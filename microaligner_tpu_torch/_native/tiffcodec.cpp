// Native TIFF codec kernels: LZW decode, PackBits decode, horizontal
// predictor undo.  These are the byte-at-a-time loops that are slow in
// Python; everything else in the TIFF stack stays host Python.
//
// Built at first use (g++ -O3 -shared -fPIC) and loaded via ctypes with a
// pure-Python fallback (microaligner_tpu_torch/_native/__init__.py).
// Copied from microaligner_tpu/_native/tiffcodec.cpp unchanged otherwise.

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// TIFF-variant LZW (MSB-first bit order, early code-size change).
// Returns number of bytes written to dst, or -1 on malformed input.
long lzw_decode(const uint8_t* src, long src_len, uint8_t* dst, long dst_cap) {
    constexpr int kClear = 256;
    constexpr int kEoi = 257;
    constexpr int kFirst = 258;
    constexpr int kMaxCode = 4096;

    // dictionary as (prefix, suffix) pairs; entries < 256 are literals
    std::vector<int32_t> prefix(kMaxCode, -1);
    std::vector<uint8_t> suffix(kMaxCode, 0);
    std::vector<uint8_t> stack(kMaxCode, 0);

    int next_code = kFirst;
    int code_bits = 9;
    long bitpos = 0;
    const long nbits = src_len * 8;
    long out = 0;
    int prev = -1;

    auto read_code = [&]() -> int {
        if (bitpos + code_bits > nbits) return kEoi;
        long byte = bitpos >> 3;
        int shift = (int)(bitpos & 7);
        uint32_t v = 0;
        // read up to 3 bytes covering the code
        v = ((uint32_t)src[byte] << 16);
        if (byte + 1 < src_len) v |= ((uint32_t)src[byte + 1] << 8);
        if (byte + 2 < src_len) v |= (uint32_t)src[byte + 2];
        v <<= shift;
        v &= 0xFFFFFF;
        bitpos += code_bits;
        return (int)(v >> (24 - code_bits));
    };

    auto emit = [&](int code) -> int {
        // expand code onto the stack, copy to dst; returns first byte or -1
        int sp = 0;
        int c = code;
        while (c >= 256) {
            if (c >= next_code || sp >= kMaxCode) return -1;
            stack[sp++] = suffix[c];
            c = prefix[c];
        }
        uint8_t first = (uint8_t)c;
        if (out + sp + 1 > dst_cap) {
            // truncate silently at capacity (caller sized it exactly)
            long room = dst_cap - out;
            if (room <= 0) return first;
            long n = room < sp + 1 ? room : sp + 1;
            dst[out++] = first;
            for (long i = 0; i < n - 1; i++) dst[out++] = stack[sp - 1 - i];
            return first;
        }
        dst[out++] = first;
        for (int i = sp - 1; i >= 0; i--) dst[out++] = stack[i];
        return first;
    };

    while (true) {
        int code = read_code();
        if (code == kEoi) break;
        if (code == kClear) {
            next_code = kFirst;
            code_bits = 9;
            prev = -1;
            continue;
        }
        if (prev < 0) {
            if (code >= 256) return -1;
            if (out < dst_cap) dst[out++] = (uint8_t)code;
            prev = code;
        } else {
            int first;
            if (code < next_code) {
                first = emit(code);
                if (first < 0) return -1;
            } else if (code == next_code) {
                // KwKwK case: emit prev + firstchar(prev)
                int c = prev;
                while (c >= 256) c = prefix[c];
                // temporarily register, then emit
                prefix[next_code] = prev;
                suffix[next_code] = (uint8_t)c;
                next_code++;
                first = emit(code);
                if (first < 0) return -1;
                // already registered; skip the registration below
                if (next_code == (1 << code_bits) - 1 && code_bits < 12) code_bits++;
                prev = code;
                continue;
            } else {
                return -1;
            }
            if (next_code < kMaxCode) {
                prefix[next_code] = prev;
                suffix[next_code] = (uint8_t)first;
                next_code++;
            }
            prev = code;
        }
        // TIFF early change: bump width when next_code == 2^bits - 1
        if (next_code == (1 << code_bits) - 1 && code_bits < 12) code_bits++;
        if (out >= dst_cap) break;
    }
    return out;
}

long packbits_decode(const uint8_t* src, long src_len, uint8_t* dst, long dst_cap) {
    long i = 0, out = 0;
    while (i < src_len && out < dst_cap) {
        int8_t n = (int8_t)src[i++];
        if (n >= 0) {
            long cnt = (long)n + 1;
            if (i + cnt > src_len) cnt = src_len - i;
            if (out + cnt > dst_cap) cnt = dst_cap - out;
            std::memcpy(dst + out, src + i, cnt);
            i += cnt;
            out += cnt;
        } else if (n != -128) {
            long cnt = 1 - (long)n;
            if (i >= src_len) break;
            if (out + cnt > dst_cap) cnt = dst_cap - out;
            std::memset(dst + out, src[i], cnt);
            i += 1;
            out += cnt;
        }
    }
    return out;
}

// Undo TIFF predictor 2 (horizontal differencing) in place.
// Element size 1, 2 or 4; `stride` elements per row (width * samples).
void undo_hpredict_u8(uint8_t* p, long rows, long stride) {
    for (long r = 0; r < rows; r++) {
        uint8_t* row = p + r * stride;
        for (long c = 1; c < stride; c++) row[c] = (uint8_t)(row[c] + row[c - 1]);
    }
}

void undo_hpredict_u16(uint16_t* p, long rows, long stride) {
    for (long r = 0; r < rows; r++) {
        uint16_t* row = p + r * stride;
        for (long c = 1; c < stride; c++) row[c] = (uint16_t)(row[c] + row[c - 1]);
    }
}

void undo_hpredict_u32(uint32_t* p, long rows, long stride) {
    for (long r = 0; r < rows; r++) {
        uint32_t* row = p + r * stride;
        for (long c = 1; c < stride; c++) row[c] = row[c] + row[c - 1];
    }
}

}  // extern "C"
