"""Peaks of one NVIDIA H100 and the least time of the port's kernels and of
a Farneback register, counted from shapes.

``kernel_bounds`` and ``band_entry_bound`` are frozen copies of
``chip_smoke.py``'s: each input read once and each output written once
over HBM's rate, against the float32 operations over the rate outside the
tensor cores (NVIDIA's data sheet, SXM part, at 700 W).
``register_least_s`` counts the kernels' work of one OptFlowReg register
from the plane's shape and the configuration alone, never from launches,
so it reads the same work whatever implements it.
"""

from __future__ import annotations

H100_BYTES_PER_S, H100_F32_FLOPS, H100_BF16_TC_FLOPS = 3.35e12, 67e12, 989e12


def kernel_bounds(h, w, planes=8, taps=99, r_bytes=4, m_bytes=4) -> dict:
    """{kernel: (bound ms, "bytes" or "operations")} at an (h, w) slab.
    Operations a pixel are counted from each kernel's arithmetic (K3: two
    passes of 5 planes x ``taps`` multiply-adds, plus the solve).  R0/R1
    and M are planes of ``r_bytes`` and ``m_bytes``.  On bf16 M, K3's entry
    runs its multiply-adds on the tensor cores: its bound is the largest of
    the bytes, those multiply-adds over the dense bf16 rate and the solve's
    float32 operations over the float32 rate."""
    px, pad = h * w, (h + 2) * (w + 2)
    work = {  # (bytes, float32 operations)
        "K1": (4 * px + 8 * px + 4 * px, 17 * px),
        "K2": (2 * 4 * pad + (10 * r_bytes + 5 * m_bytes) * px, 170 * px),
        "K3": (5 * m_bytes * px + 2 * 4 * px, (2 * 5 * taps * 2 + 15) * px),
        "K4": (10 * r_bytes * px + 8 * px + 5 * m_bytes * px, 90 * px),
        "K5": (planes * 4 * px * 2 + 8 * px, (13 * planes + 4) * px),
        "K6": (4 * pad + 5 * 4 * px, 66 * px),
    }
    out = {}
    for k, (nbytes, flops) in work.items():
        tb, tf = 1e3 * nbytes / H100_BYTES_PER_S, 1e3 * flops / H100_F32_FLOPS
        out[k] = (max(tb, tf), "bytes" if tb >= tf else "operations")
    if m_bytes == 2:
        out["K3 float32 operations"] = out["K3"]
        tb = 1e3 * work["K3"][0] / H100_BYTES_PER_S
        tc, solve = 1e3 * 2 * 5 * taps * 2 * px / H100_BF16_TC_FLOPS, 1e3 * 15 * px / H100_F32_FLOPS
        out["K3"] = (max(tb, tc, solve), "bytes" if tb >= max(tc, solve) else "operations")
    return out


def band_entry_bound(planes, px, itemsize) -> tuple:
    """(bound ms, "bytes" or "operations") of K5's band entry over ``planes``
    stored planes of ``px`` pixels: each stored plane read once and written
    once, the (H, W, 2) flow read once; K5's operations a plane and output,
    the taps' 4 conversions and the rounding's 3."""
    nbytes, ops = planes * px * itemsize * 2 + 8 * px, (20 * planes + 4) * px
    tb, tf = 1e3 * nbytes / H100_BYTES_PER_S, 1e3 * ops / H100_F32_FLOPS
    return max(tb, tf), "bytes" if tb >= tf else "operations"


def level_shapes(shape, num_pyr_lvl: int, use_full_res: bool) -> list:
    """(H, W) of each pyramid level of the register, coarsest first
    (``cv.pyrDown`` halves rounding up; a level exists while both sides
    stay >= 100 px)."""
    h, w = shape
    out = []
    lh, lw = h, w
    for lvl in range(num_pyr_lvl):
        factor = 2 ** (lvl + 1)
        if h / factor < 100 or w / factor < 100:
            break
        lh, lw = (lh + 1) // 2, (lw + 1) // 2
        out.append((lh, lw))
    out.reverse()
    if use_full_res:
        out.append((h, w))
    return out


# bytes a stored R and M value takes on each Farneback precision a configuration may state
FLOW_STORAGE = {"float32": (4, 4), "bfloat16": (2, 2), "bfloat16_m": (4, 2)}


def register_least_s(shape, params: dict, flow_precision: str = "float32") -> float:
    """Least time of one OptFlowReg register's kernel work, in seconds: per
    level over its pixels, K2 once, K3 a Farneback iteration, K4 between
    iterations, and K5's band entry for the post-warp and, after the first
    level, the pre-warp of the level's u8 image, with R and M stored as
    ``flow_precision`` stores them.  The plain filters, the gate and the
    composition are not counted: the numerator is work that kernels of the
    port must do, so the share cannot pass 100%."""
    r_bytes, m_bytes = FLOW_STORAGE[flow_precision]
    taps = 2 * ((params["Overlap"] - (1 - params["Overlap"] % 2)) // 2) + 1
    iters = params["NumberIterationsPerLevel"]
    total_ms = 0.0
    for i, (h, w) in enumerate(level_shapes(shape, params["NumberPyramidLevels"], params["UseFullResImage"])):
        b = kernel_bounds(h, w, planes=1, taps=taps, r_bytes=r_bytes, m_bytes=m_bytes)
        total_ms += b["K2"][0] + iters * b["K3"][0] + (iters - 1) * b["K4"][0]
        total_ms += (2 if i else 1) * band_entry_bound(1, h * w, 1)[0]
    return total_ms / 1e3
