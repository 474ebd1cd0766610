"""Share of FeatureReg's knn least time in the device time of its match
steps, in percent.  The least time is counted a ``match_descriptors`` call
from the port's ``features.knn`` counters (valid query and train rows,
near-tie rows, descriptor width, operand dtype): the larger of the
operations (2 Vq Vt width over the dense rate of the operand dtype, plus
2 ties Vt width at the FP64 tensor rate) and the bytes (both sides' valid
descriptors in the operand dtype, the outputs: a flag and an int64 index a
valid query) over HBM's rate; NVIDIA H100 SXM data sheet, 700 W.  The
device time is the interval between the timing events of the port's
``features.match`` spans; both summed over the window."""

from benchmark import program_trace

HBM_BYTES_PER_S = 3.35e12
FP64_TC_FLOPS = 67e12
DENSE_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
OPERAND_BYTES = {"bfloat16": 2, "float32": 4}
OUTPUT_BYTES = 1 + 8  # the ratio test's flag and the nearest index of a query row


def least_s(values: dict) -> float:
    vq, vt, width = int(values["query_valid"]), int(values["train_valid"]), int(values["width"])
    dtype, ties = values["dtype"], int(values["ties"])
    ops_s = 2 * vq * vt * width / DENSE_FLOPS[dtype] + 2 * ties * vt * width / FP64_TC_FLOPS
    bytes_s = ((vq + vt) * width * OPERAND_BYTES[dtype] + vq * OUTPUT_BYTES) / HBM_BYTES_PER_S
    return max(ops_s, bytes_s)


def read(t):
    records = program_trace.counters(t, "features.knn")
    busy = program_trace.device_total_s(program_trace.spans(t, "features.match"))
    if not records or not busy:
        return None
    return 100.0 * sum(least_s(c.values) for c in records) / busy
