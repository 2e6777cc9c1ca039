"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit), and the least time a piece of work
can take on it.  A run prints the card's name and power limit on standard
error, so that a share of these peaks can be read beside them."""

#: FLOP/s by the precision of the products
PEAK_FLOPS = {
    "bfloat16": 989e12,
    "float16": 989e12,
    "tf32": 495e12,
    "float32": 67e12,
    "fp8": 1979e12,
}
#: HBM3 bytes/s
PEAK_BYTES_PER_S = 3.35e12


def least_seconds(flops: float, nbytes: float, dtype: str):
    """The least time for ``flops`` in ``dtype`` products and ``nbytes`` of
    memory traffic: the larger of the two bounds, and which one it is."""
    ops = flops / PEAK_FLOPS[dtype]
    mem = nbytes / PEAK_BYTES_PER_S
    return max(ops, mem), ("operations" if ops >= mem else "bytes")
