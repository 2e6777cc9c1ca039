"""``attn_bwd_roofline``: the flash-attention backward as a whole (B2 and
B3, ``csrc/flash_attention_bwd.cu``, and whatever kernels a later version
splits it into or fuses it to), as a share of its roofline.

Work of one call: the four products dP, dV, dQ and dK, 8 FLOPs per head dim
per attended pair, with no recomputation counted; Q, K, V, O, dO and the
float32 log-sum-exp read once, dQ, dK and dV written once.  The time is the
sum of every kernel whose name matches :data:`PATTERN`, so a fused or split
backward is read against the same work.  The matched launches have to be a
whole multiple of the calls (two kernels a call today, dQ and dK/dV); where
they are not, the reading is left out."""

import sys

from portbench import flops, peaks

NAME = "attn_bwd_roofline"

PATTERN = r"flash_bwd"
ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4}


def call_seconds(shape: dict) -> float:
    """The least time of one backward call at ``shape``."""
    n = shape["batch"] * shape["seq"] * shape["heads"] * shape["head_dim"]
    work = 8.0 * shape["head_dim"] * flops.attention_pairs(shape)
    nbytes = 8 * n * ITEMSIZE[shape["dtype"]] + shape["batch"] * shape["heads"] * shape["seq"] * 4
    return peaks.least_seconds(work, nbytes, shape["dtype"])[0]


def read(run):
    if run.trace is None:
        return None
    seconds, launches = run.trace.device_seconds(PATTERN)
    if not launches or seconds <= 0:
        return None
    shape = flops.attention_shape(run.cell.config, run.cell.traffic)
    calls = run.facts["steps"] * shape["layers"]
    print(f"{NAME}: {launches} launches for {calls} calls", file=sys.stderr)
    if launches % calls:
        # launches the stretch's steps did not make, or calls missing from
        # the trace: the work and the time would not match
        return None
    return 100.0 * calls * call_seconds(shape) / seconds
