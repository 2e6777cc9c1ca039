"""``attn_fwd_roofline``: B1, the flash-attention forward
(``csrc/flash_attention_fwd.cu``), as a share of its roofline.

Work of one call: QK^T and PV, 4 FLOPs per head dim per attended pair
(causal attention attends the pairs on and below the diagonal); Q, K and V
read once, O and the float32 log-sum-exp written once.  The least time of
the traced stretch is that of one call at the cell's shape times the calls
the stretch's steps make (one a layer a step), over the device time of the
kernels whose name matches :data:`PATTERN`.  The matched launches have to
be a whole multiple of the calls (one kernel a call today); where they are
not, the reading is left out."""

import sys

from portbench import flops, peaks

NAME = "attn_fwd_roofline"

PATTERN = r"flash_fwd_kernel"
ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4}


def call_seconds(shape: dict) -> float:
    """The least time of one forward call at ``shape``."""
    n = shape["batch"] * shape["seq"] * shape["heads"] * shape["head_dim"]
    work = 4.0 * shape["head_dim"] * flops.attention_pairs(shape)
    nbytes = 4 * n * ITEMSIZE[shape["dtype"]] + shape["batch"] * shape["heads"] * shape["seq"] * 4
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
