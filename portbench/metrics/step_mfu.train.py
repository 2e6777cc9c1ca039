"""``step_mfu.train``: the whole training step's share of the card's peak
over the traced stretch: the model FLOPs of the samples the stretch trained
(:mod:`portbench.flops`) over the stretch's seconds (from the device
trace) and the peak of the compute precision.  It stands beside the
kernels' roofline shares: a kernel taken off the path leaves its own share
silent, not this one."""

from portbench import peaks


def read(run):
    if run.trace is None or run.trace.window_s <= 0 or not run.facts.get("samples"):
        return None
    work = run.facts["samples"] * run.facts["flops_per_sample"]
    peak = peaks.PEAK_FLOPS[run.cell.traffic["compute_dtype"]]
    return 100.0 * work / run.trace.window_s / peak
