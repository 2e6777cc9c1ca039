"""``serve.decode_step_ms``: the mean wall time of one decode step of the
serving engine from its own histogram ``serving_token_latency_seconds``:
its sum and count at the start of the traced stretch less those at the
window's open (the profiler slows the host loop, so the stretch is left
out)."""


def read(run):
    window = run.facts.get("window")
    if window is None:
        return None
    before, after = window
    steps = after["step_count"] - before["step_count"]
    if steps <= 0:
        return None
    return 1e3 * (after["step_sum"] - before["step_sum"]) / steps
