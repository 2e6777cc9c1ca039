"""``serve.prefill_ms``: the mean of the requests' prefill time in the
serving engine (``GenerateResult.prefill_s``, from the start of the
request's prefill to its first token read back), over the requests
:func:`portbench.engine_timings.window_results` reads."""

from portbench import engine_timings


def read(run):
    results = engine_timings.window_results(run)
    if not results:
        return None
    return 1e3 * sum(r.prefill_s for r in results) / len(results)
