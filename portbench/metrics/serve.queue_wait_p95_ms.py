"""``serve.queue_wait_p95_ms``: the nearest-rank p95 of the requests' wait
in the serving engine's admission queue (``GenerateResult.queue_wait_s``,
from the request's entry to the start of its prefill), over the requests
:func:`portbench.engine_timings.window_results` reads."""

from portbench import engine_timings
from portbench.traffic import percentile


def read(run):
    results = engine_timings.window_results(run)
    if not results:
        return None
    return 1e3 * percentile([r.queue_wait_s for r in results], 95)
