"""``serve.decode_device_ms_per_token``: the device milliseconds of the
serving engine's decode steps per token they generated: the sum of the
requests' decode shares (``GenerateResult.decode_device_s``, each step's
CUDA-event time split evenly over its active slots) over their tokens
after the first (the first is the prefill's), over the requests
:func:`portbench.engine_timings.window_results` reads."""

from portbench import engine_timings


def read(run):
    results = engine_timings.window_results(run)
    tokens = sum(len(r.tokens) - 1 for r in results)
    if tokens <= 0:
        return None
    return 1e3 * sum(r.decode_device_s for r in results) / tokens
