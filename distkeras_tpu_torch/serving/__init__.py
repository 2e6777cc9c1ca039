"""Online inference: continuous batching, paged KV cache, SLO metrics.

The port of :mod:`distkeras_tpu.serving` on one device:

* :class:`~distkeras_tpu_torch.serving.engine.ServingEngine` — the decode
  loop (fixed slot ring, one decode step over every slot,
  prefill-on-admission / retire-on-EOS, speculative decoding);
* :mod:`~distkeras_tpu_torch.serving.cache` — paged KV cache (slot page
  tables over shared K/V pools);
* :mod:`~distkeras_tpu_torch.serving.sampling` — temperature / top-k /
  top-p with per-request seeds, all data on the device;
* :mod:`~distkeras_tpu_torch.serving.frontend` — request/response
  dataclasses and the bounded queue with backpressure.

Quick start::

    from distkeras_tpu_torch import serving
    engine = serving.ServingEngine(trained_model)   # on the card
    print(engine.generate([1, 2, 3], max_new_tokens=8).tokens)
    engine.stop()

The fault-tolerant router over replicas (``serving/tier.py``:
``ServingTier``, ``LocalReplica``, ``HttpReplica``, ``watch_and_swap``)
needs fleet membership and comes with the control-plane slice (ROADMAP
Queue A item 18); the ``/generate`` HTTP endpoint needs the flight deck
(item 19).
"""

from distkeras_tpu_torch.serving.cache import PagedKVCache, append_rows, rollback_rows
from distkeras_tpu_torch.serving.engine import EngineCrashed, ServingEngine, serving_metrics
from distkeras_tpu_torch.serving.frontend import (
    GenerateRequest,
    GenerateResult,
    QueueFull,
    RequestQueue,
    install_http_endpoint,
    serve_flags,
)
from distkeras_tpu_torch.serving.sampling import (
    modified_probs,
    sample_one,
    sample_tokens,
    speculative_verify,
)

__all__ = [
    "EngineCrashed",
    "GenerateRequest",
    "GenerateResult",
    "PagedKVCache",
    "QueueFull",
    "RequestQueue",
    "ServingEngine",
    "append_rows",
    "install_http_endpoint",
    "modified_probs",
    "rollback_rows",
    "sample_one",
    "sample_tokens",
    "serve_flags",
    "serving_metrics",
    "speculative_verify",
]
