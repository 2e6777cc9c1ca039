"""End-to-end request tracing through the port's serving tier, against
tests/test_request_trace.py: one tier request through ``HttpReplica`` with
an injected ``stall_http`` failover leaves a merged trace whose every span
shares one ``trace_id`` with the right parent links — its normalised
schema equal to the JAX package's golden (``tests/golden/
request_trace.json``) — and ``tools.dktrace``'s ``critical-path`` and the
flight deck's ``/trace?request_id=`` rebuild it from the port's trace
directory.

The scenario runs once (module fixture): two engines of a tiny
``TransformerLM`` (flax parameters carried over) behind
``install_http_endpoint`` on the flight deck's server, routed by a tier of
two ``HttpReplica``s.  Chaos stalls the first outbound hop past the hop
timeout, so attempt 1 ends ``hedge_uncancelled`` and the request fails
over to the second replica."""

import json
import os
import urllib.request

import jax
import numpy as np
import pytest
import torch

from distkeras_tpu.models import TransformerLM as JaxLM
from distkeras_tpu.models.generate import greedy_generate_module
from distkeras_tpu_torch import chaos, telemetry
from distkeras_tpu_torch.models import TransformerLM, params_from_flax
from distkeras_tpu_torch.serving import (
    GenerateRequest,
    HttpReplica,
    ServingEngine,
    ServingTier,
    install_http_endpoint,
)
from distkeras_tpu_torch.telemetry.flightdeck import correlate
from distkeras_tpu_torch.telemetry.flightdeck import server as server_mod
from distkeras_tpu_torch.telemetry.metrics import Registry
from tools.dktrace import critical_path, load_events, request_events
from tools.dktrace.__main__ import main as dktrace_main

torch.set_num_threads(1)  # the suite runs under xdist: keep each worker small

VOCAB = 23
CFG = dict(vocab_size=VOCAB, dim=16, heads=2, num_layers=2, max_len=32)
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
PROMPT = [2, 4, 6]
MAX_NEW = 4

#: args that vary run to run and never enter the normalised schema
_VOLATILE = frozenset({"run_id", "budget_s", "hop_s"})
#: args whose values are deterministic and pinned by the golden
_STABLE = ("parent", "attempt", "replica", "outcome", "slot", "width", "plen", "n_active")


@pytest.fixture(scope="module")
def failover_trace(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("reqtrace")
    old_dir = os.environ.get("DISTKERAS_TELEMETRY_DIR")
    os.environ["DISTKERAS_TELEMETRY_DIR"] = str(tmp)
    telemetry.configure(True)
    telemetry.metrics.reset()
    telemetry.trace.reset()
    correlate.set_run_id("tracetest")
    chaos.configure("")

    jax_model = JaxLM(**CFG)
    flax_params = jax_model.init(jax.random.PRNGKey(0), np.zeros((1, 4), np.int32))["params"]
    model = TransformerLM(**CFG)
    params = params_from_flax(model, flax_params)
    engines = [ServingEngine(model, params, registry=Registry(), num_slots=2, page_size=8,
                             device="cpu") for _ in range(2)]
    for eng in engines:
        assert eng.submit(GenerateRequest(prompt=[1, 2], max_new_tokens=2,
                                          request_id="warmup")).result(timeout=120) is not None

    server_mod.configure(0)
    addr = telemetry.flightdeck.ensure_server()
    for i, eng in enumerate(engines):
        install_http_endpoint(eng, path=f"/generate_{i}")
    tier = ServingTier([HttpReplica(addr, name=f"http-{i}", path=f"/generate_{i}")
                        for i in range(2)], registry=Registry(), hop_timeout_s=1.0)
    tier.probe_once()

    # stall the FIRST outbound generate hop well past the hop timeout; the
    # stalled thread never sends, so the trace stays deterministic
    chaos.configure("7:stall_http=1,stall_secs=60")
    try:
        result = tier.dispatch(GenerateRequest(prompt=PROMPT, max_new_tokens=MAX_NEW))
    finally:
        chaos.configure("")
    telemetry.flush()

    ref = greedy_generate_module(jax_model, flax_params, np.asarray([PROMPT], np.int32), MAX_NEW)
    yield {"result": result, "ref_tokens": ref[0, len(PROMPT):].tolist(),
           "events": load_events([str(tmp)]), "trace_dir": str(tmp), "addr": addr}

    tier.stop()
    for eng in engines:
        eng.stop()
    chaos.configure(None)
    server_mod.stop()
    server_mod.configure(None)
    telemetry.trace.reset()
    telemetry.metrics.reset()
    correlate.set_run_id(None)
    telemetry.configure(None)
    if old_dir is None:
        os.environ.pop("DISTKERAS_TELEMETRY_DIR", None)
    else:
        os.environ["DISTKERAS_TELEMETRY_DIR"] = old_dir


def _normalize(spans, rid, tid):
    """Schema view of the request's spans: names in ts order, arg-key
    sets, parent links and deterministic values, ids as placeholders."""
    rows = []
    for e in sorted(spans, key=lambda e: float(e.get("ts") or 0.0)):
        args = {k: v for k, v in (e.get("args") or {}).items() if k not in _VOLATILE}
        row = {"name": e["name"], "keys": sorted(args)}
        for k in _STABLE:
            if k in args:
                row[k] = args[k]
        if "request_id" in args:
            row["request_id"] = "<rid>" if args["request_id"] == rid else "<foreign>"
        if "trace_id" in args:
            row["trace_id"] = "<tid>" if args["trace_id"] == tid else "<foreign>"
        if "requests" in args:
            row["requests"] = ["<rid>" if r == rid else "<foreign>" for r in args["requests"]]
        rows.append(row)
    return rows


def test_failover_request_trace_schema_golden(failover_trace):
    result = failover_trace["result"]
    assert result.finish_reason in ("length", "eos")
    assert result.tokens == failover_trace["ref_tokens"]
    assert result.trace_id and result.request_id
    mine = request_events(failover_trace["events"], result.request_id)
    assert {e["args"]["trace_id"] for e in mine} == {result.trace_id}
    with open(os.path.join(GOLDEN, "request_trace.json")) as fh:
        golden = json.load(fh)
    assert _normalize(mine, result.request_id, result.trace_id) == golden


def test_failover_critical_path_breakdown(failover_trace):
    result = failover_trace["result"]
    bd = critical_path(failover_trace["events"], result.request_id)
    assert bd["outcome"] == "ok"
    assert bd["trace_ids"] == [result.trace_id]
    assert [(a["attempt"], a["replica"], a["outcome"]) for a in bd["attempts"]] == [
        (1, "http-0", "hedge_uncancelled"), (2, "http-1", "ok")]
    assert bd["attempts"][0]["dur_us"] >= 1.0e6  # attempt 1 burned the hop timeout
    assert bd["http_hops"] == 1
    assert bd["decode_steps"] >= 1
    assert bd["queue_wait_us"] > 0
    assert bd["span_count"] == 6 + len(bd["prefills"]) + bd["decode_steps"]
    with pytest.raises(ValueError):
        critical_path(failover_trace["events"], "nonexistent")


def test_dktrace_critical_path_cli(failover_trace, capsys):
    rid = failover_trace["result"].request_id
    tdir = failover_trace["trace_dir"]
    assert dktrace_main(["critical-path", rid, tdir]) == 0
    out = capsys.readouterr().out
    assert "attempt 1 -> http-0" in out and "hedge_uncancelled" in out
    assert "attempt 2 -> http-1" in out
    assert dktrace_main(["critical-path", rid, tdir, "--json"]) == 0
    payload = json.loads(capsys.readouterr().out)
    assert payload["request_id"] == rid and payload["outcome"] == "ok"
    assert dktrace_main(["critical-path", "nope", tdir]) == 2
    assert "nope" in capsys.readouterr().err


def test_flightdeck_trace_endpoint_filters(failover_trace):
    result = failover_trace["result"]
    addr = failover_trace["addr"]

    def _get(query):
        with urllib.request.urlopen(f"http://{addr}/trace?{query}", timeout=10) as resp:
            return json.loads(resp.read().decode("utf-8"))["traceEvents"]

    evs = _get(f"request_id={result.request_id}")
    names = {e["name"] for e in evs}
    assert {"tier.request", "tier.attempt", "serving.http_request", "serving.admit",
            "serving.prefill"} <= names
    assert all(e["args"].get("request_id") == result.request_id
               or result.request_id in (e["args"].get("requests") or ()) for e in evs)
    assert {e["name"] for e in _get(f"trace_id={result.trace_id}")} == names
    assert _get("request_id=doesnotexist") == []
