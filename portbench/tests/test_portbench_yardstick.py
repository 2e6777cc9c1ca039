"""The yardstick's arithmetic against figures worked out by hand."""

import math

import pytest

from portbench import flops, harness, peaks

MANIFEST = harness.load_json(harness.ROOT / "BENCHMARK.json")
GPT2 = harness.resolve(MANIFEST, "gpt2s-train-downpour")


def test_gpt2_small_product_parameters():
    # per block qkv 3d^2, proj d^2, fc1 and fc2 2 x 4d^2: 12 d^2, x 12 blocks,
    # plus the untied head d x V.  Biases are added, not multiplied: counting
    # the blocks' too (9d a block) gives the 123.6 M often quoted
    d, v = 768, 50257
    assert flops.product_params(GPT2.config) == 12 * 12 * d * d + d * v == 123_532_032


def test_flops_per_token():
    # GPT-2: 6 x 123.53 M + causal attention (3 x 4 x 768 x 512.5 pairs x 12)
    lm = flops.train_flops_per_sample(GPT2.config, 1024) / 1024
    assert lm == pytest.approx(6 * 123_532_032 + 3 * 4 * 768 * 512.5 * 12)
    assert lm == pytest.approx(0.798e9, rel=1e-3)


def _metric(name):
    return harness.metric_reader(name)


def test_attention_forward_work():
    shape = flops.attention_shape(GPT2.config, GPT2.traffic)
    assert shape == {"batch": 16, "seq": 1024, "heads": 12, "head_dim": 64, "causal": True,
                     "dtype": "bfloat16", "layers": 12}
    pairs = 16 * 12 * 1024 * 1025 / 2
    work = 4 * 64 * pairs
    nbytes = 4 * 16 * 1024 * 12 * 64 * 2 + 16 * 12 * 1024 * 4
    want = max(work / 989e12, nbytes / 3.35e12)
    assert _metric("attn_fwd_roofline").call_seconds(shape) == pytest.approx(want)
    assert want == pytest.approx(30.3e-6, rel=0.01)  # bound by the bytes


@pytest.mark.parametrize("causal", [True, False])
def test_attention_backward_work(causal):
    shape = dict(flops.attention_shape(GPT2.config, GPT2.traffic), causal=causal)
    pairs = 16 * 12 * (1024 * 1025 / 2 if causal else 1024 * 1024)
    work = 8 * 64 * pairs
    nbytes = 8 * 16 * 1024 * 12 * 64 * 2 + 16 * 12 * 1024 * 4
    want = max(work / 989e12, nbytes / 3.35e12)
    assert _metric("attn_bwd_roofline").call_seconds(shape) == pytest.approx(want)


def test_least_seconds_names_its_bound():
    assert peaks.least_seconds(989e12, 0, "bfloat16") == (1.0, "operations")
    assert peaks.least_seconds(0, 3.35e12, "bfloat16") == (1.0, "bytes")


class _Trace:
    def __init__(self, seconds, launches, window=2.0, busy=1.5):
        self.seconds, self.launches, self.window_s, self.busy_s = seconds, launches, window, busy

    def device_seconds(self, pattern):
        return self.seconds, self.launches


def _run(cell, trace, **facts):
    run = harness.Run(cell=cell, seed=1, seconds=1, traced=True, t0=0.0)
    run.trace, run.facts = trace, facts
    return run


def test_roofline_reads_the_stretch():
    shape = flops.attention_shape(GPT2.config, GPT2.traffic)
    per_call = _metric("attn_fwd_roofline").call_seconds(shape)
    run = _run(GPT2, _Trace(seconds=10 * 12 * per_call * 4, launches=120), steps=10)
    assert _metric("attn_fwd_roofline").read(run) == pytest.approx(25.0)
    assert _metric("attn_fwd_roofline").read(_run(GPT2, _Trace(0.0, 0), steps=10)) is None
    assert _metric("attn_fwd_roofline").read(_run(GPT2, None, steps=10)) is None


@pytest.mark.parametrize("metric,per_call", [("attn_fwd_roofline", 1), ("attn_bwd_roofline", 2)])
def test_roofline_needs_every_call_in_the_trace(metric, per_call):
    # 10 steps x 12 layers = 120 calls; a launch missing from the trace (or
    # one the steps did not make) leaves the share out instead of inflating it
    reader = _metric(metric)
    shape = flops.attention_shape(GPT2.config, GPT2.traffic)
    seconds = 120 * reader.call_seconds(shape) * 2
    assert reader.read(_run(GPT2, _Trace(seconds, 120 * per_call), steps=10)) == pytest.approx(50.0)
    assert reader.read(_run(GPT2, _Trace(seconds, 120 * per_call - 1), steps=10)) is None


def test_step_mfu_and_idle():
    run = _run(GPT2, _Trace(0, 0, window=2.0, busy=1.5), samples=100, flops_per_sample=9.89e12)
    assert _metric("step_mfu.train").read(run) == pytest.approx(50.0)
    assert _metric("device_idle.train").read(run) == pytest.approx(25.0)


def test_serving_counters():
    before = {"tokens": 0, "padded": 10, "step_sum": 1.0, "step_count": 10}
    after = {"tokens": 500, "padded": 40, "step_sum": 1.5, "step_count": 110}
    run = _run(GPT2, None, window=(before, after), prompt_tokens=90)
    assert _metric("serve.decode_step_ms").read(run) == pytest.approx(5.0)
    assert _metric("serve.prefill_pad_share").read(run) == pytest.approx(25.0)


def test_mfu_formula_matches_the_rate():
    # train_mfu = samples/s x FLOPs a sample / peak
    per_sample = flops.train_flops_per_sample(GPT2.config, 1024)
    assert 100 * 300 * per_sample / peaks.PEAK_FLOPS["bfloat16"] == pytest.approx(
        100 * 300 * 1024 * 0.798e9 / 989e12, rel=1e-3)
    assert math.isclose(peaks.PEAK_FLOPS["bfloat16"], 989e12)
