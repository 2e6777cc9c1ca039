"""Port parity: ``distkeras_tpu_torch.serving.sampling`` against the JAX
package's ``distkeras_tpu.serving.sampling``.

``filtered_logits`` / ``modified_probs`` are within 1e-6 of JAX's over a
grid of temperature, top-k and top-p (ties included); greedy speculative
judging equals JAX's.  The random draws are the port's own (ROADMAP C9: a
counter-based stream keyed by the request's seed, where JAX splits a PRNG
key), so they are held to their distribution instead: chi-square tests
that ``sample_one`` and speculative sampling follow ``modified_probs``,
and the C9 properties — the same seed gives the same tokens, another seed
others, and neither the rows beside a request nor its row change them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from distkeras_tpu.serving import sampling as jax_sampling
from distkeras_tpu_torch.serving import sampling

torch.set_num_threads(1)  # the suite runs under xdist: keep each worker small

VOCAB = 23
TOL = 1e-6
TOP_K = (0, 1, 3, 7, VOCAB, 40)
TOP_P = (1.0, 0.95, 0.5, 0.1, 0.0)
# p-value below which a chi-square test fails: a correct sampler fails one
# test in a million
P_MIN = 1e-6


def _logits(kind, rows, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(rows, VOCAB)).astype(np.float32) * 2.0
    if kind == "ties":  # repeated values, a tied maximum among them
        x = np.round(x * 2.0) / 2.0
        x[:, 5] = x[:, 9] = x.max(-1) + 0.5
    return x


def _grid(kind):
    """Every (temperature, top_k, top_p) of the grid over a few logit rows."""
    rows = []
    for t in (0.0, 0.6, 1.0, 1.7):
        for k in TOP_K:
            for p in TOP_P:
                rows.append((t, k, p))
    t, k, p = (np.asarray(c) for c in zip(*rows))
    logits = np.tile(_logits(kind, 3), (len(rows), 1, 1))
    return (logits, np.repeat(t, 3).astype(np.float32), np.repeat(k, 3).astype(np.int32),
            np.repeat(p, 3).astype(np.float32))


@pytest.mark.parametrize("kind", ["normal", "ties"])
@pytest.mark.parametrize("fn", ["filtered_logits", "modified_probs"])
def test_distribution_shaping_matches_jax(kind, fn):
    logits, t, k, p = _grid(kind)
    logits = logits.reshape(-1, VOCAB)
    ref = np.asarray(jax.vmap(getattr(jax_sampling, fn))(
        jnp.asarray(logits), jnp.asarray(t), jnp.asarray(k), jnp.asarray(p)))
    out = getattr(sampling, fn)(torch.from_numpy(logits), torch.from_numpy(t),
                                torch.from_numpy(k), torch.from_numpy(p)).numpy()
    assert np.array_equal(np.isneginf(out), np.isneginf(ref))  # the same tokens kept
    finite = np.isfinite(ref)
    np.testing.assert_allclose(out[finite], ref[finite], atol=TOL, rtol=TOL)
    # one row with scalar knobs takes the same path
    one = getattr(sampling, fn)(torch.from_numpy(logits[7]), float(t[7]), int(k[7]),
                                float(p[7])).numpy()
    np.testing.assert_array_equal(one, out[7])


def _judge_jax(logits, drafts, qprobs, temperature, speculate):
    out, count, accepted, _ = jax_sampling.speculative_verify(
        jnp.asarray(logits), jnp.asarray(drafts, jnp.int32), jnp.asarray(qprobs),
        jax.random.PRNGKey(0), jnp.float32(temperature), jnp.int32(0), jnp.float32(1.0),
        jnp.asarray(speculate))
    return np.asarray(out), int(count), int(accepted)


def _judge(logits, drafts, qprobs, temperature, speculate, seed=0, counter=0):
    out, count, accepted = sampling.speculative_verify(
        torch.from_numpy(logits), torch.from_numpy(np.asarray(drafts)),
        torch.from_numpy(qprobs), seed, counter, temperature, 0, 1.0, speculate)
    return out.numpy(), int(count), int(accepted)


@pytest.mark.parametrize("mismatch", [None, 0, 2])
@pytest.mark.parametrize("speculate", [True, False])
def test_greedy_speculative_verify_matches_jax(mismatch, speculate):
    logits = np.random.default_rng(0).normal(size=(4, 11)).astype(np.float32)
    drafts = logits.argmax(-1)
    if mismatch is not None:
        drafts[mismatch] = (drafts[mismatch] + 1) % 11
    qprobs = np.full((4, 11), 1.0 / 11, np.float32)
    out, count, accepted = _judge(logits, drafts, qprobs, 0.0, speculate)
    ref, ref_count, ref_accepted = _judge_jax(logits, drafts, qprobs, 0.0, speculate)
    assert (count, accepted) == (ref_count, ref_accepted)
    np.testing.assert_array_equal(out[:count], ref[:count])
    if mismatch is None and speculate:
        assert (count, accepted) == (4, 4)  # all accepted: no bonus token


def test_batched_verify_matches_jax_vmap():
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(5, 3, VOCAB)).astype(np.float32)
    drafts = logits.argmax(-1)
    drafts[1, 1] = (drafts[1, 1] + 1) % VOCAB
    drafts[3, 0] = (drafts[3, 0] + 2) % VOCAB
    q = np.full((5, 3, VOCAB), 1.0 / VOCAB, np.float32)
    speculate = np.array([True, True, False, True, True])
    keys = jax.random.split(jax.random.PRNGKey(1), 5)
    zeros = np.zeros(5, np.float32)
    ref = jax_sampling.speculative_verify_tokens(
        jnp.asarray(logits), jnp.asarray(drafts), jnp.asarray(q), keys, jnp.asarray(zeros),
        jnp.zeros(5, jnp.int32), jnp.ones(5, jnp.float32), jnp.asarray(speculate))
    out = sampling.speculative_verify_tokens(
        torch.from_numpy(logits), torch.from_numpy(drafts), torch.from_numpy(q),
        torch.arange(5), torch.zeros(5, dtype=torch.long), torch.from_numpy(zeros),
        torch.zeros(5, dtype=torch.long), torch.ones(5), torch.from_numpy(speculate))
    counts = np.asarray(ref[1])
    np.testing.assert_array_equal(out[1].numpy(), counts)
    np.testing.assert_array_equal(out[2].numpy(), np.asarray(ref[2]))
    for row, n in enumerate(counts):
        np.testing.assert_array_equal(out[0][row, :n].numpy(), np.asarray(ref[0])[row, :n])


def _chi2_pvalue(tokens, probs):
    counts = np.bincount(tokens, minlength=len(probs))
    support = probs > 0
    assert counts[~support].sum() == 0, "a token outside the filtered support was drawn"
    expected = probs[support] * len(tokens)
    return stats.chisquare(counts[support], expected * counts[support].sum() / expected.sum()
                           ).pvalue


@pytest.mark.parametrize("knobs", [(1.0, 0, 1.0), (0.7, 8, 1.0), (1.3, 0, 0.8)])
def test_sample_one_follows_modified_probs(knobs):
    n = 20000
    logits = torch.from_numpy(_logits("normal", 1, seed=5)[0])
    probs = sampling.modified_probs(logits, *knobs).double().numpy()
    # one request's stream: the same seed, its counter advancing per draw
    tokens = sampling.sample_tokens(logits.expand(n, VOCAB), torch.full((n,), 11),
                                    torch.arange(n), *(torch.full((n,), v) for v in knobs))
    assert _chi2_pvalue(tokens.numpy(), probs) > P_MIN
    # and across seeds at one counter
    tokens = sampling.sample_tokens(logits.expand(n, VOCAB), torch.arange(n),
                                    torch.zeros(n, dtype=torch.long),
                                    *(torch.full((n,), v) for v in knobs))
    assert _chi2_pvalue(tokens.numpy(), probs) > P_MIN


def test_speculative_sampling_preserves_target_distribution():
    """With a deliberately wrong draft distribution q != p, the emitted
    token's marginal is still the target p (the accept/resample identity),
    over 20000 draws with m=1; and a faithful draft (q == p) accepts
    everything."""
    n, v = 20000, 5
    rng = np.random.default_rng(13)
    logits = torch.from_numpy(rng.normal(size=(1, v)).astype(np.float32))
    p = sampling.modified_probs(logits[0], 1.0, 0, 1.0)
    q = torch.tensor([0.70, 0.15, 0.05, 0.05, 0.05])
    drafts = torch.from_numpy(rng.choice(v, size=(n, 1), p=q.numpy() / q.sum().item()))
    ones = torch.ones(n)
    out, count, accepted = sampling.speculative_verify_tokens(
        logits.expand(n, 1, v), drafts, q.expand(n, 1, v), torch.full((n,), 3),
        torch.arange(n), ones, torch.zeros(n, dtype=torch.long), ones,
        torch.ones(n, dtype=torch.bool))
    assert (count == 1).all()
    assert 0 < accepted.sum() < n
    assert _chi2_pvalue(out[:, 0].numpy(), p.double().numpy()) > P_MIN

    drafts = torch.multinomial(p, n, replacement=True, generator=torch.Generator().manual_seed(0))
    out, count, accepted = sampling.speculative_verify_tokens(
        logits.expand(n, 1, v), drafts[:, None], p.expand(n, 1, v), torch.full((n,), 3),
        torch.arange(n), ones, torch.zeros(n, dtype=torch.long), ones,
        torch.ones(n, dtype=torch.bool))
    assert (accepted == 1).all() and torch.equal(out[:, 0], drafts)


def test_uniform_draws_are_uniform():
    u = sampling.uniform(torch.tensor([5, 6]), torch.tensor([0, 0]), sampling.STREAM_ACCEPT,
                         torch.arange(50000))
    assert u.dtype == torch.float32 and 0.0 <= u.min() and u.max() < 1.0
    for row in u.numpy():
        assert stats.kstest(row, "uniform").pvalue > P_MIN
    assert np.corrcoef(u.numpy())[0, 1] < 0.03  # two seeds: unrelated draws


def test_c9_same_seed_same_tokens_other_seed_others():
    logits = torch.from_numpy(_logits("normal", 16, seed=2))
    knobs = (torch.full((16,), 0.9), torch.full((16,), 7), torch.full((16,), 0.95))
    seed = torch.full((16,), 123)
    draw = sampling.sample_tokens(logits, seed, torch.arange(16), *knobs)
    assert torch.equal(draw, sampling.sample_tokens(logits, seed, torch.arange(16), *knobs))
    other = sampling.sample_tokens(logits, torch.full((16,), 7), torch.arange(16), *knobs)
    assert not torch.equal(draw, other)
    # each stream purpose draws differently from the same (seed, counter)
    bits = [sampling.random_bits(seed[:1], torch.zeros(1), s, torch.arange(64))
            for s in (sampling.STREAM_SAMPLE, sampling.STREAM_ACCEPT,
                      sampling.STREAM_RESAMPLE, sampling.STREAM_DRAFT)]
    assert len({tuple(b[0].tolist()) for b in bits}) == 4


def test_c9_rows_beside_a_request_and_its_row_change_nothing():
    logits = torch.from_numpy(_logits("normal", 6, seed=4))
    rng = np.random.default_rng(9)
    seeds = torch.from_numpy(rng.integers(0, 2**40, 6))
    counters = torch.from_numpy(rng.integers(0, 100, 6))
    temp = torch.tensor([0.9, 0.0, 1.2, 0.5, 0.9, 2.0])
    top_k = torch.tensor([0, 5, 7, 0, 3, 0])
    top_p = torch.tensor([1.0, 1.0, 0.9, 0.5, 1.0, 0.99])
    batch = sampling.sample_tokens(logits, seeds, counters, temp, top_k, top_p)
    alone = torch.stack([sampling.sample_one(logits[i], seeds[i], counters[i], temp[i],
                                             top_k[i], top_p[i]) for i in range(6)])
    assert torch.equal(batch, alone)
    perm = torch.tensor([3, 5, 0, 1, 4, 2])
    moved = sampling.sample_tokens(logits[perm], seeds[perm], counters[perm], temp[perm],
                                   top_k[perm], top_p[perm])
    assert torch.equal(moved, batch[perm])
    assert batch[1] == torch.argmax(logits[1])  # greedy row: the first maximum


def test_seed_values_wrap_to_int64():
    assert sampling.seed_value(5) == 5
    assert sampling.seed_value(-1) == -1
    assert sampling.seed_value(2**64 + 3) == 3
    assert sampling.seed_value(2**63) == -(2**63)
