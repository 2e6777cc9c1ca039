"""Sampling beyond greedy: temperature / top-k / top-p, per-request seeds.

The port of :mod:`distkeras_tpu.serving.sampling`.  Every knob is a tensor,
not a Python value: the serving engine runs one decode step for every
request mix, so "this request samples at temperature 0.8 with top_k 40,
that one is greedy" is data on the device, never a change of shapes.
Greedy is the ``temperature <= 0`` limit and is computed as an exact
``argmax`` (the first maximum) — not a low-temperature softmax — so greedy
requests through the engine emit the tokens of ``greedy_generate``.

Conventions (matching the common HF/vLLM semantics):

* ``temperature <= 0`` — greedy (argmax); the other knobs are ignored.
* ``top_k <= 0`` or ``>= vocab`` — no top-k truncation.
* ``top_p >= 1`` — no nucleus truncation; the smallest prefix of
  probability-sorted tokens with cumulative mass ``>= top_p`` is kept
  (the token that crosses the threshold is always kept).

Every function takes a leading batch (``logits [..., vocab]`` with knobs of
shape ``[...]``) or one row with scalar knobs.

**Random numbers (a deliberate difference, ROADMAP C9).**  The reference
carries a ``jax.random`` key per request and splits it each step; PyTorch
cannot reproduce those draws.  Here a request's randomness is a
counter-based stream computed on the device: every draw is a 32-bit hash of
``(seed, counter, stream, index)`` — the request's seed, the count of its
own engine iterations so far, the draw's purpose (``STREAM_SAMPLE``,
``STREAM_ACCEPT``, ``STREAM_RESAMPLE``, ``STREAM_DRAFT``) and the position
within the draw (a vocabulary id, a window row).  Categorical draws are
Gumbel-max over the (filtered) logits, as ``jax.random.categorical`` is.
So, as in the reference, the same seed gives the same tokens, another seed
other tokens, and neither co-batched traffic nor the slot index changes a
request's tokens — but the tokens are not the reference's.  Nothing of it
reads back to the host.

Speculative decoding (:func:`speculative_verify`) builds on the same
filtered distributions: the acceptance test and the rejection-resample both
use the **modified** distribution (after temperature/top-k/top-p), which is
what makes draft-then-verify sampling exact for the filtered target
distribution (Leviathan et al., arXiv:2211.17192, applied per-knob).
"""

from __future__ import annotations

import torch

__all__ = [
    "STREAM_ACCEPT",
    "STREAM_DRAFT",
    "STREAM_RESAMPLE",
    "STREAM_SAMPLE",
    "filtered_logits",
    "modified_probs",
    "random_bits",
    "sample_one",
    "sample_tokens",
    "seed_value",
    "speculative_verify",
    "speculative_verify_tokens",
    "uniform",
]

#: the purposes a request's draws are keyed by, so no two share a draw
STREAM_SAMPLE, STREAM_ACCEPT, STREAM_RESAMPLE, STREAM_DRAFT = 1, 2, 3, 4

_MASK32 = 0xFFFFFFFF


def seed_value(seed: int) -> int:
    """A request seed as the int64 the streams hash (its value mod 2**64)."""
    s = int(seed) % (1 << 64)
    return s - (1 << 64) if s >= (1 << 63) else s


def _mul32(x, c: int):
    """``x * c mod 2**32`` for ``x`` an int64 tensor in ``[0, 2**32)``,
    in 16-bit halves of ``c`` so that no product leaves int64."""
    lo, hi = c & 0xFFFF, c >> 16
    return ((x * lo) + (((x * hi) & 0xFFFF) << 16)) & _MASK32


def _mix32(x):
    """A 32-bit integer hash (``lowbias32``) of an int64 tensor in
    ``[0, 2**32)``."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def random_bits(seed, counter, stream: int, index):
    """32 random bits (int64 in ``[0, 2**32)``) for every ``index`` of the
    draw ``(seed, counter, stream)``: ``seed`` and ``counter`` are int64
    tensors of shape ``[...]``, ``index`` an int64 tensor of shape ``[n]``;
    the result is ``[..., n]``."""
    seed = seed.long()
    h = _mix32((seed & _MASK32) ^ 0x9E3779B9)
    h = _mix32(h ^ ((seed >> 32) & _MASK32))
    h = _mix32(h ^ (counter.long() & _MASK32))
    h = _mix32(h ^ _mul32(torch.full_like(h, stream), 0x85EBCA6B))
    return _mix32(h[..., None] ^ index.long())


def uniform(seed, counter, stream: int, index):
    """Uniform float32 draws in ``[0, 1)`` (24 bits), shaped like
    :func:`random_bits`."""
    return (random_bits(seed, counter, stream, index) >> 8).to(torch.float32) * 2.0 ** -24


def _gumbel(seed, counter, stream: int, n: int, device):
    """Standard Gumbel noise ``[..., n]`` from uniforms in ``(0, 1)``."""
    index = torch.arange(n, device=device)
    u = ((random_bits(seed, counter, stream, index) >> 8).to(torch.float32) + 0.5) * 2.0 ** -24
    return -torch.log(-torch.log(u))


def _categorical(logits, seed, counter, stream: int):
    """One draw from ``softmax(logits)`` along the last axis (Gumbel-max)."""
    g = _gumbel(seed, counter, stream, logits.shape[-1], logits.device)
    return torch.argmax(logits + g, dim=-1)


def _knob(value, like, dtype):
    """A knob as a tensor ``[..., 1]`` broadcasting against ``like [...,
    vocab]``."""
    return torch.as_tensor(value, dtype=dtype, device=like.device)[..., None]


def filtered_logits(logits, temperature, top_k, top_p):
    """Temperature-scaled logits with the top-k / top-p mask applied
    (masked-out entries are ``-inf``).  ``logits [..., vocab]``; knobs of
    shape ``[...]``.  This is the distribution-shaping half of
    :func:`sample_one`, shared with the speculative accept/resample path."""
    vocab = logits.shape[-1]
    temperature = _knob(temperature, logits, torch.float32)
    top_k = _knob(top_k, logits, torch.long)
    top_p = _knob(top_p, logits, torch.float32)

    # temperature-scaled working copy (the divide-by-zero is guarded even
    # though the greedy branch wins the final where)
    safe_t = torch.where(temperature > 0, temperature, torch.ones_like(temperature))
    scaled = logits / safe_t

    desc = torch.sort(scaled, dim=-1, descending=True).values

    # top-k: keep logits >= the k-th largest; k<=0 or k>=vocab disables
    kth = torch.gather(desc, -1, torch.clamp(top_k, 1, vocab) - 1)
    use_k = (top_k > 0) & (top_k < vocab)
    k_mask = torch.where(use_k, scaled >= kth, True)

    # top-p over the sorted softmax: keep the smallest prefix with
    # cumulative mass >= top_p; (cum - p) < top_p keeps the crossing token
    probs = torch.softmax(desc, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_sorted = (cum - probs) < top_p
    # map back by value: the threshold is the smallest kept sorted logit
    n_keep = keep_sorted.sum(-1, keepdim=True)
    p_thresh = torch.gather(desc, -1, torch.clamp(n_keep - 1, 0, vocab - 1))
    use_p = top_p < 1.0
    p_mask = torch.where(use_p, scaled >= p_thresh, True)

    return torch.where(k_mask & p_mask, scaled, float("-inf"))


def modified_probs(logits, temperature, top_k, top_p):
    """The *modified* distribution the sampler actually draws from:
    ``softmax(filtered_logits(...))``.  The speculative acceptance test
    compares draft and target under their modified distributions."""
    return torch.softmax(filtered_logits(logits, temperature, top_k, top_p), dim=-1)


def sample_tokens(logits, seed, counter, temperature, top_k, top_p, stream: int = STREAM_SAMPLE):
    """Sample one token id per row of ``logits [..., vocab]`` from the draw
    ``(seed, counter, stream)`` of each row; knobs, seeds and counters of
    shape ``[...]``.  Greedy rows (``temperature <= 0``) take the argmax."""
    greedy = torch.argmax(logits, dim=-1)
    seed = torch.as_tensor(seed, dtype=torch.long, device=logits.device)
    counter = torch.as_tensor(counter, dtype=torch.long, device=logits.device)
    sampled = _categorical(filtered_logits(logits, temperature, top_k, top_p), seed, counter,
                           stream)
    temperature = torch.as_tensor(temperature, dtype=torch.float32, device=logits.device)
    return torch.where(temperature > 0, sampled, greedy)


def sample_one(logits, seed, counter, temperature, top_k, top_p, stream: int = STREAM_SAMPLE):
    """:func:`sample_tokens` for one row: ``logits [vocab]``, scalar knobs;
    returns a 0-d tensor."""
    return sample_tokens(logits, seed, counter, temperature, top_k, top_p, stream)


def speculative_verify(logits, drafts, draft_probs, seed, counter, temperature, top_k,
                       top_p, speculate):
    """Judge one slot's ``m``-token speculative window.

    ``logits [m, vocab]`` are the target's logits where row ``i`` predicts
    the position ``drafts[i]`` was proposed for; ``draft_probs [m, vocab]``
    are the draft's *modified* distributions at those positions.
    ``speculate`` False collapses to the plain single-token path (row 0
    sampled exactly as the non-speculative decode step would, from the same
    draw), so opted-out slots ride the same step without semantic drift.

    Returns ``(tokens [m], count, accepted)``: emit ``tokens[:count]``;
    ``accepted`` counts kept draft tokens.  There is no bonus token: on an
    all-accept window the emitted suffix is ``drafts`` itself.  The caller
    advances the request's counter by one.  :func:`speculative_verify_tokens`
    is the same over a slot batch."""
    out, count, accepted = speculative_verify_tokens(
        logits[None], drafts[None], draft_probs[None],
        *(torch.as_tensor(a, device=logits.device)[None]
          for a in (seed, counter, temperature, top_k, top_p, speculate)))
    return out[0], count[0], accepted[0]


def speculative_verify_tokens(logits, drafts, draft_probs, seed, counter, temperature, top_k,
                              top_p, speculate):
    """Judge every slot's window: ``logits [slots, m, vocab]``, ``drafts
    [slots, m]``, ``draft_probs [slots, m, vocab]``, per-slot seeds,
    counters, knobs and opt-in ``[slots]``.  Returns ``(tokens [slots, m],
    count [slots], accepted [slots])``.

    * greedy (``temperature <= 0``): accept while the draft matches the
      target argmax; every emitted token is a target argmax row, so the
      emitted stream is the non-speculative greedy stream.
    * stochastic: accept ``d_i`` with probability ``min(1, p(d_i)/q(d_i))``
      (uniforms from ``STREAM_ACCEPT``); on the first rejection, resample
      from ``normalize(max(p - q, 0))`` (``STREAM_RESAMPLE``).
    """
    slots, m, vocab = logits.shape
    dev = logits.device
    seed = torch.as_tensor(seed, dtype=torch.long, device=dev)
    counter = torch.as_tensor(counter, dtype=torch.long, device=dev)
    temperature = torch.as_tensor(temperature, dtype=torch.float32, device=dev)
    top_k = torch.as_tensor(top_k, dtype=torch.long, device=dev)
    top_p = torch.as_tensor(top_p, dtype=torch.float32, device=dev)
    speculate = torch.as_tensor(speculate, dtype=torch.bool, device=dev)
    drafts = drafts.long()

    targets = torch.argmax(logits, dim=-1)
    greedy_ok = drafts == targets

    def per_row(knob):
        return knob[:, None].expand(slots, m)

    p = modified_probs(logits, per_row(temperature), per_row(top_k), per_row(top_p))
    p_d = torch.gather(p, -1, drafts[..., None])[..., 0]
    q_d = torch.gather(draft_probs, -1, drafts[..., None])[..., 0]
    u = uniform(seed, counter, STREAM_ACCEPT, torch.arange(m, device=dev))
    # u < p/q, written mult-form so q(d)=0 (never proposed, but numerically
    # possible) accepts iff p(d) > 0 instead of dividing by zero
    stoch_ok = u * q_d < p_d

    residual = torch.clamp(p - draft_probs, min=0.0)
    total = residual.sum(-1, keepdim=True)
    # p == q makes the residual empty — but then rejection has probability
    # ~0; fall back to p so the draw below stays well-defined
    residual = torch.where(total > 0, residual / total, p)
    g = _gumbel(seed, counter, STREAM_RESAMPLE, m * vocab, dev).view(slots, m, vocab)
    resampled = torch.argmax(torch.log(residual) + g, dim=-1)

    stochastic = (temperature > 0)[:, None]
    ok = torch.where(stochastic, stoch_ok, greedy_ok)
    lead = torch.cumprod(ok.long(), dim=1).sum(1)  # leading accepts
    count = torch.clamp(lead + 1, max=m)  # +1 = the correction/final token
    accepted = torch.minimum(lead, count)
    out = torch.where(stochastic, torch.where(ok, drafts, resampled), targets)

    plain = sample_tokens(logits[:, 0], seed, counter, temperature, top_k, top_p)
    opted_out = out.clone()
    opted_out[:, 0] = plain
    out = torch.where(speculate[:, None], out, opted_out)
    count = torch.where(speculate, count, torch.ones_like(count))
    accepted = torch.where(speculate, accepted, torch.zeros_like(accepted))
    return out, count, accepted
