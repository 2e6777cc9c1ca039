"""Continuous-batching serving engine: one decode step over every slot.

The port of :mod:`distkeras_tpu.serving.engine`.  ``greedy_generate`` runs
a whole batch in lockstep; an online service sees requests that arrive
whenever, want different lengths and sampling, and must not wait for each
other.  This engine is the standard continuous-batching formulation
(Orca/vLLM):

* a fixed ring of ``num_slots`` **batch slots**;
* ONE single-token **decode step** over all slots — every per-request
  quantity (position, last token, seed and counter of its random stream,
  temperature/top-k/top-p, active flag, speculative opt-in) is *data* in
  tensors of fixed shape on the engine's device, so admitting or retiring a
  request changes no shape and allocates nothing;
* a **paged KV cache** (:mod:`distkeras_tpu_torch.serving.cache`): K/V
  pools shared by all slots, updated in place (their storage never moves),
  per-slot page tables, pages allocated at admission and freed at
  retirement;
* between decode steps the host loop **admits** queued requests into free
  slots (prefill) and **retires** finished ones (EOS / max-new-tokens), so
  a long request never convoys short ones;
* SLO metrics through the telemetry registry — TTFT and per-step-latency
  histograms, queue depth, token/request counters.

Fast paths:

* **Prefill width bucketing** — prompts prefill at the smallest
  power-of-two page-multiple width that fits them (``prefill_buckets``)
  instead of the slot's full page capacity; one input shape per *used*
  bucket; ``serving_prefill_padded_tokens`` counts the padding burned.
* **Speculative decoding** (``draft_model``) — a cheaper draft model
  (anything with a ``decode_spec``, e.g. a shallower ``TransformerLM``)
  proposes ``spec_tokens`` tokens per engine iteration via single-token
  draft steps; ONE multi-token target step verifies the window against the
  paged cache and emits the accepted prefix plus a correction token
  (:func:`distkeras_tpu_torch.serving.sampling.speculative_verify`).  There
  is no bonus token, so draft and target caches never develop holes.
  Greedy emitted tokens are target-argmax rows, hence the non-speculative
  greedy stream regardless of draft quality; stochastic requests use exact
  acceptance-rejection resampling.  Requests opt out per call
  (``speculative=False``) and ride the same step as data.

Numerics: ``_block_apply`` restates ``TransformerEncoderBlock``'s math
(the LayerNorms, the fused QKV and output projections, the tanh-GELU MLP)
over the parameter dicts the model's ``decode_spec`` hook slices out, as the
reference's engine restates its flax block: a hot swap replaces those dicts,
and the module binds its own parameters.  A test holds the two to each
other.  Attention is the KV-cache decode's own
:func:`~distkeras_tpu_torch.models.transformer.masked_attention` over a
gather of the slot's pages, ``key_pos <= pos``: plain PyTorch products, as
the reference's are plain XLA ones (no Pallas kernel carries decode).  The
pools are built in ``dtype`` (f32 by default, as in JAX): K/V rows are cast
to it on the scatter, as JAX's ``.at[].set`` casts, and the rows attention
reads back are cast to the query's dtype (torch refuses the mixed-dtype
product that ``jnp`` promotes).  Prefill writes the whole
right-padded bucket into the slot's pages; rows past the prompt are causally
masked and overwritten by decode before they could be attended.

The loop runs on a daemon thread with the engine's device set and
gradients off.  Each step uploads the host-side slot arrays (pinned on a
card, copied without blocking) and brings the sampled tokens back in one
copy, the step's only wait for the device.  A failure in the loop is not
swallowed: every pending request resolves ``"aborted"``, the error is
printed, and ``submit`` raises :class:`EngineCrashed` from then on.

**Step programs.**  The JAX engine compiles its decode step, its draft and
verify steps and one prefill per role and bucket width, and keeps them.  On
a card the port's counterpart is a **captured CUDA graph** for each: one
decode step an engine, one speculative iteration (the ``m`` draft steps and
the verify step with its rollback), one prefill for each ``(role, bucket
width)`` used.  Each reads only fixed storage: the uploaded slot arrays
(the admitted slot and its prompt's length among them, so one prefill
serves every slot and prompt length of its bucket), the page pools and the
parameters.  A program is captured at its first use, after a warm-up on a
side stream that writes the K/V rows the replay then writes again, under
the process-wide capture lock (:mod:`~distkeras_tpu_torch.utils.graphs`);
the engine's graphs share one memory pool and register no generator (the
samplers are counter-based).  A hot swap replaces the parameters' storage,
so it drops every graph, and each captures anew at its next use.
``graph_stats`` counts captures and replays.  A failed capture or replay
crashes the engine as any loop failure does; nothing falls back to eager.
On the CPU the programs run eagerly.  :data:`CAPTURE_PROGRAMS`, read when
an engine is built, turns capture off on a card (the ``_use_graphs``
attribute does too, on an engine without a mesh before its first step).

Random numbers are counter-based streams keyed by each request's seed
(ROADMAP C9, :mod:`~distkeras_tpu_torch.serving.sampling`): a request's
counter advances once per engine iteration *of that request*, so its
sampled tokens are a function of (params, prompt, knobs, seed) alone.

**Tensor-parallel decode** (``mesh=``, a 1-D mesh over the model axis,
e.g. ``make_mesh(world, axis_name="model")``): each rank keeps its ``heads
/ tp`` block of every block's ``qkv`` weight and bias and the matching
input columns of ``proj``, and page pools of ``heads / tp`` heads; the rest
of the target, and the draft model with its pools, stay whole on every
rank.  Each rank contracts its heads with ``proj`` without the bias, the
partials are summed over the axis (one all-reduce a block), and the bias is
added once, after the sum, as the reference's ``shard_map`` step does; the
logits come out whole on every rank.  JAX drives every device from one
process; the port runs one process per card (ROADMAP C10), so every rank
builds the engine with the same arguments and runs the host loop in
lockstep.  Mesh rank 0 owns the front end (``submit``, ``generate``, the
queue, ``cancel``, ``drain``, ``stop``) and decides: before each device
operation (a prefill, a decode step, a speculative iteration, a hot swap)
it broadcasts a fixed-size **plan** that carries the operation, every slot
array, the page tables and the prompt, over a gloo group of the mesh's
ranks with a timeout (:data:`PLAN_TIMEOUT_S`); idle, it broadcasts an idle plan
every loop turn, and ``stop`` a stop plan, so no follower waits on a plan
that never comes.  The followers (every other rank) only execute: they
run the same blocks (their all-reduces pair with rank 0's) and sample
nothing; the tokens the next plan feeds are rank 0's, and so are the
drafts a verify step feeds and the counts it rolls back, broadcast in the
step, so no rank's state can depart from rank 0's by a rounding.  A timed-out
collective crashes the engine on the rank that waits
(:class:`EngineCrashed`).  ``hot_swap`` is called on every rank with the
same model, as the constructor is; the plan says when it applies.  On a
card every rank captures the same step programs (the same roles and
buckets, in the order rank 0's plans give) and replays them in lockstep:
the all-reduce a block, and the drafts and counts a verify step broadcasts
from rank 0, are inside the graphs, over a step group that must run NCCL
(a gloo mesh on a card is refused unless :data:`CAPTURE_PROGRAMS` is off);
the plans stay outside them, host data decided before the step, which a
follower uploads into the slot buffers its replay reads.  A replayed
collective has no watchdog, so every rank waits for its replays with the
plan timeout as the deadline (``utils.graphs.wait_bounded``) instead of
blocking in a read-back: a peer that died before its replay crashes the
waiting rank's engine once the step group's communicator is aborted.  A
hot swap drops every rank's graphs at the same plan.  ``all_reduces`` counts the
all-reduces the steps ran: a captured program's, recorded once, count at
each replay; the warm-up and the recording before a capture count none.

A ``StagedLM`` target (raw with its staged parameters, or as a
``TrainedModel``) resolves through its ``decode_spec`` to the layout a
``TransformerLM`` gives, and is served as one, with ``mesh=`` too.

**Accounting.**  With telemetry on and ``DISTKERAS_ACCOUNTING`` not falsey,
the engine bills its registry's per-tenant ledger
(:mod:`~distkeras_tpu_torch.telemetry.accounting`) at four points of the
host loop: admission (prompt tokens, queue wait, prefill seconds and the
first token), each decode step (every active slot's tokens and an even
share of the step's wall time), each speculative verdict (accepted and
rejected drafts) and retirement (KV page-seconds).  The ledger reads
host-visible values only and adds no device sync; off, the engine holds no
ledger and each point is one ``is None`` check.  With the runtime sanitizer
on, the engine's condition variable runs under the lock-order watchdog
(``lockwatch``), and the loop's read-backs are declared transfers to the
transfer guard.

**Chaos.**  With fault injection armed (:mod:`~distkeras_tpu_torch.chaos`,
``DISTKERAS_CHAOS``), the loop crosses the ``replica`` site between
admission and the decode step of every iteration with a request in flight:
a seeded ``kill_replica`` raises :class:`~distkeras_tpu_torch.chaos.
ChaosKilled` there, on the loop thread, and the engine crashes as on any
other failure (every request aborted, ``submit`` and ``hot_swap`` raise
:class:`EngineCrashed`), which is what the serving tier's failover is
tested against.  Unarmed, the site is one cached bool check an iteration.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import sys
import threading
import time
import traceback
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from distkeras_tpu_torch.models.transformer import masked_attention
from distkeras_tpu_torch.parallel.mesh import (
    _route,
    all_reduce_sum,
    broadcast,
    mesh_group,
    mesh_rank,
    mesh_size,
    resolve_device,
    transport_stats,
)
from distkeras_tpu_torch.serving.cache import PagedKVCache, append_rows, rollback_rows
from distkeras_tpu_torch.serving.frontend import GenerateRequest, GenerateResult, RequestQueue
from distkeras_tpu_torch.serving.sampling import (
    STREAM_DRAFT,
    modified_probs,
    sample_tokens,
    seed_value,
    speculative_verify_tokens,
)
from distkeras_tpu_torch import chaos as _chaos
from distkeras_tpu_torch import sanitizer as _sanitizer
from distkeras_tpu_torch.sanitizer import lockwatch
from distkeras_tpu_torch.telemetry import accounting as _accounting
from distkeras_tpu_torch.telemetry import runtime as _truntime
from distkeras_tpu_torch.telemetry.trace import NOOP_SPAN, trace as _trace
from distkeras_tpu_torch.utils import graphs

__all__ = ["EngineCrashed", "ServingEngine", "serving_metrics"]

class EngineCrashed(RuntimeError):
    """The engine's host loop died: every request aborted, the replica is
    dead.  Raised by ``submit``/``hot_swap`` so a caller can tell "dead"
    from "saturated"."""


def serving_metrics(registry=None) -> dict:
    """Get-or-create the engine's SLO instruments on ``registry`` (default:
    the process-global one), with the JAX package's names, help text and
    bucket ladder."""
    if registry is None:
        from distkeras_tpu_torch.telemetry.metrics import metrics as registry
    return {
        "ttft": registry.histogram(
            "serving_ttft_seconds",
            help="time from request admission-queue entry to first token",
        ),
        "token_latency": registry.histogram(
            "serving_token_latency_seconds",
            help="wall time of one continuous-batching decode step",
        ),
        "prefill_seconds": registry.histogram(
            "serving_prefill_seconds",
            help="wall time of one prefill dispatch (bucketed width)",
        ),
        "queue_depth": registry.gauge(
            "serving_queue_depth", help="requests waiting for a batch slot"
        ),
        "active_slots": registry.gauge(
            "serving_active_slots", help="batch slots generating right now"
        ),
        "pages_in_use": registry.gauge(
            "serving_kv_pages_in_use", help="allocated KV cache pages"
        ),
        "tokens": registry.counter(
            "serving_tokens_total", help="tokens generated across all requests"
        ),
        "requests": registry.counter(
            "serving_requests_total", help="requests completed (any finish reason)"
        ),
        "rejected": registry.counter(
            "serving_requests_rejected_total",
            help="requests shed by queue backpressure",
        ),
        "prefill_padded": registry.counter(
            "serving_prefill_padded_tokens",
            help="padding tokens burned by bucketed prefill (width - prompt)",
        ),
        "decode_steps": registry.counter(
            "serving_decode_steps_total",
            help="target decode/verify iterations (speculative emits >1 "
                 "token per step, so steps/tokens < 1)",
        ),
        "spec_proposed": registry.counter(
            "serving_spec_proposed_total",
            help="draft tokens proposed by speculative decoding",
        ),
        "spec_accepted": registry.counter(
            "serving_spec_accepted_total",
            help="draft tokens accepted by target verification",
        ),
        "hot_swaps": registry.counter(
            "serving_hot_swaps_total",
            help="in-place param hot-swaps applied by this engine",
        ),
    }


# ------------------------------------------------------------ model slicing


@dataclasses.dataclass
class _Spec:
    """Normalized decode view of one causal LM: embedding tables, per-block
    parameter dicts, final LN + head, and the static config the steps read.
    Built from the model's ``decode_spec`` hook."""

    tok: Any
    pos: Any
    blocks: List[Any]
    final_ln: Any
    head: Any
    dim: int
    heads: int
    head_dim: int
    max_len: int
    vocab: int
    ln_eps: float

    def params(self) -> dict:
        return {
            "tok": self.tok, "pos": self.pos, "blocks": list(self.blocks),
            "final_ln": self.final_ln, "head": self.head,
        }


def _resolve_spec(model, params, device) -> _Spec:
    """Accept a ``TrainedModel``, a ``TorchModel`` adapter + params, or a
    module or adapter with a ``decode_spec`` hook + params (name -> tensor;
    a ``StagedLM``'s staged tree); the tensors are put on ``device``."""
    from distkeras_tpu_torch.models.adapter import TorchModel, TrainedModel

    if isinstance(model, TrainedModel):
        return _resolve_spec(model.adapter, model.params, device)
    if isinstance(model, TorchModel):
        model = model.module
    hook = getattr(model, "decode_spec", None)
    if hook is None:
        raise TypeError(
            f"{type(model).__name__} has no decode_spec hook; serving "
            "supports TransformerLM and StagedLM"
        )
    if params is None:
        raise ValueError(
            "params required when passing a bare module/adapter "
            "(a TrainedModel carries its own)"
        )
    raw = hook(params)
    cfg = raw["config"]

    def put(tree):
        return {k: v.detach().to(device) for k, v in tree.items()}

    return _Spec(
        tok=raw["embed"]["tok"].detach().to(device),
        pos=raw["embed"]["pos"].detach().to(device),
        blocks=[put(b) for b in raw["blocks"]],
        final_ln=put(raw["final_ln"]),
        head=put(raw["head"]),
        dim=int(cfg["dim"]),
        heads=int(cfg["heads"]),
        head_dim=int(cfg["head_dim"]),
        max_len=int(cfg["max_len"]),
        vocab=int(cfg["vocab_size"]),
        ln_eps=float(cfg["ln_eps"]),
    )


def _block_apply(bp, x, attend, eps, heads, head_dim, psum=None):
    """One encoder block over the parameter dict ``bp`` (the names of
    ``TransformerEncoderBlock``), with its math: pre-LayerNorm attention
    and tanh-GELU MLP, dropout off.  ``attend(q, k, v)`` (``[b, l, heads,
    head_dim]`` each) supplies the paged-cache attention.  ``psum`` is the
    sum over the tensor-parallel axis (None unsharded): ``heads`` is then
    this rank's, each rank contracts them with ``proj`` without the bias,
    and the bias is added once, after the sum (adding it in each rank's
    product would add it ``tp`` times)."""
    dim = x.shape[-1]
    b, l = x.shape[:2]
    h = F.layer_norm(x, (dim,), bp["ln1.weight"], bp["ln1.bias"], eps)
    qkv = F.linear(h, bp["attn.qkv.weight"], bp["attn.qkv.bias"])
    q, k, v = qkv.view(b, l, 3, heads, head_dim).unbind(2)
    out = attend(q, k, v).reshape(b, l, heads * head_dim)
    if psum is None:
        x = x + F.linear(out, bp["attn.proj.weight"], bp["attn.proj.bias"])
    else:
        x = x + (psum(F.linear(out, bp["attn.proj.weight"])) + bp["attn.proj.bias"])
    h = F.layer_norm(x, (dim,), bp["ln2.weight"], bp["ln2.bias"], eps)
    h = F.gelu(F.linear(h, bp["fc1.weight"], bp["fc1.bias"]), approximate="tanh")
    return x + F.linear(h, bp["fc2.weight"], bp["fc2.bias"])


def _shard_heads(spec: _Spec, tp: int, index: int) -> _Spec:
    """Rank ``index``'s part of ``spec`` over a tensor-parallel axis of
    ``tp`` ranks: its ``heads / tp`` block of each ``attn.qkv`` weight (read
    as ``[3, heads, head_dim, dim]``) and bias (``[3, heads, head_dim]``),
    and the matching input columns of ``attn.proj.weight`` (``[dim, heads *
    head_dim]``), as new tensors; every other tensor whole (shared)."""
    hl, hd = spec.heads // tp, spec.head_dim
    cut = slice(index * hl, (index + 1) * hl)

    def block(bp):
        bp = dict(bp)
        w = bp["attn.qkv.weight"].view(3, spec.heads, hd, -1)[:, cut]
        bp["attn.qkv.weight"] = w.reshape(3 * hl * hd, -1).clone()
        bp["attn.qkv.bias"] = bp["attn.qkv.bias"].view(3, spec.heads, hd)[:, cut].reshape(-1).clone()
        bp["attn.proj.weight"] = bp["attn.proj.weight"][:, index * hl * hd:(index + 1) * hl * hd].clone()
        return bp

    return dataclasses.replace(spec, blocks=[block(b) for b in spec.blocks], heads=hl)


def _mesh_groups(mesh, heads: int, timeout: float):
    """``(tp, index, step group, plan group)`` of a serving mesh: its size,
    this rank's index on it, a group of its ranks for the step's
    all-reduces (the mesh's backend) and a gloo group for the plans, both
    with ``timeout``.  ``(1, 0, None, None)`` without a mesh or on one
    rank.  The JAX package's checks: one axis, ``heads`` divisible."""
    if mesh is None:
        return 1, 0, None, None
    names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
    if len(names) != 1:
        raise ValueError(f"serving mesh must be 1-D (one tensor-parallel axis); got axes {names}")
    tp = int(mesh.size(0))
    if heads % tp:
        raise ValueError(f"model heads {heads} not divisible by mesh size {tp}")
    group = mesh_group(mesh)
    if tp == 1 or group is None:
        return 1, 0, None, None
    ranks = dist.get_process_group_ranks(group)
    wait = datetime.timedelta(seconds=float(timeout))
    step = dist.new_group(ranks, timeout=wait, backend=dist.get_backend(group),
                          use_local_synchronization=True)
    plan = dist.new_group(ranks, timeout=wait, backend="gloo", use_local_synchronization=True)
    return tp, mesh_rank(mesh), step, plan


def _head_apply(final_ln, head, x, eps):
    h = F.layer_norm(x, (x.shape[-1],), final_ln["weight"], final_ln["bias"], eps)
    return F.linear(h, head["weight"], head["bias"])


def _paged_attention(q, kpool, vpool, tables, hidden):
    """Each slot's queries ``q [slots, m, heads, head_dim]`` over its pages
    (``kpool``/``vpool [pages, page_size, heads, head_dim]`` of one layer,
    gathered through ``tables [slots, pages_per_slot]``); ``hidden [slots,
    m, 1, ctx]`` is True at the keys past each query's position."""
    s = q.shape[0]
    # the pools' dtype may differ from the queries' (``dtype=``): read back in q's
    kg = kpool[tables].reshape(s, -1, *kpool.shape[-2:]).to(q.dtype)  # [slots, ctx, heads, hd]
    vg = vpool[tables].reshape(s, -1, *vpool.shape[-2:]).to(q.dtype)
    return masked_attention(q, kg, vg, hidden)


def _resolve_buckets(prefill_buckets, page_size: int, max_context: int):
    """The prefill width ladder: ascending page-multiple widths ending at
    ``max_context``.  Default: ``page_size * 2**i`` capped at capacity."""
    if prefill_buckets is None:
        widths, w = [], page_size
        while w < max_context:
            widths.append(w)
            w *= 2
        widths.append(max_context)
        return tuple(widths)
    widths = sorted({int(w) for w in prefill_buckets})
    if not widths:
        raise ValueError("prefill_buckets must be non-empty")
    for w in widths:
        if w < 1 or w > max_context or w % page_size:
            raise ValueError(
                f"prefill bucket {w} must be a positive multiple of "
                f"page_size {page_size} and <= max context {max_context}"
            )
    if widths[-1] != max_context:
        widths.append(max_context)  # every admissible prompt needs a bucket
    return tuple(widths)


# -------------------------------------------------------------- bookkeeping


class _Pending:
    """Handle returned by :meth:`ServingEngine.submit` — resolves to a
    :class:`GenerateResult` when the request retires."""

    __slots__ = ("request", "max_new", "enqueue_t", "_event", "_result")

    def __init__(self, request: GenerateRequest, max_new: int, enqueue_t: float):
        self.request = request
        self.max_new = max_new
        self.enqueue_t = enqueue_t
        self._event = threading.Event()
        self._result: Optional[GenerateResult] = None

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> Optional[GenerateResult]:
        """Block for the result; ``None`` on timeout."""
        if not self._event.wait(timeout):
            return None
        return self._result

    def _resolve(self, result: GenerateResult) -> None:
        self._result = result
        self._event.set()


class _Program:
    """One captured step program: its graph, its static output (None for a
    draft prefill, and on a follower), the all-reduces recorded in it and
    how often it was replayed."""

    __slots__ = ("graph", "out", "reduces", "replays")

    def __init__(self, graph, out, reduces):
        self.graph, self.out, self.reduces, self.replays = graph, out, reduces, 0


class _SlotState:
    """Host-side record for one occupied batch slot."""

    __slots__ = ("pending", "tokens", "plen", "ttft_s", "pages", "admit_t")

    def __init__(self, pending: _Pending, plen: int):
        self.pending = pending
        self.tokens: List[int] = []
        self.plen = plen
        self.ttft_s = 0.0
        self.pages = 0        # pages held — the page-seconds numerator
        self.admit_t = 0.0    # prefill-done wall time — its clock start


# The host-side slot arrays uploaded before every step: name -> dtype.
# ``ctr``/``dctr`` count the draws of a request's target and draft streams.
_SLOT_ARRAYS = {
    "pos": torch.int64, "last": torch.int64, "seed": torch.int64, "ctr": torch.int64,
    "dctr": torch.int64, "temp": torch.float32, "topk": torch.int64, "topp": torch.float32,
    "active": torch.bool, "spec_on": torch.bool,
}

# The operations a lockstep plan orders (the plan's word 0).
_OP_IDLE, _OP_PREFILL, _OP_DECODE, _OP_SPEC, _OP_SWAP, _OP_STOP = range(6)
_PLAN_HEADER = 5  # op, slot, width, plen, spec_on
#: seconds a rank of a serving mesh waits on a plan or a step's collective
#: before its engine crashes (rank 0 sends an idle plan every loop turn)
PLAN_TIMEOUT_S = 60.0
#: whether an engine built on a card captures its step programs as CUDA
#: graphs (read when an engine is built, on every rank of a mesh alike); a
#: mesh over gloo on a card runs them eagerly only with this off
CAPTURE_PROGRAMS = True
_FOLLOWER = ("this rank follows mesh rank 0, which owns the serving front end (submit, "
             "generate, cancel, drain, resume, stop): send requests there")


# -------------------------------------------------------------------- engine


class ServingEngine:
    """Online inference engine with continuous batching over a paged KV
    cache.  See the module docstring for the design; quick start::

        engine = ServingEngine(trained_model, num_slots=4, page_size=16)
        out = engine.generate([1, 2, 3], max_new_tokens=8)   # blocking
        pending = engine.submit(GenerateRequest(prompt=[1, 2, 3]))  # async
        result = pending.result(timeout=30)
        engine.stop()

    The host loop runs on a daemon thread started lazily by the first
    ``submit``/``generate`` (or explicitly via :meth:`start`).  ``model``
    is a ``TrainedModel``, or a ``TransformerLM`` (raw or behind
    ``TorchModel``) plus ``params``.  ``device`` defaults to ``"cuda"`` and
    raises without a card; pass ``device="cpu"`` to serve on the CPU.

    Fast-path knobs: ``prefill_buckets`` (width ladder; default
    power-of-two), ``draft_model``/``draft_params``/``spec_tokens``
    (speculative decoding).  ``dtype`` is the KV page pools' dtype (both
    the target's and the draft's), f32 by default as in JAX: bf16 pools
    halve the cache for f32 parameters.
    """

    def __init__(self, model, params=None, *, num_slots: int = 4,
                 page_size: int = 16, pages_per_slot: Optional[int] = None,
                 num_pages: Optional[int] = None, queue_size: int = 64,
                 registry=None, dtype=torch.float32,
                 prefill_buckets: Optional[Sequence[int]] = None,
                 draft_model=None, draft_params=None, spec_tokens: int = 4,
                 mesh=None, device="cuda"):
        self.device = resolve_device(device)
        # the step programs: captured graphs on a card (the attribute turns
        # capture off on an engine without a mesh), keyed as the JAX engine
        # keys its programs, sharing one memory pool; a mesh's collectives
        # are recorded in them, which only NCCL's can be
        self._use_graphs = self.device.type == "cuda" and CAPTURE_PROGRAMS
        if self._use_graphs and mesh_size(mesh) > 1:
            graphs.require_nccl(
                [mesh_group(mesh)], "a serving mesh's captured step programs",
                "serve over NCCL (one rank per card), or build every rank's engine with "
                "serving.engine.CAPTURE_PROGRAMS = False (eager steps)")
        spec = _resolve_spec(model, params, self.device)
        self._plan_timeout = float(PLAN_TIMEOUT_S)
        self._tp, self._tp_index, self._step_group, self._plan_group = _mesh_groups(
            mesh, spec.heads, self._plan_timeout)
        #: this rank decides and owns the front end (every rank without a mesh)
        self.leads = self._tp_index == 0
        #: all-reduces the tensor-parallel steps ran (one a target block a pass)
        self.all_reduces = 0
        self._psum = self._all_reduce if self._tp > 1 else None
        if self._tp > 1:
            spec = _shard_heads(spec, self._tp, self._tp_index)
        self._spec = spec
        if pages_per_slot is None:
            pages_per_slot = -(-spec.max_len // page_size)
        self.num_slots = int(num_slots)
        self._cache = PagedKVCache(
            num_layers=len(spec.blocks), num_slots=num_slots,
            page_size=page_size, pages_per_slot=pages_per_slot,
            heads=spec.heads, head_dim=spec.head_dim,
            num_pages=num_pages, dtype=dtype, device=self.device,
        )
        self._width = self._cache.max_context()
        self._buckets = _resolve_buckets(
            prefill_buckets, self._cache.page_size, self._width)
        self._queue = RequestQueue(queue_size)
        self._metrics = serving_metrics(registry)
        # the registry's per-tenant ledger, or None (accounting off)
        self._ledger = _accounting.maybe_ledger(registry)
        # the runtime sanitizer, read once at build as the training engine does
        self._sanitize = _sanitizer.enabled()

        # --------------------------------------------------- draft / verify
        self._draft_spec = None
        self._draft_cache = None
        self._spec_tokens = int(spec_tokens)
        if draft_model is not None:
            if self._spec_tokens < 1:
                raise ValueError("spec_tokens must be >= 1")
            dspec = _resolve_spec(draft_model, draft_params, self.device)
            if dspec.vocab != spec.vocab:
                raise ValueError(
                    f"draft vocab {dspec.vocab} != target vocab {spec.vocab}"
                )
            serviceable = min(self._width, spec.max_len)
            if dspec.max_len < serviceable:
                raise ValueError(
                    f"draft max_len {dspec.max_len} < serviceable context "
                    f"{serviceable}; pick a draft trained at the same length"
                )
            self._draft_spec = dspec
            # same page geometry so the target's page tables address the
            # draft pools directly; its bookkeeping (free list) is unused
            self._draft_cache = PagedKVCache(
                num_layers=len(dspec.blocks), num_slots=num_slots,
                page_size=page_size, pages_per_slot=pages_per_slot,
                heads=dspec.heads, head_dim=dspec.head_dim,
                num_pages=self._cache.num_pages, dtype=dtype, device=self.device,
            )

        # Slot arrays: host tensors (pinned on a card) with numpy views the
        # loop edits, and their device twins, refreshed before every step.
        s = self.num_slots
        pin = self.device.type == "cuda"
        host = {name: torch.zeros(s, dtype=dt, pin_memory=pin)
                for name, dt in _SLOT_ARRAYS.items()}
        host["tables"] = torch.zeros(self._cache.tables.shape, dtype=torch.int64,
                                     pin_memory=pin)
        host["prompt"] = torch.zeros(self._width, dtype=torch.int64, pin_memory=pin)
        # the slot being admitted and its prompt's length, read by the prefill
        host["at"] = torch.zeros(2, dtype=torch.int64, pin_memory=pin)
        self._host = host
        self._dev = {name: torch.zeros_like(t, device=self.device) for name, t in host.items()}
        self._pos = host["pos"].numpy()        # position of the fed token
        self._last = host["last"].numpy()      # token being fed this step
        self._seed = host["seed"].numpy()
        self._ctr = host["ctr"].numpy()
        self._dctr = host["dctr"].numpy()
        self._temp = host["temp"].numpy()
        self._topk = host["topk"].numpy()
        self._topp = host["topp"].numpy()
        self._active = host["active"].numpy()
        self._spec_on = host["spec_on"].numpy()
        self._topp[:] = 1.0

        self._slots: List[Optional[_SlotState]] = [None] * s
        self._cv = lockwatch.maybe_wrap(threading.Condition(), "serving.engine")
        self._running = False
        self._thread: Optional[threading.Thread] = None
        # drain/hot-swap/cancel state, all owned by the loop thread except
        # the flags themselves (set under _cv by callers)
        self._crashed = False
        self._error: Optional[BaseException] = None
        self._draining = False
        self._drain_ack = False
        self._swap: Optional[Tuple[_Spec, threading.Event]] = None
        self._cancelled: List[_Pending] = []
        # the request between the queue and its slot (its prefill running)
        self._admitting: Optional[_Pending] = None
        self._sent = False  # whether this loop turn sent a plan
        self._programs: Dict[tuple, _Program] = {}
        self._pool = None
        #: programs captured and replayed (cumulative: a hot swap recaptures)
        self.graph_stats = {"captures": 0, "replays": 0}

        if self._plan_group is not None:
            # the plan: a header, the slot arrays, the page tables, the prompt
            self._plan = torch.zeros(_PLAN_HEADER + len(_SLOT_ARRAYS) * s
                                     + self._cache.tables.size + self._width, dtype=torch.int64)
            # every rank's loop runs from here on, in lockstep
            self.start()

    # ------------------------------------------------------- lockstep (mesh)

    def _all_reduce(self, t):
        self.all_reduces += 1
        return all_reduce_sum([t], self._step_group)[0]

    def _plan_fields(self):
        """The plan's numpy views after the header, in order: each slot
        array (float32 fields by their bits), the tables, the prompt."""
        buf = self._plan.numpy()
        out, at, s = [], _PLAN_HEADER, self.num_slots
        for name in _SLOT_ARRAYS:
            out.append((self._host[name].numpy(), buf[at:at + s]))
            at += s
        n = self._cache.tables.size
        out.append((self._cache.tables.reshape(-1), buf[at:at + n]))
        out.append((self._host["prompt"].numpy(), buf[at + n:]))
        return out

    def _lockstep(self, op: int, slot: int = 0, width: int = 0, plen: int = 0,
                  spec_on: bool = False) -> None:
        """Rank 0: broadcast the plan of the next operation to the mesh (a
        no-op without one, and on a follower)."""
        if self._plan_group is None or not self.leads:
            return
        buf = self._plan.numpy()
        buf[:_PLAN_HEADER] = (op, slot, width, plen, int(spec_on))
        for host, field in self._plan_fields():
            field[:] = host.view(np.int32) if host.dtype == np.float32 else host
        dist.broadcast(self._plan, src=dist.get_global_rank(self._plan_group, 0),
                       group=self._plan_group)
        self._sent = True

    def _receive_plan(self) -> Tuple[int, int, int, int, bool]:
        """A follower: wait for rank 0's next plan (within the plan group's
        timeout) and take its slot arrays, tables and prompt as its own;
        returns the header."""
        dist.broadcast(self._plan, src=dist.get_global_rank(self._plan_group, 0),
                       group=self._plan_group)
        for host, field in self._plan_fields():
            if host.dtype == np.float32:
                host[:] = field.astype(np.int32).view(np.float32)
            else:
                host[:] = field
        op, slot, width, plen, spec_on = (int(v) for v in self._plan.numpy()[:_PLAN_HEADER])
        return op, slot, width, plen, bool(spec_on)

    def _from_leader(self, t, shape, dtype):
        """Rank 0's ``t`` on every rank: a broadcast over the step group, of
        device data, so that a captured speculative iteration holds it
        (gloo stages a CUDA tensor through the host, counted in
        ``transport_stats``); ``t`` itself without a mesh.  A follower
        passes None."""
        if self._step_group is None:
            return t
        t = t.to(dtype) if self.leads else torch.empty(shape, dtype=dtype, device=self.device)
        if _route(self._step_group, t) == "host":
            transport_stats["host_staged_bytes"] += 2 * t.numel() * t.element_size()
        return broadcast([t], 0, self._step_group)[0]

    def _follow(self) -> None:
        """A follower's loop: execute rank 0's plans until a stop plan."""
        k, v = self._cache.k_pages, self._cache.v_pages
        while True:
            op, slot, width, plen, spec_on = self._receive_plan()
            if op == _OP_STOP:
                return
            if op == _OP_IDLE:
                continue
            if op == _OP_SWAP:
                self._follow_swap()
                continue
            if op == _OP_PREFILL:
                self._host["at"].numpy()[:] = (slot, plen)
            self._upload()
            with self._cv:
                spec = self._spec
            # rank 0's programs, under its keys: captured and replayed in its order
            if op == _OP_PREFILL:
                self._program(("prefill", "target", width), lambda: self._prefill(
                    spec, k, v, width, sample=False, psum=self._psum))
                if spec_on:
                    dc = self._draft_cache
                    self._program(("prefill", "draft", width), lambda: self._prefill(
                        self._draft_spec, dc.k_pages, dc.v_pages, width, sample=False))
            elif op == _OP_DECODE:
                self._program(("decode",), lambda: self._decode(spec, k, v))
            else:
                self._program(("spec",), lambda: self._spec_iteration(spec))
            self._await_step()  # the host buffers are rewritten next

    def _follow_swap(self) -> None:
        """A follower applies the swap its own ``hot_swap`` call registered
        (every rank is given the same model), when rank 0's plan says."""
        with self._cv:
            if not self._cv.wait_for(lambda: self._swap is not None,
                                     timeout=self._plan_timeout):
                raise RuntimeError("mesh rank 0 applied a hot_swap this rank was not given: "
                                   "call hot_swap on every rank with the same model")
        self._apply_swap()

    # --------------------------------------------------------- device steps

    def _upload(self) -> None:
        """Copy the host slot arrays (and the page tables) to the device.
        The copies do not block: the host buffers are rewritten only after
        the step's token copy, which waits for everything before it."""
        np.copyto(self._host["tables"].numpy(), self._cache.tables)
        for name, dst in self._dev.items():
            dst.copy_(self._host[name], non_blocking=True)

    def _await_step(self) -> None:
        """Wait for the step this rank launched, before its read-back (rank
        0) or the next plan (a follower).  Over a mesh whose programs are
        captured the wait has the plan timeout as its deadline: a replayed
        collective has no watchdog, so a peer that died before its replay
        would block a read-back for ever.  Past the deadline the step
        group's communicator is aborted (waited for a bounded time), which
        frees the waiting replay, and ``TimeoutError``, saying how the abort
        went, crashes the engine (ROADMAP C23).  Elsewhere a
        follower on a card synchronises, and rank 0's read-back waits."""
        if self._use_graphs and self._step_group is not None:
            event = torch.cuda.Event()
            event.record()
            graphs.wait_bounded(event, self._plan_timeout,
                                lambda: graphs.abort_group(self._step_group),
                                "a serving mesh's replayed step")
        elif not self.leads and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _program(self, key: tuple, fn):
        """Run one step program, ``fn()``, which reads only the engine's
        fixed storage: eagerly, or on a card as its captured graph, captured
        at the key's first use.  Returns ``fn``'s output: on a card the
        graph's static output, in the pool the engine's graphs share, where
        a replay of a graph captured before it may write, so the loop reads
        it back before the next step.  (The target prefill's token is read
        after the draft's prefill, which is captured after it, while the
        token's memory is held, and so never writes there.)"""
        if not self._use_graphs:
            return fn()
        program = self._programs.get(key)
        if program is None:
            program = self._programs[key] = self._capture(fn)
        program.graph.replay()
        program.replays += 1
        self.graph_stats["replays"] += 1
        self.all_reduces += program.reduces
        return program.out

    def _capture(self, fn) -> _Program:
        """Capture ``fn()`` as a CUDA graph in the engine's memory pool,
        under the process-wide capture lock, after a warm-up run on a side
        stream.  The warm-up runs over the step's own inputs, so it writes
        the K/V rows the replay that follows writes again before it reads
        them (a verify's rollback zeroes rows of the window the replay
        writes whole): it needs no undo.  No generator is registered: the
        samplers are counter-based (ROADMAP C9).  Over a mesh the step
        group's communicator is made first, every rank capturing the same
        program at the same plan; the warm-up's and the recording's
        all-reduces are not counted in ``all_reduces``, each replay's are."""
        reduces = self.all_reduces
        with graphs.CAPTURE_LOCK:
            graphs.warm_up_groups([self._step_group], self.device)
            graphs.warm_up(fn, self.device)
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            graph = torch.cuda.CUDAGraph()
            recorded = self.all_reduces
            with graphs.capturing(graph, self._pool):
                out = fn()
        program = _Program(graph, out, self.all_reduces - recorded)
        self.all_reduces = reduces
        self.graph_stats["captures"] += 1
        return program

    def _drop_programs(self) -> None:
        """Forget every captured program and their memory pool: they read
        the parameters' storage, which a hot swap replaces (a graph holds
        addresses, not the tensors).  Each captures anew at its next use."""
        self._programs.clear()
        self._pool = None

    def _prefill(self, spec: _Spec, kpool, vpool, width: int, sample: bool, psum=None):
        """Run the admitted slot's right-padded prompt (``prompt[:width]``
        of the uploaded arrays) through ``spec``, writing every row's K/V
        into the slot's first ``width // page_size`` pages; with ``sample``,
        return the first token (the request's draw 0).  The slot and the
        prompt's length are device data (``at`` of the uploaded arrays), as
        they are arguments of the JAX engine's prefill program."""
        st = self._dev
        ps = self._cache.page_size
        npages = width // ps
        slot, plen = st["at"][:1], st["at"][1:]
        table = st["tables"].index_select(0, slot)[0, :npages]
        tokens = st["prompt"][:width][None]
        positions = torch.clamp(torch.arange(width, device=self.device), 0, spec.max_len - 1)
        x = spec.tok[tokens] + spec.pos[positions][None]
        hidden = torch.ones(width, width, dtype=torch.bool, device=self.device).triu(1)
        hidden = hidden[None, :, None, :]

        def attend(li):
            def fn(q, k, v):
                # stash the whole padded chunk into this slot's pages; rows
                # past the prompt are causally masked below, never attended
                kpool[li, table] = k[0].reshape(npages, ps, *k.shape[-2:]).to(kpool.dtype)
                vpool[li, table] = v[0].reshape(npages, ps, *v.shape[-2:]).to(vpool.dtype)
                return masked_attention(q, k, v, hidden)

            return fn

        for li, bp in enumerate(spec.blocks):
            x = _block_apply(bp, x, attend(li), spec.ln_eps, spec.heads, spec.head_dim, psum)
        if not sample:
            return None
        logits = _head_apply(spec.final_ln, spec.head, x.index_select(1, plen - 1)[:, 0],
                             spec.ln_eps)
        knob = lambda name: st[name].index_select(0, slot)
        return sample_tokens(logits, knob("seed"), knob("ctr"), knob("temp"), knob("topk"),
                             knob("topp"))

    def _run_blocks(self, spec: _Spec, kpool, vpool, fed, positions, psum=None):
        """Feed ``fed [slots, m]`` tokens at ``positions [slots, m]`` through
        ``spec``, appending their K/V at each slot's position; returns the
        logits ``[slots, m, vocab]``."""
        st = self._dev
        tables, pos = st["tables"], positions[:, 0]
        x = spec.tok[fed] + spec.pos[torch.clamp(positions, 0, spec.max_len - 1)]
        key_pos = torch.arange(self._width, device=self.device)
        hidden = (key_pos[None, None, :] > positions[:, :, None])[:, :, None, :]

        def attend(li):
            def fn(q, k, v):
                append_rows(kpool, li, tables, pos, k)
                append_rows(vpool, li, tables, pos, v)
                return _paged_attention(q, kpool[li], vpool[li], tables, hidden)

            return fn

        for li, bp in enumerate(spec.blocks):
            x = _block_apply(bp, x, attend(li), spec.ln_eps, spec.heads, spec.head_dim, psum)
        return _head_apply(spec.final_ln, spec.head, x, spec.ln_eps)

    def _decode(self, spec: _Spec, kpool, vpool):
        """One token for every slot.  Inactive slots compute garbage into
        the scratch page (their tables point at physical page 0) and emit
        token 0 — all masked out host-side.  A follower samples nothing."""
        st = self._dev
        logits = self._run_blocks(spec, kpool, vpool, st["last"][:, None], st["pos"][:, None],
                                  self._psum)
        if not self.leads:
            return None
        tok = sample_tokens(logits[:, 0], st["seed"], st["ctr"], st["temp"], st["topk"],
                            st["topp"])
        return torch.where(st["active"], tok, 0)

    def _draft_step(self, kpool, vpool, pos, last, i: int):
        """One single-token draft step over all slots at ``pos``: writes
        draft K/V, samples the proposal from the draft stream, and returns
        it with the draft's *modified* distribution (the q of the
        acceptance test)."""
        st = self._dev
        logits = self._run_blocks(self._draft_spec, kpool, vpool, last[:, None],
                                  pos[:, None])[:, 0]
        tok = sample_tokens(logits, st["seed"], st["dctr"] + i, st["temp"], st["topk"],
                            st["topp"], stream=STREAM_DRAFT)
        tok = torch.where(st["active"], tok, 0)
        return tok, modified_probs(logits, st["temp"], st["topk"], st["topp"])

    def _verify(self, spec: _Spec, kpool, vpool, drafts, qprobs):
        """The multi-token target step: feed the window ``[last, d_1 ..
        d_{m-1}]``, write its K/V through the page tables, compute all m
        next-token logits in one pass, judge the drafts per slot
        (:func:`speculative_verify_tokens`), and roll the rejected suffix
        rows back out of the pools.  Under a mesh rank 0 judges, and every
        rank rolls back rank 0's counts."""
        st = self._dev
        m = self._spec_tokens
        pos = st["pos"]
        fed = torch.cat([st["last"][:, None], drafts[:, :-1]], dim=1)
        positions = pos[:, None] + torch.arange(m, device=self.device)[None, :]
        logits = self._run_blocks(spec, kpool, vpool, fed, positions, self._psum)
        out = count = accepted = None
        if self.leads:
            out, count, accepted = speculative_verify_tokens(
                logits, drafts, qprobs, st["seed"], st["ctr"], st["temp"], st["topk"],
                st["topp"], st["spec_on"] & st["active"])
            out = torch.where(st["active"][:, None], out, 0)
        count = self._from_leader(count, (self.num_slots,), torch.int64)
        # erase the rejected suffix so the pools only ever hold
        # accepted-token K/V between iterations
        for li in range(len(spec.blocks)):
            rollback_rows(kpool, li, st["tables"], pos, count, m)
            rollback_rows(vpool, li, st["tables"], pos, count, m)
        return out, count, accepted

    # ----------------------------------------------------------- public API

    def start(self) -> None:
        """Start the host loop thread (idempotent; ``submit`` calls this)."""
        with self._cv:
            if self._running:
                return
            self._running = True
            self._thread = threading.Thread(
                target=self._loop, name="serving-engine", daemon=True
            )
            self._thread.start()

    def stop(self, timeout: float = 10.0) -> None:
        """Stop the loop; queued and in-flight requests resolve with
        ``finish_reason="aborted"`` (partial tokens included).  Under a
        mesh rank 0's stop ends every rank's loop (its last plan); a
        follower's waits up to ``timeout`` for that."""
        if not self.leads:
            with self._cv:
                thread = self._thread
            if thread is not None:
                thread.join(timeout=timeout)
            return
        with self._cv:
            if not self._running:
                thread = None
            else:
                self._running = False
                thread = self._thread
                self._thread = None
            self._cv.notify_all()
        if thread is not None:
            thread.join(timeout=timeout)
        for slot in range(self.num_slots):
            if self._slots[slot] is not None:
                self._retire(slot, "aborted")
        while True:
            pending = self._queue.pop()
            if pending is None:
                break
            self._finish(pending, [], "aborted", 0.0)
        self._metrics["queue_depth"].set(0)

    def submit(self, request: GenerateRequest) -> _Pending:
        """Validate + enqueue; returns a :class:`_Pending` handle.  Raises
        :class:`~distkeras_tpu_torch.serving.frontend.QueueFull` under
        backpressure and ``ValueError`` for an unservable request.  The
        admission is a ``serving.admit`` span on the caller's thread."""
        span = NOOP_SPAN
        if _truntime.enabled():
            span = _trace.span(
                "serving.admit", request_id=request.request_id,
                trace_id=request.trace_id)
        with span:
            return self._submit(request)

    def _submit(self, request: GenerateRequest) -> _Pending:
        self._front_end()
        with self._cv:
            # snapshot the published spec: hot-swap replaces it under _cv
            crashed, spec, error = self._crashed, self._spec, self._error
        if crashed:
            raise EngineCrashed(f"serving engine crashed ({error!r}); replica is dead")
        request.validate()
        plen = len(request.prompt)
        if plen > self._width or plen >= spec.max_len:
            raise ValueError(
                f"prompt length {plen} exceeds serviceable context "
                f"(width {self._width}, model max_len {spec.max_len})"
            )
        if int(np.max(request.prompt)) >= spec.vocab:
            raise ValueError("prompt token id out of vocabulary")
        if request.speculative and self._draft_spec is None:
            raise ValueError(
                "request asks for speculative decoding but the engine was "
                "built without a draft_model"
            )
        max_new = min(request.max_new_tokens, spec.max_len - plen,
                      self._width - plen)
        pending = _Pending(request, max_new, time.perf_counter())
        try:
            self._queue.put(pending)
        except Exception:
            self._metrics["rejected"].inc()
            raise
        self._metrics["queue_depth"].set(len(self._queue))
        self.start()
        with self._cv:
            self._cv.notify_all()
        return pending

    def generate(self, prompt, max_new_tokens: int = 16,
                 timeout: Optional[float] = 60.0,
                 **knobs) -> GenerateResult:
        """Blocking convenience: submit one request, wait for its result.
        ``knobs`` forwards temperature/top_k/top_p/seed/eos_id/speculative."""
        req = GenerateRequest(prompt=[int(t) for t in prompt],
                              max_new_tokens=max_new_tokens, **knobs)
        result = self.submit(req).result(timeout=timeout)
        if result is None:
            raise TimeoutError(f"generation did not finish in {timeout}s")
        return result

    def stats(self) -> Dict[str, float]:
        """Host-side snapshot for bench/debug (not the metrics surface)."""
        return {
            "queue_depth": float(len(self._queue)),
            "active_slots": float(int(self._active.sum())),
            "pages_in_use": float(self._cache.pages_in_use),
            "pages_free": float(self._cache.pages_free),
            "slots_total": float(self.num_slots),
        }

    def _front_end(self) -> None:
        if not self.leads:
            raise RuntimeError(f"serving mesh rank {self._tp_index}: {_FOLLOWER}")

    @property
    def alive(self) -> bool:
        """``False`` once the loop has crashed."""
        with self._cv:
            return not self._crashed

    @property
    def error(self) -> Optional[BaseException]:
        """The exception that crashed the loop, if it did."""
        with self._cv:
            return self._error

    @property
    def draining(self) -> bool:
        """Whether admission is paused (explicit :meth:`drain` or an
        in-flight :meth:`hot_swap`)."""
        with self._cv:
            return self._draining or self._swap is not None

    # ------------------------------------------------- tier hooks (host side)

    def cancel(self, pending: _Pending) -> bool:
        """Abort a submitted request: queued — removed and resolved
        ``"aborted"`` immediately; in a slot — retired ``"aborted"`` at the
        loop's next iteration (slot and pages reclaimed).  Returns ``False``
        when the request had already finished."""
        self._front_end()
        if pending.done():
            return False
        if self._queue.remove(pending):
            self._finish(pending, [], "aborted", 0.0)
            self._metrics["queue_depth"].set(len(self._queue))
            return True
        with self._cv:
            running = self._running
            if running:
                self._cancelled.append(pending)
                self._cv.notify_all()
        if not running and not pending.done():
            # no loop to process it — resolve it directly
            self._finish(pending, [], "aborted", 0.0)
        return True

    def drain(self, timeout: float = 30.0) -> bool:
        """Pause admission and wait until every occupied slot retires.
        Queued requests stay queued (they admit again after
        :meth:`resume`).  Returns ``True`` once drained; ``False`` on
        timeout (admission stays paused either way)."""
        self._front_end()
        span = NOOP_SPAN
        if _truntime.enabled():
            span = _trace.span("serving.drain")
        with span:
            with self._cv:
                self._draining = True
                started = self._thread is not None
                self._cv.notify_all()
            if not started:
                return True  # no loop => nothing in flight, nothing can admit
            deadline = time.perf_counter() + timeout
            while time.perf_counter() < deadline:
                with self._cv:
                    running, acked = self._running, self._drain_ack
                if not running:
                    return True  # stopped/crashed under us — slots are clear
                if acked and not self._active.any():
                    return True
                time.sleep(0.002)
            return False

    def resume(self) -> None:
        """Reopen admission after :meth:`drain`."""
        self._front_end()
        with self._cv:
            self._draining = False
            self._drain_ack = False
            self._cv.notify_all()

    def hot_swap(self, model, params=None, timeout: float = 30.0) -> None:
        """Swap the served params in place.

        Geometry (dim/heads/head_dim/max_len/vocab/depth/ln_eps) must match
        the engine's current spec, so every step keeps its shapes.  The loop
        applies the swap at the first iteration with zero active slots
        (admission pauses until then): in-flight requests finish under the
        old params, queued requests decode under the new, and nothing
        drops.  With a draft model, only the target swaps.  Returns
        ``None``; raises ``TimeoutError`` when the engine did not drain in
        ``timeout``.  Under a mesh every rank makes the call with the same
        model (each keeps its part), and rank 0's plan applies it
        everywhere at once."""
        span = NOOP_SPAN
        if _truntime.enabled():
            span = _trace.span("serving.hot_swap")
        with span:
            self._hot_swap(model, params, timeout)

    def _hot_swap(self, model, params, timeout: float) -> None:
        new = _resolve_spec(model, params, self.device)
        if self._tp > 1:
            if new.heads != self._spec.heads * self._tp:
                raise ValueError(f"hot_swap geometry mismatch on heads: {new.heads} != "
                                 f"{self._spec.heads * self._tp}")
            new = _shard_heads(new, self._tp, self._tp_index)
        with self._cv:
            old = self._spec
        for f in ("dim", "heads", "head_dim", "max_len", "vocab", "ln_eps"):
            if getattr(new, f) != getattr(old, f):
                raise ValueError(
                    f"hot_swap geometry mismatch on {f}: "
                    f"{getattr(new, f)} != {getattr(old, f)}"
                )
        if len(new.blocks) != len(old.blocks):
            raise ValueError(
                f"hot_swap depth mismatch: {len(new.blocks)} blocks "
                f"!= {len(old.blocks)}"
            )
        with self._cv:
            if self._crashed:
                raise EngineCrashed("engine crashed; cannot hot_swap")
            if self._swap is not None:
                raise RuntimeError("another hot_swap is already in flight")
            if not self._running:
                # no loop => no in-flight work: swap synchronously
                self._spec = new
                self._drop_programs()
                self._metrics["hot_swaps"].inc()
                return
            done = threading.Event()
            self._swap = (new, done)
            self._cv.notify_all()
        if not done.wait(timeout):
            with self._cv:
                self._swap = None
            raise TimeoutError(f"hot_swap did not drain within {timeout}s")

    @property
    def prefill_buckets(self) -> Tuple[int, ...]:
        return self._buckets

    # ------------------------------------------------------------ host loop

    def _loop(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        try:
            with torch.no_grad():
                if self.leads:
                    self._serve()
                else:
                    self._follow()
                    with self._cv:
                        self._running = False
                        self._thread = None
        except Exception as exc:  # noqa: BLE001 — re-raised to every caller
            if not isinstance(exc, _chaos.ChaosKilled):  # an injected kill is no bug
                traceback.print_exc(file=sys.stderr)
            self._crash(exc)
            if self.leads and self._plan_group is not None:
                try:  # the followers waiting on a plan end with this one
                    self._lockstep(_OP_STOP)
                except Exception:  # noqa: BLE001 — a follower is gone already
                    pass

    def _serve(self) -> None:
        while True:
            self._sent = False
            with self._cv:
                if not self._running:
                    self._lockstep(_OP_STOP)
                    return
                self._drain_ack = self._draining
                swap_pending = self._swap is not None
                paused = self._draining or swap_pending
            self._cancel_requested()
            if swap_pending and not self._active.any():
                self._apply_swap()
                with self._cv:
                    paused = self._draining
            progressed = False if paused else self._admit()
            if _chaos.enabled() and self._active.any():
                # the kill_replica site: only busy iterations count, so a
                # seeded kill lands mid-decode with requests in flight
                _chaos.fault("replica")
            progressed = self._decode_once() or progressed
            if not self._sent:
                self._lockstep(_OP_IDLE)  # no follower waits past its timeout
            if not progressed:
                with self._cv:
                    if (self._running and self._swap is None
                            and not self._cancelled
                            and (paused or len(self._queue) == 0)):
                        self._cv.wait(timeout=0.05)

    def _cancel_requested(self) -> None:
        """Retire every slot whose request was cancelled (loop thread only)."""
        with self._cv:
            if not self._cancelled:
                return
            cancelled, self._cancelled = self._cancelled, []
        for pending in cancelled:
            if pending.done():
                continue
            if self._queue.remove(pending):
                self._finish(pending, [], "aborted", 0.0)
                continue
            for slot, state in enumerate(self._slots):
                if state is not None and state.pending is pending:
                    self._retire(slot, "aborted")
                    break
        self._metrics["queue_depth"].set(len(self._queue))

    def _apply_swap(self) -> None:
        """Apply a pending hot-swap (loop thread, zero active slots)."""
        with self._cv:
            if self._swap is None:
                return  # hot_swap timed out and withdrew the request
            spec, done = self._swap
            # under the lock, so that a timing-out hot_swap cannot withdraw
            # a swap the followers were just told to apply
            self._lockstep(_OP_SWAP)
            self._spec = spec
            self._drop_programs()
            self._swap = None
        self._metrics["hot_swaps"].inc()
        done.set()

    def _crash(self, error: BaseException) -> None:
        # Runs ON the loop thread after a failed step: every in-flight and
        # queued request aborts (partial tokens included) and the engine
        # refuses further work.
        with self._cv:
            self._crashed = True
            self._error = error
            self._running = False
            self._thread = None
            self._cv.notify_all()
        for slot in range(self.num_slots):
            if self._slots[slot] is not None:
                self._retire(slot, "aborted")
        if self._admitting is not None and not self._admitting.done():
            # the loop failed inside this request's prefill
            self._finish(self._admitting, [], "aborted", 0.0)
        while True:
            pending = self._queue.pop()
            if pending is None:
                break
            self._finish(pending, [], "aborted", 0.0)
        self._metrics["queue_depth"].set(0)

    def _admit(self) -> bool:
        """Move queued requests into free slots (prefill).  FIFO with
        head-of-line blocking: when the page pool can't fit the next
        request yet, it waits for a retirement rather than being skipped —
        no starvation of big requests."""
        admitted = False
        while True:
            free = [i for i, st in enumerate(self._slots) if st is None]
            if not free:
                break
            pending = self._queue.pop()
            if pending is None:
                break
            need = self._cache.pages_needed(
                len(pending.request.prompt) + pending.max_new
            )
            if not self._cache.can_alloc(need):
                self._queue.requeue_front(pending)
                break
            self._admitting = pending
            self._prefill_into(free[0], pending, need)
            self._admitting = None
            admitted = True
        self._metrics["queue_depth"].set(len(self._queue))
        return admitted

    def _prefill_into(self, slot: int, pending: _Pending, need: int) -> None:
        req = pending.request
        plen = len(req.prompt)
        self._cache.alloc(slot, need)
        # smallest bucket that fits the prompt (the ladder always ends at
        # max_context and submit bounded plen, so next() can't exhaust)
        width = next(w for w in self._buckets if w >= plen)
        t0 = time.perf_counter()
        span = NOOP_SPAN
        if _truntime.enabled():
            # the loop thread serves every request, so the ids ride span
            # args; queue wait spans the enqueue-to-prefill gap
            _trace.record(
                "serving.queue_wait", pending.enqueue_t, t0,
                request_id=req.request_id, trace_id=req.trace_id,
                parent="serving.admit")
            attrs: Dict[str, Any] = dict(
                request_id=req.request_id, trace_id=req.trace_id,
                parent="serving.admit", slot=slot, width=width, plen=plen)
            if req.tenant:
                attrs["tenant"] = req.tenant
            span = _trace.span("serving.prefill", **attrs)
        spec_on = self._draft_spec is not None and req.speculative is not False
        with span:
            prompt = self._host["prompt"].numpy()
            prompt[:] = 0
            prompt[:plen] = req.prompt
            self._seed[slot] = seed_value(req.seed)
            self._ctr[slot] = 0
            self._dctr[slot] = 0
            self._temp[slot] = req.temperature
            self._topk[slot] = req.top_k
            self._topp[slot] = req.top_p
            self._host["at"].numpy()[:] = (slot, plen)
            self._lockstep(_OP_PREFILL, slot, width, plen, spec_on)
            self._upload()
            with self._cv:
                spec = self._spec
            k, v = self._cache.k_pages, self._cache.v_pages
            tok = self._program(("prefill", "target", width), lambda: self._prefill(
                spec, k, v, width, sample=True, psum=self._psum))
            if spec_on:
                dc = self._draft_cache
                self._program(("prefill", "draft", width), lambda: self._prefill(
                    self._draft_spec, dc.k_pages, dc.v_pages, width, sample=False))
            self._await_step()
            with self._read_back():
                tok0 = int(tok.item())  # device sync: the prefill is done here
        now = time.perf_counter()
        self._metrics["prefill_seconds"].observe(now - t0)
        self._metrics["prefill_padded"].inc(width - plen)

        state = _SlotState(pending, plen)
        state.tokens.append(tok0)
        state.ttft_s = now - pending.enqueue_t
        state.pages = need
        state.admit_t = now
        self._metrics["ttft"].observe(state.ttft_s)
        self._metrics["tokens"].inc()
        if self._ledger is not None:
            # prompt tokens, queue wait, prefill seconds and the first
            # sampled token bill at admission — all host-visible
            self._ledger.admit(
                req.tenant, prompt_tokens=plen,
                queue_wait_s=t0 - pending.enqueue_t,
                device_s=now - t0, generated=1)
        self._slots[slot] = state
        self._pos[slot] = plen
        self._last[slot] = tok0
        self._ctr[slot] = 1
        self._active[slot] = True
        self._spec_on[slot] = spec_on
        self._refresh_gauges()

        if req.eos_id is not None and tok0 == req.eos_id:
            self._retire(slot, "eos")
        elif len(state.tokens) >= pending.max_new:
            self._retire(slot, "length")

    def _read_back(self):
        """One read-back of the loop (a sync on the card, by design),
        declared to the sanitizer's transfer guard: torch's sync debug mode
        is process-wide, so another thread's strict guard would otherwise
        report it.  A null context with the sanitizer off."""
        if not self._sanitize:
            return contextlib.nullcontext()
        return _sanitizer.transfer.allow("serving read-back")

    def _decode_once(self) -> bool:
        """One engine iteration over every active slot: a plain decode
        step, or (with a draft model) m draft steps + one verify step."""
        if not self._active.any():
            return False
        if self._draft_spec is not None:
            self._spec_once()
        else:
            self._plain_once()
        return True

    def _step_span(self):
        """A ``serving.decode_step`` span for one engine iteration, listing
        the request ids it served (``args.requests``); NOOP when telemetry
        is off."""
        if not _truntime.enabled():
            return NOOP_SPAN
        reqs = [self._slots[i].pending.request
                for i in range(self.num_slots)
                if self._active[i] and self._slots[i] is not None]
        attrs: Dict[str, Any] = {
            "requests": [r.request_id for r in reqs],
            "n_active": len(reqs),
        }
        traces = sorted({r.trace_id for r in reqs if r.trace_id})
        if len(reqs) == 1:
            attrs["request_id"] = reqs[0].request_id
            attrs["parent"] = "serving.prefill"
        if len(traces) == 1:
            attrs["trace_id"] = traces[0]
        elif traces:
            attrs["trace_ids"] = traces
        tenants = sorted({r.tenant for r in reqs if r.tenant})
        if len(tenants) == 1:
            attrs["tenant"] = tenants[0]
        elif tenants:
            attrs["tenants"] = tenants
        return _trace.span("serving.decode_step", **attrs)

    def _plain_once(self) -> None:
        t0 = time.perf_counter()
        with self._step_span():
            self._lockstep(_OP_DECODE)
            self._upload()
            with self._cv:
                spec = self._spec
            k, v = self._cache.k_pages, self._cache.v_pages
            tok = self._program(("decode",), lambda: self._decode(spec, k, v))
            self._await_step()
            with self._read_back():
                toks = tok.cpu().numpy()  # device sync: the step is done here
        dt = time.perf_counter() - t0
        self._metrics["token_latency"].observe(dt)
        self._metrics["decode_steps"].inc()
        self._ctr[self._active] += 1
        ledger = self._ledger
        # the step's wall time split evenly over the slots it decoded for
        # (counted before retirements change them)
        share = dt / max(1, int(self._active.sum()))

        for slot in range(self.num_slots):
            state = self._slots[slot]
            if state is None or not self._active[slot]:
                continue
            t = int(toks[slot])
            state.tokens.append(t)
            self._metrics["tokens"].inc()
            if ledger is not None:
                ledger.decode(state.pending.request.tenant, tokens=1, device_s=share)
            self._pos[slot] += 1
            self._last[slot] = t
            eos = state.pending.request.eos_id
            if eos is not None and t == eos:
                self._retire(slot, "eos")
            elif len(state.tokens) >= state.pending.max_new:
                self._retire(slot, "length")

    def _spec_once(self) -> None:
        """One speculative iteration: chain m draft steps (the proposals
        stay on the device between them), verify the window in one target
        step, then emit each slot's accepted prefix."""
        t0 = time.perf_counter()
        m = self._spec_tokens
        with self._step_span():
            self._lockstep(_OP_SPEC)
            self._upload()
            with self._cv:
                spec = self._spec

            def iteration():
                out, count, accepted = self._spec_iteration(spec)
                return torch.cat([out, count[:, None], accepted[:, None]], dim=1)

            packed = self._program(("spec",), iteration)
            self._await_step()
            # one copy back: the iteration is done here
            with self._read_back():
                packed = packed.cpu().numpy()
        out, counts, acc = packed[:, :m], packed[:, m], packed[:, m + 1]
        dt = time.perf_counter() - t0
        self._metrics["token_latency"].observe(dt)
        self._metrics["decode_steps"].inc()
        spec_slots = self._active & self._spec_on
        n_spec = int(spec_slots.sum())
        if n_spec:
            self._metrics["spec_proposed"].inc(m * n_spec)
            self._metrics["spec_accepted"].inc(int(acc[spec_slots].sum()))
        self._ctr[self._active] += 1
        self._dctr[self._active] += m
        ledger = self._ledger
        share = dt / max(1, int(self._active.sum()))

        for slot in range(self.num_slots):
            state = self._slots[slot]
            if state is None or not self._active[slot]:
                continue
            req = state.pending.request
            if ledger is not None and spec_slots[slot]:
                # accepted + rejected = m per speculative slot, so the tenant
                # sums conserve against serving_spec_{proposed,accepted}_total
                accepted = int(acc[slot])
                ledger.speculative(req.tenant, accepted=accepted, rejected=m - accepted)
            retired = False
            emitted = 0
            for j in range(int(counts[slot])):
                t = int(out[slot, j])
                state.tokens.append(t)
                emitted += 1
                self._metrics["tokens"].inc()
                if req.eos_id is not None and t == req.eos_id:
                    self._retire(slot, "eos")
                    retired = True
                    break
                if len(state.tokens) >= state.pending.max_new:
                    self._retire(slot, "length")
                    retired = True
                    break
            if ledger is not None:
                ledger.decode(req.tenant, tokens=emitted, device_s=share)
            if not retired:
                self._pos[slot] += emitted
                self._last[slot] = int(out[slot, emitted - 1])

    def _spec_iteration(self, spec: _Spec):
        """The device work of one speculative iteration: m draft steps (the
        proposals stay on the device between them), then the verify step
        over rank 0's proposals (every rank drafts, as every JAX device
        runs the replicated draft)."""
        st = self._dev
        dc = self._draft_cache
        m = self._spec_tokens
        last = st["last"]
        drafts, qprobs = [], []
        for i in range(m):
            last, qp = self._draft_step(dc.k_pages, dc.v_pages, st["pos"] + i, last, i)
            drafts.append(last)
            qprobs.append(qp)
        drafts = self._from_leader(torch.stack(drafts, dim=1), (self.num_slots, m), torch.int64)
        return self._verify(spec, self._cache.k_pages, self._cache.v_pages, drafts,
                            torch.stack(qprobs, dim=1))

    def _retire(self, slot: int, reason: str) -> None:
        state = self._slots[slot]
        if self._ledger is not None:
            # page-seconds sample at slot free: pages held x wall time
            self._ledger.release(
                state.pending.request.tenant, pages=state.pages,
                held_s=time.perf_counter() - state.admit_t)
        self._cache.free(slot)
        self._slots[slot] = None
        self._active[slot] = False
        self._spec_on[slot] = False
        self._pos[slot] = 0
        self._last[slot] = 0
        self._temp[slot] = 0.0
        self._topk[slot] = 0
        self._topp[slot] = 1.0
        self._finish(state.pending, state.tokens, reason, state.ttft_s)
        self._refresh_gauges()

    def _finish(self, pending: _Pending, tokens: List[int], reason: str,
                ttft_s: float) -> None:
        self._metrics["requests"].inc()
        pending._resolve(GenerateResult(
            request_id=pending.request.request_id,
            prompt=list(pending.request.prompt),
            tokens=list(tokens),
            finish_reason=reason,
            ttft_s=ttft_s,
            latency_s=time.perf_counter() - pending.enqueue_t,
            trace_id=pending.request.trace_id,
        ))

    def _refresh_gauges(self) -> None:
        self._metrics["active_slots"].set(int(self._active.sum()))
        self._metrics["pages_in_use"].set(self._cache.pages_in_use)
