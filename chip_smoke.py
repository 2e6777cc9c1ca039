#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``distkeras_tpu_torch``).

    python3 chip_smoke.py [--seed 0]

Needs one CUDA card (an H100: the kernels are built for sm_90a) and the CUDA
toolkit.  Phases, each printing JSON lines:

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: compiles every kernel from ``distkeras_tpu_torch/csrc``, one
   ``nvcc`` per source, all at once; then each kernel's registers and
   spills (ptxas) and its tensor-core instructions (HMMA in cuobjdump's
   SASS): every instantiation of the forward (B1), dQ (B2) and dK/dV (B3)
   kernels (f32, bf16 and f16; head dims 16 to 256) must have them;
3. kernels: each kernel against its plain PyTorch version on the card,
   with its time, the plain version's, one library call's and the bound:
   the forward (B1, also at lq != lk and on misaligned inputs that the
   wrapper copies) and the backward's dQ (B2) and dK/dV (B3) kernels,
   whose f32 rows give two bounds (the CUDA cores' f32 rate and the
   tensor cores' 3xTF32 rate); also at head dims 8, 96 and 256 (f32,
   ``[4, 1024, 12, d]`` causal; the wrappers zero-pad 8 and 96, and the
   padding copy is timed alone) and in f16 (B1 at ``[16, 1024, 12, 64]``,
   B2/B3 at the training shape), each bound on the true head dim; the
   forward on the LM shape and the backward kernels on the training shape,
   the three head dims and f16 run twice and must agree bit for bit;
4. ``ModelPredictor`` over a ``TransformerClassifier`` at GPT-2-small widths
   (768 wide, 12 heads, 12 layers, 1024 positions, 50257 tokens), weights
   drawn from ``--seed``: 64 rows of 1024 tokens in batches of 16;
5. a causal ``TransformerLM`` forward through ``TrainedModel`` at the same
   widths on ``[4, 1024]`` tokens;
6. training: ``DOWNPOUR`` over the same ``TransformerLM`` (depth not cut),
   2 workers, batch 4, window 2, Adam, 2 epochs over 32 rows of 1024 tokens
   of the ``(token + 1) mod vocab`` task, then one training step at
   ``[1, 1024]`` held against the same step on the CPU;
7. the paper's training suite (``bench.py``'s six configurations, one JSON
   line each): ``SingleTrainer`` over ``MLP``, ``DOWNPOUR`` over
   ``MNISTCNN`` and ``CIFARCNN``, ``AEASGD`` and ``EAMSGD`` over
   ``CIFARCNN``, ``ADAG`` over ``ResNet20``, ``DynSGD`` over ``TextCNN``, at
   the published widths and per-worker batches, bf16 compute, 2 workers,
   window 16, 2 epochs of 2 windows, on bench.py's random data drawn from
   ``--seed``.  Each line has samples/s, seconds per local step, the
   seconds of the model's own forward + backward at the same batch (CUDA
   events; the rest of a step is the engine's), the loss history, the
   commit count and peak memory; each configuration then holds one f32
   step on 32 rows against the CPU.  ``cifar_cnn_downpour`` trains twice
   (is it bitwise repeatable?), must lower its loss from epoch 1 to 2 and
   serves ``ModelPredictor`` against the CPU; ``ResNet20``'s running
   statistics must move and be equal across workers after a commit;
8. staleness: ``DynSGD`` over ``TextCNN`` with ``commit_schedule=[16, 32]``,
   64 steps an epoch: the commit count and the workers' clocks must equal
   a host-side count of the race, with at least one stale commit;
9. flow: the paper's DataFrame flow (``examples/mnist.py``) through the
   public API at MNIST's shape, on 60,000 synthetic rows of 784 pixels
   drawn from ``--seed``: ``from_numpy`` -> ``MinMaxTransformer`` ->
   ``OneHotTransformer`` -> ``split(0.8)`` -> ``SingleTrainer``,
   ``DOWNPOUR``, ``AEASGD`` and ``ADAG`` over ``MLP(256, 128)`` (2 workers,
   batch 32, the example's settings, 2 epochs where the example has 5)
   and ``SingleTrainer`` over ``MNISTCNN`` (batch 256, through
   ``ReshapeTransformer``), each with ``tensorboard_dir`` -> ``ModelPredictor``
   -> ``LabelIndexTransformer`` -> ``AccuracyEvaluator``, and
   ``LossEvaluator``; one line each, with samples/s and s/step.  Gates: the
   held-out accuracy, predictions and ``LossEvaluator`` against the CPU,
   ``AccuracyEvaluator`` against a numpy recount, one scalar-log entry per
   epoch holding the history's loss, the commit counts;
10. head-dim models: ``ModelPredictor`` over a ``TransformerLM`` at GPT-2
    small's widths with 8 heads (head dim 96) and over a ``dim=16, heads=2``
    ``TransformerClassifier`` (head dim 8), card against CPU, and
    ``PerplexityEvaluator`` over the LM's output;
11. networking: ``networking.initialize`` over NCCL at world size 1, one
    ``all_reduce`` of a CUDA tensor, ``shutdown``; a ``send_data`` /
    ``recv_data`` round trip over a socket pair;
12. epochs: ``cifar_cnn_downpour`` (the zoo's configuration, 2 epochs of 4
    windows) eager, with ``dispatch_epochs=2`` and with ``unroll=True``
    (every window a captured CUDA graph), each with samples/s and s/step
    end to end and in a steady pass on the trained engine, and the card's
    busy share under ``torch.profiler``: ``dispatch_epochs`` must equal
    eager bit for bit, the graph within 1e-6 (loss, relative) and 1e-5
    (center parameters);
13. streaming: the same run with ``streaming=True``, ``prefetch`` 0 and 2,
    held to the in-memory run with the same gates; the native gather must
    be built;
14. checkpoint: the same run with ``checkpoint_dir``; 1 epoch and a resume
    for 1 more, a resume after a flipped byte quarantined the newest step,
    and ``train_with_recovery`` over one injected failure, each bitwise the
    uninterrupted run; the save's host-blocking ms and bytes;
15. remat and graph on the attention path: the train phase's ``DOWNPOUR``
    at GPT-2-small widths with dropout 0.1, trained eagerly, with
    ``remat=True`` and with ``unroll=True`` from the same seeds, each held
    to the eager run with the epochs phase's gates; B1 launched twice as
    often under remat, B1-B3 launched inside the graph (counted as the
    wrappers' capture ticks times the replays, plus the warm-up window);
    peak memory of all three; two replays of one captured window from the
    same state draw different dropout masks, and the same masks again
    once the generators are put back;
16. serving: KV-cache decode and the serving engine at GPT-2-small widths
    through ``greedy_generate`` (each token against the argmax of a
    full-context forward, which runs B1), ``ServingEngine`` (24 staggered
    requests, half greedy held to ``greedy_generate``, half sampled held to
    themselves rerun alone; EOS, a full queue, pages returned),
    speculative decoding (a 2-layer draft, and the target as its own) and
    ``ModelPredictor(engine=)``; TTFT and step-latency quantiles, decode
    tokens/s, the profiled decode step, prefill ms per bucket, peak pages
    and memory.  A greedy token may differ from its reference only where
    the reference's two best logits are within ``GREEDY_GAP``.

Phases 4 to 6, 10 and 15 set the kernels' launch counts to 0 just before
and read them just after, check that every kernel of the path ran as often
as the model needs, and hold the output against the same model on the CPU
(phase 15: against the eager run).  Phase 16 does so around the serving
path, which launches no kernel of the port's own (decode attention is the
reference's plain masked product, as there), and around its check's
forward, which launches B1.  Phases 7 to 9 and 11 to 14 run no
kernel of the port's own: convolutions, dense products and embedding
gathers are PyTorch's.  The last lines are a ``{"kernels":
[...]}`` summary, the nvidia-smi line and ``{"ok": true, "device":
{...}}``.  Any failed check raises, so the script exits non-zero without
the ``ok`` line; so does a machine without CUDA.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

# f32: the kernel and the plain version differ only in summation order.
F32_ATOL = F32_RTOL = 1e-4
# bf16 (and f16, held to the same gates): both compute in f32, but O is
# rounded to 16 bits at the end (LSE stays f32).
BF16_O_ATOL = 2e-2
BF16_LSE_ATOL = 1e-3
# ModelPredictor probabilities and LM logits on the card against the CPU.
PREDICT_ATOL = 1e-4
LM_LOGITS_ATOL = 1e-3
# Backward kernels against the plain backward.  f32: summation order only,
# over up to 1024 keys with gradients up to ~10 in size.  bf16: both compute
# in f32 from the same bf16 values; the gradients are rounded to bf16
# (8 mantissa bits) at the end.
BWD_F32 = dict(atol=1e-3, rtol=1e-3)
BWD_BF16 = dict(atol=3e-2, rtol=2e-2)
# One training step at [1, 1024] on the card against the CPU: loss within
# 1e-4 relative; each parameter's gradient within 1e-3 in relative norm
# (f32 throughout, TF32 off; the orders of summation differ).
STEP_LOSS_RTOL = 1e-4
STEP_GRAD_RTOL = 1e-3

# Published H100 SXM peaks (dense): f32 outside the tensor cores, bf16
# tensor cores, HBM3 bandwidth.
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12, torch.float16: 989e12}
PEAK_BYTES_PER_S = 3.35e12
# f32 products on the tensor cores at f32 accuracy: three TF32 products
# (3xTF32) at the 495 TFLOP/s TF32 peak, as the backward kernels run them.
PEAK_TC_F32 = 495e12 / 3

GPT2_SMALL = dict(vocab_size=50257, dim=768, heads=12, num_layers=12, max_len=1024)

# (name, q's [batch, seq, heads, dim], k's and v's seq (None: q's), dtype,
# causal, layout): "fused" takes q, k, v as the strided views of one QKV
# projection, as _SelfAttention does; "offset" starts each input 4 bytes past
# a 16-byte boundary, so the wrapper must copy it first.
KERNEL_CASES = [
    ("ragged", (2, 100, 2, 32), None, torch.float32, False, "plain"),
    ("ragged_causal", (2, 100, 2, 32), None, torch.float32, True, "plain"),
    ("classifier", (16, 1024, 12, 64), None, torch.float32, False, "fused"),
    ("classifier_causal", (16, 1024, 12, 64), None, torch.float32, True, "fused"),
    ("lm", (4, 1024, 12, 64), None, torch.float32, True, "fused"),
    ("lm_bf16", (4, 1024, 12, 64), None, torch.bfloat16, True, "plain"),
    ("dim128", (1, 257, 4, 128), None, torch.float32, False, "plain"),
    ("dim128_bf16", (1, 257, 4, 128), None, torch.bfloat16, True, "plain"),
    ("lq_gt_lk_causal", (2, 200, 2, 64), 77, torch.float32, True, "plain"),
    ("offset", (2, 100, 2, 64), None, torch.float32, True, "offset"),
    # head dims outside the built sizes (zero-padded to 16, 128, and the
    # d = 256 build) and f16
    ("d8", (4, 1024, 12, 8), None, torch.float32, True, "plain"),
    ("d96", (4, 1024, 12, 96), None, torch.float32, True, "plain"),
    ("d256", (4, 1024, 12, 256), None, torch.float32, True, "plain"),
    ("f16", (16, 1024, 12, 64), None, torch.float16, False, "plain"),
]
MAIN_PATH_CASE = "classifier"  # the shape ModelPredictor hands the kernel
DETERMINISM_CASE = "lm"  # the forward runs twice here and must agree bit for bit

# Backward cases, as above.  "train" is the shape a DOWNPOUR worker with
# batch 4 hands the backward kernels at GPT-2-small widths.
BWD_CASES = [
    ("ragged", (2, 100, 2, 32), torch.float32, False, False),
    ("ragged_causal", (2, 100, 2, 32), torch.float32, True, False),
    ("ragged_bf16", (2, 100, 2, 32), torch.bfloat16, True, False),
    ("dim128", (1, 257, 4, 128), torch.float32, False, False),
    ("dim128_causal", (1, 257, 4, 128), torch.float32, True, False),
    ("train", (4, 1024, 12, 64), torch.float32, True, True),
    ("train_noncausal", (4, 1024, 12, 64), torch.float32, False, True),
    ("train_bf16", (4, 1024, 12, 64), torch.bfloat16, True, True),
    ("dim128_bf16", (1, 257, 4, 128), torch.bfloat16, True, True),
    ("d8", (4, 1024, 12, 8), torch.float32, True, False),
    ("d96", (4, 1024, 12, 96), torch.float32, True, False),
    ("d256", (4, 1024, 12, 256), torch.float32, True, False),
    ("train_f16", (4, 1024, 12, 64), torch.float16, True, True),
]
# cases whose backward kernels also run twice and must agree bit for bit
BWD_RERUN_CASES = ("train", "d8", "d96", "d256", "train_f16")
# the head-dim and f16 rows of the kernels line: (forward case, backward case)
COVERAGE_CASES = (("d8", "d8"), ("d96", "d96"), ("d256", "d256"), ("f16", "train_f16"))
BWD_MAIN_PATH_CASE = "train"
# training phase: DOWNPOUR over GPT-2-small widths
TRAIN_ROWS, TRAIN_SEQ, TRAIN_BATCH, TRAIN_WORKERS, TRAIN_WINDOW, TRAIN_EPOCHS = 32, 1024, 4, 2, 2, 2


def emit(**fields):
    print(json.dumps(fields), flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds per call of ``fn`` on the card (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound_ms(shape, dtype, causal: bool, peak: float = None, lk: int = None):
    """Least time for the card to do one attention forward with q of
    ``shape`` and ``lk`` keys (default: q's length): the larger of the
    FLOPs over ``peak`` (default: the dtype's peak rate; 4·d per attended
    (query, key) pair, only the attended pairs when causal, the diagonal
    aligned at the top-left corner) and the bytes over the memory rate (Q,
    K, V read once, O and the f32 LSE written once)."""
    b, l, h, d = shape
    lk = l if lk is None else lk
    pairs = sum(min(r + 1, lk) for r in range(l)) if causal else l * lk
    flops = 4.0 * b * h * pairs * d
    itemsize = torch.empty((), dtype=dtype).element_size()
    nbytes = 2 * b * (l + lk) * h * d * itemsize + b * h * l * 4
    ops_ms = flops / (peak or PEAK_FLOPS[dtype]) * 1e3
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes")


def kernel_bound_ms(shape, dtype, causal: bool, flops_per_pair_per_d: int, tensors_moved: int,
                    peak: float = None):
    """Least time for the card to do backward work at ``shape``: the larger
    of the FLOPs (``flops_per_pair_per_d``·d per attended (query, key)
    pair) over ``peak`` (default: the dtype's peak rate) and the bytes (the
    ``tensors_moved`` [b, L, h, d] tensors read or written once, plus LSE
    and Δ in f32) over the memory rate.  The whole backward is 10·d a pair
    (five products of 2·d: S, dP, dV, dK, dQ) over 8 tensors (Q, K, V, O,
    dO read, dQ, dK, dV written); the dQ kernel alone 6·d over 5 (Q, K,
    V, dO in, dQ out), the dK/dV kernel 8·d over 6.  The two kernels
    recompute S and dP in both (14·d a pair), so together they can reach
    at most 10/14 of the whole backward's bound."""
    b, l, h, d = shape
    pairs = l * (l + 1) // 2 if causal else l * l
    flops = float(flops_per_pair_per_d) * b * h * pairs * d
    itemsize = torch.empty((), dtype=dtype).element_size()
    nbytes = tensors_moved * b * l * h * d * itemsize + 2 * b * h * l * 4
    ops_ms = flops / (peak or PEAK_FLOPS[dtype]) * 1e3
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes")


def kernel_resources():
    """Registers, stack and spills of every compiled kernel (ptxas's report,
    kept beside each library) and its count of tensor-core instructions
    (HMMA lines in cuobjdump's SASS), one dict per instantiation."""
    import re
    import shutil
    from pathlib import Path

    from distkeras_tpu_torch.ops import _build

    name_re = re.compile(
        r"(flash_(?:fwd|bwd_dq|bwd_dkv)_kernel)I(f|13__nv_bfloat16|6__half)Li(\d+)E")
    dtype_names = {"f": "float32", "13__nv_bfloat16": "bfloat16", "6__half": "float16"}
    frame_re = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads")
    cuobjdump = Path(_build.nvcc_path()).parent / "cuobjdump"
    cuobjdump = str(cuobjdump) if cuobjdump.is_file() else shutil.which("cuobjdump")
    if cuobjdump is None:
        raise RuntimeError("cuobjdump not found beside nvcc or on PATH")
    rows = {}

    def row_of(match):
        kernel, dtype, head_dim = match.group(1), match.group(2), int(match.group(3))
        dtype = dtype_names[dtype]
        return rows.setdefault((kernel, dtype, head_dim),
                               dict(kernel=kernel, dtype=dtype, head_dim=head_dim, hmma=0))

    for name in ("flash_attention_fwd", "flash_attention_bwd"):
        library = _build.build(name, _build.CSRC / f"{name}.cu")
        row = None
        for line in _build.ptxas_log(library).read_text().splitlines():
            if match := name_re.search(line):
                row = row_of(match)
            elif row is not None and (match := frame_re.search(line)):
                row.update(stack_bytes=int(match.group(1)), spill_store_bytes=int(match.group(2)),
                           spill_load_bytes=int(match.group(3)))
            elif row is not None and (match := re.search(r"Used (\d+) registers", line)):
                row["registers"] = int(match.group(1))
        sass = subprocess.run([cuobjdump, "-sass", str(library)], capture_output=True, text=True,
                              check=True, timeout=300).stdout
        row = None
        for line in sass.splitlines():
            if "Function :" in line:
                match = name_re.search(line)
                row = row_of(match) if match else None
            elif row is not None and "HMMA" in line:
                row["hmma"] += 1
    return sorted(rows.values(), key=lambda r: (r["kernel"], r["dtype"], r["head_dim"]))


def make_qkv(shape, dtype, layout: str, gen: torch.Generator, lk: int = None):
    """q ``[b, l, h, d]``, k and v ``[b, lk, h, d]`` on the card, in one of the
    layouts of ``KERNEL_CASES``."""
    b, l, h, d = shape
    lk = l if lk is None else lk
    if layout == "fused":
        assert lk == l
        qkv = torch.randn((b, l, 3, h, d), generator=gen, device="cuda").to(dtype)
        return qkv.unbind(2)
    offset = 4 // torch.empty((), dtype=dtype).element_size() if layout == "offset" else 0

    def draw(length):
        n = b * length * h * d
        flat = torch.randn(n + offset, generator=gen, device="cuda").to(dtype)
        return flat[offset:].view(b, length, h, d)

    q, k, v = draw(l), draw(lk), draw(lk)
    if layout == "offset" and not all(t.data_ptr() % 16 for t in (q, k, v)):
        raise AssertionError("offset inputs must not be 16-byte aligned")
    return q, k, v


def kernel_phase(seed: int):
    import torch.nn.functional as F

    from distkeras_tpu_torch.ops.flash_attention import (
        HEAD_DIMS,
        _pad_head_dim,
        flash_attention_fwd,
        flash_attention_plain,
    )

    gen = torch.Generator(device="cuda").manual_seed(seed)
    results = {}
    for name, shape, lk, dtype, causal, layout in KERNEL_CASES:
        q, k, v = make_qkv(shape, dtype, layout, gen, lk)
        o, lse = flash_attention_fwd(q, k, v, causal)
        o_ref, lse_ref = flash_attention_plain(q, k, v, causal)
        torch.cuda.synchronize()
        err_o = (o.float() - o_ref.float()).abs().max().item()
        err_lse = (lse - lse_ref).abs().max().item()
        if dtype != torch.float32:
            ok = err_o <= BF16_O_ATOL and err_lse <= BF16_LSE_ATOL
            tol = {"o_atol": BF16_O_ATOL, "lse_atol": BF16_LSE_ATOL}
        else:
            ok = (torch.allclose(o, o_ref, atol=F32_ATOL, rtol=F32_RTOL)
                  and torch.allclose(lse, lse_ref, atol=F32_ATOL, rtol=F32_RTOL))
            tol = {"atol": F32_ATOL, "rtol": F32_RTOL}
        big = shape[1] >= 1024
        kernel_ms = cuda_ms(lambda: flash_attention_fwd(q, k, v, causal), 10 if big else 50)
        plain_ms = cuda_ms(lambda: flash_attention_plain(q, k, v, causal), 5 if big else 50)
        # SDPA faults (misaligned address) on the offset views: it gets aligned copies
        aligned = (lambda x: x.clone()) if layout == "offset" else (lambda x: x)
        qt, kt, vt = (aligned(x).transpose(1, 2) for x in (q, k, v))
        library_ms = cuda_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal),
            10 if big else 50,
        )
        bound_ms, bound_by = attention_bound_ms(shape, dtype, causal, lk=lk)
        row = dict(case=name, shape=list(shape), lk=k.shape[1], layout=layout,
                   dtype=str(dtype).replace("torch.", ""),
                   causal=causal, max_abs_err_o=err_o, max_abs_err_lse=err_lse,
                   tolerance=tol, kernel_ms=kernel_ms, plain_ms=plain_ms,
                   library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)
        if dtype == torch.float32:  # on the tensor cores in 3xTF32
            row["bound_tc_ms"] = attention_bound_ms(shape, dtype, causal, PEAK_TC_F32, lk)[0]
        if shape[3] not in HEAD_DIMS:  # the wrapper's zero-padding copy, inside kernel_ms
            row["pad_ms"] = cuda_ms(lambda: _pad_head_dim(q, k, v), 10 if big else 50)
        if name == DETERMINISM_CASE:  # no atomics: a second run agrees bit for bit
            o2, lse2 = flash_attention_fwd(q, k, v, causal)
            row["deterministic"] = torch.equal(o, o2) and torch.equal(lse, lse2)
            ok = ok and row["deterministic"]
        emit(phase="kernel", kernel="flash_attention_fwd", **row)
        if not ok:
            raise AssertionError(f"flash_attention_fwd disagrees with its plain version "
                                 f"or with itself: {row}")
        results[name] = row
        del q, k, v, o, lse, o_ref, lse_ref
    return results


def bwd_kernel_phase(seed: int):
    import torch.nn.functional as F

    from distkeras_tpu_torch.ops.flash_attention import (
        HEAD_DIMS,
        _pad_head_dim,
        attention_delta,
        flash_attention_bwd_dkv,
        flash_attention_bwd_dq,
        flash_attention_bwd_plain,
        flash_attention_fwd,
    )

    gen = torch.Generator(device="cuda").manual_seed(seed + 10)
    results = {}
    for name, shape, dtype, causal, fused in BWD_CASES:
        q, k, v = make_qkv(shape, dtype, "fused" if fused else "plain", gen)
        do = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        o, lse = flash_attention_fwd(q, k, v, causal)
        delta = attention_delta(o, do)
        dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, causal)
        dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal)
        ref = flash_attention_bwd_plain(q, k, v, o, lse, do, causal)
        torch.cuda.synchronize()
        errs = [(got.float() - want.float()).abs().max().item()
                for got, want in zip((dq, dk, dv), ref)]
        tol = BWD_F32 if dtype == torch.float32 else BWD_BF16
        ok = all(torch.allclose(got.float(), want.float(), **tol)
                 for got, want in zip((dq, dk, dv), ref))
        big = shape[1] >= 1024
        iters = 10 if big else 50
        dq_ms = cuda_ms(lambda: flash_attention_bwd_dq(q, k, v, do, lse, delta, causal), iters)
        dkv_ms = cuda_ms(lambda: flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal), iters)
        plain_ms = cuda_ms(lambda: flash_attention_bwd_plain(q, k, v, o, lse, do, causal),
                           5 if big else 50)
        # the library's backward: forward + backward of SDPA less its forward
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
        dot = do.transpose(1, 2)

        def sdpa_fwd():
            with torch.no_grad():
                F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)

        def sdpa_fwd_bwd():
            out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
            torch.autograd.grad(out, (qt, kt, vt), dot)

        library_ms = cuda_ms(sdpa_fwd_bwd, iters) - cuda_ms(sdpa_fwd, iters)
        bounds = {"": (10, 8), "dq_": (6, 5), "dkv_": (8, 6)}  # (FLOPs/pair/d, tensors)
        row = dict(case=name, shape=list(shape), dtype=str(dtype).replace("torch.", ""),
                   causal=causal, max_abs_err_dq=errs[0], max_abs_err_dk=errs[1],
                   max_abs_err_dv=errs[2], tolerance=tol, dq_ms=dq_ms, dkv_ms=dkv_ms,
                   kernels_ms=dq_ms + dkv_ms, plain_ms=plain_ms, library_ms=library_ms,
                   bound_note="10*d FLOPs a pair; the kernels do 14*d, so at most 10/14 of it; "
                              "f32 bound_tc_* at the 3xTF32 rate (495/3 TFLOP/s)")
        for prefix, (flops, tensors) in bounds.items():
            row[f"{prefix}bound_ms"], row[f"{prefix}bound_by"] = kernel_bound_ms(
                shape, dtype, causal, flops, tensors)
            if dtype == torch.float32:
                row[f"{prefix}bound_tc_ms"] = kernel_bound_ms(
                    shape, dtype, causal, flops, tensors, PEAK_TC_F32)[0]
        if shape[3] not in HEAD_DIMS:  # each kernel's padding copy (q, k, v, dO), in its ms
            row["pad_ms"] = cuda_ms(lambda: _pad_head_dim(q, k, v, do), iters)
        if name in BWD_RERUN_CASES:  # no atomics: a second run agrees bit for bit
            again = (flash_attention_bwd_dq(q, k, v, do, lse, delta, causal),
                     *flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal))
            row["deterministic"] = all(torch.equal(a, b) for a, b in zip((dq, dk, dv), again))
            ok = ok and row["deterministic"]
        emit(phase="kernel", kernel="flash_attention_bwd", **row)
        if not ok:
            raise AssertionError(f"flash-attention backward kernels disagree with the plain "
                                 f"version or with themselves: {row}")
        results[name] = row
        del q, k, v, do, o, lse, delta, dq, dk, dv, ref, qt, kt, vt, dot
    return results


def predictor_phase(seed: int):
    from distkeras_tpu_torch import ModelPredictor, from_numpy
    from distkeras_tpu_torch.models import TorchModel, TrainedModel, TransformerClassifier
    from distkeras_tpu_torch.ops import flash_attention

    model = TransformerClassifier(num_classes=2, **GPT2_SMALL,
                                  generator=torch.Generator().manual_seed(seed))
    params = {name: p.detach() for name, p in model.named_parameters()}
    rows, seq, batch = 64, 1024, 16
    tokens = np.random.default_rng(seed).integers(0, GPT2_SMALL["vocab_size"], (rows, seq),
                                                  dtype=np.int32)
    frame = from_numpy(tokens)
    predictor = ModelPredictor(TrainedModel(TorchModel(model), params, device="cuda"),
                               batch_size=batch, device="cuda")
    predictor.predict(frame.limit(batch))  # warm-up: cuBLAS handles, allocator

    flash_attention.launches = 0
    t0 = time.perf_counter()
    probs = predictor.predict(frame)["prediction"]
    seconds = time.perf_counter() - t0
    launches = flash_attention.launches
    expected = GPT2_SMALL["num_layers"] * (rows // batch)
    if launches != expected:
        raise AssertionError(f"flash kernel launched {launches} times, expected {expected}")
    if probs.shape != (rows, 2) or not np.isfinite(probs).all() \
            or not np.allclose(probs.sum(-1), 1.0, atol=1e-5):
        raise AssertionError(f"bad predictions: shape {probs.shape}")

    cpu = ModelPredictor(TrainedModel(TorchModel(model), params, device="cpu"),
                         batch_size=2, device="cpu")
    ref = cpu.predict(frame.limit(2))["prediction"]
    err = float(np.abs(probs[:2] - ref).max())
    emit(phase="predictor", model="TransformerClassifier", **GPT2_SMALL, rows=rows, seq=seq,
         batch_size=batch, launches=launches, expected_launches=expected,
         seconds=seconds, rows_per_s=rows / seconds, max_abs_err_vs_cpu=err,
         atol=PREDICT_ATOL)
    if err > PREDICT_ATOL:
        raise AssertionError(f"card and CPU predictions differ by {err}")
    return launches


def lm_phase(seed: int):
    from distkeras_tpu_torch.models import TorchModel, TrainedModel, TransformerLM
    from distkeras_tpu_torch.ops import flash_attention

    model = TransformerLM(**GPT2_SMALL, generator=torch.Generator().manual_seed(seed + 1))
    params = {name: p.detach() for name, p in model.named_parameters()}
    tokens = np.random.default_rng(seed + 1).integers(0, GPT2_SMALL["vocab_size"], (4, 1024),
                                                      dtype=np.int32)
    trained = TrainedModel(TorchModel(model), params, device="cuda")

    flash_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits = trained(tokens)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = flash_attention.launches
    expected = GPT2_SMALL["num_layers"]
    if launches != expected:
        raise AssertionError(f"flash kernel launched {launches} times, expected {expected}")
    if tuple(logits.shape) != (4, 1024, GPT2_SMALL["vocab_size"]) \
            or not torch.isfinite(logits).all():
        raise AssertionError(f"bad logits: shape {tuple(logits.shape)}")

    ref = TrainedModel(TorchModel(model), params, device="cpu")(tokens[:1])
    err = (logits[0].cpu() - ref[0]).abs().max().item()
    emit(phase="lm", model="TransformerLM", **GPT2_SMALL, tokens=[4, 1024],
         launches=launches, expected_launches=expected, seconds=seconds,
         tokens_per_s=4 * 1024 / seconds, max_abs_err_vs_cpu=err, atol=LM_LOGITS_ATOL)
    if err > LM_LOGITS_ATOL:
        raise AssertionError(f"card and CPU logits differ by {err}")
    return launches


def lm_task(rows: int, seq: int, vocab: int, seed: int):
    """The ``(token + 1) mod vocab`` next-token task, a random start a row."""
    start = np.random.default_rng(seed).integers(0, vocab, (rows, 1))
    x = (start + np.arange(seq)) % vocab
    return x.astype(np.int32), ((x + 1) % vocab).astype(np.int32)


def train_phase(seed: int):
    import distkeras_tpu_torch as tdk
    from distkeras_tpu_torch.models import TorchModel, TransformerLM
    from distkeras_tpu_torch.ops import (
        flash_attention,
        flash_attention_bwd_dkv,
        flash_attention_bwd_dq,
        get_loss,
    )

    model = TransformerLM(**GPT2_SMALL, generator=torch.Generator().manual_seed(seed + 2))
    x, y = lm_task(TRAIN_ROWS, TRAIN_SEQ, GPT2_SMALL["vocab_size"], seed + 2)
    trainer = tdk.DOWNPOUR(
        model, loss="token_crossentropy", metrics=("token_accuracy",),
        worker_optimizer=("adam", {"learning_rate": 2e-4}), num_workers=TRAIN_WORKERS,
        batch_size=TRAIN_BATCH, communication_window=TRAIN_WINDOW, num_epoch=TRAIN_EPOCHS,
        seed=seed, device="cuda",
    )
    # warm-up outside the counted run: cuBLAS handles, allocator, kernels
    adapter = TorchModel(model)
    loss_fn = get_loss("token_crossentropy")
    warm = {k: p.detach().cuda().requires_grad_(True) for k, p in model.named_parameters()}
    out, _ = adapter.apply(warm, {}, torch.from_numpy(x[:TRAIN_BATCH]).cuda(), training=True)
    torch.autograd.grad(loss_fn(out, y[:TRAIN_BATCH]), list(warm.values()))
    del warm, out
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    flash_attention.launches = 0
    flash_attention_bwd_dq.launches = 0
    flash_attention_bwd_dkv.launches = 0
    trained = trainer.train(tdk.from_numpy(x, y))
    torch.cuda.synchronize()
    launches = {"flash_attention_fwd": flash_attention.launches,
                "flash_attention_bwd_dq": flash_attention_bwd_dq.launches,
                "flash_attention_bwd_dkv": flash_attention_bwd_dkv.launches}
    steps_per_worker = TRAIN_EPOCHS * (TRAIN_ROWS // (TRAIN_WORKERS * TRAIN_BATCH))
    local_steps = TRAIN_WORKERS * steps_per_worker
    expected = GPT2_SMALL["num_layers"] * local_steps
    history = trainer.get_history()
    seconds = history["training_time"]
    tokens = TRAIN_EPOCHS * TRAIN_ROWS * TRAIN_SEQ
    emit(phase="train", trainer="DOWNPOUR", model="TransformerLM", **GPT2_SMALL,
         workers=TRAIN_WORKERS, batch_size=TRAIN_BATCH, window=TRAIN_WINDOW,
         epochs=TRAIN_EPOCHS, rows=TRAIN_ROWS, seq=TRAIN_SEQ, local_steps=local_steps,
         launches=launches, expected_launches=expected, loss=history["loss"],
         token_accuracy=history["token_accuracy"], num_updates=trainer.num_updates,
         seconds=seconds, seconds_per_step=seconds / local_steps,
         tokens_per_s=tokens / seconds,
         peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
         params=sum(p.numel() for p in trained.params.values()))
    for name, count in launches.items():
        if count != expected:
            raise AssertionError(f"{name} launched {count} times in training, expected {expected}")
    losses = np.asarray(history["loss"])
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise AssertionError(f"training loss did not fall: {losses.tolist()}")

    # one step at [1, 1024] on the card against the CPU, through the same loss
    params = {k: v.detach().cpu() for k, v in trained.params.items()}
    tokens_1, labels_1 = torch.from_numpy(x[:1]), torch.from_numpy(y[:1])

    def step(device):
        leaves = {k: v.to(device).requires_grad_(True) for k, v in params.items()}
        out, _ = adapter.apply(leaves, {}, tokens_1.to(device), training=True)
        loss = loss_fn(out.float(), labels_1.to(device))
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return loss.item(), {k: g.cpu() for k, g in zip(leaves, grads)}

    flash_attention_bwd_dq.launches = 0
    loss_card, grads_card = step("cuda")
    step_launches = flash_attention_bwd_dq.launches
    t0 = time.perf_counter()
    loss_cpu, grads_cpu = step("cpu")
    cpu_seconds = time.perf_counter() - t0
    loss_err = abs(loss_card - loss_cpu) / abs(loss_cpu)
    grad_errs = {k: ((grads_card[k] - g).norm() / g.norm().clamp(min=1e-30)).item()
                 for k, g in grads_cpu.items()}
    worst = max(grad_errs, key=grad_errs.get)
    emit(phase="train_step_vs_cpu", tokens=[1, TRAIN_SEQ], loss_card=loss_card,
         loss_cpu=loss_cpu, loss_rel_err=loss_err, loss_rtol=STEP_LOSS_RTOL,
         max_grad_rel_norm_err=grad_errs[worst], worst_param=worst,
         grad_rtol=STEP_GRAD_RTOL, bwd_dq_launches=step_launches, cpu_seconds=cpu_seconds)
    if step_launches != GPT2_SMALL["num_layers"]:
        raise AssertionError(f"the card's step launched dQ {step_launches} times")
    if loss_err > STEP_LOSS_RTOL or grad_errs[worst] > STEP_GRAD_RTOL:
        raise AssertionError(f"card and CPU training steps differ: loss {loss_err}, "
                             f"{worst} gradient {grad_errs[worst]}")
    run = dict(loss=history["loss"], params={k: v.detach().float().cpu().clone()
                                             for k, v in trained.params.items()})
    return launches, run


# The paper's training suite (bench.py's table of configurations), at the
# published widths and per-worker batches, bf16 compute: (phase, trainer,
# model, model kwargs, per-worker batch, input shape, int ids?, classes,
# worker optimizer (None: the trainer's default), trainer kwargs)
ZOO_CONFIGS = [
    ("mnist_mlp_single", "SingleTrainer", "MLP", {}, 512, (784,), False, 10,
     ("sgd", {"learning_rate": 0.1}), {}),
    ("mnist_cnn_downpour", "DOWNPOUR", "MNISTCNN", {}, 256, (28, 28, 1), False, 10,
     ("sgd", {"learning_rate": 0.05}), {}),
    ("cifar_cnn_downpour", "DOWNPOUR", "CIFARCNN", {}, 256, (32, 32, 3), False, 10,
     ("sgd", {"learning_rate": 0.05, "momentum": 0.9}), {}),
    ("cifar_cnn_aeasgd", "AEASGD", "CIFARCNN", {}, 256, (32, 32, 3), False, 10,
     ("sgd", {"learning_rate": 0.05}), {"rho": 5.0, "learning_rate": 0.05}),
    ("cifar_cnn_aeasgd", "EAMSGD", "CIFARCNN", {}, 256, (32, 32, 3), False, 10,
     None, {"rho": 5.0, "learning_rate": 0.05}),
    ("cifar_resnet20_adag", "ADAG", "ResNet20", {}, 128, (32, 32, 3), False, 10,
     ("sgd", {"learning_rate": 0.1, "momentum": 0.9}), {}),
    ("imdb_textcnn_dynsgd", "DynSGD", "TextCNN", {"vocab_size": 20000, "num_classes": 2}, 128,
     (256,), True, 2, ("adam", {"learning_rate": 1e-3}), {}),
]
# every configuration: 2 workers (SingleTrainer: 1), window 16, 2 windows an
# epoch, 2 epochs
ZOO_WORKERS, ZOO_WINDOW, ZOO_WINDOWS, ZOO_EPOCHS = 2, 16, 2, 2
ZOO_DEVICE = "cuda"  # the zoo phases' device (a CPU rehearsal at small sizes sets "cpu")
ZOO_STEP_ROWS = 32  # rows of the f32 step held against the CPU
ZOO_PREDICT_ROWS = 256
REPEAT_CONFIG = "cifar_cnn_downpour"  # trained twice: is the run bitwise repeatable?
# configurations whose model forward + backward is traced by torch.profiler
PROFILE_CONFIGS = ("cifar_cnn_downpour", "cifar_resnet20_adag")
# kernel-name fragments of cuDNN convolutions and cuBLAS/CUTLASS products
CONV_GEMM_KERNELS = ("conv", "gemm", "xmma", "cutlass", "wgrad", "dgrad", "fprop", "cudnn",
                     "sm90_", "nchw", "nhwc")
# the staleness run: DynSGD over TextCNN, per-worker commit periods, 64 steps an epoch
STALENESS_SCHEDULE, STALENESS_STEPS, STALENESS_EPOCHS, STALENESS_BATCH = (16, 32), 64, 2, 128


def zoo_data(shape, int_data: bool, classes: int, rows: int, seed: int):
    """bench.py's data: normal features (int ids in [0, 1000) for the text
    model) and random one-hot labels, drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    if int_data:
        x = rng.integers(0, 1000, size=(rows,) + shape).astype(np.int32)
    else:
        x = rng.standard_normal(size=(rows,) + shape, dtype=np.float32)
    y = np.eye(classes, dtype=np.float32)[rng.integers(0, classes, rows)]
    return x, y


def _keeping_fit(cls):
    """``cls`` whose instances keep the ``(engine, state, adapter)`` of
    their last fit, for checks on the state the trainer does not return."""

    class Kept(cls):
        def _fit(self, *args, **kwargs):
            self.fit_result = super()._fit(*args, **kwargs)
            return self.fit_result

    Kept.__name__ = cls.__name__
    return Kept


def simulate_clocks(schedule, n_steps: int, n_epochs: int):
    """Host-side count of the race the staleness simulation models: each
    step, every worker whose period divides ``t + 1`` commits; committers
    of one step all see the update count from before the step, then their
    clocks jump to the count after it.  Returns (clocks, num_updates,
    staleness of every commit)."""
    clocks, num_updates, staleness = [0] * len(schedule), 0, []
    for _ in range(n_epochs):
        for t in range(n_steps):
            committers = [i for i, p in enumerate(schedule) if (t + 1) % p == 0]
            staleness += [num_updates - clocks[i] for i in committers]
            num_updates += len(committers)
            for i in committers:
                clocks[i] = num_updates
    return clocks, num_updates, staleness


def fwd_bwd(adapter, params, state, x, y, loss_fn, dtype):
    """One forward + backward of the model alone, params cast to ``dtype``
    inside the loss as the engine does: a step less the optimizer update and
    the engine's bookkeeping."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    x_c = x.to(dtype) if x.is_floating_point() else x

    def run():
        p = {k: v.to(dtype) for k, v in leaves.items()}
        out, _ = adapter.apply(p, {k: v.clone() for k, v in state.items()}, x_c, training=True)
        torch.autograd.grad(loss_fn(out.float(), y), list(leaves.values()))

    return run


def fwd_bwd_profile(run, iters: int = 5):
    """Where the model's forward + backward ``run`` spends the card's time:
    ``torch.profiler`` over ``iters`` calls, kernel time split into
    convolutions and dense products (cuDNN, cuBLAS, CUTLASS) and the rest
    (pooling, BatchNorm, ReLU, casts, the loss), per call, and the card's
    busy share of the wall time.  A profiler that records no device time
    gives ``None`` for the device numbers."""
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels, launches = {}, 0
    for event in prof.key_averages():
        if getattr(event, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(event, "self_device_time_total", None)
        if us is None:
            us = event.self_cuda_time_total
        if us > 0:
            kernels[event.key] = kernels.get(event.key, 0.0) + us
            launches += event.count
    total_us = sum(kernels.values())
    if not total_us:
        return dict(profile_iters=iters, device_ms_per_call=None, conv_gemm_share=None,
                    device_busy_share=None, top_kernels=[])
    conv_us = sum(us for name, us in kernels.items()
                  if any(f in name.lower() for f in CONV_GEMM_KERNELS))
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    return dict(profile_iters=iters, device_ms_per_call=total_us / iters / 1e3,
                conv_gemm_ms_per_call=conv_us / iters / 1e3,
                other_ms_per_call=(total_us - conv_us) / iters / 1e3,
                conv_gemm_share=conv_us / total_us,
                device_busy_share=total_us / 1e6 / wall, wall_ms_per_call=wall / iters * 1e3,
                kernels_per_call=launches / iters,
                top_kernels=[[name[:80], us / iters / 1e3] for name, us in top])


def training_step(adapter, params, state, x, y, loss_fn, device, dtype):
    """One training-mode forward + backward from ``params`` in ``dtype`` on
    ``device``: the loss and each parameter's gradient (in f64, on the CPU)."""
    leaves = {k: v.detach().to(device, dtype).requires_grad_(True) for k, v in params.items()}
    st = {k: v.detach().to(device, dtype).clone() for k, v in state.items()}
    x_d = torch.from_numpy(x).to(device)
    out, _ = adapter.apply(leaves, st, x_d.to(dtype) if x_d.is_floating_point() else x_d,
                           training=True)
    loss = loss_fn(out.to(dtype), torch.from_numpy(y).to(device, dtype))
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.item(), {k: g.cpu().double() for k, g in zip(leaves, grads)}


def step_errors(step, reference):
    """(loss relative error, worst gradient relative norm error, its
    parameter) of ``step`` against ``reference``."""
    (loss, grads), (ref_loss, ref_grads) = step, reference
    errs = {k: ((grads[k] - g).norm() / g.norm().clamp(min=1e-30)).item()
            for k, g in ref_grads.items()}
    worst = max(errs, key=errs.get)
    return abs(loss - ref_loss) / abs(ref_loss), errs[worst], worst


def train_zoo_config(config, seed: int):
    """Train one configuration of ``ZOO_CONFIGS`` on the card through its
    trainer class.  Returns (trainer, trained model, row of numbers)."""
    import distkeras_tpu_torch as tdk
    from distkeras_tpu_torch.data import epoch_arrays
    from distkeras_tpu_torch.models import TorchModel, zoo
    from distkeras_tpu_torch.ops import get_loss

    name, trainer_name, model_name, model_kw, batch, shape, int_data, classes, opt, extra = config
    single = trainer_name == "SingleTrainer"
    workers = 1 if single else ZOO_WORKERS
    rows = workers * ZOO_WINDOWS * ZOO_WINDOW * batch
    x, y = zoo_data(shape, int_data, classes, rows, seed)
    model = getattr(zoo, model_name)(**model_kw, generator=torch.Generator().manual_seed(seed))
    adapter, loss_fn = TorchModel(model), get_loss("categorical_crossentropy")

    # the model alone at the same batch (this also warms cuDNN and the allocator)
    params = {k: p.detach().to(ZOO_DEVICE) for k, p in model.named_parameters()}
    buffers = {k: b.detach().to(ZOO_DEVICE) for k, b in model.named_buffers()}
    xb = torch.from_numpy(x[:batch]).to(ZOO_DEVICE)
    yb = torch.from_numpy(y[:batch]).to(ZOO_DEVICE)
    run = fwd_bwd(adapter, params, buffers, xb, yb, loss_fn, torch.bfloat16)
    model_ms = cuda_ms(run, 20, warmup=3)
    profile_row = fwd_bwd_profile(run) if name in PROFILE_CONFIGS else None
    del run, params, buffers, xb, yb
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    kwargs = dict(loss="categorical_crossentropy", metrics=(), batch_size=batch,
                  num_epoch=ZOO_EPOCHS, seed=seed, compute_dtype="bfloat16", device=ZOO_DEVICE)
    if opt is not None:
        kwargs["worker_optimizer"] = opt
    if not single:
        kwargs.update(num_workers=workers, communication_window=ZOO_WINDOW)
    trainer = _keeping_fit(getattr(tdk, trainer_name))(model, **kwargs, **extra)
    trained = trainer.train(tdk.from_numpy(x, y))
    torch.cuda.synchronize()
    history = trainer.get_history()
    seconds = history["training_time"]
    local_steps = ZOO_EPOCHS * workers * ZOO_WINDOWS * ZOO_WINDOW
    expected_updates = None if single else ZOO_EPOCHS * ZOO_WINDOWS * workers
    row = dict(config=name, trainer=trainer_name, model=model_name, **model_kw,
               workers=workers, batch_size=batch, window=None if single else ZOO_WINDOW,
               epochs=ZOO_EPOCHS, rows=rows, compute_dtype="bfloat16", local_steps=local_steps,
               seconds=seconds, samples_per_s=ZOO_EPOCHS * rows / seconds,
               seconds_per_step=seconds / local_steps, model_fwd_bwd_seconds=model_ms / 1e3,
               engine_overhead_seconds=seconds / local_steps - model_ms / 1e3,
               loss=history["loss"],
               num_updates=None if single else trainer.num_updates,
               expected_num_updates=expected_updates,
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
               params=sum(p.numel() for p in trained.params.values()))
    if profile_row is not None:
        row["model_profile"] = profile_row
    # the host's share: one epoch's shuffle-free gather and copy to the card
    # (data.epoch_arrays + engine.shard_batches), as the trainer runs it
    engine = trainer.fit_result[0]
    t0 = time.perf_counter()
    xs, ys = engine.shard_batches(*epoch_arrays(x, y, workers, batch, ZOO_WINDOW))
    torch.cuda.synchronize()
    data_per_step = (time.perf_counter() - t0) / (local_steps // ZOO_EPOCHS)
    del xs, ys
    row.update(data_seconds_per_step=data_per_step,
               optimizer_and_commit_seconds_per_step=row["engine_overhead_seconds"] - data_per_step)
    losses = np.asarray(history["loss"])
    if not np.isfinite(losses).all():
        raise AssertionError(f"{name}/{trainer_name}: loss not finite: {losses.tolist()}")
    if row["num_updates"] != expected_updates:
        raise AssertionError(f"{name}/{trainer_name}: {row['num_updates']} updates, "
                             f"expected {expected_updates}")

    # one f32 step on [32, ...] rows, card against CPU (TF32 is off), and
    # the same step in f64
    args = (adapter, {k: v.cpu() for k, v in trained.params.items()},
            {k: v.cpu() for k, v in trained.state.items()},
            x[:ZOO_STEP_ROWS], y[:ZOO_STEP_ROWS], loss_fn)
    steps = {(device, dtype): training_step(*args, device, dtype)
             for device in (ZOO_DEVICE, "cpu") for dtype in (torch.float32, torch.float64)}
    loss_err, grad_err, worst = step_errors(steps[ZOO_DEVICE, torch.float32],
                                            steps["cpu", torch.float32])
    loss64_err, grad64_err, worst64 = step_errors(steps[ZOO_DEVICE, torch.float64],
                                                  steps["cpu", torch.float64])
    _, cpu_f32_err, cpu_worst = step_errors(steps["cpu", torch.float32],
                                            steps["cpu", torch.float64])
    # A ReLU's gradient jumps at its kink: where two f32 evaluations round
    # a pre-activation to opposite sides of zero, the gradients part by up
    # to ~5e-3 (one such element in a trained ResNet20 at 32 rows).  So the
    # f32 gradients are held to 1e-3 where f32 resolves this step to 1e-3
    # at all, as the CPU's own f32 step against its f64 step shows; the
    # f64 step (no kink within reach) is always held, and so is the loss.
    f32_resolves = cpu_f32_err <= STEP_GRAD_RTOL
    row.update(step_rows=ZOO_STEP_ROWS, step_loss_rel_err=loss_err, step_loss_rtol=STEP_LOSS_RTOL,
               step_max_grad_rel_norm_err=grad_err, step_worst_param=worst,
               step_grad_rtol=STEP_GRAD_RTOL, step_cpu_f32_vs_f64_grad_err=cpu_f32_err,
               step_cpu_f32_worst_param=cpu_worst, step_f32_grads_held=f32_resolves,
               step_f64_loss_rel_err=loss64_err, step_f64_max_grad_rel_norm_err=grad64_err,
               step_f64_worst_param=worst64)
    gated = {"f32 step": (loss_err, grad_err if f32_resolves else 0.0, worst),
             "f64 step": (loss64_err, grad64_err, worst64)}
    row["failures"] = [f"card and CPU differ in the {what}: loss {l_err}, {param} gradient {g_err}"
                       for what, (l_err, g_err, param) in gated.items()
                       if l_err > STEP_LOSS_RTOL or g_err > STEP_GRAD_RTOL]
    return trainer, trained, row, x


def zoo_phase(seed: int):
    """Every configuration of ``ZOO_CONFIGS``, one JSON line each, with the
    checks of each; ``cifar_cnn_downpour`` twice (bitwise repeatable?)."""
    from distkeras_tpu_torch import ModelPredictor, from_numpy
    from distkeras_tpu_torch.models import TrainedModel

    rows = []
    for config in ZOO_CONFIGS:
        name, trainer_name = config[0], config[1]
        trainer, trained, row, x = train_zoo_config(config, seed)
        if name == REPEAT_CONFIG:
            _, again, _, _ = train_zoo_config(config, seed)
            row["bitwise_repeatable"] = all(torch.equal(v, again.params[k])
                                            for k, v in trained.params.items())
            row["second_run_seconds_per_step"] = again.history["training_time"] / row["local_steps"]
            losses = row["loss"]
            if not losses[1] < losses[0]:
                row["failures"].append(f"loss did not fall from epoch 1 to 2: {losses}")
            # ModelPredictor over the trained CIFARCNN, card against CPU
            frame = from_numpy(x[:ZOO_PREDICT_ROWS])
            card = ModelPredictor(trained, batch_size=128, device=ZOO_DEVICE).predict(frame)
            cpu_model = TrainedModel(trained.adapter,
                                     {k: v.cpu() for k, v in trained.params.items()},
                                     {k: v.cpu() for k, v in trained.state.items()}, device="cpu")
            cpu = ModelPredictor(cpu_model, batch_size=128, device="cpu").predict(frame)
            err = float(np.abs(card["prediction"] - cpu["prediction"]).max())
            row.update(predict_rows=ZOO_PREDICT_ROWS, predict_max_abs_err_vs_cpu=err,
                       predict_atol=PREDICT_ATOL)
            if err > PREDICT_ATOL:
                row["failures"].append(f"card and CPU predictions differ by {err}")
        if trainer_name == "ADAG":
            # BatchNorm running statistics: moved from their init, and the same
            # on every worker right after the last window's commit
            engine, state, _ = trainer.fit_result
            stats = {k: v for k, v in state.model_state.items() if "running" in k}
            moved = max(float((v - (1.0 if k.endswith("var") else 0.0)).abs().max())
                        for k, v in stats.items())
            synced = all(torch.equal(v[0], v[1]) for v in stats.values())
            row.update(running_stats=len(stats), running_stats_moved=moved,
                       running_stats_equal_across_workers=synced)
            if len(stats) != 2 * 19 or not moved > 0.0 or not synced:
                row["failures"].append(f"running statistics moved {moved}, "
                                       f"equal across workers {synced}")
        emit(phase="zoo", **row)
        if row["failures"]:
            raise AssertionError(f"{name}/{trainer_name}: {row['failures']}")
        rows.append(row)
        del trainer, trained
    return rows


def staleness_phase(seed: int):
    """DynSGD over TextCNN with per-worker commit periods: the realised
    update count and clocks must equal the host-side count of the race."""
    import distkeras_tpu_torch as tdk
    from distkeras_tpu_torch.models import zoo

    workers, batch = len(STALENESS_SCHEDULE), STALENESS_BATCH
    rows = workers * STALENESS_STEPS * batch
    x, y = zoo_data((256,), True, 2, rows, seed + 3)
    model = zoo.TextCNN(vocab_size=20000, num_classes=2,
                        generator=torch.Generator().manual_seed(seed + 3))
    trainer = _keeping_fit(tdk.DynSGD)(
        model, loss="categorical_crossentropy", worker_optimizer=("adam", {"learning_rate": 1e-3}),
        metrics=(), num_workers=workers, batch_size=batch, num_epoch=STALENESS_EPOCHS,
        communication_window=ZOO_WINDOW, commit_schedule=list(STALENESS_SCHEDULE),
        compute_dtype="bfloat16", seed=seed, device=ZOO_DEVICE)
    trainer.train(tdk.from_numpy(x, y))
    torch.cuda.synchronize()
    _, state, _ = trainer.fit_result
    clocks = state.rule_local["clock"].tolist()
    want_clocks, want_updates, staleness = simulate_clocks(STALENESS_SCHEDULE, STALENESS_STEPS,
                                                           STALENESS_EPOCHS)
    history = trainer.get_history()
    seconds = history["training_time"]
    local_steps = STALENESS_EPOCHS * STALENESS_STEPS * workers
    row = dict(trainer="DynSGD", model="TextCNN", commit_schedule=list(STALENESS_SCHEDULE),
               steps_per_epoch=STALENESS_STEPS, epochs=STALENESS_EPOCHS, batch_size=batch,
               num_updates=trainer.num_updates, expected_num_updates=want_updates,
               clocks=clocks, expected_clocks=want_clocks,
               max_staleness=max(staleness), stale_commits=sum(s > 0 for s in staleness),
               loss=history["loss"], seconds=seconds, seconds_per_step=seconds / local_steps)
    emit(phase="staleness", **row)
    if trainer.num_updates != want_updates or clocks != want_clocks:
        raise AssertionError(f"staleness run: updates {trainer.num_updates} (want "
                             f"{want_updates}), clocks {clocks} (want {want_clocks})")
    if not max(staleness) > 0 or not np.isfinite(history["loss"]).all():
        raise AssertionError(f"staleness run: no stale commit or a non-finite loss: {row}")
    return row


# The paper's DataFrame flow (examples/mnist.py) at MNIST's shape: synthetic
# rows of 784 integer pixels in [0, 255], labelled by a fixed random linear
# map of the pixels (so the task can be learned), split 0.8 / 0.2.
FLOW_ROWS, FLOW_FEATURES, FLOW_CLASSES = 60000, 784, 10
FLOW_EPOCHS = 2  # the example's default is 5: cut for time
FLOW_BATCH, FLOW_CNN_BATCH, FLOW_WORKERS = 32, 256, 2
FLOW_CPU_ROWS = 2048  # held-out rows predicted again on the CPU
FLOW_PIXEL_NOISE = 400.0  # std of the pixels around their class prototype
# Held-out accuracy each model's trainers must beat after 2 epochs.  The
# same flow on the CPU (flow_phase with ZOO_DEVICE = "cpu", at these
# sizes) gave 0.9306 (SingleTrainer), 0.9516 (DOWNPOUR), 0.9582 (AEASGD),
# 0.9604 (ADAG) and 0.3847 (MNISTCNN, 375 steps of SGD at batch 256);
# chance is 0.1.  The card sums in another order and 1,500 SGD steps an
# epoch carry that apart: its SingleTrainer reached 0.8908 where the CPU's
# reached 0.9306.  The limits leave room for that.
FLOW_MIN_ACCURACY = {"MLP": 0.8, "MNISTCNN": 0.2}
FLOW_PREDICT_ATOL = 1e-5
FLOW_LOSS_RTOL = 1e-5
# (name, trainer, model, batch, trainer kwargs): the example's settings
FLOW_TRAINERS = [
    ("SingleTrainer", "SingleTrainer", "MLP", FLOW_BATCH,
     {"worker_optimizer": ("sgd", {"learning_rate": 0.1})}),
    ("DOWNPOUR", "DOWNPOUR", "MLP", FLOW_BATCH,
     {"worker_optimizer": ("adam", {"learning_rate": 1e-3 / FLOW_WORKERS}),
      "communication_window": 5}),
    ("AEASGD", "AEASGD", "MLP", FLOW_BATCH,
     {"worker_optimizer": ("sgd", {"learning_rate": 0.1}), "communication_window": 16,
      "rho": 1.0, "learning_rate": 0.05}),
    ("ADAG", "ADAG", "MLP", FLOW_BATCH,
     {"worker_optimizer": ("adam", {"learning_rate": 1e-3 * 8 / FLOW_WORKERS}),
      "communication_window": 8}),
    ("SingleTrainer_MNISTCNN", "SingleTrainer", "MNISTCNN", FLOW_CNN_BATCH,
     {"worker_optimizer": ("sgd", {"learning_rate": 0.05})}),
]


def synthetic_mnist(rows: int, features: int, classes: int, seed: int):
    """MNIST-shaped data drawn from ``seed``: integer pixels in [0, 255] and
    labels from a fixed random linear map ``w`` of them.  Each row is a noisy
    copy of one of ``classes`` prototypes (bright where a column of ``w`` is
    positive), so the classes form clusters that a model learns in an epoch,
    as MNIST's digits do; the label is the map's argmax, not the prototype."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((features, classes)).astype(np.float32)
    prototypes = np.where(w > 0, 200.0, 55.0).T  # [classes, features]
    drawn = rng.integers(0, classes, rows)
    noise = rng.normal(0.0, FLOW_PIXEL_NOISE, (rows, features))
    x = np.clip(np.rint(prototypes[drawn] + noise), 0, 255).astype(np.float32)
    y = np.argmax((x / 255.0 - 0.5) @ w, axis=-1).astype(np.int64)
    return x, y


def logged_scalars(logdir: str):
    """What a trainer's ``ScalarLogger`` wrote to ``logdir``, as
    ``(sink, [{"step", "loss", ...}])``: its ``scalars.jsonl``, or, where
    ``torch.utils.tensorboard`` imports and the logger took it, its
    TensorBoard event files."""
    import os

    jsonl = os.path.join(logdir, "scalars.jsonl")
    if os.path.exists(jsonl):
        with open(jsonl) as f:
            return "jsonl", [json.loads(line) for line in f]
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(logdir)
    acc.Reload()
    lines = {}
    for tag in acc.Tags()["scalars"]:
        for event in acc.Scalars(tag):
            lines.setdefault(event.step, {"step": event.step})[tag] = event.value
    return "tensorboard", [lines[step] for step in sorted(lines)]


def windows_per_epoch(rows: int, workers: int, batch: int, window: int) -> int:
    """Commits a worker makes in an epoch: the windows that cover ``rows``
    (the last one padded by wrapping round), as the JAX package plans them."""
    steps = -(-rows // (workers * batch))
    return -(-steps // window)


def flow_phase(seed: int):
    """The paper's flow through the port's public API: ``from_numpy`` ->
    ``MinMaxTransformer`` -> ``OneHotTransformer`` -> ``split`` -> a trainer
    -> ``ModelPredictor`` -> ``LabelIndexTransformer`` ->
    ``AccuracyEvaluator``, and ``LossEvaluator``, for each of
    ``FLOW_TRAINERS``, with ``tensorboard_dir`` set.  One JSON line each."""
    import tempfile

    import distkeras_tpu_torch as tdk
    from distkeras_tpu_torch.models import TrainedModel, zoo

    t0 = time.perf_counter()
    x, y = synthetic_mnist(FLOW_ROWS, FLOW_FEATURES, FLOW_CLASSES, seed + 4)
    df = tdk.from_numpy(x, y, features_col="features_raw", label_col="label")
    df = tdk.MinMaxTransformer(0.0, 1.0, 0.0, 255.0, input_col="features_raw",
                               output_col="features").transform(df)
    df = tdk.OneHotTransformer(FLOW_CLASSES, input_col="label",
                               output_col="label_encoded").transform(df)
    df = tdk.ReshapeTransformer("features", "image", (28, 28, 1)).transform(df)
    train_df, test_df = df.split(0.8, seed=seed)
    prepare_seconds = time.perf_counter() - t0
    n_train, n_test = len(train_df), len(test_df)
    rows = []
    for name, trainer_name, model_name, batch, kwargs in FLOW_TRAINERS:
        single = trainer_name == "SingleTrainer"
        workers = 1 if single else FLOW_WORKERS
        features_col = "image" if model_name == "MNISTCNN" else "features"
        if model_name == "MLP":
            model = zoo.MLP(features=(256, 128), num_classes=FLOW_CLASSES,
                            in_features=FLOW_FEATURES,
                            generator=torch.Generator().manual_seed(seed))
        else:
            model = zoo.MNISTCNN(num_classes=FLOW_CLASSES,
                                 generator=torch.Generator().manual_seed(seed))
        extra = {} if single else {"num_workers": workers}
        with tempfile.TemporaryDirectory() as logdir:
            trainer = getattr(tdk, trainer_name)(
                model, loss="categorical_crossentropy", features_col=features_col,
                label_col="label_encoded", batch_size=batch, num_epoch=FLOW_EPOCHS, seed=seed,
                tensorboard_dir=logdir, device=ZOO_DEVICE, **extra, **kwargs)
            trained = trainer.train(train_df)
            sink, scalars = logged_scalars(logdir)
        torch.cuda.synchronize()
        history = trainer.get_history()
        seconds = history["training_time"]
        window = kwargs.get("communication_window")
        if single:
            local_steps = FLOW_EPOCHS * -(-n_train // batch)
            expected_updates = None
        else:
            n_windows = windows_per_epoch(n_train, workers, batch, window)
            local_steps = FLOW_EPOCHS * n_windows * window * workers
            expected_updates = FLOW_EPOCHS * n_windows * workers

        t1 = time.perf_counter()
        pred = tdk.ModelPredictor(trained, features_col=features_col,
                                  device=ZOO_DEVICE).predict(test_df)
        pred = tdk.LabelIndexTransformer(FLOW_CLASSES, input_col="prediction",
                                         output_col="prediction_index").transform(pred)
        accuracy = tdk.AccuracyEvaluator(prediction_col="prediction_index",
                                         label_col="label").evaluate(pred)
        predict_seconds = time.perf_counter() - t1
        loss = tdk.LossEvaluator("categorical_crossentropy", prediction_col="prediction",
                                 label_col="label_encoded", device=ZOO_DEVICE).evaluate(pred)
        recount = float(np.mean(np.argmax(pred["prediction"], -1) == pred["label"]))
        # the same trained parameters on the CPU
        cpu_model = TrainedModel(trained.adapter, {k: v.cpu() for k, v in trained.params.items()},
                                 {k: v.cpu() for k, v in trained.state.items()}, device="cpu")
        head = pred.limit(FLOW_CPU_ROWS)
        cpu_pred = tdk.ModelPredictor(cpu_model, features_col=features_col,
                                      device="cpu").predict(head)
        predict_err = float(np.abs(head["prediction"] - cpu_pred["prediction"]).max())
        cpu_loss = tdk.LossEvaluator("categorical_crossentropy", prediction_col="prediction",
                                     label_col="label_encoded", device="cpu").evaluate(pred)
        loss_err = abs(loss - cpu_loss) / abs(cpu_loss)
        logged_loss = [line.get("loss") for line in scalars]
        row = dict(trainer=name, model=model_name, workers=workers, batch_size=batch,
                   window=window, epochs=FLOW_EPOCHS, example_epochs=5,
                   cut="2 epochs instead of examples/mnist.py's 5, for time",
                   train_rows=n_train, test_rows=n_test, local_steps=local_steps,
                   seconds=seconds, samples_per_s=FLOW_EPOCHS * n_train / seconds,
                   seconds_per_step=seconds / local_steps, loss=history["loss"],
                   accuracy=accuracy, accuracy_recount=recount,
                   min_accuracy=FLOW_MIN_ACCURACY[model_name], predict_seconds=predict_seconds,
                   predict_rows_per_s=n_test / predict_seconds, loss_evaluator=loss,
                   loss_evaluator_cpu=cpu_loss, loss_evaluator_rel_err=loss_err,
                   loss_rtol=FLOW_LOSS_RTOL, predict_cpu_rows=len(head),
                   predict_max_abs_err_vs_cpu=predict_err, predict_atol=FLOW_PREDICT_ATOL,
                   scalar_sink=sink, scalar_lines=len(scalars), scalar_loss=logged_loss,
                   num_updates=None if single else trainer.num_updates,
                   expected_num_updates=expected_updates)
        failures = []
        if not accuracy > FLOW_MIN_ACCURACY[model_name]:
            failures.append(f"held-out accuracy {accuracy} not above "
                            f"{FLOW_MIN_ACCURACY[model_name]}")
        if accuracy != recount:
            failures.append(f"AccuracyEvaluator {accuracy} != numpy recount {recount}")
        if predict_err > FLOW_PREDICT_ATOL:
            failures.append(f"card and CPU predictions differ by {predict_err}")
        if loss_err > FLOW_LOSS_RTOL:
            failures.append(f"card and CPU LossEvaluator differ by {loss_err} relative")
        if len(scalars) != FLOW_EPOCHS or [line["step"] for line in scalars] != list(
                range(FLOW_EPOCHS)) or not np.array_equal(
                np.float32(logged_loss), np.float32(history["loss"])):
            failures.append(f"scalar log {scalars} does not hold the epochs' losses "
                            f"{history['loss']}")
        if row["num_updates"] != expected_updates:
            failures.append(f"{row['num_updates']} commits, expected {expected_updates}")
        if not np.isfinite(history["loss"]).all():
            failures.append(f"loss not finite: {history['loss']}")
        row["failures"] = failures
        emit(phase="flow", **row)
        if failures:
            raise AssertionError(f"flow/{name}: {failures}")
        rows.append(row)
        del trainer, trained, pred, cpu_model
    emit(phase="flow_data", rows=FLOW_ROWS, features=FLOW_FEATURES, train_rows=n_train,
         test_rows=n_test, prepare_seconds=prepare_seconds,
         steps="from_numpy, MinMaxTransformer(0, 1, 0, 255), OneHotTransformer(10), "
               "ReshapeTransformer(28, 28, 1), split(0.8)")
    return rows


# The head-dim check on whole models: GPT-2 small's widths over 8 heads
# (d = 96, which the wrappers pad to the d = 128 build) and the JAX tests'
# dim 16 over 2 heads (d = 8, padded to 16)
LM_D96 = dict(GPT2_SMALL, heads=8)
LM_D96_ROWS = 2
CLASSIFIER_D8 = dict(vocab_size=64, num_classes=3, dim=16, heads=2, num_layers=2, max_len=32)
CLASSIFIER_D8_ROWS, CLASSIFIER_D8_BATCH = 64, 16


def head_dim_phase(seed: int):
    """``ModelPredictor`` over models whose head dim is not a built size,
    card against CPU, with the forward kernel's launch counts;
    ``PerplexityEvaluator`` over the LM's output."""
    import distkeras_tpu_torch as tdk
    from distkeras_tpu_torch.models import (
        TorchModel,
        TrainedModel,
        TransformerClassifier,
        TransformerLM,
    )
    from distkeras_tpu_torch.ops import flash_attention

    out = {}
    rng = np.random.default_rng(seed + 5)
    lm = TransformerLM(**LM_D96, generator=torch.Generator().manual_seed(seed + 5))
    params = {name: p.detach() for name, p in lm.named_parameters()}
    tokens = rng.integers(0, LM_D96["vocab_size"], (LM_D96_ROWS, LM_D96["max_len"]),
                          dtype=np.int32)
    frame = tdk.from_numpy(tokens, (tokens + 1) % LM_D96["vocab_size"])
    card = tdk.ModelPredictor(TrainedModel(TorchModel(lm), params, device=ZOO_DEVICE),
                              batch_size=LM_D96_ROWS, device=ZOO_DEVICE)
    flash_attention.launches = 0
    t0 = time.perf_counter()
    probs = card.predict(frame)
    seconds = time.perf_counter() - t0
    launches = flash_attention.launches
    perplexity = tdk.PerplexityEvaluator().evaluate(probs)
    cpu = tdk.ModelPredictor(TrainedModel(TorchModel(lm), params, device="cpu"),
                             batch_size=1, device="cpu").predict(frame.limit(1))
    err = float(np.abs(probs["prediction"][:1] - cpu["prediction"]).max())
    out["lm_d96"] = dict(model="TransformerLM", **LM_D96, head_dim=96, rows=LM_D96_ROWS,
                         launches=launches, expected_launches=LM_D96["num_layers"],
                         seconds=seconds, perplexity=perplexity,
                         max_abs_err_vs_cpu=err, atol=PREDICT_ATOL)
    del probs, cpu, card

    clf = TransformerClassifier(**CLASSIFIER_D8, generator=torch.Generator().manual_seed(seed))
    params = {name: p.detach() for name, p in clf.named_parameters()}
    tokens = rng.integers(0, CLASSIFIER_D8["vocab_size"],
                          (CLASSIFIER_D8_ROWS, CLASSIFIER_D8["max_len"]), dtype=np.int32)
    frame = tdk.from_numpy(tokens)
    flash_attention.launches = 0
    card = tdk.ModelPredictor(TrainedModel(TorchModel(clf), params, device=ZOO_DEVICE),
                              batch_size=CLASSIFIER_D8_BATCH, device=ZOO_DEVICE).predict(frame)
    launches = flash_attention.launches
    cpu = tdk.ModelPredictor(TrainedModel(TorchModel(clf), params, device="cpu"),
                             batch_size=CLASSIFIER_D8_BATCH, device="cpu").predict(frame)
    err = float(np.abs(card["prediction"] - cpu["prediction"]).max())
    out["classifier_d8"] = dict(
        model="TransformerClassifier", **CLASSIFIER_D8, head_dim=8, rows=CLASSIFIER_D8_ROWS,
        launches=launches,
        expected_launches=CLASSIFIER_D8["num_layers"] * CLASSIFIER_D8_ROWS // CLASSIFIER_D8_BATCH,
        max_abs_err_vs_cpu=err, atol=PREDICT_ATOL)

    for name, row in out.items():
        emit(phase="head_dim_models", case=name, **row)
        # on the CPU the models take the reference path: no launch to count
        want = row["expected_launches"] if ZOO_DEVICE == "cuda" else 0
        if row["launches"] != want:
            raise AssertionError(f"{name}: the forward kernel launched {row['launches']} "
                                 f"times, expected {want}")
        if not row["max_abs_err_vs_cpu"] <= PREDICT_ATOL:
            raise AssertionError(f"{name}: card and CPU differ by {row['max_abs_err_vs_cpu']}")
    if not (np.isfinite(out["lm_d96"]["perplexity"]) and out["lm_d96"]["perplexity"] > 1.0):
        raise AssertionError(f"perplexity {out['lm_d96']['perplexity']}")
    return out


def networking_phase(seed: int):
    """``networking.initialize`` / ``shutdown`` over NCCL at world size 1
    with one ``all_reduce`` of a CUDA tensor between them, and a
    ``send_data`` / ``recv_data`` round trip over a socket pair."""
    import socket

    import torch.distributed as dist

    from distkeras_tpu_torch import networking

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    networking.initialize(f"127.0.0.1:{port}", 1, 0, device=ZOO_DEVICE)
    try:
        backend = dist.get_backend()
        t = torch.arange(8, dtype=torch.float32, device=ZOO_DEVICE)
        dist.all_reduce(t)
        torch.cuda.synchronize()
        reduced = t.cpu().tolist()
    finally:
        networking.shutdown()
    rng = np.random.default_rng(seed)
    msg = {"delta": {"w": rng.standard_normal((64, 32)).astype(np.float32),
                     "step": np.arange(5, dtype=np.int64)},
           "blob": bytes(range(256)), "verb": "commit"}
    a, b = socket.socketpair()
    try:
        networking.send_data(a, msg)
        got = networking.recv_data(b)
    finally:
        a.close()
        b.close()
    same = (got["verb"] == msg["verb"] and got["blob"] == msg["blob"]
            and all(np.array_equal(got["delta"][k], v) for k, v in msg["delta"].items()))
    row = dict(backend=backend, world_size=1, all_reduce=reduced,
               group_left=not dist.is_initialized(), wire_round_trip=same)
    emit(phase="networking", **row)
    if (reduced != [float(i) for i in range(8)] or not row["group_left"] or not same
            or backend != ("nccl" if ZOO_DEVICE == "cuda" else "gloo")):
        raise AssertionError(f"networking: {row}")
    return row


# The training surface of this slice, on cifar_cnn_downpour at bench.py's
# widths (CIFARCNN, per-worker batch 256, Downpour(16), SGD lr 0.05 with
# momentum 0.9, bf16 compute), 2 workers, 2 epochs of EPOCHS_WINDOWS windows
EPOCHS_CONFIG = "cifar_cnn_downpour"
EPOCHS_WINDOWS = 4
# the captured window against eager: the step checks' loss tolerance and a
# 1e-5 bound on the center parameters
GRAPH_LOSS_RTOL, GRAPH_PARAM_ATOL = 1e-6, 1e-5
# the remat/graph phase: the train phase's DOWNPOUR over GPT-2-small widths,
# with dropout, so that remat's recomputation and the graph's replays must
# draw the eager run's masks
REMAT_MODEL, REMAT_DROPOUT = GPT2_SMALL, 0.1


def _epochs_config():
    return next(c for c in ZOO_CONFIGS if c[0] == EPOCHS_CONFIG)


def _cifar_trainer(model_seed: int, **kwargs):
    """cifar_cnn_downpour's trainer (the zoo's configuration), 2 epochs."""
    import distkeras_tpu_torch as tdk
    from distkeras_tpu_torch.models import zoo

    _, trainer_name, model_name, model_kw, batch, _, _, _, opt, extra = _epochs_config()
    model = getattr(zoo, model_name)(**model_kw,
                                     generator=torch.Generator().manual_seed(model_seed))
    kwargs = dict(dict(num_epoch=ZOO_EPOCHS, **extra), **kwargs)
    return _keeping_fit(getattr(tdk, trainer_name))(
        model, loss="categorical_crossentropy", metrics=(), batch_size=batch,
        seed=model_seed, compute_dtype="bfloat16", device=ZOO_DEVICE, worker_optimizer=opt,
        num_workers=ZOO_WORKERS, communication_window=ZOO_WINDOW, **kwargs)


def _trained(trainer, frame):
    model = trainer.train(frame)
    if ZOO_DEVICE == "cuda":
        torch.cuda.synchronize()
    history = trainer.get_history()
    return dict(loss=history["loss"], seconds=history["training_time"],
                params={k: v.detach().float().cpu().clone() for k, v in model.params.items()})


def _versus(run, reference):
    """How far ``run`` lies from ``reference``: bitwise?, the largest loss
    relative error and center-parameter difference."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(run["loss"], reference["loss"]))
    param = max(float((run["params"][k] - v).abs().max()) for k, v in reference["params"].items())
    bitwise = run["loss"] == reference["loss"] and all(
        torch.equal(run["params"][k], v) for k, v in reference["params"].items())
    return dict(bitwise=bitwise, loss_rel_err=loss, max_param_err=param)


def _steady(trainer, x, y, dispatch: bool):
    """One more pass of 2 epochs on the trained engine and state, as the
    trainer runs them (the window graphs, if any, already captured): its
    seconds a local step and samples/s, then the card's busy share of one
    more pass under torch.profiler."""
    from distkeras_tpu_torch.data import epoch_arrays

    engine, state, _ = trainer.fit_result
    batch = _epochs_config()[4]
    xs, ys = engine.shard_batches(*epoch_arrays(x, y, ZOO_WORKERS, batch, ZOO_WINDOW))
    box = [state]

    def run():
        if dispatch:
            box[0], _ = engine.run_epochs(box[0], xs, ys, ZOO_EPOCHS)
        else:
            for _ in range(ZOO_EPOCHS):
                box[0], _ = engine.run_epoch(box[0], xs, ys)

    run()  # warm
    if ZOO_DEVICE == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    if ZOO_DEVICE == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    steps = ZOO_EPOCHS * EPOCHS_WINDOWS * ZOO_WINDOW * ZOO_WORKERS
    # the CPU has no device time to split (a rehearsal skips the profiler)
    profile = fwd_bwd_profile(run, iters=1) if ZOO_DEVICE == "cuda" else {}
    return dict(steady_seconds_per_step=seconds / steps,
                steady_samples_per_s=ZOO_EPOCHS * len(x) / seconds,
                device_busy_share=profile.get("device_busy_share"),
                device_ms_per_pass=profile.get("device_ms_per_call"),
                kernels_per_pass=profile.get("kernels_per_call"))


def epochs_phase(seed: int):
    """cifar_cnn_downpour three ways: eager per epoch, ``dispatch_epochs=2``
    (the on-device reshuffle off: ``train`` does not shuffle) and
    ``unroll=True`` (each window a captured CUDA graph).  The first two
    must agree bit for bit; the graph within the step checks' tolerances.
    Returns the eager run, which the next phases are held to."""
    import distkeras_tpu_torch as tdk

    batch, shape = _epochs_config()[4], _epochs_config()[5]
    rows = ZOO_WORKERS * EPOCHS_WINDOWS * ZOO_WINDOW * batch
    x, y = zoo_data(shape, False, 10, rows, seed)
    frame = tdk.from_numpy(x, y)
    runs, rows_out = {}, []
    for mode, kwargs in (("eager", {}), ("dispatch_epochs", {"dispatch_epochs": 2}),
                         ("graph", {"unroll": True})):
        trainer = _cifar_trainer(seed, **kwargs)
        run = runs[mode] = _trained(trainer, frame)
        steps = ZOO_EPOCHS * EPOCHS_WINDOWS * ZOO_WINDOW * ZOO_WORKERS
        row = dict(config=EPOCHS_CONFIG, mode=mode, **kwargs, workers=ZOO_WORKERS,
                   batch_size=batch, window=ZOO_WINDOW, windows_per_epoch=EPOCHS_WINDOWS,
                   epochs=ZOO_EPOCHS, rows=rows, local_steps=steps, loss=run["loss"],
                   seconds=run["seconds"], seconds_per_step=run["seconds"] / steps,
                   samples_per_s=ZOO_EPOCHS * rows / run["seconds"])
        row.update(_steady(trainer, x, y, dispatch=mode == "dispatch_epochs"))
        engine = trainer.fit_result[0]
        if mode == "graph":
            row.update(graphs=engine.use_graphs, graph_stats=dict(engine.graph_stats))
        if mode != "eager":
            row.update(vs_eager=_versus(run, runs["eager"]))
        emit(phase="epochs", **row)
        rows_out.append(row)
        del trainer, engine
    if not rows_out[1]["vs_eager"]["bitwise"]:
        raise AssertionError(f"dispatch_epochs=2 differs from the per-epoch loop: "
                             f"{rows_out[1]['vs_eager']}")
    graph = rows_out[2]["vs_eager"]
    if ZOO_DEVICE == "cuda" and not rows_out[2]["graphs"]:
        raise AssertionError("unroll=True did not capture the windows")
    if graph["loss_rel_err"] > GRAPH_LOSS_RTOL or graph["max_param_err"] > GRAPH_PARAM_ATOL:
        raise AssertionError(f"the captured windows differ from eager: {graph}")
    losses = np.asarray(runs["eager"]["loss"])
    if not np.isfinite(losses).all():
        raise AssertionError(f"epochs phase: loss not finite: {losses.tolist()}")
    return runs["eager"], frame, x, y


def streaming_phase(seed: int, eager, frame):
    """The same configuration streamed, with no prefetch and through a
    prefetch ring of 2, against the in-memory run: the same trajectory
    within the epochs phase's gates.  The native gather must be built."""
    from distkeras_tpu_torch import native

    rows = []
    for prefetch in (0, 2):
        trainer = _cifar_trainer(seed, streaming=True, prefetch=prefetch)
        run = _trained(trainer, frame)
        steps = ZOO_EPOCHS * EPOCHS_WINDOWS * ZOO_WINDOW * ZOO_WORKERS
        row = dict(config=EPOCHS_CONFIG, streaming=True, prefetch=prefetch, loss=run["loss"],
                   seconds=run["seconds"], seconds_per_step=run["seconds"] / steps,
                   samples_per_s=ZOO_EPOCHS * len(frame) / run["seconds"],
                   native_available=native.available(),
                   last_stream_report=trainer.fit_result[0].last_stream_report,
                   vs_in_memory=_versus(run, eager))
        emit(phase="streaming", **row)
        rows.append(row)
        versus = row["vs_in_memory"]
        if versus["loss_rel_err"] > GRAPH_LOSS_RTOL or versus["max_param_err"] > GRAPH_PARAM_ATOL:
            raise AssertionError(f"streaming (prefetch {prefetch}) differs from the in-memory "
                                 f"run: {versus}")
    if not native.available():
        raise AssertionError("the native gather did not build: the numpy fallback ran")
    return rows


class _FailOnce:
    """``WindowedEngine.run_epoch`` raising once, on its ``at``-th call
    (1-based), while in the ``with`` block."""

    def __init__(self, at: int):
        self.at, self.calls = at, 0

    def __enter__(self):
        from distkeras_tpu_torch.parallel import WindowedEngine

        self.real = real = WindowedEngine.run_epoch

        def run_epoch(engine, *args, **kwargs):
            self.calls += 1
            if self.calls == self.at:
                raise RuntimeError("injected transient failure")
            return real(engine, *args, **kwargs)

        WindowedEngine.run_epoch = run_epoch
        return self

    def __exit__(self, *exc):
        from distkeras_tpu_torch.parallel import WindowedEngine

        WindowedEngine.run_epoch = self.real
        return False


def checkpoint_phase(seed: int, eager, frame):
    """Checkpoints on the card: 2 epochs with ``checkpoint_dir`` against 1
    epoch and a resume for 1 more (bitwise); a flipped byte in the newest
    step quarantines it and the resume falls back one step (bitwise again);
    ``train_with_recovery`` with one failure injected after epoch 1 ends
    where the uninterrupted run ends.  Prints the save's host-blocking ms
    and the files' bytes."""
    import json as json_mod
    import os
    import tempfile

    from distkeras_tpu_torch import checkpoint

    row = dict(config=EPOCHS_CONFIG)
    with tempfile.TemporaryDirectory() as root:
        whole = os.path.join(root, "whole")
        full = _trained(_cifar_trainer(seed, checkpoint_dir=whole), frame)
        row["with_checkpoints_vs_eager"] = _versus(full, eager)
        split = os.path.join(root, "split")
        _trained(_cifar_trainer(seed, checkpoint_dir=split, num_epoch=1), frame)
        resumed = _trained(_cifar_trainer(seed, checkpoint_dir=split, resume=True), frame)
        # a resumed run's history holds the epochs it ran: the second
        tail = dict(full, loss=full["loss"][1:])
        row["resume_vs_uninterrupted"] = _versus(resumed, tail)
        row["resumed_loss"] = resumed["loss"]

        # a flipped byte in the newest step: quarantined, and resume falls back
        victim = os.path.join(whole, "step_2", "center_params.npz")
        with open(victim, "rb") as fh:
            raw = bytearray(fh.read())
        raw[len(raw) // 2] ^= 0x01
        with open(victim + ".tmp", "wb") as fh:
            fh.write(bytes(raw))
        os.replace(victim + ".tmp", victim)
        fallback = _trained(_cifar_trainer(seed, checkpoint_dir=whole, resume=True), frame)
        row.update(quarantined="step_2.corrupt" in os.listdir(whole),
                   fallback_loss=fallback["loss"],
                   fallback_vs_uninterrupted=_versus(fallback, tail))

        # train_with_recovery with one transient failure in the second epoch
        # (it installs the SIGTERM-to-flag handler: put the old one back after)
        import signal

        from distkeras_tpu_torch import fleet

        recovering = _cifar_trainer(seed, checkpoint_dir=os.path.join(root, "recover"))
        sigterm = signal.getsignal(signal.SIGTERM)
        try:
            with _FailOnce(at=2) as failing:
                model = recovering.train_with_recovery(frame, backoff_base=0)
        finally:
            signal.signal(signal.SIGTERM, sigterm)
            fleet._HANDLER_INSTALLED = False
        if ZOO_DEVICE == "cuda":
            torch.cuda.synchronize()
        recovered = dict(loss=recovering.get_history()["loss"],
                         params={k: v.detach().float().cpu().clone()
                                 for k, v in model.params.items()})
        row.update(recovery_calls=failing.calls,
                   recovery_vs_uninterrupted=_versus(recovered, tail))

        # the save itself: host-blocking ms (the snapshot off the card) and
        # the files written
        engine, state, _ = recovering.fit_result
        target = os.path.join(root, "timed")
        t0 = time.perf_counter()
        checkpoint.save_checkpoint(target, state, 1)
        blocking = time.perf_counter() - t0
        checkpoint.wait_until_finished()
        total = time.perf_counter() - t0
        with open(checkpoint.manifest_path(target, 1)) as fh:
            files = json_mod.load(fh)["files"]
        row.update(save_host_blocking_ms=blocking * 1e3, save_total_ms=total * 1e3,
                   checkpoint_bytes=sum(f["bytes"] for f in files.values()),
                   checkpoint_files=sorted(files))
    emit(phase="checkpoint", **row)
    for key in ("resume_vs_uninterrupted", "fallback_vs_uninterrupted",
                "recovery_vs_uninterrupted"):
        if not row[key]["bitwise"]:
            raise AssertionError(f"checkpoint phase: {key} is not bitwise: {row[key]}")
    if not row["quarantined"]:
        raise AssertionError("the damaged step was not quarantined")
    if row["fallback_loss"] != full["loss"][1:] or row["recovery_calls"] < 3:
        raise AssertionError(f"checkpoint phase: fallback or recovery did not rerun: {row}")
    return row


def replay_masks(engine) -> dict:
    """Replays of a captured window draw fresh dropout masks.  The engine's
    first captured window is replayed three times from the same state
    values and inputs: the second replay must differ from the first (each
    replay advances the workers' registered generators), and the third,
    with the generators put back as well, must give the first again bit
    for bit.  The state and the generators are left as they were found."""
    from distkeras_tpu_torch.parallel.engine import _state_trees
    from distkeras_tpu_torch.utils.pytree import tree_leaves

    captured = next(iter(engine._graphs.values()))
    static = engine._static
    leaves = tree_leaves(_state_trees(static))
    values = [t.clone() for t in leaves]
    rng = [g.get_state() for g in static.rng]

    def put_back(generators: bool):
        with torch.no_grad():
            for t, v in zip(leaves, values):
                t.copy_(v)
        if generators:
            for g, s in zip(static.rng, rng):
                g.set_state(s)

    def replay(generators: bool):
        put_back(generators)
        captured.graph.replay()
        torch.cuda.synchronize()
        return [t.clone() for t in tree_leaves(static.local_params)]

    first, second, third = replay(True), replay(False), replay(True)
    put_back(True)
    fresh = any(not torch.equal(a, b) for a, b in zip(first, second))
    repeatable = all(torch.equal(a, b) for a, b in zip(first, third))
    return dict(fresh_masks_each_replay=fresh, replay_repeatable=repeatable)


def remat_graph_phase(seed: int, train_run):
    """The attention path under ``remat`` and in captured windows, through
    the trainer: the train phase's ``DOWNPOUR`` over a GPT-2-small-wide LM
    with dropout ``REMAT_DROPOUT``, trained eagerly, with ``remat=True`` and
    with ``unroll=True`` from the same seeds.  Remat and the graph are each
    held to the eager run within the epochs phase's gates (loss 1e-6
    relative, center parameters 1e-5): remat's recomputation and the
    graph's replays must draw the eager run's masks.  Remat launches the
    forward kernel (B1) twice as often as eager and B2/B3 as often; the
    graph run launches B1-B3 inside its windows; peak memory is printed for
    all three.  Two replays of a window from the same state must draw
    different masks (:func:`replay_masks`), and the eager run must differ
    from the train phase's run without dropout (``train_run``)."""
    import distkeras_tpu_torch as tdk
    from distkeras_tpu_torch.models import TransformerLM
    from distkeras_tpu_torch.ops import (
        flash_attention,
        flash_attention_bwd_dkv,
        flash_attention_bwd_dq,
    )

    counters = (flash_attention, flash_attention_bwd_dq, flash_attention_bwd_dkv)
    x, y = lm_task(TRAIN_ROWS, REMAT_MODEL["max_len"], REMAT_MODEL["vocab_size"], seed + 2)
    frame = tdk.from_numpy(x, y)

    def train(**kwargs):
        model = TransformerLM(**REMAT_MODEL, dropout=REMAT_DROPOUT,
                              generator=torch.Generator().manual_seed(seed + 2))
        trainer = _keeping_fit(tdk.DOWNPOUR)(
            model, loss="token_crossentropy", metrics=("token_accuracy",),
            worker_optimizer=("adam", {"learning_rate": 2e-4}), num_workers=TRAIN_WORKERS,
            batch_size=TRAIN_BATCH, communication_window=TRAIN_WINDOW, num_epoch=TRAIN_EPOCHS,
            seed=seed, device=ZOO_DEVICE, **kwargs)
        if ZOO_DEVICE == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        for c in counters:
            c.launches = 0
        run = _trained(trainer, frame)
        run.update(launches=[c.launches for c in counters],
                   peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
        return trainer, run

    trainer, eager = train()
    del trainer
    trainer, remat = train(remat=True)
    del trainer
    trainer, graph = train(unroll=True)
    engine = trainer.fit_result[0]
    ticks_and_launches = engine.graph_launches()
    # a wrapper's counter ticks at the warm-up window (real launches) and at
    # capture (none); the graph's launches are its capture ticks x replays
    graph_launches = [c.launches - ticks_and_launches.get(c.__name__, (0, 0))[0]
                      + ticks_and_launches.get(c.__name__, (0, 0))[1] for c in counters]
    replays = replay_masks(engine) if engine.use_graphs else {}
    graph_stats, use_graphs = dict(engine.graph_stats), engine.use_graphs
    del trainer, engine

    local_steps = TRAIN_EPOCHS * (TRAIN_ROWS // (TRAIN_WORKERS * TRAIN_BATCH)) * TRAIN_WORKERS
    expected = REMAT_MODEL["num_layers"] * local_steps
    window_launches = REMAT_MODEL["num_layers"] * TRAIN_WORKERS * TRAIN_WINDOW
    row = dict(trainer="DOWNPOUR", model="TransformerLM", **REMAT_MODEL, dropout=REMAT_DROPOUT,
               workers=TRAIN_WORKERS, batch_size=TRAIN_BATCH, window=TRAIN_WINDOW,
               epochs=TRAIN_EPOCHS, rows=TRAIN_ROWS, local_steps=local_steps,
               loss=eager["loss"], remat_loss=remat["loss"], graph_loss=graph["loss"],
               seconds=eager["seconds"], remat_seconds=remat["seconds"],
               graph_seconds=graph["seconds"],
               dropout_changed_loss=eager["loss"] != train_run["loss"],
               remat_vs_eager=_versus(remat, eager), graph_vs_eager=_versus(graph, eager),
               launches_eager=eager["launches"], launches_remat=remat["launches"],
               expected_launches_eager=expected,
               peak_memory_gb_eager=eager["peak_memory_gb"],
               peak_memory_gb_remat=remat["peak_memory_gb"],
               peak_memory_gb_graph=graph["peak_memory_gb"],
               remat_lowered_peak_memory=remat["peak_memory_gb"] < eager["peak_memory_gb"],
               graph_stats=graph_stats, graphs=use_graphs,
               graph_ticks_and_launches=ticks_and_launches, launches_graph=graph_launches,
               expected_launches_graph=expected + window_launches,  # + the warm-up window
               launches_counted_as="wrapper counter - capture ticks + capture ticks x replays",
               **replays)
    failures = []
    if not row["dropout_changed_loss"]:
        failures.append("the loss with dropout equals the train phase's without: no mask drawn")
    for mode in ("remat", "graph"):
        versus = row[f"{mode}_vs_eager"]
        if versus["loss_rel_err"] > GRAPH_LOSS_RTOL or versus["max_param_err"] > GRAPH_PARAM_ATOL:
            failures.append(f"{mode} differs from eager with dropout: {versus}")
    if ZOO_DEVICE == "cuda":
        if eager["launches"] != [expected] * 3:
            failures.append(f"eager launched {eager['launches']}, expected {expected} each")
        if remat["launches"] != [2 * expected, expected, expected]:
            failures.append(f"remat launched {remat['launches']}, expected "
                            f"{[2 * expected, expected, expected]} (B1 twice)")
        if not use_graphs or graph_launches != [expected + window_launches] * 3:
            failures.append(f"graph launches {graph_launches}, expected "
                            f"{expected + window_launches} each")
        if not (replays["fresh_masks_each_replay"] and replays["replay_repeatable"]):
            failures.append(f"replays of a captured window: {replays}")
    row["failures"] = failures
    emit(phase="remat_graph", **row)
    if failures:
        raise AssertionError(f"remat/graph phase: {failures}")
    return row


# serving phase: KV-cache decode and the serving engine at GPT-2-small widths
SERVE_MODEL = GPT2_SMALL
SERVE_DRAFT = dict(vocab_size=50257, dim=256, heads=4, num_layers=2, max_len=1024)
SERVE_GREEDY = (4, 128, 64)  # greedy_generate: batch, prompt length, steps
SERVE_SLOTS, SERVE_PAGE = 8, 16
SERVE_REQUESTS = 24
SERVE_PROMPT_LEN = (16, 768)  # drawn from --seed, inclusive
SERVE_NEW_TOKENS = (32, 128)
SERVE_STAGGER_S = 0.02  # between submissions
SERVE_SAMPLING = dict(temperature=0.9, top_k=50, top_p=0.95)
SERVE_SPEC_TOKENS = 4
SERVE_SPEC_PROMPTS = 4  # greedy requests of the traffic run through the speculative engines
SERVE_PREDICT = (16, 64, 16)  # ModelPredictor(engine=): rows, prompt length, new tokens
SERVE_PROFILE = (64, 64)  # profiled decode: prompt length, new tokens, one request a slot
# A greedy token may differ from its reference only where the reference's
# two best logits are closer than this (f32, the orders of summation differ).
GREEDY_GAP = 1e-4


def _top_two_gap(logits) -> float:
    top = torch.topk(logits.float(), 2).values
    return float(top[0] - top[1])


def _held_to_greedy(trained, prompt, tokens, ref):
    """Where ``tokens`` first departs from the greedy reference ``ref`` (both
    continuations of ``prompt``): None if it never does, else ``(position,
    the reference's top-two gap there)`` from a full-context forward over
    the shared prefix.  Raises if that gap is not below ``GREEDY_GAP``."""
    n = min(len(tokens), len(ref))
    diff = next((j for j in range(n) if tokens[j] != ref[j]), None)
    if diff is None:
        if len(tokens) != len(ref):
            raise AssertionError(f"{len(tokens)} tokens against {len(ref)} in the reference")
        return None
    context = np.asarray([list(prompt) + list(ref[:diff])], np.int32)
    gap = _top_two_gap(trained(context)[0, -1])
    if not gap < GREEDY_GAP:
        raise AssertionError(f"token {diff} differs from greedy ({tokens[diff]} against "
                             f"{ref[diff]}) where the reference's top-two gap is {gap}")
    return diff, gap


def _hist_delta(after: dict, before: dict) -> dict:
    """A histogram snapshot less an earlier one of the same instrument."""
    if not before:
        return after
    return dict(type="histogram", sum=after["sum"] - before["sum"],
                count=after["count"] - before["count"],
                buckets={le: n - before["buckets"].get(le, 0)
                         for le, n in after["buckets"].items()})


def _hist_quantile(payload: dict, q: float):
    """The upper bound of the bucket holding the ``q`` quantile of a
    histogram snapshot (cumulative ``le`` counts), in ms; None when empty."""
    if not payload["count"]:
        return None
    rank = q * payload["count"]
    for le, n in payload["buckets"].items():
        if n >= rank:
            return float("inf") if le == "+Inf" else float(le) * 1e3
    return float("inf")


def _serving_engine(trained, registry, **kwargs):
    """A ``ServingEngine`` at the phase's geometry whose prefill times (by
    bucket width) and peak page count are recorded for the summary."""
    from distkeras_tpu_torch.serving import ServingEngine

    engine = ServingEngine(trained, num_slots=SERVE_SLOTS, page_size=SERVE_PAGE,
                           registry=registry, device=ZOO_DEVICE, **kwargs)
    prefill_into, alloc = engine._prefill_into, engine._cache.alloc
    engine.prefill_ms, engine.peak_pages = {}, 0

    def timed_prefill(slot, pending, need):
        width = next(w for w in engine.prefill_buckets if w >= len(pending.request.prompt))
        t0 = time.perf_counter()
        prefill_into(slot, pending, need)  # ends on the first token's copy to the host
        engine.prefill_ms.setdefault(width, []).append((time.perf_counter() - t0) * 1e3)

    def counted_alloc(slot, n):
        alloc(slot, n)
        engine.peak_pages = max(engine.peak_pages, engine._cache.pages_in_use)

    engine._prefill_into, engine._cache.alloc = timed_prefill, counted_alloc
    return engine


def serving_phase(seed: int):
    """KV-cache decode and the serving engine through their entry points at
    GPT-2-small widths (random weights from ``--seed``, f32):

    1. ``greedy_generate`` over a ``TrainedModel`` (batch 4, 128-token
       prompts, 64 steps), each token held against the argmax of one
       full-context forward over the prompt and the tokens so far (which
       runs B1: its launches are counted); a token may differ only where
       that forward's top-two gap is below ``GREEDY_GAP``;
    2. ``ServingEngine`` (8 slots, pages of 16, buckets 16 to 1024): 24
       staggered requests, prompts of 16-768 tokens and 32-128 new ones
       drawn from ``--seed``; the greedy half held to ``greedy_generate``
       under the same gap rule, the sampled half (each its own seed) to
       itself rerun alone, exactly; one request retires on EOS; a drained
       engine's full queue refuses one more (``QueueFull``); every page
       comes back;
    3. speculative decoding (a 2-layer, 256-wide draft; 4 tokens a window),
       one request at a time, held to plain greedy, and the target as its
       own draft accepting every proposal, in fewer decode steps than the
       tokens they emitted (a draft that is never right takes one step a
       token);
    4. ``ModelPredictor(engine=)`` over 16 prompts, held row by row to
       ``engine.generate``, exactly.

    Prints TTFT and decode-step latency quantiles from the engine's
    histograms, the traffic run's generated tokens over its wall (prefills
    and the stagger included) and its decode tokens over the summed
    decode-step wall, decode-step ms, device operations and the card's busy
    share under ``torch.profiler``, prefill ms per bucket width, peak pages
    and memory, and B1's launches (0 on the serving path, which runs the
    reference's plain masked attention)."""
    import distkeras_tpu_torch as tdk
    from distkeras_tpu_torch.models import TorchModel, TrainedModel, TransformerLM, greedy_generate
    from distkeras_tpu_torch.ops import (
        flash_attention,
        flash_attention_bwd_dkv,
        flash_attention_bwd_dq,
    )
    from distkeras_tpu_torch.serving import GenerateRequest, QueueFull
    from distkeras_tpu_torch.telemetry.metrics import Registry

    cuda = ZOO_DEVICE == "cuda"
    vocab = SERVE_MODEL["vocab_size"]
    model = TransformerLM(**SERVE_MODEL, generator=torch.Generator().manual_seed(seed + 7))
    trained = TrainedModel(TorchModel(model), {k: v.detach() for k, v in model.named_parameters()},
                           device=ZOO_DEVICE)
    rng = np.random.default_rng(seed + 7)
    out = {}

    # 1. greedy_generate against full-context forwards
    batch, plen, steps = SERVE_GREEDY
    prompt = rng.integers(0, vocab, (batch, plen), dtype=np.int32)
    greedy_generate(trained, prompt[:, :16], 4)  # warm-up
    flash_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    generated = greedy_generate(trained, prompt, steps)
    greedy_s = time.perf_counter() - t0
    greedy_launches = flash_attention.launches
    flash_attention.launches = 0
    with torch.inference_mode():
        ref_logits = trained(generated[:, :-1])[:, plen - 1:]
    check_launches = flash_attention.launches
    ref_tokens = ref_logits.argmax(-1).cpu().numpy()
    departures = []
    for row in range(batch):
        for j in np.nonzero(ref_tokens[row] != generated[row, plen:])[0]:
            gap = _top_two_gap(ref_logits[row, j])
            departures.append(dict(row=row, position=int(j), gap=gap))
            if not gap < GREEDY_GAP:
                raise AssertionError(f"greedy_generate row {row} token {j} is not the "
                                     f"full-context argmax (top-two gap {gap})")
    out["greedy"] = dict(batch=batch, prompt=plen, steps=steps, seconds=greedy_s,
                         ms_per_step=greedy_s / steps * 1e3,
                         tokens_per_s=batch * steps / greedy_s, departures=departures,
                         launches_b1=greedy_launches, launches_b1_check=check_launches)
    if greedy_launches != 0 or check_launches != (SERVE_MODEL["num_layers"] if cuda else 0):
        raise AssertionError(f"B1 launches: {greedy_launches} in greedy_generate (want 0), "
                             f"{check_launches} in the check's forward")
    del ref_logits

    # 2. the engine under staggered traffic
    lengths = rng.integers(SERVE_PROMPT_LEN[0], SERVE_PROMPT_LEN[1] + 1, SERVE_REQUESTS)
    new = rng.integers(SERVE_NEW_TOKENS[0], SERVE_NEW_TOKENS[1] + 1, SERVE_REQUESTS)
    prompts = [rng.integers(0, vocab, int(n)).tolist() for n in lengths]
    greedy = [i for i in range(SERVE_REQUESTS) if i % 2 == 0]
    refs = {i: greedy_generate(trained, np.asarray([prompts[i]], np.int32),
                               int(new[i]))[0, lengths[i]:].tolist() for i in greedy}
    eos_request = greedy[0]
    eos_id = refs[eos_request][3]
    requests = []
    for i in range(SERVE_REQUESTS):
        knobs = {} if i in refs else dict(SERVE_SAMPLING, seed=1000 + i)
        if i == eos_request:
            knobs["eos_id"] = eos_id
        requests.append(GenerateRequest(prompt=prompts[i], max_new_tokens=int(new[i]),
                                        **knobs))
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    registry = Registry()
    engine = _serving_engine(trained, registry, queue_size=SERVE_REQUESTS + 8)
    try:
        engine.generate(prompts[1][:16], max_new_tokens=4, timeout=600)  # warm-up
        before = registry.snapshot()
        counters = (flash_attention, flash_attention_bwd_dq, flash_attention_bwd_dkv)
        for counter in counters:
            counter.launches = 0
        t0 = time.perf_counter()
        pendings = []
        for req in requests:
            pendings.append(engine.submit(req))
            time.sleep(SERVE_STAGGER_S)
        results = [p.result(timeout=600) for p in pendings]
        wall = time.perf_counter() - t0
        serve_launches = [counter.launches for counter in counters]
        after = registry.snapshot()
        if any(r is None or r.finish_reason == "aborted" for r in results) or not engine.alive:
            raise AssertionError(f"the engine failed: {engine.error!r}")
        greedy_departures = []
        for i in greedy:
            tokens, ref = results[i].tokens, refs[i]
            if i == eos_request:
                ref = ref[:ref.index(eos_id) + 1]
            hit = _held_to_greedy(trained, prompts[i], tokens, ref)
            if hit is not None:
                greedy_departures.append(dict(request=i, position=hit[0], gap=hit[1]))
            elif i == eos_request and results[i].finish_reason != "eos":
                raise AssertionError(f"the EOS request finished on {results[i].finish_reason}")
        reruns = {i: engine.generate(prompts[i], max_new_tokens=int(new[i]), timeout=600,
                                     **SERVE_SAMPLING, seed=1000 + i).tokens
                  for i in range(SERVE_REQUESTS) if i not in refs}
        mismatched = [i for i, tokens in reruns.items() if tokens != results[i].tokens]
        if mismatched:
            raise AssertionError(f"sampled requests {mismatched} gave other tokens alone")
        k = min(reruns)
        other_seed = engine.generate(prompts[k], max_new_tokens=int(new[k]), timeout=600,
                                     **SERVE_SAMPLING, seed=1000 + k + SERVE_REQUESTS).tokens
        if other_seed == results[k].tokens:
            raise AssertionError("another seed gave the same sampled tokens")

        # a drained engine queues but does not admit: one past the queue is refused
        engine.drain(timeout=60)
        held = [engine.submit(GenerateRequest(prompt=prompts[0][:16], max_new_tokens=1))
                for _ in range(engine._queue.maxsize)]
        try:
            engine.submit(GenerateRequest(prompt=prompts[0][:16], max_new_tokens=1))
            raise AssertionError("a full queue took one more request")
        except QueueFull:
            pass
        engine.resume()
        if any(p.result(timeout=600).finish_reason != "length" for p in held):
            raise AssertionError("queued requests did not finish after resume")
        rejected = registry.snapshot()["serving_requests_rejected_total"]["value"]

        # the decode step under torch.profiler: one request a slot, admitted
        # together (queued while drained), short prompts
        profile_prompts = [rng.integers(0, vocab, SERVE_PROFILE[0]).tolist()
                           for _ in range(SERVE_SLOTS)]
        run_steps = []

        def run():
            steps_before = engine._metrics["decode_steps"].value
            engine.drain(timeout=60)
            batch = [engine.submit(GenerateRequest(prompt=p, max_new_tokens=SERVE_PROFILE[1]))
                     for p in profile_prompts]
            engine.resume()
            for p in batch:
                p.result(timeout=600)
            run_steps.append(engine._metrics["decode_steps"].value - steps_before)

        # the CPU has no device time to split: a rehearsal runs it unprofiled
        profile = fwd_bwd_profile(run, iters=1) if cuda else run() or {}
        profiled_steps = run_steps[-1]

        # 4. ModelPredictor(engine=) row by row against engine.generate
        rows, prow, pnew = SERVE_PREDICT
        frame = tdk.from_numpy(rng.integers(0, vocab, (rows, prow), dtype=np.int32))
        predictor = tdk.ModelPredictor(engine=engine, max_new_tokens=pnew)
        column = predictor.predict(frame)["prediction"]
        single = [engine.generate(row.tolist(), max_new_tokens=pnew, timeout=600).tokens
                  for row in frame["features"]]
        if predictor.last_mode != "engine" or [list(c) for c in column] != single:
            raise AssertionError("ModelPredictor(engine=) differs from engine.generate")
        time.sleep(0.05)
        pages_after = engine.stats()["pages_in_use"]
        if pages_after != 0:
            raise AssertionError(f"{pages_after} pages still in use after the traffic")
    finally:
        engine.stop()
    peak_memory = torch.cuda.max_memory_allocated() if cuda else None

    ttft = _hist_delta(after["serving_ttft_seconds"], before.get("serving_ttft_seconds", {}))
    itl = _hist_delta(after["serving_token_latency_seconds"],
                      before.get("serving_token_latency_seconds", {}))
    tokens = sum(len(r.tokens) for r in results)
    ttfts = sorted(r.ttft_s * 1e3 for r in results)
    out["engine"] = dict(
        slots=SERVE_SLOTS, page_size=SERVE_PAGE, buckets=list(engine.prefill_buckets),
        requests=SERVE_REQUESTS, prompt_tokens=int(lengths.sum()), tokens=tokens,
        seconds=wall, generated_tokens_per_s=tokens / wall,
        # each request's first token comes from its prefill, the rest from
        # decode steps, whose walls the step histogram sums
        decode_tokens_per_s=(tokens - SERVE_REQUESTS) / itl["sum"] if itl["sum"] else None,
        ttft_ms_p50=_hist_quantile(ttft, 0.5), ttft_ms_p99=_hist_quantile(ttft, 0.99),
        ttft_ms_exact_p50=float(np.percentile(ttfts, 50)),
        ttft_ms_exact_p99=float(np.percentile(ttfts, 99)),
        step_ms_p50=_hist_quantile(itl, 0.5), step_ms_p99=_hist_quantile(itl, 0.99),
        step_ms_mean=itl["sum"] / max(itl["count"], 1) * 1e3, decode_steps=itl["count"],
        prefill_ms={w: dict(n=len(v), mean=float(np.mean(v)), min=float(np.min(v)))
                    for w, v in sorted(engine.prefill_ms.items())},
        peak_pages=engine.peak_pages, pages_total=engine._cache.num_pages - 1,
        pages_after=pages_after, peak_memory_bytes=peak_memory,
        launches_b1=serve_launches[0], launches_b2_b3=serve_launches[1:],
        greedy_departures=greedy_departures,
        eos_finish=results[eos_request].finish_reason, sampled_rerun_equal=True,
        other_seed_differs=True, queue_full_rejected=rejected,
        predictor_rows=rows, predictor_equal=True,
        profiled_decode=dict(slots=SERVE_SLOTS, steps=profiled_steps,
                             # the run's wall over its decode steps (8 prefills in it)
                             wall_ms_per_step=(profile.get("wall_ms_per_call", 0.0)
                                               / max(profiled_steps, 1)),
                             device_ms_per_step=(profile["device_ms_per_call"]
                                                 / max(profiled_steps, 1)
                                                 if profile.get("device_ms_per_call") else None),
                             device_busy_share=profile.get("device_busy_share"),
                             # every device operation of the run (kernels and
                             # copies, the 8 prefills' included) and a step's share
                             device_ops=profile.get("kernels_per_call"),
                             device_ops_per_step=(profile["kernels_per_call"]
                                                  / max(profiled_steps, 1)
                                                  if profile.get("kernels_per_call") else None),
                             top_kernels=profile.get("top_kernels")))
    if serve_launches != [0, 0, 0]:
        raise AssertionError(f"B1-B3 launched {serve_launches} times on the serving path")

    # 3. speculative decoding: a shallow draft, and the target as its own,
    # one request in flight at a time, so that decode steps count per token
    draft = TransformerLM(**SERVE_DRAFT, generator=torch.Generator().manual_seed(seed + 8))
    draft_params = {k: v.detach() for k, v in draft.named_parameters()}
    spec_rows = {}
    for name, kwargs in (("draft", dict(draft_model=draft, draft_params=draft_params)),
                         ("faithful", dict(draft_model=trained))):
        registry = Registry()
        engine = _serving_engine(trained, registry, spec_tokens=SERVE_SPEC_TOKENS, **kwargs)
        try:
            t0 = time.perf_counter()
            results = [engine.submit(requests[i]).result(timeout=600)
                       for i in greedy[1:1 + SERVE_SPEC_PROMPTS]]
            seconds = time.perf_counter() - t0
        finally:
            engine.stop()
        departures = []
        for i, result in zip(greedy[1:1 + SERVE_SPEC_PROMPTS], results):
            hit = _held_to_greedy(trained, prompts[i], result.tokens, refs[i])
            if hit is not None:
                departures.append(dict(request=i, position=hit[0], gap=hit[1]))
        snap = {k[len("serving_"):]: v["value"] for k, v in registry.snapshot().items()
                if v["type"] == "counter"}
        spec_rows[name] = dict(
            requests=len(results), tokens=snap["tokens_total"], seconds=seconds,
            tokens_per_s=snap["tokens_total"] / seconds,
            decode_steps=snap["decode_steps_total"], proposed=snap["spec_proposed_total"],
            accepted=snap["spec_accepted_total"],
            # a request's first token is its prefill's: the steps emit the rest
            steps_per_decode_token=(snap["decode_steps_total"]
                                    / max(snap["tokens_total"] - len(results), 1)),
            accept_rate=snap["spec_accepted_total"] / max(snap["spec_proposed_total"], 1),
            departures=departures)
    faithful = spec_rows["faithful"]
    if (faithful["accepted"] != faithful["proposed"]
            or not faithful["steps_per_decode_token"] < 1):
        raise AssertionError(f"the target as its own draft: {faithful}")
    out["speculative"] = dict(spec_tokens=SERVE_SPEC_TOKENS, draft_model=SERVE_DRAFT, **spec_rows)

    for case, row in out.items():
        emit(phase="serving", case=case, model="TransformerLM", **SERVE_MODEL, **row)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0, help="seed for weights and inputs")
    args = parser.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2

    from distkeras_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit(phase="precision", matmul_allow_tf32=False, cudnn_allow_tf32=False)

    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    emit(phase="device", kind=kind, count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    _build.build_all()
    emit(phase="build", kernels=["flash_attention_fwd", "flash_attention_bwd"],
         seconds=time.perf_counter() - t0)
    resources = kernel_resources()
    for row in resources:
        emit(phase="resources", **row)
    for kernel in ("flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel"):
        found = [r for r in resources if r["kernel"] == kernel]
        if len(found) != 3 * 5:  # float32, bfloat16 and float16, head dims 16 to 256
            raise AssertionError(f"{kernel}: {len(found)} instantiations in the SASS, expected 15")
    no_tensor_cores = [r for r in resources if not r["hmma"]]
    if no_tensor_cores:
        raise AssertionError(f"kernels without tensor-core instructions: {no_tensor_cores}")

    cases = kernel_phase(args.seed)
    bwd_cases = bwd_kernel_phase(args.seed)
    predictor_launches = predictor_phase(args.seed)
    lm_launches = lm_phase(args.seed)
    train_launches, train_run = train_phase(args.seed)
    zoo_phase(args.seed)
    staleness_phase(args.seed)
    flow_phase(args.seed)
    head_dim_rows = head_dim_phase(args.seed)
    networking_phase(args.seed)
    eager_run, cifar_frame, _, _ = epochs_phase(args.seed)
    streaming_phase(args.seed, eager_run, cifar_frame)
    checkpoint_phase(args.seed, eager_run, cifar_frame)
    remat_graph = remat_graph_phase(args.seed, train_run)
    serving = serving_phase(args.seed)

    main_case = cases[MAIN_PATH_CASE]
    lm_case = cases["lm"]
    lm_bf16 = cases["lm_bf16"]
    bwd = bwd_cases[BWD_MAIN_PATH_CASE]
    bwd_bf16 = bwd_cases["train_bf16"]
    from distkeras_tpu_torch.ops.flash_attention import kernel_head_dim

    def coverage(kind):
        """The head-dim and f16 rows of one kernel: its time (the wrapper's,
        the padding copy included), the padding copy's alone, the plain
        version's, SDPA's and the bound on the true head dim."""
        out = []
        for fwd_case, bwd_case in COVERAGE_CASES:
            row = cases[fwd_case] if kind == "fwd" else bwd_cases[bwd_case]
            prefix = "" if kind == "fwd" else f"{kind}_"
            d = row["shape"][3]
            entry = dict(case=row["case"], shape=row["shape"], dtype=row["dtype"],
                         causal=row["causal"], head_dim=d, built_head_dim=kernel_head_dim(d),
                         plain_ms=row["plain_ms"], library_ms=row["library_ms"],
                         bound_ms=row[f"{prefix}bound_ms"], bound_by=row[f"{prefix}bound_by"],
                         pad_ms=row.get("pad_ms"))
            if kind == "fwd":
                entry.update(ms=row["kernel_ms"], max_abs_err=row["max_abs_err_o"])
            else:
                entry.update(ms=row[f"{kind}_ms"], deterministic=row["deterministic"],
                             max_abs_err=(row["max_abs_err_dq"] if kind == "dq" else
                                          max(row["max_abs_err_dk"], row["max_abs_err_dv"])))
            out.append(entry)
        return out

    bwd_entry = dict(route="cuda", source="distkeras_tpu_torch/csrc/flash_attention_bwd.cu",
                     plain_ms=bwd["plain_ms"], library_ms=bwd["library_ms"],
                     shape=bwd["shape"], causal=True, deterministic=bwd["deterministic"],
                     plain_and_library_cover="dQ, dK and dV together")
    print(json.dumps({"kernels": [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "distkeras_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "distkeras_tpu/ops/pallas/flash_attention.py:114",
        "launches": predictor_launches,
        "launches_lm": lm_launches,
        "max_abs_err": main_case["max_abs_err_o"],
        "ms": main_case["kernel_ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "bound_tc_ms": main_case["bound_tc_ms"],
        "library_ms": main_case["library_ms"],
        "shape": main_case["shape"],
        "launches_training": train_launches["flash_attention_fwd"],
        "training_shape": lm_case["shape"],
        "training_ms": lm_case["kernel_ms"],
        "training_plain_ms": lm_case["plain_ms"],
        "training_library_ms": lm_case["library_ms"],
        "training_bound_ms": lm_case["bound_ms"],
        "training_bound_tc_ms": lm_case["bound_tc_ms"],
        "deterministic": lm_case["deterministic"],
        "training_bf16_ms": lm_bf16["kernel_ms"],
        "training_bf16_library_ms": lm_bf16["library_ms"],
        "training_bf16_bound_ms": lm_bf16["bound_ms"],
        "training_bf16_bound_by": lm_bf16["bound_by"],
        "launches_head_dim_models": {name: row["launches"]
                                     for name, row in head_dim_rows.items()},
        "launches_train_eager_and_remat": [remat_graph["launches_eager"][0],
                                           remat_graph["launches_remat"][0]],
        "launches_graph": remat_graph["launches_graph"][0],
        "launches_serving": serving["engine"]["launches_b1"],
        "launches_greedy_generate": serving["greedy"]["launches_b1"],
        "launches_greedy_check": serving["greedy"]["launches_b1_check"],
        "head_dims_and_f16": coverage("fwd"),
    }, {
        "name": "flash_attention_bwd_dq",
        "replaces": "distkeras_tpu/ops/pallas/flash_attention.py:247",
        "launches": train_launches["flash_attention_bwd_dq"],
        "launches_train_eager_and_remat": [remat_graph["launches_eager"][1],
                                           remat_graph["launches_remat"][1]],
        "launches_graph": remat_graph["launches_graph"][1],
        "max_abs_err": bwd["max_abs_err_dq"],
        "ms": bwd["dq_ms"],
        "bound_ms": bwd["dq_bound_ms"],
        "bound_by": bwd["dq_bound_by"],
        "bound_tc_ms": bwd["dq_bound_tc_ms"],
        "bf16_ms": bwd_bf16["dq_ms"],
        "bf16_bound_ms": bwd_bf16["dq_bound_ms"],
        "head_dims_and_f16": coverage("dq"),
        **bwd_entry,
    }, {
        "name": "flash_attention_bwd_dkv",
        "replaces": "distkeras_tpu/ops/pallas/flash_attention.py:264",
        "launches": train_launches["flash_attention_bwd_dkv"],
        "launches_train_eager_and_remat": [remat_graph["launches_eager"][2],
                                           remat_graph["launches_remat"][2]],
        "launches_graph": remat_graph["launches_graph"][2],
        "max_abs_err": max(bwd["max_abs_err_dk"], bwd["max_abs_err_dv"]),
        "ms": bwd["dkv_ms"],
        "bound_ms": bwd["dkv_bound_ms"],
        "bound_by": bwd["dkv_bound_by"],
        "bound_tc_ms": bwd["dkv_bound_tc_ms"],
        "bf16_ms": bwd_bf16["dkv_ms"],
        "bf16_bound_ms": bwd_bf16["dkv_bound_ms"],
        "head_dims_and_f16": coverage("dkv"),
        **bwd_entry,
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
