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
   kernels must have them;
3. kernels: each kernel against its plain PyTorch version on the card,
   with its time, the plain version's, one library call's and the bound:
   the forward (B1, also at lq != lk and on misaligned inputs that the
   wrapper copies) and the backward's dQ (B2) and dK/dV (B3) kernels,
   whose f32 rows give two bounds (the CUDA cores' f32 rate and the
   tensor cores' 3xTF32 rate); the forward on the LM shape and the
   backward kernels on the training shape run twice and must agree bit
   for bit;
4. ``ModelPredictor`` over a ``TransformerClassifier`` at GPT-2-small widths
   (768 wide, 12 heads, 12 layers, 1024 positions, 50257 tokens), weights
   drawn from ``--seed``: 64 rows of 1024 tokens in batches of 16;
5. a causal ``TransformerLM`` forward through ``TrainedModel`` at the same
   widths on ``[4, 1024]`` tokens;
6. training: ``DOWNPOUR`` over the same ``TransformerLM`` (depth not cut),
   2 workers, batch 4, window 2, Adam, 2 epochs over 32 rows of 1024 tokens
   of the ``(token + 1) mod vocab`` task, then one training step at
   ``[1, 1024]`` held against the same step on the CPU.

Phases 4 to 6 set the kernels' launch counts to 0 just before and read them
just after, check that every kernel of the path ran as often as the model
needs, and hold the output against the same model on the CPU.  The last
lines are a ``{"kernels": [...]}`` summary, the nvidia-smi line and
``{"ok": true, "device": {...}}``.  Any failed check raises, so the script
exits non-zero without the ``ok`` line; so does a machine without CUDA.
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
# bf16: both compute in f32, but O is rounded to bf16 at the end (LSE stays f32).
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
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
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
]
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

    name_re = re.compile(r"(flash_(?:fwd|bwd_dq|bwd_dkv)_kernel)I(f|13__nv_bfloat16)Li(\d+)E")
    frame_re = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads")
    cuobjdump = Path(_build.nvcc_path()).parent / "cuobjdump"
    cuobjdump = str(cuobjdump) if cuobjdump.is_file() else shutil.which("cuobjdump")
    if cuobjdump is None:
        raise RuntimeError("cuobjdump not found beside nvcc or on PATH")
    rows = {}

    def row_of(match):
        kernel, dtype, head_dim = match.group(1), match.group(2), int(match.group(3))
        dtype = "float32" if dtype == "f" else "bfloat16"
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
        if dtype == torch.bfloat16:
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
        tol = BWD_BF16 if dtype == torch.bfloat16 else BWD_F32
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
        if name == BWD_MAIN_PATH_CASE:  # no atomics: a second run agrees bit for bit
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
    return launches


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
        if len(found) != 2 * 4:  # float32 and bfloat16, head dims 16 to 128
            raise AssertionError(f"{kernel}: {len(found)} instantiations in the SASS, expected 8")
    no_tensor_cores = [r for r in resources if not r["hmma"]]
    if no_tensor_cores:
        raise AssertionError(f"kernels without tensor-core instructions: {no_tensor_cores}")

    cases = kernel_phase(args.seed)
    bwd_cases = bwd_kernel_phase(args.seed)
    predictor_launches = predictor_phase(args.seed)
    lm_launches = lm_phase(args.seed)
    train_launches = train_phase(args.seed)

    main_case = cases[MAIN_PATH_CASE]
    lm_case = cases["lm"]
    lm_bf16 = cases["lm_bf16"]
    bwd = bwd_cases[BWD_MAIN_PATH_CASE]
    bwd_bf16 = bwd_cases["train_bf16"]
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
    }, {
        "name": "flash_attention_bwd_dq",
        "replaces": "distkeras_tpu/ops/pallas/flash_attention.py:247",
        "launches": train_launches["flash_attention_bwd_dq"],
        "max_abs_err": bwd["max_abs_err_dq"],
        "ms": bwd["dq_ms"],
        "bound_ms": bwd["dq_bound_ms"],
        "bound_by": bwd["dq_bound_by"],
        "bound_tc_ms": bwd["dq_bound_tc_ms"],
        "bf16_ms": bwd_bf16["dq_ms"],
        "bf16_bound_ms": bwd_bf16["dq_bound_ms"],
        **bwd_entry,
    }, {
        "name": "flash_attention_bwd_dkv",
        "replaces": "distkeras_tpu/ops/pallas/flash_attention.py:264",
        "launches": train_launches["flash_attention_bwd_dkv"],
        "max_abs_err": max(bwd["max_abs_err_dk"], bwd["max_abs_err_dv"]),
        "ms": bwd["dkv_ms"],
        "bound_ms": bwd["dkv_bound_ms"],
        "bound_by": bwd["dkv_bound_by"],
        "bound_tc_ms": bwd["dkv_bound_tc_ms"],
        "bf16_ms": bwd_bf16["dkv_ms"],
        "bf16_bound_ms": bwd_bf16["dkv_bound_ms"],
        **bwd_entry,
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
