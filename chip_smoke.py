#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``distkeras_tpu_torch``).

    python3 chip_smoke.py [--seed 0]

Needs one CUDA card (an H100: the kernels are built for sm_90a) and the CUDA
toolkit.  Phases, each printing JSON lines:

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: compiles every kernel from ``distkeras_tpu_torch/csrc``;
3. kernels: each kernel against its plain PyTorch version on the card,
   with its time, the plain version's, one library call's and the bound;
4. ``ModelPredictor`` over a ``TransformerClassifier`` at GPT-2-small widths
   (768 wide, 12 heads, 12 layers, 1024 positions, 50257 tokens), weights
   drawn from ``--seed``: 64 rows of 1024 tokens in batches of 16;
5. a causal ``TransformerLM`` forward through ``TrainedModel`` at the same
   widths on ``[4, 1024]`` tokens.

Phases 4 and 5 set the kernels' launch counts to 0 just before and read them
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

# Published H100 SXM peaks (dense): f32 outside the tensor cores, bf16
# tensor cores, HBM3 bandwidth.
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
PEAK_BYTES_PER_S = 3.35e12

GPT2_SMALL = dict(vocab_size=50257, dim=768, heads=12, num_layers=12, max_len=1024)

# (name, [batch, seq, heads, dim], dtype, causal, fused): fused cases take
# q, k, v as the strided views of one QKV projection, as _SelfAttention does.
KERNEL_CASES = [
    ("ragged", (2, 100, 2, 32), torch.float32, False, False),
    ("ragged_causal", (2, 100, 2, 32), torch.float32, True, False),
    ("classifier", (16, 1024, 12, 64), torch.float32, False, True),
    ("classifier_causal", (16, 1024, 12, 64), torch.float32, True, True),
    ("lm", (4, 1024, 12, 64), torch.float32, True, True),
    ("lm_bf16", (4, 1024, 12, 64), torch.bfloat16, True, False),
    ("dim128", (1, 257, 4, 128), torch.float32, False, False),
]
MAIN_PATH_CASE = "classifier"  # the shape ModelPredictor hands the kernel


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


def attention_bound_ms(shape, dtype, causal: bool):
    """Least time for the card to do one attention forward at ``shape``:
    the larger of the FLOPs over the dtype's peak rate (4·d per attended
    (query, key) pair, only the attended pairs when causal) and the bytes
    over the memory rate (Q, K, V read once, O and the f32 LSE written once)."""
    b, l, h, d = shape
    pairs = l * (l + 1) // 2 if causal else l * l
    flops = 4.0 * b * h * pairs * d
    itemsize = torch.empty((), dtype=dtype).element_size()
    nbytes = 4 * b * l * h * d * itemsize + b * h * l * 4
    ops_ms = flops / PEAK_FLOPS[dtype] * 1e3
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes")


def make_qkv(shape, dtype, fused: bool, gen: torch.Generator):
    b, l, h, d = shape
    if fused:
        qkv = torch.randn((b, l, 3, h, d), generator=gen, device="cuda").to(dtype)
        return qkv.unbind(2)
    return tuple(torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(3))


def kernel_phase(seed: int):
    import torch.nn.functional as F

    from distkeras_tpu_torch.ops.flash_attention import (
        flash_attention_fwd,
        flash_attention_plain,
    )

    gen = torch.Generator(device="cuda").manual_seed(seed)
    results = {}
    for name, shape, dtype, causal, fused in KERNEL_CASES:
        q, k, v = make_qkv(shape, dtype, fused, gen)
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
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        library_ms = cuda_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal),
            10 if big else 50,
        )
        bound_ms, bound_by = attention_bound_ms(shape, dtype, causal)
        row = dict(case=name, shape=list(shape), dtype=str(dtype).replace("torch.", ""),
                   causal=causal, max_abs_err_o=err_o, max_abs_err_lse=err_lse,
                   tolerance=tol, kernel_ms=kernel_ms, plain_ms=plain_ms,
                   library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)
        emit(phase="kernel", kernel="flash_attention_fwd", **row)
        if not ok:
            raise AssertionError(f"flash_attention_fwd disagrees with its plain version: {row}")
        results[name] = row
        del q, k, v, o, lse, o_ref, lse_ref
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
    _build.flash_attention_fwd_library()
    emit(phase="build", kernel="flash_attention_fwd", seconds=time.perf_counter() - t0)

    cases = kernel_phase(args.seed)
    predictor_launches = predictor_phase(args.seed)
    lm_launches = lm_phase(args.seed)

    main_case = cases[MAIN_PATH_CASE]
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
        "library_ms": main_case["library_ms"],
        "shape": main_case["shape"],
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
