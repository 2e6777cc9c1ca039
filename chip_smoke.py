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
    full-context forward, which runs B1), ``ServingEngine`` (12 staggered
    requests, half greedy held to ``greedy_generate``, half sampled held to
    themselves rerun alone; EOS, a full queue, pages returned),
    speculative decoding (a 2-layer draft, and the target as its own) and
    ``ModelPredictor(engine=)``; TTFT and step-latency quantiles, decode
    tokens/s, the profiled decode step, prefill ms per bucket, peak pages
    and memory.  A greedy token may differ from its reference only where
    the reference's two best logits are within ``GREEDY_GAP``;
17. packing: 96 ragged sequences (``bench.py``'s log-normal length mix
    scaled to width 1024, clipped to 16..1024) through ``pack_sequences``
    (efficiency printed), each segment's logits through a GPT-2-small
    ``TransformerLM(packed=True)`` against the same sequence alone through
    its ``packed=False`` twin on the same parameters (B1) within
    ``PACK_LOGITS_ATOL``, and ``DOWNPOUR`` (2 workers, batch 4, window 2,
    2 epochs) on 16 packed rows with ``masked_token_crossentropy``: real
    tokens/s, peak memory, a finite loss;
18. mesh: (a) ``networking.initialize`` over NCCL at world size 1 and
    ``make_mesh()``: ``cifar_cnn_downpour`` eager and in captured windows
    (the commit's all-reduce inside the graph) bitwise the epochs phase's
    no-mesh run, and the train phase's GPT-2-small ``DOWNPOUR`` over the
    mesh launching B1-B3 as often as there; each NCCL transport of
    ``parallel/mesh.py`` recorded into a graph over that group and replayed
    on two input sets, bitwise eager (the ring hop a send to itself); and
    ``cifar_cnn_downpour`` with ``fsdp=True`` (the GSPMD engine) in
    captured windows bitwise its eager run on the group, the commit's
    all-reduces in the graphs; (b) two gloo ranks spawned on
    the one card (``--mesh-rank``; NCCL refuses two ranks on one card),
    ``cifar_cnn_downpour`` with 4 workers, 2 a rank, against one rank
    with 4: commit counts exact, the first window's center in f32 within
    ``MESH_F32_PARAM_ATOL``, the bf16 run (2 epochs) within
    ``MESH_BF16_*``, samples/s; (c) where the machine has several cards,
    ``min(4, count)`` NCCL ranks, one a card, the same checks (one card:
    ``mesh_cards_run: 1``); (d) ``ModelPredictor`` over every card and
    over two replicas on one card within ``MESH_PREDICT_ATOL`` of
    ``num_devices=1``;
19. seq: sequence parallelism (on several cards also in captured windows,
    as in phases 20-22), (a) two gloo ranks spawned on the one card
    (``--seq-rank``), the ``(workers, seq)`` grid 1 x 2: the train phase's
    ``DOWNPOUR`` over ``TransformerLM(seq_axis="seq")`` at GPT-2-small
    widths cut to 6 blocks and one epoch, with ``seq_shards=2`` (each rank
    holds 512 tokens of each row) against the same run on one rank (the
    first window's loss within
    ``SEQ_FIRST_LOSS_RTOL``, the loss history and the center within
    ``SEQ_LOSS_RTOL`` and ``SEQ_PARAM_REL_NORM``), then ``fsdp=True`` bit
    for bit the replicated run, with its center in seq shards; tokens/s,
    peak memory of rank 0 against the one rank's, the ring's forward ms a
    layer and the bytes staged through the host; (b) the classifier's
    logits at 2 ranks against one rank (B1) within ``SEQ_CLS_ATOL``; (c)
    the twin the trainer returned through ``ModelPredictor``; (d) on a
    machine with several cards, NCCL, one rank a card (2 x 2 with 4 cards,
    1 x 2 with 2 or 3), the same checks, eager and in captured windows
    (else ``seq_cards_run: 1``);
20. tp: tensor parallelism (see :func:`tp_phase`);
21. serving_tp: ``ServingEngine(mesh=)`` at the serving phase's widths (6
    of its 12 blocks) on
    two gloo ranks sharing the card (and NCCL ranks on a machine with
    several cards, eager and with captured step programs) against the
    one-rank engine (see :func:`serving_tp_phase`);
22. moe: ``MoETransformerClassifier`` at switch-base-8's widths under
    ``DOWNPOUR`` on one rank, then expert-parallel on two gloo ranks (and
    the NCCL grid on a machine with several cards, eager and in captured
    windows; see :func:`moe_phase`);
23. pipeline: a ``StagedLM`` at GPT-2 small's widths (cut to 6 of the 12
    blocks, as 2 stages of 3, and 16 rows) under ``DOWNPOUR`` on
    one rank, then
    ``pipeline_stages=2, pp_microbatches=2`` on two gloo ranks sharing the
    card (``--pp-rank``), replicated and with ``fsdp=True``; its greedy
    decode pipelined over the ranks and a ``ServingEngine`` over it (and
    the 2 x 2 NCCL grid on a 4-card machine; see :func:`pipeline_phase`);
24. pipeline_3d: phase 23's ``StagedLM`` and ``DOWNPOUR`` on four gloo
    ranks sharing the card (``--pp3d-rank``), grid 1 x 2 x 2:
    ``tp_shards=2`` (the ``(workers, stages, model)`` grid), then with
    ``fsdp=True``, then ``seq_shards=2`` with the model built
    ``seq_axis="seq"`` (the ``(workers, stages, seq)`` grid), each against
    phase 23's one-rank run (and both grids over NCCL, one rank a card, on
    a 4-card machine; see :func:`pipeline_3d_phase`);
25. hf_telemetry: a GPT-2-small checkpoint's layout (``GPT2LMHeadModel``'s
    state dict, random from ``--seed``) through ``gpt2_state_to_staged``
    into a ``PretrainedStagedLM`` of 2 stages: its forward on the card
    against the CPU, the train phase's one-rank ``DOWNPOUR`` over it with
    the training telemetry off and then on (``DISTKERAS_TELEMETRY``,
    ``DISTKERAS_DYNAMICS`` with the ``warn`` watchdog, ``profile_dir``), bit
    for bit the same, and the fine-tuned model served over HTTP by
    ``install_http_endpoint`` on the flight deck's exporter (see
    :func:`hf_telemetry_phase`);
26. fleet: chaos, fleet membership and the Punchcard control plane over
    ``DOWNPOUR`` on a ``TransformerLM`` at GPT-2 small's widths cut to 2
    blocks: a seeded kill and a kill after a torn checkpoint, each
    recovered by ``train_with_recovery`` bit for bit; a live elastic grow
    from 2 to 4 workers over a ``PunchcardServer`` on 127.0.0.1, bit for
    bit the elastic-resume path; a job submitted under client-side faults
    whose script predicts on the card in a process of its own, bit for bit
    the parent's prediction (see :func:`fleet_phase`);
27. online: the serving tier and the online serve-to-train loop at GPT-2
    small's widths and depth: two ``ServingEngine`` replicas behind a
    ``ServingTier``, failover under a seeded ``kill_replica`` held to each
    request served alone and billed once; then served traffic captured by
    a ``TrafficLog`` behind ``install_tier_endpoint``, each window retrained
    by ``WindowScheduler`` through ``DOWNPOUR`` (a killed first attempt
    retried), a rotted step rejected at swap time and the next rolled into
    both replicas bit for bit while requests are in flight (see
    :func:`online_phase`).  A ``timing`` line then gives every phase's wall
    seconds and the run's wall from the build on.

Phases 19 to 24, which train and serve over gloo ranks sharing the card,
run in a process of their own (``--gloo-lane``), started once phases 4 and
5 have timed the kernels, side by side with phases 6 to 18 and 25 to 27 in
this one; each process counts its own launches, so every phase's counts
are its own, but the rates and device shares printed while both run are
taken on a shared card and host.  Each process empties the allocator's
cache after every phase, so that the two fit on the card together.

Phases 4 to 6, 10 and 15 set the kernels' launch counts to 0 just before
and read them just after, check that every kernel of the path ran as often
as the model needs, and hold the output against the same model on the CPU
(phase 15: against the eager run).  Phase 16 does so around the serving
path, which launches no kernel of the port's own (decode attention is the
reference's plain masked product, as there), and around its check's
forward, which launches B1; phase 17 around the packed forwards and the
packed training (0 launches: the packed path is the reference's masked
product, as there) and each segment's forward alone (B1); phase 18
around its GPT-2 run over the mesh; phase 19 around each rank's
seq-sharded training and classifier forward (0 launches: the ring is the
reference's plain products, as there) and the twin's predictor (B1);
phase 21 around each rank-0 serving run (0 launches); phase 22 around the
MoE training (B1-B3 12 a step), its step check and its predictor (B1);
phase 23 around the one-rank training (B1-B3 6 a step) and each stage
rank's pipelined training (B1-B3 ``blocks_per_stage x microbatches`` a
step); phase 24 around each rank's training on the 3-D grids (pp x tp as
phase 23's stage ranks, every model rank running all heads; pp x sp 0: the
ring's plain products); phase 25 around the converted forward (B1 12) and
each of its two trainings (B1-B3 12 a step); phase 26 around each of its
trainings (B1-B3 2 a local step; a kill recovered launches as often as the
uninterrupted run, a torn checkpoint one replayed epoch more) and each
job prediction (B1 2 a batch, in the job's process and the parent); phase
27 around the failover's serving (0 launches) and the two window retrains
(B1-B3 12 a local step; the killed attempt none).
Phases 7 to 9, 11 to 14 and 18's
CIFAR runs launch no kernel of the port's own: convolutions, dense
products and embedding gathers are PyTorch's.  The last lines are a ``{"kernels":
[...]}`` summary, the nvidia-smi line and ``{"ok": true, "device":
{...}}``.  Any failed check raises, so the script exits non-zero without
the ``ok`` line; so does a machine without CUDA.
"""

from __future__ import annotations

import argparse
import dataclasses
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


def _gpt2_downpour(seed: int):
    """The train phase's ``DOWNPOUR`` over a GPT-2-small ``TransformerLM``:
    ``(model, trainer, x, y)``."""
    import distkeras_tpu_torch as tdk
    from distkeras_tpu_torch.models import TransformerLM

    model = TransformerLM(**GPT2_SMALL, generator=torch.Generator().manual_seed(seed + 2))
    x, y = lm_task(TRAIN_ROWS, TRAIN_SEQ, GPT2_SMALL["vocab_size"], seed + 2)
    trainer = _keeping_fit(tdk.DOWNPOUR)(
        model, loss="token_crossentropy", metrics=("token_accuracy",),
        worker_optimizer=("adam", {"learning_rate": 2e-4}), num_workers=TRAIN_WORKERS,
        batch_size=TRAIN_BATCH, communication_window=TRAIN_WINDOW, num_epoch=TRAIN_EPOCHS,
        seed=seed, device="cuda",
    )
    return model, trainer, x, y


def train_phase(seed: int):
    import distkeras_tpu_torch as tdk
    from distkeras_tpu_torch.models import TorchModel
    from distkeras_tpu_torch.ops import (
        flash_attention,
        flash_attention_bwd_dkv,
        flash_attention_bwd_dq,
        get_loss,
    )

    model, trainer, x, y = _gpt2_downpour(seed)
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
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    emit(phase="train", trainer="DOWNPOUR", model="TransformerLM", **GPT2_SMALL,
         workers=TRAIN_WORKERS, batch_size=TRAIN_BATCH, window=TRAIN_WINDOW,
         epochs=TRAIN_EPOCHS, rows=TRAIN_ROWS, seq=TRAIN_SEQ, local_steps=local_steps,
         launches=launches, expected_launches=expected, loss=history["loss"],
         token_accuracy=history["token_accuracy"], num_updates=trainer.num_updates,
         seconds=seconds, seconds_per_step=seconds / local_steps,
         tokens_per_s=tokens / seconds, peak_memory_gb=peak_gb,
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
    run = dict(loss=history["loss"], first_window_loss=trainer.window_losses[0],
               peak_memory_gb=peak_gb, tokens_per_s=tokens / seconds,
               params={k: v.detach().float().cpu().clone() for k, v in trained.params.items()})
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
    their last fit, for checks on the state the trainer does not return,
    and the per-window losses of its in-memory epochs (``window_losses``,
    each the mean over the workers)."""
    from distkeras_tpu_torch.parallel import WindowedEngine

    class Kept(cls):
        def _fit(self, *args, **kwargs):
            real, self.window_losses = WindowedEngine.run_epoch, []

            def run_epoch(engine, *a, **kw):
                state, stats = real(engine, *a, **kw)
                self.window_losses.extend(np.asarray(stats["loss"]).tolist())
                return state, stats

            WindowedEngine.run_epoch = run_epoch
            try:
                self.fit_result = super()._fit(*args, **kwargs)
            finally:
                WindowedEngine.run_epoch = real
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
    from torch.profiler import ProfilerActivity, profile, supported_activities

    run()
    torch.cuda.synchronize()
    # the card's activity alone: the host's operator events would add
    # several times as many events to parse, and their recording to the
    # wall (a build without CUDA records the host's, which hold no device time)
    activities = ([ProfilerActivity.CUDA] if ProfilerActivity.CUDA in supported_activities()
                  else [ProfilerActivity.CPU])
    with profile(activities=activities) as prof:
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
    update count and clocks must equal the host-side count of the race.
    The same schedule from the same seeds again with ``unroll=True``, one
    captured step replayed once a step on a card, held to the eager run:
    updates and clocks equal, loss 1e-6 relative, center parameters 1e-5."""
    import distkeras_tpu_torch as tdk
    from distkeras_tpu_torch.models import zoo

    workers, batch = len(STALENESS_SCHEDULE), STALENESS_BATCH
    rows = workers * STALENESS_STEPS * batch
    x, y = zoo_data((256,), True, 2, rows, seed + 3)
    frame = tdk.from_numpy(x, y)

    def train(**kwargs):
        model = zoo.TextCNN(vocab_size=20000, num_classes=2,
                            generator=torch.Generator().manual_seed(seed + 3))
        trainer = _keeping_fit(tdk.DynSGD)(
            model, loss="categorical_crossentropy",
            worker_optimizer=("adam", {"learning_rate": 1e-3}), metrics=(),
            num_workers=workers, batch_size=batch, num_epoch=STALENESS_EPOCHS,
            communication_window=ZOO_WINDOW, commit_schedule=list(STALENESS_SCHEDULE),
            compute_dtype="bfloat16", seed=seed, device=ZOO_DEVICE, **kwargs)
        return trainer, _trained(trainer, frame)

    trainer, eager = train()
    captured, graph = train(unroll=True)
    engine, graph_state, _ = captured.fit_result
    graph_row = dict(graphs=engine.use_graphs, graph_stats=dict(engine.graph_stats),
                     clocks=graph_state.rule_local["clock"].tolist(),
                     num_updates=captured.num_updates, seconds=graph["seconds"],
                     versus_eager=_versus(graph, eager))
    del captured, engine, graph_state
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
               loss=history["loss"], seconds=seconds, seconds_per_step=seconds / local_steps,
               unroll=graph_row)
    emit(phase="staleness", **row)
    if trainer.num_updates != want_updates or clocks != want_clocks:
        raise AssertionError(f"staleness run: updates {trainer.num_updates} (want "
                             f"{want_updates}), clocks {clocks} (want {want_clocks})")
    if not max(staleness) > 0 or not np.isfinite(history["loss"]).all():
        raise AssertionError(f"staleness run: no stale commit or a non-finite loss: {row}")
    versus = graph_row["versus_eager"]
    if (graph_row["num_updates"] != want_updates or graph_row["clocks"] != want_clocks
            or versus["loss_rel_err"] > GRAPH_LOSS_RTOL
            or versus["max_param_err"] > GRAPH_PARAM_ATOL):
        raise AssertionError(f"staleness run with unroll=True differs from eager: {graph_row}")
    if ZOO_DEVICE == "cuda" and (not graph_row["graphs"] or graph_row["graph_stats"] != {
            "captures": 1, "replays": STALENESS_EPOCHS * STALENESS_STEPS}):
        raise AssertionError(f"staleness run with unroll=True: {graph_row}")
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

    networking.initialize(f"127.0.0.1:{_free_port()}", 1, 0, device=ZOO_DEVICE)
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
    kwargs = dict(dict(num_epoch=ZOO_EPOCHS, compute_dtype="bfloat16", num_workers=ZOO_WORKERS,
                       **extra), **kwargs)
    return _keeping_fit(getattr(tdk, trainer_name))(
        model, loss="categorical_crossentropy", metrics=(), batch_size=batch,
        seed=model_seed, device=ZOO_DEVICE, worker_optimizer=opt,
        communication_window=ZOO_WINDOW, **kwargs)


def _flat_params(params) -> dict:
    """A name -> tensor dict; a staged model's tree with ``key/name`` keys."""
    out = {}
    for k, v in params.items():
        out.update({f"{k}/{n}": t for n, t in v.items()} if isinstance(v, dict) else {k: v})
    return out


def _trained(trainer, frame):
    model = trainer.train(frame)
    if ZOO_DEVICE == "cuda":
        torch.cuda.synchronize()
    history = trainer.get_history()
    return dict(loss=history["loss"], seconds=history["training_time"],
                params={k: v.detach().float().cpu().clone()
                        for k, v in _flat_params(model.params).items()})


def _versus(run, reference):
    """How far ``run`` lies from ``reference``: bitwise?, the largest loss
    relative error and center-parameter difference, and the norm of the
    parameters' difference relative to the reference's (all leaves as one
    vector)."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(run["loss"], reference["loss"]))
    param = max(float((run["params"][k] - v).abs().max()) for k, v in reference["params"].items())
    diff = sum(float((run["params"][k] - v).double().square().sum())
               for k, v in reference["params"].items())
    norm = sum(float(v.double().square().sum()) for v in reference["params"].values())
    rel = (diff / max(norm, 1e-300)) ** 0.5
    bitwise = run["loss"] == reference["loss"] and all(
        torch.equal(run["params"][k], v) for k, v in reference["params"].items())
    return dict(bitwise=bitwise, loss_rel_err=loss, max_param_err=param,
                param_rel_norm_err=rel)


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
    for bit.  Under ``remat`` the twins the recomputations draw from are put
    back with the workers' generators (the engine sets them so before each
    replay; a replay advances a worker's generator and its twin alike).  The
    state and the generators are left as they were found."""
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
            for g, twin, s in zip(static.rng, engine._twins or [None] * len(rng), rng):
                g.set_state(s)
                if twin is not None:
                    twin.set_state(s)

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
    with dropout ``REMAT_DROPOUT``, trained eagerly, with ``remat=True``,
    with ``unroll=True`` and with both, from the same seeds.  Remat, the
    graph and remat in the graph are each held to the eager run within the
    epochs phase's gates (loss 1e-6 relative, center parameters 1e-5):
    remat's recomputation and the graph's replays must draw the eager run's
    masks.  Remat launches the forward kernel (B1) twice as often as eager
    and B2/B3 as often; the graph runs launch B1-B3 inside their windows,
    B1 twice a forward under remat; peak memory is printed for all four.
    Two replays of a window from the same state must draw different masks
    (:func:`replay_masks`), under remat too, and the eager run must differ
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

    def captured(**kwargs):
        trainer, run = train(unroll=True, **kwargs)
        engine = trainer.fit_result[0]
        ticks_and_launches = engine.graph_launches()
        # a wrapper's counter ticks at the warm-up window (real launches) and
        # at capture (none); the graph's launches are its capture ticks x replays
        launches = [c.launches - ticks_and_launches.get(c.__name__, (0, 0))[0]
                    + ticks_and_launches.get(c.__name__, (0, 0))[1] for c in counters]
        replays = replay_masks(engine) if engine.use_graphs else {}
        return run, dict(engine.graph_stats), engine.use_graphs, ticks_and_launches, launches, \
            replays

    graph, graph_stats, use_graphs, ticks_and_launches, graph_launches, replays = captured()
    (remat_graph, remat_graph_stats, _, remat_ticks_and_launches, remat_graph_launches,
     remat_replays) = captured(remat=True)

    local_steps = TRAIN_EPOCHS * (TRAIN_ROWS // (TRAIN_WORKERS * TRAIN_BATCH)) * TRAIN_WORKERS
    expected = REMAT_MODEL["num_layers"] * local_steps
    window_launches = REMAT_MODEL["num_layers"] * TRAIN_WORKERS * TRAIN_WINDOW
    row = dict(trainer="DOWNPOUR", model="TransformerLM", **REMAT_MODEL, dropout=REMAT_DROPOUT,
               workers=TRAIN_WORKERS, batch_size=TRAIN_BATCH, window=TRAIN_WINDOW,
               epochs=TRAIN_EPOCHS, rows=TRAIN_ROWS, local_steps=local_steps,
               loss=eager["loss"], remat_loss=remat["loss"], graph_loss=graph["loss"],
               remat_graph_loss=remat_graph["loss"],
               seconds=eager["seconds"], remat_seconds=remat["seconds"],
               graph_seconds=graph["seconds"], remat_graph_seconds=remat_graph["seconds"],
               dropout_changed_loss=eager["loss"] != train_run["loss"],
               remat_vs_eager=_versus(remat, eager), graph_vs_eager=_versus(graph, eager),
               remat_graph_vs_eager=_versus(remat_graph, eager),
               launches_eager=eager["launches"], launches_remat=remat["launches"],
               expected_launches_eager=expected,
               peak_memory_gb_eager=eager["peak_memory_gb"],
               peak_memory_gb_remat=remat["peak_memory_gb"],
               peak_memory_gb_graph=graph["peak_memory_gb"],
               peak_memory_gb_remat_graph=remat_graph["peak_memory_gb"],
               remat_lowered_peak_memory=remat["peak_memory_gb"] < eager["peak_memory_gb"],
               graph_stats=graph_stats, graphs=use_graphs,
               graph_ticks_and_launches=ticks_and_launches, launches_graph=graph_launches,
               expected_launches_graph=expected + window_launches,  # + the warm-up window
               remat_graph_stats=remat_graph_stats,
               remat_graph_ticks_and_launches=remat_ticks_and_launches,
               launches_remat_graph=remat_graph_launches,
               launches_counted_as="wrapper counter - capture ticks + capture ticks x replays",
               **replays, remat_graph_replays=remat_replays)
    failures = []
    if not row["dropout_changed_loss"]:
        failures.append("the loss with dropout equals the train phase's without: no mask drawn")
    for mode in ("remat", "graph", "remat_graph"):
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
        graphed = expected + window_launches
        if remat_graph_launches != [2 * graphed, graphed, graphed]:
            failures.append(f"remat graph launches {remat_graph_launches}, expected "
                            f"{[2 * graphed, graphed, graphed]} (B1 twice)")
        for name, got in (("graph", replays), ("remat graph", remat_replays)):
            if not (got["fresh_masks_each_replay"] and got["replay_repeatable"]):
                failures.append(f"replays of a captured {name} window: {got}")
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
SERVE_REQUESTS = 12  # cut from 24 for the script's time
SERVE_PROMPT_LEN = (16, 768)  # drawn from --seed, inclusive
SERVE_NEW_TOKENS = (32, 128)
SERVE_STAGGER_S = 0.02  # between submissions
SERVE_SAMPLING = dict(temperature=0.9, top_k=50, top_p=0.95)
SERVE_SPEC_TOKENS = 4
SERVE_SPEC_PROMPTS = 2  # greedy requests of the traffic run through the speculative engines
SERVE_PREDICT = (8, 64, 16)  # ModelPredictor(engine=): rows, prompt length, new tokens
SERVE_PROFILE = (64, 32)  # profiled decode: prompt length, new tokens, one request a slot
SERVE_SWAP_REQUESTS, SERVE_SWAP_NEW = 4, 32  # after the hot swap: requests, new tokens each
# A greedy token may differ from its reference only where the reference's
# two best logits are closer than this (f32, the orders of summation differ).
GREEDY_GAP = 1e-4


def _top_two_gap(logits) -> float:
    top = torch.topk(logits.float(), 2).values
    return float(top[0] - top[1])


def _held_to_greedy(trained, prompt, tokens, ref, limit=GREEDY_GAP):
    """Where ``tokens`` first departs from the greedy reference ``ref`` (both
    continuations of ``prompt``): None if it never does, else ``(position,
    the reference's top-two gap there)`` from a full-context forward over
    the shared prefix.  Raises if that gap is not below ``limit``
    (``GREEDY_GAP``)."""
    n = min(len(tokens), len(ref))
    diff = next((j for j in range(n) if tokens[j] != ref[j]), None)
    if diff is None:
        if len(tokens) != len(ref):
            raise AssertionError(f"{len(tokens)} tokens against {len(ref)} in the reference")
        return None
    context = np.asarray([list(prompt) + list(ref[:diff])], np.int32)
    gap = _top_two_gap(trained(context)[0, -1])
    if not gap < limit:
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


def _kv_rounding_logit_error(model, trained, contexts) -> float:
    """The largest change in any logit that rounding every block's keys and
    values to bf16 (what bf16 page pools store) makes in a full-context
    forward over each of ``contexts``: the forward is run plain, then with a
    hook on each block's fused QKV projection that rounds its K and V
    thirds."""
    dim = model.dim

    def round_kv(module, args, out):
        kv = out[..., dim:].to(torch.bfloat16).to(out.dtype)
        return torch.cat([out[..., :dim], kv], dim=-1)

    worst = 0.0
    for context in contexts:
        tokens = np.asarray([context], np.int32)
        plain = trained(tokens)
        hooks = [block.attn.qkv.register_forward_hook(round_kv) for block in model.blocks]
        try:
            rounded = trained(tokens)
        finally:
            for h in hooks:
                h.remove()
        worst = max(worst, float((plain - rounded).abs().max()))
    return worst


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


def _profiled_decode(engine, prompts, cuda: bool) -> dict:
    """The decode step under ``torch.profiler``: one request a slot (each
    of ``prompts``, ``SERVE_PROFILE[1]`` new tokens), admitted together
    (queued while drained).  The run's wall and device time over its decode
    steps (its prefills in them), the card's busy share, every device
    operation of the run and a step's share; the CPU has no device time to
    split, so a rehearsal runs it unprofiled."""
    from distkeras_tpu_torch.serving import GenerateRequest

    run_steps = []

    def run():
        steps_before = engine._metrics["decode_steps"].value
        engine.drain(timeout=60)
        batch = [engine.submit(GenerateRequest(prompt=p, max_new_tokens=SERVE_PROFILE[1]))
                 for p in prompts]
        engine.resume()
        for p in batch:
            p.result(timeout=600)
        run_steps.append(engine._metrics["decode_steps"].value - steps_before)

    profile = fwd_bwd_profile(run, iters=1) if cuda else run() or {}
    steps = max(run_steps[-1], 1)
    ops = profile.get("kernels_per_call")
    return dict(slots=len(prompts), steps=run_steps[-1], captured=engine._use_graphs,
                wall_ms_per_step=profile.get("wall_ms_per_call", 0.0) / steps,
                device_ms_per_step=(profile["device_ms_per_call"] / steps
                                    if profile.get("device_ms_per_call") else None),
                device_busy_share=profile.get("device_busy_share"),
                device_ops=ops, device_ops_per_step=ops / steps if ops else None,
                top_kernels=profile.get("top_kernels"))


def _program_counts(engine) -> dict:
    """A serving engine's captured programs: ``graph_stats``, each
    program's replays by key, and the decode steps and finished requests
    its registry counted (every finished request was prefilled once)."""
    return dict(graph_stats=dict(engine.graph_stats),
                replays={"/".join(map(str, k)): p.replays for k, p in engine._programs.items()},
                decode_steps=int(engine._metrics["decode_steps"].value),
                requests=int(engine._metrics["requests"].value))


def _check_programs(graphs: dict, steps: list, roles: tuple, buckets) -> None:
    """The gates on a serving engine's captured programs, from its
    :func:`_program_counts` before and after a hot swap and its eager
    twin's: before the swap one capture a program (the decode or
    speculative graph, a prefill graph a role and bucket used), the step
    program replayed once a decode step, a prefill once a request and
    role; after it every program used captured anew and counted the same
    way; the eager twin captured nothing."""
    before, after, eager = graphs["before_swap"], graphs["after_swap"], graphs["eager"]
    allowed = {"/".join(map(str, k)) for k in steps} | {
        f"prefill/{role}/{w}" for role in roles for w in buckets}
    step = "/".join(map(str, steps[0]))
    failures = []
    for name, got, base in (("before the swap", before, None), ("after it", after, before)):
        captures, replays = got["graph_stats"]["captures"], got["graph_stats"]["replays"]
        steps_run = got["decode_steps"] - (base["decode_steps"] if base else 0)
        requests = got["requests"] - (base["requests"] if base else 0)
        prior = base["graph_stats"] if base else {"captures": 0, "replays": 0}
        if (not set(got["replays"]) <= allowed or step not in got["replays"]
                or captures - prior["captures"] != len(got["replays"])
                or got["replays"][step] != steps_run
                or replays - prior["replays"] != steps_run + requests * len(roles)):
            failures.append(f"{name}: {got}")
    if eager["graph_stats"] != {"captures": 0, "replays": 0} or eager["replays"]:
        failures.append(f"the eager engine captured: {eager}")
    if failures:
        raise AssertionError(f"captured programs: {failures}")


def _serve_all(engine, requests, new_tokens=None) -> list:
    """Each of ``requests`` (copies, ``new_tokens`` new tokens where given)
    submitted at once; their tokens, in order."""
    copies = [dataclasses.replace(r, max_new_tokens=new_tokens or r.max_new_tokens)
              for r in requests]
    pendings = [engine.submit(r) for r in copies]
    results = [p.result(timeout=600) for p in pendings]
    if any(r is None or r.finish_reason == "aborted" for r in results) or not engine.alive:
        raise AssertionError(f"the engine failed: {engine.error!r}")
    return [r.tokens for r in results]


def serving_phase(seed: int):
    """KV-cache decode and the serving engine through their entry points at
    GPT-2-small widths (random weights from ``--seed``, f32):

    1. ``greedy_generate`` over a ``TrainedModel`` (batch 4, 128-token
       prompts, 64 steps), each token held against the argmax of one
       full-context forward over the prompt and the tokens so far (which
       runs B1: its launches are counted); a token may differ only where
       that forward's top-two gap is below ``GREEDY_GAP``;
    2. ``ServingEngine`` (8 slots, pages of 16, buckets 16 to 1024): 12
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
    4. ``ModelPredictor(engine=)`` over 8 prompts, held row by row to
       ``engine.generate``, exactly.

    On a card the engine runs its step programs as captured CUDA graphs.
    The traffic of 2 runs again through an eager engine (capture off), and
    the tokens must be equal bit for bit; both engines then swap to a second
    set of weights drawn from ``--seed`` and serve 4 requests (greedy and
    sampled), bit for bit again; the speculative engine (the shallow draft)
    is held to its eager twin the same way, across a swap too.  Captures
    must not grow with the requests: one decode (or speculative) graph and
    one prefill graph for each role and bucket used, again after a swap; a
    replay for every decode step and every prefill.

    Prints TTFT and decode-step latency quantiles from the engine's
    histograms, the traffic run's generated tokens over its wall (prefills
    and the stagger included) and its decode tokens over the summed
    decode-step wall, decode-step ms, device operations and the card's busy
    share under ``torch.profiler``, captured and eager, prefill ms per
    bucket width, peak pages and memory, the engines' ``graph_stats``, and
    B1's launches (0 on the serving path, which runs the reference's plain
    masked attention)."""
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
    second = TransformerLM(**SERVE_MODEL, generator=torch.Generator().manual_seed(seed + 9))
    swapped = TrainedModel(TorchModel(second),
                           {k: v.detach() for k, v in second.named_parameters()},
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
    sampled = [i for i in range(SERVE_REQUESTS) if i % 2 == 1]
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
    eager = _serving_engine(trained, Registry(), queue_size=SERVE_REQUESTS + 8)
    eager._use_graphs = False  # the engine's eager path, on the card too
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

        # 2b. the same traffic through the eager path: the same tokens, bit for bit
        eager_tokens = _serve_all(eager, requests)
        differ = [i for i, r in enumerate(results) if r.tokens != eager_tokens[i]]
        if differ:
            raise AssertionError(f"captured and eager tokens differ for requests {differ}")

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

        # the decode step under torch.profiler, captured and eager
        profile_prompts = [rng.integers(0, vocab, SERVE_PROFILE[0]).tolist()
                           for _ in range(SERVE_SLOTS)]
        profiled = _profiled_decode(engine, profile_prompts, cuda)
        profiled_eager = _profiled_decode(eager, profile_prompts, cuda)

        # 2c. both engines swap to the second weights (each drops its
        # graphs, and the captured one captures anew): bit for bit again
        before_swap = _program_counts(engine)
        swap_ids = greedy[:SERVE_SWAP_REQUESTS // 2] + sampled[:SERVE_SWAP_REQUESTS // 2]
        swap_traffic = [requests[i] for i in swap_ids]
        for e in (engine, eager):
            e.hot_swap(swapped, timeout=600)
        swap_tokens = _serve_all(engine, swap_traffic, SERVE_SWAP_NEW)
        if swap_tokens != _serve_all(eager, swap_traffic, SERVE_SWAP_NEW):
            raise AssertionError("captured and eager tokens differ after the hot swap")
        if all(t == results[i].tokens[:SERVE_SWAP_NEW] for t, i in zip(swap_tokens, swap_ids)):
            raise AssertionError("the hot swap changed no token")

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
        after_swap, eager_counts = _program_counts(engine), _program_counts(eager)
    finally:
        engine.stop()
        eager.stop()
    peak_memory = torch.cuda.max_memory_allocated() if cuda else None
    graphs = dict(before_swap=before_swap, after_swap=after_swap, eager=eager_counts)
    if cuda:
        _check_programs(graphs, [("decode",)], ("target",), engine.prefill_buckets)

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
        pool_bytes=engine._cache.k_pages.nbytes + engine._cache.v_pages.nbytes,
        pages_after=pages_after, peak_memory_bytes=peak_memory,
        launches_b1=serve_launches[0], launches_b2_b3=serve_launches[1:],
        greedy_departures=greedy_departures,
        eos_finish=results[eos_request].finish_reason, sampled_rerun_equal=True,
        other_seed_differs=True, queue_full_rejected=rejected,
        predictor_rows=rows, predictor_equal=True,
        profiled_decode=profiled, profiled_decode_eager=profiled_eager,
        eager_equal=True, swap_requests=len(swap_ids), swap_new_tokens=SERVE_SWAP_NEW,
        swap_eager_equal=True, graphs=graphs)
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

    # 3b. the speculative engine captured against its eager twin: a greedy
    # and a sampled request, then both again after a hot swap of the target
    spec_traffic = [requests[greedy[1]], requests[sampled[0]]]
    spec_runs = {}
    for captured in (True, False):
        engine = _serving_engine(trained, Registry(), spec_tokens=SERVE_SPEC_TOKENS,
                                 draft_model=draft, draft_params=draft_params)
        engine._use_graphs = engine._use_graphs and captured
        try:
            tokens = _serve_all(engine, spec_traffic, SERVE_SWAP_NEW)
            before_swap = _program_counts(engine)
            engine.hot_swap(swapped, timeout=600)
            tokens += _serve_all(engine, spec_traffic, SERVE_SWAP_NEW)
            spec_runs[captured] = dict(tokens=tokens, before_swap=before_swap,
                                       after_swap=_program_counts(engine))
        finally:
            engine.stop()
    if spec_runs[True]["tokens"] != spec_runs[False]["tokens"]:
        raise AssertionError("the speculative engine's captured and eager tokens differ")
    spec_graphs = dict(spec_runs[True], eager=spec_runs[False]["after_swap"])
    del spec_graphs["tokens"]
    if cuda:
        _check_programs(spec_graphs, [("spec",)], ("target", "draft"), engine.prefill_buckets)
    out["speculative"] = dict(spec_tokens=SERVE_SPEC_TOKENS, draft_model=SERVE_DRAFT, **spec_rows,
                              graphs=dict(spec_graphs, requests=len(spec_traffic),
                                          new_tokens=SERVE_SWAP_NEW, eager_equal=True))

    # 5. bf16 page pools under the f32 parameters (ServingEngine(dtype=)),
    # one greedy request at a time; prefill attends its own f32 K/V, decode
    # reads them back from the pools rounded to bf16
    chosen = greedy[1:1 + SERVE_SPEC_PROMPTS]
    limit = max(GREEDY_GAP, 2 * _kv_rounding_logit_error(
        model, trained, [prompts[i] + refs[i] for i in chosen[:2]]))
    registry = Registry()
    engine = _serving_engine(trained, registry, dtype=torch.bfloat16)
    try:
        pool_dtypes = {str(engine._cache.k_pages.dtype), str(engine._cache.v_pages.dtype)}
        pool_bytes = engine._cache.k_pages.nbytes + engine._cache.v_pages.nbytes
        t0 = time.perf_counter()
        results = [engine.submit(requests[i]).result(timeout=600) for i in chosen]
        seconds = time.perf_counter() - t0
    finally:
        engine.stop()
    departures = []
    for i, result in zip(chosen, results):
        if result.tokens[:1] != refs[i][:1]:
            raise AssertionError(f"bf16 pools: request {i}'s first token (its f32 prefill) "
                                 f"is {result.tokens[:1]}, greedy's {refs[i][:1]}")
        hit = _held_to_greedy(trained, prompts[i], result.tokens, refs[i], limit)
        if hit is not None:
            departures.append(dict(request=i, position=hit[0], gap=hit[1]))
    f32_bytes = out["engine"]["pool_bytes"]
    out["bf16_pools"] = dict(requests=len(results), tokens=sum(len(r.tokens) for r in results),
                             seconds=seconds, pool_dtypes=sorted(pool_dtypes),
                             pool_bytes=pool_bytes, pool_bytes_f32=f32_bytes,
                             gap_limit=limit, departures=departures)
    if pool_dtypes != {"torch.bfloat16"} or pool_bytes * 2 != f32_bytes:
        raise AssertionError(f"bf16 pools: {pool_dtypes}, {pool_bytes} bytes against the f32 "
                             f"pools' {f32_bytes}")

    for case, row in out.items():
        emit(phase="serving", case=case, model="TransformerLM", **SERVE_MODEL, **row)
    return out


# packing phase: GPT-2-small widths at pack width 1024, random weights from
# --seed; bench.py's ragged length mix (log-normal, mu 4.0 and sigma 0.8 at
# width 256, bench.py:1946-1948) scaled to width 1024 (mu 4.0 + ln 4) and
# clipped to 16..1024
PACK_MODEL = GPT2_SMALL
PACK_WIDTH, PACK_SEQUENCES, PACK_MIN_LEN = 1024, 96, 16
PACK_LOGITS_ATOL = 1e-4  # a segment's packed logits against its logits alone (B1)
PACK_EPOCHS = 2
# mesh phase: cifar_cnn_downpour with 4 workers over ranks of one group
MESH_WORKERS, MESH_RANK_TIMEOUT_S = 4, 600
MESH_F32_PARAM_ATOL = 1e-5  # the first window's center in f32, 2 ranks against 1
# the bf16 run (2 epochs) at 2 ranks against 1 rank: the commit's sum order
# differs, (w0 + w1) + (w2 + w3) against w0 + w1 + w2 + w3, and the bf16
# steps amplify that ulp into a different trajectory.  scripts/mesh_tolerance.py
# measured it on the CPU (this commit pattern, batch 16 and 32, seeds 0-3):
# loss within 1.5e-4 relative, parameters within 5.6e-3 in relative norm;
# the bounds are about 5x those
MESH_BF16_LOSS_RTOL, MESH_BF16_PARAM_RTOL = 1e-3, 3e-2
MESH_PREDICT_ROWS, MESH_PREDICT_ATOL = 1024, 1e-5
CARD = None  # the nvidia-smi name and power limit, beside the new phases' numbers


def packed_lengths(n: int, width: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    mu = 4.0 + np.log(width / 256)
    return np.clip(rng.lognormal(mu, 0.8, size=n).astype(int), PACK_MIN_LEN, width)


def packing_phase(seed: int):
    """Sequence packing at GPT-2-small widths: ``pack_sequences`` over the
    ragged mix, every segment's logits through ``TransformerLM(packed=True)``
    against the same sequence alone through its ``packed=False`` twin on the
    same parameters (B1, on the card), and ``DOWNPOUR`` over the packed rows
    with ``masked_token_crossentropy``.  The packed path is the reference's
    masked product (no kernel has a segment mask): B1-B3 launch 0 times in
    the packed forwards and the packed training."""
    import distkeras_tpu_torch as tdk
    from distkeras_tpu_torch.datapipe import pack_sequences
    from distkeras_tpu_torch.models import TorchModel, TransformerLM
    from distkeras_tpu_torch.ops import (
        flash_attention,
        flash_attention_bwd_dkv,
        flash_attention_bwd_dq,
    )

    counters = (flash_attention, flash_attention_bwd_dq, flash_attention_bwd_dkv)
    cfg = dict(PACK_MODEL, max_len=PACK_WIDTH)
    rng = np.random.default_rng(seed + 7)
    seqs = [rng.integers(1, cfg["vocab_size"], size=int(m)).astype(np.int32)
            for m in packed_lengths(PACK_SEQUENCES, PACK_WIDTH, seed + 7)]
    t0 = time.perf_counter()
    pb = pack_sequences(seqs, PACK_WIDTH)
    pack_ms = (time.perf_counter() - t0) * 1e3
    rows = pb.tokens.shape[0]
    train_rows = TRAIN_WORKERS * TRAIN_BATCH * TRAIN_WINDOW
    if rows < train_rows:
        raise AssertionError(f"packing: {rows} rows, the training needs {train_rows}")

    packed = TransformerLM(**cfg, packed=True, generator=torch.Generator().manual_seed(seed + 7))
    params = {k: p.detach().to(ZOO_DEVICE) for k, p in packed.named_parameters()}
    on_card, twin = TorchModel(packed), TorchModel(TransformerLM(**cfg))
    inputs = pb.model_inputs()
    worst, packed_launches, alone_launches = 0.0, 0, 0
    with torch.inference_mode():
        for r in range(rows):
            flash_attention.launches = 0
            out = on_card.apply(params, {}, torch.from_numpy(inputs[r:r + 1]).to(ZOO_DEVICE))[0][0]
            packed_launches += flash_attention.launches
            for seg in range(1, int(pb.segment_ids[r].max()) + 1):
                sel = torch.from_numpy(pb.segment_ids[r] == seg).to(ZOO_DEVICE)
                tokens = torch.from_numpy(pb.tokens[r][pb.segment_ids[r] == seg])[None]
                flash_attention.launches = 0
                alone = twin.apply(params, {}, tokens.to(ZOO_DEVICE))[0][0]
                alone_launches += flash_attention.launches
                worst = max(worst, float((out[sel] - alone).abs().max()))
            del out

    x, y = inputs[:train_rows], pb.labels[:train_rows]
    real_tokens = int((pb.segment_ids[:train_rows] != 0).sum())
    trainer = tdk.DOWNPOUR(
        packed, loss="masked_token_crossentropy", metrics=(),
        worker_optimizer=("adam", {"learning_rate": 2e-4}), num_workers=TRAIN_WORKERS,
        batch_size=TRAIN_BATCH, communication_window=TRAIN_WINDOW, num_epoch=PACK_EPOCHS,
        seed=seed, device=ZOO_DEVICE)
    if ZOO_DEVICE == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.launches = 0
    trainer.train(tdk.from_numpy(x, y))
    if ZOO_DEVICE == "cuda":
        torch.cuda.synchronize()
    train_launches = [c.launches for c in counters]
    history = trainer.get_history()
    row = dict(model="TransformerLM", packed=True, **cfg, sequences=len(seqs), width=PACK_WIDTH,
               rows=rows, lengths=[int(min(map(len, seqs))), int(max(map(len, seqs)))],
               real_tokens=pb.total_tokens, efficiency=pb.efficiency,
               fixed_width_padding_fraction=1.0 - pb.total_tokens / (len(seqs) * PACK_WIDTH),
               pack_ms=pack_ms, max_abs_err_packed_vs_alone=worst, atol=PACK_LOGITS_ATOL,
               launches_packed_forward=packed_launches, launches_alone=alone_launches,
               expected_launches_alone=cfg["num_layers"] * len(seqs),
               train=dict(trainer="DOWNPOUR", loss_fn="masked_token_crossentropy",
                          workers=TRAIN_WORKERS, batch_size=TRAIN_BATCH, window=TRAIN_WINDOW,
                          epochs=PACK_EPOCHS, rows=train_rows, real_tokens=real_tokens,
                          loss=history["loss"], seconds=history["training_time"],
                          real_tokens_per_s=PACK_EPOCHS * real_tokens / history["training_time"],
                          peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
                          num_updates=trainer.num_updates, launches_b1_b2_b3=train_launches),
               card=CARD)
    emit(phase="packing", **row)
    if worst > PACK_LOGITS_ATOL:
        raise AssertionError(f"packing: packed and alone logits differ by {worst}")
    if packed_launches or any(train_launches):
        raise AssertionError(f"packing: the packed path launched a kernel: forward "
                             f"{packed_launches}, training {train_launches}")
    want = row["expected_launches_alone"] if ZOO_DEVICE == "cuda" else 0
    if alone_launches != want:
        raise AssertionError(f"packing: B1 launched {alone_launches} times alone, expected {want}")
    if not np.isfinite(history["loss"]).all():
        raise AssertionError(f"packing: loss not finite: {history['loss']}")
    return row


def _timer(seconds: dict, t0: float, who: str = "chip_smoke"):
    """A ``timed(name, fn, *args)`` that calls ``fn(*args)``, keeps its wall
    seconds in ``seconds[name]`` and prints them, on standard error too
    (with the seconds since ``t0``), so that a run cut short still shows
    how far it got; then frees what the phase left in the allocator's
    cache."""
    import gc

    def timed(name, fn, *args):
        t = time.perf_counter()
        try:
            return fn(*args)
        finally:
            seconds[name] = time.perf_counter() - t
            emit(phase="timing", of=name, seconds=seconds[name])
            print(f"{who}: {name} {seconds[name]:.1f} s, "
                  f"{time.perf_counter() - t0:.1f} s since the build began",
                  file=sys.stderr, flush=True)
            gc.collect()
            if torch.cuda.is_initialized():
                torch.cuda.empty_cache()

    return timed


# phases 19 to 24, in this order, in the gloo lane's process
LANE_PHASES = ("seq", "tp", "serving_tp", "moe", "pipeline", "pipeline_3d")
LANE_TIMEOUT_S = 1100  # the lane's whole run, set-up included


def gloo_lane(seed: int, timed) -> dict:
    """Phases 19 to 24 in turn through ``timed``: each phase's row that the
    kernels line reads, by phase."""
    pipeline = {}

    def pipeline_3d(seed):
        # phase 24's reference is phase 23's one-rank run when their models agree
        ref = (pipeline["one_rank"] if _pp3d_model() == PP_MODEL
               else _pp_one_rank(seed, 1, _pp3d_model()))
        return pipeline_3d_phase(seed, ref)

    def pipeline_run(seed):
        pipeline.update(pipeline_phase(seed))
        return pipeline

    phases = {
        "seq": (lambda s: seq_phase(s, seq_train(s, 1)[1]), "two_ranks_one_card"),
        "tp": (lambda s: tp_phase(s, tp_train(s, TRAIN_EPOCHS)[1]), "two_ranks_one_card"),
        "serving_tp": (serving_tp_phase, "two_ranks_one_card"),
        "moe": (moe_phase, None),
        "pipeline": (pipeline_run, "two_ranks_one_card"),
        "pipeline_3d": (pipeline_3d, "four_ranks_one_card"),
    }
    out = {}
    for name in LANE_PHASES:
        fn, key = phases[name]
        got = timed(name, fn, seed)
        out[name] = got if key is None else got[key]
    return out


def _die_with(parent: int):
    """End this process's group (itself and every rank it spawned) once
    ``parent`` is gone, however it ended: the lane runs in a session of its
    own, which a signal to the parent's group does not reach."""
    import os
    import signal
    import threading

    def watch():
        while os.getppid() == parent:
            time.sleep(1.0)
        os.killpg(0, signal.SIGKILL)

    threading.Thread(target=watch, name="chip_smoke-lane-watch", daemon=True).start()


def gloo_lane_main(spec_path: str) -> int:
    """The gloo lane's process: the parent's seed, card line and thread
    count from ``spec_path``; :func:`gloo_lane`; its rows and phase seconds
    written as JSON to the spec's ``out`` (tensors left out)."""
    with open(spec_path, encoding="utf-8") as fh:
        spec = json.load(fh)
    _die_with(spec["parent"])
    global CARD
    CARD = spec["card"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(spec["threads"])
    seconds = {}
    rows = gloo_lane(spec["seed"], _timer(seconds, spec["t0"], "chip_smoke gloo lane"))
    with open(spec["out"], "w", encoding="utf-8") as fh:
        json.dump(dict(rows=rows, seconds=seconds), fh,
                  default=lambda o: None if isinstance(o, torch.Tensor) else repr(o))
    return 0


class GlooLane:
    """Phases 19 to 24 in a process of this script (``--gloo-lane``) in a
    session of its own, so that :meth:`stop` ends it and every rank it
    spawned; its standard output goes to a file that :meth:`result` copies
    to this process's, its standard error straight through."""

    def __init__(self, seed: int, t0: float):
        import os
        import tempfile

        self._dir = tempfile.TemporaryDirectory(prefix="chip_smoke_lane_")
        spec = dict(seed=seed, card=CARD, out=os.path.join(self._dir.name, "rows.json"),
                    parent=os.getpid(),
                    # the lane shares the host's cores with this process
                    threads=max(1, torch.get_num_threads() // 2),
                    # the parent's clock: perf_counter is one clock across the machine
                    t0=t0)
        path = os.path.join(self._dir.name, "spec.json")
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(spec, fh)
        self._out = spec["out"]
        self._log = open(os.path.join(self._dir.name, "stdout.txt"), "w+", encoding="utf-8")
        self._proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--gloo-lane", path],
            stdout=self._log, cwd=os.path.dirname(os.path.abspath(__file__)),
            start_new_session=True)

    def result(self, timeout: float) -> tuple:
        """Wait for the lane (``timeout`` seconds at most), copy its rows to
        standard output and return ``(rows by phase, seconds by phase)``;
        raises if it failed or ran late."""
        try:
            rc = self._proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            raise AssertionError(f"the gloo lane ran past {timeout} s") from None
        self._log.seek(0)
        sys.stdout.write(self._log.read())
        sys.stdout.flush()
        if rc != 0:
            raise AssertionError(f"the gloo lane (phases 19 to 24) exited {rc}: see its "
                                 "rows above and its standard error")
        with open(self._out, encoding="utf-8") as fh:
            got = json.load(fh)
        return got["rows"], got["seconds"]

    def stop(self):
        """End the lane and every rank it spawned, if still running."""
        import os
        import signal

        if self._proc.poll() is None:
            try:
                os.killpg(self._proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            self._proc.wait()
        self._log.close()
        self._dir.cleanup()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _nccl_cards() -> int:
    """The NCCL ranks, one a card, of the several-card rows of phases 19 to
    22: 4 on a machine with 4 cards or more (their 2 x 2 grids), 2 on one
    with 2 or 3 (the 1 x 2 grids), 0 on one card (NCCL refuses two ranks on
    one card)."""
    count = torch.cuda.device_count() if ZOO_DEVICE == "cuda" else 1
    return 4 if count >= 4 else 2 if count >= 2 else 0


NCCL_CARDS_REASON = ("the several-card NCCL grid needs torch.cuda.device_count() >= 2 "
                     "(NCCL refuses two ranks on one card)")


def _captures_here() -> bool:
    """Whether this spawned rank's group runs NCCL, whose collectives a
    captured window or serving step holds: the rows of phases 19 to 22 then
    run their captured twins too."""
    import torch.distributed as dist

    return dist.get_backend() == "nccl"


def _graph_record(engine) -> dict:
    """A trained engine's captured windows: captures and replays, and each
    kernel's (B1-B3) and collective's capture ticks and ticks x replays."""
    return dict(graph_stats=dict(engine.graph_stats),
                graph_launches={k: list(v) for k, v in engine.graph_launches().items()})


def _steady_epoch(trainer, x, y, tokens: int, workers: int = None) -> dict:
    """One more epoch on the trained engine and state (captured windows
    replayed, none captured), timed to its stats' read-back: s, tokens/s
    (``workers``: the trainer's, by default the train phase's)."""
    from distkeras_tpu_torch.data import epoch_arrays

    engine, state, _ = trainer.fit_result
    workers = TRAIN_WORKERS if workers is None else workers
    xs, ys = engine.shard_batches(*epoch_arrays(x, y, workers, TRAIN_BATCH, TRAIN_WINDOW))
    t0 = time.perf_counter()
    engine.run_epoch(state, xs, ys)  # ends on the stats' copy to the host
    seconds = time.perf_counter() - t0
    return dict(steady_seconds=seconds, steady_tokens_per_s=tokens / seconds)


def _captured_row(graph: dict, eager: dict, steps: int, epochs: int) -> tuple:
    """A run in captured windows (``unroll=True``) against the same run
    eager in this call, on the same ranks: bitwise?, captures and replays,
    B1-B3's capture ticks and ticks x replays (each replay launches what was
    recorded once: the eager run's count), the collectives in the graphs,
    tokens/s and ms a local step (``steps`` of them an epoch, ``epochs``
    epochs) both ways, whole and in one steady epoch.  Returns ``(row, failures)``; the caller holds a
    run that is not bitwise to the phase's gates against one rank."""
    from distkeras_tpu_torch.ops import (
        flash_attention,
        flash_attention_bwd_dkv,
        flash_attention_bwd_dq,
    )
    from distkeras_tpu_torch.parallel.mesh import TRANSPORTS

    names = [c.__name__ for c in (flash_attention, flash_attention_bwd_dq, flash_attention_bwd_dkv)]
    launches = graph["graph_launches"]
    got = lambda n: launches.get(n, [0, 0])
    row = dict(vs_eager=_versus(graph, eager), graph_stats=graph["graph_stats"],
               launches_b1_b2_b3_ticks=[got(n)[0] for n in names],
               launches_b1_b2_b3_ticks_x_replays=[got(n)[1] for n in names],
               launches_b1_b2_b3_eager=list(eager["launches"]),
               collectives_ticks_and_ticks_x_replays={n: got(n) for n in TRANSPORTS},
               tokens_per_s=graph["tokens_per_s"], tokens_per_s_eager=eager["tokens_per_s"],
               step_ms=graph["seconds"] * 1e3 / (steps * epochs),
               step_ms_eager=eager["seconds"] * 1e3 / (steps * epochs),
               steady_tokens_per_s=graph["steady_tokens_per_s"],
               steady_tokens_per_s_eager=eager["steady_tokens_per_s"],
               steady_step_ms=graph["steady_seconds"] * 1e3 / steps,
               steady_step_ms_eager=eager["steady_seconds"] * 1e3 / steps,
               timed_as="host clock to the stats' read-back; the whole run includes the "
                        "warm-up window and the capture, the steady epoch neither")
    failures = []
    if not (graph["graph_stats"]["captures"] >= 1 and graph["graph_stats"]["replays"] >= 1):
        failures.append(f"no window was captured: {graph['graph_stats']}")
    if row["launches_b1_b2_b3_ticks_x_replays"] != row["launches_b1_b2_b3_eager"]:
        failures.append(f"B1-B3 ran {row['launches_b1_b2_b3_ticks_x_replays']} times in the "
                        f"graphs, eagerly {row['launches_b1_b2_b3_eager']}")
    return row, failures


def _rendezvous(workdir: str, name: str) -> str:
    """The ``init_method`` of one group of spawned ranks: a file store in the
    phase's own work directory.  A TCP port picked free by the parent and
    bound by rank 0 only once it has imported torch could be taken by any
    other process in between; a path in a fresh directory cannot."""
    import os

    return "file://" + os.path.join(workdir, f"{name}.rendezvous")


def _mesh_frame(seed: int):
    """The epochs phase's cifar_cnn_downpour rows: ``(x, y)``."""
    batch, shape = _epochs_config()[4], _epochs_config()[5]
    return zoo_data(shape, False, 10, ZOO_WORKERS * EPOCHS_WINDOWS * ZOO_WINDOW * batch, seed)


def _mesh_runs(seed: int) -> dict:
    """cifar_cnn_downpour with MESH_WORKERS workers over whatever group this
    process is in (none: one rank): one window in f32, and the bf16 run of
    2 epochs.  Returns the runs and their commit counts."""
    import distkeras_tpu_torch as tdk

    x, y = _mesh_frame(seed)
    one_window = MESH_WORKERS * ZOO_WINDOW * _epochs_config()[4]
    out = {}
    for name, rows, kwargs in (("f32", one_window, dict(num_epoch=1, compute_dtype=None)),
                               ("bf16", len(x), {})):
        trainer = _cifar_trainer(seed, num_workers=MESH_WORKERS, **kwargs)
        # deterministic convolutions: cuDNN's default choice for f32 may sum a
        # weight gradient with atomics, and then no two runs agree, whatever
        # the ranks (the workers' own steps must be the same at one rank and
        # at two for the commit's sum order to be all that differs)
        with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                        allow_tf32=False):
            run = _trained(trainer, tdk.from_numpy(x[:rows], y[:rows]))
        engine = trainer.fit_result[0]
        run.update(num_updates=trainer.num_updates, ranks=engine.ranks, rows=rows,
                   samples_per_s=len(run["loss"]) * rows / run["seconds"])
        out[name] = run
        del trainer, engine
    return out


def mesh_rank_main(spec_path: str) -> int:
    """One spawned rank of the mesh phase: the settings of the parent (its
    device, sizes and configuration) from ``spec_path``, the group joined,
    :func:`_mesh_runs`, the group left on every path; rank 0 writes the
    runs next to the spec."""
    import torch.distributed as dist

    global ZOO_DEVICE, ZOO_WINDOW, EPOCHS_WINDOWS, ZOO_EPOCHS, ZOO_CONFIGS
    with open(spec_path, encoding="utf-8") as fh:
        spec = json.load(fh)
    ZOO_DEVICE, ZOO_WINDOW = spec["device"], spec["window"]
    EPOCHS_WINDOWS, ZOO_EPOCHS = spec["windows"], spec["epochs"]
    config = list(spec["config"])  # JSON made the tuples lists
    config[5] = tuple(config[5])
    config[8] = None if config[8] is None else tuple(config[8])
    ZOO_CONFIGS = [tuple(config)]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(spec["threads"])
    if ZOO_DEVICE == "cuda":
        torch.cuda.set_device(spec["device_index"])
    dist.init_process_group(spec["backend"], init_method=spec["init"],
                            world_size=spec["world"], rank=spec["rank"])
    try:
        runs = _mesh_runs(spec["seed"])
    finally:
        _leave_group()
    if spec["rank"] == 0:
        torch.save(runs, spec["out"])
    return 0


def _leave_group() -> None:
    """A spawned rank leaves its group through ``networking.shutdown``,
    which first frees the CUDA graphs that recorded NCCL collectives: NCCL
    does not destroy a communicator a live graph uses, and the rank would
    hang in ``destroy_process_group``."""
    from distkeras_tpu_torch import networking

    networking.shutdown()


def _run_ranks(flag: str, specs, workdir: str, timeout: int, phase: str):
    """Spawn one process of this script per spec (``flag SPEC.json``), all
    at once, and wait for all of them, ``timeout`` seconds at most.  A rank
    that fails, or is still running then, fails the phase with the end of
    every rank's output (a late rank's with every thread's stack, dumped on
    ``SIGUSR1`` before the kill), and no rank outlives it."""
    import gc
    import os
    import signal

    gc.collect()
    if torch.cuda.is_initialized():
        torch.cuda.empty_cache()  # the ranks share this card
    procs, logs, late = [], [], False
    try:
        for spec in specs:
            path = os.path.join(workdir, f"spec_{spec['backend']}_{spec['world']}_"
                                f"{spec['rank']}.json")
            with open(path, "w", encoding="utf-8") as fh:
                json.dump(spec, fh)
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), flag, path],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                cwd=os.path.dirname(os.path.abspath(__file__))))
        deadline = time.monotonic() + timeout
        for p in procs:
            try:
                logs.append(p.communicate(timeout=max(0.0, deadline - time.monotonic()))[0])
            except subprocess.TimeoutExpired:
                late = True
                break
    finally:
        if late:
            for p in procs:
                if p.poll() is None:
                    p.send_signal(signal.SIGUSR1)
            time.sleep(5)
        for p in procs:
            if p.poll() is None:
                p.kill()
        logs += [p.communicate()[0] for p in procs[len(logs):]]
    tails = "".join(f"\n--- rank {spec['rank']} (exit {p.returncode}):\n{log[-6000:]}"
                    for spec, p, log in zip(specs, procs, logs))
    if late:
        raise AssertionError(f"{phase}: a rank ran past {timeout} s; every rank's output:{tails}")
    for spec, p in zip(specs, procs):
        if p.returncode != 0:
            raise AssertionError(f"{phase}: rank {spec['rank']} of {spec['world']} "
                                 f"({spec['backend']}) exited {p.returncode}:{tails}")


def _spawn_mesh(seed: int, world: int, backend: str, cards: bool, workdir: str) -> dict:
    """Spawn ``world`` ranks of this script (``--mesh-rank``), each on
    ``cuda:0`` or, with ``cards``, on ``cuda:<rank>``; wait for all of them
    and return rank 0's runs."""
    import os

    name = f"mesh_{backend}_{world}"
    init, out = _rendezvous(workdir, name), os.path.join(workdir, name + ".pt")
    specs = [dict(seed=seed, device=ZOO_DEVICE, window=ZOO_WINDOW, windows=EPOCHS_WINDOWS,
                  epochs=ZOO_EPOCHS, config=list(_epochs_config()), backend=backend,
                  world=world, rank=rank, init=init, out=out,
                  device_index=rank if cards else 0,
                  # the parent's: on the CPU the thread count changes the
                  # convolutions' sums, which this run amplifies
                  threads=torch.get_num_threads())
             for rank in range(world)]
    _run_ranks("--mesh-rank", specs, workdir, MESH_RANK_TIMEOUT_S, "mesh")
    return torch.load(out)


# phase 18 (a)'s transports captured over the one-rank NCCL group: a
# [1024, 768] f32 block (a GPT-2-small row's activations) and an int64
# vector, each transport recorded into one graph, replayed on two input sets
MESH_TRANSPORT_SHAPE = (1024, 768)
MESH_TRANSPORT_TICKS = {"all_reduce": 2, "broadcast": 1, "all_gather": 1, "reduce_scatter": 1,
                        "shift": 2}


def _captured_transports(group) -> dict:
    """Each transport of ``parallel/mesh.py`` over ``group``: eager, then
    recorded into one CUDA graph (its communicator made first) and replayed
    on two sets of inputs copied into the graph's input buffers; whether each
    transport's replayed outputs equal its eager ones bit for bit, whether
    the two input sets give different outputs, the transports' counts at
    the capture and the ms of one eager pass and one replay (CUDA events).
    On one rank the ring hop is ``_shift``'s send to itself
    (``ppermute`` short-circuits an axis of one rank)."""
    import torch.distributed as dist

    from distkeras_tpu_torch.parallel.mesh import (
        TRANSPORTS,
        Axis,
        _gather,
        _reduce_scatter,
        _shift,
        all_reduce_sum,
        broadcast,
        transport_stats,
    )
    from distkeras_tpu_torch.utils import graphs

    size, index = dist.get_world_size(group), dist.get_rank(group)
    ax = Axis("ring", group, index, size)
    gen = torch.Generator().manual_seed(31 + index)
    sets = [(torch.randn(MESH_TRANSPORT_SHAPE, generator=gen),
             torch.randint(0, 1 << 40, (4096,), generator=gen)) for _ in range(2)]
    x = torch.zeros(MESH_TRANSPORT_SHAPE, device="cuda")
    n = torch.zeros(4096, dtype=torch.int64, device="cuda")

    def body():
        flat = x.reshape(-1)
        return {"all_reduce": all_reduce_sum([x, n], group),
                "broadcast": broadcast([2 * x], 0, group),
                "all_gather": [_gather(x, ax)],
                "reduce_scatter": [_reduce_scatter(x, ax, 0)],
                "shift": [_shift(flat, ax, 1), _shift(flat, ax, -1)]}

    def run(step):
        outs = []
        for a, b in sets:
            x.copy_(a)
            n.copy_(b)
            outs.append({k: [t.clone() for t in v] for k, v in step().items()})
        return outs

    eager = run(body)
    with graphs.CAPTURE_LOCK:
        graphs.warm_up_groups([group], "cuda")
        graphs.warm_up(body, "cuda")
        graph = torch.cuda.CUDAGraph()
        before = {k: transport_stats[k] for k in TRANSPORTS}
        with graphs.capturing(graph):
            static = body()
        ticks = {k: transport_stats[k] - before[k] for k in TRANSPORTS}

    def replay():
        graph.replay()
        return static

    captured = run(replay)
    same = {k: all(torch.equal(c, e) for got, want in zip(captured, eager)
                   for c, e in zip(got[k], want[k])) for k in static}
    moved = all(not torch.equal(eager[0][k][0], eager[1][k][0]) for k in static)
    return dict(group_size=size, shape=list(MESH_TRANSPORT_SHAPE), bitwise=same,
                inputs_change_outputs=moved, ticks=ticks,
                eager_ms=cuda_ms(body, 10), replay_ms=cuda_ms(graph.replay, 10))


def _gspmd_fsdp_captured(seed: int, frame) -> dict:
    """``cifar_cnn_downpour`` with ``fsdp=True`` (the GSPMD engine) over the
    one-rank NCCL mesh, eager and in captured windows, cuDNN deterministic
    (as the spawned mesh runs): the captured run against the eager one, the
    engine, its captures and replays and the collectives its graphs hold,
    ticks and ticks x replays.  One workers rank splits no center leaf: the
    fsdp gather short-circuits, and the graphs hold the commit's
    all-reduces."""
    from distkeras_tpu_torch.parallel.mesh import TRANSPORTS
    from distkeras_tpu_torch.utils.pytree import tree_leaves

    runs, engines = {}, {}
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=False):
        for name, kwargs in (("eager", {}), ("graph", dict(unroll=True))):
            trainer = _cifar_trainer(seed, fsdp=True, **kwargs)
            runs[name] = _trained(trainer, frame)
            engines[name] = trainer.fit_result[0]
            del trainer
    graph = engines["graph"]
    launches = graph.graph_launches()
    return dict(engine=type(graph).__name__, fsdp=graph.fsdp, use_graphs=graph.use_graphs,
                eager_use_graphs=engines["eager"].use_graphs, workers_ranks=graph.n_dev,
                center_leaves_split=sum(d >= 0 for d in tree_leaves(graph._fsdp_dims)),
                graph_stats=dict(graph.graph_stats),
                collectives_ticks_and_ticks_x_replays={n: list(launches[n]) for n in TRANSPORTS},
                vs_eager=_versus(runs["graph"], runs["eager"]),
                samples_per_s=ZOO_EPOCHS * len(frame) / runs["graph"]["seconds"],
                samples_per_s_eager=ZOO_EPOCHS * len(frame) / runs["eager"]["seconds"])


def _mesh_versus(got: dict, want: dict) -> dict:
    """A spawned run against the one-rank run, and the phase's gates."""
    f32 = _versus(got["f32"], want["f32"])
    bf16 = _versus(got["bf16"], want["bf16"])
    row = dict(ranks=got["f32"]["ranks"], f32_vs_one_rank=f32, bf16_vs_one_rank=bf16,
               num_updates=[got["f32"]["num_updates"], got["bf16"]["num_updates"]],
               num_updates_one_rank=[want["f32"]["num_updates"], want["bf16"]["num_updates"]],
               bf16_loss=got["bf16"]["loss"], samples_per_s=got["bf16"]["samples_per_s"],
               samples_per_s_one_rank=want["bf16"]["samples_per_s"],
               f32_param_atol=MESH_F32_PARAM_ATOL, bf16_loss_rtol=MESH_BF16_LOSS_RTOL,
               bf16_param_rel_norm_rtol=MESH_BF16_PARAM_RTOL)
    failures = []
    if row["num_updates"] != row["num_updates_one_rank"]:
        failures.append("commit counts differ")
    if not f32["max_param_err"] <= MESH_F32_PARAM_ATOL:
        failures.append(f"f32 first window's center off by {f32['max_param_err']}")
    if not (bf16["loss_rel_err"] <= MESH_BF16_LOSS_RTOL
            and bf16["param_rel_norm_err"] <= MESH_BF16_PARAM_RTOL):
        failures.append(f"bf16 run off: {bf16}")
    if not np.isfinite(got["bf16"]["loss"]).all():
        failures.append("bf16 loss not finite")
    return row, failures


def mesh_phase(seed: int, eager_run, frame, train_launches, train_run) -> dict:
    """Training over meshes: (a) one NCCL rank through ``networking.initialize``
    and ``make_mesh()``, cifar_cnn_downpour bitwise the epochs phase's
    no-mesh run (eager, and captured windows whose commit all-reduce sits in
    the graph, within the epochs phase's gates), and the train phase's
    GPT-2-small ``DOWNPOUR`` launching B1-B3 as often as there; (b) two
    ranks sharing the card over gloo (NCCL refuses two ranks on one card),
    spawned, cifar_cnn_downpour with 4 workers against one rank with 4;
    (c) on a machine with several cards, ``min(4, count)`` NCCL ranks, one
    a card; (d) ``ModelPredictor`` over every card, and over two replicas
    on one card, against ``num_devices=1``."""
    import tempfile

    import torch.distributed as dist

    import distkeras_tpu_torch as tdk
    from distkeras_tpu_torch import networking
    from distkeras_tpu_torch.ops import (
        flash_attention,
        flash_attention_bwd_dkv,
        flash_attention_bwd_dq,
    )
    from distkeras_tpu_torch.parallel import make_mesh

    counters = (flash_attention, flash_attention_bwd_dq, flash_attention_bwd_dkv)
    out = {}
    # (a) one rank over NCCL (gloo on a CPU rehearsal)
    networking.initialize(f"127.0.0.1:{_free_port()}", 1, 0, device=ZOO_DEVICE)
    try:
        mesh = make_mesh()
        row = dict(case="one_rank", backend=dist.get_backend(), mesh=type(mesh).__name__,
                   mesh_dim_names=list(mesh.mesh_dim_names), ranks=mesh.size())
        trainer = _cifar_trainer(seed)
        run = _trained(trainer, frame)
        engine = trainer.fit_result[0]
        row.update(engine_group=engine.group is not None, vs_no_mesh=_versus(run, eager_run),
                   samples_per_s=ZOO_EPOCHS * len(frame) / run["seconds"])
        del trainer, engine
        trainer = _cifar_trainer(seed, unroll=True)
        run = _trained(trainer, frame)
        engine = trainer.fit_result[0]
        row.update(graph=dict(use_graphs=engine.use_graphs, stats=dict(engine.graph_stats),
                              vs_no_mesh_eager=_versus(run, eager_run)))
        del trainer, engine
        if ZOO_DEVICE == "cuda":
            _, trainer, x, y = _gpt2_downpour(seed)
            for c in counters:
                c.launches = 0
            lm = _trained(trainer, tdk.from_numpy(x, y))
            row.update(lm=dict(launches=[c.launches for c in counters],
                               launches_train_phase=list(train_launches.values()),
                               engine_group=trainer.fit_result[0].group is not None,
                               vs_train_phase=_versus(lm, train_run)))
            del trainer
            row["transports_captured"] = _captured_transports(dist.group.WORLD)
            row["gspmd_fsdp_captured"] = _gspmd_fsdp_captured(seed, frame)
    finally:
        networking.shutdown()
    row["card"] = CARD
    emit(phase="mesh", **row)
    out["one_rank"] = row
    if not (row["vs_no_mesh"]["bitwise"] and row["engine_group"]):
        raise AssertionError(f"mesh: one NCCL rank is not the no-mesh run: {row}")
    graph = row["graph"]["vs_no_mesh_eager"]
    if ZOO_DEVICE == "cuda" and not row["graph"]["use_graphs"]:
        raise AssertionError("mesh: unroll=True did not capture over the one-rank mesh")
    if graph["loss_rel_err"] > GRAPH_LOSS_RTOL or graph["max_param_err"] > GRAPH_PARAM_ATOL:
        raise AssertionError(f"mesh: the captured windows differ from eager: {graph}")
    if "lm" in row and (row["lm"]["launches"] != row["lm"]["launches_train_phase"]
                        or not row["lm"]["engine_group"]):
        raise AssertionError(f"mesh: the GPT-2 DOWNPOUR over the mesh: {row['lm']}")
    if "transports_captured" in row:
        got = row["transports_captured"]
        if not (all(got["bitwise"].values()) and got["inputs_change_outputs"]
                and got["ticks"] == MESH_TRANSPORT_TICKS):
            raise AssertionError(f"mesh: the transports captured over one NCCL rank: {got}")
        got = row["gspmd_fsdp_captured"]
        reduces = got["collectives_ticks_and_ticks_x_replays"]["all_reduce"]
        if not (got["engine"] == "GSPMDEngine" and got["fsdp"] and got["use_graphs"]
                and not got["eager_use_graphs"] and got["graph_stats"]["captures"] >= 1
                and reduces[0] >= 1 and reduces[1] == reduces[0] * got["graph_stats"]["replays"]
                and got["vs_eager"]["bitwise"]):
            raise AssertionError(f"mesh: GSPMD fsdp captured over one NCCL rank: {got}")

    # (b) two ranks on the one card, and (c) one rank a card
    one_rank = _mesh_runs(seed)
    count = torch.cuda.device_count() if ZOO_DEVICE == "cuda" else 1
    with tempfile.TemporaryDirectory() as workdir:
        got = _spawn_mesh(seed, 2, "gloo", False, workdir)
        row, failures = _mesh_versus(got, one_rank)
        row = dict(case="two_ranks_one_card", backend="gloo", **row, card=CARD)
        emit(phase="mesh", **row)
        out["two_ranks"] = row
        if failures:
            raise AssertionError(f"mesh: two ranks on one card: {failures}")
        if count > 1:
            world = min(4, count)
            got = _spawn_mesh(seed, world, "nccl", True, workdir)
            row, failures = _mesh_versus(got, one_rank)
            row = dict(case="cards", backend="nccl", mesh_cards_run=world, **row, card=CARD)
            emit(phase="mesh", **row)
            out["cards"] = row
            if failures:
                raise AssertionError(f"mesh: {world} cards: {failures}")
        else:
            emit(phase="mesh", case="cards", mesh_cards_run=1,
                 reason="this machine has one card: the several-card run needs "
                        "torch.cuda.device_count() > 1", card=CARD)

    # (d) the predictor over the cards, and two replicas on one card
    from distkeras_tpu_torch.models import zoo

    x, _ = _mesh_frame(seed)
    rows = tdk.from_numpy(x[:MESH_PREDICT_ROWS])
    _, _, model_name, model_kw, batch = _epochs_config()[:5]
    model = getattr(zoo, model_name)(**model_kw, generator=torch.Generator().manual_seed(seed))
    ref = tdk.ModelPredictor(model, batch_size=batch, num_devices=1, device=ZOO_DEVICE)
    want = ref.predict(rows)["prediction"]
    row = dict(case="predictor", rows=MESH_PREDICT_ROWS, batch_size=batch, atol=MESH_PREDICT_ATOL,
               card=CARD)
    for name, kwargs in (("all_cards", dict(num_devices=count, device=ZOO_DEVICE)),
                         ("two_replicas_one_card", dict(num_devices=2, device=[ZOO_DEVICE] * 2))):
        pred = tdk.ModelPredictor(model, batch_size=batch, **kwargs)
        got = pred.predict(rows)["prediction"]
        row[name] = dict(num_devices=pred.n_dev, mode=pred.last_mode,
                         max_abs_err=float(np.abs(got - want).max()))
    emit(phase="mesh", **row)
    out["predictor"] = row
    if row["two_replicas_one_card"]["mode"] != "distributed":
        raise AssertionError(f"mesh: the predictor did not split the rows: {row}")
    for name in ("all_cards", "two_replicas_one_card"):
        if not row[name]["max_abs_err"] <= MESH_PREDICT_ATOL:
            raise AssertionError(f"mesh: predictor {name} off: {row[name]}")
    return out


# sequence-parallel phase: the train phase's DOWNPOUR over a GPT-2-small
# TransformerLM(seq_axis="seq") on the (workers, seq) grid, 2 seq ranks.
# Cut in depth to 6 of GPT-2 small's 12 blocks and to one epoch of the train
# phase's two, widths kept, against a one-rank run of the same cut in this
# process: the two ranks on one card move every step's gradients and ring
# hops through the host, and the cut keeps the whole script under 950 s
SEQ_MODEL = dict(GPT2_SMALL, num_layers=6)
SEQ_EPOCHS = 1
SEQ_SHARDS, SEQ_RANK_TIMEOUT_S = 2, 900
# The first window's loss, before any commit: the same arithmetic up to the
# order of the products (the ring's plain f32 products against B1-B3's
# 3xTF32), so f32 round-off alone.
SEQ_FIRST_LOSS_RTOL = 1e-5
# The loss history and the center, 2 seq ranks against one rank: JAX's own
# bounds for sequence parallelism against data parallelism
# (tests/test_lm.py:97-101): losses within 2e-4 relative; parameters within
# 5e-3 relative, held here as the center's relative norm error.  Adam
# (lr 2e-4, 16 steps a worker) turns round-off in the exactly-zero gradient
# of the key bias into steps of up to lr, which JAX's bound allows for.
SEQ_LOSS_RTOL, SEQ_PARAM_REL_NORM = 2e-4, 5e-3
SEQ_CLS_ROWS, SEQ_CLS_ATOL = 4, PACK_LOGITS_ATOL  # the classifier's logits, 2 ranks vs B1
SEQ_PREDICT_ROWS = 2  # the twin's ModelPredictor rows (per-token outputs of 50257)
SEQ_RING_ITERS = 10


def _seq_cls_inputs(seed: int):
    x = np.random.default_rng(seed + 11).integers(
        0, SEQ_MODEL["vocab_size"], (SEQ_CLS_ROWS, SEQ_MODEL["max_len"]))
    return x.astype(np.int32)


def seq_train(seed: int, seq_shards: int, **kwargs):
    """The train phase's ``DOWNPOUR`` over ``SEQ_MODEL`` (seq_axis="seq"
    when ``seq_shards > 1``), 2 workers, batch 4, window 2, Adam, on the
    train phase's task, for ``SEQ_EPOCHS`` epochs: ``(trainer, run)``."""
    import distkeras_tpu_torch as tdk
    from distkeras_tpu_torch.models import TransformerLM

    model = TransformerLM(**SEQ_MODEL, seq_axis="seq" if seq_shards > 1 else None,
                          generator=torch.Generator().manual_seed(seed + 2))
    x, y = lm_task(TRAIN_ROWS, SEQ_MODEL["max_len"], SEQ_MODEL["vocab_size"], seed + 2)
    trainer = _keeping_fit(tdk.DOWNPOUR)(
        model, loss="token_crossentropy", metrics=("token_accuracy",),
        worker_optimizer=("adam", {"learning_rate": 2e-4}), num_workers=TRAIN_WORKERS,
        batch_size=TRAIN_BATCH, communication_window=TRAIN_WINDOW, num_epoch=SEQ_EPOCHS,
        seed=seed, device=ZOO_DEVICE, seq_shards=seq_shards, **kwargs)
    run = _trained(trainer, tdk.from_numpy(x, y))
    run.update(first_window_loss=trainer.window_losses[0],
               tokens_per_s=SEQ_EPOCHS * TRAIN_ROWS * SEQ_MODEL["max_len"] / run["seconds"])
    return trainer, run


def _ring_ms_per_layer(batch: int, mesh) -> float:
    """One layer's ring attention forward at the training shape (this
    rank's block of a ``[batch, max_len]`` row), host clock around
    synchronised runs: the hop crosses the host on gloo."""
    from distkeras_tpu_torch.parallel import ring_attention

    heads = SEQ_MODEL["heads"]
    shape = (batch, SEQ_MODEL["max_len"] // SEQ_SHARDS, heads, SEQ_MODEL["dim"] // heads)
    gen = torch.Generator(device=ZOO_DEVICE).manual_seed(0)
    q, k, v = (torch.randn(shape, generator=gen, device=ZOO_DEVICE) for _ in range(3))
    sync = torch.cuda.synchronize if ZOO_DEVICE == "cuda" else (lambda: None)
    with torch.no_grad():
        ring_attention(q, k, v, "seq", True, mesh)
        sync()
        t0 = time.perf_counter()
        for _ in range(SEQ_RING_ITERS):
            ring_attention(q, k, v, "seq", True, mesh)
        sync()
    return (time.perf_counter() - t0) / SEQ_RING_ITERS * 1e3


def _seq_runs(seed: int) -> dict:
    """One rank's share of the phase, in the grid of the group it is in:
    the SP ``DOWNPOUR`` (center replicated, then ``fsdp=True``), over NCCL
    both again in captured windows (``unroll=True``: the ring's hops, the
    pmean over seq and fsdp's gathers inside the graphs) with one steady
    epoch each way, the ring's ms a layer, the classifier's forward on this
    rank's block, and (rank 0, after the group is left) the returned twin
    through ``ModelPredictor``."""
    import torch.distributed as dist

    import distkeras_tpu_torch as tdk
    from distkeras_tpu_torch.models import TorchModel, TransformerClassifier
    from distkeras_tpu_torch.ops import (
        flash_attention,
        flash_attention_bwd_dkv,
        flash_attention_bwd_dq,
    )
    from distkeras_tpu_torch.parallel.mesh import bind_mesh, transport_stats

    counters = (flash_attention, flash_attention_bwd_dq, flash_attention_bwd_dkv)
    out = {}
    on_card = ZOO_DEVICE == "cuda"
    nccl = _captures_here()
    cases = [("sp", {}), ("fsdp", dict(fsdp=True))]
    if nccl:
        cases += [(f"{name}_graph", dict(kwargs, unroll=True)) for name, kwargs in cases]
    x, y = lm_task(TRAIN_ROWS, SEQ_MODEL["max_len"], SEQ_MODEL["vocab_size"], seed + 2)
    for name, kwargs in cases:
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        for c in counters:
            c.launches = 0
        transport_stats["host_staged_bytes"] = 0
        trainer, run = seq_train(seed, SEQ_SHARDS, **kwargs)
        engine, state, _ = trainer.fit_result
        run.update(launches=[c.launches for c in counters],
                   host_staged_bytes=transport_stats["host_staged_bytes"],
                   peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9 if on_card else None,
                   center_bytes=sum(t.numel() * t.element_size()
                                    for t in state.center_params.values()),
                   grid=list(engine.mesh.shape), num_updates=trainer.num_updates,
                   **_graph_record(engine))
        if nccl:
            run.update(_steady_epoch(trainer, x, y, TRAIN_ROWS * SEQ_MODEL["max_len"]))
        out[name] = run
        if name == "sp":  # the grid, and the model the trainer returned
            mesh, twin = engine.mesh, trainer.parameter_server.model
            out["ring_ms_per_layer"] = _ring_ms_per_layer(TRAIN_BATCH, mesh)
        del trainer, engine, state
    model = TransformerClassifier(**SEQ_MODEL, seq_axis="seq",
                                  generator=torch.Generator().manual_seed(seed + 11))
    x = _seq_cls_inputs(seed)
    block = x.shape[1] // SEQ_SHARDS
    index = dist.get_rank() % SEQ_SHARDS
    params = {k: p.detach().to(ZOO_DEVICE) for k, p in model.named_parameters()}
    for c in counters:
        c.launches = 0
    with torch.inference_mode(), bind_mesh(mesh):
        logits = TorchModel(model).apply(params, {}, torch.from_numpy(
            x[:, index * block:(index + 1) * block]).to(ZOO_DEVICE))[0]
    out["classifier"] = dict(logits=logits.float().cpu(), launches=[c.launches for c in counters])
    out["twin"] = twin
    return out


def _twin_predictor(twin, seed: int) -> dict:
    """The trained seq-free twin through ``ModelPredictor`` on the card, its
    B1 launches counted."""
    import distkeras_tpu_torch as tdk
    from distkeras_tpu_torch.ops import flash_attention

    x, _ = lm_task(SEQ_PREDICT_ROWS, SEQ_MODEL["max_len"], SEQ_MODEL["vocab_size"], seed + 2)
    flash_attention.launches = 0
    pred = tdk.ModelPredictor(twin, batch_size=SEQ_PREDICT_ROWS, num_devices=1,
                              device=ZOO_DEVICE)
    out = np.stack(pred.predict(tdk.from_numpy(x))["prediction"])
    launches = flash_attention.launches
    modules = list(twin.adapter.module.modules())
    return dict(rows=SEQ_PREDICT_ROWS, shape=list(out.shape), finite=bool(np.isfinite(out).all()),
                seq_free=all(getattr(m, "seq_axis", None) is None for m in modules),
                launches_b1=launches, expected_launches_b1=SEQ_MODEL["num_layers"]
                if ZOO_DEVICE == "cuda" else 0)


def seq_rank_main(spec_path: str) -> int:
    """One spawned rank of the sequence-parallel phase: the parent's
    settings from ``spec_path``, the group joined, :func:`_seq_runs`, the
    group left on every path; rank 0 then runs the twin's predictor and
    writes the runs next to the spec."""
    import torch.distributed as dist

    global ZOO_DEVICE, SEQ_MODEL, TRAIN_ROWS, TRAIN_BATCH, TRAIN_WORKERS, TRAIN_WINDOW
    global SEQ_EPOCHS, SEQ_CLS_ROWS, SEQ_PREDICT_ROWS
    with open(spec_path, encoding="utf-8") as fh:
        spec = json.load(fh)
    ZOO_DEVICE, SEQ_MODEL = spec["device"], spec["model"]
    TRAIN_ROWS, TRAIN_BATCH, TRAIN_WORKERS, TRAIN_WINDOW, SEQ_EPOCHS = spec["train"]
    SEQ_CLS_ROWS, SEQ_PREDICT_ROWS = spec["cls_rows"], spec["predict_rows"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(spec["threads"])
    if ZOO_DEVICE == "cuda":
        torch.cuda.set_device(spec["device_index"])
    dist.init_process_group(spec["backend"], init_method=spec["init"],
                            world_size=spec["world"], rank=spec["rank"])
    try:
        runs = _seq_runs(spec["seed"])
    finally:
        _leave_group()
    if spec["rank"] == 0:
        runs["twin"] = _twin_predictor(runs["twin"], spec["seed"])
        torch.save(runs, spec["out"])
    return 0


def _spawn_seq(seed: int, world: int, backend: str, cards: bool, workdir: str) -> dict:
    import os

    name = f"seq_{backend}_{world}"
    init, out = _rendezvous(workdir, name), os.path.join(workdir, name + ".pt")
    specs = [dict(seed=seed, device=ZOO_DEVICE, model=SEQ_MODEL, backend=backend,
                  train=[TRAIN_ROWS, TRAIN_BATCH, TRAIN_WORKERS, TRAIN_WINDOW, SEQ_EPOCHS],
                  cls_rows=SEQ_CLS_ROWS, predict_rows=SEQ_PREDICT_ROWS, world=world,
                  rank=rank, init=init, out=out, device_index=rank if cards else 0,
                  threads=torch.get_num_threads())
             for rank in range(world)]
    _run_ranks("--seq-rank", specs, workdir, SEQ_RANK_TIMEOUT_S, "seq")
    return torch.load(out)


def _seq_versus(got: dict, train_run: dict, cls_want, backend: str) -> tuple:
    """A spawned grid's runs against the one-rank run ``train_run`` (the
    same training on one rank, :func:`seq_train` with ``seq_shards=1``) and
    the one-rank classifier, and the phase's gates."""
    sp, fsdp = got["sp"], got["fsdp"]
    versus = _versus(sp, train_run)
    first = abs(sp["first_window_loss"] - train_run["first_window_loss"]) / abs(
        train_run["first_window_loss"])
    cls_err = float((got["classifier"]["logits"] - cls_want).abs().max())
    row = dict(grid=sp["grid"], seq_shards=SEQ_SHARDS, model="TransformerLM", **SEQ_MODEL,
               workers=TRAIN_WORKERS, batch_size=TRAIN_BATCH, window=TRAIN_WINDOW,
               epochs=SEQ_EPOCHS, rows=TRAIN_ROWS, tokens_per_rank=SEQ_MODEL["max_len"]
               // SEQ_SHARDS, loss=sp["loss"], loss_one_rank=train_run["loss"],
               first_window_loss=sp["first_window_loss"],
               first_window_loss_one_rank=train_run["first_window_loss"],
               first_window_loss_rel_err=first, first_window_loss_rtol=SEQ_FIRST_LOSS_RTOL,
               vs_one_rank=versus, loss_rtol=SEQ_LOSS_RTOL, param_rel_norm_rtol=SEQ_PARAM_REL_NORM,
               fsdp_vs_sp=_versus(fsdp, sp), num_updates=[sp["num_updates"], fsdp["num_updates"]],
               seconds=sp["seconds"], tokens_per_s=sp["tokens_per_s"],
               tokens_per_s_one_rank=train_run.get("tokens_per_s"),
               fsdp_tokens_per_s=fsdp["tokens_per_s"],
               peak_memory_gb_rank0=sp["peak_memory_gb"],
               peak_memory_gb_rank0_fsdp=fsdp["peak_memory_gb"],
               peak_memory_gb_one_rank=train_run.get("peak_memory_gb"),
               center_bytes_rank0=sp["center_bytes"], center_bytes_rank0_fsdp=fsdp["center_bytes"],
               ring_fwd_ms_per_layer=got["ring_ms_per_layer"],
               ring_timed_as="host clock, synchronised, one layer's forward on rank 0",
               host_staged_bytes_rank0=sp["host_staged_bytes"],
               host_staged_bytes_rank0_fsdp=fsdp["host_staged_bytes"],
               launches_b1_b2_b3=sp["launches"], launches_b1_b2_b3_fsdp=fsdp["launches"],
               classifier=dict(rows=SEQ_CLS_ROWS, max_abs_err_vs_one_rank=cls_err,
                               atol=SEQ_CLS_ATOL, launches_b1_b2_b3=got["classifier"]["launches"]),
               twin_predictor=got["twin"], card=CARD)
    failures = []
    if first > SEQ_FIRST_LOSS_RTOL:
        failures.append(f"first window's loss off by {first}")
    if versus["loss_rel_err"] > SEQ_LOSS_RTOL or versus["param_rel_norm_err"] > SEQ_PARAM_REL_NORM:
        failures.append(f"SP against one rank: {versus}")
    if not row["fsdp_vs_sp"]["bitwise"]:
        failures.append(f"fsdp is not the replicated SP run bit for bit: {row['fsdp_vs_sp']}")
    # every leaf but those no dim of which splits (the LM head's bias over
    # an odd vocabulary) is stored in seq shards
    if not 0 < fsdp["center_bytes"] <= sp["center_bytes"] / SEQ_SHARDS * 1.01:
        failures.append(f"fsdp center bytes {fsdp['center_bytes']} against {sp['center_bytes']}")
    if any(sp["launches"]) or any(fsdp["launches"]) or any(got["classifier"]["launches"]):
        failures.append("a kernel launched on the seq-sharded path")
    if cls_err > SEQ_CLS_ATOL:
        failures.append(f"classifier logits off by {cls_err}")
    twin = got["twin"]
    if not (twin["seq_free"] and twin["finite"]
            and twin["launches_b1"] == twin["expected_launches_b1"]):
        failures.append(f"the twin's predictor: {twin}")
    if ZOO_DEVICE == "cuda" and backend == "gloo" and not sp["host_staged_bytes"] > 0:
        failures.append("gloo on the card staged no byte through the host")
    if "sp_graph" in got:  # over NCCL: the same runs in captured windows
        steps = TRAIN_ROWS // (TRAIN_WORKERS * TRAIN_BATCH)
        row["captured"] = {}
        for name in ("sp", "fsdp"):
            graph = got[f"{name}_graph"]
            crow, cfail = _captured_row(graph, got[name], steps, SEQ_EPOCHS)
            if not crow["vs_eager"]["bitwise"]:  # the one-rank gates still hold
                v = _versus(graph, train_run)
                cfirst = abs(graph["first_window_loss"] - train_run["first_window_loss"]) / abs(
                    train_run["first_window_loss"])
                crow.update(vs_one_rank=v, first_window_loss_rel_err=cfirst)
                if (cfirst > SEQ_FIRST_LOSS_RTOL or v["loss_rel_err"] > SEQ_LOSS_RTOL
                        or v["param_rel_norm_err"] > SEQ_PARAM_REL_NORM):
                    cfail.append(f"not bitwise eager, and off one rank: {v}, first {cfirst}")
            row["captured"][name] = crow
            failures += [f"captured {name}: {f}" for f in cfail]
        if not _versus(got["fsdp_graph"], got["sp_graph"])["bitwise"]:
            failures.append("captured fsdp is not the captured replicated run bit for bit")
    return row, failures


def seq_phase(seed: int, train_run, pair: bool = True) -> dict:
    """Sequence parallelism at GPT-2-small widths (``SEQ_MODEL``: 6 blocks,
    ``SEQ_EPOCHS``): (a) two gloo ranks spawned on the one card
    (``--seq-rank``; NCCL refuses two ranks on one card), grid 1 x 2: the
    train phase's ``DOWNPOUR`` with ``seq_shards=2`` (each rank holds 512
    tokens of each row) against ``train_run``, the same training on one
    rank (``seq_train(seed, 1)``), then ``fsdp=True`` bit for bit the
    replicated run; (b)
    ``TransformerClassifier(seq_axis="seq")``'s logits at 2 ranks against
    one rank (B1); (c) the trained twin through ``ModelPredictor`` (B1); (d)
    on a machine with several cards, NCCL, one rank a card (grid 2 x 2 with 4
    cards or more, 1 x 2 with 2 or 3), the same checks, and both runs again
    in captured windows, held to the eager runs bit for bit (else to the
    one-rank gates), with captures, replays, the collectives in the graphs
    and tokens/s both ways (one card: ``seq_cards_run: 1``).  B1-B3 launch
    0 times on the seq-sharded path: the ring is plain products, as in
    JAX.  ``pair=False`` skips (a), for a call that runs the NCCL grid
    alone."""
    import tempfile

    from distkeras_tpu_torch.models import TorchModel, TransformerClassifier
    from distkeras_tpu_torch.ops import flash_attention

    model = TransformerClassifier(**SEQ_MODEL, generator=torch.Generator().manual_seed(seed + 11))
    params = {k: p.detach().to(ZOO_DEVICE) for k, p in model.named_parameters()}
    flash_attention.launches = 0
    with torch.inference_mode():
        cls_want = TorchModel(model).apply(params, {}, torch.from_numpy(
            _seq_cls_inputs(seed)).to(ZOO_DEVICE))[0].float().cpu()
    cls_launches = flash_attention.launches
    del model, params
    if ZOO_DEVICE == "cuda":
        torch.cuda.empty_cache()
    out = {}
    cards = _nccl_cards()
    with tempfile.TemporaryDirectory() as workdir:
        runs = [("two_ranks_one_card", 2, "gloo", False)] if pair else []
        if cards:
            runs.append(("cards", cards, "nccl", True))
        for case, world, backend, cards in runs:
            got = _spawn_seq(seed, world, backend, cards, workdir)
            row, failures = _seq_versus(got, train_run, cls_want, backend)
            row = dict(case=case, backend=backend, ranks=world,
                       **({"seq_cards_run": world} if cards else {}), **row)
            row["classifier"]["one_rank_launches_b1"] = cls_launches
            row["failures"] = failures
            emit(phase="seq", **row)
            out[case] = row
            if failures:
                raise AssertionError(f"seq: {case}: {failures}")
    if not _nccl_cards():
        emit(phase="seq", case="cards", seq_cards_run=1, reason=NCCL_CARDS_REASON, card=CARD)
    return out


# tensor-parallel phase: the train phase's DOWNPOUR over a GPT-2-small
# TransformerLM on the GSPMD engine's (workers, model) grid, 2 model ranks
# GPT-2 small's widths cut to 6 of its 12 blocks, so that the whole script
# stays within its time with phase 25's sanitized runs; the references (the
# one-rank one-epoch run and the two-epoch run whose first window it must
# reproduce) are made at the same depth
TP_MODEL = dict(GPT2_SMALL, num_layers=6)
TP_SHARDS, TP_RANK_TIMEOUT_S = 2, 900
# One epoch where the train phase runs two: the phase moves ~4 GB through
# the host a local step on the shared card (every column-parallel product's
# outputs gathered, every input gradient psummed), and one epoch keeps the
# whole script within the earlier runs' time; its one-rank reference is a
# one-epoch run of the train phase's trainer, on the card in this process.
TP_EPOCHS = 1
# The first window's loss, before any commit: the column-parallel products
# sum each output over the same inputs as one rank's, but the input
# gradients sum the two ranks' halves: f32 round-off alone (SEQ_* rationale).
TP_FIRST_LOSS_RTOL = SEQ_FIRST_LOSS_RTOL
# The loss history and the center against one rank: JAX's bounds for a
# layout change against data parallelism, as the seq phase's (Adam's
# round-off steps on the key bias included).
TP_LOSS_RTOL, TP_PARAM_REL_NORM = SEQ_LOSS_RTOL, SEQ_PARAM_REL_NORM


def tp_train(seed: int, epochs: int, **kwargs):
    """The train phase's ``DOWNPOUR`` over ``TP_MODEL`` (2 workers, batch 4,
    window 2, Adam) for ``epochs`` epochs, with the trainer's parallelism
    ``kwargs``: ``(trainer, run)``."""
    import distkeras_tpu_torch as tdk
    from distkeras_tpu_torch.models import TransformerLM

    model = TransformerLM(**TP_MODEL, generator=torch.Generator().manual_seed(seed + 2))
    x, y = lm_task(TRAIN_ROWS, TP_MODEL["max_len"], TP_MODEL["vocab_size"], seed + 2)
    trainer = _keeping_fit(tdk.DOWNPOUR)(
        model, loss="token_crossentropy", metrics=("token_accuracy",),
        worker_optimizer=("adam", {"learning_rate": 2e-4}), num_workers=TRAIN_WORKERS,
        batch_size=TRAIN_BATCH, communication_window=TRAIN_WINDOW, num_epoch=epochs,
        seed=seed, device=ZOO_DEVICE, **kwargs)
    run = _trained(trainer, tdk.from_numpy(x, y))
    run.update(first_window_loss=trainer.window_losses[0],
               tokens_per_s=epochs * TRAIN_ROWS * TP_MODEL["max_len"] / run["seconds"])
    return trainer, run


def _state_bytes(tree) -> int:
    from distkeras_tpu_torch.utils.pytree import tree_leaves

    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def _resident(engine, state) -> dict:
    """This rank's bytes of center, local parameters and optimizer state,
    and what the layout says they must be (each leaf split over the model
    axis a ``tp_shards``-th of the whole; under fsdp, the center's leaves
    split over the workers axis too)."""
    from distkeras_tpu_torch.utils.pytree import tree_leaves

    tp = getattr(engine, "tp_shards", 1)
    whole = engine.gather_center(state)
    dims = engine._tp_dims if tp > 1 else {k: -1 for k in whole}
    fsdp = engine._fsdp_dims if engine.fsdp else {k: -1 for k in whole}
    rows = engine.n_dev
    per_leaf = {k: v.numel() * v.element_size() // (tp if dims[k] >= 0 else 1)
                for k, v in whole.items()}
    center = sum(b // (rows if fsdp[k] >= 0 else 1) for k, b in per_leaf.items())
    block = sum(per_leaf.values())
    opt_leaves = len(tree_leaves(state.opt_state))  # Adam: mu and nu per leaf, one count
    return dict(center_bytes=_state_bytes(state.center_params), center_bytes_layout=center,
                local_bytes=_state_bytes(state.local_params),
                local_bytes_layout=engine.virtual * block,
                opt_bytes=_state_bytes(state.opt_state),
                opt_bytes_layout=engine.virtual * (2 * block + 4 * (opt_leaves - 2 * len(whole))),
                whole_center_bytes=_state_bytes(whole))


def _tp_runs(seed: int) -> dict:
    """One rank's share of the phase, in the group it is in: over 2 ranks
    (one card) the ``tp_shards=2`` run (grid 1 x 2), then the replicated
    2-rank run and ``fsdp=True`` alone (grid 2 x 1); over 4 (one a card)
    ``tp_shards=2, fsdp=True`` (grid 2 x 2).  Each with B1-B3's launches,
    the bytes staged through the host, peak memory and resident bytes; rank
    0 keeps the first run's returned model for the predictor.  Over NCCL
    the ``tp`` run (and on 2 ranks the fsdp run) again in captured windows
    (``unroll=True``: the column-parallel gathers and psums, the commit and
    fsdp's gathers inside the graphs), with one steady epoch each way."""
    import torch.distributed as dist

    from distkeras_tpu_torch.ops import (
        flash_attention,
        flash_attention_bwd_dkv,
        flash_attention_bwd_dq,
    )
    from distkeras_tpu_torch.parallel.mesh import transport_stats

    counters = (flash_attention, flash_attention_bwd_dq, flash_attention_bwd_dkv)
    on_card = ZOO_DEVICE == "cuda"
    nccl = _captures_here()
    if dist.get_world_size() == 2:
        cases = [("tp", dict(tp_shards=TP_SHARDS)), ("replicated", {}),
                 ("fsdp", dict(fsdp=True))]
    else:
        cases = [("tp", dict(tp_shards=TP_SHARDS, fsdp=True))]
    if nccl:
        cases += [(f"{name}_graph", dict(kwargs, unroll=True)) for name, kwargs in cases
                  if name != "replicated"]
    x, y = lm_task(TRAIN_ROWS, TP_MODEL["max_len"], TP_MODEL["vocab_size"], seed + 2)
    out = {}
    for name, kwargs in cases:
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        for c in counters:
            c.launches = 0
        transport_stats["host_staged_bytes"] = 0
        trainer, run = tp_train(seed, TP_EPOCHS, **kwargs)
        engine, state, _ = trainer.fit_result
        run.update(launches=[c.launches for c in counters],
                   host_staged_bytes=transport_stats["host_staged_bytes"],
                   peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9 if on_card else None,
                   grid=list(engine.mesh.shape), engine=type(engine).__name__,
                   num_updates=trainer.num_updates, **_resident(engine, state),
                   **_graph_record(engine))
        if nccl:
            run.update(_steady_epoch(trainer, x, y, TRAIN_ROWS * TP_MODEL["max_len"]))
        out[name] = run
        if name == "tp":
            out["model"] = trainer.parameter_server.model
        del trainer, engine, state
    return out


def tp_rank_main(spec_path: str) -> int:
    """One spawned rank of the tensor-parallel phase: the parent's settings
    from ``spec_path``, the group joined, :func:`_tp_runs`, the group left
    on every path; rank 0 then serves the returned model through
    ``ModelPredictor`` on its card alone and writes the runs."""
    import torch.distributed as dist

    global ZOO_DEVICE, TP_MODEL, SEQ_MODEL, TRAIN_ROWS, TRAIN_BATCH, TRAIN_WORKERS
    global TRAIN_WINDOW, TP_EPOCHS, SEQ_PREDICT_ROWS
    with open(spec_path, encoding="utf-8") as fh:
        spec = json.load(fh)
    ZOO_DEVICE, TP_MODEL = spec["device"], spec["model"]
    SEQ_MODEL, SEQ_PREDICT_ROWS = TP_MODEL, spec["predict_rows"]  # the predictor's settings
    TRAIN_ROWS, TRAIN_BATCH, TRAIN_WORKERS, TRAIN_WINDOW, TP_EPOCHS = spec["train"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(spec["threads"])
    if ZOO_DEVICE == "cuda":
        torch.cuda.set_device(spec["device_index"])
    dist.init_process_group(spec["backend"], init_method=spec["init"],
                            world_size=spec["world"], rank=spec["rank"])
    try:
        runs = _tp_runs(spec["seed"])
    finally:
        _leave_group()
    if spec["rank"] == 0:
        runs["predictor"] = _twin_predictor(runs.pop("model"), spec["seed"])
        torch.save(runs, spec["out"])
    return 0


def _spawn_tp(seed: int, world: int, backend: str, cards: bool, workdir: str) -> dict:
    import os

    name = f"tp_{backend}_{world}"
    init, out = _rendezvous(workdir, name), os.path.join(workdir, name + ".pt")
    specs = [dict(seed=seed, device=ZOO_DEVICE, model=TP_MODEL, backend=backend,
                  train=[TRAIN_ROWS, TRAIN_BATCH, TRAIN_WORKERS, TRAIN_WINDOW, TP_EPOCHS],
                  predict_rows=SEQ_PREDICT_ROWS, world=world, rank=rank, init=init, out=out,
                  device_index=rank if cards else 0, threads=torch.get_num_threads())
             for rank in range(world)]
    _run_ranks("--tp-rank", specs, workdir, TP_RANK_TIMEOUT_S, "tp")
    return torch.load(out)


def _tp_versus(got: dict, ref: dict, ref_launches, train_run, backend: str) -> tuple:
    """A spawned grid's runs against the one-rank run of as many epochs,
    and the phase's gates."""
    tp = got["tp"]
    rows = tp["grid"][0]
    versus = _versus(tp, ref)
    first = abs(tp["first_window_loss"] - ref["first_window_loss"]) / abs(ref["first_window_loss"])
    resident = {k: [tp[k], tp[f"{k}_layout"], ref[k]]
                for k in ("center_bytes", "local_bytes", "opt_bytes")}
    row = dict(grid=tp["grid"], tp_shards=TP_SHARDS, fsdp=tp["grid"][0] > 1,
               model="TransformerLM", **TP_MODEL, workers=TRAIN_WORKERS,
               batch_size=TRAIN_BATCH, window=TRAIN_WINDOW, epochs=TP_EPOCHS,
               train_phase_epochs=TRAIN_EPOCHS, rows=TRAIN_ROWS, loss=tp["loss"],
               loss_one_rank=ref["loss"], train_phase_loss=train_run["loss"],
               first_window_loss=tp["first_window_loss"],
               first_window_loss_one_rank=ref["first_window_loss"],
               first_window_loss_train_phase=train_run["first_window_loss"],
               first_window_loss_rel_err=first, first_window_loss_rtol=TP_FIRST_LOSS_RTOL,
               vs_one_rank=versus, loss_rtol=TP_LOSS_RTOL, param_rel_norm_rtol=TP_PARAM_REL_NORM,
               num_updates=[tp["num_updates"], ref["num_updates"]],
               seconds=tp["seconds"], tokens_per_s=tp["tokens_per_s"],
               tokens_per_s_one_rank=ref["tokens_per_s"],
               peak_memory_gb_rank0=tp["peak_memory_gb"],
               peak_memory_gb_one_rank=ref["peak_memory_gb"],
               resident_rank0_layout_one_rank=resident,
               host_staged_bytes_rank0=tp["host_staged_bytes"],
               launches_b1_b2_b3=tp["launches"], launches_b1_b2_b3_one_rank=ref_launches,
               predictor=got["predictor"], card=CARD)
    failures = []
    if first > TP_FIRST_LOSS_RTOL:
        failures.append(f"first window's loss off by {first}")
    if ref["first_window_loss"] != train_run["first_window_loss"]:
        failures.append("the one-rank reference's first window is not the two-epoch run's")
    if versus["loss_rel_err"] > TP_LOSS_RTOL or versus["param_rel_norm_err"] > TP_PARAM_REL_NORM:
        failures.append(f"TP against one rank: {versus}")
    if row["num_updates"][0] != row["num_updates"][1]:
        failures.append("commit counts differ")
    # every model rank runs every worker of its row on whole heads
    if [n * rows for n in tp["launches"]] != list(ref_launches):
        failures.append(f"B1-B3 launched {tp['launches']} times a rank, one rank "
                        f"{ref_launches} over {rows} workers rows")
    for key, (mine, layout, one) in resident.items():
        if mine != layout or not mine < one:
            failures.append(f"{key}: {mine} a rank, the layout's {layout}, one rank {one}")
    pred = got["predictor"]
    if not (pred["finite"] and pred["launches_b1"] == pred["expected_launches_b1"]):
        failures.append(f"the predictor: {pred}")
    if ZOO_DEVICE == "cuda" and backend == "gloo" and not tp["host_staged_bytes"] > 0:
        failures.append("gloo on the card staged no byte through the host")
    if "fsdp" in got:  # grid 2 x 1: fsdp alone against the replicated 2-rank run
        fsdp, rep = got["fsdp"], got["replicated"]
        row["fsdp_alone"] = dict(grid=fsdp["grid"], engine=fsdp["engine"],
                                 replicated_engine=rep["engine"], vs_replicated=_versus(fsdp, rep),
                                 center_bytes_rank0=fsdp["center_bytes"],
                                 center_bytes_layout=fsdp["center_bytes_layout"],
                                 center_bytes_replicated=rep["center_bytes"],
                                 tokens_per_s=fsdp["tokens_per_s"],
                                 tokens_per_s_replicated=rep["tokens_per_s"],
                                 host_staged_bytes_rank0=fsdp["host_staged_bytes"],
                                 launches_b1_b2_b3=fsdp["launches"])
        if not row["fsdp_alone"]["vs_replicated"]["bitwise"]:
            failures.append(f"fsdp is not the replicated run bit for bit: {row['fsdp_alone']}")
        if not (fsdp["center_bytes"] == fsdp["center_bytes_layout"]
                and fsdp["center_bytes"] < rep["center_bytes"]):
            failures.append("the fsdp center is not stored in worker shards")
        if fsdp["engine"] != "GSPMDEngine" or rep["engine"] != "WindowedEngine":
            failures.append(f"engines: fsdp {fsdp['engine']}, replicated {rep['engine']}")
    if "tp_graph" in got:  # over NCCL: the same runs in captured windows
        steps = TRAIN_ROWS // (TRAIN_WORKERS * TRAIN_BATCH)
        row["captured"] = {}
        for name in ("tp", "fsdp"):
            if f"{name}_graph" not in got:
                continue
            graph = got[f"{name}_graph"]
            crow, cfail = _captured_row(graph, got[name], steps, TP_EPOCHS)
            if not crow["vs_eager"]["bitwise"]:  # the one-rank gates still hold
                v = _versus(graph, ref)
                cfirst = abs(graph["first_window_loss"] - ref["first_window_loss"]) / abs(
                    ref["first_window_loss"])
                crow.update(vs_one_rank=v, first_window_loss_rel_err=cfirst)
                if (cfirst > TP_FIRST_LOSS_RTOL or v["loss_rel_err"] > TP_LOSS_RTOL
                        or v["param_rel_norm_err"] > TP_PARAM_REL_NORM):
                    cfail.append(f"not bitwise eager, and off one rank: {v}, first {cfirst}")
            row["captured"][name] = crow
            failures += [f"captured {name}: {f}" for f in cfail]
    return row, failures


def tp_phase(seed: int, train_run, pair: bool = True) -> dict:
    """Tensor parallelism at GPT-2-small widths (``TP_MODEL``: 6 blocks;
    ``TP_EPOCHS`` epochs of the train phase's ``DOWNPOUR``): (a) two gloo
    ranks spawned on the one card (``--tp-rank``), grid 1 x 2,
    ``tp_shards=2`` against one rank's run of as many epochs in this
    process (its first window that of ``train_run``, the same training's
    ``TRAIN_EPOCHS`` epochs on one rank, ``tp_train(seed, TRAIN_EPOCHS)``):
    B1-B3 launched on each rank as often as at one rank, each rank's center,
    local parameters and Adam state as the layout splits them; (b) on the
    same two ranks ``fsdp=True`` alone (grid 2 x 1) bit for bit the
    replicated two-rank run, its center in worker shards; (c) the returned
    model through ``ModelPredictor`` on one rank (B1); (d) on a machine with
    several cards, NCCL, one rank a card: grid 2 x 2 with ``tp_shards=2,
    fsdp=True`` on 4 cards or more, (a) and (b)'s grids on 2 or 3, the same
    checks, and the TP (and fsdp) runs again in captured windows, held to
    the eager runs bit for bit (else to the one-rank gates), B1-B3 launched
    in the graphs as eagerly (ticks x replays), with captures, replays and
    tokens/s both ways (one card: ``tp_cards_run: 1``).  ``pair=False``
    skips (a) and (b), for a call that runs the NCCL grid alone."""
    import tempfile

    from distkeras_tpu_torch.ops import (
        flash_attention,
        flash_attention_bwd_dkv,
        flash_attention_bwd_dq,
    )

    counters = (flash_attention, flash_attention_bwd_dq, flash_attention_bwd_dkv)
    if ZOO_DEVICE == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.launches = 0
    trainer, ref = tp_train(seed, TP_EPOCHS)
    ref_launches = [c.launches for c in counters]
    ref.update(peak_memory_gb=(torch.cuda.max_memory_allocated() / 1e9
                               if ZOO_DEVICE == "cuda" else None),
               num_updates=trainer.num_updates, **_resident(*trainer.fit_result[:2]))
    del trainer
    if ZOO_DEVICE == "cuda":
        torch.cuda.empty_cache()
    out = {}
    cards = _nccl_cards()
    with tempfile.TemporaryDirectory() as workdir:
        runs = [("two_ranks_one_card", 2, "gloo", False)] if pair else []
        if cards:
            runs.append(("cards", cards, "nccl", True))
        for case, world, backend, cards in runs:
            got = _spawn_tp(seed, world, backend, cards, workdir)
            row, failures = _tp_versus(got, ref, ref_launches, train_run, backend)
            row = dict(case=case, backend=backend, ranks=world,
                       **({"tp_cards_run": world} if cards else {}), **row)
            row["failures"] = failures
            emit(phase="tp", **row)
            out[case] = row
            if failures:
                raise AssertionError(f"tp: {case}: {failures}")
    if not _nccl_cards():
        emit(phase="tp", case="cards", tp_cards_run=1, reason=NCCL_CARDS_REASON, card=CARD)
    return out


# tensor-parallel serving phase: the serving phase's GPT-2-small LM and
# engine geometry (8 slots, pages of 16, f32 pools) with mesh= over the
# model axis: two gloo ranks sharing the card (6 heads a rank) against the
# one-rank engine in this process; on a 4-card machine also 4 NCCL ranks,
# one a card (3 heads a rank); 6 requests (cut from 12 to make room for
# phase 27, the one-rank engine serving the same 6)
SERVE_TP_REQUESTS = 6
SERVE_TP_SPEC_PROMPTS = 2  # greedy requests of the traffic through the mesh's speculative engine
SERVE_TP_RANK_TIMEOUT_S = 900
# the serving phase's widths cut to 6 of the 12 blocks, so that the
# script stays within its time with phase 26: the gloo pair's decode step is
# bound by the host, one all-reduce a block
SERVE_TP_BLOCKS = 6


def _serve_model(seed: int):
    """The serving phase's LM (random weights from ``--seed``) and its
    ``TrainedModel`` on the phase's device: ``(model, trained)``."""
    from distkeras_tpu_torch.models import TorchModel, TrainedModel, TransformerLM

    model = TransformerLM(**SERVE_MODEL, generator=torch.Generator().manual_seed(seed + 7))
    trained = TrainedModel(TorchModel(model), {k: v.detach() for k, v in model.named_parameters()},
                           device=ZOO_DEVICE)
    return model, trained


def _serve_tp_requests(seed: int) -> list:
    """The phase's traffic as ``GenerateRequest`` keyword dicts: prompts of
    ``SERVE_PROMPT_LEN`` tokens, ``SERVE_NEW_TOKENS`` new ones, every odd
    request sampled with its own seed."""
    rng = np.random.default_rng(seed + 21)
    vocab = SERVE_MODEL["vocab_size"]
    lengths = rng.integers(SERVE_PROMPT_LEN[0], SERVE_PROMPT_LEN[1] + 1, SERVE_TP_REQUESTS)
    new = rng.integers(SERVE_NEW_TOKENS[0], SERVE_NEW_TOKENS[1] + 1, SERVE_TP_REQUESTS)
    return [dict(prompt=rng.integers(0, vocab, int(n)).tolist(), max_new_tokens=int(m),
                 **(dict(SERVE_SAMPLING, seed=2000 + i) if i % 2 else {}))
            for i, (n, m) in enumerate(zip(lengths, new))]


def _serve_traffic(engine, registry, requests) -> dict:
    """The requests submitted ``SERVE_STAGGER_S`` apart (after a warm-up):
    their tokens, the wall, generated tokens/s, TTFT and step quantiles."""
    from distkeras_tpu_torch.serving import GenerateRequest

    engine.generate(requests[1]["prompt"][:16], max_new_tokens=4, timeout=600)  # warm-up
    before = registry.snapshot()
    t0 = time.perf_counter()
    pendings = []
    for req in requests:
        pendings.append(engine.submit(GenerateRequest(**req)))
        time.sleep(SERVE_STAGGER_S)
    results = [p.result(timeout=600) for p in pendings]
    wall = time.perf_counter() - t0
    if any(r is None or r.finish_reason == "aborted" for r in results) or not engine.alive:
        raise AssertionError(f"the engine failed: {engine.error!r}")
    after = registry.snapshot()
    ttft = _hist_delta(after["serving_ttft_seconds"], before.get("serving_ttft_seconds", {}))
    itl = _hist_delta(after["serving_token_latency_seconds"],
                      before.get("serving_token_latency_seconds", {}))
    tokens = sum(len(r.tokens) for r in results)
    return dict(tokens=[r.tokens for r in results], generated=tokens, seconds=wall,
                generated_tokens_per_s=tokens / wall,
                ttft_ms_p50=_hist_quantile(ttft, 0.5), step_ms_p50=_hist_quantile(itl, 0.5),
                step_ms_p99=_hist_quantile(itl, 0.99), decode_steps=itl["count"],
                step_ms_mean=itl["sum"] / max(itl["count"], 1) * 1e3)


def _serving_tp_runs(seed: int, world: int) -> dict:
    """One rank's share of the phase, in the group it is in:
    :func:`_serving_tp_served` with the step programs eager (gloo: its
    collectives cannot be captured) and, over NCCL, again with them
    captured (each rank's prefills, decode step and speculative iteration
    as CUDA graphs, the all-reduce a block inside), under ``captured``.
    Rank 0 returns what it measured."""
    from distkeras_tpu_torch.parallel.mesh import make_mesh
    from distkeras_tpu_torch.serving import engine as engine_module

    _, trained = _serve_model(seed)
    requests = _serve_tp_requests(seed)
    mesh = make_mesh(world, axis_name="model")
    out = {}
    try:
        for captured in (False, True) if _captures_here() else (False,):
            engine_module.CAPTURE_PROGRAMS = captured  # read when each engine is built
            got = _serving_tp_served(trained, requests, mesh, seed)
            if captured:
                out["captured"] = got
            else:
                out.update(got)
    finally:
        engine_module.CAPTURE_PROGRAMS = True
    return out


def _serving_tp_served(trained, requests, mesh, seed: int) -> dict:
    """The traffic on ``ServingEngine(mesh=)`` over every rank (rank 0
    drives, the others follow its plans), the sampled requests rerun alone,
    the profiled decode step, then the speculative engine on the same mesh;
    rank 0's measurements with each engine's captures and replays."""
    from distkeras_tpu_torch.models import TransformerLM
    from distkeras_tpu_torch.ops import (
        flash_attention,
        flash_attention_bwd_dkv,
        flash_attention_bwd_dq,
    )
    from distkeras_tpu_torch.parallel.mesh import transport_stats
    from distkeras_tpu_torch.serving import GenerateRequest
    from distkeras_tpu_torch.telemetry.metrics import Registry

    counters = (flash_attention, flash_attention_bwd_dq, flash_attention_bwd_dkv)
    out = {}
    registry = Registry()
    engine = _serving_engine(trained, registry, mesh=mesh, queue_size=SERVE_TP_REQUESTS + 8)
    if not engine.leads:
        engine.stop(timeout=SERVE_TP_RANK_TIMEOUT_S)  # follows rank 0's plans until its stop
    else:
        try:
            for c in counters:
                c.launches = 0
            transport_stats["host_staged_bytes"] = 0
            out["traffic"] = _serve_traffic(engine, registry, requests)
            out["host_staged_bytes"] = transport_stats["host_staged_bytes"]
            out["launches_b1_b2_b3"] = [c.launches for c in counters]
            sampled = [i for i, r in enumerate(requests) if "seed" in r]
            reruns = {i: engine.generate(timeout=600, **requests[i]).tokens for i in sampled}
            out["sampled_mismatched"] = [i for i in sampled
                                         if reruns[i] != out["traffic"]["tokens"][i]]
            # the decode step under torch.profiler: one request a slot,
            # admitted together; the all-reduces of its decode steps
            rng = np.random.default_rng(seed + 22)
            profile_prompts = [rng.integers(0, SERVE_MODEL["vocab_size"],
                                            SERVE_PROFILE[0]).tolist() for _ in range(SERVE_SLOTS)]
            counts = []

            def run():
                steps, reduces = engine._metrics["decode_steps"].value, engine.all_reduces
                engine.drain(timeout=60)
                batch = [engine.submit(GenerateRequest(prompt=p, max_new_tokens=SERVE_PROFILE[1]))
                         for p in profile_prompts]
                engine.resume()
                for p in batch:
                    p.result(timeout=600)
                counts.append((engine._metrics["decode_steps"].value - steps,
                               engine.all_reduces - reduces))

            profile = fwd_bwd_profile(run, iters=1) if ZOO_DEVICE == "cuda" else run() or {}
            steps, reduces = counts[-1]
            prefill_reduces = SERVE_SLOTS * SERVE_MODEL["num_layers"]
            out["profiled_decode"] = dict(
                slots=SERVE_SLOTS, steps=steps,
                all_reduces_per_decode_step=(reduces - prefill_reduces) / max(steps, 1),
                wall_ms_per_step=profile.get("wall_ms_per_call", 0.0) / max(steps, 1),
                device_ms_per_step=(profile["device_ms_per_call"] / max(steps, 1)
                                    if profile.get("device_ms_per_call") else None),
                device_busy_share=profile.get("device_busy_share"))
            out["pool_bytes"] = engine._cache.k_pages.nbytes + engine._cache.v_pages.nbytes
            out["heads_a_rank"] = engine._spec.heads
            out["graph_stats"] = dict(engine.graph_stats, captured=engine._use_graphs)
        finally:
            engine.stop()
    draft = TransformerLM(**SERVE_DRAFT, generator=torch.Generator().manual_seed(seed + 8))
    spec = _serving_engine(trained, Registry(), mesh=mesh, draft_model=draft,
                           draft_params={k: v.detach() for k, v in draft.named_parameters()},
                           spec_tokens=SERVE_SPEC_TOKENS)
    if not spec.leads:
        spec.stop(timeout=SERVE_TP_RANK_TIMEOUT_S)
        return out
    try:
        greedy = [i for i, r in enumerate(requests) if "seed" not in r][:SERVE_TP_SPEC_PROMPTS]
        t0 = time.perf_counter()
        out["speculative"] = dict(requests=greedy, tokens=[
            spec.submit(GenerateRequest(**requests[i])).result(timeout=600).tokens
            for i in greedy], seconds=time.perf_counter() - t0,
            graph_stats=dict(spec.graph_stats, captured=spec._use_graphs))
    finally:
        spec.stop()
    return out


def serving_tp_rank_main(spec_path: str) -> int:
    """One spawned rank of the tensor-parallel serving phase: the parent's
    settings from ``spec_path``, the group joined, :func:`_serving_tp_runs`,
    the group left; rank 0 writes what it measured."""
    import torch.distributed as dist

    global ZOO_DEVICE, SERVE_MODEL, SERVE_DRAFT, SERVE_SLOTS, SERVE_PAGE, SERVE_TP_REQUESTS
    global SERVE_PROMPT_LEN, SERVE_NEW_TOKENS, SERVE_STAGGER_S, SERVE_PROFILE
    global SERVE_TP_SPEC_PROMPTS
    with open(spec_path, encoding="utf-8") as fh:
        spec = json.load(fh)
    ZOO_DEVICE, SERVE_MODEL, SERVE_DRAFT = spec["device"], spec["model"], spec["draft"]
    (SERVE_SLOTS, SERVE_PAGE, SERVE_TP_REQUESTS, SERVE_PROMPT_LEN, SERVE_NEW_TOKENS,
     SERVE_STAGGER_S, SERVE_PROFILE, SERVE_TP_SPEC_PROMPTS) = spec["serve"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(spec["threads"])
    if ZOO_DEVICE == "cuda":
        torch.cuda.set_device(spec["device_index"])
    dist.init_process_group(spec["backend"], init_method=spec["init"],
                            world_size=spec["world"], rank=spec["rank"])
    try:
        runs = _serving_tp_runs(spec["seed"], spec["world"])
    finally:
        _leave_group()
    if spec["rank"] == 0:
        torch.save(runs, spec["out"])
    return 0


def _spawn_serving_tp(seed: int, world: int, backend: str, cards: bool, workdir: str) -> dict:
    import os

    name = f"serving_tp_{backend}_{world}"
    init, out = _rendezvous(workdir, name), os.path.join(workdir, name + ".pt")
    specs = [dict(seed=seed, device=ZOO_DEVICE, model=SERVE_MODEL, draft=SERVE_DRAFT,
                  serve=[SERVE_SLOTS, SERVE_PAGE, SERVE_TP_REQUESTS, list(SERVE_PROMPT_LEN),
                         list(SERVE_NEW_TOKENS), SERVE_STAGGER_S, list(SERVE_PROFILE),
                         SERVE_TP_SPEC_PROMPTS],
                  backend=backend, world=world, rank=rank, init=init, out=out,
                  device_index=rank if cards else 0, threads=torch.get_num_threads())
             for rank in range(world)]
    _run_ranks("--serving-tp-rank", specs, workdir, SERVE_TP_RANK_TIMEOUT_S, "serving_tp")
    return torch.load(out)


def _serving_tp_versus(got: dict, ref: dict, requests, trained, world: int) -> tuple:
    """A mesh's run against the one-rank engine's, and the phase's gates."""
    failures, departures, spec_departures = [], [], []
    for i, req in enumerate(requests):
        if "seed" in req:
            continue
        try:
            hit = _held_to_greedy(trained, req["prompt"], got["traffic"]["tokens"][i],
                                  ref["tokens"][i])
        except AssertionError as e:
            failures.append(f"request {i}: {e}")
            continue
        if hit is not None:
            departures.append(dict(request=i, position=hit[0], gap=hit[1]))
    spec = got["speculative"]
    for i, tokens in zip(spec["requests"], spec["tokens"]):
        try:
            hit = _held_to_greedy(trained, requests[i]["prompt"], tokens,
                                  got["traffic"]["tokens"][i])
        except AssertionError as e:
            failures.append(f"speculative request {i}: {e}")
            continue
        if hit is not None:
            spec_departures.append(dict(request=i, position=hit[0], gap=hit[1]))
    if got["sampled_mismatched"]:
        failures.append(f"sampled requests {got['sampled_mismatched']} gave other tokens alone")
    if got["pool_bytes"] * world != ref["pool_bytes"]:
        failures.append(f"a rank's pools hold {got['pool_bytes']} bytes, one rank's "
                        f"{ref['pool_bytes']} over {world}")
    per_step = got["profiled_decode"]["all_reduces_per_decode_step"]
    if per_step != SERVE_MODEL["num_layers"]:
        failures.append(f"{per_step} all-reduces a decode step, one a block expected")
    if got["launches_b1_b2_b3"] != [0, 0, 0]:
        failures.append(f"B1-B3 launched {got['launches_b1_b2_b3']} times on the serving path")
    traffic = {k: v for k, v in got["traffic"].items() if k != "tokens"}
    row = dict(model="TransformerLM", **SERVE_MODEL, slots=SERVE_SLOTS, page_size=SERVE_PAGE,
               requests=len(requests), sampled=sum("seed" in r for r in requests),
               heads_a_rank=got["heads_a_rank"], **traffic,
               one_rank={k: v for k, v in ref.items() if k != "tokens"},
               greedy_departures=departures, sampled_rerun_equal=not got["sampled_mismatched"],
               speculative=dict(requests=len(spec["requests"]), seconds=spec["seconds"],
                                spec_tokens=SERVE_SPEC_TOKENS, draft_model=SERVE_DRAFT,
                                departures_from_mesh_plain=spec_departures),
               pool_bytes_rank=got["pool_bytes"], pool_bytes_one_rank=ref["pool_bytes"],
               host_staged_bytes_rank0=got["host_staged_bytes"],
               profiled_decode=got["profiled_decode"], graph_stats=got["graph_stats"],
               launches_b1_b2_b3=got["launches_b1_b2_b3"], greedy_gap=GREEDY_GAP, card=CARD)
    if "captured" in got:  # over NCCL: the same traffic through captured programs
        cap = got["captured"]
        same = (cap["traffic"]["tokens"] == got["traffic"]["tokens"]
                and cap["speculative"]["tokens"] == spec["tokens"])
        row["captured"] = dict(
            tokens_equal_eager=same, graph_stats=cap["graph_stats"],
            speculative_graph_stats=cap["speculative"]["graph_stats"],
            generated_tokens_per_s=cap["traffic"]["generated_tokens_per_s"],
            generated_tokens_per_s_eager=traffic["generated_tokens_per_s"],
            step_ms_mean=cap["traffic"]["step_ms_mean"], step_ms_mean_eager=traffic["step_ms_mean"],
            step_ms_p50=cap["traffic"]["step_ms_p50"], step_ms_p50_eager=traffic["step_ms_p50"],
            ttft_ms_p50=cap["traffic"]["ttft_ms_p50"], ttft_ms_p50_eager=traffic["ttft_ms_p50"],
            speculative_seconds=cap["speculative"]["seconds"],
            speculative_seconds_eager=spec["seconds"],
            profiled_decode=cap["profiled_decode"],
            profiled_decode_eager=got["profiled_decode"],
            launches_b1_b2_b3=cap["launches_b1_b2_b3"],
            sampled_rerun_equal=not cap["sampled_mismatched"])
        if not (cap["graph_stats"]["captured"] and cap["graph_stats"]["captures"] >= 1
                and cap["speculative"]["graph_stats"]["captures"] >= 1):
            failures.append(f"captured: no program was captured: {row['captured']}")
        if not same:
            # not bitwise the eager programs: held to the one-rank engine instead
            for i, req in enumerate(requests):
                if "seed" not in req:
                    try:
                        _held_to_greedy(trained, req["prompt"], cap["traffic"]["tokens"][i],
                                        ref["tokens"][i])
                    except AssertionError as e:
                        failures.append(f"captured request {i}: {e}")
        if cap["sampled_mismatched"]:
            failures.append(f"captured: sampled requests {cap['sampled_mismatched']} differ alone")
        if cap["profiled_decode"]["all_reduces_per_decode_step"] != SERVE_MODEL["num_layers"]:
            failures.append(f"captured: {cap['profiled_decode']['all_reduces_per_decode_step']} "
                            "all-reduces a replayed decode step, one a block expected")
        if cap["launches_b1_b2_b3"] != [0, 0, 0]:
            failures.append(f"captured: B1-B3 launched {cap['launches_b1_b2_b3']} times")
    return row, failures


def serving_tp_phase(seed: int, pair: bool = True) -> dict:
    """:func:`_serving_tp_phase` on the serving phase's model cut to
    ``SERVE_TP_BLOCKS`` blocks (widths kept), the one-rank engine and the
    ranks alike."""
    global SERVE_MODEL
    full = SERVE_MODEL
    SERVE_MODEL = dict(full, num_layers=min(full["num_layers"], SERVE_TP_BLOCKS))
    try:
        return _serving_tp_phase(seed, pair)
    finally:
        SERVE_MODEL = full


def _serving_tp_phase(seed: int, pair: bool = True) -> dict:
    """Tensor-parallel serving (``ServingEngine(mesh=)``) at the serving
    phase's GPT-2-small widths: ``SERVE_TP_REQUESTS`` requests
    ``SERVE_STAGGER_S`` apart (half sampled) on the one-rank engine in this
    process, then on (a) two gloo ranks spawned on the one card
    (``--serving-tp-rank``, 6 heads a rank; their step programs eager, as
    gloo cannot be captured) and (b) on a machine with several cards, 4
    NCCL ranks, one a card, with 4 cards or more (3 heads a rank), 2 with 2
    or 3 (else ``serving_tp_cards_run: 1``), the traffic served eagerly and
    again through captured step programs, whose tokens must equal the eager
    ones (else be held to the one-rank engine as the eager ones are), one
    all-reduce a block a replayed decode step.  Gates: greedy tokens equal to the
    one-rank engine's but where the reference's top-two gap is below
    ``GREEDY_GAP``; sampled requests equal to themselves rerun alone on the
    mesh; speculative greedy (the serving phase's draft) the mesh's plain
    stream under the same rule; a rank's pools ``1/tp`` of one rank's; one
    all-reduce a block a decode step; B1-B3 never launched (the serving
    path runs the reference's plain masked attention).  ``pair=False``
    skips (a), for a 4-card call that runs the NCCL ranks alone."""
    import tempfile

    from distkeras_tpu_torch.telemetry.metrics import Registry

    _, trained = _serve_model(seed)
    requests = _serve_tp_requests(seed)
    registry = Registry()
    engine = _serving_engine(trained, registry, queue_size=SERVE_TP_REQUESTS + 8)
    try:
        ref = _serve_traffic(engine, registry, requests)
        ref["pool_bytes"] = engine._cache.k_pages.nbytes + engine._cache.v_pages.nbytes
    finally:
        engine.stop()
    out = {}
    cards = _nccl_cards()
    with tempfile.TemporaryDirectory() as workdir:
        runs = [("two_ranks_one_card", 2, "gloo", False)] if pair else []
        if cards:
            runs.append(("cards", cards, "nccl", True))
        for case, world, backend, cards in runs:
            got = _spawn_serving_tp(seed, world, backend, cards, workdir)
            row, failures = _serving_tp_versus(got, ref, requests, trained, world)
            row = dict(case=case, backend=backend, ranks=world,
                       **({"serving_tp_cards_run": world} if cards else {}), **row)
            row["failures"] = failures
            emit(phase="serving_tp", **row)
            out[case] = row
            if failures:
                raise AssertionError(f"serving_tp: {case}: {failures}")
    if not _nccl_cards():
        emit(phase="serving_tp", case="cards", serving_tp_cards_run=1, reason=NCCL_CARDS_REASON,
             card=CARD)
    return out


# MoE phase: MoETransformerClassifier at google/switch-base-8's widths (Fedus
# et al. 2021; HF SwitchTransformersConfig: d_model 768, 12 heads, d_ff
# 3072, 12 blocks, 8 experts, capacity factor 1.25, vocab 32128), sequence
# 512, 2 classes, f32, random weights from --seed.  Every block is MoE here
# (the repo's class), where the published model alternates dense and
# sparse blocks.  DOWNPOUR, 2 workers, batch 4, window 2, Adam, one epoch of
# one window (16 rows), and the predictor over 2 rows (cut from two windows
# and 4 rows to make room for phase 27, the one-rank reference cut alike)
MOE_MODEL = dict(vocab_size=32128, num_classes=2, dim=768, heads=12, num_layers=12,
                 num_experts=8, mlp_ratio=4, top_k=1, capacity_factor=1.25, max_len=512)
MOE_WINDOWS, MOE_EPOCHS, MOE_PREDICT_ROWS = 1, 1, 2
MOE_TP_SHARDS, MOE_RANK_TIMEOUT_S = 2, 900
# the expert-parallel run against one rank: phase 20's gates
MOE_FIRST_LOSS_RTOL, MOE_LOSS_RTOL, MOE_PARAM_REL_NORM = (
    TP_FIRST_LOSS_RTOL, TP_LOSS_RTOL, TP_PARAM_REL_NORM)


def moe_task(rows: int, seed: int):
    """``rows`` token rows of ``MOE_MODEL``'s length and their one-hot
    class (does token 7 appear more often than token 3?)."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, MOE_MODEL["vocab_size"], (rows, MOE_MODEL["max_len"]), dtype=np.int32)
    x[:, :8] = rng.integers(0, 8, (rows, 8))  # small ids often, so that both classes occur
    y = ((x == 7).sum(1) > (x == 3).sum(1)).astype(np.int64)
    return x, np.eye(MOE_MODEL["num_classes"], dtype=np.float32)[y]


def moe_train(seed: int, **kwargs):
    """``DOWNPOUR`` over ``MOE_MODEL`` for ``MOE_EPOCHS`` epochs with the
    trainer's parallelism ``kwargs``: ``(trainer, run)``, each expert
    product's expert count recorded in the run."""
    import distkeras_tpu_torch as tdk
    from distkeras_tpu_torch.models import MoETransformerClassifier, moe

    rows = TRAIN_WORKERS * MOE_WINDOWS * TRAIN_WINDOW * TRAIN_BATCH
    model = MoETransformerClassifier(**MOE_MODEL,
                                     generator=torch.Generator().manual_seed(seed + 22))
    x, y = moe_task(rows, seed + 22)
    trainer = _keeping_fit(tdk.DOWNPOUR)(
        model, loss="categorical_crossentropy", metrics=("accuracy",),
        worker_optimizer=("adam", {"learning_rate": 2e-4}), num_workers=TRAIN_WORKERS,
        batch_size=TRAIN_BATCH, communication_window=TRAIN_WINDOW, num_epoch=MOE_EPOCHS,
        seed=seed, device=ZOO_DEVICE, **kwargs)
    seen, plain = [], moe._expert_ffn

    def counted(xin, *stacks):
        seen.append(int(xin.shape[0]))
        return plain(xin, *stacks)

    moe._expert_ffn = counted
    try:
        run = _trained(trainer, tdk.from_numpy(x, y))
    finally:
        moe._expert_ffn = plain
    run.update(first_window_loss=trainer.window_losses[0], experts_seen=sorted(set(seen)),
               expert_calls=len(seen),
               tokens_per_s=MOE_EPOCHS * rows * MOE_MODEL["max_len"] / run["seconds"])
    return trainer, run


def _moe_runs(seed: int) -> dict:
    """One rank's share of the phase, in the group it is in: over 2 ranks
    ``tp_shards=2`` with ``expert_partition(8)`` (grid 1 x 2), over 4 (one a
    card) the same on the 2 x 2 grid; B1-B3's launches, bytes through the
    host, peak memory, the resident expert bytes.  Over NCCL the same run
    again in captured windows (``unroll=True``: EP's input psum and output
    gather and the attention's gathers and psums inside the graphs), under
    ``captured``, with one steady epoch each way."""
    from distkeras_tpu_torch.models import expert_partition
    from distkeras_tpu_torch.ops import (
        flash_attention,
        flash_attention_bwd_dkv,
        flash_attention_bwd_dq,
    )
    from distkeras_tpu_torch.parallel.mesh import transport_stats

    counters = (flash_attention, flash_attention_bwd_dq, flash_attention_bwd_dkv)
    on_card = ZOO_DEVICE == "cuda"
    nccl = _captures_here()
    rows = TRAIN_WORKERS * MOE_WINDOWS * TRAIN_WINDOW * TRAIN_BATCH
    x, y = moe_task(rows, seed + 22)
    runs = {}
    for name, kwargs in (("eager", {}), ("captured", dict(unroll=True)))[:2 if nccl else 1]:
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        for c in counters:
            c.launches = 0
        transport_stats["host_staged_bytes"] = 0
        trainer, run = moe_train(seed, tp_shards=MOE_TP_SHARDS,
                                 tp_spec_fn=expert_partition(MOE_MODEL["num_experts"]), **kwargs)
        engine, state, _ = trainer.fit_result
        run.update(launches=[c.launches for c in counters],
                   host_staged_bytes=transport_stats["host_staged_bytes"],
                   peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9 if on_card else None,
                   grid=list(engine.mesh.shape), num_updates=trainer.num_updates,
                   **_expert_bytes(state.center_params),
                   **_graph_record(engine))
        if nccl:
            run.update(_steady_epoch(trainer, x, y, rows * MOE_MODEL["max_len"]))
        runs[name] = run
        del trainer, engine, state
    return dict(runs["eager"], **({"captured": runs["captured"]} if nccl else {}))


def _expert_bytes(center) -> dict:
    """Bytes of the center's expert stacks and of the rest of it."""
    from distkeras_tpu_torch.models.moe import EXPERT_PARAM_NAMES

    expert = sum(v.numel() * v.element_size() for k, v in center.items()
                 if ".moe." in k and k.split(".")[-1] in EXPERT_PARAM_NAMES)
    total = sum(v.numel() * v.element_size() for v in center.values())
    return dict(expert_bytes=expert, other_bytes=total - expert)


def moe_rank_main(spec_path: str) -> int:
    """One spawned rank of the MoE phase: the parent's settings from
    ``spec_path``, the group joined, :func:`_moe_runs`, the group left;
    rank 0 writes its run."""
    import torch.distributed as dist

    global ZOO_DEVICE, MOE_MODEL, TRAIN_BATCH, TRAIN_WORKERS, TRAIN_WINDOW, MOE_WINDOWS
    global MOE_EPOCHS
    with open(spec_path, encoding="utf-8") as fh:
        spec = json.load(fh)
    ZOO_DEVICE, MOE_MODEL = spec["device"], spec["model"]
    TRAIN_BATCH, TRAIN_WORKERS, TRAIN_WINDOW, MOE_WINDOWS, MOE_EPOCHS = spec["train"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(spec["threads"])
    if ZOO_DEVICE == "cuda":
        torch.cuda.set_device(spec["device_index"])
    dist.init_process_group(spec["backend"], init_method=spec["init"],
                            world_size=spec["world"], rank=spec["rank"])
    try:
        run = _moe_runs(spec["seed"])
    finally:
        _leave_group()
    if spec["rank"] == 0:
        torch.save(run, spec["out"])
    return 0


def _spawn_moe(seed: int, world: int, backend: str, cards: bool, workdir: str) -> dict:
    import os

    name = f"moe_{backend}_{world}"
    init, out = _rendezvous(workdir, name), os.path.join(workdir, name + ".pt")
    specs = [dict(seed=seed, device=ZOO_DEVICE, model=MOE_MODEL, backend=backend,
                  train=[TRAIN_BATCH, TRAIN_WORKERS, TRAIN_WINDOW, MOE_WINDOWS, MOE_EPOCHS],
                  world=world, rank=rank, init=init, out=out,
                  device_index=rank if cards else 0, threads=torch.get_num_threads())
             for rank in range(world)]
    _run_ranks("--moe-rank", specs, workdir, MOE_RANK_TIMEOUT_S, "moe")
    return torch.load(out)


def _moe_step(adapter, params, state, x, y, device):
    """One training-mode forward + backward of the objective the engine
    minimises, cross-entropy plus the load-balance loss, on ``device``: the
    loss, the aux loss and each parameter's gradient (f64, on the CPU)."""
    from distkeras_tpu_torch.ops import get_loss

    leaves = {k: v.detach().to(device).requires_grad_(True) for k, v in params.items()}
    out, new_state = adapter.apply(leaves, {k: v.to(device) for k, v in state.items()},
                                   torch.from_numpy(x).to(device), training=True)
    aux = adapter.aux_loss(new_state)
    loss = get_loss("categorical_crossentropy")(out.float(), torch.from_numpy(y).to(device)) + aux
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return (loss.item(), float(torch.as_tensor(aux).detach()),
            {k: g.cpu().double() for k, g in zip(leaves, grads)})


def moe_phase(seed: int, pair: bool = True) -> dict:
    """Mixture-of-experts at switch-base-8's widths (``MOE_MODEL``): (a)
    ``DOWNPOUR`` on one rank (B1 a forward and B2/B3 a backward, 12 each a
    step), a finite history, one ``[1, 512]`` step of cross-entropy plus
    the load-balance loss held to the CPU (``STEP_LOSS_RTOL``,
    ``STEP_GRAD_RTOL``), the engine's loss on a batch equal to cross-entropy
    plus the aux loss, the trained model through ``ModelPredictor`` against
    the CPU within ``PREDICT_ATOL`` (B1 12); (b) two gloo ranks spawned on
    the card (``--moe-rank``), ``tp_shards=2`` with ``expert_partition(8)``
    (grid 1 x 2): first window, history and center against (a) within phase
    20's gates, each rank's expert stacks half of one rank's, each expert
    product on a rank over 4 experts, B1-B3 as at one rank; (c) on a
    machine with several cards, NCCL, one rank a card (grid 2 x 2 with 4
    cards or more, 1 x 2 with 2 or 3), the same checks, and the run again
    in captured windows, held to the eager run bit for bit (else to the
    one-rank gates), B1-B3 launched in the graphs as eagerly (ticks x
    replays), with captures, replays and tokens/s both ways (else
    ``moe_cards_run: 1``).  ``pair=False`` skips (b), for a call that runs
    the NCCL grid alone."""
    import tempfile

    import distkeras_tpu_torch as tdk
    from distkeras_tpu_torch.models import TrainedModel
    from distkeras_tpu_torch.ops import (
        flash_attention,
        flash_attention_bwd_dkv,
        flash_attention_bwd_dq,
    )

    counters = (flash_attention, flash_attention_bwd_dq, flash_attention_bwd_dkv)
    cuda = ZOO_DEVICE == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.launches = 0
    trainer, ref = moe_train(seed)
    launches = [c.launches for c in counters]
    engine, state, adapter = trainer.fit_result
    L = MOE_MODEL["num_layers"]
    local_steps = TRAIN_WORKERS * MOE_EPOCHS * MOE_WINDOWS * TRAIN_WINDOW
    expected = [L * local_steps if cuda else 0] * 3
    ref.update(peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9 if cuda else None,
               num_updates=trainer.num_updates, launches=launches,
               **_expert_bytes(state.center_params))
    model = trainer.parameter_server.model
    params = {k: v.detach().cpu() for k, v in model.params.items()}
    buffers = {k: v.detach().cpu() for k, v in model.state.items()}
    failures = []
    if launches != expected:
        failures.append(f"B1-B3 launched {launches} times, expected {expected}")
    if not np.isfinite(ref["loss"]).all():
        failures.append(f"the history is not finite: {ref['loss']}")

    # the objective: the engine's loss on one batch is cross-entropy + aux
    x, y = moe_task(TRAIN_BATCH, seed + 23)
    xd, yd = torch.from_numpy(x).to(engine.device), torch.from_numpy(y).to(engine.device)
    pd = {k: v.to(engine.device) for k, v in params.items()}
    sd = {k: v.to(engine.device) for k, v in buffers.items()}
    _, _, _, engine_loss, _, _ = engine._local_step(pd, engine.optimizer.init(pd), sd, None, xd,
                                                    yd)
    with torch.no_grad():
        out, new_state = adapter.apply(pd, sd, xd, training=True)
        aux = float(adapter.aux_loss(new_state))
        ce = float(engine.loss_fn(out.float(), yd))
    objective_err = abs(float(engine_loss) - (ce + aux)) / abs(ce + aux)
    if not (aux > 0 and objective_err < 1e-6):
        failures.append(f"the engine's loss {float(engine_loss)} is not ce {ce} + aux {aux}")
    del pd, sd, xd, yd, out, new_state

    # one [1, 512] step on the card against the CPU
    x1, y1 = x[:1], y[:1]
    for c in counters:
        c.launches = 0
    loss_card, aux_card, grads_card = _moe_step(adapter, params, buffers, x1, y1, ZOO_DEVICE)
    step_launches = [c.launches for c in counters]
    loss_cpu, aux_cpu, grads_cpu = _moe_step(adapter, params, buffers, x1, y1, "cpu")
    loss_err = abs(loss_card - loss_cpu) / abs(loss_cpu)
    errs = {k: ((grads_card[k] - g).norm() / g.norm().clamp(min=1e-30)).item()
            for k, g in grads_cpu.items()}
    worst = max(errs, key=errs.get)
    if loss_err > STEP_LOSS_RTOL or errs[worst] > STEP_GRAD_RTOL:
        failures.append(f"card and CPU steps differ: loss {loss_err}, {worst} {errs[worst]}")
    if step_launches != [L if cuda else 0] * 3:
        failures.append(f"the step launched B1-B3 {step_launches} times")
    del grads_card, grads_cpu

    # the trained model through ModelPredictor, against the CPU
    xp, _ = moe_task(MOE_PREDICT_ROWS, seed + 24)
    flash_attention.launches = 0
    pred = tdk.ModelPredictor(model, batch_size=MOE_PREDICT_ROWS, num_devices=1,
                              device=ZOO_DEVICE)
    probs = np.stack(pred.predict(tdk.from_numpy(xp))["prediction"])
    predictor_launches = flash_attention.launches
    cpu_probs = TrainedModel(model.adapter, params, buffers, device="cpu").predict(xp)
    predict_err = float(np.abs(probs - cpu_probs).max())
    if predict_err > PREDICT_ATOL or predictor_launches != (L if cuda else 0):
        failures.append(f"the predictor: {predict_err} from the CPU, {predictor_launches} B1")
    one_rank = dict(loss=ref["loss"], first_window_loss=ref["first_window_loss"],
                    tokens_per_s=ref["tokens_per_s"], seconds=ref["seconds"],
                    peak_memory_gb=ref["peak_memory_gb"], launches_b1_b2_b3=launches,
                    expected_launches=expected, num_updates=ref["num_updates"],
                    experts_seen=ref["experts_seen"], expert_bytes=ref["expert_bytes"],
                    aux_loss=aux, objective_rel_err=objective_err,
                    step_vs_cpu=dict(tokens=[1, MOE_MODEL["max_len"]], loss_rel_err=loss_err,
                                     aux_card=aux_card, aux_cpu=aux_cpu,
                                     max_grad_rel_norm_err=errs[worst], worst_param=worst,
                                     launches_b1_b2_b3=step_launches),
                    predictor=dict(rows=MOE_PREDICT_ROWS, max_abs_err=predict_err,
                                   launches_b1=predictor_launches))
    emit(phase="moe", case="one_rank", model="MoETransformerClassifier", **MOE_MODEL,
         params=sum(v.numel() for v in params.values()), workers=TRAIN_WORKERS,
         batch_size=TRAIN_BATCH, window=TRAIN_WINDOW, windows=MOE_WINDOWS, epochs=MOE_EPOCHS,
         failures=failures, card=CARD, **one_rank)
    if failures:
        raise AssertionError(f"moe: one rank: {failures}")
    del trainer, engine, state, model
    if cuda:
        torch.cuda.empty_cache()

    out = {"one_rank": one_rank}
    cards = _nccl_cards()
    E = MOE_MODEL["num_experts"]
    with tempfile.TemporaryDirectory() as workdir:
        runs = [("two_ranks_one_card", 2, "gloo", False)] if pair else []
        if cards:
            runs.append(("cards", cards, "nccl", True))
        for case, world, backend, cards in runs:
            got = _spawn_moe(seed, world, backend, cards, workdir)
            rows = got["grid"][0]
            versus = _versus(got, ref)
            first = (abs(got["first_window_loss"] - ref["first_window_loss"])
                     / abs(ref["first_window_loss"]))
            row = dict(case=case, backend=backend, ranks=world, grid=got["grid"],
                       tp_shards=MOE_TP_SHARDS, **({"moe_cards_run": world} if cards else {}),
                       loss=got["loss"], loss_one_rank=ref["loss"],
                       first_window_loss_rel_err=first, first_window_loss_rtol=MOE_FIRST_LOSS_RTOL,
                       vs_one_rank=versus, loss_rtol=MOE_LOSS_RTOL,
                       param_rel_norm_rtol=MOE_PARAM_REL_NORM,
                       tokens_per_s=got["tokens_per_s"], tokens_per_s_one_rank=ref["tokens_per_s"],
                       peak_memory_gb_rank0=got["peak_memory_gb"],
                       peak_memory_gb_one_rank=ref["peak_memory_gb"],
                       host_staged_bytes_rank0=got["host_staged_bytes"],
                       expert_bytes_rank0=got["expert_bytes"], expert_bytes_one_rank=ref[
                           "expert_bytes"], experts_seen_rank0=got["experts_seen"],
                       launches_b1_b2_b3=got["launches"], launches_b1_b2_b3_one_rank=launches,
                       num_updates=[got["num_updates"], ref["num_updates"]], card=CARD)
            failures = []
            if first > MOE_FIRST_LOSS_RTOL:
                failures.append(f"first window's loss off by {first}")
            if versus["loss_rel_err"] > MOE_LOSS_RTOL or (
                    versus["param_rel_norm_err"] > MOE_PARAM_REL_NORM):
                failures.append(f"EP against one rank: {versus}")
            if row["num_updates"][0] != row["num_updates"][1]:
                failures.append("commit counts differ")
            if got["expert_bytes"] * MOE_TP_SHARDS != ref["expert_bytes"]:
                failures.append(f"expert bytes a rank {got['expert_bytes']}, one rank "
                                f"{ref['expert_bytes']}")
            if got["experts_seen"] != [E // MOE_TP_SHARDS]:
                failures.append(f"expert products saw {got['experts_seen']} experts")
            if [n * rows for n in got["launches"]] != list(launches):
                failures.append(f"B1-B3 launched {got['launches']} times a rank, one rank "
                                f"{launches} over {rows} workers rows")
            if cuda and backend == "gloo" and not got["host_staged_bytes"] > 0:
                failures.append("gloo on the card staged no byte through the host")
            if "captured" in got:  # over NCCL: the same run in captured windows
                graph = got["captured"]
                crow, cfail = _captured_row(graph, got, MOE_WINDOWS * TRAIN_WINDOW, MOE_EPOCHS)
                if not crow["vs_eager"]["bitwise"]:  # the one-rank gates still hold
                    v = _versus(graph, ref)
                    cfirst = (abs(graph["first_window_loss"] - ref["first_window_loss"])
                              / abs(ref["first_window_loss"]))
                    crow.update(vs_one_rank=v, first_window_loss_rel_err=cfirst)
                    if (cfirst > MOE_FIRST_LOSS_RTOL or v["loss_rel_err"] > MOE_LOSS_RTOL
                            or v["param_rel_norm_err"] > MOE_PARAM_REL_NORM):
                        cfail.append(f"not bitwise eager, and off one rank: {v}, "
                                     f"first {cfirst}")
                if graph["experts_seen"] != [E // MOE_TP_SHARDS]:
                    cfail.append(f"expert products saw {graph['experts_seen']} experts")
                row["captured"] = crow
                failures += [f"captured: {f}" for f in cfail]
            row["failures"] = failures
            emit(phase="moe", **row)
            out[case] = row
            if failures:
                raise AssertionError(f"moe: {case}: {failures}")
    if not cards:
        emit(phase="moe", case="cards", moe_cards_run=1, reason=NCCL_CARDS_REASON, card=CARD)
    return out


# pipeline phase: the train phase's DOWNPOUR over a GPT-2-small StagedLM (6
# of the 12 blocks as 2 stages of 3, f32, so that the script stays within its
# time with phase 26) on the pipeline engine's (workers, stages) grid, the
# two stage ranks sharing the card over gloo (grid 1 x 2), and on a 4-card
# machine the 2 x 2 grid over NCCL
PP_MODEL = dict(vocab_size=GPT2_SMALL["vocab_size"], dim=GPT2_SMALL["dim"],
                heads=GPT2_SMALL["heads"], num_stages=2, blocks_per_stage=3,
                max_len=GPT2_SMALL["max_len"])
# the ranks run ~50 s on one card: a hang surfaces with their output
# well inside a call's time
PP_MICROBATCHES, PP_RANK_TIMEOUT_S = 2, 300
# One epoch of PP_ROWS rows: the phase moves the head's [4, 1024, 50257]
# logits through the host a step (the last stage's outputs broadcast to the
# other, on gloo), so one epoch keeps it near the earlier phases' time
PP_EPOCHS = 1
# half the train phase's rows (4 local steps a worker): the gloo
# ranks' time goes with the logits moved through the host a step
PP_ROWS = 16
# against one rank: the seq and tp phases' gates for a layout against data
# parallelism (a microbatch's products see the same rows as the whole
# batch's; f32 round-off alone, and Adam's steps on the key bias)
PP_FIRST_LOSS_RTOL = SEQ_FIRST_LOSS_RTOL
PP_LOSS_RTOL, PP_PARAM_REL_NORM = SEQ_LOSS_RTOL, SEQ_PARAM_REL_NORM
PP_DECODE = (2, 16, 8)  # greedy decode: rows, prompt length, new tokens
PP_SERVE_REQUESTS = 3  # greedy requests to the serving engine over the trained StagedLM


def pp_train(seed: int, num_workers: int, seq_axis=None, model=None, **kwargs):
    """The train phase's ``DOWNPOUR`` (batch 4, window 2, Adam) over a
    ``StagedLM`` at ``model``'s widths (default ``PP_MODEL``; built with
    ``seq_axis``) for ``PP_EPOCHS`` epochs, with ``num_workers`` and the
    trainer's pipeline ``kwargs``: ``(trainer, run)``."""
    import distkeras_tpu_torch as tdk
    from distkeras_tpu_torch.models import StagedLM

    model = PP_MODEL if model is None else model
    x, y = lm_task(PP_ROWS, model["max_len"], model["vocab_size"], seed + 23)
    trainer = _keeping_fit(tdk.DOWNPOUR)(
        StagedLM(**model, seq_axis=seq_axis), loss="token_crossentropy",
        metrics=("token_accuracy",),
        worker_optimizer=("adam", {"learning_rate": 2e-4}), num_workers=num_workers,
        batch_size=TRAIN_BATCH, communication_window=TRAIN_WINDOW, num_epoch=PP_EPOCHS,
        seed=seed, device=ZOO_DEVICE, **kwargs)
    run = _trained(trainer, tdk.from_numpy(x, y))
    run.update(first_window_loss=trainer.window_losses[0],
               tokens_per_s=PP_EPOCHS * PP_ROWS * model["max_len"] / run["seconds"],
               local_steps=PP_EPOCHS * PP_ROWS // (num_workers * TRAIN_BATCH))
    return trainer, run


def _pp_resident(engine, state) -> dict:
    """This rank's bytes of the center's staged blocks and of its embedding
    and head, and the embed/head bytes the stage placement says it must
    hold (a leaf split over the stages a stage's share, a whole one whole)."""
    whole = engine.gather_center(state)
    dims = getattr(engine, "_pp_dims", None)
    stages = getattr(engine, "pp_stages", 1)
    layout = sum(v.numel() * v.element_size() // (stages if dims and dims[k][n] >= 0 else 1)
                 for k in ("embed", "head") for n, v in whole[k].items())
    return dict(block_bytes=_state_bytes(state.center_params["blocks"]),
                embed_head_bytes=_state_bytes([state.center_params["embed"],
                                               state.center_params["head"]]),
                embed_head_bytes_layout=layout)


def _pp_decode(model, seed: int) -> dict:
    """``greedy_generate`` over the trained ``StagedLM`` on this rank, then
    with ``pipelined=True`` over the stage ranks (each holding one stage's
    blocks and KV cache): both token arrays and their tokens/s."""
    from distkeras_tpu_torch.models import greedy_generate

    rows, length, steps = PP_DECODE
    prompt = np.random.default_rng(seed + 24).integers(
        0, PP_MODEL["vocab_size"], (rows, length)).astype(np.int32)
    out = {}
    for name, pipelined in (("sequential", False), ("pipelined", True)):
        t0 = time.perf_counter()
        out[name] = greedy_generate(model, prompt, steps, pipelined=pipelined)
        out[f"{name}_tokens_per_s"] = rows * steps / (time.perf_counter() - t0)
    return out


def _pp_serving(model, seed: int) -> dict:
    """A ``ServingEngine`` over the trained ``StagedLM`` (its ``decode_spec``)
    answering ``PP_SERVE_REQUESTS`` greedy requests, each held to
    ``greedy_generate`` (a departure only where its top-two gap is below
    ``GREEDY_GAP``)."""
    from distkeras_tpu_torch.models import greedy_generate
    from distkeras_tpu_torch.serving import GenerateRequest, ServingEngine
    from distkeras_tpu_torch.telemetry.metrics import Registry

    rows, length, steps = PP_DECODE
    rng = np.random.default_rng(seed + 25)
    prompts = [rng.integers(0, PP_MODEL["vocab_size"], length).tolist()
               for _ in range(PP_SERVE_REQUESTS)]
    engine = ServingEngine(model, num_slots=PP_SERVE_REQUESTS, page_size=16,
                           registry=Registry(), device=ZOO_DEVICE)
    try:
        pending = [engine.submit(GenerateRequest(prompt=p, max_new_tokens=steps))
                   for p in prompts]
        results = [p.result(timeout=600) for p in pending]
    finally:
        engine.stop()
    departures = []
    for prompt, result in zip(prompts, results):
        ref = greedy_generate(model, np.asarray([prompt], np.int32), steps)[0, length:].tolist()
        departures.append(_held_to_greedy(model, prompt, result.tokens, ref))
    return dict(requests=PP_SERVE_REQUESTS, new_tokens=steps,
                tokens=[r.tokens for r in results], departures=departures)


def _pp_runs(seed: int) -> dict:
    """One rank's share of the phase, in the group it is in (grid ``world /
    2 x 2``): the pipeline (``pipeline_stages=2``, ``pp_microbatches=2``)
    and ``fsdp=True`` on it, each with B1-B3's launches, the bytes staged
    through the host, peak memory and resident bytes; over NCCL both again
    in captured windows (``unroll=True``: the shifts, the broadcast from the
    last stage, the gradient sums, fsdp's gather and reduce-scatter and the
    commit inside the graphs), with one steady epoch each way; then greedy
    decode with the pipeline's model, sequential and pipelined, and on rank
    0 the serving engine over it."""
    import torch.distributed as dist

    from distkeras_tpu_torch.ops import (
        flash_attention,
        flash_attention_bwd_dkv,
        flash_attention_bwd_dq,
    )
    from distkeras_tpu_torch.parallel.mesh import transport_stats

    counters = (flash_attention, flash_attention_bwd_dq, flash_attention_bwd_dkv)
    on_card = ZOO_DEVICE == "cuda"
    nccl = _captures_here()
    workers = dist.get_world_size() // PP_MODEL["num_stages"]
    cases = [("pipeline", {}), ("fsdp", dict(fsdp=True))]
    if nccl:
        cases += [(f"{name}_graph", dict(kwargs, unroll=True)) for name, kwargs in cases]
    x, y = lm_task(PP_ROWS, PP_MODEL["max_len"], PP_MODEL["vocab_size"], seed + 23)
    out = {}
    for name, kwargs in cases:
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        for c in counters:
            c.launches = 0
        transport_stats["host_staged_bytes"] = 0
        trainer, run = pp_train(seed, workers, pipeline_stages=PP_MODEL["num_stages"],
                                pp_microbatches=PP_MICROBATCHES, **kwargs)
        engine, state, _ = trainer.fit_result
        run.update(launches=[c.launches for c in counters],
                   host_staged_bytes=transport_stats["host_staged_bytes"],
                   peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9 if on_card else None,
                   grid=list(engine.mesh.shape), engine=type(engine).__name__,
                   stage=engine.stage_index, num_updates=trainer.num_updates,
                   **_pp_resident(engine, state), **_graph_record(engine))
        if nccl:
            run.update(_steady_epoch(trainer, x, y, PP_ROWS * PP_MODEL["max_len"], workers))
        out[name] = run
        if name == "pipeline":
            model = trainer.parameter_server.model
        del trainer, engine, state
    transport_stats["host_staged_bytes"] = 0
    out["decode"] = _pp_decode(model, seed)
    out["decode"]["host_staged_bytes"] = transport_stats["host_staged_bytes"]
    if dist.get_rank() == 0:
        out["serving"] = _pp_serving(model, seed)
    return out


def pp_rank_main(spec_path: str) -> int:
    """One spawned rank of the pipeline phase: the parent's settings from
    ``spec_path``, the group joined, :func:`_pp_runs`, the group left on
    every path; every rank writes its runs (``OUT.<rank>``)."""
    import torch.distributed as dist

    global ZOO_DEVICE, PP_MODEL, PP_ROWS, TRAIN_BATCH, TRAIN_WINDOW, PP_EPOCHS
    global PP_MICROBATCHES, PP_DECODE, PP_SERVE_REQUESTS
    with open(spec_path, encoding="utf-8") as fh:
        spec = json.load(fh)
    ZOO_DEVICE, PP_MODEL = spec["device"], spec["model"]
    PP_ROWS, TRAIN_BATCH, TRAIN_WINDOW, PP_EPOCHS, PP_MICROBATCHES = spec["train"]
    PP_DECODE, PP_SERVE_REQUESTS = tuple(spec["decode"]), spec["serve_requests"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(spec["threads"])
    if ZOO_DEVICE == "cuda":
        torch.cuda.set_device(spec["device_index"])
    dist.init_process_group(spec["backend"], init_method=spec["init"],
                            world_size=spec["world"], rank=spec["rank"])
    try:
        runs = _pp_runs(spec["seed"])
    finally:
        _leave_group()
    torch.save(runs, f"{spec['out']}.{spec['rank']}")
    return 0


def _spawn_pp(seed: int, world: int, backend: str, cards: bool, workdir: str) -> list:
    """Every rank's runs, in rank order."""
    import os

    name = f"pp_{backend}_{world}"
    init, out = _rendezvous(workdir, name), os.path.join(workdir, name + ".pt")
    specs = [dict(seed=seed, device=ZOO_DEVICE, model=PP_MODEL, backend=backend,
                  train=[PP_ROWS, TRAIN_BATCH, TRAIN_WINDOW, PP_EPOCHS, PP_MICROBATCHES],
                  decode=list(PP_DECODE), serve_requests=PP_SERVE_REQUESTS, world=world,
                  rank=rank, init=init, out=out, device_index=rank if cards else 0,
                  threads=torch.get_num_threads())
             for rank in range(world)]
    _run_ranks("--pp-rank", specs, workdir, PP_RANK_TIMEOUT_S, "pipeline")
    return [torch.load(f"{out}.{rank}", weights_only=False) for rank in range(world)]


def _pp_one_rank(seed: int, num_workers: int, model=None) -> dict:
    """The reference: the same model (``model``, default ``PP_MODEL``) and
    data on one rank (``pipeline_stages=1``, the sequential executor) in
    this process, with B1-B3's launches, peak memory and resident bytes."""
    from distkeras_tpu_torch.ops import (
        flash_attention,
        flash_attention_bwd_dkv,
        flash_attention_bwd_dq,
    )

    counters = (flash_attention, flash_attention_bwd_dq, flash_attention_bwd_dkv)
    cuda = ZOO_DEVICE == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.launches = 0
    trainer, ref = pp_train(seed, num_workers, model=model)
    ref.update(launches=[c.launches for c in counters], num_updates=trainer.num_updates,
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9 if cuda else None,
               engine=type(trainer.fit_result[0]).__name__,
               **_pp_resident(*trainer.fit_result[:2]))
    del trainer
    if cuda:
        torch.cuda.empty_cache()
    return ref


def _pp_captured(ranks: list, name: str, steps: int) -> tuple:
    """Every rank's ``name`` run in captured windows against its eager twin
    (``_captured_row`` on rank 0, and on every rank the bitwise check, B1-B3
    ticks x replays against the eager launches and the peak GB both ways).
    The captured twin must be bitwise its eager twin: the same kernels and
    NCCL calls on the same inputs.  Returns ``(row, failures)``."""
    row, failures = _captured_row(ranks[0][f"{name}_graph"], ranks[0][name], steps, PP_EPOCHS)
    row.update(bitwise_per_rank=[], launches_b1_b2_b3_ticks_x_replays_per_rank=[],
               peak_memory_gb_per_rank=[], peak_memory_gb_per_rank_eager=[])
    for r, run in enumerate(ranks):
        graph, eager = run[f"{name}_graph"], run[name]
        crow, cfail = _captured_row(graph, eager, steps, PP_EPOCHS)
        row["bitwise_per_rank"].append(crow["vs_eager"]["bitwise"])
        row["launches_b1_b2_b3_ticks_x_replays_per_rank"].append(
            crow["launches_b1_b2_b3_ticks_x_replays"])
        row["peak_memory_gb_per_rank"].append(graph["peak_memory_gb"])
        row["peak_memory_gb_per_rank_eager"].append(eager["peak_memory_gb"])
        failures += [f"rank {r}: {f}" for f in cfail if r]
        if not crow["vs_eager"]["bitwise"]:
            failures.append(f"rank {r}: not bitwise its eager twin: {crow['vs_eager']}")
    return row, failures


def _pp_versus(ranks: list, ref: dict, backend: str) -> tuple:
    """The spawned grid's runs against the one-rank run, and the phase's
    gates."""
    S, P, M = PP_MODEL["num_stages"], PP_MODEL["blocks_per_stage"], PP_MICROBATCHES
    cuda = ZOO_DEVICE == "cuda"
    pp = ranks[0]["pipeline"]
    steps = pp["local_steps"]
    # the schedule: a stage rank computes on M of the M + S - 1 ticks of a
    # step, one microbatch each, through its P blocks (B1 in each forward,
    # B2 and B3 in each backward): P x M x local steps a kernel
    expected = [P * M * steps if cuda else 0] * 3
    versus = _versus(pp, ref)
    first = abs(pp["first_window_loss"] - ref["first_window_loss"]) / abs(ref["first_window_loss"])
    row = dict(grid=pp["grid"], microbatches=M, model="StagedLM", **PP_MODEL, batch_size=TRAIN_BATCH, window=TRAIN_WINDOW,
               epochs=PP_EPOCHS, rows=PP_ROWS, local_steps=steps, loss=pp["loss"],
               loss_one_rank=ref["loss"], first_window_loss_rel_err=first,
               first_window_loss_rtol=PP_FIRST_LOSS_RTOL, vs_one_rank=versus,
               loss_rtol=PP_LOSS_RTOL, param_rel_norm_rtol=PP_PARAM_REL_NORM,
               num_updates=[pp["num_updates"], ref["num_updates"]],
               seconds=pp["seconds"], tokens_per_s=pp["tokens_per_s"],
               tokens_per_s_one_rank=ref["tokens_per_s"],
               peak_memory_gb_per_rank=[r["pipeline"]["peak_memory_gb"] for r in ranks],
               peak_memory_gb_one_rank=ref["peak_memory_gb"],
               block_bytes_per_rank=[r["pipeline"]["block_bytes"] for r in ranks],
               block_bytes_one_rank=ref["block_bytes"],
               host_staged_bytes_per_rank=[r["pipeline"]["host_staged_bytes"] for r in ranks],
               launches_b1_b2_b3_per_rank=[r["pipeline"]["launches"] for r in ranks],
               launches_b1_b2_b3_expected=expected, launches_b1_b2_b3_one_rank=ref["launches"],
               launches_formula="blocks_per_stage x microbatches x local steps", card=CARD)
    failures = []
    if first > PP_FIRST_LOSS_RTOL:
        failures.append(f"first window's loss off by {first}")
    if versus["loss_rel_err"] > PP_LOSS_RTOL or versus["param_rel_norm_err"] > PP_PARAM_REL_NORM:
        failures.append(f"the pipeline against one rank: {versus}")
    if row["num_updates"][0] != row["num_updates"][1]:
        failures.append("commit counts differ")
    for r, got in enumerate(ranks):
        if got["pipeline"]["launches"] != expected or got["fsdp"]["launches"] != expected:
            failures.append(f"rank {r} launched B1-B3 {got['pipeline']['launches']} and "
                            f"{got['fsdp']['launches']} (fsdp) times, the schedule {expected}")
        if got["pipeline"]["block_bytes"] * S != ref["block_bytes"]:
            failures.append(f"rank {r} holds {got['pipeline']['block_bytes']} block bytes, "
                            f"one rank {ref['block_bytes']}")
        if got["pipeline"]["engine"] != "PipelineEngine" or got["pipeline"]["stage"] != r % S:
            failures.append(f"rank {r}: {got['pipeline']['engine']} stage "
                            f"{got['pipeline']['stage']}")
    fsdp = ranks[0]["fsdp"]
    row["fsdp"] = dict(vs_pipeline=_versus(fsdp, pp),
                       embed_head_bytes_per_rank=[r["fsdp"]["embed_head_bytes"] for r in ranks],
                       embed_head_bytes_layout=fsdp["embed_head_bytes_layout"],
                       embed_head_bytes_replicated=pp["embed_head_bytes"],
                       block_bytes_per_rank=[r["fsdp"]["block_bytes"] for r in ranks],
                       tokens_per_s=fsdp["tokens_per_s"],
                       peak_memory_gb_per_rank=[r["fsdp"]["peak_memory_gb"] for r in ranks],
                       host_staged_bytes_per_rank=[r["fsdp"]["host_staged_bytes"] for r in ranks])
    if not row["fsdp"]["vs_pipeline"]["bitwise"]:
        failures.append(f"fsdp is not the replicated pipeline bit for bit: {row['fsdp']}")
    for r, got in enumerate(ranks):
        f = got["fsdp"]
        # every leaf of embed and head splits in two but the head's 50257-wide
        # bias (odd: zero_shard_dim keeps it whole): just over half
        if not (f["embed_head_bytes"] == f["embed_head_bytes_layout"]
                and 2 * f["embed_head_bytes"] < 1.01 * pp["embed_head_bytes"]):
            failures.append(f"rank {r}: fsdp embed/head bytes {f['embed_head_bytes']}, the "
                            f"layout's {f['embed_head_bytes_layout']}, replicated "
                            f"{pp['embed_head_bytes']}")
    decode = [r["decode"] for r in ranks]
    row["decode"] = dict(rows=PP_DECODE[0], prompt=PP_DECODE[1], new_tokens=PP_DECODE[2],
                         pipelined_equals_sequential=[
                             bool(np.array_equal(d["pipelined"], d["sequential"])) for d in decode],
                         tokens_per_s_sequential=decode[0]["sequential_tokens_per_s"],
                         tokens_per_s_pipelined=decode[0]["pipelined_tokens_per_s"],
                         host_staged_bytes_rank0=decode[0]["host_staged_bytes"])
    if not all(row["decode"]["pipelined_equals_sequential"]):
        failures.append("pipelined decode departs from the sequential decode")
    if not all(np.array_equal(d["sequential"], decode[0]["sequential"]) for d in decode):
        failures.append("the ranks' trained models decode different tokens")
    row["serving"] = ranks[0]["serving"]
    if "pipeline_graph" in ranks[0]:  # over NCCL: the same runs in captured windows
        row["captured"] = {}
        for name in ("pipeline", "fsdp"):
            crow, cfail = _pp_captured(ranks, name, steps)
            row["captured"][name] = crow
            failures += [f"captured {name}: {f}" for f in cfail]
    if cuda and backend == "gloo" and not all(
            r["pipeline"]["host_staged_bytes"] > 0 for r in ranks):
        failures.append("gloo on the card staged no byte through the host")
    if not np.isfinite(pp["loss"]).all():
        failures.append(f"the history is not finite: {pp['loss']}")
    return row, failures


def _pp_one_stage_run(seed: int, unroll) -> dict:
    """A one-stage ``PipelineEngine`` over the phase's ``StagedLM`` (every
    block of ``PP_MODEL`` on the one stage, ``PP_MICROBATCHES`` microbatches),
    the train phase's Adam, batch and window, one worker: ``PP_EPOCHS``
    epochs of ``PP_ROWS`` rows and one steady epoch more, with ``unroll``.
    The losses of every epoch, the center, B1-B3's launches, the captured
    windows' record, seconds and tokens/s (whole and steady) and peak
    memory, as ``_captured_row`` reads them."""
    from distkeras_tpu_torch import algorithms
    from distkeras_tpu_torch.data import epoch_arrays
    from distkeras_tpu_torch.models import StagedLM
    from distkeras_tpu_torch.ops import (
        flash_attention,
        flash_attention_bwd_dkv,
        flash_attention_bwd_dq,
    )
    from distkeras_tpu_torch.parallel import PipelineEngine

    counters = (flash_attention, flash_attention_bwd_dq, flash_attention_bwd_dkv)
    cuda = ZOO_DEVICE == "cuda"
    depth = PP_MODEL["num_stages"] * PP_MODEL["blocks_per_stage"]
    model = StagedLM(**dict(PP_MODEL, num_stages=1, blocks_per_stage=depth))
    x, y = lm_task(PP_ROWS, PP_MODEL["max_len"], PP_MODEL["vocab_size"], seed + 23)
    engine = PipelineEngine(model, "token_crossentropy", ("adam", {"learning_rate": 2e-4}),
                            algorithms.Downpour(TRAIN_WINDOW), 1, microbatches=PP_MICROBATCHES,
                            metrics=(), unroll=unroll, device=ZOO_DEVICE)
    state = engine.init_state(torch.Generator().manual_seed(seed), None)
    xs, ys = engine.shard_batches(*epoch_arrays(x, y, 1, TRAIN_BATCH, TRAIN_WINDOW))
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.launches = 0
    tokens, losses, seconds = PP_ROWS * PP_MODEL["max_len"], [], []
    for _ in range(PP_EPOCHS + 1):
        t0 = time.perf_counter()
        state, stats = engine.run_epoch(state, xs, ys)  # ends on the stats' copy to the host
        seconds.append(time.perf_counter() - t0)
        losses.extend(np.asarray(stats["loss"]).tolist())
    whole = sum(seconds[:-1])
    run = dict(loss=losses, params={k: v.detach().float().cpu().clone() for k, v in
                                    _flat_params(engine.gather_center(state)).items()},
               launches=[c.launches for c in counters], seconds=whole,
               tokens_per_s=PP_EPOCHS * tokens / whole, steady_seconds=seconds[-1],
               steady_tokens_per_s=tokens / seconds[-1], use_graphs=engine.use_graphs,
               group=engine.group is not None,
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9 if cuda else None,
               **_graph_record(engine))
    del engine, state
    if cuda:
        torch.cuda.empty_cache()
    return run


def _pp_one_stage_captured(seed: int) -> tuple:
    """Phase 23 (a)'s captured check: :func:`_pp_one_stage_run` eager and with
    ``unroll=True``, on a card over a one-rank NCCL group (as phase 18's
    mesh; none on a CPU rehearsal, where ``unroll`` is inert): the captured
    run bitwise the eager one, at least one capture with replays, B1-B3
    ticks x replays the eager launches (``blocks x microbatches x local
    steps``), and tokens/s and peak GB both ways.  Returns ``(row,
    failures)``."""
    import torch.distributed as dist

    from distkeras_tpu_torch import networking

    cuda = ZOO_DEVICE == "cuda"
    group = cuda and not (dist.is_available() and dist.is_initialized())
    if group:
        networking.initialize(f"127.0.0.1:{_free_port()}", 1, 0, device=ZOO_DEVICE)
    try:
        runs = {name: _pp_one_stage_run(seed, unroll)
                for name, unroll in (("eager", 1), ("graph", True))}
    finally:
        if group:
            networking.shutdown()
    eager, graph = runs["eager"], runs["graph"]
    steps = PP_ROWS // TRAIN_BATCH
    depth = PP_MODEL["num_stages"] * PP_MODEL["blocks_per_stage"]
    row, failures = _captured_row(graph, eager, steps, PP_EPOCHS)
    row.update(model="StagedLM", **dict(PP_MODEL, num_stages=1, blocks_per_stage=depth),
               microbatches=PP_MICROBATCHES, epochs=PP_EPOCHS, steady_epochs=1,
               one_rank_nccl_group=group and graph["group"],
               peak_memory_gb=graph["peak_memory_gb"],
               peak_memory_gb_eager=eager["peak_memory_gb"],
               launches_formula="blocks x microbatches x local steps (the steady epoch's too)")
    expected = [depth * PP_MICROBATCHES * steps * (PP_EPOCHS + 1) if cuda else 0] * 3
    if eager["launches"] != expected:
        failures.append(f"B1-B3 ran {eager['launches']} times eagerly, expected {expected}")
    if not cuda:  # no capture on the CPU: the eager run twice
        failures = [f for f in failures if not f.startswith("no window was captured")]
    elif not (graph["use_graphs"] and row["vs_eager"]["bitwise"]):
        failures.append(f"not bitwise its eager run: {row['vs_eager']}")
    return row, failures


def pipeline_phase(seed: int, pair: bool = True) -> dict:
    """Pipeline parallelism at GPT-2-small widths (a ``StagedLM``, 6 blocks
    as 2 stages of 3, ``PP_EPOCHS`` epochs of ``PP_ROWS`` rows of the train phase's
    ``DOWNPOUR``): (a) the same model on one rank (``pipeline_stages=1``,
    the sequential executor, B1-B3 6 a step) in this process, and a
    one-stage ``PipelineEngine`` over the same blocks in captured windows
    against its eager run (:func:`_pp_one_stage_captured`: bitwise, B1-B3
    ticks x replays the eager launches); (b)
    two gloo ranks spawned on the card (``--pp-rank``), grid 1 x 2,
    ``pipeline_stages=2, pp_microbatches=2``: the first window, history and
    center against (a) within the seq phase's gates, B1-B3 launched on each
    rank as the schedule predicts (``blocks_per_stage x microbatches x
    local steps``), each rank's blocks half of one rank's; ``fsdp=True`` bit
    for bit the replicated pipeline, its embed/head in stage halves; the
    trained model's greedy decode pipelined over the ranks token for token
    its sequential decode; a ``ServingEngine`` over it held to
    ``greedy_generate``; (c) on a machine with 4 cards, NCCL, one rank a
    card, grid 2 x 2 against a 2-worker one-rank run, the same checks, and
    the pipeline and fsdp runs again in captured windows, each bitwise its
    eager twin with B1-B3 ticks x replays its eager launches on every rank
    (else ``pp_cards_run: 1``).  ``pair=False`` skips (b)."""
    import tempfile

    captured, failures = _pp_one_stage_captured(seed)
    if failures:
        raise AssertionError(f"pipeline: the one-stage pipeline in captured windows: {failures}: "
                             f"{captured}")
    ref = _pp_one_rank(seed, 1)
    emit(phase="pipeline", case="one_rank", model="StagedLM", **PP_MODEL, workers=1,
         batch_size=TRAIN_BATCH, window=TRAIN_WINDOW, epochs=PP_EPOCHS, loss=ref["loss"],
         first_window_loss=ref["first_window_loss"], tokens_per_s=ref["tokens_per_s"],
         seconds=ref["seconds"], peak_memory_gb=ref["peak_memory_gb"],
         launches_b1_b2_b3=ref["launches"], engine=ref["engine"], block_bytes=ref["block_bytes"],
         embed_head_bytes=ref["embed_head_bytes"], captured_one_stage=captured, card=CARD)
    out = {"one_rank": ref, "captured_one_stage": captured}
    count = torch.cuda.device_count() if ZOO_DEVICE == "cuda" else 1
    with tempfile.TemporaryDirectory() as workdir:
        runs = [("two_ranks_one_card", 2, "gloo", False)] if pair else []
        if count >= 4:
            runs.append(("cards", 4, "nccl", True))
        for case, world, backend, cards in runs:
            reference = ref if world == PP_MODEL["num_stages"] else _pp_one_rank(
                seed, world // PP_MODEL["num_stages"])
            got = _spawn_pp(seed, world, backend, cards, workdir)
            row, failures = _pp_versus(got, reference, backend)
            row = dict(case=case, backend=backend, ranks=world,
                       **({"pp_cards_run": world} if cards else {}), **row, failures=failures)
            emit(phase="pipeline", **row)
            out[case] = row
            if failures:
                raise AssertionError(f"pipeline: {case}: {failures}")
    if count < 4:
        emit(phase="pipeline", case="cards", pp_cards_run=1,
             reason="the 2 x 2 grid over NCCL needs torch.cuda.device_count() >= 4", card=CARD)
    return out


# pipeline_3d phase: phase 23's StagedLM and DOWNPOUR on the pipeline
# engine's 3-D grids, four gloo ranks sharing the card (grid 1 x 2 x 2):
# pipeline x tensor parallelism (tp_shards=2; then with fsdp) and pipeline x
# sequence parallelism (seq_shards=2, the model built with seq_axis), against
# phase 23's one-rank run; on a 4-card machine both grids over NCCL
PP3D_SHARDS = 2
# four ranks on one card, each step's collectives through the host: a hang
# surfaces with their output well inside a call's time
PP3D_RANK_TIMEOUT_S = 600
PP3D_CASES = (("tp", dict(tp_shards=PP3D_SHARDS), None),
              ("tp_fsdp", dict(tp_shards=PP3D_SHARDS, fsdp=True), None),
              ("sp", dict(seq_shards=PP3D_SHARDS), "seq"))
PP3D_PREDICT_ROWS = 1  # rows the returned model predicts on rank 0 (per-token, 50257 wide)
# phase 23's widths cut to 3 blocks a stage (6 of 12), so that the whole
# script stays within its time with phases 25 and 26; its one-rank
# reference is made at the same depth (phase 23's run, when they agree)
PP3D_BLOCKS_PER_STAGE = 3


def _pp3d_model() -> dict:
    """Phase 24's ``StagedLM``: ``PP_MODEL`` with at most
    ``PP3D_BLOCKS_PER_STAGE`` blocks a stage."""
    return dict(PP_MODEL, blocks_per_stage=min(PP_MODEL["blocks_per_stage"],
                                               PP3D_BLOCKS_PER_STAGE))


def _pp3d_runs(seed: int) -> dict:
    """One rank's share of the phase, in the group it is in (grid ``world /
    4 x 2 x 2``): each of :data:`PP3D_CASES` through ``DOWNPOUR(...,
    pipeline_stages=2, pp_microbatches=2, ...)`` with B1-B3's launches, the
    bytes staged through the host, peak memory and the center's block
    bytes; on rank 0 the returned model's predictions on one rank.  Over
    NCCL every case again in captured windows (``unroll=True``: the stage
    shifts, the model axis's gathers and psums or the ring's hops, the
    gradient sums and the commit inside the graphs), with one steady epoch
    each way."""
    import torch.distributed as dist

    from distkeras_tpu_torch.ops import (
        flash_attention,
        flash_attention_bwd_dkv,
        flash_attention_bwd_dq,
    )
    from distkeras_tpu_torch.parallel.mesh import transport_stats

    counters = (flash_attention, flash_attention_bwd_dq, flash_attention_bwd_dkv)
    on_card = ZOO_DEVICE == "cuda"
    nccl = _captures_here()
    S = PP_MODEL["num_stages"]
    workers = dist.get_world_size() // (S * PP3D_SHARDS)
    x, _ = lm_task(PP3D_PREDICT_ROWS, PP_MODEL["max_len"], PP_MODEL["vocab_size"], seed + 26)
    tx, ty = lm_task(PP_ROWS, PP_MODEL["max_len"], PP_MODEL["vocab_size"], seed + 23)
    cases = list(PP3D_CASES)
    if nccl:
        cases += [(f"{name}_graph", dict(kwargs, unroll=True), seq_axis)
                  for name, kwargs, seq_axis in PP3D_CASES]
    out = {}
    for name, kwargs, seq_axis in cases:
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        for c in counters:
            c.launches = 0
        transport_stats["host_staged_bytes"] = 0
        trainer, run = pp_train(seed, workers, seq_axis=seq_axis, pipeline_stages=S,
                                pp_microbatches=PP_MICROBATCHES, **kwargs)
        engine, state, _ = trainer.fit_result
        run.update(launches=[c.launches for c in counters],
                   host_staged_bytes=transport_stats["host_staged_bytes"],
                   peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9 if on_card else None,
                   grid=list(engine.mesh.shape), axes=list(engine.mesh.mesh_dim_names),
                   engine=type(engine).__name__, stage=engine.stage_index,
                   num_updates=trainer.num_updates,
                   block_bytes=_state_bytes(state.center_params["blocks"]),
                   embed_head_bytes=_state_bytes([state.center_params["embed"],
                                                  state.center_params["head"]]),
                   **_graph_record(engine))
        if nccl:
            run.update(_steady_epoch(trainer, tx, ty, PP_ROWS * PP_MODEL["max_len"], workers))
        del engine, state
        if dist.get_rank() == 0 and not name.endswith("_graph"):
            model = trainer.parameter_server.model
            probs = np.asarray(model.predict(x))
            run["predict"] = dict(shape=list(probs.shape), finite=bool(np.isfinite(probs).all()),
                                  row_sum_err=float(np.abs(probs.sum(-1) - 1.0).max()),
                                  seq_axis=str(model.adapter.seq_axis))
            del model, probs
        out[name] = run
        del trainer
    return out


def pp3d_rank_main(spec_path: str) -> int:
    """One spawned rank of the pipeline_3d phase: the parent's settings from
    ``spec_path``, the group joined, :func:`_pp3d_runs`, the group left on
    every path; every rank writes its runs (``OUT.<rank>``)."""
    import torch.distributed as dist

    global ZOO_DEVICE, PP_MODEL, PP_ROWS, TRAIN_BATCH, TRAIN_WINDOW, PP_EPOCHS
    global PP_MICROBATCHES
    with open(spec_path, encoding="utf-8") as fh:
        spec = json.load(fh)
    ZOO_DEVICE, PP_MODEL = spec["device"], spec["model"]
    PP_ROWS, TRAIN_BATCH, TRAIN_WINDOW, PP_EPOCHS, PP_MICROBATCHES = spec["train"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(spec["threads"])
    if ZOO_DEVICE == "cuda":
        torch.cuda.set_device(spec["device_index"])
    dist.init_process_group(spec["backend"], init_method=spec["init"],
                            world_size=spec["world"], rank=spec["rank"])
    try:
        runs = _pp3d_runs(spec["seed"])
    finally:
        _leave_group()
    torch.save(runs, f"{spec['out']}.{spec['rank']}")
    return 0


def _spawn_pp3d(seed: int, world: int, backend: str, cards: bool, workdir: str) -> list:
    """Every rank's runs, in rank order."""
    import os

    name = f"pp3d_{backend}_{world}"
    init, out = _rendezvous(workdir, name), os.path.join(workdir, name + ".pt")
    specs = [dict(seed=seed, device=ZOO_DEVICE, model=_pp3d_model(), backend=backend,
                  train=[PP_ROWS, TRAIN_BATCH, TRAIN_WINDOW, PP_EPOCHS, PP_MICROBATCHES],
                  world=world, rank=rank, init=init, out=out,
                  device_index=rank if cards else 0,
                  # four ranks share the machine's cores
                  threads=max(1, torch.get_num_threads() // world))
             for rank in range(world)]
    _run_ranks("--pp3d-rank", specs, workdir, PP3D_RANK_TIMEOUT_S, "pipeline_3d")
    return [torch.load(f"{out}.{rank}", weights_only=False) for rank in range(world)]


def _pp3d_versus(ranks: list, ref: dict, backend: str) -> tuple:
    """The spawned grid's runs against the one-rank run, and the phase's
    gates."""
    model = _pp3d_model()
    S, P, M = model["num_stages"], model["blocks_per_stage"], PP_MICROBATCHES
    k = PP3D_SHARDS
    cuda = ZOO_DEVICE == "cuda"
    steps = ranks[0]["tp"]["local_steps"]
    # pp x tp: every model rank of a stage runs its M of the M + S - 1 ticks
    # through its P blocks, all heads on each (B1 in each forward, B2 and B3
    # in each backward); pp x sp: the ring's blocks are plain products
    expected = {"tp": [P * M * steps if cuda else 0] * 3, "tp_fsdp": [P * M * steps if cuda else 0] * 3,
                "sp": [0, 0, 0]}
    # the center's blocks a rank: its stage's, and of them its model block
    # (every staged leaf splits at these widths) or all of them (seq)
    share = {"tp": S * k, "tp_fsdp": S * k, "sp": S}
    failures, row = [], dict(grid=ranks[0]["tp"]["grid"], microbatches=M, model="StagedLM",
                             **model, batch_size=TRAIN_BATCH, window=TRAIN_WINDOW,
                             epochs=PP_EPOCHS, rows=PP_ROWS, local_steps=steps,
                             loss_one_rank=ref["loss"], tokens_per_s_one_rank=ref["tokens_per_s"],
                             peak_memory_gb_one_rank=ref["peak_memory_gb"],
                             block_bytes_one_rank=ref["block_bytes"],
                             launches_b1_b2_b3_one_rank=ref["launches"],
                             first_window_loss_rtol=PP_FIRST_LOSS_RTOL, loss_rtol=PP_LOSS_RTOL,
                             param_rel_norm_rtol=PP_PARAM_REL_NORM,
                             launches_formula="tp: blocks_per_stage x microbatches x local "
                                              "steps; sp: 0 (the ring's plain products)",
                             card=CARD)
    for name, _, seq_axis in PP3D_CASES:
        got = ranks[0][name]
        versus = _versus(got, ref)
        first = (abs(got["first_window_loss"] - ref["first_window_loss"])
                 / abs(ref["first_window_loss"]))
        case = dict(axes=got["axes"], loss=got["loss"], first_window_loss_rel_err=first,
                    vs_one_rank=versus, num_updates=[got["num_updates"], ref["num_updates"]],
                    seconds=got["seconds"], tokens_per_s=got["tokens_per_s"],
                    peak_memory_gb_per_rank=[r[name]["peak_memory_gb"] for r in ranks],
                    block_bytes_per_rank=[r[name]["block_bytes"] for r in ranks],
                    embed_head_bytes_per_rank=[r[name]["embed_head_bytes"] for r in ranks],
                    host_staged_bytes_per_rank=[r[name]["host_staged_bytes"] for r in ranks],
                    launches_b1_b2_b3_per_rank=[r[name]["launches"] for r in ranks],
                    launches_b1_b2_b3_expected=expected[name], predict=got["predict"])
        row[name] = case
        if first > PP_FIRST_LOSS_RTOL:
            failures.append(f"{name}: first window's loss off by {first}")
        if versus["loss_rel_err"] > PP_LOSS_RTOL or versus["param_rel_norm_err"] > PP_PARAM_REL_NORM:
            failures.append(f"{name} against one rank: {versus}")
        if case["num_updates"][0] != case["num_updates"][1]:
            failures.append(f"{name}: commit counts differ")
        if not np.isfinite(got["loss"]).all():
            failures.append(f"{name}: the history is not finite: {got['loss']}")
        pred = got["predict"]
        if not (pred["finite"] and pred["shape"] == [PP3D_PREDICT_ROWS, model["max_len"],
                                                     model["vocab_size"]]
                and pred["row_sum_err"] < 1e-4 and pred["seq_axis"] == "None"):
            failures.append(f"{name}: the returned model's predictions on one rank: {pred}")
        for r, run in enumerate(ranks):
            mine = run[name]
            if mine["launches"] != expected[name]:
                failures.append(f"{name}: rank {r} launched B1-B3 {mine['launches']} times, "
                                f"expected {expected[name]}")
            if mine["block_bytes"] * share[name] != ref["block_bytes"]:
                failures.append(f"{name}: rank {r} holds {mine['block_bytes']} block bytes, one "
                                f"rank {ref['block_bytes']}")
            stage = (r // k) % S  # mesh rank (w, s, m) is global rank (w S + s) k + m
            if (mine["engine"] != "PipelineEngine" or mine["stage"] != stage
                    or mine["axes"] != ["workers", "stages", "seq" if seq_axis else "model"]):
                failures.append(f"{name}: rank {r}: {mine['engine']} stage {mine['stage']} "
                                f"axes {mine['axes']}")
            if cuda and backend == "gloo" and mine["host_staged_bytes"] <= 0:
                failures.append(f"{name}: rank {r} on gloo staged no byte through the host")
    if "tp_graph" in ranks[0]:  # over NCCL: every case in captured windows
        row["captured"] = {}
        for name, _, _ in PP3D_CASES:
            crow, cfail = _pp_captured(ranks, name, steps)
            row["captured"][name] = crow
            failures += [f"captured {name}: {f}" for f in cfail]
    row["tp_fsdp"]["vs_tp"] = _versus(ranks[0]["tp_fsdp"], ranks[0]["tp"])
    if not row["tp_fsdp"]["vs_tp"]["bitwise"]:
        failures.append(f"tp_fsdp is not pp x tp bit for bit: {row['tp_fsdp']['vs_tp']}")
    for r, run in enumerate(ranks):
        # fsdp splits every embed/head leaf over the stages but the head's
        # odd 50257-wide bias: just over half of the replicated bytes
        f, t = run["tp_fsdp"]["embed_head_bytes"], run["tp"]["embed_head_bytes"]
        if not 2 * f < 1.01 * t:
            failures.append(f"tp_fsdp: rank {r} holds {f} embed/head bytes, replicated {t}")
    return row, failures


def pipeline_3d_phase(seed: int, ref: dict, pair: bool = True) -> dict:
    """Pipeline x tensor and pipeline x sequence parallelism at GPT-2-small
    widths (phase 23's ``StagedLM`` and ``DOWNPOUR``, cut to 6 blocks as 2
    stages of 3, :func:`_pp3d_model`, on ``PP_ROWS`` rows), against ``ref``, the same model's
    one-rank run (``_pp_one_rank(seed, 1, _pp3d_model())``): (a) four gloo
    ranks spawned on the card (``--pp3d-rank``), grid 1 x 2 x 2:
    ``tp_shards=2``, then with ``fsdp=True`` (bit for bit the replicated
    run), then ``seq_shards=2`` with the model built ``seq_axis="seq"``:
    each run's first window, history and center within phase 23's gates,
    B1-B3 launched on each rank ``blocks_per_stage x microbatches x local
    steps`` times (tp) or never (sp), each rank's blocks a quarter (tp) or
    half (sp) of one rank's, the returned model predicting on one rank; and
    ``tp_shards=2`` with ``seq_shards=2`` refused in JAX's words; (b) on a
    machine with 4 cards, the same over NCCL, one rank a card (else
    ``pp3d_cards_run: 1``).  ``pair=False`` skips (a)."""
    import tempfile

    from distkeras_tpu_torch import algorithms
    from distkeras_tpu_torch.models import StagedLM
    from distkeras_tpu_torch.parallel import PipelineEngine

    refused = None
    try:
        PipelineEngine(StagedLM(**dict(PP_MODEL, num_stages=1, blocks_per_stage=1),
                                seq_axis="seq"), "token_crossentropy", "adam",
                       algorithms.Downpour(TRAIN_WINDOW), tp_shards=2, seq_shards=2,
                       device=ZOO_DEVICE)
    except ValueError as e:
        refused = str(e)
    if refused is None or "not supported" not in refused:
        raise AssertionError(f"pipeline_3d: tp_shards=2 with seq_shards=2 was not refused: "
                             f"{refused}")
    out = {}
    count = torch.cuda.device_count() if ZOO_DEVICE == "cuda" else 1
    with tempfile.TemporaryDirectory() as workdir:
        runs = [("four_ranks_one_card", 4, "gloo", False)] if pair else []
        if count >= 4:
            runs.append(("cards", 4, "nccl", True))
        for case, world, backend, cards in runs:
            t0 = time.perf_counter()
            got = _spawn_pp3d(seed, world, backend, cards, workdir)
            row, failures = _pp3d_versus(got, ref, backend)
            row = dict(case=case, backend=backend, ranks=world,
                       **({"pp3d_cards_run": world} if cards else {}), **row,
                       both_axes_refused=refused, seconds=time.perf_counter() - t0,
                       failures=failures)
            emit(phase="pipeline_3d", **row)
            out[case] = row
            if failures:
                raise AssertionError(f"pipeline_3d: {case}: {failures}")
    if count < 4:
        emit(phase="pipeline_3d", case="cards", pp3d_cards_run=1,
             reason="the 1 x 2 x 2 grids over NCCL, one rank a card, need "
                    "torch.cuda.device_count() >= 4", card=CARD)
    return out


# hf_telemetry phase: a GPT-2-small checkpoint's layout (GPT2LMHeadModel's
# state-dict names and shapes, random from --seed at std 0.02; the card's
# machine has no transformers) converted by gpt2_state_to_staged into a
# PretrainedStagedLM of 2 stages, its forward on the card, the train phase's
# one-rank DOWNPOUR over it with the training telemetry off and on, and the
# fine-tuned model served over the flight deck's HTTP exporter
HF_CONFIG = dict(vocab_size=GPT2_SMALL["vocab_size"], n_positions=GPT2_SMALL["max_len"],
                 n_embd=GPT2_SMALL["dim"], n_head=GPT2_SMALL["heads"],
                 n_layer=GPT2_SMALL["num_layers"], n_inner=None,
                 activation_function="gelu_new", layer_norm_epsilon=1e-5,
                 tie_word_embeddings=True)
HF_STAGES = 2
HF_STD = 0.02
HF_FORWARD_ROWS = 2  # rows of n_positions tokens in the forward check
HF_EPOCHS = 1  # of TRAIN_ROWS rows: TRAIN_ROWS / TRAIN_BATCH local steps
HF_SERVE = (3, 32, 16)  # HTTP requests, prompt tokens, greedy new tokens each
HF_FLASH = ("flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")
HF_TENANTS = ("a", "a", "b")  # the tenant of each HTTP request, in turn


def gpt2_state(config: dict, seed: int) -> dict:
    """A ``GPT2LMHeadModel`` state dict of ``config``'s shapes: matrices and
    embeddings normal at ``HF_STD`` from ``seed``, LayerNorms at identity,
    biases zero, ``lm_head.weight`` the tied embedding (HF's own init)."""
    g = torch.Generator().manual_seed(seed)
    d, n = config["n_embd"], config["n_layer"]

    def normal(*shape):
        return torch.randn(*shape, generator=g) * HF_STD

    sd = {"transformer.wte.weight": normal(config["vocab_size"], d),
          "transformer.wpe.weight": normal(config["n_positions"], d)}
    for i in range(n):
        pre = f"transformer.h.{i}."
        for ln in ("ln_1", "ln_2"):
            sd[pre + ln + ".weight"], sd[pre + ln + ".bias"] = torch.ones(d), torch.zeros(d)
        for name, (fan_in, fan_out) in (("attn.c_attn", (d, 3 * d)), ("attn.c_proj", (d, d)),
                                        ("mlp.c_fc", (d, 4 * d)), ("mlp.c_proj", (4 * d, d))):
            sd[pre + name + ".weight"] = normal(fan_in, fan_out)  # Conv1D: (in, out)
            sd[pre + name + ".bias"] = torch.zeros(fan_out)
    sd["transformer.ln_f.weight"], sd["transformer.ln_f.bias"] = torch.ones(d), torch.zeros(d)
    sd["lm_head.weight"] = sd["transformer.wte.weight"]
    return sd


def _hf_train(staged, seed: int, **kwargs):
    """The train phase's one-rank ``DOWNPOUR`` (batch 4, window 2, Adam) over
    the converted model for ``HF_EPOCHS`` epochs: ``(trainer, run)`` with
    B1-B3's launches in the run."""
    import distkeras_tpu_torch as tdk
    from distkeras_tpu_torch.ops import (
        flash_attention,
        flash_attention_bwd_dkv,
        flash_attention_bwd_dq,
    )

    counters = (flash_attention, flash_attention_bwd_dq, flash_attention_bwd_dkv)
    x, y = lm_task(TRAIN_ROWS, HF_CONFIG["n_positions"], HF_CONFIG["vocab_size"], seed + 26)
    trainer = tdk.DOWNPOUR(staged, loss="token_crossentropy", metrics=("token_accuracy",),
                           worker_optimizer=("adam", {"learning_rate": 2e-4}), num_workers=1,
                           batch_size=TRAIN_BATCH, communication_window=TRAIN_WINDOW,
                           num_epoch=HF_EPOCHS, seed=seed, device=ZOO_DEVICE, **kwargs)
    for c in counters:
        c.launches = 0
    run = _trained(trainer, tdk.from_numpy(x, y))
    run.update(launches=[c.launches for c in counters], model=trainer.parameter_server.model,
               history={k: v for k, v in trainer.get_history().items() if k != "training_time"},
               tokens_per_s=HF_EPOCHS * TRAIN_ROWS * HF_CONFIG["n_positions"] / run["seconds"])
    return trainer, run


def _hf_sanitized(staged, seed: int) -> dict:
    """``_hf_train`` under the runtime sanitizer, strict: each epoch's
    device work inside the transfer guard (on the card, torch's sync debug
    mode armed), the consumed input state poisoned after it.  Returns the
    run with the violations, the donation and declared-transfer counts,
    what a read of the first consumed state raised, and the tokens/s of the
    same training with the sanitizer off just before and just after it (the
    like-for-like comparison: same telemetry, all after the phase's
    warm-up)."""
    from distkeras_tpu_torch import sanitizer
    from distkeras_tpu_torch.sanitizer import donation, transfer

    _, unsanitized = _hf_train(staged, seed)

    consumed = []
    poison = donation.poison

    def recording(state, label="consumed state"):
        consumed.append(state)
        return poison(state, label)

    sanitizer.configure("strict")
    donation.reset_stats()
    transfer.reset_stats()
    donation.poison = recording
    try:
        try:
            _, run = _hf_train(staged, seed)
            run["error"] = None
        except sanitizer.SanitizerViolation as e:
            run = {"error": f"{type(e).__name__}: {e}"}
        run.update(violations=sanitizer.violations(), donation=donation.stats(),
                   declared=transfer.stats()["declared"],
                   tokens_per_s_unsanitized=[unsanitized["tokens_per_s"]])
        try:
            consumed[0].center_params  # noqa: B018 — the read is the check
            run["stale_read"] = None
        except sanitizer.SanitizerViolation as e:
            run["stale_read"] = str(e)
        except IndexError:
            run["stale_read"] = None
    finally:
        donation.poison = poison
        sanitizer.configure(None)
    run["tokens_per_s_unsanitized"].append(_hf_train(staged, seed)[1]["tokens_per_s"])
    return run


def _default_serving_objectives():
    from distkeras_tpu_torch.telemetry import slo

    return slo.default_serving_objectives()


def _planted_sync() -> dict:
    """A sync the transfer guard's interposition does not cover
    (``torch.nonzero`` of a tensor on the card) inside a strict
    ``transfer.guard("planted")``, then the same call outside it: what the
    first raised (None: nothing) and what the second returned."""
    from distkeras_tpu_torch import sanitizer
    from distkeras_tpu_torch.sanitizer import transfer

    x = torch.arange(8, device=ZOO_DEVICE)
    sanitizer.configure("strict")
    try:
        try:
            with transfer.guard("planted"):
                torch.nonzero(x)
            caught = None
        except transfer.TransferViolation as e:
            caught = str(e)
        outside = int(torch.nonzero(x).shape[0])
    finally:
        sanitizer.configure(None)
    return dict(caught=caught, outside_rows=outside)


def _hf_http(model, seed: int) -> dict:
    """The fine-tuned model behind ``install_http_endpoint`` on the flight
    deck's exporter (127.0.0.1, an ephemeral port), built with the runtime
    sanitizer strict (its condition variable under the lock watchdog) and
    the per-tenant ledger on: ``HF_SERVE``'s greedy requests posted at once
    for the tenants of ``HF_TENANTS``, each held to ``greedy_generate``,
    their latencies, a ``/metrics``, a ``/ledger`` and a ``/healthz``
    scrape, and ``/slo`` serving one engine of the default serving
    objectives, evaluated once over the rollup ring."""
    import threading
    import urllib.request

    from distkeras_tpu_torch import sanitizer, telemetry
    from distkeras_tpu_torch.models import greedy_generate
    from distkeras_tpu_torch.serving import ServingEngine, install_http_endpoint
    from distkeras_tpu_torch.telemetry import accounting, slo
    from distkeras_tpu_torch.telemetry.flightdeck import rollup
    from distkeras_tpu_torch.telemetry.flightdeck import server as server_mod

    n, length, steps = HF_SERVE
    tenants = [HF_TENANTS[i % len(HF_TENANTS)] for i in range(n)]
    rng = np.random.default_rng(seed + 27)
    prompts = [rng.integers(0, HF_CONFIG["vocab_size"], length).tolist() for _ in range(n)]
    server_mod.configure(0)
    address = telemetry.flightdeck.ensure_server()
    sanitizer.configure("strict")
    accounting.configure(True)
    accounting.reset()
    rollup.configure(1.0)
    engine = ServingEngine(model, num_slots=n, page_size=16, registry=None, device=ZOO_DEVICE)
    replies, seconds = [None] * n, [None] * n

    def get(path):
        with urllib.request.urlopen(f"http://{address}{path}", timeout=60) as r:
            return r.read().decode()

    def post(i):
        body = json.dumps({"prompt": prompts[i], "max_new_tokens": steps,
                           "tenant": tenants[i]}).encode()
        req = urllib.request.Request(f"http://{address}/generate", data=body,
                                     headers={"Content-Type": "application/json"})
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=600) as r:
            replies[i] = (r.status, json.loads(r.read()))
        seconds[i] = time.perf_counter() - t0

    try:
        install_http_endpoint(engine)
        threads = [threading.Thread(target=post, args=(i,)) for i in range(n)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        scrape = get("/metrics")
        ledger = json.loads(get("/ledger"))
        health = json.loads(get("/healthz"))
        lockwatched = type(engine._cv).__name__
        objectives = slo.maybe_engine(slo.default_serving_objectives(), source="serving")
        if objectives is not None:
            objectives.evaluate()
        slo_view = json.loads(get("/slo"))
    finally:
        engine.stop()
        server_mod.stop()
        server_mod.configure(None)
        sanitizer.configure(None)
        accounting.configure(None)
        accounting.reset()
        rollup.stop()
        rollup.configure(None)
        slo.reset_engines()
    departures = []
    for prompt, reply in zip(prompts, replies):
        if reply is None or reply[0] != 200:
            raise AssertionError(f"hf_telemetry: an HTTP request failed: {reply}")
        ref = greedy_generate(model, np.asarray([prompt], np.int32), steps)[0, length:].tolist()
        departures.append(_held_to_greedy(model, prompt, reply[1]["tokens"], ref))
    rid = telemetry.flightdeck.current_run_id()
    tokens_line = next((line for line in scrape.splitlines()
                        if line.startswith(f'serving_tokens_total{{run_id="{rid}"}}')), None)
    rows = {r["tenant"]: r for r in ledger.get("tenants", [])}
    engines = slo_view.get("engines", {})
    return dict(address=address, requests=n, prompt=length, new_tokens=steps,
                tokens=[r[1]["tokens"] for r in replies], departures=departures,
                latency_s=seconds, run_id=rid, scrape_tokens_line=tokens_line,
                scrape_has_ttft="serving_ttft_seconds_bucket{" in scrape,
                tenants=tenants, ledger_enabled=ledger.get("enabled"),
                ledger_tenants=sorted(rows),
                ledger_decode_tokens=sum(r["decode_tokens"] for r in rows.values()),
                ledger_prefill_tokens=sum(r["prefill_tokens"] for r in rows.values()),
                ledger_by_tenant={t: {k: r[k] for k in ("prefill_tokens", "decode_tokens",
                                                         "page_seconds", "device_seconds")}
                                  for t, r in rows.items()},
                prompt_tokens=sum(len(p) for p in prompts),
                healthz_sanitizer=health.get("sanitizer"), engine_cv=lockwatched,
                slo_engines=sorted(engines),
                slo_objectives=[o["name"] for e in engines.values() for o in e["objectives"]],
                slo_evaluated=[e["unix"] is not None for e in engines.values()])


def hf_telemetry_phase(seed: int) -> dict:
    """HuggingFace GPT-2 and the training telemetry at GPT-2-small widths:

    (a) ``gpt2_state_to_staged`` (the route ``gpt2_to_staged`` takes after
    checking its ``GPT2LMHeadModel``) converts ``gpt2_state`` into a
    ``PretrainedStagedLM`` of ``HF_STAGES`` stages; its logits on
    ``HF_FORWARD_ROWS`` rows of 1024 tokens through ``TrainedModel`` on the
    card against the same model on the CPU within ``PREDICT_ATOL`` (B1 once
    a block);
    (b) the train phase's one-rank ``DOWNPOUR`` over it (batch 4, window 2,
    Adam, ``HF_EPOCHS`` epoch of 32 rows), twice: telemetry and dynamics
    off, then ``DISTKERAS_TELEMETRY`` on, ``DISTKERAS_DYNAMICS`` on with the
    ``warn`` watchdog and ``profile_dir`` set.  Gates: the two histories
    equal bit for bit, and the trained centers too; B1-B3 launched
    ``n_layer x local steps`` times in each run; the dynamics summary
    finite, with no non-finite gradient or parameter and a nonzero center
    update; the dynamics JSONL line written; on the card the profiler's
    Chrome trace names the three kernels, whose share of the profiled
    epoch's device time is printed;
    (c) the fine-tuned model served through a ``ServingEngine`` behind
    ``install_http_endpoint`` on the flight deck's exporter at 127.0.0.1:
    ``HF_SERVE``'s greedy requests over HTTP, each held to
    ``greedy_generate`` (a departure only where the reference's top-two gap
    is below ``GREEDY_GAP``), and a ``/metrics`` scrape carrying the serving
    counters under the run's ``run_id`` label;
    (d) the runtime sanitizer and the per-tenant ledger: the training with
    telemetry on, strict (``_hf_sanitized``; its tokens/s against the same
    training's unsanitized just before and after), with no violation, bit
    for bit the plain
    run, B1-B3 launched as often, one donation boundary an epoch and a read
    of the consumed input state raising; a sync planted inside a strict
    ``transfer.guard`` on the card (``torch.nonzero``) caught, naming the
    guard, and the same call passing outside it; the HTTP requests of (c)
    served strict, for ``HF_TENANTS``: the tenant-summed decode tokens equal
    the scrape's ``serving_tokens_total`` exactly, the prefill tokens the
    prompts' total, ``/ledger`` lists both tenants, ``/healthz`` reports
    strict with no violation, and ``/slo`` serves one engine of the default
    serving objectives, evaluated once."""
    import os
    import tempfile

    from distkeras_tpu_torch import telemetry
    from distkeras_tpu_torch.models import TrainedModel, gpt2_state_to_staged
    from distkeras_tpu_torch.ops import flash_attention
    from distkeras_tpu_torch.telemetry.profiler import kernel_times

    cuda = ZOO_DEVICE == "cuda"
    staged = gpt2_state_to_staged(HF_CONFIG, gpt2_state(HF_CONFIG, seed), HF_STAGES)
    params, _ = staged.init(None, None)
    tokens = np.random.default_rng(seed + 28).integers(
        0, HF_CONFIG["vocab_size"], (HF_FORWARD_ROWS, HF_CONFIG["n_positions"]))
    flash_attention.launches = 0
    got = TrainedModel(staged, params, device=ZOO_DEVICE)(tokens).float().cpu()
    forward_launches = flash_attention.launches
    want = TrainedModel(staged, params, device="cpu")(tokens)
    forward_err = float((got - want).abs().max())
    del got, want
    failures = []
    if not forward_err <= PREDICT_ATOL:
        failures.append(f"the converted forward is off the CPU's by {forward_err}")
    if forward_launches != (HF_CONFIG["n_layer"] if cuda else 0):
        failures.append(f"the converted forward launched B1 {forward_launches} times")

    steps = HF_EPOCHS * TRAIN_ROWS // TRAIN_BATCH
    expected = [HF_CONFIG["n_layer"] * steps if cuda else 0] * 3
    _, plain = _hf_train(staged, seed)
    with tempfile.TemporaryDirectory() as workdir:
        telemetry_dir = os.path.join(workdir, "telemetry")
        os.environ["DISTKERAS_TELEMETRY_DIR"] = telemetry_dir
        telemetry.configure(True)
        telemetry.dynamics.configure(enabled=True, watchdog="warn")
        try:
            _, observed = _hf_train(staged, seed, profile_dir=os.path.join(workdir, "profile"))
            summary = (telemetry.dynamics.last_summary() or {}).get("summary", {})
            jsonl = [os.path.join(telemetry_dir, f) for f in os.listdir(telemetry_dir)
                     if f.startswith("metrics_")]
            series = [json.loads(line) for path in jsonl for line in open(path)
                      if '"type": "dynamics"' in line]
            traces = [os.path.join(workdir, "profile", f)
                      for f in os.listdir(os.path.join(workdir, "profile"))]
            times = kernel_times(traces[0]) if traces else {}
            sanitized = _hf_sanitized(staged, seed)
            planted = _planted_sync()
            http = _hf_http(observed["model"], seed)
        finally:
            telemetry.dynamics.configure()
            telemetry.configure(None)
            telemetry.trace.reset()
            telemetry.metrics.reset()
            os.environ.pop("DISTKERAS_TELEMETRY_DIR", None)
    flash = {k: sum(us for name, us in times.items() if k in name) for k in HF_FLASH}
    device_us = sum(times.values())
    row = dict(model="PretrainedStagedLM", config=HF_CONFIG, num_stages=HF_STAGES,
               forward_rows=HF_FORWARD_ROWS, forward_max_abs_err=forward_err,
               forward_atol=PREDICT_ATOL, forward_launches_b1=forward_launches,
               batch_size=TRAIN_BATCH, window=TRAIN_WINDOW, epochs=HF_EPOCHS, rows=TRAIN_ROWS,
               local_steps=steps, loss=plain["loss"],
               histories_bitwise=observed["history"] == plain["history"],
               vs_plain=_versus(observed, plain),
               launches_b1_b2_b3_plain=plain["launches"],
               launches_b1_b2_b3_observed=observed["launches"],
               launches_b1_b2_b3_expected=expected,
               tokens_per_s_plain=plain["tokens_per_s"],
               tokens_per_s_observed=observed["tokens_per_s"],
               tokens_per_s_sanitized=sanitized.get("tokens_per_s"),
               tokens_per_s_unsanitized_before_after=sanitized["tokens_per_s_unsanitized"],
               sanitized_error=sanitized["error"],
               sanitized_bitwise=("loss" in sanitized
                                  and sanitized["history"] == plain["history"]
                                  and _versus(sanitized, plain)["bitwise"]),
               launches_b1_b2_b3_sanitized=sanitized.get("launches"),
               sanitizer_violations=sanitized["violations"],
               sanitizer_donation=sanitized["donation"],
               sanitizer_declared=sanitized["declared"],
               sanitizer_stale_read=sanitized["stale_read"], planted_sync=planted,
               dynamics_summary=summary,
               dynamics_lines=len(series), profile_traces=len(traces),
               profile_kernel_us=flash, profile_device_us=device_us,
               profile_flash_share=(sum(flash.values()) / device_us) if device_us else None,
               http=http, card=CARD)
    if not row["histories_bitwise"] or not row["vs_plain"]["bitwise"]:
        failures.append(f"the telemetry moved the trajectory: {row['vs_plain']}")
    for name, got_launches in (("plain", plain["launches"]), ("observed", observed["launches"])):
        if got_launches != expected:
            failures.append(f"the {name} run launched B1-B3 {got_launches} times, "
                            f"expected {expected}")
    if not summary or not all(isinstance(v, float) and np.isfinite(v) for v in summary.values()):
        failures.append(f"the dynamics summary is not finite: {summary}")
    elif (summary.get("nonfinite_grads_max") != 0.0 or summary.get("nonfinite_params_max") != 0.0
          or not summary.get("update_norm", 0.0) > 0.0):
        failures.append(f"the dynamics summary is unhealthy: {summary}")
    if len(series) != HF_EPOCHS:
        failures.append(f"{len(series)} dynamics JSONL lines for {HF_EPOCHS} epochs")
    if len(traces) != 1 or (cuda and not all(flash.values())):
        failures.append(f"profiler traces {traces}, flash kernels' device us {flash}")
    if not (http["scrape_has_ttft"] and http["scrape_tokens_line"]
            and float(http["scrape_tokens_line"].split()[-1]) >= HF_SERVE[0] * HF_SERVE[2]):
        failures.append(f"the /metrics scrape lacks the serving counters: "
                        f"{http['scrape_tokens_line']}")
    # (d) the sanitizer and the ledger
    if sanitized["error"] or sanitized["violations"]:
        failures.append(f"the strict run: {sanitized['error']} {sanitized['violations']}")
    elif not row["sanitized_bitwise"]:
        failures.append(f"the sanitizer moved the trajectory: {_versus(sanitized, plain)}")
    if sanitized.get("launches") != expected:
        failures.append(f"the strict run launched B1-B3 {sanitized.get('launches')} times, "
                        f"expected {expected}")
    if sanitized["donation"]["boundaries"] != HF_EPOCHS:
        failures.append(f"{sanitized['donation']} donation boundaries for {HF_EPOCHS} epochs")
    if not (sanitized["stale_read"] or "").startswith("read of 'center_params' on a consumed"):
        failures.append(f"a read of the consumed state did not raise: {sanitized['stale_read']}")
    if cuda and "guard 'planted'" not in (planted["caught"] or ""):
        failures.append(f"the planted card sync was not caught: {planted}")
    if (not cuda and planted["caught"] is not None) or planted["outside_rows"] != 7:
        failures.append(f"the planted sync: {planted}")
    if http["ledger_decode_tokens"] != float(http["scrape_tokens_line"].split()[-1]):
        failures.append(f"the ledger billed {http['ledger_decode_tokens']} decode tokens, the "
                        f"scrape counts {http['scrape_tokens_line']}")
    if http["ledger_prefill_tokens"] != http["prompt_tokens"]:
        failures.append(f"the ledger billed {http['ledger_prefill_tokens']} prefill tokens for "
                        f"{http['prompt_tokens']} prompt tokens")
    if http["ledger_tenants"] != sorted(set(http["tenants"])) or not http["ledger_enabled"]:
        failures.append(f"/ledger lists {http['ledger_tenants']}, sent {http['tenants']}")
    if http["healthz_sanitizer"] != {"mode": "strict", "violations": {}}:
        failures.append(f"/healthz reports the sanitizer as {http['healthz_sanitizer']}")
    if http["engine_cv"] != "GuardedLock":
        failures.append(f"the engine's condition variable is a {http['engine_cv']}")
    if (http["slo_engines"] != ["serving"] or http["slo_evaluated"] != [True]
            or http["slo_objectives"] != [o.name for o in _default_serving_objectives()]):
        failures.append(f"/slo serves {http['slo_engines']} {http['slo_objectives']} "
                        f"evaluated {http['slo_evaluated']}")
    row["failures"] = failures
    emit(phase="hf_telemetry", **row)
    if failures:
        raise AssertionError(f"hf_telemetry: {failures}")
    return row



# Phase 26: chaos, fleet membership with the live elastic resize, and the
# Punchcard control plane, on GPT-2 small's widths cut to 2 blocks: each
# boundary save holds the center and both workers' parameters (about 54 M
# parameters a copy at 2 blocks, most of them the embeddings).
FLEET_MODEL = dict(GPT2_SMALL, num_layers=2)
FLEET_ROWS, FLEET_EPOCHS, FLEET_WORKERS, FLEET_GROW = 16, 3, 2, 4
FLEET_SGD = ("sgd", {"learning_rate": 0.01})
FLEET_JOB = (4, 2)  # the job's ModelPredictor: rows of max_len tokens, batch size
FLEET_JOB_TIMEOUT_S = 600
#: the Punchcard job: the same model built on the card in a process of its
#: own, started by the daemon with cwd = its workdir, so it puts the
#: checkout on its path itself
FLEET_JOB_SCRIPT = """import json, sys
sys.path.insert(0, {root!r})
import chip_smoke
seed, device, cfg, rows, batch = sys.argv[1:6]
print(json.dumps(chip_smoke.fleet_predict(int(seed), device, json.loads(cfg), int(rows),
                                          int(batch))))
"""


def _flash_counters():
    from distkeras_tpu_torch.ops import flash_attention, flash_attention_bwd_dkv, \
        flash_attention_bwd_dq

    return flash_attention, flash_attention_bwd_dq, flash_attention_bwd_dkv


def fleet_predict(seed: int, device: str, cfg: dict, rows: int, batch: int) -> dict:
    """``ModelPredictor`` over a ``TransformerLM(**cfg)`` drawn from ``seed``
    on ``rows`` rows of ``max_len`` tokens in batches of ``batch``, on
    ``device``: the device's name, B1's launches and the predictions'
    sha256.  The job's script calls it on the card in its own process."""
    import hashlib

    from distkeras_tpu_torch import ModelPredictor, from_numpy
    from distkeras_tpu_torch.models import TorchModel, TrainedModel, TransformerLM

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = TransformerLM(**cfg, generator=torch.Generator().manual_seed(seed + 29))
    params = {name: p.detach() for name, p in model.named_parameters()}
    tokens = np.random.default_rng(seed + 29).integers(0, cfg["vocab_size"],
                                                       (rows, cfg["max_len"]), dtype=np.int32)
    predictor = ModelPredictor(TrainedModel(TorchModel(model), params, device=device),
                               batch_size=batch, device=device)
    b1 = _flash_counters()[0]
    b1.launches = 0
    probs = np.ascontiguousarray(predictor.predict(from_numpy(tokens))["prediction"])
    launches = b1.launches
    return dict(kind=torch.cuda.get_device_name(0) if device == "cuda" else device,
                launches_b1=launches, shape=list(probs.shape), finite=bool(np.isfinite(probs).all()),
                sha256=hashlib.sha256(probs.tobytes()).hexdigest())


def _fleet_trainer(seed: int, num_workers: int = FLEET_WORKERS, num_epoch: int = FLEET_EPOCHS,
                   **kwargs):
    import distkeras_tpu_torch as tdk
    from distkeras_tpu_torch.models import TransformerLM

    model = TransformerLM(**FLEET_MODEL, generator=torch.Generator().manual_seed(seed + 27))
    return _keeping_fit(tdk.DOWNPOUR)(model, loss="token_crossentropy", metrics=("token_accuracy",),
                        worker_optimizer=FLEET_SGD, num_workers=num_workers,
                        batch_size=TRAIN_BATCH, communication_window=TRAIN_WINDOW,
                        num_epoch=num_epoch, seed=seed, device=ZOO_DEVICE, **kwargs)


def _fleet_run(trainer, frame, recover: bool = False) -> dict:
    """``trainer.train(frame)`` (``train_with_recovery`` when ``recover``)
    with B1-B3's launches counted around it: the history, the center, the
    launches and the wall seconds."""
    counters = _flash_counters()
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    model = trainer.train_with_recovery(frame, backoff_base=0) if recover \
        else trainer.train(frame)
    if ZOO_DEVICE == "cuda":
        torch.cuda.synchronize()
    return dict(loss=trainer.get_history()["loss"], seconds=time.perf_counter() - t0,
                launches=[c.launches for c in counters],
                params={k: v.detach().cpu().clone() for k, v in model.params.items()})


def _fleet_steps(workers: int) -> int:
    """Local steps of one epoch over every worker at ``workers`` workers
    (the window grid ``plan_epoch`` lays out, wrap-padded)."""
    from distkeras_tpu_torch.data import plan_epoch

    n_windows, _ = plan_epoch(FLEET_ROWS, workers, TRAIN_BATCH, TRAIN_WINDOW)
    return workers * n_windows * TRAIN_WINDOW


def _same(run: dict, ref: dict) -> bool:
    """``run``'s history and center bit for bit ``ref``'s (``run``'s
    history may hold only its last epochs, after a resume)."""
    return (len(run["loss"]) > 0 and run["loss"] == ref["loss"][-len(run["loss"]):]
            and all(torch.equal(run["params"][k], v) for k, v in ref["params"].items()))


def _dir_bytes(path: str) -> int:
    import os

    return sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(path) for f in files)


def fleet_phase(seed: int) -> dict:
    """Chaos, fleet membership and the Punchcard control plane, over
    ``DOWNPOUR`` on a ``TransformerLM`` at GPT-2 small's widths cut to 2
    blocks (``FLEET_MODEL``; 2 workers, batch 4, window 2, SGD, dropout 0,
    ``FLEET_EPOCHS`` epochs of ``FLEET_ROWS`` rows):

    (a) seeded kill, recovered: the uninterrupted run; then
    ``train_with_recovery`` with ``DISTKERAS_CHAOS``'s ``kill_epoch=1`` and a
    checkpoint a boundary; then ``kill_epoch=2,torn_ckpt=1``, which tears
    the epoch-1 boundary's step (``step_2``) after its manifest landed, so
    the resume quarantines it (``step_2.corrupt``) and falls back to the
    epoch-0 boundary's (``step_1``).  Gates: both recovered histories and
    centers bit for bit the uninterrupted run's; the kill run launches
    B1-B3 exactly as often (the kill fires entering the epoch, before any
    device work), the torn run one replayed epoch's launches more; the
    ``epoch`` sites counted; one ``step_2.corrupt`` left;
    (b) live elastic grow 2 -> 4 over a ``PunchcardServer`` on 127.0.0.1:
    one ``FleetWorker(workers=2)`` registered, the training polls an
    ``ElasticMembership(min_workers=2, max_workers=4)`` whose second poll
    first registers a second ``FleetWorker(workers=2)``, so the fleet grows
    between the epoch-0 and epoch-1 boundaries.  Gates: one resize, to 4
    workers (telemetry's ``elastic_resizes_total`` and ``elastic_workers``);
    the center bit for bit the elastic-resume path's (a trainer at 4
    workers resuming from (a)'s killed run's epoch-1 boundary step, 2
    epochs at 2 workers); B1-B3
    launched ``blocks x`` the local steps ``plan_epoch`` lays out; tokens/s
    of the epochs before and after the resize (their ``epoch`` spans);
    (c) a job through that daemon's control plane, submitted with the
    client's ``refuse_connect=1,drop_reply=1,tear_send=1`` armed: its
    script builds the same 2-block LM on the card in a process of its own
    and runs ``ModelPredictor`` over ``FLEET_JOB`` rows.  Gates: the
    daemon's table holds one job, finished with rc 0, on the parent's
    device, B1 launched ``blocks x batches`` times, its predictions' sha256
    the parent's in-process prediction's."""
    import os
    import shutil
    import tempfile
    from pathlib import Path

    import distkeras_tpu_torch as tdk
    from distkeras_tpu_torch import chaos, telemetry
    from distkeras_tpu_torch.fleet import ElasticMembership, FleetWorker
    from distkeras_tpu_torch.job_deployment import Job, PunchcardServer

    cuda = ZOO_DEVICE == "cuda"
    blocks = FLEET_MODEL["num_layers"]
    x, y = lm_task(FLEET_ROWS, FLEET_MODEL["max_len"], FLEET_MODEL["vocab_size"], seed + 27)
    frame = tdk.from_numpy(x, y)
    per_epoch = _fleet_steps(FLEET_WORKERS)
    expect = lambda steps: [blocks * steps if cuda else 0] * 3
    row = dict(model="TransformerLM", **FLEET_MODEL, rows=FLEET_ROWS, epochs=FLEET_EPOCHS,
               workers=FLEET_WORKERS, batch_size=TRAIN_BATCH, window=TRAIN_WINDOW,
               local_steps_per_epoch=per_epoch, card=CARD)
    failures = []

    # (a) seeded kill and torn checkpoint, recovered
    trainer = _fleet_trainer(seed)
    base = _fleet_run(trainer, frame)
    _, state, _ = trainer.fit_result
    # what a save writes: every TrainState field but the generators and the
    # epoch (the center, and each worker's parameters and rule state)
    reckoned = sum(_state_bytes(getattr(state, f)) for f in (
        "center_params", "center_rule", "local_params", "opt_state", "model_state",
        "rule_local"))
    del trainer, state
    runs = {}
    workdir = tempfile.TemporaryDirectory()
    for name, spec in (("killed", "kill_epoch=1"), ("torn", "kill_epoch=2,torn_ckpt=1")):
        ckpt = os.path.join(workdir.name, name)
        chaos.configure(f"{seed}:{spec}")
        try:
            run = _fleet_run(_fleet_trainer(seed, checkpoint_dir=ckpt), frame, recover=True)
            run["epoch_sites"] = chaos.counts().get("epoch", 0)
        finally:
            chaos.configure("")
        run["corrupt"] = sorted(f for f in os.listdir(ckpt) if f.endswith(".corrupt"))
        run["save_bytes"] = _dir_bytes(os.path.join(ckpt, f"step_{FLEET_EPOCHS}"))
        runs[name] = run
    shutil.rmtree(os.path.join(workdir.name, "torn"))
    params = sum(v.numel() for v in base["params"].values())
    row.update(params=params, save_bytes_on_disk=runs["killed"]["save_bytes"],
               save_bytes_reckoned=reckoned,
               launches_b1_b2_b3_uninterrupted=base["launches"],
               launches_b1_b2_b3_killed=runs["killed"]["launches"],
               launches_b1_b2_b3_torn=runs["torn"]["launches"],
               killed_bitwise=_same(runs["killed"], base), torn_bitwise=_same(runs["torn"], base),
               killed_epochs_after_resume=len(runs["killed"]["loss"]),
               torn_epochs_after_resume=len(runs["torn"]["loss"]),
               epoch_sites=[runs["killed"]["epoch_sites"], runs["torn"]["epoch_sites"]],
               torn_quarantined=runs["torn"]["corrupt"],
               seconds_uninterrupted_killed_torn=[base["seconds"], runs["killed"]["seconds"],
                                                  runs["torn"]["seconds"]])
    if base["launches"] != expect(FLEET_EPOCHS * per_epoch):
        failures.append(f"the uninterrupted run launched B1-B3 {base['launches']} times")
    if runs["killed"]["launches"] != base["launches"]:
        failures.append(f"the killed run launched B1-B3 {runs['killed']['launches']} times, "
                        f"the uninterrupted one {base['launches']}")
    if runs["torn"]["launches"] != expect((FLEET_EPOCHS + 1) * per_epoch):
        failures.append(f"the torn run launched B1-B3 {runs['torn']['launches']} times, not one "
                        "replayed epoch more than the uninterrupted run")
    if not (row["killed_bitwise"] and row["torn_bitwise"]):
        failures.append("a recovered run is not the uninterrupted run bit for bit")
    if row["epoch_sites"] != [4, 5]:
        failures.append(f"the epoch sites fired {row['epoch_sites']} times, expected [4, 5]")
    if row["torn_quarantined"] != ["step_2.corrupt"]:
        failures.append(f"the torn run quarantined {row['torn_quarantined']}")
    if row["killed_epochs_after_resume"] != FLEET_EPOCHS - 1 \
            or row["torn_epochs_after_resume"] != FLEET_EPOCHS - 1:
        failures.append("a recovery did not resume from the step it should have")

    with workdir:
        workdir = workdir.name
        saved_dir = os.environ.get("DISTKERAS_TELEMETRY_DIR")
        os.environ["DISTKERAS_TELEMETRY_DIR"] = os.path.join(workdir, "telemetry")
        telemetry.configure(True)
        os.makedirs(os.path.join(workdir, "punchcard"))
        server = PunchcardServer(port=0, workdir=os.path.join(workdir, "punchcard"))
        server.start()
        first = FleetWorker("127.0.0.1", server.port, workers=FLEET_WORKERS)
        second = FleetWorker("127.0.0.1", server.port, workers=FLEET_GROW - FLEET_WORKERS)
        try:
            # (b) the live grow over the daemon
            first.start()

            class Growing(ElasticMembership):
                """Registers the second member just before its second poll."""
                polls = 0

                def poll(self):
                    self.polls += 1
                    if self.polls == 2:
                        second.start()
                    return super().poll()

            ctl = Growing("127.0.0.1", server.port, min_workers=FLEET_WORKERS,
                          max_workers=FLEET_GROW)
            telemetry.metrics.reset()
            telemetry.trace.reset()
            live = _fleet_run(_fleet_trainer(seed, elastic=ctl), frame)
            spans = sorted((e["args"]["epoch"], e["dur"] / 1e6) for e in telemetry.trace.events()
                           if e["name"] == "epoch")
            resizes = telemetry.metrics.counter("elastic_resizes_total").value
            grown = telemetry.metrics.gauge("elastic_workers").value
            # the elastic-resume path: the killed run's epoch-1 boundary step
            # (2 epochs at 2 workers, bitwise the uninterrupted run, (a)) made
            # its newest, resumed at 4 workers, saving nothing more
            # (checkpoint_every changes which boundaries save, not the run)
            ckpt = os.path.join(workdir, "killed")
            for f in os.listdir(ckpt):
                if f.startswith(f"step_{FLEET_EPOCHS}"):
                    path = os.path.join(ckpt, f)
                    shutil.rmtree(path) if os.path.isdir(path) else os.remove(path)
            resumed = _fleet_run(_fleet_trainer(seed, num_workers=FLEET_GROW,
                                                checkpoint_dir=ckpt, resume=True,
                                                checkpoint_every=FLEET_EPOCHS + 1), frame)
            workers = [FLEET_WORKERS, FLEET_WORKERS, FLEET_GROW]
            tokens = [_fleet_steps(w) * TRAIN_BATCH * FLEET_MODEL["max_len"] for w in workers]
            row["elastic"] = dict(
                polls=ctl.polls, resizes=resizes, workers_after=grown,
                workers_per_epoch=workers, launches_b1_b2_b3=live["launches"],
                expected_launches=expect(sum(_fleet_steps(w) for w in workers))[0],
                bitwise_resume_path=_same(resumed, live),
                resume_path_loss=resumed["loss"], loss=live["loss"],
                epoch_seconds=[d for _, d in spans],
                tokens_per_s_per_epoch=[t / d for t, (_, d) in zip(tokens, spans)])
            if (resizes, grown, ctl.polls) != (1, FLEET_GROW, FLEET_EPOCHS - 1):
                failures.append(f"elastic: {resizes} resizes to {grown} workers in {ctl.polls} "
                                "polls")
            if live["launches"] != expect(sum(_fleet_steps(w) for w in workers)):
                failures.append(f"the live resize launched B1-B3 {live['launches']} times")
            if not row["elastic"]["bitwise_resume_path"]:
                failures.append("the live resize is not the elastic-resume path bit for bit")
            if len(spans) != FLEET_EPOCHS:
                failures.append(f"{len(spans)} epoch spans for {FLEET_EPOCHS} epochs")

            # (c) a job on the card through the daemon, under client-side faults
            rows_, batch = FLEET_JOB
            script = FLEET_JOB_SCRIPT.format(root=str(Path(__file__).resolve().parent))
            job = Job("127.0.0.1", server.port, script=script, rpc_backoff=0.01,
                      args=[seed, ZOO_DEVICE, json.dumps(FLEET_MODEL), rows_, batch])
            chaos.configure(f"{seed}:refuse_connect=1,drop_reply=1,tear_send=1")
            try:
                job.submit()
                fired = chaos.counts()
            finally:
                chaos.configure("")
            t0 = time.perf_counter()
            status = job.wait(timeout=FLEET_JOB_TIMEOUT_S)
            job_seconds = time.perf_counter() - t0
            with server._cv:
                n_jobs = len(server.jobs)
            lines = [line for line in status["output"].splitlines() if line.startswith("{")]
            got = json.loads(lines[-1]) if lines else {}
            want = fleet_predict(seed, ZOO_DEVICE, FLEET_MODEL, rows_, batch)
            row["job"] = dict(jobs=n_jobs, status=status["status"],
                              returncode=status["returncode"], seconds=job_seconds,
                              chaos_sites={k: fired.get(k, 0) for k in
                                           ("connect", "send", "rpc_reply")},
                              child=got, parent=want,
                              expected_launches_b1=blocks * -(-rows_ // batch) if cuda else 0)
            if (n_jobs, status["status"], status["returncode"]) != (1, "finished", 0):
                failures.append(f"the daemon holds {n_jobs} jobs, the job {status['status']} "
                                f"rc {status['returncode']}: {status['output'][-2000:]}")
            elif got.get("kind") != want["kind"] or got.get("sha256") != want["sha256"] \
                    or not got.get("finite"):
                failures.append(f"the job's predictions ({got}) are not the parent's ({want})")
            for who in (got, want):
                if who.get("launches_b1") != row["job"]["expected_launches_b1"]:
                    failures.append(f"B1 launched {who.get('launches_b1')} times in a job "
                                    "prediction")
        finally:
            for w in (first, second):
                w.stop()
            server.stop()
            telemetry.metrics.reset()
            telemetry.trace.reset()
            telemetry.configure(None)
            if saved_dir is None:
                os.environ.pop("DISTKERAS_TELEMETRY_DIR", None)
            else:
                os.environ["DISTKERAS_TELEMETRY_DIR"] = saved_dir
    row["failures"] = failures
    emit(phase="fleet", **row)
    if failures:
        raise AssertionError(f"fleet: {failures}")
    return row


def fleet_launches(row: dict, kernel: int) -> dict:
    """Phase 26's launches of B1, B2 or B3 (``kernel`` 0, 1, 2) for the
    kernels line."""
    return {"launches_fleet_uninterrupted_killed_torn": [
                row[f"launches_b1_b2_b3_{run}"][kernel]
                for run in ("uninterrupted", "killed", "torn")],
            "launches_fleet_elastic": row["elastic"]["launches_b1_b2_b3"][kernel]}


# Phase 27: the serving tier and the online serve-to-train loop, at GPT-2
# small's widths and depth (12 blocks, f32, random from --seed): two
# ServingEngine replicas behind a ServingTier of LocalReplicas, greedy and
# seeded-sampled requests for tenants a and b.  (a) failover under a seeded
# kill_replica; (b) the loop closed on the card: served traffic captured by a
# TrafficLog, each window retrained by DOWNPOUR (B1-B3), published as a
# verified step and rolled into the replicas while they serve.
ONLINE_MODEL = GPT2_SMALL
ONLINE_SLOTS, ONLINE_PAGE = 8, 16
ONLINE_REQUESTS, ONLINE_CLIENTS = 16, 4
ONLINE_PROMPT_LEN = (16, 64)  # drawn from --seed, inclusive
ONLINE_NEW_TOKENS = 16
ONLINE_KILL = 3  # kill_replica: the busy engine iteration the seeded kill lands on
ONLINE_WINDOW, ONLINE_ROW = 8, 128  # the TrafficLog's window_samples and max_len
ONLINE_SGD = ("sgd", {"learning_rate": 0.01})
#: requests put in flight just before the roll starts (fewer than a window,
#: so they publish none), and their new tokens
ONLINE_ROLL_REQUESTS, ONLINE_ROLL_NEW_TOKENS = 4, 32
ONLINE_PROBES = 4  # greedy prompts held to a fresh engine on the step after the roll
ONLINE_REJECT_S, ONLINE_ROLL_S = 30.0, 60.0  # bounds on the watcher's verdicts


def _online_requests(seed: int, n: int, new_tokens: int = None) -> list:
    """``n`` requests of ``ONLINE_PROMPT_LEN`` prompts from ``seed``, for
    tenants ``a`` and ``b`` in turn; every second one sampled with its own
    seed (``SERVE_SAMPLING``)."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(ONLINE_PROMPT_LEN[0], ONLINE_PROMPT_LEN[1] + 1, n)
    out = []
    for i, length in enumerate(lengths):
        req = dict(prompt=rng.integers(0, ONLINE_MODEL["vocab_size"], int(length)).tolist(),
                   max_new_tokens=new_tokens or ONLINE_NEW_TOKENS, tenant="ab"[i % 2])
        if i % 2:
            req.update(seed=seed * 1000 + i, **SERVE_SAMPLING)
        out.append(req)
    return out


def _online_engines(trained, n: int) -> list:
    from distkeras_tpu_torch.serving import ServingEngine
    from distkeras_tpu_torch.telemetry.metrics import Registry

    return [ServingEngine(trained, num_slots=ONLINE_SLOTS, page_size=ONLINE_PAGE,
                          registry=Registry(), device=ZOO_DEVICE) for _ in range(n)]


def _online_alone(trained, requests) -> list:
    """Each request served alone on a fresh engine: its tokens."""
    engine = _online_engines(trained, 1)[0]
    try:
        return [engine.generate(timeout=600, **r).tokens for r in requests]
    finally:
        engine.stop()


def _online_versus(trained, requests, tokens, alone) -> tuple:
    """Greedy requests held to ``alone`` by the ``GREEDY_GAP`` rule (their
    departures), sampled ones exactly (the indices that differ)."""
    departures, mismatched = {}, []
    for i, (req, got, want) in enumerate(zip(requests, tokens, alone)):
        if "seed" in req:
            if got != want:
                mismatched.append(i)
        else:
            hit = _held_to_greedy(trained, req["prompt"], got, want)
            if hit is not None:
                departures[i] = hit
    return departures, mismatched


def _latency_row(seconds: list, tokens: int, wall: float) -> dict:
    ms = np.sort(np.asarray(seconds)) * 1e3
    return dict(latency_p50_ms=float(np.percentile(ms, 50)),
                latency_p99_ms=float(np.percentile(ms, 99)),
                generated_tokens=tokens, wall_s=wall, tokens_per_s=tokens / wall)


def _online_failover(trained, seed: int) -> dict:
    """(a): ``ONLINE_REQUESTS`` requests through ``tier.generate`` from
    ``ONLINE_CLIENTS`` client threads with ``kill_replica=ONLINE_KILL``
    armed, against each request served alone."""
    import threading

    from distkeras_tpu_torch import chaos
    from distkeras_tpu_torch.serving import LocalReplica, ServingTier
    from distkeras_tpu_torch.telemetry.metrics import Registry

    b1 = _flash_counters()[0]
    requests = _online_requests(seed + 31, ONLINE_REQUESTS)
    registry = Registry()
    engines = _online_engines(trained, 2)
    tier = ServingTier([LocalReplica(e, name=f"replica-{i}") for i, e in enumerate(engines)],
                       probe_interval=0.05, default_deadline_s=600.0, registry=registry)
    results, seconds = [None] * len(requests), [None] * len(requests)
    try:
        for e in engines:  # warm-up, chaos off: cuBLAS handles, the allocator
            e.generate(requests[0]["prompt"], max_new_tokens=2, timeout=600)
        tier.start()

        def client(c):
            for i in range(c, len(requests), ONLINE_CLIENTS):
                t0 = time.perf_counter()
                results[i] = tier.generate(deadline_s=600.0, **requests[i])
                seconds[i] = time.perf_counter() - t0

        b1.launches = 0
        chaos.configure(f"{seed}:kill_replica={ONLINE_KILL}")
        t0 = time.perf_counter()
        try:
            threads = [threading.Thread(target=client, args=(c,)) for c in range(ONLINE_CLIENTS)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=600)
            fired = chaos.counts().get("replica", 0)
        finally:
            chaos.configure("")
        wall = time.perf_counter() - t0
        launches = b1.launches
        states = tier.states()
        snap = registry.snapshot()
        bills = tier._acct.snapshot()["tenants"] if tier._acct is not None else []
    finally:
        tier.stop(close_replicas=True)
    if any(r is None or r.finish_reason == "aborted" for r in results):
        raise AssertionError(f"online: a request did not complete under the kill: {results}")
    tokens = [r.tokens for r in results]
    departures, mismatched = _online_versus(trained, requests, tokens,
                                            _online_alone(trained, requests))
    value = lambda name: (snap.get(name) or {}).get("value", 0)
    return dict(requests=len(requests), clients=ONLINE_CLIENTS,
                sampled=sum("seed" in r for r in requests), kill_replica=ONLINE_KILL,
                replica_sites=fired, states=states,
                dead=list(states.values()).count("dead"),
                failovers=value("serving_tier_failovers_total"),
                routed=value("serving_tier_routed_total"),
                billed_requests=sum(r["requests"] for r in bills),
                billed_failover_attempts=sum(r["failover_attempts"] for r in bills),
                billed_tenants=sorted(r["tenant"] for r in bills),
                greedy_departures=departures, sampled_mismatched=mismatched,
                launches_b1=launches,
                **_latency_row(seconds, sum(len(t) for t in tokens), wall))


def _online_train_fn(model, seed: int, record: dict):
    """The scheduler's retrain: ``DOWNPOUR`` over the served ``model`` on
    the window's rows (2 workers, batch 4, window 2, SGD, one epoch), the
    next-token loss masked past each row's length; returns the fit's
    ``TrainState`` and records its seconds, tokens and center."""
    import distkeras_tpu_torch as tdk

    def train_fn(window, source):
        feats, lengths = source.local_arrays()
        x = np.ascontiguousarray(feats, dtype=np.int32)
        y = np.full_like(x, -1)
        for i, n in enumerate(np.asarray(lengths)):
            y[i, :n - 1] = x[i, 1:n]
        trainer = _keeping_fit(tdk.DOWNPOUR)(
            model, loss="masked_token_crossentropy", metrics=(),
            worker_optimizer=ONLINE_SGD, num_workers=TRAIN_WORKERS, batch_size=TRAIN_BATCH,
            communication_window=TRAIN_WINDOW, num_epoch=1, seed=seed, device=ZOO_DEVICE)
        t0 = time.perf_counter()
        trainer.train(tdk.from_numpy(x, y))
        if ZOO_DEVICE == "cuda":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        state = trainer.fit_result[1]
        record[window] = dict(seconds=seconds, rows=len(x),
                              tokens_per_s=_online_steps() * TRAIN_BATCH * x.shape[1] / seconds,
                              loss=trainer.get_history()["loss"],
                              center={k: v.detach().clone() for k, v in
                                      state.center_params.items()})
        return state

    return train_fn


def _online_steps() -> int:
    """Local steps of one window's epoch over every worker (``plan_epoch``)."""
    from distkeras_tpu_torch.data import plan_epoch

    n_windows, _ = plan_epoch(ONLINE_WINDOW, TRAIN_WORKERS, TRAIN_BATCH, TRAIN_WINDOW)
    return TRAIN_WORKERS * n_windows * TRAIN_WINDOW


def _spec_is(engine, model, params) -> bool:
    """Whether ``engine`` serves exactly ``params``: every tensor its decode
    reads, bit for bit."""
    from distkeras_tpu_torch.serving.engine import _resolve_spec

    want, got = _resolve_spec(model, params, engine.device), engine._spec
    pairs = [(got.tok, want.tok), (got.pos, want.pos)]
    for g, w in zip(got.blocks + [got.final_ln, got.head], want.blocks + [want.final_ln, want.head]):
        pairs += [(g[k], w[k]) for k in w]
    return all(torch.equal(g, w) for g, w in pairs)


def _online_loop(model, trained, seed: int, workdir: str) -> dict:
    """(b): a tier of two fresh replicas behind ``install_tier_endpoint``
    with a ``TrafficLog``, ``watch_checkpoints`` restoring each step's
    center on the card, ``kill_epoch=0,flip_ckpt=0`` armed;
    ``ONLINE_REQUESTS`` requests POSTed give two windows, closed one at a
    time by ``WindowScheduler.step_once``."""
    import os
    import threading
    import urllib.request

    from distkeras_tpu_torch import chaos, telemetry
    from distkeras_tpu_torch import checkpoint as ckpt
    from distkeras_tpu_torch.models import TorchModel, TrainedModel
    from distkeras_tpu_torch.online import TrafficLog, WindowScheduler, load_window_manifest, \
        published_windows
    from distkeras_tpu_torch.serving import LocalReplica, ServingTier, install_tier_endpoint
    from distkeras_tpu_torch.telemetry.flightdeck import server as server_mod
    from distkeras_tpu_torch.telemetry.metrics import Registry

    counters = _flash_counters()
    capture_dir, ckpt_dir = os.path.join(workdir, "capture"), os.path.join(workdir, "ckpt")
    registry = Registry()
    engines = _online_engines(trained, 2)
    tier = ServingTier([LocalReplica(e, name=f"replica-{i}") for i, e in enumerate(engines)],
                       probe_interval=0.05, default_deadline_s=600.0, registry=registry)
    log = TrafficLog(capture_dir, window_samples=ONLINE_WINDOW, max_len=ONLINE_ROW,
                     registry=registry)
    retrains, loaded, verifies, roll = {}, {}, [], {}
    scheduler = WindowScheduler(capture_dir, _online_train_fn(model, seed, retrains), ckpt_dir,
                                registry=registry)
    requests = _online_requests(seed + 32, ONLINE_REQUESTS)
    in_roll = _online_requests(seed + 33, ONLINE_ROLL_REQUESTS, ONLINE_ROLL_NEW_TOKENS)
    roll_results = [None] * len(in_roll)
    server_mod.configure(0)
    address = telemetry.flightdeck.ensure_server()

    def post(req):
        body = json.dumps(req).encode()
        http = urllib.request.Request(f"http://{address}/generate", data=body,
                                      headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(http, timeout=600) as r:
            return r.status, json.loads(r.read())

    def roll_client(i):
        roll_results[i] = post(in_roll[i])

    def loader(step):
        # the step's center restored on the card once, for every replica;
        # then, before the roll starts, requests put in flight across it
        t0 = time.perf_counter()
        center = ckpt.restore_center(ckpt_dir, step)["center_params"]
        center = {k: v.to(ZOO_DEVICE) for k, v in center.items()}
        if ZOO_DEVICE == "cuda":
            torch.cuda.synchronize()
        loaded[step] = dict(seconds=time.perf_counter() - t0, center=center)
        roll["threads"] = [threading.Thread(target=roll_client, args=(i,))
                           for i in range(len(in_roll))]
        for th in roll["threads"]:
            th.start()
        deadline = time.monotonic() + 60
        while (sum(r["inflight"] for r in tier.snapshot()["replicas"]) < len(in_roll)
               and time.monotonic() < deadline):
            time.sleep(0.002)
        roll["started"] = time.perf_counter()
        return model, center

    def timed_verify(directory, step, mode="fast"):
        t0 = time.perf_counter()
        verdict = plain_verify(directory, step, mode)
        if mode == "full":
            verifies.append(dict(step=step, seconds=time.perf_counter() - t0,
                                 ok=verdict is None,
                                 bytes=_dir_bytes(os.path.join(directory, f"step_{step}"))))
        return verdict

    def wait(pred, bound):
        deadline = time.monotonic() + bound
        while not pred() and time.monotonic() < deadline:
            time.sleep(0.01)
        return pred()

    live = lambda name: (registry.snapshot().get(name) or {}).get("value", 0)
    plain_verify = ckpt.verify_failure
    # the watcher polls only between publications, so that a step's damage
    # after its manifest (flip_ckpt, on the writer thread) lands before the
    # watcher first sees the step, however the threads are scheduled
    publishing, plain_poll = threading.Lock(), ckpt.CheckpointWatcher.poll

    def gated_poll(watcher):
        with publishing:
            return plain_poll(watcher)

    ckpt.CheckpointWatcher.poll = gated_poll
    steps_info = {}
    try:
        for e in engines:
            e.generate(requests[0]["prompt"], max_new_tokens=2, timeout=600)
        install_tier_endpoint(tier, traffic_log=log)
        tier.start()
        ckpt.verify_failure = timed_verify  # bound by watch_checkpoints at the call
        try:
            tier.watch_checkpoints(ckpt_dir, loader, poll_interval=0.05)
        finally:
            ckpt.verify_failure = plain_verify
        chaos.configure(f"{seed}:kill_epoch=0,flip_ckpt=0")
        t0 = time.perf_counter()
        replies = [None] * len(requests)

        def client(c):
            for i in range(c, len(requests), ONLINE_CLIENTS):
                replies[i] = post(requests[i])

        threads = [threading.Thread(target=client, args=(c,)) for c in range(ONLINE_CLIENTS)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        serve_wall = time.perf_counter() - t0
        for c in counters:
            c.launches = 0
        for window in (0, 1):
            t0 = time.perf_counter()
            with publishing:
                closed = scheduler.step_once()
            published = time.perf_counter()
            step = closed + scheduler.step_offset
            steps_info[window] = dict(
                window=closed, step=step, step_once_s=published - t0,
                save_s=published - t0 - retrains[window]["seconds"],
                save_bytes=_dir_bytes(os.path.join(ckpt_dir, f"step_{step}")),
                published_at=published)
            if window == 0:
                rejected = wait(lambda: live("serving_checkpoint_rejected_total") >= 1,
                                ONLINE_REJECT_S)
                steps_info[0]["rejected_after_s"] = time.perf_counter() - published
                steps_info[0]["rejected"] = rejected
        launches = [c.launches for c in counters]
        rolled = wait(lambda: live("serving_tier_hot_swaps_total") >= 2, ONLINE_ROLL_S)
        rolled_at = time.perf_counter()
        chaos.configure("")
        for th in roll.get("threads", []):
            th.join(timeout=600)
        # before the probes, which the router captures too
        windows_published = published_windows(capture_dir)
        step = steps_info[1]["step"]
        center = retrains[1]["center"]
        swapped = [_spec_is(e, model, center) for e in engines]
        data_state = ckpt.restore_data_state(ckpt_dir, step)
        manifest = load_window_manifest(capture_dir, 1)
        probes = _online_requests(seed + 34, 2 * ONLINE_PROBES)[::2]  # the greedy ones
        probe_tokens = [tier.generate(deadline_s=600.0, **r).tokens for r in probes]
        fresh = TrainedModel(TorchModel(model), center, device=ZOO_DEVICE)
        probe_alone = _online_alone(fresh, probes)
        probe_departures, _ = _online_versus(fresh, probes, probe_tokens, probe_alone)
        snap = registry.snapshot()
        capture_errors = (telemetry.metrics.snapshot().get("online_capture_errors_total")
                          or {}).get("value", 0)
    finally:
        chaos.configure("")
        tier.stop(close_replicas=True)
        ckpt.CheckpointWatcher.poll = plain_poll
        log.close()
        server_mod.stop()
        server_mod.configure(None)
    value = lambda name: (snap.get(name) or {}).get("value", 0)
    statuses = [r[0] if r else None for r in replies]
    return dict(
        requests=len(requests), http_statuses=sorted(set(statuses)), serve_wall_s=serve_wall,
        windows_published=windows_published,
        windows_trained=value("online_windows_trained_total"),
        retrain_failures=value("online_retrain_failures_total"),
        ckpt_rejected=value("serving_checkpoint_rejected_total"),
        hot_swaps=value("serving_tier_hot_swaps_total"),
        roll_failures=value("serving_tier_roll_failures_total"),
        capture_errors=capture_errors, rolled=rolled,
        window0_rejected=steps_info[0]["rejected"],
        window0_rejected_after_s=steps_info[0]["rejected_after_s"],
        loaded_steps=sorted(loaded), replicas_bitwise_the_step=swapped,
        roll_requests=len(in_roll),
        roll_finish_reasons=[r[1].get("finish_reason") if r else None for r in roll_results],
        roll_statuses=[r[0] if r else None for r in roll_results],
        data_state=dict(epoch=data_state.epoch, block_cursor=data_state.block_cursor),
        window1_last_seq=int(manifest["last_seq"]),
        probe_departures=probe_departures,
        launches_b1_b2_b3=launches,
        local_steps_per_window=_online_steps(),
        retrains={w: {k: v for k, v in r.items() if k != "center"}
                  for w, r in retrains.items()},
        saves=[{k: v for k, v in s.items() if k != "published_at"}
               for s in steps_info.values()],
        verifies=verifies,
        load_s={s: v["seconds"] for s, v in loaded.items()},
        publish_to_roll_s=rolled_at - steps_info[1]["published_at"],
        roll_s=rolled_at - roll["started"] if "started" in roll else None)


def online_phase(seed: int) -> dict:
    """The serving tier and the online serve-to-train loop at GPT-2 small's
    widths and depth (``ONLINE_MODEL``, f32, random from ``seed``): two
    ``ServingEngine`` replicas (``ONLINE_SLOTS`` slots, pages of
    ``ONLINE_PAGE``) behind one ``ServingTier`` of two ``LocalReplica``s,
    telemetry and the per-tenant ledger on.

    (a) failover: ``kill_replica=ONLINE_KILL`` armed, ``ONLINE_REQUESTS``
    requests (prompts of ``ONLINE_PROMPT_LEN``, ``ONLINE_NEW_TOKENS`` new
    tokens, half seeded-sampled, tenants ``a`` and ``b``) through
    ``tier.generate`` from ``ONLINE_CLIENTS`` threads.  Gates: every
    request completes; one replica dead, ``serving_tier_failovers_total``
    >= 1; greedy tokens equal to each request served alone except where the
    reference's top-two gap is under ``GREEDY_GAP``, sampled ones exactly;
    the router's ledger bills 16 requests, once each; B1 launches 0 (the
    decode step's attention is the plain masked product);
    (b) the loop: a fresh tier behind ``install_tier_endpoint`` on the
    flight deck with a ``TrafficLog(window_samples=ONLINE_WINDOW,
    max_len=ONLINE_ROW)``, ``watch_checkpoints`` restoring each step's
    center on the card with ``restore_center``, ``kill_epoch=0,flip_ckpt=0``
    armed; ``ONLINE_REQUESTS`` requests POSTed give two windows, closed one
    at a time by ``WindowScheduler.step_once`` (``DOWNPOUR`` over the served
    model, ``_online_train_fn``).  ``torn_ckpt`` would truncate window 0's
    step, which the watcher's fast size check never surfaces; ``flip_ckpt``
    rots one bit with the sizes kept, so the step reaches the swap and its
    full re-verify rejects it there.  Gates: 2 windows published and 2
    trained; ``online_retrain_failures_total`` 1 (the killed first
    attempt, before any device work); window 0's step rejected at swap time
    (``serving_checkpoint_rejected_total`` 1) with the fleet's parameters
    kept; window 1's step rolled into both replicas (2 hot swaps), each
    serving the step's center bit for bit, and the requests put in flight
    as the roll starts finishing with a reason other than ``aborted``; the
    step's ``DataState`` at ``epoch=1``, ``block_cursor`` = the window's
    ``last_seq + 1``; ``ONLINE_PROBES`` greedy prompts through the tier
    held to a fresh engine on the step's center by the ``GREEDY_GAP`` rule;
    B1-B3 each launched blocks x 2 windows x the local steps of a window's
    epoch (``plan_epoch``); capture errors and roll failures 0.  Prints each
    save's and full verify's bytes and seconds, the retrain's tokens/s and
    the time from window 1's publish to the roll."""
    import os
    import tempfile

    from distkeras_tpu_torch import telemetry
    from distkeras_tpu_torch.models import TorchModel, TrainedModel, TransformerLM
    from distkeras_tpu_torch.telemetry import accounting

    cuda = ZOO_DEVICE == "cuda"
    blocks = ONLINE_MODEL["num_layers"]
    model = TransformerLM(**ONLINE_MODEL, generator=torch.Generator().manual_seed(seed + 30))
    params = {name: p.detach().clone() for name, p in model.named_parameters()}
    trained = TrainedModel(TorchModel(model), params, device=ZOO_DEVICE)
    row = dict(model="TransformerLM", **ONLINE_MODEL, slots=ONLINE_SLOTS, page=ONLINE_PAGE,
               params=sum(p.numel() for p in params.values()), card=CARD)
    failures = []
    saved_dir = os.environ.get("DISTKERAS_TELEMETRY_DIR")
    with tempfile.TemporaryDirectory() as workdir:
        os.environ["DISTKERAS_TELEMETRY_DIR"] = os.path.join(workdir, "telemetry")
        telemetry.configure(True)
        accounting.configure(True)
        accounting.reset()
        try:
            t0 = time.perf_counter()
            fo = row["failover"] = _online_failover(trained, seed)
            fo["seconds"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            loop = row["loop"] = _online_loop(model, trained, seed, workdir)
            loop["seconds"] = time.perf_counter() - t0
        finally:
            telemetry.metrics.reset()
            telemetry.trace.reset()
            accounting.configure(None)
            accounting.reset()
            telemetry.configure(None)
            if saved_dir is None:
                os.environ.pop("DISTKERAS_TELEMETRY_DIR", None)
            else:
                os.environ["DISTKERAS_TELEMETRY_DIR"] = saved_dir
    n = ONLINE_REQUESTS
    if fo["dead"] != 1 or fo["failovers"] < 1:
        failures.append(f"failover: {fo['dead']} dead replicas, {fo['failovers']} failovers")
    if fo["sampled_mismatched"]:
        failures.append(f"failover: sampled requests {fo['sampled_mismatched']} gave other "
                        "tokens alone")
    if (fo["routed"], fo["billed_requests"]) != (n, n) or fo["billed_tenants"] != ["a", "b"]:
        failures.append(f"failover: routed {fo['routed']}, billed {fo['billed_requests']} "
                        f"requests to {fo['billed_tenants']}")
    if fo["launches_b1"] != 0:
        failures.append(f"failover: B1 launched {fo['launches_b1']} times while serving")
    expected = [blocks * 2 * loop["local_steps_per_window"] if cuda else 0] * 3
    loop["expected_launches"] = expected[0]
    checks = {
        "2 windows published": loop["windows_published"] == [0, 1],
        "2 windows trained": loop["windows_trained"] == 2,
        "one retrain failure (the killed attempt)": loop["retrain_failures"] == 1,
        "window 0's step rejected at swap time": (loop["window0_rejected"]
                                                  and loop["ckpt_rejected"] == 1),
        "window 1's step rolled into both replicas": (loop["rolled"] and loop["hot_swaps"] == 2
                                                      and loop["loaded_steps"] == [2]),
        "each replica serves the step bit for bit": loop["replicas_bitwise_the_step"] == [True,
                                                                                         True],
        "nothing aborted across the roll": (loop["roll_statuses"] == [200] * len(
            loop["roll_statuses"]) and "aborted" not in loop["roll_finish_reasons"]),
        "every POST answered 200": loop["http_statuses"] == [200],
        "the step's DataState": loop["data_state"] == dict(
            epoch=1, block_cursor=loop["window1_last_seq"] + 1),
        "B1-B3 launches": loop["launches_b1_b2_b3"] == expected,
        "no capture error, no roll failure": (loop["capture_errors"], loop["roll_failures"])
        == (0, 0),
    }
    failures += [f"loop: {name}: {loop}" if name == "B1-B3 launches" else f"loop: {name}"
                 for name, ok in checks.items() if not ok]
    row["failures"] = failures
    emit(phase="online", **row)
    if failures:
        raise AssertionError(f"online: {failures}")
    return row


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0, help="seed for weights and inputs")
    parser.add_argument("--mesh-rank", metavar="SPEC", default=None,
                        help="run one spawned rank of the mesh phase (internal)")
    parser.add_argument("--seq-rank", metavar="SPEC", default=None,
                        help="run one spawned rank of the sequence-parallel phase (internal)")
    parser.add_argument("--tp-rank", metavar="SPEC", default=None,
                        help="run one spawned rank of the tensor-parallel phase (internal)")
    parser.add_argument("--serving-tp-rank", metavar="SPEC", default=None,
                        help="run one spawned rank of the tensor-parallel serving phase "
                             "(internal)")
    parser.add_argument("--moe-rank", metavar="SPEC", default=None,
                        help="run one spawned rank of the MoE phase (internal)")
    parser.add_argument("--pp-rank", metavar="SPEC", default=None,
                        help="run one spawned rank of the pipeline phase (internal)")
    parser.add_argument("--pp3d-rank", metavar="SPEC", default=None,
                        help="run one spawned rank of the pipeline_3d phase (internal)")
    parser.add_argument("--gloo-lane", metavar="SPEC", default=None,
                        help="run phases 19 to 24 beside the parent's (internal)")
    args = parser.parse_args(argv)
    if args.gloo_lane is not None:
        return gloo_lane_main(args.gloo_lane)
    if any(v is not None for k, v in vars(args).items() if k.endswith("_rank")):
        # a spawned rank: SIGUSR1 prints every thread's stack to its output
        # (_run_ranks sends it to a rank past its timeout before the kill)
        import faulthandler
        import signal

        faulthandler.register(signal.SIGUSR1, file=sys.stdout, all_threads=True)
    if args.mesh_rank is not None:
        return mesh_rank_main(args.mesh_rank)
    if args.seq_rank is not None:
        return seq_rank_main(args.seq_rank)
    if args.tp_rank is not None:
        return tp_rank_main(args.tp_rank)
    if args.serving_tp_rank is not None:
        return serving_tp_rank_main(args.serving_tp_rank)
    if args.moe_rank is not None:
        return moe_rank_main(args.moe_rank)
    if args.pp_rank is not None:
        return pp_rank_main(args.pp_rank)
    if args.pp3d_rank is not None:
        return pp3d_rank_main(args.pp3d_rank)

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
    global CARD
    CARD = smi
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

    seconds = {}
    timed = _timer(seconds, t0)
    t_phases = time.perf_counter()
    cases = timed("kernel", kernel_phase, args.seed)
    bwd_cases = timed("bwd_kernel", bwd_kernel_phase, args.seed)
    # the kernels are timed: phases 19 to 24 start beside the rest
    lane = GlooLane(args.seed, t0)
    try:
        predictor_launches = timed("predictor", predictor_phase, args.seed)
        lm_launches = timed("lm", lm_phase, args.seed)
        train_launches, train_run = timed("train", train_phase, args.seed)
        timed("zoo", zoo_phase, args.seed)
        timed("staleness", staleness_phase, args.seed)
        timed("flow", flow_phase, args.seed)
        head_dim_rows = timed("head_dim", head_dim_phase, args.seed)
        timed("networking", networking_phase, args.seed)
        eager_run, cifar_frame, _, _ = timed("epochs", epochs_phase, args.seed)
        timed("streaming", streaming_phase, args.seed, eager_run, cifar_frame)
        timed("checkpoint", checkpoint_phase, args.seed, eager_run, cifar_frame)
        remat_graph = timed("remat_graph", remat_graph_phase, args.seed, train_run)
        serving = timed("serving", serving_phase, args.seed)
        packing = timed("packing", packing_phase, args.seed)
        mesh = timed("mesh", mesh_phase, args.seed, eager_run, cifar_frame, train_launches,
                     train_run)
        hf = timed("hf_telemetry", hf_telemetry_phase, args.seed)
        fleet = timed("fleet", fleet_phase, args.seed)
        online = timed("online", online_phase, args.seed)
        t_lane = time.perf_counter()
        lane_rows, lane_seconds = lane.result(LANE_TIMEOUT_S)
        lane_wait = time.perf_counter() - t_lane
    finally:
        lane.stop()
    seq, tp, serving_tp = lane_rows["seq"], lane_rows["tp"], lane_rows["serving_tp"]
    moe, pp, pp3d = lane_rows["moe"], lane_rows["pipeline"], lane_rows["pipeline_3d"]
    # total_s is the phases' wall, from the first to the end of the last
    # (the lane's overlap the others); wall_s adds the build before them;
    # phases_summed_s counts the overlap twice
    end = time.perf_counter()
    emit(phase="timing", seconds=dict(seconds, **lane_seconds),
         gloo_lane=list(lane_seconds), total_s=end - t_phases, wall_s=end - t0,
         phases_summed_s=sum(seconds.values()) + sum(lane_seconds.values()),
         lane_s=sum(lane_seconds.values()), waiting_for_the_lane_s=lane_wait, card=CARD)

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
        "launches_remat_graph": remat_graph["launches_remat_graph"][0],
        "launches_serving": serving["engine"]["launches_b1"],
        "launches_greedy_generate": serving["greedy"]["launches_b1"],
        "launches_greedy_check": serving["greedy"]["launches_b1_check"],
        "launches_packing_forward": packing["launches_packed_forward"],
        "launches_packing_alone": packing["launches_alone"],
        "launches_packing_train": packing["train"]["launches_b1_b2_b3"][0],
        "launches_mesh_train": mesh["one_rank"]["lm"]["launches"][0],
        "launches_seq_train": seq["launches_b1_b2_b3"][0],
        "launches_seq_classifier": seq["classifier"]["launches_b1_b2_b3"][0],
        "launches_seq_twin_predictor": seq["twin_predictor"]["launches_b1"],
        "launches_tp_train_per_rank": tp["launches_b1_b2_b3"][0],
        "launches_tp_train_one_rank": tp["launches_b1_b2_b3_one_rank"][0],
        "launches_tp_predictor": tp["predictor"]["launches_b1"],
        "launches_serving_tp_rank0": serving_tp["launches_b1_b2_b3"][0],
        "launches_moe_train_one_rank": moe["one_rank"]["launches_b1_b2_b3"][0],
        "launches_moe_train_ep_per_rank": moe["two_ranks_one_card"]["launches_b1_b2_b3"][0],
        "launches_moe_step_check": moe["one_rank"]["step_vs_cpu"]["launches_b1_b2_b3"][0],
        "launches_moe_predictor": moe["one_rank"]["predictor"]["launches_b1"],
        "launches_pp_train_per_rank": [r[0] for r in pp["launches_b1_b2_b3_per_rank"]],
        "launches_pp_train_one_rank": pp["launches_b1_b2_b3_one_rank"][0],
        "launches_pp3d_tp_train_per_rank": [r[0] for r in
                                            pp3d["tp"]["launches_b1_b2_b3_per_rank"]],
        "launches_pp3d_tp_fsdp_train_per_rank": [r[0] for r in
                                                 pp3d["tp_fsdp"]["launches_b1_b2_b3_per_rank"]],
        "launches_pp3d_sp_train_per_rank": [r[0] for r in
                                            pp3d["sp"]["launches_b1_b2_b3_per_rank"]],
        "launches_hf_forward": hf["forward_launches_b1"],
        "launches_hf_train_plain_and_observed": [hf["launches_b1_b2_b3_plain"][0],
                                                 hf["launches_b1_b2_b3_observed"][0]],
        **fleet_launches(fleet, 0),
        "launches_online_retrain": online["loop"]["launches_b1_b2_b3"][0],
        "launches_fleet_job_child_and_parent": [fleet["job"]["child"]["launches_b1"],
                                                fleet["job"]["parent"]["launches_b1"]],
        "launches_online_serving": online["failover"]["launches_b1"],
        "head_dims_and_f16": coverage("fwd"),
    }, {
        "name": "flash_attention_bwd_dq",
        "replaces": "distkeras_tpu/ops/pallas/flash_attention.py:247",
        "launches": train_launches["flash_attention_bwd_dq"],
        "launches_train_eager_and_remat": [remat_graph["launches_eager"][1],
                                           remat_graph["launches_remat"][1]],
        "launches_graph": remat_graph["launches_graph"][1],
        "launches_remat_graph": remat_graph["launches_remat_graph"][1],
        "launches_packing_train": packing["train"]["launches_b1_b2_b3"][1],
        "launches_mesh_train": mesh["one_rank"]["lm"]["launches"][1],
        "launches_seq_train": seq["launches_b1_b2_b3"][1],
        "launches_tp_train_per_rank": tp["launches_b1_b2_b3"][1],
        "launches_tp_train_one_rank": tp["launches_b1_b2_b3_one_rank"][1],
        "launches_serving_tp_rank0": serving_tp["launches_b1_b2_b3"][1],
        "launches_moe_train_one_rank": moe["one_rank"]["launches_b1_b2_b3"][1],
        "launches_moe_train_ep_per_rank": moe["two_ranks_one_card"]["launches_b1_b2_b3"][1],
        "launches_pp_train_per_rank": [r[1] for r in pp["launches_b1_b2_b3_per_rank"]],
        "launches_pp_train_one_rank": pp["launches_b1_b2_b3_one_rank"][1],
        "launches_pp3d_tp_train_per_rank": [r[1] for r in
                                            pp3d["tp"]["launches_b1_b2_b3_per_rank"]],
        "launches_pp3d_tp_fsdp_train_per_rank": [r[1] for r in
                                                 pp3d["tp_fsdp"]["launches_b1_b2_b3_per_rank"]],
        "launches_pp3d_sp_train_per_rank": [r[1] for r in
                                            pp3d["sp"]["launches_b1_b2_b3_per_rank"]],
        "launches_hf_train_plain_and_observed": [hf["launches_b1_b2_b3_plain"][1],
                                                 hf["launches_b1_b2_b3_observed"][1]],
        **fleet_launches(fleet, 1),
        "launches_online_retrain": online["loop"]["launches_b1_b2_b3"][1],
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
        "launches_remat_graph": remat_graph["launches_remat_graph"][2],
        "launches_packing_train": packing["train"]["launches_b1_b2_b3"][2],
        "launches_mesh_train": mesh["one_rank"]["lm"]["launches"][2],
        "launches_seq_train": seq["launches_b1_b2_b3"][2],
        "launches_tp_train_per_rank": tp["launches_b1_b2_b3"][2],
        "launches_tp_train_one_rank": tp["launches_b1_b2_b3_one_rank"][2],
        "launches_serving_tp_rank0": serving_tp["launches_b1_b2_b3"][2],
        "launches_moe_train_one_rank": moe["one_rank"]["launches_b1_b2_b3"][2],
        "launches_moe_train_ep_per_rank": moe["two_ranks_one_card"]["launches_b1_b2_b3"][2],
        "launches_pp_train_per_rank": [r[2] for r in pp["launches_b1_b2_b3_per_rank"]],
        "launches_pp_train_one_rank": pp["launches_b1_b2_b3_one_rank"][2],
        "launches_pp3d_tp_train_per_rank": [r[2] for r in
                                            pp3d["tp"]["launches_b1_b2_b3_per_rank"]],
        "launches_pp3d_tp_fsdp_train_per_rank": [r[2] for r in
                                                 pp3d["tp_fsdp"]["launches_b1_b2_b3_per_rank"]],
        "launches_pp3d_sp_train_per_rank": [r[2] for r in
                                            pp3d["sp"]["launches_b1_b2_b3_per_rank"]],
        "launches_hf_train_plain_and_observed": [hf["launches_b1_b2_b3_plain"][2],
                                                 hf["launches_b1_b2_b3_observed"][2]],
        **fleet_launches(fleet, 2),
        "launches_online_retrain": online["loop"]["launches_b1_b2_b3"][2],
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
