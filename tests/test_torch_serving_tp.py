"""Tensor-parallel serving in the port: ``ServingEngine(mesh=)`` over two
gloo ranks on the CPU (heads 8, 4 a rank), against
tests/test_serving_spec.py's ``test_sharded_decode_token_parity_and_speculative_smoke``
and ``test_sharded_engine_validates_mesh``: greedy tokens equal to the JAX
package's unsharded greedy reference (the flax parameters carried over
with ``params_from_flax``), greedy speculative decoding on the mesh equal
to the mesh's own plain stream, and the mesh's checks.  Beyond JAX's test,
the lockstep the port needs (one process a rank): sampled requests equal
to themselves rerun alone, a rank's page pools half of one rank's, a
follower's ``submit`` refused, rank 0's ``stop`` ending every rank's loop,
``hot_swap`` on every rank serving the new weights, and a follower that
crashes mid-step crashing rank 0's engine instead of hanging it.  What a
card captures (each rank's step programs as CUDA graphs, the step group's
collectives inside them): every program of both ranks reads nothing on the
host (the transfer guard), both ranks issue the same collectives in the
same order, and a gloo mesh on a card is refused by name.  On two cards
(``cuda``, skipped below two): a follower that raises at a replay of a
program it captured, instead of replaying, crashes rank 0's engine within a
small multiple of the plan timeout, as the eager crash case does (ROADMAP
C23: a replayed collective has no watchdog, so rank 0 waits for its
replays with a deadline).

The two ranks are spawned **once** for the module (``ranks`` fixture, the
pattern of ``test_torch_ring.py``): each runs this file as a script, joins
the gloo group and builds the same engines in the same order; rank 0
drives them and both write their results.  Tokens are compared exactly, as
JAX's test compares them.
"""

import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)  # the suite runs under xdist: keep each worker small

ROOT = Path(__file__).resolve().parent.parent
WORLD = 2
VOCAB = 23
LM = dict(vocab_size=VOCAB, dim=32, heads=8, num_layers=2, max_len=32)
DRAFT = dict(LM, num_layers=1)
PROMPT_LENS = (3, 6)
NEW_TOKENS = 6
SAMPLED = dict(temperature=0.9, top_k=10, top_p=0.95)
STOP_WITHIN_S = 10.0
CRASH_TIMEOUT_S = 5.0  # the crash case's plan timeout
# the two-card case's plan timeout, also its NCCL step group's: NCCL's
# watchdog ends a rank whose eager collective (the capture's warm-up) waits
# past it, so it allows for the communicators' set-up
CARDS_TIMEOUT_S = 15.0


def prompts():
    rng = np.random.default_rng(9)
    return [rng.integers(0, VOCAB, size=n).tolist() for n in PROMPT_LENS]


# ------------------------------------------------------------------ the ranks

def _load(workdir, name):
    with np.load(os.path.join(workdir, f"{name}.npz")) as got:
        return {k: torch.from_numpy(got[k]) for k in got.files}


def _pool_bytes(cache):
    return cache.k_pages.nbytes + cache.v_pages.nbytes


def _engine(workdir, mesh, name="params", **kwargs):
    from distkeras_tpu_torch.models import TransformerLM
    from distkeras_tpu_torch.serving import ServingEngine
    from distkeras_tpu_torch.telemetry.metrics import Registry

    return ServingEngine(TransformerLM(**LM), _load(workdir, name), num_slots=2, page_size=8,
                         mesh=mesh, registry=Registry(), device="cpu", **kwargs)


def _leader(workdir, mesh, out):
    """Rank 0: drive every engine (the followers build the same ones)."""
    from distkeras_tpu_torch.models import TransformerLM
    from distkeras_tpu_torch.serving import EngineCrashed, GenerateRequest

    plain = _engine(workdir, mesh)
    out["pool_bytes"] = _pool_bytes(plain._cache)
    out["greedy"] = [plain.generate(p, max_new_tokens=NEW_TOKENS, timeout=120).tokens
                     for p in prompts()]
    # staggered traffic, half of it sampled; then each sampled request alone
    reqs = [dict(prompt=p, max_new_tokens=NEW_TOKENS, seed=s, **(SAMPLED if s % 2 else {}))
            for s, p in enumerate(prompts() * 2)]
    pendings = []
    for r in reqs:
        pendings.append(plain.submit(GenerateRequest(**r)))
        time.sleep(0.01)
    out["traffic"] = [p.result(timeout=120).tokens for p in pendings]
    out["alone"] = [plain.generate(**r, timeout=120).tokens for r in reqs]
    out["sampled"] = [bool(r["seed"] % 2) for r in reqs]
    plain.hot_swap(TransformerLM(**LM), _load(workdir, "swapped"), timeout=120)
    out["swapped"] = [plain.generate(p, max_new_tokens=NEW_TOKENS, timeout=120).tokens
                      for p in prompts()]
    out["all_reduces"] = plain.all_reduces
    out["stop_at"] = time.monotonic()  # the system-wide clock both ranks read
    plain.stop(timeout=30)

    spec = _engine(workdir, mesh, draft_model=TransformerLM(**DRAFT),
                   draft_params=_load(workdir, "draft"), spec_tokens=2)
    out["speculative"] = [spec.generate(p, max_new_tokens=NEW_TOKENS, timeout=120).tokens
                          for p in prompts()]
    out["draft_pool_bytes"] = _pool_bytes(spec._draft_cache)
    spec.stop(timeout=30)
    _programs_case(workdir, mesh, out)

    from distkeras_tpu_torch.serving import engine as engine_module

    engine_module.PLAN_TIMEOUT_S = CRASH_TIMEOUT_S
    crashing = _engine(workdir, mesh)
    t0 = time.perf_counter()
    result = crashing.generate(prompts()[0], max_new_tokens=NEW_TOKENS, timeout=120)
    out["crash"] = {"finish_reason": result.finish_reason, "seconds": time.perf_counter() - t0,
                    "alive": crashing.alive}
    try:
        crashing.submit(GenerateRequest(prompt=prompts()[0]))
        out["crash"]["submit"] = "accepted"
    except EngineCrashed as e:
        out["crash"]["submit"] = f"EngineCrashed: {e}"
    crashing.stop(timeout=30)


def _follower(workdir, mesh, out):
    """Every other rank: build the same engines, make the collective calls
    (``hot_swap``), and wait for rank 0's stop plans."""
    from distkeras_tpu_torch.models import TransformerLM
    from distkeras_tpu_torch.serving import GenerateRequest

    plain = _engine(workdir, mesh)
    out["pool_bytes"] = _pool_bytes(plain._cache)
    try:
        plain.submit(GenerateRequest(prompt=[1, 2, 3]))
        out["submit"] = "accepted"
    except RuntimeError as e:
        out["submit"] = str(e)
    plain.hot_swap(TransformerLM(**LM), _load(workdir, "swapped"), timeout=120)
    plain.stop(timeout=120)
    out["stopped_at"] = time.monotonic()
    out["stopped"] = plain._thread is None and plain.alive

    spec = _engine(workdir, mesh, draft_model=TransformerLM(**DRAFT),
                   draft_params=_load(workdir, "draft"), spec_tokens=2)
    spec.stop(timeout=120)
    _programs_case(workdir, mesh, out)

    from distkeras_tpu_torch.serving import engine as engine_module

    def crash(*args, **kwargs):
        raise RuntimeError("a follower fault in the middle of a step")

    engine_module.PLAN_TIMEOUT_S = CRASH_TIMEOUT_S
    engine_module.ServingEngine._prefill = crash  # the last engine of this rank
    crashing = _engine(workdir, mesh)
    deadline = time.monotonic() + 120
    while crashing.alive and time.monotonic() < deadline:
        time.sleep(0.05)
    out["crashed"] = not crashing.alive and "follower fault" in repr(crashing.error)
    # stay up past rank 0's timeout: its all-reduce must time out, not see
    # this process go
    time.sleep(2 * CRASH_TIMEOUT_S)


def _programs_case(workdir, mesh, out):
    """The step programs as a card captures them, on both ranks: a plain
    and a speculative engine serve (rank 0 drives, the follower follows)
    with every program run under the transfer guard and every collective
    recorded, from the engines' build to their stop."""
    from distkeras_tpu_torch.models import TransformerLM
    from distkeras_tpu_torch.serving import ServingEngine
    from test_torch_ring import host_reads, recording_collectives

    program, reads = ServingEngine._program, []

    def guarded(self, key, fn):
        with host_reads() as found:
            result = program(self, key, fn)
        reads.extend(found)
        return result

    ServingEngine._program = guarded
    try:
        with recording_collectives() as log:
            for kwargs in ({}, dict(draft_model=TransformerLM(**DRAFT),
                                    draft_params=_load(workdir, "draft"), spec_tokens=2)):
                engine = _engine(workdir, mesh, **kwargs)
                if engine.leads:
                    out.setdefault("programs_tokens", []).append(
                        engine.generate(prompts()[1], max_new_tokens=NEW_TOKENS,
                                        timeout=120).tokens)
                    engine.stop(timeout=30)
                else:
                    engine.stop(timeout=120)
    finally:
        ServingEngine._program = program
    out["programs_collectives"], out["programs_host_reads"] = log, reads


def _block_case(workdir, mesh, out):
    """One target block on this rank's heads with the sum over the mesh,
    against the whole block: the qkv/proj split and the bias added once."""
    from distkeras_tpu_torch.models import TransformerLM
    from distkeras_tpu_torch.models.transformer import masked_attention
    from distkeras_tpu_torch.parallel.mesh import all_reduce_sum, mesh_group, mesh_rank
    from distkeras_tpu_torch.serving.engine import _block_apply, _resolve_spec, _shard_heads

    spec = _resolve_spec(TransformerLM(**LM), _load(workdir, "params"), torch.device("cpu"))
    part = _shard_heads(spec, WORLD, mesh_rank(mesh))
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(2, 5, LM["dim"]))
                         .astype(np.float32))
    hidden = torch.ones(5, 5, dtype=torch.bool).triu(1)[None, :, None, :]

    def attend(q, k, v):
        return masked_attention(q, k, v, hidden)

    group = mesh_group(mesh)
    whole = _block_apply(spec.blocks[0], x, attend, spec.ln_eps, spec.heads, spec.head_dim)
    split = _block_apply(part.blocks[0], x, attend, part.ln_eps, part.heads, part.head_dim,
                         psum=lambda t: all_reduce_sum([t], group)[0])
    out["block_err"] = float((split - whole).abs().max())
    out["block_heads"] = part.heads


def _bad_meshes(out):
    """The JAX engine's mesh checks, made before any group is joined."""
    from distkeras_tpu_torch.models import TransformerLM
    from distkeras_tpu_torch.parallel.mesh import make_mesh, make_mesh_grid
    from distkeras_tpu_torch.serving import ServingEngine

    model = TransformerLM(vocab_size=VOCAB, dim=24, heads=3, num_layers=1, max_len=16)
    params = {k: v.detach() for k, v in model.named_parameters()}
    for name, mesh in (("heads", make_mesh(WORLD, axis_name="model")),
                       ("two_axes", make_mesh_grid(1, WORLD, axis_names=("workers", "model")))):
        try:
            ServingEngine(model, params, mesh=mesh, device="cpu")
            out[name] = "built"
        except ValueError as e:
            out[name] = str(e)


def _card_refusal(mesh, out):
    """On a (faked) card a mesh's step programs are captured, which a gloo
    group cannot be: the engine refuses it before it allocates anything."""
    from distkeras_tpu_torch.models import TransformerLM
    from distkeras_tpu_torch.serving import ServingEngine
    from test_torch_ring import faked_card

    model = TransformerLM(**LM)
    try:
        with faked_card():
            ServingEngine(model, {k: v.detach() for k, v in model.named_parameters()},
                          mesh=mesh, device="cuda")
        out["card_gloo"] = "built"
    except ValueError as e:
        out["card_gloo"] = str(e)


def _rank_main(rank: int, world: int, init: str, workdir: str) -> None:
    import torch.distributed as dist

    from distkeras_tpu_torch.parallel.mesh import make_mesh

    dist.init_process_group("gloo", init_method=init,
                            world_size=world, rank=rank)
    out = {}
    try:
        mesh = make_mesh(world, axis_name="model")
        _bad_meshes(out)
        _card_refusal(mesh, out)
        _block_case(workdir, mesh, out)
        (_leader if rank == 0 else _follower)(workdir, mesh, out)
    finally:
        with open(os.path.join(workdir, f"rank_{rank}.json"), "w", encoding="utf-8") as fh:
            json.dump(out, fh)
    # the crash case's groups are left broken: end without a collective
    os._exit(0)


def _cards_main(where: str, rank: int, world: int, init: str, workdir: str) -> None:
    """One NCCL rank a card, serving ``mesh=`` with captured programs: a
    first request captures the prefill and the decode step (one decode
    step, replayed once); then the follower raises at its next ``where``
    program (``decode`` or ``prefill``, a key it has captured) instead of
    replaying it, and stays up; rank 0 serves a second request.  Each rank
    writes ``cards_<rank>.json``; a rank still running after 100 s prints
    every thread's stack."""
    import faulthandler

    import torch.distributed as dist

    from distkeras_tpu_torch.models import TransformerLM
    from distkeras_tpu_torch.parallel.mesh import make_mesh
    from distkeras_tpu_torch.serving import EngineCrashed, GenerateRequest, ServingEngine
    from distkeras_tpu_torch.serving import engine as engine_module
    from distkeras_tpu_torch.telemetry.metrics import Registry

    faulthandler.dump_traceback_later(100)
    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method=init, world_size=world, rank=rank)
    engine_module.PLAN_TIMEOUT_S = CARDS_TIMEOUT_S
    if rank != 0:
        program = ServingEngine._program

        def failing(self, key, fn):
            if key[0] == where and key in self._programs:
                raise RuntimeError(f"a follower fault at its {where} replay")
            return program(self, key, fn)

        ServingEngine._program = failing
    model = TransformerLM(**LM, generator=torch.Generator().manual_seed(4))
    engine = ServingEngine(model, {k: v.detach() for k, v in model.named_parameters()},
                           num_slots=2, page_size=8, mesh=make_mesh(world, axis_name="model"),
                           registry=Registry(), device="cuda")
    out = {}
    if rank == 0:
        first = engine.generate(prompts()[0], max_new_tokens=2, timeout=120)
        out["first"] = {"finish_reason": first.finish_reason, "tokens": len(first.tokens),
                        **engine.graph_stats}
        t0 = time.perf_counter()
        result = engine.generate(prompts()[0], max_new_tokens=NEW_TOKENS, timeout=120)
        out["crash"] = {"finish_reason": result.finish_reason,
                        "seconds": time.perf_counter() - t0, "alive": engine.alive,
                        "error": repr(engine.error),
                        # the replay that waited has returned once the stream drains
                        "stream_drained": torch.cuda.current_stream().query()}
        try:
            engine.submit(GenerateRequest(prompt=prompts()[0]))
            out["crash"]["submit"] = "accepted"
        except EngineCrashed as e:
            out["crash"]["submit"] = f"EngineCrashed: {e}"
    else:
        deadline = time.monotonic() + 120
        while engine.alive and time.monotonic() < deadline:
            time.sleep(0.05)
        out["crashed"] = not engine.alive and "follower fault" in repr(engine.error)
        out["captures"] = engine.graph_stats["captures"]
        # stay up past rank 0's deadline: its wait must time out, not see
        # this process go
        time.sleep(2 * CARDS_TIMEOUT_S)
    with open(os.path.join(workdir, f"cards_{rank}.json"), "w", encoding="utf-8") as fh:
        json.dump(out, fh)
    os._exit(0)  # the step group is aborted on rank 0: end without a collective


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    if sys.argv[1] == "--cards":
        _cards_main(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), sys.argv[5], sys.argv[6])
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])


# ------------------------------------------------------------- test process

def _flax(seed, cfg=LM):
    """A JAX LM and its parameters, each perturbed off its initial value
    (flax starts every bias at 0: the bias-once rule would not show)."""
    import jax

    from distkeras_tpu.models import TransformerLM as JaxLM

    module = JaxLM(**cfg)
    params = module.init(jax.random.PRNGKey(seed), np.zeros((1, 4), np.int32))["params"]
    rng = np.random.default_rng(seed)
    return module, jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * rng.standard_normal(a.shape).astype(np.float32), params)


def _ref(module, params, prompt, steps):
    from distkeras_tpu.models.generate import greedy_generate_module

    out = greedy_generate_module(module, params, np.asarray([prompt], np.int32), steps)
    return out[0, len(prompt):].tolist()


def _save(workdir, name, cfg, params):
    from distkeras_tpu_torch.models import TransformerLM, params_from_flax

    got = params_from_flax(TransformerLM(**cfg), params)
    np.savez(os.path.join(workdir, f"{name}.npz"), **{k: v.numpy() for k, v in got.items()})


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """``(rank 0's results, rank 1's, JAX's greedy references)``."""
    from test_torch_ring import spawn_ranks

    workdir = str(tmp_path_factory.mktemp("serving_tp"))
    module, params = _flax(8)
    _, swapped = _flax(10)
    _, draft = _flax(11, DRAFT)
    _save(workdir, "params", LM, params)
    _save(workdir, "swapped", LM, swapped)
    _save(workdir, "draft", DRAFT, draft)
    refs = {"params": [_ref(module, params, p, NEW_TOKENS) for p in prompts()],
            "swapped": [_ref(module, swapped, p, NEW_TOKENS) for p in prompts()]}
    spawn_ranks(__file__, WORLD, workdir)
    results = []
    for r in range(WORLD):
        with open(os.path.join(workdir, f"rank_{r}.json"), encoding="utf-8") as fh:
            results.append(json.load(fh))
    return results[0], results[1], refs


def test_sharded_greedy_tokens_equal_jax_unsharded_greedy(ranks):
    """Each rank contracts its 4 heads; the psum and the bias added once
    give JAX's unsharded greedy tokens (the psum reorders float sums:
    token-equal, as JAX's test claims, not bitwise)."""
    leader, _, refs = ranks
    assert leader["greedy"] == refs["params"]
    assert leader["all_reduces"] > 0


def test_the_bias_is_added_once_after_the_sum(ranks):
    """A block on 4 of the 8 heads, summed over the two ranks, is the whole
    block within 1e-5: ``proj``'s bias rides outside the sum."""
    for got in ranks[:2]:
        assert got["block_heads"] == LM["heads"] // WORLD
        assert got["block_err"] < 1e-5, got["block_err"]


def test_speculative_on_the_mesh_is_the_mesh_plain_stream(ranks):
    """Sharded verify with the replicated draft: greedy speculative tokens
    are the mesh's own plain stream."""
    leader, _, _ = ranks
    assert leader["speculative"] == leader["greedy"]


def test_sampled_requests_equal_themselves_rerun_alone(ranks):
    """Staggered traffic, half sampled: every request's tokens are those
    it gets alone (its counter stream is its own); the greedy ones are the
    greedy stream."""
    leader, _, _ = ranks
    assert any(leader["sampled"]) and not all(leader["sampled"])
    assert leader["traffic"] == leader["alone"]
    for tokens, sampled, want in zip(leader["traffic"], leader["sampled"],
                                     leader["greedy"] * 2):
        if not sampled:
            assert tokens == want


def test_a_rank_pools_are_half_of_one_rank(ranks):
    """Each rank's target pools hold 4 of the 8 heads; the draft's stay
    whole (``num_pages x page_size x heads x head_dim`` f32, K and V)."""
    leader, follower, _ = ranks
    pages = 2 * (LM["max_len"] // 8) + 1
    one_rank = 2 * LM["num_layers"] * pages * 8 * LM["heads"] * (LM["dim"] // LM["heads"]) * 4
    assert leader["pool_bytes"] == follower["pool_bytes"] == one_rank // 2
    assert leader["draft_pool_bytes"] == one_rank // LM["num_layers"] * DRAFT["num_layers"]


def test_a_follower_refuses_requests(ranks):
    _, follower, _ = ranks
    assert "mesh rank 0" in follower["submit"], follower["submit"]


def test_stop_on_rank_0_ends_every_rank_loop(ranks):
    leader, follower, _ = ranks
    assert follower["stopped"]
    assert follower["stopped_at"] - leader["stop_at"] < STOP_WITHIN_S


def test_hot_swap_under_the_mesh_serves_the_new_weights(ranks):
    leader, _, refs = ranks
    assert refs["swapped"] != refs["params"]
    assert leader["swapped"] == refs["swapped"]


def test_a_follower_crash_mid_step_crashes_rank_0(ranks):
    """The follower fails in its prefill and stays up; rank 0's all-reduce
    times out (the plan timeout), its engine crashes: the request aborts
    and ``submit`` raises EngineCrashed; neither rank hangs."""
    leader, follower, _ = ranks
    crash = leader["crash"]
    assert crash["finish_reason"] == "aborted" and not crash["alive"], crash
    assert crash["submit"].startswith("EngineCrashed"), crash
    assert CRASH_TIMEOUT_S * 0.5 < crash["seconds"] < 4 * CRASH_TIMEOUT_S, crash
    assert follower["crashed"]


@pytest.mark.parametrize("case,match", [("heads", "heads 3 not divisible by mesh size 2"),
                                        ("two_axes", "must be 1-D")])
def test_sharded_engine_validates_mesh(ranks, case, match):
    for got in ranks[:2]:
        assert match in got[case], got[case]


def test_a_gloo_mesh_on_a_card_is_refused_naming_nccl(ranks):
    """A serving mesh's programs are captured on a card, their all-reduces
    inside the graphs: gloo, which stages CUDA tensors through the host,
    is refused by name (``CAPTURE_PROGRAMS = False`` serves it eagerly)."""
    for got in ranks[:2]:
        assert "only NCCL collectives can be captured" in got["card_gloo"], got["card_gloo"]
        assert "CAPTURE_PROGRAMS" in got["card_gloo"]


def test_every_program_reads_nothing_on_the_host_and_both_ranks_pair(ranks):
    """Each prefill, decode step and speculative iteration, rank 0's and
    the follower's, under the transfer guard: no host read.  Both ranks
    issue the same collectives in the same order (the plans, the all-reduce
    a block, the drafts and counts a verify step takes from rank 0), so
    that captured programs pair at every replay."""
    leader, follower, _ = ranks
    assert leader["programs_tokens"] == [leader["greedy"][1]] * 2
    log = leader["programs_collectives"]
    assert log and log == follower["programs_collectives"]
    assert {"all_reduce", "broadcast"} == {c[0] for c in log}
    assert leader["programs_host_reads"] == follower["programs_host_reads"] == []


@pytest.mark.cuda
@pytest.mark.parametrize("where", ["decode", "prefill"])
def test_a_follower_gone_before_a_captured_replay_crashes_rank_0(tmp_path, where):
    """ROADMAP C23 on two cards: the follower raises at a replay of its
    captured ``where`` program and stays up; rank 0 replays its own, whose
    all-reduce waits for the follower for ever, and a replayed collective
    has no watchdog.  Rank 0 waits with the plan timeout as its deadline,
    aborts the step group, and its engine crashes: the request aborts and
    ``submit`` raises EngineCrashed; neither rank hangs.  Each rank's
    output is kept in ``tmp_path``."""
    import subprocess

    from test_torch_ring import rendezvous

    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards: NCCL refuses two ranks on one card, so a "
                    "captured serving mesh runs only on a machine with several cards")
    import signal

    workdir = str(tmp_path)
    init = rendezvous(workdir)
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    logs = [open(os.path.join(workdir, f"log_{r}.txt"), "w+", encoding="utf-8")
            for r in range(2)]
    procs = [subprocess.Popen([sys.executable, __file__, "--cards", where, str(r), "2", init,
                               workdir], cwd=ROOT, env=env, stdout=logs[r],
                              stderr=subprocess.STDOUT, start_new_session=True)
             for r in range(2)]
    deadline = time.monotonic() + 120
    try:
        for proc in procs:
            proc.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for proc in procs:  # a rank left waiting must not outlive the test
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
    tails = []
    for r, log in enumerate(logs):
        log.seek(0)
        tails.append(f"--- rank {r} (exit {procs[r].returncode}):\n{log.read()[-3000:]}")
        log.close()
    for proc in procs:
        assert proc.returncode == 0, "\n".join(tails)
    got = []
    for rank in range(2):
        with open(os.path.join(workdir, f"cards_{rank}.json"), encoding="utf-8") as fh:
            got.append(json.load(fh))
    leader, follower = got
    first = leader["first"]
    assert first["finish_reason"] == "length" and first["tokens"] == 2, first
    assert first["captures"] == 2 and first["replays"] == 2, first  # prefill, decode
    crash = leader["crash"]
    assert crash["finish_reason"] == "aborted" and not crash["alive"], crash
    assert "TimeoutError" in crash["error"], crash
    assert crash["submit"].startswith("EngineCrashed"), crash
    assert CARDS_TIMEOUT_S * 0.5 < crash["seconds"] < 4 * CARDS_TIMEOUT_S, crash
    assert follower["crashed"] and follower["captures"] == 2, follower
