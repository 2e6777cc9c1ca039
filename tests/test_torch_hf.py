"""HuggingFace GPT-2 in the port: ``HuggingFaceModel`` over a PyTorch
``GPT2LMHeadModel`` and ``gpt2_to_staged`` (a checkpoint on the pipeline
engine), case by case against tests/test_hf.py and tests/test_hf_staged.py.

The models are built as JAX's tests build them: a Flax GPT-2 from one
``GPT2Config`` and seed, its weights carried to a torch ``GPT2LMHeadModel``
with ``transformers``' ``load_flax_weights_in_pytorch_model`` (nothing is
downloaded).  Tolerances: the adapter's logits against JAX's within 1e-5; a
``DOWNPOUR`` run's losses within ``rtol=2e-4, atol=2e-5`` (the engine
tests' bound); the converted parameters equal ``params_from_flax`` of
JAX's ``gpt2_to_staged`` output bit for bit (the conversion is a pure
re-layout); converted logits and greedy decode against HF torch's own
within 1e-5.

Four gloo ranks are spawned **once** for the module (``ranks``): each runs
this file as a script (torch, ``transformers``' PyTorch GPT-2 and the port
only) and runs the cases that need a grid — ``tp_shards=2, fsdp=True`` over
the HF model (grid 2 x 2), the converted model under ``pipeline_stages=2,
fsdp=True`` (2 x 2) with its pipelined decode, and the pp x sp twin (1 x 2
x 2) — while the JAX package runs the first two on four CPU devices in the
pytest process.
"""

import os
import sys
from pathlib import Path

os.environ.setdefault("USE_TF", "0")  # transformers' torch models alone

import numpy as np
import pytest
import torch

torch.set_num_threads(1)  # the suite runs under xdist: keep each worker small

ROOT = Path(__file__).resolve().parent.parent
WORLD = 4
TOL = dict(rtol=2e-4, atol=2e-5)
LOGITS_ATOL = 1e-5
ADAM = ("adam", {"learning_rate": 3e-3})
# tests/test_hf.py's adapter model, and tests/test_hf_staged.py's
SMALL = dict(vocab_size=23, n_positions=16, n_embd=32, n_layer=1, n_head=2,
             resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)
STAGED = dict(vocab_size=64, n_positions=32, n_embd=32, n_layer=4, n_head=2,
              embd_pdrop=0.0, attn_pdrop=0.0, resid_pdrop=0.0)


# ------------------------------------------------------- shared with the ranks

def lm_corpus(n=256, seq=8, vocab=23, seed=0):
    """tests/test_hf.py's next-token corpus."""
    rng = np.random.default_rng(seed)
    start = rng.integers(0, vocab, size=(n, 1))
    x = ((start + np.arange(seq)) % vocab).astype(np.int32)
    return x, ((x + 1) % vocab).astype(np.int32)


def staged_corpus(seed, n=64, seq=8, vocab=64):
    x = np.random.default_rng(seed).integers(0, vocab, size=(n, seq)).astype(np.int32)
    return x, x


def torch_gpt2(config: dict, state=None):
    """A torch ``GPT2LMHeadModel`` of ``config``, with ``state`` (a state
    dict as numpy arrays) loaded when given."""
    import transformers

    model = transformers.GPT2LMHeadModel(transformers.GPT2Config(**config))
    if state is not None:
        model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in state.items()},
                              strict=False)
    return model.eval()


def _load_state(workdir, name):
    with np.load(os.path.join(workdir, f"{name}.npz")) as got:
        return {k: got[k] for k in got.files}


def _tp_fsdp_case(workdir):
    """tests/test_hf.py's TP + fsdp run over the (workers, model) grid:
    its history, and this rank's stored center elements."""
    import distkeras_tpu_torch as tdk

    model = torch_gpt2(SMALL, _load_state(workdir, "small"))
    x, y = lm_corpus(n=128)
    class Kept(tdk.DOWNPOUR):  # keeps the engine and state of its fit
        def _fit(self, *args, **kwargs):
            self.fit_result = super()._fit(*args, **kwargs)
            return self.fit_result

    t = Kept(model, loss="token_crossentropy", worker_optimizer=ADAM, num_workers=2,
             batch_size=16, num_epoch=2, communication_window=2, tp_shards=2, fsdp=True,
             metrics=(), device="cpu")
    t.train(tdk.from_numpy(x, y))
    engine, state, _ = t.fit_result
    resident = sum(v.numel() for v in state.center_params.values())
    return {"loss": np.asarray(t.get_history()["loss"]), "resident": np.asarray(resident),
            "engine": np.asarray(type(engine).__name__)}


def _pipeline_fsdp_case(workdir):
    """tests/test_hf_staged.py's converted model under pipeline x fsdp, its
    trained embedding, and the trained model's greedy decode pipelined over
    the stage ranks against its sequential decode."""
    import distkeras_tpu_torch as tdk
    from distkeras_tpu_torch.models import gpt2_to_staged, greedy_generate

    staged = gpt2_to_staged(torch_gpt2(STAGED, _load_state(workdir, "staged")), num_stages=2)
    x, y = staged_corpus(2)
    t = tdk.DOWNPOUR(staged, loss="token_crossentropy", metrics=(),
                     worker_optimizer=("adam", {"learning_rate": 1e-3}), num_workers=2,
                     batch_size=8, num_epoch=2, communication_window=2, pipeline_stages=2,
                     fsdp=True, device="cpu")
    trained = t.train(tdk.from_numpy(x, y))
    prompt = np.random.default_rng(1).integers(0, 64, size=(2, 5)).astype(np.int32)
    return {"loss": np.asarray(t.get_history()["loss"]),
            "tok": trained.params["embed"]["tok_embed.weight"].numpy(),
            "pipelined": greedy_generate(trained, prompt, 6, pipelined=True),
            "sequential": greedy_generate(trained, prompt, 6)}


def _pp_sp_twin_case(workdir):
    """tests/test_hf_staged.py's pp x sp fine-tune (grid 1 x 2 x 2): the
    returned twin drops the seq axis, keeps the checkpoint and serves."""
    import distkeras_tpu_torch as tdk
    from distkeras_tpu_torch.models import gpt2_to_staged

    staged = gpt2_to_staged(torch_gpt2(STAGED, _load_state(workdir, "staged")), num_stages=2,
                            seq_axis="seq")
    x, y = staged_corpus(4)
    t = tdk.DOWNPOUR(staged, loss="token_crossentropy", metrics=(),
                     worker_optimizer=("adam", {"learning_rate": 1e-3}), num_workers=1,
                     batch_size=8, num_epoch=2, communication_window=2, pipeline_stages=2,
                     seq_shards=2, device="cpu")
    trained = t.train(tdk.from_numpy(x, y))
    params, _ = trained.adapter.init(None, x[:1])
    return {"loss": np.asarray(t.get_history()["loss"]),
            "seq_axis": np.asarray(str(trained.adapter.seq_axis)),
            "tok": params["embed"]["tok_embed.weight"].numpy(),
            "predict": trained.predict(x[:8])}


def _rank_main(rank: int, world: int, init: str, workdir: str) -> None:
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=init, world_size=world, rank=rank)
    try:
        results = {"tp_fsdp": _tp_fsdp_case(workdir), "pp_fsdp": _pipeline_fsdp_case(workdir),
                   "pp_sp": _pp_sp_twin_case(workdir)}
    finally:
        dist.destroy_process_group()
    np.savez(os.path.join(workdir, f"rank_{rank}.npz"),
             **{f"{c}|{k}": v for c, r in results.items() for k, v in r.items()})


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
    sys.exit(0)


# ------------------------------------------------------------- test process

transformers = pytest.importorskip("transformers")

import jax  # noqa: E402

import distkeras_tpu as jdk  # noqa: E402
import distkeras_tpu_torch as tdk  # noqa: E402
from distkeras_tpu_torch.models import (  # noqa: E402
    HuggingFaceModel,
    gpt2_state_to_staged,
    gpt2_to_staged,
    greedy_generate,
    params_from_flax,
)
from distkeras_tpu_torch.models.adapter import as_adapter  # noqa: E402


def flax_gpt2(config: dict, seed=0, **kwargs):
    return transformers.FlaxGPT2LMHeadModel(transformers.GPT2Config(**config), seed=seed,
                                            **kwargs)


def carried(config: dict, flax_model):
    """The torch ``GPT2LMHeadModel`` with the Flax model's weights."""
    from transformers.modeling_flax_pytorch_utils import load_flax_weights_in_pytorch_model

    model = transformers.GPT2LMHeadModel(transformers.GPT2Config(**config))
    return load_flax_weights_in_pytorch_model(model, flax_model.params).eval()


def numpy_state(model):
    return {k: v.detach().numpy() for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def small():
    fx = flax_gpt2(SMALL, input_shape=(1, 8))
    return fx, carried(SMALL, fx)


@pytest.fixture(scope="module")
def staged_models():
    fx = flax_gpt2(STAGED)
    return fx, carried(STAGED, fx)


def _jax_tp_fsdp(model, epochs=2):
    """The ranks' ``tp_shards=2, fsdp=True`` trainer run as JAX's
    ``GSPMDEngine`` on four CPU devices (the 2 x 2 grid the ranks form):
    per-epoch mean losses, and the center elements device 0 holds."""
    from distkeras_tpu.algorithms import Downpour
    from distkeras_tpu.data import epoch_arrays
    from distkeras_tpu.models import HuggingFaceModel as JaxHF
    from distkeras_tpu.parallel.gspmd import GSPMDEngine

    engine = GSPMDEngine(JaxHF(model), "token_crossentropy", ADAM, Downpour(2), num_workers=2,
                         tp_shards=2, fsdp=True, metrics=(), devices=jax.devices()[:4])
    x, y = lm_corpus(n=128)
    state = engine.init_state(jax.random.PRNGKey(0), x[:16])
    xs, ys = engine.shard_batches(*epoch_arrays(x, y, 2, 16, 2))
    losses = []
    for _ in range(epochs):
        state, stats = engine.run_epoch(state, xs, ys)
        losses.append(float(np.mean(np.asarray(stats["loss"]))))
    resident = sum(leaf.addressable_shards[0].data.size
                   for leaf in jax.tree_util.tree_leaves(state.center_params))
    return np.asarray(losses), resident


def _jax_pipeline(model, epochs=2):
    """The ranks' pipeline trainer run as JAX's ``PipelineEngine`` on four
    CPU devices (the trainer would take all eight, and two workers need a
    2 x 2 grid): the same epochs of the unshuffled corpus, per-epoch mean
    losses."""
    from distkeras_tpu.algorithms import Downpour
    from distkeras_tpu.data import epoch_arrays
    from distkeras_tpu.parallel import PipelineEngine

    engine = PipelineEngine(model, "token_crossentropy", ("adam", {"learning_rate": 1e-3}),
                            Downpour(2), num_workers=2, metrics=(), fsdp=True,
                            devices=jax.devices()[:4])
    x, y = staged_corpus(2)
    state = engine.init_state(jax.random.PRNGKey(0), x[:8])
    xs, ys = engine.shard_batches(*epoch_arrays(x, y, 2, 8, 2))
    losses = []
    for _ in range(epochs):
        state, stats = engine.run_epoch(state, xs, ys)
        losses.append(float(np.mean(np.asarray(stats["loss"]))))
    return np.asarray(losses)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, small, staged_models):
    """``(every rank's results, JAX's runs)``: the torch models' weights are
    written for the ranks, which start; the JAX trainers run meanwhile on
    four CPU devices, in the grids the ranks form."""
    from test_torch_ring import start_ranks, wait_ranks

    workdir = str(tmp_path_factory.mktemp("hf"))
    np.savez(os.path.join(workdir, "small.npz"), **numpy_state(small[1]))
    np.savez(os.path.join(workdir, "staged.npz"), **numpy_state(staged_models[1]))
    procs = start_ranks(__file__, WORLD, workdir)
    jax_runs = {}
    try:
        from distkeras_tpu.models import gpt2_to_staged as jax_gpt2_to_staged

        jax_runs["tp_fsdp"], jax_runs["tp_fsdp_resident"] = _jax_tp_fsdp(small[0])
        jax_runs["pp_fsdp"] = _jax_pipeline(jax_gpt2_to_staged(staged_models[0], num_stages=2))
    finally:
        wait_ranks(procs, workdir)
    got = []
    for r in range(WORLD):
        with np.load(os.path.join(workdir, f"rank_{r}.npz")) as npz:
            results = {}
            for key in npz.files:
                case, _, name = key.partition("|")
                results.setdefault(case, {})[name] = npz[key]
        got.append(results)
    return got, jax_runs


# ------------------------------------------------------------- the adapter

def test_as_adapter_detects_hf_and_lm_head(small):
    a = as_adapter(small[1])
    assert isinstance(a, HuggingFaceModel)
    assert a.per_token_labels  # LMHeadModel => per-token targets
    assert a.outputs_logits


def test_hf_logits_match_jax(small):
    from distkeras_tpu.models import HuggingFaceModel as JaxHF

    tokens = np.random.default_rng(0).integers(0, 23, size=(3, 8)).astype(np.int32)
    jax_adapter = JaxHF(small[0])
    jp, _ = jax_adapter.init(jax.random.PRNGKey(0), tokens[:1])
    want, _ = jax_adapter.apply(jp, {}, tokens)
    adapter = HuggingFaceModel(small[1])
    params, state = adapter.init(None, tokens[:1])
    got, _ = adapter.apply(params, state, torch.from_numpy(tokens).long())
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=LOGITS_ATOL, rtol=0)


def test_hf_gpt2_downpour_matches_jax(small):
    """tests/test_hf.py's DOWNPOUR fine-tune (4 workers, Adam, window 2):
    the port's history against JAX's from the same checkpoint."""
    x, y = lm_corpus()
    kwargs = dict(loss="token_crossentropy", metrics=("token_accuracy",),
                  worker_optimizer=ADAM, num_workers=4, batch_size=16, num_epoch=2,
                  communication_window=2)
    want = jdk.DOWNPOUR(small[0], **kwargs)
    want.train(jdk.from_numpy(x, y))
    got = tdk.DOWNPOUR(small[1], device="cpu", **kwargs)
    got.train(tdk.from_numpy(x, y))
    for key in ("loss", "token_accuracy"):
        np.testing.assert_allclose(got.get_history()[key], want.get_history()[key], **TOL)


def test_hf_gpt2_finetunes_under_downpour(small):
    """The next-token corpus trains to high token accuracy through the
    standard DOWNPOUR flow, the checkpoint as the initial center."""
    x, y = lm_corpus()
    t = tdk.DOWNPOUR(carried(SMALL, small[0]), loss="token_crossentropy",
                     metrics=("token_accuracy",), worker_optimizer=ADAM, num_workers=4,
                     batch_size=16, num_epoch=10, communication_window=2, device="cpu")
    t.train(tdk.from_numpy(x, y))
    h = t.get_history()
    assert h["loss"][-1] < h["loss"][0] * 0.5
    assert h["token_accuracy"][-1] > 0.9


def test_hf_adapter_rejects_flax_models():
    """The mirror of JAX's refusal of torch models (ROADMAP C17)."""
    class FakeFlaxThing:
        pass

    FakeFlaxThing.__module__ = "transformers.models.gpt2.modeling_flax_gpt2"
    with pytest.raises(TypeError, match="PyTorch"):
        as_adapter(FakeFlaxThing())


def test_hf_return_dict_false_and_metric_aliases():
    """return_dict=False configs return tuples, and the 'acc' alias
    canonicalises to token accuracy for per-token models."""
    config = dict(SMALL, return_dict=False)
    model = carried(config, flax_gpt2(config, input_shape=(1, 8)))
    x, y = lm_corpus(n=128)
    t = tdk.DOWNPOUR(model, loss="token_crossentropy", metrics=("acc",), worker_optimizer=ADAM,
                     num_workers=4, batch_size=16, num_epoch=2, communication_window=2,
                     device="cpu")
    t.train(tdk.from_numpy(x, y))
    h = t.get_history()
    assert "token_accuracy" in h and np.isfinite(h["loss"]).all()


def test_hf_params_adopted_as_center(small):
    """init adopts the checkpoint's parameters (the tied head once, under
    the embedding), not fresh draws; the state is empty."""
    model = small[1]
    params, state = HuggingFaceModel(model).init(torch.Generator().manual_seed(0), None)
    src = dict(model.named_parameters())
    assert sorted(params) == sorted(src) and "lm_head.weight" not in params
    for name, value in params.items():
        assert torch.equal(value, src[name].detach()) and value is not src[name]
    assert state == {}


def test_hf_tied_head_follows_the_embedding(small):
    """A training step moves the tied head with the embedding: zeroing
    ``transformer.wte.weight`` zeroes the logits (functional_call ties)."""
    adapter = HuggingFaceModel(small[1])
    params, _ = adapter.init(None, None)
    params["transformer.wte.weight"] = torch.zeros_like(params["transformer.wte.weight"])
    logits, _ = adapter.apply(params, {}, torch.zeros((1, 4), dtype=torch.long))
    assert float(logits.abs().max()) == 0.0


def test_hf_dropout_draws_from_the_worker_generator():
    """The choice pinned: a training call draws its dropout masks from the
    worker's generator (the same state gives the same masks), advances it,
    and leaves the process's default generator where it was."""
    config = dict(SMALL, resid_pdrop=0.5, embd_pdrop=0.5, attn_pdrop=0.5)
    adapter = HuggingFaceModel(transformers.GPT2LMHeadModel(transformers.GPT2Config(**config)))
    params, _ = adapter.init(None, None)
    tokens = torch.arange(8).reshape(1, 8) % 23
    g = torch.Generator().manual_seed(5)
    start = g.get_state()
    default = torch.default_generator.get_state()
    a = adapter.apply(params, {}, tokens, training=True, generator=g)[0]
    advanced = g.get_state()
    assert not torch.equal(advanced, start)
    assert torch.equal(torch.default_generator.get_state(), default)
    g.set_state(start)
    b = adapter.apply(params, {}, tokens, training=True, generator=g)[0]
    c = adapter.apply(params, {}, tokens, training=True, generator=g)[0]
    assert torch.equal(a, b) and not torch.equal(b, c)
    # eval: no dropout, and the generator untouched
    e1 = adapter.apply(params, {}, tokens, training=False)[0]
    e2 = adapter.apply(params, {}, tokens, training=False, generator=g)[0]
    assert torch.equal(e1, e2) and not adapter.model.training


# ------------------------------------------------------------ gpt2_to_staged

def test_converted_params_equal_jax_conversion(staged_models):
    """The port's conversion is JAX's re-layout, bit for bit: its leaves
    equal ``params_from_flax`` of JAX's ``gpt2_to_staged`` output; the
    state-dict route equals the model route."""
    from distkeras_tpu.models import gpt2_to_staged as jax_gpt2_to_staged

    fx, pt = staged_models
    staged = gpt2_to_staged(pt, num_stages=2)
    params, _ = staged.init(None, None)
    jstaged = jax_gpt2_to_staged(fx, num_stages=2)
    want = params_from_flax(staged, jstaged.init(jax.random.PRNGKey(0), None)[0])
    routed, _ = gpt2_state_to_staged(pt.config.to_dict(), pt.state_dict(), 2).init(None, None)
    assert (staged.ln_eps, staged.max_len, staged.blocks_per_stage) == (1e-5, 32, 2)
    for part in ("embed", "blocks", "head"):
        assert sorted(params[part]) == sorted(want[part])
        for name, value in params[part].items():
            assert torch.equal(value, want[part][name]), (part, name)
            assert torch.equal(value, routed[part][name]), (part, name)


def test_converted_logits_match_hf(staged_models):
    _, pt = staged_models
    staged = gpt2_to_staged(pt, num_stages=2)
    params, _ = staged.init(None, None)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, 64, size=(3, 16))).long()
    ours, _ = staged.apply(params, {}, tokens)
    with torch.no_grad():
        theirs = pt(tokens).logits
    np.testing.assert_allclose(ours.detach().numpy(), theirs.numpy(), atol=LOGITS_ATOL, rtol=0)


def test_converted_decode_matches_hf_greedy(staged_models):
    """KV-cached greedy decode emits the tokens HF's own full-context argmax
    chooses (the pipelined decode runs on the ranks)."""
    _, pt = staged_models
    staged = gpt2_to_staged(pt, num_stages=2)
    params, _ = staged.init(None, None)
    prompt = np.random.default_rng(1).integers(0, 64, size=(2, 5)).astype(np.int32)
    ref = torch.from_numpy(prompt).long()
    with torch.no_grad():
        for _ in range(6):
            nxt = pt(ref).logits[:, -1].argmax(-1)
            ref = torch.cat([ref, nxt[:, None]], dim=1)
    trained = tdk.models.TrainedModel(staged, params, device="cpu")
    np.testing.assert_array_equal(greedy_generate(trained, prompt, 6), ref.numpy())


def test_untied_checkpoint_uses_its_own_head():
    config = dict(vocab_size=48, n_positions=16, n_embd=16, n_layer=2, n_head=2,
                  tie_word_embeddings=False)
    pt = carried(config, flax_gpt2(config, seed=3))
    staged = gpt2_to_staged(pt, num_stages=2)
    params, _ = staged.init(None, None)
    tokens = torch.arange(8).reshape(2, 4)
    ours, _ = staged.apply(params, {}, tokens)
    with torch.no_grad():
        theirs = pt(tokens).logits
    np.testing.assert_allclose(ours.detach().numpy(), theirs.numpy(), atol=LOGITS_ATOL, rtol=0)
    # and it genuinely differs from the tied mapping
    assert not torch.allclose(params["head"]["out.weight"], params["embed"]["tok_embed.weight"])


def test_conversion_rejects_mismatched_architectures(staged_models):
    with pytest.raises(ValueError, match="stages"):
        gpt2_to_staged(staged_models[1], num_stages=3)
    relu = transformers.GPT2LMHeadModel(transformers.GPT2Config(
        vocab_size=32, n_embd=16, n_layer=2, n_head=2, activation_function="relu"))
    with pytest.raises(ValueError, match="GELU"):
        gpt2_to_staged(relu, num_stages=2)
    with pytest.raises(ValueError, match="converts GPT2LMHeadModel, got FlaxGPT2LMHeadModel"):
        gpt2_to_staged(staged_models[0], num_stages=2)


# ------------------------------------------------------- the spawned grids

def test_hf_gpt2_composes_with_tp_and_fsdp(ranks):
    """The HF model trains under the GSPMD engine, its leaves split over the
    (workers, model) grid and the center ZeRO-sharded, unmodified: the
    history against JAX's on the same grid, and each rank's stored center
    elements against the elements JAX's device 0 holds."""
    got, jax_runs = ranks
    losses = [r["tp_fsdp"]["loss"] for r in got]
    for loss in losses[1:]:
        np.testing.assert_array_equal(loss, losses[0])
    np.testing.assert_allclose(losses[0], jax_runs["tp_fsdp"], **TOL)
    assert np.isfinite(losses[0]).all() and losses[0][-1] < losses[0][0]
    resident = [int(r["tp_fsdp"]["resident"]) for r in got]
    assert all(str(r["tp_fsdp"]["engine"]) == "GSPMDEngine" for r in got)
    assert resident == [jax_runs["tp_fsdp_resident"]] * WORLD


def test_converted_model_trains_on_pipeline_fsdp(ranks):
    got, jax_runs = ranks
    run = got[0]["pp_fsdp"]
    np.testing.assert_allclose(run["loss"], jax_runs["pp_fsdp"], **TOL)
    assert np.isfinite(run["loss"]).all() and run["loss"][-1] < run["loss"][0]
    assert run["tok"].shape == (64, 32) and np.isfinite(run["tok"]).all()
    for r in got:
        np.testing.assert_array_equal(r["pp_fsdp"]["pipelined"], r["pp_fsdp"]["sequential"])


def test_pretrained_pp_sp_twin_keeps_checkpoint(ranks):
    got, _ = ranks
    run = got[0]["pp_sp"]
    assert np.isfinite(run["loss"]).all() and run["loss"][-1] < run["loss"][0]
    assert str(run["seq_axis"]) == "None"
    assert run["tok"].shape == (64, 32) and np.isfinite(run["tok"]).all()
    assert np.isfinite(run["predict"]).all()
