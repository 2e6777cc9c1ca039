"""Port parity: ``TransformerLM`` (causal) and ``TransformerClassifier``
(non-causal) of ``distkeras_tpu_torch`` against the JAX package's flax
models, with the flax parameters carried over by ``params_from_flax``.

Every flax parameter is perturbed away from its initial value first, so
LayerNorm scales and biases are not 1 and 0 and a swapped tensor shows.
"""

import jax
import numpy as np
import pytest
import torch

from distkeras_tpu.models.transformer import TransformerClassifier as JaxClassifier
from distkeras_tpu.models.transformer import TransformerLM as JaxLM
from distkeras_tpu_torch.models import (
    TransformerClassifier,
    TransformerEncoderBlock,
    TransformerLM,
    params_from_flax,
)
from distkeras_tpu_torch.models import transformer as port_transformer
from distkeras_tpu_torch.ops import flash_attention
from distkeras_tpu_torch.parallel.ring import attention

torch.set_num_threads(1)  # the suite runs under xdist: keep each worker small

CFG = dict(vocab_size=64, dim=32, heads=2, num_layers=2, max_len=32)
SEQ = 24


def _tokens(seed=0, batch=3):
    return np.random.default_rng(seed).integers(0, CFG["vocab_size"], (batch, SEQ), dtype=np.int32)


def _flax_params(module, seed):
    variables = module.init(jax.random.key(seed), np.zeros((1, SEQ), np.int32))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * rng.standard_normal(a.shape).astype(np.float32),
        variables["params"],
    )


def _pair(kind):
    if kind == "lm":
        return JaxLM(**CFG), TransformerLM(**CFG)
    return JaxClassifier(num_classes=3, **CFG), TransformerClassifier(num_classes=3, **CFG)


@pytest.fixture(scope="module")
def jax_reference():
    """Per model kind: the JAX model, its perturbed params and its logits on
    ``_tokens()`` (computed once for the module's forward tests)."""
    cache = {}

    def get(kind):
        if kind not in cache:
            jax_model, _ = _pair(kind)
            flax_params = _flax_params(jax_model, seed=1)
            out = np.asarray(jax_model.apply({"params": flax_params}, _tokens()))
            cache[kind] = (flax_params, out)
        return cache[kind]

    return get


@pytest.mark.parametrize("route", ["default", "flash_plain"])
@pytest.mark.parametrize("kind", ["lm", "classifier"])
def test_forward_matches_jax(kind, route, jax_reference, monkeypatch):
    _, port_model = _pair(kind)
    flax_params, ref = jax_reference(kind)
    params_from_flax(port_model, flax_params)
    if route == "flash_plain":
        # every block's attention through the kernel's plain version
        monkeypatch.setattr(port_transformer, "attention",
                            lambda *a, **kw: attention(*a, use_flash=True, **kw))
    tokens = _tokens()
    flash_attention.launches = 0
    with torch.no_grad():
        out = port_model(torch.from_numpy(tokens))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)
    assert flash_attention.launches == 0  # CPU tensors never launch the kernel


def test_params_from_flax_layouts():
    jax_model, port_model = _pair("lm")
    tree = _flax_params(jax_model, seed=2)
    params = params_from_flax(port_model, tree)
    blk = tree["block_0"]
    attn = blk["_SelfAttention_0"]
    np.testing.assert_array_equal(params["tok_embed.weight"], tree["tok_embed"]["embedding"])
    np.testing.assert_array_equal(params["pos_embed.weight"], tree["pos_embed"]["embedding"])
    # qkv: DenseGeneral [D, 3, H, hd] -> one Linear whose output splits [3, H, hd]
    x = np.random.default_rng(0).standard_normal((5, CFG["dim"])).astype(np.float32)
    ref_qkv = np.einsum("nd,dthk->nthk", x, attn["qkv"]["kernel"]) + attn["qkv"]["bias"]
    with torch.no_grad():
        qkv = port_model.blocks[0].attn.qkv(torch.from_numpy(x)).view(5, 3, 2, 16)
    np.testing.assert_allclose(qkv.numpy(), ref_qkv, atol=1e-5)
    # proj: [H, hd, D] contracted over (H, hd)
    y = np.random.default_rng(1).standard_normal((5, 2, 16)).astype(np.float32)
    ref_proj = np.einsum("nhk,hkd->nd", y, attn["proj"]["kernel"]) + attn["proj"]["bias"]
    with torch.no_grad():
        proj = port_model.blocks[0].attn.proj(torch.from_numpy(y).reshape(5, 32))
    np.testing.assert_allclose(proj.numpy(), ref_proj, atol=1e-5)
    # Dense kernels are [in, out]; Linear weights [out, in]
    np.testing.assert_array_equal(params["blocks.0.fc1.weight"], blk["Dense_0"]["kernel"].T)
    np.testing.assert_array_equal(params["blocks.1.fc2.weight"],
                                  tree["block_1"]["Dense_1"]["kernel"].T)
    # block-local LayerNorms vs the top-level final LayerNorm_0
    np.testing.assert_array_equal(params["blocks.0.ln1.weight"], blk["LayerNorm_0"]["scale"])
    np.testing.assert_array_equal(params["blocks.0.ln2.bias"], blk["LayerNorm_1"]["bias"])
    np.testing.assert_array_equal(params["final_ln.weight"], tree["LayerNorm_0"]["scale"])
    np.testing.assert_array_equal(params["lm_head.bias"], tree["lm_head"]["bias"])


def test_params_from_flax_classifier_head():
    jax_model, port_model = _pair("classifier")
    tree = _flax_params(jax_model, seed=3)
    params = params_from_flax(port_model, {"params": tree})  # whole variables dict
    np.testing.assert_array_equal(params["head.weight"], tree["head"]["kernel"].T)


def test_block_matches_jax():
    from distkeras_tpu.models.transformer import TransformerEncoderBlock as JaxBlock

    jax_block = JaxBlock(dim=32, heads=2, causal=True)
    x = np.random.default_rng(4).standard_normal((2, SEQ, 32)).astype(np.float32)
    tree = jax.tree_util.tree_map(np.asarray, jax_block.init(jax.random.key(4), x)["params"])
    block = TransformerEncoderBlock(32, 2, causal=True)
    attn = tree["_SelfAttention_0"]
    sd = {
        "ln1.weight": tree["LayerNorm_0"]["scale"], "ln1.bias": tree["LayerNorm_0"]["bias"],
        "ln2.weight": tree["LayerNorm_1"]["scale"], "ln2.bias": tree["LayerNorm_1"]["bias"],
        "attn.qkv.weight": attn["qkv"]["kernel"].reshape(32, -1).T,
        "attn.qkv.bias": attn["qkv"]["bias"].reshape(-1),
        "attn.proj.weight": attn["proj"]["kernel"].reshape(-1, 32).T,
        "attn.proj.bias": attn["proj"]["bias"],
        "fc1.weight": tree["Dense_0"]["kernel"].T, "fc1.bias": tree["Dense_0"]["bias"],
        "fc2.weight": tree["Dense_1"]["kernel"].T, "fc2.bias": tree["Dense_1"]["bias"],
    }
    block.load_state_dict({k: torch.tensor(v) for k, v in sd.items()})
    ref = np.asarray(jax_block.apply({"params": tree}, x))
    with torch.no_grad():
        out = block(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)


def test_decode_matches_jax(jax_reference):
    # KV-cache decode (ported with the serving slice): a prefill chunk and
    # two single-token steps, each against the flax model's decode=True
    import jax.numpy as jnp

    flax_params, _ = jax_reference("lm")
    jax_model, model = _pair("lm")
    params = params_from_flax(model, flax_params)
    tokens = _tokens()
    cache = model.init_cache(tokens.shape[0])
    variables = {"params": flax_params}
    for a, b in ((0, 20), (20, 21), (21, 22)):
        ref, mutated = jax_model.apply(variables, jnp.asarray(tokens[:, a:b]), decode=True,
                                       mutable=["cache"])
        variables = {"params": flax_params, "cache": mutated["cache"]}
        with torch.no_grad():
            out = torch.func.functional_call(model, params, (torch.from_numpy(tokens[:, a:b]),),
                                             {"decode": True, "cache": cache})
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
    assert cache.index == 22


@pytest.mark.parametrize("what", ["seq_axis_lm", "seq_axis_classifier", "packed"])
def test_unported_options_raise(what):
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A item"):
        if what == "seq_axis_lm":
            TransformerLM(**CFG, seq_axis="seq")
        elif what == "seq_axis_classifier":
            TransformerClassifier(**CFG, seq_axis="seq")
        else:
            TransformerLM(**CFG, packed=True)


@pytest.mark.parametrize("bad", ["negative", "below_minus_vocab", "past_vocab", "past_max_len"])
def test_out_of_range_inputs_match_jax(bad, jax_reference):
    # flax's nn.Embed gathers with jnp.take's "fill" mode: ids in [-vocab, 0)
    # wrap, ids outside [-vocab, vocab) and positions past max_len give NaN rows
    vocab = CFG["vocab_size"]
    tokens = _tokens()
    if bad == "negative":
        tokens[0, 0], tokens[2, 5] = -1, -vocab
    elif bad == "below_minus_vocab":
        tokens[1, 4] = -vocab - 1
    elif bad == "past_vocab":
        tokens[1, 3] = vocab
    else:
        tokens = np.random.default_rng(3).integers(0, vocab, (2, CFG["max_len"] + 1),
                                                   dtype=np.int32)
    for kind in ("lm", "classifier"):
        jax_model, port_model = _pair(kind)
        flax_params, _ = jax_reference(kind)
        params_from_flax(port_model, flax_params)
        ref = np.asarray(jax_model.apply({"params": flax_params}, tokens))
        with torch.no_grad():
            out = port_model(torch.from_numpy(tokens)).numpy()
        assert out.shape == ref.shape
        np.testing.assert_array_equal(np.isnan(out), np.isnan(ref))
        if bad == "negative":
            assert np.isfinite(out).all()
        else:
            assert np.isnan(out).any()
        finite = np.isfinite(ref)
        np.testing.assert_allclose(out[finite], ref[finite], atol=1e-5, rtol=1e-5)


def test_reset_parameters_follows_flax_initialisers():
    a = TransformerLM(**CFG, generator=torch.Generator().manual_seed(7))
    b = TransformerLM(**CFG, generator=torch.Generator().manual_seed(7))
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), name
    big = TransformerClassifier(vocab_size=4096, dim=256, heads=4, num_layers=1, max_len=8,
                                generator=torch.Generator().manual_seed(0))
    # embeddings: normal, std 1/sqrt(dim); dense: lecun normal, zero bias
    assert abs(big.tok_embed.weight.std().item() - 256 ** -0.5) < 2e-3
    assert abs(big.blocks[0].fc1.weight.std().item() - 256 ** -0.5) < 2e-3
    assert big.blocks[0].fc1.weight.abs().max().item() <= 2 * 256 ** -0.5 / 0.8796 + 1e-6
    assert torch.count_nonzero(big.blocks[0].fc1.bias) == 0
    assert torch.equal(big.final_ln.weight, torch.ones(256))


def test_decode_spec_matches_jax_layout():
    jax_model, port_model = _pair("lm")
    tree = _flax_params(jax_model, seed=5)
    params = params_from_flax(port_model, tree)
    spec = port_model.decode_spec(params)
    ref = jax_model.decode_spec(tree)
    assert spec["config"] == ref["config"]
    np.testing.assert_array_equal(spec["embed"]["tok"], ref["embed"]["tok"])
    np.testing.assert_array_equal(spec["final_ln"]["weight"], ref["final_ln"]["scale"])
    np.testing.assert_array_equal(spec["head"]["bias"], ref["head"]["bias"])
    assert len(spec["blocks"]) == CFG["num_layers"]
    assert set(spec["blocks"][1]) == {
        f"{m}.{p}" for m in ("ln1", "ln2", "fc1", "fc2", "attn.qkv", "attn.proj")
        for p in ("weight", "bias")
    }
