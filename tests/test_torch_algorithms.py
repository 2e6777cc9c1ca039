"""Port parity: the update rules of ``distkeras_tpu_torch.algorithms``
(``Sequential``, ``OneShotAverage``, ``Downpour``) against the JAX
package's, in the closed-form cases with ``psum`` = identity, and the
stacked-worker commit (``psum`` = a sum over the leading worker dim)
against the JAX rule under ``vmap`` on the same inputs.  Tolerance: 1e-6
relative (f32 adds and selects)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from distkeras_tpu import algorithms as jax_algorithms
from distkeras_tpu_torch import algorithms
from distkeras_tpu_torch.algorithms import make_ctx, stacked_ctx

torch.set_num_threads(1)  # the suite runs under xdist: keep each worker small


def _params(v, lib):
    w, b = np.float32(v), np.asarray([v * 2.0], np.float32)
    if lib == "jax":
        return {"w": jnp.asarray(w), "b": jnp.asarray(b)}
    return {"w": torch.tensor(w), "b": torch.from_numpy(b)}


def _commit(lib, rule_name, mask, local_v, center_v, num_updates=0):
    mod = jax_algorithms if lib == "jax" else algorithms
    rule = getattr(mod, rule_name)()
    center, local = _params(center_v, lib), _params(local_v, lib)
    ctx = mod.make_ctx(mask=mask) if lib == "jax" else make_ctx(mask=mask)
    cst = rule.init_center_state()
    cst = {"num_updates": cst["num_updates"] + num_updates}
    local_state = rule.init_local_state(center)
    return rule.commit(ctx, local, center, local_state, cst)


@pytest.mark.parametrize("rule_name", ["Downpour", "Sequential", "OneShotAverage"])
@pytest.mark.parametrize("mask", [True, False])
def test_closed_form_commit_matches_jax(rule_name, mask):
    got = _commit("torch", rule_name, mask, 1.5, 1.0, num_updates=3)
    want = _commit("jax", rule_name, mask, 1.5, 1.0, num_updates=3)
    for g, w in zip((got.local_params, got.center_params), (want.local_params, want.center_params)):
        for k in ("w", "b"):
            np.testing.assert_allclose(g[k].numpy(), np.asarray(w[k]), rtol=1e-6)
    assert int(got.center_state["num_updates"]) == int(want.center_state["num_updates"])
    if rule_name == "Downpour":
        np.testing.assert_allclose(got.local_state["anchor"]["w"].numpy(),
                                   np.asarray(want.local_state["anchor"]["w"]), rtol=1e-6)


def test_downpour_closed_form():
    res = _commit("torch", "Downpour", True, 1.5, 1.0)
    assert float(res.center_params["w"]) == 1.5  # center + (local - anchor)
    assert float(res.local_params["w"]) == 1.5  # pulled
    assert float(res.local_state["anchor"]["w"]) == 1.5
    assert int(res.center_state["num_updates"]) == 1


def test_stacked_downpour_matches_jax_vmap():
    # three workers that drifted apart from one anchor; the port stacks
    # them on a leading dim, JAX vmaps the rule with a psum over the axis
    rng = np.random.default_rng(0)
    center = {"w": rng.standard_normal((4, 2)).astype(np.float32),
              "b": rng.standard_normal(2).astype(np.float32)}
    local = {k: v[None] + 0.1 * rng.standard_normal((3,) + v.shape).astype(np.float32)
             for k, v in center.items()}

    rule = algorithms.Downpour(2)
    t_center = {k: torch.from_numpy(v) for k, v in center.items()}
    anchor = {k: v.expand(3, *v.shape).clone() for k, v in t_center.items()}
    res = rule.commit(stacked_ctx(3, 2.0, "cpu"), {k: torch.from_numpy(v) for k, v in local.items()},
                      t_center, {"anchor": anchor}, rule.init_center_state())

    jrule = jax_algorithms.Downpour(2)

    def one(local_w):
        ctx = jax_algorithms.CommitCtx(
            psum=lambda t: jax.tree_util.tree_map(lambda x: lax.psum(x, "w"), t),
            mask=jnp.asarray(True), steps_in_window=jnp.asarray(2.0), num_workers=3)
        return jrule.commit(ctx, local_w, center, jrule.init_local_state(center),
                            jrule.init_center_state())

    want = jax.vmap(one, axis_name="w")(local)
    for k in center:
        np.testing.assert_allclose(res.center_params[k].numpy(),
                                   np.asarray(want.center_params[k][0]), rtol=1e-6)
        np.testing.assert_allclose(res.local_params[k].numpy(),
                                   np.asarray(want.local_params[k]), rtol=1e-6)
        np.testing.assert_allclose(res.local_state["anchor"][k].numpy(),
                                   np.asarray(want.local_state["anchor"][k]), rtol=1e-6)
    assert int(res.center_state["num_updates"]) == int(want.center_state["num_updates"][0]) == 3


def test_stacked_oneshot_average():
    rule = algorithms.OneShotAverage()
    local = {"w": torch.tensor([1.0, 2.0, 3.0, 4.0])}
    res = rule.commit(stacked_ctx(4, 1.0, "cpu"), local, {"w": torch.zeros(())}, (),
                      rule.init_center_state())
    assert float(res.center_params["w"]) == 2.5
    assert int(res.center_state["num_updates"]) == 4


def test_rule_defaults_match_jax():
    for name in ("Downpour", "Sequential", "OneShotAverage"):
        got, want = getattr(algorithms, name)(), getattr(jax_algorithms, name)()
        assert (got.communication_window, got.pulls) == (want.communication_window, want.pulls)
