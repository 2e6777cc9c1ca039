"""Port parity: the update rules of ``distkeras_tpu_torch.algorithms``
(``Sequential``, ``OneShotAverage``, ``Downpour``, ``Aeasgd``, ``Eamsgd``,
``Adag``, ``DynSGD``, ``AdaptiveDynSGD``) against the JAX package's, in the
closed-form cases with ``psum`` = identity, and the stacked-worker commit
(``psum`` = a sum over the leading worker dim) against the JAX rule under
``vmap`` on the same inputs.  Tolerance: 1e-6 relative (f32 adds, products
and selects); counters and clocks exact."""

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


RULES = ["Downpour", "Sequential", "OneShotAverage", "Aeasgd", "Eamsgd", "Adag", "DynSGD",
         "AdaptiveDynSGD"]


def _commit(lib, rule_name, mask, local_v, center_v, num_updates=0, steps=1):
    mod = jax_algorithms if lib == "jax" else algorithms
    rule = getattr(mod, rule_name)()
    center, local = _params(center_v, lib), _params(local_v, lib)
    ctx = (mod.make_ctx(mask=mask, steps_in_window=steps) if lib == "jax"
           else make_ctx(mask=mask, steps_in_window=steps))
    cst = dict(rule.init_center_state())
    cst["num_updates"] = cst["num_updates"] + num_updates
    local_state = rule.init_local_state(center)
    return rule.commit(ctx, local, center, local_state, cst)


def _assert_trees(got, want, rtol=1e-6):
    """Port and JAX trees of one structure hold the same values."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys()
        for k in want:
            _assert_trees(got[k], want[k], rtol)
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_trees(g, w, rtol)
    elif np.issubdtype(np.asarray(want).dtype, np.integer):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol)


@pytest.mark.parametrize("rule_name", RULES)
@pytest.mark.parametrize("mask", [True, False])
def test_closed_form_commit_matches_jax(rule_name, mask):
    # 3 updates since the (zero) clock: DynSGD damps by 1/4; ADAG divides by 3
    got = _commit("torch", rule_name, mask, 1.5, 1.0, num_updates=3, steps=3)
    want = _commit("jax", rule_name, mask, 1.5, 1.0, num_updates=3, steps=3)
    for field in ("local_params", "center_params", "local_state", "center_state"):
        _assert_trees(getattr(got, field), getattr(want, field))


def _stacked_inputs(rule, lib, num_updates, bound):
    """Two workers drifted apart from their anchors (the center at their
    last pulls), with clocks 3 and 1 against ``num_updates``: staleness
    0 and 2 for DynSGD.  ``bound`` sets AdaptiveDynSGD's bound."""
    rng = np.random.default_rng(0)
    center = {"w": rng.standard_normal((4, 2)).astype(np.float32),
              "b": rng.standard_normal(2).astype(np.float32)}
    anchor = {k: v[None] + 0.05 * rng.standard_normal((2,) + v.shape).astype(np.float32)
              for k, v in center.items()}
    local = {k: v + 0.1 * rng.standard_normal(v.shape).astype(np.float32)
             for k, v in anchor.items()}
    clock = np.array([3, 1], np.int32)
    if lib == "jax":
        as_lib = jnp.asarray
    else:
        as_lib = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    structure = rule.init_local_state(center)
    local_state = ({k: v for k, v in {"anchor": anchor, "clock": clock}.items() if k in structure}
                   if isinstance(structure, dict) else ())
    center_state = dict(rule.init_center_state())
    center_state["num_updates"] = as_lib(np.int32(num_updates))
    if "staleness_bound" in center_state:
        center_state["staleness_bound"] = as_lib(np.float32(bound))
    to = lambda tree: jax.tree_util.tree_map(as_lib, tree)
    return to(local), to(center), to(local_state), center_state


@pytest.mark.parametrize("rule_name, bound",
                         [(r, float("inf")) for r in RULES[3:]] + [("AdaptiveDynSGD", 1.0)],
                         ids=RULES[3:] + ["AdaptiveDynSGD-bound1"])
@pytest.mark.parametrize("mask", [(True, True), (True, False), (False, True)],
                         ids=["both", "first", "second"])
def test_stacked_commit_matches_jax_vmap(rule_name, bound, mask):
    # two workers stacked on the port's leading dim, against the JAX rule
    # under vmap with a psum over the axis; per-worker steps_in_window as
    # the staleness simulation hands them
    steps = np.array([2.0, 3.0], np.float32)
    rule = getattr(algorithms, rule_name)()
    local, center, local_state, center_state = _stacked_inputs(rule, "torch", 3, bound)
    ctx = stacked_ctx(2, torch.from_numpy(steps), "cpu", torch.tensor(mask))
    got = rule.commit(ctx, local, center, local_state, center_state)

    jrule = getattr(jax_algorithms, rule_name)()
    jlocal, jcenter, jlocal_state, jcenter_state = _stacked_inputs(jrule, "jax", 3, bound)

    def one(local_w, state_w, mask_w, steps_w):
        ctx = jax_algorithms.CommitCtx(
            psum=lambda t: jax.tree_util.tree_map(lambda x: lax.psum(x, "w"), t),
            mask=mask_w, steps_in_window=steps_w, num_workers=2)
        return jrule.commit(ctx, local_w, jcenter, state_w, jcenter_state)

    want = jax.vmap(one, axis_name="w")(jlocal, jlocal_state, jnp.asarray(mask),
                                        jnp.asarray(steps))
    first = lambda tree: jax.tree_util.tree_map(lambda x: x[0], tree)  # replicated
    _assert_trees(got.local_params, want.local_params)
    _assert_trees(got.local_state, want.local_state)
    _assert_trees(got.center_params, first(want.center_params))
    _assert_trees(got.center_state, first(want.center_state))
    if rule_name == "AdaptiveDynSGD" and bound == 1.0 and mask[1]:
        # the stale second worker (staleness 2) is dropped but still pulls
        assert int(got.center_state["num_updates"]) == 3 + int(mask[0])
        assert int(got.local_state["clock"][1]) == int(got.center_state["num_updates"])


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
    import dataclasses

    for name in RULES:
        got, want = getattr(algorithms, name)(), getattr(jax_algorithms, name)()
        assert dataclasses.asdict(got) == dataclasses.asdict(want), name
        assert set(got.init_center_state()) == set(want.init_center_state()), name
    assert algorithms.Aeasgd(rho=2.0, learning_rate=0.5).alpha == 1.0
