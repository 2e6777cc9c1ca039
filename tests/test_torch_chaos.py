"""The deterministic chaos harness in the port (``DISTKERAS_CHAOS``),
against tests/test_chaos.py.

* The spec parser is the JAX package's: the same specs parse to the same
  values, the same typos fail with the same errors, and the seeded draws
  (``tear_bytes``' split points, ``corrupt_ckpt``'s file, offset and bit)
  are the same for the same seed and spec.
* Off is stock: no site counts and the daemon's job table is a plain dict.
* The control plane's seeded faults (refused connects, dropped replies,
  torn frames) are absorbed by the client's retries and the daemon's
  idempotency keys: one job each.
* A seeded kill resumes bit for bit from the checkpoint, and the
  recovered run's parameters are the JAX package's within the trainer
  tolerance of tests/test_torch_trainers.py.
* JAX's "the lowered program is byte-identical" becomes: with every spec
  key armed and none firing, a checkpointed streaming epoch's history,
  parameters and flash-attention launch counts are bit for bit those with
  chaos off.
"""

import jax
import numpy as np
import pytest
import torch

import distkeras_tpu as jdk
import distkeras_tpu_torch as tdk
from distkeras_tpu import chaos as jax_chaos
from distkeras_tpu.models import FlaxModel
from distkeras_tpu.models import zoo as jax_zoo
from distkeras_tpu_torch import chaos
from distkeras_tpu_torch.job_deployment import Job, PunchcardServer
from distkeras_tpu_torch.models import TorchModel, TransformerLM, variables_from_flax, zoo

torch.set_num_threads(1)  # the suite runs under xdist: keep each worker small

PARAM_TOL = dict(rtol=2e-3, atol=2e-4)  # tests/test_torch_trainers.py's
MLP_KW = dict(features=(16,), num_classes=2)


@pytest.fixture(autouse=True)
def chaos_off():
    """Each test arms its own spec; leave both packages env-driven."""
    for c in (chaos, jax_chaos):
        c.configure("")
    yield
    for c in (chaos, jax_chaos):
        c.configure(None)


# ------------------------------------------------------------ spec parsing

def test_spec_parsing_roundtrip_as_jax():
    raw = "7:kill_block=5,refuse_connect=2,stall_secs=0.25"
    cfg = chaos.ChaosConfig.parse(raw)
    assert cfg.seed == 7 and cfg.get("kill_block") == 5
    assert cfg.get("refuse_connect") == 2 and cfg.get("stall_secs") == 0.25
    assert cfg.get("drop_reply") is None  # unarmed
    want = jax_chaos.ChaosConfig.parse(raw)
    assert (cfg.seed, cfg.params) == (want.seed, want.params)
    assert chaos._INT_KEYS == jax_chaos._INT_KEYS and chaos._FLOAT_KEYS == jax_chaos._FLOAT_KEYS


@pytest.mark.parametrize("raw, match", [("1:kill_epochs=3", "unknown chaos spec key"),
                                        ("kill_epoch=3", "<seed>:"),
                                        ("1:kill_epoch", "key=value")])
def test_spec_rejects_typos_loudly(raw, match):
    for c in (chaos, jax_chaos):
        with pytest.raises(ValueError, match=match):
            c.ChaosConfig.parse(raw)


def test_configure_and_counts():
    assert chaos.enabled() is False
    chaos.fault("connect")  # off: no-op, not even counted
    assert chaos.counts() == {}
    chaos.configure("3:refuse_connect=1")
    assert chaos.enabled() is True
    with pytest.raises(ConnectionRefusedError):
        chaos.fault("connect")
    chaos.fault("connect")  # budget of 1 spent
    assert chaos.counts()["connect"] == 2


def test_wrap_blocks_kills_at_seeded_block():
    chaos.configure("1:kill_block=1")
    got = []
    with pytest.raises(chaos.ChaosKilled):
        for item in chaos.wrap_blocks(iter([10, 20, 30])):
            got.append(item)
    assert got == [10]  # block 0 passed, block 1 killed
    # fire-once: the retry's iterator streams through
    assert list(chaos.wrap_blocks(iter([10, 20, 30]))) == [10, 20, 30]


@pytest.mark.parametrize("seed", [5, 9, 123])
def test_tear_bytes_is_seeded_and_jaxs(seed):
    def draws(c):
        c.configure(f"{seed}:tear_send=3")
        return [c.tear_bytes("send", n) for n in (100, 12, 100000, 100)]

    got = draws(chaos)
    assert all(1 <= g < n for g, n in zip(got[:3], (100, 12, 100000))) and got[3] is None
    assert got == draws(jax_chaos)
    assert got == draws(chaos)  # the same seed: the same split points


@pytest.mark.parametrize("key", ["torn_ckpt", "flip_ckpt"])
def test_corrupt_ckpt_damages_what_jax_damages(key, tmp_path):
    rng = np.random.default_rng(0)
    payload = {f"f{i}.npz": rng.bytes(int(n)) for i, n in enumerate((300, 17, 4096))}
    damaged = {}
    for name, c in (("port", chaos), ("jax", jax_chaos)):
        d = tmp_path / name
        d.mkdir()
        for f, data in payload.items():
            (d / f).write_bytes(data)
        c.configure(f"11:{key}=1")
        paths = [str(d / f) for f in payload]
        assert c.corrupt_ckpt(paths) is None  # publish 0: not armed
        what = c.corrupt_ckpt(paths)  # publish 1: fires once
        assert what is not None and c.corrupt_ckpt(paths) is None
        damaged[name] = ({f: (d / f).read_bytes() for f in payload}, what.replace(str(d), ""))
    assert damaged["port"] == damaged["jax"]
    assert damaged["port"][0] != payload  # one file changed


# ------------------------------------------------- zero-cost when disarmed

def test_off_path_is_stock():
    assert chaos.enabled() is False and chaos.spec() is None
    srv = PunchcardServer(port=0)
    assert type(srv.jobs) is dict  # no wrapping sneaks in via chaos
    for site in ("connect", "send", "recv", "rpc_reply", "epoch", "block", "ckpt_commit"):
        chaos.fault(site)
    assert chaos.tear_bytes("send", 10) is None and chaos.counts() == {}


LM = dict(vocab_size=23, dim=16, heads=2, num_layers=1, max_len=32)
#: every spec key armed at a count no run of the test reaches
SILENT = ("7:kill_epoch=99,kill_block=99,stall_block=99,refuse_connect=0,drop_reply=0,"
          "drop_recv=0,tear_send=0,delay_send_ms=0,kill_replica=99,stall_http=0,"
          "kill_commit=99,delay_commit_ms=0,kill_rotate=99,torn_ckpt=99,flip_ckpt=99,"
          "stall_secs=0.01")


def _lm_epochs(ckpt_dir):
    """Two checkpointed streaming epochs of a tiny LM: (history, params,
    the flash-attention kernels' launch counts)."""
    from distkeras_tpu_torch.ops import flash_attention, flash_attention_bwd_dkv, \
        flash_attention_bwd_dq

    rng = np.random.default_rng(0)
    x = ((rng.integers(0, 23, (16, 1)) + np.arange(16)) % 23).astype(np.int32)
    kernels = (flash_attention, flash_attention_bwd_dq, flash_attention_bwd_dkv)
    for k in kernels:
        k.launches = 0
    t = tdk.DOWNPOUR(TransformerLM(**LM, generator=torch.Generator().manual_seed(3)),
                     loss="token_crossentropy", metrics=("token_accuracy",), num_workers=2,
                     batch_size=2, communication_window=2, num_epoch=2, seed=3,
                     streaming=True, checkpoint_dir=ckpt_dir, device="cpu")
    trained = t.train(tdk.from_numpy(x, (x + 1) % 23), shuffle=True)
    return t.get_history(), trained.params, [k.launches for k in kernels]


def test_armed_but_silent_chaos_is_bitwise_the_off_run(tmp_path):
    """Chaos is host-side fault injection around dispatch: arming every key
    without one firing changes no value and no kernel launch."""
    history, params, launches = _lm_epochs(str(tmp_path / "off"))
    assert chaos.counts() == {}
    chaos.configure(SILENT)
    armed_history, armed_params, armed_launches = _lm_epochs(str(tmp_path / "armed"))
    counts = chaos.counts()
    assert counts["epoch"] == 2 and counts["block"] == 4  # two windows an epoch
    assert counts["ckpt_commit"] == counts["ckpt_publish"] == 2
    assert armed_launches == launches
    assert armed_history["loss"] == history["loss"]
    for name, value in params.items():
        assert torch.equal(armed_params[name], value), name


# ----------------------------------------- control-plane faults + idempotency

@pytest.fixture()
def daemon():
    server = PunchcardServer(port=0, secret="s3cret")
    server.start()
    yield server
    server.stop()


def _submit(daemon, retries=4):
    job = Job("127.0.0.1", daemon.port, secret="s3cret", script="print('ok')",
              rpc_timeout=10.0, rpc_retries=retries, rpc_backoff=0.01)
    job.submit()
    return job


def _job_count(daemon):
    with daemon._cv:
        return len(daemon.jobs)


@pytest.mark.parametrize("spec, site, least", [
    ("3:refuse_connect=2", "connect", 3),  # two refusals, then success
    ("3:drop_reply=2", "rpc_reply", 3),    # the request landed, the reply was lost
    ("5:tear_send=1", "send", 2),          # a torn frame, then a whole one
])
def test_retried_submit_is_idempotent_under_faults(daemon, spec, site, least):
    chaos.configure(spec)
    job = _submit(daemon)
    assert job.wait(timeout=30)["status"] == "finished"
    assert _job_count(daemon) == 1  # retries re-sent, the daemon deduped
    assert chaos.counts()[site] >= least


def test_two_distinct_submits_stay_distinct(daemon):
    """The idempotency key is per logical call, not per client."""
    a, b = _submit(daemon), _submit(daemon)
    assert a.wait(timeout=30)["status"] == b.wait(timeout=30)["status"] == "finished"
    assert a.job_id != b.job_id and _job_count(daemon) == 2


def test_rpc_exhausts_retry_budget(daemon):
    chaos.configure("3:drop_reply=99")
    with pytest.raises(ConnectionError, match="reply dropped"):
        _submit(daemon, retries=2)


# ------------------------------------------------- seeded kill => bit-exact

def _toy():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(512, 8)).astype(np.float32)
    y = (x @ rng.normal(size=(8,)) > 0).astype(np.int32)
    return x, np.eye(2, dtype=np.float32)[y]


class FixedInit(TorchModel):
    """Test-side adapter whose ``init`` returns given parameters."""

    def __init__(self, module, params):
        super().__init__(module)
        self.params = params

    def init(self, generator, sample_input):
        return {k: v.clone() for k, v in self.params.items()}, {}


def _kwargs(**kw):
    return dict(loss="categorical_crossentropy",
                worker_optimizer=("sgd", {"learning_rate": 0.05}), num_workers=4,
                batch_size=16, num_epoch=4, communication_window=4, seed=11, **kw)


def test_seeded_kill_resumes_bitwise_and_as_jax(tmp_path):
    x, onehot = _toy()
    want = jdk.DOWNPOUR(FlaxModel(jax_zoo.MLP(**MLP_KW)), **_kwargs()).train(
        jdk.from_numpy(x, onehot))
    variables = jax_zoo.MLP(**MLP_KW).init(jax.random.PRNGKey(11), x[:16])
    params, _ = variables_from_flax(zoo.MLP(**MLP_KW, in_features=8),
                                    jax.tree_util.tree_map(np.asarray, variables))
    model = lambda: FixedInit(zoo.MLP(**MLP_KW, in_features=8), params)
    df = tdk.from_numpy(x, onehot)
    baseline = tdk.DOWNPOUR(model(), device="cpu", **_kwargs()).train(df)

    # the seeded kill fires once entering epoch 2; train_with_recovery
    # resumes from the boundary checkpoint and lands on the exact same
    # parameters as the uninterrupted run
    chaos.configure("7:kill_epoch=2")
    trained = tdk.DOWNPOUR(model(), device="cpu", checkpoint_dir=str(tmp_path),
                           **_kwargs()).train_with_recovery(df, backoff_base=0)
    assert chaos.counts()["epoch"] == 5  # epochs 0-2 (killed), then 2-3 again
    for name, value in baseline.params.items():
        assert torch.equal(trained.params[name], value), name
    got, _ = variables_from_flax(zoo.MLP(**MLP_KW, in_features=8), {"params": jax.tree_util.tree_map(
        np.asarray, want.params)})
    for name, value in got.items():
        np.testing.assert_allclose(trained.params[name].numpy(), value.numpy(), **PARAM_TOL,
                                   err_msg=name)
