"""The port's training runtime (`repro_torch.checkpoint`, `.data`,
`.runtime`, `.launch.train`) against the reference's, on the CPU.

The counterparts of the eight training-side tests of
`tests/test_runtime.py` (checkpoint round trip, gc and async, pipeline
determinism and host sharding, prefetch, error feedback, driver recovery,
stragglers, elastic restore), and across the packages: the pipeline's
batches bit for bit, and a `TrainState` checkpoint written by either
package restored by the other, equal bit for bit to the state carried
across by `train_state_from_reference` / `train_state_to_reference`.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.checkpoint.checkpoint as RCK
import repro.configs as RC
import repro.data.pipeline as RD
import repro.models as RM
import repro_torch.configs as PC
import repro_torch.models as PM
from repro.train import train_step as RT
from repro_torch.checkpoint.checkpoint import (AsyncCheckpointer, latest_step,
                                               restore, save)
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch import train as launch
from repro_torch.runtime.fault_tolerance import StragglerStats, TrainDriver
from repro_torch.train.grad_compression import compress_grads, ef_init
from repro_torch.train.optimizer import AdamConfig
from repro_torch.train.train_step import make_train_state, train_step
from repro_torch.models.tree import leaves, tree_map

CTX = PM.Ctx()
QWEN = "qwen1_5_0_5b"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    # beside other pytest-xdist workers, a thread per core oversubscribes
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture()
def tiny():
    cfg = PC.smoke_config(QWEN)
    return cfg, PM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")


def state_arrays(state):
    """Every leaf of a state (either package's) as numpy, in order."""
    if hasattr(state.params, "tree"):
        state = PM.train_state_to_reference(state)
    return [np.asarray(x) for x in jax.tree.leaves(state)]


def key_paths(tree):
    return [jax.tree_util.keystr(p)
            for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def assert_same_state(a, b):
    la, lb = state_arrays(a), state_arrays(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# the eight of tests/test_runtime.py
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path, tiny):
    cfg, params = tiny
    state = make_train_state(params, compression=True)
    path = save(str(tmp_path), 7, state)
    assert os.path.exists(os.path.join(path, "manifest.json"))
    assert latest_step(str(tmp_path)) == 7
    restored = restore(str(tmp_path), 7, state)
    assert isinstance(restored.params, PM.LM)
    assert_same_state(state, restored)


def test_checkpoint_gc_and_async(tmp_path):
    ck = AsyncCheckpointer(str(tmp_path), keep=2)
    for step in (1, 2, 3):
        ck.save(step, {"w": torch.ones(4) * step})
    ck.wait()
    steps = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert steps == ["step_00000002", "step_00000003"]
    r = restore(str(tmp_path), 3, {"w": torch.zeros(4)})
    np.testing.assert_array_equal(r["w"].numpy(), 3 * np.ones(4))
    assert ck.snapshot_s >= 0 and ck.write_s >= 0


def test_pipeline_determinism_and_sharding():
    kw = dict(vocab=100, batch=8, seq_len=16, seed=42)
    p1 = TokenPipeline(**kw)
    p2 = TokenPipeline(**kw)
    b1, b2 = p1.batch_at(5), p2.batch_at(5)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    assert not np.array_equal(p1.batch_at(5)["tokens"],
                              p1.batch_at(6)["tokens"])
    # host sharding: different hosts draw different slices
    h0 = TokenPipeline(**kw, host=0, n_hosts=2).batch_at(5)
    h1 = TokenPipeline(**kw, host=1, n_hosts=2).batch_at(5)
    assert h0["tokens"].shape[0] == 4
    assert not np.array_equal(h0["tokens"], h1["tokens"])


def test_pipeline_prefetch():
    p = TokenPipeline(vocab=50, batch=4, seq_len=8)
    p.start(from_step=3)
    it = iter(p)
    s, b = next(it)
    assert s == 3 and b["tokens"].shape == (4, 8)
    s2, _ = next(it)
    assert s2 == 4
    p.stop()


def test_grad_compression_error_feedback(tiny):
    cfg, params = tiny
    grads = tree_map(lambda p: torch.full(p.shape, 1e-3), params)
    ef = ef_init(params)
    total = tree_map(lambda p: torch.zeros(p.shape), params)
    for _ in range(8):
        dq, ef = compress_grads(grads, ef)
        total = tree_map(torch.add, total, dq)
    # error feedback: accumulated dequantized grads converge to 8 x grads
    for t, g in zip(leaves(total), leaves(grads)):
        np.testing.assert_allclose(t.numpy(), 8 * g.numpy(), rtol=0.02,
                                   atol=1e-5)


def test_driver_recovers_from_failures(tmp_path, tiny):
    cfg, params = tiny
    state = make_train_state(params)
    pipe = TokenPipeline(vocab=cfg.vocab, batch=2, seq_len=16)

    def stepper(st, b):
        return train_step(st, b, cfg, CTX, AdamConfig(lr=1e-3))

    boom = {"armed": True}

    def fail_hook(step):
        if step == 5 and boom["armed"]:
            boom["armed"] = False
            raise RuntimeError("simulated node failure")

    drv = TrainDriver(step_fn=stepper, state=state, pipeline=pipe,
                      ckpt_dir=str(tmp_path), ckpt_every=2,
                      fail_hook=fail_hook, device="cpu")
    final = drv.run(8)
    assert drv.recoveries == 1
    assert len([m for m in drv.metrics_log if m["step"] == 7]) >= 1
    assert int(final.opt.step) > 0
    losses = [m["loss"] for m in drv.metrics_log]
    assert all(np.isfinite(losses))
    # the replayed step 4 (restored from step 4's checkpoint) gives its
    # first pass's loss: the restored state is the one saved
    first, again = [m["loss"] for m in drv.metrics_log if m["step"] == 4]
    assert first == again
    assert int(final.opt.step) == 8


def test_straggler_detection():
    st = StragglerStats(threshold=2.0)
    for i in range(10):
        st.observe(i, 0.1)
    assert st.observe(10, 1.0)          # 10x the EMA -> flagged
    assert st.slow_steps and st.slow_steps[-1][0] == 10
    assert not st.observe(11, 0.1)


def test_elastic_restore_reshape(tmp_path):
    """Restore onto a different target: dtype adaptation."""
    tree = {"w": torch.arange(16, dtype=torch.float32).reshape(4, 4)}
    save(str(tmp_path), 1, tree)
    like = {"w": torch.empty((4, 4), dtype=torch.bfloat16)}
    out = restore(str(tmp_path), 1, like)
    assert out["w"].dtype == torch.bfloat16
    np.testing.assert_allclose(out["w"].float().numpy(),
                               np.arange(16).reshape(4, 4))


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(vocab=100, batch=8, seq_len=16, seed=42),
    dict(vocab=151_936, batch=8, seq_len=64),
    dict(vocab=50, batch=6, seq_len=9, seed=3, host=2, n_hosts=3),
    dict(vocab=256, batch=4, seq_len=12, structured=True),
    dict(vocab=64, batch=2, seq_len=8, extras={"frames": (4, 16)}),
])
def test_pipeline_batches_equal_reference_bit_for_bit(kw):
    got, want = TokenPipeline(**kw), RD.TokenPipeline(**kw)
    for step in (0, 1, 17):
        g, w = got.batch_at(step), want.batch_at(step)
        assert g.keys() == w.keys()
        for k in w:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])


@pytest.fixture(scope="module")
def ref_state():
    """A reference TrainState after one step with compression on (every
    leaf kind set: params, m, v, step, ef), as numpy, and its config."""
    cfg = RC.smoke_config(QWEN)
    params = RM.init_params(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(0)
    batch = {"tokens": jnp.asarray(rng.integers(0, cfg.vocab, (2, 8)),
                                   jnp.int32),
             "targets": jnp.asarray(rng.integers(0, cfg.vocab, (2, 8)),
                                    jnp.int32)}
    state, _ = jax.jit(lambda st, b: RT.train_step(
        st, b, cfg, RM.Ctx(mesh=None)))(
        RT.make_train_state(params, compression=True), batch)
    return jax.tree.map(np.asarray, state), PC.smoke_config(QWEN)


def test_state_carries_across_bit_for_bit(ref_state):
    state_np, cfg = ref_state
    port = PM.train_state_from_reference(state_np, cfg, "cpu")
    assert isinstance(port.params, PM.LM) and port.opt.step.dtype == \
        torch.int32
    back = PM.train_state_to_reference(port)
    assert key_paths(back) == key_paths(state_np)
    assert_same_state(back, state_np)


def test_reference_checkpoint_restores_in_the_port(tmp_path, ref_state):
    state_np, cfg = ref_state
    RCK.save(str(tmp_path), 3, state_np)
    like = make_train_state(
        PM.init_params(cfg, torch.Generator().manual_seed(1), "cpu"),
        compression=True)
    got = restore(str(tmp_path), latest_step(str(tmp_path)), like)
    assert_same_state(got, PM.train_state_from_reference(state_np, cfg,
                                                         "cpu"))


def test_port_checkpoint_restores_in_the_reference(tmp_path, ref_state):
    state_np, cfg = ref_state
    port = PM.train_state_from_reference(state_np, cfg, "cpu")
    save(str(tmp_path / "port"), 3, port)
    RCK.save(str(tmp_path / "ref"), 3, state_np)
    manifests = [json.load(open(tmp_path / d / "step_00000003" /
                                "manifest.json"))["leaves"]
                 for d in ("port", "ref")]
    assert manifests[0] == manifests[1]
    assert ".params['blocks'][0]['ln1']" in manifests[0]
    assert ".opt.step" in manifests[0] and ".ef['embed']" in manifests[0]
    like = jax.tree.map(np.zeros_like, state_np)
    got = RCK.restore(str(tmp_path / "port"), 3, like)
    assert_same_state(jax.tree.map(np.asarray, got),
                      PM.train_state_to_reference(port))


def test_async_snapshot_is_a_copy(tmp_path, tiny):
    """A step after `save` (here one that updates the params in place, and
    the functional `train_step`) does not reach the checkpoint."""
    cfg, params = tiny
    state = make_train_state(params)
    want = [x.copy() for x in state_arrays(state)]
    ck = AsyncCheckpointer(str(tmp_path))
    ck.save(1, state)
    with torch.no_grad():
        for p in state.params.parameters():
            p.add_(1.0)
    state.opt.step.add_(5)
    train_step(state, TokenPipeline(vocab=cfg.vocab, batch=2,
                                    seq_len=8).batch_at(0), cfg, CTX)
    ck.wait()
    got = state_arrays(restore(str(tmp_path), 1, state))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_bf16_leaf_saves_widened_and_restores_bit_for_bit(tmp_path):
    w = torch.randn(5, 3, generator=torch.Generator().manual_seed(0)).to(
        torch.bfloat16)
    save(str(tmp_path), 2, {"w": w})
    manifest = json.load(open(tmp_path / "step_00000002" / "manifest.json"))
    assert manifest["leaves"]["['w']"] == {"shape": [5, 3],
                                           "dtype": "bfloat16"}
    with np.load(tmp_path / "step_00000002" / "arrays.npz") as data:
        assert data["['w']"].dtype == np.float32
    out = restore(str(tmp_path), 2, {"w": torch.zeros(5, 3,
                                                      dtype=torch.bfloat16)})
    assert out["w"].dtype == torch.bfloat16 and torch.equal(out["w"], w)


def test_train_launcher_on_the_cpu(tmp_path, capsys):
    drv = launch.main(["--device", "cpu", "--steps", "3", "--batch", "2",
                       "--seq", "8", "--ckpt", str(tmp_path)])
    assert [m["step"] for m in drv.metrics_log] == [0, 1, 2]
    assert "qwen-smoke on CPU: done: 3 steps" in capsys.readouterr().out
    # the launcher checkpoints every 20 steps: none in 3
    assert latest_step(str(tmp_path)) is None


def test_train_launcher_and_driver_want_cuda_unless_cpu_is_asked(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        launch.main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        PM.train_state_from_reference(None, PC.smoke_config(QWEN))
