"""The port's training step (`repro_torch.train`) against the reference's
(`repro.train`), on the CPU at smoke width.

Each family's reference weights, `init_params(PRNGKey(0))`, reach the
port through `from_reference` (a train state through
`train_state_from_reference`); both packages then take the loss and its
gradients, and Adam steps, on the batch of `tests/test_archs.py`
(batch 2, sequence 16, with the family's frames or patches).

Tolerances, float32 smoke configs: the loss within rtol 1e-4; every
gradient leaf within 1e-4 of its largest |reference gradient| plus 1e-6
(the two packages add in different orders, so they agree to float32
rounding); after a step, params, `m`, `v`, `step`, `ef` and `grad_norm`
within rtol 1e-4, atol 1e-5, with the two exceptions that
`repro_torch.train.compare` sets out: a param whose gradient is float32
noise to Adam is held to 2 lr + atol, an element whose int8 rounding
sits on a boundary (at most 2 % of a leaf) is left out of its leaf, and
the error feedback is held to twice the gradient tolerance besides.
`compress_grads` on the same input is held bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
import repro.models as RM
import repro_torch.configs as PC
import repro_torch.models as PM
from repro.data.pipeline import TokenPipeline
from repro.train import grad_compression as RG
from repro.train import optimizer as RO
from repro.train import train_step as RT
from repro_torch.models.tree import leaves, tree_map
from repro_torch.serve.batcher import Request, ServeEngine
from repro_torch.train import grad_compression as PG
from repro_torch.train import optimizer as PO
from repro_torch.train import train_step as PT
from repro_torch.train.compare import RTOL, compare_grads, compare_states
from test_archs import _batch

CTX = RM.Ctx(mesh=None)
# the step's learning rate at full strength from step 1 (warmup 1), so
# that the step moves the params by about lr, well over atol (1e-5)
OPT = dict(lr=3e-4, warmup=1)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    # beside other pytest-xdist workers, a thread per core oversubscribes
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def batch_np(cfg):
    return np_tree(_batch(cfg))


_FAMILIES: dict = {}


def family(arch):
    """The reference's weights and value-and-grad on the batch, once."""
    if arch not in _FAMILIES:
        cfg = RC.smoke_config(arch)
        ref = RM.init_params(jax.random.PRNGKey(0), cfg)
        batch = batch_np(cfg)
        vg = jax.jit(lambda p, b: jax.value_and_grad(RT.loss_fn)(
            p, b, cfg, CTX))
        loss, grads = vg(ref, jax.tree.map(jnp.asarray, batch))
        _FAMILIES[arch] = (cfg, ref, batch, float(loss), np_tree(grads))
    return _FAMILIES[arch]


def port_model(arch, ref):
    return PM.from_reference(np_tree(ref), PC.smoke_config(arch), "cpu")


def assert_grads_close(got, want, what):
    compare_grads(got, tree_map(torch.from_numpy, want), what)


def assert_state_close(got, want, what, before=None, grads=None, opt=OPT):
    """The port's TrainState against the reference's (carried across to
    the port bit for bit), after the step `before` compared; `grads`,
    the reference's gradients a compressing step saw."""
    cfg = got.params.cfg
    scale = (None if grads is None else
             [float(np.abs(g).max()) for g in jax.tree.leaves(grads)])
    return compare_states(
        got, PM.train_state_from_reference(np_tree(want), cfg, "cpu"),
        PO.AdamConfig(**opt), before=before, grad_scale=scale, what=what)


# ---------------------------------------------------------------------------
# loss and gradients, every family
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", RC.ARCHS)
def test_loss_and_grads_match_reference(arch):
    cfg, ref, batch, want_loss, want_grads = family(arch)
    port = port_model(arch, ref)
    loss, grads = PT.value_and_grad(port, batch, port.cfg, PM.Ctx())
    np.testing.assert_allclose(float(loss), want_loss, rtol=RTOL)
    assert_grads_close(grads, want_grads, arch)
    # the gradients are the masters' own: float32, and nothing else holds
    # one (the step is functional)
    assert all(p.grad is None for p in port.parameters())


@pytest.mark.parametrize("arch", RC.ARCHS)
def test_one_train_step_matches_reference(arch):
    """The reference's step at accum 1 is its value-and-grad and then
    `adam_update`; the port's `train_step` against that."""
    cfg, ref, batch, _, grads = family(arch)
    opt_cfg = RO.AdamConfig(**OPT)
    state = RT.make_train_state(ref)
    want_p, want_opt, want_norm = jax.jit(
        lambda g, o, p: RO.adam_update(g, o, p, opt_cfg))(
        jax.tree.map(jnp.asarray, grads), state.opt, state.params)
    want = RT.TrainState(want_p, want_opt, None)

    port = PT.make_train_state(port_model(arch, ref))
    got, metrics = PT.train_step(port, batch, port.params.cfg, PM.Ctx(),
                                 PO.AdamConfig(**OPT))
    assert_state_close(got, want, arch)
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(want_norm),
                               rtol=RTOL)
    assert int(metrics["step"]) == 1
    # the step moved the params, and left the given state as it was
    before = PM.to_reference(port.params)
    assert all(np.array_equal(a, b) for a, b in zip(
        jax.tree.leaves(before), jax.tree.leaves(np_tree(ref))))
    moved = sum(float(np.abs(a - b).sum()) for a, b in zip(
        jax.tree.leaves(PM.to_reference(got.params)),
        jax.tree.leaves(before)))
    assert moved > 0


# ---------------------------------------------------------------------------
# Qwen: accumulation, compression, two steps
# ---------------------------------------------------------------------------

QWEN = "qwen1_5_0_5b"


def ref_step(state, batch, accum=1):
    cfg = RC.smoke_config(QWEN)
    opt_cfg = RO.AdamConfig(**OPT)
    return jax.jit(lambda st, b: RT.train_step(st, b, cfg, CTX, opt_cfg,
                                               accum))(
        state, jax.tree.map(jnp.asarray, batch))


def port_step(state, batch, accum=1):
    return PT.train_step(state, batch, state.params.cfg, PM.Ctx(),
                         PO.AdamConfig(**OPT), accum)


def test_accum_2_matches_reference():
    cfg, ref, batch, _, _ = family(QWEN)
    want, want_m = ref_step(RT.make_train_state(ref), batch, accum=2)
    got, got_m = port_step(PT.make_train_state(port_model(QWEN, ref)),
                           batch, accum=2)
    assert_state_close(got, want, "accum=2")
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(got_m[k]), float(want_m[k]),
                                   rtol=RTOL)


def test_accum_2_is_the_mean_of_the_microbatches():
    """Two microbatches' loss and gradients, averaged, are the accum=2
    step's (a split along the leading axis, in order)."""
    cfg, ref, batch, _, _ = family(QWEN)
    port = port_model(QWEN, ref)
    parts = [PT.value_and_grad(port, {k: v[i:i + 1] for k, v in
                                      batch.items()}, port.cfg, PM.Ctx())
             for i in range(2)]
    _, m = port_step(PT.make_train_state(port), batch, accum=2)
    np.testing.assert_allclose(float(m["loss"]),
                               (float(parts[0][0]) + float(parts[1][0])) / 2,
                               rtol=1e-6)
    mean = [(a + b) / 2 for a, b in zip(leaves(parts[0][1]),
                                        leaves(parts[1][1]))]
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(PO.global_norm(mean)), rtol=1e-6)


def test_compress_grads_is_the_reference_bit_for_bit():
    """The same gradients and residuals through both packages'
    `compress_grads`: the same int8 rounding (half to even), scales and
    residuals, bit for bit, twice in a row."""
    _, _, _, _, grads = family(QWEN)
    rng = np.random.default_rng(3)
    ef = jax.tree.map(lambda g: (rng.normal(size=g.shape) * np.abs(g).max()
                                 / 500).astype(np.float32), grads)
    # a leaf with exact halves of its quantum and an all-zero leaf
    tree = {"g": grads, "halves": np.array([-127, -2.5, -0.5, 0.5, 1.5,
                                            2.5, 126.5], np.float32),
            "zeros": np.zeros(5, np.float32)}
    ef_t = {"g": ef, "halves": np.zeros(7, np.float32),
            "zeros": np.zeros(5, np.float32)}
    want_g, want_e = jax.tree.map(jnp.asarray, tree), jax.tree.map(
        jnp.asarray, ef_t)
    got_g, got_e = (jax.tree.map(torch.from_numpy, tree),
                    jax.tree.map(torch.from_numpy, ef_t))
    for _ in range(2):
        want_g, want_e = RG.compress_grads(want_g, want_e)
        got_g, got_e = PG.compress_grads(got_g, got_e)
        for got, want in ((got_g, want_g), (got_e, want_e)):
            for g, w in zip(leaves(got), jax.tree.leaves(want)):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    q, s = PG._q8(torch.tensor([-127, -2.5, -0.5, 0.5, 1.5, 2.5, 126.5]))
    assert q.tolist() == [-127, -2, 0, 0, 2, 2, 126] and float(s) == 1.0


def test_compression_step_matches_reference():
    cfg, ref, batch, _, grads = family(QWEN)
    want, want_m = ref_step(RT.make_train_state(ref, compression=True),
                            batch)
    got, got_m = port_step(PT.make_train_state(port_model(QWEN, ref),
                                               compression=True), batch)
    assert_state_close(got, want, "compression", grads=grads)
    np.testing.assert_allclose(float(got_m["grad_norm"]),
                               float(want_m["grad_norm"]), rtol=RTOL)
    np.testing.assert_allclose(float(got_m["loss"]), float(want_m["loss"]),
                               rtol=RTOL)


def test_two_steps_in_a_row_match_reference():
    cfg, ref, _, _, _ = family(QWEN)
    pipe = TokenPipeline(vocab=cfg.vocab, batch=2, seq_len=16, seed=5)
    want = RT.make_train_state(ref)
    got = PT.make_train_state(port_model(QWEN, ref))
    before = None
    for step in range(2):
        batch = pipe.batch_at(step)
        want, want_m = ref_step(want, batch)
        got, got_m = port_step(got, batch)
        before = assert_state_close(got, want, f"step {step}", before)
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(got_m[k]), float(want_m[k]),
                                       rtol=RTOL)
    assert int(got_m["step"]) == 2


# ---------------------------------------------------------------------------
# Adam on a hand tree
# ---------------------------------------------------------------------------

def hand_tree(rng):
    return {"blocks": ({"ln1": rng.normal(size=(3, 4)).astype(np.float32),
                        "w": rng.normal(size=(3, 4, 5)).astype(np.float32)},),
            "final_norm": rng.normal(size=(4,)).astype(np.float32)}


def test_adam_update_on_a_hand_tree_matches_reference():
    rng = np.random.default_rng(0)
    params, grads = hand_tree(rng), hand_tree(rng)
    grads["final_norm"] *= 10        # a norm over grad_clip: clipped
    cfg = dict(lr=1e-2, warmup=3, weight_decay=0.1)
    want_s = RO.adam_init(jax.tree.map(jnp.asarray, params))
    got_s = PO.adam_init(jax.tree.map(torch.from_numpy, params))
    want_p = jax.tree.map(jnp.asarray, params)
    got_p = jax.tree.map(torch.from_numpy, params)
    for _ in range(4):               # across the end of the warmup
        want_p, want_s, want_n = RO.adam_update(
            jax.tree.map(jnp.asarray, grads), want_s, want_p,
            RO.AdamConfig(**cfg))
        got_p, got_s, got_n = PO.adam_update(
            jax.tree.map(torch.from_numpy, grads), got_s, got_p,
            PO.AdamConfig(**cfg))
        np.testing.assert_allclose(float(got_n), float(want_n), rtol=1e-6)
        for got, want in ((got_p, want_p), (got_s.m, want_s.m),
                          (got_s.v, want_s.v)):
            for g, w in zip(leaves(got), jax.tree.leaves(want)):
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           rtol=1e-6, atol=1e-7)
    assert got_s.step.dtype == torch.int32 and int(got_s.step) == 4


def test_weight_decay_follows_the_stacked_ndim():
    """With zero gradients only decay moves a leaf: the stacked (reps, D)
    norm scale and the matrices decay, the 1-D `final_norm` does not."""
    rng = np.random.default_rng(1)
    params = jax.tree.map(torch.from_numpy, hand_tree(rng))
    zeros = jax.tree.map(torch.zeros_like, params)
    cfg = PO.AdamConfig(lr=0.1, warmup=1, weight_decay=0.5)
    new, _, _ = PO.adam_update(zeros, PO.adam_init(params), params, cfg)
    for name in ("ln1", "w"):
        torch.testing.assert_close(new["blocks"][0][name],
                                   params["blocks"][0][name] * (1 - 0.05))
    assert torch.equal(new["final_norm"], params["final_norm"])


# ---------------------------------------------------------------------------
# the model: gradients reach the masters, remat, serving records no graph
# ---------------------------------------------------------------------------

def test_bf16_compute_puts_float32_grads_on_the_masters():
    import dataclasses

    cfg = dataclasses.replace(PC.smoke_config(QWEN), dtype="bfloat16")
    model = PM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = batch_np(cfg)
    logits = PM.forward_train(model, batch, cfg, PM.Ctx())
    assert logits.dtype == torch.bfloat16 and logits.grad_fn is not None
    _, grads = PT.value_and_grad(model, batch, cfg, PM.Ctx())
    assert all(g.dtype == torch.float32 for g in leaves(grads))
    assert all(float(g.abs().max()) > 0 for g in leaves(grads))


def test_each_repeat_is_recomputed_in_the_backward(monkeypatch):
    """With autograd on, every block runs twice a repeat (the forward
    and its recompute); without it, once."""
    from repro_torch.models import transformer as TF

    model = port_model(QWEN, family(QWEN)[1])
    cfg, batch = model.cfg, family(QWEN)[2]
    calls = []
    orig = TF.AttnBlock.forward

    def counted(self, x, p, *a, **k):
        calls.append(p["ln1"].shape)
        return orig(self, x, p, *a, **k)

    monkeypatch.setattr(TF.AttnBlock, "forward", counted)
    PT.value_and_grad(model, batch, cfg, PM.Ctx())
    assert len(calls) == 2 * cfg.n_layers
    assert all(s == (cfg.d_model,) for s in calls)   # a repeat's slice
    calls.clear()
    with torch.no_grad():
        PM.forward_train(model, batch, cfg, PM.Ctx())
    assert len(calls) == cfg.n_layers


def test_serving_records_no_graph():
    cfg, ref, batch, _, _ = family(QWEN)
    model = port_model(QWEN, ref)
    assert all(p.requires_grad for p in model.parameters())
    cache = PM.init_cache(model.cfg, 2, 24, device="cpu")
    logits, cache = PM.decode_step(model, np.array([3, 7]), cache, 0,
                                   model.cfg, PM.Ctx())
    assert logits.grad_fn is None and not logits.requires_grad
    assert all(not t.requires_grad for c in cache for t in c.values())
    logits, cache = PM.prefill(model, {"tokens": batch["tokens"]},
                               model.cfg, PM.Ctx())
    assert logits.grad_fn is None
    eng = ServeEngine(model, model.cfg, slots=2, max_len=16, device="cpu")
    req = Request(0, np.arange(3), 2, logits=[])
    eng.submit(req)
    eng.run_until_drained()
    assert req.done and all(t.grad_fn is None for t in req.logits)
    assert all(not t.requires_grad for c in eng.cache for t in c.values())


# ---------------------------------------------------------------------------
# the comparison itself
# ---------------------------------------------------------------------------

def hand_state(rng, ef_scale=None):
    t = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    params = {"w": t(3, 50), "b": t(50)}
    v = {"w": t(3, 50).abs() * 1e-2, "b": t(50).abs() * 1e-2}
    ef = None if ef_scale is None else {"w": t(3, 50) * ef_scale,
                                        "b": t(50) * ef_scale}
    return PT.TrainState(params, PO.AdamState(
        {"w": t(3, 50), "b": t(50)}, v, torch.tensor(3, dtype=torch.int32)),
        ef)


def test_compare_states_finds_a_wrong_leaf():
    base = hand_state(np.random.default_rng(0))
    opt = PO.AdamConfig()
    assert compare_states(base, base, opt)["int8_apart"] == 0
    for field in ("params", "m", "v"):
        bad = jax.tree.map(torch.clone, base)
        tree = bad.params if field == "params" else getattr(bad.opt, field)
        tree["w"][1, 7] += 1e-3
        with pytest.raises(AssertionError, match=field):
            compare_states(bad, base, opt)
    bad = base._replace(opt=base.opt._replace(step=base.opt.step + 1))
    with pytest.raises(AssertionError, match="step"):
        compare_states(bad, base, opt)


def test_compare_states_counts_boundary_roundings_and_no_more():
    """An int8 rounding on a boundary (residuals +-scale/2, the param and
    moments a quantum apart) is counted and left out (its param held to
    twice the steps' learning rates); more than 2 % of
    a leaf (counted as of 1,000 elements) fails, as does a residual off
    without the opposite sign."""
    rng = np.random.default_rng(1)
    base = hand_state(rng, ef_scale=1e-3)
    opt = PO.AdamConfig()
    one = jax.tree.map(torch.clone, base)
    one.ef["b"][4] = -base.ef["b"][4]
    one.params["b"][4] += 3e-5        # within twice the steps' lr, 1.8e-5
    one.opt.m["b"][4] += 1e-3
    res = compare_states(one, base, opt)
    assert res["int8_apart"] == 1 and bool(res["loose"][0][4])
    far = jax.tree.map(torch.clone, one)
    far.params["b"][4] += 1e-2
    with pytest.raises(AssertionError, match="moves"):
        compare_states(far, base, opt)
    many = jax.tree.map(torch.clone, one)
    many.ef["b"][5:26] = -base.ef["b"][5:26]       # 22 of 50
    with pytest.raises(AssertionError, match="int8 roundings"):
        compare_states(many, base, opt)
    off = jax.tree.map(torch.clone, base)
    off.ef["w"][0, 3] += 1e-2
    with pytest.raises(AssertionError, match="ef"):
        compare_states(off, base, opt)


def test_compare_grads_finds_a_wrong_leaf():
    g = {"a": torch.ones(4), "b": torch.arange(5.0)}
    assert compare_grads(g, g) == 0
    bad = {"a": torch.ones(4), "b": torch.arange(5.0) + 1e-3}
    with pytest.raises(AssertionError, match="leaf 1"):
        compare_grads(bad, g)
