"""The port's sharded language models against the reference's sharded
program, on the CPU at smoke width.

The reference runs `jax.jit` over a (2, 2) ("data", "model") mesh of 4
of the 8 forced host devices (`tests/conftest.py`), its weights placed
by `shardings_for`, its inputs by `batch_spec`.  The port runs the same
weights (`init_params(PRNGKey(0))` through `from_reference`), placed by
its `param_specs` as DTensors over a local world of 4 virtual CPU slots
(`repro_torch.launch.mesh.world`), on the same (2, 2) mesh and on (1, 4)
(tensor parallelism alone).  Every rank's copy of a result must agree
(`sharding.gather`).

Tolerances (float32): logits within 1e-5 absolute of the reference's
sharded program and of the port's unsharded run (the reference's own
sharded-against-unsharded gap is 9.8e-7 for Qwen, 2.4e-6 for Granite);
prefill and decode tokens equal; a train step held to `chip_smoke.py`
phase 11 (a)'s limits: loss rtol 1e-4, gradient norm rtol 1e-3, each
gradient leaf within 1e-3 of its largest |gradient|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
import repro.models as RM
import repro.models.sharding as RS
import repro.train.train_step as RT
import repro_torch.launch.mesh as PMESH
import repro_torch.models as PM
import repro_torch.models.sharding as PS
import repro_torch.train.train_step as PT
from repro_torch.models.tree import leaves
from repro_torch.train.optimizer import AdamConfig, global_norm

LOGIT_ATOL = 1e-5
LOSS_RTOL, NORM_RTOL, LEAF_REL = 1e-4, 1e-3, 1e-3
B, S = 4, 8
DENSE, MOE = "qwen1_5_0_5b", "granite_moe_1b_a400m"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


_MODELS: dict = {}


def models(arch):
    if arch not in _MODELS:
        cfg = RC.smoke_config(arch)
        ref = RM.init_params(jax.random.PRNGKey(0), cfg)
        port = PM.from_reference(jax.tree.map(np.asarray, ref),
                                 PM.ModelConfig(**cfg.__dict__), "cpu")
        _MODELS[arch] = (cfg, ref, port)
    return _MODELS[arch]


def batch_for(cfg, seed=0, b=B, s=S, train=False):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if train:
        batch["targets"] = rng.integers(0, cfg.vocab, (b, s)).astype(
            np.int32)
    if cfg.encoder_layers:
        batch["frames"] = rng.normal(size=(b, 4, cfg.d_model)).astype(
            np.float32)
    if cfg.n_patches:
        batch["patch_embeds"] = rng.normal(
            size=(b, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return batch


def ref_ctx(shape):
    devs = jax.devices()
    assert len(devs) >= 4, "tests/conftest.py forces 8 host devices"
    mesh = jax.sharding.Mesh(np.asarray(devs[:4]).reshape(shape),
                             ("data", "model"))
    return RS.Ctx(mesh=mesh)


def ref_place(tree, rctx, specs):
    return jax.device_put(tree, jax.tree.map(
        lambda s: jax.sharding.NamedSharding(rctx.mesh, s), specs,
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)))


def ref_batch(batch, rctx):
    specs = {k: jax.sharding.PartitionSpec(
        RS.batch_spec(rctx) if v.shape[0] % rctx.dp_size == 0 else None,
        *[None] * (v.ndim - 1)) for k, v in batch.items()}
    return ref_place({k: jnp.asarray(v) for k, v in batch.items()}, rctx,
                     specs)


def ref_forward(arch, batch, shape):
    cfg, ref, _ = models(arch)
    rctx = ref_ctx(shape)
    params = ref_place(ref, rctx, RS.param_specs(ref, rctx))
    fn = jax.jit(lambda p, b: RM.forward_train(p, b, cfg, rctx))
    return np.asarray(fn(params, ref_batch(batch, rctx)))


def sharded(port, ctx):
    return PM.LM(port.cfg, PS.distribute(port.tree(), ctx))


def local_ctx(shape):
    return PMESH.make_ctx(PMESH.make_mesh(shape, ("data", "model")))


@pytest.mark.parametrize("arch", RC.ARCHS)
def test_forward_matches_reference_sharded(arch):
    cfg, _, port = models(arch)
    batch = batch_for(cfg, seed=2)
    want = ref_forward(arch, batch, (2, 2))
    with torch.no_grad():
        alone = PM.forward_train(port, batch, port.cfg, PM.Ctx()).numpy()
        with PMESH.world(4, "local"):
            ctx = local_ctx((2, 2))
            out = PM.forward_train(sharded(port, ctx), batch, port.cfg, ctx)
            got = PS.gather(out).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_ATOL)
    np.testing.assert_allclose(got, alone, rtol=0, atol=LOGIT_ATOL)


@pytest.mark.parametrize("arch", [DENSE, MOE])
def test_tensor_parallel_alone_matches_reference(arch):
    """A (1, 4) mesh: every rank holds all the rows and a quarter of the
    model axis."""
    cfg, _, port = models(arch)
    batch = batch_for(cfg, seed=3)
    want = ref_forward(arch, batch, (1, 4))
    with torch.no_grad(), PMESH.world(4, "local"):
        ctx = local_ctx((1, 4))
        got = PS.gather(PM.forward_train(sharded(port, ctx), batch,
                                           port.cfg, ctx)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_ATOL)


def ref_serve(arch, tokens, steps, smax, shape):
    """The reference's sharded prefill, then `steps` greedy decode steps
    from its caches grown to `smax` (its prefill's, unsharded, where the
    data axis does not divide the batch)."""
    cfg, ref, _ = models(arch)
    rctx = ref_ctx(shape)
    b = tokens.shape[0]
    pctx = rctx if b % rctx.dp_size == 0 else RS.Ctx()
    params = ref_place(ref, rctx, RS.param_specs(ref, rctx))
    logits, cache = jax.jit(lambda p, t: RM.prefill(
        p, {"tokens": t}, cfg, pctx))(params if pctx.mesh else ref,
                                      jnp.asarray(tokens))
    cache = jax.tree.map(
        lambda c: jnp.pad(c, [(0, 0), (0, 0), (0, smax - c.shape[2])]
                          + [(0, 0)] * (c.ndim - 3)) if c.ndim >= 4 else c,
        cache)
    cache = ref_place(cache, rctx, jax.tree.map(
        lambda c: RS.cache_spec(c.shape, b, rctx), cache))
    step = jax.jit(lambda p, t, c, pos: RM.decode_step(p, t, c, pos, cfg,
                                                       rctx))
    out = [np.asarray(logits).argmax(-1)]
    for i in range(steps):
        logits, cache = step(params, jnp.asarray(out[-1], jnp.int32), cache,
                             jnp.int32(tokens.shape[1] + i))
        out.append(np.asarray(logits).argmax(-1))
    return np.stack(out), np.asarray(logits)


def port_serve(port, tokens, steps, smax, ctx):
    logits, cache = PM.prefill(port, {"tokens": tokens}, port.cfg, ctx)
    cache = PM.pad_cache(cache, smax)
    out = [PS.gather(logits).argmax(-1).numpy()]
    for i in range(steps):
        logits, cache = PM.decode_step(port, out[-1], cache,
                                       tokens.shape[1] + i, port.cfg, ctx)
        out.append(PS.gather(logits).argmax(-1).numpy())
    return np.stack(out), PS.gather(logits).numpy()


@pytest.mark.parametrize("arch,b", [(DENSE, 4), (MOE, 4), (MOE, 1)])
def test_prefill_and_decode_tokens_match_reference(arch, b):
    """Greedy tokens of a prefill and 6 decode steps; at batch 1 the
    MoE takes its replicated-token branch."""
    cfg, _, port = models(arch)
    tokens = np.random.default_rng(5).integers(0, cfg.vocab, (b, 8))
    want, want_logits = ref_serve(arch, tokens, 6, 16, (2, 2))
    alone, _ = port_serve(port, tokens, 6, 16, PM.Ctx())
    with PMESH.world(4, "local"):
        ctx = local_ctx((2, 2))
        got, got_logits = port_serve(sharded(port, ctx), tokens, 6, 16, ctx)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, alone)
    np.testing.assert_allclose(got_logits, want_logits, rtol=0,
                               atol=LOGIT_ATOL)


def ref_train_step(arch, batch, shape):
    cfg, ref, _ = models(arch)
    rctx = ref_ctx(shape)
    state = RT.make_train_state(ref)
    specs = RS.param_specs(ref, rctx)
    state = state._replace(params=ref_place(state.params, rctx, specs))
    fn = jax.jit(lambda st, b: jax.value_and_grad(RT.loss_fn)(
        st.params, b, cfg, rctx))
    loss, grads = fn(state, ref_batch(batch, rctx))
    return float(loss), [np.asarray(g) for g in jax.tree.leaves(grads)]


def port_grads(port, batch, ctx):
    loss, grads = PT.value_and_grad(port, batch, port.cfg, ctx)
    return (float(PS.gather(loss)),
            [PS.gather(g).numpy() for g in leaves(grads)])


def hold(got, want):
    loss, grads = got
    wloss, wgrads = want
    assert abs(loss - wloss) <= LOSS_RTOL * abs(wloss)
    norm = float(global_norm([torch.from_numpy(g) for g in grads]))
    wnorm = float(global_norm([torch.from_numpy(g) for g in wgrads]))
    assert abs(norm - wnorm) <= NORM_RTOL * wnorm
    assert len(grads) == len(wgrads)
    for g, w in zip(grads, wgrads):
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= LEAF_REL * np.abs(w).max()


@pytest.mark.parametrize("arch", [DENSE, MOE])
def test_train_step_matches_reference(arch):
    """One step's loss and gradients (the reference's `value_and_grad`
    of its sharded `loss_fn`, the port's of its own), and the port's
    Adam step on the mesh equal to its step on one device."""
    cfg, _, port = models(arch)
    batch = batch_for(cfg, seed=4, train=True)
    want = ref_train_step(arch, batch, (2, 2))
    alone = port_grads(port, batch, PM.Ctx())
    st1, m1 = PT.train_step(PT.make_train_state(port), batch, port.cfg,
                            PM.Ctx(), AdamConfig())
    with PMESH.world(4, "local"):
        ctx = local_ctx((2, 2))
        sp = sharded(port, ctx)
        got = port_grads(sp, batch, ctx)
        st2, m2 = PT.train_step(PT.make_train_state(sp), batch, port.cfg,
                                ctx, AdamConfig())
        params2 = [PS.gather(p).detach().numpy()
                   for p in leaves(st2.params)]
        loss2 = float(PS.gather(m2["loss"]))
    hold(got, want)
    hold(got, alone)
    assert abs(loss2 - float(m1["loss"])) <= LOSS_RTOL * float(m1["loss"])
    for p, w in zip(params2, leaves(st1.params)):
        np.testing.assert_allclose(p, w.detach().numpy(), rtol=1e-4,
                                   atol=1e-5)


def test_onehot_loss_equals_gather_loss(monkeypatch):
    cfg, _, port = models(DENSE)
    batch = batch_for(cfg, seed=6, train=True)
    with torch.no_grad(), PMESH.world(4, "local"):
        ctx = local_ctx((2, 2))
        sp = sharded(port, ctx)
        gather = float(PS.gather(PT.loss_fn(sp, batch, port.cfg, ctx)))
        monkeypatch.setenv("REPRO_LOSS_MODE", "onehot")
        onehot = float(PS.gather(PT.loss_fn(sp, batch, port.cfg, ctx)))
        monkeypatch.setenv("REPRO_LOSS_MODE", "gather")
        alone = float(PT.loss_fn(port, batch, port.cfg, PM.Ctx()))
    assert abs(onehot - gather) <= LOSS_RTOL * gather
    assert abs(gather - alone) <= LOSS_RTOL * alone


def test_moe_gathers_each_expert_weight_once_a_layer():
    """The experts' FSDP-sharded weights are gathered to the local
    function's specs once a weight a layer, not once an expert: one
    all-gather a sharded weight in one MoE layer's call, and a second
    for `w_down`, whose model-sharded dim moves (an all-to-all, which
    the CPU's collectives carry as an all-gather and a chunk)."""
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.models import moe as moe_mod

    cfg, _, port = models(MOE)
    p = {k: v[0].detach() for k, v in port.tree()["blocks"][0]["ffn"].items()}
    x = torch.from_numpy(np.random.default_rng(7).normal(
        size=(B, S, cfg.d_model)).astype(np.float32))
    want = moe_mod.moe_ffn(x, p, cfg, PM.Ctx())
    with torch.no_grad(), PMESH.world(4, "local"):
        ctx = local_ctx((2, 2))
        specs = PS.param_specs({"w": p}, ctx)["w"]
        ps = PS.distribute(p, ctx, specs)
        sharded_fsdp = sum(any(e == "data" for e in s)
                           for s in PS.spec_leaves(specs))
        xs = PS.place(x, ctx.mesh, PS.P("data", None, None))
        with CommDebugMode() as comm:
            y = moe_mod.moe_ffn(xs, ps, cfg, ctx)
        got = PS.gather(y)
    gathers = sum(n for op, n in comm.get_comm_counts().items()
                  if "all_gather" in str(op))
    assert sharded_fsdp == 4 and gathers == sharded_fsdp + 1
    assert cfg.n_experts > 1
    torch.testing.assert_close(got, want, rtol=0, atol=LOGIT_ATOL)


def test_launchers_on_virtual_slots_equal_one_device(tmp_path):
    """The serving and training launchers on 4 virtual CPU slots (a
    (1, 4) mesh by the reference's factorisation) give the one-device
    run's tokens and losses; a sharded train state survives a
    checkpoint's save and restore."""
    from torch.distributed.tensor import DTensor

    from repro_torch.checkpoint.checkpoint import restore, save
    from repro_torch.core import mesh as core_mesh
    from repro_torch.launch import serve as LS
    from repro_torch.launch import train as LT

    serve_args = ["--device", "cpu", "--requests", "2", "--max-new", "3"]
    train_args = ["--device", "cpu", "--steps", "2"]
    alone = [r.out for r in LS.main(serve_args)[0]]
    alone_loss = [m["loss"] for m in LT.main(train_args).metrics_log]
    core_mesh.virtual_devices("cpu", 4)
    try:
        assert PMESH.factor(4) == (1, 4)
        got = [r.out for r in LS.main(serve_args)[0]]
        drv = LT.main(train_args)
        loss = [m["loss"] for m in drv.metrics_log]
        params = LT.launch_params(LT.parse_args(train_args),
                                  torch.device("cpu"))
        with PMESH.model_mesh("cpu") as mesh:
            assert tuple(mesh.shape) == (1, 4)
            ctx = PMESH.make_ctx(mesh)
            state = PT.make_train_state(sharded(params, ctx))
            save(str(tmp_path), 7, state)
            back = restore(str(tmp_path), 7, state)
            n_sharded = 0
            for a, b in zip(leaves(back), leaves(state), strict=True):
                if isinstance(b, DTensor):
                    assert a.placements == b.placements
                    n_sharded += 1
                assert torch.equal(PS.gather(a), PS.gather(b))
            assert n_sharded == 3 * len(leaves(params))
    finally:
        core_mesh.virtual_devices("cpu", 1)
    assert got == alone
    np.testing.assert_allclose(loss, alone_loss, rtol=LOSS_RTOL)
