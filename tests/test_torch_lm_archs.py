"""The port's ten model families (`repro_torch.models`) against the
reference's (`repro.models`), on the CPU at smoke width.

Each family's reference weights, `init_params(PRNGKey(0))`, reach the
port through `from_reference`; both packages then run `prefill` (batch
2, sequence 8, with the family's frames or patches), `decode_step` at
`pos=5` against one seeded random cache, and the forward of
`forward_train`, on the same numpy inputs.

Tolerance: float32 smoke configs, rtol 1e-4, atol 1e-5 on logits and
caches.  The two packages add in different orders (XLA's dots and the
reference's associative scan in Mamba against torch's matmuls and a
step-by-step recurrence), so they agree to float32 rounding, not bit for
bit.  The full configs must equal the reference's field for field.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
import repro.models as RM
import repro_torch.configs as PC
import repro_torch.models as PM

RTOL, ATOL = 1e-4, 1e-5
B, S, SMAX, S_ENC, POS = 2, 8, 24, 8, 5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    # beside other pytest-xdist workers, a thread per core oversubscribes
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def batch_for(cfg, seed=0, b=B, s=S):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.encoder_layers:
        batch["frames"] = rng.normal(size=(b, 4, cfg.d_model)).astype(
            np.float32)
    if cfg.n_patches:
        batch["patch_embeds"] = rng.normal(
            size=(b, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return batch


def random_cache(cfg, seed=1):
    """One seeded cache in the reference's layout, as numpy."""
    rng = np.random.default_rng(seed)
    struct = RM.cache_struct(cfg, B, SMAX,
                             s_enc=S_ENC if cfg.encoder_layers else 0)
    return jax.tree.map(
        lambda sd: rng.normal(size=sd.shape).astype(np.float32), struct,
        is_leaf=lambda x: isinstance(x, jax.ShapeDtypeStruct))


def close(got, want, what):
    got = jax.tree.map(lambda t: t.detach().numpy(), got)
    got_l, got_def = jax.tree.flatten(got)
    want_l, want_def = jax.tree.flatten(to_np(want))
    assert got_def == want_def, what
    for g, w in zip(got_l, want_l):
        assert g.shape == w.shape, what
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=what)


@pytest.fixture(scope="module")
def families():
    """Per family: its config, the reference's weights and the port's."""
    out = {}
    for arch in RC.ARCHS:
        cfg = RC.smoke_config(arch)
        ref = RM.init_params(jax.random.PRNGKey(0), cfg)
        out[arch] = (cfg, ref, PM.from_reference(to_np(ref),
                                                 PC.smoke_config(arch), "cpu"))
    return out


RECURRENT = {"mamba": ("h", "conv"), "mlstm": ("c", "n", "m"),
             "slstm": ("c", "n", "m", "h")}


def reference_end_state(ref, cfg, tokens):
    """The reference's recurrent states after `tokens`, fed one at a time
    through its `decode_step` from its decode inits (zeros, the xLSTM
    stabiliser at -1e30): what a prefill hands decode."""
    b, s = tokens.shape
    cache = RM.init_cache(cfg, b, s)
    cache = tuple(dict(c, m=jnp.full_like(c["m"], -1e30))
                  if kind in ("mlstm", "slstm") else c
                  for kind, c in zip(cfg.pattern, cache))
    for i in range(s):
        _, cache = RM.decode_step(ref, jnp.asarray(tokens[:, i]), cache,
                                  jnp.int32(i), cfg, RM.Ctx(mesh=None))
    return cache


@pytest.mark.parametrize("arch", RC.ARCHS)
def test_prefill_matches_reference(families, arch):
    """Logits and KV caches against the reference's `prefill`.  The
    recurrent states (Mamba, mLSTM, sLSTM) against the state the
    reference's own decode recurrence reaches over the prompt: the
    reference's prefill hands on its zero placeholder there, the port
    the state after the prompt (ROADMAP Queue 3)."""
    cfg, ref, port = families[arch]
    batch = batch_for(cfg)
    want_logits, want_cache = RM.prefill(
        ref, jax.tree.map(jnp.asarray, batch), cfg, RM.Ctx(mesh=None))
    if any(kind in RECURRENT for kind in cfg.pattern):
        end = reference_end_state(ref, cfg, batch["tokens"])
        want_cache = tuple(
            dict(c, **{k: e[k] for k in RECURRENT.get(kind, ())})
            for kind, c, e in zip(cfg.pattern, want_cache, end))
    got_logits, got_cache = PM.prefill(port, batch, port.cfg, PM.Ctx())
    close(got_logits, want_logits, f"{arch} prefill logits")
    close(got_cache, want_cache, f"{arch} prefill cache")


@pytest.mark.parametrize("arch", RC.ARCHS)
def test_decode_step_matches_reference(families, arch):
    cfg, ref, port = families[arch]
    cache = random_cache(cfg)
    tok = np.array([3, 250], np.int32) % cfg.vocab
    want_logits, want_cache = RM.decode_step(
        ref, jnp.asarray(tok), jax.tree.map(jnp.asarray, cache),
        jnp.int32(POS), cfg, RM.Ctx(mesh=None))
    got_logits, got_cache = PM.decode_step(
        port, tok, jax.tree.map(torch.from_numpy, cache), POS, port.cfg,
        PM.Ctx())
    close(got_logits, want_logits, f"{arch} decode logits")
    close(got_cache, want_cache, f"{arch} decode cache")


@pytest.mark.parametrize("arch", RC.ARCHS)
def test_forward_matches_reference(families, arch):
    cfg, ref, port = families[arch]
    batch = batch_for(cfg, seed=2)
    want = RM.forward_train(ref, jax.tree.map(jnp.asarray, batch), cfg,
                            RM.Ctx(mesh=None))
    got = PM.forward_train(port, batch, port.cfg, PM.Ctx())
    close(got, want, f"{arch} forward logits")


@pytest.mark.parametrize("arch", RC.ARCHS)
def test_configs_equal_reference(arch):
    for get in ("get_config", "smoke_config"):
        want = dataclasses.asdict(getattr(RC, get)(arch))
        got = dataclasses.asdict(getattr(PC, get)(arch))
        assert got == want
    assert PC.shapes_for(arch) == RC.shapes_for(arch)
    assert PC.SKIPS == RC.SKIPS and PC.ARCHS == RC.ARCHS


def test_shapes_equal_reference():
    assert {k: dataclasses.asdict(v) for k, v in PM.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in RM.SHAPES.items()}


@pytest.mark.parametrize("arch", RC.ARCHS)
def test_random_init_has_reference_shapes_and_scales(families, arch):
    """`init_params` draws the reference's tree of shapes and dtypes; the
    leaves the reference fills without its key (norm scales, biases,
    `a_log`, `d_skip`, `f_bias`) are equal (to float32 rounding: `a_log`
    is a `log` of two libraries), and every drawn leaf's spread is the
    reference's within sampling error."""
    cfg, ref, _ = families[arch]
    ref2 = to_np(RM.init_params(jax.random.PRNGKey(1), cfg))
    port = PM.to_reference(PM.init_params(
        PC.smoke_config(arch), torch.Generator().manual_seed(0), "cpu"))
    assert jax.tree.structure(port) == jax.tree.structure(ref2)
    for g, w, w2 in zip(jax.tree.leaves(port), jax.tree.leaves(to_np(ref)),
                        jax.tree.leaves(ref2)):
        assert g.shape == w.shape and g.dtype == w.dtype
        if np.array_equal(w, w2):
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=0)
        else:
            assert w.size >= 128
            assert 0.75 < g.std() / w.std() < 1.33


@pytest.mark.parametrize("arch", ["jamba_v0_1_52b", "xlstm_125m"])
def test_prefill_then_decode_equals_token_by_token(families, arch):
    """`prefill` hands decode the recurrent state the prompt reached: a
    prefill, then greedy decode steps, gives the logits and tokens of
    the prompt fed one token at a time through `decode_step` from the
    recurrences' own start (the decode inits: zeros, the xLSTM
    stabiliser at -1e30), to rtol 1e-5."""
    _, _, port = families[arch]
    cfg = port.cfg
    tokens = np.random.default_rng(9).integers(0, cfg.vocab, (B, 12))
    smax, ctx = 20, PM.Ctx()
    logits, cache = PM.prefill(port, {"tokens": tokens}, cfg, ctx)
    cache = PM.pad_cache(cache, smax)
    step = tuple(dict(c, m=torch.full_like(c["m"], -1e30))
                 if kind in ("mlstm", "slstm") else c
                 for kind, c in zip(cfg.pattern,
                                    PM.init_cache(cfg, B, smax, device="cpu")))
    for i in range(tokens.shape[1]):
        want, step = PM.decode_step(port, tokens[:, i], step, i, cfg, ctx)
    torch.testing.assert_close(logits, want, rtol=1e-5, atol=1e-5)
    for i in range(6):
        tok = logits.argmax(-1)
        assert torch.equal(tok, want.argmax(-1))
        pos = tokens.shape[1] + i
        logits, cache = PM.decode_step(port, tok, cache, pos, cfg, ctx)
        want, step = PM.decode_step(port, tok, step, pos, cfg, ctx)
        torch.testing.assert_close(logits, want, rtol=1e-5, atol=1e-5)
