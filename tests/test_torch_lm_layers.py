"""The port's model layers (`repro_torch.models.*`) against the
reference's (`repro.models.*`), function by function, on the CPU, on
the same seeded numpy inputs.

None of these functions reaches a Pallas kernel in the reference: they
are plain JAX there and plain torch here.  Tolerance: float32, rtol
1e-4, atol 1e-5 (XLA and torch add in different orders; the Mamba
recurrence runs step by step in the port and as an associative scan in
the reference).  Integer decisions (the MoE's routing and the tokens it
drops) are exact: the outputs of a dropped token are zero on both sides.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
import repro.models.attention as RA
import repro.models.layers as RL
import repro.models.moe as RMOE
import repro.models.ssm as RS
import repro.models.xlstm as RX
import repro_torch.configs as PC
import repro_torch.models.attention as PA
import repro_torch.models.layers as PL
import repro_torch.models.moe as PMOE
import repro_torch.models.ssm as PS
import repro_torch.models.xlstm as PX

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    # beside other pytest-xdist workers, a thread per core oversubscribes
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def rnd(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def T(a):
    return torch.from_numpy(np.array(a))


def J(a):
    return jnp.asarray(a)


def close(got, want, rtol=RTOL, atol=ATOL):
    got = jax.tree.map(lambda t: t.detach().float().numpy(), got)
    want = jax.tree.map(lambda a: np.asarray(a, np.float32), want)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


def params(rng, shapes: dict, scale=0.2):
    """Matching numpy weights for both packages (a dict of arrays, nested
    dicts kept)."""
    return {k: params(rng, v, scale) if isinstance(v, dict)
            else rnd(rng, *v, scale=scale) for k, v in shapes.items()}


def tmap(tree):
    return jax.tree.map(T, tree)


def jmap(tree):
    return jax.tree.map(J, tree)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_rms_norm():
    rng = np.random.default_rng(0)
    x, s = rnd(rng, 3, 5, 64, scale=3.0), rnd(rng, 64)
    close(PL.rms_norm(T(x), T(s)), RL.rms_norm(J(x), J(s)))


def test_rms_norm_bf16_casts_back_before_scaling():
    rng = np.random.default_rng(1)
    x, s = rnd(rng, 4, 64, scale=3.0), rnd(rng, 64)
    got = PL.rms_norm(T(x).bfloat16(), T(s).bfloat16())
    want = RL.rms_norm(J(x).astype(jnp.bfloat16), J(s).astype(jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    # one bf16 rounding of the normalised value, one of the product
    close(got, want, rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("fraction", [1.0, 0.5, 0.0])
@pytest.mark.parametrize("hd", [16, 10])
def test_apply_rope(fraction, hd):
    rng = np.random.default_rng(2)
    x = rnd(rng, 2, 7, 3, hd)
    pos = np.arange(7) + 11
    close(PL.apply_rope(T(x), T(pos), theta=1e6, fraction=fraction),
          RL.apply_rope(J(x), J(pos), theta=1e6, fraction=fraction))


def test_apply_rope_per_row_positions():
    """(B, 1) positions (the port's decode) against the reference at each
    row's scalar position."""
    rng = np.random.default_rng(3)
    x = rnd(rng, 3, 1, 4, 16)
    pos = np.array([0, 5, 17])
    got = PL.apply_rope(T(x), T(pos[:, None]))
    for b in range(3):
        close(got[b:b + 1], RL.apply_rope(J(x[b:b + 1]), J(pos[b:b + 1])))


def test_rope_freqs_is_the_reference_array():
    np.testing.assert_array_equal(PL.rope_freqs(64, 1e6),
                                  RL.rope_freqs(64, 1e6))


@pytest.mark.parametrize("kind", ["swiglu", "gelu"])
def test_mlp(kind):
    rng = np.random.default_rng(4)
    p = params(rng, {"w_gate": (32, 48), "w_up": (32, 48),
                     "w_down": (48, 32)})
    if kind == "gelu":
        del p["w_gate"]
    x = rnd(rng, 2, 5, 32)
    close(PL.mlp_apply(T(x), tmap(p), kind), RL.mlp_apply(J(x), jmap(p), kind))


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

ATTN_CASES = {
    # name: (B, S, H, Hkv, dk, dv, causal, window, q_block, kv_block)
    "causal": (2, 16, 4, 4, 8, 8, True, None, 4, 8),
    "windowed": (2, 16, 4, 4, 8, 8, True, 5, 4, 4),
    "gqa": (1, 12, 6, 2, 8, 12, True, None, 4, 6),
    "bidirectional": (2, 9, 4, 2, 8, 8, False, None, 256, 512),
    # 17 is prime: both blocks fall back to a divisor (1)
    "divisor_fallback": (1, 17, 2, 1, 8, 8, True, None, 4, 8),
    # 12 tokens at q_block 8 / kv_block 5: blocks of 6 and 4
    "uneven_blocks": (1, 12, 2, 2, 8, 8, True, 7, 8, 5),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_blockwise_attention(case):
    b, s, h, hkv, dk, dv, causal, window, qb, kb = ATTN_CASES[case]
    rng = np.random.default_rng(5)
    q, k, v = rnd(rng, b, s, h, dk), rnd(rng, b, s, hkv, dk), \
        rnd(rng, b, s, hkv, dv)
    kw = dict(causal=causal, window=window, q_block=qb, kv_block=kb)
    close(PA.blockwise_attention(T(q), T(k), T(v), **kw),
          RA.blockwise_attention(J(q), J(k), J(v), **kw))


@pytest.mark.parametrize("case", ["causal", "windowed", "gqa"])
def test_naive_attention(case):
    b, s, h, hkv, dk, dv, causal, window, _, _ = ATTN_CASES[case]
    rng = np.random.default_rng(6)
    q, k, v = rnd(rng, b, s, h, dk), rnd(rng, b, s, hkv, dk), \
        rnd(rng, b, s, hkv, dv)
    kw = dict(causal=causal, window=window)
    close(PA.naive_attention(T(q), T(k), T(v), **kw),
          RA.naive_attention(J(q), J(k), J(v), **kw))
    # the unrolled blockwise form is the naive one
    close(PA.blockwise_attention(T(q), T(k), T(v), unroll=True, **kw),
          RA.naive_attention(J(q), J(k), J(v), **kw))


@pytest.mark.parametrize("window", [None, 3])
@pytest.mark.parametrize("hkv", [4, 2])
def test_decode_attention(window, hkv):
    rng = np.random.default_rng(7)
    q, kc, vc = rnd(rng, 3, 4, 8), rnd(rng, 3, 10, hkv, 8), \
        rnd(rng, 3, 10, hkv, 6)
    close(PA.decode_attention(T(q), T(kc), T(vc), 6, window=window),
          RA.decode_attention(J(q), J(kc), J(vc), 6, window=window))
    # one length a row: each row as the reference at its own length
    lens = np.array([1, 6, 10])
    got = PA.decode_attention(T(q), T(kc), T(vc), T(lens), window=window)
    for r in range(3):
        close(got[r:r + 1], RA.decode_attention(
            J(q[r:r + 1]), J(kc[r:r + 1]), J(vc[r:r + 1]), int(lens[r]),
            window=window))


def test_mla_decode_scores():
    rng = np.random.default_rng(8)
    qa, qpe = rnd(rng, 2, 4, 16), rnd(rng, 2, 4, 8)
    ckv, kpe = rnd(rng, 2, 9, 16), rnd(rng, 2, 9, 8)
    close(PA.mla_decode_scores(T(qa), T(qpe), T(ckv), T(kpe), 5, 0.2),
          RA.mla_decode_scores(J(qa), J(qpe), J(ckv), J(kpe), 5, 0.2))
    lens = np.array([2, 9])
    got = PA.mla_decode_scores(T(qa), T(qpe), T(ckv), T(kpe), T(lens), 0.2)
    for r in range(2):
        close(got[r:r + 1], RA.mla_decode_scores(
            J(qa[r:r + 1]), J(qpe[r:r + 1]), J(ckv[r:r + 1]),
            J(kpe[r:r + 1]), int(lens[r]), 0.2))


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def moe_params(rng, d, f, e, shared: bool):
    shapes = {"w_router": (d, e), "w_gate": (e, d, f), "w_up": (e, d, f),
              "w_down": (e, f, d)}
    if shared:
        shapes["shared"] = {"w_gate": (d, 2 * f), "w_up": (d, 2 * f),
                            "w_down": (2 * f, d)}
    return params(rng, shapes, scale=0.3)


@pytest.mark.parametrize("n,topk,e,capacity,shared", [
    (6, 2, 4, 8, False),      # every assignment fits
    (24, 2, 4, 8, True),      # 48 assignments into 4 x 8 slots: drops
    (40, 1, 4, 8, False),     # top-1, most tokens dropped
    (16, 3, 8, 8, True),
])
def test_moe_local(n, topk, e, capacity, shared):
    rng = np.random.default_rng(n + topk)
    p = moe_params(rng, 16, 12, e, shared)
    x = rnd(rng, n, 16)
    got = PMOE._moe_local(T(x), tmap(p), topk=topk, capacity=capacity)
    want = RMOE._moe_local(J(x), jmap(p), topk=topk, capacity=capacity,
                           tp_axis=None)
    close(got, want)


def test_moe_local_drops_the_same_tokens():
    """Capacity overflow: the tokens each expert keeps are its first
    `capacity` in token order (a stable sort), the same on both sides.
    Without the shared expert a token every expert dropped is all zero."""
    rng = np.random.default_rng(9)
    n, topk, e, cap = 32, 1, 2, 8
    p = moe_params(rng, 16, 12, e, shared=False)
    x = rnd(rng, n, 16)
    got = PMOE._moe_local(T(x), tmap(p), topk=topk, capacity=cap).numpy()
    want = np.asarray(RMOE._moe_local(J(x), jmap(p), topk=topk, capacity=cap,
                                      tp_axis=None))
    dropped_got = np.all(got == 0, axis=1)
    dropped_want = np.all(want == 0, axis=1)
    assert dropped_want.sum() == n - e * cap
    np.testing.assert_array_equal(dropped_got, dropped_want)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_top_k_breaks_ties_to_the_lower_index():
    x = np.array([[0.2, 0.5, 0.5, 0.1, 0.5], [1.0, 1.0, 1.0, 1.0, 1.0]],
                 np.float32)
    vals, ids = PMOE.top_k(T(x), 2)
    want_v, want_i = jax.lax.top_k(J(x), 2)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(want_v))


def test_moe_ffn_capacity():
    cfg = PC.smoke_config("granite_moe_1b_a400m")
    rcfg = RC.smoke_config("granite_moe_1b_a400m")
    rng = np.random.default_rng(10)
    p = moe_params(rng, cfg.d_model, cfg.moe_d_ff, cfg.n_experts, False)
    x = rnd(rng, 2, 9, cfg.d_model)
    for n in (1, 8, 18, 100):
        assert PMOE.capacity(cfg, n) == max(
            8, -(-int(np.ceil(2.0 * n * cfg.topk / cfg.n_experts)) // 8) * 8)
    from repro.models.sharding import Ctx as RCtx
    from repro_torch.models.sharding import Ctx
    close(PMOE.moe_ffn(T(x), tmap(p), cfg, Ctx()),
          RMOE.moe_ffn(J(x), jmap(p), rcfg, RCtx(mesh=None)))


# ---------------------------------------------------------------------------
# Mamba
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jamba():
    cfg = RC.smoke_config("jamba_v0_1_52b")
    p = RS.mamba_init(jax.random.PRNGKey(3), cfg, jnp.float32)
    # a non-zero conv bias, dt bias and skip, so every term is exercised
    rng = np.random.default_rng(11)
    p = jax.tree.map(np.asarray, p)
    p["conv_b"] = rnd(rng, *p["conv_b"].shape, scale=0.1)
    p["dt_bias"] = rnd(rng, *p["dt_bias"].shape, scale=0.5)
    p["d_skip"] = rnd(rng, *p["d_skip"].shape)
    return cfg, PC.smoke_config("jamba_v0_1_52b"), p


@pytest.mark.parametrize("s", [16, 32])
def test_mamba_forward(jamba, s):
    rcfg, cfg, p = jamba
    x = rnd(np.random.default_rng(s), 2, s, cfg.d_model)
    close(PS.mamba_forward(T(x), tmap(p), cfg),
          RS.mamba_forward(J(x), jmap(p), rcfg))


def test_mamba_decode_steps_equal_the_forward(jamba):
    rcfg, cfg, p = jamba
    rng = np.random.default_rng(12)
    x = rnd(rng, 2, 5, cfg.d_model)
    st = PS.mamba_decode_init(cfg, 2, torch.float32)
    rst = RS.mamba_decode_init(rcfg, 2, jnp.float32)
    ys = []
    for t in range(5):
        y, st = PS.mamba_decode(T(x[:, t]), st, tmap(p), cfg)
        ry, rst = RS.mamba_decode(J(x[:, t]), rst, jmap(p), rcfg)
        close((y, st), (ry, rst))
        ys.append(y)
    close(torch.stack(ys, 1), RS.mamba_forward(J(np.pad(
        x, ((0, 0), (0, 11), (0, 0)))), jmap(p), rcfg)[:, :5])


# ---------------------------------------------------------------------------
# xLSTM
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def xl():
    cfg = RC.smoke_config("xlstm_125m")
    m = jax.tree.map(np.asarray, RX.mlstm_init(jax.random.PRNGKey(4), cfg,
                                               jnp.float32))
    s = jax.tree.map(np.asarray, RX.slstm_init(jax.random.PRNGKey(5), cfg,
                                               jnp.float32))
    s["b"] = rnd(np.random.default_rng(13), *s["b"].shape, scale=0.5)
    return cfg, PC.smoke_config("xlstm_125m"), m, s


def test_mlstm_forward_and_parallel(xl):
    rcfg, cfg, m, _ = xl
    x = rnd(np.random.default_rng(14), 2, 10, cfg.d_model)
    want = RX.mlstm_forward(J(x), jmap(m), rcfg)
    close(PX.mlstm_forward(T(x), tmap(m), cfg), want)
    close(PX.mlstm_parallel(T(x), tmap(m), cfg),
          RX.mlstm_parallel(J(x), jmap(m), rcfg))


def test_mlstm_decode(xl):
    rcfg, cfg, m, _ = xl
    rng = np.random.default_rng(15)
    st = PX.mlstm_decode_init(cfg, 2)
    rst = RX.mlstm_decode_init(rcfg, 2, None)
    close(st, rst)
    for _ in range(4):
        x = rnd(rng, 2, cfg.d_model)
        y, st = PX.mlstm_decode(T(x), st, tmap(m), cfg)
        ry, rst = RX.mlstm_decode(J(x), rst, jmap(m), rcfg)
        close((y, st), (ry, rst))


def test_slstm_forward_and_decode(xl):
    rcfg, cfg, _, s = xl
    rng = np.random.default_rng(16)
    x = rnd(rng, 2, 7, cfg.d_model)
    close(PX.slstm_forward(T(x), tmap(s), cfg),
          RX.slstm_forward(J(x), jmap(s), rcfg))
    st = PX.slstm_decode_init(cfg, 2)
    rst = RX.slstm_decode_init(rcfg, 2, None)
    close(st, rst)
    for t in range(3):
        y, st = PX.slstm_decode(T(x[:, t]), st, tmap(s), cfg)
        ry, rst = RX.slstm_decode(J(x[:, t]), rst, jmap(s), rcfg)
        close((y, st), (ry, rst))
