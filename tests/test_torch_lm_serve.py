"""The port's continuous-batching engine (`repro_torch.serve.batcher`)
against the reference's (`repro.serve.batcher`), on the CPU at smoke
width, with the reference's weights carried across by `from_reference`.

The oracle is the reference's engine serving one request alone
(slots=1): there its slot semantics are sound.  With more slots the
reference's engine is at fault (ROADMAP Queue 3): admission runs a
prompt through the whole batch, which overwrites every live slot's KV
rows and advances their recurrent state, and every slot decodes at the
first live slot's position.  The port's engine gives each request its
alone-tokens at any slot count up to 8.  Tokens are compared exactly.
"""
import jax
import numpy as np
import pytest
import torch

import repro.configs as RC
import repro.models as RM
import repro.serve.batcher as RB
import repro_torch.configs as PC
import repro_torch.launch.serve as launch
import repro_torch.models as PM
import repro_torch.serve.batcher as PB

MAX_LEN = 32
# the fault input: each request alone, and both through the reference's
# engine at slots=2 (qwen smoke, PRNGKey(0), max_new 6, max_len 32)
FAULT_PROMPTS = [[5, 17, 33, 2, 9, 41], [7, 3]]
FAULT_ALONE = [[99, 110, 227, 206, 99, 99, 99],
               [36, 36, 36, 62, 62, 122, 186]]
FAULT_REF_SLOTS2 = [[99, 234, 220, 220, 220, 218, 218],
                    [36, 33, 33, 178, 178, 178, 178]]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    # beside other pytest-xdist workers, a thread per core oversubscribes
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


_MODELS = {}


def models(arch):
    """The reference's smoke weights (PRNGKey(0)) in both packages."""
    if arch not in _MODELS:
        cfg = RC.smoke_config(arch)
        ref = RM.init_params(jax.random.PRNGKey(0), cfg)
        port = PM.from_reference(jax.tree.map(np.asarray, ref),
                                 PC.smoke_config(arch), "cpu")
        _MODELS[arch] = (cfg, ref, port)
    return _MODELS[arch]


def prompts_for(cfg, n=3, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, 2 + 2 * i).astype(np.int32).tolist()
            for i in range(n)]


def serve_ref(arch, prompts, slots, max_new=5):
    cfg, ref, _ = models(arch)
    eng = RB.ServeEngine(ref, cfg, RM.Ctx(mesh=None), slots=slots,
                         max_len=MAX_LEN)
    reqs = [RB.Request(i, np.array(p, np.int32), max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    return [r.out for r in reqs]


def serve_port(arch, prompts, slots, max_new=5, **kw):
    _, _, port = models(arch)
    eng = PB.ServeEngine(port, port.cfg, slots=slots, max_len=MAX_LEN,
                         device="cpu", **kw)
    reqs = [PB.Request(i, np.array(p, np.int32), max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    assert all(r.done for r in reqs)
    return [r.out for r in reqs]


@pytest.mark.parametrize("arch", ["qwen1_5_0_5b", "granite_moe_1b_a400m",
                                  "xlstm_125m", "jamba_v0_1_52b"])
def test_alone_tokens_equal_the_reference(arch):
    cfg = RC.smoke_config(arch)
    for p in prompts_for(cfg, n=2):
        assert serve_port(arch, [p], 1) == serve_ref(arch, [p], 1)


def test_fault_input_gets_the_reference_alone_tokens():
    arch = "qwen1_5_0_5b"
    alone = [serve_ref(arch, [p], 1, max_new=6)[0] for p in FAULT_PROMPTS]
    assert alone == FAULT_ALONE
    # the reference's engine at slots=2 gives other tokens (its fault)
    assert serve_ref(arch, FAULT_PROMPTS, 2, max_new=6) == FAULT_REF_SLOTS2
    for slots in (2, 4):
        assert serve_port(arch, FAULT_PROMPTS, slots, max_new=6) == FAULT_ALONE


@pytest.mark.parametrize("arch", RC.ARCHS)
@pytest.mark.parametrize("slots", [2, 4])
def test_every_request_gets_its_alone_tokens(arch, slots):
    """More requests than slots, so slots are reused and admissions land
    between other slots' decode ticks."""
    cfg = RC.smoke_config(arch)
    prompts = prompts_for(cfg, n=5, seed=slots)
    alone = [serve_port(arch, [p], 1)[0] for p in prompts]
    assert serve_port(arch, prompts, slots) == alone


@pytest.mark.parametrize("arch", ["xlstm_125m", "jamba_v0_1_52b",
                                  "qwen1_5_0_5b"])
def test_a_reused_slot_starts_clean(arch):
    """One slot serving requests one after another: each gets the tokens
    of a fresh engine (the slot's recurrent state and KV rows reset)."""
    cfg = RC.smoke_config(arch)
    prompts = prompts_for(cfg, n=3, seed=7)
    alone = [serve_port(arch, [p], 1)[0] for p in prompts]
    assert serve_port(arch, prompts, 1) == alone


@pytest.mark.parametrize("arch", RC.ARCHS)
def test_decode_step_per_row_positions_equal_scalar_calls(arch):
    """A (B,) position vector equals one scalar-position call a row, to
    float32 rounding (rtol 1e-4, atol 1e-5: a batch of 3 and a batch of
    1 take different matrix-product paths)."""
    _, _, port = models(arch)
    cfg = port.cfg
    rng = np.random.default_rng(3)
    s_enc = 8 if cfg.encoder_layers else 0
    cache = tuple({k: torch.from_numpy(rng.normal(size=v.shape).astype(
        np.float32)) for k, v in c.items()}
        for c in PM.init_cache(cfg, 3, 16, s_enc, "cpu"))
    tok = np.array([1, 7, 200]) % cfg.vocab
    pos = np.array([0, 9, 4])
    ctx = PM.Ctx()
    logits, new = PM.decode_step(port, tok, cache, torch.from_numpy(pos),
                                 cfg, ctx)
    for b in range(3):
        row = tuple({k: v[:, b:b + 1] for k, v in c.items()} for c in cache)
        lb, nb = PM.decode_step(port, tok[b:b + 1], row, int(pos[b]), cfg,
                                ctx)
        torch.testing.assert_close(logits[b:b + 1], lb, rtol=1e-4,
                                   atol=1e-5)
        for c, cb in zip(new, nb):
            for k in c:
                torch.testing.assert_close(c[k][:, b:b + 1], cb[k],
                                           rtol=1e-4, atol=1e-5)


def test_decode_step_refuses_a_position_past_the_cache():
    _, _, port = models("qwen1_5_0_5b")
    cache = PM.init_cache(port.cfg, 2, 8, device="cpu")
    with pytest.raises(IndexError):
        PM.decode_step(port, np.array([1, 2]), cache, torch.tensor([3, 8]),
                       port.cfg, PM.Ctx())


@pytest.mark.parametrize("arch", RC.ARCHS)
def test_weight_round_trip_is_lossless(arch):
    cfg, ref, port = models(arch)
    want = jax.tree.map(np.asarray, ref)
    back = PM.to_reference(port)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    again = PM.from_reference(back, port.cfg, "cpu")
    for (n, a), (m, b) in zip(port.named_parameters(),
                              again.named_parameters()):
        assert n == m and torch.equal(a, b)


def test_parameter_names_are_the_reference_paths():
    _, ref, port = models("jamba_v0_1_52b")
    names = {n for n, _ in port.named_parameters()}
    paths = {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path)
             for path, _ in jax.tree_util.tree_flatten_with_path(ref)[0]}
    assert names == paths


def test_cast_params_holds_one_bf16_copy():
    cfg = PC.smoke_config("qwen1_5_0_5b")
    import dataclasses
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    masters = PM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    copy = PM.cast_params(masters, cfg)
    assert copy is not masters
    assert all(p.dtype == torch.bfloat16 for p in copy.parameters())
    assert all(p.dtype == torch.float32 for p in masters.parameters())
    assert PM.cast_params(copy, cfg) is copy


def test_submit_refuses_a_prompt_that_does_not_fit():
    _, _, port = models("qwen1_5_0_5b")
    eng = PB.ServeEngine(port, port.cfg, slots=1, max_len=8, device="cpu")
    with pytest.raises(ValueError):
        eng.submit(PB.Request(0, np.arange(8), 2))
    with pytest.raises(ValueError):
        eng.submit(PB.Request(0, np.arange(0), 2))


def test_force_and_logits_replay_a_stream():
    """`force` emits the given tokens; `logits` records the logits that
    chose each one, the same as a free run's on the same stream."""
    _, _, port = models("qwen1_5_0_5b")
    free = PB.Request(0, np.array([5, 6, 7]), 4, logits=[])
    eng = PB.ServeEngine(port, port.cfg, slots=2, max_len=MAX_LEN,
                         device="cpu")
    eng.submit(free)
    eng.run_until_drained()
    assert len(free.logits) == len(free.out) == 5
    forced = PB.Request(1, np.array([5, 6, 7]), 4, logits=[],
                        force=free.out)
    eng.submit(forced)
    eng.run_until_drained()
    assert forced.out == free.out
    for a, b in zip(forced.logits, free.logits):
        torch.testing.assert_close(a, b)
        assert a.dtype == torch.float32 and a.shape == (port.cfg.vocab,)


def test_first_max_is_numpy_argmax():
    x = torch.tensor([[1.0, 3.0, 3.0, 0.0], [2.0, 2.0, 2.0, 2.0],
                      [0.0, float("nan"), 5.0, float("nan")]])
    np.testing.assert_array_equal(PB.first_max(x),
                                  np.argmax(x.numpy(), axis=1))
    y = x[:2].bfloat16()
    np.testing.assert_array_equal(PB.first_max(y), [1, 0])


def test_engine_cli_and_weights_want_cuda_unless_cpu_is_asked(monkeypatch, capsys):
    _, _, port = models("qwen1_5_0_5b")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        PB.ServeEngine(port, port.cfg, slots=2, max_len=MAX_LEN)
    with pytest.raises(RuntimeError, match="CUDA"):
        launch.main(["--requests", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        PM.init_params(port.cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        PM.from_reference(PM.to_reference(port), port.cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        PM.init_cache(port.cfg, 1, MAX_LEN)
    assert PM.init_cache(port.cfg, 1, MAX_LEN, device="cpu")[0]["k"] \
        .device == torch.device("cpu")
    eng = PB.ServeEngine(port, port.cfg, slots=2, max_len=MAX_LEN,
                         device="cpu")
    assert eng.device == torch.device("cpu")
    reqs, eng = launch.main(["--device", "cpu", "--requests", "3",
                             "--max-new", "4"])
    out = capsys.readouterr().out
    assert "3 requests, 15 tokens" in out and "on CPU" in out
    assert all(r.done and len(r.out) == 5 for r in reqs)


def test_cli_defaults_are_the_reference_launcher_draw():
    """The port's launcher draws the reference launcher's prompts."""
    cfg = PC.smoke_config("qwen1_5_0_5b")
    rng = np.random.default_rng(0)
    want = [rng.integers(0, cfg.vocab, 4 + int(rng.integers(0, 6)))
            for _ in range(8)]
    got = launch.make_requests(cfg, 8, 12)
    assert [r.prompt.tolist() for r in got] == [w.tolist() for w in want]
    assert all(4 <= len(r.prompt) <= 9 and r.max_new == 12 for r in got)
