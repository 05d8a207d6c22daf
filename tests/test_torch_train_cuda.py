"""The training path on the card against the CPU, for Qwen at smoke
width (float32, TF32 off): the same weights (seed 0) and batches on both
devices give the same loss and gradients, and the same state after two
`train_step`s, the second with accum=2 and int8 compression on.

Run on a machine with an NVIDIA card:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_train_cuda.py

Without CUDA every test here skips (decided inside the `cuda` fixture).
Tolerances: those of `tests/test_torch_train.py`, with the exceptions
`repro_torch.train.compare` sets out.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.models import Ctx, cast_params, init_params
from repro_torch.train.compare import compare_grads, compare_states
from repro_torch.train.grad_compression import ef_init
from repro_torch.train.optimizer import AdamConfig
from repro_torch.train.train_step import (make_train_state, train_step,
                                          value_and_grad)
from repro_torch.models.tree import leaves

pytestmark = pytest.mark.cuda

QWEN = "qwen1_5_0_5b"
OPT = AdamConfig(warmup=1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = before


def batches(cfg, n=2, b=2, s=16):
    rng = np.random.default_rng(0)
    return [{"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
             "targets": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
            for _ in range(n)]


def models(cuda):
    cfg = smoke_config(QWEN)
    host = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    return cfg, host, cast_params(host, cfg, cuda)


def test_qwen_loss_and_grads_on_card_match_cpu(cuda):
    cfg, host, card = models(cuda)
    b = batches(cfg)[0]
    loss_c, grads_c = value_and_grad(card, b, cfg, Ctx())
    loss_h, grads_h = value_and_grad(host, b, cfg, Ctx())
    assert loss_c.device.type == "cuda"
    np.testing.assert_allclose(float(loss_c), float(loss_h), rtol=1e-4)
    compare_grads(grads_c, grads_h, "qwen grads")


def test_qwen_two_steps_on_card_match_cpu(cuda):
    cfg, host, card = models(cuda)
    b1, b2 = batches(cfg)
    states = []
    for params in (card, host):
        st, _ = train_step(make_train_state(params), b1, cfg, Ctx(), OPT)
        first = st
        st, m = train_step(st._replace(ef=ef_init(st.params)), b2, cfg,
                           Ctx(), OPT, accum=2)
        states.append((first, st, m))
    assert states[0][1].params.embed.device.type == "cuda"
    first = compare_states(states[0][0], states[1][0], OPT, what="step 1")
    halves = [leaves(value_and_grad(states[1][0].params,
                                    {k: v[i:i + 1] for k, v in b2.items()},
                                    cfg, Ctx())[1]) for i in range(2)]
    scale = [float(((a + b) / 2).abs().max()) for a, b in zip(*halves)]
    compare_states(states[0][1], states[1][1], OPT, before=first,
                   grad_scale=scale, what="step 2")
    np.testing.assert_allclose(float(states[0][2]["loss"]),
                               float(states[1][2]["loss"]), rtol=1e-4)


def test_qwen_full_width_bf16_step_on_card(cuda):
    """One step of the launcher's configuration at full width in bf16:
    a finite loss near ln(vocab) from random weights, float32 masters
    and moments on the card, the params moved."""
    cfg = get_config(QWEN)
    params = init_params(cfg, torch.Generator().manual_seed(0), cuda)
    state = make_train_state(params)
    b = batches(cfg, n=1, b=2, s=64)[0]
    new, m = train_step(state, b, cfg, Ctx(), AdamConfig(warmup=10))
    loss = float(m["loss"])
    assert np.isfinite(loss) and abs(loss - np.log(cfg.vocab)) < 1.0
    assert all(p.dtype == torch.float32 and p.device.type == "cuda"
               for p in new.params.parameters())
    assert not torch.equal(new.params.embed, state.params.embed)
