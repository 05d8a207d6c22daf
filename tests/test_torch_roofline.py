"""The port's roofline module (`repro_torch.launch.roofline`) against the
reference's (`repro.launch.roofline`) and the port's models, on the CPU.

`param_count` and `model_flops` are the reference's formulas, so they
equal its numbers exactly for every full config and shape; the analytic
count stands against the port's `LM.parameters()` at smoke width with
the reference test's tolerance.  The machine constants are the H100's
(data sheet), so `roofline_terms` is checked at them.
"""
import textwrap

import pytest
import torch

import repro.configs as RC
import repro.launch.roofline as RR
import repro_torch.configs as PC
import repro_torch.launch.roofline as R
from repro.models.config import SHAPES as RR_SHAPES
from repro_torch.models import SHAPES, init_params


@pytest.mark.parametrize("arch", RC.ARCHS)
def test_param_count_matches_the_ports_model(arch):
    cfg = PC.smoke_config(arch)
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    real = sum(p.numel() for p in model.parameters())
    est = R.param_count(cfg)
    tol = 0.05 * real + 20 * cfg.d_model * (cfg.n_layers
                                            + cfg.encoder_layers + 2)
    assert abs(est - real) < tol, (arch, est, real)


@pytest.mark.parametrize("arch", RC.ARCHS)
def test_counts_equal_the_reference(arch):
    for get in ("get_config", "smoke_config"):
        cfg, ref_cfg = getattr(PC, get)(arch), getattr(RC, get)(arch)
        for active in (False, True):
            assert R.param_count(cfg, active) == RR.param_count(ref_cfg,
                                                                active)
        for name, shape in SHAPES.items():
            ref_shape = RR_SHAPES[name]
            assert R.model_flops(cfg, shape) == RR.model_flops(ref_cfg,
                                                               ref_shape)
            for chips in (1, 4):
                for fn in ("flash_bytes", "slstm_correction_flops",
                           "analytic_hbm_bytes"):
                    assert getattr(R, fn)(cfg, shape, chips) == getattr(
                        RR, fn)(ref_cfg, ref_shape, chips), (fn, name)


def test_model_flops_moe_uses_active():
    cfg = PC.get_config("deepseek_v2_236b")
    shape = SHAPES["train_4k"]
    total = R.param_count(cfg)
    active = R.param_count(cfg, active_only=True)
    assert active < 0.25 * total        # 236B total / ~21B active + embeds
    assert R.model_flops(cfg, shape) == pytest.approx(
        6 * active * shape.global_batch * shape.seq_len)


def test_qwen_train_step_bound():
    """The train step's compute bound at the launcher's shape (batch 8 x
    sequence 64): 6 N D over the H100's bf16 peak."""
    from repro_torch.models.config import ShapeConfig

    cfg = PC.get_config("qwen1_5_0_5b")
    shape = ShapeConfig("train_launcher", "train", 64, 8)
    flops = R.model_flops(cfg, shape)
    assert flops == 6 * R.param_count(cfg) * 512
    assert flops / R.PEAK_FLOPS == pytest.approx(flops / 989e12)


def test_roofline_terms_at_the_h100_constants():
    assert (R.PEAK_FLOPS, R.HBM_BW, R.NVLINK_BW) == (989e12, 3.35e12, 450e9)
    t = R.roofline_terms(989e12, 3.35e12 * 2, 0.0, 1)
    assert t["bottleneck"] == "memory_s"
    assert t["roofline_fraction"] == pytest.approx(0.5)
    assert t["bound_s"] == pytest.approx(2.0)
    t = R.roofline_terms(0.0, 0.0, 450e9 * 3, 1)
    assert t["bottleneck"] == "collective_s"
    assert t["collective_s"] == pytest.approx(3.0)


def test_collective_parser_operand_bytes():
    hlo = textwrap.dedent("""\
      %dot = f32[256,512]{1,0} dot(%a, %b), lhs_contracting_dims={1}
      %all-reduce = f32[256,512]{1,0} all-reduce(%dot), channel_id=1
      %ag = bf16[64,64]{1,0} all-gather(%small), dimensions={0}
      %small = bf16[8,64]{1,0} add(%x, %y)
    """)
    out = R.collective_bytes(hlo)
    assert out["all-reduce"] == 256 * 512 * 4
    assert out["all-gather"] == 8 * 64 * 2          # operand, not result
    assert out["total"] == out["all-reduce"] + out["all-gather"]
    assert out == RR.collective_bytes(hlo)
