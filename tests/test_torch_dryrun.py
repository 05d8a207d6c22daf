"""The port's dry run (`repro_torch.launch.dryrun`) on the CPU.

It traces a cell's step as DTensors over a fake world (nothing is
allocated) and counts rank 0's local operations.  Held here: a sharded
matmul's per-device FLOPs exactly (the reference's
`test_cost_analysis_is_per_device`, which needs an 8-device XLA compile
and a slow mark there); a cell's count at its full depth equal to its
1- and 2-repeat extrapolation; the JSON keys equal to the reference's;
the CLI writing one JSON per cell into a directory.
"""
import dataclasses
import json
import os
import re

import pytest
import torch

import repro
import repro_torch.launch.dryrun as D
import repro_torch.launch.mesh as PMESH
from repro_torch.configs import smoke_config
from repro_torch.models.config import SHAPES
from repro_torch.models.sharding import P, place


def test_sharded_matmul_counts_per_device_flops():
    """A P("data", None) @ P(None, "model") product of 256³ on a fake
    (2, 4) mesh: 2·M·K·N / 8 FLOPs a device, no collective."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    m = k = n = 256
    with PMESH.world(8, "fake"):
        mesh = PMESH.make_mesh((2, 4), ("data", "model"))
        with FakeTensorMode():
            a = place(torch.empty(m, k), mesh, P("data", None))
            b = place(torch.empty(k, n), mesh, P(None, "model"))
            with D.counting(D.Cost()) as cost:
                c = a @ b
            assert tuple(c.to_local().shape) == (m // 2, n // 4)
    assert cost.flops == 2 * m * k * n // 8
    assert cost.coll == {}
    # the local operands and result, once each
    assert cost.bytes == 4 * (m // 2 * k + k * n // 4 + m // 2 * n // 4)


def test_counting_leaves_dtensor_as_it_was():
    """The counting block wraps DTensor's propagation and attention only
    while it is open."""
    from torch.distributed.tensor import DTensor

    prop = DTensor._op_dispatcher.sharding_propagator
    before = {n: getattr(prop, n) for n in ("propagate_op_sharding",)
              if hasattr(prop, n)}
    attention = D.A.blockwise_attention
    with D.counting(D.Cost()):
        assert D.A.blockwise_attention is not attention
    assert D.A.blockwise_attention is attention
    for n, fn in before.items():
        assert getattr(prop, n) == fn


def four_repeats(arch):
    cfg = smoke_config(arch)
    return dataclasses.replace(cfg, n_layers=4 * len(cfg.pattern),
                               encoder_layers=min(cfg.encoder_layers, 4))


@pytest.mark.parametrize("arch,shape", [
    ("qwen1_5_0_5b", "train_4k"), ("granite_moe_1b_a400m", "prefill_32k"),
    ("qwen1_5_0_5b", "decode_32k")])
def test_extrapolation_equals_the_full_count(arch, shape):
    """At smoke width with 4 repeats: the count of the full depth equals
    the 1- and 2-repeat probes' linear extrapolation."""
    cfg = four_repeats(arch)
    full = D._measure(D.probe_config(cfg, 4), SHAPES[shape], False)
    extrap = D.measure_cell(arch, shape, multi_pod=False, cfg_override=cfg)
    for key in ("flops", "attn_bytes", "arg_bytes"):
        assert extrap[key] == full[key], key
    assert full["flops"] > 0 and full["coll_total"] > 0
    for key in ("bytes", "coll_total"):
        if SHAPES[shape].kind != "train":
            assert extrap[key] == full[key], key
        else:
            # the backward of a repeat's slice of a stacked leaf fills a
            # gradient of the whole stack, and the repeats' add up (and
            # are reduced): a term quadratic in depth, a few millionths
            # of the step's bytes here
            assert abs(extrap[key] - full[key]) <= 1e-5 * full[key], key


def reference_keys():
    """The keys of the reference's `run_cell` result, read from its
    source (importing it would set XLA's device count)."""
    src = open(os.path.join(repro.__path__[0], "launch", "dryrun.py")).read()
    body = src[src.index("    result = {"):src.index("    return result")]
    keys = set(re.findall(r'"(\w+)":', body))
    roof = open(os.path.join(repro.__path__[0], "launch",
                             "roofline.py")).read()
    terms = roof[roof.index("def roofline_terms"):]
    keys |= set(re.findall(r'terms\["(\w+)"\]', terms))
    keys |= set(re.findall(r'"(\w+_s)":', terms))
    return keys


def test_cell_keys_equal_reference(monkeypatch):
    monkeypatch.setattr(D, "get_config", smoke_config)
    res = D.run_cell("qwen1_5_0_5b", "decode_32k", multi_pod=False)
    assert set(res) == reference_keys()
    assert res["chips"] == 256 and res["mesh"] == "16x16"
    assert set(res["memory"]) >= {"argument_bytes", "output_bytes",
                                  "temp_bytes", "code_bytes"}


def test_cli_writes_one_json_a_cell(tmp_path, monkeypatch, capsys):
    """One smoke cell a shape kind, and a skipped cell."""
    monkeypatch.setattr(D, "get_config", smoke_config)
    cells = [("qwen1_5_0_5b", "train_4k", []),
             ("granite_moe_1b_a400m", "prefill_32k", []),
             ("qwen1_5_0_5b", "decode_32k", ["--multipod"])]
    for arch, shape, extra in cells:
        D.main(["--arch", arch, "--shape", shape, "--out", str(tmp_path)]
               + extra)
    D.main(["--arch", "qwen1_5_0_5b", "--shape", "long_500k", "--out",
            str(tmp_path)])
    assert "SKIP qwen1_5_0_5b long_500k" in capsys.readouterr().out
    names = sorted(os.listdir(tmp_path))
    assert names == sorted(["qwen1_5_0_5b__train_4k__pod.json",
                            "granite_moe_1b_a400m__prefill_32k__pod.json",
                            "qwen1_5_0_5b__decode_32k__multipod.json"])
    for name in names:
        res = json.load(open(tmp_path / name))
        assert set(res) == reference_keys()
        assert res["flops_per_dev"] > 0 and res["bound_s"] > 0
    multi = json.load(open(tmp_path / "qwen1_5_0_5b__decode_32k__multipod.json"))
    assert multi["chips"] == 512 and multi["mesh"] == "2x16x16"
