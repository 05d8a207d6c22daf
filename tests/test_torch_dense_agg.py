"""Dense aggregation over a large key domain on the CPU
(`kernels/dense_agg.py`, `core/operators/agg.py`): which aggregations
take the large-domain entry point, its plain version and its custom
operator's vmap rule against the engine's segment operations, and the
calls it counts.  The kernel itself runs on the card only
(`test_torch_dense_agg_cuda.py`).
"""
import importlib
import types

import numpy as np
import pytest
import torch

from repro_torch.core import CompiledQuery, preset
from repro_torch.core.backend import TorchBackend as BE
from repro_torch.core.expr import col
from repro_torch.core.ir import Agg, AggSpec, Scan
from repro_torch.core.operators import agg as agg_op
from repro_torch.core.operators.base import F32BIG, Binding, Frame
from repro_torch.core.passes.param_binding import bind_plan, plan_params
from repro_torch.kernels import ops
from repro_torch.relational import Database
from repro_torch.relational.queries import (PARAM_ALT_BINDINGS,
                                            PARAM_QUERIES)

kd = importlib.import_module("repro_torch.kernels.dense_agg")

D = agg_op.KERNEL_MAX_GROUPS + 1


@pytest.fixture(scope="module")
def db():
    torch.set_num_threads(1)
    return Database.tpch(sf=0.01, seed=0)


# ---------------------------------------------------------------------------
# which aggregations take the entry point
# ---------------------------------------------------------------------------

def _rule_case(case: str):
    n = 16
    f32 = torch.ones(n, dtype=torch.float32)
    i32 = torch.ones(n, dtype=torch.int32)
    cols = {"k": Binding(i32, "num"), "d": Binding(i32, "num"),
            "b": Binding(-f32, "num")}
    fns = ["sum", "count", "avg"]
    vals = {"s": f32, "a": f32}
    carry = ["d", "b"]
    domain, kernels, part = D, True, None
    if case == "small_domain":
        domain = agg_op.KERNEL_MAX_GROUPS
    elif case in ("min", "max"):
        fns = [case]
    elif case == "char_matrix_carry":
        cols["c"] = Binding(torch.zeros((n, 4), dtype=torch.uint8), "chars")
        carry = ["c"]
    elif case == "partitioned":
        part = "lineitem"
    elif case == "no_kernels":
        kernels = False
    elif case == "int_value":
        vals["s"] = i32
    elif case == "int64_carry":
        cols["d"] = Binding(i32.long(), "num")
    elif case == "nine_carries":
        for k in range(9):
            cols[f"c{k}"] = Binding(i32, "num")
        carry = [f"c{k}" for k in range(9)]
    a = Agg(None, ["k"], [AggSpec(f"x{i}", fn, None if fn == "count"
                                  else col("s")) for i, fn in enumerate(fns)],
            carry=carry, strategy="dense", domains=[domain])
    f = Frame(cols)
    f.part = part
    ctx = types.SimpleNamespace(use_kernels=kernels)
    return a, f, ctx, domain, vals


@pytest.mark.parametrize("case,takes", [
    ("large", True), ("small_domain", False), ("min", False),
    ("max", False), ("char_matrix_carry", False), ("partitioned", False),
    ("no_kernels", False), ("int_value", False), ("int64_carry", False),
    ("nine_carries", False)])
def test_engagement_rule(case, takes):
    """The large-domain kernel takes a dense aggregation past
    KERNEL_MAX_GROUPS of sums, counts and averages of float32 columns
    with 1-D int32 or float32 carries, on the hand-kernel rung, over an
    unsharded frame; everything else keeps its path."""
    a, f, ctx, domain, vals = _rule_case(case)
    assert agg_op._large_domain_kernel_ok(a, f, ctx, domain, vals) is takes


def _orders_plan(fns=("sum", "count", "avg"), carry=("l_shipdate",
                                                       "l_discount")):
    """lineitem by l_orderkey (15,000 keys at sf 0.01, past the small
    domains), with two carries."""
    return Agg(Scan("lineitem"), ["l_orderkey"],
               [AggSpec(f"x{i}", fn, None if fn == "count"
                        else col("l_quantity")) for i, fn in enumerate(fns)],
               carry=list(carry))


@pytest.mark.parametrize("pname,fns,calls", [
    ("opt-pallas", ("sum", "count", "avg"), 1),
    ("opt-pallas", ("count",), 1),
    ("opt-pallas", ("sum", "max"), 0),
    ("opt", ("sum", "count", "avg"), 0),
    ("strdict", ("sum",), 0)])
def test_plans_route_by_the_rule(db, pname, fns, calls):
    """A compiled plan calls the entry point once a run where the rule
    holds, and answers as the same plan at `opt` (no kernels), bit for
    bit: the CPU version is the segment operations."""
    cq = CompiledQuery(_orders_plan(fns), db, preset(pname), device="cpu")
    before = ops.calls["dense_agg"]
    got = cq.run()
    assert ops.calls["dense_agg"] - before == calls
    want = CompiledQuery(_orders_plan(fns), db, preset("opt"),
                         device="cpu").run()
    assert list(got) == list(want)
    # (a rung below opt may group by sorting, which carries a group's
    # first row, not its max: these carries are no function of the key)
    carried = {"l_shipdate", "l_discount"} if pname == "strdict" else set()
    for k in set(want) - carried:
        assert np.array_equal(got[k], want[k]), k


# ---------------------------------------------------------------------------
# the CPU version and the operator's vmap rule
# ---------------------------------------------------------------------------

def _operands(n: int, seed: int, B=None):
    g = torch.Generator().manual_seed(seed)
    lead = () if B is None else (B,)
    mask = torch.rand(*lead, n, generator=g) < 0.6
    gidx = torch.randint(0, D, (*lead, n), generator=g, dtype=torch.int32)
    vals = [torch.rand(*lead, n, generator=g) * 4 - 1 for _ in range(2)]
    cars = [torch.randn(*lead, n, generator=g) * 100,
            torch.randint(-50, 50, (*lead, n), generator=g,
                          dtype=torch.int32)]
    return mask, gidx, vals, cars


def _segment_ops(mask, gidx, vals, cars):
    """The engine's dense branch before the kernel, as it wrote it."""
    mi32 = mask.to(torch.int32)
    sums = [BE.segment_sum(torch.where(mask, v, 0), gidx, D) for v in vals]
    cnt = BE.segment_sum(mi32, gidx, D)
    carried = [BE.segment_max(torch.where(mask, cars[0], -F32BIG), gidx, D,
                              0.0),
               BE.segment_max(torch.where(mask, cars[1], -1).to(torch.int32),
                              gidx, D, 0)]
    return sums, cnt, carried


def _equal(got, want):
    for g, w in zip([*got[0], got[1], *got[2]], [*want[0], want[1],
                                                  *want[2]]):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("n", [0, 1, 1000])
def test_cpu_version_is_the_segment_ops(n):
    mask, gidx, vals, cars = _operands(n, n)
    want = _segment_ops(mask, gidx, vals, cars)
    _equal(kd.dense_agg(mask, gidx, vals, cars, D), want)
    _equal(ops.dense_agg_query(mask, gidx, vals, cars, D), want)
    row = torch.ops.repro_torch.dense_agg(mask, gidx, vals, cars, D)
    assert row.shape == (4 * D + D,) and row.dtype == torch.int32
    _equal(kd.unpack(row, D, 2, kd.kinds(cars)), want)


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("shared", ["none", "mask", "keys_and_values"])
def test_vmap_rule_is_the_segment_ops_a_binding(B, shared):
    """`ops.dense_agg_query` under `torch.func.vmap`: the operator's vmap
    rule (one call of the batched plain version), each binding's slot the
    segment operations on that binding's operands, shared operands read
    by every binding."""
    mask, gidx, vals, cars = _operands(777, 5, B)
    dims = [0, 0, 0, 0, 0]
    if shared == "mask":
        mask, dims[0] = mask[0], None
    if shared == "keys_and_values":
        gidx, vals[0], dims[1], dims[2] = gidx[0], vals[0][0], None, None
    args = [mask, gidx, vals[0], cars[0], cars[1]]
    launched = dict(kd.launches)
    calls = ops.calls["dense_agg"]
    sums, cnt, carried = torch.func.vmap(
        lambda m, g, v, c, i: ops.dense_agg_query(m, g, [v], [c, i], D),
        in_dims=tuple(dims))(*args)
    assert ops.calls["dense_agg"] == calls + 1
    assert kd.launches == launched          # the CPU launches nothing
    for b in range(B):
        def one(t, d):
            return t if d is None else t[b]
        want = _segment_ops(one(mask, dims[0]), one(gidx, dims[1]),
                            [one(vals[0], dims[2])], [cars[0][b],
                                                      cars[1][b]])
        _equal(([sums[0][b]], cnt[b], [carried[0][b], carried[1][b]]), want)


def test_pack_and_unpack_round_trip():
    mask, gidx, vals, cars = _operands(300, 9)
    out = kd.dense_agg_plain(mask, gidx, vals, cars, D)
    row = kd.pack(*out)
    assert row.shape == ((1 + 2 + 2) * D,)
    _equal(kd.unpack(row, D, 2, "fi"), out)
    assert kd.kinds(cars) == "fi"
    assert kd.fits(8, 8) and not kd.fits(9, 0) and not kd.fits(0, 9)


# ---------------------------------------------------------------------------
# calls
# ---------------------------------------------------------------------------

def test_calls_rise_once_a_walk_and_once_a_pass(db):
    """q3 (orders by l_orderkey at sf 0.01, past the small domains): one
    call an eager run, one a batched pass of any number of bindings."""
    build, defaults = PARAM_QUERIES["q3"]
    plan = build()
    spec = plan_params(plan)
    runtime = {k: defaults[k] for k, i in spec.items() if not i.structural}
    plan = bind_plan(plan, {k: defaults[k] for k, i in spec.items()
                            if i.structural})
    cq = CompiledQuery(plan, db, preset("opt-pallas"), device="cpu",
                       params=runtime)
    alt = dict(runtime, **PARAM_ALT_BINDINGS["q3"])
    before = ops.calls["dense_agg"]
    single = [cq.run(runtime), cq.run(alt)]
    assert ops.calls["dense_agg"] == before + 2
    many = cq.run_batched([runtime, alt, runtime, alt])
    assert ops.calls["dense_agg"] == before + 3
    for got, want in zip(many, single + single):
        for k in want:
            assert np.array_equal(got[k], want[k]), k
