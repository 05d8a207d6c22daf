"""The CUDA kernels against their plain torch versions, on the card.

Run on a machine with an NVIDIA Hopper card and nvcc:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Without CUDA every test here skips (the decision is taken inside the
`cuda` fixture, never at import).  Integer outputs must match exactly;
float sums within rtol 1e-3, atol 1e-3 (the kernels and `index_add_` add
in different orders).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import CompiledQuery, preset
from repro_torch.core.expr import And, Cmp, Col, CodeIn, Const, Param
from repro_torch.core.operators import fused as fu
from repro_torch.kernels import compact as kc
from repro_torch.kernels import filter_agg as kf
from repro_torch.relational import Database
from repro_torch.relational.queries import QUERIES
from test_queries import SORT_INSENSITIVE, assert_same

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _same(got, want):
    for g, w in zip(got, want):
        if g.dtype.is_floating_point:
            torch.testing.assert_close(g, w, rtol=1e-3, atol=1e-3)
        else:
            assert torch.equal(g, w)


@pytest.mark.parametrize("n", [1, 37, 5000, 1 << 20])
@pytest.mark.parametrize("p", [0.0, 0.3, 1.0])
@pytest.mark.parametrize("translate", [False, True])
def test_compact_kernel(cuda, n, p, translate):
    rng = np.random.default_rng(n + int(10 * p))
    mask = torch.from_numpy(rng.random(n) < p).to(cuda)
    before = kc.launches["compact"]
    for cap in (1, 64, n // 2 + 1, n + 7):
        _same(kc.compact(mask, cap, translate=translate),
              kc.compact_plain(mask, cap, translate))
    assert kc.launches["compact"] == before + 4


@pytest.mark.parametrize("n", [1, 37, 5000, 1 << 20])
@pytest.mark.parametrize("G", [1, 7, 130, 4096])
def test_filter_agg_kernel(cuda, n, G):
    rng = np.random.default_rng(n + G)
    mask = torch.from_numpy(rng.random(n) < 0.6).to(cuda)
    gidx = torch.from_numpy(rng.integers(-1, G + 1, n).astype(np.int32)
                            ).to(cuda)
    vals = [torch.from_numpy(rng.normal(size=n).astype(np.float32)).to(cuda)
            for _ in range(2)]
    _same(kf.filter_agg(mask, gidx, vals, G),
          kf.filter_agg_plain(mask, gidx, vals, G))


def _pred():
    return And(And(Cmp(">=", Col("f0"), Const(0.05)),
                   Cmp("<=", Col("f0"), Const(0.07))),
               And(Cmp("<", Col("f1"), Param("qty", "float32")),
                   CodeIn("c0", (1, 3))))


def _cols(n, dev):
    rng = np.random.default_rng(n)
    cols = {"c0": rng.integers(0, 7, n).astype(np.int32),
            "f0": (rng.integers(0, 11, n) / 100.0).astype(np.float32),
            "f1": rng.integers(1, 51, n).astype(np.float32)}
    return {k: torch.from_numpy(v).to(dev) for k, v in cols.items()}


@pytest.mark.parametrize("n", [1, 37, 5000, 1 << 20])
def test_generated_kernels(cuda, n):
    cols = _cols(n, cuda)
    pred = fu.TileFn(_pred(), ["qty"])
    vals = [fu.TileFn(Col("f0"), ["qty"])]
    gidx = fu.GroupIndex([("c0", 7, 1)], 7)
    for qty in (24.0, 30.5):            # rebinding reuses one build
        for cap in (1, n + 1):
            _same(kc.compact_pred(cols, [qty], pred, cap, translate=True),
                  kc.compact_pred_plain(cols, [qty], pred, cap, True))
        _same(kf.selective_filter_agg(cols, [qty], pred, vals, gidx, 7),
              kf.selective_filter_agg_plain(cols, [qty], pred, vals, gidx,
                                            7))
    assert len(kc._PRED_LIBS) >= 1 and len(kf._GEN_LIBS) >= 1


def test_cuda_tensor_never_takes_plain_path(cuda):
    """A kernel that cannot take its input raises instead of falling back."""
    mask = torch.ones(10, dtype=torch.bool, device=cuda)
    with pytest.raises(TypeError):
        kc.compact(mask.to(torch.uint8), 4)
    with pytest.raises(ValueError):
        kf.filter_agg(mask, torch.zeros(10, dtype=torch.int32, device=cuda),
                      [torch.ones(10, device=cuda)], 70000)


@pytest.fixture(scope="module")
def sdb():
    return Database.tpch(sf=0.05, seed=0)


@pytest.mark.parametrize("pname", ["opt", "opt-pallas"])
@pytest.mark.parametrize("qname", ["q1", "q3", "q5", "q6", "q9", "q10",
                                   "q12", "q13", "q14", "q17", "q18",
                                   "q19"])
def test_query_on_card_matches_cpu(cuda, sdb, qname, pname):
    """Every query the port runs, on the card against the port's CPU
    answer (sf 0.05)."""
    want = CompiledQuery(QUERIES[qname](), sdb, preset(pname),
                         device="cpu").run()
    cq = CompiledQuery(QUERIES[qname](), sdb, preset(pname))
    assert_same(cq.run(), want, qname in SORT_INSENSITIVE)
    assert cq.n_overflows == 0
