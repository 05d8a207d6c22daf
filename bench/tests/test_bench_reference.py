"""The benchmark's frozen generator and plain reference against the port.

The generator has to draw the port's arrays bit for bit, and the
reference has to give the port's CPU answers, for every plan and for
bindings drawn as the cells draw them.  These tests may import the port;
the reference and the generator may not (test_bench_imports.py).
"""
import numpy as np
import pytest
import torch

from bench import compare, manifest, reference, tpchgen
from repro_torch.core import CompiledQuery, preset
from repro_torch.core.passes.param_binding import bind_plan, plan_params
from repro_torch.relational import Database
from repro_torch.relational.queries import PARAM_QUERIES, QUERIES
from repro_torch.relational.tpch import generate

SEED = 0
SF = 0.01


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def arrays():
    return tpchgen.generate(SF, SEED)


@pytest.fixture(scope="module")
def db(arrays):
    return Database.from_arrays(arrays)


@pytest.fixture(scope="module")
def ref(arrays):
    return reference.Reference(arrays, "cpu")


@pytest.mark.parametrize("sf,seed", [(SF, SEED), (0.02, 2**31 + 5)])
def test_generator_is_the_ports_bit_for_bit(sf, seed):
    ours = tpchgen.generate(sf, seed)
    theirs = generate(sf, seed)
    assert set(ours) == set(theirs)
    for name, table in theirs.items():
        assert set(ours[name]["columns"]) == set(table.data)
        for col, want in table.data.items():
            got = ours[name]["columns"][col]
            assert got.dtype == want.dtype and np.array_equal(got, want), \
                (name, col)
        for part, want in (("vocabs", table.vocabs),
                           ("word_vocabs", table.word_vocabs)):
            assert set(ours[name][part]) == set(want)
            for col, v in want.items():
                assert np.array_equal(ours[name][part][col], v), (name, col)


def _judge(got, want, q, params=None):
    return compare.judge(got, want, reference.SORT[q],
                         reference.FLOAT_COLUMNS[q],
                         reference.limit(q, params))


@pytest.mark.parametrize("q", sorted(QUERIES))
def test_reference_matches_the_ports_answer(db, ref, q):
    got = CompiledQuery(QUERIES[q](), db, preset("opt-pallas"),
                        device="cpu").run()
    why, gap = _judge(got, ref.answer(q), q)
    assert why is None
    assert gap < 1e-5


def _drawn(q: str, n: int, seed: int) -> list:
    """`n` bindings of template `q`, drawn as the power stream draws them."""
    cell = manifest.load("adhoc-power")
    specs = cell.traffic["params"][q]
    rng = np.random.default_rng(seed)
    return [cell.generator.draw_params(specs, rng) for _ in range(n)]


@pytest.mark.parametrize("q", sorted(PARAM_QUERIES))
def test_reference_matches_the_ports_templates(db, ref, q):
    build, defaults = PARAM_QUERIES[q]
    plan = build()
    spec = plan_params(plan)
    fixed = {n: defaults[n] for n, i in spec.items() if i.structural}
    runtime = {n: defaults[n] for n, i in spec.items() if not i.structural}
    cq = CompiledQuery(bind_plan(plan, fixed), db, preset("opt-pallas"),
                       params=runtime, device="cpu")
    bindings = _drawn(q, 4, 7)
    answers = cq.run_many([{k: v for k, v in b.items() if k not in fixed}
                           for b in bindings])
    for b, got in zip(bindings, answers):
        why, gap = _judge(got, ref.answer(q, b), q, b)
        assert why is None, b
        assert gap < 1e-5


def test_judge_finds_each_kind_of_fault(db, ref):
    got = CompiledQuery(QUERIES["q3"](), db, preset("opt-pallas"),
                        device="cpu").run()
    want = ref.answer("q3")
    assert _judge(got, want, "q3") == (None, pytest.approx(0, abs=1e-5))
    dropped = {k: v[1:] for k, v in got.items()}
    assert "rows" in _judge(dropped, want, "q3")[0]
    swapped = {k: v[[1, 0, *range(2, len(v))]] for k, v in got.items()}
    assert "order" in _judge(swapped, want, "q3")[0]
    other = dict(got, l_orderkey=got["l_orderkey"] + 1)
    assert "not the reference's" in _judge(other, want, "q3")[0]
    scaled = dict(got, revenue=got["revenue"] * np.float32(1.01))
    why, gap = _judge(scaled, want, "q3")
    assert why is None and gap == pytest.approx(0.01, rel=1e-3)
