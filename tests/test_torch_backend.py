"""TorchBackend against the reference package's NumpyBackend (and, where
the staged semantics differ from the numpy collection walk's, against
JaxBackend), on seeded numpy inputs."""
import numpy as np
import pytest
import torch

from repro.core.backend import JaxBackend, NumpyBackend
from repro_torch.core.backend import TorchBackend

tb = TorchBackend("cpu")
nb = NumpyBackend()


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("n,m", [(0, 5), (1, 4), (37, 50), (500, 1000)])
@pytest.mark.parametrize("width", [None, 3])
def test_take_clamps_like_numpy(n, m, width):
    rng = np.random.default_rng(n * 10 + m)
    shape = (n,) if width is None else (n, width)
    arr = rng.normal(size=shape).astype(np.float32)
    idx = rng.integers(-5, n + 5, m).astype(np.int32)
    np.testing.assert_array_equal(tb.take(T(arr), T(idx)).numpy(),
                                  nb.take(arr, idx))


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("n,segs", [(0, 4), (1, 1), (37, 6), (5000, 130)])
def test_segment_sum(dtype, n, segs):
    rng = np.random.default_rng(n + segs)
    data = (rng.normal(size=n) * 100).astype(dtype)
    ids = rng.integers(0, segs, n).astype(np.int32)
    got = tb.segment_sum(T(data), T(ids), segs).numpy()
    want = nb.segment_sum(data, ids, segs)
    if dtype == np.float32:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("how", ["max", "min"])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("n,segs", [(0, 4), (1, 3), (37, 50), (5000, 130)])
def test_segment_extrema_with_empty_segments(how, dtype, n, segs):
    """Data on the far side of `fill`: both references agree, and empty
    segments (segs > rows for small n) keep the fill."""
    rng = np.random.default_rng(n * 3 + segs)
    data = rng.integers(1, 1000, n).astype(dtype)
    if how == "min":
        data = -data
    ids = rng.integers(0, segs, n).astype(np.int32)
    fill = dtype(0)
    got = getattr(tb, f"segment_{how}")(T(data), T(ids), segs, fill)
    want = getattr(nb, f"segment_{how}")(data, ids, segs, fill)
    np.testing.assert_array_equal(got.numpy(), want)


def test_segment_max_below_fill_follows_staged_semantics():
    """A non-empty segment whose values all lie below `fill` reduces over
    its rows alone (the staged program's semantics; the numpy collection
    walk would fold the fill in)."""
    data = np.array([-5.0, -3.0, -7.0, 2.0], np.float32)
    ids = np.array([0, 0, 2, 3], np.int32)
    got = tb.segment_max(T(data), T(ids), 5, 0.0).numpy()
    want = np.asarray(JaxBackend().segment_max(data, ids, 5, 0.0))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [-3.0, 0.0, -7.0, 2.0, 0.0])


def test_segment_max_2d():
    rng = np.random.default_rng(7)
    data = rng.integers(0, 200, (40, 3)).astype(np.int32)
    ids = rng.integers(0, 9, 40).astype(np.int32)
    np.testing.assert_array_equal(
        tb.segment_max(T(data), T(ids), 9, 0).numpy(),
        nb.segment_max(data, ids, 9, 0))


@pytest.mark.parametrize("n", [1, 37, 5000])
def test_lexsort_matches_numpy(n):
    rng = np.random.default_rng(n)
    k0 = rng.integers(0, 4, n).astype(np.int32)      # least significant
    k1 = rng.normal(size=n).astype(np.float32).round(1)
    k2 = rng.random(n) < 0.3                         # primary (bool)
    got = tb.lexsort([T(k0), T(k1), T(k2)]).numpy()
    np.testing.assert_array_equal(got, nb.lexsort([k0, k1, k2]))


@pytest.mark.parametrize("n", [0, 1, 37, 5000])
@pytest.mark.parametrize("cap", [1, 16, 6000])
@pytest.mark.parametrize("p", [0.0, 0.3, 1.0])
def test_compact_matches_numpy(n, cap, p):
    """count 0 (p=0 or n=0), overflow above cap (p=1, cap < n), padding."""
    rng = np.random.default_rng(n * 13 + cap + int(10 * p))
    mask = rng.random(n) < p
    idx, count = tb.compact(T(mask), cap)
    widx, wcount = nb.compact(mask, cap)
    assert idx.dtype == torch.int32 and idx.shape == (cap,)
    assert int(count) == int(wcount) == int(mask.sum())
    np.testing.assert_array_equal(idx.numpy(), widx)


def test_barrier_is_identity():
    x = T(np.arange(5, dtype=np.int32))
    assert tb.barrier(x) is x
