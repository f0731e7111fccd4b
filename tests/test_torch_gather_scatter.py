"""Port parity: the gather and scatter utilities (torch) vs the JAX package.

* ``gather.table_take`` twin (kernel B9): bit for bit with JAX
  ``table_take`` on its XLA path and on its Pallas kernel in interpret
  mode (N = 65,536, the kernel's smallest size); ids outside the table
  give zeros.
* ``scatter.scatter_add_by_id`` twin (kernel B10): within 1 float32 ulp
  of float64 ``np.add.at`` sums (it sums in float64 and rounds once),
  with out-of-range ids and a hot row of 150,000 entries; and within
  3e-5 of the scale of JAX ``scatter_add_by_id``
  (tests/test_gather_scatter.py's bar for the JAX kernel's bf16 hi/lo
  split). The kernel's per-chunk partials (``scatter.chunk_partials_plain``,
  their plain twin) on coherent, random, hot-row and wide cases: every
  live column in one (id, chunk) partial, id sums within 1 ulp, and
  within JAX's bar of its Pallas kernel.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvdiffrast_tpu.ops import gather as jg
from nvdiffrast_tpu.ops import scatter as js
from nvdiffrast_tpu_torch.ops import gather as tg
from nvdiffrast_tpu_torch.ops import scatter as ts


def _ulps(a, b):
    """Distance in float32 ulps (same-sign values; zeros of either sign)."""
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    a = np.where(a < 0, -(a & 0x7FFFFFFF), a)
    b = np.where(b < 0, -(b & 0x7FFFFFFF), b)
    return np.abs(a - b)


@pytest.mark.parametrize("impl,K,T,N", [("xla", 9, 300, 5000),
                                         ("pallas_interpret", 9, 130, 65536)])
def test_table_take_twin_matches_jax(impl, K, T, N):
    rng = np.random.RandomState(0)
    tbl = rng.randn(K, T).astype(np.float32)
    rid = rng.randint(0, T, N).astype(np.int32)
    ref = np.asarray(jg.table_take(jnp.asarray(tbl), jnp.asarray(rid), impl=impl))
    got = tg.table_take(torch.from_numpy(tbl), torch.from_numpy(rid))
    assert got.shape == (K, N) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)


def test_table_take_out_of_range_and_dispatch():
    tbl = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    rid = torch.tensor([0, 3, -1, 4, 2], dtype=torch.int32)
    before = tg.KERNEL.launches
    got = tg.table_take(tbl, rid)
    assert tg.KERNEL.launches == before  # CPU tensors run the twin
    np.testing.assert_array_equal(got.numpy(), [[0, 3, 0, 0, 2], [4, 7, 0, 0, 6],
                                                [8, 11, 0, 0, 10]])
    with pytest.raises(ValueError, match="unsupported device"):
        tg.table_take(tbl.to("meta"), rid.to("meta"))
    with pytest.raises(ValueError):
        tg.table_take(tbl, rid.long())


def _scatter_case(seed, K, R, N, hot=0):
    """Ids over [-3, R + 3) (out-of-range ones dropped), values with both
    signs, some zero columns, and `hot` entries of row 1."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(-3, R + 3, N).astype(np.int32)
    if hot:
        ids[rng.choice(N, hot, replace=False)] = 1
    vals = rng.randn(K, N).astype(np.float32)
    vals[:, rng.rand(N) < 0.1] = 0.0
    return ids, vals


def _f64_sum(ids, vals, R):
    ok = (ids >= 0) & (ids < R)
    acc = np.zeros((R, vals.shape[0]), np.float64)
    np.add.at(acc, ids[ok], vals[:, ok].T.astype(np.float64))
    return acc


@pytest.mark.parametrize("K,R,N,hot", [(9, 40, 1 << 15, 0), (48, 300, 5000, 0),
                                       (3, 8, 200000, 150000)])
def test_scatter_twin_within_one_ulp_of_float64(K, R, N, hot):
    ids, vals = _scatter_case(K, K, R, N, hot)
    got = ts.scatter_add_by_id(torch.from_numpy(ids), torch.from_numpy(vals), R)
    assert got.shape == (R, K) and got.dtype == torch.float32
    ref = _f64_sum(ids, vals, R)
    assert _ulps(got.numpy(), ref.astype(np.float32)).max() <= 1
    if hot:
        assert np.abs(ref[1]).max() > 0


def test_scatter_twin_matches_jax():
    """tests/test_gather_scatter.py test_scatter_methods_agree's case."""
    rng = np.random.RandomState(2)
    K, R, N = 5, 40, 1 << 17
    ids = rng.randint(0, R + 3, N).astype(np.int32)  # some out of range
    vals = rng.randn(K, N).astype(np.float32)
    got = ts.scatter_add_by_id(torch.from_numpy(ids), torch.from_numpy(vals), R).numpy()
    for method in ("scatter", "pallas_interpret"):
        ref = np.asarray(js.scatter_add_by_id(jnp.asarray(ids), jnp.asarray(vals), R,
                                              method=method))
        np.testing.assert_allclose(got, ref, rtol=0, atol=3e-5 * np.abs(ref).max())


def _coherent_case(seed, K, R, N):
    """Ids in runs along the columns, as pixel rows are (a run of 1-40
    columns per id, -1 for background), with zero columns."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(1, 41, N)
    runs = np.where(rng.rand(N) < 0.3, -1, rng.randint(0, R, N))
    ids = np.repeat(runs, lens)[:N].astype(np.int32)
    vals = rng.randn(K, N).astype(np.float32)
    vals[:, rng.rand(N) < 0.1] = 0.0
    return ids, vals


CHUNK_CASES = {
    "coherent": lambda: _coherent_case(5, 9, 500, 20000),
    "random": lambda: _scatter_case(6, 9, 300, 20000),
    "hot": lambda: _scatter_case(7, 3, 8, 40000, hot=30000),
    "wide": lambda: _scatter_case(8, 48, 30, 3000),
}


@pytest.mark.parametrize("name", list(CHUNK_CASES))
def test_chunk_partials_twin(name):
    """Kernel B10's per-chunk structure (plain twin): every live column
    (id in [0, R), a non-zero value) in exactly one (id, chunk) partial,
    chunks ascending and ids ascending within a chunk; the partials' id
    sums within 1 ulp of float64 np.add.at sums."""
    ids, vals = CHUNK_CASES[name]()
    K, N = vals.shape
    R = int(ids.max()) - 2 if name in ("random", "hot", "wide") else 500
    ti, tv = torch.from_numpy(ids), torch.from_numpy(vals)
    id_, chunk, part, n = ts.chunk_partials_plain(ti, tv, R)
    order = chunk * R + id_
    assert bool((order[1:] > order[:-1]).all())
    live = (ids >= 0) & (ids < R) & (vals != 0).any(0)
    assert int(n.sum()) == live.sum()
    np.testing.assert_array_equal(np.unique(chunk.numpy()),
                                  np.unique(np.nonzero(live)[0] // ts.CHUNK))
    got = torch.zeros((R, K), dtype=torch.float64).index_add_(0, id_, part).float()
    assert _ulps(got.numpy(), _f64_sum(ids, vals, R).astype(np.float32)).max() <= 1
    if name == "coherent":
        assert id_.shape[0] * 8 < live.sum()  # a chunk's runs reduce
    if name == "random":
        assert int(torch.bincount(chunk).max()) > ts.CAP  # past the kernel's scratch
    if name == "hot":
        assert int(n.max()) > 4 * 32  # its lanes take turns


def test_chunk_partials_twin_matches_jax():
    """The partials' id sums against JAX scatter_add_by_id's Pallas
    kernel (interpret mode), at its bar."""
    ids, vals = _coherent_case(9, 5, 40, 1 << 15)
    id_, _, part, _ = ts.chunk_partials_plain(torch.from_numpy(ids), torch.from_numpy(vals), 40)
    got = torch.zeros((40, 5), dtype=torch.float64).index_add_(0, id_, part).float().numpy()
    ref = np.asarray(js.scatter_add_by_id(jnp.asarray(ids), jnp.asarray(vals), 40,
                                          method="pallas_interpret"))
    np.testing.assert_allclose(got, ref, rtol=0, atol=3e-5 * np.abs(ref).max())


def test_scatter_dispatch_and_checks():
    ids, vals = _scatter_case(3, 4, 6, 3000, hot=1000)
    before = ts.KERNEL.launches
    ts.scatter_add_by_id(torch.from_numpy(ids), torch.from_numpy(vals), 6)
    assert ts.KERNEL.launches == before  # CPU tensors run the twin
    with pytest.raises(ValueError, match="unsupported device"):
        ts.scatter_add_by_id(torch.from_numpy(ids).to("meta"),
                             torch.from_numpy(vals).to("meta"), 6)
    with pytest.raises(ValueError):
        ts.scatter_add_by_id(torch.from_numpy(ids[:-1]), torch.from_numpy(vals), 6)
    with pytest.raises(ValueError):
        ts.chunk_partials_plain(torch.from_numpy(ids).long(), torch.from_numpy(vals), 6)
