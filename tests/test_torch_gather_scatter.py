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
  split). The kernel's index glue (``scatter.entries``) is checked
  against numpy: live columns only, stably sorted by row, pieces of 256.
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


def test_scatter_entries_glue():
    """The kernel's entry list: live columns (id in range, column not all
    zero) in stable id order, row segments and their pieces of 256."""
    ids, vals = _scatter_case(3, 4, 6, 3000, hot=1000)
    codes, off, first, n_pieces = ts.entries(torch.from_numpy(ids), torch.from_numpy(vals), 6)
    live = (ids >= 0) & (ids < 6) & (vals != 0).any(0)
    ref_codes = np.nonzero(live)[0][np.argsort(ids[live], kind="stable")]
    np.testing.assert_array_equal(codes.numpy(), ref_codes)
    counts = np.bincount(ids[live], minlength=6)
    np.testing.assert_array_equal(off.numpy(), np.concatenate([[0], np.cumsum(counts)]))
    pieces = -(-counts // ts.PIECE)
    np.testing.assert_array_equal(first.numpy(), np.concatenate([[0], np.cumsum(pieces)]))
    assert n_pieces == pieces.sum() and pieces[1] >= 4
    before = ts.KERNEL.launches
    ts.scatter_add_by_id(torch.from_numpy(ids), torch.from_numpy(vals), 6)
    assert ts.KERNEL.launches == before  # CPU tensors run the twin
    with pytest.raises(ValueError, match="unsupported device"):
        ts.scatter_add_by_id(torch.from_numpy(ids).to("meta"),
                             torch.from_numpy(vals).to("meta"), 6)
    with pytest.raises(ValueError):
        ts.scatter_add_by_id(torch.from_numpy(ids[:-1]), torch.from_numpy(vals), 6)
