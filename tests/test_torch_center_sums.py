"""KMeans' center sums: the counting instance's bookkeeping and the
kernels' summation order, emulated on the CPU.

- ``ops/kernels.center_order_plain`` (the counting sort of
  ``csrc/center_sums.cu`` step for step: the histogram per block, the
  (cluster, block) scan, the stable ranks among the lower lanes, the
  earlier rounds and the earlier warps) against ``torch.sort(best,
  stable=True)`` and against the sorted instance's offsets
  (``center_order_sorted``, whose int32 order the sums read), over one row, one block, one block and a row,
  several blocks, one huge cluster, empty clusters and more clusters than
  rows, at the kernel's block size and at a small one (many blocks);
- ``center_sums_pieces_plain`` (pieces of ``PIECE_ROWS`` sorted rows,
  double sums per column in row order, pieces in order) against float64
  numpy sums of the same products at 1e-12;
- the routing by k, and the constants the wrappers mirror from the source.

The kernels themselves are held on the card by the ``gpu`` tests of
tests/test_torch_stacked.py.
"""

import re

import numpy as np
import pytest
import torch

from cycloneml_tpu_torch.ops import build
from cycloneml_tpu_torch.ops import kernels as tk

BLOCK = tk.SORT_ROWS


def _best(n, k, seed, huge=False, empty=0):
    """An assignment of n rows to k clusters: uniform over the first k -
    ``empty`` clusters, half the rows in cluster 0 with ``huge``."""
    rng = np.random.RandomState(seed)
    best = rng.randint(0, max(k - empty, 1), n)
    if huge:
        best[rng.rand(n) < 0.5] = 0
    return torch.from_numpy(best.astype(np.int32))


ORDER_CASES = [
    # (n, k, huge, empty)
    (1, 1, False, 0),
    (1, 13, False, 0),
    (BLOCK, 13, False, 0),
    (BLOCK + 1, 1000, False, 0),
    (3 * BLOCK + 77, 1000, True, 0),
    (2 * BLOCK + 5, 1, False, 0),
    (BLOCK + 1, 13, True, 5),
    (500, 1000, False, 0),       # more clusters than rows
    (5000, tk.COUNT_MAX_K, False, 0),
]


@pytest.mark.parametrize("n,k,huge,empty", ORDER_CASES)
def test_counting_order_is_the_stable_sort(n, k, huge, empty):
    best = _best(n, k, seed=n % 97 + k, huge=huge, empty=empty)
    got = tk.center_order_plain(best, k)
    want = tk.center_order_sorted(best, k)
    assert got.order.dtype == torch.int32 and got.order.shape == (n,)
    assert torch.equal(got.order.long(),
                       torch.sort(best.long(), stable=True).indices)
    assert want.order.dtype == torch.int32
    assert torch.equal(got.order, want.order)
    assert torch.equal(got.offsets, want.offsets)
    assert torch.equal(got.piece_start, want.piece_start)
    rows = torch.bincount(best.long(), minlength=k)
    assert torch.equal(got.offsets[1:] - got.offsets[:-1], rows)
    assert torch.equal(got.piece_start[1:] - got.piece_start[:-1],
                       (rows + tk.PIECE_ROWS - 1) // tk.PIECE_ROWS)
    if empty:
        assert int(rows[k - 1]) == 0


@pytest.mark.parametrize("block_rows,warp_rows", [(256, 32), (512, 64),
                                                  (64, 64)])
@pytest.mark.parametrize("n,k", [(1, 3), (255, 7), (2049, 13), (3001, 600)])
def test_counting_order_over_many_blocks_and_warps(n, k, block_rows,
                                                   warp_rows):
    """The same bookkeeping with small blocks and warp runs: many (cluster,
    block) entries, runs of one round, partial last blocks."""
    best = _best(n, k, seed=k, huge=True)
    got = tk.center_order_plain(best, k, block_rows=block_rows,
                                warp_rows=warp_rows)
    want = tk.center_order_sorted(best, k)
    assert torch.equal(got.order, want.order)
    assert torch.equal(got.offsets, want.offsets)
    assert torch.equal(got.piece_start, want.piece_start)


def test_counting_order_leaves_out_rows_outside_the_clusters():
    best = torch.tensor([2, -1, 0, 5, 2, 1, 0, 3], dtype=torch.int32)
    got = tk.center_order_plain(best, 3)
    kept = int(got.offsets[3])
    assert kept == 5
    assert got.order[:kept].tolist() == [2, 6, 5, 0, 4]
    assert got.offsets.tolist() == [0, 2, 3, 5]


def test_center_order_on_the_cpu_is_the_plain_version():
    best = _best(4000, 17, seed=3, huge=True)
    got = tk._center_order(best, 17)
    want = tk.center_order_plain(best, 17)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert tk._center_order.launches == 0


def _float64_truth(x, w, best, k, acc):
    """Float64 numpy sums of the products rounded at w's width ``acc``."""
    prod = (x.astype(acc) * w.astype(acc)[:, None]).astype(np.float64)
    sums = np.zeros((k, x.shape[1]))
    counts = np.zeros(k)
    np.add.at(sums, best, prod)
    np.add.at(counts, best, w.astype(np.float64))
    return sums, counts


@pytest.mark.parametrize("x_dtype,w_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.float32),
    (torch.float64, torch.float32), (torch.float32, torch.float64),
    (torch.float64, torch.float64)])
@pytest.mark.parametrize("n,d,k", [(1, 1, 1), (5000, 7, 13),
                                   (2 * BLOCK + 3, 3, 3), (3000, 129, 50)])
def test_piece_order_matches_float64(n, d, k, x_dtype, w_dtype):
    rng = np.random.RandomState(n + d)
    best = _best(n, k, seed=d, huge=True)
    x = torch.from_numpy(rng.randn(n, d)).to(x_dtype)
    w = torch.from_numpy(rng.rand(n)).to(w_dtype)
    w[::7] = 0.0
    co = tk.center_order_plain(best, k)
    sums, counts = tk.center_sums_pieces_plain(x, w, co, k)
    acc = np.float32 if w_dtype == torch.float32 else np.float64
    want_s, want_c = _float64_truth(x.double().numpy(), w.double().numpy(),
                                    best.long().numpy(), k, acc)
    assert sums.dtype == w_dtype and counts.dtype == w_dtype
    # the double sums themselves, before the rounding to w's width
    s64, c64 = tk.center_sums_pieces_plain(x, w, co, k,
                                           out_dtype=torch.float64)
    assert torch.equal(sums, s64.to(w_dtype))
    np.testing.assert_allclose(s64.numpy(), want_s, rtol=1e-12,
                               atol=1e-12 * max(np.abs(want_s).max(), 1.0))
    np.testing.assert_allclose(c64.numpy(), want_c, rtol=1e-12, atol=1e-12)
    _, only = tk.center_sums_pieces_plain(x, w, co, k, with_sums=False)
    assert torch.equal(only, counts)


def test_piece_sums_run_in_row_order_within_a_piece():
    """A piece's double sum is taken row after row in sorted order: values
    whose sum depends on the order (1, 1e16, -1e16) give the sequential
    result, not a pairwise one."""
    x = torch.tensor([[1.0], [1e16], [-1e16], [1.0]], dtype=torch.float64)
    w = torch.ones(4, dtype=torch.float64)
    best = torch.zeros(4, dtype=torch.int32)
    co = tk.center_order_plain(best, 1)
    sums, counts = tk.center_sums_pieces_plain(x, w, co, 1)
    assert float(sums[0, 0]) == ((1.0 + 1e16) - 1e16) + 1.0
    assert float(counts[0]) == 4.0


def test_pieces_of_a_large_cluster_are_summed_in_piece_order():
    n = 3 * tk.PIECE_ROWS + 5
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.randn(n, 2))
    w = torch.from_numpy(rng.rand(n))
    best = torch.zeros(n, dtype=torch.int32)
    co = tk.center_order_plain(best, 1)
    assert co.piece_start.tolist() == [0, 4]
    sums, counts = tk.center_sums_pieces_plain(x, w, co, 1)
    parts = [(x[lo:lo + tk.PIECE_ROWS] * w[lo:lo + tk.PIECE_ROWS, None])
             for lo in range(0, n, tk.PIECE_ROWS)]
    want = torch.zeros(2, dtype=torch.float64)
    for part in parts:
        acc = torch.zeros(2, dtype=torch.float64)
        for r in part:
            acc += r
        want += acc
    assert torch.equal(sums[0], want)


def test_instances_by_k():
    assert tk.center_sums_instance(1) == tk.COUNTING
    assert tk.center_sums_instance(1000) == tk.COUNTING
    assert tk.center_sums_instance(tk.COUNT_MAX_K) == tk.COUNTING
    assert tk.center_sums_instance(tk.COUNT_MAX_K + 1) == tk.SORTED
    with pytest.raises(ValueError):
        tk.center_sums_instance(0)


def test_wrapper_constants_match_the_source():
    src = (build.CSRC_DIR / "center_sums.cu").read_text()

    def const(name):
        m = re.search(rf"constexpr int {name} = ([^;]+);", src)
        assert m, name
        return int(eval(m.group(1), {"kSortRows": tk.SORT_ROWS,
                                     "kSortWarps": 8}))

    assert const("kPieceRows") == tk.PIECE_ROWS
    assert const("kSortRows") == tk.SORT_ROWS
    assert const("kCountMaxK") == tk.COUNT_MAX_K
    assert tk.SORT_ROWS // const("kSortWarps") == tk.SORT_WARP_ROWS
    assert const("kWarpRows") == tk.SORT_WARP_ROWS
    for bit, stage in ((1, "kHist"), (2, "kScan"), (4, "kScatter"),
                       (8, "kPieces"), (16, "kReduce")):
        assert re.search(rf"\b{stage} = {bit}\b", src), stage
    assert tk._STAGES_ALL == 31 and tk._STAGES_ORDER == 7
    assert tk._STAGES_SUMS == 24


def test_center_sums_on_the_cpu_launch_nothing_by_instance():
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randn(300, 5))
    w = torch.from_numpy(rng.rand(300))
    best = _best(300, 7, seed=1)
    tk.reset_launch_counts()
    a = tk.center_sums(x, w, best.long(), 7)
    b = tk.center_sums(x, w, best, 7)  # int32, as K3 writes it
    assert all(torch.equal(p, q) for p, q in zip(a, b))
    assert tk.center_sums.launches == 0
    assert tk.center_sums.launches_by_instance == {tk.COUNTING: 0,
                                                  tk.SORTED: 0}

