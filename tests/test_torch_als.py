"""The port's ALS against the JAX package's, on the same numpy ratings.

Both compact the ids with ``np.unique`` and draw the initial factors from
``np.random.RandomState(seed)``, users first, so in float64
(``cyclone.compute.dtype=float64`` for the port, the root conftest's x64
for the reference) the two fits start from identical factors and take the
same steps. The factors agree within rtol 1e-8, atol 1e-10: the two sum
each entity's normal equations in other orders (the reference psums eight
shards of its test mesh) and factor A by other LU codes, about 1e-13
relative after ten iterations.

- ``als_normal_plain`` (the CPU's normal equations) against the
  reference's ``_normal_eq_local`` called directly: A, b and n to 1e-12;
- the order (``als_order``): stable, every rating once, pieces cut at P,
  P +- 1 and 5P, a destination with no rating;
- the plain chunks within ``aggregationChunkBytes`` and the same factors
  under a 4,096-byte budget (the port's form of the reference's memory
  check, which no longer runs under jax 0.9.0);
- ``shardFactors`` "never", "always" and "auto" at a tiny threshold give
  bitwise-equal factors;
- the model (cold start, ``recommend_for_all_users``/``_items``) against
  the reference's on identical factors (``interop.als_model_from_reference``);
- a ``checkpointDir`` of another fit raises (the resume itself is held
  in tests/test_torch_checkpoint.py); persistence raises only where the
  reference's does (a path that exists, a directory of another class), and a round
  trip keeps the factors bit for bit.

The float32 kernel's arithmetic (TF32 parts, three products, float32
sums by stage) is emulated in numpy and held to the card's tolerance.

The ``gpu`` tests hold ``csrc/als_normal.cu`` against the plain twin on
the card (ranks 1 to 200, destinations of 0 to 80 P ratings, both modes,
factor magnitudes 1e-3 to 1e3 at alpha = 40, the FMA instance at float32,
A == A^T bitwise, bitwise repeats, 0 spills, fits): the card's machine has
no jax, so the reference is imported inside the tests that use it:

    python -m pytest --noconftest -m gpu tests/test_torch_als.py
"""

import numpy as np
import pytest
import torch

from cycloneml_tpu_torch import CycloneConf, CycloneContext, interop
from cycloneml_tpu_torch.dataset.frame import MLFrame
from cycloneml_tpu_torch.ml.recommendation import ALS, ALSModel
from cycloneml_tpu_torch.ops import kernels as tk

FIT_TOL = dict(rtol=1e-8, atol=1e-10)
P = tk.ALS_PIECE


@pytest.fixture
def pctx():
    c = CycloneContext(CycloneConf().set("cyclone.master", "cpu")
                       .set("cyclone.compute.dtype", "float64"))
    yield c
    c.stop()


def _ratings(seed=51, n_users=40, n_items=30, rank=3, frac=0.5):
    """tests/test_als.py's ratings: a rank-``rank`` matrix observed at
    ``frac`` of its entries."""
    rng = np.random.RandomState(seed)
    u = rng.randn(n_users, rank)
    v = rng.randn(n_items, rank)
    full = u @ v.T
    mask = rng.rand(n_users, n_items) < frac
    users, items = np.nonzero(mask)
    return users, items, full[users, items], full, mask


def _implicit_counts(r, seed):
    """Ratings with negative entries and zeros: implicit mode adds them to
    A and n but not to b."""
    out = np.round(r * 2) / 2
    out[np.random.RandomState(seed).rand(len(r)) < 0.1] = 0.0
    return out


MODES = {
    "explicit": (dict(regParam=0.01), lambda r, s: r),
    "implicit": (dict(regParam=0.1, implicitPrefs=True, alpha=2.0),
                 _implicit_counts),
    "nonnegative": (dict(regParam=0.1, nonnegative=True),
                    lambda r, s: np.abs(r) + 0.1),
}


def _fit_both(ctx, pctx, cols, **kw):
    """The reference's fit and the port's on the same columns, with each
    package's frame of them."""
    from cycloneml_tpu.dataset.frame import MLFrame as JaxFrame
    from cycloneml_tpu.ml.recommendation import ALS as JaxALS
    jframe, frame = JaxFrame(ctx, cols), MLFrame(pctx, cols)
    return JaxALS(**kw).fit(jframe), ALS(**kw).fit(frame), jframe, frame


def _assert_same_factors(ref, got, tol=FIT_TOL):
    np.testing.assert_array_equal(got.user_ids, ref.user_ids)
    np.testing.assert_array_equal(got.item_ids, ref.item_ids)
    np.testing.assert_allclose(got.user_factors, ref.user_factors, **tol)
    np.testing.assert_allclose(got.item_factors, ref.item_factors, **tol)


@pytest.mark.parametrize("rank", [1, 3, 10])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_f64_fit_matches_reference(ctx, pctx, mode, rank):
    extra, shape = MODES[mode]
    seed = 51 + rank
    users, items, r, _, _ = _ratings(seed=seed)
    r = shape(r, seed)
    if mode == "implicit":
        assert (r < 0).any() and (r == 0).any()
    # raw ids that are not 0..n-1: the compaction is part of the fit
    cols = {"user": users * 3 + 7, "item": items + 100, "rating": r}
    ref, got, jframe, frame = _fit_both(ctx, pctx, cols, rank=rank,
                                        maxIter=10, seed=rank, **extra)
    _assert_same_factors(ref, got)
    if mode == "nonnegative":
        assert got.user_factors.min() >= 0 and got.item_factors.min() >= 0
    np.testing.assert_allclose(got.transform(frame)["prediction"],
                               np.asarray(ref.transform(jframe)["prediction"]),
                               **FIT_TOL)


def test_f64_nonnegative_implicit_matches_reference(ctx, pctx):
    users, items, r, _, _ = _ratings(seed=58)
    cols = {"user": users, "item": items, "rating": _implicit_counts(r, 58)}
    ref, got, _, _ = _fit_both(ctx, pctx, cols, rank=4, maxIter=8,
                               regParam=0.1, seed=3, implicitPrefs=True,
                               alpha=0.5, nonnegative=True)
    _assert_same_factors(ref, got)


def test_two_fits_are_bitwise_equal(pctx):
    users, items, r, _, _ = _ratings(seed=59)
    frame = MLFrame(pctx, {"user": users, "item": items, "rating": r})
    a = ALS(rank=3, maxIter=5, seed=1).fit(frame)
    b = ALS(rank=3, maxIter=5, seed=1).fit(frame)
    assert np.array_equal(a.user_factors, b.user_factors)
    assert np.array_equal(a.item_factors, b.item_factors)


# -- the normal equations -----------------------------------------------------

def _coo(n_dst, n_src, nnz, seed, empty=True):
    rng = np.random.RandomState(seed)
    dst = rng.randint(0, n_dst - 1 if empty else n_dst, nnz)
    src = rng.randint(0, n_src, nnz)
    rating = rng.randn(nnz)
    rating[rng.rand(nnz) < 0.1] = 0.0
    return dst, src, rating


@pytest.mark.parametrize("implicit", [False, True])
@pytest.mark.parametrize("rank", [3, 10])
def test_plain_normal_equations_match_reference(implicit, rank):
    """``als_normal_plain`` against the reference's per-shard normal equations
    (``_normal_eq_local``) called directly, in four chunks: A, b and n to
    1e-12 (the reference adds in input order, the plain twin in the
    order's, which keeps input order within each destination)."""
    import jax.numpy as jnp
    from cycloneml_tpu.ml.recommendation.als import _normal_eq_local
    n_dst, n_src, nnz, alpha = 13, 11, 400, 0.7
    dst, src, rating = _coo(n_dst, n_src, nnz, seed=rank)
    fac = np.random.RandomState(rank + 1).randn(n_src, rank)
    local = _normal_eq_local(n_dst, rank, 4, implicit, alpha)
    want = local(jnp.asarray(dst, jnp.int32), jnp.asarray(src, jnp.int32),
                 jnp.asarray(rating), jnp.ones(nnz), jnp.asarray(fac),
                 jnp.zeros((rank, rank)))
    order = tk.als_order(torch.from_numpy(dst), torch.from_numpy(src),
                         torch.from_numpy(rating), n_dst, n_src)
    a, b, n = tk.als_normal_plain(torch.from_numpy(fac), order, implicit,
                                  alpha)
    np.testing.assert_allclose(a.numpy(), np.asarray(want["A"]), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(b.numpy(), np.asarray(want["b"]), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_array_equal(n.numpy(), np.asarray(want["n"]))
    assert n[n_dst - 1] == 0 and (a[n_dst - 1] == 0).all()


def test_plain_terms_are_the_solves():
    """With reg and yty the plain twin's A is the reference's solve
    matrix: A + reg max(n, 1) I + Y^T Y (an entity with no rating gets
    reg I + Y^T Y)."""
    dst, src, rating = _coo(5, 7, 60, seed=3)
    fac = torch.from_numpy(np.random.RandomState(4).randn(7, 3))
    order = tk.als_order(torch.from_numpy(dst), torch.from_numpy(src),
                         torch.from_numpy(rating), 5, 7)
    raw, b0, n = tk.als_normal_plain(fac, order)
    yty = fac.T @ fac
    a, b, _ = tk.als_normal_plain(fac, order, reg=0.3, yty=yty)
    lam = 0.3 * torch.clamp(n, min=1.0)
    want = raw + lam[:, None, None] * torch.eye(3, dtype=torch.float64) + yty
    assert torch.equal(a, want) and torch.equal(b, b0)


def test_als_normal_on_the_cpu_is_the_plain_twin():
    dst, src, rating = _coo(9, 6, 200, seed=5)
    fac = torch.from_numpy(np.random.RandomState(6).randn(6, 4))
    order = tk.als_order(torch.from_numpy(dst), torch.from_numpy(src),
                         torch.from_numpy(rating), 9, 6)
    before = tk.als_normal.launches
    got = tk.als_normal(fac, order, True, 0.5, 0.1, fac.T @ fac)
    want = tk.als_normal_plain(fac, order, True, 0.5, 0.1, fac.T @ fac)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert tk.als_normal.launches == before


# -- the float32 kernel's arithmetic, emulated --------------------------------

def _tf32(x):
    """float32 values rounded to TF32's 10-bit mantissa, to nearest with
    ties away from zero (cvt.rna.tf32.f32), as float32."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)) \
        .view(np.float32)


def _split(x):
    hi = _tf32(x)
    return hi, _tf32(np.float32(x) - hi)


def _tensor_core_sums(v, c, bw, three=True):
    """One piece's A (r, r) and b (r,) as csrc/als_normal.cu's float32
    instance sums them: A = v_i (c v_j) and b = v_i bw, each operand split
    in TF32 parts, products lo*hi, hi*lo, hi*hi (``three``; else one TF32
    product, hi*hi) per k-step of 8 ratings, each product of mma.sync
    (float32 C plus 8 exact products) rounded once to float32, a stage's
    32 ratings summed from zero and added to the running sums in float32.
    float64 numpy; the products of two TF32 values are exact in it."""
    f32, f64 = np.float32, np.float64
    a_op = v.astype(f32)
    b_op = np.concatenate([(c.astype(f32)[:, None] * a_op).astype(f32),
                           bw.astype(f32)[:, None]], axis=1)
    ah, al = _split(a_op)
    bh, bl = _split(b_op)
    terms = ((al, bh), (ah, bl), (ah, bh)) if three else ((ah, bh),)
    tot = np.zeros((v.shape[1], v.shape[1] + 1), f32)
    for s0 in range(0, len(v), 32):
        acc = np.zeros_like(tot)
        for k0 in range(s0, min(s0 + 32, len(v)), 8):
            ks = slice(k0, min(k0 + 8, len(v)))
            for x, y in terms:
                acc = (acc.astype(f64)
                       + x[ks].astype(f64).T @ y[ks].astype(f64)).astype(f32)
        tot = (tot + acc).astype(f32)
    return tot[:, :-1], tot[:, -1]


@pytest.mark.parametrize("implicit", [False, True])
def test_tf32x3_arithmetic_holds_the_kernels_tolerance(implicit):
    """The tensor-core instance's arithmetic, emulated at rank 64 on 200
    seeded rows (a user's ratings at configuration 4's shape): within
    1e-5 sqrt(A_ii A_jj) of float64 in every entry of A and 1e-5 of
    sum |bw| |v| in b, the tolerance the card's checks hold the kernel
    to; one TF32 product a term is not."""
    rng = np.random.RandomState(16)
    v = (rng.randn(200, 64) / 8).astype(np.float32).astype(np.float64)
    r = np.round(rng.randn(200) * 2) / 2 + 3.0
    c, bw = (40.0 * np.abs(r), np.where(r > 0, 1 + 40.0 * np.abs(r), 0.0)) \
        if implicit else (np.ones(200), r)
    c, bw = c.astype(np.float32).astype(np.float64), \
        bw.astype(np.float32).astype(np.float64)
    a64 = v.T @ (c[:, None] * v)
    b64 = v.T @ bw
    scale = np.sqrt(np.outer(np.diag(a64), np.diag(a64)))
    bscale = np.abs(v).T @ np.abs(bw)
    errs = {}
    for three in (True, False):
        a, b = _tensor_core_sums(v, c, bw, three)
        errs[three] = (np.max(np.abs(a - a64) / scale),
                       np.max(np.abs(b - b64) / bscale))
    assert max(errs[True]) <= 1e-5, errs
    assert errs[False][0] > 1e-5, errs


# -- the order and its pieces -------------------------------------------------

SIZES = {  # destination sizes as functions of the piece P
    "empty destination": lambda p: (0, 1, 2),
    "P-1, P, P+1": lambda p: (p - 1, p, p + 1),
    "5P, 1, 0, P": lambda p: (5 * p, 1, 0, p),
    "2P+1 alone": lambda p: (2 * p + 1,),
}


@pytest.mark.parametrize("piece", [4, 7, P])
@pytest.mark.parametrize("sizes", sorted(SIZES))
def test_order_is_stable_and_cut_at_p(sizes, piece):
    counts = list(SIZES[sizes](piece))
    rng = np.random.RandomState(len(counts) + piece)
    dst = np.repeat(np.arange(len(counts)), counts)
    rng.shuffle(dst)
    n_src = 17
    src = rng.randint(0, n_src, len(dst))
    rating = rng.randn(len(dst))
    order = tk.als_order(torch.from_numpy(dst), torch.from_numpy(src),
                         torch.from_numpy(rating), len(counts), n_src, piece)
    perm = np.argsort(dst, kind="stable")
    assert order.src.dtype == torch.int32 and order.dst.dtype == torch.int32
    np.testing.assert_array_equal(order.dst.numpy(), dst[perm])
    np.testing.assert_array_equal(order.src.numpy(), src[perm])
    np.testing.assert_array_equal(order.rating.numpy(), rating[perm])
    np.testing.assert_array_equal(order.counts.numpy(), counts)
    pieces = [max(1, -(-c // piece)) for c in counts]
    np.testing.assert_array_equal(order.piece_start.numpy(),
                                  np.concatenate([[0], np.cumsum(pieces)]))
    np.testing.assert_array_equal(order.piece_dst.numpy(),
                                  np.repeat(np.arange(len(counts)), pieces))
    # the slots: consecutive within a destination of several pieces
    multi = [e for e, p in enumerate(pieces) if p > 1]
    np.testing.assert_array_equal(order.multi.numpy(), multi)
    slots = order.piece_slot.numpy()
    assert order.n_slots == sum(pieces[e] for e in multi)
    np.testing.assert_array_equal(slots[slots >= 0],
                                  np.arange(order.n_slots))
    for e, p in enumerate(pieces):
        s = slots[order.piece_start[e]:order.piece_start[e + 1]]
        assert (s < 0).all() if p == 1 else (np.diff(s) == 1).all()
    # every rating in exactly one piece, every piece at most P long
    covered = []
    for g, e in enumerate(order.piece_dst.tolist()):
        first = int(order.offsets[e]) + (g - int(order.piece_start[e])) * piece
        last = min(first + piece, int(order.offsets[e + 1]))
        assert 0 <= last - first <= piece
        covered.extend(range(first, last))
    assert covered == list(range(len(dst)))


def test_order_refuses_ids_out_of_range():
    z = torch.zeros(3, dtype=torch.int64)
    with pytest.raises(ValueError, match="out of range"):
        tk.als_order(z + 3, z, torch.ones(3), 3, 5)
    with pytest.raises(ValueError, match="out of range"):
        tk.als_order(z, z - 1, torch.ones(3), 3, 5)


# -- chunks and memory --------------------------------------------------------

@pytest.mark.parametrize("rank,itemsize,budget", [
    (1, 8, 4096), (3, 8, 4096), (10, 8, 4096), (10, 4, 4096),
    (64, 4, 256 << 20), (64, 8, 256 << 20), (200, 4, 1 << 20)])
def test_plain_chunk_within_the_budget(rank, itemsize, budget):
    rows = tk.als_chunk_rows(rank, itemsize, budget)
    per = rank * rank * itemsize
    assert rows * per <= budget < (rows + 1) * per


def test_plain_chunks_never_exceed_the_budget(pctx, monkeypatch):
    """A fit under a 4,096-byte aggregationChunkBytes adds no block of
    outer products larger than the budget, and gives the default's
    factors bit for bit (the CPU's index_add_ adds in order, so the chunks'
    boundaries change nothing)."""
    users, items, r, _, _ = _ratings(seed=5)
    frame = MLFrame(pctx, {"user": users, "item": items, "rating": r})
    big = ALS(rank=3, maxIter=5, seed=2).fit(frame)
    seen = []
    add0 = torch.Tensor.index_add_

    def spy(self, dim, index, source, *args, **kw):
        if source.dim() == 3:
            seen.append(source.numel() * source.element_size())
        return add0(self, dim, index, source, *args, **kw)

    monkeypatch.setattr(torch.Tensor, "index_add_", spy)
    small = ALS(rank=3, maxIter=5, seed=2,
                aggregationChunkBytes=4096).fit(frame)
    rows = 4096 // (3 * 3 * 8)
    assert len(seen) == 2 * 5 * -(-len(r) // rows)
    assert max(seen) <= 4096
    assert np.array_equal(small.user_factors, big.user_factors)
    assert np.array_equal(small.item_factors, big.item_factors)


def test_movielens_shape_kernel_needs_no_scratch():
    """At MovieLens-25M's shape (benchmarks/als_scale.py's draws of
    users and items) every user and item has fewer than P ratings: each
    destination is one piece, so the kernel's only output is A (n_dst x
    64 x 64 float32, 2.66 GB for the users) and its scratch is empty; the
    plain twin's chunk at rank 64 stays within the default 256 MiB."""
    n_users, n_items, nnz = 162_541, 62_423, 25_000_095
    rng = np.random.default_rng(7)
    per_user = np.bincount(rng.integers(0, n_users, nnz), minlength=n_users)
    per_item = np.bincount(rng.integers(0, n_items, nnz), minlength=n_items)
    assert per_user.max() < P and per_item.max() < P
    assert per_user.min() > 0 and per_item.min() > 0
    assert tk.als_chunk_rows(64, 4, 256 << 20) * 64 * 64 * 4 <= 256 << 20


def test_order_refuses_more_than_int32_ratings():
    huge = torch.empty(2 ** 31, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="int32"):
        tk.als_order(huge, huge, huge.float(), 1, 1)


# -- shardFactors, the model, what raises ------------------------------------

def test_shard_factors_modes_are_bitwise_equal(pctx):
    users, items, r, _, _ = _ratings(seed=55)
    frame = MLFrame(pctx, {"user": users, "item": items, "rating": r})
    kw = dict(rank=3, maxIter=4, regParam=0.05, seed=7)
    fits = [ALS(shardFactors="never", **kw).fit(frame),
            ALS(shardFactors="always", **kw).fit(frame),
            ALS(factorShardingThresholdBytes=64, **kw).fit(frame)]
    for f in fits[1:]:
        assert np.array_equal(f.user_factors, fits[0].user_factors)
        assert np.array_equal(f.item_factors, fits[0].item_factors)


def _reference_model(ctx, seed=56):
    from cycloneml_tpu.dataset.frame import MLFrame as JaxFrame
    from cycloneml_tpu.ml.recommendation import ALS as JaxALS
    users, items, r, full, _ = _ratings(seed=seed)
    cols = {"user": users + 10, "item": items * 2, "rating": r}
    ref = JaxALS(rank=3, maxIter=5, regParam=0.01, seed=6).fit(
        JaxFrame(ctx, cols))
    got = interop.als_model_from_reference(
        ref.user_ids, ref.item_ids, ref.user_factors, ref.item_factors)
    return ref, got, cols


@pytest.mark.parametrize("strategy", ["nan", "drop"])
def test_cold_start_matches_reference(ctx, pctx, strategy):
    from cycloneml_tpu.dataset.frame import MLFrame as JaxFrame
    ref, got, cols = _reference_model(ctx)
    probe = {"user": np.array([cols["user"][0], 9999, cols["user"][3]]),
             "item": np.array([cols["item"][0], cols["item"][1], -5]),
             "rating": np.ones(3)}
    ref.set("coldStartStrategy", strategy)
    got.set("coldStartStrategy", strategy)
    want = ref.transform(JaxFrame(ctx, probe))
    out = got.transform(MLFrame(pctx, probe))
    assert out.n_rows == want.n_rows == (3 if strategy == "nan" else 1)
    np.testing.assert_array_equal(out["prediction"],
                                  np.asarray(want["prediction"]))
    assert np.isnan(out["prediction"]).sum() == (2 if strategy == "nan"
                                                 else 0)


@pytest.mark.parametrize("side", ["users", "items"])
def test_recommendations_match_reference(ctx, pctx, side):
    ref, got, _ = _reference_model(ctx)
    assert got.rank == ref.rank == 3
    name = f"recommend_for_all_{side}"
    want, out = getattr(ref, name)(4), getattr(got, name)(4)
    assert out.n_rows == want.n_rows
    for col in ("user", "item", "rating"):
        np.testing.assert_array_equal(out[col], np.asarray(want[col]))


def test_checkpoint_dir_raises(pctx, tmp_path):
    """A checkpoint directory written by another fit (here another rank)
    raises on its fingerprint instead of resuming foreign factors."""
    users, items, r, _, _ = _ratings(seed=3)
    frame = MLFrame(pctx, {"user": users, "item": items, "rating": r})
    ALS(rank=3, maxIter=2, checkpointDir=str(tmp_path),
        checkpointInterval=1).fit(frame)
    with pytest.raises(ValueError, match="DIFFERENT ALS run"):
        ALS(rank=4, maxIter=2, checkpointDir=str(tmp_path)).fit(frame)


def test_persistence_raises(pctx, tmp_path):
    """Since Queue 1 item 4, ALS and ALSModel persist: saving onto a path
    that exists raises, as loading an ALS estimator's directory as a model
    does; the round trip keeps ids and factors bitwise."""
    users, items, r, _, _ = _ratings(seed=57)
    model = ALS(rank=3, maxIter=2).fit(
        MLFrame(pctx, {"user": users, "item": items, "rating": r}))
    model.save(str(tmp_path / "m"))
    ALS(rank=3).save(str(tmp_path / "e"))
    with pytest.raises(IOError, match="Path exists"):
        model.save(str(tmp_path / "m"))
    with pytest.raises(TypeError, match="expected ALSModel"):
        ALSModel.load(str(tmp_path / "e"))
    back = ALSModel.load(str(tmp_path / "m"))
    for name in ("user_ids", "item_ids", "user_factors", "item_factors"):
        a, b = getattr(model, name), getattr(back, name)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert ALS.load(str(tmp_path / "e")).get("rank") == 3


def test_params_keep_the_reference_defaults():
    from cycloneml_tpu.ml.recommendation import ALS as JaxALS
    ref, got = JaxALS(), ALS()
    names = sorted(p.name for p in ref.params)
    assert sorted(p.name for p in got.params) == names
    for name in names:
        assert got.get(name) == ref.get(name), name
    for bad in (dict(rank=0), dict(alpha=-1.0), dict(shardFactors="x"),
                dict(coldStartStrategy="zero"), dict(aggregationChunkBytes=0)):
        with pytest.raises(ValueError):
            ALS(**bad)


# -- on the card --------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _card_order(counts, n_src, seed, dev, dtype=torch.float64, piece=P):
    """An order on the card with destination e holding counts[e] ratings,
    shuffled, a tenth of them zero and about half negative."""
    rng = np.random.RandomState(seed)
    dst = np.repeat(np.arange(len(counts)), counts)
    rng.shuffle(dst)
    src = rng.randint(0, n_src, len(dst))
    rating = rng.randn(len(dst))
    rating[rng.rand(len(dst)) < 0.1] = 0.0
    return tk.als_order(torch.from_numpy(dst).to(dev),
                        torch.from_numpy(src).to(dev),
                        torch.from_numpy(rating).to(dev, dtype),
                        len(counts), n_src, piece)


def _sym_scale(a):
    diag = torch.diagonal(a, dim1=1, dim2=2).abs()
    return torch.sqrt(diag[:, :, None] * diag[:, None, :])


def _assert_kernel(fac, order, implicit, tol, reg=0.0, yty=None, alpha=0.8,
                   instance=None):
    """The kernel against the float64 plain twin: |dA_ij| <= tol
    sqrt(A_ii A_jj), |db| <= tol of the row's sum |bw| |v|, counts exact,
    A == A^T bitwise, two launches bitwise equal, one launch each (of
    ``instance``; None: the dtype's)."""
    before = tk.als_normal.launches
    a, b, n = tk.als_normal(fac, order, implicit, alpha, reg, yty,
                            instance=instance)
    a2, b2, _ = tk.als_normal(fac, order, implicit, alpha, reg, yty,
                              instance=instance)
    torch.cuda.synchronize()
    assert tk.als_normal.launches == before + 2
    o64 = order._replace(rating=order.rating.double())
    ta, tb, tn = tk.als_normal_plain(
        fac.double(), o64, implicit, alpha, reg,
        None if yty is None else yty.double())
    scale = _sym_scale(ta) + 1e-300
    assert float(((a.double() - ta).abs() / scale).max()) <= tol
    w = 1.0 + alpha * o64.rating.abs() if implicit else o64.rating.abs()
    bscale = torch.zeros_like(tb).index_add_(
        0, o64.dst, w[:, None] * fac.double()[o64.src].abs())
    assert bool(((b.double() - tb).abs() <= tol * bscale + 1e-300).all())
    assert torch.equal(n.double(), tn)
    assert torch.equal(a, a.transpose(1, 2))
    assert torch.equal(a, a2) and torch.equal(b, b2)


@pytest.mark.gpu
@pytest.mark.parametrize("implicit", [False, True])
@pytest.mark.parametrize("rank", [1, 3, 10, 33, 64, 65, 128, 200])
def test_cuda_kernel_matches_plain_at_every_rank(rank, implicit):
    """float64 kernel against the float64 plain twin at 1e-12, the float32
    kernel at 1e-5, with the solve's terms (reg, Y^T Y) and without."""
    dev = _cuda()
    counts = np.random.RandomState(rank).randint(0, 300, 40)
    counts[:3] = (0, 1, 2 * P + 5)
    order = _card_order(counts, 57, rank, dev)
    fac = torch.from_numpy(np.random.RandomState(rank + 1).randn(57, rank)) \
        .to(dev)
    _assert_kernel(fac, order, implicit, 1e-12)
    _assert_kernel(fac, order, implicit, 1e-12, 0.3, fac.T @ fac)
    o32 = order._replace(rating=order.rating.float())
    _assert_kernel(fac.float(), o32, implicit, 1e-5)
    _assert_kernel(fac.float(), o32, implicit, 1e-5, 0.3,
                   fac.float().T @ fac.float())


@pytest.mark.gpu
@pytest.mark.parametrize("implicit", [False, True])
@pytest.mark.parametrize("rank", [3, 64, 65])
def test_cuda_fma_instance_at_float32(rank, implicit):
    """The earlier float32 design (``instance="fma"``, timed beside the
    tensor cores) against the float64 plain twin at 1e-5, counted by
    instance."""
    dev = _cuda()
    counts = np.random.RandomState(rank).randint(0, 300, 20)
    counts[:2] = (0, P + 3)
    order = _card_order(counts, 41, rank, dev, torch.float32)
    fac = torch.from_numpy(np.random.RandomState(rank + 1).randn(41, rank)) \
        .to(dev, torch.float32)
    before = dict(tk.als_normal.launches_by_instance)
    _assert_kernel(fac, order, implicit, 1e-5, 0.3, fac.T @ fac,
                   instance=tk.FMA)
    assert tk.als_normal.launches_by_instance[tk.FMA] == before[tk.FMA] + 2
    assert tk.als_normal.launches_by_instance[tk.TENSOR_CORE] == \
        before[tk.TENSOR_CORE]


@pytest.mark.gpu
@pytest.mark.parametrize("implicit", [False, True])
def test_cuda_split_covers_factor_magnitudes(implicit):
    """Rank 64, factors of magnitude 1e-3 to 1e3 (each entry's power of
    ten drawn uniformly) and alpha = 40: the float32 kernel within 1e-5 of
    the float64 plain twin, as at unit magnitudes: the TF32 split keeps
    its precision over the range."""
    dev = _cuda()
    rng = np.random.RandomState(40)
    counts = rng.randint(1, 600, 30)
    order = _card_order(counts, 300, 41, dev, torch.float32)
    fac = rng.randn(300, 64) * 10.0 ** rng.uniform(-3, 3, (300, 64))
    fac = torch.from_numpy(fac).to(dev, torch.float32)
    _assert_kernel(fac, order, implicit, 1e-5, alpha=40.0)
    _assert_kernel(fac, order, implicit, 1e-5, 0.1, fac.T @ fac, alpha=40.0)


@pytest.mark.gpu
@pytest.mark.parametrize("implicit", [False, True])
def test_cuda_kernel_at_piece_boundaries(implicit):
    """Destinations of 0, 1, P - 1, P, P + 1 and 80 P ratings (80 pieces
    summed by the second stage in piece order), float32 and float64."""
    dev = _cuda()
    counts = np.array([0, 1, P - 1, P, P + 1, 80 * P, 3])
    order = _card_order(counts, 1000, 7, dev)
    assert order.n_slots == 2 + 80 and order.multi.tolist() == [4, 5]
    for dt, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        fac = torch.from_numpy(np.random.RandomState(8).randn(1000, 64)) \
            .to(dev, dt)
        o = order._replace(rating=order.rating.to(dt))
        _assert_kernel(fac, o, implicit, tol, 0.05, fac.T @ fac)


@pytest.mark.gpu
def test_cuda_kernel_refuses_what_it_cannot_take():
    dev = _cuda()
    order = _card_order(np.array([3, 4]), 5, 1, dev)
    fac = torch.randn(5, 4, device=dev, dtype=torch.float64)
    with pytest.raises(ValueError, match="ratings of"):
        tk.als_normal(fac.float(), order)
    with pytest.raises(ValueError, match="float32 or float64"):
        tk.als_normal(fac.to(torch.bfloat16), order)
    with pytest.raises(ValueError, match="yty"):
        tk.als_normal(fac, order, yty=torch.eye(3, device=dev))
    with pytest.raises(ValueError, match="no 'tensor_core' instance"):
        tk.als_normal(fac, order, instance=tk.TENSOR_CORE)


@pytest.mark.gpu
def test_cuda_als_kernels_do_not_spill():
    """Every kernel of the build reports 0 spill bytes in ptxas's lines:
    the tensor-core instance up to rank 64 and past it, the FMA instance
    (float32, float64) and the second stage (float32, float64)."""
    _cuda()
    from cycloneml_tpu_torch.ops import build
    tk._library("als_normal")
    spills, func = {}, None
    for ln in build.ptxas_report("als_normal").read_text().splitlines():
        if "Compiling entry function" in ln:
            func = ln.split("'")[1]
        elif func and "spill stores" in ln:
            spills[func] = ln.split(":")[-1].strip()
    assert len(spills) == 6, spills
    bad = {f: s for f, s in spills.items()
           if "0 bytes spill stores, 0 bytes spill loads" not in s}
    assert not bad, bad


@pytest.mark.gpu
@pytest.mark.parametrize("kw", [dict(), dict(implicitPrefs=True, alpha=1.0),
                                dict(nonnegative=True)])
def test_cuda_fits_are_bitwise_equal_and_close_to_plain(kw):
    """Fits on the card through the kernel: two launches a iteration, two
    fits bitwise equal, within 1e-4 (norm-relative) of the plain fit."""
    _cuda()
    users, items, r, _, _ = _ratings(seed=61, n_users=300, n_items=200,
                                     rank=5, frac=0.3)
    ctx = CycloneContext(CycloneConf().set("cyclone.master", "cuda"))
    try:
        frame = MLFrame(ctx, {"user": users, "item": items, "rating": r})
        est = dict(rank=5, maxIter=3, regParam=0.1, seed=2, **kw)
        before = tk.als_normal.launches
        a = ALS(**est).fit(frame)
        assert tk.als_normal.launches == before + 2 * 3
        b = ALS(**est).fit(frame)
        assert np.array_equal(a.user_factors, b.user_factors)
        assert np.array_equal(a.item_factors, b.item_factors)
        ctx.conf.set("cyclone.ml.usePallasKernels", "false")
        p = ALS(**est).fit(frame)
        assert tk.als_normal.launches == before + 2 * 3 * 2
        for x, y in ((a.user_factors, p.user_factors),
                     (a.item_factors, p.item_factors)):
            assert np.linalg.norm(x - y) <= 1e-4 * np.linalg.norm(y)
    finally:
        ctx.stop()
