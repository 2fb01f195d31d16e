"""GraphX in the port — ``Graph``, ``pregel`` and the graph library —
against the JAX package's, on the same seeded numpy inputs, and the
segment reduction they merge messages with.

- Every case of the reference's ``tests/test_graph.py`` runs through both
  packages (the port on ``cyclone.master=cpu``, the reference on a
  one-device mesh of its own, ``rctx``), each with the reference's own
  assertions and the two packages' results compared.
- ``Graph.from_edges`` on 10^5 random int64 ids gives the reference's
  ``vertex_ids`` and remapped edges (the port remaps by ``np.unique``'s
  inverse, the reference by a Python dict).
- On seeded random graphs: degrees, connected components, SCC, triangle
  counts, shortest paths, label propagation and Pregel exactly the
  reference's; PageRank within rtol 1e-5 of it (both sum float32
  messages, the reference in float32 over its mesh's shards, the port in
  float64 rounded once) and within 1e-4 of the dense float64 replica;
  SVD++ at ``max_iter`` 10 within rtol 1e-4 (factors) and 1e-5 (RMSE).
- ``kernels.segment_reduce_plain`` against a numpy loop for sum, min and
  max over float32, float64 and int32 rows with empty segments (exactly
  for min, max and int32; float sums to one float rounding), its
  ``rows`` and accumulate forms, and ``segment_order`` against a stable
  numpy argsort.

The ``gpu`` tests hold ``kernels.segment_reduce`` (``csrc/
segment_reduce.cu``) against its plain version on the card (every dtype
and merge, k from 1 to 4,096, empty segments, a hub segment, int32 labels
near 2^31, the rows and accumulate forms; two launches bitwise equal) and
the graph library through it against the plain route. The card's machine
has no jax, so the reference is imported inside the tests that use it:

    python -m pytest --noconftest -m gpu tests/test_torch_graph.py
"""

import types

import numpy as np
import pytest
import torch

from cycloneml_tpu_torch import CycloneConf, CycloneContext
from cycloneml_tpu_torch.graph import Graph, pregel
from cycloneml_tpu_torch.graph import lib as glib
from cycloneml_tpu_torch.ops import kernels

PR_RTOL = 1e-5         # PageRank against the reference (float32 messages)
SVD_RTOL = 1e-4        # SVD++'s factors after 10 epochs
RMSE_RTOL = 1e-5


@pytest.fixture
def pctx():
    c = CycloneContext(CycloneConf().set("cyclone.master", "cpu")
                       .set("cyclone.compute.dtype", "float64"))
    yield c
    c.stop()


@pytest.fixture(scope="module")
def rctx():
    """The reference graph's context: only its mesh runtime is read, and
    here it is a one-device mesh of its own. On the session's 8-device CPU
    mesh every message merge is an 8-thread collective, and under a loaded
    multi-worker run XLA's rendezvous termination timeout aborted the
    worker (three times in one run); on one device no collective waits on
    another thread. The sums' order differs from the 8-shard one only in
    float rounding, inside every tolerance here."""
    from cycloneml_tpu.mesh import MeshRuntime
    return types.SimpleNamespace(mesh_runtime=MeshRuntime("local-mesh[1]"))


def _ref():
    import jax.numpy as jnp
    from cycloneml_tpu.graph import Graph as RGraph
    from cycloneml_tpu.graph import lib as rlib
    from cycloneml_tpu.graph import pregel as rpregel
    return types.SimpleNamespace(Graph=RGraph, lib=rlib, pregel=rpregel,
                                 jnp=jnp)


def _port():
    return types.SimpleNamespace(Graph=Graph, lib=glib, pregel=pregel)


def _both(rctx, pctx, case):
    """``case(pkg, context)`` run on the reference and on the port."""
    return case(_ref(), rctx), case(_port(), pctx)


# -- the reference's cases, through both packages -----------------------------

def _tri(pkg, c):
    return pkg.Graph(c, np.array([0, 0, 1]), np.array([1, 2, 2]),
                     n_vertices=3)


def test_degrees(rctx, pctx):
    def case(pkg, c):
        g = _tri(pkg, c)
        out = (g.out_degrees(), g.in_degrees(), g.degrees())
        assert np.array_equal(out[0], [2, 1, 0])
        assert np.array_equal(out[1], [0, 1, 2])
        assert np.array_equal(out[2], [2, 2, 2])
        return out
    ref, got = _both(rctx, pctx, case)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(a), b)
        assert b.dtype == np.float32


def test_reverse_subgraph(rctx, pctx):
    def case(pkg, c):
        g = _tri(pkg, c)
        rev = g.reverse()
        assert np.array_equal(rev.out_degrees(), [0, 1, 2])
        sub = g.subgraph(lambda s, d, a: d != 2)
        assert sub.n_edges == 1 and np.array_equal(sub.out_degrees(),
                                                   [1, 0, 0])
        return np.asarray(rev.out_degrees()), np.asarray(sub.in_degrees())
    ref, got = _both(rctx, pctx, case)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(a, b)


def test_from_edges_remaps_ids(rctx, pctx):
    def case(pkg, c):
        g = pkg.Graph.from_edges(c, [(100, 200), (200, 300)])
        assert g.n_vertices == 3
        assert np.array_equal(g.vertex_ids, [100, 200, 300])
        return g.vertex_ids, g._h_src, g._h_dst
    ref, got = _both(rctx, pctx, case)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(a, b)


def _dense_pagerank(src, dst, n, iters):
    a = np.zeros((n, n))
    for s, d in zip(src, dst):
        a[s, d] += 1.0
    outdeg = a.sum(axis=1)
    inv = np.where(outdeg > 0, 1.0 / np.maximum(outdeg, 1), 0.0)
    r = np.ones(n)
    for _ in range(iters):
        r = 0.15 + 0.85 * a.T @ (r * inv)
    return r


def test_pagerank_matches_dense_reference(rctx, pctx):
    rng = np.random.RandomState(3)
    n, e = 12, 40
    src = rng.randint(0, n, e).astype(np.int64)
    dst = rng.randint(0, n, e).astype(np.int64)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    r = _dense_pagerank(src, dst, n, 15)

    def case(pkg, c):
        ranks = pkg.lib.pagerank(pkg.Graph(c, src, dst, n_vertices=n),
                                 num_iter=15)
        assert np.allclose(ranks, r, atol=1e-4)
        return np.asarray(ranks)
    ref, got = _both(rctx, pctx, case)
    np.testing.assert_allclose(got, ref, rtol=PR_RTOL)


def test_pagerank_personalized(rctx, pctx):
    def case(pkg, c):
        g = pkg.Graph(c, np.array([0, 1, 2]), np.array([1, 2, 0]),
                      n_vertices=3)
        r = pkg.lib.pagerank(g, num_iter=30, personalized_src=0)
        assert r[0] == max(r)
        return np.asarray(r)
    ref, got = _both(rctx, pctx, case)
    np.testing.assert_allclose(got, ref, rtol=PR_RTOL)


def test_connected_components(rctx, pctx):
    def case(pkg, c):
        g = pkg.Graph(c, np.array([0, 1, 3]), np.array([1, 2, 4]),
                      n_vertices=6)
        labels = pkg.lib.connected_components(g)
        assert np.array_equal(labels, [0, 0, 0, 3, 3, 5])
        return labels
    ref, got = _both(rctx, pctx, case)
    np.testing.assert_array_equal(got, ref)
    assert got.dtype == np.int64


def test_shortest_paths(rctx, pctx):
    def case(pkg, c):
        g = pkg.Graph(c, np.array([0, 1, 2]), np.array([1, 2, 3]),
                      n_vertices=5)
        d = pkg.lib.shortest_paths(g, landmarks=[3, 1])
        assert np.array_equal(d[:4, 0], [3, 2, 1, 0])
        assert np.isinf(d[4, 0]) and d[0, 1] == 1 and np.isinf(d[2, 1])
        return d
    ref, got = _both(rctx, pctx, case)
    np.testing.assert_array_equal(got, ref)


def test_triangle_count(rctx, pctx):
    def case(pkg, c):
        src, dst = zip(*[(i, j) for i in range(4) for j in range(4) if i < j])
        g = pkg.Graph(c, np.array(src), np.array(dst), n_vertices=4)
        k4 = pkg.lib.triangle_count(g)
        assert np.array_equal(k4, [3, 3, 3, 3])
        g2 = pkg.Graph(c, np.array([0, 1, 2, 3]), np.array([1, 2, 3, 0]),
                       n_vertices=4)
        cyc = pkg.lib.triangle_count(g2)
        assert np.array_equal(cyc, [0, 0, 0, 0])
        return k4, cyc
    ref, got = _both(rctx, pctx, case)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(b, a)


def test_label_propagation_two_cliques(rctx, pctx):
    edges = [(i, j) for i in range(4) for j in range(4) if i < j]
    edges += [(i, j) for i in range(4, 8) for j in range(4, 8) if i < j]
    src = np.array([e[0] for e in edges])
    dst = np.array([e[1] for e in edges])

    def case(pkg, c):
        labels = pkg.lib.label_propagation(
            pkg.Graph(c, src, dst, n_vertices=8), max_iter=10)
        assert len(set(labels[:4])) == 1 and len(set(labels[4:])) == 1
        assert labels[0] != labels[4]
        return labels
    ref, got = _both(rctx, pctx, case)
    np.testing.assert_array_equal(got, ref)


def test_scc(rctx, pctx):
    def case(pkg, c):
        g = pkg.Graph(c, np.array([0, 1, 2, 3]), np.array([1, 2, 0, 0]),
                      n_vertices=5)
        labels = pkg.lib.strongly_connected_components(g)
        assert np.array_equal(labels, [0, 0, 0, 3, 4])
        return labels
    ref, got = _both(rctx, pctx, case)
    np.testing.assert_array_equal(got, ref)


def test_svd_plus_plus(rctx, pctx):
    src = np.array([0, 0, 0, 1, 1])
    dst = np.array([2, 3, 4, 2, 3])
    ratings = np.array([5.0, 3.0, 4.0, 4.0, 2.0], dtype=np.float32)

    def case(pkg, c):
        g = pkg.Graph(c, src, dst, edge_attr=ratings, n_vertices=5)
        m0 = pkg.lib.svd_plus_plus(g, rank=4, max_iter=0)
        m = pkg.lib.svd_plus_plus(g, rank=4, max_iter=30)
        assert np.isfinite(m["rmse"]) and m["rmse"] <= m0["rmse"] + 1e-9
        assert m["rmse"] < 1.2
        return m
    ref, got = _both(rctx, pctx, case)
    assert got["rmse"] == pytest.approx(ref["rmse"], rel=RMSE_RTOL)
    for k in ("p", "q", "y", "bias"):
        np.testing.assert_allclose(got[k], np.asarray(ref[k]), rtol=SVD_RTOL,
                                   atol=1e-6)


def test_pregel_connected_components(rctx, pctx):
    """The generic Pregel API: min-label propagation."""
    r = _ref()
    jnp = r.jnp
    g = r.Graph(rctx, np.array([0, 1, 3]), np.array([1, 2, 4]), n_vertices=5)
    ref = r.pregel(
        g, jnp.arange(5, dtype=jnp.float32), np.inf,
        lambda attr, msg, has: jnp.minimum(attr, msg),
        send_to_dst=lambda sa, da, e, s, d: (
            sa, (sa < da).astype(jnp.float32) * s),
        send_to_src=lambda sa, da, e, s, d: (
            da, (da < sa).astype(jnp.float32) * d),
        merge="min", max_iter=10)
    pg = Graph(pctx, np.array([0, 1, 3]), np.array([1, 2, 4]), n_vertices=5)
    out = pregel(
        pg, torch.arange(5, dtype=torch.float32), np.inf,
        lambda attr, msg, has: torch.minimum(attr, msg),
        send_to_dst=lambda sa, da, e, s, d: (sa, (sa < da).float() * s),
        send_to_src=lambda sa, da, e, s, d: (da, (da < sa).float() * d),
        merge="min", max_iter=10)
    assert np.array_equal(out.numpy(), [0, 0, 0, 3, 3])
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_aggregate_messages_weighted(rctx, pctx):
    r = _ref()
    src, dst = np.array([0, 1]), np.array([2, 2])
    attr = np.array([2.0, 5.0], dtype=np.float32)
    ref = r.Graph(rctx, src, dst, edge_attr=attr, n_vertices=3) \
        .aggregate_messages(r.jnp.ones(3, dtype=r.jnp.float32),
                            to_dst=lambda sa, da, e: sa * e)
    out = Graph(pctx, src, dst, edge_attr=attr, n_vertices=3) \
        .aggregate_messages(torch.ones(3), to_dst=lambda sa, da, e: sa * e)
    assert np.allclose(out.numpy(), [0, 0, 7.0])
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


# -- parity on random graphs ---------------------------------------------------

def test_from_edges_matches_the_reference_on_1e5_ids(rctx, pctx):
    """10^5 random int64 ids (50,000 edges): the port's ``np.unique``
    remap gives the reference's vertex ids and edges exactly."""
    rng = np.random.RandomState(41)
    edges = rng.randint(-2 ** 62, 2 ** 62, size=(50_000, 2), dtype=np.int64)
    ref = _ref().Graph.from_edges(rctx, [tuple(e) for e in edges])
    got = Graph.from_edges(pctx, edges)
    assert got.n_vertices == ref.n_vertices == len(np.unique(edges))
    np.testing.assert_array_equal(got.vertex_ids, ref.vertex_ids)
    np.testing.assert_array_equal(got._h_src, ref._h_src)
    np.testing.assert_array_equal(got._h_dst, ref._h_dst)
    # the list form, as the reference takes it
    pairs = [tuple(e) for e in edges[:100]]
    again, ref100 = Graph.from_edges(pctx, pairs), \
        _ref().Graph.from_edges(rctx, pairs)
    np.testing.assert_array_equal(again.vertex_ids, ref100.vertex_ids)
    np.testing.assert_array_equal(again._h_src, ref100._h_src)
    np.testing.assert_array_equal(again._h_dst, ref100._h_dst)


def _random_graph(seed, n=60, e=240, loops=False):
    rng = np.random.RandomState(seed)
    src = rng.randint(0, n, e)
    dst = rng.randint(0, n, e)
    if not loops:
        keep = src != dst
        src, dst = src[keep], dst[keep]
    attr = rng.rand(len(src)).astype(np.float32)
    return src, dst, attr, n


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_structure_and_labels_equal_the_reference(rctx, pctx, seed):
    """Degrees, CC, SCC, triangles, shortest paths and label propagation
    exactly the reference's on seeded random graphs (a few components
    each: the edges are sparse)."""
    src, dst, attr, n = _random_graph(seed, e=70)
    r = _ref()
    rg = r.Graph(rctx, src, dst, edge_attr=attr, n_vertices=n)
    pg = Graph(pctx, src, dst, edge_attr=attr, n_vertices=n)
    for name in ("in_degrees", "out_degrees", "degrees"):
        np.testing.assert_array_equal(getattr(pg, name)(),
                                      np.asarray(getattr(rg, name)()))
    for fn, kw in (("connected_components", {}),
                   ("strongly_connected_components", {}),
                   ("triangle_count", {}),
                   ("label_propagation", {"max_iter": 5}),
                   ("shortest_paths", {"landmarks": [0, 5, 17]})):
        got = getattr(glib, fn)(pg, **kw)
        want = getattr(r.lib, fn)(rg, **kw)
        np.testing.assert_array_equal(got, np.asarray(want), err_msg=fn)
    # the structural operators
    for a, b in ((pg.undirected(), rg.undirected()), (pg.reverse(),
                                                      rg.reverse())):
        np.testing.assert_array_equal(a._h_src, b._h_src)
        np.testing.assert_array_equal(a._h_dst, b._h_dst)
        np.testing.assert_array_equal(a._h_attr, b._h_attr)
    sub_p = pg.map_edges(lambda a: a * 2).subgraph(lambda s, d, a: a > 0.5)
    sub_r = rg.map_edges(lambda a: a * 2).subgraph(lambda s, d, a: a > 0.5)
    assert sub_p.n_edges == sub_r.n_edges
    np.testing.assert_array_equal(sub_p.out_degrees(),
                                  np.asarray(sub_r.out_degrees()))


@pytest.mark.parametrize("seed", [0, 1])
def test_pagerank_on_random_graphs(rctx, pctx, seed):
    src, dst, attr, n = _random_graph(seed, n=200, e=2000)
    want = _ref().lib.pagerank(_ref().Graph(rctx, src, dst, n_vertices=n),
                               num_iter=20)
    got = glib.pagerank(Graph(pctx, src, dst, n_vertices=n), num_iter=20)
    np.testing.assert_allclose(got, np.asarray(want), rtol=PR_RTOL)
    np.testing.assert_allclose(got, _dense_pagerank(src, dst, n, 20),
                               atol=1e-4)
    pers = glib.pagerank(Graph(pctx, src, dst, n_vertices=n), num_iter=20,
                         personalized_src=3, tol=1e-6)
    pref = _ref().lib.pagerank(_ref().Graph(rctx, src, dst, n_vertices=n),
                               num_iter=20, personalized_src=3, tol=1e-6)
    np.testing.assert_allclose(pers, np.asarray(pref), rtol=PR_RTOL,
                               atol=1e-7)


def test_pregel_sum_merge_equals_the_reference(rctx, pctx):
    """A sum-merge Pregel (its receipt count channel): each vertex adds the
    labels its active in-neighbors send, for a few supersteps."""
    src, dst, attr, n = _random_graph(4, n=30, e=60)
    r = _ref()
    jnp = r.jnp
    ref = r.pregel(
        r.Graph(rctx, src, dst, edge_attr=attr, n_vertices=n),
        jnp.arange(n, dtype=jnp.float32), 1.0,
        lambda a, m, h: a + m,
        send_to_dst=lambda sa, da, e, s, d: (
            sa * e, (sa < 1000.0).astype(jnp.float32) * s),
        merge="sum", max_iter=4)
    got = pregel(
        Graph(pctx, src, dst, edge_attr=attr, n_vertices=n),
        torch.arange(n, dtype=torch.float32), 1.0,
        lambda a, m, h: a + m,
        send_to_dst=lambda sa, da, e, s, d: (sa * e,
                                             (sa < 1000.0).float() * s),
        merge="sum", max_iter=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)


def test_svd_plus_plus_matches_the_reference(rctx, pctx):
    """SVD++ on a seeded bipartite rating graph (30 users, 20 items) at
    ``max_iter`` 10: the same initial factors (one RandomState), then
    factors within rtol 1e-4 and the RMSE within 1e-5."""
    rng = np.random.RandomState(9)
    users, items, e = 30, 20, 200
    pairs = np.unique(np.stack([rng.randint(0, users, e),
                                users + rng.randint(0, items, e)], 1),
                      axis=0)
    ratings = rng.randint(1, 6, len(pairs)).astype(np.float32)
    r = _ref()
    want = r.lib.svd_plus_plus(
        r.Graph(rctx, pairs[:, 0], pairs[:, 1], edge_attr=ratings,
                n_vertices=users + items), rank=4, max_iter=10, seed=3)
    got = glib.svd_plus_plus(
        Graph(pctx, pairs[:, 0], pairs[:, 1], edge_attr=ratings,
              n_vertices=users + items), rank=4, max_iter=10, seed=3)
    assert got["mean"] == want["mean"]
    assert got["rmse"] == pytest.approx(want["rmse"], rel=RMSE_RTOL)
    for k in ("p", "q", "y", "bias"):
        np.testing.assert_allclose(got[k], np.asarray(want[k]),
                                   rtol=SVD_RTOL, atol=1e-6, err_msg=k)


def test_merge_identity_matches_the_reference():
    from cycloneml_tpu.graph.graph import merge_identity as ref_identity
    from cycloneml_tpu_torch.graph.graph import merge_identity
    for dt, ndt in ((torch.float32, np.float32), (torch.float64, np.float64),
                    (torch.int32, np.int32)):
        for merge in ("sum", "min", "max"):
            assert merge_identity(dt, merge).item() == \
                np.asarray(ref_identity(ndt, merge)).item()


# -- the segment reduction's plain version ------------------------------------

def _segments(seed, n=40, m=300, k=3, dtype=np.float32, empty=(3, 7, 39)):
    rng = np.random.RandomState(seed)
    dst = rng.randint(0, n, m)
    other = next(u for u in range(n) if u not in empty)
    for v in empty:
        dst[dst == v] = other
    if np.issubdtype(dtype, np.integer):
        x = rng.randint(-2 ** 31, 2 ** 31 - 1, size=(m, k)).astype(dtype)
    else:
        x = rng.randn(m, k).astype(dtype)
    return dst, x, n


def _numpy_segments(dst, x, n, merge):
    """The truth by a loop over the destinations."""
    dt = x.dtype
    ident = kernels.merge_identity(
        {np.dtype(np.float32): torch.float32,
         np.dtype(np.float64): torch.float64,
         np.dtype(np.int32): torch.int32}[dt], merge)
    out = np.full((n,) + x.shape[1:], ident, dtype=dt)
    for v in range(n):
        rows = x[dst == v]
        if not len(rows):
            continue
        if merge == "sum":
            acc = rows.astype(np.float64 if dt.kind == "f" else np.int64)
            s = acc.sum(axis=0)
            out[v] = s.astype(dt) if dt.kind == "f" else \
                ((s + 2 ** 31) % 2 ** 32 - 2 ** 31).astype(dt)
        else:
            out[v] = rows.min(axis=0) if merge == "min" else rows.max(axis=0)
    return out


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32])
@pytest.mark.parametrize("merge", ["sum", "min", "max"])
@pytest.mark.parametrize("k", [1, 3, 33])
def test_segment_reduce_plain_matches_a_numpy_loop(dtype, merge, k):
    """Exact for min, max and int32 sums (wrapped to int32); float sums
    within one rounding of the float64 sum. Empty segments hold the
    identity."""
    dst, x, n = _segments(k, k=k, dtype=dtype)
    want = _numpy_segments(dst, x, n, merge)
    perm, offsets = kernels.segment_order(torch.from_numpy(dst), n)
    xt = torch.from_numpy(x)
    got = kernels.segment_reduce_plain(xt[perm], offsets, merge)
    by_rows = kernels.segment_reduce(xt, offsets, merge, rows=perm)
    assert kernels.segment_reduce.launches == 0
    np.testing.assert_array_equal(by_rows.numpy(), got.numpy())
    if merge == "sum" and dtype != np.int32:
        # the float64 sums of both differ in their order: within m 2^-53 of
        # the values' magnitudes, then one rounding to the rows' dtype
        mag = _numpy_segments(dst, np.abs(x).astype(np.float64), n, "sum")
        err = np.abs(got.numpy().astype(np.float64) - want)
        assert (err <= np.finfo(dtype).eps * np.abs(want)
                + len(dst) * 2.0 ** -53 * mag).all()
    else:
        np.testing.assert_array_equal(got.numpy(), want)
    for v in (3, 7, 39):
        assert (got[v].numpy() == want[v]).all()
    # messages with a trailing shape come back with it
    got3 = kernels.segment_reduce_plain(xt[perm].reshape(len(dst), k, 1),
                                        offsets, merge)
    assert got3.shape == (n, k, 1)


def test_segment_reduce_accumulate_form():
    """out[v] += Σ rows of v, in float64 with out's value, rounded once;
    rows of empty segments untouched."""
    dst, x, n = _segments(5, k=4)
    w = np.random.RandomState(6).randn(n, 4).astype(np.float32)
    perm, offsets = kernels.segment_order(torch.from_numpy(dst), n)
    wt = torch.from_numpy(w.copy())
    ret = kernels.segment_reduce(torch.from_numpy(x), offsets, rows=perm,
                                 out=wt)
    assert ret is wt
    want = w.astype(np.float64)
    np.add.at(want, dst, x.astype(np.float64))
    np.testing.assert_array_equal(wt.numpy(), want.astype(np.float32))
    assert (wt.numpy()[[3, 7, 39]] == w[[3, 7, 39]]).all()
    with pytest.raises(ValueError, match="accumulate form is a sum"):
        kernels.segment_reduce(torch.from_numpy(x), offsets, "min",
                               rows=perm, out=wt)


def test_segment_order_is_a_stable_sort():
    rng = np.random.RandomState(8)
    dst = rng.randint(0, 50, 1000)
    dst[dst == 10] = 11
    perm, offsets = kernels.segment_order(torch.from_numpy(dst), 50)
    np.testing.assert_array_equal(perm.numpy(),
                                  np.argsort(dst, kind="stable"))
    np.testing.assert_array_equal(
        offsets.numpy(), np.concatenate([[0], np.cumsum(
            np.bincount(dst, minlength=50))]))
    with pytest.raises(ValueError, match="out of"):
        kernels.segment_order(torch.tensor([0, 50]), 50)


def test_segment_pieces_cut_segments_in_row_order():
    """Each segment's ceil(count / piece_rows) pieces, one at least (an
    empty segment's piece is empty), numbered in segment order; the
    segments of several pieces listed."""
    counts = np.array([0, 3, 1025, 512, 513, 0])
    offsets = torch.from_numpy(np.concatenate([[0], np.cumsum(counts)]))
    plan = kernels.segment_pieces(offsets)
    assert plan.piece_rows == kernels.SEGMENT_PIECE_ROWS == 512
    pieces = [1, 1, 3, 1, 2, 1]
    m = int(counts.sum())
    # sized from shapes: the segments plus the rows over piece_rows, the
    # pieces past the real count naming segment n, multi padded with -1
    assert plan.n_pieces == 6 + m // 512 >= sum(pieces)
    np.testing.assert_array_equal(
        plan.piece_seg.numpy(),
        np.concatenate([np.repeat(np.arange(6), pieces),
                        np.full(plan.n_pieces - sum(pieces), 6)]))
    np.testing.assert_array_equal(plan.piece_start.numpy(),
                                  np.concatenate([[0], np.cumsum(pieces)]))
    np.testing.assert_array_equal(plan.multi.numpy(),
                                  [2, 4] + [-1] * (m // 513 - 2))
    assert plan.piece_seg.dtype == plan.multi.dtype == torch.int32
    given = kernels.segment_pieces(offsets, rows=m)
    for a, b in zip(given, plan):
        assert (torch.equal(a, b) if torch.is_tensor(a) else a == b)
    small = kernels.segment_pieces(offsets, piece_rows=7)
    assert small.piece_start[-1] == 1 + 1 + 147 + 74 + 74 + 1
    # the plain version takes a plan for its offsets
    x = torch.randn(int(counts.sum()), 2, dtype=torch.float64)
    np.testing.assert_array_equal(
        kernels.segment_reduce(x, small).numpy(),
        kernels.segment_reduce_plain(x, offsets).numpy())
    with pytest.raises(ValueError, match="at least 1"):
        kernels.segment_pieces(offsets, piece_rows=0)


def test_graph_plain_route_gives_the_same_results(pctx):
    """``cyclone.ml.usePallasKernels=false`` takes the plain version; on
    the CPU both routes are the plain version, so every result is the
    same."""
    src, dst, attr, n = _random_graph(3)
    g = Graph(pctx, src, dst, edge_attr=attr, n_vertices=n)
    a = glib.pagerank(g), glib.connected_components(g)
    pctx.conf.set("cyclone.ml.usePallasKernels", "false")
    b = glib.pagerank(g), glib.connected_components(g)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_graph_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CycloneContext(CycloneConf().set("cyclone.master", "cuda"))
    with pytest.raises(ValueError, match="no kernel"):
        kernels.segment_reduce(torch.zeros((4, 2), device="meta"),
                               torch.zeros(3, dtype=torch.int64,
                                           device="meta"))


# -- on the card ------------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _cuda_context(**conf):
    _cuda()
    c = CycloneConf().set("cyclone.master", "cuda")
    for key, v in conf.items():
        c.set(key, v)
    return CycloneContext(c)


def _cuda_check(x, dst, n, merge, rows_form):
    """The kernel against its plain version on the card (exact for min,
    max and int32; float32 sums within one float rounding of the float64
    plain sum, float64 sums within 1e-15 relative), twice bitwise."""
    dev = _cuda()
    xd = torch.from_numpy(x).to(dev)
    perm, offsets = kernels.segment_order(torch.from_numpy(dst).to(dev), n)
    kernels.reset_launch_counts()
    if rows_form:
        got = kernels.segment_reduce(xd, offsets, merge, rows=perm)
        again = kernels.segment_reduce(xd, offsets, merge, rows=perm)
    else:
        xs = xd[perm].contiguous()
        got = kernels.segment_reduce(xs, offsets, merge)
        again = kernels.segment_reduce(xs, offsets, merge)
    torch.cuda.synchronize()
    assert kernels.segment_reduce.launches == 2
    inst = kernels.segment_instance(xd.dtype, merge)
    assert kernels.segment_reduce.launches_by_instance[inst] == 2
    assert torch.equal(got, again)
    if merge == "sum" and xd.dtype.is_floating_point:
        # both sum in double in other orders (each within its rows' count
        # x 2^-53 of the magnitudes), the kernel's float32 rounded once
        truth = kernels.segment_reduce_plain(xd.double(), offsets, merge,
                                             rows=perm)
        tol = 2.0 ** -24 if xd.dtype == torch.float32 else 0.0
        mag = kernels.segment_reduce_plain(xd.double().abs(), offsets,
                                           merge, rows=perm)
        count = torch.diff(offsets).double().reshape(
            (-1,) + (1,) * (mag.dim() - 1))
        err = (got.double() - truth).abs()
        bound = tol * truth.abs() + 2 * count * 2.0 ** -53 * mag
        assert bool((err <= bound).all()), float((err - bound).max())
    else:
        truth = kernels.segment_reduce_plain(xd, offsets, merge, rows=perm)
        assert torch.equal(got, truth)
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32])
@pytest.mark.parametrize("merge", ["sum", "min", "max"])
@pytest.mark.parametrize("k", [1, 2, 5, 32, 100, 4096])
def test_cuda_segment_reduce_matches_its_plain_version(dtype, merge, k):
    n = 3000 if k < 1000 else 200
    m = 40_000 if k < 1000 else 2_000
    dst, x, n = _segments(k, n=n, m=m, k=k, dtype=dtype,
                          empty=(0, 17, n - 1))
    got = _cuda_check(x, dst, n, merge, rows_form=k % 2 == 0)
    want_empty = kernels.merge_identity(got.dtype, merge)
    assert bool((got[[0, 17, n - 1]] == want_empty).all())


@pytest.mark.gpu
def test_cuda_segment_reduce_hub_and_int32_labels():
    """A hub segment of 200,000 rows beside 10^5 short ones (k = 1, as
    PageRank's) and int32 labels near 2^31 (min and max exact)."""
    rng = np.random.RandomState(12)
    n = 100_000
    dst = np.concatenate([np.full(200_000, 5), rng.randint(0, n, 300_000)])
    x = rng.rand(len(dst), 1).astype(np.float32)
    _cuda_check(x, dst, n, "sum", rows_form=False)
    lab = (2 ** 31 - 1 - rng.randint(0, 1000, (len(dst), 1))).astype(
        np.int32)
    for merge in ("min", "max"):
        _cuda_check(lab, dst, n, merge, rows_form=True)
        _cuda_check(-lab, dst, n, merge, rows_form=False)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32])
@pytest.mark.parametrize("merge", ["sum", "min", "max"])
@pytest.mark.parametrize("k", [1, 3, 100])
def test_cuda_segment_reduce_in_small_pieces(dtype, merge, k):
    """Pieces of 7 rows: almost every segment is merged from its pieces'
    partials (the merge kernel), held against the plain version as in
    _cuda_check; two launches bitwise equal."""
    dev = _cuda()
    dst, x, n = _segments(40 + k, n=700, m=20_000, k=k, dtype=dtype,
                          empty=(1, 2, 699))
    dst[:3000] = 5                          # a hub of 3,000 rows or more
    xd = torch.from_numpy(x).to(dev)
    perm, offsets = kernels.segment_order(torch.from_numpy(dst).to(dev), n)
    plan = kernels.segment_pieces(offsets, piece_rows=7)
    assert int((plan.multi >= 0).sum()) > n // 2
    got = kernels.segment_reduce(xd, plan, merge, rows=perm)
    again = kernels.segment_reduce(xd, plan, merge, rows=perm)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    if merge == "sum" and xd.dtype.is_floating_point:
        truth = kernels.segment_reduce_plain(xd.double(), offsets, merge,
                                             rows=perm)
        mag = kernels.segment_reduce_plain(xd.double().abs(), offsets,
                                           merge, rows=perm)
        count = torch.diff(offsets).double()[:, None]
        tol = 2.0 ** -24 if xd.dtype == torch.float32 else 0.0
        err = (got.double() - truth).abs()
        assert bool((err <= tol * truth.abs()
                     + 2 * count * 2.0 ** -53 * mag).all())
    else:
        assert torch.equal(got, kernels.segment_reduce_plain(
            xd, offsets, merge, rows=perm))
    if merge == "sum" and dtype == np.float32:
        w0 = torch.randn(n, k, device=dev)
        w1 = w0.clone()
        kernels.segment_reduce(xd, plan, rows=perm, out=w1)
        truth = w0.double()
        kernels.segment_reduce_plain(xd.double(), offsets, rows=perm,
                                     out=truth)
        assert bool(((w1.double() - truth).abs()
                     <= 2.0 ** -24 * truth.abs() + 1e-9).all())
        assert torch.equal(w1[[1, 2, 699]], w0[[1, 2, 699]])


@pytest.mark.gpu
def test_cuda_segment_reduce_accumulate_form():
    dev = _cuda()
    rng = np.random.RandomState(13)
    n, k, m = 5000, 100, 40_960
    dst = rng.randint(0, n, m)
    w0 = torch.from_numpy(rng.randn(n, k).astype(np.float32)).to(dev)
    upd = torch.from_numpy(rng.randn(m, k).astype(np.float32)).to(dev)
    perm, offsets = kernels.segment_order(torch.from_numpy(dst).to(dev), n)
    kernels.reset_launch_counts()
    w1, w2 = w0.clone(), w0.clone()
    kernels.segment_reduce(upd, offsets, rows=perm, out=w1)
    kernels.segment_reduce(upd, offsets, rows=perm, out=w2)
    torch.cuda.synchronize()
    assert torch.equal(w1, w2)
    assert kernels.segment_reduce.launches_by_instance[
        "f32_sum_accumulate"] == 2
    truth = w0.double().clone()
    kernels.segment_reduce_plain(upd.double(), offsets, rows=perm, out=truth)
    err = (w1.double() - truth).abs()
    assert bool((err <= 2.0 ** -24 * truth.abs() + 1e-12).all())
    untouched = torch.diff(offsets) == 0
    assert torch.equal(w1[untouched], w0[untouched])


@pytest.mark.gpu
def test_cuda_segment_reduce_raises_on_what_it_does_not_take():
    dev = _cuda()
    off = torch.zeros(3, dtype=torch.int64, device=dev)
    with pytest.raises(ValueError, match="float32, float64 or int32"):
        kernels.segment_reduce(torch.zeros((4, 2), dtype=torch.int64,
                                           device=dev), off)
    with pytest.raises(ValueError, match="int64"):
        kernels.segment_reduce(torch.zeros((4, 2), device=dev),
                               off.to(torch.int32))


@pytest.mark.gpu
def test_cuda_graph_library_equals_the_plain_route():
    """PageRank within one float rounding a step of the plain route and
    bitwise on a refit; CC, SCC, triangles, shortest paths and label
    propagation exactly the plain route's; SVD++ within rtol 1e-4."""
    src, dst, attr, n = _random_graph(21, n=3000, e=40_000)
    out = {}
    for mode in ("auto", "false"):
        c = _cuda_context(**{"cyclone.ml.usePallasKernels": mode})
        try:
            kernels.reset_launch_counts()
            g = Graph(c, src, dst, edge_attr=attr, n_vertices=n)
            out[mode] = {
                "pr": glib.pagerank(g), "pr2": glib.pagerank(g),
                "cc": glib.connected_components(g),
                "sp": glib.shortest_paths(g, [0, 7, 99]),
                "lp": glib.label_propagation(
                    Graph(c, src[:3000] % 500, dst[:3000] % 500,
                          n_vertices=500)),
                "svd": glib.svd_plus_plus(g, rank=4, max_iter=3)["p"]}
            small = Graph(c, src % 400, dst % 400, n_vertices=400)
            out[mode]["tri"] = glib.triangle_count(small)
            out[mode]["scc"] = glib.strongly_connected_components(small)
            out[mode]["launches"] = kernels.segment_reduce.launches
        finally:
            c.stop()
    k, p = out["auto"], out["false"]
    assert k["launches"] > 0 and p["launches"] == 0
    np.testing.assert_array_equal(k["pr"], k["pr2"])
    np.testing.assert_allclose(k["pr"], p["pr"], rtol=1e-5)
    for key in ("cc", "sp", "lp", "tri", "scc"):
        np.testing.assert_array_equal(k[key], p[key], err_msg=key)
    np.testing.assert_allclose(k["svd"], p["svd"], rtol=1e-4, atol=1e-6)
