"""Graph algorithm library.

The port's counterpart of ``cycloneml_tpu/graph/lib.py`` (ref: graphx/src/
main/scala/org/apache/spark/graphx/lib/): PageRank, ConnectedComponents,
StronglyConnectedComponents, LabelPropagation, ShortestPaths, TriangleCount,
SVDPlusPlus. Each algorithm builds its message program(s) once and
iterates a host loop reading one scalar an iteration, as the reference's
do; every merge goes through ``csrc/segment_reduce.cu`` on the card. The
closure-based algorithms (SCC, triangles) use the dense adjacency: their
products are float32 ``torch.matmul`` with TF32 off, the reference's
``Precision.HIGHEST`` products (0/1 matrices, so every count below 2^24 is
exact).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from cycloneml_tpu_torch.graph.graph import Graph
from cycloneml_tpu_torch.ml.optim.aggregators import precision_scope


def pagerank(graph: Graph, num_iter: int = 20, reset_prob: float = 0.15,
             tol: Optional[float] = None,
             personalized_src: Optional[int] = None,
             dtype: torch.dtype = torch.float32) -> np.ndarray:
    """PageRank (ref lib/PageRank.scala — run/runUntilConvergence/
    runWithOptions personalized). Returns per-vertex ranks (Spark semantics:
    ranks sum ≈ n, each init 1.0; rank = resetProb + (1−resetProb)·Σ
    incoming rank/outDegree). ``dtype``: the ranks' type, float32 as the
    reference's; float64 gives a check its twin."""
    n, dev = graph.n_vertices, graph.device
    out_deg = torch.as_tensor(graph.out_degrees(), device=dev).to(dtype)
    inv_deg = torch.where(out_deg > 0, 1.0 / torch.clamp(out_deg, min=1.0),
                          torch.zeros((), dtype=dtype, device=dev))
    prog = graph.message_program(to_dst=lambda sa, da, e: sa, merge="sum")
    if personalized_src is None:
        reset = torch.full((n,), reset_prob, dtype=dtype, device=dev)
    else:
        reset = torch.zeros((n,), dtype=dtype, device=dev)
        reset[personalized_src] = reset_prob
    ranks = torch.ones((n,), dtype=dtype, device=dev)
    for _ in range(num_iter):
        contrib = prog(ranks * inv_deg)
        new = reset + (1.0 - reset_prob) * contrib
        if tol is not None and float(torch.max(torch.abs(new - ranks))) < tol:
            ranks = new
            break
        ranks = new
    return ranks.cpu().numpy()


def connected_components(graph: Graph, max_iter: int = 100) -> np.ndarray:
    """Connected components: each vertex labeled with the smallest vertex id
    in its component, edges treated as undirected (ref
    lib/ConnectedComponents.scala — Pregel with min-merge); int32 labels
    on the card, int64 returned."""
    labels, _ = connected_components_iters(graph, max_iter)
    return labels


def connected_components_iters(graph: Graph, max_iter: int = 100):
    """:func:`connected_components` and the supersteps it ran."""
    prog = graph.message_program(
        to_dst=lambda sa, da, e: sa, to_src=lambda sa, da, e: da, merge="min")
    labels = torch.arange(graph.n_vertices, dtype=torch.int32,
                          device=graph.device)
    it = 0
    for it in range(1, max_iter + 1):
        new = torch.minimum(labels, prog(labels))
        if bool(torch.all(new == labels)):
            break
        labels = new
    return labels.cpu().numpy().astype(np.int64), it


def label_propagation(graph: Graph, max_iter: int = 5) -> np.ndarray:
    """Community detection by label propagation (ref
    lib/LabelPropagation.scala): each vertex adopts the most frequent label
    among neighbors; ties break to the smallest label (deterministic, where
    the reference's hashmap order is not). Dense n-wide one-hot histogram
    messages — one segment sum a superstep."""
    n, dev = graph.n_vertices, graph.device

    def onehot(lab):
        return torch.nn.functional.one_hot(lab.long(), n).to(torch.float32)

    prog = graph.message_program(
        to_dst=lambda sa, da, e: onehot(sa),
        to_src=lambda sa, da, e: onehot(da), merge="sum")
    labels = torch.arange(n, dtype=torch.int32, device=dev)
    for _ in range(max_iter):
        counts = prog(labels)  # (n, n) label histogram per vertex
        total = counts.sum(dim=1)
        best = torch.argmax(counts, dim=1).to(torch.int32)  # first max
        labels = torch.where(total > 0, best, labels)
    return labels.cpu().numpy().astype(np.int64)


def shortest_paths(graph: Graph, landmarks: Sequence[int],
                   max_iter: int = 0) -> np.ndarray:
    """Hop-count shortest path distances to landmark vertices following edge
    direction (ref lib/ShortestPaths.scala — messages flow dst→src with
    incremented maps). Returns (n_vertices, n_landmarks); unreachable =
    inf."""
    dist, _ = shortest_paths_iters(graph, landmarks, max_iter)
    return dist


def shortest_paths_iters(graph: Graph, landmarks: Sequence[int],
                         max_iter: int = 0):
    """:func:`shortest_paths` and the supersteps it ran."""
    n = graph.n_vertices
    lm = np.asarray(list(landmarks), dtype=np.int64)
    dist = np.full((n, len(lm)), np.inf, dtype=np.float32)
    dist[lm, np.arange(len(lm))] = 0.0
    dist = torch.as_tensor(dist, device=graph.device)
    prog = graph.message_program(to_src=lambda sa, da, e: da + 1.0,
                                 merge="min")
    it = 0
    for it in range(1, (max_iter or n) + 1):
        new = torch.minimum(dist, prog(dist))
        if bool(torch.all(new == dist)):
            break
        dist = new
    return dist.cpu().numpy(), it


def triangle_count(graph: Graph) -> np.ndarray:
    """Per-vertex triangle counts (ref lib/TriangleCount.scala — the
    reference canonicalizes then intersects neighbor sets per edge; here the
    count is diag(A³)/2 for the symmetrized loop-free adjacency: two
    float32 products, TF32 off)."""
    a = graph.adjacency(symmetric=True)
    with precision_scope("highest", a.device):
        tri = torch.sum(torch.matmul(a, a) * a, dim=1) / 2.0
    return tri.cpu().numpy().astype(np.int64)


def strongly_connected_components(graph: Graph) -> np.ndarray:
    """SCC labels (smallest vertex id per component). The reference
    (lib/StronglyConnectedComponents.scala) runs iterative trim + forward/
    backward Pregel coloring; this form computes the boolean transitive
    closure by log₂(n) squarings of (I ∨ A) — float32 products, TF32 off —
    then labels v with min{j : v⇝j ∧ j⇝v}."""
    n = graph.n_vertices
    a = torch.zeros((n, n), dtype=torch.float32, device=graph.device)
    a[graph.src.long(), graph.dst.long()] = 1.0
    a.fill_diagonal_(1.0)
    r = a > 0
    steps = max(1, int(np.ceil(np.log2(max(n, 2)))))
    with precision_scope("highest", a.device):
        for _ in range(steps):
            rf = r.to(torch.float32)
            r = torch.minimum(torch.matmul(rf, rf) + rf,
                              torch.ones((), device=rf.device)) > 0
    m = torch.logical_and(r, r.T)
    labels = torch.argmax(m.to(torch.uint8), dim=1)  # first True = smallest
    return labels.cpu().numpy().astype(np.int64)


def svd_plus_plus(graph: Graph, rank: int = 8, max_iter: int = 10,
                  min_val: float = 0.0, max_val: float = 5.0,
                  gamma1: float = 0.007, gamma2: float = 0.007,
                  gamma6: float = 0.005, gamma7: float = 0.015,
                  seed: int = 0, dtype: torch.dtype = torch.float32
                  ) -> Dict[str, np.ndarray]:
    """SVD++ collaborative filtering on a bipartite rating graph
    (ref lib/SVDPlusPlus.scala; Koren KDD'08). Edges are (user → item) with
    rating attrs. As in the reference each epoch is a batch gradient step
    built from message programs (neighbor-factor sums, error
    back-propagation to p/q/y and biases); the factors are drawn from
    ``np.random.RandomState(seed)`` as the reference draws them, so one
    seed starts both packages from the same factors. ``dtype``: the
    factors' type, float32 as the reference's (float64 starts from the
    same float32 draws, for a check's twin). Returns factors, biases, mean
    and final training RMSE."""
    n, dev = graph.n_vertices, graph.device
    rng = np.random.RandomState(seed)
    mu = float(np.average(graph._h_attr))
    out_deg = graph.out_degrees()
    norm_u = np.where(out_deg > 0, 1.0 / np.sqrt(np.maximum(out_deg, 1.0)),
                      0.0)

    # neighbor y-sum per user: Σ_{j∈N(u)} y_j
    nsum_prog = graph.message_program(
        to_src=lambda sa, da, e: da, merge="sum")

    def _err(sa, da, e):
        pe, q, b = sa["pe"], da["q"], sa["b"] + da["b"]
        pred = mu + b + torch.sum(pe * q, dim=1)
        pred = torch.clamp(pred, min_val, max_val)
        return e - pred

    grad_q = graph.message_program(
        to_dst=lambda sa, da, e: _err(sa, da, e)[:, None] * sa["pe"],
        merge="sum")
    grad_p = graph.message_program(
        to_src=lambda sa, da, e: _err(sa, da, e)[:, None] * da["q"],
        merge="sum")
    grad_b_u = graph.message_program(to_src=lambda sa, da, e: _err(sa, da, e),
                                     merge="sum")
    grad_b_i = graph.message_program(to_dst=lambda sa, da, e: _err(sa, da, e),
                                     merge="sum")
    # y gradient: for each edge (u,j), y_j += norm_u * acc_u where
    # acc_u = Σ_i err(u,i)·q_i (== the p-gradient message)
    grad_y = graph.message_program(
        to_dst=lambda sa, da, e: sa["acc"] * sa["nrm"][:, None], merge="sum")
    sq_err = graph.message_program(
        to_src=lambda sa, da, e: _err(sa, da, e) ** 2, merge="sum")

    def draw():
        return torch.as_tensor(rng.randn(n, rank).astype(np.float32) * 0.1,
                               device=dev).to(dtype)

    p, q, y = draw(), draw(), draw()
    b = torch.zeros((n,), dtype=dtype, device=dev)
    nrm = torch.as_tensor(norm_u.astype(np.float32), device=dev).to(dtype)

    for _ in range(max_iter):
        nsum = nsum_prog(y)
        pe = p + nrm[:, None] * nsum
        state = {"pe": pe, "q": q, "b": b}
        acc = grad_p(state)
        p = p + gamma2 * (acc - gamma7 * p)
        q = q + gamma2 * (grad_q(state) - gamma7 * q)
        y = y + gamma2 * (grad_y({"pe": pe, "q": q, "b": b, "acc": acc,
                                  "nrm": nrm}) - gamma7 * y)
        b = b + gamma1 * ((grad_b_u(state) + grad_b_i(state)) - gamma6 * b)

    nsum = nsum_prog(y)
    pe = p + nrm[:, None] * nsum
    total_sq = float(torch.sum(sq_err({"pe": pe, "q": q, "b": b})))
    rmse = float(np.sqrt(total_sq / max(graph.n_edges, 1)))
    return {"p": p.cpu().numpy(), "q": q.cpu().numpy(),
            "y": y.cpu().numpy(), "bias": b.cpu().numpy(), "mean": mu,
            "rmse": rmse}
