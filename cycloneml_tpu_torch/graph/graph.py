"""Property graphs on the card.

The port's counterpart of ``cycloneml_tpu/graph/graph.py`` (ref:
graphx/src/main/scala/org/apache/spark/graphx/ — Graph, VertexRDD.scala:55,
EdgeRDD.scala:39, impl/GraphImpl.scala:35). The reference pads its edges
into equal row shards of its mesh, replicates the vertex state, and merges
each edge's message with ``jax.ops.segment_{sum,min,max}`` and a ``psum``
over the mesh. One card holds one shard, so the padding and its ``valid``
mask have no counterpart here (several devices are ROADMAP Queue 1 item 9):

- **Edges** live on the context's device in two orders, sorted stably by
  destination and by source, each with its segment offsets and their
  pieces (``ops/kernels.segment_order``, ``segment_pieces``), built once a
  graph.
- **Vertex state** is one set of tensors (or dicts and tuples of them, the
  reference's pytrees) on the same device; gathers are plain indexing.
- ``message_program`` computes ``to_dst`` messages over the
  destination-sorted edges and ``to_src`` messages over the source-sorted
  ones, and merges each by ``kernels.segment_reduce``
  (``csrc/segment_reduce.cu``): every vertex's messages reduced in a fixed
  order, so two runs give the same bits. ``cyclone.ml.usePallasKernels=
  false`` takes the plain version instead.

Vertex ids are dense ``[0, n)`` indices; ``Graph.from_edges`` remaps
arbitrary int64 ids (vectorised: ``np.unique`` with ``return_inverse``) and
keeps the mapping for user-facing results. The element types are the
reference's: float32 edge attributes, int32 ids on the card.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from cycloneml_tpu_torch.ops import kernels


class EdgeOrder(NamedTuple):
    """The edges sorted stably by one endpoint (``key``): their sources,
    destinations and attributes in that order, and the key's segments
    (``kernels.SegmentPieces``: the offsets (n + 1,) int64 and their
    pieces)."""
    src: torch.Tensor
    dst: torch.Tensor
    attr: torch.Tensor
    pieces: kernels.SegmentPieces

    @property
    def offsets(self) -> torch.Tensor:
        return self.pieces.offsets


def _edge_order(src: torch.Tensor, dst: torch.Tensor, attr: torch.Tensor,
                key: torch.Tensor, n: int) -> EdgeOrder:
    perm, offsets = kernels.segment_order(key, n, check=False)
    return EdgeOrder(src[perm], dst[perm], attr[perm],
                     kernels.segment_pieces(offsets))


def _on(dev: torch.device, a, dtype) -> torch.Tensor:
    if torch.is_tensor(a):
        return a.to(device=dev, dtype=dtype)
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)


def tree_map(fn, tree):
    """``fn`` on every tensor leaf of dicts, tuples and lists of tensors
    (the reference's ``jax.tree_util.tree_map`` over vertex pytrees)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_map2(fn, a, b):
    """``fn`` on the paired leaves of two trees of the same structure."""
    if isinstance(a, dict):
        return {k: tree_map2(fn, a[k], b[k]) for k in a}
    if isinstance(a, (tuple, list)):
        return type(a)(tree_map2(fn, x, y) for x, y in zip(a, b))
    return fn(a, b)


class Graph:
    """Immutable property graph on the context's device (ref
    graphx/Graph.scala). ``src``, ``dst`` and ``edge_attr`` may be numpy
    arrays or tensors (on any device; a graph drawn on the card stays
    there)."""

    def __init__(self, ctx, src, dst, edge_attr=None,
                 n_vertices: Optional[int] = None,
                 vertex_ids: Optional[np.ndarray] = None):
        self.ctx = ctx
        dev = ctx.device
        self.device = dev
        src_t = _on(dev, src, torch.int32)
        dst_t = _on(dev, dst, torch.int32)
        self.n_edges = int(src_t.shape[0])
        if dst_t.shape != src_t.shape:
            raise ValueError(f"src {tuple(src_t.shape)} and dst "
                             f"{tuple(dst_t.shape)} differ")
        if n_vertices is None:
            n_vertices = int(max(int(src_t.max()) if self.n_edges else -1,
                                 int(dst_t.max()) if self.n_edges else -1)
                             + 1)
        elif self.n_edges and (int(torch.minimum(src_t.min(), dst_t.min())) < 0
                               or int(torch.maximum(src_t.max(), dst_t.max()))
                               >= n_vertices):
            raise ValueError(f"vertex ids out of [0, {n_vertices})")
        self.n_vertices = n_vertices
        # external-id mapping (identity when built from dense indices)
        self.vertex_ids = (np.arange(n_vertices, dtype=np.int64)
                           if vertex_ids is None else np.asarray(vertex_ids))
        attr_t = (torch.ones(self.n_edges, dtype=torch.float32, device=dev)
                  if edge_attr is None else _on(dev, edge_attr, torch.float32))
        self.src, self.dst, self.edge_attr = src_t, dst_t, attr_t
        self._host = None
        self.by_dst = _edge_order(src_t, dst_t, attr_t, dst_t, n_vertices)
        self.by_src = _edge_order(src_t, dst_t, attr_t, src_t, n_vertices)

    # -- host copies for the structural operators (built at first use) ------
    def _host_edges(self):
        if self._host is None:
            self._host = (self.src.cpu().numpy(), self.dst.cpu().numpy(),
                          self.edge_attr.cpu().numpy())
        return self._host

    @property
    def _h_src(self) -> np.ndarray:
        return self._host_edges()[0]

    @property
    def _h_dst(self) -> np.ndarray:
        return self._host_edges()[1]

    @property
    def _h_attr(self) -> np.ndarray:
        return self._host_edges()[2]

    # -- construction ----------------------------------------------------------
    @classmethod
    def from_edges(cls, ctx, edges: Sequence[Tuple[int, int]],
                   edge_attr: Optional[np.ndarray] = None) -> "Graph":
        """Build from (srcId, dstId) pairs with arbitrary int ids (ref
        Graph.fromEdgeTuples): the sorted distinct ids become vertices 0 ..
        n - 1 (``np.unique`` with ``return_inverse``, the reference's
        remap without its Python dict)."""
        arr = (edges.astype(np.int64, copy=False)
               if isinstance(edges, np.ndarray)
               else np.asarray(list(edges), dtype=np.int64))
        if arr.size == 0:
            raise ValueError("empty edge list")
        ids, inv = np.unique(arr, return_inverse=True)
        inv = inv.reshape(arr.shape).astype(np.int32)
        return cls(ctx, inv[:, 0], inv[:, 1], edge_attr, n_vertices=len(ids),
                   vertex_ids=ids)

    # -- structural operators (edge rewrites, ref Graph.scala) ----------------
    def reverse(self) -> "Graph":
        return Graph(self.ctx, self.dst, self.src, self.edge_attr,
                     self.n_vertices, self.vertex_ids)

    def subgraph(self, edge_pred: Callable[[int, int, float], bool]
                 ) -> "Graph":
        keep = np.array([edge_pred(int(s), int(d), float(a)) for s, d, a in
                         zip(self._h_src, self._h_dst, self._h_attr)],
                        dtype=bool)
        return Graph(self.ctx, self._h_src[keep], self._h_dst[keep],
                     self._h_attr[keep], self.n_vertices, self.vertex_ids)

    def map_edges(self, f: Callable[[np.ndarray], np.ndarray]) -> "Graph":
        return Graph(self.ctx, self.src, self.dst, f(self._h_attr),
                     self.n_vertices, self.vertex_ids)

    def undirected(self) -> "Graph":
        """Symmetrize: add reversed edges, drop duplicates and self-loops."""
        pairs = np.stack([np.concatenate([self._h_src, self._h_dst]),
                          np.concatenate([self._h_dst, self._h_src])], axis=1)
        attr = np.concatenate([self._h_attr, self._h_attr])
        keep = pairs[:, 0] != pairs[:, 1]
        pairs, attr = pairs[keep], attr[keep]
        _, idx = np.unique(pairs, axis=0, return_index=True)
        return Graph(self.ctx, pairs[idx, 0], pairs[idx, 1], attr[idx],
                     self.n_vertices, self.vertex_ids)

    # -- the core primitive ----------------------------------------------------
    def _reduce(self):
        plain = kernels.kernel_mode(self.ctx) == "false"
        return kernels.segment_reduce_plain if plain \
            else kernels.segment_reduce

    def message_program(self, to_dst: Optional[Callable] = None,
                        to_src: Optional[Callable] = None,
                        merge: str = "sum", n_extras: int = 0):
        """An aggregate-messages program (ref GraphX ``aggregateMessages``).

        ``to_dst``/``to_src``: ``fn(src_attr_e, dst_attr_e, edge_attr_e,
        *extras) -> msgs`` (torch functions) computed per edge, ``to_dst``'s
        over the destination-sorted edges and merged into each edge's
        destination, ``to_src``'s over the source-sorted edges into its
        source, with ``merge`` in {sum, min, max}; the two results are
        combined in that order. Returns a callable ``(vertex_attrs,
        *extras) -> merged (n_vertices, ...)``; vertex attributes are
        tensors or dicts and tuples of them (numpy leaves are copied to the
        device); a vertex that receives no message holds the merge
        identity (0 / +inf / -inf; an integer type's bounds).
        ``n_extras`` is the reference's signature and is not needed."""
        if merge not in kernels.SEGMENT_MERGES:
            raise ValueError(f"merge must be one of {kernels.SEGMENT_MERGES}")
        reduce = self._reduce()
        dev = self.device

        def combine(a, b):
            if merge == "sum":
                return a + b
            return torch.minimum(a, b) if merge == "min" else \
                torch.maximum(a, b)

        def to_dev(t):
            return t.to(dev) if torch.is_tensor(t) else \
                torch.as_tensor(np.asarray(t), device=dev)

        def run(vattr, *extras):
            vattr = tree_map(to_dev, vattr)
            out = None
            for fn, order in ((to_dst, self.by_dst), (to_src, self.by_src)):
                if fn is None:
                    continue
                msgs = fn(_gather(vattr, order.src),
                          _gather(vattr, order.dst), order.attr, *extras)
                c = reduce(msgs, order.pieces, merge)
                out = c if out is None else combine(out, c)
            return out

        return run

    def aggregate_messages(self, vertex_attrs, to_dst=None, to_src=None,
                           merge: str = "sum", extras: Tuple = ()):
        """One-shot aggregate (loops should build :meth:`message_program`
        once and iterate)."""
        prog = self.message_program(to_dst, to_src, merge, len(extras))
        return prog(vertex_attrs, *extras)

    # -- degrees (ref GraphOps.{in,out}Degrees) --------------------------------
    def _degrees(self, to_dst, to_src) -> np.ndarray:
        one = (lambda s, d, e: torch.ones_like(e))
        out = self.aggregate_messages(
            torch.zeros(self.n_vertices, dtype=torch.float32,
                        device=self.device),
            to_dst=one if to_dst else None, to_src=one if to_src else None)
        return out.cpu().numpy()

    def in_degrees(self) -> np.ndarray:
        return self._degrees(True, False)

    def out_degrees(self) -> np.ndarray:
        return self._degrees(False, True)

    def degrees(self) -> np.ndarray:
        return self._degrees(True, True)

    # -- dense adjacency (for closure-based algorithms) -----------------------
    def adjacency(self, symmetric: bool = False) -> torch.Tensor:
        """Dense 0/1 adjacency as a float32 tensor on the device, built
        there. O(n²) memory: the reference's trade for algorithms that
        become matrix products (triangle counting, transitive closure);
        fine for n up to ~16k."""
        n = self.n_vertices
        a = torch.zeros((n, n), dtype=torch.float32, device=self.device)
        a[self.src.long(), self.dst.long()] = 1.0
        if symmetric:
            a = torch.maximum(a, a.T)
        a.fill_diagonal_(0.0)
        return a


def merge_identity(dtype: torch.dtype, merge: str) -> torch.Tensor:
    """The merge's identity element in the message dtype as a 0-d tensor:
    integer label dtypes get their iinfo bounds, so vertex ids above 2^24
    stay exact (:func:`kernels.merge_identity`)."""
    return torch.tensor(kernels.merge_identity(dtype, merge), dtype=dtype)


def _gather(vattr, idx: torch.Tensor):
    """Per-edge vertex attributes gathered from vertex state (tensors or
    dicts and tuples of them, leading vertex dim)."""
    return tree_map(lambda t: t[idx], vattr)
