"""Pregel BSP loop.

The port's counterpart of ``cycloneml_tpu/graph/pregel.py`` (ref:
graphx/.../Pregel.scala:59, loop at :115): each superstep is one message
program (``Graph.message_program``, merged by ``csrc/segment_reduce.cu`` on
the card; for a sum merge a receipt count rides along as an extra channel,
for a min/max merge receipt is judged against the merge identity) plus the
vertex program; the host loop reads one scalar a superstep.

Semantics kept: the initial message is delivered to every vertex; a vertex
runs ``vprog`` only when it received a message; only vertices that
received a message in superstep t send in t+1; the loop ends when no
messages remain or ``max_iter`` is hit.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from cycloneml_tpu_torch.graph.graph import merge_identity, tree_map, tree_map2


def pregel(graph, vertex_attrs, initial_msg, vprog: Callable,
           send_to_dst: Optional[Callable] = None,
           send_to_src: Optional[Callable] = None,
           merge: str = "sum", max_iter: int = 20):
    """Run Pregel; returns the final vertex attributes (a tensor, or a dict
    or tuple of them).

    - ``vprog(attr, msg, has_msg) -> attr``, vectorized over all vertices;
      applied only where ``has_msg`` (masking handled here).
    - ``send_*(src_attr, dst_attr, edge_attr, src_active, dst_active) ->
      (msgs, send_mask)``, per edge; masked sends get the merge identity.
      (min/max caveat: a deliberately sent message exactly equal to the
      merge identity is indistinguishable from no message.)
    - ``merge`` in {sum, min, max}.
    """
    if send_to_dst is None and send_to_src is None:
        raise ValueError("need at least one send function")
    dev = graph.device
    shape_box = []  # the messages' trailing shape, seen at the first send

    def _wrap(user_fn):
        if user_fn is None:
            return None

        def fn(sa, da, e):
            (s_attr, s_act), (d_attr, d_act) = sa, da
            msgs, mask = user_fn(s_attr, d_attr, e, s_act, d_act)
            if not shape_box:
                shape_box.append(msgs.shape[1:])
            ident = merge_identity(msgs.dtype, merge).to(dev)
            m = mask.reshape(mask.shape + (1,) * (msgs.dim() - mask.dim()))
            masked = torch.where(m > 0, msgs, ident)
            if merge != "sum":
                return masked
            # the receipt count rides as an extra channel: one edge pass
            flat = masked.reshape(masked.shape[0], -1)
            cnt = (mask > 0).to(flat.dtype)[:, None]
            return torch.cat([flat, cnt], dim=1)
        return fn

    prog = graph.message_program(_wrap(send_to_dst), _wrap(send_to_src),
                                 merge)

    def apply_vprog(attrs, msgs, has):
        new = vprog(attrs, msgs, has)
        return tree_map2(
            lambda a, b: torch.where(
                has.reshape(has.shape + (1,) * (a.dim() - has.dim())), b, a),
            attrs, new)

    n = graph.n_vertices
    attrs = tree_map(lambda t: t.to(dev) if torch.is_tensor(t) else
                     torch.as_tensor(np.asarray(t), device=dev), vertex_attrs)
    # superstep 0: everyone gets the initial message
    init0 = np.asarray(initial_msg)
    init = torch.as_tensor(init0, device=dev).expand((n,) + init0.shape)
    attrs = apply_vprog(attrs, init, torch.ones(n, dtype=torch.bool,
                                                device=dev))
    active = torch.ones(n, dtype=torch.float32, device=dev)

    for _ in range(max_iter):
        merged = prog((attrs, active))
        if merge == "sum":
            has = merged[:, -1] > 0
            msgs = merged[:, :-1].reshape((n,) + tuple(shape_box[0]))
        else:
            cmp = merged != merge_identity(merged.dtype, merge).to(dev)
            has = cmp.reshape(n, -1).any(dim=1)
            msgs = merged
        if not bool(has.any()):
            break
        attrs = apply_vprog(attrs, msgs, has)
        active = has.to(torch.float32)
    return attrs
