"""Streaming sinks: the port's ``Sink`` and ``MemorySink`` of
``cycloneml_tpu/streaming/sinks.py`` (:21-60).

A batch is a column dict (name -> 1-D numpy array). ``add_batch(batch_id,
batch, mode)`` must be idempotent per batch id: a replayed batch after a
restart is dropped.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

Batch = Dict[str, np.ndarray]


class Sink:
    def add_batch(self, batch_id: int, batch: Batch, mode: str) -> None:
        raise NotImplementedError


class MemorySink(Sink):
    """Collects output rows in memory, batch by batch."""

    def __init__(self):
        self._batches: Dict[int, Batch] = {}
        self._order: List[int] = []

    def add_batch(self, batch_id: int, batch: Batch, mode: str) -> None:
        if batch_id in self._batches:
            return  # replayed batch after recovery: idempotent
        if mode == "complete":
            self._batches.clear()
            self._order.clear()
        self._batches[batch_id] = batch
        self._order.append(batch_id)

    def to_batch(self, schema: Optional[List[str]] = None) -> Batch:
        """Every non-empty batch concatenated column-wise, in arrival
        order (empty columns of ``schema`` when there is none)."""
        parts = [self._batches[b] for b in self._order]
        live = [p for p in parts if p and len(next(iter(p.values()))) > 0]
        if not live:
            return {c: np.array([]) for c in (schema or [])}
        return {c: np.concatenate([np.asarray(p[c]) for p in live])
                for c in live[0]}

    def rows(self) -> List[tuple]:
        batch = self.to_batch()
        cols = list(batch)
        n = len(batch[cols[0]]) if cols else 0
        return [tuple(batch[c][i] for c in cols) for i in range(n)]

    def clear(self) -> None:
        self._batches.clear()
        self._order.clear()
