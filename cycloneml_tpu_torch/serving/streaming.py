"""Streaming scoring: featurize -> predict -> sink as one pipeline.

The port's ``cycloneml_tpu/serving/streaming.py``. Wrapping a streaming
query's sink routes every micro-batch's feature columns through the model
server's micro-batcher before the rows land downstream: the same
bucketed, admission-guarded dispatch path as online requests, in the same
metrics and spans. A replayed batch id is passed through to the inner
sink, which dedupes it.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from cycloneml_tpu_torch.streaming.sinks import Sink


class ScoringSink(Sink):
    """Wrap an inner sink with model scoring.

    Each micro-batch's ``feature_cols`` assemble (in order) into the
    request matrix; predictions append as ``output_col`` (for a gang,
    ``output_col.0 .. output_col.K-1``, one column a member) and the
    widened batch goes to ``inner``::

        sink = ScoringSink(server, "churn", ["f0", "f1"], MemorySink())
    """

    def __init__(self, server, model: str, feature_cols: Sequence[str],
                 inner: Sink, output_col: str = "prediction"):
        self.server = server
        self.model = model
        self.feature_cols: List[str] = list(feature_cols)
        self.inner = inner
        self.output_col = output_col

    def add_batch(self, batch_id: int, batch, mode: str) -> None:
        cols = list(batch)
        n = len(batch[cols[0]]) if cols else 0
        out = dict(batch)
        if n:
            x = np.column_stack([np.asarray(batch[c], dtype=np.float64)
                                 for c in self.feature_cols])
        else:  # an empty micro-batch still needs the output schema
            x = np.zeros((0, self.server.n_features(self.model)))
        preds = self.server.predict(self.model, x)
        if isinstance(preds, list):        # gang: one column a member
            for k in range(len(preds)):
                out[f"{self.output_col}.{k}"] = np.asarray(preds[k])
        else:
            out[self.output_col] = np.asarray(preds)
        self.inner.add_batch(batch_id, out, mode)
