"""InstanceDataset — the numeric tier every estimator trains on.

The port's counterpart of ``cycloneml_tpu/dataset/dataset.py:
InstanceDataset``: ``x`` is ``(n_pad, d)`` in the data tier, ``y``/``w`` are
``(n_pad,)`` in the accumulator tier, all on the mesh's device; padding
rows carry w=0. Host twins of the padded (y, w) are kept when they are
known, so estimators read label histograms without a device readback.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from cycloneml_tpu_torch.dataset.instance import (blockify_arrays,
                                                  compute_dtype, data_dtype)
from cycloneml_tpu_torch.parallel import collectives


class InstanceDataset:
    def __init__(self, ctx, x: torch.Tensor, y: torch.Tensor,
                 w: torch.Tensor, n_rows: int, n_features: int):
        self.ctx = ctx
        self._x = x
        self._y = y
        self._w = w
        self._yw_host: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self._summary_cache = None  # Summarizer moments (immutable data)
        self.n_rows = n_rows
        self.n_features = n_features

    @classmethod
    def from_numpy(cls, ctx, x: np.ndarray, y: Optional[np.ndarray] = None,
                   w: Optional[np.ndarray] = None,
                   dtype: Optional[torch.dtype] = None) -> "InstanceDataset":
        """Pad host arrays with zero-weight rows and place them on the
        mesh: X in the data tier (``dtype``, default
        :func:`data_dtype`), y/w in the accumulator tier."""
        conf = getattr(ctx, "conf", None)
        if dtype is None:
            dtype = data_dtype(conf)
        x = np.asarray(x)
        rt = ctx.mesh_runtime
        x_p, y_p, w_p, n = blockify_arrays(x, y, w, rt.data_parallelism,
                                           dtype=dtype,
                                           yw_dtype=compute_dtype(conf))
        ds = cls(ctx, rt.device_put_sharded_rows(x_p),
                 rt.device_put_sharded_rows(y_p),
                 rt.device_put_sharded_rows(w_p), n, x.shape[1])
        ds._yw_host = (y_p.numpy(), w_p.numpy())
        return ds

    def attach_host_labels(self, y: np.ndarray,
                           w: np.ndarray) -> "InstanceDataset":
        """Attach padded host twins of (y, w), so ``y_host``/``w_host``
        never read the device back."""
        self._yw_host = (y, w)
        return self

    def to_instance_dataset(self, *args, **kwargs) -> "InstanceDataset":
        """Already an InstanceDataset: estimators accept one as a frame."""
        return self

    @property
    def x(self) -> torch.Tensor:
        return self._x

    @property
    def y(self) -> torch.Tensor:
        return self._y

    @property
    def w(self) -> torch.Tensor:
        return self._w

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n_rows, self.n_features)

    def y_host(self) -> np.ndarray:
        """Padded label vector as numpy."""
        if self._yw_host is not None:
            return self._yw_host[0]
        return self._y.cpu().numpy()

    def w_host(self) -> np.ndarray:
        """Padded weight vector as numpy."""
        if self._yw_host is not None:
            return self._yw_host[1]
        return self._w.cpu().numpy()

    def padded_bytes(self) -> int:
        """Storage footprint of the padded block."""
        return (self._x.numel() * self._x.element_size()
                + self._y.numel() * self._y.element_size()
                + self._w.numel() * self._w.element_size())

    def to_numpy(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Unpadded host copies; a bf16 X comes back as float32."""
        n = self.n_rows
        x = self._x[:n]
        if x.dtype == torch.bfloat16:
            x = x.float()
        return (x.cpu().numpy(), self._y[:n].cpu().numpy(),
                self._w[:n].cpu().numpy())

    def tree_aggregate_fn(self, fn: Callable, auto_psum: bool = True):
        """``fn(x_shard, y_shard, w_shard, *extras) -> pytree`` summed over
        the mesh; returns a callable taking the extras. ``.compiled`` is the
        aggregation over explicit ``(x, y, w, *extras)`` and ``.arrays()``
        the dataset's arrays, so a caller can run the aggregation inside
        its own loop."""
        compiled = collectives.tree_aggregate(
            fn, self.ctx.mesh_runtime, self.x, self.y, self.w,
            auto_psum=auto_psum)
        ds = self

        def call(*extras):
            return compiled(ds.x, ds.y, ds.w, *extras)

        call.compiled = compiled
        call.arrays = lambda: (ds.x, ds.y, ds.w)
        return call
