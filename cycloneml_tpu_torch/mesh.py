"""Device-mesh runtime over one torch device.

The port's counterpart of ``cycloneml_tpu/mesh.py:MeshRuntime``. The mesh
keeps the reference's ``(replica, data)`` axes so that ``tree_aggregate``
keeps its shape — a per-shard call, then a sum over the data shards in a
fixed order — but this slice runs one data shard on one device: the
multi-device runtime over ``torch.distributed`` is ROADMAP slice 8.

Master strings (``cyclone.master``): ``cuda`` or ``cuda:N`` (one card; the
default) and ``cpu``. ``cuda`` with no card raises: the port never drops to
the CPU by itself.
"""

from __future__ import annotations

import threading
from typing import List, Optional

import numpy as np
import torch

DATA_AXIS = "data"
REPLICA_AXIS = "replica"


def resolve_device(master: str) -> torch.device:
    """The torch device a master string names; raises for a CUDA master
    when no card is present."""
    m = str(master).strip().lower()
    if m == "cpu":
        return torch.device("cpu")
    if m == "cuda" or m.startswith("cuda:"):
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"cyclone.master={master!r} but no CUDA device is present; "
                "set cyclone.master=cpu to run on the CPU")
        dev = torch.device(m)
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"cyclone.master={master!r}: only "
                               f"{torch.cuda.device_count()} CUDA device(s)")
        return dev
    raise ValueError(f"unknown cyclone.master {master!r}: expected 'cuda', "
                     "'cuda:N' or 'cpu' (multi-device masters are ROADMAP "
                     "slice 8)")


class MeshRuntime:
    """Owns the device and the row-sharding helpers of the mesh."""

    def __init__(self, master: str = "cuda"):
        self.device = resolve_device(master)
        self.master = master
        self.platform = self.device.type
        self.axis_sizes = {REPLICA_AXIS: 1, DATA_AXIS: 1}
        self.n_devices = 1
        if self.platform == "cuda":
            # full-f32 products everywhere: TF32 keeps ~3 decimal digits,
            # which the plain aggregator and the kernel checks cannot take
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False

    @property
    def data_parallelism(self) -> int:
        return self.axis_sizes[REPLICA_AXIS] * self.axis_sizes[DATA_AXIS]

    def device_put_sharded_rows(self, arr) -> torch.Tensor:
        """Place a host array (numpy or torch) on the mesh, rows sharded
        over replica x data — one shard here."""
        t = torch.from_numpy(np.ascontiguousarray(arr)) \
            if isinstance(arr, np.ndarray) else arr
        return t.to(self.device)

    def row_shards(self, t: torch.Tensor) -> List[torch.Tensor]:
        """The per-shard row blocks of a row-sharded tensor, in shard
        order (views, no copies)."""
        return list(torch.chunk(t, self.data_parallelism, dim=0))


_active: Optional[MeshRuntime] = None
_active_lock = threading.Lock()


def get_or_create(master: str = "cuda") -> MeshRuntime:
    global _active
    with _active_lock:
        if _active is None:
            _active = MeshRuntime(master)
        elif _active.master != master:
            raise RuntimeError(
                f"A mesh is already active for master {_active.master!r}; "
                f"cannot re-initialise for {master!r}. Stop all contexts and "
                "call mesh.reset() first.")
        return _active


def active() -> Optional[MeshRuntime]:
    return _active


def reset() -> None:
    global _active
    with _active_lock:
        _active = None
