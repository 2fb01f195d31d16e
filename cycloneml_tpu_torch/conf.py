"""Typed configuration registry — the port's counterpart of
``cycloneml_tpu/conf.py``, holding only the keys on the ported path.

``ConfigBuilder`` makes typed ``ConfigEntry`` objects with defaults and
validators; ``CycloneConf`` is a string map with typed reads, seeded from
``CYCLONE_CONF_*`` environment variables. Key names are the reference's, so
a configuration carries over unchanged.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Callable, Dict, Generic, Optional, TypeVar

T = TypeVar("T")

_REGISTRY: Dict[str, "ConfigEntry"] = {}
_REGISTRY_LOCK = threading.Lock()


class ConfigEntry(Generic[T]):
    """A typed configuration entry with a default and a validator."""

    def __init__(self, key: str, default: Optional[T], value_type: type,
                 doc: str = "", validator: Optional[Callable[[T], bool]] = None,
                 validator_msg: str = ""):
        self.key = key
        self.default = default
        self.value_type = value_type
        self.doc = doc
        self.validator = validator
        self.validator_msg = validator_msg
        with _REGISTRY_LOCK:
            if key in _REGISTRY:
                raise ValueError(f"Config entry already registered: {key}")
            _REGISTRY[key] = self

    def _convert(self, raw: Any) -> T:
        t = self.value_type
        if isinstance(raw, t) and not (t is int and isinstance(raw, bool)):
            return raw
        s = str(raw)
        if t is bool:
            if s.lower() in ("true", "1", "yes"):
                return True  # type: ignore[return-value]
            if s.lower() in ("false", "0", "no"):
                return False  # type: ignore[return-value]
            raise ValueError(f"{self.key}: cannot parse boolean from {raw!r}")
        if t is int:
            return int(s)  # type: ignore[return-value]
        if t is str:
            return s  # type: ignore[return-value]
        raise TypeError(f"{self.key}: unsupported config type {t}")

    def read_from(self, conf: "CycloneConf") -> T:
        if conf.contains_raw(self.key):
            v = self._convert(conf.get_raw(self.key))
            if self.validator is not None and not self.validator(v):
                raise ValueError(
                    f"Invalid value {v!r} for {self.key}: {self.validator_msg}")
            return v
        if self.default is None:
            raise KeyError(f"Config {self.key} is not set and has no default")
        return self.default


class ConfigBuilder:
    """Fluent builder of :class:`ConfigEntry`."""

    def __init__(self, key: str):
        self._key = key
        self._doc = ""
        self._validator: Optional[Callable] = None
        self._validator_msg = ""

    def doc(self, d: str) -> "ConfigBuilder":
        self._doc = d
        return self

    def check_value(self, fn: Callable, msg: str) -> "ConfigBuilder":
        self._validator = fn
        self._validator_msg = msg
        return self

    def _make(self, default, value_type) -> ConfigEntry:
        return ConfigEntry(self._key, default, value_type, self._doc,
                           self._validator, self._validator_msg)

    def int_conf(self, default: Optional[int] = None) -> ConfigEntry[int]:
        return self._make(default, int)

    def str_conf(self, default: Optional[str] = None) -> ConfigEntry[str]:
        return self._make(default, str)


class CycloneConf:
    """String-keyed configuration map with typed reads (SparkConf
    semantics: set/get/contains, ``CYCLONE_CONF_*`` environment seeding,
    clone)."""

    ENV_PREFIX = "CYCLONE_CONF_"

    def __init__(self, load_defaults: bool = True):
        self._settings: Dict[str, str] = {}
        self._lock = threading.Lock()
        if load_defaults:
            # CYCLONE_CONF_cyclone__master=cpu -> cyclone.master
            for k, v in os.environ.items():
                if k.startswith(self.ENV_PREFIX):
                    key = k[len(self.ENV_PREFIX):].replace("__", ".")
                    self._settings[key] = v

    def set(self, key, value) -> "CycloneConf":
        k = key.key if isinstance(key, ConfigEntry) else key
        with self._lock:
            self._settings[k] = str(value)
        return self

    def remove(self, key) -> "CycloneConf":
        k = key.key if isinstance(key, ConfigEntry) else key
        with self._lock:
            self._settings.pop(k, None)
        return self

    def contains_raw(self, key: str) -> bool:
        return key in self._settings

    def get_raw(self, key: str) -> str:
        return self._settings[key]

    def get(self, key, default: Any = None) -> Any:
        if isinstance(key, ConfigEntry):
            return key.read_from(self)
        entry = _REGISTRY.get(key)
        if entry is not None:
            return entry.read_from(self)
        if key in self._settings:
            return self._settings[key]
        if default is not None:
            return default
        raise KeyError(key)

    def get_all(self) -> Dict[str, str]:
        with self._lock:
            return dict(self._settings)

    def clone(self) -> "CycloneConf":
        c = CycloneConf(load_defaults=False)
        c._settings = dict(self._settings)
        return c


# ---------------------------------------------------------------------------
# The keys on the ported path
# ---------------------------------------------------------------------------

APP_NAME = ConfigBuilder("cyclone.app.name").doc("Application name.") \
    .str_conf("cyclone-app")

MASTER = (
    ConfigBuilder("cyclone.master")
    .doc("The torch device the mesh runs on: 'cuda' (default) or 'cuda:N' "
         "for one card, 'cpu' for the CPU. 'cuda' with no card raises; the "
         "port never drops to the CPU by itself.")
    .str_conf("cuda")
)

AGGREGATION_DEPTH = (
    ConfigBuilder("cyclone.treeAggregate.depth")
    .doc("Depth of the hierarchical reduction across the mesh's replica "
         "and data axes. Validated and kept so configurations carry over; "
         "the one-device mesh of this slice reduces one term and reads it "
         "nowhere (the multi-device runtime is ROADMAP slice 8).")
    .check_value(lambda v: v >= 1, "must be >= 1")
    .int_conf(2)
)

COMPUTE_DTYPE = (
    ConfigBuilder("cyclone.compute.dtype")
    .doc("The accumulator tier: labels, weights, optimizer state and every "
         "reduction. 'float32' (default) on the card; 'float64' is the "
         "parity switch the CPU tests use against the reference's x64 "
         "configuration.")
    .check_value(lambda v: v in ("float32", "float64"),
                 "must be float32 or float64")
    .str_conf("float32")
)

DATA_DTYPE = (
    ConfigBuilder("cyclone.data.dtype")
    .doc("Storage dtype of the design matrix. 'auto' (default) is "
         "bfloat16 — the sweep is bandwidth-bound, so X's width is the "
         "fit's speed — except under cyclone.compute.dtype=float64, where "
         "it is float64 so parity runs see full-width data. 'float32' and "
         "'bfloat16' force a tier; the kernels upcast to float32 inside. "
         "The SECOND precision rung: 'auto8' resolves to float8_e4m3fn "
         "(1 byte, per-column scales at accumulator width, float32 "
         "accumulation in the kernels) for fp8-capable estimators "
         "(LogisticRegression, LinearRegression l-bfgs) and to bfloat16 "
         "for everything else, except under cyclone.compute.dtype=float64, "
         "where it keeps the parity tier like 'auto'; 'float8' forces the "
         "same split through parity configurations. fp8-capable fits run "
         "a pre-fit envelope probe that falls back to bfloat16 (a logged "
         "warning and a recorded reason) when e4m3's 3-bit mantissa would "
         "break the documented accuracy envelope.")
    .check_value(lambda v: v in ("auto", "auto8", "bfloat16", "float8",
                                 "float32", "float64"),
                 "must be auto, auto8, bfloat16, float8, float32 or float64")
    .str_conf("auto")
)

LBFGS_DEVICE_CHUNK = (
    ConfigBuilder("cyclone.ml.lbfgs.deviceChunk")
    .doc("L-BFGS iterations per device-resident chunk for eligible fits "
         "(dense tier, standardized-or-no L2). 0 disables the chunked "
         "optimizer (host loop with the device line search).")
    .check_value(lambda v: v >= 0, "must be >= 0")
    .int_conf(16)
)

USE_PALLAS_KERNELS = (
    ConfigBuilder("cyclone.ml.usePallasKernels")
    .doc("Route the dense passes through the hand-written CUDA kernels "
         "(ops/kernels.py): the LogisticRegression sweep (K1), the "
         "LinearRegression sweep (K2), KMeans' assignments (K3) and "
         "RowMatrix's Gramian (K4). The name is the reference's, so "
         "configurations carry over. 'auto' (default): on when the data "
         "lives on CUDA; 'true'/'false' force one path (on the CPU 'true' "
         "runs the kernels' plain versions).")
    .check_value(lambda v: str(v).lower() in ("auto", "true", "false"),
                 "must be auto, true or false")
    .str_conf("auto")
)

OOCORE_MODE = (
    ConfigBuilder("cyclone.oocore.mode")
    .doc("Out-of-core streaming fit mode, the reference's key: 'auto' "
         "(default) and 'off' fit in core; 'force' asks for the streaming "
         "epoch engine, which is ROADMAP slice 6 (stacked fits raise "
         "NotImplementedError under it).")
    .check_value(lambda v: v in ("auto", "force", "off"),
                 "must be auto, force or off")
    .str_conf("auto")
)
