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
from typing import (Any, Callable, Dict, Generic, Iterator, List, Optional,
                    TypeVar)

T = TypeVar("T")

_REGISTRY: Dict[str, "ConfigEntry"] = {}
_REGISTRY_LOCK = threading.Lock()


class ConfigEntry(Generic[T]):
    """A typed configuration entry with a default and a validator; it may
    also read alternative (older) key names and fall back to another
    entry when none is set (ref ConfigEntry.scala:74)."""

    def __init__(self, key: str, default: Optional[T], value_type: type,
                 doc: str = "", validator: Optional[Callable[[T], bool]] = None,
                 validator_msg: str = "", version: str = "0.1.0",
                 alternatives: Optional[List[str]] = None,
                 fallback: Optional["ConfigEntry[T]"] = None,
                 mutable: bool = False):
        self.key = key
        self.default = default
        self.value_type = value_type
        self.doc = doc
        self.validator = validator
        self.validator_msg = validator_msg
        self.version = version
        self.alternatives = alternatives or []
        self.fallback = fallback
        self.mutable = mutable
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
        if t is float:
            return float(s)  # type: ignore[return-value]
        if t is str:
            return s  # type: ignore[return-value]
        raise TypeError(f"{self.key}: unsupported config type {t}")

    def read_from(self, conf: "CycloneConf") -> T:
        for k in [self.key] + self.alternatives:
            if conf.contains_raw(k):
                v = self._convert(conf.get_raw(k))
                if self.validator is not None and not self.validator(v):
                    raise ValueError(f"Invalid value {v!r} for {self.key}: "
                                     f"{self.validator_msg}")
                return v
        if self.fallback is not None:
            return self.fallback.read_from(conf)
        if self.default is None:
            raise KeyError(f"Config {self.key} is not set and has no default")
        return self.default


class ConfigBuilder:
    """Fluent builder of :class:`ConfigEntry` (ref ConfigBuilder.scala:183)."""

    def __init__(self, key: str):
        self._key = key
        self._doc = ""
        self._version = "0.1.0"
        self._validator: Optional[Callable] = None
        self._validator_msg = ""
        self._alternatives: List[str] = []
        self._mutable = False

    def doc(self, d: str) -> "ConfigBuilder":
        self._doc = d
        return self

    def version(self, v: str) -> "ConfigBuilder":
        self._version = v
        return self

    def with_alternative(self, key: str) -> "ConfigBuilder":
        self._alternatives.append(key)
        return self

    def check_value(self, fn: Callable, msg: str) -> "ConfigBuilder":
        self._validator = fn
        self._validator_msg = msg
        return self

    def mutable(self) -> "ConfigBuilder":
        self._mutable = True
        return self

    def _make(self, default, value_type, fallback=None) -> ConfigEntry:
        return ConfigEntry(self._key, default, value_type, self._doc,
                           self._validator, self._validator_msg,
                           self._version, self._alternatives, fallback,
                           self._mutable)

    def int_conf(self, default: Optional[int] = None) -> ConfigEntry[int]:
        return self._make(default, int)

    def str_conf(self, default: Optional[str] = None) -> ConfigEntry[str]:
        return self._make(default, str)

    def float_conf(self, default: Optional[float] = None
                   ) -> ConfigEntry[float]:
        return self._make(default, float)

    def bool_conf(self, default: Optional[bool] = None) -> ConfigEntry[bool]:
        return self._make(default, bool)

    def fallback_conf(self, parent: ConfigEntry) -> ConfigEntry:
        """An entry that reads ``parent`` until it is set itself."""
        return self._make(None, parent.value_type, fallback=parent)


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

    def set_if_missing(self, key, value) -> "CycloneConf":
        k = key.key if isinstance(key, ConfigEntry) else key
        with self._lock:
            self._settings.setdefault(k, str(value))
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

    def __iter__(self) -> Iterator:
        return iter(self.get_all().items())


def registered_entries() -> Dict[str, ConfigEntry]:
    """Every registered entry by key."""
    with _REGISTRY_LOCK:
        return dict(_REGISTRY)


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

DEFAULT_PARALLELISM = (
    ConfigBuilder("cyclone.default.parallelism")
    .doc("Default number of partitions of a host-tier dataset "
         "(CycloneContext.parallelize); 0 = the mesh's device count.")
    .check_value(lambda v: v >= 0, "must be >= 0")
    .int_conf(0)
)

BLOCK_SIZE_MAX_MEM = (
    ConfigBuilder("cyclone.dataset.blockSizeInMB")
    .doc("Max memory per instance block in MB (ref: ml/feature/"
         "Instance.scala:146 blokifyWithMaxMemUsage). Registered so "
         "configurations carry over; the port places a dataset as one "
         "padded block and reads it nowhere.")
    .float_conf(0.0)
)

MATMUL_PRECISION = (
    ConfigBuilder("cyclone.compute.matmulPrecision")
    .doc("Precision of the loss functions' plain torch float32 products "
         "on the card: 'highest' (default) keeps TF32 off (full float32, "
         "the mesh's setting); 'default' lets cuBLAS use TF32 in them "
         "(torch.backends.cuda.matmul.allow_tf32, set around each "
         "aggregation and restored after: "
         "ml/optim/aggregators.precision_scope). The hand-written kernels "
         "read neither. Resolved when a loss function is built, so a "
         "change applies to the next fit.")
    .check_value(lambda v: v in ("highest", "default"),
                 "must be 'highest' or 'default'")
    .str_conf("highest")
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
    .doc("Out-of-core streaming fit mode (oocore/): 'auto' (default) fits "
         "in core, but an eligible fit whose predicted peak device memory "
         "exceeds the budget guard's budget (cyclone.memory.*) DEGRADES "
         "to the streaming epoch engine instead of warning or raising; "
         "'force' routes every eligible dense fit (LogisticRegression, "
         "its stacked fits, LinearRegression l-bfgs) through the "
         "streaming path, each loss/gradient evaluation one epoch over "
         "shards on disk staged onto the device through pinned buffers; "
         "'off' never streams, and the guard warns or raises.")
    .check_value(lambda v: v in ("auto", "force", "off"),
                 "must be auto, force or off")
    .str_conf("auto")
)

OOCORE_SHARD_ROWS = (
    ConfigBuilder("cyclone.oocore.shardRows")
    .doc("Rows per out-of-core shard. Every shard is staged in one fixed "
         "(padRows, d) block (zero-weight padding rows), so the device "
         "slots are allocated once and host staging peaks at O(shardRows "
         "d), never O(n d).")
    .check_value(lambda v: v >= 1, "must be >= 1")
    .int_conf(65536)
)

OOCORE_PREFETCH_DEPTH = (
    ConfigBuilder("cyclone.oocore.prefetchDepth")
    .doc("Staged shards in flight ahead of compute: 2 is double "
         "buffering, shard i+1's disk read and copy overlapping shard i's "
         "kernel. Device-resident shard slots are bounded by depth + 1.")
    .check_value(lambda v: v >= 1, "must be >= 1")
    .int_conf(2)
)

OOCORE_SHUFFLE = (
    ConfigBuilder("cyclone.oocore.shuffle")
    .doc("Shuffle the shard ORDER of every streamed-SGD epoch (a seeded "
         "permutation keyed on the optimizer seed x step, so a fixed seed "
         "replays exactly). The epoch's gradient is order-invariant up to "
         "float summation order. Off keeps the sequential order.")
    .bool_conf(False)
)

OOCORE_DIR = (
    ConfigBuilder("cyclone.oocore.dir")
    .doc("Directory for out-of-core shard files (one .npy per array). "
         "Empty = the system temp dir. Shard sets built by the engine own "
         "their files and remove them on close/GC.")
    .str_conf("")
)

CHECKPOINT_DIR = (
    ConfigBuilder("cyclone.checkpoint.dir")
    .doc("Directory for dataset checkpoints (ref: RDD.scala:1631 "
         "checkpoint): PartitionedDataset.checkpoint writes its "
         "partitions there; CycloneContext.set_checkpoint_dir sets it.")
    .str_conf("")
)

STORAGE_DEVICE_BUDGET = (
    ConfigBuilder("cyclone.storage.deviceBudget")
    .doc("Byte budget for DEVICE-tier managed datasets (the context's "
         "StorageManager, the BlockManager memory store's analog). "
         "Exceeding it demotes the least-recently-used managed dataset to "
         "the host tier. Read when the context is made. 0 = unbounded.")
    .check_value(lambda v: v >= 0, "must be >= 0")
    .int_conf(0)
)

STORAGE_HOST_BUDGET = (
    ConfigBuilder("cyclone.storage.hostBudget")
    .doc("Byte budget for HOST-tier managed datasets; past it, the "
         "least-recently-used datasets demote to disk spill files. Read "
         "when the context is made. 0 = unbounded.")
    .check_value(lambda v: v >= 0, "must be >= 0")
    .int_conf(0)
)

OOCORE_STREAM_DTYPE = (
    ConfigBuilder("cyclone.oocore.streamDtype")
    .doc("Storage dtype of out-of-core shards, the precision rung of the "
         "host-to-device stream. 'auto' (default) follows "
         "cyclone.data.dtype, fp8 tiers included: under auto8/float8 the "
         "spill-time envelope probe (instance.fp8_probe_ok over the write "
         "pass's moments) decides fp8 or bf16 for the shard SET, a "
         "refusal recorded in ctx.precision_fallbacks; 'bfloat16' pins "
         "the bf16 rung; 'float8' asks for e4m3 codes with per-column "
         "scales whenever the probe allows.")
    .check_value(lambda v: v in ("auto", "bfloat16", "float8"),
                 "must be auto, bfloat16 or float8")
    .str_conf("auto")
)

OOCORE_CACHE_BYTES = (
    ConfigBuilder("cyclone.oocore.cacheBytes")
    .doc("Byte bound of the shard-set reuse cache (oocore/cache.py): "
         "spilled shard sets are keyed by content hash (the source "
         "dataset, the stream tier, the geometry), so a re-fit over the "
         "same dataset ATTACHES to the existing spill and writes 0 bytes. "
         "LRU-evicted past the bound; live handles pin their entries; "
         "every attach re-checks each shard's sha256. 0 disables reuse.")
    .check_value(lambda v: v >= 0, "must be >= 0")
    .int_conf(1 << 30)
)

MEMORY_BUDGET_FRACTION = (
    ConfigBuilder("cyclone.memory.budgetFraction")
    .doc("The memory budget guard (observe/costs.py): when a fit's "
         "predicted peak device memory (the bytes of its device arrays "
         "plus its working set, computed from shapes) exceeds this "
         "fraction of the device's memory, a MemoryBudgetExceeded record "
         "goes to ctx.memory_warnings and the fit degrades: to the "
         "streaming engine where it has one and cyclone.oocore.mode "
         "allows, else it warns or raises (cyclone.memory.budgetAction). "
         "The guard is armed only when this key is set explicitly.")
    .check_value(lambda v: 0 < v <= 1.0, "must be in (0, 1]")
    .float_conf(0.9)
)

MEMORY_BUDGET_ACTION = (
    ConfigBuilder("cyclone.memory.budgetAction")
    .doc("What an exceeded memory budget does once nothing is left to "
         "degrade to: 'warn' (default) logs and proceeds; 'raise' throws "
         "MemoryBudgetError.")
    .check_value(lambda v: v in ("warn", "raise"),
                 "must be 'warn' or 'raise'")
    .str_conf("warn")
)

MEMORY_DEVICE_BYTES = (
    ConfigBuilder("cyclone.memory.deviceBytes")
    .doc("Device memory bytes the budget guard divides into. 0 (default) "
         "detects it: torch.cuda.mem_get_info's total on the card, total "
         "host RAM on the CPU.")
    .check_value(lambda v: v >= 0, "must be >= 0")
    .int_conf(0)
)

SERVING_MAX_BATCH = (
    ConfigBuilder("cyclone.serving.maxBatch")
    .doc("Upper bound on coalesced rows per serving dispatch. The model "
         "server prepares one predict program per power-of-two row bucket "
         "up to (the next power of two >=) this value at registration (on "
         "the card one CUDA graph a bucket), so no request ever pays a "
         "build or a capture.")
    .check_value(lambda v: v >= 1, "must be >= 1")
    .int_conf(64)
)

SERVING_WINDOW_MS = (
    ConfigBuilder("cyclone.serving.windowMs")
    .doc("Latency-bounded batching window in milliseconds (Clipper-style "
         "adaptive micro-batching): once a request is queued, the "
         "batcher waits at most this long for more requests to the same "
         "model before dispatching the coalesced batch. 0 dispatches "
         "immediately (no coalescing beyond what is already queued).")
    .check_value(lambda v: v >= 0, "must be >= 0")
    .float_conf(5.0)
)

SERVING_DTYPE = (
    ConfigBuilder("cyclone.serving.dtype")
    .doc("Float dtype serving predict programs compute in. 'auto' (the "
         "default) resolves to the accumulator tier, cyclone.compute.dtype "
         "(float32 by default, float64 under the parity configuration). "
         "Request payloads and model parameters are cast to this width at "
         "the serving boundary; the bf16 data tier never applies to "
         "request batches (they are latency-, not bandwidth-bound, and "
         "scoring accuracy is part of the contract). 'float64' is honoured "
         "on the card and on the CPU.")
    .check_value(lambda v: v in ("auto", "float32", "float64"),
                 "must be 'auto', 'float32' or 'float64'")
    .str_conf("auto")
)

SERVING_MAX_QUEUE = (
    ConfigBuilder("cyclone.serving.maxQueue")
    .doc("Backpressure bound: maximum requests queued per registered "
         "model. Submissions past it fail fast with ServingOverloaded "
         "(503) instead of growing the queue without limit.")
    .check_value(lambda v: v >= 1, "must be >= 1")
    .int_conf(1024)
)

SERVING_SHED_AFTER_MS = (
    ConfigBuilder("cyclone.serving.shedAfterMs")
    .doc("Admission-control patience: when the memory budget guard "
         "predicts a dispatch would not fit (cyclone.memory.budgetFraction "
         "x device memory), the batch is re-queued and re-checked each "
         "batching window until its oldest request has waited this long, "
         "then every request in it is shed with ServingOverloaded (503). "
         "Serving never raises MemoryBudgetError and never dispatches a "
         "program the guard predicts will run out of memory.")
    .check_value(lambda v: v >= 0, "must be >= 0")
    .float_conf(1000.0)
)

SERVING_MAX_RETRIES = (
    ConfigBuilder("cyclone.serving.maxRetries")
    .doc("Dispatch retries for TRANSIENT failures (resilience "
         "classification) before the batch is shed with a 5xx "
         "ServingError. Permanent failures shed immediately.")
    .check_value(lambda v: v >= 0, "must be >= 0")
    .int_conf(3)
)

SERVING_QUANTIZE = (
    ConfigBuilder("cyclone.serving.quantize")
    .doc("Serve QUANTIZED predict programs: coefficient tensors stored "
         "fp8 (e4m3) with per-margin-row scales at serving dtype, "
         "dequantized inside the kernel (one rounded multiply a "
         "coefficient; the per-row reduction stays independent of the "
         "batch dim, so bucket padding remains bitwise-neutral). Cuts "
         "each bucket program's parameter bytes 4-8x, so the admission "
         "path fits strictly more gang models under the same "
         "cyclone.memory.budgetFraction. Margins round to e4m3's 3-bit "
         "mantissa (~6 percent relative per coefficient): predictions at "
         "the decision boundary can flip. Off by default.")
    .bool_conf(False)
)
