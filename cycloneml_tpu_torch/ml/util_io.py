"""Model persistence.

The port's counterpart of ``cycloneml_tpu/ml/util_io.py``, in the same
layout (ref: ml/util/ReadWrite.scala — MLWriter:157, MLReader:323,
MLWritable:274, DefaultParamsWriter/Reader): a model directory holds
``metadata/part-00000`` with the {class, timestamp, cycloneVersion, uid,
paramMap, defaultParamMap} JSON and ``data/data.npz`` with the learned
arrays; pipelines keep their stages under ``stages/<idx>_<uid>/``.

A directory the reference wrote loads here: a ``class`` under the
reference's package (the port's name without its ``_torch`` suffix) is
read as the same path under the port's package, by name: nothing of the
reference is imported. A class the port does not have yet raises and names
its ROADMAP item.
"""

from __future__ import annotations

import importlib
import inspect
import json
import os
import shutil
import time
from typing import Any, Dict, Optional

import numpy as np

VERSION = "0.1.0"

_PORT_PACKAGE = __name__.split(".")[0]
_PORT_PREFIX = _PORT_PACKAGE + "."
_REFERENCE_PREFIX = _PORT_PACKAGE[:-len("_torch")] + "."

#: where a class without a port stands in the ROADMAP (Queue 1 items), by
#: prefix of its path under the port's package; the first match wins
#: (SQLTransformer parses through the SQL engine, the host-side layers')
_ROADMAP_ITEMS = (("ml.feature.formula.SQLTransformer", 12), ("ml.", 11),
                  ("", 12))


def _metadata_path(path: str) -> str:
    return os.path.join(path, "metadata", "part-00000")


def save_metadata(instance, path: str,
                  extra: Optional[Dict[str, Any]] = None) -> None:
    os.makedirs(os.path.join(path, "metadata"), exist_ok=True)
    meta = {
        "class": f"{type(instance).__module__}.{type(instance).__qualname__}",
        "timestamp": int(time.time() * 1000),
        "cycloneVersion": VERSION,
        "uid": instance.uid,
        "paramMap": instance._params_to_json(),
        "defaultParamMap": instance._default_params_to_json(),
    }
    if extra:
        meta.update(extra)
    with open(_metadata_path(path), "w", encoding="utf-8") as fh:
        json.dump(meta, fh)


def load_metadata(path: str) -> Dict[str, Any]:
    with open(_metadata_path(path), encoding="utf-8") as fh:
        return json.load(fh)


def port_class_path(name: str) -> str:
    """The port's path of a persisted class name: the reference's package
    prefix replaced by the port's; a port path unchanged."""
    if name.startswith(_REFERENCE_PREFIX):
        return _PORT_PREFIX + name[len(_REFERENCE_PREFIX):]
    return name


def _class_of(name: str):
    path = port_class_path(name)
    module, _, cls_name = path.rpartition(".")
    if not module.startswith(_PORT_PREFIX):
        raise ValueError(f"{name!r} is not a class of cycloneml")
    try:
        cls = getattr(importlib.import_module(module), cls_name)
    except (ImportError, AttributeError):
        rest = path[len(_PORT_PREFIX):]
        item = next(i for prefix, i in _ROADMAP_ITEMS
                    if rest.startswith(prefix))
        raise NotImplementedError(
            f"{name} has no port yet: ROADMAP Queue 1 item {item}") from None
    return cls


def instantiate_from_metadata(meta: Dict[str, Any]):
    cls = _class_of(meta["class"])
    obj = cls.__new__(cls)
    if _init_takes_uid(cls):
        cls.__init__(obj, uid=meta["uid"])
    else:
        cls.__init__(obj)
    obj._set_params_from_json(meta.get("defaultParamMap", {}), default=True)
    obj._set_params_from_json(meta.get("paramMap", {}))
    return obj


def _init_takes_uid(cls) -> bool:
    try:
        return "uid" in inspect.signature(cls.__init__).parameters
    except (TypeError, ValueError):
        return False


def save_arrays(path: str, **arrays) -> None:
    os.makedirs(os.path.join(path, "data"), exist_ok=True)
    np.savez(os.path.join(path, "data", "data.npz"), **arrays)


def load_arrays(path: str) -> Dict[str, np.ndarray]:
    z = np.load(os.path.join(path, "data", "data.npz"), allow_pickle=False)
    return {k: z[k] for k in z.files}


class MLWritable:
    """Mixin giving ``save(path)`` (ref MLWritable:274). Subclasses override
    ``_save_data(path)`` to write learned state."""

    def save(self, path: str, overwrite: bool = False) -> None:
        if os.path.exists(path):
            if not overwrite:
                raise IOError(f"Path exists: {path}; use overwrite=True")
            shutil.rmtree(path)
        os.makedirs(path)
        save_metadata(self, path)
        self._save_data(path)

    def write(self) -> "_Writer":
        return _Writer(self)

    def _save_data(self, path: str) -> None:
        pass


class _Writer:
    """Fluent writer (ref MLWriter:157)."""

    def __init__(self, instance):
        self._instance = instance
        self._overwrite = False

    def overwrite(self) -> "_Writer":
        self._overwrite = True
        return self

    def save(self, path: str) -> None:
        self._instance.save(path, overwrite=self._overwrite)


class MLReadable:
    """Mixin giving ``load(path)`` (ref MLReadable/MLReader:323)."""

    @classmethod
    def load(cls, path: str):
        meta = load_metadata(path)
        obj = instantiate_from_metadata(meta)
        if not isinstance(obj, cls):
            raise TypeError(f"{path} holds {type(obj).__name__}, expected "
                            f"{cls.__name__}")
        obj._load_data(path, meta)
        return obj

    @classmethod
    def read(cls) -> "_Reader":
        return _Reader(cls)

    def _load_data(self, path: str, meta: Dict[str, Any]) -> None:
        pass


class _Reader:
    def __init__(self, cls):
        self._cls = cls

    def load(self, path: str):
        return self._cls.load(path)


def load_instance(path: str):
    """Whatever instance the directory holds, its learned state loaded."""
    meta = load_metadata(path)
    obj = instantiate_from_metadata(meta)
    obj._load_data(path, meta)
    return obj


def save_pipeline_stages(stages, path: str) -> None:
    os.makedirs(os.path.join(path, "stages"), exist_ok=True)
    for i, stage in enumerate(stages):
        stage.save(os.path.join(path, "stages", f"{i}_{stage.uid}"),
                   overwrite=True)


def load_pipeline_stages(path: str):
    sdir = os.path.join(path, "stages")
    entries = sorted(os.listdir(sdir), key=lambda s: int(s.split("_", 1)[0]))
    return [load_instance(os.path.join(sdir, e)) for e in entries]
