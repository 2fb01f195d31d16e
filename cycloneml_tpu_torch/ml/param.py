"""ML parameter system — the port's copy of ``cycloneml_tpu/ml/param.py``.

Per-instance ``Param``/``ParamMap`` semantics (ref: mllib/src/main/scala/org/
apache/spark/ml/param/params.scala): typed params with docs and validators,
per-instance default vs. user-set maps, ``copy``/``extractParamMap``, and
JSON persistence of values — the contract ``DefaultParamsWriter`` relies on
(``ml/util_io.py``).
"""

from __future__ import annotations

import json
import uuid
from typing import Any, Callable, Dict, Generic, List, Optional, TypeVar

import numpy as np

T = TypeVar("T")


class Param(Generic[T]):
    """A param with self-contained documentation (≈ params.scala Param)."""

    def __init__(self, parent: str, name: str, doc: str,
                 is_valid: Optional[Callable[[T], bool]] = None):
        self.parent = parent
        self.name = name
        self.doc = doc
        self.is_valid = is_valid or (lambda v: True)

    def validate(self, value: T) -> None:
        if not self.is_valid(value):
            raise ValueError(f"{self.parent}_{self.name} given invalid value {value!r}")

    def __repr__(self) -> str:
        return f"{self.parent}__{self.name}"

    def __hash__(self) -> int:
        return hash((self.parent, self.name))

    def __eq__(self, other) -> bool:
        return isinstance(other, Param) and (self.parent, self.name) == (other.parent, other.name)

    # JSON codecs used by model persistence
    def json_encode(self, value: T) -> str:
        if isinstance(value, np.ndarray):
            return json.dumps(value.tolist())
        return json.dumps(value)

    def json_decode(self, s: str) -> T:
        return json.loads(s)


class ParamValidators:
    """Factory of common validators (≈ params.scala ParamValidators)."""

    @staticmethod
    def gt(lower: float) -> Callable:
        return lambda v: v > lower

    @staticmethod
    def gt_eq(lower: float) -> Callable:
        return lambda v: v >= lower

    @staticmethod
    def lt(upper: float) -> Callable:
        return lambda v: v < upper

    @staticmethod
    def lt_eq(upper: float) -> Callable:
        return lambda v: v <= upper

    @staticmethod
    def in_range(lo: float, hi: float, lower_inclusive: bool = True,
                 upper_inclusive: bool = True) -> Callable:
        def check(v):
            ok_lo = v >= lo if lower_inclusive else v > lo
            ok_hi = v <= hi if upper_inclusive else v < hi
            return ok_lo and ok_hi
        return check

    @staticmethod
    def in_array(allowed: List) -> Callable:
        return lambda v: v in allowed

    @staticmethod
    def array_length_gt(lower: int) -> Callable:
        return lambda v: len(v) > lower


class ParamMap:
    """A map of param → value (≈ params.scala ParamMap)."""

    def __init__(self, initial: Optional[Dict[Param, Any]] = None):
        self._map: Dict[Param, Any] = dict(initial or {})

    def put(self, param: Param, value: Any) -> "ParamMap":
        param.validate(value)
        self._map[param] = value
        return self

    def get(self, param: Param, default: Any = None) -> Any:
        return self._map.get(param, default)

    def contains(self, param: Param) -> bool:
        return param in self._map

    def remove(self, param: Param) -> Any:
        return self._map.pop(param, None)

    def copy(self) -> "ParamMap":
        return ParamMap(self._map)

    def items(self):
        return self._map.items()

    def __len__(self) -> int:
        return len(self._map)

    def __iter__(self):
        return iter(self._map)

    def __add__(self, other: "ParamMap") -> "ParamMap":
        m = self.copy()
        m._map.update(other._map)
        return m


class Params:
    """Base trait for components that take parameters (≈ params.scala Params).

    Subclasses declare params as class attributes built in ``_declare_params``
    or module scope; per-instance state lives in ``_param_map`` (user-set) and
    ``_default_param_map`` (defaults) exactly like the reference's paramMap /
    defaultParamMap split, which persistence depends on.
    """

    def __init__(self, uid: Optional[str] = None):
        self.uid = uid or f"{type(self).__name__}_{uuid.uuid4().hex[:12]}"
        self._params: Dict[str, Param] = {}
        self._param_map = ParamMap()
        self._default_param_map = ParamMap()

    # -- param declaration ---------------------------------------------------
    def _param(self, name: str, doc: str, is_valid: Optional[Callable] = None,
               default: Any = None) -> Param:
        p = Param(type(self).__name__, name, doc, is_valid)
        self._params[name] = p
        if default is not None:
            self._set_default(p, default)
        return p

    def _set_default(self, param: Param, value: Any) -> None:
        if value is not None:
            self._default_param_map.put(param, value)

    # -- access ---------------------------------------------------------------
    @property
    def params(self) -> List[Param]:
        return sorted(self._params.values(), key=lambda p: p.name)

    def get_param(self, name: str) -> Param:
        if name not in self._params:
            raise KeyError(f"Param {name} does not exist on {self.uid}")
        return self._params[name]

    def is_set(self, param: Param) -> bool:
        return self._param_map.contains(param)

    def is_defined(self, param: Param) -> bool:
        return self._param_map.contains(param) or self._default_param_map.contains(param)

    def has_default(self, param: Param) -> bool:
        return self._default_param_map.contains(param)

    def get_or_default(self, param: Param) -> Any:
        if self._param_map.contains(param):
            return self._param_map.get(param)
        if self._default_param_map.contains(param):
            return self._default_param_map.get(param)
        raise KeyError(f"Param {param} is not set and has no default")

    def get_default(self, param: Param) -> Any:
        return self._default_param_map.get(param)

    def set(self, param, value) -> "Params":
        if isinstance(param, str):
            param = self.get_param(param)
        self._param_map.put(param, value)
        return self

    def clear(self, param: Param) -> "Params":
        self._param_map.remove(param)
        return self

    def extract_param_map(self, extra: Optional[ParamMap] = None) -> ParamMap:
        m = self._default_param_map.copy() + self._param_map
        if extra is not None:
            m = m + extra
        return m

    # convenience: obj.get('maxIter')
    def get(self, name: str) -> Any:
        return self.get_or_default(self.get_param(name))

    # -- copy -----------------------------------------------------------------
    def copy(self, extra: Optional[ParamMap] = None) -> "Params":
        import copy as _copy
        that = _copy.copy(self)
        that._param_map = self._param_map.copy()
        that._default_param_map = self._default_param_map.copy()
        # re-point params at the clone: Param identity is (parent, name) so
        # the shared class-level declarations remain valid
        if extra is not None:
            for p, v in extra.items():
                if p.name in that._params:
                    that._param_map.put(that._params[p.name], v)
        return that

    def _copy_values(self, to: "Params", extra: Optional[ParamMap] = None) -> "Params":
        """Copy explicitly-set param values from this instance to ``to`` (≈ copyValues)."""
        m = self._param_map.copy() + (extra or ParamMap())
        for p, v in m.items():
            if p.name in to._params:
                to.set(to.get_param(p.name), v)
        return to

    # -- persistence helpers ---------------------------------------------------
    def _params_to_json(self) -> Dict[str, Any]:
        out = {}
        for name, p in self._params.items():
            if self._param_map.contains(p):
                v = self._param_map.get(p)
                out[name] = json.loads(p.json_encode(v))
        return out

    def _default_params_to_json(self) -> Dict[str, Any]:
        out = {}
        for name, p in self._params.items():
            if self._default_param_map.contains(p):
                v = self._default_param_map.get(p)
                out[name] = json.loads(p.json_encode(v))
        return out

    def _set_params_from_json(self, d: Dict[str, Any], default: bool = False) -> None:
        for name, v in d.items():
            if name in self._params:
                if default:
                    self._default_param_map.put(self._params[name], v)
                else:
                    self._param_map.put(self._params[name], v)

    def explain_param(self, param: Param) -> str:
        value = "undefined"
        if self.is_defined(param):
            value = repr(self.get_or_default(param))
        default = ""
        if self.has_default(param):
            default = f" (default: {self.get_default(param)!r})"
        return f"{param.name}: {param.doc}{default} (current: {value})"

    def explain_params(self) -> str:
        return "\n".join(self.explain_param(p) for p in self.params)
