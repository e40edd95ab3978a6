"""Declared-parameter store with namespacing and live reconfigure.

Capability parity with the reference's ROS 2 parameter machinery — ~60
declared parameters with descriptors (reference: pointcloud_preprocessor.py
:128-199), ``parameter_namespace`` prefixing for composing several nodes in
one process (:121-126), and the dynamic-reconfigure callback protocol
(:817-1004, SetParametersResult semantics) — without requiring rclpy. A ROS
adapter can mirror this store into real node parameters 1:1.

A copy of the reference package's ``runtime/params.py`` (the port does not
import the reference).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Any, Callable, Dict, List, Optional


class ParameterType(enum.Enum):
    BOOL = "bool"
    INT = "int"
    DOUBLE = "double"
    STRING = "string"
    BOOL_ARRAY = "bool_array"
    INT_ARRAY = "int_array"
    DOUBLE_ARRAY = "double_array"
    STRING_ARRAY = "string_array"

    @staticmethod
    def infer(value: Any) -> "ParameterType":
        if isinstance(value, bool):
            return ParameterType.BOOL
        if isinstance(value, int):
            return ParameterType.INT
        if isinstance(value, float):
            return ParameterType.DOUBLE
        if isinstance(value, str):
            return ParameterType.STRING
        if isinstance(value, (list, tuple)):
            if all(isinstance(v, bool) for v in value):
                return ParameterType.BOOL_ARRAY
            if all(isinstance(v, int) for v in value):
                return ParameterType.INT_ARRAY
            if all(isinstance(v, (int, float)) for v in value):
                return ParameterType.DOUBLE_ARRAY
            return ParameterType.STRING_ARRAY
        raise TypeError(f"cannot infer parameter type for {value!r}")


@dataclasses.dataclass
class Parameter:
    """A named parameter value (rclpy.Parameter analog)."""

    name: str
    value: Any
    type_: Optional[ParameterType] = None

    def __post_init__(self):
        if self.type_ is None:
            self.type_ = ParameterType.infer(self.value)


@dataclasses.dataclass
class SetParametersResult:
    """Result of a reconfigure attempt (rcl_interfaces analog)."""

    successful: bool = True
    reason: str = ""


_COMPATIBLE = {
    ParameterType.DOUBLE: {ParameterType.DOUBLE, ParameterType.INT},
    ParameterType.DOUBLE_ARRAY: {
        ParameterType.DOUBLE_ARRAY,
        ParameterType.INT_ARRAY,
    },
}


class ParameterStore:
    """Declared parameters + reconfigure callbacks.

    Unknown or type-mismatched sets are rejected, matching the reference's
    behavior of failing reconfigure for undeclared names
    (pointcloud_preprocessor.py:1001-1002).
    """

    def __init__(self, namespace: str = ""):
        # reference semantics: non-empty namespace becomes a dotted prefix
        # (pointcloud_preprocessor.py:123-126)
        if namespace:
            namespace = f"{namespace.rstrip('.')}."
        self.namespace = namespace
        self._declared: Dict[str, Parameter] = {}
        self._callbacks: List[Callable[[List[Parameter]], SetParametersResult]] = []

    # -- declaration / access -------------------------------------------------

    def declare(self, name: str, value: Any, description: str = "") -> None:
        full = f"{self.namespace}{name}"
        if full in self._declared:
            raise ValueError(f"parameter {full!r} already declared")
        self._declared[full] = Parameter(full, value)

    def get(self, name: str, namespaced: bool = True) -> Any:
        full = f"{self.namespace}{name}" if namespaced else name
        return self._declared[full].value

    def has(self, name: str) -> bool:
        return f"{self.namespace}{name}" in self._declared

    def names(self) -> List[str]:
        return list(self._declared)

    def by_prefix(self, prefix: str) -> Dict[str, Any]:
        """All params under ``namespace + prefix`` with the prefix stripped."""
        full_prefix = f"{self.namespace}{prefix}"
        out = {}
        for name, p in self._declared.items():
            if name.startswith(full_prefix):
                out[name[len(full_prefix):].lstrip(".")] = p.value
        return out

    # -- reconfigure ----------------------------------------------------------

    def add_on_set_parameters_callback(
        self, cb: Callable[[List[Parameter]], SetParametersResult]
    ) -> None:
        """Register a validation/update callback (rclpy analog, :375)."""
        self._callbacks.append(cb)

    def set_parameters(self, params: List[Parameter]) -> List[SetParametersResult]:
        """Attempt to update parameters; one result per parameter.

        Each parameter runs through every registered callback; a rejection
        leaves the stored value untouched (ROS semantics).
        """
        results = []
        for p in params:
            result = self._validate(p)
            if result.successful:
                for cb in self._callbacks:
                    result = cb([p])
                    if not result.successful:
                        break
            if result.successful:
                stored = self._declared[p.name]
                stored.value = p.value
                stored.type_ = p.type_
            results.append(result)
        return results

    def set_parameters_atomically(
        self, params: List[Parameter]
    ) -> SetParametersResult:
        """All-or-nothing update (rclpy set_parameters_atomically analog).

        Callbacks see the WHOLE list in one invocation, so coupled statics
        (e.g. ``neighborhood_passes`` and a per-pass ``window_blocks``
        tuple) can change together; any rejection leaves every stored
        value untouched.
        """
        result = SetParametersResult(successful=True)
        for p in params:
            result = self._validate(p)
            if not result.successful:
                return result
        for cb in self._callbacks:
            result = cb(list(params))
            if not result.successful:
                return result
        for p in params:
            stored = self._declared[p.name]
            stored.value = p.value
            stored.type_ = p.type_
        return result

    def _validate(self, p: Parameter) -> SetParametersResult:
        if p.name not in self._declared:
            return SetParametersResult(
                successful=False, reason=f"parameter {p.name!r} not declared"
            )
        declared_t = self._declared[p.name].type_
        ok_types = _COMPATIBLE.get(declared_t, {declared_t})
        if p.type_ not in ok_types and self._declared[p.name].value is not None:
            # empty-list declarations (e.g. visualize.front) accept any array
            if not (
                isinstance(self._declared[p.name].value, (list, tuple))
                and isinstance(p.value, (list, tuple))
            ):
                return SetParametersResult(
                    successful=False,
                    reason=(
                        f"type mismatch for {p.name!r}: declared "
                        f"{declared_t.value}, got {p.type_.value}"
                    ),
                )
        return SetParametersResult(successful=True)
