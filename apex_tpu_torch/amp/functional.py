"""Function-level precision control: the cast decorators.

Counterpart of ``apex_tpu/amp/functional.py`` (:21-115). The reference
names the control points of its patching pass (``half_function``,
``float_function``, ``promote_function`` and the ``register_*`` calls);
here, as there, they are explicit decorators applied where a function is
defined or used, and ``register_*`` rebinds a module attribute at once.

The cast rule is defined once, in :func:`_cast_floats`: floating-point
tensors anywhere in nested tuples, lists and dicts are cast; Python
scalars, integer and boolean tensors pass through (a Python float stays
weakly typed, on both sides). :func:`promote_function` casts every float
tensor to the widest float dtype among them, 0-d tensors included: JAX
promotes an fp16 array with an fp32 0-d array to fp32, where PyTorch's
own promotion lets a 0-d tensor lose to a dimensioned one.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Optional

import torch


def _is_float(x) -> bool:
    return isinstance(x, torch.Tensor) and x.is_floating_point()


def _tree_map(fn: Callable, tree: Any) -> Any:
    """``fn`` over the leaves of nested tuples (named ones too), lists
    and dicts; anything else is a leaf."""
    if isinstance(tree, dict):
        return type(tree)((k, _tree_map(fn, v)) for k, v in tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree: Any) -> list:
    out = []
    _tree_map(out.append, tree)
    return out


def _cast_floats(tree: Any, dtype: torch.dtype) -> Any:
    return _tree_map(lambda x: x.to(dtype) if _is_float(x) else x, tree)


def widest_float(tree: Any) -> Optional[torch.dtype]:
    """The widest float dtype among the float tensors of ``tree`` (JAX's
    ``result_type`` of their dtypes: bf16 with fp16 gives fp32), or None
    without one."""
    dtypes = [x.dtype for x in _leaves(tree) if _is_float(x)]
    if not dtypes:
        return None
    return functools.reduce(torch.promote_types, dtypes)


def promote_floats(tree: Any) -> Any:
    """``tree`` with every float tensor cast to :func:`widest_float`."""
    widest = widest_float(tree)
    return tree if widest is None else _cast_floats(tree, widest)


def _cast_function(fn: Callable, dtype: torch.dtype) -> Callable:
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        return fn(*_cast_floats(args, dtype), **_cast_floats(kwargs, dtype))

    return wrapper


def half_function(fn: Callable) -> Callable:
    """Run ``fn`` with float16 inputs."""
    return _cast_function(fn, torch.float16)


def bfloat16_function(fn: Callable) -> Callable:
    """Run ``fn`` with bfloat16 inputs."""
    return _cast_function(fn, torch.bfloat16)


def float_function(fn: Callable) -> Callable:
    """Run ``fn`` with float32 inputs."""
    return _cast_function(fn, torch.float32)


def promote_function(fn: Callable) -> Callable:
    """Run ``fn`` with every float tensor argument cast to the widest
    float dtype among them (0-d tensors included)."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        args, kwargs = promote_floats((args, kwargs))
        return fn(*args, **kwargs)

    return wrapper


def compute_cast(fn: Callable, compute_dtype: torch.dtype) -> Callable:
    """Cast inputs to ``compute_dtype`` and the float outputs back to fp32:
    the O1/O4 behaviour at one boundary (a model's forward)."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        out = fn(*_cast_floats(args, compute_dtype),
                 **_cast_floats(kwargs, compute_dtype))
        return _cast_floats(out, torch.float32)

    return wrapper


def _register(module, name: str, deco: Callable) -> None:
    setattr(module, name, deco(getattr(module, name)))


def register_half_function(module, function_name: str) -> None:
    """Replace ``module.function_name`` by its :func:`half_function` form
    (at once: there is no deferred patching pass)."""
    _register(module, function_name, half_function)


def register_bfloat16_function(module, function_name: str) -> None:
    _register(module, function_name, bfloat16_function)


def register_float_function(module, function_name: str) -> None:
    _register(module, function_name, float_function)


def register_promote_function(module, function_name: str) -> None:
    _register(module, function_name, promote_function)


__all__ = ["bfloat16_function", "compute_cast", "float_function",
           "half_function", "promote_floats", "promote_function",
           "register_bfloat16_function", "register_float_function",
           "register_half_function", "register_promote_function",
           "widest_float"]
