"""Process-level active amp policy.

Counterpart of ``apex_tpu/amp/_amp_state.py``: ``amp.initialize``
activates its ``Properties`` here and ``policy_scope`` scopes one. The
``amp.F`` functions (``amp/nn_functional.py``) read the policy at each
call: ``active_compute_dtype`` is the dtype whitelisted ops run in, or
None when no patch-style policy (O1, O4) is active or casts are
suspended (``amp.disable_casts``, through ``suspend_casts``). The port's
models take their compute dtype from their config, not from here.
"""

from __future__ import annotations

import contextlib
from typing import Any, Optional

_active_props: Optional[Any] = None
_casts_disabled: int = 0
allow_banned: bool = False


def set_active(props: Optional[Any]) -> None:
    global _active_props
    _active_props = props


def get_active() -> Optional[Any]:
    return _active_props


def casts_enabled() -> bool:
    return _casts_disabled == 0


def active_compute_dtype():
    """The ``torch.dtype`` whitelisted ops run in right now, or None when
    no patch-style policy (O1/O4) is active or casts are suspended."""
    if not casts_enabled() or _active_props is None:
        return None
    return getattr(_active_props, "compute_dtype", None)


@contextlib.contextmanager
def policy_scope(props: Optional[Any]):
    """Activate ``props`` for the duration of the block."""
    global _active_props
    prev = _active_props
    _active_props = props
    try:
        yield
    finally:
        _active_props = prev


@contextlib.contextmanager
def suspend_casts():
    """Every ``amp.F`` wrapper passes its inputs through unchanged inside
    the block (nested blocks count)."""
    global _casts_disabled
    _casts_disabled += 1
    try:
        yield
    finally:
        _casts_disabled -= 1


__all__ = ["set_active", "get_active", "casts_enabled",
           "active_compute_dtype", "policy_scope", "suspend_casts",
           "allow_banned"]
