"""Process-level active amp policy.

Counterpart of ``apex_tpu/amp/_amp_state.py``: ``amp.initialize``
activates its ``Properties`` here and ``policy_scope`` scopes one. The
function-level casts that read the policy (the reference's ``amp.F``,
``functional.py``, ``handle.py``'s ``disable_casts``) are not ported
yet; the port's models take their compute dtype from their config.
"""

from __future__ import annotations

import contextlib
from typing import Any, Optional

_active_props: Optional[Any] = None
allow_banned: bool = False


def set_active(props: Optional[Any]) -> None:
    global _active_props
    _active_props = props


def get_active() -> Optional[Any]:
    return _active_props


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


__all__ = ["set_active", "get_active", "policy_scope", "allow_banned"]
