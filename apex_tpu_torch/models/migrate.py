"""Checkpoint migration between scanned and unrolled layer stacks.

Counterpart of ``apex_tpu/models/migrate.py``. The reference's model zoo
stacks each layer stack's parameters under one scanned node with a
leading layer axis; checkpoints written by its unrolled form name each
layer. These helpers convert a nested mapping (dicts of numpy arrays or
tensors) either way:

=================  ==========================  =====================
model              scanned node                unrolled names
=================  ==========================  =====================
GPT / BERT         ``layers.layer``            ``layer_{i}``
T5 encoder         ``encoder_layers.layer``    ``encoder_{i}``
T5 decoder         ``decoder_layers.layer``    ``decoder_{i}``
=================  ==========================  =====================

Only the structure changes; values are moved bit for bit (a layer's
slice of a stacked leaf, or the stack of the layers' leaves, in the
leaf's own dtype).
"""

from __future__ import annotations

import re
from typing import Any, Callable, Mapping

import numpy as np
import torch

# scanned-node name -> unrolled per-layer name pattern
_SCAN_NODES = {
    "layers": "layer_{}",
    "encoder_layers": "encoder_{}",
    "decoder_layers": "decoder_{}",
}
_UNROLLED_RE = re.compile(r"^(layer|encoder|decoder)_(\d+)$")
_STACK_OF = {"layer": "layers", "encoder": "encoder_layers",
             "decoder": "decoder_layers"}


def _first_leaf(tree: Mapping):
    for val in tree.values():
        leaf = _first_leaf(val) if isinstance(val, Mapping) else val
        if leaf is not None:
            return leaf
    return None


def _map(fn: Callable, *trees: Mapping) -> dict:
    """``fn`` over the leaves of mappings of one structure."""
    return {key: (_map(fn, *(t[key] for t in trees))
                  if isinstance(val, Mapping) else fn(*(t[key] for t in trees)))
            for key, val in trees[0].items()}


def _stack(*leaves):
    if isinstance(leaves[0], torch.Tensor):
        return torch.stack(leaves, dim=0)
    return np.stack(leaves, axis=0)


def unstack_scan_params(tree: Any) -> Any:
    """Scanned layout -> unrolled layout (``layers.layer`` with a leading
    layer axis becomes ``layer_0 .. layer_{L-1}``)."""
    if not isinstance(tree, Mapping):
        return tree
    out = {}
    for key, val in tree.items():
        if (key in _SCAN_NODES and isinstance(val, Mapping)
                and set(val) == {"layer"}):
            body = val["layer"]
            leaf = _first_leaf(body)
            if leaf is None:
                out[key] = val
                continue
            pat = _SCAN_NODES[key]
            for i in range(int(leaf.shape[0])):
                out[pat.format(i)] = _map(lambda x, i=i: x[i], body)
        else:
            out[key] = unstack_scan_params(val)
    return out


def stack_scan_params(tree: Any) -> Any:
    """Unrolled layout -> scanned layout (the ``layer_{i}`` groups are
    stacked along a new leading axis under ``layers.layer``). Raises when
    a group's indices are not 0 .. n - 1."""
    if not isinstance(tree, Mapping):
        return tree
    groups: dict = {}
    out = {}
    for key, val in tree.items():
        m = _UNROLLED_RE.match(key)
        if m:
            groups.setdefault(m.group(1), {})[int(m.group(2))] = val
        else:
            out[key] = stack_scan_params(val)
    for kind, by_idx in groups.items():
        n = len(by_idx)
        missing = [i for i in range(n) if i not in by_idx]
        if missing:
            raise ValueError(
                f"unrolled {kind}_* params are not contiguous: have "
                f"{sorted(by_idx)}, missing {missing}")
        out[_STACK_OF[kind]] = {
            "layer": _map(_stack, *[by_idx[i] for i in range(n)])}
    return out


__all__ = ["stack_scan_params", "unstack_scan_params"]
