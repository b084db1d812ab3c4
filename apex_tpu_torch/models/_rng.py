"""The dropout keys Flax hands the reference's GPT and BERT layers.

The reference draws every dropout key with ``self.make_rng("dropout")``
from the key its user passes as ``apply(..., rngs={"dropout": key})``.
Flax derives each one from the module path (``core/scope.py`` of
Flax 0.12.3):

- a scope holds its collection's key with a *suffix*, the names of the
  scopes pushed since the key was last concrete (``LazyRng``);
- ``make_rng`` counts its calls per scope from 1 and appends the count;
- the key becomes concrete as ``fold_in(key, h)``, ``h`` the first four
  bytes, big-endian, of the SHA-1 of the suffix: each name's UTF-8 bytes
  and each count in its minimal big-endian bytes, concatenated with no
  separator (``_fold_in_static`` with Flax's separator flag
  ``fix_rng_separator`` off);
- ``nn.scan(..., split_rngs={"dropout": True})`` splits the *raw* key of
  the scanned scope into one per layer (``random.split(clone(rng),
  length)``, ``core/lift.py``), keeping its suffix: layer ``i`` draws
  from ``split(key, L)[i]`` with the path ``("layers", "layer", ...)``.
  The scan traces its body twice, first in "init mode" to find the
  outputs it broadcasts (``core/axes_scan.py`` :169-185), and both
  traces share the counters: in a scanned layer every scope's draw has
  count 2.

So with ``scan_layers=True`` layer ``i``'s attention draw is
``fold_in(split(key, L)[i], h("layers", "layer", "attention", 2))``, and
with ``scan_layers=False`` it is ``fold_in(key, h("layer_i",
"attention", 1))``. Each layer draws (``models/gpt.py`` :312-320,
:344-347, :408-409, :423-424; ``models/bert.py`` :122-129, :144-147,
:175-176, :190-191): the flash kernel's key in the attention scope, or
on the softmax backend the probabilities' ``nn.Dropout`` (``Dropout_0``
of the attention scope); then the two hidden ``nn.Dropout`` of the
layer, ``Dropout_0`` after the attention and ``Dropout_1`` after the
MLP. Keys are (k1, k2) pairs of Python ints, derived on the host.
"""

from __future__ import annotations

import hashlib
from typing import List, NamedTuple, Sequence, Tuple, Union

from apex_tpu_torch.random import KeyLike, M32, key_words, threefry2x32

Key = Tuple[int, int]


def fold_in_static(key: KeyLike, data: Sequence[Union[str, int]]) -> Key:
    """Flax's ``_fold_in_static``: ``key`` folded with the SHA-1 of the
    names and counts in ``data`` (no separator between them)."""
    k = key_words(key)
    if not data:
        return k
    m = hashlib.sha1()
    for x in data:
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        else:
            m.update(int(x).to_bytes((int(x).bit_length() + 7) // 8, "big"))
    h = int.from_bytes(m.digest()[:4], "big")
    return threefry2x32(k[0], k[1], 0, h & M32)


def make_rng(key: KeyLike, path: Sequence[str], count: int = 1) -> Key:
    """The key of the ``count``-th ``make_rng`` call of the scope at
    ``path`` (names since ``key`` was last concrete)."""
    return fold_in_static(key, (*path, count))


class LayerKeys(NamedTuple):
    """One layer's dropout keys: ``attention`` (the flash kernel's, or
    the softmax probabilities' ``nn.Dropout``), ``hidden`` (after the
    attention, after the MLP)."""

    attention: Key
    hidden: Tuple[Key, Key]


def layer_keys(key: KeyLike, num_layers: int, *, scan_layers: bool,
               softmax_backend: bool) -> List[LayerKeys]:
    """The keys each layer of the reference's GPT or BERT draws from
    ``apply(..., rngs={"dropout": key})``."""
    k = key_words(key)
    out = []
    for i in range(num_layers):
        if scan_layers:
            base, path, n = (threefry2x32(k[0], k[1], 0, i),
                             ("layers", "layer"), 2)
        else:
            base, path, n = k, (f"layer_{i}",), 1
        attn = ((*path, "attention", "Dropout_0") if softmax_backend
                else (*path, "attention"))
        out.append(LayerKeys(
            make_rng(base, attn, n),
            (make_rng(base, (*path, "Dropout_0"), n),
             make_rng(base, (*path, "Dropout_1"), n))))
    return out


__all__ = ["LayerKeys", "fold_in_static", "layer_keys", "make_rng"]
