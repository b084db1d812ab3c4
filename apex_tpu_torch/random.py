"""The counter-based threefry2x32 generator of ``jax.random``, in PyTorch.

Counterpart of the subset of ``jax.random`` the reference draws from:
``PRNGKey``, ``key_data``, ``fold_in``, ``split``, ``bits`` (32-bit),
``uniform``, ``normal``, ``bernoulli`` and ``gumbel``. A key is a (2,) int64 tensor
holding two uint32 words; every operation is uint32 arithmetic carried
in int64 (or in Python ints, for the few words of a key derivation,
which stay on the host) and cut back with ``& 0xFFFFFFFF``, so the same
key gives the same bits on the CPU and on the card, and the same bits
as JAX 0.9.0 with its defaults (64-bit types off and
``jax_threefry_partitionable=True``, ``jax/_src/prng.py``):

- ``PRNGKey(seed)`` is ``(0, seed mod 2^32)`` (a 32-bit seed padded
  with a zero high word, ``_threefry_seed``);
- ``bits(key, shape)`` is ``x1 ^ x2`` of ``threefry2x32(key, (hi, lo))``
  over the hi and lo words of each element's flat index
  (``_threefry_random_bits_partitionable``);
- ``split(key, n)`` is key ``i`` = ``threefry2x32(key, (0, i))``
  (``_threefry_split_foldlike``);
- ``fold_in(key, d)`` is ``threefry2x32(key, (0, d))``.

``uniform``, ``normal``, ``bernoulli`` and ``gumbel`` follow
``jax/_src/random.py``: 23 random mantissa bits under the exponent of
1.0, minus 1.0, then scaled; ``normal`` is ``sqrt(2) erfinv(u)`` with
``u`` uniform on ``(-1, 1)`` and XLA's single-precision ``erfinv`` (M.
Giles' polynomials; its ``log1p`` and ``sqrt`` are PyTorch's, so a draw
is within a few ulps of JAX's, most of them bitwise);
``bernoulli`` is ``uniform < p`` in fp32; ``gumbel`` is
``-log(-log(u))`` with ``u`` drawn on ``[tiny, 1)``.

The fused dropout kernel (``csrc/dropout.cu``) computes ``bits`` per
element on the card; this module is its plain version.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np
import torch

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

KeyLike = Union[torch.Tensor, Sequence[int]]


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & M32) | (x >> (32 - r))


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of the counter pairs ``(x1,
    x2)`` under the key ``(k1, k2)``: int64 tensors (or Python ints) of
    uint32 values that broadcast together; returns the two output
    words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & M32
    x2 = (x2 + ks[1]) & M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x1 = (x1 + x2) & M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & M32
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & M32
    return x1, x2


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: the key ``(0, seed mod 2^32)``."""
    return torch.tensor([0, int(seed) & M32], dtype=torch.int64,
                        device=device)


def key_words(key: KeyLike) -> Tuple[int, int]:
    """A key's two uint32 words as Python ints, from a (2,) tensor (read
    to the host), a numpy array (the reference's
    ``jax.random.key_data``) or a pair of ints."""
    if isinstance(key, torch.Tensor):
        flat = key.reshape(-1).tolist()
    elif hasattr(key, "ravel"):
        flat = key.ravel().tolist()
    else:
        flat = list(key)
    if len(flat) != 2:
        raise ValueError(f"a key has two uint32 words, got {len(flat)}")
    return int(flat[0]) & M32, int(flat[1]) & M32


def key_data(key: KeyLike, device=None) -> torch.Tensor:
    """A key as a (2,) int64 tensor of its two uint32 words."""
    return torch.tensor(key_words(key), dtype=torch.int64, device=device)


def fold_in(key: KeyLike, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: ``threefry2x32(key, (0,
    data))`` (``data`` cut to 32 bits), computed on the host."""
    k1, k2 = key_words(key)
    return torch.tensor(threefry2x32(k1, k2, 0, int(data) & M32),
                        dtype=torch.int64)


def split(key: KeyLike, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: (num, 2) keys, key ``i`` being
    ``threefry2x32(key, (0, i))``, computed on the host."""
    k1, k2 = key_words(key)
    i = torch.arange(num, dtype=torch.int64)
    y1, y2 = threefry2x32(k1, k2, torch.zeros_like(i), i)
    return torch.stack([y1, y2], dim=1)


def _counters(shape, device):
    n = 1
    for s in shape:
        n *= int(s)
    idx = torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
    return idx >> 32, idx & M32


def bits(key: KeyLike, shape: Sequence[int], device=None) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32) as int64 values on
    ``device`` (the CPU by default): each element's flat index split
    into hi and lo words, hashed, the two words xor-ed. A stack of keys
    (an (n, 2) tensor) draws n arrays at once, (n, *shape), the i-th
    being ``bits(key[i], shape)`` (the reference's ``vmap`` of a draw)."""
    hi, lo = _counters(tuple(shape), device)
    if isinstance(key, torch.Tensor) and key.ndim == 2:
        k = key.to(device=hi.device, dtype=torch.int64).reshape(
            -1, 2, *([1] * len(shape)))
        k1, k2 = k[:, 0], k[:, 1]
    else:
        k1, k2 = key_words(key)
    y1, y2 = threefry2x32(k1, k2, hi, lo)
    return y1 ^ y2


def _unit_floats(b: torch.Tensor) -> torch.Tensor:
    """fp32 in [0, 1) from uint32 bits: the top 23 bits as the mantissa
    of a number in [1, 2), minus 1."""
    one = ((b >> 9) | 0x3F800000).to(torch.int32)
    return one.view(torch.float32) - 1.0


def uniform(key: KeyLike, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0, device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    f = _unit_floats(bits(key, shape, device))
    # fp32 0-d tensors made on the device (no host copy: a CUDA graph
    # can capture the draw)
    lo = torch.full((), minval, dtype=torch.float32, device=f.device)
    hi = torch.full((), maxval, dtype=torch.float32, device=f.device)
    return torch.maximum(lo, f * (hi - lo) + lo)


# XLA's fp32 erfinv: M. Giles, "Approximating the erfinv function", in
# w = -log1p(-x^2) - 2.5 below 5, sqrt(w) - 3 above
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _erfinv(x: torch.Tensor) -> torch.Tensor:
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = None
    for a, b in zip(_ERFINV_LT5, _ERFINV_GE5):
        c = torch.where(lt, torch.full((), np.float32(a), device=x.device),
                        torch.full((), np.float32(b), device=x.device))
        p = c if p is None else c + p * w
    return torch.where(x.abs() == 1, x * float("inf"), p * x)


def normal(key: KeyLike, shape: Sequence[int], device=None) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)``: ``sqrt(2) erfinv(u)``,
    ``u`` uniform on ``[nextafter(-1, 0), 1)`` in fp32."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(key, shape, lo, 1.0, device)
    return torch.full((), np.float32(np.sqrt(2.0)), dtype=torch.float32,
                      device=u.device) * _erfinv(u)


def bernoulli(key: KeyLike, p: float, shape: Sequence[int],
              device=None) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)`` for a Python float ``p``:
    ``uniform < p`` with ``p`` rounded to fp32."""
    u = uniform(key, shape, device=device)
    return u < torch.full((), p, dtype=torch.float32, device=u.device)


def gumbel(key: KeyLike, shape: Sequence[int], device=None) -> torch.Tensor:
    """``jax.random.gumbel(key, shape, float32)`` (its default "low"
    mode): ``-log(-log(u))``, ``u`` uniform on ``[tiny, 1)``. On the CPU
    both logs are taken in fp64 through numpy and the result rounded
    once to fp32: PyTorch's fp32 CPU ``log`` splits a large tensor over
    worker threads, and a chunk may take another vector path, so its
    bits would depend on the thread count (as ``torch.sqrt``'s do,
    ``multi_tensor.engine.sqrt_rn``). On the card, ``torch.log``."""
    tiny = torch.finfo(torch.float32).tiny
    u = uniform(key, shape, tiny, 1.0, device)
    if u.device.type == "cpu":
        g = -np.log(-np.log(u.numpy().astype(np.float64)))
        return torch.from_numpy(np.asarray(g.astype(np.float32)))
    return -torch.log(-torch.log(u))


__all__ = ["PRNGKey", "bernoulli", "bits", "fold_in", "gumbel", "key_data",
           "key_words", "normal", "split", "threefry2x32", "uniform"]
