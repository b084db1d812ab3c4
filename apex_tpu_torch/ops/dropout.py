"""Dropout with jax.random's threefry2x32 bits, forward and backward.

Counterpart of Flax's ``nn.Dropout.__call__`` (``linen/stochastic.py``
of the Flax package), which the reference's GPT and BERT use for their
hidden dropout and, on the softmax attention backend, for the attention
probabilities::

    keep = jax.random.bernoulli(key, 1 - rate, x.shape)
    y = lax.select(keep, x / (1 - rate), zeros_like(x))

The reference computes it in XLA (no ``pallas_call``). On a CUDA tensor
it runs the hand-written kernel of ``csrc/dropout.cu``, which draws the
threefry bits of every element's flat index, compares and selects in
one pass; on a CPU tensor :func:`_dropout_torch`, the plain version
composed from :mod:`apex_tpu_torch.random`. Both give the reference's
output bit for bit on the same key: the mask is ``uniform < keep`` in
fp32, and the division is Flax's, by the keep probability rounded to x's
dtype (bf16: 0.9 becomes 0.8984375), the quotient taken in fp32 and
rounded once to x's dtype.

A call that autograd has to differentiate goes through ``_DropoutFn``:
its backward is the same pass over the gradient, the mask recomputed
from the key (the derivative of ``select(keep, x / c, 0)`` is
``select(keep, g / c, 0)``); nothing is saved. The forward and backward
launches count under ``dropout_fwd`` and ``dropout_bwd``.
"""

from __future__ import annotations

import torch

from apex_tpu_torch import _build
from apex_tpu_torch._backend import check_kernel_input, uses_kernel
from apex_tpu_torch.random import KeyLike, bernoulli, key_words

FWD_KERNEL = "dropout_fwd"
BWD_KERNEL = "dropout_bwd"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _keep_probs(rate: float, dtype: torch.dtype):
    """(the keep probability in fp32, it rounded to ``dtype``), both as
    Python floats."""
    keep = 1.0 - rate
    return (torch.tensor(keep, dtype=torch.float32).item(),
            torch.tensor(keep, dtype=dtype).item())


def _dropout_torch(x: torch.Tensor, key, rate: float) -> torch.Tensor:
    """Plain version: the threefry mask of ``x``'s shape and the
    select, on x's device."""
    keep = bernoulli(key, 1.0 - rate, x.shape, device=x.device)
    # a 0-d tensor on x's device: a CUDA tensor divided by a host number
    # is multiplied by its reciprocal, where the reference divides
    div = torch.full((), _keep_probs(rate, x.dtype)[1], dtype=torch.float32,
                     device=x.device)
    y = (x.float() / div).to(x.dtype)
    return torch.where(keep, y, torch.zeros((), dtype=x.dtype,
                                            device=x.device))


def _dropout_cuda(x: torch.Tensor, key, rate: float,
                  counter: str = FWD_KERNEL) -> torch.Tensor:
    """The kernel: ``x`` (any shape) dropped under ``key``; the launch
    counts under ``counter``."""
    x = x.contiguous()
    check_kernel_input("x", x, tuple(_DTYPE_CODES), x.device)
    k0, k1 = key_words(key)
    keep_p, keep_x = _keep_probs(rate, x.dtype)
    y = torch.empty_like(x)
    P, L, I, U, F = _build.P, _build.L, _build.I, _build.U, _build.F
    lib = _build.library("dropout", "apex_dropout",
                         (P, P, L, I, U, U, F, F, P),
                         "apex_dropout_error_string")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.apex_dropout(x.data_ptr(), y.data_ptr(), x.numel(),
                               _DTYPE_CODES[x.dtype], k0, k1, keep_p,
                               keep_x, stream)
    if err:
        raise RuntimeError(f"{counter}: CUDA error {err} at launch: "
                           f"{lib.apex_dropout_error_string(err).decode()}")
    _build.count_launch(counter)
    return y


class _DropoutFn(torch.autograd.Function):
    """Dropout under autograd: the kernel on CUDA tensors, the plain
    version on CPU tensors, forward and backward alike."""

    @staticmethod
    def forward(ctx, x, key, rate, kernel):
        ctx.args = (key, rate, kernel)
        if kernel:
            return _dropout_cuda(x, key, rate, FWD_KERNEL)
        return _dropout_torch(x, key, rate)

    @staticmethod
    def backward(ctx, g):
        key, rate, kernel = ctx.args
        if kernel:
            return _dropout_cuda(g, key, rate, BWD_KERNEL), None, None, None
        return _dropout_torch(g, key, rate), None, None, None


def _dropout(x: torch.Tensor, rate: float, key: KeyLike,
             kernel: bool) -> torch.Tensor:
    if not 0.0 <= rate <= 1.0:
        raise ValueError(f"dropout rate must be in [0, 1], got {rate}")
    if rate == 0.0:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)       # Flax's edge case
    key = key_words(key)                 # read once, on the host
    if torch.is_grad_enabled() and x.requires_grad:
        return _DropoutFn.apply(x, key, rate, kernel)
    return (_dropout_cuda(x, key, rate) if kernel
            else _dropout_torch(x, key, rate))


def dropout(x: torch.Tensor, rate: float, key: KeyLike) -> torch.Tensor:
    """Flax's ``nn.Dropout(rate)(x, deterministic=False, rng=key)``:
    each element kept with probability ``1 - rate`` (threefry2x32 bits
    of ``key``, a (2,) tensor or pair of uint32 words) and divided by
    it, the others 0. Rate 0 returns ``x``; rate 1 zeros."""
    return _dropout(x, rate, key, uses_kernel(x))


def dropout_plain(x: torch.Tensor, rate: float, key: KeyLike) -> torch.Tensor:
    """:func:`dropout` through the plain version on any device — the
    yardstick the kernel is held against on the card."""
    return _dropout(x, rate, key, False)


__all__ = ["BWD_KERNEL", "FWD_KERNEL", "dropout", "dropout_plain"]
