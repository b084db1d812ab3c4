"""``amp.F``: a functional namespace with the shipped op classification
applied.

Counterpart of ``apex_tpu/amp/nn_functional.py``. Every function reads
the active policy (:mod:`apex_tpu_torch.amp._amp_state`, set by
``amp.initialize`` or ``policy_scope``) at each call and applies the
classification of :mod:`apex_tpu_torch.amp.lists`:

- whitelisted ops cast their float inputs to the policy's compute dtype
  (fp16 under O1, bf16 under O4);
- blacklisted ops compute and return fp32;
- promoted ops cast mixed float arguments to the widest float dtype;
- ``binary_cross_entropy`` is banned with guidance.

With no active policy, or under ``amp.disable_casts()``, every wrapper
passes its inputs through, so a model written against ``amp.F`` runs
unchanged in fp32. The functions are plain PyTorch, as the reference's
are plain ``jnp``/``lax``; the hand-written kernels stay in
``apex_tpu_torch.ops`` and ``normalization``.

The reference's names, keywords and defaults are kept: ``axis=`` (not
``dim=``), ``ddof=0`` for ``var`` and ``std``, ``approximate=True``
(tanh) for ``gelu``, ``axis=None`` flattening for ``cumsum``,
``cumprod``, ``norm`` and ``logsumexp``, ``linear`` with an (out, in)
weight, NCHW activations and OIHW weights for the convolutions (padding
an int, a tuple of ints or a list of (lo, hi) pairs), mean reductions for
the losses. Where ``jnp`` promotes mixed float operands (a matmul of fp16
with fp32, or an fp32 0-d tensor beside an fp16 array), these functions
promote the same way (:func:`~apex_tpu_torch.amp.functional.
promote_floats`) before calling PyTorch.
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as _F

from apex_tpu_torch.amp import _amp_state
from apex_tpu_torch.amp.functional import _cast_floats, promote_floats
from apex_tpu_torch.amp.lists import BANNED_MESSAGE


# ---------------------------------------------------------------------------
# classification decorators: the policy-aware forms of amp.functional's
# static-dtype decorators (the cast rule itself lives there); the promoted
# ops promote in their bodies (below)
# ---------------------------------------------------------------------------

def whitelisted(fn):
    """Run in the active compute dtype (a tensor-core op)."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        dt = _amp_state.active_compute_dtype()
        if dt is not None:
            args, kwargs = _cast_floats(args, dt), _cast_floats(kwargs, dt)
        return fn(*args, **kwargs)

    return wrapper


def blacklisted(fn):
    """Compute and return fp32 whenever a patch-style policy is active."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if _amp_state.active_compute_dtype() is not None:
            args = _cast_floats(args, torch.float32)
            kwargs = _cast_floats(kwargs, torch.float32)
        return fn(*args, **kwargs)

    return wrapper


def banned(name: str, message: str):
    def wrapper(*args, **kwargs):
        if (_amp_state.active_compute_dtype() is not None
                and not _amp_state.allow_banned):
            raise RuntimeError(f"amp banned function {name!r}: {message}")
        return _binary_cross_entropy_impl(*args, **kwargs)

    wrapper.__name__ = name
    return wrapper


# ---------------------------------------------------------------------------
# whitelist: tensor-core ops
# ---------------------------------------------------------------------------

@whitelisted
def linear(x, weight, bias=None):
    """y = x @ weight.T (+ bias); weight is (out, in)."""
    x, weight = promote_floats((x, weight))
    y = torch.matmul(x, weight.transpose(-1, -2))
    return y if bias is None else y + bias


dense = linear


@whitelisted
def matmul(a, b):
    return torch.matmul(*promote_floats((a, b)))


@whitelisted
def bmm(a, b):
    return torch.matmul(*promote_floats((a, b)))


@whitelisted
def dot(a, b):
    """``jnp.dot``: a product with a 0-d operand, else a contraction of
    the last axis of ``a`` with the second-to-last of ``b`` (its only
    axis when 1-D), which for N-D operands is not ``torch.matmul``'s
    batched product."""
    a, b = promote_floats((a, b))
    if a.ndim == 0 or b.ndim == 0:
        return a * b
    return torch.tensordot(a, b, dims=([a.ndim - 1], [max(b.ndim - 2, 0)]))


@whitelisted
def einsum(subscripts, *operands):
    return torch.einsum(subscripts, *promote_floats(operands))


def _pairs(padding, nd):
    """``padding`` as nd (lo, hi) pairs: an int, a tuple of ints (one a
    spatial dim) or a list of (lo, hi) pairs."""
    if isinstance(padding, int):
        return [(padding, padding)] * nd
    padding = list(padding)
    if padding and isinstance(padding[0], int):
        return [(p, p) for p in padding]
    return [tuple(p) for p in padding]


def _pad_arg(pairs):
    """``(symmetric ints, None)`` or ``(0, F.pad's list)`` (last spatial
    dim first) for asymmetric or negative pairs (PyTorch's convolutions
    take neither)."""
    if all(lo == hi >= 0 for lo, hi in pairs):
        return tuple(lo for lo, _ in pairs), None
    return 0, [p for lo, hi in reversed(pairs) for p in (lo, hi)]


def _tuple(v, nd):
    return (v,) * nd if isinstance(v, int) else tuple(v)


_CONVS = {1: _F.conv1d, 2: _F.conv2d, 3: _F.conv3d}


def _conv_nd(x, weight, bias, stride, padding, dilation, groups, nd):
    x, weight = promote_floats((x, weight))
    pad, explicit = _pad_arg(_pairs(padding, nd))
    if explicit is not None:
        x = _F.pad(x, explicit)
    y = _CONVS[nd](x, weight, None, _tuple(stride, nd), pad,
                   _tuple(dilation, nd), groups)
    if bias is not None:
        y = y + bias.reshape((1, -1) + (1,) * nd)
    return y


@whitelisted
def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 1)


@whitelisted
def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 2)


@whitelisted
def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 3)


@whitelisted
def conv_transpose2d(x, weight, bias=None, stride=1, padding=0, groups=1):
    """The transposed convolution, weight (in, out, H, W); ``padding``
    (lo, hi) pairs cut (or, negative, zero-pad) the full output."""
    if groups != 1:
        raise NotImplementedError(
            "conv_transpose2d with groups > 1: the gradient-of-conv "
            "formulation needs block-diagonal weight handling; use "
            "groups=1 or a per-group loop")
    x, weight = promote_floats((x, weight))
    pad, explicit = _pad_arg(_pairs(padding, 2))
    y = _F.conv_transpose2d(x, weight, None, _tuple(stride, 2), pad)
    if explicit is not None:
        y = _F.pad(y, [-p for p in explicit])
    if bias is not None:
        y = y + bias.reshape(1, -1, 1, 1)
    return y


# ---------------------------------------------------------------------------
# blacklist: fp32 ops
# ---------------------------------------------------------------------------

@blacklisted
def softmax(x, axis=-1):
    return torch.softmax(x, dim=axis)


@blacklisted
def log_softmax(x, axis=-1):
    return torch.log_softmax(x, dim=axis)


@blacklisted
def softmin(x, axis=-1):
    return torch.softmax(-x, dim=axis)


@blacklisted
def softplus(x):
    # jax.nn.softplus is logaddexp(x, 0): max(x, 0) + log1p(exp(-|x|))
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


@blacklisted
def gelu(x, approximate=True):
    """``jax.nn.gelu``'s formulas and operation order: tanh by default
    (``x * 0.5 (1 + tanh(sqrt(2/pi) (x + 0.044715 x^3)))``), else
    ``0.5 x erfc(-x sqrt(1/2))``."""
    if approximate:
        c = torch.tensor(np.float32(np.sqrt(2 / np.pi)), dtype=x.dtype)
        cdf = 0.5 * (1.0 + torch.tanh(c * (x + 0.044715 * (x * (x * x)))))
        return x * cdf
    half = torch.tensor(np.float32(np.sqrt(0.5)), dtype=x.dtype)
    return 0.5 * x * torch.erfc(-x * half)


@blacklisted
def logsumexp(x, axis=None, keepdims=False):
    if axis is None:
        out = torch.logsumexp(x.reshape(-1), 0)
        return out.reshape((1,) * x.ndim) if keepdims else out
    return torch.logsumexp(x, dim=axis, keepdim=keepdims)


@blacklisted
def layer_norm(x, normalized_shape, weight=None, bias=None, eps=1e-5):
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    axes = tuple(range(x.ndim - len(normalized_shape), x.ndim))
    mu = x.mean(dim=axes, keepdim=True)
    var_ = (x - mu).square().mean(dim=axes, keepdim=True)
    y = (x - mu) * torch.rsqrt(var_ + eps)
    if weight is not None:
        y = y * weight
    if bias is not None:
        y = y + bias
    return y


@blacklisted
def rms_norm(x, weight=None, eps=1e-6):
    y = x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps)
    return y if weight is None else y * weight


@blacklisted
def group_norm(x, num_groups, weight=None, bias=None, eps=1e-5):
    n, c = x.shape[:2]
    g = x.reshape((n, num_groups, c // num_groups) + tuple(x.shape[2:]))
    axes = tuple(range(2, g.ndim))
    mu = g.mean(dim=axes, keepdim=True)
    var_ = (g - mu).square().mean(dim=axes, keepdim=True)
    y = ((g - mu) * torch.rsqrt(var_ + eps)).reshape(x.shape)
    shape = (1, c) + (1,) * (x.ndim - 2)
    if weight is not None:
        y = y * weight.reshape(shape)
    if bias is not None:
        y = y + bias.reshape(shape)
    return y


@blacklisted
def batch_norm(x, running_mean=None, running_var=None, weight=None,
               bias=None, training=False, eps=1e-5):
    """Functional BN that never mutates running statistics:
    ``training=True`` normalises with the batch's mean and biased
    variance, else with the given running statistics."""
    axes = (0,) + tuple(range(2, x.ndim))
    if training or running_mean is None:
        mu = x.mean(dim=axes)
        var_ = x.var(dim=axes, correction=0)
    else:
        mu, var_ = running_mean, running_var
    shape = (1, -1) + (1,) * (x.ndim - 2)
    y = (x - mu.reshape(shape)) * torch.rsqrt(var_.reshape(shape) + eps)
    if weight is not None:
        y = y * weight.reshape(shape)
    if bias is not None:
        y = y + bias.reshape(shape)
    return y


@blacklisted
def normalize(x, p=2, axis=1, eps=1e-12):
    n = torch.linalg.vector_norm(x, ord=p, dim=axis, keepdim=True)
    return x / torch.clamp_min(n, eps)


@blacklisted
def cosine_similarity(x1, x2, axis=1, eps=1e-8):
    """The dot over ``max(n1 n2, eps)``: the product of the norms is
    clamped, where ``F.cosine_similarity`` clamps each norm."""
    n1 = torch.linalg.vector_norm(x1, dim=axis)
    n2 = torch.linalg.vector_norm(x2, dim=axis)
    return (x1 * x2).sum(dim=axis) / torch.clamp_min(n1 * n2, eps)


@blacklisted
def norm(x, ord=None, axis=None):
    """``jnp.linalg.norm``: the 2-norm of the flattened input by default;
    a vector norm along one axis; a matrix norm over two (Frobenius by
    default)."""
    if axis is None and ord is None:
        return torch.linalg.vector_norm(x.reshape(-1))
    if axis is None:
        axis = tuple(range(x.ndim))
    if isinstance(axis, (tuple, list)) and len(axis) == 2:
        return torch.linalg.matrix_norm(
            x, ord="fro" if ord is None else ord, dim=tuple(axis))
    return torch.linalg.vector_norm(x, ord=2 if ord is None else ord,
                                    dim=axis)


@blacklisted
def var(x, axis=None, ddof=0):
    return torch.var(x, dim=axis, correction=ddof)


@blacklisted
def std(x, axis=None, ddof=0):
    return torch.std(x, dim=axis, correction=ddof)


@blacklisted
def cumsum(x, axis=None):
    return torch.cumsum(x.reshape(-1), 0) if axis is None else \
        torch.cumsum(x, axis)


@blacklisted
def cumprod(x, axis=None):
    return torch.cumprod(x.reshape(-1), 0) if axis is None else \
        torch.cumprod(x, axis)


def _reduce(v, reduction):
    if reduction == "mean":
        return v.mean()
    if reduction == "sum":
        return v.sum()
    return v


def _pick(x, target):
    return torch.gather(x, -1, target.long()[..., None])[..., 0]


@blacklisted
def mse_loss(pred, target, reduction="mean"):
    return _reduce((pred - target).square(), reduction)


@blacklisted
def l1_loss(pred, target, reduction="mean"):
    return _reduce((pred - target).abs(), reduction)


@blacklisted
def smooth_l1_loss(pred, target, beta=1.0, reduction="mean"):
    d = (pred - target).abs()
    v = torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)
    return _reduce(v, reduction)


@blacklisted
def nll_loss(log_probs, target, reduction="mean"):
    return _reduce(-_pick(log_probs, target), reduction)


@blacklisted
def cross_entropy(logits, target, reduction="mean"):
    return _reduce(-_pick(torch.log_softmax(logits, dim=-1), target),
                   reduction)


@blacklisted
def kl_div(log_pred, target, reduction="mean"):
    """``target (log(max(target, 1e-38)) - log_pred)``: 0 where the
    target is 0."""
    v = target * (torch.log(torch.clamp_min(target, 1e-38)) - log_pred)
    return _reduce(v, reduction)


@blacklisted
def poisson_nll_loss(log_input, target, reduction="mean"):
    return _reduce(torch.exp(log_input) - target * log_input, reduction)


@blacklisted
def binary_cross_entropy_with_logits(logits, target, reduction="mean"):
    v = (torch.clamp_min(logits, 0) - logits * target
         + torch.log1p(torch.exp(-logits.abs())))
    return _reduce(v, reduction)


def _binary_cross_entropy_impl(probs, target, reduction="mean",
                               eps=1e-12):
    p = torch.clamp(probs, eps, 1.0 - eps)
    v = -(target * torch.log(p) + (1.0 - target) * torch.log1p(-p))
    return _reduce(v, reduction)


binary_cross_entropy = banned("binary_cross_entropy", BANNED_MESSAGE)


# ---------------------------------------------------------------------------
# promote: mixed-dtype math and sequence casts. Each body casts its float
# arguments to the widest float dtype among them (promote_floats), with or
# without a policy, as jnp promotes; the reference's ``promoted`` decorator
# has nothing left to do here and is not kept.
# ---------------------------------------------------------------------------

def add(a, b):
    a, b = promote_floats((a, b))
    return a + b


def mul(a, b):
    a, b = promote_floats((a, b))
    return a * b


def div(a, b):
    a, b = promote_floats((a, b))
    return a / b


def atan2(a, b):
    a, b = promote_floats((a, b))
    # a Python number takes the tensor's dtype (weakly typed, as in jnp)
    t = a if isinstance(a, torch.Tensor) else b
    a, b = (x if isinstance(x, torch.Tensor) else
            torch.as_tensor(x, dtype=t.dtype, device=t.device)
            for x in (a, b))
    return torch.atan2(a, b)


def cat(arrays: Sequence, axis=0):
    return torch.cat(promote_floats(list(arrays)), dim=axis)


concatenate = cat


def stack(arrays: Sequence, axis=0):
    return torch.stack(promote_floats(list(arrays)), dim=axis)


# ---------------------------------------------------------------------------
# match-input: dtype-preserving activations, deliberately unwrapped
# ---------------------------------------------------------------------------

def relu(x):
    return torch.relu(x)


def tanh(x):
    return torch.tanh(x)


def sigmoid(x):
    return torch.sigmoid(x)


def silu(x):
    return _F.silu(x)

