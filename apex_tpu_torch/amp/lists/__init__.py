"""The shipped op classification.

Counterpart of ``apex_tpu/amp/lists/__init__.py`` (:31-167): the tables
are copied as they are (a test holds them equal), and
:func:`register_defaults` applies them to any module holding functions
of those names through the ``amp.functional`` decorators.
:mod:`apex_tpu_torch.amp.nn_functional` (``amp.F``) is the namespace with
the classification already applied.

- ``COMPUTE_FUNCS`` (fp16 under O1, bf16 under O4): matmuls and
  convolutions, where the tensor cores win and accumulate in fp32;
- ``FP32_FUNCS``: the softmax family, norms, variance-style reductions
  and losses, unsafe in 16 bits;
- ``PROMOTE_FUNCS`` and ``SEQUENCE_CASTS``: mixed float arguments go to
  the widest dtype;
- ``MATCH_INPUT_FUNCS``: left as they are;
- ``BANNED_FUNCS``: ``binary_cross_entropy`` on probabilities.
"""

from __future__ import annotations

import torch

# -- whitelist: run in the policy compute dtype (fp16 for O1, bf16 for
#    O4) -----------------------------------------------------------------
COMPUTE_FUNCS = [
    "linear",
    "dense",
    "conv1d",
    "conv2d",
    "conv3d",
    "conv_transpose2d",
    "matmul",
    "bmm",
    "einsum",
    "dot",
]

# the same ops for bf16
FP16_FUNCS = list(COMPUTE_FUNCS)
BFLOAT16_FUNCS = list(COMPUTE_FUNCS)

# -- blacklist: always computed (and returned) in fp32 -------------------
FP32_FUNCS = [
    # softmax family / exponent-range pointwise
    "softmax",
    "log_softmax",
    "softmin",
    "softplus",
    "gelu",
    "logsumexp",
    # normalization
    "layer_norm",
    "rms_norm",
    "group_norm",
    "batch_norm",
    "normalize",
    "cosine_similarity",
    # variance-style reductions
    "norm",
    "var",
    "std",
    "cumsum",
    "cumprod",
    # losses
    "mse_loss",
    "l1_loss",
    "smooth_l1_loss",
    "nll_loss",
    "cross_entropy",
    "kl_div",
    "poisson_nll_loss",
    "binary_cross_entropy_with_logits",
]

# -- mixed-argument math: cast every float arg to the widest dtype -------
PROMOTE_FUNCS = [
    "add",
    "mul",
    "div",
    "atan2",
]

# sequence-taking variants of the same (ref torch_overrides.py:116-133)
SEQUENCE_CASTS = [
    "cat",
    "stack",
    "concatenate",
]

# -- run in whatever dtype the input already has -------------------------
MATCH_INPUT_FUNCS = [
    "relu",
    "tanh",
    "sigmoid",
    "silu",
]

BANNED_MESSAGE = (
    "amp does not work out-of-the-box with `binary_cross_entropy` on "
    "probabilities: a sigmoid output saturates to exactly 0/1 in 16-bit "
    "and the loss gradient blows up. Use "
    "`binary_cross_entropy_with_logits` (sigmoid fused into the loss, "
    "classified fp32 here), or if you really know what you are doing "
    "pass allow_banned=True to amp.initialize. "
    "(ref: apex/amp/lists/functional_overrides.py:95-107)"
)

BANNED_FUNCS = [("binary_cross_entropy", BANNED_MESSAGE)]


# attribute stamped on every wrapper register_defaults installs, so a
# repeated call (or an alias pair like linear/dense resolving to an
# already-wrapped function) never stacks a second cast wrapper
_WRAPPED_FLAG = "_apex_tpu_torch_amp_wrapped"

_DTYPE_NAMES = {"float16": torch.float16, "half": torch.float16,
                "bfloat16": torch.bfloat16}


def _as_dtype(compute_dtype) -> torch.dtype:
    if isinstance(compute_dtype, torch.dtype):
        return compute_dtype
    name = str(compute_dtype).replace("torch.", "")
    if name not in _DTYPE_NAMES:
        raise ValueError(f"compute_dtype {compute_dtype!r}: expected "
                         "float16 or bfloat16")
    return _DTYPE_NAMES[name]


def register_defaults(module, compute_dtype="float16") -> int:
    """Apply the default classification to ``module`` in place: each
    table name present on ``module`` is rebound through the matching
    ``amp.functional`` decorator (``compute_dtype`` a ``torch.dtype`` or
    its name). A function a previous call wrapped is skipped, so a
    second call never wraps twice. Returns the number of functions newly
    rebound."""
    from apex_tpu_torch.amp import functional as afn

    compute = (afn.bfloat16_function
               if _as_dtype(compute_dtype) == torch.bfloat16
               else afn.half_function)
    n = 0
    for names, deco in (
        (COMPUTE_FUNCS, compute),
        (FP32_FUNCS, afn.float_function),
        (PROMOTE_FUNCS + SEQUENCE_CASTS, afn.promote_function),
    ):
        for name in names:
            fn = getattr(module, name, None)
            if not callable(fn) or getattr(fn, _WRAPPED_FLAG, False):
                continue
            wrapped = deco(fn)
            try:
                setattr(wrapped, _WRAPPED_FLAG, True)
            except (AttributeError, TypeError):
                pass      # a callable that takes no attribute: not marked
            setattr(module, name, wrapped)
            n += 1
    return n


__all__ = [
    "COMPUTE_FUNCS", "FP16_FUNCS", "BFLOAT16_FUNCS", "FP32_FUNCS",
    "PROMOTE_FUNCS", "SEQUENCE_CASTS", "MATCH_INPUT_FUNCS",
    "BANNED_FUNCS", "BANNED_MESSAGE", "register_defaults",
]
