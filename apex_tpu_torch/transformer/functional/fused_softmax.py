"""FusedScaleMaskSoftmax, the softmax dispatcher of attention.

Counterpart of ``apex_tpu/transformer/functional/fused_softmax.py``
(:26-88). With fusion on (the default), a causal mask type goes to
:func:`scaled_upper_triang_masked_softmax` over (b * np, sq, sk), a
padding mask to :func:`scaled_masked_softmax`, and a call without a mask
to :func:`scaled_softmax`: the kernels of ``ops/softmax.py`` on a CUDA
tensor, their plain versions on a CPU tensor. With
``scaled_masked_softmax_fusion=False`` it runs the reference's unfused
path in PyTorch ops, which *replaces* masked scores by -10000 (or calls
``mask_func``) where the fused kernels add -10000: the two differ on a
row whose keys are all masked, as they do in the reference.
"""

from __future__ import annotations

import enum
from typing import Callable, Optional

import torch

from apex_tpu_torch.ops.softmax import (
    MASK_FILL,
    scaled_masked_softmax,
    scaled_softmax,
    scaled_upper_triang_masked_softmax,
)


class AttnMaskType(enum.Enum):
    """The reference's ``AttnMaskType`` (its own copy: the port imports
    nothing of the JAX package)."""

    padding = 1
    causal = 2


class FusedScaleMaskSoftmax:
    """Softmax over (b, np, sq, sk) attention scores; ``mask`` is
    boolean, True masking out (a padding mask), or None."""

    def __init__(self, input_in_fp16: bool = False,
                 input_in_bf16: bool = False,
                 attn_mask_type: AttnMaskType = AttnMaskType.padding,
                 scaled_masked_softmax_fusion: bool = True,
                 mask_func: Optional[Callable] = None,
                 softmax_in_fp32: bool = True,
                 scale: Optional[float] = None):
        self.input_in_float16 = input_in_fp16 or input_in_bf16
        self.attn_mask_type = attn_mask_type
        self.scaled_masked_softmax_fusion = scaled_masked_softmax_fusion
        self.mask_func = mask_func
        self.softmax_in_fp32 = softmax_in_fp32
        self.scale = scale
        if scale is not None and not softmax_in_fp32:
            raise ValueError("softmax should be in fp32 when scaled")

    def is_kernel_available(self, mask, b, np_, sq, sk) -> bool:
        """The kernels take any shape (the reference's CUDA limits on sk
        do not bind), so only the fusion switch decides."""
        return self.scaled_masked_softmax_fusion and sk >= 1

    def __call__(self, inp: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if inp.ndim != 4:
            raise ValueError(f"expected (b, np, sq, sk) scores, got "
                             f"{tuple(inp.shape)}")
        b, np_, sq, sk = inp.shape
        scale = self.scale if self.scale is not None else 1.0
        if self.is_kernel_available(mask, b, np_, sq, sk):
            if self.attn_mask_type == AttnMaskType.causal:
                out = scaled_upper_triang_masked_softmax(
                    inp.reshape(-1, sq, sk), scale)
                return out.reshape(b, np_, sq, sk)
            if mask is not None:
                return scaled_masked_softmax(inp, mask, scale)
            return scaled_softmax(inp, scale)
        # unfused path (the reference's :79-88)
        x = inp.float() if self.softmax_in_fp32 else inp
        x = x * scale
        if self.mask_func is not None and mask is not None:
            x = self.mask_func(x, mask)
        elif mask is not None:
            x = torch.where(mask, MASK_FILL, x)
        out = torch.exp(x - torch.amax(x, dim=-1, keepdim=True))
        out = out / torch.sum(out, dim=-1, keepdim=True)
        return out.to(inp.dtype)


__all__ = ["AttnMaskType", "FusedScaleMaskSoftmax"]
