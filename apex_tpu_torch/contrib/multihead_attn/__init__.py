"""Multi-head attention modules (counterpart of
``apex_tpu/contrib/multihead_attn``, itself the counterpart of the
reference's ``apex.contrib.multihead_attn``).

``SelfMultiheadAttn`` and ``EncdecMultiheadAttn`` over (seq, batch,
hidden), with the reference's fields and parameter names: the
projections ``qkv_proj`` (or ``q_proj``, ``k_proj``, ``v_proj`` with
``separate_qkv_params``) / ``q_proj`` and ``kv_proj``, then ``out_proj``
(``nn.Linear``: weight (out, in), fp32, computed in ``dtype`` as Flax's
``Dense(dtype=...)`` does), and with ``include_norm_add`` the
pre-LayerNorm ``lyr_nrm`` and the residual add. The attention core is
``flash_attention`` (``impl="fast"`` or ``"interpret"``: the flash
kernels on CUDA tensors) or ``attention_plain`` (``impl="default"``,
the reference's score-materialising path). Masks map as the reference's
``_core`` (:56-85) does:

- a bool ``key_padding_mask`` (b, sk), True where masked, becomes kv
  segment ids;
- with ``mask_additive`` the key-padding mask is already additive and
  becomes a (b, 1, 1, sk) bias;
- a bool ``attn_mask`` (sq, sk) becomes -10000 / 0, a (1, 1, sq, sk)
  bias (a float one is taken as it is); given both, the biases sum.

Dropout draws its key as Flax's ``self.make_rng("dropout")`` of the
module applied at the top level: ``forward(..., dropout_key=key)`` with
the key of ``apply(..., rngs={"dropout": key})``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch._backend import DeviceLike, resolve_device
from apex_tpu_torch.models._rng import make_rng
from apex_tpu_torch.normalization import FusedLayerNorm
from apex_tpu_torch.ops.attention import attention_plain, flash_attention

_IMPL = {"fast": flash_attention, "interpret": flash_attention,
         "default": attention_plain}


def _attn_impl(impl: str):
    if impl not in _IMPL:
        raise ValueError(f"impl={impl!r}; expected one of {sorted(_IMPL)}")
    return _IMPL[impl]


class _MHABase(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 bias: bool = False, include_norm_add: bool = False,
                 impl: str = "fast", mask_additive: bool = False,
                 dtype: torch.dtype = torch.float32, *,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        _attn_impl(impl)
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.dropout = dropout
        self.bias = bias
        self.include_norm_add = include_norm_add
        self.impl = impl
        self.mask_additive = mask_additive
        self.dtype = dtype
        self._device = resolve_device(device)
        self._generator = generator
        if include_norm_add:
            self.lyr_nrm = FusedLayerNorm(embed_dim, device=self._device)

    def _linear(self, in_features: int, out_features: int) -> nn.Linear:
        """A projection with fp32 parameters: weight drawn from the
        generator on the CPU with std in_features^-1/2 (the reference's
        LeCun-normal scale), bias zero."""
        lin = nn.Linear(in_features, out_features, bias=self.bias,
                        device="meta")
        w = torch.empty(out_features, in_features).normal_(
            0.0, in_features ** -0.5, generator=self._generator)
        lin.weight = nn.Parameter(w.to(self._device))
        if self.bias:
            lin.bias = nn.Parameter(torch.zeros(out_features,
                                                device=self._device))
        return lin

    def _dense(self, lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        """Flax's ``Dense(dtype=self.dtype)``: input, kernel and bias cast
        to ``dtype``, the product in ``dtype``."""
        b = None if lin.bias is None else lin.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), lin.weight.to(self.dtype), b)

    def _split_heads(self, x: torch.Tensor) -> torch.Tensor:
        # (s, b, h*d) -> (b, heads, s, d)
        s, b, _ = x.shape
        d = self.embed_dim // self.num_heads
        return x.reshape(s, b, self.num_heads, d).permute(1, 2, 0, 3) \
            .contiguous()

    @staticmethod
    def _merge_heads(x: torch.Tensor) -> torch.Tensor:
        # (b, heads, s, d) -> (s, b, h*d)
        b, nh, s, d = x.shape
        return x.permute(2, 0, 1, 3).reshape(s, b, nh * d)

    def _core(self, q, k, v, key_padding_mask, attn_mask, deterministic,
              dropout_key):
        scale = (self.embed_dim // self.num_heads) ** -0.5
        bias = kv_seg = None
        if key_padding_mask is not None:
            if self.mask_additive:
                bias = key_padding_mask[:, None, None, :].float()
            else:
                kv_seg = key_padding_mask.to(torch.int32)
        if attn_mask is not None:
            am = attn_mask.float()
            if attn_mask.dtype == torch.bool:
                am = torch.where(attn_mask, -10000.0, 0.0)
            bias = am[None, None] if bias is None else bias + am[None, None]
        rate = 0.0 if deterministic else self.dropout
        rng = None
        if rate > 0.0:
            if dropout_key is None:
                raise ValueError("dropout > 0 in training needs dropout_key")
            rng = make_rng(dropout_key, ())
        return _attn_impl(self.impl)(
            q, k, v, bias=bias, kv_segment_ids=kv_seg, softmax_scale=scale,
            dropout_rate=rate, dropout_rng=rng)


class SelfMultiheadAttn(_MHABase):
    """Self attention over (seq, batch, hidden) (the reference's
    ``self_multihead_attn.py``)."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 bias: bool = False, include_norm_add: bool = False,
                 impl: str = "fast", separate_qkv_params: bool = False,
                 mask_additive: bool = False,
                 dtype: torch.dtype = torch.float32, *,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(embed_dim, num_heads, dropout, bias,
                         include_norm_add, impl, mask_additive, dtype,
                         device=device, generator=generator)
        self.separate_qkv_params = separate_qkv_params
        e = embed_dim
        if separate_qkv_params:
            self.q_proj = self._linear(e, e)
            self.k_proj = self._linear(e, e)
            self.v_proj = self._linear(e, e)
        else:
            self.qkv_proj = self._linear(e, 3 * e)
        self.out_proj = self._linear(e, e)

    def forward(self, query, key_padding_mask=None, attn_mask=None, *,
                is_training: bool = True, dropout_key=None):
        x = self.lyr_nrm(query) if self.include_norm_add else query
        if self.separate_qkv_params:
            q, k, v = (self._dense(p, x)
                       for p in (self.q_proj, self.k_proj, self.v_proj))
        else:
            q, k, v = self._dense(self.qkv_proj, x).chunk(3, dim=-1)
        out = self._core(self._split_heads(q), self._split_heads(k),
                         self._split_heads(v), key_padding_mask, attn_mask,
                         not is_training, dropout_key)
        out = self._dense(self.out_proj, self._merge_heads(out))
        if self.include_norm_add:
            out = out + query
        return out, None


class EncdecMultiheadAttn(_MHABase):
    """Encoder-decoder attention: Q from the decoder stream, K and V from
    the encoder stream (the reference's ``encdec_multihead_attn.py``)."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 bias: bool = False, include_norm_add: bool = False,
                 impl: str = "fast", mask_additive: bool = False,
                 dtype: torch.dtype = torch.float32, *,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(embed_dim, num_heads, dropout, bias,
                         include_norm_add, impl, mask_additive, dtype,
                         device=device, generator=generator)
        self.q_proj = self._linear(embed_dim, embed_dim)
        self.kv_proj = self._linear(embed_dim, 2 * embed_dim)
        self.out_proj = self._linear(embed_dim, embed_dim)

    def forward(self, query, key, key_padding_mask=None, attn_mask=None, *,
                is_training: bool = True, dropout_key=None):
        x = self.lyr_nrm(query) if self.include_norm_add else query
        q = self._dense(self.q_proj, x)
        k, v = self._dense(self.kv_proj, key).chunk(2, dim=-1)
        out = self._core(self._split_heads(q), self._split_heads(k),
                         self._split_heads(v), key_padding_mask, attn_mask,
                         not is_training, dropout_key)
        out = self._dense(self.out_proj, self._merge_heads(out))
        if self.include_norm_add:
            out = out + query
        return out, None


__all__ = ["EncdecMultiheadAttn", "SelfMultiheadAttn"]
