"""Megatron-style encoder-decoder LM (T5), the zoo's third model family.

Counterpart of ``apex_tpu/models/t5.py`` (:46-352) at tp=1: a shared word
embedding and position table, a bidirectional pre-LN encoder under the
padding mask, a pre-LN decoder with causal self attention and cross
attention into the encoder's output, the tied LM head and the masked-mean
cross entropy. What the port keeps exactly, because the tests hold it
against the reference on converted weights:

- activations in the ``(s, b, h)`` layout; ``forward(enc_tokens (b,
  s_enc), enc_mask (b, s_enc) keep-mask, dec_tokens (b, s_dec))`` returns
  fp32 logits ``(s_dec, b, vocab)``;
- the embedding rows cast to the compute dtype and ``pos[:s]`` added in
  that dtype; the decoder reuses the same word and position tables
  (:299, :313);
- self attention's fused ``qkv`` split per head as ``[q | k | v]``
  (:126-127); cross attention's separate ``q`` and ``kv``, ``kv`` split
  per head as ``[k | v]`` (:132-144);
- the softmax backend (the default, :169-175): fp32 scores divided by
  sqrt(d), cast to the compute dtype, the fused softmax at scale 1 —
  the masked one over the encoder's outer-product mask and over the
  cross mask, which masks keys only ((b, 1, 1, s_enc), broadcast over
  the decoder's queries where the reference repeats it), the causal one
  in the decoder's self attention;
- the flash backend (:146-162): the encoder's raw keep-mask as segment
  ids on both sides; cross attention with ``kv_segment_ids = 1 - mask``
  (real keys in segment 0, every query in segment 0: the kernels'
  key-side mode); the decoder's self attention causal with no mask;
- tanh GELU (:199) and the tied head in fp32, ``y.float() @
  table.float().T`` (:335-337), a plain product outside any kernel.

Layers are a Python loop over ``nn.ModuleList``s; the reference's
``scan_layers`` is a parameter layout, which ``convert.py`` reads either
way. ``t5_param_specs`` (tensor parallel) waits for the mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch._backend import DeviceLike, resolve_device
from apex_tpu_torch.models._flash_bridge import flash_sbhd
from apex_tpu_torch.models.bert import bert_extended_attention_mask
from apex_tpu_torch.models.gpt import KERNEL_OPS, PLAIN_OPS, _norm, _Ops
from apex_tpu_torch.models.gpt import _names, param_spec, softmax_attention
from apex_tpu_torch.normalization import FusedLayerNorm
from apex_tpu_torch.ops.xentropy import logsumexp_diff
from apex_tpu_torch.transformer.enums import AttnMaskType, AttnType
from apex_tpu_torch.transformer.tensor_parallel import (
    ColumnParallelLinear,
    RowParallelLinear,
    VocabParallelEmbedding,
    tensor_axis,
)


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    max_seq_len: int = 512
    hidden_size: int = 768
    num_encoder_layers: int = 12
    num_decoder_layers: int = 12
    num_heads: int = 12
    ffn_hidden_size: Optional[int] = None   # default 4*hidden
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    # "softmax": materialised scores and the fused masked softmax (the
    # reference fixture's path); "flash": the flash kernels — encoder
    # padding as segment ids, decoder causal, cross attention through
    # key-side-only segment masking
    attention_backend: str = "softmax"

    def __post_init__(self):
        if self.attention_backend not in ("softmax", "flash"):
            raise ValueError(
                f"attention_backend must be 'softmax' or 'flash', got "
                f"{self.attention_backend!r}")

    @property
    def ffn(self) -> int:
        return self.ffn_hidden_size or 4 * self.hidden_size

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def encoder_decoder_stage_layout(
    num_encoder_layers: int,
    num_decoder_layers: int,
    pipeline_size: int,
    split_rank: int,
) -> Tuple[Tuple[str, int], ...]:
    """Per-stage (kind, n_layers) of an encoder-decoder pipeline (the
    reference's :78-99, host-only): the encoder on stages [0, split_rank),
    the decoder on [split_rank, pipeline_size)."""
    if not (0 < split_rank < pipeline_size):
        raise ValueError(
            f"split_rank {split_rank} must be inside (0, {pipeline_size})")
    if num_encoder_layers % split_rank:
        raise ValueError("encoder layers must divide encoder stages")
    if num_decoder_layers % (pipeline_size - split_rank):
        raise ValueError("decoder layers must divide decoder stages")
    enc_per = num_encoder_layers // split_rank
    dec_per = num_decoder_layers // (pipeline_size - split_rank)
    return tuple(
        ("encoder", enc_per) if s < split_rank else ("decoder", dec_per)
        for s in range(pipeline_size))


def _linear(cfg: T5Config, n_in: int, n_out: int, cls=ColumnParallelLinear):
    return cls(n_in, n_out, dtype=cfg.dtype, param_dtype=cfg.param_dtype,
               device="cpu")


class _Attention(nn.Module):
    """Self or cross attention (the reference's ``_Attention``, :102-186):
    projections, the softmax or flash backend, the output projection."""

    def __init__(self, config: T5Config, attn_type: AttnType,
                 mask_type: AttnMaskType):
        super().__init__()
        cfg = config
        h = cfg.hidden_size
        self.config = cfg
        self.attn_type = attn_type
        self.mask_type = mask_type
        if attn_type == AttnType.self_attn:
            self.qkv = _linear(cfg, h, 3 * h)
        else:
            self.q = _linear(cfg, h, h)
            self.kv = _linear(cfg, h, 2 * h)
        self.proj = _linear(cfg, h, h, RowParallelLinear)

    def forward(self, x, kv_source=None, mask=None,
                ops: _Ops = KERNEL_OPS):
        """``mask``: on the softmax backend the boolean mask (b, 1, sq or
        1, sk), True masking out; on the flash backend the raw (b, sk)
        keep-mask; None for the causal decoder."""
        cfg = self.config
        heads, hd = cfg.num_heads, cfg.head_dim
        if self.attn_type == AttnType.self_attn:
            qkv = self.qkv(x)
            sq, b = qkv.shape[0], qkv.shape[1]
            q, k, v = torch.split(qkv.reshape(sq, b, heads, 3 * hd), hd,
                                  dim=-1)
        else:
            q = self.q(x)
            kv = self.kv(kv_source)
            sq, b, sk = q.shape[0], q.shape[1], kv.shape[0]
            q = q.reshape(sq, b, heads, hd)
            k, v = torch.split(kv.reshape(sk, b, heads, 2 * hd), hd, dim=-1)
        causal = self.mask_type == AttnMaskType.causal
        if cfg.attention_backend == "flash":
            kwargs = {}
            if not causal and mask is not None:
                seg = mask.to(torch.int32)
                if self.attn_type == AttnType.self_attn:
                    kwargs["segment_ids"] = seg
                else:
                    kwargs["kv_segment_ids"] = 1 - seg
            ctx = flash_sbhd(q, k, v, attention=ops.attention, causal=causal,
                             **kwargs)
        else:
            ctx = softmax_attention(q, k, v, None if causal else mask,
                                    causal, cfg.dtype, ops)
            ctx = ctx.permute(2, 0, 1, 3).reshape(sq, b, cfg.hidden_size)
        return self.proj(ctx)


class _MLP(nn.Module):
    """fc1, tanh GELU (:199), fc2."""

    def __init__(self, config: T5Config):
        super().__init__()
        self.fc1 = _linear(config, config.hidden_size, config.ffn)
        self.fc2 = _linear(config, config.ffn, config.hidden_size,
                           RowParallelLinear)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


def _layer_norm(config: T5Config) -> FusedLayerNorm:
    return FusedLayerNorm(config.hidden_size, device="cpu",
                          dtype=torch.float32)


class EncoderLayer(nn.Module):
    """Pre-LN: bidirectional self attention under the padding mask, then
    the MLP (:228-240)."""

    def __init__(self, config: T5Config):
        super().__init__()
        self.input_norm = _layer_norm(config)
        self.self_attention = _Attention(config, AttnType.self_attn,
                                         AttnMaskType.padding)
        self.post_norm = _layer_norm(config)
        self.mlp = _MLP(config)

    def forward(self, x, enc_mask, ops: _Ops = KERNEL_OPS):
        x = x + self.self_attention(_norm(ops, self.input_norm, x),
                                    mask=enc_mask, ops=ops)
        return x + self.mlp(_norm(ops, self.post_norm, x))


class DecoderLayer(nn.Module):
    """Pre-LN: causal self attention, cross attention into the encoder's
    output, then the MLP (:243-264)."""

    def __init__(self, config: T5Config):
        super().__init__()
        self.input_norm = _layer_norm(config)
        self.self_attention = _Attention(config, AttnType.self_attn,
                                         AttnMaskType.causal)
        self.post_attn_norm = _layer_norm(config)
        self.inter_attention = _Attention(config, AttnType.cross_attn,
                                          AttnMaskType.padding)
        self.post_norm = _layer_norm(config)
        self.mlp = _MLP(config)

    def forward(self, x, enc_out, cross_mask, ops: _Ops = KERNEL_OPS):
        x = x + self.self_attention(_norm(ops, self.input_norm, x), ops=ops)
        x = x + self.inter_attention(_norm(ops, self.post_attn_norm, x),
                                     kv_source=enc_out, mask=cross_mask,
                                     ops=ops)
        return x + self.mlp(_norm(ops, self.post_norm, x))


class T5Model(nn.Module):
    """Encoder-decoder LM. ``forward(enc_tokens (b, s_enc), enc_mask (b,
    s_enc) keep-mask, dec_tokens (b, s_dec))`` returns fp32 logits
    ``(s_dec, b, vocab)``.

    Parameters are made on the CPU from ``generator`` (a
    ``torch.Generator``; the default generator when None) and then moved
    to ``device`` — CUDA unless the caller names another."""

    def __init__(self, config: T5Config, *, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if tensor_axis().size > 1:
            raise NotImplementedError(
                "T5's tensor-parallel forward is not ported yet "
                "(ROADMAP A 11); build it outside a tensor axis of more than "
                "one rank")
        dev = resolve_device(device)
        cfg = config
        h = cfg.hidden_size
        self.config = cfg
        self.embedding = VocabParallelEmbedding(
            cfg.vocab_size, h, dtype=cfg.dtype, param_dtype=cfg.param_dtype,
            device="cpu")
        self.position_embedding = nn.Parameter(torch.empty(
            (cfg.max_seq_len, h), dtype=cfg.param_dtype))
        self.encoder_layers = nn.ModuleList(
            [EncoderLayer(cfg) for _ in range(cfg.num_encoder_layers)])
        self.encoder_norm = _layer_norm(cfg)
        self.decoder_layers = nn.ModuleList(
            [DecoderLayer(cfg) for _ in range(cfg.num_decoder_layers)])
        self.decoder_norm = _layer_norm(cfg)
        with torch.no_grad():
            for name, p in self.named_parameters():
                if "norm." in name or name.endswith("bias"):
                    continue                      # ones and zeros
                # the (out, in) linears with variance 1 / fan_in; the
                # word and position tables N(0, 0.02)
                std = (p.shape[-1] ** -0.5 if name.startswith(
                    ("encoder_layers.", "decoder_layers.")) else 0.02)
                p.normal_(0.0, std, generator=generator)
        self.to(dev)

    def forward(self, enc_tokens, enc_mask, dec_tokens) -> torch.Tensor:
        return self._forward(enc_tokens, enc_mask, dec_tokens, KERNEL_OPS)

    def forward_plain(self, enc_tokens, enc_mask, dec_tokens
                      ) -> torch.Tensor:
        """:meth:`forward` through the plain PyTorch versions of the
        kernels on any device — the yardstick the kernel path is held
        against on the card."""
        return self._forward(enc_tokens, enc_mask, dec_tokens, PLAIN_OPS)

    def _embed(self, tokens):
        x = self.embedding(tokens)                         # (b, s, h)
        pos = self.position_embedding[:tokens.shape[1]]
        return (x + pos[None].to(self.config.dtype)).transpose(0, 1)

    def _forward(self, enc_tokens, enc_mask, dec_tokens, ops: _Ops):
        cfg = self.config
        dev = self.embedding.weight.device
        enc_tokens = torch.as_tensor(enc_tokens, device=dev).long()
        dec_tokens = torch.as_tensor(dec_tokens, device=dev).long()
        enc_mask = torch.as_tensor(enc_mask, device=dev)
        if cfg.attention_backend == "flash":
            # the kernels take the raw keep-mask
            enc_attn_mask = cross_mask = enc_mask
        else:
            # (b, 1, sq, sk) and (b, 1, 1, s_enc), True = masked
            enc_attn_mask = bert_extended_attention_mask(enc_mask)
            cross_mask = (enc_mask.float() < 0.5)[:, None, None, :]
        x = self._embed(enc_tokens)
        for layer in self.encoder_layers:
            x = layer(x, enc_attn_mask, ops)
        enc_out = _norm(ops, self.encoder_norm, x)
        y = self._embed(dec_tokens)
        for layer in self.decoder_layers:
            y = layer(y, enc_out, cross_mask, ops)
        y = _norm(ops, self.decoder_norm, y)
        # the tied LM head, in fp32
        return torch.matmul(y.float(), self.embedding.weight.float().t())


def t5_loss_fn(logits: torch.Tensor, labels: torch.Tensor,
               loss_mask: torch.Tensor) -> torch.Tensor:
    """Masked mean cross entropy over the decoder tokens (the reference's
    ``t5_loss_fn`` :340-352 outside a tensor-parallel axis): ``logits``
    (s_dec, b, vocab) fp32; ``labels``, ``loss_mask`` (b, s_dec)."""
    labels_sb = labels.transpose(0, 1).long()
    tgt = torch.gather(logits, -1, labels_sb[..., None])[..., 0]
    mask_sb = loss_mask.transpose(0, 1).float()
    return (torch.sum((logsumexp_diff(logits) - tgt) * mask_sb)
            / torch.clamp(torch.sum(mask_sb), min=1.0))


def t5_pretrain_loss(model: T5Model, enc_tokens, enc_mask, dec_tokens,
                     labels, loss_mask) -> torch.Tensor:
    """The loss of one batch for ``PretrainStep(model, opt,
    loss_fn=t5_pretrain_loss)``: ``step(state, enc_tokens, enc_mask,
    dec_tokens, labels, loss_mask)``."""
    return t5_loss_fn(model(enc_tokens, enc_mask, dec_tokens), labels,
                      loss_mask)


def t5_param_specs(params) -> Dict[str, tuple]:
    """Each T5 parameter's layout, by name (the reference's
    ``t5_param_specs`` :355): ``gpt_param_specs``' rules plus the cross
    attention's ``q`` and ``kv`` columns."""
    return {n: param_spec(n, column=("qkv", "fc1", "q", "kv"))
            for n in _names(params)}


__all__ = ["DecoderLayer", "EncoderLayer", "T5Config", "T5Model",
           "encoder_decoder_stage_layout", "t5_loss_fn", "t5_param_specs",
           "t5_pretrain_loss"]
