"""Megatron-style BERT for pretraining.

Counterpart of ``apex_tpu/models/bert.py`` (:36-378) at tp=1, without
sequence parallelism: word + position + tokentype embeddings, L pre-LN
blocks [LayerNorm, fused-QKV bidirectional attention under the padding
mask, LayerNorm, GELU MLP], a final LayerNorm, the pooler and binary
(NSP) head, and the MLM head tied to the word embedding. What the port
keeps exactly, because the tests hold it against the reference on
converted weights:

- activations in the ``(s, b, h)`` layout; ``forward`` returns
  ``(lm_logits (s, b, vocab) fp32, binary_logits (b, 2) fp32 or None)``;
- the fused QKV output split per head as ``[q | k | v]`` (:111-112);
- the embedding rows cast to the compute dtype, then the position and
  tokentype embeddings added in that dtype;
- two weight layouts: the tensor-parallel linears (``qkv``, ``proj``,
  ``fc1``, ``fc2``) keep ``(out, in)``; the pooler, the LM head's dense
  and the binary head are ``x @ w`` with ``w`` stored ``(in, out)``
  (:205-209, :223-227, :336-343), as the converter hands them over;
- ``fc1`` and ``fc2`` directly under the layer (no ``mlp``), and the LM
  head's ``dense_bias`` beside its vocab ``bias``;
- both attention backends. ``"softmax"`` (the default, the reference
  fixture's path) runs the masked fused softmax over the outer-product
  mask :func:`bert_extended_attention_mask`, which *adds* -10000 to
  masked scores, so a pad query row (all keys masked) is the softmax of
  its shifted scores. ``"flash"`` hands the raw (b, s) keep-mask to the
  flash kernel as segment ids: real queries see real keys and pads see
  pads. Real rows agree under both; pad rows differ and stay out of the
  loss and the pooler.

Dropout follows GPT's (``forward(..., deterministic=False,
dropout_key=key)``): the attention probabilities dropped in the flash
kernel or, on the softmax backend, through ``ops/dropout.py``; the hidden
dropout after the attention projection and after ``fc2``, with the keys
Flax gives each scope (``_rng.py``). ``bert_param_specs`` waits for the
mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch._backend import DeviceLike, resolve_device
from apex_tpu_torch.models._rng import LayerKeys
from apex_tpu_torch.models.gpt import (
    KERNEL_OPS,
    PLAIN_OPS,
    _dropout_keys,
    _hidden_dropout,
    _norm,
    _names,
    _Ops,
    param_spec,
    softmax_attention,
)
from apex_tpu_torch.normalization import FusedLayerNorm
from apex_tpu_torch.transformer.tensor_parallel import (
    ColumnParallelLinear,
    RowParallelLinear,
    VocabParallelEmbedding,
    tensor_axis,
)


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30528
    max_seq_len: int = 512
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    ffn_hidden_size: Optional[int] = None   # default 4*hidden
    num_tokentypes: int = 2
    add_binary_head: bool = True
    dtype: torch.dtype = torch.bfloat16
    # the linears' and embeddings' parameters; the LayerNorms' stay fp32
    # as the reference's (its FusedLayerNorm takes no param_dtype): a bf16
    # master casts the whole model (``model.bfloat16()``)
    param_dtype: torch.dtype = torch.float32
    attention_backend: str = "softmax"
    attention_dropout: float = 0.0
    hidden_dropout: float = 0.0
    layernorm_epsilon: float = 1e-5
    # the reference's layer scan: here only the layout of the dropout keys
    scan_layers: bool = True

    def __post_init__(self):
        if self.attention_backend not in ("softmax", "flash"):
            raise ValueError(
                f"attention_backend must be 'softmax' or 'flash', got "
                f"{self.attention_backend!r}")
        for name in ("attention_dropout", "hidden_dropout"):
            if not 0.0 <= getattr(self, name) < 1.0:
                raise ValueError(f"{name} must be in [0, 1), got "
                                 f"{getattr(self, name)}")
        if self.hidden_size % self.num_heads:
            raise ValueError("num_heads must divide hidden_size")

    @property
    def ffn(self) -> int:
        return self.ffn_hidden_size or 4 * self.hidden_size

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    # BERT-large (the reference's BertConfig.bert_large)
    @staticmethod
    def bert_large(**kw) -> "BertConfig":
        return BertConfig(hidden_size=1024, num_layers=24, num_heads=16,
                          max_seq_len=512, **kw)


def bert_extended_attention_mask(attention_mask: torch.Tensor
                                 ) -> torch.Tensor:
    """(b, s) {0, 1} keep-mask -> (b, 1, s, s) boolean, True = masked:
    the outer product of the query and key keep vectors, inverted."""
    m = attention_mask.float()
    bss = m[:, None, :] * m[:, :, None]
    return (bss < 0.5)[:, None, :, :]


def _dense_in_out(x, w, b, dtype):
    """``x @ w + b`` with ``w`` stored (in, out), in ``dtype``."""
    return torch.matmul(x.to(dtype), w.to(dtype)) + b.to(dtype)


class BertParallelAttention(nn.Module):
    """Bidirectional self attention under the padding mask: fused QKV,
    softmax or flash attention, output projection."""

    def __init__(self, config: BertConfig, *, device: DeviceLike = None):
        super().__init__()
        cfg = config
        self.config = cfg
        self.qkv = ColumnParallelLinear(
            cfg.hidden_size, 3 * cfg.hidden_size, dtype=cfg.dtype,
            param_dtype=cfg.param_dtype, device=device)
        self.proj = RowParallelLinear(
            cfg.hidden_size, cfg.hidden_size, dtype=cfg.dtype,
            param_dtype=cfg.param_dtype, device=device)

    def forward(self, x, mask, ops: _Ops = KERNEL_OPS,
                keys: Optional[LayerKeys] = None):
        """``mask``: the (b, 1, s, s) boolean mask (softmax backend) or
        the raw (b, s) keep-mask (flash backend); ``keys``: the layer's
        dropout keys (None: deterministic)."""
        cfg = self.config
        hd = cfg.head_dim
        rate = cfg.attention_dropout if keys is not None else 0.0
        qkv = self.qkv(x)
        s, b = qkv.shape[0], qkv.shape[1]
        q, k, v = torch.split(qkv.reshape(s, b, cfg.num_heads, 3 * hd), hd,
                              dim=-1)
        if cfg.attention_backend == "flash":
            qb, kb, vb = (t.permute(1, 2, 0, 3).contiguous()
                          for t in (q, k, v))
            ctx = ops.attention(qb, kb, vb,
                                segment_ids=mask.to(torch.int32),
                                dropout_rate=rate,
                                dropout_rng=keys.attention if rate else None)
        else:
            ctx = softmax_attention(q, k, v, mask, False, cfg.dtype, ops,
                                    (rate, keys.attention) if rate else None)
        ctx = ctx.permute(2, 0, 1, 3).reshape(s, b, cfg.hidden_size)
        return self.proj(ctx)


class BertLayer(nn.Module):
    """Pre-LN transformer block with padding-mask attention."""

    def __init__(self, config: BertConfig, *, device: DeviceLike = None):
        super().__init__()
        cfg = config
        h = cfg.hidden_size
        eps = cfg.layernorm_epsilon
        self.input_norm = FusedLayerNorm(h, eps, device=device,
                                         dtype=torch.float32)
        self.attention = BertParallelAttention(cfg, device=device)
        self.post_norm = FusedLayerNorm(h, eps, device=device,
                                        dtype=torch.float32)
        self.fc1 = ColumnParallelLinear(h, cfg.ffn, dtype=cfg.dtype,
                                        param_dtype=cfg.param_dtype,
                                        device=device)
        self.fc2 = RowParallelLinear(cfg.ffn, h, dtype=cfg.dtype,
                                     param_dtype=cfg.param_dtype,
                                     device=device)

    def forward(self, x, mask, ops: _Ops = KERNEL_OPS,
                keys: Optional[LayerKeys] = None):
        rate = self.attention.config.hidden_dropout
        a = self.attention(_norm(ops, self.input_norm, x), mask, ops, keys)
        x = x + _hidden_dropout(ops, rate, a, keys, 0)
        hcol = F.gelu(self.fc1(_norm(ops, self.post_norm, x)),
                      approximate="tanh")
        return x + _hidden_dropout(ops, rate, self.fc2(hcol), keys, 1)


class BertPooler(nn.Module):
    """dense + tanh over the first ([CLS]) token; ``weight`` (in, out)."""

    def __init__(self, config: BertConfig, *, device: DeviceLike = None):
        super().__init__()
        cfg = config
        self.config = cfg
        h = cfg.hidden_size
        self.weight = nn.Parameter(torch.empty(
            (h, h), dtype=cfg.param_dtype, device=device))
        self.bias = nn.Parameter(torch.zeros(h, dtype=cfg.param_dtype,
                                             device=device))

    def forward(self, x):                  # (s, b, h) -> (b, h)
        return torch.tanh(_dense_in_out(x[0], self.weight, self.bias,
                                        self.config.dtype))


class BertLMHead(nn.Module):
    """MLM head: dense ((in, out) ``weight`` + ``dense_bias``) -> tanh
    GELU -> LayerNorm -> fp32 logits against the tied word embedding +
    the vocab ``bias``."""

    def __init__(self, config: BertConfig, *, device: DeviceLike = None):
        super().__init__()
        cfg = config
        self.config = cfg
        h = cfg.hidden_size
        self.weight = nn.Parameter(torch.empty(
            (h, h), dtype=cfg.param_dtype, device=device))
        self.dense_bias = nn.Parameter(torch.zeros(
            h, dtype=cfg.param_dtype, device=device))
        self.norm = FusedLayerNorm(h, cfg.layernorm_epsilon, device=device,
                                   dtype=torch.float32)
        self.bias = nn.Parameter(torch.zeros(
            cfg.vocab_size, dtype=cfg.param_dtype, device=device))

    def forward(self, x, word_embedding, ops: _Ops = KERNEL_OPS):
        x = _dense_in_out(x, self.weight, self.dense_bias, self.config.dtype)
        x = _norm(ops, self.norm, F.gelu(x, approximate="tanh"))
        logits = torch.matmul(x.float(), word_embedding.float().t())
        return logits + self.bias.float()


class BertModel(nn.Module):
    """Full BERT. ``forward(tokens (b, s), attention_mask (b, s) keep-mask,
    tokentype_ids (b, s) or None)`` returns ``(lm_logits (s, b, vocab),
    binary_logits (b, 2) or None)``, both fp32.

    Parameters are made on the CPU from ``generator`` (a
    ``torch.Generator``; the default generator when None) and then
    moved to ``device`` — CUDA unless the caller names another."""

    def __init__(self, config: BertConfig, *, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if tensor_axis().size > 1:
            raise NotImplementedError(
                "BERT's tensor-parallel forward is not ported yet "
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
        self.tokentype_embedding = (
            nn.Parameter(torch.empty((cfg.num_tokentypes, h),
                                     dtype=cfg.param_dtype))
            if cfg.num_tokentypes > 0 else None)
        self.layers = nn.ModuleList(
            [BertLayer(cfg, device="cpu") for _ in range(cfg.num_layers)])
        self.final_norm = FusedLayerNorm(h, cfg.layernorm_epsilon,
                                         device="cpu", dtype=torch.float32)
        if cfg.add_binary_head:
            self.pooler = BertPooler(cfg, device="cpu")
            self.binary_weight = nn.Parameter(torch.empty(
                (h, 2), dtype=cfg.param_dtype))
            self.binary_bias = nn.Parameter(torch.zeros(
                2, dtype=cfg.param_dtype))
        self.lm_head = BertLMHead(cfg, device="cpu")
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.endswith("norm.weight"):
                    continue                      # ones
                if name.endswith("bias"):
                    continue                      # zeros
                # the layers' (out, in) linears with variance 1 / fan_in;
                # the embeddings and the (in, out) heads N(0, 0.02), as
                # the reference draws them
                std = (p.shape[-1] ** -0.5 if name.startswith("layers.")
                       else 0.02)
                p.normal_(0.0, std, generator=generator)
        self.to(dev)

    def forward(self, tokens, attention_mask, tokentype_ids=None, *,
                deterministic=True, dropout_key=None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """``deterministic=False`` applies the config's dropout, keyed on
        ``dropout_key`` (the reference's ``rngs={"dropout": key}``)."""
        return self._forward(tokens, attention_mask, tokentype_ids,
                             KERNEL_OPS, deterministic, dropout_key)

    def forward_plain(self, tokens, attention_mask, tokentype_ids=None, *,
                      deterministic=True, dropout_key=None
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """:meth:`forward` through the plain PyTorch versions of the
        kernels on any device — the yardstick the kernel path is held
        against on the card."""
        return self._forward(tokens, attention_mask, tokentype_ids,
                             PLAIN_OPS, deterministic, dropout_key)

    def _forward(self, tokens, attention_mask, tokentype_ids, ops,
                 deterministic=True, dropout_key=None):
        cfg = self.config
        keys = _dropout_keys(cfg, deterministic, dropout_key,
                             cfg.attention_backend == "softmax")
        dev = self.embedding.weight.device
        tokens = torch.as_tensor(tokens, device=dev).long()
        attention_mask = torch.as_tensor(attention_mask, device=dev)
        s = tokens.shape[1]
        mask = (attention_mask if cfg.attention_backend == "flash"
                else bert_extended_attention_mask(attention_mask))
        x = self.embedding(tokens)                         # (b, s, h)
        x = x + self.position_embedding[:s][None].to(cfg.dtype)
        if self.tokentype_embedding is not None:
            if tokentype_ids is None:
                tokentype_ids = torch.zeros_like(tokens)
            tt = self.tokentype_embedding.to(cfg.dtype)
            x = x + tt[torch.as_tensor(tokentype_ids, device=dev).long()]
        x = x.transpose(0, 1)                              # (s, b, h)
        for i, layer in enumerate(self.layers):
            x = layer(x, mask, ops, None if keys is None else keys[i])
        x = _norm(ops, self.final_norm, x)
        binary = None
        if cfg.add_binary_head:
            pooled = self.pooler(x)
            binary = (torch.matmul(pooled.float(), self.binary_weight.float())
                      + self.binary_bias.float())
        return self.lm_head(x, self.embedding.weight, ops), binary


def bert_loss_fn(lm_logits: torch.Tensor,
                 binary_logits: Optional[torch.Tensor],
                 lm_labels: torch.Tensor, loss_mask: torch.Tensor,
                 nsp_labels: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked-LM loss (+ NSP when the head and labels are there): per-token
    cross entropy averaged over the ``loss_mask`` positions, plus the
    2-way cross entropy of the binary head (the reference's
    ``bert_loss_fn`` outside a tensor-parallel axis). ``lm_logits`` (s, b,
    vocab); ``lm_labels``, ``loss_mask`` (b, s)."""
    labels_sb = lm_labels.transpose(0, 1).long()
    lse = torch.logsumexp(lm_logits, dim=-1)
    tgt = torch.gather(lm_logits, -1, labels_sb[..., None])[..., 0]
    mask_sb = loss_mask.transpose(0, 1).float()
    lm_loss = (torch.sum((lse - tgt) * mask_sb)
               / torch.clamp(torch.sum(mask_sb), min=1.0))
    if binary_logits is None or nsp_labels is None:
        return lm_loss
    logp = torch.log_softmax(binary_logits, dim=-1)
    nsp = -torch.mean(torch.gather(logp, 1, nsp_labels.long()[:, None])[:, 0])
    return lm_loss + nsp


def bert_param_specs(params) -> Dict[str, tuple]:
    """Each BERT parameter's layout, by name (the reference's
    ``bert_param_specs`` :381): ``gpt_param_specs``' rules plus the LM
    head's bias on the vocab dim."""
    return {n: param_spec(n, vocab_bias=True) for n in _names(params)}


__all__ = ["BertConfig", "BertLayer", "BertLMHead", "BertModel",
           "BertParallelAttention", "BertPooler", "bert_param_specs",
           "bert_extended_attention_mask", "bert_loss_fn"]
