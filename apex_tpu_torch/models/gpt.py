"""Megatron-style GPT, dense, for serving and training.

Counterpart of ``apex_tpu/models/gpt.py`` (:43-577) at tp=1: token +
position embedding, L pre-LN blocks [LayerNorm, fused-QKV attention,
LayerNorm, GELU MLP], a final LayerNorm and the tied LM head. What the
port keeps exactly, because the tests hold it against the reference on
converted weights:

- activations in the ``(s, b, h)`` layout; logits ``(s, b, vocab)`` fp32;
- the fused QKV output laid out per kv group,
  ``[q_0 .. q_{g-1} | k | v] x kv_heads`` (``g`` q heads per kv head);
- the embedding rows cast to the compute dtype, then the position
  embedding added in that dtype;
- tanh GELU; the tied LM head computed in fp32;
- the serving hooks: ``return_kv`` (prefill), ``kv_ctx`` + ``ctx_mask``
  with one query per sequence (decode) or a chunk of queries over
  ``[ctx | chunk]`` keys with the causal ``sk > sq`` offset (chunked
  prefill);
- the training loss :func:`gpt_loss_fn`: mean cross entropy over fp32
  logits through a plain logsumexp, as the reference computes it outside
  any kernel. The forward differentiates through the LayerNorm and
  flash-attention kernels' backward kernels;
- ``attention_backend="softmax"`` (the reference's :326-354): fp32
  scores divided by sqrt(head_dim) and cast to the compute dtype, the
  causal fused softmax, ``probs @ v`` accumulated in fp32 and cast; GQA
  repeats each kv head over its group of q heads. The serving hooks
  (``kv_ctx``) run flash attention whatever the backend, as there.

- dropout (``forward(..., deterministic=False, dropout_key=key)``, the
  reference's ``apply(..., deterministic=False, rngs={"dropout":
  key})``): ``attention_dropout`` in the flash kernel (its
  counter-based mask) or, on the softmax backend, on the probabilities
  through ``ops/dropout.py``; ``hidden_dropout`` after the attention
  projection and after the MLP, through ``ops/dropout.py``. Each draw's
  key is the one Flax gives that scope (``_rng.py``), so the masks are
  the reference's bit for bit.

Layers are a Python loop over an ``nn.ModuleList``; the reference's
``scan_layers`` is a parameter layout there, which ``convert.py`` reads
either way, and the layout of the dropout keys, which ``scan_layers``
selects. MoE, the ring attention backend and sequence parallelism
belong to later slices of the port.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch._backend import DeviceLike, resolve_device
from apex_tpu_torch.models._rng import LayerKeys, layer_keys
from apex_tpu_torch.normalization import FusedLayerNorm
from apex_tpu_torch.ops.attention import attention_plain, flash_attention
from apex_tpu_torch.ops.dropout import dropout, dropout_plain
from apex_tpu_torch.ops.layer_norm import fused_layer_norm, layer_norm_plain
from apex_tpu_torch.ops.softmax import softmax_plain
from apex_tpu_torch.transformer.functional import (
    AttnMaskType,
    FusedScaleMaskSoftmax,
)
from apex_tpu_torch.transformer.tensor_parallel import (
    ColumnParallelLinear,
    RowParallelLinear,
    VocabParallelEmbedding,
)


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 50304
    max_seq_len: int = 1024
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    # GQA/MQA: shared kv heads (None = num_heads)
    num_kv_heads: Optional[int] = None
    # sliding-window attention: each query sees its last
    # `attention_window` keys up to the diagonal (full forward only)
    attention_window: Optional[int] = None
    ffn_hidden_size: Optional[int] = None   # default 4*hidden
    dtype: torch.dtype = torch.bfloat16
    # the linears' and embeddings' parameters; the LayerNorms' stay fp32
    # as the reference's (its FusedLayerNorm takes no param_dtype): a bf16
    # master casts the whole model (``model.bfloat16()``)
    param_dtype: torch.dtype = torch.float32
    attention_dropout: float = 0.0
    hidden_dropout: float = 0.0
    attention_backend: str = "flash"
    # the reference's layer scan: here only the layout of the dropout
    # keys (its parameter layout is convert.py's business)
    scan_layers: bool = True
    num_experts: int = 0

    def __post_init__(self):
        for name in ("attention_dropout", "hidden_dropout"):
            if not 0.0 <= getattr(self, name) < 1.0:
                raise ValueError(f"{name} must be in [0, 1), got "
                                 f"{getattr(self, name)}")
        if self.num_kv_heads is not None and self.num_kv_heads < 1:
            raise ValueError(
                f"num_kv_heads must be >= 1 or None, got {self.num_kv_heads}")
        if self.num_heads % self.kv_heads:
            raise ValueError(
                f"num_kv_heads ({self.kv_heads}) must divide num_heads "
                f"({self.num_heads})")
        if self.hidden_size % self.num_heads:
            raise ValueError("num_heads must divide hidden_size")
        if self.attention_window is not None:
            if self.attention_backend != "flash":
                raise ValueError(
                    "attention_window requires attention_backend='flash' "
                    f"(got {self.attention_backend!r})")
            if self.attention_window < 1:
                raise ValueError("attention_window must be >= 1")
        if self.attention_backend == "ring":
            raise NotImplementedError(
                "attention_backend='ring' is not ported yet; ring attention "
                "belongs to the context-parallel slice of the port")
        if self.attention_backend not in ("flash", "softmax"):
            raise ValueError(
                "attention_backend must be 'flash', 'softmax' or 'ring', "
                f"got {self.attention_backend!r}")
        if self.num_experts:
            raise NotImplementedError(
                "MoE (num_experts > 0) is not ported yet")

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    @property
    def ffn(self) -> int:
        return self.ffn_hidden_size or 4 * self.hidden_size

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    # GPT-2 345M (the reference's GPTConfig.gpt2_345m)
    @staticmethod
    def gpt2_345m(**kw) -> "GPTConfig":
        return GPTConfig(hidden_size=1024, num_layers=24, num_heads=16,
                         max_seq_len=1024, **kw)


def _fused_softmax(scores, mask=None, *, causal=False):
    return FusedScaleMaskSoftmax(
        attn_mask_type=AttnMaskType.causal if causal
        else AttnMaskType.padding)(scores, mask)


class _Ops(NamedTuple):
    """The fused ops a forward runs: the kernels' wrappers (``forward``)
    or their plain versions (``forward_plain``). ``softmax(scores (b, h,
    sq, sk), mask, causal=...)`` is the attention softmax of the softmax
    backend; ``dropout(x, rate, key)`` Flax's ``nn.Dropout``."""

    layer_norm: Callable
    attention: Callable
    softmax: Callable
    dropout: Callable


KERNEL_OPS = _Ops(fused_layer_norm, flash_attention, _fused_softmax, dropout)
PLAIN_OPS = _Ops(layer_norm_plain, attention_plain, softmax_plain,
                 dropout_plain)


def _norm(ops: _Ops, m: FusedLayerNorm, x: torch.Tensor) -> torch.Tensor:
    return ops.layer_norm(x, m.weight, m.bias, eps=m.eps)


def softmax_attention(q, k, v, mask, causal: bool, dtype: torch.dtype,
                      ops: _Ops = KERNEL_OPS, drop=None) -> torch.Tensor:
    """Attention over materialised scores, the reference's softmax
    backend (GPT :326-354, BERT :131-154): q, k, v (s, b, heads, d) ->
    ctx (b, heads, s, d). The scores are an fp32 product divided by
    sqrt(d), cast to ``dtype``; the softmax runs at scale 1 (causal, or
    with the boolean ``mask`` (b or 1, 1, s, s)); ``drop=(rate, key)``
    drops the probabilities (``nn.Dropout``); ``probs @ v`` is
    accumulated in fp32 and cast to ``dtype``."""
    d = q.shape[-1]
    qb, kb, vb = (t.permute(1, 2, 0, 3).float() for t in (q, k, v))
    # a 0-d tensor on q's device: PyTorch multiplies a CUDA tensor by the
    # reciprocal of a host number, where the reference divides
    root_d = torch.full((), float(d), device=q.device).sqrt()
    scores = torch.matmul(qb, kb.transpose(-1, -2)) / root_d
    probs = ops.softmax(scores.to(dtype), mask, causal=causal)
    if drop is not None:
        probs = ops.dropout(probs, *drop)
    return torch.matmul(probs.float(), vb).to(dtype)


class ParallelAttention(nn.Module):
    """Fused-QKV self attention with an output projection. The serving
    hooks are the reference's: ``return_kv`` also returns this call's
    K/V as ``(b, kv_heads, s, head_dim)``; ``kv_ctx=(k_ctx, v_ctx,
    ctx_mask)`` attends over the gathered cache ``(b, kv_heads, L, d)``
    (``ctx_mask`` (b, L) marks the written prefix) plus this call's own
    keys."""

    def __init__(self, config: GPTConfig, *, device: DeviceLike = None):
        super().__init__()
        cfg = config
        self.config = cfg
        self.qkv = ColumnParallelLinear(
            cfg.hidden_size, (cfg.num_heads + 2 * cfg.kv_heads) * cfg.head_dim,
            dtype=cfg.dtype, param_dtype=cfg.param_dtype, device=device)
        self.proj = RowParallelLinear(
            cfg.num_heads * cfg.head_dim, cfg.hidden_size, dtype=cfg.dtype,
            param_dtype=cfg.param_dtype, device=device)

    def forward(self, x, *, kv_ctx=None, return_kv=False, ops=KERNEL_OPS,
                keys: Optional[LayerKeys] = None):
        """``keys``: the layer's dropout keys (None: deterministic)."""
        cfg = self.config
        hd, nkv = cfg.head_dim, cfg.kv_heads
        rate = cfg.attention_dropout if keys is not None else 0.0
        group = cfg.num_heads // nkv
        qkv = self.qkv(x)
        s, b = qkv.shape[0], qkv.shape[1]
        # one slab per kv group: [q_0..q_{g-1} | k | v]; q head
        # g*group + j shares kv head g (the kernel's h / group map)
        q, k, v = torch.split(qkv.reshape(s, b, nkv, (group + 2) * hd),
                              [group * hd, hd, hd], dim=-1)
        q = q.reshape(s, b, cfg.num_heads, hd)
        k = k.reshape(s, b, nkv, hd)
        v = v.reshape(s, b, nkv, hd)
        kv_new = (k.permute(1, 2, 0, 3).contiguous(),
                  v.permute(1, 2, 0, 3).contiguous())
        qb = q.permute(1, 2, 0, 3)                       # (b, h, s, d)

        if kv_ctx is not None:
            if cfg.attention_window is not None:
                raise NotImplementedError(
                    "kv_ctx decode with attention_window is not supported")
            k_ctx, v_ctx, ctx_mask = kv_ctx
            k_all = torch.cat([k_ctx.to(cfg.dtype), kv_new[0]], dim=2)
            v_all = torch.cat([v_ctx.to(cfg.dtype), kv_new[1]], dim=2)
            # the written prefix and this call's own keys are segment
            # 0, everything else 1; decode (s == 1) needs no causal
            # mask, a chunk (s > 1) sees ctx plus its causal prefix
            # through the sk > sq offset
            kv_seg = torch.cat(
                [torch.where(ctx_mask, 0, 1).to(torch.int32),
                 torch.zeros((b, s), dtype=torch.int32, device=x.device)],
                dim=1)
            ctx = ops.attention(qb.contiguous(), k_all, v_all, causal=s > 1,
                                kv_segment_ids=kv_seg)
        elif cfg.attention_backend == "softmax":
            # the score buffer dominates memory here: share kv heads by
            # repeating each over its group of q heads
            ctx = softmax_attention(q, k.repeat_interleave(group, dim=2),
                                    v.repeat_interleave(group, dim=2), None,
                                    True, cfg.dtype, ops,
                                    (rate, keys.attention) if rate else None)
        else:
            ctx = ops.attention(qb.contiguous(), kv_new[0], kv_new[1],
                                causal=True,
                                window_size=cfg.attention_window,
                                dropout_rate=rate,
                                dropout_rng=keys.attention if rate else None)
        ctx = ctx.permute(2, 0, 1, 3).reshape(s, b, cfg.num_heads * hd)
        out = self.proj(ctx)
        return (out, kv_new) if return_kv else out


class ParallelMLP(nn.Module):
    """fc1 (h -> ffn) -> tanh GELU -> fc2 (ffn -> h)."""

    def __init__(self, config: GPTConfig, *, device: DeviceLike = None):
        super().__init__()
        cfg = config
        self.fc1 = ColumnParallelLinear(
            cfg.hidden_size, cfg.ffn, dtype=cfg.dtype,
            param_dtype=cfg.param_dtype, device=device)
        self.fc2 = RowParallelLinear(
            cfg.ffn, cfg.hidden_size, dtype=cfg.dtype,
            param_dtype=cfg.param_dtype, device=device)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


def _hidden_dropout(ops: _Ops, rate: float, x, keys: Optional[LayerKeys],
                    i: int):
    """The layer's ``i``-th hidden ``nn.Dropout`` (``Dropout_0`` after
    the attention, ``Dropout_1`` after the MLP)."""
    if keys is None or rate <= 0.0:
        return x
    return ops.dropout(x, rate, keys.hidden[i])


class GPTLayer(nn.Module):
    """Pre-LN transformer block."""

    def __init__(self, config: GPTConfig, *, device: DeviceLike = None):
        super().__init__()
        cfg = config
        self.input_norm = FusedLayerNorm(cfg.hidden_size, device=device,
                                         dtype=torch.float32)
        self.attention = ParallelAttention(cfg, device=device)
        self.post_norm = FusedLayerNorm(cfg.hidden_size, device=device,
                                        dtype=torch.float32)
        self.mlp = ParallelMLP(cfg, device=device)

    def forward(self, x, *, kv_ctx=None, return_kv=False, ops=KERNEL_OPS,
                keys: Optional[LayerKeys] = None):
        """``keys``: the layer's dropout keys (None: deterministic)."""
        a = self.attention(_norm(ops, self.input_norm, x), kv_ctx=kv_ctx,
                           return_kv=return_kv, ops=ops, keys=keys)
        kv = None
        if return_kv:
            a, kv = a
        rate = self.attention.config.hidden_dropout
        x = x + _hidden_dropout(ops, rate, a, keys, 0)
        m = self.mlp(_norm(ops, self.post_norm, x))
        y = x + _hidden_dropout(ops, rate, m, keys, 1)
        return (y, kv) if return_kv else y


class GPTModel(nn.Module):
    """GPT LM. ``forward(tokens (b, s))`` returns logits ``(s, b,
    vocab)`` in fp32.

    Parameters are made on the CPU from ``generator`` (a
    ``torch.Generator``; the default generator when None) and then
    moved to ``device`` — CUDA unless the caller names another."""

    def __init__(self, config: GPTConfig, *, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        cfg = config
        self.config = cfg
        self.embedding = VocabParallelEmbedding(
            cfg.vocab_size, cfg.hidden_size, dtype=cfg.dtype,
            param_dtype=cfg.param_dtype, device="cpu")
        self.position_embedding = nn.Parameter(torch.empty(
            (cfg.max_seq_len, cfg.hidden_size), dtype=cfg.param_dtype))
        self.layers = nn.ModuleList(
            [GPTLayer(cfg, device="cpu") for _ in range(cfg.num_layers)])
        self.final_norm = FusedLayerNorm(cfg.hidden_size, device="cpu",
                                         dtype=torch.float32)
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.endswith("norm.weight"):
                    continue                      # ones
                if name.endswith("bias"):
                    continue                      # zeros
                fan_in = p.shape[-1] if p.ndim == 2 else 1
                std = (0.02 if "embedding" in name else fan_in ** -0.5)
                p.normal_(0.0, std, generator=generator)
        self.to(dev)

    def forward(self, tokens, *, positions=None, kv_ctx=None, ctx_mask=None,
                return_kv=False, deterministic=True, dropout_key=None):
        """``positions`` (s,) or (b, s) override ``arange(s)``;
        ``kv_ctx=(k_ctx, v_ctx)`` ``(num_layers, b, kv_heads, L,
        head_dim)`` with ``ctx_mask`` (b, L) runs the cached decode /
        chunk path; ``return_kv=True`` also returns this call's K/V
        stacked ``(num_layers, b, kv_heads, s, head_dim)``.
        ``deterministic=False`` applies the config's dropout, keyed on
        ``dropout_key`` (the reference's ``rngs={"dropout": key}``: a
        (2,) tensor or pair of uint32 words)."""
        return self._forward(tokens, positions, kv_ctx, ctx_mask,
                             return_kv, KERNEL_OPS, deterministic,
                             dropout_key)

    def forward_plain(self, tokens, *, positions=None, kv_ctx=None,
                      ctx_mask=None, return_kv=False, deterministic=True,
                      dropout_key=None):
        """:meth:`forward` through the plain PyTorch versions of the
        kernels on any device — the yardstick the kernel path is held
        against on the card."""
        return self._forward(tokens, positions, kv_ctx, ctx_mask,
                             return_kv, PLAIN_OPS, deterministic,
                             dropout_key)

    def _forward(self, tokens, positions, kv_ctx, ctx_mask, return_kv, ops,
                 deterministic=True, dropout_key=None):
        cfg = self.config
        keys = _dropout_keys(cfg, deterministic, dropout_key,
                             cfg.attention_backend == "softmax")
        b, s = tokens.shape
        x = self.embedding(tokens)                           # (b, s, h)
        pos = self.position_embedding
        if positions is None:
            pos_emb = pos[None, :s]
        else:
            positions = torch.as_tensor(positions, device=tokens.device)
            pos_emb = pos[positions.long()]
            if positions.ndim == 1:
                pos_emb = pos_emb[None]
        x = (x + pos_emb.to(cfg.dtype)).transpose(0, 1)      # (s, b, h)
        serving = return_kv or kv_ctx is not None
        ks, vs = [], []
        for i, layer in enumerate(self.layers):
            ctx = (None if kv_ctx is None
                   else (kv_ctx[0][i], kv_ctx[1][i], ctx_mask))
            x = layer(x, kv_ctx=ctx, return_kv=serving, ops=ops,
                      keys=None if keys is None else keys[i])
            if serving:
                x, (k, v) = x
                ks.append(k)
                vs.append(v)
        x = _norm(ops, self.final_norm, x)
        # tied LM head in fp32
        logits = torch.matmul(x.float(), self.embedding.weight.float().t())
        if return_kv:
            return logits, (torch.stack(ks), torch.stack(vs))
        return logits


def _dropout_keys(cfg, deterministic: bool, dropout_key,
                  softmax_backend: bool) -> Optional[List[LayerKeys]]:
    """Each layer's dropout keys for a forward of ``cfg``, or None when
    it drops nothing."""
    if deterministic or (cfg.attention_dropout <= 0.0
                         and cfg.hidden_dropout <= 0.0):
        return None
    if dropout_key is None:
        raise ValueError("deterministic=False with dropout needs "
                         "dropout_key (the reference's rngs={'dropout': "
                         "key})")
    return layer_keys(dropout_key, cfg.num_layers,
                      scan_layers=cfg.scan_layers,
                      softmax_backend=softmax_backend)


def gpt_loss_fn(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross entropy over tokens (the reference's ``gpt_loss_fn``
    :577 outside a tensor-parallel axis): ``logits`` (s, b, vocab) fp32,
    ``labels`` (b, s)."""
    labels_sb = labels.transpose(0, 1).long()
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, labels_sb[..., None])[..., 0]
    return torch.mean(lse - tgt)


__all__ = ["GPTConfig", "GPTLayer", "GPTModel", "ParallelAttention",
           "ParallelMLP", "gpt_loss_fn", "softmax_attention"]
