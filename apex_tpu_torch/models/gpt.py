"""Megatron-style GPT for serving and training, dense or tensor-parallel.

Counterpart of ``apex_tpu/models/gpt.py`` (:43-626): token + position
embedding, L pre-LN blocks [LayerNorm, fused-QKV attention, LayerNorm,
GELU MLP], a final LayerNorm and the tied LM head. What the port keeps
exactly, because the tests hold it against the reference on converted
weights:

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

Tensor parallelism (the reference's :202-231, :506-590): a model built
inside a topology whose tensor axis has more than one rank (``axis_name``,
``transformer.parallel_state``) holds this rank's shard, drawn full-size
and cut (``gpt_param_specs``): local heads and kv heads (tp divides
both), the fused-QKV rows of whole kv groups, ``proj`` and ``fc2``
row-parallel, the embedding split on the vocab. The LM head is a copy to
the tensor region and an fp32 product with the local vocab shard:
logits ``(s, b, V / tp)``, which :func:`gpt_loss_fn` reduces through the
vocab-parallel cross entropy. ``sequence_parallel`` splits the sequence
between the embedding and the final LayerNorm in the forward, as the
reference tests it, at the loss. Two things raise at tp > 1, each
waiting for ROADMAP A 9g: attention dropout (the flash kernels hash the
global q-head index, so a rank's heads need an offset in kernels #2, #4
and #5 to draw the reference's mask) and dropout under sequence
parallelism; hidden dropout is replicated and runs.

Layers are a Python loop over an ``nn.ModuleList``; the reference's
``scan_layers`` is a parameter layout there, which ``convert.py`` reads
either way, and the layout of the dropout keys, which ``scan_layers``
selects. MoE and the ring attention backend belong to later slices of
the port.
"""

from __future__ import annotations

import dataclasses
from typing import (Callable, Dict, Iterable, List, Mapping, NamedTuple,
                    Optional, Union)

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
from apex_tpu_torch.transformer.parallel_state import TENSOR_AXIS
from apex_tpu_torch.transformer.tensor_parallel import (
    ColumnParallelLinear,
    RowParallelLinear,
    VocabParallelEmbedding,
    column_bias_spec,
    column_kernel_spec,
    copy_to_tensor_model_parallel_region,
    gather_from_sequence_parallel_region,
    row_kernel_spec,
    scatter_to_sequence_parallel_region,
    shard_tensor,
    tensor_axis,
    vocab_embedding_spec,
    vocab_parallel_cross_entropy,
)
from apex_tpu_torch.transformer.tensor_parallel.mappings import AxisLike

# the queue item the tensor-parallel paths that raise wait for
TP_DROPOUT_ITEM = "ROADMAP A 9g"


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
    # split the sequence over the tensor axis between the embedding and
    # the final LayerNorm (tp > 1 only; the forward, as the reference
    # tests it)
    sequence_parallel: bool = False
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
    keys. At tp > 1 it holds ``num_heads / tp`` q heads and ``kv_heads /
    tp`` kv heads; the cache K/V are this rank's kv heads."""

    def __init__(self, config: GPTConfig, *, device: DeviceLike = None,
                 axis_name: Optional[AxisLike] = TENSOR_AXIS):
        super().__init__()
        cfg = config
        self.config = cfg
        ax = self.axis = tensor_axis(axis_name)
        if cfg.num_heads % ax.size or cfg.kv_heads % ax.size:
            raise ValueError(
                f"tensor-parallel size {ax.size} must divide num_heads "
                f"({cfg.num_heads}) and kv heads ({cfg.kv_heads})")
        self.heads_local = cfg.num_heads // ax.size
        self.kv_local = cfg.kv_heads // ax.size
        sp = cfg.sequence_parallel
        self.qkv = ColumnParallelLinear(
            cfg.hidden_size, (cfg.num_heads + 2 * cfg.kv_heads) * cfg.head_dim,
            gather_output=False, sequence_parallel_enabled=sp, axis_name=ax,
            dtype=cfg.dtype, param_dtype=cfg.param_dtype, device=device)
        self.proj = RowParallelLinear(
            cfg.num_heads * cfg.head_dim, cfg.hidden_size,
            sequence_parallel_enabled=sp, axis_name=ax, dtype=cfg.dtype,
            param_dtype=cfg.param_dtype, device=device)

    def forward(self, x, *, kv_ctx=None, return_kv=False, ops=KERNEL_OPS,
                keys: Optional[LayerKeys] = None):
        """``keys``: the layer's dropout keys (None: deterministic)."""
        cfg = self.config
        hd, nkv, nh = cfg.head_dim, self.kv_local, self.heads_local
        rate = cfg.attention_dropout if keys is not None else 0.0
        if rate and self.axis.size > 1:
            raise NotImplementedError(
                "attention_dropout > 0 at tensor-parallel size "
                f"{self.axis.size}: the flash kernels hash the global q-head "
                "index, so a rank's heads need a head offset in the mask "
                f"({TP_DROPOUT_ITEM})")
        group = nh // nkv
        qkv = self.qkv(x)
        s, b = qkv.shape[0], qkv.shape[1]
        # one slab per kv group: [q_0..q_{g-1} | k | v]; q head
        # g*group + j shares kv head g (the kernel's h / group map); a
        # rank's contiguous rows are whole groups
        q, k, v = torch.split(qkv.reshape(s, b, nkv, (group + 2) * hd),
                              [group * hd, hd, hd], dim=-1)
        q = q.reshape(s, b, nh, hd)
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
        ctx = ctx.permute(2, 0, 1, 3).reshape(s, b, nh * hd)
        out = self.proj(ctx)
        return (out, kv_new) if return_kv else out


class ParallelMLP(nn.Module):
    """fc1 (h -> ffn, column-parallel) -> tanh GELU -> fc2 (ffn -> h,
    row-parallel)."""

    def __init__(self, config: GPTConfig, *, device: DeviceLike = None,
                 axis_name: Optional[AxisLike] = TENSOR_AXIS):
        super().__init__()
        cfg = config
        sp = cfg.sequence_parallel
        self.fc1 = ColumnParallelLinear(
            cfg.hidden_size, cfg.ffn, gather_output=False,
            sequence_parallel_enabled=sp, axis_name=axis_name,
            dtype=cfg.dtype, param_dtype=cfg.param_dtype, device=device)
        self.fc2 = RowParallelLinear(
            cfg.ffn, cfg.hidden_size, sequence_parallel_enabled=sp,
            axis_name=axis_name, dtype=cfg.dtype,
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

    def __init__(self, config: GPTConfig, *, device: DeviceLike = None,
                 axis_name: Optional[AxisLike] = TENSOR_AXIS):
        super().__init__()
        cfg = config
        self.input_norm = FusedLayerNorm(cfg.hidden_size, device=device,
                                         dtype=torch.float32)
        self.attention = ParallelAttention(cfg, device=device,
                                           axis_name=axis_name)
        self.post_norm = FusedLayerNorm(cfg.hidden_size, device=device,
                                        dtype=torch.float32)
        self.mlp = ParallelMLP(cfg, device=device, axis_name=axis_name)

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
    vocab / tp)`` in fp32 (the whole vocab at tp=1).

    Parameters are made on the CPU from ``generator`` (a
    ``torch.Generator``; the default generator when None) and then
    moved to ``device`` — CUDA unless the caller names another. Inside a
    topology whose tensor axis (``axis_name``; None: none, a whole
    model) has tp > 1 ranks, every rank draws the same full-size
    parameters and keeps its shard (``gpt_param_specs``), so the tp
    ranks' shards put together are the tp=1 model of the same generator.
    ``params`` (full-size tensors by name, e.g. a tp=1 model's
    ``named_parameters()`` or a converted checkpoint) takes the place of
    the draw: each rank keeps its slice of them."""

    def __init__(self, config: GPTConfig, *, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None,
                 params: Optional[Mapping[str, torch.Tensor]] = None,
                 axis_name: Optional[AxisLike] = TENSOR_AXIS):
        super().__init__()
        dev = resolve_device(device)
        cfg = config
        self.config = cfg
        ax = self.axis = tensor_axis(axis_name)
        self.embedding = VocabParallelEmbedding(
            cfg.vocab_size, cfg.hidden_size, axis_name=ax, dtype=cfg.dtype,
            param_dtype=cfg.param_dtype, device="cpu")
        self.position_embedding = nn.Parameter(torch.empty(
            (cfg.max_seq_len, cfg.hidden_size), dtype=cfg.param_dtype))
        self.layers = nn.ModuleList(
            [GPTLayer(cfg, device="cpu", axis_name=ax)
             for _ in range(cfg.num_layers)])
        self.final_norm = FusedLayerNorm(cfg.hidden_size, device="cpu",
                                         dtype=torch.float32)
        specs = gpt_param_specs(self)
        if params is not None and set(params) != set(specs):
            raise KeyError(
                "params do not match the model: missing "
                f"{sorted(set(specs) - set(params))}, unexpected "
                f"{sorted(set(params) - set(specs))}")
        sizes, coords = {TENSOR_AXIS: ax.size}, {TENSOR_AXIS: ax.index}
        with torch.no_grad():
            for name, p in self.named_parameters():
                spec = specs[name]
                if params is not None:
                    full = params[name]
                    shape = _full_shape(p, spec, ax.size)
                    if tuple(full.shape) != shape:
                        raise ValueError(f"{name}: shape {tuple(full.shape)},"
                                         f" the model's full shape {shape}")
                    p.copy_(shard_tensor(full, spec, sizes, coords))
                    continue
                if name.endswith("norm.weight"):
                    continue                      # ones
                if name.endswith("bias"):
                    continue                      # zeros
                shape = _full_shape(p, spec, ax.size)
                fan_in = shape[-1] if p.ndim == 2 else 1
                std = (0.02 if "embedding" in name else fan_in ** -0.5)
                full = p if ax.size == 1 else torch.empty(shape,
                                                          dtype=p.dtype)
                full.normal_(0.0, std, generator=generator)
                if full is not p:
                    p.copy_(shard_tensor(full, spec, sizes, coords))
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
        ax = self.axis
        sp = cfg.sequence_parallel and ax.size > 1
        keys = _dropout_keys(cfg, deterministic, dropout_key,
                             cfg.attention_backend == "softmax")
        if keys is not None and sp:
            raise NotImplementedError(
                "dropout under sequence_parallel at tensor-parallel size "
                f"{ax.size} ({TP_DROPOUT_ITEM})")
        if sp and torch.is_grad_enabled() \
                and self.position_embedding.requires_grad:
            raise NotImplementedError(
                "training under sequence_parallel at tensor-parallel size "
                f"{ax.size}: the replicated LayerNorm gradients would be "
                "partial sums over the sequence shards, and their reduction "
                f"over the tensor group is not ported ({TP_DROPOUT_ITEM}); "
                "run the forward under torch.no_grad")
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
        if sp:
            x = scatter_to_sequence_parallel_region(x, ax)
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
        if sp:
            x = gather_from_sequence_parallel_region(x, ax, True)
        # tied LM head in fp32 over the local vocab shard; the copy makes
        # the gradient of x the sum over the shards
        x = copy_to_tensor_model_parallel_region(x, ax)
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


def gpt_loss_fn(logits: torch.Tensor, labels: torch.Tensor,
                axis_name: Optional[AxisLike] = TENSOR_AXIS) -> torch.Tensor:
    """Mean cross entropy over tokens (the reference's ``gpt_loss_fn``
    :577): ``logits`` (s, b, vocab / tp) fp32, ``labels`` (b, s). Over a
    tensor axis of more than one rank (a model's ``axis``), the
    vocab-parallel cross entropy; else a plain logsumexp."""
    labels_sb = labels.transpose(0, 1).long()
    ax = tensor_axis(axis_name)
    if ax.size > 1:
        return torch.mean(vocab_parallel_cross_entropy(logits, labels_sb,
                                                       axis_name=ax))
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, labels_sb[..., None])[..., 0]
    return torch.mean(lse - tgt)


# -- partition specs ----------------------------------------------------------


Spec = tuple


def _full_shape(p: torch.Tensor, spec: Spec, tp: int) -> tuple:
    return tuple(n * tp if i < len(spec) and spec[i] is not None else n
                 for i, n in enumerate(p.shape))


def _names(params) -> Iterable[str]:
    if isinstance(params, nn.Module):
        return [n for n, _ in params.named_parameters()]
    if isinstance(params, Mapping):
        return list(params)
    return list(params)


def param_spec(name: str, column=("qkv", "fc1"), row=("proj", "fc2"),
               vocab_bias: bool = False) -> Spec:
    """One parameter's layout by the reference's rules (``gpt.py``
    :596-626, ``bert.py`` :381, ``t5.py`` :355) on the port's dotted
    name: the word embedding on the vocab dim, the weight and bias of a
    module named in ``column`` on the output dim, the weight of one in
    ``row`` on the input dim, with ``vocab_bias`` BERT's LM-head bias on
    the vocab; everything else replicated (``()``)."""
    *mods, leaf = name.split(".")
    last = mods[-1] if mods else ""
    if name == "embedding.weight":
        return vocab_embedding_spec()
    if last in column:
        return column_kernel_spec() if leaf == "weight" else column_bias_spec()
    if last in row and leaf == "weight":
        return row_kernel_spec()
    if vocab_bias and name == "lm_head.bias":
        return column_bias_spec()
    return ()


def gpt_param_specs(params: Union[nn.Module, Mapping[str, torch.Tensor],
                                  Iterable[str]]) -> Dict[str, Spec]:
    """Each GPT parameter's layout, by name (a model, a state dict or
    the names): a tuple with the tensor axis's name on a split dim and
    None elsewhere; ``()`` for a replicated parameter. The port's
    names are per layer (``layers.{i}...``), so no leading layer axis."""
    return {n: param_spec(n) for n in _names(params)}


__all__ = ["GPTConfig", "GPTLayer", "GPTModel", "ParallelAttention",
           "ParallelMLP", "TP_DROPOUT_ITEM", "gpt_loss_fn", "gpt_param_specs",
           "param_spec", "softmax_attention"]
