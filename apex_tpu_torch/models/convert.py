"""Convert the reference's GPT, BERT, T5 and ResNet parameters (and their
optimizer state) into the port's ``GPTModel`` / ``BertModel`` /
``T5Model`` / ``ResNet`` (and ``FlatOptState``, or one rank's shard of
a ZeRO state, ``load_jax_dist_state``), and the DCGAN example's two
modules.

The input is the parameter tree of the reference's ``GPTModel``
(``apex_tpu/models/gpt.py``) or ``BertModel`` (``apex_tpu/models/bert.py``)
with numpy leaves, with or without the outer ``{"params": ...}``. Both
layer layouts are read:

- ``scan_layers=True``: one ``layers/layer/...`` subtree whose leaves
  carry a leading layer axis;
- ``scan_layers=False``: one ``layer_{i}/...`` subtree per layer.

T5 has two stacks, ``encoder_layers/layer`` / ``encoder_{i}`` and
``decoder_layers/layer`` / ``decoder_{i}`` (``t5_params_from_jax``).

No leaf is transposed: the parallel linears keep the reference's
``(out, in)`` layout and BERT's pooler, LM-head dense and binary head its
``(in, out)`` one, as the port's modules expect; the reference's
LayerNorm ``scale`` becomes ``weight``.
bf16 leaves (numpy's ``bfloat16`` from ml_dtypes, or their raw
``uint16`` bits) cross as uint16 views and come out as
``torch.bfloat16``. A missing or an extra key, or a shape that does not
fit the config, raises.

ResNet (``resnet_params_from_jax``, ``load_jax_resnet``): the
reference's tree names map to module paths ('/' -> '.'), its HWIO conv
kernels become OIHW, BatchNorm's ``scale`` becomes ``weight`` and the
``batch_stats`` ``mean`` / ``var`` the buffers ``running_mean`` /
``running_var``.

DCGAN (``dcgan_params_from_jax``): the generator and discriminator of
``examples/dcgan/main_amp.py`` (Flax ``Dense``, ``GroupNorm``, ``Conv``
and ``ConvTranspose``), read through the same key check as the model
zoo's, then laid out for PyTorch: ``Dense`` kernels (in, out) become
``Linear`` weights (out, in), ``Conv`` kernels HWIO become OIHW, and
``ConvTranspose`` kernels (H, W, I, O) become ``conv_transpose2d``'s
(I, O, H, W) flipped in H and W (Flax's transposed convolution does not
flip its kernel; PyTorch's does).

Multi-head attention (``multihead_attn_params_from_jax``): the
reference's ``SelfMultiheadAttn`` / ``EncdecMultiheadAttn`` tree. Its
Flax ``Dense`` kernels are stored (in, out) and become ``nn.Linear``
weights (out, in); ``lyr_nrm``'s ``scale`` becomes ``weight``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Union

import numpy as np
import torch

from apex_tpu_torch.models.bert import BertConfig, BertModel
from apex_tpu_torch.models.gpt import GPTConfig, GPTModel
from apex_tpu_torch.models.migrate import unstack_scan_params
from apex_tpu_torch.models.resnet import ResNet, ResNetConfig
from apex_tpu_torch.models.t5 import T5Config, T5Model
from apex_tpu_torch.optimizers.fused import FlatOptState

# torch name inside one layer -> reference path inside one layer
_LAYER_KEYS = {
    "input_norm.weight": "input_norm/scale",
    "input_norm.bias": "input_norm/bias",
    "attention.qkv.weight": "attention/qkv/kernel",
    "attention.qkv.bias": "attention/qkv/bias",
    "attention.proj.weight": "attention/proj/kernel",
    "attention.proj.bias": "attention/proj/bias",
    "post_norm.weight": "post_norm/scale",
    "post_norm.bias": "post_norm/bias",
    "mlp.fc1.weight": "mlp/fc1/kernel",
    "mlp.fc1.bias": "mlp/fc1/bias",
    "mlp.fc2.weight": "mlp/fc2/kernel",
    "mlp.fc2.bias": "mlp/fc2/bias",
}
_TOP_KEYS = {
    "embedding.weight": "embedding/embedding",
    "position_embedding": "position_embedding",
    "final_norm.weight": "final_norm/scale",
    "final_norm.bias": "final_norm/bias",
}
# BERT: fc1/fc2 sit directly under the layer
_BERT_LAYER_KEYS = {
    **{k: v for k, v in _LAYER_KEYS.items() if not k.startswith("mlp.")},
    "fc1.weight": "fc1/kernel",
    "fc1.bias": "fc1/bias",
    "fc2.weight": "fc2/kernel",
    "fc2.bias": "fc2/bias",
}
_BERT_LM_HEAD_KEYS = {
    "lm_head.weight": "lm_head/kernel",
    "lm_head.dense_bias": "lm_head/dense_bias",
    "lm_head.norm.weight": "lm_head/norm/scale",
    "lm_head.norm.bias": "lm_head/norm/bias",
    "lm_head.bias": "lm_head/bias",
}


def _bert_top_keys(config: BertConfig) -> Dict[str, str]:
    keys = dict(_TOP_KEYS, **_BERT_LM_HEAD_KEYS)
    if config.num_tokentypes > 0:
        keys["tokentype_embedding"] = "tokentype_embedding"
    if config.add_binary_head:
        keys.update({"pooler.weight": "pooler/kernel",
                     "pooler.bias": "pooler/bias",
                     "binary_weight": "binary_kernel",
                     "binary_bias": "binary_bias"})
    return keys


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, path + "/"))
        else:
            out[path] = v
    return out


def _to_torch(a) -> torch.Tensor:
    a = np.array(a, copy=True, order="C")   # writable, owned by torch
    if a.dtype.name == "bfloat16" or a.dtype == np.uint16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _params_from_jax(params_np: Mapping, top_keys: Mapping[str, str],
                     stacks, family: str) -> Dict[str, torch.Tensor]:
    """The state dict of one model family: ``top_keys`` (torch name ->
    reference path) and, for each ``(torch stack, reference stack,
    n_layers, layer_keys)`` of ``stacks``, layer ``i``'s
    ``<torch stack>.{i}.<name>`` from ``<reference stack>_{i}/<path>``.
    A scanned stack is unrolled first (``migrate``), so both layouts are
    read the same way."""
    flat = _flatten(unstack_scan_params(dict(params_np.get("params",
                                                           params_np))))
    wanted: Dict[str, str] = dict(top_keys)
    for stack, ref_stack, n, keys in stacks:
        for i in range(n):
            for name, path in keys.items():
                wanted[f"{stack}.{i}.{name}"] = f"{ref_stack}_{i}/{path}"
    missing = sorted(p for p in wanted.values() if p not in flat)
    extra = sorted(set(flat) - set(wanted.values()))
    if missing or extra:
        raise KeyError(f"reference {family} params do not match the config: "
                       f"missing {missing}, unexpected {extra}")
    return {name: _to_torch(flat[path]) for name, path in wanted.items()}


def gpt_params_from_jax(params_np: Mapping, config: GPTConfig
                        ) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of a :class:`GPTModel` of ``config`` holding
    the reference's parameters ``params_np`` (CPU tensors)."""
    return _params_from_jax(params_np, _TOP_KEYS, (
        ("layers", "layer", config.num_layers, _LAYER_KEYS),), "GPT")


def gpt_shard_from_jax(params_np: Mapping, config: GPTConfig,
                       specs: Mapping[str, tuple], rank: int, tp: int,
                       *, pipe_rank: int = 0, pipe: int = 1,
                       num_model_chunks: int = 1
                       ) -> Dict[str, torch.Tensor]:
    """Tensor rank ``rank``'s shard (of ``tp``) of the reference's GPT
    parameters ``params_np`` (its scan-stacked ``(L, ...)`` leaves or
    its per-layer ones), in the port's names: each tensor of
    :func:`gpt_params_from_jax` cut by its spec in ``specs``
    (``gpt_param_specs``, axis ``tensor``), the counterpart of the
    reference's ``ShardingPlan.shard_params`` (``mesh.py`` :174-181) on
    its tree. With ``pipe > 1`` only pipe stage ``pipe_rank``'s
    parameters (``num_model_chunks`` chunks a stage;
    ``mesh.pipeline.stage_param_names``), the last stage's copy of the
    tied embedding included. Load it into a :class:`GPTModel` built at
    that rank, or its ``mesh.pipeline.GPTStage``."""
    from apex_tpu_torch.mesh.pipeline import stage_param_names
    from apex_tpu_torch.transformer.parallel_state import TENSOR_AXIS
    from apex_tpu_torch.transformer.tensor_parallel import shard_tensor

    full = gpt_params_from_jax(params_np, config)
    if pipe > 1:
        full = {n: full[n] for n in stage_param_names(
            list(full), pipe, pipe_rank, num_model_chunks)}
    sizes, coords = {TENSOR_AXIS: int(tp)}, {TENSOR_AXIS: int(rank)}
    return {n: shard_tensor(t, specs[n], sizes, coords).clone()
            for n, t in full.items()}


def bert_params_from_jax(params_np: Mapping, config: BertConfig
                         ) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of a :class:`BertModel` of ``config`` holding
    the reference's parameters ``params_np`` (CPU tensors)."""
    return _params_from_jax(params_np, _bert_top_keys(config), (
        ("layers", "layer", config.num_layers, _BERT_LAYER_KEYS),), "BERT")


def _linear_keys(scope: str, names) -> Dict[str, str]:
    return {f"{scope}.{n}.{leaf}":
            f"{scope}/{n}/{'kernel' if leaf == 'weight' else 'bias'}"
            for n in names for leaf in ("weight", "bias")}


def _norm_keys(*scopes: str) -> Dict[str, str]:
    return {f"{n}.{leaf}": f"{n}/{'scale' if leaf == 'weight' else 'bias'}"
            for n in scopes for leaf in ("weight", "bias")}


# T5: torch name inside one layer -> reference path inside one layer
_T5_ENCODER_KEYS = {
    **_norm_keys("input_norm", "post_norm"),
    **_linear_keys("self_attention", ("qkv", "proj")),
    **_linear_keys("mlp", ("fc1", "fc2")),
}
_T5_DECODER_KEYS = {
    **_T5_ENCODER_KEYS,
    **_norm_keys("post_attn_norm"),
    **_linear_keys("inter_attention", ("q", "kv", "proj")),
}
_T5_TOP_KEYS = {
    "embedding.weight": "embedding/embedding",
    "position_embedding": "position_embedding",
    **_norm_keys("encoder_norm", "decoder_norm"),
}


def t5_params_from_jax(params_np: Mapping, config: T5Config
                       ) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of a :class:`T5Model` of ``config`` holding the
    reference's parameters ``params_np`` (CPU tensors). Both layouts of
    each stack are read: ``encoder_layers/layer/...`` with a leading layer
    axis (``scan_layers=True``) or ``encoder_{i}/...`` (the same for the
    decoder); the scanned one is unrolled by ``migrate``."""
    return _params_from_jax(params_np, _T5_TOP_KEYS, (
        ("encoder_layers", "encoder", config.num_encoder_layers,
         _T5_ENCODER_KEYS),
        ("decoder_layers", "decoder", config.num_decoder_layers,
         _T5_DECODER_KEYS)), "T5")


_DCGAN_KEYS = {
    "generator": {"dense.weight": "Dense_0/kernel", "dense.bias": "Dense_0/bias",
                  **{f"group_norm{i}.{leaf}": f"GroupNorm_{i}/{leaf}"
                     for i in (0, 1) for leaf in ("scale", "bias")},
                  **{f"deconv{i}.{leaf}": f"ConvTranspose_{i}/{ref}"
                     for i in (0, 1) for leaf, ref in (("weight", "kernel"),
                                                       ("bias", "bias"))}},
    "discriminator": {**{f"conv{i}.{leaf}": f"Conv_{i}/{ref}"
                         for i in (0, 1) for leaf, ref in (("weight", "kernel"),
                                                           ("bias", "bias"))},
                      "dense.weight": "Dense_0/kernel",
                      "dense.bias": "Dense_0/bias"},
}


def dcgan_params_from_jax(params_np: Mapping, kind: str
                          ) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` (CPU tensors) of the port's DCGAN ``Generator``
    (``kind="generator"``) or ``Discriminator`` (``"discriminator"``,
    ``apex_tpu_torch.examples.dcgan_amp``) holding the reference module's
    parameters ``params_np`` (numpy leaves, with or without
    ``{"params": ...}``)."""
    if kind not in _DCGAN_KEYS:
        raise ValueError(f"kind {kind!r}: expected one of "
                         f"{sorted(_DCGAN_KEYS)}")
    state = _params_from_jax(params_np, _DCGAN_KEYS[kind], (),
                             f"DCGAN {kind}")
    for name, t in state.items():
        if name.startswith("dense.") and t.ndim == 2:
            t = t.T                                      # (in, out) -> (out, in)
        elif name.startswith("conv") and t.ndim == 4:
            t = t.permute(3, 2, 0, 1)                    # HWIO -> OIHW
        elif name.startswith("deconv") and t.ndim == 4:
            t = t.permute(2, 3, 0, 1).flip(2, 3)         # HWIO -> IOHW, flipped
        state[name] = t.contiguous()
    return state


_MHA_DENSE = ("qkv_proj", "q_proj", "k_proj", "v_proj", "kv_proj",
              "out_proj")


def multihead_attn_params_from_jax(params_np: Mapping
                                   ) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of the port's ``SelfMultiheadAttn`` or
    ``EncdecMultiheadAttn`` holding the reference module's parameters
    ``params_np`` (numpy leaves, with or without ``{"params": ...}``;
    CPU tensors). A name the modules do not have raises."""
    flat = _flatten(params_np.get("params", params_np))
    state: Dict[str, torch.Tensor] = {}
    for path, leaf in flat.items():
        mod, _, leaf_name = path.partition("/")
        t = _to_torch(leaf)
        if mod in _MHA_DENSE and leaf_name in ("kernel", "bias"):
            name = "weight" if leaf_name == "kernel" else "bias"
            state[f"{mod}.{name}"] = t.T.contiguous() if name == "weight" \
                else t
        elif mod == "lyr_nrm" and leaf_name in ("scale", "bias"):
            state[f"lyr_nrm.{'weight' if leaf_name == 'scale' else 'bias'}"] \
                = t
        else:
            raise KeyError(f"unexpected multi-head attention parameter "
                           f"{path!r}")
    return state


_RESNET_LEAF = {"scale": "weight", "mean": "running_mean",
                "var": "running_var"}


def resnet_params_from_jax(params_np: Mapping,
                           batch_stats_np: Optional[Mapping] = None
                           ) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` entries (CPU tensors) of a :class:`ResNet`
    holding the reference's ``params`` (with or without the outer
    ``{"params": ...}``) and, when given, its ``batch_stats``: module
    paths for tree paths, OIHW conv weights for HWIO kernels, BatchNorm
    ``weight`` / ``running_mean`` / ``running_var`` for ``scale`` /
    ``mean`` / ``var``."""
    state: Dict[str, torch.Tensor] = {}
    trees = [params_np.get("params", params_np)]
    if batch_stats_np is not None:
        trees.append(batch_stats_np.get("batch_stats", batch_stats_np))
    for tree in trees:
        for path, leaf in _flatten(tree).items():
            *mods, leaf_name = path.split("/")
            t = _to_torch(leaf)
            if t.ndim == 4:                      # HWIO -> OIHW
                t = t.permute(3, 2, 0, 1).contiguous()
            state[".".join(mods + [_RESNET_LEAF.get(leaf_name, leaf_name)])] \
                = t
    return state


def load_jax_resnet(model: ResNet, params_np: Mapping,
                    batch_stats_np: Optional[Mapping] = None) -> ResNet:
    """Copy the reference's ResNet parameters (and, when given, its
    ``batch_stats``) into ``model`` and return it. Strict: every
    parameter (and, with ``batch_stats``, every running statistic) is
    set and shapes must match."""
    state = resnet_params_from_jax(params_np, batch_stats_np)
    own = model.state_dict()
    wanted = set(own) if batch_stats_np is not None else {
        k for k in own if not k.endswith(("running_mean", "running_var"))}
    if set(state) != wanted:
        raise KeyError(f"reference ResNet params do not match the model: "
                       f"missing {sorted(wanted - set(state))}, unexpected "
                       f"{sorted(set(state) - wanted)}")
    for name, t in state.items():
        if own[name].shape != t.shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} from the "
                             f"reference, {tuple(own[name].shape)} in the "
                             "model")
    model.load_state_dict(state, strict=batch_stats_np is not None)
    return model


def _params_for(config, params_np: Mapping) -> Dict[str, torch.Tensor]:
    if isinstance(config, BertConfig):
        return bert_params_from_jax(params_np, config)
    if isinstance(config, T5Config):
        return t5_params_from_jax(params_np, config)
    if isinstance(config, ResNetConfig):
        return resnet_params_from_jax(params_np)
    return gpt_params_from_jax(params_np, config)


def load_jax_params(model: Union[GPTModel, BertModel, T5Model],
                    params_np: Mapping
                    ) -> Union[GPTModel, BertModel, T5Model]:
    """Copy the reference's parameters into ``model`` (a GPT, a BERT or a
    T5; strict: every parameter is set, shapes must match) and return
    it."""
    state = _params_for(model.config, params_np)
    own = model.state_dict()
    for name, t in state.items():
        if name in own and own[name].shape != t.shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} from the reference "
                             f"params, {tuple(own[name].shape)} in the model")
    model.load_state_dict(state, strict=True)
    return model


def load_jax_opt_state(state: FlatOptState,
                       config: Union[GPTConfig, BertConfig, ResNetConfig,
                                     T5Config],
                       opt_state_np: Mapping) -> FlatOptState:
    """Copy the reference's optimizer state into ``state`` (the port's,
    for a :class:`GPTModel`, :class:`BertModel` or :class:`ResNet` of
    ``config``, in either flat layout) and return it: FusedAdam's or
    FusedLAMB's slots ``m`` and ``v``, FusedSGD's or FusedLARS's
    ``momentum`` and ``initialized``, FusedAdagrad's ``h``,
    FusedNovoGrad's ``m`` and its per-leaf ``v``.

    ``opt_state_np`` holds ``"master"`` and each flat slot, each the
    reference's ``FlatOptState`` buffer unpacked through its space
    (``space.unpack(buf, dtype="buffer")``: the param tree with numpy
    leaves of the buffer's dtype; a bf16 master's cross as bf16 or their
    uint16 bits, into the port's bf16 master bit for bit), every 0-d slot as a number, every per-leaf slot (one
    value a leaf, ``(num_leaves,)``) as the param tree with that value at
    each leaf (``space.treedef.unflatten(list(v))``), and ``"count"``.
    The two flat layouts order (and, segmented, pad) their leaves
    differently, so each leaf goes by parameter name into its slot of
    the port's buffers, in place: parameters bound to the master see the
    loaded values. A per-leaf slot cannot be loaded from a reference
    built with ``scan_layers=True``: there one value covers a stacked
    leaf of all the layers, where the port keeps one a layer."""
    bufs = {"master": state.master, **state.slots}
    with torch.no_grad():
        for key, buf in bufs.items():
            if buf.ndim == 0:
                buf.fill_(float(np.asarray(opt_state_np[key])))
            elif buf.shape == state.master.shape:
                state.space.pack_into(
                    buf, _params_for(config, opt_state_np[key]))
            elif buf.shape == (state.space.num_leaves,):
                _load_per_leaf(buf, state, config, key, opt_state_np[key])
            else:
                raise ValueError(
                    f"slot {key!r} of shape {tuple(buf.shape)} is neither "
                    "0-d, flat nor one value a leaf")
    return state._replace(count=int(opt_state_np["count"]))


def _load_per_leaf(buf: torch.Tensor, state: FlatOptState, config,
                   key: str, tree: Mapping) -> None:
    """``buf[i]`` = the reference's value of the leaf named
    ``state.space.names[i]``, from ``tree`` (the param tree with one
    value a leaf)."""
    flat = _flatten(tree.get("params", tree))
    if any(p.startswith("layers/layer/") for p in flat):
        raise ValueError(
            f"slot {key!r}: a per-leaf slot of a scan_layers=True reference "
            "holds one value for a stacked leaf of all the layers; the "
            "port keeps one per layer (build the reference with "
            "scan_layers=False)")
    if any(np.size(v) != 1 for v in flat.values()):
        raise ValueError(f"slot {key!r}: a per-leaf slot takes one value "
                         "at each leaf")
    vals = _params_for(config, {p: np.asarray(v, np.float32).reshape(())
                                for p, v in flat.items()})
    buf.copy_(torch.stack([vals[name].reshape(()).float()
                           for name in state.space.names]))


def load_jax_dist_state(state, dist_state_np: Mapping):
    """Copy one device's shard of the reference's ZeRO state
    (``DistFlatOptState``, ``apex_tpu/contrib/optimizers``) into ``state``
    (the port's ``DistFlatOptState`` of the same rank, over the same
    parameters laid out alike) and return it.

    ``dist_state_np`` holds that device's ``"master"`` shard (a bf16
    one as bf16 or its uint16 bits, bit for bit), each slot's shard
    (``"m"``, ``"v"``), ``"count"``, ``"found_inf"`` and
    ``"l2_grad_norm"``, and optionally ``"leaf_ids"``: the shard's
    per-element leaf map, held against the port's (a shard of another
    layout, world or rank raises). The shards go into the port's
    buffers in place, so a LAMB state's windows see them."""
    ids = dist_state_np.get("leaf_ids")
    if ids is not None and not np.array_equal(np.asarray(ids),
                                              state.leaf_ids):
        raise ValueError("leaf_ids: the reference's shard is laid out "
                         "otherwise (another tree order, world or rank)")
    bufs = {"master": state.master, **state.slots}
    with torch.no_grad():
        for key, buf in bufs.items():
            src = _to_torch(dist_state_np[key])
            if src.shape != buf.shape:
                raise ValueError(f"{key!r}: a shard of shape "
                                 f"{tuple(src.shape)}, not "
                                 f"{tuple(buf.shape)}")
            buf.copy_(src.to(buf.dtype))
    dev = state.master.device

    def scalar(key):
        return torch.tensor(float(np.asarray(dist_state_np[key])),
                            dtype=torch.float32, device=dev)

    return state._replace(count=int(np.asarray(dist_state_np["count"])),
                          found_inf=scalar("found_inf"),
                          l2_grad_norm=scalar("l2_grad_norm"))


__all__ = ["bert_params_from_jax", "dcgan_params_from_jax",
           "gpt_params_from_jax", "load_jax_dist_state",
           "load_jax_opt_state", "load_jax_params", "load_jax_resnet",
           "resnet_params_from_jax", "t5_params_from_jax"]
