"""Convert the reference's GPT and BERT parameters (and their optimizer
state) into the port's ``GPTModel`` / ``BertModel`` (and
``FlatOptState``).

The input is the parameter tree of the reference's ``GPTModel``
(``apex_tpu/models/gpt.py``) or ``BertModel`` (``apex_tpu/models/bert.py``)
with numpy leaves, with or without the outer ``{"params": ...}``. Both
layer layouts are read:

- ``scan_layers=True``: one ``layers/layer/...`` subtree whose leaves
  carry a leading layer axis;
- ``scan_layers=False``: one ``layer_{i}/...`` subtree per layer.

No leaf is transposed: the parallel linears keep the reference's
``(out, in)`` layout and BERT's pooler, LM-head dense and binary head its
``(in, out)`` one, as the port's modules expect; the reference's
LayerNorm ``scale`` becomes ``weight``.
bf16 leaves (numpy's ``bfloat16`` from ml_dtypes, or their raw
``uint16`` bits) cross as uint16 views and come out as
``torch.bfloat16``. A missing or an extra key, or a shape that does not
fit the config, raises.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Union

import numpy as np
import torch

from apex_tpu_torch.models.bert import BertConfig, BertModel
from apex_tpu_torch.models.gpt import GPTConfig, GPTModel
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


def _params_from_jax(params_np: Mapping, num_layers: int,
                     top_keys: Mapping[str, str], layer_keys: Mapping[str, str],
                     family: str) -> Dict[str, torch.Tensor]:
    tree = params_np.get("params", params_np)
    flat = _flatten(tree)
    scanned = any(k.startswith("layers/layer/") for k in flat)
    wanted: Dict[str, str] = dict(top_keys)
    if scanned:
        for name, path in layer_keys.items():
            wanted[f"layers.*.{name}"] = f"layers/layer/{path}"
    else:
        for i in range(num_layers):
            for name, path in layer_keys.items():
                wanted[f"layers.{i}.{name}"] = f"layer_{i}/{path}"
    missing = sorted(p for p in wanted.values() if p not in flat)
    extra = sorted(set(flat) - set(wanted.values()))
    if missing or extra:
        raise KeyError(f"reference {family} params do not match the config: "
                       f"missing {missing}, unexpected {extra}")
    state: Dict[str, torch.Tensor] = {}
    for name, path in wanted.items():
        t = _to_torch(flat[path])
        if "*" in name:
            if t.shape[0] != num_layers:
                raise ValueError(
                    f"{path}: leading layer axis {t.shape[0]}, config has "
                    f"{num_layers} layers")
            for i in range(num_layers):
                state[name.replace("*", str(i))] = t[i]
        else:
            state[name] = t
    return state


def gpt_params_from_jax(params_np: Mapping, config: GPTConfig
                        ) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of a :class:`GPTModel` of ``config`` holding
    the reference's parameters ``params_np`` (CPU tensors)."""
    return _params_from_jax(params_np, config.num_layers, _TOP_KEYS,
                            _LAYER_KEYS, "GPT")


def bert_params_from_jax(params_np: Mapping, config: BertConfig
                         ) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of a :class:`BertModel` of ``config`` holding
    the reference's parameters ``params_np`` (CPU tensors)."""
    return _params_from_jax(params_np, config.num_layers,
                            _bert_top_keys(config), _BERT_LAYER_KEYS, "BERT")


def _params_for(config, params_np: Mapping) -> Dict[str, torch.Tensor]:
    if isinstance(config, BertConfig):
        return bert_params_from_jax(params_np, config)
    return gpt_params_from_jax(params_np, config)


def load_jax_params(model: Union[GPTModel, BertModel],
                    params_np: Mapping) -> Union[GPTModel, BertModel]:
    """Copy the reference's parameters into ``model`` (a GPT or a BERT;
    strict: every parameter is set, shapes must match) and return it."""
    state = _params_for(model.config, params_np)
    own = model.state_dict()
    for name, t in state.items():
        if name in own and own[name].shape != t.shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} from the reference "
                             f"params, {tuple(own[name].shape)} in the model")
    model.load_state_dict(state, strict=True)
    return model


def load_jax_opt_state(state: FlatOptState,
                       config: Union[GPTConfig, BertConfig],
                       opt_state_np: Mapping) -> FlatOptState:
    """Copy the reference's FusedAdam or FusedLAMB state (both keep the
    slots ``m`` and ``v``) into ``state`` (the port's, for a
    :class:`GPTModel` or :class:`BertModel` of ``config``, in either flat
    layout) and return it.

    ``opt_state_np`` holds ``"master"``, ``"m"`` and ``"v"``, each the
    reference's ``FlatOptState`` buffer unpacked through its space
    (``space.unpack(buf, dtype="buffer")``: the param tree with fp32
    numpy leaves), and ``"count"``. The two flat layouts order (and,
    segmented, pad) their leaves differently, so each leaf goes by
    parameter name into its slot of the port's buffers, in place:
    parameters bound to the master see the loaded values."""
    bufs = {"master": state.master, **state.slots}
    for key in ("master", "m", "v"):
        named = _params_for(config, opt_state_np[key])
        state.space.pack_into(bufs[key], named)
    return state._replace(count=int(opt_state_np["count"]))


__all__ = ["bert_params_from_jax", "gpt_params_from_jax",
           "load_jax_opt_state", "load_jax_params"]
