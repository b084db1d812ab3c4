"""Rank-side code of the tensor-parallel parity tests
(tests/test_torch_{tensor_parallel,mesh,tp_cuda}.py).

Each function runs in every rank of a world that
``apex_tpu_torch.parallel.multiproc.launch`` spawns (gloo over a file
rendezvous), takes the inputs of every rank (numpy, from the test's
seed; full-size weights in the port's names or the reference's tree as
numpy) and returns this rank's results as numpy. It imports the port
only: the reference runs in the pytest process.
"""

import contextlib

import numpy as np
import torch
import torch.distributed as dist

from apex_tpu_torch import mesh as gmesh
from apex_tpu_torch.models import (BertConfig, BertModel, GPTConfig,
                                   GPTModel, T5Config, T5Model, gpt_loss_fn,
                                   gpt_param_specs, gpt_shard_from_jax,
                                   make_gpt_pretrain_step)
from apex_tpu_torch.models.convert import gpt_params_from_jax
from apex_tpu_torch.optimizers import FusedAdam, FusedLAMB, FusedNovoGrad
from apex_tpu_torch.serving import KVCache, make_decode_step
from apex_tpu_torch.transformer import parallel_state as ps
from apex_tpu_torch.transformer import tensor_parallel as tp
from apex_tpu_torch.transformer.parallel_state import TENSOR_AXIS


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().cpu().numpy()
    if isinstance(t, dict):
        return {k: _np(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return [_np(v) for v in t]
    return t


def _t(a, dtype=torch.float32, grad=False):
    return torch.tensor(np.asarray(a), dtype=dtype, requires_grad=grad)


def _load(layer, full):
    """Copy this rank's shard of the full weights ``full`` (numpy, by
    parameter name) into ``layer``."""
    ax = layer.axis
    specs = {"weight": layer.weight_spec if hasattr(layer, "weight_spec")
             else tp.vocab_embedding_spec(),
             "bias": getattr(layer, "bias_spec", ())}
    with torch.no_grad():
        for n, p in layer.named_parameters():
            p.copy_(tp.shard_tensor(torch.tensor(full[n]), specs[n],
                                    {TENSOR_AXIS: ax.size},
                                    {TENSOR_AXIS: ax.index}))


def _grads(layer):
    return {n: _np(p.grad) for n, p in layer.named_parameters()}


# -- mappings, layers, cross entropy ----------------------------------------


MAPPINGS = {
    "copy": tp.copy_to_tensor_model_parallel_region,
    "reduce": tp.reduce_from_tensor_model_parallel_region,
    "scatter": tp.scatter_to_tensor_model_parallel_region,
    "gather": tp.gather_from_tensor_model_parallel_region,
    "scatter_seq": tp.scatter_to_sequence_parallel_region,
    "gather_seq": tp.gather_from_sequence_parallel_region,
    "gather_seq_split": lambda x: tp.gather_from_sequence_parallel_region(
        x, tensor_parallel_output_grad=False),
    "reduce_scatter_seq": tp.reduce_scatter_to_sequence_parallel_region,
}


def _mapping_cases(inp, r):
    out = {}
    for name, op in MAPPINGS.items():
        for dt in ("float32", "bfloat16"):
            dtype = getattr(torch, dt)
            x = _t(inp["map_x"][r], dtype, grad=True)
            y = op(x)
            y.backward(_t(inp["map_g"][name][r], dtype))
            assert y.dtype == dtype and x.grad.dtype == dtype
            out[f"{name}_{dt}"] = {"y": _np(y), "dx": _np(x.grad)}
    return out


def _column_cases(inp):
    w = inp["col"]
    out = {}
    for gather in (True, False):
        layer = tp.ColumnParallelLinear(16, 32, gather_output=gather,
                                        device="cpu")
        _load(layer, w)
        x = _t(inp["col_x"], grad=True)
        y = layer(x)
        out[f"gather{int(gather)}"] = _np(y)
        if gather:
            (y * _t(inp["col_t"])).sum().backward()
            out["grads"] = _grads(layer)
            out["dx"] = _np(x.grad)
    layer = tp.ColumnParallelLinear(16, 32, gather_output=False,
                                    skip_bias_add=True, device="cpu")
    _load(layer, w)
    y, b = layer(_t(inp["col_x"]))
    out["skip_bias"] = {"y": _np(y), "b": _np(b)}
    return out


def _row_cases(inp):
    w = inp["row"]
    out = {}
    for parallel in (False, True):
        layer = tp.RowParallelLinear(32, 24, input_is_parallel=parallel,
                                     device="cpu")
        _load(layer, w)
        x = _t(inp["row_x"])
        if parallel:
            x = tp.scatter_to_tensor_model_parallel_region(x)
        x.requires_grad_(True)
        y = layer(x)
        (y * _t(inp["row_t"])).sum().backward()
        out[f"parallel{int(parallel)}"] = {"y": _np(y),
                                           "grads": _grads(layer)}
    # the fp32 reduction in bf16 (and the compute-dtype one beside it)
    for fp32 in (True, False):
        layer = tp.RowParallelLinear(512, 32, input_is_parallel=False,
                                     use_bias=False, reduce_in_fp32=fp32,
                                     param_dtype=torch.bfloat16,
                                     device="cpu")
        with torch.no_grad():
            ax = layer.axis
            layer.weight.copy_(tp.shard_tensor(
                torch.tensor(inp["w64"], dtype=torch.bfloat16),
                tp.row_kernel_spec(), {TENSOR_AXIS: ax.size},
                {TENSOR_AXIS: ax.index}))
            out[f"fp32_{fp32}"] = _np(layer(_t(inp["x64"],
                                                torch.bfloat16)))
    return out


def _block_cases(inp):
    out = {}
    for sp in (False, True):
        col = tp.ColumnParallelLinear(16, 64, gather_output=False,
                                      sequence_parallel_enabled=sp,
                                      device="cpu")
        row = tp.RowParallelLinear(64, 16, sequence_parallel_enabled=sp,
                                   device="cpu")
        _load(col, inp["mlp_col"])
        _load(row, inp["mlp_row"])
        x = _t(inp["sp_x"] if sp else inp["mlp_x"])
        if sp:
            x = tp.scatter_to_sequence_parallel_region(x)
        x.requires_grad_(True)
        y = row(torch.nn.functional.gelu(col(x), approximate="tanh"))
        y.sum().backward()
        out[f"sp{int(sp)}"] = {"y": _np(y), "dx": _np(x.grad),
                               "col": _grads(col), "row": _grads(row)}
    # the functional core: copy (or the sequence gather) and the product
    x = _t(inp["mlp_x"], grad=True)
    w = _t(inp["mlp_col"]["weight"])
    ax = tp.tensor_axis()
    w_mine = tp.shard_tensor(w, tp.column_kernel_spec(),
                             {TENSOR_AXIS: ax.size}, {TENSOR_AXIS: ax.index})
    y = tp.linear_with_grad_accumulation_and_async_allreduce(x, w_mine)
    y.sum().backward()
    out["functional"] = {"y": _np(y), "dx": _np(x.grad)}
    return out


def _embedding_cases(inp):
    emb = tp.VocabParallelEmbedding(64, 16, device="cpu")
    _load(emb, inp["emb"])
    y = emb(torch.tensor(inp["emb_ids"]))
    (y * _t(inp["emb_t"])).sum().backward()
    return {"y": _np(y), "grad": _np(emb.weight.grad)}


def _xent_cases(inp, r, n):
    out = {}
    per = inp["ce_logits"].shape[-1] // n
    mine = slice(r * per, (r + 1) * per)
    for name, tgt in (("in_range", inp["ce_target"]),
                      ("out_of_range", inp["ce_target_oob"])):
        for s in (0.0, 0.1):
            logits = _t(inp["ce_logits"][..., mine], grad=True)
            loss = tp.vocab_parallel_cross_entropy(
                logits, torch.tensor(tgt), label_smoothing=s)
            loss.sum().backward()
            out[f"{name}_{s}"] = {"loss": _np(loss), "grad": _np(logits.grad)}
    return out


def tp_world(inp):
    """Every mapping, layer and cross-entropy case at tp = world."""
    n, r = dist.get_world_size(), dist.get_rank()
    ps.initialize_model_parallel(n)
    try:
        return {"mappings": _mapping_cases(inp, r),
                "column": _column_cases(inp), "row": _row_cases(inp),
                "block": _block_cases(inp),
                "embedding": _embedding_cases(inp),
                "xent": _xent_cases(inp, r, n)}
    finally:
        ps.destroy_model_parallel()


# -- GPT, the mesh step, serving -------------------------------------------


def _gpt_loss_and_grads(cfg_kw, tree, tokens, labels, grad=True):
    """The loss (and every gradient) of this rank's shard, loaded from
    the reference's tree through ``gpt_shard_from_jax``."""
    cfg = GPTConfig(**cfg_kw)
    model = GPTModel(cfg, device="cpu")
    ax = model.axis
    model.load_state_dict(gpt_shard_from_jax(
        tree, cfg, gpt_param_specs(model), ax.index, ax.size))
    scope = contextlib.nullcontext() if grad else torch.no_grad()
    with scope:
        loss = gpt_loss_fn(model(torch.tensor(tokens)), torch.tensor(labels),
                           axis_name=model.axis)
    out = {"loss": float(loss)}
    if grad:
        loss.backward()
        out["grads"] = {n: _np(p.grad) for n, p in model.named_parameters()}
    return out


def _train(cfg_kw, ref_tree, tokens, labels, steps, lr):
    cfg = GPTConfig(**cfg_kw)
    full = GPTModel(cfg, device="cpu", axis_name=None,
                    params=gpt_params_from_jax(ref_tree, cfg))
    step, state = make_gpt_pretrain_step(cfg, FusedAdam(lr=lr))(full)
    assert isinstance(step, gmesh.MeshTrainStep)
    losses, replicated = [], []
    names = [n for n, s in gpt_param_specs(step.model).items() if not s]
    for _ in range(steps):
        state, loss = step(state, tokens, labels)
        losses.append(float(loss))
        replicated.append({n: _np(p) for n, p in
                           step.model.named_parameters() if n in names})
    return {"losses": losses, "replicated": replicated,
            "params": {n: _np(p) for n, p in step.model.named_parameters()},
            "plan": step.plan.detail()}


def _raises(fn, exc):
    try:
        fn()
    except exc as e:
        return str(e)
    return None


def _raise_cases(cfg_kw, ref_tree, tokens, labels):
    cfg = GPTConfig(**cfg_kw)
    state = gpt_params_from_jax(ref_tree, cfg)
    out = {}
    drop = GPTConfig(**{**cfg_kw, "attention_dropout": 0.1})
    m = GPTModel(drop, device="cpu", params=state)
    out["attention_dropout"] = _raises(lambda: m(
        torch.tensor(tokens), deterministic=False,
        dropout_key=(0, 1)),
        NotImplementedError)
    sp = GPTConfig(**{**cfg_kw, "sequence_parallel": True})
    m = GPTModel(sp, device="cpu", params=state)
    out["sp_training"] = _raises(lambda: m(torch.tensor(tokens)),
                                 NotImplementedError)
    full = GPTModel(cfg, device="cpu", axis_name=None, params=state)
    out["bert"] = _raises(lambda: BertModel(BertConfig(
        vocab_size=64, max_seq_len=16, hidden_size=32, num_layers=1,
        num_heads=4), device="cpu"), NotImplementedError)
    out["t5"] = _raises(lambda: T5Model(T5Config(
        vocab_size=64, max_seq_len=16, hidden_size=32, num_encoder_layers=1,
        num_decoder_layers=1, num_heads=4), device="cpu"),
        NotImplementedError)
    # the optimizers whose norms span the tensor group run (A 9h): step
    # 1's loss
    for name, opt in (("lamb", FusedLAMB(lr=1e-3, max_grad_norm=1.0)),
                      ("novograd", FusedNovoGrad(lr=1e-3))):
        step, st = make_gpt_pretrain_step(cfg, opt)(full)
        out[name] = float(step(st, tokens, labels)[1])
    return out


def _decode(cfg_kw, ref_tree, prompt, new_tokens):
    """The reference's TestServingSharded stream on this rank's shard:
    the checkpoint through ``shard_params_for_serving``, a full pool cut
    by ``shard_kv_pool`` (the same shape as the pool ``KVCache``
    sizes at this tp)."""
    cfg = GPTConfig(**cfg_kw)
    full = gpt_params_from_jax(ref_tree, cfg)
    model = GPTModel(cfg, device="cpu")
    model.load_state_dict(gmesh.annotate.shard_params_for_serving(full))
    cache = KVCache.for_config(cfg, num_blocks=16, block_size=8,
                               device="cpu")
    state = gmesh.annotate.shard_kv_pool(KVCache.for_config(
        cfg, num_blocks=16, block_size=8, device="cpu",
        axis_name=None).init_state())
    assert state.k.shape == cache.init_state().k.shape
    step = make_decode_step(model, cache)
    b, s = prompt.shape
    for i in range(b):
        cache.allocate(i, s + new_tokens + 1)
    tables = cache.table_array(list(range(b)), width=4)
    lengths = np.full(b, s, np.int64)
    out = step.prefill(state, prompt, lengths, tables)
    tok, toks = out.next_token, [_np(out.next_token)]
    pos = lengths.copy()
    for _ in range(new_tokens):
        out = step.decode(out.cache, tok, pos, tables)
        tok = out.next_token
        toks.append(_np(tok))
        pos = pos + 1
    return {"tokens": np.stack(toks), "kv_heads": int(state.k.shape[3]),
            "logits": _np(out.logits)}


def mesh_world(inp):
    """The GPT cases at tp = world (forward and gradients on each config,
    the sequence-parallel loss), the mesh step at each layout of
    ``inp["train_layouts"]``, the sharded greedy decode, the raises, the
    mesh's lifecycle and each plan's detail."""
    n = dist.get_world_size()
    out = {"gpt": {}, "train": {}}
    gmesh.initialize_mesh(model=n)
    try:
        for name, case in inp["gpt"].items():
            out["gpt"][name] = _gpt_loss_and_grads(
                case["cfg"], case["tree"], inp["tokens"], inp["labels"],
                grad=not case["cfg"].get("sequence_parallel", False))
        # the shard a model draws from a generator is the tp=1 draw cut
        gen = GPTModel(GPTConfig(**inp["draw_cfg"]), device="cpu",
                       generator=torch.Generator().manual_seed(5))
        out["drawn"] = {k: _np(v) for k, v in gen.state_dict().items()}
        out["decode"] = _decode(inp["decode"]["cfg"], inp["decode"]["tree"],
                                inp["prompt"], inp["new_tokens"])
    finally:
        gmesh.destroy_mesh()
    for label, mesh_kw in inp["train_layouts"].items():
        gmesh.initialize_mesh(**mesh_kw)
        try:
            if "raises" not in out:
                out["raises"] = _raise_cases(
                    inp["train"]["cfg"], inp["train"]["tree"],
                    inp["tokens_train"], inp["labels_train"])
            out["train"][label] = _train(
                inp["train"]["cfg"], inp["train"]["tree"],
                inp["tokens_train"], inp["labels_train"], inp["steps"],
                inp["lr"])
        finally:
            gmesh.destroy_mesh()
    # lifecycle: the default batch, a bad factorization, pipe > 1
    life = {"fresh": gmesh.axis_sizes()}
    gmesh.initialize_mesh(model=2)
    life["model2"] = gmesh.axis_sizes()
    life["size"] = gmesh.mesh_size()
    life["coords"] = gmesh.current_mesh().coords
    gmesh.destroy_mesh()
    life["destroyed"] = (gmesh.mesh_initialized(), gmesh.mesh_size())
    life["bad"] = _raises(lambda: gmesh.initialize_mesh(model=3), ValueError)
    life["bad3"] = _raises(lambda: gmesh.initialize_mesh(
        batch=2, model=2, pipe=3), ValueError)
    gmesh.initialize_mesh(batch=n // 2, pipe=2)
    try:
        cfg = GPTConfig(**inp["train"]["cfg"])
        full = GPTModel(cfg, device="cpu", axis_name=None)
        # a pipe axis takes the pipelined step; the one-stage step refuses it
        life["pipe"] = _raises(lambda: gmesh.make_mesh_train_step(
            full, FusedAdam(lr=1e-3), gmesh.plan_gpt(full)),
            NotImplementedError)
    finally:
        gmesh.destroy_mesh()
    out["life"] = life
    return out


# -- the card -----------------------------------------------------------------


def cuda_world(inp):
    """Two ranks on one card over gloo: a tiny GPT at tp=2 through the
    mesh step, the replicated leaves bitwise across the ranks after
    every step, the flash and LayerNorm kernels launched on each rank;
    the first loss against one rank's tp=1 loss on the same card."""
    from apex_tpu_torch import _build
    from apex_tpu_torch.parallel import multiproc

    dev = multiproc.device()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = GPTConfig(**inp["cfg"])
    full = GPTModel(cfg, device="cpu", axis_name=None,
                    generator=torch.Generator().manual_seed(0))
    tokens = torch.tensor(inp["tokens"], device=dev)
    labels = torch.tensor(inp["labels"], device=dev)
    one = GPTModel(cfg, device=dev, axis_name=None,
                   params=dict(full.named_parameters()))
    with torch.no_grad():
        tp1 = float(gpt_loss_fn(one(tokens), labels, axis_name=None))
    gmesh.initialize_mesh(model=2)
    try:
        step, state = make_gpt_pretrain_step(cfg, FusedAdam(lr=1e-3))(
            full, device=dev)
        names = [n for n, s in gpt_param_specs(step.model).items() if not s]
        losses, reps = [], []
        _build.reset_launch_counts()
        for _ in range(inp["steps"]):
            state, loss = step(state, tokens, labels)
            losses.append(float(loss))
            reps.append({n: _np(p) for n, p in step.model.named_parameters()
                         if n in names})
        torch.cuda.synchronize()
        return {"tp1": tp1, "losses": losses, "replicated": reps,
                "launches": _build.launch_counts()}
    finally:
        gmesh.destroy_mesh()
