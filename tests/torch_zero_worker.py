"""Rank-side code of the ZeRO and sharded-norm parity tests
(tests/test_torch_zero.py, tests/test_torch_sharded_norms.py,
tests/test_torch_zero_cuda.py).

Each function runs in every rank of a world that
``apex_tpu_torch.parallel.multiproc.launch`` spawns (gloo over a file
rendezvous), takes the inputs of every rank (numpy, from the tests'
seeds: parameter trees, one gradient tree a rank, the reference's
states and GPT weights) and returns this rank's results as numpy. It
imports the port only: the reference runs in the pytest process.
"""

import numpy as np
import torch
import torch.distributed as dist

from apex_tpu_torch.contrib.clip_grad import clip_grad_norm_
from apex_tpu_torch.contrib.optimizers import (DistributedFusedAdam,
                                               DistributedFusedLAMB)
from apex_tpu_torch.models.convert import load_jax_dist_state
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.parallel.distributed import DistributedDataParallel
from apex_tpu_torch.transformer import parallel_state as ps

OPTS = {"adam": DistributedFusedAdam, "lamb": DistributedFusedLAMB}


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().cpu().numpy().copy()
    if isinstance(t, dict):
        return {k: _np(v) for k, v in t.items()}
    return t


def _dtype(name):
    return None if name is None else getattr(torch, name)


def _kw(kw):
    """Optimizer keywords with dtype names (they pickle) as dtypes."""
    return {k: _dtype(v) if k.endswith("dtype") else v
            for k, v in kw.items()}


def _tree(arrays, dtype="float32"):
    return {k: torch.tensor(np.asarray(v, np.float32)).to(_dtype(dtype))
            for k, v in arrays.items()}


def _mine(grads, r):
    return {k: torch.tensor(np.asarray(v[r], np.float32))
            for k, v in grads.items()}


def _shard(state):
    return {"master": _np(state.master),
            **{k: _np(v) for k, v in state.slots.items()},
            "count": int(state.count), "found_inf": float(state.found_inf),
            "l2": float(state.l2_grad_norm), "leaf_ids": state.leaf_ids}


def _run(case, r):
    """``case["steps"]`` steps of the case's optimizer on this rank's
    gradient tree (the same every step, as the reference's tests take
    it): the gathered parameters and this rank's shard after them."""
    opt = OPTS[case["opt"]](**_kw(case["kw"]))
    state = opt.init(_tree(case["params"], case.get("dtype", "float32")))
    g = _mine(case["grads"], r)
    p = None
    for _ in range(case["steps"]):
        p, state = opt.step(state, g, **case.get("step_kw", {}))
    out = {"params": _np(p), **_shard(state)}
    if case.get("wire"):
        out["wire"] = _wire_mean(state, g, _dtype(case["kw"]["grad_sync_dtype"]))
    return out


def _wire_mean(state, g, dtype):
    """The mean gradient as the wire gives it, by a reduce-scatter of its
    own (not the optimizer's): every rank's padded flat gradient in
    ``dtype``, summed over the data group, gathered, fp32, / world."""
    lay = state.layout
    full = torch.zeros(lay.padded_total)
    state.space.pack_into(full, g)
    part = torch.empty(lay.shard, dtype=dtype)
    dist.reduce_scatter_tensor(part, full.to(dtype))
    out = torch.empty(lay.padded_total, dtype=dtype)
    dist.all_gather_into_tensor(out, part)
    return _np(out.float()[:state.space.total] / lay.world)


def _l2(case, r):
    """``l2_grad_norm`` before a step and the step's own
    ``new_state.l2_grad_norm`` on the same gradients."""
    opt = OPTS[case["opt"]](**_kw(case["kw"]))
    state = opt.init(_tree(case["params"]))
    g = _mine(case["grads"], r)
    before = float(opt.l2_grad_norm(state, g, grad_scale=2.0))
    _, state = opt.step(state, g, grad_scale=2.0)
    return {"before": before, "after": float(state.l2_grad_norm)}


def _resume(case, r):
    """One step from the reference's state after its first steps
    (``load_jax_dist_state`` of this rank's shard)."""
    opt = OPTS[case["opt"]](**_kw(case["kw"]))
    state = opt.init(_tree(case["params"]))
    state = load_jax_dist_state(state, case["states"][r])
    p, state = opt.step(state, _mine(case["grads"], r))
    return {"params": _np(p), **_shard(state)}


def _ddp(case, r):
    """ZeRO-Adam against DDP + FusedAdam from the same parameters and
    gradients: the gathered master (every rank's shard in order) and
    DDP's master after each step, as bits."""
    params = _tree(case["params"])
    zopt = DistributedFusedAdam(**case["kw"])
    zstate = zopt.init(params)
    dopt = FusedAdam(**case["kw"])
    dstate = dopt.init(params)
    ddp = DistributedDataParallel()
    space = dstate.space
    out = []
    for g in case["grads"]:
        flat = space.pack(_mine(g, r), dtype=torch.float32)
        full, zstate = zopt.step_flat(zstate, flat.clone())
        red = flat.clone()
        ddp(red)
        _, dstate = dopt.step_flat(dstate, red)
        gathered = torch.empty(zstate.layout.padded_total)
        dist.all_gather_into_tensor(gathered, zstate.master)
        out.append({"zero": gathered[:space.total].numpy().view(np.uint32),
                    "zero_out": full[:space.total].numpy().view(np.uint32),
                    "ddp": dstate.master.numpy().view(np.uint32).copy()})
    return out


def _refusals(case, r):
    msgs = {}
    opt = DistributedFusedLAMB(lr=1e-2, clip_after_ar=False)
    state = opt.init(_tree(case["params"]))
    try:
        opt.step(state, _mine(case["grads"], r), grads_pre_synced=True)
    except ValueError as e:
        msgs["pre_synced"] = str(e)
    try:
        DistributedFusedAdam(lr=1e-3, master_dtype=torch.bfloat16,
                             stochastic_rounding=True).init(
            {"w": torch.ones(64, dtype=torch.bfloat16),
             "ln": torch.ones(8)})
    except ValueError as e:
        msgs["mixed"] = str(e)
    return msgs


def zero_world(inp):
    """Every ZeRO case at dp = world (the data axis is the shard axis)."""
    r = dist.get_rank()
    ps.initialize_model_parallel(1, 1)
    try:
        out = {"cases": {name: _run(case, r)
                         for name, case in inp["cases"].items()}}
        out["l2"] = _l2(inp["l2"], r)
        out["resume"] = _resume(inp["resume"], r)
        out["ddp"] = _ddp(inp["ddp"], r)
        out["refusals"] = _refusals(inp["refusals"], r)
        return out
    finally:
        ps.destroy_model_parallel()


# -- norms over a state cut on the model and pipe axes ------------------------


class Clipped:
    """``opt`` stepped through ``make_train_step(opt, max_grad_norm=...)``
    (the generic clip folded into grad_scale), for a step that calls
    ``step_flat``."""

    def __init__(self, opt, max_grad_norm):
        from apex_tpu_torch.optimizers import make_train_step

        self.opt = opt
        self.train_step = make_train_step(opt, max_grad_norm=max_grad_norm)

    def init(self, params):
        return self.opt.init(params)

    def step_flat(self, state, flat_grads, **kw):
        new_state, _ = self.train_step(state, flat_grads)
        return None, new_state


def _optimizer(name):
    from apex_tpu_torch.optimizers import (FusedLAMB, FusedLARS,
                                           FusedNovoGrad, FusedSGD)
    from apex_tpu_torch.parallel import LARC

    lamb = dict(lr=1e-3, weight_decay=0.01, max_grad_norm=1.0)
    return {
        "lamb": lambda: FusedLAMB(**lamb, segmented=False),
        "lamb_seg": lambda: FusedLAMB(**lamb, segmented=True),
        "novograd": lambda: FusedNovoGrad(lr=1e-3, weight_decay=0.01),
        "lars": lambda: FusedLARS(lr=1e-2, momentum=0.9, weight_decay=1e-4),
        "larc": lambda: LARC(FusedSGD(lr=1e-2, momentum=0.9,
                                      weight_decay=1e-4)),
        "adam_clip": lambda: Clipped(FusedAdam(lr=1e-3, weight_decay=0.01),
                                     0.5),
    }[name]()


def _mesh_train(inp, name, *, unreduced=False):
    """``inp["steps"]`` steps of the tiny GPT through
    ``make_gpt_pretrain_step`` on the live mesh with optimizer ``name``:
    the losses, this rank's parameters after step 1 and after the last,
    the replicated leaves after every step. ``unreduced`` drops the
    state's cross-rank norms (every norm this rank's part alone)."""
    from apex_tpu_torch import mesh as gmesh
    from apex_tpu_torch.models import (GPTConfig, GPTModel,
                                       make_gpt_pretrain_step)
    from apex_tpu_torch.models.convert import gpt_params_from_jax

    cfg = GPTConfig(**inp["cfg"])
    full = GPTModel(cfg, device="cpu", axis_name=None,
                    params=gpt_params_from_jax(inp["tree"], cfg))
    step, state = make_gpt_pretrain_step(
        cfg, _optimizer(name), schedule="1f1b", num_microbatches=2)(full)
    if unreduced:
        state = state._replace(norms=None)
    specs = step.plan.param_specs
    rep = [n for n in specs if not any(specs[n])]
    out = {"losses": [], "replicated": [], "plan": step.plan.detail()}
    for i in range(inp["steps"]):
        state, loss = step(state, inp["tokens"], inp["labels"])
        out["losses"].append(float(loss))
        params = {n: _np(p) for n, p in step.model.named_parameters()}
        if i == 0:
            out["step1"] = params
            if state.norms is not None:
                # the gradient's norm: the whole model's, and this
                # rank's part alone
                from apex_tpu_torch.multi_tensor import multi_tensor_l2norm

                out["gnorm"] = float(state.norms.global_norm(step.grad))
                out["gnorm_local"] = float(multi_tensor_l2norm(step.grad)[0])
        out["replicated"].append({n: params[n] for n in rep if n in params})
        # the tied embedding's copy on this pipe stage
        out.setdefault("tied", []).append(params.get("embedding.weight"))
    out["params"] = params
    out["coords"] = dict(gmesh.current_mesh().coords)
    out["specs"] = {n: tuple(s) for n, s in specs.items()}
    return out


def _helper_case(inp):
    """The replicated-once rule on a tree of split and replicated leaves:
    this rank's part of each (a split leaf's rows, a replicated leaf
    whole) through ``ShardedNorms``, and ``clip_grad_norm_`` of the flat
    buffer with ``norms``."""
    from apex_tpu_torch import mesh as gmesh
    from apex_tpu_torch.multi_tensor import FlatSpace

    mesh = gmesh.current_mesh()
    n, r = mesh.shape["model"], mesh.coords["model"]
    specs = {k: (("model",) if split else ()) for k, split in
             inp["split"].items()}
    plan = gmesh.ShardingPlan(mesh=mesh, param_specs=specs)
    mine = {k: torch.tensor(np.array_split(v, n)[r] if inp["split"][k]
                            else v) for k, v in inp["tree"].items()}
    space = FlatSpace.create(mine)
    norms = plan.norms(space)
    flat = space.pack(mine, dtype=torch.float32)
    leaf = norms.leaf_norms(_local(flat, space))
    total = float(norms.global_norm(flat))
    clipped, clip_norm = clip_grad_norm_(flat.clone(), inp["max_norm"],
                                         norms=norms)
    return {"leaf": {k: float(leaf[i]) for i, k in enumerate(space.names)},
            "total": total, "clip_norm": float(clip_norm),
            "clipped": {k: _np(v) for k, v in
                        space.unpack(clipped, dtype="buffer").items()}}


def _local(flat, space):
    from apex_tpu_torch.parallel.sharded_norms import local_leaf_sumsq

    return local_leaf_sumsq(flat, space)


def norms_world(inp):
    """Each optimizer of ``inp["optimizers"]`` through the mesh step at
    every layout of ``inp["layouts"]`` (keyword arguments of
    ``initialize_mesh``), 3 steps; the pipe layouts' run with the norms
    left unreduced (the fault the reduction repairs); the helper's
    case on the model layout."""
    from apex_tpu_torch import mesh as gmesh

    out = {}
    for label, mesh_kw in inp["layouts"].items():
        gmesh.initialize_mesh(**mesh_kw)
        try:
            res = {name: _mesh_train(inp, name)
                   for name in inp["optimizers"][label]}
            if mesh_kw.get("pipe", 1) > 1:
                res["lamb_unreduced"] = _mesh_train(inp, "lamb",
                                                    unreduced=True)
            if mesh_kw.get("model", 1) > 1 and "helper" in inp:
                res["helper"] = _helper_case(inp["helper"])
            out[label] = res
        finally:
            gmesh.destroy_mesh()
    return out


# -- the card -----------------------------------------------------------------


def cuda_world(inp):
    """Two ranks on one card over gloo: a tiny GPT (fp32, TF32 off) whose
    parameters are views into the flat buffer ZeRO gathers into, ZeRO-
    Adam against DDP + FusedAdam (the gathered master after each step, as
    bits) and ZeRO-LAMB against DDP + FusedLAMB stepped on the same
    gradients; the optimizer kernels
    launched; one bf16-master SR step against the plain SR of its fp32
    twin; then FusedLAMB (segmented) at tp=2 through the mesh step, the
    replicated leaves after every step and the whole model's gradient
    norm against one process's."""
    from apex_tpu_torch import _build
    from apex_tpu_torch import mesh as gmesh
    from apex_tpu_torch.models import (GPTConfig, GPTModel, gpt_loss_fn,
                                       gpt_param_specs,
                                       make_gpt_pretrain_step)
    from apex_tpu_torch.models.pretrain import PretrainStep
    from apex_tpu_torch.multi_tensor.engine import stochastic_round_cast
    from apex_tpu_torch.optimizers import FusedLAMB
    from apex_tpu_torch.parallel import multiproc

    dev = multiproc.device()
    torch.backends.cuda.matmul.allow_tf32 = False
    r, n = dist.get_rank(), dist.get_world_size()
    cfg = GPTConfig(**inp["cfg"])
    full = GPTModel(cfg, device="cpu", axis_name=None,
                    generator=torch.Generator().manual_seed(0))
    tokens = torch.tensor(inp["tokens"], device=dev)
    labels = torch.tensor(inp["labels"], device=dev)
    per = tokens.shape[0] // n
    x, y = tokens[r * per:(r + 1) * per], labels[r * per:(r + 1) * per]
    out = {}
    ps.initialize_model_parallel()
    try:
        for name, zcls, dcls, kw in (
                ("adam", DistributedFusedAdam, FusedAdam,
                 dict(lr=1e-3, weight_decay=0.01)),
                ("lamb", DistributedFusedLAMB, FusedLAMB,
                 dict(lr=1e-3, weight_decay=0.01, max_grad_norm=1.0))):
            model = GPTModel(cfg, device=dev, axis_name=None,
                             params=dict(full.named_parameters()))
            params = dict(model.named_parameters())
            opt = zcls(**kw)
            state = opt.init(params)
            space, lay = state.space, state.layout
            flat = torch.zeros(lay.padded_total, device=dev)
            space.pack_into(flat, params)
            grad = torch.zeros(space.total, device=dev)
            space.bind(model, flat[:space.total], grad)
            # LAMB's DDP side steps in lockstep on the same gradients: its
            # trust ratios differ by an ulp, and a second run would part
            # from the first where the forward meets the weights an ulp
            # apart
            lock = name == "lamb"
            if lock:
                dopt, ddp = dcls(**kw), DistributedDataParallel()
                st = dopt.init(params)
            zero, ref = [], []
            _build.reset_launch_counts()
            for _ in range(inp["steps"]):
                grad.zero_()
                gpt_loss_fn(model(x), y, axis_name=None).backward()
                if lock:
                    red = st.space.pack(space.unpack(grad, "buffer"))
                    ddp(red)
                    _, st = dopt.step_flat(st, red)
                    ref.append(space.pack(st.space.unpack(
                        st.master, "buffer")).cpu())
                _, state = opt.step_flat(state, grad, out=flat)
                zero.append(flat[:space.total].to("cpu", copy=True))
            launches = _build.launch_counts()
            if not lock:
                ddp = PretrainStep(
                    GPTModel(cfg, device=dev, axis_name=None,
                             params=dict(full.named_parameters())),
                    dcls(**kw), grad_reduce=DistributedDataParallel())
                st = ddp.init()
                for _ in range(inp["steps"]):
                    st, _ = ddp(st, x, y)
                    ref.append(space.pack(st.space.unpack(
                        st.master, "buffer")).cpu())
            out[name] = {"zero": zero, "ddp": ref, "launches": launches}
            if name == "lamb":
                # a bf16 master under SR and its fp32 twin, one step each
                bf = {k: v.detach().to(torch.bfloat16)
                      for k, v in params.items()}
                sr = zcls(**kw, master_dtype=torch.bfloat16,
                          stochastic_rounding=True)
                twin = zcls(**kw)
                s_sr, s_tw = sr.init(bf), twin.init(
                    {k: v.float() for k, v in bf.items()})
                _build.reset_launch_counts()
                _, s_sr = sr.step_flat(s_sr, grad)
                out["sr_launches"] = _build.launch_counts()
                _, s_tw = twin.step_flat(s_tw, grad)
                want = stochastic_round_cast(s_tw.master,
                                             s_sr.layout.rank, plain=True)
                out["sr_bitwise"] = bool(torch.equal(s_sr.master, want))
    finally:
        ps.destroy_model_parallel()
    # one process's gradient norm on the whole batch (the ranks in turn)
    dense = None
    for turn in range(n):
        if turn == r:
            m = GPTModel(cfg, device=dev, axis_name=None,
                         params=dict(full.named_parameters()))
            gpt_loss_fn(m(tokens), labels, axis_name=None).backward()
            dense = float(torch.sqrt(sum((p.grad.double() ** 2).sum()
                                         for p in m.parameters())))
            del m
        dist.barrier()
    gmesh.initialize_mesh(model=n)
    try:
        step, state = make_gpt_pretrain_step(
            cfg, FusedLAMB(lr=1e-3, weight_decay=0.01, max_grad_norm=1.0))(
            full, device=dev)
        specs = gpt_param_specs(step.model)
        rep = [k for k, s in specs.items() if not s]
        reps, norm = [], None
        for i in range(inp["steps"]):
            state, _ = step(state, tokens, labels)
            if i == 0:
                norm = float(state.norms.global_norm(step.grad))
            reps.append({k: _np(p) for k, p in step.model.named_parameters()
                         if k in rep})
        out["tp"] = {"replicated": reps, "norm": norm, "dense_norm": dense}
    finally:
        gmesh.destroy_mesh()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return out
