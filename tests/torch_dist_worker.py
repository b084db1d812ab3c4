"""Rank-side code of the multi-process parity tests
(tests/test_torch_{ddp,syncbn_dist,parallel_state,collectives,
ddp_examples,ddp_cuda,multiproc}.py).

Each function here runs in every rank of a world that
``apex_tpu_torch.parallel.multiproc.launch`` spawns (gloo over a file
rendezvous, so concurrent test workers never share a port), takes the
inputs of every rank (numpy, from the test's seed) and returns this
rank's results as numpy. It imports the port only: the reference runs
in the pytest process.
"""

import os

import torch
import torch.distributed as dist
from torch import nn

from apex_tpu_torch.parallel import (DistributedDataParallel, Reducer,
                                     SyncBatchNorm, convert_syncbn_model,
                                     multiproc, sync_deviation)
from apex_tpu_torch.transformer import parallel_state as ps


def _np(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().float().cpu().numpy()
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np(v) for v in tree]
    return tree


def _mine(tree, rank, dtype=torch.float32, device="cpu"):
    return {k: torch.tensor(v[rank], dtype=dtype, device=device)
            for k, v in tree.items()}


# -- DDP ---------------------------------------------------------------------


def ddp_cases(inp):
    """Every DistributedDataParallel / Reducer / sync_deviation case on
    this rank's gradients."""
    ps.initialize_model_parallel()
    r = dist.get_rank()
    out = {}
    for case, kw, dtype in (
            ("average", {}, torch.float32),
            ("sum", {"gradient_average": False}, torch.float32),
            ("predivide", {"gradient_predivide_factor": 2.0}, torch.float32),
            ("predivide_sum", {"gradient_predivide_factor": 2.0,
                               "gradient_average": False}, torch.float32),
            ("bf16", {}, torch.bfloat16),
            ("bf16_fp32", {"allreduce_always_fp32": True}, torch.bfloat16),
            ("groups", {"axis_index_groups": [[0, 1], [2, 3]]},
             torch.float32),
            ("bf16_groups", {"axis_index_groups": [[0, 1], [2, 3]]},
             torch.bfloat16)):
        g = _mine(inp["grads"], r, dtype)
        ddp = DistributedDataParallel(**kw)
        got = ddp.allreduce_grads(g)
        assert got is g and all(t.dtype == dtype for t in g.values())
        out[case] = _np(g)
    # one flat buffer, one collective: the PretrainStep path
    flat = torch.cat([torch.tensor(inp["grads"][k][r]).reshape(-1)
                      for k in sorted(inp["grads"])])
    DistributedDataParallel()(flat)
    out["flat"] = flat.numpy()
    red = _mine(inp["grads"], r)
    Reducer().reduce(red)
    out["reducer"] = _np(red)
    red = _mine(inp["grads"], r)
    Reducer().reduce(red, average=False)
    out["reducer_sum"] = _np(red)

    ddp = DistributedDataParallel(check_reduction=True)
    g = _mine(inp["grads"], r)
    out["dev_before"] = float(sync_deviation(g))
    ddp.allreduce_grads(g)
    out["dev_after"] = float(sync_deviation(g))
    out["check_good"] = float(ddp.check_synchronized(g))
    bad = dict(g, extra=torch.tensor(inp["grads"]["a"][r]))
    out["check_bad"] = float(ddp.check_synchronized(bad))
    nan = _mine(inp["grads"], r)
    if r == 1:
        nan["a"][0, 0] = float("nan")
    out["dev_nan"] = float(sync_deviation(nan))
    out["dev_groups"] = float(sync_deviation(
        _mine(inp["grads"], r), axis_index_groups=[[0, 1], [2, 3]]))
    ps.destroy_model_parallel()
    return out


# -- SyncBatchNorm -------------------------------------------------------------


def _bn_case(x, t, groups=None, fuse_relu=False):
    bn = SyncBatchNorm(x.shape[-1], axis_index_groups=groups,
                       fuse_relu=fuse_relu)
    with torch.no_grad():
        bn.weight.copy_(torch.linspace(0.5, 1.5, x.shape[-1]))
        bn.bias.copy_(torch.linspace(-0.2, 0.2, x.shape[-1]))
    x = torch.tensor(x, requires_grad=True)
    y = bn(x)
    (y * torch.tensor(t)).sum().backward()
    res = {"y": _np(y), "dx": _np(x.grad), "dw": _np(bn.weight.grad),
           "db": _np(bn.bias.grad), "mean": _np(bn.running_mean),
           "var": _np(bn.running_var)}
    with torch.no_grad():
        res["eval"] = _np(bn(x, use_running_stats=True))
    return res


def syncbn_cases(inp):
    """SyncBatchNorm forward, backward, running statistics, eval, fused
    ReLU and groups on this rank's shard; convert_syncbn_model; the
    tiny ResNet's step through the ImageNet example."""
    ps.initialize_model_parallel()
    r = dist.get_rank()
    x, t = inp["x"][r], inp["t"][r]
    out = {"plain": _bn_case(x, t),
           "groups": _bn_case(x, t, groups=[[0, 1], [2, 3]]),
           "relu": _bn_case(x, t, fuse_relu=True)}

    torch.manual_seed(0)
    seq = nn.Sequential(nn.Conv2d(3, 4, 3), nn.BatchNorm2d(4, momentum=0.2),
                        nn.ReLU(), nn.Flatten(), nn.Linear(4 * 4 * 4, 5),
                        nn.BatchNorm1d(5, eps=1e-3))
    seq.load_state_dict({k: torch.tensor(v)
                         for k, v in inp["seq_state"].items()})
    conv = convert_syncbn_model(seq)
    assert isinstance(conv[1], SyncBatchNorm) and not conv[1].channel_last
    assert conv[1].momentum == 0.2 and conv[5].eps == 1e-3
    y = conv(torch.tensor(inp["seq_x"][r]))
    out["convert"] = {"y": _np(y), "mean1": _np(conv[1].running_mean),
                      "var1": _np(conv[1].running_var),
                      "mean5": _np(conv[5].running_mean),
                      "var5": _np(conv[5].running_var)}

    from apex_tpu_torch.examples import imagenet_main_amp as ex
    args = ex.parse_args(["--arch", "tiny", "--sync-bn", "--opt-level", "O0",
                          "--steps", "1", "--batch-size",
                          str(inp["resnet_batch"])])
    res = ex.train(args, device="cpu",
                   state_dict={k: torch.tensor(v)
                               for k, v in inp["resnet_state"].items()})
    out["resnet"] = {"loss": res["losses"][0],
                     "state": _np(res["model"].state_dict())}
    ps.destroy_model_parallel()
    return out


# -- parallel_state ------------------------------------------------------------


def parallel_state_cases(configs):
    """For each (tp, pp, ep, cp): this rank's coordinates, sizes, and the
    sum of the ranks of each axis group (an all-reduce over the group)."""
    out = []
    for tp, pp, ep, cp in configs:
        ps.initialize_model_parallel(tp, pp, ep, cp)
        res = {
            "coords": dict(ps.get_mesh().coords),
            "sizes": {"data": ps.get_data_parallel_world_size(),
                      "tensor": ps.get_tensor_model_parallel_world_size(),
                      "pipe": ps.get_pipeline_model_parallel_world_size(),
                      "expert": ps.get_expert_model_parallel_world_size(),
                      "context": ps.get_context_parallel_world_size(),
                      "world": ps.get_world_size()},
            "ranks": {"data": ps.get_data_parallel_rank(),
                      "tensor": ps.get_tensor_model_parallel_rank(),
                      "pipe": ps.get_pipeline_model_parallel_rank(),
                      "expert": ps.get_expert_model_parallel_rank(),
                      "context": ps.get_context_parallel_rank()},
            "group_sums": {}}
        for axis in ps.AXES:
            group, ranks = ps.axis_group(axis)
            v = torch.tensor([float(dist.get_rank())])
            if group is not None:
                dist.all_reduce(v, group=group)
            res["group_sums"][axis] = (float(v), list(ranks))
        out.append(res)
        ps.destroy_model_parallel()
    return out


# -- collectives ---------------------------------------------------------------


def collective_ops(col, inp, rank, handler=None):
    """The Collective contract's ops on ``inp`` (the same sequence for a
    process collective and a LocalCollective handle)."""
    from apex_tpu_torch.resilience.guard import PreemptionHandler

    out = {"gather": [col.all_gather(a[rank]) for a in inp["gather"]],
           "bcast": col.broadcast_from(1, [a[rank] for a in inp["bcast"]])}
    col.barrier()
    out["any_none"] = col.agree_any(False)
    out["any_one"] = col.agree_any(rank == inp["flagged"])
    h = handler or PreemptionHandler()
    h.requested = rank == inp["flagged"]
    out["should_stop"] = h.should_stop(col)
    out["ids"] = (col.n_replicas, col.replica_id)
    return out


def collective_cases(inp):
    """``collective_ops`` over ProcessCollective, KVStoreCollective and
    process_collective() (instrumented), and a real SIGTERM drill."""
    import signal

    from apex_tpu_torch.resilience.guard import (KVStoreCollective,
                                                 PreemptionHandler,
                                                 ProcessCollective)
    from apex_tpu_torch.telemetry import comms

    r = dist.get_rank()
    out = {"process": collective_ops(ProcessCollective(), inp, r),
           "kvstore": collective_ops(KVStoreCollective(timeout=60), inp, r)}
    tracer = comms.enable()
    try:
        col = multiproc.process_collective()
        out["instrumented"] = collective_ops(col, inp, r)
        out["impl"] = col.impl_name()
        out["traced_ops"] = sorted(tracer.summary()["ops"])
        kv = comms.instrument(KVStoreCollective(timeout=60,
                                                prefix="kv_traced"))
        out["kv_instrumented"] = collective_ops(kv, inp, r)
    finally:
        comms.disable()
    with PreemptionHandler() as h:
        if r == inp["flagged"]:
            os.kill(os.getpid(), signal.SIGTERM)
        col = multiproc.process_collective()
        out["sigterm_local"] = h.requested
        out["sigterm_stop"] = h.should_stop(col)
    return out


# -- the examples --------------------------------------------------------------


def examples_case(inp):
    """The DDP example (its steps' losses and final master), the same
    with a SIGTERM to rank 1 at ``sigterm_step``, and the ImageNet
    example at --arch tiny --sync-bn for 6 steps, saved and resumed."""
    from apex_tpu_torch.examples import imagenet_main_amp, simple_ddp
    from apex_tpu_torch.resilience import faults

    r = dist.get_rank()
    ps.initialize_model_parallel()
    params = {k: torch.tensor(v) for k, v in inp["params"].items()}
    args = simple_ddp.parse_args(["--steps", str(inp["steps"])])
    res = simple_ddp.train(args, params=params, device="cpu")
    out = {"losses": res["losses"], "stopped_at": res["stopped_at"],
           "master": _np(master_by_name(res["state"]))}
    plan = ({"sigterm_steps": frozenset({inp["sigterm_step"]})}
            if r == 1 else {})
    with faults.inject(**plan):
        res = simple_ddp.train(
            simple_ddp.parse_args(["--steps", str(inp["steps"])]),
            params=params, device="cpu")
    out["sigterm"] = {"stopped_at": res["stopped_at"],
                      "losses": res["losses"]}
    ps.destroy_model_parallel()
    ck = inp["ckpt"]
    base = ["--arch", "tiny", "--batch-size", "16", "--sync-bn",
            "--opt-level", "O1", "--print-freq", "3"]
    out["imagenet"] = [
        imagenet_main_amp.main(base + ["--steps", "6", "--save", ck],
                               device="cpu")]
    dist.barrier()
    out["imagenet"].append(imagenet_main_amp.main(
        base + ["--steps", "8", "--resume", ck], device="cpu"))
    return out


def master_by_name(state):
    """The flat master of an optimizer state, by parameter name."""
    return state.space.unpack(state.master, dtype="buffer")


# -- on the card ---------------------------------------------------------------


def cuda_cases(inp):
    """Two ranks sharing the card over gloo: a CUDA flat buffer's
    all-reduce, SyncBatchNorm on CUDA tensors, and a few DDP steps of the
    FusedSGD kernel on the DDP example."""
    from apex_tpu_torch import _build
    from apex_tpu_torch.examples import simple_ddp

    dev = multiproc.device()
    r = dist.get_rank()
    ps.initialize_model_parallel()
    out = {}
    flat = torch.tensor(inp["flat"][r], device=dev)
    DistributedDataParallel(gradient_average=False)(flat)
    out["flat_sum"] = _np(flat)
    bn = SyncBatchNorm(inp["x"].shape[-1], device=dev)
    x = torch.tensor(inp["x"][r], device=dev, requires_grad=True)
    y = bn(x)
    (y * torch.tensor(inp["t"][r], device=dev)).sum().backward()
    out["bn"] = {"y": _np(y), "dx": _np(x.grad), "mean": _np(bn.running_mean),
                 "var": _np(bn.running_var)}
    devs = []
    _build.reset_launch_counts()
    res = simple_ddp.train(
        simple_ddp.parse_args(["--steps", str(inp["steps"])]), device=dev,
        on_step=lambda i, s, ss, loss: devs.append(float(sync_deviation(
            [s.master, s.slots["momentum"]]))))
    out["ddp"] = {"deviations": devs, "launches": _build.launch_counts(),
                  "master": _np(master_by_name(res["state"])),
                  "losses": res["losses"]}
    ps.destroy_model_parallel()
    return out


def failing_rank(bad_rank):
    """Raises on ``bad_rank`` after the world is up; returns the rank
    elsewhere."""
    if dist.get_rank() == bad_rank:
        raise ValueError(f"boom on rank {bad_rank}")
    return dist.get_rank()
