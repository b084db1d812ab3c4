"""The port's pipeline schedules against the reference's
(``tests/test_mesh_pipeline.py``, class by class).

The reference runs in this process on its forced 8-device CPU mesh, with
that file's tiny configs and seeds; the port in one world of 2 and one
of 4 gloo processes (``torch_pp_worker.pp_world``, one spawn a world),
each rank holding its stage, and in this process with the pipe group of
one rank, where every stage row runs locally. Every side gets the
reference's initial weights (``models.convert``).

Tolerances: every loss within rtol 2e-5 of the reference's (its own
parity bound); gpipe's loss equal to 1f1b's bitwise, and a schedule's
loss bitwise repeatable; the parameters after 3 FusedAdam steps within
``tests/test_torch_mesh.py``'s bounds (rtol 1e-4, atol 2e-6; the key
bias, whose exact gradient is 0, within 2 x steps x lr); at tp=2 x pp=2
the loss within rtol 2e-4 of the dense reference's and every gradient
(the tensor ranks' shards put together) within rtol 2e-3, atol 2e-5,
again ``test_torch_mesh.py``'s. The two copies of the tied embedding are
bitwise equal after every step; the gauges, the info blob (less its
wall-clock fields), the spans' names and arguments and the ledger's
``ppermute`` op, payload and wire bytes equal the reference's.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import mesh as ref_mesh
from apex_tpu import telemetry as ref_telemetry
from apex_tpu.mesh.pipeline import PipelineSpec as RefSpec
from apex_tpu.mesh.pipeline import \
    make_mesh_pipeline_train_step as ref_make_step
from apex_tpu.mesh.pipeline import make_pipeline_loss_fn as ref_loss_fn
from apex_tpu.models.gpt import GPTConfig as RefConfig
from apex_tpu.models.gpt import GPTModel as RefGPT
from apex_tpu.models.gpt import gpt_loss_fn as ref_gpt_loss
from apex_tpu.optimizers import FusedAdam as RefAdam
from apex_tpu.telemetry import comms as ref_comms
from apex_tpu.telemetry import metrics as ref_metrics
from apex_tpu.telemetry import timeline as ref_timeline

import torch_pp_worker
from apex_tpu_torch import mesh as gmesh
from apex_tpu_torch.mesh import Mesh
from apex_tpu_torch.mesh.pipeline import (SCHEDULES, MeshPipelineTrainStep,
                                          PipelineSpec, bubble_fraction,
                                          make_mesh_pipeline_train_step,
                                          make_pipeline_loss_fn, rank_order,
                                          stage_param_names, tick_plan)
from apex_tpu_torch.models import GPTConfig, GPTModel, gpt_param_specs
from apex_tpu_torch.models.convert import gpt_params_from_jax
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.parallel import multiproc
from apex_tpu_torch.transformer import parallel_state as ps

LOSS_RTOL = 2e-5


def tiny_kw(layers=4):
    return dict(vocab_size=64, max_seq_len=16, hidden_size=32,
                num_layers=layers, num_heads=4)


def _ref_cfg(layers=4):
    return RefConfig(dtype=jnp.float32, softmax_impl="xla",
                     **tiny_kw(layers))


def _port_cfg(layers=4):
    return dict(tiny_kw(layers), dtype=torch.float32,
                param_dtype=torch.float32)


def tiny_data(batch=4, seq=16, vocab=64, seed=7):
    toks = np.random.RandomState(seed).randint(0, vocab, (batch, seq + 1))
    toks = toks.astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


def _tree(layers, key, x):
    return jax.tree.map(np.asarray, RefGPT(_ref_cfg(layers)).init(
        jax.random.PRNGKey(key), jnp.asarray(x)))


# the reference file's cases: (layers, key, batch, seed)
PARITY = (4, 0, 4, 7)
STEP = (2, 1, 8, 7)
ASYNC = (2, 0, 4, 3)
INTERLEAVED = (4, 0, 4, 5)
PP4 = (4, 2, 8, 9)
SPECS = {"gpipe": ("gpipe", 2, 2), "1f1b": ("1f1b", 2, 2),
         "1f1b_m4": ("1f1b", 2, 4),
         "interleaved": ("interleaved_1f1b", 2, 2, 2)}
STEPS, LR = 3, 1e-3


def _case(which, **kw):
    layers, key, batch, seed = which
    x, y = tiny_data(batch=batch, seed=seed)
    return dict(cfg=_port_cfg(layers), tree=_tree(layers, key, x), tokens=x,
                labels=y, **kw)


@pytest.fixture(scope="module")
def cases():
    return {
        "parity": _case(PARITY, specs=SPECS),
        "step": _case(STEP, schedule="1f1b", m=2, chunks=1, steps=STEPS,
                      lr=LR),
        "async": _case(ASYNC, schedule="async_1f1b", m=2, chunks=1, steps=6,
                       lr=2e-3),
        "interleaved": _case(INTERLEAVED, schedule="interleaved_1f1b", m=2,
                             chunks=2, steps=5, lr=2e-3),
        "pp4": _case(PP4, schedule="1f1b", m=4, chunks=1, steps=1, lr=LR),
        "tp": _case(PARITY, schedule="1f1b", m=2, lr=LR),
        "shard": _case(INTERLEAVED, spec=("interleaved_1f1b", 2, 2, 2)),
    }


# -- the reference ------------------------------------------------------------


def _ref_model_params(case, layers):
    return RefGPT(_ref_cfg(layers)), jax.tree.map(jnp.asarray, case["tree"])


@pytest.fixture(scope="module")
def reference(cases, launched):
    """Every number the port is held to, from the reference: each sync
    schedule's loss and the plain loss at pp=2; the 1f1b step's 3 losses,
    parameters and telemetry (then a step from pre-sharded params); the
    async losses over 6 steps and after a reset; the interleaved
    losses; the pp=4 case's plain loss; the dense gradient of the tp
    case."""
    out = {}
    ref_mesh.destroy_mesh()
    c = cases["parity"]
    model, params = _ref_model_params(c, 4)
    x, y = jnp.asarray(c["tokens"]), jnp.asarray(c["labels"])
    out["plain"] = float(ref_gpt_loss(model.apply(params, x), y))
    ref_mesh.initialize_mesh(pipe=2)
    try:
        for name, args in SPECS.items():
            out[name] = float(ref_loss_fn(model, RefSpec(*args))(
                params, x, y))
    finally:
        ref_mesh.destroy_mesh()

    c = cases["step"]
    model, params = _ref_model_params(c, 2)
    ref_telemetry.reset()
    ref_mesh.initialize_mesh(pipe=2)
    try:
        ref_timeline.enable()
        ref_comms.enable()
        step = ref_make_step(model, RefAdam(lr=LR, impl="xla"),
                             ref_mesh.plan_gpt(params), schedule="1f1b",
                             num_microbatches=2)
        state = step.init(params)
        losses = []
        for _ in range(STEPS):
            state, loss = step(state, c["tokens"], c["labels"])
            losses.append(float(loss))
        snap = ref_metrics.registry().snapshot()
        out["step"] = {
            "losses": losses, "bubble": step.last_bubble_fraction,
            "final": jax.tree.map(np.asarray, step.opt.master_params(state)),
            "gauges": {k: v for k, v in snap["gauges"].items()
                       if k.startswith("pipeline")},
            "info": snap["info"]["pipeline"],
            "spans": [(s.name, s.args) for s in
                      ref_timeline.get_timeline().spans()
                      if s.category == "pipeline"],
            "ledger": [r for r in ref_comms.get_tracer().ledger()
                       if r["op"] == "ppermute"]}
        plan = ref_mesh.plan_gpt(params)
        _, loss2 = step(step.init(plan.shard_params(params)), c["tokens"],
                        c["labels"])
        out["step"]["presharded"] = float(loss2)
        out["step"]["ledger_after"] = [
            r for r in ref_comms.get_tracer().ledger()
            if r["op"] == "ppermute"]
    finally:
        ref_telemetry.reset()
        ref_comms.disable()
        ref_timeline.disable()
        ref_mesh.destroy_mesh()

    for label, layers, chunks in (("async", 2, 1), ("interleaved", 4, 2)):
        c = cases[label]
        label = label if label == "async" else "interleaved_train"
        model, params = _ref_model_params(c, layers)
        ref_mesh.initialize_mesh(pipe=2)
        try:
            step = ref_make_step(model, RefAdam(lr=c["lr"], impl="xla"),
                                 ref_mesh.plan_gpt(params),
                                 schedule=c["schedule"], num_microbatches=2,
                                 num_model_chunks=chunks)
            state = step.init(params)
            losses = []
            for _ in range(c["steps"]):
                state, loss = step(state, c["tokens"], c["labels"])
                losses.append(float(loss))
            out[label] = {"losses": losses,
                          "bubble": step.last_bubble_fraction}
            if label == "async":
                step.reset_pipeline()
                _, loss = step(state, c["tokens"], c["labels"])
                out[label]["after_reset"] = float(loss)
        finally:
            ref_mesh.destroy_mesh()

    c = cases["pp4"]
    model, params = _ref_model_params(c, 4)
    out["pp4"] = float(ref_gpt_loss(model.apply(params, jnp.asarray(
        c["tokens"])), jnp.asarray(c["labels"])))
    c = cases["tp"]
    model, params = _ref_model_params(c, 4)
    loss, g = jax.value_and_grad(lambda p: ref_gpt_loss(
        model.apply(p, jnp.asarray(c["tokens"])),
        jnp.asarray(c["labels"])))(params)
    out["tp"] = {"loss": float(loss), "grads": gpt_params_from_jax(
        jax.tree.map(np.asarray, g), GPTConfig(**c["cfg"]))}
    return out


# -- the port's worlds ----------------------------------------------------------


EXAMPLE_ARGV = ["--tp", "1", "--pp", "2", "--schedule", "interleaved_1f1b",
                "--model-chunks", "2", "--global-batch", "4",
                "--micro-batches", "2", "--seq", "16", "--hidden", "32",
                "--layers", "4", "--heads", "4", "--vocab", "64",
                "--lr", "1e-3"]


@pytest.fixture(scope="module")
def launched(cases, tmp_path_factory):
    """The port's two worlds, started before the reference runs (in
    threads: each spawns its ranks, which run beside this process)."""
    c = cases
    worlds = {
        2: {"parity": ({"pipe": 2}, "parity", c["parity"]),
            "step": ({"pipe": 2}, "train", dict(c["step"], telemetry=True,
                                                gpipe=True)),
            "async": ({"pipe": 2}, "train", c["async"]),
            "interleaved": ({"pipe": 2}, "train", c["interleaved"]),
            "shard": ({"pipe": 2}, "shard", c["shard"]),
            "example": ({"pipe": 2}, "example", {
                "argv": EXAMPLE_ARGV,
                "dir": str(tmp_path_factory.mktemp("pretrain_gpt"))})},
        4: {"dp2pp2": ({"batch": 2, "pipe": 2}, "train", c["step"]),
            "pp4": ({"pipe": 4}, "train", c["pp4"]),
            "tp2pp2": ({"model": 2, "pipe": 2}, "grads", c["tp"])},
    }
    pool = ThreadPoolExecutor(max_workers=2)
    futures = {n: pool.submit(multiproc.launch, torch_pp_worker.pp_world, n,
                              ({"cases": w},), backend="gloo", threads=1,
                              timeout=600) for n, w in worlds.items()}
    yield futures
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def world2(launched):
    return launched[2].result()


@pytest.fixture(scope="module")
def world4(launched):
    return launched[4].result()


def _local(case, name):
    cfg = GPTConfig(**case["cfg"])
    model = GPTModel(cfg, device="cpu", axis_name=None,
                     params=gpt_params_from_jax(case["tree"], cfg))
    fn = make_pipeline_loss_fn(model, PipelineSpec(*SPECS[name]))
    x = torch.tensor(case["tokens"]).long()
    y = torch.tensor(case["labels"]).long()
    with torch.no_grad():
        return [float(fn(model, x, y)) for _ in range(2)]


@pytest.fixture(scope="module")
def local_losses(cases):
    """Every sync schedule with both stage rows in this process (a pipe
    group of one rank)."""
    return {name: _local(cases["parity"], name) for name in SPECS}


# -- TestPipelineSpec, TestBubbleAlgebra --------------------------------------


def test_schedules_tuple():
    assert SCHEDULES == ("gpipe", "1f1b", "interleaved_1f1b", "async_1f1b")


@pytest.mark.parametrize("kw, match", [
    (dict(schedule="zb-h1"), "unknown schedule"),
    (dict(schedule="interleaved_1f1b", num_stages=2, num_microbatches=4,
          num_model_chunks=1), "num_model_chunks"),
    (dict(schedule="interleaved_1f1b", num_stages=4, num_microbatches=6,
          num_model_chunks=2), "divisible"),
    (dict(schedule="1f1b", num_stages=2, num_microbatches=4,
          num_model_chunks=2), "one model chunk"),
    (dict(schedule="1f1b", num_stages=0), ">= 1"),
], ids=["unknown", "interleaved_chunks", "interleaved_divisible",
        "chunks_one", "stages"])
def test_spec_validation_matches_reference(kw, match):
    with pytest.raises(ValueError, match=match) as mine:
        PipelineSpec(**kw)
    with pytest.raises(ValueError) as theirs:
        RefSpec(**kw)
    assert str(mine.value) == str(theirs.value)


@pytest.mark.parametrize("args", [
    ("1f1b", 4, 8), ("gpipe", 2, 4), ("interleaved_1f1b", 4, 8, 2),
    ("interleaved_1f1b", 2, 4, 2), ("async_1f1b", 4, 8), ("1f1b", 1, 8)])
def test_spec_algebra_matches_reference(args):
    mine, ref = PipelineSpec(*args), RefSpec(*args)
    assert (mine.ticks, mine.busy_ticks_per_stage, mine.bubble) == \
        (ref.ticks, ref.busy_ticks_per_stage, ref.bubble)
    assert mine.detail() == ref.detail()
    for layers in (8, 6, 12):
        try:
            want = ref.stage_layers(layers)
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                mine.stage_layers(layers)
            assert str(got.value) == str(e)
        else:
            assert mine.stage_layers(layers) == want


def test_bubble_algebra():
    assert bubble_fraction("gpipe", 4, 8) == \
        bubble_fraction("1f1b", 4, 8) == pytest.approx(3 / 11)
    for s, m in [(2, 4), (4, 8), (8, 16)]:
        assert bubble_fraction("interleaved_1f1b", s, m, 2) < \
            bubble_fraction("1f1b", s, m)
    assert bubble_fraction("1f1b", 4, 16) < bubble_fraction("1f1b", 4, 4)
    assert bubble_fraction("async_1f1b", 4, 8) == 0.0
    assert bubble_fraction("1f1b", 1, 8) == 0.0


@pytest.mark.parametrize("args", [
    ("gpipe", 2, 4), ("1f1b", 2, 4), ("1f1b", 4, 8), ("1f1b", 4, 2),
    ("interleaved_1f1b", 2, 4, 2), ("interleaved_1f1b", 4, 8, 2),
    ("interleaved_1f1b", 2, 2, 3)])
def test_tick_plan_runs_every_unit_once_in_dependency_order(args):
    """Every (microbatch, chunk) forward and backward once, on its stage,
    a stage's units in its order; 1F1B never holds more than S - s
    microbatches on stage s."""
    spec = PipelineSpec(*args)
    S, K, M = spec.num_stages, spec.num_chunks, spec.num_microbatches
    when = {}
    for t, tick in enumerate(tick_plan(spec)):
        assert len({a[2] % S for a in tick}) == len(tick)
        for a in tick:
            assert a not in when
            when[a] = t
    assert len(when) == 2 * K * M
    for (kind, i, k), t in when.items():
        if kind == "F" and k:
            assert when[("F", i, k - 1)] < t
        if kind == "B":
            assert when[("F", i, k)] < t
            if k < K - 1:
                assert when[("B", i, k + 1)] < t
    for s in range(S):
        order = rank_order(spec, s)
        assert sorted(order, key=when.get) == order
        if spec.schedule == "1f1b":
            live = peak = 0
            for kind, *_ in order:
                live += 1 if kind == "F" else -1
                peak = max(peak, live)
            assert peak <= S - s
    if spec.schedule == "gpipe":
        assert len(tick_plan(spec, forward_only=True)) == M + S - 1


def test_stage_param_names():
    names = [n for n, _ in GPTModel(GPTConfig(**_port_cfg(4)), device="cpu",
                                    axis_name=None).named_parameters()]
    first = stage_param_names(names, 2, 0)
    last = stage_param_names(names, 2, 1)
    assert {"embedding.weight", "position_embedding"} <= set(first)
    assert {n.split(".")[1] for n in first if n.startswith("layers")} == \
        {"0", "1"}
    assert "embedding.weight" in last and "position_embedding" not in last
    assert any(n.startswith("final_norm") for n in last)
    inter = stage_param_names(names, 2, 1, num_model_chunks=2)
    assert {n.split(".")[1] for n in inter if n.startswith("layers")} == \
        {"1", "3"}
    assert set(first) | set(last) == set(names)


# -- TestLossFnParity -----------------------------------------------------------


@pytest.mark.parametrize("name", ["gpipe", "1f1b", "interleaved"])
@pytest.mark.parametrize("where", ["local", "pp2"])
def test_loss_matches_reference_and_plain(reference, world2, local_losses,
                                          where, name):
    got = [local_losses[name]] if where == "local" else [
        r["parity"][name] for r in world2]
    for g in got:
        np.testing.assert_allclose(g[0], reference[name], rtol=LOSS_RTOL)
        np.testing.assert_allclose(g[0], reference["plain"], rtol=LOSS_RTOL)


@pytest.mark.parametrize("where", ["local", "pp2"])
def test_gpipe_1f1b_bitwise_and_repeatable(reference, world2, local_losses,
                                           where):
    runs = [local_losses] if where == "local" else [r["parity"]
                                                    for r in world2]
    for run in runs:
        assert run["gpipe"][0] == run["1f1b"][0]
        for name in ("gpipe", "1f1b", "interleaved"):
            assert run[name][0] == run[name][1]
        np.testing.assert_allclose(run["1f1b_m4"][0], run["1f1b"][0],
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(run["1f1b_m4"][0], reference["1f1b_m4"],
                                   rtol=LOSS_RTOL)
    if where == "pp2":
        assert runs[0] == runs[1]            # the loss is on every rank


def test_local_loss_is_differentiable(cases):
    """One pipe rank: the pipelined loss's gradient is the plain loss's."""
    c = cases["parity"]
    cfg = GPTConfig(**c["cfg"])
    x = torch.tensor(c["tokens"]).long()
    y = torch.tensor(c["labels"]).long()
    grads = []
    for pipelined in (True, False):
        model = GPTModel(cfg, device="cpu", axis_name=None,
                         params=gpt_params_from_jax(c["tree"], cfg))
        if pipelined:
            loss = make_pipeline_loss_fn(model, PipelineSpec(
                "1f1b", 2, 2))(model, x, y)
        else:
            from apex_tpu_torch.models import gpt_loss_fn
            loss = gpt_loss_fn(model(x), y, axis_name=None)
        loss.backward()
        grads.append({n: p.grad for n, p in model.named_parameters()})
    for n, g in grads[0].items():
        torch.testing.assert_close(g, grads[1][n], rtol=1e-4, atol=1e-6)


# -- TestMeshPipelineTrainStep ----------------------------------------------------


def _key_rows(kw):
    heads, d = kw["num_heads"], kw["hidden_size"] // kw["num_heads"]
    slab = np.zeros(3 * d, bool)
    slab[d:2 * d] = True
    return np.tile(slab, heads)


def _check_params(got_params, final, case, steps, lr):
    want = gpt_params_from_jax(final, GPTConfig(**case["cfg"]))
    for k, mine in got_params.items():
        w = want[k].numpy()
        if k.endswith("attention.qkv.bias"):
            keys = _key_rows(case["cfg"])
            np.testing.assert_allclose(mine[keys], w[keys], rtol=0,
                                       atol=2 * steps * lr, err_msg=k)
            mine, w = mine[~keys], w[~keys]
        np.testing.assert_allclose(mine, w, rtol=1e-4, atol=2e-6, err_msg=k)


@pytest.mark.parametrize("layout", ["pp2", "dp2pp2"])
def test_train_step_matches_reference(reference, world2, world4, cases,
                                      layout):
    ranks = ([r["step"] for r in world2] if layout == "pp2"
             else [r["dp2pp2"] for r in world4])
    ref = reference["step"]
    seen = set()
    for r in ranks:
        np.testing.assert_allclose(r["losses"], ref["losses"], rtol=LOSS_RTOL)
        _check_params(r["params"], ref["final"], cases["step"], STEPS, LR)
        seen |= set(r["params"])
        assert r["in_place"]
    assert seen == set(gpt_params_from_jax(ref["final"], GPTConfig(
        **cases["step"]["cfg"])))
    assert ref["losses"][-1] < ref["losses"][0]


@pytest.mark.parametrize("layout", ["step", "dp2pp2", "pp4", "async",
                                    "interleaved"])
def test_tied_embedding_copies_bitwise_every_step(world2, world4, layout):
    """The first and last pipe ranks of each data rank hold equal copies
    of the tied embedding after every step."""
    ranks = [r[layout] for r in (world4 if layout in ("dp2pp2", "pp4")
                                 else world2)]
    stages = 4 if layout == "pp4" else 2
    for first in range(0, len(ranks), stages):
        a, b = ranks[first]["tied"], ranks[first + stages - 1]["tied"]
        assert len(a) == len(b) > 0
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_gpipe_step_bitwise_1f1b_step(world2):
    assert all(r["step"]["gpipe_bitwise"] for r in world2)


def test_bubble_gauges_and_ticks(reference, world2):
    ref = reference["step"]
    spec = PipelineSpec("1f1b", 2, 2)
    for r in world2:
        got = r["step"]
        assert got["bubble"] == ref["bubble"] == pytest.approx(spec.bubble)
        assert got["gauges"] == ref["gauges"]
        assert got["gauges"]['pipeline_ticks{schedule="1f1b"}'] == spec.ticks


def test_stage_spans_and_info_blob(reference, world2):
    ref = reference["step"]

    def strip(info):
        return {**{k: v for k, v in info.items() if k != "step_ms"},
                "stages": [{k: v for k, v in s.items()
                            if k in ("stage", "busy_ticks")}
                           for s in info["stages"]]}

    for r in world2:
        got = r["step"]
        assert got["spans"] == ref["spans"]
        assert len(got["spans"]) == STEPS * 2
        assert strip(got["info"]) == strip(ref["info"])
        assert got["info"]["step_ms"] > 0


@pytest.mark.parametrize("when", ["ledger", "ledger_after"])
def test_boundary_transfers_priced_as_reference(reference, world2, when):
    ref = reference["step"][when]
    keys = ("op", "calls", "payload_bytes", "wire_bytes")
    for r in world2:
        got = r["step"][when]
        assert [{k: row[k] for k in keys} for row in got] == \
            [{k: row[k] for k in keys} for row in ref]
        assert got[0]["measured_mbps"] is None or got[0]["measured_mbps"] > 0


def test_transfers_counted(world2, cases):
    """1f1b at S = 2, M = 2: each rank sends or receives one activation
    and one gradient a microbatch, (seq, mb, hidden) fp32 each."""
    c = cases["step"]
    slab = 16 * (8 // 2) * 32 * 4
    for r in world2:
        assert r["step"]["transfers"] == (4, 4 * slab)


def test_init_accepts_presharded_params(reference, world2):
    for r in world2:
        np.testing.assert_allclose(r["step"]["presharded"],
                                   reference["step"]["presharded"],
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(r["step"]["presharded"],
                                   reference["step"]["losses"][0],
                                   rtol=LOSS_RTOL)
        assert r["step"]["spans_after"] == (STEPS + 1) * 2


def test_one_pipe_rank_step_matches_reference(reference, cases):
    """The pipelined step with both stage rows on this rank (a mesh of
    one), against the reference's pp=2 step."""
    c = cases["step"]
    cfg = GPTConfig(**c["cfg"])
    model = GPTModel(cfg, device="cpu", axis_name=None,
                     params=gpt_params_from_jax(c["tree"], cfg))
    gmesh.initialize_mesh()
    try:
        step = make_mesh_pipeline_train_step(
            model, FusedAdam(lr=LR), gmesh.plan_gpt(model),
            schedule="1f1b", num_microbatches=2)
        assert step.spec.num_stages == 2
        state = step.init()
        losses = []
        for _ in range(STEPS):
            state, loss = step(state, c["tokens"], c["labels"])
            losses.append(float(loss))
    finally:
        gmesh.destroy_mesh()
    np.testing.assert_allclose(losses, reference["step"]["losses"],
                               rtol=LOSS_RTOL)
    _check_params({n: p.detach().numpy() for n, p in
                   step.model.named_parameters()},
                  reference["step"]["final"], c, STEPS, LR)


# -- TestAsyncSchedule, interleaved and deep pipelines -------------------------


@pytest.mark.parametrize("where", ["local", "pp2"])
def test_async_losses_match_reference(reference, world2, cases, where):
    ref = reference["async"]
    if where == "pp2":
        runs = [r["async"] for r in world2]
    else:
        c = cases["async"]
        cfg = GPTConfig(**c["cfg"])
        model = GPTModel(cfg, device="cpu", axis_name=None,
                         params=gpt_params_from_jax(c["tree"], cfg))
        gmesh.initialize_mesh()
        try:
            step = make_mesh_pipeline_train_step(
                model, FusedAdam(lr=c["lr"]), gmesh.plan_gpt(model),
                schedule="async_1f1b", num_microbatches=2)
            state, losses = step.init(), []
            for _ in range(c["steps"]):
                state, loss = step(state, c["tokens"], c["labels"])
                losses.append(float(loss))
            run = {"losses": losses, "bubble": step.last_bubble_fraction,
                   "carried": step._pipe_buf is not None}
            step.reset_pipeline()
            run["reset"] = (step._pipe_buf is None, step._tick0)
            run["after_reset"] = float(step(state, c["tokens"],
                                            c["labels"])[1])
        finally:
            gmesh.destroy_mesh()
        runs = [run]
    for r in runs:
        np.testing.assert_allclose(r["losses"], ref["losses"], rtol=LOSS_RTOL)
        assert all(np.isfinite(r["losses"]))
        assert r["losses"][-1] < r["losses"][0]
        assert r["bubble"] == ref["bubble"] == 0.0
        assert r["reset"] == (True, 0)
        np.testing.assert_allclose(r["after_reset"], ref["after_reset"],
                                   rtol=LOSS_RTOL)
    if where == "pp2":
        assert world2[1]["async"]["carried"]


def test_interleaved_training_matches_reference(reference, world2):
    ref = reference["interleaved_train"]
    for r in world2:
        got = r["interleaved"]
        np.testing.assert_allclose(got["losses"], ref["losses"],
                                   rtol=LOSS_RTOL)
        assert got["losses"][-1] < got["losses"][0]
        assert got["bubble"] == ref["bubble"] == pytest.approx(1 / 5)


def test_pp4_matches_reference(reference, world4):
    for r in world4:
        np.testing.assert_allclose(r["pp4"]["losses"][0], reference["pp4"],
                                   rtol=LOSS_RTOL)
        assert r["pp4:coords"]["pipe"] == r["rank"]


def _gather(parts, spec):
    dims = [d for d, a in enumerate(spec) if a is not None]
    return np.concatenate(parts, axis=dims[0]) if dims else parts[0]


def test_tp2_pp2_loss_and_gradients(reference, world4):
    ref = reference["tp"]
    specs = gpt_param_specs(ref["grads"])
    by_stage = {}
    for r in world4:
        got = r["tp2pp2"]
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=2e-4)
        by_stage.setdefault(r["tp2pp2:coords"]["pipe"], {})[
            got["tp_rank"]] = got["grads"]
    seen = set()
    for stage, shards in by_stage.items():
        for k in shards[0]:
            mine = _gather([shards[t][k] for t in sorted(shards)], specs[k])
            np.testing.assert_allclose(mine, ref["grads"][k].numpy(),
                                       rtol=2e-3, atol=2e-5,
                                       err_msg=f"stage {stage} {k}")
            seen.add(k)
    assert seen == set(ref["grads"])


def test_gpt_shard_from_jax_cuts_by_stage(world2):
    assert all(r["shard"] for r in world2)


# -- the raises ---------------------------------------------------------------------


def _two_stage_mesh():
    grid = ps.rank_grid(2, pipeline_model_parallel_size=2)
    return Mesh(ps.Topology(grid=grid, rank=0,
                            coords=dict.fromkeys(ps.AXES, 0), groups={}))


def test_num_stages_must_match_the_pipe_axis():
    model = GPTModel(GPTConfig(**_port_cfg(4)), device="cpu",
                     axis_name=None)
    plan = gmesh.plan_gpt(model, mesh=_two_stage_mesh())
    with pytest.raises(ValueError, match="num_stages \\(4\\) must equal"):
        MeshPipelineTrainStep(model, FusedAdam(lr=LR), plan,
                              PipelineSpec("1f1b", 4, 4))
    with pytest.raises(NotImplementedError, match="MeshPipelineTrainStep"):
        gmesh.make_mesh_train_step(model, FusedAdam(lr=LR), plan)


def test_indivisible_layers_and_microbatches_raise():
    cfg = GPTConfig(**_port_cfg(3))
    model = GPTModel(cfg, device="cpu", axis_name=None)
    with pytest.raises(ValueError, match="num_layers \\(3\\) must divide"):
        make_pipeline_loss_fn(model, PipelineSpec("1f1b", 2, 2))
    gmesh.initialize_mesh()
    try:
        with pytest.raises(ValueError, match="num_layers"):
            make_mesh_pipeline_train_step(model, FusedAdam(lr=LR),
                                          gmesh.plan_gpt(model))
        model = GPTModel(GPTConfig(**_port_cfg(2)), device="cpu",
                         axis_name=None)
        step = make_mesh_pipeline_train_step(
            model, FusedAdam(lr=LR), gmesh.plan_gpt(model),
            num_microbatches=3)
        x, y = tiny_data(batch=4)
        with pytest.raises(ValueError, match="not divisible by "
                                             "num_microbatches 3"):
            step(step.init(), x, y)
    finally:
        gmesh.destroy_mesh()
    with pytest.raises(ValueError, match="async_1f1b carries state"):
        make_pipeline_loss_fn(model, PipelineSpec("async_1f1b", 2, 2))


def test_pretrain_gpt_example_resumes_exactly(world2):
    """``examples/pretrain_gpt.py`` at pp=2, interleaved: a run saved at
    step 2 and resumed to step 4 gives the uninterrupted run's last two
    losses, bitwise (every rank's ``opt.state_dict`` through
    ``torch.save``, the batch stream skipped ahead)."""
    for r in world2:
        ex = r["example"]
        assert ex["start"] == 2
        assert ex["resumed"] == ex["whole"][2:]
        assert all(np.isfinite(ex["whole"]))
        assert ex["bubble"] == pytest.approx(1 / 5)
    assert world2[0]["example"]["whole"] == world2[1]["example"]["whole"]


@pytest.mark.parametrize("chunks", [1, 2])
def test_plan_and_shard_state_cut_by_stage(chunks):
    """On a mesh of two pipe stages the plan holds stage 0's parameters
    and ``shard_state`` cuts a full FusedAdam state to them, slot for
    slot (the layout alone: no process group is needed)."""
    model = GPTModel(GPTConfig(**_port_cfg(4)), device="cpu",
                     axis_name=None, generator=torch.Generator().manual_seed(3))
    plan = gmesh.plan_gpt(model, mesh=_two_stage_mesh(),
                          num_model_chunks=chunks)
    names = [n for n, _ in model.named_parameters()]
    assert list(plan.param_specs) == stage_param_names(names, 2, 0, chunks)
    opt = FusedAdam(lr=LR)
    state = opt.init(dict(model.named_parameters()))
    state.slots["m"].copy_(torch.arange(state.master.numel(),
                                        dtype=torch.float32))
    cut = plan.shard_state(state)
    full_m = state.space.unpack(state.slots["m"], dtype="buffer")
    assert list(cut.space.names) == list(plan.param_specs)
    for n, t in cut.space.unpack(cut.master, dtype="buffer").items():
        torch.testing.assert_close(t, dict(model.named_parameters())[n],
                                   rtol=0, atol=0)
    for n, t in cut.space.unpack(cut.slots["m"], dtype="buffer").items():
        torch.testing.assert_close(t, full_m[n], rtol=0, atol=0)
    assert plan.shard_params(dict(model.named_parameters())).keys() == \
        set(plan.param_specs)
