"""Norms over a flat optimizer state cut on the model and pipe axes
(``apex_tpu_torch/parallel/sharded_norms.py``): FusedLAMB (both
layouts), FusedNovoGrad, FusedLARS, LARC and FusedAdam under
``make_train_step(max_grad_norm=...)`` through the mesh step at tp = 2
and dp = 2 x tp = 2, FusedLAMB and the clip through the pipelined step
at pp = 2 and dp = 2 x pp = 2, against the reference's step.

The port runs in one gloo world of 2 CPU processes (tp = 2, then pp = 2)
and one of 4 (dp = 2 x tp = 2, then dp = 2 x pp = 2),
``torch_zero_worker.norms_world``, one spawn a world. The reference keeps its flat state replicated on any
mesh (``apex_tpu/mesh/mesh.py`` :184-196), so its numbers are the
one-device step's: its ``MeshTrainStep`` body (the flat gradient of the
loss, then ``step_flat``; LARC's ``step`` on the gradient tree, the clip
through its ``make_train_step``) on one device, here, from the same
weights (the reference's, converted by ``models.convert``) and batch.

Tolerances, from the measured gaps: the losses within rtol 2e-5 (the
mesh step's bound, ``tests/test_torch_mesh.py``); the parameters after
step 1 and after 3 steps within rtol 1e-4, atol 2e-6 (that file's
bound; the gradients' fp32 error, ~1e-6 relative, carried by at most
lr x a trust ratio a step). Every replicated leaf, and the two copies of
the tied embedding at pp = 2, bitwise equal across the ranks after
every step (an all-reduce hands each rank one sum). The global norm the
clips read within rtol 1e-5 of the reference's full gradient's, and
each rank's part's own norm below it. Under Adam, the rule of
``_params_close``. At pp = 2 with the state's norms left unreduced
(each stage clipping by its own gradient's norm, the fault the
reduction repairs) FusedLAMB stays within the bound, as its update is
invariant to a clip factor that holds from step to step (measured:
4.8e-7 past rtol, under atol 2e-6). The helper's per-leaf and global
norms within rtol 1e-6 of numpy's fp64 ones.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from apex_tpu.models.gpt import GPTConfig as RefConfig
from apex_tpu.models.gpt import GPTModel as RefGPT
from apex_tpu.models.gpt import gpt_loss_fn as ref_loss
from apex_tpu.optimizers import FusedAdam as RefAdam
from apex_tpu.optimizers import FusedLAMB as RefLAMB
from apex_tpu.optimizers import FusedLARS as RefLARS
from apex_tpu.optimizers import FusedNovoGrad as RefNovoGrad
from apex_tpu.optimizers import FusedSGD as RefSGD
from apex_tpu.optimizers import make_train_step as ref_make_train_step
from apex_tpu.parallel import LARC as RefLARC

import torch
import torch_zero_worker
from apex_tpu_torch.models import GPTConfig, gpt_param_specs
from apex_tpu_torch.models.convert import gpt_params_from_jax
from apex_tpu_torch.parallel import multiproc

TRAIN = dict(vocab_size=128, max_seq_len=32, hidden_size=64, num_layers=2,
             num_heads=4)
STEPS = 3
LOSS_RTOL = 2e-5
P_RTOL, P_ATOL = 1e-4, 2e-6
ALL = ("lamb", "lamb_seg", "novograd", "lars", "larc", "adam_clip")
PIPE = ("lamb", "lamb_seg", "adam_clip")
LAYOUTS = {2: {"model2": {"model": 2}, "pipe2": {"pipe": 2}},
           4: {"batch2_model2": {"batch": 2, "model": 2},
               "batch2_pipe2": {"batch": 2, "pipe": 2}}}


def _ref_cfg():
    # one leaf a layer, as the port keeps them: a per-leaf norm (LAMB's,
    # NovoGrad's, LARS's) of a stacked leaf would span every layer
    return RefConfig(dtype=jnp.float32, softmax_impl="xla",
                     scan_layers=False, **TRAIN)


def _port_cfg():
    return dict(TRAIN, dtype=torch.float32, param_dtype=torch.float32)


def _batch():
    toks = np.random.RandomState(2).randint(0, TRAIN["vocab_size"],
                                            (8, TRAIN["max_seq_len"] + 1))
    return toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32)


def _helper_tree():
    rng = np.random.RandomState(4)
    tree = {"a": rng.randn(6, 4), "b": rng.randn(5), "c": rng.randn(4, 3),
            "d": rng.randn(7)}
    return ({k: np.asarray(v, np.float32) for k, v in tree.items()},
            {"a": True, "b": False, "c": True, "d": False})


def _inputs(n):
    x, y = _batch()
    tree = jax.tree.map(np.asarray, RefGPT(_ref_cfg()).init(
        jax.random.PRNGKey(0), jnp.asarray(x)))
    layouts = LAYOUTS[n]
    helper, split = _helper_tree()
    return {"cfg": _port_cfg(), "tree": tree, "tokens": x, "labels": y,
            "steps": STEPS, "layouts": layouts,
            "optimizers": {k: PIPE if "pipe" in v else ALL
                           for k, v in layouts.items()},
            "helper": {"tree": helper, "split": split, "max_norm": 1.0}}


@pytest.fixture(scope="module", params=[2, 4], ids=["w2", "w4"])
def world(request):
    n = request.param
    inp = _inputs(n)
    return n, inp, multiproc.launch(torch_zero_worker.norms_world, n, (inp,),
                                    backend="gloo", threads=1, timeout=600)


# -- the reference ------------------------------------------------------------


def _ref_optimizer(name):
    lamb = dict(lr=1e-3, weight_decay=0.01, max_grad_norm=1.0, impl="xla")
    return {
        "lamb": lambda: RefLAMB(**lamb, segmented=False),
        "lamb_seg": lambda: RefLAMB(**lamb, segmented=True),
        "novograd": lambda: RefNovoGrad(lr=1e-3, weight_decay=0.01,
                                        impl="xla"),
        "lars": lambda: RefLARS(lr=1e-2, momentum=0.9, weight_decay=1e-4,
                                impl="xla"),
        "larc": lambda: RefLARC(RefSGD(lr=1e-2, momentum=0.9,
                                       weight_decay=1e-4, impl="xla")),
        "adam_clip": lambda: RefAdam(lr=1e-3, weight_decay=0.01, impl="xla"),
    }[name]()


@pytest.fixture(scope="module")
def reference():
    """Each optimizer's losses and parameters (by the port's names)
    after step 1 and after the last, on one device."""
    x, y = _batch()
    model = RefGPT(_ref_cfg())
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(x))
    vg = jax.jit(jax.value_and_grad(
        lambda p: ref_loss(model.apply(p, jnp.asarray(x)), jnp.asarray(y))))
    cfg = GPTConfig(**_port_cfg())
    out = {}
    for name in ALL:
        opt = _ref_optimizer(name)
        inner = opt.optimizer if name == "larc" else opt
        ts = (ref_make_train_step(opt, max_grad_norm=0.5)
              if name == "adam_clip" else None)
        state = opt.init(params)
        losses, after = [], []
        for i in range(STEPS):
            loss, g = vg(inner.master_params(state))
            if i == 0:
                gnorm = float(np.sqrt(sum(
                    np.sum(np.float64(np.asarray(v)) ** 2)
                    for v in jax.tree.leaves(g))))
            if name == "larc":
                _, state = opt.step(state, g)
            elif ts is not None:
                state, _ = ts(state, state.space.pack(g, dtype=jnp.float32))
            else:
                _, state = opt.step_flat(
                    state, state.space.pack(g, dtype=jnp.float32))
            losses.append(float(loss))
            after.append({k: v.numpy() for k, v in gpt_params_from_jax(
                jax.tree.map(np.asarray, inner.master_params(state)),
                cfg).items()})
        out[name] = {"losses": losses, "step1": after[0],
                     "params": after[-1], "gnorm": gnorm}
    return out


# -- the port against it --------------------------------------------------------


def _gather(world, label, name, key):
    """The whole of each parameter from the ranks of one data rank: a
    split leaf's shards put together over the model axis, a pipe
    stage's leaves by name."""
    n, _, got = world
    runs = [got[r][label][name] for r in range(n)]
    mine = [run for run in runs if run["coords"]["batch"] == 0]
    whole = {}
    specs = gpt_param_specs({k: torch.tensor(v) for k, v in
                             runs[0]["params"].items()})
    by_model = sorted(mine, key=lambda run: run["coords"]["model"])
    for k in {k for run in mine for k in run[key]}:
        parts = [run[key][k] for run in by_model if k in run[key]]
        spec = specs.get(k) or runs[0]["specs"].get(k, ())
        dims = [d for d, a in enumerate(spec) if a is not None]
        model = max(run["coords"]["model"] for run in mine) + 1
        whole[k] = (np.concatenate(parts, axis=dims[0])
                    if dims and model > 1 else parts[0])
    return whole


def _cases(world):
    _, inp, _ = world
    return [(label, name) for label, names in inp["optimizers"].items()
            for name in names]


def _key_rows():
    heads, d = TRAIN["num_heads"], TRAIN["hidden_size"] // TRAIN["num_heads"]
    slab = np.zeros(3 * d, bool)
    slab[d:2 * d] = True
    return np.tile(slab, heads)


def _params_close(got, want, label, adam_steps=0):
    """Every parameter within the bound. Under Adam (``adam_steps``
    steps of lr 1e-3), whose update lr g / (|g| + eps) turns the fp32
    error of a gradient element near 0 into a step of up to lr: the key
    bias, whose exact gradient is 0, within 2 x steps x lr
    (``tests/test_torch_pipeline.py``'s rule); elsewhere at most 0.1% of
    a leaf's elements past the bound (one of proj.weight's 4096 at tp =
    2, by 0.04 lr), each within 2 x steps x lr."""
    assert set(got) == set(want), label
    for k, w in want.items():
        mine, msg = got[k], f"{label} {k}"
        if adam_steps:
            most = 2 * adam_steps * 1e-3
            np.testing.assert_allclose(mine, w, rtol=0, atol=most,
                                       err_msg=msg)
            if k.endswith("attention.qkv.bias"):
                keys = _key_rows()
                mine, w = mine[~keys], w[~keys]
            past = ~np.isclose(mine, w, rtol=P_RTOL, atol=P_ATOL)
            assert past.mean() <= 1e-3, (msg, int(past.sum()))
            continue
        np.testing.assert_allclose(mine, w, rtol=P_RTOL, atol=P_ATOL,
                                   err_msg=msg)


def test_losses_match_reference(world, reference):
    n, _, got = world
    for label, name in _cases(world):
        for r in range(n):
            np.testing.assert_allclose(got[r][label][name]["losses"],
                                       reference[name]["losses"],
                                       rtol=LOSS_RTOL,
                                       err_msg=f"{label} {name}")


@pytest.mark.parametrize("key", ["step1", "params"])
def test_parameters_match_reference(world, reference, key):
    for label, name in _cases(world):
        steps = (1 if key == "step1" else STEPS) if name == "adam_clip" \
            else 0
        _params_close(_gather(world, label, name, key), reference[name][key],
                      f"{label} {name} {key}", adam_steps=steps)


def test_replicated_leaves_bitwise_across_ranks(world):
    """Every replicated leaf equal on each rank of its model group, and
    the tied embedding's two copies equal across the pipe stages, after
    every step."""
    n, _, got = world
    for label, name in _cases(world):
        runs = [got[r][label][name] for r in range(n)]
        for i in range(STEPS):
            for run in runs[1:]:
                for k, v in runs[0]["replicated"][i].items():
                    if k in run["replicated"][i]:
                        np.testing.assert_array_equal(
                            run["replicated"][i][k], v,
                            err_msg=f"{label} {name} {k} step {i + 1}")
            if "pipe" in label:
                np.testing.assert_array_equal(
                    runs[0]["tied"][i], runs[-1]["tied"][i],
                    err_msg=f"{label} {name} tied step {i + 1}")


def test_global_norm_is_the_whole_models(world, reference):
    """The norm the clips read, on each rank: the whole model's
    gradient's (the tied embedding counted once at pp = 2), not this
    rank's part's."""
    n, inp, got = world
    want = reference["lamb"]["gnorm"]
    for label in inp["layouts"]:
        for r in range(n):
            run = got[r][label]["lamb"]
            np.testing.assert_allclose(run["gnorm"], want, rtol=1e-5,
                                       err_msg=label)
            assert run["gnorm_local"] < want * (1 - 1e-3), label


def test_pipe_lamb_without_the_reduction(world, reference):
    """At pp = 2 each stage clipping by its own gradient's norm (the
    state's norms left unreduced): FusedLAMB's update is invariant to a
    clip factor that holds from step to step (m / sqrt(v), then the
    trust ratio), so the parameters stay within the bound of the
    reference's (measured: 4.8e-7 past rtol at pp = 2); the norm the
    clip reads is held above."""
    _, inp, _ = world
    label = next(k for k in inp["layouts"] if "pipe" in k)
    for key in ("step1", "params"):
        _params_close(_gather(world, label, "lamb_unreduced", key),
                      reference["lamb"][key], f"unreduced {key}")


def test_helper_counts_a_replicated_leaf_once(world):
    n, inp, got = world
    tree, split = inp["helper"]["tree"], inp["helper"]["split"]
    want_leaf = {k: float(np.linalg.norm(np.float64(v)))
                 for k, v in tree.items()}
    total = float(np.sqrt(sum(v ** 2 for v in want_leaf.values())))
    clip = min(inp["helper"]["max_norm"] / (total + 1e-6), 1.0)
    label = next(k for k in inp["layouts"] if "model" in k)
    for r in range(n):
        h = got[r][label]["helper"]
        for k, w in want_leaf.items():
            np.testing.assert_allclose(h["leaf"][k], w, rtol=1e-6)
        np.testing.assert_allclose(h["total"], total, rtol=1e-6)
        np.testing.assert_allclose(h["clip_norm"], total, rtol=1e-6)
        for k, v in tree.items():
            want = (np.array_split(v, 2)[got[r][label]["lamb"]["coords"]
                                        ["model"]]
                    if split[k] else v) * clip
            np.testing.assert_allclose(h["clipped"][k], want, rtol=1e-6,
                                       atol=1e-7)
