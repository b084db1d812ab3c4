"""The GPT pretraining step of apex_tpu_torch against apex_tpu's.

A tiny GPT (2 layers, hidden 64, 4 heads, vocab 128, seq 32, batch 4)
trains in the reference — ``make_gpt_pretrain_step(cfg, FusedAdam(lr=2e-3,
weight_decay=0.01, impl="xla"))`` on one device — for one step; its
weights and its Adam state (master, m, v, count) are then converted into
the port (``load_jax_params``, ``load_jax_opt_state``), and both take the
same three further steps, under the flash attention backend and under
the softmax one. The losses are compared at each step, and every
parameter, m and v after the third, per parameter name. The port
runs its plain PyTorch versions on the CPU (the kernel path is held
against the plain path on the card by ``chip_smoke.py``).

Tolerances. fp32: losses within 2e-6 (observed 5e-7); m, v and the
parameters within 1e-5 of each leaf's largest |value| (sums in other
orders), except the key bias: it has an exactly-zero true gradient
(softmax does not change when every score of a row moves by the same
q . b_k), so its computed gradient is rounding noise, which Adam
normalises to steps of up to about lr in either direction on each side:
it is held within 2 lr a step, 6 lr in all. bf16 compute: the two
frameworks round activations and gradients to bf16 at different points
(~1% apart), and Adam normalises a gradient of any size to a step of
about lr, so elements with small gradients move apart by up to that
much. Losses within 1e-3 (observed 1e-4); m and v within 10% of each
leaf's largest |value| (observed 3%); the parameters all within 6 lr,
their mean difference within lr / 20 (observed lr / 100) and at most 1%
of them more than lr / 4 apart (observed 0.1%).
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from apex_tpu.amp.scaler import LossScaler as RefScaler
from apex_tpu.models.gpt import GPTConfig as RefConfig
from apex_tpu.models.pretrain import init_gpt_pretrain_params as ref_init
from apex_tpu.models.pretrain import make_gpt_pretrain_step as ref_make
from apex_tpu.optimizers import FusedAdam as RefAdam
from apex_tpu.optimizers import make_train_step as ref_make_train_step

import apex_tpu_torch
from apex_tpu_torch.amp import LossScaler
from apex_tpu_torch.models import (
    GPTConfig,
    GPTModel,
    gpt_params_from_jax,
    init_gpt_pretrain_params,
    load_jax_opt_state,
    load_jax_params,
    make_gpt_pretrain_step,
)
from apex_tpu_torch.models.pretrain import PretrainStep
from apex_tpu_torch.optimizers import FusedAdam, FusedLAMB, make_train_step

VOCAB, SEQ, HID, LAYERS, HEADS, BATCH = 128, 32, 64, 2, 4, 4
LR = 2e-3
LOSS_ATOL = {"fp32": 2e-6, "bf16": 1e-3}
MV_REL = {"fp32": 1e-5, "bf16": 0.1}
PARAM_REL_FP32 = 1e-5


def _configs(dt):
    """The reference's and the port's tiny GPT for ``dt``: "fp32" or
    "bf16", with "-softmax" for the softmax attention backend."""
    dt, _, backend = dt.partition("-")
    jdt, tdt = {"fp32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dt]
    shape = dict(vocab_size=VOCAB, max_seq_len=SEQ, hidden_size=HID,
                 num_layers=LAYERS, num_heads=HEADS,
                 attention_backend=backend or "flash")
    return RefConfig(dtype=jdt, **shape), GPTConfig(dtype=tdt, **shape)


def _batches(n, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        t = rng.randint(0, VOCAB, (BATCH, SEQ + 1)).astype(np.int32)
        out.append((t[:, :-1], t[:, 1:]))
    return out


def _unpack(state, buf):
    return jax.tree_util.tree_map(
        np.asarray, state.space.unpack(buf, dtype="buffer"))


def _key_bias_mask(cfg):
    """True on the key slots of each layer's fused qkv bias ([q | k | v]
    per kv head)."""
    hd = cfg.hidden_size // cfg.num_heads
    group = cfg.num_heads // cfg.kv_heads
    mask = torch.zeros(cfg.kv_heads, group + 2, hd, dtype=torch.bool)
    mask[:, group] = True
    return mask.reshape(-1)


@pytest.fixture(scope="module",
                params=["fp32", "bf16", "fp32-softmax", "bf16-softmax"])
def trained(request):
    rcfg, cfg = _configs(request.param)
    dt = request.param.partition("-")[0]
    params = ref_init(rcfg, jax.random.PRNGKey(0))
    ref_step, rs = ref_make(rcfg, RefAdam(lr=LR, weight_decay=0.01,
                                          impl="xla"))(params)
    batches = _batches(4)
    rs, _ = ref_step(rs, *batches[0])
    model = load_jax_params(GPTModel(cfg, device="cpu"),
                            _unpack(rs, rs.master))
    step, ps = make_gpt_pretrain_step(
        cfg, FusedAdam(lr=LR, weight_decay=0.01))(model)
    ps = load_jax_opt_state(ps, cfg, {
        "master": _unpack(rs, rs.master), "m": _unpack(rs, rs.slots["m"]),
        "v": _unpack(rs, rs.slots["v"]), "count": int(rs.count)})
    losses = []
    for x, y in batches[1:]:
        rs, rl = ref_step(rs, x, y)
        ps, pl = step(ps, x, y)
        losses.append((float(rl), float(pl)))
    return dt, cfg, rs, ps, model, losses


def test_losses_match_each_step(trained):
    dt, _, _, _, _, losses = trained
    for want, got in losses:
        assert np.isfinite(got)
        assert abs(got - want) <= LOSS_ATOL[dt], losses


def test_state_matches_after_three_steps(trained):
    dt, cfg, rs, ps, _, _ = trained
    assert ps.count == int(rs.count) == 4
    key = _key_bias_mask(cfg)
    for name, rbuf, pbuf in (("master", rs.master, ps.master),
                             ("m", rs.slots["m"], ps.slots["m"]),
                             ("v", rs.slots["v"], ps.slots["v"])):
        want = gpt_params_from_jax(_unpack(rs, rbuf), cfg)
        got = ps.space.unpack(pbuf, "buffer")
        assert set(got) == set(want)
        diffs = []
        for leaf, w in want.items():
            diff = (got[leaf] - w).abs()
            diffs.append(diff.reshape(-1))
            if name == "master" and dt == "bf16":
                continue                     # held as a whole below
            if leaf.endswith("qkv.bias"):
                if name == "master":
                    assert float(diff[key].max()) <= 6 * LR, leaf
                diff, w = diff[~key], w[~key]
            rel = MV_REL[dt] if name != "master" else PARAM_REL_FP32
            assert float(diff.max()) <= rel * float(w.abs().max()), (
                name, leaf, float(diff.max()))
        if name == "master" and dt == "bf16":
            d = torch.cat(diffs)
            assert float(d.max()) <= 6 * LR
            assert float(d.mean()) <= LR / 20
            assert float((d > LR / 4).float().mean()) <= 0.01


def test_model_parameters_are_views_of_the_master(trained):
    _, _, _, ps, model, _ = trained
    views = ps.space.unpack(ps.master, "buffer")
    for name, p in model.named_parameters():
        assert p.data_ptr() == views[name].data_ptr()
        assert torch.equal(p, views[name])


def test_scaler_step_on_overflow_matches_reference(trained):
    """One ``make_train_step(opt, scaler=...)`` step on a gradient with
    an inf: both sides leave the state as it was and back the scale
    off."""
    dt, cfg, rs, ps, _, _ = trained
    ref_opt, opt = RefAdam(lr=LR, impl="xla"), FusedAdam(lr=LR)
    rstep = ref_make_train_step(ref_opt, scaler=RefScaler())
    pstep = make_train_step(opt, scaler=LossScaler())
    # the two flat layouts differ in size (the reference stacks layers)
    rg = np.ones(rs.master.shape[0], np.float32)
    pg = np.ones(ps.master.shape[0], np.float32)
    rg[123] = pg[123] = np.inf
    master, m, count = ps.master.clone(), ps.slots["m"].clone(), ps.count
    rs2, rss, raux = rstep(rs, jnp.asarray(rg), rstep.scaler.init())
    ps2, pss, aux = pstep(ps, torch.from_numpy(pg), pstep.scaler.init())
    assert float(aux.found_inf) == float(raux.found_inf) == 1.0
    assert pss.loss_scale == float(rss.loss_scale) == 2.0 ** 15
    assert ps2.count == count == int(rs2.count)
    assert torch.equal(ps2.master, master)
    assert torch.equal(ps2.slots["m"], m)


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, cfg = _configs("fp32")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_gpt_pretrain_params(cfg)
    model = init_gpt_pretrain_params(cfg, device="cpu")
    assert next(model.parameters()).device.type == "cpu"


def test_unported_options_raise():
    _, cfg = _configs("fp32")
    opt = FusedAdam(lr=LR)
    with pytest.raises(ValueError, match="requires master_dtype=bfloat16"):
        FusedLAMB(lr=LR, stochastic_rounding=True)
    with pytest.raises(NotImplementedError, match="fingerprint"):
        make_train_step(opt, fingerprint_every=10)
    with pytest.raises(NotImplementedError, match="chained"):
        make_train_step(FusedLAMB(lr=LR), max_grad_norm=1.0).chained(4)
    # the pipe axis is ported; on a mesh of two pipe stages (the layout
    # alone, no process group needed before the raises) the one-stage
    # step still refuses it, and so does a stage count the pipe axis
    # cannot hold
    from apex_tpu_torch import mesh as gmesh
    from apex_tpu_torch.mesh import Mesh
    from apex_tpu_torch.transformer import parallel_state as ps

    grid = ps.rank_grid(2, pipeline_model_parallel_size=2)
    two_stages = Mesh(ps.Topology(grid=grid, rank=0,
                                  coords=dict.fromkeys(ps.AXES, 0),
                                  groups={}))
    model = init_gpt_pretrain_params(cfg, torch.Generator().manual_seed(0),
                                     device="cpu")
    plan = gmesh.plan_gpt(model, mesh=two_stages)
    with pytest.raises(NotImplementedError,
                       match="pipe=2: MeshTrainStep runs one pipeline stage"):
        gmesh.make_mesh_train_step(model, opt, plan)
    with pytest.raises(ValueError, match="num_stages \\(4\\) must equal"):
        gmesh.MeshPipelineTrainStep(model, opt, plan, gmesh.PipelineSpec(
            "1f1b", num_stages=4, num_microbatches=4))
    with pytest.raises(ValueError, match="requires master_dtype=bfloat16"):
        FusedAdam(lr=LR, stochastic_rounding=True)


def test_loss_falls_over_steps_on_one_batch():
    _, cfg = _configs("fp32")
    gen = torch.Generator().manual_seed(0)
    model = init_gpt_pretrain_params(cfg, gen, device="cpu")
    step, state = make_gpt_pretrain_step(cfg, FusedAdam(lr=1e-2))(model)
    x, y = _batches(1, seed=3)[0]
    losses = []
    for _ in range(5):
        state, loss = step(state, x, y)
        losses.append(float(loss))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


def test_model_chunks_ignored_at_one_pipe_stage():
    """Without a mesh (one pipe stage) ``num_model_chunks`` has no effect,
    as in the reference (``models/pretrain.py`` :92-106): the plain step,
    whose losses are the default build's bitwise."""
    _, cfg = _configs("fp32")
    x, y = _batches(1, seed=3)[0]
    losses = {}
    for chunks in (1, 2):
        model = init_gpt_pretrain_params(
            cfg, torch.Generator().manual_seed(0), device="cpu")
        step, state = make_gpt_pretrain_step(
            cfg, FusedAdam(lr=1e-2), num_model_chunks=chunks)(model)
        assert isinstance(step, PretrainStep)
        losses[chunks] = []
        for _ in range(2):
            state, loss = step(state, x, y)
            losses[chunks].append(float(loss))
    assert losses[2] == losses[1]


def test_training_modules_import_no_jax():
    code = ("import sys, apex_tpu_torch.models, apex_tpu_torch.optimizers, "
            "apex_tpu_torch.multi_tensor, apex_tpu_torch.amp, "
            "apex_tpu_torch.multi_tensor.segmented, "
            "apex_tpu_torch.multi_tensor.engine, "
            "apex_tpu_torch.optimizers.fused, apex_tpu_torch.models.pretrain, "
            "apex_tpu_torch.models.convert, apex_tpu_torch.random, "
            "apex_tpu_torch.amp.nn_functional, apex_tpu_torch.amp.handle, "
            "apex_tpu_torch.amp.functional, apex_tpu_torch.amp.lists, "
            "apex_tpu_torch.fp16_utils, apex_tpu_torch.examples.amp_functional, "
            "apex_tpu_torch.examples.dcgan_amp; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'apex_tpu')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    root = Path(apex_tpu_torch.__file__).resolve().parent.parent
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
