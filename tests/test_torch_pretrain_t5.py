"""T5 pretraining with FusedAdam, apex_tpu_torch against apex_tpu.

A tiny T5 (vocab 96, hidden 64, 2 encoder and 2 decoder layers, 4 heads,
24 encoder and 12 decoder tokens, batch 3 with padded encoder tails and a
loss mask over 80% of the decoder tokens) trains in the reference for one
step — ``jax.value_and_grad`` of ``t5_loss_fn`` over the model's apply,
then ``FusedAdam(lr=2e-3, weight_decay=0.01, impl="xla").step`` — its
weights and Adam state (master, m, v, count) are converted into the port
(``load_jax_params``, ``load_jax_opt_state``), and both take the same
three further steps, the port through ``PretrainStep(model,
FusedAdam(...), loss_fn=t5_pretrain_loss)``. The losses are compared at
each step, and every parameter, m and v after the third, per parameter
name. The reference runs its XLA softmax path, and on the flash backend
its Pallas kernels interpreted on the CPU; the port its plain versions
on CPU tensors.

Tolerances, those of ``test_torch_pretrain.py`` (GPT with FusedAdam).
fp32: losses within 2e-6; m, v and the parameters within 1e-5 of each
leaf's largest |value|, except the key biases of self and cross
attention (an exactly-zero true gradient, whose rounding noise Adam
normalises to steps of up to about lr): within 6 lr. The parameters'
bound has a floor of 1e-3 lr: Adam divides each gradient by its own root
mean square, so an element whose gradient is a small near-cancelling
sum keeps that sum's relative rounding error in a step of about lr. The
cross attention's query bias and the LayerNorm before it have such
elements (gradients down to ~2e-3 of their leaf's largest, each sum
~5e-10 apart between the frameworks: relative errors up to 5e-4 at the
first step); their parameters end up to 4.5e-7 = 2.2e-4 lr apart after
four steps, which 1e-5 of their largest |value| (~7e-3) would not take.
A wrong update would put them ~lr apart. bf16 compute:
losses within 1e-3; m and v within 10% of each leaf's largest |value|;
the parameters all within 6 lr, their mean difference within lr / 20
and at most 1% of them more than lr / 4 apart.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from apex_tpu.models.t5 import T5Model as RefModel
from apex_tpu.models.t5 import t5_loss_fn as ref_loss
from apex_tpu.optimizers import FusedAdam as RefAdam

from apex_tpu_torch.models import (
    PretrainStep,
    T5Model,
    load_jax_opt_state,
    load_jax_params,
    t5_params_from_jax,
    t5_pretrain_loss,
)
from apex_tpu_torch.optimizers import FusedAdam
from test_torch_t5 import _key_bias, batch, port_config, ref_config

LR = 2e-3
LOSS_ATOL = {"fp32": 2e-6, "bf16": 1e-3}
MV_REL = {"fp32": 1e-5, "bf16": 0.1}
PARAM_REL_FP32 = 1e-5
PARAM_FLOOR_FP32 = 1e-3 * LR


def _unpack(state, buf):
    return jax.tree_util.tree_map(
        np.asarray, state.space.unpack(buf, dtype="buffer"))


@pytest.fixture(scope="module", params=["fp32-softmax", "bf16-softmax",
                                        "fp32-flash"])
def trained(request):
    dt, backend = request.param.split("-")
    rmodel = RefModel(ref_config(backend, dt))
    batches = [batch(seed) for seed in range(4)]
    params = rmodel.init(jax.random.PRNGKey(0),
                         *(jnp.asarray(a) for a in batches[0][:3]))
    ropt = RefAdam(lr=LR, weight_decay=0.01, impl="xla")
    rs = ropt.init(params)

    @jax.jit
    def ref_step(state, enc, keep, dec, labels, loss_mask):
        def loss_of(p):
            return ref_loss(rmodel.apply(p, enc, keep, dec), labels,
                            loss_mask)
        loss, grads = jax.value_and_grad(loss_of)(
            state.space.unpack(state.master))
        _, state = ropt.step(state, grads)
        return state, loss

    rs, _ = ref_step(rs, *batches[0])
    cfg = port_config(backend, dt)
    model = load_jax_params(T5Model(cfg, device="cpu"),
                            _unpack(rs, rs.master))
    step = PretrainStep(model, FusedAdam(lr=LR, weight_decay=0.01),
                        loss_fn=t5_pretrain_loss)
    ps = load_jax_opt_state(step.init(), cfg, {
        "master": _unpack(rs, rs.master), "m": _unpack(rs, rs.slots["m"]),
        "v": _unpack(rs, rs.slots["v"]), "count": int(rs.count)})
    losses = []
    for b in batches[1:]:
        rs, rl = ref_step(rs, *b)
        ps, pl = step(ps, *(torch.from_numpy(a) for a in b))
        losses.append((float(rl), float(pl)))
    return dt, cfg, rs, ps, model, losses


def test_t5_adam_losses_match_each_step(trained):
    dt, _, _, _, _, losses = trained
    for want, got in losses:
        assert np.isfinite(got)
        assert abs(got - want) <= LOSS_ATOL[dt], losses
    assert losses[-1][1] < losses[0][1] + 0.5      # trains, no blow-up


def test_t5_adam_state_matches_after_three_steps(trained):
    dt, cfg, rs, ps, _, _ = trained
    assert ps.count == int(rs.count) == 4
    for name, rbuf, pbuf in (("master", rs.master, ps.master),
                             ("m", rs.slots["m"], ps.slots["m"]),
                             ("v", rs.slots["v"], ps.slots["v"])):
        want = t5_params_from_jax(_unpack(rs, rbuf), cfg)
        got = ps.space.unpack(pbuf, "buffer")
        assert set(got) == set(want)
        diffs = []
        for leaf, w in want.items():
            diff = (got[leaf] - w).abs()
            diffs.append(diff.reshape(-1))
            if name == "master" and dt == "bf16":
                continue                     # held as a whole below
            key = _key_bias(leaf)
            if key is not None:
                if name == "master":
                    assert float(diff[key].max()) <= 6 * LR, leaf
                diff, w = diff[~key], w[~key]
            if name == "master":
                bound = max(PARAM_REL_FP32 * float(w.abs().max()),
                            PARAM_FLOOR_FP32)
            else:
                bound = MV_REL[dt] * float(w.abs().max())
            assert float(diff.max()) <= bound, (name, leaf, float(diff.max()))
        if name == "master" and dt == "bf16":
            d = torch.cat(diffs)
            assert float(d.max()) <= 6 * LR
            assert float(d.mean()) <= LR / 20
            assert float((d > LR / 4).float().mean()) <= 0.01


def test_t5_model_is_bound_to_the_master(trained):
    _, _, _, ps, model, _ = trained
    views = ps.space.unpack(ps.master, "buffer")
    for name, p in model.named_parameters():
        assert p.data_ptr() == views[name].data_ptr()


def test_t5_loss_falls_on_one_batch_under_both_backends():
    for backend in ("softmax", "flash"):
        model = T5Model(port_config(backend), device="cpu",
                        generator=torch.Generator().manual_seed(0))
        step = PretrainStep(model, FusedAdam(lr=1e-2),
                            loss_fn=t5_pretrain_loss)
        state = step.init()
        b = [torch.from_numpy(a) for a in batch(5)]
        losses = []
        for _ in range(5):
            state, loss = step(state, *b)
            losses.append(float(loss))
        assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
