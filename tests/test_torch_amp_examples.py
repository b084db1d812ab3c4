"""The ported amp examples against the reference's on the CPU.

- ``apex_tpu_torch.examples.amp_functional`` against
  ``examples/amp_functional/main.py``: the same model (through each side's
  ``amp.F``), the same data and weights (one numpy seed, drawn in the same
  order), the same loop (FusedSGD under ``make_train_step`` with amp's
  scaler, the gradient of the scaled loss into the flat master), under O1
  and O4. The losses step by step within ``O1_LOSS_RTOL``: under O1 the
  convolution and linears round to fp16 (O4 bf16) on both sides, and 30
  SGD steps with momentum carry those roundings on (read here: 5.6e-4 and
  2.6e-3 at worst; about 4x is held); the scales equal.
- ``apex_tpu_torch.examples.dcgan_amp`` against ``examples/dcgan/
  main_amp.py`` at ``--steps 3``, batch 4, feat 8, image 16, the
  reference's Flax weights carried across by ``dcgan_params_from_jax``:
  first each module's forward (within ``FWD_ATOL``: fp32 convolutions and
  GroupNorm sums in other orders; read 3.7e-7), then lossD and lossG step
  by step (within ``DCGAN_LOSS_ATOL``, read 1.2e-7; the noise ``z`` is
  drawn by the port's threefry ``normal``, within a few ulps of
  ``jax.random.normal``, held here too) and the scales, clean and with a
  nan in the discriminator's gradient at one step (its scaler halves,
  the generator's does not).
- At the widths the card runs (batch 64, nz 100, 64 features), why one
  leaf of the discriminator's gradient reads farther than the rest from
  another device's: ``dense.bias``'s gradient is the sum of the real
  half's ``mean(sigmoid - 1)`` and the fake half's ``mean(sigmoid)``,
  which nearly cancel at random weights (read: -0.518 + 0.526, the sum
  146 times smaller than its terms' magnitudes). Its fp32 gradient reads
  2.5e-6 from fp64 here, every other leaf at most 6.8e-7. Held: the
  cancellation (``D_BIAS_MIN_CANCEL``), ``dense.bias`` the leaf farthest
  from fp64, and its fp32 error within ``D_BIAS_ATOL`` of its terms'
  magnitudes.
"""

import copy
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from apex_tpu import amp as ref_amp
from apex_tpu.optimizers import FusedAdam as RefAdam
from apex_tpu.optimizers import FusedSGD as RefSGD
from apex_tpu.optimizers import make_train_step as ref_make_train_step

from apex_tpu_torch import amp
from apex_tpu_torch import random as jrandom
from apex_tpu_torch.examples import amp_functional, dcgan_amp
from apex_tpu_torch.models import dcgan_params_from_jax

ROOT = Path(__file__).resolve().parent.parent
O1_LOSS_RTOL = {"O1": 2e-3, "O4": 1e-2}
FWD_ATOL = 2e-6
DCGAN_LOSS_ATOL = 1e-6
NORMAL_ULPS = 4
CARD_ARGS = ["--batch-size", "64", "--nz", "100", "--feat", "64"]
D_BIAS_MIN_CANCEL = 50.0
D_BIAS_ATOL = 1e-6


def _load(rel, name):
    spec = importlib.util.spec_from_file_location(name, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod          # its dataclasses look themselves up
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ref_o1():
    return _load("examples/amp_functional/main.py", "ref_amp_functional")


@pytest.fixture(scope="module")
def ref_dcgan():
    return _load("examples/dcgan/main_amp.py", "ref_dcgan_amp")


@pytest.fixture(autouse=True)
def _restore_policy():
    """amp.initialize activates a process-global policy on both sides."""
    from apex_tpu.amp import _amp_state as ref_state
    prev = ref_state.get_active()
    yield
    ref_state.set_active(prev)


def _ref_o1_losses(mod, opt_level):
    """The reference main's loop, its losses and scales returned."""
    rng = np.random.RandomState(0)
    n, c, s, classes = 64, 3, 8, 10
    X = jnp.asarray(rng.randn(n, c, s, s).astype(np.float32))
    Y = jnp.asarray(rng.randint(0, classes, (n,)))
    params = {
        "conv_w": jnp.asarray(rng.randn(8, c, 3, 3).astype(np.float32) * 0.2),
        "conv_b": jnp.zeros((8,)),
        "fc1_w": jnp.asarray(
            rng.randn(32, 8 * s * s).astype(np.float32) * 0.05),
        "fc1_b": jnp.zeros((32,)),
        "fc2_w": jnp.asarray(rng.randn(classes, 32).astype(np.float32) * 0.1),
        "fc2_b": jnp.zeros((classes,)),
    }
    opt = RefSGD(lr=0.05, momentum=0.9)
    params, opt_state, amp_state = ref_amp.initialize(params, opt,
                                                      opt_level=opt_level)

    def loss_fn(p):
        return mod.F.cross_entropy(mod.model(p, X), Y)

    step = ref_make_train_step(opt, scaler=ref_amp.make_scaler(
        amp_state.properties))
    scaler_state = amp_state.scalers[0]
    flat_vg = jax.jit(opt_state.space.grad_fn(
        lambda p, scale: loss_fn(p) * scale, with_value=True))
    losses, scales = [], []
    for _ in range(amp_functional.STEPS):
        scale = scaler_state.loss_scale
        scaled_loss, g = flat_vg(opt_state.master, scale)
        losses.append(float(scaled_loss) / float(scale))
        opt_state, scaler_state, _ = step(opt_state, g, scaler_state)
        scales.append(float(scaler_state.loss_scale))
    return losses, scales


@pytest.mark.parametrize("opt_level", ["O1", "O4"])
def test_amp_functional_matches_reference(ref_o1, opt_level):
    want, want_scales = _ref_o1_losses(ref_o1, opt_level)
    before = amp._amp_state.get_active()
    got = amp_functional.main("cpu", opt_level)
    assert got["scales"] == want_scales
    np.testing.assert_allclose(got["losses"], want, rtol=O1_LOSS_RTOL[
        opt_level], atol=0)
    assert got["losses"][-1] < got["losses"][0]
    assert amp._amp_state.get_active() is before      # the caller's again


ARGS = ["--steps", "3", "--batch-size", "4", "--feat", "8"]


def _ref_dcgan(mod, args, poison_step=None):
    """The reference main's loop on ``args``: its initial weights and
    the losses and scales of each step (with a nan in the discriminator's
    gradient at ``poison_step``)."""
    rng = np.random.RandomState(0)
    real = jnp.asarray(
        rng.rand(args.batch_size, args.image_size, args.image_size, 3) * 2
        - 1, jnp.float32)
    netG, netD = mod.Generator(feat=args.feat), mod.Discriminator(
        feat=args.feat)
    z0 = jnp.asarray(rng.randn(args.batch_size, args.nz), jnp.float32)
    pG = netG.init(jax.random.PRNGKey(0), z0)
    pD = netD.init(jax.random.PRNGKey(1), real)
    init = (jax.tree_util.tree_map(np.asarray, pG),
            jax.tree_util.tree_map(np.asarray, pD))
    optG = RefAdam(lr=args.lr, betas=(0.5, 0.999), impl="xla")
    optD = RefAdam(lr=args.lr, betas=(0.5, 0.999), impl="xla")
    pD, sD, ampD = ref_amp.initialize(pD, optD, opt_level=args.opt_level)
    pG, sG, ampG = ref_amp.initialize(pG, optG, opt_level=args.opt_level)
    scaler = ref_amp.make_scaler(ampD.properties)
    ssD, ssG = ampD.scalers[0], ampG.scalers[0]

    @jax.jit
    def stepD(pD, pG, sD, ssD, z, poison):
        def lossD(p):
            fake = netG.apply(pG, z)
            return (mod.bce_logits(netD.apply(p, real), 1.0)
                    + mod.bce_logits(netD.apply(p, fake), 0.0))
        sloss, g = jax.value_and_grad(
            lambda p: scaler.scale_loss(lossD(p), ssD))(pD)
        dense = g["params"]["Dense_0"]
        dense["bias"] = jnp.where(poison, jnp.nan, dense["bias"])
        pD2, sD = optD.step(sD, g, grad_scale=ssD.loss_scale,
                            skip_if_nonfinite=True)
        return pD2, sD, scaler.update(ssD, sD.found_inf), sloss

    @jax.jit
    def stepG(pG, pD, sG, ssG, z):
        def lossG(p):
            return mod.bce_logits(netD.apply(pD, netG.apply(p, z)), 1.0)
        sloss, g = jax.value_and_grad(
            lambda p: scaler.scale_loss(lossG(p), ssG))(pG)
        pG2, sG = optG.step(sG, g, grad_scale=ssG.loss_scale,
                            skip_if_nonfinite=True)
        return pG2, sG, scaler.update(ssG, sG.found_inf), sloss

    out = {"lossD": [], "lossG": [], "scaleD": [], "scaleG": []}
    key = jax.random.PRNGKey(2)
    for i in range(args.steps):
        key, kz = jax.random.split(key)
        z = jax.random.normal(kz, (args.batch_size, args.nz))
        scale = float(ssD.loss_scale)
        pD, sD, ssD, lD = stepD(pD, pG, sD, ssD, z, i == poison_step)
        out["lossD"].append(float(lD) / scale)
        scale = float(ssG.loss_scale)
        pG, sG, ssG, lG = stepG(pG, pD, sG, ssG, z)
        out["lossG"].append(float(lG) / scale)
        out["scaleD"].append(float(ssD.loss_scale))
        out["scaleG"].append(float(ssG.loss_scale))
    return init, out, (netG, netD)


def _port_nets(init, args):
    netG, netD = dcgan_amp.build(args, "cpu")
    netG.load_state_dict(dcgan_params_from_jax(init[0], "generator"))
    netD.load_state_dict(dcgan_params_from_jax(init[1], "discriminator"))
    return netG, netD


POISON_STEP = 1


@pytest.fixture(scope="module", params=[None, POISON_STEP],
                ids=["clean", "d_overflows"])
def dcgan_run(ref_dcgan, request):
    from apex_tpu.amp import _amp_state as ref_state
    prev = ref_state.get_active()
    args = dcgan_amp.parse(ARGS)
    init, want, ref_nets = _ref_dcgan(ref_dcgan, args, request.param)
    ref_state.set_active(prev)
    return args, init, want, ref_nets, request.param


def test_dcgan_modules_match_reference(dcgan_run):
    args, init, _, (rG, rD), _ = dcgan_run
    netG, netD = _port_nets(init, args)
    z = np.random.RandomState(5).randn(args.batch_size, args.nz).astype(
        np.float32)
    want = np.asarray(rG.apply(init[0], jnp.asarray(z)))
    with torch.no_grad():
        fake = netG(torch.from_numpy(z))
    assert fake.shape == want.shape == (args.batch_size, 16, 16, 3)
    np.testing.assert_allclose(fake.numpy(), want, rtol=0, atol=FWD_ATOL)
    want = np.asarray(rD.apply(init[1], jnp.asarray(fake.numpy())))
    with torch.no_grad():
        got = netD(fake)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=FWD_ATOL)


def test_dcgan_losses_match_reference(dcgan_run):
    """Step by step; with a nan in D's gradient at one step the two
    scalers move apart (D's halves, G's does not), as the reference's."""
    args, init, want, _, poison = dcgan_run
    netG, netD = _port_nets(init, args)

    def hook(net, i, g):
        if net == "D" and i == poison:
            g = g.clone()
            g[0] = float("nan")
        return g

    got = dcgan_amp.train(netG, netD, args, "cpu", grad_hook=hook)
    for k in ("lossD", "lossG"):
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=DCGAN_LOSS_ATOL)
    assert got["scaleD"] == want["scaleD"] and got["scaleG"] == want["scaleG"]
    skipped = 0 if poison is None else 1
    assert got["stateD"].count == args.steps - skipped
    assert got["stateG"].count == args.steps
    if poison is not None:
        assert got["scaleD"][poison] == got["scaleG"][poison] / 2


def test_normal_matches_jax():
    key, kz = jax.random.split(jax.random.PRNGKey(2))
    want = np.asarray(jax.random.normal(kz, (64, 100)))
    got = jrandom.normal(jrandom.split(jrandom.PRNGKey(2))[1],
                         (64, 100)).numpy()
    assert (np.abs(got - want) <= NORMAL_ULPS * np.spacing(
        np.abs(want))).all()
    assert (got == want).mean() > 0.9


def test_converter_rejects_wrong_kind(dcgan_run):
    init = dcgan_run[1]
    with pytest.raises(ValueError, match="kind"):
        dcgan_params_from_jax(init[0], "critic")
    with pytest.raises(KeyError, match="DCGAN discriminator"):
        dcgan_params_from_jax(init[0], "discriminator")


def _d_grads(netG, netD, real, z, dtype):
    pD = {n: p.detach().to(dtype).requires_grad_()
          for n, p in netD.named_parameters()}
    pG = {n: p.detach().to(dtype) for n, p in netG.named_parameters()}
    loss = dcgan_amp.d_loss(netD, netG, pD, pG, real.to(dtype),
                            z.to(dtype))
    return dict(zip(pD, torch.autograd.grad(loss, list(pD.values()))))


def test_dcgan_d_bias_gradient_is_a_near_cancelling_sum():
    args = dcgan_amp.parse(CARD_ARGS)
    netG, netD = dcgan_amp.build(args, "cpu")
    real = dcgan_amp.real_images(args, "cpu")
    z = jrandom.normal(jrandom.split(jrandom.PRNGKey(2))[1],
                       (args.batch_size, args.nz))
    g32 = _d_grads(netG, netD, real, z, torch.float32)
    g64 = _d_grads(netG, netD, real, z, torch.float64)
    rel = {n: float((g32[n].double() - g64[n]).norm() / g64[n].norm())
           for n in g64}
    netG64 = copy.deepcopy(netG).double()
    netD64 = copy.deepcopy(netD).double()
    with torch.no_grad():
        lr = netD64(real.double())
        lf = netD64(netG64(z.double()))
    real_term = float((torch.sigmoid(lr) - 1).mean())
    fake_term = float(torch.sigmoid(lf).mean())
    magnitudes = abs(real_term) + abs(fake_term)
    bias = float(g64["dense.bias"])
    print(f"dense.bias = {real_term:.4f} + {fake_term:.4f} = {bias:.4e}; "
          f"fp32 from fp64 by leaf " + ", ".join(
              f"{n} {e:.2e}" for n, e in rel.items()))
    assert abs(real_term + fake_term - bias) <= 1e-12
    assert magnitudes >= D_BIAS_MIN_CANCEL * abs(bias)
    assert max(rel, key=rel.get) == "dense.bias"
    assert (abs(float(g32["dense.bias"]) - bias)
            <= D_BIAS_ATOL * magnitudes)
