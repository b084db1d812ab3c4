"""An O1 model written against ``amp.F``, trained with FusedSGD under the
fused train step.

Port of ``examples/amp_functional/main.py``. The model calls ``amp.F``,
the namespace with amp's op classification applied, and
``amp.initialize`` activates the policy: under O1 the convolution and
the linears run in fp16, the LayerNorm, GELU and the loss in fp32, and
``relu`` keeps its input's dtype. Each step takes the gradient of the
scaled loss straight into the flat master (``space.grad_fn``) and the
train step (``make_train_step``) unscales it inside the SGD update,
skips on overflow and advances the loss scale::

    python -m apex_tpu_torch.examples.amp_functional [--opt-level O4]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from apex_tpu_torch import amp
from apex_tpu_torch._backend import DeviceLike, resolve_device
from apex_tpu_torch.optimizers import FusedSGD, make_train_step

F = amp.F
STEPS = 30


def model(params, x):
    """conv 3x3 -> relu -> linear -> LayerNorm -> GELU -> linear."""
    h = F.conv2d(x, params["conv_w"], params["conv_b"], padding=1)
    h = F.relu(h)                                   # keeps its input's dtype
    h = h.reshape(h.shape[0], -1)
    h = F.linear(h, params["fc1_w"], params["fc1_b"])
    h = F.layer_norm(h, h.shape[-1])                # fp32 always
    h = F.gelu(h)
    return F.linear(h, params["fc2_w"], params["fc2_b"])


def data_and_params(device):
    """The reference's data and weights, drawn from the same numpy seed
    in the same order."""
    rng = np.random.RandomState(0)
    n, c, s, classes = 64, 3, 8, 10
    x = rng.randn(n, c, s, s).astype(np.float32)
    y = rng.randint(0, classes, (n,))
    params = {
        "conv_w": rng.randn(8, c, 3, 3).astype(np.float32) * 0.2,
        "conv_b": np.zeros((8,), np.float32),
        "fc1_w": rng.randn(32, 8 * s * s).astype(np.float32) * 0.05,
        "fc1_b": np.zeros((32,), np.float32),
        "fc2_w": rng.randn(classes, 32).astype(np.float32) * 0.1,
        "fc2_b": np.zeros((classes,), np.float32),
    }
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa
    return t(x), t(y).long(), {k: t(v) for k, v in params.items()}


def main(device: DeviceLike = None, opt_level: str = "O1",
         steps: int = STEPS) -> dict:
    """Train ``steps`` steps; returns the losses and the loss scale after
    each step. The amp policy ``amp.initialize`` activates is the
    caller's again on return."""
    dev = resolve_device(device)
    x, y, params = data_and_params(dev)
    opt = FusedSGD(lr=0.05, momentum=0.9)
    with amp.policy_scope(amp._amp_state.get_active()):
        params, opt_state, amp_state = amp.initialize(params, opt,
                                                      opt_level=opt_level)

        def loss_fn(p):
            return F.cross_entropy(model(p, x), y)   # fp32 (blacklisted)

        scaler = amp.make_scaler(amp_state.properties)
        step = make_train_step(opt, scaler=scaler)
        scaler_state = amp_state.scalers[0]
        # the gradient of the scaled loss, straight into the flat buffer
        flat_vg = opt_state.space.grad_fn(
            lambda p, scale: loss_fn(p) * scale, with_value=True)
        losses, scales = [], []
        for _ in range(steps):
            scale = scaler_state.loss_scale
            scaled_loss, g = flat_vg(opt_state.master, scale)
            losses.append(float(scaled_loss) / scale)
            opt_state, scaler_state, _ = step(opt_state, g, scaler_state)
            scales.append(scaler_state.loss_scale)
    print(f"{opt_level} training: loss {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"(scale {scales[-1]:.0f})")
    return {"losses": losses, "scales": scales, "state": opt_state}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--opt-level", default="O1")
    ap.add_argument("--device", default=None)
    a = ap.parse_args()
    out = main(a.device, a.opt_level)
    assert out["losses"][-1] < out["losses"][0], "loss did not improve"
