"""Fused multi-tensor ops over flat buffers.

Counterpart of ``apex_tpu/multi_tensor/ops.py``. Ported so far: the
Adam / AdamW update, whose functor runs as the kernel in
``csrc/fused_adam.cu`` on CUDA buffers and as plain PyTorch on CPU
buffers. The other functors (scale, axpby, the L2 norms, Adagrad, SGD,
LAMB, NovoGrad, LARS) wait for their kernels.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from apex_tpu_torch import _build
from apex_tpu_torch._backend import check_kernel_input
from apex_tpu_torch.multi_tensor.engine import (
    fused_elementwise,
    register_kernel,
)

ADAM_KERNEL = "fused_adam"


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def _adam_fn(ins: Sequence[torch.Tensor], s: Sequence[torch.Tensor], _
             ) -> List[torch.Tensor]:
    """The reference's Adam functor (``fused_adam_update`` :161-173),
    one elementwise op at a time on fp32 0-d scalars."""
    p_, m_, v_, g_ = [x.float() for x in ins]
    lr_, b1, b2, eps_, wd, bc1_, bc2_, mode_, inv_scale = s
    g_ = g_ * inv_scale
    g_l2 = g_ + wd * p_
    g_eff = torch.where(mode_ > 0.5, g_, g_l2)
    m2 = b1 * m_ + (1.0 - b1) * g_eff
    v2 = b2 * v_ + (1.0 - b2) * g_eff * g_eff
    mhat = m2 / bc1_
    vhat = v2 / bc2_
    upd = mhat / (torch.sqrt(vhat) + eps_)
    upd = upd + torch.where(mode_ > 0.5, wd * p_, 0.0)
    return [p_ - lr_ * upd, m2, v2]


def _adam_kernel(inputs, outputs, scalars, found, check_finite) -> None:
    """Launch ``csrc/fused_adam.cu`` for :func:`_adam_fn`."""
    if check_finite != (3,):
        raise NotImplementedError(
            f"the Adam kernel checks the gradient (input 3) for "
            f"non-finite values; check_finite={check_finite} is not built")
    dev = inputs[0].device
    for name, t in zip(("p", "m", "v", "g", "p_out", "m_out", "v_out"),
                       (*inputs, *outputs)):
        check_kernel_input(name, t, (torch.float32,), dev)
    lr, b1, b2, eps, wd, bc1, bc2, mode, inv_scale = scalars
    P, L, F, I = _build.P, _build.L, _build.F, _build.I
    lib = _build.library("fused_adam", "apex_adam",
                         (P,) * 8 + (L,) + (F,) * 8 + (I, P),
                         "apex_adam_error_string")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.apex_adam(*(t.data_ptr() for t in (*inputs, *outputs)),
                            found.data_ptr(), inputs[0].numel(), lr, b1, b2,
                            eps, wd, bc1, bc2, inv_scale, int(mode > 0.5),
                            stream)
    if err:
        raise RuntimeError(f"{ADAM_KERNEL}: CUDA error {err} at launch: "
                           f"{lib.apex_adam_error_string(err).decode()}")
    _build.count_launch(ADAM_KERNEL)


register_kernel(_adam_fn, _adam_kernel)


def fused_adam_update(
    p, m, v, g, *,
    lr, beta1=0.9, beta2=0.999, eps=1e-8, step=1,
    adam_w_mode=True, bias_correction=True, weight_decay=0.0,
    grad_scale=1.0, in_place=True, plain=False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One fused Adam/AdamW step over flat fp32 buffers.

    ``adam_w_mode`` selects decoupled weight decay (AdamW) against L2
    regularisation; ``grad_scale`` divides the gradient inside the same
    sweep. The bias corrections are computed in fp32 as the reference
    computes them (:153-158). With ``in_place`` (the default, the
    reference's aliasing) p, m and v are overwritten and returned; with
    ``in_place=False`` they are left as they were and the results are
    new buffers. ``plain=True`` runs the plain version on any device
    (the kernel's yardstick on the card). Returns ``(p', m', v',
    found_inf)``, ``found_inf`` covering the raw gradients."""
    step_t = _f32(float(step))
    bc1 = 1.0 - torch.pow(_f32(beta1), step_t)
    bc2 = 1.0 - torch.pow(_f32(beta2), step_t)
    if not bias_correction:
        bc1 = bc2 = _f32(1.0)
    mode = 1.0 if adam_w_mode else 0.0
    (p2, m2, v2), found = fused_elementwise(
        _adam_fn, [p, m, v, g],
        scalars=[lr, beta1, beta2, eps, weight_decay, bc1, bc2, mode,
                 1.0 / _f32(grad_scale)],
        num_outputs=3, out_dtypes=[p.dtype, m.dtype, v.dtype],
        check_finite=(3,),
        aliases={0: 0, 1: 1, 2: 2} if in_place else None,
        kernel=False if plain else None)
    return p2, m2, v2, found


__all__ = ["ADAM_KERNEL", "fused_adam_update"]
