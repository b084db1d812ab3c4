"""Contributed ops (counterpart of ``apex_tpu/contrib/``). Ported so far:
``bottleneck.conv2d_nhwc`` and ``clip_grad.clip_grad_norm_``."""
