"""Contributed ops (counterpart of ``apex_tpu/contrib/``). Ported so far:
``bottleneck.conv2d_nhwc``, ``clip_grad.clip_grad_norm_`` and
``xentropy`` (``softmax_cross_entropy``, ``SoftmaxCrossEntropyLoss``)."""
