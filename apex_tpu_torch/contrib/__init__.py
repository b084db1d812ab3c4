"""Contributed ops (counterpart of ``apex_tpu/contrib/``). Ported so far:
``bottleneck.conv2d_nhwc``, ``clip_grad.clip_grad_norm_``,
``multihead_attn`` (``SelfMultiheadAttn``, ``EncdecMultiheadAttn``),
``optimizers`` (ZeRO: ``DistributedFusedAdam``, ``DistributedFusedLAMB``)
and ``xentropy`` (``softmax_cross_entropy``, ``SoftmaxCrossEntropyLoss``)."""
