"""Models (counterpart of ``apex_tpu/models/``): GPT for serving and
pretraining, on one device or tensor-parallel; BERT, T5 and ResNet for
single-device pretraining (ResNet also data-parallel)."""

from apex_tpu_torch.models.bert import (
    BertConfig,
    BertModel,
    bert_extended_attention_mask,
    bert_loss_fn,
    bert_param_specs,
)
from apex_tpu_torch.models.convert import (
    bert_params_from_jax,
    dcgan_params_from_jax,
    gpt_params_from_jax,
    gpt_shard_from_jax,
    load_jax_opt_state,
    load_jax_params,
    load_jax_resnet,
    multihead_attn_params_from_jax,
    resnet_params_from_jax,
    t5_params_from_jax,
)
from apex_tpu_torch.models.gpt import (
    GPTConfig,
    GPTModel,
    gpt_loss_fn,
    gpt_param_specs,
)
from apex_tpu_torch.models.resnet import (
    ResNet,
    ResNetBottleneckBlock,
    ResNetConfig,
    cross_entropy_logits,
)
from apex_tpu_torch.models.t5 import (
    T5Config,
    T5Model,
    encoder_decoder_stage_layout,
    t5_loss_fn,
    t5_param_specs,
    t5_pretrain_loss,
)
from apex_tpu_torch.models.pretrain import (
    PretrainStep,
    init_gpt_pretrain_params,
    make_gpt_pretrain_step,
)

__all__ = ["BertConfig", "BertModel", "GPTConfig", "GPTModel",
           "PretrainStep", "ResNet", "ResNetBottleneckBlock", "ResNetConfig",
           "T5Config", "T5Model", "encoder_decoder_stage_layout",
           "bert_extended_attention_mask", "bert_loss_fn", "bert_param_specs",
           "bert_params_from_jax", "cross_entropy_logits",
           "dcgan_params_from_jax", "gpt_loss_fn", "gpt_param_specs",
           "gpt_params_from_jax", "gpt_shard_from_jax",
           "init_gpt_pretrain_params",
           "load_jax_opt_state", "load_jax_params", "load_jax_resnet",
           "make_gpt_pretrain_step", "multihead_attn_params_from_jax",
           "resnet_params_from_jax", "t5_loss_fn", "t5_param_specs",
           "t5_params_from_jax",
           "t5_pretrain_loss"]
