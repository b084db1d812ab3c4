"""Models (counterpart of ``apex_tpu/models/``): GPT for serving and
single-device pretraining."""

from apex_tpu_torch.models.convert import (
    gpt_params_from_jax,
    load_jax_opt_state,
    load_jax_params,
)
from apex_tpu_torch.models.gpt import GPTConfig, GPTModel, gpt_loss_fn
from apex_tpu_torch.models.pretrain import (
    PretrainStep,
    init_gpt_pretrain_params,
    make_gpt_pretrain_step,
)

__all__ = ["GPTConfig", "GPTModel", "PretrainStep", "gpt_loss_fn",
           "gpt_params_from_jax", "init_gpt_pretrain_params",
           "load_jax_opt_state", "load_jax_params",
           "make_gpt_pretrain_step"]
