"""Serving: paged KV cache, prefill/decode steps and the
continuous-batching scheduler (counterpart of ``apex_tpu/serving/``).

    from apex_tpu_torch.models import GPTConfig, GPTModel
    from apex_tpu_torch.serving import (ContinuousBatcher, KVCache,
                                        Request, serve_loop)

    model = GPTModel(cfg)                      # on the CUDA device
    cache = KVCache.for_config(cfg, num_blocks=512)
    state = cache.init_state()
    batcher = ContinuousBatcher(model, cache, prefill_chunk=256)
    state, results = serve_loop(batcher, state, requests)
"""

from apex_tpu_torch.serving.decode import (
    DecodeStep,
    StepOut,
    greedy_sampling,
    make_decode_step,
    select_token,
)
from apex_tpu_torch.serving.kv_cache import (
    TRASH_BLOCK,
    KVCache,
    KVCacheState,
    PoolExhausted,
    PrefixMatch,
    append_kv,
    append_kv_chunk,
    append_kv_prefill,
    apply_copies,
    gather_kv,
    scrub_blocks,
)
from apex_tpu_torch.serving.scheduler import (
    ContinuousBatcher,
    Request,
    RequestResult,
    serve_loop,
    static_batch_generate,
)

__all__ = [
    "ContinuousBatcher",
    "DecodeStep",
    "KVCache",
    "KVCacheState",
    "PoolExhausted",
    "PrefixMatch",
    "Request",
    "RequestResult",
    "StepOut",
    "TRASH_BLOCK",
    "append_kv",
    "append_kv_chunk",
    "append_kv_prefill",
    "apply_copies",
    "gather_kv",
    "greedy_sampling",
    "make_decode_step",
    "scrub_blocks",
    "select_token",
    "serve_loop",
    "static_batch_generate",
]
