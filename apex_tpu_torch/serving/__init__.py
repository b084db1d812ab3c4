"""Serving: paged KV cache, prefill/decode steps, the
continuous-batching scheduler with its resilience and request planes,
and the fleet router over several engines (counterpart of
``apex_tpu/serving/``).

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
from apex_tpu_torch.serving.resilience import (
    SnapshotError,
    WeightSwapError,
    latest_snapshot,
    load_snapshot,
    merge_results,
    params_digest,
    params_fingerprint,
    params_signature,
    resume_requests,
    save_snapshot,
    swap_weights,
    validate_snapshot,
)
from apex_tpu_torch.serving.scheduler import (
    ContinuousBatcher,
    Request,
    RequestResult,
    serve_loop,
    static_batch_generate,
)
from apex_tpu_torch.serving.tracing import (
    RequestTrace,
    RequestTracer,
)

# imported last: the router fronts the scheduler, resilience and tracing
# modules above
from apex_tpu_torch.serving.fleet import (  # noqa: E402
    ENGINE_ROLES,
    ENGINE_STATES,
    EngineHandle,
    FleetRouter,
    fleet_serve_loop,
)

__all__ = [
    "ContinuousBatcher",
    "DecodeStep",
    "ENGINE_ROLES",
    "ENGINE_STATES",
    "EngineHandle",
    "FleetRouter",
    "KVCache",
    "KVCacheState",
    "PoolExhausted",
    "PrefixMatch",
    "Request",
    "RequestResult",
    "RequestTrace",
    "RequestTracer",
    "SnapshotError",
    "StepOut",
    "TRASH_BLOCK",
    "WeightSwapError",
    "append_kv",
    "append_kv_chunk",
    "append_kv_prefill",
    "apply_copies",
    "fleet_serve_loop",
    "gather_kv",
    "greedy_sampling",
    "latest_snapshot",
    "load_snapshot",
    "make_decode_step",
    "merge_results",
    "params_digest",
    "params_fingerprint",
    "params_signature",
    "resume_requests",
    "save_snapshot",
    "scrub_blocks",
    "select_token",
    "serve_loop",
    "static_batch_generate",
    "swap_weights",
    "validate_snapshot",
]
