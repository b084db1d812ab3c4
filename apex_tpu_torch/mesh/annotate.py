"""The serving side of the mesh: a model-sharded GPT checkpoint and a KV
pool of this rank's kv heads.

Counterpart of ``apex_tpu/mesh/annotate.py`` (:24-188).
:func:`shard_params_for_serving` gives this rank's shard of a GPT
checkpoint (column kernels on the output dim, row kernels on the input
dim, the embedding on the vocab: the training plan's dims) and
:func:`shard_kv_pool` this rank's kv heads of a paged pool, so that
prefill, chunked prefill and decode run each attention head where its
K/V lives and need no collective before the output projection.

The reference's ``constrain_*`` helpers are not ported: they are XLA
layout hints (``with_sharding_constraint``) that let the compiler place
the collectives, and here the tensor-parallel layers place every
collective themselves, so a hint would have nothing to act on.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import torch

from apex_tpu_torch.mesh import mesh as _mesh


def mesh_active() -> bool:
    """True where a mesh of more than one rank is armed."""
    return _mesh.mesh_initialized() and _mesh.mesh_size() > 1


def _live(mesh: Optional[_mesh.Mesh]) -> Optional[_mesh.Mesh]:
    if mesh is not None:
        return mesh
    return _mesh.current_mesh() if _mesh.mesh_initialized() else None


def serving_param_shardings(params: Any, *, mesh=None) -> Dict[str, tuple]:
    """The spec a parameter name of a model-sharded serving checkpoint:
    the GPT plan's (the tensor axis renamed ``model``) on the given or
    the current mesh."""
    return _mesh.plan_gpt(params, mesh=mesh).param_specs


def shard_params_for_serving(params: Mapping[str, torch.Tensor], *,
                             mesh=None) -> Mapping[str, torch.Tensor]:
    """This rank's shard of a full GPT checkpoint (by name); the
    checkpoint itself without a mesh or on a mesh of one rank."""
    m = _live(mesh)
    if m is None:
        return params
    return _mesh.plan_gpt(params, mesh=m).shard_params(params)


def shard_kv_pool(state, *, mesh=None):
    """A paged ``KVCacheState`` (pools ``(layers, blocks + 1, block_size,
    kv_heads, head_dim)``) cut to this rank's kv heads along the
    ``model`` axis: the heads whose qkv rows the rank holds. The state
    itself without a mesh or on a mesh of one rank."""
    m = _live(mesh)
    if m is None or m.size <= 1:
        return state
    n, i = m.shape[_mesh.MODEL_AXIS], m.coords[_mesh.MODEL_AXIS]
    if n == 1:
        return state

    def cut(pool: torch.Tensor) -> torch.Tensor:
        heads = pool.shape[3]
        if heads % n:
            raise ValueError(f"{heads} kv heads do not split over "
                             f"model={n}")
        per = heads // n
        return pool[:, :, :, i * per:(i + 1) * per].contiguous()

    return type(state)(*[cut(p) for p in state])


__all__ = ["mesh_active", "serving_param_shardings", "shard_kv_pool",
           "shard_params_for_serving"]
