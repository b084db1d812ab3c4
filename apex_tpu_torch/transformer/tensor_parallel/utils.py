"""Tensor-parallel helpers: divisibility, the last-dim split and the vocab
ranges of a row-sharded table.

Counterpart of ``apex_tpu/transformer/tensor_parallel/utils.py``
(:12-48). The split returns views (``torch.split``); the reference's
contiguity flag has no use there and none here.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence, Tuple

import torch


def ensure_divisibility(numerator: int, denominator: int) -> None:
    if numerator % denominator:
        raise ValueError(f"{numerator} is not divisible by {denominator}")


def divide(numerator: int, denominator: int) -> int:
    ensure_divisibility(numerator, denominator)
    return numerator // denominator


def split_tensor_along_last_dim(tensor: torch.Tensor, num_partitions: int
                                ) -> Tuple[torch.Tensor, ...]:
    """``num_partitions`` equal views of ``tensor`` along its last dim."""
    last = divide(tensor.shape[-1], num_partitions)
    return tuple(torch.split(tensor, last, dim=-1))


def shard_tensor(tensor: torch.Tensor, spec: Sequence[Optional[str]],
                 sizes: Mapping[str, int], coords: Mapping[str, int]
                 ) -> torch.Tensor:
    """This rank's block of a full ``tensor`` under ``spec`` (an axis
    name or None a dim, trailing dims replicated): each named dim cut in
    ``sizes[axis]`` equal chunks, chunk ``coords[axis]`` kept. A view."""
    for dim, axis in enumerate(spec):
        n = sizes.get(axis, 1) if axis is not None else 1
        if n == 1:
            continue
        chunk = divide(tensor.shape[dim], n)
        tensor = tensor.narrow(dim, coords[axis] * chunk, chunk)
    return tensor


class VocabUtility:
    """The ``[first, last)`` vocab range a rank's shard of a row-sharded
    table holds."""

    @staticmethod
    def vocab_range_from_per_partition_vocab_size(
            per_partition_vocab_size: int, rank: int, world_size: int
    ) -> Tuple[int, int]:
        f = rank * per_partition_vocab_size
        return f, f + per_partition_vocab_size

    @staticmethod
    def vocab_range_from_global_vocab_size(global_vocab_size: int, rank: int,
                                           world_size: int
                                           ) -> Tuple[int, int]:
        per = divide(global_vocab_size, world_size)
        return VocabUtility.vocab_range_from_per_partition_vocab_size(
            per, rank, world_size)


__all__ = ["VocabUtility", "divide", "ensure_divisibility", "shard_tensor",
           "split_tensor_along_last_dim"]
