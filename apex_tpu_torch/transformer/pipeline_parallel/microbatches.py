"""Microbatch calculators.

Counterpart of ``apex_tpu/transformer/pipeline_parallel/microbatches.py``
(:1-120), host-only: :class:`ConstantNumMicroBatches`,
:class:`RampupBatchsizeNumMicroBatches` (a linear global-batch ramp) and
:func:`build_num_microbatches_calculator`, which picks one by whether a
ramp is given. The messages and the rounding are the reference's.
"""

from __future__ import annotations

from typing import Optional, Sequence


class NumMicroBatchesCalculator:
    def __init__(self):
        self.num_micro_batches: Optional[int] = None
        self.current_global_batch_size: Optional[int] = None

    def get(self) -> int:
        return self.num_micro_batches

    def get_current_global_batch_size(self) -> int:
        return self.current_global_batch_size

    def update(self, consumed_samples, consistency_check) -> None:
        pass


class ConstantNumMicroBatches(NumMicroBatchesCalculator):
    """``global_batch_size / (micro_batch_size * data_parallel_size)``
    microbatches, every step."""

    def __init__(self, global_batch_size: int, micro_batch_size: int,
                 data_parallel_size: int):
        super().__init__()
        micro_batch_times_dp = micro_batch_size * data_parallel_size
        if global_batch_size % micro_batch_times_dp:
            raise ValueError(
                f"global batch size ({global_batch_size}) is not divisible by "
                f"micro batch size ({micro_batch_size}) times data parallel "
                f"size ({data_parallel_size})")
        self.num_micro_batches = global_batch_size // micro_batch_times_dp
        if self.num_micro_batches < 1:
            raise ValueError("num_micro_batches must be at least 1")
        self.current_global_batch_size = global_batch_size
        self.micro_batch_size = micro_batch_size


class RampupBatchsizeNumMicroBatches(NumMicroBatchesCalculator):
    """The global batch grows from ``start_batch_size`` to
    ``global_batch_size`` by ``batch_size_increment`` every
    ``ramup_samples / increments`` consumed samples, rounded down to a
    whole number of microbatches."""

    def __init__(self, start_batch_size: int, batch_size_increment: int,
                 ramup_samples: int, global_batch_size: int,
                 micro_batch_size: int, data_parallel_size: int):
        super().__init__()
        self.micro_batch_size = micro_batch_size
        self.data_parallel_size = data_parallel_size
        self.start_batch_size = start_batch_size
        self.batch_size_increment = batch_size_increment
        self.ramup_samples = ramup_samples
        self.global_batch_size = global_batch_size
        self.micro_batch_times_data_parallel_size = (
            micro_batch_size * data_parallel_size)
        diff = global_batch_size - start_batch_size
        if diff < 0 or diff % batch_size_increment:
            raise ValueError(
                "global batch size must equal start size plus a whole "
                "number of increments")
        num_increments = diff // batch_size_increment
        self.rampup_samples_per_increment = (
            self.ramup_samples / num_increments if num_increments else 0)
        self.update(0, False)

    def update(self, consumed_samples: int, consistency_check: bool) -> None:
        if consumed_samples > self.ramup_samples:
            gbs = self.global_batch_size
        else:
            steps = int(consumed_samples / self.rampup_samples_per_increment)
            gbs = self.start_batch_size + steps * self.batch_size_increment
            gbs = min(gbs, self.global_batch_size)
        per = self.micro_batch_times_data_parallel_size
        if consistency_check and gbs % per:
            raise ValueError(
                f"current global batch size ({gbs}) is not divisible by "
                "micro-batch-size * data-parallel-size")
        self.current_global_batch_size = (gbs // per) * per
        self.num_micro_batches = self.current_global_batch_size // per


def build_num_microbatches_calculator(
    global_batch_size: int,
    micro_batch_size: int,
    data_parallel_size: int,
    rampup_batch_size: Optional[Sequence[int]] = None,
) -> NumMicroBatchesCalculator:
    """A constant calculator, or with ``rampup_batch_size = [start,
    increment, samples]`` the ramp."""
    if rampup_batch_size is None:
        return ConstantNumMicroBatches(global_batch_size, micro_batch_size,
                                       data_parallel_size)
    if len(rampup_batch_size) != 3:
        raise ValueError(
            "rampup_batch_size = [start_batch_size, increment, samples]")
    return RampupBatchsizeNumMicroBatches(
        int(rampup_batch_size[0]), int(rampup_batch_size[1]),
        int(rampup_batch_size[2]), global_batch_size, micro_batch_size,
        data_parallel_size)


__all__ = ["ConstantNumMicroBatches", "NumMicroBatchesCalculator",
           "RampupBatchsizeNumMicroBatches",
           "build_num_microbatches_calculator"]
