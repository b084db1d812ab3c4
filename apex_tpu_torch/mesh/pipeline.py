"""The pipeline schedules' analytic bubble.

Counterpart of ``apex_tpu/mesh/pipeline.py`` ``bubble_fraction``
(:77-86), which the layout planner prices. The schedules themselves
(GPipe, 1F1B, interleaved 1F1B and the asynchronous variant over the
mesh's ``pipe`` axis, ``PipelineSpec`` and the pipeline train step) are
ROADMAP A 9c.
"""

from __future__ import annotations

SCHEDULES = ("gpipe", "1f1b", "interleaved_1f1b", "async_1f1b")


def bubble_fraction(schedule: str, num_stages: int, num_microbatches: int,
                    num_model_chunks: int = 1) -> float:
    """The idle share of one schedule on (stages, microbatches, model
    chunks): ``(s - 1) / (m + s - 1)`` for GPipe and 1F1B, ``(s - 1) /
    (v * m + s - 1)`` interleaved, 0 for the asynchronous schedule's
    steady state and for one stage."""
    s, m, v = int(num_stages), int(num_microbatches), int(num_model_chunks)
    if s <= 1:
        return 0.0
    if schedule == "async_1f1b":
        return 0.0
    if schedule == "interleaved_1f1b":
        return (s - 1) / (v * m + s - 1)
    return (s - 1) / (m + s - 1)


__all__ = ["SCHEDULES", "bubble_fraction"]
