"""Automatic (dp, tp, pp) layout planner: an AMP-style analytic search.

Counterpart of ``apex_tpu/mesh/planner.py``: enumerate the exact tilings
of a device count, score each against an analytic cost model (roofline
compute at an assumed MFU, the pipeline schedule's bubble, the wire
bytes of each parallel plane priced by ``telemetry.comms.wire_bytes``
plus a launch latency a collective, and a memory budget) and rank them.
The model orders layouts; it does not predict milliseconds. The
algorithm and its constants are the reference's, unchanged.

The peak rate, when the caller gives none, comes from
:func:`chip_peak_tflops` on the card's name (``torch.cuda.
get_device_name()``): NVIDIA's data sheet for the H100 SXM part (``NVIDIA
H100 80GB HBM3``), 989 TFLOP/s dense bf16 at 700 W. Any other kind (the
CPU, another card) takes :data:`FALLBACK_PEAK_TFLOPS` and the objective
says ``peak_source: "fallback"``, as the reference does. The link rate,
when the caller gives none, is calibrated from the armed comms ledger
(:func:`measured_link_gbps`), else :data:`FALLBACK_LINK_GBPS`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

# dense bf16 tensor-core peak a card, from the card's name: (every
# substring, TFLOP/s). NVIDIA H100 data sheet, SXM part (the name
# torch.cuda.get_device_name gives it), without sparsity, at 700 W.
_PEAK_TFLOPS = ((("h100", "hbm3"), 989.0),)


def device_kind() -> str:
    """The name of the card this process runs on, or ``"cpu"``."""
    import torch

    if torch.cuda.is_available():
        return torch.cuda.get_device_name()
    return "cpu"


def chip_peak_tflops(kind: str) -> Optional[float]:
    """Peak dense bf16 TFLOP/s of a card by its name, or None for a kind
    the table does not hold."""
    name = kind.lower()
    for parts, peak in _PEAK_TFLOPS:
        if all(p in name for p in parts):
            return peak
    return None


# the reference's fallback constants, unchanged: a planner without a
# known card still has to ORDER layouts, so any consistent positive
# numbers work; the sources are marked in the objective dict. They are
# no measurement of the H100 or its links.
FALLBACK_PEAK_TFLOPS = 50.0
FALLBACK_LINK_GBPS = 100.0
ASSUMED_MFU = 0.4
# AMP-style alpha-beta transport: every collective pays a fixed launch
# latency on top of bytes/bandwidth — this is what makes the 8*L
# per-layer tensor-parallel reductions expensive relative to ONE
# bucketed gradient all-reduce even when their byte counts are close
COLLECTIVE_LATENCY_MS = 0.01
# the dp gradient all-reduce overlaps the backward pass (bucketed,
# DDP-style); tp/pp collectives sit on the critical path and don't
DP_OVERLAP = 0.5
FP32 = 4


def enumerate_layouts(n_devices: int) -> List[Tuple[int, int, int]]:
    """All ordered ``(dp, tp, pp)`` with ``dp*tp*pp == n_devices`` —
    the exact tilings of the device count, nothing else."""
    n = int(n_devices)
    if n < 1:
        raise ValueError(f"n_devices must be >= 1, got {n}")
    out = []
    for dp in range(1, n + 1):
        if n % dp:
            continue
        rest = n // dp
        for tp in range(1, rest + 1):
            if rest % tp:
                continue
            out.append((dp, tp, rest // tp))
    return out


#: schedules the planner prices when pp > 1 — the ones
#: :mod:`apex_tpu_torch.mesh.pipeline` can actually run (the experimental
#: async variant changes training semantics, so the planner does not
#: auto-pick it)
PLANNED_SCHEDULES = ("gpipe", "1f1b", "interleaved_1f1b")
#: model chunks per stage the interleaved candidate assumes
INTERLEAVE_CHUNKS = 2


@dataclasses.dataclass(frozen=True)
class LayoutScore:
    """One scored layout — the BEST (schedule, microbatches) candidate
    for its ``(dp, tp, pp)`` tiling (pp=1 rows carry
    ``schedule="none"``). ``total_ms`` is the objective (bubble-scaled
    compute + wire time); ``feasible`` False layouts carry ``reason``
    and always rank below every feasible one."""

    dp: int
    tp: int
    pp: int
    compute_ms: float
    comm_ms: float
    wire_bytes: int
    mem_bytes_per_device: int
    feasible: bool
    reason: Optional[str]
    # trailing defaults keep every pre-PR-16 positional construction
    # (and pickle) working
    schedule: str = "none"
    microbatches: int = 0
    bubble_fraction: float = 0.0
    # MoE expert parallelism (PR-19): the dispatch/combine all-to-all
    # bytes this tiling pays on the ``model`` axis, and the expert
    # count it was priced for (0 = dense, no EP terms)
    ep_wire_bytes: int = 0
    num_experts: int = 0

    @property
    def total_ms(self) -> float:
        return self.compute_ms + self.comm_ms

    def detail(self) -> Dict[str, Any]:
        out = {
            "dp": self.dp, "tp": self.tp, "pp": self.pp,
            "schedule": self.schedule,
            "microbatches": self.microbatches,
            "bubble_fraction": round(self.bubble_fraction, 6),
            "compute_ms": round(self.compute_ms, 4),
            "comm_ms": round(self.comm_ms, 4),
            "total_ms": round(self.total_ms, 4),
            "wire_bytes": int(self.wire_bytes),
            "mem_bytes_per_device": int(self.mem_bytes_per_device),
            "feasible": self.feasible,
            "reason": self.reason,
        }
        if self.num_experts > 0:
            out["ep_wire_bytes"] = int(self.ep_wire_bytes)
            out["num_experts"] = int(self.num_experts)
        return out


@dataclasses.dataclass(frozen=True)
class LayoutPlan:
    """The ranked answer: ``scores[0]`` is the planner's choice."""

    n_devices: int
    scores: Tuple[LayoutScore, ...]
    objective: Dict[str, Any]

    @property
    def best(self) -> LayoutScore:
        return self.scores[0]

    def rank_of(self, dp: int, tp: int, pp: int) -> int:
        """Index of the ``(dp, tp, pp)`` tiling in the ranking (the
        bench regression gate's lookup)."""
        for i, s in enumerate(self.scores):
            if (s.dp, s.tp, s.pp) == (dp, tp, pp):
                return i
        raise KeyError(f"no scored layout ({dp}, {tp}, {pp})")

    def detail(self) -> Dict[str, Any]:
        """JSON-able plan for bench records / ``snapshot_detail()``."""
        best = self.best
        return {
            "n_devices": self.n_devices,
            "best": {"dp": best.dp, "tp": best.tp, "pp": best.pp},
            "objective": dict(self.objective),
            "scores": [s.detail() for s in self.scores],
        }


def measured_link_gbps() -> Optional[float]:
    """Link rate calibrated from the live comms ledger, or ``None``.

    Reads the armed :class:`~apex_tpu_torch.telemetry.comms.CommsTracer`'s
    bandwidth ledger and converts the best observed ``measured_mbps``
    (MB/s of analytic wire bytes over wall time) to Gbit/s. The MAX
    across ops is used deliberately: traced transfers overlap compute,
    so every row is a LOWER bound on the link — the fastest row is the
    least-masked observation. This is what lets :func:`plan_layout`'s
    alpha-beta constants come from the machine instead of a datasheet
    roofline (``link_source: "measured"``)."""
    from apex_tpu_torch.telemetry import comms as _comms

    tracer = _comms.get_tracer()
    if tracer is None:
        return None
    best = None
    for row in tracer.ledger():
        mbps = row.get("measured_mbps")
        if mbps and (best is None or mbps > best):
            best = float(mbps)
    if best is None:
        return None
    return best * 8.0 / 1000.0           # MB/s -> Gbit/s


def _microbatch_candidates(base_m: int, global_batch: int,
                           pp: int) -> List[int]:
    """Microbatch counts one tiling's schedule search tries: the
    caller's ``microbatches`` and its 2x/4x deepenings, kept to exact
    divisors of the global batch and at least ``pp`` (fewer
    microbatches than stages leaves stages idle every tick)."""
    cands = []
    for mm in (base_m, 2 * base_m, 4 * base_m):
        if mm < 1 or mm > global_batch or global_batch % mm:
            continue
        if mm < min(pp, global_batch):
            continue
        if mm not in cands:
            cands.append(mm)
    return cands or [min(base_m, global_batch)]


def plan_layout(n_devices: int, *, hidden_size: int, num_layers: int,
                vocab_size: int, ffn_hidden_size: Optional[int] = None,
                global_batch: int, seq_len: int,
                num_heads: Optional[int] = None,
                mem_budget_bytes: Optional[int] = None,
                link_gbps: Optional[float] = None,
                peak_tflops: Optional[float] = None,
                microbatches: int = 4,
                num_experts: int = 0, moe_top_k: int = 2,
                moe_layer_freq: int = 1,
                capacity_factor: float = 1.25) -> LayoutPlan:
    """Score every legal ``(dp, tp, pp)`` tiling of ``n_devices`` for
    one GPT-shaped training config and return them ranked.

    The cost model, per layout:

    - **compute** — dense-transformer step FLOPs
      (``6 * tokens * params`` plus the quadratic attention term)
      spread over all chips at ``peak * ASSUMED_MFU``, scaled by the
      chosen schedule's bubble;
    - **schedule search** — each pp>1 tiling tries every
      :data:`PLANNED_SCHEDULES` x microbatch-count candidate
      (``microbatches`` and its 2x/4x deepenings that divide the
      batch) and keeps the best; the bubble terms are the analytic
      :func:`apex_tpu_torch.mesh.pipeline.bubble_fraction` fractions —
      GPipe/1F1B ``(pp-1)/(m+pp-1)``, interleaved
      ``(pp-1)/(V*m+pp-1)`` — with 1F1B additionally capping the
      in-flight activation residency at ``pp`` microbatches (the
      memory schedule) and interleaved paying V x the boundary
      traffic;
    - **comm** — ``telemetry.comms.wire_bytes`` prices the gradient
      all-reduce across ``dp``, per-layer activation reductions across
      ``tp``, and microbatch boundary-slab p2p (``op="ppermute"``)
      across ``pp``; each plane pays bytes over the link rate plus
      :data:`COLLECTIVE_LATENCY_MS` per collective (the alpha-beta
      model), and the dp all-reduce is :data:`DP_OVERLAP`-hidden
      behind the backward pass. With no caller ``link_gbps`` the beta
      constant is CALIBRATED from the live comms ledger when one is
      armed (:func:`measured_link_gbps`, ``link_source:
      "measured"``), falling back to the datasheet constant;
    - **memory** — fp32 weights + master + Adam slots
      (``16 * params / (tp * pp)``) plus an activation slab with the
      sequence-parallel half split across ``tp``; a layout over
      ``mem_budget_bytes`` is infeasible (``reason: "memory"``), as is
      one whose ``tp`` does not divide the head count, ``pp`` over the
      layer count, or ``dp`` over the global batch;
    - **expert parallelism** (``num_experts > 0``, docs/moe.md) —
      every ``moe_layer_freq``-th layer's dense MLP becomes
      ``num_experts`` expert MLPs sharded on the SAME ``model`` axis
      as tp. Weight memory grows by the full expert table, compute by
      only the ``moe_top_k`` active experts per token (the MoE deal),
      and each MoE layer pays dispatch + combine token all-to-alls
      (fwd + bwd, ``op="all_to_all"`` on the PR-12 wire model) whose
      payload scales with ``capacity_factor * top_k`` token copies. A
      ``tp`` that does not divide ``num_experts`` leaves orphan
      experts and is infeasible.
    """
    n = int(n_devices)
    h = int(hidden_size)
    L = int(num_layers)
    v = int(vocab_size)
    ffn = int(ffn_hidden_size) if ffn_hidden_size else 4 * h
    B = int(global_batch)
    S = int(seq_len)
    m = max(int(microbatches), 1)

    peak_source = "table"
    if peak_tflops is None:
        peak_tflops = chip_peak_tflops(device_kind())
        if peak_tflops is None:
            peak_tflops, peak_source = FALLBACK_PEAK_TFLOPS, "fallback"
    else:
        peak_source = "caller"
    link_source = "caller"
    if link_gbps is None:
        link_gbps = measured_link_gbps()
        if link_gbps is not None:
            link_source = "measured"
        else:
            link_gbps, link_source = FALLBACK_LINK_GBPS, "fallback"

    # dense-GPT accounting (same shapes telemetry/cost.py's MFU
    # denominator assumes): per-layer 4h^2 attn + 2*h*ffn MLP, plus
    # the embedding/readout table
    params = v * h + S * h + L * (4 * h * h + 2 * h * ffn + 9 * h)
    E = max(int(num_experts), 0)
    k = max(int(moe_top_k), 1)
    n_moe = (L // max(int(moe_layer_freq), 1)) if E > 0 else 0
    # MoE layers hold E expert MLPs + the gate (memory) but each token
    # only runs top_k of them (flops) — params splits into the table
    # the chips STORE vs the params a token TOUCHES
    params += n_moe * ((E - 1) * 2 * h * ffn + h * E)
    params_active = (v * h + S * h + L * (4 * h * h + 2 * h * ffn + 9 * h)
                     + n_moe * ((k - 1) * 2 * h * ffn + h * E))
    tokens = B * S
    step_flops = 6 * tokens * params_active + 12 * L * B * S * S * h
    # one microbatch's boundary activation slab, and the full
    # per-device activation residency (~8 live (B,S,h) tensors/layer)
    act_total = 8 * B * S * h * L * FP32

    from apex_tpu_torch.mesh.pipeline import bubble_fraction as _bubble
    from apex_tpu_torch.telemetry.comms import wire_bytes as _wire

    scores: List[LayoutScore] = []
    for dp, tp, pp in enumerate_layouts(n):
        base_reason = None
        if num_heads is not None and num_heads % tp:
            base_reason = f"tp={tp} does not divide num_heads={num_heads}"
        elif E > 0 and tp > 1 and E % tp:
            base_reason = f"tp={tp} does not divide num_experts={E}"
        elif pp > L:
            base_reason = f"pp={pp} exceeds num_layers={L}"
        elif dp > B:
            base_reason = f"dp={dp} exceeds global_batch={B}"

        weight_bytes = 16 * params // (tp * pp)
        flops_per_chip = step_flops / n
        base_compute_ms = (flops_per_chip
                           / (peak_tflops * 1e12 * ASSUMED_MFU) * 1e3)

        # the schedule x microbatch candidates this tiling searches
        if pp == 1:
            cands = [("none", 0, 1)]
        else:
            cands = []
            for mm in _microbatch_candidates(m, B, pp):
                for sched in PLANNED_SCHEDULES:
                    V = (INTERLEAVE_CHUNKS
                         if sched == "interleaved_1f1b" else 1)
                    if V > 1 and (mm % pp or L % (pp * V)):
                        continue     # interleave needs m|pp, L|pp*V
                    cands.append((sched, mm, V))

        best = None
        for sched, mm, V in cands:
            reason = base_reason
            bubble = _bubble(sched, pp, max(mm, 1), V) if pp > 1 else 0.0
            # compute: all chips at roofline, schedule-bubble-scaled —
            # busy/(busy+bubble) utilization is 1/(1-bubble) slowdown
            compute_ms = base_compute_ms / (1.0 - bubble)

            # memory: weights(4) + master(4) + adam slots(8) live on
            # every dp replica; activations split across dp*pp with
            # the sequence-parallel half further split across tp.
            # GPipe keeps ALL mm microbatches in flight; 1F1B (and
            # interleaved) cap the residency at pp of them — the
            # schedule IS a memory knob.
            act_bytes = act_total * (0.5 + 0.5 / tp) / (dp * pp)
            if sched in ("1f1b", "interleaved_1f1b") and mm > pp:
                act_bytes *= pp / mm
            mem = weight_bytes + int(act_bytes)
            if reason is None and mem_budget_bytes is not None \
                    and mem > mem_budget_bytes:
                reason = (f"memory {mem} exceeds per-chip budget "
                          f"{int(mem_budget_bytes)}")

            # one microbatch's boundary slab for THIS mm
            act_slab = (B // mm if 0 < mm <= B else B) * S * h * FP32

            # wire: the three planes, each priced with the ledger
            # model, plus alpha (launch latency) per collective; the
            # dp gradient all-reduce additionally overlaps the
            # backward pass
            wire = 0
            comm_ms = 0.0
            if dp > 1:             # ring grad all-reduce ~= reduce-
                grad_bytes = FP32 * params // (tp * pp)  # scatter + AG
                dp_wire = 2 * _wire("all_gather", grad_bytes // dp, dp)
                wire += dp_wire
                comm_ms += (DP_OVERLAP * dp_wire / (link_gbps * 1e9)
                            * 1e3 + 2 * COLLECTIVE_LATENCY_MS)
            if tp > 1:             # 4 activation reductions/layer fwd
                per = _wire("all_gather", act_slab // dp, tp) // tp
                n_ops = 8 * (L // pp)                    # + 4 bwd
                tp_wire = n_ops * per
                wire += tp_wire
                comm_ms += (tp_wire / (link_gbps * 1e9) * 1e3
                            + n_ops * COLLECTIVE_LATENCY_MS)
            if pp > 1:             # boundary slab rotations, fwd + bwd
                n_ops = 2 * mm * V   # each chunk crossing pays a hop
                pp_wire = n_ops * _wire("ppermute", act_slab // dp, pp)
                wire += pp_wire
                comm_ms += (pp_wire / (link_gbps * 1e9) * 1e3
                            + n_ops * COLLECTIVE_LATENCY_MS)
            ep_wire = 0
            if E > 0 and tp > 1:   # MoE dispatch/combine all-to-alls:
                # 2 per layer fwd + 2 bwd; payload = the shard's token
                # copies (capacity_factor * top_k duplication) x hidden
                n_ops = 4 * max(n_moe // pp, 1)
                payload = int(capacity_factor * k
                              * (B * S // max(dp, 1)) * h) * FP32
                ep_wire = n_ops * _wire("all_to_all", payload, tp)
                wire += ep_wire
                comm_ms += (ep_wire / (link_gbps * 1e9) * 1e3
                            + n_ops * COLLECTIVE_LATENCY_MS)

            cand = LayoutScore(
                dp=dp, tp=tp, pp=pp, compute_ms=compute_ms,
                comm_ms=comm_ms, wire_bytes=int(wire),
                mem_bytes_per_device=int(mem),
                feasible=reason is None, reason=reason,
                schedule=sched, microbatches=mm,
                bubble_fraction=float(bubble),
                ep_wire_bytes=int(ep_wire), num_experts=E)
            if best is None or (not cand.feasible, cand.total_ms,
                                cand.mem_bytes_per_device) < \
                    (not best.feasible, best.total_ms,
                     best.mem_bytes_per_device):
                best = cand
        scores.append(best)

    scores.sort(key=lambda s: (not s.feasible, s.total_ms, s.pp, s.tp,
                               s.mem_bytes_per_device))
    objective = {
        "peak_tflops": float(peak_tflops), "peak_source": peak_source,
        "link_gbps": float(link_gbps), "link_source": link_source,
        "assumed_mfu": ASSUMED_MFU, "microbatches": m,
        "params": int(params), "step_flops": int(step_flops),
        "mem_budget_bytes": (int(mem_budget_bytes)
                             if mem_budget_bytes is not None else None),
        "model": {"hidden_size": h, "num_layers": L, "vocab_size": v,
                  "ffn_hidden_size": ffn, "global_batch": B,
                  "seq_len": S, "num_heads": num_heads},
    }
    if E > 0:
        objective["moe"] = {
            "num_experts": E, "top_k": k,
            "moe_layer_freq": int(moe_layer_freq),
            "capacity_factor": float(capacity_factor),
            "moe_layers": n_moe, "params_active": int(params_active),
        }
    return LayoutPlan(n_devices=n, scores=tuple(scores),
                      objective=objective)


def plan_for_config(cfg, n_devices: int, *, global_batch: int,
                    **kwargs) -> LayoutPlan:
    """:func:`plan_layout` from a ``GPTConfig``-shaped object (reads
    ``hidden_size`` / ``num_layers`` / ``vocab_size`` /
    ``ffn_hidden_size`` / ``num_heads``, plus the MoE knobs when the
    config carries them)."""
    return plan_layout(
        n_devices,
        hidden_size=cfg.hidden_size,
        num_layers=cfg.num_layers,
        vocab_size=cfg.vocab_size,
        ffn_hidden_size=getattr(cfg, "ffn_hidden_size", None),
        global_batch=global_batch,
        seq_len=kwargs.pop("seq_len", None)
        or getattr(cfg, "max_seq_len", 512),
        num_heads=(getattr(cfg, "num_heads", None)
                   or getattr(cfg, "num_attention_heads", None)),
        num_experts=kwargs.pop("num_experts", None)
        or getattr(cfg, "num_experts", 0) or 0,
        moe_top_k=kwargs.pop("moe_top_k", None)
        or getattr(cfg, "moe_top_k", 2),
        moe_layer_freq=kwargs.pop("moe_layer_freq", None)
        or getattr(cfg, "moe_layer_freq", 1),
        capacity_factor=kwargs.pop("capacity_factor", None)
        or getattr(cfg, "moe_capacity_factor", 1.25),
        **kwargs)


def publish_plan(plan: LayoutPlan, *, registry=None) -> Dict[str, Any]:
    """Land the chosen plan on the telemetry plane: the
    ``layout_plan`` info blob ``snapshot_detail()`` folds in, plus
    ``layout_plan_axis{axis=}`` gauges and the predicted step time —
    so a dashboard shows WHAT layout the planner chose next to the
    ``sharding_devices{fn=}`` gauges showing what the compiler
    actually did. Returns the published detail dict."""
    from apex_tpu_torch.telemetry import metrics as _metrics

    reg = registry if registry is not None else _metrics.registry()
    detail = plan.detail()
    best = plan.best
    axis_g = reg.gauge("layout_plan_axis",
                       "planner-chosen parallel degree by axis")
    axis_g.set(best.dp, axis="dp")
    axis_g.set(best.tp, axis="tp")
    axis_g.set(best.pp, axis="pp")
    reg.gauge("layout_plan_total_ms",
              "planner-predicted step ms of the chosen layout"
              ).set(best.total_ms)
    if best.pp > 1:
        reg.gauge("layout_plan_microbatches",
                  "planner-chosen pipeline microbatch count"
                  ).set(best.microbatches, schedule=best.schedule)
        reg.gauge("layout_plan_bubble_fraction",
                  "planner-predicted bubble of the chosen schedule"
                  ).set(best.bubble_fraction, schedule=best.schedule)
    reg.set_info("layout_plan", detail)
    return detail


__all__ = [
    "ASSUMED_MFU",
    "chip_peak_tflops",
    "device_kind",
    "FALLBACK_LINK_GBPS",
    "FALLBACK_PEAK_TFLOPS",
    "INTERLEAVE_CHUNKS",
    "LayoutPlan",
    "LayoutScore",
    "PLANNED_SCHEDULES",
    "enumerate_layouts",
    "measured_link_gbps",
    "plan_for_config",
    "plan_layout",
    "publish_plan",
]
