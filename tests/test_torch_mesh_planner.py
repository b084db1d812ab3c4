"""The port's layout planner against the reference's
(``apex_tpu/mesh/planner.py``), case for case.

Mirrors every case of ``tests/test_mesh_planner.py`` with an explicit
peak rate and link rate (``peak_tflops``, ``link_gbps``; the reference's
table reads a TPU's name, the port's a GPU's), and holds each plan to
the reference's on the same arguments: the ranked layouts equal (dp, tp,
pp, schedule, microbatches, feasibility, reason, wire and memory bytes)
and every time and bubble within 1e-12 relative. Host-only: no world.
"""

import json

import numpy as np
import pytest

from apex_tpu.mesh import planner as ref_planner

from apex_tpu_torch.mesh import planner

# a peak and a link of no particular card: the planner's arithmetic
PEAK, LINK = 123.0, 45.0


def small_plan(n, module=planner, **kw):
    kw.setdefault("hidden_size", 256)
    kw.setdefault("num_layers", 4)
    kw.setdefault("vocab_size", 1024)
    kw.setdefault("global_batch", 8)
    kw.setdefault("seq_len", 128)
    kw.setdefault("num_heads", 8)
    kw.setdefault("peak_tflops", PEAK)
    kw.setdefault("link_gbps", LINK)
    return module.plan_layout(n, **kw)


def _same_plan(got, want):
    assert got.n_devices == want.n_devices
    assert len(got.scores) == len(want.scores)
    for a, b in zip(got.scores, want.scores):
        for f in ("dp", "tp", "pp", "schedule", "microbatches", "feasible",
                  "reason", "wire_bytes", "mem_bytes_per_device",
                  "ep_wire_bytes", "num_experts"):
            assert getattr(a, f) == getattr(b, f), f
        for f in ("compute_ms", "comm_ms", "bubble_fraction", "total_ms"):
            np.testing.assert_allclose(getattr(a, f), getattr(b, f),
                                       rtol=1e-12, atol=0, err_msg=f)
    assert got.objective == want.objective


# the arguments of every plan the reference's tests make
PLAN_CASES = {
    "n1": (1, {}), "n2": (2, {}), "n4": (4, {}), "n8": (8, {}),
    "budget_20M": (8, {"mem_budget_bytes": 20_000_000}),
    "heads4": (8, {"num_heads": 4}),
    "layers4": (8, {"num_layers": 4}),
    "batch4": (8, {"global_batch": 4}),
    "moe4": (8, {"num_experts": 4, "moe_top_k": 2}),
    "moe3": (8, {"num_experts": 3, "moe_top_k": 1}),
    "moe8": (8, {"num_experts": 8, "moe_top_k": 2}),
    "microbatches2": (8, {"microbatches": 2}),
}


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_plan_matches_reference(case):
    n, kw = PLAN_CASES[case]
    _same_plan(small_plan(n, **kw), small_plan(n, ref_planner, **kw))


def test_budgeted_plan_matches_reference():
    unconstrained = small_plan(8)
    dp8 = next(s for s in unconstrained.scores
               if (s.dp, s.tp, s.pp) == (8, 1, 1))
    budget = dp8.mem_bytes_per_device // 2
    _same_plan(small_plan(8, mem_budget_bytes=budget),
               small_plan(8, ref_planner, mem_budget_bytes=budget))


class TestEnumerate:
    @pytest.mark.parametrize("n", [1, 2, 4, 6, 8, 12, 16])
    def test_every_layout_tiles_device_count(self, n):
        layouts = planner.enumerate_layouts(n)
        assert layouts == ref_planner.enumerate_layouts(n)
        for dp, tp, pp in layouts:
            assert dp * tp * pp == n
        assert len(set(layouts)) == len(layouts)

    def test_counts(self):
        assert len(planner.enumerate_layouts(8)) == 10
        assert planner.enumerate_layouts(1) == [(1, 1, 1)]

    def test_invalid(self):
        with pytest.raises(ValueError):
            planner.enumerate_layouts(0)


class TestPlanProperties:
    @pytest.mark.parametrize("n", [1, 2, 4, 8])
    def test_plan_scores_every_tiling_exactly(self, n):
        plan = small_plan(n)
        assert plan.n_devices == n
        assert len(plan.scores) == len(planner.enumerate_layouts(n))
        for s in plan.scores:
            assert s.dp * s.tp * s.pp == n
            assert s.total_ms == pytest.approx(s.compute_ms + s.comm_ms)
            assert s.mem_bytes_per_device > 0

    def test_feasible_rank_above_infeasible(self):
        plan = small_plan(8, mem_budget_bytes=20_000_000)
        feas = [s.feasible for s in plan.scores]
        assert feas == sorted(feas, reverse=True)
        assert plan.best.feasible

    def test_detail_is_json_able(self):
        d = small_plan(8).detail()
        json.dumps(d)
        assert d["best"]["dp"] * d["best"]["tp"] * d["best"]["pp"] == 8
        assert len(d["scores"]) == 10
        assert d["objective"]["peak_source"] == "caller"
        assert d["objective"]["link_source"] == "caller"
        assert d == small_plan(8, ref_planner).detail()


class TestGoldenOrderings:
    def test_degenerates_to_pure_dp_on_one_device(self):
        plan = small_plan(1)
        assert (plan.best.dp, plan.best.tp, plan.best.pp) == (1, 1, 1)
        assert plan.best.feasible

    def test_dp_heavy_wins_when_memory_fits(self):
        plan = small_plan(8)
        assert plan.best.tp == 1
        assert plan.best.dp > 1

    def test_tp_heavy_above_dp_heavy_when_memory_over_budget(self):
        unconstrained = small_plan(8)
        dp_heavy = next(s for s in unconstrained.scores
                        if (s.dp, s.tp, s.pp) == (8, 1, 1))
        plan = small_plan(8,
                          mem_budget_bytes=dp_heavy.mem_bytes_per_device // 2)
        assert plan.rank_of(1, 8, 1) < plan.rank_of(8, 1, 1)
        dp8 = plan.scores[plan.rank_of(8, 1, 1)]
        assert not dp8.feasible and "budget" in dp8.reason
        assert plan.scores[plan.rank_of(1, 8, 1)].feasible

    def test_tp_must_divide_heads(self):
        bad = [s for s in small_plan(8, num_heads=4).scores if s.tp == 8]
        assert bad and not bad[0].feasible
        assert "num_heads" in bad[0].reason

    def test_pp_bounded_by_layers(self):
        bad = [s for s in small_plan(8, num_layers=4).scores if s.pp == 8]
        assert bad and not bad[0].feasible
        assert "num_layers" in bad[0].reason

    def test_dp_bounded_by_global_batch(self):
        bad = [s for s in small_plan(8, global_batch=4).scores if s.dp == 8]
        assert bad and not bad[0].feasible
        assert "global_batch" in bad[0].reason


class TestPublishPlan:
    def test_publish_lands_in_snapshot_detail(self):
        from apex_tpu_torch import telemetry
        from apex_tpu_torch.telemetry import metrics as tmetrics

        telemetry.reset()
        try:
            detail0 = telemetry.snapshot_detail()
            assert detail0["layout_plan"] is None
            assert "layout_plan_reason" in detail0
            plan = small_plan(8)
            out = planner.publish_plan(plan)
            assert out == plan.detail()
            g = tmetrics.registry().snapshot()["gauges"]
            assert g['layout_plan_axis{axis="dp"}'] == plan.best.dp
            assert g['layout_plan_axis{axis="tp"}'] == plan.best.tp
            detail = telemetry.snapshot_detail()
            assert detail["layout_plan"]["best"] == plan.detail()["best"]
            assert "layout_plan_reason" not in detail
        finally:
            telemetry.reset()

    def test_plan_for_config(self):
        from apex_tpu.models.gpt import GPTConfig as RefConfig

        from apex_tpu_torch.models import GPTConfig

        cfg = GPTConfig(hidden_size=128, num_layers=4, num_heads=8,
                        max_seq_len=64, vocab_size=512)
        plan = planner.plan_for_config(cfg, 8, global_batch=8, seq_len=64,
                                       peak_tflops=PEAK, link_gbps=LINK)
        assert plan.n_devices == 8
        assert plan.objective["model"]["num_heads"] == 8
        ref = ref_planner.plan_for_config(
            RefConfig(hidden_size=128, num_layers=4, num_heads=8,
                      max_seq_len=64, vocab_size=512), 8, global_batch=8,
            seq_len=64, peak_tflops=PEAK, link_gbps=LINK)
        _same_plan(plan, ref)


class TestExpertParallel:
    def test_ep_wire_on_tp_tilings_only(self):
        for s in small_plan(8, num_experts=4, moe_top_k=2).scores:
            if s.tp > 1 and s.feasible:
                assert s.ep_wire_bytes > 0, s
            if s.tp == 1:
                assert s.ep_wire_bytes == 0, s
            assert s.num_experts == 4

    def test_dense_has_no_ep_terms(self):
        plan = small_plan(8)
        assert all(s.ep_wire_bytes == 0 and s.num_experts == 0
                   for s in plan.scores)
        assert "moe" not in plan.objective
        assert "ep_wire_bytes" not in plan.scores[0].detail()

    def test_tp_must_divide_experts(self):
        plan = small_plan(8, num_experts=3, moe_top_k=1)
        bad = [s for s in plan.scores if s.tp == 2]
        assert bad and all(not s.feasible and "num_experts" in s.reason
                           for s in bad)
        assert any(s.feasible for s in plan.scores if s.tp == 1)

    def test_active_params_in_objective(self):
        plan = small_plan(8, num_experts=8, moe_top_k=2)
        moe = plan.objective["moe"]
        assert moe["num_experts"] == 8 and moe["top_k"] == 2
        assert moe["moe_layers"] == 4
        assert moe["params_active"] < plan.objective["params"]
        assert plan.objective["params"] > small_plan(8).objective["params"]

    def test_ep_wire_prices_all_to_all(self):
        from apex_tpu_torch.telemetry import comms

        plan = small_plan(8, num_experts=4, moe_top_k=2)
        tp2 = next(s for s in plan.scores
                   if s.tp == 2 and s.pp == 1 and s.feasible)
        tp4 = next(s for s in plan.scores
                   if s.tp == 4 and s.pp == 1 and s.feasible)
        assert comms.wire_bytes("all_to_all", 999, 4) == 999 * 3 // 4
        assert tp4.ep_wire_bytes > tp2.ep_wire_bytes

    def test_detail_carries_ep_fields(self):
        plan = small_plan(8, num_experts=4, moe_top_k=2)
        row = next(s for s in plan.scores if s.tp > 1 and s.feasible)
        d = row.detail()
        assert d["ep_wire_bytes"] == row.ep_wire_bytes > 0
        assert d["num_experts"] == 4
        json.dumps(plan.detail())


def test_peak_and_link_sources():
    """Without a caller's peak the card's name picks it (the H100 SXM's
    989 TFLOP/s), an unknown kind the reference's fallback; without a
    caller's link, the fallback (no comms ledger armed)."""
    assert planner.chip_peak_tflops("NVIDIA H100 80GB HBM3") == 989.0
    assert planner.chip_peak_tflops("cpu") is None
    assert planner.chip_peak_tflops("NVIDIA A100-SXM4-80GB") is None
    plan = planner.plan_layout(8, hidden_size=256, num_layers=4,
                               vocab_size=1024, global_batch=8, seq_len=128)
    assert plan.objective["peak_source"] == "fallback"
    assert plan.objective["peak_tflops"] == planner.FALLBACK_PEAK_TFLOPS \
        == ref_planner.FALLBACK_PEAK_TFLOPS
    assert plan.objective["link_source"] == "fallback"
    assert plan.objective["link_gbps"] == planner.FALLBACK_LINK_GBPS \
        == ref_planner.FALLBACK_LINK_GBPS
    for name in ("ASSUMED_MFU", "COLLECTIVE_LATENCY_MS", "DP_OVERLAP",
                 "INTERLEAVE_CHUNKS", "PLANNED_SCHEDULES"):
        assert getattr(planner, name) == getattr(ref_planner, name)


def test_measured_link_reads_the_comms_ledger():
    from apex_tpu_torch.telemetry import comms

    comms.disable()
    assert planner.measured_link_gbps() is None
    tracer = comms.enable()
    try:
        tracer.record("all_gather", "gloo", payload_bytes=1_000_000,
                      wire=comms.wire_bytes("all_gather", 1_000_000, 2),
                      t0=0.0, dur_s=0.001)
        mbps = max(r["measured_mbps"] for r in tracer.ledger()
                   if r.get("measured_mbps"))
        assert planner.measured_link_gbps() == pytest.approx(
            mbps * 8.0 / 1000.0)
        plan = small_plan(4, link_gbps=None)
        assert plan.objective["link_source"] == "measured"
    finally:
        comms.disable()
