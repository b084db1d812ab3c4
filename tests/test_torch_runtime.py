"""The port's PrefetchLoader against the reference's, on the CPU.

Each case runs the same source batches and the same fault plan
(``io:device_put`` clauses, each package its own injector) through both
loaders and holds equal, exactly: the batches delivered, in order; the
``degraded`` flag and ``worker_deaths``; the deltas of the
``prefetch_batches``, ``prefetch_device_put_retries`` and
``prefetch_worker_deaths`` counters; the batches ``transform`` saw; the
error a source raises. Mirrors ``tests/test_runtime.py`` and
``tests/test_resilience.py``'s ``TestPrefetchTransferFaults``.
"""

import threading
import time

import numpy as np
import pytest
import torch

from apex_tpu.resilience import faults as ref_faults
from apex_tpu.runtime import PrefetchLoader as RefLoader
from apex_tpu.telemetry import metrics as ref_metrics

from apex_tpu_torch.resilience import faults
from apex_tpu_torch.runtime import PrefetchLoader
from apex_tpu_torch.telemetry import metrics

COUNTERS = ("prefetch_batches", "prefetch_device_put_retries",
            "prefetch_worker_deaths")


def _batches(n):
    return [{"x": np.full((3,), i, np.float32),
             "y": np.arange(i, i + 2, dtype=np.int32)} for i in range(n)]


def _run(loader_cls, faults_mod, metrics_mod, n, plan, transform, **kw):
    reg = metrics_mod.registry()
    before = {c: reg.counter(c).value() for c in COUNTERS}
    seen = []

    def tf(b):
        seen.append(int(b["x"][0]))
        return {k: v * 2 for k, v in b.items()}

    extra = {"device": "cpu"} if loader_cls is PrefetchLoader else {}
    with faults_mod.inject(**plan):
        loader = loader_cls(iter(_batches(n)), depth=2,
                            retry_base_delay=0.001,
                            transform=tf if transform else None,
                            **extra, **kw)
        out = [{k: np.asarray(v) for k, v in b.items()} for b in loader]
    return {"out": out, "degraded": loader.degraded,
            "deaths": loader.worker_deaths, "seen": sorted(seen),
            "counters": {c: reg.counter(c).value() - before[c]
                         for c in COUNTERS}}


@pytest.mark.parametrize("plan,kw,transform", [
    ({}, {}, False),
    ({}, {}, True),
    ({"io_errors": {"device_put": frozenset({0, 2})}}, {}, False),
    ({"io_errors": {"device_put": frozenset({0, 1, 2, 3})}},
     {"transfer_retries": 1, "max_worker_restarts": 1}, False),
    ({"io_errors": {"device_put": frozenset({0, 1})}},
     {"transfer_retries": 0, "max_worker_restarts": 2}, True),
], ids=["plain", "transform", "retried", "degraded", "restarts"])
def test_loader_matches_reference(plan, kw, transform):
    n = 5
    got = _run(PrefetchLoader, faults, metrics, n, plan, transform, **kw)
    want = _run(RefLoader, ref_faults, ref_metrics, n, plan, transform, **kw)
    assert len(got["out"]) == len(want["out"]) == n
    for g, w in zip(got["out"], want["out"]):
        for k in w:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])
    for key in ("degraded", "deaths", "seen", "counters"):
        assert got[key] == want[key], key


def test_source_errors_are_never_retried():
    def gen():
        yield np.zeros((1,), np.float32)
        raise ValueError("boom")

    loader = PrefetchLoader(gen(), depth=2, transfer_retries=5,
                            device="cpu")
    with pytest.raises(ValueError, match="boom"):
        list(loader)
    assert loader.worker_deaths == 0
    with pytest.raises(RuntimeError, match="single-pass"):
        iter(loader)


def test_abandoned_consumer_releases_the_worker():
    def gen():
        while True:
            yield torch.zeros(1)

    before = threading.active_count()
    it = iter(PrefetchLoader(gen(), depth=2, device="cpu"))
    next(it)
    it.close()
    time.sleep(0.5)
    assert threading.active_count() <= before + 1


def test_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default is the card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PrefetchLoader(iter([]))
