"""ProcessCollective and KVStoreCollective against LocalCollective.

Three gloo CPU processes (``torch_dist_worker.collective_cases``,
launched once for the module) run the Collective contract's ops on the
same per-replica inputs through ``ProcessCollective``,
``KVStoreCollective``, ``multiproc.process_collective()`` under an armed
comms tracer and an instrumented ``KVStoreCollective``; this process
runs the same ops through ``LocalCollective(3)`` on three threads. Every
result must be equal, array for array (dtype and shape too). Then a
real SIGTERM to one rank: ``PreemptionHandler.should_stop`` over the
process collective stops every rank.
"""

import threading

import numpy as np
import pytest

import torch_dist_worker
from apex_tpu_torch.parallel import multiproc
from apex_tpu_torch.resilience.guard import LocalCollective

WORLD = 3
FLAGGED = 1


def _inputs():
    rng = np.random.RandomState(0)
    return {
        "gather": [rng.randn(WORLD, 4, 3).astype(np.float32),
                   rng.randint(0, 2 ** 32, (WORLD, 5), dtype=np.uint32),
                   rng.randint(-9, 9, (WORLD, 1), dtype=np.int64)],
        "bcast": [rng.randn(WORLD, 7).astype(np.float64),
                  rng.randint(0, 255, (WORLD, 2, 2), dtype=np.uint8)],
        "flagged": FLAGGED}


@pytest.fixture(scope="module")
def world():
    inp = _inputs()
    return inp, multiproc.launch(torch_dist_worker.collective_cases, WORLD,
                                 (inp,), backend="gloo", threads=1,
                                 timeout=300)


@pytest.fixture(scope="module")
def local():
    inp = _inputs()
    handles = LocalCollective(WORLD).handles()
    out = [None] * WORLD

    def run(r):
        out[r] = torch_dist_worker.collective_ops(handles[r], inp, r)

    threads = [threading.Thread(target=run, args=(r,)) for r in range(WORLD)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    return out


def _same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("impl", ["process", "kvstore", "instrumented",
                                  "kv_instrumented"])
def test_collective_matches_local_collective(world, local, impl):
    _, got = world
    for r in range(WORLD):
        _same(got[r][impl], local[r])
        assert got[r][impl]["should_stop"] is True
        assert got[r][impl]["any_one"] is True
        assert got[r][impl]["any_none"] is False


def test_process_collective_is_traced_through_comms(world):
    _, got = world
    for r in range(WORLD):
        assert got[r]["impl"] == "ProcessCollective"
        assert {"all_gather", "broadcast_from",
                "barrier"} <= set(got[r]["traced_ops"])


def test_sigterm_on_one_rank_stops_every_rank(world):
    _, got = world
    for r in range(WORLD):
        assert got[r]["sigterm_local"] is (r == FLAGGED)
        assert got[r]["sigterm_stop"] is True


def test_one_process_gets_the_null_collective():
    from apex_tpu_torch.resilience.guard import NullCollective

    col = multiproc.process_collective()
    assert isinstance(col, NullCollective) and col.n_replicas == 1
