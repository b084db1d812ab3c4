"""The port's card probes: the kprobe ladder (``apex_tpu_torch/tools/
kprobe.py``, counterpart of ``tools/tpu_kprobe.py``) and the launch probe
(``apex_tpu_torch/tools/launch_probe.py``, counterpart of
``tools/mosaic_probe.py``).

The reference scripts print timings, not values, so their formulas are
copied here, with their lines, as numpy fp32 evaluations, and each
probe's plain version is held bitwise to them: the ladder's rungs
(``tools/tpu_kprobe.py`` :90-91 copy, :103-106 multi7, :121-126
``adam_body``, :147-160 the found flag) and the launch probe's cases
(``tools/mosaic_probe.py`` :20-21 ``x * 2``, :92-99 the subtile gather,
:114-117 its expected output). The CUDA kernels are held to the plain
versions on the card (``chip_smoke.py``, ``tests/test_torch_kernels_
cuda.py``). Tolerance: bitwise throughout.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import apex_tpu_torch
from apex_tpu_torch.tools import kprobe, launch_probe

F = np.float32


def _bufs(n=4099, seed=0):
    rng = np.random.RandomState(seed)
    p = rng.randn(n).astype(F)
    m = rng.randn(n).astype(F)
    v = rng.rand(n).astype(F)
    g = (rng.randn(n) * 1e-3).astype(F)
    return p, m, v, g


def _numpy_rung(rung, p, m, v, g):
    if rung == "copy1":                                   # :90-91
        return (p * F(1.0000001),)
    if rung == "multi7":                                  # :103-106
        return (p * F(1.0000001), m * F(1.0000001), v + g)
    m2 = F(0.9) * m + F(0.1) * g                          # :121-126
    v2 = F(0.999) * v + F(0.001) * g * g
    up = m2 / (np.sqrt(v2) + F(1e-8)) + F(0.01) * p
    return (p - F(1e-3) * up, m2, v2)


def _bits(a):
    return np.asarray(a, F).view(np.uint32)


@pytest.mark.parametrize("rung", ["copy1", "multi7", "adam_math",
                                  "adam_found", "adam_alias"])
def test_plain_rungs_are_the_reference_formulas(rung):
    bufs = _bufs()
    got, found = kprobe.plain_rung(rung, *(torch.from_numpy(a)
                                           for a in bufs))
    want = _numpy_rung(rung, *bufs)
    assert len(got) == len(want)
    for a, w in zip(got, want):
        np.testing.assert_array_equal(_bits(a.numpy()), _bits(w))
    if rung == "adam_found":
        assert float(found) == 0.0
    else:
        assert found is None


def test_found_flag_is_any_nonfinite_gradient():        # :147-160
    p, m, v, g = _bufs()
    for bad, want in ((None, 0.0), (np.inf, 1.0), (-np.inf, 1.0),
                      (np.nan, 1.0)):
        gg = g.copy()
        if bad is not None:
            gg[1234] = bad
        _, found = kprobe.plain_rung("adam_found", *(torch.from_numpy(a)
                                                     for a in (p, m, v, gg)))
        assert float(found) == want


def test_ladder_records_have_the_reference_shape():
    assert kprobe.KERNEL_RUNGS == ("copy1", "multi7", "adam_math",
                                   "adam_found", "adam_alias")
    assert kprobe.DEFAULT_N == 64_000_000                # :47
    assert kprobe.STREAMS["copy1"] == 2
    assert all(kprobe.STREAMS[r] == 7 for r in kprobe.STREAMS
               if r != "copy1")
    assert kprobe.kernel_name("adam_alias") == "kprobe_adam_alias"
    with pytest.raises(RuntimeError, match="CUDA device"):
        kprobe.ladder(64, device="cpu", timer=lambda fn: 1.0)


def test_inputs_follow_the_reference():
    p, m, v, g = kprobe.inputs(1000, "cpu", seed=0)
    assert float(m.abs().max()) == float(v.abs().max()) == 0.0
    assert 0.5 < float(p.std()) < 1.5
    assert 0.5e-3 < float(g.std()) < 1.5e-3


@pytest.mark.parametrize("case", launch_probe.CASES, ids=lambda c: c.name)
def test_plain_tiles_are_x_times_two_where_blocks_reach(case):
    """:20-21: ``o = x * 2`` over each block the index map places; every
    one of the fourteen cases covers its array."""
    x = np.random.RandomState(0).rand(*case.arr_shape).astype(F)
    got = launch_probe.plain_tiles(case, torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(x * F(2.0)))
    org = launch_probe.block_origins(case)
    assert org.shape == (max(1, int(np.prod(case.grid))), 3)


def test_block_origins_follow_the_index_maps():
    banded = {c.name: c for c in launch_probe.CASES}["3d banded index map"]
    org = launch_probe.block_origins(banded)
    # (i, min(j, 1), 0) times the (1, 128, 128) block
    assert org.tolist()[:4] == [[0, 0, 0], [0, 128, 0], [1, 0, 0],
                                [1, 128, 0]]
    two_d = launch_probe.CASES[0]
    assert launch_probe.block_origins(two_d)[3].tolist() == [0, 1, 128]


def test_plain_gather_is_the_reference_kernel():          # :92-99, :114-117
    s = launch_probe.GATHER_SIZES
    ids, vals, x = launch_probe.gather_inputs("cpu")
    assert s == dict(tile_rows=512, lanes=128, sub=32, n_tiles=2)
    got = launch_probe.plain_gather(ids, vals, x, s["tile_rows"], s["sub"])
    want = np.repeat(vals.numpy()[ids.numpy()], s["tile_rows"] // s["sub"]
                     )[:, None] * np.ones((1, s["lanes"]), F)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_limit_cases_cover_each_limit_and_the_first_shape_past_it():
    cases = launch_probe.limit_cases()
    by = {c.name: c for c in cases}
    assert by["threads 1024"].valid and not by["threads 2048"].valid
    assert by["dynamic smem 227 KB"].smem == launch_probe.MAX_DYNAMIC_SMEM
    assert by["dynamic smem 227 KB"].valid
    past = [c for c in cases if c.smem > launch_probe.MAX_DYNAMIC_SMEM]
    assert len(past) == 1 and not past[0].valid
    clusters = {c.cluster: c.valid for c in cases if c.name.startswith(
        "cluster")}
    assert clusters == {1: True, 2: True, 4: True, 8: True, 16: True,
                        32: False}
    for c in cases:
        assert c.smem == 0 or c.smem >= c.threads * 4


def test_probes_raise_without_a_card():
    with pytest.raises(RuntimeError, match="CUDA device"):
        launch_probe.probe_all(device="cpu")


def test_probe_modules_import_no_jax():
    code = ("import sys, apex_tpu_torch.tools.kprobe, "
            "apex_tpu_torch.tools.launch_probe; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'apex_tpu')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    root = Path(apex_tpu_torch.__file__).resolve().parent.parent
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
