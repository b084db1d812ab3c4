"""``apex_tpu_torch.amp.lists``, the cast decorators and the public
surface of ``amp`` and ``fp16_utils`` against the reference's.

The tables must be equal, name for name and in order, and the banned
message word for word. ``register_defaults`` and the four
``register_*`` calls are applied to a module object holding functions
of the tables' names, on both sides, and the outputs' dtypes compared;
a second ``register_defaults`` wraps nothing again. Values: fp32
outputs within 1e-6 of the largest |value| (matmuls and softmax sum in
other orders), 16-bit outputs within two ulps of their dtype at the
largest |value|.
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from apex_tpu import amp as ref_amp
from apex_tpu import fp16_utils as ref_fp16
from apex_tpu.amp import functional as ref_fn
from apex_tpu.amp import lists as ref_lists

from apex_tpu_torch import amp, fp16_utils
from apex_tpu_torch.amp import functional as fn
from apex_tpu_torch.amp import lists

TABLES = ("COMPUTE_FUNCS", "FP16_FUNCS", "BFLOAT16_FUNCS", "FP32_FUNCS",
          "PROMOTE_FUNCS", "SEQUENCE_CASTS", "MATCH_INPUT_FUNCS",
          "BANNED_FUNCS", "BANNED_MESSAGE")
TORCH_OF = {"float32": torch.float32, "float16": torch.float16,
            "bfloat16": torch.bfloat16}
RTOL = {torch.float32: 1e-6, torch.float16: 2.0 ** -9,
        torch.bfloat16: 2.0 ** -6}


@pytest.mark.parametrize("table", TABLES)
def test_tables_equal_the_reference(table):
    assert getattr(lists, table) == getattr(ref_lists, table)


def test_public_surface():
    assert list(lists.__all__) == list(ref_lists.__all__)
    assert set(ref_amp.__all__) <= set(amp.__all__)
    for name in ref_amp.__all__:
        assert hasattr(amp, name), name
    for name in ref_fp16.__all__:
        assert hasattr(fp16_utils, name), name
    assert set(fp16_utils.__all__) == set(ref_fp16.__all__)


def _namespaces():
    """The same functions of the tables' names on both sides (and one
    outside them)."""
    ref = types.SimpleNamespace(
        linear=lambda x, w: x @ w.T, dense=lambda x, w: x @ w.T,
        softmax=lambda x: jax.nn.softmax(x, axis=-1),
        add=lambda a, b: a + b, cat=lambda xs: jnp.concatenate(xs),
        relu=lambda x: jnp.maximum(x, 0), unrelated="leave me")
    port = types.SimpleNamespace(
        linear=lambda x, w: x @ w.T, dense=lambda x, w: x @ w.T,
        softmax=lambda x: torch.softmax(x, dim=-1),
        add=lambda a, b: a + b, cat=lambda xs: torch.cat(xs),
        relu=torch.relu, unrelated="leave me")
    return ref, port


def _inputs():
    r = np.random.RandomState(0)
    x = r.randn(4, 8).astype(np.float32)
    w = r.randn(6, 8).astype(np.float32)
    h = r.randn(8).astype(np.float16)
    s = np.array(0.75, np.float32)
    return x, w, h, s


def _same(want, got):
    assert got.dtype == TORCH_OF[str(want.dtype)], (got.dtype, want.dtype)
    w = np.asarray(want.astype(jnp.float32))
    err = np.abs(got.float().numpy() - w).max()
    assert err <= RTOL[got.dtype] * np.abs(w).max(), err


def _calls(ns, conv):
    x, w, h, s = (conv(a) for a in _inputs())
    return {"linear": ns.linear(x, w), "dense": ns.dense(x, w),
            "softmax": ns.softmax(h), "add": ns.add(h, s),
            "cat": ns.cat([h, x[0]]), "relu": ns.relu(h)}


@pytest.mark.parametrize("compute", ["float16", "bfloat16"])
def test_register_defaults_on_a_module(compute):
    ref, port = _namespaces()
    assert lists.register_defaults(port, compute) == \
        ref_lists.register_defaults(ref, compute) == 5
    want = _calls(ref, jnp.asarray)
    got = _calls(port, lambda a: torch.from_numpy(a.copy()))
    for k in want:
        _same(want[k], got[k])
    assert got["linear"].dtype == TORCH_OF[compute]
    assert got["add"].dtype == torch.float32       # the fp32 0-d widens
    assert port.unrelated == "leave me"
    # a second call wraps nothing again; torch.dtype names the dtype too
    wrapped = (port.linear, port.dense, port.softmax)
    assert lists.register_defaults(port, TORCH_OF[compute]) == 0
    assert (port.linear, port.dense, port.softmax) == wrapped
    _same(want["linear"], port.linear(*(torch.from_numpy(a.copy())
                                        for a in _inputs()[:2])))


@pytest.mark.parametrize("register", ["register_half_function",
                                      "register_bfloat16_function",
                                      "register_float_function",
                                      "register_promote_function"])
def test_register_functions(register):
    ref, port = _namespaces()
    for name in ("linear", "add"):
        getattr(ref_fn, register)(ref, name)
        getattr(fn, register)(port, name)
    x, w, h, s = _inputs()
    t = lambda a: torch.from_numpy(a.copy())  # noqa: E731
    _same(ref.linear(jnp.asarray(x), jnp.asarray(w)), port.linear(t(x), t(w)))
    _same(ref.add(jnp.asarray(h), jnp.asarray(s)), port.add(t(h), t(s)))


def test_compute_cast_and_nested_arguments():
    def ref_f(d):
        return {"y": d["a"] @ d["b"][0].T, "n": d["n"] + 1}

    def port_f(d):
        return {"y": d["a"] @ d["b"][0].T, "n": d["n"] + 1}

    x, w, _, _ = _inputs()
    n = np.arange(3, dtype=np.int32)
    for dt in ("float16", "bfloat16"):
        want = ref_fn.compute_cast(ref_f, getattr(jnp, dt))(
            {"a": jnp.asarray(x), "b": (jnp.asarray(w),), "n": jnp.asarray(n)})
        got = fn.compute_cast(port_f, TORCH_OF[dt])(
            {"a": torch.from_numpy(x), "b": (torch.from_numpy(w),),
             "n": torch.from_numpy(n)})
        _same(want["y"], got["y"])
        assert got["n"].dtype == torch.int32 and str(want["n"].dtype) == \
            "int32"
    # Python scalars and integer tensors pass through every decorator
    f = fn.half_function(lambda a, k, i: (a, k, i))
    a, k, i = f(torch.ones(2), 2.5, torch.ones(2, dtype=torch.int64))
    assert a.dtype == torch.float16 and k == 2.5 and i.dtype == torch.int64


def test_promote_function_widens_bf16_with_fp16():
    h = np.ones(3, np.float16)
    b16 = jnp.ones(3, jnp.bfloat16)
    want = ref_fn.promote_function(lambda a, b: a + b)(jnp.asarray(h), b16)
    got = fn.promote_function(lambda a, b: a + b)(
        torch.from_numpy(h), torch.ones(3, dtype=torch.bfloat16))
    _same(want, got)
    assert got.dtype == torch.float32
