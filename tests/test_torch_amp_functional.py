"""``apex_tpu_torch.amp.F`` against ``apex_tpu.amp.F`` on the CPU.

One parametrised test runs every public function of the reference's
``amp/nn_functional.py`` (a test asserts the case table covers them all)
on the same numpy inputs under four policies, set on both sides with
``policy_scope``: none, O1 (fp16 compute), O4 (bf16 compute) and O1
inside ``disable_casts``. The output dtypes must be equal, and the
values within the tolerance of the function's class:

- ``exact``: bitwise (relu, the promoted arithmetic, the sequence casts:
  one correctly rounded operation an element, or none);
- ``ulp``: one ulp of the output dtype an element; for gelu, silu and
  softplus two ulps of the larger of the output and the input. These are the
  transcendental activations (tanh, sigmoid, silu, softplus, gelu) and
  atan2: XLA's CPU polynomials and PyTorch's vectorised ones are not
  correctly rounded and differ by an ulp on some inputs, as ``cos`` and
  ``log`` do (ROADMAP's traps); gelu, silu and softplus carry the ulp
  of an inner term (``1 + tanh``, the sigmoid, ``log1p``) times the
  input, plus the product's own rounding, which near a cancellation is
  many ulps of the output (an ulp and a fifth of the input read here);
- ``mm``: matmuls and convolutions, 16-bit outputs within two ulps of
  their dtype an element (both accumulate in fp32 and round once, sums
  in other orders), fp32 outputs as ``reduce``;
- ``reduce``: everything that sums (the softmax family, norms, variance,
  cumulative sums, losses), within rtol 1e-6 of the output's largest
  |value|.

Separate cases pin the traps: ``dot``'s N-d contraction, ``var``/``std``
at ddof 0, the fp32 0-d operand promoting fp16, ``cosine_similarity``'s
clamp of the norms' product, ``kl_div`` at zero targets, the convolutions'
padding forms, ``conv_transpose2d`` refusing groups, the tanh ``gelu``,
``batch_norm``'s batch statistics and the banned function.
"""

import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from apex_tpu import amp as ref_amp
from apex_tpu.amp import _amp_state as ref_state
from apex_tpu.amp import nn_functional as RF

from apex_tpu_torch import amp
from apex_tpu_torch.amp import _amp_state
from apex_tpu_torch.amp import nn_functional as PF

MANT = {torch.float32: 23, torch.float16: 10, torch.bfloat16: 7}
MIN_EXP = {torch.float32: -126, torch.float16: -14, torch.bfloat16: -126}
REDUCE_RTOL = 1e-6
MM_ULPS = 2

POLICIES = {
    "none": (None, None, False),
    "O1": (ref_amp.OPT_LEVELS["O1"], amp.OPT_LEVELS["O1"], False),
    "O4": (ref_amp.OPT_LEVELS["O4"], amp.OPT_LEVELS["O4"], False),
    "O1_disabled": (ref_amp.OPT_LEVELS["O1"], amp.OPT_LEVELS["O1"], True),
}


@pytest.fixture(autouse=True)
def _no_policy():
    """Each case starts with no active policy on either side, whatever
    another test file left active (``amp.initialize`` sets one
    process-wide)."""
    with ref_amp.policy_scope(None), amp.policy_scope(None):
        yield


def _rng(name):
    return np.random.RandomState(sum(map(ord, name)))


def _f(rng, *shape, scale=1.0, dtype=np.float32):
    return np.asarray(scale * rng.randn(*shape)).astype(dtype)


def _pos(rng, *shape):
    return (0.5 + rng.rand(*shape)).astype(np.float32)


def _probs(rng, *shape, zeros=False):
    p = rng.rand(*shape).astype(np.float32)
    if zeros:
        p[rng.rand(*shape) < 0.3] = 0.0
    return (p / p.sum(-1, keepdims=True)).astype(np.float32)


def _log_probs(rng, *shape):
    x = rng.randn(*shape)
    return (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)


# name -> (class, builder(rng) -> (args, kwargs)); arrays numpy, ints int32
CASES = {
    "linear": ("mm", lambda r: ((_f(r, 4, 8), _f(r, 6, 8), _f(r, 6)), {})),
    "dense": ("mm", lambda r: ((_f(r, 4, 8), _f(r, 6, 8), _f(r, 6)), {})),
    "matmul": ("mm", lambda r: ((_f(r, 3, 4, 5), _f(r, 3, 5, 2)), {})),
    "bmm": ("mm", lambda r: ((_f(r, 3, 4, 5), _f(r, 3, 5, 2)), {})),
    "dot": ("mm", lambda r: ((_f(r, 2, 3, 4), _f(r, 5, 4, 6)), {})),
    "einsum": ("mm", lambda r: (("bij,bjk->bik", _f(r, 3, 4, 5),
                                 _f(r, 3, 5, 2)), {})),
    "conv1d": ("mm", lambda r: ((_f(r, 2, 3, 10), _f(r, 4, 3, 3), _f(r, 4)),
                                {"padding": 1})),
    "conv2d": ("mm", lambda r: ((_f(r, 2, 3, 8, 8), _f(r, 4, 3, 3, 3),
                                 _f(r, 4)), {"stride": 2, "padding": 1})),
    "conv3d": ("mm", lambda r: ((_f(r, 1, 2, 5, 5, 5), _f(r, 3, 2, 3, 3, 3),
                                 _f(r, 3)), {"padding": 1})),
    "conv_transpose2d": ("mm", lambda r: ((_f(r, 2, 4, 5, 5),
                                           _f(r, 4, 3, 4, 4), _f(r, 3)),
                                          {"stride": 2, "padding": 1})),
    "softmax": ("reduce", lambda r: ((_f(r, 4, 10, scale=3),), {})),
    "log_softmax": ("reduce", lambda r: ((_f(r, 4, 10, scale=3),), {})),
    "softmin": ("reduce", lambda r: ((_f(r, 4, 10, scale=3),), {})),
    "softplus": ("ulp", lambda r: ((_f(r, 4, 10, scale=5),), {})),
    "gelu": ("ulp", lambda r: ((_f(r, 4, 10, scale=3),), {})),
    "logsumexp": ("reduce", lambda r: ((_f(r, 4, 10, scale=3),), {})),
    "layer_norm": ("reduce", lambda r: ((_f(r, 4, 16), 16, _f(r, 16),
                                         _f(r, 16)), {})),
    "rms_norm": ("reduce", lambda r: ((_f(r, 4, 16), _f(r, 16)), {})),
    "group_norm": ("reduce", lambda r: ((_f(r, 2, 8, 4, 4), 4, _f(r, 8),
                                         _f(r, 8)), {})),
    "batch_norm": ("reduce", lambda r: ((_f(r, 4, 6, 3, 3), _f(r, 6),
                                         _pos(r, 6), _f(r, 6), _f(r, 6)),
                                        {})),
    "normalize": ("reduce", lambda r: ((_f(r, 4, 8),), {})),
    "cosine_similarity": ("reduce", lambda r: ((_f(r, 4, 8), _f(r, 4, 8)),
                                               {})),
    "norm": ("reduce", lambda r: ((_f(r, 4, 8),), {})),
    "var": ("reduce", lambda r: ((_f(r, 4, 8),), {})),
    "std": ("reduce", lambda r: ((_f(r, 4, 8),), {})),
    "cumsum": ("reduce", lambda r: ((_f(r, 3, 4),), {})),
    "cumprod": ("reduce", lambda r: ((_pos(r, 3, 4),), {})),
    "mse_loss": ("reduce", lambda r: ((_f(r, 4, 8), _f(r, 4, 8)), {})),
    "l1_loss": ("reduce", lambda r: ((_f(r, 4, 8), _f(r, 4, 8)), {})),
    "smooth_l1_loss": ("reduce", lambda r: ((_f(r, 4, 8), _f(r, 4, 8)), {})),
    "nll_loss": ("reduce", lambda r: ((_log_probs(r, 4, 10),
                                       r.randint(0, 10, 4).astype(np.int32)),
                                      {})),
    "cross_entropy": ("reduce", lambda r: ((_f(r, 4, 10, scale=3),
                                            r.randint(0, 10, 4)
                                            .astype(np.int32)), {})),
    "kl_div": ("reduce", lambda r: ((_log_probs(r, 4, 10),
                                     _probs(r, 4, 10)), {})),
    "poisson_nll_loss": ("reduce", lambda r: ((_f(r, 4, 8), _pos(r, 4, 8)),
                                              {})),
    "binary_cross_entropy_with_logits": (
        "reduce", lambda r: ((_f(r, 4, 8, scale=3),
                              (r.rand(4, 8) < 0.5).astype(np.float32)), {})),
    "add": ("exact", lambda r: ((_f(r, 4, 8, dtype=np.float16),
                                 _f(r, 4, 8)), {})),
    "mul": ("exact", lambda r: ((_f(r, 4, 8), _f(r, 4, 8, dtype=np.float16)),
                                {})),
    "div": ("exact", lambda r: ((_f(r, 4, 8), _pos(r, 4, 8)), {})),
    "atan2": ("ulp", lambda r: ((_f(r, 4, 8), _f(r, 4, 8)), {})),
    "cat": ("exact", lambda r: (([_f(r, 2, 3, dtype=np.float16),
                                  _f(r, 4, 3)],), {})),
    "concatenate": ("exact", lambda r: (([_f(r, 2, 3), _f(r, 1, 3)],),
                                        {"axis": 0})),
    "stack": ("exact", lambda r: (([_f(r, 2, 3),
                                    _f(r, 2, 3, dtype=np.float16)],),
                                  {"axis": 1})),
    "relu": ("exact", lambda r: ((_f(r, 4, 8, dtype=np.float16),), {})),
    "tanh": ("ulp", lambda r: ((_f(r, 4, 8, dtype=np.float16),), {})),
    "sigmoid": ("ulp", lambda r: ((_f(r, 4, 8, scale=3),), {})),
    "silu": ("ulp", lambda r: ((_f(r, 4, 8, scale=3),), {})),
}


def _public(module):
    return {n for n, f in vars(module).items()
            if inspect.isfunction(f) and not n.startswith("_")
            and f.__module__ == module.__name__
            and n not in ("whitelisted", "blacklisted", "promoted",
                          "banned")} | {"dense", "concatenate"}


def _to(tree, conv):
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(t, conv) for t in tree)
    if isinstance(tree, dict):
        return {k: _to(v, conv) for k, v in tree.items()}
    return conv(tree) if isinstance(tree, np.ndarray) else tree


def _jax(a):
    return jnp.asarray(a)


def _torch(a):
    return torch.from_numpy(a.copy())


TORCH_OF = {"float32": torch.float32, "float16": torch.float16,
            "bfloat16": torch.bfloat16}


def _run(policy, name, args, kwargs):
    ref_props, props, disabled = POLICIES[policy]
    with ref_amp.policy_scope(ref_props), amp.policy_scope(props):
        if disabled:
            with ref_amp.disable_casts(), amp.disable_casts():
                return _run_both(name, args, kwargs)
        return _run_both(name, args, kwargs)


def _run_both(name, args, kwargs):
    want = getattr(RF, name)(*_to(args, _jax), **_to(kwargs, _jax))
    got = getattr(PF, name)(*_to(args, _torch), **_to(kwargs, _torch))
    return want, got


def _ulp(x, dtype):
    """One ulp of ``dtype`` at each |x| (float64; the smallest normal's
    below it)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** MIN_EXP[dtype])))
    return 2.0 ** (e - MANT[dtype])


# these are held to INPUT_ULPS ulps of the larger of output and input
INPUT_ULP = ("gelu", "silu", "softplus")
INPUT_ULPS = 2


def check_close(want, got, cls, scale=None):
    dtype = TORCH_OF[str(want.dtype)]
    assert got.dtype == dtype, (got.dtype, want.dtype)
    w = np.asarray(want.astype(jnp.float32), np.float64)
    g = got.detach().float().numpy().astype(np.float64)
    assert g.shape == w.shape
    err = np.abs(g - w)
    if cls == "exact":
        np.testing.assert_array_equal(g, w)
    elif cls == "ulp":
        at, k = (w, 1) if scale is None else (
            np.maximum(np.abs(w), np.abs(scale)), INPUT_ULPS)
        assert (err <= k * _ulp(at, dtype)).all(), float(
            (err / _ulp(at, dtype)).max())
    elif cls == "mm" and dtype != torch.float32:
        assert (err <= MM_ULPS * _ulp(w, dtype)).all(), float(
            (err / _ulp(w, dtype)).max())
    else:
        top = max(float(np.abs(w).max()), 1e-30)
        assert float(err.max()) <= REDUCE_RTOL * top, float(err.max()) / top


def test_cases_cover_every_function():
    assert set(CASES) == _public(RF) - {"binary_cross_entropy"}
    assert set(CASES) <= _public(PF)


@pytest.mark.parametrize("policy", list(POLICIES))
@pytest.mark.parametrize("name", list(CASES))
def test_matches_reference(name, policy):
    cls, build = CASES[name]
    args, kwargs = build(_rng(name))
    want, got = _run(policy, name, args, kwargs)
    check_close(want, got, cls, args[0] if name in INPUT_ULP else None)


# -- the traps ----------------------------------------------------------------

def test_dot_contracts_like_jnp_not_matmul():
    r = _rng("dot_trap")
    a, b = _f(r, 2, 3, 4), _f(r, 5, 4, 6)
    want = RF.dot(jnp.asarray(a), jnp.asarray(b))
    got = PF.dot(torch.from_numpy(a), torch.from_numpy(b))
    assert tuple(got.shape) == want.shape == (2, 3, 5, 6)
    check_close(want, got, "mm")
    with pytest.raises(RuntimeError):
        torch.matmul(torch.from_numpy(a), torch.from_numpy(b))
    for sa, sb in (((4,), (4,)), ((3, 4), (4,)), ((3, 4), (4, 2)), ((), (3,))):
        x, y = _f(r, *sa), _f(r, *sb)
        check_close(RF.dot(jnp.asarray(x), jnp.asarray(y)),
                    PF.dot(torch.from_numpy(x), torch.from_numpy(y)), "mm")


def test_var_and_std_take_ddof_0():
    x = _f(_rng("var_trap"), 6, 5)
    for fn in ("var", "std"):
        want = float(getattr(RF, fn)(jnp.asarray(x)))
        got = float(getattr(PF, fn)(torch.from_numpy(x)))
        torch_default = float(getattr(torch, fn)(torch.from_numpy(x)))
        assert abs(got - want) <= REDUCE_RTOL * abs(want)
        assert abs(torch_default - want) > 1e-3 * abs(want)
        for axis in (0, 1, (0, 1)):
            check_close(getattr(RF, fn)(jnp.asarray(x), axis=axis, ddof=1),
                        getattr(PF, fn)(torch.from_numpy(x), axis=axis,
                                        ddof=1), "reduce")


@pytest.mark.parametrize("policy", ["none", "O1"])
def test_zero_d_fp32_promotes_fp16(policy):
    r = _rng("zero_d")
    a, s = _f(r, 4, 3, dtype=np.float16), np.array(1.7, np.float32)
    for name in ("add", "mul", "div", "atan2"):
        want, got = _run(policy, name, (a, s), {})
        assert str(want.dtype) == "float32"
        check_close(want, got, "ulp" if name == "atan2" else "exact")
    # PyTorch's own promotion lets the 0-d tensor lose
    assert (torch.from_numpy(a) + torch.from_numpy(s)).dtype == torch.float16
    # a Python float stays weak on both sides, on either side of the op
    for name in ("add", "mul", "div", "atan2"):
        for args in ((a, 0.5), (0.5, a)):
            want, got = _run(policy, name, args, {})
            assert str(want.dtype) == "float16"
            check_close(want, got, "ulp" if name == "atan2" else "exact")


def test_cosine_similarity_clamps_the_product():
    x1 = np.full((2, 4), 5e-6, np.float32)
    x2 = np.full((2, 4), 5e-6, np.float32)
    want = RF.cosine_similarity(jnp.asarray(x1), jnp.asarray(x2))
    got = PF.cosine_similarity(torch.from_numpy(x1), torch.from_numpy(x2))
    check_close(want, got, "reduce")
    assert float(got[0]) < 0.02            # 1e-10 over eps 1e-8
    lib = torch.nn.functional.cosine_similarity(torch.from_numpy(x1),
                                                torch.from_numpy(x2))
    assert abs(float(lib[0]) - 1.0) < 1e-5


def test_kl_div_is_zero_at_zero_targets():
    """A zero target contributes 0 in the port. The reference's clamp,
    1e-38, is an fp32 subnormal that XLA's CPU flushes to zero, so its
    ``log`` is -inf and a zero target gives NaN there (a reference fault,
    ROADMAP C); elsewhere the two agree."""
    r = _rng("kl_trap")
    lp, t = _log_probs(r, 3, 6), _probs(r, 3, 6, zeros=True)
    t[0, :3] = 0.0
    want = np.asarray(RF.kl_div(jnp.asarray(lp), jnp.asarray(t),
                                reduction="none"))
    got = PF.kl_div(torch.from_numpy(lp), torch.from_numpy(t),
                    reduction="none").numpy()
    zero = t == 0
    assert np.isfinite(got).all() and not got[zero].any()
    assert np.isnan(want[zero]).all()
    np.testing.assert_allclose(got[~zero], want[~zero], rtol=0,
                               atol=REDUCE_RTOL * np.abs(want[~zero]).max())


@pytest.mark.parametrize("padding", [0, 2, (1, 2), [(0, 1), (1, 0)],
                                     [(2, 1), (0, 3)], [(1, -1), (-1, 1)],
                                     [(-1, -1), (1, 1)]])
@pytest.mark.parametrize("policy", ["none", "O4"])
def test_conv2d_padding_forms(padding, policy):
    r = _rng("conv_pad")
    args = (_f(r, 2, 3, 9, 8), _f(r, 4, 3, 3, 3), _f(r, 4))
    want, got = _run(policy, "conv2d", args, {"padding": padding,
                                              "stride": (2, 1)})
    check_close(want, got, "mm")


@pytest.mark.parametrize("padding", [0, 1, [(0, 2), (1, 0)], [(2, 1), (1, 1)],
                                     [(-1, -1), (0, 0)]])
def test_conv_transpose2d_padding_forms(padding):
    r = _rng("convt_pad")
    args = (_f(r, 2, 4, 5, 6), _f(r, 4, 3, 4, 4), _f(r, 3))
    want, got = _run("none", "conv_transpose2d", args,
                     {"padding": padding, "stride": 2})
    check_close(want, got, "mm")


def test_conv_transpose2d_refuses_groups():
    r = _rng("convt_groups")
    x, w = _f(r, 1, 4, 5, 5), _f(r, 4, 1, 3, 3)
    with pytest.raises(NotImplementedError):
        RF.conv_transpose2d(jnp.asarray(x), jnp.asarray(w), groups=2)
    with pytest.raises(NotImplementedError):
        PF.conv_transpose2d(torch.from_numpy(x), torch.from_numpy(w),
                            groups=2)


def test_gelu_defaults_to_tanh():
    x = torch.from_numpy(_f(_rng("gelu_trap"), 64, scale=3))
    tanh_ = torch.nn.functional.gelu(x, approximate="tanh")
    erf_ = torch.nn.functional.gelu(x)
    assert float((PF.gelu(x) - tanh_).abs().max()) <= 1e-6
    assert float((PF.gelu(x) - erf_).abs().max()) > 1e-4
    check_close(RF.gelu(jnp.asarray(x.numpy()), approximate=False),
                PF.gelu(x, approximate=False), "ulp", x.numpy())


def test_batch_norm_batch_statistics_leave_running_ones():
    r = _rng("bn_trap")
    x, rm, rv = _f(r, 4, 6, 3, 3), _f(r, 6), _pos(r, 6)
    before = (rm.copy(), rv.copy())
    want = RF.batch_norm(jnp.asarray(x), jnp.asarray(rm), jnp.asarray(rv),
                         training=True)
    trm, trv = torch.from_numpy(rm), torch.from_numpy(rv)
    got = PF.batch_norm(torch.from_numpy(x), trm, trv, training=True)
    check_close(want, got, "reduce")
    assert np.array_equal(trm.numpy(), before[0])
    assert np.array_equal(trv.numpy(), before[1])


@pytest.mark.parametrize("axis", [None, 0, 1])
def test_flattening_reductions(axis):
    x = _pos(_rng("flatten"), 3, 4)
    for name in ("cumsum", "cumprod", "norm", "logsumexp"):
        want = getattr(RF, name)(jnp.asarray(x), axis=axis)
        got = getattr(PF, name)(torch.from_numpy(x), axis=axis)
        assert tuple(got.shape) == want.shape, name
        check_close(want, got, "reduce")


def test_binary_cross_entropy_is_banned_under_o1():
    r = _rng("bce")
    p = (0.05 + 0.9 * r.rand(4, 8)).astype(np.float32)
    t = (r.rand(4, 8) < 0.5).astype(np.float32)
    jp, jt, tp, tt = jnp.asarray(p), jnp.asarray(t), torch.from_numpy(p), \
        torch.from_numpy(t)
    check_close(RF.binary_cross_entropy(jp, jt),
                PF.binary_cross_entropy(tp, tt), "reduce")
    with ref_amp.policy_scope(ref_amp.OPT_LEVELS["O1"]), \
            amp.policy_scope(amp.OPT_LEVELS["O1"]):
        with pytest.raises(RuntimeError, match="binary_cross_entropy"):
            RF.binary_cross_entropy(jp, jt)
        with pytest.raises(RuntimeError, match="binary_cross_entropy"):
            PF.binary_cross_entropy(tp, tt)
        prev = (ref_state.allow_banned, _amp_state.allow_banned)
        ref_state.allow_banned = _amp_state.allow_banned = True
        try:
            check_close(RF.binary_cross_entropy(jp, jt),
                        PF.binary_cross_entropy(tp, tt), "reduce")
        finally:
            ref_state.allow_banned, _amp_state.allow_banned = prev
        with amp.disable_casts():
            assert PF.binary_cross_entropy(tp, tt).dtype == torch.float32
