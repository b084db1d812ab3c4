"""The port's tensor-parallel mapping ops, layers and vocab-split cross
entropy against the reference's, at tp 2 and 4.

The port runs in gloo CPU worlds of 2 and 4 processes
(``multiproc.launch``, once a world for the module:
``torch_tp_worker.tp_world``); the reference in this process under
``shard_map`` over a ``("tensor",)`` mesh of as many simulated CPU
devices, on the same inputs and the reference's own initial weights.
Mirrors ``tests/test_tensor_parallel.py``'s column, row, composition,
sequence-parallel, embedding and cross-entropy classes.

Tolerances: the mapping ops' splits and gathers bitwise; a sum over two
ranks bitwise (a + b rounds once in either order); over four, another
order than XLA's, so each element within 2^-21 (fp32) or 2^-6 (bf16)
of the sum of the four |terms| (``tests/test_torch_ddp.py``'s bounds).
Layers: the reference's own bounds, sharded against dense (outputs rtol
and atol 1e-5, MLP blocks 1e-4, gradients rtol 1e-4 atol 1e-5); the
fp32 reduction in bf16 within one bf16 ulp (2^-7 relative) of the
reference's and within its own test's 0.02 of the round-once dense
product, strictly closer to float64 on average than the bf16
reduction. Cross entropy: rtol 1e-4, atol 1e-5 (the reference's test).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import shard_map
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from apex_tpu.transformer.tensor_parallel import (
    ColumnParallelLinear as RefColumn,
    RowParallelLinear as RefRow,
    VocabParallelEmbedding as RefEmbedding,
    vocab_parallel_cross_entropy as ref_xent,
)
from apex_tpu.transformer.tensor_parallel import mappings as ref_maps
from apex_tpu.transformer.tensor_parallel.layers import (
    column_bias_spec, column_kernel_spec, row_bias_spec, row_kernel_spec,
    vocab_embedding_spec)

import torch_tp_worker
from apex_tpu_torch.parallel import multiproc
from apex_tpu_torch.transformer import tensor_parallel as tp

T = "tensor"
REF_MAPPINGS = {
    "copy": ref_maps.copy_to_tensor_model_parallel_region,
    "reduce": ref_maps.reduce_from_tensor_model_parallel_region,
    "scatter": ref_maps.scatter_to_tensor_model_parallel_region,
    "gather": ref_maps.gather_from_tensor_model_parallel_region,
    "scatter_seq": ref_maps.scatter_to_sequence_parallel_region,
    "gather_seq": ref_maps.gather_from_sequence_parallel_region,
    "gather_seq_split":
        lambda x: ref_maps.gather_from_sequence_parallel_region(x, T, False),
    "reduce_scatter_seq": ref_maps.reduce_scatter_to_sequence_parallel_region,
}
# the ops whose forward (f) or backward (b) sums over the ranks
SUMS = {"copy": "b", "reduce": "f", "gather_seq": "b",
        "reduce_scatter_seq": "f"}


def _out_shape(name, n):
    return {"copy": (8, 12), "reduce": (8, 12), "scatter": (8, 12 // n),
            "gather": (8, 12 * n), "scatter_seq": (8 // n, 12),
            "gather_seq": (8 * n, 12), "gather_seq_split": (8 * n, 12),
            "reduce_scatter_seq": (8 // n, 12)}[name]


def _np_params(tree):
    p = tree["params"]
    out = {"weight": np.asarray(p.get("kernel", p.get("embedding")))}
    if "bias" in p:
        out["bias"] = np.asarray(p["bias"])
    return out


def _inputs(n):
    rng = np.random.RandomState(0)
    inp = {"map_x": rng.randn(n, 8, 12).astype(np.float32)}
    inp["map_g"] = {k: rng.randn(n, *_out_shape(k, n)).astype(np.float32)
                    for k in REF_MAPPINGS}
    inp["col_x"] = rng.randn(6, 16).astype(np.float32)
    inp["col_t"] = rng.randn(6, 32).astype(np.float32)
    inp["col"] = _np_params(RefColumn(output_size=32).init(
        jax.random.PRNGKey(0), inp["col_x"]))
    inp["row_x"] = rng.randn(6, 32).astype(np.float32)
    inp["row_t"] = rng.randn(6, 24).astype(np.float32)
    inp["row"] = _np_params(RefRow(output_size=24, input_is_parallel=False)
                            .init(jax.random.PRNGKey(0), inp["row_x"]))
    inp["x64"] = rng.randn(64, 512)
    inp["w64"] = rng.randn(32, 512) / np.sqrt(512)
    inp["mlp_x"] = rng.randn(6, 16).astype(np.float32)
    inp["sp_x"] = rng.randn(16, 16).astype(np.float32)
    col = RefColumn(output_size=64, gather_output=False)
    pc = col.init(jax.random.PRNGKey(0), inp["mlp_x"])
    pr = RefRow(output_size=16).init(
        jax.random.PRNGKey(1), jax.nn.gelu(col.apply(pc, inp["mlp_x"])))
    inp["mlp_col"], inp["mlp_row"] = _np_params(pc), _np_params(pr)
    inp["emb_ids"] = rng.randint(0, 64, (4, 10)).astype(np.int64)
    inp["emb_t"] = rng.randn(4, 10, 16).astype(np.float32)
    inp["emb"] = _np_params(RefEmbedding(num_embeddings=64, embedding_dim=16)
                            .init(jax.random.PRNGKey(0), inp["emb_ids"]))
    inp["ce_logits"] = rng.randn(4, 10, 64).astype(np.float32)
    inp["ce_target"] = rng.randint(0, 64, (4, 10)).astype(np.int64)
    oob = inp["ce_target"].copy()
    oob[0, :3] = [64, 100, -1]
    inp["ce_target_oob"] = oob
    return inp


@pytest.fixture(scope="module", params=[2, 4], ids=["tp2", "tp4"])
def world(request):
    n = request.param
    inp = _inputs(n)
    return n, inp, multiproc.launch(torch_tp_worker.tp_world, n, (inp,),
                                    backend="gloo", threads=1, timeout=300)


def _mesh(n):
    return Mesh(np.array(jax.devices()[:n]), (T,))


def _gather(parts, spec):
    """The full tensor from each rank's shard (rank order)."""
    dims = [d for d, a in enumerate(spec) if a is not None]
    return np.concatenate(parts, axis=dims[0]) if dims else parts[0]


def _order_ok(got, want, terms, bound):
    tol = bound * np.abs(np.asarray(terms, np.float64)).sum(0)
    return np.all(np.abs(np.asarray(got, np.float64) - want) <= tol)


def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("name", list(REF_MAPPINGS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mapping_forward_and_backward_match_reference(world, name, dtype):
    n, inp, got = world
    jdt = getattr(jnp, dtype)
    op = REF_MAPPINGS[name]

    def body(x, g):
        y, vjp = jax.vjp(op, x[0])
        return y[None].astype(jnp.float32), vjp(g[0])[0][None].astype(
            jnp.float32)

    y, dx = jax.jit(shard_map(body, mesh=_mesh(n),
                              in_specs=(P(T), P(T)), out_specs=(P(T), P(T)),
                              check_vma=False))(
        jnp.asarray(inp["map_x"], jdt), jnp.asarray(inp["map_g"][name], jdt))
    y, dx = np.asarray(y), np.asarray(dx)
    x_terms, g_terms = inp["map_x"], inp["map_g"][name]
    if dtype == "bfloat16":
        x_terms, g_terms = _bf16(x_terms), _bf16(g_terms)
    bound = 2.0 ** -6 if dtype == "bfloat16" else 2.0 ** -21
    for r in range(n):
        mine = got[r]["mappings"][f"{name}_{dtype}"]
        for key, want, terms in (("y", y[r], x_terms), ("dx", dx[r], g_terms)):
            summed = SUMS.get(name) == ("f" if key == "y" else "b")
            if not summed or n == 2:
                np.testing.assert_array_equal(mine[key], want, err_msg=key)
            else:
                if name == "reduce_scatter_seq":
                    terms = np.stack([t[r * (8 // n):(r + 1) * (8 // n)]
                                      for t in terms])
                elif name == "gather_seq":
                    terms = np.stack([t[r * 8:(r + 1) * 8] for t in terms])
                assert _order_ok(mine[key], want, terms, bound), key
        # the summed results are the same bits on every rank
        if name in ("copy", "reduce"):
            key = "dx" if name == "copy" else "y"
            np.testing.assert_array_equal(mine[key],
                                          got[0]["mappings"][
                                              f"{name}_{dtype}"][key])


def _sharded(fn, n, args, in_specs, out_specs):
    return jax.jit(shard_map(fn, mesh=_mesh(n), in_specs=in_specs,
                             out_specs=out_specs, check_vma=False))(*args)


def _ref_tree(np_params, key="kernel"):
    out = {key: jnp.asarray(np_params["weight"])}
    if "bias" in np_params:
        out["bias"] = jnp.asarray(np_params["bias"])
    return {"params": out}


def test_column_parallel_matches_reference(world):
    n, inp, got = world
    specs = {"params": {"kernel": column_kernel_spec(),
                        "bias": column_bias_spec()}}
    params = _ref_tree(inp["col"])
    x = jnp.asarray(inp["col_x"])
    for gather, out_spec in ((True, P()), (False, P(None, T))):
        layer = RefColumn(output_size=32, gather_output=gather)
        want = np.asarray(_sharded(lambda p, x: layer.apply(p, x), n,
                                   (params, x), (specs, P()), out_spec))
        mine = np.concatenate([got[r]["column"][f"gather{int(gather)}"]
                               for r in range(n)], axis=-1) if not gather \
            else got[0]["column"]["gather1"]
        np.testing.assert_allclose(mine, want, rtol=1e-5, atol=1e-5)
    # gradients: the reference's per-rank loss copies summed
    layer = RefColumn(output_size=32, gather_output=True)
    t = jnp.asarray(inp["col_t"])
    inner = shard_map(lambda p, x: jnp.sum(layer.apply(p, x) * t)[None],
                      mesh=_mesh(n), in_specs=(specs, P()),
                      out_specs=P(T), check_vma=False)
    g = jax.jit(jax.grad(lambda p: jnp.sum(inner(p, x))))(params)["params"]
    for leaf, key, spec in (("weight", "kernel", column_kernel_spec()),
                            ("bias", "bias", column_bias_spec())):
        mine = _gather([got[r]["column"]["grads"][leaf] for r in range(n)],
                       spec)
        np.testing.assert_allclose(mine, np.asarray(g[key]), rtol=1e-4,
                                   atol=1e-5)
    dense_dx = jax.grad(lambda x: jnp.sum(layer.apply(params, x) * t))(x)
    for r in range(n):
        np.testing.assert_allclose(got[r]["column"]["dx"],
                                   np.asarray(dense_dx), rtol=1e-4,
                                   atol=1e-5)
        # skip_bias_add: the local product and this rank's bias apart
        sk = got[r]["column"]["skip_bias"]
        per = 32 // n
        np.testing.assert_array_equal(
            sk["b"], inp["col"]["bias"][r * per:(r + 1) * per])
        np.testing.assert_allclose(sk["y"] + sk["b"],
                                   got[r]["column"]["gather0"], rtol=1e-6,
                                   atol=1e-6)


def test_row_parallel_matches_reference(world):
    n, inp, got = world
    specs = {"params": {"kernel": row_kernel_spec(), "bias": row_bias_spec()}}
    params = _ref_tree(inp["row"])
    x = jnp.asarray(inp["row_x"])
    t = jnp.asarray(inp["row_t"])
    for parallel, x_spec in ((False, P()), (True, P(None, T))):
        layer = RefRow(output_size=24, input_is_parallel=parallel)
        want = np.asarray(_sharded(lambda p, x: layer.apply(p, x), n,
                                   (params, x), (specs, x_spec), P()))
        inner = shard_map(lambda p, x: jnp.sum(layer.apply(p, x) * t)[None],
                          mesh=_mesh(n), in_specs=(specs, x_spec),
                          out_specs=P(T), check_vma=False)
        g = jax.jit(jax.grad(lambda p: jnp.sum(inner(p, x))))(params)
        # the replicated bias: the dense gradient on every rank (the
        # summed copies above hold n of them)
        dense = jax.grad(lambda p: jnp.sum(layer.apply(p, x) * t))(params)
        for r in range(n):
            mine = got[r]["row"][f"parallel{int(parallel)}"]
            np.testing.assert_allclose(mine["y"], want, rtol=1e-5, atol=1e-5)
            np.testing.assert_array_equal(mine["y"],
                                          got[0]["row"][
                                              f"parallel{int(parallel)}"]["y"])
            np.testing.assert_allclose(mine["grads"]["bias"],
                                       np.asarray(dense["params"]["bias"]),
                                       rtol=1e-4, atol=1e-5)
        mine = _gather([got[r]["row"][f"parallel{int(parallel)}"]["grads"]
                        ["weight"] for r in range(n)], row_kernel_spec())
        np.testing.assert_allclose(mine, np.asarray(g["params"]["kernel"]),
                                   rtol=1e-4, atol=1e-5)


def test_row_parallel_fp32_reduce(world):
    """The reference's test_row_parallel_fp32_reduce at this world's tp:
    the fp32 partial sums cross the all-reduce and round to bf16 once."""
    n, inp, got = world
    truth = inp["x64"] @ inp["w64"].T
    x = jnp.asarray(inp["x64"], jnp.bfloat16)

    def ref(fp32):
        layer = RefRow(output_size=32, input_is_parallel=False,
                       use_bias=False, reduce_in_fp32=fp32,
                       param_dtype=jnp.bfloat16)
        params = {"params": {"kernel": jnp.asarray(inp["w64"],
                                                   jnp.bfloat16)}}
        return np.asarray(_sharded(
            lambda p, x: layer.apply(p, x), n, (params, x),
            ({"params": {"kernel": row_kernel_spec()}}, P()), P()),
            np.float64)

    dense = np.asarray((jnp.asarray(inp["x64"], jnp.bfloat16)
                        .astype(jnp.float32)
                        @ jnp.asarray(inp["w64"], jnp.bfloat16)
                        .astype(jnp.float32).T).astype(jnp.bfloat16),
                       np.float64)
    for fp32 in (True, False):
        want = ref(fp32)
        for r in range(n):
            mine = got[r]["row"][f"fp32_{fp32}"].astype(np.float64)
            np.testing.assert_allclose(mine, want, rtol=2.0 ** -7,
                                       atol=2.0 ** -7)
    mine32 = got[0]["row"]["fp32_True"].astype(np.float64)
    mine16 = got[0]["row"]["fp32_False"].astype(np.float64)
    assert np.abs(mine32 - truth).mean() < np.abs(mine16 - truth).mean()
    np.testing.assert_allclose(mine32, dense, rtol=0.02, atol=0.02)


@pytest.mark.parametrize("sp", [False, True], ids=["mlp", "sequence"])
def test_column_row_block_matches_reference(world, sp):
    """Column (no gather) -> gelu -> Row: the Megatron MLP with one
    all-reduce; under sequence parallelism the column layer gathers the
    sequence and the row layer reduce-scatters it."""
    n, inp, got = world
    col = RefColumn(output_size=64, gather_output=False,
                    sequence_parallel_enabled=sp)
    row = RefRow(output_size=16, input_is_parallel=True,
                 sequence_parallel_enabled=sp)
    pc, pr = _ref_tree(inp["mlp_col"]), _ref_tree(inp["mlp_row"])
    cspecs = {"params": {"kernel": column_kernel_spec(),
                         "bias": column_bias_spec()}}
    rspecs = {"params": {"kernel": row_kernel_spec(), "bias": row_bias_spec()}}
    x = jnp.asarray(inp["sp_x"] if sp else inp["mlp_x"])
    xs = P(T, None) if sp else P()

    def block(pc, pr, x):
        return row.apply(pr, jax.nn.gelu(col.apply(pc, x)))

    want = np.asarray(_sharded(block, n, (pc, pr, x), (cspecs, rspecs, xs),
                               xs))
    inner = shard_map(lambda pc, pr, x: jnp.sum(block(pc, pr, x))[None],
                      mesh=_mesh(n), in_specs=(cspecs, rspecs, xs),
                      out_specs=P(T), check_vma=False)
    gc, gr = jax.jit(jax.grad(lambda pc, pr: jnp.sum(inner(pc, pr, x)),
                              argnums=(0, 1)))(pc, pr)
    key = f"sp{int(sp)}"
    rows = 16 // n
    for r in range(n):
        mine = got[r]["block"][key]["y"]
        np.testing.assert_allclose(
            mine, want[r * rows:(r + 1) * rows] if sp else want,
            rtol=1e-4, atol=1e-4)
    for leaf, k, spec in (("weight", "kernel", column_kernel_spec()),
                          ("bias", "bias", column_bias_spec())):
        np.testing.assert_allclose(
            _gather([got[r]["block"][key]["col"][leaf] for r in range(n)],
                    spec), np.asarray(gc["params"][k]), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(
        _gather([got[r]["block"][key]["row"]["weight"] for r in range(n)],
                row_kernel_spec()), np.asarray(gr["params"]["kernel"]),
        rtol=1e-4, atol=1e-5)
    if not sp:
        # the dense block's input gradient on every rank
        dense = jax.grad(lambda x: jnp.sum(row.apply(pr, jax.nn.gelu(
            col.apply(pc, x)))))(x)
        for r in range(n):
            np.testing.assert_allclose(got[r]["block"][key]["dx"],
                                       np.asarray(dense), rtol=1e-4,
                                       atol=1e-5)
        # the functional core: the local column product, the input's
        # gradient all-reduced
        w = inp["mlp_col"]["weight"]
        per = 64 // n
        for r in range(n):
            f = got[r]["block"]["functional"]
            np.testing.assert_allclose(
                f["y"], inp["mlp_x"] @ w[r * per:(r + 1) * per].T,
                rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(
                f["dx"], np.ones((6, 64), np.float32) @ w, rtol=1e-5,
                atol=1e-5)


def test_vocab_parallel_embedding_matches_reference(world):
    n, inp, got = world
    emb = RefEmbedding(num_embeddings=64, embedding_dim=16)
    params = _ref_tree(inp["emb"], "embedding")
    specs = {"params": {"embedding": vocab_embedding_spec()}}
    ids = jnp.asarray(inp["emb_ids"], jnp.int32)
    want = np.asarray(_sharded(lambda p, i: emb.apply(p, i), n,
                               (params, ids), (specs, P()), P()))
    t = jnp.asarray(inp["emb_t"])
    fn = shard_map(lambda p, i: jnp.sum(emb.apply(p, i) * t)[None],
                   mesh=_mesh(n), in_specs=(specs, P()), out_specs=P(T),
                   check_vma=False)
    g = jax.jit(jax.grad(lambda p: jnp.sum(fn(p, ids))))(params)
    for r in range(n):
        # one rank holds each row: the all-reduce adds zeros, exactly
        np.testing.assert_array_equal(got[r]["embedding"]["y"], want)
    np.testing.assert_allclose(
        _gather([got[r]["embedding"]["grad"] for r in range(n)],
                vocab_embedding_spec()),
        np.asarray(g["params"]["embedding"]), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("target", ["in_range", "out_of_range"])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_vocab_parallel_cross_entropy_matches_reference(world, target,
                                                        smoothing):
    n, inp, got = world
    logits = jnp.asarray(inp["ce_logits"])
    key = "ce_target" if target == "in_range" else "ce_target_oob"
    tgt = jnp.asarray(inp[key], jnp.int32)

    def body(l, t):
        loss, vjp = jax.vjp(lambda l_: ref_xent(l_, t, smoothing), l)
        return loss[None], vjp(jnp.ones_like(loss))[0]

    loss, grad = _sharded(body, n, (logits, tgt), (P(None, None, T), P()),
                          (P(T), P(None, None, T)))
    loss, grad = np.asarray(loss), np.asarray(grad)
    for r in range(n):
        mine = got[r]["xent"][f"{target}_{smoothing}"]
        np.testing.assert_allclose(mine["loss"], loss[r], rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_array_equal(mine["loss"],
                                      got[0]["xent"][f"{target}_{smoothing}"]
                                      ["loss"])
    mine = np.concatenate([got[r]["xent"][f"{target}_{smoothing}"]["grad"]
                           for r in range(n)], axis=-1)
    np.testing.assert_allclose(mine, grad, rtol=1e-4, atol=1e-5)
    if target == "in_range" and smoothing == 0.0:
        # and the full softmax cross entropy's, as the reference's test
        lse = jax.scipy.special.logsumexp(logits, axis=-1)
        full = lse - jnp.take_along_axis(logits, tgt[..., None], -1)[..., 0]
        np.testing.assert_allclose(got[0]["xent"]["in_range_0.0"]["loss"],
                                   np.asarray(full), rtol=1e-4, atol=1e-5)


def test_split_and_vocab_utilities():
    import torch

    x = torch.arange(24.0).reshape(2, 12)
    parts = tp.split_tensor_along_last_dim(x, 3)
    assert len(parts) == 3 and all(p.shape == (2, 4) for p in parts)
    assert torch.equal(torch.cat(parts, -1), x)
    assert tp.VocabUtility.vocab_range_from_global_vocab_size(64, 3, 4) == \
        (48, 64)
    assert tp.divide(12, 4) == 3
    with pytest.raises(ValueError):
        tp.ensure_divisibility(10, 4)
    # one rank: every op is the identity, the layer dense
    assert tp.copy_to_tensor_model_parallel_region(x) is x
    assert tp.gather_from_tensor_model_parallel_region(x) is x
    assert tp.tensor_axis().size == 1
