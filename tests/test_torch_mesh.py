"""The port's mesh, tensor-parallel GPT, mesh train step and sharded
decode against the reference's, at tp 2 and 4.

The port runs in gloo CPU worlds of 2 and 4 processes (once a world for
the module: ``torch_tp_worker.mesh_world``); the reference in this
process, dense or on its GSPMD mesh over as many simulated CPU devices,
on the same weights (the reference's initial parameters, converted by
``models.convert``) and batches from the seed. Mirrors
``tests/test_gpt.py::TestTensorParallel`` (and its GQA flash case),
``tests/test_mesh.py`` (lifecycle, plans, the train step, the sharded
decode) and the ``*_param_specs`` of GPT, BERT and T5.

Tolerances, the reference's own: a tensor-parallel GPT's loss within
rtol 2e-4 of the dense model's, its gradients (each rank's shard put
together) within rtol 2e-3, atol 2e-5; the mesh step's losses within
rtol and atol 2e-5 of the reference's ``MeshTrainStep`` (its
``test_tp2_matches_single_device`` bound) over 3 FusedAdam steps; the
parameters after them within rtol 1e-4, atol 2e-6 (Adam's update,
lr * m / sqrt(v), carries the gradient's fp32 error, ~1e-6 relative,
into each step of at most lr = 1e-3); every replicated leaf bitwise
equal across the port's tensor ranks after every step; greedy tokens
equal. Specs and plan details equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from apex_tpu import mesh as ref_mesh
from apex_tpu.mesh import annotate as ref_annotate
from apex_tpu.models.bert import BertConfig as RefBertConfig
from apex_tpu.models.bert import BertModel as RefBert
from apex_tpu.models.bert import bert_param_specs as ref_bert_specs
from apex_tpu.models.gpt import GPTConfig as RefConfig
from apex_tpu.models.gpt import GPTModel as RefGPT
from apex_tpu.models.gpt import gpt_loss_fn as ref_loss
from apex_tpu.models.gpt import gpt_param_specs as ref_gpt_specs
from apex_tpu.models.t5 import T5Config as RefT5Config
from apex_tpu.models.t5 import T5Model as RefT5
from apex_tpu.models.t5 import t5_param_specs as ref_t5_specs
from apex_tpu.optimizers import FusedAdam as RefAdam

import torch_tp_worker
from apex_tpu_torch import mesh as gmesh
from apex_tpu_torch.mesh import annotate
from apex_tpu_torch.models import (BertConfig, GPTConfig, GPTModel, T5Config,
                                   bert_param_specs, gpt_param_specs,
                                   t5_param_specs)
from apex_tpu_torch.models.convert import (bert_params_from_jax,
                                           gpt_params_from_jax,
                                           t5_params_from_jax)
from apex_tpu_torch.parallel import multiproc

SMALL = dict(vocab_size=64, max_seq_len=16, hidden_size=32, num_layers=2,
             num_heads=4)
# name -> (config keywords, worlds)
GPT_CASES = {
    "flash": ({}, (2, 4)),
    "flash_gqa_window": ({"num_kv_heads": 2, "attention_window": 8}, (2,)),
    "softmax": ({"attention_backend": "softmax"}, (2,)),
    "softmax_gqa": ({"attention_backend": "softmax", "num_heads": 8,
                     "num_kv_heads": 4}, (4,)),
    "flash_gqa": ({"num_heads": 8, "num_kv_heads": 4}, (4,)),
    "sequence_parallel": ({"sequence_parallel": True}, (2, 4)),
}
TRAIN = dict(vocab_size=128, max_seq_len=32, hidden_size=64, num_layers=2,
             num_heads=4)
LAYOUTS = {2: {"model2": {"model": 2}},
           4: {"batch2_model2": {"batch": 2, "model": 2}}}
STEPS, LR = 3, 1e-3
# the reference's TestServingSharded config (GQA, 2 kv heads) at tp=2;
# its MHA form at tp=4, where 2 kv heads do not split
DECODE = {2: dict(TRAIN, num_kv_heads=2), 4: TRAIN}


def _ref_cfg(kw, **extra):
    kw = dict(kw)
    if kw.get("attention_backend", "flash") == "flash":
        kw["softmax_impl"] = "xla"
    return RefConfig(dtype=jnp.float32, **kw, **extra)


def _port_cfg(kw):
    return dict(kw, dtype=torch.float32, param_dtype=torch.float32)


def _tree_np(params):
    return jax.tree.map(np.asarray, params)


def _batch(seed, b, s, vocab):
    tokens = np.random.RandomState(seed).randint(0, vocab, (b, s + 1))
    return tokens[:, :-1].astype(np.int32), tokens[:, 1:].astype(np.int32)


def _inputs(n):
    tokens, labels = _batch(1, 2, 16, SMALL["vocab_size"])
    gpt = {}
    for name, (kw, worlds) in GPT_CASES.items():
        if n not in worlds:
            continue
        cfg = dict(SMALL, **kw)
        params = RefGPT(_ref_cfg({k: v for k, v in cfg.items()
                                  if k != "sequence_parallel"})).init(
            jax.random.PRNGKey(0), jnp.asarray(tokens))
        gpt[name] = {"cfg": _port_cfg(cfg), "tree": _tree_np(params)}
    tt, tl = _batch(2, 8, 16, TRAIN["vocab_size"])
    train = RefGPT(_ref_cfg(TRAIN)).init(jax.random.PRNGKey(0),
                                         jnp.asarray(tt))
    inp = {"gpt": gpt, "tokens": tokens, "labels": labels,
           "draw_cfg": _port_cfg(dict(SMALL, num_heads=8, num_kv_heads=4)),
           "train": {"cfg": _port_cfg(TRAIN), "tree": _tree_np(train)},
           "tokens_train": tt, "labels_train": tl, "steps": STEPS, "lr": LR,
           "train_layouts": LAYOUTS[n]}
    prompt = np.random.RandomState(0).randint(
        0, DECODE[n]["vocab_size"], (2, 8)).astype(np.int32)
    tree = RefGPT(_ref_cfg(DECODE[n])).init(jax.random.PRNGKey(0),
                                           jnp.asarray(prompt))
    inp.update(decode={"cfg": _port_cfg(DECODE[n]), "tree": _tree_np(tree)},
               prompt=prompt, new_tokens=3)
    return inp


@pytest.fixture(scope="module", params=[2, 4], ids=["tp2", "tp4"])
def world(request):
    n = request.param
    inp = _inputs(n)
    return n, inp, multiproc.launch(torch_tp_worker.mesh_world, n, (inp,),
                                    backend="gloo", threads=1, timeout=600)


def _gather(parts, spec):
    dims = [d for d, a in enumerate(spec) if a is not None]
    return np.concatenate(parts, axis=dims[0]) if dims else parts[0]


def _cases(n):
    return [name for name, (_, worlds) in GPT_CASES.items() if n in worlds]


def test_gpt_tensor_parallel_matches_dense(world):
    """TestTensorParallel at tp = world: the loss of each config (the
    sequence-parallel one at the loss only, as the reference tests it)
    and every gradient, each rank's shard put together."""
    n, inp, got = world
    for name in _cases(n):
        case = inp["gpt"][name]
        kw = {k: v for k, v in case["cfg"].items()
              if k not in ("dtype", "param_dtype", "sequence_parallel")}
        model = RefGPT(_ref_cfg(kw))
        x, y = jnp.asarray(inp["tokens"]), jnp.asarray(inp["labels"])
        loss, g = jax.value_and_grad(
            lambda p: ref_loss(model.apply(p, x), y))(case["tree"])
        for r in range(n):
            np.testing.assert_allclose(got[r]["gpt"][name]["loss"],
                                       float(loss), rtol=2e-4, err_msg=name)
        if "grads" not in got[0]["gpt"][name]:
            continue
        want = gpt_params_from_jax(_tree_np(g), GPTConfig(**case["cfg"]))
        specs = gpt_param_specs(want)
        for k, w in want.items():
            mine = _gather([got[r]["gpt"][name]["grads"][k]
                            for r in range(n)], specs[k])
            np.testing.assert_allclose(mine, w.numpy(), rtol=2e-3,
                                       atol=2e-5, err_msg=f"{name} {k}")
            if not specs[k]:
                for r in range(1, n):
                    np.testing.assert_array_equal(
                        got[r]["gpt"][name]["grads"][k],
                        got[0]["gpt"][name]["grads"][k])


def test_drawn_shards_are_the_one_rank_draw_cut(world):
    n, inp, got = world
    whole = GPTModel(GPTConfig(**inp["draw_cfg"]), device="cpu",
                     generator=torch.Generator().manual_seed(5))
    specs = gpt_param_specs(whole)
    for k, v in whole.state_dict().items():
        np.testing.assert_array_equal(
            _gather([got[r]["drawn"][k] for r in range(n)], specs[k]),
            v.numpy(), err_msg=k)


def _ref_train(n, mesh_kw, inp):
    model = RefGPT(_ref_cfg(TRAIN))
    ref_mesh.initialize_mesh(**mesh_kw, devices=jax.devices()[:n])
    try:
        params = inp["train"]["tree"]
        step = ref_mesh.make_mesh_train_step(
            model, RefAdam(lr=LR, impl="xla"), ref_mesh.plan_gpt(params))
        state = step.init(params)
        losses = []
        for _ in range(STEPS):
            state, loss = step(state, inp["tokens_train"],
                               inp["labels_train"])
            losses.append(float(loss))
        final = _tree_np(step.opt.master_params(state))
        return losses, final
    finally:
        ref_mesh.destroy_mesh()


def test_mesh_train_step_matches_reference(world):
    n, inp, got = world
    cfg = GPTConfig(**inp["train"]["cfg"])
    for label, mesh_kw in LAYOUTS[n].items():
        losses, final = _ref_train(n, mesh_kw, inp)
        want = gpt_params_from_jax(final, cfg)
        specs = gpt_param_specs(want)
        model_size = mesh_kw["model"]
        for r in range(n):
            mine = got[r]["train"][label]
            np.testing.assert_allclose(mine["losses"], losses, rtol=2e-5,
                                       atol=2e-5)
            # the replicated leaves: the same bits on every tensor rank,
            # after every step
            first = got[r - r % model_size]["train"][label]
            for a, b in zip(mine["replicated"], first["replicated"]):
                for k in a:
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        for k, w in want.items():
            mine = _gather([got[r]["train"][label]["params"][k]
                            for r in range(model_size)], specs[k])
            w = w.numpy()
            if k.endswith("attention.qkv.bias"):
                # the key bias's gradient is 0 in exact arithmetic (each
                # query's softmax is shift-invariant along its keys), so
                # Adam's normalised step of its fp32 noise is anything in
                # [-lr, lr]: those elements within 2 * STEPS * lr
                keys = _key_rows(TRAIN)
                np.testing.assert_allclose(mine[keys], w[keys], rtol=0,
                                           atol=2 * STEPS * LR, err_msg=k)
                mine, w = mine[~keys], w[~keys]
            np.testing.assert_allclose(mine, w, rtol=1e-4, atol=2e-6,
                                       err_msg=k)
        assert losses[-1] < losses[0]


def _key_rows(kw):
    """The key rows of the fused QKV output, ``[q_0 .. q_{g-1} | k | v]``
    a kv group."""
    heads = kw["num_heads"]
    kv = kw.get("num_kv_heads") or heads
    d = kw["hidden_size"] // heads
    g = heads // kv
    slab = np.zeros((g + 2) * d, bool)
    slab[g * d:(g + 1) * d] = True
    return np.tile(slab, kv)


def test_sharded_greedy_decode_matches_reference(world):
    """TestServingSharded: the reference's model-sharded decode (itself
    token-identical to its one-device engine), greedy tokens equal."""
    n, inp, got = world
    from apex_tpu.serving import KVCache, make_decode_step

    model = RefGPT(_ref_cfg(DECODE[n]))
    params = jax.tree.map(jnp.asarray, inp["decode"]["tree"])
    prompt = jnp.asarray(inp["prompt"])
    ref_mesh.initialize_mesh(model=n, devices=jax.devices()[:n])
    try:
        cache = KVCache.for_config(_ref_cfg(DECODE[n]), num_blocks=16,
                                   block_size=8)
        state = ref_annotate.shard_kv_pool(cache.init_state())
        step = make_decode_step(model, cache)
        for i in range(2):
            cache.allocate(i, 8 + 4)
        tables = cache.table_array([0, 1], width=4)
        lengths = np.asarray([8, 8], np.int32)
        sharded = ref_annotate.shard_params_for_serving(params)
        out = step.prefill(sharded, state, prompt, lengths, tables)
        state, tok = out.cache, out.next_token
        toks = [np.asarray(tok)]
        pos = lengths.copy()
        for _ in range(3):
            out = step.decode(sharded, state, np.asarray(tok), pos, tables)
            state, tok = out.cache, out.next_token
            pos = pos + 1
            toks.append(np.asarray(tok))
    finally:
        ref_mesh.destroy_mesh()
    want = np.stack(toks)
    for r in range(n):
        np.testing.assert_array_equal(got[r]["decode"]["tokens"], want)
        kv = DECODE[n].get("num_kv_heads") or DECODE[n]["num_heads"]
        assert got[r]["decode"]["kv_heads"] == kv // n
        np.testing.assert_allclose(got[r]["decode"]["logits"],
                                   np.asarray(out.logits), rtol=1e-4,
                                   atol=1e-4)


def test_tensor_parallel_paths_that_wait_raise(world):
    n, _, got = world
    for r in range(n):
        msgs = got[r]["raises"]
        assert "A 9g" in msgs["attention_dropout"]
        assert "head offset" in msgs["attention_dropout"]
        assert "sequence_parallel" in msgs["sp_training"]
        assert "A 9g" in msgs["sp_training"]
        # the optimizers whose norms span the tensor group run (A 9h)
        for opt in ("lamb", "novograd"):
            assert isinstance(msgs[opt], float) and np.isfinite(msgs[opt])
        assert "MeshPipelineTrainStep" in got[r]["life"]["pipe"]
        # BERT's and T5's tensor-parallel forwards are not ported
        assert "A 11" in msgs["bert"] and "A 11" in msgs["t5"]


def test_mesh_lifecycle(world):
    n, _, got = world
    for r in range(n):
        life = got[r]["life"]
        assert life["fresh"] == {"batch": 1, "pipe": 1, "model": 1}
        assert life["model2"] == {"batch": n // 2, "pipe": 1, "model": 2}
        assert life["size"] == n
        # model innermost: ranks 2i and 2i + 1 share a tensor group
        assert life["coords"] == {"batch": r // 2, "pipe": 0,
                                  "model": r % 2}
        assert life["destroyed"] == (False, 1)
        assert life["bad"] and life["bad3"]


def test_plan_detail_matches_reference(world):
    n, inp, got = world
    params = RefGPT(_ref_cfg(dict(TRAIN), scan_layers=False)).init(
        jax.random.PRNGKey(0), jnp.asarray(inp["tokens_train"]))
    for label, mesh_kw in LAYOUTS[n].items():
        shape = (mesh_kw.get("batch", 1), 1, mesh_kw["model"])
        m = Mesh(np.asarray(jax.devices()[:n]).reshape(shape),
                 ref_mesh.MESH_AXES)
        want = ref_mesh.plan_gpt(params, mesh=m).detail()
        for r in range(n):
            assert got[r]["train"][label]["plan"] == want


# -- one process: specs, identity, annotate ----------------------------------


def _ref_unrolled(cls, cfg, *args):
    return cls(cfg).init(jax.random.PRNGKey(0), *args)


@pytest.mark.parametrize("family", ["gpt", "bert", "t5"])
def test_param_specs_match_reference_per_name(family):
    """Each port parameter's spec against the reference's spec of the
    parameter it converts from (unrolled trees: no leading layer axis)."""
    toks = jnp.zeros((2, 8), jnp.int32)
    if family == "gpt":
        cfg = RefConfig(**SMALL, scan_layers=False, num_kv_heads=2)
        tree = _ref_unrolled(RefGPT, cfg, toks)
        port = GPTConfig(**SMALL, num_kv_heads=2)
        specs, conv, ref_specs = gpt_param_specs, gpt_params_from_jax, \
            ref_gpt_specs
    elif family == "bert":
        cfg = RefBertConfig(vocab_size=64, max_seq_len=16, hidden_size=32,
                            num_layers=2, num_heads=4, scan_layers=False)
        tree = _ref_unrolled(RefBert, cfg, toks, jnp.ones((2, 8), jnp.int32))
        port = BertConfig(vocab_size=64, max_seq_len=16, hidden_size=32,
                          num_layers=2, num_heads=4)
        specs, conv, ref_specs = bert_param_specs, bert_params_from_jax, \
            ref_bert_specs
    else:
        cfg = RefT5Config(vocab_size=64, max_seq_len=16, hidden_size=32,
                          num_encoder_layers=2, num_decoder_layers=2,
                          num_heads=4, scan_layers=False)
        tree = _ref_unrolled(RefT5, cfg, toks, jnp.ones((2, 8), jnp.int32),
                             toks)
        port = T5Config(vocab_size=64, max_seq_len=16, hidden_size=32,
                        num_encoder_layers=2, num_decoder_layers=2,
                        num_heads=4)
        specs, conv, ref_specs = t5_param_specs, t5_params_from_jax, \
            ref_t5_specs
    # the spec tree, converted leaf by leaf as the parameters are
    ref_tree = ref_specs(tree)
    as_str = jax.tree.map(lambda s: np.asarray(repr(tuple(s))), ref_tree,
                          is_leaf=lambda x: isinstance(
                              x, jax.sharding.PartitionSpec))
    want = {k: eval(str(v.numpy().item() if hasattr(v, "numpy") else v))
            for k, v in _spec_names(as_str, conv, port).items()}
    got = specs(conv(_tree_np(tree), port))
    assert got == want
    assert any(got.values())


def _spec_names(spec_tree, conv, port):
    """The reference's spec strings by the port's parameter names (the
    converter's name map over a tree of strings)."""
    flat = {}

    def walk(t, prefix):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                flat[f"{prefix}{k}"] = str(v)

    walk(spec_tree["params"] if "params" in spec_tree else spec_tree, "")
    codes = {path: np.full((1,), i, np.float32)
             for i, path in enumerate(sorted(flat))}
    tree = {}
    for path, code in codes.items():
        node = tree
        *mods, leaf = path.split("/")
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = code
    back = {int(t.numpy()[0]): name for name, t in conv(
        {"params": tree}, port).items()}
    paths = sorted(flat)
    return {back[i]: flat[paths[i]] for i in back}


def test_one_rank_mesh_is_identity():
    """test_mesh.py's TestShardingPlan.test_identity_on_one_device and
    the lifecycle's degenerate cases, in this process's world of one."""
    gmesh.destroy_mesh()
    assert not gmesh.mesh_initialized() and gmesh.mesh_size() == 1
    assert gmesh.axis_sizes() == {"batch": 1, "pipe": 1, "model": 1}
    with pytest.raises(RuntimeError):
        gmesh.current_mesh()
    state_kv = ("k", "v")
    assert annotate.shard_kv_pool(state_kv) is state_kv
    gmesh.initialize_mesh(batch=1, model=1, pipe=1)
    try:
        assert gmesh.mesh_initialized() and gmesh.mesh_size() == 1
        model = GPTModel(GPTConfig(**SMALL, dtype=torch.float32),
                         device="cpu")
        params = dict(model.named_parameters())
        plan = gmesh.plan_gpt(model)
        assert plan.is_identity()
        assert plan.shard_params(params) is params
        toks = np.zeros((2, 8), np.int32)
        assert plan.shard_batch(toks) is toks
        state = {"anything": torch.ones(3)}
        assert plan.shard_state(state) is state
        assert annotate.shard_params_for_serving(params) is params
        assert annotate.shard_kv_pool(state_kv) is state_kv
        assert not annotate.mesh_active()
        # the embedding and six a layer
        assert plan.detail()["param_leaves_sharded"] == 1 + 6 * 2
        specs = annotate.serving_param_shardings(model)
        assert specs["embedding.weight"] == ("model", None)
        assert specs["layers.0.mlp.fc2.weight"] == (None, "model")
    finally:
        gmesh.destroy_mesh()
    assert not gmesh.mesh_initialized()
    with pytest.raises(ValueError):
        gmesh.initialize_mesh(model=2)


def test_shard_state_cuts_an_adam_state_as_the_parameters():
    """ShardingPlan.shard_state of a full FusedAdam state: each rank's
    part is the state FusedAdam builds over that rank's shard, slot for
    slot (a mesh of two ranks laid out without a process group)."""
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.transformer import parallel_state as ps

    model = GPTModel(GPTConfig(**SMALL, dtype=torch.float32), device="cpu",
                     generator=torch.Generator().manual_seed(0))
    params = dict(model.named_parameters())
    opt = FusedAdam(lr=1e-3)
    full = opt.init(params)
    full.slots["m"].copy_(torch.randn(full.master.shape))
    grid = ps.rank_grid(2, 2)
    for r in range(2):
        topo = ps.Topology(grid=grid, rank=r,
                           coords={**dict.fromkeys(ps.AXES, 0), "tensor": r},
                           groups={})
        plan = gmesh.plan_gpt(model, mesh=gmesh.Mesh(topo))
        mine = plan.shard_state(full)
        want = opt.init(plan.shard_params(params))
        assert mine.space.names == want.space.names
        assert mine.space.shapes == want.space.shapes
        assert torch.equal(mine.master, want.master)
        m_full = full.space.unpack(full.slots["m"], dtype="buffer")
        for k, t in mine.space.unpack(mine.slots["m"], dtype="buffer").items():
            assert torch.equal(t, plan.shard_params({k: m_full[k]})[k])
