"""apex_tpu_torch.serving against apex_tpu.serving, and the port's rules.

The tiny fp32 GPT of tests/test_serving.py is initialised in flax and
converted; both packages then serve the same prompts:

- the cache ops: ``gather_kv`` after ``append_kv`` / ``append_kv_prefill``
  / ``append_kv_chunk`` is bitwise equal to the reference's (pure data
  movement);
- ``DecodeStep``: prefill then N greedy decodes give the reference's
  tokens exactly and its logits within 1e-4 absolute (fp32 through two
  layers and the LM head, summed in other orders);
- ``ContinuousBatcher``: six requests, one of them chunked and two
  sharing a prompt prefix, give the reference engine's token streams
  exactly, greedy and sampled (temperature, top-k, top-p and seed per
  request, lanes mixed);
- sampled ``DecodeStep`` dispatches draw the reference's tokens: the
  gumbel noise comes from the ported threefry2x32 and the key
  ``fold_in(PRNGKey(seed), token index)``. Its ``-log(-log(u))`` is an
  fp32 ulp or so off the reference's on ~20% of draws (the two ``log``
  implementations), far below the gaps between candidate scores.

Then the port's own rules: an entry point without ``device`` raises
where there is no CUDA device, ``import apex_tpu_torch`` loads no JAX,
and no file of the package imports JAX, flax or apex_tpu.
"""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from apex_tpu import serving as ref_serving
from apex_tpu.models.gpt import GPTConfig as RefConfig
from apex_tpu.models.gpt import GPTModel as RefModel
from apex_tpu.serving import kv_cache as ref_kv

import apex_tpu_torch
from apex_tpu_torch import serving
from apex_tpu_torch.models import GPTConfig, GPTModel, load_jax_params
from apex_tpu_torch.serving import kv_cache as port_kv

VOCAB, SEQ, HID, LAYERS, HEADS, KV = 64, 64, 32, 2, 4, 2
D = HID // HEADS
BLOCKS, BS = 32, 4
LOGIT_ATOL = 1e-4


@pytest.fixture(scope="module")
def models():
    ref = RefModel(RefConfig(vocab_size=VOCAB, max_seq_len=SEQ,
                             hidden_size=HID, num_layers=LAYERS,
                             num_heads=HEADS, num_kv_heads=KV,
                             dtype=jnp.float32, param_dtype=jnp.float32,
                             softmax_impl="xla"))
    toks = jnp.asarray(np.random.RandomState(0).randint(0, VOCAB, (1, 8)),
                       jnp.int32)
    params = ref.init(jax.random.PRNGKey(0), toks)
    cfg = GPTConfig(vocab_size=VOCAB, max_seq_len=SEQ, hidden_size=HID,
                    num_layers=LAYERS, num_heads=HEADS, num_kv_heads=KV,
                    dtype=torch.float32, param_dtype=torch.float32)
    port = load_jax_params(GPTModel(cfg, device="cpu"),
                           jax.tree_util.tree_map(np.asarray, params))
    return ref, params, port


def ref_cache():
    return ref_kv.KVCache(LAYERS, KV, D, num_blocks=BLOCKS, block_size=BS,
                          dtype=jnp.float32)


def port_cache():
    return port_kv.KVCache(LAYERS, KV, D, num_blocks=BLOCKS, block_size=BS,
                           dtype=torch.float32, device="cpu")


# -- cache ops -------------------------------------------------------------


def test_append_then_gather_bitwise_against_reference():
    rng = np.random.RandomState(1)
    rc, pc = ref_cache(), port_cache()
    for c in (rc, pc):
        c.allocate("a", 3 * BS)
        c.allocate("b", 3 * BS)
    tables = rc.table_array(["a", "b"], width=3)
    np.testing.assert_array_equal(tables, pc.table_array(["a", "b"], 3))
    rs, ps = rc.init_state(), pc.init_state()
    s = 7
    k = rng.randn(LAYERS, 2, KV, s, D).astype(np.float32)
    v = rng.randn(LAYERS, 2, KV, s, D).astype(np.float32)
    lengths = np.array([7, 3], np.int32)
    rs = ref_kv.append_kv_prefill(rs, jnp.asarray(k), jnp.asarray(v),
                                  jnp.asarray(tables), jnp.asarray(lengths))
    ps = port_kv.append_kv_prefill(ps, torch.from_numpy(k),
                                   torch.from_numpy(v), tables, lengths)
    # a chunk resuming lane 1 at position 3, then one decode token each
    ck = rng.randn(LAYERS, 2, KV, 4, D).astype(np.float32)
    starts, clens = np.array([7, 3], np.int32), np.array([0, 4], np.int32)
    rs = ref_kv.append_kv_chunk(rs, jnp.asarray(ck), jnp.asarray(ck),
                                jnp.asarray(tables), jnp.asarray(starts),
                                jnp.asarray(clens))
    ps = port_kv.append_kv_chunk(ps, torch.from_numpy(ck),
                                 torch.from_numpy(ck), tables, starts, clens)
    tk = rng.randn(LAYERS, 2, KV, D).astype(np.float32)
    pos = np.array([7, 7], np.int32)
    rs = ref_kv.append_kv(rs, jnp.asarray(tk), jnp.asarray(tk),
                          jnp.asarray(tables), jnp.asarray(pos))
    ps = port_kv.append_kv(ps, torch.from_numpy(tk), torch.from_numpy(tk),
                           tables, pos)
    rk, rv = ref_kv.gather_kv(rs, jnp.asarray(tables))
    gk, gv = port_kv.gather_kv(ps, tables)
    np.testing.assert_array_equal(gk.numpy(), np.asarray(rk))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(rv))
    # trash block aside, the pools themselves agree bitwise
    np.testing.assert_array_equal(ps.k[:, 1:].numpy(), np.asarray(rs.k)[:, 1:])


def test_allocator_follows_reference_through_a_script():
    # the same allocator calls on both caches: prefix sharing with a COW
    # fork, a dirty (quarantine-style) free with its scrub hand-back,
    # staged extension and the read-only prefix probe
    rc, pc = ref_cache(), port_cache()
    prompt = list(range(1, 11))                       # 2.5 blocks of 4

    def script(c):
        out = []
        c.allocate_prefix("a", prompt, total_len=14)
        c.publish_prefix("a", prompt)
        m = c.allocate_prefix("b", prompt[:9] + [60, 61], total_len=16,
                              chunk=4)
        out.append(tuple(m))
        out.append(c.extend("b", 16))
        out.append(c.prefix_match_len(prompt + [5]))
        out.append(c.exclusive_blocks("b"))
        c.fork_copied("b")
        out.append(c.free("a", dirty=True))
        out.append(c.free("b"))
        pending = c.take_pending_scrub()
        out.append(sorted(pending))
        c.scrub_done(pending)
        out.append((c.free_blocks, c.blocks_in_use, c.prefix_stats()))
        out.append(c.allocate("c", 9))
        return out

    assert script(pc) == script(rc)


def test_export_import_round_trip():
    rng = np.random.RandomState(5)
    c = port_cache()
    state = c.init_state()
    state.k.copy_(torch.from_numpy(
        rng.randn(*state.k.shape).astype(np.float32)))
    c.allocate("src", 2 * BS + 1)
    blocks, k, v = c.export_blocks(state, "src", length=2 * BS)
    assert len(blocks) == 2 and k.shape[1] == 2
    c.allocate("dst", 2 * BS)
    c.import_blocks(state, "dst", k, v)
    dst = c.table("dst")
    np.testing.assert_array_equal(state.k[:, dst].numpy(),
                                  state.k[:, blocks].numpy())


def _bf16_pools(seed):
    """One bf16 pool's bits in both packages: the port's cache state and
    the reference's, filled with the same random bf16 values (signed
    zeros, subnormals and large magnitudes included)."""
    rng = np.random.RandomState(seed)
    shape = (LAYERS, BLOCKS + 1, BS, KV, D)
    vals = (rng.randn(*shape) * 10.0 ** rng.randint(-40, 5, shape)).astype(
        np.float32)
    vals.reshape(-1)[:3] = (-0.0, 1e-40, 3e38)
    bits = torch.from_numpy(vals).bfloat16()
    pc = port_kv.KVCache(LAYERS, KV, D, num_blocks=BLOCKS, block_size=BS,
                         dtype=torch.bfloat16, device="cpu")
    ps = port_kv.KVCacheState(bits.clone(), bits.flip(0).contiguous())
    raw = [t.view(torch.int16).numpy().view(np.uint16)
           for t in (ps.k, ps.v)]
    rc = ref_kv.KVCache(LAYERS, KV, D, num_blocks=BLOCKS, block_size=BS,
                        dtype=jnp.bfloat16)
    rs = ref_kv.KVCacheState(
        *(jax.lax.bitcast_convert_type(jnp.asarray(r), jnp.bfloat16)
          for r in raw))
    return pc, ps, rc, rs, raw


def test_bf16_export_gives_the_pool_bits_as_uint16():
    pc, ps, _, _, raw = _bf16_pools(11)
    pc.allocate("src", 3 * BS)
    blocks, k, v = pc.export_blocks(ps, "src", length=2 * BS + 1)
    assert k.dtype == v.dtype == np.uint16 and k.shape[1] == 3
    np.testing.assert_array_equal(k, raw[0][:, blocks])
    np.testing.assert_array_equal(v, raw[1][:, blocks])
    assert pc.dtype_name == "bfloat16"


def test_bf16_import_is_bitwise():
    pc, ps, _, _, raw = _bf16_pools(12)
    pc.allocate("src", 2 * BS)
    blocks, k, v = pc.export_blocks(ps, "src")
    pc.allocate("dst", 3 * BS)
    pc.import_blocks(ps, "dst", k, v)
    dst = pc.table("dst")[:2]
    for t, r in zip((ps.k, ps.v), raw):
        got = t[:, dst].view(torch.int16).numpy().view(np.uint16)
        np.testing.assert_array_equal(got, r[:, blocks])


def test_bf16_manifest_matches_the_reference():
    """The port's manifest over its uint16 export names ``bfloat16`` and
    has the reference's root over the reference's own export of the same
    bits; the reference's bfloat16 arrays import into the port's pool
    bit for bit."""
    pc, ps, rc, rs, _ = _bf16_pools(13)
    for c in (pc, rc):
        c.allocate("src", 3 * BS)
    pb, pk, pv = pc.export_blocks(ps, "src", length=3 * BS)
    rb, rk, rv = rc.export_blocks(rs, "src", length=3 * BS)
    assert pb == rb and str(rk.dtype) == "bfloat16"
    want = ref_serving.FleetRouter._manifest(rb, rk, rv)
    got = serving.FleetRouter._manifest(pb, pk, pv, dtype=pc.dtype_name)
    assert got == want and got["dtype"] == "bfloat16"
    assert serving.FleetRouter._manifest(rb, rk, rv) == want
    pc.allocate("dst", 3 * BS)
    pc.import_blocks(ps, "dst", rk, rv)
    _, k2, v2 = pc.export_blocks(ps, "dst")
    np.testing.assert_array_equal(k2, pk)
    np.testing.assert_array_equal(v2, pv)


def test_copies_and_scrub_bitwise_against_reference():
    rng = np.random.RandomState(2)
    pool = rng.randn(LAYERS, BLOCKS + 1, BS, KV, D).astype(np.float32)
    rs = ref_kv.KVCacheState(jnp.asarray(pool), jnp.asarray(pool))
    ps = port_kv.KVCacheState(torch.from_numpy(pool.copy()),
                              torch.from_numpy(pool.copy()))
    rs = ref_kv.scrub_blocks(ref_kv.apply_copies(rs, [(3, 5, 2)]), [7, 2])
    ps = port_kv.scrub_blocks(port_kv.apply_copies(ps, [(3, 5, 2)]), [7, 2])
    np.testing.assert_array_equal(ps.k.numpy(), np.asarray(rs.k))
    np.testing.assert_array_equal(ps.v.numpy(), np.asarray(rs.v))


# -- DecodeStep --------------------------------------------------------------


def test_decode_step_greedy_tokens_match_reference(models):
    ref, params, port = models
    plens, n_decode = [11, 6], 6
    b = len(plens)
    rng = np.random.RandomState(3)
    toks = np.zeros((b, 16), np.int32)
    for i, n in enumerate(plens):
        toks[i, :n] = rng.randint(0, VOCAB, n)
    rc, pc = ref_cache(), port_cache()
    for c in (rc, pc):
        for i, n in enumerate(plens):
            c.allocate(i, n + n_decode)
    tables = rc.table_array([0, 1], width=8)
    rstep = ref_serving.make_decode_step(ref, rc)
    pstep = serving.make_decode_step(port, pc)
    lengths = np.asarray(plens, np.int32)
    rout = rstep.prefill(params, rc.init_state(), toks, lengths, tables)
    pout = pstep.prefill(pc.init_state(), toks, lengths, tables)
    rstate, pstate = rout.cache, pout.cache
    positions = lengths.copy()
    for _ in range(n_decode + 1):
        np.testing.assert_allclose(pout.logits.numpy(),
                                   np.asarray(rout.logits), rtol=0,
                                   atol=LOGIT_ATOL)
        nxt = np.asarray(rout.next_token)
        np.testing.assert_array_equal(pout.next_token.numpy(), nxt)
        assert pout.finite.all()
        if positions[0] >= plens[0] + n_decode:
            break
        rout = rstep.decode(params, rstate, nxt, positions, tables)
        pout = pstep.decode(pstate, nxt, positions, tables)
        rstate, pstate = rout.cache, pout.cache
        positions = positions + 1


def test_decode_step_refuses_sampling(models):
    # sampled decoding is ported (the sampled-stream tests below): what
    # is refused is a sampling setting outside its range, as the
    # reference's Request refuses it
    _, _, port = models
    c = port_cache()
    step = serving.make_decode_step(port, c)
    table = np.zeros((1, 1), np.int32)
    with pytest.raises(ValueError, match="temperature"):
        step.decode(c.init_state(), [1], [0], table,
                    sampling=([-0.5], [0], [1.0], [0]))
    with pytest.raises(ValueError, match="top_p"):
        step.decode(c.init_state(), [1], [0], table,
                    sampling=([0.7], [0], [0.0], [0]))
    for kw in ({"temperature": -1.0}, {"top_k": -1}, {"top_p": 0.0},
               {"top_p": 1.5}):
        with pytest.raises(ValueError):
            serving.Request(id=0, prompt=[1, 2], **kw)
    assert serving.Request(id=0, prompt=[1, 2], temperature=0.5).seed == 0


SAMPLING = {   # per lane: (temperature, top_k, top_p, seed)
    "mixed": [(0.0, 0, 1.0, 0), (0.8, 50, 0.95, 11), (1.3, 0, 1.0, 7),
              (0.6, 5, 1.0, 3)],
    "nucleus": [(1.0, 0, 0.3, 1), (2.0, 0, 0.9, 2), (0.9, 3, 0.5, 5),
                (1.0, 1, 1.0, 9)],
}


@pytest.mark.parametrize("case", sorted(SAMPLING))
def test_decode_step_sampled_tokens_match_reference(models, case):
    ref, params, port = models
    lanes = SAMPLING[case]
    plens, n_decode = [11, 6, 9, 4], 8
    b = len(plens)
    rng = np.random.RandomState(5)
    toks = np.zeros((b, 16), np.int32)
    for i, n in enumerate(plens):
        toks[i, :n] = rng.randint(0, VOCAB, n)
    sampling = tuple(np.asarray(col, dt) for col, dt in zip(
        zip(*lanes), (np.float32, np.int32, np.float32, np.uint32)))
    rc, pc = ref_cache(), port_cache()
    for c in (rc, pc):
        for i, n in enumerate(plens):
            c.allocate(i, n + n_decode)
    tables = rc.table_array(list(range(b)), width=8)
    rstep = ref_serving.make_decode_step(ref, rc)
    pstep = serving.make_decode_step(port, pc)
    lengths = np.asarray(plens, np.int32)
    rout = rstep.prefill(params, rc.init_state(), toks, lengths, tables,
                         sampling=sampling)
    pout = pstep.prefill(pc.init_state(), toks, lengths, tables,
                         sampling=sampling)
    rstate, pstate = rout.cache, pout.cache
    positions = lengths.copy()
    greedy_lane = [t == 0.0 for t, _, _, _ in lanes]
    for _ in range(n_decode):
        nxt = np.asarray(rout.next_token)
        np.testing.assert_array_equal(pout.next_token.numpy(), nxt)
        # a greedy lane is the argmax, whatever its neighbours draw
        for i, g in enumerate(greedy_lane):
            if g:
                assert nxt[i] == int(np.argmax(np.asarray(rout.logits)[i]))
        rout = rstep.decode(params, rstate, nxt, positions, tables,
                            sampling=sampling)
        pout = pstep.decode(pstate, nxt, positions, tables,
                            sampling=sampling)
        rstate, pstate = rout.cache, pout.cache
        positions = positions + 1


def test_select_token_draws_the_reference_gumbel_argmax():
    # the sampler alone, on logits with well-separated scores: its draw
    # is argmax(masked + gumbel(fold_in(PRNGKey(seed), pos)))
    rng = np.random.RandomState(6)
    b, v = 6, 97
    out = rng.randn(b, v).astype(np.float32) * 3
    seeds = np.arange(b, dtype=np.uint32) * 1000 + 17
    pos = np.arange(b) + 40
    temps = np.full(b, 0.7, np.float32)
    got = serving.select_token(
        torch.from_numpy(out), (temps, np.zeros(b, np.int32),
                                np.ones(b, np.float32), seeds), pos)
    for i in range(b):
        key = jax.random.fold_in(jax.random.PRNGKey(seeds[i]), pos[i])
        g = np.asarray(jax.random.gumbel(key, (v,), jnp.float32))
        assert int(got[i]) == int(np.argmax(out[i] / np.float32(0.7) + g))


def test_batcher_sampled_streams_match_reference(models):
    ref, params, port = models
    rc, pc = ref_cache(), port_cache()
    kw = dict(max_batch=4, max_prefill_batch=2, prefill_chunk=8)
    knobs = [dict(temperature=0.8, top_k=50, top_p=0.95, seed=1),
             dict(),
             dict(temperature=1.2, top_k=0, top_p=0.9, seed=2),
             dict(temperature=0.5, top_k=8, top_p=1.0, seed=3),
             dict(),
             dict(temperature=1.0, top_k=0, top_p=1.0, seed=4)]
    reqs = _requests()

    def run(mod, eng, c):
        return mod.serve_loop(eng, c.init_state(), [
            mod.Request(id=i, prompt=p, max_new_tokens=n, **k)
            for (i, p, n), k in zip(reqs, knobs)])[1]

    rres = run(ref_serving, ref_serving.ContinuousBatcher(ref, params, rc,
                                                          **kw), rc)
    pres = run(serving, serving.ContinuousBatcher(port, pc, **kw), pc)
    want = {r.id: r.tokens for r in rres}
    assert {r.id: r.tokens for r in pres} == want
    # a replay regenerates every sampled stream token for token
    pc2 = port_cache()
    again = run(serving, serving.ContinuousBatcher(port, pc2, **kw), pc2)
    assert {r.id: r.tokens for r in again} == want


# -- ContinuousBatcher ---------------------------------------------------------


def _requests():
    rng = np.random.RandomState(4)
    shared = list(rng.randint(0, VOCAB, 13))
    prompts = [list(rng.randint(0, VOCAB, 5)),
               list(rng.randint(0, VOCAB, 21)),          # chunked (> 8)
               shared + [7],
               list(rng.randint(0, VOCAB, 3)),
               list(rng.randint(0, VOCAB, 8)),
               shared + [9, 11]]                         # prefix hit
    news = [4, 3, 5, 6, 2, 4]
    return [(i, p, n) for i, (p, n) in enumerate(zip(prompts, news))]


def test_batcher_streams_match_reference(models):
    ref, params, port = models
    rc, pc = ref_cache(), port_cache()
    kw = dict(max_batch=4, max_prefill_batch=2, prefill_chunk=8)
    reng = ref_serving.ContinuousBatcher(ref, params, rc, **kw)
    peng = serving.ContinuousBatcher(port, pc, **kw)
    reqs = _requests()
    _, rres = ref_serving.serve_loop(
        reng, rc.init_state(),
        [ref_serving.Request(id=i, prompt=p, max_new_tokens=n)
         for i, p, n in reqs])
    _, pres = serving.serve_loop(
        peng, pc.init_state(),
        [serving.Request(id=i, prompt=p, max_new_tokens=n)
         for i, p, n in reqs])
    want = {r.id: r.tokens for r in rres}
    got = {r.id: r.tokens for r in pres}
    assert got == want
    assert all(r.finish_reason == "length" for r in pres)
    assert pc.prefix_stats()["hits"] >= 1       # the shared-prefix pair
    assert pc.blocks_in_use == 0


@pytest.mark.parametrize("knobs", [
    dict(prefill_chunk=8, prefill_interval=2),
    dict(prefill_chunk=4, prefill_token_budget=4, max_prefill_batch=1),
    dict(prefill_chunk=None)], ids=["interval", "budget", "monolithic"])
def test_batcher_schedule_knobs_keep_the_streams(models, knobs):
    # how prefill is chunked and interleaved with decode changes the
    # schedule, not the greedy tokens
    _, _, port = models
    reqs = [serving.Request(id=i, prompt=p, max_new_tokens=n)
            for i, p, n in _requests()]
    c1, c2 = port_cache(), port_cache()
    _, base = serving.serve_loop(
        serving.ContinuousBatcher(port, c1, max_batch=4,
                                  max_prefill_batch=2, prefill_chunk=8),
        c1.init_state(), reqs)
    kw = dict(max_batch=4, max_prefill_batch=2)
    kw.update(knobs)
    _, got = serving.serve_loop(serving.ContinuousBatcher(port, c2, **kw),
                                c2.init_state(), reqs)
    assert {r.id: r.tokens for r in got} == {r.id: r.tokens for r in base}
    assert c2.blocks_in_use == 0


def test_batcher_rejects_oversized_and_honours_eos(models):
    _, _, port = models
    c = port_kv.KVCache(LAYERS, KV, D, num_blocks=4, block_size=BS,
                        dtype=torch.float32, device="cpu")
    eng = serving.ContinuousBatcher(port, c, max_batch=2)
    state = c.init_state()
    eng.submit(serving.Request(id="big", prompt=[1] * 10, max_new_tokens=20))
    eng.submit(serving.Request(id="ok", prompt=[3] * 4, max_new_tokens=5))
    while not eng.idle():
        state, _ = eng.step(state)
    res = {r.id: r for r in eng.drain()}
    assert res["big"].finish_reason == "error"
    assert res["big"].reason == "oversized"
    assert len(res["ok"].tokens) == 5
    eos = res["ok"].tokens[1]
    eng.submit(serving.Request(id="e", prompt=[3] * 4, max_new_tokens=5,
                               eos_id=eos))
    while not eng.idle():
        state, _ = eng.step(state)
    out = eng.drain()[0]
    assert out.finish_reason == "eos"
    assert out.tokens == res["ok"].tokens[:res["ok"].tokens.index(eos) + 1]
    assert c.blocks_in_use == 0


def test_static_batch_generate_same_tokens(models):
    _, _, port = models
    reqs = [serving.Request(id=i, prompt=p, max_new_tokens=n)
            for i, p, n in _requests() if len(p) <= 16]
    c1, c2 = port_cache(), port_cache()
    _, cb = serving.serve_loop(serving.ContinuousBatcher(port, c1),
                               c1.init_state(), reqs)
    _, st = serving.static_batch_generate(port, c2, c2.init_state(), reqs,
                                          batch_size=3)
    assert {r.id: r.tokens for r in cb} == {r.id: r.tokens for r in st}


# -- the port's rules ----------------------------------------------------------


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = GPTConfig(vocab_size=VOCAB, max_seq_len=SEQ, hidden_size=HID,
                    num_layers=1, num_heads=HEADS)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        apex_tpu_torch.resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GPTModel(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_kv.KVCache.for_config(cfg, num_blocks=4)
    assert apex_tpu_torch.resolve_device("cpu") == torch.device("cpu")


def test_import_loads_no_jax():
    code = ("import sys, apex_tpu_torch, apex_tpu_torch.serving, "
            "apex_tpu_torch.models, apex_tpu_torch.ops, "
            "apex_tpu_torch.telemetry, apex_tpu_torch.resilience, "
            "apex_tpu_torch.records, apex_tpu_torch.serving.resilience, "
            "apex_tpu_torch.serving.tracing, apex_tpu_torch.serving.fleet, "
            "apex_tpu_torch.telemetry.comms, apex_tpu_torch.telemetry.fleet, "
            "apex_tpu_torch.resilience.retry, apex_tpu_torch.parallel, "
            "apex_tpu_torch.parallel.multiproc, apex_tpu_torch.runtime, "
            "apex_tpu_torch.transformer.parallel_state, "
            "apex_tpu_torch.transformer.tensor_parallel, "
            "apex_tpu_torch.mesh, apex_tpu_torch.mesh.planner, "
            "apex_tpu_torch.contrib.optimizers, "
            "apex_tpu_torch.parallel.sharded_norms, "
            "apex_tpu_torch.mesh.pipeline, "
            "apex_tpu_torch.transformer.pipeline_parallel, "
            "apex_tpu_torch.examples.pretrain_gpt, "
            "apex_tpu_torch.examples.simple_ddp, "
            "apex_tpu_torch.examples.imagenet_main_amp; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'apex_tpu')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    root = Path(apex_tpu_torch.__file__).resolve().parent.parent
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_package_sources_never_import_jax_or_the_reference():
    pkg = Path(apex_tpu_torch.__file__).resolve().parent
    bad = re.compile(r"import jax|from jax|flax|apex_tpu\.")
    hits = []
    for path in pkg.rglob("*.py"):
        for m in bad.finditer(path.read_text()):
            hits.append(f"{path.relative_to(pkg)}: {m.group(0).strip()}")
    assert not hits, hits
