"""BERT pretraining with FusedLAMB (NVLAMB), apex_tpu_torch against
apex_tpu.

A tiny BERT (vocab 128, hidden 64, 2 layers, 4 heads, seq 32, batch 3
with padded tails, tokentypes, a 30% MLM loss mask over the real tokens
and NSP labels) trains in the reference as ``bench.py`` composes its
BERT-Large step — ``jax.grad`` of ``bert_loss_fn`` over the model's
apply, then ``FusedLAMB(lr=2e-3, weight_decay=0.01, max_grad_norm=1.0,
use_nvlamb=True, impl="xla").step`` — for one step, on parameters built
with ``scan_layers=False`` (stacked layers would share one trust ratio
per kind of layer parameter; the port has one per layer parameter). Its
weights and LAMB state are converted into the port (``load_jax_params``,
``load_jax_opt_state``), and both take the same three further steps,
the port through ``PretrainStep(model, FusedLAMB(...), loss_fn=...)``
(its default segmented layout). The losses are compared at each step,
and every parameter, m and v after the third, per parameter name.

Tolerances, as ``test_torch_pretrain_lamb.py`` states them for GPT.
fp32: losses within 2e-6; m, v and the parameters within 1e-5 of each
leaf's largest |value|, except the key bias (an exactly-zero true
gradient, whose rounding noise LAMB normalises to steps of up to ~lr):
within 6 lr. bf16 compute: losses within 1e-3; m and v within 10% of
each leaf's largest |value|; the parameters all within 6 lr, their mean
difference within lr / 20 and at most 1% of them more than lr / 4 apart.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from apex_tpu.models.bert import BertConfig as RefConfig
from apex_tpu.models.bert import BertModel as RefModel
from apex_tpu.models.bert import bert_loss_fn as ref_loss
from apex_tpu.optimizers import FusedLAMB as RefLAMB

from apex_tpu_torch.models import (
    BertConfig,
    BertModel,
    PretrainStep,
    bert_loss_fn,
    bert_params_from_jax,
    load_jax_opt_state,
    load_jax_params,
)
from apex_tpu_torch.optimizers import FusedLAMB

VOCAB, SEQ, HID, LAYERS, HEADS, BATCH = 128, 32, 64, 2, 4, 3
LENS = (32, 20, 9)
LR = 2e-3
LOSS_ATOL = {"fp32": 2e-6, "bf16": 1e-3}
MV_REL = {"fp32": 1e-5, "bf16": 0.1}
PARAM_REL_FP32 = 1e-5
LAMB_KW = dict(lr=LR, weight_decay=0.01, max_grad_norm=1.0, use_nvlamb=True)


def _configs(dt):
    jdt, tdt = {"fp32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dt]
    shape = dict(vocab_size=VOCAB, max_seq_len=SEQ, hidden_size=HID,
                 num_layers=LAYERS, num_heads=HEADS)
    return (RefConfig(dtype=jdt, scan_layers=False, softmax_impl="xla",
                      **shape),
            BertConfig(dtype=tdt, **shape))


def _batches(n, seed=0):
    """n batches of (tokens, keep, tokentypes, labels, loss_mask, nsp)."""
    rng = np.random.RandomState(seed)
    keep = np.arange(SEQ)[None, :] < np.asarray(LENS)[:, None]
    tt = keep & (np.arange(SEQ)[None, :] >= np.asarray(LENS)[:, None] // 2)
    out = []
    for _ in range(n):
        out.append((rng.randint(0, VOCAB, (BATCH, SEQ)).astype(np.int32),
                    keep.astype(np.int32), tt.astype(np.int32),
                    rng.randint(0, VOCAB, (BATCH, SEQ)).astype(np.int32),
                    (keep & (rng.rand(BATCH, SEQ) < 0.3)).astype(np.float32),
                    rng.randint(0, 2, (BATCH,)).astype(np.int32)))
    return out


def _port_loss(model, tokens, keep, tt, labels, loss_mask, nsp):
    return bert_loss_fn(*model(tokens, keep, tt), labels, loss_mask, nsp)


def _unpack(state, buf):
    return jax.tree_util.tree_map(
        np.asarray, state.space.unpack(buf, dtype="buffer"))


def _key_bias():
    mask = torch.zeros(HEADS, 3, HID // HEADS, dtype=torch.bool)
    mask[:, 1] = True
    return mask.reshape(-1)


@pytest.fixture(scope="module", params=["fp32", "bf16"])
def trained(request):
    dt = request.param
    rcfg, cfg = _configs(dt)
    rmodel = RefModel(rcfg)
    batches = _batches(4)
    params = rmodel.init(jax.random.PRNGKey(0), jnp.asarray(batches[0][0]),
                         jnp.asarray(batches[0][1]))
    ropt = RefLAMB(impl="xla", **LAMB_KW)
    rs = ropt.init(params)

    @jax.jit
    def ref_step(state, tokens, keep, tt, labels, loss_mask, nsp):
        def loss_of(p):
            lm, binary = rmodel.apply(p, tokens, keep, tt)
            return ref_loss(lm, binary, labels, loss_mask, nsp)
        loss, grads = jax.value_and_grad(loss_of)(
            state.space.unpack(state.master))
        _, state = ropt.step(state, grads)
        return state, loss

    rs, _ = ref_step(rs, *batches[0])
    model = load_jax_params(BertModel(cfg, device="cpu"),
                            _unpack(rs, rs.master))
    step = PretrainStep(model, FusedLAMB(**LAMB_KW), loss_fn=_port_loss)
    ps = step.init()
    assert ps.seg_meta is not None
    ps = load_jax_opt_state(ps, cfg, {
        "master": _unpack(rs, rs.master), "m": _unpack(rs, rs.slots["m"]),
        "v": _unpack(rs, rs.slots["v"]), "count": int(rs.count)})
    losses = []
    for b in batches[1:]:
        rs, rl = ref_step(rs, *b)
        ps, pl = step(ps, *b)
        losses.append((float(rl), float(pl)))
    return dt, cfg, rs, ps, model, losses


def test_bert_lamb_losses_match_each_step(trained):
    dt, _, _, _, _, losses = trained
    for want, got in losses:
        assert np.isfinite(got)
        assert abs(got - want) <= LOSS_ATOL[dt], losses


def test_bert_lamb_state_matches_after_three_steps(trained):
    dt, cfg, rs, ps, _, _ = trained
    assert ps.count == int(rs.count) == 4
    key = _key_bias()
    for name, rbuf, pbuf in (("master", rs.master, ps.master),
                             ("m", rs.slots["m"], ps.slots["m"]),
                             ("v", rs.slots["v"], ps.slots["v"])):
        want = bert_params_from_jax(_unpack(rs, rbuf), cfg)
        got = ps.space.unpack(pbuf, "buffer")
        assert set(got) == set(want)
        diffs = []
        for leaf, w in want.items():
            diff = (got[leaf] - w).abs()
            diffs.append(diff.reshape(-1))
            if name == "master" and dt == "bf16":
                continue                     # held as a whole below
            if leaf.endswith("qkv.bias"):
                if name == "master":
                    assert float(diff[key].max()) <= 6 * LR, leaf
                diff, w = diff[~key], w[~key]
            rel = MV_REL[dt] if name != "master" else PARAM_REL_FP32
            assert float(diff.max()) <= rel * float(w.abs().max()), (
                name, leaf, float(diff.max()))
        if name == "master" and dt == "bf16":
            d = torch.cat(diffs)
            assert float(d.max()) <= 6 * LR
            assert float(d.mean()) <= LR / 20
            assert float((d > LR / 4).float().mean()) <= 0.01


def test_bert_model_is_bound_to_the_master(trained):
    _, _, _, ps, model, _ = trained
    views = ps.space.unpack(ps.master, "buffer")
    for name, p in model.named_parameters():
        assert p.data_ptr() == views[name].data_ptr()


def test_bert_loss_falls_on_one_batch_under_both_backends():
    for backend in ("softmax", "flash"):
        cfg = BertConfig(vocab_size=VOCAB, max_seq_len=SEQ, hidden_size=HID,
                         num_layers=LAYERS, num_heads=HEADS,
                         dtype=torch.float32, attention_backend=backend)
        model = BertModel(cfg, device="cpu",
                          generator=torch.Generator().manual_seed(0))
        step = PretrainStep(model, FusedLAMB(lr=1e-2, weight_decay=0.01,
                                             use_nvlamb=True),
                            loss_fn=_port_loss)
        state = step.init()
        b = _batches(1, seed=3)[0]
        losses = []
        for _ in range(5):
            state, loss = step(state, *b)
            losses.append(float(loss))
        assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
