"""Master-free bf16 pretraining with stochastic rounding (SR),
apex_tpu_torch against apex_tpu.

A tiny GPT (vocab 128, hidden 64, 2 layers, 4 heads, seq 32, batch 4)
with ``FusedAdam(lr=2e-3, weight_decay=0.01, master_dtype=bf16,
stochastic_rounding=True)`` and a tiny BERT (``test_torch_pretrain_bert``'s
shape and batches) with the same master under NVLAMB
(``FusedLAMB(lr=2e-3, weight_decay=0.01, max_grad_norm=1.0,
use_nvlamb=True)``) start from the same bf16 weights: the reference's
(``param_dtype=bf16``, ``scan_layers=False``, the tree cast to bf16 as
its bench casts it: its LayerNorms keep fp32 parameters) loaded into the
port through ``load_jax_params``, the port's model cast with
``.bfloat16()``. Both take three steps, the reference's optimizer with
``impl="interpret"`` (for GPT its ``make_gpt_pretrain_step``, for BERT
``jax.grad`` of ``bert_loss_fn`` then ``FusedLAMB.step``), the port
through ``make_gpt_pretrain_step`` / ``PretrainStep``. The losses are
compared at each step and the parameters per name after the first and
the third.

SR streams are keyed by the flat layout (threefry over the element's
index for Adam, murmur3 over it in the LAMB segment pass), and the
port's default layout is module order where the reference's is sorted
keys. The main runs therefore build the port's optimizer state over
the parameters in the reference's order (``opt.init`` of the reordered
mapping; ``PretrainStep`` binds the model to it), so both sides draw the
same bits for the same element; one run per model keeps the default
module order, where the draws are independent.

Tolerances, measured first on this CPU (measured values in brackets).
Losses: fp32 compute within 2e-6 [1e-6], bf16 compute within 1e-3 [6.7e-4]
(the existing pretraining tolerances). After the first step every
parameter element within one bf16 ulp of the reference's, except the
key bias (an exactly-zero true gradient, its rounding noise a step of up
to ~lr either way on each side: within 2 lr) and the elements whose
gradient the two frameworks round differently: under fp32 compute at
most 0.01% of the elements [1 of 110,336], under bf16 compute (its
gradients sum in bf16 on both sides, in other orders: the embedding's
scatter-add, the biases' reductions, the LayerNorms' dw and db) at most
1% [0.3%], each within 3 lr and one ulp [2.4 lr]. After the third step,
per parameter (the key bias left out): relative L2 distance under fp32
compute within 2e-3 [6.8e-4]; under bf16 compute within 0.03 for the
matrices and embeddings [0.0101] and 0.5 for the biases and LayerNorm
parameters [0.25: they start at zero or one and move ~lr a step, and a
noise-level gradient flips the sign of a step], every element within
6 lr and one ulp [3.6 lr]. The module-order runs: losses within 3e-3
[1.8e-3 for BERT: independent draws move every weight by up to an ulp],
every element within 6 lr and one ulp after the first step and three
after the third (each side's draw may round the other way each step:
final_norm's weights near 1 came out two ulps apart).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from apex_tpu.models.bert import BertConfig as RefBertConfig
from apex_tpu.models.bert import BertModel as RefBertModel
from apex_tpu.models.bert import bert_loss_fn as ref_bert_loss
from apex_tpu.models.gpt import GPTConfig as RefGPTConfig
from apex_tpu.models.pretrain import init_gpt_pretrain_params as ref_init
from apex_tpu.models.pretrain import make_gpt_pretrain_step as ref_make
from apex_tpu.optimizers import FusedAdam as RefAdam
from apex_tpu.optimizers import FusedLAMB as RefLAMB

from apex_tpu_torch.models import (
    BertConfig,
    BertModel,
    GPTConfig,
    GPTModel,
    PretrainStep,
    bert_loss_fn,
    bert_params_from_jax,
    gpt_params_from_jax,
    load_jax_params,
    make_gpt_pretrain_step,
)
from apex_tpu_torch.optimizers import (
    FusedAdagrad,
    FusedAdam,
    FusedLAMB,
    FusedLARS,
    FusedNovoGrad,
    FusedSGD,
)

VOCAB, SEQ, HID, LAYERS, HEADS = 128, 32, 64, 2, 4
GPT_BATCH, BERT_LENS = 4, (32, 20, 9)
LR = 2e-3
LOSS_ATOL = {"fp32": 2e-6, "bf16": 1e-3}
MODULE_LOSS_ATOL = 3e-3
STEP1_FRACTION = {"fp32": 1e-4, "bf16": 0.01}
REL_L2 = {"fp32": (2e-3, 2e-3), "bf16": (0.03, 0.5)}
SR = dict(master_dtype=torch.bfloat16, stochastic_rounding=True)
REF_SR = dict(master_dtype=jnp.bfloat16, stochastic_rounding=True)
LAMB_KW = dict(lr=LR, weight_decay=0.01, max_grad_norm=1.0, use_nvlamb=True,
               seg_elems=65536)
SHAPE = dict(vocab_size=VOCAB, max_seq_len=SEQ, hidden_size=HID,
             num_layers=LAYERS, num_heads=HEADS)
DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _bf16_tree(tree):
    return jax.tree.map(lambda leaf: leaf.astype(jnp.bfloat16), tree)


def _unpack(state, buf):
    return jax.tree_util.tree_map(
        np.asarray, state.space.unpack(buf, dtype="buffer"))


def _reference_order(params, convert, cfg):
    """The port's parameter names in the order of the reference's leaves:
    each reference leaf filled with its index, converted by name."""
    leaves, treedef = jax.tree.flatten(params)
    idx = convert(treedef.unflatten(
        [np.full(leaf.shape, i, np.float32) for i, leaf in
         enumerate(leaves)]), cfg)
    return sorted(idx, key=lambda name: float(idx[name].reshape(-1)[0]))


def _key_bias():
    mask = torch.zeros(HEADS, 3, HID // HEADS, dtype=torch.bool)
    mask[:, 1] = True
    return mask.reshape(-1)


def _gpt_batches(n, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        t = rng.randint(0, VOCAB, (GPT_BATCH, SEQ + 1)).astype(np.int32)
        out.append((t[:, :-1], t[:, 1:]))
    return out


def _bert_batches(n, seed=0):
    rng = np.random.RandomState(seed)
    b = len(BERT_LENS)
    keep = np.arange(SEQ)[None, :] < np.asarray(BERT_LENS)[:, None]
    tt = keep & (np.arange(SEQ)[None, :] >= np.asarray(BERT_LENS)[:, None]
                 // 2)
    return [(rng.randint(0, VOCAB, (b, SEQ)).astype(np.int32),
             keep.astype(np.int32), tt.astype(np.int32),
             rng.randint(0, VOCAB, (b, SEQ)).astype(np.int32),
             (keep & (rng.rand(b, SEQ) < 0.3)).astype(np.float32),
             rng.randint(0, 2, (b,)).astype(np.int32)) for _ in range(n)]


def _bert_loss(model, tokens, keep, tt, labels, loss_mask, nsp):
    return bert_loss_fn(*model(tokens, keep, tt), labels, loss_mask, nsp)


def _run_gpt(dt, aligned):
    jdt, tdt = DTYPES[dt]
    rcfg = RefGPTConfig(dtype=jdt, param_dtype=jnp.bfloat16,
                        scan_layers=False, **SHAPE)
    cfg = GPTConfig(dtype=tdt, param_dtype=torch.bfloat16, **SHAPE)
    params = _bf16_tree(ref_init(rcfg, jax.random.PRNGKey(0)))
    ref_step, rs = ref_make(rcfg, RefAdam(lr=LR, weight_decay=0.01,
                                          impl="interpret",
                                          **REF_SR))(params)
    model = load_jax_params(GPTModel(cfg, device="cpu").bfloat16(),
                            _unpack(rs, rs.master))
    step, ps = make_gpt_pretrain_step(
        cfg, FusedAdam(lr=LR, weight_decay=0.01, **SR))(model)
    if aligned:
        named = dict(model.named_parameters())
        ps = step.opt.init({n: named[n] for n in _reference_order(
            params, gpt_params_from_jax, cfg)})
        assert ps.space.offsets == rs.space.offsets
    return _steps(ref_step, rs, step, ps, _gpt_batches(3),
                  lambda s: gpt_params_from_jax(_unpack(s, s.master), cfg))


def _run_bert(dt, aligned):
    jdt, tdt = DTYPES[dt]
    rcfg = RefBertConfig(dtype=jdt, param_dtype=jnp.bfloat16,
                         scan_layers=False, softmax_impl="xla", **SHAPE)
    cfg = BertConfig(dtype=tdt, param_dtype=torch.bfloat16, **SHAPE)
    rmodel = RefBertModel(rcfg)
    batches = _bert_batches(3)
    params = _bf16_tree(rmodel.init(jax.random.PRNGKey(0),
                                    jnp.asarray(batches[0][0]),
                                    jnp.asarray(batches[0][1])))
    ropt = RefLAMB(impl="interpret", **LAMB_KW, **REF_SR)

    @jax.jit
    def ref_step(state, tokens, keep, tt, labels, loss_mask, nsp):
        def loss_of(p):
            lm, binary = rmodel.apply(p, tokens, keep, tt)
            return ref_bert_loss(lm, binary, labels, loss_mask, nsp)
        loss, grads = jax.value_and_grad(loss_of)(
            state.space.unpack(state.master))
        _, state = ropt.step(state, grads)
        return state, loss

    rs = ropt.init(params)
    model = load_jax_params(BertModel(cfg, device="cpu").bfloat16(),
                            _unpack(rs, rs.master))
    step = PretrainStep(model, FusedLAMB(**LAMB_KW, **SR),
                        loss_fn=_bert_loss)
    if aligned:
        named = dict(model.named_parameters())
        ps = step.opt.init({n: named[n] for n in _reference_order(
            params, bert_params_from_jax, cfg)})
        assert ps.space.offsets == rs.space.offsets
    else:
        ps = step.init()
    assert ps.seg_meta is not None
    return _steps(ref_step, rs, step, ps, batches,
                  lambda s: bert_params_from_jax(_unpack(s, s.master), cfg))


def _steps(ref_step, rs, step, ps, batches, ref_params):
    """Both sides' steps: the losses and, after each step, the reference's
    parameters by port name and the port's."""
    assert ps.master.dtype == torch.bfloat16
    losses, snaps = [], []
    for b in batches:
        rs, rl = ref_step(rs, *b)
        ps, pl = step(ps, *b)
        losses.append((float(rl), float(pl)))
        snaps.append((ref_params(rs), {k: v.clone() for k, v in
                                       ps.space.unpack(ps.master,
                                                       "buffer").items()}))
        assert ps.count == int(rs.count)
    return losses, snaps, step, ps


@pytest.fixture(scope="module", params=[
    ("gpt", "fp32", True), ("gpt", "bf16", True), ("gpt", "bf16", False),
    ("bert", "fp32", True), ("bert", "bf16", True), ("bert", "bf16", False)],
    ids=lambda p: f"{p[0]}-{p[1]}-{'aligned' if p[2] else 'module'}")
def trained(request):
    model, dt, aligned = request.param
    run = _run_gpt if model == "gpt" else _run_bert
    return (model, dt, aligned, *run(dt, aligned))


def _ulp(w: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp of each |w| (2^-7 of its power of two; the smallest
    normal's below it)."""
    a = w.float().abs().clamp_min(torch.finfo(torch.bfloat16).tiny)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def _diffs(want, got, skip_key):
    """Per leaf: |got - want|, want's ulp and a mask of the elements held
    (the key bias left out where ``skip_key``)."""
    key = _key_bias()
    for name, w in want.items():
        d = (got[name].float() - w.float()).abs().reshape(-1)
        keep = torch.ones_like(d, dtype=torch.bool)
        if skip_key and name.endswith("qkv.bias"):
            keep = ~key
        yield name, d, _ulp(w).reshape(-1), keep


def test_losses_match_each_step(trained):
    _, dt, aligned, losses, _, _, _ = trained
    for want, got in losses:
        assert np.isfinite(got)
        tol = LOSS_ATOL[dt] if aligned else MODULE_LOSS_ATOL
        assert abs(got - want) <= tol, losses


def test_parameters_after_the_first_step(trained):
    _, dt, aligned, _, snaps, _, _ = trained
    want, got = snaps[0]
    beyond, total = 0, 0
    for name, d, ulp, keep in _diffs(want, got, skip_key=True):
        if name.endswith("qkv.bias"):
            assert float(d[~keep].max()) <= 2 * LR, name
        out = (d > ulp) & keep
        beyond += int(out.sum())
        total += int(keep.sum())
        bound = (3 * LR if aligned else 6 * LR) + ulp
        assert (d[keep] <= bound[keep]).all(), name
    limit = STEP1_FRACTION[dt] if aligned else 2 * STEP1_FRACTION["bf16"]
    assert beyond <= limit * total, (beyond, total)


def test_parameters_after_three_steps(trained):
    _, dt, aligned, _, snaps, _, _ = trained
    want, got = snaps[-1]
    mat, other = REL_L2[dt]
    # independent draws (module order) may each round the other way once
    # a step: three ulps after three steps
    ulps = 1 if aligned else len(snaps)
    for name, d, ulp, keep in _diffs(want, got, skip_key=True):
        assert (d[keep] <= 6 * LR + ulps * ulp[keep]).all(), name
        if not aligned:
            continue
        w = want[name].float().reshape(-1)[keep]
        rel = float(torch.linalg.norm(d[keep])
                    / torch.linalg.norm(w).clamp_min(1e-30))
        is_matrix = want[name].ndim == 2
        assert rel <= (mat if is_matrix else other), (name, rel)


def test_model_is_bound_to_the_bf16_master(trained):
    _, _, _, _, _, step, ps = trained
    views = ps.space.unpack(ps.master, "buffer")
    for name, p in step.model.named_parameters():
        assert p.dtype == torch.bfloat16
        assert p.data_ptr() == views[name].data_ptr()
    assert step.grad.dtype == torch.bfloat16
    assert all(s.dtype == torch.float32 for s in ps.slots.values())


# -- the reference's convergence check (tests/test_optimizers.py:314) -------


@pytest.mark.parametrize("cls", [FusedAdam, FusedLAMB, FusedSGD,
                                 FusedNovoGrad, FusedAdagrad, FusedLARS])
def test_trains_close_to_fp32(cls):
    """bf16 + SR reaches a loss in the regime of the fp32-master run on a
    small regression, 80 steps from the same initial draw (the
    reference's ``test_trains_close_to_fp32``)."""
    rng = np.random.RandomState(0)
    W = torch.from_numpy((rng.randn(16, 16) * 0.7).astype(np.float32))
    X = torch.from_numpy(rng.randn(512, 16).astype(np.float32))
    Y = torch.tanh(X @ W)

    def loss_fn(pt):
        h = torch.tanh(X @ pt["w1"].float())
        return torch.mean((h @ pt["w2"].float() - Y) ** 2)

    init = {"w1": rng.randn(16, 32) * 0.3, "w2": rng.randn(32, 16) * 0.3}

    def train(dtype, **kw):
        params = {k: torch.from_numpy(v.astype(np.float32)).to(dtype)
                  for k, v in init.items()}
        opt = cls(lr=0.3 if cls is FusedSGD else 0.03, **kw)
        state = opt.init(params)
        for _ in range(80):
            leaves = {k: v.detach().requires_grad_(True)
                      for k, v in params.items()}
            loss = loss_fn(leaves)
            loss.backward()
            params, state = opt.step(state, {k: v.grad for k, v in
                                             leaves.items()})
        return float(loss.detach())

    l_fp32 = train(torch.float32)
    l_sr = train(torch.bfloat16, **SR)
    assert l_sr < max(3.0 * l_fp32, 5e-3), (l_sr, l_fp32)
