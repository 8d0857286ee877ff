"""The port's training path against the JAX package: CrossEntropyCriterion,
SGD, the LM's full-sequence forward and loss gradient, three steps of
LocalOptimizer, and the train main.

Everything runs at f32 (the default policy on both sides) with the same
inputs made by numpy and the JAX model's weights moved across
(``load_jax_params``), so the two differ only in the order of sums.
Tolerances: 1e-5 for the criterion and SGD (elementwise math), 1e-4 for
logits, losses, gradients and trained parameters of the small LMs (sums
over up to 64 columns through two blocks).
"""
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu import optim as joptim
from bigdl_tpu.dataset.dataset import LocalArrayDataSet as JDataSet
from bigdl_tpu.dataset.sample import Sample as JSample
from bigdl_tpu.dataset.transformer import SampleToBatch as JToBatch
from bigdl_tpu.models import TransformerLM as JaxLM
from bigdl_tpu.models.utils.text_lm import build_text_lm_datasets
from bigdl_tpu.observability.summary import TrainSummary
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch import optim as toptim
from bigdl_tpu_torch.dataset import LocalArrayDataSet as TDataSet
from bigdl_tpu_torch.dataset import Sample as TSample
from bigdl_tpu_torch.dataset import SampleToBatch as TToBatch
from bigdl_tpu_torch.interop import (load_jax_params, params_from_jax,
                                     sgd_state_from_jax)
from bigdl_tpu_torch.models import TransformerLM
from bigdl_tpu_torch.ops import flash_attention as tfa
from bigdl_tpu_torch.utils.random import RandomGenerator as TRandom

ttrain = importlib.import_module("bigdl_tpu_torch.models.transformer.train")


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol,
                               err_msg=what)


# ---------------------------------------------------------------- criterion

@pytest.mark.parametrize("weights,smoothing,size_average", [
    (False, 0.0, True), (True, 0.0, True), (False, 0.1, True),
    (True, 0.2, True), (True, 0.0, False), (False, 0.1, False)],
    ids=["plain", "weights", "smooth", "weights-smooth", "weights-sum",
         "smooth-sum"])
def test_cross_entropy_matches_jax(weights, smoothing, size_average):
    """Loss and its gradient w.r.t. (B, S, V) logits, 1-based targets."""
    rs = np.random.default_rng(0)
    x = rs.standard_normal((2, 5, 11), np.float32) * 3
    t = rs.integers(1, 12, size=(2, 5)).astype(np.float32)
    w = rs.uniform(0.5, 2.0, size=11).astype(np.float32) if weights \
        else None
    jc = jnn.CrossEntropyCriterion(w, size_average, smoothing)
    tc = tnn.CrossEntropyCriterion(w, size_average, smoothing)
    jl, jg = jax.value_and_grad(lambda a: jc.apply(a, jnp.asarray(t)))(
        jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    tl = tc(tx, torch.from_numpy(t))
    tl.backward()
    _close(tl, jl, 1e-5, "loss")
    _close(tx.grad, jg, 1e-5, "grad")
    assert repr(tc.clone_criterion()) == "CrossEntropyCriterion()"


def test_cross_entropy_rejects_bad_smoothing():
    with pytest.raises(ValueError, match="label_smoothing"):
        tnn.CrossEntropyCriterion(label_smoothing=1.0)


# ---------------------------------------------------------------- SGD

_SGD_CASES = {
    "decay": dict(learning_rate=0.1, learning_rate_decay=0.01),
    "momentum": dict(learning_rate=0.05, momentum=0.9),
    "dampening": dict(learning_rate=0.05, momentum=0.9, dampening=0.3,
                      weight_decay=1e-2),
    "nesterov": dict(learning_rate=0.05, momentum=0.9, dampening=0.0,
                     nesterov=True, learning_rate_decay=0.1),
    "step": dict(learning_rate=0.1, learning_rate_schedule="step"),
    "warmup": dict(learning_rate=0.1, learning_rate_decay=0.05,
                   learning_rate_schedule="warmup"),
}


def _schedule(mod, name):
    return {"step": lambda: mod.Step(2, 0.5),
            "warmup": lambda: mod.Warmup(2)}[name]()


@pytest.mark.parametrize("case", sorted(_SGD_CASES))
def test_sgd_matches_jax_leaf_by_leaf(case):
    """Four updates of a small parameter tree from the same gradients;
    every leaf and every velocity leaf after every step. The port then
    resumes from JAX's state after step 2 (``sgd_state_from_jax``)."""
    kw = dict(_SGD_CASES[case])
    jkw, tkw = dict(kw), dict(kw)
    if "learning_rate_schedule" in kw:
        jkw["learning_rate_schedule"] = _schedule(joptim, kw[
            "learning_rate_schedule"])
        tkw["learning_rate_schedule"] = _schedule(toptim, kw[
            "learning_rate_schedule"])
    jsgd, tsgd = joptim.SGD(**jkw), toptim.SGD(**tkw)
    rs = np.random.default_rng(1)
    tree = {"a": {"w": rs.standard_normal((3, 4), np.float32)},
            "b": rs.standard_normal((5,), np.float32)}
    jp = jax.tree.map(jnp.asarray, tree)
    tp = params_from_jax(tree)
    jstate, tstate = jsgd.init_state(jp), tsgd.init_state(tp)
    grads, saved = [], None
    for step in range(4):
        g = jax.tree.map(
            lambda a: rs.standard_normal(a.shape, np.float32), tree)
        grads.append(g)
        epoch = 1 + step // 2
        jp, jstate = jsgd.update(jax.tree.map(jnp.asarray, g), jp,
                                 dict(jstate, epoch=epoch))
        tstate = tsgd.update(params_from_jax(g), tp,
                             dict(tstate, epoch=epoch))
        if step == 1:
            saved = (jax.tree.map(np.asarray, jstate),
                     params_from_jax(jax.tree.map(np.asarray, jp)))
        assert tstate["neval"] == int(jstate["neval"])
        for name, val in params_from_jax(jax.tree.map(np.asarray,
                                                      jp)).items():
            _close(tp[name], val, 1e-5, f"step {step} {name}")
        if "velocity" in jstate:
            for name, val in params_from_jax(jax.tree.map(
                    np.asarray, jstate["velocity"])).items():
                _close(tstate["velocity"][name], val, 1e-5, name)
    # resume the port from JAX's state after step 2: the last two steps
    # land on JAX's final parameters
    rstate, rp = sgd_state_from_jax(saved[0]), saved[1]
    assert rstate["neval"] == 2 and set(rstate) == set(tstate)
    for step in (2, 3):
        rstate = tsgd.update(params_from_jax(grads[step]), rp,
                             dict(rstate, epoch=2))
    for name, val in params_from_jax(jax.tree.map(np.asarray, jp)).items():
        _close(rp[name], val, 1e-5, f"resumed {name}")


def test_sgd_refuses_bad_nesterov_and_partial_hypers():
    with pytest.raises(ValueError, match="Nesterov"):
        toptim.SGD(momentum=0.9, nesterov=True)
    sgd = toptim.SGD(learning_rates={"a": 1.0})
    p = {"a": torch.zeros(2), "b": torch.zeros(2)}
    with pytest.raises(ValueError, match="every"):
        sgd.update({"a": torch.ones(2), "b": torch.ones(2)}, p,
                   sgd.init_state(p))


# ---------------------------------------------------------------- the LM

_LM_CASES = {
    # head dim 16: the attention core takes its plain path
    "learned-kv4": dict(d_model=64, num_heads=4, num_kv_heads=4,
                        pos_encoding="learned"),
    "rope-kv2": dict(d_model=64, num_heads=4, num_kv_heads=2,
                     pos_encoding="rope"),
    # head dim 64: the flash path (plain kernel versions on the CPU)
    "rope-kv1-flash": dict(d_model=128, num_heads=2, num_kv_heads=1,
                           pos_encoding="rope"),
}


def _lm_pair(vocab=96, max_len=32, **kw):
    jm = JaxLM(vocab, num_layers=2, max_len=max_len, with_log_softmax=False,
               **kw)
    jm.materialize(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jm.params)
    tm = TransformerLM(vocab, num_layers=2, max_len=max_len,
                       with_log_softmax=False, device="cpu", **kw)
    load_jax_params(tm, tree)
    return jm, tm


@pytest.mark.parametrize("case", sorted(_LM_CASES))
def test_lm_forward_and_loss_gradient_match_jax(case):
    """Full-sequence logits, the CE loss and its gradient for every
    parameter; the explicit ``flash=False`` forward agrees too."""
    jm, tm = _lm_pair(**_LM_CASES[case])
    rs = np.random.default_rng(2)
    x = rs.integers(1, 97, size=(2, 24)).astype(np.int32)
    t = rs.integers(1, 97, size=(2, 24)).astype(np.float32)
    crit = jnn.CrossEntropyCriterion()

    def jloss(p):
        y, _ = jm.apply(p, jm.state, jnp.asarray(x), training=True)
        return crit.apply(y, jnp.asarray(t)), y

    (jl, jy), jg = jax.value_and_grad(jloss, has_aux=True)(jm.params)
    ty = tm(torch.from_numpy(x))
    tl = tnn.CrossEntropyCriterion()(ty, torch.from_numpy(t))
    tl.backward()
    _close(ty, jy, 1e-4, "logits")
    _close(tl, jl, 1e-5, "loss")
    want = params_from_jax(jax.tree.map(np.asarray, jg))
    for name, p in tm.named_parameters():
        _close(p.grad, want[name], 1e-4, name)
    with torch.no_grad():
        _close(tm(torch.from_numpy(x), flash=False), jy, 1e-4,
               "flash=False logits")


def test_lm_dropout_is_refused():
    """An LM with dropout > 0 refuses to train until the caller sets the
    masks' generator. It builds: ``nn.Dropout`` ends every FFN, at the
    JAX block's position, and evaluation is the identity."""
    tm = TransformerLM(32, d_model=16, num_heads=2, num_layers=1,
                       dropout=0.1, device="cpu")
    jm = JaxLM(32, d_model=16, num_heads=2, num_layers=1, dropout=0.1)
    ffn, jffn = tm[1][1][1], jm.modules[1].modules[1].modules[1]
    assert [type(m).__name__ for m in ffn._modules.values()] == \
        [type(m).__name__ for m in jffn.modules]
    assert isinstance(ffn[3], tnn.Dropout) and ffn[3].p == 0.1
    x = torch.ones((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="generator"):
        tm(x)
    tm.evaluate()
    assert torch.isfinite(tm(x)).all()


def test_lm_dropout_p0_matches_jax():
    """An LM built with dropout, its Dropout modules at p = 0, in
    training mode: logits, loss and every gradient as JAX's."""
    jm, tm = _lm_pair(dropout=0.2, **_LM_CASES["rope-kv2"])
    for m in tm.modules():
        if isinstance(m, tnn.Dropout):
            m.set_p(0.0)
    n = 0
    for blk in jm.modules[1:3]:
        blk.modules[1].modules[1].modules[3].set_p(0.0)
        n += 1
    assert n == 2
    rs = np.random.default_rng(6)
    x = rs.integers(1, 97, size=(2, 16)).astype(np.int32)
    t = rs.integers(1, 97, size=(2, 16)).astype(np.float32)
    crit = jnn.CrossEntropyCriterion()

    def jloss(p):
        y, _ = jm.apply(p, jm.state, jnp.asarray(x), training=True,
                        rng=jax.random.PRNGKey(1))
        return crit.apply(y, jnp.asarray(t)), y

    (jl, jy), jg = jax.value_and_grad(jloss, has_aux=True)(jm.params)
    tm.train()
    ty = tm(torch.from_numpy(x))
    tl = tnn.CrossEntropyCriterion()(ty, torch.from_numpy(t))
    tl.backward()
    _close(ty, jy, 1e-4, "logits")
    _close(tl, jl, 1e-5, "loss")
    want = params_from_jax(jax.tree.map(np.asarray, jg))
    for name, p in tm.named_parameters():
        _close(p.grad, want[name], 1e-4, name)


def test_lm_dropout_statistics():
    """At p = 0.25 each FFN's Dropout zeroes about a quarter of its input
    (16 x 64 x 64 draws: 5 standard deviations is 0.009) and scales the
    rest by 1/0.75; a reseeded generator repeats the masks, and the loss
    moves against p = 0."""
    tm = TransformerLM(64, d_model=64, num_heads=4, num_layers=2,
                       max_len=64, dropout=0.25, with_log_softmax=False,
                       device="cpu",
                       generator=torch.Generator().manual_seed(0))
    drops = [m for m in tm.modules() if isinstance(m, tnn.Dropout)]
    assert len(drops) == 2
    seen = []

    def hook(mod, inp, out):
        seen.append((inp[0].detach(), out.detach()))
    for m in drops:
        m.register_forward_hook(hook)
    x = torch.from_numpy(np.random.default_rng(7).integers(
        1, 65, size=(16, 64)).astype(np.int32))

    def run(seed):
        gen = torch.Generator().manual_seed(seed)
        for m in drops:
            m.generator = gen
        seen.clear()
        with torch.no_grad():
            return tm(x), list(seen)
    y1, s1 = run(3)
    y2, s2 = run(3)
    assert torch.equal(y1, y2)
    for (i1, o1), (_, o2) in zip(s1, s2):
        assert torch.equal(o1, o2)
        live = i1 != 0
        dropped = float((o1[live] == 0).float().mean())
        assert abs(dropped - 0.25) < 0.009
        kept = o1 != 0
        torch.testing.assert_close(o1[kept], i1[kept] / 0.75)
    for m in drops:
        m.set_p(0.0)
    with torch.no_grad():
        y0 = tm(x)
    assert not torch.allclose(y0, y1)


def _lm_batches(n, seq, vocab, seed):
    rs = np.random.default_rng(seed)
    feats = rs.integers(1, vocab + 1, size=(n, seq)).astype(np.int32)
    labels = rs.integers(1, vocab + 1, size=(n, seq)).astype(np.float32)
    return feats, labels


def test_local_optimizer_three_steps_match_jax(tmp_path):
    """Three SGD-with-momentum steps of JAX's LocalOptimizer and the
    port's on the same LocalArrayDataSet batches (2 steps per epoch, so
    step 3 comes after the epoch-end shuffle of both MT19937 streams):
    every loss and every trained parameter."""
    jm, tm = _lm_pair(**_LM_CASES["rope-kv1-flash"])
    feats, labels = _lm_batches(4, 16, 96, seed=3)
    jset = JDataSet([JSample(f, l) for f, l in zip(feats, labels)]) \
        >> JToBatch(2)
    tset = TDataSet([TSample(f, l) for f, l in zip(feats, labels)]) \
        >> TToBatch(2)
    TRandom.set_seed(1)     # the JAX stream is seeded to 1 by conftest
    summary = TrainSummary(str(tmp_path), "lm")
    jo = joptim.Optimizer(jm, jset, jnn.CrossEntropyCriterion())
    jo.set_optim_method(joptim.SGD(learning_rate=0.1, momentum=0.9))
    jo.set_end_when(joptim.max_iteration(3)).set_train_summary(summary)
    jo.optimize()
    to = toptim.Optimizer(tm, tset, tnn.CrossEntropyCriterion())
    assert isinstance(to, toptim.LocalOptimizer)
    to.set_optim_method(toptim.SGD(learning_rate=0.1, momentum=0.9))
    to.set_end_when(toptim.max_iteration(3))
    to.optimize()
    jlosses = [v for _, _, v in summary.read_scalar("Loss")]
    assert [h["neval"] for h in to.history] == [1, 2, 3]
    assert [h["epoch"] for h in to.history] == [1, 1, 2]
    _close(np.asarray([h["loss"] for h in to.history]),
           np.asarray(jlosses), 1e-4, "losses")
    want = params_from_jax(jax.tree.map(np.asarray, jm.params))
    for name, p in tm.named_parameters():
        _close(p, want[name], 1e-4, name)
    assert to.opt_state["neval"] == 3


def test_optimizer_refuses_what_is_not_ported():
    _, tm = _lm_pair(**_LM_CASES["learned-kv4"])
    ds = TDataSet([]) >> TToBatch(2)
    with pytest.raises(NotImplementedError, match="distributed"):
        toptim.Optimizer(tm, ds, tnn.CrossEntropyCriterion(), mesh=object())
    o = toptim.Optimizer(tm, ds, tnn.CrossEntropyCriterion())
    for call in (lambda: o.set_checkpoint("/x", toptim.every_epoch()),
                 lambda: o.set_state({}), lambda: o.set_input_pipeline(2),
                 lambda: o.set_grad_accumulation(2),
                 lambda: o.set_aot_cache(None),
                 lambda: o.set_train_summary(None)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            call()


def test_validation_loss_is_the_row_weighted_mean():
    crit = tnn.CrossEntropyCriterion()
    rs = np.random.default_rng(4)
    outs = [torch.from_numpy(rs.standard_normal((n, 3, 7), np.float32))
            for n in (2, 1)]
    tgts = [rs.integers(1, 8, size=(n, 3)).astype(np.float32)
            for n in (2, 1)]
    loss = toptim.Loss(crit)
    r = loss(outs[0], tgts[0]) + loss(outs[1], tgts[1])
    want = (2 * float(crit(outs[0], torch.from_numpy(tgts[0])))
            + float(crit(outs[1], torch.from_numpy(tgts[1])))) / 3
    assert r.result()[1] == 3
    assert r.result()[0] == pytest.approx(want, rel=1e-6)


# ---------------------------------------------------------------- main

def _write_text(folder, n_sentences=10, words=30, vocab_words=50, seed=5):
    rs = np.random.default_rng(seed)
    lines = [" ".join(f"w{i}" for i in rs.integers(0, vocab_words,
                                                   size=words)) + "."
             for _ in range(n_sentences)]
    with open(os.path.join(folder, "input.txt"), "w") as f:
        f.write(" ".join(lines))


def test_train_main_on_the_cpu(tmp_path):
    """The port's train main end to end with ``--device cpu``: finite
    losses, one validation per epoch, and the dictionary JAX's pipeline
    builds from the same text."""
    data = tmp_path / "data"
    data.mkdir()
    _write_text(str(data))
    TRandom.set_seed(1)
    torch.manual_seed(0)
    opt = ttrain.main(["-f", str(data), "--vocabSize", "40", "--dModel",
                       "64", "--numHeads", "1", "--numLayers", "1",
                       "--seqLength", "16", "-b", "2", "-e", "2",
                       "--device", "cpu"])
    losses = [h["loss"] for h in opt.history]
    # 10 sentences -> 8 train samples -> 4 steps per epoch
    assert len(losses) == 8 and np.all(np.isfinite(losses))
    assert [n for n, _ in opt.validation_results] == [5, 9]
    port_dict = (data / "dictionary.txt").read_text()
    jdir = tmp_path / "jax_dict"
    _, _, vocab, jdict = build_text_lm_datasets(
        str(data), 40, 16, 2, one_hot=False, dictionary_dir=str(jdir))
    assert (jdir / "dictionary.txt").read_text() == port_dict
    assert vocab == 41
    assert opt.model[0].tok.shape == (41, 64)


def test_train_main_defaults_on_the_cpu(tmp_path):
    """The train main at its default model flags (--dModel 128
    --numHeads 4: head dim 32, which the flash kernels take) runs one
    step of the default batch of 32 on the CPU, through the flash
    kernels' plain versions (no launch counted); a --dropout run trains
    too."""
    data = tmp_path / "data"
    data.mkdir()
    _write_text(str(data), n_sentences=40)      # 32 train samples
    TRandom.set_seed(1)
    torch.manual_seed(0)
    before = (tfa.fwd_launches, tfa.dq_launches, tfa.dkdv_launches)
    opt = ttrain.main(["-f", str(data), "-e", "1", "--device", "cpu"])
    q = torch.empty((1, 8, 4, opt.model[1][0][1].head_dim))
    assert q.shape[-1] == 32 and tfa.flash_supported(q, q)
    assert len(opt.history) == 1 and np.isfinite(opt.history[0]["loss"])
    assert (tfa.fwd_launches, tfa.dq_launches, tfa.dkdv_launches) == before
    opt = ttrain.main(["-f", str(data), "-e", "1", "--dropout", "0.1",
                       "--numLayers", "1", "--device", "cpu"])
    assert isinstance(opt.model[1][1][1][3], tnn.Dropout)
    assert opt.model[1][1][1][3].generator is not None
    assert np.isfinite(opt.history[0]["loss"])


@pytest.mark.parametrize("d_model,heads", [(128, 1), (256, 1)],
                         ids=["d128", "d256"])
def test_train_main_one_wide_head_on_the_cpu(tmp_path, d_model, heads):
    """The train main's model flags at one head as wide as the model
    (``--dModel 128 --numHeads 1``: head dim 128; ``--dModel 256``: 256,
    the head width ``[train]`` runs on the card at ``--dModel 1024
    --numHeads 4``), one layer, one step on the CPU through the flash
    kernels' plain versions, which the flash kernels take on the card."""
    data = tmp_path / "data"
    data.mkdir()
    _write_text(str(data), n_sentences=40)
    TRandom.set_seed(1)
    torch.manual_seed(0)
    opt = ttrain.main(["-f", str(data), "-e", "1", "--dModel",
                       str(d_model), "--numHeads", str(heads),
                       "--numLayers", "1", "--seqLength", "32", "--device",
                       "cpu"])
    d = opt.model[1][0][1].head_dim
    assert d == d_model // heads
    q = torch.empty((1, 8, heads, d))
    assert tfa.flash_supported(q, q)
    assert len(opt.history) >= 1
    assert all(np.isfinite(h["loss"]) for h in opt.history)


@pytest.mark.parametrize("flags", [["--chips", "2"], ["--model", "m"],
                                   ["--sequenceParallel", "ring"]])
def test_train_main_refuses_what_is_not_ported(tmp_path, flags):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ttrain.main(["-f", str(tmp_path), "--device", "cpu", *flags])


def test_train_and_evaluate_set_torchs_plain_flag():
    """``Module.training`` is torch's plain bool on every submodule;
    ``evaluate()`` (the JAX name) and ``train()`` switch it and return the
    module."""
    tm = TransformerLM(32, d_model=16, num_heads=2, num_layers=1,
                       device="cpu")
    assert tm.training is True and tm[1][0][1].training is True
    assert tm.evaluate() is tm
    assert tm.training is False and tm[1][0][1].training is False
    assert tm.train() is tm
    assert tm.training is True and tm[2].training is True


def test_train_main_at_head_dim_16_matches_jax(tmp_path, monkeypatch):
    """The train main at ``--numHeads 8`` with its default ``--dModel
    128`` (head dim 16, which the card's flash kernels run zero-padded to
    32; here their plain versions behind the same padding), two layers,
    one step of the default batch of 32 on the CPU, from the JAX model's
    weights (``load_jax_params`` on the model the main builds): the
    step's loss against JAX's on the same batch (the 32 train samples
    JAX's pipeline builds from the same text, in one batch: the mean
    loss does not depend on their order) at 1e-5, and every trained
    parameter against JAX's SGD step (lr 0.02 at step 1) from JAX's
    gradient at 1e-5."""
    data = tmp_path / "data"
    data.mkdir()
    _write_text(str(data), n_sentences=40)      # 32 train samples
    from bigdl_tpu_torch import models as tmodels
    real, built = tmodels.TransformerLM, {}

    def build(vocab, **kw):
        jkw = {k: v for k, v in kw.items() if k != "device"}
        jm = JaxLM(vocab, **jkw)
        jm.materialize(jax.random.PRNGKey(3))
        model = real(vocab, **kw)
        load_jax_params(model, jax.tree.map(np.asarray, jm.params))
        built["jax"] = jm
        built["start"] = {n: p.detach().clone()
                          for n, p in model.named_parameters()}
        return model
    monkeypatch.setattr(tmodels, "TransformerLM", build)
    TRandom.set_seed(1)
    opt = ttrain.main(["-f", str(data), "-e", "1", "--numHeads", "8",
                       "--device", "cpu"])
    assert opt.model[1][0][1].head_dim == 16
    assert len(opt.history) == 1
    jm = built["jax"]
    jtrain, _, vocab, _ = build_text_lm_datasets(
        str(data), 4000, 128, 32, one_hot=False,
        dictionary_dir=str(tmp_path / "jax_dict"))
    batch = next(iter(jtrain.data(train=False)))
    assert np.asarray(batch.data).shape == (32, 128)
    crit = jnn.CrossEntropyCriterion()

    def jloss(p):
        y, _ = jm.apply(p, jm.state, jnp.asarray(batch.data), training=True)
        return crit.apply(y, jnp.asarray(batch.labels))

    jl, jg = jax.value_and_grad(jloss)(jm.params)
    _close(np.asarray(opt.history[0]["loss"]), np.asarray(jl), 1e-5, "loss")
    grads = params_from_jax(jax.tree.map(np.asarray, jg))
    for name, p in opt.model.named_parameters():
        want = built["start"][name] - 0.02 * grads[name]
        _close(p, want, 1e-5, name)
