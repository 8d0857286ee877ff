"""The port's throughput harness (bigdl_tpu_torch.models.utils.perf)
against the JAX package's: one fused harness step — the body to the
final LayerNorm, then the fused LM head + CE — held against the JAX
harness's loss function (``bigdl_tpu/models/utils/perf.py:115-137``) with
the Pallas kernel in interpret mode, then the harness mains on the CPU.

The step runs at f32 (the default policy on both sides), d_model 128 (one
head of 128: the port's attention takes the flash path, its plain
versions on the CPU), 2 layers, batch 2 x 64, vocab 256, with the JAX
model's weights moved across (``load_jax_params``). The two differ only
in the order of sums: 1e-5 on the loss, 1e-4 on the gradients and on
the parameters after one SGD(0.01) update (as the LM tests of
``test_torch_train.py`` hold them). The conv path (``-m inception_v1``)
is held against the JAX package in ``test_torch_inception.py``; here it
runs as a main on the CPU, with its analytic FLOP count.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.models import TransformerLM as JaxLM
from bigdl_tpu.ops.pallas.fused_ce import linear_cross_entropy as jce
from bigdl_tpu.optim import SGD as JSGD
from bigdl_tpu_torch.interop import load_jax_params, params_from_jax
from bigdl_tpu_torch.models import TransformerLM
from bigdl_tpu_torch.models.utils import perf
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.ops import fused_ce as tce
from bigdl_tpu_torch.ops import lrn as tlrn
from bigdl_tpu_torch.ops import maxpool as tmp
from bigdl_tpu_torch.optim import SGD
from bigdl_tpu_torch.tensor import get_policy, policy_scope

_VOCAB, _D, _LAYERS, _B, _S = 256, 128, 2, 2, 64


def _jax_fused_step(model, params, mstate, opt_state, optim, data, labels):
    """``perf.py``'s transformer step with ``fused`` on and the kernel in
    interpret mode (the JAX harness turns it on only on a TPU)."""
    head_idx = str(len(model.modules) - 1)

    def loss_fn(p):
        x, new_mstate = data, dict(mstate)
        for i, m in enumerate(model.modules[:-1]):
            x, new_mstate[str(i)] = m.apply(p[str(i)], mstate[str(i)], x,
                                            training=True)
        loss = jce(x.reshape(-1, x.shape[-1]),
                   p[head_idx]["weight"].astype(x.dtype),
                   p[head_idx].get("bias"), labels.reshape(-1),
                   use_kernel=True, interpret=True)
        return loss, new_mstate

    (loss, _), g = jax.value_and_grad(loss_fn, has_aux=True)(params)
    p2, _ = optim.update(g, params, opt_state)
    return loss, g, p2


def _close(got, want, tol, what):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol, err_msg=what)


def test_fused_harness_step_matches_jax():
    jm = JaxLM(_VOCAB, d_model=_D, num_heads=_D // 128, num_layers=_LAYERS,
               max_len=_S, with_log_softmax=False)
    jm.materialize(jax.random.PRNGKey(0))
    jm.training()
    host = np.random.default_rng(0)
    data = host.integers(1, _VOCAB + 1, size=(_B, _S))
    labels = host.integers(1, _VOCAB + 1, size=(_B, _S))
    joptim = JSGD(learning_rate=0.01)
    jloss, jg, jp2 = _jax_fused_step(
        jm, jm.params, jm.state, joptim.init_state(jm.params), joptim,
        jnp.asarray(data), jnp.asarray(labels))

    tm = TransformerLM(_VOCAB, d_model=_D, num_heads=_D // 128,
                       num_layers=_LAYERS, max_len=_S,
                       with_log_softmax=False, device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, jm.params))
    tm.train()
    td, tl = torch.as_tensor(data), torch.as_tensor(labels)
    fwd, criterion = perf.body_and_loss(tm, fused=True)
    named = dict(tm.named_parameters())
    loss = criterion(fwd(td), tl)
    grads = torch.autograd.grad(loss, list(named.values()))
    _close(loss, jloss, 1e-5, "loss")
    want = params_from_jax(jax.tree.map(np.asarray, jg))
    assert set(want) == set(named)
    for name, g in zip(named, grads):
        _close(g, want[name], 1e-4, f"grad {name}")

    sgd = SGD(learning_rate=0.01)
    step = perf.make_step(tm, sgd, fused=True)
    state, sloss = step(sgd.init_state(named), td, tl, 1)
    _close(sloss, jloss, 1e-5, "step loss")
    assert state["neval"] == 1
    want = params_from_jax(jax.tree.map(np.asarray, jp2))
    for name, p in tm.named_parameters():
        _close(p, want[name], 1e-4, f"updated {name}")


def test_body_stops_before_the_head():
    """The fused step's body gives the final LayerNorm's output: the LM
    head applied to it is the model's output."""
    tm = TransformerLM(64, d_model=32, num_heads=2, num_layers=1,
                       max_len=8, with_log_softmax=False, device="cpu")
    x = torch.as_tensor(np.random.default_rng(1).integers(1, 65, (2, 8)))
    body, _ = perf.body_and_loss(tm, fused=True)
    hidden = body(x)
    assert hidden.shape == (2, 8, 32)
    torch.testing.assert_close(tm[3](hidden), tm(x))


def test_transformer_and_attention_mains_on_the_cpu():
    """Tiny ``-m transformer`` (the unfused path, as off the card) and
    ``-m attention`` runs with ``--device cpu``: finite losses near ln V
    at the start, the analytic FLOP count of ``bench.py``, no fused-CE
    launches."""
    before = (tce.fwd_launches, tce.dh_launches, tce.dw_launches)
    out = perf.main(["-m", "transformer", "-b", "2", "--seqLen", "32",
                     "--classNum", "256", "--dModel", "128",
                     "--numLayers", "1", "--warmUp", "1", "-i", "2",
                     "--dataType", "f32", "--device", "cpu"])
    assert out["fused"] is False and out["peak_bytes"] is None
    assert abs(out["first_loss"] - np.log(256)) < 0.5
    assert np.isfinite(out["final_loss"]) and out["tokens_per_s"] > 0
    flops = perf.step_flops(out["model"], 256, 128, 1, 2, 32)
    # one block: q, k, v, o (4·128²) and the FFN (8·128²) + the head
    p_matmul = 12 * 128 ** 2 + 256 * 128
    assert flops["dense"] == 6 * p_matmul * 64 + 12 * 32 * 128 * 64
    assert (tce.fwd_launches, tce.dh_launches, tce.dw_launches) == before
    att = perf.main(["-m", "attention", "-b", "1", "--seqLen", "64",
                     "--heads", "2", "--headDim", "64", "--warmUp", "1",
                     "-i", "1", "--dataType", "f32", "--device", "cpu"])
    assert att["flash"] > 0 and att["plain"] > 0


# each refusal names its ROADMAP.md queue A item (the ids keep the step
# numbers the messages cited before the queue was renumbered)
@pytest.mark.parametrize("module,item", [
    pytest.param("decode", "Serving depth", id="decode-3"),
    pytest.param("lenet5", "The conv zoo in the harness", id="lenet5-2"),
    pytest.param("inception_v2", "The conv zoo in the harness",
                 id="inception_v2-2"),
    pytest.param("vgg16", "The conv zoo in the harness", id="vgg16-5")])
def test_unported_modes_are_refused(module, item):
    with pytest.raises(NotImplementedError, match=f"queue A, {item}"):
        perf.main(["-m", module, "--device", "cpu"])


def test_flop_hooks_count_forward_dx_and_dw():
    """2 FLOPs a multiply-add, x3 for a training step, x2 for a conv that
    computes no dx."""
    m = tnn.Sequential(
        tnn.SpatialConvolution(3, 4, 3, 3, propagate_back=False,
                               device="cpu"),
        tnn.View(4 * 3 * 3), tnn.Linear(36, 5, device="cpu"))
    handles, total = perf._flop_hooks(m)
    m(torch.zeros(2, 3, 5, 5))
    for h in handles:
        h.remove()
    conv_macs = 2 * 4 * 3 * 3 * (3 * 3 * 3)
    assert total[0] == 2 * conv_macs * 2 + 2 * (2 * 5 * 36) * 3


def test_inception_main_on_the_cpu():
    """``-m inception_v1`` at batch 1 under the bf16 policy on the CPU:
    a finite first loss near ln 10, Inception-v1's training FLOPs (about
    3 x 2 x 1.5 G multiply-adds an image), no kernel launches."""
    before = (tlrn.fwd_launches, tlrn.bwd_launches, tmp.bwd_launches)
    with policy_scope(get_policy()):
        out = perf.main(["-m", "inception_v1", "-b", "1", "-i", "1",
                         "--warmUp", "1", "--classNum", "10", "--device",
                         "cpu"])
    assert out["peak_bytes"] is None and out["records_per_s"] > 0
    assert abs(out["first_loss"] - np.log(10)) < 0.5
    assert np.isfinite(out["final_loss"])
    assert 8e9 < out["step_flops"] < 1e10
    assert (tlrn.fwd_launches, tlrn.bwd_launches,
            tmp.bwd_launches) == before
