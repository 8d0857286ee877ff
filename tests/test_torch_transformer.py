"""The port's TransformerLM and decode helpers against the JAX package,
with the JAX model's weights moved across by ``params_from_jax``.

Everything runs at f32 (the default policy on both sides), where the two
differ only in the order of sums: tolerances are 1e-5 for single ops and
1e-4 for logits after two blocks.
"""
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu.models import TransformerLM as JaxLM
from bigdl_tpu.models.transformer import serving as jsv
from bigdl_tpu_torch.interop import load_jax_params, params_from_jax
from bigdl_tpu_torch.models import TransformerLM
from bigdl_tpu_torch.models.transformer import generate as tgen
from bigdl_tpu_torch.models.transformer import serving as tsv

# the JAX package's transformer __init__ re-exports a ``generate``
# function under the module's name
jgen = importlib.import_module("bigdl_tpu.models.transformer.generate")

_GEOM = dict(d_model=64, num_heads=4, num_layers=2, max_len=64,
             with_log_softmax=False)


def _models(kv=2, pos="rope"):
    jm = JaxLM(128, num_kv_heads=kv, pos_encoding=pos, **_GEOM)
    jm.materialize(jax.random.PRNGKey(0))
    jm.evaluate()
    tree = jax.tree.map(np.asarray, jm.params)
    tm = TransformerLM(128, num_kv_heads=kv, pos_encoding=pos,
                       device="cpu", generator=torch.Generator()
                       .manual_seed(0), **_GEOM)
    load_jax_params(tm, tree)
    return jm, tm, tree


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("pos", ["rope", "learned"])
def test_params_from_jax_round_trip(pos):
    """Every JAX leaf lands in exactly one torch parameter, with its
    shape and values; nothing in the torch model is left unmatched."""
    _, tm, tree = _models(pos=pos)
    leaves = dict(_leaves(tree))
    state = tm.state_dict()
    assert set(leaves) == set(state) == set(params_from_jax(tree))
    for key, val in leaves.items():
        assert tuple(state[key].shape) == val.shape, key
        np.testing.assert_array_equal(state[key].numpy(), val)
    # the nested view the decode functions read is the JAX tree's shape
    assert set(dict(_leaves(tm.params))) == set(leaves)


def test_load_jax_params_is_strict():
    _, tm, tree = _models()
    tree["0"]["extra"] = np.zeros((2,), np.float32)
    with pytest.raises(RuntimeError, match="extra"):
        load_jax_params(tm, tree)


def test_block_helpers_parity():
    """_ln / _proj / _ffn / _embed / _rope_rows on the same inputs and
    weights."""
    _, tm, tree = _models(pos="learned")
    rs = np.random.default_rng(0)
    x = rs.standard_normal((2, 5, 64), np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    jb, tb = tree["1"], tm.params["1"]

    def close(got, want, tol=1e-5):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=tol, rtol=tol)

    close(tgen._ln(tb["0"]["0"], tx), jgen._ln(jb["0"]["0"], jx))
    for name in ("q", "k", "v", "out"):
        close(tgen._proj(tb["0"]["1"], name, tx),
              jgen._proj(jb["0"]["1"], name, jx))
    close(tgen._ffn(tb["1"]["1"], tx), jgen._ffn(jb["1"]["1"], jx))
    ids = rs.integers(0, 131, size=(2, 7)).astype(np.int32)  # 0/129+ clamp
    close(tgen._embed(tm.params["0"], torch.from_numpy(ids), 3),
          jgen._embed(tree["0"], jnp.asarray(ids), 3))
    cols = rs.integers(0, 64, size=(2, 7)).astype(np.int32)
    close(tsv._embed_rows(tm.params["0"], torch.from_numpy(ids),
                          torch.from_numpy(cols).long()),
          jsv._embed_rows(tree["0"], jnp.asarray(ids), jnp.asarray(cols)))
    heads = rs.standard_normal((2, 7, 4, 16), np.float32)
    close(tsv._rope_rows(torch.from_numpy(heads),
                         torch.from_numpy(cols).long()),
          jsv._rope_rows(jnp.asarray(heads), jnp.asarray(cols)))
    close(tsv._qkv(tb, tx, 4, 2)[1], jsv._qkv(jb, jx, 4, 2)[1])
    from bigdl_tpu.nn.attention import apply_rope as j_rope
    from bigdl_tpu_torch.nn.attention import apply_rope as t_rope
    pos = np.arange(3, 10, dtype=np.int32)
    close(t_rope(torch.from_numpy(heads), torch.from_numpy(pos)),
          j_rope(jnp.asarray(heads), jnp.asarray(pos)))


def test_sample_greedy_and_top_k():
    """Greedy is argmax + 1 (1-based ids, ties to the lowest id, as
    jnp.argmax); tempered top-k draws stay inside the top k and repeat
    with the same generator seed."""
    logits = torch.tensor([[0.0, 3.0, 3.0, 1.0], [5.0, -1.0, 2.0, 4.0]])
    assert tgen._sample(logits, 0.0, None).tolist() == [2, 1]
    assert tgen._sample(logits, 0.0, None).tolist() == (
        np.asarray(jgen._sample(jnp.asarray(logits.numpy()), None, 0.0,
                                None)).tolist())
    draw = lambda: tgen._sample(logits.repeat(64, 1), 1.0, 2,
                                torch.Generator().manual_seed(3))
    a, b = draw(), draw()
    assert torch.equal(a, b)
    assert set(a[0::2].tolist()) <= {2, 3} and set(a[1::2].tolist()) <= {1, 4}


@pytest.mark.parametrize("kv,pos", [(2, "rope"), (1, "learned"),
                                    (4, "rope")],
                         ids=["gqa-rope", "mqa-learned", "mha-rope"])
def test_prefill_logits_match_jax(kv, pos):
    """Last-position logits of the port's paged prefill equal the JAX
    model's own forward at that position; the greedy first tokens equal
    the JAX paged prefill's."""
    jm, tm, _ = _models(kv, pos)
    rs = np.random.default_rng(1)
    prompts = [list(rs.integers(1, 129, size=(n,))) for n in (5, 11, 3)]
    cache = tsv.PagedKVCache(2, num_pages=16, page_size=4, kv_heads=kv,
                             head_dim=16, device="cpu")
    table = np.arange(15, dtype=np.int32).reshape(3, 5)
    lengths = np.asarray([len(p) for p in prompts], np.int32)
    batch = np.ones((3, 11), np.int32)
    for i, p in enumerate(prompts):
        batch[i, :len(p)] = p
    logits = tsv._paged_prefill_impl(
        tm.params, cache, table, batch, lengths, num_layers=2,
        num_heads=4, rope=pos == "rope", num_kv_heads=kv)
    for i, p in enumerate(prompts):
        full, _ = jm.apply(jm.params, jm.state,
                           jnp.asarray([p], jnp.int32))
        np.testing.assert_allclose(logits[i].numpy(),
                                   np.asarray(full[0, -1]), atol=1e-4,
                                   rtol=1e-4)
    jcache = jsv.PagedKVCache(2, num_pages=16, page_size=4, kv_heads=kv,
                              head_dim=16)
    jfirst, _ = jsv.paged_prefill(jm, jcache, table, prompts,
                                  paged_kernel="dense")
    np.testing.assert_array_equal(
        (torch.argmax(logits, -1) + 1).numpy(), np.asarray(jfirst))
