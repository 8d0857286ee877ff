"""The port's paged prefill/decode and ContinuousBatcher against the JAX
package's, at f32 with greedy sampling, with the JAX model's weights
moved across by ``load_jax_params``. Greedy tokens must be equal: at f32
the two differ only in the order of sums (well under the gap between the
top two logits of these prompts).
"""
import numpy as np
import pytest
import torch

import jax

from bigdl_tpu.models import TransformerLM as JaxLM
from bigdl_tpu.models.transformer import serving as jsv
from bigdl_tpu.observability.exporter import HealthRegistry
from bigdl_tpu.observability.registry import MetricRegistry
from bigdl_tpu_torch.interop import load_jax_params
from bigdl_tpu_torch.models import TransformerLM
from bigdl_tpu_torch.models.transformer import serving as tsv


def _models(kv=2, pos="rope", **widths):
    geom = dict(d_model=64, num_heads=4, num_layers=2, max_len=64,
                with_log_softmax=False, num_kv_heads=kv, pos_encoding=pos)
    geom.update(widths)
    jm = JaxLM(128, **geom)
    jm.materialize(jax.random.PRNGKey(0))
    jm.evaluate()
    tm = TransformerLM(128, device="cpu", **geom)
    load_jax_params(tm, jax.tree.map(np.asarray, jm.params))
    return jm, tm


def _prompts(lengths, seed=0):
    rs = np.random.default_rng(seed)
    return [list(int(t) for t in rs.integers(1, 129, size=(n,)))
            for n in lengths]


@pytest.mark.parametrize("kv,pos", [(2, "rope"), (1, "learned")],
                         ids=["gqa-rope", "mqa-learned"])
def test_prefill_decode_tokens_match_jax(kv, pos):
    jm, tm = _models(kv, pos)
    prompts = _prompts((5, 11, 3))
    table = np.arange(24, dtype=np.int32).reshape(3, 8)

    jcache = jsv.PagedKVCache(2, num_pages=25, page_size=4, kv_heads=kv,
                              head_dim=16)
    jfirst, jlen = jsv.paged_prefill(jm, jcache, table, prompts,
                                     paged_kernel="dense")
    jtoks, jnew = jsv.paged_decode(jm, jcache, table, jlen, jfirst, 6,
                                   paged_kernel="dense")

    tcache = tsv.PagedKVCache(2, num_pages=25, page_size=4, kv_heads=kv,
                              head_dim=16, device="cpu")
    tfirst, tlen = tsv.paged_prefill(tm, tcache, table, prompts)
    ttoks, tnew = tsv.paged_decode(tm, tcache, table, tlen, tfirst, 6)

    np.testing.assert_array_equal(tfirst.numpy(), np.asarray(jfirst))
    np.testing.assert_array_equal(tlen, np.asarray(jlen))
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
    np.testing.assert_array_equal(tnew.numpy(), np.asarray(jnew))
    # the pools hold the same KV (neither side writes padding columns)
    for li in range(2):
        np.testing.assert_allclose(tcache.kp[li].numpy(),
                                   np.asarray(jcache.kp[li]), atol=1e-5)


def test_falcon_shaped_prefill_decode_match_jax():
    """Falcon-7B's attention shape at the tests' scale: 71 query heads
    over one kv head (G 71, past the 64 rows that the card's tensor-core
    kernel used to cap), head dim 8 (d_model 568), 2 layers. The port's
    paged prefill and decode (their plain versions here) give the JAX
    serving functions' greedy tokens and pools (1e-5)."""
    jm, tm = _models(1, "rope", d_model=568, num_heads=71)
    prompts = _prompts((5, 11, 3), seed=3)
    table = np.arange(24, dtype=np.int32).reshape(3, 8)

    jcache = jsv.PagedKVCache(2, num_pages=25, page_size=4, kv_heads=1,
                              head_dim=8)
    jfirst, jlen = jsv.paged_prefill(jm, jcache, table, prompts,
                                     paged_kernel="dense")
    jtoks, jnew = jsv.paged_decode(jm, jcache, table, jlen, jfirst, 6,
                                   paged_kernel="dense")

    tcache = tsv.PagedKVCache(2, num_pages=25, page_size=4, kv_heads=1,
                              head_dim=8, device="cpu")
    tfirst, tlen = tsv.paged_prefill(tm, tcache, table, prompts)
    ttoks, tnew = tsv.paged_decode(tm, tcache, table, tlen, tfirst, 6)

    np.testing.assert_array_equal(tfirst.numpy(), np.asarray(jfirst))
    np.testing.assert_array_equal(tlen, np.asarray(jlen))
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
    np.testing.assert_array_equal(tnew.numpy(), np.asarray(jnew))
    for li in range(2):
        np.testing.assert_allclose(tcache.kp[li].numpy(),
                                   np.asarray(jcache.kp[li]), atol=1e-5)
        np.testing.assert_allclose(tcache.vp[li].numpy(),
                                   np.asarray(jcache.vp[li]), atol=1e-5)


def _run_jax(jm, prompts, cancel=(), **kw):
    b = jsv.ContinuousBatcher(jm, registry=MetricRegistry(),
                              health=HealthRegistry(),
                              paged_kernel="dense", **kw)
    return _drive(b, prompts, cancel)


def _drive(b, prompts, cancel):
    for rid, p in prompts.items():
        b.submit(rid, p)
    for rid in cancel:       # in flight after one step, or still queued
        if rid == "r0":
            b.step()
        assert b.cancel(rid)
    assert not b.cancel("nope")
    return dict(b.run_to_completion())


_BATCHER = dict(max_batch=2, num_pages=48, page_size=4, max_new_tokens=6,
                max_burst=4)


class TestBatcherMatchesJax:
    """Prompts spanning buckets 8/16/32, more requests than slots."""

    def setup_method(self):
        self.jm, self.tm = _models(kv=1, pos="rope")
        self.prompts = {f"r{i}": p for i, p in
                        enumerate(_prompts((5, 9, 3, 17, 30), seed=2))}

    def _both(self, cancel=(), **kw):
        want = _run_jax(self.jm, self.prompts, cancel, **_BATCHER, **kw)
        got = _drive(tsv.ContinuousBatcher(self.tm, **_BATCHER, **kw),
                     self.prompts, cancel)
        assert got == want
        return got

    def test_results(self):
        got = self._both()
        assert sorted(got) == sorted(self.prompts)
        assert all(len(t) == 6 for t in got.values())

    def test_eos(self):
        # an id that greedy decoding emits mid-sequence for some request
        eos = self._both()["r1"][2]
        got = self._both(eos_id=eos)
        assert got["r1"][-1] == eos and len(got["r1"]) <= 3

    def test_cancel(self):
        got = self._both(cancel=("r0", "r4"))
        assert sorted(got) == ["r1", "r2", "r3"]


def test_batcher_at_phi3_head_dim_matches_jax():
    """Phi-3-mini's attention width at the tests' scale: head dim 96
    (d_model 384, 4 heads over 4 kv heads), which the card's paged
    kernels run at 128 with zero columns past 96, 2 layers. The port's
    batcher (the paged kernels' plain versions here) gives the JAX
    batcher's greedy tokens, which the JAX batcher serves on its dense
    path at that head dim."""
    jm, tm = _models(kv=4, pos="rope", d_model=384, num_heads=4)
    assert tm.lm_meta["d_model"] // tm.lm_meta["num_heads"] == 96
    prompts = {f"r{i}": p for i, p in
               enumerate(_prompts((5, 9, 3, 17, 30), seed=4))}
    want = _run_jax(jm, prompts, **_BATCHER)
    got = _drive(tsv.ContinuousBatcher(tm, **_BATCHER), prompts, ())
    assert got == want
    assert sorted(got) == sorted(prompts)
    assert all(len(t) == 6 for t in got.values())


def test_prefill_padding_writes_no_page_it_does_not_own():
    """JAX drops padding-column writes through an out-of-range page id; a
    torch index_put with that id would fault. The port writes only the
    valid columns: with a 3-token prompt padded to 8 columns, slot 3 of
    the row's own page and all of the neighbour's page (mapped where the
    padding columns fall) keep their contents."""
    _, tm = _models()
    cache = tsv.PagedKVCache(2, num_pages=4, page_size=4, kv_heads=2,
                             head_dim=16, device="cpu")
    for pool in cache.kp + cache.vp:
        pool.fill_(7.0)
    padded = np.ones((1, 8), np.int32)
    padded[0, :3] = [5, 6, 7]
    tsv.paged_prefill(tm, cache, np.asarray([[1, 2]], np.int32), padded,
                      lengths=np.asarray([3], np.int32))
    for pool in cache.kp + cache.vp:
        assert not torch.all(pool[1, :3] == 7.0)          # written
        assert torch.all(pool[1, 3] == 7.0)               # padding col
        assert torch.all(pool[2] == 7.0)                  # not its page
        assert torch.all(pool[[0, 3]] == 7.0)


def test_decode_capacity_checked_on_host():
    """An out-of-range table gather is an error in torch (a device assert
    on the card), so decode past the table's capacity is refused before
    any tensor is touched."""
    _, tm = _models()
    cache = tsv.PagedKVCache(2, num_pages=4, page_size=4, kv_heads=2,
                             head_dim=16, device="cpu")
    with pytest.raises(ValueError, match="capacity"):
        tsv.paged_decode(tm, cache, np.asarray([[0, 1]], np.int32), [6],
                         [1], 3)
