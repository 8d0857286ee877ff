"""The port's paged attention (bigdl_tpu_torch.ops.paged_attention)
against the JAX package's Pallas kernel, run as its own tests run it on
the CPU (interpret mode).

On the CPU the port's wrapper takes its plain version
(``paged_attention_ref``: the ``_paged_view`` gather + ``_attend_grouped``),
so these tests hold that plain version — the yardstick the CUDA kernel is
compared with on the card by ``chip_smoke.py`` — to the JAX kernel.

Tolerances: f32 pools 2e-5 (the JAX tests' own: same math, sums in
another order). bf16 pools 1e-2 absolute: both sides round the softmax
weights p to bf16 before P·V (relative error 2^-9), but at different
points — the Pallas kernel rounds unnormalised per-page weights, the
plain version normalised ones — so outputs, weighted means of N(0, 1)
values, differ by up to about 2^-9 · max|v|.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bigdl_tpu.ops.pallas import paged_attention as jpa
from bigdl_tpu_torch.models.transformer import serving as tsv
from bigdl_tpu_torch.ops import paged_attention as tpa

_DTYPES = {"f32": (jnp.float32, torch.float32, 2e-5, 2e-5),
           "bf16": (jnp.bfloat16, torch.bfloat16, 1e-2, 0.0)}


def _geometry(b, t, h, kv, d, n_pages, s, p, seed=0):
    rs = np.random.default_rng(seed)
    q = rs.standard_normal((b, t, h, d), np.float32)
    kp = rs.standard_normal((n_pages, s, kv, d), np.float32)
    vp = rs.standard_normal((n_pages, s, kv, d), np.float32)
    table = rs.permutation(n_pages)[:b * p].reshape(b, p).astype(np.int32)
    return q, kp, vp, table


def _compare(q, kp, vp, table, q_start, dtype, scale=None):
    jdt, tdt, atol, rtol = _DTYPES[dtype]
    q_start = np.asarray(q_start, np.int32)
    want = jpa.paged_attention(
        jnp.asarray(q), jnp.asarray(kp, jdt), jnp.asarray(vp, jdt),
        jnp.asarray(table), jnp.asarray(q_start), scale=scale,
        interpret=True)
    got = tpa.paged_attention(
        torch.from_numpy(q), torch.from_numpy(kp).to(tdt),
        torch.from_numpy(vp).to(tdt), torch.from_numpy(table),
        torch.from_numpy(q_start), scale=scale)
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
class TestRefParity:

    @pytest.mark.parametrize("h,kv", [(8, 2), (4, 1), (4, 4)],
                             ids=["gqa", "mqa", "mha"])
    def test_grouping_modes(self, h, kv, dtype):
        q, kp, vp, table = _geometry(3, 1, h, kv, 32, 32, 8, 4)
        # mid-page, last slot of page 1, single-page row
        _compare(q, kp, vp, table, [5, 15, 2], dtype, scale=32 ** -0.5)

    def test_multi_column_causal(self, dtype):
        q, kp, vp, table = _geometry(2, 4, 4, 2, 16, 16, 4, 6, seed=1)
        _compare(q, kp, vp, table, [0, 9], dtype)

    @pytest.mark.parametrize("pos", [0, 7, 8, 31],
                             ids=["first-token", "page-end", "page-start",
                                  "last-slot"])
    def test_page_boundary_positions(self, pos, dtype):
        q, kp, vp, table = _geometry(1, 1, 4, 1, 16, 8, 8, 4, seed=2)
        _compare(q, kp, vp, table, [pos], dtype)

    @pytest.mark.parametrize("m,q_start", [(24, [2, 11, 0]),
                                           (13, [12, 4, 0])],
                             ids=["paged-24", "prime-13"])
    def test_dense_cache_view(self, m, q_start, dtype):
        jdt, tdt, atol, rtol = _DTYPES[dtype]
        rs = np.random.default_rng(3)
        q = rs.standard_normal((3, 3, 4, 16), np.float32)
        ck = rs.standard_normal((3, m, 2, 16), np.float32)
        cv = rs.standard_normal((3, m, 2, 16), np.float32)
        qs = np.asarray(q_start, np.int32)
        want = jpa.dense_cache_attention(
            jnp.asarray(q), jnp.asarray(ck, jdt), jnp.asarray(cv, jdt),
            jnp.asarray(qs), interpret=True)
        got = tpa.dense_cache_attention(
            torch.from_numpy(q), torch.from_numpy(ck).to(tdt),
            torch.from_numpy(cv).to(tdt), torch.from_numpy(qs))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=atol, rtol=rtol)


def test_dense_cache_page_size_matches_jax():
    for m in (13, 24, 64, 197, 320, 2048):
        assert tpa.dense_cache_page_size(m) == jpa.dense_cache_page_size(m)


def test_attend_grouped_matches_jax():
    """The plain version's core against the JAX serving helper itself."""
    from bigdl_tpu.models.transformer import serving as jsv
    rs = np.random.default_rng(6)
    q = rs.standard_normal((2, 3, 4, 8), np.float32)
    ck = rs.standard_normal((2, 10, 2, 8), np.float32)
    cv = rs.standard_normal((2, 10, 2, 8), np.float32)
    upto = np.asarray([[1, 2, 3], [7, 8, 9]], np.int32)
    want = jsv._attend_grouped(jnp.asarray(q), jnp.asarray(ck),
                               jnp.asarray(cv), jnp.asarray(upto), 4, 0.3)
    got = tsv._attend_grouped(torch.from_numpy(q), torch.from_numpy(ck),
                              torch.from_numpy(cv),
                              torch.from_numpy(upto).long(), 4, 0.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


class TestNoSilentFallback:

    def test_default_device_needs_cuda(self):
        """Entry points default to the card and raise without one."""
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tsv.PagedKVCache(1, num_pages=4, page_size=4, kv_heads=1,
                             head_dim=8)

    def test_non_cpu_tensor_never_takes_the_plain_version(self):
        """Only a CPU tensor selects the plain version; any other device
        must launch the kernel or raise."""
        q = torch.empty((1, 1, 4, 32), device="meta")
        kp = torch.empty((4, 8, 2, 32), device="meta")
        table = torch.zeros((1, 2), dtype=torch.int32, device="meta")
        qs = torch.zeros((1,), dtype=torch.int32, device="meta")
        with pytest.raises(ValueError, match="CUDA device"):
            tpa.paged_attention(q, kp, kp, table, qs)

    def test_kernel_mode_on_cpu_pools_raises(self):
        geom = (128, 16, torch.bfloat16)
        cpu, cuda = torch.device("cpu"), torch.device("cuda")
        with pytest.raises(ValueError, match="CUDA"):
            tsv._resolve_paged_kernel("kernel", cpu, *geom)
        with pytest.raises(ValueError, match="paged_kernel"):
            tsv._resolve_paged_kernel("interpret", cpu, *geom)
        assert tsv._resolve_paged_kernel("auto", cpu, *geom) == "dense"
        assert tsv._resolve_paged_kernel("auto", cuda, *geom) == "kernel"

    # (head dim, page size, pool dtype) -> the kernel takes it
    _GEOMETRIES = {
        "d32": ((32, 16, torch.bfloat16), True),
        "d96": ((96, 16, torch.bfloat16), False),
        "s128-f32-d128": ((128, 128, torch.float32), False),
        "s256-bf16-d128": ((128, 256, torch.bfloat16), False),
        "s128-bf16-d128": ((128, 128, torch.bfloat16), True),
        "fp16": ((128, 16, torch.float16), False),
    }

    @pytest.mark.parametrize("case", sorted(_GEOMETRIES))
    def test_auto_consults_the_pool_geometry(self, case):
        """``paged_kernel_supported`` is the wrapper's geometry checks
        (head dim in (32, 64, 128, 256), f32 or bf16, 4·S·D·bytes within
        shared memory); "auto" takes the kernel for a CUDA pool where it
        holds and refuses the pool where it does not, naming "dense";
        "kernel" and "dense" are taken as asked."""
        geom, ok = self._GEOMETRIES[case]
        assert tpa.paged_kernel_supported(*geom) is ok
        cuda = torch.device("cuda")
        if ok:
            assert tsv._resolve_paged_kernel("auto", cuda, *geom) == "kernel"
        else:
            with pytest.raises(ValueError, match="paged_kernel='dense'"):
                tsv._resolve_paged_kernel("auto", cuda, *geom)
        assert tsv._resolve_paged_kernel("kernel", cuda, *geom) == "kernel"
        assert tsv._resolve_paged_kernel("dense", cuda, *geom) == "dense"
        assert tsv._resolve_paged_kernel("auto", torch.device("cpu"),
                                         *geom) == "dense"

    def test_auto_refuses_unsupported_pools_off_the_cpu(self):
        """A prefill/decode step over a pool off the CPU whose geometry
        the kernel does not take raises under "auto" instead of taking
        the dense path unseen (meta pools stand in for the card's);
        "dense" is taken as asked, and CPU pools take it under "auto"."""
        class _Model:
            lm_meta = dict(num_layers=1, num_heads=2, num_kv_heads=1)

        meta = tsv.PagedKVCache(1, 4, 16, 1, 96, torch.bfloat16,
                                device="meta")
        with pytest.raises(ValueError, match="head dim 96"):
            tsv._meta_statics(_Model, "auto", meta)
        assert tsv._meta_statics(_Model, "dense", meta)["paged_kernel"] \
            == "dense"
        cpu = tsv.PagedKVCache(1, 4, 16, 1, 96, torch.bfloat16,
                               device="cpu")
        assert tsv._meta_statics(_Model, "auto", cpu)["paged_kernel"] \
            == "dense"
