"""The port's flash attention (bigdl_tpu_torch.ops.flash_attention) and
attention core (parallel.sequence.dot_product_attention) against the JAX
package's Pallas kernel, run as its own tests run it on the CPU
(interpret mode), and against its XLA path.

On the CPU the port's wrappers take their plain versions
(``flash_fwd_ref``, ``flash_dq_ref``, ``flash_dkdv_ref``) inside the same
``autograd.Function`` the card runs, so these tests hold the yardsticks
that ``chip_smoke.py`` compares the CUDA kernels with to the JAX kernels,
backward and lse cotangent included.

Tolerances. float32: 2e-5 on o and lse, 5e-5 on the gradients: the same
math, sums in another order. bfloat16 (inputs, o and the gradients in
bf16): 2e-2 absolute on values of order 1 — one bf16 rounding step
(2^-8 relative) of the output, plus P rounded to bf16 at different
points of the two online softmaxes; lse stays f32 and is held at 1e-4.
"""
import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.ops.pallas import flash_attention as jfa
from bigdl_tpu.parallel import sequence as jseq
from bigdl_tpu.tuning.records import TuningRecords, set_default_records
from bigdl_tpu_torch.ops import flash_attention as tfa
from bigdl_tpu_torch.parallel import sequence as tseq

_DTYPES = {"f32": (jnp.float32, torch.float32, 2e-5, 5e-5),
           "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2, 2e-2)}


def _inputs(b, s, h, d, seed=0, kv=None, skv=None):
    rs = np.random.default_rng(seed)
    kv = kv or h
    skv = skv or s
    q = rs.standard_normal((b, s, h, d), np.float32)
    k = rs.standard_normal((b, skv, kv, d), np.float32)
    v = rs.standard_normal((b, skv, kv, d), np.float32)
    g = rs.standard_normal((b, s, h, d), np.float32)
    g_lse = rs.standard_normal((b, s, h), np.float32)
    return q, k, v, g, g_lse


def _close(got, want, tol, what):
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol, err_msg=what)


def _check_against_jax_kernel(b, s, h, d, causal, dtype, skv=None):
    """o, lse and dq/dk/dv of (o, lse) with nonzero cotangents on both
    (the analogue of tests/test_flash_attention.py's lse-cotangent test),
    the port against the JAX kernel in interpret mode."""
    jdt, tdt, tol, gtol = _DTYPES[dtype]
    q, k, v, g, g_lse = _inputs(b, s, h, d, skv=skv)
    jq, jk, jv = (jnp.asarray(x, jdt) for x in (q, k, v))

    def jf(q_, k_, v_):
        return jfa.flash_attention_with_lse(q_, k_, v_, causal=causal,
                                            interpret=True)

    (jo, jlse), vjp = jax.vjp(jf, jq, jk, jv)
    jdq, jdk, jdv = vjp((jnp.asarray(g, jdt), jnp.asarray(g_lse)))

    tq, tk, tv = (torch.from_numpy(x).to(tdt).requires_grad_()
                  for x in (q, k, v))
    to, tlse = tfa.flash_attention_with_lse(tq, tk, tv, causal=causal)
    assert to.dtype == tdt and tlse.dtype == torch.float32
    assert tlse.shape == (b, s, h)
    tdq, tdk, tdv = torch.autograd.grad(
        (to.float() * torch.from_numpy(g).to(tdt).float()).sum()
        + (tlse * torch.from_numpy(g_lse)).sum(), (tq, tk, tv))
    _close(to, jo, tol, "o")
    _close(tlse, jlse, 1e-4 if dtype == "bf16" else tol, "lse")
    for name, got, want in (("dq", tdq, jdq), ("dk", tdk, jdk),
                            ("dv", tdv, jdv)):
        assert got.dtype == tdt, name
        _close(got, want, gtol, name)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_matches_jax_kernel(causal, dtype):
    """(B2, S128, H2, D64) against the JAX kernel."""
    _check_against_jax_kernel(2, 128, 2, 64, causal, dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_matches_jax_kernel_at_ragged_tile_edges(causal, dtype):
    """D 128 at Sq 200: one 128-row tile of the card's kernels and a
    ragged tail of 72 rows; Skv 136 when not causal (a 128-key tile and
    8 keys). These are the yardsticks chip_smoke.py holds the kernels to
    at those edges. The JAX kernel tiles only lengths with a divisor it
    knows, so an in-memory tuning record hands it blocks that divide
    these (a record is honoured when its blocks divide the lengths)."""
    skv = 200 if causal else 136
    records = TuningRecords()
    records.record("flash_attention", {"sq": 200, "skv": skv},
                   {"bq": 40, "bk": 40 if causal else 136})
    set_default_records(records)
    try:
        _check_against_jax_kernel(1, 200, 2, 128, causal, dtype, skv=skv)
    finally:
        set_default_records(None)


@pytest.mark.parametrize("causal", [True, False])
def test_kernel_plain_versions_agree_with_one_autograd_function(causal):
    """The three plain kernel versions, composed by ``_Flash``, equal
    autograd through ``flash_attention_ref`` (f32, ragged S = 37 and a
    different key length when not causal): 2e-5."""
    q, k, v, g, g_lse = _inputs(2, 37, 3, 64, seed=1,
                                skv=37 if causal else 29)
    grads = []
    for fn in (tfa.flash_attention_with_lse, tfa.flash_attention_ref):
        tq, tk, tv = (torch.from_numpy(x).requires_grad_()
                      for x in (q, k, v))
        o, lse = fn(tq, tk, tv, causal=causal)
        loss = (o * torch.from_numpy(g)).sum() \
            + (lse * torch.from_numpy(g_lse)).sum()
        grads.append((o, lse) + torch.autograd.grad(loss, (tq, tk, tv)))
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   atol=2e-5, rtol=2e-5)


def test_cpu_path_counts_no_kernel_launches():
    q, k, v, _, _ = _inputs(1, 16, 1, 64)
    before = (tfa.fwd_launches, tfa.dq_launches, tfa.dkdv_launches)
    tq = torch.from_numpy(q).requires_grad_()
    tfa.flash_attention(tq, torch.from_numpy(k), torch.from_numpy(v),
                        causal=True).sum().backward()
    assert (tfa.fwd_launches, tfa.dq_launches, tfa.dkdv_launches) == before


@pytest.mark.parametrize("flash", ["auto", False])
@pytest.mark.parametrize("causal", [True, False])
def test_dot_product_attention_gqa_matches_jax_xla_path(causal, flash):
    """GQA widening (repeat_interleave = jnp.repeat on the head axis),
    then the port's attention core (flash "auto": the flash path; False:
    the plain f32 path) against JAX's XLA path at f32: 2e-5."""
    q, k, v, _, _ = _inputs(2, 48, 4, 64, seed=2, kv=2)
    jk = jnp.repeat(jnp.asarray(k), 2, axis=2)
    jv = jnp.repeat(jnp.asarray(v), 2, axis=2)
    want = jseq.dot_product_attention(jnp.asarray(q), jk, jv, causal=causal,
                                      flash=False)
    tk = torch.repeat_interleave(torch.from_numpy(k), 2, dim=2)
    tv = torch.repeat_interleave(torch.from_numpy(v), 2, dim=2)
    got = tseq.dot_product_attention(torch.from_numpy(q), tk, tv,
                                     causal=causal, flash=flash)
    _close(got, want, 2e-5, "o")


def test_dot_product_attention_offsets_and_unsupported_shapes():
    """Causal offsets take the plain path (as in the JAX package);
    flash=True refuses what the kernels do not take (causal offsets,
    float16); head dim 16 is taken, under flash=True too, zero-padded to
    the kernels' 32 (on CPU tensors their plain versions): 2e-5 against
    JAX's XLA path."""
    q, k, v, _, _ = _inputs(1, 8, 2, 16, seed=3)
    want = jseq.dot_product_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), causal=True,
                                      q_offset=4, kv_offset=2, flash=False)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = tseq.dot_product_attention(tq, tk, tv, causal=True, q_offset=4,
                                     kv_offset=2)
    _close(got, want, 2e-5, "offsets")
    assert tfa.flash_supported(tq, tk)
    want = jseq.dot_product_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), flash=False)
    _close(tseq.dot_product_attention(tq, tk, tv, flash=True), want, 2e-5,
           "head dim 16")
    with pytest.raises(ValueError, match="flash=True"):
        tseq.dot_product_attention(*(x.half() for x in (tq, tk, tv)),
                                   flash=True)
    q64, k64, _, _, _ = _inputs(1, 8, 2, 64, seed=3)
    assert tfa.flash_supported(torch.from_numpy(q64), torch.from_numpy(k64))
    with pytest.raises(ValueError, match="flash=True"):
        tseq.dot_product_attention(torch.from_numpy(q64),
                                   torch.from_numpy(k64),
                                   torch.from_numpy(k64), causal=True,
                                   q_offset=1, flash=True)


@pytest.mark.parametrize("what", ["head_dim", "offsets", "head_dim_320",
                                  "head_dim_288"])
def test_auto_refuses_unsupported_calls_off_the_cpu(what):
    """Off the CPU (meta tensors stand in for the card's here), "auto"
    raises where the kernels do not take the call instead of quietly
    building the (B, H, S, S) plain path; flash=False still takes it.
    Only causal offsets are refused now. Every head dim is taken: 320
    by the D-sliced kernels, 16 and 288 zero-padded to 32 and 320, so
    "auto" hands each to the kernel wrappers, which need a CUDA
    device."""
    d, kw = {"head_dim": (16, {}),
             "offsets": (64, dict(q_offset=4, kv_offset=2)),
             "head_dim_320": (320, {}),
             "head_dim_288": (288, {})}[what]
    q = torch.empty((1, 8, 2, d), device="meta")
    refusal = ("flash=False takes the plain" if what == "offsets"
               else "one CUDA device")
    with pytest.raises(ValueError, match=refusal):
        tseq.dot_product_attention(q, q, q, causal=True, **kw)
    o = tseq.dot_product_attention(q, q, q, causal=True, flash=False, **kw)
    assert o.shape == q.shape and o.device.type == "meta"


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_matches_jax_kernel_at_head_dim_32(causal, dtype):
    """Head dim 32, the train main's default width (d_model 128, 4
    heads), which the card's kernels take as one zero-padded 64-wide
    chunk: (B2, S128, H2, D32) against the JAX kernel."""
    _check_against_jax_kernel(2, 128, 2, 32, causal, dtype)


@pytest.mark.parametrize("d", [192, 256, 320, 384, 512])
def test_auto_takes_wide_head_dims_off_the_cpu(d):
    """Head dims 192 and 256, and past 256 every multiple of 64 (the
    D-sliced kernels), are not refused off the CPU: "auto" hands the call
    to the kernel wrappers, which need a CUDA device (the meta tensors
    standing in for the card's reach them and stop there), and never to
    the plain path."""
    q = torch.empty((1, 8, 2, d), device="meta")
    assert tfa.flash_supported(q, q)
    with pytest.raises(ValueError, match="one CUDA device"):
        tseq.dot_product_attention(q, q, q, causal=True)


def test_flash_supported_head_dims():
    """Every head dim is taken: those the kernels are built for (32, 64,
    128, 192, 256, and past 256 every multiple of 64) as they are, the
    rest zero-padded (``padded_head_dim``: 16 -> 32, 80 and 96 -> 128,
    288 -> 320), also those the JAX kernel leaves to XLA (16, 96, 288).
    Both dtypes; fp16 is refused."""
    for d in (1, 16, 20, 32, 64, 80, 96, 128, 192, 200, 256, 288, 320,
              384, 448, 512, 576, 1000, 1024):
        for dt in (torch.float32, torch.bfloat16):
            q = torch.empty((1, 4, 2, d), dtype=dt, device="meta")
            assert tfa.flash_supported(q, q), (d, dt)
    assert [tfa.padded_head_dim(d) for d in (1, 16, 33, 80, 96, 129, 193,
                                             256, 257, 288, 320, 1000)] \
        == [32, 32, 64, 128, 128, 192, 256, 256, 320, 320, 320, 1024]
    q = torch.empty((1, 4, 2, 128), dtype=torch.float16, device="meta")
    assert not tfa.flash_supported(q, q)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,s,d", [(2, 128, 192), (1, 128, 256),
                                   (1, 128, 320), (1, 128, 384),
                                   (1, 128, 512), (1, 128, 576),
                                   (1, 128, 1024)],
                         ids=["d192", "d256", "d320", "d384", "d512",
                              "d576", "d1024"])
def test_flash_matches_jax_kernel_at_wide_head_dims(b, s, d, causal,
                                                     dtype):
    """Head dims 192 and 256 (Gemma's heads are 256 wide), which the
    card's kernels take with tiles of their own (64-key forward tiles,
    one-warpgroup dq CTAs, dk and dv split between the warpgroups; f32
    tiles of 32 rows), and 320, 384, 512, 576 and 1024, which they take
    D-sliced (the scores summed over 64-column chunks; a CTA per 64
    output columns, or per slice of up to 256 in the bf16 forward, with
    Q resident at D 576 and streamed at 1024: ``flash_route``):
    (B, S, H2, D) against the JAX kernel at the file's tolerances. In
    bf16 a wider head changes nothing they rest on:
    o, dv and dq/dk are sums over keys of bf16-rounded P or dS times
    unit-variance values, at the same S as the D 64 case, and the extra
    dims only lengthen f32 sums of exact bf16 products."""
    _check_against_jax_kernel(b, s, 2, d, causal, dtype)


#: the bf16 launcher past D 256 each C entry names in the dispatch, the
#: function that launches its kernel, and the kernel
_WIDE_BF16 = {"fwd": ("tc::fwd_sliced", "int fwd_sliced_own(",
                      "flash_fwd_sliced_tc_kernel<OWN>"),
              "dq": ("tc::dq_sliced", "int dq_sliced_own(",
                     "flash_dq_sliced_tc_kernel<OWN>"),
              "dkdv": ("tc::dkdv_sliced", "int dkdv_sliced_own(",
                       "flash_dkdv_sliced_tc_kernel<OWN>")}
#: the f32 launcher of each C entry at every head dim (named in the
#: entry's ``tf32``, which passes the workspace on), the function that
#: launches its kernel past D 256, and that kernel (route "sliced_tf32")
_WIDE_F32 = {"fwd": ("tc::fwd_sliced_tf32", "int fwd_sliced_tf32_own(",
                     "flash_fwd_sliced_tf32_kernel<OWN>"),
             "dq": ("tc::dq_sliced_tf32", "int dq_sliced_tf32_own(",
                    "flash_dq_sliced_tf32_kernel<OWN>"),
             "dkdv": ("tc::dkdv_sliced_tf32", "int dkdv_sliced_tf32_own(",
                      "flash_dkdv_sliced_tf32_kernel<OWN>")}


def _function_body(src, head):
    """The text of the function of ``src`` that starts at ``head``, up to
    its closing brace at column 0."""
    body = src[src.index(head):]
    return body[:body.index("\n}\n")]


#: the instantiations each f32 launcher must call for the head dims up to
#: 256, one slice of all of D: chunks(D) = 1, 1, 2, 3, 4 at D 32, 64, 128,
#: 192, 256. The forward and dq up to 128 run the 128-row kernel of
#: chunks(D) (route "rows_tf32"), at 192 and 256 the sliced one whose
#: warpgroup 0 takes ceil(chunks / 2); dk/dv's warpgroups take all of them
_NARROW_F32_CALLS = {"fwd": ("fwd_rows_tf32<1>(", "fwd_rows_tf32<2>(",
                             "fwd_sliced_tf32_own<2>("),
                     "dq": ("dq_rows_tf32<1>(", "dq_rows_tf32<2>(",
                            "dq_sliced_tf32_own<2>("),
                     "dkdv": tuple(f"dkdv_sliced_tf32_own<{n}>("
                                   for n in (1, 2, 3, 4))}


@pytest.mark.parametrize("kernel", ["fwd", "dq", "dkdv"])
def test_flash_route_matches_the_c_dispatch(kernel):
    """``flash_route(dtype, d, kernel)`` against ``BIGDL_FLASH_DISPATCH``
    and its use in the C entry of ``kernel`` in csrc/flash_attention.cu,
    for every head dim up to 4096 (each at the route of
    ``padded_head_dim``) and each dtype. bf16: the head dims with kernels
    of their own run ``tc::`` (route "tc"); past 256 ``tc::fwd_sliced``,
    ``tc::dq_sliced`` and ``tc::dkdv_sliced``, whose launchers launch
    ``flash_{fwd,dq,dkdv}_sliced_tc_kernel`` (route "sliced_tc"). f32, at
    every head dim the kernels are built for: ``tc::fwd_sliced_tf32``,
    ``tc::dq_sliced_tf32`` and ``tc::dkdv_sliced_tf32`` (through the
    entry's ``tf32``, which passes the workspace on; 3xTF32 on the tensor
    cores), whose launchers launch ``flash_{fwd,dq,dkdv}_sliced_tf32_
    kernel`` past 256 (route "sliced_tf32") and call every instantiation
    the head dims up to 256 need: the forward and dq up to 128
    ``flash_fwd_rows_tf32_kernel`` and ``flash_dq_rows_tf32_kernel``
    (route "rows_tf32"), then the sliced kernel (route "sliced_tf32");
    dk/dv the sliced kernel. The CUDA-core forward, dq and dk/dv kernels
    are gone."""
    src = (Path(tfa.__file__).resolve().parents[1] / "csrc"
           / "flash_attention.cu").read_text()
    macro = src[src.index(
        "#define BIGDL_FLASH_DISPATCH(FN, F32, WIDE_BF16, "):]
    macro = macro[:macro.index("} while (0)")]
    own = {int(d): "tc" for d in re.findall(
        r"if \(dtype == 1 && D == (\d+)\) return tc::FN<\1>", macro)}
    f32 = re.search(r"if \(dtype == 0 && \(((?:[^()]|\([^()]*\))*)\)\)"
                    r"\s*\\\s*return F32\(D, __VA_ARGS__\);", macro)
    f32_dims = {int(d) for d in re.findall(r"D == (\d+)", f32.group(1))}
    assert f32_dims == set(own) == {32, 64, 128, 192, 256}
    # and past 256 every multiple of 64, in the same branch
    assert re.search(r"\|\|\s*(?:\\\s*)?\(D > 256 && D % 64 == 0\)$",
                     f32.group(1).strip())
    wide = dict(re.findall(r"if \(dtype == (\d) && D > 256 && D % 64 == 0\)"
                           r"\s*\\\s*return (\S+)\(D, __VA_ARGS__\);",
                           macro))
    assert wide == {"1": "WIDE_BF16"}
    f32_lambda, bf16_wide = re.search(
        rf"BIGDL_FLASH_DISPATCH\({kernel}, ([^,]+), ([^,]+),", src).groups()
    entry = _function_body(src, f'extern "C" int bigdl_flash_{kernel}(')
    f32_name, f32_launcher, f32_kernel = _WIDE_F32[kernel]
    # the entry's lambda hands every argument and the workspace to the f32
    # launcher
    assert f32_lambda == "tf32"
    assert f"auto tf32 = [work](int D, auto... a) {{\n    return " \
        f"{f32_name}(D, a..., work);" in entry
    assert f32_kernel in _function_body(src, f32_launcher)
    # the launcher's caller picks between its instantiations: every one
    # the head dims up to 256 need, and past 256 the sliced kernel's
    name = f32_name.split("::")[1]
    caller = _function_body(src, f"int {name}(int D, ")
    assert f32_launcher[4:-1] + "<" in caller
    for call in _NARROW_F32_CALLS[kernel]:
        assert call in caller, (kernel, call)
    if kernel != "dkdv":
        assert (f"flash_{kernel}_rows_tf32_kernel<NC>" in _function_body(
            src, f"int {kernel}_rows_tf32("))
        # up to 128 the 128-row kernel, past it the sliced one
        assert re.search(rf"if \(D <= 64\)\s*return {kernel}_rows_tf32<1>\("
                         rf"[^;]*;\s*if \(D <= 128\)\s*return "
                         rf"{kernel}_rows_tf32<2>\(", caller)
    # the CUDA-core kernels they replaced are gone
    assert f"flash_{kernel}_kernel<" not in src
    assert "cuda_cores" not in src
    b_entry, b_launcher, b_kernel = _WIDE_BF16[kernel]
    assert bf16_wide == b_entry
    assert b_kernel in _function_body(src, b_launcher)
    name = b_entry.split("::")[1]
    assert b_launcher[4:-1] + "<" in _function_body(src, f"int {name}(int D, ")
    codes = {torch.float32: 0, torch.bfloat16: 1}
    for dtype, code in codes.items():
        built = {}
        for d in range(32, 4097, 32):
            if d in own:
                built[d] = (own[d] if code == 1 else "rows_tf32"
                            if kernel != "dkdv" and d <= 128
                            else "sliced_tf32")
            elif d > 256 and d % 64 == 0:
                built[d] = "sliced_tf32" if code == 0 else "sliced_tc"
        assert set(built) == {d for d in range(32, 4097, 32)
                              if tfa._head_dim_ok(d)}
        # every other head dim runs padded to the next built one, on its
        # route
        for d in range(1, 4097):
            assert tfa.flash_route(dtype, d, kernel) == built[
                tfa.padded_head_dim(d)], (kernel, dtype, d)
    assert tfa.flash_route(torch.float16, 128, kernel) is None
    assert all(tfa.flash_route(torch.bfloat16, d, kernel) == "sliced_tc"
               for d in (320, 384, 448, 512, 576, 1024))
    assert all(tfa.flash_route(torch.float32, d, kernel) == "sliced_tf32"
               for d in (320, 384, 448, 512, 576, 1024))
    # the workspace follows the route: f32 takes one at every head dim,
    # bf16 never
    for dtype in codes:
        for d in (32, 96, 128, 256, 320):
            q = torch.empty((1, 2, 1, d), dtype=dtype, device="meta")
            work = tfa._work(kernel, q, q)
            assert (work is not None) == (tfa.flash_route(dtype, d, kernel)
                                          in tfa.TF32_ROUTES), (dtype, d)
            assert (work is not None) == (dtype == torch.float32), (dtype, d)
            if work is not None:
                assert work.numel() == (2 if kernel == "fwd" else 4) * 2 * d


def _chip_smoke():
    """The repository's ``chip_smoke.py`` (its limits and ``_worst``;
    importing it touches no card)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tf32(x):
    """x rounded to tf32 (10 mantissa bits, to nearest, ties away from
    zero: ``cvt.rna.tf32.f32``) by integer operations on its bits, as
    ``to_tf32`` in csrc/hopper.cuh does."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _mm_3xtf32(a, b):
    """a @ b in 3xTF32: each operand split into x = hi + lo, hi = tf32(x),
    lo = tf32(x - hi), and hi·lo + lo·hi + hi·hi summed in f32."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return ah @ bl + al @ bh + ah @ bh


def _mm_1xtf32(a, b):
    """a @ b as one TF32 product: both operands rounded to tf32."""
    return _tf32(a) @ _tf32(b)


def _emulated_backward(q, k, v, do, lse, delta, scale, causal, mm):
    """dq, dk, dv of one (b, h) as the f32 kernels past D 256 form them,
    every product (S = Q·Kᵀ, dP = dO·Vᵀ, dS·K, dSᵀ·Q, Pᵀ·dO) through
    ``mm``, P and dS left in f32."""
    s = mm(q, k.T) * scale
    if causal:
        pos = torch.arange(q.shape[0])
        s = torch.where(pos[None, :] > pos[:, None], -1e9, s)
    p = torch.exp(s - lse[:, None])
    ds = p * (mm(do, v.T) - delta[:, None]) * scale
    return mm(ds, k), mm(ds.T, q), mm(p.T, do)


@pytest.mark.parametrize(
    "causal,d", [pytest.param(c, d, id=f"{c}" + ("" if d == 512 else f"-d{d}"))
                 for d in (512, 32, 128, 256) for c in (True, False)])
def test_3xtf32_products_hold_the_f32_limit(causal, d):
    """The numerical argument of the f32 dq and dk/dv (at every head
    dim): their products split each f32 operand into two tf32 parts on
    the tensor cores (3xTF32). Emulated here in f32 on the CPU (integer
    rounding to tf32 as the kernels round, products of parts exact in
    f32) at D 512, 256, 128 and 32 (B1 S192 H1, inputs from a numpy
    seed), the gradients stay within ``chip_smoke._FLASH_TOL[(float32,
    "grad")]`` of ``flash_dq_ref`` / ``flash_dkdv_ref``, measured as
    ``chip_smoke._worst`` does (0.03-0.12 of the limit), while a single
    TF32 product of the same operands does not, at any of these widths
    (21-95 x the limit): TF32 keeps 11 of f32's 24 bits, the split about
    22. (The card's f32 sums inside the tensor cores drop bits as well;
    chip_smoke holds the kernels there.)"""
    cs = _chip_smoke()
    rtol, atol = cs._FLASH_TOL[(torch.float32, "grad")]
    q, k, v, g, _ = _inputs(1, 192, 1, d, seed=18)
    q, k, v, do = (torch.from_numpy(x) for x in (q, k, v, g))
    scale = d ** -0.5
    o, lse = tfa.flash_fwd_ref(q, k, v, scale, causal)
    delta = (do * o).sum(-1)
    want = (tfa.flash_dq_ref(q, k, v, do, lse, delta, scale, causal),
            *tfa.flash_dkdv_ref(q, k, v, do, lse, delta, scale, causal))
    args = (q[0, :, 0], k[0, :, 0], v[0, :, 0], do[0, :, 0], lse[0, :, 0],
            delta[0, :, 0], scale, causal)
    for mm, holds in ((_mm_3xtf32, True), (_mm_1xtf32, False)):
        got = _emulated_backward(*args, mm)
        worst = {name: cs._worst(gt, w[0, :, 0], rtol, atol)[1]
                 for name, gt, w in zip(("dq", "dk", "dv"), got, want)}
        if holds:
            assert max(worst.values()) <= 1, (mm.__name__, worst)
        else:
            assert min(worst.values()) > 1, (mm.__name__, worst)


def _emulated_forward(q, k, v, scale, causal, mm):
    """o and lse of one (b, h) as the f32 forward past D 256 forms them:
    64-key tiles walked with the online softmax (row max m and sum l; o
    rescaled by exp(m_old - m_new) at each tile), S = Q·Kᵀ and P·V through
    ``mm``, P left in f32 at the running max, o divided by l at the
    end."""
    sq, skv = q.shape[0], k.shape[0]
    m = torch.full((sq, 1), -torch.inf)
    lsum = torch.zeros((sq, 1))
    o = torch.zeros((sq, v.shape[1]))
    qpos = torch.arange(sq)[:, None]
    for k0 in range(0, skv, 64):
        s = mm(q, k[k0:k0 + 64].T) * scale
        if causal:
            kpos = k0 + torch.arange(s.shape[1])[None, :]
            s = torch.where(kpos > qpos, -1e9, s)
        m_new = torch.maximum(m, s.amax(dim=1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        lsum = lsum * alpha + p.sum(dim=1, keepdim=True)
        o = o * alpha + mm(p, v[k0:k0 + 64])
        m = m_new
    return o / lsum, (m + torch.log(lsum))[:, 0]


@pytest.mark.parametrize(
    "causal,d", [pytest.param(c, d, id=f"{c}" + ("" if d == 512 else f"-d{d}"))
                 for d in (512, 32, 64, 128, 256) for c in (True, False)])
def test_3xtf32_forward_holds_the_f32_limit(causal, d):
    """The numerical argument of the f32 forward (3xTF32 on the tensor
    cores at every head dim, the online softmax over 64-key tiles),
    emulated in f32 on the CPU as ``test_3xtf32_products_hold_the_f32_
    limit`` does the backward: at D 512, 256 (the sliced kernel, one
    slice), 128, 64 and 32 (the 128-row kernel; B1 S192 H1, inputs from a
    numpy seed) o stays within ``chip_smoke._FLASH_TOL[(float32, "o")]``
    of ``flash_fwd_ref`` evaluated in float64 (measured as
    ``chip_smoke._worst`` does: 0.02-0.06 of the limit) and lse within
    ``chip_smoke._LSE_TOL``, while the same walk with single TF32 products
    misses the o limit at every one of these widths (20-33 x it): the
    split keeps about 22 of f32's 24 bits, one TF32 product 11."""
    cs = _chip_smoke()
    rtol, atol = cs._FLASH_TOL[(torch.float32, "o")]
    q, k, v, _, _ = _inputs(1, 192, 1, d, seed=19)
    q, k, v = (torch.from_numpy(x) for x in (q, k, v))
    scale = d ** -0.5
    o64, lse64 = tfa.flash_fwd_ref(q.double(), k.double(), v.double(),
                                   scale, causal)
    assert o64.dtype == lse64.dtype == torch.float64
    args = (q[0, :, 0], k[0, :, 0], v[0, :, 0], scale, causal)
    for mm, holds in ((_mm_3xtf32, True), (_mm_1xtf32, False)):
        o, lse = _emulated_forward(*args, mm)
        worst_o = cs._worst(o, o64[0, :, 0], rtol, atol)[1]
        worst_lse = cs._worst(lse, lse64[0, :, 0], None, cs._LSE_TOL)[1]
        if holds:
            assert max(worst_o, worst_lse) <= 1, (mm.__name__, worst_o,
                                                  worst_lse)
        else:
            assert worst_o > 1, (mm.__name__, worst_o, worst_lse)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
def test_flash_fwd_ref_sums_float64_inputs_in_float64(dtype):
    """``flash_fwd_ref`` as ``chip_smoke`` holds the f32 forward to it:
    float64 inputs are summed in float64 (o and lse in float64, equal to
    softmax·v in float64 to 1e-12), as the backward's plain versions do;
    f32 and bf16 inputs give the bits they gave when P and v were cast to
    f32 for P·V whatever the input (P rounded to v's dtype first)."""
    q, k, v, _, _ = _inputs(1, 40, 2, 64, seed=5)
    q, k, v = (torch.from_numpy(x).to(dtype) for x in (q, k, v))
    o, lse = tfa.flash_fwd_ref(q, k, v, 0.125, True)
    s = tfa._scores(q, k, 0.125, True)
    if dtype == torch.float64:
        assert o.dtype == lse.dtype == torch.float64
        want = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)
        np.testing.assert_allclose(o.numpy(), want.numpy(), rtol=1e-12,
                                   atol=1e-12)
        np.testing.assert_allclose(
            lse.numpy(), torch.logsumexp(s, dim=-1).permute(0, 2, 1).numpy(),
            rtol=1e-12, atol=1e-12)
        return
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    lsum = p.sum(dim=-1, keepdim=True)
    want = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    want = want / lsum.squeeze(-1).permute(0, 2, 1)[..., None]
    assert o.dtype == dtype and lse.dtype == torch.float32
    assert torch.equal(o, want.to(dtype))
    assert torch.equal(lse, (m + torch.log(lsum)).squeeze(-1)
                       .permute(0, 2, 1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chip_smoke_holds_f32_gradients_to_the_float64_plain_version(dtype):
    """``chip_smoke._flash_bwd_refs``, the reference the card's dq, dk and
    dv are held to: for f32 inputs the plain versions evaluated in
    float64 (``flash_dq_ref`` / ``flash_dkdv_ref`` keep float64 inputs in
    float64) and rounded to f32, within ``_FLASH_TOL`` of the f32 plain
    versions on a small causal case; for bf16 the plain versions
    themselves, bit for bit (their bf16 rounding points kept)."""
    cs = _chip_smoke()
    q, k, v, g, _ = _inputs(1, 96, 2, 64, seed=3)
    q, k, v, do = (torch.from_numpy(x).to(dtype) for x in (q, k, v, g))
    scale = 64 ** -0.5
    o, lse = tfa.flash_fwd_ref(q, k, v, scale, True)
    delta = (do.float() * o.float()).sum(-1)
    got = cs._flash_bwd_refs(tfa, q, k, v, do, lse, delta, scale, True)
    plain = (tfa.flash_dq_ref(q, k, v, do, lse, delta, scale, True),
             *tfa.flash_dkdv_ref(q, k, v, do, lse, delta, scale, True))
    wide = tfa.flash_dq_ref(*(x.double() for x in (q, k, v, do, lse,
                                                    delta)), scale, True)
    assert wide.dtype == torch.float64
    for x, y in zip(got, plain):
        assert x.dtype == y.dtype == dtype
        if dtype == torch.bfloat16:
            assert torch.equal(x, y)
        else:
            rtol, atol = cs._FLASH_TOL[(torch.float32, "grad")]
            assert cs._worst(x, y, rtol, atol)[1] <= 1


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [16, 80, 96, 288])
def test_padded_head_dims_match_jax_xla_path(d, causal, dtype):
    """Head dims the kernels are not built for (16: the train main's at
    --numHeads 8; Phi-2's 80; Phi-3-mini's 96; 288, past 256 and no
    multiple of 64), which ``flash_attention`` runs zero-padded to 32,
    128, 128 and 320 with the scale of the true D: o and its gradients,
    through ``flash_attention`` and ``dot_product_attention`` ("auto"),
    against JAX's ``dot_product_attention(flash=False)`` (the XLA path,
    which JAX takes at these head dims) and its ``jax.grad``, at (B1, S40,
    H2). f32: 2e-5 on o, 5e-5 on the gradients (the same math, sums in
    another order). bf16: 2e-2, the file's tolerance (P rounded to bf16
    in the flash arithmetic, f32 throughout in JAX's)."""
    jdt, tdt, tol, gtol = _DTYPES[dtype]
    q, k, v, g, _ = _inputs(1, 40, 2, d, seed=d)

    def jloss(q_, k_, v_):
        o = jseq.dot_product_attention(q_, k_, v_, causal=causal,
                                       flash=False)
        return (o.astype(jnp.float32) * jnp.asarray(g)).sum(), o

    (_, jo), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                         has_aux=True)(
        *(jnp.asarray(x, jdt) for x in (q, k, v)))
    for fn in (tfa.flash_attention, tseq.dot_product_attention):
        tq, tk, tv = (torch.from_numpy(x).to(tdt).requires_grad_()
                      for x in (q, k, v))
        to = fn(tq, tk, tv, causal=causal)
        assert to.shape == tq.shape and to.dtype == tdt
        grads = torch.autograd.grad(
            (to.float() * torch.from_numpy(g)).sum(), (tq, tk, tv))
        _close(to, jo, tol, f"{fn.__name__} o")
        for name, got, want in zip(("dq", "dk", "dv"), grads, jgrads):
            assert got.dtype == tdt and got.shape == tq.shape, name
            _close(got, want, gtol, f"{fn.__name__} {name}")
