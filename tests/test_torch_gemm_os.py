"""Port's output-stationary GEMM against the JAX reference on the CPU (the
Pallas kernel in interpret mode and the plain ``gemm_ref``), and the
wrapper's CPU route and input checks.  The kernel itself is held against
its plain version on a card by tests/test_torch_gpu.py.

Tolerances are tests/test_kernels.py's: rtol 1e-4, atol 8e-4 in float32
and rtol 2e-2, atol 0.16 in bf16 for the shape sweep (atol = 8 rtol
there); 1e-4 for the fused epilogues; 1e-5 for the any-shape property,
whose small integer-valued inputs sum exactly in float32."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip(
    "hypothesis", reason="hypothesis not installed (pip install -e '.[test]')")
from hypothesis import given, settings, strategies as st

from repro.kernels.gemm_os.ops import gemm_os as jax_gemm_os
from repro.kernels.gemm_os.ref import gemm_ref as jax_ref
from repro_torch.kernels.common import cdiv
from repro_torch.kernels.gemm_os import kernel as kmod
from repro_torch.kernels.gemm_os.kernel import gemm_os_cuda
from repro_torch.kernels.gemm_os.ops import gemm_os
from repro_torch.kernels.gemm_os.ref import (gemm_ref, matmul_tf32x3,
                                             split_tf32)

SHAPES = [(128, 128, 128), (256, 384, 128), (64, 200, 96), (8, 128, 257)]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _normal(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _both(arr, dtype):
    """The same numbers as a JAX array and a torch tensor of ``dtype``."""
    jd, td = DTYPES[dtype]
    return jnp.asarray(arr, jd), torch.from_numpy(arr).to(td)


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


@pytest.mark.parametrize("coalesce", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N", SHAPES)
def test_gemm_os_matches_jax(M, K, N, dtype, coalesce):
    ja, ta = _both(_normal((M, K), M + K), dtype)
    jb, tb = _both(_normal((K, N), K + N), dtype)
    before = gemm_os.launches
    got = gemm_os(ta, tb, coalesce_grid=coalesce)
    assert gemm_os.launches == before           # CPU tensors: plain version
    assert got.dtype == DTYPES[dtype][1] and got.shape == (M, N)
    tol = 2e-2 if dtype == "bfloat16" else 1e-4
    for want in (jax_gemm_os(ja, jb, interpret=True, coalesce_grid=coalesce),
                 jax_ref(ja, jb)):
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol,
                                   atol=tol * 8)


@pytest.mark.parametrize("act", [None, "relu", "gelu", "silu"])
def test_gemm_os_fused_epilogue(act):
    a, b, bias = _normal((64, 128), 1), _normal((128, 64), 2), \
        _normal((64,), 3)
    got = gemm_os(*(torch.from_numpy(x) for x in (a, b, bias)),
                  activation=act)
    ja, jb, jbias = (jnp.asarray(x) for x in (a, b, bias))
    for want in (jax_gemm_os(ja, jb, jbias, activation=act, interpret=True),
                 jax_ref(ja, jb, jbias, act)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-4)


@settings(max_examples=10, deadline=None)
@given(st.integers(1, 100), st.integers(1, 100), st.integers(1, 100))
def test_gemm_os_property_any_shape(M, K, N):
    a = (np.arange(M * K).reshape(M, K) % 7).astype(np.float32)
    b = (np.arange(K * N).reshape(K, N) % 5).astype(np.float32)
    got = gemm_os(torch.from_numpy(a), torch.from_numpy(b))
    want = jax_gemm_os(jnp.asarray(a), jnp.asarray(b), interpret=True,
                       bm=32, bn=32, bk=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_gemm_os_out_dtype_and_bias_dtype(out_dtype):
    """out_dtype sets the result's type; a bf16 bias is added in float32,
    as the reference casts it."""
    a, b, bias = _normal((16, 32), 4), _normal((32, 24), 5), _normal((24,), 6)
    got = gemm_ref(torch.from_numpy(a), torch.from_numpy(b),
                   torch.from_numpy(bias).to(torch.bfloat16), "silu",
                   out_dtype)
    want = jax_ref(jnp.asarray(a), jnp.asarray(b),
                   jnp.asarray(bias, jnp.bfloat16), "silu",
                   jnp.bfloat16 if out_dtype == torch.bfloat16
                   else jnp.float32)
    assert got.dtype == out_dtype
    tol = 2e-2 if out_dtype == torch.bfloat16 else 1e-4
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


def test_gemm_os_unknown_activation_raises():
    a = torch.ones(2, 3)
    with pytest.raises(ValueError, match="tanh"):
        gemm_os(a, torch.ones(3, 2), activation="tanh")


def test_gemm_os_other_device_raises():
    a = torch.ones(2, 3, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        gemm_os(a, torch.ones(3, 2, device="meta"))


@pytest.mark.parametrize("change,error,match", [
    (dict(a=torch.float16), TypeError, "float32 or bfloat16"),
    (dict(b=torch.bfloat16), TypeError, "one dtype"),
    (dict(out_dtype=torch.float16), TypeError, "writes float32"),
    (dict(bias=torch.int32), TypeError, "floating point"),
    (dict(activation="tanh"), ValueError, "activation"),
    (dict(b_shape=(5, 4)), ValueError, "shapes"),
    (dict(bias_shape=(3,)), ValueError, "shapes"),
    (dict(), ValueError, "CUDA device"),
])
def test_gemm_os_kernel_rejects(change, error, match):
    """The kernel's wrapper refuses what the kernel does not take, before
    it builds or launches anything: another dtype, an unknown activation,
    mismatched shapes, or tensors off the card (CPU tensors here)."""
    a, b, bias = torch.ones(3, 6), torch.ones(6, 4), torch.ones(4)
    if "b_shape" in change:
        b = torch.ones(change["b_shape"])
    if "bias_shape" in change:
        bias = torch.ones(change["bias_shape"])
    tensors = dict(a=a, b=b, bias=bias)
    for name in ("a", "b", "bias"):
        if name in change:
            tensors[name] = tensors[name].to(change[name])
    kwargs = {k: change[k] for k in ("out_dtype", "activation") if k in change}
    with pytest.raises(error, match=match):
        gemm_os_cuda(tensors["a"], tensors["b"], tensors["bias"], **kwargs)


@pytest.mark.parametrize("M,K,N,dtype,aligned,want", [
    (1024, 2048, 8192, torch.bfloat16, True, ("tensor_core", 128, 128)),
    (8, 2048, 8192, torch.bfloat16, True, ("tensor_core", 64, 64)),
    (64, 512, 384, torch.bfloat16, True, ("tensor_core", 64, 64)),
    (65, 512, 384, torch.bfloat16, True, ("tensor_core", 128, 128)),
    (200, 136, 264, torch.bfloat16, True, ("tensor_core", 128, 128)),
    (8, 2048, 1000, torch.bfloat16, True, ("tensor_core", 64, 64)),
    (1000, 2000, 777, torch.bfloat16, True, ("simt", 128, 128)),
    (129, 37, 255, torch.bfloat16, True, ("simt", 128, 128)),
    (1, 1, 1, torch.bfloat16, True, ("simt", 128, 128)),
    (1024, 2048, 8192, torch.bfloat16, False, ("simt", 128, 128)),
    (1024, 2048, 8192, torch.float32, True, ("tf32x3", 128, 128)),
    (8, 2048, 8192, torch.float32, True, ("tf32x3", 64, 64)),
    (256, 256, 256, torch.float32, True, ("tf32x3", 64, 64)),
    (1200, 2048, 1408, torch.float32, True, ("tf32x3", 64, 64)),
    (2048, 2048, 1408, torch.float32, True, ("tf32x3", 128, 128)),
    (200, 36, 260, torch.float32, True, ("tf32x3", 64, 64)),
    (1000, 2000, 777, torch.float32, True, ("simt", 128, 128)),
    (1024, 2046, 8192, torch.float32, True, ("simt", 128, 128)),
    (1024, 2048, 8190, torch.float32, True, ("simt", 128, 128)),
    (129, 37, 255, torch.float32, True, ("simt", 128, 128)),
    (1, 1, 1, torch.float32, True, ("simt", 128, 128)),
    (1024, 2048, 8192, torch.float32, False, ("simt", 128, 128)),
    # K at the scratch cap: one full wave over K must fit in 2 GiB
    (60000, 60000, 60000, torch.float32, True, ("tf32x3", 128, 128)),
    (60000, 91180, 60000, torch.float32, True, ("tf32x3", 128, 128)),
    (60000, 91184, 60000, torch.float32, True, ("simt", 128, 128)),
    (1408, 182360, 1408, torch.float32, True, ("tf32x3", 64, 64)),
    (1408, 182364, 1408, torch.float32, True, ("simt", 128, 128)),
    (8, 31744, 8448, torch.float32, True, ("tf32x3", 64, 64)),
    (8, 31748, 8448, torch.float32, True, ("simt", 128, 128)),
    (8, 200000, 64, torch.float32, True, ("tf32x3", 64, 64)),
])
def test_gemm_os_route(M, K, N, dtype, aligned, want):
    """The tensor-core route takes bf16 with K and N multiples of 8 (TMA's
    16-byte row strides) and aligned pointers, with the 64 x 64 tile up
    to M 64 and 128 x 128 above; tf32x3 takes float32 with K and N
    multiples of 4 (16-byte rows) and aligned pointers, with the 64 x 64
    tile up to M 64 and wherever 128 x 128 tiles would be fewer than the
    card's 132 SMs, as long as one full wave of tiles (132, or all the
    product has) over the whole K fits its split operands under the
    scratch cap: 12 x 11 tiles of 128 up to K 91180, of 64 up to K
    182360, one row of 132 tiles of 64 at M 8 up to K 31744; a product of
    one tile fits to K 200000 and beyond.  The rest run on SIMT."""
    assert tuple(kmod.route(M, K, N, dtype, aligned)) == want


@pytest.mark.parametrize("M,blocks", [(8, 128), (1024, 512)])
def test_gemm_os_tiles_fill_the_card(M, blocks):
    """At llama3.2-1b's ffn_in site (N 8192) the route's tile gives at
    least 128 blocks in decode (M 8), one per SM streaming B, and 512 in
    prefill (M 1024)."""
    r = kmod.route(M, 2048, 8192, torch.bfloat16)
    assert cdiv(M, r.block_m) * cdiv(8192, r.block_n) == blocks


def test_gemm_os_tf32x3_tiles_fill_the_card():
    """The kernel path's float32 row (256^3) runs 16 blocks of 64 x 64 on
    tf32x3, not the 4 of 128 x 128 that SIMT runs; the ffn_in site in
    float32 keeps 512 blocks of 128 x 128."""
    for (M, K, N), blocks in (((256, 256, 256), 16),
                              ((1024, 2048, 8192), 512)):
        r = kmod.route(M, K, N, torch.float32)
        assert r.kind == "tf32x3"
        assert cdiv(M, r.block_m) * cdiv(N, r.block_n) == blocks


def test_gemm_os_tf32x3_scratch():
    """The wrapper's scratch for the split operands of one panel product:
    [A_hi; A_lo] (2 Pm, K) and [B_hi^T; B_lo^T] (2 Pn, K), in float32.  At
    ffn_in the one panel is the whole product, 151 MB; at 60000^3 the
    largest panel pair (12 x 22 tiles of 128), under the 2 GiB cap."""
    assert kmod.tf32x3_scratch_floats(1024, 2048, 8192) == \
        2 * 1024 * 2048 + 2 * 8192 * 2048
    assert kmod.tf32x3_scratch_floats(60000, 60000, 60000) == \
        2 * (12 * 128 + 22 * 128) * 60000
    assert 4 * kmod.tf32x3_scratch_floats(60000, 60000, 60000) <= \
        kmod.TF32X3_SCRATCH_BYTES
    cap = 8 * 1024 * 640       # panel pairs of 5 tiles of 128 at K 1024
    assert sum(kmod._panel_scratch(kmod.tf32x3_panels(
        2048, 1024, 2048, 128, 128, cap), 1024)) <= cap // 4


def _walk_panels(M, K, N, bm, bn, cap):
    """Checks tf32x3_panels' plan: every panel product under the cap, its
    split operands in the scratch when it runs (written by it or left by
    the product before it), and every (bm x bn) tile of C covered exactly
    once.  Returns the panels."""
    panels = kmod.tf32x3_panels(M, K, N, bm, bn, cap)
    seen = np.zeros((cdiv(M, bm), cdiv(N, bn)), np.int64)
    held_a = held_b = None
    for p in panels:
        assert 8 * K * (p.m + p.n) <= cap or len(panels) == 1
        assert p.m0 % bm == 0 and p.n0 % bn == 0
        assert (p.m % bm == 0 or p.m0 + p.m == M) and \
            (p.n % bn == 0 or p.n0 + p.n == N)
        if p.split_a:
            held_a = (p.m0, p.m)
        if p.split_b:
            held_b = (p.n0, p.n)
        assert held_a == (p.m0, p.m) and held_b == (p.n0, p.n)
        seen[p.m0 // bm:cdiv(p.m0 + p.m, bm),
             p.n0 // bn:cdiv(p.n0 + p.n, bn)] += 1
    assert (seen == 1).all()
    return panels


@pytest.mark.parametrize("M,K,N,bm,cap,n_panels", [
    (1024, 2048, 8192, 128, kmod.TF32X3_SCRATCH_BYTES, 1),   # ffn_in
    (256, 256, 256, 64, kmod.TF32X3_SCRATCH_BYTES, 1),
    (60000, 60000, 60000, 128, kmod.TF32X3_SCRATCH_BYTES, 40 * 22),
    (60000, 91180, 60000, 128, kmod.TF32X3_SCRATCH_BYTES, None),
    (2048, 1024, 2048, 128, 8 * 1024 * 640, None),
    (2000, 1000, 1900, 128, 8 * 1000 * 700, None),
    (1200, 512, 1412, 64, 8 * 512 * 500, None),
    (8, 4096, 8192, 64, 8 * 4096 * 1000, None),
])
def test_tf32x3_panels_cover_every_tile_once_under_the_cap(M, K, N, bm, cap,
                                                           n_panels):
    """The panel plan covers each tile of C exactly once, keeps each panel
    product's 2 (Pm + Pn) K floats under the cap, and splits each operand
    panel before the products that read it; the ffn_in site is one
    panel, 60000^3 many (40 row panels of 12 tiles x 22 column panels of
    22, each full pair two waves of 132 tiles); small caps force panels
    at small shapes, ragged ones too."""
    panels = _walk_panels(M, K, N, bm, bm, cap)
    if n_panels is not None:
        assert len(panels) == n_panels
    else:
        assert len(panels) > 1
    if len(panels) > 1 and cap == kmod.TF32X3_SCRATCH_BYTES:
        # full panel pairs hold at least one wave of tiles
        full = [p for p in panels if p.m % bm == 0 and p.n % bm == 0
                and p.m0 + p.m < M and p.n0 + p.n < N]
        assert full and all((p.m // bm) * (p.n // bm) >= kmod.CARD_SMS
                            for p in full)


def test_tf32x3_panels_split_each_outer_panel_once():
    """At 60000^3 the column panels of B run outside (22 of them, each
    split once) and A's 40 row panels inside, split once per column
    panel: 22 M K + N K floats split, not 40 N K + M K."""
    panels = kmod.tf32x3_panels(60000, 60000, 60000, 128, 128)
    assert sum(p.split_b for p in panels) == 22
    assert sum(p.split_a for p in panels) == 22 * 40
    assert [p.n0 for p in panels] == sorted(p.n0 for p in panels)


def test_tf32x3_panels_refuse_a_cap_below_one_tile():
    with pytest.raises(ValueError, match="scratch cap"):
        kmod.tf32x3_panels(2048, 1024, 2048, 128, 128, 8 * 1024 * 255)
    assert len(kmod.tf32x3_panels(2048, 1024, 2048, 128, 128,
                                  8 * 1024 * 256)) == 256


def _tf32_bits_clear(t):
    return bool(((t.view(torch.int32) & 0x1FFF) == 0).all())


@pytest.mark.parametrize("scale", [1e-30, 1e-3, 1.0, 7.5, 1e20])
def test_split_tf32_reconstructs(scale):
    """hi and lo are TF32 numbers (low 13 bits 0) and hi + lo gives x to
    2^-22 relative; hi is x rounded to nearest, ties away from zero, as
    cvt.rna.tf32.f32 rounds: |x - hi| is at most half a TF32 ulp."""
    x = torch.from_numpy(_normal((4096,), 11) * np.float32(scale))
    hi, lo = split_tf32(x)
    assert _tf32_bits_clear(hi) and _tf32_bits_clear(lo)
    x64, hi64, lo64 = (t.double() for t in (x, hi, lo))
    assert ((hi64 + lo64 - x64).abs() <= 2.0 ** -22 * x64.abs()).all()
    assert ((x64 - hi64).abs() <= 2.0 ** -11 * x64.abs()).all()


def test_split_tf32_rounds_ties_away_and_keeps_non_finite():
    """Ties round away from zero (1 + 2^-11 to 1 + 2^-10, and its
    negative); infinities and NaN keep hi = x with lo = 0, so that lo
    never carries the NaN of inf - inf."""
    x = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 2.0 ** -12,
                      float("inf"), float("-inf"), float("nan"), 0.0])
    hi, lo = split_tf32(x)
    assert hi[:3].tolist() == [1 + 2.0 ** -10, -(1 + 2.0 ** -10), 1.0]
    assert lo[:3].tolist() == [-2.0 ** -11, 2.0 ** -11, 2.0 ** -12]
    assert hi[3] == float("inf") and hi[4] == float("-inf")
    assert torch.isnan(hi[5])
    assert lo[3:].tolist() == [0.0] * 4


@pytest.mark.parametrize("M,K,N", SHAPES + [(64, 2048, 96)])
def test_matmul_tf32x3_within_table1_tol(M, K, N):
    """Three TF32 products per term, summed in float32 per 8 k, stay
    within the Table-I float32 tolerance (rtol and atol 1e-4) of a float64
    product and of the JAX reference, at the reference's shapes and at
    K 2048 with weights at 1/sqrt(K); one TF32 product does not at K 2048
    (why the route takes three)."""
    a = _normal((M, K), M + K)
    b = _normal((K, N), K + N) / np.float32(np.sqrt(K))
    got = matmul_tf32x3(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want64 = a.astype(np.float64) @ b.astype(np.float64)
    np.testing.assert_allclose(got, want64, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, np.asarray(jax_ref(jnp.asarray(a),
                                                       jnp.asarray(b))),
                               rtol=1e-4, atol=1e-4)
    if K == 2048:
        one = (split_tf32(torch.from_numpy(a))[0]
               @ split_tf32(torch.from_numpy(b))[0]).numpy()
        assert not np.allclose(one, want64, rtol=1e-4, atol=1e-4)


def test_gemm_os_counts_launches_by_route():
    """The per-route counter has one entry per route, and CPU calls count
    in neither."""
    assert set(gemm_os.launches_by_route) == set(kmod.ROUTES)
    before = dict(gemm_os.launches_by_route)
    gemm_os(torch.ones(8, 16, dtype=torch.bfloat16),
            torch.ones(16, 8, dtype=torch.bfloat16))
    assert gemm_os.launches_by_route == before
