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
])
def test_gemm_os_route(M, K, N, dtype, aligned, want):
    """The tensor-core route takes bf16 with K and N multiples of 8 (TMA's
    16-byte row strides) and aligned pointers, with the 64 x 64 tile up
    to M 64 and 128 x 128 above; tf32x3 takes float32 with K and N
    multiples of 4 (16-byte rows) and aligned pointers, with the 64 x 64
    tile up to M 64 and wherever 128 x 128 tiles would be fewer than the
    card's 132 SMs; the rest run on SIMT."""
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
    """The wrapper's scratch for the split operands: [A_hi; A_lo] (2M, K)
    and [B_hi^T; B_lo^T] (2N, K), in float32."""
    assert kmod.tf32x3_scratch_floats(1024, 2048, 8192) == \
        2 * 1024 * 2048 + 2 * 8192 * 2048


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
