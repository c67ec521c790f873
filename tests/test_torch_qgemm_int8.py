"""Port's int8 quantized GEMM and its quantization helpers against the JAX
reference on the CPU (the Pallas kernel in interpret mode and the plain
``qgemm_ref``), and the wrapper's CPU route and input checks.  The kernel
itself is held against its plain version on a card by
tests/test_torch_gpu.py.

Every comparison is word for word: the int32 accumulator is exact, and
the float32 epilogue multiplies by the row's scale, then the column's,
in both, with the same rounding; quantization rounds half to even in
both."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.qgemm_int8.ops import qgemm_int8 as jax_qgemm_int8
from repro.kernels.qgemm_int8.ref import qgemm_ref as jax_ref
from repro.kernels.qgemm_int8.ref import quantize_rowwise as jax_quantize
from repro.kernels.qgemm_int8.ref import requantize_ref as jax_requantize
from repro_torch.kernels.qgemm_int8 import kernel as kmod
from repro_torch.kernels.qgemm_int8.kernel import K_MAX, qgemm_int8_cuda
from repro_torch.kernels.qgemm_int8.ops import qgemm_int8
from repro_torch.kernels.qgemm_int8.ref import (int_matmul_ref, qgemm_ref,
                                                quantize_rowwise,
                                                requantize_ref)


def _normal(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _quantized(M, K, N, seed):
    """int8 a (M, K), b (K, N) and their float32 scales, quantized from
    normals by the JAX package's quantize_rowwise, as
    tests/test_kernels.py draws them."""
    a, sa = jax_quantize(jnp.asarray(_normal((M, K), seed)))
    bq, sb = jax_quantize(jnp.asarray(_normal((N, K), seed + 1)))
    return [np.array(x) for x in (a, bq.T, sa, sb)]


@pytest.mark.parametrize("M,K,N", [(64, 128, 64), (100, 96, 56)])
def test_qgemm_int8_matches_jax(M, K, N):
    a, b, sa, sb = _quantized(M, K, N, seed=M + K)
    before = qgemm_int8.launches
    got = qgemm_int8(*(torch.from_numpy(x) for x in (a, b, sa, sb)))
    assert qgemm_int8.launches == before        # CPU tensors: plain version
    assert got.dtype == torch.float32 and got.shape == (M, N)
    ja, jb, jsa, jsb = (jnp.asarray(x) for x in (a, b, sa, sb))
    for want in (jax_qgemm_int8(ja, jb, jsa, jsb, interpret=True),
                 jax_ref(ja, jb, jsa, jsb)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_qgemm_int8_exact_vs_int_math():
    """With unit scales the output is the int32 product itself."""
    rng = np.random.default_rng(0)
    a = rng.integers(-127, 127, (32, 64)).astype(np.int8)
    b = rng.integers(-127, 127, (64, 48)).astype(np.int8)
    got = qgemm_int8(torch.from_numpy(a), torch.from_numpy(b),
                     torch.ones(32), torch.ones(48))
    want = a.astype(np.int32) @ b.astype(np.int32)
    np.testing.assert_array_equal(got.numpy().astype(np.int64),
                                  want.astype(np.int64))
    jax_got = jax_qgemm_int8(jnp.asarray(a), jnp.asarray(b),
                             jnp.ones((32,), jnp.float32),
                             jnp.ones((48,), jnp.float32), interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_got))


@pytest.mark.parametrize("K", [1, 1024, 4096])
def test_int_matmul_ref_is_exact(K):
    """The plain accumulator is exact where float32 would not be: at
    K = 1024 and 4096 the extreme rows sum past 2^24, and -128 is in
    range."""
    rng = np.random.default_rng(K)
    a = rng.integers(-128, 128, (5, K)).astype(np.int8)
    b = rng.integers(-128, 128, (K, 7)).astype(np.int8)
    a[0], b[:, 0], b[:, 1] = 127, 127, -128
    got = int_matmul_ref(torch.from_numpy(a), torch.from_numpy(b))
    want = a.astype(np.int64) @ b.astype(np.int64)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().astype(np.int64), want)


def test_quantize_rowwise_matches_jax():
    """Same int8 values and bit-identical scales, with a zero row (scale
    1) and values that land on .5 after the division (half to even)."""
    x = _normal((9, 33), 7) * 3
    x[4] = 0.0
    x[5, 0], x[5, 1:] = 127.0, np.arange(32) - 15.5    # scale 1: k + 0.5
    q, s = quantize_rowwise(torch.from_numpy(x))
    assert q[5, 1:].tolist() == np.round(x[5, 1:]).tolist()   # half to even
    jq, js = jax_quantize(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert s[4] == 1.0


@pytest.mark.parametrize("mult,shift,qmin,qmax", [(3, 2, -127, 127),
                                                  (1 << 14, 20, -127, 127),
                                                  (77, 5, -8, 7)])
def test_requantize_ref_matches_jax(mult, shift, qmin, qmax):
    """On numpy int32 arrays, on JAX arrays and on torch int32 tensors,
    arithmetic shift and clamp give the same integers."""
    acc = np.random.default_rng(mult).integers(-2 ** 20, 2 ** 20,
                                               (6, 11)).astype(np.int32)
    want = jax_requantize(acc, mult, shift, qmin, qmax)
    np.testing.assert_array_equal(requantize_ref(acc, mult, shift, qmin,
                                                 qmax), want)
    np.testing.assert_array_equal(
        np.asarray(jax_requantize(jnp.asarray(acc), mult, shift, qmin,
                                  qmax)), want)
    got = requantize_ref(torch.from_numpy(acc), mult, shift, qmin, qmax)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_qgemm_int8_k_too_large_is_refused():
    """K past (2^31 - 1) / 128^2 could wrap the int32 accumulator: refused
    on the CPU route as on the card's.  At the limit, every a and b at -128
    sums to K * 128^2, the largest the accumulator must hold, and it holds
    it exactly."""
    assert K_MAX == 131071 and K_MAX * 128 ** 2 <= 2 ** 31 - 1 \
        < (K_MAX + 1) * 128 ** 2
    K = K_MAX + 1
    a = torch.full((1, K), -128, dtype=torch.int8)
    b = torch.full((K, 1), -128, dtype=torch.int8)
    with pytest.raises(ValueError, match="wrap"):
        qgemm_int8(a, b, torch.ones(1), torch.ones(1))
    with pytest.raises(ValueError, match="wrap"):
        qgemm_int8_cuda(a, b, torch.ones(1), torch.ones(1))
    a, b = a[:, :K_MAX], b[:K_MAX]
    assert int_matmul_ref(a, b).item() == K_MAX * 128 ** 2
    assert qgemm_int8(a, b, torch.ones(1), torch.ones(1)).item() == \
        float(K_MAX * 128 ** 2)


def test_qgemm_int8_other_device_raises():
    a = torch.zeros(2, 3, dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        qgemm_int8(a, torch.zeros(3, 2, dtype=torch.int8, device="meta"),
                   torch.ones(2, device="meta"), torch.ones(2, device="meta"))


@pytest.mark.parametrize("change,error,match", [
    (dict(a=torch.int32), TypeError, "int8 a/b"),
    (dict(b=torch.uint8), TypeError, "int8 a/b"),
    (dict(a_scale=torch.bfloat16), TypeError, "float32 scales"),
    (dict(b_scale=torch.float64), TypeError, "float32 scales"),
    (dict(out_dtype=torch.int32), TypeError, "writes float32"),
    (dict(b_shape=(7, 4)), ValueError, "shapes"),
    (dict(a_scale_shape=(4,)), ValueError, "shapes"),
    (dict(b_scale_shape=(1, 4)), ValueError, "shapes"),
    (dict(), ValueError, "CUDA device"),
])
def test_qgemm_int8_kernel_rejects(change, error, match):
    """The kernel's wrapper refuses what the kernel does not take, before
    it builds or launches anything: other dtypes, mismatched shapes, or
    tensors off the card (CPU tensors here)."""
    a = torch.ones(3, 6, dtype=change.get("a", torch.int8))
    b = torch.ones(change.get("b_shape", (6, 4)),
                   dtype=change.get("b", torch.int8))
    sa = torch.ones(change.get("a_scale_shape", (3,)),
                    dtype=change.get("a_scale", torch.float32))
    sb = torch.ones(change.get("b_scale_shape", (4,)),
                    dtype=change.get("b_scale", torch.float32))
    kwargs = {"out_dtype": change["out_dtype"]} if "out_dtype" in change \
        else {}
    with pytest.raises(error, match=match):
        qgemm_int8_cuda(a, b, sa, sb, **kwargs)


@pytest.mark.parametrize("M,K,N,dtype,aligned,want", [
    (1024, 2048, 8192, torch.int8, True, "tensor_core"),   # ffn_in site
    (200, 2064, 1040, torch.int8, True, "tensor_core"),    # ragged M, tiles
    (1, 16, 16, torch.int8, True, "tensor_core"),
    (K_MAX // 16 * 16, K_MAX // 16 * 16, 16, torch.int8, True, "tensor_core"),
    (64, K_MAX, 64, torch.int8, True, "simt"),             # K % 16 != 0
    (100, 96, 56, torch.int8, True, "simt"),               # N % 16 != 0
    (33, 37, 129, torch.int8, True, "simt"),
    (1024, 2048, 8192, torch.int8, False, "simt"),         # unaligned base
    (1024, 2048, 8192, torch.uint8, True, "simt"),         # wrong dtype
    (1024, 2048, 8192, torch.int32, True, "simt"),
])
def test_qgemm_int8_route(M, K, N, dtype, aligned, want):
    """The tensor-core route takes int8 with K and N multiples of 16 (TMA's
    16-byte row strides) and 16-byte aligned pointers, at any M; every
    other call runs on SIMT, which refuses a wrong dtype as before."""
    assert kmod.route(M, K, N, dtype, aligned) == want


def test_qgemm_int8_counts_launches_by_route():
    """The per-route counter has one entry per route, and CPU calls count
    on none."""
    assert set(qgemm_int8.launches_by_route) == set(kmod.ROUTES)
    before = dict(qgemm_int8.launches_by_route)
    a = torch.ones(4, 16, dtype=torch.int8)
    qgemm_int8(a, torch.ones(16, 16, dtype=torch.int8), torch.ones(4),
               torch.ones(16))
    assert qgemm_int8.launches_by_route == before
