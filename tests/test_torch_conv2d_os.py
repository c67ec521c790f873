"""Port's output-stationary direct convolution against the JAX reference on
the CPU (the Pallas kernel in interpret mode and the plain
``conv2d_ref``), and the wrapper's CPU route and input checks.  The
kernel itself is held against its plain version on a card by
tests/test_torch_gpu.py.

Tolerance 1e-4 (rtol and atol) in float32, as tests/test_kernels.py
holds the Pallas kernel to its oracle; in bf16 one bf16 step (rtol 2^-7)
and atol 1e-4, since both round the same float32 sum once."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.conv2d_os.ops import conv2d_os as jax_conv2d_os
from repro.kernels.conv2d_os.ref import conv2d_ref as jax_ref
from repro_torch.kernels.common import cdiv
from repro_torch.kernels.conv2d_os import kernel as kmod
from repro_torch.kernels.conv2d_os.kernel import conv2d_os_cuda
from repro_torch.kernels.conv2d_os.ops import conv2d_os
from repro_torch.kernels.conv2d_os.ref import conv2d_ref

TOL = 1e-4
# tests/test_kernels.py's three shapes, then the paper's Table-I CONV as
# Listing 2 writes it: one input channel, 64 x 64 out, 3 x 3 taps, 64 out
# channels
SHAPES = [(1, 12, 12, 8, 16, 3), (2, 9, 9, 4, 32, 3), (1, 8, 8, 8, 8, 1),
          (1, 66, 66, 1, 64, 3)]


def _inputs(N, H, W, Cin, Cout, K, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, H, W, Cin)).astype(np.float32)
    w = (rng.normal(size=(K, K, Cin, Cout)) * 0.5).astype(np.float32)
    return x, w


@pytest.mark.parametrize("N,H,W,Cin,Cout,K", SHAPES)
def test_conv2d_os_matches_jax(N, H, W, Cin, Cout, K):
    x, w = _inputs(N, H, W, Cin, Cout, K, seed=H * Cin + Cout)
    before = conv2d_os.launches
    got = conv2d_os(torch.from_numpy(x), torch.from_numpy(w))
    assert conv2d_os.launches == before         # CPU tensors: plain version
    assert got.shape == (N, H - K + 1, W - K + 1, Cout)
    jx, jw = jnp.asarray(x), jnp.asarray(w)
    for want in (jax_conv2d_os(jx, jw, interpret=True), jax_ref(jx, jw)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                                   atol=TOL)


def test_conv2d_os_bf16_rounds_once():
    x, w = _inputs(2, 9, 9, 4, 32, 3, seed=5)
    got = conv2d_os(torch.from_numpy(x).to(torch.bfloat16),
                    torch.from_numpy(w).to(torch.bfloat16))
    want = jax_ref(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=2.0 ** -7, atol=TOL)


def test_conv2d_os_out_dtype():
    x, w = _inputs(1, 6, 7, 3, 5, 3, seed=6)
    got = conv2d_ref(torch.from_numpy(x), torch.from_numpy(w),
                     out_dtype=torch.bfloat16)
    want = jax_ref(jnp.asarray(x), jnp.asarray(w), jnp.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=2.0 ** -7, atol=TOL)


def test_smem_plan_matches_the_source():
    """The wrapper's shared-memory sum is the source's for the 3 x 3 taps
    of the main path (28.8 KB), and 10 x 10 taps are the most that fit."""
    assert kmod.smem_bytes(3, 3) == 4 * (18 * 18 * 8 + 9 * 8 * 64)
    assert kmod.smem_bytes(10, 10) <= kmod.MAX_SMEM < kmod.smem_bytes(11, 11)


@pytest.mark.parametrize("change,error,match", [
    (dict(x=torch.float16), TypeError, "float32 or bfloat16"),
    (dict(w=torch.bfloat16), TypeError, "one dtype"),
    (dict(out_dtype=torch.float16), TypeError, "writes float32"),
    (dict(w_shape=(3, 3, 5, 8)), ValueError, "shapes"),
    (dict(w_shape=(11, 3, 4, 8)), ValueError, "shapes"),
    (dict(w_shape=(3, 3, 4)), ValueError, "shapes"),
    (dict(w_shape=(3, 3, 4, 0)), ValueError, "nonempty"),
    (dict(x_shape=(1, 40, 40, 4), w_shape=(11, 11, 4, 8)), ValueError,
     "shared memory"),
    (dict(), ValueError, "CUDA device"),
])
def test_conv2d_os_kernel_rejects(change, error, match):
    """The kernel's wrapper refuses what the kernel does not take, before
    it builds or launches anything: another dtype, mismatched shapes, taps
    larger than the image or than shared memory holds, or tensors off the
    card (CPU tensors here)."""
    x = torch.ones(change.get("x_shape", (2, 9, 9, 4)))
    w = torch.ones(change.get("w_shape", (3, 3, 4, 8)))
    x = x.to(change.get("x", torch.float32))
    w = w.to(change.get("w", torch.float32))
    kwargs = {"out_dtype": change["out_dtype"]} if "out_dtype" in change \
        else {}
    with pytest.raises(error, match=match):
        conv2d_os_cuda(x, w, **kwargs)


@pytest.mark.parametrize("K", range(1, 11))
def test_every_tap_size_up_to_10_fits(K):
    """Both routes take every square and non-square tap size up to 10 x 10
    within a block's shared memory, and the tensor-core sum is the
    source's: 2 patch buffers of (16 + K - 1)^2 pixels at 144 bytes and 2
    weight stages of 64 rows at 144 bytes (109 KB at 3 x 3)."""
    for kh, kw in ((K, K), (K, 1), (1, K), (K, 10)):
        assert kmod.smem_bytes(kh, kw) <= kmod.MAX_SMEM
        assert kmod.tc_smem_bytes(kh, kw) <= kmod.MAX_SMEM
    assert kmod.tc_smem_bytes(K, K) == 2 * ((15 + K) ** 2 * 144 + 64 * 144)


@pytest.mark.parametrize("Cin,Cout,dtype,aligned,want", [
    (64, 64, torch.bfloat16, True, "tensor_core"),
    (32, 96, torch.bfloat16, True, "tensor_core"),
    (8, 8, torch.bfloat16, True, "tensor_core"),
    (1, 64, torch.bfloat16, True, "simt"),       # Listing 2
    (13, 72, torch.bfloat16, True, "simt"),
    (64, 3, torch.bfloat16, True, "simt"),
    (64, 64, torch.bfloat16, False, "simt"),
    (64, 64, torch.float32, True, "simt"),
])
def test_conv2d_os_route(Cin, Cout, dtype, aligned, want):
    """The tensor-core route takes bf16 with Cin and Cout multiples of 8
    (whole 16-byte cp.async groups) and aligned pointers; float32 and the
    rest run on SIMT.  Each route's tile and shared memory come with it."""
    r = kmod.route(Cin, Cout, 3, 3, dtype, aligned)
    assert r.kind == want
    if want == "tensor_core":
        assert (r.tile, r.block_co, r.smem) == ((16, 16), 64,
                                                kmod.tc_smem_bytes(3, 3))
    else:
        assert (r.tile, r.block_co, r.smem) == ((16, 16), 64,
                                                kmod.smem_bytes(3, 3))


@pytest.mark.parametrize("KH,KW,want", [
    (10, 10, "tensor_core"), (1, 31, "tensor_core"),
    (1, 32, "simt"), (1, 40, "simt"), (40, 1, "simt"), (1, 87, "simt"),
])
def test_conv2d_os_route_wide_taps(KH, KW, want):
    """Aligned bf16 taps whose tensor-core patch buffers would not fit in
    shared memory (1 x 32 and wider) go to the SIMT block, which still
    takes them."""
    r = kmod.route(64, 64, KH, KW, torch.bfloat16)
    assert r.kind == want and r.smem <= kmod.MAX_SMEM


def test_conv2d_os_route_takes_every_simt_tap():
    """Every tap size the SIMT block fits (all PR 13's kernel accepted)
    gets a route whose block fits, for every dtype and alignment."""
    for kh in range(1, 100):
        for kw in range(1, 100):
            if kmod.smem_bytes(kh, kw) > kmod.MAX_SMEM:
                continue
            for dtype in (torch.bfloat16, torch.float32):
                for aligned in (True, False):
                    r = kmod.route(64, 64, kh, kw, dtype, aligned)
                    assert r.smem <= kmod.MAX_SMEM, (kh, kw, dtype, r)


def test_conv2d_os_main_path_blocks():
    """The batched Table-I CONV (N 32, 64 x 64 out, 64 channels) launches
    32 x 4 x 4 = 512 tensor-core blocks, two to an SM."""
    r = kmod.route(64, 64, 3, 3, torch.bfloat16)
    (th, tw), bco = r.tile, r.block_co
    assert 32 * cdiv(64, th) * cdiv(64, tw) * cdiv(64, bco) == 512
    assert 2 * (r.smem + 1024) <= 233472    # an SM's shared memory
