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
from repro_torch.kernels.conv2d_os.ref import conv2d_ref, conv2d_tf32x3

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
    (dict(kind="tiled"), ValueError, "kind"),
    (dict(), ValueError, "CUDA device"),
    (dict(kind="tf32x3"), ValueError, "CUDA device"),
])
def test_conv2d_os_kernel_rejects(change, error, match):
    """The kernel's wrapper refuses what the kernel does not take, before
    it builds or launches anything: another dtype, mismatched shapes, taps
    larger than the image, empty channels, or tensors off the card (CPU
    tensors here)."""
    x = torch.ones(change.get("x_shape", (2, 9, 9, 4)))
    w = torch.ones(change.get("w_shape", (3, 3, 4, 8)))
    x = x.to(change.get("x", torch.float32))
    w = w.to(change.get("w", torch.float32))
    kwargs = {k: change[k] for k in ("out_dtype", "kind") if k in change}
    with pytest.raises(error, match=match):
        conv2d_os_cuda(x, w, **kwargs)


@pytest.mark.parametrize("K", range(1, 11))
def test_every_tap_size_up_to_10_fits(K):
    """The SIMT and both tensor-core routes take every square and
    non-square tap size up to 10 x 10 within a block's shared memory, and
    the bf16 tensor-core sum is the source's: 2 patch buffers of (16 + K -
    1)^2 pixels at 144 bytes and 2 weight stages of 64 rows at 144 bytes
    (109 KB at 3 x 3)."""
    for kh, kw in ((K, K), (K, 1), (1, K), (K, 10)):
        assert kmod.smem_bytes(kh, kw) <= kmod.MAX_SMEM
        assert kmod.tc_smem_bytes(kh, kw) <= kmod.MAX_SMEM
        assert kmod.tf32_smem_bytes(kh, kw) <= kmod.MAX_SMEM
    assert kmod.tc_smem_bytes(K, K) == 2 * ((15 + K) ** 2 * 144 + 64 * 144)


@pytest.mark.parametrize("Cin,Cout,dtype,aligned,want", [
    (64, 64, torch.bfloat16, True, "tensor_core"),
    (32, 96, torch.bfloat16, True, "tensor_core"),
    (8, 8, torch.bfloat16, True, "tensor_core"),
    (1, 64, torch.bfloat16, True, "simt"),       # Listing 2
    (13, 72, torch.bfloat16, True, "simt"),
    (64, 3, torch.bfloat16, True, "simt"),
    (64, 64, torch.bfloat16, False, "simt"),
    (64, 64, torch.float32, True, "tf32x3"),
    (4, 12, torch.float32, True, "simt"),        # below MIN_TF32_CIN
    (12, 4, torch.float32, True, "tf32x3"),
    (1, 64, torch.float32, True, "simt"),        # Listing 2
    (13, 72, torch.float32, True, "simt"),
    (64, 6, torch.float32, True, "simt"),
    (64, 64, torch.float32, False, "simt"),
])
def test_conv2d_os_route(Cin, Cout, dtype, aligned, want):
    """The tensor-core route takes bf16 with Cin and Cout multiples of 8
    (whole 16-byte cp.async groups) and aligned pointers; tf32x3 takes
    float32 with Cin and Cout multiples of 4 (16 bytes), Cin at least
    MIN_TF32_CIN and aligned pointers; the rest run on SIMT.  Each route's
    tile and shared memory come with it."""
    r = kmod.route(Cin, Cout, 3, 3, dtype, aligned)
    assert r.kind == want
    if want == "tensor_core":
        assert (r.tile, r.block_co, r.smem) == ((16, 16), 64,
                                                kmod.tc_smem_bytes(3, 3))
    elif want == "tf32x3":
        assert (r.tile, r.block_co, r.smem) == ((16, 16), 64,
                                                kmod.tf32_smem_bytes(3, 3))
    else:
        assert (r.tile, r.block_co, r.smem) == ((16, 16), 64,
                                                kmod.smem_bytes(3, 3))


@pytest.mark.parametrize("Cout", [4, 16, 64, 68])
@pytest.mark.parametrize("Cin,want", [
    (4, "simt"), (8, "simt"), (12, "tf32x3"), (16, "tf32x3"),
    (20, "tf32x3"), (32, "tf32x3"), (48, "tf32x3"), (64, "tf32x3")])
def test_conv2d_os_route_float32_by_input_channels(Cin, Cout, want):
    """Aligned float32 takes tf32x3 from MIN_TF32_CIN = 12 input channels
    on, whatever Cout: below it a tf32x3 step (32 channels) is mostly
    padding and the SIMT kernel (8 a step) is the faster one on the card.
    Each route keeps its tile and shared memory."""
    assert kmod.MIN_TF32_CIN == 12
    r = kmod.route(Cin, Cout, 3, 3, torch.float32)
    smem = {"simt": kmod.smem_bytes(3, 3),
            "tf32x3": kmod.tf32_smem_bytes(3, 3)}
    assert (r.kind, r.tile, r.block_co, r.smem) == (want, (16, 16), 64,
                                                    smem[want])


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


@pytest.mark.parametrize("KH,KW,want", [
    (3, 3, "tf32x3"), (10, 10, "tf32x3"), (1, 24, "tf32x3"),
    (24, 1, "tf32x3"), (1, 25, "simt"), (1, 87, "simt"), (40, 1, "simt"),
    (11, 11, "stream"), (1, 88, "stream"), (100, 1, "stream"),
])
def test_conv2d_os_route_float32_taps(KH, KW, want):
    """Aligned float32 at 64 channels: tf32x3 for every tap whose two
    patch buffers and three weight stages fit in shared memory (up to 10 x
    10, 1 x 24); wider taps on SIMT, and past SIMT's block on the
    streaming route."""
    r = kmod.route(64, 64, KH, KW, torch.float32)
    assert r.kind == want and r.smem <= kmod.MAX_SMEM


def test_tf32_smem_plan_matches_the_source():
    """The wrapper's tf32x3 sum is the source's: 2 patch buffers of
    (16 + KH - 1) x (16 + KW - 1) pixels at 144 bytes (32 float32 and 16
    of padding) and 3 weight stages of a hi and a lo tile of 32 x 64
    float32: 139 KB at 3 x 3; 10 x 10 taps are the most that fit."""
    assert kmod.tf32_smem_bytes(3, 3) == \
        2 * 18 * 18 * 144 + 3 * 2 * 32 * 64 * 4
    assert kmod.tf32_smem_bytes(10, 10) <= kmod.MAX_SMEM < \
        kmod.tf32_smem_bytes(11, 11)


@pytest.mark.parametrize("KH,KW,Cin,Cout,floats", [
    (3, 3, 64, 64, 9 * 2 * 1 * 4096),
    (5, 5, 12, 68, 25 * 1 * 2 * 4096),
    (1, 1, 4, 4, 4096),
])
def test_tf32_scratch_holds_the_split_weights(KH, KW, Cin, Cout, floats):
    """The split weights' scratch: a hi and a lo tile of 32 input x 64
    output channels per (tap, chunk of 32 input channels, tile of 64
    output channels), padded with zeros."""
    assert kmod.tf32x3_scratch_floats(KH, KW, Cin, Cout) == floats


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


def test_conv2d_os_main_path_blocks_float32():
    """In float32 the batched Table-I CONV runs the same 512 blocks of 16 x
    16 pixels x 64 channels on tf32x3, one (of 16 warps) to an SM."""
    r = kmod.route(64, 64, 3, 3, torch.float32)
    (th, tw), bco = r.tile, r.block_co
    assert r.kind == "tf32x3"
    assert 32 * cdiv(64, th) * cdiv(64, tw) * cdiv(64, bco) == 512
    assert r.smem + 1024 <= 233472


@pytest.mark.parametrize("N,H,W,Cin,Cout,K", SHAPES + [(2, 10, 11, 64, 8, 3)])
def test_conv2d_tf32x3_within_table1_tol(N, H, W, Cin, Cout, K):
    """The tf32x3 route's arithmetic (per tap, three TF32 products per 8
    channels summed in float32) within the Table-I float32 tolerance of a
    float64 convolution and of the JAX reference, at the reference's
    shapes and at 64 channels."""
    x, w = _inputs(N, H, W, Cin, Cout, K, seed=H * Cin + Cout)
    got = conv2d_tf32x3(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    OH, OW = H - K + 1, W - K + 1
    want64 = sum(np.einsum("nhwc,co->nhwo",
                           x[:, kh:kh + OH, kw:kw + OW].astype(np.float64),
                           w[kh, kw].astype(np.float64))
                 for kh in range(K) for kw in range(K))
    np.testing.assert_allclose(got, want64, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, np.asarray(jax_ref(jnp.asarray(x),
                                                       jnp.asarray(w))),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("KH,KW", [(11, 11), (16, 16), (1, 88), (40, 3),
                                   (33, 40)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv2d_os_route_streams_taps_past_shared_memory(KH, KW, dtype):
    """Taps whose SIMT block would not fit in shared memory (11 x 11 and
    larger) go to the streaming route when the tensor-core route does not
    take them (float32, or Cin not a multiple of 8), with a block of one
    fixed size within a block's shared memory, whatever the taps."""
    assert kmod.smem_bytes(KH, KW) > kmod.MAX_SMEM
    r = kmod.route(13, 64, KH, KW, dtype)
    assert r.kind == "stream" and r.tile == (16, 16) and r.block_co == 64
    assert r.smem == kmod.stream_smem_bytes() == \
        4 * (16 * 31 * 8 + 16 * 8 * 64) <= 48 * 1024


@pytest.mark.parametrize("x_shape,w_shape", [
    ((1, 40, 40, 4), (11, 11, 4, 8)),        # taps past shared memory
    ((65536, 4, 4, 8), (3, 3, 8, 16)),       # a batch past grid.z
])
def test_conv2d_os_kernel_takes_any_taps_and_batch(x_shape, w_shape):
    """Neither a batch past 65535 images nor taps past a SIMT block's
    shared memory is refused: the wrapper's only objection to these CPU
    tensors is that they are not on the card."""
    x, w = torch.zeros(x_shape), torch.zeros(w_shape)
    with pytest.raises(ValueError, match="CUDA device"):
        conv2d_os_cuda(x, w)


def test_conv2d_os_large_taps_plain_matches_jax():
    """The plain version at taps that need the streaming route (12 x 11,
    Cin 3) against JAX's ``conv2d_ref``: what the streaming kernel is held
    to on the card."""
    x, w = _inputs(2, 20, 19, 3, 5, 12, seed=21)
    w = w[:, :11]
    got = conv2d_ref(torch.from_numpy(x), torch.from_numpy(np.ascontiguousarray(w)))
    want = jax_ref(jnp.asarray(x), jnp.asarray(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
