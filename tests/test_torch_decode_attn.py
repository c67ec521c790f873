"""Port's decode attention against the JAX reference (plain version and
Pallas kernel in interpret mode), and the wrapper's CPU route and split
plan.  The kernel itself is held against its plain version on a card by
tests/test_torch_gpu.py.

Tolerance 2e-4 (rtol and atol) in float32, as tests/test_kernels.py holds
the Pallas kernel to its oracle."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attn.ops import decode_attn as jax_decode_attn
from repro.kernels.decode_attn.ref import decode_attn_ref as jax_ref
from repro_torch.kernels.common import cdiv, pad_to
from repro_torch.kernels.decode_attn import kernel as kmod
from repro_torch.kernels.decode_attn.ops import decode_attn
from repro_torch.kernels.decode_attn.ref import decode_attn_ref

TOL = 2e-4
SHAPES = [(2, 8, 2, 256, 64, 64), (1, 4, 4, 128, 32, 128),
          (3, 6, 1, 192, 64, 64), (2, 8, 2, 1000, 64, 512)]


def _inputs(B, H, Hkv, S, D, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, D)).astype(np.float32)
    k = rng.normal(size=(B, Hkv, S, D)).astype(np.float32)
    v = rng.normal(size=(B, Hkv, S, D)).astype(np.float32)
    lens = rng.integers(1, S + 1, (B,)).astype(np.int32)
    return q, k, v, lens


@pytest.mark.parametrize("B,H,Hkv,S,D,bs", SHAPES)
def test_decode_attn_matches_jax(B, H, Hkv, S, D, bs):
    q, k, v, lens = _inputs(B, H, Hkv, S, D, seed=S + B)
    before = decode_attn.launches
    got = decode_attn(*(torch.from_numpy(a) for a in (q, k, v, lens)))
    assert decode_attn.launches == before    # CPU tensors: plain version
    jq, jk, jv, jl = (jnp.asarray(a) for a in (q, k, v, lens))
    want_ref = np.asarray(jax_ref(jq, jk, jv, jl))
    want_kernel = np.asarray(jax_decode_attn(jq, jk, jv, jl, bs=bs,
                                             interpret=True))
    np.testing.assert_allclose(got.numpy(), want_ref, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.numpy(), want_kernel, rtol=TOL, atol=TOL)


def test_ref_is_the_cpu_route():
    q, k, v, lens = (torch.from_numpy(a)
                     for a in _inputs(2, 8, 2, 64, 32, seed=1))
    torch.testing.assert_close(decode_attn(q, k, v, lens),
                               decode_attn_ref(q, k, v, lens),
                               rtol=0, atol=0)


def test_unsupported_device_raises():
    q = torch.zeros((1, 4, 32), device="meta")
    k = torch.zeros((1, 2, 8, 32), device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        decode_attn(q, k, k, torch.ones(1, dtype=torch.int32))


@pytest.mark.parametrize("S,dtype,want", [
    (2048, torch.bfloat16, (16, 128)), (1000, torch.bfloat16, (16, 64)),
    (2048, torch.float32, (16, 128)), (1, torch.bfloat16, (1, 64)),
    (100000, torch.float32, (17, 5888))])
def test_split_plan(S, dtype, want):
    # B=8, Hkv=8, D=64 on a 132-SM card: about 8 split blocks per SM
    splits, chunk = kmod.split_plan(8, 8, S, 64, dtype, n_sms=132)
    assert (splits, chunk) == want
    assert splits * chunk >= S > (splits - 1) * chunk


def test_pad_to_and_cdiv():
    x = torch.arange(6.0).reshape(2, 3)
    padded, n = pad_to(x, 1, 4)
    assert n == 3 and padded.shape == (2, 4) and padded[:, 3].eq(0).all()
    assert pad_to(x, 0, 2)[0] is x
    assert pad_to(x, -1, 4)[0].shape == (2, 4)
    assert cdiv(7, 2) == 4 and cdiv(8, 2) == 4


@pytest.mark.parametrize("D,G,dtype,aligned,want", [
    (64, 4, torch.bfloat16, True, "tensor_core"),    # llama3.2-1b decode
    (128, 8, torch.bfloat16, True, "tensor_core"),
    (16, 1, torch.bfloat16, True, "tensor_core"),
    (32, 2, torch.bfloat16, True, "tensor_core"),
    (64, 4, torch.float32, True, "simt"),            # TF32 would break 2e-4
    (64, 4, torch.bfloat16, False, "simt"),          # unaligned q/k/v
    (48, 4, torch.bfloat16, True, "simt"),           # head_dim not built
    (64, 3, torch.bfloat16, True, "tensor_core"),    # any group: one tile
    (64, 4, torch.float16, True, "simt"),            # wrong dtype
])
def test_decode_attn_route(D, G, dtype, aligned, want):
    """The tensor-core route takes bf16 at every head_dim the kernels are
    built for and any group size, with 16-byte aligned q/k/v; float32 and
    every other call run on SIMT, which refuses what it cannot take."""
    assert kmod.route(D, G, dtype, aligned) == want


@pytest.mark.parametrize("S,want", [(2048, (4, 512)), (1000, (4, 256)),
                                    (1, (1, 256)), (100000, (4, 25024))])
def test_split_plan_tc(S, want):
    """B=8, Hkv=8 on a 132-SM card: as many splits as keep 2 blocks an SM
    resident, each a whole number of 64-key steps and at least 256 rows."""
    splits, chunk = kmod.split_plan_tc(8, 8, S, n_sms=132)
    assert (splits, chunk) == want
    assert splits * chunk >= S > (splits - 1) * chunk
    assert chunk % kmod.TC_TILE == 0 and chunk >= kmod.TC_MIN_CHUNK


def test_decode_attn_counts_launches_by_route():
    """The per-route counter has one entry per route, and CPU calls count
    on none."""
    assert set(decode_attn.launches_by_route) == set(kmod.ROUTES)
    before = dict(decode_attn.launches_by_route)
    q, k, v, lens = (torch.from_numpy(a)
                     for a in _inputs(1, 4, 2, 32, 16, seed=2))
    decode_attn(q, k, v, lens)
    assert decode_attn.launches_by_route == before


def _jax_ref(q, k, v, lens):
    return np.asarray(jax_ref(*(jnp.asarray(a) for a in (q, k, v, lens))))


@pytest.mark.parametrize("S", [256, 600, 1000, 1024])
def test_decode_attn_length_zero_matches_jax(S):
    """A row of length 0 masks every logit, so the reference's softmax is
    uniform: the row is the mean of its V over all S rows.  The CPU route
    gives JAX's decode_attn_ref, at S a multiple of the Pallas wrapper's
    512-row block and not (where that wrapper pads S and departs from its
    own oracle; ROADMAP C7)."""
    B, H, Hkv, D = 3, 8, 2, 32
    q, k, v, _ = _inputs(B, H, Hkv, S, D, seed=S)
    lens = np.array([0, S // 3, 0], np.int32)
    got = decode_attn(*(torch.from_numpy(a) for a in (q, k, v, lens)))
    np.testing.assert_allclose(got.numpy(), _jax_ref(q, k, v, lens),
                               rtol=TOL, atol=TOL)
    mean = v.mean(axis=2).repeat(H // Hkv, axis=1)     # (B, H, D)
    np.testing.assert_allclose(got.numpy()[[0, 2]], mean[[0, 2]],
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("G,Hkv", [(3, 8), (5, 8), (48, 1)])
def test_decode_attn_groups_match_jax(G, Hkv):
    """Group sizes of llama3.2-3b (24 / 8), llama4-maverick (40 / 8) and
    granite-34b (48 / 1): the CPU route against JAX's plain version and
    its Pallas kernel in interpret mode, ragged lengths and a row of
    length 0 included."""
    B, S, D = 3, 256, 64
    q, k, v, _ = _inputs(B, G * Hkv, Hkv, S, D, seed=G)
    lens = np.array([S, 77, 0], np.int32)
    got = decode_attn(*(torch.from_numpy(a) for a in (q, k, v, lens)))
    np.testing.assert_allclose(got.numpy(), _jax_ref(q, k, v, lens),
                               rtol=TOL, atol=TOL)
    jq, jk, jv, jl = (jnp.asarray(a) for a in (q, k, v, lens))
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jax_decode_attn(jq, jk, jv, jl, bs=128,
                                                interpret=True)),
        rtol=TOL, atol=TOL)


@pytest.mark.parametrize("G,kind,tile,tiles", [
    (4, "tensor_core", 4, 1), (3, "tensor_core", 4, 1),
    (5, "tensor_core", 8, 1), (12, "tensor_core", 16, 1),
    (48, "tensor_core", 16, 3), (1, "simt", 1, 1), (3, "simt", 4, 1),
    (5, "simt", 8, 1), (48, "simt", 8, 6)])
def test_group_tile(G, kind, tile, tiles):
    """A block serves the smallest built tile of query heads that holds
    the group (one m16 tile of up to 16 on the tensor cores, up to 8 on
    SIMT); a larger group runs as several tiles, the last one padded."""
    assert kmod.group_tile(G, kind) == tile
    assert cdiv(G, tile) == tiles
    assert tile in kmod.TILES[kind]


@pytest.mark.parametrize("G", [3, 5, 48])
@pytest.mark.parametrize("dtype,want", [(torch.bfloat16, "tensor_core"),
                                        (torch.float32, "simt")])
def test_decode_attn_route_any_group(G, dtype, want):
    """G 3, 5 and 48 run on the card: bf16 on the tensor cores, float32 on
    SIMT, at every built head_dim."""
    for D in kmod.HEAD_DIMS:
        assert kmod.route(D, G, dtype) == want


def test_plan_counts_group_tiles():
    """A group of several tiles has that many blocks per (batch, KV head)
    and split, so the split plan sees them: granite-34b's 48 heads on one
    KV head plan as 3 tensor-core or 6 SIMT tiles; a one-tile group plans
    as before."""
    assert kmod.plan("tensor_core", 8, 1, 48, 2048, 128, torch.bfloat16,
                     132) == kmod.split_plan_tc(8, 3, 2048, 132)
    assert kmod.plan("simt", 8, 1, 48, 2048, 128, torch.float32, 132) == \
        kmod.split_plan(8, 6, 2048, 128, torch.float32, 132)
    assert kmod.plan("tensor_core", 8, 8, 4, 2048, 64, torch.bfloat16,
                     132) == (4, 512)       # llama3.2-1b serving, unchanged
