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
