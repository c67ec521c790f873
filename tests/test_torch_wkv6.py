"""Port's WKV6 recurrence against the JAX reference on the CPU (the plain
``wkv6_ref`` and the model's ``_wkv6_scan``; the Pallas kernel does not
run on this JAX), and the wrapper's CPU route and input checks.  The
kernel itself is held against its plain version on a card by
tests/test_torch_gpu.py.

Tolerance 1e-5 (rtol and atol) on output and state in float32, as
tests/test_kernels.py holds the Pallas kernel to its oracle."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.wkv6.ref import wkv6_ref as jax_ref
from repro.models.rwkv6 import _wkv6_scan as jax_scan
from repro_torch.kernels.wkv6.kernel import wkv6_cuda
from repro_torch.kernels.wkv6.ops import wkv6
from repro_torch.kernels.wkv6.ref import wkv6_ref

TOL = 1e-5
SHAPES = [(2, 32, 3, 16), (1, 16, 2, 8), (2, 24, 1, 32)]   # (B, T, H, D)


def _inputs(B, T, H, D, seed, state=False):
    """r, k, v, w, u (and a nonzero state0) as tests/test_kernels.py draws
    them: w uniform in (0.5, 0.99)."""
    rng = np.random.default_rng(seed)
    r = rng.normal(size=(B, T, H, D)) * 0.5
    k = rng.normal(size=(B, T, H, D)) * 0.5
    v = rng.normal(size=(B, T, H, D))
    w = rng.uniform(0.5, 0.99, (B, T, H, D))
    u = rng.normal(size=(H, D)) * 0.3
    out = [r, k, v, w, u]
    if state:
        out.append(rng.normal(size=(B, H, D, D)))
    return [a.astype(np.float32) for a in out]


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("state", [False, True], ids=["zeros", "state0"])
@pytest.mark.parametrize("reference", [jax_ref, jax_scan],
                         ids=["wkv6_ref", "_wkv6_scan"])
@pytest.mark.parametrize("B,T,H,D", SHAPES)
def test_wkv6_matches_jax(B, T, H, D, reference, state):
    arrays = _inputs(B, T, H, D, seed=B * T + H, state=state)
    if reference is jax_scan and not state:
        arrays.append(np.zeros((B, H, D, D), np.float32))
    before = wkv6.launches
    got, gs = wkv6(*(torch.from_numpy(a) for a in arrays))
    assert wkv6.launches == before           # CPU tensors: plain version
    want, ws = reference(*(jnp.asarray(a) for a in arrays))
    assert got.dtype == torch.float32 and gs.dtype == torch.float32
    _close(got, want)
    _close(gs, ws)


def test_wkv6_state_chaining():
    """Two halves with the carried state give the whole run's second half
    and final state, and agree with the reference over the whole."""
    r, k, v, w, u = (torch.from_numpy(a) for a in _inputs(1, 16, 2, 8, 7))
    full, s_full = wkv6_ref(r, k, v, w, u)
    _, s1 = wkv6_ref(r[:, :8], k[:, :8], v[:, :8], w[:, :8], u)
    h2, s2 = wkv6_ref(r[:, 8:], k[:, 8:], v[:, 8:], w[:, 8:], u, s1)
    _close(h2, full[:, 8:])
    _close(s2, s_full)
    want, ws = jax_ref(*(jnp.asarray(a.numpy()) for a in (r, k, v, w, u)))
    _close(full, want)
    _close(s_full, ws)


def test_wkv6_bf16_output_rounds_once():
    """bf16 inputs: both compute in float32 and round the output to bf16
    once, so they differ by at most one bf16 step (2^-7 relative)."""
    arrays = _inputs(2, 32, 3, 16, 11)
    got, gs = wkv6_ref(*(torch.from_numpy(a).to(torch.bfloat16)
                         for a in arrays[:4]), torch.from_numpy(arrays[4]))
    want, ws = jax_ref(*(jnp.asarray(a, jnp.bfloat16) for a in arrays[:4]),
                       jnp.asarray(arrays[4]))
    assert got.dtype == torch.bfloat16 and gs.dtype == torch.float32
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=2.0 ** -7, atol=1e-5)
    _close(gs, ws)


@pytest.mark.parametrize("change,error,match", [
    (dict(r=torch.float16), TypeError, "float32 or bfloat16"),
    (dict(k=torch.bfloat16), TypeError, "one dtype"),
    (dict(u=torch.bfloat16), TypeError, "u and state0 in float32"),
    (dict(state0=torch.bfloat16), TypeError, "u and state0 in float32"),
    (dict(D=8), ValueError, "built for D"),
    (dict(v_shape=(2, 5, 3, 16)), ValueError, "shapes"),
    (dict(state0_shape=(2, 3, 16, 8)), ValueError, "shapes"),
    (dict(), ValueError, "CUDA device"),
])
def test_wkv6_kernel_rejects(change, error, match):
    """The kernel's wrapper refuses what the kernel does not take: another
    dtype or D, mismatched shapes, or tensors off the card (CPU tensors
    here), before it builds or launches anything."""
    B, T, H = 2, 6, 3
    D = change.get("D", 16)
    r, k, v, w, u, s0 = (torch.from_numpy(a) for a in
                         _inputs(B, T, H, D, 0, state=True))
    if "v_shape" in change:
        v = torch.zeros(change["v_shape"])
    if "state0_shape" in change:
        s0 = torch.zeros(change["state0_shape"])
    tensors = dict(r=r, k=k, v=v, w=w, u=u, state0=s0)
    for name, dtype in change.items():
        if name in tensors:
            tensors[name] = tensors[name].to(dtype)
    with pytest.raises(error, match=match):
        wkv6_cuda(**tensors)
