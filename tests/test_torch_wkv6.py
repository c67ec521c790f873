"""Port's WKV6 recurrence against the JAX reference on the CPU (the plain
``wkv6_ref`` and the model's ``_wkv6_scan``; the Pallas kernel does not
run on this JAX), the plain version of the chunked route's algorithm
(``wkv6_chunked_ref``), the route rule, and the wrapper's CPU route and
input checks.  The kernels themselves are held against their plain
version on a card by tests/test_torch_gpu.py.

Tolerance 1e-5 (rtol and atol) on output and state in float32, as
tests/test_kernels.py holds the Pallas kernel to its oracle."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.wkv6.ref import wkv6_ref as jax_ref
from repro.models.rwkv6 import _wkv6_scan as jax_scan
from repro_torch.kernels.wkv6 import kernel as kmod
from repro_torch.kernels.wkv6.kernel import wkv6_cuda
from repro_torch.kernels.wkv6.ops import wkv6
from repro_torch.kernels.wkv6.ref import wkv6_chunked_ref, wkv6_ref

TOL = 1e-5
SHAPES = [(2, 32, 3, 16), (1, 16, 2, 8), (2, 24, 1, 32)]   # (B, T, H, D)


def _inputs(B, T, H, D, seed, state=False, decays=(0.5, 0.99)):
    """r, k, v, w, u (and a nonzero state0) as tests/test_kernels.py draws
    them: w uniform in ``decays``, (0.5, 0.99) there."""
    rng = np.random.default_rng(seed)
    r = rng.normal(size=(B, T, H, D)) * 0.5
    k = rng.normal(size=(B, T, H, D)) * 0.5
    v = rng.normal(size=(B, T, H, D))
    w = rng.uniform(*decays, (B, T, H, D))
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


# Decay ranges of the chunked form's checks: near 0 (each chunk's decay
# product underflows), near 1 (the state carries the whole run), between.
DECAYS = {"near0": (1e-4, 0.05), "near1": (0.999, 0.99999),
          "mid": (0.5, 0.99)}


def _chunk_lengths(ct):
    """T of one step, one short of a chunk, one chunk, one past it, and
    three chunks and a short one."""
    return [1, ct - 1, ct, ct + 1, 3 * ct + 5]


@pytest.mark.parametrize("state", [False, True], ids=["zeros", "state0"])
@pytest.mark.parametrize("decays", DECAYS)
@pytest.mark.parametrize("T", _chunk_lengths(16))
def test_wkv6_chunked_ref_matches_jax(T, decays, state):
    """The chunked route's algorithm against JAX's ``wkv6_ref`` at 1e-5,
    with chunks of 16 steps and D 16.  At that tolerance the size is
    bounded by float32 summation order, not by the chunking: with
    near-1 decays even one chunk (the step form itself) of D 64 differs
    from JAX by 2e-5."""
    B, H, D = 2, 3, 16
    arrays = _inputs(B, T, H, D, seed=T + B, state=state,
                     decays=DECAYS[decays])
    got, gs = wkv6_chunked_ref(*(torch.from_numpy(a) for a in arrays),
                               ct=16)
    want, ws = jax_ref(*(jnp.asarray(a) for a in arrays))
    _close(got, want)
    _close(gs, ws)


@pytest.mark.parametrize("state", [False, True], ids=["zeros", "state0"])
@pytest.mark.parametrize("decays", DECAYS)
@pytest.mark.parametrize("T", _chunk_lengths(kmod.CHUNK_T))
def test_wkv6_chunked_ref_matches_plain(T, decays, state):
    """The chunked route's algorithm with the route's own chunk length
    against the port's step-by-step ``wkv6_ref`` at (1e-4, 1e-4), the
    tolerance the card's checks hold the chunked kernel to."""
    B, H, D = 2, 3, 16
    arrays = [torch.from_numpy(a) for a in _inputs(
        B, T, H, D, seed=T + B, state=state, decays=DECAYS[decays])]
    got = wkv6_chunked_ref(*arrays, ct=kmod.CHUNK_T)
    want = wkv6_ref(*arrays)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


def test_wkv6_chunked_ref_bf16_output_rounds_once():
    """bf16 inputs: the chunked form keeps its local outputs in float32 and
    rounds once, like the step form, so the two land at most one bf16
    step apart."""
    arrays = [torch.from_numpy(a) for a in _inputs(1, 150, 2, 16, 5,
                                                   state=True)]
    half = [a.to(torch.bfloat16) for a in arrays[:4]] + arrays[4:]
    got, gs = wkv6_chunked_ref(*half, ct=kmod.CHUNK_T)
    want, ws = wkv6_ref(*half)
    assert got.dtype == torch.bfloat16 and gs.dtype == torch.float32
    torch.testing.assert_close(got.float(), want.float(), rtol=2.0 ** -7,
                               atol=1e-4)
    torch.testing.assert_close(gs, ws, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("B,T,H,D,want", [
    (8, 1, 32, 64, "step"),                          # rwkv6-1.6b decode
    (1, kmod.CHUNK_T - 1, 32, 64, "step"),           # a short prompt
    (1, kmod.CHUNK_T, 32, 64, "chunked"),            # the shortest prefill
    (1, kmod.CHUNK_T + 1, 32, 64, "chunked"),        # a short last chunk
    (1, 1024, 32, 64, "chunked"),                    # the longest prefill
    (1, 777, 32, 64, "chunked"),
    (8, 1024, 32, 16, "chunked"),
])
def test_wkv6_route(B, T, H, D, want):
    """Decode and short prompts run on the step kernel; from one whole
    chunk (CHUNK_T steps) up, the chunked route, so every prompt of
    rwkv6-1.6b's serving episode (64 to 1024 tokens) is a chunked
    prefill."""
    assert kmod.route(B, T, H, D) == want


def test_wkv6_counts_launches_by_route():
    """The per-route counter has one entry per route, and CPU calls count
    on none."""
    assert set(wkv6.launches_by_route) == set(kmod.ROUTES)
    before = dict(wkv6.launches_by_route), wkv6.launches
    wkv6(*(torch.from_numpy(a) for a in _inputs(1, 200, 2, 16, 3)))
    assert (dict(wkv6.launches_by_route), wkv6.launches) == before
