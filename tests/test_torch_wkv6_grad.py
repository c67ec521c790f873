"""The WKV6 recurrence's gradient in the port: the plain hand-derived
backward (``wkv6_backward_ref``), its chunked form
(``wkv6_backward_chunked_ref``, the first backward kernel's algorithm)
and its parallel form (``wkv6_backward_parallel_ref``, the parallel
route's: chunk scans of the state and of its gradient, then every chunk
on its own) against autograd through ``wkv6_ref`` in float64 (1e-10),
and against ``jax.vjp``
of the reference's ``wkv6_ref`` and of the model's ``_wkv6_scan`` in
float32 (1e-4 of each gradient's largest |g|, the bar of training's
card-against-CPU check); the autograd Function's backward returning None
where no gradient is wanted; the CPU route of ``wkv6_backward``; the
gradient's chunk scan against the plain walk at every chunk boundary;
the backward's route rule; and the backward kernel launcher's input
checks, which need no card.  The kernel
itself is held against the plain version on a card by
tests/test_torch_gpu.py, its count in the dry run by
tests/test_torch_roofline.py."""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.wkv6.ref import wkv6_ref as jax_ref
from repro.models.rwkv6 import _wkv6_scan as jax_scan
from repro_torch.kernels.wkv6.kernel import (BWD_CHUNK_T, BWD_HEAD_DIMS,
                                             CHUNK_T, backward_route,
                                             wkv6_backward_cuda)
from repro_torch.kernels.wkv6.ops import _WKV6, wkv6_backward
from repro_torch.kernels.wkv6.ref import (_gradient_exits,
                                          wkv6_backward_chunked_ref,
                                          wkv6_backward_parallel_ref,
                                          wkv6_backward_ref, wkv6_ref)

DECAYS = {"mid": (0.9, 0.999), "near0": (1e-4, 0.05),
          "near1": (0.999, 0.99999)}
# (T, D, state0 given, g_state given, decays): every T of {1, 16, 64, 130}
# with every D of {16, 64, 80}, the other three varied across them
CASES = [(1, 16, True, False, "mid"), (1, 64, False, True, "near0"),
         (1, 80, True, True, "near1"), (16, 16, False, False, "near1"),
         (16, 64, True, False, "mid"), (16, 80, False, True, "near0"),
         (64, 16, True, True, "near0"), (64, 64, False, False, "near1"),
         (64, 80, True, False, "mid"), (130, 16, False, True, "mid"),
         (130, 64, True, True, "near1"), (130, 80, False, False, "near0")]
# the parallel form at the kernel's chunk and at 24 steps, which divides
# no T of CASES
FORMS = {"plain": wkv6_backward_ref,
         "chunked": lambda *a: wkv6_backward_chunked_ref(*a, ct=16),
         "parallel": lambda *a: wkv6_backward_parallel_ref(*a,
                                                           ct=BWD_CHUNK_T),
         "parallel_ct24": lambda *a: wkv6_backward_parallel_ref(*a, ct=24)}


def _arrays(T, D, state0, g_state, decays, seed, B=2, H=2):
    """r, k, v, w, u, state0 (or None), g_out, g_state (or None) as numpy
    float64 arrays from a seed; w uniform in ``decays``."""
    rng = np.random.default_rng(seed)
    shape = (B, T, H, D)
    r, k = (rng.normal(size=shape) * 0.5 for _ in range(2))
    v = rng.normal(size=shape)
    w = rng.uniform(*DECAYS[decays], shape)
    u = rng.normal(size=(H, D)) * 0.3
    s0 = rng.normal(size=(B, H, D, D)) if state0 else None
    go = rng.normal(size=shape)
    gs = rng.normal(size=(B, H, D, D)) if g_state else None
    return [r, k, v, w, u, s0, go, gs]


def _torch(arrays, dtype):
    return [None if a is None else torch.from_numpy(a).to(dtype)
            for a in arrays]


def _autograd(r, k, v, w, u, s0, go, gs):
    """Gradients of (r, k, v, w, u, state0) by autograd through
    wkv6_ref (state0's None when it is None)."""
    ins = [t.clone().requires_grad_() for t in (r, k, v, w, u)]
    if s0 is not None:
        ins.append(s0.clone().requires_grad_())
    out, state = wkv6_ref(*ins[:5], ins[5] if s0 is not None else None)
    outs, cots = [out], [go]
    if gs is not None:
        outs.append(state)
        cots.append(gs)
    grads = torch.autograd.grad(outs, ins, cots, allow_unused=True)
    # w reaches only the final state: unused at T 1 with no g_state
    return [torch.zeros_like(t) if g is None else g
            for g, t in zip(grads, ins)] + ([None] if s0 is None else [])


def _held(got, want, rel):
    """Each gradient within ``rel`` of its want's largest |g|."""
    for g, w in zip(got, want):
        if w is None:
            continue
        w = torch.as_tensor(np.asarray(w, dtype=np.float64))
        scale = w.abs().max().item()
        err = (g.double() - w).abs().max().item()
        assert err <= rel * scale, (err, scale)


@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("T,D,state0,g_state,decays", CASES)
def test_backward_matches_autograd_float64(T, D, state0, g_state, decays,
                                           form):
    args = _torch(_arrays(T, D, state0, g_state, decays, seed=T * 97 + D),
                  torch.float64)
    got = FORMS[form](*args)
    want = _autograd(*args)
    assert [g.dtype for g in got] == [torch.float64] * 6
    if args[5] is None:       # no state0: its gradient is G_0 all the same
        want[5] = FORMS["plain"](*args)[5]
    _held(got, want, 1e-10)


def test_chunked_form_at_the_kernels_chunk_equals_the_plain_one():
    """At the kernel's chunk of CHUNK_T steps, over a ragged last chunk."""
    args = _torch(_arrays(2 * CHUNK_T + 5, 16, True, True, "mid", seed=5),
                  torch.float64)
    _held(wkv6_backward_chunked_ref(*args, ct=CHUNK_T),
          wkv6_backward_ref(*args), 1e-12)


@pytest.mark.parametrize("ct", [BWD_CHUNK_T, 24])
@pytest.mark.parametrize("g_state", [False, True])
def test_gradient_chunk_scan_equals_the_plain_walk_at_each_boundary(
        g_state, ct):
    """The gradient's reverse chunk scan (each chunk's part from a zero
    exit, then exit(c - 1) = diag(W_c) exit(c) + LG_c from the last
    chunk) gives at each chunk's exit the G that the plain walk, G_{t-1}
    = diag(w_t) G_t + r_t^T go_t from the end, has there; over a ragged
    last chunk, float64."""
    r, k, v, w, u, s0, go, gs = _torch(
        _arrays(5 * ct + 3, 16, False, g_state, "mid", seed=ct),
        torch.float64)
    B, T, H, D = r.shape
    G = torch.zeros((B, H, D, D), dtype=torch.float64) if gs is None else gs
    exits = _gradient_exits(G, r, w, go, ct)
    walked = {}
    for t in reversed(range(T)):
        if (t + 1) % ct == 0 or t + 1 == T:     # the exit of t's chunk
            walked[t // ct] = G
        G = w[:, t, :, :, None] * G + r[:, t, :, :, None] * go[:, t, :, None]
    assert len(exits) == len(walked) == -(-T // ct)
    for c, want in walked.items():
        torch.testing.assert_close(exits[c], want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("D", [1, 8, 16, 32, 48, 64, 80, 128, 256])
@pytest.mark.parametrize("T", [1, BWD_CHUNK_T - 1, BWD_CHUNK_T, CHUNK_T,
                               CHUNK_T + 1, 256, 777])
def test_backward_route_by_head_size_and_length(T, D):
    """The parallel route for D 16, 32 and 64 at every T (rwkv6's D 64:
    training's B 2 x T 256 runs on it), the first kernel for other D:
    chunked where T spans more than one chunk of CHUNK_T steps, else
    step.  B and H do not move it."""
    want = "parallel" if D in (16, 32, 64) else \
        "chunked" if T > CHUNK_T else "step"
    assert BWD_HEAD_DIMS == (16, 32, 64)
    for B, H in ((1, 1), (2, 32), (8, 3)):
        assert backward_route(B, T, H, D) == want


def _jax_vjp(reference, r, k, v, w, u, s0, go, gs):
    """Cotangents of (r, k, v, w, u, state0) from jax.vjp of
    ``reference`` (state0 zeros where None; g_state zeros where None)."""
    B, T, H, D = r.shape
    s0 = np.zeros((B, H, D, D)) if s0 is None else s0
    gs = np.zeros((B, H, D, D)) if gs is None else gs
    f32 = [jnp.asarray(a, jnp.float32) for a in (r, k, v, w, u, s0)]
    _, vjp = jax.vjp(reference, *f32)
    return [np.asarray(g, np.float64) for g in vjp(
        (jnp.asarray(go, jnp.float32), jnp.asarray(gs, jnp.float32)))]


@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("reference", [jax_ref, jax_scan],
                         ids=["wkv6_ref", "_wkv6_scan"])
@pytest.mark.parametrize("T,D,state0,g_state,decays",
                         [CASES[0], CASES[5], CASES[7], CASES[11]])
def test_backward_matches_jax_vjp(T, D, state0, g_state, decays, reference,
                                  form):
    arrays = _arrays(T, D, state0, g_state, decays, seed=T + D)
    arrays = [None if a is None else a.astype(np.float32) for a in arrays]
    got = FORMS[form](*_torch(arrays, torch.float32))
    assert [g.dtype for g in got] == [torch.float32] * 6
    _held(got, _jax_vjp(reference, *arrays), 1e-4)


def test_bf16_gradients_come_back_in_autograds_dtypes():
    """bf16 r, k, v, w and g_out: dr, dk, dv and dw in bf16, du and
    dstate0 in float32, as autograd through wkv6_ref gives them, and each
    the float32 computation rounded once."""
    args = _torch(_arrays(20, 16, True, False, "mid", seed=3),
                  torch.float32)
    for i in (0, 1, 2, 3, 6):
        args[i] = args[i].bfloat16()
    got = wkv6_backward_ref(*args)
    want = _autograd(*args)
    assert [g.dtype for g in got] == [g.dtype for g in want] == \
        [torch.bfloat16] * 4 + [torch.float32] * 2
    f32 = wkv6_backward_ref(*[None if a is None else a.float()
                              for a in args])
    for g, w in zip(got, f32):
        assert torch.equal(g, w.to(g.dtype))


@pytest.mark.parametrize("need", [
    (True,) * 6, (True, True, True, True, True, False),
    (False, False, False, False, True, False),
    (True, False, True, False, False, True)])
def test_function_backward_returns_none_where_not_needed(need):
    """_WKV6.backward on CPU tensors (the plain hand-derived backward):
    the gradients autograd wants, None for the others."""
    args = _torch(_arrays(16, 16, True, False, "mid", seed=11),
                  torch.float32)
    ctx = types.SimpleNamespace(saved_tensors=tuple(args[:6]),
                                needs_input_grad=need)
    got = _WKV6.backward(ctx, args[6], None)
    want = _autograd(*args)
    assert len(got) == 6
    for g, w, n in zip(got, want, need):
        if n:
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
        else:
            assert g is None


def test_wkv6_backward_on_cpu_is_the_plain_version():
    args = _torch(_arrays(16, 16, True, True, "mid", seed=2), torch.float32)
    before = (wkv6_backward.launches, dict(wkv6_backward.launches_by_route))
    got = wkv6_backward(*args)
    assert (wkv6_backward.launches,
            dict(wkv6_backward.launches_by_route)) == before
    for g, w in zip(got, wkv6_backward_ref(*args)):
        assert torch.equal(g, w)


def _launcher_args(dtype=torch.float32, D=16):
    B, T, H = 1, 8, 2
    t = [torch.zeros((B, T, H, D), dtype=dtype) for _ in range(4)]
    return t + [torch.zeros((H, D)), None, torch.zeros((B, T, H, D),
                                                       dtype=dtype), None]


@pytest.mark.parametrize("change,error", [
    (lambda a: a.__setitem__(2, a[2].bfloat16()), TypeError),
    (lambda a: a.__setitem__(6, a[6].bfloat16()), TypeError),
    (lambda a: [a.__setitem__(i, a[i].double()) for i in (0, 1, 2, 3, 6)],
     TypeError),
    (lambda a: a.__setitem__(4, a[4].double()), TypeError),
    (lambda a: a.__setitem__(7, torch.zeros((1, 2, 16, 16),
                                            dtype=torch.float64)), TypeError),
    (lambda a: a.__setitem__(1, a[1][:, :4]), ValueError),
    (lambda a: a.__setitem__(4, torch.zeros((2, 8))), ValueError),
    (lambda a: a.__setitem__(5, torch.zeros((1, 2, 16, 8))), ValueError),
    (lambda a: a.__setitem__(7, torch.zeros((2, 2, 16, 16))), ValueError),
    (lambda a: None, ValueError),          # CPU tensors: not on a card
])
def test_backward_launcher_checks_inputs(change, error):
    args = _launcher_args()
    change(args)
    with pytest.raises(error):
        wkv6_backward_cuda(*args)


@pytest.mark.parametrize("D,T,kind", [
    (16, 8, "chunked"),     # one chunk: the first kernel's route is step
    (64, 100, "step"),      # more than one chunk: it is chunked
    (80, 8, "parallel"),    # not built for D 80
    (64, 8, "simt")])       # no such route
def test_backward_launcher_refuses_another_route(D, T, kind):
    """``kind`` may name the rule's route or the first kernel's route for
    T (chip_smoke's "before" timing); anything else is refused before the
    launch."""
    args = _launcher_args(D=D)
    for i in (0, 1, 2, 3, 6):
        args[i] = torch.zeros((1, T, 2, D))
    with pytest.raises(ValueError, match="runs on"):
        wkv6_backward_cuda(*args, kind=kind)


@pytest.mark.parametrize("D,T,kind", [(64, 8, "step"), (64, 100, "chunked"),
                                      (64, 100, "parallel")])
def test_backward_launcher_takes_either_route_then_needs_a_card(D, T, kind):
    """The routes ``kind`` may name pass the route check; CPU tensors are
    then refused as not on a card."""
    args = _launcher_args(D=D)
    for i in (0, 1, 2, 3, 6):
        args[i] = torch.zeros((1, T, 2, D))
    with pytest.raises(ValueError, match="CUDA|card|cuda"):
        wkv6_backward_cuda(*args, kind=kind)


def test_backward_launcher_refuses_an_empty_axis():
    args = _launcher_args()
    for i in (0, 1, 2, 3, 6):
        args[i] = args[i][:, :0]
    with pytest.raises(ValueError, match=">= 1"):
        wkv6_backward_cuda(*args)
