"""Plain PyTorch version of the RWKV6 (Finch) WKV recurrence with
data-dependent decay.

Per (batch, head), with state S in R^{D x D}:
    o_t = r_t @ (S_{t-1} + diag(u) (k_t^T v_t))
    S_t = diag(w_t) S_{t-1} + k_t^T v_t
"""
from __future__ import annotations

from typing import Optional

import torch


def wkv6_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor,
             state0: Optional[torch.Tensor] = None):
    """r/k/v/w: (B, T, H, D); u: (H, D); state0: (B, H, D, D) or None
    (zeros).  Steps over T in float32 (in float64 for float64 r, as an
    exact yardstick); returns (out (B, T, H, D) in r's dtype, final state
    (B, H, D, D) float32, or float64 for float64 r)."""
    B, T, H, D = r.shape
    wide = torch.float64 if r.dtype == torch.float64 else torch.float32
    if state0 is None:
        S = torch.zeros((B, H, D, D), dtype=wide, device=r.device)
    else:
        S = state0.to(wide)
    uf = u.to(wide)[None, :, :, None]
    rf, kf, vf, wf = (a.to(wide) for a in (r, k, v, w))
    outs = []
    for t in range(T):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]
        outs.append((rf[:, t, :, :, None] * (S + uf * kv)).sum(-2))
        S = wf[:, t, :, :, None] * S + kv
    return torch.stack(outs, 1).to(r.dtype), S


def wkv6_chunked_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     w: torch.Tensor, u: torch.Tensor,
                     state0: Optional[torch.Tensor] = None, ct: int = 64):
    """The chunked route's algorithm in plain PyTorch (for tests and the
    card's checks; the serving path never calls it).  T is cut into chunks
    of ``ct`` steps.  Chunk 0 runs the recurrence from state0; every other
    chunk c from zeros, giving local outputs and an end state L_c.  Then
    S_{c+1} = diag(W_c) S_c + L_c with W_c the product of the chunk's
    decays, and out_t = local_t + (r_t * p_t) S_c with p_t the product of
    the chunk's decays before step t.  No division.  Returns (out in r's
    dtype, final state float32), as ``wkv6_ref``."""
    T = r.shape[1]
    rf, kf, vf, wf = (a.float() for a in (r, k, v, w))
    S = None if state0 is None else state0.float()
    outs = []
    for c0 in range(0, T, ct):
        sl = slice(c0, min(T, c0 + ct))
        local, L = wkv6_ref(rf[:, sl], kf[:, sl], vf[:, sl], wf[:, sl], u,
                            S if c0 == 0 else None)
        if c0 == 0:
            S = L
        else:
            wc = wf[:, sl]                                  # (B, n, H, D)
            p = torch.cumprod(torch.cat([torch.ones_like(wc[:, :1]),
                                         wc[:, :-1]], 1), 1)
            local = local + torch.einsum("bthd,bhde->bthe", rf[:, sl] * p, S)
            S = torch.cumprod(wc, 1)[:, -1, :, :, None] * S + L
        outs.append(local)
    return torch.cat(outs, 1).to(r.dtype), S


# ------------------------------------------------------------- backward
# The recurrence's gradient, derived by hand (the backward kernel,
# csrc/wkv6_backward.cu, computes the same; autograd through wkv6_ref is
# the yardstick).  Per (batch, head), with S_{t-1} the state before step t
# and G_t the gradient of the loss with respect to S_t (G_T the final
# state's gradient, zeros when it is None):
#     G_{t-1} = diag(w_t) G_t + r_t^T go_t
#     dr_t[d] = sum_e S_{t-1}[d,e] go_t[e] + u[d] k_t[d] (v_t . go_t)
#     dk_t[d] = sum_e G_t[d,e] v_t[e]     + u[d] r_t[d] (v_t . go_t)
#     dv_t[e] = sum_d G_t[d,e] k_t[d]     + go_t[e] sum_d r_t[d] u[d] k_t[d]
#     dw_t[d] = sum_e G_t[d,e] S_{t-1}[d,e]
#     du[d]   = sum_{b,t} r_t[d] k_t[d] (v_t . go_t)
#     dstate0 = G_0
# (o_t reads S_{t-1} and the u term; S_t = diag(w_t) S_{t-1} + k_t^T v_t
# passes G_t back through diag(w_t) and to k_t, v_t and w_t.)
def _reverse_steps(S0, G, rf, kf, vf, wf, gof, uf):
    """The gradient over one stretch of steps (B, n, H, D each, widened)
    that starts from state S0 and whose end state has gradient G.
    Returns (dr, dk, dv, dw (B, n, H, D), du (H, D), G before the
    stretch)."""
    states = [S0]
    for t in range(rf.shape[1] - 1):        # S_{t-1} of each step
        states.append(wf[:, t, :, :, None] * states[-1]
                      + kf[:, t, :, :, None] * vf[:, t, :, None, :])
    dr, dk, dv, dw = ([None] * rf.shape[1] for _ in range(4))
    du = torch.zeros_like(uf)
    for t in reversed(range(rf.shape[1])):
        r, k, v, w, go = (a[:, t] for a in (rf, kf, vf, wf, gof))
        vgo = (v * go).sum(-1, keepdim=True)                 # (B, H, 1)
        S = states[t]
        dr[t] = (S * go[..., None, :]).sum(-1) + uf * k * vgo
        dk[t] = (G * v[..., None, :]).sum(-1) + uf * r * vgo
        dv[t] = (G * k[..., :, None]).sum(-2) + \
            go * (r * uf * k).sum(-1, keepdim=True)
        dw[t] = (G * S).sum(-1)
        du = du + (r * k * vgo).sum(0)
        G = w[..., :, None] * G + r[..., :, None] * go[..., None, :]
    return (*(torch.stack(g, 1) for g in (dr, dk, dv, dw)), du, G)


def _widened(r, k, v, w, u, state0, g_out, g_state):
    B, T, H, D = r.shape
    wide = torch.float64 if r.dtype == torch.float64 else torch.float32
    S0 = torch.zeros((B, H, D, D), dtype=wide, device=r.device) \
        if state0 is None else state0.to(wide)
    G = torch.zeros((B, H, D, D), dtype=wide, device=r.device) \
        if g_state is None else g_state.to(wide)
    return wide, S0, G, [a.to(wide) for a in (r, k, v, w, g_out)], \
        u.to(wide)


def _narrowed(r, u, state0, dr, dk, dv, dw, du, dS0):
    """The gradients in the dtypes autograd through wkv6_ref gives (with
    no state0, dstate0 in the dtype of the state it starts from)."""
    return (*(g.to(r.dtype) for g in (dr, dk, dv, dw)), du.to(u.dtype),
            dS0 if state0 is None else dS0.to(state0.dtype))


def wkv6_backward_ref(r, k, v, w, u, state0, g_out, g_state=None):
    """Gradients (dr, dk, dv, dw, du, dstate0) of ``wkv6_ref``'s (out,
    state) given ``g_out`` (B, T, H, D) and ``g_state`` (B, H, D, D) or
    None (zeros), by the equations above, every step in float32 (float64
    for float64 r), keeping every state of the run.  dr, dk, dv and dw
    come back in r's dtype, du in u's, dstate0 in state0's (float32, or
    float64 for float64 r, when state0 is None), as autograd through
    ``wkv6_ref`` gives them."""
    _, S0, G, (rf, kf, vf, wf, gof), uf = _widened(r, k, v, w, u, state0,
                                                   g_out, g_state)
    dr, dk, dv, dw, du, G = _reverse_steps(S0, G, rf, kf, vf, wf, gof, uf)
    return _narrowed(r, u, state0, dr, dk, dv, dw, du, G)


def wkv6_backward_chunked_ref(r, k, v, w, u, state0, g_out, g_state=None,
                              ct: int = 64):
    """``wkv6_backward_ref`` as the backward kernel's ``step`` and
    ``chunked`` routes compute it: the state at each chunk's entry from the forward's chunk recurrence (chunks of
    ``ct`` steps, as ``wkv6_chunked_ref``; one state a chunk is kept),
    then the chunks from the last to the first, each recomputing its own
    states from its entry state and passing the gradient of its entry
    state to the chunk before it."""
    T = r.shape[1]
    _, S0, G, (rf, kf, vf, wf, gof), uf = _widened(r, k, v, w, u, state0,
                                                   g_out, g_state)
    starts = list(range(0, T, ct))
    entry = _state_entries(S0, rf, kf, vf, wf, uf, ct)
    parts, du = [], torch.zeros_like(uf)
    for c0, Sc in reversed(list(zip(starts, entry))):
        sl = slice(c0, min(T, c0 + ct))
        *grads, du_c, G = _reverse_steps(Sc, G, rf[:, sl], kf[:, sl],
                                         vf[:, sl], wf[:, sl], gof[:, sl],
                                         uf)
        parts.append(grads)
        du = du + du_c
    dr, dk, dv, dw = (torch.cat(g[::-1], 1) for g in zip(*parts))
    return _narrowed(r, u, state0, dr, dk, dv, dw, du, G)


def _state_entries(S0, rf, kf, vf, wf, uf, ct):
    """The state at each chunk's entry (chunks of ``ct`` steps), by the
    forward's chunk scan: each chunk's end state from zeros L_c, then
    S_{c+1} = diag(W_c) S_c + L_c, W_c the product of its decays."""
    entry = [S0]
    for c0 in range(0, rf.shape[1], ct)[:-1]:
        sl = slice(c0, c0 + ct)
        _, L = wkv6_ref(rf[:, sl], kf[:, sl], vf[:, sl], wf[:, sl], uf)
        entry.append(torch.prod(wf[:, sl], 1)[..., None] * entry[-1] + L)
    return entry


def _gradient_exits(G, rf, wf, gof, ct):
    """The state gradient at each chunk's exit (the gradient of the state
    after its last step; G for the last chunk), by the gradient's own
    chunk scan.  G_{t-1} = diag(w_t) G_t + r_t^T go_t has the forward's
    form with time reversed, so over a chunk G at its entry is diag(W_c)
    G at its exit + LG_c, with LG_c = sum_t diag(p_t) r_t^T go_t the
    chunk's part from a zero exit, p_t the product of the chunk's decays
    before step t (products only, no division).  The scan runs from the
    last chunk: exit(c - 1) = diag(W_c) exit(c) + LG_c."""
    starts = list(range(0, rf.shape[1], ct))
    exits = [G]
    for c0 in reversed(starts[1:]):
        sl = slice(c0, c0 + ct)
        wc = wf[:, sl]
        p = torch.cumprod(torch.cat([torch.ones_like(wc[:, :1]),
                                     wc[:, :-1]], 1), 1)
        local = torch.einsum("bthd,bthe->bhde", rf[:, sl] * p, gof[:, sl])
        exits.append(torch.prod(wc, 1)[..., None] * exits[-1] + local)
    return exits[::-1]


def wkv6_backward_parallel_ref(r, k, v, w, u, state0, g_out, g_state=None,
                               ct: int = 16):
    """``wkv6_backward_ref`` as the backward kernel's ``parallel`` route
    computes it, in chunks of ``ct`` steps that need no other chunk once
    two scans have run: the state at each chunk's entry by the forward's
    chunk scan (``_state_entries``), the state gradient at each chunk's
    exit by the gradient's reverse chunk scan (``_gradient_exits``), then
    every chunk on its own from its entry state and exit gradient; du sums
    the chunks' parts in order, and chunk 0's gradient at its entry is
    dstate0."""
    _, S0, G, (rf, kf, vf, wf, gof), uf = _widened(r, k, v, w, u, state0,
                                                   g_out, g_state)
    entries = _state_entries(S0, rf, kf, vf, wf, uf, ct)
    exits = _gradient_exits(G, rf, wf, gof, ct)
    parts, du = [], torch.zeros_like(uf)
    for c0, Sc, Gc in zip(range(0, r.shape[1], ct), entries, exits):
        sl = slice(c0, c0 + ct)
        *grads, du_c, G_in = _reverse_steps(Sc, Gc, rf[:, sl], kf[:, sl],
                                            vf[:, sl], wf[:, sl],
                                            gof[:, sl], uf)
        parts.append(grads)
        du = du + du_c
        if c0 == 0:
            dS0 = G_in
    dr, dk, dv, dw = (torch.cat(g, 1) for g in zip(*parts))
    return _narrowed(r, u, state0, dr, dk, dv, dw, du, dS0)
