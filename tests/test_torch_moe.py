"""Port's MoE FFN against the JAX reference on the CPU: llama4-maverick's
top-1 and deepseek-v3's top-2 (at serve_smoke_config size), both with a
shared expert, at capacity factor 1.25 (where the reference drops
choices) and 8.0 (where it drops none).  Out, aux loss, expert choices
(idx) and kept choices (keep) are compared; keep is also held to a plain
loop over the choices in k-major order.  Float32, 1e-4 (rtol and atol)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.moe as jax_moe
from repro.configs.registry import serve_smoke_config as jax_smoke
from repro.models.zoo import build_model as jax_build
from repro_torch.configs.registry import get_config, serve_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.models.moe import capacity, moe_forward, moe_route

TOL = dict(rtol=1e-4, atol=1e-4)
B, T = 2, 8


def _layer(arch_id):
    """Layer 0 of the smoke model's MoE stack, in both packages."""
    jcfg, tcfg = jax_smoke(arch_id), serve_smoke_config(arch_id)
    jp = jax_build(jcfg).init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    jffn = jax.tree.map(lambda a: a[0], jp["moe_layers"]["ffn"])
    return jcfg, tcfg, jffn, tp.moe_layers[0].ffn


def _kept_in_order(idx, E, C):
    """Plain loop: a choice is kept while its expert holds fewer than C
    choices, every token's first choice counted before any second."""
    N, k = idx.shape
    held = np.zeros(E, int)
    keep = np.zeros((N, k), bool)
    for j in range(k):
        for n in range(N):
            keep[n, j] = held[idx[n, j]] < C
            held[idx[n, j]] += 1
    return keep


@pytest.mark.parametrize("cf", [1.25, 8.0])
@pytest.mark.parametrize("arch_id", ["llama4-maverick-400b-a17b",
                                     "deepseek-v3-671b"])
def test_moe_forward_matches_jax(arch_id, cf, monkeypatch):
    jcfg, tcfg, jffn, tffn = _layer(arch_id)
    assert tffn.shared is not None and tcfg.top_k == (1 if "llama4" in
                                                      arch_id else 2)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(B, T, tcfg.d_model)).astype(np.float32)

    seen = []
    top_k = jax.lax.top_k

    def recording_top_k(probs, k):
        out = top_k(probs, k)
        seen.append(np.asarray(out[1]))
        return out

    monkeypatch.setattr(jax_moe.jax.lax, "top_k", recording_top_k)
    jout, jaux = jax_moe.moe_forward(jffn, jcfg, jnp.asarray(x),
                                     capacity_factor=cf)
    monkeypatch.undo()
    (jidx,) = seen

    xt = torch.from_numpy(x)
    out, aux = moe_forward(tffn, tcfg, xt, capacity_factor=cf)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(aux.item(), float(jaux), **TOL)

    N, E, k = B * T, tcfg.n_experts, tcfg.top_k
    C = capacity(N, tcfg, cf)
    assert C == max(1, min(N, int(N * k / E * cf)))
    _, _, idx, keep, slot = moe_route(tffn.router, xt.reshape(N, -1), k, C)
    np.testing.assert_array_equal(idx.numpy(), jidx)
    want_keep = _kept_in_order(jidx, E, C)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    assert (slot[~keep] == C).all() and (slot[keep] < C).all()
    if cf == 1.25:     # the case the capacity exists for
        assert not want_keep.all(), "the reference dropped no choice"
    else:
        assert want_keep.all()


def test_decode_capacity_truncates():
    """At decode with 8 slots both MoE configs get one slot per expert:
    8 * 1 / 128 * 1.25 and 8 * 8 / 256 * 1.25 both truncate below 1."""
    for arch_id in ("llama4-maverick-400b-a17b", "deepseek-v3-671b"):
        assert capacity(8, get_config(arch_id)) == 1
    assert capacity(1024, get_config("deepseek-v3-671b")) == 40


def test_kept_choices_ignore_what_the_bucket_holds():
    """Dropped choices share the bucket slot; kept ones are unaffected by
    how many land there.  Every token routed to expert 0 at C = 1: only
    token 0's choice is kept, and the output is the shared expert's for
    the others."""
    _, tcfg, _, tffn = _layer("llama4-maverick-400b-a17b")
    with torch.no_grad():
        tffn.router.zero_()
        tffn.router[:, 0] = 1.0
    x = torch.ones((1, 6, tcfg.d_model))
    _, _, idx, keep, _ = moe_route(tffn.router, x.reshape(6, -1), 1, 1)
    assert (idx == 0).all() and keep[:, 0].tolist() == [True] + [False] * 5
    out, _ = moe_forward(tffn, tcfg, x, capacity_factor=1.0)
    assert not torch.equal(out[0, 0], out[0, 1])
    torch.testing.assert_close(out[0, 1:], out[0, 1:2].expand(5, -1))
