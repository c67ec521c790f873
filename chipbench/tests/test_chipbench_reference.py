"""The plain references against the port's CPU path, at the port's
``reduced()`` sizes in float32, on the benchmark's own weights."""
import pytest
import torch

from chipbench import harness, weights
from chipbench.reference import linear_scan
from chipbench.reference.plain import (FLOAT32, FP8, TF32, strict_float32,
                                       to_tf32)
from chipbench.tests.tiny import tiny_config

CONFIGS = [c["name"] for c in harness.benchmark()["configs"]]


def _port(cfg, seed):
    from repro_torch.models.zoo import build_model
    mcfg = harness.model_config(cfg)
    model = build_model(mcfg, "cpu")
    params = harness.port_module(cfg)(mcfg, None, device="meta")
    specs = harness.reference(cfg).param_specs(cfg)
    drawn = weights.draw(specs, seed, torch.device("cpu"))
    weights.install(params, drawn)
    return mcfg, model, params, drawn


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_logits_match_the_port(name):
    cfg = tiny_config(name)
    mcfg, model, params, drawn = _port(cfg, seed=2**31 + 7)
    ids = torch.randint(0, mcfg.vocab, (2, 37),
                        generator=torch.Generator().manual_seed(0))
    with torch.no_grad(), strict_float32():
        want, _ = model.train_logits(params, ids)
        got = harness.reference(cfg).logits(drawn, cfg, ids, FLOAT32)
    scale = want.abs().max()
    assert (got - want).abs().max() <= 1e-4 * scale


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_follows_prefill_then_decode(name):
    """The port's prefill and three decode steps through its cache give
    the reference's logits at those positions."""
    cfg = tiny_config(name)
    mcfg, model, params, drawn = _port(cfg, seed=5)
    ids = torch.randint(0, mcfg.vocab, (1, 24),
                        generator=torch.Generator().manual_seed(1))
    T0 = 20
    with torch.no_grad(), strict_float32():
        cache = model.init_cache(1, 32)
        logits, new = model.prefill(params, ids[:, :T0],
                                    torch.tensor([T0]))
        from repro_torch.models.zoo import cache_tensors
        for full, part in zip(cache_tensors(cache), cache_tensors(new)):
            idx = [slice(None)] * part.ndim
            seq = [a for a in range(2, part.ndim)
                   if part.shape[a] != full.shape[a]]
            if seq:
                idx[seq[0]] = slice(0, part.shape[seq[0]])
            full[tuple(idx)] = part
        rows = [logits[0, -1]]
        for t in range(T0, 23):
            lg, cache = model.decode(params, cache, ids[:, t:t + 1],
                                     torch.tensor([[t]]),
                                     torch.tensor([t + 1]))
            rows.append(lg[0, -1])
        want = torch.stack(rows)
        got = harness.reference(cfg).logits(
            drawn, cfg, ids[:, :23], FLOAT32,
            torch.arange(T0 - 1, 23))[0]
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


def test_wkv6_chunked_equals_the_plain_walk():
    g = torch.Generator().manual_seed(3)
    B, T, H, D = 2, 53, 3, 8
    r, k, v = (torch.randn(B, T, H, D, generator=g, dtype=torch.float64)
               for _ in range(3))
    logw = -torch.exp(torch.randn(B, T, H, D, generator=g,
                                  dtype=torch.float64) - 1)
    u = torch.randn(H, D, generator=g, dtype=torch.float64)
    S = torch.zeros(B, H, D, D, dtype=torch.float64)
    outs = []
    for t in range(T):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        outs.append((r[:, t, :, :, None] * (S + u[None, :, :, None] * kv))
                    .sum(-2))
        S = torch.exp(logw[:, t])[..., None] * S + kv
    want = torch.stack(outs, 1)
    for chunk in (1, 4, 16, 64):
        got = linear_scan.wkv6(r, k, v, logw, u, chunk=chunk)
        assert torch.allclose(got, want, rtol=1e-10, atol=1e-10)


def test_ssd_chunked_equals_the_plain_walk():
    g = torch.Generator().manual_seed(4)
    B, T, nh, hp, ds = 2, 45, 3, 4, 5
    x = torch.randn(B, T, nh, hp, generator=g, dtype=torch.float64)
    Bm, Cm = (torch.randn(B, T, ds, generator=g, dtype=torch.float64)
              for _ in range(2))
    dt = torch.rand(B, T, nh, generator=g, dtype=torch.float64)
    loga = -dt * 2.0
    S = torch.zeros(B, nh, hp, ds, dtype=torch.float64)
    ys = []
    for t in range(T):
        S = torch.exp(loga[:, t])[..., None, None] * S + \
            dt[:, t, :, None, None] * x[:, t, :, :, None] * \
            Bm[:, t, None, None, :]
        ys.append((S * Cm[:, t, None, None, :]).sum(-1))
    want = torch.stack(ys, 1)
    for chunk in (1, 8, 64):
        got = linear_scan.ssd(x, Bm, Cm, loga, dt, chunk=chunk)
        assert torch.allclose(got, want, rtol=1e-10, atol=1e-10)


def test_the_controls_round_every_product():
    a = torch.randn(16, 32, generator=torch.Generator().manual_seed(0))
    b = torch.randn(32, 8, generator=torch.Generator().manual_seed(1))
    exact = FLOAT32.mm(a, b)
    low = FP8.mm(a, b)
    err = (low - exact).abs().max() / exact.abs().max()
    assert 1e-3 < err < 0.2
    tf = TF32.mm(a, b)
    assert 1e-6 < (tf - exact).abs().max() / exact.abs().max() < 1e-2
    assert to_tf32(torch.tensor([1 + 2**-11, 1 + 3 * 2**-11,
                                 float("inf")])).tolist() == \
        [1.0, 1 + 2**-9, float("inf")]
