"""The port's CUDA kernels against their plain versions, on a card.

Imports neither JAX nor the JAX package, so it runs on the machine with
the card:  PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
Elsewhere each test skips with its reason."""
import copy

import numpy as np
import pytest
import torch

from repro_torch.kernels.decode_attn.ops import decode_attn
from repro_torch.kernels.decode_attn.ref import decode_attn_ref
from repro_torch.kernels.wkv6.ops import wkv6
from repro_torch.kernels.wkv6.ref import wkv6_ref


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [2048, 1000])
def test_decode_attn_kernel_matches_plain(S, dtype):
    """Tolerance 2e-4 in float32 (as tests/test_kernels.py holds the Pallas
    kernel); in bf16 the two may round the output to neighbouring bf16
    values, one step being 2^-7 relative, hence 2e-2 for outputs below 2."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(S)
    B, H, Hkv, D = 8, 32, 8, 64
    q = rng.normal(size=(B, H, D))
    k = rng.normal(size=(B, Hkv, S, D))
    v = rng.normal(size=(B, Hkv, S, D))
    lens = np.array([1, 63, 64, 65, S, S // 2, 129, S - 1], np.int32)
    args = [torch.from_numpy(a).to("cuda", dtype) for a in (q, k, v)]
    args.append(torch.from_numpy(lens).cuda())
    before = decode_attn.launches
    got = decode_attn(*args)
    torch.cuda.synchronize()
    assert decode_attn.launches == before + 1
    tol = 2e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), decode_attn_ref(*args).float(),
                               rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("H,Hkv,D,S", [(8, 8, 16, 77), (8, 4, 32, 300),
                                       (8, 4, 128, 513), (32, 4, 64, 129)])
def test_decode_attn_kernel_other_shapes(H, Hkv, D, S):
    """Every head_dim and group size the kernel is built for (G = 1, 2, 2,
    8), in float32 at the 2e-4 tolerance, with a row of length 0 that must
    come out finite (its value is unspecified)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(D + S)
    B = 3
    q, k, v = (torch.from_numpy(rng.normal(size=shape)).to("cuda",
                                                            torch.float32)
               for shape in ((B, H, D), (B, Hkv, S, D), (B, Hkv, S, D)))
    lens = torch.tensor([S, 1 + S // 3, 0], dtype=torch.int32, device="cuda")
    got = decode_attn(q, k, v, lens)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got[:2], decode_attn_ref(q, k, v, lens)[:2],
                               rtol=2e-4, atol=2e-4)


@pytest.mark.gpu
def test_smoke_model_on_card_matches_cpu():
    """The smoke llama (float32) served on the card, decode attention in
    the kernel, against the same parameters on the CPU with the plain
    version: greedy tokens equal, last decode logits within 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.configs.registry import serve_smoke_config
    from repro_torch.models.zoo import build_model
    from repro_torch.serve.engine import Engine, Request

    cfg = serve_smoke_config("llama3.2-1b")
    cpu = build_model(cfg, device="cpu")
    params = cpu.init(torch.Generator().manual_seed(0))
    card = build_model(cfg)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=n) for n in (5, 17, 9)]
    outs = []
    on_card = copy.deepcopy(params).to(card.device)
    for model, p in ((cpu, params), (card, on_card)):
        eng = Engine(model, p, batch=4, max_len=64, device=model.device)
        reqs = [Request(rid=i, prompt=pr, max_new=12)
                for i, pr in enumerate(prompts)]
        for r in reqs:
            assert eng.admit(r)
        while eng.n_active:
            eng.step()
        toks = torch.from_numpy(eng.last_tok[:, None].astype(np.int64))
        lens = torch.full((4,), 30, dtype=torch.int32)
        pos = (lens - 1)[:, None].long()
        logits, _ = model.decode(p, eng.caches, toks.to(model.device),
                                 pos.to(model.device), lens.to(model.device))
        outs.append(([r.out for r in reqs], logits.cpu()))
    assert outs[0][0] == outs[1][0]
    torch.testing.assert_close(outs[1][1], outs[0][1], rtol=1e-4, atol=1e-4)


def _wkv6_inputs(B, T, H, D, dtype, seed):
    """r, k, v, w (in ``dtype``), u and a nonzero state0 (float32) on the
    card; w uniform in (0.9, 0.999), so the state carries many steps."""
    rng = np.random.default_rng(seed)
    r, k = (rng.normal(size=(B, T, H, D)) * 0.5 for _ in range(2))
    v = rng.normal(size=(B, T, H, D))
    w = rng.uniform(0.9, 0.999, (B, T, H, D))
    u = rng.normal(size=(H, D)) * 0.3
    s0 = rng.normal(size=(B, H, D, D))
    return ([torch.from_numpy(a).to("cuda", dtype) for a in (r, k, v, w)]
            + [torch.from_numpy(a).to("cuda", torch.float32) for a in (u, s0)])


def _wkv6_close(got, want, dtype):
    """Output: 1e-4 in float32 (sums in another order); in bf16 both round
    the same float32 value once, so they may land one bf16 step apart
    (2^-7 relative).  The float32 state: 1e-4."""
    tol = (2.0 ** -7, 1e-4) if dtype == torch.bfloat16 else (1e-4, 1e-4)
    torch.testing.assert_close(got[0].float(), want[0].float(),
                               rtol=tol[0], atol=tol[1])
    torch.testing.assert_close(got[1], want[1], rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [16, 32, 64, 128])
def test_wkv6_kernel_matches_plain(D, dtype):
    """Every D the kernel is built for, T = 300 (not a whole number of
    chunks for any D), from a nonzero state0 and from zeros."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r, k, v, w, u, s0 = _wkv6_inputs(2, 300, 3, D, dtype, seed=D)
    before = wkv6.launches
    got = wkv6(r, k, v, w, u, s0)
    got0 = wkv6(r, k, v, w, u)
    torch.cuda.synchronize()
    assert wkv6.launches == before + 2
    assert got[0].dtype == dtype and got[1].dtype == torch.float32
    _wkv6_close(got, wkv6_ref(r, k, v, w, u, s0), dtype)
    _wkv6_close(got0, wkv6_ref(r, k, v, w, u), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv6_kernel_state_chaining(dtype):
    """Two halves with the carried state give the whole run's second half
    and final state, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r, k, v, w, u, s0 = _wkv6_inputs(1, 77, 4, 64, dtype, seed=1)
    full = wkv6(r, k, v, w, u, s0)
    _, s1 = wkv6(r[:, :40].contiguous(), k[:, :40].contiguous(),
                 v[:, :40].contiguous(), w[:, :40].contiguous(), u, s0)
    h2, s2 = wkv6(r[:, 40:].contiguous(), k[:, 40:].contiguous(),
                  v[:, 40:].contiguous(), w[:, 40:].contiguous(), u, s1)
    torch.cuda.synchronize()
    _wkv6_close((h2, s2), (full[0][:, 40:], full[1]), dtype)


@pytest.mark.gpu
def test_rwkv6_smoke_model_on_card_matches_cpu():
    """The smoke rwkv6 (float32) served on the card, the recurrence in the
    kernel, against the same parameters on the CPU with the plain version:
    five requests over two slots (so slots are recycled), greedy tokens
    equal, and one more decode step's logits within 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.configs.registry import serve_smoke_config
    from repro_torch.models.zoo import build_model
    from repro_torch.serve.engine import Engine, Request

    cfg = serve_smoke_config("rwkv6-1.6b")
    cpu = build_model(cfg, device="cpu")
    params = cpu.init(torch.Generator().manual_seed(0))
    card = build_model(cfg)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=n) for n in (5, 17, 9, 3, 12)]
    outs = []
    on_card = copy.deepcopy(params).to(card.device)
    for model, p in ((cpu, params), (card, on_card)):
        eng = Engine(model, p, batch=2, max_len=64, device=model.device)
        reqs = [Request(rid=i, prompt=pr, max_new=6 + i)
                for i, pr in enumerate(prompts)]
        pending = list(reqs)
        while pending or eng.n_active:
            while pending and eng.has_free_slot():
                assert eng.admit(pending.pop(0))
            eng.step()
        toks = torch.from_numpy(eng.last_tok[:, None].astype(np.int64))
        logits, _ = model.decode(p, eng.caches, toks.to(model.device),
                                 None, None)
        outs.append(([r.out for r in reqs], logits.cpu()))
    assert outs[0][0] == outs[1][0]
    torch.testing.assert_close(outs[1][1], outs[0][1], rtol=1e-4, atol=1e-4)
