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
