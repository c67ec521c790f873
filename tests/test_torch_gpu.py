"""The port's CUDA kernels against their plain versions, on a card.

Imports neither JAX nor the JAX package, so it runs on the machine with
the card:  PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
Elsewhere each test skips with its reason."""
import copy

import numpy as np
import pytest
import torch

from repro_torch.kernels.conv2d_os.kernel import route as conv_route
from repro_torch.kernels.conv2d_os.ops import conv2d_os
from repro_torch.kernels.conv2d_os.ref import conv2d_ref
from repro_torch.kernels.decode_attn.kernel import route as attn_route
from repro_torch.kernels.decode_attn.ops import decode_attn
from repro_torch.kernels.decode_attn.ref import decode_attn_ref
from repro_torch.kernels.gemm_os.kernel import route as gemm_route
from repro_torch.kernels.gemm_os.ops import gemm_os
from repro_torch.kernels.gemm_os.ref import gemm_ref
from repro_torch.kernels.qgemm_int8.kernel import route as qgemm_route
from repro_torch.kernels.qgemm_int8.ops import qgemm_int8
from repro_torch.kernels.qgemm_int8.ref import (int_matmul_ref, qgemm_ref,
                                                quantize_rowwise)
from repro_torch.kernels.wkv6.kernel import CHUNK_T
from repro_torch.kernels.wkv6.kernel import route as wkv6_route
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
    kind = attn_route(D, H // Hkv, dtype)
    assert kind == ("simt" if dtype == torch.float32 else "tensor_core")
    before = decode_attn.launches
    before_route = decode_attn.launches_by_route[kind]
    got = decode_attn(*args)
    torch.cuda.synchronize()
    assert decode_attn.launches == before + 1
    assert decode_attn.launches_by_route[kind] == before_route + 1
    tol = 2e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), decode_attn_ref(*args).float(),
                               rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("H,Hkv,D,S", [(8, 8, 16, 77), (8, 4, 32, 300),
                                       (8, 4, 128, 513), (32, 4, 64, 129)])
def test_decode_attn_kernel_other_shapes(H, Hkv, D, S):
    """Every head_dim and group sizes G = 1, 2, 2, 8, in float32 at the
    2e-4 tolerance, with a row of length 0, which must give the plain
    version's value: the mean of its V over all S rows."""
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
    torch.testing.assert_close(got, decode_attn_ref(q, k, v, lens),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("D", [16, 32, 64, 128])
@pytest.mark.parametrize("G", [1, 2, 4, 8])
def test_decode_attn_tensor_core_matches_plain(G, D):
    """The tensor-core route (mma.sync flash-decode) for every head_dim and
    the group sizes of one tile up to 8, in bf16 within 2e-2 of the plain
    version (outputs below 2 may land one bf16 step apart), at ragged
    lengths that straddle its 16-key warp slices and 64-key steps, S
    itself, and 0, whose row must give the plain version's mean of V."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    S, Hkv = 700, 2
    lens_list = [0, 1, 63, 64, 65, S, 300, 257]
    B = len(lens_list)
    rng = np.random.default_rng(100 * G + D)
    q, k, v = (torch.from_numpy(rng.normal(size=shape)).to("cuda",
                                                            torch.bfloat16)
               for shape in ((B, G * Hkv, D), (B, Hkv, S, D), (B, Hkv, S, D)))
    lens = torch.tensor(lens_list, dtype=torch.int32, device="cuda")
    assert attn_route(D, G, torch.bfloat16) == "tensor_core"
    before = decode_attn.launches_by_route["tensor_core"]
    got = decode_attn(q, k, v, lens)
    torch.cuda.synchronize()
    assert decode_attn.launches_by_route["tensor_core"] == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    torch.testing.assert_close(got.float(),
                               decode_attn_ref(q, k, v, lens).float(),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [600, 2048])
def test_decode_attn_length_zero_matches_plain(S, dtype):
    """Rows of length 0 on both routes (bf16 on the tensor cores, float32
    on SIMT), at the serving shape and at an S that is no multiple of 64
    or 512: the mean of V over all S rows, as the plain version gives it,
    beside rows of other lengths."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(S + 1)
    B, H, Hkv, D = 4, 32, 8, 64
    q, k, v = (torch.from_numpy(rng.normal(size=shape)).to("cuda", dtype)
               for shape in ((B, H, D), (B, Hkv, S, D), (B, Hkv, S, D)))
    lens = torch.tensor([0, S, 0, 1], dtype=torch.int32, device="cuda")
    kind = attn_route(D, H // Hkv, dtype)
    assert kind == ("simt" if dtype == torch.float32 else "tensor_core")
    before = decode_attn.launches_by_route[kind]
    got = decode_attn(q, k, v, lens)
    torch.cuda.synchronize()
    assert decode_attn.launches_by_route[kind] == before + 1
    want = decode_attn_ref(q, k, v, lens)
    tol = 2e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    mean = v.float().mean(2).repeat_interleave(H // Hkv, 1)
    torch.testing.assert_close(got[[0, 2]].float(), mean[[0, 2]],
                               rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,Hkv,D", [(3, 8, 128), (5, 8, 128), (48, 1, 128),
                                     (16, 2, 64), (12, 2, 32), (48, 2, 16)])
def test_decode_attn_any_group_matches_plain(G, Hkv, D, dtype):
    """Groups the kernels have no tile of their own for: llama3.2-3b's 3,
    llama4-maverick's 5, granite-34b's 48 (at their head_dim 128), a full
    and a padded m16 tile (16, 12) and 48 at D 16.  Each runs on the route
    the rule gives (bf16 on the tensor cores, float32 on SIMT) and agrees
    with the plain version at ragged lengths and at length 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    S = 700
    lens_list = [0, 1, 65, S, 333]
    B = len(lens_list)
    rng = np.random.default_rng(G * D + Hkv)
    q, k, v = (torch.from_numpy(rng.normal(size=shape)).to("cuda", dtype)
               for shape in ((B, G * Hkv, D), (B, Hkv, S, D), (B, Hkv, S, D)))
    lens = torch.tensor(lens_list, dtype=torch.int32, device="cuda")
    kind = attn_route(D, G, dtype)
    assert kind == ("simt" if dtype == torch.float32 else "tensor_core")
    before = decode_attn.launches_by_route[kind]
    got = decode_attn(q, k, v, lens)
    torch.cuda.synchronize()
    assert decode_attn.launches_by_route[kind] == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    tol = 2e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(),
                               decode_attn_ref(q, k, v, lens).float(),
                               rtol=tol, atol=tol)


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


def _wkv6_inputs(B, T, H, D, dtype, seed, decays=(0.9, 0.999)):
    """r, k, v, w (in ``dtype``), u and a nonzero state0 (float32) on the
    card; w uniform in ``decays``, by default (0.9, 0.999), so the state
    carries many steps."""
    rng = np.random.default_rng(seed)
    r, k = (rng.normal(size=(B, T, H, D)) * 0.5 for _ in range(2))
    v = rng.normal(size=(B, T, H, D))
    w = rng.uniform(*decays, (B, T, H, D))
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
    torch.testing.assert_close(got[1], want[1].float(), rtol=1e-4,
                               atol=1e-4)


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
@pytest.mark.parametrize("D", [16, 32, 64, 128])
def test_wkv6_step_route_matches_plain(D, dtype):
    """The step route's C entry at T = 300, where the rule gives the
    chunked route: every D, from a nonzero state0 and from zeros."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.wkv6 import kernel as wk

    def step(r, k, v, w, u, s0=None):
        Bs, Ts, Hs, Ds = r.shape
        out = torch.empty_like(r)
        state = torch.empty((Bs, Hs, Ds, Ds), dtype=torch.float32,
                            device=r.device)
        err = wk._entries()["step"](
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), None if s0 is None else s0.data_ptr(),
            out.data_ptr(), state.data_ptr(), Bs, Ts, Hs, Ds,
            wk._DTYPES[r.dtype], torch.cuda.current_stream().cuda_stream)
        assert err == 0
        return out, state

    r, k, v, w, u, s0 = _wkv6_inputs(2, 300, 3, D, dtype, seed=D + 1)
    assert wkv6_route(2, 300, 3, D) == "chunked"
    got = step(r, k, v, w, u, s0)
    got0 = step(r, k, v, w, u)
    torch.cuda.synchronize()
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


# Decays of the chunked route's checks, and whether each is held against
# the plain version in float64.  Near 1 the state sums a thousand steps
# and outputs reach about 200; the plain version's own float32 rounding
# then reaches 2e-4 of the float64 value (the chunked form 8e-5, on the
# CPU at B 1, T 1000, H 2, D 64), so the exact value is the yardstick.
WKV6_DECAYS = {"near0": ((1e-4, 0.05), False), "near1": ((0.999, 0.99999),
                                                          True),
               "mid": ((0.9, 0.999), False)}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [16, 32, 64, 128])
@pytest.mark.parametrize("T,decays", [
    (1024, "near0"), (1024, "near1"), (777, "mid"),
    (CHUNK_T + 1, "mid")])
def test_wkv6_chunked_matches_plain(T, decays, D, dtype):
    """The chunked route at a batch-1 prefill of rwkv6-1.6b's longest
    prompt with decays near 0 and near 1, at T 777 and just above the
    route's threshold (a short last chunk each), from a nonzero state0,
    against the plain version at the step kernel's tolerances."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng_decays, exact = WKV6_DECAYS[decays]
    r, k, v, w, u, s0 = _wkv6_inputs(1, T, 4, D, dtype, seed=T + D,
                                     decays=rng_decays)
    assert wkv6_route(1, T, 4, D) == "chunked"
    before = wkv6.launches_by_route["chunked"]
    got = wkv6(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    assert wkv6.launches_by_route["chunked"] == before + 1
    assert got[0].dtype == dtype and got[1].dtype == torch.float32
    wide = torch.float64 if exact else torch.float32
    want = wkv6_ref(*(a.to(wide) for a in (r, k, v, w, u, s0)))
    _wkv6_close(got, (want[0].to(dtype), want[1]), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv6_state_chains_across_routes(dtype):
    """A prefill on the chunked route, then three decode steps on the step
    route, each from the state the last call left: the outputs and final
    state of the whole run, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    T, n_steps = 1000, 3
    r, k, v, w, u, s0 = _wkv6_inputs(2, T + n_steps, 4, 64, dtype, seed=9)
    before = dict(wkv6.launches_by_route)
    outs = []
    out, state = wkv6(*(a[:, :T].contiguous() for a in (r, k, v, w)), u, s0)
    outs.append(out)
    for t in range(T, T + n_steps):
        out, state = wkv6(*(a[:, t:t + 1].contiguous() for a in (r, k, v, w)),
                          u, state)
        outs.append(out)
    torch.cuda.synchronize()
    assert {kind: n - before[kind] for kind, n in
            wkv6.launches_by_route.items()} == {"chunked": 1,
                                                "step": n_steps}
    _wkv6_close((torch.cat(outs, 1), state), wkv6_ref(r, k, v, w, u, s0),
                dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("B,T,want", [(8, 1, "step"), (1, 32, "step"),
                                      (1, CHUNK_T - 1, "step"),
                                      (1, CHUNK_T, "chunked"),
                                      (3, 300, "chunked")])
def test_wkv6_counts_launches_by_route(B, T, want):
    """Each call counts one launch, on the route the rule gives it (the
    chunked route's three kernels are one launch), and agrees with the
    plain version there."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r, k, v, w, u, s0 = _wkv6_inputs(B, T, 4, 64, torch.bfloat16, seed=T)
    assert wkv6_route(B, T, 4, 64) == want
    before = dict(wkv6.launches_by_route), wkv6.launches
    got = wkv6(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    assert wkv6.launches == before[1] + 1
    assert {kind: n - before[0][kind] for kind, n in
            wkv6.launches_by_route.items()} == {
                kind: int(kind == want) for kind in before[0]}
    _wkv6_close(got, wkv6_ref(r, k, v, w, u, s0), torch.bfloat16)


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


# Table-I kernels.  float32: (rtol, atol) 1e-4, as tests/test_kernels.py
# holds the Pallas kernels; bf16 output: both round the same float32 sum
# once, so they may land one bf16 step (2^-7 relative) apart.
TABLE1_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2.0 ** -7, 1e-4)}


def _card(arr, dtype):
    return torch.from_numpy(np.asarray(arr, np.float32)).to("cuda", dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("act", [None, "relu", "gelu", "silu"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N", [(1000, 2000, 777), (8, 2048, 1000),
                                   (1, 1, 1), (129, 37, 255)])
def test_gemm_os_kernel_matches_plain(M, K, N, dtype, act):
    """Ragged M, N and K (none a multiple of the kernel's tiles, and the
    one-element product), every epilogue with a bias, float32 and bf16;
    weights at 1/sqrt(K) so outputs are of order one.  The 1-D tile grid
    gives the 2-D grid's result bit for bit.  Each call runs on the route
    the rule gives (bf16 8 x 2048 x 1000 on the tensor cores, the others
    on SIMT)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(M + K + N)
    a = _card(rng.normal(size=(M, K)), dtype)
    b = _card(rng.normal(size=(K, N)) / np.sqrt(K), dtype)
    bias = _card(rng.normal(size=(N,)), torch.float32)
    kind = gemm_route(M, K, N, dtype).kind
    before = gemm_os.launches
    before_route = gemm_os.launches_by_route[kind]
    got = gemm_os(a, b, bias, activation=act)
    flat = gemm_os(a, b, bias, activation=act, coalesce_grid=True)
    torch.cuda.synchronize()
    assert gemm_os.launches == before + 2
    assert gemm_os.launches_by_route[kind] == before_route + 2
    assert got.dtype == dtype and got.shape == (M, N)
    assert torch.equal(got, flat)
    rtol, atol = TABLE1_TOL[dtype]
    torch.testing.assert_close(got.float(),
                               gemm_ref(a, b, bias, act).float(),
                               rtol=rtol, atol=atol)


@pytest.mark.gpu
@pytest.mark.parametrize("act", [None, "relu", "gelu", "silu"])
@pytest.mark.parametrize("M,K,N", [(1024, 2048, 8192), (64, 512, 384),
                                   (8, 2048, 8192), (200, 136, 264)])
def test_gemm_os_tensor_core_matches_plain(M, K, N, act):
    """The tensor-core route (wgmma fed by TMA) at llama3.2-1b's ffn_in
    site in prefill and decode, at the largest M of the 64 x 64 tile, and
    with ragged M and K (136 is not a multiple of the 64-deep stage): every
    epilogue with a bias, within one bf16 step of the plain version, and
    the 1-D tile grid bit-equal to the 2-D one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(M + K + N)
    a = _card(rng.normal(size=(M, K)), torch.bfloat16)
    b = _card(rng.normal(size=(K, N)) / np.sqrt(K), torch.bfloat16)
    bias = _card(rng.normal(size=(N,)), torch.float32)
    assert gemm_route(M, K, N, torch.bfloat16).kind == "tensor_core"
    before = gemm_os.launches_by_route["tensor_core"]
    got = gemm_os(a, b, bias, activation=act)
    flat = gemm_os(a, b, bias, activation=act, coalesce_grid=True)
    torch.cuda.synchronize()
    assert gemm_os.launches_by_route["tensor_core"] == before + 2
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    assert torch.equal(got, flat)
    rtol, atol = TABLE1_TOL[torch.bfloat16]
    torch.testing.assert_close(got.float(),
                               gemm_ref(a, b, bias, act).float(),
                               rtol=rtol, atol=atol)


@pytest.mark.gpu
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_gemm_os_kernel_out_dtype(out_dtype):
    """bf16 inputs to a float32 output and back, no bias."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(3)
    a = _card(rng.normal(size=(300, 512)), torch.bfloat16)
    b = _card(rng.normal(size=(512, 200)) / np.sqrt(512), torch.bfloat16)
    got = gemm_os(a, b, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert got.dtype == out_dtype
    rtol, atol = TABLE1_TOL[out_dtype]
    torch.testing.assert_close(got.float(),
                               gemm_ref(a, b, out_dtype=out_dtype).float(),
                               rtol=rtol, atol=atol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,H,W,Cin,Cout,K", [
    (1, 66, 66, 1, 64, 3),       # Table-I CONV as Listing 2 writes it
    (3, 66, 66, 64, 64, 3),      # the batched edge layer, fewer images
    (2, 21, 35, 13, 72, 3),      # ragged tiles, Cin and Cout
    (1, 8, 8, 8, 8, 1), (2, 12, 12, 5, 3, 5)])
def test_conv2d_os_kernel_matches_plain(N, H, W, Cin, Cout, K, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(H * Cin + Cout)
    x = _card(rng.normal(size=(N, H, W, Cin)), dtype)
    w = _card(rng.normal(size=(K, K, Cin, Cout)) / np.sqrt(K * K * Cin),
              dtype)
    kind = conv_route(Cin, Cout, K, K, dtype).kind
    before = conv2d_os.launches
    before_route = conv2d_os.launches_by_route[kind]
    got = conv2d_os(x, w)
    torch.cuda.synchronize()
    assert conv2d_os.launches == before + 1
    assert conv2d_os.launches_by_route[kind] == before_route + 1
    assert got.dtype == dtype and got.shape == (N, H - K + 1, W - K + 1, Cout)
    rtol, atol = TABLE1_TOL[dtype]
    torch.testing.assert_close(got.float(), conv2d_ref(x, w).float(),
                               rtol=rtol, atol=atol)


@pytest.mark.gpu
@pytest.mark.parametrize("N,H,W,Cin,Cout,KH,KW", [
    (32, 66, 66, 64, 64, 3, 3),  # the batched Table-I CONV of the main path
    (2, 34, 50, 32, 96, 5, 5),   # Cin below one 64-channel chunk
    (1, 30, 40, 16, 24, 10, 10),  # the largest taps; ragged Cout tile
    (2, 20, 45, 136, 72, 10, 3),  # non-square taps, Cin over two chunks
])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_conv2d_os_tensor_core_matches_plain(N, H, W, Cin, Cout, KH, KW,
                                             out_dtype):
    """The tensor-core route (implicit GEMM on mma.sync, the patch staged
    by cp.async) within one bf16 step of the plain version in a bf16
    output, and within float32 rounding of it in a float32 output."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(H * Cin + Cout + KW)
    x = _card(rng.normal(size=(N, H, W, Cin)), torch.bfloat16)
    w = _card(rng.normal(size=(KH, KW, Cin, Cout)) / np.sqrt(KH * KW * Cin),
              torch.bfloat16)
    assert conv_route(Cin, Cout, KH, KW, torch.bfloat16).kind == "tensor_core"
    before = conv2d_os.launches_by_route["tensor_core"]
    got = conv2d_os(x, w, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert conv2d_os.launches_by_route["tensor_core"] == before + 1
    assert got.dtype == out_dtype and \
        got.shape == (N, H - KH + 1, W - KW + 1, Cout)
    rtol, atol = TABLE1_TOL[out_dtype]
    torch.testing.assert_close(got.float(),
                               conv2d_ref(x, w, out_dtype).float(),
                               rtol=rtol, atol=atol)


@pytest.mark.gpu
@pytest.mark.parametrize("N,H,W,KH,KW,want", [
    (1, 12, 60, 1, 31, "tensor_core"),  # the widest row the patch fits
    (2, 12, 70, 1, 40, "simt"),          # too wide for the tensor cores
    (1, 50, 20, 40, 1, "simt"),
])
def test_conv2d_os_wide_taps_matches_plain(N, H, W, KH, KW, want):
    """Aligned bf16 convolutions with wide non-square taps run on the route
    the rule gives them, within one bf16 step of the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    Cin = Cout = 64
    rng = np.random.default_rng(KH * 100 + KW)
    x = _card(rng.normal(size=(N, H, W, Cin)), torch.bfloat16)
    w = _card(rng.normal(size=(KH, KW, Cin, Cout)) / np.sqrt(KH * KW * Cin),
              torch.bfloat16)
    assert conv_route(Cin, Cout, KH, KW, torch.bfloat16).kind == want
    before = conv2d_os.launches_by_route[want]
    got = conv2d_os(x, w)
    torch.cuda.synchronize()
    assert conv2d_os.launches_by_route[want] == before + 1
    assert got.shape == (N, H - KH + 1, W - KW + 1, Cout)
    rtol, atol = TABLE1_TOL[torch.bfloat16]
    torch.testing.assert_close(got.float(), conv2d_ref(x, w).float(),
                               rtol=rtol, atol=atol)


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N", [(1024, 2048, 1000), (100, 96, 56),
                                   (1000, 2000, 777), (33, 37, 129),
                                   (1, 1, 1)])
def test_qgemm_int8_kernel_bit_exact(M, K, N):
    """Ragged M, N and K, K not a multiple of 4 (the kernel's byte path),
    on the SIMT route (N or K not a multiple of 16): the float32 output
    equals the plain version's bit for bit, and so does, with unit
    scales, the int32 accumulator (exact in float32 while it stays below
    2^24, which these inputs do)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(M + K + N)
    a, sa = quantize_rowwise(_card(rng.normal(size=(M, K)), torch.float32))
    bq, sb = quantize_rowwise(_card(rng.normal(size=(N, K)), torch.float32))
    b = bq.t().contiguous()
    assert qgemm_route(M, K, N) == "simt"
    before = qgemm_int8.launches
    before_route = qgemm_int8.launches_by_route["simt"]
    got = qgemm_int8(a, b, sa, sb)
    ones = qgemm_int8(a, b, torch.ones_like(sa), torch.ones_like(sb))
    half = qgemm_int8(a, b, sa, sb, out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert qgemm_int8.launches == before + 3
    assert qgemm_int8.launches_by_route["simt"] == before_route + 3
    assert torch.equal(got, qgemm_ref(a, b, sa, sb))
    assert torch.equal(half, qgemm_ref(a, b, sa, sb, torch.bfloat16))
    acc = int_matmul_ref(a, b)
    assert acc.abs().max().item() < 2 ** 24
    assert torch.equal(ones, acc.float())


@pytest.mark.gpu
def test_qgemm_int8_kernel_at_k_limit():
    """At the largest K the wrapper takes, every a and b at -128: the int32
    accumulator reaches K * 128^2 = 2^31 - 2^14 without wrapping (and is
    exact in float32, a multiple of 2^14 below 2^31)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.qgemm_int8.kernel import K_MAX

    a = torch.full((2, K_MAX), -128, dtype=torch.int8, device="cuda")
    b = torch.full((K_MAX, 3), -128, dtype=torch.int8, device="cuda")
    ones_a = torch.ones(2, device="cuda")
    ones_b = torch.ones(3, device="cuda")
    got = qgemm_int8(a, b, ones_a, ones_b)
    torch.cuda.synchronize()
    assert torch.equal(got, torch.full((2, 3), float(K_MAX * 128 ** 2),
                                       device="cuda"))
    assert torch.equal(got, qgemm_ref(a, b, ones_a, ones_b))


@pytest.mark.gpu
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N", [(1024, 2048, 8192), (200, 2064, 1040),
                                   (1, 16, 16), (129, 4096, 272),
                                   (64, 144, 128)])
def test_qgemm_int8_tensor_core_bit_exact(M, K, N, out_dtype):
    """The tensor-core route (wgmma s8, B transposed in the block) at the
    ffn_in site, with ragged M and K or N not a multiple of the 128 x 128
    tile or of the 128-deep stage: the output in both types equals the
    plain version's bit for bit, and with unit scales the int32
    accumulator does too (exact in float32 below 2^24)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(M + K + N)
    a, sa = quantize_rowwise(_card(rng.normal(size=(M, K)), torch.float32))
    bq, sb = quantize_rowwise(_card(rng.normal(size=(N, K)), torch.float32))
    b = bq.t().contiguous()
    assert qgemm_route(M, K, N) == "tensor_core"
    before = qgemm_int8.launches_by_route["tensor_core"]
    got = qgemm_int8(a, b, sa, sb, out_dtype=out_dtype)
    ones = qgemm_int8(a, b, torch.ones_like(sa), torch.ones_like(sb))
    torch.cuda.synchronize()
    assert qgemm_int8.launches_by_route["tensor_core"] == before + 2
    assert got.dtype == out_dtype and got.shape == (M, N)
    assert torch.equal(got, qgemm_ref(a, b, sa, sb, out_dtype))
    acc = int_matmul_ref(a, b)
    assert acc.abs().max().item() < 2 ** 24
    assert torch.equal(ones, acc.float())


@pytest.mark.gpu
def test_qgemm_int8_tensor_core_at_k_limit():
    """At the largest K the tensor-core route takes under the wrapper's
    limit (131056, the last multiple of 16 below K_MAX), every a and b at
    -128: the int32 accumulator reaches K * 128^2 = 8191 * 2^18 without
    wrapping, exact in float32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.qgemm_int8.kernel import K_MAX

    K = K_MAX // 16 * 16
    assert qgemm_route(2, K, 16) == "tensor_core"
    a = torch.full((2, K), -128, dtype=torch.int8, device="cuda")
    b = torch.full((K, 16), -128, dtype=torch.int8, device="cuda")
    ones_a = torch.ones(2, device="cuda")
    ones_b = torch.ones(16, device="cuda")
    before = qgemm_int8.launches_by_route["tensor_core"]
    got = qgemm_int8(a, b, ones_a, ones_b)
    torch.cuda.synchronize()
    assert qgemm_int8.launches_by_route["tensor_core"] == before + 1
    assert torch.equal(got, torch.full((2, 16), float(K * 128 ** 2),
                                       device="cuda"))
    assert torch.equal(got, qgemm_ref(a, b, ones_a, ones_b))


@pytest.mark.gpu
def test_bench_kernel_micro_on_card(monkeypatch):
    """The kernel path's entry point on the card, at small shapes: every
    row timed, every op launched as often as its rows say."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch import bench

    monkeypatch.setattr(bench, "SHAPES", dict(gemm=(16, 64, 96),
                                              conv=(2, 10, 10, 4, 8, 3)))
    ops = {"gemm_os": gemm_os, "decode_attn": decode_attn,
           "conv2d_os": conv2d_os, "qgemm_int8": qgemm_int8}
    before = {k: op.launches for k, op in ops.items()}
    rows = bench.bench_kernel_micro()
    calls = {k: 0 for k in ops}
    for r in rows:
        assert r["us"] > 0
        calls[r["derived"]["kernel"]] += r["derived"]["calls"]
    assert {k: op.launches - before[k] for k, op in ops.items()} == calls


# ----------------------------------------------------------- the CGRA flow
# The six Table-I kernels at small dims and the four DSL kernels, compiled
# by the port on the host; the card's results are held word for word
# against the port's own CPU path (which the CPU tests hold against JAX).
CGRA_SET = ["GEMM", "GEMM-U", "GEMM-U-C", "CONV", "CONV-U-C-1",
            "CONV-U-C-2", "dwconv", "avgpool2x2", "gemm-bias-relu",
            "requant-int8"]
CGRA_SEEDS = list(range(16))


@pytest.fixture(scope="module")
def cgra_set():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.core import Toolchain, table1_kernels
    from repro_torch.frontend.library import dsl_kernels
    specs = {**table1_kernels(small=True), **dsl_kernels()}
    cks = Toolchain(cache_dir="").compile_many([specs[n] for n in CGRA_SET])
    return dict(zip(CGRA_SET, cks))


def _same_banks(want, got, label):
    assert len(want) == len(got)
    for i, (w, g) in enumerate(zip(want, got)):
        for bank in w:
            assert g[bank].dtype == w[bank].dtype, label
            np.testing.assert_array_equal(g[bank], w[bank],
                                          err_msg=f"{label} {i} {bank}")


@pytest.mark.gpu
@pytest.mark.parametrize("tile_limit", [None, 0])
@pytest.mark.parametrize("name", CGRA_SET)
def test_cgra_simulate_batch_on_card_matches_cpu(cgra_set, name,
                                                 tile_limit, monkeypatch):
    """Both store-gate paths: tabulated (the default at these sizes) and
    derived each cycle (tiling cap 0)."""
    from repro_torch.core import simulator
    from repro_torch.core.verify import generate_test_data
    if tile_limit is not None:
        monkeypatch.setattr(simulator, "_TILE_BYTES_LIMIT", tile_limit)
    ck = cgra_set[name]
    init = [generate_test_data(ck.spec, s).init_banks for s in CGRA_SEEDS]
    _same_banks(ck.run_batch(init, device="cpu"),
                ck.run_batch(init, device="cuda"), name)
    _same_banks([ck.run(init[0], device="cpu")],
                [ck.run(init[0], device="cuda")], name)


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [8, 32])
def test_cgra_int32_carrier_on_card_matches_cpu(bits):
    """Datapaths other than 16 bits run on int32 carriers (an explicit
    wrap at 8 bits, int32 overflow at 32)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import dataclasses
    from repro_torch.core import Toolchain, cluster_4x4, table1_kernels
    from repro_torch.core.toolchain import CompiledKernel
    arch = dataclasses.replace(cluster_4x4(), datapath_bits=bits)
    ck = CompiledKernel.from_json(Toolchain(cache_dir="").compile(
        table1_kernels(small=True, arch=arch)["GEMM"]).to_json())
    init = [ck.random_banks(s) for s in CGRA_SEEDS]
    _same_banks(ck.run_batch(init, device="cpu"),
                ck.run_batch(init, device="cuda"), f"{bits}-bit")
    ck.verify_batch(CGRA_SEEDS, device="cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", CGRA_SET)
def test_cgra_oracle_on_card_matches_numpy(cgra_set, name):
    from repro_torch.core.refexec import reference_execute_torch
    from repro_torch.core.verify import generate_test_data
    spec = cgra_set[name].spec
    inits = [generate_test_data(spec, s).init_banks for s in CGRA_SEEDS]
    stacked = {k: np.stack([i[k] for i in inits]) for k in inits[0]}
    bits = spec.arch.datapath_bits
    want = spec.dfg.reference_execute_batch(
        spec.mapped_iters, {k: v.astype(np.int64) for k, v in stacked.items()},
        spec.invocations, bits=bits)
    got = reference_execute_torch(spec.dfg, spec.mapped_iters, stacked,
                                  spec.invocations, bits, device="cuda")
    for bank in want:
        np.testing.assert_array_equal(got[bank], want[bank], err_msg=bank)


@pytest.mark.gpu
def test_cgra_verify_stacked_on_card():
    """dwconv and requant-int8 on fabrics with 4, 8 and 16 registers: each
    kernel's three variants in one 16-register stacked cycle loop."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.bench import RF_COHORT, rf_cohort_arch
    from repro_torch.core import Toolchain
    from repro_torch.core.toolchain import verify_stacked
    from repro_torch.frontend.library import dsl_kernels
    tc = Toolchain(cache_dir="")
    cks = [tc.compile(dsl_kernels(rf_cohort_arch(rf))[name])
           for name in ("dwconv", "requant-int8") for rf in RF_COHORT]
    assert verify_stacked(cks, range(64), device="cuda") == cks
    for ck in cks:
        ck.verify_batch(range(8), device="cuda")


# ------------------------------------------------- the CGRA flow's tools
@pytest.mark.gpu
@pytest.mark.parametrize("name", CGRA_SET)
def test_cgra_cross_validate_on_card(cgra_set, name):
    """The standalone interpreter ≡ the simulator on the card, 4 seeds."""
    from repro_torch.isa import cross_validate
    assert cross_validate(cgra_set[name], seeds=range(4),
                          device="cuda") == 4


@pytest.mark.gpu
@pytest.mark.parametrize("env", ["MORPHER_CHECK", "MORPHER_XVAL"])
def test_cgra_verify_gates_on_card(cgra_set, env, monkeypatch):
    from repro_torch.core.toolchain import verify_stacked
    monkeypatch.setenv(env, "1")
    cks = list(cgra_set.values())
    for ck in cks:
        ck.verify_batch(range(4), device="cuda")
    assert verify_stacked(cks, range(2), device="cuda") == cks


@pytest.mark.gpu
def test_cgra_mutation_gate_on_card_matches_cpu(cgra_set):
    from repro_torch.check.mutate import MIN_SCORE, mutation_gate
    cks = list(cgra_set.values())
    card = mutation_gate(cks, device="cuda")
    assert card.score >= MIN_SCORE
    assert card.to_json_dict() == mutation_gate(cks, device="cpu") \
        .to_json_dict()


@pytest.mark.gpu
@pytest.mark.parametrize("cls", ["mux_select", "store_window",
                                 "bank_clobber", "rf_overcommit",
                                 "load_hazard", "opcode_clobber",
                                 "livein_clobber", "nbr_clobber"])
def test_cgra_probe_on_card_matches_cpu(cgra_set, cls):
    """The dead-mutant probe simulates every config-layer mutant class on
    the card (the gate probes only the checker's misses, and the library
    has none): the card's verdict is the CPU's."""
    from repro_torch.check.mutate import CLASSES, _probe_dead, mutate_one
    layer = CLASSES[cls][0]
    for name in ("requant-int8", "dwconv"):
        ck = cgra_set[name]
        made = mutate_one(ck, cls, seed=0, index=0)
        if made is not None:
            assert _probe_dead(ck, layer, made[0], device="cuda") == \
                _probe_dead(ck, layer, made[0], device="cpu"), made[1]


@pytest.mark.gpu
def test_dse_tiny_frontier_on_card_matches_cpu(tmp_path):
    """tiny[:2]: the sweep verifying on the card writes the frontier the
    sweep verifying on the CPU writes, byte for byte."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.core import MapperOptions, Toolchain
    from repro_torch.dse import get_space, run_sweep, write_artifacts
    points = get_space("tiny")[:2]
    out = {}
    for dev in ("cpu", "cuda"):
        tc = Toolchain(options=MapperOptions(ii_max=20),
                       cache_dir=str(tmp_path / "cache"))
        res = run_sweep(points, toolchain=tc, device=dev)
        write_artifacts(res, str(tmp_path / dev), space="tiny")
        out[dev] = (tmp_path / dev / "dse_frontier.json").read_bytes()
    assert out["cuda"] == out["cpu"]


@pytest.mark.gpu
def test_serve_plan_spot_check_on_card():
    """llama3.2-1b's plan spot-checks every distinct tile on the card over
    64 seeds, naming the sites the CPU's check names."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.configs.registry import get_config
    from repro_torch.core import Toolchain
    from repro_torch.serve.plan import build_serve_plan
    plan = build_serve_plan(get_config("llama3.2-1b"),
                            toolchain=Toolchain(cache_dir=""),
                            spot_check=False)
    n = len(plan.sites)
    assert plan.spot_check(seeds=range(64), n_sites=n) == \
        plan.spot_check(seeds=range(4), n_sites=n, device="cpu") == \
        [plan.sites[0].name]


# head_dim 128 at the dense configs' own GQA groups, narrow otherwise
DENSE_GROUPS = {"llama3.2-3b": (6, 2), "codeqwen1.5-7b": (4, 4),
                "granite-34b": (48, 1)}


@pytest.mark.gpu
@pytest.mark.parametrize("arch_id", sorted(DENSE_GROUPS))
def test_dense_decode_step_kernel_matches_plain(arch_id, monkeypatch):
    """One bf16 decode step of a two-layer model at head_dim 128 and the
    config's group (G 3, 1, 48): decode_attn on the tensor-core route, one
    launch per layer, logits within 5% of the largest logit of the same
    step with the plain version (chip_smoke.py's LOGITS_REL_TOL)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import dataclasses

    import repro_torch.models.attention as attention
    from repro_torch.configs.registry import get_config
    from repro_torch.models.zoo import build_model, cache_tensors

    H, Hkv = DENSE_GROUPS[arch_id]
    cfg = dataclasses.replace(get_config(arch_id), n_layers=2, d_model=256,
                              n_heads=H, n_kv_heads=Hkv, head_dim=128,
                              d_ff=512, vocab=512)
    assert attn_route(128, H // Hkv, cfg.dtype) == "tensor_core"
    model = build_model(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    B, S, T = 4, 256, 100
    caches = model.init_cache(B, S)
    toks = torch.randint(0, cfg.vocab, (B, T), device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(1))
    _, pre = model.prefill(params, toks, torch.full((B,), T, device="cuda"))
    for full, new in zip(cache_tensors(caches), cache_tensors(pre)):
        full[:, :, :, :T] = new
    lens = torch.tensor([T - 60, T - 1, T - 30, T], device="cuda")
    step = (toks[:, -1:], (lens - 1)[:, None], lens.to(torch.int32))
    saved = [c.clone() for c in cache_tensors(caches)]
    before = decode_attn.launches_by_route["tensor_core"]
    logits, _ = model.decode(params, caches, *step)
    torch.cuda.synchronize()
    assert decode_attn.launches_by_route["tensor_core"] == \
        before + cfg.n_layers
    for c, s in zip(cache_tensors(caches), saved):
        c.copy_(s)
    monkeypatch.setattr(attention, "decode_attn", decode_attn_ref)
    plain, _ = model.decode(params, caches, *step)
    logits, plain = logits.float(), plain.float()
    assert torch.isfinite(logits).all() and logits.shape == (B, 1, cfg.vocab)
    scale = plain.abs().max().item()
    assert (logits - plain).abs().max().item() <= 5e-2 * scale


# The families of PR 20: their code runs no kernel of its own (MoE
# routing and experts, MLA, MTP, the Mamba2 scan, embedding inputs)
NEW_FAMILIES = ("zamba2-1.2b", "llama4-maverick-400b-a17b",
                "deepseek-v3-671b", "musicgen-large",
                "llava-next-mistral-7b")


@pytest.mark.gpu
@pytest.mark.parametrize("arch_id", NEW_FAMILIES)
def test_new_family_card_matches_cpu(arch_id, monkeypatch):
    """serve_smoke_config size in float32, TF32 off, the CPU's parameters
    copied to the card: prefill and 3 chained decode steps give logits
    within 1e-4 on both, and every MoE routing the same expert choices
    (idx) and kept choices (keep)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import repro_torch.models.moe as moe
    from repro_torch.configs.registry import serve_smoke_config
    from repro_torch.models.zoo import build_model, cache_tensors

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    cfg = serve_smoke_config(arch_id)
    rng = np.random.default_rng(0)
    B, T, S = 2, 8, 16
    shapes = [(B, T)] + [(B, 1)] * 3
    if cfg.input_mode == "tokens":
        inputs = [torch.from_numpy(rng.integers(0, cfg.vocab, sh))
                  for sh in shapes]
    else:
        inputs = [torch.from_numpy(rng.normal(size=(*sh, cfg.d_model))
                                   .astype(np.float32)) for sh in shapes]
    cpu_model = build_model(cfg, device="cpu")
    cpu_params = cpu_model.init(torch.Generator().manual_seed(0))
    route = moe.moe_route
    runs = {}
    for dev in ("cuda", "cpu"):
        model = cpu_model if dev == "cpu" else build_model(cfg, device=dev)
        params = cpu_params if dev == "cpu" else \
            copy.deepcopy(cpu_params).to(dev)
        seen = []

        def recording(router, xf, k, C):
            out = route(router, xf, k, C)
            seen.append((out[2].cpu(), out[3].cpu()))
            return out

        monkeypatch.setattr(moe, "moe_route", recording)
        x = [a.to(dev) for a in inputs]
        logits, pre = model.prefill(params, x[0],
                                    torch.full((B,), T, device=dev))
        out = [logits.cpu()]
        caches = model.init_cache(B, S)
        for full, new in zip(cache_tensors(caches), cache_tensors(pre)):
            if full.shape == new.shape:
                full.copy_(new)
            else:
                ax = next(a for a in range(2, new.ndim)
                          if new.shape[a] != full.shape[a])
                full.narrow(ax, 0, T).copy_(new)
        for t in range(3):
            pos = torch.tensor([[T + t], [T + 1 + t]], device=dev)
            logits, caches = model.decode(params, caches, x[1 + t], pos,
                                          pos[:, 0] + 1)
            out.append(logits.cpu())
        runs[dev] = (out, seen)
    for got, want in zip(runs["cuda"][0], runs["cpu"][0]):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    card_routes, cpu_routes = runs["cuda"][1], runs["cpu"][1]
    assert len(card_routes) == len(cpu_routes) == (
        (1 + 3) * (cfg.n_layers - cfg.first_k_dense) if cfg.moe else 0)
    for (idx, keep), (want_idx, want_keep) in zip(card_routes, cpu_routes):
        assert torch.equal(idx, want_idx) and torch.equal(keep, want_keep)
