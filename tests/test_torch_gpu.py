"""The port's CUDA kernels against their plain versions, on a card.

Imports neither JAX nor the JAX package, so it runs on the machine with
the card:  PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
Elsewhere each test skips with its reason."""
import copy

import numpy as np
import pytest
import torch

from repro_torch.kernels.conv2d_os.kernel import MIN_TF32_CIN, conv2d_os_cuda
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
from repro_torch.kernels.wkv6.kernel import (BWD_CHUNK_T, CHUNK_T,
                                             backward_route)
from repro_torch.kernels.wkv6.kernel import route as wkv6_route
from repro_torch.kernels.wkv6.ops import wkv6, wkv6_backward
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
@pytest.mark.parametrize("S,G,Hkv,D", [
    (S, G, Hkv, D) for S in (512, 2048) for G, Hkv in
    ((1, 8), (4, 2), (8, 2), (48, 1)) for D in (16, 64, 128)]
    + [(100000, 1, 8, 64), (100000, 4, 2, 16)])
def test_decode_attn_float32_one_launch_matches_plain(S, G, Hkv, D):
    """float32 at the head_dims of the vector kernel, which merges its own
    splits in one launch (by ticket, the last block of a group merging in
    split order): ragged lengths, length 0 (the mean of V) and a full
    row, from one split up to hundreds a row, G 1/4/8/48, against the
    plain version at 2e-4; a rerun, and the same call on a second stream
    (its own ticket buffer), bit-equal; one launch counted a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    lens_list = [0, 1, 127, 129, S, S // 3, 0, S - 1]
    B = len(lens_list)
    rng = np.random.default_rng(S + G * D + Hkv)
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
               .to("cuda") for shape in ((B, G * Hkv, D), (B, Hkv, S, D),
                                         (B, Hkv, S, D)))
    lens = torch.tensor(lens_list, dtype=torch.int32, device="cuda")
    assert attn_route(D, G, torch.float32) == "simt"
    before = decode_attn.launches_by_route["simt"]
    got = decode_attn(q, k, v, lens)
    again = decode_attn(q, k, v, lens)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        other = decode_attn(q, k, v, lens)
    torch.cuda.synchronize()
    assert decode_attn.launches_by_route["simt"] == before + 3
    assert torch.equal(got, again) and torch.equal(got, other)
    torch.testing.assert_close(got, decode_attn_ref(q, k, v, lens),
                               rtol=2e-4, atol=2e-4)
    mean = v.mean(2).repeat_interleave(G, 1)
    torch.testing.assert_close(got[[0, 6]], mean[[0, 6]], rtol=2e-4,
                               atol=2e-4)


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
    """A prefill on the chunked route, then three decode steps on the
    decode route, each from the state the last call left: the outputs and
    final state of the whole run, on the card."""
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
            wkv6.launches_by_route.items()} == {"chunked": 1, "step": 0,
                                                "decode": n_steps}
    _wkv6_close((torch.cat(outs, 1), state), wkv6_ref(r, k, v, w, u, s0),
                dtype)


def _wkv6_entry_call(kind, r, k, v, w, u, s0, state):
    """wkv6 on the ``kind`` route's C entry (``decode`` or ``step``), its
    new state written to ``state``, which may be ``s0`` itself."""
    from repro_torch.kernels.wkv6 import kernel as wk
    Bs, Ts, Hs, Ds = r.shape
    out = torch.empty_like(r)
    err = wk._entries()[kind](
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
        u.data_ptr(), None if s0 is None else s0.data_ptr(), out.data_ptr(),
        state.data_ptr(), Bs, Ts, Hs, Ds, wk._DTYPES[r.dtype],
        torch.cuda.current_stream().cuda_stream)
    assert err == 0
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,D", [(8, 32, 64), (3, 5, 16), (2, 7, 32),
                                   (4, 3, 128), (1, 1, 64)])
def test_wkv6_decode_matches_plain(B, H, D, dtype):
    """The decode route (T = 1) at every D it is built for: from a
    nonzero state and from zeros, through the op (one launch on decode)
    and on its C entry with the new state written over state0 (aliased),
    held to wkv6_ref at the step kernel's tolerances; a rerun bit-equal;
    the step kernel it replaced, on the same inputs, within the same
    tolerances."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r, k, v, w, u, s0 = _wkv6_inputs(B, 1, H, D, dtype, seed=B * H + D)
    assert wkv6_route(B, 1, H, D) == "decode"
    want, want0 = wkv6_ref(r, k, v, w, u, s0), wkv6_ref(r, k, v, w, u)
    before = dict(wkv6.launches_by_route)
    got, again = wkv6(r, k, v, w, u, s0), wkv6(r, k, v, w, u, s0)
    got0 = wkv6(r, k, v, w, u)
    torch.cuda.synchronize()
    assert {kind: n - before[kind] for kind, n in
            wkv6.launches_by_route.items()} == {"decode": 3, "step": 0,
                                                "chunked": 0}
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    _wkv6_close(got, want, dtype)
    _wkv6_close(got0, want0, dtype)
    state = s0.clone()
    out = _wkv6_entry_call("decode", r, k, v, w, u, state, state)
    torch.cuda.synchronize()
    assert torch.equal(out, got[0]) and torch.equal(state, got[1])
    step_state = torch.empty_like(s0)
    step_out = _wkv6_entry_call("step", r, k, v, w, u, s0, step_state)
    torch.cuda.synchronize()
    _wkv6_close((step_out, step_state), want, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("B,T,want", [(8, 1, "decode"), (1, 32, "step"),
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


def _wkv6_grads(r, k, v, w, u, s0, go, gs, wide):
    """Gradients of (r, k, v, w, u, state0) by autograd through wkv6_ref
    on the inputs as given (``wide`` None: their own dtypes, the plain
    backward) or widened to ``wide``."""
    ins = [a if wide is None else a.to(wide) for a in (r, k, v, w, u)]
    ins += [None if s0 is None else (s0 if wide is None else s0.to(wide))]
    ins = [None if a is None else a.detach().requires_grad_() for a in ins]
    out, st = wkv6_ref(*ins)
    outs = [(out, go)] + ([(st, gs)] if gs is not None else [])
    wanted = [a for a in ins if a is not None]
    grads = torch.autograd.grad(
        [o for o, _ in outs],
        wanted, [g if wide is None else g.to(wide) for _, g in outs])
    return list(grads) + ([None] if s0 is None else [])


def _wkv6_grads_held(got, inputs):
    """Each gradient against float64 autograd through wkv6_ref within the
    larger of 1e-4 of its largest |g| and the plain backward's own error
    (autograd through wkv6_ref in the inputs' dtypes, float32 arithmetic,
    each gradient rounded once to its dtype, as the kernel's is)."""
    exact = _wkv6_grads(*inputs, torch.float64)
    plain = _wkv6_grads(*inputs, None)
    for name, g, e, p in zip("r k v w u state0".split(), got, exact, plain):
        if e is None:
            continue
        assert g.dtype == p.dtype, name
        tol = max(1e-4 * e.abs().max().item(),
                  (p.double() - e).abs().max().item())
        err = (g.double() - e).abs().max().item()
        assert err <= tol, (name, err, tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,H,D,decays,with_state", [
    (2, 256, 32, 64, (0.9, 0.999), False),     # rwkv6-1.6b's training shape
    (2, 48, 4, 80, (0.9, 0.999), True),        # the step route, D 80
    (1, 1, 2, 16, (0.9, 0.999), True),
    (2, CHUNK_T, 3, 32, (1e-4, 0.05), True),   # one whole chunk
    (2, 130, 3, 64, (0.999, 0.99999), True),   # a ragged last chunk
    (1, 100, 2, 48, (0.9, 0.999), True),       # registers, masked to D
    (1, 200, 2, 256, (0.9, 0.999), False)])
def test_wkv6_backward_kernel_matches_plain(B, T, H, D, decays, with_state,
                                            dtype):
    """The Function's backward on the card (the backward kernels, on the
    route the shape gives them: ``parallel`` for D 16 / 32 / 64, the first
    kernel's ``step`` / ``chunked`` by T for other D, on registers up to
    64 and past it), both forward routes, against float64 autograd through
    wkv6_ref."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r, k, v, w, u, s0 = _wkv6_inputs(B, T, H, D, dtype, seed=T + D,
                                     decays=decays)
    s0 = s0 if with_state else None
    gen = torch.Generator(device="cuda").manual_seed(T)
    go = torch.randn((B, T, H, D), generator=gen, device="cuda").to(dtype)
    gs = torch.randn((B, H, D, D), generator=gen, device="cuda") \
        if with_state else None
    ins = [a.detach().requires_grad_() for a in (r, k, v, w, u)]
    ins.append(None if s0 is None else s0.detach().requires_grad_())
    before = wkv6_backward.launches, dict(wkv6_backward.launches_by_route)
    out, st = wkv6(*ins)
    outs = [(out, go)] + ([(st, gs)] if gs is not None else [])
    got = list(torch.autograd.grad([o for o, _ in outs],
                                   [a for a in ins if a is not None],
                                   [g for _, g in outs]))
    torch.cuda.synchronize()
    kind = backward_route(B, T, H, D)
    assert wkv6_backward.launches == before[0] + 1
    assert wkv6_backward.launches_by_route[kind] == before[1][kind] + 1
    _wkv6_grads_held(got + ([None] if s0 is None else []),
                     (r, k, v, w, u, s0, go, gs))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,T,with_state,g_state,decays", [
    (16, 1, True, True, (0.9, 0.999)),              # one step
    (32, BWD_CHUNK_T - 3, False, True, (1e-4, 0.05)),  # T < one chunk
    (64, BWD_CHUNK_T, True, False, (0.999, 0.99999)),  # one whole chunk
    (64, 5 * BWD_CHUNK_T + 3, False, False, (0.9, 0.999)),  # ragged
    (16, 4 * BWD_CHUNK_T, True, True, (0.999, 0.99999)),
    (32, 7 * BWD_CHUNK_T + 1, True, False, (0.9, 0.999)),
    (64, 256, False, True, (1e-4, 0.05)),
    (64, 256, True, True, (0.999, 0.99999)),
    (80, 130, True, True, (0.9, 0.999)),            # stays on chunked
    (80, 10, False, False, (0.999, 0.99999))])      # stays on step
def test_wkv6_backward_parallel_matches_plain(D, T, with_state, g_state,
                                              decays, dtype):
    """``wkv6_backward`` on the route ``backward_route`` gives (parallel
    for D 16 / 32 / 64 at any T; the first kernel's for D 80), with and
    without state0 and g_state, each decay range: every gradient within
    the larger of 1e-4 of its largest |g| and the plain backward's own
    error of float64 autograd through wkv6_ref, two calls bit-equal, the
    launch counted on its route."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    B, H = 2, 3
    r, k, v, w, u, s0 = _wkv6_inputs(B, T, H, D, dtype, seed=3 * T + D,
                                     decays=decays)
    s0 = s0 if with_state else None
    gen = torch.Generator(device="cuda").manual_seed(T + D)
    go = torch.randn((B, T, H, D), generator=gen, device="cuda").to(dtype)
    gs = torch.randn((B, H, D, D), generator=gen, device="cuda") \
        if g_state else None
    kind = backward_route(B, T, H, D)
    assert kind == ("parallel" if D in (16, 32, 64) else
                    "chunked" if T > CHUNK_T else "step")
    before = wkv6_backward.launches, dict(wkv6_backward.launches_by_route)
    got = wkv6_backward(r, k, v, w, u, s0, go, gs)
    again = wkv6_backward(r, k, v, w, u, s0, go, gs)
    torch.cuda.synchronize()
    assert wkv6_backward.launches == before[0] + 2
    assert {n: c - before[1][n] for n, c in
            wkv6_backward.launches_by_route.items()} == {
                n: 2 * (n == kind) for n in before[1]}
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    _wkv6_grads_held(list(got[:5]) + [got[5] if with_state else None],
                     (r, k, v, w, u, s0, go, gs))


@pytest.mark.gpu
@pytest.mark.parametrize("T", [40, 300])
def test_wkv6_backward_kernel_is_deterministic(T):
    """Two calls on the same inputs give the same gradients bit for bit
    (no atomics: each element is summed by one thread in a fixed order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r, k, v, w, u, s0 = _wkv6_inputs(2, T, 4, 64, torch.bfloat16, seed=T)
    go = torch.randn((2, T, 4, 64), device="cuda").bfloat16()
    gs = torch.randn((2, 4, 64, 64), device="cuda")
    first = wkv6_backward(r, k, v, w, u, s0, go, gs)
    second = wkv6_backward(r, k, v, w, u, s0, go, gs)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


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


# The float32 tf32x3 routes (three TF32 products per term): each held to
# the plain version at TABLE1_TOL, and its max error against a float64
# product to TF32X3_ERR_FACTOR times the library call's own float32 error
# (TF32 off) on the same inputs, or times TF32X3_ERR_FLOOR where that is
# smaller: a short sum's float32 error is a few ulps, and its max over a
# small output is noise.
TF32X3_ERR_FACTOR, TF32X3_ERR_FLOOR = 8, 1e-6


@pytest.fixture
def no_tf32():
    """TF32 off in the library calls (torch.matmul and cuDNN), as the
    yardsticks of the float32 routes; restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


def _within_library_error(got, library, want64):
    err = (got.double() - want64).abs().max().item()
    lib = (library.double() - want64).abs().max().item()
    assert err <= TF32X3_ERR_FACTOR * max(lib, TF32X3_ERR_FLOOR), (err, lib)


@pytest.mark.gpu
@pytest.mark.parametrize("act", [None, "relu", "gelu", "silu"])
@pytest.mark.parametrize("M,K,N", [(1024, 2048, 8192), (200, 36, 260),
                                   (8, 2048, 1000), (129, 4100, 132),
                                   (1000, 2000, 776), (64, 512, 384)])
def test_gemm_os_tf32x3_matches_plain(M, K, N, act, no_tf32):
    """The float32 tensor-core route at the ffn_in site, ragged M, K not a
    multiple of its 32-deep stage, M <= 64 and both tiles, with every
    epilogue and a bias: within the Table-I float32 tolerance of the plain
    version, within the library's error of float64, two calls and the 1-D
    tile grid bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(M + K + N)
    a = _card(rng.normal(size=(M, K)), torch.float32)
    b = _card(rng.normal(size=(K, N)) / np.sqrt(K), torch.float32)
    bias = _card(rng.normal(size=(N,)), torch.float32)
    assert gemm_route(M, K, N, torch.float32).kind == "tf32x3"
    before = gemm_os.launches_by_route["tf32x3"]
    got = gemm_os(a, b, bias, activation=act)
    again = gemm_os(a, b, bias, activation=act)
    flat = gemm_os(a, b, bias, activation=act, coalesce_grid=True)
    torch.cuda.synchronize()
    assert gemm_os.launches_by_route["tf32x3"] == before + 3
    assert got.dtype == torch.float32 and got.shape == (M, N)
    assert torch.equal(got, again) and torch.equal(got, flat)
    rtol, atol = TABLE1_TOL[torch.float32]
    torch.testing.assert_close(got, gemm_ref(a, b, bias, act), rtol=rtol,
                               atol=atol)
    if act is None:
        _within_library_error(got, torch.matmul(a, b) + bias,
                              a.double() @ b.double() + bias.double())


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N", [(300, 512, 200), (8, 64, 1024)])
def test_gemm_os_tf32x3_bf16_output(M, K, N):
    """float32 in, bf16 out: one rounding of the float32 sum, within one
    bf16 step of the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(M * N)
    a = _card(rng.normal(size=(M, K)), torch.float32)
    b = _card(rng.normal(size=(K, N)) / np.sqrt(K), torch.float32)
    before = gemm_os.launches_by_route["tf32x3"]
    got = gemm_os(a, b, out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert gemm_os.launches_by_route["tf32x3"] == before + 1
    assert got.dtype == torch.bfloat16
    rtol, atol = TABLE1_TOL[torch.bfloat16]
    torch.testing.assert_close(
        got.float(), gemm_ref(a, b, out_dtype=torch.bfloat16).float(),
        rtol=rtol, atol=atol)


@pytest.mark.gpu
def test_gemm_os_tf32x3_non_finite_inputs():
    """An infinity and a NaN in A and B: through the split, inf x b would
    add inf b_hi and inf b_lo (NaN where their signs differ); the kernel
    recomputes every non-finite output in plain float32, so it gives what
    the plain version gives, NaNs in the same places; the other outputs
    stay within the tolerance."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(9)
    a = _card(rng.normal(size=(200, 64)), torch.float32)
    b = _card(rng.normal(size=(64, 136)), torch.float32)
    a[3, 5], a[7, 0], b[9, 100] = float("inf"), float("nan"), float("-inf")
    before = gemm_os.launches_by_route["tf32x3"]
    got = gemm_os(a, b, torch.ones(136, device="cuda"), activation="silu")
    torch.cuda.synchronize()
    assert gemm_os.launches_by_route["tf32x3"] == before + 1
    want = gemm_ref(a, b, torch.ones(136, device="cuda"), "silu")
    assert not torch.isfinite(want).all()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4,
                               equal_nan=True)


@pytest.mark.gpu
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N,tiles", [(2048, 1024, 2048, 6),
                                         (2000, 1000, 1900, 5),
                                         (1200, 512, 1412, 7),
                                         (8, 4096, 8192, 16)])
def test_gemm_os_tf32x3_panels_match_one_call(M, K, N, tiles, out_dtype,
                                              monkeypatch):
    """The tf32x3 route forced into panels by a small scratch cap (panel
    pairs of ``tiles`` tiles; ragged M, N and K, both tiles, bias and
    silu): held to the plain version at the Table-I tolerance and equal
    bit for bit to the same call with the default cap (one panel, the
    same tile), also on the 1-D grid.  The small cap reaches the wrapper
    through its panel plan alone, so the route and tile stay the rule's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.gemm_os import kernel as gk
    from repro_torch.kernels.gemm_os.kernel import (gemm_os_cuda,
                                                    tf32x3_panels)
    rng = np.random.default_rng(M + N)
    a = _card(rng.normal(size=(M, K)), torch.float32)
    b = _card(rng.normal(size=(K, N)) / np.sqrt(K), torch.float32)
    bias = _card(rng.normal(size=(N,)), torch.float32)
    r = gemm_route(M, K, N, torch.float32)
    cap = 8 * K * tiles * r.block_m
    assert r.kind == "tf32x3" and len(tf32x3_panels(
        M, K, N, r.block_m, r.block_n, cap)) > 1
    assert len(tf32x3_panels(M, K, N, r.block_m, r.block_n)) == 1
    kw = dict(activation="silu", out_dtype=out_dtype)
    whole, ran = gemm_os_cuda(a, b, bias, **kw)
    monkeypatch.setattr(gk, "tf32x3_panels", lambda M, K, N, bm, bn:
                        tf32x3_panels(M, K, N, bm, bn, cap))
    paneled, ran_p = gemm_os_cuda(a, b, bias, **kw)
    flat, _ = gemm_os_cuda(a, b, bias, coalesce_grid=True, **kw)
    torch.cuda.synchronize()
    assert ran == ran_p == r
    assert torch.equal(paneled, whole) and torch.equal(flat, whole)
    rtol, atol = TABLE1_TOL[out_dtype]
    torch.testing.assert_close(
        paneled.float(),
        gemm_ref(a, b, bias, "silu", out_dtype=out_dtype).float(),
        rtol=rtol, atol=atol)


@pytest.mark.gpu
def test_gemm_os_simt_entry_float32():
    """The SIMT kernel, which aligned float32 no longer reaches through the
    rule, called on its C entry with an aligned float32 product: still
    within the Table-I tolerance of the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.gemm_os.kernel import _entries
    rng = np.random.default_rng(4)
    M, K, N = 300, 512, 200
    a = _card(rng.normal(size=(M, K)), torch.float32)
    b = _card(rng.normal(size=(K, N)) / np.sqrt(K), torch.float32)
    assert gemm_route(M, K, N, torch.float32).kind == "tf32x3"
    out = torch.empty((M, N), device="cuda")
    err = _entries()[0](a.data_ptr(), b.data_ptr(), None, out.data_ptr(), M,
                        N, K, 0, 0, 0, 0,
                        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    rtol, atol = TABLE1_TOL[torch.float32]
    torch.testing.assert_close(out, gemm_ref(a, b), rtol=rtol, atol=atol)


def _library_conv(x, w):
    """F.conv2d (cuDNN) on NHWC x and (KH, KW, Cin, Cout) w, NHWC out."""
    import torch.nn.functional as F
    return F.conv2d(x.permute(0, 3, 1, 2),
                    w.permute(3, 2, 0, 1)).permute(0, 2, 3, 1)


@pytest.mark.gpu
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,H,W,Cin,Cout,KH,KW", [
    (32, 66, 66, 64, 64, 3, 3),   # the batched Table-I CONV
    (2, 21, 35, 4, 12, 1, 1),     # Cin 4, one tap
    (2, 30, 19, 12, 36, 5, 5),    # Cin 12, ragged tiles and Cout
    (1, 40, 40, 64, 68, 7, 7),    # a second, ragged Cout tile
    (3, 17, 50, 20, 8, 3, 7),     # non-square taps, Cin over a chunk
    (1, 30, 40, 8, 16, 10, 10),   # the largest taps that fit
])
def test_conv2d_os_tf32x3_matches_plain(N, H, W, Cin, Cout, KH, KW,
                                        out_dtype, no_tf32):
    """The float32 tensor-core route at taps 1, 3, 5, 7 and 10 and Cin 4
    to 64: within the Table-I tolerance of the plain version in its
    output dtype, within the library's error of float64 (float32 out),
    two calls bit-equal.  Below MIN_TF32_CIN the rule gives SIMT, so
    those cases ask the wrapper for tf32x3 by name."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(H * Cin + Cout + KW)
    x = _card(rng.normal(size=(N, H, W, Cin)), torch.float32)
    w = _card(rng.normal(size=(KH, KW, Cin, Cout)) / np.sqrt(KH * KW * Cin),
              torch.float32)
    rule = conv_route(Cin, Cout, KH, KW, torch.float32).kind
    assert rule == ("tf32x3" if Cin >= MIN_TF32_CIN else "simt")
    if rule == "tf32x3":
        before = conv2d_os.launches_by_route["tf32x3"]
        got = conv2d_os(x, w, out_dtype=out_dtype)
        again = conv2d_os(x, w, out_dtype=out_dtype)
        torch.cuda.synchronize()
        assert conv2d_os.launches_by_route["tf32x3"] == before + 2
    else:
        (got, r), (again, _) = (conv2d_os_cuda(x, w, out_dtype=out_dtype,
                                               kind="tf32x3")
                                for _ in range(2))
        torch.cuda.synchronize()
        assert r.kind == "tf32x3"
    assert got.dtype == out_dtype and \
        got.shape == (N, H - KH + 1, W - KW + 1, Cout)
    assert torch.equal(got, again)
    rtol, atol = TABLE1_TOL[out_dtype]
    torch.testing.assert_close(got.float(),
                               conv2d_ref(x, w, out_dtype).float(),
                               rtol=rtol, atol=atol)
    if out_dtype == torch.float32:
        _within_library_error(got, _library_conv(x, w),
                              _library_conv(x.double(), w.double()))


@pytest.mark.gpu
def test_conv2d_os_tf32x3_non_finite_inputs():
    """An infinity and a NaN in x and a weight of 1e38 (overflowing some
    products): the kernel recomputes every non-finite output in plain
    float32, so it gives what the plain version gives."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(10)
    x = _card(rng.normal(size=(2, 20, 20, 8)), torch.float32)
    w = _card(rng.normal(size=(3, 3, 8, 12)), torch.float32)
    x[0, 4, 4, 1], x[1, 10, 3, 0], w[1, 1, 2, 5] = (float("inf"),
                                                      float("nan"), 1e38)
    got, r = conv2d_os_cuda(x, w, kind="tf32x3")   # Cin 8: SIMT by rule
    torch.cuda.synchronize()
    assert r.kind == "tf32x3"
    want = conv2d_ref(x, w)
    assert not torch.isfinite(want).all()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4,
                               equal_nan=True)


@pytest.mark.gpu
def test_conv2d_os_simt_entry_float32():
    """The SIMT kernel on its C entry with an aligned float32 convolution
    that the rule now sends to tf32x3: still within the Table-I tolerance
    of the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.conv2d_os.kernel import _entries
    rng = np.random.default_rng(6)
    N, H, W, Cin, Cout, K = 3, 30, 30, 64, 64, 3
    x = _card(rng.normal(size=(N, H, W, Cin)), torch.float32)
    w = _card(rng.normal(size=(K, K, Cin, Cout)) / np.sqrt(K * K * Cin),
              torch.float32)
    assert conv_route(Cin, Cout, K, K, torch.float32).kind == "tf32x3"
    out = torch.empty((N, H - K + 1, W - K + 1, Cout), device="cuda")
    err = _entries()["simt"](x.data_ptr(), w.data_ptr(), out.data_ptr(), N,
                             H, W, Cin, Cout, K, K, 0, 0,
                             torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    rtol, atol = TABLE1_TOL[torch.float32]
    torch.testing.assert_close(out, conv2d_ref(x, w), rtol=rtol, atol=atol)


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


# ---- shapes the fast kernels are not built for (any head_dim, any K, any
# batch and taps): each on its route, held against its plain version.

@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [80, 96, 256, 300])
@pytest.mark.parametrize("G", [1, 4])
def test_decode_attn_any_head_dim_matches_plain(G, D, dtype):
    """Head_dims outside the vector kernels' set run on the SIMT route's
    any-D kernel (D 300: two passes of 256 columns), with a row of length
    0 and S 600; tolerances as in test_decode_attn_kernel_matches_plain."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(D + G)
    B, Hkv, S = 4, 2, 600
    q = rng.normal(size=(B, Hkv * G, D))
    k = rng.normal(size=(B, Hkv, S, D))
    v = rng.normal(size=(B, Hkv, S, D))
    lens = np.array([0, 1, 333, S], np.int32)
    args = [torch.from_numpy(a).to("cuda", dtype) for a in (q, k, v)]
    args.append(torch.from_numpy(lens).cuda())
    assert attn_route(D, G, dtype) == "simt"
    before = decode_attn.launches_by_route["simt"]
    got = decode_attn(*args)
    torch.cuda.synchronize()
    assert decode_attn.launches_by_route["simt"] == before + 1
    tol = 2e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), decode_attn_ref(*args).float(),
                               rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [80, 256, 400])
@pytest.mark.parametrize("T", [16, 256])
def test_wkv6_any_head_size_matches_plain(T, D, dtype):
    """Head sizes outside the fast kernels' set on both routes (T 16 on
    step, T 256 on chunked), from a nonzero state0 and from zeros; D 400
    keeps its state columns in the output instead of shared memory."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r, k, v, w, u, s0 = _wkv6_inputs(2, T, 2, D, dtype, seed=D + T)
    kind = wkv6_route(2, T, 2, D)
    assert kind == ("chunked" if T >= CHUNK_T else "step")
    before = wkv6.launches_by_route[kind]
    got = wkv6(r, k, v, w, u, s0)
    got0 = wkv6(r, k, v, w, u)
    torch.cuda.synchronize()
    assert wkv6.launches_by_route[kind] == before + 2
    _wkv6_close(got, wkv6_ref(r, k, v, w, u, s0), dtype)
    _wkv6_close(got0, wkv6_ref(r, k, v, w, u), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("T", [16, 128])
@pytest.mark.parametrize("D", [64, 80])
def test_wkv6_gradients_match_autograd_through_plain(D, T):
    """The autograd Function around the kernels: its gradients of r, k,
    v, w, u and state0 (the backward kernel's) against autograd through
    ``wkv6_ref``, float32, 1e-4; ``test_rwkv6_train_gradients_kernel_
    match_plain`` holds the gradients the kernels lead to in a model."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ins = [t.requires_grad_() for t in
           _wkv6_inputs(2, T, 2, D, torch.float32, seed=T + D)]
    rng = np.random.default_rng(1)
    g_out = torch.from_numpy(rng.normal(size=(2, T, 2, D))).float().cuda()
    g_state = torch.from_numpy(rng.normal(size=(2, 2, D, D))).float().cuda()

    def grads(fn):
        out, state = fn(*ins)
        return torch.autograd.grad([out, state], ins, [g_out, g_state])

    before = wkv6.launches
    got = grads(wkv6)
    torch.cuda.synchronize()
    assert wkv6.launches == before + 1
    for g, want in zip(got, grads(wkv6_ref)):
        torch.testing.assert_close(g, want, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("d_model,n_heads", [(64, 4), (160, 2)],
                         ids=["D16", "D80"])
def test_rwkv6_train_gradients_kernel_match_plain(d_model, n_heads):
    """One rwkv6 loss.backward at reduced() depth in float32 (TF32 off),
    B 2 x T 128 (the chunked route), with ``wkv6`` on the kernel against
    the same with ``wkv6_ref`` in its place: loss within 1e-4 relative and
    every parameter's gradient within 1e-4 of its tensor's largest |g|.
    Head size 16 runs the instantiated kernels, 80 the any-D kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import dataclasses
    from unittest import mock

    import repro_torch.models.rwkv6 as rwkv6_mod
    from repro_torch.configs.registry import get_config
    from repro_torch.models.zoo import build_model
    from repro_torch.train.step import make_loss_fn

    cfg = dataclasses.replace(get_config("rwkv6-1.6b").reduced(),
                              d_model=d_model, n_heads=n_heads)
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    params.requires_grad_(True)
    rng = np.random.default_rng(5)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (2, 128))).cuda()
             for k in ("inputs", "labels")}
    loss_fn = make_loss_fn(model)

    def step():
        for p in params.parameters():
            p.grad = None
        loss, _ = loss_fn(params, batch)
        loss.backward()
        return loss.item(), {n: p.grad.clone()
                             for n, p in params.named_parameters()
                             if p.grad is not None}

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        before = dict(wkv6.launches_by_route)
        k_loss, k_grads = step()
        assert wkv6.launches_by_route["chunked"] - before["chunked"] == \
            cfg.n_layers
        with mock.patch.object(rwkv6_mod, "wkv6", wkv6_ref):
            p_loss, p_grads = step()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert abs(k_loss - p_loss) <= 1e-4 * abs(p_loss)
    assert k_grads.keys() == p_grads.keys()
    assert "layers.0.u" in p_grads
    for name, want in p_grads.items():
        err = (k_grads[name] - want).abs().max().item()
        assert err <= 1e-4 * want.abs().max().item(), name


@pytest.mark.gpu
@pytest.mark.parametrize("fill", [-128, None], ids=["all_min", "random"])
def test_qgemm_int8_past_k_limit_bit_exact(fill):
    """K 140000, past K_MAX, on the SIMT route's wrapping instantiation:
    all -128 gives K * 16384 wrapped to int32 (-2001207296) times the
    scales, and random inputs equal the plain version bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    M, K, N = 8, 140000, 16
    if fill is None:
        gen = torch.Generator(device="cuda").manual_seed(3)
        a = torch.randint(-128, 128, (M, K), generator=gen, device="cuda",
                          dtype=torch.int8)
        b = torch.randint(-128, 128, (K, N), generator=gen, device="cuda",
                          dtype=torch.int8)
    else:
        a = torch.full((M, K), fill, dtype=torch.int8, device="cuda")
        b = torch.full((K, N), fill, dtype=torch.int8, device="cuda")
    sa = torch.linspace(0.5, 2, M, device="cuda")
    sb = torch.linspace(0.25, 1, N, device="cuda")
    assert qgemm_route(M, K, N) == "simt"
    before = qgemm_int8.launches_by_route["simt"]
    got = qgemm_int8(a, b, sa, sb)
    torch.cuda.synchronize()
    assert qgemm_int8.launches_by_route["simt"] == before + 1
    assert torch.equal(got, qgemm_ref(a, b, sa, sb))
    if fill is not None:
        want = (torch.full((M, N), -2001207296.0, device="cuda")
                * sa[:, None]) * sb[None, :]
        assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,H,W,Cin,Cout,KH,KW,want", [
    (65536, 4, 4, 8, 16, 3, 3, None),     # a batch past grid.z
    (2, 30, 28, 13, 70, 12, 11, "stream"),  # taps past shared memory
    (1, 20, 100, 3, 8, 1, 90, "stream"),
])
def test_conv2d_os_any_batch_and_taps_matches_plain(N, H, W, Cin, Cout, KH,
                                                   KW, want, dtype):
    """A batch of 65536 images (two launches in one C call) and taps whose
    SIMT block would not fit in shared memory (the streaming route), each
    on the route the rule gives, held to the plain version within the
    Table-I tolerance of its dtype."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(N + KH * KW)
    x = _card(rng.normal(size=(N, H, W, Cin)), dtype)
    w = _card(rng.normal(size=(KH, KW, Cin, Cout)) / np.sqrt(KH * KW * Cin),
              dtype)
    kind = conv_route(Cin, Cout, KH, KW, dtype).kind
    assert want is None or kind == want
    before = conv2d_os.launches_by_route[kind]
    got = conv2d_os(x, w)
    torch.cuda.synchronize()
    assert conv2d_os.launches_by_route[kind] == before + 1
    assert got.shape == (N, H - KH + 1, W - KW + 1, Cout)
    rtol, atol = TABLE1_TOL[dtype]
    torch.testing.assert_close(got.float(), conv2d_ref(x, w).float(),
                               rtol=rtol, atol=atol)


def _launch_counts() -> dict:
    """(op, route) -> launches the wrappers of decode_attn and wkv6 have
    counted; route None is the op's total."""
    out = {}
    for op in (decode_attn, wkv6):
        out[op.__name__, None] = op.launches
        for route, n in op.launches_by_route.items():
            out[op.__name__, route] = n
    return out


def _decode_kernels(fn):
    """Runs ``fn`` under torch.profiler; returns what it returned and the
    times each device kernel of wkv6's decode route and of decode_attn
    ran, by name."""
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    ran = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            m = re.search(r"\b(wkv6_decode_kernel|decode_\w*kernel)\b",
                          e.name())
            if m:
                ran[m.group(1)] = ran.get(m.group(1), 0) + 1
    return out, ran


@pytest.mark.gpu
@pytest.mark.parametrize("arch_id,dtype", [
    ("rwkv6-1.6b", torch.float32), ("zamba2-1.2b", torch.bfloat16),
    ("llama3.2-1b", torch.bfloat16),
    ("llama4-maverick-400b-a17b", torch.bfloat16),
    ("deepseek-v3-671b", torch.bfloat16)])
def test_engine_graph_replay_matches_eager_decode(arch_id, dtype):
    """A card's engine records its decode step as a CUDA graph after
    EAGER_STEPS eager steps and replays it, through admissions and
    recycled slots: each step's logits, tokens and caches bit-equal to
    ``Model.decode`` called directly on copies of the step's caches and
    inputs.  The wrappers count the launches of the eager steps and the
    recording as the direct call's, and none of a replay's; the
    profiler's trace of the recorded step and of a later replay holds the
    direct call's decode kernels, by name and count.  With spans on, a
    replayed step is ``graph=1`` over ``model.decode`` and records no
    block spans."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import dataclasses

    from repro_torch import spans
    from repro_torch.configs.registry import serve_smoke_config
    from repro_torch.models.zoo import build_model, cache_tensors
    from repro_torch.serve.engine import EAGER_STEPS, Engine, Request

    cfg = dataclasses.replace(serve_smoke_config(arch_id), dtype=dtype)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=model.device).manual_seed(0))
    eng = Engine(model, params, batch=3, max_len=64)
    rng = np.random.default_rng(3)
    pending = [Request(rid=i, prompt=rng.integers(
        0, cfg.vocab, size=int(rng.integers(3, 24))),
        max_new=int(rng.integers(6, 16))) for i in range(14)]
    traced = (EAGER_STEPS, EAGER_STEPS + 4)    # the recording, a replay
    spanned = EAGER_STEPS + 3

    def moved(before):
        after = _launch_counts()
        return {k: after[k] - n for k, n in before.items() if after[k] != n}

    def run(fn, steps):
        if steps in traced:
            return _decode_kernels(fn)
        return fn(), None

    steps, recycled = 0, 0
    step_spans = {}
    while pending or eng.n_active:
        while pending and eng.has_free_slot():
            recycled += steps > 0
            assert eng.admit(pending.pop(0))
        copies = copy.deepcopy(eng.caches)
        inputs = [torch.from_numpy(a).to(model.device) for a in (
            eng.last_tok[:, None].astype(np.int64),
            eng.lengths[:, None].astype(np.int64), eng.lengths + 1)]
        active = {i: r.rid for i, r in enumerate(eng.slots) if r is not None}
        before = _launch_counts()
        if steps in (0, spanned):
            spans.enable()
        try:
            out, ran = run(eng.step, steps)
        finally:
            spans.disable()
        step_spans[steps] = spans.take()
        by_step = moved(before)
        before = _launch_counts()
        (logits, copies), ran_direct = run(
            lambda: model.decode(params, copies, *inputs), steps)
        direct = moved(before)
        assert by_step == (direct if steps <= EAGER_STEPS else {}), \
            f"step {steps}"
        assert ran == ran_direct, f"step {steps}"
        if steps in traced:
            assert bool(ran) == bool(direct), f"step {steps}"
        torch.cuda.synchronize()
        assert torch.equal(eng.logits, logits), f"step {steps}"
        toks = logits[:, -1].argmax(-1).cpu()
        assert out == {rid: int(toks[i]) for i, rid in active.items()}
        for got, want in zip(cache_tensors(eng.caches),
                             cache_tensors(copies)):
            assert torch.equal(got, want), f"step {steps}"
        steps += 1
    assert steps >= 40 and recycled >= 8
    assert (eng.eager_steps, eng.graph_replays) == \
        (EAGER_STEPS, steps - EAGER_STEPS)

    eager, replayed = step_spans[0], step_spans[spanned]
    top = [s for s in replayed if s.parent is None]
    assert [(s.name, s.meta["graph"]) for s in top] == [("engine.step", 1)]
    assert [s.name for s in replayed[1:]] == [
        "engine.step.inputs", "model.decode", "engine.step.readback",
        "engine.step.finish"]
    assert all(s.parent == 0 for s in replayed[1:])
    assert eager[0].meta["graph"] == 0
    if cfg.family in ("ssm", "hybrid"):
        assert any(s.name.startswith("block.") for s in eager)
