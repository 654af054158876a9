"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test calls ``needs_cuda()`` and skips without a card: the CUDA
kernels have no interpret mode. The quant kernels run the plain versions'
fp32 arithmetic operation for operation, so they are held to them exactly;
``causal_attention`` sums on the tensor cores, so it is held to float64
beside its plain version (at most one bf16 ulp of the output further off,
bit for bit on 99 % of the elements).
This file imports neither JAX nor ``repro``, so it also runs where only
the port is installed:

    PYTHONPATH=src python -m pytest --noconftest tests/test_torch_cuda.py
"""
import importlib

import numpy as np
import pytest
import torch

from helpers.torch_parity import needs_cuda
from repro_torch import kernels as tk
from repro_torch.kernels import ref as tref


def _tq_args(f, seed):
    """A random (pi, s, phi) for width f, made from a numpy seed."""
    rng = np.random.default_rng(seed)
    pi = rng.permutation(f)
    s = (1.0 + 0.05 * rng.standard_normal(f)).astype(np.float32)
    phi = (1e-2 * rng.standard_normal(f // 2)).astype(np.float32)
    return (torch.from_numpy(pi.astype(np.int64)), torch.from_numpy(s),
            torch.from_numpy(phi))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits,group", [(2, 32), (3, 128), (8, 64), (1, 16),
                                        (2, 16)])
def test_group_quant_cuda_matches_plain(dtype, bits, group):
    dev = needs_cuda()
    w = (torch.randn((512, 384), generator=torch.Generator().manual_seed(1))
         * 2.5).to(dev, dtype)
    before = tk.LAUNCHES["group_quant"]
    fq, s, z = tk.group_quant(w, bits=bits, group=group)
    assert tk.LAUNCHES["group_quant"] == before + 1
    assert fq.dtype == dtype
    for got, want in zip((fq, s, z), tref.group_quant_ref(w, bits, group)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits,group", [(2, 32), (3, 128), (1, 16), (2, 16)])
def test_group_quant_cuda_round_range_matches_plain(dtype, bits, group):
    """``round_range`` (``core.quant.fake_quant``'s qparams in w's dtype)."""
    dev = needs_cuda()
    w = (torch.randn((512, 384), generator=torch.Generator().manual_seed(1))
         * 2.5).to(dev, dtype)
    before = tk.LAUNCHES["group_quant"]
    fq, s, z = tk.group_quant(w, bits=bits, group=group, round_range=True)
    assert tk.LAUNCHES["group_quant"] == before + 1
    for got, want in zip((fq, s, z), tref.group_quant_ref(
            w, bits, group, round_range=True)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


# (K, N, group) for the kernel's other bodies, widths and plans
GQ_EDGE_CUDA = [
    (512, 384, 512), (4096, 64, 4096),         # per-column: held (bf16
    (8192, 16, 8192),                          # read twice), read twice
    (512, 1, 32), (512, 1, 512), (24, 1, 3),   # the 1-D path, N = 1
    (512, 100, 32), (256, 37, 64), (64, 6, 32),   # N not a multiple of 8
    (192, 256, 96), (64, 40, 8), (2048, 2048, 64),  # other groups
    (896, 4864, 32),     # between one and two waves: the halved hold
]


@pytest.mark.parametrize("round_range", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K,N,group", GQ_EDGE_CUDA)
def test_group_quant_cuda_edges_match_plain(K, N, group, dtype, round_range):
    """The kernel plans as ``kernels/group_quant.py::plan`` does and equals
    the plain version at every body (fixed, general, vector), vector width
    and hold."""
    dev = needs_cuda()
    gq = importlib.import_module("repro_torch.kernels.group_quant")
    assert gq.kernel_plan(K, N, group, dtype) == gq.plan(K, N, group, dtype)
    w = (torch.randn((K, N), generator=torch.Generator().manual_seed(K + N))
         * 2.5).to(dev, dtype)
    for bits in (2, 3, 8):
        got = tk.group_quant(w, bits=bits, group=group,
                             round_range=round_range)
        for g, want in zip(got, tref.group_quant_ref(
                w, bits, group, round_range=round_range)):
            torch.testing.assert_close(g, want, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_group_quant_cuda_misaligned_view_matches_plain(dtype):
    """A contiguous view that starts off a 16-byte boundary: the kernel
    narrows its accesses."""
    dev = needs_cuda()
    base = (torch.randn(256 * 512 + 1, generator=torch.Generator()
                        .manual_seed(3)) * 2.5).to(dev, dtype)
    w = base[1:].view(256, 512)
    for got, want in zip(tk.group_quant(w, bits=2, group=32),
                         tref.group_quant_ref(w, 2, 32)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def _pi(kind, f, seed):
    """A gather index of width f: identity, a partial shuffle (an eighth of
    the positions permuted among themselves), a random permutation, or
    random indices with duplicates."""
    rng = np.random.default_rng(seed)
    pi = np.arange(f)
    if kind == "partial":
        idx = rng.choice(f, f // 8, replace=False)
        pi[idx] = rng.permutation(idx)
    elif kind == "random":
        pi = rng.permutation(f)
    elif kind == "dup":
        pi = rng.integers(0, f, f)
    return torch.from_numpy(pi.astype(np.int64))


# (D, F, bits, group, pi kind, gate): the shape the test held first, then
# shapes that cross the kernels' tiles: a ragged F (1408 and 4864 columns:
# "up" slices of 176 and 608, "down" tiles of 128 columns cut at the edge),
# F = 22528 over a few bands (slices of 2816 columns), groups 64 and 128
# ("up" in two passes, at F 8192 in two sub-bands), every pi kind, the gated
# FFN's call (s = 1, phi = 0), D = 90 ("down" in 4-byte units) at group
# 30, 8 bits (codes up to 255), and Table 3's 1-bit and 2-bit group-16
# settings at opt-1.3b's FFN (2048, 8192)
TQ_CUDA_CASES = [
    (96, 256, 2, 32, "random", False), (96, 256, 4, 16, "random", False),
    (1408, 4864, 2, 32, "random", False), (128, 1408, 2, 64, "dup", False),
    (64, 22528, 2, 32, "random", False), (256, 8192, 2, 128, "random", False),
    (256, 8192, 3, 128, "partial", False), (512, 1024, 2, 32, "identity",
                                            False),
    (512, 1024, 2, 32, "partial", False), (512, 1024, 2, 32, "dup", False),
    (256, 2048, 2, 32, "random", True), (90, 120, 2, 30, "random", False),
    (512, 1024, 8, 64, "random", False),
    (2048, 8192, 1, 16, "random", False), (2048, 8192, 2, 16, "identity",
                                           False),
]


@pytest.mark.parametrize("mode", ["up", "down"])
@pytest.mark.parametrize("D,F,bits,group,kind,gate", TQ_CUDA_CASES)
def test_transform_quant_cuda_matches_plain(mode, D, F, bits, group, kind,
                                            gate):
    dev = needs_cuda()
    w = torch.randn((D, F) if mode == "up" else (F, D),
                    generator=torch.Generator().manual_seed(2)).to(dev)
    _, s, phi = _tq_args(F, seed=3)
    if gate:
        s, phi = torch.ones_like(s), torch.zeros_like(phi)
    pi, s, phi = _pi(kind, F, seed=4).to(dev), s.to(dev), phi.to(dev)
    before = tk.LAUNCHES["transform_quant"]
    fq, sc, z = tk.transform_quant(w, pi, s, phi, bits=bits, group=group,
                                   mode=mode)
    assert tk.LAUNCHES["transform_quant"] == before + 1
    for got, want in zip((fq, sc, z), tref.transform_quant_ref(
            w, pi, s, phi, bits=bits, group=group, mode=mode)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


# bf16 w: the f32 cases' shapes that cross the tiles ("down" in 16-byte
# copies of 8 values, or one value at a time at D 90), and Qwen3-4B's FFN
TQ_BF16_CASES = [c for c in TQ_CUDA_CASES if c[:2] in (
    (96, 256), (1408, 4864), (256, 8192), (90, 120))] + [
    (2560, 9728, 2, 32, "random", False), (2560, 9728, 2, 32, "random", True),
    (2560, 9728, 1, 16, "random", False), (2560, 9728, 2, 16, "identity",
                                           False)]


@pytest.mark.parametrize("mode", ["up", "down"])
@pytest.mark.parametrize("D,F,bits,group,kind,gate", TQ_BF16_CASES)
def test_transform_quant_cuda_bf16_matches_plain(mode, D, F, bits, group,
                                                 kind, gate):
    dev = needs_cuda()
    w = torch.randn((D, F) if mode == "up" else (F, D),
                    generator=torch.Generator().manual_seed(2)).to(
                        dev, torch.bfloat16)
    _, s, phi = _tq_args(F, seed=3)
    if gate:
        s, phi = torch.ones_like(s), torch.zeros_like(phi)
    pi, s, phi = _pi(kind, F, seed=4).to(dev), s.to(dev), phi.to(dev)
    before = tk.LAUNCHES["transform_quant"]
    fq, sc, z = tk.transform_quant(w, pi, s, phi, bits=bits, group=group,
                                   mode=mode)
    assert tk.LAUNCHES["transform_quant"] == before + 1
    assert fq.dtype == torch.bfloat16 and sc.dtype == torch.float32
    for got, want in zip((fq, sc, z), tref.transform_quant_ref(
            w, pi, s, phi, bits=bits, group=group, mode=mode)):
        assert torch.equal(got, want)


def test_cuda_wrappers_raise_on_bad_inputs():
    dev = needs_cuda()
    w = torch.randn((64, 32), device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        tk.group_quant(w.t(), bits=2, group=32)
    with pytest.raises(ValueError, match="dtype"):
        tk.group_quant(w.half(), bits=2, group=32)
    with pytest.raises(ValueError, match="multiple"):
        tk.group_quant(w, bits=2, group=24)
    pi = torch.arange(32, device=dev)
    s, phi = torch.ones(32, device=dev), torch.zeros(16, device=dev)
    with pytest.raises(ValueError, match="index"):
        tk.transform_quant(w, pi + 1, s, phi, bits=2, group=32, mode="up")
    with pytest.raises(ValueError, match="dtype"):
        tk.transform_quant(w, pi.int(), s, phi, bits=2, group=32, mode="up")
    with pytest.raises(ValueError, match="is on"):
        tk.transform_quant(w, pi.cpu(), s, phi, bits=2, group=32, mode="up")
    shifted = torch.randn(64 * 32 + 1, device=dev)[1:].view(64, 32)
    with pytest.raises(ValueError, match="16-byte"):
        tk.transform_quant(shifted, torch.arange(64, device=dev),
                           torch.ones(64, device=dev),
                           torch.zeros(32, device=dev), bits=2, group=32,
                           mode="down")


def _paged_case(dev, *, B, H, Hkv, Dh, psz, P, lens, dtype, seed):
    """Random pools (f32, bf16 or int8 + scales) and distinct block tables
    on the card; lens (B,) may hold 0 and P * psz."""
    g = torch.Generator().manual_seed(seed)
    n_pages = B * P + 1
    q = torch.randn((B, H, Dh), generator=g)
    kp = torch.randn((n_pages, psz, Hkv, Dh), generator=g)
    vp = torch.randn((n_pages, psz, Hkv, Dh), generator=g)
    ks = vs = None
    if dtype == torch.int8:
        ks = kp.abs().amax(-1) / 127.0 + 1e-8
        vs = vp.abs().amax(-1) / 127.0 + 1e-8
        kp = torch.round(kp / ks[..., None]).to(torch.int8)
        vp = torch.round(vp / vs[..., None]).to(torch.int8)
        ks, vs = ks.to(dev), vs.to(dev)
    else:
        kp, vp = kp.to(dtype), vp.to(dtype)
    bt = (torch.randperm(n_pages - 1, generator=g)[: B * P] + 1).reshape(B, P)
    return (q.to(dev), kp.to(dev), vp.to(dev), bt.int().to(dev),
            torch.tensor(lens, dtype=torch.int32, device=dev), ks, vs)


PAGED_ROUTES = [  # (H, Hkv, fused_gqa, pages_per_block) -> route
    ((4, 4, True, 1), "paged_decode"),
    ((8, 2, False, 1), "paged_decode"),
    ((8, 2, True, 1), "paged_decode_gqa"),
    ((8, 2, True, 2), "paged_decode_gqa_mp"),
    ((8, 2, True, 4), "paged_decode_gqa_mp"),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("layout,route", PAGED_ROUTES,
                         ids=[f"{r}-{'x'.join(map(str, lay))}"
                              for lay, r in PAGED_ROUTES])
def test_paged_decode_cuda_matches_plain(dtype, layout, route):
    """Each route against the plain version on the same card tensors, at
    the reference's 1e-5 (the kernel sums in another order), outputs and
    (acc, m, l) partials; ragged lengths 0, 1, page-aligned and P·psz."""
    dev = needs_cuda()
    H, Hkv, fused, mp = layout
    psz, P = 8, 5
    args = _paged_case(dev, B=5, H=H, Hkv=Hkv, Dh=32, psz=psz, P=P,
                       lens=[0, 1, psz, 2 * psz + 3, P * psz], dtype=dtype,
                       seed=11)
    kw = dict(fused_gqa=fused, gqa_pages_per_block=mp)
    before = tk.LAUNCHES[route]
    out = tk.paged_decode(*args, **kw)
    assert tk.LAUNCHES[route] == before + 1
    torch.testing.assert_close(out, tref.paged_decode_ref(*args),
                               rtol=1e-5, atol=1e-5)
    assert not out[0].any(), "an empty sequence gives exactly 0"
    for got, want in zip(tk.paged_decode(*args, normalize=False, **kw),
                         tref.paged_decode_ref(*args, normalize=False)):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("layout,route", PAGED_ROUTES[1:4],
                         ids=[r for _, r in PAGED_ROUTES[1:4]])
def test_paged_decode_cuda_never_reads_dead_slots(layout, route):
    """NaN in every slot past each length (dead pages, the last live
    page's tail, the null page) never reaches the output."""
    dev = needs_cuda()
    H, Hkv, fused, mp = layout
    psz, P = 4, 8
    q, kp, vp, bt, lens, _, _ = _paged_case(
        dev, B=3, H=H, Hkv=Hkv, Dh=16, psz=psz, P=P, lens=[3, 2 * psz, 0],
        dtype=torch.float32, seed=13)
    want = tref.paged_decode_ref(q, kp, vp, bt, lens)
    pos = torch.arange(P * psz, device=dev).reshape(P, psz)
    for b in range(3):
        dead = pos >= lens[b]                     # (P, psz) per table slot
        for p in range(P):
            kp[bt[b, p], dead[p]] = float("nan")
            vp[bt[b, p], dead[p]] = float("nan")
    kp[0] = vp[0] = float("nan")
    got = tk.paged_decode(q, kp, vp, bt, lens, fused_gqa=fused,
                          gqa_pages_per_block=mp)
    assert not torch.isnan(got).any()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


SPLIT_ROUTES = [("paged_decode_gqa", 1), ("paged_decode_gqa_mp", 2),
                ("paged_decode_gqa_mp", 4), ("paged_decode", 1)]


def _split_case(dev, lens, dtype, seed):
    """A layout the planner splits on every route: B 2, 8/2 heads, Dh 128,
    page size 16, 64 pages per table (the per-query-head route serves it
    with ``fused_gqa=False``)."""
    return _paged_case(dev, B=2, H=8, Hkv=2, Dh=128, psz=16, P=64, lens=lens,
                       dtype=dtype, seed=seed)


def _split_kw(route, mp):
    return dict(gqa_pages_per_block=mp, fused_gqa=route != "paged_decode")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("route,mp", SPLIT_ROUTES,
                         ids=[f"{r}-mp{mp}" for r, mp in SPLIT_ROUTES])
@pytest.mark.parametrize("lens", [[1024, 333], [0, 1000]],
                         ids=["ragged", "empty"])
def test_paged_decode_gqa_split_cuda_matches_plain(dtype, route, mp, lens):
    """Every route where the planner splits the pages across CTAs (the
    split pass, then the merge of the runs' partials): outputs and
    (acc, m, l) partials within 1e-5 of the plain version; runs past the
    333-token sequence's end are empty; a zero-length sequence gives
    exactly 0."""
    dev = needs_cuda()
    pd = importlib.import_module("repro_torch.kernels.paged_decode")
    heads = 8 if route == "paged_decode" else 2
    assert pd.plan(route, 2, heads, 64, 16, mp, pd.sm_count(dev)).n_split > 1
    args = _split_case(dev, lens, dtype, seed=21)
    kw = _split_kw(route, mp)
    before = tk.LAUNCHES[route]
    out = tk.paged_decode(*args, **kw)
    assert tk.LAUNCHES[route] == before + 1
    torch.testing.assert_close(out, tref.paged_decode_ref(*args),
                               rtol=1e-5, atol=1e-5)
    if 0 in lens:
        assert not out[lens.index(0)].any(), "an empty sequence gives 0"
    for got, want in zip(tk.paged_decode(*args, normalize=False, **kw),
                         tref.paged_decode_ref(*args, normalize=False)):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("route,mp", SPLIT_ROUTES,
                         ids=[f"{r}-mp{mp}" for r, mp in SPLIT_ROUTES])
def test_paged_decode_gqa_split_never_reads_dead_slots(route, mp):
    """Split runs with NaN in every slot past each length (the last live
    page's tail, every dead page, the null page): never read."""
    dev = needs_cuda()
    lens = [1000, 333]
    q, kp, vp, bt, ln, _, _ = _split_case(dev, lens, torch.float32, seed=23)
    want = tref.paged_decode_ref(q, kp, vp, bt, ln)
    pos = torch.arange(64 * 16, device=dev).reshape(64, 16)
    for b in range(2):
        dead = pos >= lens[b]
        for p in range(64):
            kp[bt[b, p], dead[p]] = float("nan")
            vp[bt[b, p], dead[p]] = float("nan")
    kp[0] = vp[0] = float("nan")
    got = tk.paged_decode(q, kp, vp, bt, ln, **_split_kw(route, mp))
    assert not torch.isnan(got).any()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_paged_decode_head_long_context_split_cuda_matches_plain(dtype):
    """The per-query-head route on an MHA layout (opt-1.3b's head dim 64)
    at one long sequence and a ragged one: the planner splits B · H = 8
    pairs into runs, and the merged output and partials hold to the plain
    version at 1e-5."""
    dev = needs_cuda()
    pd = importlib.import_module("repro_torch.kernels.paged_decode")
    assert pd.plan("paged_decode", 2, 4, 128, 16, 1,
                   pd.sm_count(dev)).n_split > 1
    args = _paged_case(dev, B=2, H=4, Hkv=4, Dh=64, psz=16, P=128,
                       lens=[2048, 777], dtype=dtype, seed=25)
    before = tk.LAUNCHES["paged_decode"]
    out = tk.paged_decode(*args)
    assert tk.LAUNCHES["paged_decode"] == before + 1
    torch.testing.assert_close(out, tref.paged_decode_ref(*args),
                               rtol=1e-5, atol=1e-5)
    for got, want in zip(tk.paged_decode(*args, normalize=False),
                         tref.paged_decode_ref(*args, normalize=False)):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_paged_decode_wrapper_raises_on_bad_inputs():
    dev = needs_cuda()
    q, kp, vp, bt, lens, _, _ = _paged_case(
        dev, B=2, H=4, Hkv=2, Dh=16, psz=4, P=3, lens=[3, 5],
        dtype=torch.float32, seed=1)
    with pytest.raises(ValueError, match="seq_lens"):
        tk.paged_decode(q, kp, vp, bt, lens.long())
    with pytest.raises(ValueError, match="contiguous"):
        tk.paged_decode(q, kp, vp, bt.t().contiguous().t(), lens)
    # the split-KV body stages fixed row tiles: MP no longer sizes shared
    # memory, so a block of 4096 pages is taken; a head dim past 1024 is not
    torch.testing.assert_close(
        tk.paged_decode(q, kp, vp, bt, lens, gqa_pages_per_block=4096),
        tref.paged_decode_ref(q, kp, vp, bt, lens), rtol=1e-5, atol=1e-5)
    wide = _paged_case(dev, B=2, H=4, Hkv=2, Dh=1028, psz=4, P=3, lens=[3, 5],
                       dtype=torch.float32, seed=1)
    with pytest.raises(ValueError, match="head dims up to 1024"):
        tk.paged_decode(*wide)
    shifted = torch.empty(kp.numel() + 1, device=dev)[1:].view(kp.shape)
    with pytest.raises(ValueError, match="boundary"):
        tk.paged_decode(q, shifted, shifted, bt, lens)


def test_sampling_draws_its_noise_on_the_card():
    """Sampled tokens on the card: the Gumbel noise comes from a generator
    on the logits' device, is fixed by (seed, token index) alone and keeps
    to the top-k set."""
    dev = needs_cuda()
    from repro_torch.serving import decode as tdec
    logits = torch.randn((4, 64), generator=torch.Generator().manual_seed(2))
    logits = logits.to(dev)

    def draw(seeds, index=3):
        keys = [tdec.request_key(s, index, dev) for s in seeds]
        return tdec.sample_logits_per_seq(logits, keys, [2.0] * 4, [5] * 4)

    toks = draw(range(4))
    assert toks.device.type == "cuda"
    assert torch.equal(toks, draw(range(4)))
    kth = torch.topk(logits, 5).values[:, -1:]
    assert bool((logits.gather(1, toks[:, None]) >= kth).all())
    streams = torch.stack([draw(range(4), index=i) for i in range(16)])
    assert len(torch.unique(streams)) > 1     # the index moves the stream


def _flash_case(dev, *, B, S, H, Hkv, Dh, dtype, seed):
    """Random contiguous caches (f32, bf16 or int8 + scales) on the card."""
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((B, H, Dh), generator=g)
    k = torch.randn((B, S, Hkv, Dh), generator=g)
    v = torch.randn((B, S, Hkv, Dh), generator=g)
    ks = vs = None
    if dtype == torch.int8:
        ks = k.abs().amax(-1) / 127.0 + 1e-8
        vs = v.abs().amax(-1) / 127.0 + 1e-8
        k = torch.round(k / ks[..., None]).to(torch.int8)
        v = torch.round(v / vs[..., None]).to(torch.int8)
        ks, vs = ks.to(dev), vs.to(dev)
    else:
        k, v = k.to(dtype), v.to(dtype)
    return q.to(dev), k.to(dev), v.to(dev), ks, vs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("H,Hkv", [(4, 4), (8, 2)], ids=["mha", "gqa"])
def test_flash_decode_cuda_matches_plain(dtype, H, Hkv):
    """The kernel against the plain version on the same card tensors at
    the reference's 2e-4, kv_len 0 (exactly 0), 1, a tile boundary, ragged
    and S; S = 150 is no multiple of the kernel's 32-row tile."""
    dev = needs_cuda()
    S = 150
    args = _flash_case(dev, B=3, S=S, H=H, Hkv=Hkv, Dh=32, dtype=dtype,
                       seed=21)
    for kv_len in (0, 1, 64, 97, S):
        before = tk.LAUNCHES["flash_decode"]
        out = tk.flash_decode(*args, kv_len=kv_len)
        assert tk.LAUNCHES["flash_decode"] == before + 1
        torch.testing.assert_close(out, tref.flash_decode_ref(
            *args, kv_len=kv_len), rtol=2e-4, atol=2e-4)
        if kv_len == 0:
            assert not out.any(), "an empty cache gives exactly 0"


@pytest.mark.parametrize("H,Hkv", [(4, 4), (8, 2)], ids=["mha", "gqa"])
def test_flash_decode_cuda_never_reads_past_kv_len(H, Hkv):
    dev = needs_cuda()
    q, k, v, _, _ = _flash_case(dev, B=2, S=96, H=H, Hkv=Hkv, Dh=16,
                                dtype=torch.float32, seed=23)
    want = tref.flash_decode_ref(q, k, v, kv_len=70)
    k[:, 70:] = float("nan")
    v[:, 70:] = float("nan")
    got = tk.flash_decode(q, k, v, kv_len=70)
    assert not torch.isnan(got).any()
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


def _flash_split_plan(dev, H, Hkv, S):
    """The planner's split of one S-row sequence on this card; it must cut
    the rows into two or more runs."""
    tfd = importlib.import_module("repro_torch.kernels.flash_decode")
    sp = tfd.plan(1, H, Hkv, S, tfd.sm_count(dev))
    assert sp.n_split >= 2, sp
    return sp


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("H,Hkv", [(4, 4), (8, 2)], ids=["mha", "gqa"])
def test_flash_decode_split_cuda_matches_plain(dtype, H, Hkv):
    """One 1000-row sequence, which the planner cuts into runs across CTAs
    (split pass, then the merge of the partials): against the plain
    version at 2e-4 at kv_len 0 (exactly 0), 1, a run boundary and one row
    past it, ragged and S."""
    dev = needs_cuda()
    S = 1000
    run = _flash_split_plan(dev, H, Hkv, S).run_pages
    args = _flash_case(dev, B=1, S=S, H=H, Hkv=Hkv, Dh=32, dtype=dtype,
                       seed=25)
    for kv_len in (0, 1, run, run + 1, 517, S):
        before = tk.LAUNCHES["flash_decode"]
        out = tk.flash_decode(*args, kv_len=kv_len)
        assert tk.LAUNCHES["flash_decode"] == before + 1
        torch.testing.assert_close(out, tref.flash_decode_ref(
            *args, kv_len=kv_len), rtol=2e-4, atol=2e-4)
        if kv_len == 0:
            assert not out.any(), "an empty cache gives exactly 0"


@pytest.mark.parametrize("H,Hkv", [(4, 4), (8, 2)], ids=["mha", "gqa"])
def test_flash_decode_split_cuda_never_reads_past_kv_len(H, Hkv):
    """NaN in every row at or past kv_len (in the scales for int8) never
    reaches the output while the rows are split across CTAs."""
    dev = needs_cuda()
    S, kv_len = 1000, 777
    _flash_split_plan(dev, H, Hkv, kv_len)
    for dtype in (torch.float32, torch.int8):
        args = list(_flash_case(dev, B=1, S=S, H=H, Hkv=Hkv, Dh=32,
                                dtype=dtype, seed=27))
        want = tref.flash_decode_ref(*args, kv_len=kv_len)
        for i in ((3, 4) if dtype == torch.int8 else (1, 2)):
            args[i][:, kv_len:] = float("nan")
        got = tk.flash_decode(*args, kv_len=kv_len)
        assert not torch.isnan(got).any()
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits,group,M,K,N", [
    (2, 32, 8, 256, 160), (3, 32, 5, 96, 128), (4, 64, 16, 512, 96),
    (8, 32, 9, 160, 64), (1, 16, 8, 2048, 8192), (2, 16, 8, 8192, 2048)])
def test_quant_matmul_cuda_matches_plain(dtype, bits, group, M, K, N):
    """The kernel against the plain version at the reference's 5e-4;
    3-bit pads K (10 codes per word), M and N are off any tiling; 1 bit
    packs 32 codes a word (Table 3's 1-bit and 2-bit g16 at opt-1.3b's
    up and down)."""
    dev = needs_cuda()
    from repro_torch.core.quant import QuantConfig, quantize_tensor
    g = torch.Generator().manual_seed(bits * 100 + M)
    qt = quantize_tensor(torch.randn((K, N), generator=g),
                         QuantConfig(bits=bits, group_size=group)).to(dev)
    x = torch.randn((M, K), generator=g).to(dev, dtype)
    before = tk.LAUNCHES["quant_matmul"]
    out = tk.quant_matmul(x, qt.packed, qt.scale, qt.zero, bits=bits,
                          group=group)
    assert tk.LAUNCHES["quant_matmul"] == before + 1
    assert out.dtype == torch.float32 and out.shape == (M, N)
    torch.testing.assert_close(out, tref.quant_matmul_ref(
        x, qt.packed, qt.scale, qt.zero, bits, group), rtol=5e-4, atol=5e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits,group,M,K,N", [
    (2, 32, 8, 8192, 2048), (3, 32, 8, 2048, 256), (4, 128, 128, 1024, 1024),
    (6, 32, 3, 640, 37)], ids=["down", "3-bit", "M128", "ragged"])
def test_quant_matmul_cuda_split_k_matches_plain(dtype, bits, group, M, K, N):
    """Shapes the planner cuts into two or more runs of K (split pass, then
    the ordered sum of the partials): opt-1.3b's down projection, a padded
    3-bit K, M = 128, and a ragged N with 6 bits; 5e-4 as above."""
    dev = needs_cuda()
    from repro_torch.core.quant import QuantConfig, quantize_tensor
    tqm = importlib.import_module("repro_torch.kernels.quant_matmul")
    g = torch.Generator().manual_seed(bits * 10 + M)
    qt = quantize_tensor(torch.randn((K, N), generator=g),
                         QuantConfig(bits=bits, group_size=group)).to(dev)
    assert tqm.plan(M, N, qt.packed.shape[0], bits, group,
                    tqm.sm_count(dev)).n_split >= 2
    x = torch.randn((M, K), generator=g).to(dev, dtype)
    before = tk.LAUNCHES["quant_matmul"]
    out = tk.quant_matmul(x, qt.packed, qt.scale, qt.zero, bits=bits,
                          group=group)
    assert tk.LAUNCHES["quant_matmul"] == before + 1
    torch.testing.assert_close(out, tref.quant_matmul_ref(
        x, qt.packed, qt.scale, qt.zero, bits, group), rtol=5e-4, atol=5e-4)


def test_flash_decode_and_quant_matmul_raise_on_bad_inputs():
    dev = needs_cuda()
    q, k, v, _, _ = _flash_case(dev, B=2, S=8, H=4, Hkv=2, Dh=16,
                                dtype=torch.float32, seed=1)
    with pytest.raises(ValueError, match="contiguous"):
        tk.flash_decode(q, k.transpose(1, 2).contiguous().transpose(1, 2), v)
    with pytest.raises(ValueError, match="kv_len"):
        tk.flash_decode(q, k, v, kv_len=-1)
    words = torch.zeros((4, 8), dtype=torch.int32, device=dev)
    sz = torch.ones((2, 8), device=dev)
    with pytest.raises(ValueError, match="K_pad"):
        tk.quant_matmul(torch.ones((2, 80), device=dev), words, sz, sz,
                        bits=2, group=32)
    with pytest.raises(ValueError, match="dtype"):
        tk.quant_matmul(torch.ones((2, 64), device=dev), words.float(), sz,
                        sz, bits=2, group=32)


def test_search_measure_memory_unit_below_stack_on_the_card():
    """``measure_memory`` at opt-tiny: the candidate batch is K units under
    ``install="unit"`` and K stacks under ``"stack"`` (a ratio of exactly
    n_units), the stack is the same, and the unit lane's allocator peak
    stays below the stack lane's."""
    dev = needs_cuda()
    from repro_torch.configs import get_config
    from repro_torch.core.quant import QuantConfig
    from repro_torch.core.search import SearchConfig
    from repro_torch.data.calib import calibration_tensor
    from repro_torch.models.model import init_params
    from repro_torch.search import run

    cfg = get_config("opt-tiny").reduced()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    calib = calibration_tensor(cfg.vocab_size, n_seqs=2, seq_len=32,
                               device=dev)
    stats = {}
    for mode in ("unit", "stack"):
        res = run(params, params, cfg, QuantConfig(2, 32), calib,
                  SearchConfig(steps=3, population=4, fused_kernel=True,
                               log_every=0, measure_memory=True,
                               install=mode))
        stats[mode] = res.stats
    assert stats["unit"]["stack_bytes"] == stats["stack"]["stack_bytes"]
    assert (stats["unit"]["candidate_batch_bytes"] * cfg.n_layers
            == stats["stack"]["candidate_batch_bytes"])
    assert stats["unit"]["candidate_batch_bytes"] * cfg.n_layers == \
        4 * stats["unit"]["stack_bytes"]
    assert 0 < stats["unit"]["peak_live_bytes"] < \
        stats["stack"]["peak_live_bytes"]


# ---- causal_attention: the bf16 forward's fused attention ----------------

def _causal_case(dev, *, B, S, Hq, Hkv, Dh, seed):
    """bf16 q, k, v on the card, made on the CPU from a seed; q doubled so
    the softmax is peaked as well as flat."""
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((B, S, Hq, Dh), generator=g) * 2.0
    k = torch.randn((B, S, Hkv, Dh), generator=g)
    v = torch.randn((B, S, Hkv, Dh), generator=g)
    return tuple(t.to(dev, torch.bfloat16) for t in (q, k, v))


def _causal_f64(q, k, v):
    """Causal attention in float64 on the same bf16 values."""
    B, S, Hq, Dh = q.shape
    rep = Hq // k.shape[2]
    qd = q.double()
    kd = k.double().repeat_interleave(rep, dim=2)
    vd = v.double().repeat_interleave(rep, dim=2)
    s = torch.einsum("bihd,bjhd->bhij", qd, kd) * Dh ** -0.5
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    return torch.einsum("bhij,bjhd->bihd", p, vd)


def _hold_causal(got, plain, want64):
    """The kernel's largest error against float64 exceeds the plain
    path's by at most one bf16 ulp of the output, and the two agree bit for
    bit on at least 99 % of the elements."""
    top = float(want64.abs().max())
    ulp = 2.0 ** (np.floor(np.log2(top)) - 7)
    err_k = float((got.double() - want64).abs().max())
    err_p = float((plain.double() - want64).abs().max())
    same = float((got == plain).double().mean())
    assert err_k <= err_p + ulp, (err_k, err_p, ulp)
    assert same >= 0.99, same


CAUSAL_CASES = [(8, 512, 32, 8, 128), (2, 256, 8, 8, 64),
                (2, 300, 8, 2, 128), (3, 300, 4, 4, 64),
                (4, 1, 8, 2, 128), (2, 1, 4, 4, 64)]
CAUSAL_IDS = ["qwen3-4b", "mha-dh64", "ragged-gqa", "ragged-dh64", "s1-gqa",
              "s1-dh64"]


@pytest.mark.parametrize("B,S,Hq,Hkv,Dh", CAUSAL_CASES, ids=CAUSAL_IDS)
def test_causal_attention_cuda_matches_plain(B, S, Hq, Hkv, Dh):
    dev = needs_cuda()
    q, k, v = _causal_case(dev, B=B, S=S, Hq=Hq, Hkv=Hkv, Dh=Dh, seed=S + Dh)
    before = tk.LAUNCHES["causal_attention"]
    got = tk.causal_attention(q, k, v)
    assert tk.LAUNCHES["causal_attention"] == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    _hold_causal(got, tref.causal_attention_ref(q, k, v),
                 _causal_f64(q, k, v))


@pytest.mark.parametrize("B,S,Hq,Hkv,Dh", [(2, 333, 14, 2, 64),
                                           (1, 1024, 8, 8, 128)],
                         ids=["rep7", "long"])
def test_causal_attention_cuda_other_layouts_match_plain(B, S, Hq, Hkv, Dh):
    """InternVL2's GQA at 7 query heads a KV head, and one long sequence
    (the grid's heaviest blocks first)."""
    dev = needs_cuda()
    q, k, v = _causal_case(dev, B=B, S=S, Hq=Hq, Hkv=Hkv, Dh=Dh, seed=7)
    _hold_causal(tk.causal_attention(q, k, v),
                 tref.causal_attention_ref(q, k, v), _causal_f64(q, k, v))


def test_causal_attention_refuses_bad_inputs_before_any_launch():
    dev = needs_cuda()
    q, k, v = _causal_case(dev, B=2, S=16, Hq=4, Hkv=2, Dh=64, seed=1)
    q112, k112, _ = _causal_case(dev, B=2, S=16, Hq=4, Hkv=2, Dh=112, seed=1)
    shifted = torch.zeros(q.numel() + 1, device=dev,
                          dtype=torch.bfloat16)[1:].view(q.shape)
    before = tk.LAUNCHES["causal_attention"]
    bad = [((q112, k112, k112), "head dim"),
           ((q.float(), k, v), "dtype"),
           ((q, k, v.float()), "dtype"),
           ((q.transpose(1, 2).contiguous().transpose(1, 2), k, v),
            "contiguous"),
           ((q[:, :, :3], k, v), "multiple"),
           ((q, k[:, :8], v), "shape"),
           ((shifted, k, v), "16-byte"),
           ((q, k, v.clone().requires_grad_()), "grad")]
    for args, match in bad:
        with pytest.raises(ValueError, match=match):
            tk.causal_attention(*args)
    assert tk.LAUNCHES["causal_attention"] == before


def test_causal_attention_counts_a_launch_a_layer_in_a_bf16_forward():
    """The engagement count: one launch a layer in a bf16 forward of a
    Qwen3-like model at Dh 128, none in its f32 twin."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.model import forward, init_params

    dev = needs_cuda()
    base = dataclasses.replace(get_config("qwen3-4b").reduced(),
                               head_dim=128)
    toks = torch.randint(0, base.vocab_size, (2, 96),
                         generator=torch.Generator().manual_seed(0)).to(dev)
    for dtype, want in (("bfloat16", base.n_layers), ("float32", 0)):
        cfg = dataclasses.replace(base, param_dtype=dtype,
                                  compute_dtype=dtype)
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             device=dev)
        tk.reset_launch_counts()
        logits = forward(params, cfg, toks)
        assert tk.LAUNCHES["causal_attention"] == want
        assert bool(torch.isfinite(logits.float()).all())
