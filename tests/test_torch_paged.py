"""Port parity: paged one-token decode attention — the plain version every
CUDA route is held to (``repro_torch.kernels.ref.paged_decode_ref``, which
``kernels.paged_decode`` runs for CPU tensors) — vs the JAX reference's
``ops.paged_decode`` (its three Pallas kernels, in interpret mode on the
CPU, as ``tests/test_paged.py`` runs them) and its ``paged_decode_ref``
oracle, at the reference's bar of 1e-5. Also ``quantize_kv``, the
routing of the paged-decode wrapper, and the split arithmetic of the
fused-GQA routes (their planner, and the plain ``merge_partials`` that
their merge kernel follows, against the reference's).
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers.torch_parity import one_torch_thread, to_np  # noqa: F401
from repro.dist.attention import merge_partials as jmerge_partials
from repro.kernels import paged_decode as jpaged_decode
from repro.kernels.ref import paged_decode_ref as jpaged_ref
from repro.models.layers import quantize_kv as jquantize_kv
from repro_torch import kernels as tk
from repro_torch.kernels import ref as tref
from repro_torch.models.layers import quantize_kv as tquantize_kv

pd = importlib.import_module("repro_torch.kernels.paged_decode")

pytestmark = pytest.mark.usefixtures("one_torch_thread")
TOL = dict(rtol=1e-5, atol=1e-5)


def _random_paged(seed, B, H, Hkv, Dh, psz, n_pages, max_pages, int8=False,
                  lens=None):
    """numpy inputs: distinct physical pages per sequence, tables padded
    with the null page 0 like the batcher's."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, Dh)).astype(np.float32)
    kp = rng.standard_normal((n_pages, psz, Hkv, Dh)).astype(np.float32)
    vp = rng.standard_normal((n_pages, psz, Hkv, Dh)).astype(np.float32)
    perm = rng.permutation(n_pages - 1) + 1
    bt = np.zeros((B, max_pages), np.int32)
    flat = perm[: B * max_pages]
    bt.flat[: flat.size] = flat
    if lens is None:
        lens = rng.integers(1, max_pages * psz + 1, size=B)
    lens = np.asarray(lens, np.int32)
    ks = vs = None
    if int8:
        ks = (np.abs(kp).max(-1) / 127.0 + 1e-8).astype(np.float32)
        vs = (np.abs(vp).max(-1) / 127.0 + 1e-8).astype(np.float32)
        kp = np.round(kp / ks[..., None]).astype(np.int8)
        vp = np.round(vp / vs[..., None]).astype(np.int8)
    return q, kp, vp, bt, lens, ks, vs


def _both(args):
    """The same numpy inputs as jnp arrays and as CPU tensors."""
    j = [None if a is None else jnp.asarray(a) for a in args]
    t = [None if a is None else torch.from_numpy(np.array(a)) for a in args]
    return j, t


def _check(got, want):
    if isinstance(want, (tuple, list)):
        for g, w in zip(got, want):
            np.testing.assert_allclose(to_np(g), np.asarray(w), **TOL)
    else:
        np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("psz", [4, 8, 16, 32])
def test_mha_matches_reference(psz):
    j, t = _both(_random_paged(psz, B=3, H=4, Hkv=4, Dh=16, psz=psz,
                               n_pages=10, max_pages=3))
    got = tk.paged_decode(*t)
    _check(got, jpaged_decode(*j))
    _check(got, jpaged_ref(*j))


@pytest.mark.parametrize("H,Hkv", [(8, 4), (8, 2), (4, 1)])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_gqa_matches_reference(H, Hkv, fused):
    """The fused per-KV-head route and ``fused_gqa=False`` (per query head)
    are one function: query head h reads KV head h // rep."""
    j, t = _both(_random_paged(7, B=3, H=H, Hkv=Hkv, Dh=16, psz=8,
                               n_pages=13, max_pages=4))
    got = tk.paged_decode(*t, fused_gqa=fused)
    _check(got, jpaged_decode(*j, fused_gqa=fused))
    _check(got, jpaged_ref(*j))


@pytest.mark.parametrize("mp", [2, 4])
def test_multipage_matches_reference(mp):
    """max_pages 5 is not a multiple of MP: the last page block is partly
    dead. Partials included."""
    j, t = _both(_random_paged(31, B=3, H=8, Hkv=2, Dh=16, psz=8,
                               n_pages=16, max_pages=5))
    _check(tk.paged_decode(*t, gqa_pages_per_block=mp),
           jpaged_decode(*j, gqa_pages_per_block=mp))
    _check(tk.paged_decode(*t, gqa_pages_per_block=mp, normalize=False),
           jpaged_decode(*j, gqa_pages_per_block=mp, normalize=False))


@pytest.mark.parametrize("H,Hkv,mp", [(4, 4, 1), (8, 2, 1), (8, 2, 2)])
def test_int8_pages_match_reference(H, Hkv, mp):
    lens = [1, 5, 9, 16]
    j, t = _both(_random_paged(23, B=4, H=H, Hkv=Hkv, Dh=32, psz=4,
                               n_pages=17, max_pages=4, int8=True, lens=lens))
    got = tk.paged_decode(*t, gqa_pages_per_block=mp)
    _check(got, jpaged_decode(*j, gqa_pages_per_block=mp))
    _check(got, jpaged_ref(*j))


@pytest.mark.parametrize("H,Hkv,mp", [(4, 4, 1), (8, 2, 1), (8, 2, 4)],
                         ids=["mha", "gqa", "gqa-mp4"])
@pytest.mark.parametrize("normalize", [True, False], ids=["out", "partials"])
def test_ragged_lengths_including_zero(H, Hkv, mp, normalize):
    """Lengths 0, 1, page-aligned and P·psz. Against the TPU kernels (an
    empty sequence gives exactly 0, with (m, l) = (-1e30, 0)) everywhere,
    and against the reference oracle on the non-empty rows."""
    psz, P = 8, 6
    lens = [0, 1, psz, 2 * psz + 3, P * psz]
    j, t = _both(_random_paged(41, B=5, H=H, Hkv=Hkv, Dh=16, psz=psz,
                               n_pages=31, max_pages=P, lens=lens))
    got = tk.paged_decode(*t, normalize=normalize, gqa_pages_per_block=mp)
    _check(got, jpaged_decode(*j, normalize=normalize,
                              gqa_pages_per_block=mp))
    want = jpaged_ref(*j, normalize=normalize)
    for g, w in zip((got,) if normalize else got,
                    (want,) if normalize else want):
        np.testing.assert_allclose(to_np(g)[1:], np.asarray(w)[1:], **TOL)
    out = got if normalize else got[0]
    assert not out[0].any(), "an empty sequence must give exactly 0"


@pytest.mark.parametrize("H,Hkv,mp", [(4, 4, 1), (8, 2, 1), (8, 2, 2)])
@pytest.mark.parametrize("every_slot", [False, True],
                         ids=["dead-pages", "every-slot"])
def test_poisoned_dead_pages(H, Hkv, mp, every_slot):
    """NaN in every page past each sequence's live count (the reference's
    ``test_paged_decode_skipped_pages_never_read``) never reaches the
    output, which equals the unpoisoned one and the TPU kernels'. The port
    goes further: NaN in EVERY slot past each length (the tail of the last
    live page and the null page too) is never read either — the TPU
    kernels multiply those slots' zero probabilities into V, so that case
    is held to the unpoisoned output only."""
    psz, P = 4, 8
    args = _random_paged(13, B=3, H=H, Hkv=Hkv, Dh=8, psz=psz,
                         n_pages=3 * P + 1, max_pages=P, lens=[3, 2 * psz, 0])
    q, kp, vp, bt, lens, _, _ = args
    kp2, vp2 = kp.copy(), vp.copy()
    for b in range(bt.shape[0]):
        n_live = max(-(-int(lens[b]) // psz), 1)
        for p in range(P):
            for s in range(psz):
                if (p * psz + s >= lens[b]) if every_slot else p >= n_live:
                    kp2[bt[b, p], s] = vp2[bt[b, p], s] = np.nan
    if every_slot:
        kp2[0] = vp2[0] = np.nan
    j, t = _both((q, kp2, vp2, bt, lens, None, None))
    _, t_clean = _both(args)
    got = tk.paged_decode(*t, gqa_pages_per_block=mp)
    assert not torch.isnan(got).any()
    _check(got, tk.paged_decode(*t_clean, gqa_pages_per_block=mp))
    if not every_slot:
        _check(got, jpaged_decode(*j, gqa_pages_per_block=mp))


def test_quantize_kv_matches_reference():
    rng = np.random.default_rng(5)
    k = (rng.standard_normal((2, 7, 4, 16)) * 3).astype(np.float32)
    v = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    k[0, 0, 0] = np.linspace(-127, 127, 16) * 0.5   # exact .5 ties
    got = tquantize_kv(torch.from_numpy(k), torch.from_numpy(v))
    want = jquantize_kv(jnp.asarray(k), jnp.asarray(v))
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == torch.int8
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


@pytest.mark.parametrize("H,Hkv,fused,mp,route", [
    (4, 4, True, 1, "paged_decode"),
    (4, 4, True, 4, "paged_decode"),          # MHA never takes the GQA grid
    (8, 2, True, 1, "paged_decode_gqa"),
    (8, 2, True, 2, "paged_decode_gqa_mp"),
    (8, 2, False, 2, "paged_decode"),         # fused_gqa=False: per query head
    (32, 8, True, 4, "paged_decode_gqa_mp"),
    (32, 32, False, 1, "paged_decode"),
])
def test_routing_matches_reference_ops(H, Hkv, fused, mp, route):
    """``repro.kernels.ops.paged_decode`` lines 161-170: GQA + fused ->
    per-KV-head grid (multi-page when pages_per_block > 1), else the
    per-query-head grid. The route names the launch counter a CUDA call
    bumps."""
    assert tk.paged_decode_route(H, Hkv, fused_gqa=fused,
                                 gqa_pages_per_block=mp) == route
    assert route in tk.LAUNCHES


def test_cpu_calls_launch_nothing():
    """A CPU tensor runs the plain version and counts no launch."""
    _, t = _both(_random_paged(3, B=2, H=8, Hkv=2, Dh=16, psz=8, n_pages=9,
                               max_pages=4))
    before = dict(tk.LAUNCHES)
    tk.paged_decode(*t, gqa_pages_per_block=2)
    assert tk.LAUNCHES == before


# ---- the fused-GQA routes' split: planner and merge arithmetic ----------

H100_SMS = 132


def _runs(sp, P):
    """The page ranges [lo, hi) of a plan's runs over a P-page table."""
    return [(s * sp.run_pages, min((s + 1) * sp.run_pages, P))
            for s in range(sp.n_split)]


def test_merge_partials_matches_reference():
    """The plain merge against ``repro.dist.attention.merge_partials`` on the
    same partials (one run empty in some rows, as a split past a sequence's
    end gives), at 1e-6."""
    rng = np.random.default_rng(17)
    N, B, H, Dh = 4, 3, 5, 8
    acc = rng.standard_normal((N, B, H, Dh)).astype(np.float32) * 3
    m = rng.standard_normal((N, B, H)).astype(np.float32) * 4
    l = rng.uniform(0.5, 20, (N, B, H)).astype(np.float32)  # noqa: E741
    acc[1, 0], m[1, 0], l[1, 0] = 0.0, -1e30, 0.0          # an empty run
    want = jmerge_partials(jnp.asarray(acc), jnp.asarray(m), jnp.asarray(l))
    got = tref.merge_partials(torch.from_numpy(acc), torch.from_numpy(m),
                              torch.from_numpy(l))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_merge_partials_of_empty_rows_is_exactly_zero():
    """Every run empty: 0 with (m, l) = (-1e30, 0), where the reference's
    acc / l is 0 / 0."""
    acc = torch.zeros((3, 2, 4, 8))
    m = torch.full((3, 2, 4), -1e30)
    l = torch.zeros((3, 2, 4))  # noqa: E741
    out = tref.merge_partials(acc, m, l)
    assert not torch.isnan(out).any() and not out.any()
    a, m2, l2 = tref.merge_partials(acc, m, l, normalize=False)
    assert not a.any() and bool((m2 == -1e30).all()) and not l2.any()


@pytest.mark.parametrize("H,Hkv,mp", [(4, 4, 1), (8, 2, 1), (8, 2, 2)],
                         ids=["mha", "gqa", "gqa-mp2"])
@pytest.mark.parametrize("runs_from", ["plan", "one-unit"])
@pytest.mark.parametrize("normalize", [True, False], ids=["out", "partials"])
def test_split_runs_merge_to_unsplit(H, Hkv, mp, runs_from, normalize):
    """The split pass's arithmetic on the plain version: each run's
    partials (its own block-table slice, its length clamped to the run)
    merge to the unsplit decode at 1e-5. Lengths 0, 1, one ending mid-page
    and the full table, so runs past a sequence's end are empty; a
    zero-length sequence gives exactly 0 and no NaN."""
    psz, P = 8, 48
    lens = [0, 1, 5 * psz + 3, 300, P * psz]
    args = _random_paged(29, B=5, H=H, Hkv=Hkv, Dh=16, psz=psz,
                         n_pages=5 * P + 1, max_pages=P, lens=lens)
    _, (q, kp, vp, bt, ln, _, _) = _both(args)
    route = "paged_decode_gqa_mp" if mp > 1 else "paged_decode_gqa"
    sp = pd.plan(route, 5, Hkv, P, psz, mp, H100_SMS)
    if runs_from == "one-unit":
        sp = sp._replace(run_pages=sp.unit_pages,
                         n_split=-(-P // sp.unit_pages))
    assert sp.n_split > 1
    parts = []
    for lo, hi in _runs(sp, P):
        run_lens = torch.clamp(ln - lo * psz, 0, (hi - lo) * psz).int()
        parts.append(tref.paged_decode_ref(q, kp, vp, bt[:, lo:hi].contiguous(),
                                           run_lens, normalize=False))
    acc, m, l = (torch.stack(x) for x in zip(*parts))  # noqa: E741
    got = tref.merge_partials(acc, m, l, normalize=normalize)
    want = tref.paged_decode_ref(q, kp, vp, bt, ln, normalize=normalize)
    _check(got, want)
    out = got if normalize else got[0]
    assert not torch.isnan(out).any()
    assert not out[0].any(), "an empty sequence must give exactly 0"
    if not normalize:
        assert bool((got[1][0] == -1e30).all()) and not got[2][0].any()


@pytest.mark.parametrize("route,mp", [("paged_decode_gqa", 1),
                                      ("paged_decode_gqa_mp", 2),
                                      ("paged_decode_gqa_mp", 4)])
@pytest.mark.parametrize("P", [1, 2, 3, 4, 5])
def test_planner_keeps_the_decode_shape_whole(route, mp, P):
    """The main path's decode shape (B 8, 32/8 heads, page size 16, at most
    5 pages): one run, so one launch and no merge, as before the split."""
    sp = pd.plan(route, 8, 8, P, 16, mp, H100_SMS)
    assert sp.n_split == 1 and sp.run_pages >= P


@pytest.mark.parametrize("route,mp", [("paged_decode_gqa", 1),
                                      ("paged_decode_gqa_mp", 2),
                                      ("paged_decode_gqa_mp", 4)])
@pytest.mark.parametrize("B,P", [(1, 512), (8, 64), (2, 64)],
                         ids=["1x8192", "8x1024", "2x1024"])
def test_planner_splits_long_contexts(route, mp, B, P):
    """Long contexts split into more CTAs than the (b, KV head) grid, and
    into no more than one wave of two CTAs per SM."""
    sp = pd.plan(route, B, 8, P, 16, mp, H100_SMS)
    assert sp.n_split > 1
    assert B * 8 * sp.n_split <= pd.CTAS_PER_SM * H100_SMS
    assert sp.run_pages * 16 >= pd.MIN_RUN_ROWS


@pytest.mark.parametrize("route,mp", [("paged_decode_gqa", 1),
                                      ("paged_decode_gqa_mp", 2),
                                      ("paged_decode_gqa_mp", 3),
                                      ("paged_decode_gqa_mp", 8),
                                      ("paged_decode", 1)])
@pytest.mark.parametrize("psz", [1, 4, 16, 64])
def test_planner_runs_cover_every_page_once(route, mp, psz):
    """Over many (B, Hkv, P): the runs cover every page of the table exactly
    once, none starts past it, and every run boundary falls on a unit (a
    block of MP pages on the multi-page route)."""
    for B in (1, 2, 3, 8, 64):
        for Hkv in (1, 2, 8):
            for P in (1, 2, 7, 16, 63, 64, 65, 512, 1000):
                sp = pd.plan(route, B, Hkv, P, psz, mp, H100_SMS)
                if route == "paged_decode_gqa_mp":
                    assert sp.unit_pages == mp
                assert sp.run_pages % sp.unit_pages == 0
                pages = [p for lo, hi in _runs(sp, P) for p in range(lo, hi)]
                assert pages == list(range(P))
                assert (sp.n_split - 1) * sp.run_pages < P


# ---- the per-query-head route on the split-KV body ----------------------

@pytest.mark.parametrize("P", [1, 2, 3, 4, 5])
def test_head_route_planner_keeps_the_decode_shape_whole(P):
    """The product's decode shape (B 8, 32 query heads, page size 16, at
    most 5 pages): 256 CTAs, one run, so one launch and no merge."""
    sp = pd.plan("paged_decode", 8, 32, P, 16, 1, H100_SMS)
    assert sp.n_split == 1 and sp.run_pages >= P


@pytest.mark.parametrize("B,P,split", [(8, 64, False), (1, 512, True),
                                       (2, 64, True)],
                         ids=["8x1024", "1x8192", "2x1024"])
def test_head_route_planner_splits_only_short_of_a_wave(B, P, split):
    """The per-query-head route's pairs are B · H (32 query heads): B 8 ×
    1024 already fills a wave of two CTAs per SM and stays whole; one or
    two long sequences split, into no more than that wave."""
    sp = pd.plan("paged_decode", B, 32, P, 16, 1, H100_SMS)
    assert (sp.n_split > 1) == split
    assert B * 32 * sp.n_split <= max(pd.CTAS_PER_SM * H100_SMS, B * 32)
    assert sp.unit_pages == 2 and sp.run_pages * 16 >= pd.MIN_RUN_ROWS


@pytest.mark.parametrize("normalize", [True, False], ids=["out", "partials"])
@pytest.mark.parametrize("H,Hkv", [(4, 4), (8, 2)], ids=["mha", "gqa-unfused"])
def test_head_route_runs_merge_to_unsplit(H, Hkv, normalize):
    """The per-query-head route's runs (planned over B · H pairs) on the
    plain version: each run's partials merge to the unsplit decode at 1e-5,
    a zero-length sequence to exactly 0."""
    psz, P = 8, 48
    lens = [0, 1, 5 * psz + 3, 300, P * psz]
    args = _random_paged(31, B=5, H=H, Hkv=Hkv, Dh=16, psz=psz,
                         n_pages=5 * P + 1, max_pages=P, lens=lens)
    _, (q, kp, vp, bt, ln, _, _) = _both(args)
    sp = pd.plan("paged_decode", 5, H, P, psz, 1, H100_SMS)
    assert sp.n_split > 1
    parts = []
    for lo, hi in _runs(sp, P):
        run_lens = torch.clamp(ln - lo * psz, 0, (hi - lo) * psz).int()
        parts.append(tref.paged_decode_ref(q, kp, vp, bt[:, lo:hi].contiguous(),
                                           run_lens, normalize=False))
    acc, m, l = (torch.stack(x) for x in zip(*parts))  # noqa: E741
    got = tref.merge_partials(acc, m, l, normalize=normalize)
    _check(got, tref.paged_decode_ref(q, kp, vp, bt, ln, normalize=normalize))
    out = got if normalize else got[0]
    assert not torch.isnan(out).any() and not out[0].any()
