"""Port parity: paged one-token decode attention — the plain version every
CUDA route is held to (``repro_torch.kernels.ref.paged_decode_ref``, which
``kernels.paged_decode`` runs for CPU tensors) — vs the JAX reference's
``ops.paged_decode`` (its three Pallas kernels, in interpret mode on the
CPU, as ``tests/test_paged.py`` runs them) and its ``paged_decode_ref``
oracle, at the reference's bar of 1e-5. Also ``quantize_kv`` and the
routing of the paged-decode wrapper.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers.torch_parity import one_torch_thread, to_np  # noqa: F401
from repro.kernels import paged_decode as jpaged_decode
from repro.kernels.ref import paged_decode_ref as jpaged_ref
from repro.models.layers import quantize_kv as jquantize_kv
from repro_torch import kernels as tk
from repro_torch.models.layers import quantize_kv as tquantize_kv

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
