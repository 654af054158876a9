"""Port parity on the SSM and hybrid families, continued: the search
(``MambaAdapter``, ``SharedFFNAdapter``, the two-phase hybrid run), RTN,
the fixed-slot server, the refusals, and the CLIs with ``--arch
mamba2-2.7b`` / ``zamba2-7b``.

Configs and weights as in ``tests/test_torch_ssm_model.py`` (the reduced
sizes, the reference's ``init_params`` carried across). The replayed
searches quantize at 2 bits with group 8 and move half of a head's
channels a step (``subset_frac=0.5``): at the reduced head_dim 16 a group
of 16 or 32 rows holds whole heads, so a within-head move would leave the
fake-quant weights a pure permutation and the loss unchanged but for fp32
summation order (a tie on every step). Bars (measured worst case on the
CPU beside each):

- the search under the reference's replayed proposals: the same accept
  decisions, losses within rtol 1e-5 (measured ≤ 2.6e-7), no step within
  1e-5 of a tie, transforms at atol 1e-7 (the π equal), final weights
  within ``group_quant``'s one-step bar (``assert_within_one_step``);
- RTN: every quantized leaf within the one-step bar;
- ``BatchedServer`` greedy tokens identical to the reference's.
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers.torch_parity import (assert_within_one_step, one_torch_thread,  # noqa: F401
                                  to_np)
from repro import search as jsearch
from repro.configs import get_config as jget_config
from repro.core import invariance as jinv
from repro.core import quant as jq
from repro.core import rtn as jrtn
from repro.core import search as jcs
from repro.core.pipeline import quantize_model as jquantize_model
from repro.launch.serve import BatchedServer as JBatchedServer
from repro.launch.serve import Request as JRequest
from repro.models import model as jmodel
from repro.quantized.qmodel import pack_model as jpack_model
from repro.serving import decode as jdec
from repro.serving import paged_cache as jpc
from repro.serving import prefill as jpre
from repro_torch import search as tsearch
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import list_archs as tlist_archs
from repro_torch.convert import params_from_numpy
from repro_torch.core import invariance as tinv
from repro_torch.core import pipeline as tpipeline
from repro_torch.core import quant as tq
from repro_torch.core import rtn as trtn
from repro_torch.core import search as tcs
from repro_torch.core.pipeline import quantize_model as tquantize_model
from repro_torch.data.calib import calibration_tokens
from repro_torch.launch import search as tsearch_cli
from repro_torch.launch import serve as tserve
from repro_torch.models import model as tmodel
from repro_torch.models import ssm as tssm
from repro_torch.quantized.qmodel import pack_model as tpack_model
from repro_torch.serving import PagedKVCache
from repro_torch.serving import decode as tdec
from repro_torch.serving import prefill as tpre
from test_torch_search import JaxReplay
from test_torch_ssm_model import ARCHS, IDS, pair

pytestmark = pytest.mark.usefixtures("one_torch_thread")
SEED, GROUP = 3, 8
PCFG = dict(subset_frac=0.5)
STEPS = {"mamba2-2.7b": 8, "zamba2-7b": 9}     # zamba2: phases of 4 and 5
SEARCH_KEYS = ("up", "gate", "down", "w_z", "w_x", "out_proj")


class MambaReplay(JaxReplay):
    """The reference engine's key chain with the reference's
    ``MambaAdapter.propose`` (within-head moves) in place of ``propose``."""

    def __init__(self, seed, jadapter):
        super().__init__(seed)
        self.propose = jax.jit(jadapter.propose, static_argnums=2)


def replay_sources(arch, jcfg, seed=SEED):
    """What ``repro_torch.search.run`` takes to replay the reference: the
    Mamba source, and for hybrid one per phase (each phase's engine starts
    its key chain from the seed)."""
    mamba = MambaReplay(seed, jcs.MambaAdapter(jcfg))
    if arch == "zamba2-7b":
        return {"mamba": mamba, "shared": JaxReplay(seed)}
    return mamba


# ---------------------------------------------------------------------------
# adapters and the within-head move
# ---------------------------------------------------------------------------

def test_make_adapter_dispatch_matches_reference():
    for arch in tlist_archs(assigned_only=False):
        jcfg, tcfg = jget_config(arch), tget_config(arch)
        for phase in (None, "shared"):
            assert type(tcs.make_adapter(tcfg, phase)).__name__ == \
                type(jcs.make_adapter(jcfg, phase)).__name__, (arch, phase)
    assert type(tcs.make_adapter(tget_config("mamba2-2.7b"))).__name__ == \
        "MambaAdapter"


@pytest.mark.parametrize("arch", ARCHS, ids=IDS)
def test_mamba_adapter_units_and_shapes(arch):
    jcfg, tcfg, jparams, tparams = pair(arch)
    ad, jad = tcs.MambaAdapter(tcfg), jcs.MambaAdapter(jcfg)
    assert (ad.n_units, ad.di, ad.head_dim, ad.f_dim) == \
        (jad.n_units, jad.di, jad.head_dim, jad.f_dim)
    base, jbase = ad.base_stack(tparams), jad.base_stack(jparams)
    assert sorted(base) == sorted(jbase)
    rng = np.random.default_rng(1)
    pi = np.concatenate([h * ad.head_dim + rng.permutation(ad.head_dim)
                         for h in range(ad.di // ad.head_dim)])
    t = tinv.FFNTransform(torch.from_numpy(pi), torch.ones(ad.di),
                          torch.zeros(ad.di // 2))
    jt = jinv.FFNTransform(jnp.asarray(pi, jnp.int32), jnp.ones(ad.di),
                           jnp.zeros(ad.di // 2))
    u = ad.n_units - 1
    unit, junit = ad.transform_unit(base, t, u), jad.transform_unit(jbase,
                                                                    jt, u)
    qc, jqc = tq.QuantConfig(2, GROUP), jq.QuantConfig(2, GROUP)
    fq, jfq = ad.quant_unit(unit, qc), jad.quant_unit(junit, jqc)
    for k in unit:
        np.testing.assert_array_equal(unit[k].numpy(), np.asarray(junit[k]))
        if k in ("w_z", "w_x", "out_proj"):
            s, _ = jq.compute_qparams(junit[k], jqc)
            assert_within_one_step(fq[k], jfq[k], s, GROUP)
        else:
            assert fq[k] is unit[k]
    stack = ad.quant_stack(base, qc)
    installed = ad.install(tparams, stack)["blocks"]["ssm"]
    assert installed["w_B"] is tparams["blocks"]["ssm"]["w_B"]
    assert torch.equal(installed["out_proj"][u],
                       tq.fake_quant(base["out_proj"][u], qc))


def test_shared_ffn_adapter_units_and_shapes():
    jcfg, tcfg, jparams, tparams = pair("zamba2-7b")
    ad, jad = tcs.SharedFFNAdapter(tcfg), jcs.SharedFFNAdapter(jcfg)
    assert ad.n_units == jad.n_units == 1 and ad.f_dim == jad.f_dim
    base, jbase = ad.base_stack(tparams), jad.base_stack(jparams)
    assert sorted(base) == sorted(jbase) == ["down", "gate", "up"]
    for k in base:
        np.testing.assert_array_equal(base[k].numpy(), np.asarray(jbase[k]))
    t = tinv.propose(torch.Generator().manual_seed(0),
                     tinv.identity_transform(ad.f_dim, "cpu"),
                     tinv.ProposalConfig())
    qc = tq.QuantConfig(2, 32)
    fused = ad.transform_quant_unit(base, t, 0, qc)
    unfused = ad.quant_unit(ad.transform_unit(base, t, 0), qc)
    for k in fused:
        assert torch.equal(fused[k], unfused[k]), k
    params = ad.install(tparams, ad.quant_stack(base, qc))
    assert params["shared"]["mlp"]["up"].shape == \
        tparams["shared"]["mlp"]["up"].shape
    assert params["shared"]["attn"] is tparams["shared"]["attn"]
    assert params["blocks"] is tparams["blocks"]
    assert ad.unit_override(0, fused) == ("shared", {"mlp": fused})


def test_apply_transform_mamba_matches_reference():
    rng = np.random.default_rng(0)
    D, di, hd = 8, 32, 8
    ws = [rng.standard_normal(s).astype(np.float32)
          for s in ((D, di), (D, di), (4, di), (di, D))]
    pi = np.concatenate([h * hd + rng.permutation(hd) for h in range(4)])
    got = tinv.apply_transform_mamba(torch.from_numpy(pi),
                                     *map(torch.from_numpy, ws), hd)
    want = jinv.apply_transform_mamba(jnp.asarray(pi), *map(jnp.asarray, ws),
                                      hd)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_mamba_within_head_permutation_is_invariant():
    """The reference's invariance test (``tests/test_invariance.py``) on the
    port: four within-head moves at subset_frac 0.5 (native proposals),
    the block's output unchanged at the reference's 2e-4."""
    cfg = tget_config("mamba2-2.7b").reduced(n_layers=1, d_model=32)
    params = tmodel.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    adapter = tcs.MambaAdapter(cfg)
    base = adapter.base_stack(params)
    x = torch.randn((2, 16, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    p0 = {k: v[0] for k, v in params["blocks"]["ssm"].items()}
    y0 = tssm.ssm_forward(p0, cfg, x)
    src = tinv.NativeProposals(2, "cpu", adapter.propose)
    t = tinv.identity_transform(adapter.di, "cpu")
    for _ in range(4):
        t = src(t, 1, tinv.ProposalConfig(subset_frac=0.5))[0]
    assert int((t.pi != torch.arange(adapter.di)).sum()) > 0
    y1 = tssm.ssm_forward({**p0, **adapter.transform_unit(base, t, 0)}, cfg, x)
    np.testing.assert_allclose(y1.numpy(), y0.numpy(), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("frac,n_move", [(0.1, 2), (0.5, 8), (0.25, 4)])
def test_within_head_proposals_move_one_head(frac, n_move):
    """``propose_within_head``: one head's channels only, at most n_move of
    them, s and φ untouched; the same seed gives the same draws."""
    hd, n_heads = 16, 8
    t = tinv.identity_transform(hd * n_heads, "cpu")
    pcfg = tinv.ProposalConfig(subset_frac=frac)
    a = tinv.NativeProposals(4, "cpu", lambda g, t, p: tinv.propose_within_head(
        g, t, p, hd))(t, 6, pcfg)
    b = tinv.NativeProposals(4, "cpu", lambda g, t, p: tinv.propose_within_head(
        g, t, p, hd))(t, 6, pcfg)
    heads = set()
    for c, d in zip(a, b):
        assert torch.equal(c.pi, d.pi)
        moved = torch.nonzero(c.pi != t.pi).flatten()
        assert 0 < moved.numel() <= n_move
        head = int(moved[0]) // hd
        heads.add(head)
        assert bool((moved // hd == head).all())
        assert bool((c.pi // hd == torch.arange(hd * n_heads) // hd).all())
        assert sorted(c.pi.tolist()) == list(range(hd * n_heads))
        assert c.s is t.s and c.phi is t.phi
    assert len(heads) > 1


# ---------------------------------------------------------------------------
# RTN and the search
# ---------------------------------------------------------------------------

def _bases(arch):
    jcfg, tcfg, jparams, tparams = pair(arch)
    jqc, tqc = jq.QuantConfig(2, GROUP), tq.QuantConfig(2, GROUP)
    frozen = lambda p: p[-1] not in SEARCH_KEYS  # noqa: E731
    jbase = jrtn.map_quantizable(jparams, lambda w, p: jq.fake_quant(w, jqc),
                                 only=frozen)
    tbase = trtn.map_quantizable(tparams, lambda w, p: tq.fake_quant(w, tqc),
                                 only=frozen)
    calib = calibration_tokens(jcfg.vocab_size, n_seqs=2, seq_len=32)
    return jcfg, tcfg, jparams, tparams, jbase, tbase, jqc, tqc, calib


@pytest.fixture(scope="module", params=ARCHS, ids=IDS)
def ssm_bases(request):
    return request.param, _bases(request.param)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: tree}


def _assert_quantized_leaves_close(tparams_q, jparams_q, paths, group):
    for path in paths:
        jw = jrtn.get_by_path(jparams_q, path)
        tw = trtn.get_by_path(tparams_q, path)
        for i in range(jw.shape[0] if jw.ndim == 3 else 1):
            a, b = (tw[i], jw[i]) if jw.ndim == 3 else (tw, jw)
            s, _ = jq.compute_qparams(b, jq.QuantConfig(2, group))
            assert_within_one_step(a, b, s, group)


@pytest.mark.parametrize("arch", ARCHS, ids=IDS)
def test_quantize_model_rtn_matches_reference(arch):
    jcfg, tcfg, jparams, tparams = pair(arch)
    jr = jquantize_model(jparams, jcfg, jq.QuantConfig(2, 32))
    tr = tquantize_model(tparams, tcfg, tq.QuantConfig(2, 32), device="cpu")
    assert tr.method == jr.method == "rtn"
    paths = jmodel.quantizable_paths(jparams)
    assert sorted(paths) == sorted(tmodel.quantizable_paths(tparams))
    assert {p[-1] for p in paths} >= {"w_z", "w_x", "out_proj"}
    _assert_quantized_leaves_close(tr.params_q, jr.params_q, paths, 32)
    for path, v in _flat(tr.params_q).items():
        if path not in paths:          # conv, norms, A_log / D / dt_bias ...
            np.testing.assert_array_equal(
                v.numpy(), np.asarray(jrtn.get_by_path(jparams, path)))


def test_search_replay_matches_reference(ssm_bases):
    """Under the reference's replayed proposals (Mamba: within-head moves;
    hybrid: the Mamba phase then the shared FFN phase, each from the seed):
    equal accept decisions, losses at rtol 1e-5 clear of ties, the merged
    history / accept rate / stats, and the final weights within the
    one-step bar."""
    arch, (jcfg, tcfg, jparams, tparams, jbase, tbase, jqc, tqc,
           calib) = ssm_bases
    steps = STEPS[arch]
    jres = jsearch.run(jparams, jbase, jcfg, jqc, jnp.asarray(calib),
                       jcs.SearchConfig(steps=steps, seed=SEED, log_every=0,
                                        proposal=jinv.ProposalConfig(**PCFG)))
    tres = tsearch.run(tparams, tbase, tcfg, tqc,
                       torch.from_numpy(calib.astype(np.int64)),
                       tcs.SearchConfig(steps=steps, seed=SEED, log_every=0,
                                        proposal=tinv.ProposalConfig(**PCFG)),
                       proposals=replay_sources(arch, jcfg))
    th, jh = tres.history, jres.history
    n_phases = 2 if arch == "zamba2-7b" else 1
    assert len(th) == len(jh) == steps + n_phases
    cur = None
    for (ts_, tl, tp, ta_, tacc), (js_, jl, jp, ja_, jacc) in zip(th, jh):
        assert ts_ == js_
        np.testing.assert_allclose([tl, tp, ta_], [jl, jp, ja_], rtol=1e-5)
        if js_ == 0:                     # a phase's step-0 baseline
            assert tacc and jacc
            cur = jl
            continue
        assert abs(jl - cur) >= 1e-5 * abs(jl), f"step {js_}: near tie"
        assert tacc == jacc, f"step {js_}: accept flags differ"
        if jacc:
            cur = jl
    assert sum(h[4] for h in th if h[0]) > 0, "no move was accepted"
    np.testing.assert_allclose(tres.initial_loss, jres.initial_loss,
                               rtol=1e-5)
    np.testing.assert_allclose(tres.final_loss, jres.final_loss, rtol=1e-5)
    assert tres.accept_rate == pytest.approx(jres.accept_rate, abs=1e-12)
    assert tres.stats["proposals"] == jres.stats["proposals"] == steps
    assert tres.island_histories == [th]
    for a, b in zip(tres.transforms, jres.transforms):
        np.testing.assert_allclose(to_np(a), to_np(b), rtol=0, atol=1e-7)
    paths = [p for p in jmodel.quantizable_paths(jparams)
             if p[-1] in SEARCH_KEYS]
    _assert_quantized_leaves_close(tres.params_q, jres.params_q, paths,
                                   GROUP)


@pytest.mark.parametrize("arch", ARCHS, ids=IDS)
def test_quantize_model_with_search_on_both_families(arch):
    """RTN + the search through the pipeline (native proposals, the fused
    flag asked for): the Mamba projections reach the search continuous
    (``_FFN_KEYS``), every phase runs, the loss never worsens."""
    _, tcfg, _, tparams = pair(arch)
    calib = calibration_tokens(tcfg.vocab_size, n_seqs=2, seq_len=32)
    seen = {}
    real = tpipeline.run_invar_search

    def spy(params_fp, params_base, *a, **kw):
        seen["base"] = params_base
        return real(params_fp, params_base, *a, **kw)

    tpipeline.run_invar_search = spy
    try:
        with pytest.warns(UserWarning, match="MambaAdapter has no "
                                             "transform_quant_unit"):
            res = tquantize_model(tparams, tcfg, tq.QuantConfig(2, GROUP),
                                  "rtn", calib,
                                  tcs.SearchConfig(steps=5, fused_kernel=True,
                                                   log_every=0),
                                  device="cpu")
    finally:
        tpipeline.run_invar_search = real
    ssm = seen["base"]["blocks"]["ssm"]
    for k in ("w_z", "w_x", "out_proj"):
        assert ssm[k] is tparams["blocks"]["ssm"][k], k
    assert res.method == "rtn+invarexplore"
    assert res.search.final_loss <= res.search.initial_loss
    hybrid = tcfg.block_pattern == "hybrid"
    assert len(res.search.history) == 5 + (2 if hybrid else 1)
    assert res.search.stats["fused"] is hybrid   # the shared FFN runs fused
    if hybrid:
        assert res.params_q["shared"]["attn"]["wq"] is \
            seen["base"]["shared"]["attn"]["wq"]


def test_hybrid_search_spends_odd_step_budgets_fully():
    """The reference's regression test (``tests/test_search_engine.py``) on
    the port: 7 steps run as 3 + 4, histories and stats merged."""
    _, tcfg, _, tparams = pair("zamba2-7b")
    calib = torch.from_numpy(calibration_tokens(
        tcfg.vocab_size, n_seqs=1, seq_len=32).astype(np.int64))
    res = tsearch.run(tparams, tparams, tcfg, tq.QuantConfig(2, 16), calib,
                      tcs.SearchConfig(steps=7, n_match_layers=0,
                                       log_every=0))
    assert len(res.history) == 7 + 2
    assert [h[0] for h in res.history] == [0, 1, 2, 3, 0, 1, 2, 3, 4]
    assert res.stats["proposals"] == 7, "odd budgets must be spent in full"
    assert len(res.island_histories) == 1
    assert len(res.island_histories[0]) == 7 + 2
    assert type(res.stats["uphill_accepts"]) is int
    # each phase climbs from its own baseline; the merged initial loss is
    # phase 1's, taken with the shared FFN still continuous (as in the
    # reference), so only the phases are monotone
    for seg in (res.history[:4], res.history[4:]):
        assert min(h[1] for h in seg if h[4]) <= seg[0][1]
    assert res.final_loss == min(h[1] for h in res.history[4:] if h[4])
    single = tsearch.run(tparams, tparams, tcfg, tq.QuantConfig(2, 16), calib,
                         tcs.SearchConfig(steps=3, n_match_layers=0,
                                          log_every=0), hybrid=False)
    assert single.history == res.history[:4]
    with pytest.raises(ValueError, match="hybrid"):
        _, mcfg, _, mparams = pair("mamba2-2.7b")
        tsearch.run(mparams, mparams, mcfg, tq.QuantConfig(2, 16), calib,
                    tcs.SearchConfig(steps=1, log_every=0), hybrid=True)


def test_fused_flag_on_a_mamba_adapter_warns_and_runs_unfused():
    """The reference's fallback (``search/engine.py``): a warning, the
    unfused lane, ``stats["fused"]`` False, and a history equal to the
    unfused run's."""
    _, tcfg, _, tparams = pair("mamba2-2.7b")
    calib = torch.from_numpy(calibration_tokens(
        tcfg.vocab_size, n_seqs=2, seq_len=32).astype(np.int64))
    qc = tq.QuantConfig(2, GROUP)
    runs = {}
    for fused in (False, True):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            runs[fused] = tsearch.run(
                tparams, tparams, tcfg, qc, calib,
                tcs.SearchConfig(steps=4, seed=1, fused_kernel=fused,
                                 log_every=0,
                                 proposal=tinv.ProposalConfig(**PCFG)))
        msgs = [str(w.message) for w in caught]
        assert any("falling back to the unfused" in m for m in msgs) == fused
    assert runs[True].stats["fused"] is runs[False].stats["fused"] is False
    assert runs[True].history == runs[False].history


def test_reference_warns_the_same_way():
    jcfg, _, jparams, _ = pair("mamba2-2.7b")
    calib = calibration_tokens(jcfg.vocab_size, n_seqs=1, seq_len=16)
    with pytest.warns(UserWarning, match="falling back to the unfused"):
        res = jsearch.run(jparams, jparams, jcfg, jq.QuantConfig(2, GROUP),
                          jnp.asarray(calib),
                          jcs.SearchConfig(steps=1, fused_kernel=True,
                                           log_every=0))
    assert res.stats["fused"] is False


@pytest.mark.parametrize("method", ["gptq", "awq", "omniquant"])
@pytest.mark.parametrize("arch", ARCHS, ids=IDS)
def test_calibrated_methods_refuse_both_families(arch, method):
    jcfg, tcfg, jparams, tparams = pair(arch)
    calib = calibration_tokens(jcfg.vocab_size, n_seqs=2, seq_len=16)
    with pytest.raises(AssertionError):
        jquantize_model(jparams, jcfg, jq.QuantConfig(2, 32), method=method,
                        calib_tokens=jnp.asarray(calib))
    with pytest.raises(ValueError, match="block_pattern='dense'"):
        tquantize_model(tparams, tcfg, tq.QuantConfig(2, 32), method, calib,
                        device="cpu")


# ---------------------------------------------------------------------------
# serving: BatchedServer serves, the paged stack refuses
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=ARCHS, ids=IDS)
def ssm_packed(request):
    jcfg, tcfg, jparams, _ = pair(request.param)
    jpq = jpack_model(jparams, jq.QuantConfig(bits=2, group_size=32))
    return jcfg, tcfg, jpq, params_from_numpy(jax.tree.map(np.asarray, jpq),
                                              "cpu")


def test_pack_model_packs_the_projections_and_the_shared_block(ssm_packed):
    jcfg, tcfg, jpq, tpq = ssm_packed
    _, _, _, tparams = pair(jcfg.name)
    own = tpack_model(tparams, tq.QuantConfig(bits=2, group_size=32))
    packed = {p for p, v in _flat(own).items() if isinstance(v, tq.QTensor)}
    want = {tuple(p) for p in tmodel.quantizable_paths(tparams)}
    assert packed == want
    assert {p[-1] for p in packed} >= {"w_z", "w_x", "out_proj"}
    if tcfg.block_pattern == "hybrid":
        assert ("shared", "mlp", "up") in packed
        assert ("shared", "attn", "wq") in packed
    for p in packed:
        np.testing.assert_array_equal(
            _flat(own)[p].packed.numpy(), _flat(tpq)[p].packed.numpy())


def test_batched_server_tokens_match_reference(ssm_packed):
    jcfg, tcfg, jpq, tpq = ssm_packed
    rng = np.random.default_rng(6)
    reqs = [dict(prompt=rng.integers(0, 512, int(n)).astype(np.int32),
                 max_new=int(m)) for n, m in [(5, 4), (11, 6), (7, 5)]]
    want = JBatchedServer(jpq, jcfg, batch_size=2, max_len=64).generate(
        [JRequest(**r) for r in reqs])
    flags = (False, True) if tcfg.block_pattern == "hybrid" else (False,)
    for flash in flags:
        server = tserve.BatchedServer(
            tpq, dataclasses.replace(tcfg, use_flash_decode=flash),
            batch_size=2, max_len=64, device="cpu")
        assert server.generate([tserve.Request(**r) for r in reqs]) == want


@pytest.mark.parametrize("arch", ARCHS, ids=IDS)
def test_paged_stack_refuses_both_families(arch):
    """``tests/test_paged.py::test_paged_cache_rejects_stateless_archs`` on
    the port, and the step builders and server: ValueError on both sides."""
    jcfg, tcfg = jget_config(arch).reduced(), tget_config(arch).reduced()
    with pytest.raises(ValueError, match="O\\(1\\) state"):
        jpc.PagedKVCache(jcfg, n_pages=8, page_size=8, max_pages_per_seq=4)
    with pytest.raises(ValueError, match="O\\(1\\) state"):
        PagedKVCache(tcfg, n_pages=8, page_size=8, max_pages_per_seq=4,
                     device="cpu")
    with pytest.raises(ValueError, match="paged decode requires attention"):
        jdec.make_paged_decode_step(jcfg)
    with pytest.raises(ValueError, match="paged decode requires attention"):
        tdec.make_paged_decode_step(tcfg)
    with pytest.raises(ValueError, match="paged prefill requires attention"):
        jpre.make_paged_prefill_step(jcfg)
    with pytest.raises(ValueError, match="paged prefill requires attention"):
        tpre.make_paged_prefill_step(tcfg)
    params = tmodel.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="O\\(1\\) state"):
        tserve.PagedServer(params, tcfg, device="cpu")


def test_params_from_numpy_keeps_bf16_tree_and_f32_leaves():
    """A bf16 reference tree carried across: the shared subtree arrives,
    every leaf keeps its dtype (A_log / D / dt_bias f32), values exact."""
    jcfg = jget_config("zamba2-7b").reduced(param_dtype="bfloat16",
                                             compute_dtype="bfloat16")
    jp = jax.tree.map(np.asarray, jmodel.init_params(jax.random.PRNGKey(0),
                                                     jcfg))
    tp = params_from_numpy(jp, "cpu")
    jflat, tflat = _flat(jp), _flat(tp)
    assert sorted(tflat) == sorted(jflat)
    assert ("shared", "mlp", "gate") in tflat
    for k, v in tflat.items():
        want = "float32" if k[-1] in ("A_log", "D", "dt_bias") else "bfloat16"
        assert str(v.dtype).split(".")[1] == jflat[k].dtype.name == want, k
        np.testing.assert_array_equal(to_np(v), to_np(jflat[k]))


# ---------------------------------------------------------------------------
# the CLIs (reduced sizes, as the reference's)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS, ids=IDS)
def test_serve_cli_serves_legacy_and_refuses_paged(arch):
    outs = tserve.main(["--arch", arch, "--requests", "3", "--max-new", "3",
                        "--metrics-out", "", "--legacy"], device="cpu")
    assert len(outs) == 3 and all(len(o) == 3 for o in outs)
    with pytest.raises(ValueError, match="O\\(1\\) state"):
        tserve.main(["--arch", arch, "--requests", "2", "--metrics-out", ""],
                    device="cpu")


@pytest.mark.parametrize("arch", ARCHS, ids=IDS)
def test_search_cli_runs_the_arch(arch, tmp_path):
    out = tmp_path / "bench.json"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # the Mamba fallback
        assert tsearch_cli.main(["--arch", arch, "--steps", "3", "--fused",
                                 "--seqs", "2", "--seq-len", "32", "--out",
                                 str(out), "--metrics-out", ""],
                                device="cpu") == 0
    assert arch in out.read_text()
