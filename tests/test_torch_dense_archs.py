"""Port parity on the dense zoo configs (``repro_torch.configs``: qwen3-4b,
yi-6b, internlm2-1.8b, command-r-35b): RoPE, GQA, gated SwiGLU, RMSNorm and
LayerNorm without biases, qk-norm and head_dim != d_model / n_heads, against
the JAX reference at each config's ``reduced()`` size, on the same numpy
inputs. Norm weights are perturbed from their ones / zeros init so that
every norm leaf is read.

Bars (each the bar of the port's test of the same function on OPT):
- configs: field for field equal; ``ModelConfig``'s shared defaults equal;
- ``forward`` logits and per-block outputs, ``capture_dense_taps``: rtol
  1e-4, atol 1e-5 (``test_torch_model.py``);
- prefill + 3 decode steps, logits and caches: rtol = atol = 1e-4
  (``test_torch_legacy_serve.py``); ``BatchedServer`` tokens identical;
- paged serving on qwen3-4b: greedy tokens and stats identical to the
  reference's batcher with sharing off and on, chunked prefill at non-zero
  offsets, and a preemption with re-admission (``test_torch_batcher.py``);
- the fused-lane search on yi-6b with the reference's proposals replayed,
  the gate call included: per-step losses rtol 1e-5, accept flags equal
  (``test_torch_search.py``);
- RTN / GPTQ / AWQ / OmniQuant on internlm2-1.8b: ``test_torch_baselines.py``'s
  bars: the pipeline's weight bars, except OmniQuant's optimised up / down,
  which are held by that file's other two OmniQuant bars (block losses over
  10 steps at rtol 1e-3; calibration CE within the reference's own
  one-ulp spread, ``_reference_ulp_spread``). Here the block losses agree
  to ~1e-7 and then part abruptly (layer 1 near step 50, layer 0 near 170
  of 200): a code flips at a near tie in the rounding STE, the
  trajectory ROADMAP.md's parity notes record at other bit widths;
- one train step on command-r-35b: ``test_torch_train.py``'s step bars.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers.torch_parity import one_torch_thread, to_np  # noqa: F401
from repro import search as jsearch
from repro import serving as js
from repro.configs import get_config as jget_config
from repro.configs import list_archs as jlist_archs
from repro.core import quant as jq
from repro.core import rtn as jrtn
from repro.core import search as jcs
from repro.core.gptq import gptq_process_dense as jgptq_process_dense
from repro.core.objective import calib_ce as jcalib_ce
from repro.core.omniquant import omniquant_process_dense as jomni_process
from repro.core.pipeline import quantize_model as jquantize_model
from repro.core.taps import capture_dense_taps as jcapture
from repro.launch.serve import BatchedServer as JBatchedServer
from repro.launch.serve import Request as JRequest
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import model as jmodel
from repro.models.config import ModelConfig as JModelConfig
from repro.optim import adamw as ja
from repro.quantized.qmodel import pack_model as jpack_model
from repro_torch import search as tsearch
from repro_torch import serving as ts
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import list_archs as tlist_archs
from repro_torch.convert import params_from_numpy
from repro_torch.core import quant as tq
from repro_torch.core import rtn as trtn
from repro_torch.core import search as tcs
from repro_torch.core.objective import calib_ce as tcalib_ce
from repro_torch.core.omniquant import omniquant_process_dense as tomni_process
from repro_torch.core.pipeline import quantize_model as tquantize_model
from repro_torch.core.taps import capture_dense_taps as tcapture
from repro_torch.data.calib import calibration_tokens
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.models import model as tmodel
from repro_torch.models.config import ModelConfig as TModelConfig
from repro_torch.optim import adamw as ta
from test_torch_baselines import (_grid_position, _reference_ulp_spread,
                                  assert_gptq_close, assert_parts_only_at_ties)
from test_torch_search import JaxReplay

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ARCHS = ("qwen3-4b", "yi-6b", "internlm2-1.8b", "command-r-35b")


def _perturb_norms(tree, rng, path=()):
    """Norm leaves (``ln*``, ``final_norm``, ``q_norm``, ``k_norm``) moved
    off their ones / zeros init."""
    if isinstance(tree, dict):
        return {k: _perturb_norms(v, rng, path + (k,)) for k, v in tree.items()}
    if any("norm" in p or p.startswith("ln") for p in path):
        return (tree + 0.1 * rng.standard_normal(tree.shape)).astype(tree.dtype)
    return tree


def _pair(arch, seed=0):
    jcfg, tcfg = jget_config(arch).reduced(), tget_config(arch).reduced()
    p = jax.tree.map(np.asarray, jmodel.init_params(jax.random.PRNGKey(seed),
                                                    jcfg))
    p = _perturb_norms(p, np.random.default_rng(seed))
    return jcfg, tcfg, jax.tree.map(jnp.asarray, p), params_from_numpy(p, "cpu")


@pytest.fixture(scope="module", params=ARCHS)
def arch_pair(request):
    return _pair(request.param)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: tree}


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_reference_field_for_field(arch):
    jcfg, tcfg = jget_config(arch), tget_config(arch)
    jdefaults = {f.name: f.default for f in dataclasses.fields(JModelConfig)}
    tnames = {f.name for f in dataclasses.fields(TModelConfig)}
    for name, default in jdefaults.items():
        if name in tnames:
            assert getattr(tcfg, name) == getattr(jcfg, name), name
        else:   # a field the port does not carry is at its default there
            assert getattr(jcfg, name) == default, name
    for prop in ("resolved_head_dim", "padded_vocab"):
        assert getattr(tcfg, prop) == getattr(jcfg, prop), prop
    assert tcfg.reduced() == tget_config(arch).reduced()
    for name in tnames:
        assert getattr(tcfg.reduced(), name) == getattr(jcfg.reduced(), name)


def test_model_config_defaults_equal_reference():
    jf = [f for f in dataclasses.fields(JModelConfig)]
    tf = [f for f in dataclasses.fields(TModelConfig)]
    jdef = {f.name: f.default for f in jf}
    # the port has every reference field
    assert [f.name for f in tf] == [f.name for f in jf]
    shared = [f.name for f in tf if f.name in jdef]
    assert shared == [f.name for f in tf], "the port has a field the reference lacks"
    for f in tf:
        assert f.default == jdef[f.name], f.name
    # the shared fields come in the reference's order
    assert shared == [f.name for f in jf if f.name in set(shared)]
    assert TModelConfig().pos_emb == JModelConfig().pos_emb == "rope"


def test_list_archs_registers_the_ported_reference_ids():
    """Every reference id is registered, in the reference's order."""
    ported = tlist_archs(assigned_only=False)
    assert ported == jlist_archs(assigned_only=False)
    assert tlist_archs() == jlist_archs()
    assert [a for a in ported if a.startswith("opt-")] == [
        "opt-1.3b", "opt-13b", "opt-125m", "opt-tiny"]
    for arch in ported:
        assert tget_config(arch).name == jget_config(arch).name
    with pytest.raises(KeyError, match="unknown arch"):
        tget_config("no-such-arch")


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_init_params_tree_matches_reference(arch_pair):
    jcfg, tcfg, jparams, _ = arch_pair
    jflat = _flat(jax.tree.map(np.asarray, jparams))
    tflat = _flat(tmodel.init_params(tcfg, torch.Generator().manual_seed(0),
                                     device="cpu"))
    assert sorted(tflat) == sorted(jflat)
    for path, j in jflat.items():
        assert tuple(tflat[path].shape) == j.shape, path
    assert (("blocks", "attn", "q_norm") in tflat) == tcfg.qk_norm
    assert ("embed", "pos") not in tflat


def test_forward_logits_and_hidden_match_reference(arch_pair):
    jcfg, tcfg, jparams, tparams = arch_pair
    tokens = calibration_tokens(jcfg.vocab_size, n_seqs=2, seq_len=64)
    jl, jh = jmodel.forward(jparams, jcfg, jnp.asarray(tokens),
                            collect_hidden=True)
    tl, th = tmodel.forward(tparams, tcfg, torch.from_numpy(
        tokens.astype(np.int64)), collect_hidden=True)
    assert tuple(tl.shape) == jl.shape and tuple(th.shape) == jh.shape
    np.testing.assert_allclose(to_np(tl), to_np(jl), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(to_np(th), to_np(jh), rtol=1e-4, atol=1e-5)


def test_capture_dense_taps_matches_reference(arch_pair):
    jcfg, tcfg, jparams, tparams = arch_pair
    calib = calibration_tokens(jcfg.vocab_size, n_seqs=2, seq_len=32)
    want = jcapture(jparams, jcfg, jnp.asarray(calib))
    got = tcapture(tparams, tcfg, torch.from_numpy(calib.astype(np.int64)))
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        np.testing.assert_allclose(to_np(got[k]), to_np(want[k]), rtol=1e-4,
                                   atol=1e-5, err_msg=k)


def test_prefill_and_decode_match_reference(arch_pair):
    jcfg, tcfg, jparams, tparams = arch_pair
    rng = np.random.default_rng(4)
    toks = rng.integers(0, jcfg.vocab_size, (3, 9)).astype(np.int32)
    jl, jc = jmodel.prefill(jparams, jcfg, jnp.asarray(toks), 32)
    tl, tc = tmodel.prefill(tparams, tcfg,
                            torch.from_numpy(toks.astype(np.int64)), 32)

    def close(got, want):
        np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-4,
                                   atol=1e-4)

    close(tl, jl)
    for key in jc:
        close(tc[key], jc[key])
    for step, tok in enumerate(rng.integers(0, jcfg.vocab_size, (3, 3, 1))):
        tok = tok.astype(np.int32)
        jl, jc = jmodel.decode_step(jparams, jcfg, jnp.asarray(tok), jc, 9 + step)
        tl, tc = tmodel.decode_step(tparams, tcfg,
                                    torch.from_numpy(tok.astype(np.int64)),
                                    tc, 9 + step)
        close(tl, jl)
        for key in jc:
            close(tc[key], jc[key])


# ---------------------------------------------------------------------------
# serving (qwen3-4b: qk-norm, RoPE at 1e6, GQA 4/2, Dh 16)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def qwen_packed():
    jcfg, tcfg, jparams, _ = _pair("qwen3-4b")
    jpq = jpack_model(jparams, jq.QuantConfig(bits=2, group_size=32))
    return jcfg, tcfg, jpq, params_from_numpy(jax.tree.map(np.asarray, jpq),
                                              "cpu")


def _run_both_batchers(model, prompts, max_new, *, n_pages, page_size,
                       max_pages, **kw):
    jcfg, tcfg, jpq, tpq = model
    jc = js.PagedKVCache(jcfg, n_pages=n_pages, page_size=page_size,
                         max_pages_per_seq=max_pages)
    tc = ts.PagedKVCache(tcfg, n_pages=n_pages, page_size=page_size,
                         max_pages_per_seq=max_pages, device="cpu")
    jb = js.ContinuousBatcher(jpq, jcfg, jc, **kw)
    tb = ts.ContinuousBatcher(tpq, tcfg, tc, **kw)
    jout = jb.run([js.PagedRequest(prompt=p.copy(), max_new=max_new)
                   for p in prompts])
    tout = tb.run([ts.PagedRequest(prompt=p.copy(), max_new=max_new)
                   for p in prompts])
    assert tc.allocator.num_free == tc.n_pages - tc.allocator.reserved
    assert tout == jout
    assert tb.stats == jb.stats
    return tout, tb.stats


def _greedy_oracle(tpq, tcfg, prompt, n):
    seq = list(prompt)
    for _ in range(n):
        logits = tmodel.forward(tpq, tcfg, torch.tensor([seq]))
        seq.append(int(torch.argmax(logits[0, -1, :tcfg.vocab_size])))
    return seq[len(prompt):]


@pytest.mark.parametrize("prefix_cache", [False, True], ids=["off", "on"])
def test_paged_sharing_and_chunked_prefill_match_reference(qwen_packed,
                                                           prefix_cache):
    """A shared 2-page system prefix with ragged tails and one duplicate,
    prefilled one page a chunk (every chunk after the first at a non-zero
    offset; with sharing on the tail starts past the aliased pages)."""
    rng = np.random.default_rng(7)
    psz = 4
    sys_p = rng.integers(0, 512, size=2 * psz).astype(np.int32)
    prompts = [np.concatenate([sys_p, rng.integers(0, 512, size=n).astype(
        np.int32)]) for n in (3, 7, 1, psz)]
    prompts.append(prompts[0].copy())
    outs, stats = _run_both_batchers(
        qwen_packed, prompts, 4, n_pages=40, page_size=psz, max_pages=8,
        max_batch=3, prefill_chunk_pages=1, prefix_cache=prefix_cache)
    assert stats["prefill_chunks"] > stats["prefills"]
    if prefix_cache:
        assert stats["prefill_tokens_saved"] > 0
    _, tcfg, _, tpq = qwen_packed
    for p, out in zip(prompts[:2], outs):
        assert out == _greedy_oracle(tpq, tcfg, p, 4)


def test_paged_preemption_and_readmission_match_reference(qwen_packed):
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 512, size=n).astype(np.int32)
               for n in (6, 8, 11)]
    outs, stats = _run_both_batchers(qwen_packed, prompts, 8, n_pages=7,
                                     page_size=4, max_pages=6, max_batch=3)
    assert stats["evictions"] >= 1
    _, tcfg, _, tpq = qwen_packed
    for p, out in zip(prompts, outs):
        assert out == _greedy_oracle(tpq, tcfg, p, 8)


def test_batched_server_tokens_match_reference(qwen_packed):
    """Left-padded rows (mixed prompt lengths) rotate at the batch's shared
    positions in both packages."""
    jcfg, tcfg, jpq, tpq = qwen_packed
    rng = np.random.default_rng(6)
    reqs = [dict(prompt=rng.integers(0, 512, int(n)).astype(np.int32),
                 max_new=int(m)) for n, m in [(5, 4), (11, 6), (3, 5)]]
    want = JBatchedServer(jpq, jcfg, batch_size=2, max_len=64).generate(
        [JRequest(**r) for r in reqs])
    for flash in (False, True):
        server = tserve.BatchedServer(
            tpq, dataclasses.replace(tcfg, use_flash_decode=flash),
            batch_size=2, max_len=64, device="cpu")
        assert server.generate([tserve.Request(**r) for r in reqs]) == want


def test_paged_step_aliases_return_the_serving_steps():
    cfg = tget_config("qwen3-4b").reduced()
    assert tsteps.make_paged_serve_step(cfg).__qualname__ == \
        "make_paged_decode_step.<locals>.step"
    assert tsteps.make_paged_prefill_chunk_step(cfg).__qualname__ == \
        "make_paged_prefill_step.<locals>.chunk_step"
    assert tsteps.make_page_copy_step(cfg) is ts.paged_cache.copy_page
    pools = {"k": torch.arange(2 * 3 * 2, dtype=torch.float32).reshape(2, 3, 2)}
    out = tsteps.make_page_copy_step(cfg)(pools, 1, 2)
    assert out is pools and torch.equal(pools["k"][:, 2], pools["k"][:, 1])


# ---------------------------------------------------------------------------
# the fused search on a gated model (yi-6b), replayed proposals
# ---------------------------------------------------------------------------

def test_fused_search_replay_matches_reference_on_gated_ffn():
    jcfg, tcfg, jparams, tparams = _pair("yi-6b")
    calib = calibration_tokens(jcfg.vocab_size, n_seqs=2, seq_len=64)
    jqc, tqc = jq.QuantConfig(2, 32), tq.QuantConfig(2, 32)
    not_ffn = lambda p: p[-1] not in ("up", "gate", "down")  # noqa: E731
    jbase = jrtn.map_quantizable(jparams, lambda w, p: jq.fake_quant(w, jqc),
                                 only=not_ffn)
    tbase = trtn.map_quantizable(tparams, lambda w, p: tq.fake_quant(w, tqc),
                                 only=not_ffn)
    steps, seed = 8, 0
    jres = jsearch.run(jparams, jbase, jcfg, jqc, jnp.asarray(calib),
                       jcs.SearchConfig(steps=steps, seed=seed,
                                        fused_kernel=True, log_every=0))
    tres = tsearch.run(tparams, tbase, tcfg, tqc,
                       torch.from_numpy(calib.astype(np.int64)),
                       tcs.SearchConfig(steps=steps, seed=seed,
                                        fused_kernel=True, log_every=0),
                       proposals=JaxReplay(seed))
    th, jh = tres.history, jres.history
    assert len(th) == len(jh) == steps + 1
    np.testing.assert_allclose(th[0][1:4], jh[0][1:4], rtol=1e-5)
    cur = jh[0][1]
    for (ts_, tl, tp, tacc_a, tacc), (js_, jl, jp, jacc_a, jacc) in zip(
            th[1:], jh[1:]):
        assert ts_ == js_
        assert abs(jl - cur) >= 1e-5 * abs(jl), f"step {js_}: near tie"
        np.testing.assert_allclose([tl, tp, tacc_a], [jl, jp, jacc_a],
                                   rtol=1e-5)
        assert tacc == jacc, f"step {js_}: accept flags differ"
        if jacc:
            cur = jl
    assert sum(h[4] for h in th[1:]) > 0, "no move was accepted"
    assert tres.accept_rate == jres.accept_rate
    np.testing.assert_allclose(tres.final_loss, jres.final_loss, rtol=1e-5)
    for a, b in zip(tres.transforms, jres.transforms):
        np.testing.assert_allclose(to_np(a), to_np(b), rtol=0, atol=1e-7)
    # the gate leaves were rebuilt by the fused lane (permuted, requantized)
    assert not torch.equal(tres.params_q["blocks"]["mlp"]["gate"],
                           tbase["blocks"]["mlp"]["gate"])


# ---------------------------------------------------------------------------
# the base methods on internlm2-1.8b
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def internlm_runs():
    jcfg, tcfg, jparams, tparams = _pair("internlm2-1.8b")
    calib = calibration_tokens(jcfg.vocab_size, n_seqs=4, seq_len=64)
    runs = {}
    for m in ("rtn", "gptq", "awq", "omniquant"):
        jr = jquantize_model(jparams, jcfg, jq.QuantConfig(2, 32), method=m,
                             calib_tokens=jnp.asarray(calib))
        tr = tquantize_model(tparams, tcfg, tq.QuantConfig(2, 32), m, calib,
                             device="cpu")
        runs[m] = (jr, tr)
    gptq_base = jgptq_process_dense(jparams, jcfg, jnp.asarray(calib),
                                    jq.QuantConfig(2, 32))
    return jcfg, tcfg, jparams, tparams, calib, runs, gptq_base


@pytest.mark.parametrize("method", ["rtn", "gptq", "awq", "omniquant"])
def test_base_methods_match_reference_on_internlm2(internlm_runs, method):
    jcfg, tcfg, jparams, tparams, calib, runs, gptq_base = internlm_runs
    jr, tr = runs[method]
    assert tr.method == jr.method == method
    paths = jmodel.quantizable_paths(jparams)
    assert sorted(p[-1] for p in paths) == sorted(
        ["wq", "wk", "wv", "wo", "up", "gate", "down"])
    for path in paths:
        got = to_np(trtn.get_by_path(tr.params_q, path))
        want = to_np(jrtn.get_by_path(jr.params_q, path))
        if method == "gptq":
            assert_parts_only_at_ties(got, want,
                                      jrtn.get_by_path(gptq_base, path), 2,
                                      32, f"gptq {path}")
        elif method != "omniquant" or path[-1] not in ("up", "down"):
            _, scale = _grid_position(want, 2, 32)
            assert_gptq_close(got, want, scale, f"{method} {path}")
    for key in ("ln1", "ln2"):     # norms pass through untouched
        np.testing.assert_array_equal(
            to_np(tr.params_q["blocks"][key]["w"]),
            to_np(jr.params_q["blocks"][key]["w"]))
    if method != "omniquant":
        return
    # OmniQuant's optimised up / down: the block losses over 10 steps
    # (test_torch_baselines.py::test_optimize_block_losses_match_reference)
    qc = (jq.QuantConfig(2, 32), tq.QuantConfig(2, 32))
    _, jl = jomni_process(jparams, jcfg, jnp.asarray(calib), qc[0], steps=10)
    _, tl = tomni_process(tparams, tcfg, torch.from_numpy(
        calib.astype(np.int64)), qc[1], steps=10)
    np.testing.assert_allclose(to_np(tl), np.asarray(jl), rtol=1e-3)
    # ... and the calibration CE after 200 steps, within the reference's own
    # spread under one-ulp changes of its input weights
    # (test_torch_baselines.py::test_trained_tiny_ordering_and_ce_match_reference)
    ce_j = float(jcalib_ce(jmodel.forward(jr.params_q, jcfg,
                                          jnp.asarray(calib)),
                           jnp.asarray(calib), jcfg.vocab_size))
    ttoks = torch.from_numpy(calib.astype(np.int64))
    ce_t = float(tcalib_ce(tmodel.forward(tr.params_q, tcfg, ttoks), ttoks,
                           tcfg.vocab_size))
    bar = max(1e-3 * ce_j, 2 * _reference_ulp_spread(
        "omniquant", jparams, jcfg, jnp.asarray(calib)))
    assert abs(ce_t - ce_j) <= bar, (ce_t, ce_j, bar)


# ---------------------------------------------------------------------------
# one train step on command-r-35b (LayerNorm, no biases, RoPE at 8e6)
# ---------------------------------------------------------------------------

def test_train_step_matches_reference_on_command_r():
    jcfg, tcfg, jp, tp = _pair("command-r-35b")
    assert jcfg.norm == "layernorm" and not jcfg.use_bias
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size,
                                               (4, 32)).astype(np.int32)
    jo = dict(lr=1e-3, total_steps=10, warmup_steps=2)
    jnew, _, jm = jax.jit(jmake_train_step(jcfg, ja.AdamWConfig(**jo)))(
        jp, ja.adamw_init(jp), {"tokens": jnp.asarray(tokens)})
    tnew, tst, tm = tsteps.make_train_step(tcfg, ta.AdamWConfig(**jo))(
        tp, ta.adamw_init(tp), {"tokens": torch.from_numpy(tokens)})
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    jflat = _flat(jax.tree.map(np.asarray, jnew))
    tflat = _flat(tnew)
    assert sorted(tflat) == sorted(jflat)
    for path, j in jflat.items():
        np.testing.assert_allclose(to_np(tflat[path]), j, rtol=0, atol=1e-5,
                                   err_msg="/".join(path))
    assert int(tst["step"]) == 1
