"""bf16 parity of the port's base methods and search on the dense zoo
configs in their own dtype (the reduced configs in bf16, the reference's
bf16 weights on both sides; ``test_torch_bf16.py`` says where the two round
and why).

Bars:
- RTN equal bit for bit; AWQ: every leaf bf16 and equal to the reference's
  leaf rounded to bf16 (the reference's AWQ returns a bf16 model's
  processed weights in f32, its searches promoting them by the f32 scales
  and clip ratios; the port fake-quantises them in f32 and rounds once to
  the config's dtype), except on < 0.1 % of a leaf's elements, each within
  one quantization step: the f32 fake-quant bar of the fp32 pipeline
  (``assert_within_one_step``), whose f32 scales part by an ulp from the
  reference's and so may flip a round-half boundary (measured: 5 of
  77,824 elements, on wv and gate);
- the search, both lanes and both install modes, with the reference's
  proposals replayed and the port's accept decisions forced to the
  reference's (``anneal.accept``): every leaf bf16; per-step loss and CE
  within ``LOSS_RTOL`` relative of the reference's, the activation MSE
  within ``MSE_RTOL`` (it measures the gap between block outputs that
  agree to bf16 ulps and the FP taps, ~0.1 of their scale, so the
  forward's ulps weigh ~10x more in it; measured up to 1.8e-3 on yi-6b,
  the loss 3.2e-4); the port's own decision (loss < current) equal to the
  reference's wherever the step's |loss - current| exceeds the loss bar.
  The search fails on the tree before this file (the first fault: the
  candidate reached ``forward`` in f32 against a bf16 stack, a matmul
  dtype error).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers.torch_parity import one_torch_thread, to_np  # noqa: F401
from repro import search as jsearch
from repro.core import quant as jq
from repro.core import rtn as jrtn
from repro.core import search as jcs
from repro.core.pipeline import quantize_model as jquantize_model
from repro.models import model as jmodel
from repro_torch import search as tsearch
from repro_torch.core import quant as tq
from repro_torch.core import rtn as trtn
from repro_torch.core import search as tcs
from repro_torch.core.pipeline import quantize_model as tquantize_model
from repro_torch.data.calib import calibration_tokens
from repro_torch.search import anneal as tanneal
from test_torch_bf16 import _pair
from test_torch_search import JaxReplay

pytestmark = pytest.mark.usefixtures("one_torch_thread")

LOSS_RTOL = 1e-3      # search loss and CE, relative
MSE_RTOL = 1e-2       # search activation MSE, relative
STEPS = 8


# ---------------------------------------------------------------------------
# RTN and AWQ
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def qwen_methods():
    jcfg, tcfg, jp, tp, _, _ = _pair("qwen3-4b")
    calib = calibration_tokens(jcfg.vocab_size, n_seqs=4, seq_len=64)
    qc = (jq.QuantConfig(2, 32), tq.QuantConfig(2, 32))
    runs = {m: (jquantize_model(jp, jcfg, qc[0], method=m,
                                calib_tokens=jnp.asarray(calib)),
                tquantize_model(tp, tcfg, qc[1], m, calib, device="cpu"))
            for m in ("rtn", "awq")}
    return runs, tcfg, tp, calib


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def assert_reference_rounded(got, want, quantized, what):
    """``got`` (bf16) equal to the reference's leaf ``want`` rounded to bf16;
    on a fake-quant leaf (``quantized``) of f32 ``want``, except on < 0.1 %
    of its elements, each within one step of the reference's (L, K, N)
    groups of 32 (module docstring)."""
    assert got.dtype == torch.bfloat16, what
    got = to_np(got)
    w32 = np.asarray(want).astype(np.float32)
    off = got != to_np(want.astype(jnp.bfloat16))
    if not (quantized and want.dtype == jnp.float32):
        assert not off.any(), what
        return
    L, K, N = w32.shape
    g = w32.reshape(L, K // 32, 32, N)
    step = np.broadcast_to((g.max(2, keepdims=True) - g.min(2, keepdims=True))
                           / 3, g.shape).reshape(L, K, N)
    assert float(np.mean(off)) < 1e-3, f"{what}: {off.sum()} elements off"
    assert np.all(np.abs(got - w32)[off] <= step[off] * 1.001 + 1e-6), (
        f"{what}: an element differs by more than one step")


def assert_matches_reference_rounded(params_q, jparams_q):
    """Every leaf of the port's result against the reference's, rounded to
    bf16 (``assert_reference_rounded``); returns how many of the
    reference's leaves are f32."""
    quantized = set(jmodel.quantizable_paths(jparams_q))
    n_f32 = 0
    for path, got in _leaves(params_q):
        want = jrtn.get_by_path(jparams_q, path)
        n_f32 += want.dtype == jnp.float32
        assert_reference_rounded(got, want, path in quantized, str(path))
    return n_f32


@pytest.mark.parametrize("method", ["rtn", "awq"])
def test_base_methods_bf16_match_reference(qwen_methods, method):
    jr, tr = qwen_methods[0][method]
    n_f32 = assert_matches_reference_rounded(tr.params_q, jr.params_q)
    # the reference's AWQ leaves come back f32 (module docstring)
    assert (n_f32 > 0) == (method == "awq")


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_awq_search_bf16_starts_from_the_reference_awq(qwen_methods, fused,
                                                       monkeypatch):
    """AWQ + the search on a bf16 model: the search's base is AWQ's f32
    output, its stack and candidates are bf16. With every move rejected the
    result is the starting point, which is the reference's AWQ result
    rounded to bf16, leaf for leaf, at the AWQ bar (module docstring)."""
    runs, tcfg, tp, calib = qwen_methods
    jr = runs["awq"][0]
    deltas = []
    monkeypatch.setattr(tanneal, "accept",
                        lambda delta, temperature, uniform:
                        deltas.append(delta) and False)
    tr = tquantize_model(tp, tcfg, tq.QuantConfig(2, 32), "awq", calib,
                         tcs.SearchConfig(steps=2, seed=0, fused_kernel=fused,
                                          log_every=0), device="cpu")
    assert len(deltas) == 2 and all(np.isfinite(deltas))
    assert tr.search.final_loss == tr.search.initial_loss
    assert_matches_reference_rounded(tr.params_q, jr.params_q)


# ---------------------------------------------------------------------------
# the search
# ---------------------------------------------------------------------------

class ForcedAccept:
    """``anneal.accept`` that returns the reference's decisions in turn and
    records the deltas the port computed."""

    def __init__(self, flags):
        self.flags, self.deltas = list(flags), []

    def __call__(self, delta, temperature, uniform):
        self.deltas.append(delta)
        return self.flags[len(self.deltas) - 1]


@pytest.fixture(scope="module")
def search_refs():
    """Per (arch, fused): the pair, the calibration set, the RTN'd bases and
    the reference's run (its install mode changes no value)."""
    out = {}
    for arch in ("qwen3-4b", "yi-6b"):
        jcfg, tcfg, jp, tp, _, _ = _pair(arch)
        calib = calibration_tokens(jcfg.vocab_size, n_seqs=2, seq_len=64)
        not_ffn = lambda p: p[-1] not in ("up", "gate", "down")  # noqa: E731
        jbase = jrtn.map_quantizable(
            jp, lambda w, p: jq.fake_quant(w, jq.QuantConfig(2, 32)),
            only=not_ffn)
        tbase = trtn.map_quantizable(
            tp, lambda w, p: tq.fake_quant(w, tq.QuantConfig(2, 32)),
            only=not_ffn)
        for fused in (False, True):
            jres = jsearch.run(jp, jbase, jcfg, jq.QuantConfig(2, 32),
                               jnp.asarray(calib), jcs.SearchConfig(
                                   steps=STEPS, seed=0, fused_kernel=fused,
                                   log_every=0))
            out[arch, fused] = (tcfg, tp, tbase, calib, jres)
    return out


@pytest.mark.parametrize("install", ["unit", "stack"])
@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("arch", ["qwen3-4b", "yi-6b"])
def test_search_bf16_teacher_forced_to_reference(search_refs, arch, fused,
                                                 install, monkeypatch):
    tcfg, tp, tbase, calib, jres = search_refs[arch, fused]
    jh = jres.history
    forced = ForcedAccept(h[4] for h in jh[1:])
    monkeypatch.setattr(tanneal, "accept", forced)
    tres = tsearch.run(tp, tbase, tcfg, tq.QuantConfig(2, 32),
                       torch.from_numpy(calib.astype(np.int64)),
                       tcs.SearchConfig(steps=STEPS, seed=0,
                                        fused_kernel=fused, install=install,
                                        log_every=0),
                       proposals=JaxReplay(0))
    for path in jmodel.quantizable_paths(jres.params_q):
        assert trtn.get_by_path(tres.params_q, path).dtype == torch.bfloat16
    th = tres.history
    assert len(th) == len(jh) == STEPS + 1 and len(forced.deltas) == STEPS
    cur = jh[0][1]
    for (ts_, tl, tp_, ta, tacc), (js_, jl, jp_, ja, jacc) in zip(th, jh):
        assert ts_ == js_ and tacc == jacc
        np.testing.assert_allclose([tl, tp_], [jl, jp_], rtol=LOSS_RTOL,
                                   err_msg=f"step {js_}")
        np.testing.assert_allclose(ta, ja, rtol=MSE_RTOL,
                                   err_msg=f"step {js_}")
    for (js_, jl, _, _, jacc), delta in zip(jh[1:], forced.deltas):
        if abs(jl - cur) > LOSS_RTOL * abs(jl):
            assert (delta < 0.0) == jacc, f"step {js_}: the decision parts"
        if jacc:
            cur = jl
    assert sum(h[4] for h in jh[1:]) > 0, "no move was accepted"
