"""Shared parts of the bf16 parity tests of the MoE, SSM, hybrid,
encoder-decoder and vision families (``tests/test_torch_bf16_ssm*.py``,
``tests/test_torch_bf16_moe_encdec*.py``): the reduced configs in their own
bf16 with ``test_torch_bf16.py::_pair``'s weights on both sides, and the
checks each file runs on them.

- RTN (``quantize_model`` without calibration): every leaf of the port's
  result has the reference's dtype and values, bit for bit.
- The search on an RTN base whose searched leaves stay continuous, with
  the reference's proposals replayed (``MambaAdapter``'s within-head moves
  for a Mamba phase, one key chain per phase of the hybrid run) and the
  port's accept decisions forced to the reference's (``anneal.accept``):
  every searched leaf bf16 (a Mamba block's ``A_log``, ``D`` and
  ``dt_bias`` f32, as in the reference); per-step loss and CE within
  ``test_torch_bf16_search.py``'s ``LOSS_RTOL`` relative of the
  reference's, the activation MSE within its ``MSE_RTOL``; the port's own
  decision (loss < current) equal to the reference's wherever the step's
  |loss - current| exceeds the loss bar.
- The servers on the reference's packed bf16 model (2-bit g32): greedy
  tokens (and the paged batcher's stats) equal to the reference's under
  the same options.
"""
import dataclasses
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import torch

from helpers.torch_parity import to_np
from repro import search as jsearch
from repro.core import quant as jq
from repro.core import rtn as jrtn
from repro.core import search as jcs
from repro.core.pipeline import quantize_model as jquantize_model
from repro.launch.serve import BatchedServer as JBatchedServer
from repro.launch.serve import Request as JRequest
from repro.models import model as jmodel
from repro.quantized.qmodel import pack_model as jpack_model
from repro_torch import search as tsearch
from repro_torch.convert import params_from_numpy
from repro_torch.core import quant as tq
from repro_torch.core import rtn as trtn
from repro_torch.core import search as tcs
from repro_torch.core.pipeline import quantize_model as tquantize_model
from repro_torch.data.calib import calibration_tokens
from repro_torch.launch import serve as tserve
from repro_torch.search import anneal as tanneal
from test_torch_bf16 import _pair
from test_torch_bf16_search import LOSS_RTOL, MSE_RTOL, ForcedAccept
from test_torch_search import JaxReplay
from test_torch_ssm_search_serve import SEARCH_KEYS, replay_sources

STEPS = 6
MOE, MAMBA, ZAMBA = "phi3.5-moe-42b-a6.6b", "mamba2-2.7b", "zamba2-7b"
SEAMLESS, INTERNVL = "seamless-m4t-medium", "internvl2-1b"

# ``_pair`` cached per process (no test writes into its trees)
pair = functools.lru_cache(maxsize=None)(_pair)


def frontend_bf16(cfg, batch, seed=1):
    """{"enc_embeds" (B, 16, D) | "vision_embeds" (B, 8, D)}: the stub
    frontends' shape and dtype (bf16, the compute dtype), scale 0.5, as
    numpy; {} for a text-only stack."""
    if not (cfg.is_enc_dec or cfg.frontend == "vision"):
        return {}
    n = 16 if cfg.is_enc_dec else 8
    x = (0.5 * np.random.default_rng(seed).standard_normal(
        (batch, n, cfg.d_model))).astype(jnp.bfloat16)
    return {"enc_embeds" if cfg.is_enc_dec else "vision_embeds": x}


def jkw(kw, dtype=None):
    return {k: jnp.asarray(v if dtype is None else v.astype(dtype))
            for k, v in kw.items()}


def tkw(kw):
    return {k: params_from_numpy(v, "cpu") for k, v in kw.items()}


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def assert_rtn_equals_reference(arch):
    jcfg, tcfg, jp, tp, _, _ = pair(arch)
    jr = jquantize_model(jp, jcfg, jq.QuantConfig(2, 32))
    tr = tquantize_model(tp, tcfg, tq.QuantConfig(2, 32), device="cpu")
    n = 0
    for path, got in _leaves(tr.params_q):
        want = np.asarray(jrtn.get_by_path(jr.params_q, path))
        assert str(got.dtype).split(".")[-1] == str(want.dtype), path
        np.testing.assert_array_equal(to_np(got), want, err_msg=str(path))
        n += 1
    assert n == len(jax.tree.leaves(jr.params_q))


def _run_quiet(fn):
    """The fused flag on a Mamba adapter warns and runs unfused (both
    packages); the warning is ``test_torch_ssm_search_serve.py``'s."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return fn()


def search_refs(cases):
    """Per (arch, fused) case: the port's inputs and the reference's run
    (its install mode changes no value). The searched leaves
    (``SEARCH_KEYS``) stay continuous, the rest is RTN'd; an
    encoder-decoder stack gets 16 bf16 frames."""
    out, pairs = {}, {}
    for arch, fused in cases:
        if arch not in pairs:
            jcfg, tcfg, jp, tp, _, _ = pair(arch)
            frozen = lambda p: p[-1] not in SEARCH_KEYS  # noqa: E731
            jbase = jrtn.map_quantizable(
                jp, lambda w, p: jq.fake_quant(w, jq.QuantConfig(2, 32)),
                only=frozen)
            tbase = trtn.map_quantizable(
                tp, lambda w, p: tq.fake_quant(w, tq.QuantConfig(2, 32)),
                only=frozen)
            calib = calibration_tokens(jcfg.vocab_size, n_seqs=2, seq_len=32)
            kw = frontend_bf16(jcfg, 2) if jcfg.is_enc_dec else {}
            pairs[arch] = (jcfg, tcfg, jp, tp, jbase, tbase, calib, kw)
        jcfg, tcfg, jp, tp, jbase, tbase, calib, kw = pairs[arch]
        jres = _run_quiet(lambda: jsearch.run(
            jp, jbase, jcfg, jq.QuantConfig(2, 32), jnp.asarray(calib),
            jcs.SearchConfig(steps=STEPS, seed=0, fused_kernel=fused,
                             log_every=0), forward_kwargs=jkw(kw)))
        out[arch, fused] = (jcfg, tcfg, tp, tbase, calib, kw, jres)
    return out


def assert_search_teacher_forced(ref, arch, fused, install, monkeypatch):
    """The port's search (lane ``fused``, ``install``) on the reference's
    proposals and accept decisions, held to the reference's run ``ref``."""
    jcfg, tcfg, tp, tbase, calib, kw, jres = ref
    jh = jres.history
    forced = ForcedAccept(h[4] for h in jh if h[0])
    monkeypatch.setattr(tanneal, "accept", forced)
    source = replay_sources(arch, jcfg, seed=0) if arch in (MAMBA, ZAMBA) \
        else JaxReplay(0)
    tres = _run_quiet(lambda: tsearch.run(
        tp, tbase, tcfg, tq.QuantConfig(2, 32),
        torch.from_numpy(calib.astype(np.int64)),
        tcs.SearchConfig(steps=STEPS, seed=0, fused_kernel=fused,
                         install=install, log_every=0),
        proposals=source, forward_kwargs=tkw(kw)))
    for path in jmodel.quantizable_paths(jres.params_q):
        assert trtn.get_by_path(tres.params_q, path).dtype == torch.bfloat16
    if "ssm" in tres.params_q["blocks"]:
        for k in ("A_log", "D", "dt_bias"):
            assert tres.params_q["blocks"]["ssm"][k].dtype == torch.float32
    th = tres.history
    assert len(th) == len(jh) == STEPS + (2 if arch == ZAMBA else 1)
    assert len(forced.deltas) == STEPS
    deltas, cur = iter(forced.deltas), None
    for (ts_, tl, tp_, ta, tacc), (js_, jl, jp_, ja, jacc) in zip(th, jh):
        assert ts_ == js_ and tacc == jacc
        np.testing.assert_allclose([tl, tp_], [jl, jp_], rtol=LOSS_RTOL,
                                   err_msg=f"step {js_}")
        np.testing.assert_allclose(ta, ja, rtol=MSE_RTOL,
                                   err_msg=f"step {js_}")
        if js_ == 0:                    # a phase's step-0 baseline
            cur = jl
            continue
        delta = next(deltas)
        if abs(jl - cur) > LOSS_RTOL * abs(jl):
            assert (delta < 0.0) == jacc, f"step {js_}: the decision parts"
        if jacc:
            cur = jl
    assert sum(h[4] for h in jh if h[0]) > 0, "no move was accepted"


def packed_bf16(arch):
    """(jcfg, tcfg, the reference's packed bf16 tree, its port copy)."""
    jcfg, tcfg, jp, _, _, _ = pair(arch)
    jpq = jax.jit(lambda p: jpack_model(
        p, jq.QuantConfig(bits=2, group_size=32)))(jp)
    return jcfg, tcfg, jpq, params_from_numpy(jax.tree.map(np.asarray, jpq),
                                              "cpu")


def assert_batched_server_matches(model, flags=(False, True)):
    """``BatchedServer`` (one batch of two requests) greedy tokens equal to
    the reference's, with ``use_flash_decode`` at each of ``flags``."""
    jcfg, tcfg, jpq, tpq = model
    rng = np.random.default_rng(6)
    reqs = [dict(prompt=rng.integers(0, 512, int(n)).astype(np.int32),
                 max_new=int(m)) for n, m in [(5, 4), (11, 6)]]
    want = JBatchedServer(jpq, jcfg, batch_size=2, max_len=64).generate(
        [JRequest(**r) for r in reqs])
    for flash in flags:
        server = tserve.BatchedServer(
            tpq, dataclasses.replace(tcfg, use_flash_decode=flash),
            batch_size=2, max_len=64, device="cpu")
        assert server.generate([tserve.Request(**r) for r in reqs]) == want
