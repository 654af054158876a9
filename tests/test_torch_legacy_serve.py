"""Port parity: the contiguous-cache serving path — ``models.model``'s
``init_cache`` / ``prefill`` / ``decode_step``, ``launch.steps`` and the
fixed-slot ``BatchedServer`` (``serve --legacy``) — vs the JAX reference,
from the same converted packed params.

- prefill and decode-step logits within rtol = atol = 1e-4 and caches within
  1e-5, with ``use_flash_decode`` off and on; the decode index is a Python
  int, so the reference takes its Pallas flash-decode kernel (interpret
  mode) where the flag is on;
- greedy ``BatchedServer`` tokens equal the reference's on
  ``tests/test_serve.py``'s ``served`` config and on GQA 4/2 with an int8
  KV cache, flag off and on. The reference's server jits its step with a
  traced index, so it always takes blocked attention; the port's eager
  step takes the flash route whenever the flag is set.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.kernels as tkernels
from helpers.torch_parity import one_torch_thread, to_np  # noqa: F401
from repro.configs import get_config as jget_config
from repro.core.quant import QuantConfig as JQuantConfig
from repro.launch.serve import BatchedServer as JBatchedServer
from repro.launch.serve import Request as JRequest
from repro.models import init_params as jinit_params
from repro.models import model as jmodel
from repro.quantized.qmodel import pack_model as jpack_model
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import params_from_numpy
from repro_torch.launch import serve as tserve
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import model as tmodel

pytestmark = pytest.mark.usefixtures("one_torch_thread")
SERVED = dict(n_layers=2, d_model=64, d_ff=128, vocab_size=256, n_heads=4)
CONFIGS = {"served": (4, "compute"), "gqa-int8": (2, "int8")}


def _pair(n_kv, kv_dtype):
    kw = {**SERVED, "n_kv_heads": n_kv}
    jcfg = dataclasses.replace(jget_config("opt-tiny").reduced(**kw),
                               kv_cache_dtype=kv_dtype)
    tcfg = dataclasses.replace(tget_config("opt-tiny").reduced(**kw),
                               kv_cache_dtype=kv_dtype)
    jpq = jpack_model(jinit_params(jax.random.PRNGKey(0), jcfg),
                      JQuantConfig(bits=2, group_size=32))
    tpq = params_from_numpy(jax.tree.map(np.asarray, jpq), "cpu")
    return jcfg, tcfg, jpq, tpq


@pytest.fixture(scope="module", params=list(CONFIGS))
def packed(request):
    return _pair(*CONFIGS[request.param])


def _flag(cfg, on):
    return dataclasses.replace(cfg, use_flash_decode=on)


def _close(got, want, tol):
    np.testing.assert_allclose(to_np(got).astype(np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("flash", [False, True], ids=["blocked", "flash"])
def test_prefill_and_decode_steps_match_reference(packed, flash):
    jcfg, tcfg, jpq, tpq = packed
    jcfg, tcfg = _flag(jcfg, flash), _flag(tcfg, flash)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, jcfg.vocab_size, (3, 9)).astype(np.int32)
    max_len = 64
    jl, jc = jmodel.prefill(jpq, jcfg, jnp.asarray(toks), max_len)
    tl, tc = tmodel.prefill(tpq, tcfg, torch.from_numpy(toks.astype(np.int64)),
                            max_len)
    _close(tl, jl, 1e-4)
    for key in jc:
        _close(tc[key], jc[key], 1e-5)
    nxt = rng.integers(0, jcfg.vocab_size, (2, 3, 1)).astype(np.int32)
    for step, tok in enumerate(nxt):
        index = 9 + step                   # a Python int: concrete in JAX
        jl, jc = jmodel.decode_step(jpq, jcfg, jnp.asarray(tok), jc, index)
        tl, tc2 = tmodel.decode_step(tpq, tcfg,
                                     torch.from_numpy(tok.astype(np.int64)),
                                     tc, index)
        assert tc2 is tc                   # written in place
        _close(tl, jl, 1e-4)
        for key in jc:
            _close(tc[key], jc[key], 1e-5)


def test_init_cache_layout_matches_reference(packed):
    jcfg, tcfg, _, _ = packed
    jc = jmodel.init_cache(jcfg, 3, 32)
    tc = tmodel.init_cache(tcfg, 3, 32, device="cpu")
    assert sorted(tc) == sorted(jc)
    for key, j in jc.items():
        assert tuple(tc[key].shape) == j.shape
        assert str(tc[key].dtype).endswith(str(j.dtype)) and not tc[key].any()


def test_serve_and_prefill_steps_match_reference_steps(packed):
    """``make_serve_step`` / ``make_prefill_step`` against the reference's
    builders: greedy tokens equal, the prefill's last logits close."""
    from repro.launch.steps import make_prefill_step as jmake_prefill
    from repro.launch.steps import make_serve_step as jmake_serve
    jcfg, tcfg, jpq, tpq = packed
    toks = np.random.default_rng(5).integers(0, 256, (2, 7)).astype(np.int32)
    jl, jc = jmake_prefill(jcfg, 32)(jpq, {"tokens": jnp.asarray(toks)})
    tl, tc = make_prefill_step(tcfg, 32)(
        tpq, {"tokens": torch.from_numpy(toks.astype(np.int64))})
    assert tuple(tl.shape) == jl.shape
    _close(tl, jl, 1e-4)
    jtok = jnp.argmax(jl[:, -1, :jcfg.vocab_size], -1).astype(jnp.int32)[:, None]
    ttok = torch.argmax(tl[:, -1, :tcfg.vocab_size], -1)[:, None]
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    for index in (7, 8):
        jtok, jc = jmake_serve(jcfg)(jpq, jtok, jc, index)
        ttok, tc = make_serve_step(tcfg)(tpq, ttok, tc, index)
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))


def _requests(vocab, seed=6):
    """Mixed prompt lengths (left padding matters) and max_new; five
    requests over batch 3, so the last batch is padded with copies."""
    rng = np.random.default_rng(seed)
    return [dict(prompt=rng.integers(0, vocab, int(n)).astype(np.int32),
                 max_new=int(m))
            for n, m in [(5, 4), (11, 6), (3, 5), (8, 3), (6, 6)]]


@pytest.fixture(scope="module")
def reference_tokens(packed):
    jcfg, _, jpq, _ = packed
    server = JBatchedServer(jpq, jcfg, batch_size=3, max_len=64)
    return server.generate([JRequest(**r) for r in _requests(256)])


@pytest.mark.parametrize("flash", [False, True], ids=["blocked", "flash"])
def test_batched_server_tokens_match_reference(packed, reference_tokens,
                                               flash, monkeypatch):
    _, tcfg, _, tpq = packed
    calls = []
    real = tkernels.flash_decode
    monkeypatch.setattr(tkernels, "flash_decode",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    server = tserve.BatchedServer(tpq, _flag(tcfg, flash), batch_size=3,
                                  max_len=64, device="cpu")
    outs = server.generate([tserve.Request(**r) for r in _requests(256)])
    assert outs == reference_tokens
    # every decode step of every layer took the flash route when set:
    # batches of max_new 6 and 6 -> (5 + 5) steps x 2 layers
    assert len(calls) == (2 * (6 - 1) * tcfg.n_layers if flash else 0)


def test_batched_server_consistency_and_greedy_chain():
    """Batching does not change per-request outputs (same prompt lengths;
    ``tests/test_serve.py``), and a single request is the argmax chain of
    repeated full forwards."""
    _, tcfg, _, tpq = _pair(4, "compute")
    rng = np.random.default_rng(1)
    reqs = [tserve.Request(prompt=rng.integers(0, 256, 6).astype(np.int32),
                           max_new=4) for _ in range(3)]
    single = tserve.BatchedServer(tpq, tcfg, batch_size=1, max_len=64,
                                  device="cpu")
    batched = tserve.BatchedServer(tpq, _flag(tcfg, True), batch_size=3,
                                   max_len=64, device="cpu")
    outs_1 = [single.generate([r])[0] for r in reqs]
    assert outs_1 == batched.generate(reqs)
    seq = list(reqs[0].prompt)
    for _ in range(4):
        logits = tmodel.forward(tpq, tcfg, torch.tensor([seq]))
        seq.append(int(torch.argmax(logits[0, -1, :tcfg.vocab_size])))
    assert outs_1[0] == seq[-4:]


def test_legacy_cli_serves_on_the_cpu(capsys):
    outs = tserve.main(["--legacy", "--requests", "3", "--batch", "2",
                        "--max-new", "3", "--max-len", "96",
                        "--metrics-out", ""], device="cpu")
    assert [len(o) for o in outs] == [3, 3, 3]
    assert all(0 <= t < 512 for o in outs for t in o)
    text = capsys.readouterr().out
    assert "3 requests, 9 tokens" in text and "batcher stats" not in text
