"""Port parity on the encoder-decoder and vision families, continued: the
serving steps (``make_prefill_step`` / ``make_serve_step`` over the cross
cache and after a vision prefix), both servers, their refusals, and the
serve and search CLIs with ``--arch seamless-m4t-medium`` /
``internvl2-1b``.

Configs, weights and frontend inputs as in
``tests/test_torch_encdec_vision.py``; packed weights are the reference's
``pack_model`` output carried across, so both sides serve the same codes.
The reference's semantics (finding 4): the paged steps and both servers
refuse an encoder-decoder stack, which is served through
``make_prefill_step`` + ``make_serve_step``; InternVL2 is served on text
by both servers. Bar: greedy tokens (and batcher stats) identical.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers.torch_parity import one_torch_thread  # noqa: F401
from repro import serving as js
from repro.core import quant as jq
from repro.launch import steps as jsteps
from repro.launch.serve import BatchedServer as JBatchedServer
from repro.launch.serve import PagedServer as JPagedServer
from repro.launch.serve import Request as JRequest
from repro.quantized.qmodel import pack_model as jpack_model
from repro_torch import serving as ts
from repro_torch.configs import list_archs as tlist_archs
from repro_torch.convert import params_from_numpy
from repro_torch.launch import search as tsearch_cli
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from test_torch_encdec_vision import (ARCHS, IDS, INTERNVL, SEAMLESS,
                                      frontend_inputs, jkw, pair, tkw)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=ARCHS, ids=IDS)
def packed(request):
    jcfg, tcfg, jparams, _ = pair(request.param)
    return (jcfg, tcfg) + _packed_pair(jparams)


def _packed_pair(jparams):
    """The reference's packed tree (jitted pack) and its port copy: both
    sides serve the same codes."""
    jpq = jax.jit(lambda p: jpack_model(
        p, jq.QuantConfig(bits=2, group_size=32)))(jparams)
    return jpq, params_from_numpy(jax.tree.map(np.asarray, jpq), "cpu")


def test_pack_model_packs_the_encoder_and_cross_attention(packed):
    """The port's own ``pack_model`` packs every quantizable leaf — the
    encoder's and the cross-attention's included — to the reference's
    codes; a tied tree has no head to pack."""
    from repro_torch.core.quant import QTensor, QuantConfig
    from repro_torch.models.model import quantizable_paths
    from repro_torch.quantized.qmodel import pack_model

    jcfg, tcfg, jpq, tpq = packed
    _, _, _, tparams = pair(jcfg.name)
    own = pack_model(tparams, QuantConfig(bits=2, group_size=32))

    def flat(tree, prefix=()):
        if isinstance(tree, dict):
            return {k: v for key, sub in tree.items()
                    for k, v in flat(sub, prefix + (key,)).items()}
        return {prefix: tree}

    mine, theirs = flat(own), flat(tpq)
    packed_paths = {p for p, v in mine.items() if isinstance(v, QTensor)}
    assert packed_paths == {tuple(p) for p in quantizable_paths(tparams)}
    if tcfg.is_enc_dec:
        assert {("enc_blocks", "mlp", "up"), ("blocks", "xattn", "wv")} \
            <= packed_paths
    else:
        assert "lm_head" not in own
    for p in packed_paths:
        assert torch.equal(mine[p].packed, theirs[p].packed), p


def test_prefill_and_serve_steps_match_reference(packed):
    """``make_prefill_step`` with the frontend input in the batch, then
    greedy ``make_serve_step`` over the cache (the cross K/V for the
    enc-dec stack; positions from P+S after the patches): tokens equal to
    the reference's, with ``use_flash_decode`` off and on."""
    jcfg, tcfg, jpq, tpq = packed
    toks = np.random.default_rng(3).integers(0, jcfg.vocab_size,
                                             (2, 6)).astype(np.int32)
    kw = frontend_inputs(jcfg, 2)
    P = 8 if "vision_embeds" in kw else 0
    steps = 4

    def run(prefill, serve, params, cfg, batch):
        last, cache = prefill(params, batch)
        out = [last[:, -1, :cfg.vocab_size].argmax(-1)[:, None]]
        for t in range(steps):
            nxt, cache = serve(params, out[-1], cache, P + 6 + t)
            out.append(nxt)
        return np.concatenate([np.asarray(o) for o in out], axis=1)

    want = run(jax.jit(jsteps.make_prefill_step(jcfg, 32)),
               jax.jit(jsteps.make_serve_step(jcfg)), jpq, jcfg,
               {"tokens": jnp.asarray(toks), **jkw(kw)})
    for flash in (False, True):
        cfg = dataclasses.replace(tcfg, use_flash_decode=flash)
        got = run(tsteps.make_prefill_step(cfg, 32),
                  tsteps.make_serve_step(cfg), tpq, cfg,
                  {"tokens": torch.from_numpy(toks.astype(np.int64)),
                   **tkw(kw)})
        np.testing.assert_array_equal(got, want)


def test_paged_server_serves_internvl_text_as_the_reference():
    """Continuous batching on InternVL2's text: greedy tokens and stats
    equal to the reference's batcher, with sharing off and on."""
    jcfg, tcfg, jparams, _ = pair(INTERNVL)
    jpq, tpq = _packed_pair(jparams)
    rng = np.random.default_rng(7)
    sys_p = rng.integers(0, 512, size=8).astype(np.int32)
    prompts = [np.concatenate([sys_p, rng.integers(0, 512, size=n).astype(
        np.int32)]) for n in (3, 7, 1)]
    for prefix_cache in (False, True):
        kw = dict(max_batch=3, prefill_chunk_pages=1,
                  prefix_cache=prefix_cache)
        jc = js.PagedKVCache(jcfg, n_pages=32, page_size=4,
                             max_pages_per_seq=8)
        tc = ts.PagedKVCache(tcfg, n_pages=32, page_size=4,
                             max_pages_per_seq=8, device="cpu")
        jb = js.ContinuousBatcher(jpq, jcfg, jc, **kw)
        tb = ts.ContinuousBatcher(tpq, tcfg, tc, **kw)
        want = jb.run([js.PagedRequest(prompt=p.copy(), max_new=4)
                       for p in prompts])
        got = tb.run([ts.PagedRequest(prompt=p.copy(), max_new=4)
                      for p in prompts])
        assert got == want and tb.stats == jb.stats


def test_batched_server_serves_internvl_text_as_the_reference():
    jcfg, tcfg, jparams, _ = pair(INTERNVL)
    jpq, tpq = _packed_pair(jparams)
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


def test_servers_refuse_the_encdec_stack():
    """Finding 4: the paged steps raise ValueError in both packages, and so
    does each PagedServer; the reference's BatchedServer fails at its
    prefill (no encoder input), the port's raises ValueError naming the
    steps that serve the stack."""
    jcfg, tcfg, jparams, tparams = pair(SEAMLESS)
    from repro.serving import decode as jdec
    from repro.serving import prefill as jpre
    from repro_torch.serving import decode as tdec
    from repro_torch.serving import prefill as tpre
    for mod, cfg in ((jdec, jcfg), (tdec, tcfg)):
        with pytest.raises(ValueError, match="cross-attention"):
            mod.make_paged_decode_step(cfg)
    for mod, cfg in ((jpre, jcfg), (tpre, tcfg)):
        with pytest.raises(ValueError, match="cross-attention"):
            mod.make_paged_prefill_step(cfg)
    with pytest.raises(ValueError, match="cross-attention"):
        JPagedServer(jparams, jcfg)
    with pytest.raises(ValueError, match="cross-attention"):
        tserve.PagedServer(tparams, tcfg, device="cpu")
    with pytest.raises(AttributeError):
        JBatchedServer(jparams, jcfg, batch_size=1, max_len=32).generate(
            [JRequest(prompt=np.arange(4, dtype=np.int32), max_new=2)])
    with pytest.raises(ValueError, match="make_prefill_step"):
        tserve.BatchedServer(tparams, tcfg, batch_size=1, max_len=32,
                             device="cpu")


@pytest.mark.parametrize("arch", ARCHS, ids=IDS)
def test_cli_entry_points_on_both_archs(arch, tmp_path):
    """The serve and search CLIs with ``--arch``: InternVL2 runs on text
    (paged and fixed-slot serving, the search); Seamless, whose CLI runs
    carry no encoder input, raises ValueError (the reference fails there
    too)."""
    assert arch in tlist_archs()
    out = tmp_path / "bench.json"
    search = ["--arch", arch, "--steps", "2", "--population", "1", "--seqs",
              "2", "--seq-len", "16", "--out", str(out), "--metrics-out", ""]
    serve = ["--arch", arch, "--requests", "2", "--max-new", "2",
             "--metrics-out", ""]
    if arch == SEAMLESS:
        with pytest.raises(ValueError, match="enc_embeds"):
            tsearch_cli.main(search, device="cpu")
        for extra in ([], ["--legacy"]):
            with pytest.raises(ValueError):
                tserve.main(serve + extra, device="cpu")
        return
    assert tsearch_cli.main(search, device="cpu") == 0
    assert arch in out.read_text()
    for extra in ([], ["--legacy"]):
        outs = tserve.main(serve + extra, device="cpu")
        assert len(outs) == 2 and all(len(o) == 2 for o in outs)


