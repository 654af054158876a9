"""bf16 parity of the port on the encoder-decoder (SeamlessM4T) and vision
(InternVL2) families (the reduced configs in their own bf16,
``test_torch_bf16.py::_pair``'s weights on both sides;
``helpers/bf16_families.py`` holds the shared checks and their bars):
- RTN bit for bit, leaf for leaf and dtype for dtype;
- the search teacher-forced to the reference's (shared bars), both install
  modes: SeamlessM4T (the decoder's FFNs with ``b_up``, with
  ``enc_embeds``) on the fused lane; InternVL2 on text (the reference's CE
  search with patches fails, ``test_torch_encdec_vision_search.py``) on
  the unfused lane. The two ``DenseFFNAdapter`` decoders share one
  adapter, so one lane each covers both lanes of it at the families'
  shapes;
- the forward of SeamlessM4T (bf16 ``enc_embeds``: 16 stub frames) and of
  InternVL2 (bf16 ``vision_embeds``: 8 stub patches), logits and every
  block output: ``test_torch_bf16.py``'s dtype bar (2 ulps of the scale
  elementwise, and no farther from the reference's fp32 than 1.25 x the
  reference's bf16); the stub frontends emit the compute dtype;
- SeamlessM4T's serving steps on the reference's packed bf16 model:
  ``make_prefill_step`` with 16 bf16 frames in the batch (the cross cache
  bf16), then greedy ``make_serve_step``, tokens equal to the reference's
  with ``use_flash_decode`` off and on (the paged steps and
  ``BatchedServer`` refuse the stack, in both packages). InternVL2's
  servers are in ``test_torch_bf16_moe_encdec_serve.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers.bf16_families import (INTERNVL, SEAMLESS, assert_rtn_equals_reference,
                                   assert_search_teacher_forced, frontend_bf16, jkw,
                                   packed_bf16, pair, search_refs, tkw)
from helpers.torch_parity import one_torch_thread  # noqa: F401
from repro.launch import steps as jsteps
from repro.models import model as jmodel
from repro_torch.data.calib import calibration_tokens
from repro_torch.launch import steps as tsteps
from repro_torch.models import frontends as tfrontends
from repro_torch.models import model as tmodel
from test_torch_bf16 import assert_bf16_close

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("arch", [SEAMLESS, INTERNVL],
                         ids=["seamless", "internvl2"])
def test_rtn_bf16_equals_reference(arch):
    assert_rtn_equals_reference(arch)


CASES = [(SEAMLESS, True), (INTERNVL, False)]


@pytest.fixture(scope="module")
def refs():
    return search_refs(CASES)


@pytest.mark.parametrize("install", ["unit", "stack"])
@pytest.mark.parametrize("arch,fused", CASES, ids=["seamless-fused",
                                                   "internvl2-unfused"])
def test_search_bf16_teacher_forced_to_reference(refs, arch, fused, install,
                                                 monkeypatch):
    assert_search_teacher_forced(refs[arch, fused], arch, fused, install,
                                 monkeypatch)


@pytest.mark.parametrize("arch", [SEAMLESS, INTERNVL],
                         ids=["seamless", "internvl2"])
def test_frontend_forward_bf16_within_the_dtype_bar(arch):
    jcfg, tcfg, jp, tp, jp32, jcfg32 = pair(arch)
    gen = torch.Generator().manual_seed(0)
    stub = (tfrontends.stub_audio_frames(gen, tcfg, 2, 4, device="cpu")
            if tcfg.is_enc_dec else
            tfrontends.stub_vision_embeds(gen, tcfg, 2, 4, device="cpu"))
    assert stub.dtype == torch.bfloat16
    tokens = calibration_tokens(jcfg.vocab_size, n_seqs=2, seq_len=64)
    kw = frontend_bf16(jcfg, 2)
    jl, jh = jmodel.forward(jp, jcfg, jnp.asarray(tokens), collect_hidden=True,
                            **jkw(kw))
    l32, h32 = jmodel.forward(jp32, jcfg32, jnp.asarray(tokens),
                              collect_hidden=True, **jkw(kw, np.float32))
    tl, th = tmodel.forward(tp, tcfg, torch.from_numpy(
        tokens.astype(np.int64)), collect_hidden=True, **tkw(kw))
    assert tl.dtype == th.dtype == torch.bfloat16
    assert_bf16_close(tl, jl, l32, f"{arch} logits")
    for i in range(th.shape[0]):
        assert_bf16_close(th[i], jh[i], h32[i], f"{arch} block {i}")


def test_encdec_serving_steps_bf16_match_reference():
    jcfg, tcfg, jpq, tpq = packed_bf16(SEAMLESS)
    toks = np.random.default_rng(3).integers(0, jcfg.vocab_size,
                                             (2, 6)).astype(np.int32)
    kw = frontend_bf16(jcfg, 2)

    def run(prefill, serve, params, cfg, batch):
        last, cache = prefill(params, batch)
        out = [last[:, -1, :cfg.vocab_size].argmax(-1)[:, None]]
        for t in range(4):
            nxt, cache = serve(params, out[-1], cache, 6 + t)
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
