"""End-to-end system test on the port — the counterpart of
``tests/test_system.py``: the paper's central claim on a model that the
port itself trains (``repro_torch.launch.train.train``, 120 steps of the
reference's ``trained_tiny`` recipe on the synthetic corpus, from a torch
generator's init): 2-bit RTN wrecks held-out perplexity, InvarExplore
recovers part of it, and stacks on AWQ without regressing it."""
import math

import numpy as np
import pytest
import torch

from helpers.torch_parity import one_torch_thread  # noqa: F401
from repro_torch.configs import get_config
from repro_torch.core.objective import calib_ce
from repro_torch.core.pipeline import quantize_model
from repro_torch.core.quant import QuantConfig
from repro_torch.core.search import SearchConfig
from repro_torch.data.calib import calibration_tokens
from repro_torch.data.pipeline import DataConfig, make_pipeline
from repro_torch.launch.train import train
from repro_torch.models.model import forward

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def port_trained(tiny_cfg):
    cfg = get_config("opt-tiny").reduced(
        n_layers=tiny_cfg.n_layers, d_model=tiny_cfg.d_model, d_ff=tiny_cfg.d_ff,
        vocab_size=tiny_cfg.vocab_size, n_heads=tiny_cfg.n_heads,
        n_kv_heads=tiny_cfg.n_kv_heads, max_seq_len=tiny_cfg.max_seq_len)
    params, losses, cfg = train(steps=120, batch=8, seq=128, lr=1e-3, cfg=cfg,
                                log_every=1000, device="cpu")
    assert losses[-1] < losses[0] - 0.5, "training must reduce loss"
    calib = calibration_tokens(cfg.vocab_size, n_seqs=4, seq_len=128)
    held = make_pipeline(DataConfig(seq_len=128, global_batch=8, seed=4242,
                                    vocab_size=cfg.vocab_size))(0)
    return params, cfg, calib, torch.from_numpy(held.astype(np.int64))


def _ppl(params, cfg, tokens):
    return math.exp(float(calib_ce(forward(params, cfg, tokens), tokens,
                                   cfg.vocab_size)))


def test_invarexplore_improves_over_rtn(port_trained):
    params, cfg, calib, held = port_trained
    qcfg = QuantConfig(bits=2, group_size=32)
    ppl_fp = _ppl(params, cfg, held)
    r_rtn = quantize_model(params, cfg, qcfg, method="rtn", device="cpu")
    ppl_rtn = _ppl(r_rtn.params_q, cfg, held)
    assert ppl_rtn > ppl_fp * 1.05, "2-bit RTN must degrade a trained model"
    r_ie = quantize_model(params, cfg, qcfg, method="rtn", calib_tokens=calib,
                          search=SearchConfig(steps=200, n_match_layers=2,
                                              log_every=0), device="cpu")
    ppl_ie = _ppl(r_ie.params_q, cfg, held)
    print(f"\nppl fp={ppl_fp:.2f} rtn={ppl_rtn:.2f} rtn+IE={ppl_ie:.2f}")
    assert ppl_ie < ppl_rtn, (
        f"+InvarExplore ({ppl_ie:.2f}) must beat RTN ({ppl_rtn:.2f}) on HELD-OUT data")
    assert r_ie.search.accept_rate > 0.02


def test_invarexplore_stacks_on_awq(port_trained):
    """The paper's add-on property: AWQ+IE <= AWQ on held-out perplexity."""
    params, cfg, calib, held = port_trained
    qcfg = QuantConfig(bits=2, group_size=32)
    r_awq = quantize_model(params, cfg, qcfg, method="awq", calib_tokens=calib,
                           device="cpu")
    ppl_awq = _ppl(r_awq.params_q, cfg, held)
    r_both = quantize_model(params, cfg, qcfg, method="awq", calib_tokens=calib,
                            search=SearchConfig(steps=150, n_match_layers=2,
                                                log_every=0), device="cpu")
    ppl_both = _ppl(r_both.params_q, cfg, held)
    print(f"\nppl awq={ppl_awq:.2f} awq+IE={ppl_both:.2f}")
    assert ppl_both < ppl_awq * 1.02, "search must not regress the base method"
