"""Quickstart: quantize a model to 2 bits with InvarExplore in ~30 lines.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.core.objective import calib_ce
from repro_torch.core.pipeline import quantize_model
from repro_torch.core.quant import QuantConfig
from repro_torch.core.search import SearchConfig
from repro_torch.data.calib import calibration_tensor
from repro_torch.device import resolve_device
from repro_torch.models.model import forward, init_params


def main(argv=None):
    """Returns the ``PTQResult``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default; raises without a card) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # 1. a model (here: random-init tiny OPT; swap in your own params tree)
    cfg = get_config("opt-tiny").reduced(n_layers=2, d_model=64, d_ff=128,
                                         vocab_size=256, n_heads=4,
                                         n_kv_heads=4)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)

    # 2. a small calibration set (paper: 32 x 512 tokens from the Pile)
    calib = calibration_tensor(cfg.vocab_size, n_seqs=4, seq_len=128,
                               device=dev)

    # 3. ultra-low-bit PTQ: AWQ base + InvarExplore discrete search on top
    qcfg = QuantConfig(bits=2, group_size=32)
    result = quantize_model(
        params, cfg, qcfg,
        method="awq",                           # rtn | gptq | awq | omniquant
        calib_tokens=calib,
        search=SearchConfig(steps=150, n_match_layers=2, log_every=50),
        device=dev,
    )

    ce_fp = float(calib_ce(forward(params, cfg, calib), calib,
                           cfg.vocab_size))
    ce_q = float(calib_ce(forward(result.params_q, cfg, calib), calib,
                          cfg.vocab_size))
    print(f"\nmethod={result.method}")
    print(f"calib CE: fp32={ce_fp:.4f}  2-bit={ce_q:.4f}")
    print(f"search: {result.search.initial_loss:.4f} -> "
          f"{result.search.final_loss:.4f} "
          f"(accept rate {result.search.accept_rate:.1%})")
    return result


if __name__ == "__main__":
    main()
