"""End-to-end: TRAIN a small LM on the synthetic corpus (with checkpointing
and fault tolerance), then post-training-quantize it and compare RTN vs
RTN+InvarExplore held-out perplexity.

    PYTHONPATH=src python -m repro_torch.examples.train_then_quantize [--steps 300]
"""
from __future__ import annotations

import argparse
import math
import tempfile

import numpy as np
import torch

from repro_torch.core.objective import calib_ce
from repro_torch.core.pipeline import quantize_model
from repro_torch.core.quant import QuantConfig
from repro_torch.core.search import SearchConfig
from repro_torch.data.calib import calibration_tensor
from repro_torch.data.pipeline import DataConfig, make_pipeline
from repro_torch.device import resolve_device
from repro_torch.launch.train import train
from repro_torch.models.model import forward


def main(argv=None):
    """Returns {"losses": the training losses, "ppl": {"fp32", "rtn",
    "ie"}: held-out perplexities, "accept_rate": the search's}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--search-steps", type=int, default=200)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default; raises without a card) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    with tempfile.TemporaryDirectory() as ckpt_dir:
        params, losses, cfg = train(arch="opt-tiny", steps=args.steps,
                                    batch=16, seq=128, lr=1.5e-3,
                                    ckpt_dir=ckpt_dir, save_every=100,
                                    device=dev)
    print(f"\ntraining: loss {losses[0]:.3f} -> {losses[-1]:.3f}")

    calib = calibration_tensor(cfg.vocab_size, n_seqs=8, seq_len=128,
                               device=dev)
    held = torch.from_numpy(make_pipeline(DataConfig(
        seq_len=128, global_batch=8, seed=777,
        vocab_size=cfg.vocab_size))(0).astype(np.int64)).to(dev)

    def ppl(p):
        return math.exp(float(calib_ce(forward(p, cfg, held), held,
                                       cfg.vocab_size)))

    qcfg = QuantConfig(bits=2, group_size=32)
    r_rtn = quantize_model(params, cfg, qcfg, method="rtn",
                           calib_tokens=calib, device=dev)
    r_ie = quantize_model(params, cfg, qcfg, method="rtn", calib_tokens=calib,
                          search=SearchConfig(steps=args.search_steps,
                                              n_match_layers=2,
                                              log_every=100), device=dev)
    out = {"losses": losses, "accept_rate": r_ie.search.accept_rate,
           "ppl": {"fp32": ppl(params), "rtn": ppl(r_rtn.params_q),
                   "ie": ppl(r_ie.params_q)}}
    print(f"\nheld-out ppl:  fp32={out['ppl']['fp32']:8.2f}")
    print(f"               rtn ={out['ppl']['rtn']:8.2f}")
    print(f"               +IE ={out['ppl']['ie']:8.2f}   "
          f"(accept {r_ie.search.accept_rate:.1%})")
    return out


if __name__ == "__main__":
    main()
