"""Paper Table 1 on the port: RTN / GPTQ / AWQ / OmniQuant ± InvarExplore,
2-bit g32, on the bench model the port trains itself (the reference's
``benchmarks/table1_main.py``).

    PYTHONPATH=src python -m repro_torch.bench.table1_main            # card
    PYTHONPATH=src python -m repro_torch.bench.table1_main --device cpu

Claims checked (the reference's own): (i) 2-bit RTN is catastrophic, (ii)
+InvarExplore does not regress any calibrated base method (≤ 1.02×), (iii)
+InvarExplore improves RTN. The search runs the fused candidate build
(``SearchConfig(fused_kernel=True)``: the ``transform_quant`` kernel on the
card; the same accept decisions as the unfused build). Writes
``build/bench/table1.json`` (held-out ppl by row).
"""
from __future__ import annotations

import argparse
import json

from repro_torch.bench.common import (ART, CKPT, bench_model, calib_set, emit,
                                      heldout_set, ppl, timed)
from repro_torch.core.pipeline import quantize_model
from repro_torch.core.quant import QuantConfig
from repro_torch.core.search import SearchConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import ops

__all__ = ["run", "check_claims", "METHODS"]

METHODS = ("rtn", "gptq", "awq", "omniquant")


def check_claims(rows: dict) -> None:
    """The reference's paper-claim checks; raises AssertionError."""
    if not rows["rtn"] > rows["fp32"] * 1.05:
        raise AssertionError(f"2-bit RTN ({rows['rtn']:.3f}) must degrade the "
                             f"model by > 5% (fp32 {rows['fp32']:.3f})")
    for m in ("gptq", "awq", "omniquant"):
        if not rows[m + "+invarexplore"] <= rows[m] * 1.02:
            raise AssertionError(f"{m}: IE regressed ({rows[m + '+invarexplore']:.3f} "
                                 f"> 1.02 x {rows[m]:.3f})")
    if not rows["rtn+invarexplore"] < rows["rtn"]:
        raise AssertionError(f"RTN+IE ({rows['rtn+invarexplore']:.3f}) must beat "
                             f"RTN ({rows['rtn']:.3f})")


def run(search_steps: int = 400, bits: int = 2, group: int = 32, *,
        device="cuda", ckpt_dir=CKPT, out=ART / "table1.json"):
    """Returns (rows: name -> held-out ppl, info: name -> {"seconds",
    "accept_rate", "launches"}); the kernel launch counts are of that row's
    ``quantize_model`` call alone."""
    dev = resolve_device(device)
    params, cfg = bench_model(device=dev, ckpt_dir=ckpt_dir)
    calib = calib_set(cfg, device=dev)
    held = heldout_set(cfg, device=dev)
    qcfg = QuantConfig(bits=bits, group_size=group)
    scfg = SearchConfig(steps=search_steps, n_match_layers=4, log_every=0,
                        fused_kernel=True)

    rows = {"fp32": ppl(params, cfg, held)}
    info = {}
    for method in METHODS:
        for search in (None, scfg):
            name = method + ("+invarexplore" if search else "")
            ops.reset_launch_counts()
            r, us = timed(lambda: quantize_model(params, cfg, qcfg, method=method,
                                                 calib_tokens=calib, search=search,
                                                 device=dev), device=dev)
            launches = dict(ops.LAUNCHES)
            rows[name] = ppl(r.params_q, cfg, held)
            acc = r.search.accept_rate if search else None
            info[name] = {"seconds": us / 1e6, "accept_rate": acc,
                          "launches": launches}
            emit(f"table1/{name}", us, f"ppl={rows[name]:.3f}"
                 + (f";accept={acc:.2f}" if search else ""))
            del r

    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rows, indent=1))
    print("\nTable 1 (held-out ppl, lower=better):")
    for k, v in rows.items():
        print(f"  {k:22s} {v:10.3f}")
    check_claims(rows)
    return rows, info


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--search-steps", type=int, default=400)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default; raises without a card) or 'cpu'")
    args = ap.parse_args(argv)
    run(args.search_steps, device=args.device)


if __name__ == "__main__":
    main()
