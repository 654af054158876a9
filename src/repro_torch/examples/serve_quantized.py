"""End-to-end serving driver (the paper's deployment scenario): pack a model
to 2-bit QTensors and serve a MIXED-LENGTH request stream through the paged
KV cache + continuous batcher, reporting the memory split and tokens/s.

    PYTHONPATH=src python -m repro_torch.examples.serve_quantized --requests 8
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.quant import QuantConfig
from repro_torch.device import resolve_device
from repro_torch.launch.serve import PagedServer, Request
from repro_torch.models.model import init_params
from repro_torch.quantized.qmodel import (dense_bytes, pack_model,
                                          packed_bytes, serving_memory_report)


def main(argv=None):
    """Returns each request's generated tokens."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="opt-tiny")
    ap.add_argument("--bits", type=int, default=2)
    ap.add_argument("--group", type=int, default=32)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default; raises without a card) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch).reduced(n_layers=4, d_model=128, d_ff=512,
                                        vocab_size=512, n_heads=4,
                                        n_kv_heads=4)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    qcfg = QuantConfig(bits=args.bits, group_size=args.group)
    params_q = pack_model(params, qcfg)
    pb, db = packed_bytes(params_q), dense_bytes(params_q)
    print(f"[serve] weights: packed={pb/1e6:.2f} MB vs fp16-dense="
          f"{db/1e6:.2f} MB on quantized leaves ({db/pb:.1f}x)")

    server = PagedServer(params_q, cfg, max_batch=args.batch,
                         page_size=args.page_size, max_len=args.max_len,
                         device=dev)
    rep = serving_memory_report(params_q, server.cache.pools)
    print(f"[serve] page pool {server.cache.n_pages} x {args.page_size} "
          f"tokens; kv_fraction={rep['kv_fraction']:.2f} of serving memory")
    rng = np.random.default_rng(0)
    reqs = [Request(prompt=rng.integers(
        0, cfg.vocab_size, size=int(rng.integers(4, 16))).astype(np.int32),
        max_new=args.max_new) for _ in range(args.requests)]
    t0 = time.perf_counter()
    outs = server.generate(reqs)
    dt = time.perf_counter() - t0
    n = sum(len(o) for o in outs)
    print(f"[serve] {len(reqs)} requests -> {n} tokens in {dt:.2f}s "
          f"({n/dt:.1f} tok/s)")
    print(f"[serve] batcher stats: {server.batcher.stats}")
    for i, o in enumerate(outs[:3]):
        print(f"  req{i}: prompt_len={len(reqs[i].prompt)} -> {o[:8]}...")
    return outs


if __name__ == "__main__":
    main()
