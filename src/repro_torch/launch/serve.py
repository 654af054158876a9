"""Serving entry point for quantized models: paged KV cache + continuous batching
(the reference's ``repro.launch.serve``, paged path).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch opt-tiny --bits 2

``PagedServer``: requests stream through ``serving.ContinuousBatcher`` —
chunked prefill writes prompt K/V into a fixed-size page pool, one decode
step advances every live sequence at its own depth (attention reads pages
through the CUDA paged-decode kernel), finished sequences hand their page
references back between steps, and exhaustion preempts the scheduler's
victim. Shared prompt prefixes are aliased from the prefix cache at admit
(``--no-prefix-cache`` disables), and ``--scheduler slo`` turns on priority
admission with per-tenant page quotas. Weights stay packed QTensors and are
dequantized one layer at a time inside each step.

``BatchedServer`` (``--legacy``) keeps the reference's fixed-slot loop for
comparison: it left-pads every batch to its longest prompt and holds
max_len-deep contiguous cache slots whether used or not; with
``cfg.use_flash_decode`` each decode step's attention takes the CUDA
``flash_decode`` kernel. It is the only server of the SSM and hybrid
stacks (``--arch mamba2-2.7b`` / ``zamba2-7b --legacy``): their blocks keep
O(1) state, so the paged cache refuses them, as the reference's does.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs import get_config
from repro_torch.core.quant import QuantConfig
from repro_torch.device import check_on_device, resolve_device
from repro_torch.launch.steps import make_serve_step
from repro_torch.models.model import init_params, prefill
from repro_torch.quantized.qmodel import dense_bytes, pack_model, packed_bytes
from repro_torch.serving import (ContinuousBatcher, PagedKVCache,
                                 PagedRequest, make_scheduler)

__all__ = ["Request", "BatchedServer", "PagedServer", "main"]


@dataclasses.dataclass
class Request:
    prompt: np.ndarray              # (S,) int32
    max_new: int = 32
    out: Optional[list] = None
    temperature: float = 0.0        # <= 0: greedy
    top_k: int = 0                  # 0: unrestricted
    seed: int = 0                   # per-request sample stream
    tenant: str = "default"         # quota bucket (SLO scheduler)
    priority: int = 0               # admission order (SLO scheduler)


class BatchedServer:
    """Fixed-batch greedy decoding server with slot recycling over a
    contiguous cache (the reference's ``BatchedServer``): K/V slots, and
    for SSM and hybrid stacks each SSM block's state (``models.model``'s
    ``prefill`` / ``decode_step``).

    Each batch of up to ``batch_size`` requests is left-padded with token 0
    to its longest prompt and padded to ``batch_size`` rows with copies of
    its last request; the prefill's last logits give the first token, then
    ``max_new - 1`` decode steps follow. The cache (``batch_size`` x
    ``max_len``) lives on ``device`` (the card unless ``device="cpu"``),
    where ``params_q`` must already be.

    Prompts are text: a vision stack is served without patches, as the
    reference's server serves it. An encoder-decoder stack raises
    ``ValueError`` (the reference's server prefills without the encoder's
    input and fails there): serve it with ``launch.steps.make_prefill_step``
    (``enc_embeds`` in the batch) and ``make_serve_step``.
    """

    def __init__(self, params_q, cfg, batch_size: int = 4, max_len: int = 512,
                 device="cuda"):
        if cfg.is_enc_dec:
            raise ValueError(
                f"BatchedServer prefills text prompts only; {cfg.name} is an "
                f"encoder-decoder stack: serve it with "
                f"launch.steps.make_prefill_step (enc_embeds in the batch) "
                f"and make_serve_step over the cross-attention cache")
        self.device = resolve_device(device)
        check_on_device(params_q, self.device)
        self.cfg = cfg
        self.params = params_q
        self.B = batch_size
        self.max_len = max_len
        self.step_fn = make_serve_step(cfg)
        self.prefill_fn = lambda p, batch: prefill(p, cfg, batch["tokens"],
                                                   max_len)

    def generate(self, requests: List[Request]):
        """Serve all requests; returns list of generated-token lists."""
        queue = list(requests)
        results = {id(r): [] for r in requests}
        while queue:
            chunk = queue[: self.B]
            queue = queue[self.B:]
            # pad the batch to B with copies (masked out of results)
            live = len(chunk)
            while len(chunk) < self.B:
                chunk.append(chunk[-1])
            plen = max(len(r.prompt) for r in chunk)
            toks = np.stack([np.pad(r.prompt, (plen - len(r.prompt), 0),
                                    constant_values=0) for r in chunk])
            logits, cache = self.prefill_fn(self.params, {
                "tokens": torch.from_numpy(toks.astype(np.int64)).to(
                    self.device)})
            last = torch.argmax(logits[:, -1, : self.cfg.vocab_size],
                                dim=-1)[:, None]
            max_new = max(r.max_new for r in chunk[:live])
            outs = [last]
            tok = last
            for t in range(max_new - 1):
                tok, cache = self.step_fn(self.params, tok, cache, plen + t)
                outs.append(tok)
            gen = torch.cat(outs, dim=1).cpu().numpy()
            for i, r in enumerate(chunk[:live]):
                results[id(r)] = gen[i, : r.max_new].tolist()
        return [results[id(r)] for r in requests]


class PagedServer:
    """Continuous-batching server over the paged KV cache.

    ``n_pages`` bounds TOTAL cache memory across all live sequences;
    ``max_pages_per_seq`` (from ``max_len``) bounds a single sequence.
    SSM and hybrid configs raise ``ValueError`` (``PagedKVCache``), and
    encoder-decoder configs too (the paged steps keep no cross-attention
    cache), as in the reference; a vision stack is served on text.
    ``prefix_cache`` (default on) shares pages between requests, outputs
    token-identical to sharing disabled on a dense model (an MoE model
    routes each prefill chunk at that chunk's capacity, and sharing
    changes the chunks, as in the reference). ``scheduler`` is ``"fifo"``,
    ``"slo"`` (with ``tenant_quota`` pages per tenant) or a
    ``serving.Scheduler``. The pools live on ``device`` (the card unless
    ``device="cpu"``), where ``params_q`` must already be.
    """

    def __init__(self, params_q, cfg, max_batch: int = 4, page_size: int = 16,
                 n_pages: Optional[int] = None, max_len: int = 512,
                 prefill_chunk_pages: int = 4, prefix_cache: bool = True,
                 scheduler="fifo", tenant_quota: Optional[int] = None,
                 gqa_pages_per_block: int = 1, device="cuda"):
        pages_per_seq = -(-max_len // page_size)
        if n_pages is None:
            n_pages = max_batch * pages_per_seq + 1  # +1 null page
        self.cfg = cfg
        self.cache = PagedKVCache(cfg, n_pages=n_pages, page_size=page_size,
                                  max_pages_per_seq=pages_per_seq,
                                  device=device)
        if isinstance(scheduler, str):
            scheduler = make_scheduler(scheduler, tenant_quota=tenant_quota)
        self.batcher = ContinuousBatcher(params_q, cfg, self.cache,
                                         max_batch=max_batch,
                                         prefill_chunk_pages=prefill_chunk_pages,
                                         scheduler=scheduler,
                                         prefix_cache=prefix_cache,
                                         gqa_pages_per_block=gqa_pages_per_block)

    def generate(self, requests: List[Request]):
        paged = [PagedRequest(prompt=np.asarray(r.prompt, np.int32),
                              max_new=r.max_new, temperature=r.temperature,
                              top_k=r.top_k, seed=r.seed, tenant=r.tenant,
                              priority=r.priority) for r in requests]
        return self.batcher.run(paged)

    def sharing_report(self) -> dict:
        """Prefix-sharing + latency stats for the run(s) so far. TTFT
        percentiles come from the ``serving_ttft_seconds`` histogram
        (accurate to within one bucket width)."""
        st = self.batcher.stats
        total = st["prefill_tokens"] + st["prefill_tokens_saved"]
        ttft = self.batcher.obs["ttft"]

        def pct(p):
            return ttft.quantile(p) if ttft.count() else 0.0

        return {
            "prefill_tokens": st["prefill_tokens"],
            "prefill_tokens_saved": st["prefill_tokens_saved"],
            "saved_frac": st["prefill_tokens_saved"] / total if total else 0.0,
            "aliased_pages": st["aliased_pages"],
            "dedup_admits": st["dedup_admits"],
            "cow_forks": st["cow_forks"],
            "ttft_p50_s": pct(0.50),
            "ttft_p99_s": pct(0.99),
        }


def main(argv=None, device="cuda"):
    """The reference's flags; runs on ``device``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="opt-tiny")
    ap.add_argument("--bits", type=int, default=2)
    ap.add_argument("--group", type=int, default=32)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--pages", type=int, default=None,
                    help="total page-pool size (default: batch x max_len/page)")
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--prefill-chunk-pages", type=int, default=4,
                    help="pages per paged-prefill chunk (admit granularity)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="per-request sampling temperature (0 = greedy)")
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="disable prefix-cache page sharing across requests")
    ap.add_argument("--scheduler", default="fifo", choices=("fifo", "slo"),
                    help="admission/eviction policy (slo: priority + quotas)")
    ap.add_argument("--tenant-quota", type=int, default=None,
                    help="max pages a tenant's live requests may hold (slo)")
    ap.add_argument("--gqa-pages-per-block", type=int, default=1,
                    help="pages staged per fused-GQA decode update")
    ap.add_argument("--tenants", type=int, default=1,
                    help="spread requests round-robin over N tenants, each "
                         "sharing one system-prompt prefix")
    ap.add_argument("--legacy", action="store_true",
                    help="fixed-slot BatchedServer instead of the paged path")
    ap.add_argument("--metrics-out", default=obs.DEFAULT_METRICS_PATH,
                    help="metrics snapshot path ('' disables)")
    ap.add_argument("--trace-out", default="",
                    help="span JSONL sink path ('' disables)")
    args = ap.parse_args(argv)
    if args.trace_out:
        obs.set_trace_sink(args.trace_out)

    cfg = get_config(args.arch).reduced()
    dev = torch.device(device)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    params_q = pack_model(params, QuantConfig(bits=args.bits,
                                              group_size=args.group))
    pb, db = packed_bytes(params_q), dense_bytes(params_q)
    print(f"[serve] packed={pb/1e6:.2f}MB vs fp16={db/1e6:.2f}MB "
          f"({db/pb:.1f}x smaller)")

    rng = np.random.default_rng(0)
    sys_prompt = rng.integers(0, cfg.vocab_size,
                              size=2 * args.page_size).astype(np.int32)
    tenant_tpl = {t: rng.integers(0, cfg.vocab_size,
                                  size=args.page_size).astype(np.int32)
                  for t in range(args.tenants)}
    reqs = []
    for i in range(args.requests):
        t = i % args.tenants
        tail = rng.integers(0, cfg.vocab_size,
                            size=rng.integers(4, 12)).astype(np.int32)
        reqs.append(Request(
            prompt=np.concatenate([sys_prompt, tenant_tpl[t], tail]),
            max_new=args.max_new, temperature=args.temperature,
            top_k=args.top_k, seed=i, tenant=f"tenant{t}",
            priority=t % 3))
    if args.legacy:
        server = BatchedServer(params_q, cfg, batch_size=args.batch,
                               max_len=args.max_len, device=dev)
    else:
        server = PagedServer(params_q, cfg, max_batch=args.batch,
                             page_size=args.page_size, n_pages=args.pages,
                             max_len=args.max_len,
                             prefill_chunk_pages=args.prefill_chunk_pages,
                             prefix_cache=not args.no_prefix_cache,
                             scheduler=args.scheduler,
                             tenant_quota=args.tenant_quota,
                             gqa_pages_per_block=args.gqa_pages_per_block,
                             device=dev)
        pool = server.cache.pool_bytes()
        dense = server.cache.dense_equiv_bytes(args.batch, args.max_len)
        print(f"[serve] page pool: {server.cache.n_pages} x "
              f"{args.page_size}-token pages = {pool/1e6:.2f}MB "
              f"(contiguous {args.batch}x{args.max_len} cache: "
              f"{dense/1e6:.2f}MB)")
    t0 = time.monotonic()
    outs = server.generate(reqs)
    dt = time.monotonic() - t0
    n_tok = sum(len(o) for o in outs)
    print(f"[serve] {len(reqs)} requests, {n_tok} tokens in {dt:.2f}s "
          f"({n_tok/dt:.1f} tok/s)")
    if not args.legacy:
        print(f"[serve] batcher stats: {server.batcher.stats}")
        rep = server.sharing_report()
        print(f"[serve] sharing: {rep['prefill_tokens_saved']} prompt tokens "
              f"aliased ({rep['saved_frac']:.0%} of prefill), "
              f"{rep['dedup_admits']} duplicate admits, "
              f"{rep['cow_forks']} COW forks; "
              f"TTFT p50={rep['ttft_p50_s']*1e3:.1f}ms "
              f"p99={rep['ttft_p99_s']*1e3:.1f}ms")
    for i, o in enumerate(outs[:3]):
        print(f"  req{i}: {o[:10]}...")
    if args.metrics_out:
        p = obs.write_snapshot(path=args.metrics_out)
        print(f"[serve] metrics snapshot -> {p}")
    return outs


if __name__ == "__main__":
    main()
