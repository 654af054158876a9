"""Command-line entry point of the population × island discrete search (the
reference's ``repro.launch.search``).

    PYTHONPATH=src python -m repro_torch.launch.search --arch opt-tiny \\
        --steps 40 --population 4 --islands 2 --bits 2 --group 32

Runs the RTN → InvarExplore pipeline on the ``.reduced()`` config with
random weights from ``--seed``, and merges a proposals/sec row into
``--out`` (default ``build/bench/BENCH_search.json`` under the working
directory, git-ignored) by row name. Row names and the ``derived`` field
are the reference's. With ``--measure-mem`` (CUDA only) the row carries
``peak_live_bytes``, ``stack_bytes`` and ``candidate_batch_bytes`` and lands
under ``search_unit_install/`` or ``search_stack_install/`` per
``--install``. With ``--mapped`` the islands run one per rank of the
``torch.distributed`` world (``SearchConfig(mapped=True)``; ``--islands``
must equal the world size), each rank on its own device, and the row lands
under ``search_mapped_islands/``, written by rank 0 alone; its proposals
are reconciled with the registries of every rank merged
(``obs.dist_snapshot``). ``main`` brings the world up from the
``REPRO_COORDINATOR`` / ``REPRO_NUM_PROCESSES`` / ``REPRO_PROCESS_ID``
environment (``dist.runtime.initialize``) or runs alone:

    REPRO_COORDINATOR=127.0.0.1:29511 REPRO_NUM_PROCESSES=2 \
    REPRO_PROCESS_ID=0 PYTHONPATH=src python -m repro_torch.launch.search \
        --islands 2 --mapped --steps 8 &   # ... and REPRO_PROCESS_ID=1

``main(argv, device="cpu")`` runs it on the CPU (over gloo when mapped).
"""
from __future__ import annotations

import argparse
import json
import pathlib
import time

import torch

from repro_torch import obs
from repro_torch.configs import get_config
from repro_torch.core.pipeline import quantize_model
from repro_torch.core.quant import QuantConfig
from repro_torch.core.search import SearchConfig
from repro_torch.data.calib import calibration_tensor
from repro_torch.dist import runtime
from repro_torch.models.model import init_params

__all__ = ["run_search_bench", "main", "DEFAULT_OUT"]

# under the git-ignored build/, as obs.DEFAULT_METRICS_PATH
DEFAULT_OUT = "build/bench/BENCH_search.json"


def _merge_rows(out: pathlib.Path, row: dict):
    """Accumulate rows by name, so rows of several invocations land side by
    side in one file."""
    rows = []
    if out.exists():
        try:
            rows = [r for r in json.loads(out.read_text())
                    if r.get("name") != row["name"]]
        except (ValueError, KeyError):
            rows = []
    rows.append(row)
    out.write_text(json.dumps(rows, indent=1))


def _proposals_total(mapped: bool) -> float:
    """``search_proposals_total`` over every label: this process's, or,
    when mapped, every rank's merged (a collective: every rank calls it)."""
    if not mapped:
        return obs.counter("search_proposals_total",
                           "Candidate transforms proposed").total()
    entry = obs.dist_snapshot().get("search_proposals_total")
    return sum(s["value"] for s in entry["series"]) if entry else 0.0


def run_search_bench(arch: str = "opt-tiny", *, steps: int = 40,
                     population: int = 4, islands: int = 1,
                     temperature: float = 0.0, anneal: str = "geometric",
                     migrate_every: int = 25, fused: bool = False,
                     mapped: bool = False, objective: str = "ce",
                     install: str = "unit", tabu: int = 0,
                     shard_calib: bool = False, measure_mem: bool = False,
                     bits: int = 2, group: int = 32, n_seqs: int = 4,
                     seq_len: int = 128, seed: int = 0,
                     out=None, metrics_out: str = obs.DEFAULT_METRICS_PATH,
                     device="cuda") -> dict:
    dev = runtime.local_device(device)
    cfg = get_config(arch).reduced()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                         device=dev)
    calib = calibration_tensor(cfg.vocab_size, n_seqs=n_seqs,
                               seq_len=seq_len, device=dev)
    scfg = SearchConfig(steps=steps, seed=seed, n_match_layers=2, log_every=0,
                        population=population, islands=islands,
                        temperature=temperature, anneal=anneal,
                        migrate_every=migrate_every, fused_kernel=fused,
                        mapped=mapped, objective=objective, install=install,
                        tabu=tabu, shard_calib=shard_calib,
                        measure_memory=measure_mem)
    qcfg = QuantConfig(bits=bits, group_size=group)

    prop_before = _proposals_total(mapped)
    t0 = time.monotonic()
    result = quantize_model(params, cfg, qcfg, method="rtn",
                            calib_tokens=calib, search=scfg, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.monotonic() - t0
    sr = result.search
    proposals = sr.stats["proposals"]
    # the registry must reconcile exactly with the stats dict — a drift
    # here means an instrumentation hook was moved off the hot path
    prop_delta = _proposals_total(mapped) - prop_before
    if prop_delta != proposals:
        raise AssertionError(
            f"obs/stats divergence: search_proposals_total grew by "
            f"{prop_delta} but stats['proposals'] == {proposals}")
    family = ({"unit": "search_unit_install",
               "stack": "search_stack_install"}[install] if measure_mem
              else "search_mapped_islands" if mapped else "search/engine")
    row = {
        "name": (f"{family}/{arch}s{steps}p{population}i{islands}"
                 f"b{bits}g{group}" + ("fused" if fused else "")
                 + (f"-{objective}" if objective != "ce" else "")),
        "us_per_call": round(dt * 1e6 / max(proposals, 1), 1),
        "derived": (f"proposals_per_sec={proposals / max(dt, 1e-9):.2f} "
                    f"loss={sr.initial_loss:.4f}->{sr.final_loss:.4f} "
                    f"accept={sr.accept_rate:.2%} "
                    f"migrations={sr.stats['migrations']} "
                    f"objective={sr.stats['objective']} "
                    f"install={sr.stats['install']} "
                    f"tabu_hits={sr.stats['tabu_hits']}"),
    }
    if measure_mem:
        for key in ("peak_live_bytes", "stack_bytes", "candidate_batch_bytes"):
            row[key] = int(sr.stats[key])
    if runtime.process_index() == 0:
        print(f"{row['name']},{row['us_per_call']},{row['derived']}")
        out = pathlib.Path(out if out else DEFAULT_OUT)
        out.parent.mkdir(parents=True, exist_ok=True)
        _merge_rows(out, row)
    if metrics_out:
        obs.write_snapshot(path=metrics_out)
    return row


def main(argv=None, *, device="cuda") -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="opt-tiny")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--population", type=int, default=4)
    ap.add_argument("--islands", type=int, default=1)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--anneal", default="geometric")
    ap.add_argument("--migrate-every", type=int, default=25)
    ap.add_argument("--fused", action="store_true",
                    help="fused transform+fake-quant kernel hot path")
    ap.add_argument("--mapped", action="store_true",
                    help="one island per rank of the torch.distributed world "
                         "(requires --islands == world size)")
    ap.add_argument("--objective", default="ce",
                    choices=["ce", "kl", "swd_actmatch", "saliency_ce"],
                    help="search objective (registry name)")
    ap.add_argument("--install", default="unit", choices=["unit", "stack"],
                    help="candidate install mode: 'unit' = stack + K built "
                         "units; 'stack' = K full stacks")
    ap.add_argument("--tabu", type=int, default=0,
                    help="tried-point memory capacity (0 disables)")
    ap.add_argument("--shard-calib", action="store_true",
                    help="each island climbs on its own calibration slice")
    ap.add_argument("--measure-mem", action="store_true",
                    help="read the CUDA allocator's peak; rows land under "
                         "search_unit_install/search_stack_install")
    ap.add_argument("--bits", type=int, default=2)
    ap.add_argument("--group", type=int, default=32)
    ap.add_argument("--seqs", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--metrics-out", default=obs.DEFAULT_METRICS_PATH,
                    help="metrics snapshot path ('' disables)")
    ap.add_argument("--trace-out", default="",
                    help="span/event JSONL sink path ('' disables)")
    args = ap.parse_args(argv)
    if args.trace_out:
        obs.set_trace_sink(args.trace_out)
    runtime.initialize(device=device)
    run_search_bench(args.arch, steps=args.steps, population=args.population,
                     islands=args.islands, temperature=args.temperature,
                     anneal=args.anneal, migrate_every=args.migrate_every,
                     fused=args.fused, mapped=args.mapped,
                     objective=args.objective, install=args.install,
                     tabu=args.tabu, shard_calib=args.shard_calib,
                     measure_mem=args.measure_mem, bits=args.bits,
                     group=args.group, n_seqs=args.seqs,
                     seq_len=args.seq_len, seed=args.seed, out=args.out,
                     metrics_out=args.metrics_out, device=device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
