"""Which torch.distributed backends move card tensors on this machine.

    python3 scripts/probe_dist_backends.py      # on a machine with a card

Starts, with ``spawn``, a NCCL group of one, two gloo ranks and two NCCL
ranks, every rank on ``cuda:0``, and runs the collectives the port uses
(``all_gather`` in list form on f32 / int32 / f64, ``broadcast``,
``all_reduce`` SUM and MAX, ``all_gather_object``) on card tensors. Prints
one JSON line a group with each call's result or its error (two NCCL ranks
on one card are refused: "Duplicate GPU detected"), and the NCCL version.
"""
import json
import socket
import sys
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _gather(x, world):
    out = [torch.empty_like(x) for _ in range(world)]
    dist.all_gather(out, x)
    return [t.tolist() for t in out]


def _reduced(x, op):
    y = x.clone()
    dist.all_reduce(y, op=op)
    return y.tolist()


def _broadcast(x):
    y = x.clone()
    dist.broadcast(y, 0)
    return y.tolist()


def _objects(rank, world):
    out = [None] * world
    dist.all_gather_object(out, {"rank": rank})
    return out


def worker(rank, world, port, backend, q):
    out = {"rank": rank, "backend": backend}
    try:
        torch.cuda.set_device(0)
        dist.init_process_group(backend, world_size=world, rank=rank,
                                init_method=f"tcp://127.0.0.1:{port}")
        x = torch.full((4,), float(rank + 1), device="cuda:0")
        calls = {
            "all_gather": lambda: _gather(x, world),
            "all_gather_int32": lambda: _gather(x.int(), world),
            "all_gather_f64": lambda: _gather(x.double(), world),
            "broadcast": lambda: _broadcast(x),
            "all_reduce_sum": lambda: _reduced(x, dist.ReduceOp.SUM),
            "all_reduce_max": lambda: _reduced(x, dist.ReduceOp.MAX),
            "all_gather_object": lambda: _objects(rank, world),
        }
        for name, fn in calls.items():
            try:
                out[name] = fn()
            except Exception as e:   # noqa: BLE001 — the refusal is the result
                out[name] = f"ERROR {type(e).__name__}: {e}"[:300]
        out["nccl"] = ".".join(map(str, torch.cuda.nccl.version()))
        dist.destroy_process_group()
    except Exception:   # noqa: BLE001 — reported, the parent prints it
        out["fatal"] = traceback.format_exc()[-2000:]
    q.put(out)


def run(world, backend):
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=worker, args=(r, world, port, backend, q))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        res = [q.get(timeout=300) for _ in procs]
    finally:
        for p in procs:
            p.join(60)
            if p.is_alive():
                p.kill()
    return sorted(res, key=lambda r: r["rank"])


if __name__ == "__main__":
    if not torch.cuda.is_available():
        print("probe_dist_backends: needs a CUDA card", file=sys.stderr)
        sys.exit(2)
    print(torch.__version__, torch.version.cuda,
          torch.cuda.get_device_name(0), flush=True)
    for world, backend in ((1, "nccl"), (2, "gloo"), (2, "nccl")):
        print(json.dumps({"world": world, "backend": backend,
                          "ranks": run(world, backend)}), flush=True)
