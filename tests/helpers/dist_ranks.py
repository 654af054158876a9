"""Run a function in N real ``torch.distributed`` ranks on the CPU (gloo).

``run_ranks(fn, world, tmp_path, *args)`` starts ``world`` processes with
the ``spawn`` start method, brings each up through
``repro_torch.dist.runtime.initialize`` over a ``file://`` store under
``tmp_path`` (no port to collide on between test workers), calls
``fn(rank, world, *args)`` on one intra-op thread, and returns every rank's
result (picklable), in rank order; ``run_worlds`` starts several world
sizes at once, and ``start_ranks`` / ``finish_ranks`` let the caller work
while the ranks run. A rank that raises fails the call with its
traceback. ``fn`` must be importable by module path (the workers live in
``helpers.dist_workers``, which imports nothing of JAX).
"""
from __future__ import annotations

import multiprocessing as mp
import pathlib
import pickle
import time
import traceback


def _entry(fn, rank, world, store, out, args):
    import torch

    torch.set_num_threads(1)
    res_file = pathlib.Path(out) / f"rank{rank}.pkl"
    try:
        from repro_torch.dist import runtime
        runtime.initialize(f"file://{store}", world, rank, device="cpu")
        res = fn(rank, world, *args)
        res_file.write_bytes(pickle.dumps(("ok", res)))
    except BaseException:
        res_file.write_bytes(pickle.dumps(("error", traceback.format_exc())))
        raise
    finally:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, world: int, tmp_path, *args, timeout: float = 300.0):
    return finish_ranks(start_ranks(fn, world, tmp_path, *args), timeout)


def run_worlds(fn, worlds, tmp_path, *args, timeout: float = 300.0):
    """``run_ranks`` for several world sizes at once (every rank of every
    world started together, each world on a store of its own); returns
    {world: results}."""
    started = [start_ranks(fn, w, tmp_path, *args) for w in worlds]
    try:
        return {w: finish_ranks(st, timeout)
                for w, st in zip(worlds, started)}
    finally:   # a world that failed first leaves none of the others running
        for procs, _ in started:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()


def start_ranks(fn, world: int, tmp_path, *args):
    """Start the ranks and return at once (a handle for ``finish_ranks``),
    so the caller can work while they run."""
    tmp = pathlib.Path(tmp_path)
    out = tmp / f"ranks_{fn.__name__}_{world}"
    out.mkdir(parents=True, exist_ok=True)
    store = out / "store"
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry,
                         args=(fn, r, world, str(store), str(out), args))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs, out


def finish_ranks(handle, timeout: float = 300.0):
    """Wait for the ranks of ``start_ranks`` (killing any left after
    ``timeout``) and return their results, in rank order."""
    procs, out = handle
    deadline = time.monotonic() + timeout
    try:   # a rank that failed leaves its peers blocked in a collective
        while any(p.is_alive() for p in procs) and \
                time.monotonic() < deadline and \
                not any(p.exitcode not in (None, 0) for p in procs):
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    results, errors = [], []
    for r, p in enumerate(procs):
        f = out / f"rank{r}.pkl"
        if not f.exists():
            errors.append(f"rank {r}: exit code {p.exitcode}, no result")
            continue
        status, res = pickle.loads(f.read_bytes())
        if status != "ok":
            errors.append(f"rank {r}:\n{res}")
        results.append(res)
    if errors:
        raise AssertionError("\n".join(errors))
    return results
