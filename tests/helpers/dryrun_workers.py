"""Rank workers of ``tests/test_torch_dryrun.py`` (run by
``helpers.dist_ranks.run_ranks``; importable by module path, no JAX)."""


def collective_counts(rank, world, n):
    """``launch.roofline.collective_bytes`` over an all-gather, a broadcast
    and two all-reduces (f32, f64) of ``n`` values a rank."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.roofline import collective_bytes

    x = torch.arange(n, dtype=torch.float32) + rank
    with collective_bytes() as coll:
        out = [torch.empty(n) for _ in range(world)]
        dist.all_gather(out, x)
        dist.broadcast(x, src=0)
        dist.all_reduce(x)
        dist.all_reduce(x.double())
        dist.barrier()
    return coll.as_dict()
