"""Distributed substrate over ``torch.distributed``: runtime bring-up,
sharding rules, fault tolerance, compressed collectives, and
sequence-sharded decode attention (the reference's ``repro.dist``).

Layout:
    runtime.py     — process-group bring-up (coordinator/process env vars),
                     all-reduce barrier, device introspection; one process
                     per device
    sharding.py    — partition-spec trees over the ("data", "model") mesh
                     shape, and a rank's slice of a leaf under a spec
    fault.py       — straggler watchdog, checkpoint-restore resilient loop,
                     preemption-signal → checkpoint-and-barrier hook,
                     elastic re-mesh restore
    collectives.py — group-quantized (compressed) all-reduce + the island
                     search's elite exchange (argmin_allgather scalar race,
                     elite_broadcast state move)
    attention.py   — log-sum-exp partial-softmax merge for sharded KV decode

With no process group initialised the world is one process and every
collective is the identity over it.
"""
from repro_torch.dist import runtime
from repro_torch.dist.attention import (merge_partials,
                                        partial_decode_attention,
                                        sharded_decode_attention,
                                        sharded_paged_decode_attention)
from repro_torch.dist.collectives import (argmin_allgather, compressed_psum,
                                          elite_broadcast)
from repro_torch.dist.fault import (PreemptionGuard, StepWatchdog,
                                    remesh_restore, run_resilient)
from repro_torch.dist.sharding import (ShardingRules, cache_specs, data_spec,
                                       opt_state_specs, param_specs)

__all__ = [
    "ShardingRules", "param_specs", "opt_state_specs", "cache_specs",
    "data_spec",
    "StepWatchdog", "PreemptionGuard", "run_resilient", "remesh_restore",
    "compressed_psum", "argmin_allgather", "elite_broadcast",
    "partial_decode_attention", "merge_partials", "sharded_decode_attention",
    "sharded_paged_decode_attention",
    "runtime",
]
