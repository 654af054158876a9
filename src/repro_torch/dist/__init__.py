"""Fault tolerance for the port's training loop (the reference's
``repro.dist.fault``): straggler watchdog, checkpoint-restore resilient
loop, preemption-signal -> checkpoint-and-barrier hook. The rest of the
reference's ``repro.dist`` (runtime, sharding, collectives, sharded
attention, ``remesh_restore``) waits for ROADMAP Queue 1 item 14."""
from repro_torch.dist.fault import PreemptionGuard, StepWatchdog, run_resilient

__all__ = ["StepWatchdog", "PreemptionGuard", "run_resilient"]
