"""Fault tolerance: straggler detection + checkpoint-restore resilient loop
(the reference's ``repro.dist.fault``, with its obs names).

``run_resilient`` wraps a deterministic step function: on any step failure it
restores the latest checkpoint (or the initial state when none landed yet) and
replays forward. Because the data pipeline is step-indexed and the step
function is pure in (state, step), replay converges to the same state.

``remesh_restore`` is the elastic restore: the latest (or a given) checkpoint
read back as this rank's slices under target specs over a mesh shape — which
may differ from the one that saved — or as whole tensors.
``PreemptionGuard.drain`` joins ``runtime.barrier("preemption-drain")`` (a
world of one without a process group).
"""
from __future__ import annotations

import signal
import threading
import time
from typing import Callable, Optional

import numpy as np

from repro_torch import obs
from repro_torch.ckpt.checkpoint import list_steps

__all__ = ["StepWatchdog", "PreemptionGuard", "run_resilient",
           "remesh_restore"]


class StepWatchdog:
    """Flags straggler steps: a step slower than ``threshold`` x the median of
    recent healthy steps. Flagged samples are excluded from the baseline so a
    slow patch cannot drag the median up and mask itself.

    Every observation lands in the ``dist_step_seconds`` histogram; trips
    count into ``dist_watchdog_trips_total`` and the rolling median (plus the
    sample count, so "no baseline yet" is distinguishable from "fast") is
    exported as gauges."""

    def __init__(self, threshold: float = 2.0, warmup: int = 5,
                 window: int = 64):
        self.threshold = threshold
        self.warmup = warmup
        self.window = window
        self.flagged = 0
        self._times: list = []
        reg = obs.get_registry()
        self._h_step = reg.histogram(
            "dist_step_seconds", "Observed step durations (all samples)")
        self._c_trips = reg.counter(
            "dist_watchdog_trips_total", "Steps flagged as stragglers")
        self._g_median = reg.gauge(
            "dist_watchdog_median_step_seconds",
            "Rolling median of healthy step durations")
        self._g_samples = reg.gauge(
            "dist_watchdog_samples_seen",
            "Healthy samples in the watchdog baseline")

    def observe(self, step_seconds: float) -> bool:
        """Record one step duration; returns True iff it is a straggler."""
        self._h_step.observe(step_seconds)
        is_straggler = False
        if len(self._times) >= self.warmup:
            baseline = float(np.median(self._times[-self.window:]))
            is_straggler = step_seconds > self.threshold * baseline
        if is_straggler:
            self.flagged += 1
            self._c_trips.inc()
        else:
            self._times.append(step_seconds)
        med = self.median_step
        if med is not None:
            self._g_median.set(med)
        self._g_samples.set(self.samples_seen)
        return is_straggler

    @property
    def samples_seen(self) -> int:
        """Healthy samples recorded so far — report this next to
        ``median_step`` so a pre-warmup ``None`` median reads as "too few
        samples", not silently as "no stragglers"."""
        return len(self._times)

    @property
    def median_step(self) -> Optional[float]:
        if not self._times:
            return None
        return float(np.median(self._times[-self.window:]))

    def stats(self) -> dict:
        """One-line health summary: median (None pre-warmup), the sample
        count that explains it, and trips."""
        return {"median_step": self.median_step,
                "samples_seen": self.samples_seen,
                "warmed_up": self.samples_seen >= self.warmup,
                "flagged": self.flagged}


class PreemptionGuard:
    """Preemption-signal → checkpoint-and-barrier hook.

    Cloud schedulers announce eviction with a signal (SIGTERM on most
    platforms) and a grace window; dying mid-step wastes the window and — on
    a multi-host run — leaves peers hanging in a collective. The guard turns
    the signal into a FLAG checked at step boundaries: ``run_resilient``
    drains to a final checkpoint, then joins a ``runtime.barrier()`` so
    every host exits with the SAME step durably on disk (the next
    incarnation restores it, possibly onto another mesh via
    ``remesh_restore``).

    Use as a context manager so the previous handlers are restored (tests,
    nested loops); ``signal.raise_signal`` or a real ``kill`` both work.
    """

    def __init__(self, signals=(signal.SIGTERM,)):
        self.signals = tuple(signals)
        self._flag = threading.Event()
        self._prev: dict = {}

    def __enter__(self):
        for s in self.signals:
            self._prev[s] = signal.signal(s, self._on_signal)
        return self

    def __exit__(self, *exc):
        for s, h in self._prev.items():
            signal.signal(s, h)
        self._prev.clear()
        return False

    def _on_signal(self, signum, frame):
        self._flag.set()

    @property
    def preempted(self) -> bool:
        return self._flag.is_set()

    def drain(self, ckpt, step: int, state) -> None:
        """Checkpoint ``state`` at ``step``, join the save, then barrier so
        every host has the step durably written before anyone exits."""
        from repro_torch.dist import runtime
        obs.counter("dist_preemption_drains_total",
                    "Preemption signals drained to a checkpoint").inc()
        with obs.trace_span("dist.preemption_drain", step=step):
            if ckpt is not None:
                ckpt.save(step, state)
                ckpt.wait()
            runtime.barrier("preemption-drain")


def run_resilient(step_fn: Callable, state, n_steps: int, *, ckpt=None,
                  save_every: int = 0, start_step: int = 0, watchdog=None,
                  max_restores: int = 8, preemption: Optional[PreemptionGuard] = None):
    """Run ``state = step_fn(state, step)`` for steps [start_step, n_steps),
    surviving step failures via checkpoint restore.

    ckpt        — a ``CheckpointManager`` (or None: failures re-raise).
    save_every  — checkpoint whenever the completed-step count hits a multiple
                  (manifests record the NEXT step to run, so restore resumes
                  exactly where the save left off).
    watchdog    — optional ``StepWatchdog``; stragglers are logged as events,
                  never fatal.
    max_restores— restart budget; a persistent failure eventually re-raises
                  instead of looping (replay is only safe for transient
                  faults).
    preemption  — optional ``PreemptionGuard``; once its signal fires the
                  loop stops at the NEXT step boundary, checkpoints, joins a
                  cross-host barrier, and returns early with a
                  ("preempted", step) event.

    Returns (final_state, events) where events is a list of tuples:
    ("saved", step) / ("failure", step, msg) / ("restored", step) /
    ("straggler", step, seconds) / ("preempted", step).

    Caveat: the no-checkpoint initial-state fallback replays from the
    ``state`` passed in, so a step function must not modify its input state
    in place (the port's train step does not).
    """
    events: list = []
    initial = state
    step = start_step
    restores = 0
    while step < n_steps:
        try:
            t0 = time.perf_counter()
            state = step_fn(state, step)
            dt = time.perf_counter() - t0
            if watchdog is not None and watchdog.observe(dt):
                events.append(("straggler", step, dt))
            step += 1
            if preemption is not None and preemption.preempted:
                preemption.drain(ckpt, step, state)
                if ckpt is not None:
                    events.append(("saved", step))
                events.append(("preempted", step))
                return state, events
            if ckpt is not None and save_every and step % save_every == 0:
                ckpt.save(step, state)
                events.append(("saved", step))
        except KeyboardInterrupt:
            raise
        except Exception as e:  # noqa: BLE001 — any step fault is recoverable
            events.append(("failure", step, f"{type(e).__name__}: {e}"))
            restores += 1
            if ckpt is None or restores > max_restores:
                raise
            state, step = _restore_newest_intact(ckpt, initial, start_step,
                                                 events)
            events.append(("restored", step))
    if ckpt is not None:
        if save_every and step % save_every != 0:
            ckpt.save(step, state)  # final state: trailing steps survive restart
            events.append(("saved", step))
        ckpt.wait()  # the last async save must land before callers restore
    return state, events


def _restore_newest_intact(ckpt, initial, start_step: int, events: list):
    """Newest checkpoint that actually restores; corrupt ones are skipped
    (a failure that also corrupted the latest save must not end recovery).
    Falls back to the initial state when nothing intact remains."""
    ckpt.wait()
    for s in reversed(list_steps(ckpt.dir)):
        try:
            state, manifest = ckpt.restore(s)
            return state, int(manifest["step"])
        except Exception as e:  # noqa: BLE001 — corrupt shard, keep digging
            events.append(("corrupt_ckpt", s, f"{type(e).__name__}: {e}"))
    return initial, start_step


def remesh_restore(ckpt, specs=None, step: Optional[int] = None,
                   mesh_shape=None):
    """Elastic restore: load the latest (or given) checkpoint of the
    ``CheckpointManager`` ``ckpt`` and return this rank's slice of every
    leaf under the target ``specs`` (a spec tree, ``dist.sharding``) over
    ``mesh_shape`` — which may differ in shape and world size from the mesh
    that saved (N ranks -> M ranks) — or whole tensors when ``specs`` is
    None. Format-2 checkpoints read only the saved shards that overlap each
    slice. Returns (tree, manifest)."""
    return ckpt.restore(step, specs=specs, mesh=mesh_shape)
