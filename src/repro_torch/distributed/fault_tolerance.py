"""Fault tolerance: heartbeats, elastic restart, straggler detection.

The twin of ``repro/distributed/fault_tolerance.py``.

Serving-side (simulator): ``HeartbeatMonitor`` watches daemon liveness and
triggers the cluster's re-route path; stragglers are detected by
fleet-relative step times.

Training-side: ``run_with_restarts`` is the checkpoint/restart loop — on a
(possibly injected) failure it restores the latest committed checkpoint and
resumes.  The port's train step updates the parameters and the optimizer's
moments in place, so a step that fails after it has written leaves the
state it was given changed: the loop never resumes from that state, only
from what ``Checkpointer.restore`` reads back (new tensors).  For the same
reason it commits step 0 before the first step when the directory holds no
checkpoint: the reference restarts a failure before its first save from
step 0 with whatever state the failed run had left, which after a step
has run is not the initial state.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List

from repro_torch.checkpoint.checkpoint import Checkpointer


class InjectedFailure(RuntimeError):
    """Raised by tests/benchmarks to simulate a node loss."""


@dataclasses.dataclass
class HeartbeatMonitor:
    """Marks instances failed when their daemon stops completing ops.

    ``cluster`` is duck-typed: ``instances``, each with ``name``,
    ``failed`` and a ``daemon`` with ``last_heartbeat`` and
    ``oldest_pending_time()``; and ``fail_instance(name)``."""
    timeout_s: float = 5.0

    def check(self, cluster, now: float) -> List[str]:
        failed = []
        for inst in cluster.instances:
            if inst.failed:
                continue
            last = max(inst.daemon.last_heartbeat, 0.0)
            oldest = inst.daemon.oldest_pending_time()
            # presumed dead only if work has been WAITING past the timeout
            # with no completions in that window (freshly re-routed work on a
            # healthy-but-idle instance must not trip the detector)
            if (oldest is not None
                    and now - oldest > self.timeout_s
                    and now - last > self.timeout_s):
                cluster.fail_instance(inst.name)
                failed.append(inst.name)
        return failed


def run_with_restarts(train_steps: int,
                      step_fn: Callable[[int, Dict], Dict],
                      state: Dict,
                      ckpt: Checkpointer,
                      *,
                      save_every: int = 10,
                      max_restarts: int = 5) -> Dict:
    """Elastic training loop.

    ``step_fn(step, state) -> state`` may raise ``InjectedFailure`` — the
    loop restores the last committed checkpoint and resumes from there,
    at most ``max_restarts`` times.  The final state is identical to an
    uninterrupted run's when step_fn is deterministic, also when it updates
    ``state`` in place before it raises.  Saves are blocking, so a
    committed step is on disk before the next step runs.
    """
    restarts = 0
    step = ckpt.latest_step()
    if step is None:
        step = 0
        ckpt.save(step, state, blocking=True)
    else:
        state = ckpt.restore(step, state)
    while step < train_steps:
        try:
            state = step_fn(step, state)
            step += 1
            if step % save_every == 0 or step == train_steps:
                ckpt.save(step, state, blocking=True)
        except InjectedFailure:
            restarts += 1
            if restarts > max_restarts:
                raise
            step = ckpt.latest_step()
            state = ckpt.restore(step, state)
    return state


@dataclasses.dataclass
class StragglerStats:
    """Fleet-relative straggler detection (serving + training)."""
    threshold: float = 2.5

    def stragglers(self, step_times: Dict[str, float]) -> List[str]:
        vals = sorted(v for v in step_times.values() if v > 0)
        if len(vals) < 2:
            return []
        med = vals[len(vals) // 2]
        return [k for k, v in step_times.items() if v > self.threshold * med]
