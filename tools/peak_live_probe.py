"""What the dry-run's peak of live bytes is made of: one cell traced as
``repro_torch.launch.dryrun`` traces it, with ``StepCounter`` recording
the op (and, for outputs of 100 MiB or more, the model lines) behind
every storage it holds, and at each new peak the live bytes by op,
whether the peak falls in the forward or the backward pass, and what
refers to each large residual-stream ``add`` still live there.

    PYTHONPATH=src python tools/peak_live_probe.py [ARCH SHAPE single|multi
                                                    [collect]]

Prints torch's version, the cell's ``mem_temp_bytes``, and for each
traced step (a training step is traced at one and two repeats of its
layer stack) the peak and its 12 largest ops.  Run it under two torch
versions to see where their peaks part.  ``collect`` runs Python's cyclic
collector before each rise of the peak by 1 % (or 16 MiB), so garbage in
reference cycles cannot count (and names no holders).  Imports torch and the port
only; allocates nothing on any device.
"""
import collections
import gc
import sys
import traceback
import weakref

import torch

from repro_torch.launch import dryrun as DR
from repro_torch.launch import step_analysis as SA

BIG = 100 << 20          # bytes of an output whose making lines are kept


def describe(o) -> str:
    """A short name for an object that refers to a live output."""
    if isinstance(o, (list, tuple)):
        return f"{type(o).__name__}[{len(o)}]"
    if isinstance(o, dict):
        return f"dict keys {list(o)[:4]}"
    return type(o).__name__


def holders(t) -> list:
    """What refers to ``t``, and what refers to each of those."""
    here = sys._getframe()
    return [describe(r) + " <- " + ", ".join(sorted({
        describe(q) for q in gc.get_referrers(r) if q is not here}))
        for r in gc.get_referrers(t) if r is not here]


def main(arch="olmo-1b", shape="train_4k", mesh="single", collect=""):
    steps = []

    class Probe(SA.StepCounter):
        def __init__(self):
            super().__init__()
            self.live = collections.Counter()
            self.at_peak = collections.Counter()
            self.big, self.held, self.phase, self.op = {}, {}, "", ""
            steps.append(self)

        def _count(self, func, args, kwargs, result, outs):
            self.op = func._schema.name.partition("::")[2]
            super()._count(func, args, kwargs, result, outs)

        def _hold(self, t):
            n = t.untyped_storage().nbytes()
            if not n:
                return
            op = self.op
            if collect and self._live + n > max(
                    1.01 * self.out.peak_live_bytes,
                    self.out.peak_live_bytes + (16 << 20)):
                gc.collect()
            if n >= BIG:
                site = [f"{f.filename.rsplit('/', 1)[-1]}:{f.lineno}"
                        for f in traceback.extract_stack()
                        if "/repro_torch/models/" in f.filename]
                op = f"{op} @ {' < '.join(reversed(site[-2:]))}"
                self.big.setdefault(op, []).append(weakref.ref(t))
            self.live[op] += n
            peak = self.out.peak_live_bytes
            super()._hold(t)
            if self.out.peak_live_bytes > peak:
                self.at_peak = collections.Counter(self.live)
                backward = torch._C._current_graph_task_id() != -1
                self.phase = ("backward" if backward else "forward") \
                    + f" at {op}"
                if not collect and (backward
                                    or not torch.is_grad_enabled()):
                    self.held = {k: [holders(r()) for r in refs
                                     if r() is not None]
                                 for k, refs in self.big.items()
                                 if self.live[k] and k.startswith("add @")}
            weakref.finalize(t.untyped_storage(), self._drop, op, n)

        def _drop(self, op, n):
            self.live[op] -= n

    SA.StepCounter = Probe
    info = DR.lower_cell(arch, shape, multi_pod=mesh == "multi")
    print(f"torch {torch.__version__}: {arch} x {shape} x {mesh}"
          f"{' (collected)' if collect else ''}: "
          f"mem_temp_bytes {info['mem_temp_bytes']}")
    for i, s in enumerate(steps):
        print(f"step {i}: peak {s.out.peak_live_bytes}, {s.phase}")
        for op, n in s.at_peak.most_common(12):
            print(f"  {op:48s} {n}")
        for op, h in s.held.items():
            print(f"  held: {op}: {h}")


if __name__ == "__main__":
    main(*sys.argv[1:5])
