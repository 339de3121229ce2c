"""What the dry-run's peak of live bytes is made of: one cell traced as
``repro_torch.launch.dryrun`` traces it, with ``StepCounter`` recording
the op (and, for storages of 100 MiB or more, the model lines) that made
each storage, and at the step's peak the live ranges that cover it,
summed by that label, with the op positions where the largest begin and
end.

    PYTHONPATH=src python tools/peak_live_probe.py [ARCH SHAPE single|multi]

Prints torch's version, the cell's ``mem_temp_bytes``, and for each
traced step (a training step is traced at one and two repeats of its
layer stack) its peak, the op position of the peak out of all of the
step's ops, whether that op ran in the forward or the backward pass, and
the 12 largest labels live there.  The figure is the op stream's
liveness (``StepCounter``'s docstring): run it under two torch versions
and the same figure means the same op sequence.  Imports torch and the
port only; allocates nothing on any device.
"""
import collections
import sys
import traceback

import torch

from repro_torch.launch import dryrun as DR
from repro_torch.launch import step_analysis as SA

BIG = 100 << 20          # bytes of a storage whose making lines are kept


def main(arch="olmo-1b", shape="train_4k", mesh="single"):
    steps = []

    class Probe(SA.StepCounter):
        def __init__(self):
            super().__init__()
            self.labels = {}           # id of a live range -> its label
            self.phases = {}           # op position -> forward/backward
            self.op = ""
            steps.append(self)

        def _count(self, func, args, kwargs, result, outs):
            self.op = func._schema.name.partition("::")[2]
            backward = torch._C._current_graph_task_id() != -1
            self.phases[self._pos + 1] = "backward" if backward \
                else "forward"
            super()._count(func, args, kwargs, result, outs)

        def _make(self, t):
            super()._make(t)
            rec = self._ranges.get(t.untyped_storage()._cdata)
            if rec is None or rec[0] != self._pos:
                return
            label = self.op
            if rec[2] >= BIG:
                site = [f"{f.filename.rsplit('/', 1)[-1]}:{f.lineno}"
                        for f in traceback.extract_stack()
                        if "/repro_torch/models/" in f.filename]
                label = f"{label} @ {' < '.join(reversed(site[-2:]))}"
            self.labels[id(rec)] = label

    SA.StepCounter = Probe
    info = DR.lower_cell(arch, shape, multi_pod=mesh == "multi")
    print(f"torch {torch.__version__}: {arch} x {shape} x {mesh}: "
          f"mem_temp_bytes {info['mem_temp_bytes']}")
    for i, s in enumerate(steps):
        ranges = list(s._ranges.values())
        events = collections.Counter()
        for first, last, n in ranges:
            events[first] += n
            if last != float("inf"):
                events[last + 1] -= n
        live = peak = at = 0
        for pos in sorted(events):
            live += events[pos]
            if live > peak:
                peak, at = live, pos
        print(f"step {i}: peak {peak} at op {at} of {s._pos} "
              f"({s.phases.get(at, '?')})")
        by_label = collections.Counter()
        spans = collections.defaultdict(list)
        for rec in ranges:
            if rec[0] <= at <= rec[1]:
                label = s.labels.get(id(rec), "?")
                by_label[label] += rec[2]
                spans[label].append((rec[0], rec[1]))
        for label, n in by_label.most_common(12):
            first = min(a for a, _ in spans[label])
            last = max(b for _, b in spans[label])
            print(f"  {label:56s} {n} ({len(spans[label])} ranges, ops "
                  f"{first}..{last})")


if __name__ == "__main__":
    main(*sys.argv[1:4])
