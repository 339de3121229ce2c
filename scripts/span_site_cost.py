#!/usr/bin/env python3
"""What an instrumented site of the serving path costs with tracing off.

    PYTHONPATH=src python3 scripts/span_site_cost.py [--n 2000000]

Times, with ``FLEX_PROFILE`` off (``profiler.ACTIVE`` is None, the
engine's ``timeline`` None), the two shapes a site takes in the port
(``core/spans.py``): a model site (a module-level load, a None check, and
the check that closes the span) and an engine site (the same on an
attribute of the engine), each against an empty statement, best of
``--repeat`` runs of ``--n`` executions; prints ns a site.  Sites a
decode step runs: two a layer (mixer and FFN) and the logits in the
model, five in the engine (launch, completion, slot fill).
"""
import argparse
import sys
import timeit
from pathlib import Path
from types import SimpleNamespace

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import profiler as _prof  # noqa: E402
from repro_torch.core import spans as _spans  # noqa: E402

MODEL_SITE = """\
sp = None if _prof.ACTIVE is None else _spans.model_span("attention", layer=0)
if sp is not None:
    sp.close()
"""
ENGINE_SITE = """\
tl = eng.timeline
sp = None if tl is None else _spans.Span(tl, "engine.submit", {"req_id": 1})
if sp is not None:
    sp.close()
"""


def per_site_ns(stmt: str, n: int, repeat: int, ns: dict) -> float:
    best = min(timeit.repeat(stmt, number=n, repeat=repeat, globals=ns))
    bare = min(timeit.repeat("pass", number=n, repeat=repeat, globals=ns))
    return (best - bare) / n * 1e9


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=2_000_000)
    ap.add_argument("--repeat", type=int, default=7)
    args = ap.parse_args(argv)
    if _prof.ACTIVE is not None:
        raise SystemExit("a Timeline is active: this times the off path")
    ns = {"_prof": _prof, "_spans": _spans,
          "eng": SimpleNamespace(timeline=None)}
    for name, stmt in (("model", MODEL_SITE), ("engine", ENGINE_SITE)):
        print(f"{name} site, tracing off: "
              f"{per_site_ns(stmt, args.n, args.repeat, ns):.1f} ns")
    return 0


if __name__ == "__main__":
    sys.exit(main())
