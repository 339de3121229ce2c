"""Trace every arch's ``.reduced()`` config through the dry-run on small
fake meshes: a quick check that DTensor lays out every op of every step
kind, on whichever torch the machine has (the card's and the CPU's differ).

    PYTHONPATH=src python3 scripts/dryrun_smoke.py [--archs a,b] \
        [--kinds train,prefill,decode] [--meshes dm,pdm]

``dm`` is a (2, 2) (data, model) mesh, ``pdm`` a (2, 2, 2) (pod, data,
model) one; the steps are 8 sequences of 64 tokens.  Prints one line a
cell, OK with its per-rank FLOPs, collective bytes, peak temporary bytes
and trace seconds, or FAIL with the op that stopped it; exits 1 if any
failed.
"""
import argparse
import sys
import time

from repro_torch.configs import get_config, list_archs
from repro_torch.configs.base import MeshConfig, ShapeConfig, ShapeKind
from repro_torch.launch.dryrun import trace_cell

MESHES = {"dm": MeshConfig((2, 2), ("data", "model")),
          "pdm": MeshConfig((2, 2, 2), ("pod", "data", "model"))}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--archs", default=",".join(list_archs()))
    ap.add_argument("--kinds", default="train,prefill,decode")
    ap.add_argument("--meshes", default="dm,pdm")
    args = ap.parse_args()
    failed = 0
    for arch in args.archs.split(","):
        cfg = get_config(arch).reduced()
        for kind in args.kinds.split(","):
            for name in args.meshes.split(","):
                t0 = time.monotonic()
                try:
                    info = trace_cell(cfg, ShapeConfig(
                        "smoke", 64, 8, ShapeKind(kind)), MESHES[name])
                except Exception as e:   # a cell's failure names its op
                    failed += 1
                    print(f"FAIL {arch} {kind} {name}: "
                          f"{str(e).splitlines()[0][:400]}", flush=True)
                    continue
                print(f"OK   {arch} {kind} {name}: flops "
                      f"{info['hlo_flops']:.4e}, collectives "
                      f"{info['collective_bytes']['total']:.4e} B, temp "
                      f"{info['mem_temp_bytes']} B, "
                      f"{time.monotonic() - t0:.1f} s", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
