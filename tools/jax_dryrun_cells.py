"""The JAX package's dry-run for a few cells, beside the port's (CPU).

    PYTHONPATH=src python tools/jax_dryrun_cells.py \
        [--cells olmo-1b:train_4k:single ...] [--port-dir results/dryrun_torch]

Runs ``repro/launch/dryrun.py``'s ``lower_cell`` (lower and compile on
512 fake host devices, ``hlo_analysis`` of the post-SPMD HLO) with one
change around it: the production mesh's axes are made ``Auto``.  The
installed jax's ``jax.make_mesh`` makes them ``Explicit``, which its
``with_sharding_constraint`` refuses, so the reference's own
``python -m repro.launch.dryrun`` fails every cell here.  Prints, for each
cell, JAX's per-device FLOPs, HBM bytes, collective bytes by type and
memory analysis, and the port's from its JSON under ``--port-dir``
(written by ``python -m repro_torch.launch.dryrun``), with their ratios.
"""
import argparse
import json
import os

from repro.launch import dryrun as JD   # sets XLA_FLAGS before jax starts

import jax  # noqa: E402
from jax.sharding import AxisType  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def auto_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return jax.make_mesh(shape, axes, axis_types=(AxisType.Auto,) * len(axes))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", nargs="+",
                    default=["olmo-1b:train_4k:single"])
    ap.add_argument("--port-dir", default=os.path.join(
        ROOT, "results", "dryrun_torch"))
    args = ap.parse_args()
    JD.make_production_mesh = auto_mesh
    for cell in args.cells:
        arch, shape, mesh = cell.split(":")
        _, info = JD.lower_cell(arch, shape, multi_pod=mesh == "multi")
        path = os.path.join(args.port_dir, f"{arch}__{shape}__{mesh}.json")
        port = json.load(open(path)) if os.path.exists(path) else None
        print(f"{arch} x {shape} x {mesh}: JAX compile {info['compile_s']} s")
        for key in ("hlo_flops", "hlo_bytes", "mem_argument_bytes",
                    "mem_output_bytes", "mem_temp_bytes", "mem_alias_bytes"):
            mine = port[key] if port else None
            ratio = f", port / JAX {mine / info[key]!r}" if (
                mine is not None and info[key]) else ""
            print(f"  {key}: JAX {info[key]!r}, port {mine!r}{ratio}")
        kinds = set(info["collective_bytes"]) | set(
            port["collective_bytes"] if port else ())
        for kind in sorted(kinds):
            j = info["collective_bytes"].get(kind, 0.0)
            mine = port["collective_bytes"].get(kind, 0.0) if port else None
            print(f"  collective {kind}: JAX {j!r}, port {mine!r}")


if __name__ == "__main__":
    main()
