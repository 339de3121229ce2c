"""Two repaired dry-run figures: the peak of live bytes from the op
stream, and one-token decode on FSDP weights.

* The peak (``StepCounter.peak_live_bytes``): each storage a step makes
  is live from the op that makes it to the last op that touches it, or to
  the step's end if the step returns it.  A Python reference that keeps a
  tensor past its last use moves nothing (the card's torch 2.11 kept
  residual streams alive so), and a small hand-counted sequence gives its
  known peak exactly.
* The decode layout: where a rank holds few rows, the MoE region and the
  products keep FSDP weights in place and reduce partial products, as
  GSPMD does.  jamba-1.5-large-398b x long_500k on the 2 x 16 x 16 mesh is
  held against the JAX package's dry-run of the same cell (``lower_cell``
  on 512 fake host devices, in a subprocess: about 15 s): FLOPs a rank
  within 5 %, all-gather bytes at most 1.5x JAX's.  The all-gathers JAX
  adds are its attention decode's gathers of K/V blocks over the cache's
  T split, where the port combines flash-decoding statistics.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.launch import dryrun as DR
from repro_torch.launch.step_analysis import StepCounter

ROOT = Path(__file__).resolve().parents[1]
N = 256                                  # fp32 elements: 1 KiB a tensor


def hand_step(keep_alive: bool):
    """y = sum((x * 2 + 1) ** 2) on a 1 KiB input made before the step."""
    x = torch.empty(N, device="meta")
    held = []
    with StepCounter() as counter:
        a = x * 2              # op 1: a made
        b = a + 1              # op 2: b made, a's last use
        if keep_alive:
            held.append(a)     # a Python reference past a's last use
        del a
        c = b * b              # op 3: c made, b's last use
        del b
        y = c.sum()            # op 4: y made (4 B), c's last use
    counter.keep(y)
    return counter.result().peak_live_bytes


def test_peak_ignores_references_past_the_last_use():
    assert hand_step(keep_alive=True) == hand_step(keep_alive=False)


def test_peak_of_a_hand_counted_sequence():
    # live at op 2: a and b; at op 3: b and c; at op 4: c and y
    assert hand_step(keep_alive=False) == 2 * 4 * N


def test_peak_counts_outputs_to_the_end_and_in_place_writes():
    x = torch.empty(N, device="meta")
    with StepCounter() as counter:
        kept = x * 2           # op 1: returned by the step
        t = x + 1              # op 2
        t.mul_(3)              # op 3: an in-place write touches t
        u = t * t              # op 4: t's last use
        del t
        v = u.sum()            # op 5: u's last use
    counter.keep((kept, v))
    # at op 4: kept, t and u
    assert counter.result().peak_live_bytes == 3 * 4 * N


def jax_cell(arch: str, shape: str, mesh: str) -> dict:
    """The JAX package's dry-run of one cell (``tools/jax_dryrun_cells.py``'s
    ``Auto`` mesh), in a subprocess: XLA's 512 host devices are set before
    its JAX starts."""
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {str(ROOT / 'tools')!r})\n"
        "import jax_dryrun_cells as T\n"
        "from repro.launch import dryrun as JD\n"
        "JD.make_production_mesh = T.auto_mesh\n"
        f"_, info = JD.lower_cell({arch!r}, {shape!r}, "
        f"multi_pod={mesh == 'multi'})\n"
        "print(json.dumps({k: info[k] for k in ('hlo_flops', "
        "'collective_bytes')}))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def jamba_long():
    """(the port's cell, JAX's) for jamba-1.5-large-398b x long_500k x
    2 x 16 x 16."""
    port = DR.lower_cell("jamba-1.5-large-398b", "long_500k", multi_pod=True)
    return port, jax_cell("jamba-1.5-large-398b", "long_500k", "multi")


def test_fsdp_decode_flops_match_jax(jamba_long):
    port, jax = jamba_long
    assert abs(port["hlo_flops"] / jax["hlo_flops"] - 1) < 0.05, \
        (port["hlo_flops"], jax["hlo_flops"])


def test_fsdp_decode_gathers_no_whole_weight(jamba_long):
    port, jax = jamba_long
    got = port["collective_bytes"].get("all-gather", 0.0)
    want = jax["collective_bytes"]["all-gather"]
    assert got <= 1.5 * want, (got, want)
    # before the repair the MoE region gathered every expert weight's
    # embed dim for one token: 4.28e10 B a rank
    assert port["collective_bytes"]["total"] < 2 * jax[
        "collective_bytes"]["total"]


def test_training_flops_unchanged():
    """olmo-1b x train_4k on 16 x 16 still counts JAX's FLOPs a rank: the
    training step gathers its weights."""
    port = DR.lower_cell("olmo-1b", "train_4k", multi_pod=False)
    assert port["hlo_flops"] == jax_cell("olmo-1b", "train_4k",
                                         "single")["hlo_flops"]
