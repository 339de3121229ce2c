"""The port's copies of JAX-free modules stay copies.

Every module the port keeps as a copy of a module of the JAX package that
imports no JAX (the virtualization layer, the control plane, the configs,
the registry, the request and cost model, the simulator stack and its
example) must equal its original once both are normalised: the package
name ``repro_torch`` read as ``repro``, parenthesised import lists joined
onto one line (the longer name rewraps them), and the reference's
pull-request tags in comments (``(PR n)``) dropped.  The only other
differences are the edits in ``EDITS``, each an exact (original, copy)
pair of text with the reason the port makes it; any other hunk fails,
so a change to either side shows here.  The JAX package is read as
text; nothing is edited or imported.
"""
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
REF = ROOT / "src" / "repro"
PORT = ROOT / "src" / "repro_torch"

# (port path, reference path) of every copy
COPIES = sorted(
    [(f"{pkg}/{p.name}", f"{pkg}/{p.name}")
     for pkg in ("core", "sched", "transport", "cache", "predict", "traffic")
     for p in (REF / pkg).glob("*.py")]
    + [(f"configs/{p.name}", f"configs/{p.name}")
       for p in (REF / "configs").glob("*.py")
       if p.name not in ("__init__.py", "registry.py")]
    + [(f"serving/{n}.py", f"serving/{n}.py")
       for n in ("__init__", "request", "costmodel", "kvcache", "realtime",
                 "fluid", "simulator")]
    + [("registry.py", "registry.py"),
       ("examples/cluster_sim_384.py", "../../examples/cluster_sim_384.py")])

# the port's sync of the card's stream where the reference blocks on JAX
_JAX_BLOCK_CLIENT = """                try:
                    import jax
                    out = jax.block_until_ready(out)
                except Exception:
                    pass
"""
_JAX_BLOCK_DAEMON = """        try:  # block like a device stream sync so exec_time is honest
            import jax
            out = jax.block_until_ready(out)
        except Exception:
            pass
"""
_SYNC_DEVICE = '''

def sync_device() -> None:
    """Wait for the work this thread queued on the card, so that an op's
    recorded time is its completion time on the card.  A CUDA error raised
    by the wait propagates to the caller (and from there to the op's
    future).  A no-op while CUDA is not initialised (CPU runs)."""
    if torch.cuda.is_initialized():
        done = torch.cuda.Event()
        done.record()               # on this thread's current stream
        done.synchronize()
'''

# module -> [(the original's text, the copy's text, why)]
EDITS = {
    "configs/base.py": [(
        "nothing here touches jax device state, so importing configs is\n"
        "always safe (dry-run sets XLA_FLAGS before any jax import).",
        "nothing here touches device state, so importing configs is\n"
        "always safe.",
        "the docstring names no JAX")],
    "core/__init__.py": [(
        "adapted to the JAX runtime boundary — DESIGN.md §2).",
        "adapted to the PyTorch runtime boundary).",
        "the comment names the port's runtime")],
    "core/session.py": [(
        "real (JAX) backend", "real (PyTorch) backend",
        "the docstring names the port's backend")],
    "core/client.py": [
        ("_payload_copy, _payload_nbytes)",
         "_payload_copy, _payload_nbytes, sync_device)",
         "sync_device: op completion on the card"),
        (_JAX_BLOCK_CLIENT,
         "                sync_device()   # completion on the card, errors "
         "included\n",
         "sync_device: op completion on the card")],
    "core/daemon.py": [
        ("executes ops on the in-process JAX backend",
         "executes ops on the in-process PyTorch backend",
         "the docstring names the port's backend"),
        ("import numpy as np\n\nfrom repro",
         "import numpy as np\nimport torch\n\nfrom repro",
         "sync_device: op completion on the card"),
        ("from repro.sched.dispatch import FIFOPolicy\n",
         "from repro.sched.dispatch import FIFOPolicy\n" + _SYNC_DEVICE,
         "sync_device: op completion on the card"),
        ('"""Executes launches in-process (CPU JAX here; TPU in production)."""',
         '"""Executes launches in-process (PyTorch on the CPU or one CUDA '
         'card)."""',
         "the docstring names the port's backend"),
        (_JAX_BLOCK_DAEMON,
         "        sync_device()   # block like a device stream sync: "
         "exec_time is honest\n",
         "sync_device: op completion on the card")],
    "core/profiler.py": [(
        "HBM_BW_BYTES = 819e9        # TPU v5e HBM bandwidth (DESIGN.md "
        "hardware model)\nPEAK_FLOPS = 197e12         # bf16 peak per chip",
        "HBM_BW_BYTES = 3.35e12      # H100 SXM HBM3 bandwidth (NVIDIA data "
        "sheet)\nPEAK_FLOPS = 989e12         # H100 SXM dense bf16 "
        "tensor-core peak (data sheet)",
        "the H100's peaks")],
    "serving/costmodel.py": [
        ("""Grounded in the DESIGN.md hardware model (TPU v5e: 197 TFLOP/s bf16, 819 GB/s
HBM, ~50 GB/s/link ICI) and the same analytic terms as EXPERIMENTS.md
§Roofline; the dry-run's compiled HLO FLOPs/bytes can be fed back in through
``calibration`` multipliers so simulated times track the compiled graphs.""",
         """The twin of ``repro/serving/costmodel.py``, the same code apart from its
import paths, its hardware constants and its derates.  The constants are
one NVIDIA H100 SXM's (NVIDIA's data sheet): 989 TFLOP/s dense bf16,
3.35 TB/s of HBM3, 80 GB of it, and NVLink at 900 GB/s a GPU, 450 GB/s
each way.  ``InstanceSpec``'s derates are fitted to the card
(``chip_smoke.py``'s ``sim`` phase; beside them, the card and the
shapes).  The analytic terms are those of the dry-run's roofline
(``launch/dryrun.py``); its traced FLOPs/bytes can be fed back in through
``calibration`` multipliers so simulated times track the traced steps.""",
         "the docstring names the H100 and its fitted derates"),
        ("""from repro.configs.base import ModelConfig

PEAK_FLOPS = 197e12          # bf16 / chip
HBM_BW = 819e9               # bytes/s / chip
ICI_BW = 50e9                # bytes/s/link
HBM_PER_CHIP = 16e9          # v5e HBM capacity""",
         """from repro.configs.base import ModelConfig
from repro.core.profiler import HBM_BW_BYTES, PEAK_FLOPS

HBM_BW = HBM_BW_BYTES        # bytes/s / chip (H100 SXM, HBM3)
# NVLink (fourth generation): 900 GB/s a GPU in both directions together
# (NVIDIA's H100 SXM data sheet), so 450 GB/s each way
ICI_BW = 450e9               # bytes/s each way, the one-directional rate
HBM_PER_CHIP = 80e9          # H100 SXM HBM capacity""",
         "the H100's constants"),
        ("""    # modeled efficiencies (MFU-style derates; calibratable)
    compute_eff: float = 0.55
    bw_eff: float = 0.75
    # fixed per-launch overhead (dispatch + host + collective setup)
    launch_overhead_s: float = 0.002
    # fraction of each step spent in non-overlapped collectives (TP/EP)
    collective_frac: float = 0.08""",
         None,                       # the copy's: instance_spec_text()
         "the derates fitted to the H100"),
        ("""

# The per-link occupancy model (LinkModel/LinkTransfer) lives in
# repro.transport; its one-release re-export from this module was removed
# — import from repro.transport (docs/api.md "KV transport & topology").
""", "\n", "the comment points at documents the port does not carry")],
    "examples/cluster_sim_384.py": [
        ("    PYTHONPATH=src python examples/cluster_sim_384.py "
         "[--arch grok-1-314b]",
         "    PYTHONPATH=src python -m repro.examples.cluster_sim_384 \\\\\n"
         "        [--arch grok-1-314b]",
         "a module of the port's package, run with -m"),
        ('import dataclasses\nimport sys\n\nsys.path.insert(0, "src")\n',
         "import dataclasses\n",
         "a module of the port's package needs no sys.path entry")],
}


def instance_spec_text() -> str:
    """The copy's ``InstanceSpec`` derates: the block from its first
    derate comment to ``collective_frac``'s line."""
    text = (PORT / "serving" / "costmodel.py").read_text()
    start = text.index("    # modeled efficiencies")
    end = text.index("    collective_frac: float = 0.08") + len(
        "    collective_frac: float = 0.08")
    return text[start:end]


def normalise(text: str) -> str:
    text = re.sub(r"\brepro_torch\b", "repro", text)
    text = re.sub(r" \(PR \d+\)", "", text)
    text = re.sub(r"\(PR \d+, ", "(", text)
    return re.sub(r"import \(([^)]*)\)",
                  lambda m: "import (" + " ".join(m.group(1).split()) + ")",
                  text)


@pytest.mark.parametrize("port,ref", COPIES, ids=[c[0] for c in COPIES])
def test_copy_equals_its_original_but_for_listed_edits(port, ref):
    want = normalise((REF / ref).read_text())
    for old, new, why in EDITS.get(port, []):
        if new is None:
            new = instance_spec_text()
        old, new = normalise(old), normalise(new)
        assert want.count(old) == 1, (port, why, old[:80])
        want = want.replace(old, new)
    got = normalise((PORT / port).read_text())
    assert got == want, "\n".join(
        line for line in __import__("difflib").unified_diff(
            want.splitlines(), got.splitlines(), "original + edits", port,
            lineterm="", n=1))


def test_every_copy_has_an_original():
    assert all((REF / ref).exists() and (PORT / port).exists()
               for port, ref in COPIES)
    # the copies cover every JAX-free package the port carries
    assert {"core/api.py", "sched/cluster.py", "transport/links.py",
            "serving/simulator.py", "traffic/workloads.py",
            "predict/latency.py", "cache/prefix.py"} <= {p for p, _ in COPIES}
