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
        "the H100's peaks"),
        ("  * per-phase token throughput,\n", "",
         "Profiler: tokens_done, read by nothing, is gone"),
        ("import collections\n", "import bisect\nimport collections\n",
         "Timeline.to_profiler_ns: interpolates between clock anchors"),
        ("import threading\n", "import threading\nimport time\n",
         "Timeline: clock anchors"),
        ("""    ewma_bytes: float = 0.0         # bytes touched per op
    ewma_flops: float = 0.0
    ops_completed: int = 0
    tokens_done: int = 0
    busy_time: float = 0.0
""", "    ewma_bytes: float = 0.0         # bytes touched per op\n",
         "PhaseStats: fields read by nothing, updated on every completion"),
        ("""
    def compute_util(self) -> float:
        if self.ewma_exec <= 0:
            return 0.0
        return min(1.0, self.ewma_flops / self.ewma_exec / PEAK_FLOPS)
""", "", "PhaseStats.compute_util: read by nothing"),
        ("""        if "flops" in op.meta:
            s.ewma_flops = self._ewma(s.ewma_flops, float(op.meta["flops"]))
        s.ops_completed += 1
        s.tokens_done += int(op.meta.get("tokens", 0))
        s.busy_time += op.exec_time
        if op.op == OpType.LAUNCH:
            self._busy_events.append((op.dispatch_time, op.complete_time))
""", """        if op.op == OpType.LAUNCH:
            self._busy_events.append((op.dispatch_time, op.complete_time))
            # what ended before the horizon adds nothing to a later
            # device_utilization(now >= complete_time): keep the deque short
            lo = op.complete_time - self.horizon
            while self._busy_events and self._busy_events[0][1] < lo:
                self._busy_events.popleft()
""", "Profiler.on_complete: no unread counters; _busy_events trimmed to "
         "the horizon (only device_utilization trimmed it, and only the "
         "simulator calls that, so a serving process grew it for life)"),
        ("""
    def snapshot(self) -> Dict[str, Dict[str, float]]:
        return {
            p.value: {
                "ewma_exec": s.ewma_exec,
                "ewma_queue_delay": s.ewma_queue_delay,
                "bandwidth_util": s.bandwidth_util(),
                "compute_util": s.compute_util(),
                "ops": s.ops_completed,
                "tokens": s.tokens_done,
            } for p, s in self.stats.items()
        }
""", "", "Profiler.snapshot: read by nothing"),
        ("""_TRACE_IDS = itertools.count(1)
""", """_TRACE_IDS = itertools.count(1)

# the Timeline of the session being traced, for code that holds no session
# (the model's step, a benchmark's readers): set when a Timeline starts,
# cleared when it is written out; None while FLEX_PROFILE is off
ACTIVE: Optional["Timeline"] = None


def _clock_anchor() -> Tuple[int, int]:
    \"\"\"(monotonic ns, Unix ns) read back to back, the Unix reading the
    mean of two taken around the monotonic one.\"\"\"
    a = time.time_ns()
    m = time.monotonic_ns()
    b = time.time_ns()
    return m, (a + b) // 2
""", "spans: the process-level accessor and the clock anchors"),
        ("""    turning it on perturbs (wall-clock) timing but never simulated time.
    \"\"\"

    def __init__(self):
        self._lk = threading.Lock()
        self._events: List[dict] = []
""", """    turning it on perturbs (wall-clock) timing but never simulated time.

    The same list holds the host's spans and counters
    (``repro.core.spans``), on the ops' monotonic clock;
    :meth:`to_profiler_ns` maps that clock onto torch.profiler's.
    \"\"\"

    def __init__(self):
        global ACTIVE
        self._lk = threading.Lock()
        self._events: List[dict] = []
        self._anchors: List[Tuple[int, int]] = [_clock_anchor()]
        ACTIVE = self
""", "spans: one recorder for ops, spans and counters, reachable from "
         "code that holds no session"),
        ("""        with self._lk:
            self._events.append(ev)

    def events(self) -> List[dict]:
        with self._lk:
            return list(self._events)
""", """        with self._lk:
            self._events.append(ev)
        step = op.meta.get("_step")     # a traced model step (core/spans.py)
        if step is not None:
            step.complete(self, op)

    def add(self, ev: dict) -> None:
        \"\"\"Append a span or counter event.\"\"\"
        with self._lk:
            self._events.append(ev)

    def events(self) -> List[dict]:
        anchor = _clock_anchor()
        with self._lk:
            self._anchors.append(anchor)
            return list(self._events)

    def to_profiler_ns(self, mono_ns: float) -> float:
        \"\"\"A time on this timeline's clock (monotonic ns) on the clock
        torch.profiler stamps CUDA activity with (Unix ns): the offset
        between the two interpolated between the anchor pairs around it,
        read when the timeline started and whenever it was read.\"\"\"
        with self._lk:
            anchors = list(self._anchors)
        i = bisect.bisect_right([m for m, _ in anchors], mono_ns)
        if i == 0 or i == len(anchors):
            m, u = anchors[min(i, len(anchors) - 1)]
            return mono_ns + (u - m)
        (m0, u0), (m1, u1) = anchors[i - 1], anchors[i]
        f = (mono_ns - m0) / (m1 - m0)
        return mono_ns + (u0 - m0) + f * ((u1 - m1) - (u0 - m0))
""", "spans: a traced step's spans written once its op completes (their "
         "CUDA events resolved, the op's id known); span and counter "
         "events; the map onto the device trace's clock"),
        ("""        \"\"\"Write the Chrome-trace file; returns the path written.\"\"\"
        if path is None:""", """        \"\"\"Write the Chrome-trace file; returns the path written.\"\"\"
        global ACTIVE
        if ACTIVE is self:
            ACTIVE = None
        if path is None:""", "spans: a written timeline is no longer the "
         "active one")],
    "sched/dispatch.py": [(
        """            p = self.latency.predict(op.phase.value, tokens,
                                     float(op.meta.get("ctx", tokens)))
""", """            ctx = op.meta.get("ctx", tokens)
            if isinstance(ctx, list):   # each row's, stamped only while
                ctx = tokens            # traced: read as if untraced
            p = self.latency.predict(op.phase.value, tokens, float(ctx))
""", "a decode op's ctx, stamped only while traced, holds each row's "
        "context length: ignored, so that tracing changes no prediction "
        "(an untraced decode op carries none)")],
    "predict/features.py": [(
        """        ctx = float(args.get("ctx", tokens) or tokens)
""", """        ctx = args.get("ctx", tokens) or tokens
        if isinstance(ctx, list):   # each row's, stamped only while
            ctx = tokens            # traced: read as if untraced
        ctx = float(ctx)
""", "a decode op's ctx, stamped only while traced, holds each row's "
        "context length: ignored, so that a predictor fitted from a "
        "timeline learns the feature an untraced op supplies")],
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
