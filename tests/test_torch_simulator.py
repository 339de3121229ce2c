"""The port's cluster simulator against the JAX package's, in one process.

``repro_torch``'s simulator stack (``serving/{simulator,fluid,kvcache,
realtime}.py``, ``transport``, ``cache``, ``predict``, ``traffic`` and
``launch/serve.py::run_sim``) is a copy of the reference's (held text for
text by ``tests/test_torch_copies.py``) run on the port's H100 cost model.
With the reference's constants patched into the port's cost model (its
TPU v5e peaks and ``InstanceSpec``'s derates), every result must equal the
reference's key for key, floats included: the stepped drive is
deterministic.  At the port's own constants each cell's result differs,
which shows the constants are read.  No case asserts a wall-clock time:
the threaded drive's case asserts completion only.
"""
import dataclasses
import functools
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import repro.serving.costmodel as RC
import repro_torch.serving.costmodel as PC
import repro_torch.serving.simulator as PS
from repro.launch.serve import run_sim as ref_run_sim
from repro_torch.launch.serve import run_sim as port_run_sim

ROOT = Path(__file__).resolve().parents[1]
ARCH = "mixtral-8x7b"
CELLS = [("dynamic", "1k1k"), ("6p2d", "1k1k"), ("role_switch", "1k1k"),
         ("static_colocate", "1k1k"), ("dynamic", "1k4k"),
         ("dynamic", "bursty")]


@pytest.fixture
def reference_constants(monkeypatch):
    """The port's cost model on the reference's constants and derates."""
    for name in ("PEAK_FLOPS", "HBM_BW", "ICI_BW", "HBM_PER_CHIP"):
        monkeypatch.setattr(PC, name, getattr(RC, name))
    spec = RC.InstanceSpec("reference", 1)
    monkeypatch.setattr(PS, "InstanceSpec", functools.partial(
        PC.InstanceSpec, **{f.name: getattr(spec, f.name)
                            for f in dataclasses.fields(spec)
                            if f.name not in ("name", "chips")}))


def assert_same(want, got, path="result"):
    """Equal key for key and value for value (NaN equal to NaN)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(want) == set(got), \
            (path, set(want) ^ set(got))
        for k in want:
            assert_same(want[k], got[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(want) == len(got), path
        for i, (w, g) in enumerate(zip(want, got)):
            assert_same(w, g, f"{path}[{i}]")
    elif isinstance(want, float) and math.isnan(want):
        assert isinstance(got, float) and math.isnan(got), path
    else:
        assert want == got, (path, want, got)


def ref_and_port():
    """Both packages' serving, traffic and config modules."""
    import repro.configs as RCF
    import repro.serving as RS
    import repro.traffic as RT
    import repro_torch.configs as PCF
    import repro_torch.serving as PSV
    import repro_torch.traffic as PT
    return (RCF, RS, RT), (PCF, PSV, PT)


# ------------------------------------------------------------- run_sim
@pytest.mark.parametrize("deployment,workload", CELLS,
                         ids=[f"{d}-{w}" for d, w in CELLS])
def test_run_sim_equals_the_reference(reference_constants, deployment,
                                      workload):
    want = ref_run_sim(ARCH, deployment, workload, verbose=False)
    got = port_run_sim(ARCH, deployment, workload, verbose=False)
    assert got["completed"] == want["completed"] > 0
    assert got["failed"] == 0
    assert_same(want, got)


@pytest.mark.parametrize("deployment", ["dynamic", "6p2d"])
def test_h100_constants_are_read(deployment):
    """At the port's own constants (H100 peaks, fitted derates) the same
    cell completes every request but times them otherwise."""
    want = ref_run_sim(ARCH, deployment, "1k1k", verbose=False)
    got = port_run_sim(ARCH, deployment, "1k1k", verbose=False)
    assert got["completed"] == want["completed"] == 2000
    assert got["failed"] == 0
    assert got["ttft_mean_s"] != want["ttft_mean_s"]
    assert got["tpot_mean_s"] != want["tpot_mean_s"]


def test_sim_cli_runs_without_jax(tmp_path):
    """``python -m repro_torch.launch.serve --sim`` with ``jax`` and
    ``repro`` blocked (a meta-path finder that raises on either)."""
    script = tmp_path / "blocked.py"
    script.write_text(
        "import importlib.abc, runpy, sys\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'repro'):\n"
        "            raise ImportError(f'blocked: {name}')\n"
        "sys.meta_path.insert(0, Block())\n"
        "sys.argv = ['serve', '--sim', '--arch', 'mixtral-8x7b',\n"
        "            '--deployment', 'role_switch', '--workload', 'bursty']\n"
        "runpy.run_module('repro_torch.launch.serve', run_name='__main__')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, str(script)], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "completed: 640" in out.stdout and "failed: 0" in out.stdout


# ---------------------------------------------------- the other parts
def run_both(build):
    """``build(configs, serving, traffic)`` -> result, on both sides."""
    ref, port = ref_and_port()
    return build(*ref), build(*port)


def test_fluid_fidelity_equals_the_reference(reference_constants):
    def build(cf, sv, tr):
        cluster = sv.Cluster(cf.get_config(ARCH), sv.deployment_dynamic(),
                             sim_cfg=sv.SimConfig(fidelity="fluid"))
        return cluster.run(tr.deepseek_1k1k(), until=7200)
    want, got = run_both(build)
    assert want["fidelity"] == "fluid" and got["completed"] == 2000
    assert_same(want, got)


def test_predictors_equal_the_reference(reference_constants):
    """A bootstrap-fitted latency predictor with adaptive chunking, and the
    online length predictor."""
    def build(cf, sv, tr):
        deploy = dataclasses.replace(
            sv.deployment_dynamic(), latency_predictor="ridge_latency",
            length_predictor="length_quantile", adaptive_chunking=True)
        cluster = sv.Cluster(cf.get_config(ARCH), deploy,
                             sim_cfg=sv.SimConfig(chunk_prefill_tokens=512))
        res = cluster.run(tr.deepseek_1k1k(n=400), until=7200)
        return res, cluster.latency_model.report()
    (want, want_report), (got, got_report) = run_both(build)
    assert got["completed"] == 400
    assert_same(want, got)
    assert_same(want_report, got_report)


def test_prefix_tour_equals_the_reference(reference_constants):
    """``cluster_sim_384.py``'s prefix tour: multi_turn traffic under
    prefix_affinity routing and an lru prefix cache, both deployments."""
    def build(cf, sv, tr):
        out = {}
        for name, deploy in (("6p2d", sv.deployment_6p2d()),
                             ("dynamic", sv.deployment_dynamic())):
            deploy = dataclasses.replace(deploy,
                                         cluster_policy="prefix_affinity")
            cluster = sv.Cluster(cf.get_config(ARCH), deploy,
                                 sim_cfg=sv.SimConfig(prefix_cache="lru"))
            out[name] = cluster.run(tr.make_traffic("multi_turn", n=80),
                                    until=72000)
            cluster.check_kv_conservation()
        return out
    want, got = run_both(build)
    assert got["dynamic"]["prefix_cache"]["hit_rate"] > 0.5
    assert_same(want, got)


def test_threaded_drive_completes():
    """The threaded drive on the port's constants: every request completes
    (no timing asserted)."""
    res = port_run_sim(ARCH, "dynamic", "bursty", verbose=False,
                       drive="threaded")
    assert res["completed"] == 640 and res["failed"] == 0


def request_fields(reqs):
    """Each request's fields but its id (a process-wide counter)."""
    keep = ("prompt_len", "max_new_tokens", "arrival_time",
            "prompt_tokens", "tenant", "slo", "priority")
    return [{k: (v.tolist() if isinstance(v, np.ndarray) else v)
             for k in keep if hasattr(r, k)
             for v in (getattr(r, k),)} for r in reqs]


TRAFFIC = [("bursty_phase_shift", {}), ("deepseek_1k1k", {}),
           ("deepseek_1k4k", {}), ("multi_turn", {}), ("qwen_grid", {}),
           ("tiered", {}), ("tiered_burst", {}),
           ("open_loop", dict(n=64, input_len=512, output_len=128, rate=8.0,
                              seed=5, arrival="gamma", cv=2.0))]


@pytest.mark.parametrize("name,knobs", TRAFFIC, ids=[t[0] for t in TRAFFIC])
def test_traffic_generators_equal_the_reference(name, knobs):
    import repro.traffic as RT
    import repro_torch.traffic as PT
    assert PT.list_traffic() == RT.list_traffic()
    want = RT.make_traffic(name, **knobs)
    got = PT.make_traffic(name, **knobs)
    if isinstance(want, dict):              # qwen_grid: {cell: requests}
        assert set(want) == set(got)
        want = [r for k in sorted(want) for r in want[k]]
        got = [r for k in sorted(got) for r in got[k]]
    assert len(want) == len(got) > 0
    w, g = request_fields(want), request_fields(got)
    for a, b in zip(w, g):
        if "slo" in a:
            a["slo"], b["slo"] = (dataclasses.asdict(a["slo"]) if a["slo"]
                                  else None, dataclasses.asdict(b["slo"])
                                  if b["slo"] else None)
    assert_same(w, g)


def test_closed_loop_pools_equal_the_reference():
    import repro.traffic as RT
    import repro_torch.traffic as PT
    want = RT.make_traffic("closed_loop", users=6, requests_per_user=3)
    got = PT.make_traffic("closed_loop", users=6, requests_per_user=3)
    issued = []
    for pool in (want, got):
        reqs = pool.initial()
        out = request_fields(reqs)
        for r in reqs:                      # each user's next request
            nxt = pool.on_complete(r, 1.0)
            out += request_fields([nxt] if nxt is not None else [])
        issued.append([{k: v for k, v in r.items() if k != "slo"}
                       for r in out])
    assert_same(*issued)


def test_link_model_shares_equal_the_reference():
    """Three flows over a shared spine, one at half share: every poll, eta
    and the per-link stats."""
    from repro.transport import LinkModel as RL, make_topology as RTop
    from repro_torch.transport import LinkModel as PL, make_topology as PTop
    runs = []
    for LinkModel, make_topology in ((RL, RTop), (PL, PTop)):
        topo = make_topology("shared_spine", spine_bw=4e9, n_spines=2)
        lm = LinkModel(bw=50e9, latency_s=1e-3, topology=topo)
        log = []
        xs = [lm.start(topo.path("P0", "D0"), 8e9, 0.0),
              lm.start(topo.path("P1", "D0"), 4e9, 0.1, share=0.5),
              lm.start(topo.path("P2", "D1"), 2e9, 0.2)]
        for t in np.arange(0.25, 8.0, 0.25):
            log.append([(lm.poll(x, float(t)), lm.eta(x, float(t)))
                        for x in xs])
        log.append(json.loads(json.dumps(lm.stats(), default=str)))
        runs.append(log)
    assert_same(*runs)


def test_paged_allocator_equals_the_reference():
    from repro.serving.kvcache import OutOfPages as RO, PagedAllocator as RA
    from repro_torch.serving.kvcache import (OutOfPages as PO,
                                             PagedAllocator as PA)
    runs = []
    for Alloc, OutOfPages in ((RA, RO), (PA, PO)):
        a = Alloc(num_pages=16, page_size=4)
        log = [a.allocate(1, 10), a.allocate(2, 7)]
        log += [a.append(1) for _ in range(5)]
        a.pin(log[0][0])
        log += [a.free(1), a.free_pages, a.used_tokens(),
                a.pin_count(log[0][0]), a.unpin(log[0][0])]
        try:
            a.allocate(3, 100)
        except OutOfPages as e:
            log.append(f"out of pages: {e}")
        log += [a.allocate(4, 20), a.page_table(2), a.page_table(4),
                a.shared_pages()]
        a.check_invariants()
        runs.append(log)
    assert_same(*runs)


def test_latency_fit_on_a_timeline_trace_equals_the_reference(tmp_path):
    """A synthetic trace written by the port's ``Timeline`` (the shape the
    engine's ``FLEX_PROFILE=1`` traces take): both packages' samples and
    fitted coefficients are equal."""
    from repro.predict import LatencyModel as RL
    from repro.predict import load_samples as r_load
    from repro_torch.core.api import OpDescriptor, OpType, Phase
    from repro_torch.core.profiler import Timeline
    from repro_torch.predict import LatencyModel as PL
    from repro_torch.predict import load_samples as p_load
    rng = np.random.default_rng(0)
    tl, t = Timeline(), 0.0
    for i in range(60):
        prefill = i % 3 == 0
        tokens = int(rng.integers(64, 2048)) if prefill else \
            int(rng.integers(1, 5))
        ctx = tokens if prefill else int(rng.integers(100, 1000))
        dur = (2e-3 + 6e-6 * tokens if prefill
               else 1.5e-2 + 1e-6 * ctx * tokens) * rng.uniform(0.95, 1.05)
        op = OpDescriptor(OpType.LAUNCH,
                          Phase.PREFILL if prefill else Phase.DECODE,
                          meta={"tokens": tokens, "ctx": ctx, "req_id": i})
        op.enqueue_time = op.dispatch_time = t
        op.complete_time = t + dur
        tl.record(0, op)
        t += dur
    path = tl.dump(str(tmp_path / "flextrace.json"))
    want, got = r_load(path), p_load(path)
    assert len(got) == 60
    assert [dataclasses.astuple(s) for s in want] == \
        [dataclasses.astuple(s) for s in got]
    rm, pm = RL(), PL()
    assert_same(rm.fit(want), pm.fit(got))
    assert_same(rm.report(), pm.report())
    assert pm.predict("prefill", 1000, 1000) == rm.predict("prefill", 1000,
                                                           1000)


# --------------------------------------------------------- the example
def test_cluster_sim_384_example_runs_to_its_summary():
    """``python -m repro_torch.examples.cluster_sim_384 --requests 80`` (the
    prefix tour) runs on the CPU to its summary line."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.cluster_sim_384",
         "--requests", "80", "--traffic", "multi_turn", "--cluster-policy",
         "prefix_affinity", "--prefix-cache", "lru"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert any("dynamic vs disagg" in line for line in lines), out.stdout
    hits = [float(line.split("hit_rate=")[1].split()[0]) for line in lines
            if "hit_rate=" in line]
    assert hits and min(hits) > 0.5, out.stdout
