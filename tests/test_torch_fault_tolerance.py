"""The port's fault tolerance against the JAX package's.

* ``run_with_restarts`` as ``tests/test_checkpoint.py`` drives it (a
  deterministic step function failing at three steps ends on the
  uninterrupted state), beside the reference's loop on the same
  failures; a failure before the first save; the restart budget.
* ``run_with_restarts`` over the port's own train step on olmo-1b
  ``.reduced()``: AdamW updates the parameters and moments in place, so
  a failure raised after a step has written into the state must still
  leave the loop with the checkpoint's values.  The final parameters
  and optimizer state equal an uninterrupted run's bit for bit; that run
  draws its own parameters from the same seed (shared ones would be
  updated twice in place).
* ``HeartbeatMonitor`` and ``StragglerStats`` give the reference's
  answers on the same stub clusters and step-time dicts.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as JaxCheckpointer
from repro.distributed import fault_tolerance as JFT
from repro_torch import tree as TR
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config
from repro_torch.distributed import fault_tolerance as FT
from repro_torch.models import build_model
from repro_torch.training import (AdamWConfig, TrainConfig,
                                  init_train_state, make_batch,
                                  make_train_step)

torch.set_num_threads(2)


def counter_step(step, state):
    """The reference test's deterministic step function."""
    return {"x": state["x"] + step, "n": state["n"] + 1}


def flaky(step_fn, fail_at, calls, *, after=(), exc=FT.InjectedFailure):
    """step_fn raising ``exc`` once at each step of ``fail_at`` (before it
    runs) and of ``after`` (after it has run: an in-place step has then
    written into the state)."""
    fail_at, after = set(fail_at), set(after)

    def fn(step, state):
        if step in fail_at:
            fail_at.discard(step)
            raise exc(f"node died at {step}")
        calls["n"] += 1
        out = step_fn(step, state)
        if step in after:
            after.discard(step)
            raise exc(f"node died after {step}")
        return out
    return fn


def test_run_with_restarts_identical_to_uninterrupted(tmp_path):
    """Checkpoint/restart fault tolerance: the final state after injected
    failures equals the uninterrupted run (deterministic step_fn), and the
    reference's loop's on the same failures."""
    clean = {"x": torch.tensor(0.0, dtype=torch.float64),
             "n": torch.tensor(0)}
    for i in range(30):
        clean = counter_step(i, clean)

    calls = {"n": 0}
    ck = Checkpointer(str(tmp_path / "ft"), keep=3)
    out = FT.run_with_restarts(
        30, flaky(counter_step, {7, 19, 23}, calls),
        {"x": torch.tensor(0.0, dtype=torch.float64), "n": torch.tensor(0)},
        ck, save_every=5)
    assert float(out["x"]) == float(clean["x"])
    assert int(out["n"]) == int(clean["n"])
    assert calls["n"] >= 30  # some steps were re-executed after restore

    jcalls = {"n": 0}
    jck = JaxCheckpointer(str(tmp_path / "jax"), keep=3)
    jout = JFT.run_with_restarts(
        30, flaky(counter_step, {7, 19, 23}, jcalls,
                  exc=JFT.InjectedFailure),
        {"x": np.asarray(0.0), "n": np.asarray(0)}, jck, save_every=5)
    assert float(out["x"]) == float(jout["x"])
    assert int(out["n"]) == int(jout["n"])
    assert calls == jcalls        # the same steps re-executed


def test_failure_before_the_first_save_restarts_from_the_initial_state(
        tmp_path):
    """Step 0 is committed before the first step: a failure at step 3,
    before the first save at step 5, restarts from the initial state, not
    from what steps 0-2 left (the reference resumes from step 0 with that
    state)."""
    calls = {"n": 0}
    out = FT.run_with_restarts(
        6, flaky(counter_step, {3}, calls),
        {"x": torch.tensor(0.0, dtype=torch.float64), "n": torch.tensor(0)},
        Checkpointer(str(tmp_path), keep=2), save_every=5)
    assert (float(out["x"]), int(out["n"])) == (15.0, 6)
    assert calls["n"] == 9        # steps 0-2 ran twice


def test_restart_budget_is_bounded(tmp_path):
    def always(step, state):
        raise FT.InjectedFailure("down")
    with pytest.raises(FT.InjectedFailure):
        FT.run_with_restarts(3, always, {"x": torch.zeros(2)},
                             Checkpointer(str(tmp_path)), max_restarts=2)


def test_straggler_stats():
    s = FT.StragglerStats(threshold=2.0)
    assert s.stragglers({"a": 1.0, "b": 1.1, "c": 5.0}) == ["c"]
    assert s.stragglers({"a": 1.0}) == []


def test_straggler_stats_match_jax():
    rng = np.random.default_rng(0)
    for _ in range(200):
        n = int(rng.integers(0, 7))
        times = {f"i{k}": float(v) for k, v in enumerate(
            rng.choice([0.0, -1.0, 1.0, 2.0, 5.0], n)
            * rng.uniform(0.5, 1.5, n))}
        threshold = float(rng.uniform(1.0, 3.0))
        assert FT.StragglerStats(threshold).stragglers(times) == \
            JFT.StragglerStats(threshold).stragglers(times), times


# ----------------------------------------------------------- heartbeats
@dataclasses.dataclass
class StubDaemon:
    last_heartbeat: float
    oldest: object

    def oldest_pending_time(self):
        return self.oldest


@dataclasses.dataclass
class StubInstance:
    name: str
    daemon: StubDaemon
    failed: bool = False


class StubCluster:
    def __init__(self, rows):
        self.instances = [StubInstance(f"C{k}", StubDaemon(last, oldest),
                                       failed)
                          for k, (last, oldest, failed) in enumerate(rows)]
        self.calls = []

    def fail_instance(self, name):
        self.calls.append(name)
        next(i for i in self.instances if i.name == name).failed = True


def test_heartbeat_monitor_matches_jax():
    rng = np.random.default_rng(0)
    for _ in range(200):
        rows = [(float(rng.choice([-1.0, 0.0, 1.0, 4.0, 9.0])),
                 None if rng.random() < 0.3 else float(rng.uniform(0, 9)),
                 bool(rng.random() < 0.2))
                for _ in range(int(rng.integers(1, 6)))]
        now, timeout = float(rng.uniform(0, 12)), float(rng.uniform(1, 5))
        ours, theirs = StubCluster(rows), StubCluster(rows)
        got = FT.HeartbeatMonitor(timeout).check(ours, now)
        want = JFT.HeartbeatMonitor(timeout).check(theirs, now)
        assert got == want == ours.calls == theirs.calls, (rows, now)


def test_heartbeat_monitor_skips_idle_and_failed_instances():
    cluster = StubCluster([(0.0, 1.0, False),    # waiting, silent: dead
                           (9.0, 1.0, False),    # completed recently
                           (0.0, None, False),   # idle
                           (0.0, 1.0, True)])    # already failed
    assert FT.HeartbeatMonitor(timeout_s=2.0).check(cluster, 10.0) == ["C0"]


# --------------------------------------- restarts over the port's train step
STEPS, B, S = 6, 2, 32


def train_state(cfg, seed=0):
    model = build_model(cfg)
    tcfg = TrainConfig(opt=AdamWConfig(lr=1e-3, warmup_steps=2,
                                       total_steps=STEPS))
    params, opt = init_train_state(model, tcfg, seed, device="cpu")
    return make_train_step(model, tcfg), {"params": params, "opt": opt}


def step_with(cfg, train_step):
    def step_fn(step, state):
        batch = {k: torch.from_numpy(v) for k, v in
                 make_batch(cfg, B, S, step=step).items()}
        params, opt, _ = train_step(state["params"], state["opt"], batch)
        return {"params": params, "opt": opt}
    return step_fn


def test_restarts_over_the_train_step_end_bit_for_bit(tmp_path):
    cfg = get_config("olmo-1b").reduced()
    train_step, clean = train_state(cfg)
    run = step_with(cfg, train_step)
    for i in range(STEPS):
        clean = run(i, clean)

    train_step, state = train_state(cfg)   # its own draw from the seed
    first = [t.clone() for t in TR.leaves(state)]
    calls = {"n": 0}
    # step 1 fails after writing, before the first save (step 2): the
    # restart must read step 0 back; step 4 fails before it runs; step 3
    # fails after writing into the state restored at step 2
    out = FT.run_with_restarts(
        STEPS, flaky(step_with(cfg, train_step), {4}, calls, after={1, 3}),
        state, Checkpointer(str(tmp_path), keep=2), save_every=2)
    assert calls["n"] == STEPS + 4        # steps 0-3 ran twice
    got, want = TR.flatten_with_paths(out), TR.flatten_with_paths(clean)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    assert int(out["opt"]["step"]) == STEPS
    # the run moved the parameters (the check is not of an idle state)
    assert not all(torch.equal(a, b) for a, b in
                   zip(first, TR.leaves(out)))


def test_restarts_resume_a_finished_directory(tmp_path):
    """A second run on the same directory resumes from its latest
    committed step and ends on the uninterrupted run."""
    cfg = get_config("olmo-1b").reduced()
    train_step, clean = train_state(cfg)
    run = step_with(cfg, train_step)
    for i in range(STEPS):
        clean = run(i, clean)
    ck = Checkpointer(str(tmp_path), keep=2)
    train_step, state = train_state(cfg)
    FT.run_with_restarts(STEPS - 2, step_with(cfg, train_step), state, ck,
                         save_every=2)
    train_step, state = train_state(cfg, seed=1)   # overwritten by restore
    calls = {"n": 0}
    out = FT.run_with_restarts(STEPS, flaky(step_with(cfg, train_step), (),
                                            calls), state, ck, save_every=2)
    assert calls["n"] == 2
    assert all(torch.equal(a, b) for a, b in
               zip(TR.leaves(out), TR.leaves(clean)))
