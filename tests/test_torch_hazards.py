"""The port's happens-before hazard sanitizer (``FLEX_SANITIZE=1``).

Mirrors the sanitizer sections of ``tests/test_analysis.py`` against the
port's own ``repro_torch.analysis.hazards`` and ``repro_torch.core.connect``:
the vector clocks on stub daemons and ops (same-vstream FIFO, event and
memcpy-peer edges, host observation, free-vs-use), then live sessions.
Then the port's ``RealEngine`` serves the reduced olmo-1b in all four
modes under the sanitizer on the CPU and must find no hazard; disagg moves
its KV caches by ``memcpy_peer`` under a shared event edge.  (The JAX
file's dual-drive ``Cluster`` case has no counterpart: the port has no
simulator yet.)
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.analysis import HazardSanitizer, sanitize_enabled
from repro_torch.configs import get_config
from repro_torch.core import connect
from repro_torch.core.api import MemcpyKind, OpDescriptor, OpType
from repro_torch.models import build_model
from repro_torch.serving.engine import RealEngine
from repro_torch.serving.request import Request

torch.set_num_threads(2)


# ============================================= sanitizer: vector clocks
def _daemon_stub(device_id=0):
    return SimpleNamespace(device_id=device_id)


def _h2d(handle, vstream):
    return OpDescriptor(OpType.MEMCPY, vstream=vstream, vhandles=(handle,),
                        meta={"kind": MemcpyKind.H2D})


def _d2h(handle, vstream):
    return OpDescriptor(OpType.MEMCPY, vstream=vstream, vhandles=(handle,),
                        meta={"kind": MemcpyKind.D2H})


def test_same_stream_fifo_orders_writes():
    san, d = HazardSanitizer(), _daemon_stub()
    san.on_complete(d, _h2d(7, vstream=1))
    san.on_complete(d, _h2d(7, vstream=1))
    assert san.hazards == []


def test_unordered_cross_stream_writes_conflict():
    san, d = HazardSanitizer(), _daemon_stub()
    san.on_complete(d, _h2d(7, vstream=1))
    san.on_complete(d, _h2d(7, vstream=2))
    assert len(san.hazards) == 1
    assert "write-write hazard" in san.hazards[0]
    assert "no happens-before edge" in san.hazards[0]


def test_record_wait_event_edge_suppresses_conflict():
    san, d = HazardSanitizer(), _daemon_stub()
    san.on_complete(d, _h2d(7, vstream=1))
    san.on_complete(d, OpDescriptor(OpType.RECORD_EVENT, vstream=1,
                                    vhandles=(5,)))
    san.on_complete(d, OpDescriptor(OpType.WAIT_EVENT, vstream=2,
                                    vhandles=(5,)))
    san.on_complete(d, _h2d(7, vstream=2))
    assert san.hazards == []


def test_memcpy_peer_write_needs_shared_event_edge():
    san = HazardSanitizer()
    d0, d1 = _daemon_stub(0), _daemon_stub(1)

    def run_pair(with_edge):
        peer = OpDescriptor(OpType.MEMCPY_PEER, vstream=1, vhandles=(4,),
                            meta={"_dst_daemon": d1, "dst_handle": 9})
        san.on_complete(d0, peer)          # writes (dev1, handle 9)
        if with_edge:
            san.on_complete(d0, OpDescriptor(OpType.RECORD_EVENT, vstream=1,
                                             vhandles=(-3,)))
            san.on_complete(d1, OpDescriptor(OpType.WAIT_EVENT, vstream=1,
                                             vhandles=(-3,)))
        san.on_complete(d1, _d2h(9, vstream=1))
        return san.drain()

    hazards = run_pair(with_edge=False)
    assert len(hazards) == 1 and "write-read hazard" in hazards[0]
    san = HazardSanitizer()
    assert run_pair(with_edge=True) == []


def test_host_observation_edge_orders_later_enqueues():
    # await-then-enqueue is synchronization: result() publishes the op's
    # clock to the host, and the next enqueue snapshots it
    san, d = HazardSanitizer(), _daemon_stub()
    m1 = _h2d(7, vstream=1)
    san.on_complete(d, m1)
    m1.future.set_result(None)
    m1.future.result()
    m2 = _h2d(7, vstream=2)
    san.on_enqueue(d, m2)
    san.on_complete(d, m2)
    assert san.hazards == []


def test_completion_without_observation_publishes_nothing():
    # fire-and-forget: the op completed before the second enqueue, but
    # the host never looked — still a racy program, still reported
    san, d = HazardSanitizer(), _daemon_stub()
    m1 = _h2d(7, vstream=1)
    san.on_complete(d, m1)
    m1.future.set_result(None)
    m2 = _h2d(7, vstream=2)
    san.on_enqueue(d, m2)
    san.on_complete(d, m2)
    assert len(san.hazards) == 1
    assert "write-write hazard" in san.hazards[0]


def test_done_callback_counts_as_host_observation():
    san, d = HazardSanitizer(), _daemon_stub()
    m1 = _h2d(7, vstream=1)
    san.on_complete(d, m1)
    m1.future.add_done_callback(lambda f: None)
    m1.future.set_result(None)         # callback fires -> host edge
    m2 = _h2d(7, vstream=2)
    san.on_enqueue(d, m2)
    san.on_complete(d, m2)
    assert san.hazards == []


def test_free_vs_use_reported_and_malloc_resets():
    san, d = HazardSanitizer(), _daemon_stub()
    san.on_malloc(d, 7)
    san.on_complete(d, _h2d(7, vstream=1))
    san.on_free(d, 7)
    san.on_complete(d, _d2h(7, vstream=2))
    assert len(san.hazards) == 1
    assert "free-vs-use hazard" in san.hazards[0]
    san.drain()
    san.on_malloc(d, 7)                    # fresh allocation, clean slate
    san.on_complete(d, _h2d(7, vstream=3))
    assert san.hazards == []


# ============================================== sanitizer: live sessions
def test_sanitizer_off_by_default(monkeypatch):
    monkeypatch.delenv("FLEX_SANITIZE", raising=False)
    assert not sanitize_enabled()
    with connect(mode="flex", devices=1) as sess:
        assert sess.sanitizer is None


def test_connect_builds_one_sanitizer_a_session(monkeypatch):
    """One checker spans the session: every daemon holds the same one;
    passthrough has no daemon and no sanitizer."""
    monkeypatch.setenv("FLEX_SANITIZE", "1")
    with connect(mode="flex", devices=2) as sess:
        assert isinstance(sess.sanitizer, HazardSanitizer)
        assert all(d.sanitizer is sess.sanitizer for d in sess.daemons)
    with connect(mode="passthrough", devices=1) as sess:
        assert sess.sanitizer is None


def test_dropped_event_wait_edge_is_write_write_hazard(monkeypatch):
    monkeypatch.setenv("FLEX_SANITIZE", "1")
    sess = connect(mode="flex", devices=1)
    try:
        s1, s2 = sess.create_stream(), sess.create_stream()
        h = sess.malloc(1 << 12)
        buf = np.zeros(1 << 12, np.uint8)
        sess.memcpy(h, buf, vstream=s1)
        # the event edge a correct program would put here is deliberately
        # dropped: two same-buffer writes race across vstreams
        sess.memcpy(h, buf, vstream=s2)
        sess.synchronize(None)
        hazards = sess.sanitizer.drain()
        assert any("write-write hazard" in hz for hz in hazards)
    finally:
        sess.sanitizer.drain()
        sess.close()


def test_event_ordered_session_is_hazard_clean(monkeypatch):
    monkeypatch.setenv("FLEX_SANITIZE", "1")
    with connect(mode="flex", devices=1) as sess:
        s1, s2 = sess.create_stream(), sess.create_stream()
        ev = sess.create_event()
        h = sess.malloc(1 << 12)
        buf = np.zeros(1 << 12, np.uint8)
        sess.memcpy(h, buf, vstream=s1)
        sess.record_event(ev, s1)
        sess.wait_event(ev, s2)
        sess.memcpy(h, buf, vstream=s2)
        sess.synchronize(None)
        assert sess.sanitizer.hazards == []
    # context exit closes the session: close() itself raises on hazards


def test_session_close_raises_on_hazards(monkeypatch):
    monkeypatch.setenv("FLEX_SANITIZE", "1")
    sess = connect(mode="flex", devices=1)
    s1, s2 = sess.create_stream(), sess.create_stream()
    h = sess.malloc(1 << 12)
    buf = np.zeros(1 << 12, np.uint8)
    sess.memcpy(h, buf, vstream=s1)
    sess.memcpy(h, buf, vstream=s2)
    sess.synchronize(None)
    with pytest.raises(RuntimeError, match="happens-before hazard"):
        sess.close()


# ======================================================= the port engine
@pytest.fixture(scope="module")
def olmo():
    cfg = get_config("olmo-1b").reduced()
    model = build_model(cfg)
    return model, model.init(0, device="cpu")


def _requests(cfg, n=4, prompt=12, out=6):
    return [Request(prompt_len=prompt, max_new_tokens=out,
                    prompt_tokens=np.random.default_rng(s).integers(
                        0, cfg.vocab_size, prompt).tolist(),
                    arrival_time=s * 0.01)
            for s in range(n)]


@pytest.fixture(scope="module")
def unsanitized_tokens(olmo):
    """The engine's tokens with the sanitizer off (dynamic_pd)."""
    model, params = olmo
    reqs = _requests(model.cfg)
    eng = RealEngine(model, params, mode="dynamic_pd", max_num_seqs=2,
                     max_len=32, device="cpu")
    try:
        eng.run(reqs, timeout=120)
    finally:
        eng.shutdown()
    return [r.output_tokens for r in reqs]


@pytest.mark.parametrize("mode", ["passthrough", "static_colocate",
                                  "dynamic_pd", "disagg"])
def test_engine_is_hazard_clean(monkeypatch, olmo, unsanitized_tokens,
                                mode):
    """The reduced olmo-1b served under FLEX_SANITIZE=1: every request
    completes with the tokens of an unsanitized run, the session's
    sanitizer (none in passthrough) checked the run's ops, and it finds
    no hazard (``Session.close()`` would raise on one)."""
    monkeypatch.setenv("FLEX_SANITIZE", "1")
    model, params = olmo
    reqs = _requests(model.cfg)
    eng = RealEngine(model, params, mode=mode, max_num_seqs=2, max_len=32,
                     device="cpu")
    try:
        res = eng.run(reqs, timeout=120)
        san = eng.session.sanitizer
        if mode == "passthrough":
            assert san is None
        else:
            assert san is not None and san.hazards == []
            # every completed op advanced its own stream's component
            ops = sum(c[k] for k, c in san._stream_clock.items())
            assert ops > len(reqs)
    finally:
        eng.shutdown()
    assert res["completed"] == len(reqs) and res["failed"] == 0
    assert [r.output_tokens for r in reqs] == unsanitized_tokens
