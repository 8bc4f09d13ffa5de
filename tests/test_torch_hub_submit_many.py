"""Run submits: ``HubSession.submit_many`` and the decoder's C runs.

The decoder's bulk-index route (writes of at least ``_NATIVE_MIN`` =
2,048 bytes) hands each run of change payloads to its pipeline's
``submit_many`` in one call where the pipeline has one: the hub's
session, which admits the run whole once its window has any room.  The
JAX ``TpuDecoder`` and the port's ``CudaDecoder(device="cpu")`` get the
same seeded wire, and the JAX hub (on ``hashlib``) and the port's (on an
injected ``hash_begin`` over ``hashlib``) the same runs.  Shapes: three
runs of 40, 40 and 30 changes with 40-200-byte values, a 100-byte blob
between runs, written in one write (about 14 KB).  Digests, tags, run
lengths, parked counts and shed verdicts are compared exactly.
"""

from __future__ import annotations

import hashlib
import threading
import time

import numpy as np
import pytest

from dat_replication_protocol_tpu.backend.tpu_backend import TpuDecoder
from dat_replication_protocol_tpu.hub import ReplicationHub as JaxHub
from dat_replication_protocol_tpu.hub import SessionShed as JaxSessionShed
from dat_replication_protocol_tpu.obs import events as jax_events
from dat_replication_protocol_tpu_torch.backend.cuda_backend import (
    CudaDecoder,
)
from dat_replication_protocol_tpu_torch.hub import ReplicationHub, SessionShed
from dat_replication_protocol_tpu_torch.obs import events, metrics
from dat_replication_protocol_tpu_torch.session.decoder import Decoder
from dat_replication_protocol_tpu_torch.wire.change_codec import (
    encode_change,
)
from dat_replication_protocol_tpu_torch.wire.framing import (
    TYPE_BLOB,
    TYPE_CHANGE,
    frame,
)

RUNS = (40, 40, 30)
BLOB = 100
WAIT = 30.0


def _h(p: bytes) -> bytes:
    return hashlib.blake2b(p, digest_size=32).digest()


def _payloads(seed: int = 7) -> list[list[bytes]]:
    rng = np.random.default_rng(seed)
    out, i = [], 0
    for n in RUNS:
        run = []
        for _ in range(n):
            value = rng.bytes(int(rng.integers(40, 201)))
            run.append(encode_change({"key": f"k{i}", "change": i,
                                      "from": i, "to": i + 1,
                                      "value": value}))
            i += 1
        out.append(run)
    return out


RUN_PAYLOADS = _payloads()
WIRE = b"".join(
    b"".join(frame(TYPE_CHANGE, p) for p in run)
    + (frame(TYPE_BLOB, bytes([k]) * BLOB) if k < len(RUNS) - 1 else b"")
    for k, run in enumerate(RUN_PAYLOADS))
CHANGES = [p for run in RUN_PAYLOADS for p in run]


class RecordingPipeline:
    """A pipeline with the run surface that records every call and
    delivers ``hashlib`` digests at once."""

    def __init__(self):
        self.calls = []

    def submit(self, payload, on_digest, tag=None):
        self.calls.append(("submit", tag, [bytes(payload)]))
        on_digest(tag, _h(bytes(payload)))

    def submit_many(self, payloads, on_digest, tag_base=0):
        payloads = [bytes(p) for p in payloads]
        self.calls.append(("submit_many", tag_base, payloads))
        for k, p in enumerate(payloads):
            on_digest(tag_base + k, _h(p))

    def submit_stream(self, stream, on_digest, tag=None):
        raise AssertionError("no blob here is long enough to stream")

    def flush(self):
        pass


def _decoders(pipelines):
    """(JAX TpuDecoder, port CudaDecoder) on the given pipelines, each
    acking every change and blob at once and recording its digests."""
    out = []
    for dec in (TpuDecoder(pipeline=pipelines[0]),
                CudaDecoder(pipeline=pipelines[1], device="cpu")):
        got = []
        dec.on_digest(lambda kind, seq, d, got=got: got.append(
            (kind, seq, d)))
        dec.change(lambda c, done: done())
        dec.blob(lambda b, done: b.collect(lambda data: done()))
        out.append((dec, got))
    return out


@pytest.fixture
def jax_native(monkeypatch):
    # the JAX decoder's C route, whatever the environment asks
    monkeypatch.delenv("DAT_NATIVE_DISABLE", raising=False)
    monkeypatch.delenv("DAT_FASTPATH_DISABLE", raising=False)


def test_each_c_run_is_one_submit_many_call_as_in_the_jax_decoder(
        jax_native):
    assert len(WIRE) >= Decoder._NATIVE_MIN
    recs = (RecordingPipeline(), RecordingPipeline())
    seen = []
    for (dec, got), rec in zip(_decoders(recs), recs):
        dec.write(WIRE)
        dec.end()
        seen.append((rec.calls, got))
    assert seen[1] == seen[0]
    calls, got = seen[1]
    changes = [c for c in calls if c[2] and c[2][0] in set(CHANGES)]
    assert [(kind, tag, len(ps)) for kind, tag, ps in changes] == [
        ("submit_many", 0, 40), ("submit_many", 40, 40),
        ("submit_many", 80, 30)]
    assert [p for _, _, ps in changes for p in ps] == CHANGES
    assert [(k, s, d) for k, s, d in got if k == "change"] == [
        ("change", i, _h(p)) for i, p in enumerate(CHANGES)]


def test_a_pipeline_without_submit_many_gets_one_submit_a_payload():
    class PerPayload(RecordingPipeline):
        submit_many = None

    rec = PerPayload()
    dec, got = _decoders((RecordingPipeline(), rec))[1]
    dec.write(WIRE)
    dec.end()
    tags = [tag for kind, tag, ps in rec.calls if ps[0] in set(CHANGES)]
    assert {kind for kind, _, _ in rec.calls} == {"submit"}
    assert tags == list(range(len(CHANGES)))
    assert [d for k, _, d in got if k == "change"] == [_h(p) for p in CHANGES]


def _gated():
    release = threading.Event()

    def hash_batch(payloads):
        release.wait(WAIT)
        return [_h(bytes(p)) for p in payloads]

    def hash_begin(payloads):
        digests = hash_batch(payloads)
        return lambda: digests

    return release, hash_batch, hash_begin


def _hub(which: str, **kw):
    release, hash_batch, hash_begin = _gated()
    if which == "jax":
        return release, JaxHub(hash_batch=hash_batch, linger_s=0.0, **kw)
    return release, ReplicationHub(hash_begin=hash_begin, linger_s=0.0, **kw)


@pytest.mark.parametrize("nowait", [False, True], ids=["blocking", "nowait"])
def test_a_run_larger_than_the_window_is_admitted_whole(nowait):
    run = RUN_PAYLOADS[0]
    got = {}
    for which in ("jax", "port"):
        release, hub = _hub(which, window_items=8)
        s = hub.register("k", nowait=nowait)
        out = []
        try:
            t = threading.Thread(target=s.submit_many, args=(
                run, lambda tag, d: out.append((tag, d)), 100))
            t.start()
            t.join(5.0)
            assert not t.is_alive(), f"{which}: submit_many blocked"
            parked = s._state.parked_items
            release.set()
            if nowait:
                deadline = time.monotonic() + WAIT
                while len(out) < len(run) and time.monotonic() < deadline:
                    s.poll()
                    time.sleep(0.005)
            s.flush()
            s.submit_many([], lambda tag, d: out.append((tag, d)), 7)
        finally:
            release.set()
            s.close()
            hub.close()
        got[which] = (parked, out)
    assert got["port"] == got["jax"]
    parked, out = got["port"]
    assert parked == len(run) > 8
    assert out == [(100 + k, _h(p)) for k, p in enumerate(run)]


def test_the_decoder_parks_the_same_run_on_both_hubs(jax_native):
    """Through the decoder: the first C run is admitted whole, then the
    writer waits on the full window; the same items are parked in both
    packages while the engine is held."""
    state = {}
    for which in ("jax", "port"):
        release, hub = _hub(which, window_items=8)
        s = hub.register("k")
        dec = (TpuDecoder(pipeline=s) if which == "jax"
               else CudaDecoder(pipeline=s, device="cpu"))
        got = []
        dec.on_digest(lambda kind, seq, d: got.append((kind, seq, d)))
        dec.change(lambda c, done: done())
        dec.blob(lambda b, done: b.collect(lambda data: done()))
        t = threading.Thread(target=lambda: (dec.write(WIRE), dec.end()))
        try:
            t.start()
            deadline = time.monotonic() + WAIT
            while (s._state.parked_items < RUNS[0]
                   and time.monotonic() < deadline):
                time.sleep(0.005)
            time.sleep(0.2)  # the writer is parked on the full window
            parked = (s._state.parked_items, s._state.parked_bytes)
            blocked = t.is_alive()
            release.set()
            t.join(WAIT)
            assert not t.is_alive()
        finally:
            release.set()
            s.close()
            hub.close()
        state[which] = (parked, blocked, got)
    assert state["port"] == state["jax"]
    (items, nbytes), blocked, got = state["port"]
    assert blocked and items == RUNS[0]
    assert nbytes == sum(len(p) for p in RUN_PAYLOADS[0])
    assert [(s, d) for k, s, d in got if k == "change"] == [
        (i, _h(p)) for i, p in enumerate(CHANGES)]


@pytest.fixture
def port_obs():
    was_on = metrics.OBS.on
    metrics.REGISTRY.reset()
    events.EVENTS.clear()
    metrics.enable()
    try:
        yield metrics
    finally:
        metrics.OBS.on = was_on
        metrics.REGISTRY.reset()
        events.EVENTS.clear()


def test_a_parked_budget_below_one_run_sheds_as_the_jax_hub(obs_enabled,
                                                            port_obs):
    run = RUN_PAYLOADS[1]
    budget = sum(len(p) for p in run) // 2
    verdicts = {}
    for which, shed_cls, log in (("jax", JaxSessionShed, jax_events.EVENTS),
                                 ("port", SessionShed, events.EVENTS)):
        log.clear()
        release, hub = _hub(which, parked_budget=budget, window_items=8)
        s = hub.register("flood")
        try:
            with pytest.raises(shed_cls) as ei:
                s.submit_many(run, lambda tag, d: None, 0)
            e = ei.value
            verdicts[which] = ((e.key, e.reason, e.parked_bytes, str(e)),
                               s.shed_reason,
                               [ev["fields"] for ev in log.events(
                                   "hub.shed")])
        finally:
            release.set()
            s.close()
            hub.close()
            log.clear()
    assert verdicts["port"] == verdicts["jax"]
    (key, reason, parked, _), shed, sheds = verdicts["port"]
    assert (key, reason, parked, shed) == (
        "flood", "parked-budget", sum(len(p) for p in run), "parked-budget")
    assert sheds == [{"key": "flood", "reason": "parked-budget",
                      "parked_bytes": parked, "sessions": 1}]
