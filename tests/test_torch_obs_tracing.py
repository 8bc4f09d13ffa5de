"""The port's spans, profiler ranges and flight recorder.

Span nesting, the error field and the Chrome trace export are held
against the JAX package's on the same sequence of spans, with
timestamps, ids, thread ids and sequence numbers removed.
``utils.trace.span`` must show up under a CPU ``torch.profiler``
capture, and be the shared null span when neither a profiler nor the
gate is on.  Flight bundles must read back through the JAX package's
``read_bundle``.
"""

import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import dat_replication_protocol_tpu_torch as protocol
from dat_replication_protocol_tpu.obs import flight as jax_flight
from dat_replication_protocol_tpu.obs import tracing as jax_tracing
from dat_replication_protocol_tpu.obs import events as jax_events
from dat_replication_protocol_tpu_torch.obs import (device, events, flight,
                                                    metrics, tracing)
from dat_replication_protocol_tpu_torch.utils import trace


@pytest.fixture
def port_obs():
    """The port's gate on, with clean values, rings, recorder, sentinel
    and engine notes; the prior gate state restored afterwards."""
    was_on = metrics.OBS.on

    def reset():
        metrics.REGISTRY.reset()
        events.EVENTS.clear()
        tracing.SPANS.clear()
        flight.FLIGHT._reset_for_tests()
        device.SENTINEL.reset_for_tests()
        device.reset_engine_notes()

    reset()
    metrics.enable()
    try:
        yield metrics
    finally:
        metrics.OBS.on = was_on
        reset()


class Boom(Exception):
    pass


def _script(trc, evs):
    """One sequence of nested spans, instants and events."""
    with trc.trace_span("t.outer", k=1):
        trc.trace_instant("encoder.frame", offset=0, wire_len=9,
                          kind="change")
        with trc.trace_span("t.inner"):
            evs.emit("t.ev", x="y")
        try:
            with trc.trace_span("t.fails", n=2):
                raise Boom("x")
        except Boom:
            pass
    trc.trace_instant("decoder.frame", offset=9, wire_len=3, kind="blob")


def _shape(spans):
    """Span records without clocks or ids: name, fields, parent's name."""
    by_id = {r["id"]: r["span"] for r in spans}
    return [(r["span"], r["fields"], by_id.get(r["parent"]),
             r["dur"] > 0) for r in spans]


def _chrome(doc):
    out = []
    for ev in doc["traceEvents"]:
        ev = dict(ev)
        for k in ("ts", "dur", "pid", "tid"):
            ev.pop(k, None)
        ev["args"] = {k: v for k, v in ev["args"].items()
                      if k not in ("seq", "parent")}
        out.append(ev)
    return out


def test_spans_and_chrome_trace_equal_the_reference(port_obs, obs_enabled):
    _script(tracing, events)
    _script(jax_tracing, jax_events)
    ours = tracing.SPANS.spans()
    ref = jax_tracing.SPANS.spans()
    assert _shape(ours) == _shape(ref)
    fails = [r for r in ours if r["span"] == "t.fails"]
    assert fails[0]["fields"] == {"n": 2, "error": "Boom"}
    assert _chrome(tracing.to_chrome_trace()) == \
        _chrome(jax_tracing.to_chrome_trace())


def test_spans_nest_per_thread(port_obs):
    import threading

    def worker():
        with tracing.trace_span("t.thread"):
            pass

    with tracing.trace_span("t.main"):
        t = threading.Thread(target=worker)
        t.start()
        t.join()
    recs = {r["span"]: r for r in tracing.SPANS.spans()}
    assert recs["t.thread"]["parent"] is None
    assert recs["t.thread"]["tid"] != recs["t.main"]["tid"]


def test_export_chrome_trace_and_jsonl_sink(port_obs, tmp_path):
    path = tmp_path / "log.jsonl"
    sink = tracing.attach_jsonl_sink(str(path))
    try:
        _script(tracing, events)
    finally:
        events.EVENTS.detach_sink()
        tracing.SPANS.detach_sink()
        sink.close()
    lines = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert [r.get("span", r.get("event")) for r in lines] == [
        "encoder.frame", "t.ev", "t.inner", "t.fails", "t.outer",
        "decoder.frame"]
    out = tracing.export_chrome_trace(str(tmp_path / "x" / "t.json"))
    doc = json.loads(open(out).read())
    assert {e["ph"] for e in doc["traceEvents"]} == {"X", "i"}
    assert not any(p.name.startswith("t.json.tmp")
                   for p in (tmp_path / "x").iterdir())


def test_span_is_the_null_span_without_profiler_or_gate():
    was_on = metrics.OBS.on
    metrics.OBS.on = False
    try:
        assert trace.span("digest.dispatch") is trace._NULL
    finally:
        metrics.OBS.on = was_on


def test_span_records_an_obs_span_with_src_torch(port_obs):
    with trace.span("cdc.greedy"):
        pass
    (rec,) = tracing.SPANS.spans("cdc.greedy")
    assert rec["fields"] == {"src": "torch"}


@pytest.mark.parametrize("gate", [False, True], ids=["dark", "gated"])
def test_span_shows_under_a_cpu_profiler(gate):
    was_on = metrics.OBS.on
    metrics.OBS.on = gate
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with trace.span("digest.dispatch"):
                torch.ones(4) + 1
    finally:
        metrics.OBS.on = was_on
    assert "digest.dispatch" in {e.name for e in prof.events()}


def test_session_and_cdc_spans_show_under_a_cpu_profiler(port_obs):
    """Every span a CPU digest session and content_address open is both
    a profiler range and an obs span."""
    rng = np.random.default_rng(3)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        enc = protocol.encode()
        dec = protocol.decode(backend="cuda", device="cpu")
        dec.on_digest(lambda *a: None)
        protocol.pipe(enc, dec)
        for i in range(5):
            enc.change({"key": f"k{i}", "change": i, "from": 0, "to": 1})
        enc.blob(300).end(rng.bytes(300))
        enc.finalize()
        protocol.content_address(rng.bytes(20_000), avg_bits=8, device="cpu")
    names = {e.name for e in prof.events()}
    torch_spans = {r["span"] for r in tracing.SPANS.spans()
                   if r["fields"].get("src") == "torch"}
    assert {"digest.dispatch", "digest.collect", "cdc.dispatch",
            "cdc.collect", "cdc.greedy"} <= torch_spans <= names


def test_trace_to_writes_a_chrome_trace(tmp_path):
    with trace.trace_to(str(tmp_path), cuda=False) as prof:
        with trace.span("reconcile.diff"):
            torch.ones(3) * 2
    assert prof is not None
    doc = json.loads((tmp_path / "trace.json").read_text())
    assert any(ev.get("name") == "reconcile.diff"
               for ev in doc["traceEvents"])
    with trace.trace_to(None) as nothing:
        assert nothing is None


def test_flight_bundle_reads_back_through_the_reference(port_obs, tmp_path):
    flight.FLIGHT.arm(str(tmp_path))
    events.emit("t.before", i=1)
    tracing.trace_instant("decoder.frame", offset=0, wire_len=4,
                          kind="change")
    err = protocol.ProtocolError("bad", frame=3, offset=17)
    path = flight.dump("protocol-error", error=err, extra={"k": 1})
    assert os.path.basename(path).endswith("-protocol-error")
    assert flight.dump("protocol-error", error=err) is None  # dedup
    assert flight.FLIGHT.suppressed == 1
    b = jax_flight.read_bundle(path)
    assert b == flight.read_bundle(path)
    assert b["manifest"]["reason"] == "protocol-error"
    assert b["manifest"]["error"] == {"type": "ProtocolError",
                                      "message": str(err), "frame": 3,
                                      "offset": 17, "cause": None}
    assert b["manifest"]["extra"] == {"k": 1}
    assert [r["event"] for r in b["events"]] == ["t.before"]
    assert [r["span"] for r in b["spans"]] == ["decoder.frame"]
    assert not [p for p in os.listdir(tmp_path) if p.startswith(".tmp-")]
    assert [r["event"] for r in events.EVENTS.events()][-1] == "flight.dump"


def test_flight_budget_and_rearm(port_obs, tmp_path):
    flight.FLIGHT.arm(str(tmp_path), max_bundles=3)
    assert flight.dump("a") and flight.dump("b") and flight.dump("c")
    assert flight.dump("d") is None  # budget spent
    assert flight.dump("e") is None
    assert flight.FLIGHT.suppressed == 2
    flight.disarm()
    assert flight.dump("f") is None
    # re-arming into the same directory is a fresh capture, no collision
    flight.FLIGHT.arm(str(tmp_path), max_bundles=4)
    assert flight.dump("a")
    assert len(os.listdir(tmp_path)) == 4
