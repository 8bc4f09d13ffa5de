"""The port's session telemetry against the JAX package's, on the CPU.

The same seeded session goes through the JAX package's ``encode()`` /
``decode()`` and the port's: host ends, then a digest decoder
(``backend="tpu"`` against ``backend="cuda", device="cpu"``) and a
digest encoder, on per-record and negotiated batch wires.  The session
and digest counters must be equal, and the ``encoder.frame`` /
``decoder.frame`` records equal in offset, wire_len, kind and rows (and
tile the wire).  Then the per-peer JSONL logs through the JAX package's
offline ``timeline`` tool, a corrupt wire's ``protocol.error`` and
flight bundle, ``content_address``'s CDC counters, and the sidecar's
``--trace-jsonl`` / ``--flight-dir`` flags.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import dat_replication_protocol_tpu as jax_protocol
import dat_replication_protocol_tpu_torch as protocol
from dat_replication_protocol_tpu.obs import metrics as jax_metrics
from dat_replication_protocol_tpu.obs import tracing as jax_tracing
from dat_replication_protocol_tpu.obs import events as jax_events
from dat_replication_protocol_tpu_torch.obs import (device, events, flight,
                                                    metrics, tracing)

REPO = Path(__file__).resolve().parent.parent

# the counters both packages keep on these paths (OBSERVABILITY.md)
SESSION_COUNTERS = (
    "decoder.bytes", "decoder.changes", "decoder.blobs",
    "decoder.blob.bytes", "decoder.requeues", "decoder.errors",
    "decoder.batch.frames", "wire.batch.bytes_saved_rx",
    "encoder.bytes", "encoder.changes", "encoder.blobs",
    "encoder.blob.chunks", "encoder.parked.bytes", "wire.batch.frames",
    "wire.batch.rows", "wire.batch.bytes_saved",
    "decoder.digests", "encoder.digests", "device.submit.items",
    "device.submit.bytes", "device.dispatch.batches",
)
FRAME_SPANS = ("encoder.frame", "decoder.frame")


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


def _records(seed: int):
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(int(rng.integers(20, 40))):
        rec = {"key": f"row-{i % 6}", "change": int(rng.integers(0, 1 << 20)),
               "from": 0, "to": int(rng.integers(1, 9))}
        if rng.random() < 0.8:
            rec["value"] = rng.bytes(int(rng.integers(0, 300)))
        if rng.random() < 0.3:
            rec["subset"] = f"s{int(rng.integers(0, 3))}"
        recs.append(rec)
    blobs = [rng.bytes(int(rng.integers(1, 5000))) for _ in range(4)]
    return recs, blobs


def _drive(p, enc, seed: int, many: bool = True):
    """Changes around blobs, two blobs open at once (the second corked,
    changes parked behind them), a ``change_many`` run when ``many``,
    then finalize; returns the wire."""
    recs, blobs = _records(seed)
    third = len(recs) // 3
    for r in recs[:third]:
        enc.change(r)
    a = enc.blob(len(blobs[0]))
    b = enc.blob(len(blobs[1]))  # corked until a ends
    b.write(blobs[1][:7])
    enc.change(recs[third])  # parked behind the open blobs
    a.write(blobs[0][:100])
    a.end(blobs[0][100:])
    b.end(blobs[1][7:])
    for r in recs[third + 1:2 * third]:
        enc.change(r)
    enc.blob(len(blobs[2])).end(blobs[2])
    if many:
        enc.change_many(recs[2 * third:])
    else:
        for r in recs[2 * third:]:
            enc.change(r)
    enc.blob(len(blobs[3])).end(blobs[3])
    enc.finalize()
    out = bytearray()
    while (c := enc.read(1000)) is not None:
        out += c
    return bytes(out)


def _session(p, backend: str, batch: bool, digest_end: str, seed: int,
             device_kw: dict):
    """Run one session through package ``p``: encoder -> wire -> decoder
    fed in 700-byte writes.  Returns the wire and each end's digests."""
    kw = {}
    if batch:
        kw = {"peer_caps": p.CAP_CHANGE_BATCH,
              "batch_policy": p.BatchPolicy(max_rows=7)}
    enc_backend = backend if digest_end in ("encoder", "both") else "host"
    dec_backend = backend if digest_end in ("decoder", "both") else "host"
    enc = p.encode(backend=enc_backend,
                   **(device_kw if enc_backend != "host" else {}), **kw)
    got = {"enc": [], "dec": []}
    if enc_backend != "host":
        enc.on_digest(lambda k, s, d: got["enc"].append((k, s, d)))
    # the reference's change_many gives no digests (the port's does)
    wire = _drive(p, enc, seed, many=enc_backend == "host")
    if enc_backend != "host":
        enc.digest_pipeline.flush()
    dec = p.decode(backend=dec_backend,
                   **(device_kw if dec_backend != "host" else {}))
    dec._NATIVE_MIN = 1 << 62  # the JAX decoder's streaming scanner
    if dec_backend != "host":
        dec.on_digest(lambda k, s, d: got["dec"].append((k, s, d)))
    dec.change(lambda c, done: done())
    for i in range(0, len(wire), 700):
        dec.write(wire[i:i + 700])
    dec.end()
    assert dec.finished and not dec.destroyed
    return wire, got


def _frames(spans):
    return [(r["span"], r["fields"]["offset"], r["fields"]["wire_len"],
             r["fields"]["kind"], r["fields"].get("rows"))
            for r in spans if r["span"] in FRAME_SPANS]


def _tiles(frames, name, total):
    end = 0
    for n, off, wl, _, _ in frames:
        if n == name:
            assert off == end, (name, off, end)
            end = off + wl
    assert end == total


def _counters(snap):
    return {k: snap["counters"].get(k, 0) for k in SESSION_COUNTERS}


CASES = [
    ("host", False, "none"), ("host", True, "none"),
    ("digest", False, "decoder"), ("digest", True, "decoder"),
    ("digest", False, "encoder"),
]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kind,batch,digest_end", CASES,
                         ids=["host", "host-batch", "digest-decoder",
                              "digest-decoder-batch", "digest-encoder"])
def test_session_counters_and_frames_equal_the_reference(
        kind, batch, digest_end, seed, port_obs, obs_enabled):
    wire, got = _session(protocol, "cuda", batch, digest_end, seed,
                         {"device": "cpu"})
    ref_wire, ref_got = _session(jax_protocol, "tpu", batch, digest_end,
                                 seed, {})
    assert wire == ref_wire
    assert got == ref_got
    ours = _counters(metrics.snapshot())
    ref = _counters(jax_metrics.snapshot())
    assert ours == ref
    assert ours["decoder.bytes"] == ours["encoder.bytes"] == len(wire)
    if digest_end == "decoder":
        assert ours["decoder.digests"] == len(got["dec"]) > 0
    if batch:
        assert ours["wire.batch.frames"] > 0
        assert ours["wire.batch.bytes_saved"] == \
            ours["wire.batch.bytes_saved_rx"]
    frames = _frames(tracing.SPANS.spans())
    assert frames == _frames(jax_tracing.SPANS.spans())
    for name in FRAME_SPANS:
        _tiles(frames, name, len(wire))
    assert any(f[3] == "blob" for f in frames)


def test_digest_session_counts_its_device_traffic(port_obs):
    """The CPU digest session's batch edge counts H2D and D2H bytes as
    the reference's device batch edge does: padded words and lengths up,
    64 bytes of digest halves an item down."""
    _, got = _session(protocol, "cuda", False, "decoder", 0,
                      {"device": "cpu"})
    c = metrics.snapshot()["counters"]
    n = len(got["dec"])
    assert c["device.d2h.bytes"] == 64 * n
    assert c["device.h2d.bytes"] >= 132 * n  # >= one block + length each
    sites = device.SENTINEL.snapshot()
    assert sites["ops.blake2b_cuda.packed"]["calls"] >= \
        c["device.dispatch.batches"]
    engines = {e["fields"]["component"]
               for e in events.EVENTS.events("device.engine.select")}
    assert {"digest.hash", "blake2b.batch"} <= engines
    spans = {r["span"] for r in tracing.SPANS.spans()}
    assert {"device.dispatch", "device.deliver", "digest.dispatch",
            "digest.collect"} <= spans


def _timeline(tmp_path, batch: bool):
    """The port's per-peer logs of one session, sender then receiver."""
    s_path, r_path = tmp_path / "s.jsonl", tmp_path / "r.jsonl"
    sink = tracing.attach_jsonl_sink(str(s_path))
    try:
        kw = {"peer_caps": protocol.CAP_CHANGE_BATCH} if batch else {}
        wire = _drive(protocol, protocol.encode(**kw), 3)
    finally:
        events.EVENTS.detach_sink()
        tracing.SPANS.detach_sink()
        sink.close()
    sink = tracing.attach_jsonl_sink(str(r_path))
    try:
        dec = protocol.decode(backend="cuda", device="cpu")
        dec.on_digest(lambda *a: None)
        for i in range(0, len(wire), 999):
            dec.write(wire[i:i + 999])
        dec.end()
    finally:
        events.EVENTS.detach_sink()
        tracing.SPANS.detach_sink()
        sink.close()
    return s_path, r_path, wire


@pytest.mark.parametrize("batch", [False, True], ids=["records", "batch"])
def test_port_logs_pass_the_reference_timeline(batch, port_obs, tmp_path):
    s_path, r_path, wire = _timeline(tmp_path, batch)
    out = subprocess.run(
        [sys.executable, "-m", "dat_replication_protocol_tpu.obs",
         "timeline", str(s_path), str(r_path), "--json"],
        capture_output=True, text=True, timeout=120, cwd=REPO,
        env={**os.environ, "PYTHONPATH": str(REPO), "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stdout + out.stderr
    doc = json.loads(out.stdout)
    assert doc["flags"] == []
    assert doc["sender"]["covered"] == doc["receiver"]["covered"] \
        == len(wire)


CORRUPT = {
    "unknown-type": b"\x02\x07\x00",
    "bad-change": b"\x03\x01\xff\xff",
    "long-header": b"\xff" * 16,
}


@pytest.mark.parametrize("tail", list(CORRUPT), ids=list(CORRUPT))
def test_corrupt_wire_error_and_bundle_equal_the_reference(
        tail, port_obs, obs_enabled, tmp_path):
    def run(p):
        enc = p.encode()
        enc.change({"key": "k", "change": 1, "from": 0, "to": 1})
        enc.blob(5).end(b"abcde")
        enc.finalize()
        wire = enc.read() + CORRUPT[tail]
        dec = p.decode()
        errors = []
        dec.on_error(errors.append)
        dec.write(wire)
        assert dec.destroyed and len(errors) == 1
        return errors[0]

    flight.FLIGHT.arm(str(tmp_path))
    ours, ref = run(protocol), run(jax_protocol)
    (ev,) = events.EVENTS.events("protocol.error")
    (ref_ev,) = jax_events.EVENTS.events("protocol.error")
    assert ev["fields"] == ref_ev["fields"]
    assert (ours.frame, ours.offset) == (ref.frame, ref.offset)
    assert metrics.snapshot()["counters"]["decoder.errors"] == 1
    (name,) = os.listdir(tmp_path)
    b = flight.read_bundle(str(tmp_path / name))
    assert b["manifest"]["reason"] == "protocol-error"
    assert b["manifest"]["error"]["frame"] == ours.frame
    assert b["manifest"]["error"]["offset"] == ours.offset
    assert any(r["span"] == "decoder.frame" for r in b["spans"])


def test_raise_then_resume_requeues_the_tail(port_obs, obs_enabled):
    def run(p):
        enc = p.encode()
        for i in range(4):
            enc.change({"key": f"k{i}", "change": i, "from": 0, "to": 1})
        enc.finalize()
        wire = enc.read()
        dec = p.decode()
        seen = []

        def handler(c, done):
            seen.append(c.key)
            done()
            if c.key == "k1":
                raise RuntimeError("app")

        dec.change(handler)
        with pytest.raises(RuntimeError):
            dec.write(wire)
        dec.write(b"")
        return seen

    assert run(protocol) == run(jax_protocol) == ["k0", "k1", "k2", "k3"]
    ours = [e["fields"] for e in events.EVENTS.events("decoder.requeue")]
    ref = [e["fields"] for e in jax_events.EVENTS.events("decoder.requeue")]
    assert ours == ref and len(ours) == 1
    assert metrics.snapshot()["counters"]["decoder.requeues"] == 1


def test_content_address_cdc_counters_equal_the_reference(port_obs,
                                                          obs_enabled):
    from dat_replication_protocol_tpu.runtime import content as jax_content

    blob = np.random.default_rng(11).integers(0, 256, 60_000,
                                              dtype=np.uint8)
    ours = protocol.content_address(blob, avg_bits=8, device="cpu")
    ref = jax_content.content_address(blob, avg_bits=8)
    assert ours.cuts == ref.cuts and ours.root == ref.root
    names = ("cdc.fused.bytes", "cdc.fused.chunks")
    c = metrics.snapshot()["counters"]
    jc = jax_metrics.snapshot()["counters"]
    assert [c[n] for n in names] == [jc[n] for n in names] \
        == [blob.size, len(ours.cuts)]
    assert c["device.d2h.bytes"] == 32 * len(ours.cuts) + 32
    (span,) = tracing.SPANS.spans("device.content.address")
    assert span["fields"] == {"bytes": blob.size}
    names = [r["span"] for r in tracing.SPANS.spans()]
    for name in ("cdc.dispatch", "cdc.collect", "cdc.greedy",
                 "device.dispatch"):
        assert name in names
    note = events.EVENTS.events("device.engine.select")
    assert {"component": "cdc.hash", "engine": "bitmask-cpu",
            "bytes": blob.size} in [e["fields"] for e in note]


def test_reconcile_spans_and_counters(port_obs):
    from dat_replication_protocol_tpu_torch.ops import rateless, reconcile

    keys = [b"k%03d" % i for i in range(64)]
    a = reconcile.LogSummary([b"v" + k for k in keys], keys, 6, device="cpu")
    b = reconcile.LogSummary([b"v" + k for k in keys[1:]], keys[1:], 6,
                             device="cpu")
    reconcile.reconcile(a, b)
    d = np.random.default_rng(0).integers(0, 256, (64, 32), dtype=np.uint8)
    dec = rateless.PeelDecoder(d[1:], device="cpu")
    dec.add_symbols(0, rateless.CodedSymbols(d, device="cpu").extend(16))
    assert dec.try_decode()[0].tolist() == [d[0].tolist()]
    names = {r["span"] for r in tracing.SPANS.spans()}
    assert {"reconcile.hash", "reconcile.sketch", "reconcile.diff",
            "reconcile.build", "reconcile.peel"} <= names
    c = metrics.snapshot()["counters"]
    assert c["reconcile.symbols"] == 32  # 16 sent + 16 local
    assert c["reconcile.peeled"] == 1
    # records of 5 bytes and keys of 4, one window each, staged whole in
    # words: 64 * 9 bytes for a, 63 * 9 rounded up to a word for b
    assert c["device.h2d.bytes"] == 64 * 9 + 63 * 9 + 1
    assert c["device.h2d.overlap"] == 0
    assert c["extents.windows"] == 2


@pytest.mark.parametrize("garbage", [False, True], ids=["clean", "garbage"])
def test_sidecar_trace_jsonl_and_flight_dir(garbage, tmp_path):
    enc = protocol.encode()
    enc.change({"key": "k", "change": 1, "from": 0, "to": 1, "value": b"v"})
    enc.blob(4).end(b"abcd")
    enc.finalize()
    wire = enc.read() + (b"\xff" * 16 if garbage else b"")
    trace_path, fdir = tmp_path / "trace.jsonl", tmp_path / "flight"
    out = subprocess.run(
        [sys.executable, "-m", "dat_replication_protocol_tpu_torch.sidecar",
         "--stdio", "--device", "cpu", "--trace-jsonl", str(trace_path),
         "--flight-dir", str(fdir)],
        input=wire, capture_output=True, timeout=120, cwd=REPO,
        env={**os.environ, "PYTHONPATH": str(REPO)})
    recs = [json.loads(ln) for ln in trace_path.read_text().splitlines()]
    names = [r.get("span", r.get("event")) for r in recs]
    assert "sidecar.session.recv" in names and "decoder.frame" in names
    bundles = os.listdir(fdir)
    if garbage:
        assert out.returncode == 1
        assert "protocol.error" in names
        (name,) = bundles
        assert name.endswith("-protocol-error")
    else:
        assert out.returncode == 0, out.stderr
        assert bundles == []
        # the reply's frames: one digest Change per payload
        assert names.count("encoder.frame") == 2


def test_feed_counts_its_staging_and_readback(port_obs, monkeypatch):
    """Four windows of 16 one-block extents, one B1 chunk each: every
    window's words count as H2D, the three staged after the first as
    overlap, the digests as D2H; one ``device.dispatch`` span a chunk."""
    from dat_replication_protocol_tpu_torch.batch import feed

    monkeypatch.setattr(feed, "WINDOW_BYTES", 1024)
    buf = np.random.default_rng(5).integers(0, 256, 4096, dtype=np.uint8)
    offs = np.arange(0, 4096, 64)
    lens = np.full(64, 64)
    digests = feed.hash_extents(buf, offs, lens, device="cpu",
                                pipeline_bytes=16 * 128)
    assert digests.shape == (64, 32)
    c = metrics.snapshot()["counters"]
    assert c["extents.windows"] == 4
    assert c["device.h2d.bytes"] == 4096
    assert c["device.h2d.overlap"] == 3 * 1024
    assert c["device.d2h.bytes"] == 64 * 32
    spans = tracing.SPANS.spans("device.dispatch")
    assert [(r["fields"]["site"], r["fields"]["items"]) for r in spans] == \
        [("feed.hash_extents", 16)] * 4
