"""The spans inside the port's two benchmarked paths, the digest
pipeline's batch histograms, and the obs export's clock.

Each span is counted in a CPU ``torch.profiler`` capture: one
``decoder.blob`` a blob of a digest session, one ``digest.stage`` a
bucket of a batch, one ``digest.collect`` a dispatched batch (paired in
order with the ``digest.dispatch`` ranges), one ``cdc.stage`` a slab of
``chunk_stream``, one ``extents.pack`` a pipeline chunk and one
``extents.collect`` a call of ``hash_extents``, one ``merkle.fold`` a
``root_host``.  ``digest.wait`` is on the CUDA branch only.  With the
gate on, ``DigestPipeline`` observes ``device.batch.fill.seconds`` once
a batch.

The obs ring's Chrome export, rebased onto a profiler export's
``baseTimeNanoseconds``, lies on the profiler's time axis.
``export-trace --like`` converts each part of a log through the
``obs.clock`` anchor at its head, a bundle through its manifest's, and
refuses records with no anchor.
"""

import hashlib
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import dat_replication_protocol_tpu_torch as protocol
from dat_replication_protocol_tpu_torch.backend.cuda_backend import (
    DigestPipeline)
from dat_replication_protocol_tpu_torch.batch import feed
from dat_replication_protocol_tpu_torch.obs import (device, events, flight,
                                                    metrics, tracing)
from dat_replication_protocol_tpu_torch.obs.__main__ import main as obs_main
from dat_replication_protocol_tpu_torch.ops import blake2b, merkle, rabin
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


@pytest.fixture
def gate_off():
    was_on = metrics.OBS.on
    metrics.OBS.on = False
    try:
        yield
    finally:
        metrics.OBS.on = was_on


def _ranges(prof, name: str) -> list[tuple[float, float]]:
    """(start, end) in microseconds of the capture's ranges ``name``."""
    return sorted((e.time_range.start, e.time_range.end)
                  for e in prof.events() if e.name == name)


def _session(sizes, max_batch: int, seed: int = 0,
             stream_threshold: int = 8 << 20):
    """A CPU digest session of blobs of ``sizes`` under a profiler (blobs
    of at least ``stream_threshold`` bytes hash on the host as streams);
    returns the profiler and the digests delivered."""
    rng = np.random.default_rng(seed)
    blobs = [rng.bytes(n) for n in sizes]
    got = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        enc = protocol.encode()
        dec = protocol.decode(backend="cuda", device="cpu",
                              stream_threshold=stream_threshold,
                              pipeline=DigestPipeline(device="cpu",
                                                      max_batch=max_batch))
        dec.on_digest(lambda kind, seq, d: got.append((kind, seq, d)))
        protocol.pipe(enc, dec)
        for b in blobs:
            enc.blob(len(b)).end(b)
        enc.finalize()
    assert dec.finished
    assert [d for _, _, d in got] == [
        hashlib.blake2b(b, digest_size=32).digest() for b in blobs]
    return prof, got


def test_span_off_path_is_the_shared_null_span(gate_off):
    assert trace.span("decoder.blob") is trace._NULL
    assert trace.span("merkle.fold") is trace._NULL


@pytest.mark.parametrize("stream_threshold", [8 << 20, 512],
                         ids=["batched", "streamed"])
@pytest.mark.parametrize("nblobs", [1, 4, 9])
def test_one_decoder_blob_range_a_blob(nblobs, stream_threshold, gate_off):
    prof, got = _session([700] * nblobs, max_batch=4,
                         stream_threshold=stream_threshold)
    assert len(_ranges(prof, "decoder.blob")) == nblobs == len(got)
    # a streamed blob is hashed on the host: nothing is staged
    staged = len(_ranges(prof, "digest.stage"))
    assert (staged == 0) if stream_threshold == 512 else staged


# blob sizes of one session and the batch size: blocks of 128 bytes, so
# 100 / 300 / 1,000 / 2,000 bytes fall in the 1, 4, 8 and 16-block
# buckets
@pytest.mark.parametrize("sizes,max_batch", [
    ([300] * 5, 2),
    ([100, 300, 1000, 100, 2000, 300, 1000], 3),
    ([100, 2000] * 4 + [300], 8),
], ids=["one-bucket", "mixed", "wide"])
def test_stage_a_bucket_and_collect_paired_with_dispatch(sizes, max_batch,
                                                         gate_off):
    prof, _ = _session(sizes, max_batch)
    batches = [sizes[i:i + max_batch] for i in range(0, len(sizes),
                                                     max_batch)]
    buckets = sum(len(blake2b.bucket_by_blocks([b"x" * n for n in batch]))
                  for batch in batches)
    assert len(_ranges(prof, "digest.stage")) == buckets
    dispatch = _ranges(prof, "digest.dispatch")
    collect = _ranges(prof, "digest.collect")
    assert len(dispatch) == len(collect) == len(batches)
    # batch k is collected after its dispatch, once two newer batches
    # have been dispatched (two in flight) or at the finalize flush
    for k, ((d0, d1), (c0, _)) in enumerate(zip(dispatch, collect)):
        assert d1 <= c0
        if k + 2 < len(dispatch):
            assert dispatch[k + 2][1] <= c0
    assert _ranges(prof, "digest.wait") == []  # the CUDA branch only


@pytest.mark.parametrize("nbytes,slab_tiles,slabs", [
    (4096 * 4, 4, 1),
    (70_001, 4, 5),
    (4096 * 24, 8, 3),
])
def test_one_cdc_stage_a_slab(nbytes, slab_tiles, slabs, gate_off):
    data = np.random.default_rng(nbytes).integers(0, 256, nbytes,
                                                  dtype=np.uint8)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        cuts = rabin.chunk_stream(data, 8, tile_bytes=4096,
                                  slab_tiles=slab_tiles, device="cpu")
    assert cuts[-1] == nbytes
    assert len(_ranges(prof, "cdc.stage")) == slabs


# extent lengths and the pipeline's padded bytes, in 128-byte blocks: a
# chunk holds pipeline_blocks // nb extents of an nb-block bucket (64,
# 200, 300 and 1,000 bytes: nb 1, 2, 4 and 8), and every bucket packs
# its own chunks
@pytest.mark.parametrize("lens,pipeline_blocks,chunks", [
    ([64] * 64, 64, 1),
    ([64] * 64, 16, 4),
    ([64] * 32 + [200] * 16, 16, 2 + 2),
    ([64, 300, 1000] * 8, 16, 1 + 2 + 4),
], ids=["one-chunk", "four-chunks", "two-buckets", "three-buckets"])
def test_hash_extents_packs_a_chunk_and_collects_once(lens, pipeline_blocks,
                                                      chunks, gate_off):
    lens = np.asarray(lens)
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]])
    buf = np.random.default_rng(5).integers(0, 256, int(lens.sum()),
                                            dtype=np.uint8)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        digests = feed.hash_extents(buf, offs, lens, device="cpu",
                                    pipeline_bytes=pipeline_blocks * 128)
    assert digests.tolist() == [
        list(hashlib.blake2b(buf[o:o + n].tobytes(), digest_size=32).digest())
        for o, n in zip(offs, lens)]
    assert len(_ranges(prof, "extents.pack")) == chunks
    assert len(_ranges(prof, "extents.collect")) == 1


@pytest.mark.parametrize("leaves", [0, 5])
def test_root_host_is_one_merkle_fold(leaves, port_obs):
    d = np.random.default_rng(leaves).integers(0, 256, (leaves, 32),
                                               dtype=np.uint8)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        merkle.root_host(d)
    assert len(_ranges(prof, "merkle.fold")) == 1
    (rec,) = tracing.SPANS.spans("merkle.fold")
    assert rec["fields"] == {"src": "torch"}


@pytest.mark.parametrize("nblobs,max_batch,stream_threshold", [
    (6, 2, 8 << 20), (7, 3, 8 << 20), (2, 4, 8 << 20), (5, 2, 512)],
    ids=["full", "ragged", "flush-only", "streamed"])
def test_batch_histograms_observe_once_a_batch(nblobs, max_batch,
                                               stream_threshold, port_obs):
    _session([700] * nblobs, max_batch, stream_threshold=stream_threshold)
    fill = metrics.snapshot()["histograms"]["device.batch.fill.seconds"]
    batches = -(-nblobs // max_batch)
    assert fill["count"] == batches
    # each batch fills between the session's first blob and its last
    # dispatch
    first = min(r["ts"] for r in tracing.SPANS.spans("decoder.blob"))
    last = max(r["ts"] for r in tracing.SPANS.spans("device.dispatch"))
    assert 0 <= fill["sum"] <= batches * (last - first)


def test_batch_histograms_are_silent_with_the_gate_off(gate_off):
    before = {k: v["count"] for k, v in
              metrics.snapshot()["histograms"].items()
              if k.startswith("device.batch.")}
    _session([700] * 5, 2)
    after = {k: v["count"] for k, v in
             metrics.snapshot()["histograms"].items()
             if k.startswith("device.batch.")}
    assert after == before


# -- one clock ------------------------------------------------------------------


def test_one_span_on_the_obs_and_the_profiler_clock(port_obs, tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("t.warm"):
            torch.ones(2) + 1
        with trace.span("t.clock"):
            torch.ones(2) + 1
    path = tmp_path / "profiler.json"
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    base_ns = doc["baseTimeNanoseconds"]
    (prof_ev,) = [e for e in doc["traceEvents"] if e.get("name") == "t.clock"]
    obs_doc = tracing.to_chrome_trace(
        tracing.rebase(tracing.SPANS.spans(), base_ns, tracing.CLOCK), [],
        base_ns)
    (obs_ev,) = [e for e in obs_doc["traceEvents"] if e["name"] == "t.clock"]
    assert obs_doc["baseTimeNanoseconds"] == base_ns
    assert abs(obs_ev["ts"] - prof_ev["ts"]) < 1e3


def _log(tmp_path):
    path = tmp_path / "log.jsonl"
    sink = tracing.attach_jsonl_sink(str(path))
    try:
        with tracing.trace_span("t.outer", k=1):
            tracing.trace_instant("encoder.frame", offset=0, wire_len=9,
                                  kind="change")
            events.emit("t.ev", x="y")
    finally:
        events.EVENTS.detach_sink()
        tracing.SPANS.detach_sink()
        sink.close()
    return path


def _profiler_file(tmp_path, base_ns: int):
    like = tmp_path / "profiler.json"
    like.write_text(json.dumps({"traceEvents": [],
                                "baseTimeNanoseconds": base_ns}))
    return str(like)


def test_export_trace_keeps_its_record_shape(port_obs, tmp_path, capsys):
    path = _log(tmp_path)
    out = tmp_path / "t.json"
    assert obs_main(["export-trace", str(path), "-o", str(out)]) == 0
    assert capsys.readouterr().out == f"{out}: 4 trace event(s)\n"
    doc = json.loads(out.read_text())
    assert set(doc) == {"traceEvents", "displayTimeUnit", "metadata"}
    shapes = {e["name"]: (e["ph"], sorted(e)) for e in doc["traceEvents"]}
    base = ["args", "name", "ph", "pid", "tid", "ts"]
    assert shapes == {
        "obs.clock": ("i", sorted(base + ["s"])),
        "t.ev": ("i", sorted(base + ["s"])),
        "encoder.frame": ("i", sorted(base + ["s"])),
        "t.outer": ("X", sorted(base + ["dur"])),
    }
    # the same document the live rings give
    live = tracing.to_chrome_trace()
    assert [e for e in doc["traceEvents"] if e["name"] != "obs.clock"] == \
        [dict(e, pid=doc["metadata"]["pid"]) for e in live["traceEvents"]]


def _anchored(mono: float, unix_ns: int, seq: int) -> list[dict]:
    """One part of a log: its ``obs.clock`` head and a span 2.5 s later."""
    return [
        {"seq": 0, "ts": mono, "event": "obs.clock",
         "fields": {"mono": mono, "unix_ns": unix_ns}},
        {"seq": seq, "ts": mono + 2.5, "dur": 0.25, "span": "digest.dispatch",
         "id": seq, "parent": None, "tid": 3, "fields": {}},
    ]


# parts of one log appended by processes of different boots: each
# converts through the anchor at its own head
@pytest.mark.parametrize("parts", [
    [(10.0, 1_790_000_000_123_456_789)],
    [(123_456.789, 1_790_000_100_000_000_001)],
    [(0.5, 1_790_000_000_000_000_000)],
    [(5_000.0, 1_790_000_000_000_000_000), (3.0, 1_790_000_900_000_000_000)],
], ids=["one", "late-boot", "base", "two-boots"])
def test_export_trace_converts_through_the_logs_anchor(parts, tmp_path,
                                                       capsys):
    base_ns = 1_790_000_000_000_000_000
    recs = [r for k, (mono, unix_ns) in enumerate(parts)
            for r in _anchored(mono, unix_ns, k + 1)]
    path = tmp_path / "other.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in recs))
    out = tmp_path / "t.json"
    assert obs_main(["export-trace", str(path), "-o", str(out),
                     "--like", _profiler_file(tmp_path, base_ns)]) == 0
    doc = json.loads(out.read_text())
    assert doc["baseTimeNanoseconds"] == base_ns
    got = sorted((e["args"]["seq"], e["ts"], e["dur"])
                 for e in doc["traceEvents"] if e["name"] == "digest.dispatch")
    assert len(got) == len(parts)
    for (seq, ts, dur), (mono, unix_ns) in zip(got, parts):
        assert ts == pytest.approx((unix_ns - base_ns) / 1e3 + 2.5e6, abs=1.0)
        assert dur == pytest.approx(0.25e6)


def test_export_trace_like_a_profiler_trace(port_obs, tmp_path, capsys):
    path = _log(tmp_path)
    base_ns = 1_790_000_000_000_000_000
    a, b = tmp_path / "a.json", tmp_path / "b.json"
    assert obs_main(["export-trace", str(path), "-o", str(a)]) == 0
    assert obs_main(["export-trace", str(path), "-o", str(b),
                     "--like", _profiler_file(tmp_path, base_ns)]) == 0
    da, db = json.loads(a.read_text()), json.loads(b.read_text())
    assert "baseTimeNanoseconds" not in da
    assert db["baseTimeNanoseconds"] == base_ns
    offset_us = (tracing.CLOCK["unix_ns"] - base_ns) / 1e3 \
        - tracing.CLOCK["mono"] * 1e6
    assert len(da["traceEvents"]) == len(db["traceEvents"]) == 4
    for ea, eb in zip(da["traceEvents"], db["traceEvents"]):
        assert eb["ts"] == pytest.approx(ea["ts"] + offset_us, abs=1.0)


def test_export_trace_refuses_records_with_no_anchor(tmp_path, capsys):
    recs = _anchored(10.0, 1_790_000_000_000_000_000, 1)[1:]
    path = tmp_path / "bare.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in recs))
    out = tmp_path / "t.json"
    assert obs_main(["export-trace", str(path), "-o", str(out),
                     "--like", _profiler_file(tmp_path, 0)]) == 2
    assert "no obs.clock anchor" in capsys.readouterr().err
    assert not out.exists()
    # without --like the log exports on its own monotonic clock
    assert obs_main(["export-trace", str(path), "-o", str(out)]) == 0


def test_export_trace_of_a_bundle_through_its_manifests_anchor(
        port_obs, tmp_path, capsys):
    flight.FLIGHT.arm(str(tmp_path / "bundles"))
    with tracing.trace_span("reconnect.attempt", n=1):
        events.emit("session.connect", attempt=1)
    bundle = flight.FLIGHT.dump("session-failed")
    base_ns = 1_790_000_000_000_000_000
    out = tmp_path / "t.json"
    assert obs_main(["export-trace", bundle, "-o", str(out),
                     "--like", _profiler_file(tmp_path, base_ns)]) == 0
    got = {e["name"]: e["ts"] for e in json.loads(out.read_text())
           ["traceEvents"]}
    want = {r.get("span", r.get("event")): r["ts"] for r in
            tracing.rebase(tracing.SPANS.spans() + events.EVENTS.events(),
                           base_ns, tracing.CLOCK)}
    assert {"reconnect.attempt", "session.connect"} <= set(got)
    assert got == pytest.approx({k: want[k] * 1e6 for k in got}, abs=1.0)
