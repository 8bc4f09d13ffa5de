"""The readers of the program's spans inside the two benchmarked paths,
on made-up traces."""

import numpy as np
import pytest

from portbench import catalog, readers, trace

GIB = 1 << 30


def ev(name, ts, dur, cat="user_annotation", tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid}


def read(metric, events, **counters):
    ctx = readers.Context(trace=trace.Trace(events), counters=counters)
    return catalog.load_module("metrics", metric).read(ctx)


def window(*events):
    return [ev(trace.WINDOW_SPAN, 0, 100_000), *events]


# two sessions, three batches each: batch k of a session dispatched at
# d_k and collected by c_k; the second session's batches take longer
SESSIONS = window(
    ev(trace.SESSION_SPAN, 0, 40_000),
    ev("decoder.blob", 1_000, 3_000),
    ev("digest.dispatch", 2_000, 500),
    ev("digest.stage", 2_100, 300),
    ev("decoder.blob", 6_000, 4_000),
    ev("digest.dispatch", 7_000, 500),
    ev("digest.collect", 8_000, 1_000),
    ev("digest.wait", 8_100, 800),
    ev("decoder.blob", 20_000, 1_000),
    ev("digest.dispatch", 30_000, 100),
    ev("digest.collect", 30_200, 300),
    ev("digest.collect", 30_600, 400),
    ev(trace.SESSION_SPAN, 50_000, 40_000),
    ev("digest.dispatch", 51_000, 100),
    ev("digest.dispatch", 60_000, 100),
    ev("digest.collect", 70_000, 1_000),
    ev("digest.dispatch", 80_000, 100),
    ev("digest.collect", 85_000, 1_000),
    ev("digest.collect", 88_000, 1_000),
    ev("aten::copy_", 88_100, 50, cat="cpu_op"),
)


def test_blob_join_leaves_out_the_digest_ranges_nested_in_a_blob():
    # blobs 3,000 + 4,000 + 1,000 us; nested: dispatch 500 in the first,
    # dispatch 500 and collect 1,000 in the second; none in the third
    got = read("blob_join_s_per_gib.recv", SESSIONS, wire_bytes=2 * GIB)
    assert got == pytest.approx((8_000 - 2_000) / 1e6 / 2)


# digest.stage 300 us, digest.wait 800 us
@pytest.mark.parametrize("metric,us", [
    ("stage_s_per_gib.recv", 300),
    ("digest_wait_s_per_gib.recv", 800),
])
def test_recv_span_seconds_per_gib(metric, us):
    assert read(metric, SESSIONS, wire_bytes=GIB) == pytest.approx(us / 1e6)


def test_inflight_pairs_dispatch_and_collect_in_order_per_session():
    # session 1: 2,000 -> 9,000, 7,000 -> 30,500, 30,000 -> 31,000;
    # session 2: 51,000 -> 71,000, 60,000 -> 86,000, 80,000 -> 89,000
    got = read("digest_inflight_ms.recv", SESSIONS, wire_bytes=GIB)
    spans_ms = [7.0, 23.5, 1.0, 20.0, 26.0, 9.0]
    assert got == pytest.approx(float(np.percentile(spans_ms, 95)))


@pytest.mark.parametrize("drop", ["digest.dispatch", "digest.collect"])
def test_inflight_is_left_out_where_a_session_does_not_pair(drop):
    # the second session loses its last range of one kind
    last = max(i for i, e in enumerate(SESSIONS) if e["name"] == drop)
    events = SESSIONS[:last] + SESSIONS[last + 1:]
    assert read("digest_inflight_ms.recv", events, wire_bytes=GIB) is None


def test_inflight_reads_ranges_inside_a_session_only():
    # a dispatch and a collect outside every session range are not paired
    events = SESSIONS + [ev("digest.dispatch", 95_000, 100),
                         ev("digest.collect", 98_000, 1_000)]
    got = read("digest_inflight_ms.recv", events, wire_bytes=GIB)
    assert got == read("digest_inflight_ms.recv", SESSIONS, wire_bytes=GIB)


CALLS = window(
    ev(trace.CALL_SPAN, 0, 50_000),
    ev("cdc.stage", 100, 2_000),
    ev("cdc.dispatch", 2_100, 100),
    ev("cdc.stage", 3_000, 2_000),
    ev("cdc.collect", 5_000, 1_000),
    ev("extents.pack", 10_000, 5_000),
    ev("extents.pack", 16_000, 5_000),
    ev("extents.collect", 30_000, 3_000),
    ev("merkle.fold", 40_000, 7_000),
)


@pytest.mark.parametrize("metric,us", [
    ("slab_stage_s_per_gib.import", 4_000),
    ("extents_pack_s_per_gib.import", 10_000),
    ("extents_collect_s_per_gib.import", 3_000),
    ("merkle_fold_s_per_gib.import", 7_000),
])
def test_import_span_seconds_per_gib(metric, us):
    got = read(metric, CALLS, file_bytes=4 * GIB)
    assert got == pytest.approx(us / 1e6 / 4)


NEW = ["blob_join_s_per_gib.recv", "stage_s_per_gib.recv",
       "digest_wait_s_per_gib.recv", "digest_inflight_ms.recv",
       "slab_stage_s_per_gib.import", "extents_pack_s_per_gib.import",
       "extents_collect_s_per_gib.import", "merkle_fold_s_per_gib.import"]


@pytest.mark.parametrize("metric", NEW)
def test_silent_where_the_program_opens_no_such_span(metric):
    # the parent's trace holds only the harness's ranges and the spans
    # it had (digest_inflight_ms reads those, so it fires there too)
    bare = window(ev(trace.SESSION_SPAN, 0, 40_000),
                  ev(trace.CALL_SPAN, 50_000, 40_000))
    assert read(metric, bare, wire_bytes=GIB, file_bytes=GIB) is None
    assert catalog.load_module("metrics", metric).read(
        readers.Context(trace=None, counters={})) is None
