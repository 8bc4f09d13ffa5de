"""The ``change-log`` configuration: its writer against the port's
encoder, its reference against the writer's table and ``hashlib``,
``correct`` on a sound run, on planted faults and on both controls, and
the change route's spans and readers, on the CPU at small sizes (the
port's plain versions stand for its kernels)."""

import dataclasses
import hashlib
import json
import os
import sys
import tempfile

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from portbench import catalog, readers, trace
from portbench.controls import change_log as controls
from portbench.drivers import blob_feed, change_log
from portbench.gen import changelog
from portbench.reference import change_log as reference

CELL = "change-log.replay1m"
CPU = torch.device("cpu")
ROWS = 20_000  # 16 writes of 64 KiB, 20 batches of 1,024 a session
SEED = 2**33 + 71


def run_cell(system=None, seed=SEED, params=None, seconds=0.01,
             trace_on=False):
    sys.path.insert(0, str(catalog.HERE))
    import run

    return run.run_cell(CELL, seed, seconds, trace_on, CPU, system=system,
                        params={"rows": ROWS, **(params or {})})


def _encoded(log, n):
    from dat_replication_protocol_tpu_torch.runtime.replay import (
        encode_change_log)

    recs = []
    for i in range(n):
        subset, key, change, from_, to, value = log.change_record(i)
        recs.append({"key": key, "change": change, "from": from_, "to": to,
                     "value": value, "subset": subset or None})
    return encode_change_log(recs)


@pytest.mark.parametrize("seed", [SEED, 7])
def test_the_writers_wire_equals_the_ports_encoder(seed):
    log = changelog.make_log({"rows": 4096}, seed)
    assert log.buf.tobytes() == _encoded(log, 4096)
    assert log.nbytes == int(log.ends[-1])
    # every item a change payload, its frame's last byte its own
    assert (log.kinds == 0).all() and (log.seqs == np.arange(4096)).all()


def test_a_seed_gives_one_wire_and_another_seed_other_values():
    a, b = (changelog.make_log({"rows": 3000}, s) for s in (SEED, SEED + 1))
    assert a.buf.tobytes() == changelog.make_log({"rows": 3000},
                                                 SEED).buf.tobytes()
    assert np.array_equal(a.starts, b.starts)
    assert np.array_equal(a.ends, b.ends)
    assert a.values != b.values
    assert [a.change_record(i)[:5] for i in range(3000)] == [
        b.change_record(i)[:5] for i in range(3000)]


def test_the_reference_reads_the_writers_table_and_hashlibs_digests():
    log = changelog.make_log({"rows": 5000}, SEED)
    ref = reference.expected(log.buf)
    assert ref["records"] == [log.change_record(i) for i in range(5000)]
    assert ref["digests"]["change"] == [
        hashlib.blake2b(log.buf[s:e].tobytes(), digest_size=32).digest()
        for s, e in zip(log.starts, log.ends)]
    assert ref["digests"]["blob"] == []
    # the shape: an empty value on every 48th row, a subset on two of three
    assert ref["records"][0] == ("", "key-0000000", 0, 0, 1, b"")
    assert [r[0] for r in ref["records"][:4]] == ["", "s", "s", ""]
    assert [len(r[5]) for r in ref["records"][46:50]] == [46, 47, 0, 1]


def _frame(payload: bytes, type_id: int = 1) -> bytes:
    from portbench.gen.wire import frame_header

    return frame_header(len(payload), type_id) + payload


@pytest.mark.parametrize("payload,want", [
    # no subset, no value: the protobuf defaults
    (b"\x12\x01k\x18\x05\x20\x00\x28\x01", ("", "k", 5, 0, 1, b"")),
    # a multi-byte varint and a field given twice (the last one holds)
    (b"\x0a\x01a\x0a\x01b\x12\x01k\x18\x80\x01\x20\x00\x28\x01",
     ("b", "k", 128, 0, 1, b"")),
])
def test_the_reference_reads_defaults_and_protobuf_rules(payload, want):
    records, starts, ends = reference.decode_log(
        np.frombuffer(_frame(payload) * 2, np.uint8))
    assert records == [want, want]
    assert starts.tolist() == [2, 4 + len(payload)]


@pytest.mark.parametrize("wire", [
    _frame(b"\x12\x01k\x18\x05\x20\x00\x28\x01", type_id=2),  # a blob
    _frame(b"\x12\x01k\x18\x05\x20\x00"),  # no `to`
    _frame(b"\x12\x01k\x18\x05\x20\x00\x28\x01\x38\x01"),  # field 7
    _frame(b"\x12\x01k\x18\x05\x20\x00\x28\x01")[:-1],  # cut frame
    _frame(b"\x12\x05k\x18\x05"),  # a key past the payload
], ids=["blob", "missing", "unknown", "cut", "overrun"])
def test_the_reference_refuses_what_the_log_cannot_hold(wire):
    with pytest.raises(ValueError):
        reference.decode_log(np.frombuffer(wire, np.uint8))


def test_a_sound_run_is_correct():
    result, checks = run_cell()
    assert result["correct"], checks
    assert checks == {"failed_sessions": 0, "wrong_digests": 0,
                      "out_of_order": 0, "after_finalize": 0,
                      "wrong_changes": 0}
    assert set(result["metrics"]) == {"recv_gibps", "verify_p95_ms",
                                      "setup_s"}


def _tampered(fault):
    """The port's decoder with one fault planted where its answers are
    handed to the application."""
    def system(state):
        dec = blob_feed.port_system(state)
        register_change, register_digest = dec.change, dec.on_digest

        def change(handler):
            seen = [0]

            def faulty(c, done):
                seen[0] += 1
                if seen[0] == 7:
                    if fault == "row-left-out":
                        return done()
                    if fault == "row-repeated":
                        handler(c, lambda: None)
                    if fault == "value-altered":
                        c = dataclasses.replace(c, value=c.value + b"x")
                if fault == "subset-dropped":
                    c = dataclasses.replace(c, subset="")
                return handler(c, done)

            return register_change(faulty)

        def on_digest(cb):
            def faulty(kind, seq, digest):
                if fault == "digest-altered" and seq == 7:
                    digest = bytes([digest[0] ^ 1]) + digest[1:]
                cb(kind, seq, digest)

            return register_digest(faulty)

        dec.change, dec.on_digest = change, on_digest
        return dec

    return system


@pytest.mark.parametrize("fault,number", [
    ("subset-dropped", "wrong_changes"),
    ("value-altered", "wrong_changes"),
    ("row-left-out", "wrong_changes"),
    ("digest-altered", "wrong_digests"),
    ("row-repeated", "wrong_changes"),
])
def test_faults_are_not_correct(fault, number):
    result, checks = run_cell(_tampered(fault))
    assert not result["correct"]
    assert checks[number] > 0
    if number == "wrong_changes":
        assert checks["wrong_digests"] == 0


@pytest.mark.parametrize("control,number", [
    ("late-finalize", "after_finalize"),
    ("subset-dropped", "wrong_changes"),
])
def test_controls_are_not_correct(control, number):
    result, checks = run_cell(controls.SYSTEMS[control])
    assert not result["correct"]
    assert checks[number] > 0
    assert checks["wrong_digests"] == checks["out_of_order"] == 0
    assert sum(checks.values()) == checks[number]
    if control == "subset-dropped":  # the rows written with a subset
        assert checks[number] == 2 * ROWS // 3 * result["attempted"]


def test_the_port_decodes_a_row_without_a_subset_as_empty():
    import dat_replication_protocol_tpu_torch as protocol

    log = changelog.make_log({"rows": 3000}, SEED)
    got = []
    dec = protocol.decode(backend="cuda", device=CPU)
    dec.change(lambda c, done: (got.append(c), done()))
    dec.write(log.buf.tobytes())
    dec.end()
    assert dec.finished and dec.change_runs == 1
    assert [c.subset for c in got[:3]] == ["", "s", "s"]
    assert list(map(change_log.record_of, got)) == [
        log.change_record(i) for i in range(3000)]


def _traced_window(state):
    """A window of sessions under a CPU profiler, reduced as the traced
    run reduces it (the capture of ``portbench/trace.py`` waits on the
    card, so the CPU's is made here)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(trace.WINDOW_SPAN):
            win = change_log.window(state, 0.01, span=record_function)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path, encoding="utf-8") as f:
            return win, trace.Trace(json.load(f)["traceEvents"])
    finally:
        os.unlink(path)


def test_the_change_route_spans_fire_and_the_readers_read():
    cell = catalog.load_cell(CELL)
    cell.params = {"rows": ROWS}
    state = change_log.setup(cell, SEED, CPU)
    win, tr = _traced_window(state)
    ref = change_log.reference(state)
    assert not any(change_log.check(state, win, ref).values())
    counters = change_log.counters(state, win, ref)
    n = len(win["sessions"])
    runs = tr.span_count("decoder.change_run")
    # a run a 64 KiB write, never a run a row
    assert n * 15 <= runs <= n * 17
    assert tr.span_count("digest.submit") == runs
    assert counters["rows"] == n * ROWS
    ctx = readers.Context(trace=tr, counters=counters)
    got = {m: catalog.load_module("metrics", m).read(ctx) for m in (
        "change_run_s_per_mrow.log", "change_submit_s_per_mrow.log",
        "rows_per_run.log", "items_per_dispatch.recv",
        "digest_inflight_ms.recv", "parse_s_per_gib.recv",
        "stage_s_per_gib.recv")}
    assert all(v is not None and v > 0 for v in got.values()), got
    assert got["rows_per_run.log"] == n * ROWS / runs
    assert got["items_per_dispatch.recv"] == ROWS / 20
    assert got["change_run_s_per_mrow.log"] == pytest.approx(
        tr.span_seconds("decoder.change_run") / (n * ROWS / 1e6))


def ev(name, ts, dur):
    return {"ph": "X", "name": name, "cat": "user_annotation", "ts": ts,
            "dur": dur, "pid": 1, "tid": 1}


def _read(metric, events, **counters):
    ctx = readers.Context(trace=trace.Trace(events), counters=counters)
    return catalog.load_module("metrics", metric).read(ctx)


RUNS = [ev(trace.WINDOW_SPAN, 0, 100_000),
        ev(trace.SESSION_SPAN, 0, 90_000),
        ev("decoder.change_run", 1_000, 4_000),
        ev("digest.submit", 5_000, 3_000),
        ev("digest.dispatch", 6_000, 500),
        ev("digest.stage", 6_100, 200),
        ev("digest.collect", 7_000, 600),
        ev("decoder.change_run", 10_000, 6_000),
        ev("digest.submit", 16_000, 1_000),
        # the finalize flush: outside every submit
        ev("digest.dispatch", 20_000, 700),
        ev("digest.collect", 21_000, 900)]


def test_the_readers_on_a_made_up_trace():
    # change runs 4,000 + 6,000 us over 2,000,000 rows; submits 3,000 +
    # 1,000 us less the 500 + 600 us nested in the first
    assert _read("change_run_s_per_mrow.log", RUNS, rows=2_000_000) == pytest.approx(0.010 / 2)
    assert _read("change_submit_s_per_mrow.log", RUNS, rows=2_000_000) == pytest.approx(0.0029 / 2)
    assert _read("rows_per_run.log", RUNS, rows=2_000_000) == 1_000_000


@pytest.mark.parametrize("metric", ["change_run_s_per_mrow.log",
                                    "change_submit_s_per_mrow.log",
                                    "rows_per_run.log"])
def test_silent_where_the_program_has_no_such_span_or_count(metric):
    # the parent's program: the harness's ranges and the pipeline's own
    bare = [e for e in RUNS if e["name"] not in ("decoder.change_run",
                                                 "digest.submit")]
    assert _read(metric, bare, rows=2_000_000) is None
    assert catalog.load_module("metrics", metric).read(
        readers.Context(trace=None, counters={"rows": 2_000_000})) is None
