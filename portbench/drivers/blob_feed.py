"""Window driver of the ``blob-feed`` configuration: a receiving peer
verifies a dat replication session.

Each pass is one session in a closed loop: a fresh
``decode(backend="cuda")`` (the port's ``CudaDecoder`` on its native
route) with a change handler that keeps each decoded ``Change`` and acks
at once, an ``on_digest`` subscriber and a finalize hook, fed the
session's wire in writes of the configuration's ``write_bytes`` from the
first byte to ``end()``.  The same wire is replayed pass after pass.
The window runs whole sessions until ``seconds`` have passed and ends
with the session under way then, so its seconds cover all its work.

Recorded per session: every digest with its kind, seq and arrival time,
every decoded change, the host time before each write, how many digests
had arrived when the finalize hook ran, and the digest pipeline's
``dispatches``.  Where the wire holds changes, ``check`` also compares
every decoded change's key, counters and value with what the writer
wrote (``wrong_changes``); a cell whose traffic has changes lists that
number among its limits.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import os
import time
from collections import Counter

import numpy as np

from portbench.gen import wire as wire_gen
from portbench.reference import blob_feed as reference_blob_feed
from portbench.trace import SESSION_SPAN
from portbench.work import blake2b as b1_work

KINDS = (("change", wire_gen.KIND_CHANGE), ("blob", wire_gen.KIND_BLOB))


def port_system(state):
    """The system under test: a fresh digest decoder of the port."""
    import dat_replication_protocol_tpu_torch as protocol

    if state.device.type == "cuda":
        return protocol.decode(backend="cuda")
    return protocol.decode(backend="cuda", device=state.device)


@dataclasses.dataclass
class State:
    cell: object
    device: object
    wire: wire_gen.Wire
    pieces: list
    last_write: dict  # kind -> write index of each item's last byte
    system: object
    expected: int
    work: dict
    notes: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Session:
    delivered: list
    changes: list
    writes: list
    at_finalize: int | None
    finished: bool
    error: str | None
    dispatches: int
    seconds: float
    cpu_s: float  # this process's CPU seconds in the session


def setup(cell, seed: int, device, system=None) -> State:
    """Make the wire from ``seed`` and warm one session."""
    t0 = time.perf_counter()
    spec = {**cell.config, **cell.params}
    w = wire_gen.make_session(spec, seed)
    t1 = time.perf_counter()
    step = int(spec["write_bytes"])
    mv = memoryview(w.buf)
    pieces = [mv[at:at + step] for at in range(0, w.nbytes, step)]
    last_write = {}
    for name, kind in KINDS:
        _, ends = w.of_kind(kind)
        last_write[name] = (ends - 1) // step
    state = State(cell=cell, device=device, wire=w, pieces=pieces,
                  last_write=last_write, system=system or port_system,
                  expected=len(w.kinds),
                  work=b1_work.work(w.ends - w.starts))
    warm = run_session(state).seconds  # every shape the window uses
    state.notes = [f"set-up: wire {t1 - t0} s, warm-up session {warm} s"]
    return state


def run_session(state: State, span=None) -> Session:
    clock = time.perf_counter
    delivered: list = []
    changes: list = []
    keep = changes.append
    final: list = []
    append = delivered.append
    t0 = clock()
    c0 = os.times()
    dec = state.system(state)

    def on_digest(kind, seq, digest):
        append((kind, seq, digest, clock()))

    dec.on_digest(on_digest)
    dec.change(lambda change, done: (keep(change), done()))
    dec.finalize(lambda done: (final.append(len(delivered)), done()))
    writes: list = []
    mark = writes.append
    error = None
    try:
        with span(SESSION_SPAN) if span else contextlib.nullcontext():
            write = dec.write
            for piece in state.pieces:
                mark(clock())
                write(piece)
            dec.end()
    except Exception as e:  # a session that fails counts as failed
        error = f"{type(e).__name__}: {e}"
    finished = bool(dec.finished and not dec.destroyed and error is None)
    pipeline = getattr(dec, "digest_pipeline", None)
    return Session(delivered=delivered, changes=changes, writes=writes,
                   at_finalize=final[0] if final else None,
                   finished=finished, error=error,
                   dispatches=int(getattr(pipeline, "dispatches", 0)),
                   seconds=clock() - t0, cpu_s=_cpu_since(c0))


def _cpu_since(t0) -> float:
    t = os.times()
    return (t.user + t.system) - (t0.user + t0.system)


def window(state: State, seconds: float, span=None) -> dict:
    """Whole sessions for ``seconds``.  What the harness keeps of each
    session is frozen out of the garbage collector's generations as the
    session ends, so that it does not slow the sessions after it."""
    sessions = []
    clock = time.perf_counter
    gc.freeze()
    t0 = clock()
    while not sessions or clock() - t0 < seconds:
        sessions.append(run_session(state, span))
        gc.freeze()
    return {"sessions": sessions, "seconds": clock() - t0}


def release(state: State) -> None:
    """The program holds no state between sessions."""


def end_to_end(state: State, win: dict) -> tuple[dict, list]:
    """``recv_gibps`` and ``verify_p95_ms``, and the lines to print."""
    done = [s for s in win["sessions"] if s.finished]
    wire_bytes = state.wire.nbytes * len(done)
    lat = latencies(state, win["sessions"])
    out = {"recv_gibps": wire_bytes / win["seconds"] / (1 << 30)}
    notes = [f"sessions {len(win['sessions'])} ({len(done)} finished), "
             f"wire bytes {wire_bytes}, window {win['seconds']} s, session "
             f"seconds {[s.seconds for s in win['sessions']]}, their "
             f"process CPU seconds {[s.cpu_s for s in win['sessions']]}"]
    if len(lat):
        out["verify_p95_ms"] = float(np.percentile(lat, 95)) * 1e3
        notes.append(f"verify samples {len(lat)}: p50 "
                     f"{float(np.percentile(lat, 50)) * 1e3} ms, p95 "
                     f"{out['verify_p95_ms']} ms")
    return out, notes


def latencies(state: State, sessions) -> np.ndarray:
    """Seconds from the write that handed each item's last byte to the
    item's digest, for every digest delivered in these sessions."""
    out = []
    for s in sessions:
        if not s.delivered:
            continue
        tw = np.asarray(s.writes)
        for name, _ in KINDS:
            rec = [(seq, t) for kind, seq, _, t in s.delivered
                   if kind == name]
            if not rec:
                continue
            seq, t = (np.asarray(x) for x in zip(*rec))
            idx = state.last_write[name]
            ok = (seq >= 0) & (seq < len(idx))
            w = idx[seq[ok]]
            ok2 = w < len(tw)
            out.append(t[ok][ok2] - tw[w[ok2]])
    return np.concatenate(out) if out else np.empty(0)


def counters(state: State, win: dict, ref) -> dict:
    """The counts the per-layer readers take: wire bytes, digests and
    dispatches of the window, and the work of B1 on its items."""
    done = [s for s in win["sessions"] if s.finished]
    n = len(done)
    return {"wire_bytes": state.wire.nbytes * n,
            "digests": sum(len(s.delivered) for s in done),
            "dispatches": sum(s.dispatches for s in done),
            "b1": {k: v * n for k, v in state.work.items()}}


def reference(state: State):
    return reference_blob_feed.expected_digests(state.wire)


def check(state: State, win: dict, ref) -> dict:
    """Each number that decides ``correct``, over every session of the
    window: sessions that did not finish, digests wrong, missing or
    repeated, digests out of seq order, digests that came after the
    finalize hook; and where the wire holds changes, decoded changes
    wrong, missing or extra."""
    failed = wrong = disorder = late = bad_changes = 0
    want_changes = [state.wire.change_record(i)
                    for i in range(state.wire.n_changes)]
    for s in win["sessions"]:
        if not s.finished:
            failed += 1
            continue
        for name, _ in KINDS:
            want = ref[name]
            got = [(seq, d) for kind, seq, d, _ in s.delivered
                   if kind == name]
            seqs = [seq for seq, _ in got]
            if seqs == list(range(len(want))) and [
                    d for _, d in got] == want:
                continue
            disorder += sum(1 for i, seq in enumerate(seqs) if seq != i)
            times = Counter(seqs)
            right = sum(1 for seq, d in got if times[seq] == 1
                        and 0 <= seq < len(want) and d == want[seq])
            wrong += (len(want) - right) + max(0, len(got) - len(want))
        at = s.at_finalize if s.at_finalize is not None else 0
        late += max(0, state.expected - at)
        bad_changes += wrong_changes(s.changes, want_changes)
    out = {"failed_sessions": failed, "wrong_digests": wrong,
           "out_of_order": disorder, "after_finalize": late}
    if want_changes:
        out["wrong_changes"] = bad_changes
    return out


def wrong_changes(got: list, want: list) -> int:
    """Expected changes not decoded as written at their place, plus
    decoded changes past the expected count."""
    right = sum(1 for c, w in zip(got, want)
                if (c.key, c.change, c.from_, c.to, bytes(c.value or b""))
                == w)
    return len(want) - right + max(0, len(got) - len(want))


def attempted(win: dict) -> tuple[int, int]:
    ss = win["sessions"]
    return len(ss), sum(1 for s in ss if not s.finished)
