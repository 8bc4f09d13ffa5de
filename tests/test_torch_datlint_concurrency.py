"""The port's whole-program concurrency analyzer and readiness
certifier, held to the JAX package's.

A port of ``test_datlint_concurrency.py`` and ``test_datlint_readiness.py``
onto ``dat_replication_protocol_tpu_torch.analysis``: fixture suites for
lock-order, blocking-under-lock and guarded-state, the
wire-dispatch-parity matrix rule, the structured CLI (--json /
--baseline / --stats / --lock-graph / --format / --write-artifacts),
the may-block summary lattice, blocking-reachability, callback-escape
and the certificate renderer.  Every fixture also goes through
``datlint_parity``, which runs both analyzers on it and requires the
same findings.  The regression tests of production fixes run against
the port's own ``fanout/`` and ``obs/events.py``.

Fixture doctrine (same as test_torch_datlint.py): each bad fixture is a
minimal re-creation of the PRE-fix repo pattern — if a rule stops
firing on it, the analyzer has lost the bug class that motivated it.
"""

import json
import textwrap

import pytest

from datlint_parity import datlint_main, run_paths
from dat_replication_protocol_tpu_torch.analysis.concurrency import (
    BlockingReachability,
    BlockingUnderLock,
    CallbackEscape,
    GuardedState,
    LockOrder,
    ReadinessIndex,
    render_event_loop_surface,
)
from dat_replication_protocol_tpu_torch.analysis.engine import Project
from dat_replication_protocol_tpu_torch.obs import events as port_events
from dat_replication_protocol_tpu_torch.obs import metrics as port_metrics


@pytest.fixture
def port_obs():
    """The port's obs gate on, its registry and event ring reset."""
    was_on = port_metrics.OBS.on
    port_metrics.REGISTRY.reset()
    port_events.EVENTS.clear()
    port_metrics.enable()
    try:
        yield port_metrics
    finally:
        port_metrics.OBS.on = was_on
        port_metrics.REGISTRY.reset()
        port_events.EVENTS.clear()


CONC_RULES = (LockOrder(), BlockingUnderLock(), GuardedState())


def _lint(tmp_path, *files, rules=CONC_RULES):
    for name, source in files:
        (tmp_path / name).write_text(textwrap.dedent(source))
    return run_paths([tmp_path], rules=rules)


def _rules_fired(findings):
    return {f.rule for f in findings}


# -- lock-order: inversions ---------------------------------------------------

# the classic: one thread locks a then b, another locks b then a
TWO_LOCK_INVERSION = '''
import threading

class Engine:
    def __init__(self):
        self._alock = threading.Lock()
        self._block = threading.Lock()

    def forward(self):
        with self._alock:
            with self._block:
                pass

    def backward(self):
        with self._block:
            with self._alock:
                pass
'''


def test_lock_order_fires_on_two_lock_inversion(tmp_path):
    findings = _lint(tmp_path, ("inv.py", TWO_LOCK_INVERSION))
    assert "lock-order" in _rules_fired(findings)
    inv = [f for f in findings if f.rule == "lock-order"]
    # the finding cites BOTH acquisition chains (one per direction)
    assert inv[0].chains and len(inv[0].chains) == 2
    assert "forward" in inv[0].message and "backward" in inv[0].message


def test_lock_order_fires_on_three_lock_cycle(tmp_path):
    findings = _lint(tmp_path, ("cycle3.py", '''
        import threading

        A = threading.Lock()
        B = threading.Lock()
        C = threading.Lock()

        def ab():
            with A:
                with B:
                    pass

        def bc():
            with B:
                with C:
                    pass

        def ca():
            with C:
                with A:
                    pass
    '''))
    inv = [f for f in findings if f.rule == "lock-order"]
    assert inv, findings
    assert len(inv[0].chains) == 3  # one chain per cycle edge


def test_lock_order_is_whole_program_across_files(tmp_path):
    # each file is single-order-clean; only the cross-file composition
    # inverts — the exact blind spot of a per-file pass.  (The import
    # cycle is fine: the analyzer reads ASTs, nothing executes.)
    findings = _lint(
        tmp_path,
        ("liblog.py", '''
            import threading
            from server import SRV

            class Log:
                def __init__(self):
                    self._lock = threading.Lock()

                def append(self, data):
                    with self._lock:
                        pass

                def flush(self):
                    # log -> server, while publish does server -> log
                    with self._lock:
                        SRV.wake()

            LOG = Log()
        '''),
        ("server.py", '''
            import threading
            from liblog import LOG

            class Server:
                def __init__(self):
                    self._lock = threading.Lock()

                def wake(self):
                    with self._lock:
                        pass

                def publish(self, data):
                    with self._lock:
                        LOG.append(data)

            SRV = Server()
        '''))
    inv = [f for f in findings if f.rule == "lock-order"]
    assert inv, findings
    assert "Log._lock" in inv[0].message and "Server._lock" in inv[0].message


def test_lock_order_rlock_reentry_is_a_non_finding(tmp_path):
    assert _lint(tmp_path, ("re.py", '''
        import threading

        class R:
            def __init__(self):
                self._lock = threading.RLock()

            def outer(self):
                with self._lock:
                    self.inner()

            def inner(self):
                with self._lock:
                    pass
    ''')) == []


def test_lock_order_plain_lock_reentry_fires(tmp_path):
    findings = _lint(tmp_path, ("self.py", '''
        import threading

        class R:
            def __init__(self):
                self._lock = threading.Lock()

            def outer(self):
                with self._lock:
                    self.inner()

            def inner(self):
                with self._lock:
                    pass
    '''))
    inv = [f for f in findings if f.rule == "lock-order"]
    assert inv and "self-deadlock" in inv[0].message, findings


def test_lock_order_condition_aliases_its_wrapped_lock(tmp_path):
    # acquiring the Condition IS acquiring the wrapped plain lock:
    # lock -> cv re-entry must be caught as a self-deadlock
    findings = _lint(tmp_path, ("cv.py", '''
        import threading

        class W:
            def __init__(self):
                self._lock = threading.Lock()
                self._cv = threading.Condition(self._lock)

            def poke(self):
                with self._lock:
                    with self._cv:
                        pass
    '''))
    inv = [f for f in findings if f.rule == "lock-order"]
    assert inv and "self-deadlock" in inv[0].message, findings


def test_lock_order_consistent_order_is_clean(tmp_path):
    assert _lint(tmp_path, ("ok.py", '''
        import threading

        A = threading.Lock()
        B = threading.Lock()

        def one():
            with A:
                with B:
                    pass

        def two():
            with A:
                with B:
                    pass
    ''')) == []


def test_lock_order_suppression_works(tmp_path):
    src = TWO_LOCK_INVERSION.replace(
        "        with self._alock:\n            with self._block:",
        "        with self._alock:\n            # datlint: disable=lock-order"
        "\n            with self._block:")
    assert _lint(tmp_path, ("inv.py", src)) == []


# -- blocking-under-lock: each blocked class ---------------------------------

def _blocking_fixture(body):
    return f'''
import os
import socket
import subprocess
import threading
import time

class S:
    def __init__(self):
        self._lock = threading.Lock()
        self.sock = socket.socket()
        self.on_data = None

    def run(self, fd, cb, data):
        with self._lock:
{textwrap.indent(textwrap.dedent(body), "            ")}
'''


@pytest.mark.parametrize("body,cls", [
    ("self.sock.sendall(data)", "socket"),
    ("os.write(fd, data)", "os-io"),
    ("time.sleep(0.1)", "sleep"),
    ("subprocess.run(['true'])", "subprocess"),
    ("open('/tmp/x', 'wb')", "file-io"),
    ("cb(data)", "callback"),           # a parameter IS user code
    ("self.on_data(data)", "callback"),  # on_* attribute ditto
])
def test_blocking_under_lock_fires_per_class(tmp_path, body, cls):
    findings = _lint(tmp_path, ("b.py", _blocking_fixture(body)))
    hits = [f for f in findings if f.rule == "blocking-under-lock"]
    assert hits, (body, findings)
    assert f"[{cls}]" in hits[0].message


def test_blocking_under_lock_propagates_through_calls(tmp_path):
    # the helper contains no `with` at all — only the call graph knows
    # it runs locked (the single-file blind spot, closed)
    findings = _lint(tmp_path, ("t.py", '''
        import threading
        import time

        _lock = threading.Lock()

        def helper():
            time.sleep(1)

        def entry():
            with _lock:
                helper()
    '''))
    hits = [f for f in findings if f.rule == "blocking-under-lock"]
    assert hits, findings
    assert "entry" in hits[0].message and "helper" in hits[0].message


def test_blocking_under_lock_clean_outside_lock(tmp_path):
    assert _lint(tmp_path, ("ok.py", '''
        import threading
        import time

        _lock = threading.Lock()

        def entry():
            with _lock:
                n = 1 + 1
            time.sleep(n)
    ''')) == []


def test_blocking_allow_marker_accepts_the_site(tmp_path):
    assert _lint(tmp_path, ("a.py", '''
        import threading
        import time

        _lock = threading.Lock()

        def entry():
            with _lock:
                # justified: <why>  datlint: allow-blocking-under-lock
                time.sleep(0.1)
    ''')) == []


def test_blocking_allow_marker_is_class_scoped(tmp_path):
    findings = _lint(tmp_path, ("a.py", '''
        import threading
        import time

        _lock = threading.Lock()

        def entry(sock, data):
            with _lock:
                # datlint: allow-blocking-under-lock(sleep)
                time.sleep(0.1)
                sock.sendall(data)
    '''))
    hits = [f for f in findings if f.rule == "blocking-under-lock"]
    # the scoped allow covers sleep but NOT the socket write
    assert len(hits) == 1 and "[socket]" in hits[0].message, findings


def test_blocking_allow_is_lexical_only(tmp_path):
    """An allow next to the blocking site excuses only the locks
    VISIBLE there: a lock smuggled in by a caller still reports, so an
    audited leaf can never silently cover new locked callers."""
    findings = _lint(tmp_path, ("leaf.py", '''
        import threading
        import time

        _outer = threading.Lock()

        def leaf():
            # datlint: allow-blocking-under-lock
            time.sleep(0.1)

        def caller():
            with _outer:
                leaf()
    '''))
    hits = [f for f in findings if f.rule == "blocking-under-lock"]
    assert hits and "_outer" in hits[0].message, findings


def test_blocking_allow_at_call_site_covers_the_callee(tmp_path):
    # the sink-serializer idiom: the lock is held around a helper whose
    # entire job is the I/O it guards — the allow goes ON THE CALL
    assert _lint(tmp_path, ("sink.py", '''
        import threading
        import time

        class Sink:
            def __init__(self):
                self._lock = threading.Lock()

            def _io(self, data):
                time.sleep(0.1)

            def write(self, data):
                with self._lock:
                    # serializing is this lock's job:
                    # datlint: allow-blocking-under-lock
                    self._io(data)
    ''')) == []


# -- guarded-state ------------------------------------------------------------

GUARDED_BAD = '''
import threading

class Table:
    # datlint: guarded-by(self._lock): self._rows
    def __init__(self):
        self._lock = threading.Lock()
        self._rows = {}

    def put(self, k, v):
        with self._lock:
            self._rows[k] = v

    def forgot(self, k):
        self._rows[k] = None
'''


def test_guarded_state_fires_on_unguarded_write(tmp_path):
    findings = _lint(tmp_path, ("g.py", GUARDED_BAD))
    hits = [f for f in findings if f.rule == "guarded-state"]
    assert hits and "forgot" in hits[0].message, findings
    # the guarded write and the __init__ construction are NOT findings
    assert len(hits) == 1


def test_guarded_state_accepts_locked_helper_via_call_graph(tmp_path):
    # the *_locked idiom: no lexical `with`, but every known caller
    # holds the lock — proven through the entry-held fixpoint
    assert _lint(tmp_path, ("h.py", '''
        import threading

        class Table:
            # datlint: guarded-by(self._lock): self._rows
            def __init__(self):
                self._lock = threading.Lock()
                self._rows = {}

            def put(self, k, v):
                with self._lock:
                    self._put_locked(k, v)

            def drop(self, k):
                with self._lock:
                    self._put_locked(k, None)

            def _put_locked(self, k, v):
                self._rows[k] = v
    ''')) == []


def test_guarded_state_rejects_helper_with_one_unlocked_caller(tmp_path):
    findings = _lint(tmp_path, ("h.py", '''
        import threading

        class Table:
            # datlint: guarded-by(self._lock): self._rows
            def __init__(self):
                self._lock = threading.Lock()
                self._rows = {}

            def put(self, k, v):
                with self._lock:
                    self._put_locked(k, v)

            def sneaky(self, k):
                self._put_locked(k, None)

            def _put_locked(self, k, v):
                self._rows[k] = v
    '''))
    hits = [f for f in findings if f.rule == "guarded-state"]
    assert hits, findings


def test_guarded_state_counts_container_mutators_as_writes(tmp_path):
    findings = _lint(tmp_path, ("m.py", '''
        import threading

        class Q:
            # datlint: guarded-by(self._lock): self._items
            def __init__(self):
                self._lock = threading.Lock()
                self._items = []

            def ok(self, x):
                with self._lock:
                    self._items.append(x)

            def bad(self, x):
                self._items.append(x)
    '''))
    hits = [f for f in findings if f.rule == "guarded-state"]
    assert len(hits) == 1 and "mutator:append" in hits[0].message, findings


def test_guarded_state_suppression_works(tmp_path):
    src = GUARDED_BAD.replace(
        "        self._rows[k] = None",
        "        # single-threaded teardown: datlint: disable=guarded-state"
        "\n        self._rows[k] = None")
    assert _lint(tmp_path, ("g.py", src)) == []


# the cursor-coherence lesson: a declaration the rule cannot honor is
# LOUD, never a silent disarm
@pytest.mark.parametrize("old,new,needle", [
    # unparsable member: the whole declaration is ignored, loudly
    ("guarded-by(self._lock): self._rows",
     "guarded-by(self._lock): self._rows ,, junk(",
     "unparsable member"),
    # lock name that resolves to no known lock
    ("guarded-by(self._lock): self._rows",
     "guarded-by(self._no_such_lock): self._rows",
     "does not resolve"),
    # member no function ever writes: stale/typo'd spelling
    ("guarded-by(self._lock): self._rows",
     "guarded-by(self._lock): self._typo_rows",
     "ever writes it"),
])
def test_guarded_state_unhonorable_declarations_are_loud(
        tmp_path, old, new, needle):
    src = GUARDED_BAD.replace(old, new)
    findings = _lint(tmp_path, ("g.py", src))
    msgs = [f.message for f in findings if f.rule == "guarded-state"]
    assert any(needle in m for m in msgs), (needle, findings)


def test_guarded_state_self_member_outside_class_is_loud(tmp_path):
    findings = _lint(tmp_path, ("mod.py", '''
        import threading

        _lock = threading.Lock()
        # datlint: guarded-by(_lock): self._rows

        def f():
            pass
    '''))
    msgs = [f.message for f in findings if f.rule == "guarded-state"]
    assert any("outside any class" in m for m in msgs), findings


def test_guarded_state_module_level_globals(tmp_path):
    findings = _lint(tmp_path, ("mod.py", '''
        import threading

        _lock = threading.Lock()
        _cache = {}
        # datlint: guarded-by(_lock): _cache

        def ok(k, v):
            global _cache
            with _lock:
                _cache = {k: v}

        def bad(k):
            global _cache
            _cache = {}
    '''))
    hits = [f for f in findings if f.rule == "guarded-state"]
    assert len(hits) == 1 and "bad" in hits[0].message, findings


# -- wire-dispatch-parity -----------------------------------------------------

WIRE_OK = (
    ("framing.py", '''
        TYPE_HEADER = 0
        TYPE_CHANGE = 1
        TYPE_BLOB = 2
        KNOWN_TYPES = (TYPE_CHANGE, TYPE_BLOB)
    '''),
    ("decoder.py", '''
        from framing import TYPE_BLOB, TYPE_CHANGE

        def trace(kind):
            pass

        class Decoder:
            def __init__(self):
                self.changes = 0
                self.blobs = 0

            def _scan_header(self, type_id):
                if type_id == TYPE_CHANGE:
                    trace(kind="change")
                elif type_id == TYPE_BLOB:
                    trace(kind="blob")

            def _run_indexed(self, ids):
                for type_id in ids:
                    if type_id == TYPE_CHANGE:
                        self.changes += 1
                    elif type_id == TYPE_BLOB:
                        self.blobs += 1

            def _frames_delivered(self):
                return self.changes + self.blobs
    '''),
)


def _wire_lint(tmp_path, *files):
    from dat_replication_protocol_tpu_torch.analysis.rules.wire_dispatch import (
        WireDispatchParity,
    )

    return _lint(tmp_path, *files, rules=[WireDispatchParity()])


def test_wire_dispatch_full_matrix_is_clean(tmp_path):
    assert _wire_lint(tmp_path, *WIRE_OK) == []


def test_wire_dispatch_fires_when_scanner_misses_a_type(tmp_path):
    framing = ("framing.py", WIRE_OK[0][1].replace(
        "KNOWN_TYPES = (TYPE_CHANGE, TYPE_BLOB)",
        "TYPE_NEW = 3\n        "
        "KNOWN_TYPES = (TYPE_CHANGE, TYPE_BLOB, TYPE_NEW)"))
    findings = _wire_lint(tmp_path, framing, WIRE_OK[1])
    msgs = [f.message for f in findings
            if f.rule == "wire-dispatch-parity"]
    assert any("TYPE_NEW" in m and "half-wired" in m
               and "_scan_header" in m for m in msgs), findings


def test_wire_dispatch_fires_per_missing_surface(tmp_path):
    # TYPE_BLOB wired into the scanner only: bulk, accounting, and
    # tracing must all be named missing
    decoder = ("decoder.py", '''
        from framing import TYPE_BLOB, TYPE_CHANGE

        def trace(kind):
            pass

        class Decoder:
            def __init__(self):
                self.changes = 0

            def _scan_header(self, type_id):
                if type_id == TYPE_CHANGE:
                    trace(kind="change")
                elif type_id == TYPE_BLOB:
                    pass

            def _run_indexed(self, ids):
                for type_id in ids:
                    if type_id == TYPE_CHANGE:
                        self.changes += 1

            def _frames_delivered(self):
                return self.changes
    ''')
    findings = _wire_lint(tmp_path, WIRE_OK[0], decoder)
    msgs = [f.message for f in findings
            if f.rule == "wire-dispatch-parity" and "TYPE_BLOB" in f.message]
    assert msgs, findings
    m = msgs[0]
    assert "_run_indexed" in m and "_frames_delivered" in m \
        and 'kind="blob"' in m


def test_wire_dispatch_type_outside_known_types_is_loud(tmp_path):
    framing = ("framing.py",
               WIRE_OK[0][1].rstrip() + "\n        TYPE_ROGUE = 9\n")
    findings = _wire_lint(tmp_path, framing, WIRE_OK[1])
    msgs = [f.message for f in findings
            if f.rule == "wire-dispatch-parity"]
    assert any("TYPE_ROGUE" in m and "KNOWN_TYPES" in m for m in msgs)


def test_wire_dispatch_lost_anchor_is_loud(tmp_path):
    # renaming _scan_header must not silently disarm the matrix
    decoder = ("decoder.py", WIRE_OK[1][1].replace(
        "_scan_header", "_scan_hdr"))
    findings = _wire_lint(tmp_path, WIRE_OK[0], decoder)
    msgs = [f.message for f in findings
            if f.rule == "wire-dispatch-parity"]
    assert any("lost its anchor" in m for m in msgs), findings


# -- structured CLI -----------------------------------------------------------

def test_cli_json_output_carries_chains(tmp_path, capsys):
    (tmp_path / "inv.py").write_text(textwrap.dedent(TWO_LOCK_INVERSION))
    rc = datlint_main([str(tmp_path), "--rule", "lock-order", "--json"])
    out = json.loads(capsys.readouterr().out)
    assert rc == 1
    assert out["findings"], out
    f = out["findings"][0]
    assert set(f) == {"rule", "path", "line", "message", "chains"}
    assert f["rule"] == "lock-order" and len(f["chains"]) == 2


def test_cli_baseline_accepts_known_findings(tmp_path, capsys):
    (tmp_path / "inv.py").write_text(textwrap.dedent(TWO_LOCK_INVERSION))
    base = tmp_path / "baseline.json"
    rc = datlint_main([str(tmp_path), "--rule", "lock-order",
                       "--write-baseline", str(base)])
    assert rc == 0 and json.loads(base.read_text())["accept"]
    capsys.readouterr()
    # accepted: the same findings no longer fail the run
    rc = datlint_main([str(tmp_path), "--rule", "lock-order",
                       "--baseline", str(base)])
    assert rc == 0
    assert "baseline-accepted" in capsys.readouterr().out
    # ...but a NEW finding still does
    (tmp_path / "new.py").write_text(textwrap.dedent('''
        import threading

        class N:
            def __init__(self):
                self._xlock = threading.Lock()
                self._ylock = threading.Lock()

            def f(self):
                with self._xlock:
                    with self._ylock:
                        pass

            def g(self):
                with self._ylock:
                    with self._xlock:
                        pass
    '''))
    rc = datlint_main([str(tmp_path), "--rule", "lock-order",
                       "--baseline", str(base)])
    assert rc == 1


def test_cli_unreadable_baseline_is_a_usage_error(tmp_path):
    (tmp_path / "ok.py").write_text("x = 1\n")
    bad = tmp_path / "broken.json"
    bad.write_text("{not json")
    assert datlint_main([str(tmp_path), "--baseline", str(bad)]) == 2


def test_cli_stats_reports_per_rule_time(tmp_path, capsys):
    (tmp_path / "ok.py").write_text("x = 1\n")
    rc = datlint_main([str(tmp_path), "--rule", "lock-order", "--stats"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "stats: lock-order:" in out and "stats: TOTAL:" in out


def test_cli_lock_graph_is_deterministic(tmp_path, capsys):
    (tmp_path / "l.py").write_text(textwrap.dedent('''
        import threading

        class A:
            def __init__(self):
                self._lock = threading.Lock()

            def f(self):
                with self._lock:
                    pass
    '''))
    g1, g2 = tmp_path / "g1.json", tmp_path / "g2.json"
    datlint_main([str(tmp_path / "l.py"), "--lock-graph", str(g1)])
    datlint_main([str(tmp_path / "l.py"), "--lock-graph", str(g2)])
    capsys.readouterr()
    assert g1.read_bytes() == g2.read_bytes()
    doc = json.loads(g1.read_text())
    assert doc["locks"] and doc["locks"][0]["id"] == "l.py::A._lock"


# -- regression tests for the true positives fixed in production -------------
#
# Each of these encodes the post-fix behavior of a finding the
# whole-program pass produced on the real tree (ANALYSIS.md table).
# The aggregate guard is test_datlint_repo_clean.py; these pin the
# BEHAVIOR the fixes must preserve.

def test_fanout_trim_event_survives_the_deferred_emit(port_obs):
    # fanout.trim used to be emitted INSIDE the log lock; it now rides
    # _maybe_trim_locked's return value out — same event, lock released
    from dat_replication_protocol_tpu_torch.fanout.log import BroadcastLog
    from dat_replication_protocol_tpu_torch.obs.events import EVENTS

    log = BroadcastLog(retention_budget=64)
    log.append(b"x" * 256)
    log.enforce_retention()
    trims = EVENTS.events("fanout.trim")
    assert trims, "retention trim no longer emits fanout.trim"
    assert trims[-1]["fields"]["trimmed"] > 0


def test_fanout_attach_refusal_still_emits_snapshot_needed(port_obs):
    from dat_replication_protocol_tpu_torch.fanout.log import (
        BroadcastLog,
        SnapshotNeeded,
    )
    from dat_replication_protocol_tpu_torch.obs.events import EVENTS

    log = BroadcastLog(retention_budget=64)
    log.append(b"x" * 256)
    log.enforce_retention()
    with pytest.raises(SnapshotNeeded):
        log.attach("late", 0)
    evs = EVENTS.events("fanout.snapshot_needed")
    assert evs and evs[-1]["fields"]["offset"] == 0


def test_eventlog_clear_resets_sink_dropped_under_its_own_lock():
    # clear() used to reset sink_dropped under _lock while the sink
    # path increments it under _sink_lock — a lost-update the
    # guarded-state declaration now forbids
    from dat_replication_protocol_tpu_torch.obs.events import EventLog

    log = EventLog(capacity=4)
    log.sink_dropped = 3
    log.dropped = 2
    log.clear()
    assert log.sink_dropped == 0 and log.dropped == 0


def test_attach_peer_dup_failure_rolls_back_the_cursor(monkeypatch):
    # os.dup moved INSIDE the rollback scope: an EMFILE after
    # log.attach must detach the provisional cursor, or the peer key
    # is unusable until process restart
    import os
    import socket

    from dat_replication_protocol_tpu_torch.fanout.log import BroadcastLog
    from dat_replication_protocol_tpu_torch.fanout.server import FanoutServer

    log = BroadcastLog()
    log.append(b"x" * 64)
    srv = FanoutServer(log)
    a, b = socket.socketpair()
    try:
        def _emfile(fd):
            raise OSError(24, "Too many open files")

        monkeypatch.setattr(os, "dup", _emfile)
        with pytest.raises(OSError):
            srv.attach_peer("k", fd=a.fileno(), offset=0)
        monkeypatch.undo()
        # the key must be reusable: the provisional cursor was detached
        peer = srv.attach_peer("k", sink=lambda views: sum(
            len(v) for v in views), offset=0)
        srv.seal()
        assert srv.drain()
        assert peer.wait_done()
    finally:
        srv.close()
        a.close()
        b.close()


def test_guarded_state_baseline_keys_are_line_number_free(tmp_path):
    # the declaration site lives in the finding's SECOND sentence:
    # Finding.key() keeps only the first, so a --baseline entry must
    # survive unrelated edits shifting the guarded-by line
    import re

    shifted = GUARDED_BAD.replace(
        "import threading", "import threading\n\nPAD = 1\n")
    k1 = [f.key() for f in _lint(tmp_path, ("g1.py", GUARDED_BAD))
          if f.rule == "guarded-state"]
    k2 = [f.key() for f in _lint(tmp_path, ("g1.py", shifted))
          if f.rule == "guarded-state"]
    assert k1 and k1 == k2
    assert not re.search(r":\d+", k1[0].split(":", 1)[1])


def test_index_sees_defs_and_locks_in_except_handlers(tmp_path):
    # the import-shim idiom: the fallback def lives in the EXCEPT
    # handler (utils/jax_compat.py shape) — it must be in the call
    # graph, or blocking under a lock through it goes dark
    findings = _lint(tmp_path, ("shim.py", '''
import threading
import time

_lock = threading.Lock()

try:
    from nonexistent_fast_mod import helper
except ImportError:
    def helper():
        time.sleep(0.1)

def run():
    with _lock:
        helper()
'''))
    hits = [f for f in findings if f.rule == "blocking-under-lock"]
    assert hits, findings
    assert "[sleep]" in hits[0].message


def test_blocking_sees_with_item_calls(tmp_path):
    # `with open(...)` / `with helper():` — the call lives in the
    # with-ITEM expression, which the walk used to drop entirely
    findings = _lint(tmp_path, ("w.py", '''
import threading
import time

_lock = threading.Lock()

def helper():
    time.sleep(0.1)
    class _N:
        def __enter__(self): return self
        def __exit__(self, *a): return False
    return _N()

def direct(path):
    with _lock:
        with open(path, "w"):
            pass

def through_manager():
    with _lock:
        with helper():
            pass
'''))
    hits = [f for f in findings if f.rule == "blocking-under-lock"]
    classes = {m for f in hits for m in ("[file-io]", "[sleep]")
               if m in f.message}
    assert classes == {"[file-io]", "[sleep]"}, hits


def test_cli_stats_prints_with_write_baseline(tmp_path, capsys):
    (tmp_path / "c.py").write_text(textwrap.dedent(TWO_LOCK_INVERSION))
    rc = datlint_main([str(tmp_path / "c.py"), "--stats",
                       "--write-baseline", str(tmp_path / "b.json")])
    out = capsys.readouterr().out
    assert rc == 0
    assert "datlint: stats: TOTAL:" in out and "wrote" in out


def test_attach_peer_duplicate_key_is_a_server_level_error():
    from dat_replication_protocol_tpu_torch.fanout.log import BroadcastLog
    from dat_replication_protocol_tpu_torch.fanout.server import FanoutServer

    log = BroadcastLog()
    log.append(b"x" * 16)
    srv = FanoutServer(log)
    try:
        srv.attach_peer("k", sink=lambda vs: sum(len(v) for v in vs),
                        offset=0)
        with pytest.raises(ValueError, match="peer key 'k' already"):
            srv.attach_peer("k", sink=lambda vs: 0, offset=0)
    finally:
        srv.close()


def test_guarded_state_accepts_function_local_lock_alias(tmp_path):
    # 'mu = self._mu; with mu:' — the mutator write's held set comes
    # from the main walk (aliases resolved), not a lexical re-walk
    findings = _lint(tmp_path, ("a.py", '''
import threading

class Box:
    # datlint: guarded-by(self._mu): self._items
    def __init__(self):
        self._mu = threading.Lock()
        self._items = []

    def put(self, x):
        mu = self._mu
        with mu:
            self._items.append(x)
'''))
    assert not [f for f in findings if f.rule == "guarded-state"], findings


def test_cli_baseline_keys_survive_path_spelling(tmp_path, capsys):
    (tmp_path / "m.py").write_text(textwrap.dedent(TWO_LOCK_INVERSION))
    base = tmp_path / "b.json"
    # record with a RELATIVE spelling, accept with the ABSOLUTE one
    import os
    old = os.getcwd()
    os.chdir(tmp_path)
    try:
        datlint_main(["m.py", "--write-baseline", str(base)])
    finally:
        os.chdir(old)
    rc = datlint_main([str(tmp_path / "m.py"), "--baseline", str(base)])
    out = capsys.readouterr().out
    assert rc == 0 and "baseline-accepted" in out


def test_attach_peer_bad_offset_is_not_reported_as_duplicate():
    from dat_replication_protocol_tpu_torch.fanout.log import BroadcastLog
    from dat_replication_protocol_tpu_torch.fanout.server import FanoutServer

    log = BroadcastLog()
    log.append(b"x" * 8)
    srv = FanoutServer(log)
    try:
        with pytest.raises(ValueError) as ei:
            srv.attach_peer("k", sink=lambda vs: 0, offset="abc")
        assert "already attached" not in str(ei.value)
    finally:
        srv.close()


def test_guarded_state_fires_inside_closed_call_cycles(tmp_path):
    # mutually-recursive helpers with no outside caller: the entry-held
    # fixpoint used to seed them with ALL locks and converge there,
    # silently accepting an unguarded write
    findings = _lint(tmp_path, ("cyc.py", '''
import threading

class Pair:
    # datlint: guarded-by(self._lock): self._n
    def __init__(self):
        self._lock = threading.Lock()
        self._n = 0

    def ping(self, k):
        if k > 0:
            self.pong(k - 1)

    def pong(self, k):
        self._n = k
        self.ping(k)
'''))
    hits = [f for f in findings if f.rule == "guarded-state"]
    assert hits and "self._n" in hits[0].message, findings


def test_cli_json_with_write_baseline_emits_one_document(tmp_path, capsys):
    (tmp_path / "j.py").write_text(textwrap.dedent(TWO_LOCK_INVERSION))
    rc = datlint_main([str(tmp_path / "j.py"), "--json",
                       "--write-baseline", str(tmp_path / "b.json")])
    out = capsys.readouterr().out
    doc = json.loads(out)   # must parse as exactly one JSON document
    assert rc == 0 and doc["accepted_keys"] >= 1


def test_attach_peer_at_capacity_rejects_before_snapshot_redirect():
    # admission must stay the CHEAP first gate: a stale offset at a
    # full server gets FanoutBusy, not a SnapshotNeeded+hint redirect
    # into a snapshot fetch the full server would then reject
    from dat_replication_protocol_tpu_torch.fanout.log import (
        BroadcastLog,
        SnapshotNeeded,
    )
    from dat_replication_protocol_tpu_torch.fanout.server import (
        FanoutBusy,
        FanoutServer,
    )

    log = BroadcastLog(retention_budget=64)
    log.append(b"x" * 400)
    log.enforce_retention()   # offset 0 is now below the window
    srv = FanoutServer(log, max_peers=1, snapshot_hint={"port": 1})
    try:
        srv.attach_peer("a", sink=lambda vs: sum(len(v) for v in vs))
        with pytest.raises(FanoutBusy):
            try:
                srv.attach_peer("late", sink=lambda vs: 0, offset=0)
            except SnapshotNeeded:
                pytest.fail("full server redirected a joiner into the "
                            "snapshot protocol instead of FanoutBusy")
    finally:
        srv.close()


# == event-loop readiness certifier =========================================

READY_RULES = (BlockingReachability(), CallbackEscape())


def _write(tmp_path, *files):
    for name, source in files:
        (tmp_path / name).write_text(textwrap.dedent(source))
    return tmp_path


def _ready_lint(tmp_path, *files, rules=READY_RULES):
    _write(tmp_path, *files)
    return run_paths([tmp_path], rules=rules)


def _index(tmp_path, *files):
    _write(tmp_path, *files)
    run_paths([tmp_path])   # both analyzers agree on the fixture
    return ReadinessIndex.get(Project.from_paths([tmp_path]))


def _summary(idx, suffix):
    keys = [k for k in idx.fns if k.endswith(suffix)]
    assert keys, f"no function key ends with {suffix!r}: {sorted(idx.fns)}"
    return idx.fns[keys[0]].summary


# -- the summary lattice ------------------------------------------------------

def test_timeout_wait_is_bounded_bare_wait_is_not(tmp_path):
    idx = _index(tmp_path, ("w.py", '''
        import threading

        class Loop:
            def __init__(self):
                self._ev = threading.Event()

            def carries(self):
                self._ev.wait(0.5)

            def carries_kw(self):
                self._ev.wait(timeout=2.0)

            def bare(self):
                self._ev.wait()

            def explicit_none(self):
                self._ev.wait(timeout=None)
    '''))
    assert _summary(idx, "::Loop.carries") == "bounded-blocking"
    assert _summary(idx, "::Loop.carries_kw") == "bounded-blocking"
    assert _summary(idx, "::Loop.bare") == "unbounded-blocking"
    assert _summary(idx, "::Loop.explicit_none") == "unbounded-blocking"


def test_sleep_join_and_acquire_boundedness(tmp_path):
    idx = _index(tmp_path, ("j.py", '''
        import time

        def naps():
            time.sleep(0.01)

        def joins_bounded(worker):
            worker.join(timeout=5)

        def joins_forever(worker):
            worker.join()

        def string_join_is_not_a_wait(parts):
            return ",".join(parts)

        class L:
            def try_lock(self):
                return self._lock.acquire(blocking=False)

            def takes_lock(self):
                self._lock.acquire()
    '''))
    assert _summary(idx, "::naps") == "bounded-blocking"
    assert _summary(idx, "::joins_bounded") == "bounded-blocking"
    assert _summary(idx, "::joins_forever") == "unbounded-blocking"
    assert _summary(idx, "::string_join_is_not_a_wait") == "nonblocking"
    assert _summary(idx, "::L.try_lock") == "bounded-blocking"
    assert _summary(idx, "::L.takes_lock") == "unbounded-blocking"


def test_summary_propagates_through_calls(tmp_path):
    idx = _index(tmp_path, ("p.py", '''
        def leaf(sock):
            sock.recv(4096)

        def middle(sock):
            leaf(sock)

        def top(sock):
            middle(sock)
    '''))
    for fn in ("::leaf", "::middle", "::top"):
        assert _summary(idx, fn) == "unbounded-blocking"


def test_recursion_cycle_terminates_and_stays_sound(tmp_path):
    # ping <-> pong call each other forever; pong also reaches a bare
    # recv.  The fixpoint must terminate (monotone on a finite
    # lattice) and BOTH cycle members must inherit the unbounded site.
    idx = _index(tmp_path, ("cycle.py", '''
        def blocker(sock):
            sock.recv(1)

        def ping(sock, n):
            if n:
                pong(sock, n - 1)

        def pong(sock, n):
            ping(sock, n)
            blocker(sock)
    '''))
    assert _summary(idx, "::ping") == "unbounded-blocking"
    assert _summary(idx, "::pong") == "unbounded-blocking"


def test_thread_spawn_does_not_raise_spawner_summary(tmp_path):
    # Thread(target=self._run) with a bound method: starting a thread
    # is nonblocking, but the TARGET's classification must resolve and
    # surface as a spawn edge
    idx = _index(tmp_path, ("t.py", '''
        import threading

        class Boss:
            def start(self):
                t = threading.Thread(target=self._run, daemon=True)
                t.start()

            def _run(self):
                self.sock.recv(1)
    '''))
    assert _summary(idx, "::Boss.start") == "nonblocking"
    assert _summary(idx, "::Boss._run") == "unbounded-blocking"
    start = [rf for k, rf in idx.fns.items() if k.endswith("::Boss.start")]
    spawns = start[0].spawns
    assert len(spawns) == 1
    assert spawns[0].target is not None
    assert spawns[0].target.endswith("::Boss._run")


def test_lambda_stored_in_dict_links_to_dynamic_call(tmp_path):
    # the callback-escape edge case: the blocking call
    # hides behind a lambda stored in a dict, invoked dynamically
    idx = _index(tmp_path, ("d.py", '''
        class Srv:
            def __init__(self):
                self._handlers = {}
                self._handlers["x"] = lambda: self.sock.recv(1)

            def _dispatch_loop(self):
                self._handlers["x"]()
    '''))
    assert _summary(idx, "::Srv._dispatch_loop") == "unbounded-blocking"


def test_dict_literal_of_callables_links_too(tmp_path):
    idx = _index(tmp_path, ("dl.py", '''
        class Srv:
            def __init__(self):
                self._handlers = {"x": self._on_x}

            def _on_x(self):
                self.sock.recv(1)

            def _dispatch_loop(self):
                self._handlers["x"]()
    '''))
    assert _summary(idx, "::Srv._dispatch_loop") == "unbounded-blocking"


# -- blocking-reachability ----------------------------------------------------

def test_unbounded_site_reachable_from_dispatch_loop_fires(tmp_path):
    findings = _ready_lint(tmp_path, ("srv.py", '''
        class Srv:
            def _dispatch_loop(self):
                self._pump()

            def _pump(self):
                self.sock.recv(4096)
    '''))
    assert [f.rule for f in findings] == ["blocking-reachability"]
    assert findings[0].line == 7
    # the evidence chain names both hops with file:line
    chain = findings[0].chains[0]
    assert any("_dispatch_loop" in step for step in chain)
    assert any(":7" in step and "recv" in step for step in chain)


def test_bounded_dispatch_loop_is_clean(tmp_path):
    findings = _ready_lint(tmp_path, ("ok.py", '''
        import time

        class Srv:
            def _dispatch_loop(self):
                self._work.wait(0.25)
                time.sleep(0.002)
                if self._lock.acquire(blocking=False):
                    pass
    '''))
    assert findings == []


def test_allow_blocking_reachable_marker_silences(tmp_path):
    findings = _ready_lint(tmp_path, ("allowed.py", '''
        class Srv:
            def _dispatch_loop(self):
                # fd is nonblocking here by construction (fixture).
                # datlint: allow-blocking-reachable(socket)
                self.sock.recv(4096)
    '''))
    assert findings == []


def test_blocking_outside_any_dispatcher_is_not_a_finding(tmp_path):
    # the rule certifies dispatch loops, not the whole program: a
    # session thread may block by contract
    findings = _ready_lint(tmp_path, ("free.py", '''
        def session_thread(sock):
            sock.recv(4096)
    '''))
    assert findings == []


# -- callback-escape ----------------------------------------------------------

def test_user_callback_on_dispatcher_thread_fires(tmp_path):
    findings = _ready_lint(tmp_path, ("cb.py", '''
        class Hub:
            def _dispatch_loop(self):
                self.on_done(3)
    '''))
    assert [f.rule for f in findings] == ["callback-escape"]
    assert "on_done" in findings[0].message


def test_allow_callback_escape_marker_silences(tmp_path):
    findings = _ready_lint(tmp_path, ("cba.py", '''
        class Hub:
            def _dispatch_loop(self):
                # audited: fixture sink contract.
                # datlint: allow-callback-escape
                self.on_done(3)
    '''))
    assert findings == []


def test_callback_on_session_thread_is_not_an_escape(tmp_path):
    findings = _ready_lint(tmp_path, ("sess.py", '''
        class Hub:
            def deliver(self):
                self.on_done(3)
    '''))
    assert findings == []


# -- the certificate ----------------------------------------------------------

def test_certificate_is_deterministic_and_byte_stable(tmp_path):
    files = (("srv.py", '''
        import threading

        class Srv:
            def __init__(self):
                self._work = threading.Event()

            def _dispatch_loop(self):
                self._work.wait(0.5)
                self._emit()

            def _emit(self):
                self.sock.sendall(b"x")
    '''),)
    _write(tmp_path, *files)
    run_paths([tmp_path])   # both analyzers agree on the fixture
    docs = []
    for _ in range(2):
        # a FRESH project per render: memoized indices must not be the
        # only reason the bytes agree
        idx = ReadinessIndex.get(Project.from_paths([tmp_path]))
        docs.append(json.dumps(render_event_loop_surface(idx),
                               indent=2, sort_keys=True))
    assert docs[0] == docs[1]
    doc = json.loads(docs[0])
    assert doc["levels"] == ["nonblocking", "bounded-blocking",
                             "unbounded-blocking"]
    # the fixture tree has none of the real entry points: every named
    # spec must be reported missing, never silently dropped
    missing = {m["entry"] for m in doc["missing_entry_points"]}
    assert "hub-dispatch" in missing and "sidecar-session" in missing
    # the fixture dispatcher still certifies (by name pattern)
    entries = {e["entry"]: e for e in doc["entry_points"]}
    assert "Srv._dispatch_loop" in entries
    e = entries["Srv._dispatch_loop"]
    assert e["enforced"] is True
    assert e["classification"] == "unbounded-blocking"
    assert e["certified"] is False
    assert e["unbounded"][0]["call"] == "self.sock.sendall(...)"
    assert e["unbounded"][0]["chain"]  # file:line evidence present


def test_checked_in_certificate_shape(tmp_path):
    # structural invariants every consumer (ROADMAP item 2 diffing,
    # the tier-1 byte-match test) relies on
    _write(tmp_path, ("loop.py", '''
        class S:
            def _dispatch_loop(self):
                self._q.wait(0.1)
    '''))
    run_paths([tmp_path])   # both analyzers agree on the fixture
    doc = render_event_loop_surface(
        ReadinessIndex.get(Project.from_paths([tmp_path])))
    assert set(doc) == {"version", "generator", "levels", "summary",
                        "entry_points", "missing_entry_points",
                        "unbounded_functions"}
    assert doc["version"] == 1
    counts = doc["summary"]
    assert counts["functions"] == (counts["nonblocking"]
                                   + counts["bounded-blocking"]
                                   + counts["unbounded-blocking"])


# -- CLI: --format json|sarif, --write-artifacts ------------------------------

BAD_TREE = ('''
    class Srv:
        def _dispatch_loop(self):
            self.sock.recv(4096)
''')


def test_format_json_round_trips_findings(tmp_path, capsys):
    _write(tmp_path, ("srv.py", BAD_TREE))
    rc = datlint_main(["--format", "json", "--rule",
                       "blocking-reachability", str(tmp_path)])
    doc = json.loads(capsys.readouterr().out)
    assert rc == 1
    expected = [f.to_json() for f in run_paths(
        [tmp_path], rules=(BlockingReachability(),))]
    assert doc["findings"] == expected
    f = doc["findings"][0]
    assert set(f) == {"rule", "path", "line", "message", "chains"}
    assert f["rule"] == "blocking-reachability"
    assert f["chains"][0]  # evidence chain survives the round trip


def test_json_flag_is_an_alias_for_format_json(tmp_path, capsys):
    _write(tmp_path, ("srv.py", BAD_TREE))
    datlint_main(["--format", "json", "--rule", "blocking-reachability",
                  str(tmp_path)])
    via_format = capsys.readouterr().out
    datlint_main(["--json", "--rule", "blocking-reachability",
                  str(tmp_path)])
    assert capsys.readouterr().out == via_format


def test_json_flag_contradicting_format_is_a_usage_error(tmp_path):
    _write(tmp_path, ("ok.py", "X = 1\n"))
    assert datlint_main(["--json", "--format", "sarif",
                         str(tmp_path)]) == 2


def test_format_sarif_structure(tmp_path, capsys):
    _write(tmp_path, ("srv.py", BAD_TREE))
    rc = datlint_main(["--format", "sarif", "--rule",
                       "blocking-reachability", str(tmp_path)])
    doc = json.loads(capsys.readouterr().out)
    assert rc == 1
    assert doc["version"] == "2.1.0"
    run = doc["runs"][0]
    assert run["tool"]["driver"]["name"] == "datlint"
    rule_ids = {r["id"] for r in run["tool"]["driver"]["rules"]}
    assert rule_ids == {"blocking-reachability"}
    (res,) = run["results"]
    findings = run_paths([tmp_path], rules=(BlockingReachability(),))
    loc = res["locations"][0]["physicalLocation"]
    assert res["ruleId"] == findings[0].rule
    assert loc["artifactLocation"]["uri"] == findings[0].path
    assert loc["region"]["startLine"] == findings[0].line
    assert res["properties"]["chains"] == [list(c)
                                           for c in findings[0].chains]


def test_sarif_clean_tree_exits_zero_with_no_results(tmp_path, capsys):
    _write(tmp_path, ("ok.py", "X = 1\n"))
    rc = datlint_main(["--format", "sarif", "--rule",
                       "blocking-reachability", str(tmp_path)])
    doc = json.loads(capsys.readouterr().out)
    assert rc == 0
    assert doc["runs"][0]["results"] == []


def test_write_artifacts_regenerates_both_byte_stably(tmp_path, capsys):
    src = tmp_path / "tree"
    src.mkdir()
    (src / "loop.py").write_text(textwrap.dedent('''
        import threading

        class S:
            def __init__(self):
                self._lock = threading.Lock()
                self._work = threading.Event()

            def _dispatch_loop(self):
                with self._lock:
                    pass
                self._work.wait(0.1)
    '''))
    outs = []
    for name in ("a", "b"):
        out = tmp_path / name
        rc = datlint_main(["--write-artifacts", str(out), str(src)])
        capsys.readouterr()
        assert rc == 0
        assert (out / "lock_graph.json").exists()
        assert (out / "event_loop_surface.json").exists()
        outs.append(out)
    for fname in ("lock_graph.json", "event_loop_surface.json"):
        a = (outs[0] / fname).read_bytes()
        b = (outs[1] / fname).read_bytes()
        assert a == b, f"{fname} is not byte-stable across regeneration"
        assert a.endswith(b"\n")
