"""Window driver of the ``change-log`` configuration: a receiving peer
replays a dataset's change log.

Each pass is one session in a closed loop, run by ``blob_feed``'s
``window``: a fresh ``decode(backend="cuda")`` (the port's
``CudaDecoder``: its C change loop and the digest pipeline) with a
change handler that keeps each decoded ``Change`` and acks at once, an
``on_digest`` subscriber and a finalize hook, fed the log's wire
(``gen/changelog.py``) in writes of the configuration's ``write_bytes``
from the first byte to ``end()``.  The same wire is replayed pass after
pass.

The end-to-end metrics, the latencies and the counts are
``blob_feed``'s; the counts add the window's rows.  ``check`` compares
every session with the plain reference's decode of the wire
(``reference/change_log.py``): digests per kind in seq order, and every
decoded change's subset, key, counters and value.
"""

from __future__ import annotations

import dataclasses
import operator
import resource
import sys
import time
import types

import numpy as np

from portbench.drivers import blob_feed
from portbench.drivers.blob_feed import (attempted, release,  # noqa: F401
                                        window)
from portbench.gen import changelog
from portbench.reference import change_log as reference_change_log
from portbench.work import blake2b as b1_work

# a decoded Change as the reference gives its record
record_of = operator.attrgetter("subset", "key", "change", "from_", "to",
                                "value")


@dataclasses.dataclass
class State(blob_feed.State):
    memo: dict = dataclasses.field(default_factory=dict)  # the controls'


def setup(cell, seed: int, device, system=None) -> State:
    """Make the wire from ``seed`` and warm one session."""
    t0 = time.perf_counter()
    spec = {**cell.config, **cell.params}
    w = changelog.make_log(spec, seed)
    t1 = time.perf_counter()
    step = int(spec["write_bytes"])
    mv = memoryview(w.buf)
    state = State(cell=cell, device=device, wire=w,
                  pieces=[mv[at:at + step] for at in range(0, w.nbytes, step)],
                  last_write={"change": (w.ends - 1) // step,
                              "blob": np.empty(0, np.int64)},
                  system=system or blob_feed.port_system,
                  expected=len(w.kinds), work=b1_work.work(w.ends - w.starts))
    warm = blob_feed.run_session(state).seconds  # every shape the window uses
    state.notes = [f"set-up: wire of {len(w.kinds)} rows, {w.nbytes} bytes, "
                   f"{t1 - t0} s; warm-up session {warm} s"]
    return state


def end_to_end(state: State, win: dict) -> tuple[dict, list]:
    """``blob_feed``'s, and the rate of rows and the host memory the
    window's kept changes and digests take."""
    out, notes = blob_feed.end_to_end(state, win)
    done = sum(1 for s in win["sessions"] if s.finished)
    kept = _kept_bytes(win["sessions"][0])
    notes.append(f"rows/s {state.expected * done / win['seconds']}; the "
                 f"harness keeps every session's changes and digests, about "
                 f"{kept} bytes a session ({kept * len(win['sessions'])} in "
                 f"the window); process peak RSS "
                 f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss} KiB")
    return out, notes


def _kept_bytes(s, sample: int = 1000) -> int:
    """About the bytes of one session's kept changes and digest records
    (each object, its fields and a list slot), from the first
    ``sample`` of each."""
    size = sys.getsizeof

    def each(objs, fields) -> float:
        objs = objs[:sample]
        return sum(size(o) + 8 + sum(map(size, fields(o)))
                   for o in objs) / max(1, len(objs))

    return int(each(s.changes, record_of) * len(s.changes)
               + each(s.delivered, tuple) * len(s.delivered))


def counters(state: State, win: dict, ref) -> dict:
    """``blob_feed``'s counts, and the rows of the finished sessions."""
    out = blob_feed.counters(state, win, ref)
    out["rows"] = state.expected * sum(1 for s in win["sessions"]
                                       if s.finished)
    return out


def reference(state: State) -> dict:
    """The wire's records and digests, as the plain reference decodes
    them."""
    return reference_change_log.expected(state.wire.buf)


def check(state: State, win: dict, ref) -> dict:
    """Each number that decides ``correct``, over every session of the
    window: ``blob_feed``'s four, and decoded changes not as the
    reference decodes them at their place (subset included), missing or
    extra."""
    # blob_feed's check with no changes to compare: its own changes'
    # check leaves the subset out
    digests_only = types.SimpleNamespace(
        expected=state.expected, wire=types.SimpleNamespace(n_changes=0))
    out = blob_feed.check(digests_only, win, ref["digests"])
    out["wrong_changes"] = sum(wrong_changes(s.changes, ref["records"])
                               for s in win["sessions"] if s.finished)
    return out


def wrong_changes(got: list, want: list) -> int:
    """Expected records not decoded as the reference decodes them at
    their place (subset, key, change, from, to, value), plus decoded
    changes past the expected count."""
    rows = list(map(record_of, got))
    if rows == want:
        return 0
    right = sum(1 for g, w in zip(rows, want) if g == w)
    return len(want) - right + max(0, len(rows) - len(want))
