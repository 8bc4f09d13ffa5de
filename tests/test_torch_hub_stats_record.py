"""The stats record's hub count and its session breakdown agree.

``sidecar.snapshot_stats()`` writes the hub's aggregate (``hub``, with
its ``sessions`` count) and its per-session breakdown (``sessions``).
The JAX package reads them with two calls, each under its own hold of
the hub lock (reference ``sidecar.py:1065-1066``), so a session that
registers or closes between them tears the record: a count of 10 beside
a breakdown of 9, which the port's phase 15b check on the card caught.
The port reads both under one hold (``ReplicationHub.stats_sections``).
A churn thread registers and closes sessions while the records are
taken, with a short switch interval to widen any window.
"""

from __future__ import annotations

import sys
import threading
import time

from dat_replication_protocol_tpu_torch import sidecar
from dat_replication_protocol_tpu_torch.hub import ReplicationHub


def test_stats_record_count_equals_its_breakdown_under_churn():
    hub = ReplicationHub(device="cpu", max_sessions=64)
    stop = threading.Event()
    churned = [0]

    def churn():
        n = 0
        live = []
        while not stop.is_set():
            live.append(hub.register(f"c{n}"))
            n += 1
            if len(live) > 8:
                live.pop(0).close()
            churned[0] = n
        for s in live:
            s.close()

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    sidecar.set_active_hub(hub)
    t = threading.Thread(target=churn, daemon=True)
    try:
        t.start()
        records = 0
        deadline = time.monotonic() + 1.0
        while time.monotonic() < deadline:
            rec = sidecar.snapshot_stats()
            assert rec["hub"]["sessions"] == len(rec["sessions"]), rec
            records += 1
    finally:
        stop.set()
        t.join(10)
        sys.setswitchinterval(switch)
        sidecar.set_active_hub(None)
        hub.close()
    assert not t.is_alive()
    assert records > 10 and churned[0] > 10
    a, b = hub.stats_sections()
    assert a["sessions"] == len(b) == 0
