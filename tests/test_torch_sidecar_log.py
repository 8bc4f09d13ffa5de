"""The port's sidecar writes every session record as one whole line.

``print`` writes a record's text and its newline apart, so two sessions
that end together can write ``A``, ``B``, ``\\n``, ``\\n``: one line with
two records, then an empty one.  The port's sidecar writes each record
through ``sidecar.log_line``, one write under a module lock.  Here 16
threads write 200 records each through it into one pipe: every line read
back is exactly one record, 3,200 in all.  The sources are held to it
too: no function that runs on a session, listener or gossip thread calls
``print``.
"""

import ast
import json
import io
import os
import threading
from pathlib import Path

from dat_replication_protocol_tpu_torch import sidecar

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "dat_replication_protocol_tpu_torch"

THREADS = 16
RECORDS = 200


def test_log_line_keeps_every_record_on_its_own_line():
    r, w = os.pipe()
    # a stream built as the interpreter builds a piped stderr: unbuffered,
    # every write one system call that releases the GIL, so writes of
    # different threads interleave unless something serializes them
    out = io.TextIOWrapper(io.FileIO(w, "w"), write_through=True)
    got = bytearray()

    def read() -> None:
        while chunk := os.read(r, 1 << 16):
            got.extend(chunk)

    reader = threading.Thread(target=read)
    reader.start()
    start = threading.Barrier(THREADS)

    def writer(t: int) -> None:
        start.wait()
        for i in range(RECORDS):
            # a session record's shape and length: a peer and a dict
            rec = {"thread": t, "seq": i, "ok": True, "pad": "x" * (i % 97)}
            sidecar.log_line(json.dumps(rec), out)

    threads = [threading.Thread(target=writer, args=(t,))
               for t in range(THREADS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
        assert not t.is_alive()
    out.close()
    reader.join(60)
    assert not reader.is_alive()
    os.close(r)
    text = got.decode()
    assert text.endswith("\n")
    lines = text[:-1].split("\n")
    seen = set()
    for line in lines:
        rec = json.loads(line)  # one line, one whole record
        assert isinstance(rec, dict) and set(rec) == {"thread", "seq", "ok",
                                                      "pad"}
        seen.add((rec["thread"], rec["seq"]))
    assert len(lines) == THREADS * RECORDS == 3200
    assert seen == {(t, i) for t in range(THREADS) for i in range(RECORDS)}


def _functions(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            for item in node.body:
                if isinstance(item, ast.FunctionDef):
                    yield f"{node.name}.{item.name}", item
        elif isinstance(node, ast.FunctionDef):
            yield node.name, node


def _prints(fn) -> list:
    return [n.lineno for n in ast.walk(fn)
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
            and n.func.id == "print"]


def test_thread_side_code_logs_through_log_line():
    # the sidecar's accept loops and session legs, the snapshot
    # listener, the edge loop (its table's records), the gossip leg
    thread_side = {
        PORT / "sidecar.py": ("serve_tcp", "serve_stdio", "SnapshotListener.",
                              "run_replica_session", "run_session",
                              "run_subscriber", "_end_on_mesh_failure"),
        PORT / "edge" / "loop.py": ("EdgeLoop.",),
        PORT / "cluster" / "live.py": ("",),
        PORT / "cluster" / "node.py": ("",),
    }
    found = []
    for path, prefixes in thread_side.items():
        names = []
        for name, fn in _functions(path):
            if name.startswith(prefixes):
                names.append(name)
                found += [f"{path.name}:{line} in {name}"
                          for line in _prints(fn)]
        assert names, path
    assert found == []
    src = (PORT / "sidecar.py").read_text()
    assert src.count("log_line(") >= 5
