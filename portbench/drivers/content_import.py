"""Window driver of the ``content-import`` configuration: a peer imports
files into a dat by content-defined chunking, chunk digests and a Merkle
root.

Each pass is one call of the port's ``content_address(data)`` with its
defaults (no route, no sizes: what users get), in a closed loop over the
cell's files in the seed's order, one call at a time.  The window runs
whole calls until ``seconds`` have passed and ends with the call under
way then, so its seconds cover all its work.  Every call's cuts, digests
and root are kept for the check after the window.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import os
import time
import types

import numpy as np

from portbench.gen import files as files_gen
from portbench.reference import cdc
from portbench.trace import CALL_SPAN
from portbench.work import blake2b as b1_work
from portbench.work import gear as gear_work


def port_system(state):
    """The system under test: the port's ``content_address``."""
    from dat_replication_protocol_tpu_torch import content_address

    if state.device.type == "cuda":
        return content_address
    return lambda data: content_address(data, device=state.device)


@dataclasses.dataclass
class State:
    cell: object
    device: object
    files: list
    address: object
    notes: list = dataclasses.field(default_factory=list)


def setup(cell, seed: int, device, system=None) -> State:
    """Make the files from ``seed`` and warm one call on each size, on
    the last file of that size, so that the window's first call follows
    a call on another file."""
    t0 = time.perf_counter()
    state = State(cell=cell, device=device,
                  files=files_gen.make_files(cell.params, seed),
                  address=None)
    t1 = time.perf_counter()
    state.address = (system or port_system)(state)
    last = {len(f): f for f in state.files}
    for f in last.values():
        state.address(f)
    state.notes = [f"set-up: files {t1 - t0} s, warm-up calls "
                   f"{time.perf_counter() - t1} s"]
    return state


def _kept(summary) -> types.SimpleNamespace:
    return types.SimpleNamespace(
        length=int(summary.length), cuts=list(summary.cuts),
        digests=np.asarray(summary.digests, dtype=np.uint8),
        root=bytes(summary.root))


def window(state: State, seconds: float, span=None) -> dict:
    """Whole calls for ``seconds``; what the harness keeps of each call is
    frozen out of the garbage collector's generations as it returns."""
    calls, times = [], []
    clock = time.perf_counter
    n = len(state.files)
    gc.freeze()
    t0 = clock()
    while not calls or clock() - t0 < seconds:
        i = len(calls) % n
        t1, c1 = clock(), os.times()
        try:
            with span(CALL_SPAN) if span else contextlib.nullcontext():
                out = state.address(state.files[i])
            calls.append((i, _kept(out), None))
        except Exception as e:  # a call that fails counts as failed
            calls.append((i, None, f"{type(e).__name__}: {e}"))
        c2 = os.times()
        times.append((clock() - t1,
                      (c2.user + c2.system) - (c1.user + c1.system)))
        gc.freeze()
    return {"calls": calls, "seconds": clock() - t0, "times": times}


def release(state: State) -> None:
    """Free the caching allocator's blocks before the reference runs."""
    import torch

    if state.device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def end_to_end(state: State, win: dict) -> tuple[dict, list]:
    done = [i for i, out, err in win["calls"] if err is None]
    nbytes = sum(len(state.files[i]) for i in done)
    return ({"import_gibps": nbytes / win["seconds"] / (1 << 30)},
            [f"calls {len(win['calls'])} ({len(done)} returned), file "
             f"bytes {nbytes}, window {win['seconds']} s, file sizes "
             f"{[len(f) for f in state.files]}, call seconds and their "
             f"process CPU seconds {win.get('times')}"])


def reference(state: State) -> list:
    """Each file's ``(cuts, digests, root)`` by the configuration's
    chunking, once a file."""
    chunking = state.cell.config["chunking"]
    return [cdc.summary(f, chunking, state.device) for f in state.files]


def counters(state: State, win: dict, ref) -> dict:
    """File bytes of the window's calls, and the work of the gear scan
    and of B1 on their chunks (the chunks by the reference's cuts)."""
    per_file = []
    for cuts, _, _ in ref:
        ends = np.asarray(cuts, dtype=np.int64)
        per_file.append(b1_work.work(np.diff(np.concatenate([[0], ends]))))
    done = [i for i, _, err in win["calls"] if err is None]
    b1 = {k: sum(per_file[i][k] for i in done) for k in per_file[0]}
    nbytes = sum(len(state.files[i]) for i in done)
    return {"file_bytes": nbytes, "calls": len(done), "b1": b1,
            "gear": gear_work.work(nbytes)}


def check(state: State, win: dict, ref) -> dict:
    """Each number that decides ``correct``, over every call of the
    window: calls that raised; cut positions not in both the call's and
    the reference's cuts; reference chunks whose extent or digest the
    call does not give at the same index; roots that differ."""
    failed = wrong_cuts = wrong_digests = wrong_roots = 0
    for i, out, err in win["calls"]:
        if err is not None:
            failed += 1
            continue
        cuts, digests, root = ref[i]
        wrong_roots += int(out.root != root)
        if out.length != len(state.files[i]):
            wrong_cuts += 1
        if out.cuts == cuts and out.digests.shape == digests.shape:
            # the common case, without a per-cut array walk
            wrong_digests += int((out.digests != digests).any(axis=1).sum())
            continue
        got = np.asarray(out.cuts, dtype=np.int64)
        want = np.asarray(cuts, dtype=np.int64)
        wrong_cuts += len(np.setxor1d(got, want))
        n = min(len(got), len(want))
        same = got[:n] == want[:n]
        same[1:] &= got[:n - 1] == want[:n - 1]
        if out.digests.shape[1:] == (32,) and len(out.digests) >= n:
            same &= (out.digests[:n] == digests[:n]).all(axis=1)
        else:
            same[:] = False
        wrong_digests += len(want) - int(same.sum())
    return {"failed_calls": failed, "wrong_cuts": wrong_cuts,
            "wrong_digests": wrong_digests, "wrong_roots": wrong_roots}


def attempted(win: dict) -> tuple[int, int]:
    calls = win["calls"]
    return len(calls), sum(1 for _, _, err in calls if err is not None)
