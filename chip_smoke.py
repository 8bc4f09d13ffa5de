#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card, ``nvcc``
under ``/usr/local/cuda`` and PyTorch built for CUDA.  It imports nothing
of JAX or of the JAX package.  Phases (any failure raises; exit code 1):

1. build: compile every kernel of ``dat_replication_protocol_tpu_torch``
   from ``csrc/`` with ``nvcc`` (one process per source, all started
   together) and print the card's name and power limit;
2. kernels against their plain PyTorch versions on the card, byte-exact:
   B1 (batched BLAKE2b) at edge lengths across four buckets, also against
   ``hashlib``; B2 (Merkle level) on 2^16 random leaves;
3. the digest session at BASELINE.json configs[2]'s item width (1 MiB
   blobs): the port's Encoder writes 2,048 blobs of 1 MiB and 65,536
   changes with 40-200-byte values (the blob count is cut from 10k to fit
   the run's time limit), ``decode(backend="cuda")`` consumes it through
   ``pipe`` and every digest is held against ``hashlib``; a 256-blob
   repeat under ``torch.profiler`` gives the device time by kernel and
   the busy share; then a short session through ``sidecar.run_session``
   over an in-memory byte pair;
4. ``entry()`` at BASELINE.json configs[4]'s width: 2^20 payloads hashed
   and folded to a Merkle root, held against ``root_host``;
5. times: each kernel at the main path's shapes beside its plain version
   and its bound.

Every launch counter is set to 0 just before each main-path phase (3, 4)
and read just after; a kernel that the phases did not launch fails the
run.  The lines before the last carry the card, the per-kernel JSON and
the times; the last line is ``{"ok": true, "device": {...}}``.  Without a
card it exits 2 and prints no result.
"""

from __future__ import annotations

import hashlib
import io
import json
import subprocess
import sys
import time

import numpy as np

SEED = 20261016
MIB = 1 << 20

# H100 SXM rates for the bounds (NVIDIA's data sheet and Hopper white
# paper): HBM3 at 3.35 TB/s; 32-bit integer ALU at 132 SMs x 64 INT32
# lanes x 1.98 GHz boost clock
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9

# 32-bit integer operations of one BLAKE2b compression that only the
# INT32 lanes execute, on 64-bit words split into 32-bit halves: a G mix
# has 4 64-bit xors (2 ops each) and 3 rotates by 24/16/63 (2 funnel
# shifts each; the rotate by 32 is a register swap) = 14 ops; 12 rounds
# of 8 mixes, plus 4 to set up v12 and v14 and 16 three-input xors of the
# feed-forward.  The 64-bit adds (8 ops a mix) are left out: the compiler
# can issue them as IMAD on the FP32 pipe beside the INT32 lanes, so
# counting them would put the bound above what the card can reach.
OPS_PER_COMPRESSION = 12 * 8 * 14 + 4 + 16

# phase 3 shape: 32 changes, then one blob, 2,048 times
N_BLOBS = 2048
BLOB_BYTES = MIB
CHANGES_PER_BLOB = 32
ENTRY_LEAVES = 1 << 20


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def reset_counters() -> None:
    from dat_replication_protocol_tpu_torch.ops.blake2b_cuda import (
        blake2b_packed_kernel)
    from dat_replication_protocol_tpu_torch.ops.merkle_cuda import (
        merkle_level_kernel)

    blake2b_packed_kernel.launches = 0
    merkle_level_kernel.launches = 0


def read_counters() -> dict:
    from dat_replication_protocol_tpu_torch.ops.blake2b_cuda import (
        blake2b_packed_kernel)
    from dat_replication_protocol_tpu_torch.ops.merkle_cuda import (
        merkle_level_kernel)

    return {"blake2b": blake2b_packed_kernel.launches,
            "merkle_level": merkle_level_kernel.launches}


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def blake(data) -> bytes:
    return hashlib.blake2b(data, digest_size=32).digest()


def max_abs_err(got, want) -> int:
    """Largest absolute difference between two (hi, lo) int32 pairs, with
    each pair read as one unsigned 64-bit word per element."""
    import torch

    diff = 0
    for a, b in zip(got, want):
        d = (a.to(torch.int64) - b.to(torch.int64)).abs().max()
        diff = max(diff, int(d))
    return diff


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def check_kernels(device, b1_lengths=(0, 1, 127, 128, 129, 255, 256, 1000,
                                      131072), b2_leaves=1 << 16) -> None:
    import torch

    from dat_replication_protocol_tpu_torch.ops import blake2b as b2b
    from dat_replication_protocol_tpu_torch.ops import merkle
    from dat_replication_protocol_tpu_torch.ops.blake2b_cuda import (
        blake2b_packed_kernel)
    from dat_replication_protocol_tpu_torch.ops.merkle_cuda import (
        merkle_level_kernel)

    rng = np.random.default_rng(SEED)
    payloads = [rng.bytes(n) for n in b1_lengths]
    want = [blake(p) for p in payloads]
    if b2b.blake2b_batch(payloads, device=device) != want:
        raise AssertionError("B1 batch digests differ from hashlib")
    buckets: dict[int, list[bytes]] = {}
    for p in payloads:
        nb = b2b._bucket_nblocks(b2b._need_blocks(len(p)))
        buckets.setdefault(nb, []).append(p)
    if len(buckets) < 3:
        raise AssertionError(f"B1 edge lengths span {len(buckets)} buckets")
    for nb, items in sorted(buckets.items()):
        mh, ml, lengths = (t.to(device) for t in b2b.pack_payloads(items, nb))
        got = blake2b_packed_kernel(mh, ml, lengths)
        plain = b2b.blake2b_packed(mh, ml, lengths)
        sync(device)
        if not all(torch.equal(a, b) for a, b in zip(got, plain)):
            raise AssertionError(f"B1 differs from its plain version at "
                                 f"nblocks={nb}")
        if b2b.digests_to_bytes(got[0].cpu(), got[1].cpu()) != [
                blake(p) for p in items]:
            raise AssertionError(f"B1 differs from hashlib at nblocks={nb}")
    log(f"phase 2: B1 byte-exact vs plain and hashlib at lengths "
        f"{list(b1_lengths)}, buckets {sorted(buckets)}")

    words = rng.integers(0, 1 << 32, (2, b2_leaves, 4), dtype=np.uint64)
    hh, hl = (torch.from_numpy(w.astype(np.uint32).view(np.int32)).to(device)
              for w in words)
    got = merkle_level_kernel(hh, hl)
    plain = merkle.merkle_level(hh, hl)
    sync(device)
    if not all(torch.equal(a, b) for a, b in zip(got, plain)):
        raise AssertionError("B2 differs from its plain version")
    leaves = merkle.digests_from_device(hh[:64], hl[:64])
    parents = merkle.digests_from_device(got[0][:32], got[1][:32])
    if parents != merkle.host_tree(leaves)[1]:
        raise AssertionError("B2 differs from hashlib parents")
    log(f"phase 2: B2 byte-exact vs plain on {b2_leaves} leaves")


# ---------------------------------------------------------------------------
# phase 3: the digest session and the sidecar
# ---------------------------------------------------------------------------


def make_session(n_blobs, blob_bytes, changes_per_blob, seed=SEED):
    """Blob bytes (one buffer) and change records, from one seed."""
    rng = np.random.default_rng(seed)
    blob_buf = rng.bytes(n_blobs * blob_bytes)
    n_changes = n_blobs * changes_per_blob
    value_lens = rng.integers(40, 201, n_changes)
    value_buf = rng.bytes(int(value_lens.sum()))
    offs = np.concatenate([[0], np.cumsum(value_lens)])
    changes = [{"key": f"row-{i}", "change": i + 1, "from": 0, "to": 1,
                "value": value_buf[offs[i]:offs[i + 1]]}
               for i in range(n_changes)]
    return memoryview(blob_buf), changes


def run_session(device, n_blobs=N_BLOBS, blob_bytes=BLOB_BYTES,
                changes_per_blob=CHANGES_PER_BLOB) -> dict:
    import dat_replication_protocol_tpu_torch as protocol
    from dat_replication_protocol_tpu_torch.backend.cuda_backend import (
        DEFAULT_STREAM_THRESHOLD)

    if blob_bytes >= DEFAULT_STREAM_THRESHOLD:
        raise ValueError("phase 3 blobs must take the batch path")
    blobs, changes = make_session(n_blobs, blob_bytes, changes_per_blob)
    enc = protocol.encode()
    dec = protocol.decode(backend="cuda", device=device)
    got = {"change": [], "blob": []}
    at_finalize = []
    dec.on_digest(lambda kind, seq, d: got[kind].append((seq, d)))
    dec.change(lambda c, done: done())
    dec.finalize(lambda done: (at_finalize.append(
        len(got["change"]) + len(got["blob"])), done()))

    reset_counters()
    t0 = time.perf_counter()
    protocol.pipe(enc, dec)
    for b in range(n_blobs):
        for c in changes[b * changes_per_blob:(b + 1) * changes_per_blob]:
            enc.change(c)
        enc.blob(blob_bytes).end(blobs[b * blob_bytes:(b + 1) * blob_bytes])
    enc.finalize()
    sync(device)
    seconds = time.perf_counter() - t0
    launches = read_counters()

    if not dec.finished or dec.destroyed:
        raise AssertionError("phase 3 session did not finish")
    pipeline = dec.digest_pipeline
    total = len(changes) + n_blobs
    if at_finalize != [total]:
        raise AssertionError(f"digests before finalize: {at_finalize}, "
                             f"want {total}")
    if pipeline.streamed or pipeline.batched != total:
        raise AssertionError(f"batch path took {pipeline.batched} of "
                             f"{total}, host streams {pipeline.streamed}")
    if [s for s, _ in got["change"]] != list(range(len(changes))):
        raise AssertionError("change digests out of order")
    if [s for s, _ in got["blob"]] != list(range(n_blobs)):
        raise AssertionError("blob digests out of order")
    for (_, d), c in zip(got["change"], changes):
        if d != blake(protocol.encode_change(c)):
            raise AssertionError("a change digest differs from hashlib")
    for b, (_, d) in enumerate(got["blob"]):
        if d != blake(blobs[b * blob_bytes:(b + 1) * blob_bytes]):
            raise AssertionError(f"blob {b} digest differs from hashlib")
    if launches["blake2b"] == 0:
        raise AssertionError("phase 3 never launched B1")
    return {"seconds": seconds, "wire_bytes": dec.bytes,
            "gib_per_s": dec.bytes / seconds / (1 << 30),
            "changes": len(changes), "blobs": n_blobs,
            "dispatches": pipeline.dispatches, "launches": launches}


def profile_session(device, n_blobs=256) -> dict:
    """Device time by kernel and copy over a shorter session, from
    ``torch.profiler``; the busy share is their sum over the session's
    host-clock seconds (one stream, so nothing overlaps)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        session = run_session(device, n_blobs=n_blobs)
    # only events that ran on the card: host ops (aten::copy_) and
    # runtime calls (cudaLaunchKernel) also carry their kernels' time
    rows = sorted(((e.self_device_time_total / 1e3, e.key, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), reverse=True)
    if not rows:
        raise AssertionError("the profiled session shows no device time")
    busy_s = sum(ms for ms, _, _ in rows) / 1e3
    return {"seconds": session["seconds"], "busy_share":
            busy_s / session["seconds"], "rows": rows}


def run_sidecar(device, n_changes=16, n_blobs=4, blob_bytes=64 << 10) -> dict:
    import dat_replication_protocol_tpu_torch as protocol
    from dat_replication_protocol_tpu_torch import sidecar

    blobs, changes = make_session(n_blobs, blob_bytes,
                                  n_changes // n_blobs, seed=SEED + 1)
    enc = protocol.encode()
    want = []
    for b in range(n_blobs):
        per = n_changes // n_blobs
        for i, c in enumerate(changes[b * per:(b + 1) * per]):
            enc.change(c)
            want.append(("change", b * per + i, blake(
                protocol.encode_change(c))))
        blob = blobs[b * blob_bytes:(b + 1) * blob_bytes]
        enc.blob(blob_bytes).end(blob)
        want.append(("blob", b, blake(blob)))
    enc.finalize()
    wire = bytearray()
    while (chunk := enc.read()) is not None:
        wire += chunk
    reply = bytearray()

    reset_counters()
    out = sidecar.run_session(io.BytesIO(bytes(wire)).read, reply.extend,
                              device=device)
    launches = read_counters()
    if not out["ok"]:
        raise AssertionError(f"sidecar session failed: {out}")
    dec = protocol.decode()
    replies = []
    dec.change(lambda c, done: (replies.append(c), done()))
    dec.write(bytes(reply))
    dec.end()
    if not dec.finished:
        raise AssertionError("sidecar reply is not a complete session")
    got = sorted(((c.subset.split(":")[1], c.change, c.value)
                  for c in replies), key=lambda r: (r[0], r[1]))
    if got != sorted(want, key=lambda r: (r[0], r[1])):
        raise AssertionError("sidecar digest replies differ from hashlib")
    for c in replies:
        kind = c.subset.split(":")[1]
        if c.key != f"{kind}-{c.change}":
            raise AssertionError(f"sidecar reply key {c.key!r}")
    if launches["blake2b"] == 0:
        raise AssertionError("the sidecar session never launched B1")
    return {"digests": out["digests"], "launches": launches}


# ---------------------------------------------------------------------------
# phase 4: entry() at 2^20 leaves
# ---------------------------------------------------------------------------


def run_entry(device, n_leaves=ENTRY_LEAVES) -> dict:
    from dat_replication_protocol_tpu_torch import entry
    from dat_replication_protocol_tpu_torch.ops import merkle

    rng = np.random.default_rng(SEED + 2)
    lens = rng.integers(40, 201, n_leaves)
    buf = rng.bytes(int(lens.sum()))
    offs = np.concatenate([[0], np.cumsum(lens)])
    payloads = [buf[offs[i]:offs[i + 1]] for i in range(n_leaves)]
    fn, args = entry.entry(device=device, payloads=payloads)

    reset_counters()
    t0 = time.perf_counter()
    root_hh, root_hl = fn(*args)
    sync(device)
    seconds = time.perf_counter() - t0
    launches = read_counters()

    root = merkle.digests_from_device(root_hh, root_hl)[0]
    if root != merkle.root_host([blake(p) for p in payloads]):
        raise AssertionError("entry() root differs from root_host")
    if launches["merkle_level"] == 0 or launches["blake2b"] == 0:
        raise AssertionError(f"entry() launches {launches}")
    return {"seconds": seconds, "leaves": n_leaves, "launches": launches,
            "root": root.hex(), "step": (fn, args)}


# ---------------------------------------------------------------------------
# phase 5: times and bounds
# ---------------------------------------------------------------------------


def time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` runs, after a warm-up,
    from CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def b1_bound(lengths) -> tuple[float, str]:
    blocks = np.maximum(1, -(-np.asarray(lengths, dtype=np.int64) // 128))
    nbytes = int(blocks.sum()) * 128 + 4 * len(lengths) + 64 * len(lengths)
    ops = int(blocks.sum()) * OPS_PER_COMPRESSION
    return bound(nbytes, ops)


def b2_bound(parents: int) -> tuple[float, str]:
    return bound(64 * parents + 32 * parents, parents * OPS_PER_COMPRESSION)


def bound(nbytes: int, ops: int) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def b1_inputs(device, payloads):
    """A bucket staged as ``blake2b_batch_begin`` stages it: power-of-two
    batch and block count, split into hi/lo halves on the card."""
    from dat_replication_protocol_tpu_torch.ops import blake2b as b2b

    nb = b2b._bucket_nblocks(b2b._need_blocks(max(map(len, payloads))))
    batch = list(payloads) + [b""] * (b2b._bucket_nblocks(len(payloads))
                                      - len(payloads))
    raw, lengths = b2b._stage_bytes(batch, nb, pin=False)
    raw, lengths = raw.to(device), lengths.to(device)
    mh, ml = b2b._split_halves(raw, nb)
    return (mh, ml, lengths), [len(p) for p in batch]


def time_kernels(device, launches: dict, entry_step) -> list[dict]:
    from dat_replication_protocol_tpu_torch.ops import blake2b as b2b
    from dat_replication_protocol_tpu_torch.ops import merkle
    from dat_replication_protocol_tpu_torch.ops.blake2b_cuda import (
        blake2b_packed_kernel)
    from dat_replication_protocol_tpu_torch.ops.merkle_cuda import (
        merkle_level_kernel)

    rows = []
    # B1 at the session's blob bucket: each batch of 1,024 items holds 31
    # blobs (32 changes per blob), padded to a batch of 32 x 8,192 blocks
    blobs, changes = make_session(31, BLOB_BYTES, 0, seed=SEED + 3)
    args, lens = b1_inputs(device, [blobs[i * BLOB_BYTES:(i + 1) * BLOB_BYTES]
                                    for i in range(31)])
    ms = time_ms(lambda: blake2b_packed_kernel(*args), reps=5)
    t0 = time.perf_counter()
    plain = b2b.blake2b_packed(*args)
    sync(device)
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = max_abs_err(blake2b_packed_kernel(*args), plain)
    bound_ms, bound_by = b1_bound(lens)
    rows.append({
        "name": "blake2b_packed", "route": "cuda",
        "source": "dat_replication_protocol_tpu_torch/csrc/blake2b.cu",
        "replaces": "dat_replication_protocol_tpu/ops/blake2b_pallas.py:228",
        "launches": launches["blake2b"], "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None, "shape": list(args[0].shape)})

    # B1 at the session's change bucket: 1,024 payloads of 2 blocks
    _, recs = make_session(1, 0, 1024, seed=SEED + 4)
    from dat_replication_protocol_tpu_torch import encode_change

    args_c, lens_c = b1_inputs(device, [encode_change(c) for c in recs])
    ms_c = time_ms(lambda: blake2b_packed_kernel(*args_c), reps=50)
    plain_c = time_ms(lambda: b2b.blake2b_packed(*args_c), reps=3)
    err_c = max_abs_err(blake2b_packed_kernel(*args_c),
                        b2b.blake2b_packed(*args_c))
    bc, bc_by = b1_bound(lens_c)
    log(f"phase 5: B1 at change bucket {list(args_c[0].shape)}: {ms_c} ms, "
        f"plain {plain_c} ms, bound {bc} ms ({bc_by}), max_abs_err {err_c}")
    if err or err_c:
        raise AssertionError("B1 differs from its plain version in phase 5")

    # B2 at the first level of entry()'s 2^20-leaf tree
    rng = np.random.default_rng(SEED + 5)
    words = rng.integers(0, 1 << 32, (2, ENTRY_LEAVES, 4), dtype=np.uint64)
    import torch

    hh, hl = (torch.from_numpy(w.astype(np.uint32).view(np.int32)).to(device)
              for w in words)
    ms2 = time_ms(lambda: merkle_level_kernel(hh, hl), reps=20)
    plain2 = time_ms(lambda: merkle.merkle_level(hh, hl), reps=3)
    err2 = max_abs_err(merkle_level_kernel(hh, hl), merkle.merkle_level(hh, hl))
    if err2:
        raise AssertionError("B2 differs from its plain version in phase 5")
    b2, b2_by = b2_bound(ENTRY_LEAVES // 2)
    rows.append({
        "name": "merkle_level", "route": "cuda",
        "source": "dat_replication_protocol_tpu_torch/csrc/merkle_level.cu",
        "replaces": "dat_replication_protocol_tpu/ops/merkle_pallas.py:69",
        "launches": launches["merkle_level"], "max_abs_err": err2,
        "ms": ms2, "plain_ms": plain2, "bound_ms": b2, "bound_by": b2_by,
        "library_ms": None, "shape": [ENTRY_LEAVES, 4]})

    # the whole tree, all 20 levels, and entry()'s whole step warm
    tree_ms = time_ms(lambda: merkle.build_tree(hh, hl), reps=5)
    log(f"phase 5: build_tree over {ENTRY_LEAVES} leaves: {tree_ms} ms")
    fn, args = entry_step
    step_ms = time_ms(lambda: fn(*args), reps=5)
    leaf_ms = time_ms(lambda: blake2b_packed_kernel(*args), reps=5)
    lb, lb_by = b1_bound(args[2].cpu().numpy())
    log(f"phase 5: entry() step over {ENTRY_LEAVES} leaves warm: {step_ms} "
        f"ms; its B1 launch at {list(args[0].shape)}: {leaf_ms} ms, bound "
        f"{lb} ms ({lb_by})")
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one CUDA card", file=sys.stderr)
        return 2
    from dat_replication_protocol_tpu_torch.ops import _build

    device = "cuda"
    t_start = time.perf_counter()
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    report = _build.build()
    log(f"phase 1: built {sorted(report)} in "
        f"{time.perf_counter() - t0:.2f} s (nvcc in parallel)")
    for name, r in sorted(report.items()):
        for line in r["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    t0 = time.perf_counter()
    check_kernels(device)
    log(f"phase 2: {time.perf_counter() - t0:.2f} s")

    session = run_session(device)
    log(f"phase 3: session of {session['blobs']} x 1 MiB blobs (cut from "
        f"BASELINE configs[2]'s 10k to fit the time limit) and "
        f"{session['changes']} changes: {session['wire_bytes']} wire bytes "
        f"in {session['seconds']} s = {session['gib_per_s']} GiB/s end to "
        f"end, {session['dispatches']} dispatches, launches "
        f"{session['launches']}")
    prof = profile_session(device)
    log(f"phase 3: profiled session of 256 blobs: {prof['seconds']} s, "
        f"device busy share {prof['busy_share']}")
    for ms, key, count in prof["rows"][:6]:
        log(f"  {ms} ms device in {count} x {key[:90]}")
    side = run_sidecar(device)
    log(f"phase 3: sidecar.run_session replied {side['digests']} digests, "
        f"launches {side['launches']}")

    ent = run_entry(device)
    log(f"phase 4: entry() over {ent['leaves']} leaves in {ent['seconds']} s,"
        f" root {ent['root']}, launches {ent['launches']}")

    launches = {k: session["launches"][k] + side["launches"][k]
                + ent["launches"][k] for k in session["launches"]}
    rows = time_kernels(device, launches, ent["step"])
    for r in rows:
        if r["launches"] == 0:
            raise AssertionError(f"{r['name']} was not launched on the "
                                 "main path")
        log(f"phase 5: {r['name']} at {r['shape']}: {r['ms']} ms, plain "
            f"{r['plain_ms']} ms, bound {r['bound_ms']} ms ({r['bound_by']}),"
            f" {r['launches']} launches on the main path")
    log(f"total {time.perf_counter() - t_start:.1f} s on {card}")
    print(json.dumps({"kernels": [{k: v for k, v in r.items()
                                   if k != "shape"} for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
