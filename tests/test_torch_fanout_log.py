"""The port's broadcast log against the JAX package's.

The same numpy-seeded operation sequences (appends of many sizes,
attaches at retained and trimmed offsets, acks, detaches, reads, budget
enforcement, seal) run on both packages' ``BroadcastLog``: every slice,
trim, ``SnapshotNeeded`` refusal (and its retained range) and the final
state must be equal.
"""

import numpy as np
import pytest

from dat_replication_protocol_tpu.fanout import log as jlog
from dat_replication_protocol_tpu_torch.fanout import log as plog
from dat_replication_protocol_tpu_torch.session.resume import ResumeError


def _run(mod, seed, budget, n_ops=400):
    rng = np.random.default_rng(seed)
    log = mod.BroadcastLog(retention_budget=budget)
    cursors = {}
    trace = []
    for step in range(n_ops):
        op = rng.integers(0, 7)
        try:
            if op == 0 and not log.sealed:
                size = int(rng.choice([1, 100, 4095, 4096, 9000]))
                log.append(rng.bytes(size))
                trace.append(("append", log.start, log.end))
            elif op == 1:
                key = f"p{step}"
                off = None if rng.integers(0, 3) == 0 else int(
                    rng.integers(0, log.end + 2))
                cursors[key] = log.attach(key, off)
                trace.append(("attach", key, cursors[key].acked))
            elif op == 2 and cursors:
                key = sorted(cursors)[int(rng.integers(0, len(cursors)))]
                cur = cursors[key]
                off = int(rng.integers(cur.acked, log.end + 1))
                log.ack(cur, off)
                trace.append(("ack", key, off, log.start))
            elif op == 3 and cursors:
                key = sorted(cursors)[int(rng.integers(0, len(cursors)))]
                log.detach(cursors.pop(key))
                trace.append(("detach", key, log.start))
            elif op == 4:
                off = int(rng.integers(max(0, log.start - 50), log.end + 1))
                views = log.read_slices(off, int(rng.integers(1, 20000)),
                                        max_iov=int(rng.integers(1, 5)))
                trace.append(("read", off, [bytes(v) for v in views]))
            elif op == 5:
                log.enforce_retention()
                trace.append(("enforce", log.start, log.end))
            elif op == 6 and rng.integers(0, 40) == 0:
                log.seal()
                trace.append(("seal", log.end))
        except mod.SnapshotNeeded as e:
            trace.append(("snapshot_needed", e.offset, e.retained, str(e)))
        except (ValueError, ResumeError, jlog.ResumeError) as e:
            trace.append((type(e).__name__, str(e)))
    trace.append(("final", log.start, log.end, log.retained_bytes,
                  log.sealed, log.cursors_snapshot(),
                  log.read_from(log.start)))
    return trace


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("budget", [20_000, 1 << 20])
def test_seeded_operation_sequences_match_jax(seed, budget):
    assert _run(plog, seed, budget) == _run(jlog, seed, budget)


def test_trimmed_past_paths_raise_snapshot_needed_with_the_range():
    for mod in (plog, jlog):
        log = mod.BroadcastLog(retention_budget=10_000)
        lag = log.attach("lag", 0)
        log.append(b"x" * 8000)
        log.append(b"y" * 8000)
        log.enforce_retention()
        assert (log.start, log.end) == (6000, 16000)
        with pytest.raises(mod.SnapshotNeeded) as e:
            log.ack(lag, 100)
        assert e.value.retained == (6000, 16000)
        with pytest.raises(mod.SnapshotNeeded, match="below the retained"):
            log.read_slices(10, 5)
        with pytest.raises(mod.SnapshotNeeded, match="snapshot"):
            log.attach("late", 0)
        assert isinstance(e.value, ResumeError if mod is plog
                          else jlog.ResumeError)


def test_read_slices_alias_the_segments_and_append_refuses_after_seal():
    log = plog.BroadcastLog()
    big = b"z" * 10_000
    log.append(big)
    a, b = log.read_slices(0, 5000), log.read_slices(100, 5000)
    assert a[0].obj is b[0].obj  # zero-copy views of one segment
    log.seal()
    with pytest.raises(ValueError, match="sealed"):
        log.append(b"more")
    with pytest.raises(ValueError, match="non-empty"):
        log.seek(5)
