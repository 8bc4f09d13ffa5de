"""Replayed change records -> Merkle leaves and device columns.

``batch.feed.leaves_from_columns(device="cpu")`` in all three branches
(the per-record wire's own extents, the canonical re-encode of a batch
log, and ``frames=None``'s re-encode of ``cols.row(i)``) is held against
``hashlib.blake2b(digest_size=32)`` of the bytes each branch hashes and
against the JAX package's ``leaves_from_columns`` on the same log; the
root of the padded leaves (plain B2) against ``root_host``.
``decode_batch_device(device="cpu")`` is held against the host columns
of ``decode_change_batch``.  Every comparison is exact.  The ``cuda``
case does the same on the card, kernels B1 and B2, and skips here.
"""

import hashlib

import numpy as np
import pytest
import torch

from dat_replication_protocol_tpu.batch import feed as jax_feed
from dat_replication_protocol_tpu.runtime import replay as jax_replay
from dat_replication_protocol_tpu_torch.batch import feed
from dat_replication_protocol_tpu_torch.ops import merkle
from dat_replication_protocol_tpu_torch.ops.blake2b_cuda import (
    blake2b_packed_kernel,
)
from dat_replication_protocol_tpu_torch.ops.merkle_cuda import (
    merkle_level_kernel,
)
from dat_replication_protocol_tpu_torch.runtime import replay
from dat_replication_protocol_tpu_torch.wire import batch_codec
from dat_replication_protocol_tpu_torch.wire.change_codec import (
    encode_change,
)
from dat_replication_protocol_tpu_torch.wire.framing import (
    TYPE_BLOB,
    TYPE_CHANGE,
    frame,
)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    return torch.device("cuda")


def _records(n, seed):
    rng = np.random.default_rng(seed)
    return [{"key": f"key-{int(rng.integers(0, 40)):04d}",
             "change": int(rng.integers(0, 1 << 32)), "from": i, "to": i + 1,
             "value": (None if i % 4 == 0
                       else rng.bytes(int(rng.integers(0, 400)))),
             "subset": None if i % 3 == 0 else f"s{i % 2}"}
            for i in range(n)]


def _logs(n, seed):
    """(records, per-record wire, batch wire with a blob between frames)."""
    records = _records(n, seed)
    wire = b"".join(frame(TYPE_CHANGE, encode_change(r)) for r in records)
    cols, _ = replay.replay_log(np.frombuffer(wire, np.uint8))
    half = n // 2
    bwire = (replay.encode_batch_frames(replay._slice_columns(cols, 0, half),
                                        16)
             + frame(TYPE_BLOB, b"blob")
             + replay.encode_batch_frames(
                 replay._slice_columns(cols, half, n), 16))
    return records, wire, bwire


def _h(data) -> bytes:
    return hashlib.blake2b(data, digest_size=32).digest()


def _matrix(digests) -> np.ndarray:
    return np.frombuffer(b"".join(digests), np.uint8).reshape(-1, 32)


def _replay_both(wire):
    buf = np.frombuffer(wire, np.uint8)
    return replay.replay_log(buf), jax_replay.replay_log(buf)


@pytest.mark.parametrize("n,seed", [(1, 1), (37, 2), (300, 3)])
def test_leaves_with_frames_match_hashlib_and_jax(n, seed):
    records, wire, bwire = _logs(n, seed)
    want = _matrix([_h(encode_change(r)) for r in records])
    for log in (wire, bwire):
        (cols, frames), (jcols, jframes) = _replay_both(log)
        got = feed.leaves_from_columns(cols, frames, device="cpu")
        assert np.array_equal(got, want)
        assert np.array_equal(got, jax_feed.leaves_from_columns(jcols,
                                                                jframes))
        assert np.array_equal(
            feed.leaves_from_change_columns(cols, device="cpu"), want)


@pytest.mark.parametrize("n,seed", [(1, 4), (60, 5)])
def test_leaves_without_frames_hash_rows_as_jax(n, seed):
    """``frames=None`` re-encodes ``cols.row(i)``, absent optionals as
    present-empty, as the JAX package does: those leaves differ from
    the wire's for rows with an absent value or subset."""
    records, wire, _ = _logs(n, seed)
    (cols, _), (jcols, _) = _replay_both(wire)
    got = feed.leaves_from_columns(cols, device="cpu")
    assert np.array_equal(got, jax_feed.leaves_from_columns(jcols))
    assert np.array_equal(got, _matrix(
        [_h(encode_change(cols.row(i))) for i in range(n)]))
    assert n == 1 or not np.array_equal(
        got, _matrix([_h(encode_change(r)) for r in records]))


def test_leaves_of_an_empty_log():
    cols, frames = replay.replay_log(np.zeros(0, np.uint8))
    for leaves in (feed.leaves_from_columns(cols, frames, device="cpu"),
                   feed.leaves_from_columns(cols, device="cpu"),
                   feed.leaves_from_change_columns(cols, device="cpu")):
        assert leaves.shape == (0, 32)


def test_pack_ragged_of_a_whole_log_matches_jax():
    """Over 4,096 extents ``pack_ragged`` takes its numpy scatter (the
    replay leaves' case): the JAX package's packing, word for word."""
    _, wire, _ = _logs(5000, 9)
    cols, frames = replay.replay_log(np.frombuffer(wire, np.uint8))
    args = (frames.buf, frames.starts, frames.lens)
    for nb in (None, 8):
        got = feed.pack_ragged(*args, nb)
        want = jax_feed.pack_ragged(*args, nb)
        for a, b in zip(got, want):
            assert np.array_equal(a, np.asarray(b))


@pytest.mark.parametrize("n", [1, 5, 64, 100])
def test_root_of_replayed_leaves_matches_root_host(n):
    records, _, bwire = _logs(n, 6)
    cols, frames = replay.replay_log(np.frombuffer(bwire, np.uint8))
    leaves = feed.leaves_from_columns(cols, frames, device="cpu")
    hh, hl = merkle.digests_to_device([leaves.tobytes()], device="cpu")
    root = merkle.digests_from_device(*merkle.root(
        *merkle.pad_leaves(hh, hl)))[0]
    assert root == merkle.root_host([_h(encode_change(r)) for r in records])


@pytest.mark.parametrize("base", [0, 9])
def test_decode_batch_device_matches_host_columns(base):
    records = _records(100, 7)
    rows = [(r["key"].encode(), r["change"], r["from"], r["to"], r["value"],
             None if r["subset"] is None else r["subset"].encode())
            for r in records]
    payload = batch_codec.encode_rows(rows)
    dev = feed.decode_batch_device(payload, base=base, device="cpu")
    cols = batch_codec.decode_change_batch(payload, base=base)
    assert len(dev) == 100
    for name in ("change", "from_", "to", "val_off", "val_len"):
        t = getattr(dev, name)
        assert t.dtype == torch.int64 and t.device.type == "cpu"
        assert np.array_equal(t.numpy(), getattr(cols, name).astype(np.int64))
    assert int(dev.change.max()) > 1 << 31  # uint32 values above int32's
    assert bytes(dev.buf.numpy()) == payload
    # the buffer on the device serves value gathers directly
    for i in (1, 2, 99):
        vo, vl = int(dev.val_off[i]) - base, int(dev.val_len[i])
        assert bytes(dev.buf[vo:vo + vl].numpy()) == records[i]["value"]
    dev.buf[0] = 0  # a copy: the payload stays as it was
    assert payload[0] == batch_codec.BATCH_VERSION


def test_decode_batch_device_refuses_corrupt_payloads():
    payload = bytearray(batch_codec.encode_rows([(b"k", 1, 0, 1, b"v",
                                                  None)]))
    payload[1] = 3
    with pytest.raises(ValueError, match="bad ChangeBatch widths"):
        feed.decode_batch_device(bytes(payload), device="cpu")


@pytest.mark.cuda
def test_leaves_root_and_device_batch_on_card(cuda_device):
    records, wire, bwire = _logs(3000, 8)
    want = _matrix([_h(encode_change(r)) for r in records])
    before = blake2b_packed_kernel.launches
    for log in (wire, bwire):
        cols, frames = replay.replay_log(np.frombuffer(log, np.uint8))
        assert np.array_equal(
            feed.leaves_from_columns(cols, frames, device=cuda_device), want)
    assert blake2b_packed_kernel.launches > before
    cols, _ = replay.replay_log(np.frombuffer(wire, np.uint8))
    assert np.array_equal(feed.leaves_from_columns(cols, device=cuda_device),
                          feed.leaves_from_columns(cols, device="cpu"))
    hh, hl = merkle.digests_to_device([want.tobytes()], device=cuda_device)
    before = merkle_level_kernel.launches
    root = merkle.digests_from_device(*merkle.root(
        *merkle.pad_leaves(hh, hl)))[0]
    assert merkle_level_kernel.launches == before + 12
    assert root == merkle.root_host(list(map(bytes, want)))
    payload = batch_codec.encode_columns(cols)
    dev = feed.decode_batch_device(payload, device=cuda_device)
    host = feed.decode_batch_device(payload, device="cpu")
    for name in ("change", "from_", "to", "buf", "val_off", "val_len"):
        assert getattr(dev, name).device.type == "cuda"
        assert torch.equal(getattr(dev, name).cpu(), getattr(host, name))
