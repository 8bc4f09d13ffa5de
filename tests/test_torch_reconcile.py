"""The port's sketch reconciliation against the JAX package.

Logs are made from seeded keys.  The JAX side builds its ``LogSummary``
with ``engine="device"`` (its jitted hash and scatter-add, on the CPU)
and ``engine="host"`` (the native C engine, an oracle only the tests
import); the port hashes with B1's plain version and scatter-adds with
``index_add_`` on the CPU.  Every comparison is byte-exact.  The card
path runs only on a CUDA card (``cuda`` marker).
"""

import hashlib
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dat_replication_protocol_tpu.ops import reconcile as jrec
from dat_replication_protocol_tpu_torch import weights
from dat_replication_protocol_tpu_torch.ops import reconcile as rec


def _log(keys, suffix=b""):
    return [b"record:" + k * 3 + suffix for k in keys], list(keys)


def _u32(t):
    return t.numpy().view(np.uint32)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    return torch.device("cuda")


@pytest.mark.parametrize("n,log2_slots", [(257, 10), (600, 8)],
                         ids=["sparse", "repeated-slots"])
def test_log_summary_matches_jax_engines(n, log2_slots):
    keys = [b"k-%04d" % i for i in range(n)]
    recs = [b"record-value:" + k * (1 + i % 3) for i, k in enumerate(keys)]
    ours = rec.LogSummary(recs, keys, log2_slots, device="cpu")
    assert ours.table.dtype == torch.int32
    assert ours.table.shape == (1 << log2_slots, 8)
    assert ours.slots.dtype == np.int64
    engines = ("device", "host") if n == 257 else ("host",)
    for engine in engines:
        theirs = jrec.LogSummary(recs, keys, log2_slots, engine=engine)
        assert np.array_equal(_u32(ours.table), np.asarray(theirs.table))
        assert np.array_equal(ours.slots, theirs.slots)
    if n == 600:  # more records than slots: cells hold sums of several
        assert len(np.unique(ours.slots)) < n


def test_table_equals_hashlib_and_add_at():
    keys = [b"x%03d" % i for i in range(300)]
    recs, _ = _log(keys)
    ours = rec.LogSummary(recs, keys, 9, device="cpu")
    table = np.zeros((512, 8), np.uint32)
    for r, k in zip(recs, keys):
        kd = hashlib.blake2b(k, digest_size=32).digest()
        rd = hashlib.blake2b(r, digest_size=32).digest()
        np.add.at(table, int.from_bytes(kd[:4], "little") & 511,
                  np.frombuffer(rd, "<u4"))
    assert np.array_equal(_u32(ours.table), table)


def test_key_slots_at_31_bits_keep_the_top_bit_out():
    # key digests whose first low word has its top bit set
    keys = [b"top-%d" % i for i in range(400)]
    kd = [hashlib.blake2b(k, digest_size=32).digest() for k in keys]
    words = np.frombuffer(b"".join(kd), "<u4").reshape(-1, 8)
    assert (words[:, 0] >> 31).any() and not (words[:, 0] >> 31).all()
    hl = torch.from_numpy(np.ascontiguousarray(words[:, 0::2]).view(np.int32))
    slots = rec.key_slots(hl, 31)
    assert slots.dtype == torch.int32 and bool((slots >= 0).all())
    # the reference's formula, on its device path and its hashlib path
    want = np.asarray(jnp.asarray(words[:, 0::2])[:, 0]
                      & jnp.uint32((1 << 31) - 1))
    assert np.array_equal(slots.numpy().astype(np.uint32), want)
    assert slots.tolist() == [int.from_bytes(d[:4], "little") & (2**31 - 1)
                              for d in kd]


def test_sketch_table_masks_top_bit_slots_like_jax():
    rng = np.random.default_rng(3)
    words = rng.integers(0, 1 << 32, (2, 500, 4), dtype=np.uint64).astype(
        np.uint32)
    slots = rng.integers(0, 1 << 32, 500, dtype=np.uint64).astype(np.uint32)
    slots[:5] = [0xFFFFFFFF, 0x80000000, 0x80000001, 0xFFFFFC00, 0x7FFFFFFF]
    got = rec.sketch_table(torch.from_numpy(words[0].view(np.int32)),
                           torch.from_numpy(words[1].view(np.int32)),
                           torch.from_numpy(slots.view(np.int32)), 1024)
    want = jrec.sketch_table(jnp.asarray(words[0]), jnp.asarray(words[1]),
                             jnp.asarray(slots), 1024)
    assert np.array_equal(_u32(got), np.asarray(want))


def test_scatter_add_wraps_like_add_at():
    words = np.full((4, 8), 0xFFFFFFFF, np.uint32)
    words[3] = np.arange(8, dtype=np.uint32) << 29
    index = np.array([0, 0, 0, 1])
    got = rec.scatter_add_words(3, torch.from_numpy(index),
                                torch.from_numpy(words.view(np.int32)))
    want = np.zeros((3, 8), np.uint32)
    np.add.at(want, index, words)
    assert np.array_equal(_u32(got), want)


def test_reconcile_matches_jax_on_inserts_deletes_and_flips():
    rng = random.Random(5)
    keys = [b"key-%05d" % i for i in range(800)]
    b_keys = list(keys)
    inserted = [b"new-%d" % i for i in range(5)]
    for k in inserted:
        b_keys.insert(rng.randrange(len(b_keys)), k)
    deleted = [b_keys.pop(rng.randrange(len(b_keys))) for _ in range(4)]
    a_recs, _ = _log(keys)
    b_recs, _ = _log(b_keys)
    flipped = []
    for _ in range(3):
        i = rng.randrange(len(b_keys))
        if b_keys[i] in inserted:
            continue
        b_recs[i] += b"~v2"
        flipped.append(b_keys[i])
    ours = rec.reconcile(rec.LogSummary(a_recs, keys, 11, device="cpu"),
                         rec.LogSummary(b_recs, b_keys, 11, device="cpu"))
    theirs = jrec.reconcile(jrec.LogSummary(a_recs, keys, 11, engine="host"),
                            jrec.LogSummary(b_recs, b_keys, 11,
                                            engine="host"))
    assert ours["slots"].dtype == np.int64
    assert np.array_equal(ours["slots"], theirs["slots"])
    assert ours["a_keys"] == theirs["a_keys"]
    assert ours["b_keys"] == theirs["b_keys"]
    assert set(inserted) | set(flipped) <= set(ours["b_keys"])
    assert (set(deleted) - set(inserted)) | set(flipped) <= set(
        ours["a_keys"])


def test_reorder_is_invisible_and_identical_logs_agree():
    keys = [b"o%03d" % i for i in range(300)]
    shuffled = list(keys)
    random.Random(9).shuffle(shuffled)
    recs, _ = _log(keys)
    by_key = dict(zip(keys, recs))
    a = rec.LogSummary(recs, keys, 10, device="cpu")
    b = rec.LogSummary([by_key[k] for k in shuffled], shuffled, 10,
                       device="cpu")
    assert torch.equal(a.table, b.table)
    out = rec.reconcile(a, b)
    assert len(out["slots"]) == 0 and out["a_keys"] == out["b_keys"] == []


def test_empty_replica_bootstrap_matches_jax():
    keys = [b"e%03d" % i for i in range(100)]
    recs, _ = _log(keys)
    empty = rec.LogSummary([], [], 10, device="cpu")
    assert empty.slots.shape == (0,) and not empty.table.any()
    ours = rec.reconcile(empty, rec.LogSummary(recs, keys, 10, device="cpu"))
    theirs = jrec.reconcile(jrec.LogSummary([], [], 10),
                            jrec.LogSummary(recs, keys, 10, engine="host"))
    assert ours["a_keys"] == [] and set(ours["b_keys"]) == set(keys)
    assert ours["b_keys"] == theirs["b_keys"]
    assert np.array_equal(ours["slots"], theirs["slots"])


@pytest.mark.parametrize("bad", [0, -1, 32, 40])
def test_log2_slots_bounds(bad):
    recs, keys = _log([b"a", b"b"])
    with pytest.raises(ValueError, match="log2_slots"):
        rec.LogSummary(recs, keys, bad, device="cpu")


def test_records_and_keys_must_align():
    with pytest.raises(ValueError, match="align"):
        rec.LogSummary([b"r1", b"r2"], [b"k1"], 8, device="cpu")


def test_table_leaves_and_diff_sketches_match_jax():
    keys = [b"t%03d" % i for i in range(200)]
    a = rec.LogSummary(*_log(keys), 8, device="cpu")
    b = rec.LogSummary(*_log(keys[:150] + [b"other"]), 8, device="cpu")
    ta, tb = _u32(a.table), _u32(b.table)
    hh, hl = rec.table_leaves(a.table)
    jhh, jhl = jrec.table_leaves(ta)
    assert hh.is_contiguous() and hl.is_contiguous()
    assert np.array_equal(_u32(hh), np.asarray(jhh))
    assert np.array_equal(_u32(hl), np.asarray(jhl))
    got = rec.diff_sketches(a.table, b.table)
    assert np.array_equal(got, jrec.diff_sketches(ta, tb)) and len(got)
    with pytest.raises(ValueError, match="equal slot counts"):
        rec.diff_sketches(a.table, b.table[:128])


def test_sketch_tables_cross_packages_and_reconcile():
    keys = [b"w%04d" % i for i in range(500)]
    b_keys = keys[:400] + [b"fresh-%d" % i for i in range(7)] + keys[400:]
    a_recs, _ = _log(keys)
    b_recs, _ = _log(b_keys)
    ja = jrec.LogSummary(a_recs, keys, 10, engine="host")
    t = weights.table_from_numpy(ja.table, device="cpu")
    assert t.dtype == torch.int32
    assert weights.table_to_numpy(t).tobytes() == np.asarray(
        ja.table).tobytes()
    crossed = weights.log_summary_from_numpy(ja.table, ja.slots, ja.keys,
                                             device="cpu")
    native_b = rec.LogSummary(b_recs, b_keys, 10, device="cpu")
    ours = rec.reconcile(crossed, native_b)
    theirs = jrec.reconcile(ja, jrec.LogSummary(b_recs, b_keys, 10,
                                                engine="host"))
    assert np.array_equal(ours["slots"], theirs["slots"])
    assert ours["a_keys"] == theirs["a_keys"]
    assert ours["b_keys"] == theirs["b_keys"]
    own = rec.reconcile(rec.LogSummary(a_recs, keys, 10, device="cpu"),
                        native_b)
    assert np.array_equal(own["slots"], ours["slots"])
    with pytest.raises(ValueError, match="one slot per key"):
        weights.log_summary_from_numpy(ja.table, ja.slots[:-1], ja.keys,
                                       device="cpu")


@pytest.mark.cuda
def test_log_summary_on_card_matches_cpu(cuda_device):
    keys = [b"c%05d" % i for i in range(20000)]
    recs, _ = _log(keys)
    card = rec.LogSummary(recs, keys, 12, device=cuda_device)
    cpu = rec.LogSummary(recs, keys, 12, device="cpu")
    assert card.table.device.type == "cuda"
    assert torch.equal(card.table.cpu(), cpu.table)
    assert np.array_equal(card.slots, cpu.slots)
    other = rec.LogSummary(*_log(keys[1:]), 12, device=cuda_device)
    out = rec.reconcile(card, other)
    assert out["a_keys"] and keys[0] in out["a_keys"]


def test_sketch_sums_are_exact_and_cut_to_the_table():
    # the int64 sums of unsigned words do not wrap; their low 32 bits are
    # the sketch table (exact integers: no tolerance)
    words = np.full((2, 3, 4), 0xFFFFFFFF, np.uint32)
    slots = np.zeros(3, np.int32)
    args = [torch.from_numpy(words[0].view(np.int32)),
            torch.from_numpy(words[1].view(np.int32)),
            torch.from_numpy(slots)]
    sums = rec.sketch_sums(*args, 4)
    assert sums.dtype == torch.int64
    assert sums[0].tolist() == [3 * 0xFFFFFFFF] * 8
    assert sums[1:].eq(0).all()
    assert torch.equal(sums.to(torch.int32), rec.sketch_table(*args, 4))
