"""The port's rateless coded symbols against the JAX package.

Digests are made with numpy from a seed (or hashed with hashlib).  The
JAX side builds with its numpy reference (``build_symbols_host``), its
jitted scatter-add (``engine="device"``, on the CPU) and, as an oracle
only, the native C engine; the port builds with a torch gather plus
``index_add_`` on the CPU.  Every comparison is byte-exact.  The card
build runs only on a CUDA card (``cuda`` marker).
"""

import hashlib

import numpy as np
import pytest
import torch

from dat_replication_protocol_tpu.ops import rateless as jrl
from dat_replication_protocol_tpu.runtime import native
from dat_replication_protocol_tpu_torch import weights
from dat_replication_protocol_tpu_torch.ops import rateless as rl


def _random(n, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, 32),
                                                dtype=np.uint8)


def _hashed(items):
    if not items:
        return np.empty((0, 32), np.uint8)
    return np.frombuffer(
        b"".join(hashlib.blake2b(x, digest_size=32).digest() for x in items),
        np.uint8).reshape(-1, 32).copy()


def _sets(n, k, seed):
    """A and B over one record space: k//2 records only in A, the rest of
    k only in B (bench.py config 11's split), the others shared."""
    ka = k // 2
    items = [b"rec-%d-%d" % (seed, i) for i in range(n + k - ka)]
    return _hashed(items[:n]), _hashed(items[ka:])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    return torch.device("cuda")


def test_constants_are_the_reference_values():
    for name in ("RATELESS_GAMMA", "RATELESS_MIX1", "RATELESS_MIX2",
                 "RATELESS_W_SHIFT", "RATELESS_W_CAP", "SYMBOL_WORDS",
                 "WSYMBOL_WORDS", "SYMBOL_BYTES", "WSYMBOL_BYTES"):
        assert getattr(rl, name) == getattr(jrl, name), name


def test_rows_checksums_and_mix_match_jax():
    d = _random(300, seed=1)
    assert np.array_equal(rl.element_rows(d), jrl.element_rows(d))
    words = d.view("<u4")
    assert np.array_equal(rl.checksum_words(words),
                          jrl.checksum_words(words))
    z = d.view("<u8")[:, 0]
    assert np.array_equal(rl._mix64(z), jrl._mix64(z))
    lens = np.random.default_rng(2).integers(0, 1 << 32, 300)
    assert np.array_equal(rl.weight_classes(lens), jrl.weight_classes(lens))
    assert np.array_equal(rl.weighted_element_rows(d, lens),
                          jrl.weighted_element_rows(d, lens))
    assert np.array_equal(rl.weighted_checksum_words(words, lens),
                          jrl.weighted_checksum_words(words, lens))


def test_dedupe_matches_jax_on_duplicates_and_first_word_collisions():
    d = _random(50, seed=3)
    twin = d[7].copy()
    twin[20] ^= 1  # same first u64 word, a distinct digest
    mixed = np.concatenate([d, d[:10], twin[None], d[7:8]])
    got, first = rl.dedupe_digests(mixed)
    want, wfirst = jrl.dedupe_digests(mixed)
    assert np.array_equal(got, want) and np.array_equal(first, wfirst)
    assert len(got) == 51
    empty = rl.dedupe_digests(np.empty((0, 32), np.uint8))
    assert empty[0].shape == (0, 32) and len(empty[1]) == 0


@pytest.mark.parametrize("schedule", [(256,), (16, 64, 256), (1, 2, 300)])
def test_index_cursor_matches_jax_on_every_schedule(schedule):
    d = _random(120, seed=4)
    lens = np.random.default_rng(5).integers(0, 1 << 24, 120)
    ours, theirs = rl.IndexCursor(d), jrl.IndexCursor(d)
    wours, wtheirs = (rl.WeightedIndexCursor(d, lens),
                      jrl.WeightedIndexCursor(d, lens))
    for m in schedule:
        for a, b in ((ours.advance(m), theirs.advance(m)),
                     (wours.advance(m), wtheirs.advance(m))):
            assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


def test_device_build_matches_host_and_jax_builds():
    d = _random(257, seed=6)
    rows = rl.element_rows(d)
    e, i = rl.IndexCursor(d).advance(192)
    got = rl.build_symbols_device(rows, e, i, 192, device="cpu")
    assert got.dtype == np.uint32 and got.shape == (192, 11)
    assert np.array_equal(got, jrl.build_symbols_host(rows, e, i, 192))
    assert np.array_equal(got, jrl.build_symbols_device(rows, e, i, 192))
    # a block past a base, and the same rows handed over as a tensor
    sel = i >= 64
    block = rl.build_symbols_device(torch.from_numpy(rows.view(np.int32)),
                                    e[sel], i[sel], 192, 64, device="cpu")
    assert np.array_equal(block, got[64:])
    assert np.array_equal(rl.build_symbols_host(rows, e, i, 192), got)


def test_device_build_wraps_u32_sums():
    rows = np.full((3, 11), 0xFFFFFFFF, dtype=np.uint32)
    e = np.array([0, 1, 2, 0], dtype=np.int64)
    i = np.array([0, 0, 0, 1], dtype=np.int64)
    got = rl.build_symbols_device(rows, e, i, 2, device="cpu")
    assert np.array_equal(got, jrl.build_symbols_host(rows, e, i, 2))
    assert got[0, 0] == 0xFFFFFFFD


def test_device_build_empty_and_out_of_range():
    rows = rl.element_rows(_random(4, seed=7))
    none = np.empty(0, np.int64)
    assert np.array_equal(rl.build_symbols_device(rows, none, none, 8,
                                                  device="cpu"),
                          np.zeros((8, 11), np.uint32))
    with pytest.raises(IndexError, match="symbol indices"):
        rl.build_symbols_device(rows, np.array([0]), np.array([8]), 8,
                                device="cpu")


@pytest.mark.parametrize("schedule", [(64,), (16, 64, 192), (5, 6, 7, 300)])
def test_coded_symbols_match_every_jax_engine(schedule):
    d = _random(257, seed=8)
    ours = rl.CodedSymbols(d, device="cpu")
    engines = ["numpy", "device"] + (["host"] if native.available() else [])
    theirs = {eng: jrl.CodedSymbols(d, engine=eng) for eng in engines}
    for m in schedule:
        got = ours.extend(m)
        for eng, cs in theirs.items():
            assert got.tobytes() == np.asarray(cs.extend(m)).tobytes(), eng
    assert np.array_equal(ours.extend(3), ours.extend(schedule[-1])[:3])


@pytest.mark.parametrize("schedule", [(64,), (16, 64, 192)])
def test_weighted_symbols_match_every_jax_engine(schedule):
    d = _random(200, seed=9)
    lens = np.random.default_rng(10).integers(0, 1 << 22, 200)
    ours = rl.WeightedSymbols(d, lens, device="cpu")
    engines = ["numpy", "device"] + (["host"] if native.available() else [])
    theirs = {eng: jrl.WeightedSymbols(d, lens, engine=eng)
              for eng in engines}
    for m in schedule:
        got = ours.extend(m)
        assert got.shape == (m, 12)
        for eng, cs in theirs.items():
            assert got.tobytes() == np.asarray(cs.extend(m)).tobytes(), eng


def _decode(sender, decoder, batch0=16):
    m, sent = batch0, 0
    while True:
        decoder.add_symbols(sent, sender.extend(m)[sent:])
        sent = m
        out = decoder.try_decode()
        if out is not None:
            return out, sent
        m *= 2
        assert m <= 1 << 16, "decode never completed"


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("k", [0, 1, 17, 300])
def test_peel_decoder_matches_jax(seed, k):
    da, db = _sets(400, k, seed)
    (got, sent), (want, wsent) = (
        _decode(rl.CodedSymbols(rl.dedupe_digests(da)[0], device="cpu"),
                rl.PeelDecoder(db, device="cpu")),
        _decode(jrl.CodedSymbols(jrl.dedupe_digests(da)[0], engine="numpy"),
                jrl.PeelDecoder(db, engine="numpy")))
    assert sent == wsent
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    a, b = {bytes(x) for x in da}, {bytes(x) for x in db}
    assert {bytes(x) for x in got[0][got[1] == 1]} == a - b
    assert {bytes(x) for x in got[0][got[1] == -1]} == b - a


def test_peel_matches_jax_on_a_partial_block():
    da, db = _sets(300, 120, seed=11)
    cs = rl.CodedSymbols(da, device="cpu")
    local = rl.CodedSymbols(db, device="cpu")
    work = (cs.extend(40) - local.extend(40)).astype(np.uint32)
    got = rl.peel(work.copy())
    want = jrl.peel(work.copy())
    assert not got[2] and got[2] == want[2]
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


@pytest.mark.parametrize("k", [0, 1, 40])
def test_weighted_peel_decoder_matches_jax(k):
    da, db = _sets(250, k, seed=12)
    lens_of = {bytes(x): int(h[0]) | int(h[1]) << 8 | int(h[2]) << 16
               for x, h in zip(np.concatenate([da, db]),
                               np.concatenate([da, db]))}
    la = np.array([lens_of[bytes(x)] for x in da], np.int64)
    lb = np.array([lens_of[bytes(x)] for x in db], np.int64)
    (got, sent), (want, wsent) = (
        _decode(rl.WeightedSymbols(da, la, device="cpu"),
                rl.WeightedPeelDecoder(db, lb, device="cpu")),
        _decode(jrl.WeightedSymbols(da, la, engine="numpy"),
                jrl.WeightedPeelDecoder(db, lb, engine="numpy")))
    assert sent == wsent
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    for d, n in zip(got[0], got[1]):
        assert lens_of[bytes(d)] == n


def test_identical_and_empty_sets():
    d = _random(100, seed=13)
    (got, sent) = _decode(rl.CodedSymbols(d, device="cpu"),
                          rl.PeelDecoder(d, device="cpu"))
    assert len(got[0]) == 0 and sent == 16
    empty = np.empty((0, 32), np.uint8)
    (got, _) = _decode(rl.CodedSymbols(empty, device="cpu"),
                       rl.PeelDecoder(d, device="cpu"))
    assert (got[1] == -1).all() and len(got[0]) == 100
    assert rl.PeelDecoder(d, device="cpu").try_decode() is None


def test_decoders_refuse_gaps_and_wrong_widths():
    d = _random(10, seed=14)
    dec = rl.PeelDecoder(d, device="cpu")
    cells = rl.CodedSymbols(d, device="cpu").extend(8)
    with pytest.raises(ValueError, match="starts at 4"):
        dec.add_symbols(4, cells)
    with pytest.raises(ValueError, match=r"\(k, 11\)"):
        dec.add_symbols(0, np.zeros((2, 12), np.uint32))
    wdec = rl.WeightedPeelDecoder(d, np.arange(10), device="cpu")
    with pytest.raises(ValueError, match=r"\(k, 12\)"):
        wdec.add_symbols(0, cells)
    with pytest.raises(ValueError, match="align"):
        rl.WeightedSymbols(d, np.arange(9), device="cpu")
    with pytest.raises(ValueError, match="u32"):
        rl.weighted_element_rows(d, np.full(10, 1 << 32))
    with pytest.raises(ValueError, match=">= 0"):
        rl.weighted_element_rows(d, np.full(10, -1))


@pytest.mark.parametrize("width", [11, 12])
def test_symbol_blocks_cross_packages_bit_for_bit(width):
    d = _random(90, seed=15)
    block = (jrl.CodedSymbols(d, engine="numpy").extend(64) if width == 11
             else jrl.WeightedSymbols(d, np.arange(90) << 10,
                                      engine="numpy").extend(64))
    t = weights.table_from_numpy(block, device="cpu")
    assert t.dtype == torch.int32 and t.shape == (64, width)
    back = weights.table_to_numpy(t)
    assert back.dtype == np.uint32 and back.tobytes() == block.tobytes()
    dec = rl.PeelDecoder(d[5:], device="cpu")
    if width == 11:  # a JAX-built symbol run decodes in the port
        dec.add_symbols(0, back)
        got = dec.try_decode()
        assert got is not None and len(got[0]) == 5


def test_table_from_numpy_refuses_other_shapes():
    with pytest.raises(ValueError, match="8\\|11\\|12"):
        weights.table_from_numpy(np.zeros((4, 9), np.uint32), device="cpu")
    with pytest.raises(ValueError, match="8\\|11\\|12"):
        weights.table_from_numpy(np.zeros(8, np.uint32), device="cpu")


@pytest.mark.cuda
def test_device_build_and_decode_on_card(cuda_device):
    da, db = _sets(5000, 60, seed=16)
    cs = rl.CodedSymbols(da, device=cuda_device)
    cells = cs.extend(256)
    e, i = rl.IndexCursor(da).advance(256)
    assert np.array_equal(cells, rl.build_symbols_host(rl.element_rows(da),
                                                       e, i, 256))
    (got, _) = _decode(rl.CodedSymbols(da, device=cuda_device),
                       rl.PeelDecoder(db, device=cuda_device))
    (want, _) = _decode(rl.CodedSymbols(da, device="cpu"),
                        rl.PeelDecoder(db, device="cpu"))
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
