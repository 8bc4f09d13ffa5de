"""The port's streaming BLAKE2b against the JAX package and hashlib.

``blake2b_update`` (the plain version of B1's chained entry) takes the same
numpy-made states, counters and segments as the JAX package's jitted
``blake2b_update``, at one small shape; ``Blake2bStream(device="cpu")``
takes the same streams as the JAX ``Blake2bStream`` and ``hashlib``.
Digests, states and counters are compared exactly.  The chained entry
itself runs only on a CUDA card (``cuda`` marker).
"""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dat_replication_protocol_tpu.ops import blake2b as jax_b2b
from dat_replication_protocol_tpu_torch.ops import blake2b as b2b
from dat_replication_protocol_tpu_torch.ops.blake2b_cuda import (
    LANES,
    blake2b_update_kernel,
    launch_update,
)

B, NBLOCKS = 6, 4  # the one shape of the JAX update calls
SEG = 256  # stream segment bytes: two blocks


def _hashlib(data, digest_size=32):
    return hashlib.blake2b(data, digest_size=digest_size).digest()


def _update_inputs(case: str, seed: int = 1):
    """(hh, hl, t_hi, t_lo, mh, ml, seg_lengths, is_last) as uint32/bool
    numpy arrays, for one case."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, (2, B, NBLOCKS, 16), dtype=np.uint32)
    if case == "fresh":
        # the IV state at t = 0: the empty message, one byte, a block, a
        # block and a byte, two whole blocks not last, four blocks
        hh, hl = (np.asarray(a) for a in jax_b2b.initial_state(B, 32))
        t_hi = t_lo = np.zeros(B, np.uint32)
        lengths = np.array([0, 1, 128, 129, 256, 512], np.uint32)
        last = np.array([1, 1, 1, 1, 0, 1], bool)
    elif case == "t_hi":
        # a stream past 4 GiB, one state about to carry into t_hi, and a
        # zero-length last segment at t != 0 (no block compressed)
        hh, hl = rng.integers(0, 1 << 32, (2, B, 8), dtype=np.uint32)
        t_hi = np.array([1, 1, 0, 7, 1, 0xFFFFFFFF], np.uint32)
        t_lo = np.array([0, 0xFFFFFF80, 0xFFFFFF00, 384, 0, 0xFFFFFF80],
                        np.uint32)
        lengths = np.array([512, 256, 300, 0, 1, 128], np.uint32)
        last = np.array([0, 0, 1, 1, 1, 1], bool)
    elif case == "tail-bucket":
        # last segments bucketed to 4 blocks that hold 1-2: the padded
        # blocks carry garbage, which must not be compressed
        hh, hl = rng.integers(0, 1 << 32, (2, B, 8), dtype=np.uint32)
        t_hi = np.zeros(B, np.uint32)
        t_lo = np.array([128, 256, 4096, 128, 0, 1 << 20], np.uint32)
        lengths = np.array([1, 127, 128, 200, 5, 256], np.uint32)
        last = np.ones(B, bool)
    else:
        raise ValueError(case)
    # zero the bytes past each length inside its last block (the packers'
    # contract); whole blocks past it keep their garbage
    raw = np.zeros((B, NBLOCKS, 32), np.uint32)
    raw[..., 1::2], raw[..., 0::2] = words
    raw8 = raw.view(np.uint8).reshape(B, NBLOCKS * 128)
    for i, n in enumerate(lengths):
        end = -(-int(n) // 128) * 128
        raw8[i, int(n):end] = 0
    mh = raw.reshape(B, NBLOCKS, 32)[..., 1::2].copy()
    ml = raw.reshape(B, NBLOCKS, 32)[..., 0::2].copy()
    return hh, hl, t_hi, t_lo, mh, ml, lengths, last


def _torch(arrays):
    return tuple(torch.from_numpy(a) if a.dtype == bool else
                 torch.from_numpy(np.array(a).view(np.int32))
                 for a in arrays)


def _u32(t):
    return t.contiguous().numpy().view(np.uint32)


@pytest.mark.parametrize("case", ["fresh", "t_hi", "tail-bucket"])
def test_plain_update_matches_jax(case):
    args = _update_inputs(case)
    want = jax_b2b.blake2b_update(*(jnp.asarray(a) for a in args))
    got = b2b.blake2b_update(*_torch(args))
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        assert np.array_equal(_u32(g), np.asarray(w))


def test_plain_update_carries_into_t_hi():
    args = _update_inputs("t_hi")
    _, _, t_hi, t_lo = b2b.blake2b_update(*_torch(args))
    assert _u32(t_hi)[1] == 2 and _u32(t_lo)[1] == 0x80
    assert _u32(t_hi)[5] == 0 and _u32(t_lo)[5] == 0  # 64-bit wrap


def test_plain_update_leaves_a_non_final_empty_segment_alone():
    args = list(_update_inputs("t_hi"))
    args[6] = np.zeros(B, np.uint32)
    args[7] = np.zeros(B, bool)
    hh, hl, t_hi, t_lo = b2b.blake2b_update(*_torch(args))
    assert np.array_equal(_u32(hh), args[0])
    assert np.array_equal(_u32(hl), args[1])
    assert np.array_equal(_u32(t_lo), args[3])


def test_update_chain_matches_hashlib():
    # two segments per item through the plain update, then the digest
    # (each last segment non-empty, as the stream keeps it)
    rng = np.random.default_rng(4)
    items = [rng.bytes(n) for n in (384, 300, 511, 257)]
    hh, hl = b2b.initial_state(len(items), device="cpu")
    t = torch.zeros(len(items), dtype=torch.int32)
    state = (hh, hl, t, t)
    for seg, last in ((slice(0, 256), False), (slice(256, None), True)):
        mh, ml, lengths = b2b.pack_payloads([p[seg] for p in items], 4)
        state = blake2b_update_kernel(*state, mh, ml, lengths,
                                      torch.full((len(items),), last))
    assert b2b.digests_to_bytes(*state[:2]) == [_hashlib(p) for p in items]


EDGE = (0, 1, 127, 128, 129, SEG - 1, SEG, SEG + 1, 2 * SEG, 2 * SEG + 1,
        5 * SEG - 3)


@pytest.mark.parametrize("n", EDGE)
def test_stream_matches_hashlib_and_jax(n):
    data = np.random.default_rng(n).bytes(n)
    ours = b2b.Blake2bStream(segment_bytes=SEG, device="cpu")
    theirs = jax_b2b.Blake2bStream(segment_bytes=SEG)
    for at in range(0, n, 100):
        ours.update(data[at:at + 100])
        theirs.update(data[at:at + 100])
    assert ours.length == theirs.length == n
    assert ours.digest() == theirs.digest() == _hashlib(data)
    assert ours.digest() == _hashlib(data)  # idempotent


@pytest.mark.parametrize("pieces", [[1] * 7 + [600], [SEG, SEG, 1], [777],
                                    [0, 777, 0]], ids=str)
def test_stream_digest_does_not_depend_on_the_split(pieces):
    data = np.random.default_rng(9).bytes(sum(pieces))
    s = b2b.Blake2bStream(segment_bytes=SEG, device="cpu")
    at = 0
    for k in pieces:
        s.update(memoryview(data)[at:at + k])
        at += k
    assert s.digest() == _hashlib(data)


@pytest.mark.parametrize("digest_size", [1, 20, 64])
def test_stream_digest_sizes_match_hashlib(digest_size):
    data = np.random.default_rng(2).bytes(700)
    s = b2b.Blake2bStream(digest_size, segment_bytes=SEG, device="cpu")
    assert s.update(data).digest() == _hashlib(data, digest_size)


def test_update_after_digest_raises_as_jax_does():
    for s in (b2b.Blake2bStream(segment_bytes=SEG, device="cpu"),
              jax_b2b.Blake2bStream(segment_bytes=SEG)):
        s.update(b"abc").digest()
        with pytest.raises(RuntimeError, match="after digest"):
            s.update(b"d")


def test_stream_refuses_a_segment_of_partial_blocks():
    with pytest.raises(ValueError, match="multiple of 128"):
        b2b.Blake2bStream(segment_bytes=200, device="cpu")
    with pytest.raises(ValueError, match="multiple of 128"):
        jax_b2b.Blake2bStream(segment_bytes=200)
    with pytest.raises(ValueError, match="multiple of 128"):
        b2b.Blake2bStream(segment_bytes=0, device="cpu")


def test_initial_state_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        b2b.initial_state(2)
    hh, hl = b2b.initial_state(2, device="cpu")
    jh, jl = jax_b2b.initial_state(2, 32)
    assert np.array_equal(_u32(hh), np.asarray(jh))
    assert np.array_equal(_u32(hl), np.asarray(jl))


def test_wrapper_takes_plain_version_on_cpu_without_launching():
    args = _torch(_update_inputs("t_hi"))
    before = blake2b_update_kernel.launches
    got = blake2b_update_kernel(*args)
    assert blake2b_update_kernel.launches == before
    for g, w in zip(got, b2b.blake2b_update(*args)):
        assert torch.equal(g, w)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["fresh", "t_hi", "tail-bucket"])
@pytest.mark.parametrize("lanes", LANES)
def test_chained_entry_matches_plain_on_the_card(cuda_device, case, lanes):
    args = [t.to(cuda_device) for t in _torch(_update_inputs(case))]
    before = blake2b_update_kernel.launches_by_lanes[lanes]
    got = launch_update(*args, lanes)
    assert blake2b_update_kernel.launches_by_lanes[lanes] == before + 1
    for g, w in zip(got, b2b.blake2b_update(*args)):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_stream_on_the_card_matches_hashlib(cuda_device):
    for n in EDGE:
        data = np.random.default_rng(n).bytes(n)
        s = b2b.Blake2bStream(segment_bytes=SEG, device=cuda_device)
        assert s.update(data).digest() == _hashlib(data)


def test_chained_entry_is_bound_from_b1s_library():
    # the entry lives in blake2b.cu, so loading B1's library binds both
    # entries, and its ctypes signature has one argument per C parameter
    from dat_replication_protocol_tpu_torch.ops import _build

    assert set(_build.SIGNATURES["blake2b"]) == {"dat_blake2b_packed",
                                                 "dat_blake2b_update"}
    src = (_build.CSRC / "blake2b.cu").read_text()
    params = src.split('extern "C" int dat_blake2b_update(')[1].split(")")[0]
    argtypes = _build.SIGNATURES["blake2b"]["dat_blake2b_update"]
    assert len(argtypes) == params.count(",") + 1 == 16
