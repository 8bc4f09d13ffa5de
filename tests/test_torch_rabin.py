"""The port's gear CDC scan against the JAX package.

Inputs are made with numpy from a seed and handed to both packages.  The
plain versions of kernels B3-B6 are held against the JAX package's
Pallas kernels in interpret mode, once each at the smallest shape its
own tests use (2 rows, stride 2048, avg_bits 8, thin_bits 9); everything
else uses the cheap oracles (``host_candidates``, ``host_thin``, the
native ``cdc_hash`` and the JAX ``chunk_stream``, which takes its native
host route here).  Every comparison is exact: these are hashes and
offsets.  The kernels themselves run only on a CUDA card (``cuda``
marker).
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dat_replication_protocol_tpu.ops import rabin as jrabin
from dat_replication_protocol_tpu.ops import rabin_pallas
from dat_replication_protocol_tpu.ops.fused_cdc_hash_pallas import (
    RESIDENCY_CAP as JAX_RESIDENCY_CAP,
)
from dat_replication_protocol_tpu.ops.fused_cdc_hash_pallas import (
    gear_window_first_checked as jax_checked,
)
from dat_replication_protocol_tpu.runtime import native
from dat_replication_protocol_tpu_torch.ops import fused_cdc_hash, rabin
from dat_replication_protocol_tpu_torch.ops.rabin_cuda import (
    gear_candidates_kernel,
    gear_first_kernel,
    gear_window_first_kernel,
)

CPU = torch.device("cpu")
T, STRIDE, AVG, THIN = 2, 2048, 8, 9


@pytest.fixture(scope="module")
def rows():
    """(jax rows, port rows) of the same bytes, built by the JAX package's
    ``_build_rows`` with the zero-seeded head prefix."""
    data = np.random.default_rng(17).integers(0, 256, T * STRIDE,
                                              dtype=np.uint8)
    words = jnp.asarray(data.view("<u4"))
    jrows = jrabin._build_rows(
        words, jnp.zeros((jrabin._PREFIX_WORDS,), jnp.uint32), T, STRIDE)
    host = np.asarray(jrows)
    return jrows, torch.from_numpy(host.view(np.int32).copy())


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def test_constants_match_the_jax_module():
    assert (rabin.WINDOW, rabin.GROUP, rabin.PACK) == (
        jrabin.WINDOW, jrabin.GROUP, jrabin.PACK)
    assert (rabin._PREFIX, rabin._PREFIX_WORDS, rabin.NO_HIT) == (
        jrabin._PREFIX, jrabin._PREFIX_WORDS, jrabin.NO_HIT)
    assert (rabin._GEAR_C1, rabin._GEAR_C2) == (jrabin._GEAR_C1,
                                                jrabin._GEAR_C2)
    assert rabin._SENT_OFF == rabin_pallas._SENT_OFF
    assert fused_cdc_hash.RESIDENCY_CAP == JAX_RESIDENCY_CAP


def test_b3_plain_matches_pallas_interpret(rows):
    jrows, trows = rows
    want = np.asarray(rabin_pallas.gear_candidates_pallas(
        jrows, AVG, interpret=True))
    got = rabin.gear_candidates_tiled(trows, AVG)
    assert got.shape == (T, (STRIDE + 256) // 32)
    assert np.array_equal(_u32(got), want)
    assert want[:, 8:].any(), "weak fixture: no candidates"


def test_b4_plain_matches_pallas_interpret(rows):
    jrows, trows = rows
    want = np.asarray(rabin_pallas.gear_first_pallas(jrows, AVG,
                                                     interpret=True))
    assert np.array_equal(_u32(rabin.gear_first_tiled(trows, AVG)), want)


def test_b5_plain_matches_pallas_interpret(rows):
    jrows, trows = rows
    want = np.asarray(rabin_pallas.gear_window_first_pallas(
        jrows, AVG, THIN, interpret=True))
    got = rabin.gear_window_first(trows, AVG, THIN)
    assert np.array_equal(got.numpy(), want)
    assert (want < (1 << 30)).any() and (want == (1 << 30)).any()


def test_b6_plain_matches_pallas_interpret(rows):
    jrows, trows = rows
    want, jviol = jax_checked(jrows, AVG, THIN, interpret=True)
    got, viol = rabin.gear_window_first_checked(trows, AVG, THIN)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert int(viol) == int(jviol) == 0


def test_wrappers_take_plain_versions_on_cpu_without_launching(rows):
    _, trows = rows
    before = (gear_candidates_kernel.launches, gear_first_kernel.launches,
              gear_window_first_kernel.launches,
              fused_cdc_hash.gear_window_first_checked_kernel.launches)
    assert torch.equal(gear_candidates_kernel(trows, AVG),
                       rabin.gear_candidates_tiled(trows, AVG))
    assert torch.equal(gear_first_kernel(trows, AVG),
                       rabin.gear_first_tiled(trows, AVG))
    assert torch.equal(gear_window_first_kernel(trows, AVG, THIN),
                       rabin.gear_window_first(trows, AVG, THIN))
    first, viol = fused_cdc_hash.gear_window_first_checked_kernel(
        trows, AVG, THIN)
    assert torch.equal(first, rabin.gear_window_first(trows, AVG, THIN))
    assert int(viol) == 0
    assert before == (gear_candidates_kernel.launches,
                      gear_first_kernel.launches,
                      gear_window_first_kernel.launches,
                      fused_cdc_hash.gear_window_first_checked_kernel.launches)


@pytest.mark.parametrize("avg_bits", [6, 8, 10])
def test_b3_plain_matches_host_candidates(avg_bits):
    data = random.Random(avg_bits).randbytes(3 * 1024 + 77)
    buf = np.frombuffer(data, dtype=np.uint8)
    got = rabin._device_candidates(buf, avg_bits, 1024, 2, None, "bitmask",
                                   CPU)
    assert got.tolist() == jrabin.host_candidates(data, avg_bits)


def test_host_references_match_jax():
    data = random.Random(29).randbytes(3000)
    cands = rabin.host_candidates(data, 7)
    assert cands == jrabin.host_candidates(data, 7) and cands
    assert rabin.host_thin(cands, 8) == jrabin.host_thin(cands, 8)


def test_gear_hash_rows_matches_the_serial_chain():
    data = np.random.default_rng(3).integers(0, 256, 512, dtype=np.uint8)
    rows = torch.from_numpy(data.view(np.int32).copy()).reshape(1, -1)
    h, want = 0, []
    for b in data.tolist():
        h = ((h << 1) + rabin._gear_g(b)) & 0xFFFFFFFFFFFFFFFF
        want.append(h)
    got = rabin.gear_hash_rows(rows)[0].numpy().view(np.uint64)
    assert got.tolist() == want


def test_first_bit_per_window_matches_host_thin():
    data = random.Random(5).randbytes(8 * 1024)
    buf = np.frombuffer(data, dtype=np.uint8)
    allc = jrabin.host_candidates(data, 7)
    for thin in (5, 6, 8, 10):
        got = rabin._device_candidates(buf, 7, 2048, 2, thin, "bitmask", CPU)
        assert got.tolist() == jrabin.host_thin(allc, thin)


@pytest.mark.parametrize("route", rabin.ROUTES)
def test_every_route_gives_the_host_reference_candidates(route):
    data = random.Random(13).randbytes(6 * 4096 + 321)
    buf = np.frombuffer(data, dtype=np.uint8)
    ref = jrabin.host_thin(jrabin.host_candidates(data, 8), 8)
    got = rabin._device_candidates(buf, 8, 1 << 12, 4, 8, route, CPU)
    assert got.tolist() == ref


@pytest.mark.parametrize("n,avg_bits,tile,slab_tiles", [
    (0, 8, 4096, 4),
    (1, 8, 4096, 4),
    (70_001, 8, 4096, 4),      # slab boundaries every 16 KiB
    (200_003, 10, 8192, 3),    # ragged last tile and slab
    (300_000, 13, 1 << 17, 8192),
    (150_000, 10, 2048, 16),
], ids=["empty", "one-byte", "slabs-8", "slabs-10", "default-13", "tile2k"])
def test_chunk_stream_matches_jax_and_native(n, avg_bits, tile, slab_tiles):
    data = np.random.default_rng(n + avg_bits).integers(0, 256, n,
                                                        dtype=np.uint8)
    got = rabin.chunk_stream(data, avg_bits, tile_bytes=tile,
                             slab_tiles=slab_tiles, device="cpu")
    assert got == jrabin.chunk_stream(data, avg_bits, tile_bytes=tile)
    if n:
        mn, mx = 1 << (avg_bits - 2), 1 << (avg_bits + 2)
        thin = rabin._clamp_thin_bits(mn.bit_length() - 1, tile)
        cuts, _ = native.cdc_hash(data, avg_bits, thin, mn, mx)
        assert got == cuts.tolist()
    else:
        assert got == []


def test_route_cuts_are_identical():
    data = np.random.default_rng(7).integers(0, 256, 100_000, dtype=np.uint8)
    cuts = {r: rabin.chunk_stream(data, 10, tile_bytes=4096, slab_tiles=8,
                                  route=r, device="cpu")
            for r in rabin.ROUTES}
    assert len({tuple(c) for c in cuts.values()}) == 1
    assert cuts["bitmask"] == jrabin.chunk_stream(data, 10, tile_bytes=4096)


def test_refused_fused1p_extraction_recomputes_on_bitmask(monkeypatch):
    """A nonzero ``viol`` from B6 is refused: the extraction recomputes
    on the bitmask route, the refusal is counted, and the candidates are
    still the host reference's."""

    def divergent(rows, avg_bits, thin_bits):
        first, _ = rabin.gear_window_first_checked(rows, avg_bits, thin_bits)
        return first, torch.tensor(1)

    monkeypatch.setattr(fused_cdc_hash, "gear_window_first_checked_kernel",
                        divergent)
    data = random.Random(23).randbytes(2 << 12)
    words = torch.from_numpy(np.frombuffer(data, np.uint8).view(np.int32)
                             .copy())
    before = rabin.candidates_begin.refusals
    got = rabin.candidates_words(words, len(data), avg_bits=8,
                                 tile_bytes=1 << 12, thin_bits=8,
                                 route="fused1p")
    assert got.tolist() == jrabin.host_thin(jrabin.host_candidates(data, 8),
                                            8)
    assert rabin.candidates_begin.refusals == before + 1


def test_unknown_route_is_refused():
    with pytest.raises(ValueError, match="unknown CDC route"):
        rabin.chunk_stream(b"abc", route="fast", device="cpu")
    with pytest.raises(ValueError, match="unknown CDC route"):
        rabin.candidates_begin(torch.zeros(1, dtype=torch.int32), 4,
                               route="FUSED1P")


def test_greedy_matches_the_reference_loop():
    rng = np.random.default_rng(11)
    cands = np.sort(rng.choice(1 << 20, 300, replace=False))
    for mn, mx in ((256, 4096), (2048, 32768), (1, 1 << 21)):
        assert rabin._greedy_select(cands, 1 << 20, mn, mx) == \
            jrabin._greedy_select_py(cands, 1 << 20, mn, mx)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernels_match_plain_on_card(cuda_device, rows):
    _, trows = rows
    g = trows.to(cuda_device)
    assert torch.equal(gear_candidates_kernel(g, AVG).cpu(),
                       rabin.gear_candidates_tiled(trows, AVG))
    assert torch.equal(gear_first_kernel(g, AVG).cpu(),
                       rabin.gear_first_tiled(trows, AVG))
    want = rabin.gear_window_first(trows, AVG, THIN)
    assert torch.equal(gear_window_first_kernel(g, AVG, THIN).cpu(), want)
    first, viol = fused_cdc_hash.gear_window_first_checked_kernel(
        g, AVG, THIN)
    assert torch.equal(first.cpu(), want) and int(viol) == 0
