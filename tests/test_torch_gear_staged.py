"""Kernels B4, B5 and B6 as their CUDA kernels decompose the work, and
B4's launch geometry, on the CPU.

B5 and B6 run one window scan (one thread per window, per-group hit
words in registers): it takes its window's first hit from the earliest
group that has one, and B6 also ORs the group's packed words into its
occupancy.  That decomposition of per-group results
(``rabin_cuda.window_reduce``) is held against the JAX package's Pallas
kernels in interpret mode: the per-group inputs are its B3 and B4, and
the result must equal its B5 and B6 (``first``) and the OR of its B3
words over each window (``occ``), at thin_bits 8, 9, 11 and 16 (B5 and
B6 themselves from the interpret kernels at 11 and 16, from the JAX host
reference at 8 and 9).  The geometry tests walk the spans of B4's staged
scan (``csrc/gear_staged.cuh``) as the kernel does and check that every
group is scanned exactly once with the right warm-up at span and row
edges.  Everything is exact.  The kernels themselves run only on a CUDA
card (``cuda`` marker).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dat_replication_protocol_tpu.ops import rabin as jrabin
from dat_replication_protocol_tpu.ops import rabin_pallas
from dat_replication_protocol_tpu.ops.fused_cdc_hash_pallas import (
    gear_window_first_checked as jax_checked,
)
from dat_replication_protocol_tpu_torch.ops import rabin, rabin_cuda
from dat_replication_protocol_tpu_torch.ops.fused_cdc_hash import (
    gear_window_first_checked_kernel,
)
from dat_replication_protocol_tpu_torch.ops.rabin_cuda import (
    STAGED_THREADS,
    staged_geometry,
    window_reduce,
)

T, STRIDE, AVG = 2, 1 << 16, 8  # payload a multiple of every window


@pytest.fixture(scope="module")
def per_group():
    """(jax rows, port rows, JAX B3 words, JAX B4 firsts, stream bytes)
    of one input: the rows of a stream head, as ``_build_rows`` makes
    them."""
    data = np.random.default_rng(41).integers(0, 256, T * STRIDE,
                                              dtype=np.uint8)
    jrows = jrabin._build_rows(
        jnp.asarray(data.view("<u4")),
        jnp.zeros((jrabin._PREFIX_WORDS,), jnp.uint32), T, STRIDE)
    words = np.asarray(rabin_pallas.gear_candidates_pallas(
        jrows, AVG, interpret=True))
    firsts = np.asarray(rabin_pallas.gear_first_pallas(jrows, AVG,
                                                       interpret=True))
    trows = torch.from_numpy(np.asarray(jrows).view(np.int32).copy())
    return (jrows, trows, torch.from_numpy(words.view(np.int32).copy()),
            torch.from_numpy(firsts.view(np.int32).copy()), data)


def _host_first(data: np.ndarray, thin_bits: int) -> np.ndarray:
    """Per-window first offsets from the JAX package's host reference
    (``host_thin`` of ``host_candidates``), windows aligned to the row
    payloads as the kernels' are."""
    W = 1 << thin_bits
    out = np.full(T * STRIDE // W, 1 << 30, dtype=np.int64)
    for p in jrabin.host_thin(jrabin.host_candidates(data.tobytes(), AVG),
                              thin_bits):
        out[p // W] = p % W
    return out


@pytest.mark.parametrize("thin_bits", [8, 9, 11, 16])
def test_window_reduction_equals_the_jax_b6_and_b3(per_group, thin_bits):
    """B6 from its kernel's decomposition of the JAX interpret B3 and B4,
    against the JAX interpret B6 (thin_bits 11 and 16) or the JAX host
    reference (8 and 9, where the interpret B6 is already held against
    the plain version in test_torch_rabin.py), and ``occ`` against the OR
    of the JAX B3 words over each window."""
    jrows, trows, words, firsts, data = per_group
    if thin_bits >= 11:
        want_first, jviol = jax_checked(jrows, AVG, thin_bits, interpret=True)
        want_first = np.asarray(want_first)
        assert int(jviol) == 0
    else:
        want_first = _host_first(data, thin_bits)
    wpw = (1 << thin_bits) // rabin.PACK
    payload = words.numpy().view(np.uint32)[:, rabin._PREFIX // rabin.PACK:]
    want_occ = np.bitwise_or.reduce(payload.reshape(-1, wpw), axis=1)
    assert (want_first < (1 << 30)).any()
    if thin_bits < 11:
        assert (want_first == (1 << 30)).any(), "weak fixture: no empty"
    assert np.array_equal(want_occ != 0, want_first < (1 << 30))
    first, occ = window_reduce(words, firsts, thin_bits)
    assert np.array_equal(first.numpy(), want_first)
    assert np.array_equal(occ.numpy().view(np.uint32), want_occ)
    # the same from the port's plain B3 and B4, and its plain B6
    pw, pf = (rabin.gear_candidates_tiled(trows, AVG),
              rabin.gear_first_tiled(trows, AVG))
    assert torch.equal(pw, words) and torch.equal(pf, firsts)
    first, _ = window_reduce(pw, pf, thin_bits)
    assert torch.equal(first, rabin.gear_window_first_checked(
        trows, AVG, thin_bits)[0])


@pytest.mark.parametrize("thin_bits", [8, 9, 11, 16])
def test_window_reduction_equals_the_jax_b5(per_group, thin_bits):
    """B5 from the decomposition its kernel shares with B6 (each group's
    first hit, then the earliest group that has one) of the JAX
    interpret B3 and B4, against the JAX package's B5: its interpret
    kernel at thin_bits 11 and 16, its host reference at 8 and 9."""
    jrows, _, words, firsts, data = per_group
    if thin_bits >= 11:
        want = np.asarray(rabin_pallas.gear_window_first_pallas(
            jrows, AVG, thin_bits, interpret=True))
    else:
        want = _host_first(data, thin_bits)
    assert (want < (1 << 30)).any()
    if thin_bits < 11:
        assert (want == (1 << 30)).any(), "weak fixture: no empty"
    first, _ = window_reduce(words, firsts, thin_bits)
    assert np.array_equal(first.numpy(), want)


def _spans(geom, nrows, S):
    """(row, group) of every thread's group, with the group its warm-up
    reads from (the one before it in the flat run, or None at the run's
    start), walked as the kernel walks spans: CTA c takes spans c,
    c + ctas, ...; thread t of span s scans flat group s * 256 + t of the
    rows read as one row of nrows * S/256 groups, and drops it past the
    end."""
    ng = S // 256
    out = []
    for c in range(geom.ctas):
        for s in range(c, geom.total_spans, geom.ctas):
            for t in range(STAGED_THREADS):
                g = s * STAGED_THREADS + t
                if g < nrows * ng:
                    out.append((divmod(g, ng), divmod(g - 1, ng) if g else None))
    return out


@pytest.mark.parametrize("nrows,S", [
    (1, 256), (3, 256 + 2048), (7, 256 + (1 << 17)), (5, 256 + 4096),
    (9, 256 + 4096), (11, 256 + (1 << 17)), (3, 256 + (1 << 17)),
    (13, 256 + 2048)])
@pytest.mark.parametrize("sms", [1, 132])
def test_every_group_is_scanned_once_with_its_warm_up(nrows, S, sms):
    geom = staged_geometry(nrows, S, sms=sms)
    ng = S // 256
    seen = {}
    for (r, g), before in _spans(geom, nrows, S):
        assert (r, g) not in seen
        seen[(r, g)] = before
    assert set(seen) == {(r, g) for r in range(nrows) for g in range(ng)}
    for (r, g), before in seen.items():
        # a group warms on the 64 bytes before it, in its row; a row's
        # group 0 starts from the zero state (the kernel discards the
        # warm-up there, which reads the previous row's last group)
        assert before == ((r, g - 1) if g else
                          (None if r == 0 else (r - 1, ng - 1)))
    assert 1 <= geom.ctas <= geom.total_spans


def test_b4_spans_cross_rows_and_only_the_last_is_ragged():
    S = 256 + (1 << 17)  # 513 groups a row
    geom = staged_geometry(8192, S)
    assert geom.total_spans == -(-8192 * 513 // STAGED_THREADS)
    # a row-aligned span would leave the 513th group a span of its own
    assert geom.total_spans < 8192 * -(-513 // STAGED_THREADS)


def test_grid_is_one_resident_cta_an_sm_and_at_most_one_a_span():
    """Two spans of 257 slots of 272 B take 139,808 B of shared memory:
    one CTA an SM, so the grid is the SM count, or the span count when
    there are fewer spans."""
    assert rabin_cuda.STAGED_SMEM == 2 * 257 * 272
    S = 256 + (1 << 17)
    assert staged_geometry(8192, S, sms=132) == (132, 16416)
    assert staged_geometry(8192, S, sms=114).ctas == 114
    assert staged_geometry(3, S, sms=132) == (7, 7)
    assert staged_geometry(0, S) == (0, 0)


def test_geometry_refuses_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="multiple of 256"):
        staged_geometry(2, 1000)
    with pytest.raises(ValueError, match="multiple of 256"):
        staged_geometry(2, 0)
    with pytest.raises(ValueError, match="multiple of 256"):
        staged_geometry(-1, 2304)


def test_args_are_the_c_entries_order():
    geom = staged_geometry(4, 256 + 4096)
    assert tuple(geom) == (geom.ctas, geom.total_spans)
    _I = rabin_cuda._build.ctypes.c_int
    argtypes = rabin_cuda._build.SIGNATURES["gear_first"]["dat_gear_first"]
    assert argtypes[5:7] == (_I, _I)
    assert len(argtypes) == 8


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("thin_bits", [8, 9, 11, 16])
def test_staged_kernels_match_plain_on_card(cuda_device, per_group,
                                            thin_bits):
    _, trows, words, firsts, _ = per_group
    rows = trows.to(cuda_device)
    assert torch.equal(rabin_cuda.gear_first_kernel(rows, AVG).cpu(), firsts)
    first, viol = gear_window_first_checked_kernel(rows, AVG, thin_bits)
    want = window_reduce(words, firsts, thin_bits)[0]
    assert torch.equal(first.cpu(), want)
    assert int(viol) == 0
    b5 = rabin_cuda.gear_window_first_kernel(rows, AVG, thin_bits)
    assert torch.equal(b5.cpu(), want)
    assert torch.equal(b5.cpu(), rabin.gear_window_first(trows, AVG,
                                                         thin_bits))
