"""Roofline work counts on known shapes."""

import pytest

from portbench.work import blake2b, gear, peaks


def test_blake2b_compressions_and_operations():
    assert blake2b.compressions([0, 1, 127, 128, 129, 256, 257]) == (
        1 + 1 + 1 + 1 + 2 + 2 + 3)
    assert blake2b.G_OPS == 22
    assert blake2b.OPS_PER_COMPRESSION == 12 * 8 * 22 + 22 == 2134
    w = blake2b.work([0, 1 << 20])
    assert w == {"bytes": (1 << 20) + 64,
                 "ops": (1 + 8192) * 2134, "items": 2}


def test_gear_work():
    assert gear.work(1 << 30) == {"bytes": 1 << 30, "ops": 3 << 30}


def test_peaks_and_bound():
    assert peaks.INT32_OPS_PER_S == pytest.approx(16.73e12, rel=1e-3)
    assert peaks.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert peaks.bound_s(0, peaks.INT32_OPS_PER_S) == pytest.approx(1.0)
    # the gear scan is bound by its bytes on an H100
    g = gear.work(1 << 30)
    assert peaks.bound_s(g["bytes"], g["ops"]) == pytest.approx(
        (1 << 30) / 3.35e12)
    # B1's blob bucket (32 items of 1 MiB) is bound by its operations
    b = blake2b.work([1 << 20] * 32)
    assert peaks.bound_s(b["bytes"], b["ops"]) == pytest.approx(
        32 * 8192 * 2134 / peaks.INT32_OPS_PER_S)
