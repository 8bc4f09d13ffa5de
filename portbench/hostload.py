"""What the host did around the window, for the noise a run's host-clock
metrics carry: this process's CPU seconds, the cgroup's CPU use and
throttling, the host's CPU pressure and load, and the host's speed on a
fixed piece of work before and after the window.  Only reads ``/proc``
and ``/sys``; a file that is not there reads as None."""

from __future__ import annotations

import os
import time

import numpy as np

CGROUP = "/sys/fs/cgroup"


def _read(path: str) -> str | None:
    try:
        with open(path, encoding="ascii") as f:
            return f.read()
    except OSError:
        return None


def _cpu_stat() -> dict:
    text = _read(f"{CGROUP}/cpu.stat") or ""
    out = {}
    for line in text.splitlines():
        k, _, v = line.partition(" ")
        if v.strip().isdigit():
            out[k] = int(v)
    return out


def _pressure_total_us() -> int | None:
    """``some`` stall microseconds of ``/proc/pressure/cpu``."""
    for line in (_read("/proc/pressure/cpu") or "").splitlines():
        if line.startswith("some"):
            for field in line.split():
                if field.startswith("total="):
                    return int(field[6:])
    return None


def snapshot() -> dict:
    t = os.times()
    return {"wall": time.perf_counter(), "cpu": t.user + t.system,
            "cgroup": _cpu_stat(), "pressure_us": _pressure_total_us()}


def describe() -> str:
    """The host's fixed facts: cores, affinity, the cgroup's quota."""
    affinity = len(os.sched_getaffinity(0)) if hasattr(
        os, "sched_getaffinity") else None
    quota = (_read(f"{CGROUP}/cpu.max") or "unread").strip()
    return (f"host: os.cpu_count() {os.cpu_count()}, affinity {affinity}, "
            f"cgroup cpu.max {quota!r}")


def between(a: dict, b: dict) -> str:
    """What the host did from snapshot ``a`` to snapshot ``b``."""
    wall = b["wall"] - a["wall"]
    parts = [f"wall {wall} s", f"process CPU {b['cpu'] - a['cpu']} s "
             f"({(b['cpu'] - a['cpu']) / wall if wall else 0.0} cores)"]
    ga, gb = a["cgroup"], b["cgroup"]
    for key, unit in (("usage_usec", "cgroup CPU"),
                      ("throttled_usec", "cgroup throttled")):
        if key in ga and key in gb:
            parts.append(f"{unit} {(gb[key] - ga[key]) / 1e6} s")
    if "nr_throttled" in ga and "nr_throttled" in gb:
        parts.append("throttled periods "
                     f"{gb['nr_throttled'] - ga['nr_throttled']}")
    if a["pressure_us"] is not None and b["pressure_us"] is not None:
        parts.append(f"CPU pressure (some) "
                     f"{(b['pressure_us'] - a['pressure_us']) / 1e6} s")
    load = (_read("/proc/loadavg") or "").split()[:3]
    parts.append(f"loadavg {' '.join(load)}")
    return ", ".join(parts)


CAL_LOOP = 1_000_000
CAL_BYTES = 256 << 20


def calibrate() -> str:
    """The host's speed now: seconds of a fixed pure-Python loop, and
    GB/s of a ``CAL_BYTES`` memory copy (one warm copy, then four)."""
    t = time.perf_counter()
    sum(i * i for i in range(CAL_LOOP))
    loop_s = time.perf_counter() - t
    src = np.ones(CAL_BYTES, dtype=np.uint8)
    dst = np.empty_like(src)
    np.copyto(dst, src)
    t = time.perf_counter()
    for _ in range(4):
        np.copyto(dst, src)
    copy_gbps = 4 * CAL_BYTES / (time.perf_counter() - t) / 1e9
    return f"python loop {loop_s} s, memory copy {copy_gbps} GB/s"
