"""The port's kernel sentinel, engine notes, gauges and init watchdog.

``kernel_site`` is the port's counterpart of the reference's
``jit_site`` for callables without a jit cache: ``calls`` counts calls
(launches, on the card) and ``traces`` distinct argument signatures
(launch shapes).  Calls made while the current stream captures a CUDA
graph bypass it; the capture check is faked here.
"""

import time

import numpy as np
import pytest
import torch

from dat_replication_protocol_tpu.obs import device as jax_device
from dat_replication_protocol_tpu_torch.obs import (device, events, flight,
                                                    metrics, tracing)
from dat_replication_protocol_tpu_torch.ops import (blake2b_cuda,
                                                    fused_cdc_hash, merkle,
                                                    merkle_cuda, rabin,
                                                    rabin_cuda, rateless)


@pytest.fixture
def port_obs():
    """The port's gate on, with clean values, rings, recorder, sentinel
    and engine notes; the prior gate state restored afterwards."""
    was_on = metrics.OBS.on

    def reset():
        metrics.REGISTRY.reset()
        events.EVENTS.clear()
        tracing.SPANS.clear()
        flight.FLIGHT._reset_for_tests()
        device.SENTINEL.reset_for_tests()
        device.reset_engine_notes()

    reset()
    metrics.enable()
    try:
        yield metrics
    finally:
        metrics.OBS.on = was_on
        reset()


def _counter(name):
    return metrics.snapshot()["counters"].get(name, 0)


def test_site_counts_calls_and_signatures(port_obs):
    site = device.kernel_site("t.site.count", lambda x, k=1: x)
    for n in (4, 4, 8, 4, 8, 16):
        site(torch.zeros(n, dtype=torch.int32))
    site(torch.zeros(4, dtype=torch.int32), k=2)  # a scalar is part of it
    assert device.SENTINEL.snapshot()["t.site.count"] == {"calls": 7,
                                                          "traces": 4}
    assert _counter("device.jit.calls") == 7
    assert _counter("device.jit.traces") == 4
    traces = events.EVENTS.events("device.jit.trace")
    assert [e["fields"]["traces"] for e in traces] == [1, 2, 3, 4]
    assert traces[0]["fields"]["signature"] == "(4,)torch.int32"


def test_site_flags_the_budget_once(port_obs):
    site = device.kernel_site("t.site.budget", lambda x: x)
    for n in range(1, 13):
        site(np.zeros(n))
    (ev,) = events.EVENTS.events("device.jit.recompile_budget")
    assert ev["fields"]["traces"] == device.DEFAULT_RECOMPILE_BUDGET + 1
    assert ev["fields"]["budget"] == 8
    over = device.RecompileBudget().check()
    assert over == [{"site": "t.site.budget", "calls": 12, "traces": 12}]
    assert not device.RecompileBudget(limit=12).check()
    with pytest.raises(ValueError):
        device.RecompileBudget(limit=0)


def test_site_skips_calls_under_graph_capture(port_obs, monkeypatch):
    seen = []
    site = device.kernel_site("t.site.capture", seen.append)
    monkeypatch.setattr(device, "_capturing", lambda: True)
    site(1)
    monkeypatch.setattr(device, "_capturing", lambda: False)
    site(2)
    assert seen == [1, 2]  # the call itself always runs
    assert device.SENTINEL.snapshot()["t.site.capture"]["calls"] == 1


def test_capture_check_never_initializes_cuda():
    assert device._capturing() is False
    assert not torch.cuda.is_initialized()


def test_site_is_dark_while_gate_off():
    site = device.kernel_site("t.site.dark", lambda x: x + 1)
    was_on = metrics.OBS.on
    metrics.OBS.on = False
    try:
        assert site(1) == 2
    finally:
        metrics.OBS.on = was_on
    assert "t.site.dark" not in device.SENTINEL.snapshot()


def test_site_forwards_attributes_to_the_wrapper(port_obs):
    def fn(x):
        fn_site.launches += 1
        return x

    fn.launches = 0
    fn_site = device.kernel_site("t.site.attrs", fn)
    fn_site(1)
    fn_site(2)
    assert fn.launches == 2 and fn_site.launches == 2
    fn_site.launches = 0  # a reset through the site lands on the wrapper
    assert fn.launches == 0
    assert fn_site.__wrapped__ is fn and fn_site.site == "t.site.attrs"
    assert device.SENTINEL.snapshot()["t.site.attrs"]["calls"] == 2


@pytest.mark.parametrize("wrapper,name", [
    (blake2b_cuda.blake2b_packed_kernel, "ops.blake2b_cuda.packed"),
    (blake2b_cuda.blake2b_update_kernel, "ops.blake2b_cuda.update"),
    (merkle_cuda.merkle_level_kernel, "ops.merkle_cuda.level"),
    (rabin_cuda.gear_candidates_kernel, "ops.rabin_cuda.candidates"),
    (rabin_cuda.gear_first_kernel, "ops.rabin_cuda.first"),
    (rabin_cuda.gear_window_first_kernel, "ops.rabin_cuda.window_first"),
    (fused_cdc_hash.gear_window_first_checked_kernel,
     "ops.fused_cdc_hash.window_first_checked"),
    (fused_cdc_hash.pack_extents_device, "ops.fused_cdc_hash.pack_extents"),
    (merkle.build_tree, "ops.merkle.build_tree"),
    (merkle.diff_root_guided, "ops.merkle.diff_root_guided"),
    (merkle.diff_root_guided_packed, "ops.merkle.diff_root_guided_packed"),
    (merkle.update_leaves, "ops.merkle.update_leaves"),
    (rabin._extract_first_occ, "ops.rabin.extract_first_occ"),
    (rabin._extract_candidates, "ops.rabin.extract_candidates"),
    (rateless.build_symbols_device, "ops.rateless.build"),
])
def test_port_sites_carry_their_names_and_launch_counters(wrapper, name):
    assert wrapper.site == name
    if name.startswith(("ops.blake2b_cuda", "ops.merkle_cuda",
                        "ops.rabin_cuda", "ops.fused_cdc_hash.window")):
        assert isinstance(wrapper.launches, int)


def test_b1_site_counts_a_cpu_batch(port_obs):
    from dat_replication_protocol_tpu_torch.ops import blake2b

    blake2b.blake2b_batch([b"a" * 10, b"b" * 300, b"c"], device="cpu")
    snap = device.SENTINEL.snapshot()
    # two buckets (1 and 4 blocks): two calls, two shapes
    assert snap["ops.blake2b_cuda.packed"] == {"calls": 2, "traces": 2}


def _b1_halves(n_items, nblocks):
    z = torch.zeros((n_items, nblocks, 16), dtype=torch.int32)
    return z, z.clone(), torch.zeros(n_items, dtype=torch.int32)


def test_b1_site_keys_on_the_block_count_not_the_item_count(port_obs):
    kernel = blake2b_cuda.blake2b_packed_kernel
    for n_items in (3, 17, 181, 238):  # one bucket, four grid lengths
        kernel(*_b1_halves(n_items, 4))
    kernel(*_b1_halves(5, 8))
    assert device.SENTINEL.snapshot()["ops.blake2b_cuda.packed"] == {
        "calls": 5, "traces": 2}
    (first, _) = events.EVENTS.events("device.jit.trace")
    assert first["fields"]["signature"] == "(None, 4, 16)torch.int32"


def test_b1_site_still_flags_unbucketed_block_counts(port_obs):
    kernel = blake2b_cuda.blake2b_packed_kernel
    for nblocks in range(1, device.DEFAULT_RECOMPILE_BUDGET + 3):
        kernel(*_b1_halves(2, nblocks))
    (ev,) = events.EVENTS.events("device.jit.recompile_budget")
    assert ev["fields"]["site"] == "ops.blake2b_cuda.packed"
    assert ev["fields"]["traces"] == device.DEFAULT_RECOMPILE_BUDGET + 1


def test_b2_site_gives_a_trees_levels_one_signature(port_obs):
    rng = np.random.default_rng(9)
    leaves = torch.from_numpy(rng.integers(-2**31, 2**31, (1024, 4),
                                           dtype=np.int64).astype(np.int32))
    merkle.root(leaves, leaves.clone())
    assert device.SENTINEL.snapshot()["ops.merkle_cuda.level"] == {
        "calls": 10, "traces": 1}


def test_content_address_meets_no_signature_budget(port_obs):
    """The main path's shapes are bucketed: a gated content_address,
    with phase 13's chunk sizes on its default route, raises no
    ``device.jit.recompile_budget``."""
    from dat_replication_protocol_tpu_torch.runtime.content import (
        content_address)

    blob = np.random.default_rng(13).integers(0, 256, 4 << 20,
                                              dtype=np.uint8).tobytes()
    content_address(blob, 13, 2 << 10, 32 << 10, route="fused1p",
                    device="cpu")
    snap = device.SENTINEL.snapshot()
    assert snap["ops.blake2b_cuda.packed"]["calls"] >= 3
    assert events.EVENTS.count("device.jit.recompile_budget") == 0
    assert not device.RecompileBudget().check()


def test_note_engine_records_changes_only(port_obs):
    for engine in ("quad", "quad", "thread", "thread", "quad"):
        device.note_engine("t.comp", engine)
    got = [e["fields"]["engine"]
           for e in events.EVENTS.events("device.engine.select")]
    assert got == ["quad", "thread", "quad"]
    device.reset_engine_notes()
    device.note_engine("t.comp", "quad")
    assert events.EVENTS.count("device.engine.select") == 4


def test_note_engine_key_widens_the_memo(port_obs):
    for nb, engine in ((1, "quad"), (64, "thread"), (1, "quad"),
                       (64, "thread")):
        device.note_engine("t.batch", engine, key=nb, nblocks=nb)
    assert events.EVENTS.count("device.engine.select") == 2


def test_note_engine_memo_matches_the_reference(port_obs, obs_enabled):
    from dat_replication_protocol_tpu.obs import events as jax_events

    jax_device.reset_engine_notes()
    seq = [("a", "x", None), ("a", "x", None), ("b", "y", 1), ("b", "z", 1),
           ("b", "y", 2), ("a", "w", None)]
    for comp, eng, key in seq:
        device.note_engine(comp, eng, key=key)
        jax_device.note_engine(comp, eng, key=key)
    strip = [(e["event"], e["fields"])
             for e in events.EVENTS.events("device.engine.select")]
    ref = [(e["event"], e["fields"])
           for e in jax_events.EVENTS.events("device.engine.select")]
    assert strip == ref


def test_gauges_sample_nothing_without_cuda(port_obs):
    assert device.sample_device_gauges() is False
    assert not torch.cuda.is_initialized()
    was_on = metrics.OBS.on
    metrics.OBS.on = False
    try:
        assert device.sample_device_gauges() is False
    finally:
        metrics.OBS.on = was_on


def test_gauges_read_the_caching_allocator(port_obs, monkeypatch):
    class FakeCuda:
        @staticmethod
        def is_initialized():
            return True

        @staticmethod
        def memory_allocated():
            return 4096

        @staticmethod
        def memory_stats():
            return {"active.all.current": 3}

    monkeypatch.setattr(torch, "cuda", FakeCuda)
    assert device.sample_device_gauges() is True
    gauges = metrics.snapshot()["gauges"]
    assert gauges["device.mem.bytes_in_use"] == 4096.0
    assert gauges["device.mem.live_buffers"] == 3.0


def test_watchdog_fires_and_bundle_names_the_stuck_stage(port_obs, tmp_path):
    flight.FLIGHT.arm(str(tmp_path))
    with device.BackendInitWatchdog(deadline_s=0.2) as wd:
        wd.stage("platform_probe")
        wd.stage("first_compile")
        time.sleep(0.6)
    assert wd.fired
    (stuck,) = events.EVENTS.events("backend.init.stuck")
    assert stuck["fields"]["stage"] == "first_compile"
    (done,) = events.EVENTS.events("backend.init.done")
    assert done["fields"]["stuck"] is True and done["fields"]["stages"] == 2
    b = flight.read_bundle(flight.FLIGHT.last_bundle)
    assert b["manifest"]["reason"] == "backend-init-stuck"
    assert b["manifest"]["extra"]["stage"] == "first_compile"
    assert [s["stage"] for s in b["manifest"]["extra"]["stages"]] == [
        "platform_probe", "first_compile"]
    (span,) = tracing.SPANS.spans("backend.init")
    assert span["fields"]["deadline_s"] == 0.2


def test_watchdog_clean_init_fires_nothing(port_obs, tmp_path):
    flight.FLIGHT.arm(str(tmp_path))
    with device.BackendInitWatchdog(deadline_s=5.0) as wd:
        for stage in device.INIT_STAGES:
            wd.stage(stage)
    assert not wd.fired and wd.current_stage == "first_compile"
    assert [s for s, _ in wd.stages] == list(jax_device.INIT_STAGES)
    assert events.EVENTS.count("backend.init.stuck") == 0
    assert events.EVENTS.count("backend.init.stage") == 3
    assert flight.FLIGHT.last_bundle is None
    assert not wd._timer.is_alive()
    with pytest.raises(ValueError):
        device.BackendInitWatchdog(deadline_s=0)
