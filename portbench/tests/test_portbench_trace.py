"""The reduction of a profiler trace, on a made-up one."""

import pytest

from portbench import readers, trace


def ev(name, cat, ts, dur, tid=1, pid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": pid, "tid": tid}


EVENTS = [
    ev(trace.WINDOW_SPAN, "user_annotation", 0, 1000),
    ev("portbench.session", "user_annotation", 0, 1000),
    ev("digest.dispatch", "user_annotation", 100, 100),
    ev("aten::copy_", "cpu_op", 120, 50),
    ev("digest.collect", "user_annotation", 600, 50),
    ev("(anonymous namespace)::blake2b_quad_kernel(unsigned int const*, int)",
       "kernel", 200, 300, tid=7, pid=0),
    ev("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 150, 100, tid=7,
       pid=0),
    ev("void at::native::elementwise_kernel<128, 4, F<(lambda)#1> >(int, F)",
       "kernel", 900, 200, tid=7, pid=0),
    ev("digest.dispatch", "gpu_user_annotation", 150, 350, tid=7, pid=0),
    ev("aten::empty", "cpu_op", 5000, 10),  # outside the window
    {"ph": "i", "name": "instant", "ts": 3},
]


def test_window_busy_and_device_time():
    t = trace.Trace(EVENTS)
    assert t.window_s == pytest.approx(1e-3)
    # [150, 500] and [900, 1000] (clipped at the window's end)
    assert t.busy_s == pytest.approx(450e-6)
    assert t.kernel_seconds("blake2b_") == pytest.approx(300e-6)
    assert t.device_seconds(lambda b, f: "HtoD" in f) == pytest.approx(
        100e-6)
    assert t.span_seconds("digest.dispatch") == pytest.approx(100e-6)
    assert t.span_count("digest.collect") == 1
    assert [n for n, _ in t.device_ops()] == [
        "blake2b_quad_kernel", "Memcpy HtoD", "elementwise_kernel"]


def test_idle_gaps_by_what_the_host_was_in():
    gaps = dict(trace.Trace(EVENTS).idle_gaps())
    # [0, 150] mid 75: the session; [500, 900] mid 700: the session
    assert gaps == {"portbench.session": pytest.approx(550e-6)}


def test_readers():
    t = trace.Trace(EVENTS)
    ctx = readers.Context(trace=t, counters={
        "wire_bytes": 1 << 30, "b1": {"bytes": 0, "ops": 0}})
    assert readers.device_idle(ctx) == pytest.approx(55.0)
    assert readers.spans_seconds(ctx, ("digest.dispatch",
                                       "digest.collect")) == pytest.approx(
        150e-6)
    assert readers.roofline(ctx, "blake2b_", "b1") is None  # no work
    ctx.counters["b1"] = {"bytes": 3.35e12 * 150e-6, "ops": 0}
    assert readers.roofline(ctx, "blake2b_", "b1") == pytest.approx(50.0)
    assert readers.roofline(ctx, "gear_", "b1") is None
    assert readers.spans_seconds(ctx, ("cdc.greedy",)) is None
    assert readers.roofline(readers.Context(None, {}), "b", "b1") is None


def test_a_trace_without_the_window_is_refused():
    with pytest.raises(RuntimeError):
        trace.Trace(EVENTS[1:])
