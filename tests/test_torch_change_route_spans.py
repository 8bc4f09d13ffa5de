"""The port's change route in a traced session: one ``decoder.change_run``
range a run of the C change loop, counted in ``Decoder.change_runs``, and
one ``digest.submit`` range a run's payloads on the digest decoder, with
the batches the submits dispatch nested in it.  Never a range a row.

Each range is counted in a CPU ``torch.profiler`` capture, on a log of
per-record ``Change`` frames (configs[1]'s record shape: key
``key-%07d``, change ``i``, from ``i``, to ``i + 1``, a value of ``i mod
48`` bytes, subset ``"s"`` where ``i mod 3 != 0``) written in 64 KiB
writes, as a receiving peer's socket hands them over.
"""

import hashlib

import pytest
from torch.profiler import ProfilerActivity, profile

import dat_replication_protocol_tpu_torch as protocol
from dat_replication_protocol_tpu_torch.backend.cuda_backend import (
    DigestPipeline)
from dat_replication_protocol_tpu_torch.obs import metrics, tracing
from dat_replication_protocol_tpu_torch.runtime.replay import (
    encode_change_log)
from dat_replication_protocol_tpu_torch.session.decoder import Decoder
from dat_replication_protocol_tpu_torch.utils import trace

WRITE = 65536


def _records(n: int) -> list[dict]:
    return [{"key": f"key-{i:07d}", "change": i, "from": i, "to": i + 1,
             "value": bytes([i % 251]) * (i % 48),
             "subset": "s" if i % 3 else None} for i in range(n)]


def _wire(n: int) -> bytes:
    return encode_change_log(_records(n))


@pytest.fixture
def gate_off():
    was_on = metrics.OBS.on
    metrics.OBS.on = False
    try:
        yield
    finally:
        metrics.OBS.on = was_on


@pytest.fixture
def gate_on():
    was_on = metrics.OBS.on
    tracing.SPANS.clear()
    metrics.enable()
    try:
        yield
    finally:
        metrics.OBS.on = was_on
        tracing.SPANS.clear()


def _ranges(prof, name: str) -> list[tuple[float, float]]:
    return sorted((e.time_range.start, e.time_range.end)
                  for e in prof.events() if e.name == name)


def _feed(dec, wire: bytes, step: int = WRITE) -> list:
    changes = []
    dec.change(lambda c, done: (changes.append(c), done()))
    for at in range(0, len(wire), step):
        dec.write(wire[at:at + step])
    dec.end()
    assert dec.finished and not dec.destroyed
    return changes


@pytest.mark.parametrize("rows", [100, 5000, 20000])
def test_one_change_run_range_a_run_of_the_c_loop(rows, gate_off):
    wire = _wire(rows)
    got = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        dec = protocol.decode(backend="cuda", device="cpu",
                              pipeline=DigestPipeline(device="cpu"))
        dec.on_digest(lambda kind, seq, d: got.append((kind, seq, d)))
        changes = _feed(dec, wire)
    runs = dec.change_runs
    # a run a write of complete frames, never a run a row
    assert 1 <= runs <= -(-len(wire) // WRITE) < rows
    assert len(_ranges(prof, "decoder.change_run")) == runs
    assert len(_ranges(prof, "digest.submit")) == runs
    assert [(c.subset, c.key, c.change, c.from_, c.to, c.value)
            for c in changes] == [(r["subset"] or "", r["key"], r["change"],
                                   r["from"], r["to"], r["value"])
                                  for r in _records(rows)]
    payloads = [protocol.encode_change(r) for r in _records(rows)]
    assert got == [("change", i, hashlib.blake2b(p, digest_size=32).digest())
                   for i, p in enumerate(payloads)]


def test_a_batch_the_submits_fill_dispatches_inside_their_range(gate_off):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        dec = protocol.decode(backend="cuda", device="cpu",
                              pipeline=DigestPipeline(device="cpu",
                                                      max_batch=256))
        dec.on_digest(lambda kind, seq, d: None)
        _feed(dec, _wire(5000))
    submits = _ranges(prof, "digest.submit")
    inside = [(s, t) for s, t in _ranges(prof, "digest.dispatch")
              if any(a <= s and t <= b for a, b in submits)]
    # 5,000 rows in batches of 256: 19 full batches; the 20th, short,
    # dispatches at the finalize flush, outside every submit
    assert len(inside) == 5000 // 256
    assert len(_ranges(prof, "digest.dispatch")) == -(-5000 // 256)
    runs = _ranges(prof, "decoder.change_run")
    assert not any(a <= s and t <= b for s, t in submits for a, b in runs)


def test_no_submit_range_without_a_digest_subscriber(gate_off):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        dec = protocol.decode(backend="cuda", device="cpu")
        _feed(dec, _wire(3000))
    assert dec.change_runs >= 1
    assert len(_ranges(prof, "decoder.change_run")) == dec.change_runs
    assert _ranges(prof, "digest.submit") == []


@pytest.mark.parametrize("native,step,runs", [
    (True, WRITE, None), (True, 1000, 0), (False, WRITE, 0)],
    ids=["bulk", "small-writes", "plain"])
def test_the_host_decoder_counts_its_runs(native, step, runs, gate_off):
    wire = _wire(4000)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        dec = Decoder(native=native)
        changes = _feed(dec, wire, step)
    assert len(changes) == 4000
    want = -(-len(wire) // step) if runs is None else runs
    assert dec.change_runs == want
    assert len(_ranges(prof, "decoder.change_run")) == want


def test_spans_off_the_profiler_are_the_shared_null_span(gate_off):
    assert trace.span("decoder.change_run") is trace._NULL
    assert trace.span("digest.submit") is trace._NULL


def test_the_gate_records_the_runs_in_the_obs_ring(gate_on):
    dec = protocol.decode(backend="cuda", device="cpu")
    dec.on_digest(lambda kind, seq, d: None)
    _feed(dec, _wire(5000))
    runs = tracing.SPANS.spans("decoder.change_run")
    assert len(runs) == dec.change_runs
    assert len(tracing.SPANS.spans("digest.submit")) == dec.change_runs
    assert all(r["fields"] == {"src": "torch"} for r in runs)
