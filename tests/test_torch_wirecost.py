"""The port's wire cost ledger against the JAX package's.

The same submissions go through each package's encoder (tx) and the
encoder's bytes through that package's decoder (rx), with the pump's
transport notes on both sides: per-record changes, negotiated
``ChangeBatch`` frames, a mix of both with blobs (one corked behind
another), and reconcile and snapshot frames.  Both ledgers must hold the same
per-class payload, framing and frame counts in each direction, the same
batch savings, and an unattributed residual of exactly 0; the exported
``wire.cost.*`` entries must be the same.  With the gate off the port's
ledger stays empty, and a protocol error counts one failure on the rx
link in both.
"""

import numpy as np
import pytest

from dat_replication_protocol_tpu.obs import wirecost as jax_wirecost
from dat_replication_protocol_tpu.session import pump as jax_pump
from dat_replication_protocol_tpu.session.decoder import Decoder as JaxDecoder
from dat_replication_protocol_tpu.session.encoder import (
    BatchPolicy as JaxBatchPolicy)
from dat_replication_protocol_tpu.session.encoder import Encoder as JaxEncoder
from dat_replication_protocol_tpu_torch.obs import metrics, wirecost
from dat_replication_protocol_tpu_torch.session import pump
from dat_replication_protocol_tpu_torch.session.decoder import Decoder
from dat_replication_protocol_tpu_torch.session.encoder import (
    BatchPolicy, Encoder)
from dat_replication_protocol_tpu_torch.wire import reconcile_codec as rc
from dat_replication_protocol_tpu_torch.wire import snapshot_codec as sn
from dat_replication_protocol_tpu_torch.wire.framing import (
    CAP_CHANGE_BATCH, CAP_RECONCILE, CAP_SNAPSHOT)

ALL = CAP_CHANGE_BATCH | CAP_RECONCILE | CAP_SNAPSHOT


@pytest.fixture
def port_obs():
    was_on = metrics.OBS.on
    metrics.REGISTRY.reset()
    wirecost.WIRECOST.reset_for_tests()
    metrics.enable()
    try:
        yield metrics
    finally:
        metrics.OBS.on = was_on
        metrics.REGISTRY.reset()
        wirecost.WIRECOST.reset_for_tests()


def _rec(rng, i):
    return {"key": f"k{i:04d}", "change": int(rng.integers(0, 1 << 20)),
            "from": i, "to": i + 1,
            "value": rng.integers(0, 256, int(rng.integers(0, 90)),
                                  dtype=np.uint8).tobytes(),
            "subset": None if i % 3 else f"sub{i % 5}"}


def _control_payloads():
    rng = np.random.default_rng(7)
    cells = rng.integers(0, 1 << 32, (3, 11), dtype=np.uint64).astype(
        np.uint32)
    wcells = rng.integers(0, 1 << 32, (2, 12), dtype=np.uint64).astype(
        np.uint32)
    return ([rc.encode_begin(1000), rc.encode_symbols(0, cells),
             rc.encode_more(3)],
            [sn.encode_want_all(), sn.encode_symbols(0, wcells),
             sn.encode_chunks([(bytes(32), b"abc" * 500)]),
             sn.encode_done(2, np.arange(5))])


def _script(enc, name: str, seed: int = 3) -> None:
    """One scenario's submissions, the same on either package's encoder."""
    rng = np.random.default_rng(seed)
    recs = [_rec(rng, i) for i in range(300)]
    if name == "per-record":
        for r in recs[:40]:
            enc.change(r)
        enc.change_many(recs[40:300])
    elif name == "batch":
        enc.change_many(recs[:250])
        enc.change(recs[250])
        enc.change_many(recs[251:])
    elif name == "mixed":
        enc.change_many(recs[:30])
        a = enc.blob(3000)
        a.write(rng.integers(0, 256, 1000, dtype=np.uint8).tobytes())
        b = enc.blob(40)  # corked behind a
        enc.change(recs[30])
        a.end(rng.integers(0, 256, 2000, dtype=np.uint8).tobytes())
        b.end(b"z" * 40)
        big = enc.blob(70000)
        big.end(bytes(70000))
        enc.negotiate(CAP_CHANGE_BATCH)  # per-record frames, then batches
        enc.change_many(recs[31:120])
    elif name in ("reconcile", "snapshot"):
        rcs, sns = _control_payloads()
        enc.change(recs[0])
        for p in (rcs if name == "reconcile" else sns):
            enc.change_many(recs[1:20])
            if name == "reconcile":
                enc.reconcile_frame(p)
            else:
                enc.snapshot_frame(p)
    enc.finalize()


SCENARIOS = {"per-record": 0, "batch": CAP_CHANGE_BATCH,
             "mixed": 0, "reconcile": ALL, "snapshot": ALL}


def _session(encoder, decoder, pump_mod, name: str) -> bytes:
    caps = SCENARIOS[name]
    enc = encoder(peer_caps=caps, batch_policy=(
        (JaxBatchPolicy if encoder is JaxEncoder else BatchPolicy)(
            max_rows=64)))
    _script(enc, name)
    dec = decoder()
    wire = bytearray()
    while True:
        chunk = enc.read(4093)
        if chunk is None:
            break
        if chunk:
            if pump_mod._OBS.on:  # a sender's note, behind the gate
                pump_mod._lit_tx(enc, len(chunk))
            wire += chunk
    read = pump_mod._metered_reader(dec, _reader(bytes(wire)))
    while True:
        data = read(1021)
        if not data:
            break
        dec.write(data)
    dec.end()
    assert dec.finished
    return bytes(wire)


def _reader(wire: bytes):
    pos = [0]

    def read(n):
        out = wire[pos[0]:pos[0] + n]
        pos[0] += len(out)
        return out
    return read


def _ledger(snap):
    return {link: {k: v for k, v in rec.items() if k != "age_s"}
            for link, rec in snap["links"].items()}


def _cost_entries(snap):
    return {section: {k: v for k, v in snap[section].items()
                      if k.startswith("wire.cost.")}
            for section in ("counters", "gauges")}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_ledgers_tile_the_wire_as_the_jax_ledger(name, obs_enabled,
                                                  port_obs, monkeypatch):
    monkeypatch.setenv("DAT_NATIVE_DISABLE", "1")
    jwire = _session(JaxEncoder, JaxDecoder, jax_pump, name)
    want = _ledger(jax_wirecost.WIRECOST.snapshot())
    want_entries = _cost_entries(obs_enabled.REGISTRY.snapshot())
    pwire = _session(Encoder, Decoder, pump, name)
    got = _ledger(wirecost.WIRECOST.snapshot())
    got_entries = _cost_entries(port_obs.REGISTRY.snapshot())
    assert pwire == jwire
    assert got == want
    assert got_entries == want_entries
    for d in ("tx", "rx"):
        rec = got[f"session|{d}"]
        assert rec["residual_bytes"] == 0
        assert rec["ledger_bytes"] == rec["transport_bytes"] == len(pwire)
        assert rec["failures"] == 0
    assert got["session|tx"]["classes"] == got["session|rx"]["classes"]
    classes = set(got["session|tx"]["classes"])
    assert {"per-record": {"change"}, "batch": {"change_batch"},
            "mixed": {"change_batch", "change", "blob"},
            "reconcile": {"change_batch", "reconcile"},
            "snapshot": {"change_batch", "snapshot"}}[name] == classes
    # both ends price a batch's savings with the same arithmetic
    assert got["session|tx"]["batch_saved_bytes"] == \
        got["session|rx"]["batch_saved_bytes"]
    if name == "batch":
        assert got["session|tx"]["batch_saved_bytes"] > 0


def test_the_dark_gate_leaves_the_ledger_empty():
    wirecost.WIRECOST.reset_for_tests()
    was_on = metrics.OBS.on
    metrics.disable()
    try:
        _session(Encoder, Decoder, pump, "mixed")
    finally:
        metrics.OBS.on = was_on
    assert wirecost.WIRECOST.snapshot()["links"] == {}


def test_a_protocol_error_counts_one_failure(obs_enabled, port_obs,
                                             monkeypatch):
    monkeypatch.setenv("DAT_NATIVE_DISABLE", "1")
    got = []
    for dec, board in ((JaxDecoder(), jax_wirecost.WIRECOST),
                       (Decoder(), wirecost.WIRECOST)):
        dec.on_error(lambda e: None)
        dec.write(bytes([0x02, 0x01, 0x0C]))
        rec = board.snapshot()["links"]["session|rx"]
        got.append((rec["failures"], rec["error"], rec["residual_bytes"]))
    assert got[0] == got[1]
    assert got[1][0] == 1 and got[1][2] is None  # no transport: unknown


def test_cost_link_names_the_link(port_obs):
    enc = Encoder()
    enc.cost_link = "c1:10.0.0.1:5000"
    enc.change({"key": "k", "change": 1, "from": 0, "to": 1})
    links = wirecost.WIRECOST.snapshot()["links"]
    assert list(links) == ["c1:10.0.0.1:5000|tx"]
    snap = port_obs.REGISTRY.snapshot()
    assert snap["counters"][
        "wire.cost.frames{link=c1:10.0.0.1:5000,dir=tx,class=change}"] == 1
    with pytest.raises(ValueError, match="unknown wire cost class"):
        wirecost.account("gossip", "x", "tx", 1, 1)
    with pytest.raises(ValueError, match="direction"):
        wirecost.account("change", "x", "up", 1, 1)


def test_amplification_and_denominators_as_the_jax_board(obs_enabled,
                                                          port_obs):
    got = []
    for mod in (jax_wirecost, wirecost):
        mod.note_source("fan", 1000)
        mod.note_delivered("fan", "p1", 1000)
        mod.note_delivered("fan", "p2", 500)
        mod.account("reconcile", "r", "tx", 300, 20)
        mod.note_diff("r", "tx", 64)
        mod.account("snapshot", "s", "rx", 4000, 40)
        mod.note_dataset("s", "rx", 8000)
        mod.note_transport("s", "rx", 4100)
        snap = mod.WIRECOST.snapshot()
        got.append((snap["amplification"], _ledger(snap)))
    assert got[0] == got[1]
    amp, ledger = got[1]
    assert amp["fan"]["amplification"] == 1.5
    assert ledger["r|tx"]["reconcile_wire_per_diff_byte"] == 320 / 64
    assert ledger["s|rx"]["snapshot_cold_ratio"] == 4040 / 8000
    assert ledger["s|rx"]["residual_bytes"] == 60
