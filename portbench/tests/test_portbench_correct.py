"""``correct`` decides: a sound run of each cell passes; each control,
and each fault planted under the timed path, fails it.  The runs skip
the look for a card and drive the rest of a run on the CPU, at sizes a
test run holds (the port's plain versions stand for its kernels)."""

import types

import numpy as np
import pytest
import torch

from portbench import catalog
from portbench.reference import merkle

CPU = torch.device("cpu")
SMALL = {
    # more than two batches of 1,024 a session, as in the cell
    "blob-feed.stream10k": {"blobs": 2100, "blob_bytes": 256},
    "content-import.blob3g": {"count": 2, "min_bytes": 3 << 20,
                               "max_bytes": 3 << 20},
}
# the blob-feed wire with change records, for the changes' check
WITH_CHANGES = {"changes_per_blob": 3, "value_bytes": [40, 200]}


@pytest.fixture(autouse=True)
def _slabbed_route(monkeypatch):
    """The content-import cell's blobs lie above RESIDENCY_CAP; at the
    tests' sizes a cap of 1 MiB sends them down the same slabbed route."""
    from dat_replication_protocol_tpu_torch.ops import fused_cdc_hash

    monkeypatch.setattr(fused_cdc_hash, "RESIDENCY_CAP", 1 << 20)


def run_cell(cell, system=None, seed=2**31 + 99, params=None,
             limits=None):
    import sys

    sys.path.insert(0, str(catalog.HERE))
    import run

    return run.run_cell(cell, seed, 0.01, False, CPU, system=system,
                        params={**SMALL[cell], **(params or {})},
                        limits=limits)


# -- blob-feed: faults under the digest pipeline's hash engine -----------


def _faulty_engine(fault):
    def system(state):
        from dat_replication_protocol_tpu_torch.backend.cuda_backend import (
            CudaDecoder, DigestPipeline)
        from dat_replication_protocol_tpu_torch.ops.blake2b import (
            blake2b_batch_begin)

        last = []

        def begin(payloads):
            collect = blake2b_batch_begin(payloads, device=state.device)

            def faulty():
                got = [bytes(d) for d in collect()]
                out = list(got)
                if fault == "unchanged":  # the previous batch's digests
                    if last:
                        out = (last[0] * (len(got) // len(last[0]) + 1)
                               )[:len(got)]
                    last[:] = [got]
                elif fault == "half":  # half the batch left out
                    keep = out[:max(1, len(out) // 2)]
                    out = (keep * 2)[:len(out)]
                elif fault == "altered":  # one digest altered
                    out[-1] = bytes([out[-1][0] ^ 1]) + out[-1][1:]
                return out

            return faulty

        pipe = DigestPipeline(hash_begin=begin, device=state.device)
        return CudaDecoder(pipeline=pipe, device=state.device)

    return system


# -- content-import: faults where the summary is produced ----------------


def _faulty_address(fault):
    def system(state):
        from dat_replication_protocol_tpu_torch import content_address

        last = []

        def address(data):
            s = content_address(data, device=state.device)
            out = types.SimpleNamespace(length=s.length, cuts=list(s.cuts),
                                        digests=s.digests.copy(),
                                        root=s.root)
            if fault == "unchanged":  # the previous call's answer
                prev = last[0] if last else out
                last[:] = [out]
                return prev
            if fault == "half":  # half the chunks left out of the root
                n = max(1, len(out.digests) // 2)
                out.digests = out.digests[:n]
                out.root = merkle.root([d.tobytes() for d in out.digests])
            elif fault == "altered":  # one chunk digest altered
                out.digests[0, 0] ^= 1
            return out

        return address

    return system


FAULTS = ("unchanged", "half", "altered")


@pytest.mark.parametrize("cell", list(SMALL))
def test_a_sound_run_is_correct(cell):
    result, checks = run_cell(cell)
    assert result["correct"], checks
    assert not any(checks.values())
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("fault", FAULTS)
def test_blob_feed_faults_are_not_correct(fault):
    result, checks = run_cell("blob-feed.stream10k", _faulty_engine(fault))
    assert not result["correct"]
    assert checks["wrong_digests"] > 0


@pytest.mark.parametrize("fault", FAULTS)
def test_content_import_faults_are_not_correct(fault):
    result, checks = run_cell("content-import.blob3g",
                              _faulty_address(fault))
    assert not result["correct"]
    assert checks["wrong_digests"] > 0


def test_blob_feed_control_is_not_correct():
    from portbench.controls.blob_feed import SYSTEMS

    result, checks = run_cell("blob-feed.stream10k", SYSTEMS["late-finalize"])
    assert not result["correct"]
    assert checks["after_finalize"] > 0
    assert checks["wrong_digests"] == checks["out_of_order"] == 0


def test_content_import_control_is_not_correct():
    from portbench.controls.content_import import SYSTEMS

    result, checks = run_cell("content-import.blob3g",
                              SYSTEMS["unthinned"])
    assert not result["correct"]
    assert checks["wrong_cuts"] > 0 and checks["wrong_roots"] > 0


def _changes_fault(fault):
    """The port's decoder with its decoded changes altered or one left
    out where they are handed to the application."""
    def system(state):
        import dataclasses

        import dat_replication_protocol_tpu_torch as protocol

        dec = protocol.decode(backend="cuda", device=state.device)
        register = dec.change

        def change(handler):
            seen = []

            def faulty(c, done):
                seen.append(c)
                if len(seen) == 2:
                    if fault == "dropped":
                        return done()
                    c = dataclasses.replace(c, value=b"x" + c.value[1:])
                return handler(c, done)

            return register(faulty)

        dec.change = change
        return dec

    return system


def test_decoded_changes_are_checked_where_the_wire_has_them():
    cell = "blob-feed.stream10k"
    result, checks = run_cell(cell, params=WITH_CHANGES,
                              limits={"wrong_changes": 0})
    assert result["correct"], checks
    assert checks["wrong_changes"] == 0
    _, plain = run_cell(cell)
    assert "wrong_changes" not in plain  # no changes on the wire


@pytest.mark.parametrize("fault", ("altered", "dropped"))
def test_changes_faults_are_not_correct(fault):
    result, checks = run_cell("blob-feed.stream10k", _changes_fault(fault),
                              params=WITH_CHANGES,
                              limits={"wrong_changes": 0})
    assert not result["correct"]
    assert checks["wrong_changes"] > 0
    assert checks["wrong_digests"] == 0


def test_a_failed_session_is_not_correct():
    def broken(state):
        from dat_replication_protocol_tpu_torch.backend.cuda_backend import (
            CudaDecoder, DigestPipeline)

        def begin(payloads):
            raise RuntimeError("engine down")

        return CudaDecoder(pipeline=DigestPipeline(hash_begin=begin,
                                                   device=state.device),
                           device=state.device)

    with pytest.raises(RuntimeError):
        run_cell("blob-feed.stream10k", broken)  # the warm-up pass fails


def test_digests_compare_per_kind_in_seq_order():
    from portbench.drivers import blob_feed

    # the change records themselves are not checked here
    state = types.SimpleNamespace(expected=3,
                                  wire=types.SimpleNamespace(n_changes=0))
    ref = {"change": [b"a", b"b"], "blob": [b"c"]}
    good = blob_feed.Session(
        delivered=[("change", 0, b"a", 0.0), ("change", 1, b"b", 0.0),
                   ("blob", 0, b"c", 0.0)], changes=[], writes=[0.0],
        at_finalize=3, finished=True, error=None, dispatches=1, seconds=1.0,
        cpu_s=1.0)
    swapped = blob_feed.Session(
        delivered=[("change", 1, b"b", 0.0), ("change", 0, b"a", 0.0),
                   ("blob", 0, b"c", 0.0)], changes=[], writes=[0.0],
        at_finalize=2, finished=True, error=None, dispatches=1, seconds=1.0,
        cpu_s=1.0)
    assert blob_feed.check(state, {"sessions": [good]}, ref) == {
        "failed_sessions": 0, "wrong_digests": 0, "out_of_order": 0,
        "after_finalize": 0}
    assert blob_feed.check(state, {"sessions": [swapped]}, ref) == {
        "failed_sessions": 0, "wrong_digests": 0, "out_of_order": 2,
        "after_finalize": 1}


def test_change_records_compare_in_place():
    from portbench.drivers import blob_feed
    from portbench.gen import wire as wire_gen

    w = wire_gen.make_session({"blobs": 2, "blob_bytes": 64,
                               "changes_per_blob": 2,
                               "value_bytes": [40, 200]}, seed=4)
    want = [w.change_record(i) for i in range(w.n_changes)]
    got = [types.SimpleNamespace(key=k, change=c, from_=f, to=t, value=v)
           for k, c, f, t, v in want]
    assert blob_feed.wrong_changes(got, want) == 0
    assert blob_feed.wrong_changes(got[1:], want) == 4  # shifted by one
    assert blob_feed.wrong_changes(got + got[:1], want) == 1
    got[2].to = 2
    assert blob_feed.wrong_changes(got, want) == 1


def test_content_checks_count_cut_and_digest_differences():
    from portbench.drivers import content_import

    f = np.zeros(100, np.uint8)
    state = types.SimpleNamespace(files=[f])
    d = np.arange(3 * 32, dtype=np.uint8).reshape(3, 32)
    ref = [([30, 60, 100], d, b"r")]
    out = types.SimpleNamespace(length=100, cuts=[30, 61, 100],
                                digests=d.copy(), root=b"x")
    got = content_import.check(state, {"calls": [(0, out, None)]}, ref)
    assert got == {"failed_calls": 0, "wrong_cuts": 2, "wrong_digests": 2,
                   "wrong_roots": 1}
