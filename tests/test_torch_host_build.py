"""The host libraries' build is bounded, keyed and fails loudly.

``runtime.native`` builds ``native/dat_native.cpp`` and
``runtime.fastpath`` builds ``native/dat_fastpath.cpp`` with ``g++`` at
first use, each under ``BUILD_TIMEOUT_S``.  Here a fake ``g++`` (a shell
script first on ``PATH``) stands in for the compiler: one that sleeps is
killed and the build raises naming the source; one that fails raises
with its output, and a caller on the native route gets that error, never
the Python route.  The library name is keyed by the source (and, for
the extension, by ``sys.version``).
"""

import sys
import time

import numpy as np
import pytest

from dat_replication_protocol_tpu_torch import _fastpath_gate
from dat_replication_protocol_tpu_torch.runtime import fastpath, native
from dat_replication_protocol_tpu_torch.runtime import replay
from dat_replication_protocol_tpu_torch.session.decoder import Decoder
from dat_replication_protocol_tpu_torch.wire.change_codec import (
    encode_change,
)

RECORD = {"key": "k", "change": 1, "from": 0, "to": 1}


def _fake_gxx(tmp_path, monkeypatch, body: str):
    bindir = tmp_path / "bin"
    bindir.mkdir()
    script = bindir / "g++"
    script.write_text("#!/bin/sh\n" + body + "\n")
    script.chmod(0o755)
    monkeypatch.setenv("PATH", f"{bindir}:/usr/bin:/bin")


@pytest.fixture
def fresh(tmp_path, monkeypatch):
    """Both libraries unloaded and building into an empty directory."""
    out = tmp_path / "build"
    monkeypatch.setattr(native, "BUILD_DIR", out)
    monkeypatch.setattr(fastpath, "BUILD_DIR", out)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(fastpath, "_mod", None)
    monkeypatch.setattr(_fastpath_gate, "_get", None)
    return out


def test_a_stuck_gxx_is_killed_and_the_build_raises(tmp_path, monkeypatch,
                                                    fresh):
    _fake_gxx(tmp_path, monkeypatch, "exec sleep 30")
    monkeypatch.setattr(native, "BUILD_TIMEOUT_S", 0.5)
    for mod, name in ((native, "dat_native.cpp"),
                      (fastpath, "dat_fastpath.cpp")):
        t0 = time.monotonic()
        with pytest.raises(RuntimeError) as err:
            mod.build()
        assert time.monotonic() - t0 < 10.0
        assert name in str(err.value)
        assert "ran past 0.5 s and was killed" in str(err.value)
        assert not mod.library_path().exists()
    assert list(fresh.iterdir()) == []


def test_a_failed_build_raises_and_never_yields_the_python_route(
        tmp_path, monkeypatch, fresh):
    _fake_gxx(tmp_path, monkeypatch, "echo 'error: no compiler'; exit 4")
    wire = replay.encode_change_log([RECORD] * 400, native=False)
    with pytest.raises(RuntimeError, match="dat_native build of .*"
                       "dat_native.cpp: g\\+\\+ exited 4\nerror: no compiler"):
        native.get_lib()
    with pytest.raises(RuntimeError, match="dat_native.cpp"):
        replay.split_frames(wire)
    with pytest.raises(RuntimeError, match="dat_native.cpp"):
        Decoder().write(wire)
    with pytest.raises(RuntimeError, match="dat_fastpath.cpp"):
        encode_change(RECORD)
    # the Python route is there only when asked for
    assert len(replay.split_frames(wire, native=False)) == 400
    dec = Decoder(native=False)
    dec.write(wire)
    assert dec.changes == 400
    assert list(fresh.iterdir()) == []


def test_without_gxx_the_build_raises_naming_the_source(tmp_path,
                                                       monkeypatch, fresh):
    monkeypatch.setenv("PATH", str(tmp_path / "nowhere"))
    with pytest.raises(RuntimeError, match="g\\+\\+ not found: .*"
                       "dat_native.cpp"):
        native.build()


def test_a_finished_build_lands_under_the_keyed_name(tmp_path, monkeypatch,
                                                     fresh):
    _fake_gxx(tmp_path, monkeypatch,
              'while [ "$1" != "-o" ]; do shift; done\necho lib > "$2"')
    for mod in (native, fastpath):
        report = mod.build()
        assert report["seconds"] >= 0
        assert mod.library_path().read_text() == "lib\n"
        assert mod.build() == {}  # built once
    assert sorted(p.name for p in fresh.iterdir()) == sorted(
        [native.library_path().name, fastpath.library_path().name])


def test_the_cache_keys_on_the_source_and_the_interpreter(tmp_path,
                                                          monkeypatch):
    paths = {m: m.library_path() for m in (native, fastpath)}
    for mod in (native, fastpath):
        edited = tmp_path / mod.SOURCE.name
        edited.write_bytes(mod.SOURCE.read_bytes() + b"\n// edited\n")
        monkeypatch.setattr(mod, "SOURCE", edited)
        assert mod.library_path() != paths[mod]
        monkeypatch.undo()
    monkeypatch.setattr(sys, "version", sys.version + " other")
    assert fastpath.library_path() != paths[fastpath]
    assert native.library_path() == paths[native]


def test_the_build_limit_sits_far_above_a_real_build():
    # dat_native builds in about 2 s, dat_fastpath in about 2.5 s
    assert native.BUILD_TIMEOUT_S >= 60


def test_the_real_libraries_load_from_the_build_directory():
    lib = native.get_lib()
    assert native.library_path().exists()
    assert fastpath.get().__file__ == str(fastpath.library_path())
    assert fastpath.library_path().parent == native.BUILD_DIR
    assert native.BUILD_DIR.parts[-2:] == ("build", "torch_host")
    out = native.greedy_select(np.array([5, 9], np.int64), 20, 4, 8)
    assert out.tolist() == [5, 9, 17, 20] and lib is native.get_lib()
