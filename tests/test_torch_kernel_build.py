"""The kernel build is bounded and fails loudly, with no card and no nvcc.

``ops._build.build`` runs one ``nvcc`` per source under
``BUILD_TIMEOUT_S``; here a fake ``nvcc`` (a shell script) stands in
for the compiler, so the timeout, the failure report and the atomic
rename of the library are driven on the CPU.
"""

import time

import pytest

from dat_replication_protocol_tpu_torch.ops import _build


def _fake_nvcc(tmp_path, body: str):
    script = tmp_path / "nvcc"
    script.write_text("#!/bin/sh\n" + body + "\n")
    script.chmod(0o755)
    return str(script)


@pytest.fixture
def build_dir(tmp_path, monkeypatch):
    out = tmp_path / "build"
    monkeypatch.setattr(_build, "BUILD_DIR", out)
    return out


def test_a_stuck_nvcc_is_killed_and_the_build_raises(tmp_path, build_dir,
                                                     monkeypatch):
    nvcc = _fake_nvcc(tmp_path, "exec sleep 30")
    monkeypatch.setattr(_build, "_nvcc", lambda: nvcc)
    monkeypatch.setattr(_build, "BUILD_TIMEOUT_S", 0.5)
    names = ("merkle_level", "gear_candidates")
    t0 = time.monotonic()
    with pytest.raises(RuntimeError) as err:
        _build.build(names)
    assert time.monotonic() - t0 < 10.0
    for name in names:
        assert f"{name}: nvcc ran past 0.5 s and was killed" in str(err.value)
        assert not _build.library_path(name).exists()
    assert list(build_dir.iterdir()) == []


def test_a_failing_nvcc_raises_with_its_output(tmp_path, build_dir,
                                               monkeypatch):
    nvcc = _fake_nvcc(tmp_path, "echo 'error: bad kernel'; exit 3")
    monkeypatch.setattr(_build, "_nvcc", lambda: nvcc)
    with pytest.raises(RuntimeError, match="merkle_level: nvcc exited 3"
                       "\nerror: bad kernel"):
        _build.build(("merkle_level",))
    assert list(build_dir.iterdir()) == []


def test_a_finished_build_lands_under_the_library_name(tmp_path, build_dir,
                                                       monkeypatch):
    # the fake compiler writes its -o argument, as nvcc does
    nvcc = _fake_nvcc(tmp_path, 'while [ "$1" != "-o" ]; do shift; done\n'
                                'echo lib > "$2"; echo ptxas-report')
    monkeypatch.setattr(_build, "_nvcc", lambda: nvcc)
    report = _build.build(("merkle_level", "gear_first"))
    assert set(report) == {"merkle_level", "gear_first"}
    for name, rep in report.items():
        assert _build.library_path(name).read_text() == "lib\n"
        assert rep["log"] == "ptxas-report\n" and rep["seconds"] >= 0
    # built libraries are not compiled again
    assert _build.build(("merkle_level", "gear_first")) == {}
    assert sorted(p.name for p in build_dir.iterdir()) == sorted(
        _build.library_path(n).name for n in report)


def test_the_build_limit_sits_far_above_a_real_build():
    # all seven sources build together in about 7 s on an H100 host
    assert _build.BUILD_TIMEOUT_S >= 60
