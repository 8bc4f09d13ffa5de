"""The port's perf-budget gate (``obs/perf.py``) against the JAX package's.

The cases of ``test_obs_device.py``'s perf-check section (the checked-in
snapshot within budget, a doctored regression, the lower-is-better
direction, the reduced-config ratio, malformed ratios), each on both
packages with equal rows; then seeded budgets and artifacts, made with
numpy, through ``check_snapshot``, ``run_check``, ``_parse_snapshot`` and
``find_first_failure`` of each: rows, printed reports and exit codes
equal.  The port's ``perf-check`` needs ``--budgets``: without it, it
exits 2 and says so.
"""

import copy
import io
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from dat_replication_protocol_tpu.obs import perf as jperf
from dat_replication_protocol_tpu.obs.__main__ import main as jmain
from dat_replication_protocol_tpu_torch.obs import perf
from dat_replication_protocol_tpu_torch.obs.__main__ import main as pmain

REPO = Path(__file__).resolve().parent.parent
BUDGETS = REPO / "artifacts" / "perf_budgets.json"
SNAPSHOT = REPO / "artifacts" / "perf_snapshot_host.json"


def _both_rows(snap, budgets, **kw):
    want = jperf.check_snapshot(copy.deepcopy(snap), copy.deepcopy(budgets),
                                **kw)
    got = perf.check_snapshot(copy.deepcopy(snap), copy.deepcopy(budgets),
                              **kw)
    assert got == want
    return got


@pytest.mark.parametrize("host_only", [True, False])
def test_checked_in_snapshot_rows_equal(host_only):
    budgets = perf.load_budgets(str(BUDGETS))
    assert budgets == jperf.load_budgets(str(BUDGETS))
    snap = json.loads(SNAPSHOT.read_text())
    rows = _both_rows(snap, budgets, host_only=host_only)
    if host_only:
        assert not [r for r in rows if r["status"] == "fail"]
        assert sum(r["status"] == "ok" for r in rows) >= 4


def test_doctored_regression_is_the_same_first_failure():
    budgets = perf.load_budgets(str(BUDGETS))
    snap = json.loads(SNAPSHOT.read_text())
    snap["configs"]["replay"]["value"] /= 1000.0
    rows = _both_rows(snap, budgets, host_only=True)
    bad = perf.find_first_failure(rows)
    assert bad == jperf.find_first_failure(rows)
    assert bad is not None and bad["config"] == "replay"


def test_lower_is_better_and_reduced_ratio():
    lower = {"configs": {"resume": {"group": "host", "checks": [
        {"field": "value", "direction": "lower",
         "reference": 0.5, "ratio": 0.05}]}}}
    for value, fails in ((0.2, False), (50.0, True)):
        rows = _both_rows({"configs": {"resume": {"value": value}}}, lower)
        assert (perf.find_first_failure(rows) is not None) == fails
    loose = {"configs": {"hash": {"checks": [
        {"field": "value", "direction": "higher",
         "reference": 100.0, "ratio": 0.5, "reduced_ratio": 0.01}]}}}
    for reduced, fails in ((False, True), (True, False)):
        res = {"value": 10.0}
        if reduced:
            res["reduced_config"] = True
        rows = _both_rows({"configs": {"hash": res}}, loose)
        assert (perf.find_first_failure(rows) is not None) == fails


@pytest.mark.parametrize("bad", [0, -1, "x", None])
def test_malformed_ratio_is_a_failing_row(bad):
    budgets = {"configs": {"c": {"checks": [
        {"field": "value", "reference": 1.0, "ratio": 0.5,
         "reduced_ratio": bad}]}}}
    rows = _both_rows({"configs": {"c": {"value": 1.0,
                                         "reduced_config": True}}}, budgets)
    assert rows[0]["status"] == "fail"
    assert "malformed" in rows[0]["detail"]


def _seeded(seed: int):
    """Budgets and an artifact from ``seed``: every row kind (ok, fail,
    skip, optional, errored, absent, no checks, non-numeric field)."""
    rng = np.random.default_rng(seed)
    budgets: dict = {"configs": {}}
    configs: dict = {}
    for i in range(int(rng.integers(3, 9))):
        name = f"cfg{i}"
        checks = []
        for j in range(int(rng.integers(0, 4))):
            ref = float(rng.uniform(0.1, 1000.0))
            checks.append({"field": f"f{j}",
                           "direction": ("higher", "lower")[rng.integers(2)],
                           "reference": ref,
                           "ratio": float(rng.choice([0.05, 0.5, 1.0])),
                           **({"reduced_ratio": 0.01}
                              if rng.integers(2) else {})})
        entry = {"group": ("host", "device")[rng.integers(2)],
                 "checks": checks}
        if rng.integers(4) == 0:
            entry["optional"] = True
        budgets["configs"][name] = entry
        kind = int(rng.integers(6))
        if kind == 0:
            continue  # absent
        if kind == 1:
            configs[name] = {"error": "boom"}
            continue
        res = {f"f{j}": float(rng.uniform(0.0, 2000.0))
               for j in range(len(checks))}
        if kind == 2 and checks:
            res["f0"] = "n/a"
        if rng.integers(2):
            res["reduced_config"] = True
        configs[name] = res
    return budgets, {"configs": configs, "seed": seed}


@pytest.mark.parametrize("seed", range(8))
def test_seeded_budgets_rows_and_reports_equal(seed, tmp_path):
    budgets, snap = _seeded(seed)
    for host_only in (False, True):
        _both_rows(snap, budgets, host_only=host_only)
    bpath = tmp_path / "budgets.json"
    bpath.write_text(json.dumps(budgets))
    # the artifact wrapped in log noise and other JSON lines, as a bench
    # script's log holds it
    spath = tmp_path / "bench.log"
    spath.write_text("bench: starting\n" + json.dumps({"stats": 1}) + "\n"
                     + json.dumps(snap) + "\n{torn\n")
    for host_only in (False, True):
        outs = []
        for mod in (jperf, perf):
            buf = io.StringIO()
            rc = mod.run_check(str(spath), str(bpath), host_only=host_only,
                               out=buf)
            outs.append((rc, buf.getvalue()))
        assert outs[0] == outs[1]
        assert outs[1][0] == int("FAIL" in outs[1][1])


def test_parse_snapshot_prefers_configs_then_last_object():
    texts = ['{"configs": {}}', 'x\n{"a": 1}\n{"b": 2}\nnoise',
             '{"a": 1}\n{"configs": {"c": {}}}\n{"b": 2}']
    for text in texts:
        assert perf._parse_snapshot(text, "p") == \
            jperf._parse_snapshot(text, "p")
    for mod in (jperf, perf):
        with pytest.raises(ValueError, match="no parseable bench JSON"):
            mod._parse_snapshot("no json here\n{torn", "p")


def test_load_budgets_refuses_a_file_without_configs(tmp_path):
    path = tmp_path / "b.json"
    path.write_text(json.dumps({"checks": []}))
    for mod in (jperf, perf):
        with pytest.raises(ValueError, match="no 'configs' table"):
            mod.load_budgets(str(path))


def test_perf_check_cli_matches_with_budgets(capsys):
    argv = ["perf-check", str(SNAPSHOT), "--budgets", str(BUDGETS),
            "--host-only"]
    rc_j = jmain(argv)
    out_j = capsys.readouterr().out
    rc_p = pmain(argv)
    out_p = capsys.readouterr().out
    assert (rc_p, out_p) == (rc_j, out_j)
    assert rc_p == 0 and "within budget" in out_p


def test_perf_check_without_budgets_fails_loudly(capsys):
    assert pmain(["perf-check", str(SNAPSHOT)]) == 2
    captured = capsys.readouterr()
    assert "--budgets PATH is required" in captured.err
    assert captured.out == ""
    # the module has no default to fall back on
    assert not hasattr(perf, "DEFAULT_BUDGETS_PATH")


def test_python_m_perf_check_without_budgets_exits_nonzero():
    proc = subprocess.run(
        [sys.executable, "-m", "dat_replication_protocol_tpu_torch.obs",
         "perf-check", str(SNAPSHOT)], cwd=REPO, capture_output=True,
        text=True, timeout=120)
    assert proc.returncode == 2
    assert "--budgets PATH is required" in proc.stderr
