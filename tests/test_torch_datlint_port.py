"""The port's datlint over the port's own package, and over the JAX one.

The counterpart of ``test_datlint_repo_clean.py`` for
``dat_replication_protocol_tpu_torch``: its package carries zero
findings under every rule within the same runtime budget, and its
checked-in certificates under ``artifacts/torch/`` byte-match a fresh
render.  Over the JAX package's tree the port's analyzer must agree
with the JAX package's checked-in run: no findings, the same lock graph
(bar ``generator``), the same certificate entries; over a copy of that
tree with every ``datlint:`` marker disarmed, both analyzers must give
the same, non-empty, findings.  The guarded-by declarations and the
gear constants' parity are shown to bite on doctored copies.

Whole-program passes run once per module (fixtures below).
"""

import io
import json
import os
import re
import shutil
import tokenize
from pathlib import Path

import pytest

import dat_replication_protocol_tpu
import dat_replication_protocol_tpu_torch
from dat_replication_protocol_tpu.analysis import ALL_RULES as REF_RULES
from dat_replication_protocol_tpu_torch.analysis import ALL_RULES
from dat_replication_protocol_tpu_torch.analysis.__main__ import (
    write_event_loop_surface,
    write_lock_graph,
)
from dat_replication_protocol_tpu_torch.analysis.concurrency import (
    GuardedState,
    ProgramIndex,
    ReadinessIndex,
    render_event_loop_surface,
    render_lock_graph,
)
from dat_replication_protocol_tpu_torch.analysis.engine import (
    Project,
    run_project,
)
from dat_replication_protocol_tpu_torch.analysis.rules.wire_constants \
    import WireConstantParity

from datlint_parity import reference_findings, rows

PORT_ROOT = Path(dat_replication_protocol_tpu_torch.__file__).resolve().parent
JAX_ROOT = Path(dat_replication_protocol_tpu.__file__).resolve().parent
REPO_ROOT = PORT_ROOT.parent
PORT_ARTIFACTS = REPO_ROOT / "artifacts" / "torch"
REF_ARTIFACTS = REPO_ROOT / "artifacts"

# the JAX package's budget for its own clean run (DATLINT_BUDGET_S)
_BUDGET_S = float(os.environ.get("DATLINT_BUDGET_S", "45"))

_DECL_RE = re.compile(r"datlint:\s*((?:guarded-by|coupled-state).*)$")
# the JAX package's declarations with no field in the port: the bulk-
# index cursor of its native decoder route (_run_indexed), which the
# port does not have yet
NO_COUNTERPART = {("session/decoder.py", 'coupled-state st["f"], st["row"]')}
# the JAX package's C sources and the engine's C comment shapes
_C_SUFFIXES = (".c", ".cc", ".cpp", ".h", ".hpp")
_C_COMMENT = re.compile(r"//.*$|/\*.*?\*/")


@pytest.fixture(scope="module")
def port_run():
    project = Project.from_paths([PORT_ROOT])
    stats: dict = {}
    findings = run_project(project, ALL_RULES, stats)
    return project, findings, stats


@pytest.fixture(scope="module")
def jax_run():
    project = Project.from_paths([JAX_ROOT])
    return project, run_project(project, ALL_RULES)


def _declarations(project: Project, root: Path) -> set:
    out = set()
    for src in project.py_sources:
        rel = src.path.relative_to(root).as_posix()
        for comment in src.comments.values():
            m = _DECL_RE.search(comment)
            if m:
                out.add((rel, " ".join(m.group(1).split())))
    return out


# -- the port's package ---------------------------------------------------------

def test_port_package_is_datlint_clean_within_budget(port_run):
    _, findings, stats = port_run
    assert findings == [], (
        "datlint findings in the port's package:\n"
        + "\n".join(f.render() for f in findings))
    total = sum(stats.values())
    worst = max(stats.items(), key=lambda kv: kv[1])
    assert total < _BUDGET_S, (
        f"datlint over the port took {total:.1f}s (budget {_BUDGET_S}s); "
        f"heaviest rule: {worst[0]} at {worst[1]:.1f}s")


def test_port_lock_graph_artifact_matches_the_tree(port_run, tmp_path):
    project = port_run[0]
    artifact = PORT_ARTIFACTS / "lock_graph.json"
    fresh = tmp_path / "lock_graph.json"
    write_lock_graph(project, fresh)
    assert fresh.read_bytes() == artifact.read_bytes(), (
        "artifacts/torch/lock_graph.json no longer matches the port's "
        "tree: read the diff, then regenerate with python -m "
        "dat_replication_protocol_tpu_torch.analysis --write-artifacts "
        "artifacts/torch")
    doc = json.loads(artifact.read_text("utf-8"))
    assert doc["locks"]
    assert doc["generator"].startswith(
        "python -m dat_replication_protocol_tpu_torch.analysis")


def test_port_event_loop_surface_artifact_matches_the_tree(port_run,
                                                           tmp_path):
    project = port_run[0]
    artifact = PORT_ARTIFACTS / "event_loop_surface.json"
    fresh = tmp_path / "event_loop_surface.json"
    write_event_loop_surface(project, fresh)
    assert fresh.read_bytes() == artifact.read_bytes(), (
        "artifacts/torch/event_loop_surface.json no longer matches the "
        "port's tree: read the diff, then regenerate with "
        "--write-artifacts artifacts/torch")
    doc = json.loads(artifact.read_text("utf-8"))
    assert doc["missing_entry_points"] == []
    by_entry = {e["entry"]: e for e in doc["entry_points"]}
    for entry in ("hub-dispatch", "fanout-dispatch", "edge-dispatch"):
        e = by_entry[entry]
        assert e["enforced"] and e["certified"], entry
        assert e["classification"] != "unbounded-blocking", entry
    assert by_entry["sidecar-subscriber"]["unbounded"]
    # the kernel build is bounded (nvcc under a timeout), as the JAX
    # package's native build is on its edge loop
    assert any(b["call"] == "subprocess.run(...)"
               and b["site"].startswith("ops/_build.py:")
               for b in by_entry["edge-dispatch"]["bounded"])
    assert not any(u["site"].startswith("ops/_build.py:")
                   for u in by_entry["edge-dispatch"]["unbounded"])


def test_port_registry_has_every_reference_rule():
    assert [r.name for r in ALL_RULES] == [r.name for r in REF_RULES]


def test_port_analyzer_saw_the_protocol_stack_and_the_kernels(port_run):
    names = {s.path.name for s in port_run[0].sources}
    assert {"decoder.py", "framing.py", "change_codec.py", "gear.cuh",
            "blake2b.cu"} <= names
    c_names = {s.path.name for s in port_run[0].c_sources}
    assert {"gear.cuh", "blake2b.cu"} <= c_names


def test_port_carries_the_reference_declarations(port_run, jax_run):
    ref = _declarations(jax_run[0], JAX_ROOT)
    port = _declarations(port_run[0], PORT_ROOT)
    assert ref, "no declarations found in the JAX package: scan broken?"
    missing = sorted(ref - port - NO_COUNTERPART)
    assert missing == [], f"declarations without a port counterpart: " \
                          f"{missing}"
    assert NO_COUNTERPART <= ref


def _strip_markers(text: str, is_python: bool) -> str:
    """``text`` with every comment that holds ``datlint`` emptied (allow
    markers, suppressions and declarations alike)."""
    lines = text.splitlines(keepends=True)
    if is_python:
        for tok in tokenize.generate_tokens(io.StringIO(text).readline):
            if tok.type == tokenize.COMMENT and "datlint" in tok.string:
                row, col = tok.start
                lines[row - 1] = (lines[row - 1][:col] + "#"
                                  + lines[row - 1][tok.end[1]:])
        return "".join(lines)
    return "".join(_C_COMMENT.sub(
        lambda m: "//" if "datlint" in m.group(0) else m.group(0), line)
        for line in lines)


def _copy_tree(src: Path, dst: Path) -> Path:
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns(
        "__pycache__", "_build", "*.so"))
    return dst


def test_guarded_state_fires_when_a_guarded_write_leaves_its_lock(tmp_path):
    root = _copy_tree(PORT_ROOT, tmp_path / "port")
    target = root / "obs" / "wirecost.py"
    text = target.read_text()
    locked = "        with self._lock:\n            self._links.clear()\n"
    assert text.count(locked) == 1
    target.write_text(text.replace(
        locked, "        self._links.clear()\n"
                "        with self._lock:\n            pass\n"))
    findings = run_project(Project.from_paths([root]), [GuardedState()])
    assert [(Path(f.path).name, f.rule) for f in findings] == [
        ("wirecost.py", "guarded-state")], findings
    assert "self._links" in findings[0].message


def test_gear_constants_are_held_to_the_kernel_source(tmp_path):
    for src in (PORT_ROOT / "csrc" / "gear.cuh",
                PORT_ROOT / "ops" / "rabin.py"):
        shutil.copy(src, tmp_path / src.name)
    rule = [WireConstantParity()]
    assert run_project(Project.from_paths([tmp_path]), rule) == []
    cuh = tmp_path / "gear.cuh"
    text = cuh.read_text()
    assert "GEAR_C1 = 0x9E3779B1;" in text
    cuh.write_text(text.replace("GEAR_C1 = 0x9E3779B1;",
                                "GEAR_C1 = 0x9E3779B3;"))
    findings = run_project(Project.from_paths([tmp_path]), rule)
    assert [f.rule for f in findings] == ["wire-constant-parity"]
    assert "GEAR_C1" in findings[0].message


# -- the JAX package's tree -----------------------------------------------------

def test_port_analyzer_is_clean_on_the_jax_package(jax_run):
    findings = jax_run[1]
    assert findings == [], "\n".join(f.render() for f in findings)


def test_port_lock_graph_of_the_jax_package_matches_its_artifact(jax_run):
    doc = render_lock_graph(ProgramIndex.get(jax_run[0]))
    ref = json.loads((REF_ARTIFACTS / "lock_graph.json").read_text("utf-8"))
    assert doc.pop("generator") != ref.pop("generator")
    assert doc == ref


def test_port_surface_of_the_jax_package_matches_its_artifact(jax_run):
    """The port's certifier renders the JAX package's surface as the
    reference's artifact has it, every entry point included (the native
    pumps' specs came back with the port's wire pump)."""
    doc = render_event_loop_surface(ReadinessIndex.get(jax_run[0]))
    ref = json.loads((REF_ARTIFACTS / "event_loop_surface.json")
                     .read_text("utf-8"))
    assert doc["missing_entry_points"] == []
    ref_entries = {e["entry"]: e for e in ref["entry_points"]}
    names = [e["entry"] for e in doc["entry_points"]]
    # every entry, the native pumps' included, as in the reference
    assert set(names) == set(ref_entries)
    for e in doc["entry_points"]:
        assert e == ref_entries[e["entry"]], e["entry"]
    for key in ("levels", "summary", "unbounded_functions"):
        assert doc[key] == ref[key], key


def test_both_analyzers_agree_on_the_jax_package_without_markers(
        tmp_path):
    root = _copy_tree(JAX_ROOT, tmp_path / "pkg")
    stripped = 0
    for path in root.rglob("*"):
        if path.suffix == ".py" or path.suffix in _C_SUFFIXES:
            text = path.read_text(encoding="utf-8", errors="replace")
            if "datlint" in text:
                path.write_text(_strip_markers(text, path.suffix == ".py"),
                                encoding="utf-8")
                stripped += 1
    assert stripped > 20
    port = run_project(Project.from_paths([root]), ALL_RULES)
    ref = reference_findings([root])
    assert port, "no findings without the markers: analyzer went blind?"
    assert rows(port, [root]) == rows(ref, [root])
    assert {"blocking-reachability", "callback-escape",
            "blocking-under-lock"} <= {f.rule for f in port}
