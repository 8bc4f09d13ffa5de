"""Nothing the benchmark runs imports JAX or the JAX package; the
reference, the generators and the work counts import nothing of the
port.  Top-level module names are compared whole: the port's name only
begins with the JAX package's."""

import ast
import subprocess
import sys

import pytest

from portbench import catalog

FORBIDDEN = {"jax", "jaxlib", "flax", "dat_replication_protocol_tpu"}
PORT = "dat_replication_protocol_tpu_torch"
YARDSTICK = ("reference", "gen", "work")


def imported_tops(path):
    tree = ast.parse(path.read_text(), str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", "")
              == "__import__" and node.args
              and isinstance(node.args[0], ast.Constant)):
            out.add(str(node.args[0].value).split(".")[0])
    return out


SOURCES = sorted(p for p in catalog.HERE.rglob("*.py")
                 if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: p.relative_to(catalog.HERE).as_posix())
def test_no_jax_anywhere(path):
    assert not imported_tops(path) & FORBIDDEN


@pytest.mark.parametrize("path", [p for p in SOURCES if p.relative_to(
    catalog.HERE).parts[0] in YARDSTICK],
    ids=lambda p: p.relative_to(catalog.HERE).as_posix())
def test_the_yardstick_imports_nothing_of_the_port(path):
    assert PORT not in imported_tops(path)


def test_whole_names_are_compared():
    assert "dat_replication_protocol_tpu" in FORBIDDEN
    assert PORT.split(".")[0] not in FORBIDDEN
    sys.path.insert(0, str(catalog.HERE))
    import run

    saved = dict(sys.modules)
    try:
        sys.modules["dat_replication_protocol_tpu_torch.x"] = sys
        assert "dat_replication_protocol_tpu" not in run.forbidden_modules()
        sys.modules["dat_replication_protocol_tpu.wire"] = sys
        assert "dat_replication_protocol_tpu" in run.forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_loading_the_yardstick_loads_nothing_of_the_port():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import portbench.reference.cdc, portbench.reference.blob_feed\n"
        "import portbench.reference.merkle, portbench.gen.files\n"
        "import portbench.gen.wire, portbench.work.blake2b\n"
        "import portbench.work.gear, portbench.work.peaks\n"
        "tops = {m.split('.')[0] for m in sys.modules}\n"
        "print(sorted(tops & %r))\n" % (str(catalog.ROOT),
                                         FORBIDDEN | {PORT}))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]"


def test_a_run_loads_no_jax():
    code = (
        "import sys; sys.path.insert(0, %r); sys.path.insert(0, %r)\n"
        "import torch, run\n"
        "run.run_cell('blob-feed.stream10k', 3, 0.01, False,"
        " torch.device('cpu'), params={'blobs': 2, 'blob_bytes': 1024})\n"
        "run.run_cell('content-import.blob3g', 3, 0.01, False,"
        " torch.device('cpu'), params={'count': 1, 'min_bytes': 5000,"
        " 'max_bytes': 6000})\n"
        "print(run.forbidden_modules())\n" % (str(catalog.ROOT),
                                               str(catalog.HERE)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"
