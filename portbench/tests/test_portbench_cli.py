"""The command: no card, no port, and a cell added by files alone."""

import json
import os
import shutil
import subprocess
import sys

from portbench import catalog

CMD = [sys.executable, "portbench/run.py", "--workload", "blob-feed.stream10k",
       "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"]


def _env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


def test_a_run_without_a_card_fails_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        return  # only a host without a card can show it
    out = subprocess.run(CMD, cwd=catalog.ROOT, capture_output=True,
                         text=True, timeout=300, env=_env())
    assert out.returncode == 2
    assert out.stdout == ""
    assert "no result" in out.stderr


def test_a_checkout_of_only_the_benchmark_fails(tmp_path):
    shutil.copytree(catalog.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(catalog.BENCHMARK, tmp_path / "BENCHMARK.json")
    out = subprocess.run(CMD, cwd=tmp_path, capture_output=True, text=True,
                         timeout=300, env=_env())
    assert out.returncode != 0
    assert out.stdout == ""


def test_a_cell_is_added_by_files_and_entries_alone(tmp_path):
    shutil.copytree(catalog.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(catalog.ROOT / "dat_replication_protocol_tpu_torch",
               tmp_path / "dat_replication_protocol_tpu_torch")
    before = {p: p.read_bytes() for p in (tmp_path / "portbench").rglob("*")
              if p.is_file()}
    bench = catalog.load_benchmark()
    bench["workloads"].append({
        "name": "blob-feed.meta1", "config": "blob-feed", "traffic": "meta1",
        "chips": 1, "why": "one change a blob"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "blob-feed.stream10k" in m.get("workloads", []):
            m["workloads"].append("blob-feed.meta1")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = json.loads((catalog.HERE / "cells" / "blob-feed.stream10k.json")
                      .read_text())
    cell.update(traffic="meta1", params={"changes_per_blob": 1,
                                         "value_bytes": [40, 200]})
    cell["limits"]["wrong_changes"] = 0  # a mix with changes checks them
    (tmp_path / "portbench" / "cells" / "blob-feed.meta1.json").write_text(
        json.dumps(cell))
    code = ("import sys, json, torch; sys.path.insert(0, 'portbench')\n"
            "import run\n"
            "r, _ = run.run_cell('blob-feed.meta1', 9, 0.01, False,"
            " torch.device('cpu'), params={'blobs': 3, 'blob_bytes': 1024})\n"
            "print(json.dumps(r))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env=_env(), check=True)
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] and set(r["metrics"]) == {"recv_gibps",
                                                  "verify_p95_ms", "setup_s"}
    for p, data in before.items():
        assert p.read_bytes() == data, p
