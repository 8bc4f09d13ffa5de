"""The perf-budget gate: one bench artifact against per-metric budgets.

A trimmed copy of ``dat_replication_protocol_tpu/obs/perf.py``; stdlib
only.  It compares one bench artifact (the one-line JSON object a bench
script prints, with a ``configs`` table) against a budget file and
returns verdict rows; ``python -m dat_replication_protocol_tpu_torch.obs
perf-check BENCH.json --budgets PATH`` exits 1 on any regression.

There is no default budget file.  The reference's
``artifacts/perf_budgets.json`` holds budgets for the CPU fallback and
the TPU, none of which is a budget for this port; the port's own come
with its benchmark, and until then ``perf-check`` needs ``--budgets``.

Budget file format::

    {
      "configs": {
        "<config name>": {
          "group": "host" | "device",
          "checks": [
            {"field": "value",          # key in the config's result
             "direction": "higher",     # "higher" = bigger is better
             "reference": 16691.4,
             "ratio": 0.05,             # fail below reference*ratio
             "reduced_ratio": 0.02}     # the bound when the result
          ]                             # says reduced_config: true
        }
      }
    }

* ``direction: "higher"`` fails when ``value < reference * ratio``;
  ``"lower"`` (latencies) fails when ``value > reference / ratio``.
* A result carrying ``reduced_config: true`` is judged against
  ``reduced_ratio`` when the check has one.
* ``host_only`` evaluates only ``group: "host"`` configs.
* A budgeted config missing from the artifact, or carrying an
  ``"error"``, fails (``"optional": true`` on its entry makes that a
  skip): a gate that passes on absent data is not a gate.
"""

from __future__ import annotations

import json
from typing import Optional

__all__ = ["load_budgets", "check_snapshot", "run_check",
           "find_first_failure"]


def load_budgets(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        budgets = json.load(f)
    if "configs" not in budgets or not isinstance(budgets["configs"], dict):
        raise ValueError(f"{path}: budget file has no 'configs' table")
    return budgets


def _check_one(config: str, result: dict, check: dict) -> dict:
    """One check against one config's result: a verdict row
    ``{config, field, status: ok|fail|skip, ...}``."""
    field = check.get("field", "value")
    direction = check.get("direction", "higher")
    reference = check.get("reference")
    ratio = check.get("ratio", 0.1)
    reduced = bool(result.get("reduced_config"))
    if reduced and "reduced_ratio" in check:
        ratio = check["reduced_ratio"]
    if (reference is None or direction not in ("higher", "lower")
            or not isinstance(ratio, (int, float)) or ratio <= 0):
        # a malformed budget entry is a failing row, never a traceback
        return {"config": config, "field": field, "status": "fail",
                "detail": "malformed check (needs reference, a "
                          "higher/lower direction, and a positive ratio)"}
    value = result.get(field)
    if not isinstance(value, (int, float)):
        return {"config": config, "field": field, "status": "fail",
                "value": value,
                "detail": f"field {field!r} missing or non-numeric"}
    if direction == "higher":
        bound = reference * ratio
        ok = value >= bound
        rel = "<" if not ok else ">="
    else:
        bound = reference / ratio
        ok = value <= bound
        rel = ">" if not ok else "<="
    return {
        "config": config, "field": field,
        "status": "ok" if ok else "fail",
        "value": value, "bound": bound, "reference": reference,
        "ratio": ratio, "direction": direction, "reduced": reduced,
        "detail": f"{field}={value:g} {rel} bound {bound:g} "
                  f"(reference {reference:g} x ratio {ratio:g}"
                  f"{', reduced config' if reduced else ''})",
    }


def check_snapshot(snapshot: dict, budgets: dict,
                   host_only: bool = False) -> list[dict]:
    """Every budgeted config against a parsed bench artifact: verdict
    rows; callers gate on ``any(r["status"] == "fail")``."""
    configs = snapshot.get("configs", {})
    rows: list[dict] = []
    for name, entry in budgets["configs"].items():
        group = entry.get("group", "device")
        if host_only and group != "host":
            rows.append({"config": name, "field": "-", "status": "skip",
                         "detail": f"group {group!r} skipped (--host-only)"})
            continue
        result = configs.get(name)
        optional = bool(entry.get("optional"))
        if result is None or "error" in (result or {}):
            status = "skip" if optional else "fail"
            why = ("absent from snapshot" if result is None
                   else f"errored: {result['error']}")
            rows.append({"config": name, "field": "-", "status": status,
                         "detail": f"config {why}"
                                   + (" (optional)" if optional else "")})
            continue
        checks = entry.get("checks")
        if not isinstance(checks, list) or not checks:
            # nothing evaluable would pass vacuously
            rows.append({"config": name, "field": "-", "status": "fail",
                         "detail": "budget entry has no evaluable checks"})
            continue
        for check in checks:
            rows.append(_check_one(name, result, check))
    return rows


def run_check(snapshot_path: str, budgets_path: str,
              host_only: bool = False, out=None) -> int:
    """Load, evaluate, report one line a check to ``out`` (stdout by
    default); returns the exit code (1 on any failure)."""
    import sys

    out = out if out is not None else sys.stdout
    with open(snapshot_path, encoding="utf-8") as f:
        snapshot = _parse_snapshot(f.read(), snapshot_path)
    budgets = load_budgets(budgets_path)
    rows = check_snapshot(snapshot, budgets, host_only=host_only)
    failed = 0
    for r in rows:
        mark = {"ok": "OK  ", "fail": "FAIL", "skip": "skip"}[r["status"]]
        print(f"{mark} {r['config']:<12} {r['detail']}", file=out)
        failed += r["status"] == "fail"
    verdict = "REGRESSION" if failed else "within budget"
    print(f"perf-check: {len(rows)} check(s), {failed} failed — {verdict}",
          file=out)
    return 1 if failed else 0


def _parse_snapshot(text: str, path: str) -> dict:
    """One JSON object, or a log that holds it among other lines: scan
    the lines from the end and take the first object with a ``configs``
    table, else the last object that parses."""
    text = text.strip()
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        fallback = None
        for ln in reversed(text.splitlines()):
            ln = ln.strip()
            if not ln.startswith("{"):
                continue
            try:
                obj = json.loads(ln)
            except json.JSONDecodeError:
                continue
            if isinstance(obj, dict) and "configs" in obj:
                return obj
            if fallback is None:
                fallback = obj
        if fallback is not None:
            return fallback
        raise ValueError(f"{path}: no parseable bench JSON found")


def find_first_failure(rows: list[dict]) -> Optional[dict]:
    for r in rows:
        if r["status"] == "fail":
            return r
    return None
