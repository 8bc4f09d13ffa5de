#!/usr/bin/env python3
"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

From the root of a checkout on a machine with the card(s) the cell asks
for.  A run makes the cell's inputs from ``--seed``, warms one pass of
the cell's own shapes (the first run in a checkout also builds the
port's kernels into ``build/torch_kernels/`` and its host libraries into
``build/torch_host/``), measures whole passes for ``--seconds``, then
works the answers out again with the plain reference and compares.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer metrics, read from a
``torch.profiler`` capture of the window), ``device``, with ``--trace
1`` ``breakdown``, and last ``checks``: each number compared, with its
limit.  The same numbers are the last lines of standard error.

Exit codes: 0 with a result; 2 and no result without a CUDA card, with
fewer cards than the cell asks for, without the port in the checkout, or
when JAX or the JAX package was loaded; 1 on any other failure.
``--control NAME`` puts one of the cell's controls (``controls/``) in
the program's place: its result must read ``correct: false``.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import catalog, hostload  # noqa: E402
from portbench.readers import Context  # noqa: E402

PORT = "dat_replication_protocol_tpu_torch"
# top-level module names that may not be loaded by a run, whole names
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "dat_replication_protocol_tpu"})


class Refused(Exception):
    """A run that may print no result: exit 2."""


def log(msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def port_in_checkout() -> None:
    """The port has to be this checkout's own package."""
    try:
        mod = __import__(PORT)
    except ImportError as e:
        raise Refused(f"the port {PORT} is not in this checkout: {e}")
    path = Path(mod.__file__).resolve()
    if ROOT not in path.parents:
        raise Refused(f"{PORT} loads from {path}, outside the checkout "
                      f"{ROOT}")


def the_card(chips: int):
    import torch

    if not torch.cuda.is_available():
        raise Refused("torch.cuda.is_available() is False: no CUDA card")
    if torch.cuda.device_count() < chips:
        raise Refused(f"the cell asks for {chips} cards, "
                      f"torch.cuda.device_count() is "
                      f"{torch.cuda.device_count()}")
    return torch.device("cuda", 0)


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unread ({type(e).__name__})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else (
        f"unread (exit {out.returncode})")


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             system=None, params=None, t_start=None,
             limits=None) -> tuple[dict, dict]:
    """One run of cell ``name`` on ``device``; returns the result line's
    object and the checks.  ``system`` replaces the system under test (a
    control or a planted fault); ``params`` overrides traffic
    parameters and ``limits`` adds or overrides limits (the CPU tests'
    small sizes and other mixes)."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    cell = catalog.load_cell(name)
    if params:
        cell.params = {**cell.params, **params}
    if limits:
        cell.limits = {**cell.limits, **limits}
    drv = cell.driver
    cuda = device.type == "cuda"
    t_setup = time.perf_counter()
    state = drv.setup(cell, seed, device, system)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s} s: start to the driver {t_setup - t_start} s")
    for note in state.notes:
        log(note)

    tr = None
    log(hostload.describe())
    log(f"host speed before the window: {hostload.calibrate()}")
    before = hostload.snapshot()
    if trace:
        from torch.profiler import record_function

        from portbench import trace as tracing

        with tracing.capture() as cap:
            with record_function(tracing.WINDOW_SPAN):
                win = drv.window(state, seconds, span=record_function)
        tr = cap["trace"]
    else:
        win = drv.window(state, seconds)
    if cuda:
        torch.cuda.synchronize()
    log(f"window host load: {hostload.between(before, hostload.snapshot())}")
    log(f"host speed after the window: {hostload.calibrate()}")
    if cuda:
        peak = int(torch.cuda.max_memory_allocated(device))
    else:
        peak = 0
    drv.release(state)
    e2e, notes = drv.end_to_end(state, win)
    for note in notes:
        log(note)
    t_ref = time.perf_counter()
    ref = drv.reference(state)
    t_check = time.perf_counter()
    checks = drv.check(state, win, ref)
    log(f"reference {t_check - t_ref} s, check "
        f"{time.perf_counter() - t_check} s")
    if set(checks) != set(cell.limits):
        raise RuntimeError(f"checks {sorted(checks)} differ from the "
                           f"cell's limits {sorted(cell.limits)}")
    correct = all(checks[k] <= cell.limits[k] for k in checks)

    metrics = {}
    if trace:
        ctx = Context(trace=tr,
                      counters=drv.counters(state, win, ref))
        for m in cell.per_layer:
            value = catalog.load_module("metrics", m["name"]).read(ctx)
            if value is None:
                log(f"per-layer metric {m['name']}: its source did not "
                    f"fire, left out")
            else:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e["setup_s"] = setup_s
        for m in cell.end_to_end:
            if m["name"] not in e2e:
                raise RuntimeError(f"the driver gave no {m['name']}")
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}

    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": peak}
    attempted, failed = drv.attempted(win)
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": dev}
    if tr is not None:
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.device_ops(),
                               "idle_gaps": tr.idle_gaps()}
    result["checks"] = {k: {"value": v, "limit": cell.limits[k]}
                        for k, v in checks.items()}
    return result, checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", default=None)
    args = ap.parse_args(argv)
    try:
        cell = catalog.load_cell(args.workload)
        port_in_checkout()
        t_port = time.perf_counter()
        device = the_card(cell.chips)
        import torch

        log(f"{torch.cuda.get_device_name(device)}, "
            f"torch.cuda.device_count() {torch.cuda.device_count()}; cell "
            f"{cell.name} on {cell.chips} card(s); seed {args.seed}; "
            f"{args.seconds} s; trace {args.trace}; start to the port "
            f"{t_port - T_START} s, to the card "
            f"{time.perf_counter() - T_START} s")
        system = None
        if args.control:
            system = catalog.load_module(
                "controls", cell.driver_name).SYSTEMS[args.control]
            log(f"control {args.control} in the program's place")
        result, checks = run_cell(args.workload, args.seed, args.seconds,
                                  bool(args.trace), device, system,
                                  t_start=T_START)
        log(f"nvidia-smi name, power limit: {power_limit()}")
        found = forbidden_modules()
        if found:
            raise Refused(f"loaded in this process: {', '.join(found)}")
    except Refused as e:
        log(f"no result: {e}")
        return 2
    for k, v in checks.items():
        print(f"check {k} {v} limit {result['checks'][k]['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
