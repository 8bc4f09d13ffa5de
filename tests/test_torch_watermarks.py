"""The port's watermark board against the JAX package's.

The same seeded sequences of track, mark, untrack and cursor moves on
both packages' ``WatermarkBoard`` must give the same snapshots (offsets,
marks, lag in bytes, the exactness rule of lag in seconds) and the same
registry gauges; ``link_lag`` is held against the JAX function on
seeded inputs.
"""

import numpy as np
import pytest

from dat_replication_protocol_tpu.obs import watermarks as jwm
from dat_replication_protocol_tpu_torch.obs import watermarks as pwm


def _strip(snap: dict) -> dict:
    # the monotonic stamps differ between two runs; everything else must not
    out = {"links": {}}
    for name, rec in snap["links"].items():
        rec = dict(rec)
        rec["marks"] = [o for o, _t in rec["marks"]]
        if rec.get("lag_seconds") is not None:
            rec["lag_seconds"] = "set"
        out["links"][name] = rec
    return out


def _run(mod, seed):
    rng = np.random.default_rng(seed)
    board = mod.WatermarkBoard()
    cursors = {}
    trace = []
    for step in range(300):
        op = rng.integers(0, 5)
        link = f"l{int(rng.integers(0, 4))}"
        role = ("append", "parsed", "acked", "delivered")[
            int(rng.integers(0, 4))]
        if op == 0:
            cursors[(link, role)] = int(rng.integers(0, 10_000))
            board.track(role, link, lambda k=(link, role): cursors[k])
        elif op == 1:
            board.mark(link, int(rng.integers(0, 10_000)))
        elif op == 2 and rng.integers(0, 6) == 0:
            board.untrack(link)
        elif op == 3 and cursors:
            k = sorted(cursors)[int(rng.integers(0, len(cursors)))]
            cursors[k] += int(rng.integers(0, 500))
        else:
            trace.append(_strip(board.snapshot()))
            trace.append(board._collect())
    trace.append(_strip(board.snapshot()))
    return trace


@pytest.mark.parametrize("seed", range(5))
def test_seeded_sequences_give_the_same_snapshots(seed):
    assert _run(pwm, seed) == _run(jwm, seed)


@pytest.mark.parametrize("seed", range(5))
def test_link_lag_equals_jax(seed):
    rng = np.random.default_rng(100 + seed)
    for _ in range(200):
        offsets = {r: int(rng.integers(0, 1000)) for r in
                   rng.choice(["append", "parsed", "delivered", "acked"],
                              int(rng.integers(0, 4)), replace=False)}
        marks = sorted((int(o), float(t)) for o, t in zip(
            rng.integers(0, 1200, int(rng.integers(0, 6))),
            rng.random(6)))
        now = 2.0
        dropped = int(rng.integers(0, 2))
        assert pwm.link_lag(offsets, marks, now, dropped) \
            == jwm.link_lag(offsets, marks, now, dropped)


def test_labels_are_refused_as_jax_refuses():
    for mod in (pwm, jwm):
        board = mod.WatermarkBoard()
        for bad in ("", "a,b", 'q"', "x\ny", "{}"):
            with pytest.raises(ValueError, match="must be a non-empty"):
                board.track("append", bad, lambda: 0)


def test_a_dying_cursor_goes_missing_and_the_board_survives():
    board = pwm.WatermarkBoard()
    board.track("append", "s", lambda: 10)
    board.track("parsed", "s", lambda: 1 // 0)
    snap = board.snapshot()
    assert snap["links"]["s"]["offsets"] == {"append": 10}
    board.reset_for_tests()
    assert board.snapshot()["links"] == {}
