"""Exponential backoff with full jitter, and the retry wrapper.

A trimmed copy of ``dat_replication_protocol_tpu/session/reconnect.py``:
:class:`BackoffPolicy` and :func:`retrying`, which the sidecar's TCP
listener binds and accepts through.  The resumable receive driver
(``run_resumable``) is not carried.

Attempt ``k`` (1-based) sleeps ``uniform(0, min(cap, base * 2**k))``,
the "full jitter" variant that keeps many peers losing one link from
reconnecting in step.  Attempts are bounded: past ``max_retries`` faults
the wrapper gives up with ONE structured
:class:`~..wire.framing.ProtocolError` wrapping the last cause.
"""

from __future__ import annotations

import random
import time
from typing import Callable, Optional

from ..obs.events import emit as _emit
from ..obs.flight import FLIGHT as _FLIGHT
from ..obs.metrics import OBS as _OBS
from ..obs.metrics import counter as _counter
from ..obs.metrics import histogram as _histogram
from ..wire.framing import ProtocolError

__all__ = ["BackoffPolicy", "retrying"]

_M_BACKOFFS = _counter("reconnect.backoffs")
_H_BACKOFF = _histogram("reconnect.backoff.seconds")


class BackoffPolicy:
    """Exponential backoff with full jitter, bounded attempts.

    ``seed`` pins the jitter for reproducible tests; ``sleep`` is
    injectable for the same reason.  ``max_retries`` counts *faults
    absorbed*: the first failure is retried while ``faults <=
    max_retries``, so ``max_retries=0`` means fail on the first fault.
    """

    def __init__(self, base: float = 0.05, cap: float = 5.0,
                 max_retries: int = 5, seed: Optional[int] = None,
                 sleep: Callable[[float], None] = time.sleep):
        if base < 0 or cap < 0:
            raise ValueError("backoff base/cap must be >= 0")
        self.base = base
        self.cap = cap
        self.max_retries = max_retries
        self._rng = random.Random(seed)
        self._sleep = sleep

    def delay(self, attempt: int) -> float:
        """Full-jitter delay before retry ``attempt`` (1-based)."""
        ceiling = min(self.cap, self.base * (2 ** max(0, attempt)))
        return self._rng.uniform(0.0, ceiling)

    def sleep_before(self, attempt: int) -> float:
        d = self.delay(attempt)
        if _OBS.on:
            # every backoff in the stack sleeps here
            _M_BACKOFFS.inc()
            _H_BACKOFF.observe(d)
            _emit("reconnect.backoff", attempt=attempt, seconds=d)
        if d > 0:
            self._sleep(d)
        return d


def retrying(fn: Callable[[], object], policy: BackoffPolicy,
             retry_on: tuple = (OSError,), describe: str = "operation"):
    """Run ``fn`` with the policy's backoff until it returns or the
    attempts are exhausted; the terminal failure is one structured
    ProtocolError wrapping the last cause."""
    failures = 0
    while True:
        try:
            return fn()
        except retry_on as e:
            failures += 1
            if failures > policy.max_retries:
                err = ProtocolError(
                    f"{describe} failed after {failures} attempt(s)",
                    cause=e,
                )
                if _FLIGHT.armed:  # retry exhaustion is a post-mortem
                    _FLIGHT.dump("retry-exhausted", error=err)
                raise err from e
            policy.sleep_before(failures)
