"""The ``change-log`` controls: the reference in the decoder's place, each
with one guarantee of the configuration broken.

Both stand where ``decode(backend="cuda")`` stands and extend
``blob_feed``'s ``LateFinalizeDecoder``: they read the writes' byte
count against the session's wire table, hash each payload with
``hashlib`` once its last byte has arrived, and deliver digests in
batches of 1,024 with two in flight.  They also hand each change, as
the plain reference decodes the wire (``reference/change_log.py``, once
a run and kept in the state's ``memo``), to the change handler once its
frame's last byte has arrived.

* ``late-finalize``: runs the finalize hook before it delivers its last
  batches (``blob_feed``'s control): ``after_finalize`` > 0.
* ``subset-dropped``: delivers every digest before the hook, and each
  change without its subset (read as ``""``): ``wrong_changes`` > 0,
  every digest right.
"""

from __future__ import annotations

from collections import namedtuple

from portbench.controls.blob_feed import LateFinalizeDecoder
from portbench.reference import change_log as reference_change_log

Row = namedtuple("Row", "subset key change from_ to value")


def _done() -> None:
    pass


class LateFinalizeLog(LateFinalizeDecoder):
    def __init__(self, state):
        super().__init__(state)
        if "records" not in state.memo:
            state.memo["records"] = reference_change_log.decode_log(
                state.wire.buf)[0]
        self._records = state.memo["records"]
        self._handed = 0
        self._on_change = None

    def change(self, cb):
        self._on_change = cb
        return self

    def _row(self, record) -> Row:
        return Row(*record)

    def write(self, data) -> bool:
        super().write(data)
        while self._handed < self._next:  # frames whose last byte is in
            row = self._row(self._records[self._handed])
            self._handed += 1
            if self._on_change is not None:
                self._on_change(row, _done)
        return True


class SubsetDropped(LateFinalizeLog):
    def _row(self, record) -> Row:
        return Row("", *record[1:])

    def end(self) -> None:
        self._dispatch()
        while self._inflight:  # every digest before the hook
            self._deliver()
        super().end()


SYSTEMS = {"late-finalize": LateFinalizeLog, "subset-dropped": SubsetDropped}
