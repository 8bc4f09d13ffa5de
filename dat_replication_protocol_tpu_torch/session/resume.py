"""Session resume, trimmed to its error type.

A trimmed copy of ``dat_replication_protocol_tpu/session/resume.py``:
only :class:`ResumeError`, which the broadcast log raises when a reader
attaches below what it retains.  Checkpoints and the wire journal are
not carried.
"""

from __future__ import annotations

from ..wire.framing import ProtocolError

__all__ = ["ResumeError"]


class ResumeError(ProtocolError):
    """A checkpoint or offset that cannot be honored (e.g. the log
    already trimmed past it).  Carries the standard structured context."""
