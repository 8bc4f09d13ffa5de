"""Broadcast replication: one shared log, many independent cursors.

The port carries :mod:`.log` (:class:`BroadcastLog`, the offset-addressed
log a snapshot source frames its cold answer into once).  The JAX
package's fan-out server is not carried yet.
"""

from .log import BroadcastCursor, BroadcastLog, SnapshotNeeded

__all__ = ["BroadcastLog", "BroadcastCursor", "SnapshotNeeded"]
