"""Broadcast replication: one shared log, many independent cursors.

One source session's wire becomes an offset-addressed
:class:`BroadcastLog` that many downstream peers stream from at
independent offsets: digest work is done once (wherever the source
session decodes), and frames are fanned out by :class:`FanoutServer`
with per-peer flow-control windows and the three-stage overload
contract (admission, window stall, shed).  A snapshot source also frames
its cold answer into a :class:`BroadcastLog` once.
"""

from .log import BroadcastCursor, BroadcastLog, SnapshotNeeded
from .server import FanoutBusy, FanoutPeer, FanoutServer, PeerShed

__all__ = ["BroadcastLog", "BroadcastCursor", "SnapshotNeeded",
           "FanoutServer", "FanoutPeer", "FanoutBusy", "PeerShed"]
