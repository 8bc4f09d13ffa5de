"""The event-driven edge: ONE selector session table serving hub
sessions, broadcast subscribers of N groups and reconcile and snapshot
responders from a single loop, with the threaded edge's staged overload
ladder (admission, per-session windows, heaviest-offender shed).

The port of ``dat_replication_protocol_tpu/edge/`` without the gossip
leg, which comes with the cluster package.
"""

from .loop import QOS_PRESETS, EdgeLoop, serve_edge

__all__ = ["EdgeLoop", "serve_edge", "QOS_PRESETS"]
