"""blocking-under-lock: no lock-holding region may block.

Motivating incidents (ANALYSIS.md has the table): since the hub
landed, reading the code has caught one of these by hand again and again —
the dispatcher composing a batch under ``self._lock`` and then writing
the socket before releasing it, an event emitter invoking a user sink
inside its registry lock (the sink re-enters ``emit`` → self-deadlock;
or merely blocks → every emitting thread convoys), the obs HTTP
handler reading a file under the collector lock.  The hub-isolation
rule hard-codes ONE instance of the contract (no device dispatch under
the hub lock); this rule is that contract generalized to the whole
program, with the call graph carried along: a helper only ever invoked
under a lock is analyzed as running locked even though it contains no
``with`` itself.

Blocked-call classes (the ``cls`` vocabulary, used by the scoped
allowlist):

* ``sleep`` — ``time.sleep``
* ``socket`` — send/recv/sendall/accept/connect/select on any
  socket-shaped receiver
* ``os-io`` — ``os.write/writev/read/...`` (raw fd I/O)
* ``file-io`` — ``open()`` and file-object read/write on a file-shaped
  receiver
* ``subprocess`` — any ``subprocess.*`` entry point
* ``callback`` — invoking user-supplied code (``on_*``/``*_cb``/
  ``*_hook``/``sink`` attributes, callable parameters, loop-unpacked
  callback tuples).  User code under YOUR lock is the worst class:
  it can block forever AND re-enter the lock.

Escape: ``# datlint: allow-blocking-under-lock`` on (or immediately
above) the call line accepts the site; ``allow-blocking-under-lock
(socket,file-io)`` scopes the acceptance to the named classes.  Every
allow must sit next to a written justification — the fixture suite
keeps the marker honest.

Findings cite the full chain: entry function → call steps → the lock
acquisition → the blocking call, so the reader sees both WHY the lock
is held and WHAT blocks under it.
"""

from __future__ import annotations

from typing import Iterator

from ..engine import Finding, Project
from .model import ProgramIndex

_CHAIN_SEP = " -> "


class BlockingUnderLock:
    name = "blocking-under-lock"
    description = (
        "no socket/file/os I/O, sleep, subprocess, or user-callback "
        "invocation while a lock is held (directly or through the "
        "call graph); escape: allow-blocking-under-lock + justification"
    )

    def check(self, project: Project) -> Iterator[Finding]:
        index = ProgramIndex.get(project)
        for sid in sorted(index.blocked):
            site, fn, chain, held = index.blocked[sid]
            roots = sorted({index.root_lock(h) for h in held
                            if not h.startswith("?")})
            unknown = [h for h in held if h.startswith("?")]
            if not roots and unknown:
                # only unresolvable lock-like regions hold here; still a
                # finding (conservative), but say so
                held_desc = "an unresolved lock-like region"
            else:
                held_desc = ", ".join(roots)
                if unknown:
                    held_desc += " (+ an unresolved lock-like region)"
            yield Finding(
                path=index.src_path(fn.module.relpath),
                line=site.line,
                rule=self.name,
                message=(
                    f"{site.rendered} [{site.cls}] runs while holding "
                    f"{held_desc}: a blocking call under a lock convoys "
                    f"every thread contending for it"
                    + (" — and user code under your lock can re-enter "
                       "it (self-deadlock)" if site.cls == "callback"
                       else "")
                    + f".  Path: {_CHAIN_SEP.join(chain)}"
                ),
                chains=(chain,),
            )
