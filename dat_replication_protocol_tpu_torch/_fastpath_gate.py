"""The one lazy binding to the ``dat_fastpath`` C extension.

Both consumers (``wire.change_codec``'s per-record codec and
``session.decoder``'s bulk dispatch) reach the extension through
:func:`fastpath_mod`, so one process holds one binding.  Neither can
import ``runtime.fastpath`` when it is imported (``runtime`` imports
``replay``, which imports ``change_codec``), so this module holds the
shared lazy binding instead of each keeping its own copy.  Only the
bound ``get`` function is cached here; the build and import happen
once, inside it, and raise when they fail.
"""

from __future__ import annotations

_get = None  # runtime.fastpath.get, bound at first use


def fastpath_mod():
    """The ``dat_fastpath`` extension module (built at first use)."""
    get = _get
    if get is None:
        get = _bind()
    return get()


def _bind():
    global _get
    from .runtime import fastpath

    _get = fastpath.get
    return _get
