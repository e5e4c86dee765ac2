"""Named fault points for crash-injection testing.

Counterpart of ``repro.faults``, with the same five names and its own
hook: the port imports nothing of the JAX package, so a hook installed
here drives only the port's durability code.

Durability code (``pipeline/wal.py``, ``checkpoint.py``) calls
``faultpoint(name)`` at the instants where a crash is interesting — mid
record append, after append but before fsync, mid snapshot write, between
the snapshot tmp-write and its atomic rename.  In production the hook is
``None`` and the call is an attribute load and a compare; under test a
hook that raises at a chosen point leaves the disk exactly as a crash
there would, and recovery is then proven from that torn state.
"""
from __future__ import annotations

from typing import Callable, Optional

# the canonical crash points; tests iterate this list so a new call site
# must be registered here to be covered by the fault-injection suite
FAULT_POINTS = (
    "wal.mid_append",     # torn WAL record: header+partial payload on disk
    "wal.after_append",   # full record written, fsync not yet issued
    "wal.pre_sync",       # record(s) written in full, death inside the
                          # fsync that would have acknowledged them
    "ckpt.mid_write",     # snapshot tmp dir partially written, no manifest
    "ckpt.pre_rename",    # complete tmp dir, atomic publish rename pending
)

_HOOK: Optional[Callable[[str], None]] = None


def faultpoint(name: str) -> None:
    """Crash-injection call site; no-op unless a hook is installed."""
    if _HOOK is not None:
        _HOOK(name)


def set_fault_hook(hook: Optional[Callable[[str], None]]):
    """Install (or clear, with ``None``) the fault hook; returns the
    previous hook so nested scopes can restore it."""
    global _HOOK
    prev = _HOOK
    _HOOK = hook
    return prev
