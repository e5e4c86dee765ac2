"""Runtime side of the one-launch-a-window contract (the dynamic half of
PI002).

Counterpart of ``repro.analysis.runtime``.  The JAX package promises one
compiled program a run and counts traces; eager PyTorch compiles
nothing, so the port promises a fixed number of kernel launches a window
and counts launches: a named counter that each kernel wrapper bumps
where it launches its kernel (a call on a CPU tensor runs the plain
version and never counts), plus one canonical assertion message, so
every suite and smoke run reports a surplus or missing launch the same
way.  These guards are the only store of the launch counts.

Producer (where the kernel is launched)::

    _LAUNCHES = launch_guard("pi_probe")

    def pi_probe(...):
        ...                     # the C call that enqueues the kernel
        _LAUNCHES.bump()

Consumer (around a serving run)::

    guard = launch_guard("pi_probe")
    base = guard.count()
    ... drive the pipeline ...
    guard.expect(base, n_windows, "padded serving run")

Stdlib-only by design: production modules import this, and the analyzer
package must stay runnable anywhere the interpreter is.
"""
from __future__ import annotations

from typing import Dict


class LaunchGuard:
    """Named launch counter with one canonical assertion format."""

    __slots__ = ("name", "_launches")

    def __init__(self, name: str):
        self.name = name
        self._launches = 0

    def bump(self) -> None:
        """Count one launch; call where the kernel is enqueued."""
        self._launches += 1

    def count(self) -> int:
        return self._launches

    def message(self, got: int, want: int, what: str = "") -> str:
        """The single launch-count failure format every assert site uses."""
        ctx = f" during {what}" if what else ""
        return (f"launch_guard[{self.name}]: {got} launch(es){ctx} where "
                f"{want} expected — a window launched its kernel more or "
                f"fewer times than its contract, or ran the plain version "
                f"(PI002)")

    def expect(self, base: int, want: int = 1, what: str = "") -> None:
        """Assert exactly ``want`` launches happened since ``base``."""
        got = self._launches - base
        assert got == want, self.message(got, want, what)


_GUARDS: Dict[str, LaunchGuard] = {}


def launch_guard(name: str) -> LaunchGuard:
    """Process-wide guard registry: one counter per name."""
    guard = _GUARDS.get(name)
    if guard is None:
        guard = _GUARDS[name] = LaunchGuard(name)
    return guard
