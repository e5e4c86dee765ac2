"""pilint for the port: contract-enforcing static analysis of the PI
pipeline on PyTorch.

Counterpart of ``repro.analysis``.  ``python -m repro_torch.analysis
src/repro_torch`` parses the tree with Python's ``ast`` and enforces the
repo's load-bearing conventions as mechanical rules (DESIGN.md §10):

* PI001 — one-writer ownership: index-state leaves are mutated only
  through the sanctioned ``core`` entry points (torch's in-place methods
  and ``out=`` included).
* PI002 — host round-trips inside a device scope (``.item()``,
  ``.tolist()``, host casts, Python control flow on device values): each
  syncs the stream and stalls the pipelined enqueue.
* PI003 — in-place writes to an input of the index's device scopes,
  whose pre-window state the dispatcher reads again (eager PyTorch
  donates nothing; this is what donation aliasing becomes).
* PI004 — float arithmetic on exact integer domains (keys, seqs,
  capacities, thresholds).
* PI005 — inline sentinel construction instead of ``sentinel_for``.
* PI006 — durable-I/O sites not covered by a registered fault point.

Findings can be suppressed per line with ``# pilint: disable=PI00x`` and
grandfathered via a committed baseline file (the JAX package's format);
the CLI emits both human and JSON reports.  The analyzer is stdlib-only
(``ast``/``json``/``argparse``), though importing it runs the
``repro_torch`` package's ``__init__``, which imports torch.
``runtime.py`` is the one module imported by production code (the launch
guards) and has no analyzer dependencies.
"""
from repro_torch.analysis.runtime import LaunchGuard, launch_guard

__all__ = ["LaunchGuard", "launch_guard"]
