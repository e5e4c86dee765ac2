"""Entry points of the port: ``serve`` (LM continuous batching over the
PI session table) and ``train`` (the fault-tolerant training loop).  The
dry-run waits (ROADMAP A12)."""
