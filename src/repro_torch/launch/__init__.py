"""Entry points of the port: ``serve`` (LM continuous batching over the
PI session table).  Training and the dry-run wait (ROADMAP A10, A12)."""
