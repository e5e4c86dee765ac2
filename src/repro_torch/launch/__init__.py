"""Entry points of the port: ``serve`` (LM continuous batching over the
PI session table), ``train`` (the fault-tolerant training loop) and
``mesh`` (device meshes over ``torch.distributed``, one process a rank).
The dry-run waits (ROADMAP A12)."""
