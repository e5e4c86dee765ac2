"""Entry points of the port: ``serve`` (LM continuous batching over the
PI session table), ``train`` (the fault-tolerant training loop), ``mesh``
(device meshes over ``torch.distributed``, one process a rank, or a fake
process group for the dry run) and ``dryrun`` (one rank's program of an
(arch × shape × mesh) cell counted on ``meta`` tensors and priced at the
H100's rates, ``roofline``)."""
