"""PI on PyTorch and CUDA: the port of the JAX package ``repro``.

It imports ``torch`` and numpy, never ``jax`` and nothing of ``repro``.
The kernels on its path are hand-written CUDA for Hopper (sm_90a) in
``kernels/csrc/``, built with ``nvcc`` on first use.  Entry points build
on the card unless the caller passes ``device="cpu"``.
"""
from repro_torch.core import *  # noqa: F401,F403
from repro_torch.core import __all__  # noqa: F401
