"""aria_tpu_torch: the Aria serving path in PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper (sm_90a).

It mirrors the layout of ``aria_tpu`` (``ops/``, ``models/``, ``engine/``,
``checkpoint/``) and is held to it by the tests: the same param tree, given
as numpy leaves, runs through both packages. It imports ``torch`` and never
``jax``; the configuration dataclasses are the JAX package's own
(``aria_tpu/config.py`` imports no jax), re-exported here.

Every kernel wrapper launches its CUDA kernel for CUDA tensors and runs its
plain PyTorch version for CPU tensors (``ops/backend.py``).
"""

from aria_tpu.config import AriaConfig, TextConfig

__all__ = ["AriaConfig", "TextConfig"]
__version__ = "0.1.0"
