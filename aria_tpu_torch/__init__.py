"""aria_tpu_torch: the Aria serving path and trainer in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

It mirrors the layout of ``aria_tpu`` (``ops/``, ``models/``, ``engine/``,
``checkpoint/``, ``train/``, ``data/``, ``utils/``, ``cli/``) and is held
to it by the tests: the same param tree, given as numpy leaves, runs
through both packages. It imports ``torch`` and nothing of ``jax`` or of
the JAX package; it keeps its own copies of the jax-free modules it needs
(``config.py``, ``data/``, ``train/recipe.py``, ``utils/metrics.py``).

Every kernel wrapper launches its CUDA kernel for CUDA tensors and runs its
plain PyTorch version for CPU tensors (``ops/backend.py``). Entry points
that build tensors do so on the card unless the caller passes
``device="cpu"``; without a card they raise.
"""

from aria_tpu_torch.config import AriaConfig, ProjectorConfig, TextConfig, VisionConfig

__all__ = ["AriaConfig", "ProjectorConfig", "TextConfig", "VisionConfig"]
__version__ = "0.1.0"
