"""strelka_tpu_torch — the PyTorch/CUDA port of strelka_tpu.

The package mirrors the JAX package's layout (ops/, render/, scene/,
loaders/, utils/) and adds kernels/ (Python wrappers of the hand-written
CUDA kernels and their plain PyTorch versions) and csrc/ (the CUDA
sources). It imports torch, numpy and scipy, never jax or strelka_tpu.

Entry points run on the CUDA card unless the caller passes device="cpu".
"""

from strelka_tpu_torch.settings import SettingsManager, SharedContext  # noqa: F401
