"""refport: the benchmark's plain reference renderer.

A copy of the port's plain PyTorch code, frozen here so that no later change
to the program moves the yardstick: the loaders (the USD crate reader with
its Python decoders), the scene and material tables, the textures, the
sampler, the shading and the integrator. Every kernel is its plain version
(kernels/), every intersection the dense sweep over all primitives
(ops/intersect.py), and there is no native code (the crate reader's Python
decoders run). It imports torch and numpy only: nothing of the
program, and neither jax nor the JAX package. `benchmark/reference.py`
drives it.
"""

from refport.settings import SettingsManager, SharedContext  # noqa: F401
