"""miniworld_tpu_torch: the PyTorch + CUDA port of miniworld_tpu.

A batched MiniWorld for one NVIDIA GPU (written for the H100): envs
step, auto-reset and render RGB-D on the device, with the render's hot
stages as hand-written CUDA kernels (``csrc/``, built with nvcc at
first use). The JAX package ``miniworld_tpu`` beside it is the
reference; this package imports neither it nor jax.
"""

__version__ = "0.1.0"

from miniworld_tpu_torch.envs import ENV_IDS, make_spec  # noqa: F401
from miniworld_tpu_torch.vector import MiniWorldVec  # noqa: F401
