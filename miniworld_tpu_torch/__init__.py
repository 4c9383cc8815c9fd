"""miniworld_tpu_torch: the PyTorch + CUDA port of miniworld_tpu.

A batched MiniWorld for one NVIDIA GPU (written for the H100): envs
step, auto-reset and render RGB-D on the device, with the render's hot
stages as hand-written CUDA kernels (``csrc/``, built with nvcc at
first use). The JAX package ``miniworld_tpu`` beside it is the
reference; this package imports neither it nor jax.
"""

__version__ = "0.1.0"

from miniworld_tpu_torch.envs import ENV_IDS, make_spec  # noqa: F401
from miniworld_tpu_torch.gym_env import SingleEnv, register_gym  # noqa: F401
from miniworld_tpu_torch.vector import MiniWorldVec  # noqa: F401


def __getattr__(name):
    # MiniWorldGym exists where gymnasium is installed (gym_env.py)
    if name == "MiniWorldGym":
        from miniworld_tpu_torch.gym_env import MiniWorldGym

        return MiniWorldGym
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
