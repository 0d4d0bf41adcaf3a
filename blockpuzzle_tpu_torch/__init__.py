"""blockpuzzle_tpu_torch: the PyTorch + CUDA port of blockpuzzle_tpu.

A batched BlockPuzzle engine for NVIDIA Hopper: the same game, state layout
and step semantics as the JAX package, with its Pallas kernels rewritten
as hand CUDA kernels (``kernels/``), and the PPO and DQN learners on top
of it (``learn/``).  It imports neither JAX nor the JAX package.  The
Gymnasium surface, ``blockpuzzle_tpu_torch.vector_env``, is imported on
its own (it needs gymnasium) and registers the ``BlockPuzzleTpuTorch/``
ids.
"""

from blockpuzzle_tpu_torch.config import PRESETS, EnvConfig
from blockpuzzle_tpu_torch.env import make_env

__all__ = ["EnvConfig", "PRESETS", "make_env"]
