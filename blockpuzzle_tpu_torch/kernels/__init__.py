"""Hand-written CUDA kernels for Hopper, each with its plain torch version.

Each wrapper binds one config's tables to one device.  For CPU tensors it
runs the plain version; for CUDA tensors it launches its kernel (built
from ``csrc/`` at first use) or raises, and counts each launch in its
``launches`` attribute, a plain int.
"""

from blockpuzzle_tpu_torch.kernels.collision import ApplyKernel, apply_plain
from blockpuzzle_tpu_torch.kernels.mask import MaskKernel, mask_plain

__all__ = ["ApplyKernel", "MaskKernel", "apply_plain", "mask_plain"]
