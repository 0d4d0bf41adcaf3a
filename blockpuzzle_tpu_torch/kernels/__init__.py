"""Hand-written CUDA kernels for Hopper, each with its plain torch version.

Each wrapper binds one config's tables to one device: the card unless
the caller asks for another (built without a device on a machine with no
card, it raises).  For CPU tensors it runs the plain version; for CUDA
tensors it launches its kernel (built from ``csrc/`` at first use) or
raises, and counts each launch in its ``launches`` attribute, a plain int
(the four u8 wrappers count their general kernels in
``general_launches``).
"""

from blockpuzzle_tpu_torch.kernels.clear import ClearScanKernel, clear_plain
from blockpuzzle_tpu_torch.kernels.collision import (
    ApplyKernel,
    LegalityKernel,
    apply_plain,
    legality_plain,
)
from blockpuzzle_tpu_torch.kernels.mask import MaskKernel, mask_plain
from blockpuzzle_tpu_torch.kernels.packed import (
    PackedApplyKernel,
    PackedMaskKernel,
    packed_apply_plain,
    packed_mask_plain,
)

__all__ = [
    "ApplyKernel", "ClearScanKernel", "LegalityKernel", "MaskKernel",
    "PackedApplyKernel", "PackedMaskKernel",
    "apply_plain", "clear_plain", "legality_plain", "mask_plain",
    "packed_apply_plain", "packed_mask_plain",
]
