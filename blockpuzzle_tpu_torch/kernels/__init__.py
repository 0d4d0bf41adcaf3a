"""Hand-written CUDA kernels for Hopper, each with its plain torch version.

Each wrapper binds one config's tables to one device: the card unless
the caller asks for another (built without a device on a machine with no
card, it raises).  For CPU tensors it runs the plain version; for CUDA
tensors it launches its kernel (built from ``csrc/`` at first use) or
raises, and counts each launch in its ``launches`` attribute, a plain int
(the four u8 wrappers count their general kernels in
``general_launches``, their wide kernels in ``wide_launches``, their tall
kernels, for boards of 33 to 128 rows, in ``tall_launches``, their deep
kernels, for taller boards, in ``deep_launches``, and their xwide kernels,
for rows of 129 to 1024 cells, in ``xwide_launches``, and those on rows
of 1025 to 4096 cells in ``xwide_long_launches``: the u8 apply's are the
clear's kernels' apply
instances, the legality's the mask's kernels'
every-piece instances; the packed wrappers their tall and general kernels in
``tall_launches`` and ``general_launches``, the packed mask its words entry
in ``words_launches``, ``words_tall_launches`` and
``words_general_launches``, the packed tail its unpack entry in
``unpack_launches``); ``name`` is the kernel a wrapper picked.  The draw
wrappers (``draws.py``) compute the port's counter-based random draws: the
deal and the two uniform-legal policies; the packed tail (``tail.py``) the
step from the mask onward and the board unpack.
"""

from blockpuzzle_tpu_torch.kernels.clear import ClearScanKernel, clear_plain
from blockpuzzle_tpu_torch.kernels.collision import (
    ApplyKernel,
    LegalityKernel,
    apply_plain,
    legality_plain,
)
from blockpuzzle_tpu_torch.kernels.draws import (
    DealKernel,
    UniformLegalKernel,
    WordsSelectKernel,
)
from blockpuzzle_tpu_torch.kernels.mask import MaskKernel, mask_plain
from blockpuzzle_tpu_torch.kernels.packed import (
    PackedApplyKernel,
    PackedMaskKernel,
    packed_apply_plain,
    packed_legal_words_plain,
    packed_mask_plain,
)
from blockpuzzle_tpu_torch.kernels.tail import PackedTailKernel, tail_plain

__all__ = [
    "ApplyKernel", "ClearScanKernel", "DealKernel", "LegalityKernel", "MaskKernel",
    "PackedApplyKernel", "PackedMaskKernel", "PackedTailKernel", "UniformLegalKernel",
    "WordsSelectKernel", "apply_plain", "clear_plain", "legality_plain", "mask_plain",
    "packed_apply_plain", "packed_legal_words_plain", "packed_mask_plain", "tail_plain",
]
