"""Simultaneous line clear: CUDA kernels (``csrc/clear.cu``) and their
plain version.

The port of ``ClearScanKernel`` (``blockpuzzle_tpu/kernels/clear.py``):
every full row, column (and 3x3 region) of the board is found first and
then all are cleared at once; ``k`` counts them.  There is no legality
gate: a line that was full on the input is cleared too.  The line tables
live here, as ``_line_table`` does in the JAX package, and the apply
kernel (``collision.py``) shares them.

Two kernels compute it: the bit-row kernel, for boards of at most 32 rows
of at most 32 cells (every shipped preset), tests lines on 32-bit row
words; the general kernel walks ``line_cell_table`` and takes any other
board.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from blockpuzzle_tpu_torch import rules
from blockpuzzle_tpu_torch.config import EnvConfig
from blockpuzzle_tpu_torch.kernels import _build
from blockpuzzle_tpu_torch.kernels.packed import row_launch_shape

# (hw + L) bytes of shared memory per warp, four warps a block, must stay
# under the 48 KB a launch gets without opting in to more
_MAX_SMEM_PER_WARP = 48 * 1024 // 4


def line_masks(cfg: EnvConfig) -> np.ndarray:
    """(L, HW) uint8 membership of every row, column (and region)."""
    t = rules.tables_for(cfg)
    parts = [t.row_masks, t.col_masks]
    if cfg.region_clear:
        parts.append(t.region_masks)
    return np.concatenate(parts, axis=0)


def line_cell_table(masks: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(L, max_len) int32 flat cell indices of each line (zero-padded) and
    (L,) int32 line lengths: the kernels' form of ``masks``."""
    lens = masks.sum(axis=1).astype(np.int32)
    cells = np.zeros((masks.shape[0], int(lens.max())), np.int32)
    for line, row in enumerate(masks):
        idx = np.flatnonzero(row)
        cells[line, : idx.size] = idx
    return cells, lens


def clear_plain(
    board: torch.Tensor, masks: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version (``clear_scan_reference``): line occupancy and
    cleared cells as two products with the (L, HW) float32 line ``masks``;
    returns (cleared (N, HW) u8, k (N,) i32)."""
    occ = board.to(torch.float32) @ masks.T                       # (N, L)
    full = occ == masks.sum(dim=1)
    clear_cells = full.to(torch.float32) @ masks                  # (N, HW)
    cleared = torch.where(clear_cells > 0, 0, board).to(torch.uint8)
    return cleared, full.sum(dim=1).to(torch.int32)


class LineTables:
    """One config's line tables on one device, in the plain version's form
    (``masks``) and the kernels' (``line_cells``, ``line_len``)."""

    def __init__(self, cfg: EnvConfig, device):
        masks = line_masks(cfg)
        if cfg.num_cells + masks.shape[0] > _MAX_SMEM_PER_WARP:
            raise ValueError(f"board of {cfg.num_cells} cells is too large")
        cells, lens = line_cell_table(masks)
        self.masks = torch.as_tensor(masks.astype(np.float32), device=device)
        self.line_cells = torch.as_tensor(cells, device=device)
        self.line_len = torch.as_tensor(lens, device=device)


class ClearScanKernel:
    """Config-bound simultaneous clear on one device, the card unless asked
    for another.

    ``__call__(board (N, HW) u8) -> (cleared (N, HW) u8, k (N,) i32)``.
    For CPU tensors it runs ``clear_plain``; for CUDA tensors it launches a
    kernel or raises.  The kernel is picked here, by shape: the bit-row
    kernel where H <= 32 and W <= 32 (``shape`` is its launch shape;
    ``launches`` counts its launches), else the general kernel (``shape``
    is None; ``general_launches`` counts them).

    The bit-row kernel takes the engine's boards, whose cells are 0 or 1
    (``env/state.py``): it finds a line full when every cell is nonzero
    and writes the cleared board as 0/1 cells.  On such boards that is
    ``clear_plain``'s test (the line's cells sum to its length) and output.
    """

    def __init__(self, cfg: EnvConfig, device="cuda"):
        self.cfg = cfg
        self.device = _build.resolve_device(device)
        self.launches = 0
        self.general_launches = 0
        self.shape = row_launch_shape(cfg)
        self.lines = LineTables(cfg, self.device)

    def plain(self, board: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return clear_plain(board, self.lines.masks)

    def __call__(self, board: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        n = board.shape[0]
        hw = cfg.num_cells
        if board.device != self.device:
            raise ValueError(
                f"tensor on {board.device}, kernel tables on {self.device}"
            )
        if board.shape != (n, hw) or board.dtype != torch.uint8:
            raise ValueError(f"board must be (N, {hw}) uint8")
        if self.device.type == "cpu":
            return self.plain(board)
        if self.device.type != "cuda":
            raise ValueError(f"no clear kernel for device {self.device}")
        if not board.is_contiguous():
            raise ValueError("board must be contiguous")
        lines = self.lines
        cleared = torch.empty_like(board)
        k = torch.empty(n, dtype=torch.int32, device=self.device)
        stream = torch.cuda.current_stream(self.device).cuda_stream
        lib = _build.library()
        with torch.cuda.device(self.device):
            if self.shape is None:
                name = "bp_clear"
                err = lib.bp_clear(
                    board.data_ptr(), lines.line_cells.data_ptr(),
                    lines.line_len.data_ptr(), cleared.data_ptr(), k.data_ptr(),
                    n, hw, lines.line_cells.shape[0], lines.line_cells.shape[1],
                    stream,
                )
            else:
                if cleared.data_ptr() % 16:  # the kernel stores 16-byte vectors
                    raise RuntimeError("clear output is not 16-byte aligned")
                name = "bp_clear_rows"
                err = lib.bp_clear_rows(
                    board.data_ptr(), cleared.data_ptr(), k.data_ptr(), n,
                    cfg.height, cfg.width,
                    cfg.region_size if cfg.region_clear else 0, *self.shape,
                    stream,
                )
        _build.check(err, name)
        if self.shape is None:
            self.general_launches += 1
        else:
            self.launches += 1
        return cleared, k
