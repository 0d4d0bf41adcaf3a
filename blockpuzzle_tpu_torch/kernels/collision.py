"""Chosen-action apply: CUDA kernel (``csrc/collision.cu``) and its plain
version.

The port of ``ApplyKernel`` (``blockpuzzle_tpu/kernels/collision.py``):
overlap test of the chosen footprint, masked place, and the simultaneous
clear of every full row, column and region, all found on the placed board.
Outputs ``(new_board (N, HW) u8, k (N,) i32, legal (N,) bool)``; an illegal
action is a strict no-op with k = 0, even on a board that already holds a
full line.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from blockpuzzle_tpu_torch import rules
from blockpuzzle_tpu_torch.config import EnvConfig
from blockpuzzle_tpu_torch.kernels import _build

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
    (L,) int32 line lengths: the kernel's form of ``masks``."""
    lens = masks.sum(axis=1).astype(np.int32)
    cells = np.zeros((masks.shape[0], int(lens.max())), np.int32)
    for line, row in enumerate(masks):
        idx = np.flatnonzero(row)
        cells[line, : idx.size] = idx
    return cells, lens


def apply_plain(
    board: torch.Tensor,
    cover: torch.Tensor,
    valid: torch.Tensor,
    masks: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain torch version (``ApplyKernel.reference``): line occupancy and
    cleared cells as two products with the (L, HW) float32 line ``masks``."""
    overlap = (board & cover).to(torch.int32).sum(dim=1)
    legal = valid & (overlap == 0)
    placed = torch.where(legal[:, None], board | cover, board)
    occ = placed.to(torch.float32) @ masks.T                      # (N, L)
    full = occ == masks.sum(dim=1)
    clear_cells = full.to(torch.float32) @ masks                  # (N, HW)
    cleared = torch.where(clear_cells > 0, 0, placed).to(torch.uint8)
    new_board = torch.where(legal[:, None], cleared, board)
    k = torch.where(legal, full.sum(dim=1).to(torch.int32), 0).to(torch.int32)
    return new_board, k, legal


class ApplyKernel:
    """Config-bound fused collision + place + clear on one device.

    ``__call__(board (N, HW) u8, cover (N, HW) u8, valid (N,) bool)``.  For
    CPU tensors it runs ``apply_plain``; for CUDA tensors it launches the
    kernel (``launches`` counts those launches) or raises.
    """

    def __init__(self, cfg: EnvConfig, device="cpu"):
        self.cfg = cfg
        self.device = _build.resolve_device(device)
        self.launches = 0
        masks = line_masks(cfg)
        cells, lens = line_cell_table(masks)
        self.masks = torch.as_tensor(masks.astype(np.float32), device=self.device)
        self.line_cells = torch.as_tensor(cells, device=self.device)
        self.line_len = torch.as_tensor(lens, device=self.device)
        if cfg.num_cells + masks.shape[0] > _MAX_SMEM_PER_WARP:
            raise ValueError(f"board of {cfg.num_cells} cells is too large")

    def plain(self, board, cover, valid):
        return apply_plain(board, cover, valid, self.masks)

    def __call__(
        self, board: torch.Tensor, cover: torch.Tensor, valid: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        n = board.shape[0]
        hw = self.cfg.num_cells
        for x in (board, cover, valid):
            if x.device != self.device:
                raise ValueError(
                    f"tensor on {x.device}, kernel tables on {self.device}"
                )
        if board.shape != (n, hw) or board.dtype != torch.uint8:
            raise ValueError(f"board must be (N, {hw}) uint8")
        if cover.shape != (n, hw) or cover.dtype != torch.uint8:
            raise ValueError(f"cover must be (N, {hw}) uint8")
        if valid.shape != (n,) or valid.dtype != torch.bool:
            raise ValueError("valid must be (N,) bool")
        if self.device.type == "cpu":
            return self.plain(board, cover, valid)
        if self.device.type != "cuda":
            raise ValueError(f"no apply kernel for device {self.device}")
        if not all(x.is_contiguous() for x in (board, cover, valid)):
            raise ValueError("board, cover and valid must be contiguous")
        new_board = torch.empty_like(board)
        k = torch.empty(n, dtype=torch.int32, device=self.device)
        legal = torch.empty(n, dtype=torch.bool, device=self.device)
        stream = torch.cuda.current_stream(self.device).cuda_stream
        with torch.cuda.device(self.device):
            err = _build.library().bp_apply(
                board.data_ptr(), cover.data_ptr(), valid.data_ptr(),
                self.line_cells.data_ptr(), self.line_len.data_ptr(),
                new_board.data_ptr(), k.data_ptr(), legal.data_ptr(),
                n, hw, self.line_cells.shape[0], self.line_cells.shape[1],
                stream,
            )
        _build.check(err, "bp_apply")
        self.launches += 1
        return new_board, k, legal
