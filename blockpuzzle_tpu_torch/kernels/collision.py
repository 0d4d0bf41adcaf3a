"""Placement collision: CUDA kernels and their plain versions.

The port of ``blockpuzzle_tpu/kernels/collision.py``, whose two kernels
sit here together as they do there:

* ``LegalityKernel`` (``csrc/legality.cu``): legality of every (piece,
  anchor) on each board, ``(N, P, HW)`` bool: the piece lies in bounds
  there and covers no occupied cell.
* ``ApplyKernel`` (``csrc/collision.cu``): overlap test of the chosen
  footprint, masked place, and the simultaneous clear of every full row,
  column and region, all found on the placed board.  Outputs
  ``(new_board (N, HW) u8, k (N,) i32, legal (N,) bool)``; an illegal
  action is a strict no-op with k = 0, even on a board that already holds
  a full line.

``piece_table`` is the per-piece footprint table of the legality and mask
kernels.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from blockpuzzle_tpu_torch import rules
from blockpuzzle_tpu_torch.config import EnvConfig
from blockpuzzle_tpu_torch.kernels import _build
from blockpuzzle_tpu_torch.kernels.clear import LineTables, clear_plain


def piece_table(cfg: EnvConfig) -> np.ndarray:
    """(P, 3 + max_cells) int32 rows ``[h, w, ncells, dr*W + dc ...]``:
    each piece's bounding box and the flat offsets of its cells from the
    anchor."""
    t = rules.tables_for(cfg)
    max_cells = int(t.piece_cells.max())
    table = np.zeros((t.num_pieces, 3 + max_cells), np.int32)
    for p in range(t.num_pieces):
        offs = [dr * cfg.width + dc for dr, dc in np.argwhere(t.pieces[p])]
        table[p, :3] = (t.piece_h[p], t.piece_w[p], len(offs))
        table[p, 3 : 3 + len(offs)] = offs
    return table


# ---------------------------------------------------------------------------
# all-anchors legality map
# ---------------------------------------------------------------------------


def legality_plain(
    board: torch.Tensor, cover_t: torch.Tensor, valid: torch.Tensor
) -> torch.Tensor:
    """Plain torch version (``LegalityKernel.reference``): occupied-cell
    counts under every (piece, anchor) footprint as one matmul, then
    ``counts == 0 & valid``; returns (N, P, HW) bool.

    ``cover_t``: (HW, P*HW) float32 footprints; ``valid``: (P*HW,) bool."""
    n, hw = board.shape
    counts = board.to(torch.float32) @ cover_t                  # (N, P*HW)
    return ((counts == 0) & valid).view(n, -1, hw)


class LegalityKernel:
    """Config-bound all-(piece, anchor) legality on one device, the card
    unless asked for another.

    ``__call__(board (N, HW) u8) -> (N, P, HW) bool``.  For CPU tensors it
    runs ``legality_plain``; for CUDA tensors it launches the kernel
    (``launches`` counts those launches) or raises.
    """

    def __init__(self, cfg: EnvConfig, device="cuda"):
        t = rules.tables_for(cfg)
        self.cfg = cfg
        self.device = _build.resolve_device(device)
        self.num_pieces = t.num_pieces
        self.launches = 0
        self.piece_table = torch.as_tensor(piece_table(cfg), device=self.device)
        self.cover_t = torch.as_tensor(
            t.cover.T.astype(np.float32), device=self.device
        )
        self.valid = torch.as_tensor(t.valid, device=self.device)

    def plain(self, board: torch.Tensor) -> torch.Tensor:
        return legality_plain(board, self.cover_t, self.valid)

    def __call__(self, board: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        n = board.shape[0]
        if board.device != self.device:
            raise ValueError(
                f"tensor on {board.device}, kernel tables on {self.device}"
            )
        if board.shape != (n, cfg.num_cells) or board.dtype != torch.uint8:
            raise ValueError(f"board must be (N, {cfg.num_cells}) uint8")
        if self.device.type == "cpu":
            return self.plain(board)
        if self.device.type != "cuda":
            raise ValueError(f"no legality kernel for device {self.device}")
        if not board.is_contiguous():
            raise ValueError("board must be contiguous")
        out = torch.empty(
            (n, self.num_pieces, cfg.num_cells), dtype=torch.bool,
            device=self.device,
        )
        stream = torch.cuda.current_stream(self.device).cuda_stream
        with torch.cuda.device(self.device):
            err = _build.library().bp_legality(
                board.data_ptr(), self.piece_table.data_ptr(), out.data_ptr(),
                n, cfg.height, cfg.width, self.num_pieces,
                self.piece_table.shape[1] - 3, stream,
            )
        _build.check(err, "bp_legality")
        self.launches += 1
        return out


# ---------------------------------------------------------------------------
# chosen-action apply (collision + place + clear)
# ---------------------------------------------------------------------------


def place_and_clear(
    board: torch.Tensor,
    cover: torch.Tensor,
    valid: torch.Tensor,
    clear: Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]],
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Overlap test, masked place, ``clear(placed) -> (cleared, k)``, and
    the strict no-op of an illegal action: the operations of the JAX u8
    jnp step (``core.py`` ``step``), in its order."""
    overlap = (board & cover).to(torch.int32).sum(dim=1)
    legal = valid & (overlap == 0)
    placed = torch.where(legal[:, None], board | cover, board)
    cleared, k = clear(placed)
    new_board = torch.where(legal[:, None], cleared, board)
    k = torch.where(legal, k, 0).to(torch.int32)
    return new_board, k, legal


def apply_plain(
    board: torch.Tensor,
    cover: torch.Tensor,
    valid: torch.Tensor,
    masks: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain torch version (``ApplyKernel.reference``): ``place_and_clear``
    with ``clear_plain`` over the (L, HW) float32 line ``masks``."""
    return place_and_clear(board, cover, valid, lambda b: clear_plain(b, masks))


class ApplyKernel:
    """Config-bound fused collision + place + clear on one device, the card
    unless asked for another.

    ``__call__(board (N, HW) u8, cover (N, HW) u8, valid (N,) bool)``.  For
    CPU tensors it runs ``apply_plain``; for CUDA tensors it launches the
    kernel (``launches`` counts those launches) or raises.
    """

    def __init__(self, cfg: EnvConfig, device="cuda"):
        self.cfg = cfg
        self.device = _build.resolve_device(device)
        self.launches = 0
        self.lines = LineTables(cfg, self.device)

    def plain(self, board, cover, valid):
        return apply_plain(board, cover, valid, self.lines.masks)

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
        lines = self.lines
        new_board = torch.empty_like(board)
        k = torch.empty(n, dtype=torch.int32, device=self.device)
        legal = torch.empty(n, dtype=torch.bool, device=self.device)
        stream = torch.cuda.current_stream(self.device).cuda_stream
        with torch.cuda.device(self.device):
            err = _build.library().bp_apply(
                board.data_ptr(), cover.data_ptr(), valid.data_ptr(),
                lines.line_cells.data_ptr(), lines.line_len.data_ptr(),
                new_board.data_ptr(), k.data_ptr(), legal.data_ptr(),
                n, hw, lines.line_cells.shape[0], lines.line_cells.shape[1],
                stream,
            )
        _build.check(err, "bp_apply")
        self.launches += 1
        return new_board, k, legal
