"""Hand action mask: CUDA kernel (``csrc/mask.cu``) and its plain version.

The port of ``blockpuzzle_tpu/kernels/mask.py`` (``MaskKernel``).  Anchor
(r, c) of slot s is legal iff the slot holds a piece, the piece lies in
bounds there and covers no occupied cell; the result is the engine's
``action_mask``: (N, S*HW) bool, slot-major then row-major anchor.  It is
the legality map of ``collision.py`` read at each slot's piece.
"""

from __future__ import annotations

import numpy as np
import torch

from blockpuzzle_tpu_torch import rules
from blockpuzzle_tpu_torch.config import EnvConfig
from blockpuzzle_tpu_torch.kernels import _build
from blockpuzzle_tpu_torch.kernels.collision import legality_plain, piece_table


def mask_plain(
    board: torch.Tensor,
    queue: torch.Tensor,
    cover_t: torch.Tensor,
    valid: torch.Tensor,
) -> torch.Tensor:
    """Plain torch version: ``legality_plain``, then each slot's piece row
    (an all-False row for the empty sentinel).

    ``cover_t``: (HW, P*HW) float32 footprints; ``valid``: (P*HW,) bool."""
    n, hw = board.shape
    s = queue.shape[1]
    legal_all = legality_plain(board, cover_t, valid)
    num_pieces = legal_all.shape[1]
    legal_all = torch.cat([legal_all, legal_all.new_zeros(n, 1, hw)], dim=1)
    in_set = (queue >= 0) & (queue < num_pieces)
    pid = torch.where(in_set, queue, num_pieces).to(torch.int64)
    sel = legal_all.gather(1, pid[:, :, None].expand(n, s, hw))
    return sel.reshape(n, s * hw)


class MaskKernel:
    """Config-bound hand mask on one device.

    ``__call__(board (N, HW) u8, queue (N, S) i32) -> (N, S*HW) bool``.
    For CPU tensors it runs ``mask_plain``; for CUDA tensors it launches
    the kernel (``launches`` counts those launches) or raises.
    """

    def __init__(self, cfg: EnvConfig, device="cpu"):
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

    def plain(self, board: torch.Tensor, queue: torch.Tensor) -> torch.Tensor:
        return mask_plain(board, queue, self.cover_t, self.valid)

    def __call__(self, board: torch.Tensor, queue: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        n = board.shape[0]
        if board.device != self.device or queue.device != self.device:
            raise ValueError(
                f"tensors on {board.device}/{queue.device}, kernel tables on "
                f"{self.device}"
            )
        if board.shape != (n, cfg.num_cells) or board.dtype != torch.uint8:
            raise ValueError(f"board must be (N, {cfg.num_cells}) uint8")
        if queue.shape != (n, cfg.queue_size) or queue.dtype != torch.int32:
            raise ValueError(f"queue must be (N, {cfg.queue_size}) int32")
        if self.device.type == "cpu":
            return self.plain(board, queue)
        if self.device.type != "cuda":
            raise ValueError(f"no mask kernel for device {self.device}")
        if not (board.is_contiguous() and queue.is_contiguous()):
            raise ValueError("board and queue must be contiguous")
        out = torch.empty(
            (n, cfg.queue_size * cfg.num_cells), dtype=torch.bool,
            device=self.device,
        )
        stream = torch.cuda.current_stream(self.device).cuda_stream
        with torch.cuda.device(self.device):
            err = _build.library().bp_mask(
                board.data_ptr(), queue.data_ptr(),
                self.piece_table.data_ptr(), out.data_ptr(),
                n, cfg.height, cfg.width, cfg.queue_size, self.num_pieces,
                self.piece_table.shape[1] - 3, stream,
            )
        _build.check(err, "bp_mask")
        self.launches += 1
        return out
