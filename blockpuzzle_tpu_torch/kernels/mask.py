"""Hand action mask: CUDA kernels (``csrc/mask.cu``) and their plain version.

The port of ``blockpuzzle_tpu/kernels/mask.py`` (``MaskKernel``).  Anchor
(r, c) of slot s is legal iff the slot holds a piece, the piece lies in
bounds there and covers no occupied (nonzero) cell; the result is the
engine's ``action_mask``: (N, S*HW) bool, slot-major then row-major anchor.
It is the legality map of ``collision.py`` read at each slot's piece.

Two kernels compute it: the bit-row kernel, for boards of at most 32 rows
of at most 32 cells and pieces of at most 8 rows and 8 columns (every
shipped preset and piece set), tests each anchor row's cells at once on a
32-bit row word, from the piece table ``piece_rows_table``; the general
kernel, a thread per anchor over ``collision.piece_table``, takes any other
board.
"""

from __future__ import annotations

import numpy as np
import torch

from blockpuzzle_tpu_torch import rules
from blockpuzzle_tpu_torch.config import EnvConfig
from blockpuzzle_tpu_torch.kernels import _build
from blockpuzzle_tpu_torch.kernels.collision import legality_plain, piece_table
from blockpuzzle_tpu_torch.kernels.packed import MAX_PIECE, row_launch_shape


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


def piece_rows_table(cfg: EnvConfig) -> np.ndarray:
    """(P, 4) int32 rows ``[h, w, rect 1, rect 2]`` of the bit-row kernel:
    each piece's bounding box and its <= 2 rectangles (``piece_rects``),
    each packed as ``dr | dc << 8 | rh << 16 | rw << 24`` (an absent
    rectangle is 0)."""
    t = rules.tables_for(cfg)
    rects = t.piece_rects.reshape(-1, 2, 4).astype(np.int64)
    packed = (rects << np.array([0, 8, 16, 24])).sum(axis=2)
    table = np.stack([t.piece_h, t.piece_w, packed[:, 0], packed[:, 1]], axis=1)
    return table.astype(np.uint32).view(np.int32)


class MaskKernel:
    """Config-bound hand mask on one device, the card unless asked for
    another.

    ``__call__(board (N, HW) u8, queue (N, S) i32) -> (N, S*HW) bool``.
    For CPU tensors it runs ``mask_plain``; for CUDA tensors it launches a
    kernel or raises.  The kernel is picked here, by shape: the bit-row
    kernel where H <= 32, W <= 32 and no piece spans more than
    ``MAX_PIECE`` rows or columns (``shape`` is its launch shape;
    ``launches`` counts its launches), else the general kernel (``shape``
    is None; ``general_launches`` counts them).
    """

    def __init__(self, cfg: EnvConfig, device="cuda"):
        t = rules.tables_for(cfg)
        self.cfg = cfg
        self.device = _build.resolve_device(device)
        self.num_pieces = t.num_pieces
        self.max_h, self.max_w = t.max_h, t.max_w
        self.launches = 0
        self.general_launches = 0
        fits = max(t.max_h, t.max_w) <= MAX_PIECE
        self.shape = row_launch_shape(cfg) if fits else None
        table = piece_table(cfg) if self.shape is None else piece_rows_table(cfg)
        self.piece_table = torch.as_tensor(table, device=self.device)
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
        lib = _build.library()
        with torch.cuda.device(self.device):
            if self.shape is None:
                name = "bp_mask"
                err = lib.bp_mask(
                    board.data_ptr(), queue.data_ptr(),
                    self.piece_table.data_ptr(), out.data_ptr(),
                    n, cfg.height, cfg.width, cfg.queue_size, self.num_pieces,
                    self.piece_table.shape[1] - 3, stream,
                )
            else:
                if out.data_ptr() % 16:  # the kernel stores 16-byte vectors
                    raise RuntimeError("mask output is not 16-byte aligned")
                name = "bp_mask_rows"
                err = lib.bp_mask_rows(
                    board.data_ptr(), queue.data_ptr(),
                    self.piece_table.data_ptr(), out.data_ptr(),
                    n, cfg.height, cfg.width, cfg.queue_size, self.num_pieces,
                    self.max_h, self.max_w, *self.shape, stream,
                )
        _build.check(err, name)
        if self.shape is None:
            self.general_launches += 1
        else:
            self.launches += 1
        return out
