"""Hand action mask: CUDA kernels (``csrc/mask.cu``) and their plain version.

The port of ``blockpuzzle_tpu/kernels/mask.py`` (``MaskKernel``).  Anchor
(r, c) of slot s is legal iff the slot holds a piece, the piece lies in
bounds there and covers no occupied (nonzero) cell; the result is the
engine's ``action_mask``: (N, S*HW) bool, slot-major then row-major anchor.
It is the legality map of ``collision.py`` read at each slot's piece.

Six kernels compute it: the bit-row kernel, for boards of at most 32
rows of at most 32 cells and pieces of at most 8 rows and 8 columns (every
shipped preset and piece set), tests each anchor row's cells at once on a
32-bit row word, from the piece table ``piece_rows_table``; the wide
kernel does the same on rows of 33 to 128 cells held as two to four words;
the tall kernel on boards of 33 to 128 rows of at most 128 cells, a warp
an env-slot and up to four rows a lane; the deep kernel on boards of more
than 128 rows of at most 128 cells, a warp an env-slot walking the board
in windows of 32 rows, wherever a block of one warp with its boards fits
the shared memory a block may opt in to; the xwide kernel on boards of
any height of 129 to 4096 cells a row, a segment of lanes an env-slot and
a lane a word of every row (above 1024 cells one env-slot a warp, a lane
up to four words), wherever a block of one warp fits; the general kernel,
a thread per anchor over ``collision.piece_table``, takes what is left:
rows of more than 4096 cells, pieces of more than 8 rows or columns (no
shipped piece set has one), or a deep or xwide board too large for one
warp's shared memory.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from blockpuzzle_tpu_torch import rules
from blockpuzzle_tpu_torch.config import EnvConfig
from blockpuzzle_tpu_torch.kernels import _build
from blockpuzzle_tpu_torch.kernels.collision import (
    legality_plain, piece_rows_table, piece_table,
)
from blockpuzzle_tpu_torch.kernels.packed import (
    MAX_PIECE, SUFFIX, count_launch, u8_instance, u8_kind, u8_launch_shape,
)


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
    """Config-bound hand mask on one device, the card unless asked for
    another.

    ``__call__(board (N, HW) u8, queue (N, S) i32) -> (N, S*HW) bool``.
    For CPU tensors it runs ``mask_plain``; for CUDA tensors it launches a
    kernel or raises.  The kernel is picked here, by shape (``kind``), where
    no piece spans more than ``MAX_PIECE`` rows or columns: the bit-row
    kernel where H <= 32 and W <= 32 (``launches`` counts its launches), the
    wide kernel where H <= 32 and 32 < W <= 128 (``wide`` is True;
    ``wide_launches``), the tall kernel where 32 < H <= 128 and W <= 128
    (``tall_launches``), the deep kernel where H > 128 and W <= 128 and a
    block of one warp fits (``deep_launches``), the xwide kernel where
    128 < W <= 1024, at any height where a block of one warp fits
    (``xwide_launches``: a segment of ceil(W / 32) lanes an env-slot, a lane
    a word of every row), and its long-row instance where 1024 < W <= 4096
    (``kind`` "xwide", ``instance`` "xwide_long", ``xwide_long_launches``:
    one env-slot a warp, lane l holding words l + 32 j of every row);
    ``shape`` is the launch shape of any of them (``u8_launch_shape``).
    Else the general kernel (``shape`` is None; ``general_launches``): rows
    of more than 4096 cells, larger pieces, or a deep or xwide board whose
    one-warp block does not fit.  ``name`` is the picked instance's.  The
    clear (``ClearScanKernel``) picks its own kernel by the same board
    shapes, so the two kinds differ only where pieces are larger than 8.
    The plain version's (HW, P*HW) footprint table, ``cover_t``, is built
    at its first use (4 P HW^2 bytes: 1.4 GB on 2x4128).
    """

    def __init__(self, cfg: EnvConfig, device="cuda"):
        t = rules.tables_for(cfg)
        self.cfg = cfg
        self.device = _build.resolve_device(device)
        self.num_pieces = t.num_pieces
        self.max_h, self.max_w = t.max_h, t.max_w
        self.launches = self.wide_launches = self.tall_launches = 0
        self.deep_launches = self.xwide_launches = self.general_launches = 0
        self.xwide_long_launches = 0
        fits = max(t.max_h, t.max_w) <= MAX_PIECE
        self.shape = u8_launch_shape(cfg) if fits else None
        self.kind = u8_kind(cfg, self.shape)
        self.instance = u8_instance(cfg, self.kind)
        self.wide = self.kind == "wide"
        self.name = "mask" + SUFFIX[self.instance]
        table = piece_table(cfg) if self.shape is None else piece_rows_table(cfg)
        self.piece_table = torch.as_tensor(table, device=self.device)
        self.valid = torch.as_tensor(t.valid, device=self.device)

    @functools.cached_property
    def cover_t(self) -> torch.Tensor:
        return torch.as_tensor(
            rules.tables_for(self.cfg).cover.T.astype(np.float32), device=self.device
        )

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
                name = "bp_mask_rows" if self.kind == "rows" else "bp_mask" + SUFFIX[self.kind]
                err = getattr(lib, name)(
                    board.data_ptr(), queue.data_ptr(),
                    self.piece_table.data_ptr(), out.data_ptr(),
                    n, cfg.height, cfg.width, cfg.queue_size, self.num_pieces,
                    self.max_h, self.max_w, *self.shape, stream,
                )
        _build.check(err, name)
        count_launch(self, kind=self.instance)
        return out
