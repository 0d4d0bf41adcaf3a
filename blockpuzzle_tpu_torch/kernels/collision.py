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

Each has two kernels: a bit-row kernel, for boards of at most 32 rows of at
most 32 cells (every shipped preset; the legality also wants pieces of at
most 8 rows and columns), which works on 32-bit row words, and the general
kernel, which takes any other board.  ``piece_table`` is the per-piece
footprint table of the general legality and mask kernels,
``legality_rows_table`` the bit-row legality's.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from blockpuzzle_tpu_torch import rules
from blockpuzzle_tpu_torch.config import EnvConfig
from blockpuzzle_tpu_torch.kernels import _build
from blockpuzzle_tpu_torch.kernels.clear import LineTables, clear_plain
from blockpuzzle_tpu_torch.kernels.packed import (
    MAX_PIECE, MAX_ROWS, row_launch_shape, segments_per_warp,
)

# the bit-row legality's block and the words of one row of its shape table,
# blockDim + 8 (csrc/legality.cu kRowWarps, kPad), and the shared memory a
# launch gets without opting in to more
LEGALITY_WARPS = 4
SHAPE_STRIDE = 32 * LEGALITY_WARPS + 8
_MAX_SMEM = 48 * 1024


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


def _shape_bit(rh: int, rw: int) -> int:
    return 8 * (rh - 1) + rw - 1


def rect_shapes(cfg: EnvConfig) -> int:
    """The rectangle shapes (rh, rw) of ``cfg``'s pieces (``piece_rects``)
    as a 64-bit set: bit ``8 * (rh - 1) + rw - 1``.  The bit-row legality
    kernel keeps one table row per shape, in the order of the bits."""
    rects = rules.tables_for(cfg).piece_rects.reshape(-1, 4)
    return sum({1 << _shape_bit(rh, rw) for _, _, rh, rw in rects.tolist() if rh})


def legality_smem_bytes(cfg: EnvConfig, per_block: int) -> int:
    """Shared memory of one block of the bit-row legality kernel
    (``legality_rows_smem``, csrc/legality.cu): P piece rows of 4 words,
    ``per_block * P * H`` legal words, a row of ``SHAPE_STRIDE`` words per
    rectangle shape, rounded up to 16 bytes, and the staged boards."""
    t = rules.tables_for(cfg)
    nshapes = bin(rect_shapes(cfg)).count("1")
    words = (4 * t.num_pieces + per_block * t.num_pieces * cfg.height
             + nshapes * SHAPE_STRIDE)
    return (4 * words + 15) // 16 * 16 + per_block * cfg.num_cells + 32


def legality_launch_shape(cfg: EnvConfig):
    """(envs a warp, warps a block) of the bit-row legality kernel, or None
    where the general kernel runs: a board of more than 32 rows or cells a
    row, a piece of more than ``MAX_PIECE`` rows or columns, or a piece set
    whose block would not fit the shared memory of a plain launch.  The
    block is always ``LEGALITY_WARPS`` warps: its output span, ``envs * P *
    H * W`` bytes, starts on a 16-byte boundary only by chance (P * H * W
    is 1539 on woodoku), so the kernel's store takes any start."""
    t = rules.tables_for(cfg)
    if cfg.height > MAX_ROWS or cfg.width > 32 or max(t.max_h, t.max_w) > MAX_PIECE:
        return None
    per_warp = segments_per_warp(cfg.height)
    if legality_smem_bytes(cfg, LEGALITY_WARPS * per_warp) > _MAX_SMEM:
        return None
    return per_warp, LEGALITY_WARPS


def legality_rows_table(cfg: EnvConfig) -> np.ndarray:
    """(P, 4) int32 rows ``[h, anchor column mask, rect 1, rect 2]`` of the
    bit-row legality kernel.  The mask keeps the anchor columns c with
    ``c + w <= W``: ``2^(W - w + 1) - 1``, or 0.  Each rectangle of
    ``piece_rects`` is ``row * SHAPE_STRIDE + dr | dc << 16``: ``row`` the
    place of its shape (rh, rw) among ``rect_shapes``' bits; a piece of one
    rectangle names it twice."""
    t = rules.tables_for(cfg)
    shapes = rect_shapes(cfg)
    table = np.zeros((t.num_pieces, 4), np.int64)
    for p, rects in enumerate(t.piece_rects.reshape(-1, 2, 4).tolist()):
        words = []
        for dr, dc, rh, rw in rects:
            if rh:
                row = bin(shapes & ((1 << _shape_bit(rh, rw)) - 1)).count("1")
                words.append(row * SHAPE_STRIDE + dr | dc << 16)
        anchors = cfg.width - int(t.piece_w[p]) + 1
        table[p] = (t.piece_h[p], (1 << max(anchors, 0)) - 1, words[0], words[-1])
    return table.astype(np.uint32).view(np.int32)


class LegalityKernel:
    """Config-bound all-(piece, anchor) legality on one device, the card
    unless asked for another.

    ``__call__(board (N, HW) u8) -> (N, P, HW) bool``.  For CPU tensors it
    runs ``legality_plain``; for CUDA tensors it launches a kernel or
    raises.  The kernel is picked here, by shape
    (``legality_launch_shape``): the bit-row kernel where H <= 32, W <= 32
    and no piece spans more than ``MAX_PIECE`` rows or columns (``shape``
    is its launch shape; ``launches`` counts its launches), else the
    general kernel (``shape`` is None; ``general_launches`` counts them).

    Both read a cell as occupied when it is nonzero, as ``legality_plain``
    does (a sum of non-negative bytes is 0 iff every byte is).
    """

    def __init__(self, cfg: EnvConfig, device="cuda"):
        t = rules.tables_for(cfg)
        self.cfg = cfg
        self.device = _build.resolve_device(device)
        self.num_pieces = t.num_pieces
        self.max_h, self.max_w = t.max_h, t.max_w
        self.launches = 0
        self.general_launches = 0
        self.shape = legality_launch_shape(cfg)
        self.shapes = rect_shapes(cfg)
        table = piece_table(cfg) if self.shape is None else legality_rows_table(cfg)
        self.piece_table = torch.as_tensor(table, device=self.device)
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
        lib = _build.library()
        with torch.cuda.device(self.device):
            if self.shape is None:
                name = "bp_legality"
                err = lib.bp_legality(
                    board.data_ptr(), self.piece_table.data_ptr(), out.data_ptr(),
                    n, cfg.height, cfg.width, self.num_pieces,
                    self.piece_table.shape[1] - 3, stream,
                )
            else:
                if out.data_ptr() % 16:  # the kernel stores 16-byte vectors
                    raise RuntimeError("legality output is not 16-byte aligned")
                name = "bp_legality_rows"
                err = lib.bp_legality_rows(
                    board.data_ptr(), self.piece_table.data_ptr(), out.data_ptr(),
                    n, cfg.height, cfg.width, self.num_pieces, self.max_h,
                    self.max_w, self.shapes, *self.shape, stream,
                )
        _build.check(err, name)
        if self.shape is None:
            self.general_launches += 1
        else:
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
    CPU tensors it runs ``apply_plain``; for CUDA tensors it launches a
    kernel or raises.  The kernel is picked here, by shape: the bit-row
    kernel where H <= 32 and W <= 32 (``shape`` is its launch shape;
    ``launches`` counts its launches), else the general kernel (``shape``
    is None; ``general_launches`` counts them).

    The bit-row kernel takes boards and covers whose cells are 0 or 1: the
    engine's boards (``env/state.py``) and its footprints
    (``rules.tables_for(cfg).cover``, ``VecBlockPuzzle._cover_cells``).  It
    finds an overlap where a board cell and a cover cell are both nonzero,
    a line full when every placed cell is nonzero, and writes 0/1 cells.
    On such inputs that is ``apply_plain``'s ``board & cover``, byte sums
    and output.  (With a cover byte of 2 over a board byte of 1, ``board &
    cover`` is 0 and the bit-row test an overlap.)
    """

    def __init__(self, cfg: EnvConfig, device="cuda"):
        self.cfg = cfg
        self.device = _build.resolve_device(device)
        self.launches = 0
        self.general_launches = 0
        self.shape = row_launch_shape(cfg)
        self.lines = LineTables(cfg, self.device)

    def plain(self, board, cover, valid):
        return apply_plain(board, cover, valid, self.lines.masks)

    def __call__(
        self, board: torch.Tensor, cover: torch.Tensor, valid: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        n = board.shape[0]
        hw = cfg.num_cells
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
        lib = _build.library()
        with torch.cuda.device(self.device):
            if self.shape is None:
                name = "bp_apply"
                err = lib.bp_apply(
                    board.data_ptr(), cover.data_ptr(), valid.data_ptr(),
                    lines.line_cells.data_ptr(), lines.line_len.data_ptr(),
                    new_board.data_ptr(), k.data_ptr(), legal.data_ptr(),
                    n, hw, lines.line_cells.shape[0], lines.line_cells.shape[1],
                    stream,
                )
            else:
                if new_board.data_ptr() % 16:  # the kernel stores 16-byte vectors
                    raise RuntimeError("apply output is not 16-byte aligned")
                name = "bp_apply_rows"
                err = lib.bp_apply_rows(
                    board.data_ptr(), cover.data_ptr(), valid.data_ptr(),
                    new_board.data_ptr(), k.data_ptr(), legal.data_ptr(), n,
                    cfg.height, cfg.width,
                    cfg.region_size if cfg.region_clear else 0, *self.shape,
                    stream,
                )
        _build.check(err, name)
        if self.shape is None:
            self.general_launches += 1
        else:
            self.launches += 1
        return new_board, k, legal
