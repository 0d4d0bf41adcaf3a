"""Simultaneous line clear: CUDA kernels (``csrc/clear.cu``) and their
plain version.

The port of ``ClearScanKernel`` (``blockpuzzle_tpu/kernels/clear.py``):
every full row, column (and 3x3 region) of the board is found first and
then all are cleared at once; ``k`` counts them.  There is no legality
gate: a line that was full on the input is cleared too.  The line tables
live here, as ``_line_table`` does in the JAX package, and the apply
kernel (``collision.py``) shares them.

Six kernels compute it: the bit-row kernel, for boards of at most 32
rows of at most 32 cells (every shipped preset), tests lines on 32-bit row
words; the wide kernel does the same on rows of 33 to 128 cells held as
two to four words; the tall kernel on boards of 33 to 128 rows of at most
128 cells, a warp an env and up to four rows a lane; the deep kernel on
taller boards of at most 128 cells a row, a warp an env walking the board
in windows of 32 rows; the xwide kernel on boards of any height of 129 to
4096 cells a row, a segment of lanes an env, a lane a word of every row
(above 1024 cells one env a warp, a lane up to four words) and the rows in
windows of 32; the general kernel walks ``line_cell_table`` and takes any
other board whose board and line flags fit one warp's shared memory
(``general_warps``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from blockpuzzle_tpu_torch import rules
from blockpuzzle_tpu_torch.config import EnvConfig
from blockpuzzle_tpu_torch.kernels import _build
from blockpuzzle_tpu_torch.kernels.packed import (
    SMEM_OPT_IN, SUFFIX, clear_launch_shape, count_launch, u8_instance, u8_kind,
)

# warps a block of the general clear and apply, one env each
GENERAL_WARPS = 4


def general_warps(num_cells: int, num_lines: int) -> int:
    """Warps a block of the general clear and apply kernels (``bp_clear``,
    ``bp_apply``), each warp holding an env's board and a flag a line
    (``num_cells + num_lines`` bytes of shared memory): ``GENERAL_WARPS``, or
    the most that fit what a block may opt in to; 0 where one warp's do not
    (the kernels refuse such a board).  ``csrc/clear_lines.cuh``
    ``general_warps`` makes the same choice."""
    return min(GENERAL_WARPS, SMEM_OPT_IN // (num_cells + num_lines))


def check_general_fits(cfg: EnvConfig, num_lines: int) -> None:
    """Raise where the general clear and apply cannot stage one env of
    ``cfg`` (``general_warps`` is 0): a board of more than about 232,000
    cells, whose rule table alone takes at least 5 HW^2 bytes."""
    if general_warps(cfg.num_cells, num_lines) == 0:
        raise ValueError(
            f"board of {cfg.num_cells} cells is too large: its {num_lines} line flags and "
            f"cells pass the {SMEM_OPT_IN} bytes of shared memory a block may use")


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
    (``masks``) and the kernels' (``line_cells``, ``line_len``), for a board
    of any size (the general kernels' limit is checked where they run,
    ``check_general_fits``)."""

    def __init__(self, cfg: EnvConfig, device):
        masks = line_masks(cfg)
        cells, lens = line_cell_table(masks)
        self.masks = torch.as_tensor(masks.astype(np.float32), device=device)
        self.line_cells = torch.as_tensor(cells, device=device)
        self.line_len = torch.as_tensor(lens, device=device)


class ClearScanKernel:
    """Config-bound simultaneous clear on one device, the card unless asked
    for another.

    ``__call__(board (N, HW) u8) -> (cleared (N, HW) u8, k (N,) i32)``.
    For CPU tensors it runs ``clear_plain``; for CUDA tensors it launches a
    kernel or raises.  The kernel is picked here, by shape (``kind``): the
    bit-row kernel where H <= 32 and W <= 32 (``launches`` counts its
    launches), the wide kernel where H <= 32 and 32 < W <= 128 (``wide`` is
    True; ``wide_launches``), the tall kernel where 32 < H <= 128 and
    W <= 128 (``tall_launches``), the deep kernel where H > 128 and
    W <= 128 (``deep_launches``: a warp an env over windows of 32 rows, or
    of 32 - 32 mod rs with regions of size rs, on the deep mask's launch
    shape, ``deep_launch_shape``), the xwide kernel where
    128 < W <= 1024 at any height (``xwide_launches``: a segment of
    ceil(W / 32) lanes an env, a lane a word of every row, the rows in
    windows of 32, or of 32 - 32 mod rs with regions, on the xwide mask's
    launch shape), and its long-row instance where 1024 < W <= 4096 at any
    height (``kind`` "xwide", ``instance`` "xwide_long",
    ``xwide_long_launches``: one env a warp, lane l holding words l + 32 j
    of every row); ``shape`` is the launch shape of any of them
    (``clear_launch_shape``).  Else the general kernel (``shape`` is None;
    ``general_launches``): rows of more than 4096 cells, or a deep or xwide
    board whose one-warp block does not fit shared memory; it takes every
    such board whose cells and lines fit one warp's shared memory
    (``general_warps``) and the wrapper refuses the rest at construction.
    ``name`` is the picked instance's.

    The bit-row, wide, tall, deep and xwide kernels take the engine's
    boards, whose cells are 0 or 1 (``env/state.py``): they find a line full
    when every cell is nonzero and write the cleared board as 0/1 cells.  On such boards that
    is ``clear_plain``'s test (the line's cells sum to its length) and
    output.
    """

    def __init__(self, cfg: EnvConfig, device="cuda"):
        self.cfg = cfg
        self.device = _build.resolve_device(device)
        self.launches = self.wide_launches = self.tall_launches = 0
        self.deep_launches = self.xwide_launches = self.general_launches = 0
        self.xwide_long_launches = 0
        self.shape = clear_launch_shape(cfg)
        self.kind = u8_kind(cfg, self.shape)
        self.instance = u8_instance(cfg, self.kind)
        self.wide = self.kind == "wide"
        self.name = "clear" + SUFFIX[self.instance]
        self.lines = LineTables(cfg, self.device)
        if self.shape is None:
            check_general_fits(cfg, self.lines.line_cells.shape[0])

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
                name = "bp_clear_rows" if self.kind == "rows" else "bp_clear" + SUFFIX[self.kind]
                err = getattr(lib, name)(
                    board.data_ptr(), cleared.data_ptr(), k.data_ptr(), n,
                    cfg.height, cfg.width,
                    cfg.region_size if cfg.region_clear else 0, *self.shape,
                    stream,
                )
        _build.check(err, name)
        count_launch(self, kind=self.instance)
        return cleared, k
