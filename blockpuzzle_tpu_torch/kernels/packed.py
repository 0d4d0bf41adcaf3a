"""Packed-board kernels: CUDA kernels (``csrc/packed_apply.cu``,
``csrc/packed_mask.cu``) and their plain versions.

The packed engine holds each board as (N, H) row words: bit w of word r is
cell (r, w).  The JAX package keeps them as uint32; the port keeps the same
integers in int64 on every device (torch's CPU uint32 has no shifts, no
``>`` and no ``~``), and the kernels compute in 32-bit registers.  Every
left shift of the plain versions is masked to 32 bits wherever JAX's uint32
would wrap.

These kernels have no Pallas source: the JAX package runs its packed step
in jnp (``blockpuzzle_tpu/env/core.py``).

* ``PackedApplyKernel``: the chosen action's footprint words
  (``_cover_words``), the overlap test, the masked place and the
  simultaneous clear of every full row, column and region with k counted
  (``_clear_scan_packed``), as the packed branch of ``step`` does.  An
  illegal action is a strict no-op with k = 0.
* ``PackedMaskKernel``: the hand mask from the words
  (``_bitboard_mask_from_words``): anchor (r, c) of slot s is legal iff the
  slot holds a piece, ``c + piece_w <= W`` and, for every footprint word k,
  ``wks_k(r) & ((prow[pid][k] << c) & cmask[c]) == 0``, where ``wks_k(r)``
  ORs board rows ``r + k*fpw + j`` into field j and rows past the bottom
  read as full.

``bitboard_tables`` builds the footprint tables of both, as the JAX engine
builds them.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from blockpuzzle_tpu_torch import rules
from blockpuzzle_tpu_torch.config import EnvConfig
from blockpuzzle_tpu_torch.kernels import _build

U32 = 0xFFFFFFFF
# board rows the kernels take: one lane per row, a warp's 32 at most
MAX_ROWS = 32
# rows and columns of the largest piece the bit-row u8 mask and legality
# take (their unrolled loops; csrc/mask.cu, csrc/legality.cu kMaxPiece)
MAX_PIECE = 8


def segments_per_warp(height: int) -> int:
    """Envs (apply, clear) or env-slots (mask) per warp: each takes one
    segment of H lanes, a lane per board row."""
    if not 1 <= height <= MAX_ROWS:
        raise ValueError(f"the packed kernels take 1 <= H <= {MAX_ROWS}")
    return 32 // height


def row_launch_shape(cfg: EnvConfig):
    """(segments a warp, warps a block) of ``cfg``'s row-word kernels (the
    packed ones and the bit-row u8 mask, clear and apply), or None where a row
    does not fit a lane's 32-bit word or the board has more than 32 rows
    (the packed plain versions still run on the CPU; the u8 wrappers pick
    their general kernels); computed once per wrapper, off the step's host
    path."""
    if cfg.height > MAX_ROWS or cfg.width > 32:
        return None
    return segments_per_warp(cfg.height), mask_block_warps(cfg.height, cfg.width)


def mask_block_warps(height: int, width: int) -> int:
    """Warps per block of the mask kernels (and the bit-row clear and
    apply): the
    fewest, and at least 4, for which the block's output (warps * 32 // H
    env-slots of H*W bytes) is a multiple of 16 bytes, so that every
    block's span starts on a 16-byte boundary.  16 warps always are."""
    per_warp = segments_per_warp(height)
    return next(w for w in range(4, 17) if w * per_warp * height * width % 16 == 0)


@dataclasses.dataclass(frozen=True)
class BitboardTables:
    """Host tables of the bitboard formulation (``core.py`` ``__init__``).

    fpw: row fields per 32-bit word (``max(1, 32 // W)``).
    nwords: words per piece footprint (``ceil(max_h / fpw)``).
    prow: (P, nwords) footprint words; word k holds piece rows
      ``k*fpw .. k*fpw + fpw - 1``, each as a W-bit field.
    cmask: (W,) per-anchor-column masks keeping the bits >= c of every
      field, which strips what a left shift by c spills into the next field.
    piece_w: (P,) piece widths.
    """

    fpw: int
    nwords: int
    prow: np.ndarray
    cmask: np.ndarray
    piece_w: np.ndarray


def bitboard_tables(cfg: EnvConfig) -> BitboardTables:
    if cfg.width > 32:
        raise ValueError("packed boards need width <= 32")
    t = rules.tables_for(cfg)
    w = cfg.width
    fpw = max(1, 32 // w)
    nwords = -(-t.max_h // fpw)
    prow = (
        t.pieces.astype(np.uint64) * (1 << np.arange(t.max_w, dtype=np.uint64))
    ).sum(axis=2)                                        # (P, max_h) row masks
    packed = np.zeros((t.num_pieces, nwords), dtype=np.uint64)
    for i in range(t.max_h):
        packed[:, i // fpw] |= prow[:, i] << np.uint64((i % fpw) * w)
    field = np.uint64((1 << w) - 1)
    cmask = np.zeros(w, dtype=np.uint64)
    for c in range(w):
        keep = field & ~np.uint64((1 << c) - 1)
        for j in range(fpw):
            cmask[c] |= keep << np.uint64(j * w)
    return BitboardTables(
        fpw=fpw, nwords=nwords, prow=packed.astype(np.uint32),
        cmask=cmask.astype(np.uint32), piece_w=t.piece_w.astype(np.int32),
    )


# ---------------------------------------------------------------------------
# layout helpers
# ---------------------------------------------------------------------------


def pack_words(cells: torch.Tensor) -> torch.Tensor:
    """(N, H, W) 0/1 cells -> (N, H) int64 row words."""
    w = cells.shape[-1]
    pow2 = torch.ones(w, dtype=torch.int64, device=cells.device) << torch.arange(
        w, device=cells.device)
    return (cells.to(torch.int64) * pow2).sum(dim=-1)


def unpack_words(words: torch.Tensor, width: int) -> torch.Tensor:
    """(N, H) int64 row words -> (N, H, W) uint8 cells."""
    shift = torch.arange(width, dtype=torch.int64, device=words.device)
    return ((words[:, :, None] >> shift) & 1).to(torch.uint8)


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    shift = torch.arange(32, dtype=torch.int64, device=x.device)
    return ((x[:, None] >> shift) & 1).sum(dim=1)


# ---------------------------------------------------------------------------
# chosen-action apply
# ---------------------------------------------------------------------------


def cover_words_plain(
    attrs: torch.Tensor, r: torch.Tensor, c: torch.Tensor, height: int
) -> torch.Tensor:
    """(N, H) int64 footprint words of the chosen action (``_cover_words``):
    each of the <= 2 rectangles of the attrs row ``[h, w, cells, dr1, dc1,
    h1, w1, dr2, dc2, h2, w2]`` is a shifted ``2^rw - 1`` row mask on its
    rows.  A zero rectangle gives zero words."""
    a = attrs.to(torch.int64)
    r, c = r.to(torch.int64)[:, None], c.to(torch.int64)[:, None]
    rows = torch.arange(height, dtype=torch.int64, device=attrs.device)[None, :]
    cover = torch.zeros((attrs.shape[0], height), dtype=torch.int64,
                        device=attrs.device)
    for j in range(2):
        dr, dc, rh, rw = (a[:, 3 + 4 * j + i, None] for i in range(4))
        r0 = r + dr
        rowmask = (((torch.ones_like(rw) << rw) - 1) << (c + dc)) & U32
        inrows = (rows >= r0) & (rows < r0 + rh)
        cover = cover | torch.where(inrows, rowmask, 0)
    return cover


def clear_packed_plain(
    words: torch.Tensor, cfg: EnvConfig
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Simultaneous clear on (N, H) int64 words (``_clear_scan_packed``):
    rows equal to ``2^W - 1``, columns set in the AND of all rows (counted
    by popcount), and, with ``region_clear``, every full aligned
    region; all are found on the input, then cleared in one AND-NOT.
    Returns (cleared (N, H) int64, k (N,) int32)."""
    n, h = words.shape
    w = cfg.width
    full = (1 << w) - 1
    full_row = words == full
    colbits = words[:, 0]
    for i in range(1, h):
        colbits = colbits & words[:, i]
    k = full_row.sum(dim=1) + _popcount32(colbits)
    clearbits = torch.where(full_row, full, 0) | colbits[:, None]
    if cfg.region_clear:
        rs = cfg.region_size
        bands = []
        for a in range(h // rs):
            band = words[:, a * rs]
            for i in range(1, rs):
                band = band & words[:, a * rs + i]
            regrow = torch.zeros_like(band)
            for b in range(w // rs):
                tile = ((1 << rs) - 1) << (b * rs)
                fullt = (band & tile) == tile
                regrow = regrow | torch.where(fullt, tile, 0)
                k = k + fullt
            bands.append(regrow[:, None].expand(n, rs))
        clearbits = clearbits | torch.cat(bands, dim=1)
    return words & ~clearbits, k.to(torch.int32)


def packed_apply_plain(
    words: torch.Tensor,
    attrs: torch.Tensor,
    r: torch.Tensor,
    c: torch.Tensor,
    valid: torch.Tensor,
    cfg: EnvConfig,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain torch version: the packed branch of the JAX ``step``, in its
    order.  Returns (words_next, k (N,) int32, legal (N,) bool)."""
    cover = cover_words_plain(attrs, r, c, cfg.height)
    overlap = ((words & cover) != 0).any(dim=1)
    legal = valid & ~overlap
    placed = torch.where(legal[:, None], words | cover, words)
    cleared, k = clear_packed_plain(placed, cfg)
    k = torch.where(legal, k, 0).to(torch.int32)
    return torch.where(legal[:, None], cleared, words), k, legal


class PackedApplyKernel:
    """Config-bound packed collision + place + clear on one device, the
    card unless asked for another.

    ``__call__(words (N, H) int64, attrs (N, 11) int32, r (N,) int32,
    c (N,) int32, valid (N,) bool) -> (words_next, k, legal)``.  For CPU
    tensors it runs ``packed_apply_plain``; for CUDA tensors it launches
    the kernel (``launches`` counts those launches) or raises.
    """

    def __init__(self, cfg: EnvConfig, device="cuda"):
        if cfg.width > 32:
            raise ValueError("packed boards need width <= 32")
        self.cfg = cfg
        self.device = _build.resolve_device(device)
        self.launches = 0
        self.shape = row_launch_shape(cfg)

    def plain(self, words, attrs, r, c, valid):
        return packed_apply_plain(words, attrs, r, c, valid, self.cfg)

    def __call__(
        self,
        words: torch.Tensor,
        attrs: torch.Tensor,
        r: torch.Tensor,
        c: torch.Tensor,
        valid: torch.Tensor,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        n = words.shape[0]
        for x in (words, attrs, r, c, valid):
            if x.device != self.device:
                raise ValueError(
                    f"tensor on {x.device}, kernel tables on {self.device}"
                )
        if words.shape != (n, cfg.height) or words.dtype != torch.int64:
            raise ValueError(f"words must be (N, {cfg.height}) int64")
        if attrs.shape != (n, 11) or attrs.dtype != torch.int32:
            raise ValueError("attrs must be (N, 11) int32")
        for x in (r, c):
            if x.shape != (n,) or x.dtype != torch.int32:
                raise ValueError("r and c must be (N,) int32")
        if valid.shape != (n,) or valid.dtype != torch.bool:
            raise ValueError("valid must be (N,) bool")
        if self.device.type == "cpu":
            return self.plain(words, attrs, r, c, valid)
        if self.device.type != "cuda":
            raise ValueError(f"no packed apply kernel for device {self.device}")
        if self.shape is None:
            raise ValueError(f"the packed kernels take H <= {MAX_ROWS}")
        if not all(x.is_contiguous() for x in (words, attrs, r, c, valid)):
            raise ValueError("words, attrs, r, c and valid must be contiguous")
        words_next = torch.empty_like(words)
        k = torch.empty(n, dtype=torch.int32, device=self.device)
        legal = torch.empty(n, dtype=torch.bool, device=self.device)
        stream = torch.cuda.current_stream(self.device).cuda_stream
        with torch.cuda.device(self.device):
            err = _build.library().bp_packed_apply(
                words.data_ptr(), attrs.data_ptr(), r.data_ptr(), c.data_ptr(),
                valid.data_ptr(), words_next.data_ptr(), k.data_ptr(),
                legal.data_ptr(), n, cfg.height, cfg.width,
                cfg.region_size if cfg.region_clear else 0, self.shape[0], stream,
            )
        _build.check(err, "bp_packed_apply")
        self.launches += 1
        return words_next, k, legal


# ---------------------------------------------------------------------------
# hand mask
# ---------------------------------------------------------------------------


def packed_mask_plain(
    words: torch.Tensor,
    queue: torch.Tensor,
    prow: torch.Tensor,
    piece_w: torch.Tensor,
    cmask: torch.Tensor,
    cfg: EnvConfig,
    max_h: int,
) -> torch.Tensor:
    """Plain torch version (``_bitboard_legal_slots`` with its mask);
    returns (N, S*HW) bool, slot-major then row-major anchor.

    ``prow``: (P + 1, nwords) int64 footprint words and ``piece_w``:
    (P + 1,) int64 widths, each with a zero row for the empty sentinel P;
    ``cmask``: (W,) int64.  Ids outside ``[0, P)`` read as empty slots."""
    n, h = words.shape
    w = cfg.width
    fpw = max(1, 32 // w)
    num_pieces = prow.shape[0] - 1
    padded = torch.cat(
        [words, words.new_full((n, max_h - 1), (1 << w) - 1)], dim=1)
    wks = []
    for k in range(prow.shape[1]):
        wk = torch.zeros_like(words)
        for j in range(fpw):
            i = k * fpw + j
            if i >= max_h:
                break
            wk = wk | ((padded[:, i : i + h] << (j * w)) & U32)
        wks.append(wk)
    cols = torch.arange(w, dtype=torch.int64, device=words.device)
    masks = []
    for s in range(queue.shape[1]):
        pid = queue[:, s]
        idx = torch.where((pid >= 0) & (pid < num_pieces), pid, num_pieces).to(
            torch.int64)
        pr, pw = prow[idx], piece_w[idx]
        acc = torch.zeros((n, h, w), dtype=torch.int64, device=words.device)
        for k, wk in enumerate(wks):
            shifted = ((pr[:, k : k + 1] << cols) & U32) & cmask       # (N, W)
            acc = acc | (wk[:, :, None] & shifted[:, None, :])
        ok_col = cols + pw[:, None] <= w                              # (N, W)
        legal = (acc == 0) & ok_col[:, None, :] & (idx < num_pieces)[:, None, None]
        masks.append(legal.reshape(n, h * w))
    return torch.cat(masks, dim=1)


class PackedMaskKernel:
    """Config-bound packed hand mask on one device, the card unless asked
    for another.

    ``__call__(words (N, H) int64, queue (N, S) int32) -> (N, S*HW) bool``,
    in the order of ``MaskKernel``'s output.  For CPU tensors it runs
    ``packed_mask_plain``; for CUDA tensors it launches the kernel
    (``launches`` counts those launches) or raises.
    """

    def __init__(self, cfg: EnvConfig, device="cuda"):
        t = rules.tables_for(cfg)
        bb = bitboard_tables(cfg)
        self.cfg = cfg
        self.device = _build.resolve_device(device)
        self.num_pieces = t.num_pieces
        self.max_h = t.max_h
        self.tables = bb
        self.launches = 0
        self.shape = row_launch_shape(cfg)
        dev = self.device
        zero = np.zeros((1, bb.nwords), np.int64)
        # plain version: int64 tables with a zero row at the sentinel P
        self.prow = torch.as_tensor(
            np.concatenate([bb.prow.astype(np.int64), zero]), device=dev)
        self.piece_w = torch.as_tensor(
            np.append(bb.piece_w, 0).astype(np.int64), device=dev)
        self.cmask = torch.as_tensor(bb.cmask.astype(np.int64), device=dev)
        # kernel: the same bits as 32-bit words (it needs no cmask: see
        # csrc/packed_mask.cu)
        self.prow32 = torch.as_tensor(bb.prow.view(np.int32), device=dev)
        self.piece_w32 = torch.as_tensor(bb.piece_w, device=dev)

    def plain(self, words: torch.Tensor, queue: torch.Tensor) -> torch.Tensor:
        return packed_mask_plain(words, queue, self.prow, self.piece_w,
                                 self.cmask, self.cfg, self.max_h)

    def __call__(self, words: torch.Tensor, queue: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        n = words.shape[0]
        if words.device != self.device or queue.device != self.device:
            raise ValueError(
                f"tensors on {words.device}/{queue.device}, kernel tables on "
                f"{self.device}"
            )
        if words.shape != (n, cfg.height) or words.dtype != torch.int64:
            raise ValueError(f"words must be (N, {cfg.height}) int64")
        if queue.shape != (n, cfg.queue_size) or queue.dtype != torch.int32:
            raise ValueError(f"queue must be (N, {cfg.queue_size}) int32")
        if self.device.type == "cpu":
            return self.plain(words, queue)
        if self.device.type != "cuda":
            raise ValueError(f"no packed mask kernel for device {self.device}")
        if self.shape is None:
            raise ValueError(f"the packed kernels take H <= {MAX_ROWS}")
        if not (words.is_contiguous() and queue.is_contiguous()):
            raise ValueError("words and queue must be contiguous")
        out = torch.empty(
            (n, cfg.queue_size * cfg.num_cells), dtype=torch.bool,
            device=self.device,
        )
        if out.data_ptr() % 16:  # the kernel stores 16-byte vectors
            raise RuntimeError("mask output is not 16-byte aligned")
        stream = torch.cuda.current_stream(self.device).cuda_stream
        with torch.cuda.device(self.device):
            err = _build.library().bp_packed_mask(
                words.data_ptr(), queue.data_ptr(), self.prow32.data_ptr(),
                self.piece_w32.data_ptr(), out.data_ptr(), n, cfg.height,
                cfg.width, cfg.queue_size, self.num_pieces, self.tables.nwords,
                self.tables.fpw, *self.shape, stream,
            )
        _build.check(err, "bp_packed_mask")
        self.launches += 1
        return out
