// Whether one piece fits at one anchor of one board: the per-thread test of
// the general mask kernel (mask.cu) and the legality kernel (legality.cu).
//
// `row` is the piece's row of the piece table (kernels/collision.py
// `piece_table`): [h, w, ncells, flat cell offsets dr*W + dc ...].  The
// piece fits at flat anchor (r, c) iff its bounding box lies on the board
// (r + h <= H, c + w <= W) and every board byte under its cells is 0.
#pragma once

#include <cstdint>

__device__ __forceinline__ bool piece_fits(const uint8_t* __restrict__ board,
                                           const int32_t* __restrict__ row,
                                           int anchor, int height,
                                           int width) {
  const int r = anchor / width;
  const int c = anchor - r * width;
  if (r + row[0] > height || c + row[1] > width) return false;
  const uint8_t* cells = board + anchor;
  bool fits = true;
  for (int j = 0; j < row[2]; ++j) fits &= cells[row[3 + j]] == 0;
  return fits;
}
