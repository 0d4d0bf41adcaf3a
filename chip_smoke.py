#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (blockpuzzle_tpu_torch) on one card.

    python3 chip_smoke.py

Needs one CUDA card (compute capability 9.0) and nvcc; builds the kernels
from ``blockpuzzle_tpu_torch/kernels/csrc`` on first use.  Phases, each of
which raises on failure (non-zero exit, no result line):

  0. card name and power limit, torch/CUDA versions, compute capability,
     kernel build time;
  1. each of the forty-two kernels against its plain torch version on
     the card, bit-equal, at N = 49152 and a ragged N = 49151: the three draws
     (deal, uniform_legal, words_select: ``kernels/draws.py``) on the four
     presets, at per-env counters that wrap negative and at shared ones
     up to 2**32 - 1, on the masks and legal words of the boards below
     (empty rows among them; uniform_legal also on mask views that start
     off a 16-byte boundary), every action drawn legal; words_select also
     on the legal words of 33x9, 36x9 with 3x3 regions and a hand of three,
     and 130x8 (``SELECT_BOARDS``: rows of 33, 108 and 130 words), on every
     board also on words 8 bytes past a 16-byte boundary and at every
     segment width of 1 to 32 lanes an env (``select_pick``), its time
     beside its bound on each; the bit-row u8
     kernels (mask, clear, apply, legality) and the packed kernels
     (packed_apply, packed_mask and its words entry packed_legal_words) on
     the default, tenten, woodoku and big presets and on 24x9 (``ROWS24``:
     a warp an env-slot), on boards holding full
     rows, columns and 3x3 regions, packed_legal_words' time beside its
     bound on each; the packed kernels also against the u8
     mask and apply kernels on the unpacked boards, the words against the
     packed mask packed to words; on a board of 8 rows of 40 cells, too
     wide for a row word, the wide mask, clear and apply (mask_wide,
     clear_wide, apply_wide: rows of two words); the wide mask, clear and
     apply also on 8x33, 6x64,
     4x128, 8x100 and 9x36 with 3x3 regions (``WIDE_CASES``), the wide
     apply also against the general apply launched directly (bp_apply);
     on boards of more than 32 rows (``phase1_tall``), the tall packed
     kernels (packed_apply_tall: a warp a board; packed_mask_tall and
     packed_legal_words_tall: a segment of threads an env-slot, eight or
     four anchor rows a thread, also on blocks whose spans start off a 16-byte
     boundary and on warps that stage and store their own env-slots,
     ``ANCHOR_TURN_ENVS``, the last block ragged at N = 49151) on 33x9,
     36x9 with 3x3 regions
     across the lane seam and a hand of three, 64x8 and 128x10
     (``TALL_PACKED_CASES``), the
     tall u8 mask, clear and apply (mask_tall, clear_tall, apply_tall) on
     33x9, 36x9 with regions, 40x40 and 33x128 (``TALL_U8_CASES``; the
     plain u8 mask and apply in chunks of envs there), the packed mask also
     against the u8 one on the unpacked boards, and on boards of more than
     128 rows the deep u8 mask, clear and apply (mask_deep, clear_deep,
     apply_deep: a warp an env-slot or env over windows of 32 rows) and the
     general kernels of the packed engine (packed_apply_general: a warp an
     env over windows of rows, also with each pass 2, packed_mask_general and
     packed_legal_words_general: a warp an env-slot over windows of 32
     rows) on 130x8 (``HUGE``; the general mask, clear and apply,
     mask_general, clear_general and apply_general, launched directly there
     beside the deep ones, and the packed mask's and words' thread-an-
     anchor-row kernels beside their windowed ones), and the deep mask,
     clear and apply and the general packed kernels on 512x8 and 135x9 with
     3x3 regions and a hand of three (``DEEP_CASES``), the tall and deep
     apply, the deep clear and the windowed packed mask and words also held
     to the kernels they replace launched directly on every one of these
     boards; on rows of more than 128 cells (``phase1_xwide``) the xwide
     mask, clear, apply and legality (mask_xwide, clear_xwide, apply_xwide,
     legality_xwide: a segment of lanes an env-slot or env, a lane a word
     of every row) on 8x136 (``XWIDE``) and 40x136 (``XTALL``) at N = 49152
     and 49151 and on 8x160, 9x135 with 3x3 regions across words and a
     hand of three, 3x320 and 2x1024 (``XWIDE_CASES``) and on 33x129,
     36x135 with 3x3 regions and a hand of three and 66x130
     (``XTALL_CASES``, more than 32 rows) at N = 4096 and 4095, each also
     held to the general mask, clear, apply and legality launched
     directly; on rows of more than 1024 cells (``phase1_long``) the
     long-row xwide instances of the mask, clear, apply and legality
     (mask_xwide_long, clear_xwide_long, apply_xwide_long,
     legality_xwide_long: one env or env-slot a warp, lane l holding words
     l + 32 j) on 2x1056 (``W1056``), 3x1030, 2x2048, 9x1035 with 3x3
     regions across the lane-31 border and a hand of three and 33x1025
     (``XLONG_CASES``; the mask and legality there held to the general ones
     alone, their plain tables taking 20 HW^2 bytes each) at N = 4096 and
     4095, each also held to the general kernel launched directly, and the
     four general kernels on 2x4128 (``W4128``); the
     all-pieces legality beyond 32x32
     (``phase1_legality``): the every-piece instances of the wide, tall and
     deep masks (legality_wide, legality_tall, legality_deep) on 8x40, 33x9
     and 130x8 (``LEGALITY_BOARDS``; at N = 4096 and 4095 but on 8x40),
     each also held to the general legality (legality_general) launched
     directly; the
     step's tail (packed_tail: game over,
     truncation, score, auto-reset and both board views in one launch) and
     its unpack entry (packed_unpack) on the default, tenten, 33x9 and 130x8
     boards (``TAIL_BOARDS``: dense boards, ``max_steps`` 9, a terminal
     penalty of -0.3), with and without auto-reset, at the wrapper's tile
     and ring and at a tile of 7 envs, then at the wrapper's tile in a ring
     of one stage and on a grid of one block an SM, floats bit for bit,
     the share of done envs printed; an illegal action on a board holding a full line
     through the u8 apply kernel of every board above and through every
     packed apply; then each kernel's device time (CUDA
     events over 50 launches queued behind a spin kernel, so the host's
     launch time does not enter) beside its bound (``utils/bounds.py``)
     and the plain version's time (50 calls made as the host goes), at N
     = 49152 on the default preset (the wide kernels on the wide board, the
     tall ones on 33x9, the deep ones and the general packed ones on 130x8,
     the xwide mask, clear, apply and legality on 40x136 beside the general
     ones launched directly there, the long-row mask, clear, apply and
     legality on 2x1056, where the wrappers pick them, beside the general
     ones launched directly there, and the general ones on 2x4128, where
     the wrappers pick them),
     and the launch floor (an empty launch's
     device time) beside the deal's; then the wide board's kernels timed
     in turns for 5 rounds, with the general mask, clear, apply and
     legality launched directly on the same inputs and held bit-equal to
     the wide ones
     (``wide_turns``), and the tall mask, clear and apply likewise on 33x9
     and 40x40 (``tall_turns``);
     then the default packed rollout (N = 49152, 64 steps) through the
     draw kernels and with their plain versions swapped in, with the
     argmax and the words sampler (the paths ``draws_argmax`` and
     ``draws_words``): actions, rewards, done flags and final states
     bit-equal;
  2. the whole rollout on CUDA and on CPU from one seed (N = 1024, 64
     steps, live deals, auto-reset) on the default engine, packed wherever
     W <= 32 (every preset; 33x9 and 36x9 with regions through the tall
     packed kernels, the paths ``tall_packed`` and ``tall36r3_packed``;
     64x8 and 128x10, ``tall64_packed`` and ``tall128_packed``; 130x8
     through the general ones, ``huge_packed``, N = 256, 32 steps) and on
     the u8 apply-kernel (``backend="pallas"``) and clear-kernel
     (``backend="jnp"``) steps (every preset; the wide board, where the
     wide mask, clear and apply run: the paths ``wide_u8_pallas`` and
     ``wide_u8_jnp``; 33x9, where the tall mask, clear and apply run:
     ``tall_u8_pallas``, ``tall_u8_jnp``; 36x9 with regions,
     ``tall36r3_u8_jnp``; 130x8, the deep mask, clear and apply:
     ``huge_u8_pallas``, ``huge_u8_jnp``;
     8x136, rows of more than 128 cells, the xwide mask, clear and apply:
     ``xwide_u8_pallas``, ``xwide_u8_jnp``; 40x136, more than 32 rows of
     such rows, the xwide mask, clear and apply there:
     ``xtall_u8_pallas``, ``xtall_u8_jnp``, N = 128, 16 steps; 100x124
     with the five small pieces, whose line tables the wrappers refused
     before, the default engine (the u8 clear-kernel step on its tall
     kernels): ``big100_u8_jnp``, N = 64, 8 steps; 2x1056, rows of
     more than 1024 cells, the long-row mask, apply and clear:
     ``w1056_u8_pallas``, ``w1056_u8_jnp``, N = 256, 32 steps;
     2x4128, rows of more than 4096 cells, the general mask, apply and
     clear: ``w4128_u8_pallas``, ``w4128_u8_jnp``, N = 64, 8 steps), counters set to
     0 before each and read after it: final states and summed rewards
     bit-equal across devices and across the engines, each kernel of an
     engine launched exactly once per step and every other kernel never;
     then ``legal_all_pieces`` on the final boards against its plain
     version and the hand mask (beyond the presets the every-piece
     instance the board takes, the long-row one on 2x1056, the general
     legality on 2x4128: the paths
     ``<board>_legal_all_pieces``); then the words rollout on
     33x9, 36x9 with regions and 130x8 on CUDA against the CPU (the paths
     ``tall_words``, ``tall36r3_words``, ``huge_words``);
  3. the rollout paths: the rollout entry point at N = 49152 on the
     default preset, one warm-up chunk then 5 timed windows of 400 steps,
     on the default (packed) engine and on the apply-kernel step; then the
     inspection entry point ``legal_all_pieces`` on the packed engine's
     final boards.  The launch counters are set to 0 before each and read
     after each;
  4. the training paths: ``cli/train.py`` with the JAX CLI's default flags
     (PPO, conv torso, packed engine) on the default preset, N = 4096,
     T = 64, 3 updates, and with ``--torso mlp --state-impl u8`` (the u8
     clear-kernel step), 2 updates, each with the launch counters set to
     0 before it and read after it; then one rollout of each alone,
     timed; then a fresh network of each at the same widths on CUDA and
     its copy on the CPU over one minibatch of a CUDA rollout;
  5. the oracle parity harness (``cli/parity.py``) on the card: 8 seeded
     oracle episodes (up to 512 steps) replayed one by one and as one
     lockstep batch through the packed engine and the u8 engine on CUDA,
     on every preset, each bit-exact;
  6. DQN: ``cli/train.py --algo dqn`` with the JAX CLI's defaults (conv
     torso, packed engine, N = 4096, buffer 200,000, batch 4096, 4 env
     steps an iteration), 5 iterations (the path ``train_dqn``), and
     ``--torso mlp --state-impl u8 --dueling --n-step 3 --per``, 3
     iterations (``train_dqn_u8``), counters set to 0 before each and read
     after it: the mask kernel launched 5 times an iteration and the apply
     (or clear) kernel 4, the TD steps and buffer fill the warm-up rule
     gives, finite metrics, only legal actions in the replay; env-steps/s
     of training after the first iteration and ms per iteration; a fresh
     Q-network of each (plain, dueling) on CUDA against its CPU copy over
     one batch of 4096 replay rows; a checkpoint of the first
     configuration after 3 iterations restored on the card bit-equal
     (every tensor, host counter and the generator state) and one more
     iteration from it; ``cli/evaluate.py --steps 64`` on the first path's
     checkpoint;
  7. serving: the words rollout (``WordsSampler`` on the legal words of the
     packed mask kernel's words entry, then the packed step) on CUDA and on
     the CPU from one seed (N = 1024, 64 steps, every preset): every
     action, the final states and the summed rewards bit-equal, every
     action legal in its step's bool mask, one launch each of packed_apply,
     packed_mask and packed_legal_words a step; the same rollout timed as
     phase 3 times the argmax one (the path ``rollout_words``), its rate
     beside phase 3's; the autoreset env (``env/autoreset.py``, the
     Gymnasium surface without gymnasium) in each mode, N = 4096, 128
     steps, actions from ``WordsSampler``, a ``reset_mask`` of the dead
     envs every 8 steps under ``disabled``: every presented field and the
     carried state bit-equal on CUDA and the CPU, episodes ending in each
     mode; then each mode's env-steps/s at N = 49152 with the presented
     fields copied to the host in the timed window;
  8. the distributed runtime (``dist/``): two ranks sharing the card over
     gloo (the backend rule: ranks share a card) run ``dist``'s
     all-reduce, all-gather and row gather of CUDA tensors, each held to
     its expected value; then ``cli/train.py --distributed`` as torchrun
     starts it (each rank a spawned process with torchrun's variables):
     PPO with the JAX CLI's defaults (N = 4096, T = 64, 2 updates) and
     DQN with them (buffer 200,000, batch 4096, 3 iterations; a TD step
     from iteration 1) at world 2 (gloo, 2048 envs a rank) and world 1
     (nccl), and ``--torso mlp --state-impl u8 --tp 2`` at world 2 (2
     updates), each against the same flags unsharded in this process:
     every rank's launch counters (set to 0 before the run, read after
     it) at one mask and one apply (clear) launch a step, the metrics and
     every parameter after update 1 within ``tests/test_dist.py``'s
     tolerances (the paths ``train_dist_ppo``, ``train_dist_dqn`` and
     ``train_dist_tp2``: rank 0 of world 2), the first DQN iteration's
     replay bit-equal to the unsharded one's, and the world-2 DQN
     checkpoint restored in one process bit-equal.  Each run's backend
     and global env-steps/s are printed: two processes on one card are a
     correctness run, not a scaling figure;
  9. the measuring entry points (``blockpuzzle_tpu_torch/bench.py``,
     ``scripts/``, ``examples/``): ``bench.bench_device`` at N = 49152 on
     the default, ``pallas``, ``u8`` (clear kernel) and ``words``
     configurations (the paths ``bench``, ``bench_pallas``, ``bench_u8``,
     ``bench_words``; a warm-up chunk and 3 windows of 2 chunks of 400
     steps), each kernel of a path's step launched once a step, the three
     argmax engines' final states bit-equal, the rates beside phase 3's;
     the actor at N = 49152, both torsos (``actor_conv``, ``actor_mlp``)
     and both policies; the learner's ``base`` and ``mlp`` (2 timed
     updates); one sweep config (conv, N = 4096, T = 64, 3 updates and a
     greedy evaluation, the path ``sweep``) twice, the two metrics streams
     compared bit for bit by ``scripts/compare_metrics.py`` in a
     subprocess; the quickstart's engine and train sections;
 10. the last ported pieces: the roofline (``scripts/roofline.py``) of the
     bench's step at N = 49152 (a count pass of 400 steps, then a warm-up
     chunk and 3 windows of 2 chunks of 400; the path ``roofline``), its
     count pass's launches at one B1 and one B7 a step, its shares of the
     HBM, CUDA-core and state floors in (0, 100], and its count on CUDA
     equal to the CPU's at N = 1024 (8 steps); the scaling harness
     (``scripts/bench_scaling.py``: one rank on the card over nccl, two
     ranks sharing it over gloo, 4096 envs a rank, chunks of 50, 3 timed),
     both sizes' gathered final states bit-equal to one process's, and
     ``--cpu-sim``'s 8 CPU ranks at 256 envs a rank; the
     properties of ``tests/test_properties.py`` at batch: 4096 seeded
     (board, piece, cell) triples through the packed, u8 ``jnp`` and u8
     ``pallas`` engines on CUDA (the paths ``properties_packed``,
     ``properties_u8_jnp``, ``properties_u8_pallas``), the mask against
     the oracle's, no full line after a step, the reward zero iff the
     oracle's ``can_place`` refuses the cell.

Every path's counts include the draws: ``deal`` once a step and once an
``init`` (not where ``init`` is given the hand), and the sampler's kernel
(``uniform_legal`` or ``words_select``) once a call; a packed engine's the
tail (``packed_tail``) once a step and the unpack (``packed_unpack``) once
a ``board_obs``: each ``init``, each learner's ``observe``, each
``legal_all_pieces`` call.

The last two lines are the per-kernel JSON record and
``{"ok": true, "device": {...}}``.  A kernel's ``launches`` is the count
on the path named in its ``path``; ``launches_by_path`` gives the count on
every path read.  The packed kernels and the draws have no Pallas source:
their ``replaces`` names the JAX package's jnp code (the argmax draw's the
root ``bench.py``'s).  ``bound_ms`` is the larger
of the bytes the kernel must move (each input read once, each output
written once) over 3.35 TB/s and its integer operations on this run's
inputs over 16.7 T/s (the H100's 32-bit integer rate); ``library_ms`` is null:
no single PyTorch call computes a legal mask (as bools or as row words), a
place-and-clear, a clear-scan, a counter-based draw or a step's
select-reset-unpack tail.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

N_MAIN = 49152
PARITY_SEEDS = 8
PACKED_PRESETS = ("default", "tenten", "woodoku", "big")
# a u8 board too wide for a row word: the wide u8 mask, clear, apply and
# legality (rows of two words)
WIDE = dict(height=8, width=40)
# the other boards of more than 32 cells a row that phase 1 holds the wide
# mask, clear and apply on (tests/test_torch_kernels.py WIDE_CASES): one cell in
# the second word, 32 dividing W, four whole words (pieces of at most 2x2,
# which fit its 4 rows), four words with 4 cells in the top one, and 3x3
# regions whose fields straddle the first two words
WIDE_CASES = {"8x33": dict(height=8, width=33), "6x64": dict(height=6, width=64),
              "4x128": dict(height=4, width=128, piece_set="mini5"),
              "8x100": dict(height=8, width=100),
              "9x36r3": dict(height=9, width=36, region_clear=True, region_size=3,
                             queue_size=3)}
# a board of 17 to 31 rows, where a warp holds one env-slot or env and
# leaves 32 - H lanes idle: the bit-row kernels, the packed words among them
ROWS24 = dict(height=24, width=9)
# boards of more than 32 rows: the tall kernels (a warp a board, rows
# l + 32 j in lane l), the packed engine's by default (W <= 32) and the u8
# mask, clear, apply and legality
TALL = dict(height=33, width=9)
TALL36R3 = dict(height=36, width=9, region_clear=True, region_size=3, queue_size=3)
# the boards phase 1 holds the tall kernels on (tests/test_torch_tall.py):
# packed on two, three and four slots a lane, with 3x3 regions across the
# lane seam (rows 30..32) and a hand of three; u8 on one, two and four words
# a row (40x40: the JAX engine's u8 default there)
TALL_PACKED_CASES = {"33x9": TALL, "36x9r3": TALL36R3, "64x8": dict(height=64, width=8),
                     "128x10": dict(height=128, width=10)}
TALL_U8_CASES = {"33x9": TALL, "36x9r3": TALL36R3, "40x40": dict(height=40, width=40),
                 "33x128": dict(height=33, width=128)}
# a board of more than 128 rows: the deep u8 mask, clear, apply and legality
# (a warp an env-slot or env over windows of 32 rows), the windowed general
# packed apply, mask and words
HUGE = dict(height=130, width=8)
# the other boards of more than 128 rows phase 1 holds the deep mask, clear
# and apply and the general packed kernels on (tests/test_torch_deep.py):
# four times as many
# rows, and 3x3 regions in windows of 30 rows with a hand of three (135x9:
# a block's output span off a 16-byte boundary)
DEEP_CASES = {"512x8": dict(height=512, width=8),
              "135x9r3": dict(height=135, width=9, region_clear=True, region_size=3,
                              queue_size=3)}
# rows of more than 128 cells: the xwide u8 mask, clear, apply and legality
# (a segment of ceil(W / 32) lanes a board, a lane a word of every row; the
# paths ``xwide_u8_pallas`` and ``xwide_u8_jnp``)
XWIDE = dict(height=8, width=136)
# the other boards phase 1 holds the xwide mask, clear and apply on
# (tests/test_torch_xwide.py): whole words, 3x3 regions whose fields
# straddle words (columns 30..32, 63..65) with a hand of three, ten words
# a row and 32 (one segment a warp), the last two with pieces of at most
# 2x2, which fit their rows
XWIDE_CASES = {"8x160": dict(height=8, width=160),
               "9x135r3": dict(height=9, width=135, region_clear=True, region_size=3,
                               queue_size=3),
               "3x320": dict(height=3, width=320, piece_set="mini5"),
               "2x1024": dict(height=2, width=1024, piece_set="mini5")}
# more than 32 rows of more than 128 cells: the xwide u8 mask, clear, apply
# and legality over any height (the clear and apply in windows of 32 rows;
# the paths ``xtall_u8_pallas``, ``xtall_u8_jnp`` and
# ``xtall_legal_all_pieces``, whose launches the kernels line reads)
XTALL = dict(height=40, width=136)
# the other such boards phase 1 holds the xwide mask, clear, apply and
# legality on
# (tests/test_torch_xwide_tall.py): a one-column top word and a bar across
# row 32; 3x3 regions across words and a window border (30 rows) with a
# hand of three; two window borders
XTALL_CASES = {"33x129": dict(height=33, width=129),
               "36x135r3": dict(height=36, width=135, region_clear=True, region_size=3,
                                queue_size=3, piece_set="mini5"),
               "66x130": dict(height=66, width=130, piece_set="mini5")}
# a board of more than 12288 cells and lines, whose line tables the
# wrappers refused before: the default engine there (u8, the tall kernels)
BIG100 = dict(height=100, width=124, piece_set="mini5")
# rows of more than 1024 cells: the u8 xwide kernels' long-row instances,
# one env or env-slot a warp, a lane up to four words (the paths
# ``w1056_u8_pallas``, ``w1056_u8_jnp`` and ``w1056_legal_all_pieces``)
W1056 = dict(height=2, width=1056, piece_set="mini5")
# the other such boards phase 1 holds the long-row instances on
# (tests/test_torch_xwide_rows.py, tests/test_torch_mask_rows.py): 33
# words with a 6-bit top word, two whole slots a lane, 3x3 regions across
# the lane-31 border (columns 1023..1025) with a hand of three, and more
# than 32 rows (the clear's windowed form; its mask and legality are held
# to the general ones alone: their plain tables take 20 HW^2 bytes each)
XLONG_CASES = {"3x1030": dict(height=3, width=1030, piece_set="mini5"),
               "2x2048": dict(height=2, width=2048, piece_set="mini5"),
               "9x1035r3": dict(height=9, width=1035, region_clear=True, region_size=3,
                                queue_size=3, piece_set="mini5"),
               "33x1025": dict(height=33, width=1025, piece_set="mini5")}
# rows of more than 4096 cells: the general mask, clear, apply and legality
# (the paths ``w4128_u8_pallas``, ``w4128_u8_jnp`` and
# ``w4128_legal_all_pieces``)
W4128 = dict(height=2, width=4128, piece_set="mini5")
# kernel -> (source, the TPU kernel or jnp code it replaces, the path its
# launches are read from)
KERNEL_INFO = {
    "mask": ("blockpuzzle_tpu_torch/kernels/csrc/mask.cu",
             "blockpuzzle_tpu/kernels/mask.py:85", "rollout_pallas"),
    "mask_wide": ("blockpuzzle_tpu_torch/kernels/csrc/mask.cu",
                  "blockpuzzle_tpu/kernels/mask.py:85", "wide_u8_pallas"),
    "mask_tall": ("blockpuzzle_tpu_torch/kernels/csrc/mask.cu",
                  "blockpuzzle_tpu/kernels/mask.py:85", "tall_u8_pallas"),
    "mask_deep": ("blockpuzzle_tpu_torch/kernels/csrc/mask.cu",
                  "blockpuzzle_tpu/kernels/mask.py:85", "huge_u8_pallas"),
    "mask_xwide": ("blockpuzzle_tpu_torch/kernels/csrc/mask.cu",
                   "blockpuzzle_tpu/kernels/mask.py:85", "xtall_u8_pallas"),
    "mask_xwide_long": ("blockpuzzle_tpu_torch/kernels/csrc/mask.cu",
                        "blockpuzzle_tpu/kernels/mask.py:85", "w1056_u8_pallas"),
    "mask_general": ("blockpuzzle_tpu_torch/kernels/csrc/mask.cu",
                     "blockpuzzle_tpu/kernels/mask.py:85", "w4128_u8_pallas"),
    "apply": ("blockpuzzle_tpu_torch/kernels/csrc/collision.cu",
              "blockpuzzle_tpu/kernels/collision.py:164", "rollout_pallas"),
    "apply_wide": ("blockpuzzle_tpu_torch/kernels/csrc/clear.cu",
                   "blockpuzzle_tpu/kernels/collision.py:164", "wide_u8_pallas"),
    "apply_tall": ("blockpuzzle_tpu_torch/kernels/csrc/clear.cu",
                   "blockpuzzle_tpu/kernels/collision.py:164", "tall_u8_pallas"),
    "apply_deep": ("blockpuzzle_tpu_torch/kernels/csrc/clear.cu",
                   "blockpuzzle_tpu/kernels/collision.py:164", "huge_u8_pallas"),
    "apply_xwide": ("blockpuzzle_tpu_torch/kernels/csrc/clear.cu",
                    "blockpuzzle_tpu/kernels/collision.py:164", "xtall_u8_pallas"),
    "apply_xwide_long": ("blockpuzzle_tpu_torch/kernels/csrc/clear.cu",
                         "blockpuzzle_tpu/kernels/collision.py:164", "w1056_u8_pallas"),
    "apply_general": ("blockpuzzle_tpu_torch/kernels/csrc/collision.cu",
                      "blockpuzzle_tpu/kernels/collision.py:164", "w4128_u8_pallas"),
    "clear": ("blockpuzzle_tpu_torch/kernels/csrc/clear.cu",
              "blockpuzzle_tpu/kernels/clear.py:93", "train_u8"),
    "clear_wide": ("blockpuzzle_tpu_torch/kernels/csrc/clear.cu",
                   "blockpuzzle_tpu/kernels/clear.py:93", "wide_u8_jnp"),
    "clear_tall": ("blockpuzzle_tpu_torch/kernels/csrc/clear.cu",
                   "blockpuzzle_tpu/kernels/clear.py:93", "tall_u8_jnp"),
    "clear_deep": ("blockpuzzle_tpu_torch/kernels/csrc/clear.cu",
                   "blockpuzzle_tpu/kernels/clear.py:93", "huge_u8_jnp"),
    "clear_xwide": ("blockpuzzle_tpu_torch/kernels/csrc/clear.cu",
                    "blockpuzzle_tpu/kernels/clear.py:93", "xtall_u8_jnp"),
    "clear_xwide_long": ("blockpuzzle_tpu_torch/kernels/csrc/clear.cu",
                         "blockpuzzle_tpu/kernels/clear.py:93", "w1056_u8_jnp"),
    "clear_general": ("blockpuzzle_tpu_torch/kernels/csrc/clear.cu",
                      "blockpuzzle_tpu/kernels/clear.py:93", "w4128_u8_jnp"),
    "legality": ("blockpuzzle_tpu_torch/kernels/csrc/legality.cu",
                 "blockpuzzle_tpu/kernels/collision.py:50", "legal_all_pieces"),
    **{f"legality_{kind}": ("blockpuzzle_tpu_torch/kernels/csrc/mask.cu",
                            "blockpuzzle_tpu/kernels/collision.py:50",
                            f"{board}_legal_all_pieces")
       for kind, board in (("wide", "wide"), ("tall", "tall"), ("deep", "huge"),
                           ("xwide", "xtall"))},
    "legality_xwide_long": ("blockpuzzle_tpu_torch/kernels/csrc/mask.cu",
                            "blockpuzzle_tpu/kernels/collision.py:50",
                            "w1056_legal_all_pieces"),
    "legality_general": ("blockpuzzle_tpu_torch/kernels/csrc/legality.cu",
                         "blockpuzzle_tpu/kernels/collision.py:50",
                         "w4128_legal_all_pieces"),
    "packed_apply": ("blockpuzzle_tpu_torch/kernels/csrc/packed_apply.cu",
                     "blockpuzzle_tpu/env/core.py:962", "rollout"),
    "packed_mask": ("blockpuzzle_tpu_torch/kernels/csrc/packed_mask.cu",
                    "blockpuzzle_tpu/env/core.py:489", "rollout"),
    "packed_legal_words": ("blockpuzzle_tpu_torch/kernels/csrc/packed_mask.cu",
                           "blockpuzzle_tpu/env/words.py:78", "rollout_words"),
    "packed_apply_tall": ("blockpuzzle_tpu_torch/kernels/csrc/packed_tall.cu",
                          "blockpuzzle_tpu/env/core.py:962", "tall_packed"),
    "packed_mask_tall": ("blockpuzzle_tpu_torch/kernels/csrc/packed_tall.cu",
                         "blockpuzzle_tpu/env/core.py:489", "tall_packed"),
    "packed_legal_words_tall": ("blockpuzzle_tpu_torch/kernels/csrc/packed_tall.cu",
                                "blockpuzzle_tpu/env/words.py:78", "tall_words"),
    "packed_apply_general": ("blockpuzzle_tpu_torch/kernels/csrc/packed_tall.cu",
                             "blockpuzzle_tpu/env/core.py:962", "huge_packed"),
    "packed_mask_general": ("blockpuzzle_tpu_torch/kernels/csrc/packed_tall.cu",
                            "blockpuzzle_tpu/env/core.py:489", "huge_packed"),
    "packed_legal_words_general": ("blockpuzzle_tpu_torch/kernels/csrc/packed_tall.cu",
                                   "blockpuzzle_tpu/env/words.py:78", "huge_words"),
    "packed_tail": ("blockpuzzle_tpu_torch/kernels/csrc/packed_tail.cu",
                    "blockpuzzle_tpu/env/core.py:1056", "rollout"),
    "packed_unpack": ("blockpuzzle_tpu_torch/kernels/csrc/packed_tail.cu",
                      "blockpuzzle_tpu/env/core.py:482", "rollout"),
    "deal": ("blockpuzzle_tpu_torch/kernels/csrc/draws.cu",
             "blockpuzzle_tpu/env/core.py:317", "rollout"),
    "uniform_legal": ("blockpuzzle_tpu_torch/kernels/csrc/draws.cu", "bench.py:161",
                      "rollout"),
    "words_select": ("blockpuzzle_tpu_torch/kernels/csrc/draws.cu",
                     "blockpuzzle_tpu/env/words.py:43", "rollout_words"),
}
NO_PALLAS_SOURCE = ("deal", "uniform_legal", "words_select") + tuple(
    k for k in KERNEL_INFO if k.startswith("packed_"))
# the draws: the deal once a step and once an ``init`` on every engine path,
# a sampler's kernel once a call
DRAWS = ("deal", "uniform_legal", "words_select")
# the JAX CLI's defaults: conv torso, --state-impl auto (packed)
TRAIN_ARGV = ["--preset", "default", "--num-envs", "4096", "--rollout-len",
              "64", "--epochs", "2", "--minibatches", "4", "--updates", "3",
              "--log-every", "1", "--seed", "0", "--device", "cuda"]
# the u8 clear-kernel step, with the mlp torso (later flags win)
TRAIN_U8_ARGV = TRAIN_ARGV + ["--updates", "2", "--torso", "mlp",
                              "--state-impl", "u8", "--mlp-width", "512"]
# DQN with the JAX CLI's defaults (conv torso, packed engine, buffer
# 200,000, batch 4096, 4 env steps an iteration); then the mlp torso on the
# u8 clear-kernel step with every DQN variant
TRAIN_DQN_ARGV = ["--algo", "dqn", "--preset", "default", "--num-envs", "4096",
                  "--buffer-size", "200000", "--updates", "5", "--log-every", "1",
                  "--seed", "0", "--device", "cuda"]
TRAIN_DQN_U8_ARGV = TRAIN_DQN_ARGV + ["--updates", "3", "--torso", "mlp",
                                      "--state-impl", "u8", "--mlp-width", "512",
                                      "--dueling", "--n-step", "3", "--per"]


def kernel_counters(env) -> dict:
    """kernel -> (its wrapper on ``env``, or the samplers' shared one on
    ``env``'s device, and the wrapper's counter of its launches); the packed
    wrappers are None on a board too wide for them."""
    from blockpuzzle_tpu_torch.sampler import policy_kernels

    uniform, words = policy_kernels(env.device)
    return {"deal": (env.deal_kernel, "launches"),
            "uniform_legal": (uniform, "launches"),
            "words_select": (words, "launches"),
            "mask": (env.mask_kernel, "launches"),
            "mask_wide": (env.mask_kernel, "wide_launches"),
            "mask_tall": (env.mask_kernel, "tall_launches"),
            "mask_deep": (env.mask_kernel, "deep_launches"),
            "mask_xwide": (env.mask_kernel, "xwide_launches"),
            "mask_xwide_long": (env.mask_kernel, "xwide_long_launches"),
            "mask_general": (env.mask_kernel, "general_launches"),
            "apply": (env.apply_kernel, "launches"),
            "apply_wide": (env.apply_kernel, "wide_launches"),
            "apply_tall": (env.apply_kernel, "tall_launches"),
            "apply_deep": (env.apply_kernel, "deep_launches"),
            "apply_xwide": (env.apply_kernel, "xwide_launches"),
            "apply_xwide_long": (env.apply_kernel, "xwide_long_launches"),
            "apply_general": (env.apply_kernel, "general_launches"),
            "clear": (env.clear_kernel, "launches"),
            "clear_wide": (env.clear_kernel, "wide_launches"),
            "clear_tall": (env.clear_kernel, "tall_launches"),
            "clear_deep": (env.clear_kernel, "deep_launches"),
            "clear_xwide": (env.clear_kernel, "xwide_launches"),
            "clear_xwide_long": (env.clear_kernel, "xwide_long_launches"),
            "clear_general": (env.clear_kernel, "general_launches"),
            "legality": (env.legal_kernel, "launches"),
            **{f"legality_{kind}": (env.legal_kernel, f"{kind}_launches")
               for kind in ("wide", "tall", "deep", "xwide", "xwide_long", "general")},
            **{f"packed_{k}{s}": (getattr(env, f"packed_{k}_kernel"), f"{s[1:]}_launches"
                                   if s else "launches")
               for k in ("apply", "mask") for s in ("", "_tall", "_general")},
            **{f"packed_legal_words{s}": (env.packed_mask_kernel, f"words{s}_launches")
               for s in ("", "_tall", "_general")},
            "packed_tail": (env.packed_tail_kernel, "launches"),
            "packed_unpack": (env.packed_tail_kernel, "unpack_launches")}


def zero_counts(env) -> None:
    for k, attr in kernel_counters(env).values():
        if k is not None:
            setattr(k, attr, 0)


def read_counts(env) -> dict:
    return {name: getattr(k, attr) if k is not None else 0
            for name, (k, attr) in kernel_counters(env).items()}


def expected(**counts) -> dict:
    """Every kernel's expected launches on a path: ``counts``, 0 for the
    rest."""
    return {**dict.fromkeys(KERNEL_INFO, 0), **counts}


def tail_counts(steps: int, unpacks: int) -> dict:
    """The tail's launches on a packed engine's path: one a step, and an
    unpack a ``board_obs`` (each ``init`` and reset's timestep, each
    learner's ``observe``, each ``legal_all_pieces`` call)."""
    return {"packed_tail": steps, "packed_unpack": unpacks}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def ptxas_lines(log: str):
    """``name: Used ... registers ...`` and spill lines of nvcc's ``-Xptxas
    -v`` output, each under its kernel's (mangled) entry name."""
    entry = "?"
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "Used" in line or "spill" in line:
            yield f"{entry}: {line.strip()}"


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of ``fn`` (one kernel launch) over ``iters``
    back-to-back calls.

    A spin kernel (``torch.cuda._sleep``, ~20 ms) holds the card while the
    host queues the calls, so the launches run back to back and the host's
    issue time (Python checks, allocation, ctypes) does not enter.  The
    start event must still be pending once every call is queued, or this
    raises."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(1 << 25)
    start.record()
    for _ in range(iters):
        fn()
    queued = not start.query()
    end.record()
    torch.cuda.synchronize()
    if not queued:
        raise RuntimeError("the host could not queue the timed calls ahead of the card")
    return start.elapsed_time(end) / iters


def host_paced_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean time of ``fn`` over ``iters`` calls issued as the host goes:
    events around the calls, no spin kernel ahead of them.  For the plain
    versions, whose tens of launches a call overflow the launch queue
    before 50 calls are queued."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def chosen_action(cfg, g):
    """The packed apply kernel's view of (piece, anchor) table rows ``g``:
    attrs (n, 11) ``[h, w, cells, dr1, dc1, h1, w1, dr2, dc2, h2, w2]``,
    anchor row r and column c, as the engine's step derives them."""
    import numpy as np

    from blockpuzzle_tpu_torch import rules

    t = rules.tables_for(cfg)
    table = np.concatenate(
        [t.piece_h[:, None], t.piece_w[:, None], t.piece_cells[:, None],
         t.piece_rects], axis=1).astype(np.int32)
    pid, anchor = np.divmod(g, cfg.num_cells)
    r, c = np.divmod(anchor, cfg.width)
    return table[pid], r.astype(np.int32), c.astype(np.int32)


def kernel_inputs(cfg, n: int, seed: int):
    """Boards with some full lines, full 3x3 regions (cleared on woodoku)
    and near-full rows, hands with empty slots, and chosen actions that
    are legal, illegal, out of bounds, or complete a row, as numpy arrays:
    (board, queue, cover, valid) for the u8 kernels and (attrs, r, c) of
    the same actions for the packed apply kernel."""
    import numpy as np

    from blockpuzzle_tpu_torch import rules

    t = rules.tables_for(cfg)
    rs = np.random.default_rng(seed)
    hw = cfg.num_cells
    board = (rs.random((n, hw)) < 0.35).astype(np.uint8)
    grid = board.reshape(n, cfg.height, cfg.width)
    r4 = min(4, cfg.height - 1)                       # row 4, or the last
    grid[0::7, min(3, cfg.height - 1), :] = 1         # full rows
    grid[1::7, :, 5] = 1                              # full columns
    grid[2::7, r4, :] = 1                             # row 4 full but
    grid[2::7, r4, 0] = 0                             # its first cell
    grid[3::7, 0:3, 0:3] = 1                          # full 3x3 regions
    grid[4::7, 3:6, 3:6] = 1                          # a full region crossed
    grid[4::7, r4, :] = 1                             # by a full row
    size = cfg.region_size
    if cfg.region_clear and cfg.width > 32 and 32 % size:
        c0 = 32 // size * size                        # a full region across
        grid[5::7, :size, c0 : c0 + size] = 1         # two row words
    if cfg.region_clear and cfg.width > 1024 and 1024 % size:
        c0 = 1024 // size * size                      # and across lane 31's
        grid[6::7, :size, c0 : c0 + size] = 1         # last word and lane 0's next
    if cfg.height > 32:                               # at the lane seam: full
        grid[5::7, 31, :] = 1                         # rows 31 and 32, a full
        grid[6::7, 32, :] = 1                         # region on rows 30..32
        grid[3::7, 30:33, 0:3] = 1
    queue = rs.integers(0, t.num_pieces + 1, (n, cfg.queue_size)).astype(np.int32)
    g = rs.integers(0, t.cover.shape[0], n)           # random (piece, anchor)
    g[2::7] = r4 * cfg.width                          # 1x1 at (4, 0): clears
    return (board, queue, t.cover[g], t.valid[g]) + chosen_action(cfg, g)


def illegal_on_full_line(cfg, n: int):
    """Every board holds a full row 0; the action (1x1 at (0, 0)) overlaps
    it, so it must leave the board untouched.  (board, cover, valid, attrs,
    r, c) as numpy arrays."""
    import numpy as np

    from blockpuzzle_tpu_torch import rules

    t = rules.tables_for(cfg)
    board = np.zeros((n, cfg.num_cells), np.uint8)
    board[:, : cfg.width] = 1
    g = np.zeros(n, int)
    return (board, t.cover[g], t.valid[g]) + chosen_action(cfg, g)


def max_abs_err(got, want) -> int:
    """The largest |got - want| over all elements, taken as int64 2^26
    elements at a time (the legality map of 40x136 at N = 49152 holds 5.1 G
    bools, 41 GB as int64)."""
    import torch

    a, b, chunk = got.reshape(-1), want.reshape(-1), 1 << 26
    return max((int((a[i : i + chunk].to(torch.int64) - b[i : i + chunk].to(torch.int64))
                    .abs().max()) for i in range(0, a.numel(), chunk)), default=0)


def check_equal(outs, refs, what: str, errs: dict, name: str) -> None:
    import torch

    for o, r in zip(outs, refs):
        errs[name] = max(errs[name], max_abs_err(o, r))
        if not torch.equal(o, r):
            raise AssertionError(f"{name} kernel != plain ({what})")


def u8_kernel_names(cfg) -> tuple:
    """The u8 mask, clear, apply and legality kernels the wrappers pick on
    ``cfg``: the bit-row kernels where H <= 32 and W <= 32, the wide ones
    where H <= 32 and 32 < W <= 128, the tall ones where 32 < H <= 128 and
    W <= 128, the deep ones where H > 128 and W <= 128 (the boards phase 1
    and 2 run: each fits a block of the deep mask, of the deep apply and of
    the deep legality), the xwide ones where 128 < W <= 1024 at any height
    and their long-row instances where 1024 < W <= 4096 (the boards phases
    1 and 2 run: each fits a block of one warp), the general kernels
    elsewhere."""
    if cfg.height <= 32 and cfg.width <= 32:
        return "mask", "clear", "apply", "legality"
    if cfg.width > 128:
        kind = ("xwide" if cfg.width <= 1024 else "xwide_long" if cfg.width <= 4096
                else "general")
    else:
        kind = "wide" if cfg.height <= 32 else "tall" if cfg.height <= 128 else "deep"
    return tuple(f"{k}_{kind}" for k in ("mask", "clear", "apply", "legality"))


def packed_kernel_names(cfg) -> tuple:
    """The packed mask, apply and words kernels the wrappers pick on
    ``cfg`` (W <= 32): the bit-row kernels where H <= 32, the tall ones
    where H <= 128, the general ones above; the words entry's as
    ``kernels/packed.py`` ``words_kernel_kind`` picks it (the tall kernel
    on woodoku and big)."""
    from blockpuzzle_tpu_torch.kernels.packed import SUFFIX, words_kernel_kind

    s = "" if cfg.height <= 32 else "_tall" if cfg.height <= 128 else "_general"
    w = SUFFIX[words_kernel_kind(cfg)]
    return f"packed_mask{s}", f"packed_apply{s}", f"packed_legal_words{w}"


def chunked(fn, *args, rows: int):
    """``fn`` (a plain version) on ``rows`` envs of ``args`` at a time, the
    results joined: the u8 mask's plain version multiplies by a (HW,
    P*HW) table, whose product takes gigabytes at N = 49152 on the larger
    boards."""
    import torch

    n = args[0].shape[0]
    parts = [fn(*(a[i : i + rows] for a in args)) for i in range(0, n, rows)]
    if isinstance(parts[0], tuple):
        return tuple(torch.cat(p) for p in zip(*parts))
    return torch.cat(parts)


def plain_rows(cfg) -> int:
    """Envs a chunk of the plain u8 mask (``chunked``): about 1e8 float32
    products a chunk."""
    from blockpuzzle_tpu_torch import rules

    return max(256, int(1e8 // (rules.tables_for(cfg).num_pieces * cfg.num_cells)))


def phase1(card: str) -> dict:
    import torch

    from blockpuzzle_tpu_torch.config import PRESETS, EnvConfig
    from blockpuzzle_tpu_torch.kernels import (
        ApplyKernel, ClearScanKernel, LegalityKernel, MaskKernel,
        PackedApplyKernel, PackedMaskKernel,
    )
    from blockpuzzle_tpu_torch.env.words import pack_bool_mask
    from blockpuzzle_tpu_torch.kernels.packed import pack_words, unpack_words
    from blockpuzzle_tpu_torch.utils.bounds import kernel_bounds

    dev = torch.device("cuda")
    errs = {name: 0 for name in KERNEL_INFO}
    times, bounds = {}, {}
    configs = {name: PRESETS[name]() for name in PACKED_PRESETS}
    configs["24x9"] = EnvConfig(**ROWS24)
    configs["wide"] = EnvConfig(**WIDE)
    configs.update({name: EnvConfig(**shape) for name, shape in WIDE_CASES.items()})
    # the boards whose kernels are timed at N_MAIN, and the board each
    # kernel's line names; the boards of more than 32 rows in ``phase1_tall``,
    # the legality beyond the presets in ``phase1_legality``
    timed = {"default": ("mask", "clear", "apply", "legality"),
             "wide": ("mask_wide", "clear_wide", "apply_wide")}
    where = {"default": "default", "wide": "wide 8x40"}
    for name, cfg in configs.items():
        packed = name in PACKED_PRESETS or name == "24x9"
        full = packed                    # the bit-row legality held too
        mask_name, clear_name, apply_name, legal_name = u8_kernel_names(cfg)
        mk, ck, ak = MaskKernel(cfg, dev), ClearScanKernel(cfg, dev), ApplyKernel(cfg, dev)
        lk = LegalityKernel(cfg, dev) if full else None
        got = [w.name for w in (mk, ck, ak, lk) if w is not None]
        if got != [mask_name, clear_name, apply_name, legal_name][: len(got)]:
            raise AssertionError(f"{name}: the wrappers picked {got}")
        # the kernel the wide apply replaces, launched directly
        replaced = general_apply(cfg, ak) if ak.kind != "rows" else None
        if packed:
            pak, pmk = PackedApplyKernel(cfg, dev), PackedMaskKernel(cfg, dev)
        for n in (N_MAIN, N_MAIN - 1):
            board, queue, cover, valid, attrs, r, c = (
                torch.as_tensor(x, device=dev)
                for x in kernel_inputs(cfg, n, seed=n)
            )
            what = f"{name} {cfg.height}x{cfg.width}, N={n}"
            mask = mk(board, queue)
            check_equal([mask], [mk.plain(board, queue)], what, errs, mask_name)
            cleared = ck(board)
            check_equal(cleared, ck.plain(board), what, errs, clear_name)
            outs = ak(board, cover, valid)
            check_equal(outs, ak.plain(board, cover, valid), what, errs, apply_name)
            line = (f"[phase1] {what}: {mask_name} legal share "
                    f"{float(mask.float().mean()):.4f}, {clear_name} k "
                    f"{int(cleared[1].sum())}, {apply_name} legal {int(outs[2].sum())}")
            if replaced is not None:
                if not all(torch.equal(a, b) for a, b in
                           zip(replaced(board, cover, valid), outs)):
                    raise AssertionError(f"{apply_name} != apply_general launched directly "
                                         f"({what})")
                line += " == apply_general launched directly"
            if full:
                legal_all = lk(board)
                check_equal([legal_all], [lk.plain(board)], what, errs, legal_name)
                line += f", {legal_name} share {float(legal_all.float().mean()):.4f}"
            line += ": u8 kernels == plain (bit-equal)"
            if packed:
                words = pack_words(board.view(n, cfg.height, cfg.width))
                pmask = pmk(words, queue)
                check_equal([pmask], [pmk.plain(words, queue)], what, errs,
                            "packed_mask")
                pouts = pak(words, attrs, r, c, valid)
                check_equal(pouts, pak.plain(words, attrs, r, c, valid), what, errs,
                            "packed_apply")
                pwords = pmk.words(words, queue)
                check_equal([pwords], [pmk.plain_words(words, queue)], what, errs,
                            pmk.words_name)
                if not torch.equal(pwords, pack_bool_mask(pmask, cfg.height, cfg.width,
                                                          cfg.queue_size)):
                    raise AssertionError(
                        f"{pmk.words_name} != the packed mask's words ({what})")
                # both words kernels of a board of at most 32 rows, whichever
                # the wrapper picks
                pick = {kind: words_pick(cfg, pmk, kind) for kind in ("rows", "tall")}
                for kind, name_ in (("rows", "packed_legal_words"),
                                    ("tall", "packed_legal_words_tall")):
                    check_equal([pick[kind](words, queue)], [pwords],
                                f"{what}, launched directly", errs, name_)
                # the packed kernels against the u8 ones on the unpacked boards
                if not torch.equal(pmask, mask):
                    raise AssertionError(f"packed_mask != mask kernel ({what})")
                unpacked = unpack_words(pouts[0], cfg.width).view(n, -1)
                if not all(torch.equal(a, b) for a, b in
                           zip((unpacked,) + pouts[1:], outs)):
                    raise AssertionError(f"packed_apply != apply kernel ({what})")
                line += (f"; packed mask legal share {float(pmask.float().mean()):.4f},"
                         f" packed apply legal {int(pouts[2].sum())}, lines cleared "
                         f"{int(pouts[1].sum())}: packed kernels == plain == u8 "
                         f"kernels on the unpacked boards (bit-equal); {pmk.words_name} "
                         "== plain == the packed mask packed to words == both words "
                         "kernels launched directly")
                if n == N_MAIN:  # B7w's kernels' times beside their bound
                    b = kernel_bounds(cfg, board, queue, cover, valid, words, attrs, r, c,
                                      {"packed_legal_words": pwords})["packed_legal_words"]
                    for kind, fn in pick.items():
                        ms = cuda_ms(lambda: fn(words, queue))
                        line += (f"; words kernel {kind}{' (the wrapper' + chr(39) + 's)' if kind == pmk.words_kind else ''} "
                                 f"{ms:.6f} ms, {100 * b['bound_ms'] / ms:.1f}% of its "
                                 f"{b['bound_ms']:.6f} ms bound by {b['bound_by']}")
                    line += f" ({card})"
            print(line)
            b2, c2, v2, a2, r2, col2 = (
                torch.as_tensor(x, device=dev) for x in illegal_on_full_line(cfg, n)
            )
            noops = [ak(b2, c2, v2) + (b2,)]
            if packed:
                w2 = pack_words(b2.view(n, cfg.height, cfg.width))
                noops.append(pak(w2, a2, r2, col2, v2) + (w2,))
            for nb, k2, l2, before in noops:
                if bool(l2.any()) or int(k2.sum()) or not torch.equal(nb, before):
                    raise AssertionError(f"illegal action changed a board ({name})")
        if name not in timed:
            continue
        board, queue, cover, valid, attrs, r, c = (
            torch.as_tensor(x, device=dev)
            for x in kernel_inputs(cfg, N_MAIN, seed=0)
        )
        calls = {mask_name: (lambda: mk(board, queue), lambda: mk.plain(board, queue)),
                 clear_name: (lambda: ck(board), lambda: ck.plain(board)),
                 apply_name: (lambda: ak(board, cover, valid),
                              lambda: ak.plain(board, cover, valid)),
                 legal_name: (lambda: lk(board), lambda: lk.plain(board))}
        calls = {k: calls[k] for k in timed[name]}
        words = None
        if name == "default":
            words = pack_words(board.view(N_MAIN, cfg.height, cfg.width))
            args = (words, attrs, r, c, valid)
            calls.update({
                "packed_apply": (lambda: pak(*args), lambda: pak.plain(*args)),
                "packed_mask": (lambda: pmk(words, queue),
                                lambda: pmk.plain(words, queue)),
                "packed_legal_words": (lambda: pmk.words(words, queue),
                                       lambda: pmk.plain_words(words, queue)),
            })
        here = kernel_bounds(cfg, board, queue, cover, valid, words, attrs, r, c,
                             {k: f() for k, (f, _) in calls.items()})
        bounds.update({k: dict(b, where=where[name]) for k, b in here.items()})
        times.update({k: (cuda_ms(f), host_paced_ms(g)) for k, (f, g) in calls.items()})
    phase1_tall(errs, times, bounds)
    phase1_xwide(errs, times, bounds)
    phase1_long(errs, times, bounds)
    phase1_legality(errs, times, bounds)
    phase1_tail(errs, times, bounds)
    phase1_draws(errs, times, bounds, card)
    for k, (ms, plain_ms) in times.items():
        b = bounds[k]
        print(f"[phase1] {k} N={N_MAIN} {b.get('where', 'default')}: kernel {ms:.6f} ms, "
              f"plain {plain_ms:.6f} ms, bound {b['bound_ms']:.6f} ms by {b['bound_by']} "
              f"({b['bytes']} B, {b['ops']:.0f} ops), {100 * b['bound_ms'] / ms:.1f}% "
              f"of it ({card})")
    print("[phase1] illegal action on a full-line board: strict no-op (apply, "
          "apply_wide on every wide board, apply_tall and apply_deep on every board of "
          "more than 32 rows of the u8 kernels, apply_xwide on every board of 129 to "
          "1024 cells a row, apply_xwide_long on every board of 1025 to 4096, "
          "packed_apply, packed_apply_tall, packed_apply_general)")
    wide_turns(card, "phase1")
    tall_turns(card, "phase1")
    return {k: {"max_abs_err": errs[k], "ms": times[k][0], "plain_ms": times[k][1],
                "bound_ms": bounds[k]["bound_ms"], "bound_by": bounds[k]["bound_by"],
                "library_ms": None} for k in errs}


def phase1_tall(errs: dict, times: dict, bounds: dict) -> None:
    """Phase 1 on boards of more than 32 rows: the tall packed kernels
    (``TALL_PACKED_CASES``) and the tall u8 mask, clear and apply
    (``TALL_U8_CASES``) against their plain versions at N = 49152 and
    49151, the packed mask also against the u8 mask on the unpacked boards
    and its words against itself packed to words, the tall packed mask and
    words also at the block sizes ``ANCHOR_TURN_ENVS`` (``anchor_pick``)
    against the wrapper's, the u8 apply also against
    the general apply launched directly on the same inputs
    (``general_apply``), and an illegal action on a full line through the
    tall packed and u8 applies; then the kernels of boards of more than 128
    rows likewise on ``HUGE`` (130 rows) and
    ``DEEP_CASES`` (512x8, 135x9 with regions): the deep mask, clear and
    apply and the general packed kernels, the packed apply also with each
    pass 2 (``general_apply_pass``) against the plain version, the deep
    clear, the deep apply and the windowed packed mask and words also
    against the kernels they replace launched directly on the same inputs
    (``bp_clear``, ``general_calls``; ``bp_apply``; the thread-an-anchor-row
    packed mask and words, ``general_mask_pick``).  Times the tall kernels
    on 33x9 and the others on 130x8 at N = 49152 into ``times`` and
    ``bounds``, the general mask, clear and apply launched directly there
    beside the deep ones, and prints the deep apply's and the two windowed
    packed kernels' times beside the kernels they replace."""
    import torch

    from blockpuzzle_tpu_torch.config import EnvConfig
    from blockpuzzle_tpu_torch.env.words import pack_bool_mask
    from blockpuzzle_tpu_torch.kernels import (
        ApplyKernel, ClearScanKernel, MaskKernel, PackedApplyKernel, PackedMaskKernel,
    )
    from blockpuzzle_tpu_torch.kernels.packed import pack_words
    from blockpuzzle_tpu_torch.utils.bounds import kernel_bounds

    dev = torch.device("cuda")
    boards = {name: EnvConfig(**shape) for name, shape in
              {**TALL_PACKED_CASES, **TALL_U8_CASES, "130x8": HUGE, **DEEP_CASES}.items()}
    for name, cfg in boards.items():
        deep = cfg.height > 128
        u8 = name in TALL_U8_CASES or deep
        packed = cfg.width <= 32
        huge = name == "130x8"
        mask_name, clear_name, apply_name, _ = u8_kernel_names(cfg)
        pmask_name, papply_name, pwords_name = packed_kernel_names(cfg)
        if u8:
            mk, ck, ak = MaskKernel(cfg, dev), ClearScanKernel(cfg, dev), ApplyKernel(cfg, dev)
            if (mk.name, ck.name, ak.name) != (mask_name, clear_name, apply_name):
                raise AssertionError(f"{name}: the u8 wrappers picked {mk.name}, {ck.name}, "
                                     f"{ak.name}")
            replaced_apply = general_apply(cfg, ak)
            rows = plain_rows(cfg)
        if packed:
            pak, pmk = PackedApplyKernel(cfg, dev), PackedMaskKernel(cfg, dev)
            if (pmk.name, pak.name, pmk.words_name) != (pmask_name, papply_name,
                                                        pwords_name):
                raise AssertionError(f"{name}: the packed wrappers picked {pmk.name}, "
                                     f"{pak.name}, {pmk.words_name}")
        if deep:  # the kernels the deep clear and the windowed packed kernels replace
            general_mask, general_clear = general_calls(cfg, mk, ck)
            mask_rows = general_mask_pick(cfg, pmk, windowed=False)
            words_rows = general_mask_pick(cfg, pmk, windowed=False, words=True)
        for n in (N_MAIN, N_MAIN - 1):
            board, queue, cover, valid, attrs, r, c = (
                torch.as_tensor(x, device=dev) for x in kernel_inputs(cfg, n, seed=n))
            what = f"{name}, N={n}"
            line = f"[phase1] {what}:"
            if u8:
                mask = mk(board, queue)
                check_equal([mask], [chunked(mk.plain, board, queue, rows=rows)], what,
                            errs, mask_name)
                cleared = ck(board)
                check_equal(cleared, chunked(ck.plain, board, rows=rows), what, errs,
                            clear_name)
                if deep and not all(torch.equal(a, b)
                                    for a, b in zip(general_clear(board), cleared)):
                    raise AssertionError(f"{clear_name} != clear_general launched directly "
                                         f"({what})")
                outs = ak(board, cover, valid)
                check_equal(outs, chunked(ak.plain, board, cover, valid, rows=rows), what,
                            errs, apply_name)
                if not all(torch.equal(a, b)
                           for a, b in zip(replaced_apply(board, cover, valid), outs)):
                    raise AssertionError(f"{apply_name} != apply_general launched directly "
                                         f"({what})")
                line += (f" {mask_name} legal share {float(mask.float().mean()):.4f}, "
                         f"{clear_name} k {int(cleared[1].sum())}, {apply_name} legal "
                         f"{int(outs[2].sum())} == apply_general launched directly")
            if u8:
                line += ": u8 kernels == plain (bit-equal)"
            if packed:
                words = pack_words(board.view(n, cfg.height, cfg.width))
                pmask = pmk(words, queue)
                check_equal([pmask], [pmk.plain(words, queue)], what, errs, pmask_name)
                pouts = pak(words, attrs, r, c, valid)
                check_equal(pouts, pak.plain(words, attrs, r, c, valid), what, errs,
                            papply_name)
                pwords = pmk.words(words, queue)
                check_equal([pwords], [pmk.plain_words(words, queue)], what, errs,
                            pwords_name)
                if not torch.equal(pwords, pack_bool_mask(pmask, cfg.height, cfg.width,
                                                          cfg.queue_size)):
                    raise AssertionError(f"{pwords_name} != the packed mask's words ({what})")
                if u8 and not torch.equal(pmask, mask):
                    raise AssertionError(f"{pmask_name} != {mask_name} ({what})")
                if deep and not torch.equal(mask_rows(words, queue), pmask):
                    raise AssertionError(f"{pmask_name} != its thread-an-anchor-row kernel "
                                         f"({what})")
                if deep and not torch.equal(words_rows(words, queue), pwords):
                    raise AssertionError(f"{pwords_name} != its thread-an-anchor-row kernel "
                                         f"({what})")
                if pmk.kind == "tall":  # the other instances; the last block ragged or not
                    for envs in ANCHOR_TURN_ENVS:
                        if not (torch.equal(anchor_pick(cfg, pmk, envs)(words, queue), pmask)
                                and torch.equal(anchor_pick(cfg, pmk, envs, True)(
                                    words, queue), pwords)):
                            raise AssertionError(f"{pmask_name} at {envs} env-slots a block "
                                                 f"!= at {pmk.shape[0]} ({what})")
                    total, envs = n * cfg.queue_size, pmk.shape[0]
                    line += (f", {pmask_name} and {pwords_name} at "
                             f"{'/'.join(map(str, ANCHOR_TURN_ENVS))} env-slots a block == at "
                             f"{envs} (its last block {total % envs or envs} env-slots)")
                if int(pouts[1].sum()) == 0 or not bool(pouts[2].any()):
                    raise AssertionError(f"{papply_name} cleared nothing ({what})")
                if deep:  # each pass 2 of the general apply through its own entry
                    for staged in (True, False):
                        check_equal(general_apply_pass(cfg, staged)(words, attrs, r, c, valid),
                                    pouts, f"{what}, staged={staged}", errs, papply_name)
                    line += (f", {papply_name} with each pass 2 == plain, {clear_name} == "
                             f"clear_general and {pmask_name} and {pwords_name} == their "
                             "thread-an-anchor-row kernels, launched directly")
                line += (f"{';' if u8 else ''} {pmask_name} legal share "
                         f"{float(pmask.float().mean()):.4f}, "
                         f"{papply_name} legal {int(pouts[2].sum())}, lines cleared "
                         f"{int(pouts[1].sum())}: packed kernels == plain (bit-equal), "
                         f"{pwords_name} == the packed mask packed to words"
                         + (", the packed mask == the u8 mask" if u8 else ""))
            b2, c2, v2, a2, r2, col2 = (
                torch.as_tensor(x, device=dev) for x in illegal_on_full_line(cfg, n))
            noops = [ak(b2, c2, v2) + (b2,)] if u8 else []
            if packed:
                w2 = pack_words(b2.view(n, cfg.height, cfg.width))
                noops.append(pak(w2, a2, r2, col2, v2) + (w2,))
            for nb, k2, l2, before in noops:
                if bool(l2.any()) or int(k2.sum()) or not torch.equal(nb, before):
                    raise AssertionError(f"illegal action changed a board ({what})")
            print(line)
        if name not in ("33x9", "130x8"):
            continue
        board, queue, cover, valid, attrs, r, c = (
            torch.as_tensor(x, device=dev) for x in kernel_inputs(cfg, N_MAIN, seed=0))
        words = pack_words(board.view(N_MAIN, cfg.height, cfg.width))
        args = (words, attrs, r, c, valid)
        calls = {mask_name: (lambda: mk(board, queue), lambda: mk.plain(board, queue)),
                 clear_name: (lambda: ck(board), lambda: ck.plain(board)),
                 apply_name: (lambda: ak(board, cover, valid),
                              lambda: ak.plain(board, cover, valid)),
                 papply_name: (lambda: pak(*args), lambda: pak.plain(*args)),
                 pmask_name: (lambda: pmk(words, queue), lambda: pmk.plain(words, queue)),
                 pwords_name: (lambda: pmk.words(words, queue),
                               lambda: pmk.plain_words(words, queue))}
        if huge:  # the general mask, clear and apply beside the deep ones, launched directly
            what = f"{name}, N={N_MAIN}, launched directly"
            check_equal([general_mask(board, queue)], [mk(board, queue)], what, errs,
                        "mask_general")
            check_equal(general_clear(board), ck(board), what, errs, "clear_general")
            check_equal(replaced_apply(board, cover, valid), ak(board, cover, valid), what,
                        errs, "apply_general")
        here = kernel_bounds(cfg, board, queue, cover, valid, words, attrs, r, c,
                             {k: f() for k, (f, _) in calls.items()})
        label = f"{'tall' if name == '33x9' else 'huge'} {name}"
        bounds.update({k: dict(b, where=label) for k, b in here.items()})
        times.update({k: (cuda_ms(f), host_paced_ms(g)) for k, (f, g) in calls.items()})
        if huge:
            for new, old, fn in ((mask_name, "mask_general", lambda: general_mask(board, queue)),
                                 (clear_name, "clear_general", lambda: general_clear(board)),
                                 (apply_name, "apply_general",
                                  lambda: replaced_apply(board, cover, valid)),
                                 (pmask_name, "thread-an-anchor-row kernel",
                                  lambda: mask_rows(words, queue)),
                                 (pwords_name, "thread-an-anchor-row kernel",
                                  lambda: words_rows(words, queue))):
                old_ms = cuda_ms(fn)
                print(f"[phase1] {new} {name} N={N_MAIN}: {times[new][0]:.6f} ms, the "
                      f"{old} it replaces {old_ms:.6f} ms, launched directly on the same "
                      f"inputs (bit-equal); bound {here[new]['bound_ms']:.6f} ms")


def phase1_xwide(errs: dict, times: dict, bounds: dict) -> None:
    """Phase 1 on rows of more than 128 cells: on 8x136 (``XWIDE``) and
    40x136 (``XTALL``) at N = 49152 and 49151 the xwide mask, clear, apply
    and legality against their plain versions (in chunks of envs) and
    against the general mask, clear, apply and legality launched directly on
    the same inputs (``general_calls``, ``general_apply``,
    ``general_legality``), and an illegal action on a full line through the
    apply; the same checks on ``XWIDE_CASES`` and ``XTALL_CASES`` at
    N = 4096 and 4095.  Times the four xwide kernels on 40x136, each beside
    the general kernel it replaces launched directly on the same inputs, at
    N = 49152 into ``times`` and ``bounds``, and prints each time beside its
    bound and the general one's.  Rows of more than 1024 cells are
    ``phase1_long``'s."""
    import torch

    from blockpuzzle_tpu_torch.config import EnvConfig
    from blockpuzzle_tpu_torch.kernels import (
        ApplyKernel, ClearScanKernel, LegalityKernel, MaskKernel,
    )
    from blockpuzzle_tpu_torch.utils.bounds import kernel_bounds

    dev = torch.device("cuda")
    boards = {"8x136": (XWIDE, (N_MAIN, N_MAIN - 1)),
              **{name: (shape, (4096, 4095)) for name, shape in XWIDE_CASES.items()},
              "40x136": (XTALL, (N_MAIN, N_MAIN - 1)),
              **{name: (shape, (4096, 4095)) for name, shape in XTALL_CASES.items()}}
    # the board whose kernels' times go into ``times`` (the kernels line):
    # each kernel on the board of the path its launches are read from
    timed = ("40x136",)
    for name, (shape, sizes) in boards.items():
        cfg = EnvConfig(**shape)
        names = u8_kernel_names(cfg)
        mask_name, clear_name, apply_name, legal_name = names
        mk, ck, ak = MaskKernel(cfg, dev), ClearScanKernel(cfg, dev), ApplyKernel(cfg, dev)
        lk = LegalityKernel(cfg, dev)
        if (mk.name, ck.name, ak.name, lk.name) != names:
            raise AssertionError(f"{name}: the u8 wrappers picked {mk.name}, {ck.name}, "
                                 f"{ak.name}, {lk.name}")
        general_mask, general_clear = general_calls(cfg, mk, ck)
        replaced_apply = general_apply(cfg, ak)
        replaced_legality = general_legality(cfg, lk)
        rows = plain_rows(cfg)
        for n in sizes:
            board, queue, cover, valid, _, _, _ = (
                torch.as_tensor(x, device=dev) for x in kernel_inputs(cfg, n, seed=n))
            what = f"{name}, N={n}"
            mask = mk(board, queue)
            check_equal([mask], [chunked(mk.plain, board, queue, rows=rows)], what, errs,
                        mask_name)
            cleared = ck(board)
            check_equal(cleared, chunked(ck.plain, board, rows=rows), what, errs, clear_name)
            outs = ak(board, cover, valid)
            check_equal(outs, chunked(ak.plain, board, cover, valid, rows=rows), what, errs,
                        apply_name)
            legal_all = lk(board)
            check_equal([legal_all], [chunked(lk.plain, board, rows=rows)], what, errs,
                        legal_name)
            check_equal([general_mask(board, queue)], [mask], what, errs, "mask_general")
            check_equal(general_clear(board), cleared, what, errs, "clear_general")
            check_equal(replaced_apply(board, cover, valid), outs, what, errs, "apply_general")
            check_equal([replaced_legality(board)], [legal_all], what, errs, "legality_general")
            b2, c2, v2, _, _, _ = (
                torch.as_tensor(x, device=dev) for x in illegal_on_full_line(cfg, n))
            nb, k2, l2 = ak(b2, c2, v2)
            if bool(l2.any()) or int(k2.sum()) or not torch.equal(nb, b2):
                raise AssertionError(f"illegal action changed a board ({what})")
            if int(cleared[1].sum()) == 0 or not 0 < float(mask.float().mean()) < 1:
                raise AssertionError(f"{name}: nothing cleared or no mask to test ({what})")
            if int(outs[1].sum()) == 0 or not 0 < int(outs[2].sum()) < n:
                raise AssertionError(f"{name}: the apply cleared nothing ({what})")
            if not 0 < float(legal_all.float().mean()) < 1:
                raise AssertionError(f"{name}: no legality to test ({what})")
            print(f"[phase1] {what}: {mask_name} legal share {float(mask.float().mean()):.4f}"
                  f", {clear_name} k {int(cleared[1].sum())}, {apply_name} legal "
                  f"{int(outs[2].sum())}, k {int(outs[1].sum())}, {legal_name} share "
                  f"{float(legal_all.float().mean()):.4f}: u8 kernels == plain (bit-equal), "
                  "the xwide mask, clear, apply and legality == the general ones launched "
                  "directly")
            del mask, cleared, outs, legal_all
        if name not in timed:
            continue
        board, queue, cover, valid, attrs, r, c = (
            torch.as_tensor(x, device=dev) for x in kernel_inputs(cfg, N_MAIN, seed=0))
        kernels = {mask_name: (lambda: mk(board, queue),
                               lambda: chunked(mk.plain, board, queue, rows=rows)),
                   clear_name: (lambda: ck(board), lambda: ck.plain(board)),
                   apply_name: (lambda: ak(board, cover, valid),
                                lambda: ak.plain(board, cover, valid)),
                   legal_name: (lambda: lk(board), lambda: chunked(lk.plain, board, rows=rows))}
        general = {"mask_general": lambda: general_mask(board, queue),
                   "clear_general": lambda: general_clear(board),
                   "apply_general": lambda: replaced_apply(board, cover, valid),
                   "legality_general": lambda: replaced_legality(board)}
        here = kernel_bounds(cfg, board, queue, cover, valid, None, attrs, r, c,
                             {k: f() for k, (f, _) in kernels.items()})
        # the plain versions' products take about a second a call on 40x136
        for k, (f, plain) in kernels.items():
            times[k] = (cuda_ms(f), host_paced_ms(plain, iters=3, warmup=1))
            bounds[k] = dict(here[k], where=f"xwide {name}")
            b = here[k]
            old = k.replace("_xwide", "_general")
            old_ms = cuda_ms(general[old])
            print(f"[phase1] {k} {name} N={N_MAIN}: {times[k][0]:.6f} ms, "
                  f"{100 * b['bound_ms'] / times[k][0]:.1f}% of its {b['bound_ms']:.6f} ms "
                  f"bound by {b['bound_by']}; the {old} it replaces {old_ms:.6f} ms, launched "
                  f"directly on the same inputs (bit-equal), {old_ms / times[k][0]:.2f}x")


def phase1_long(errs: dict, times: dict, bounds: dict) -> None:
    """Phase 1 on rows of more than 1024 cells: on 2x1056 (``W1056``) and
    ``XLONG_CASES`` at N = 4096 and 4095 the long-row xwide instances of the
    mask, clear, apply and legality (mask_xwide_long, clear_xwide_long,
    apply_xwide_long, legality_xwide_long: one env or env-slot a warp, lane
    l holding words l + 32 j of every row) against their plain versions
    (but the mask's and the legality's on the board of more than 32 rows,
    whose plain tables would take 20 HW^2 bytes each) and against the
    general kernels launched directly on the same inputs
    (``general_calls``, ``general_apply``, ``general_legality``), and an
    illegal action on a full line through the apply; on 2x4128
    (``W4128``), rows too wide for the long-row instances, the four general
    kernels the wrappers pick, against their plain versions.  Times, at
    N = 49152, the kernels the wrappers pick into ``times`` and ``bounds``:
    on 2x1056 the four long-row instances (the kernels of the paths
    ``w1056_u8_pallas``, ``w1056_u8_jnp`` and ``w1056_legal_all_pieces``),
    each printed beside its bound and the general kernel launched directly
    on the same inputs; on 2x4128 the four general kernels (whose launches
    the ``w4128`` paths read), each beside its bound."""
    import torch

    from blockpuzzle_tpu_torch import rules
    from blockpuzzle_tpu_torch.config import EnvConfig
    from blockpuzzle_tpu_torch.kernels import (
        ApplyKernel, ClearScanKernel, LegalityKernel, MaskKernel,
    )
    from blockpuzzle_tpu_torch.utils.bounds import kernel_bounds

    dev = torch.device("cuda")
    for name, shape in {"2x1056": W1056, **XLONG_CASES, "2x4128": W4128}.items():
        cfg = EnvConfig(**shape)
        names = u8_kernel_names(cfg)
        mask_name, clear_name, apply_name, legal_name = names
        small = cfg.height <= 32             # the mask's and legality's plain tables fit
        mk, ck, ak = MaskKernel(cfg, dev), ClearScanKernel(cfg, dev), ApplyKernel(cfg, dev)
        lk = LegalityKernel(cfg, dev)
        got = (mk.name, ck.name, ak.name, lk.name)
        if got != names:
            raise AssertionError(f"{name}: the u8 wrappers picked {got}")
        general_mask, general_clear = general_calls(cfg, mk, ck)
        replaced_apply = general_apply(cfg, ak)
        replaced_legality = general_legality(cfg, lk)
        long = ck.kind == "xwide"
        rows = plain_rows(cfg)
        for n in (4096, 4095):
            board, queue, cover, valid, _, _, _ = (
                torch.as_tensor(x, device=dev) for x in kernel_inputs(cfg, n, seed=n))
            what = f"{name}, N={n}"
            cleared = ck(board)
            check_equal(cleared, ck.plain(board), what, errs, clear_name)
            outs = ak(board, cover, valid)
            check_equal(outs, ak.plain(board, cover, valid), what, errs, apply_name)
            mask, legal_all = mk(board, queue), lk(board)
            if small:
                check_equal([mask], [chunked(mk.plain, board, queue, rows=rows)], what, errs,
                            mask_name)
                check_equal([legal_all], [chunked(lk.plain, board, rows=rows)], what, errs,
                            legal_name)
            if long:
                check_equal([general_mask(board, queue)], [mask], what, errs, "mask_general")
                check_equal(general_clear(board), cleared, what, errs, "clear_general")
                check_equal(replaced_apply(board, cover, valid), outs, what, errs,
                            "apply_general")
                check_equal([replaced_legality(board)], [legal_all], what, errs,
                            "legality_general")
            b2, c2, v2, _, _, _ = (
                torch.as_tensor(x, device=dev) for x in illegal_on_full_line(cfg, n))
            nb, k2, l2 = ak(b2, c2, v2)
            if bool(l2.any()) or int(k2.sum()) or not torch.equal(nb, b2):
                raise AssertionError(f"illegal action changed a board ({what})")
            if int(cleared[1].sum()) == 0 or int(outs[1].sum()) == 0 or not (
                    0 < int(outs[2].sum()) < n):
                raise AssertionError(f"{name}: nothing cleared or no legality ({what})")
            if not (0 < float(mask.float().mean()) < 1
                    and 0 < float(legal_all.float().mean()) < 1):
                raise AssertionError(f"{name}: no mask or legality to test ({what})")
            held = ("plain" if small else "the general kernels launched directly alone")
            print(f"[phase1] {what}: {clear_name} k {int(cleared[1].sum())}, {apply_name} "
                  f"legal {int(outs[2].sum())}, k {int(outs[1].sum())}, {mask_name} legal "
                  f"share {float(mask.float().mean()):.4f}, {legal_name} share "
                  f"{float(legal_all.float().mean()):.4f}: {clear_name} and {apply_name} == "
                  f"plain, {mask_name} and {legal_name} == {held} (bit-equal)"
                  + (", all four == the general kernels launched directly" if long else ""))
            del cleared, outs, mask, legal_all
        if not small:                        # 5 HW^2 bytes of rule tables
            del rules._TABLE_CACHE[cfg], mk, ck, ak, lk
            continue
        if name not in ("2x1056", "2x4128"):
            continue
        board, queue, cover, valid, attrs, r, c = (
            torch.as_tensor(x, device=dev) for x in kernel_inputs(cfg, N_MAIN, seed=0))
        # the kernels the wrappers pick: the long-row instances on 2x1056,
        # the general kernels on 2x4128, where the w4128 paths launch them
        kernels = {mask_name: (lambda: mk(board, queue),
                               lambda: chunked(mk.plain, board, queue, rows=rows)),
                   clear_name: (lambda: ck(board), lambda: ck.plain(board)),
                   apply_name: (lambda: ak(board, cover, valid),
                                lambda: ak.plain(board, cover, valid)),
                   legal_name: (lambda: lk(board), lambda: chunked(lk.plain, board, rows=rows))}
        general = {"mask_general": lambda: general_mask(board, queue),
                   "clear_general": lambda: general_clear(board),
                   "apply_general": lambda: replaced_apply(board, cover, valid),
                   "legality_general": lambda: replaced_legality(board)} if long else {}
        here = kernel_bounds(cfg, board, queue, cover, valid, None, attrs, r, c,
                             {k: f() for k, f in {**{k: f for k, (f, _) in kernels.items()},
                                                  **general}.items()})
        for k, (f, plain) in kernels.items():
            times[k] = (cuda_ms(f), host_paced_ms(plain, iters=10, warmup=1))
            bounds[k] = dict(here[k], where=f"long {name}")
            b, ms = here[k], times[k][0]
            line = (f"[phase1] {k} {name} N={N_MAIN}: {ms:.6f} ms, "
                    f"{100 * b['bound_ms'] / ms:.1f}% of its {b['bound_ms']:.6f} ms bound by "
                    f"{b['bound_by']}")
            if long:
                old = k.replace("_xwide_long", "_general")
                old_ms = cuda_ms(general[old])
                line += (f"; the {old} it replaces {old_ms:.6f} ms, launched directly on the "
                         f"same inputs (bit-equal), {old_ms / ms:.2f}x")
            print(line)
        rules._TABLE_CACHE.pop(cfg, None)
        del mk, ck, ak, lk, kernels, general, board, queue, cover, valid


def general_legality(cfg, lk, lib=None):
    """A callable with ``LegalityKernel``'s arguments that launches the
    general legality (``bp_legality``) on ``cfg``'s boards, whatever kernel
    the wrapper ``lk`` picks there, with the per-cell piece table: the
    current library's, or ``lib``'s (an earlier build's, whose
    ``bp_legality`` takes the same arguments)."""
    import torch

    from blockpuzzle_tpu_torch.kernels import _build
    from blockpuzzle_tpu_torch.kernels.collision import piece_table

    lib, dev = lib or _build.library(), lk.device
    table = torch.as_tensor(piece_table(cfg), device=dev)

    def legality(board):
        n = board.shape[0]
        out = torch.empty((n, lk.num_pieces, cfg.num_cells), dtype=torch.bool, device=dev)
        _build.check(lib.bp_legality(
            board.data_ptr(), table.data_ptr(), out.data_ptr(), n, cfg.height, cfg.width,
            lk.num_pieces, table.shape[1] - 3, torch.cuda.current_stream(dev).cuda_stream),
            "bp_legality")
        return out

    return legality


# the boards phase 1 holds the wide, tall and deep all-pieces legality on
# (each the board of the path its instance's launches are read from), and
# its sizes; the xwide legality is ``phase1_xwide``'s
LEGALITY_BOARDS = {"wide 8x40": (WIDE, (N_MAIN, N_MAIN - 1)),
                   "tall 33x9": (TALL, (4096, 4095)),
                   "huge 130x8": (HUGE, (4096, 4095))}


def phase1_legality(errs: dict, times: dict, bounds: dict) -> None:
    """Phase 1 of the all-pieces legality beyond 32x32 (``LEGALITY_BOARDS``):
    the every-piece instance of the hand mask's wide, tall or deep kernel
    the wrapper picks against its plain version (in chunks of envs) and
    against the general legality launched directly on the same inputs
    (``general_legality``, ``bp_legality``), on 8x40 at N = 49152 and 49151
    and on the other boards at N = 4096 and 4095; then each instance timed
    at N = 49152 on its board into ``times`` and ``bounds``, its time
    printed beside the general one's."""
    import torch

    from blockpuzzle_tpu_torch.config import EnvConfig
    from blockpuzzle_tpu_torch.kernels import LegalityKernel
    from blockpuzzle_tpu_torch.utils.bounds import kernel_bounds

    dev = torch.device("cuda")
    for where, (shape, sizes) in LEGALITY_BOARDS.items():
        cfg = EnvConfig(**shape)
        name = u8_kernel_names(cfg)[3]
        lk = LegalityKernel(cfg, dev)
        if lk.name != name:
            raise AssertionError(f"{where}: the legality wrapper picked {lk.name}")
        general = general_legality(cfg, lk)
        rows = plain_rows(cfg)
        for n in sizes:
            board = torch.as_tensor(kernel_inputs(cfg, n, seed=n)[0], device=dev)
            what = f"{where}, N={n}"
            legal_all = lk(board)
            check_equal([legal_all], [chunked(lk.plain, board, rows=rows)], what, errs, name)
            check_equal([general(board)], [legal_all], what, errs, "legality_general")
            if not 0 < float(legal_all.float().mean()) < 1:
                raise AssertionError(f"{where}: no legality to test ({what})")
            print(f"[phase1] {what}: {name} share {float(legal_all.float().mean()):.4f} "
                  "== plain == legality_general launched directly (bit-equal)")
        board = torch.as_tensor(kernel_inputs(cfg, N_MAIN, seed=0)[0], device=dev)
        calls = {name: (lambda: lk(board), lambda: chunked(lk.plain, board, rows=rows))}
        here = kernel_bounds(cfg, board, None, None, None, None, None, None, None,
                             {k: f() for k, (f, _) in calls.items()})
        bounds.update({k: dict(b, where=where) for k, b in here.items()})
        times.update({k: (cuda_ms(f), host_paced_ms(g)) for k, (f, g) in calls.items()})
        general_ms = cuda_ms(lambda: general(board))
        print(f"[phase1] {name} {where} N={N_MAIN}: {times[name][0]:.6f} ms, the "
              f"legality_general it replaces {general_ms:.6f} ms, launched directly on the "
              f"same inputs (bit-equal); bound {here[name]['bound_ms']:.6f} ms by "
              f"{here[name]['bound_by']}")


# the boards phase 1 holds the step's tail (B10) and the unpack on, with a
# horizon and a terminal penalty that float32 rounds; the tile of 7 envs
# starts each block's spans off a 16-byte boundary
TAIL_BOARDS = {"default": None, "tenten": None, "33x9": TALL, "130x8": HUGE}
TAIL_KNOBS = dict(max_steps=9, terminal_penalty=-0.3)


def dense_cells(cfg, n: int, gen):
    """(n, H, W) 0/1 boards on which games end within a few steps: every
    row full but for one hole, the top 0 to 3 rows empty
    (tests/test_torch_tail.py ``dense_cells``)."""
    import numpy as np

    cells = np.ones((n, cfg.height, cfg.width), np.uint8)
    holes = gen.integers(0, cfg.width, (n, cfg.height))
    np.put_along_axis(cells, holes[:, :, None], 0, axis=2)
    top = gen.integers(0, 4, n)
    cells[np.arange(cfg.height)[None, :] < top[:, None]] = 0
    return cells


def tail_inputs(cfg, n: int, seed: int, density=None):
    """The tail's inputs on the card as the step hands them
    (tests/test_torch_tail.py ``tail_inputs``): dense boards (every fifth
    empty; or, given ``density``, boards whose cells are full with that
    chance, on which few games end) as row words, the packed mask kernel's mask of a hand holding
    ids of every kind (the sentinel and ids outside [0, P] too, as the
    reset deals, which are the second half of a 2S-wide deal), rewards, steps up to past ``max_steps``, scores, streaks
    and counters that wrap at 2**31."""
    import numpy as np
    import torch

    from blockpuzzle_tpu_torch import rules
    from blockpuzzle_tpu_torch.kernels import PackedMaskKernel
    from blockpuzzle_tpu_torch.kernels.packed import pack_words

    dev = torch.device("cuda")
    gen = np.random.default_rng(seed)
    p, s = rules.tables_for(cfg).num_pieces, cfg.queue_size

    def t(x, dtype):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    cells = (dense_cells(cfg, n, gen) if density is None
             else gen.random((n, cfg.height, cfg.width)) < density)
    words = pack_words(t(cells, torch.uint8))
    words[::5] = 0
    queue3 = t(gen.integers(-1, p + 3, (n, s)), torch.int32)
    reset = t(gen.integers(-2, p + 3, (n, 2 * s)), torch.int32)[:, s:]  # the step's half
    mask = PackedMaskKernel(cfg, dev)(words, queue3)
    counter = t(gen.integers(-2**31, 2**31, n), torch.int32)
    counter[::7] = 2**31 - 1
    return (words, mask, t(gen.integers(-4, 40, n) * 0.5, torch.float32), queue3, reset,
            t(gen.integers(0, 12, n), torch.int32),
            t(gen.standard_normal(n) * 50, torch.float32),
            t(gen.integers(0, 4, n), torch.int32), counter)


def tail_fields(tail) -> list:
    """A ``Tail``'s tensors, floats as their int32 bits (so +0.0 is not
    -0.0)."""
    import torch

    return [x.view(torch.int32) if x.dtype == torch.float32 else x
            for x in tail if x is not None]


def phase1_tail(errs: dict, times: dict, bounds: dict) -> None:
    """The step's tail (B10, ``packed_tail``) and its unpack entry
    (``packed_unpack``) against their plain versions on ``TAIL_BOARDS`` at
    N = 49152 and 49151, bit-equal (floats bit for bit), with and without
    auto-reset, at the wrapper's tile and at a tile of 7 envs (the unpack
    too), then at the wrapper's tile with the smallest ring (one stage) and
    with a grid of one block an SM; the share of done envs printed (and
    required in (0, 1)).  Then both kernels' device times, plain times and
    bounds at N = 49152 on the default preset with auto-reset, the step's
    own call, into ``times`` and ``bounds``."""
    import dataclasses

    import torch

    from blockpuzzle_tpu_torch.config import PRESETS, EnvConfig
    from blockpuzzle_tpu_torch.kernels import PackedTailKernel
    from blockpuzzle_tpu_torch.utils.bounds import call_bound

    dev = torch.device("cuda")
    for name, shape in TAIL_BOARDS.items():
        cfg = PRESETS[name]() if shape is None else EnvConfig(**shape)
        cfg = dataclasses.replace(cfg, **TAIL_KNOBS)
        k = PackedTailKernel(cfg, dev)
        tile, stages, unpack_tile = k.envs, k.stages, k.unpack_envs
        # (envs a tile, stages a ring, blocks an SM; 0: the kernel's choice)
        rings = ((tile, stages, 0), (7, stages, 0), (tile, 1, 0), (tile, stages, 1))
        for n in (N_MAIN, N_MAIN - 1):
            inputs = tail_inputs(cfg, n, seed=n)
            what = f"{name}, N={n}"
            for k.envs, k.stages, k.blocks_per_sm in rings:
                ring = f"tile {k.envs}, {k.stages} stages, blocks an SM {k.blocks_per_sm}"
                for auto_reset in (True, False):
                    got = k(*inputs, auto_reset)
                    check_equal(tail_fields(got), tail_fields(k.plain(*inputs, auto_reset)),
                                f"{what}, {ring}, auto_reset {auto_reset}", errs,
                                "packed_tail")
            for k.unpack_envs in (unpack_tile, 7):
                check_equal([k.unpack(inputs[0])], [k.plain_unpack(inputs[0])],
                            f"{what}, tile {k.unpack_envs}", errs, "packed_unpack")
            k.envs, k.stages, k.blocks_per_sm, k.unpack_envs = tile, stages, 0, unpack_tile
            done = float((got.terminated | got.truncated).float().mean())
            term = float(got.terminated.float().mean())
            if not 0.0 < term <= done < 1.0:
                raise AssertionError(f"packed_tail {what}: done share {done}, "
                                     f"terminated {term}")
            print(f"[phase1] {what}: packed_tail (tiles of {tile} and 7 envs in rings of "
                  f"{stages} stages, tiles of {tile} in one stage and on a grid of one "
                  f"block an SM, with and without auto-reset) and packed_unpack (tiles of "
                  f"{unpack_tile} and 7) == plain (bit-equal); done share {done:.4f} "
                  f"(terminated {term:.4f})")
    cfg = PRESETS["default"]()
    k = PackedTailKernel(cfg, dev)
    inputs = tail_inputs(dataclasses.replace(cfg, **TAIL_KNOBS), N_MAIN, seed=0)
    calls = {"packed_tail": (lambda: k(*inputs, True), lambda: k.plain(*inputs, True),
                             inputs + (True,)),
             "packed_unpack": (lambda: k.unpack(inputs[0]),
                               lambda: k.plain_unpack(inputs[0]), inputs[:1])}
    for name, (kernel, plain, args) in calls.items():
        out = kernel()
        bounds[name] = dict(call_bound(name, cfg, args, out if isinstance(out, tuple)
                                       else (out,)), where="default")
        times[name] = (cuda_ms(kernel), host_paced_ms(plain))


def draw_inputs(cfg, n: int, seed: int):
    """Inputs of the draw kernels: stream keys from a seed above 2**32,
    per-env int32 counters that wrap negative, and the legal mask and legal
    row words of ``kernel_inputs``'s boards and hands (empty hand slots
    give empty rows)."""
    import torch

    from blockpuzzle_tpu_torch.env import rng
    from blockpuzzle_tpu_torch.kernels import PackedMaskKernel
    from blockpuzzle_tpu_torch.kernels.packed import pack_words

    dev = torch.device("cuda")
    key = rng.stream_keys(2**32 + seed, n, dev)
    c = (torch.arange(n, dtype=torch.int64, device=dev) * 40503 + 2**31 - 7) & 0xFFFFFFFF
    counter = torch.where(c >= 2**31, c - 2**32, c).to(torch.int32)
    board, queue = (torch.as_tensor(x, device=dev) for x in kernel_inputs(cfg, n, seed)[:2])
    pmk = PackedMaskKernel(cfg, dev)
    words = pack_words(board.view(n, cfg.height, cfg.width))
    return key, counter, pmk(words, queue), pmk.words(words, queue)


def off_alignment(mask):
    """Copies of the (N, A) mask as contiguous views that start off a
    16-byte boundary: rows 1 .. N of an (N + 1, A) mask (A bytes in) and
    an (N, A) view one byte into a flat buffer."""
    import torch

    n, a = mask.shape
    big = torch.zeros((n + 1, a), dtype=torch.bool, device=mask.device)
    big[1:] = mask
    flat = torch.zeros(n * a + 1, dtype=torch.bool, device=mask.device)
    flat[1:] = mask.view(-1)
    return [big[1:], flat[1:].view(n, a)]


# the boards beyond the presets whose legal words phase 1 holds B2w on: the
# words path's boards of more than 32 rows (``tall_words``,
# ``tall36r3_words``, ``huge_words``), rows of 33, 108 and 130 words
SELECT_BOARDS = {"33x9": TALL, "36x9r3": TALL36R3, "130x8": HUGE}


def phase1_draws(errs: dict, times: dict, bounds: dict, card: str) -> None:
    """The draw kernels (B9, B2, B2w) against their plain versions on the
    four presets at N = 49152 and 49151, bit-equal: the step's 2S-wide
    deal at per-env counters, the reset deal at one counter (0 and 2**32 -
    1), each policy draw at counters 0, 2**31 and 2**32 - 1, the argmax
    draw also on mask views off a 16-byte boundary (``off_alignment``);
    every drawn action legal where its row has one, action 0 where not.
    B2w likewise on the legal words of ``SELECT_BOARDS``, and on every board
    also on words off a 16-byte boundary (8 bytes in: single-word loads)
    and at every segment width (``select_pick``).  Then each one's device
    time, plain time and bound at N = 49152 on the default preset, into
    ``times`` and ``bounds``, and B2w's beside its bound on every board; the
    launch floor (the device time of an empty launch,
    ``torch.cuda._sleep(0)``, back to back) and the deal's time as
    multiples of its bound and of that floor."""
    import torch

    from blockpuzzle_tpu_torch import rules
    from blockpuzzle_tpu_torch.config import PRESETS, EnvConfig
    from blockpuzzle_tpu_torch.env import rng
    from blockpuzzle_tpu_torch.kernels import DealKernel, UniformLegalKernel, WordsSelectKernel
    from blockpuzzle_tpu_torch.kernels.draws import select_lanes
    from blockpuzzle_tpu_torch.utils.bounds import COSTS, bound, call_bound

    dev = torch.device("cuda")
    ul, ws = UniformLegalKernel(dev), WordsSelectKernel(dev)
    boards = {**{name: PRESETS[name]() for name in PACKED_PRESETS},
              **{name: EnvConfig(**shape) for name, shape in SELECT_BOARDS.items()}}
    for name, cfg in boards.items():
        preset = name in PACKED_PRESETS
        s, w = cfg.queue_size, cfg.width
        dk = DealKernel(rules.tables_for(cfg).num_pieces, dev)
        for n in (N_MAIN, N_MAIN - 1):
            key, counter, mask, words = draw_inputs(cfg, n, n)
            what = f"{name}, N={n}"
            if preset:
                for c, tag, width in ((counter, rng.TAG_STEP, 2 * s), (0, rng.TAG_RESET, s),
                                      (2**32 - 1, rng.TAG_RESET, s)):
                    check_equal([dk(key, c, tag, width)], [dk.plain(key, c, tag, width)],
                                what, errs, "deal")
            rows = torch.arange(n, device=dev)
            legal = mask.any(dim=1)
            views = off_alignment(mask) if preset else []
            flat = torch.zeros(words.numel() + 1, dtype=torch.int64, device=dev)
            flat[1:] = words.view(-1)
            off = flat[1:].view(n, -1)                     # 8 bytes past 16
            for c in (0, 2**31, 2**32 - 1):
                want = ws.plain(key, c, words, w)
                draws = [("words_select", ws(key, c, words, w), want),
                         ("words_select", ws(key, c, off, w), want)]
                if preset:
                    draws.append(("uniform_legal", ul(key, c, mask), ul.plain(key, c, mask)))
                for k, got, ref in draws:
                    check_equal([got], [ref], what, errs, k)
                    if not (bool(mask[rows, got][legal].all())
                            and not bool(got[~legal].any())):
                        raise AssertionError(f"{k} drew an illegal action ({what})")
                for lanes in (1, 2, 4, 8, 16, 32):
                    check_equal([select_pick(lanes)(key, c, words, w)], [want],
                                f"{what}, {lanes} lanes", errs, "words_select")
                if preset:
                    want = ul.plain(key, c, mask)
                    for view in views:
                        check_equal([ul(key, c, view)], [want],
                                    f"{what}, mask at {view.data_ptr() % 16} past 16 B",
                                    errs, "uniform_legal")
            line = (f"[phase1] {what}: words_select (S*H = {words.shape[1]}, "
                    f"{select_lanes(words.shape[1])} lanes an env; counters 0, 2**31, "
                    f"2**32 - 1; {int((~legal).sum())} envs with no legal action) == plain "
                    "(bit-equal) at every segment width 1..32 and on words 8 bytes past a "
                    "16-byte boundary, every action legal")
            if preset:
                line += ("; deal (2S-wide at per-env counters, S-wide at 0 and 2**32 - 1) "
                         "and uniform_legal == plain; uniform_legal also on mask views "
                         f"{sorted(v.data_ptr() % 16 for v in views)} bytes past a 16-byte "
                         "boundary == plain")
            print(line)
        key, _, _, words = draw_inputs(cfg, N_MAIN, 0)
        args = (key, 7, words, w)
        b = call_bound("words_select", cfg, args, (ws(*args),))
        ms = cuda_ms(lambda: ws(*args))
        print(f"[phase1] words_select {name} N={N_MAIN} (S*H = {words.shape[1]}): {ms:.6f} ms, "
              f"bound {b['bound_ms']:.6f} ms by {b['bound_by']}, "
              f"{100 * b['bound_ms'] / ms:.1f}% of it ({card})")
    cfg = PRESETS["default"]()
    dk = DealKernel(rules.tables_for(cfg).num_pieces, dev)
    key, counter, mask, words = draw_inputs(cfg, N_MAIN, 0)
    args = {"deal": (dk, (key, counter, rng.TAG_STEP, 2 * cfg.queue_size)),
            "uniform_legal": (ul, (key, 7, mask)),
            "words_select": (ws, (key, 7, words, cfg.width))}
    for k, (kernel, a) in args.items():
        out = kernel(*a)
        bounds[k] = bound(list(a) + [out], COSTS[k](cfg, a, (out,))[1])
        times[k] = (cuda_ms(lambda: kernel(*a)), host_paced_ms(lambda: kernel.plain(*a)))
    floor = cuda_ms(lambda: torch.cuda._sleep(0))
    deal_ms = times["deal"][0]
    print(f"[phase1] launch floor: torch.cuda._sleep(0) {floor:.6f} ms of device time a "
          f"launch, back to back ({card}); deal N={N_MAIN} default {deal_ms:.6f} ms = "
          f"{deal_ms / bounds['deal']['bound_ms']:.2f} x its bound "
          f"({bounds['deal']['bound_by']}), {deal_ms / floor:.2f} x the launch floor; "
          f"words_select {times['words_select'][0]:.6f} ms = "
          f"{times['words_select'][0] / floor:.2f} x the launch floor")


def draws_rollout(sampler: str, plain: bool, n: int, steps: int):
    """The default packed rollout on the card from one seed, actions from
    ``sampler`` (``"argmax"`` or ``"words"``), through the draw kernels or,
    with ``plain``, with their plain versions swapped in (the engine's
    deal and the sampler's draw).  Returns every step's actions, rewards
    and done flags, the final state (on the CPU) and the launch counts."""
    import torch

    from blockpuzzle_tpu_torch import PRESETS, make_env
    from blockpuzzle_tpu_torch.sampler import UniformLegalSampler, WordsSampler

    class Plain:
        """A draw wrapper's plain version in its place."""

        def __init__(self, kernel):
            self.plain = kernel.plain

        def __call__(self, *args):
            return self.plain(*args)

    env = make_env(PRESETS["default"](), device="cuda")
    draw = (UniformLegalSampler if sampler == "argmax" else WordsSampler)(8, n, env.device)
    if plain:
        env.deal_kernel, draw.kernel = Plain(env.deal_kernel), Plain(draw.kernel)
    zero_counts(env)
    state, ts = env.init(7, n)
    trace = []
    for _ in range(steps):
        a = draw(ts.action_mask) if sampler == "argmax" else draw(env, state.board,
                                                                   state.queue)
        state, ts = env.step(state, a)
        trace.append(torch.stack([a, ts.reward.view(torch.int32).long(),
                                  ts.terminated.long(), ts.truncated.long()]))
    return torch.stack(trace).cpu(), state.to("cpu"), read_counts(env)


def draws_check() -> dict:
    """The default packed rollout (N = 49152, 64 steps, live deals,
    auto-reset) through the draw kernels and with their plain versions
    swapped in, for the argmax and the words sampler: actions, rewards,
    done flags and final states bit-equal; the kernel run's launches at
    one deal a step (and one at init) and one draw a step, the plain run's
    at none of the draws.  Returns the kernel runs' launch counts (the
    paths ``draws_argmax``, ``draws_words``)."""
    import torch

    steps, paths = 64, {}
    fields = ("board", "queue", "base_key", "rng_counter", "steps", "score", "streak")
    for sampler, draw, per_step in (
            ("argmax", "uniform_legal", ("packed_mask", "packed_apply")),
            ("words", "words_select",
             ("packed_mask", "packed_apply", "packed_legal_words"))):
        (tk, sk, ck), (tp, sp, cp) = (draws_rollout(sampler, plain, N_MAIN, steps)
                                      for plain in (False, True))
        common = {**dict.fromkeys(per_step, steps), **tail_counts(steps, 1)}
        if ck != expected(**common, deal=steps + 1, **{draw: steps}) or cp != expected(
                **common):
            raise AssertionError(f"draws rollout {sampler}: launches {ck}, plain {cp}")
        if not torch.equal(tk, tp) or not all(
                torch.equal(getattr(sk, f), getattr(sp, f)) for f in fields):
            raise AssertionError(f"draws rollout {sampler}: kernels != plain versions")
        paths[f"draws_{sampler}"] = ck
        print(f"[phase1] draws, default packed rollout N={N_MAIN} {steps} steps, "
              f"{sampler} sampler: actions, rewards, done flags "
              f"({int(tk[:, 2].sum())} terminated) and final states bit-equal through "
              f"the kernels and through their plain versions; launches deal "
              f"{ck['deal']}, {draw} {ck[draw]} (plain run: 0)")
    return paths


def general_calls(cfg, mk, ck, lib=None):
    """Callables that launch the general mask and clear kernels (``bp_mask``,
    ``bp_clear``) on ``cfg``'s boards, whatever kernel the wrappers ``mk``
    and ``ck`` pick there: the per-cell piece table and the line tables, as
    the wrappers call them on a board they take no other kernel for; the
    current library's, or ``lib``'s (an earlier build's, whose entries take
    the same arguments)."""
    import torch

    from blockpuzzle_tpu_torch.kernels import _build
    from blockpuzzle_tpu_torch.kernels.collision import piece_table

    lib, dev = lib or _build.library(), ck.device
    table = torch.as_tensor(piece_table(cfg), device=dev)
    lines = ck.lines

    def stream():
        return torch.cuda.current_stream(dev).cuda_stream

    def mask(board, queue):
        n = board.shape[0]
        out = torch.empty((n, cfg.queue_size * cfg.num_cells), dtype=torch.bool,
                          device=dev)
        _build.check(lib.bp_mask(
            board.data_ptr(), queue.data_ptr(), table.data_ptr(), out.data_ptr(), n,
            cfg.height, cfg.width, cfg.queue_size, mk.num_pieces, table.shape[1] - 3,
            stream()), "bp_mask")
        return out

    def clear(board):
        n = board.shape[0]
        out, k = torch.empty_like(board), torch.empty(n, dtype=torch.int32, device=dev)
        _build.check(lib.bp_clear(
            board.data_ptr(), lines.line_cells.data_ptr(), lines.line_len.data_ptr(),
            out.data_ptr(), k.data_ptr(), n, cfg.num_cells, lines.line_cells.shape[0],
            lines.line_cells.shape[1], stream()), "bp_clear")
        return out, k

    return mask, clear


def general_apply_pass(cfg, staged: bool):
    """A callable with ``PackedApplyKernel``'s arguments that launches the
    general packed apply with the pass 2 ``staged`` picks (the placed rows
    kept in shared memory, or the input read again) through
    ``bp_packed_apply_general_pass``."""
    import torch

    from blockpuzzle_tpu_torch.kernels import _build

    lib = _build.library()
    region = cfg.region_size if cfg.region_clear else 0

    def apply(words, attrs, r, c, valid):
        n = words.shape[0]
        out = torch.empty_like(words)
        k = torch.empty(n, dtype=torch.int32, device=words.device)
        legal = torch.empty(n, dtype=torch.bool, device=words.device)
        _build.check(lib.bp_packed_apply_general_pass(
            words.data_ptr(), attrs.data_ptr(), r.data_ptr(), c.data_ptr(), valid.data_ptr(),
            out.data_ptr(), k.data_ptr(), legal.data_ptr(), n, cfg.height, cfg.width, region,
            int(staged), torch.cuda.current_stream(words.device).cuda_stream),
            "bp_packed_apply_general_pass")
        return out, k, legal

    return apply


def general_mask_pick(cfg, pmk, windowed: bool, words: bool = False):
    """A callable with ``PackedMaskKernel``'s arguments that launches the
    general packed mask's kernel ``windowed`` picks (the warp over windows
    of 32 rows, or the thread an anchor row) through
    ``bp_packed_mask_general_pick``, or with ``words`` its words entry's
    through ``bp_packed_words_general_pick``."""
    import torch

    from blockpuzzle_tpu_torch.kernels import _build

    lib = _build.library()
    entry = "bp_packed_words_general_pick" if words else "bp_packed_mask_general_pick"

    def mask(board_words, queue):
        n = board_words.shape[0]
        shape, dtype = ((n, cfg.queue_size * cfg.height), torch.int64) if words else (
            (n, cfg.queue_size * cfg.num_cells), torch.bool)
        out = torch.empty(shape, dtype=dtype, device=board_words.device)
        _build.check(getattr(lib, entry)(
            *pmk._args(board_words, queue, out), int(windowed),
            torch.cuda.current_stream(board_words.device).cuda_stream), entry)
        return out

    return mask


# env-slots a block phase 1 also launches the tall packed mask and words
# at, beside the wrapper's (``kernels/packed.py`` ``anchor_launch_shape``):
# odd counts (spans off a 16-byte boundary on 33x9 and 36x9, a block
# staging and storing as one on 64x8) and 4 and 6 (a warp staging and
# storing its own env-slots: the mask's on 64x8 at 4, on 128x10 at both;
# the words' on 64x8 at 4 and 6, on 128x10 at every count)
ANCHOR_TURN_ENVS = (1, 4, 5, 6, 7)


def anchor_pick(cfg, pmk, envs: int, words: bool = False, lib=None):
    """A callable with ``PackedMaskKernel``'s arguments that launches the
    tall packed mask (``bp_packed_mask_tall``), or with ``words`` its words
    entry (``bp_packed_words_tall``), at ``envs`` env-slots a block: the
    current library's, or ``lib``'s (another build of the same entries)."""
    import torch

    from blockpuzzle_tpu_torch.kernels import _build

    lib = lib or _build.library()
    entry = "bp_packed_words_tall" if words else "bp_packed_mask_tall"

    def mask(board_words, queue):
        n = board_words.shape[0]
        size, dtype = ((n, cfg.queue_size * cfg.height), torch.int64) if words else (
            (n, cfg.queue_size * cfg.num_cells), torch.bool)
        out = torch.empty(size, dtype=dtype, device=board_words.device)
        _build.check(getattr(lib, entry)(
            *pmk._args(board_words, queue, out), envs,
            torch.cuda.current_stream(board_words.device).cuda_stream), entry)
        return out

    return mask


def select_pick(lanes: int, lib=None):
    """A callable with ``WordsSelectKernel``'s arguments that launches B2w
    at ``lanes`` threads an env (``bp_words_select_lanes``): the current
    library's, or ``lib``'s."""
    import torch

    from blockpuzzle_tpu_torch.env import rng
    from blockpuzzle_tpu_torch.kernels import _build

    lib = lib or _build.library()

    def select(key, counter, words, width):
        out = torch.empty(key.shape[0], dtype=torch.int64, device=key.device)
        _build.check(lib.bp_words_select_lanes(
            key.data_ptr(), counter & rng.MASK32, rng.TAG_POLICY, words.data_ptr(),
            out.data_ptr(), key.shape[0], words.shape[1], width, lanes,
            torch.cuda.current_stream(key.device).cuda_stream), "bp_words_select_lanes")
        return out

    return select


def words_pick(cfg, pmk, kind: str, envs: int = 0, lib=None):
    """A callable with ``PackedMaskKernel.words``' arguments on a board of at
    most 128 rows that launches the words kernel ``kind`` names, whatever
    the wrapper picks there: ``"rows"``, the bit-row kernel
    (``bp_packed_words``, H <= 32), or ``"tall"``, the tall words kernel at
    ``envs`` env-slots a block (``bp_packed_words_tall``; by default the
    words entry's ``anchor_launch_shape``): the current library's, or
    ``lib``'s."""
    import torch

    from blockpuzzle_tpu_torch.kernels import _build
    from blockpuzzle_tpu_torch.kernels.packed import anchor_launch_shape, segments_per_warp

    lib = lib or _build.library()
    entry, shape = (("bp_packed_words", segments_per_warp(cfg.height)) if kind == "rows" else
                    ("bp_packed_words_tall",
                     envs or anchor_launch_shape(cfg, words=True)[0]))

    def words(board_words, queue):
        out = torch.empty((board_words.shape[0], cfg.queue_size * cfg.height),
                          dtype=torch.int64, device=board_words.device)
        _build.check(getattr(lib, entry)(
            *pmk._args(board_words, queue, out), shape,
            torch.cuda.current_stream(board_words.device).cuda_stream), entry)
        return out

    return words


def general_apply(cfg, ak, lib=None):
    """A callable with ``ApplyKernel``'s arguments that launches the general
    u8 apply (``bp_apply``) on ``cfg``'s boards, whatever kernel the wrapper
    ``ak`` picks there, with its line tables: the current library's, or
    ``lib``'s (an earlier build's, whose ``bp_apply`` takes the same
    arguments)."""
    import torch

    from blockpuzzle_tpu_torch.kernels import _build

    lib, dev, lines = lib or _build.library(), ak.device, ak.lines

    def apply(board, cover, valid):
        n = board.shape[0]
        out = torch.empty_like(board)
        k = torch.empty(n, dtype=torch.int32, device=dev)
        legal = torch.empty(n, dtype=torch.bool, device=dev)
        _build.check(lib.bp_apply(
            board.data_ptr(), cover.data_ptr(), valid.data_ptr(),
            lines.line_cells.data_ptr(), lines.line_len.data_ptr(), out.data_ptr(),
            k.data_ptr(), legal.data_ptr(), n, cfg.num_cells, lines.line_cells.shape[0],
            lines.line_cells.shape[1], torch.cuda.current_stream(dev).cuda_stream),
            "bp_apply")
        return out, k, legal

    return apply


def wide_turns(card: str, tag: str, rounds: int = 5) -> None:
    """The u8 kernels of the wide board at N = 49152 on the same inputs,
    each timed by ``cuda_ms`` in turns with the others for ``rounds``
    rounds: the wide mask, the general mask launched directly on the same
    board, the wide clear, the general clear likewise, the wide apply, the
    general apply likewise, the wide legality and the general legality
    likewise, then again.  The wide kernels are first held bit-equal to the
    general ones; each kernel's times are printed in order with their
    median, and each wide kernel's median beside the general one's."""
    import torch

    from blockpuzzle_tpu_torch.config import EnvConfig
    from blockpuzzle_tpu_torch.kernels import (
        ApplyKernel, ClearScanKernel, LegalityKernel, MaskKernel,
    )

    dev = torch.device("cuda")
    cfg = EnvConfig(**WIDE)
    mk, ck = MaskKernel(cfg, dev), ClearScanKernel(cfg, dev)
    ak, lk = ApplyKernel(cfg, dev), LegalityKernel(cfg, dev)
    if not (mk.wide and ck.wide and ak.kind == lk.kind == "wide"):
        raise AssertionError("the wrappers did not pick the wide kernels on 8x40")
    general_mask, general_clear = general_calls(cfg, mk, ck)
    replaced_apply = general_apply(cfg, ak)
    replaced_legality = general_legality(cfg, lk)
    board, queue, cover, valid = (torch.as_tensor(x, device=dev)
                                  for x in kernel_inputs(cfg, N_MAIN, seed=0)[:4])
    if not torch.equal(mk(board, queue), general_mask(board, queue)):
        raise AssertionError("mask_wide != mask_general on 8x40")
    if not all(torch.equal(a, b) for a, b in zip(ck(board), general_clear(board))):
        raise AssertionError("clear_wide != clear_general on 8x40")
    if not all(torch.equal(a, b) for a, b in zip(ak(board, cover, valid),
                                                replaced_apply(board, cover, valid))):
        raise AssertionError("apply_wide != apply_general on 8x40")
    if not torch.equal(lk(board), replaced_legality(board)):
        raise AssertionError("legality_wide != legality_general on 8x40")
    calls = {"mask_wide": lambda: mk(board, queue),
             "mask_general": lambda: general_mask(board, queue),
             "clear_wide": lambda: ck(board), "clear_general": lambda: general_clear(board),
             "apply_wide": lambda: ak(board, cover, valid),
             "apply_general": lambda: replaced_apply(board, cover, valid),
             "legality_wide": lambda: lk(board),
             "legality_general": lambda: replaced_legality(board)}
    times = {k: [] for k in calls}
    for _ in range(rounds):
        for k, f in calls.items():
            times[k].append(cuda_ms(f))
    print(f"[{tag}] wide 8x40 N={N_MAIN}: mask_wide == mask_general, clear_wide == "
          "clear_general, apply_wide == apply_general and legality_wide == "
          "legality_general, launched directly on the same inputs (bit-equal)")
    for k, ts in times.items():
        print(f"[{tag}] {k} N={N_MAIN} wide 8x40, {rounds} rounds in turns with the "
              f"other kernels of the board, device ms: {', '.join(f'{t:.6f}' for t in ts)}; "
              f"median {statistics.median(ts):.6f} ({card})")
    for k in ("mask", "clear", "apply", "legality"):
        wide, general = (statistics.median(times[f"{k}_{v}"]) for v in ("wide", "general"))
        print(f"[{tag}] {k} 8x40 medians: general {general:.6f} ms, wide {wide:.6f} ms, "
              f"{general / wide:.2f}x ({card})")


def tall_turns(card: str, tag: str, rounds: int = 5) -> dict:
    """The tall mask, clear and apply at N = 49152 on 33x9 and on 40x40 (the
    JAX engine's u8 default there), each beside the general kernel it
    replaces launched directly on the same inputs (``general_calls``,
    ``general_apply``), held bit-equal to it, then all six timed by
    ``cuda_ms`` in turns for ``rounds`` rounds; prints each kernel's times
    with their median and each tall kernel's median beside the general
    one's.  Returns board -> kernel -> median device ms."""
    import torch

    from blockpuzzle_tpu_torch.config import EnvConfig
    from blockpuzzle_tpu_torch.kernels import ApplyKernel, ClearScanKernel, MaskKernel

    dev = torch.device("cuda")
    medians = {}
    for name in ("33x9", "40x40"):
        cfg = EnvConfig(**TALL_U8_CASES[name])
        mk, ck, ak = MaskKernel(cfg, dev), ClearScanKernel(cfg, dev), ApplyKernel(cfg, dev)
        if (mk.name, ck.name, ak.name) != ("mask_tall", "clear_tall", "apply_tall"):
            raise AssertionError(f"the wrappers did not pick the tall kernels on {name}")
        general_mask, general_clear = general_calls(cfg, mk, ck)
        replaced_apply = general_apply(cfg, ak)
        board, queue, cover, valid = (torch.as_tensor(x, device=dev)
                                      for x in kernel_inputs(cfg, N_MAIN, seed=0)[:4])
        if not torch.equal(mk(board, queue), general_mask(board, queue)):
            raise AssertionError(f"mask_tall != mask_general on {name}")
        if not all(torch.equal(a, b) for a, b in zip(ck(board), general_clear(board))):
            raise AssertionError(f"clear_tall != clear_general on {name}")
        if not all(torch.equal(a, b) for a, b in zip(ak(board, cover, valid),
                                                    replaced_apply(board, cover, valid))):
            raise AssertionError(f"apply_tall != apply_general on {name}")
        calls = {"mask_tall": lambda: mk(board, queue),
                 "mask_general": lambda: general_mask(board, queue),
                 "clear_tall": lambda: ck(board), "clear_general": lambda: general_clear(board),
                 "apply_tall": lambda: ak(board, cover, valid),
                 "apply_general": lambda: replaced_apply(board, cover, valid)}
        times = {k: [] for k in calls}
        for _ in range(rounds):
            for k, f in calls.items():
                times[k].append(cuda_ms(f))
        print(f"[{tag}] tall {name} N={N_MAIN}: mask_tall == mask_general, clear_tall "
              "== clear_general and apply_tall == apply_general, launched directly on the "
              "same inputs (bit-equal)")
        for k, ts in times.items():
            print(f"[{tag}] {k} N={N_MAIN} tall {name}, {rounds} rounds in turns with the "
                  f"other kernels of the board, device ms: "
                  f"{', '.join(f'{t:.6f}' for t in ts)}; median "
                  f"{statistics.median(ts):.6f} ({card})")
        medians[name] = {k: statistics.median(ts) for k, ts in times.items()}
        for k in ("mask", "clear", "apply"):
            tall, general = (medians[name][f"{k}_{v}"] for v in ("tall", "general"))
            print(f"[{tag}] {k} {name} medians: general {general:.6f} ms, tall "
                  f"{tall:.6f} ms, {general / tall:.2f}x ({card})")
    return medians


def hand_rows(legal_all, queue):
    """The (N, S*HW) hand mask read off the (N, P, HW) legality map (an
    all-False row for the empty sentinel)."""
    import torch

    n, num_pieces, hw = legal_all.shape
    padded = torch.cat([legal_all, legal_all.new_zeros(n, 1, hw)], dim=1)
    pid = queue.clamp(0, num_pieces).to(torch.int64)
    return padded.gather(1, pid[:, :, None].expand(-1, -1, hw)).reshape(n, -1)


def phase2():
    """Returns the maximum absolute error of ``legal_all_pieces`` against
    its plain version on the presets and on the wide, tall and huge boards,
    and the launch counts of those boards' rollouts and of
    ``legal_all_pieces`` there (the paths ``wide_u8_pallas``,
    ``wide_u8_jnp``, ``wide_legal_all_pieces``, their ``tall_`` and
    ``huge_`` twins, ``xwide_u8_pallas``, ``xwide_u8_jnp`` and
    ``xwide_legal_all_pieces`` and their ``xtall_``, ``w1056_`` and ``w4128_`` twins,
    ``big100_u8_jnp`` (the default engine on 100x124) and
    ``big100_legal_all_pieces``, ``tall_packed``, ``huge_packed``,
    ``tall_words`` and ``huge_words``, and those of the other tall
    boards)."""
    import torch

    from blockpuzzle_tpu_torch import PRESETS, make_env
    from blockpuzzle_tpu_torch.config import EnvConfig
    from blockpuzzle_tpu_torch.sampler import UniformLegalSampler

    fields = ("queue", "base_key", "rng_counter", "steps", "score", "streak")
    # engine -> make_env arguments; the kernels each launches once per step
    # are the mask with the apply (pallas) or the clear (jnp) that the
    # board takes (``u8_kernel_names``), the packed engine's on boards of at
    # most 32 columns (``packed_kernel_names``): the default engine there
    # (``default``: the same engine, run on wider boards, where it is the
    # u8 clear-kernel step)
    engines = {"packed": dict(), "pallas": dict(backend="pallas", state_impl="u8"),
               "jnp": dict(backend="jnp", state_impl="u8"), "default": dict()}
    # board -> (config, engines run, N, steps); the presets run all three
    boards = {name: (PRESETS[name](), ("packed", "pallas", "jnp"), 1024, 64)
              for name in PACKED_PRESETS}
    boards.update({
        "wide": (EnvConfig(**WIDE), ("pallas", "jnp"), 1024, 64),
        "tall": (EnvConfig(**TALL), ("packed", "pallas", "jnp"), 1024, 64),
        "tall36r3": (EnvConfig(**TALL36R3), ("packed", "jnp"), 1024, 64),
        "tall64": (EnvConfig(**TALL_PACKED_CASES["64x8"]), ("packed",), 1024, 64),
        "tall128": (EnvConfig(**TALL_PACKED_CASES["128x10"]), ("packed",), 1024, 64),
        # the plain u8 mask's product grows with the square of the cells
        "huge": (EnvConfig(**HUGE), ("packed", "pallas", "jnp"), 256, 32),
        # rows of more than 128 cells: the xwide u8 mask's and clear's
        # paths, and past 1024 cells their long-row instances'
        "xwide": (EnvConfig(**XWIDE), ("pallas", "jnp"), 256, 32),
        "xtall": (EnvConfig(**XTALL), ("pallas", "jnp"), 128, 16),
        "w1056": (EnvConfig(**W1056), ("pallas", "jnp"), 256, 32),
        # past 4096 cells a row: the general mask's, clear's, apply's and
        # legality's paths
        "w4128": (EnvConfig(**W4128), ("pallas", "jnp"), 64, 8),
        # more than 12288 cells and lines: the default engine, u8
        "big100": (EnvConfig(**BIG100), ("default",), 64, 8),
    })
    errs, paths = {k: 0 for k in KERNEL_INFO if k.startswith("legality")}, {}
    for name, (cfg, run, n, steps) in boards.items():
        board_path = name not in PACKED_PRESETS   # their launches are paths
        mask_name, clear_name, apply_name, legal_name = u8_kernel_names(cfg)
        steps_of = {"pallas": (mask_name, apply_name), "jnp": (mask_name, clear_name)}
        steps_of["default"] = steps_of["jnp"]
        if cfg.width <= 32:
            steps_of["packed"] = steps_of["default"] = packed_kernel_names(cfg)[:2]
        finals, boards_out, rewards, envs = {}, {}, {}, {}
        for engine in run:
            kwargs, per_step = engines[engine], steps_of[engine]
            for dev in ("cuda", "cpu"):
                env = make_env(cfg, device=dev, **kwargs)
                packed = engine == "packed" or (engine == "default" and cfg.width <= 32)
                if env.state_impl != ("packed" if packed else "u8"):
                    raise AssertionError(f"{name}: the default engine is {env.state_impl}")
                zero_counts(env)
                state, ts = env.init(7, n)
                sampler = UniformLegalSampler(8, n, env.device)
                total = torch.zeros((), dtype=torch.float64, device=env.device)
                for _ in range(steps):
                    state, ts = env.step(state, sampler(ts.action_mask))
                    total = total + ts.reward.sum(dtype=torch.float64)
                if dev == "cuda":
                    counts = read_counts(env)
                    expect = expected(**dict.fromkeys(per_step, steps), deal=steps + 1,
                                      uniform_legal=steps,
                                      **(tail_counts(steps, 1) if packed else {}))
                    if counts != expect:
                        raise AssertionError(
                            f"{name} {engine} launch counts {counts} != {expect}")
                    if board_path:
                        label = ("packed" if packed else "u8_jnp" if engine == "default"
                                 else f"u8_{engine}")
                        paths[f"{name}_{label}"] = counts
                    envs[engine] = (env, state)
                finals[engine, dev] = state.to("cpu")
                boards_out[engine, dev] = env.board_obs(state.board).cpu()
                rewards[engine, dev] = float(total)
        pairs = [((e, "cuda"), (e, "cpu")) for e in run]
        pairs += [((run[0], "cuda"), (e, "cuda")) for e in run[1:]]
        for a, b in pairs:
            same = torch.equal(boards_out[a], boards_out[b]) and all(
                torch.equal(getattr(finals[a], f), getattr(finals[b], f))
                for f in fields)
            if not same:
                raise AssertionError(f"{name}: final states differ {a} vs {b}")
            if rewards[a] != rewards[b]:
                raise AssertionError(f"{name}: summed rewards differ {a} vs {b}")
        print(f"[phase2] {name} {cfg.height}x{cfg.width} N={n} {steps} steps: "
              f"{', '.join(run)} engines, each CUDA == CPU, and {run[0]} CUDA == "
              f"every other engine on CUDA (final states bit-equal), summed reward "
              f"{rewards[run[0], 'cuda']}, launches per step "
              + "; ".join(f"{e}: " + " ".join(f"{k}=1" for k in steps_of[e])
                          for e in run) + ", deal=1 and uniform_legal=1 on each (deal "
              "once more at init)")
        for engine in run:
            env, state = envs[engine]
            zero_counts(env)
            legal_all = env.legal_all_pieces(state.board)
            counts = read_counts(env)
            # a packed board is unpacked first
            unpack = {"packed_unpack": 1} if engine == "packed" else {}
            if counts != expected(**{legal_name: 1}, **unpack):
                raise AssertionError(f"{name} legal_all_pieces launches {counts}")
            if board_path:
                paths[f"{name}_legal_all_pieces"] = counts
            plain = env.legal_kernel.plain(
                env.board_obs(state.board).reshape(n, -1).contiguous())
            errs[legal_name] = max(errs[legal_name], max_abs_err(legal_all, plain))
            if not torch.equal(legal_all, plain):
                raise AssertionError(f"{name}: legal_all_pieces != plain ({engine})")
            if not torch.equal(hand_rows(legal_all, state.queue),
                               env.action_mask(state.board, state.queue)):
                raise AssertionError(
                    f"{name}: legal_all_pieces hand rows != action_mask ({engine})")
        print(f"[phase2] {name}: legal_all_pieces on the final boards == plain, "
              f"hand rows == action_mask ({legal_name} launched once a call)")
        if name in ("tall", "tall36r3", "huge"):
            paths[f"{name}_words"] = words_check(name, cfg, n, steps)
    return errs, paths


def words_check(name: str, cfg, n: int, steps: int) -> dict:
    """The words rollout (``WordsSampler`` on the packed mask kernel's
    words entry) on ``cfg`` on CUDA against the CPU: actions, final states
    and summed rewards bit-equal, every action legal, one launch of the
    board's packed mask, apply and words kernels a step.  Returns the CUDA
    run's launch counts."""
    import torch

    per_step = packed_kernel_names(cfg)
    (sg, rg, ag, lg, env), (sc, rc, ac, lc, _) = (
        words_rollout(cfg, dev, n, steps) for dev in ("cuda", "cpu"))
    counts = read_counts(env)
    expect = expected(**dict.fromkeys(per_step, steps), deal=steps + 1, words_select=steps,
                      **tail_counts(steps, 1))
    if counts != expect:
        raise AssertionError(f"{name} words rollout launches {counts} != {expect}")
    if not (lg and lc):
        raise AssertionError(f"{name}: the words sampler drew an illegal action")
    fields = ("board", "queue", "rng_counter", "steps", "score", "streak")
    if not torch.equal(ag, ac) or rg != rc or not all(
            torch.equal(getattr(sg, f), getattr(sc, f)) for f in fields):
        raise AssertionError(f"{name}: words rollout differs CUDA vs CPU")
    print(f"[phase2] {name} words rollout N={n} {steps} steps: actions, final states "
          f"and summed reward ({rg}) CUDA == CPU, every action legal, launches per "
          "step " + " ".join(f"{k}=1" for k in per_step) + " deal=1 words_select=1")
    return counts


def phase3(card: str):
    """Returns the launch counts of the two rollout paths (``rollout``: the
    default, packed engine; ``rollout_pallas``: the u8 apply-kernel step)
    and of the ``legal_all_pieces`` entry point, and the packed rollout's
    median rate."""
    import torch

    from blockpuzzle_tpu_torch import PRESETS, make_env
    from blockpuzzle_tpu_torch.cli.rollout import rollout

    chunk, windows = 400, 5
    steps = (windows + 1) * chunk
    paths = {}
    for path, kwargs, per_step in (
            ("rollout", {}, ("packed_mask", "packed_apply")),
            ("rollout_pallas", {"backend": "pallas"}, ("mask", "apply"))):
        env = make_env(PRESETS["default"](), device="cuda", **kwargs)
        zero_counts(env)
        r = rollout(env, N_MAIN, chunk, windows, seed=0)
        paths[path] = read_counts(env)
        expect = expected(**dict.fromkeys(per_step, steps), deal=steps + 1,
                          uniform_legal=steps,
                          **(tail_counts(steps, 1) if path == "rollout" else {}))
        if paths[path] != expect:
            raise AssertionError(f"{path} path launches {paths[path]} != {expect}")
        s = r["state"]
        cells = env.board_obs(s.board)
        if cells.shape != (N_MAIN, env.cfg.height, env.cfg.width) or int(cells.max()) > 1:
            raise AssertionError("final boards malformed")
        if int(s.queue.min()) < 0 or int(s.queue.max()) > env.num_pieces:
            raise AssertionError("final queues out of range")
        if not bool(torch.isfinite(s.score).all()):
            raise AssertionError("non-finite scores")
        mean_return = r["episode_return"] / max(r["episodes"], 1)
        # uniform-legal play on the default preset returns ~78 per episode
        if r["episodes"] == 0 or not 60.0 < mean_return < 100.0:
            raise AssertionError(f"implausible episodes: {r['episodes']}, "
                                 f"mean return {mean_return}")
        rates = r["rates"]
        print(f"[phase3] {path} ({env.state_impl}, backend {env.backend}) "
              f"default N={N_MAIN}: windows of {chunk} steps (env-steps/s) "
              f"{[round(x) for x in rates]}")
        print(f"[phase3] {path} median {statistics.median(rates):.1f} "
              f"env-steps/s ({card}); episodes {r['episodes']}, mean return "
              f"{mean_return:.3f}; launches {paths[path]}")
        if path == "rollout":
            packed_env, final, packed_rate = env, s, statistics.median(rates)
    zero_counts(packed_env)
    legal_all = packed_env.legal_all_pieces(final.board)
    paths["legal_all_pieces"] = read_counts(packed_env)
    expect = expected(legality=1, packed_unpack=1)
    if paths["legal_all_pieces"] != expect:
        raise AssertionError(
            f"legal_all_pieces launches {paths['legal_all_pieces']} != {expect}")
    if not torch.equal(hand_rows(legal_all, final.queue),
                       packed_env.packed_mask_kernel.plain(final.board, final.queue)):
        raise AssertionError("legal_all_pieces hand rows != the hand mask")
    print(f"[phase3] legal_all_pieces on the packed rollout's final boards: "
          f"launches {paths['legal_all_pieces']}, hand rows == the hand mask")
    return paths, packed_rate


def learner_cuda_vs_cpu(learner, state) -> None:
    """A fresh network at the path's widths on CUDA and its copy on the
    CPU, over one minibatch of a CUDA rollout, with the tolerances of
    ``tests/test_torch_ppo.py``: logits and values within abs 2e-2
    (masked logits exactly ``NEG_INF``), the loss and its metrics within
    1e-2 relative, each gradient within 2e-2 relative L2."""
    import copy
    import dataclasses

    import torch

    from blockpuzzle_tpu_torch.learn.networks import NEG_INF

    cfg = learner.cfg
    net = learner.make_net(torch.Generator().manual_seed(1))
    cpu_net = copy.deepcopy(net).cpu()
    _, batch, last_value, _ = learner._rollout(state.replace(net=net))
    adv, ret = (x.flatten() for x in learner._gae(batch, last_value))
    rows = cfg.num_envs * cfg.rollout_len // cfg.num_minibatches
    mb = batch.map(lambda x: x.flatten(0, 1)[:rows])
    # old log-probs moved off the network's, so that the ratios are not 1
    dev = learner.env.device
    gen = torch.Generator(device=dev).manual_seed(2)
    noise = torch.randn(rows, generator=gen, device=dev)
    mb = dataclasses.replace(mb, log_prob=mb.log_prob + 0.1 * noise)
    outs = []
    for m, dev in ((net, dev), (cpu_net, "cpu")):
        b = mb.map(lambda x: x.to(dev))
        with torch.no_grad():
            logits, value = m(b.board, b.queue, b.action_mask)
        m.zero_grad(set_to_none=True)
        loss, metrics = learner._loss(m, b, adv[:rows].to(dev), ret[:rows].to(dev))
        loss.backward()
        outs.append((logits.cpu(), value.cpu(),
                     {k: float(v) for k, v in metrics.items()},
                     {n: p.grad.cpu() for n, p in m.named_parameters()}))
    (lg, vg, mg, gg), (lc, vc, mc, gc) = outs
    legal = mb.action_mask.cpu()
    if not bool((lg[~legal] == NEG_INF).all() and (lc[~legal] == NEG_INF).all()):
        raise AssertionError("masked logits are not NEG_INF")
    logit_err = float((lg[legal] - lc[legal]).abs().max())
    value_err = float((vg - vc).abs().max())
    metric_err = max(abs(mg[k] - mc[k]) / max(abs(mc[k]), 1e-12) for k in mc)
    grad_err, worst = max(
        (float((gg[n] - gc[n]).norm() / gc[n].norm().clamp_min(1e-12)), n)
        for n in gc)
    print(f"[phase4] fresh {cfg.torso}/{cfg.queue_mode} network, CUDA vs CPU, "
          f"one minibatch of {rows} rows: "
          f"logits max abs err {logit_err:.3e}, values {value_err:.3e}, loss "
          f"metrics max rel err {metric_err:.3e}, gradients max rel L2 err "
          f"{grad_err:.3e} ({worst}) (limits 2e-2, 2e-2, 1e-2, 2e-2)")
    if logit_err > 2e-2 or value_err > 2e-2:
        raise AssertionError("learner logits or values: CUDA != CPU")
    for k in mc:
        if abs(mg[k] - mc[k]) > 1e-6 + 1e-2 * abs(mc[k]):
            raise AssertionError(f"learner {k}: CUDA {mg[k]} != CPU {mc[k]}")
    if grad_err > 2e-2:
        raise AssertionError("learner gradients: CUDA != CPU")


def phase4(card: str) -> dict:
    """Returns the launch counts of the two training paths (``train``: the
    JAX CLI's defaults, conv torso on the packed engine; ``train_u8``: the
    mlp torso on the u8 clear-kernel step)."""
    return {"train": train_path(card, TRAIN_ARGV, ("packed_mask", "packed_apply")),
            "train_u8": train_path(card, TRAIN_U8_ARGV, ("mask", "clear"))}


def train_path(card: str, argv, kernels) -> dict:
    """``cli/train.py`` with ``argv``; ``kernels`` are the engine's mask
    and apply kernels, launched T + 1 and T times per update."""
    import math

    import torch

    from blockpuzzle_tpu_torch.cli import train

    args = train.build_parser().parse_args(argv)
    learner = train.build(args)
    env = learner.env
    zero_counts(env)
    r = train.train(args, learner)
    launches = read_counts(env)
    t = args.rollout_len
    mask_kernel, apply_kernel = kernels
    # the deal: once a step and once at init; on packed boards the tail once
    # a step and the unpack at init and at each update's ``observe``
    packed = mask_kernel.startswith("packed")
    expect = expected(**{mask_kernel: args.updates * (t + 1),
                         apply_kernel: args.updates * t}, deal=args.updates * t + 1,
                      **(tail_counts(args.updates * t, args.updates + 1) if packed else {}))
    if launches != expect:
        raise AssertionError(f"training path launches {launches} != {expect}")
    m = r["metrics"]
    for k in ("loss", "policy_loss", "value_loss", "entropy", "episode_return"):
        if not math.isfinite(m[k]):
            raise AssertionError(f"training metric {k} = {m[k]}")
    if m["illegal_action_rate"] != 0.0 or m["episodes_finished"] == 0:
        raise AssertionError(f"implausible training rollout: {m}")
    if r["state"].update_count != args.updates:
        raise AssertionError("update count")
    sps = r["env_steps_per_s"]
    update_ms = 1e3 * args.num_envs * t / sps
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    learner._rollout(r["state"])
    torch.cuda.synchronize()
    rollout_ms = 1e3 * (time.perf_counter() - t0)
    width = (f"channels {learner.cfg.channels}" if args.torso == "conv"
             else f"mlp_width {args.mlp_width}")
    print(f"[phase4] PPO default, {args.torso} torso ({width}, hidden "
          f"{learner.cfg.hidden}), {env.state_impl} engine, N={args.num_envs} "
          f"T={t}: {args.updates} updates, last loss {m['loss']:.6f}, "
          f"return {m['episode_return']:.3f}, entropy {m['entropy']:.4f}; "
          f"launches {launches}")
    print(f"[phase4] {sps:.1f} env-steps/s of training over updates 2-"
          f"{args.updates}, {update_ms:.3f} ms per update, of which a rollout "
          f"alone takes {rollout_ms:.3f} ms ({card})")
    learner_cuda_vs_cpu(learner, r["state"])
    return launches


def phase5() -> None:
    """The oracle parity harness on the card: ``check_seed`` for each seed
    and ``check_batched_lockstep`` over all of them, through the packed
    and the u8 engine on CUDA, on every preset; any mismatch raises."""
    from blockpuzzle_tpu_torch import PRESETS, make_env
    from blockpuzzle_tpu_torch.cli import parity

    seeds = list(range(PARITY_SEEDS))
    for name in PACKED_PRESETS:
        cfg = PRESETS[name]()
        for state_impl in ("packed", "u8"):
            env = make_env(cfg, device="cuda", state_impl=state_impl)
            steps = 0
            for seed in seeds:
                r = parity.check_seed(cfg, seed, 512, env=env)
                if r["mismatches"] or r["oracle_return"] != r["device_return"]:
                    raise AssertionError(f"parity {name} {state_impl} seed {seed}: {r}")
                steps += r["steps"]
            b = parity.check_batched_lockstep(cfg, env, seeds, 512)
            if b["mismatches"] or not b["returns_equal"]:
                raise AssertionError(f"lockstep parity {name} {state_impl}: {b}")
            print(f"[phase5] {name}, {state_impl} engine on {env.device}: "
                  f"{len(seeds)} oracle episodes ({steps} steps) bit-exact one by "
                  "one and as one lockstep batch")


def qnetwork_cuda_vs_cpu(learner, state) -> None:
    """A fresh Q-network at the path's widths (and a second as the target)
    on CUDA and their copies on the CPU, over one batch of ``batch_size``
    replay rows of the CUDA run, with the tolerances of
    ``tests/test_torch_dqn.py``: Q-values within abs 2e-2 (masked ones
    exactly ``NEG_INF``), the TD loss and its metrics within 1e-2
    relative, each gradient within 2e-2 relative L2."""
    import copy

    import torch

    from blockpuzzle_tpu_torch.learn.networks import NEG_INF

    cfg = learner.cfg
    nets = [learner.make_net(torch.Generator().manual_seed(s)) for s in (1, 2)]
    cpu_nets = [copy.deepcopy(n).cpu() for n in nets]
    sample = learner.sample_rows(state.replay, torch.arange(
        cfg.batch_size, device=learner.env.device))
    weights = None
    if cfg.per:
        gen = torch.Generator(device=learner.env.device).manual_seed(3)
        weights = torch.rand(cfg.batch_size, generator=gen,
                             device=learner.env.device) + 0.1
    outs = []
    for (net, target), dev in ((nets, learner.env.device), (cpu_nets, "cpu")):
        s = {k: v.to(dev) for k, v in sample.items()}
        with torch.no_grad():
            q = net(s["board"].view(-1, *learner.env.cfg.board_shape), s["queue"],
                    s["action_mask"])
        net.zero_grad(set_to_none=True)
        loss, aux = learner._td_loss(net, target, s, cfg.gamma,
                                     None if weights is None else weights.to(dev))
        loss.backward()
        outs.append((q.cpu(), {k: v.cpu() for k, v in aux.items()},
                     {n: p.grad.cpu() for n, p in net.named_parameters()}))
    (qg, ag, gg), (qc, ac, gc) = outs
    legal = sample["action_mask"].cpu()
    if not bool((qg[~legal] == NEG_INF).all() and (qc[~legal] == NEG_INF).all()):
        raise AssertionError("masked Q-values are not NEG_INF")
    q_err = float((qg[legal] - qc[legal]).abs().max())
    metrics = ("loss", "q_mean", "td_abs")
    aux_err = max(abs(float(ag[k]) - float(ac[k])) / max(abs(float(ac[k])), 1e-12)
                  for k in metrics)
    grad_err, worst = max(
        (float((gg[n] - gc[n]).norm() / gc[n].norm().clamp_min(1e-12)), n) for n in gc)
    head = "dueling" if cfg.dueling else "plain"
    print(f"[phase6] fresh {cfg.torso} {head} QNetwork, CUDA vs CPU, one batch of "
          f"{cfg.batch_size} replay rows: Q max abs err {q_err:.3e}, TD loss metrics "
          f"max rel err {aux_err:.3e}, gradients max rel L2 err {grad_err:.3e} "
          f"({worst}) (limits 2e-2, 1e-2, 2e-2)")
    if q_err > 2e-2 or grad_err > 2e-2:
        raise AssertionError("QNetwork Q-values or gradients: CUDA != CPU")
    for k in metrics:
        if abs(float(ag[k]) - float(ac[k])) > 1e-6 + 1e-2 * abs(float(ac[k])):
            raise AssertionError(f"TD {k}: CUDA {float(ag[k])} != CPU {float(ac[k])}")


def dqn_path(card: str, argv, kernels, ckpt_dir: str) -> dict:
    """``cli/train.py --algo dqn`` with ``argv`` (checkpoints to
    ``ckpt_dir``); ``kernels`` are the engine's mask and apply kernels,
    launched collect_steps + 1 and collect_steps times an iteration."""
    import math

    import torch

    from blockpuzzle_tpu_torch.cli import train

    args = train.build_parser().parse_args(argv + ["--checkpoint-dir", ckpt_dir])
    learner = train.build(args)
    env, cfg = learner.env, learner.cfg
    zero_counts(env)
    r = train.train(args, learner)
    launches = read_counts(env)
    k = cfg.collect_steps
    mask_kernel, apply_kernel = kernels
    packed = mask_kernel.startswith("packed")
    expect = expected(**{mask_kernel: args.updates * (k + 1),
                         apply_kernel: args.updates * k}, deal=args.updates * k + 1,
                      **(tail_counts(args.updates * k, args.updates + 1) if packed else {}))
    if launches != expect:
        raise AssertionError(f"DQN path launches {launches} != {expect}")
    state, m = r["state"], r["metrics"]
    # the rows iteration i writes: n-step drops the emissions rooted in
    # the n - 1 pending rows not collected yet
    written = [cfg.num_envs * max(0, k - max(0, cfg.n_step - 1 - i * k))
               for i in range(args.updates)]
    filled = [min(sum(written[: i + 1]), cfg.buffer_size) for i in range(args.updates)]
    grads = sum(f >= cfg.min_buffer for f in filled) * cfg.grad_steps
    if (state.iter_count, state.grad_count, state.replay.filled) != (
            args.updates, grads, filled[-1]):
        raise AssertionError(f"DQN counts {state.iter_count}, {state.grad_count}, "
                             f"{state.replay.filled} != {args.updates}, {grads}, "
                             f"{filled[-1]}")
    for key in ("loss", "q_mean", "td_abs", "episode_return"):
        if not math.isfinite(m[key]):
            raise AssertionError(f"DQN metric {key} = {m[key]}")
    if m["loss"] <= 0.0:
        raise AssertionError(f"DQN took no TD step: {m}")
    valid = state.replay.filled
    rows = learner.sample_rows(state.replay, torch.arange(valid, device=env.device))
    picked = rows["action_mask"].gather(1, rows["action"].long()[:, None])
    if not bool(picked.all()):
        raise AssertionError("the replay holds an illegal action")
    sps = r["env_steps_per_s"]
    it_ms = 1e3 * cfg.num_envs * k / sps
    variant = " ".join(f for f, on in (("dueling", cfg.dueling),
                                       (f"{cfg.n_step}-step", cfg.n_step > 1),
                                       ("per", cfg.per)) if on) or "plain 1-step"
    print(f"[phase6] DQN {cfg.torso} torso ({variant}), {env.state_impl} engine, "
          f"N={cfg.num_envs}, buffer {cfg.buffer_size}, batch {cfg.batch_size}: "
          f"{args.updates} iterations, {state.grad_count} TD steps, buffer "
          f"{state.replay.filled}, last loss {m['loss']:.6f}, q_mean "
          f"{m['q_mean']:.6f}, epsilon {m['epsilon']:.4f}; launches {launches}, per "
          f"iteration " + ", ".join(f"{n} {c / args.updates:g}"
                                    for n, c in launches.items() if c))
    print(f"[phase6] {sps:.1f} env-steps/s of DQN training over iterations 2-"
          f"{args.updates}, {it_ms:.3f} ms per iteration ({card})")
    qnetwork_cuda_vs_cpu(learner, state)
    return launches


def dqn_checkpoint_round_trip(ckpt_dir: str) -> None:
    """The DQN state of the JAX CLI's defaults after 3 iterations, saved
    and restored on the card into a fresh template (another seed): every
    tensor, host counter and the generator state bit-equal; then one more
    iteration from the restored state."""
    import math

    import torch

    from blockpuzzle_tpu_torch.cli import train
    from blockpuzzle_tpu_torch.learn import default_dqn_hypers
    from blockpuzzle_tpu_torch.utils import CheckpointManager
    from blockpuzzle_tpu_torch.utils.checkpoint import flatten_state
    from blockpuzzle_tpu_torch.utils.metrics import host_metrics

    learner = train.build(train.build_parser().parse_args(TRAIN_DQN_ARGV))
    state = learner.init(0)
    for it in range(3):
        state, _ = learner.iteration(state, default_dqn_hypers(learner.cfg, it))
    mgr = CheckpointManager(ckpt_dir)
    mgr.save(3, state)
    restored = mgr.restore(learner.init(1))
    saved, back = flatten_state(state), flatten_state(restored)
    if set(saved) != set(back):
        raise AssertionError("restored state has other leaves")
    tensors = 0
    for key, a in saved.items():
        b = back[key]
        if isinstance(a, torch.Tensor):
            same = a.device == b.device and torch.equal(a, b)
            tensors += 1
        elif isinstance(a, dict):       # the optimizer
            same = a["param_groups"] == b["param_groups"] and all(
                torch.equal(v, b["state"][i][n])
                for i, s in a["state"].items() for n, v in s.items())
        else:
            same = a == b
        if not same:
            raise AssertionError(f"checkpoint round trip changed {key}")
    state, m = learner.iteration(restored, default_dqn_hypers(learner.cfg, 3))
    m = host_metrics(m)
    if state.iter_count != 4 or not all(math.isfinite(v) for v in m.values()):
        raise AssertionError(f"the iteration after the restore: {m}")
    print(f"[phase6] DQN checkpoint after iteration 3 ({len(saved)} leaves, "
          f"{tensors} tensors, replay {state.replay.filled} rows) restored on the card "
          f"bit-equal, generator state and counters included; iteration 4 from it: "
          f"loss {m['loss']:.6f}, {state.grad_count} TD steps")


def phase6(card: str) -> dict:
    """DQN: the two training paths (``train_dqn``: the JAX CLI's defaults,
    conv torso on the packed engine; ``train_dqn_u8``: mlp dueling 3-step
    PER on the u8 clear-kernel step), each held against a CPU copy; a
    checkpoint round trip on the card; ``cli/evaluate.py`` on the first
    path's checkpoint.  Returns the two paths' launch counts."""
    import contextlib
    import io
    import tempfile

    from blockpuzzle_tpu_torch.cli import evaluate

    with tempfile.TemporaryDirectory() as tmp:
        paths = {
            "train_dqn": dqn_path(card, TRAIN_DQN_ARGV, ("packed_mask", "packed_apply"),
                                  f"{tmp}/dqn"),
            "train_dqn_u8": dqn_path(card, TRAIN_DQN_U8_ARGV, ("mask", "clear"),
                                     f"{tmp}/dqn_u8"),
        }
        dqn_checkpoint_round_trip(f"{tmp}/round_trip")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = evaluate.main(["--checkpoint-dir", f"{tmp}/dqn", "--steps", "64"])
    lines = out.getvalue().strip().splitlines()
    for line in lines:
        print(f"[phase6] evaluate: {line}")
    if rc != 0 or not any(l.startswith("[sampled] 262144 env-steps") for l in lines):
        raise AssertionError(f"cli/evaluate.py printed {lines}")
    return paths


def words_rollout(cfg, dev: str, n: int, steps: int):
    """The words rollout from one seed on ``dev``: each step's actions from
    ``WordsSampler`` on the state's legal words, then the packed step.
    Returns the final state, the summed reward, every step's actions (on
    the CPU), whether every action was legal in its step's bool mask, and
    the engine."""
    import torch

    from blockpuzzle_tpu_torch import make_env
    from blockpuzzle_tpu_torch.sampler import WordsSampler

    env = make_env(cfg, device=dev)
    zero_counts(env)
    state, ts = env.init(7, n)
    sampler = WordsSampler(8, n, env.device)
    total = torch.zeros((), dtype=torch.float64, device=env.device)
    legal = torch.ones((), dtype=torch.bool, device=env.device)
    actions = []
    for _ in range(steps):
        a = sampler(env, state.board, state.queue)
        legal = legal & ts.action_mask.gather(1, a[:, None]).all()
        actions.append(a.cpu())
        state, ts = env.step(state, a)
        total = total + ts.reward.sum(dtype=torch.float64)
    return state.to("cpu"), float(total), torch.stack(actions), bool(legal), env


def autoreset_run(cfg, dev: str, mode: str, n: int, steps: int):
    """The autoreset env (``env/autoreset.py``) in ``mode`` from one seed
    on ``dev``, actions from ``WordsSampler``; under ``"disabled"`` a
    ``reset_mask`` of the dead envs every 8 steps.  Returns every step's
    presented fields and carried state on the host, and the episodes
    ended."""
    from blockpuzzle_tpu_torch import make_env
    from blockpuzzle_tpu_torch.env.autoreset import AutoresetEnv, to_host
    from blockpuzzle_tpu_torch.sampler import WordsSampler

    env = make_env(cfg, device=dev)
    auto = AutoresetEnv(env, n, mode)
    sampler = WordsSampler(9, n, env.device)
    trace = [to_host(auto.reset(seed=11))]
    ended = 0
    for t in range(steps):
        out = to_host(auto.step(sampler(env, auto.state.board, auto.state.queue)))
        done = out["terminated"] | out["truncated"]
        if mode != "disabled":
            ended += int(done.sum())
        elif t % 8 == 7:  # a dead env shows its done flags until reset
            ended += int(done.sum())
            trace.append(to_host(auto.reset(options={"reset_mask": done})))
        trace.append(out)
        trace.append(to_host(auto.carried()))
    return trace, ended


def autoreset_rate(cfg, mode: str, chunk: int = 100, windows: int = 3) -> float:
    """The autoreset env's env-steps/s in ``mode`` at N = 49152: one warm-up chunk,
    then the median of ``windows`` chunks, each step's presented fields
    copied to the host inside the window (the Gymnasium boundary); under
    ``"disabled"`` a ``reset_mask`` of the dead envs every 8 steps."""
    import torch

    from blockpuzzle_tpu_torch import make_env
    from blockpuzzle_tpu_torch.env.autoreset import AutoresetEnv, to_host
    from blockpuzzle_tpu_torch.sampler import WordsSampler

    env = make_env(cfg, device="cuda")
    auto = AutoresetEnv(env, N_MAIN, mode)
    sampler = WordsSampler(9, N_MAIN, env.device)
    to_host(auto.reset(seed=11))
    rates = []
    for w in range(windows + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(chunk):
            out = to_host(auto.step(sampler(env, auto.state.board,
                                              auto.state.queue)))
            if mode == "disabled" and t % 8 == 7:
                to_host(auto.reset(
                    options={"reset_mask": out["terminated"] | out["truncated"]}))
        torch.cuda.synchronize()
        if w:
            rates.append(chunk * N_MAIN / (time.perf_counter() - t0))
    return statistics.median(rates)


def phase7(card: str, argmax_rate: float) -> dict:
    """Serving: the words rollout on CUDA against the CPU on every preset,
    timed at N = 49152 beside the argmax rollout's rate; the autoreset
    env in each mode on CUDA against the CPU, then timed.  Returns the
    launch counts of the timed words rollout (the path ``rollout_words``)."""
    import numpy as np
    import torch

    from blockpuzzle_tpu_torch import PRESETS, make_env
    from blockpuzzle_tpu_torch.cli.rollout import rollout
    from blockpuzzle_tpu_torch.env.autoreset import MODES

    n, steps = 1024, 64
    fields = ("board", "queue", "rng_counter", "steps", "score", "streak")
    for name in PACKED_PRESETS:
        cfg = PRESETS[name]()
        per_step = packed_kernel_names(cfg)  # the words: the tall kernel on woodoku, big
        (sg, rg, ag, lg, env), (sc, rc, ac, lc, _) = (
            words_rollout(cfg, dev, n, steps) for dev in ("cuda", "cpu"))
        counts = read_counts(env)
        expect = expected(**dict.fromkeys(per_step, steps), deal=steps + 1,
                          words_select=steps, **tail_counts(steps, 1))
        if counts != expect:
            raise AssertionError(f"{name} words rollout launches {counts} != {expect}")
        if not (lg and lc):
            raise AssertionError(f"{name}: the words sampler drew an illegal action")
        if not torch.equal(ag, ac):
            raise AssertionError(f"{name}: words rollout actions differ CUDA vs CPU")
        if rg != rc or not all(torch.equal(getattr(sg, f), getattr(sc, f))
                               for f in fields):
            raise AssertionError(f"{name}: words rollout final states differ")
        print(f"[phase7] {name} words rollout N={n} {steps} steps: actions, final "
              f"states and summed reward ({rg}) CUDA == CPU, every action legal, "
              f"launches per step " + " ".join(f"{k}=1" for k in per_step)
              + " deal=1 words_select=1 (deal once more at init)")

    env = make_env(PRESETS["default"](), device="cuda")
    per_step = packed_kernel_names(env.cfg)
    zero_counts(env)
    chunk, windows = 400, 5
    r = rollout(env, N_MAIN, chunk, windows, seed=0, sampler="words")
    counts = read_counts(env)
    steps = (windows + 1) * chunk
    expect = expected(**dict.fromkeys(per_step, steps), deal=steps + 1,
                      words_select=steps, **tail_counts(steps, 1))
    if counts != expect:
        raise AssertionError(f"rollout_words launches {counts} != {expect}")
    mean_return = r["episode_return"] / max(r["episodes"], 1)
    if r["episodes"] == 0 or not 60.0 < mean_return < 100.0:
        raise AssertionError(f"implausible words episodes: {r['episodes']}, {mean_return}")
    rate = statistics.median(r["rates"])
    print(f"[phase7] rollout_words default N={N_MAIN}: windows of {chunk} steps "
          f"(env-steps/s) {[round(x) for x in r['rates']]}")
    print(f"[phase7] rollout_words median {rate:.1f} env-steps/s against the argmax "
          f"rollout's {argmax_rate:.1f} (phase 3) ({card}); episodes {r['episodes']}, "
          f"mean return {mean_return:.3f}; launches {counts}")

    n, steps = 4096, 128
    cfg = PRESETS["default"]()
    for mode in MODES:
        (tg, eg), (tc, ec) = (autoreset_run(cfg, dev, mode, n, steps)
                              for dev in ("cuda", "cpu"))
        for i, (a, b) in enumerate(zip(tg, tc)):
            if a.keys() != b.keys() or not all(np.array_equal(a[k], b[k]) for k in a):
                raise AssertionError(f"autoreset {mode}: CUDA != CPU at record {i}")
        if eg == 0:
            raise AssertionError(f"autoreset {mode}: no episode ended in {steps} steps")
        print(f"[phase7] autoreset env {mode} N={n} {steps} steps: every presented "
              f"field and the carried state CUDA == CPU ({len(tg)} records), "
              f"{eg} episodes ended")
    for mode in MODES:
        print(f"[phase7] autoreset env {mode} N={N_MAIN}, presented fields "
              f"copied to the host: {autoreset_rate(cfg, mode):.1f} env-steps/s ({card})")
    return {"rollout_words": counts}


# the distributed runs of phase 8: PPO with the JAX CLI's defaults (2
# updates), DQN with them (3 iterations), the mlp torso on the u8 step at
# --tp 2 (2 updates); a checkpoint after each update
DIST_PPO_ARGV = TRAIN_ARGV + ["--updates", "2", "--checkpoint-every", "1"]
DIST_DQN_ARGV = TRAIN_DQN_ARGV + ["--updates", "3", "--checkpoint-every", "1"]
DIST_TP_ARGV = TRAIN_U8_ARGV + ["--updates", "2", "--checkpoint-every", "1"]


def free_ports(k: int) -> list:
    import socket

    socks = [socket.socket() for _ in range(k)]
    for sock in socks:
        sock.bind(("localhost", 0))
    ports = [sock.getsockname()[1] for sock in socks]
    for sock in socks:
        sock.close()
    return ports


def torchrun_env(rank: int, world: int, port: int) -> None:
    """The variables torchrun gives each of ``world`` ranks on one host."""
    import os

    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world))


def collective_rows(rank: int, n: int, device) -> dict:
    """Rank ``rank``'s rows for the row gather: one field of each dtype the
    DQN transitions carry."""
    import torch

    return {"board": torch.full((n, 100), rank, dtype=torch.uint8, device=device),
            "mask": torch.full((n, 3), bool(rank), device=device),
            "action": torch.full((n,), 7 + rank, dtype=torch.int32, device=device),
            "reward": torch.full((n, 2), 0.5 + rank, device=device),
            "key": torch.full((n, 5), 2 ** 40 + rank, dtype=torch.int64, device=device)}


def collectives_rank(rank: int, world: int, port: int, device: str, out: str) -> None:
    """One rank of the collectives check: ``dist``'s all-reduce, all-gather
    and row gather (mixed dtypes, along axes 0 and 1) on ``device``, each
    held to its expected value, then timed."""
    import torch
    import torch.distributed as tdist

    from blockpuzzle_tpu_torch import dist
    from blockpuzzle_tpu_torch.dist.mesh import all_gather_cat, all_reduce_, gather_rows

    torchrun_env(rank, world, port)
    dist.init_distributed(device)
    try:
        mesh = dist.make_mesh(1, device)
        g, dev, n = mesh.dp_group, mesh.device, 4096
        base = torch.arange(1 << 20, dtype=torch.float32, device=dev)
        x = base + rank
        rows = collective_rows(rank, n, dev)
        both = [collective_rows(r, n, dev) for r in range(world)]
        want_rows = {k: torch.cat([b[k] for b in both]) for k in rows}
        checks = {
            "all_reduce": (lambda: all_reduce_(x.clone(), g), 2 * base + 1),
            "all_gather": (lambda: all_gather_cat(x, g), torch.cat([base, base + 1])),
            "gather_rows": (lambda: gather_rows(rows, g), want_rows),
            "gather_rows_axis1": (
                lambda: gather_rows({k: v[None] for k, v in rows.items()}, g, 1),
                {k: v[None] for k, v in want_rows.items()}),
        }
        times = {}
        for name, (fn, want) in checks.items():
            got = fn()
            same = (torch.equal(got, want) if isinstance(want, torch.Tensor) else
                    all(torch.equal(got[k], v) for k, v in want.items()))
            if not same:
                raise AssertionError(f"{tdist.get_backend()} {name} on {dev}: wrong result")
            torch.cuda.synchronize() if dev.type == "cuda" else None
            t0 = time.perf_counter()
            for _ in range(5):
                fn()
            torch.cuda.synchronize() if dev.type == "cuda" else None
            times[name] = 1e3 * (time.perf_counter() - t0) / 5
        with open(out.format(rank), "w") as f:
            json.dump({"backend": tdist.get_backend(), "device": str(dev),
                       "ms": times}, f)
    finally:
        tdist.destroy_process_group()


def train_rank(rank: int, world: int, port: int, argv, out: str) -> None:
    """One rank of ``cli/train.py --distributed``, as torchrun starts it:
    the launch counters set to 0 before the run and read after it."""
    import torch.distributed as tdist

    from blockpuzzle_tpu_torch.cli import train

    torchrun_env(rank, world, port)
    args = train.build_parser().parse_args(argv)
    learner = train.build(args)
    try:
        zero_counts(learner.env)
        r = train.train(args, learner)
        with open(out.format(rank), "w") as f:
            json.dump({"backend": tdist.get_backend(), "device": str(learner.env.device),
                       "launches": read_counts(learner.env),
                       "local_envs": int(r["state"].env_state.board.shape[0]),
                       "env_steps_per_s": r["env_steps_per_s"]}, f)
    finally:
        tdist.destroy_process_group()


def spawn(fn, world: int, *args) -> list:
    """``fn(rank, world, port, *args, out)`` in ``world`` fresh processes
    (torch's ``spawn``: a child imports this file, not ``__main__``'s
    body); each rank's JSON record."""
    import os
    import tempfile

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "rank{}.json")
        mp.start_processes(fn, args=(world, free_ports(1)[0], *args, out),
                           nprocs=world, join=True, start_method="spawn")
        records = []
        for r in range(world):
            with open(out.format(r)) as f:
                records.append(json.load(f))
    return records


def run_files(d: str, algo: str, step: int):
    """The JSONL metrics logged at ``step`` and the checkpoint of ``step``."""
    import os

    import torch

    with open(os.path.join(d, f"{algo}-default.jsonl")) as f:
        log = {rec["step"]: rec for rec in map(json.loads, f)}
    return log[step], torch.load(os.path.join(d, str(step), "state.pt"),
                                 map_location="cpu", weights_only=True)


def hold_to_unsharded(what: str, got_dir: str, ref_dir: str, algo: str, step: int,
                      metric_keys) -> str:
    """The metrics and every network parameter at ``step`` of a
    distributed run against the unsharded run, with the tolerances of
    ``tests/test_dist.py`` (metrics rtol 1e-3 / atol 1e-5, parameters rtol
    1e-4 / atol 1e-5); raises beyond them.  Returns the errors' line."""
    (gm, gs), (rm, rs) = (run_files(d, algo, step) for d in (got_dir, ref_dir))
    m_used = max(abs(gm[k] - rm[k]) / (1e-5 + 1e-3 * abs(rm[k])) for k in metric_keys)
    nets = [k for k in rs if k.startswith("net/")]
    if sorted(nets) != sorted(k for k in gs if k.startswith("net/")):
        raise AssertionError(f"{what}: other network parameters")
    p_abs, p_used = 0.0, 0.0
    for k in nets:
        diff = (gs[k] - rs[k]).abs()
        p_abs = max(p_abs, float(diff.max()))
        p_used = max(p_used, float((diff / (1e-5 + 1e-4 * rs[k].abs())).max()))
    line = (f"metrics at step {step} within {100 * m_used:.2f}% of their bound, "
            f"parameters max abs err {p_abs:.3e} ({100 * p_used:.2f}% of the bound)")
    if m_used > 1.0 or p_used > 1.0:
        raise AssertionError(f"{what} != the unsharded run: {line}")
    return line


def dist_path(card: str, name: str, argv, runs, kernels, per_update, tmp: str) -> dict:
    """``cli/train.py`` with ``argv`` once unsharded in this process, then as
    each distributed run of ``runs`` ((label, world, flags)); every rank's
    launches held to ``per_update`` launches of the mask and apply kernels
    an update, each run's metrics and parameters to the unsharded run's.
    Returns rank 0's launches of the first run."""
    import os

    from blockpuzzle_tpu_torch.cli import train

    algo = "dqn" if "dqn" in argv else "ppo"
    ref = os.path.join(tmp, f"{name}_ref")
    args = train.build_parser().parse_args(argv + ["--log-dir", ref,
                                                   "--checkpoint-dir", ref])
    r = train.train(args, train.build(args))
    print(f"[phase8] {name} unsharded (one process, {args.num_envs} envs): "
          f"{r['env_steps_per_s']:.1f} env-steps/s ({card})")
    mask_kernel, apply_kernel = kernels
    packed = mask_kernel.startswith("packed")
    expect = expected(**{mask_kernel: args.updates * per_update[0],
                         apply_kernel: args.updates * per_update[1]},
                      deal=args.updates * per_update[1] + 1,
                      **(tail_counts(args.updates * per_update[1], args.updates + 1)
                         if packed else {}))
    metric_keys = (("loss", "q_mean", "td_abs") if algo == "dqn" else
                   ("loss", "policy_loss", "value_loss", "entropy"))
    first = None
    for label, world, flags in runs:
        d = os.path.join(tmp, f"{name}_{label}")
        records = spawn(train_rank, world, argv + flags + ["--log-dir", d,
                                                           "--checkpoint-dir", d])
        for rank, rec in enumerate(records):
            if rec["launches"] != expect:
                raise AssertionError(f"{name} {label} rank {rank} launches "
                                     f"{rec['launches']} != {expect}")
        line = hold_to_unsharded(f"{name} {label}", d, ref, algo, 1, metric_keys)
        if algo == "dqn" and run_files(ref, algo, 1)[0]["loss"] <= 0.0:
            raise AssertionError("the DQN runs took no TD step in iteration 1")
        rec = records[0]
        print(f"[phase8] {name} {label}: world {world}, backend {rec['backend']} on "
              f"{rec['device']}, {rec['local_envs']} envs a rank; every rank launched "
              f"{mask_kernel} {per_update[0]} and {apply_kernel} and deal {per_update[1]} "
              f"times an update (deal once more at init); {line}")
        print(f"[phase8] {name} {label}: {rec['env_steps_per_s']:.1f} global "
              f"env-steps/s ({card}); a correctness run, not a scaling figure"
              + (": two processes share one card over a host-staged gloo transport"
                 if world > 1 else ""))
        first = first or rec["launches"]
    return first, ref


def phase8(card: str) -> dict:
    """The distributed runtime: gloo collectives of CUDA tensors between
    two ranks on the one card; ``cli/train.py --distributed`` for PPO and
    DQN with the JAX CLI's defaults at world 2 (gloo, two ranks on the
    card) and world 1 (nccl), and the mlp torso on the u8 step at ``--tp
    2``, each held to the unsharded run; the first DQN iteration's replay
    bit-equal to the unsharded one's; the world-2 DQN checkpoint restored
    in one process bit-equal.  Returns the launch counts of the paths
    ``train_dist_ppo``, ``train_dist_dqn`` and ``train_dist_tp2`` (rank 0
    of the world-2 runs)."""
    import os
    import tempfile

    import torch

    from blockpuzzle_tpu_torch.cli import train
    from blockpuzzle_tpu_torch.utils import CheckpointManager
    from blockpuzzle_tpu_torch.utils.checkpoint import flatten_state

    records = spawn(collectives_rank, 2, "cuda")
    for rec in records:
        if rec["backend"] != "gloo" or rec["device"] != "cuda:0":
            raise AssertionError(f"two ranks on one card: {rec}")
    print(f"[phase8] gloo, two ranks sharing cuda:0: all_reduce, all_gather and "
          f"gather_rows (axes 0 and 1; uint8, bool, int32, float32, int64) of CUDA "
          f"tensors correct; ms a call on rank 0 "
          + ", ".join(f"{k} {v:.3f}" for k, v in records[0]["ms"].items()))
    dp_runs = [("world2", 2, ["--distributed"]), ("world1", 1, ["--distributed"])]
    paths = {}
    with tempfile.TemporaryDirectory() as tmp:
        paths["train_dist_ppo"], _ = dist_path(
            card, "ppo", DIST_PPO_ARGV, dp_runs, ("packed_mask", "packed_apply"),
            (65, 64), tmp)
        paths["train_dist_dqn"], ref = dist_path(
            card, "dqn", DIST_DQN_ARGV, dp_runs, ("packed_mask", "packed_apply"),
            (5, 4), tmp)
        paths["train_dist_tp2"], _ = dist_path(
            card, "tp2", DIST_TP_ARGV, [("world2", 2, ["--distributed", "--tp", "2"])],
            ("mask", "clear"), (65, 64), tmp)
        # the first iteration's replay, bit for bit, and the world-2
        # checkpoint in one process
        _, want = run_files(ref, "dqn", 1)
        for label in ("world2", "world1"):
            _, got = run_files(os.path.join(tmp, f"dqn_{label}"), "dqn", 1)
            bad = [k for k in want if k.startswith("replay/") and not (
                torch.equal(got[k], want[k]) if isinstance(want[k], torch.Tensor)
                else got[k] == want[k])]
            if bad:
                raise AssertionError(f"dqn {label}: iteration-1 replay differs in {bad}")
        _, saved = run_files(os.path.join(tmp, "dqn_world2"), "dqn", 3)
        learner = train.build(train.build_parser().parse_args(DIST_DQN_ARGV))
        restored = flatten_state(CheckpointManager(os.path.join(tmp, "dqn_world2"))
                                 .restore(learner.init(1), 3))
        for k, v in saved.items():
            back = restored[k]
            same = (torch.equal(back.cpu(), v) if isinstance(v, torch.Tensor) else
                    back["param_groups"] == v["param_groups"] and all(
                        torch.equal(t.cpu(), back["state"][i][n].cpu())
                        for i, st in v["state"].items() for n, t in st.items())
                    if isinstance(v, dict) else back == v)
            if not same:
                raise AssertionError(f"world-2 DQN checkpoint restored in one process: {k}")
    print(f"[phase8] dqn: the iteration-1 replay ({want['replay/filled']} rows) of the "
          f"world-2 and world-1 runs bit-equal to the unsharded run's; the world-2 "
          f"checkpoint after iteration 3 ({len(saved)} leaves) restored in one process "
          f"bit-equal")
    return paths


# the bench paths of phase 9: (BP_BENCH_STATE_IMPL, _BACKEND, _SAMPLER, the
# kernels launched once a step)
BENCH_PATHS = {
    "bench": ("auto", "jnp", "argmax", ("packed_mask", "packed_apply")),
    "bench_pallas": ("u8", "pallas", "argmax", ("mask", "apply")),
    "bench_u8": ("u8", "jnp", "argmax", ("mask", "clear")),
    "bench_words": ("auto", "jnp", "words",
                    ("packed_mask", "packed_apply", "packed_legal_words")),
}
# one sweep config at the JAX defaults' widths (conv, packed, N = 4096, T = 64)
SWEEP_ARGV = ["--configs", "base", "--updates", "3", "--log-every", "1",
              "--num-envs", "4096", "--rollout-len", "64", "--eval-envs", "4096",
              "--eval-steps", "64", "--seed", "0", "--device", "cuda"]


def check_final_state(env, state, what: str) -> None:
    """0/1 boards of the engine's shape, queue ids in range, finite scores."""
    import torch

    cells = env.board_obs(state.board)
    if cells.shape[1:] != (env.cfg.height, env.cfg.width) or int(cells.max()) > 1:
        raise AssertionError(f"{what}: final boards malformed")
    if int(state.queue.min()) < 0 or int(state.queue.max()) > env.num_pieces:
        raise AssertionError(f"{what}: final queues out of range")
    if not bool(torch.isfinite(state.score).all()):
        raise AssertionError(f"{what}: non-finite scores")


def phase9(card: str, argmax_rate: float) -> dict:
    """The measuring entry points: ``bench.bench_device`` at N = 49152 on
    the default, ``pallas``, ``u8`` (clear kernel) and ``words``
    configurations (2 chunks of 400 steps a window, 3 windows, after the
    warm-up chunk), the three argmax engines' final states bit-equal; the
    actor (both torsos, both policies; chunks of 100, 3 windows of one);
    the learner (``base``, ``mlp``: 2 timed updates); one sweep config
    twice, its metrics streams compared by ``scripts/compare_metrics.py``
    in a subprocess; the quickstart's engine and train sections.  Returns
    the launch counts of the paths ``bench``, ``bench_pallas``,
    ``bench_u8``, ``bench_words``, ``actor_conv``, ``actor_mlp`` and
    ``sweep``, each held to one launch a step of each kernel of its step
    (the sweep's mask one more an update: ``PPO.observe``)."""
    import os
    import pathlib
    import tempfile

    import torch

    from blockpuzzle_tpu_torch import bench
    from blockpuzzle_tpu_torch.examples import quickstart
    from blockpuzzle_tpu_torch.learn import PPO, PPOConfig
    from blockpuzzle_tpu_torch.scripts import bench_actor, bench_learner, sweep_ppo

    fields = ("queue", "rng_counter", "steps", "score", "streak")
    paths, finals = {}, {}
    chunk, iters, windows = 400, 2, 3
    steps = (1 + iters * windows) * chunk
    for path, (state_impl, backend, sampler, per_step) in BENCH_PATHS.items():
        env = bench.make_bench_env("default", state_impl, backend, "cuda")
        zero_counts(env)
        r = bench.bench_device(env, N_MAIN, sampler, chunk, iters, windows)
        paths[path] = read_counts(env)
        draw = "uniform_legal" if sampler == "argmax" else "words_select"
        expect = expected(**dict.fromkeys(per_step, steps), deal=steps + 1,
                          **{draw: steps},
                          **(tail_counts(steps, 1) if state_impl == "auto" else {}))
        if paths[path] != expect:
            raise AssertionError(f"{path} launches {paths[path]} != {expect}")
        check_final_state(env, r["state"], path)
        if sampler == "argmax":
            finals[path] = (env.board_obs(r["state"].board), r["state"])
        print(f"[phase9] {path} ({env.state_impl}, backend {env.backend}, sampler "
              f"{sampler}) N={N_MAIN}: windows of {iters}x{chunk} steps (env-steps/s) "
              f"{[round(x) for x in r['rates']]}, value {r['value']:.1f} against "
              f"phase 3's rollout median {argmax_rate:.1f} ({card}); launches "
              f"{paths[path]}")
    (board0, s0), *_ = finals.values()
    for path, (board, s) in list(finals.items())[1:]:
        if not torch.equal(board, board0) or not all(
                torch.equal(getattr(s, f), getattr(s0, f)) for f in fields):
            raise AssertionError(f"{path} final state != bench's")
    print(f"[phase9] {', '.join(finals)}: final states bit-equal after {steps} steps "
          "from one seed")

    env = bench.make_bench_env(device="cuda")
    chunk, iters, windows = 100, 1, 3
    for torso in ("conv", "mlp"):
        ppo = PPO(env, PPOConfig(num_envs=N_MAIN, rollout_len=8, torso=torso))
        net = ppo.init(0).net
        zero_counts(env)
        rates = {policy: bench_actor.bench_one(ppo, net, policy, chunk, iters, windows)
                 for policy in bench_actor.POLICIES}
        path = f"actor_{torso}"
        paths[path] = read_counts(env)
        taken = len(rates) * (1 + iters * windows) * chunk
        # the deal once a step and once an ``init``, one a policy; the unpack
        # at each ``init``
        expect = expected(packed_mask=taken, packed_apply=taken, deal=taken + len(rates),
                          **tail_counts(taken, len(rates)))
        if paths[path] != expect:
            raise AssertionError(f"{path} launches {paths[path]} != {expect}")
        for policy, rate in rates.items():
            if not rate > 0:
                raise AssertionError(f"{path} {policy}: rate {rate}")
            print(f"[phase9] {path} {policy} N={N_MAIN}: {rate:.1f} actor steps/s "
                  f"({card})")
        print(f"[phase9] {path}: launches {paths[path]}")

    for variant in bench_learner.VARIANTS:
        rec = bench_learner.bench_variant(variant, 4096, 64, 2, 1, "cuda")
        print(f"[phase9] learner {json.dumps(rec)} ({card})")

    with tempfile.TemporaryDirectory() as tmp:
        streams = []
        for run in range(2):
            streams.append(os.path.join(tmp, f"sweep{run}.jsonl"))
            args = sweep_ppo.parse_args(SWEEP_ARGV + ["--metrics-jsonl", streams[-1]])
            ppo = sweep_ppo.build(args)
            zero_counts(ppo.env)
            t0 = time.perf_counter()
            sweep_ppo.sweep(args, ppo)
            seconds = time.perf_counter() - t0
            counts = read_counts(ppo.env)
            rollout = args.updates * args.rollout_len
            per = sweep_ppo.EVAL_CHUNK
            evaluated = max(1, args.eval_steps // per) * per
            # the deal once a step, at ``PPO.init`` and at the evaluation's;
            # the unpack at both and at each update's ``observe``
            expect = expected(packed_apply=rollout + evaluated,
                              packed_mask=rollout + args.updates + evaluated,
                              deal=rollout + evaluated + 2,
                              **tail_counts(rollout + evaluated, args.updates + 2))
            if counts != expect:
                raise AssertionError(f"sweep launches {counts} != {expect}")
            paths["sweep"] = counts
            print(f"[phase9] sweep run {run}: {args.updates} updates and a greedy "
                  f"evaluation in {seconds:.3f} s ({card}); launches {counts}")
        compare = pathlib.Path(__file__).resolve().parent / "scripts"
        compare = compare / "compare_metrics.py"
        out = subprocess.run([sys.executable, str(compare)] + streams,
                             capture_output=True, text=True, timeout=120)
        print(f"[phase9] scripts/compare_metrics.py: {out.stdout.strip()}")
        if out.returncode != 0:
            raise AssertionError("two same-seed sweep streams differ on the card")

    quickstart.engine("cuda")
    quickstart.train("cuda")
    print("[phase9] quickstart engine and train sections ran on the card")
    return paths


# the engines of phase 10's property sweep: path -> (make_env arguments,
# the kernels of its mask and its step)
PROPERTY_ENGINES = {
    "properties_packed": (dict(state_impl="packed"), ("packed_mask", "packed_apply")),
    "properties_u8_jnp": (dict(backend="jnp", state_impl="u8"), ("mask", "clear")),
    "properties_u8_pallas": (dict(backend="pallas", state_impl="u8"), ("mask", "apply")),
}
PROPERTY_PAIRS = 4096
ROOFLINE_COUNT_KEYS = ("bytes_per_step_env", "flops_per_step_env",
                       "kernel_bytes_per_step_env", "state_bytes_per_step_env",
                       "kernel_launches_per_step")


def first_bad(ok, what: str) -> None:
    """Raise on the first False of the (M,) bool array ``ok``, printing its
    index."""
    import numpy as np

    bad = np.flatnonzero(~np.asarray(ok))
    if bad.size:
        print(f"[phase10] {what}: first mismatch at index {bad[0]} "
              f"({bad.size} of {len(ok)})")
        raise AssertionError(f"{what} fails at index {bad[0]}")


def property_sweep() -> dict:
    """The properties of ``tests/test_properties.py`` at batch on the card:
    ``PROPERTY_PAIRS`` seeded (board, piece, cell) triples, each engine of
    ``PROPERTY_ENGINES`` on CUDA in one call each: the hand mask against
    the oracle's on the raw boards; on the boards with their full lines
    emptied, one step (no auto-reset) leaves no full line, and the reward
    is the illegal penalty iff the oracle's ``can_place`` refuses the cell,
    else at least the piece's cells.  Returns each engine's launch
    counts (mask, step: 2 and 1)."""
    import numpy as np
    import torch

    from blockpuzzle_tpu_torch import make_env, rules
    from blockpuzzle_tpu_torch.config import default_config
    from blockpuzzle_tpu_torch.oracle import BlockPuzzleOracleEnv

    cfg = default_config()
    m, hw, w = PROPERTY_PAIRS, cfg.num_cells, cfg.width
    gen = np.random.default_rng(10)
    boards = gen.integers(0, 2, (m, cfg.height, w)).astype(np.uint8)
    pids = gen.integers(0, rules.tables_for(cfg).num_pieces, m)
    cells = gen.integers(0, hw, m)
    # full rows emptied, then the columns full after that, as the JAX test does
    reach = boards.copy()
    reach[reach.all(axis=2)] = 0
    reach.transpose(0, 2, 1)[reach.all(axis=1)] = 0
    oracle = BlockPuzzleOracleEnv(cfg)
    oracle.reset(seed=0)
    want_mask, want_legal = np.zeros((m, hw), bool), np.zeros(m, bool)
    for i in range(m):
        oracle.board[:] = boards[i]
        oracle.queue[:] = [pids[i]]
        want_mask[i] = oracle.legal_action_mask()
        oracle.board[:] = reach[i]
        want_legal[i] = oracle.can_place(int(pids[i]), *divmod(int(cells[i]), w))
    min_reward = rules.tables_for(cfg).piece_cells[pids]
    paths = {}
    for path, (kwargs, (mask_k, step_k)) in PROPERTY_ENGINES.items():
        env = make_env(cfg, device="cuda", **kwargs)
        zero_counts(env)
        queue = torch.as_tensor(pids[:, None], dtype=torch.int32, device=env.device)
        mask = env.action_mask(env.encode_board(boards), queue).cpu().numpy()
        first_bad((mask == want_mask).all(axis=1), f"{path}: mask != the oracle's")
        state, _ = env.init(0, m, deal_override=pids[:, None])
        state = state.replace(board=env.encode_board(reach))
        state, ts = env.step(state, torch.as_tensor(cells, device=env.device),
                             auto_reset=False)
        out = env.board_obs(state.board).cpu().numpy()
        first_bad(~(out.all(axis=2).any(axis=1) | out.all(axis=1).any(axis=1)),
                  f"{path}: a full line left after the step")
        legal = ts.info["legal"].cpu().numpy()
        reward = ts.reward.cpu().numpy()
        first_bad(legal == want_legal, f"{path}: legal != the oracle's can_place")
        first_bad(np.where(legal, reward >= min_reward, reward == cfg.illegal_penalty),
                  f"{path}: reward not zero iff illegal")
        paths[path] = read_counts(env)
        # the step draws one deal (``init`` is given the hand); on packed
        # boards the tail once and the unpack at ``init`` and for ``out``
        packed = mask_k.startswith("packed")
        expect = expected(**{mask_k: 2, step_k: 1}, deal=1,
                          **(tail_counts(1, 2) if packed else {}))
        if paths[path] != expect:
            raise AssertionError(f"{path} launches {paths[path]} != {expect}")
        print(f"[phase10] {path}: {m} seeded (board, piece, cell) triples on CUDA: "
              f"mask == the oracle's ({float(want_mask.mean()):.4f} legal), no full "
              f"line after the step, legal == can_place ({int(legal.sum())} legal), "
              f"reward zero iff illegal; launches {mask_k} 2, {step_k} 1, deal 1")
    return paths


def phase10(card: str) -> dict:
    """The last ported pieces on the card: the roofline of the bench's step
    at N = 49152 (its count pass's launches held to one B1 and one B7 a
    step, its count on CUDA equal to the CPU's at N = 1024); the scaling
    harness (one rank on the card, two ranks sharing it over gloo with
    their final states bit-equal to one process's, ``--cpu-sim``'s 8 CPU
    ranks at a small size); the properties at batch on the three engines.
    Returns the launch counts of the paths ``roofline`` and
    ``properties_*``."""
    import math

    import torch

    from blockpuzzle_tpu_torch import bench
    from blockpuzzle_tpu_torch.scripts import bench_scaling, roofline

    t0 = time.perf_counter()
    chunk, iters, windows = 400, 2, 3
    env = bench.make_bench_env(device="cuda")
    zero_counts(env)
    rec = roofline.roofline(env, N_MAIN, chunk, True, iters, windows)
    paths = {"roofline": read_counts(env)}
    print(f"[phase10] roofline ({card}): {json.dumps(rec)}")
    # the count pass's chunk, then the bench's warm-up chunk and windows; a
    # deal at each of the two inits, one more draw for the count pass's
    # first action (the state floor's)
    steps = chunk + (1 + iters * windows) * chunk
    expect = expected(packed_mask=steps, packed_apply=steps, deal=steps + 2,
                      uniform_legal=steps + 1, **tail_counts(steps, 2))
    if paths["roofline"] != expect:
        raise AssertionError(f"roofline launches {paths['roofline']} != {expect}")
    if rec["kernel_launches_per_step"] != {"packed_apply": 1.0, "packed_mask": 1.0,
                                           "packed_tail": 1.0, "deal": 1.0,
                                           "uniform_legal": 1.0}:
        raise AssertionError(f"count pass launches {rec['kernel_launches_per_step']}")
    for k in ("pct_of_hbm_bound", "pct_of_core_bound", "pct_of_state_bound"):
        if not 0.0 < rec[k] <= 100.0:
            raise AssertionError(f"roofline {k} = {rec[k]}")
    counts = {dev: roofline.roofline(bench.make_bench_env(device=dev), 1024, 8, False)
              for dev in ("cuda", "cpu")}
    differ = [k for k in ROOFLINE_COUNT_KEYS if counts["cuda"][k] != counts["cpu"][k]]
    if differ:
        raise AssertionError(f"the roofline's count differs CUDA vs CPU in {differ}: "
                             f"{[(counts['cuda'][k], counts['cpu'][k]) for k in differ]}")
    print(f"[phase10] roofline count at N=1024, 8 steps: CUDA == CPU ("
          + ", ".join(f"{k} {counts['cpu'][k]}" for k in ROOFLINE_COUNT_KEYS)
          + f"); the roofline part took {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    n, sc_chunk, sc_iters = 4096, 50, 3
    r = bench_scaling.run([1, 2], "cuda", n, sc_chunk, sc_iters, gather=True)
    for line in bench_scaling.report(r):
        print(f"[phase10] bench_scaling ({card}; size 2 is two ranks sharing the card: "
              f"correctness, not scaling): {line}")
    for d in (1, 2):
        want = bench_scaling.unsharded_state("cuda", d * n, sc_chunk, sc_iters)
        got = r["states"][d]
        bad = [f for f in vars(want) if not torch.equal(getattr(got, f), getattr(want, f))]
        if bad:
            raise AssertionError(f"bench_scaling world {d}: final states differ in {bad}")
    backends = [x["backend"] for x in r["ranks"][1] + r["ranks"][2]]
    if backends != ["nccl", "gloo", "gloo"]:
        raise AssertionError(f"bench_scaling backends {backends}")
    print(f"[phase10] bench_scaling: world 1 (nccl) and world 2 (gloo, two ranks on "
          f"the card) final states of {n} envs a rank bit-equal to one process's, "
          f"after {(1 + sc_iters) * sc_chunk} steps")
    # --cpu-sim's 8 ranks only: its smaller sizes would add a spawn each
    sim = bench_scaling.run([bench_scaling.CPU_SIM_RANKS], "cpu", 256, 8, 1)
    rate = sim["steps_per_s"][bench_scaling.CPU_SIM_RANKS]
    print(f"[phase10] bench_scaling --cpu-sim's {bench_scaling.CPU_SIM_RANKS} CPU ranks "
          f"over gloo (the harness, not the card): {rate:.1f} env-steps/s")
    if not (math.isfinite(rate) and rate > 0):
        raise AssertionError(f"--cpu-sim rate {rate}")
    print(f"[phase10] the scaling part took {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    paths.update(property_sweep())
    print(f"[phase10] the property part took {time.perf_counter() - t0:.1f} s")
    return paths


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; nothing was run")
    from blockpuzzle_tpu_torch.kernels import _build

    card = card_line()
    cap = torch.cuda.get_device_capability(0)
    print(card)
    print(f"[phase0] python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, compute capability {cap[0]}.{cap[1]}")
    if cap != (9, 0):
        raise SystemExit(f"chip_smoke: needs compute capability 9.0, got {cap}")
    t0 = time.perf_counter()
    _build.library()
    print(f"[phase0] kernels built and loaded in {time.perf_counter() - t0:.2f} s "
          f"({_build.library_path().name})")
    for line in ptxas_lines(_build.library_path().with_suffix(".log").read_text()):
        print(f"[phase0] ptxas: {line}")

    measured = phase1(card)
    draw_paths = draws_check()
    legal_errs, wide_paths = phase2()
    for k, err in legal_errs.items():
        measured[k]["max_abs_err"] = max(measured[k]["max_abs_err"], err)
    rollout_paths, argmax_rate = phase3(card)
    paths = {**rollout_paths, **phase4(card), **wide_paths, **draw_paths}
    phase5()
    paths.update(phase6(card))
    paths.update(phase7(card, argmax_rate))
    paths.update(phase8(card))
    paths.update(phase9(card, argmax_rate))
    paths.update(phase10(card))

    kernels = []
    for name, (source, replaces, path) in KERNEL_INFO.items():
        if paths[path][name] == 0:
            raise AssertionError(f"{name} was launched no time on its path {path}")
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces,
                        "pallas_source": name not in NO_PALLAS_SOURCE,
                        "path": path, "launches": paths[path][name],
                        "launches_by_path": {p: c[name] for p, c in paths.items()},
                        **measured[name]})
    print(f"[done] {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
