"""The step's tail (B10: ``blockpuzzle_tpu_torch/kernels/tail.py``,
``csrc/packed_tail.cu``): game over, truncation, the score, the auto-reset
and both board views from the mask onward, in one kernel on packed boards,
with the board unpack as its second entry.

On the CPU the wrapper runs its plain version, the torch code of the step's
tail.  The port's packed step, whose tail that is, is held bit-equal to the
JAX packed step (``blockpuzzle_tpu/env/core.py`` ``VecBlockPuzzle.step``)
on 10x10, tenten (a hand of three, refill-batch), 33x9 and 130x8, with and
without auto-reset, plain, with ``PACKED_KNOBS`` (streak bonus,
``max_steps``, both penalties, piece planes) and with a terminal penalty
that float32 rounds (-0.3), from dense boards (every row one hole, up to
three empty rows on top) so that games end within a few steps: both engines
get the same actions, the same refill deals and, for the reset of a
finished env, JAX's own reset deals.  A numpy emulation of the kernel's
block logic (persistent blocks walking tiles of envs through a ring of
shared-memory stages, each input's tile bytes brought by a bulk copy of
the whole 16-byte chunks inside its tensor and its ragged ends by plain
loads, a segment of lanes an env, the flat spans of the outputs) is held
bit-equal to the plain version on those boards, at the wrapper's tile and
ring and at a tile of 7 envs (tiles' spans off a 16-byte boundary), on
batches that are no multiple of the tile, in rings of 1 to 3 stages, on
grids smaller than the tile count and on inputs that start off a 16-byte
boundary; the unpack likewise, and ``board_obs`` of a CPU engine equals
JAX's ``_unpack_board`` on every packed shape; the wrapper's tile and ring
fit the kernel's shared memory on every packed height up to 160 rows.
Floats are compared bit for bit.

JAX is imported inside the tests that use it, so the ``gpu`` tests run on
a machine without it: ``python -m pytest --noconftest -m gpu
tests/test_torch_tail.py``.
"""

import dataclasses
import functools
import inspect

import numpy as np
import pytest
import torch

from blockpuzzle_tpu_torch import config as tcfg
from blockpuzzle_tpu_torch import make_env, rules
from blockpuzzle_tpu_torch.env import rng as trng
from blockpuzzle_tpu_torch.kernels import PackedMaskKernel, PackedTailKernel, _build
from blockpuzzle_tpu_torch.kernels import tail as ktail
from blockpuzzle_tpu_torch.kernels.packed import U32, pack_words, unpack_words
from blockpuzzle_tpu_torch.kernels.tail import Tail, tail_plain
from blockpuzzle_tpu_torch.sampler import UniformLegalSampler

# the boards the tail is held to JAX on: the default preset, a hand of three
# with refill-batch, the tall kernels' and the general kernels' heights
BOARDS = {"default": None, "tenten": None, "tall33": dict(height=33, width=9),
          "tall130": dict(height=130, width=8)}
# every packed shape: the presets, tall boards of two, three and four slots a
# lane (36x9 with regions and a hand of three), and above 128 rows
PACKED_SHAPES = {"default": None, "tenten": None, "woodoku": None, "big": None,
                 "tall33": BOARDS["tall33"],
                 "tall36r3": dict(height=36, width=9, region_clear=True, region_size=3,
                                  queue_size=3),
                 "tall64": dict(height=64, width=8), "tall128": dict(height=128, width=10),
                 "tall130": BOARDS["tall130"]}
# tests/test_torch_engine.py PACKED_KNOBS, and a terminal penalty that
# float32 rounds
KNOBS = {"plain": {},
         "knobs": {"streak_bonus": 5.0, "max_steps": 9, "illegal_penalty": -1.0,
                   "terminal_penalty": -5.0, "obs_planes": True},
         "penalty": {"terminal_penalty": -0.3}}
N, STEPS = 16, 14


def board_config(config, board, knobs=()):
    """``config``'s (the JAX or the port's config module) preset or board,
    with ``knobs``."""
    shape = PACKED_SHAPES[board]
    cfg = config.PRESETS[board]() if shape is None else config.EnvConfig(**shape)
    return dataclasses.replace(cfg, **dict(knobs))


def dense_cells(cfg, n, rng):
    """(n, H, W) 0/1 boards on which games end within a few steps: every row
    full but for one hole, the top 0 to 3 rows empty."""
    cells = np.ones((n, cfg.height, cfg.width), np.uint8)
    holes = rng.integers(0, cfg.width, (n, cfg.height))
    np.put_along_axis(cells, holes[:, :, None], 0, axis=2)
    top = rng.integers(0, 4, n)
    cells[np.arange(cfg.height)[None, :] < top[:, None]] = 0
    return cells


def tail_inputs(cfg, n, rng):
    """The tail's inputs as the step hands them, on dense boards: the row
    words and the packed mask of the refilled hand (ids of every kind, the
    sentinel and ids outside [0, P] among them, as in the reset deals),
    rewards, steps up to past ``max_steps``, scores, streaks and counters
    that wrap at 2**31."""
    p = rules.tables_for(cfg).num_pieces
    s = cfg.queue_size
    words = pack_words(torch.as_tensor(dense_cells(cfg, n, rng)))
    words[::5] = 0                                        # empty boards: a legal move
    queue3 = torch.as_tensor(rng.integers(-1, p + 3, (n, s)), dtype=torch.int32)
    # the reset deals as the step hands them: the second half of its deal
    reset = torch.as_tensor(rng.integers(-2, p + 3, (n, 2 * s)), dtype=torch.int32)[:, s:]
    mask = PackedMaskKernel(cfg, "cpu")(words, queue3)
    reward = torch.as_tensor(rng.integers(-4, 40, n) * 0.5, dtype=torch.float32)
    steps = torch.as_tensor(rng.integers(0, 12, n), dtype=torch.int32)
    score = torch.as_tensor(rng.standard_normal(n) * 50, dtype=torch.float32)
    streak = torch.as_tensor(rng.integers(0, 4, n), dtype=torch.int32)
    counter = torch.as_tensor(rng.integers(-2**31, 2**31, n), dtype=torch.int32)
    counter[::7] = 2**31 - 1
    return words, mask, reward, queue3, reset, steps, score, streak, counter


def assert_same_bits(got, want, what):
    """Equal values and, for floats, equal bits (+0.0 is not -0.0)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    if want.dtype.kind == "f":
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32), what)
    else:
        np.testing.assert_array_equal(got.astype(np.int64), want.astype(np.int64), what)


def assert_same_tail(got: Tail, want: Tail, what):
    for field, g, w in zip(Tail._fields, got, want):
        if w is None:
            assert g is None, f"{field} {what}"
        else:
            assert g.dtype == w.dtype and g.shape == w.shape, f"{field} {what}"
            assert_same_bits(g.cpu().numpy(), w.cpu().numpy(), f"{field} {what}")


# ------------------------------------------------------ against JAX ----


class ResetDeals:
    """The engine's deal kernel, but for the reset deals of the step about
    to run, which are JAX's own (``_deal_batch`` with tag 1): so a finished
    env redeals as in the JAX engine and every field can be compared."""

    def __init__(self, kernel):
        self.kernel, self.next = kernel, None

    def __call__(self, key, counter, tag, width):
        if tag == trng.TAG_RESET:
            return torch.tensor(self.next)
        return self.kernel(key, counter, tag, width)


@functools.cache
def jax_packed(board, knobs, auto_reset):
    """JAX's packed engine on ``board``, its jitted step in parity mode and
    its reset deals for a state."""
    import jax

    from blockpuzzle_tpu import config as jcfg
    from blockpuzzle_tpu.env import make_env as jax_make_env

    env_j = jax_make_env(board_config(jcfg, board, knobs), state_impl="packed")
    step = jax.jit(lambda s, a, d: env_j.step(s, a, deal_override=d, auto_reset=auto_reset))
    reset = jax.jit(lambda s: env_j._deal_batch(s.base_key, s.rng_counter, tag=1))
    return env_j, step, reset


@pytest.mark.parametrize("auto_reset", [True, False], ids=["auto_reset", "no_reset"])
@pytest.mark.parametrize("knobs", KNOBS)
@pytest.mark.parametrize("board", BOARDS)
def test_packed_step_tail_matches_jax_packed_step(board, knobs, auto_reset):
    """Every output of the port's packed step (whose tail is the plain
    version on the CPU) bit-equal to the JAX packed step's, step by step,
    through game overs (and truncations at ``max_steps``): the flags, the
    reward, every info field (``final_board``, ``final_queue``,
    ``final_action_mask``, ``final_piece_planes`` with auto-reset), the
    timestep's board, hand, mask and piece planes, and the new state."""
    import jax
    import jax.numpy as jnp

    from test_torch_engine import pick_actions

    kn = tuple(sorted(KNOBS[knobs].items()))
    env_j, step_j, reset_j = jax_packed(board, kn, auto_reset)
    ct = board_config(tcfg, board, kn)
    env_t = make_env(ct, device="cpu")
    assert env_t.state_impl == "packed"
    deals = env_t.deal_kernel = ResetDeals(env_t.deal_kernel)
    rng = np.random.default_rng(16)
    p, s = env_t.num_pieces, ct.queue_size
    init = rng.integers(0, p, (N, s)).astype(np.int32)
    sj, _ = env_j.init(jax.random.key(0), N, deal_override=jnp.asarray(init))
    st, _ = env_t.init(0, N, deal_override=init)
    cells = dense_cells(ct, N, rng)
    sj = sj.replace(board=env_j.encode_board(jnp.asarray(cells)))
    st = st.replace(board=env_t.encode_board(cells))
    mask = np.asarray(env_j.action_mask(sj.board, sj.queue))
    seen = {"terminated": 0, "truncated": 0}
    for t in range(STEPS):
        a = pick_actions(mask, rng, env_t.num_actions)
        d = rng.integers(0, p, (N, s)).astype(np.int32)
        deals.next = np.asarray(reset_j(sj))
        sj, tj = step_j(sj, jnp.asarray(a), jnp.asarray(d))
        st, tt = env_t.step(st, a, deal_override=d, auto_reset=auto_reset)
        for f in ("board", "queue", "action_mask", "reward", "terminated", "truncated"):
            assert_same_bits(getattr(tt, f).numpy(), getattr(tj, f), f"{f} t={t}")
        assert (tt.piece_planes is None) == (tj.piece_planes is None)
        if tj.piece_planes is not None:
            assert_same_bits(tt.piece_planes.numpy(), tj.piece_planes, f"planes t={t}")
        assert set(tt.info) == set(tj.info)
        assert ("final_board" in tt.info) == auto_reset
        for k in tj.info:
            assert_same_bits(tt.info[k].numpy(), tj.info[k], f"{k} t={t}")
        for f in ("board", "queue", "rng_counter", "steps", "score", "streak"):
            assert_same_bits(getattr(st, f).numpy(), getattr(sj, f), f"state {f} t={t}")
        mask = np.asarray(tj.action_mask)
        seen["terminated"] += int(tt.terminated.sum())
        seen["truncated"] += int(tt.truncated.sum())
    assert seen["terminated"] > 0
    assert seen["truncated"] > 0 if knobs == "knobs" else seen["truncated"] == 0


# ------------------------------------------------ the kernel, in numpy ----


UNSET = 1 << 40  # above every int32 and row word
GARBAGE = 0xAB   # shared memory's bytes before anything is staged there


def _div(q, d):
    """The kernel's q / d (``bit_rows::small_div``: q < 2^21)."""
    from test_torch_packed import _small_div

    assert 0 <= q < 1 << 21
    return int(_small_div(q, d))


class Memory:
    """The tail's inputs as the card holds them: each a run of bytes from
    an address (``bases``: each input's address mod 16 when it is not 0;
    the mask's must be 0), read back at absolute addresses, never outside
    its tensor.  The reset deals are a view of rows ``stride`` ids apart,
    so their bytes are those of the view's extent in its storage."""

    def __init__(self, cfg, inputs, auto_reset, bases=None):
        words, mask, reward, queue3, reset, steps, score, streak, counter = inputs
        tensors = {"mask": mask, "words": words, "reward": reward, "steps": steps,
                   "score": score, "counter": counter}
        self.reset_stride = None
        if auto_reset:
            self.reset_stride = reset.stride(0)
            n, s = reset.shape
            extent = reset.as_strided(((n - 1) * self.reset_stride + s,), (1,))
            tensors.update(queue3=queue3, streak=streak, reset=extent)
        bases = {"reset": 4 * cfg.queue_size, **(bases or {})}
        assert bases.get("mask", 0) == 0                # the kernel refuses others
        self.src = ktail.tail_sources(cfg, self.reset_stride)
        self.at, self.bytes = {}, {}
        for i, (k, t) in enumerate(tensors.items()):
            self.bytes[k] = np.ascontiguousarray(t.numpy()).view(np.uint8).reshape(-1)
            self.at[k] = (1 << 20) * (i + 1) + bases.get(k, 0)

    def read(self, k, x0, x1):
        g, b = self.at[k], self.bytes[k]
        assert g <= x0 <= x1 <= g + b.size, f"{k}: [{x0}, {x1}) outside its tensor"
        return b[x0 - g : x1 - g]

    def span(self, k, first, count):
        """csrc/packed_tail.cu ``tile_span``: (x0, x1, from, a0, a1)."""
        stride, length = self.src[k]
        g, b = self.at[k], self.bytes[k]
        x0, x1 = g + first * stride, g + (first + count - 1) * stride + length
        return x0, x1, x0 & ~15, (g + 15) & ~15, (g + b.size) & ~15


def emulate_packed_tail(cfg, inputs, auto_reset, envs, table, stages=3, blocks=2, bases=None):
    """csrc/packed_tail.cu ``packed_tail_kernel``, block by block: ``blocks``
    persistent blocks, block b walking tiles b, b + blocks, ... of ``envs``
    envs through a ring of ``stages`` stages of its shared memory (laid out
    by ``tail_layout``, every byte ``GARBAGE`` until written).  Thread
    0 issues a tile's bulk copies ``stages - 1`` tiles ahead, into the stage
    freed last: for each input, the 16-byte chunks covering the tile's
    bytes that lie inside its tensor (16-byte aligned addresses and sizes,
    inside the slot), a byte at address x landing at x minus the tile's
    first address rounded down to 16; at the wait, the stage must hold that
    tile, filled once more than it was used (the mbarrier's parity), and, on
    tiles within 15 envs of either end, the tensors' first and last bytes off
    a boundary come by plain loads.  Then phase B, a segment of
    ``tail_segment(envs)`` lanes an env: the env's staged mask as 32-bit
    words, masked at the span's ends, OR'ed lane by lane and across the
    segment; done from it and the staged steps; rows, view rows and the new
    int64 words; for a done env, its reset slots' table rows written over
    its staged mask.  Phase C, a thread an env: the flags and scalars from
    the flag bytes and the staged ones.  Phase D: the mask output as aligned
    vectors of the staged mask, both board views by ``store_span``.  Every
    output byte is written once.  Returns a ``Tail`` of numpy arrays (None
    where the kernel writes nothing)."""
    from test_torch_kernels import emulate_store_span

    mem = Memory(cfg, inputs, auto_reset, bases)
    n, h = inputs[0].shape
    w, s = cfg.width, cfg.queue_size
    hw, span = h * w, s * h * w
    num_pieces = table.shape[0] - 1
    keep = (1 << w) - 1
    table = table.reshape(-1).astype(np.uint8)
    lay = ktail.tail_layout(cfg, envs, stages, mem.reset_stride)
    seg = ktail.tail_segment(envs)
    ends = {k: (list(lay.slots.values()) + [lay.stage])[i + 1]
            for i, k in enumerate(lay.slots)}                # a slot's end in a stage
    max_steps = cfg.max_steps
    # not yet written: 2 in a byte output, NaN in a float, UNSET in an integer
    out = {"terminated": np.full(n, 2, np.uint8), "truncated": np.full(n, 2, np.uint8),
           "reward": np.full(n, np.nan, np.float32), "score_next": np.full(n, np.nan, np.float32),
           "steps_next": np.full(n, UNSET), "rng_counter": np.full(n, UNSET),
           "board": np.full(n * hw, 2, np.uint8)}
    if auto_reset:
        out.update(final_board=np.full(n * hw, 2, np.uint8), board_out=np.full(n * h, UNSET),
                   queue_out=np.full(n * s, UNSET), mask_out=np.full(n * span, 2, np.uint8),
                   steps_out=np.full(n, UNSET), score_out=np.full(n, np.nan, np.float32),
                   streak_out=np.full(n, UNSET))
    ntiles = -(-n // envs)
    seen = []

    def tile_of(tile):
        first = tile * envs
        return first, min(envs, n - first)

    for b in range(blocks):
        smem = np.full(lay.bytes, GARBAGE, np.uint8)
        fills, holds = [0] * stages, [None] * stages

        def issue(tile, r):
            first, count = tile_of(tile)
            stage = lay.ring + r * lay.stage
            for k in lay.slots:
                x0, x1, frm, a0, a1 = mem.span(k, first, count)
                b0, b1 = max(frm, a0), min((x1 + 15) & ~15, a1)
                if b0 < b1:
                    dst = stage + lay.slots[k] + b0 - frm
                    assert b0 % 16 == 0 and (b1 - b0) % 16 == 0 and dst % 16 == 0
                    assert dst + b1 - b0 <= stage + ends[k], f"{k} past its slot"
                    smem[dst : dst + b1 - b0] = mem.read(k, b0, b1)
            fills[r] += 1
            holds[r] = tile

        for k in range(stages - 1):
            if b + k * blocks < ntiles:
                issue(b + k * blocks, k)
        for i, tile in enumerate(range(b, ntiles, blocks)):
            if tile + (stages - 1) * blocks < ntiles:
                issue(tile + (stages - 1) * blocks, (i + stages - 1) % stages)
            r = i % stages
            assert holds[r] == tile and fills[r] == i // stages + 1, "the ring's order"
            seen.append(tile)
            stage = lay.ring + r * lay.stage
            first, count = tile_of(tile)
            at = {}
            near_end = first < 15 or n - first - count < 15
            for k in lay.slots:                          # the ragged bytes, then where each is
                x0, x1, frm, a0, a1 = mem.span(k, first, count)
                slot = stage + lay.slots[k]
                for lo, hi in ((x0, min(x1, a0)), (max(x0, a1), x1)):
                    if lo < hi:                      # only on tiles near either end
                        assert near_end and hi - lo < 16
                        smem[slot + lo - frm : slot + hi - frm] = mem.read(k, lo, hi)
                at[k] = slot + (x0 & 15)

            def staged(k, dtype, nelem=count):
                size = np.dtype(dtype).itemsize
                assert at[k] % size == 0
                return smem[at[k] : at[k] + size * nelem].view(dtype)

            words64 = staged("words", np.int64, count * h)
            steps = staged("steps", np.int32)
            if auto_reset:
                reset = staged("reset", np.int32, (count - 1) * mem.reset_stride + s)
            # -- phase B: a segment of ``seg`` lanes an env
            mw = smem[stage + lay.slots["mask"] : stage + ends["mask"]].view("<u4")
            m_at = at["mask"] - stage - lay.slots["mask"]
            flags = np.full(count, GARBAGE)
            rows, view = np.full(count * h, -1), np.full(count * h, -1)
            reward, score = staged("reward", np.float32), staged("score", np.float32)
            counter = staged("counter", np.int32)
            for e in range(count):
                assert (e + 1) * seg <= ktail.THREADS
                start, end = m_at + e * span, m_at + (e + 1) * span
                ws = np.arange(start // 4, (end + 3) // 4)
                v = mw[ws].astype(np.uint64)
                before, inside = start - 4 * ws, end - 4 * ws
                v &= np.where(before > 0, (0xFFFFFFFF << (8 * np.maximum(before, 0))) & 0xFFFFFFFF,
                              0xFFFFFFFF).astype(np.uint64)
                v &= np.where(inside < 4, 0xFFFFFFFF >> (8 * np.clip(4 - inside, 0, 3)),
                              0xFFFFFFFF).astype(np.uint64)
                lanes = np.zeros(seg, np.uint64)
                np.bitwise_or.at(lanes, (ws - start // 4) % seg, v)
                term = np.bitwise_or.reduce(lanes) == 0         # __reduce_or_sync
                st = (int(steps[e]) + 1 + 2**31) % 2**32 - 2**31
                trunc = max_steps > 0 and st >= max_steps
                done = term or trunc
                x = (words64[e * h : (e + 1) * h] & U32) & keep
                rows[e * h : (e + 1) * h] = x
                if auto_reset:
                    view[e * h : (e + 1) * h] = 0 if done else x
                    board_out = out["board_out"][(first + e) * h : (first + e + 1) * h]
                    assert (board_out == UNSET).all()
                    board_out[:] = 0 if done else words64[e * h : (e + 1) * h]
                    fresh = reset[e * mem.reset_stride : e * mem.reset_stride + s]
                flags[e] = int(term) | int(done) << 1
                if auto_reset and done:        # the table rows over the staged mask
                    for j in range(span):
                        k = _div(j, hw)
                        p = fresh[k] if 0 <= fresh[k] < num_pieces else num_pieces
                        smem[at["mask"] + e * span + j] = table[p * hw + j - k * hw]
            # -- phase C: a thread an env, the flags and scalars
            for e in range(count):
                term, done = bool(flags[e] & 1), bool(flags[e] >> 1)
                st = (int(steps[e]) + 1 + 2**31) % 2**32 - 2**31
                trunc = max_steps > 0 and st >= max_steps
                env = first + e
                rw = np.float32(reward[e] + np.float32(cfg.terminal_penalty)) if term else reward[e]
                sc = np.float32(score[e] + rw)
                out["terminated"][env], out["truncated"][env] = term, trunc
                out["reward"][env], out["score_next"][env] = rw, sc
                out["steps_next"][env] = st
                out["rng_counter"][env] = (int(counter[e]) + 1 + 2**31) % 2**32 - 2**31
                if auto_reset:
                    out["steps_out"][env] = 0 if done else st
                    out["score_out"][env] = np.float32(0.0) if done else sc
                    out["streak_out"][env] = 0 if done else staged("streak", np.int32)[e]
                    queue3 = staged("queue3", np.int32, count * s)
                    fresh = reset[e * mem.reset_stride : e * mem.reset_stride + s]
                    for k in range(s):
                        out["queue_out"][env * s + k] = fresh[k] if done else queue3[e * s + k]

            # -- phase D: the flat spans
            if auto_reset:
                lo, nbytes = first * span, count * span
                head = min((16 - lo % 16) % 16, nbytes)
                nvec = (nbytes - head) // 16
                o, m = out["mask_out"], smem[at["mask"] :]
                for v in range(nvec):
                    q = head + 16 * v
                    assert (lo + q) % 16 == 0 and (at["mask"] + q) % 16 == 0  # the uint4s
                    assert (o[lo + q : lo + q + 16] == 2).all()
                    o[lo + q : lo + q + 16] = m[q : q + 16]
                for j in range(nbytes - 16 * nvec):
                    q = j if j < head else j + 16 * nvec
                    assert o[lo + q] == 2
                    o[lo + q] = m[q]
                emulate_store_span(rows, out["final_board"], first * hw, count * hw, w)
                emulate_store_span(view, out["board"], first * hw, count * hw, w)
            else:
                emulate_store_span(rows, out["board"], first * hw, count * hw, w)
    assert sorted(seen) == list(range(ntiles))               # every tile once
    for k, v in out.items():                                  # every byte written
        unset = np.isnan(v) if v.dtype.kind == "f" else v == (2 if v.dtype == np.uint8 else UNSET)
        assert not unset.any(), k
    shape = (n, h, w)
    return Tail(out["terminated"].astype(bool), out["truncated"].astype(bool), out["reward"],
                out["score_next"], out["steps_next"], out["rng_counter"],
                out["board"].reshape(shape),
                *((out["final_board"].reshape(shape), out["board_out"].reshape(n, h),
                   out["queue_out"].reshape(n, s), out["mask_out"].reshape(n, span).astype(bool),
                   out["steps_out"], out["score_out"], out["streak_out"])
                  if auto_reset else (None,) * 7))


def emulate_packed_unpack(cfg, words, envs):
    """csrc/packed_tail.cu ``packed_unpack_kernel``: a tile's rows staged,
    cut to W columns, then ``store_span``."""
    from test_torch_kernels import emulate_store_span

    n, h = words.shape
    hw = h * cfg.width
    out = np.full(n * hw, 2, np.uint8)
    rows = (words.numpy().reshape(-1) & U32) & ((1 << cfg.width) - 1)
    for first in range(0, n, envs):
        count = min(envs, n - first)
        emulate_store_span(rows[first * h : (first + count) * h], out, first * hw,
                           count * hw, cfg.width)
    assert (out < 2).all()
    return out.reshape(n, h, cfg.width)


def check_emulated_tail(cfg, n, auto_reset, envs, seed, **ring):
    """The emulated kernel bit-equal to the plain tail on ``tail_inputs``,
    some envs done and some not; the plain tail for further checks."""
    k = PackedTailKernel(cfg, "cpu")
    inputs = tail_inputs(cfg, n, np.random.default_rng(seed))
    want = k(*inputs, auto_reset)
    got = emulate_packed_tail(cfg, inputs, auto_reset, envs, k.empty_legal.numpy(), **ring)
    for i, (field, g, w) in enumerate(zip(Tail._fields, got, want)):
        if g is None:  # without auto-reset the kernel writes the first seven
            assert not auto_reset and i >= 7, field
        else:
            assert_same_bits(g, w.numpy(), f"{field}, tile {envs}, {ring}")
    done = want.terminated | want.truncated
    assert 0 < int(want.terminated.sum()) < n and 0 < int(done.sum()) < n
    return want


@pytest.mark.parametrize("tile", ["wrapper", 7])
@pytest.mark.parametrize("auto_reset", [True, False], ids=["auto_reset", "no_reset"])
@pytest.mark.parametrize("board", BOARDS)
def test_emulated_tail_kernel_matches_plain(board, auto_reset, tile):
    """The kernel's block logic, in numpy, bit-equal to the plain tail on
    dense boards with ``max_steps`` and a terminal penalty that rounds, on
    two tiles and a bit more, two persistent blocks walking them through the
    wrapper's ring: at the wrapper's tile (64 envs on 10x10, fewer on
    tenten, 33x9 and 130x8) and at 7 envs, whose spans start off a 16-byte
    boundary (on 130x8 an env's 1040 mask bytes are 65 vectors); ids outside
    [0, P] in the hand and the reset deals, counters at 2**31 - 1."""
    cfg = board_config(tcfg, board, (("max_steps", 9), ("terminal_penalty", -0.3)))
    k = PackedTailKernel(cfg, "cpu")
    envs = k.envs if tile == "wrapper" else tile
    n = 2 * envs + 37
    check_emulated_tail(cfg, n, auto_reset, envs, envs, stages=k.stages)
    span = cfg.queue_size * cfg.num_cells
    if tile == 7:  # spans off a boundary but where an env's span is 16-byte whole
        assert any(first * span % 16 for first in range(0, n, envs)) == bool(span % 16)


@pytest.mark.parametrize("n_off", [-1, 1], ids=["tiles_less_one", "tiles_and_one"])
@pytest.mark.parametrize("stages", [1, 2, 3])
@pytest.mark.parametrize("board", BOARDS)
def test_emulated_tail_ring_matches_plain(board, stages, n_off):
    """The emulated kernel through rings of 1, 2 and 3 stages, three blocks
    walking 6 or 7 tiles of 7 envs (a grid smaller than the tile count,
    blocks taking 2 or 3 tiles), N one less and one more than a multiple of
    the tile: bit-equal to the plain tail."""
    cfg = board_config(tcfg, board, (("max_steps", 9), ("terminal_penalty", -0.3)))
    check_emulated_tail(cfg, 6 * 7 + n_off, True, 7, 11, stages=stages, blocks=3)


# inputs at addresses off a 16-byte boundary (the mask must start on one):
# each tensor's first and last bytes come by plain loads
OFF_BOUNDARY = {"words": 8, "reward": 4, "steps": 12, "score": 8, "counter": 4,
                "queue3": 12, "streak": 4}


@pytest.mark.parametrize("grid", ["one", "a_tile_each"])
@pytest.mark.parametrize("board", BOARDS)
def test_emulated_tail_on_inputs_off_a_boundary(board, grid):
    """The emulated kernel on inputs that start off a 16-byte boundary
    (views: int64 words 8 bytes past one, scalars 4 to 12, the reset deals 4
    past the step's half of its deal), the grid one block or a block a tile,
    at the wrapper's tile and ring: bit-equal to the plain tail, every read
    inside its tensor."""
    cfg = board_config(tcfg, board, (("max_steps", 9), ("terminal_penalty", -0.3)))
    k = PackedTailKernel(cfg, "cpu")
    n = 3 * k.envs + 5
    blocks = 1 if grid == "one" else 4
    bases = dict(OFF_BOUNDARY, reset=4 + 4 * cfg.queue_size)
    check_emulated_tail(cfg, n, True, k.envs, 13, stages=k.stages, blocks=blocks, bases=bases)


@pytest.mark.parametrize("board", PACKED_SHAPES)
def test_board_obs_and_unpack_match_jax_unpack_board(board):
    """``board_obs`` of a CPU packed engine (the unpack's plain version)
    equals JAX's ``_unpack_board``; the kernel's unpack, emulated at the
    wrapper's tile and at 7 envs, equals both; words carrying bits at and
    above W unpack their W columns alone."""
    import jax.numpy as jnp

    from blockpuzzle_tpu import config as jcfg
    from blockpuzzle_tpu.env import make_env as jax_make_env

    cfg = board_config(tcfg, board)
    env_t = make_env(cfg, device="cpu")
    env_j = jax_make_env(board_config(jcfg, board), state_impl="packed")
    rng = np.random.default_rng(3)
    n = 2 * env_t.packed_tail_kernel.unpack_envs + 5
    words = torch.as_tensor(rng.integers(0, 1 << cfg.width, (n, cfg.height)))
    want = np.asarray(env_j._unpack_board(jnp.asarray(words.numpy().astype(np.uint32))))
    got = env_t.board_obs(words)
    assert got.dtype == torch.uint8 and got.shape == (n, cfg.height, cfg.width)
    np.testing.assert_array_equal(got.numpy(), want)
    for envs in (env_t.packed_tail_kernel.unpack_envs, 7):
        np.testing.assert_array_equal(emulate_packed_unpack(cfg, words, envs), want)
    high = words | (torch.as_tensor(rng.integers(0, 2, (n, cfg.height))) << cfg.width)
    np.testing.assert_array_equal(emulate_packed_unpack(cfg, high, 7), want)
    np.testing.assert_array_equal(unpack_words(high, cfg.width).numpy(), want)


# ------------------------------------------------------- the wrapper ----


def test_tail_wrapper_runs_the_plain_version_on_the_cpu():
    """On CPU tensors the wrapper is ``tail_plain`` with ``unpack_words``
    (the step's tail), with and without auto-reset, and launches nothing;
    without auto-reset it hands back its inputs where the step does and
    has no final board."""
    cfg = board_config(tcfg, "tenten", (("max_steps", 9), ("terminal_penalty", -0.3)))
    k = PackedTailKernel(cfg, "cpu")
    inputs = tail_inputs(cfg, 40, np.random.default_rng(1))
    for auto_reset in (True, False):
        got = k(*inputs, auto_reset)
        want = tail_plain(*inputs, auto_reset, cfg, k.empty_legal,
                          lambda w: unpack_words(w, cfg.width))
        assert_same_tail(got, want, f"auto_reset {auto_reset}")
    words, mask, _, queue3, _, _, _, streak, _ = inputs
    assert got.final_board is None
    assert got.board_out is words and got.queue_out is queue3 and got.mask_out is mask
    assert got.streak_out is streak and got.steps_out is got.steps_next
    assert torch.equal(k.unpack(words), unpack_words(words, cfg.width))
    assert k.launches == k.unpack_launches == 0
    t = rules.tables_for(cfg)
    assert k.empty_legal.shape == (t.num_pieces + 1, cfg.num_cells)
    assert not k.empty_legal[-1].any()


def test_tail_wrapper_refuses_bad_inputs():
    """Wrong shapes, dtypes or devices raise, on the CPU as on the card; a
    device with no kernel raises after the checks; a board too wide for a
    row word has no packed tail."""
    cfg = tcfg.PRESETS["tenten"]()
    k = PackedTailKernel(cfg, "cpu")
    good = list(tail_inputs(cfg, 8, np.random.default_rng(2)))
    bad = {0: good[0][:, :-1], 1: good[1].to(torch.uint8), 2: good[2].double(),
           3: good[3][:, :1], 4: good[4].long(), 5: good[5][:-1], 6: good[6].half(),
           7: good[7].long(), 8: good[8].long()}
    for i, x in bad.items():
        args = list(good)
        args[i] = x
        with pytest.raises(ValueError):
            k(*args, True)
    args = list(good)
    args[4] = None
    with pytest.raises(ValueError, match="reset_deals"):
        k(*args, True)
    k(*args, False)                                 # no reset deals without auto-reset
    with pytest.raises(ValueError):
        k.unpack(good[0].int())
    meta = torch.device("meta")
    km = PackedTailKernel(cfg, meta)
    with pytest.raises(ValueError, match="no packed tail kernel"):
        km(*(x.to(meta) for x in good), True)
    with pytest.raises(ValueError, match="no packed tail kernel"):
        km.unpack(good[0].to(meta))
    with pytest.raises(ValueError):
        k(*(x.to(meta) for x in good), True)        # tensors on another device
    with pytest.raises(ValueError, match="width <= 32"):
        PackedTailKernel(tcfg.EnvConfig(height=8, width=40), "cpu")


def check_ring(cfg):
    """``tail_ring``'s choice for ``cfg``, held to its rule.  The tile it
    aims at (``tail_tile``) is a power of two up to ``TILE`` envs, the
    largest whose segments (``tail_segment``) leave a lane at most
    ``LANE_BYTES`` of an env's mask bytes, or a warp an env.  The ring is
    the deepest of up to ``STAGES`` that holds that tile in ``RING_SMEM``;
    where none does, the deepest whose tile of one env fits ``RING_SMEM``,
    else the opted-in ``SMEM_LIMIT``, with as many envs as fit it; None
    where one env in one stage does not fit the limit.  The choice fits the
    limit with the step's reset deals (2S ids apart) and with contiguous
    ones, and keeps the kernel's divisions in range (csrc/packed_tail.cu
    ``tile_fits``: the tile's mask span and row words under 2^21, its board
    bytes times W under 2^32)."""
    stride, s = 2 * cfg.queue_size, cfg.queue_size
    span = s * cfg.num_cells
    ring, tile = ktail.tail_ring(cfg), ktail.tail_tile(cfg)
    seg = ktail.tail_segment(tile)
    assert tile & (tile - 1) == 0 and tile <= ktail.TILE and tile * seg <= ktail.THREADS
    assert span <= ktail.LANE_BYTES * seg or seg == 32
    assert tile == ktail.TILE or span > ktail.LANE_BYTES * ktail.tail_segment(2 * tile)

    def smem(envs, stages):
        return ktail.tail_smem_bytes(cfg, envs, stages, stride)

    if smem(1, 1) > ktail.SMEM_LIMIT:
        assert ring is None
        return None
    envs, stages = ring
    deep = [r for r in range(1, ktail.STAGES + 1) if smem(tile, r) <= ktail.RING_SMEM]
    if deep:
        assert (envs, stages) == (tile, max(deep))
    else:
        budget = ktail.RING_SMEM if smem(1, 1) <= ktail.RING_SMEM else ktail.SMEM_LIMIT
        assert stages == max(r for r in range(1, ktail.STAGES + 1) if smem(1, r) <= budget)
        assert smem(envs, stages) <= budget and (envs == tile or smem(envs + 1, stages) > budget)
    for reset_stride in (stride, s, None):
        assert ktail.tail_smem_bytes(cfg, envs, stages, reset_stride) <= ktail.SMEM_LIMIT
    hw = cfg.height * cfg.width
    assert envs * s * hw < 1 << 21 and envs * cfg.height < 1 << 21
    assert envs * hw * cfg.width < 1 << 32
    return ring


@pytest.mark.parametrize("height", [10, 33, 130, 1000, 3000])
def test_tail_tile_fits_the_kernel(height):
    """The wrapper's tile and ring keep ``check_ring``'s rule, on boards of
    32 and 9 columns; where one env in one stage does not fit the opted-in
    shared memory there is no ring and a launch raises (two stages on 1000x32
    with a hand of three, none on 3000x32); the unpack's tile fits a plain
    launch.  Rings of 3 stages within
    56 KB on the presets, tiles of ``TILE`` envs on 10x10."""
    for width, s in ((32, 3), (9, 1)):
        cfg = tcfg.EnvConfig(height=height, width=width, queue_size=s)
        check_ring(cfg)
        unpack = ktail.unpack_block_envs(cfg)
        assert 1 <= unpack <= ktail.MAX_TILE and 4 * unpack * height <= ktail.UNPACK_LIMIT
    assert ktail.tail_ring(tcfg.EnvConfig(height=1000, width=32, queue_size=3)) == (1, 2)
    assert ktail.tail_ring(tcfg.EnvConfig(height=3000, width=32, queue_size=3)) is None
    # the wrapper's check on the card (boards that large have no rule tables
    # here): no ring, or a tile too large for the shared memory, raises
    k = PackedTailKernel(tcfg.EnvConfig(height=130, width=8), "cpu")
    k.device = torch.device("cuda")
    too_big = ktail.tail_smem_bytes(k.cfg, ktail.MAX_TILE, ktail.STAGES, 2)
    for smem in (0, too_big):
        with pytest.raises(ValueError, match="does not fit"):
            k._check_launch([], smem=smem)
    for name in ("default", "tenten", "woodoku", "big"):
        cfg = tcfg.PRESETS[name]()
        envs, stages = check_ring(cfg)
        assert stages == ktail.STAGES
        assert ktail.tail_smem_bytes(cfg, envs, stages, 2 * cfg.queue_size) <= ktail.RING_SMEM
        assert ktail.unpack_block_envs(cfg) == ktail.MAX_TILE
    assert ktail.tail_ring(tcfg.PRESETS["default"]()) == (ktail.TILE, ktail.STAGES)


@pytest.mark.parametrize("queue_size", [1, 3])
def test_tail_ring_fits_every_packed_height(queue_size):
    """For every board JAX's ``make_env`` runs packed (W <= 32) from 1 to
    160 rows, on widths 1 to 32: a ring by ``check_ring``'s rule, of tiles of
    at least one env, within the opted-in shared memory; the layout's slots
    in order, 16-byte aligned, each holding the tile's bytes of its input
    with up to 15 bytes either side."""
    from blockpuzzle_tpu import config as jcfg
    from blockpuzzle_tpu.env import make_env as jax_make_env

    assert jax_make_env(jcfg.EnvConfig(height=160, width=32)).state_impl == "packed"
    for height in range(1, 161):
        for width in (1, 8, 9, 10, 16, 31, 32):
            cfg = tcfg.EnvConfig(height=height, width=width, queue_size=queue_size)
            envs, stages = check_ring(cfg)
            stride = 2 * queue_size
            lay = ktail.tail_layout(cfg, envs, stages, stride)
            assert envs >= 1 and lay.bytes <= ktail.SMEM_LIMIT, (height, width)
            assert lay.ring % 16 == 0 and lay.stage % 16 == 0
            ends = list(lay.slots.values())[1:] + [lay.stage]
            for (k, at), end in zip(lay.slots.items(), ends):
                step, length = ktail.tail_sources(cfg, stride)[k]
                assert at % 16 == 0 and end - at >= (envs - 1) * step + length + 30, k


def test_engine_uses_the_tail_on_packed_boards_only():
    """A packed engine binds a tail wrapper to its config and device, and its
    ``board_obs`` is the wrapper's ``unpack``; a u8 engine's step runs the
    plain tail on its cells, and a board too wide for row words has no
    packed tail."""
    env = make_env(device="cpu")
    assert isinstance(env.packed_tail_kernel, PackedTailKernel)
    assert env.packed_tail_kernel.cfg is env.cfg and env.packed_tail_kernel.device == env.device
    assert torch.equal(env.packed_tail_kernel.empty_legal, env._empty_legal)
    seen = []
    unpack = env.packed_tail_kernel.unpack
    env.packed_tail_kernel.unpack = lambda w: seen.append(w) or unpack(w)
    state, _ = env.init(0, 4)
    assert len(seen) == 1                            # init's timestep board
    env.legal_all_pieces(state.board)
    assert len(seen) == 2
    wide = make_env(tcfg.EnvConfig(height=8, width=40), device="cpu")
    assert wide.packed_tail_kernel is None


# ------------------------------------------------------------ the card ----


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the CPU has only the plain versions)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("tile", ["wrapper", 7])
@pytest.mark.parametrize("auto_reset", [True, False], ids=["auto_reset", "no_reset"])
@pytest.mark.parametrize("board", BOARDS)
def test_tail_kernel_matches_plain_on_the_card(board, auto_reset, tile, cuda_device):
    """The tail and unpack kernels bit-equal to their plain versions on the
    card, on dense boards, at 4099 envs (no multiple of any tile)."""
    cfg = board_config(tcfg, board, (("max_steps", 9), ("terminal_penalty", -0.3)))
    k = PackedTailKernel(cfg, cuda_device)
    if tile != "wrapper":
        k.envs = tile
    inputs = [x.to(cuda_device) for x in tail_inputs(cfg, 4099, np.random.default_rng(5))]
    got = k(*inputs, auto_reset)
    assert k.launches == 1
    assert_same_tail(got, k.plain(*inputs, auto_reset), f"{board}, tile {k.envs}")
    assert torch.equal(k.unpack(inputs[0]), k.plain_unpack(inputs[0]))
    assert k.unpack_launches == 1
    done = got.terminated | got.truncated
    assert 0 < int(done.sum()) < 4099


@pytest.mark.gpu
@pytest.mark.parametrize("board", ["default", "tall33"])
def test_cuda_default_engine_matches_cpu_through_game_overs(board, cuda_device):
    """The default engine on the card and on the CPU from one seed, from
    dense boards, with live deals and auto-reset: every timestep and the
    final state bit-equal, games ending, one tail launch a step and one
    unpack at init."""
    cfg = board_config(tcfg, board)
    n, steps = 512, 24
    cells = dense_cells(cfg, n, np.random.default_rng(6))
    runs, ended = [], 0
    for dev in (cuda_device, "cpu"):
        env = make_env(cfg, device=dev)
        state, ts = env.init(4, n)
        state = state.replace(board=env.encode_board(cells))
        mask = env.action_mask(state.board, state.queue)
        draw = UniformLegalSampler(5, n, env.device)
        trace = []
        for _ in range(steps):
            state, ts = env.step(state, draw(mask))
            mask = ts.action_mask
            trace.append([ts.board, ts.queue, ts.action_mask, ts.reward, ts.terminated,
                          ts.truncated, ts.info["final_board"], ts.info["episode_return"]])
        runs.append((env, state, trace))
    (eg, sg, tg), (_, sc, tc) = runs
    for t, (a, b) in enumerate(zip(tg, tc)):
        for x, y in zip(a, b):
            assert_same_bits(x.cpu().numpy(), y.numpy(), f"t={t}")
        ended += int(b[4].sum())
    for f in ("board", "queue", "rng_counter", "steps", "score", "streak"):
        assert_same_bits(getattr(sg, f).cpu().numpy(), getattr(sc, f).numpy(), f)
    assert ended > 0
    assert eg.packed_tail_kernel.launches == steps
    assert eg.packed_tail_kernel.unpack_launches == 1


def test_card_tests_take_the_gpu_marker():
    """Every test here that takes ``cuda_device`` is marked ``gpu``."""
    for name, fn in globals().items():
        if name.startswith("test_") and "cuda_device" in inspect.signature(fn).parameters:
            assert any(m.name == "gpu" for m in getattr(fn, "pytestmark", [])), name
