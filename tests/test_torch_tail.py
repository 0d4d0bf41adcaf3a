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
block logic (tiles of envs, the legal and done flags in shared memory, the
mask read as 16-byte vectors with its unaligned head and tail byte by byte,
the flat spans of the outputs) is held bit-equal to the plain version on
those boards, at the wrapper's tile and at a tile of 7 envs (tiles' spans
off a 16-byte boundary), on batches that are no multiple of the tile;
the unpack likewise, and ``board_obs`` of a CPU engine equals JAX's
``_unpack_board`` on every packed shape.  Floats are compared bit for bit.

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
from blockpuzzle_tpu_torch.kernels.packed import U32, pack_words, unpack_words
from blockpuzzle_tpu_torch.kernels.tail import (
    MAX_TILE,
    SMEM_LIMIT,
    Tail,
    tail_block_envs,
    tail_plain,
    tail_smem_bytes,
)
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


def _div(q, d):
    """The kernel's q / d (``bit_rows::small_div``: q < 2^21)."""
    from test_torch_packed import _small_div

    assert 0 <= q < 1 << 21
    return int(_small_div(q, d))


def emulate_packed_tail(cfg, inputs, auto_reset, envs, table):
    """csrc/packed_tail.cu ``packed_tail_kernel``, block by block: a tile of
    ``envs`` envs, its rows staged as 32-bit words cut to W columns; the
    tile's mask span read as 16-byte vectors from the first boundary at or
    past its start (the mask starts on one), the bytes before and after one
    by one, every nonzero byte setting its env's legal flag; one thread an
    env for the flags, scalars and the done flag; then the mask output
    vector by vector (a done env's bytes from its reset slots' table rows),
    the final board and the board view by ``store_span`` (the done envs'
    rows zeroed for the latter) and the int64 words.  Every output byte is
    written once.  Returns a ``Tail`` of numpy arrays (None where the
    kernel writes nothing)."""
    from test_torch_kernels import emulate_store_span

    words, mask, reward, queue3, reset, steps, score, streak, counter = (
        x.numpy() for x in inputs)
    n, h = words.shape
    w, s = cfg.width, cfg.queue_size
    hw, span = h * w, s * h * w
    num_pieces = table.shape[0] - 1
    keep = (1 << w) - 1
    flat_mask = mask.reshape(-1).astype(np.uint8)
    table = table.reshape(-1).astype(np.uint8)
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
    for first in range(0, n, envs):
        count = min(envs, n - first)
        rows = (words[first : first + count].reshape(-1) & U32) & keep
        legal = np.zeros(count, bool)
        lo, nbytes = first * span, count * span
        head = min((16 - lo % 16) % 16, nbytes)
        nvec = (nbytes - head) // 16
        for v in range(nvec):
            q = head + 16 * v
            assert (lo + q) % 16 == 0                 # the uint4 load's alignment
            x = flat_mask[lo + q : lo + q + 16]
            if not x.any():
                continue
            e0 = _div(q, span)
            if e0 == _div(q + 15, span):
                legal[e0] = True
                continue
            for j in np.flatnonzero(x):
                legal[_div(q + int(j), span)] = True
        for j in range(nbytes - 16 * nvec):
            q = j if j < head else j + 16 * nvec
            if flat_mask[lo + q]:
                legal[_div(q, span)] = True
        done = np.zeros(count, bool)
        pidx = np.zeros((count, s), np.int64)
        for e in range(count):
            env = first + e
            term = not legal[e]
            r = np.float32(reward[env] + np.float32(cfg.terminal_penalty)) if term \
                else reward[env]
            st = (int(steps[env]) + 1 + 2**31) % 2**32 - 2**31
            trunc = cfg.max_steps > 0 and st >= cfg.max_steps
            d = term or trunc
            sc = np.float32(score[env] + r)
            out["terminated"][env], out["truncated"][env] = term, trunc
            out["reward"][env], out["score_next"][env] = r, sc
            out["steps_next"][env] = st
            out["rng_counter"][env] = (int(counter[env]) + 1 + 2**31) % 2**32 - 2**31
            done[e] = d
            if auto_reset:
                out["steps_out"][env] = 0 if d else st
                out["score_out"][env] = np.float32(0.0) if d else sc
                out["streak_out"][env] = 0 if d else streak[env]
                for k in range(s):
                    fresh = int(reset[env, k])
                    out["queue_out"][env * s + k] = fresh if d else queue3[env, k]
                    pidx[e, k] = fresh if 0 <= fresh < num_pieces else num_pieces

        def table_byte(e, at):
            k = _div(at, hw)
            return table[pidx[e, k] * hw + at - k * hw]

        if auto_reset:
            o = out["mask_out"]
            for v in range(nvec):
                q = head + 16 * v
                x = flat_mask[lo + q : lo + q + 16].copy()
                e0 = _div(q, span)
                if e0 != _div(q + 15, span) or done[e0]:
                    for j in range(16):
                        e = _div(q + j, span)
                        if done[e]:
                            x[j] = table_byte(e, q + j - e * span)
                assert (o[lo + q : lo + q + 16] == 2).all()
                o[lo + q : lo + q + 16] = x
            for j in range(nbytes - 16 * nvec):
                q = j if j < head else j + 16 * nvec
                e = _div(q, span)
                assert o[lo + q] == 2
                o[lo + q] = table_byte(e, q - e * span) if done[e] else flat_mask[lo + q]
            emulate_store_span(rows, out["final_board"], first * hw, count * hw, w)
            for i in range(count * h):
                out["board_out"][first * h + i] = 0 if done[_div(i, h)] else words.reshape(
                    -1)[first * h + i]
            rows = np.where(np.repeat(done, h), 0, rows)
        emulate_store_span(rows, out["board"], first * hw, count * hw, w)
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


@pytest.mark.parametrize("tile", ["wrapper", 7])
@pytest.mark.parametrize("auto_reset", [True, False], ids=["auto_reset", "no_reset"])
@pytest.mark.parametrize("board", BOARDS)
def test_emulated_tail_kernel_matches_plain(board, auto_reset, tile):
    """The kernel's block logic, in numpy, bit-equal to the plain tail on
    dense boards with ``max_steps`` and a terminal penalty that rounds, on
    two tiles and a bit more: at the wrapper's tile (128 envs on 10x10 and
    tenten, 118 on 33x9, 31 on 130x8) and at 7 envs, whose spans start off
    a 16-byte boundary (on 130x8 an env's 1040 mask bytes are 65 vectors);
    ids outside [0, P] in the hand and the reset deals, counters at
    2**31 - 1."""
    cfg = board_config(tcfg, board, (("max_steps", 9), ("terminal_penalty", -0.3)))
    k = PackedTailKernel(cfg, "cpu")
    envs = k.envs if tile == "wrapper" else tile
    n = 2 * envs + 37
    rng = np.random.default_rng(envs)
    inputs = tail_inputs(cfg, n, rng)
    want = k(*inputs, auto_reset)
    got = emulate_packed_tail(cfg, inputs, auto_reset, envs, k.empty_legal.numpy())
    for i, (field, g, w) in enumerate(zip(Tail._fields, got, want)):
        if g is None:  # without auto-reset the kernel writes the first seven
            assert not auto_reset and i >= 7, field
        else:
            assert_same_bits(g, w.numpy(), f"{field}, {board}, tile {envs}")
    done = want.terminated | want.truncated
    assert 0 < int(want.terminated.sum()) < n and 0 < int(done.sum()) < n
    span = cfg.queue_size * cfg.num_cells
    if tile == 7:  # spans off a boundary but where an env's span is 16-byte whole
        assert any(first * span % 16 for first in range(0, n, envs)) == bool(span % 16)


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
    n = 2 * env_t.packed_tail_kernel.envs + 5
    words = torch.as_tensor(rng.integers(0, 1 << cfg.width, (n, cfg.height)))
    want = np.asarray(env_j._unpack_board(jnp.asarray(words.numpy().astype(np.uint32))))
    got = env_t.board_obs(words)
    assert got.dtype == torch.uint8 and got.shape == (n, cfg.height, cfg.width)
    np.testing.assert_array_equal(got.numpy(), want)
    for envs in (env_t.packed_tail_kernel.envs, 7):
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


@pytest.mark.parametrize("height", [10, 33, 130, 1000, 3000])
def test_tail_tile_fits_the_kernel(height):
    """The wrapper's tile fits the shared memory of a plain launch and keeps
    the kernel's divisions in range (csrc/packed_tail.cu ``tile_fits``):
    the tile's mask span and row words under 2^21, its board bytes times W
    under 2^32; 128 envs on the presets."""
    for width, s in ((32, 3), (9, 1)):
        cfg = tcfg.EnvConfig(height=height, width=width, queue_size=s)
        envs = tail_block_envs(cfg)
        assert 1 <= envs <= MAX_TILE
        assert tail_smem_bytes(cfg, envs) <= SMEM_LIMIT
        hw = height * width
        assert envs * s * hw < 1 << 21 and envs * height < 1 << 21
        assert envs * hw * width < 1 << 32
    for name in ("default", "tenten", "woodoku", "big"):
        assert tail_block_envs(tcfg.PRESETS[name]()) == MAX_TILE


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
