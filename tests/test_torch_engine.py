"""The port's engine on the CPU against the JAX engine.

Both engines get the same actions and the same injected deals (numpy, from
a seed).  The port's ``backend="pallas"`` is held against JAX's
``make_env(cfg, backend="pallas")``, whose kernels run in interpret mode
on the CPU (``big`` against the u8 jnp engine, which the JAX package holds
bit-equal to it); the port's u8 ``"jnp"`` and ``"hybrid"`` against JAX's
``make_env(cfg, state_impl="u8")``, the u8 jnp engine; the packed engine,
the default of both packages, against JAX's ``make_env(cfg,
state_impl="packed")`` and against the port's u8 engine (its kernels'
plain versions are held against the JAX helpers in
``test_torch_packed.py``).  Boards, queues, masks, flags, lines cleared,
legality and streaks are integers or bools and must be bit-equal.
Rewards are float32 and must be bit-equal too: they are small integer
sums, computed in the same order as the JAX step.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blockpuzzle_tpu import config as jcfg
from blockpuzzle_tpu.env import make_env as jax_make_env
from blockpuzzle_tpu_torch import config as tcfg
from blockpuzzle_tpu_torch.env import make_env
from blockpuzzle_tpu_torch.interop import state_from_numpy
from blockpuzzle_tpu_torch.sampler import UniformLegalSampler

N = 8
FIELDS = ("board", "queue", "action_mask", "reward", "terminated", "truncated")
INFO = ("lines_cleared", "legal", "episode_return", "episode_length")


def pick_actions(mask, rng, num_actions, wild=0.15):
    """Uniform-legal actions, with a share of arbitrary ones (illegal and
    out of range) mixed in."""
    n = mask.shape[0]
    a = np.zeros(n, np.int32)
    for e in range(n):
        legal = np.flatnonzero(mask[e])
        a[e] = rng.choice(legal) if legal.size else 0
    wild_rows = rng.random(n) < wild
    a[wild_rows] = rng.integers(-3, num_actions + 3, wild_rows.sum())
    return a


def assert_same(tj, tt, t, extra=("streak",)):
    for f in FIELDS:
        np.testing.assert_array_equal(
            tt.__dict__[f].numpy(), np.asarray(getattr(tj, f)), f"{f} t={t}")
    for k in INFO + extra:
        np.testing.assert_array_equal(
            tt.info[k].numpy(), np.asarray(tj.info[k]), f"{k} t={t}")


@functools.cache
def jax_u8_engine(preset, knobs=()):
    """JAX's ``make_env(cfg, state_impl="u8")`` (the u8 jnp engine) and its
    jitted step without auto-reset, built once per config (the port's
    backends reuse the compiled step)."""
    cfg = dataclasses.replace(jcfg.PRESETS[preset](), **dict(knobs))
    env_j = jax_make_env(cfg, state_impl="u8")
    step_j = jax.jit(lambda s, a, d: env_j.step(s, a, deal_override=d,
                                                auto_reset=False))
    return env_j, step_j


def run_lockstep(cfg_j, cfg_t, env_j, steps, seed, auto_reset=False,
                 backend="pallas", step_j=None):
    rng = np.random.default_rng(seed)
    env_t = make_env(cfg_t, device="cpu", backend=backend, state_impl="u8")
    num_pieces = env_t.num_pieces
    init = rng.integers(0, num_pieces, (N, cfg_t.queue_size)).astype(np.int32)
    sj, tj = env_j.init(jax.random.key(0), N, deal_override=jnp.asarray(init))
    st, tt = env_t.init(0, N, deal_override=init)
    assert_same(tj, tt, -1, extra=())
    if step_j is None:
        step_j = jax.jit(lambda s, a, d: env_j.step(s, a, deal_override=d,
                                                    auto_reset=auto_reset))
    for t in range(steps):
        a = pick_actions(np.asarray(tj.action_mask), rng, env_t.num_actions)
        d = rng.integers(0, num_pieces, (N, cfg_t.queue_size)).astype(np.int32)
        sj, tj = step_j(sj, jnp.asarray(a), jnp.asarray(d))
        st, tt = env_t.step(st, a, deal_override=d, auto_reset=auto_reset)
        yield t, sj, tj, st, tt


@pytest.mark.parametrize("preset", ["default", "tenten", "woodoku"])
def test_step_parity_with_pallas_engine(preset):
    cj, ct = jcfg.PRESETS[preset](), tcfg.PRESETS[preset]()
    env_j = jax_make_env(cj, backend="pallas")
    cleared = 0
    for t, sj, tj, st, tt in run_lockstep(cj, ct, env_j, 20, seed=1):
        assert_same(tj, tt, t)
        cleared += int(tt.info["lines_cleared"].sum())
        np.testing.assert_array_equal(st.board.numpy(), np.asarray(sj.board))
    assert cleared > 0


@pytest.mark.parametrize("backend", ["jnp", "hybrid"])
@pytest.mark.parametrize("preset", ["default", "tenten", "woodoku", "big"])
def test_step_parity_with_u8_jnp_engine(preset, backend):
    """The port's jnp/hybrid step (torch collision test + clear kernel)
    against the JAX u8 jnp step, whose clear is ``clear_scan``."""
    env_j, step_j = jax_u8_engine(preset)
    ct = tcfg.PRESETS[preset]()
    cleared = 0
    for t, sj, tj, st, tt in run_lockstep(env_j.cfg, ct, env_j, 20, seed=1,
                                          backend=backend, step_j=step_j):
        assert_same(tj, tt, t)
        cleared += int(tt.info["lines_cleared"].sum())
        np.testing.assert_array_equal(st.board.numpy(), np.asarray(sj.board))
    assert cleared > 0 or preset == "big"  # 20 steps fill no 16-cell line


def test_step_parity_big_with_u8_engine():
    cj, ct = jcfg.big_config(), tcfg.big_config()
    env_j = jax_make_env(cj, state_impl="u8")
    for t, sj, tj, st, tt in run_lockstep(cj, ct, env_j, 20, seed=2):
        assert_same(tj, tt, t)


KNOBS = {
    "default+knobs": {"streak_bonus": 5.0, "max_steps": 9,
                      "illegal_penalty": -1.0, "terminal_penalty": -5.0},
    "mini5-5x5+knobs": {"queue_size": 2, "refill_batch": True,
                        "piece_set": "mini5", "height": 5, "width": 5,
                        "streak_bonus": 3.0, "max_steps": 14,
                        "illegal_penalty": -0.5, "terminal_penalty": -2.0},
}


@pytest.mark.parametrize("knobs,backend", [
    pytest.param(KNOBS[name], backend, id=name + suffix)
    for backend, suffix in (("pallas", ""), ("jnp", "-jnp"))
    for name in KNOBS
])
def test_step_parity_reward_knobs(knobs, backend):
    """streak_bonus, max_steps, both penalties and out-of-range actions
    (pick_actions mixes them in), against the u8 jnp engine.  ``hybrid``
    runs the code of ``jnp`` and is left out here."""
    env_j, step_j = jax_u8_engine("default", tuple(sorted(knobs.items())))
    cj = env_j.cfg
    ct = dataclasses.replace(tcfg.default_config(), **knobs)
    seen = {"streak": 0, "trunc": 0, "illegal": 0}
    for t, sj, tj, st, tt in run_lockstep(cj, ct, env_j, 20, seed=3,
                                          backend=backend, step_j=step_j):
        assert_same(tj, tt, t)
        seen["streak"] = max(seen["streak"], int(tt.info["streak"].max()))
        seen["trunc"] += int(tt.truncated.sum())
        seen["illegal"] += int((~tt.info["legal"]).sum())
        np.testing.assert_array_equal(st.score.numpy(), np.asarray(sj.score))
    assert seen["trunc"] and seen["illegal"]
    # the 5x5 board clears often enough that the streak bonus pays
    assert seen["streak"] >= (2 if "piece_set" in knobs else 1)


@pytest.mark.parametrize("preset", ["default", "tenten", "woodoku", "big"])
def test_jnp_and_pallas_backends_agree_on_live_deals(preset):
    """The apply-kernel step and the clear-kernel step from one seed, with
    the port's own deals and auto-reset: every output bit-equal."""
    cfg = tcfg.PRESETS[preset]()
    envs = [make_env(cfg, device="cpu", backend=b, state_impl="u8")
            for b in ("pallas", "jnp")]
    runs = [list(e.init(3, 32)) + [UniformLegalSampler(4, 32, "cpu")] for e in envs]
    cleared = 0
    for t in range(60):
        for run, env in zip(runs, envs):
            run[0], run[1] = env.step(run[0], run[2](run[1].action_mask))
        (sa, ta, _), (sb, tb, _) = runs
        for f in ("board", "queue", "rng_counter", "steps", "score", "streak"):
            assert torch.equal(getattr(sa, f), getattr(sb, f)), (f, t)
        for f in FIELDS:
            assert torch.equal(getattr(ta, f), getattr(tb, f)), (f, t)
        for k in INFO + ("streak", "final_board", "final_queue", "final_action_mask"):
            assert torch.equal(ta.info[k], tb.info[k]), (k, t)
        cleared += int(ta.info["lines_cleared"].sum())
    assert cleared > 0 and int(runs[0][0].rng_counter[0]) == 61


def test_auto_reset_reinitializes_done_envs():
    """Twin of test_env_core.py::test_auto_reset_reinitializes_done_envs,
    on the port alone: the reset deals come from the port's own stream."""
    cfg = tcfg.default_config()
    env = make_env(cfg, device="cpu")
    state, ts = env.init(0, 4)
    board = np.zeros((4, cfg.num_cells), np.uint8)
    board[0, :] = 1
    board[0, 0] = 0
    board[0, 11] = 0
    queue = state.queue.clone()
    queue[0] = 10  # 3x3 square cannot fit
    state = state.replace(board=env.encode_board(board), queue=queue)
    state2, ts2 = env.step(state, torch.zeros(4, dtype=torch.int32))
    assert bool(ts2.terminated[0])
    assert int(state2.board[0].sum()) == 0
    assert int(state2.steps[0]) == 0
    assert int(state2.queue[0, 0]) < env.num_pieces
    assert bool(ts2.action_mask[0].any())
    assert int(state2.steps[1]) == 1
    # the final_* fields hold the pre-reset view of the finished env
    np.testing.assert_array_equal(ts2.info["final_board"][0].reshape(-1).numpy(),
                                  board[0])
    assert int(ts2.info["final_queue"][0, 0]) == 10
    assert not bool(ts2.info["final_action_mask"][0].any())
    np.testing.assert_array_equal(
        ts2.action_mask[0].numpy(),
        env._empty_board_mask(state2.queue[:1])[0].numpy())


def test_auto_reset_non_done_envs_match_jax():
    """With auto-reset on, finished envs redeal from each engine's own
    stream; every env that is not done must still equal JAX.  After each
    step the port's redealt hands are overwritten with JAX's, so the two
    stay in lockstep."""
    cj, ct = jcfg.default_config(), tcfg.default_config()
    env_j = jax_make_env(cj, backend="pallas")
    env_t = make_env(ct, device="cpu", backend="pallas")
    rng = np.random.default_rng(4)
    sj, tj = env_j.init(jax.random.key(0), N)
    st, tt = env_t.init(0, N, deal_override=np.array(sj.queue))
    step_j = jax.jit(lambda s, a, d: env_j.step(s, a, deal_override=d))
    dones = 0
    for t in range(40):
        a = pick_actions(np.asarray(tj.action_mask), rng, env_t.num_actions)
        d = rng.integers(0, env_t.num_pieces, (N, 1)).astype(np.int32)
        sj, tj = step_j(sj, jnp.asarray(a), jnp.asarray(d))
        st, tt = env_t.step(st, a, deal_override=d)
        done = np.array(tj.terminated | tj.truncated)
        live = ~done
        dones += int(done.sum())
        for f in ("board", "queue", "action_mask"):
            np.testing.assert_array_equal(
                tt.__dict__[f].numpy()[live], np.asarray(getattr(tj, f))[live],
                f"{f} t={t}")
        for f in ("reward", "terminated", "truncated"):
            np.testing.assert_array_equal(
                tt.__dict__[f].numpy(), np.asarray(getattr(tj, f)), f"{f} t={t}")
        for k in INFO + ("final_board", "final_queue", "final_action_mask"):
            np.testing.assert_array_equal(
                tt.info[k].numpy(), np.asarray(tj.info[k]), f"{k} t={t}")
        for f in ("board", "steps", "score", "streak", "rng_counter"):
            np.testing.assert_array_equal(
                getattr(st, f).numpy(), np.asarray(getattr(sj, f)), f"{f} t={t}")
        # finished envs: empty board, a fresh hand of the port's own stream
        assert int(st.board[torch.as_tensor(done)].sum()) == 0
        np.testing.assert_array_equal(
            tt.action_mask.numpy()[done],
            env_t._empty_board_mask(st.queue).numpy()[done])
        st = st.replace(queue=torch.tensor(np.array(sj.queue)))
    assert dones > 0


def test_state_from_numpy_carries_a_mid_game_state():
    """A JAX mid-game state, exported with np.asarray per field, steps the
    same in both engines."""
    cj, ct = jcfg.woodoku_config(), tcfg.woodoku_config()
    env_j = jax_make_env(cj, backend="pallas")
    env_t = make_env(ct, device="cpu", backend="pallas")
    rng = np.random.default_rng(5)
    sj, tj = env_j.init(jax.random.key(3), N)
    for _ in range(6):
        a = pick_actions(np.asarray(tj.action_mask), rng, env_t.num_actions, 0)
        sj, tj = env_j.step(sj, jnp.asarray(a), auto_reset=False)
    fields = {k: np.asarray(getattr(sj, k)) for k in
              ("board", "queue", "rng_counter", "steps", "score", "streak")}
    st = state_from_numpy(fields, ct, "cpu", seed=11)
    for k, v in fields.items():
        np.testing.assert_array_equal(getattr(st, k).numpy(), v)
    np.testing.assert_array_equal(
        env_t.action_mask(st.board, st.queue).numpy(), np.asarray(tj.action_mask))
    for t in range(6):
        a = pick_actions(np.asarray(tj.action_mask), rng, env_t.num_actions)
        d = rng.integers(0, env_t.num_pieces, (N, 3)).astype(np.int32)
        sj, tj = env_j.step(sj, jnp.asarray(a), deal_override=jnp.asarray(d),
                            auto_reset=False)
        st, tt = env_t.step(st, a, deal_override=d, auto_reset=False)
        assert_same(tj, tt, t)
    with pytest.raises(ValueError):
        state_from_numpy({**fields, "board": fields["board"][:, :10]}, ct,
                         "cpu", seed=0)


def test_partial_reset_and_reset():
    cfg = tcfg.tenten_config()
    env = make_env(cfg, device="cpu")
    state, ts = env.init(0, 6)
    rng = np.random.default_rng(6)
    for _ in range(4):
        a = pick_actions(ts.action_mask.numpy(), rng, env.num_actions, 0)
        state, ts = env.step(state, a)
    m = torch.tensor([True, False, True, False, False, True])
    new, ts2 = env.partial_reset(state, m)
    assert int(new.board[m].sum()) == 0 and bool((new.steps[m] == 0).all())
    for f in ("board", "queue", "steps", "score", "streak"):
        assert torch.equal(getattr(new, f)[~m], getattr(state, f)[~m]), f
    assert torch.equal(new.rng_counter, state.rng_counter + 1)
    assert torch.equal(ts2.action_mask, env.action_mask(new.board, new.queue))
    assert torch.equal(ts2.info["episode_length"], new.steps)
    full, ts3 = env.reset(new)
    assert int(full.board.sum()) == 0 and int(full.steps.sum()) == 0
    assert torch.equal(full.rng_counter, new.rng_counter + 1)
    assert torch.equal(ts3.action_mask, env._empty_board_mask(full.queue))
    # the tag-1 substream differs from the fused step's draw at one counter
    assert not torch.equal(full.queue, new.queue)


def test_empty_board_mask_matches_jax_init():
    for preset in ("default", "woodoku", "big"):
        cj, ct = jcfg.PRESETS[preset](), tcfg.PRESETS[preset]()
        env_j = jax_make_env(cj, state_impl="u8")
        env_t = make_env(ct, device="cpu", state_impl="u8")
        q = np.arange(N * ct.queue_size).reshape(N, -1) % (env_t.num_pieces + 1)
        _, tj = env_j.init(jax.random.key(0), N,
                           deal_override=jnp.asarray(q, jnp.int32))
        _, tt = env_t.init(0, N, deal_override=q)
        np.testing.assert_array_equal(tt.action_mask.numpy(),
                                      np.asarray(tj.action_mask))
        np.testing.assert_array_equal(
            env_t.action_mask(tt.board.reshape(N, -1), tt.queue).numpy(),
            np.asarray(tj.action_mask))


def test_encode_board_and_board_obs():
    cfg = tcfg.woodoku_config()
    env = make_env(cfg, device="cpu", state_impl="u8")
    cells = np.array([[0, 2, 1] + [0] * 78])
    b = env.encode_board(cells)
    assert b.dtype == torch.uint8 and b.tolist()[0][:3] == [0, 1, 1]
    assert env.board_obs(b).shape == (1, 9, 9)
    assert torch.equal(env.encode_board(env.board_obs(b)), b)


def test_make_env_accepts_only_the_ported_engine():
    """The JAX defaults (packed where rows fit a word and the backend is
    jnp), every backend on u8 boards, obs_planes, and the refusals."""
    env = make_env(device="cpu")
    assert (env.state_impl, env.backend) == ("packed", "jnp")
    for backend in ("pallas", "hybrid"):
        env = make_env(device="cpu", backend=backend)
        assert (env.state_impl, env.backend) == ("u8", backend)
    assert make_env(device="cpu", state_impl="u8").backend == "jnp"
    assert make_env(tcfg.EnvConfig(obs_planes=True), device="cpu").cfg.obs_planes
    with pytest.raises(ValueError):
        make_env(device="cpu", backend="nope")
    with pytest.raises(ValueError, match="backend"):
        make_env(device="cpu", backend="pallas", state_impl="packed")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_env()


# ------------------------------------------------------------------------
# the packed engine, the default of both packages
# ------------------------------------------------------------------------

PACKED_KNOBS = {"streak_bonus": 5.0, "max_steps": 9, "illegal_penalty": -1.0,
                "terminal_penalty": -5.0, "obs_planes": True}


@functools.cache
def jax_packed_engine(preset, knobs=()):
    """JAX's ``make_env(cfg, state_impl="packed")`` and its jitted step in
    parity mode with auto-reset."""
    cfg = dataclasses.replace(jcfg.PRESETS[preset](), **dict(knobs))
    env_j = jax_make_env(cfg, state_impl="packed")
    step_j = jax.jit(lambda s, a, d: env_j.step(s, a, deal_override=d))
    return env_j, step_j


@pytest.mark.parametrize("knobs", [False, True], ids=["plain", "knobs"])
@pytest.mark.parametrize("preset", ["default", "tenten", "woodoku", "big"])
def test_packed_engine_matches_jax_packed_engine(preset, knobs):
    """60 steps with injected deals and auto-reset, mixing uniform-legal,
    arbitrary (illegal, out-of-range) and raw-argmax actions, then a
    partial reset.  Finished envs redeal from each engine's own stream, so
    after each step the port's redealt hands are overwritten with JAX's;
    every field of an env that is not done, and every pre-reset field of
    one that is, must be equal.  ``knobs`` adds streak_bonus, max_steps,
    both penalties and piece planes."""
    env_j, step_j = jax_packed_engine(
        preset, tuple(sorted(PACKED_KNOBS.items())) if knobs else ())
    ct = dataclasses.replace(tcfg.PRESETS[preset](), **(PACKED_KNOBS if knobs else {}))
    env_t = make_env(ct, device="cpu")
    assert env_t.state_impl == env_j.state_impl == "packed"
    rng = np.random.default_rng(8)
    s, a_n = ct.queue_size, env_t.num_actions
    init = rng.integers(0, env_t.num_pieces, (N, s)).astype(np.int32)
    sj, tj = env_j.init(jax.random.key(0), N, deal_override=jnp.asarray(init))
    st, tt = env_t.init(0, N, deal_override=init)
    assert st.board.dtype == torch.int64 and st.board.shape == (N, ct.height)
    assert_same(tj, tt, -1, extra=())
    seen = {"cleared": 0, "illegal": 0, "done": 0, "trunc": 0}
    planes = ("piece_planes",) if knobs else ()
    for t in range(60):
        if t % 7 == 3:  # raw argmax ignores the mask: sometimes illegal
            a = rng.random((N, a_n)).argmax(axis=1).astype(np.int32)
        else:
            a = pick_actions(np.asarray(tj.action_mask), rng, a_n)
        d = rng.integers(0, env_t.num_pieces, (N, s)).astype(np.int32)
        sj, tj = step_j(sj, jnp.asarray(a), jnp.asarray(d))
        st, tt = env_t.step(st, a, deal_override=d)
        done = np.asarray(tj.done)
        live = ~done
        for f in ("board", "queue", "action_mask") + planes:
            np.testing.assert_array_equal(
                getattr(tt, f).numpy()[live], np.asarray(getattr(tj, f))[live],
                f"{f} t={t}")
        for f in ("reward", "terminated", "truncated"):
            np.testing.assert_array_equal(
                getattr(tt, f).numpy(), np.asarray(getattr(tj, f)), f"{f} t={t}")
        assert set(tt.info) == set(tj.info)
        for k in tj.info:
            np.testing.assert_array_equal(
                tt.info[k].numpy(), np.asarray(tj.info[k]), f"{k} t={t}")
        np.testing.assert_array_equal(
            st.board.numpy(), np.asarray(sj.board).astype(np.int64), f"words t={t}")
        for f in ("steps", "score", "streak", "rng_counter"):
            np.testing.assert_array_equal(
                getattr(st, f).numpy(), np.asarray(getattr(sj, f)), f"{f} t={t}")
        np.testing.assert_array_equal(
            tt.action_mask.numpy()[done],
            env_t._empty_board_mask(st.queue).numpy()[done])
        st = st.replace(queue=torch.tensor(np.array(sj.queue)))
        seen["cleared"] += int(tt.info["lines_cleared"].sum())
        seen["illegal"] += int((~tt.info["legal"]).sum())
        seen["done"] += int(done.sum())
        seen["trunc"] += int(tt.truncated.sum())
    assert seen["illegal"] and seen["done"]
    # max_steps = 9 ends every episode before a line fills on most presets
    assert seen["trunc"] if knobs else seen["cleared"] > 0 or preset == "big"
    m = np.arange(N) % 3 == 0
    pj, qj = jax.jit(env_j.partial_reset)(sj, jnp.asarray(m))
    pt, qt = env_t.partial_reset(st, torch.as_tensor(m))
    np.testing.assert_array_equal(pt.board.numpy(), np.asarray(pj.board).astype(np.int64))
    for f in ("steps", "score", "streak", "rng_counter"):
        np.testing.assert_array_equal(getattr(pt, f).numpy(), np.asarray(getattr(pj, f)))
    for f in ("board", "queue", "action_mask") + planes:
        np.testing.assert_array_equal(
            getattr(qt, f).numpy()[~m], np.asarray(getattr(qj, f))[~m], f)
    np.testing.assert_array_equal(  # the masked envs' mask on JAX's redeal
        env_t.action_mask(pt.board, torch.tensor(np.array(pj.queue))).numpy(),
        np.asarray(qj.action_mask))


@pytest.mark.parametrize("preset", ["default", "tenten", "woodoku", "big"])
def test_packed_and_u8_engines_agree_on_live_deals(preset):
    """The port's packed engine and its u8 engine from one seed, with the
    port's own deals and auto-reset: every timestep bit-equal."""
    cfg = dataclasses.replace(tcfg.PRESETS[preset](), obs_planes=True)
    envs = [make_env(cfg, device="cpu", state_impl=s) for s in ("packed", "u8")]
    runs = [list(e.init(3, 16)) + [UniformLegalSampler(4, 16, "cpu")] for e in envs]
    cleared = 0
    for t in range(60):
        for run, env in zip(runs, envs):
            run[0], run[1] = env.step(run[0], run[2](run[1].action_mask))
        (sp, tp, _), (su, tu, _) = runs
        assert torch.equal(envs[0].board_obs(sp.board), envs[1].board_obs(su.board))
        for f in ("queue", "rng_counter", "steps", "score", "streak"):
            assert torch.equal(getattr(sp, f), getattr(su, f)), (f, t)
        for f in FIELDS + ("piece_planes",):
            assert torch.equal(getattr(tp, f), getattr(tu, f)), (f, t)
        assert set(tp.info) == set(tu.info)
        for k in tu.info:
            assert torch.equal(tp.info[k], tu.info[k]), (k, t)
        cleared += int(tp.info["lines_cleared"].sum())
    assert cleared > 0
    assert torch.equal(envs[0].legal_all_pieces(runs[0][0].board),
                       envs[1].legal_all_pieces(runs[1][0].board))


@pytest.mark.parametrize("preset", ["default", "tenten", "woodoku", "big"])
def test_piece_planes_match_jax(preset):
    cj, ct = jcfg.PRESETS[preset](), tcfg.PRESETS[preset]()
    env_j, env_t = jax_make_env(cj), make_env(ct, device="cpu")
    q = np.arange(N * ct.queue_size).reshape(N, -1) % (env_t.num_pieces + 1)
    q = q.astype(np.int32)
    want = np.asarray(env_j.piece_planes(jnp.asarray(q)))
    got = env_t.piece_planes(torch.as_tensor(q))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    assert not want[q == env_t.num_pieces].any() and want.any()


def test_make_env_defaults_to_packed_bitboard():
    """Twin of test_env_core.py's, less ``mask_impl``: packed wherever
    rows fit a 32-bit word and the backend is jnp, u8 otherwise."""
    for name, preset in tcfg.PRESETS.items():
        env = make_env(preset(), device="cpu")
        assert env.state_impl == "packed", name
        state, _ = env.init(0, 4)
        assert state.board.shape == (4, env.cfg.height), name
        assert state.board.dtype == torch.int64, name
    wide = make_env(dataclasses.replace(tcfg.default_config(), width=33),
                    device="cpu")
    assert wide.state_impl == "u8" and wide.packed_mask_kernel is None
    assert make_env(device="cpu", backend="pallas").state_impl == "u8"
    assert make_env(device="cpu", backend="hybrid").state_impl == "u8"


def test_packed_state_validation():
    """Twin of test_env_core.py's, less ``mask_impl``."""
    with pytest.raises(ValueError, match="width <= 32"):
        make_env(dataclasses.replace(tcfg.default_config(), width=33),
                 device="cpu", state_impl="packed")
    with pytest.raises(ValueError, match="unknown state_impl"):
        make_env(tcfg.default_config(), device="cpu", state_impl="bogus")
    for backend in ("pallas", "hybrid"):
        with pytest.raises(ValueError, match="backend"):
            make_env(tcfg.default_config(), device="cpu", backend=backend,
                     state_impl="packed")


def test_encode_board_clamps_nonbinary_cells():
    """Twin of test_env_core.py's: any nonzero cell reads as occupied in
    both layouts, and the packed one gives JAX's words."""
    cj, ct = jcfg.default_config(), tcfg.default_config()
    rng = np.random.default_rng(0)
    cells = rng.integers(0, 2, (4, ct.num_cells)).astype(np.uint8)
    weird = cells * rng.integers(1, 200, cells.shape).astype(np.uint8)
    assert weird.max() > 1
    for impl in ("packed", "u8"):
        env = make_env(ct, device="cpu", state_impl=impl)
        np.testing.assert_array_equal(
            env.board_obs(env.encode_board(weird)).numpy(),
            cells.reshape(4, ct.height, ct.width), err_msg=impl)
    words = make_env(ct, device="cpu").encode_board(weird)
    want = jax_make_env(cj, state_impl="packed").encode_board(weird)
    np.testing.assert_array_equal(words.numpy(), np.asarray(want).astype(np.int64))


def test_state_from_numpy_carries_a_packed_state():
    """A JAX packed mid-game state (uint32 words) becomes the port's int64
    words and steps the same; the layout is named, never guessed."""
    cj, ct = jcfg.tenten_config(), tcfg.tenten_config()
    env_j, _ = jax_packed_engine("tenten")
    env_t = make_env(ct, device="cpu")
    rng = np.random.default_rng(9)
    sj, tj = env_j.init(jax.random.key(3), N)
    for _ in range(6):
        a = pick_actions(np.asarray(tj.action_mask), rng, env_t.num_actions, 0)
        sj, tj = env_j.step(sj, jnp.asarray(a), auto_reset=False)
    fields = {k: np.asarray(getattr(sj, k)) for k in
              ("board", "queue", "rng_counter", "steps", "score", "streak")}
    st = state_from_numpy(fields, ct, "cpu", seed=11, state_impl=env_t.state_impl)
    assert st.board.dtype == torch.int64
    np.testing.assert_array_equal(st.board.numpy(), fields["board"].astype(np.int64))
    for t in range(6):
        a = pick_actions(np.asarray(tj.action_mask), rng, env_t.num_actions)
        d = rng.integers(0, env_t.num_pieces, (N, 3)).astype(np.int32)
        sj, tj = env_j.step(sj, jnp.asarray(a), deal_override=jnp.asarray(d),
                            auto_reset=False)
        st, tt = env_t.step(st, a, deal_override=d, auto_reset=False)
        assert_same(tj, tt, t)
    with pytest.raises(ValueError, match="shape"):
        state_from_numpy(fields, ct, "cpu", seed=0)       # u8 by default
    with pytest.raises(ValueError, match="state_impl"):
        state_from_numpy(fields, ct, "cpu", seed=0, state_impl="bits")


def _jax_u8_fields(cj, steps=8):
    """The fields of a mid-game u8 state that the JAX engine made itself."""
    env_j = jax_make_env(cj, state_impl="u8")
    rng = np.random.default_rng(1)
    sj, tj = env_j.init(jax.random.key(2), N)
    for _ in range(steps):
        a = pick_actions(np.asarray(tj.action_mask), rng, env_j.num_actions, 0)
        sj, tj = env_j.step(sj, jnp.asarray(a), auto_reset=False)
    return {k: np.asarray(getattr(sj, k)) for k in
            ("board", "queue", "rng_counter", "steps", "score", "streak")}


@pytest.mark.parametrize("bad", [2, 255])
def test_state_from_numpy_refuses_a_u8_cell_outside_0_and_1(bad):
    """The bit-row kernels read a cell as "nonzero" and write 0/1 cells; the
    JAX kernels sum bytes.  On a row of eight 1s, one 2 and one 0 they
    differ, so such a board does not enter the engine."""
    cj, ct = jcfg.default_config(), tcfg.default_config()
    fields = _jax_u8_fields(cj)
    board = fields["board"].copy()
    board[3, : ct.width] = [1] * 8 + [bad, 0]
    with pytest.raises(ValueError, match="neither 0 nor 1"):
        state_from_numpy({**fields, "board": board}, ct, "cpu", seed=0, state_impl="u8")
    # the packed layout's words are not cells: any uint32 passes
    words = np.full((N, ct.height), bad, np.uint32)
    state_from_numpy({**fields, "board": words}, ct, "cpu", seed=0, state_impl="packed")


@pytest.mark.parametrize("preset", ["default", "woodoku"])
def test_state_from_numpy_accepts_the_jax_engines_own_u8_state(preset):
    cj, ct = jcfg.PRESETS[preset](), tcfg.PRESETS[preset]()
    fields = _jax_u8_fields(cj)
    assert fields["board"].dtype == np.uint8 and fields["board"].max() == 1
    st = state_from_numpy(fields, ct, "cpu", seed=0, state_impl="u8")
    np.testing.assert_array_equal(st.board.numpy(), fields["board"])
