"""The port's Gymnasium surface (``blockpuzzle_tpu_torch/vector_env.py``)
and the autoreset env under it (``env/autoreset.py``), on the CPU.

The first part twins ``tests/test_vector_env.py`` test by test on the
port's adapter and ids (``BlockPuzzleTpuTorch/...``).  Then the two
combines are held bit-equal to the JAX adapter's on states stepped with the
same actions and injected deals, the single-env id plays JAX's oracle
episode, and the autoreset env runs on a card against the CPU (``gpu``).

gymnasium and JAX are imported inside the tests, so the ``gpu`` test runs
on a machine without either: ``python -m pytest --noconftest -m gpu
tests/test_torch_vector_env.py``.
"""

import numpy as np
import pytest
import torch

from blockpuzzle_tpu_torch import PRESETS, make_env
from blockpuzzle_tpu_torch.config import default_config, tenten_config
from blockpuzzle_tpu_torch.env.autoreset import (
    MODES,
    AutoresetEnv,
    disabled_combine,
    next_step_combine,
    raw_from_ts,
    to_host,
)
from blockpuzzle_tpu_torch.interop import state_from_numpy
from blockpuzzle_tpu_torch.sampler import WordsSampler

ID = "BlockPuzzleTpuTorch/BlockPuzzle-v0"
STATE_FIELDS = ("board", "queue", "rng_counter", "steps", "score", "streak")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the CPU has only the plain versions)")
    return torch.device("cuda")


def gym():
    """gymnasium, with the port's ids registered."""
    import gymnasium

    import blockpuzzle_tpu_torch.vector_env  # noqa: F401 (registers the ids)

    return gymnasium


def VecEnv(**kwargs):
    from blockpuzzle_tpu_torch.vector_env import BlockPuzzleVectorEnv

    return BlockPuzzleVectorEnv(device="cpu", **kwargs)


def from_jax(x) -> torch.Tensor:
    """A torch copy of a JAX (or numpy) array."""
    return torch.tensor(np.asarray(x))


def _legal_actions(mask, rng):
    return np.array(
        [rng.choice(np.flatnonzero(m)) if m.any() else 0 for m in mask],
        dtype=np.int64,
    )


# ----------------------------------------- twins of tests/test_vector_env.py


def test_make_vec_registered():
    from blockpuzzle_tpu_torch.vector_env import BlockPuzzleVectorEnv

    env = gym().make_vec(ID, num_envs=8, device="cpu")
    assert isinstance(env.unwrapped, BlockPuzzleVectorEnv)
    obs, infos = env.reset(seed=0)
    assert obs["board"].shape == (8, 10, 10)
    assert infos["action_mask"].shape == (8, 100)
    env.close()


def test_vector_step_and_masking():
    env = VecEnv(num_envs=16, cfg=default_config())
    obs, infos = env.reset(seed=1)
    rng = np.random.default_rng(0)
    for _ in range(20):
        mask = infos["action_mask"]
        actions = np.array(
            [rng.choice(np.flatnonzero(m)) for m in mask], dtype=np.int64
        )
        obs, rewards, term, trunc, infos = env.step(actions)
        assert rewards.shape == (16,)
        assert (rewards > 0).all()  # legal actions always reward
    env.close()


def test_vector_autoreset_final_observation():
    env = VecEnv(num_envs=32, cfg=default_config())
    obs, infos = env.reset(seed=2)
    rng = np.random.default_rng(1)
    saw_done = False
    for _ in range(120):
        actions = _legal_actions(infos["action_mask"], rng)
        obs, rewards, term, trunc, infos = env.step(actions)
        done = term | trunc
        if done.any():
            saw_done = True
            assert "final_board" in infos
            i = int(np.flatnonzero(done)[0])
            # live obs for the done env is a fresh (empty) board...
            assert obs["board"][i].sum() == 0
            # ...while the final board is the dead position (non-empty)
            assert infos["final_board"][i].sum() > 0
            np.testing.assert_array_equal(infos["_final_board"], done)
            np.testing.assert_array_equal(infos["final_obs"]["board"],
                                          infos["final_board"])
            break
    assert saw_done, "no episode finished in 120 steps"
    env.close()


def test_vector_env_spaces_batched():
    env = VecEnv(num_envs=4, cfg=tenten_config())
    assert env.single_action_space.n == 300
    assert env.action_space.shape == (4,)
    obs, infos = env.reset(seed=0)
    assert obs["queue"].shape == (4, 3)
    assert env.observation_space.contains(obs)
    env.close()


def test_vector_render_rgb():
    env = VecEnv(num_envs=4, render_mode="rgb_array")
    env.reset(seed=0)
    img = env.render()
    assert img is not None and img.ndim == 3 and img.dtype == np.uint8
    env.close()


def test_vector_reset_options_override_state():
    env = VecEnv(num_envs=4, cfg=default_config())
    boards = np.zeros((4, 10, 10), dtype=np.uint8)
    boards[:, 0, :9] = 1
    queues = np.zeros((4, 1), dtype=np.int32)  # piece 0 = 1x1
    obs, infos = env.reset(seed=0, options={"board": boards, "queue": queues})
    np.testing.assert_array_equal(obs["board"], boards)
    np.testing.assert_array_equal(obs["queue"], queues)
    # the recomputed mask must forbid the occupied cells
    assert not infos["action_mask"][:, :9].any()
    # completing row 0 clears it in every env
    obs, rewards, term, trunc, infos = env.step(np.full(4, 9))
    assert (infos["lines_cleared"] == 1).all()
    assert (obs["board"][:, 0].sum(axis=-1) == 0).all()
    env.close()


def test_vector_next_step_autoreset_semantics():
    """NEXT_STEP: terminal step shows the FINAL obs; the following step
    ignores the action and presents the reset obs with reward 0."""
    env = VecEnv(num_envs=32, cfg=default_config(), autoreset_mode="next_step")
    assert env.metadata["autoreset_mode"] is gym().vector.AutoresetMode.NEXT_STEP
    obs, infos = env.reset(seed=4)
    rng = np.random.default_rng(3)
    for _ in range(200):
        actions = _legal_actions(infos["action_mask"], rng)
        obs, rewards, term, trunc, infos = env.step(actions)
        done = term | trunc
        if done.any():
            break
    assert done.any(), "no episode finished in 200 steps"
    i = int(np.flatnonzero(done)[0])
    # terminal step: the presented obs is the DEAD position, not a reset
    assert obs["board"][i].sum() > 0
    assert not infos["action_mask"][i].any()  # final mask: nothing legal
    # following step: action ignored (use an arbitrary id), env resets
    actions = _legal_actions(infos["action_mask"], rng)
    actions[i] = 0  # whatever: must be ignored for the resetting env
    obs2, rewards2, term2, trunc2, infos2 = env.step(actions)
    assert rewards2[i] == 0.0
    assert not term2[i] and not trunc2[i]
    assert obs2["board"][i].sum() == 0  # reset obs: empty board
    assert infos2["action_mask"][i].any()
    assert infos2["episode_return"][i] == 0.0
    # the step after that: the env plays normally from the reset state
    actions = _legal_actions(infos2["action_mask"], rng)
    obs3, rewards3, term3, trunc3, infos3 = env.step(actions)
    assert rewards3[i] > 0.0  # legal placement rewards
    env.close()


def test_vector_next_step_ignored_action_does_not_advance_rng():
    """The discarded transition of a resetting env must not consume RNG:
    two NEXT_STEP runs that differ only in the ignored action converge to
    identical queues afterwards."""
    outs = []
    for junk_action in (0, 7):
        env = VecEnv(num_envs=16, cfg=default_config(), autoreset_mode="next_step")
        obs, infos = env.reset(seed=11)
        rng = np.random.default_rng(5)
        done = np.zeros(16, dtype=bool)
        for _ in range(200):
            actions = _legal_actions(infos["action_mask"], rng)
            obs, rewards, term, trunc, infos = env.step(actions)
            done = term | trunc
            if done.any():
                break
        assert done.any()
        i = int(np.flatnonzero(done)[0])
        actions = _legal_actions(infos["action_mask"], rng)
        actions[i] = junk_action
        obs, rewards, term, trunc, infos = env.step(actions)
        outs.append((obs["queue"][i].copy(), obs["board"][i].copy()))
        env.close()
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    np.testing.assert_array_equal(outs[0][1], outs[1][1])


def test_vector_disabled_autoreset_and_partial_reset():
    env = VecEnv(num_envs=32, cfg=default_config(), autoreset_mode="disabled")
    obs, infos = env.reset(seed=6)
    rng = np.random.default_rng(7)
    for _ in range(200):
        actions = _legal_actions(infos["action_mask"], rng)
        obs, rewards, term, trunc, infos = env.step(actions)
        done = term | trunc
        if done.any():
            break
    assert done.any(), "no episode finished in 200 steps"
    i = int(np.flatnonzero(done)[0])
    dead_board = obs["board"][i].copy()
    assert dead_board.sum() > 0
    # no auto-reset: stepping again leaves the env terminal and unchanged
    actions = _legal_actions(infos["action_mask"], rng)
    obs2, rewards2, term2, trunc2, infos2 = env.step(actions)
    assert term2[i]
    assert rewards2[i] == 0.0  # illegal no-op (default penalty 0)
    np.testing.assert_array_equal(obs2["board"][i], dead_board)
    # partial reset: ONLY the flagged env resets
    j = int(np.flatnonzero(~done)[0])
    before_j = obs2["board"][j].copy()
    queue_j = obs2["queue"][j].copy()
    mask = np.zeros(32, dtype=bool)
    mask[i] = True
    obs3, infos3 = env.reset(options={"reset_mask": mask})
    assert obs3["board"][i].sum() == 0
    assert infos3["action_mask"][i].any()
    np.testing.assert_array_equal(obs3["board"][j], before_j)
    np.testing.assert_array_equal(obs3["queue"][j], queue_j)
    # the reset env steps normally again
    actions = _legal_actions(infos3["action_mask"], rng)
    obs4, rewards4, term4, trunc4, infos4 = env.step(actions)
    assert rewards4[i] > 0.0 and not term4[i]
    env.close()


def test_vector_disabled_freezes_dead_envs():
    """A dead env's step is a bit-exact no-op: no penalty re-application,
    no stat drift, sticky death flags."""
    env = VecEnv(num_envs=32, autoreset_mode="disabled",
                 terminal_penalty=-50.0, illegal_penalty=-1.0)
    obs, infos = env.reset(seed=6)
    rng = np.random.default_rng(7)
    done = np.zeros(32, dtype=bool)
    for _ in range(200):
        actions = _legal_actions(infos["action_mask"], rng)
        obs, rewards, term, trunc, infos = env.step(actions)
        done = term | trunc
        if done.any():
            break
    assert done.any(), "no episode finished in 200 steps"
    i = int(np.flatnonzero(done)[0])
    dead_board = obs["board"][i].copy()
    dead_queue = obs["queue"][i].copy()
    dead_return = infos["episode_return"][i]
    dead_streak = infos["streak"][i]
    for _ in range(3):
        actions = _legal_actions(infos["action_mask"], rng)
        obs, rewards, term, trunc, infos = env.step(actions)
        assert rewards[i] == 0.0  # NOT illegal_penalty + terminal_penalty
        assert term[i] and not trunc[i]  # sticky death flags
        assert infos["episode_return"][i] == dead_return  # no drift
        assert infos["streak"][i] == dead_streak
        assert infos["lines_cleared"][i] == 0
        np.testing.assert_array_equal(obs["board"][i], dead_board)
        np.testing.assert_array_equal(obs["queue"][i], dead_queue)
    # reset_mask revives it
    mask = np.zeros(32, dtype=bool)
    mask[i] = True
    obs, infos = env.reset(options={"reset_mask": mask})
    actions = _legal_actions(infos["action_mask"], rng)
    obs, rewards, term, trunc, infos = env.step(actions)
    assert rewards[i] > 0.0 and not term[i]
    env.close()


def test_vector_disabled_freezes_truncated_envs():
    """Truncated (not terminated) dead envs freeze too: their mask is not
    empty, so without the freeze they would keep placing pieces."""
    env = VecEnv(num_envs=8, autoreset_mode="disabled", max_steps=5)
    obs, infos = env.reset(seed=3)
    rng = np.random.default_rng(3)
    for _ in range(5):
        actions = _legal_actions(infos["action_mask"], rng)
        obs, rewards, term, trunc, infos = env.step(actions)
    assert trunc.all()
    frozen_board = obs["board"].copy()
    frozen_term = term.copy()
    for _ in range(3):
        actions = _legal_actions(infos["action_mask"], rng)
        obs, rewards, term, trunc, infos = env.step(actions)
        assert trunc.all()
        np.testing.assert_array_equal(term, frozen_term)
        assert (rewards == 0.0).all()
        np.testing.assert_array_equal(obs["board"], frozen_board)
    env.close()


def test_vector_next_step_gymnasium_wrapper_interop():
    """gymnasium's own vector wrappers consume the NEXT_STEP convention."""
    from gymnasium.wrappers.vector import RecordEpisodeStatistics

    env = gym().make_vec(ID, num_envs=16, autoreset_mode="next_step", device="cpu")
    env = RecordEpisodeStatistics(env)
    obs, infos = env.reset(seed=0)
    rng = np.random.default_rng(0)
    finished = 0
    for _ in range(300):
        actions = _legal_actions(infos["action_mask"], rng)
        obs, rew, term, trunc, infos = env.step(actions)
        if "episode" in infos:
            finished += int(np.asarray(infos["_episode"]).sum())
    assert finished > 0
    env.close()


def test_vector_partial_reset_option_validation():
    env = VecEnv(num_envs=4, cfg=default_config(), autoreset_mode="disabled")
    with pytest.raises(RuntimeError):
        env.reset(options={"reset_mask": np.ones(4, bool)})  # before reset()
    env.reset(seed=0)
    with pytest.raises(ValueError):
        env.reset(options={"reset_mask": np.ones(3, bool)})  # wrong shape
    with pytest.raises(ValueError):
        env.reset(seed=1, options={"reset_mask": np.ones(4, bool)})
    with pytest.raises(ValueError):
        env.reset(options={"reset_mask": np.ones(4, bool), "queue": None})
    env.close()


def test_make_vec_accepts_autoreset_mode():
    env = gym().make_vec(ID, num_envs=4, autoreset_mode="next_step", device="cpu")
    assert env.unwrapped.autoreset_mode is gym().vector.AutoresetMode.NEXT_STEP
    env.reset(seed=0)
    env.close()


def test_vector_autoreset_mode_rejects_unknown():
    with pytest.raises(ValueError):
        VecEnv(num_envs=2, autoreset_mode="sometimes")
    with pytest.raises(TypeError):
        VecEnv(num_envs=2, autoreset_mode=1)


def test_vector_reset_options_rejects_unknown():
    env = VecEnv(num_envs=2, cfg=default_config())
    with pytest.raises(ValueError):
        env.reset(seed=0, options={"bogus": 1})
    env.close()


def test_vector_reset_options_rejects_bad_board():
    env = VecEnv(num_envs=2, cfg=default_config())
    # wrong shape: a transposed/flattened array must not be silently
    # reinterpreted by a bare reshape
    with pytest.raises(ValueError):
        env.reset(seed=0, options={"board": np.zeros((100, 2), np.uint8)})
    # non-binary cells
    with pytest.raises(ValueError):
        env.reset(seed=0, options={"board": np.full((2, 10, 10), 2, np.uint8)})
    # flat (N, H*W) remains accepted
    obs, infos = env.reset(seed=0, options={"board": np.zeros((2, 100), np.uint8)})
    assert obs["board"].shape == (2, 10, 10)
    env.close()


# ------------------------------------------------- beyond the JAX twins ----


def test_vector_obs_planes_and_final_obs():
    """With ``obs_planes`` the spaces, the observations and SAME_STEP's
    batched ``final_obs`` carry the piece planes."""
    env = VecEnv(num_envs=16, cfg=tenten_config(), obs_planes=True, max_steps=6)
    obs, infos = env.reset(seed=0)
    assert obs["piece_planes"].shape == (16, 3, 10, 10)
    assert env.observation_space.contains(obs)
    rng = np.random.default_rng(0)
    for _ in range(6):
        obs, rewards, term, trunc, infos = env.step(_legal_actions(infos["action_mask"], rng))
    assert trunc.all()
    assert infos["final_obs"]["piece_planes"].shape == (16, 3, 10, 10)
    assert infos["final_obs"]["board"].sum() > 0 and obs["board"].sum() == 0
    env.close()


def test_vector_next_step_reset_mask_ends_the_pending_reset():
    """Under NEXT_STEP a ``reset_mask`` of an env that just finished resets
    it at once: its next action is played, not ignored."""
    env = VecEnv(num_envs=32, autoreset_mode="next_step")
    obs, infos = env.reset(seed=4)
    rng = np.random.default_rng(3)
    for _ in range(200):
        obs, rewards, term, trunc, infos = env.step(
            _legal_actions(infos["action_mask"], rng))
        if (term | trunc).any():
            break
    i = int(np.flatnonzero(term | trunc)[0])
    mask = np.zeros(32, dtype=bool)
    mask[i] = True
    obs, infos = env.reset(options={"reset_mask": mask})
    assert obs["board"][i].sum() == 0 and infos["action_mask"][i].any()
    obs, rewards, term, trunc, infos = env.step(_legal_actions(infos["action_mask"], rng))
    assert rewards[i] > 0.0 and obs["board"][i].sum() > 0
    env.close()


def test_autoreset_env_validation_and_unseeded_reset():
    engine = make_env(default_config(), device="cpu")
    with pytest.raises(ValueError, match="mode"):
        AutoresetEnv(engine, 4, "sometimes")
    auto = AutoresetEnv(engine, 64)
    with pytest.raises(RuntimeError):
        auto.step(np.zeros(64))
    # gymnasium's convention: an unseeded reset draws fresh entropy
    first = auto.reset()["queue"].clone()
    assert not torch.equal(first, auto.reset()["queue"])
    assert torch.equal(auto.reset(seed=3)["queue"], auto.reset(seed=3)["queue"])
    auto.close()
    with pytest.raises(RuntimeError):
        auto.step(np.zeros(64))


COMBINE_CASES = {"default": {}, "tenten": dict(max_steps=25, obs_planes=True,
                                               terminal_penalty=-5.0, streak_bonus=2.0)}


@pytest.mark.parametrize("mode", ["next_step", "disabled"])
@pytest.mark.parametrize("preset", list(COMBINE_CASES))
def test_combines_match_jax(preset, mode):
    """The port's ``next_step_combine`` / ``disabled_combine`` against the
    JAX adapter's ``_next_step_combine`` / ``_disabled_combine`` over 96
    steps: both engines step with the same actions and injected deals, and
    each combine's every output field must be bit-equal.  JAX's auto-reset
    and ``partial_reset`` deal from bits the port cannot make, so the
    port's re-dealt hands are overwritten with JAX's after each step, and
    under ``disabled`` the JAX state is carried across with
    ``state_from_numpy`` after the ``reset_mask`` of the dead envs every 8
    steps."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from blockpuzzle_tpu import config as jcfg
    from blockpuzzle_tpu.vector_env import BlockPuzzleVectorEnv as JaxVecEnv

    knobs = COMBINE_CASES[preset]
    cfg_t = dataclasses.replace(PRESETS[preset](), **knobs)
    n = 16
    jenv = JaxVecEnv(num_envs=n, cfg=dataclasses.replace(jcfg.PRESETS[preset](), **knobs),
                     autoreset_mode=mode)
    env_j, auto = jenv.engine, mode == "next_step"
    assert env_j.state_impl == "packed"
    step_j = jax.jit(lambda s, a, d: env_j.step(s, a, deal_override=d, auto_reset=auto))
    combine_j = jax.jit(jenv._next_step_combine if auto else jenv._disabled_combine)
    reset_j = jax.jit(env_j.partial_reset)
    env_t = make_env(cfg_t, device="cpu")
    rng = np.random.default_rng(9)
    s = cfg_t.queue_size
    init = rng.integers(0, env_t.num_pieces, (n, s)).astype(np.int32)
    sj, tj = env_j.init(jax.random.key(0), n, deal_override=jnp.asarray(init))
    st, tt = env_t.init(0, n, deal_override=init)
    raw_j, raw_t = jenv._raw_from_ts(tj), raw_from_ts(tt)
    zeros_j, zeros_t = jnp.zeros(n, bool), torch.zeros(n, dtype=torch.bool)
    carry_j, carry_t = (zeros_j,) * (1 if auto else 3), (zeros_t,) * (1 if auto else 3)

    def same(a, b, what):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a).astype(b.numpy().dtype),
                                      what)

    ended = 0
    for t in range(96):
        a = _legal_actions(np.asarray(raw_j["mask"]), rng).astype(np.int32)
        d = rng.integers(0, env_t.num_pieces, (n, s)).astype(np.int32)
        nsj, ntj = step_j(sj, jnp.asarray(a), jnp.asarray(d))
        nst, ntt = env_t.step(st, a, deal_override=d, auto_reset=auto)
        if auto:  # JAX's re-deals for the envs that finished
            done = from_jax(ntj.done)
            col = done[:, None]
            q = torch.where(col, from_jax(ntj.queue), ntt.queue)
            nst = nst.replace(queue=q)
            ntt.queue = q
            ntt.action_mask = torch.where(col, from_jax(ntj.action_mask), ntt.action_mask)
            if cfg_t.obs_planes:
                ntt.piece_planes = torch.where(
                    done[:, None, None, None], from_jax(ntj.piece_planes),
                    ntt.piece_planes)
        if auto:
            sj, raw_j, out_j, *carry_j = combine_j(nsj, ntj, sj, raw_j, *carry_j)
            st, raw_t, out_t, *carry_t = next_step_combine(nst, ntt, st, raw_t, *carry_t)
        else:
            sj, raw_j, out_j, *carry_j = combine_j(nsj, ntj, sj, raw_j, *carry_j)
            st, raw_t, out_t, *carry_t = disabled_combine(nst, ntt, st, raw_t, *carry_t)
        for f in STATE_FIELDS:
            same(getattr(sj, f), getattr(st, f), f"state {f} t={t}")
        assert raw_j.keys() == raw_t.keys() and out_j.keys() == out_t.keys()
        for k in raw_j:
            same(raw_j[k], raw_t[k], f"raw {k} t={t}")
        for k in out_j:
            same(out_j[k], out_t[k], f"presented {k} t={t}")
        for x, y in zip(carry_j, carry_t):
            same(x, y, f"carried flags t={t}")
        ended += int(np.asarray(out_j["terminated"] | out_j["truncated"]).sum())
        if not auto and t % 8 == 7:
            m = np.asarray(carry_j[0])
            sj, tsj = reset_j(sj, jnp.asarray(m))
            fields = {f: np.asarray(getattr(sj, f)) for f in STATE_FIELDS}
            st = state_from_numpy(fields, cfg_t, "cpu", seed=0, state_impl="packed")
            raw_j = jenv._raw_from_ts(tsj)
            raw_t = {k: from_jax(v) for k, v in raw_j.items()}
            alive_j, alive_t = ~jnp.asarray(m), ~from_jax(m)
            carry_j = [x & alive_j for x in carry_j]
            carry_t = [x & alive_t for x in carry_t]
    assert ended > 0


@pytest.mark.parametrize("preset", ["default", "tenten"])
def test_gym_make_plays_the_jax_oracle_episode(preset):
    """``gymnasium.make`` of the port's id plays, from one seed and the same
    actions, the episode of the JAX package's id, with the same spaces."""
    gymnasium = gym()
    import blockpuzzle_tpu  # noqa: F401 (registers the JAX ids)
    from blockpuzzle_tpu_torch.vector_env import BlockPuzzleOracleGymEnv

    suffix = "" if preset == "default" else f"-{preset}"
    ej = gymnasium.make(f"BlockPuzzleTpu/BlockPuzzle{suffix}-v0")
    et = gymnasium.make(f"BlockPuzzleTpuTorch/BlockPuzzle{suffix}-v0")
    assert isinstance(et.unwrapped, BlockPuzzleOracleGymEnv)
    assert et.observation_space == ej.observation_space
    assert et.action_space == ej.action_space
    (oj, ij), (ot, it) = ej.reset(seed=5), et.reset(seed=5)
    rng = np.random.default_rng(0)
    for t in range(400):
        for k in oj:
            np.testing.assert_array_equal(ot[k], oj[k], f"{k} t={t}")
        assert ij.keys() == it.keys()
        for k in ij:
            np.testing.assert_array_equal(it[k], ij[k], f"{k} t={t}")
        a = int(rng.choice(np.flatnonzero(ij["action_mask"])))
        oj, rj, termj, truncj, ij = ej.step(a)
        ot, rt, termt, trunct, it = et.step(a)
        assert (rt, termt, trunct) == (rj, termj, truncj)
        if termj or truncj:
            break
    assert termj or truncj
    ej.close()
    et.close()


# ------------------------------------------------------------------- card ----


@pytest.mark.gpu
@pytest.mark.parametrize("mode", MODES)
def test_autoreset_env_on_the_card_matches_the_cpu(cuda_device, mode):
    """The autoreset env from one seed on the card and on the CPU, actions from
    ``WordsSampler``, a ``reset_mask`` of the dead envs every 8 steps under
    ``disabled``: every presented field and the carried state bit-equal."""
    runs = []
    for dev in (cuda_device, "cpu"):
        engine = make_env(PRESETS["tenten"](), device=dev)
        auto = AutoresetEnv(engine, 512, mode)
        sampler = WordsSampler(2, 512, engine.device)
        trace = [to_host(auto.reset(seed=1))]
        for t in range(64):
            out = to_host(auto.step(sampler(engine, auto.state.board,
                                              auto.state.queue)))
            trace += [out, to_host(auto.carried())]
            if mode == "disabled" and t % 8 == 7:
                trace.append(to_host(auto.reset(
                    options={"reset_mask": out["terminated"] | out["truncated"]})))
        runs.append(trace)
    for i, (a, b) in enumerate(zip(*runs)):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], f"{k} record {i}")
