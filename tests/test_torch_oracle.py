"""The port's CPU oracle (``blockpuzzle_tpu_torch.oracle``) against the JAX
package's (``blockpuzzle_tpu.oracle``).

Both record seeded uniform-legal episodes (deal stream ``seed``, policy
stream ``seed + 1``); every field of every trajectory must be bit-equal:
actions, boards, queues, masks, rewards, terminated, truncated, deals,
init_deals and the return.  Presets and the config knobs of
``tests/test_torch_parity.py``; episodes up to 512 steps.
"""

import dataclasses

import numpy as np
import pytest

from blockpuzzle_tpu import config as jcfg
from blockpuzzle_tpu.oracle import BlockPuzzleOracleEnv as JaxOracle
from blockpuzzle_tpu.oracle import record_trajectory as jax_record
from blockpuzzle_tpu_torch import config as tcfg
from blockpuzzle_tpu_torch.oracle import BlockPuzzleOracleEnv, record_trajectory

FIELDS = ("actions", "boards", "queues", "masks", "rewards", "terminated",
          "truncated", "deals", "init_deals")
KNOBS = {
    "truncation": {"max_steps": 12},
    "mini5-hand2": {"piece_set": "mini5", "queue_size": 2, "refill_batch": True},
    "streak": {"height": 5, "width": 5, "piece_set": "mini5", "streak_bonus": 7.0},
}
CASES = [pytest.param(p, {}, id=p) for p in ("default", "tenten", "woodoku", "big")]
CASES += [pytest.param("default", k, id=name) for name, k in KNOBS.items()]


def _twin(cfg):
    return jcfg.EnvConfig(**dataclasses.asdict(cfg))


@pytest.mark.parametrize("preset,knobs", CASES)
def test_record_trajectory_matches_jax_oracle(preset, knobs):
    cfg = dataclasses.replace(tcfg.PRESETS[preset](), **knobs)
    steps = 0
    for seed in (0, 3, 11):
        got = record_trajectory(cfg, seed=seed, max_steps=512)
        want = jax_record(_twin(cfg), seed=seed, max_steps=512)
        for f in FIELDS:
            a, b = getattr(got, f), getattr(want, f)
            assert a.dtype == b.dtype and a.shape == b.shape, (seed, f)
            np.testing.assert_array_equal(a, b, f"seed {seed}, {f}")
        assert got.episode_return == want.episode_return
        assert got.seed == seed and got.cfg == cfg
        steps += len(got.actions)
    assert steps > 0


def test_illegal_action_is_a_noop_with_penalty():
    """An occupied anchor and an empty slot: board, queue and streak stay,
    the reward is the illegal penalty, the episode goes on; the JAX oracle
    returns the same."""
    cfg = dataclasses.replace(tcfg.tenten_config(), streak_bonus=3.0)
    board = np.zeros((cfg.height, cfg.width), np.uint8)
    board[0, 0] = 1
    queue = np.array([0, 5, 19], np.int32)              # slot 2 is empty
    outs = []
    for env in (BlockPuzzleOracleEnv(cfg), JaxOracle(_twin(cfg))):
        env.reset(seed=4, options={"board": board, "queue": queue})
        env.streak = 2
        for action in (0, 2 * cfg.num_cells + 55):        # occupied, empty slot
            obs, r, term, trunc, info = env.step(action)
            assert r == cfg.illegal_penalty and not term and not trunc
            assert not info["legal"] and info["lines_cleared"] == 0
            np.testing.assert_array_equal(obs["board"], board)
            np.testing.assert_array_equal(obs["queue"], queue)
            assert env.streak == 2 and env.steps == (1 if action == 0 else 2)
            outs.append((obs["board"], obs["queue"], r, info["action_mask"]))
        with pytest.raises(ValueError, match="out of range"):
            env.step(cfg.num_actions())
    for a, b in zip(outs[:2], outs[2:]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_reset_options_and_render_match_jax_oracle():
    cfg = dataclasses.replace(tcfg.woodoku_config(), obs_planes=True)
    board = (np.random.default_rng(0).random((9, 9)) < 0.3).astype(np.uint8)
    envs = (BlockPuzzleOracleEnv(cfg, render_mode="ansi"),
            JaxOracle(_twin(cfg), render_mode="ansi"))
    resets = [e.reset(seed=7, options={"board": board}) for e in envs]
    for k in ("board", "queue", "piece_planes"):
        np.testing.assert_array_equal(resets[0][0][k], resets[1][0][k])
    np.testing.assert_array_equal(resets[0][1]["action_mask"],
                                  resets[1][1]["action_mask"])
    assert envs[0].render() == envs[1].render()
    for e in envs:
        with pytest.raises(ValueError, match="unknown reset options"):
            e.reset(options={"boards": board})
        with pytest.raises(ValueError, match="cells must be 0/1"):
            e.reset(options={"board": board * 2})
