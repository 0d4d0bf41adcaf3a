"""Property-based tests of the port's engines: twins of the four
properties of ``tests/test_properties.py``, with its strategies and its
``max_examples`` (60, 60, 40, 10).

The first three properties run on three engines of the port: packed (the
packed apply B1 and mask B7), u8 ``backend="jnp"`` (the mask K1 and the
clear K3) and u8 ``backend="pallas"`` (K1 and the apply K2); the
reference is the port's oracle (``blockpuzzle_tpu_torch/oracle``).  The
fourth runs on the oracle, as the JAX test does, and on the three batched
engines, whose hands refill only when empty too.  Every case runs on the
CPU and, under the ``gpu`` marker, on the card (skipped in a fixture where
there is none).

This file imports no JAX, so the card machine runs it as ``python -m
pytest --noconftest -m gpu tests/test_torch_properties.py``.  Everything
compared is integer or bool and must be equal.
"""

import functools
import random

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from blockpuzzle_tpu_torch import make_env, rules
from blockpuzzle_tpu_torch.config import default_config, tenten_config
from blockpuzzle_tpu_torch.oracle import BlockPuzzleOracleEnv
from blockpuzzle_tpu_torch.sampler import UniformLegalSampler

CFG = default_config()
ORACLE = BlockPuzzleOracleEnv(CFG)
ORACLE.reset(seed=0)
# engine -> make_env's arguments
ENGINES = {"packed": dict(state_impl="packed"),
           "u8_jnp": dict(backend="jnp", state_impl="u8"),
           "u8_pallas": dict(backend="pallas", state_impl="u8")}


@pytest.fixture(scope="module",
                params=["cpu", pytest.param("cuda", marks=pytest.mark.gpu)])
def device(request):
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the CPU has only the plain versions)")
    return request.param


@functools.cache
def engine(name: str, device: str, preset: str = "default"):
    cfg = tenten_config() if preset == "tenten" else CFG
    return make_env(cfg, device=device, **ENGINES[name])


@st.composite
def board_and_piece(draw):
    bits = draw(st.integers(0, 2**100 - 1))
    board = np.array(
        [(bits >> i) & 1 for i in range(100)], dtype=np.uint8
    ).reshape(10, 10)
    pid = draw(st.integers(0, 18))
    return board, pid


def reachable(board):
    """``board`` with its full lines emptied, a state a game can reach."""
    b = board.copy()
    b[b.all(axis=1)] = 0
    b[:, b.all(axis=0)] = 0
    return b


def one_env(env, board, pid):
    """A one-env state holding ``board`` and the hand ``[pid]``."""
    state, _ = env.init(0, 1, deal_override=np.array([[pid]]))
    return state.replace(board=env.encode_board(board[None]))


@pytest.mark.parametrize("name", ENGINES)
def test_mask_equals_canplace_everywhere(name, device):
    """Engine mask <=> the oracle's can_place at every anchor."""
    env = engine(name, device)

    @given(board_and_piece())
    @settings(max_examples=60, deadline=None)
    def check(bp):
        board, pid = bp
        ORACLE.board[:] = board
        ORACLE.queue[:] = [pid]
        expected = ORACLE.legal_action_mask()
        assert expected.tolist() == [ORACLE.can_place(pid, *divmod(a, CFG.width))
                                     for a in range(CFG.num_cells)]
        queue = torch.tensor([[pid]], dtype=torch.int32, device=env.device)
        got = env.action_mask(env.encode_board(board[None]), queue)[0].cpu().numpy()
        np.testing.assert_array_equal(got, expected)

    check()


@pytest.mark.parametrize("name", ENGINES)
def test_step_never_leaves_full_line(name, device):
    """Place-then-clear never leaves a full row or column."""
    env = engine(name, device)

    @given(board_and_piece(), st.integers(0, 99))
    @settings(max_examples=60, deadline=None)
    def check(bp, cell):
        board, pid = bp
        state = one_env(env, reachable(board), pid)
        state2, _ = env.step(state, torch.tensor([cell], device=env.device),
                             auto_reset=False)
        out = env.board_obs(state2.board)[0].cpu().numpy()
        assert not out.all(axis=1).any(), "full row left after step"
        assert not out.all(axis=0).any(), "full col left after step"

    check()


@pytest.mark.parametrize("name", ENGINES)
def test_reward_zero_iff_illegal(name, device):
    env = engine(name, device)

    @given(board_and_piece(), st.integers(0, 99))
    @settings(max_examples=40, deadline=None)
    def check(bp, cell):
        board, pid = bp
        state = one_env(env, reachable(board), pid)
        _, ts = env.step(state, torch.tensor([cell], device=env.device),
                         auto_reset=False)
        legal = bool(ts.info["legal"][0])
        reward = float(ts.reward[0])
        ORACLE.board[:] = reachable(board)
        ORACLE.queue[:] = [pid]
        assert legal == ORACLE.can_place(pid, *divmod(cell, CFG.width))
        if legal:
            assert reward >= int(rules.tables_for(CFG).piece_cells[pid])
        else:
            assert reward == CFG.illegal_penalty

    check()


@given(st.integers(0, 2**31 - 1))
@settings(max_examples=10, deadline=None)
def test_batch_refill_only_when_hand_empty(seed):
    """1010!-variant invariant on the oracle: slots refill only when ALL
    are empty."""
    cfg = tenten_config()
    oracle = BlockPuzzleOracleEnv(cfg)
    obs, info = oracle.reset(seed=seed)
    rng = random.Random(seed)
    for _ in range(30):
        legal = np.flatnonzero(info["action_mask"])
        if legal.size == 0:
            break
        n_empty_before = int((obs["queue"] == oracle._empty_id).sum())
        obs, r, term, trunc, info = oracle.step(int(rng.choice(legal)))
        n_empty_after = int((obs["queue"] == oracle._empty_id).sum())
        if n_empty_before < cfg.queue_size - 1:
            # hand not about to empty: consumed slot stays empty
            assert n_empty_after == n_empty_before + 1
        else:
            # last piece placed -> full redeal
            assert n_empty_after == 0
        if term or trunc:
            break


@pytest.mark.parametrize("name", ENGINES)
def test_batch_refill_only_when_hand_empty_batched(name, device):
    """The same invariant on a batched engine (tenten: 3 slots, batch
    refill), 16 envs with a uniform-legal action each step for 30 steps;
    an env with no legal action is out of the check from then on."""
    env = engine(name, device, "tenten")
    slots = env.cfg.queue_size

    @given(st.integers(0, 2**31 - 1))
    @settings(max_examples=10, deadline=None)
    def check(seed):
        state, ts = env.init(seed, 16)
        draw = UniformLegalSampler(seed + 1, 16, env.device)
        for _ in range(30):
            alive = ts.action_mask.any(dim=1)
            before = (state.queue == env.empty_id).sum(dim=1)
            state, ts = env.step(state, draw(ts.action_mask), auto_reset=False)
            after = (state.queue == env.empty_id).sum(dim=1)
            assert bool(ts.info["legal"][alive].all())
            want = torch.where(before < slots - 1, before + 1, 0)
            assert torch.equal(after[alive], want[alive])

    check()
