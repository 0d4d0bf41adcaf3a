"""The port's whole u8 step on boards beyond 16x16, on the CPU, against
JAX's u8 step.

The u8 parity tests of ``test_torch_engine.py`` take the presets, and the
wide, tall, deep and xwide u8 kernels are held one by one
(``test_torch_kernels.py``, ``test_torch_tall.py``, ``test_torch_deep.py``,
``test_torch_xwide.py``).  Here the whole step of the port's u8 engine,
with ``backend="jnp"`` (the mask with the clear kernel, the default where
W > 32) and ``"pallas"`` (the mask with the apply kernel), runs in
lockstep with JAX's ``make_env(cfg, state_impl="u8")`` on 8x40, 33x9,
36x9 with 3x3 regions and a hand of three, 130x8, 8x136, 40x136 (the
xwide mask, clear and apply above 32 rows) and 2x1056 with the five small
pieces (rows of more than 1024 cells: the xwide mask's, clear's and
apply's long-row instances): half the
boards dense (a hole a row, up to three empty rows on top) so that games
end, half 55% full; injected deals; auto-reset; uniform-legal, raw-argmax
(sometimes illegal) and arbitrary (illegal, out-of-range) actions.  On
every step every timestep field, every info field and every state field
is equal; finished envs redeal from each engine's own stream, so their
hands are compared before the reset and then overwritten with JAX's.  On
the CPU the kernels run their plain versions, so this holds the step's
glue and the plain kernels; the CUDA kernels are held to those by their
emulations and on the card.  Everything but the float32 rewards is
integer or bool; the rewards are small integer sums taken in the JAX
step's order, so all must be bit-equal.
"""

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
from test_torch_engine import pick_actions
from test_torch_tail import dense_cells

BOARDS = {"8x40": dict(height=8, width=40), "33x9": dict(height=33, width=9),
          "36x9r3": dict(height=36, width=9, region_clear=True, region_size=3,
                         queue_size=3),
          "130x8": dict(height=130, width=8), "8x136": dict(height=8, width=136),
          "40x136": dict(height=40, width=136),
          "2x1056": dict(height=2, width=1056, piece_set="mini5")}
N, STEPS = 8, 16


@functools.lru_cache(maxsize=1)
def jax_u8_engine(board):
    """JAX's u8 engine on ``board`` and its jitted step with auto-reset,
    built once for both backends (one board at a time: the cases run board
    by board, and each engine holds its rule tables)."""
    env_j = jax_make_env(jcfg.EnvConfig(**BOARDS[board]), state_impl="u8")
    return env_j, jax.jit(lambda s, a, d: env_j.step(s, a, deal_override=d))


@pytest.fixture(autouse=True)
def _drop_new_tables():
    """Drop the rule tables a case built from both packages' caches when it
    ends: classic19's on 40x136 take about 0.56 GB in each, and the cases
    of this file would pile them up."""
    import blockpuzzle_tpu.rules as jrules

    from blockpuzzle_tpu_torch import rules

    caches = (rules._TABLE_CACHE, jrules._TABLE_CACHE)
    before = [set(c) for c in caches]
    yield
    for cache, old in zip(caches, before):
        for cfg in set(cache) - old:
            del cache[cfg]


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
@pytest.mark.parametrize("board", BOARDS)
def test_u8_step_matches_jax_u8_step(board, backend):
    env_j, step_j = jax_u8_engine(board)
    ct = tcfg.EnvConfig(**BOARDS[board])
    env_t = make_env(ct, device="cpu", backend=backend, state_impl="u8")
    assert env_t.state_impl == env_j.state_impl == "u8"
    rng = np.random.default_rng(31)
    s, a_n = ct.queue_size, env_t.num_actions
    init = rng.integers(0, env_t.num_pieces, (N, s)).astype(np.int32)
    sj, tj = env_j.init(jax.random.key(0), N, deal_override=jnp.asarray(init))
    st, tt = env_t.init(0, N, deal_override=init)
    cells = dense_cells(ct, N, rng).reshape(N, -1)
    cells[N // 2 :] = rng.random((N - N // 2, ct.num_cells)) < 0.55
    sj = sj.replace(board=jnp.asarray(cells))
    st = st.replace(board=torch.as_tensor(cells))
    # the masks of the dense boards, as the first step's actions see them
    tj = tj.replace(action_mask=env_j.action_mask(sj.board, sj.queue))
    tt.action_mask = env_t.action_mask(st.board, st.queue)
    np.testing.assert_array_equal(tt.action_mask.numpy(), np.asarray(tj.action_mask))
    seen = {"cleared": 0, "illegal": 0, "done": 0, "term": 0}
    for t in range(STEPS):
        if t % 5 == 3:  # raw argmax ignores the mask: sometimes illegal
            a = rng.random((N, a_n)).argmax(axis=1).astype(np.int32)
        else:
            a = pick_actions(np.asarray(tj.action_mask), rng, a_n)
        d = rng.integers(0, env_t.num_pieces, (N, s)).astype(np.int32)
        sj, tj = step_j(sj, jnp.asarray(a), jnp.asarray(d))
        st, tt = env_t.step(st, a, deal_override=d)
        done = np.asarray(tj.done)
        live = ~done
        for f in ("board", "queue", "action_mask"):
            np.testing.assert_array_equal(
                getattr(tt, f).numpy()[live], np.asarray(getattr(tj, f))[live], f"{f} t={t}")
        for f in ("reward", "terminated", "truncated"):
            np.testing.assert_array_equal(
                getattr(tt, f).numpy(), np.asarray(getattr(tj, f)), f"{f} t={t}")
        assert set(tt.info) == set(tj.info)
        for k in tj.info:
            np.testing.assert_array_equal(
                tt.info[k].numpy(), np.asarray(tj.info[k]), f"{k} t={t}")
        for f in ("board", "steps", "score", "streak", "rng_counter"):
            np.testing.assert_array_equal(
                getattr(st, f).numpy(), np.asarray(getattr(sj, f)), f"{f} t={t}")
        np.testing.assert_array_equal(
            tt.action_mask.numpy()[done], env_t._empty_board_mask(st.queue).numpy()[done])
        st = st.replace(queue=torch.tensor(np.array(sj.queue)))
        seen["cleared"] += int(tt.info["lines_cleared"].sum())
        seen["illegal"] += int((~tt.info["legal"]).sum())
        seen["done"] += int(done.sum())
        seen["term"] += int(tt.terminated.sum())
    assert seen["illegal"] and seen["done"] and seen["term"] and seen["cleared"], seen
