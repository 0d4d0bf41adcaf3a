"""The port's checkpoint, metrics, debug and profiling utilities on the CPU.

Twins ``tests/test_utils.py`` (orbax there, ``torch.save`` here): the
engine-state round trip, bit-exact resume of PPO and DQN training states
(the generator included), params-only restore across an optimizer
mismatch, forward compatibility (new fields filled, a reshaped leaf
refused), JSONL metrics, the throughput meter, the scope timer; plus the
debug checks on both board layouts and the profiler trace.  Resume is
exact, so every comparison is bit-equality.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from blockpuzzle_tpu_torch import PRESETS, make_env
from blockpuzzle_tpu_torch.learn import DQN, PPO, DQNConfig, PPOConfig
from blockpuzzle_tpu_torch.utils import (
    CheckpointManager, MetricsLogger, ScopeTimer, Throughput, check_finite,
    device_trace, validate_env_state,
)
from blockpuzzle_tpu_torch.utils.checkpoint import flatten_state
from blockpuzzle_tpu_torch.utils.metrics import host_metrics

FIELDS = ("board", "queue", "base_key", "rng_counter", "steps", "score", "streak")


def small_ppo(**kw):
    return PPO(make_env(PRESETS["default"](), device="cpu"), PPOConfig(
        num_envs=8, rollout_len=4, num_epochs=1, num_minibatches=2, hidden=16,
        channels=(4,), **kw))


def small_dqn(**kw):
    return DQN(make_env(PRESETS["default"](), device="cpu"), DQNConfig(**{
        **dict(num_envs=8, buffer_size=64, batch_size=8, collect_steps=2,
               min_buffer=16, hidden=16, channels=(4,), eps_decay_iters=10), **kw}))


def assert_states_equal(a, b):
    fa, fb = flatten_state(a), flatten_state(b)
    assert set(fa) == set(fb)
    for k, x in fa.items():
        y = fb[k]
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y), k
        elif k.endswith("opt"):
            assert x["param_groups"] == y["param_groups"], k
            for i, s in x["state"].items():
                for name, v in s.items():
                    assert torch.equal(v, y["state"][i][name]), (k, i, name)
        else:
            assert x == y, k


@pytest.mark.parametrize("state_impl", ["packed", "u8"])
def test_checkpoint_roundtrip_env_state(tmp_path, state_impl):
    env = make_env(PRESETS["tenten"](), device="cpu", state_impl=state_impl)
    state, _ = env.init(0, 8)
    state, _ = env.step(state, torch.zeros(8, dtype=torch.int32))
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    assert mgr.save(1, state)
    restored = mgr.restore(env.init(5, 8)[0])
    for name in FIELDS:
        assert torch.equal(getattr(state, name), getattr(restored, name)), name
    mgr.close()


def test_checkpoint_resume_is_bit_exact(tmp_path):
    env = make_env(PRESETS["default"](), device="cpu")
    state, _ = env.init(7, 16)
    actions = torch.zeros(16, dtype=torch.int32)
    for _ in range(3):
        state, _ = env.step(state, actions)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(3, state)
    cont_state, cont_ts = env.step(state, actions)
    res_state, res_ts = env.step(mgr.restore(env.init(0, 16)[0]), actions)
    for name in FIELDS:
        assert torch.equal(getattr(cont_state, name), getattr(res_state, name)), name
    assert torch.equal(cont_ts.reward, res_ts.reward)


@pytest.mark.parametrize("algo", ["ppo", "dqn", "dqn-nstep-per"])
def test_training_resume_is_bit_exact(tmp_path, algo):
    """Save after one update (DQN: two, so that the buffer is warm); the
    next update from the restored state, restored into a template from
    another seed, equals the uninterrupted one in every tensor, counter,
    generator state and metric."""
    if algo == "ppo":
        learner, step = small_ppo(), lambda l, s: l.update(s)
    else:
        kw = dict(n_step=3, per=True) if algo.endswith("per") else {}
        learner, step = small_dqn(**kw), lambda l, s: l.iteration(s)
    state = learner.init(0)
    for _ in range(1 if algo == "ppo" else 2):
        state, _ = step(learner, state)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(1, state)
    restored = mgr.restore(learner.init(9))
    assert_states_equal(state, restored)
    a, ma = step(learner, state)
    b, mb = step(learner, restored)
    assert host_metrics(ma) == host_metrics(mb)
    assert_states_equal(a, b)
    if algo != "ppo":
        assert a.grad_count > 0 and a.replay.filled > 0


def test_restore_params_across_an_optimizer_mismatch(tmp_path):
    """Evaluation restores the weights only: the template's optimizer (SGD
    here, Adam in the file) does not matter."""
    ppo = small_ppo()
    state, _ = ppo.update(ppo.init(0))
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(1, state)
    template = ppo.init(1)
    template.opt = torch.optim.SGD(template.net.parameters(), lr=1e-3)
    with pytest.raises(ValueError):
        mgr.restore(template)
    net = CheckpointManager(str(tmp_path / "ckpt")).restore_params(template.net)
    for a, b in zip(state.net.state_dict().values(), net.state_dict().values()):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="network parameters"):
        mgr.restore_params(small_ppo(torso="mlp").make_net(torch.Generator()))


@dataclasses.dataclass
class OldEnv:
    board: torch.Tensor
    score: torch.Tensor


@dataclasses.dataclass
class NewEnv:
    board: torch.Tensor
    score: torch.Tensor
    streak: torch.Tensor  # added after the checkpoint was written


def test_restore_fills_fields_added_after_save(tmp_path, capsys):
    old = {"env": OldEnv(board=torch.arange(12.0).view(3, 4), score=torch.tensor(5.0)),
           "step": 7}
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    assert mgr.save(3, old)
    template = {"env": NewEnv(board=torch.zeros(3, 4), score=torch.tensor(0.0),
                              streak=torch.full((3,), -1, dtype=torch.int32)),
                "step": 0}
    restored = CheckpointManager(str(tmp_path / "ckpt")).restore(template)
    assert torch.equal(restored["env"].board, old["env"].board)
    assert float(restored["env"].score) == 5.0 and restored["step"] == 7
    assert torch.equal(restored["env"].streak, torch.full((3,), -1, dtype=torch.int32))
    assert "env/streak" in capsys.readouterr().err


@pytest.mark.parametrize("template", [
    {"a": torch.zeros(8), "b": 0},                       # a reshaped leaf
    {"a": torch.zeros(4, dtype=torch.int32), "b": 0},     # a new dtype
    {"a": torch.zeros(4)},                                # a saved leaf dropped
    {"a": torch.zeros(4), "b": 0.0},                      # another type
    {"c": torch.zeros(4)},                                # nothing in common
], ids=["shape", "dtype", "dropped", "type", "disjoint"])
def test_restore_still_raises_on_other_mismatches(tmp_path, template):
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    assert mgr.save(1, {"a": torch.zeros(4), "b": 0})
    with pytest.raises(ValueError):
        mgr.restore(template)


def test_manager_keeps_the_newest_steps(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=3)
    assert mgr.latest_step() is None
    for step in (1, 2, 3, 4, 5):
        assert mgr.save(step, {"x": torch.tensor(step)})
    assert mgr.all_steps() == [3, 4, 5] and mgr.latest_step() == 5
    assert not mgr.save(5, {"x": torch.tensor(0)})
    assert int(mgr.restore({"x": torch.tensor(0)})["x"]) == 5
    assert mgr.save(5, {"x": torch.tensor(9)}, force=True)
    assert int(mgr.restore({"x": torch.tensor(0)}, step=5)["x"]) == 9
    assert int(mgr.restore({"x": torch.tensor(0)}, step=3)["x"]) == 3
    with pytest.raises(FileNotFoundError):
        mgr.restore({"x": torch.tensor(0)}, step=1)
    assert not list((tmp_path / "ckpt").rglob("*.tmp"))
    mgr.save_run_meta({"algo": "dqn", "recipe": {"seed": 3}})
    assert mgr.load_run_meta() == {"algo": "dqn", "recipe": {"seed": 3}}
    assert CheckpointManager(str(tmp_path / "other")).load_run_meta() is None


def test_metrics_logger_jsonl(tmp_path):
    logger = MetricsLogger(str(tmp_path), run_name="t")
    host = logger.log(1, {"loss": torch.tensor(1.5), "return": torch.tensor(3.0),
                          "episodes": torch.tensor(4), "epsilon": 0.25})
    logger.log(2, {"loss": torch.tensor(1.0), "return": torch.tensor(4.0)})
    logger.close()
    assert host["loss"] == 1.5 and host["episodes"] == 4.0 and host["epsilon"] == 0.25
    lines = (tmp_path / "t.jsonl").read_text().strip().splitlines()
    assert len(lines) == 2
    rec = json.loads(lines[1])
    assert rec["step"] == 2 and rec["loss"] == 1.0 and "wall_time" in rec


def test_host_metrics_keeps_float32_values_exactly():
    x = torch.tensor([0.1, 1e-30, 3.4e38], dtype=torch.float32)
    got = host_metrics({"a": x[0], "b": x[1], "c": x[2], "n": 7})
    assert list(got) == ["a", "b", "c", "n"]
    assert [got[k] for k in "abc"] == [float(v) for v in x] and got["n"] == 7.0


def test_throughput_meter_skips_the_first_tick():
    import time

    m = Throughput(torch.device("cpu"))
    assert m.tick(1000) == 0.0
    time.sleep(0.01)
    assert 0 < m.tick(1000) < 1000 / 0.01


def test_scope_timer():
    t = ScopeTimer()
    for name in ("a", "a", "b"):
        with t.scope(name):
            pass
    assert set(t.summary()) == {"a", "b"}


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with device_trace(str(tmp_path / "prof")):
        torch.ones(8) @ torch.ones(8)
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert trace["traceEvents"]
    with device_trace(None):
        pass


def test_check_finite():
    net = torch.nn.Linear(2, 2)
    check_finite(1, {"loss": 1.0}, net)
    with pytest.raises(FloatingPointError, match="metric loss"):
        check_finite(3, {"loss": float("nan")}, net)
    with torch.no_grad():
        net.weight[0, 0] = float("inf")
    with pytest.raises(FloatingPointError, match="parameter weight"):
        check_finite(3, {"loss": 1.0}, net)


@pytest.mark.parametrize("state_impl", ["packed", "u8"])
def test_validate_env_state_catches_broken_states(state_impl):
    env = make_env(PRESETS["default"](), device="cpu", state_impl=state_impl)
    state, _ = env.init(0, 4)
    for _ in range(3):
        state, ts = env.step(state, torch.zeros(4, dtype=torch.int32))
    validate_env_state(env, state)
    cells = env.board_obs(state.board).clone()
    cells[1, 2, :] = 1                                  # a full row
    with pytest.raises(AssertionError, match="full row"):
        validate_env_state(env, state.replace(board=env.encode_board(cells)))
    queue = state.queue.clone()
    queue[2, 0] = env.empty_id + 1                      # an id past the sentinel
    with pytest.raises(AssertionError, match="out of range"):
        validate_env_state(env, state.replace(queue=queue))
    with pytest.raises(AssertionError):
        validate_env_state(env, state.replace(board=state.board[:, :-1]))


# ------------------------------------------------------------- bounds ----

# the bytes of each kernel's call at N = 49152 on the default preset, in MB,
# as PERF.md's table of bounds records them (the wide and general u8
# kernels' on their 8x40 board, the tall kernels' on 33x9, the general
# packed kernels' and the deep mask's and clear's on 130x8)
RECORDED_MB = {"mask": 10.03, "apply": 15.04, "clear": 10.03, "legality": 98.3,
               "packed_apply": 10.72, "packed_mask": 9.04, "packed_legal_words": 8.06,
               "mask_wide": 31.65, "clear_wide": 31.65,
               "mask_general": 31.65, "apply_general": 47.48, "clear_general": 31.65,
               "legality_general": 314.6, "deal": 0.98, "uniform_legal": 5.70,
               "words_select": 4.72, "mask_tall": 29.39, "clear_tall": 29.39,
               "packed_apply_tall": 28.80, "packed_mask_tall": 27.77,
               "packed_legal_words_tall": 26.15, "packed_apply_general": 105.1,
               "packed_mask_general": 102.4, "packed_legal_words_general": 102.4,
               "packed_unpack": 8.85, "mask_deep": 102.4, "clear_deep": 102.4,
               "apply_wide": 47.48, "apply_tall": 44.09, "apply_deep": 153.6}


def kernel_call(name, n):
    """(cfg, inputs, outputs): CPU tensors of the shapes and dtypes of one
    call of kernel ``name`` on ``n`` envs (default preset; the wide and
    general u8 kernels on an 8x40 board, the tall ones on 33x9, the general
    packed ones and the deep mask and clear on 130x8)."""
    from blockpuzzle_tpu_torch import rules
    from blockpuzzle_tpu_torch.config import EnvConfig

    cfg = (EnvConfig(height=33, width=9) if name.endswith("_tall")
           else EnvConfig(height=130, width=8) if name.startswith("packed")
           and name.endswith("_general") or name.endswith("_deep")
           else EnvConfig(height=8, width=40) if name.endswith(("_wide", "_general"))
           else PRESETS["default"]())
    hw, s, h = cfg.num_cells, cfg.queue_size, cfg.height
    p = rules.tables_for(cfg).num_pieces
    u8 = lambda *shape: torch.zeros(shape, dtype=torch.uint8)
    i32 = lambda *shape: torch.zeros(shape, dtype=torch.int32)
    i64 = lambda *shape: torch.zeros(shape, dtype=torch.int64)
    b = lambda *shape: torch.zeros(shape, dtype=torch.bool)
    calls = {
        "mask": ((u8(n, hw), i32(n, s)), (b(n, s * hw),)),
        "apply": ((u8(n, hw), u8(n, hw), b(n)), (u8(n, hw), i32(n), b(n))),
        "clear": ((u8(n, hw),), (u8(n, hw), i32(n))),
        "legality": ((u8(n, hw),), (b(n, p, hw),)),
        "packed_apply": ((i64(n, h), i32(n, 11), i32(n), i32(n), b(n)),
                         (i64(n, h), i32(n), b(n))),
        "packed_mask": ((i64(n, h), i32(n, s)), (b(n, s * hw),)),
        "packed_legal_words": ((i64(n, h), i32(n, s)), (i64(n, s * h),)),
        # the draws: the step's 2S-wide deal at per-env counters, the
        # policy draws at one counter (an int moves no bytes)
        "deal": ((i64(n), i32(n), 0, 2 * s), (i32(n, 2 * s),)),
        "uniform_legal": ((i64(n), 7, b(n, s * hw)), (i64(n),)),
        "words_select": ((i64(n), 7, i64(n, s * h), cfg.width), (i64(n),)),
        "packed_unpack": ((i64(n, h),), (u8(n, h, cfg.width),)),
    }
    base = (name.removesuffix("_general").removesuffix("_wide").removesuffix("_tall")
            .removesuffix("_deep"))
    return (cfg,) + calls[base]


@pytest.mark.parametrize("name", RECORDED_MB)
def test_bounds_reproduce_the_recorded_bytes(name):
    from blockpuzzle_tpu_torch.utils.bounds import (
        COSTS, HBM_BYTES_PER_S, INT_OPS_PER_S, bound,
    )

    cfg, inputs, outputs = kernel_call(name, 49152)
    nbytes, ops = COSTS[name](cfg, inputs, outputs)
    digits = 1 if RECORDED_MB[name] > 90 else 2
    assert round(nbytes / 1e6, digits) == RECORDED_MB[name]
    b = bound(list(inputs) + list(outputs), ops)
    assert b["bytes"] == nbytes and b["ops"] == ops and ops > 0
    by_bytes, by_ops = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / INT_OPS_PER_S
    assert b["bound_ms"] == max(by_bytes, by_ops)
    assert b["bound_by"] == ("bytes" if by_bytes >= by_ops else "operations")


def test_packed_tail_bytes_pin_the_recorded_count():
    """B10, the packed step's tail, at N = 49152 on 10x10, S = 1 with
    auto-reset: 30,572,544 bytes of its tensors (PERF.md's 30.57 MB: 208 B
    an env in, 414 B out) plus its (P + 1) * HW = 2000-byte table, 0.009127
    ms by bytes; without auto-reset it reads neither the reset deals nor
    the streak and writes only the flags, the scalars and one board view
    (318 B an env)."""
    from blockpuzzle_tpu_torch.kernels import PackedTailKernel
    from blockpuzzle_tpu_torch.utils.bounds import COSTS, call_bound

    cfg, n = PRESETS["default"](), 49152
    k = PackedTailKernel(cfg, "cpu")
    i32 = lambda *shape: torch.zeros(shape, dtype=torch.int32)
    f32 = lambda *shape: torch.zeros(shape, dtype=torch.float32)
    inputs = (torch.zeros((n, 10), dtype=torch.int64), torch.zeros((n, 100), dtype=torch.bool),
              f32(n), i32(n, 1), i32(n, 1), i32(n), f32(n), i32(n), i32(n))
    full = inputs + (True,)
    nbytes, ops = COSTS["packed_tail"](cfg, full, k(*full))
    assert nbytes == 30_572_544 + 2000 == n * 622 + 2000
    b = call_bound("packed_tail", cfg, full, k(*full))
    assert (b["bytes"], b["ops"], b["bound_by"]) == (nbytes, ops, "bytes")
    assert round(b["bound_ms"], 6) == 0.009127
    bare = inputs + (False,)
    assert COSTS["packed_tail"](cfg, bare, k(*bare))[0] == n * 318 + 2000


def test_operations_bound_at_the_cards_32_bit_integer_rate():
    """Every hand kernel does 32-bit integer work, so an operations bound
    is at the H100's integer rate (132 SMs, 64 results a clock, 1.98 GHz),
    a quarter of its float32 FMA rate."""
    from blockpuzzle_tpu_torch.utils import bounds

    assert bounds.INT_OPS_PER_S == 132 * 64 * 1.98e9
    b = bounds.bound([torch.zeros(1, dtype=torch.uint8)], 1e9)
    assert b["bound_by"] == "operations"
    assert b["bound_ms"] == 1e3 * 1e9 / bounds.INT_OPS_PER_S


@pytest.mark.parametrize("nwords, width, lanes, regs, per_env", [
    (10, 10, 2, 8, 134),      # the default preset: 2 lanes of 6 and 4 words
    (30, 10, 4, 8, 200),      # tenten: 4 lanes
    (33, 9, 4, 16, 246),      # 33x9: 4 lanes of 9 words, one at a time
    (108, 9, 16, 8, 572),     # 36x9 with a hand of three
    (130, 8, 32, 8, 968),     # 130x8: a warp, spans of 6 words in 8 registers
    (512, 8, 32, 16, 1772),   # 512x8
])
def test_words_select_operations_pin_the_segment_count(nwords, width, lanes, regs, per_env):
    """B2w's operations an env on the ALU pipe: the fold, seed and lane of
    the one draw (30), a popcount and an add a word, in each of L lanes
    log2 L scan rounds of 3 and the rank's broadcast and test (4), the
    holder's pass over its K registers (5 a word) and its 5-step select
    (30); bytes bound it on every row the words path runs."""
    from blockpuzzle_tpu_torch.kernels.draws import select_lanes, select_shape
    from blockpuzzle_tpu_torch.utils.bounds import COSTS, bound

    n = 49152
    i64 = lambda *shape: torch.zeros(shape, dtype=torch.int64)
    inputs, outputs = (i64(n), 7, i64(n, nwords), width), (i64(n),)
    assert select_lanes(nwords) == lanes and select_shape(nwords, lanes)[2] == regs
    assert per_env == (30 + 2 * nwords + lanes * (3 * (lanes.bit_length() - 1) + 4)
                       + 5 * regs + 30)
    nbytes, ops = COSTS["words_select"](PRESETS["default"](), inputs, outputs)
    assert nbytes == n * (16 + 8 * nwords) and ops == n * per_env
    assert bound(list(inputs) + list(outputs), ops)["bound_by"] == "bytes"


def test_words_select_counts_the_second_walk_of_long_spans():
    """On rows of more than 1024 words a lane's span passes its 32
    registers; the holder walks it again up to its word, 2 operations a
    word read, counted from the actions (word 0: one chunk; word 40 of a
    34-word span, place 6: one chunk; the span's last word: two)."""
    from blockpuzzle_tpu_torch.utils.bounds import COSTS

    n, nwords, width = 3, 1030, 8
    i64 = lambda *shape: torch.zeros(shape, dtype=torch.int64)
    inputs = (i64(n), 7, i64(n, nwords), width)
    base = COSTS["words_select"](PRESETS["default"](), inputs, (i64(n),))[1]
    assert base == n * (30 + 2 * nwords + 32 * (15 + 4) + 5 * 32 + 30) + 2 * 32 * n
    acts = torch.tensor([0, 40 * width + 3, 33 * width], dtype=torch.int64)
    got = COSTS["words_select"](PRESETS["default"](), inputs, (acts,))[1]
    assert got == base + 2 * 32


def test_uniform_legal_is_operations_bound_on_the_main_path():
    """B2 at N = 49152 on the default preset (A = 100): the fold, the
    stream's seed and 100 lanes of hash, select and running maximum an env
    take longer on the ALU pipe at the integer rate than its 5.70 MB take
    at 3.35 TB/s; its multiplies, on the FMA pipe beside it, are fewer; the
    deal and the words select stay bound by their bytes."""
    from blockpuzzle_tpu_torch.utils.bounds import (
        COSTS, FOLD_MULS, FOLD_OPS, HBM_BYTES_PER_S, INT_OPS_PER_S, LANE_MULS, LANE_OPS,
        SEED_OPS, bound,
    )

    cfg, inputs, outputs = kernel_call("uniform_legal", 49152)
    nbytes, ops = COSTS["uniform_legal"](cfg, inputs, outputs)
    alu, muls = FOLD_OPS + SEED_OPS + (LANE_OPS + 3) * 100, FOLD_MULS + LANE_MULS * 100
    assert alu > muls and ops == 49152 * alu
    b = bound(list(inputs) + list(outputs), ops)
    assert b["bound_by"] == "operations"
    assert b["bound_ms"] == 1e3 * ops / INT_OPS_PER_S > 1e3 * nbytes / HBM_BYTES_PER_S
    assert 0.0024 < b["bound_ms"] < 0.0025
    for name in ("deal", "words_select"):
        cfg, inputs, outputs = kernel_call(name, 49152)
        _, ops = COSTS[name](cfg, inputs, outputs)
        assert bound(list(inputs) + list(outputs), ops)["bound_by"] == "bytes"


def test_wide_kernels_are_bytes_bound_on_the_wide_board():
    """The wide mask and clear at N = 49152 on 8x40: each moves the general
    kernel's bytes (644 an env) and does 1776 and 1120 operations an env
    (two words a row: packs of 32 and 8 cells, 5 max_h shuffles and 24 smear
    and mask operations a word for the mask, 8 a word for the clear, one an
    output byte), 5.2 and 3.3 us at the integer rate, under the 9.449 us
    its bytes take."""
    from blockpuzzle_tpu_torch.utils.bounds import COSTS, bound

    for name, per_env in (("mask_wide", 1776), ("clear_wide", 1120)):
        cfg, inputs, outputs = kernel_call(name, 49152)
        nbytes, ops = COSTS[name](cfg, inputs, outputs)
        general, _ = COSTS[name.replace("_wide", "_general")](cfg, inputs, outputs)
        assert nbytes == general == 644 * 49152 and ops == per_env * 49152
        b = bound(list(inputs) + list(outputs), ops)
        assert b["bound_by"] == "bytes" and 0.00944 < b["bound_ms"] < 0.00945


def test_apply_kernels_beyond_32x32_are_bytes_bound():
    """K2's wide, tall and deep kernels at N = 49152 (8x40, 33x9, 130x8):
    3 HW + 6 bytes an env (board and cover in, a valid byte; board, k and
    legal out), the general apply's bytes; 1824, 2013 and 8580 operations
    an env (two rows of words packed a row, 2 operations a word to test and
    place and the clear's 8, the deep one 6 more, one an output byte), under
    the 0.014173, 0.013161 and 0.045865 ms their bytes take."""
    from blockpuzzle_tpu_torch.utils.bounds import COSTS, bound

    for name, per_env, ms in (("apply_wide", 1824, 0.014173), ("apply_tall", 2013, 0.013161),
                              ("apply_deep", 8580, 0.045865)):
        cfg, inputs, outputs = kernel_call(name, 49152)
        nbytes, ops = COSTS[name](cfg, inputs, outputs)
        general, _ = COSTS["apply_general"](cfg, inputs, outputs)
        assert nbytes == general == (3 * cfg.num_cells + 6) * 49152
        assert ops == per_env * 49152
        b = bound(list(inputs) + list(outputs), ops)
        assert b["bound_by"] == "bytes" and round(b["bound_ms"], 6) == ms


# the tall packed mask's and words' bounds at N = 49152 on the boards
# ``chip_measure.py --parts tall`` times them on, a hand of ids drawn
# uniformly from the piece set and the empty id, as there
# (``chip_smoke.kernel_inputs``): (H, W, S) -> (mask, words) bound in ms and
# what sets it
TALL_PACKED_BOUNDS = {
    (33, 9, 1): ((0.008290, "bytes"), (0.007806, "bytes")),
    (36, 9, 3): ((0.018663, "bytes"), (0.017078, "bytes")),
    (64, 8, 1): ((0.015083, "bytes"), (0.015083, "bytes")),
    (128, 10, 1): ((0.033864, "bytes"), (0.030107, "bytes"))}


@pytest.mark.parametrize("board", TALL_PACKED_BOUNDS)
def test_tall_packed_mask_and_words_bounds(board):
    """B7 tall and B7w tall read H int64 words and S int32 ids an env and
    write S*H*W bools (the mask) or S*H int64 words: bytes-bound on every
    tall board the measurements take, at the recorded bounds (the words on
    36x9 with a hand of three were bound by operations while the count
    charged every anchor column a test a footprint word)."""
    from blockpuzzle_tpu_torch import rules
    from blockpuzzle_tpu_torch.config import EnvConfig
    from blockpuzzle_tpu_torch.utils.bounds import kernel_bounds

    h, w, s = board
    n = 49152
    cfg = EnvConfig(height=h, width=w, queue_size=s, region_clear=s > 1, region_size=3)
    p = rules.tables_for(cfg).num_pieces
    queue = torch.as_tensor(np.random.default_rng(0).integers(0, p + 1, (n, s), dtype=np.int32))
    words = torch.zeros((n, h), dtype=torch.int64)
    outs = {"packed_mask_tall": torch.zeros((n, s * h * w), dtype=torch.bool),
            "packed_legal_words_tall": torch.zeros((n, s * h), dtype=torch.int64)}
    got = kernel_bounds(cfg, None, queue, None, None, words, None, None, None, outs)
    for (name, b), (ms, by), out_bytes in zip(got.items(), TALL_PACKED_BOUNDS[board],
                                             (s * h * w, 8 * s * h)):
        assert b["bytes"] == n * (8 * h + 4 * s + out_bytes), name
        assert b["bound_by"] == by and round(b["bound_ms"], 6) == ms, name


@pytest.mark.parametrize("preset", ["default", "tenten", "woodoku", "big"])
def test_packed_mask_operations_count_a_row_at_once(preset):
    """B7's and B7w's least work: each anchor row of an env-slot holding a
    piece ORs each cell's shifted board row (2 operations a cell) and masks
    it (2), an empty slot none; so both are bound by their bytes on every
    preset (the parallel kernels of 16 rows beat the count that charged
    every anchor column a test)."""
    from blockpuzzle_tpu_torch import rules
    from blockpuzzle_tpu_torch.utils.bounds import COSTS, bound

    cfg = PRESETS[preset]()
    t = rules.tables_for(cfg)
    queue = torch.tensor([[0] * cfg.queue_size, [t.num_pieces] * cfg.queue_size],
                         dtype=torch.int32)
    queue[1, 0] = t.num_pieces - 1
    words = torch.zeros((2, cfg.height), dtype=torch.int64)
    cells = cfg.queue_size * int(t.piece_cells[0]) + int(t.piece_cells[-1])
    for name in ("packed_mask", "packed_legal_words"):
        _, ops = COSTS[name](cfg, (words, queue), ())
        assert ops == cfg.height * (2 * cells + 2 * (cfg.queue_size + 1)), name
    cfg, inputs, outputs = kernel_call("packed_legal_words", 49152)
    nbytes, ops = COSTS["packed_legal_words"](cfg, inputs, outputs)
    assert bound(list(inputs) + list(outputs), ops)["bound_by"] == "bytes"


def test_draw_operations_count_the_busier_pipe():
    """A deal's operations are its ALU pipe's, which outnumber its
    multiplies (the fold's, two a lane and the lane's ``__umulhi``, on the
    FMA pipe) at every width."""
    from blockpuzzle_tpu_torch.utils.bounds import (
        COSTS, FOLD_MULS, FOLD_OPS, LANE_MULS, LANE_OPS, SEED_OPS,
    )

    cfg, inputs, outputs = kernel_call("deal", 64)
    key, counter, tag, _ = inputs
    for width in (1, 2, 6, 100):
        _, ops = COSTS["deal"](cfg, (key, counter, tag, width), outputs)
        alu = FOLD_OPS + SEED_OPS + LANE_OPS * width
        assert alu > FOLD_MULS + (LANE_MULS + 1) * width and ops == 64 * alu
