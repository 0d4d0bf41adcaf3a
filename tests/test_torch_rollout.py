"""The port's rollout path: CLI, random streams, sampler, and (on a card)
each kernel against its plain version, both steps and a short training
run.

This file imports no JAX at module level, so the ``gpu`` tests run on a
machine without it: ``python -m pytest --noconftest -m gpu
tests/test_torch_rollout.py``.  Everything compared is integer or bool
and must be bit-equal.
"""

import types

import numpy as np
import pytest
import torch

from blockpuzzle_tpu_torch import PRESETS, make_env
from blockpuzzle_tpu_torch.cli import rollout as rollout_cli
from blockpuzzle_tpu_torch.env import rng
from blockpuzzle_tpu_torch.sampler import UniformLegalSampler, uniform_legal

M32 = (1 << 32) - 1


def _mix32_ref(x: int) -> int:
    """Pure-Python mix32 on unbounded ints, the reference for the int64
    tensor version."""
    x ^= x >> 16
    x = (x * 0x21F0AAAD) & M32
    x ^= x >> 15
    x = (x * 0xD35A2D97) & M32
    return x ^ (x >> 15)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the CPU has only the plain versions)")
    return torch.device("cuda")


# ---------------------------------------------------------------- CLI ----


def test_rollout_cli_runs_and_is_deterministic(capsys):
    argv = ["--device", "cpu", "--num-envs", "8", "--steps", "30",
            "--preset", "tenten", "--seed", "3"]
    assert rollout_cli.main(argv) == 0
    assert rollout_cli.main(argv) == 0
    first, second = capsys.readouterr().out.strip().splitlines()
    drop_rate = lambda line: [f for f in line.split("|") if "steps/s" not in f]
    assert drop_rate(first) == drop_rate(second)
    # --steps 30 runs one measured chunk of 100 steps, as the JAX CLI does
    assert first.startswith("800 env-steps (chunks of 100)")
    assert first.endswith("device cpu")


@pytest.mark.parametrize("steps, chunks", [(50, 1), (1, 1), (149, 1), (260, 3)])
def test_rollout_cli_runs_the_jax_clis_chunks(steps, chunks, monkeypatch, capsys):
    """Chunks of 100 steps always, ``max(round(steps / 100), 1)`` of them."""
    asked = []

    def fake(env, num_envs, chunk, n_chunks, seed):
        asked.append((num_envs, chunk, n_chunks, seed))
        return {"rates": [1.0] * n_chunks, "seconds": 2.0, "reward": 0.0,
                "env_steps": n_chunks * chunk * num_envs, "episodes": 0,
                "episode_return": 0.0}

    monkeypatch.setattr(rollout_cli, "rollout", fake)
    argv = ["--device", "cpu", "--num-envs", "4", "--steps", str(steps), "--seed", "9"]
    assert rollout_cli.main(argv) == 0
    assert asked == [(4, 100, chunks, 9)]
    out = capsys.readouterr().out
    assert out.startswith(f"{chunks * 400} env-steps (chunks of 100) | ")


def test_rollout_cli_prints_the_cumulative_rate(monkeypatch, capsys):
    """The printed rate is the env-steps of all timed chunks over their
    summed wall time (the JAX CLI's ``Throughput``), not the median of the
    chunk rates: with chunk times 1 s, 1 s and 8 s the two differ."""
    times = iter([0.0,                           # the warm-up chunk's start
                  10.0, 11.0, 20.0, 21.0, 30.0, 38.0])
    env = make_env(PRESETS["default"](), device="cpu")
    clock = types.SimpleNamespace(perf_counter=lambda: next(times))
    monkeypatch.setattr(rollout_cli, "time", clock)  # the CLI's clock only
    r = rollout_cli.rollout(env, 4, 2, 3, seed=0)
    assert r["rates"] == [8.0, 8.0, 1.0] and r["seconds"] == 10.0
    assert r["env_steps"] == 24
    line = rollout_cli.summary_line({**r, "env_steps": 24_000_000}, 2, "cpu")
    assert "| 2.40M steps/s steady |" in line    # the median would print 8.00M
    monkeypatch.undo()
    assert rollout_cli.main(["--device", "cpu", "--num-envs", "4", "--steps", "50"]) == 0
    assert capsys.readouterr().out.startswith("400 env-steps (chunks of 100) | ")


def test_rollout_function_same_seed_same_state():
    env = make_env(PRESETS["woodoku"](), device="cpu")
    a = rollout_cli.rollout(env, 6, 10, 2, seed=5)
    b = rollout_cli.rollout(env, 6, 10, 2, seed=5)
    c = rollout_cli.rollout(env, 6, 10, 2, seed=6)
    for f in ("board", "queue", "rng_counter", "score"):
        assert torch.equal(getattr(a["state"], f), getattr(b["state"], f))
    assert a["reward"] == b["reward"] and len(a["rates"]) == 2
    assert not torch.equal(a["state"].board, c["state"].board)
    assert int(a["state"].rng_counter[0]) == 1 + 3 * 10


def test_rollout_cli_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this checks the failure without a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rollout_cli.main(["--num-envs", "2", "--steps", "1"])


# ---------------------------------------------------------------- RNG ----


def test_mix32_and_mul32_match_unbounded_ints():
    vals = [0, 1, 2, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, M32, 0x12345678,
            0xDEADBEEF] + list(np.random.default_rng(0).integers(0, 1 << 32, 500))
    x = torch.tensor([int(v) for v in vals], dtype=torch.int64)
    got = rng.mix32(x).tolist()
    assert got == [_mix32_ref(int(v)) for v in vals]
    for c in (0x21F0AAAD, 0xD35A2D97, M32):
        assert rng._mul32(x, c).tolist() == [(int(v) * c) & M32 for v in vals]


def test_mix32_is_a_bijection_on_a_sample():
    x = torch.arange(0, 1 << 20, dtype=torch.int64) * 4093
    y = rng.mix32(x & M32)
    assert y.unique().numel() == x.numel()
    assert int(y.min()) >= 0 and int(y.max()) <= M32


def test_stream_keys_distinct_and_deterministic():
    k = rng.stream_keys(7, 50000, "cpu")
    assert k.unique().numel() == 50000 and int(k.min()) >= 0
    assert torch.equal(k, rng.stream_keys(7, 50000, "cpu"))
    assert not torch.equal(k[:100], rng.stream_keys(8, 100, "cpu"))
    assert torch.equal(k[:10], rng.stream_keys(7, 10, "cpu"))


@pytest.mark.parametrize("num_pieces", [19, 5])
def test_deal_ids_in_range_and_roughly_uniform(num_pieces):
    key = rng.stream_keys(0, 4096, "cpu")
    ids = torch.cat([rng.deal(key, c, rng.TAG_STEP, 6, num_pieces)
                     for c in range(8)])
    assert ids.dtype == torch.int32
    assert int(ids.min()) == 0 and int(ids.max()) == num_pieces - 1
    counts = torch.bincount(ids.reshape(-1).long(), minlength=num_pieces).double()
    expect = ids.numel() / num_pieces
    chi2 = float(((counts - expect) ** 2 / expect).sum())
    # 99.9% quantile of chi-square with 18 (resp. 4) degrees of freedom
    assert chi2 < {19: 42.31, 5: 18.47}[num_pieces], chi2


def test_draws_depend_on_counter_tag_and_lane_only():
    key = rng.stream_keys(1, 64, "cpu")
    ctr = torch.full((64,), 9, dtype=torch.int32)
    a = rng.bits(key, ctr, rng.TAG_STEP, 6)
    assert torch.equal(a, rng.bits(key, 9, rng.TAG_STEP, 6))
    assert torch.equal(a[:, :3], rng.bits(key, 9, rng.TAG_STEP, 3))
    assert torch.equal(a[10:20], rng.bits(key[10:20], 9, rng.TAG_STEP, 6))
    assert (a != rng.bits(key, 10, rng.TAG_STEP, 6)).float().mean() > 0.99
    # the reset substream differs from the step draw at the same counter
    assert (a[:, :3] != rng.bits(key, 9, rng.TAG_RESET, 3)).float().mean() > 0.99
    assert (a != rng.bits(key, 9, rng.TAG_POLICY, 6)).float().mean() > 0.99
    with pytest.raises(ValueError):
        rng.bits(key, 0, 0, 1 << 17)


def test_counter_grows_and_auto_reset_never_replays_a_stream():
    env = make_env(PRESETS["default"](), device="cpu")
    n, steps = 16, 300
    state, ts = env.init(2, n)
    sampler = UniformLegalSampler(3, n, "cpu")
    episodes = [[[]] for _ in range(n)]
    for t in range(steps):
        before = state.rng_counter.clone()
        state, ts = env.step(state, sampler(ts.action_mask))
        assert torch.equal(state.rng_counter, before + 1)
        for e in range(n):
            if bool(ts.done[e]):
                episodes[e].append([])
            episodes[e][-1].append(int(state.queue[e, 0]))
    assert int(state.rng_counter[0]) == 1 + steps
    resets = 0
    for eps in episodes:
        heads = [tuple(ep[:8]) for ep in eps if len(ep) >= 8]
        resets += len(eps) - 1
        assert len(set(heads)) == len(heads), "an episode replayed a deal stream"
    assert resets > n


# ------------------------------------------------------------ sampler ----


def test_uniform_legal_matches_the_jax_formula():
    """Same mask and the same u32 draws into both frameworks: the same
    actions, ties and all-illegal rows included."""
    import jax.numpy as jnp

    r = np.random.default_rng(0)
    mask = r.random((64, 300)) < 0.1
    mask[0] = False                                  # no legal action
    bits = r.integers(0, 1 << 32, (64, 300), dtype=np.uint64).astype(np.uint32)
    bits[1] = 7                                      # ties everywhere
    bits[2, :] = 0                                   # all-zero draws
    want = np.asarray(jnp.argmax(
        jnp.where(jnp.asarray(mask), jnp.asarray(bits) | jnp.uint32(1),
                  jnp.uint32(0)), axis=-1))
    got = uniform_legal(torch.as_tensor(mask),
                        torch.as_tensor(bits.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0] == 0 and got[1] == np.flatnonzero(mask[1])[0]


def test_sampler_picks_legal_actions_uniformly():
    n, a = 2000, 40
    mask = torch.zeros(n, a, dtype=torch.bool)
    mask[:, ::4] = True                              # 10 legal actions
    s = UniformLegalSampler(0, n, "cpu")
    picks = torch.cat([s(mask) for _ in range(5)])
    assert bool(mask[0, picks].all())
    counts = torch.bincount(picks, minlength=a)[::4].double()
    chi2 = float(((counts - 1000) ** 2 / 1000).sum())
    assert chi2 < 27.88                              # chi-square 9 dof, 99.9%
    again = UniformLegalSampler(0, n, "cpu")
    assert torch.equal(torch.cat([again(mask) for _ in range(5)]), picks)


# ---------------------------------------------------------------- card ---


@pytest.mark.gpu
@pytest.mark.parametrize("preset", ["default", "tenten", "woodoku", "big", "wide40"])
def test_kernels_match_plain_versions_on_the_card(preset, cuda_device):
    """The u8 kernels against their plain versions at the rollout's N and
    at N - 1 (a ragged last block): the bit-row mask, clear, apply and
    legality on the presets, the general ones on a board of 8 rows of 40
    cells (too wide for a row word)."""
    from blockpuzzle_tpu_torch import rules
    from blockpuzzle_tpu_torch.config import EnvConfig
    from blockpuzzle_tpu_torch.kernels import (
        ApplyKernel, ClearScanKernel, LegalityKernel, MaskKernel,
    )

    cfg = EnvConfig(height=8, width=40) if preset == "wide40" else PRESETS[preset]()
    t = rules.tables_for(cfg)
    mk, ak = MaskKernel(cfg, cuda_device), ApplyKernel(cfg, cuda_device)
    ck, lk = ClearScanKernel(cfg, cuda_device), LegalityKernel(cfg, cuda_device)
    sizes = (49152, 49151)
    for n in sizes:
        r = np.random.default_rng(n)
        board = (r.random((n, cfg.num_cells)) < 0.35).astype(np.uint8)
        grid = board.reshape(n, cfg.height, cfg.width)
        grid[::5, 2, :] = 1
        grid[1::5, 3:6, 3:6] = 1
        grid[2::5, 4, :] = 1                         # row 4 full but its
        grid[2::5, 4, 0] = 0                         # first cell
        queue = r.integers(0, t.num_pieces + 1, (n, cfg.queue_size)).astype(np.int32)
        g = r.integers(0, t.cover.shape[0], n)
        g[2::5] = 4 * cfg.width                      # 1x1 at (4, 0): clears
        board, queue, cover, valid = (torch.as_tensor(x, device=cuda_device)
                                      for x in (board, queue, t.cover[g], t.valid[g]))
        assert torch.equal(mk(board, queue), mk.plain(board, queue))
        outs = ak(board, cover, valid)
        for o, p in zip(outs, ak.plain(board, cover, valid)):
            assert torch.equal(o, p)
        assert int(outs[1].sum()) > 0 and bool(outs[2].any()) and not bool(outs[2].all())
        for o, p in zip(ck(board), ck.plain(board)):
            assert torch.equal(o, p)
        legal_all = lk(board)
        assert torch.equal(legal_all, lk.plain(board))
        assert 0 < float(legal_all.float().mean()) < 1
    torch.cuda.synchronize()
    rows = preset != "wide40"
    want = (len(sizes) * rows, len(sizes) * (not rows))
    for k in (mk, ak, ck, lk):
        assert (k.launches, k.general_launches) == want


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [0, 3, 8, 13])
def test_bit_row_kernels_take_an_unaligned_board_on_the_card(offset, cuda_device):
    """Boards that start ``offset`` bytes past a 16-byte boundary: the
    bit-row mask, clear, apply and legality stage an unaligned head and
    tail byte by byte and still equal their plain versions.  The apply's
    cover starts at another offset than its board.  Woodoku's legality
    blocks also start their output spans off a boundary (P*H*W = 1539)."""
    from blockpuzzle_tpu_torch import rules
    from blockpuzzle_tpu_torch.kernels import (
        ApplyKernel, ClearScanKernel, LegalityKernel, MaskKernel,
    )

    def placed(cells, at):
        """``cells`` (n, hw) on the card, starting ``at`` bytes past a
        16-byte boundary."""
        store = torch.zeros(cells.size + 16, dtype=torch.uint8, device=cuda_device)
        out = store[at : at + cells.size].view(cells.shape)
        out.copy_(torch.as_tensor(cells, device=cuda_device))
        assert out.data_ptr() % 16 == at
        return out

    for preset in ("tenten", "woodoku"):
        cfg = PRESETS[preset]()
        t = rules.tables_for(cfg)
        n, hw = 4099, cfg.num_cells
        r = np.random.default_rng(offset)
        cells = (r.random((n, cfg.height, cfg.width)) < 0.5).astype(np.uint8)
        cells[::3, 4, :] = 1
        queue = torch.as_tensor(
            r.integers(0, t.num_pieces + 1, (n, cfg.queue_size)).astype(np.int32),
            device=cuda_device)
        g = r.integers(0, t.cover.shape[0], n)
        board = placed(cells.reshape(n, hw), offset)
        cover = placed(t.cover[g], (offset + 7) % 16)
        valid = torch.as_tensor(t.valid[g], device=cuda_device)
        mk, ck = MaskKernel(cfg, cuda_device), ClearScanKernel(cfg, cuda_device)
        ak, lk = ApplyKernel(cfg, cuda_device), LegalityKernel(cfg, cuda_device)
        assert torch.equal(mk(board, queue), mk.plain(board, queue))
        for o, p in zip(ck(board), ck.plain(board)):
            assert torch.equal(o, p)
        for o, p in zip(ak(board, cover, valid), ak.plain(board, cover, valid)):
            assert torch.equal(o, p)
        assert torch.equal(lk(board), lk.plain(board))
        torch.cuda.synchronize()
        assert [k.launches for k in (mk, ck, ak, lk)] == [1] * 4
        assert [k.general_launches for k in (mk, ck, ak, lk)] == [0] * 4


@pytest.mark.gpu
@pytest.mark.parametrize("backend", ["pallas", "jnp"])
def test_cuda_rollout_matches_cpu_rollout(cuda_device, backend):
    cfg = PRESETS["tenten"]()
    env = make_env(cfg, device=cuda_device, backend=backend, state_impl="u8")
    a = rollout_cli.rollout(env, 256, 16, 1, seed=4)
    b = rollout_cli.rollout(
        make_env(cfg, device="cpu", backend=backend, state_impl="u8"), 256, 16,
        1, seed=4)
    for f in ("board", "queue", "rng_counter", "steps", "score", "streak"):
        assert torch.equal(getattr(a["state"], f).cpu(), getattr(b["state"], f))
    assert a["reward"] == b["reward"]
    step_kernel = env.apply_kernel if backend == "pallas" else env.clear_kernel
    assert env.mask_kernel.launches == step_kernel.launches == 32


@pytest.mark.gpu
@pytest.mark.parametrize("n", [49152, 49151])
@pytest.mark.parametrize("preset", ["default", "tenten", "woodoku", "big"])
def test_packed_kernels_match_plain_versions_on_the_card(preset, n, cuda_device):
    """The packed apply and mask kernels against their plain versions and
    against the u8 apply and mask kernels on the unpacked boards, at the
    rollout's N and at N - 1 (a warp with one env segment of two, a mask
    block short of its env-slots)."""
    from blockpuzzle_tpu_torch import rules
    from blockpuzzle_tpu_torch.kernels import (
        ApplyKernel, MaskKernel, PackedApplyKernel, PackedMaskKernel,
    )
    from blockpuzzle_tpu_torch.kernels.packed import pack_words, unpack_words

    cfg = PRESETS[preset]()
    env = make_env(cfg, device=cuda_device, state_impl="u8")
    t = rules.tables_for(cfg)
    r = np.random.default_rng(1)
    cells = (r.random((n, cfg.height, cfg.width)) < 0.35).astype(np.uint8)
    cells[::5, 2, :] = 1
    cells[1::5, :, 4] = 1
    cells[2::5, 3:6, 3:6] = 1
    queue = r.integers(0, t.num_pieces + 1, (n, cfg.queue_size)).astype(np.int32)
    g = r.integers(0, t.cover.shape[0], n)
    board, queue, cover, valid, pid, anchor = (
        torch.as_tensor(x, device=cuda_device) for x in
        (cells.reshape(n, -1), queue, t.cover[g], t.valid[g], g // cfg.num_cells,
         g % cfg.num_cells))
    words = pack_words(board.view(n, cfg.height, cfg.width))
    attrs = env._attrs[pid]
    rr = (anchor // cfg.width).to(torch.int32)
    cc = (anchor % cfg.width).to(torch.int32)
    pak, pmk = PackedApplyKernel(cfg, cuda_device), PackedMaskKernel(cfg, cuda_device)
    mask = pmk(words, queue)
    assert torch.equal(mask, pmk.plain(words, queue))
    assert torch.equal(mask, MaskKernel(cfg, cuda_device)(board, queue))
    out = pak(words, attrs, rr, cc, valid)
    for o, p in zip(out, pak.plain(words, attrs, rr, cc, valid)):
        assert torch.equal(o, p)
    u8 = ApplyKernel(cfg, cuda_device)(board, cover, valid)
    assert torch.equal(unpack_words(out[0], cfg.width).view(n, -1), u8[0])
    assert torch.equal(out[1], u8[1]) and torch.equal(out[2], u8[2])
    assert int(out[1].sum()) > 0 and bool(out[2].any()) and not bool(out[2].all())
    torch.cuda.synchronize()
    assert (pak.launches, pmk.launches) == (1, 1)


@pytest.mark.gpu
def test_cuda_packed_rollout_matches_cpu_rollout(cuda_device):
    """The packed engine on the card against the CPU and against the u8
    engine on the card, from one seed with live deals and auto-reset."""
    cfg = PRESETS["woodoku"]()
    env = make_env(cfg, device=cuda_device)
    assert env.state_impl == "packed"
    runs = [rollout_cli.rollout(e, 256, 16, 1, seed=4) for e in (
        env, make_env(cfg, device="cpu"),
        make_env(cfg, device=cuda_device, state_impl="u8"))]
    words = runs[0]["state"].board
    assert torch.equal(words.cpu(), runs[1]["state"].board)
    assert torch.equal(env.board_obs(words).reshape(256, -1),
                       runs[2]["state"].board)
    for r in runs[1:]:
        for f in ("queue", "rng_counter", "steps", "score", "streak"):
            assert torch.equal(getattr(runs[0]["state"], f).cpu(),
                               getattr(r["state"], f).cpu())
        assert r["reward"] == runs[0]["reward"]
    assert env.packed_mask_kernel.launches == env.packed_apply_kernel.launches == 32
    assert env.mask_kernel.launches == env.apply_kernel.launches == 0


@pytest.mark.gpu
def test_conv_ppo_updates_on_the_card(cuda_device):
    """Two PPO updates with the JAX CLI's default flags (conv torso, packed
    engine) at small sizes on the card."""
    from blockpuzzle_tpu_torch.cli import train

    args = train.build_parser().parse_args([
        "--updates", "2", "--num-envs", "256", "--rollout-len", "16",
        "--log-every", "1"])
    learner = train.build(args)
    r = train.train(args, learner)
    m = r["metrics"]
    assert np.isfinite(m["loss"]) and m["illegal_action_rate"] == 0.0
    env = learner.env
    assert env.state_impl == "packed"
    assert env.packed_mask_kernel.launches == 2 * 17
    assert env.packed_apply_kernel.launches == 2 * 16


@pytest.mark.gpu
def test_ppo_updates_on_the_card(cuda_device):
    """Two PPO updates at small widths on the card: finite metrics, only
    legal actions, and the mask and clear kernels launched per step."""
    from blockpuzzle_tpu_torch.cli import train

    args = train.build_parser().parse_args([
        "--torso", "mlp", "--state-impl", "u8", "--updates", "2",
        "--num-envs", "256", "--rollout-len", "16", "--mlp-width", "64",
        "--log-every", "1"])
    learner = train.build(args)
    r = train.train(args, learner)
    m = r["metrics"]
    assert np.isfinite(m["loss"]) and m["illegal_action_rate"] == 0.0
    env = learner.env
    assert env.mask_kernel.launches == 2 * 17 and env.clear_kernel.launches == 2 * 16
    assert env.apply_kernel.launches == 0
