"""The port's measuring and tuning scripts (``blockpuzzle_tpu_torch/scripts/``)
and its quickstart (``blockpuzzle_tpu_torch/examples/quickstart.py``), on
the CPU, each run in process through ``main(argv)`` at a tiny size.

* Every script's JSON contract, and the flags and variants each refuses.
* ``bench_backends``: the three backends' final states equal.
* ``bench_actor``: the greedy actor step against flax's from the same
  parameters (``interop.params_from_flax``), conv and mlp torsos: logits
  within ``tests/test_torch_ppo.py``'s forward tolerance (abs 2e-2),
  actions equal on every row whose JAX top-two logit gap exceeds 1e-4, and
  those rows at least 99% of the batch.
* The ``packsel`` and ``words`` policies of ``bench_words`` pick JAX's
  ``sample_uniform_legal`` actions fed the same uniforms (bit-equal).
* ``sweep_ppo``: twins of the 7 tests of ``tests/test_sweep_ppo.py``, its
  ``--metrics-jsonl`` rows under JAX's field names, and
  ``scripts/compare_metrics.py`` (unchanged) exiting 0 on two same-seed
  streams and 1 on two seeds.
* The quickstart's four sections, and its two Gymnasium sections raising
  ``ImportError`` where gymnasium is missing.
* ``roofline``: its JSON contract, timed and not; the state floor equal to
  the hand sum of the ``EnvState`` fields' bytes; the count the same a
  step an env at two batches; the counted kernels hiding their plain
  versions' ops from the count and adding ``utils/bounds.py``'s bytes;
  each step kernel of each engine, the deal and the argmax draw counted
  once a step.
* ``bench_scaling``: a world-2 run's final states, gathered in rank order,
  bit-equal to one process on both ranks' envs; ``--cpu-sim``'s 8 ranks
  and JSON contract.
"""

import json
import pathlib
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blockpuzzle_tpu import config as jcfg
from blockpuzzle_tpu.env import make_env as jax_make_env
from blockpuzzle_tpu.env import words as jwords
from blockpuzzle_tpu.learn import PPO as JPPO
from blockpuzzle_tpu.learn import PPOConfig as JPPOConfig
from blockpuzzle_tpu.learn.ppo import default_hypers as jax_hypers
from blockpuzzle_tpu_torch import bench, sampler
from blockpuzzle_tpu_torch.env import rng
from blockpuzzle_tpu_torch.examples import quickstart
from blockpuzzle_tpu_torch.kernels import draws as kernel_draws
from blockpuzzle_tpu_torch.interop import params_from_flax
from blockpuzzle_tpu_torch.learn import PPO, PPOConfig
from blockpuzzle_tpu_torch.scripts import (
    bench_actor,
    bench_backends,
    bench_learner,
    bench_scaling,
    bench_words,
    profile_ppo,
    profile_step,
    roofline,
    sweep_ppo,
)
from blockpuzzle_tpu_torch.utils import CheckpointManager
from blockpuzzle_tpu_torch.utils.bounds import COSTS

REPO = pathlib.Path(__file__).resolve().parent.parent


def json_lines(text):
    return [json.loads(line) for line in text.strip().splitlines()
            if line.startswith("{")]


def run(module, argv, capsys):
    """``module.main(argv)`` -> (its JSON lines, its stderr)."""
    assert module.main(argv) == 0
    out = capsys.readouterr()
    return json_lines(out.out), out.err


# ------------------------------------------------------- JSON contracts ----


def test_bench_words_contract(capsys):
    recs, _ = run(bench_words, ["--device", "cpu", "--num-envs", "16", "--chunk", "4",
                                "--iters", "1", "--windows", "2"], capsys)
    assert [r["mode"] for r in recs[:3]] == ["base", "packsel", "words"]
    for r in recs[:3]:
        assert set(r) == {"mode", "num_envs", "steps_per_s", "device"}
        assert r["num_envs"] == 16 and r["steps_per_s"] > 0 and r["device"] == "cpu"
    rel = recs[3]["relative_to_base"]
    assert set(rel) == {"base", "packsel", "words"} and rel["base"] == 1.0


def test_bench_backends_contract_and_equal_final_states(capsys):
    recs, err = run(bench_backends, ["--device", "cpu", "--num-envs", "16", "--chunk",
                                     "4", "--iters", "1", "--windows", "1"], capsys)
    assert [r["backend"] for r in recs] == ["jnp", "hybrid", "pallas"]
    for r in recs:
        assert set(r) == {"backend", "platform", "device", "num_envs", "init_s",
                          "compile_s", "steps_per_s", "best_steps_per_s"}
        assert r["platform"] == "cpu" and r["steps_per_s"] > 0
    assert "final states bit-equal across jnp, hybrid, pallas" in err
    # the check the script makes, made here too
    states = [bench_backends.run_backend(b, 16, 4, 1, 1, "cpu")["state"]
              for b in bench_backends.BACKENDS]
    for s in states[1:]:
        for f in bench_backends.STATE_FIELDS:
            assert torch.equal(getattr(s, f), getattr(states[0], f)), f
    assert int(states[0].score.sum()) > 0


def test_bench_backends_raises_on_different_final_states(monkeypatch, capsys):
    real = bench_backends.run_backend

    def skewed(backend, *a):
        rec = real(backend, *a)
        if backend == "pallas":
            board = rec["state"].board.clone()
            board[0, 0] ^= 1
            rec["state"] = rec["state"].replace(board=board)
        return rec

    monkeypatch.setattr(bench_backends, "run_backend", skewed)
    with pytest.raises(AssertionError, match="pallas and jnp final states differ"):
        bench_backends.main(["--device", "cpu", "--num-envs", "8", "--chunk", "2",
                             "--iters", "1", "--windows", "1"])


def test_bench_actor_contract(capsys):
    recs, _ = run(bench_actor, ["--device", "cpu", "--num-envs", "16", "--chunk", "4",
                                "--iters", "1", "--windows", "2", "--mlp-width", "32"],
                  capsys)
    assert [(r["torso"], r["policy"]) for r in recs] == [
        ("mlp", "greedy"), ("mlp", "sample"), ("conv", "greedy"), ("conv", "sample")]
    for r in recs:
        assert set(r) == {"metric", "torso", "policy", "preset", "num_envs", "value",
                          "device"}
        assert r["metric"] == "actor_steps_per_s" and r["value"] > 0


def test_bench_learner_contract(capsys):
    recs, _ = run(bench_learner, ["--device", "cpu", "--num-envs", "16",
                                  "--rollout-len", "4", "--updates", "2", "--windows",
                                  "2"], capsys)
    assert [(r["variant"], r["torso"]) for r in recs] == [("base", "conv"),
                                                          ("mlp", "mlp")]
    for r in recs:
        assert set(r) == {"variant", "torso", "dispatch", "num_envs", "rollout_len",
                          "compile_s", "frames_per_s", "best_frames_per_s", "device"}
        assert r["dispatch"] == 1 and r["frames_per_s"] > 0


def test_profile_step_contract(tmp_path, capsys):
    (rec,), err = run(profile_step, ["--device", "cpu", "--num-envs", "16", "--chunk",
                                     "4", "--chunks", "2", "--trace-dir",
                                     str(tmp_path)], capsys)
    assert rec["steps"] == 8 and rec["device"] == "cpu" and rec["step_us"] > 0
    # no device kernels on the CPU: the device figures are not measured
    assert rec["device_total_us_per_step"] is None and rec["busy_share"] is None
    assert rec["launches_per_step"] is None and rec["top_kernels"] == []
    assert "not measured" in err
    assert (tmp_path / "trace.json").exists()


def test_profile_ppo_contract(capsys):
    (rec,), _ = run(profile_ppo, ["--device", "cpu", "--num-envs", "16",
                                  "--rollout-len", "4", "--iters", "1"], capsys)
    assert set(rec) == {"update_ms", "rollout_gae_ms", "epochs_perm_ms",
                        "epochs_roll_ms", "epochs_none_ms", "frames_per_s", "device"}
    assert all(rec[k] > 0 for k in rec if k.endswith("_ms"))


def test_ppo_epochs_are_the_update_after_the_rollout():
    """``PPO._epochs`` (profile_ppo's epochs part) is the rest of
    ``PPO.update``: from the same network and batch, the same metrics
    and parameters."""
    env = bench.make_bench_env(device="cpu")
    ppo = PPO(env, PPOConfig(num_envs=8, rollout_len=4, torso="mlp", mlp_width=32))
    a, b = ppo.init(0), ppo.init(0)
    a, ma = ppo.update(a)
    b, batch, last_value, _ = ppo._rollout(b)
    adv, ret = ppo._gae(batch, last_value)
    mb = ppo._epochs(b, batch, adv, ret, {"lr": 3e-4, "entropy_coef": 0.01,
                                          "clip_eps": 0.2, "value_coef": 0.5,
                                          "gamma": 0.995, "gae_lambda": 0.95})
    for k, v in mb.items():
        assert torch.equal(v, ma[k]), k
    for (n, p), q in zip(a.net.named_parameters(), b.net.parameters()):
        assert torch.equal(p, q), n


# ------------------------------------------------- refused flags/variants ----

REFUSED = [
    (bench_learner, ["--variants", "dispatch"], "'dispatch' is not ported"),
    (bench_learner, ["--variants", "mlp_dispatch"], "'mlp_dispatch' is not ported"),
    (bench_learner, ["--dispatch", "8"], "--dispatch"),
    (profile_ppo, ["--variants", "noperm"], "'noperm' is not ported"),
    (profile_ppo, ["--variants", "reshape"], "unknown variant 'reshape'"),
    (profile_step, ["--mask-impl", "bitboard"], "--mask-impl"),
    (profile_step, ["--mask-dtype", "int8"], "--mask-dtype"),
    (profile_step, ["--unroll", "4"], "--unroll"),
    (sweep_ppo, ["--platform", "cpu"], "--platform"),
    (bench_actor, ["--platform", "cpu"], "--platform"),
    (roofline, ["--mask-impl", "shift"], "--mask-impl 'shift' is not ported"),
    (roofline, ["--mask-dtype", "bool"], "--mask-dtype 'bool' is not ported"),
]


@pytest.mark.parametrize("module,argv,named", REFUSED,
                         ids=[f"{m.__name__.split('.')[-1]}{a[0]}={a[1]}"
                              for m, a, _ in REFUSED])
def test_refused_flags_and_variants(module, argv, named, capsys):
    with pytest.raises(SystemExit) as e:
        module.main(argv + ["--device", "cpu"])
    assert e.value.code == 2
    assert named in capsys.readouterr().err


# -------------------------------------------------- the actor against JAX ----

ACTOR_KW = dict(num_envs=256, rollout_len=8, hidden=32, mlp_width=64, channels=(4, 8))


@pytest.mark.parametrize("torso", ["mlp", "conv"])
def test_greedy_actor_step_matches_flax(torso):
    jppo = JPPO(jax_make_env(jcfg.default_config()), JPPOConfig(**ACTOR_KW, torso=torso))
    ppo = PPO(bench.make_bench_env(device="cpu"), PPOConfig(**ACTOR_KW, torso=torso))
    params = jax.jit(jppo.net.init)(
        jax.random.key(2), jnp.zeros((1, 10, 10), jnp.uint8),
        jnp.zeros((1, 1), jnp.int32), jnp.ones((1, 100), bool))
    net = ppo.make_net(torch.Generator().manual_seed(0))
    net.load_state_dict(params_from_flax(params))
    env, n = ppo.env, ACTOR_KW["num_envs"]
    # a mid-game observation
    state, ts = env.init(3, n)
    draw = sampler.UniformLegalSampler(4, n, "cpu")
    for _ in range(10):
        state, ts = env.step(state, draw(ts.action_mask))
    obs = (ts.board, ts.queue, ts.action_mask)
    lj = np.asarray(jppo.net.apply(params, *(x.numpy() for x in obs))[0])
    aj = lj.argmax(axis=1)
    gen = torch.Generator().manual_seed(0)
    with torch.inference_mode():
        lt = net(*obs)[0].numpy()
        at = bench_actor.act(net, obs, "greedy", gen).numpy()
        # the script's chunk takes the same first step
        s1, obs1, r = bench_actor.run_chunk(env, net, state, obs, "greedy", gen, 1)
    mask = obs[2].numpy()
    np.testing.assert_allclose(lt[mask], lj[mask], rtol=0, atol=2e-2)
    top2 = np.sort(np.where(mask, lj, -np.inf), axis=1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 1e-4
    assert clear.mean() >= 0.99
    np.testing.assert_array_equal(at[clear], aj[clear])
    stepped, ts2 = env.step(state, torch.as_tensor(at))
    assert torch.equal(s1.board, stepped.board) and float(r) == float(ts2.reward.sum())
    assert torch.equal(obs1[2], ts2.action_mask)


# ------------------------------------------- packsel / words against JAX ----


def inject_policy_bits(monkeypatch, draws):
    """The policy draw kernels' ``rng.bits`` (their plain versions' on the
    CPU) replaced by ``draws[counter]``."""
    def bits(key, counter, tag, width):
        assert tag == rng.TAG_POLICY
        return torch.as_tensor(draws[counter]).reshape(-1, 1)[:, :width]

    monkeypatch.setattr(kernel_draws, "rng", types.SimpleNamespace(
        **{**vars(rng), "bits": bits}))


@pytest.mark.parametrize("mode", ["packsel", "words"])
@pytest.mark.parametrize("preset", ["default", "woodoku"])
def test_words_policies_match_jax(mode, preset, monkeypatch):
    """On mid-game packed boards at a ragged N, each draw's action equals
    JAX's ``sample_uniform_legal`` on JAX's legal words (``words``) or its
    packed bool mask (``packsel``) with the key whose u32 bits the port's
    sampler is given."""
    n, draws_n = 37, 6
    env = bench.make_bench_env(preset, device="cpu")
    env_j = jax_make_env(jcfg.PRESETS[preset](), state_impl="packed")
    cfg = env.cfg
    state, ts = env.init(5, n)
    draw = sampler.UniformLegalSampler(6, n, "cpu")
    for _ in range(5):
        state, ts = env.step(state, draw(ts.action_mask))
    keys = [jax.random.key(40 + k) for k in range(draws_n)]
    inject_policy_bits(monkeypatch, [
        np.asarray(jax.random.bits(k, (n,), jnp.uint32)).astype(np.int64) for k in keys])
    policy = bench.make_policy(env, mode, n)
    board_j = jnp.asarray(state.board.numpy().astype(np.uint32))
    queue_j = jnp.asarray(state.queue.numpy())
    if mode == "words":
        words_j = jwords.legal_words(env_j, board_j, queue_j)
    else:
        words_j = jwords.pack_bool_mask(jnp.asarray(ts.action_mask.numpy()), cfg.height,
                                        cfg.width, cfg.queue_size)
    for k, key in enumerate(keys):
        got = policy(state, ts.action_mask).numpy()
        want = np.asarray(jwords.sample_uniform_legal(words_j, key, cfg.width))
        np.testing.assert_array_equal(got, want, f"draw {k}")
        assert ts.action_mask.numpy()[np.arange(n), got].all()


# ------------------------------------------------------------- sweep_ppo ----

TINY = ["--updates", "6", "--num-envs", "16", "--rollout-len", "8", "--eval-envs", "8",
        "--eval-steps", "32", "--device", "cpu", "--torso", "mlp", "--mlp-width", "32"]


def sweep(argv, capsys):
    recs, err = run(sweep_ppo, argv, capsys)
    return recs, err


def test_sweep_produces_summary(tmp_path, capsys):
    recs, _ = sweep(["--configs", "base", "--updates", "2", "--num-envs", "16",
                     "--rollout-len", "8", "--eval-envs", "8", "--eval-steps", "32",
                     "--device", "cpu", "--torso", "mlp", "--checkpoint-dir",
                     str(tmp_path / "ckpt")], capsys)
    assert len(recs) >= 2
    assert recs[0]["config"] == "base"
    assert "greedy_return" in recs[0] and "frames_per_s" in recs[0]
    assert recs[-1]["best"] == "base"
    # the best config's state was checkpointed for cli/evaluate.py
    meta = CheckpointManager(str(tmp_path / "ckpt")).load_run_meta()
    assert meta["algo"] == "ppo" and meta["state_impl"] == "packed"
    assert CheckpointManager(str(tmp_path / "ckpt")).all_steps() == [2]


def test_sweep_checkpoint_every_saves_mid_run_steps(tmp_path, capsys):
    ckpt = tmp_path / "ckpt"
    sweep(["--configs", "base", "--updates", "5", "--num-envs", "16", "--rollout-len",
           "8", "--eval-envs", "8", "--eval-steps", "32", "--device", "cpu", "--torso",
           "mlp", "--mlp-width", "32", "--checkpoint-dir", str(ckpt),
           "--checkpoint-every", "2"], capsys)
    steps = sorted(int(p.name) for p in ckpt.iterdir() if p.name.isdigit())
    assert steps == [2, 4, 5], steps  # periodic saves at 2 and 4, the final at 5


def test_sweep_checkpoint_every_rejects_multi_config(tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        sweep_ppo.main(["--configs", "base", "anneal", "--updates", "2", "--device",
                        "cpu", "--checkpoint-dir", str(tmp_path / "ckpt"),
                        "--checkpoint-every", "1"])
    assert e.value.code != 0
    assert "single --configs entry" in capsys.readouterr().err
    assert not (tmp_path / "ckpt").exists()


def test_sweep_eval_kept_records_peak_step(tmp_path, capsys):
    ckpt, jsonl = tmp_path / "ckpt", tmp_path / "metrics.jsonl"
    recs, _ = sweep(["--configs", "base"] + TINY + [
        "--log-every", "2", "--ent-floor", "10.0", "--ent-every", "3", "--lr0", "3e-4",
        "--lr1", "3e-5", "--lr-decay-start", "0.5", "--lr-shape", "cosine",
        "--metrics-jsonl", str(jsonl), "--checkpoint-dir", str(ckpt),
        "--checkpoint-every", "2", "--eval-kept"], capsys)
    rec = recs[0]
    assert rec["lr0_eff"] == 3e-4 and rec["lr1_eff"] == 3e-5
    assert rec["lr_decay_start"] == 0.5 and rec["lr_shape"] == "cosine"
    assert rec["ent_every"] == 3
    curve_rows = [r for r in recs if "checkpoint_step" in r]
    assert [r["checkpoint_step"] for r in curve_rows] == [2, 4, 6]
    kept = [r for r in recs if "kept_eval_best_step" in r]
    assert len(kept) == 1
    meta = json.loads((ckpt / "run_meta.json").read_text())
    assert meta["best_step"] == kept[0]["kept_eval_best_step"]
    assert len(meta["checkpoint_curve"]) == 3
    recipe = meta["recipe"]
    assert recipe["config"] == "base" and recipe["seed"] == 0 and recipe["updates"] == 6
    assert recipe["num_envs"] == 16 and recipe["rollout_len"] == 8
    assert recipe["lr0_eff"] == 3e-4 and recipe["lr1_eff"] == 3e-5
    assert recipe["lr_decay_start"] == 0.5 and recipe["lr_shape"] == "cosine"
    assert recipe["ent_floor"] == 10.0 and recipe["ent_every"] == 3
    for outcome in ("greedy_return", "train_s", "frames_per_s", "eval_episodes",
                    "final_train_return", "ent_mult_final"):
        assert outcome not in recipe, outcome
    rows = [json.loads(l) for l in jsonl.read_text().splitlines()]
    assert [row["update"] for row in rows] == [1, 2, 4, 6]
    assert all("entropy" in row and "loss" in row for row in rows)
    # cosine decay: lr constant through the first half, lower at the end
    assert rows[1]["lr"] == 3e-4
    assert rows[-1]["lr"] == pytest.approx(3e-5)
    # cli/evaluate.py restores the recorded best step
    net = PPO(bench.make_bench_env(device="cpu"),
              PPOConfig(torso="mlp", mlp_width=32)).make_net(torch.Generator())
    CheckpointManager(str(ckpt)).restore_params(net, step=meta["best_step"])


def test_sweep_eval_kept_requires_periodic_checkpoints(capsys):
    with pytest.raises(SystemExit) as e:
        sweep_ppo.main(["--configs", "base", "--updates", "2", "--device", "cpu",
                        "--eval-kept"])
    assert e.value.code != 0
    assert "--eval-kept requires" in capsys.readouterr().err


def test_sweep_entropy_floor_controller_raises_coef(tmp_path, capsys):
    """An unreachable floor drives the multiplier to the cap; each row
    holds the multiplier its update ran with (``entropy_coef`` = it times
    the config's 0.01)."""
    jsonl = tmp_path / "m.jsonl"
    recs, err = sweep(["--configs", "base"] + TINY + [
        "--log-every", "2", "--ent-floor", "10.0", "--ent-adapt", "5.0",
        "--ent-max-mult", "7.5", "--metrics-jsonl", str(jsonl)], capsys)
    assert recs[0]["ent_floor"] == 10.0
    assert recs[0]["ent_mult_final"] == 7.5  # hit the cap
    assert "ent_mult" in err
    rows = [json.loads(l) for l in jsonl.read_text().splitlines()]
    assert [r["ent_mult"] for r in rows] == [1.0, 7.5, 7.5, 7.5]
    assert all(r["entropy_coef"] == r["ent_mult"] * 0.01 for r in rows)


def test_sweep_kl_adaptive_clip_controller(tmp_path, capsys):
    common = ["--configs", "base"] + TINY + [
        "--log-every", "2", "--kl-adapt", "2.0", "--kl-min-mult", "0.125",
        "--kl-max-mult", "8.0"]
    # unreachably high target: every firing sees kl < target/2 -> the cap
    jsonl = tmp_path / "m.jsonl"
    recs, err = sweep(common + ["--kl-target", "1000.0", "--metrics-jsonl",
                                str(jsonl)], capsys)
    assert recs[0]["kl_target"] == 1000.0 and recs[0]["clip_mult_final"] == 8.0
    assert "clip_mult" in err
    # each row holds the multiplier its update ran with
    rows = [json.loads(l) for l in jsonl.read_text().splitlines()]
    assert [r["clip_mult"] for r in rows] == [1.0, 2.0, 4.0, 8.0]
    assert all(r["clip_eps"] == r["clip_mult"] * 0.2 for r in rows)
    # unreachably low target: every firing sees kl > 2*target -> the floor
    recs, _ = sweep(common + ["--kl-target", "1e-12"], capsys)
    assert recs[0]["clip_mult_final"] == 0.125


def jax_metric_names():
    """The keys of JAX's ``PPO.update`` metrics (traced, not compiled)."""
    cfg = JPPOConfig(num_envs=8, rollout_len=2, torso="mlp", mlp_width=16, hidden=16)
    jppo = JPPO(jax_make_env(jcfg.default_config()), cfg)
    state = jax.eval_shape(jppo.init, jax.random.key(0))
    _, metrics = jax.eval_shape(jppo.update, state, jax_hypers(cfg))
    return set(metrics)


def test_metrics_rows_compare_with_compare_metrics(tmp_path, capsys):
    """Two same-seed streams are identical under the unchanged
    ``scripts/compare_metrics.py`` (exit 0), two seeds are not (exit 1);
    a row's fields are the JAX sweep's."""
    streams = {}
    for name, seed in (("a", 0), ("b", 0), ("c", 1)):
        streams[name] = tmp_path / f"{name}.jsonl"
        sweep(["--configs", "base", "--updates", "3", "--log-every", "1", "--seed",
               str(seed), "--num-envs", "16", "--rollout-len", "4", "--eval-envs", "4",
               "--eval-steps", "8", "--device", "cpu", "--torso", "mlp", "--mlp-width",
               "32", "--metrics-jsonl", str(streams[name])], capsys)
    rows = [json.loads(l) for l in streams["a"].read_text().splitlines()]
    assert [r["update"] for r in rows] == [1, 2, 3]
    hyper = {"config", "update", "ent_mult", "lr", "entropy_coef", "clip_mult",
             "clip_eps"}
    assert set(rows[0]) == hyper | jax_metric_names()

    def compare(x, y):
        return subprocess.run(
            [sys.executable, str(REPO / "scripts" / "compare_metrics.py"),
             str(streams[x]), str(streams[y])],
            capture_output=True, text=True, timeout=120)

    same = compare("a", "b")
    assert same.returncode == 0, same.stdout
    assert "IDENTICAL on 3 common rows" in same.stdout
    other = compare("a", "c")
    assert other.returncode == 1 and "DEVICE MATH diverges" in other.stdout


# ------------------------------------------------------------- quickstart ----


def test_quickstart_gymnasium_sections(capsys):
    quickstart.single_env()
    quickstart.vector_env("cpu")
    out = capsys.readouterr().out
    assert "single env final board:" in out
    assert "vector env: mean reward/step" in out


def test_quickstart_engine_and_train_sections(capsys):
    quickstart.engine("cpu")
    quickstart.train("cpu")
    out = capsys.readouterr().out
    assert "engine: 100x1024 steps, reward/step" in out
    assert "words sampler: one uniform-legal action per env (N=1024" in out
    assert "update 2: return=" in out
    assert "train:" in out and "python -m blockpuzzle_tpu_torch.bench" in out


def test_quickstart_main_runs_every_section(monkeypatch):
    calls = []
    for name in ("single_env", "vector_env", "engine", "train"):
        monkeypatch.setattr(quickstart, name,
                            lambda *a, name=name: calls.append((name, a)))
    assert quickstart.main(["--device", "cpu"]) == 0
    assert calls == [("single_env", ()), ("vector_env", ("cpu",)),
                     ("engine", ("cpu",)), ("train", ("cpu",))]


@pytest.mark.parametrize("section", ["single_env", "vector_env"])
def test_quickstart_gymnasium_sections_raise_without_gymnasium(section, monkeypatch):
    """Where gymnasium is missing (the card's machine) the Gymnasium
    sections raise ``ImportError``: they never skip quietly."""
    monkeypatch.setitem(sys.modules, "gymnasium", None)
    args = () if section == "single_env" else ("cpu",)
    with pytest.raises(ImportError):
        getattr(quickstart, section)(*args)


# ------------------------------------------------------------- roofline ----

ROOFLINE_COUNT_KEYS = {
    "flops_per_step_env", "bytes_per_step_env", "kernel_bytes_per_step_env",
    "state_bytes_per_step_env", "hbm_floor_us_per_batched_step",
    "hbm_bound_steps_per_s", "core_ops_floor_us_per_batched_step",
    "core_bound_steps_per_s", "state_floor_us_per_batched_step"}
ROOFLINE_TIMED_KEYS = {
    "measured_steps_per_s", "measured_us_per_batched_step", "pct_of_hbm_bound",
    "pct_of_core_bound", "pct_of_state_bound"}
ROOFLINE_ARGV = ["--device", "cpu", "--num-envs", "32", "--chunk", "8"]


def test_roofline_contract_untimed(capsys):
    (rec,), _ = run(roofline, ROOFLINE_ARGV + ["--no-time"], capsys)
    assert set(rec) == {"metric", "num_envs", "chunk", "mask_impl", "device",
                        "kernel_launches_per_step"} | ROOFLINE_COUNT_KEYS
    assert (rec["metric"], rec["num_envs"], rec["chunk"], rec["mask_impl"],
            rec["device"]) == ("roofline", 32, 8, "bitboard", "cpu")
    assert all(rec[k] > 0 for k in ROOFLINE_COUNT_KEYS)
    # the packed step: B1, B7, the tail (B10), the deal (B9) and the argmax
    # draw (B2) once a step
    assert rec["kernel_launches_per_step"] == {"packed_apply": 1.0, "packed_mask": 1.0,
                                               "packed_tail": 1.0, "deal": 1.0,
                                               "uniform_legal": 1.0}
    assert rec["bytes_per_step_env"] > rec["kernel_bytes_per_step_env"]
    # floor = bytes of one batched step of N envs over 3.35 TB/s
    assert rec["hbm_floor_us_per_batched_step"] == pytest.approx(
        1e6 * rec["bytes_per_step_env"] * 32 / 3.35e12)
    assert rec["hbm_bound_steps_per_s"] == pytest.approx(
        32 / (1e-6 * rec["hbm_floor_us_per_batched_step"]))


def test_roofline_contract_timed(capsys):
    (rec,), err = run(roofline, ROOFLINE_ARGV + ["--iters", "1", "--windows", "2"],
                      capsys)
    assert ROOFLINE_COUNT_KEYS | ROOFLINE_TIMED_KEYS <= set(rec)
    assert all(rec[k] > 0 for k in ROOFLINE_COUNT_KEYS | ROOFLINE_TIMED_KEYS)
    assert all(0 < rec[k] <= 100 for k in ROOFLINE_TIMED_KEYS if k.startswith("pct"))
    assert rec["measured_us_per_batched_step"] == pytest.approx(
        1e6 * 32 / rec["measured_steps_per_s"])
    assert "says nothing of the card" in err


def test_roofline_state_floor_is_the_state_fields_bytes():
    """Default preset: a state of (10,) int64 row words, (1,) int32 queue,
    int64 key, int32 counter, steps and streak, float32 score, read and
    written; an int64 action in; 100 mask bools, a float32 reward and two
    done bools out."""
    env = bench.make_bench_env(device="cpu")
    state, _ = env.init(0, 4)
    fields = sum(getattr(state, f).element_size() * getattr(state, f)[0].numel()
                 for f in ("board", "queue", "base_key", "rng_counter", "steps",
                           "score", "streak"))
    assert fields == 80 + 4 + 8 + 4 + 4 + 4 + 4
    c = roofline.count_chunk(env, 4, 2)
    assert c.state_bytes / 4 == 2 * fields + 8 + 100 + 4 + 1 + 1 == 330


def test_roofline_count_is_independent_of_the_batch():
    """... but for the tail's (P + 1, HW) empty-board table, read once a
    call whatever the batch (20 x 100 bytes on the default preset)."""
    env = bench.make_bench_env(device="cpu")
    small, large = (roofline.roofline(env, n, 8, timed=False) for n in (32, 64))
    table = env.packed_tail_kernel.empty_legal.numel()
    assert table == 2000
    for k, share in (("bytes_per_step_env", table), ("flops_per_step_env", 0)):
        assert large[k] - share / 64 == pytest.approx(small[k] - share / 32, rel=1e-2), k
    assert (small["kernel_bytes_per_step_env"] - table / 32
            == large["kernel_bytes_per_step_env"] - table / 64)


def test_counted_kernel_hides_its_plain_ops_and_adds_its_bytes():
    """On the CPU a kernel wrapper runs its plain version as torch ops:
    unwrapped, the mode counts them; wrapped, it counts none of them and
    adds the call's bytes and operations from ``utils/bounds.py``.  The
    roofline's kernel bytes are B1's plus B7's plus the tail's (B10) plus
    the deal's (B9) plus the argmax draw's (B2)."""
    env = bench.make_bench_env(device="cpu")
    cfg, n = env.cfg, 32
    words = torch.randint(0, 1 << 10, (n, cfg.height), dtype=torch.int64)
    queue = torch.randint(0, 20, (n, cfg.queue_size), dtype=torch.int32)
    bare = roofline.OpCounter()
    with bare:
        want = env.packed_mask_kernel(words, queue)
    assert bare.torch_calls > 0 and bare.torch_bytes > 0
    counter = roofline.OpCounter()
    kernel = env.packed_mask_kernel
    with roofline.counted_kernels(env, counter), counter:
        got = env.packed_mask_kernel(words, queue)
        assert env.packed_mask_kernel.cfg is cfg      # other attributes pass through
    assert env.packed_mask_kernel is kernel           # restored
    assert torch.equal(got, want)
    assert (counter.torch_calls, counter.torch_bytes, counter.torch_ops) == (0, 0, 0)
    assert (counter.kernel_bytes, counter.kernel_ops) == COSTS["packed_mask"](
        cfg, (words, queue), (want,))
    assert counter.launches == {"packed_mask": 1}

    rec = roofline.roofline(env, n, 4, timed=False)
    attrs = torch.zeros((n, 11), dtype=torch.int32)
    rc = torch.zeros(n, dtype=torch.int32)
    valid = torch.zeros(n, dtype=torch.bool)
    b1, _ = COSTS["packed_apply"](cfg, (words, attrs, rc, rc, valid),
                                  env.packed_apply_kernel(words, attrs, rc, rc, valid))
    b7, _ = COSTS["packed_mask"](cfg, (words, queue), (want,))
    key, counter = torch.zeros(n, dtype=torch.int64), torch.zeros(n, dtype=torch.int32)
    b9, _ = COSTS["deal"](cfg, (key, counter, 0, 2), (env.deal_kernel(key, counter, 0, 2),))
    mask = torch.ones((n, env.num_actions), dtype=torch.bool)
    b2, _ = COSTS["uniform_legal"](cfg, (key, 0, mask), (torch.zeros(n, dtype=torch.int64),))
    f32, i32 = torch.zeros(n), torch.zeros(n, dtype=torch.int32)
    q = torch.zeros((n, 1), dtype=torch.int32)
    tail_in = (words, want, f32, q, q, i32, f32, i32, i32, True)
    b10, _ = COSTS["packed_tail"](cfg, tail_in, env.packed_tail_kernel(*tail_in))
    # the tail: 622 B an env and its 2000-byte table once a call
    assert rec["kernel_bytes_per_step_env"] == (b1 + b7 + b10 + b9 + b2) / n == (
        218 + 184 + 622 + 2000 / n + 20 + 116)


COUNTED_ENGINES = {
    "packed": (dict(), "default", ("packed_apply", "packed_mask", "packed_tail")),
    "u8_pallas": (dict(backend="pallas", state_impl="u8"), "default", ("mask", "apply")),
    "u8_jnp": (dict(backend="jnp", state_impl="u8"), "tenten", ("mask", "clear")),
    # a board of 40 cells a row: the wide mask, clear and apply
    "wide_u8_pallas": (dict(backend="pallas"), "wide", ("mask_wide", "apply_wide")),
    "wide_u8_jnp": (dict(backend="jnp"), "wide", ("mask_wide", "clear_wide")),
    # a board of 33 rows: the tall mask and clear on u8 boards, the tall
    # packed apply and mask on the default (packed) engine
    "tall_u8_jnp": (dict(backend="jnp", state_impl="u8"), "tall",
                    ("mask_tall", "clear_tall")),
    "tall_u8_pallas": (dict(backend="pallas", state_impl="u8"), "tall",
                       ("mask_tall", "apply_tall")),
    "tall_packed": (dict(), "tall", ("packed_apply_tall", "packed_mask_tall",
                                     "packed_tail")),
    # a board of 130 rows: the deep u8 mask, clear and apply, the general
    # packed kernels
    "huge_u8_jnp": (dict(backend="jnp", state_impl="u8"), "huge",
                    ("mask_deep", "clear_deep")),
    "huge_u8_pallas": (dict(backend="pallas", state_impl="u8"), "huge",
                       ("mask_deep", "apply_deep")),
    "huge_packed": (dict(), "huge", ("packed_apply_general", "packed_mask_general",
                                     "packed_tail")),
}
BOARDS = {"wide": dict(height=8, width=40), "tall": dict(height=33, width=9),
          "huge": dict(height=130, width=9)}
# every engine's step deals once (B9) and its argmax policy draws once (B2)
DRAW_KERNELS = ("deal", "uniform_legal")


@pytest.mark.parametrize("engine", COUNTED_ENGINES)
def test_count_chunk_counts_each_step_kernel_once_a_step(engine):
    from blockpuzzle_tpu_torch import PRESETS, make_env
    from blockpuzzle_tpu_torch.config import EnvConfig

    kwargs, preset, kernels = COUNTED_ENGINES[engine]
    cfg = EnvConfig(**BOARDS[preset]) if preset in BOARDS else PRESETS[preset]()
    env = make_env(cfg, device="cpu", **kwargs)
    c = roofline.count_chunk(env, 16, 3)
    assert c.launches == dict.fromkeys(kernels + DRAW_KERNELS, 3)
    assert c.torch_ops > 0 and c.kernel_bytes > 0 and c.kernel_ops > 0
    assert sum(c.op_bytes.values()) == c.torch_bytes


# -------------------------------------------------------- bench_scaling ----


def test_bench_scaling_world2_equals_one_process():
    """Two gloo ranks of 16 envs each: their final states, gathered in rank
    order, bit-equal to one process stepping all 32; one rank of 16 to one
    process of 16."""
    r = bench_scaling.run([1, 2], "cpu", 16, 4, 1, gather=True)
    assert list(r["steps_per_s"]) == [1, 2]
    assert all(v > 0 for v in r["steps_per_s"].values())
    assert [[(x["backend"], x["device"]) for x in r["ranks"][d]] for d in (1, 2)] == [
        [("gloo", "cpu")], [("gloo", "cpu")] * 2]
    for d in (1, 2):
        want = bench_scaling.unsharded_state("cpu", 16 * d, 4, 1)
        got = r["states"][d]
        for f in vars(want):
            assert torch.equal(getattr(got, f), getattr(want, f)), (d, f)
    assert int(want.steps.max()) > 0 and int(want.score.sum()) > 0
    lines = bench_scaling.report(r)
    assert lines[0].startswith("devices=1:") and "efficiency vs linear: 100.0%" in lines[0]
    rec = json.loads(lines[-1])
    assert rec["metric"] == "scaling_efficiency" and rec["devices"] == [1, 2]
    assert set(rec["steps_per_s"]) == {"1", "2"}


def test_bench_scaling_cpu_sim_runs_eight_ranks(capsys):
    assert bench_scaling.main(["--cpu-sim", "--envs-per-device", "16", "--chunk", "4",
                               "--iters", "1"]) == 0
    out = capsys.readouterr().out
    (rec,) = json_lines(out)
    assert rec["metric"] == "scaling_efficiency" and rec["devices"] == [1, 2, 4, 8]
    assert set(rec["steps_per_s"]) == {"1", "2", "4", "8"}
    assert all(v > 0 for v in rec["steps_per_s"].values())
    assert [line.split(":")[0] for line in out.splitlines()
            if line.startswith("devices=")] == [f"devices={d}" for d in (1, 2, 4, 8)]
