"""The port's PPO learner on the CPU against ``blockpuzzle_tpu.learn``.

Small widths (mlp_width 64, channels (4, 8), hidden 32, N = 16, T = 8),
for the mlp torso with the embedded hand and for the conv/embed,
conv/planes and mlp/planes variants.  The JAX network's
flax parameters are carried into the port with ``params_from_flax``; the
inputs are numpy arrays from a seed, handed to both.  Tolerances, with the
largest error measured on the CPU (torch 2.13, jax 0.9.0) beside each:

* masked logits: masked entries equal ``NEG_INF`` exactly; the others and
  the values within abs 2e-2, for the bf16 layers (measured 2.4e-7 and
  6.0e-8: on the CPU both frameworks round the bf16 products alike);
* ``log_prob`` and ``masked_entropy`` on given logits within 1e-6
  (measured 2.4e-7 and 4.8e-7);
* ``_gae`` within 1e-5 (measured 0, both batches);
* ``_loss`` and its metrics within 1e-2 relative (measured 1.5e-7);
* gradients within 2e-2 relative L2 per tensor (measured 4.5e-3: the bf16
  layers' backward rounds differently), but the conv biases within 1e-1
  (measured 5.7e-2): flax's bf16 conv sums a bias's B*H*W cotangents in
  bf16 on the CPU, 5.0e-2 off their exact sum on a (64, 10, 10, 8)
  output, while the port sums them in float32 (0.09% off, its bf16
  rounding);
* two optimizer steps against optax within 1e-6 (measured 6.0e-8);
* each initialised tensor's std within 10% of flax's (measured 1.1%).

Sampling draws from a ``torch.Generator``, whose bits differ from JAX's
keys: it is held by legality and distribution, not by bits.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from blockpuzzle_tpu import config as jcfg
from blockpuzzle_tpu.env import make_env as jax_make_env
from blockpuzzle_tpu.learn import networks as jnet
from blockpuzzle_tpu.learn.ppo import Batch as JBatch
from blockpuzzle_tpu.learn.ppo import PPO as JPPO
from blockpuzzle_tpu.learn.ppo import PPOConfig as JPPOConfig
from blockpuzzle_tpu_torch import config as tcfg
from blockpuzzle_tpu_torch.cli import train as train_cli
from blockpuzzle_tpu_torch.env import make_env
from blockpuzzle_tpu_torch.interop import params_from_flax
from blockpuzzle_tpu_torch.learn import networks as tnet
from blockpuzzle_tpu_torch.learn.ppo import PPO, Batch, PPOConfig, optimizer_step

N, T = 16, 8
KW = dict(num_envs=N, rollout_len=T, hidden=32, mlp_width=64, torso="mlp",
          num_epochs=1, num_minibatches=2)
METRICS = ("loss", "policy_loss", "value_loss", "entropy", "approx_kl")


@pytest.fixture(scope="module")
def pair():
    """A JAX and a torch learner holding the same flax parameters."""
    jppo = JPPO(jax_make_env(jcfg.default_config(), state_impl="u8"),
                JPPOConfig(**KW))
    tppo = PPO(make_env(tcfg.default_config(), device="cpu", state_impl="u8"),
               PPOConfig(**KW))
    params = jax.jit(jppo.net.init)(
        jax.random.key(0), jnp.zeros((1, 10, 10), jnp.uint8),
        jnp.zeros((1, 1), jnp.int32), jnp.ones((1, 100), bool))
    net = tppo.make_net(torch.Generator().manual_seed(0))
    net.load_state_dict(params_from_flax(params))
    return jppo, tppo, params, net


def observations(n, seed):
    """Random boards, hands (sentinel included) and masks with at least
    one legal action per row."""
    r = np.random.default_rng(seed)
    board = (r.random((n, 10, 10)) < 0.4).astype(np.uint8)
    queue = r.integers(0, 20, (n, 1)).astype(np.int32)
    mask = r.random((n, 100)) < 0.3
    mask[:, 7] = True
    return board, queue, mask


def minibatch(seed, jppo, params):
    """A fixed minibatch: observations, legal actions, old log-probs near
    the JAX network's, advantages and returns."""
    r = np.random.default_rng(seed)
    n = 64
    board, queue, mask = observations(n, seed)
    action = np.array([r.choice(np.flatnonzero(m)) for m in mask], np.int32)
    logits, _ = jppo.net.apply(params, board, queue, mask)
    old = np.asarray(jnet.log_prob(logits, jnp.asarray(action)))
    old = (old + r.normal(0, 0.1, n)).astype(np.float32)
    adv = r.normal(0.5, 2.0, n).astype(np.float32)
    ret = r.normal(40.0, 10.0, n).astype(np.float32)
    fields = dict(board=board, queue=queue, action_mask=mask, action=action,
                  log_prob=old)
    zeros = np.zeros(n, np.float32)
    rest = dict(value=zeros, reward=zeros, done=zeros.astype(bool),
                terminated=zeros.astype(bool), final_value=zeros)
    jmb = JBatch(**{k: jnp.asarray(v) for k, v in {**fields, **rest}.items()})
    tmb = Batch(**{k: torch.as_tensor(v) for k, v in {**fields, **rest}.items()})
    return jmb, tmb, adv, ret


def test_masked_logits_and_values_match_flax(pair):
    jppo, _, params, net = pair
    board, queue, mask = observations(64, 1)
    lj, vj = (np.asarray(x) for x in jppo.net.apply(params, board, queue, mask))
    with torch.no_grad():
        lt, vt = (x.numpy() for x in net(
            torch.as_tensor(board), torch.as_tensor(queue), torch.as_tensor(mask)))
    assert (lt[~mask] == tnet.NEG_INF).all() and (lj[~mask] == jnet.NEG_INF).all()
    np.testing.assert_allclose(lt[mask], lj[mask], rtol=0, atol=2e-2)
    np.testing.assert_allclose(vt, vj, rtol=0, atol=2e-2)
    assert np.abs(lj[mask]).max() > 0.1  # not a trivially small output


def test_log_prob_and_entropy_on_given_logits():
    r = np.random.default_rng(2)
    logits = r.normal(0, 2, (32, 100)).astype(np.float32)
    mask = r.random((32, 100)) < 0.2
    mask[:, 3] = True
    logits = np.where(mask, logits, np.float32(jnet.NEG_INF)).astype(np.float32)
    action = np.array([r.choice(np.flatnonzero(m)) for m in mask], np.int32)
    lj = np.asarray(jnet.log_prob(jnp.asarray(logits), jnp.asarray(action)))
    lt = tnet.log_prob(torch.as_tensor(logits), torch.as_tensor(action)).numpy()
    np.testing.assert_allclose(lt, lj, rtol=0, atol=1e-6)
    ej = np.asarray(jnet.masked_entropy(jnp.asarray(logits)))
    et = tnet.masked_entropy(torch.as_tensor(logits)).numpy()
    np.testing.assert_allclose(et, ej, rtol=0, atol=1e-6)


@pytest.mark.parametrize("truncating", [False, True], ids=["terminal", "truncating"])
def test_gae_matches(pair, truncating):
    """A truncating config (max_steps > 0) fills ``final_value`` and has
    done steps that did not terminate; the other only terminates."""
    jppo, tppo, _, _ = pair
    r = np.random.default_rng(3)
    shape = (T, N)
    reward = r.normal(1.0, 2.0, shape).astype(np.float32)
    value = r.normal(30.0, 5.0, shape).astype(np.float32)
    terminated = r.random(shape) < 0.1
    done = terminated | ((r.random(shape) < 0.1) if truncating else False)
    final_value = np.where(done & ~terminated, r.normal(20.0, 5.0, shape), 0.0)
    last_value = r.normal(30.0, 5.0, N).astype(np.float32)
    fields = dict(reward=reward, value=value, done=done, terminated=terminated,
                  final_value=final_value.astype(np.float32))
    dummy = {k: np.zeros(shape, np.int32) for k in
             ("board", "queue", "action_mask", "action", "log_prob")}
    aj, rj = jppo._gae(JBatch(**{k: jnp.asarray(v) for k, v in
                                 {**fields, **dummy}.items()}),
                       jnp.asarray(last_value))
    at, rt = tppo._gae(Batch(**{k: torch.as_tensor(v) for k, v in
                                {**fields, **dummy}.items()}),
                       torch.as_tensor(last_value))
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), rtol=0, atol=1e-5)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=0, atol=1e-5)
    assert (done & ~terminated).any() == truncating


def test_loss_metrics_and_grads_match(pair):
    jppo, tppo, params, net = pair
    jmb, tmb, adv, ret = minibatch(4, jppo, params)
    grads_j, mj = jax.grad(jppo._loss, has_aux=True)(
        params, jmb, jnp.asarray(adv), jnp.asarray(ret))
    net.zero_grad(set_to_none=True)
    loss, mt = tppo._loss(net, tmb, torch.as_tensor(adv), torch.as_tensor(ret))
    loss.backward()
    for k in METRICS:
        np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=1e-2,
                                   atol=1e-6, err_msg=k)
    assert float(mt["loss"]) == loss.item()
    want = params_from_flax(grads_j)
    for name, p in net.named_parameters():
        g, w = p.grad.numpy(), want[name].numpy()
        rel = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-12)
        conv_bias = name.startswith("torso.convs.") and name.endswith(".bias")
        assert rel <= (1e-1 if conv_bias else 2e-2), (name, rel)


@pytest.mark.parametrize("scale", [10.0, 1e-3], ids=["clipped", "unclipped"])
def test_optimizer_steps_match_optax(pair, scale):
    """Two steps (the second takes Adam's state from the first) from given
    gradients: global-norm clip at 0.5, Adam, ``-lr * u``."""
    jppo, tppo, params, _ = pair
    net = tppo.make_net(torch.Generator().manual_seed(1))
    net.load_state_dict(params_from_flax(params))
    opt = tppo.make_optimizer(net)
    opt_state = jppo.tx.init(params)
    r = np.random.default_rng(5)
    for lr in (3e-4, 1e-3):
        grads = jax.tree.map(
            lambda x: jnp.asarray(r.normal(0, scale, x.shape), jnp.float32),
            params)
        updates, opt_state = jppo.tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, jax.tree.map(lambda u: -lr * u, updates))
        tgrads = params_from_flax(grads)
        for name, p in net.named_parameters():
            p.grad = tgrads[name].clone()
        optimizer_step(opt, tppo.cfg.max_grad_norm, lr)
    want = params_from_flax(params)
    for name, p in net.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=0, atol=1e-6, err_msg=name)


def test_gradients_sum_rows_in_float32(pair):
    """One row repeated 4096 times has 4096 times its gradient: each
    parameter's gradient sums its rows in float32 (a bf16 sum stalls once
    the total is 256 times a row's term)."""
    _, _, _, net = pair
    board, queue, mask = (torch.as_tensor(x) for x in observations(1, 8))
    grads = []
    for rows in (1, 4096):
        net.zero_grad(set_to_none=True)
        logits, value = net(*(x.expand(rows, *x.shape[1:]) for x in (board, queue, mask)))
        (value.sum() + torch.where(mask, logits, 0.0).sum()).backward()
        grads.append({n: p.grad.clone() for n, p in net.named_parameters()})
    for name, g in grads[1].items():
        torch.testing.assert_close(g, 4096 * grads[0][name], rtol=1e-3,
                                   atol=1e-6, msg=name)


def test_init_std_matches_flax(pair):
    """Per tensor, the std over 32 seeds; biases start at zero in both."""
    jppo, tppo, _, _ = pair
    init = jax.jit(jax.vmap(lambda k: jppo.net.init(
        k, jnp.zeros((1, 10, 10), jnp.uint8), jnp.zeros((1, 1), jnp.int32),
        jnp.ones((1, 100), bool))))
    flax_params = params_from_flax(
        init(jax.random.split(jax.random.key(7), 32)))
    nets = [tppo.make_net(torch.Generator().manual_seed(s)) for s in range(32)]
    for name, want in flax_params.items():
        got = torch.stack([dict(n.named_parameters())[name].detach() for n in nets])
        if name.endswith("bias"):
            assert not want.any() and not got.any(), name
            continue
        ratio = float(got.std()) / float(want.std())
        assert abs(ratio - 1) < 0.1, (name, ratio)
        assert float(got.abs().max()) <= 2.0 * float(want.abs().max()), name


def test_masked_categorical_is_legal_and_follows_softmax():
    r = np.random.default_rng(6)
    logits = np.full((1, 40), tnet.NEG_INF, np.float32)
    legal = np.arange(0, 40, 4)
    logits[0, legal] = r.normal(0, 1, legal.size)
    x = torch.as_tensor(logits).expand(20000, 40)
    gen = torch.Generator().manual_seed(0)
    picks = tnet.masked_categorical(x, gen)
    assert np.isin(picks.numpy(), legal).all()
    counts = np.bincount(picks.numpy(), minlength=40)[legal]
    p = np.exp(logits[0, legal] - logits[0, legal].max())
    expect = 20000 * p / p.sum()
    chi2 = float(((counts - expect) ** 2 / expect).sum())
    assert chi2 < 27.88  # chi-square, 9 degrees of freedom, 99.9%
    again = tnet.masked_categorical(x, torch.Generator().manual_seed(0))
    assert torch.equal(picks, again)


@pytest.mark.parametrize("shuffle", ["roll", "perm", "none"])
def test_epoch_order(shuffle):
    env = make_env(tcfg.default_config(), device="cpu", state_impl="u8")
    ppo = PPO(env, PPOConfig(**{**KW, "shuffle": shuffle}))
    order = ppo._epoch_order(128, torch.Generator().manual_seed(3)).numpy()
    assert sorted(order) == list(range(128))
    if shuffle == "roll":
        shift = int(torch.randint(0, 128, (), generator=torch.Generator().manual_seed(3)))
        np.testing.assert_array_equal(order, np.roll(np.arange(128), shift))
    if shuffle == "none":
        np.testing.assert_array_equal(order, np.arange(128))
    with pytest.raises(ValueError, match="shuffle"):
        PPO(env, PPOConfig(shuffle="sorted"))


def test_update_runs_and_changes_params():
    """One update through the jnp-backend engine on the CPU, with a
    truncating config (so the rollout values the final observations)."""
    cfg = dataclasses.replace(tcfg.default_config(), max_steps=5)
    ppo = PPO(make_env(cfg, device="cpu", state_impl="u8"), PPOConfig(**KW))
    state = ppo.init(0)
    before = [p.detach().clone() for p in state.net.parameters()]
    state, metrics = ppo.update(state)
    assert state.update_count == 1
    assert set(metrics) == set(METRICS) | {
        "episode_return", "episode_length", "episodes_finished",
        "lines_per_step", "illegal_action_rate", "reward_per_step"}
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert float(metrics["illegal_action_rate"]) == 0.0
    assert float(metrics["episodes_finished"]) >= N  # every env hits max_steps
    assert any(not torch.equal(a, b) for a, b in zip(before, state.net.parameters()))
    assert int(state.env_state.rng_counter[0]) == 1 + T


def test_train_cli_two_updates_on_cpu(capsys):
    args = train_cli.build_parser().parse_args([
        "--torso", "mlp", "--state-impl", "u8", "--updates", "2",
        "--num-envs", str(N), "--rollout-len", str(T), "--mlp-width", "64",
        "--log-every", "1", "--device", "cpu", "--entropy-final", "0.0"])
    learner = train_cli.build(args)
    r = train_cli.train(args, learner)
    assert np.isfinite(r["metrics"]["loss"]) and r["state"].update_count == 2
    assert learner.env.backend == "jnp"
    lines = capsys.readouterr().out.strip().splitlines()
    assert [l.split(":")[0] for l in lines] == ["update 1", "update 2"]
    assert all(" loss=" in l and l.endswith("M") for l in lines)
    assert train_cli.ppo_hypers(args, 1)["entropy_coef"] == 0.0


@pytest.mark.parametrize("flags,item", [(["--algo", "dqn"], "A10")])
def test_train_cli_names_what_is_not_ported(flags, item):
    argv = flags + ["--device", "cpu"]
    with pytest.raises(NotImplementedError, match=item):
        train_cli.build(train_cli.build_parser().parse_args(argv))


@pytest.mark.parametrize("flags,state_impl,arch,queue_mode", [
    ([], "packed", "conv", "embed"),                  # the JAX CLI's defaults
    (["--queue-mode", "planes"], "packed", "conv", "planes"),
    (["--torso", "mlp", "--state-impl", "auto"], "packed", "mlp", "embed"),
    (["--torso", "mlp", "--state-impl", "packed"], "packed", "mlp", "embed"),
    (["--torso", "conv", "--state-impl", "u8"], "u8", "conv", "embed"),
], ids=["defaults", "planes", "auto", "packed", "conv-u8"])
def test_train_cli_builds_what_the_flags_ask(flags, state_impl, arch, queue_mode):
    """The engine and torso each flag set asks for, and one update of it on
    the CPU."""
    args = train_cli.build_parser().parse_args(flags + [
        "--updates", "1", "--num-envs", "8", "--rollout-len", "4",
        "--mlp-width", "32", "--device", "cpu"])
    learner = train_cli.build(args)
    assert (learner.env.state_impl, learner.env.backend) == (state_impl, "jnp")
    torso = learner.make_net(torch.Generator().manual_seed(0)).torso
    assert (torso.arch, torso.queue_mode) == (arch, queue_mode)
    if arch == "conv":
        assert [c.out_channels for c in torso.convs] == [32, 64]
    r = train_cli.train(args, learner)
    assert np.isfinite(r["metrics"]["loss"]) and r["state"].update_count == 1


def test_params_from_flax_rejects_other_trees(pair):
    _, _, params, _ = pair
    inner = dict(params["params"])
    with pytest.raises(ValueError, match="mlp/embed"):
        params_from_flax({k: v for k, v in inner.items() if k != "MXUDense_1"})


# ------------------------------------------------------------------------
# the conv torso and the planes hand
# ------------------------------------------------------------------------

VARIANTS = {"conv-embed": ("conv", "embed"), "conv-planes": ("conv", "planes"),
            "mlp-planes": ("mlp", "planes")}


def _arch_kw(variant):
    torso, queue_mode = VARIANTS[variant]
    return {**KW, "torso": torso, "queue_mode": queue_mode, "channels": (4, 8)}


@pytest.fixture(scope="module", params=list(VARIANTS))
def arch_pair(request):
    """A JAX and a torch learner with a conv torso or a planes hand on
    their default (packed) engines, holding the same flax parameters."""
    kw = _arch_kw(request.param)
    jppo = JPPO(jax_make_env(jcfg.default_config()), JPPOConfig(**kw))
    tppo = PPO(make_env(tcfg.default_config(), device="cpu"), PPOConfig(**kw))
    assert tppo.env.state_impl == "packed"
    params = jax.jit(jppo.net.init)(
        jax.random.key(1), jnp.zeros((1, 10, 10), jnp.uint8),
        jnp.zeros((1, 1), jnp.int32), jnp.ones((1, 100), bool))
    net = tppo.make_net(torch.Generator().manual_seed(0))
    net.load_state_dict(params_from_flax(params))
    return jppo, tppo, params, net


def test_arch_logits_and_values_match_flax(arch_pair):
    """A wrong conv kernel layout or flatten order still gives finite
    logits; only this comparison catches it."""
    test_masked_logits_and_values_match_flax(arch_pair)


def test_arch_loss_metrics_and_grads_match(arch_pair):
    test_loss_metrics_and_grads_match(arch_pair)


def test_arch_init_std_matches_flax(arch_pair):
    test_init_std_matches_flax(arch_pair)


def test_params_from_flax_checks_each_arch(arch_pair):
    """Conv kernels (3, 3, in, out) become (out, in, 3, 3); a tree missing
    one parameter of its architecture is refused, naming it."""
    _, tppo, params, net = arch_pair
    got = params_from_flax(params)
    assert set(got) == set(net.state_dict())
    for name, p in net.state_dict().items():
        assert got[name].shape == p.shape, name
    if tppo.cfg.torso == "conv":
        kernel = np.asarray(params["params"]["Torso_0"]["Conv_1"]["kernel"])
        np.testing.assert_array_equal(
            got["torso.convs.1.weight"][5, 2].numpy(), kernel[:, :, 2, 5])
    torso = dict(params["params"]["Torso_0"])
    torso.pop("hidden_proj")
    with pytest.raises(ValueError, match=f"{tppo.cfg.torso}/{tppo.cfg.queue_mode}"):
        params_from_flax({**params["params"], "Torso_0": torso})


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_arch_update_on_the_packed_engine(variant):
    """One update of each torso/hand variant through the packed engine on
    the CPU, with a truncating config, as ``test_update_runs_and_changes_params``."""
    cfg = dataclasses.replace(tcfg.default_config(), max_steps=5)
    ppo = PPO(make_env(cfg, device="cpu"), PPOConfig(**_arch_kw(variant)))
    assert ppo.env.state_impl == "packed"
    state = ppo.init(0)
    before = [p.detach().clone() for p in state.net.parameters()]
    state, metrics = ppo.update(state)
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert float(metrics["illegal_action_rate"]) == 0.0
    assert float(metrics["episodes_finished"]) >= N
    assert all(not torch.equal(a, b) for a, b in zip(before, state.net.parameters()))
