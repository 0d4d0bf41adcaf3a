"""PPO actor-learner on the port's batched engine.

The port of ``blockpuzzle_tpu/learn/ppo.py``: one update is a T-step
rollout driving the engine, GAE over the time axis, and epochs of
clipped-objective minibatch steps.  JAX compiles the update into one
program; here it runs eagerly on the engine's device, and the host never
waits for the device inside it.  The network and the optimizer are
updated in place; ``TrainState`` holds them with the engine state and the
sampling generator.

The optimizer is the JAX package's ``optax.chain(clip_by_global_norm,
scale_by_adam)`` followed by ``-lr * u`` with lr a runtime value:
``optimizer_step`` clips with optax's formula and steps
``torch.optim.Adam`` (the same b1, b2, eps and bias correction) with its
learning rate set for each step.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from blockpuzzle_tpu_torch.env import EnvState, VecBlockPuzzle
from blockpuzzle_tpu_torch.learn import networks
from blockpuzzle_tpu_torch.learn.networks import ActorCritic

SHUFFLES = ("roll", "perm", "none")


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    """PPO hyperparameters: the JAX package's fields and defaults, less
    ``anneal_updates`` (the LR schedule is ``cli/train.py``'s, passed to
    ``PPO.update``) and ``sample_rng_impl`` (a TPU choice)."""

    num_envs: int = 4096
    rollout_len: int = 64
    gamma: float = 0.995
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    value_coef: float = 0.5
    entropy_coef: float = 0.01
    lr: float = 3e-4
    max_grad_norm: float = 0.5
    num_epochs: int = 2
    num_minibatches: int = 4
    # Minibatch order over the flat (T*N) batch, drawn once per epoch:
    # "roll" rotates it by one random shift, "perm" permutes it, "none"
    # keeps it.  Minibatches are consecutive slices of that order.
    shuffle: str = "roll"
    hidden: int = 256
    channels: Tuple[int, ...] = (32, 64)  # conv-torso widths
    torso: str = "conv"  # "conv" | "mlp" (see networks.Torso)
    mlp_width: int = 512
    queue_mode: str = "embed"  # "embed" | "planes" (see networks.Torso)


def default_hypers(cfg: PPOConfig) -> Dict[str, float]:
    """The hyperparameters ``PPO.update`` takes at run time (so the host
    can schedule them), at their config values."""
    return {
        "lr": cfg.lr,
        "entropy_coef": cfg.entropy_coef,
        "clip_eps": cfg.clip_eps,
        "gamma": cfg.gamma,
        "gae_lambda": cfg.gae_lambda,
        "value_coef": cfg.value_coef,
    }


@dataclasses.dataclass
class Batch:
    """One rollout's transitions, time-major (T, N, ...)."""

    board: torch.Tensor
    queue: torch.Tensor
    action_mask: torch.Tensor
    action: torch.Tensor
    log_prob: torch.Tensor
    value: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor
    terminated: torch.Tensor
    # V(final obs) for truncation bootstrapping; zeros when the env config
    # cannot truncate (max_steps == 0)
    final_value: torch.Tensor

    def map(self, fn) -> "Batch":
        return Batch(**{f.name: fn(getattr(self, f.name))
                        for f in dataclasses.fields(self)})


@dataclasses.dataclass
class TrainState:
    """Everything a PPO run carries from one update to the next.

    ``net`` and ``opt`` are updated in place.  ``gen`` (on the engine's
    device) draws the actions and the minibatch order.  The current
    observation is derived from ``env_state`` at rollout start."""

    net: ActorCritic
    opt: torch.optim.Adam
    env_state: EnvState
    gen: torch.Generator
    update_count: int

    def replace(self, **changes) -> "TrainState":
        return dataclasses.replace(self, **changes)


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """``optax.clip_by_global_norm`` in place: every gradient becomes
    ``g / norm * max_norm`` when the global norm reaches ``max_norm`` (no
    epsilon, unlike ``torch.nn.utils.clip_grad_norm_``).  Returns the
    norm; the host does not wait for it."""
    norm = torch.sqrt(sum((g * g).sum() for g in grads))
    for g in grads:
        g.copy_(torch.where(norm < max_norm, g, g / norm * max_norm))
    return norm


def optimizer_step(opt: torch.optim.Adam, max_grad_norm: float, lr: float) -> None:
    """One step from the gradients in the parameters' ``.grad``: the global
    norm clip, then Adam with learning rate ``lr``."""
    params = [p for group in opt.param_groups for p in group["params"]]
    clip_by_global_norm_([p.grad for p in params], max_grad_norm)
    for group in opt.param_groups:
        group["lr"] = lr
    opt.step()


class PPO:
    """PPO over one ``VecBlockPuzzle`` engine, on the engine's device."""

    def __init__(self, env: VecBlockPuzzle, cfg: Optional[PPOConfig] = None):
        self.env = env
        self.cfg = cfg or PPOConfig()
        if self.cfg.shuffle not in SHUFFLES:
            raise ValueError(f"unknown shuffle {self.cfg.shuffle!r}")

    def make_net(self, gen: torch.Generator) -> ActorCritic:
        """A fresh network, initialised from ``gen`` (a CPU generator) and
        moved to the engine's device."""
        cfg = self.cfg
        return ActorCritic(
            self.env.cfg, self.env.num_pieces, gen, channels=cfg.channels,
            hidden=cfg.hidden,
            arch=cfg.torso, mlp_width=cfg.mlp_width, queue_mode=cfg.queue_mode,
        ).to(self.env.device)

    @staticmethod
    def make_optimizer(net: ActorCritic) -> torch.optim.Adam:
        """optax ``scale_by_adam()``'s constants; the lr is set per step."""
        return torch.optim.Adam(net.parameters(), betas=(0.9, 0.999), eps=1e-8)

    # ------------------------------------------------------------------

    def init(self, seed: int) -> TrainState:
        """Engine state from ``seed``'s streams, the network from a CPU
        generator seeded ``2 * seed``, and the device generator of the run
        seeded ``2 * seed + 1``."""
        env_state, _ = self.env.init(seed, self.cfg.num_envs)
        net = self.make_net(torch.Generator().manual_seed(2 * seed))
        gen = torch.Generator(device=self.env.device).manual_seed(2 * seed + 1)
        return TrainState(
            net=net, opt=self.make_optimizer(net), env_state=env_state,
            gen=gen, update_count=0,
        )

    def observe(self, env_state: EnvState):
        """(board3d, queue, action_mask) derived from the env state."""
        board = self.env.board_obs(env_state.board)
        mask = self.env.action_mask(env_state.board, env_state.queue)
        return board, env_state.queue, mask

    # ------------------------------------------------------------------

    @torch.no_grad()
    def _rollout(
        self, state: TrainState
    ) -> Tuple[TrainState, Batch, torch.Tensor, Dict[str, torch.Tensor]]:
        """T-step rollout; returns the batch and the bootstrap value."""
        net, env = state.net, self.env
        env_state = state.env_state
        board, queue, mask = self.observe(env_state)
        steps, stats = [], []
        for _ in range(self.cfg.rollout_len):
            logits, value = net(board, queue, mask)
            action = networks.masked_categorical(logits, state.gen)
            logp = networks.log_prob(logits, action)
            env_state, ts = env.step(env_state, action)
            if env.cfg.max_steps > 0:
                # truncating config: value the PRE-reset final observation
                # (the value head ignores the mask, so the live mask is fine)
                _, v_final = net(
                    ts.info["final_board"], ts.info["final_queue"],
                    ts.action_mask,
                )
            else:
                v_final = torch.zeros_like(value)
            done = ts.done
            steps.append(Batch(
                board=board, queue=queue, action_mask=mask, action=action,
                log_prob=logp, value=value, reward=ts.reward, done=done,
                terminated=ts.terminated, final_value=v_final,
            ))
            stats.append((
                ts.info["episode_return"] * done,
                ts.info["episode_length"] * done,
                done,
                ts.info["lines_cleared"],
                ts.info["legal"],
            ))
            board, queue, mask = ts.board, ts.queue, ts.action_mask
        _, last_value = net(board, queue, mask)
        batch = Batch(**{
            f.name: torch.stack([getattr(b, f.name) for b in steps])
            for f in dataclasses.fields(Batch)
        })
        ep_ret, ep_len, dones, lines, legal = (torch.stack(x) for x in zip(*stats))
        n_done = dones.sum().clamp(min=1)
        ep_stats = {
            "episode_return": ep_ret.sum() / n_done,
            "episode_length": ep_len.sum() / n_done,
            "episodes_finished": dones.sum(),
            "lines_per_step": lines.float().mean(),
            "illegal_action_rate": 1.0 - legal.float().mean(),
        }
        return state.replace(env_state=env_state), batch, last_value, ep_stats

    # ------------------------------------------------------------------

    def _gae(
        self, batch: Batch, last_value: torch.Tensor,
        gamma=None, gae_lambda=None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Generalized advantage estimation over the time axis.

        Terminated steps stop the bootstrap; truncated steps bootstrap from
        V(final observation), not from the post-auto-reset observation's
        value (auto-reset is same-step, so ``next_value`` at a truncation
        belongs to the next episode)."""
        cfg = self.cfg
        gamma = cfg.gamma if gamma is None else gamma
        gae_lambda = cfg.gae_lambda if gae_lambda is None else gae_lambda
        gae = torch.zeros_like(last_value)
        next_value = last_value
        advantages = [None] * batch.reward.shape[0]
        for t in reversed(range(batch.reward.shape[0])):
            done, terminated = batch.done[t], batch.terminated[t]
            truncated = done & ~terminated
            next_v = torch.where(
                terminated, 0.0,
                torch.where(truncated, batch.final_value[t], next_value),
            )
            delta = batch.reward[t] + gamma * next_v - batch.value[t]
            gae = delta + gamma * gae_lambda * torch.where(done, 0.0, gae)
            advantages[t] = gae
            next_value = batch.value[t]
        advantages = torch.stack(advantages)
        return advantages, advantages + batch.value

    # ------------------------------------------------------------------

    def _loss(
        self, net: ActorCritic, minibatch: Batch, advantages, returns,
        entropy_coef=None, clip_eps=None, value_coef=None,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        cfg = self.cfg
        entropy_coef = cfg.entropy_coef if entropy_coef is None else entropy_coef
        clip_eps = cfg.clip_eps if clip_eps is None else clip_eps
        value_coef = cfg.value_coef if value_coef is None else value_coef
        logits, value = net(
            minibatch.board, minibatch.queue, minibatch.action_mask
        )
        logp = networks.log_prob(logits, minibatch.action)
        ratio = torch.exp(logp - minibatch.log_prob)
        # jnp's std is the population std (ddof 0)
        adv = (advantages - advantages.mean()) / (
            advantages.std(correction=0) + 1e-8
        )
        pg1 = ratio * adv
        pg2 = torch.clamp(ratio, 1 - clip_eps, 1 + clip_eps) * adv
        policy_loss = -torch.minimum(pg1, pg2).mean()
        value_loss = 0.5 * torch.square(value - returns).mean()
        entropy = networks.masked_entropy(logits).mean()
        total = policy_loss + value_coef * value_loss - entropy_coef * entropy
        metrics = {
            "loss": total,
            "policy_loss": policy_loss,
            "value_loss": value_loss,
            "entropy": entropy,
            "approx_kl": ((ratio - 1) - torch.log(ratio)).mean(),
        }
        return total, {k: v.detach() for k, v in metrics.items()}

    # ------------------------------------------------------------------

    def _epoch_order(self, total: int, gen: torch.Generator) -> torch.Tensor:
        """(total,) row order of one epoch; for "roll", row i of the order
        is ``(i - shift) % total``, i.e. ``jnp.roll`` by ``shift``."""
        dev = self.env.device
        if self.cfg.shuffle == "perm":
            return torch.randperm(total, generator=gen, device=dev)
        order = torch.arange(total, device=dev)
        if self.cfg.shuffle == "roll":
            shift = torch.randint(0, total, (), generator=gen, device=dev)
            order = (order - shift) % total
        return order

    def update(
        self, state: TrainState, hypers: Optional[Dict[str, Any]] = None
    ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One full PPO update: rollout + GAE + epochs of minibatch steps.

        ``hypers`` (see ``default_hypers``) carries lr, entropy_coef,
        clip_eps, gamma, gae_lambda and value_coef (``cli/train.py``
        schedules them); when omitted they are the config's.  Metrics are
        0-d tensors on the device.
        """
        cfg = self.cfg
        hypers = hypers or default_hypers(cfg)
        state, batch, last_value, ep_stats = self._rollout(state)
        advantages, returns = self._gae(
            batch, last_value, hypers["gamma"], hypers["gae_lambda"]
        )
        flat = batch.map(lambda x: x.flatten(0, 1))
        adv_flat, ret_flat = advantages.flatten(), returns.flatten()
        total = cfg.rollout_len * cfg.num_envs
        mb_size = total // cfg.num_minibatches
        net, opt = state.net, state.opt
        history = []
        for _ in range(cfg.num_epochs):
            order = self._epoch_order(total, state.gen)
            for i in range(cfg.num_minibatches):
                rows = order[i * mb_size : (i + 1) * mb_size]
                loss, metrics = self._loss(
                    net, flat.map(lambda x: x[rows]), adv_flat[rows],
                    ret_flat[rows], hypers["entropy_coef"], hypers["clip_eps"],
                    hypers["value_coef"],
                )
                opt.zero_grad(set_to_none=True)
                loss.backward()
                optimizer_step(opt, cfg.max_grad_norm, hypers["lr"])
                history.append(metrics)
        metrics = {k: torch.stack([m[k] for m in history]).mean()
                   for k in history[0]}
        metrics.update(ep_stats)
        metrics["reward_per_step"] = batch.reward.mean()
        return state.replace(update_count=state.update_count + 1), metrics
