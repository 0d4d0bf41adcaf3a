"""On-device learners of the port: PPO with the conv or mlp torso."""

from blockpuzzle_tpu_torch.learn.networks import ActorCritic
from blockpuzzle_tpu_torch.learn.ppo import PPO, PPOConfig, TrainState, default_hypers

__all__ = ["ActorCritic", "PPO", "PPOConfig", "TrainState", "default_hypers"]
