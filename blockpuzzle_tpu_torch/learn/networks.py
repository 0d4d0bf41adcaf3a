"""Policy/value network of the PPO learner, PyTorch port.

The port of ``blockpuzzle_tpu/learn/networks.py`` for ``arch="mlp"`` and
``queue_mode="embed"``: the board flattens into one wide bf16 layer, the
hand's piece ids into a learned embedding, and a bf16 hidden layer feeds
two heads with bf16 operands and float32 results.  Illegal actions get the
logit ``NEG_INF``.

Numerics follow the flax modules:

* Every layer multiplies bf16-rounded operands in float32 (``_bf16``).
  A product of two bf16 values is exact in float32, so this is JAX's
  float32 accumulation up to the order of summation, on any device and
  whatever cuBLAS's bf16 reduction flags say.  A float32 matmul on the
  card runs in full float32 unless TF32 is allowed
  (``torch.backends.cuda.matmul.allow_tf32``, off by default).
* ``nn.Dense(dtype=bf16)`` (``mlp_0``, ``hidden_proj``): the sum with the
  bf16-rounded bias is rounded to a bf16 output (``_dense_bf16``); the
  gradients reaching the weights are bf16-rounded, as JAX's are.
* ``MXUDense``: float32 bias and output.
* ``nn.Embed(dtype=bf16)``: rows gathered from the float32 table, then
  rounded (the same values), so that the table's gradient sums its rows'
  cotangents in float32 on every device (a bf16 table's backward sums in
  bf16 on the CPU: 21% off at 16384 rows).
* Initialisers are flax's: ``he_normal`` and ``lecun_normal`` are
  truncated normals (variance scaling over fan-in, cut at two standard
  deviations and rescaled); ``nn.Embed`` draws a plain normal of variance
  1 / features; biases start at zero.  Draws take an explicit
  ``torch.Generator``; they cannot give JAX's bits, so a test carries
  flax parameters across with ``interop.params_from_flax``.

``arch="conv"`` and ``queue_mode="planes"`` are ROADMAP.md A9 and raise
``NotImplementedError``.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from blockpuzzle_tpu_torch.config import EnvConfig

NEG_INF = -1e9
# standard deviation of a standard normal cut to (-2, 2)
_TRUNC_STD = 0.87962566103423978


def _variance_scaling_(
    w: torch.Tensor, scale: float, gen: torch.Generator
) -> torch.Tensor:
    """flax ``variance_scaling(scale, "fan_in", "truncated_normal")`` on an
    (out, in) weight, in place."""
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
        return w.mul_((scale / w.shape[1]) ** 0.5 / _TRUNC_STD)


def _he_dense(in_features: int, features: int, gen: torch.Generator) -> nn.Linear:
    """``nn.Linear`` with flax Dense's ``he_normal`` kernel and zero bias
    (``skip_init``: no draw from the global generator)."""
    layer = torch.nn.utils.skip_init(nn.Linear, in_features, features)
    _variance_scaling_(layer.weight, 2.0, gen)
    nn.init.zeros_(layer.bias)
    return layer


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bf16, held as float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def _dense_bf16(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """flax ``nn.Dense(dtype=bf16)``: bf16 operands, bias and output."""
    y = F.linear(_bf16(x), _bf16(layer.weight), _bf16(layer.bias))
    return y.to(torch.bfloat16)


class MXUDense(nn.Module):
    """Dense with bf16 operands and float32 accumulation, bias and output;
    ``lecun_normal`` kernel, zero bias.

    ``weight`` is (out, in), as ``nn.Linear``'s; flax's kernel is (in, out).
    """

    def __init__(self, in_features: int, features: int, gen: torch.Generator):
        super().__init__()
        self.weight = nn.Parameter(
            _variance_scaling_(torch.empty(features, in_features), 1.0, gen)
        )
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(_bf16(x), _bf16(self.weight), self.bias)


class Torso(nn.Module):
    """Shared representation: flattened board through a wide layer, with
    the hand's piece-id embeddings, through a hidden layer; ReLU after
    each.  Layer names follow flax's (``mlp_0``, ``hidden_proj``)."""

    def __init__(
        self,
        cfg: EnvConfig,
        num_pieces: int,
        gen: torch.Generator,
        hidden: int = 256,
        embed_dim: int = 16,
        arch: str = "conv",
        mlp_width: int = 512,
        queue_mode: str = "embed",
    ) -> None:
        super().__init__()
        if arch not in ("conv", "mlp"):
            raise ValueError(f"unknown torso arch {arch!r}")
        if queue_mode not in ("embed", "planes"):
            raise ValueError(f"unknown queue_mode {queue_mode!r}")
        if arch == "conv" or queue_mode == "planes":
            raise NotImplementedError(
                "torso arch='conv' and queue_mode='planes' are ROADMAP.md A9"
            )
        self.mlp_0 = _he_dense(cfg.num_cells, mlp_width, gen)
        self.embed = torch.nn.utils.skip_init(
            nn.Embedding, num_pieces + 1, embed_dim
        )
        with torch.no_grad():
            self.embed.weight.normal_(generator=gen).mul_(embed_dim ** -0.5)
        self.hidden_proj = _he_dense(
            mlp_width + cfg.queue_size * embed_dim, hidden, gen
        )

    def forward(self, board: torch.Tensor, queue: torch.Tensor) -> torch.Tensor:
        """board (..., H, W) u8, queue (..., S) int -> (..., hidden) bf16."""
        x = F.relu(_dense_bf16(board.flatten(-2), self.mlp_0))
        emb = F.embedding(queue.long(), self.embed.weight).to(torch.bfloat16)
        x = torch.cat([x, emb.flatten(-2)], dim=-1)
        return F.relu(_dense_bf16(x, self.hidden_proj))


class ActorCritic(nn.Module):
    """Masked-policy + value network (PPO).

    Built on the CPU with flax's initialisers drawn from ``gen``, a CPU
    ``torch.Generator``; move it with ``.to(device)``."""

    def __init__(
        self,
        cfg: EnvConfig,
        num_pieces: int,
        gen: torch.Generator,
        hidden: int = 256,
        arch: str = "conv",
        mlp_width: int = 512,
        queue_mode: str = "embed",
    ) -> None:
        super().__init__()
        self.torso = Torso(
            cfg, num_pieces, gen, hidden, arch=arch,
            mlp_width=mlp_width, queue_mode=queue_mode,
        )
        self.policy = MXUDense(hidden, cfg.num_actions(), gen)
        self.value = MXUDense(hidden, 1, gen)

    def forward(
        self, board: torch.Tensor, queue: torch.Tensor, action_mask: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (masked_logits (..., A) f32, value (...,) f32)."""
        h = self.torso(board, queue)
        logits = torch.where(action_mask, self.policy(h), NEG_INF)
        return logits, self.value(h)[..., 0]


def masked_categorical(
    logits: torch.Tensor, generator: torch.Generator
) -> torch.Tensor:
    """(...,) int64 actions sampled from masked logits by Gumbel-max (as
    ``jax.random.categorical``), with uniforms from ``generator``."""
    u = torch.rand(
        logits.shape, generator=generator, device=logits.device,
        dtype=logits.dtype,
    )
    tiny = torch.finfo(logits.dtype).tiny
    gumbel = -torch.log(-torch.log(u.clamp_min(tiny)))
    return (logits + gumbel).argmax(dim=-1)


def log_prob(logits: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
    logp = F.log_softmax(logits, dim=-1)
    return logp.gather(-1, action.long()[..., None])[..., 0]


def masked_entropy(logits: torch.Tensor) -> torch.Tensor:
    """Entropy of the masked distribution; NEG_INF slots contribute 0."""
    logp = F.log_softmax(logits, dim=-1)
    p = logp.exp()
    return -torch.where(p > 0, p * logp, 0.0).sum(dim=-1)
