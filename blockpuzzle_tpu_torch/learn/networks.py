"""Policy/value network of the PPO learner, PyTorch port.

The port of ``blockpuzzle_tpu/learn/networks.py`` (``ActorCritic`` and its
``Torso``).  The board goes through 3x3 bf16 convolutions (``arch="conv"``)
or one wide bf16 layer (``arch="mlp"``); the hand goes in as a learned
embedding of its piece ids (``queue_mode="embed"``) or as piece planes,
extra input channels (conv) or extra flattened inputs (mlp)
(``queue_mode="planes"``); a bf16 hidden layer feeds two heads with bf16
operands and float32 results.  Illegal actions get the logit ``NEG_INF``.

Numerics follow the flax modules:

* Every layer multiplies bf16-rounded operands in float32 (``_bf16``).
  A product of two bf16 values is exact in float32, so this is JAX's
  float32 accumulation up to the order of summation, on any device and
  whatever cuBLAS's bf16 reduction flags say.  A float32 matmul on the
  card runs in full float32 unless TF32 is allowed
  (``torch.backends.cuda.matmul.allow_tf32``, off by default).
* ``nn.Dense(dtype=bf16)`` (``mlp_0``, ``hidden_proj``) and
  ``nn.Conv(dtype=bf16)``: the sum with the bf16-rounded bias is rounded to
  a bf16 output (``_dense_bf16``, ``_conv_bf16``); the gradients reaching
  the weights are bf16-rounded, as JAX's are.  A float32 convolution on the
  card may run in TF32 (``torch.backends.cudnn.allow_tf32``, on by
  default).  That is harmless only because TF32 holds every bf16 value
  exactly, so on these bf16-rounded operands it multiplies exactly too;
  ``chip_smoke.py`` holds the conv network on the card against its CPU
  copy.
* flax flattens the last conv activation in (H, W, C) order, so the port
  moves its channels last before the flatten, and ``hidden_proj`` carries
  flax's weights with a plain transpose.
* ``MXUDense``: float32 bias and output.
* ``nn.Embed(dtype=bf16)``: rows gathered from the float32 table, then
  rounded (the same values), so that the table's gradient sums its rows'
  cotangents in float32 on every device (a bf16 table's backward sums in
  bf16 on the CPU: 21% off at 16384 rows).
* Initialisers are flax's: ``he_normal`` and ``lecun_normal`` are
  truncated normals (variance scaling over fan-in, the product of all
  input axes of the kernel, cut at two standard deviations and
  rescaled); ``nn.Embed`` draws a plain normal of variance 1 / features;
  biases start at zero.  Draws take an explicit ``torch.Generator``;
  they cannot give JAX's bits, so a test carries flax parameters across
  with ``interop.params_from_flax``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from blockpuzzle_tpu_torch import rules
from blockpuzzle_tpu_torch.config import EnvConfig

NEG_INF = -1e9
# standard deviation of a standard normal cut to (-2, 2)
_TRUNC_STD = 0.87962566103423978


def _variance_scaling_(
    w: torch.Tensor, scale: float, gen: torch.Generator
) -> torch.Tensor:
    """flax ``variance_scaling(scale, "fan_in", "truncated_normal")`` on an
    (out, in, ...) weight, in place."""
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
        return w.mul_((scale / w[0].numel()) ** 0.5 / _TRUNC_STD)


def _he_dense(in_features: int, features: int, gen: torch.Generator) -> nn.Linear:
    """``nn.Linear`` with flax Dense's ``he_normal`` kernel and zero bias
    (``skip_init``: no draw from the global generator)."""
    layer = torch.nn.utils.skip_init(nn.Linear, in_features, features)
    _variance_scaling_(layer.weight, 2.0, gen)
    nn.init.zeros_(layer.bias)
    return layer


def _he_conv(in_ch: int, out_ch: int, gen: torch.Generator) -> nn.Conv2d:
    """3x3 ``nn.Conv2d`` with flax Conv's ``he_normal`` kernel (fan-in
    ``9 * in_ch``) and zero bias."""
    layer = torch.nn.utils.skip_init(nn.Conv2d, in_ch, out_ch, 3, padding=1)
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


def _conv_bf16(x: torch.Tensor, layer: nn.Conv2d) -> torch.Tensor:
    """flax ``nn.Conv(dtype=bf16, padding="SAME")`` on NCHW input: bf16
    operands, bias and output (TF32 on the card is exact on these)."""
    y = F.conv2d(_bf16(x), _bf16(layer.weight), _bf16(layer.bias), padding=1)
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
    """Shared representation: board features and hand features through a
    hidden layer, ReLU after each layer.

    ``arch="conv"``: a 3x3 "SAME" convolution per entry of ``channels``
    (``convs``), flattened in (H, W, C) order; ``arch="mlp"``: the
    flattened board through one wide layer (``mlp_0``).  ``queue_mode=
    "embed"``: the hand's piece-id embeddings (``embed``) join the board
    features; ``"planes"``: each slot's piece plane (``rules.
    piece_plane_table``, all-zero for an empty slot) joins the board as an
    extra input channel (conv) or extra flattened inputs (mlp).  Layer
    names follow flax's (``Conv_i``, ``mlp_0``, ``Embed_0``,
    ``hidden_proj``)."""

    def __init__(
        self,
        cfg: EnvConfig,
        num_pieces: int,
        gen: torch.Generator,
        channels: Tuple[int, ...] = (32, 64),
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
        self.cfg, self.arch, self.queue_mode = cfg, arch, queue_mode
        s, hw = cfg.queue_size, cfg.num_cells
        planes = queue_mode == "planes"
        if planes:
            table = np.concatenate(
                [rules.piece_plane_table(cfg), np.zeros((1, hw), np.uint8)])
            self.register_buffer(
                "plane_table", torch.as_tensor(table, dtype=torch.float32),
                persistent=False)
        if arch == "conv":
            self.convs = nn.ModuleList()
            in_ch = 1 + (s if planes else 0)
            for ch in channels:
                self.convs.append(_he_conv(in_ch, ch, gen))
                in_ch = ch
            features = hw * in_ch
        else:
            self.mlp_0 = _he_dense(hw * (1 + (s if planes else 0)), mlp_width, gen)
            features = mlp_width
        if not planes:
            self.embed = torch.nn.utils.skip_init(
                nn.Embedding, num_pieces + 1, embed_dim
            )
            with torch.no_grad():
                self.embed.weight.normal_(generator=gen).mul_(embed_dim ** -0.5)
            features += s * embed_dim
        self.hidden_proj = _he_dense(features, hidden, gen)

    def _planes(self, queue: torch.Tensor) -> torch.Tensor:
        """(B, S, HW) float32 piece planes of (B, S) piece ids."""
        p = self.plane_table.shape[0] - 1
        pid = torch.where((queue >= 0) & (queue < p), queue, p).long()
        return self.plane_table[pid]

    def forward(self, board: torch.Tensor, queue: torch.Tensor) -> torch.Tensor:
        """board (..., H, W) u8, queue (..., S) int -> (..., hidden) bf16."""
        cfg = self.cfg
        lead = board.shape[:-2]
        board = board.reshape(-1, cfg.height, cfg.width).to(torch.float32)
        queue = queue.reshape(-1, cfg.queue_size)
        b = board.shape[0]
        planes = self._planes(queue) if self.queue_mode == "planes" else None
        if self.arch == "conv":
            x = board[:, None]                                    # (B, 1, H, W)
            if planes is not None:
                x = torch.cat(
                    [x, planes.view(b, -1, cfg.height, cfg.width)], dim=1)
            for conv in self.convs:
                x = F.relu(_conv_bf16(x, conv))
            x = x.permute(0, 2, 3, 1).reshape(b, -1)              # flax's HWC
        else:
            x = board.reshape(b, -1)
            if planes is not None:
                x = torch.cat([x, planes.reshape(b, -1)], dim=-1)
            x = F.relu(_dense_bf16(x, self.mlp_0))
        if planes is None:
            emb = F.embedding(queue.long(), self.embed.weight).to(torch.bfloat16)
            x = torch.cat([x, emb.flatten(-2)], dim=-1)
        x = F.relu(_dense_bf16(x, self.hidden_proj))
        return x.reshape(*lead, -1)


class ActorCritic(nn.Module):
    """Masked-policy + value network (PPO).

    Built on the CPU with flax's initialisers drawn from ``gen``, a CPU
    ``torch.Generator``; move it with ``.to(device)``."""

    def __init__(
        self,
        cfg: EnvConfig,
        num_pieces: int,
        gen: torch.Generator,
        channels: Tuple[int, ...] = (32, 64),
        hidden: int = 256,
        arch: str = "conv",
        mlp_width: int = 512,
        queue_mode: str = "embed",
    ) -> None:
        super().__init__()
        self.torso = Torso(
            cfg, num_pieces, gen, channels, hidden, arch=arch,
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
