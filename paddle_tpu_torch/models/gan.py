"""DCGAN (``paddle_tpu/models/gan.py``, the book's image-generation
chapter): a transposed-conv generator, a conv discriminator, and
:func:`gan_step`, one discriminator update then one generator update.

BatchNorm's running statistics follow the reference's tape scoping: each
forward runs under its own ``nn.module.capture_state``, and only the
discriminator's forward on the *real* batch (applied after the
discriminator's update) and the generator's own forward in its step
(applied after the generator's update) move statistics; the fake
batches' forwards report to tapes that are thrown away."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from paddle_tpu_torch.models.common import ZooModel
from paddle_tpu_torch.nn import initializer as I
from paddle_tpu_torch.nn.layers import BatchNorm, Conv2D, Linear
from paddle_tpu_torch.nn.module import capture_state
from paddle_tpu_torch.ops import nn as ops_nn

__all__ = ["DCGANGenerator", "DCGANDiscriminator", "gan_step"]


class DCGANGenerator(ZooModel):
    """z (B, zdim) -> (B, s, s, out_ch) in [-1, 1], s = 4 * 2^n_up. The
    transposed convs' weights ``up{i}`` keep the reference's HWIO
    layout."""

    def __init__(self, zdim=64, base=32, n_up=3, out_ch=1, *,
                 device="cuda", seed: int = 0):
        super().__init__()
        self.base0 = base * (2 ** (n_up - 1))
        self.fc = Linear(zdim, 4 * 4 * self.base0, sharding=None)
        bns = []
        ch = self.base0
        for i in range(n_up):
            out = out_ch if i == n_up - 1 else ch // 2
            self.register_parameter(f"up{i}",
                                    nn.Parameter(torch.empty(4, 4, ch, out)))
            if i != n_up - 1:
                bns.append(BatchNorm(out))
            ch = out
        self._n_up = n_up
        self.bns = nn.ModuleList(bns)
        self._finish(device, seed)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        for i in range(self._n_up):
            I.normal(std=0.02)(getattr(self, f"up{i}"), generator)

    def forward(self, z):
        x = torch.relu(self.fc(z).reshape(-1, 4, 4, self.base0))
        for i in range(self._n_up):
            x = ops_nn.conv2d_transpose(x, getattr(self, f"up{i}"), stride=2,
                                        padding=1)
            if i != self._n_up - 1:
                x = torch.relu(self.bns[i](x))
        return torch.tanh(x)


class DCGANDiscriminator(ZooModel):
    """(B, s, s, in_ch) images, s = 4 * 2^n_down -> (B,) logits."""

    def __init__(self, in_ch=1, base=32, n_down=3, *, device="cuda",
                 seed: int = 0):
        super().__init__()
        self._in_size = 4 * (2 ** n_down)
        convs, bns = [], []
        ch_in, ch = in_ch, base
        for i in range(n_down):
            # a bias on the first conv only: BatchNorm cancels the others
            convs.append(Conv2D(ch_in, ch, 4, stride=2, padding=1,
                                bias=(i == 0),
                                weight_init=I.normal(std=0.02)))
            if i > 0:
                bns.append(BatchNorm(ch))
            ch_in, ch = ch, ch * 2
        self.convs = nn.ModuleList(convs)
        self.bns = nn.ModuleList(bns)
        self.fc = Linear(ch_in * 4 * 4, 1, sharding=None)
        self._finish(device, seed)

    def forward(self, x):
        if x.shape[1] != self._in_size or x.shape[2] != self._in_size:
            raise ValueError(
                f"discriminator expects {self._in_size}x{self._in_size} "
                f"inputs (4 * 2^n_down), got {x.shape[1]}x{x.shape[2]}")
        for i, conv in enumerate(self.convs):
            x = conv(x)
            if i > 0:
                x = self.bns[i - 1](x)
            x = torch.nn.functional.leaky_relu(x, 0.2)
        return self.fc(x.reshape(x.shape[0], -1))[:, 0]


def _bce(logits, target: float):
    return ops_nn.sigmoid_cross_entropy_with_logits(
        logits, torch.full_like(logits, target)).mean()


def gan_step(gen, disc, g_opt, d_opt):
    """``step(g_state, d_state, real, generator=None, z=None) -> (g_state,
    d_state, {"d_loss", "g_loss"})``: one discriminator update (real
    against fake, the non-saturating BCE) then one generator update, both
    models in training mode. The states are ``train.make_train_state``'s
    (updated in place, their ``step`` advanced); ``z`` is the two latent
    batches ``(z_d, z_g)``, else drawn from ``generator`` (a standard
    normal, the reference's draw from its key)."""

    def step(g_state, d_state, real, generator=None,
             z: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        if z is None:
            shape = (real.shape[0], gen.fc.weight.shape[0])
            z = tuple(torch.randn(shape, generator=generator,
                                  device=real.device) for _ in range(2))
        # discriminator: only the real batch's statistics move
        d_opt.zero_grad(set_to_none=True)
        with torch.no_grad(), capture_state():
            fake = gen(z[0])
        with capture_state() as d_tape:
            r = disc(real)
        with capture_state():
            f = disc(fake)
        d_loss = _bce(r, 1.0) + _bce(f, 0.0)
        d_loss.backward()
        d_opt.step()
        d_tape.apply()
        d_state["step"].add_(1)
        # generator: its own forward's statistics move
        g_opt.zero_grad(set_to_none=True)
        with capture_state() as g_tape:
            fake = gen(z[1])
        with capture_state():
            f = disc(fake)
        g_loss = _bce(f, 1.0)
        g_loss.backward()
        disc.zero_grad(set_to_none=True)
        g_opt.step()
        g_tape.apply()
        g_state["step"].add_(1)
        return g_state, d_state, {"d_loss": d_loss.detach(),
                                  "g_loss": g_loss.detach()}

    return step
