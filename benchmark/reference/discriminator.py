"""PatchGAN discriminator with its spectral norm written out.

Counterpart of ``sinnerf_tpu/models/discriminator.py`` (reference
``models/discriminator.py:57-171``): a DCGAN-style stack of 4x4 convolutions
chosen by ``imsize`` (the 128, 64 and 32 branches; any other value, such as
LLFF's -1, takes the 16 branch), spectral norm on every convolution,
InstanceNorm without affine (eps 1e-5, biased variance), LeakyReLU 0.2,
DiffAugment applied inside with probability 0.5, and an optional
conditional head over a scale embedding.

Spectral norm is not ``torch.nn.utils.spectral_norm``: each convolution
holds its weight as the parameter ``weight_orig`` and the power iteration's
``u`` as the buffer ``weight_u`` (the reference's state-dict slots
``main.<slot>.weight_orig`` / ``weight_u``), and a call returns ``(logits,
new_u)`` without touching the buffers.  The iteration is the JAX package's:
``v = W^T u / (|W^T u| + 1e-12)``, ``u' = W v / (|W v| + 1e-12)``,
``sigma = u'^T W v``, with ``u'`` and ``v`` detached and ``sigma`` in the
graph (torch's hook divides by ``max(|x|, eps)`` instead).  ``frozen=True``
runs on detached weights, so only the input gets a gradient, and still
advances ``u``: the training step's generator term runs that way, on the
same ``u`` chain as the discriminator's own calls.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.encoding import positional_encoding
from benchmark.reference.diffaug import DiffAugDraws, coin, diff_augment

SN_EPS = 1e-12
IN_EPS = 1e-5
HEAD_SLOTS = (1, 3, 5)  # the conditional head's convolutions in the reference's ``final`` stack


def conv_spec(imsize: int, ndf: int, nc: int = 3, final_dim: int = 1) -> List[Tuple[int, int, bool]]:
    """(in channels, out channels, InstanceNorm?) per convolution, as the
    imsize branches of discriminator.py:87-154 (JAX ``_conv_spec`` :28-56).
    Every convolution is 4x4, stride 2 and padding 1, but the last: stride
    1, padding 0."""
    if imsize == 128:
        spec = [(nc, ndf // 2, False), (ndf // 2, ndf, True), (ndf, ndf * 2, True), (ndf * 2, ndf * 4, True)]
    elif imsize == 64:
        spec = [(nc, ndf, False), (ndf, ndf * 2, True), (ndf * 2, ndf * 4, True)]
    elif imsize == 32:
        spec = [(nc, ndf * 2, True), (ndf * 2, ndf * 4, True)]
    else:
        spec = [(nc, ndf * 4, True)]
    return spec + [(ndf * 4, ndf * 8, True), (ndf * 8, final_dim, False)]


def main_slots(imsize: int, ndf: int = 64) -> List[int]:
    """The ``nn.Sequential`` slot of each convolution in the reference's
    ``main`` stack: a convolution, its InstanceNorm when it has one, then a
    LeakyReLU, but after the last (JAX ``_torch_main_slots``)."""
    spec = conv_spec(imsize, ndf)
    slots, slot = [], 0
    for i, (_, _, norm) in enumerate(spec):
        slots.append(slot)
        slot += 1 + int(norm) + int(i != len(spec) - 1)
    return slots


def output_side(imsize: int, side: int) -> int:
    """The logits' side for an input side: < 1 when the input is too small
    for the branch."""
    n = len(conv_spec(imsize, 1))
    for _ in range(n - 1):
        side = (side + 2 - 4) // 2 + 1
    return side - 3


class DCallDraws(NamedTuple):
    """The draws of one discriminator call: the coin that applies
    DiffAugment (discriminator.py:159-160) and DiffAugment's own."""

    coin: Optional[torch.Tensor] = None  # () bool: augment this call's input
    aug: DiffAugDraws = DiffAugDraws()


class SNConv(nn.Module):
    """One spectrally normalised convolution's state: ``weight_orig`` (OIHW)
    and the power iteration's ``weight_u``."""

    def __init__(self, cout: int, cin: int, k: int):
        super().__init__()
        self.weight_orig = nn.Parameter(torch.empty(cout, cin, k, k))
        self.register_buffer("weight_u", torch.empty(cout))


def spectral_normalize(w: torch.Tensor, u: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(W / sigma, u') by one power iteration (JAX ``_spectral_norm``
    :205-235 with ``update=True``, as every training call runs it)."""
    w2d = w.reshape(w.shape[0], -1)
    with torch.no_grad():
        v = w2d.t() @ u
        v = v / (torch.linalg.vector_norm(v) + SN_EPS)
        u = w2d @ v
        u = u / (torch.linalg.vector_norm(u) + SN_EPS)
    sigma = u @ (w2d @ v)
    return w / sigma, u


def _instance_norm(x: torch.Tensor) -> torch.Tensor:
    mean = torch.mean(x, dim=(2, 3), keepdim=True)
    var = torch.var(x, dim=(2, 3), keepdim=True, unbiased=False)
    return (x - mean) * torch.rsqrt(var + IN_EPS)


class Discriminator(nn.Module):
    """The reference's ``Discriminator`` at ``imsize`` and ``ndf``; its
    state dict has the reference's ``main.<slot>.weight_orig`` /
    ``weight_u`` keys (``final.<1|3|5>.*`` for the conditional head), without
    the ``weight_v`` that ``export_torch_discriminator_state`` adds."""

    def __init__(self, imsize: int = 64, ndf: int = 64, conditional: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.imsize, self.ndf, self.conditional = imsize, ndf, conditional
        self.spec = conv_spec(imsize, ndf, final_dim=ndf if conditional else 1)
        self.main = nn.ModuleDict({str(s): SNConv(cout, cin, 4)
                                   for s, (cin, cout, _) in zip(main_slots(imsize, ndf), self.spec)})
        if conditional:
            emb_ch = 2 * 4 + 1  # the scale's PE: 1 channel, 4 frequencies
            head = [(ndf + emb_ch, ndf), (ndf, ndf), (ndf, 1)]
            self.final = nn.ModuleDict({str(s): SNConv(cout, cin, 1) for s, (cin, cout) in zip(HEAD_SLOTS, head)})
        self.reset_parameters(generator)

    def convs(self) -> List[SNConv]:
        """The convolutions in call order: ``main``, then the head."""
        out = list(self.main.values())
        if self.conditional:
            out += list(self.final.values())
        return out

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Weights uniform in +-1/sqrt(fan_in) and ``u`` standard normal, as
        JAX ``init_discriminator`` draws them (from another generator)."""
        for conv in self.convs():
            w = conv.weight_orig
            bound = 1.0 / math.sqrt(w[0].numel())
            w.copy_((torch.rand(w.shape, generator=generator) * 2.0 - 1.0) * bound)
            conv.weight_u.copy_(torch.randn(conv.weight_u.shape, generator=generator))

    def u(self) -> List[torch.Tensor]:
        """The current power-iteration vectors, in call order."""
        return [c.weight_u for c in self.convs()]

    @torch.no_grad()
    def set_u(self, u: Sequence[torch.Tensor]) -> None:
        for conv, value in zip(self.convs(), u):
            conv.weight_u.copy_(value)

    def forward(
        self,
        x: torch.Tensor,
        u: Optional[Sequence[torch.Tensor]] = None,
        frozen: bool = False,
        draws: Optional[DCallDraws] = None,
        generator: Optional[torch.Generator] = None,
        policy: str = "color,cutout",
        y: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """(N, 3, H, W) -> (logits, new u) (JAX ``discriminator_apply``).
        ``u`` defaults to the buffers.  With a policy the input is augmented
        with probability 0.5 (the draws ``draws``, or from ``generator``);
        ``policy=""`` calls D on the input as it is."""
        u = self.u() if u is None else list(u)
        if policy:
            d = draws if draws is not None else DCallDraws()
            apply = d.coin if d.coin is not None else coin(x, generator)
            x = torch.where(apply, diff_augment(x, policy, d.aug, generator), x)

        new_u = []
        h = x
        n_main = len(self.spec)
        convs = self.convs()
        for i, (_, _, use_norm) in enumerate(self.spec):
            w = convs[i].weight_orig
            w_sn, u_i = spectral_normalize(w.detach() if frozen else w, u[i])
            new_u.append(u_i)
            last = i == n_main - 1
            h = F.conv2d(h, w_sn, stride=1 if last else 2, padding=0 if last else 1)
            if not last:
                if use_norm:
                    h = _instance_norm(h)
                h = F.leaky_relu(h, 0.2)
        if self.conditional:
            if y is None:
                raise ValueError("conditional discriminator needs y")
            h = F.leaky_relu(h, 0.2)
            emb = positional_encoding(y.reshape(-1, 1).to(h.dtype), 4)[:, :, None, None]
            h = torch.cat([h, emb.expand(-1, -1, *h.shape[2:])], dim=1)
            for j in range(len(HEAD_SLOTS)):
                w = convs[n_main + j].weight_orig
                w_sn, u_i = spectral_normalize(w.detach() if frozen else w, u[n_main + j])
                new_u.append(u_i)
                h = F.conv2d(h, w_sn)
                if j < len(HEAD_SLOTS) - 1:
                    h = F.leaky_relu(h, 0.2)
            h = h.reshape(-1)
        return h, new_u
