"""Synthetic clips of UCF101's frame size, made on the device from the
seed: the traffic's content.

Each clip views a smoothed random RGB texture (periodic, so a view can
travel without end) that translates at a per-clip velocity and zooms at
a per-clip rate, plus Gaussian sensor noise, rounded to uint8.  The
texture's spectrum falls as 1/(1 + (f/f0)²) (f0 = 0.05 cycles a pixel),
its gray level has mean 128 and standard deviation 40, and each channel
mixes a shared luminance with a channel field of its own.

Every seed makes the same set of motions in another order: clip i of n
takes the speed max_speed·(π₁(i) + u)/n, the direction 2π(π₂(i) + u')/n
and the zoom rate zoom_rate·(2(π₃(i) + u'')/n − 1) (π a permutation and
u a jitter drawn from the seed), so the work a TV-L1 solve needs, which
follows the motion, is spread alike over every seed's clips.  The
motion and the texture set how many rounds TV-L1's ε test lets run.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np
import torch

from bench_h100.weights import derived_seed


def motions(seed: int, n: int, content: dict) -> np.ndarray:
    """(n, 3) per-clip (speed px/frame, direction rad, zoom rate /frame)."""
    rng = np.random.default_rng([seed, 1])
    out = np.empty((n, 3))
    for j, span in enumerate((content["max_speed_px"], 2 * math.pi,
                              content["max_zoom_rate"])):
        strata = (rng.permutation(n) + rng.random(n)) / n
        out[:, j] = span * (2 * strata - 1 if j == 2 else strata)
    return out


def _texture(gen: torch.Generator, size: int, device) -> torch.Tensor:
    """(3, size, size) float32 periodic texture, gray mean 128, sd 40."""
    noise = torch.randn((4, size, size), generator=gen, device=device)
    f = torch.fft.fftfreq(size, device=device)
    rad2 = f[:, None] ** 2 + f[None, :] ** 2
    field = torch.fft.ifft2(torch.fft.fft2(noise)
                            / (1.0 + rad2 / 0.05 ** 2)).real
    field = field / field.std(dim=(1, 2), keepdim=True)
    rgb = 0.8 * field[:1] + 0.6 * field[1:]
    return 128.0 + 40.0 * rgb / rgb.std()


def _render(tex: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor
            ) -> torch.Tensor:
    """Bilinear sample of the periodic (3, S, S) texture at (T, H, W)
    coordinates → (T, H, W, 3)."""
    S = tex.shape[-1]
    y0, x0 = torch.floor(ys), torch.floor(xs)
    fy, fx = (ys - y0)[..., None], (xs - x0)[..., None]
    y0, x0 = y0.long() % S, x0.long() % S
    y1, x1 = (y0 + 1) % S, (x0 + 1) % S
    t = tex.permute(1, 2, 0)
    top = t[y0, x0] * (1 - fx) + t[y0, x1] * fx
    bot = t[y1, x0] * (1 - fx) + t[y1, x1] * fx
    return top * (1 - fy) + bot * fy


def make_clips(seed: int, lengths: Sequence[int], content: dict, device
               ) -> List[torch.Tensor]:
    """One (T_i, H, W, 3) uint8 clip on `device` per length, from
    `seed`.  `content` holds ``height``, ``width``, ``max_speed_px``,
    ``max_zoom_rate``, ``noise_sd`` and ``texture_px``."""
    H, W = content["height"], content["width"]
    gen = torch.Generator(device=device)
    gen.manual_seed(derived_seed(seed, "clips"))
    mot = motions(seed, len(lengths), content)
    yy = torch.arange(H, dtype=torch.float32, device=device)[:, None] \
        - (H - 1) / 2
    xx = torch.arange(W, dtype=torch.float32, device=device)[None, :] \
        - (W - 1) / 2
    clips = []
    for (speed, angle, zoom), T in zip(mot, lengths):
        tex = _texture(gen, content["texture_px"], device)
        t = torch.arange(T, dtype=torch.float32, device=device)[:, None,
                                                                 None]
        z = torch.exp(-zoom * t)
        ys = yy * z + speed * math.sin(angle) * t
        xs = xx * z + speed * math.cos(angle) * t
        frames = _render(tex, ys, xs)
        frames = frames + content["noise_sd"] * torch.randn(
            frames.shape, generator=gen, device=device)
        clips.append(frames.round().clamp(0, 255).to(torch.uint8))
    return clips

