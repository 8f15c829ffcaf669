"""SpyNet-style learned optical flow (Ranjan & Black 2017), in PyTorch.

Port of ``video_analytics_tpu/models/spynet.py``.  A pyramid flow network:
each level k predicts a residual flow from (I0_k, warp(I1_k, up(flow)),
up(flow)) with five 7×7 convolutions, coarse to fine.  The convolutions run
on cuDNN in float32 (TF32 is off, ``utils/device.py``), or in the
reference's reduced-precision ``dtype`` when one is given (float32
parameters; the pipeline's SpyNet stays float32, as the reference's); the
warp (``ops/kernels.warp_by_flow``, a gather) and the pyramid's and the
flow's linear resizes (``ops/kernels.resize_linear``, two-tap gathers) are
plain tensor code, as they are XLA in the reference: no hand-written kernel
stands on this path.  All of it is differentiable, so the same module
trains (``make_spynet_train_step``) and, frozen, feeds the flow stream
(``runtime/pipeline`` with ``flow_algo="spynet"``).

Weights cross to and from the reference's flax tree with
``flax_variables`` / ``load_flax_variables`` (HWIO ↔ OIHW,
``models/convert``); the synthetic-trained weights ship as package data
(``default_spynet_checkpoint``).

The synthetic-motion training data is split in two: ``synthetic_pair_draws``
makes the random arrays from a ``torch.Generator`` (``jax.random`` cannot be
reproduced in torch), and ``synthetic_pair_from_draws`` builds the pair from
them deterministically, in the reference's operations.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, List, Mapping, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from video_analytics_tpu_torch.models import convert
from video_analytics_tpu_torch.ops.layers import Conv2d
from video_analytics_tpu_torch.ops.kernels import (
    gaussian_blur, resize_area_like, resize_linear, warp_by_flow)

FEATURES = (32, 64, 32, 16)


class SpyNetLevel(nn.Module):
    """One pyramid level: (B, 4, h, w) input (I0, I1 warped, u, v) →
    (B, 2, h, w) float32 residual flow; four 7×7 convolutions with ReLU,
    then a 7×7 convolution to two channels.  The convolutions, their bias
    adds and the ReLUs run in `dtype` (float32 parameters,
    ``ops/layers.Conv2d``), as the reference's ``SpyNetLevel(dtype=)``."""

    def __init__(self, features: Tuple[int, ...] = FEATURES,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        chans = (4, *features)
        for i in range(len(features)):
            setattr(self, f"conv{i}", Conv2d(chans[i], chans[i + 1], 7,
                                             padding=3, dtype=dtype))
        self.conv_out = Conv2d(chans[-1], 2, 7, padding=3, dtype=dtype)
        self.depth = len(features)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.depth):
            x = torch.relu(getattr(self, f"conv{i}")(x))
        return self.conv_out(x).float()


class SpyNet(nn.Module):
    """Stack of per-level residual predictors (separate weights per level,
    coarse → fine).  ``nets[k]`` is the reference's ``level{k}``.  `dtype`
    is the levels' compute dtype; the pyramids, warps, resizes and the
    flow itself stay float32."""

    def __init__(self, levels: int = 4, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.levels = levels
        self.dtype = dtype
        self.nets = nn.ModuleList(SpyNetLevel(dtype=dtype)
                                  for _ in range(levels))

    def _pyramid(self, img: torch.Tensor) -> List[torch.Tensor]:
        """(B, H, W) → levels, finest first, each (h // 2, w // 2) of the
        last by a linear resize."""
        pyr = [img]
        for _ in range(self.levels - 1):
            _, h, w = pyr[-1].shape
            pyr.append(resize_area_like(pyr[-1], (h // 2, w // 2)))
        return pyr

    def forward(self, prev: torch.Tensor, nxt: torch.Tensor,
                train_all_levels: bool = False):
        """(B, H, W) gray on [0, 255] → (B, H, W, 2) flow (dx, dy), the
        convention of the classical solvers: prev(p) ≈ nxt(p + flow(p)).

        ``train_all_levels=True`` returns (flow, per-level flows, coarse
        to fine) for deep supervision."""
        p0 = self._pyramid((prev.float() / 255.0 - 0.5) * 4.0)
        p1 = self._pyramid((nxt.float() / 255.0 - 0.5) * 4.0)
        flow = None
        per_level = []
        for k in range(self.levels - 1, -1, -1):
            i0, i1 = p0[k], p1[k]
            b, h, w = i0.shape
            if flow is None:
                flow = i0.new_zeros((b, h, w, 2))
            else:
                flow = resize_linear(flow, (h, w)) * 2.0
            i1w = warp_by_flow(i1[..., None], flow)[..., 0]
            x = torch.stack([i0, i1w, flow[..., 0], flow[..., 1]], dim=1)
            flow = flow + self.nets[k](x).permute(0, 2, 3, 1)
            per_level.append(flow)
        if train_all_levels:
            return flow, per_level
        return flow

    # -- variables in the reference's layout ----------------------------------

    def flax_variables(self) -> Dict[str, Any]:
        """The weights as the reference's ``{"params": {"level{k}":
        {"conv{i}" | "conv_out": {"kernel", "bias"}}}}`` tree (numpy
        leaves): what ``runtime/checkpoint.save_variables`` writes and
        the reference's ``init_spynet`` template reads."""
        return convert.spynet_torch_to_flax(self.state_dict())

    def load_flax_variables(self, variables: Mapping[str, Any]) -> "SpyNet":
        """Take the weights from the reference's variable tree, e.g. one
        read by ``runtime/checkpoint.load_variables``."""
        self.load_state_dict(convert.spynet_flax_to_torch(variables))
        return self


def conv_flops(b: int, h: int, w: int, levels: int = 4) -> float:
    """float32 operations of one SpyNet call's convolutions on b pairs of
    h×w: per pixel of each pyramid level (h // 2, w // 2 each) 2·49·Σ
    c_in·c_out = 467,264.  The warps and resizes are left out (under
    0.1 %)."""
    chans = (4, *FEATURES, 2)
    per_px = 2 * 49 * sum(a * c for a, c in zip(chans, chans[1:]))
    total = 0
    for _ in range(levels):
        total += per_px * b * h * w
        h, w = h // 2, w // 2
    return float(total)


def default_spynet_checkpoint() -> str:
    """Path of the bundled synthetic-trained SpyNet weights (package data
    ``video_analytics_tpu_torch/checkpoints_data/``); raises
    FileNotFoundError with a pointer to ``--spynet-checkpoint`` if the
    file is missing."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "checkpoints_data",
        "spynet_synthetic.msgpack")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"bundled SpyNet checkpoint missing at {path}; pass "
            "--spynet-checkpoint (or train one: "
            "tools/torch_train_spynet.py)")
    return path


def init_spynet(model: SpyNet, generator: torch.Generator) -> SpyNet:
    """Seeded initialisation in place, following flax's ``nn.Conv``
    defaults: kernels LeCun normal (a unit normal truncated to ±2,
    scaled to variance 1/fan_in), biases 0.  Draws on the generator's
    device."""
    std = 1.0 / 0.87962566103423978      # a ±2 truncated unit normal's std
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                w = torch.empty(m.weight.shape, device=generator.device)
                nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0,
                                      generator=generator)
                m.weight.copy_(w * std * fan_in ** -0.5)
                m.bias.zero_()
    return model


# ---------------------------------------------------------------------------
# Synthetic-motion training (no external data needed)
# ---------------------------------------------------------------------------

Draws = Dict[str, torch.Tensor]


def synthetic_pair_draws(generator: torch.Generator, batch: int, h: int,
                         w: int, local_blobs: int = 0,
                         full_affine: bool = False,
                         hard_objects: int = 0) -> Draws:
    """The random arrays of one synthetic batch, uniform on the reference's
    ranges, on the generator's device:

    - ``base`` (batch, h + 16, w + 16) on [0, 255): the texture;
    - ``t`` (batch, 1, 1, 2) on [-3, 3): the translation;
    - ``a`` (batch, 1, 1, 2) on [-1, 1): the diagonal linear term, or with
      `full_affine` ``theta`` (batch, 1, 1) on [-0.07, 0.07) and ``s``
      (batch, 1, 1) on [0.95, 1.07): rotation and zoom;
    - with `local_blobs` n: ``blob_c`` (batch, n, 2) on [0.15, 0.85),
      ``blob_sig`` (batch, n, 1, 1) on [0.06, 0.2), ``blob_u`` (batch, n,
      1, 1, 2) on [-3, 3): Gaussian-windowed local translations;
    - with `hard_objects` n: ``obj_tex`` (batch, h, w) on [0, 255),
      ``obj_c`` (batch, n, 2) on [0.2, 0.8), ``obj_half`` (batch, n, 1, 1)
      on [0.05, 0.12), ``obj_u`` (batch, n, 2) on [-4, 4): sharp-edged
      squares with their own velocity."""
    dev = generator.device

    def uniform(shape, lo, hi):
        return (torch.rand(shape, generator=generator, device=dev)
                * (hi - lo) + lo)

    d = {"base": uniform((batch, h + 16, w + 16), 0.0, 255.0),
         "t": uniform((batch, 1, 1, 2), -3.0, 3.0)}
    if full_affine:
        d["theta"] = uniform((batch, 1, 1), -0.07, 0.07)
        d["s"] = uniform((batch, 1, 1), 0.95, 1.07)
    else:
        d["a"] = uniform((batch, 1, 1, 2), -1.0, 1.0)
    if local_blobs:
        d["blob_c"] = uniform((batch, local_blobs, 2), 0.15, 0.85)
        d["blob_sig"] = uniform((batch, local_blobs, 1, 1), 0.06, 0.2)
        d["blob_u"] = uniform((batch, local_blobs, 1, 1, 2), -3.0, 3.0)
    if hard_objects:
        d["obj_tex"] = uniform((batch, h, w), 0.0, 255.0)
        d["obj_c"] = uniform((batch, hard_objects, 2), 0.2, 0.8)
        d["obj_half"] = uniform((batch, hard_objects, 1, 1), 0.05, 0.12)
        d["obj_u"] = uniform((batch, hard_objects, 2), -4.0, 4.0)
    return d


def _pad_edge(x: torch.Tensor, n: int) -> torch.Tensor:
    """(B, H, W, C) replicate-padded by n on H and W."""
    return F.pad(x.permute(0, 3, 1, 2), (n, n, n, n),
                 mode="replicate").permute(0, 2, 3, 1)


def synthetic_pair_from_draws(draws: Mapping[str, torch.Tensor]
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """(prev, nxt, gt_flow) from ``synthetic_pair_draws``' arrays, with the
    reference's construction (``synthetic_pair``): band-limited texture at
    two scales stretched to full contrast; a translation plus a diagonal
    linear or a similarity field; Gaussian-windowed local translations
    (``blob_*``); ``nxt`` the texture warped by −gt, so that
    ``warp_by_flow(nxt, gt) ≈ prev``; and sharp-edged textured squares
    (``obj_*``) pasted into both frames with their own velocity (flow
    discontinuities, occluded and disoccluded strips).  Which regimes apply
    follows from the keys present."""
    base = draws["base"]
    batch, h, w = base.shape[0], base.shape[1] - 16, base.shape[2] - 16
    f32, dev = torch.float32, base.device
    base = gaussian_blur(base, 1.5) * 0.5 + gaussian_blur(base, 5.0)
    lo = base.amin(dim=(1, 2), keepdim=True)
    hi = base.amax(dim=(1, 2), keepdim=True)
    base = (base - lo) / torch.clamp(hi - lo, min=1e-6) * 255.0
    prev = base[:, 8:8 + h, 8:8 + w]
    yy = (torch.arange(h, dtype=f32, device=dev) / h - 0.5)[:, None]
    xx = (torch.arange(w, dtype=f32, device=dev) / w - 0.5)[None, :]
    yy, xx = yy.expand(batch, h, w), xx.expand(batch, h, w)
    t = draws["t"]
    if "theta" in draws:
        # s·R(θ) − I on centred pixel coordinates.
        theta, s = draws["theta"], draws["s"]
        x_px, y_px = xx * w, yy * h
        c, sn = torch.cos(theta), torch.sin(theta)
        gx = (s * c - 1.0) * x_px - s * sn * y_px
        gy = s * sn * x_px + (s * c - 1.0) * y_px
        gt = t + torch.stack([gx, gy], dim=-1)
    else:
        gt = t + draws["a"] * torch.stack([xx, yy], dim=-1)
    if "blob_c" in draws:
        cs, sig, us = draws["blob_c"], draws["blob_sig"], draws["blob_u"]
        px, py = xx + 0.5, yy + 0.5
        for i in range(cs.shape[1]):
            d2 = ((px - cs[:, i, 0, None, None]) ** 2
                  + (py - cs[:, i, 1, None, None]) ** 2)
            wgt = torch.exp(-d2 / (2.0 * sig[:, i] ** 2))
            gt = gt + wgt[..., None] * us[:, i]
    nxt = warp_by_flow(base[..., None], _pad_edge(-gt, 8))[
        :, 8:8 + h, 8:8 + w, 0]
    if "obj_c" in draws:
        tex = gaussian_blur(draws["obj_tex"], 2.0) * 0.5 + 110.0
        px, py = (xx + 0.5) * w, (yy + 0.5) * h
        cs = draws["obj_c"] * torch.tensor([w, h], dtype=f32, device=dev)
        half = draws["obj_half"] * min(h, w)
        uo = draws["obj_u"]
        for i in range(cs.shape[1]):
            cx, cy = cs[:, i, 0, None, None], cs[:, i, 1, None, None]
            ux, uy = uo[:, i, 0, None, None], uo[:, i, 1, None, None]
            hf = half[:, i]
            inside_prev = ((px - cx).abs() < hf) & ((py - cy).abs() < hf)
            inside_next = (((px - (cx + ux)).abs() < hf)
                           & ((py - (cy + uy)).abs() < hf))
            shift = (-uo[:, i, None, None, :]).expand(batch, h, w, 2)
            tex_shift = warp_by_flow(tex[..., None], shift)[..., 0]
            prev = torch.where(inside_prev, tex, prev)
            nxt = torch.where(inside_next, tex_shift, nxt)
            gt = torch.where(inside_prev[..., None],
                             uo[:, i, None, None, :], gt)
    return prev, nxt, gt


def synthetic_pair(generator: torch.Generator, batch: int, h: int, w: int,
                   local_blobs: int = 0, full_affine: bool = False,
                   hard_objects: int = 0,
                   device: Union[str, torch.device, None] = None):
    """Random band-limited images and smooth (or, with `hard_objects`,
    discontinuous) flows: (prev, nxt, gt) with prev(p) ≈ nxt(p + gt(p)).
    Drawn on the generator's device, built on `device` (default the
    same)."""
    draws = synthetic_pair_draws(generator, batch, h, w, local_blobs,
                                 full_affine, hard_objects)
    if device is not None:
        draws = {k: v.to(device) for k, v in draws.items()}
    return synthetic_pair_from_draws(draws)


def spynet_loss(model: SpyNet, prev: torch.Tensor, nxt: torch.Tensor,
                gt: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss, epe): the deep-supervision loss, the mean end-point error
    (+1e-6 under the root) of every level against the ground truth resized
    linearly to it and scaled by h / H, summed over levels; and the final
    flow's mean EPE (+1e-8)."""
    flow, per_level = model(prev, nxt, train_all_levels=True)
    loss = 0.0
    for f in per_level:
        h, w = f.shape[1:3]
        gt_k = resize_linear(gt, (h, w)) * (h / gt.shape[1])
        loss = loss + torch.sqrt(((f - gt_k) ** 2).sum(-1) + 1e-6).mean()
    epe = torch.sqrt(((flow - gt) ** 2).sum(-1) + 1e-8).mean()
    return loss, epe


def make_spynet_train_step(model: SpyNet, optimizer: torch.optim.Optimizer,
                           batch: int = 8, hw: Tuple[int, int] = (64, 64),
                           local_blobs: int = 0, full_affine: bool = False,
                           hard_objects: int = 0
                           ) -> Callable[[torch.Generator],
                                         Tuple[torch.Tensor, torch.Tensor]]:
    """``step(generator) → (loss, epe)``: draw a synthetic batch from the
    generator (built on the model's device), take one optimizer step on
    ``spynet_loss``; both results are detached 0-d tensors on the model's
    device."""
    device = next(model.parameters()).device

    def step(generator: torch.Generator):
        prev, nxt, gt = synthetic_pair(generator, batch, *hw,
                                       local_blobs=local_blobs,
                                       full_affine=full_affine,
                                       hard_objects=hard_objects,
                                       device=device)
        optimizer.zero_grad(set_to_none=True)
        loss, epe = spynet_loss(model, prev, nxt, gt)
        loss.backward()
        optimizer.step()
        return loss.detach(), epe.detach()

    return step
