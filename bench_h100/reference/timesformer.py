"""Plain TimeSformer with divided space-time attention (Bertasius, Wang
and Torresani, "Is Space-Time Attention All You Need for Video
Understanding?", ICML 2021, arXiv:2102.05095) in float32, in eval mode:
the benchmark's frozen reference of both streams of a TimeSformer
configuration (a copy of the port's test reference).

Written from the paper's equations and facebookresearch/TimeSformer's
``vit.py`` (``attention_type='divided_space_time'``), in plain ``torch``
operations, importing nothing of the program and nothing of JAX.  A clip of
T frames is cut into 16×16 patches (P a frame), embedded by a stride-16
convolution; each frame's tokens [c; patches] get the spatial position
embedding, the patch tokens z(p, t) the time embedding's row t.  Each
block: the time half, z(p, ·) += temporal_fc(MSA_t(LN_t(z(p, ·)))) over
each patch's T tokens; the space half, s(·, t) = MSA_s(LN_1([c; z(·,
t)])) over each frame's P + 1 tokens, c += mean over t of s(0, t), z(p,
t) += s(p, t); the MLP, x += fc2(GELU(fc1(LN_2(x)))) over every token.
A final LayerNorm on c and the head.  Attention is written out as
softmax(Q·Kᵀ/√d)·V.

Departures from the published code, none of which changes a number:
the published model embeds every frame's class token and keeps
``x[:B, 0]``, the first B of B·T equal rows: one class token a clip,
taken here as c + E_pos[0] once; its tokens sit in one (B, 1 + P·T, D)
tensor rearranged between the halves, here c and z are held apart;
dropout and drop-path (0 in eval) are left out, and so is the
interpolation of the embeddings for another frame count or patch grid
(the clip must have the model's own).

Parameters are a state dict of float32 tensors under the published
names (``patch_embed.proj.weight``, ``cls_token``, ``pos_embed``,
``time_embed``, ``blocks.<i>.temporal_attn.qkv.weight``,
``blocks.<i>.temporal_fc.bias``, ``blocks.<i>.norm2.weight``,
``norm.bias``, ``head.weight``, ...).  Inputs are (N, T, H, W, C) clip
volumes.  The forward pass runs `block` clips at a time; TF32 is off
while it runs.

``precision="fp8"`` is a control: every product (the patch convolution,
each linear layer, Q·Kᵀ and the weights times V) takes its operands
rounded to float8 e4m3 under a per-tensor scale (amax to 448),
accumulates in float32 and keeps the rest in float32.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


def _fp8(x: torch.Tensor) -> torch.Tensor:
    amax = x.abs().amax().clamp(min=1e-12)
    scale = E4M3_MAX / amax
    return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


def parameter_shapes(in_channels: int, num_classes: int, width: int = 768,
                     depth: int = 12, mlp: int = 3072, patch: int = 16,
                     frames: int = 8, image_size: int = 224
                     ) -> Dict[str, tuple]:
    """Every tensor of a stream's state dict and its shape, in the module
    order."""
    shapes: Dict[str, tuple] = {
        "cls_token": (1, 1, width),
        "pos_embed": (1, (image_size // patch) ** 2 + 1, width),
        "time_embed": (1, frames, width),
        "patch_embed.proj.weight": (width, in_channels, patch, patch),
        "patch_embed.proj.bias": (width,)}

    def linear(name, n_in, n_out):
        shapes[name + ".weight"] = (n_out, n_in)
        shapes[name + ".bias"] = (n_out,)

    def norm(name):
        shapes[name + ".weight"] = (width,)
        shapes[name + ".bias"] = (width,)

    for i in range(depth):
        b = f"blocks.{i}."
        norm(b + "norm1")
        linear(b + "attn.qkv", width, 3 * width)
        linear(b + "attn.proj", width, width)
        norm(b + "temporal_norm1")
        linear(b + "temporal_attn.qkv", width, 3 * width)
        linear(b + "temporal_attn.proj", width, width)
        linear(b + "temporal_fc", width, width)
        norm(b + "norm2")
        linear(b + "mlp.fc1", width, mlp)
        linear(b + "mlp.fc2", mlp, width)
    norm("norm")
    linear("head", width, num_classes)
    return shapes


class TimeSformer:
    """Eval-mode divided space-time TimeSformer over a state dict (see the
    module's names); the widths, depth, patch, frames and image size are
    read from the tensors' shapes, the head count is given."""

    def __init__(self, state: Dict[str, torch.Tensor], heads: int = 12,
                 precision: str = "float32", eps: float = 1e-6,
                 block: int = 4):
        if precision not in ("float32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.p, self.heads, self.precision = state, heads, precision
        self.eps, self.block = eps, block
        self.width = state["cls_token"].shape[-1]
        self.patch = state["patch_embed.proj.weight"].shape[-1]
        self.depth = len({k.split(".")[1] for k in state
                          if k.startswith("blocks.")})

    def _q(self, x: torch.Tensor) -> torch.Tensor:
        return _fp8(x) if self.precision == "fp8" else x

    def _linear(self, x, name):
        return F.linear(self._q(x), self._q(self.p[name + ".weight"]),
                        self.p[name + ".bias"])

    def _norm(self, x, name):
        return F.layer_norm(x, (self.width,), self.p[name + ".weight"],
                            self.p[name + ".bias"], self.eps)

    def _attention(self, x, name):
        """softmax(Q·Kᵀ/√d)·V over (B, L, D) tokens, then the projection."""
        B, L, D = x.shape
        d = D // self.heads
        qkv = self._linear(x, name + ".qkv").reshape(
            B, L, 3, self.heads, d).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        scores = self._q(q) @ self._q(k).transpose(-2, -1) * d ** -0.5
        out = self._q(torch.softmax(scores, dim=-1)) @ self._q(v)
        return self._linear(out.transpose(1, 2).reshape(B, L, D),
                            name + ".proj")

    def _block(self, c, z, b):
        N, P, T, D = z.shape
        # Time: each patch's T tokens.
        a = self._attention(self._norm(z.reshape(N * P, T, D),
                                       b + "temporal_norm1"),
                            b + "temporal_attn")
        z = z + self._linear(a, b + "temporal_fc").reshape(N, P, T, D)
        # Space: each frame's class token and P patches.
        xs = torch.cat([c[:, None, None].expand(N, T, 1, D),
                        z.permute(0, 2, 1, 3)], dim=2).reshape(N * T, P + 1,
                                                               D)
        s = self._attention(self._norm(xs, b + "norm1"), b + "attn")
        s = s.reshape(N, T, P + 1, D)
        c = c + s[:, :, 0].mean(dim=1)
        z = z + s[:, :, 1:].permute(0, 2, 1, 3)

        def mlp(x):
            h = F.gelu(self._linear(self._norm(x, b + "norm2"),
                                    b + "mlp.fc1"))
            return x + self._linear(h, b + "mlp.fc2")
        return mlp(c), mlp(z)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.p
        N, T, H, W, C = x.shape
        D = self.width
        frames = F.conv2d(self._q(x.float().reshape(N * T, H, W, C)
                                  .permute(0, 3, 1, 2)),
                          self._q(p["patch_embed.proj.weight"]),
                          p["patch_embed.proj.bias"], stride=self.patch)
        tokens = frames.flatten(2).transpose(1, 2)          # (N·T, P, D)
        P = tokens.shape[1]
        pos = p["pos_embed"][0]
        c = (p["cls_token"][0, 0] + pos[0]).expand(N, D)
        z = (tokens + pos[1:]).reshape(N, T, P, D)
        z = (z + p["time_embed"][0][None, :, None]).permute(0, 2, 1, 3)
        for i in range(self.depth):
            c, z = self._block(c, z, f"blocks.{i}.")
        return self._linear(self._norm(c, "norm"), "head")

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """(N, T, H, W, C) → (N, classes) float32 logits."""
        flags = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            return torch.cat([self._forward(x[i:i + self.block])
                              for i in range(0, x.shape[0], self.block)])
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = flags
