"""Plain R(2+1)D-34 (Tran et al., "A Closer Look at Spatiotemporal
Convolutions for Action Recognition", CVPR 2018, arXiv:1711.11248) in
float32, in eval mode: the benchmark's frozen reference of both streams
of an R(2+1)D configuration (a copy of the port's test reference).

Written from the paper's equations, in plain ``torch.nn.functional``
operations, importing nothing of the program and nothing of JAX.  Each
3×3×3 convolution of the 3D ResNet-34 (stages [3, 4, 6, 3] of basic
blocks, widths w, 2w, 4w, 8w) is a 1×3×3 convolution to M channels,
BatchNorm and ReLU, then a 3×1×1 convolution to N_out, with M =
⌊27·N_in·N_out / (9·N_in + 3·N_out)⌋ for each convolution.  Stem: 1×7×7
(stride 1, 2, 2) to 45 channels, BatchNorm, ReLU, 3×1×1 to w, BatchNorm,
ReLU.  The first block of stages 2-4 has stride 2 in time and space (the
spatial factor's stride (1, 2, 2), the temporal factor's (2, 1, 1)) and
a 1×1×1 stride-2 projection with BatchNorm on its shortcut.  Global 3D
average pool, fully connected head.

Parameters are a state dict of float32 tensors under the program's names
(``conv1.spatial.weight``, ``conv1.bn.running_var``,
``layer2.0.conv1.temporal.weight``, ``layer2.0.downsample.1.bias``,
``fc.weight``, ...).  Inputs are (N, T, H, W, C) clip volumes.  The
forward pass runs `block` clips at a time; TF32 is off while it runs.

``precision="fp8"`` is a control: every convolution and the head take
their input and weight rounded to float8 e4m3 under a per-tensor scale
(amax to 448), accumulate in float32 and keep BatchNorm and the rest in
float32.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

STAGES = (3, 4, 6, 3)
STEM_MIDPLANES = 45
E4M3_MAX = 448.0


def midplanes(n_in: int, n_out: int) -> int:
    """M of a 3×3×3 convolution from n_in to n_out channels."""
    return (27 * n_in * n_out) // (9 * n_in + 3 * n_out)


def _fp8(x: torch.Tensor) -> torch.Tensor:
    amax = x.abs().amax().clamp(min=1e-12)
    scale = E4M3_MAX / amax
    return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


def _blocks(width: int):
    """(name, in channels, out channels, stride) of every basic block."""
    cin = width
    for stage, n in enumerate(STAGES):
        cout = width * 2 ** stage
        for b in range(n):
            yield (f"layer{stage + 1}.{b}", cin, cout,
                   2 if stage > 0 and b == 0 else 1)
            cin = cout


def parameter_shapes(in_channels: int, num_classes: int, width: int = 64
                     ) -> Dict[str, tuple]:
    """Every tensor of a stream's state dict and its shape, in the
    module order (BatchNorm: weight, bias, running_mean, running_var)."""
    shapes: Dict[str, tuple] = {}

    def bn(name, c):
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            shapes[f"{name}.{leaf}"] = (c,)

    def conv2plus1d(name, cin, mid, cout, k):
        shapes[name + ".spatial.weight"] = (mid, cin, 1, k, k)
        bn(name + ".bn", mid)
        shapes[name + ".temporal.weight"] = (cout, mid, 3, 1, 1)

    conv2plus1d("conv1", in_channels, STEM_MIDPLANES, width, 7)
    bn("bn1", width)
    cin = width
    for name, cin, cout, stride in _blocks(width):
        conv2plus1d(name + ".conv1", cin, midplanes(cin, cout), cout, 3)
        bn(name + ".bn1", cout)
        conv2plus1d(name + ".conv2", cout, midplanes(cout, cout), cout, 3)
        bn(name + ".bn2", cout)
        if stride != 1 or cin != cout:
            shapes[name + ".downsample.0.weight"] = (cout, cin, 1, 1, 1)
            bn(name + ".downsample.1", cout)
        cin = cout
    shapes["fc.weight"] = (num_classes, cin)
    shapes["fc.bias"] = (num_classes,)
    return shapes


class R2Plus1D34:
    """Eval-mode R(2+1)D-34 over a state dict (see the module's names)."""

    def __init__(self, state: Dict[str, torch.Tensor],
                 precision: str = "float32", eps: float = 1e-5,
                 block: int = 4):
        if precision not in ("float32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.p, self.precision, self.eps = state, precision, eps
        self.block = block
        self.width = state["bn1.weight"].shape[0]

    def _q(self, x: torch.Tensor) -> torch.Tensor:
        return _fp8(x) if self.precision == "fp8" else x

    def _conv(self, x, name, stride, padding):
        return F.conv3d(self._q(x), self._q(self.p[name + ".weight"]), None,
                        stride, padding)

    def _bn(self, x, name):
        p = self.p
        scale = p[name + ".weight"] / torch.sqrt(p[name + ".running_var"]
                                                 + self.eps)
        shift = p[name + ".bias"] - p[name + ".running_mean"] * scale
        return (x * scale.view(1, -1, 1, 1, 1)
                + shift.view(1, -1, 1, 1, 1))

    def _conv2plus1d(self, x, name, stride, t_stride, k):
        y = F.relu(self._bn(self._conv(x, name + ".spatial",
                                       (1, stride, stride),
                                       (0, k // 2, k // 2)), name + ".bn"))
        return self._conv(y, name + ".temporal", (t_stride, 1, 1),
                          (1, 0, 0))

    def _block(self, x, name, stride):
        y = F.relu(self._bn(self._conv2plus1d(x, name + ".conv1", stride,
                                              stride, 3), name + ".bn1"))
        y = self._bn(self._conv2plus1d(y, name + ".conv2", 1, 1, 3),
                     name + ".bn2")
        if name + ".downsample.0.weight" in self.p:
            x = self._bn(self._conv(x, name + ".downsample.0", stride, 0),
                         name + ".downsample.1")
        return F.relu(y + x)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float().permute(0, 4, 1, 2, 3)
        x = F.relu(self._bn(self._conv2plus1d(x, "conv1", 2, 1, 7), "bn1"))
        for name, _, _, stride in _blocks(self.width):
            x = self._block(x, name, stride)
        x = x.mean(dim=(2, 3, 4))
        return F.linear(self._q(x), self._q(self.p["fc.weight"]),
                        self.p["fc.bias"])

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
