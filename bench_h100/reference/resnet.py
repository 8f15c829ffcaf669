"""Plain ResNet-18 (He et al. 2015, torchvision's layout and parameter
names) in float32, in eval mode: the benchmark's frozen reference of
both two-stream CNNs.

7×7/2 stem, BatchNorm, ReLU, 3×3/2 max-pool, four stages of two
BasicBlocks (64, 128, 256, 512 channels; a 1×1/2 projection where the
shape changes), global average pool, fully connected head.  Inputs are
NHWC, as the two-stream pipeline hands them over.

``precision="fp8"`` is the control: every convolution and the head take
their input and weight rounded to float8 e4m3 with a per-tensor scale
(amax to 448), accumulate in float32 and keep BatchNorm and the rest in
float32: one step below the bfloat16 the configuration states.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale, back in
    float32."""
    amax = x.abs().amax().clamp(min=1e-12)
    scale = E4M3_MAX / amax
    return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


class ResNet18:
    """Eval-mode ResNet-18 over a state dict of float32 tensors
    (torchvision's names: ``conv1.weight``, ``bn1.running_mean``,
    ``layer2.0.downsample.0.weight``, ``fc.bias``, ...)."""

    STAGES = (2, 2, 2, 2)

    def __init__(self, state: Dict[str, torch.Tensor],
                 precision: str = "float32", eps: float = 1e-5):
        if precision not in ("float32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.p = state
        self.precision = precision
        self.eps = eps

    def _q(self, x: torch.Tensor) -> torch.Tensor:
        return _fp8(x) if self.precision == "fp8" else x

    def _conv(self, x, name, stride, padding):
        return F.conv2d(self._q(x), self._q(self.p[name + ".weight"]),
                        None, stride, padding)

    def _bn(self, x, name):
        p = self.p
        scale = p[name + ".weight"] / torch.sqrt(p[name + ".running_var"]
                                                 + self.eps)
        shift = p[name + ".bias"] - p[name + ".running_mean"] * scale
        return x * scale[None, :, None, None] + shift[None, :, None, None]

    def _block(self, x, name, stride):
        y = F.relu(self._bn(self._conv(x, name + ".conv1", stride, 1),
                            name + ".bn1"))
        y = self._bn(self._conv(y, name + ".conv2", 1, 1), name + ".bn2")
        if name + ".downsample.0.weight" in self.p:
            x = self._bn(self._conv(x, name + ".downsample.0", stride, 0),
                         name + ".downsample.1")
        return F.relu(y + x)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """(N, H, W, C) float32 → (N, classes) float32 logits."""
        x = x.float().permute(0, 3, 1, 2)
        x = F.relu(self._bn(self._conv(x, "conv1", 2, 3), "bn1"))
        x = F.max_pool2d(x, 3, 2, 1)
        for stage, blocks in enumerate(self.STAGES):
            for b in range(blocks):
                stride = 2 if stage > 0 and b == 0 else 1
                x = self._block(x, f"layer{stage + 1}.{b}", stride)
        x = x.mean(dim=(2, 3))
        return F.linear(self._q(x), self._q(self.p["fc.weight"]),
                        self.p["fc.bias"])


def parameter_shapes(in_channels: int, num_classes: int, width: int = 64
                     ) -> Dict[str, tuple]:
    """Every tensor of a ResNet-18's state dict and its shape, in
    torchvision's order (BatchNorm: weight, bias, running_mean,
    running_var)."""
    shapes: Dict[str, tuple] = {}

    def conv(name, cin, cout, k):
        shapes[name + ".weight"] = (cout, cin, k, k)

    def bn(name, c):
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            shapes[f"{name}.{leaf}"] = (c,)

    conv("conv1", in_channels, width, 7)
    bn("bn1", width)
    cin = width
    for stage, blocks in enumerate(ResNet18.STAGES):
        cout = width * 2 ** stage
        for b in range(blocks):
            name = f"layer{stage + 1}.{b}"
            stride = 2 if stage > 0 and b == 0 else 1
            conv(name + ".conv1", cin, cout, 3)
            bn(name + ".bn1", cout)
            conv(name + ".conv2", cout, cout, 3)
            bn(name + ".bn2", cout)
            if stride != 1 or cin != cout:
                conv(name + ".downsample.0", cin, cout, 1)
                bn(name + ".downsample.1", cout)
            cin = cout
    shapes["fc.weight"] = (num_classes, cin)
    shapes["fc.bias"] = (num_classes,)
    return shapes
