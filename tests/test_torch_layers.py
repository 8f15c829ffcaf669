"""``ops/layers.Conv3d``'s 2-D route for t×1×1 kernels against
``nn.Conv3d``'s own call, on the CPU.

Every distinct temporal convolution of R(2+1)D-34 (channels and t-stride
at published widths) runs through the route in float32 and bfloat16 on a
small volume, the plane threshold lifted (``MIN_PLANE = 0`` on the
layer), and at the plane it has in a 112² clip under the layer's own
rule; other kernels must keep the 3-D call."""

import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from video_analytics_tpu_torch.models.video_resnet import r2plus1d_34
from video_analytics_tpu_torch.ops.layers import Conv3d

torch.set_num_threads(1)

CL3 = torch.channels_last_3d
# (C_in, C_out, t-stride, side of the H×W plane in a 112² clip) of
# R(2+1)D-34's temporal convolutions: the stem's, then each stage's first
# block (stages 2-4 halve time) and its other blocks.
TEMPORAL = {
    "stem": (45, 64, 1, 56),
    "stage1": (144, 64, 1, 56),
    "stage2.first": (230, 128, 2, 28),
    "stage2": (288, 128, 1, 28),
    "stage3.first": (460, 256, 2, 14),
    "stage3": (576, 256, 1, 14),
    "stage4.first": (921, 512, 2, 7),
    "stage4": (1152, 512, 1, 7),
}
# t×1×1 kernels of one stream: the stem's 1, then two a block over
# stages of 3, 4, 6 and 3 blocks.  Routed at 112²: the stem's and stage
# 1's six, on 56² planes.
TEMPORAL_A_STREAM = 1 + 2 * (3 + 4 + 6 + 3)
ROUTED_A_STREAM = 1 + 2 * 3


def _temporal(name: str, dtype=torch.float32, bias=False,
              any_plane=True) -> Conv3d:
    cin, cout, ts, _ = TEMPORAL[name]
    torch.manual_seed(sum(map(ord, name)))
    conv = Conv3d(cin, cout, (3, 1, 1), (ts, 1, 1), (1, 0, 0), bias=bias,
                  dtype=dtype)
    if any_plane:
        conv.MIN_PLANE = 0
    if bias:
        with torch.no_grad():
            conv.bias.uniform_(-1, 1)
    return conv


def _volume(cin: int, dtype=torch.float32, t=5, h=3, w=4, n=2
            ) -> torch.Tensor:
    g = torch.Generator().manual_seed(cin)
    return torch.randn(n, cin, t, h, w, generator=g).to(dtype).contiguous(
        memory_format=CL3)


def _reference(conv: nn.Conv3d, x, weight, bias):
    return F.conv3d(x, weight, bias, conv.stride, conv.padding,
                    conv.dilation, conv.groups)


class _Spy:
    """Records the input and output of each ``F.conv2d`` and
    ``F.conv3d`` call while installed."""

    def __init__(self, monkeypatch):
        self.calls = {"conv2d": [], "conv3d": []}
        for name in self.calls:
            monkeypatch.setattr(F, name, self._wrap(name, getattr(F, name)))

    def _wrap(self, name, fn):
        def spy(x, *args, **kwargs):
            y = fn(x, *args, **kwargs)
            self.calls[name].append((x, y))
            return y
        return spy


@pytest.mark.parametrize("name", list(TEMPORAL))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_temporal_kernels_run_as_conv2d_on_a_view(name, dtype, monkeypatch):
    conv = _temporal(name, dtype)
    x = _volume(conv.in_channels, dtype)
    spy = _Spy(monkeypatch)
    before = Conv3d.as_conv2d
    with torch.no_grad():
        y = conv(x)
        want = _reference(conv, x, conv.weight.to(dtype), None)
    assert Conv3d.as_conv2d - before == 1
    assert len(spy.calls["conv2d"]) == 1 and len(spy.calls["conv3d"]) == 1
    seen, out = spy.calls["conv2d"][0]
    # The input reached cuDNN's 2-D call as a view, and the output left it
    # as one: channels-last in 2-D, channels-last-3d in 3-D.
    assert seen.data_ptr() == x.data_ptr()
    assert seen.shape == (*x.shape[:3], x.shape[3] * x.shape[4])
    assert seen.is_contiguous(memory_format=torch.channels_last)
    assert y.data_ptr() == out.data_ptr()
    assert y.is_contiguous(memory_format=CL3)
    assert y.shape == want.shape and y.dtype == dtype
    if dtype == torch.float32:
        torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-5)
    else:
        # One bfloat16 rounding of the same float32 sums (2^-8 relative).
        scale = want.float().abs().max()
        torch.testing.assert_close(y.float(), want.float(), rtol=2 ** -8,
                                   atol=1e-5 * float(scale))


@pytest.mark.parametrize("name", list(TEMPORAL))
def test_temporal_kernels_keep_conv3d_gradients(name):
    conv = _temporal(name, bias=True)
    x = _volume(conv.in_channels).requires_grad_()
    x_ref = x.detach().clone().requires_grad_()
    w_ref = conv.weight.detach().clone().requires_grad_()
    b_ref = conv.bias.detach().clone().requires_grad_()
    before = Conv3d.as_conv2d
    y = conv(x)
    want = _reference(conv, x_ref, w_ref, b_ref)
    assert Conv3d.as_conv2d - before == 1
    torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-5)
    g = torch.randn(want.shape, generator=torch.Generator().manual_seed(9))
    y.backward(g)
    want.backward(g)
    for got, ref in ((x.grad, x_ref.grad), (conv.weight.grad, w_ref.grad),
                     (conv.bias.grad, b_ref.grad)):
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("name", ["stem", "stage1", "stage2.first"])
def test_bfloat16_bias_is_added_after_the_rounding(name):
    """A folded layer: the routed product rounded to bfloat16, then the
    bias cast to bfloat16 added (two roundings, not a fused bias)."""
    conv = _temporal(name, torch.bfloat16, bias=True)
    x = _volume(conv.in_channels, torch.bfloat16)
    with torch.no_grad():
        y = conv(x)
        product = conv._conv_forward(x, conv.weight.to(torch.bfloat16), None)
        fused = F.conv3d(x.float(), conv.weight, conv.bias, conv.stride,
                         conv.padding).to(torch.bfloat16)
    want = product + conv.bias.to(torch.bfloat16).view(-1, 1, 1, 1)
    assert torch.equal(y, want)
    assert not torch.equal(y, fused)
    assert y.is_contiguous(memory_format=CL3)


@pytest.mark.parametrize("memory_format", [torch.contiguous_format, CL3])
@pytest.mark.parametrize("n", [1, 2])
def test_the_route_keeps_the_input_memory_format(memory_format, n,
                                                 monkeypatch):
    """Also for a batch of one clip (a served request), whose strides
    ``flatten`` would leave ambiguous."""
    conv = _temporal("stage2.first")
    x = _volume(conv.in_channels, n=n).contiguous(memory_format=memory_format)
    spy = _Spy(monkeypatch)
    with torch.no_grad():
        y = conv(x)
        want = _reference(conv, x, conv.weight, None)
    seen, _ = spy.calls["conv2d"][0]
    assert seen.data_ptr() == x.data_ptr()
    if memory_format == CL3:
        assert seen.stride() == (seen[0].numel(), 1, *seen.stride()[2:])
        assert seen.is_contiguous(memory_format=torch.channels_last)
        assert y.stride() == (y[0].numel(), 1, *y.stride()[2:])
    assert y.is_contiguous(memory_format=memory_format)
    torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kernel, stride, padding, kw", [
    ((1, 3, 3), (1, 1, 1), (0, 1, 1), {}),          # spatial factor
    ((1, 3, 3), (1, 2, 2), (0, 1, 1), {}),          # its stride-2 form
    ((1, 7, 7), (1, 2, 2), (0, 3, 3), {}),          # the stem's
    ((1, 1, 1), (2, 2, 2), (0, 0, 0), {}),          # stride-2 projection
    ((3, 1, 1), (1, 1, 1), (1, 1, 1), {}),          # spatially padded
    ((3, 1, 1), (1, 2, 2), (1, 0, 0), {}),          # spatial stride
    ((3, 1, 1), (1, 1, 1), (2, 0, 0), {"dilation": (2, 1, 1)}),
    ((3, 1, 1), (1, 1, 1), (1, 0, 0), {"groups": 2}),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_other_kernels_keep_the_3d_call(kernel, stride, padding, kw, dtype,
                                        monkeypatch):
    torch.manual_seed(3)
    conv = Conv3d(8, 16, kernel, stride, padding, bias=False, dtype=dtype,
                  **kw)
    conv.MIN_PLANE = 0
    x = _volume(8, dtype)
    spy = _Spy(monkeypatch)
    before = Conv3d.as_conv2d
    with torch.no_grad():
        y = conv(x)
    assert Conv3d.as_conv2d == before
    assert not spy.calls["conv2d"] and len(spy.calls["conv3d"]) == 1
    with torch.no_grad():
        want = _reference(conv, x, conv.weight.to(dtype), None)
    assert torch.equal(y, want)


@pytest.mark.parametrize("name", list(TEMPORAL))
def test_the_route_takes_the_planes_of_56_squared(name, monkeypatch):
    """At its plane in a 112² clip each temporal convolution is routed iff
    the plane holds ``MIN_PLANE`` positions: the stem's and stage 1's."""
    conv = _temporal(name, any_plane=False)
    side = TEMPORAL[name][3]
    x = _volume(conv.in_channels, t=4, h=side, w=side)
    spy = _Spy(monkeypatch)
    before = Conv3d.as_conv2d
    with torch.no_grad():
        y = conv(x)
        want = _reference(conv, x, conv.weight, None)
    routed = name in ("stem", "stage1")
    assert conv.takes_conv2d(x) == routed == (side * side >= Conv3d.MIN_PLANE)
    assert Conv3d.as_conv2d - before == len(spy.calls["conv2d"]) == routed
    assert y.is_contiguous(memory_format=CL3) or not routed
    torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("in_channels", [3, 2])
def test_a_stream_routes_the_stem_and_stage_1(in_channels):
    model = r2plus1d_34(7, in_channels=in_channels, width=8).eval()
    temporal = [m for m in model.modules()
                if isinstance(m, Conv3d) and m.kernel_size == (3, 1, 1)]
    assert len(temporal) == TEMPORAL_A_STREAM == 33
    x = torch.randn(1, 4, 112, 112, in_channels,
                    generator=torch.Generator().manual_seed(4))
    before = Conv3d.as_conv2d
    with torch.no_grad():
        model(x)
    assert Conv3d.as_conv2d - before == ROUTED_A_STREAM == 7
