"""The fused norm pass (``ops/cuda/bn_act``) on the CPU: its plain version
against the module path it replaces (eval ``BatchNorm2d`` /
``BatchNorm3d``, then ``+ residual``, then ``torch.relu``), and where
``models/resnet.norm_act`` keeps the module path.

The CPU's BatchNorm computes ``x·α + β`` with α = w·invstd and β = b −
mean·α, in fused multiply-adds where the CPU has them; the kernel and
``bn_act_plain`` compute ``((x − mean)·invstd)·w + b``, as the card's
ATen kernel does.  On values whose products and sums are exact in float32
(multiples of 1/8, invstd a power of two) every order gives the same
float32 value, so there the two paths must agree to the bit in both
dtypes: that holds the channel indexing, the parameters, the add and the
ReLU.  On random values the orders differ in float32 by roundings of the
operands, so in bfloat16 each element may differ by one bfloat16 ulp of
the largest operand it was computed from.  The card's tests hold the
kernel to ``bn_act_plain`` bit for bit at random values."""

import os
import re

import pytest
import torch

from video_analytics_tpu_torch.models.resnet import (
    BatchNorm2d, BatchNorm3d, fusable, norm_act, resnet18)
from video_analytics_tpu_torch.ops.cuda._build import CSRC
from video_analytics_tpu_torch.ops.cuda.bn_act import (
    MAX_CHANNELS, bn_act, bn_act_plain, layout_error)

torch.set_num_threads(1)

SHAPES = {2: (3, 45, 5, 7), 3: (2, 45, 3, 5, 7)}
FORMATS = {2: torch.channels_last, 3: torch.channels_last_3d}
CASES = [(rank, residual, relu) for rank in (2, 3)
         for residual in (False, True) for relu in (False, True)]


def _norm(rank: int, exact: bool, seed: int = 0) -> torch.nn.Module:
    """An eval BatchNorm of SHAPES[rank]'s channels.  `exact`: mean,
    weight and bias multiples of 1/8 and var + eps a power of four, so
    invstd is a power of two."""
    C = SHAPES[rank][1]
    g = torch.Generator().manual_seed(seed)
    norm = (BatchNorm2d if rank == 2 else BatchNorm3d)(C).eval()
    with torch.no_grad():
        if exact:
            eighths = lambda lo, hi: torch.randint(lo, hi, (C,),
                                                   generator=g) / 8.0
            norm.running_mean.copy_(eighths(-8, 9))
            norm.weight.copy_(eighths(1, 17) * torch.where(
                torch.rand(C, generator=g) < 0.5, -1.0, 1.0))
            norm.bias.copy_(eighths(-8, 9))
            powers = torch.tensor([0.25, 1.0, 4.0])[
                torch.randint(0, 3, (C,), generator=g)]
            norm.running_var.copy_(powers - norm.eps)
            invstd = torch.sqrt(norm.running_var + norm.eps).reciprocal()
            assert torch.equal(invstd, powers.rsqrt())
        else:
            norm.running_mean.uniform_(-1, 1, generator=g)
            norm.running_var.uniform_(0.5, 2, generator=g)
            norm.weight.uniform_(-1.5, 1.5, generator=g)
            norm.bias.uniform_(-1, 1, generator=g)
    return norm


def _activation(rank: int, dtype: torch.dtype, exact: bool,
                seed: int) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    shape = SHAPES[rank]
    x = (torch.randint(-32, 33, shape, generator=g) / 8.0 if exact
         else 3 * torch.randn(shape, generator=g))
    return x.to(dtype).contiguous(memory_format=FORMATS[rank])


def _module_path(norm, x, residual, relu):
    with torch.no_grad():
        y = norm(x)
        if residual is not None:
            y = y + residual
        return torch.relu(y) if relu else y


def _both(norm, x, residual, relu):
    args = (norm.running_mean, norm.running_var, norm.weight, norm.bias,
            norm.eps, residual, relu)
    return bn_act(x, *args), bn_act_plain(x, *args)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rank,residual,relu", CASES)
def test_plain_equals_the_module_path_on_exact_values(rank, residual, relu,
                                                      dtype):
    norm = _norm(rank, exact=True)
    x = _activation(rank, dtype, True, 1)
    r = _activation(rank, dtype, True, 2) if residual else None
    want = _module_path(norm, x, r, relu)
    before = bn_act.launches
    for got in _both(norm, x, r, relu):
        assert got.dtype == dtype
        assert torch.equal(got, want)
    assert bn_act.launches == before          # the CPU runs the plain form
    assert (want < 0).any() != relu and (want != 0).any()


@pytest.mark.parametrize("rank,residual,relu", CASES)
def test_plain_keeps_one_bfloat16_ulp_of_the_module_path(rank, residual,
                                                         relu):
    norm = _norm(rank, exact=False, seed=3)
    x = _activation(rank, torch.bfloat16, False, 4)
    r = _activation(rank, torch.bfloat16, False, 5) if residual else None
    want = _module_path(norm, x, r, relu).float()
    shape = (1, -1) + (1,) * rank
    normed = ((x.float() - norm.running_mean.view(shape))
              * torch.rsqrt(norm.running_var + norm.eps).view(shape)
              * norm.weight.view(shape))
    largest = torch.maximum(normed.abs(), norm.bias.view(shape).abs())
    if r is not None:
        largest = torch.maximum(largest, r.float().abs())
    ulp = torch.ldexp(torch.ones_like(largest), torch.frexp(largest)[1] - 8)
    for got in _both(norm, x, r, relu):
        diff = (got.float() - want).abs()
        assert (diff <= ulp).all(), diff.max()
        assert (diff == 0).float().mean() > 0.95


def test_plain_rounds_like_the_model_in_float32():
    """float32 at random values: the two orders of the same affine map
    agree to a few roundings of the operands."""
    norm = _norm(3, exact=False, seed=6)
    x = _activation(3, torch.float32, False, 7)
    r = _activation(3, torch.float32, False, 8)
    want = _module_path(norm, x, r, True)
    got = bn_act_plain(x, norm.running_mean, norm.running_var, norm.weight,
                       norm.bias, norm.eps, r, True)
    scale = x.abs().max() * 4 + r.abs().max() + 2
    assert (got - want).abs().max() <= 8 * torch.finfo(torch.float32).eps \
        * scale


def _eligible(rank: int = 3):
    norm = _norm(rank, exact=False)
    x = _activation(rank, torch.bfloat16, False, 9)
    return norm, x


def test_fusable_in_eval_on_channels_last_without_grad():
    norm, x = _eligible()
    with torch.no_grad():
        assert fusable(norm, x)
        assert fusable(norm, x, x.clone())
    # Grad mode on, but nothing that autograd would record.
    for p in norm.parameters():
        p.requires_grad_(False)
    assert fusable(norm, x)


@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16])
def test_fusable_needs_float32_statistics(dtype):
    """The kernel reads the statistics and affine parameters as float32: a
    norm holding them in another dtype keeps the module path."""
    norm, x = _eligible()
    with torch.no_grad():
        assert not fusable(norm.to(dtype), x)


def test_fusable_needs_the_relu_after_a_residual():
    """The kernel adds a residual only with the ReLU after it, as every
    block ends; the norm alone may leave the ReLU out."""
    norm, x = _eligible()
    with torch.no_grad():
        assert fusable(norm, x, x.clone())
        assert not fusable(norm, x, x.clone(), relu=False)
        assert fusable(norm, x, relu=False)


def test_max_channels_is_the_kernels_limit():
    """``MAX_CHANNELS`` mirrors csrc/bn_act.cu's ``BN_MAX_C``."""
    with open(os.path.join(CSRC, "bn_act.cu")) as f:
        limit = re.search(r"constexpr int BN_MAX_C = (\d+);", f.read())
    assert limit is not None and int(limit.group(1)) == MAX_CHANNELS


def _training(norm, x):
    return norm.train(), x


def _identity(norm, x):
    return torch.nn.Identity(), x


def _contiguous(norm, x):
    return norm, x.contiguous()


def _half(norm, x):
    return norm, x.half()


def _recorded(norm, x):
    return norm, x.requires_grad_(True)


def _other_rank(norm, x):
    return BatchNorm2d(norm.num_features).eval(), x


@pytest.mark.parametrize("change", [_training, _identity, _contiguous, _half,
                                    _recorded, _other_rank])
def test_norm_act_takes_the_module_path(change):
    """Training, the folded form (``fold_bn=True``'s ``nn.Identity``), a
    contiguous (not channels-last) input, a dtype the kernel does not take
    and autograd recording each leave the fused pass; so does the CPU,
    which every case here is on."""
    norm, x = change(*_eligible())
    assert not fusable(norm, x)
    before = bn_act.launches
    if isinstance(norm, BatchNorm2d):
        with pytest.raises((ValueError, RuntimeError)):
            norm_act(norm, x)
        return
    r = torch.randn(x.shape, dtype=x.dtype).contiguous(
        memory_format=torch.channels_last_3d)
    with torch.no_grad():
        want = torch.relu(norm(x) + r)
    got = norm_act(norm, x, r)
    assert torch.equal(got.detach(), want)
    assert bn_act.launches == before


def test_resnet_on_the_cpu_answers_as_the_module_path():
    """A ResNet-18 forward on the CPU (every site through ``norm_act``)
    equals its blocks run as modules, and launches nothing."""
    net = resnet18(num_classes=5, width=8).eval()
    net.init(torch.Generator().manual_seed(0))
    x = torch.randn(2, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    before = bn_act.launches
    with torch.no_grad():
        got = net(x)
        h = x.permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        h = net.maxpool(torch.relu(net.bn1(net.conv1(h))))
        for stage in range(4):
            for block in getattr(net, f"layer{stage + 1}"):
                res = h if block.downsample is None else block.downsample(h)
                y = torch.relu(block.bn1(block.conv1(h)))
                h = torch.relu(block.bn2(block.conv2(y)) + res)
        want = net._head(h, False)
    assert torch.equal(got, want)
    assert bn_act.launches == before


def _misaligned(x):
    """A dense channels-last-3d view of `x`'s storage one element in."""
    n, c, t, h, w = x.shape
    flat = x.permute(0, 2, 3, 4, 1).flatten()
    return flat[1:1 + n * t * h * (w - 1) * c].view(
        n, t, h, w - 1, c).permute(0, 4, 1, 2, 3)


@pytest.mark.parametrize("bad,reason", [
    (lambda x: x.contiguous(), "channels-last"),
    (lambda x: x.half(), "dtype"),
    (lambda x: x[:, :, 0, 0], "4-D"),
    (_misaligned, "aligned"),
])
def test_layout_error_names_what_the_kernel_does_not_take(bad, reason):
    _, x = _eligible()
    assert layout_error(x) is None
    err = layout_error(bad(x))
    assert err is not None and reason in err
    assert "residual" in layout_error(x, x.contiguous())
