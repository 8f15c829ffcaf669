"""Short-sequence attention (``ops/cuda/short_attn``) on the CPU: its plain
version against a float64 attention of the same rounded operands, the
bias's two roundings, ``layout_error``'s rules, the constants the kernel
source states, and ``models/timesformer.Attention`` keeping SDPA on the
CPU and in float32.  The card's tests (``tests/test_torch_cuda.py``) hold
the kernel to the same float64 attention and to SDPA."""

import os
import re

import pytest
import torch
import torch.nn.functional as F

from video_analytics_tpu_torch.models.timesformer import (
    Attention, TimeSformer)
from video_analytics_tpu_torch.ops.cuda._build import CSRC
from video_analytics_tpu_torch.ops.cuda.short_attn import (
    HEAD_WIDTH, MAX_LEN, MAX_WIDTH, layout_error, short_attn,
    short_attn_plain)

torch.set_num_threads(1)


def _inputs(B, L, heads, seed=0, dtype=torch.bfloat16):
    """A qkv product of B sequences of L tokens at `heads` heads of 64 and
    a float32 bias, both of the size a projection gives."""
    g = torch.Generator().manual_seed(seed)
    W = 3 * heads * HEAD_WIDTH
    y = torch.randn(B, L, W, generator=g).to(dtype)
    bias = 0.3 * torch.randn(W, generator=g)
    return y, bias


def biased(y, bias):
    """``ops/layers.linear``'s two roundings: the bias to y's dtype, then
    the sum."""
    return (y.float() + bias.to(y.dtype).float()).to(y.dtype)


def attention64(y, bias, heads):
    """Float64 attention of the rounded operands: (B, L, D) output and the
    (B, H, L, D / H) scale Σ_j w_ij·|v_j| of each output's terms."""
    B, L, W = y.shape
    D = W // 3
    q, k, v = biased(y, bias).double().view(B, L, 3, heads, D // heads
                                            ).permute(2, 0, 3, 1, 4)
    w = torch.softmax(q @ k.transpose(-1, -2) * (D // heads) ** -0.5, -1)
    o, terms = w @ v, w @ v.abs()
    return (o.transpose(1, 2).reshape(B, L, D),
            terms.transpose(1, 2).reshape(B, L, D))


def within_one_ulp(got, y, bias, heads):
    """Whether every element of `got` lies within one bfloat16 ulp of the
    float64 attention, the ulp taken at no less than 2^-12 of the element's
    Σ_j w_ij·|v_j| (where the sum cancels, float32's rounding of its terms
    sets the floor).  Returns (verdict, largest error)."""
    want, terms = attention64(y, bias, heads)
    at = torch.maximum(want.abs(), terms * 2.0 ** -12)
    ulp = torch.ldexp(torch.ones_like(at), torch.frexp(at)[1] - 8)
    err = (got.double() - want).abs()
    return bool((err <= ulp).all()), float(err.max())


@pytest.mark.parametrize("heads", [1, 12])
@pytest.mark.parametrize("L", [1, 2, 7, 8, 16, 32])
def test_plain_is_within_one_ulp_of_float64_attention(L, heads):
    y, bias = _inputs(6, L, heads, seed=L * heads)
    got = short_attn_plain(y, bias, heads)
    assert got.dtype == torch.bfloat16
    assert got.shape == (6, L, heads * HEAD_WIDTH) and got.is_contiguous()
    ok, err = within_one_ulp(got, y, bias, heads)
    assert ok, err


def test_plain_adds_the_bias_with_two_roundings():
    """At L = 1 every weight is 1, so the output is the v third of
    round(y + round(bias)) bit for bit, and not the v third of the one
    rounding round(y + bias), which differs where the bias is not a
    bfloat16 value."""
    y, bias = _inputs(40, 1, 2, seed=5)
    D = y.shape[2] // 3
    got = short_attn_plain(y, bias, 2)
    want = biased(y, bias)[..., 2 * D:]
    once = (y.float() + bias)[..., 2 * D:].to(torch.bfloat16)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    assert not torch.equal(got, once)


def test_short_attn_on_the_cpu_is_the_plain_version():
    y, bias = _inputs(3, 8, 2, seed=2)
    n = short_attn.launches
    assert torch.equal(short_attn(y, bias, 2), short_attn_plain(y, bias, 2))
    assert short_attn.launches == n


def _misaligned(y):
    """`y`'s values one bfloat16 past a 16-byte boundary, contiguous."""
    store = torch.empty(y.numel() + 1, dtype=y.dtype)
    out = store[1:].view(y.shape)
    out.copy_(y)
    return out


LAYOUT_CASES = {
    "33 tokens": lambda y, b: (torch.cat([y, y, y[:, :1]], 1), b, 12),
    "head width 32": lambda y, b: (y, b, 24),
    "float32": lambda y, b: (y.float(), b, 12),
    "float16": lambda y, b: (y.half(), b, 12),
    "2-D": lambda y, b: (y[0], b, 12),
    "width 1088": lambda y, b: (*_inputs(4, 16, 17), 17),
    "strided": lambda y, b: (y.transpose(0, 1).contiguous().transpose(0, 1),
                             b, 12),
    "misaligned": lambda y, b: (_misaligned(y), b, 12),
    "grad on the product": lambda y, b: (y.clone().requires_grad_(), b, 12),
    "grad on the bias": lambda y, b: (y, b.clone().requires_grad_(), 12),
}


@pytest.mark.parametrize("case", sorted(LAYOUT_CASES))
def test_layout_error_refuses_what_the_kernel_cannot_take(case):
    y, bias = _inputs(4, 16, 12)
    assert layout_error(y, bias, 12) is None
    assert layout_error(y[:, :1].contiguous(), bias, 12) is None
    t, b, heads = LAYOUT_CASES[case](y, bias)
    with torch.enable_grad():
        err = layout_error(t, b, heads)
    assert isinstance(err, str) and err, case


def test_layout_error_takes_a_product_that_requires_grad_without_autograd():
    """Eval under ``torch.no_grad``: the parameters still require grad,
    but autograd records nothing."""
    y, bias = _inputs(2, 8, 12)
    y.requires_grad_()
    bias.requires_grad_()
    with torch.no_grad():
        assert layout_error(y, bias, 12) is None


def test_constants_equal_the_kernel_source():
    with open(os.path.join(CSRC, "short_attn.cu")) as f:
        src = f.read()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    assert const("SA_HD") == HEAD_WIDTH
    assert const("SA_MAX_L") == MAX_LEN
    assert const("SA_MAX_H") * const("SA_HD") == MAX_WIDTH


def _sdpa_forward(self, x):
    """``Attention.forward`` as it was before the kernel: the ``qkv``
    Linear with its bias, SDPA, ``proj``."""
    B, L, D = x.shape
    q, k, v = self.qkv(x).view(B, L, 3, self.heads, D // self.heads
                               ).permute(2, 0, 3, 1, 4).unbind(0)
    o = F.scaled_dot_product_attention(q, k, v)
    return self.proj(o.transpose(1, 2).reshape(B, L, D))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_attention_takes_sdpa_and_keeps_its_logits(dtype, monkeypatch):
    """On the CPU, in float32 and in bfloat16, both halves call SDPA once
    a forward, ``short_attn`` launches nothing, and a small TimeSformer's
    logits equal those of the forward written before the kernel, bit for
    bit."""
    model = TimeSformer(num_classes=5, width=128, depth=2, heads=2, mlp=256,
                        frames=3, image_size=32, dtype=dtype)
    g = torch.Generator().manual_seed(0)
    model.init(g)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.Linear):
                m.bias.uniform_(-0.1, 0.1, generator=g)
    model.eval()
    x = torch.randn(2, 3, 32, 32, 3, generator=torch.Generator()
                    .manual_seed(1))
    calls = []
    sdpa = F.scaled_dot_product_attention

    def counted(*args, **kwargs):
        calls.append(args[0].shape)
        return sdpa(*args, **kwargs)

    monkeypatch.setattr(F, "scaled_dot_product_attention", counted)
    n = short_attn.launches
    with torch.no_grad():
        got = model(x)
    assert len(calls) == 2 * 2 and short_attn.launches == n
    assert {tuple(s)[2] for s in calls} == {3, 5}   # T, then P + 1 tokens
    monkeypatch.setattr(Attention, "forward", _sdpa_forward)
    with torch.no_grad():
        want = model(x)
    assert torch.equal(got, want)
