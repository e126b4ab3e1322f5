"""Convolutional primitives, NCHW (JAX twin: ardae_tpu/nn/conv.py, which is
NHWC).

  * Conv2d and ConvTranspose2d with the torch-1.2 default init or the
    xavier variant (the conv implicit VAE); ConvTranspose2d keeps torch's
    (in, out, k, k) weight and output-size law
    out = (in - 1) * stride - 2 * padding + k + output_padding;
  * torchkit WNconv2d / ResConv2d (reference models/layers2.py:238-330);
  * torchkit ResLinear, here ResLinear2 (reference models/layers2.py:331-352);
  * x2 bilinear upsampling with align_corners=True (reference resconv
    decoder): in fp32 through ``F.interpolate``, which the tests hold
    against the JAX twin's interpolation-matrix form; in bf16 as that form,
    two products with coefficient matrices in bf16, as JAX rounds them.

Each convolution promotes its operands to their common dtype, as flax does
(core/precision.py ``promote``).
"""

import functools
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ardae_tpu_torch.core.precision import promote
from ardae_tpu_torch.nn.initializers import torch_default_, xavier_
from ardae_tpu_torch.nn.linear import WeightNormalizedLinear


def conv_out_size(hin, kernel_size, stride=1, padding=0):
    """(reference utils/msc.py:43-45)"""
    return (hin + 2 * padding - kernel_size) // stride + 1


class Conv2d(nn.Module):
    """Plain conv, weight OIHW; torch-1.2 default init (U(+-1/sqrt(fan_in))
    for weight and bias) or xavier (fan_in = I*k*k, fan_out = O*k*k; zero
    bias)."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, use_bias=True, xavier=False):
        super().__init__()
        k = kernel_size
        self.stride, self.padding, self.xavier = stride, padding, xavier
        self.fan_in, self.fan_out = in_channels * k * k, out_channels * k * k
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, k, k))
        self.bias = nn.Parameter(torch.empty(out_channels)) if use_bias else None

    def init_params(self, generator):
        if self.xavier:
            xavier_(self.weight, self.bias, self.fan_in, self.fan_out, generator)
        else:
            torch_default_(self.weight, self.bias, self.fan_in, generator)

    def forward(self, x):
        return F.conv2d(*promote(x, self.weight, self.bias),
                        stride=self.stride, padding=self.padding)


class ConvTranspose2d(nn.Module):
    """torch ConvTranspose2d, weight (in, out, k, k). Torch's fan convention
    for that layout: fan_in = out*k*k (the default bound 1/sqrt of it, for
    weight and bias), fan_out = in*k*k (xavier; zero bias)."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, use_bias=True, xavier=False):
        super().__init__()
        k = kernel_size
        self.stride, self.padding, self.output_padding = stride, padding, output_padding
        self.xavier = xavier
        self.fan_in, self.fan_out = out_channels * k * k, in_channels * k * k
        self.weight = nn.Parameter(torch.empty(in_channels, out_channels, k, k))
        self.bias = nn.Parameter(torch.empty(out_channels)) if use_bias else None

    def init_params(self, generator):
        if self.xavier:
            xavier_(self.weight, self.bias, self.fan_in, self.fan_out, generator)
        else:
            torch_default_(self.weight, self.bias, self.fan_in, generator)

    def forward(self, x):
        return F.conv_transpose2d(*promote(x, self.weight, self.bias),
                                  stride=self.stride,
                                  padding=self.padding,
                                  output_padding=self.output_padding)


class WNConv2d(nn.Module):
    """weight = scale * direction / ||direction|| per output channel
    (norm=True); ``direction`` is OIHW, scale init 1."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, use_bias=True, norm=True):
        super().__init__()
        k = kernel_size
        self.stride, self.padding, self.norm = stride, padding, norm
        self.fan_in = in_channels * k * k
        self.direction = nn.Parameter(torch.empty(out_channels, in_channels, k, k))
        self.scale = nn.Parameter(torch.ones(out_channels))
        self.bias = nn.Parameter(torch.empty(out_channels)) if use_bias else None

    def init_params(self, generator):
        torch_default_(self.direction, self.bias, self.fan_in, generator)
        with torch.no_grad():
            self.scale.fill_(1.0)

    def forward(self, x):
        d = self.direction
        if self.norm:
            d = d / torch.sqrt(torch.sum(d * d, dim=(1, 2, 3), keepdim=True))
        w = d * self.scale[:, None, None, None]
        return F.conv2d(*promote(x, w, self.bias), stride=self.stride,
                        padding=self.padding)


class ResConv2d(nn.Module):
    """out = conv_h1(relu(conv_0h(x))) + conv_01(x); conv_h1 is 3x3 s1 p1.
    The inner activation is relu whatever the model's nonlinearity is."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0):
        super().__init__()
        self.conv_0h = WNConv2d(in_channels, out_channels, kernel_size, stride,
                                padding)
        self.conv_h1 = WNConv2d(out_channels, out_channels, 3, 1, 1)
        self.conv_01 = WNConv2d(in_channels, out_channels, kernel_size, stride,
                                padding)

    def forward(self, x):
        return self.conv_h1(F.relu(self.conv_0h(x))) + self.conv_01(x)


class ResLinear2(nn.Module):
    """torchkit ResLinear: WN-linears with norm=True and a dot_01 skip."""

    def __init__(self, in_features, out_features, same_dim=False):
        super().__init__()
        self.same_dim = same_dim
        self.dot_0h = WeightNormalizedLinear(in_features, out_features, norm=True)
        self.dot_h1 = WeightNormalizedLinear(out_features, out_features, norm=True)
        if not same_dim:
            self.dot_01 = WeightNormalizedLinear(in_features, out_features,
                                                 norm=True)

    def forward(self, x):
        out = self.dot_h1(F.relu(self.dot_0h(x)))
        return out + (x if self.same_dim else self.dot_01(x))


def align_corners_matrix(n_in, n_out):
    """(n_out, n_in) linear-interpolation weights, align_corners=True (the
    JAX twin's ``_align_corners_matrix``, fp32)."""
    w = torch.zeros(n_out, n_in, dtype=torch.float32)
    if n_out == 1 or n_in == 1:
        w[:, 0] = 1.0
        return w
    scale = (n_in - 1) / (n_out - 1)
    for i in range(n_out):
        src = i * scale
        lo = int(math.floor(src))
        hi = min(lo + 1, n_in - 1)
        frac = src - lo
        w[i, lo] += 1.0 - frac
        w[i, hi] += frac
    return w


@functools.lru_cache(maxsize=16)
def _coefficients(n_in, n_out, device, dtype):
    """align_corners_matrix on ``device`` in ``dtype``, made once: a copy
    from the host in every decoder call would wait for the device."""
    return align_corners_matrix(n_in, n_out).to(device, dtype)


def upsample_bilinear_align_corners(x, factor: int = 2):
    """(N, C, H, W) -> (N, C, factor*H, factor*W), align_corners=True.

    fp32: through the channels-last layout: PyTorch's CUDA kernel for NCHW
    spreads only the output pixels over threads and loops over N x C in
    each, which at the IWS eval's 32,768 decoder rows took nearly all of
    the eval's time; the channels-last kernel spreads every output element.
    bf16: the JAX twin's two products, H first, with coefficient matrices
    in x's dtype (1/3 becomes 0.33398...), each product rounded to bf16."""
    if x.dtype == torch.bfloat16:
        h, w = x.shape[-2:]
        wh = _coefficients(h, h * factor, x.device, x.dtype)
        ww = _coefficients(w, w * factor, x.device, x.dtype)
        return torch.matmul(torch.matmul(wh, x), ww.t())
    y = F.interpolate(x.contiguous(memory_format=torch.channels_last),
                      scale_factor=factor, mode="bilinear", align_corners=True)
    return y.contiguous()
