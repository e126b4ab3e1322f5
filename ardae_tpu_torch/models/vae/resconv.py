"""Residual-conv MNIST trunk and decoder, NCHW
(JAX twin: ardae_tpu/models/vae/resconv.py, which is NHWC).

The JAX twin flattens NHWC before the trunk's fc and reshapes the decoder's
fc1 output to (4, 4, 32) NHWC. Here both are plain NCHW flattens/reshapes;
``convert.py`` permutes the rows of those two fc layers' weights so the two
packages compute the same function.

``MNISTResConvVAE`` is the resconv baseline: trunk (c_dim 450) -> Normal
head, and the decoder (reference models/vae/resconv.py:142-240).
"""

import torch.nn as nn

from ardae_tpu_torch.nn.activations import get_nonlinear_func
from ardae_tpu_torch.nn.conv import (
    ResConv2d,
    ResLinear2,
    upsample_bilinear_align_corners,
)
from ardae_tpu_torch.nn.heads import NormalHead


class ResConvTrunk(nn.Module):
    """Flat (bsz, 784) images -> (bsz, c_dim) features
    (reference models/vae/resconv.py:38-53)."""

    def __init__(self, c_dim=450, nonlinearity="elu", do_center=False):
        super().__init__()
        self.afun = get_nonlinear_func(nonlinearity)
        self.do_center = do_center
        self.block0 = ResConv2d(1, 16, 3, 2, 1)    # 28 -> 14
        self.block1 = ResConv2d(16, 16, 3, 1, 1)
        self.block2 = ResConv2d(16, 32, 3, 2, 1)   # 14 -> 7
        self.block3 = ResConv2d(32, 32, 3, 1, 1)
        self.block4 = ResConv2d(32, 32, 3, 2, 1)   # 7 -> 4
        self.fc = ResLinear2(32 * 4 * 4, c_dim)

    def forward(self, x):
        a = self.afun
        bsz = x.shape[0]
        x = x.reshape(bsz, 1, 28, 28)
        if self.do_center:
            x = 2.0 * x - 1.0
        h = a(self.block0(x))
        h = a(self.block1(h))
        h = a(self.block2(h))
        h = a(self.block3(h))
        h = a(self.block4(h))
        return a(self.fc(h.reshape(bsz, 32 * 4 * 4)))


class ResConvDecoder(nn.Module):
    """(bsz, z) -> (logits (bsz, 784),) (reference models/vae/resconv.py:75-140)."""

    def __init__(self, z_dim, c_dim=450, nonlinearity="elu", do_m5bias=False):
        super().__init__()
        self.afun = get_nonlinear_func(nonlinearity)
        self.do_m5bias = do_m5bias
        self.fc0 = ResLinear2(z_dim, c_dim)
        self.fc1 = ResLinear2(c_dim, 32 * 4 * 4)
        self.block0 = ResConv2d(32, 32, 3, 1, 1)
        self.block1 = ResConv2d(32, 32, 3, 1, 1)
        self.block2 = ResConv2d(32, 16, 3, 1, 1)
        self.block3 = ResConv2d(16, 16, 3, 1, 1)
        self.block4 = ResConv2d(16, 1, 3, 1, 1)

    def forward(self, z):
        a = self.afun
        bsz = z.shape[0]
        h = a(self.fc0(z.reshape(bsz, -1)))
        h = a(self.fc1(h)).reshape(bsz, 32, 4, 4)
        h = upsample_bilinear_align_corners(h, 2)        # 8x8
        h = a(self.block0(h))
        h = a(self.block1(h))
        h = h[:, :, :-1, :-1]                            # crop to 7x7
        h = upsample_bilinear_align_corners(h, 2)        # 14x14
        h = a(self.block2(h))
        h = a(self.block3(h))
        h = upsample_bilinear_align_corners(h, 2)        # 28x28
        logit = self.block4(h)
        if self.do_m5bias:
            logit = logit - 3.0
        return (logit.reshape(bsz, -1),)


class MNISTResConvVAE(nn.Module):
    """resconv / resconvct baseline. ``do_center`` feeds the trunk 2x - 1;
    the registry sets it for ``resconvct`` only (the reference driver passes
    False for both, vae.py:233-249)."""

    family = "gaussian_posterior"
    likelihood = "bernoulli"
    center_input = True

    def __init__(self, input_height=28, input_channels=1, z_dim=32, c_dim=450,
                 nonlinearity="elu", do_center=False):
        super().__init__()
        if input_height != 28 or input_channels != 1:
            raise ValueError("MNISTResConvVAE takes 28x28x1 images")
        self.z_dim = z_dim
        self.trunk = ResConvTrunk(c_dim, nonlinearity, do_center)
        self.enc_reparam = NormalHead(c_dim, z_dim)
        self.decode = ResConvDecoder(z_dim, c_dim, nonlinearity)

    def encode_params(self, x):
        return self.enc_reparam(self.trunk(x))

    def decode_params(self, z_flat):
        return self.decode(z_flat)
