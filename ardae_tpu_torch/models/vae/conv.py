"""MNIST conv encoder trunk and deconv decoder, NCHW (JAX twin:
ardae_tpu/models/vae/conv.py, which is NHWC).

Encoder trunk: 2x - 1, then 3 x (5x5, stride 2, pad 2) convs, 28 -> 14 -> 7
-> 4. Decoder: MLP (300 hidden) -> (32, 4, 4) -> 3 deconvs with the
reference's ZeroPad trick (pad (0,1,0,1) after deconv1, crop one row and
column after the logit deconv): 4 -> 7 -> 8 -> 15 -> 29 -> 28.

The JAX twin flattens the trunk's NHWC output and reshapes the decoder MLP's
output to NHWC; here both are plain NCHW flattens/reshapes, and
``convert.py`` permutes the columns of the layer after the trunk and the
rows of the decoder MLP's last layer so the two packages compute the same
function.

``MNISTConvVAE`` is the conv baseline: trunk -> ``enc_fc`` (800) -> act ->
Normal head, and the deconv decoder (reference models/vae/conv.py:138-295).
The JAX twin's ``do_xavier`` / ``do_m5bias`` options are not ported: every
registry passes False for both.
"""

import torch.nn as nn
import torch.nn.functional as F

from ardae_tpu_torch.nn.activations import get_nonlinear_func
from ardae_tpu_torch.nn.conv import Conv2d, ConvTranspose2d, conv_out_size
from ardae_tpu_torch.nn.heads import NormalHead
from ardae_tpu_torch.nn.linear import Linear
from ardae_tpu_torch.nn.mlp import MLP


def feature_size(input_height):
    """Side of the trunk's feature map: three 5x5 stride-2 convs."""
    s = input_height
    for _ in range(3):
        s = conv_out_size(s, 5, 2, 2)
    return s


class ConvEncoderTrunk(nn.Module):
    """Flat (bsz, C*H*W) images -> (bsz, 32*s*s) features, NCHW order, s =
    ``feature_size(input_height)`` (reference models/vae/conv.py:29-77 minus
    the head)."""

    def __init__(self, input_height=28, input_channels=1,
                 nonlinearity="softplus", xavier=False):
        super().__init__()
        self.afun = get_nonlinear_func(nonlinearity)
        self.input_height, self.input_channels = input_height, input_channels
        self.s = feature_size(input_height)
        self.conv1 = Conv2d(input_channels, 16, 5, 2, 2, xavier=xavier)
        self.conv2 = Conv2d(16, 32, 5, 2, 2, xavier=xavier)
        self.conv3 = Conv2d(32, 32, 5, 2, 2, xavier=xavier)

    def forward(self, x):
        a = self.afun
        bsz = x.shape[0]
        x = x.reshape(bsz, self.input_channels, self.input_height,
                      self.input_height)
        x = 2.0 * x - 1.0
        h = a(self.conv1(x))
        h = a(self.conv2(h))
        h = a(self.conv3(h))
        return h.reshape(bsz, -1)


class ConvDecoder(nn.Module):
    """(bsz, z) -> (logits (bsz, C*H*W),) (reference models/vae/conv.py:79-136)."""

    def __init__(self, z_dim, input_height=28, input_channels=1,
                 nonlinearity="softplus", xavier=False):
        super().__init__()
        self.afun = get_nonlinear_func(nonlinearity)
        self.s = feature_size(input_height)
        self.fc = MLP(z_dim, 300, self.s * self.s * 32, nonlinearity=nonlinearity,
                      num_hidden_layers=1, use_nonlinearity_output=True,
                      xavier=xavier)
        self.deconv1 = ConvTranspose2d(32, 32, 5, 2, 2, xavier=xavier)
        self.deconv2 = ConvTranspose2d(32, 16, 5, 2, 2, xavier=xavier)
        self.reparam_logit = ConvTranspose2d(16, input_channels, 5, 2, 2,
                                             xavier=xavier)

    def forward(self, z):
        a = self.afun
        bsz = z.shape[0]
        h = self.fc(z.reshape(bsz, -1)).reshape(bsz, 32, self.s, self.s)
        h = a(self.deconv1(h))
        h = F.pad(h, (0, 1, 0, 1))                 # ZeroPad2d((0, 1, 0, 1))
        h = a(self.deconv2(h))
        logit = self.reparam_logit(h)[..., :-1, :-1]  # ZeroPad2d((0, -1, 0, -1))
        return (logit.reshape(bsz, -1),)


class MNISTConvVAE(nn.Module):
    """The conv baseline (reference models/vae/conv.py:138-295)."""

    family = "gaussian_posterior"
    likelihood = "bernoulli"
    center_input = True

    def __init__(self, input_height=28, input_channels=1, z_dim=32,
                 nonlinearity="softplus"):
        super().__init__()
        self.z_dim = z_dim
        self.afun = get_nonlinear_func(nonlinearity)
        self.trunk = ConvEncoderTrunk(input_height, input_channels, nonlinearity)
        self.enc_fc = Linear(32 * self.trunk.s ** 2, 800)
        self.enc_reparam = NormalHead(800, z_dim)
        self.decode = ConvDecoder(z_dim, input_height, input_channels, nonlinearity)

    def encode_params(self, x):
        return self.enc_reparam(self.afun(self.enc_fc(self.trunk(x))))

    def decode_params(self, z_flat):
        return self.decode(z_flat)
