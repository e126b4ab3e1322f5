"""The flax <-> torch parameter converter, one round trip per layer kind and
model: flax params -> port state_dict (loaded strictly into the port module)
-> flax params again, bit for bit; and the conv baseline's enc_fc, whose
columns read the trunk's NHWC flatten in JAX."""

import jax
import numpy as np
import pytest

from ardae_tpu.models.cdae import MLPGradCARDAE as JGrad
from ardae_tpu.models.cdae import MLPResCARDAE as JRes
from ardae_tpu.models.ivae.conv import ConvIPVAE as JConvIPVAE
from ardae_tpu.models.ivae.resconv import ResConvIPVAE as JIPVAE
from ardae_tpu.models.vae.conv import MNISTConvVAE as JConvVAE
from ardae_tpu.models.vae.mnist import MNISTVAE as JMnistVAE
from ardae_tpu.models.vae.resconv import MNISTResConvVAE as JResConvVAE
from ardae_tpu.nn import conv as jconv
from ardae_tpu.nn import linear as jlin
from ardae_tpu.nn import mlp as jmlp
from ardae_tpu_torch.convert import (
    _nhwc_to_nchw_perm,
    flax_to_state_dict,
    state_dict_to_flax,
)
from ardae_tpu_torch.models.cdae.cardae import MLPGradCARDAE as TGrad
from ardae_tpu_torch.models.cdae.cardae import MLPResCARDAE as TRes
from ardae_tpu_torch.models.ivae.conv import ConvIPVAE as TConvIPVAE
from ardae_tpu_torch.models.ivae.resconv import ResConvIPVAE as TIPVAE
from ardae_tpu_torch.models.vae.conv import MNISTConvVAE as TConvVAE
from ardae_tpu_torch.models.vae.mnist import MNISTVAE as TMnistVAE
from ardae_tpu_torch.models.vae.resconv import MNISTResConvVAE as TResConvVAE
from ardae_tpu_torch.nn import conv as tconv
from ardae_tpu_torch.nn import linear as tlin
from ardae_tpu_torch.nn import mlp as tmlp
from torch_parity import init, rand

CASES = {
    "linear": lambda: (jlin.Linear(5), tlin.Linear(4, 5), (rand(0, 2, 4),)),
    "wn_linear": lambda: (jlin.WeightNormalizedLinear(5),
                          tlin.WeightNormalizedLinear(4, 5), (rand(0, 2, 4),)),
    "res_linear": lambda: (jlin.ResLinear(6), tlin.ResLinear(4, 6),
                           (rand(0, 2, 4),)),
    "res_mlp": lambda: (jmlp.ResMLP(hidden_dim=8, output_dim=3, num_hidden_layers=2),
                        tmlp.ResMLP(4, 8, 3, num_hidden_layers=2), (rand(0, 2, 4),)),
    "wn_conv2d": lambda: (jconv.WNConv2d(6, 3, 1, 1), tconv.WNConv2d(2, 6, 3, 1, 1),
                          (rand(0, 1, 5, 5, 2),)),
    "res_conv2d": lambda: (jconv.ResConv2d(6, 3, 2, 1), tconv.ResConv2d(2, 6, 3, 2, 1),
                           (rand(0, 1, 6, 6, 2),)),
    "res_linear2": lambda: (jconv.ResLinear2(6), tconv.ResLinear2(4, 6),
                            (rand(0, 2, 4),)),
    "cardae_split_l0": lambda: (
        JRes(input_dim=3, context_dim=5, h_dim=8, num_hidden_layers=3),
        TRes(3, 5, 8, 3), (rand(0, 4, 3), rand(1, 4, 5), rand(2, 4, 1))),
    "conv2d": lambda: (jconv.Conv2d(6, 5, 2, 2, xavier=True),
                       tconv.Conv2d(2, 6, 5, 2, 2, xavier=True),
                       (rand(0, 1, 9, 9, 2),)),
    "conv_transpose2d": lambda: (jconv.ConvTranspose2d(6, 5, 2, 2),
                                 tconv.ConvTranspose2d(2, 6, 5, 2, 2),
                                 (rand(0, 1, 4, 4, 2),)),
    "cardae_grad": lambda: (
        JGrad(input_dim=3, context_dim=5, h_dim=8, num_hidden_layers=3),
        TGrad(3, 5, 8, 3), (rand(0, 4, 3), rand(1, 4, 5), rand(2, 4, 1))),
    "conv_ipvae_nhwc": lambda: (
        JConvIPVAE(z_dim=4, noise_dim=3), TConvIPVAE(z_dim=4, noise_dim=3),
        (rand(0, 2, 784), rand(1, 2, 3))),
    "resconv_ipvae_nhwc": lambda: (
        JIPVAE(z_dim=4, noise_dim=3, c_dim=512, h_dim=8, enc_type="res-wn-mlp"),
        TIPVAE(z_dim=4, noise_dim=3, c_dim=512, h_dim=8),
        (rand(0, 2, 784), rand(1, 2, 3))),
    "mnist_vae": lambda: (JMnistVAE(h_dim=8, z_dim=4), TMnistVAE(h_dim=8, z_dim=4),
                          (rand(0, 2, 784),)),
    "conv_vae_nhwc": lambda: (JConvVAE(z_dim=4), TConvVAE(z_dim=4),
                              (rand(0, 2, 784),)),
    "resconv_vae_nhwc": lambda: (JResConvVAE(z_dim=4), TResConvVAE(z_dim=4),
                                 (rand(0, 2, 784),)),
}
for _head in ("mlp", "res-mlp", "res-wn-mlp-lin", "res-mlp-lin"):
    CASES[f"resconv_ipvae_{_head}"] = (
        lambda h=_head: (JIPVAE(z_dim=4, noise_dim=3, h_dim=8, enc_type=h),
                         TIPVAE(z_dim=4, noise_dim=3, h_dim=8, enc_type=h),
                         (rand(0, 2, 784), rand(1, 2, 3))))


@pytest.mark.parametrize("kind", sorted(CASES))
def test_round_trip(kind):
    jm, tm, args = CASES[kind]()
    p = init(jm, *args)
    sd = flax_to_state_dict(p, tm)
    tm.load_state_dict(sd, strict=True)
    back = state_dict_to_flax(tm.state_dict(), tm)
    la = jax.tree_util.tree_leaves_with_path(p)
    lb = dict((jax.tree_util.keystr(k), v)
              for k, v in jax.tree_util.tree_leaves_with_path(back))
    assert len(la) == len(lb)
    for k, v in la:
        np.testing.assert_array_equal(np.asarray(v), lb[jax.tree_util.keystr(k)])


def test_nhwc_perm_maps_flatten_orders():
    """perm[j_nchw] = j_nhwc: an NCHW flatten, gathered by perm, reads the
    NHWC flatten of the same feature map."""
    fmap = np.arange(32 * 4 * 4).reshape(32, 4, 4)
    nchw = fmap.reshape(-1)
    nhwc = np.transpose(fmap, (1, 2, 0)).reshape(-1)
    perm = _nhwc_to_nchw_perm(32, 4, 4)
    np.testing.assert_array_equal(nhwc[perm], nchw)


def test_conv_vae_enc_fc_reads_the_nchw_flatten():
    """enc_fc's columns are permuted NHWC -> NCHW and nothing else is: the
    port's enc_fc on the port trunk's NCHW features equals JAX's enc_fc on
    the NHWC flatten of the same feature map."""
    jm, tm = JConvVAE(z_dim=4), TConvVAE(z_dim=4)
    p = init(jm, rand(0, 2, 784))
    sd = flax_to_state_dict(p, tm)
    kernel = np.asarray(p["params"]["enc_fc"]["kernel"])       # (512, 800)
    fmap = rand(3, 32, 4, 4)
    nchw, nhwc = fmap.reshape(-1), np.transpose(fmap, (1, 2, 0)).reshape(-1)
    np.testing.assert_allclose(sd["enc_fc.weight"].numpy() @ nchw, nhwc @ kernel,
                               rtol=1e-5, atol=1e-5)
    assert np.array_equal(sd["enc_reparam.mean_fn.weight"].numpy(),
                          np.asarray(p["params"]["enc_reparam"]["mean_fn"]["kernel"]).T)
