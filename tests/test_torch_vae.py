"""The baseline (Gaussian-posterior) VAEs, port against JAX: the logvar clip
modes and the Normal and Bernoulli heads, the Gaussian losses, generation
and reconstruction, and the checks of tests/torch_vae_cases.py
(encode_params, decode_params, vae_loss with every parameter gradient,
logprob_iwae per item) for the mlp, conv, resconv (no centring) and
resconvct (centred) cases. resconvct's centring is in the encoder, which
encode_params and vae_loss reach; its IWAE bound is left to the other three.
"""

import pytest
import torch

from ardae_tpu.core import losses as jlosses
from ardae_tpu.nn import heads as jheads
from ardae_tpu_torch.core import losses as tlosses
from ardae_tpu_torch.models.vae import api as tapi
from ardae_tpu_torch.nn import heads as theads
from torch_parity import close, init, loaded, rand, t
from torch_vae_cases import (
    Z,
    binary,
    build,
    check_encode_and_decode_params,
    check_logprob_iwae_per_item,
    check_vae_loss_and_gradients,
)

MODELS = ["mnist", "conv", "resconv", "resconvct"]


@pytest.mark.parametrize("mode", ["none", "hard", "softplus", "spm4", "spm0.5",
                                  "tanh", "2tanh"])
def test_clip_logvar(mode):
    lv = rand(0, 5, 7, scale=4.0)
    close(theads.clip_logvar(t(lv), mode), jheads.clip_logvar(lv, mode), 1e-6, 1e-6)


def test_clip_logvar_unknown_mode_raises():
    with pytest.raises(NotImplementedError, match="clip mode"):
        theads.clip_logvar(t(rand(0, 2)), "cube")


@pytest.mark.parametrize("clip,xavier", [(None, False), ("hard", True)])
def test_normal_head(clip, xavier):
    h = rand(1, 3, 6, scale=3.0)
    jm = jheads.NormalHead(5, clip=clip, xavier=xavier)
    p = init(jm, h)
    tm = loaded(theads.NormalHead(6, 5, clip=clip, xavier=xavier), p)
    (mu, lv), (wmu, wlv) = tm(t(h)), jm.apply(p, h)
    close(mu, wmu)
    close(lv, wlv)


def test_bernoulli_head():
    h = rand(1, 3, 6)
    jm = jheads.BernoulliHead(5)
    p = init(jm, h)
    close(loaded(theads.BernoulliHead(6, 5), p)(t(h)), jm.apply(p, h))


@pytest.mark.parametrize("reduce", ["per_item", "sum", "none"])
def test_gaussian_losses(reduce):
    mu, lv, x = rand(0, 3, 5), rand(1, 3, 5), rand(2, 3, 5)
    close(tlosses.loss_kld_gaussian(t(mu), t(lv), reduce),
          jlosses.loss_kld_gaussian(mu, lv, reduce), 1e-6, 1e-5)
    close(tlosses.loss_recon_gaussian(t(mu), t(lv), t(x), const=0.5, reduce=reduce),
          jlosses.loss_recon_gaussian(mu, lv, x, const=0.5, reduce=reduce),
          1e-6, 1e-5)


@pytest.mark.parametrize("name", MODELS)
def test_encode_and_decode_params(name):
    check_encode_and_decode_params(name)


@pytest.mark.parametrize("name", MODELS)
def test_vae_loss_and_gradients(name):
    check_vae_loss_and_gradients(name)


@pytest.mark.parametrize("name", ["mnist", "conv", "resconv"])
def test_logprob_iwae_per_item(name):
    check_logprob_iwae_per_item(name)


def test_generate_and_reconstruct_follow_the_injected_draws():
    _, _, tm = build("mnist")
    g = torch.Generator().manual_seed(0)
    x = torch.from_numpy(binary(3, 12))
    with torch.no_grad():
        xs, probs, z = tapi.generate(tm, 3, generator=g)
        xs2, probs2, z2 = tapi.generate(tm, 3, eps=z, u=torch.full((3, 784), 0.5))
        rx, rprobs, rz = tapi.reconstruct(tm, x, generator=g)
        mu, _ = tm.encode_params(x)
        rx0, _, rz0 = tapi.reconstruct(tm, x, eps=torch.zeros(3, Z),
                                       u=torch.zeros(3, 784))
    assert xs.shape == rx.shape == (3, 784) and z.shape == rz.shape == (3, Z)
    assert torch.equal(probs, probs2) and torch.equal(xs2, (probs > 0.5).float())
    assert set(torch.unique(xs).tolist()) <= {0.0, 1.0}
    assert bool(((rprobs > 0) & (rprobs < 1)).all())
    assert torch.equal(rz0, mu) and bool((rx0 == 1).all())  # u = 0 < every p
