"""CARDAE score and DSM loss in both styles, port against JAX.

Residual style: the trunk's output. Gradient style: the input gradient of
-energy, through torch.autograd.grad(create_graph=True) so the loss can be
differentiated again. Scores at rtol 1e-5 / atol 1e-6; losses at rtol 1e-5;
every parameter gradient at rtol 2e-4 / atol 1e-6 (the grad style's second
derivatives sum in a different order)."""

import jax
import numpy as np
import pytest

from ardae_tpu.models.cdae import MLPGradCARDAE as JGrad
from ardae_tpu.models.cdae import MLPResCARDAE as JRes
from ardae_tpu.models.cdae import cdae_loss as j_loss
from ardae_tpu.models.cdae import cdae_score as j_score
from ardae_tpu_torch.models.cdae.cardae import MLPGradCARDAE as TGrad
from ardae_tpu_torch.models.cdae.cardae import MLPResCARDAE as TRes
from ardae_tpu_torch.models.cdae.cardae import cdae_loss as t_loss
from ardae_tpu_torch.models.cdae.cardae import cdae_score as t_score
from torch_parity import close, grads_as_state_dict, init, loaded, rand, t

STYLES = {"res": (JRes, TRes), "grad": (JGrad, TGrad)}
Z, C, H, L = 4, 6, 16, 3


def _pair(style, nonlin="softplus"):
    jcls, tcls = STYLES[style]
    jm = jcls(input_dim=Z, context_dim=C, h_dim=H, num_hidden_layers=L,
              nonlinearity=nonlin)
    p = init(jm, np.zeros((4, Z), np.float32), np.zeros((4, C), np.float32),
             np.zeros((4, 1), np.float32), seed=3)
    return jm, p, loaded(tcls(Z, C, H, L, nonlin), p)


@pytest.mark.parametrize("style", ["res", "grad"])
@pytest.mark.parametrize("std_kind", ["zero", "per_sample"])
def test_score(style, std_kind):
    jm, p, tm = _pair(style)
    latent = rand(1, 3, 5, Z)
    ctx = rand(2, 3, C)
    std = 0.0 if std_kind == "zero" else np.abs(rand(3, 3, 5, 1))
    want = j_score(jm, p, latent, ctx, std)
    got = t_score(tm, t(latent), t(ctx), std if std_kind == "zero" else t(std))
    assert got.shape == (3, 5, Z)
    close(got, want, 1e-5, 1e-6)


@pytest.mark.parametrize("style", ["res", "grad"])
def test_loss_and_param_grads(style):
    jm, p, tm = _pair(style, nonlin="tanh")
    latent = rand(4, 3, 7, Z)
    ctx = rand(5, 3, C)
    std = np.abs(rand(6, 3, 7, 1, scale=0.5))
    key = jax.random.PRNGKey(9)
    jl, jg = jax.value_and_grad(lambda q: j_loss(jm, q, key, latent, ctx, std))(p)
    eps = jax.random.normal(key, (21, Z))  # the draw cdae_loss makes
    loss = t_loss(tm, t(latent), t(ctx), t(std), eps=t(eps))
    loss.backward()
    close(loss, jl, 1e-5, 0.0)
    want = grads_as_state_dict(jg, tm)
    for k, prm in tm.named_parameters():
        # the grad style's output bias does not reach the score: torch leaves
        # its grad None where JAX returns zeros
        g = prm.grad if prm.grad is not None else np.zeros(prm.shape, np.float32)
        close(g, want[k], 2e-4, 1e-6, msg=k)
