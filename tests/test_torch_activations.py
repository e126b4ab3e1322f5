"""The three nonlinearities the port gained with the toy-maf slice
(``csoftplus``, ``leaky_relu`` with slope 0.2, ``swish``) against the JAX
package's: the functions themselves over a wide range (rtol 1e-5); the
grad-style CARDAE's DSM loss and parameter gradients with each as the
cdae's nonlinearity, which differentiates it twice (as
test_torch_cardae.py: loss rtol 1e-5, gradients rtol 2e-4); an MLP-concat
encoder's latents with each as the model's nonlinearity; and both port
drivers taking them as ``--model-nonlin`` / ``--cdae-nonlin``."""

import jax
import numpy as np
import pytest

from ardae_tpu.models.cdae import MLPGradCARDAE as JGrad
from ardae_tpu.models.cdae import cdae_loss as j_loss
from ardae_tpu.models.ivae.toy import ToyIPVAE as JToy
from ardae_tpu.nn.activations import get_nonlinear_func as jact
from ardae_tpu_torch.models.cdae.cardae import MLPGradCARDAE as TGrad
from ardae_tpu_torch.models.cdae.cardae import cdae_loss as t_loss
from ardae_tpu_torch.models.ivae.toy import ToyIPVAE as TToy
from ardae_tpu_torch.nn.activations import get_nonlinear_func as tact
from torch_driver_data import shared_datasets  # noqa: F401
from torch_parity import close, grads_as_state_dict, init, loaded, rand, t

NEW = ["csoftplus", "leaky_relu", "swish"]
Z, C, H, L = 4, 6, 16, 3


@pytest.mark.parametrize("name", NEW)
def test_activation_matches_jax(name):
    x = np.concatenate([rand(0, 256, scale=6.0),
                        np.array([-80.0, -20.0, 0.0, 20.0, 80.0], np.float32)])
    close(tact(name)(t(x)), jact(name)(x), 1e-5, 1e-6)


@pytest.mark.parametrize("name", NEW)
def test_grad_cdae_loss_with_activation_matches_jax(name):
    jm = JGrad(input_dim=Z, context_dim=C, h_dim=H, num_hidden_layers=L,
               nonlinearity=name)
    p = init(jm, np.zeros((4, Z), np.float32), np.zeros((4, C), np.float32),
             np.zeros((4, 1), np.float32), seed=3)
    tm = loaded(TGrad(Z, C, H, L, name), p)
    latent, ctx = rand(4, 3, 7, Z), rand(5, 3, C)
    std = np.abs(rand(6, 3, 7, 1, scale=0.5))
    key = jax.random.PRNGKey(9)
    jl, jg = jax.value_and_grad(lambda q: j_loss(jm, q, key, latent, ctx, std))(p)
    loss = t_loss(tm, t(latent), t(ctx), t(std),
                  eps=t(jax.random.normal(key, (21, Z))))
    loss.backward()
    close(loss, jl, 1e-5, 0.0)
    want = grads_as_state_dict(jg, tm)
    for k, prm in tm.named_parameters():
        g = prm.grad if prm.grad is not None else np.zeros(prm.shape, np.float32)
        close(g, want[k], 2e-4, 1e-6, msg=k)


@pytest.mark.parametrize("name", NEW)
def test_encoder_with_activation_matches_jax(name):
    jm = JToy(input_dim=2, noise_dim=3, h_dim=16, z_dim=2, nonlinearity=name,
              num_hidden_layers=2)
    x, eps = rand(7, 5, 2, scale=3.0), rand(8, 5, 3)
    p = init(jm, x, eps, seed=4)
    tm = loaded(TToy(input_dim=2, noise_dim=3, h_dim=16, z_dim=2,
                     nonlinearity=name, num_hidden_layers=2), p)
    want = jm.apply(p, x, eps, method=jm.sample_z)
    close(tm.sample_z(t(x), t(eps)), want, 1e-5, 1e-6)


@pytest.mark.parametrize("driver", ["ivae", "vae"])
def test_drivers_take_the_new_nonlinearities(tmp_path, driver):
    from ardae_tpu_torch.cli import ivae_ardae, vae

    common = ["--dataset", "25gaussians", "--nheight", "1", "--nchannels", "2",
              "--toy-train-size", "2000", "--model-z-dim", "2", "--model-h-dim", "8",
              "--train-batch-size", "8", "--max-iters", "2", "--log-interval", "1",
              "--eval-iws-interval", "0", "--vis-interval", "0", "--ckpt-interval",
              "0", "--skip-final-test-eval", "--no-resume", "--no-cuda",
              "--cache", str(tmp_path / "exp"), "--data-root", str(tmp_path / "d")]
    if driver == "ivae":
        state, _ = ivae_ardae.run(common + [
            "--model", "mlp-concat", "--model-n-dim", "3", "--model-nonlin",
            "leaky_relu", "--cdae", "mlp-grad", "--cdae-h-dim", "8",
            "--cdae-nonlin", "swish", "--train-nz-cdae", "4"])
        assert state.cdae.nonlinearity == "swish"
    else:
        state, _ = vae.run(common + ["--model", "toy", "--model-nonlin", "csoftplus"])
    assert state.step == 2
