"""The KDE, diagonal and prior IWS bounds of the port (models/ivae/api.py
``logprob_kde``, ``logprob_diag``, ``logprob_prior``) against their JAX
twins at small widths: the toy IVAE (a Gaussian likelihood), mnist-concat
(Bernoulli) and auxmnist (the hierarchical family, whose encoder noise is
a pair). Flax params cross through convert.py; every draw (the encoder
noise, the KDE's kernel picks and kernel noise, the re-sample noise, the
prior's z) is made by jax.random from the keys the JAX function splits and
injected. Bounds rel 1e-4 (per item where the port reduces per item;
JAX's are batch means); the KDE's blocks of differences, cut to a few rows,
change nothing past rounding; on the linear-Gaussian model of
tests/test_parity_extras.py the KDE bound lies within 0.2 nats of the
exact log p(x), as JAX's does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ardae_tpu.models.ivae import api as japi
from ardae_tpu.models.ivae import aux as jaux
from ardae_tpu.models.ivae.mnist import MNISTIPVAE as JMNIST
from ardae_tpu.models.ivae.toy import ToyIPVAE as JToy
from ardae_tpu_torch.data.mnist import _synthetic_mnist
from ardae_tpu_torch.models.ivae import api as tapi
from ardae_tpu_torch.models.ivae import aux as taux
from ardae_tpu_torch.models.ivae.mnist import MNISTIPVAE as TMNIST
from ardae_tpu_torch.models.ivae.toy import ToyIPVAE as TToy
from torch_parity import close, loaded, rand, t

BS, S = 3, 64
_TOY = dict(input_dim=2, noise_dim=2, h_dim=16, z_dim=2, nonlinearity="tanh",
            num_hidden_layers=2, enc_type="concat")
_MNIST = dict(noise_dim=6, h_dim=16, z_dim=4, num_hidden_layers=2)
MODELS = {
    "toy": (JToy(**_TOY), TToy(**_TOY)),
    "mnist-concat": (JMNIST(**_MNIST), TMNIST(**_MNIST)),
    "auxmnist": (jaux.MNISTAuxIPVAE(**_MNIST), taux.MNISTAuxIPVAE(**_MNIST)),
}
_BUILT = {}


def _build(name):
    if name not in _BUILT:
        jm, tm = MODELS[name]
        x = (rand(1, BS, 2, scale=2.0) if name == "toy" else
             (_synthetic_mnist(BS, seed=2)[0] > 0.5).astype(np.float32))
        noise = (rand(3, BS, jm.noise_dim) if name != "auxmnist"
                 else (rand(3, BS, jm.noise_dim), rand(4, BS, jm.z_dim)))
        p = jm.init(jax.random.PRNGKey(0), x, noise)
        _BUILT[name] = jm, p, loaded(tm, p), x
    return _BUILT[name]


def _tt(e):
    return tuple(t(a) for a in e) if isinstance(e, tuple) else t(e)


def _kde_draws(jm, key, bsz, ssz):
    """The draws logprob_kde makes from ``key`` (JAX api.py:244-254)."""
    k_enc, k_pick, k_noise = jax.random.split(key, 3)
    return dict(eps=_tt(japi.make_eps(jm, k_enc, bsz, ssz)),
                idx=torch.from_numpy(np.array(
                    jax.random.randint(k_pick, (bsz, ssz), 0, ssz))),
                new_eps=t(jax.random.normal(k_noise, (bsz, ssz, jm.z_dim))))


def _diag_draws(jm, key, bsz, ssz):
    k_enc, k_new = jax.random.split(key)
    return dict(eps=_tt(japi.make_eps(jm, k_enc, bsz, ssz)),
                new_eps=t(jax.random.normal(k_new, (bsz, ssz, jm.z_dim))))


def _prior_draws(jm, key, bsz, ssz):
    return dict(z=t(jax.random.normal(key, (bsz, ssz, jm.z_dim))))


BOUNDS = {"kde": (japi.logprob_kde, tapi.logprob_kde, _kde_draws),
          "diag": (japi.logprob_diag, tapi.logprob_diag, _diag_draws),
          "prior": (japi.logprob_prior, tapi.logprob_prior, _prior_draws)}


@pytest.mark.parametrize("bound", list(BOUNDS))
@pytest.mark.parametrize("name", list(MODELS))
def test_bound_matches_jax(name, bound):
    """The batch mean against JAX's; the per-item bounds average to it."""
    jm, p, tm, x = _build(name)
    jfn, tfn, draws = BOUNDS[bound]
    key = jax.random.PRNGKey(7)
    want = float(jfn(jm, p, key, jnp.asarray(x), S))
    d = draws(jm, key, BS, S)
    with torch.no_grad():
        got = tfn(tm, t(x), S, **d)
        per_item = tfn(tm, t(x), S, reduce="per_item", **d)
    assert per_item.shape == (BS,) and np.isfinite(want)
    close(got, want, 1e-4, 0.0)
    close(per_item.mean(), want, 1e-4, 0.0)


def test_kde_blocks_change_nothing(monkeypatch):
    """Blocks of 5 new points (a ragged last block) give the bound of one
    block, and JAX's."""
    jm, p, tm, x = _build("toy")
    key = jax.random.PRNGKey(8)
    d = _kde_draws(jm, key, BS, S)
    with torch.no_grad():
        whole = tapi.logprob_kde(tm, t(x), S, reduce="per_item", **d)
        monkeypatch.setattr(tapi, "_KDE_BLOCK", 5 * S * jm.z_dim)
        blocks = tapi.logprob_kde(tm, t(x), S, reduce="per_item", **d)
    close(blocks, whole, 1e-6, 0.0)
    close(blocks.mean(), japi.logprob_kde(jm, p, key, jnp.asarray(x), S), 1e-4, 0.0)


@pytest.mark.parametrize("bound", list(BOUNDS))
def test_bound_draws_from_a_generator(bound):
    """Without injected draws each bound draws from the generator: the same
    seed gives the same bound, finite."""
    _, _, tm, x = _build("mnist-concat")
    fn = BOUNDS[bound][1]
    with torch.no_grad():
        a, b = (fn(tm, t(x), S, generator=torch.Generator().manual_seed(3))
                for _ in range(2))
    assert torch.isfinite(a) and torch.equal(a, b)


class _LinearGaussianIVAE(torch.nn.Module):
    """The analytic model of tests/test_eval.py: q(z|x) implicit = N(Ax, I),
    p(x|z) = N(Bz, I), p(z) = N(0, I), so log p(x) = log N(x; 0, BB^T + I)."""

    z_dim, noise_dim, family, likelihood = 2, 2, "flat", "gaussian"

    def __init__(self, A, B):
        super().__init__()
        self.A, self.B = A, B

    def sample_z(self, x, eps):
        bsz = x.shape[0]
        mu = x @ self.A.T
        return mu[:, None, :] + eps.reshape(bsz, -1, self.z_dim)

    def decode_params(self, z_flat):
        return z_flat @ self.B.T, torch.zeros(z_flat.shape[0], self.B.shape[0])


def test_kde_linear_gaussian_close_to_exact():
    """tests/test_parity_extras.py:128: S 1024, within 0.2 nats of the exact
    log p(x), and the port's bound within 1e-4 of JAX's on the same draws."""
    from ardae_tpu.core.stats import mvn_logprob
    from tests.test_eval import _LinearGaussianIVAE as JLinear

    A = np.array([[0.5, 0.1], [-0.2, 0.3]], np.float32)
    B = np.array([[1.0, 0.4], [-0.3, 0.8]], np.float32)
    x = np.array([[0.7, -1.2], [1.5, 0.3]], np.float32)
    jm = JLinear(A=jnp.asarray(A), B=jnp.asarray(B))
    key = jax.random.PRNGKey(0)
    want = float(japi.logprob_kde(jm, {"params": {}}, key, jnp.asarray(x), 1024))
    with torch.no_grad():
        got = float(tapi.logprob_kde(_LinearGaussianIVAE(t(A), t(B)), t(x), 1024,
                                     **_kde_draws(jm, key, 2, 1024)))
    cov = B @ B.T + np.eye(2, dtype=np.float32)
    exact = float(jnp.mean(mvn_logprob(x, jnp.zeros(2), jnp.linalg.cholesky(cov))))
    close(got, want, 1e-4, 0.0)
    assert abs(got - exact) < 0.2, (got, exact)
