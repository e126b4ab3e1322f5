"""Probability helpers (JAX twin: ardae_tpu/core/stats.py): the IWS
evaluator's, and the kernel-density marginal-entropy terms with their
column shuffle (reference utils/stat.py:9-158).

``covmat`` and ``mvn_logprob`` take optional leading batch dimensions, so the
evaluator fits and scores every item of a batch in one call. ``covmat`` feeds
a Cholesky: run it with TF32 off (the JAX twin uses ``Precision.HIGHEST``);
the driver sets ``torch.backends.cuda.matmul.allow_tf32 = False``.
"""

import math

import torch

_LOG_2PI = math.log(2.0 * math.pi)


def logprob_gaussian(mu, logvar, z):
    """Elementwise diagonal-Gaussian log-density, no reduction
    (reference utils/stat.py:65-96, do_unsqueeze=False, do_mean=False).
    ``mu`` and ``logvar`` may be Python floats."""
    logvar = torch.as_tensor(logvar, dtype=z.dtype, device=z.device)
    neglogprob = (z - mu) ** 2 / torch.exp(logvar) + logvar + _LOG_2PI
    return -0.5 * neglogprob


def logprob_gaussian_w_fixed_var(mu, z, std: float = 1.0):
    """Elementwise Gaussian log-density with a scalar fixed std (reference
    utils/stat.py:98-125)."""
    var = std ** 2
    neglogprob = (z - mu) ** 2 / var + math.log(var) + _LOG_2PI
    return -0.5 * neglogprob


def prob_gaussian(mu, logvar, z, eps: float = 1e-6):
    """Elementwise Gaussian density (reference utils/stat.py:30-52), var and
    std each floored by ``eps`` as there."""
    var = torch.exp(logvar) + eps
    std = torch.sqrt(var) + eps
    return torch.exp(-0.5 * (z - mu) ** 2 / var) / std / math.sqrt(2.0 * math.pi)


def shuffle(z, generator=None, perm=None):
    """Each column of ``z`` (bsz, zdim) permuted across the batch on its own
    (reference utils/stat.py:9-15: the product of the marginals). ``perm``
    (zdim, bsz) holds each column's permutation, injected, else drawn from
    ``generator`` column by column."""
    bsz, zdim = z.shape
    if perm is None:
        if generator is None:
            raise ValueError("shuffle needs a generator or an injected perm")
        perm = torch.stack([torch.randperm(bsz, generator=generator,
                                           device=generator.device)
                            for _ in range(zdim)])
    perm = torch.as_tensor(perm, device=z.device, dtype=torch.long)
    return torch.gather(z, 0, perm.T)


def loss_marginal_entropy_gaussian(mu, logvar, z, reduce: str = "sum"):
    """-log(mean_j N(z_i; mu_j, var_j)) elementwise: the entropy of the
    kernel-density marginal (reference utils/stat.py:54-63); mu and logvar
    are the (b2, nz) kernels, z (b1, nz)."""
    p = prob_gaussian(mu[None, :, :], logvar[None, :, :], z[:, None, :])
    elem = -torch.log(torch.mean(p, dim=1))
    return torch.sum(elem) if reduce == "sum" else elem


def loss_approx_marginal_entropy_gaussian(mu, logvar, z, reduce: str = "sum"):
    """The mean-of-logs approximation of the marginal entropy (reference
    utils/stat.py:87-96)."""
    lp = logprob_gaussian(mu[None, :, :], logvar[None, :, :], z[:, None, :])
    elem = -torch.mean(lp, dim=1)
    return torch.sum(elem) if reduce == "sum" else elem


def covmat(m):
    """Unbiased sample covariance of the rows of ``m`` (..., n, d) ->
    (..., d, d): one centred product over n - 1 (reference
    utils/stat.py:127-158, rowvar=False)."""
    n = m.shape[-2]
    centered = m - torch.mean(m, dim=-2, keepdim=True)
    return torch.matmul(centered.transpose(-1, -2), centered) / (n - 1)


def mvn_logprob(z, mu, chol):
    """Multivariate-normal log-density given the lower Cholesky factor of
    the covariance.

    mu (*b, d) and chol (*b, d, d) share the batch dims *b (none in the
    plain form); z is (*b, ..., d). For each batch entry the samples are
    flattened into one (d, n) block, so the whole call is one triangular
    solve. Returns (*b, ...)."""
    d = mu.shape[-1]
    nb = mu.dim() - 1
    extra = z.dim() - mu.dim()
    diff = z - mu.reshape(mu.shape[:-1] + (1,) * extra + (d,))
    flat = diff.reshape(diff.shape[:nb] + (-1, d)).transpose(-1, -2)
    sol = torch.linalg.solve_triangular(chol, flat, upper=False)
    maha = torch.sum(sol ** 2, dim=-2).reshape(diff.shape[:-1])
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)),
                             dim=-1)
    logdet = logdet.reshape(logdet.shape + (1,) * extra)
    return -0.5 * (maha + logdet + d * _LOG_2PI)
