"""Probability helpers of the IWS evaluator (JAX twin: ardae_tpu/core/stats.py).

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
