"""ToyMAFVAE, the ``toy-maf`` baseline: the toy VAE with a conditional-MAF
posterior flow (JAX twin: ardae_tpu/models/vae/maf.py, a working
realization of a model the reference driver selects but never shipped).

q(z|x) is the Gaussian base N(mu(x), sigma(x)) pushed through the inverse of
two conditional MAF blocks (the coordinates reversed between them), both
conditioned on the encoder's hidden features:

    z0 ~ N(mu, sigma);  z = T^{-1}(z0; ctx)
    log q(z|x) = log N(z0; mu, sigma) - sum_blocks sum_i a_i

Each block's density direction is u_i = (z_i - m_i(z_<i, ctx)) *
exp(-a_i(z_<i, ctx)). Sampling inverts block by block with the d-pass
fixed point (pass k finalizes coordinate k). The heads start at zero, so a
fresh model is the Gaussian-posterior toy VAE up to the reversal.
"""

import torch

from ardae_tpu_torch.models.vae.toy import ToyVAE
from ardae_tpu_torch.nn.made import ConditionalMADE


class ToyMAFVAE(ToyVAE):
    """ToyVAE (the same encoder and decoder) plus the posterior flow
    ``flow0``, ``flow1``."""

    family = "flow_posterior"
    n_flows = 2

    def __init__(self, input_dim=2, h_dim=64, z_dim=2, nonlinearity="softplus",
                 num_hidden_layers=1):
        super().__init__(input_dim, h_dim, z_dim, nonlinearity, num_hidden_layers)
        for b in range(self.n_flows):
            self.add_module(f"flow{b}",
                            ConditionalMADE(z_dim, h_dim, h_dim, nonlinearity))

    @property
    def flows(self):
        return [getattr(self, f"flow{b}") for b in range(self.n_flows)]

    def encode_ctx(self, x):
        """(mu, logvar, ctx): the base Gaussian and the flow's context."""
        h = self.enc_main(x.reshape(x.shape[0], -1))
        mu, logvar = self.enc_reparam(h)
        return mu, logvar, h

    def flow_forward(self, z, ctx):
        """Density direction z -> z0: (z0, sum_a), log|det dz0/dz| = -sum_a."""
        u, sum_a = z, torch.zeros(z.shape[:-1], dtype=z.dtype, device=z.device)
        for b, made in enumerate(self.flows):
            if b > 0:
                u = torch.flip(u, dims=(-1,))
            m, a = made(u, ctx)
            u = (u - m) * torch.exp(-a)
            sum_a = sum_a + torch.sum(a, dim=-1)
        return u, sum_a

    def flow_inverse(self, z0, ctx):
        """Sampling direction z0 -> z: (z, sum_a), log q(z|x) = log N(z0;
        mu, sigma) - sum_a."""
        u = z0
        sum_a = torch.zeros(z0.shape[:-1], dtype=z0.dtype, device=z0.device)
        for b in reversed(range(self.n_flows)):
            made = self.flows[b]
            # pass k finalizes coordinate k: (m_i, a_i) read only v_{<i},
            # which pass k - 1 finalized
            v = torch.zeros_like(u)
            for _ in range(self.z_dim):
                m, a = made(v, ctx)
                v = u * torch.exp(a) + m
            sum_a = sum_a + torch.sum(a, dim=-1)
            u = torch.flip(v, dims=(-1,)) if b > 0 else v
        return u, sum_a
