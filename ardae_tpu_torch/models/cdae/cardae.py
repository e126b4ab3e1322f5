"""Conditional AR-DAE score networks (JAX twin: ardae_tpu/models/cdae/cardae.py).

  * residual style: score = the trunk's direct output;
  * gradient style: score = d/dx [-energy(x)], through
    ``torch.autograd.grad(create_graph=True)`` so the DSM loss can be
    differentiated again with respect to the parameters.

The trunk's first layer is split: ``{trunk}_l0_row`` takes the per-row input
(encoded features, then sigma as the LAST input column) and
``{trunk}_l0_ctx`` takes the per-item context features. The context
contribution is computed once per item, (bsz, h), and broadcast over the nz
sample axis. Module and parameter names follow the flax twin
(``dae``/``neglogprob``), so ``convert.py`` maps one tree onto the other.

The unconditional variants of the notebook workloads (``dae_score`` /
``dae_loss``; the ARDAE and DAE constructors) are the same module with
``conditional=False``; a fixed-sigma one (``sigma_conditioned=False``)
reads sigma only in the loss.
"""

import torch
import torch.nn as nn

from ardae_tpu_torch.core.precision import cast_input, cast_module
from ardae_tpu_torch.nn.activations import get_nonlinear_func
from ardae_tpu_torch.nn.linear import Linear
from ardae_tpu_torch.nn.mlp import MLP


class CARDAE(nn.Module):
    def __init__(self, input_dim, h_dim=128, context_dim=2, num_hidden_layers=1,
                 nonlinearity="tanh", score_type="res", conditional=True,
                 sigma_conditioned=True, enc_input=True, enc_ctx=True):
        super().__init__()
        if num_hidden_layers < 1:
            raise ValueError("num_hidden_layers must be >= 1")
        nhl = num_hidden_layers
        self.input_dim, self.h_dim, self.context_dim = input_dim, h_dim, context_dim
        self.num_hidden_layers, self.nonlinearity = nhl, nonlinearity
        self.score_type, self.conditional = score_type, conditional
        self.sigma_conditioned, self.enc_input, self.enc_ctx = (
            sigma_conditioned, enc_input, enc_ctx)
        self.afun = get_nonlinear_func(nonlinearity)
        enc = dict(hidden_dim=h_dim, output_dim=h_dim, nonlinearity=nonlinearity,
                   num_hidden_layers=nhl - 1, use_nonlinearity_output=True)
        row_dim, ctx_dim = input_dim, context_dim
        if conditional:
            if enc_ctx:
                self.ctx_encode = MLP(context_dim, **enc)
                ctx_dim = h_dim
            if enc_input:
                self.inp_encode = MLP(input_dim, **enc)
                row_dim = h_dim
        if sigma_conditioned:
            row_dim += 1
        self.trunk_name = "dae" if score_type == "res" else "neglogprob"
        out_dim = 1 if score_type == "grad" else input_dim
        self.add_module(f"{self.trunk_name}_l0_row", Linear(row_dim, h_dim))
        if conditional:
            self.add_module(f"{self.trunk_name}_l0_ctx",
                            Linear(ctx_dim, h_dim, use_bias=False))
        self.add_module(self.trunk_name, MLP(
            h_dim, h_dim, out_dim, nonlinearity=nonlinearity,
            num_hidden_layers=nhl - 1, use_nonlinearity_output=False))

    @property
    def l0_row(self):
        return getattr(self, f"{self.trunk_name}_l0_row")

    @property
    def l0_ctx(self):
        return getattr(self, f"{self.trunk_name}_l0_ctx")

    @property
    def trunk_rest(self):
        return getattr(self, self.trunk_name)

    def encode_ctx(self, ctx):
        if not self.conditional:
            raise ValueError("unconditional DAE has no context path")
        return self.ctx_encode(ctx) if self.enc_ctx else ctx

    def ctx_l0(self, ctx):
        """Per-item context -> first-layer contribution (bsz, h)."""
        if ctx.dim() == 3:
            ctx = ctx.reshape(ctx.shape[0], -1)
        return self.l0_ctx(self.encode_ctx(ctx))

    def _trunk(self, x, ctx_l0, std):
        parts = [self.inp_encode(x) if (self.conditional and self.enc_input)
                 else x]
        if self.sigma_conditioned:
            parts.append(std)
        h = self.l0_row(torch.cat(parts, dim=-1) if len(parts) > 1 else parts[0])
        if ctx_l0 is not None:
            n, bsz = x.shape[0], ctx_l0.shape[0]
            h = (h.reshape(bsz, n // bsz, self.h_dim)
                 + ctx_l0[:, None, :]).reshape(n, self.h_dim)
        return self.trunk_rest(self.afun(h))

    def raw_score(self, x, ctx_l0, std):
        """Direct-score path: (n, z_dim) rows -> (n, z_dim) scores."""
        return self._trunk(x, ctx_l0, std)

    def energy(self, x, ctx_l0, std):
        """Scalar neg-log-prob per row (gradient style), (n,)."""
        return self._trunk(x, ctx_l0, std)[:, 0]


def _score(module, x, ctx_l0, stdv, create_graph):
    if module.score_type == "res":
        return module.raw_score(x, ctx_l0, stdv)
    with torch.enable_grad():
        xx = x if x.requires_grad else x.detach().requires_grad_(True)
        neg_energy = -torch.sum(module.energy(xx, ctx_l0, stdv))
        (g,) = torch.autograd.grad(neg_energy, xx, create_graph=create_graph)
    return g


def _stdv(std, bsz, ssz, like):
    std = torch.as_tensor(std, dtype=torch.float32, device=like.device)
    return std.expand(bsz, ssz, 1).reshape(-1, 1)


def cdae_score(module, latent, context, std):
    """glogprob: score at ``latent`` (bsz, ssz, z) given context (bsz, c) and
    noise level ``std`` (scalar or (bsz, ssz, 1)) -> (bsz, ssz, z)."""
    bsz, ssz, zdim = latent.shape
    x = latent.reshape(-1, zdim)
    ctx = module.ctx_l0(context)
    score = _score(module, x, ctx, _stdv(std, bsz, ssz, latent),
                   create_graph=False)
    return score.reshape(bsz, ssz, zdim)


def dsm_noise(shape, generator=None, eps=None, device=None):
    """The DSM's Gaussian noise: the injected ``eps`` or a fresh draw."""
    if eps is not None:
        return eps.reshape(shape).to(torch.float32)
    if generator is None:
        raise ValueError("needs a generator or an injected eps")
    return torch.randn(shape, generator=generator,
                       device=device if device is not None else generator.device)


def cdae_loss(module, latent, context, std, generator=None, eps=None,
              compute_dtype=None):
    """Denoising score-matching loss mse(sigma * score(x + sigma*eps), -eps),
    mean over every element (reference resdae/mlp.py:344-381,
    graddae/mlp.py:400-444). Gaussian noise only: no line of either
    package sets the Laplace or uniform noise (ROADMAP, "Not ported").

    ``compute_dtype='bfloat16'`` is the JAX twin's recipe: the noise, the
    perturbation x + sigma*eps and the loss product sigma*score + eps stay
    fp32; x_bar, the context and sigma are cast to bf16 and the score net
    (the context contribution included; a grad-style net's input gradient
    too) runs on its parameters cast to bf16, the gradient reaching the
    fp32 parameters through the cast."""
    bsz, ssz, zdim = latent.shape
    x = latent.reshape(-1, zdim).to(torch.float32)
    stdv = _stdv(std, bsz, ssz, x)
    eps = dsm_noise(x.shape, generator, eps, device=x.device)
    x_bar = x + stdv * eps
    net = cast_module(module, compute_dtype)
    x_bar_c, ctx_c, stdv_c = (cast_input(v, compute_dtype)
                              for v in (x_bar, context, stdv))
    score = _score(net, x_bar_c, net.ctx_l0(ctx_c), stdv_c, create_graph=True)
    return torch.mean((stdv * score.float() + eps) ** 2)


def _row_std(std, n, like):
    """sigma as an (n, 1) column, from a scalar or an (n, 1) tensor."""
    return torch.as_tensor(std, dtype=torch.float32, device=like.device).expand(n, 1)


def dae_score(module, x, std):
    """Unconditional score at ``x`` (n, input_dim), noise level ``std``
    (scalar or (n, 1)) -> (n, input_dim) (reference resdae/mlp.py:82-90,
    153-167; graddae/mlp.py:101-116, 186-207). The grad style builds no
    graph back to the parameters: the score comes out detached."""
    return _score(module, x, None, _row_std(std, x.shape[0], x),
                  create_graph=False)


def dae_loss(module, x, std, generator=None, eps=None, noise_type="gaussian"):
    """Unconditional denoising score-matching loss
    mse(sigma * score(x + sigma*eps), -eps), mean over every element;
    ``eps`` (n, input_dim) injected or drawn from ``generator``. Gaussian
    noise only, as ``cdae_loss`` (ROADMAP, "Not ported")."""
    if noise_type != "gaussian":
        raise NotImplementedError(
            f"DSM noise {noise_type!r} is not ported (ROADMAP, \"Not ported\": "
            "the Laplace and uniform DSM noise)")
    x = x.to(torch.float32)
    stdv = _row_std(std, x.shape[0], x)
    eps = dsm_noise(x.shape, generator, eps, device=x.device)
    score = _score(module, x + stdv * eps, None, stdv, create_graph=True)
    return torch.mean((stdv * score + eps) ** 2)


def MLPResCARDAE(input_dim, context_dim, h_dim=128, num_hidden_layers=1,
                 nonlinearity="tanh", enc_input=True, enc_ctx=True):
    return CARDAE(input_dim, h_dim, context_dim, num_hidden_layers,
                  nonlinearity, "res", True, True, enc_input, enc_ctx)


def MLPGradCARDAE(input_dim, context_dim, h_dim=128, num_hidden_layers=1,
                  nonlinearity="tanh", enc_input=True, enc_ctx=True):
    return CARDAE(input_dim, h_dim, context_dim, num_hidden_layers,
                  nonlinearity, "grad", True, True, enc_input, enc_ctx)


def MLPResCDAE(input_dim, context_dim, h_dim=128, num_hidden_layers=1,
               nonlinearity="tanh", enc_input=True, enc_ctx=True):
    """resdae ConditionalDAE, fixed sigma (reference resdae/mlp.py:170-284)."""
    return CARDAE(input_dim, h_dim, context_dim, num_hidden_layers,
                  nonlinearity, "res", True, False, enc_input, enc_ctx)


def MLPGradCDAE(input_dim, context_dim, h_dim=128, num_hidden_layers=1,
                nonlinearity="tanh", enc_input=True, enc_ctx=True):
    """graddae ConditionalDAE, fixed sigma (reference graddae/mlp.py:210-339)."""
    return CARDAE(input_dim, h_dim, context_dim, num_hidden_layers,
                  nonlinearity, "grad", True, False, enc_input, enc_ctx)


def MLPResARDAE(input_dim, h_dim=1000, num_hidden_layers=1, nonlinearity="tanh"):
    """resdae ARDAE, unconditional (reference resdae/mlp.py:92-167)."""
    return CARDAE(input_dim, h_dim, num_hidden_layers=num_hidden_layers,
                  nonlinearity=nonlinearity, score_type="res",
                  conditional=False, sigma_conditioned=True)


def MLPGradARDAE(input_dim, h_dim=1000, num_hidden_layers=1, nonlinearity="tanh"):
    """graddae ARDAE, unconditional (reference graddae/mlp.py:118-207)."""
    return CARDAE(input_dim, h_dim, num_hidden_layers=num_hidden_layers,
                  nonlinearity=nonlinearity, score_type="grad",
                  conditional=False, sigma_conditioned=True)


def MLPResDAE(input_dim, h_dim=1000, num_hidden_layers=1, nonlinearity="tanh"):
    """resdae DAE, unconditional, fixed sigma (reference resdae/mlp.py:27-90)."""
    return CARDAE(input_dim, h_dim, num_hidden_layers=num_hidden_layers,
                  nonlinearity=nonlinearity, score_type="res",
                  conditional=False, sigma_conditioned=False)


def MLPGradDAE(input_dim, h_dim=1000, num_hidden_layers=1, nonlinearity="tanh"):
    """graddae DAE, unconditional, fixed sigma (reference graddae/mlp.py:39-116)."""
    return CARDAE(input_dim, h_dim, num_hidden_layers=num_hidden_layers,
                  nonlinearity=nonlinearity, score_type="grad",
                  conditional=False, sigma_conditioned=False)
