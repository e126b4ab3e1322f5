"""Plain-PyTorch reference of the joint AR-DAE training step (the
reference's ivae_ardae.py:729-800), frozen here. It follows the program
through its first steps from the same weights, batches and draws, and
reports what the comparison reads:

  * each step's last phase-A loss and its phase-B model loss;
  * per leaf, the size of each element's first gradient as the optimizer
    holds it after one step (Adam: |mu| / (1 - beta1); RMSprop: sqrt(sq /
    (1 - alpha)), the gradient after one update and a blend of the step's
    updates after several);
  * per leaf, the parameters' change over the steps.

PHASE A (x num_cdae_updates, each on its own batch):
    sigma_i = delta * mean_d std_s(std_scale * (z_s - z_det))   per item
    DSM loss of the cdae at sigma_i * N(0, 1) per draw; RMSprop or Adam.
PHASE B: mean(recon + beta * prior) + beta / (bsz nz) * sum(score * lsm),
    the score detached at noise level 0; the model's optimizer step.

Optimizers: the reference's vendored Adam (eps outside the sqrt, step
lr sqrt(bc2) / bc1) and torch's RMSprop with momentum.

The model, the score net and the context are the configuration's files
(``portbench/reference/__init__.py``).
"""

import math

import torch

from portbench import reference as R


def annealing(init, fin, steps, step):
    """Linear ramp from init to fin over ``steps`` (None or < 1: fin)."""
    if steps is None or steps < 1:
        return fin
    return init + (fin - init) * min(float(steps), step) / float(steps)


class Optimizer:
    """Adam (vendored law) or RMSprop over a dict of leaves, in place."""

    def __init__(self, kind, params, lr, beta1, momentum):
        if kind not in ("adam", "rmsprop"):
            raise NotImplementedError(f"reference optimizer {kind!r}")
        self.kind, self.params, self.lr = kind, params, lr
        self.b1, self.b2, self.alpha, self.eps, self.mom = beta1, 0.999, 0.99, 1e-8, momentum
        self.state = {}

    @torch.no_grad()
    def step(self):
        for name, p in self.params.items():
            g = p.grad
            if g is None:
                continue
            st = self.state.setdefault(name, {"count": 0, "a": torch.zeros_like(p),
                                              "b": torch.zeros_like(p)})
            st["count"] += 1
            if self.kind == "adam":
                st["a"].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
                st["b"].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
                bc1, bc2 = 1.0 - self.b1 ** st["count"], 1.0 - self.b2 ** st["count"]
                p.addcdiv_(st["a"], st["b"].sqrt().add_(self.eps),
                           value=-(self.lr * math.sqrt(bc2) / bc1))
            else:
                st["a"].mul_(self.alpha).addcmul_(g, g, value=1.0 - self.alpha)
                avg = st["a"].sqrt().add_(self.eps)
                if self.mom > 0.0:
                    st["b"].mul_(self.mom).addcdiv_(g, avg)
                    p.add_(st["b"], alpha=-self.lr)
                else:
                    p.addcdiv_(g, avg, value=-self.lr)
            p.grad = None

    def first_grads(self):
        """{leaf: |gradient| of each element as the state holds it after
        one step}; zeros for a leaf with no state (no gradient reached it)."""
        out = {}
        for name, p in self.params.items():
            st = self.state.get(name)
            if st is None:
                out[name] = torch.zeros_like(p)
            elif self.kind == "adam":
                out[name] = st["a"].abs() / (1.0 - self.b1)
            else:
                out[name] = torch.sqrt(st["a"] / (1.0 - self.alpha))
        return out


def _sigma_stats(cfg, P, x, latent_eps):
    with torch.no_grad():
        latent_mean = R.encode_det(cfg, P, x)
        latent = R.model(cfg).sample_z(cfg, P, x, latent_eps)
        lsm = cfg["std_scale"] * (latent - latent_mean)
        std_qz = torch.std(lsm, dim=1, keepdim=True, unbiased=True)
        sigma = cfg["delta"] * torch.mean(std_qz, dim=2, keepdim=True)
    return lsm, sigma, latent_mean


def dsm_loss(cfg, Q, lsm, ctx, stdmat, eps):
    """mean((sigma * score(x + sigma eps) + eps)^2) over every element."""
    net = R.cdae(cfg)
    bsz, ssz, z = lsm.shape
    x = lsm.reshape(-1, z)
    stdv = stdmat.expand(bsz, ssz, 1).reshape(-1, 1)
    s = net.score(cfg, Q, x + stdv * eps, net.ctx_l0(cfg, Q, ctx), stdv, True)
    return torch.mean((stdv * s + eps) ** 2)


def context(cfg, P, x, latent_mean):
    return R.ctx(cfg).context(cfg, R.model(cfg), P, x, latent_mean)


def cdae_update(cfg, P, Q, opt_d, x, d):
    lsm, sigma, latent_mean = _sigma_stats(cfg, P, x, d["latent_eps"])
    with torch.no_grad():
        ctx = context(cfg, P, x, latent_mean)
    stdmat = sigma * d["std"]
    loss = dsm_loss(cfg, Q, lsm, ctx, stdmat, d["dsm_eps"])
    loss.backward()
    opt_d.step()
    return loss.detach()


def model_update(cfg, P, Q, opt_m, x, d, beta):
    bsz, nz = x.shape[0], cfg["train_nz_model"]
    z = R.model(cfg).sample_z(cfg, P, x, d["eps"])
    z_flat = z.reshape(bsz * nz, -1)
    logit = R.model(cfg).decode_logits(cfg, P, z_flat)
    target = x[:, None, :].expand(bsz, nz, x.shape[-1]).reshape(bsz * nz, -1)
    recon = torch.sum(torch.clamp(logit, min=0.0) - logit * target
                      + torch.log1p(torch.exp(-torch.abs(logit))), dim=1)
    prior = torch.sum(0.5 * (z_flat ** 2 + math.log(2.0 * math.pi)), dim=1)
    model_loss = torch.mean(recon + beta * prior)
    with torch.no_grad():
        latent_mean = R.encode_det(cfg, P, x)
        lsm = cfg["std_scale"] * (z - latent_mean)
        net = R.cdae(cfg)
        c0 = net.ctx_l0(cfg, Q, context(cfg, P, x, latent_mean))
        s = net.score(cfg, Q, lsm.reshape(-1, lsm.shape[-1]), c0,
                      torch.zeros(lsm.shape[0] * nz, 1, device=x.device), False)
    aux = torch.sum(s.reshape(lsm.shape) * (cfg["std_scale"] * (z - latent_mean)))
    (model_loss + beta * aux / (bsz * nz)).backward()
    for q in Q.values():
        q.grad = None
    opt_m.step()
    return model_loss.detach()


def _half(d, bsz):
    """The first half of an update's items and their draws (a fault for
    the comparison's tests: half of the batch left out)."""
    def keep(t):
        if isinstance(t, tuple):
            return tuple(keep(e) for e in t)
        return t.reshape(bsz, -1)[: bsz // 2].reshape(-1, *t.shape[1:])

    return {k: t[: bsz // 2] if k == "std" else keep(t) for k, t in d.items()}


def run_steps(cfg, P0, Q0, data, steps, half=False):
    """The first len(steps) joint steps from weights ``P0`` (model) and
    ``Q0`` (cdae), on ``data`` (N, 784) gray values. Each step: ``c_idx``
    (U, B) and ``m_idx`` (B,) rows of ``data``, ``bin_cdae`` (U, B, 784)
    and ``bin_model`` (B, 784) uniforms of the binarization, ``cdae`` a
    list of U dicts {latent_eps, std, dsm_eps} and ``model`` {eps}.
    Returns {"losses": [(cdae loss, model loss)], "first_grad": {leaf:
    |element| tensor}, "delta": {leaf: the change, a tensor}} with leaves
    "model.<name>" and "cdae.<name>"."""
    P = {k: v.detach().clone().requires_grad_(True) for k, v in P0.items()}
    Q = {k: v.detach().clone().requires_grad_(True) for k, v in Q0.items()}
    opt_m = Optimizer(cfg["m_optimizer"], P, cfg["m_lr"], cfg["m_beta1"], cfg["m_momentum"])
    opt_d = Optimizer(cfg["d_optimizer"], Q, cfg["d_lr"], cfg["d_beta1"], cfg["d_momentum"])
    out = {"losses": []}
    for i, st in enumerate(steps):
        bsz = st["m_idx"].shape[0]
        binar = lambda idx, u: (u < data.index_select(0, idx.reshape(-1)).reshape(u.shape)).float()
        c_loss = None
        for u, d in enumerate(st["cdae"]):
            x = binar(st["c_idx"][u], st["bin_cdae"][u])
            if half:
                x, d = x[: bsz // 2], _half(d, bsz)
            c_loss = cdae_update(cfg, P, Q, opt_d, x, d)
        for p in P.values():
            p.grad = None
        x = binar(st["m_idx"], st["bin_model"])
        d = st["model"]
        if half:
            x, d = x[: bsz // 2], _half(d, bsz)
        beta = annealing(cfg["beta_init"], cfg["beta_fin"], cfg["beta_annealing"], i)
        m_loss = model_update(cfg, P, Q, opt_m, x, d, beta)
        out["losses"].append((float(c_loss), float(m_loss)))
        if i == 0:
            out["first_grad"] = {**{f"model.{k}": v for k, v in opt_m.first_grads().items()},
                                 **{f"cdae.{k}": v for k, v in opt_d.first_grads().items()}}
    with torch.no_grad():
        out["delta"] = {**{f"model.{k}": P[k] - P0[k] for k in P},
                        **{f"cdae.{k}": Q[k] - Q0[k] for k in Q}}
    return out
