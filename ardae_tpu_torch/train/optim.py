"""Optimizers with the reference's exact update laws (JAX twin:
ardae_tpu/train/optim.py).

  vendored Adam (reference utils/optim.py:50-110), which is NOT
  ``torch.optim.Adam``: eps outside the sqrt, step size lr*sqrt(bc2)/bc1,
      p -= lr*sqrt(bc2)/bc1 * m / (sqrt(v) + eps)
  vendored AdamW (reference utils/optim.py:111-215): decoupled decay
      p *= 1 - lr*wd before the update, and eps added before the
      bias-correction division, denom = (sqrt(v) + eps) / sqrt(bc2)
  torch RMSprop: avg = sqrt(sq) + eps; with momentum buf = mu*buf + g/avg,
      p -= lr*buf
All update the parameters in place. ``lr`` is a float or a schedule
``lr(count)`` (``step_lr``), read at a parameter's update count BEFORE the
update, as the JAX twin reads ``_as_sched(lr)(state.count)``; not
``torch.optim.lr_scheduler``'s call-after-step convention, which is one
step off.
"""

import math

import torch


def step_lr(base_lr, step_size, gamma=0.1, min_lr=0.0):
    """StepLR with a floor (reference utils/lr_scheduler.py:6-39):
    lr(t) = max(min_lr, base_lr * gamma^(t // step_size))."""

    def sched(count):
        return max(min_lr, base_lr * gamma ** (count // step_size))

    return sched


def _lr_at(lr, count):
    return lr(count) if callable(lr) else lr


class TorchAdam(torch.optim.Optimizer):
    def __init__(self, params, lr, b1=0.9, b2=0.999, eps=1e-8, amsgrad=False,
                 **extra):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps,
                                      amsgrad=amsgrad, **extra))

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            b1, b2 = group["b1"], group["b2"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["count"] = 0
                    st["mu"] = torch.zeros_like(p)
                    st["nu"] = torch.zeros_like(p)
                    if group["amsgrad"]:
                        st["max_nu"] = torch.zeros_like(p)
                lr_now = _lr_at(group["lr"], st["count"])
                st["count"] += 1
                g = p.grad
                st["mu"].mul_(b1).add_(g, alpha=1.0 - b1)
                st["nu"].mul_(b2).addcmul_(g, g, value=1.0 - b2)
                denom_src = st["nu"]
                if group["amsgrad"]:
                    torch.maximum(st["max_nu"], st["nu"], out=st["max_nu"])
                    denom_src = st["max_nu"]
                self._update(p, group, st["mu"], denom_src, lr_now,
                             1.0 - b1 ** st["count"], 1.0 - b2 ** st["count"])

    @staticmethod
    def _update(p, group, mu, denom_src, lr, bc1, bc2):
        """p -= lr*sqrt(bc2)/bc1 * m / (sqrt(v) + eps)."""
        p.addcdiv_(mu, denom_src.sqrt().add_(group["eps"]),
                   value=-(lr * math.sqrt(bc2) / bc1))


class TorchAdamW(TorchAdam):
    def __init__(self, params, lr, b1=0.9, b2=0.999, eps=1e-8,
                 weight_decay=1e-2, amsgrad=False):
        super().__init__(params, lr, b1, b2, eps, amsgrad,
                         weight_decay=weight_decay)

    @staticmethod
    def _update(p, group, mu, denom_src, lr, bc1, bc2):
        """p *= 1 - lr*wd; p -= lr/bc1 * m / ((sqrt(v) + eps) / sqrt(bc2))."""
        denom = denom_src.sqrt().add_(group["eps"]).div_(math.sqrt(bc2))
        p.mul_(1.0 - lr * group["weight_decay"])
        p.addcdiv_(mu, denom, value=-lr / bc1)


class TorchRMSprop(torch.optim.Optimizer):
    def __init__(self, params, lr, alpha=0.99, eps=1e-8, momentum=0.0):
        super().__init__(params, dict(lr=lr, alpha=alpha, eps=eps,
                                      momentum=momentum))

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            alpha, eps, mom = group["alpha"], group["eps"], group["momentum"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["sq"] = torch.zeros_like(p)
                    st["buf"] = torch.zeros_like(p)
                # a state saved before schedules were read holds no count
                st.setdefault("count", 0)
                lr_now = _lr_at(group["lr"], st["count"])
                st["count"] += 1
                g = p.grad
                st["sq"].mul_(alpha).addcmul_(g, g, value=1.0 - alpha)
                avg = st["sq"].sqrt().add_(eps)
                if mom > 0.0:
                    st["buf"].mul_(mom).addcdiv_(g, avg)
                    p.add_(st["buf"], alpha=-lr_now)
                else:
                    p.addcdiv_(g, avg, value=-lr_now)


def torch_adam(params, lr, b1=0.9, b2=0.999, eps=1e-8, amsgrad=False):
    return TorchAdam(params, lr, b1=b1, b2=b2, eps=eps, amsgrad=amsgrad)


def torch_adamw(params, lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-2,
                amsgrad=False):
    return TorchAdamW(params, lr, b1=b1, b2=b2, eps=eps,
                      weight_decay=weight_decay, amsgrad=amsgrad)


def torch_rmsprop(params, lr, alpha=0.99, eps=1e-8, momentum=0.0):
    return TorchRMSprop(params, lr, alpha=alpha, eps=eps, momentum=momentum)


def build_optimizer(name, params, lr, beta1=0.5, momentum=0.5):
    """Optimizer factory mirroring the driver flags
    (reference ivae_ardae.py:546-556, 618-629)."""
    if name == "sgd":
        # no momentum, like the reference's optim.SGD(params, lr=...)
        return torch.optim.SGD(params, lr=lr)
    if name == "adam":
        return torch_adam(params, lr, b1=beta1)
    if name == "amsgrad":
        return torch_adam(params, lr, b1=beta1, amsgrad=True)
    if name == "rmsprop":
        return torch_rmsprop(params, lr, momentum=momentum)
    if name == "adamw":  # vendored by the reference (utils/optim.py:111)
        return torch_adamw(params, lr, b1=beta1)
    raise NotImplementedError(f"unknown optimizer: {name}")
