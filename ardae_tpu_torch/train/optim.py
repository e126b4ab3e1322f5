"""Optimizers with the reference's exact update laws (JAX twin:
ardae_tpu/train/optim.py).

  vendored Adam (reference utils/optim.py:50-110), which is NOT
  ``torch.optim.Adam``: eps outside the sqrt, step size lr*sqrt(bc2)/bc1,
      p -= lr*sqrt(bc2)/bc1 * m / (sqrt(v) + eps)
  torch RMSprop: avg = sqrt(sq) + eps; with momentum buf = mu*buf + g/avg,
      p -= lr*buf
Both update the parameters in place.
"""

import math

import torch


class TorchAdam(torch.optim.Optimizer):
    def __init__(self, params, lr, b1=0.9, b2=0.999, eps=1e-8, amsgrad=False):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps,
                                      amsgrad=amsgrad))

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            b1, b2, eps = group["b1"], group["b2"], group["eps"]
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
                lr_now = group["lr"]
                st["count"] += 1
                bc1 = 1.0 - b1 ** st["count"]
                bc2 = 1.0 - b2 ** st["count"]
                g = p.grad
                st["mu"].mul_(b1).add_(g, alpha=1.0 - b1)
                st["nu"].mul_(b2).addcmul_(g, g, value=1.0 - b2)
                denom_src = st["nu"]
                if group["amsgrad"]:
                    torch.maximum(st["max_nu"], st["nu"], out=st["max_nu"])
                    denom_src = st["max_nu"]
                step_size = lr_now * math.sqrt(bc2) / bc1
                p.addcdiv_(st["mu"], denom_src.sqrt().add_(eps), value=-step_size)


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
                g = p.grad
                st["sq"].mul_(alpha).addcmul_(g, g, value=1.0 - alpha)
                avg = st["sq"].sqrt().add_(eps)
                if mom > 0.0:
                    st["buf"].mul_(mom).addcdiv_(g, avg)
                    p.add_(st["buf"], alpha=-group["lr"])
                else:
                    p.addcdiv_(g, avg, value=-group["lr"])


def torch_adam(params, lr, b1=0.9, b2=0.999, eps=1e-8, amsgrad=False):
    return TorchAdam(params, lr, b1=b1, b2=b2, eps=eps, amsgrad=amsgrad)


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
    raise NotImplementedError(f"unknown optimizer: {name}")
