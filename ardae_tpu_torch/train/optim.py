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

Each optimizer also has a step that a CUDA graph can replay
(``prepare_replay`` once before capture, ``fill_replay`` on the host before
each replay, ``replay_step`` captured): the same law over each group in
``torch._foreach_*`` passes, its per-step scalars (``_scalars``: the rate
at the update count and the bias corrections) read from 0-d device tensors
that the host fills before each replay. The state, its ``count`` and the
``state_dict`` are those ``step`` keeps.
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


def _adam_terms(group, count):
    """The rate at update count ``count`` and the bias corrections 1 - b^t
    of the update it makes, t = count + 1."""
    return (_lr_at(group["lr"], count), 1.0 - group["b1"] ** (count + 1),
            1.0 - group["b2"] ** (count + 1))


class Replayable(torch.optim.Optimizer):
    """The replayed step's host side, shared by the optimizers below; each
    defines ``_init`` (a parameter's fresh state), ``_scalars`` (a group's
    per-step scalars at an update count) and ``replay_step``."""

    def prepare_replay(self):
        """Before capture, with the gradients of a pass in place: the state
        of every parameter with a gradient (initialised where missing) and
        a 0-d device tensor a per-step scalar of each group. Raises where
        a group's parameters hold different update counts."""
        self._replay = []
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            for p in params:
                if not self.state[p]:
                    self._init(p, group)
                # a state saved before schedules were read holds no count
                self.state[p].setdefault("count", 0)
            states = [self.state[p] for p in params]
            counts = sorted({st["count"] for st in states})
            if len(counts) > 1:
                raise ValueError("a replayed step takes one update count a group; "
                                 f"this group's parameters hold {counts}")
            scalars = tuple(torch.zeros((), dtype=params[0].dtype, device=params[0].device)
                            for _ in self._scalars(group, 0))
            self._replay.append((group, params, states, scalars))

    def fill_replay(self):
        """On the host before a replay: each group's scalars at its update
        count, filled, and the counts advanced, as ``step`` advances them."""
        for group, _, states, scalars in self._replay:
            count = states[0]["count"]
            for t, v in zip(scalars, self._scalars(group, count)):
                t.fill_(v)
            for st in states:
                st["count"] = count + 1


class TorchAdam(Replayable):
    def __init__(self, params, lr, b1=0.9, b2=0.999, eps=1e-8, amsgrad=False,
                 **extra):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps,
                                      amsgrad=amsgrad, **extra))

    def _init(self, p, group):
        st = self.state[p]
        st["count"] = 0
        st["mu"] = torch.zeros_like(p)
        st["nu"] = torch.zeros_like(p)
        if group["amsgrad"]:
            st["max_nu"] = torch.zeros_like(p)

    @staticmethod
    def _scalars(group, count):
        """The update's step at update count ``count``: -lr*sqrt(bc2)/bc1."""
        lr, bc1, bc2 = _adam_terms(group, count)
        return (-(lr * math.sqrt(bc2) / bc1),)

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            b1, b2 = group["b1"], group["b2"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    self._init(p, group)
                scalars = self._scalars(group, st["count"])
                st["count"] += 1
                g = p.grad
                st["mu"].mul_(b1).add_(g, alpha=1.0 - b1)
                st["nu"].mul_(b2).addcmul_(g, g, value=1.0 - b2)
                denom_src = st["nu"]
                if group["amsgrad"]:
                    torch.maximum(st["max_nu"], st["nu"], out=st["max_nu"])
                    denom_src = st["max_nu"]
                self._update(p, st["mu"], denom_src.sqrt().add_(group["eps"]), scalars)

    @staticmethod
    def _update(p, mu, denom, scalars):
        """p -= lr*sqrt(bc2)/bc1 * m / (sqrt(v) + eps)."""
        p.addcdiv_(mu, denom, value=scalars[0])

    @torch.no_grad()
    def replay_step(self):
        for group, params, states, scalars in self._replay:
            b1, b2 = group["b1"], group["b2"]
            grads = [p.grad for p in params]
            mu, nu = [st["mu"] for st in states], [st["nu"] for st in states]
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, grads, alpha=1.0 - b1)
            torch._foreach_mul_(nu, b2)
            torch._foreach_addcmul_(nu, grads, grads, value=1.0 - b2)
            if group["amsgrad"]:
                torch._foreach_maximum_([st["max_nu"] for st in states], nu)
                nu = [st["max_nu"] for st in states]
            denom = torch._foreach_sqrt(nu)
            torch._foreach_add_(denom, group["eps"])
            self._replay_update(params, mu, denom, scalars)

    @staticmethod
    def _replay_update(params, mu, denom, scalars):
        upd = torch._foreach_div(mu, denom)
        torch._foreach_mul_(upd, scalars[0])
        torch._foreach_add_(params, upd)


class TorchAdamW(TorchAdam):
    def __init__(self, params, lr, b1=0.9, b2=0.999, eps=1e-8,
                 weight_decay=1e-2, amsgrad=False):
        super().__init__(params, lr, b1, b2, eps, amsgrad,
                         weight_decay=weight_decay)

    @staticmethod
    def _scalars(group, count):
        """The decay factor 1 - lr*wd, sqrt(bc2) and the step -lr/bc1."""
        lr, bc1, bc2 = _adam_terms(group, count)
        return (1.0 - lr * group["weight_decay"], math.sqrt(bc2), -lr / bc1)

    @staticmethod
    def _update(p, mu, denom, scalars):
        """p *= 1 - lr*wd; p -= lr/bc1 * m / ((sqrt(v) + eps) / sqrt(bc2))."""
        decay, sqrt_bc2, step = scalars
        denom.div_(sqrt_bc2)
        p.mul_(decay)
        p.addcdiv_(mu, denom, value=step)

    @staticmethod
    def _replay_update(params, mu, denom, scalars):
        decay, sqrt_bc2, step = scalars
        torch._foreach_div_(denom, sqrt_bc2)
        torch._foreach_mul_(params, decay)
        upd = torch._foreach_div(mu, denom)
        torch._foreach_mul_(upd, step)
        torch._foreach_add_(params, upd)


class TorchRMSprop(Replayable):
    def __init__(self, params, lr, alpha=0.99, eps=1e-8, momentum=0.0):
        super().__init__(params, dict(lr=lr, alpha=alpha, eps=eps,
                                      momentum=momentum))

    def _init(self, p, group):
        st = self.state[p]
        st["sq"] = torch.zeros_like(p)
        st["buf"] = torch.zeros_like(p)

    @staticmethod
    def _scalars(group, count):
        """The step -lr at update count ``count``."""
        return (-_lr_at(group["lr"], count),)

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            alpha, eps, mom = group["alpha"], group["eps"], group["momentum"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    self._init(p, group)
                # a state saved before schedules were read holds no count
                st.setdefault("count", 0)
                (step,) = self._scalars(group, st["count"])
                st["count"] += 1
                g = p.grad
                st["sq"].mul_(alpha).addcmul_(g, g, value=1.0 - alpha)
                avg = st["sq"].sqrt().add_(eps)
                if mom > 0.0:
                    st["buf"].mul_(mom).addcdiv_(g, avg)
                    p.add_(st["buf"], alpha=step)
                else:
                    p.addcdiv_(g, avg, value=step)

    @torch.no_grad()
    def replay_step(self):
        for group, params, states, (step,) in self._replay:
            alpha, mom = group["alpha"], group["momentum"]
            grads = [p.grad for p in params]
            sq = [st["sq"] for st in states]
            torch._foreach_mul_(sq, alpha)
            torch._foreach_addcmul_(sq, grads, grads, value=1.0 - alpha)
            avg = torch._foreach_sqrt(sq)
            torch._foreach_add_(avg, group["eps"])
            if mom > 0.0:
                buf = [st["buf"] for st in states]
                torch._foreach_mul_(buf, mom)
                torch._foreach_addcdiv_(buf, grads, avg)
                upd = torch._foreach_mul(buf, step)
            else:
                upd = torch._foreach_div(grads, avg)
                torch._foreach_mul_(upd, step)
            torch._foreach_add_(params, upd)


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
