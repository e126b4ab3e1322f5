"""The port's optimizers against ardae_tpu.train.optim over a few steps with
the same gradient sequence: the vendored Adam law (eps outside the sqrt,
step size lr*sqrt(bc2)/bc1; not torch.optim.Adam), the vendored AdamW law
(decoupled decay, eps before the bias-correction division) and torch's
RMSprop law, each with a constant rate and under step_lr.
fp32, rtol 1e-5 / atol 1e-7 (the port's bias corrections are computed in
double on the host, the JAX ones in fp32)."""

import jax
import numpy as np
import pytest
import torch

from ardae_tpu.train import optim as jopt
from ardae_tpu_torch.train import optim as topt
from torch_parity import close, rand

STEPS = 6


def _run(jtx, make_torch, count=None):
    """STEPS updates on both sides; ``count``: both optimizers' update count
    set to it before the first (moments zero)."""
    shapes = {"w": (3, 4), "b": (4,)}
    params = {k: rand(i, *s) for i, (k, s) in enumerate(shapes.items())}
    grads = [{k: rand(10 * s + i, *shapes[k], scale=0.1 * (s + 1))
              for i, k in enumerate(shapes)} for s in range(STEPS)]
    jp = dict(params)
    state = jtx.init(jp)
    tp = {k: torch.nn.Parameter(torch.tensor(v)) for k, v in params.items()}
    opt = make_torch(list(tp.values()))
    if count is not None:
        state = state._replace(count=jax.numpy.asarray(count, jax.numpy.int32))
        for prm in tp.values():
            opt.state[prm] = {"count": count, **{
                k: torch.zeros_like(prm) for k in ("mu", "nu", "sq", "buf")}}
    for g in grads:
        upd, state = jtx.update(g, state, jp)
        jp = jax.tree.map(lambda p, u: p + u, jp, upd)
        for k, prm in tp.items():
            prm.grad = torch.tensor(g[k])
        opt.step()
    for k in shapes:
        close(tp[k], jp[k], 1e-5, 1e-7, msg=k)


@pytest.mark.parametrize("amsgrad", [False, True])
@pytest.mark.parametrize("b1", [0.5, 0.9])
def test_adam(b1, amsgrad):
    _run(jopt.torch_adam(1e-3, b1=b1, amsgrad=amsgrad),
         lambda ps: topt.torch_adam(ps, 1e-3, b1=b1, amsgrad=amsgrad))


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_rmsprop(momentum):
    _run(jopt.torch_rmsprop(1e-4, momentum=momentum),
         lambda ps: topt.torch_rmsprop(ps, 1e-4, momentum=momentum))


@pytest.mark.parametrize("name", ["sgd", "adam", "amsgrad", "rmsprop", "adamw"])
def test_build_optimizer(name):
    _run(jopt.build_optimizer(name, 1e-3, beta1=0.9, momentum=0.9),
         lambda ps: topt.build_optimizer(name, ps, 1e-3, beta1=0.9, momentum=0.9))


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_adamw(weight_decay):
    _run(jopt.torch_adamw(1e-3, b1=0.5, weight_decay=weight_decay),
         lambda ps: topt.torch_adamw(ps, 1e-3, b1=0.5, weight_decay=weight_decay))


def test_step_lr():
    jsched, tsched = (m.step_lr(1e-3, 5000, 0.5, min_lr=1e-10) for m in (jopt, topt))
    for count in (0, 1, 4999, 5000, 5001, 10000, 10**6):
        np.testing.assert_allclose(tsched(count), float(jsched(count)), rtol=1e-6,
                                   err_msg=str(count))
    assert tsched(4999) == 1e-3 and tsched(5000) == 5e-4 and tsched(10**6) == 1e-10


_SCHEDULED = {
    "adam": (lambda lr: jopt.torch_adam(lr, b1=0.5),
             lambda ps, lr: topt.torch_adam(ps, lr, b1=0.5)),
    "rmsprop": (lambda lr: jopt.torch_rmsprop(lr, momentum=0.5),
                lambda ps, lr: topt.torch_rmsprop(ps, lr, momentum=0.5)),
    "adamw": (lambda lr: jopt.torch_adamw(lr, b1=0.9, weight_decay=0.1),
              lambda ps, lr: topt.torch_adamw(ps, lr, b1=0.9, weight_decay=0.1)),
}


@pytest.mark.parametrize("name", list(_SCHEDULED))
def test_under_step_lr(name):
    """The rate is read at the update count before the update (the JAX
    twin's _as_sched(lr)(state.count)): with step_size 2 it halves for the
    third and fifth of the six updates, down to the floor; a schedule one
    step off (torch's StepLR convention) fails this."""
    jmake, tmake = _SCHEDULED[name]
    _run(jmake(jopt.step_lr(1e-3, 2, 0.5, min_lr=3e-4)),
         lambda ps: tmake(ps, topt.step_lr(1e-3, 2, 0.5, min_lr=3e-4)))


@pytest.mark.parametrize("name", list(_SCHEDULED))
def test_step_lr_boundary_at_5000(name):
    """ardae_fit's schedule, StepLR(5000, 0.5): updates at counts 4,999 (the
    base rate) and 5,000 on (half of it)."""
    jmake, tmake = _SCHEDULED[name]
    _run(jmake(jopt.step_lr(1e-3, 5000, 0.5, min_lr=1e-10)),
         lambda ps: tmake(ps, topt.step_lr(1e-3, 5000, 0.5, min_lr=1e-10)),
         count=4999)


def test_adam_is_not_torch_adam():
    """The vendored law differs from torch.optim.Adam's (eps placement)."""
    p1 = torch.nn.Parameter(torch.ones(3))
    p2 = torch.nn.Parameter(torch.ones(3))
    o1 = topt.torch_adam([p1], 0.1, eps=1e-1)
    o2 = torch.optim.Adam([p2], 0.1, eps=1e-1)
    for o, p in ((o1, p1), (o2, p2)):
        p.grad = torch.full((3,), 0.01)
        o.step()
    assert not torch.allclose(p1, p2)
