"""The port's optimizers against ardae_tpu.train.optim over a few steps with
the same gradient sequence: the vendored Adam law (eps outside the sqrt,
step size lr*sqrt(bc2)/bc1; not torch.optim.Adam) and torch's RMSprop law.
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


def _run(jtx, make_torch):
    shapes = {"w": (3, 4), "b": (4,)}
    params = {k: rand(i, *s) for i, (k, s) in enumerate(shapes.items())}
    grads = [{k: rand(10 * s + i, *shapes[k], scale=0.1 * (s + 1))
              for i, k in enumerate(shapes)} for s in range(STEPS)]
    jp = dict(params)
    state = jtx.init(jp)
    tp = {k: torch.nn.Parameter(torch.tensor(v)) for k, v in params.items()}
    opt = make_torch(list(tp.values()))
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


@pytest.mark.parametrize("name", ["sgd", "adam", "amsgrad", "rmsprop"])
def test_build_optimizer(name):
    _run(jopt.build_optimizer(name, 1e-3, beta1=0.9, momentum=0.9),
         lambda ps: topt.build_optimizer(name, ps, 1e-3, beta1=0.9, momentum=0.9))


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
