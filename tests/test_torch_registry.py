"""The port's model registry puts what it builds on the card unless the
caller asks for the CPU: the default device of both build functions is
CUDA, and without a card that default raises instead of quietly building
on the CPU."""

import inspect

import pytest
import torch

from ardae_tpu_torch.models.registry import build_cdae, build_ivae_model

BUILDS = {
    "build_ivae_model": lambda **kw: build_ivae_model(
        "mnist-conv", nchannels=1, nheight=28, z_dim=4, h_dim=0, n_dim=3,
        n_layers=0, nonlin="softplus", **kw),
    "build_cdae": lambda **kw: build_cdae(
        "mlp-grad", input_dim=4, context_dim=4, h_dim=8, n_layers=2,
        nonlin="softplus", **kw),
}


@pytest.mark.parametrize("build", [build_ivae_model, build_cdae],
                         ids=["build_ivae_model", "build_cdae"])
def test_default_device_is_the_card(build):
    assert inspect.signature(build).parameters["device"].default == "cuda"


@pytest.mark.parametrize("name", sorted(BUILDS))
def test_default_build_goes_to_the_card_or_raises(name):
    if torch.cuda.is_available():
        module = BUILDS[name]()
        assert all(p.is_cuda for p in module.parameters())
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            BUILDS[name]()


@pytest.mark.parametrize("name", sorted(BUILDS))
def test_cpu_on_request(name):
    module = BUILDS[name](device="cpu")
    assert all(p.device.type == "cpu" for p in module.parameters())
