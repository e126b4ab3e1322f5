"""The port's model registry puts what it builds on the card unless the
caller asks for the CPU: the default device of every build function is
CUDA, and without a card that default raises instead of quietly building
on the CPU."""

import inspect

import pytest
import torch

from ardae_tpu_torch.models.registry import (
    build_cdae,
    build_ivae_model,
    build_vae_model,
)

BUILDS = {
    "build_ivae_model": lambda **kw: build_ivae_model(
        "mnist-conv", nchannels=1, nheight=28, z_dim=4, h_dim=0, n_dim=3,
        n_layers=0, nonlin="softplus", **kw),
    "build_cdae": lambda **kw: build_cdae(
        "mlp-grad", input_dim=4, context_dim=4, h_dim=8, n_layers=2,
        nonlin="softplus", **kw),
    "build_vae_model": lambda **kw: build_vae_model(
        "mnist", z_dim=4, h_dim=8, n_layers=2, **kw),
}


@pytest.mark.parametrize("build", [build_ivae_model, build_cdae, build_vae_model],
                         ids=["build_ivae_model", "build_cdae", "build_vae_model"])
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


@pytest.mark.parametrize("name,center", [("resconv", False), ("resconvct", True)])
def test_resconv_baseline_centres_as_the_jax_registry(name, center):
    """resconvct centres the trunk's input and resconv does not, as the JAX
    registry builds them (the reference driver centres neither)."""
    model = build_vae_model(name, z_dim=4, nonlin="elu", device="cpu")
    assert model.trunk.do_center is center


@pytest.mark.parametrize("build,name,slice_", [
    (build_vae_model, "auxtoy", "slice 5"), (build_vae_model, "toy-maf", "slice 6"),
    (build_vae_model, "auxmnist", "slice 5"),
    (build_ivae_model, "auxmlp", "slice 5"),
    (build_ivae_model, "auxresconvct", "slice 5")])
def test_unported_models_raise_naming_their_slice(build, name, slice_):
    with pytest.raises(NotImplementedError, match=slice_):
        build(name, device="cpu")
