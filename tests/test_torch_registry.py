"""The port's model registry puts what it builds on the card unless the
caller asks for the CPU: the default device of every build function is
CUDA, and without a card that default raises instead of quietly building
on the CPU. Every aux name builds; what is not ported raises naming its
slice."""

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
    (build_vae_model, "auxmlp", "unknown model"),
    (build_vae_model, "auxresconv-clip", "unknown model"),
    (build_ivae_model, "auxtoy", "unknown model"),
    (build_ivae_model, "toy", "unknown model")])
def test_unported_models_raise_naming_their_slice(build, name, slice_):
    """What still raises once every name builds: an aux name of the other
    driver (auxmlp and the -clip names are implicit only, auxtoy a baseline
    only) is unknown to that registry."""
    with pytest.raises(NotImplementedError, match=slice_):
        build(name, device="cpu")


@pytest.mark.parametrize("build,name,family", [
    *[(build_ivae_model, n, "aux") for n in (
        "auxmlp", "auxmnist", "auxconv", "auxresconv", "auxresconvct",
        "auxresconv-clip", "auxresconvct-clip")],
    *[(build_vae_model, n, "aux_gaussian_posterior") for n in (
        "auxtoy", "auxmnist", "auxconv", "auxresconv", "auxresconvct")]])
def test_every_aux_name_builds(build, name, family):
    """The seven aux IVAE names and the five aux baseline names build (on
    the CPU on request), centred and clipped as the JAX registry builds
    them."""
    toy = name in ("auxmlp", "auxtoy")
    model = build(name, nchannels=2 if toy else 1, nheight=1 if toy else 28,
                  z_dim=4, h_dim=8, n_dim=6, n_layers=2, nonlin="softplus",
                  device="cpu")
    assert model.family == family and model.noise_dim == 6 and model.z_dim == 4
    assert all(p.device.type == "cpu" for p in model.parameters())
    if "resconv" in name:
        assert model.trunk.do_center is ("ct" in name)
    if build is build_ivae_model and "resconv" in name:
        assert model.z0_min_std == (1.0 if name.endswith("-clip") else 0.0)
        assert model.aux_reparam.clip == (None if name.endswith("-clip") else "spm4")


def test_cdae_mlp_raises_as_the_jax_registry():
    """No registry builds the legacy --cdae mlp (JAX's raises "unknown
    cdae: mlp"): the refusal says so, and points at models/cdae/legacy.py,
    which holds the legacy DAEs."""
    from ardae_tpu_torch.models.registry import build_cdae

    with pytest.raises(NotImplementedError,
                       match="nor any registry.*unknown cdae: mlp.*legacy.py"):
        build_cdae("mlp", input_dim=2, context_dim=2, device="cpu")
