"""Plain-PyTorch reference of the benchmark's models and training step;
imports nothing of the program.

Each part of a configuration is a file of its own, found by the name the
configuration gives it, so that a new model, score net or context is a new
file and no file here changes:

  * ``models/<model>.py``: ``spec(cfg)`` (name -> shape), ``sample_z(cfg,
    P, x, eps)`` -> (bsz, nz, z), ``decode_logits(cfg, P, z)`` -> (n,
    pixels); optionally ``noise_widths(cfg)`` (else (model_n_dim,); more
    than one width makes the noise a tuple, as an aux model's pair);
  * ``cdae/<cdae>.py``: ``STYLE`` (the port's score style), ``out_width``,
    ``spec(cfg, ctx_width)``, ``ctx_l0(cfg, Q, ctx)``, ``score(cfg, Q, x,
    c0, std, create_graph)``;
  * ``ctx/<cdae_ctx_type>.py``: ``width(cfg, model)``, ``context(cfg,
    model, P, x, latent_mean)``.
"""

import importlib.util
import os

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
_LOADED = {}


def part(kind, name):
    """The module ``<kind>/<name>.py`` of this directory."""
    path = os.path.join(HERE, kind, f"{name}.py")
    if path not in _LOADED:
        if not os.path.exists(path):
            raise NotImplementedError(
                f"no reference {kind} file for {name!r}: add portbench/reference/{kind}/{name}.py")
        spec = importlib.util.spec_from_file_location(
            f"portbench.reference.{kind}.{name.replace('-', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _LOADED[path] = mod
    return _LOADED[path]


def model(cfg):
    return part("models", cfg["model"])


def cdae(cfg):
    return part("cdae", cfg["cdae"])


def ctx(cfg):
    return part("ctx", cfg["cdae_ctx_type"])


def specs(cfg):
    """{"model": spec, "cdae": spec} of the configuration."""
    return {"model": model(cfg).spec(cfg),
            "cdae": cdae(cfg).spec(cfg, ctx(cfg).width(cfg, model(cfg)))}


def noise_widths(cfg):
    m = model(cfg)
    return tuple(m.noise_widths(cfg)) if hasattr(m, "noise_widths") else (cfg["model_n_dim"],)


def encode_det(cfg, P, x):
    """The std-0 encoding (bsz, 1, z): ``sample_z`` at zero noise."""
    zeros = tuple(torch.zeros(x.shape[0], w, device=x.device) for w in noise_widths(cfg))
    return model(cfg).sample_z(cfg, P, x, zeros if len(zeros) > 1 else zeros[0])
