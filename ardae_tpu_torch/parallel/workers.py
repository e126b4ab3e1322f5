"""Rank workers that train a few steps outside the drivers: the
multi-device dry run (graft_entry.py) and the checks that hold a world of
N ranks against a world of one (chip_smoke.py phase 11, the tests).

``joint_steps`` (the joint AR-DAE step, train/step.py) and ``vae_steps``
(the baseline step, train/vae_step.py) each build a state from a picklable
``spec`` and train ``len(spec["model_idx"])`` steps through the chunk
function, one step a call, on a mesh of ``spec["dp"]`` x ``spec["sp"]``
ranks (``launch`` them with parallel/launch.py), or as a world of one when
both are 1, with or without a process group. The spec:

- ``model`` / ``cdae``: (registry name, builder keywords); ``state``:
  optional state dicts {"model", "cdae"} loaded over the build;
- ``opt_model`` / ``opt_cdae``: (optimizer name, lr, keywords of
  ``build_optimizer``);
- ``cfg``: keywords of the step's config; ``beta``; ``seed`` of the
  training generator;
- ``data`` (N, D), ``model_idx`` (K, B) and, for the joint step,
  ``cdae_idx`` (K, U, B), global; ``binarize``; ``draws``: optional
  per-step injected draws, at global shapes;
- ``snapshots``: the steps after which to keep the parameters and the
  optimizer states (0: before the first).

Each returns {"metrics": [per step {name: float}], "snapshots": {step:
{name: state dict}}, "launches": this rank's kernel launches over the
steps, "ms": [per step milliseconds, the device synchronised]}, on the CPU.
On a card they run in full fp32, TF32 off, as the drivers do.
"""

import time

import torch

from ardae_tpu_torch.parallel.mesh import sample_parallel_mesh


def _cpu(obj):
    """A copy of a (nested) state dict on the CPU."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_cpu(v) for v in obj)
    return obj


def _mesh(spec, device):
    dp, sp = spec.get("dp", 1), spec.get("sp", 1)
    return None if dp * sp == 1 else sample_parallel_mesh(dp, sp, device)


def _kernel_counters():
    from ardae_tpu_torch.ops.fused_dsm import FusedDSMFunction
    from ardae_tpu_torch.ops.fused_dsm_grad import FusedDSMGradFunction

    return FusedDSMFunction.launches, FusedDSMGradFunction.launches


def _optimizer(entry, params):
    from ardae_tpu_torch.train.optim import build_optimizer

    name, lr, kw = entry
    return build_optimizer(name, params, lr, **kw)


def joint_state(spec, device):
    """The joint step's state that ``spec`` builds on ``device``."""
    from ardae_tpu_torch.models.registry import build_cdae, build_ivae_model
    from ardae_tpu_torch.train.state import create_train_state

    (m_name, m_kw), (d_name, d_kw) = spec["model"], spec["cdae"]
    model = build_ivae_model(m_name, device=device, **m_kw)
    cdae = build_cdae(d_name, device=device, **d_kw)
    if spec.get("state"):
        model.load_state_dict(spec["state"]["model"])
        cdae.load_state_dict(spec["state"]["cdae"])
    return create_train_state(model, _optimizer(spec["opt_model"], model.parameters()),
                              cdae, _optimizer(spec["opt_cdae"], cdae.parameters()))


def _vae_state(spec, device):
    from ardae_tpu_torch.models.registry import build_vae_model
    from ardae_tpu_torch.train.state import create_train_state

    name, kw = spec["model"]
    model = build_vae_model(name, device=device, **kw)
    if spec.get("state"):
        model.load_state_dict(spec["state"]["model"])
    return create_train_state(model, _optimizer(spec["opt_model"], model.parameters()))


def _steps(spec, device, mesh, build, step):
    """The loop both workers share: ``step(state, k, generator)`` trains
    step k of ``build()``'s state and returns its metrics."""
    from ardae_tpu_torch.cli.common import rank_device

    rank_device(device)  # TF32 off on a card, as the drivers run
    state = build()
    generator = torch.Generator(device=device).manual_seed(spec.get("seed", 0))
    counters = _kernel_counters()
    for c in counters:
        c.update(dict.fromkeys(c, 0))
    out = {"metrics": [], "snapshots": {}, "ms": []}
    if 0 in spec.get("snapshots", ()):
        out["snapshots"][0] = _cpu(state.state_dict())
    for k in range(len(spec["model_idx"])):
        t0 = time.perf_counter()
        metrics = step(state, k, generator)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        out["ms"].append(1e3 * (time.perf_counter() - t0))
        out["metrics"].append({n: float(v) for n, v in metrics.items()})
        if state.step in spec.get("snapshots", ()):
            out["snapshots"][state.step] = _cpu(state.state_dict())
    out["launches"] = {n: c for counter in counters for n, c in counter.items()}
    return out


def run_joint(device, spec, mesh):
    """``joint_steps`` on a mesh built by the caller (the dry run runs two
    in one world)."""
    from ardae_tpu_torch.train.step import StepConfig, train_chunk

    cfg = StepConfig(**spec["cfg"])
    data = torch.as_tensor(spec["data"], device=device)
    draws = spec.get("draws")

    def step(state, k, generator):
        return train_chunk(state, cfg, data, spec["cdae_idx"][k:k + 1],
                           spec["model_idx"][k:k + 1], generator,
                           lambda s: spec["beta"], spec.get("binarize", False),
                           draws[k:k + 1] if draws else None, mesh)

    return _steps(spec, device, mesh, lambda: joint_state(spec, device), step)


def joint_steps(device, spec):
    """The joint step's rank worker (module docstring)."""
    return run_joint(device, spec, _mesh(spec, device))


def vae_steps(device, spec):
    """The baseline step's rank worker (module docstring)."""
    from ardae_tpu_torch.train.vae_step import VAEStepConfig, train_vae_chunk

    mesh = _mesh(spec, device)
    cfg = VAEStepConfig(**spec["cfg"])
    data = torch.as_tensor(spec["data"], device=device)
    draws = spec.get("draws")

    def step(state, k, generator):
        return train_vae_chunk(state, cfg, data, spec["model_idx"][k:k + 1],
                               generator, lambda s: spec["beta"],
                               spec.get("binarize", False),
                               draws[k:k + 1] if draws else None, mesh)

    return _steps(spec, device, mesh, lambda: _vae_state(spec, device), step)
