"""The system under test, driven as its trainer drives it: the port's
TrainState and StepConfig from the line's flags (``cli/ivae_ardae.py``
``build_state`` and ``_train``), phase A's kernel library, and
``train/step.py`` ``train_chunk`` in whole chunks of the log interval,
the metrics read once a chunk (``cli/common.py`` ``run_pipeline``).

The kernel libraries are built by ``ops/native.py`` into ``build/`` at the
checkout's root, which is rebuilt whenever a source is newer than the
library. In a copied checkout the files' times need not keep their order,
so this module keeps a hash of what a library was built from beside it
(``build/lib<name>.so.sha256``: the kernel's source, the shared headers
and ``native.py``, which holds the nvcc flags): where the hash matches,
the library's time is moved past its sources' and nothing is rebuilt;
where it does not, the library is removed and built anew.
"""

import glob
import hashlib
import importlib
import os
import time

import numpy as np
import torch

# configuration keys that are no flag of the trainer's: the data is the
# benchmark's own, made from the seed
NOT_FLAGS = ("dataset",)


def argv(config, traffic):
    """The trainer's command line for a configuration under a traffic mix:
    every key of the configuration that the trainer's parser takes, the
    traffic's compute dtypes and ``--use-kernels``."""
    from ardae_tpu_torch.cli.ivae_ardae import build_parser

    dests = {a.dest for a in build_parser()._actions}
    flags = {k: v for k, v in config.items() if k in dests and k not in NOT_FLAGS}
    for k in ("cdae_compute_dtype", "model_compute_dtype"):
        flags[k] = traffic[k]
    out = []
    for k, v in flags.items():
        out += [f"--{k.replace('_', '-')}", str(v)]
    return out + (["--use-kernels"] if traffic["use_kernels"] else [])


def _library_hash(native, name):
    csrc = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(native.__file__))), "csrc")
    h = hashlib.sha256()
    for path in [os.path.join(csrc, f"{name}.cu")] + sorted(glob.glob(os.path.join(csrc, "*.cuh"))) \
            + [os.path.abspath(native.__file__)]:
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    return h.hexdigest(), csrc


def library_name(style):
    """The kernel library of phase A for a cdae of score ``style``
    (``reference/cdae/<cdae>.py`` ``STYLE``): the module of the fused loss
    that the port's step dispatches to that style, ``ops/<name>.py``,
    which binds ``csrc/<name>.cu``."""
    from ardae_tpu_torch.train import step

    return step._KERNELS[style][1].__module__.rsplit(".", 1)[1]


def load_library(style):
    """Build (where its hash differs) and load phase A's kernel library
    for a cdae of score ``style``. Returns {"name", "built", "build_s",
    "s"}."""
    from ardae_tpu_torch.ops import native

    t0 = time.perf_counter()
    name = library_name(style)
    digest, csrc = _library_hash(native, name)
    lib, stamp = native.lib_path(name), native.lib_path(name) + ".sha256"
    kept = None
    if os.path.exists(lib) and os.path.exists(stamp):
        with open(stamp) as f:
            kept = f.read().strip()
    if kept == digest:
        newest = max(os.path.getmtime(p) for p in glob.glob(os.path.join(csrc, "*")))
        t = max(time.time(), newest + 1.0)
        os.utime(lib, (t, t))
    elif os.path.exists(lib):
        os.remove(lib)
    op = importlib.import_module(f"ardae_tpu_torch.ops.{name}")
    _, info = op.build_library()
    if info["built"] or kept != digest:
        with open(stamp, "w") as f:
            f.write(digest + "\n")
    return {"name": name, "built": bool(info["built"]), "build_s": float(info["seconds"]),
            "s": time.perf_counter() - t0}


class Program:
    """The port's state and step configuration for one run."""

    def __init__(self, config, traffic, device, seed):
        from ardae_tpu_torch.cli.ivae_ardae import build_parser, build_state
        from ardae_tpu_torch.core.annealing import annealing_func
        from ardae_tpu_torch.train.step import StepConfig

        opt = build_parser().parse_args(argv(config, traffic) + ["--seed", str(seed % 2**31)])
        for name in ("beta_annealing", "eta_annealing", "lmbd_annealing"):
            v = getattr(opt, name)
            if v is None or v < 1:
                setattr(opt, name, None)
        self.opt, self.device = opt, device
        self.state, _ = build_state(opt, device)
        self.cfg = StepConfig(
            std_scale=opt.std_scale, delta=opt.delta,
            num_cdae_updates=opt.num_cdae_updates,
            train_nz_cdae=opt.train_nz_cdae, train_nstd_cdae=opt.train_nstd_cdae,
            train_nz_model=opt.train_nz_model, ctx_type=opt.cdae_ctx_type,
            use_kernels=opt.use_kernels,
            cdae_compute_dtype=opt.cdae_compute_dtype,
            model_compute_dtype=opt.model_compute_dtype,
            weight_avg=opt.m_weight_avg,
            weight_avg_start=opt.m_weight_avg_start,
            weight_avg_decay=opt.m_weight_avg_decay)
        self.beta_fn = lambda step: annealing_func(opt.beta_init, opt.beta_fin,
                                                   opt.beta_annealing, step)

    def load_weights(self, w):
        self.state.model.load_state_dict(w["model"])
        self.state.cdae.load_state_dict(w["cdae"])

    def chunk(self, data, feed, generator, k, draws=None):
        """k joint steps through ``train_chunk``, as the trainer's ``train``
        feeds it; returns the last step's metrics, read on the host."""
        from ardae_tpu_torch.train import step

        u, bs = self.opt.num_cdae_updates, self.opt.train_batch_size
        c_idx = feed.take(k * u).reshape(k, u, bs)
        m_idx = feed.take(k)
        metrics = step.train_chunk(self.state, self.cfg, data, c_idx, m_idx, generator,
                                   self.beta_fn, binarize=True, draws=draws)
        return {name: float(v) for name, v in metrics.items()}, c_idx, m_idx

    def first_grads(self):
        """{leaf: |first gradient| of each element as the optimizers hold
        it}, as ``reference.step.Optimizer.first_grads`` reads its own."""
        out = {}
        with torch.no_grad():
            for net, module, opt in (("model", self.state.model, self.state.opt_model),
                                     ("cdae", self.state.cdae, self.state.opt_cdae)):
                g = opt.param_groups[0]
                for name, p in module.named_parameters():
                    st = opt.state.get(p)
                    if not st:
                        out[f"{net}.{name}"] = torch.zeros_like(p)
                    elif "mu" in st:
                        out[f"{net}.{name}"] = st["mu"].abs() / (1.0 - g["b1"])
                    else:
                        out[f"{net}.{name}"] = torch.sqrt(st["sq"] / (1.0 - g["alpha"]))
        return out

    def delta(self, w0):
        """{leaf: the change from the weights ``w0``, a tensor}."""
        with torch.no_grad():
            return {f"{net}.{name}": p - w0[net][name]
                    for net, module in (("model", self.state.model), ("cdae", self.state.cdae))
                    for name, p in module.named_parameters()}


def window(program, data, feed, generator, seconds, chunk_steps, on_chunk=None):
    """Whole chunks until ``seconds`` have passed, then a synchronize.
    Returns (steps, wall seconds, steps of chunks whose metrics were not
    finite)."""
    steps = bad = 0
    sync = torch.cuda.synchronize if data.is_cuda else (lambda: None)
    sync()
    t0 = time.perf_counter()
    while True:
        metrics, _, _ = program.chunk(data, feed, generator, chunk_steps)
        steps += chunk_steps
        if not all(np.isfinite(v) for v in metrics.values()):
            bad += chunk_steps
        if on_chunk is not None:
            on_chunk(steps)
        if time.perf_counter() - t0 >= seconds:
            break
    sync()
    return steps, time.perf_counter() - t0, bad
