"""The joint AR-DAE training step (JAX twin: ardae_tpu/train/step.py).

  PHASE A (x num_cdae_updates, each on its own data batch):
    sigma_i   = delta * mean_d std_s( std_scale * (z_s - z_det) )   per item
    stdmat    ~ sigma_i * N(0,1)  per (item, sample)
    cdae loss = mse(sigma * score(x_bar, ctx, sigma), -eps)
    cdae optimizer step.
  PHASE B (fresh batch):
    model loss = mean(recon + beta * prior_energy), plus the entropy-gradient
    surrogate beta/(bsz*nz) * sum(stop_grad(score) * std_scale*(z - z_det)),
    whose d/dz is the gradient the reference injects by graph surgery.
    model optimizer step.

PyTorch runs eagerly: the K-step chunk is a Python loop over steps, with the
batch gather and the Bernoulli binarization on the device. Every random draw
can be injected (``draws``); otherwise it comes from the explicit generator.
After each step, ``update_weight_avg`` moves the averaged model (Polyak or
SWA) in a few ``torch._foreach_*`` passes.
The step, its index upload and gathers, each phase-A update (its sampling
pass and its DSM loss) and phase B run inside ``ardae.*`` spans
(utils/tracing.py), which record only while a profiler records. Inside the
sampling pass, the nz-row encoder pass is ``ardae.sample.latents``, with
the rows it returned counted (``ardae.sample.latents.rows``), and an aux
model's hidden1a context ``ardae.context``; the lt0 context, a reshape of
the std-0 encoding, launches nothing and has no span.

Phase B on a CUDA device, with no mesh and under one of the port's own
optimizers (``train/optim.py`` ``Replayable``), is one CUDA graph
(``PhaseBGraph``): its device work (the loss, the detached passes, the
surrogate, the backward and the optimizer's step) is captured at the first
phase B and replayed at every one after: one launch in place of one a
kernel. The batch, the encoder noise and beta go into static buffers
first, the noise drawn in the eager path's order; the graph is captured
again when what it reads moves. On the CPU, under a mesh or with another
optimizer, phase B runs eagerly.

Mixed precision follows the JAX twin (step.py:41-85, :114-264):
``cdae_compute_dtype='bfloat16'`` runs phase A's sampling pass, its
hidden1a context and the DSM loss's score net on bf16 copies of the fp32
parameters, the sigma statistics and the loss product in fp32;
``model_compute_dtype='bfloat16'`` runs phase B's model loss and its
detached context and latent-mean passes so, cast back to fp32. The fused
kernels are fp32 only: ``--use-kernels`` with a bf16 phase A raises.

Data and sample parallelism (``mesh``, parallel/mesh.py; JAX: the jitted
step under a ("data", "sample") mesh with ``shard_samples``, step.py:79-96):
each rank takes its items of the batch and its samples of phase A's
nz_cdae axis (all of them when the mesh's sample axis is 1). Every draw is
made at its global shape and sliced, so the generators stay in lockstep.
The sigma statistics (a std over nz, two passes) sum over the sample group;
the gradients are averaged over the world before each optimizer step, and
a chunk's last metrics reduced so that rank 0 reports what a world of one
reports. Phase B is not split over samples: the ranks of a sample group
run it alike. ``mesh=None`` is the one-process step.
"""

import dataclasses

import torch

from ardae_tpu_torch.core.precision import cast_input, cast_module, compute_dtype
from ardae_tpu_torch.data.loader import gather_batches
from ardae_tpu_torch.models.cdae.cardae import cdae_loss, cdae_score, dsm_noise
from ardae_tpu_torch.models.ivae import api as ivae_api
from ardae_tpu_torch.ops.fused_dsm import fused_cdae_dsm_loss, supports_fused_dsm
from ardae_tpu_torch.ops.fused_dsm_grad import (
    fused_cdae_dsm_grad_loss,
    supports_fused_dsm_grad,
)
from ardae_tpu_torch.parallel.mesh import local
from ardae_tpu_torch.train.optim import Replayable
from ardae_tpu_torch.utils.tracing import count, span

# --use-kernels: each cdae style's hand-written kernel and the guard that
# decides whether it covers a cdae
_KERNELS = {"res": (supports_fused_dsm, fused_cdae_dsm_loss),
            "grad": (supports_fused_dsm_grad, fused_cdae_dsm_grad_loss)}


@dataclasses.dataclass(frozen=True)
class StepConfig:
    std_scale: float = 1.0
    delta: float = 1.0
    num_cdae_updates: int = 1
    train_nz_cdae: int = 1
    train_nstd_cdae: int = 1
    train_nz_model: int = 1
    ctx_type: str = "data"  # data | lt0 | hidden1a (aux models)
    # the DSM noise: gaussian | laplace | uniform (models/cdae/cardae.py);
    # no driver flag sets it, as in the JAX twin
    noise_type: str = "gaussian"
    # the hand-written fused DSM kernels for phase A (ops/fused_dsm for a
    # res-style cdae, ops/fused_dsm_grad for a grad-style one); a config the
    # kernel does not cover raises instead of falling back
    use_kernels: bool = False
    # mixed precision ("float32" | "bfloat16"): phase A's sampling pass,
    # hidden1a context and score net; phase B's model loss and detached
    # passes (the JAX twin's fields of the same names)
    cdae_compute_dtype: str = "float32"
    model_compute_dtype: str = "float32"
    weight_avg: str = "none"  # none | polyak | swa
    weight_avg_start: int = 1000
    weight_avg_decay: float = 0.998


def _randn(shape, generator, device, injected=None):
    if injected is not None:
        return injected.to(device=device, dtype=torch.float32).reshape(shape)
    return torch.randn(shape, generator=generator, device=device)


def compute_context(model, x, ctx_type):
    """CDAE conditioning (reference ivae_ardae.py:729-741), detached."""
    with torch.no_grad():
        if ctx_type == "data":
            ctx = x.reshape(x.shape[0], -1)
            return 2.0 * ctx - 1.0 if model.center_input else ctx
        if ctx_type == "lt0":
            z = ivae_api.encode_det(model, x)
            return z.reshape(z.shape[0], -1)
        if ctx_type == "hidden1a":
            return ivae_api.encode_hidden_feats(model, x)
    raise NotImplementedError(ctx_type)


def _local_rows(mesh, t, bsz, ssz, samples):
    """This rank's rows of a global (bsz*ssz, w) draw whose rows run item by
    item (and of an aux model's pair, each), its samples too where
    ``samples``."""
    if mesh is None:
        return t
    if isinstance(t, tuple):
        return tuple(_local_rows(mesh, e, bsz, ssz, samples) for e in t)
    block = local(mesh, t.reshape(bsz, ssz, -1), 0, 1 if samples else None)
    return block.reshape(-1, t.shape[-1])


def _encoder_noise(model, x, nz, generator, injected, mesh, samples):
    """The encoder noise of nz samples an item at the global batch's shape
    (injected, or drawn as ``make_eps`` draws it), then this rank's rows."""
    bsz = x.shape[0] * (1 if mesh is None else mesh.dp)
    eps = injected if injected is not None else ivae_api.make_eps(
        model, bsz, nz, generator=generator, device=x.device)
    return _local_rows(mesh, eps, bsz, nz, samples)


@torch.no_grad()
def _sigma_stats(model, x, cfg, generator, latent_eps=None, mesh=None):
    """Per-item adaptive noise level (reference ivae_ardae.py:748-758). The
    sampling pass runs in phase A's compute dtype, the statistics in fp32;
    also returns that pass's model and input, for the hidden1a context.
    On a mesh with a sample axis the rank draws its samples only, and the
    std over nz (ddof 1) is two sums over the sample group, the mean's and
    the squared deviations', as ``jnp.std`` computes it."""
    net = cast_module(model, cfg.cdae_compute_dtype)
    x_c = cast_input(x, cfg.cdae_compute_dtype)
    latent_mean = ivae_api.encode_det(net, x_c).float()             # (B,1,z)
    eps = _encoder_noise(model, x, cfg.train_nz_cdae, generator, latent_eps,
                         mesh, True)
    nz = cfg.train_nz_cdae // (1 if mesh is None else mesh.sp)
    with span("ardae.sample.latents"):
        latent = ivae_api.sample_latents(net, x_c, nz, eps=eps).float()
        count("ardae.sample.latents.rows", latent.shape[0] * latent.shape[1])
    lsm = cfg.std_scale * (latent - latent_mean)                    # (B,nz,z)
    if mesh is not None and mesh.sp > 1:
        n = cfg.train_nz_cdae
        mean = mesh.sample_sum(lsm.sum(dim=1, keepdim=True)) / n
        var = mesh.sample_sum(((lsm - mean) ** 2).sum(dim=1, keepdim=True)) / (n - 1)
        std_qz = torch.sqrt(var)
    else:
        std_qz = torch.std(lsm, dim=1, keepdim=True, unbiased=True)  # (B,1,z)
    sigma = cfg.delta * torch.mean(std_qz, dim=2, keepdim=True)     # (B,1,1)
    return lsm, sigma, latent_mean, net, x_c


def _phase_a_kernel(cdae, n_rows, dtype):
    """The fused DSM loss of ``cdae``'s style, or raise naming the reason:
    a bf16 phase A, or the guard that refused the cdae."""
    if compute_dtype(dtype) is not None:
        raise NotImplementedError(
            "--use-kernels with a bf16 phase A (--cdae-compute-dtype "
            "bfloat16): the JAX step never dispatches a fused DSM kernel in a "
            "bf16 phase A (ardae_tpu/train/step.py:186-192, \"the fused path "
            "is fp32-only\"; it runs XLA there), so neither does this one, "
            "and it keeps no fallback that hides a kernel: drop "
            "--use-kernels, or run phase A in fp32")
    guard, loss_fn = _KERNELS[cdae.score_type]
    if not guard(cdae, n_rows):
        raise NotImplementedError(
            f"--use-kernels: {guard.__module__}.{guard.__name__} refused this "
            f"{cdae.score_type}-style cdae ({cdae.nonlinearity}, h {cdae.h_dim}, "
            f"{n_rows} rows); the kernel covers the conditional, "
            "sigma-conditioned, enc_input CARDAE with softplus/relu/tanh in "
            "fp32 within its workspace cap")
    return loss_fn


def cdae_update(model, cdae, opt_d, cfg, x, generator, draws=None, mesh=None):
    """One PHASE-A update, in place. ``draws``: optional injected
    ``latent_eps`` (B*nz, noise; an aux model's pair), ``std`` (B, nz*nstd,
    1), ``dsm_eps`` (B*nz*nstd, z; of ``cfg.noise_type``), at the global
    batch's shapes. ``x`` is this rank's part of the batch under a
    ``mesh``. Returns the metrics (detached tensors)."""
    draws = draws or {}
    bsz = x.shape[0]
    with span("ardae.phase_a"):
        # the sampling pass, the context and the DSM noise
        with span("ardae.sample"):
            lsm, sigma, latent_mean, net, x_c = _sigma_stats(
                model, x, cfg, generator, draws.get("latent_eps"), mesh)
            if cfg.ctx_type == "lt0":
                # the std=0 encoding doubles as the context (ivae_ardae.py:735+748)
                ctx = latent_mean.reshape(bsz, -1)
            elif cfg.ctx_type == "hidden1a":
                # the std=0 features of the sigma pass's parameters and input, in
                # its dtype, then fp32 (JAX step.py:157-160)
                with span("ardae.context"):
                    ctx = compute_context(net, x_c, cfg.ctx_type).float()
            else:
                ctx = compute_context(model, x, cfg.ctx_type)
            nz, nstd, zdim = lsm.shape[1], cfg.train_nstd_cdae, lsm.shape[-1]
            # the world's items and samples an item; this rank has bsz and nz * nstd
            full, ns = bsz * (1 if mesh is None else mesh.dp), cfg.train_nz_cdae * nstd
            std = _randn((full, ns, 1), generator, x.device, draws.get("std"))
            stdmat = sigma * local(mesh, std, 0, 1)
            lsm_exp = lsm if nstd == 1 else (
                lsm[:, :, None, :].expand(bsz, nz, nstd, zdim).reshape(bsz, nz * nstd, zdim))
            eps = _local_rows(mesh, dsm_noise((full * ns, zdim), generator,
                                              draws.get("dsm_eps"), x.device,
                                              cfg.noise_type), full, ns, True)
            stats = {"std_eff_mean": sigma.mean(), "std_eff_max": sigma.max(),
                     "std_eff_min": sigma.min()}
        # the DSM loss, forward and backward
        with span("ardae.dsm"):
            if cfg.use_kernels:
                # the kernels take any of cdae_loss's noises (JAX runs XLA for a
                # non-Gaussian one, step.py:191: the same function)
                loss_fn = _phase_a_kernel(cdae, bsz * nz * nstd, cfg.cdae_compute_dtype)
                loss = loss_fn(cdae, lsm_exp, ctx, stdmat, eps=eps,
                               noise_type=cfg.noise_type)
            else:
                loss = cdae_loss(cdae, lsm_exp, ctx, stdmat, eps=eps,
                                 compute_dtype=cfg.cdae_compute_dtype,
                                 noise_type=cfg.noise_type)
            opt_d.zero_grad(set_to_none=True)
            loss.backward()
            metrics = {"cdae_loss": loss.detach(), **stats}
        if mesh is not None:
            mesh.average_grads(cdae.parameters())
        opt_d.step()
    return metrics


def _phase_b_loss(model, cdae, cfg, x, beta, eps):
    """Phase B's objective: ELBO-without-entropy plus the surrogate whose
    gradient is the injected entropy gradient. Returns (total, metrics)."""
    bsz, nz = x.shape[0], cfg.train_nz_model
    model_loss, terms = ivae_api.ivae_loss(
        model, x, nz, beta=beta, eps=eps, compute_dtype=cfg.model_compute_dtype)
    z = terms["z"]
    with torch.no_grad():
        # the detached passes in phase B's dtype, then fp32 (JAX
        # step.py:238-251)
        net = cast_module(model, cfg.model_compute_dtype)
        x_det = cast_input(x, cfg.model_compute_dtype)
        latent_mean = ivae_api.encode_det(net, x_det).float()
        ctx = (latent_mean.reshape(bsz, -1) if cfg.ctx_type == "lt0"
               else compute_context(net, x_det, cfg.ctx_type).float())
        # the score at noise level 0, a device zero: a host scalar would be
        # copied from pageable memory, which a capture refuses
        score = cdae_score(cdae, cfg.std_scale * (z - latent_mean), ctx,
                           x.new_zeros((), dtype=torch.float32))
    aux = torch.sum(score * (cfg.std_scale * (z - latent_mean)))
    # the rank's own bsz: its loss is a mean over its part, and the world's
    # average of the parts' gradients is the whole batch's
    total = model_loss + beta * aux / (bsz * nz)
    return total, {"model_loss": model_loss.detach(),
                   "recon_loss": terms["recon"].detach(),
                   "prior_loss": terms["prior"].detach()}


class PhaseBGraph:
    """Phase B's device work captured once into a CUDA graph and replayed
    each step: the encoder noise's use, ``_phase_b_loss``, the backward and
    the optimizer's ``replay_step``, on static buffers (the batch, the
    encoder noise, beta as a 0-d tensor) that ``fill`` writes before each
    replay. Kept by the model's optimizer; captured again when ``reads``
    changes: the configuration, the batch's shape and dtype, or the address
    of a tensor it reads (the model's, the cdae's, the optimizer's state,
    which ``load_state_dict`` replaces). The metrics it returns are its
    static outputs, overwritten by the next replay."""

    def __init__(self, model, cdae, opt_m, cfg, x):
        self.reads = self._reads(model, cdae, opt_m, cfg, x)
        rows = x.shape[0] * cfg.train_nz_model
        widths = ((model.noise_dim, model.z_dim) if model.family == "aux"
                  else (model.noise_dim,))
        self.x = torch.empty_like(x)
        self.eps = tuple(torch.empty((rows, w), device=x.device) for w in widths)
        self.beta = torch.zeros((), device=x.device)
        self.graph = self.metrics = None

    @staticmethod
    def _reads(model, cdae, opt_m, cfg, x):
        tensors = [*model.parameters(), *model.buffers(), *cdae.parameters(),
                   *cdae.buffers()]
        tensors += [v for st in opt_m.state.values() for v in st.values()
                    if torch.is_tensor(v)]
        # the groups' settings the capture holds (the rate is filled each step)
        settings = tuple((k, v) for g in opt_m.param_groups for k, v in g.items()
                         if k not in ("params", "lr"))
        return (opt_m.state, cfg, x.shape, x.dtype, x.device, settings,
                tuple(t.data_ptr() for t in tensors))

    def current(self, model, cdae, opt_m, cfg, x):
        """Whether the captured graph still reads what phase B would."""
        now = self._reads(model, cdae, opt_m, cfg, x)
        # the optimizer's state by identity: ``load_state_dict`` replaces it
        return now[0] is self.reads[0] and now[1:] == self.reads[1:]

    def fill(self, x, beta, generator, injected=None):
        """The step's inputs into the static buffers: the batch, the encoder
        noise (injected, or drawn as ``make_eps`` draws it, so the
        generator moves as in the eager path) and beta."""
        self.x.copy_(x)
        if injected is None:
            if generator is None:
                raise ValueError("phase B needs a generator or an injected eps")
            for buf in self.eps:
                torch.randn(buf.shape, generator=generator, out=buf)
        else:
            draws = tuple(injected) if isinstance(injected, (tuple, list)) else (injected,)
            for buf, e in zip(self.eps, draws):
                buf.copy_(e.reshape(buf.shape))
        self.beta.fill_(beta)

    def loss_backward(self, model, cdae, cfg):
        """The loss on the static buffers and its backward; the metrics."""
        injected = self.eps if model.family == "aux" else self.eps[0]
        eps = _encoder_noise(model, self.x, cfg.train_nz_model, None, injected, None, False)
        total, metrics = _phase_b_loss(model, cdae, cfg, self.x, self.beta, eps)
        total.backward()
        return metrics

    def body(self, model, cdae, opt_m, cfg):
        """The device work the graph holds (run eagerly, the same work on
        any device): fresh gradients, then the optimizer's replayed step,
        whose scalars ``opt_m.fill_replay`` set."""
        opt_m.zero_grad(set_to_none=True)
        metrics = self.loss_backward(model, cdae, cfg)
        opt_m.replay_step()
        return metrics

    def capture(self, model, cdae, opt_m, cfg):
        """Warm up on a side stream (the forward and backward once: nothing
        drawn, nothing updated, the gradients dropped), prepare the
        optimizer (its state made before capture), then capture ``body``.
        Raises where the capture fails."""
        side = torch.cuda.Stream(device=self.x.device)
        side.wait_stream(torch.cuda.current_stream(self.x.device))
        with torch.cuda.stream(side):
            opt_m.zero_grad(set_to_none=True)
            self.loss_backward(model, cdae, cfg)
        torch.cuda.current_stream(self.x.device).wait_stream(side)
        opt_m.prepare_replay()
        opt_m.zero_grad(set_to_none=True)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.metrics = self.body(model, cdae, opt_m, cfg)
        # the optimizer's state, made above, is read from here on
        self.reads = self._reads(model, cdae, opt_m, cfg, self.x)

    def run(self, model, cdae, opt_m, cfg, x, beta, generator, injected=None):
        """One phase B: fill, capture where not yet captured, replay."""
        self.fill(x, beta, generator, injected)
        if self.graph is None:
            with span("ardae.phase_b.capture"):
                self.capture(model, cdae, opt_m, cfg)
                opt_m.fill_replay()
                self.graph.replay()
        else:
            opt_m.fill_replay()
            with span("ardae.phase_b.replay"):
                self.graph.replay()
        return dict(self.metrics)


def _phase_b_graph(model, cdae, opt_m, cfg, x):
    """The model optimizer's phase-B graph, made anew where it no longer
    reads what this phase B would."""
    graph = getattr(opt_m, "phase_b_graph", None)
    if graph is None or not graph.current(model, cdae, opt_m, cfg, x):
        opt_m.phase_b_graph = None  # the old graph's pool goes first
        graph = opt_m.phase_b_graph = PhaseBGraph(model, cdae, opt_m, cfg, x)
    return graph


def model_update(model, cdae, opt_m, cfg, x, beta, generator, draws=None,
                 mesh=None):
    """PHASE B, in place: ELBO-without-entropy + injected entropy gradient.
    ``draws``: optional injected ``eps`` (B*nz, noise_dim; an aux model's
    pair), at the global batch's shape. A replayed CUDA graph where it
    engages (the module's docstring), else eager."""
    draws = draws or {}
    with span("ardae.phase_b"):
        if mesh is None and x.is_cuda and isinstance(opt_m, Replayable):
            graph = _phase_b_graph(model, cdae, opt_m, cfg, x)
            return graph.run(model, cdae, opt_m, cfg, x, beta, generator, draws.get("eps"))
        eps = _encoder_noise(model, x, cfg.train_nz_model, generator, draws.get("eps"),
                             mesh, False)
        total, metrics = _phase_b_loss(model, cdae, cfg, x, beta, eps)
        opt_m.zero_grad(set_to_none=True)
        total.backward()
        if mesh is not None:
            mesh.average_grads(model.parameters())
        opt_m.step()
        return metrics


def one_step(state, cfg, cdae_batches, model_batch, beta, generator, draws=None,
             mesh=None):
    """One joint step on (U, B, D) phase-A batches and a (B, D) phase-B batch
    (this rank's items under a ``mesh``). ``draws``: optional {"cdae":
    [per-update draws], "model": draws}. Returns this rank's metrics
    (``train_chunk`` reduces a chunk's last over the world)."""
    draws = draws or {}
    metrics = {}
    for i in range(cfg.num_cdae_updates):
        cd = draws.get("cdae")
        metrics.update(cdae_update(state.model, state.cdae, state.opt_cdae, cfg,
                                   cdae_batches[i], generator,
                                   cd[i] if cd else None, mesh))
    metrics.update(model_update(state.model, state.cdae, state.opt_model, cfg,
                                model_batch, beta, generator, draws.get("model"),
                                mesh))
    state.step += 1
    update_weight_avg(state, cfg)
    return metrics


@torch.no_grad()
def update_weight_avg(state, cfg):
    """The averaged model after a step (JAX: ``_update_weight_avg``,
    reference ivae_ardae.py:559-565 via torchcontrib), in place, a few
    ``torch._foreach_*`` passes over every parameter at once. Averaging has
    started once the step just counted reaches ``cfg.weight_avg_start``;
    before that the average is the live model. Polyak: avg = d * avg + (1 -
    d) * p, in JAX's order of operations; SWA: the running mean avg += (p -
    avg) / count over the iterates since the start. No-op without an
    averaging slot."""
    if cfg.weight_avg == "none" or state.avg_model is None:
        return
    avg = list(state.avg_model.parameters())
    live = [p.detach() for p in state.model.parameters()]
    if state.step < cfg.weight_avg_start:
        torch._foreach_copy_(avg, live)
        return
    state.avg_count += 1
    if cfg.weight_avg == "polyak":
        d = cfg.weight_avg_decay
        part = torch._foreach_mul(live, 1.0 - d)
        torch._foreach_mul_(avg, d)
        torch._foreach_add_(avg, part)
    elif cfg.weight_avg == "swa":
        diff = torch._foreach_sub(live, avg)
        torch._foreach_div_(diff, float(state.avg_count))
        torch._foreach_add_(avg, diff)
    else:
        raise ValueError(f"unknown weight averaging {cfg.weight_avg!r}")


def train_chunk(state, cfg, data, cdae_idx, model_idx, generator, beta_fn,
                binarize=False, draws=None, mesh=None):
    """K joint steps: the Python-loop counterpart of the JAX lax.scan chunk.

    data: (N, D) on the device; cdae_idx (K, U, B) and model_idx (K, B)
    integer indices of the global batch (a ``mesh`` rank gathers its items
    only). ``draws``: optional per-step list of {"bin_cdae": (U, B, D) and
    "bin_model": (B, D) uniforms, "step": one_step's draws}. Returns the
    last step's metrics, reduced over the world under a mesh (two
    collectives a chunk)."""
    metrics = None
    for k in range(len(model_idx)):
        d = draws[k] if draws else {}
        with span("ardae.step", step=state.step):
            # the step's indices, host to device: the copy waits for the stream
            with span("ardae.upload"):
                c_idx = torch.as_tensor(cdae_idx[k], device=data.device)
                m_idx = torch.as_tensor(model_idx[k], device=data.device)
            with span("ardae.gather"):
                cdae_batches = gather_batches(data, c_idx, binarize, generator,
                                              d.get("bin_cdae"), mesh, items_axis=1)
                model_batch = gather_batches(data, m_idx, binarize, generator,
                                             d.get("bin_model"), mesh)
            metrics = one_step(state, cfg, cdae_batches, model_batch,
                               beta_fn(state.step), generator, d.get("step"), mesh)
    return metrics if mesh is None or metrics is None else mesh.reduce_metrics(metrics)
