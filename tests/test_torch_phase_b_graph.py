"""Phase B as one CUDA graph (``train/step.py`` ``PhaseBGraph``).

On the CPU: the function the graph captures, run uncaptured on its static
buffers (``fill``, the warm-up pass, ``prepare_replay``, then ``fill_replay``
and ``body`` each step), against the eager ``model_update`` over three
steps, for a flat resconvct model (lt0 context, res cdae) and an aux model
(hidden1a context, the ``eps0`` / ``eps`` pair, grad cdae), with the encoder
noise injected and drawn: metrics, gradients, parameters and the
generator's state. The re-capture rule, and the eager path on the CPU.

On the card (marked ``cuda``; each skips without a GPU): the graph against
the eager path (a mesh of one, which keeps phase B eager) step by step,
one capture and four replays by the ``ardae.phase_b.*`` spans, a re-capture
after the optimizer's ``load_state_dict``, and the eager path under a mesh
and under ``torch.optim.SGD``. This file imports torch, pytest and the port
only, so it collects on a machine without the JAX package's
dependencies:

    python -m pytest tests/test_torch_phase_b_graph.py -m cuda -q
"""

import copy

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ardae_tpu_torch.models.registry import build_cdae, build_ivae_model, context_dim_for
from ardae_tpu_torch.train.optim import build_optimizer
from ardae_tpu_torch.train.step import PhaseBGraph, StepConfig, model_update
from ardae_tpu_torch.utils import tracing

torch.set_num_threads(2)

BS, NZ, Z, NOISE, H, D = 4, 2, 4, 6, 16, 784
LINES = {"resconvct": ("resconvct-res", "lt0", "mlp-res"),
         "aux": ("auxmnist", "hidden1a", "mlp-grad")}
BETAS = (1.0, 0.7, 0.3, 0.5, 0.9, 1.0)


def _line(kind, device):
    name, ctx, cdae_name = LINES[kind]
    model = build_ivae_model(name, nchannels=1, nheight=28, z_dim=Z, h_dim=H, n_dim=NOISE,
                             n_layers=1, nonlin="relu", seed=0, device=device)
    cdae = build_cdae(cdae_name, input_dim=Z, h_dim=H, n_layers=2, nonlin="softplus",
                      context_dim=context_dim_for(ctx, model_name=name, nchannels=1,
                                                  nheight=28, z_dim=Z, h_dim=H),
                      seed=1, device=device)
    cfg = StepConfig(std_scale=100.0, delta=0.1, train_nz_model=NZ, ctx_type=ctx)
    return model, cdae, cfg


def _inputs(kind, steps, device, injected):
    """Binarized batches, and the encoder noise of each step where
    ``injected`` (an aux model's pair), else None."""
    g = torch.Generator().manual_seed(3)
    xs = [(torch.rand(BS, D, generator=g) > 0.5).float().to(device) for _ in range(steps)]
    widths = (NOISE, Z) if kind == "aux" else (NOISE,)
    eps = [tuple(torch.randn(BS * NZ, w, generator=g).to(device) for w in widths)
           for _ in range(steps)]
    eps = [e if kind == "aux" else e[0] for e in eps]
    return xs, eps if injected else [None] * steps


def _grads(model):
    return {k: p.grad.clone() for k, p in model.named_parameters()}


def _close(a, b, rtol, msg):
    scale = float(b.detach().abs().max()) + 1e-30
    assert float((a - b).detach().abs().max()) <= rtol * scale, msg


@pytest.mark.parametrize("injected", [True, False], ids=["injected", "drawn"])
@pytest.mark.parametrize("kind", list(LINES))
def test_static_path_matches_eager(kind, injected):
    """The captured function, uncaptured, against the eager phase B, step by
    step: the same metrics (1e-6 of their size), the first gradients bit
    for bit and the generator's state. The replayed Adam rounds its last
    add once more than ``addcdiv_`` (an ulp of a parameter near 1, 1.2e-4
    of a 1e-3 move), which the next steps' gradients carry: later
    gradients within 1e-4 of their leaf's largest (5.8e-6 seen), each
    leaf's change within 2e-2 of its largest move (5e-3 seen) and the
    whole change's norm within 1e-4 (1.5e-5 seen)."""
    model, cdae, cfg = _line(kind, "cpu")
    xs, eps = _inputs(kind, 3, "cpu", injected)
    m_s, c_s = copy.deepcopy(model), copy.deepcopy(cdae)
    p0 = [p.detach().clone() for p in model.parameters()]
    opt_e = build_optimizer("adam", model.parameters(), 1e-3, beta1=0.5)
    opt_s = build_optimizer("adam", m_s.parameters(), 1e-3, beta1=0.5)
    gen_e, gen_s = (torch.Generator().manual_seed(7) for _ in range(2))
    graph = PhaseBGraph(m_s, c_s, opt_s, cfg, xs[0])
    for k in range(3):
        draws = None if eps[k] is None else {"eps": eps[k]}
        want = model_update(model, cdae, opt_e, cfg, xs[k], BETAS[k], gen_e, draws)
        graph.fill(xs[k], BETAS[k], gen_s, eps[k])
        if k == 0:  # capture's warm-up and the optimizer's preparation
            opt_s.zero_grad(set_to_none=True)
            graph.loss_backward(m_s, c_s, cfg)
            opt_s.prepare_replay()
        opt_s.fill_replay()
        got = graph.body(m_s, c_s, opt_s, cfg)
        assert set(got) == set(want)
        for name in want:
            _close(got[name], want[name], 1e-6, f"step {k} {name}")
        ge, gs = _grads(model), _grads(m_s)
        for name in ge:
            _close(gs[name], ge[name], 0.0 if k == 0 else 1e-4, f"step {k} grad {name}")
        assert torch.equal(gen_s.get_state(), gen_e.get_state()), k
    err = ref = 0.0
    for (name, p), q, a in zip(model.named_parameters(), m_s.parameters(), p0):
        _close(q - a, p - a, 2e-2, f"param {name}")
        err += float(((q - p) ** 2).sum())
        ref += float(((p - a) ** 2).sum())
        assert opt_s.state[q]["count"] == opt_e.state[p]["count"] == 3
        _close(opt_s.state[q]["nu"], opt_e.state[p]["nu"], 1e-4, f"nu {name}")
    assert err ** 0.5 <= 1e-4 * ref ** 0.5


def test_recapture_rule():
    """The graph still reads what phase B would until the batch's shape,
    the configuration, the optimizer's state (``load_state_dict``) or a
    parameter's address changes."""
    model, cdae, cfg = _line("resconvct", "cpu")
    opt = build_optimizer("adam", model.parameters(), 1e-3, beta1=0.5)
    xs, _ = _inputs("resconvct", 1, "cpu", False)
    model_update(model, cdae, opt, cfg, xs[0], 1.0, torch.Generator().manual_seed(0))
    graph = PhaseBGraph(model, cdae, opt, cfg, xs[0])
    assert graph.current(model, cdae, opt, cfg, xs[0])
    assert graph.current(model, cdae, opt, cfg, xs[0].clone())
    assert not graph.current(model, cdae, opt, cfg, xs[0][:2])
    assert not graph.current(model, cdae, opt, StepConfig(**{**cfg.__dict__, "std_scale": 1.0}),
                             xs[0])
    opt.load_state_dict(opt.state_dict())
    assert not graph.current(model, cdae, opt, cfg, xs[0])
    graph = PhaseBGraph(model, cdae, opt, cfg, xs[0])
    model.load_state_dict(copy.deepcopy(model.state_dict()))  # copied in place
    assert graph.current(model, cdae, opt, cfg, xs[0])
    leaf = next(cdae.parameters())
    leaf.data = leaf.data.clone()
    assert not graph.current(model, cdae, opt, cfg, xs[0])


def _phase_b_spans(run):
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        out = run()
    names = [r.name for r in tracing.recorded()]
    return out, {n: names.count(n) for n in set(names)}


def test_eager_on_the_cpu():
    """On the CPU phase B runs eagerly: no graph kept, no capture or replay
    span."""
    model, cdae, cfg = _line("resconvct", "cpu")
    opt = build_optimizer("adam", model.parameters(), 1e-3, beta1=0.5)
    xs, _ = _inputs("resconvct", 2, "cpu", False)
    gen = torch.Generator().manual_seed(0)
    _, counts = _phase_b_spans(lambda: [model_update(model, cdae, opt, cfg, x, 1.0, gen)
                                        for x in xs])
    assert counts == {"ardae.phase_b": 2}
    assert getattr(opt, "phase_b_graph", None) is None


class _MeshOfOne:
    """A mesh of one rank: phase B's eager path under a mesh."""
    dp = sp = 1

    @staticmethod
    def local(t, items_axis=0, samples_axis=None):
        return t

    @staticmethod
    def average_grads(params):
        pass


@pytest.fixture
def cuda():
    """The card with TF32 off (restored after)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    b = torch.backends
    saved = (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32)
    b.cuda.matmul.allow_tf32 = b.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32 = saved


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(LINES))
def test_graph_matches_eager_on_cuda(cuda, kind):
    """Five phase Bs through the graph (one capture, four replays), each
    against an eager one (a mesh of one) from a copy of the same state,
    generator and batch; then the optimizer reloads its state, and the
    sixth is captured anew and agrees as well. Each step: the losses within
    1e-6, each gradient within 1e-4 of its leaf's largest and the change's
    norm within 1e-3 of the step's move (seen on the card: 0, 2.6e-6 and
    6.1e-5, the last from the replayed Adam's rounding). The steps are
    compared one at a time: at these widths the loop is chaotic, and
    cuDNN's default algorithms do not repeat a convolution's gradient bit
    for bit, so over several steps an eager run parts from its own repeat
    as far as from the graph (2e-5 to 7e-3 of the move over six steps)."""
    model, cdae, cfg = _line(kind, cuda)
    xs, _ = _inputs(kind, 6, cuda, False)
    opt = build_optimizer("adam", model.parameters(), 1e-3, beta1=0.5)
    gen = torch.Generator(device=cuda).manual_seed(7)

    def step(k):
        m_e, c_e = copy.deepcopy(model), copy.deepcopy(cdae)
        opt_e = build_optimizer("adam", m_e.parameters(), 1e-3, beta1=0.5)
        opt_e.load_state_dict(copy.deepcopy(opt.state_dict()))
        gen_e = torch.Generator(device=cuda)
        gen_e.set_state(gen.get_state())
        before = [p.detach().clone() for p in model.parameters()]
        got = model_update(model, cdae, opt, cfg, xs[k], BETAS[k], gen)
        want = model_update(m_e, c_e, opt_e, cfg, xs[k], BETAS[k], gen_e, mesh=_MeshOfOne())
        assert getattr(opt_e, "phase_b_graph", None) is None
        for n in want:
            assert abs(float(got[n]) - float(want[n])) <= 1e-6 * abs(float(want[n])), (k, n)
        assert torch.equal(gen.get_state(), gen_e.get_state()), k
        err = ref = 0.0
        for p, q, a in zip(model.parameters(), m_e.parameters(), before):
            _close(p.grad, q.grad, 1e-4, f"step {k} grad")
            err += float(((p - q).detach() ** 2).sum())
            ref += float(((q - a).detach() ** 2).sum())
            assert opt.state[p]["count"] == opt_e.state[q]["count"] == k + 1
        assert err ** 0.5 <= 1e-3 * ref ** 0.5, (k, err ** 0.5, ref ** 0.5)

    _, counts = _phase_b_spans(lambda: [step(k) for k in range(5)])
    assert counts == {"ardae.phase_b": 10, "ardae.phase_b.capture": 1,
                      "ardae.phase_b.replay": 4}, counts
    graph = opt.phase_b_graph
    opt.load_state_dict(copy.deepcopy(opt.state_dict()))
    _, counts = _phase_b_spans(lambda: step(5))
    assert counts == {"ardae.phase_b": 2, "ardae.phase_b.capture": 1}, counts
    assert opt.phase_b_graph is not graph


@pytest.mark.cuda
def test_sgd_stays_eager_on_cuda(cuda):
    """torch.optim.SGD, which has no replayed step: phase B runs eagerly."""
    model, cdae, cfg = _line("resconvct", cuda)
    opt = build_optimizer("sgd", model.parameters(), 1e-3)
    xs, _ = _inputs("resconvct", 2, cuda, False)
    gen = torch.Generator(device=cuda).manual_seed(0)
    _, counts = _phase_b_spans(lambda: [model_update(model, cdae, opt, cfg, x, 1.0, gen)
                                        for x in xs])
    assert counts == {"ardae.phase_b": 2}
    assert getattr(opt, "phase_b_graph", None) is None
