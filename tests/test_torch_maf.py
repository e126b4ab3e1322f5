"""toy-maf on the port against the JAX package: the conditional MADE
(ardae_tpu_torch/nn/made.py) and the ToyMAFVAE (models/vae/maf.py) with
flax params converted, the flow heads drawn away from their zero init so
that the flow is not the identity; the VAE API's flow branches (vae_loss,
logprob_iwae, reconstruct) with every draw made by jax.random and
injected; the MADE's autoregressive law; the flow's inverse; and one
cli.vae --model toy-maf run on the CPU.

Tolerances: outputs rel 1e-5; losses and bounds rel 1e-5."""

import os

import jax
import numpy as np
import torch

from ardae_tpu.models.vae import api as japi
from ardae_tpu.models.vae.maf import ToyMAFVAE as JMaf
from ardae_tpu.nn.made import ConditionalMADE as JMade
from ardae_tpu_torch.convert import flax_to_state_dict
from ardae_tpu_torch.models.registry import build_vae_model
from ardae_tpu_torch.models.vae import api as tapi
from ardae_tpu_torch.models.vae.maf import ToyMAFVAE
from ardae_tpu_torch.nn.made import ConditionalMADE
from torch_parity import check_init_law, check_round_trip, close, loaded, rand, t

Z, H, BS, SSZ = 3, 16, 5, 7
RTOL, ATOL = 1e-5, 1e-6


def _heads_drawn(params, seed, scale=0.3):
    """``params`` with every zero-initialised MADE head drawn from
    N(0, scale^2): the identity flow would hide the MADE's law."""
    rng = np.random.default_rng(seed)

    def visit(tree):
        return {k: (visit(v) if hasattr(v, "items") else
                    (scale * rng.normal(size=np.shape(v))).astype(np.float32)
                    if k in ("w_m", "b_m", "w_a", "b_a") else np.asarray(v))
                for k, v in tree.items()}

    return visit(params)


def _maf():
    """(flax ToyMAFVAE, its params with drawn heads, the port's model)."""
    jm = JMaf(input_dim=2, h_dim=H, z_dim=Z, num_hidden_layers=2)
    p = _heads_drawn(jm.init(jax.random.PRNGKey(4), rand(1, BS, 2)), 9)
    tm = loaded(ToyMAFVAE(input_dim=2, h_dim=H, z_dim=Z, num_hidden_layers=2), p)
    return jm, p, tm


def test_made_matches_jax_and_is_autoregressive():
    jm = JMade(input_dim=Z, hidden_dim=H)
    z, ctx = rand(2, BS, Z), rand(3, BS, 6)
    p = _heads_drawn(jm.init(jax.random.PRNGKey(1), z, ctx), 5)
    tm = loaded(ConditionalMADE(Z, 6, H), p)
    wm, wa = jm.apply(p, z, ctx)
    m, a = tm(t(z), t(ctx))
    close(m, wm, RTOL, ATOL)
    close(a, wa, RTOL, ATOL)
    # d(m_i, a_i) / d z_j = 0 for j >= i: strictly lower triangular
    for out in (0, 1):
        jac = torch.autograd.functional.jacobian(
            lambda zz: tm(zz[None], t(ctx[:1]))[out][0], t(z[0]))
        assert bool((jac.triu() == 0).all())
        assert bool((jac.tril(-1) != 0).any())


def test_made_init_law():
    """The port's own init against a JAX init of the same widths: the heads
    zero, the rest U(+-1/sqrt(fan in)) (the hidden bias over d + c)."""
    tm = ConditionalMADE(Z, 64, 256)
    from ardae_tpu_torch.nn.initializers import init_module

    init_module(tm, torch.Generator().manual_seed(0))
    jm = JMade(input_dim=Z, hidden_dim=256)
    want = flax_to_state_dict(
        jm.init(jax.random.PRNGKey(0), rand(0, 1, Z), rand(1, 1, 64)), tm)
    check_init_law(tm.state_dict(), want)


def test_flow_inverse_then_forward_is_the_identity():
    _, _, tm = _maf()
    z0, ctx = t(rand(6, 50, Z)), t(rand(7, 50, H))
    with torch.no_grad():
        z, sum_a = tm.flow_inverse(z0, ctx)
        back, sum_a2 = tm.flow_forward(z, ctx)
    assert float((z - z0).abs().max()) > 1e-2   # the flow is not the identity
    close(back, z0, 1e-5, 1e-5)
    close(sum_a2, sum_a, 1e-5, 1e-5)


def test_flow_matches_jax():
    jm, p, tm = _maf()
    z0, ctx = rand(6, BS, Z), rand(7, BS, H)
    for method in ("flow_inverse", "flow_forward"):
        wz, wa = jm.apply(p, z0, ctx, method=getattr(jm, method))
        with torch.no_grad():
            gz, ga = getattr(tm, method)(t(z0), t(ctx))
        close(gz, wz, RTOL, ATOL)
        close(ga, wa, RTOL, ATOL)


def test_vae_loss_matches_jax():
    jm, p, tm = _maf()
    x, key = rand(8, BS, 2, scale=3.0), jax.random.PRNGKey(11)
    want, wterms = japi.vae_loss(jm, p, key, x, beta=0.7, reduce="per_item")
    eps = np.asarray(jax.random.normal(key, (BS, Z)))
    with torch.no_grad():
        got, terms = tapi.vae_loss(tm, t(x), beta=0.7, reduce="per_item", eps=t(eps))
    close(got, want, RTOL, ATOL)
    for k in ("recon", "kld", "z"):
        close(terms[k], wterms[k], RTOL, ATOL)


def test_vae_loss_gradients_match_jax():
    jm, p, tm = _maf()
    x, key = rand(8, BS, 2, scale=3.0), jax.random.PRNGKey(12)
    grads = jax.grad(lambda q: japi.vae_loss(jm, q, key, x)[0])(p)
    eps = np.asarray(jax.random.normal(key, (BS, Z)))
    tapi.vae_loss(tm, t(x), eps=t(eps))[0].backward()
    want = flax_to_state_dict(grads, tm)
    for name, param in tm.named_parameters():
        g, w = param.grad, want[name]
        assert float((g - w).norm()) <= 1e-4 * float(w.norm()) + 1e-7, name


def test_logprob_iwae_matches_jax():
    jm, p, tm = _maf()
    x, key = rand(9, BS, 2, scale=3.0), jax.random.PRNGKey(13)
    want = japi.logprob_iwae(jm, p, key, x, SSZ, reduce="per_item")
    eps = np.asarray(jax.random.normal(key, (BS, SSZ, Z)))
    with torch.no_grad():
        got = tapi.logprob_iwae(tm, t(x), SSZ, reduce="per_item", eps=t(eps))
    close(got, want, RTOL, 1e-5)


def test_reconstruct_matches_jax():
    jm, p, tm = _maf()
    x, key = rand(10, BS, 2, scale=3.0), jax.random.PRNGKey(14)
    want = japi.reconstruct(jm, p, key, x)
    k_enc, k_dec = jax.random.split(key)
    eps = np.asarray(jax.random.normal(k_enc, (BS, Z)))
    u = np.asarray(jax.random.normal(k_dec, (BS, 2)))
    with torch.no_grad():
        got = tapi.reconstruct(tm, t(x), eps=t(eps), u=t(u))
    for g, w in zip(got, want):
        close(g, w, RTOL, 1e-5)


def test_convert_round_trip_and_registry():
    _, p, tm = _maf()
    check_round_trip({"params": p["params"]}, tm)
    model = build_vae_model("toy-maf", nchannels=2, nheight=1, z_dim=2, h_dim=H,
                            n_layers=2, device="cpu")
    assert isinstance(model, ToyMAFVAE) and model.family == "flow_posterior"
    assert sorted(n for n, _ in model.named_children()) == [
        "dec_main", "dec_reparam", "enc_main", "enc_reparam", "flow0", "flow1"]
    # a fresh model's flow is the identity: zero heads
    assert all(not getattr(model, f"flow{b}").w_a.detach().any() for b in (0, 1))


def test_toy_maf_cli_run(tmp_path):
    """cli.vae --model toy-maf on 2,000 25-gaussians points with Polyak
    averaging, the panels every 2 steps, a val IWAE eval and the toy final
    dump."""
    from ardae_tpu_torch.cli import vae

    state, path = vae.run([
        "--dataset", "25gaussians", "--nheight", "1", "--nchannels", "2",
        "--toy-train-size", "2000", "--model", "toy-maf", "--model-z-dim", "2",
        "--model-h-dim", "16", "--model-n-layers", "2", "--train-batch-size", "8",
        "--iws-samples", "8", "--max-iters", "4", "--log-interval", "2",
        "--eval-iws-interval", "4", "--vis-interval", "2", "--ckpt-interval", "0",
        "--weight-avg", "polyak", "--weight-avg-start", "2", "--no-resume",
        "--no-cuda", "--cache", str(tmp_path / "exp"),
        "--data-root", str(tmp_path / "data")])
    assert state.step == 4 and state.avg_count == 3
    with open(os.path.join(path, "log.txt")) as f:
        log = f.read()
    assert log.count("| vis ") == 3 and "| rows 2000 | non-finite 0" in log
    assert "logprob (iws)" in log
