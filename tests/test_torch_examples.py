"""The notebook workloads of the port (ardae_tpu_torch/examples/) and what
they alone need, against their JAX twins at small widths: the energy
functions; dae_score / dae_loss for the six unconditional and fixed-sigma
constructors (cdae_score / cdae_loss too for the two conditional ones); one
iteration of each example's loop against the same iteration composed from
JAX's pieces (dae_loss, dae_score, torch_adam under step_lr, torch_rmsprop,
energy_func4, annealing_func); the quiver grid, the quiver panel and the
PNG writer; each example's main() on the CPU, and its refusal without a
card. Flax params cross through convert.py; every draw is made by
jax.random and injected. Tolerances: values and losses rel 1e-5 (atol 1e-6
near 0), gradients and parameter updates rel-norm 1e-4.

The learning criteria of tests/test_examples.py are held on the card, by
chip_smoke.py's phase 9a, not here.
"""

import struct
import zlib

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ardae_tpu.core import annealing as jann
from ardae_tpu.core import energy as jenergy
from ardae_tpu.models.cdae import cardae as jcd
from ardae_tpu.nn.mlp import MLP as JMLP
from ardae_tpu.train import optim as jopt
from ardae_tpu.utils import visualization as jvis
from ardae_tpu_torch.convert import flax_to_state_dict
from ardae_tpu_torch.core import annealing as tann
from ardae_tpu_torch.core import energy as tenergy
from ardae_tpu_torch.examples import ardae_fit, ardae_toy, dae_toy
from ardae_tpu_torch.models.cdae import cardae as tcd
from ardae_tpu_torch.train import optim as topt
from ardae_tpu_torch.utils import visualization as tvis
from torch_parity import check_round_trip, close, loaded, rand, t

ENERGIES = ("energy_func1", "energy_func2", "energy_func3", "energy_func4",
            "regularization_func", "normal_prob")


@pytest.mark.parametrize("name", ENERGIES)
def test_energy(name):
    """Points spread over [-8, 8]^2, so the box penalty (|x| > 6) is on for
    some."""
    x = rand(1, 64, 2, scale=4.0)
    want = getattr(jenergy, name)(jnp.asarray(x))
    got = getattr(tenergy, name)(t(x))
    assert tuple(got.shape) == tuple(want.shape)
    close(got, want, 1e-5, 1e-6)


# name: (JAX constructor, port constructor, conditional)
CTORS = {name: (getattr(jcd, name), getattr(tcd, name), name.endswith("CDAE"))
         for name in ("MLPResCDAE", "MLPGradCDAE", "MLPResARDAE", "MLPGradARDAE",
                      "MLPResDAE", "MLPGradDAE")}
D, CTX, N = 3, 4, 12


def _build(name, seed=0):
    jctor, tctor, cond = CTORS[name]
    widths = dict(h_dim=10, num_hidden_layers=2, nonlinearity="softplus")
    if cond:
        jm, tm = jctor(D, CTX, **widths), tctor(D, CTX, **widths)
        ctx = np.zeros((1, CTX), np.float32)
    else:
        jm, tm = jctor(D, **widths), tctor(D, **widths)
        ctx = None
    p = jm.init(jax.random.PRNGKey(seed), np.zeros((1, D), np.float32), ctx,
                np.zeros((1, 1), np.float32))
    return jm, p, loaded(tm, p)


def _rel_norm(a, b):
    return float((a - b).norm()) / max(float(b.norm()), 1e-30)


def _check_grads(tm, jgrads):
    want = flax_to_state_dict(jgrads, tm)
    for k, prm in tm.named_parameters():
        if prm.grad is None:   # the energy head's bias does not reach the score
            assert not want[k].any(), k
        else:
            assert _rel_norm(prm.grad, want[k]) <= 1e-4, k


@pytest.mark.parametrize("name", list(CTORS))
def test_dae_score_and_loss(name):
    """The converter's round trip (the unconditional trunks have no
    *_l0_ctx); dae_score at a scalar and a per-row sigma; dae_loss at a
    per-row sigma (of both signs, as the ARDAE draws it), the JAX eps
    injected, with every parameter gradient. A fixed-sigma net reads sigma
    in the loss only."""
    jm, p, tm = _build(name)
    check_round_trip(p, tm)
    x, std = rand(2, N, D), rand(3, N, 1)
    for s in (0.7, std):
        want = jcd.dae_score(jm, p, x, s)
        got = tcd.dae_score(tm, t(x), s if np.isscalar(s) else t(s))
        close(got, want, 1e-5, 1e-6)
    key = jax.random.PRNGKey(4)
    want, jgrads = jax.value_and_grad(lambda q: jcd.dae_loss(jm, q, key, x, std))(p)
    tm.zero_grad(set_to_none=True)
    got = tcd.dae_loss(tm, t(x), t(std), eps=t(jax.random.normal(key, x.shape)))
    got.backward()
    close(got, want, 1e-5, 0.0)
    _check_grads(tm, jgrads)
    if CTORS[name][2]:
        # the conditional API of the fixed-sigma CDAEs: (bsz, ssz, d) latents
        lat, ctx, sd = rand(5, 3, 4, D), rand(6, 3, CTX), rand(7, 3, 4, 1)
        close(tcd.cdae_score(tm, t(lat), t(ctx), t(sd)),
              jcd.cdae_score(jm, p, lat, ctx, sd), 1e-5, 1e-6)
        want, jgrads = jax.value_and_grad(
            lambda q: jcd.cdae_loss(jm, q, key, lat, ctx, sd))(p)
        tm.zero_grad(set_to_none=True)
        got = tcd.cdae_loss(tm, t(lat), t(ctx), t(sd),
                            eps=t(jax.random.normal(key, (12, D))))
        got.backward()
        close(got, want, 1e-5, 0.0)
        _check_grads(tm, jgrads)


def test_dae_loss_takes_gaussian_noise_only():
    _, _, tm = _build("MLPResARDAE")
    with pytest.raises(NotImplementedError, match="Not ported"):
        tcd.dae_loss(tm, torch.zeros(2, D), 0.1, eps=torch.zeros(2, D),
                     noise_type="laplace")


def _updates(before, module, jparams_after, jparams_before):
    """The port's parameter update against JAX's, tensor by tensor."""
    want_after = flax_to_state_dict(jparams_after, module)
    want_before = flax_to_state_dict(jparams_before, module)
    for k, prm in module.named_parameters():
        assert _rel_norm(prm.detach() - before[k],
                         want_after[k] - want_before[k]) <= 1e-4, k


def _snapshot(module):
    return {k: v.detach().clone() for k, v in module.named_parameters()}


def _apply(params, updates):
    return jax.tree.map(lambda a, u: a + u, params, updates)


BS, NS = 8, 3


@pytest.mark.parametrize("example", ["dae_toy", "ardae_toy"])
@pytest.mark.parametrize("score_type", ["grad", "res"])
def test_toy_iteration(example, score_type):
    """One iteration of the swiss-roll loop: the JAX twin's swiss-roll draw,
    sigma (annealed at step 0, or delta N(0, 1) a row) and DSM eps
    injected; torch Adam (b1 0.9) after the JAX twin's torch_adam."""
    jctor = {("dae_toy", "grad"): jcd.MLPGradDAE, ("dae_toy", "res"): jcd.MLPResDAE,
             ("ardae_toy", "grad"): jcd.MLPGradARDAE,
             ("ardae_toy", "res"): jcd.MLPResARDAE}[example, score_type]
    tctor = getattr(tcd, jctor.__name__)
    jm = jctor(input_dim=2, h_dim=16, num_hidden_layers=3, nonlinearity="softplus")
    p = jm.init(jax.random.PRNGKey(0), np.zeros((4, 2), np.float32), None,
                np.zeros((4, 1), np.float32))
    tm = loaded(tctor(2, h_dim=16, num_hidden_layers=3, nonlinearity="softplus"), p)
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(1), 3)
    from examples.dae_toy import swissroll_sampler as jsampler

    x = jsampler(k1, BS)
    if example == "dae_toy":
        perc = min(1 / 4000.0, 1.0)
        sigma = 5.0 * (1 - perc) + 0.05 * perc
        jsig, tsig = sigma, sigma
    else:
        jsig = 1.0 * jax.random.normal(k2, (BS * NS, 1))
        tsig = t(jsig)
    xr = jnp.broadcast_to(x[:, None, :], (BS, NS, 2)).reshape(BS * NS, 2)
    tx = jopt.torch_adam(0.005, b1=0.9)
    loss, grads = jax.value_and_grad(lambda q: jcd.dae_loss(jm, q, k3, xr, jsig))(p)
    upd, _ = tx.update(grads, tx.init(p), p)
    before = _snapshot(tm)
    opt = topt.torch_adam(tm.parameters(), 0.005, b1=0.9)
    got = dae_toy.dsm_step(tm, opt, t(x), tsig, NS,
                           eps=t(jax.random.normal(k3, xr.shape)))
    close(got, loss, 1e-5, 0.0)
    _updates(before, tm, _apply(p, upd), p)


class _JGen(fnn.Module):
    """ardae_fit's generator, as the JAX twin's notebook cell 4."""

    hidden_dim: int

    @fnn.compact
    def __call__(self, z):
        return JMLP(hidden_dim=self.hidden_dim, output_dim=2, nonlinearity="relu",
                    num_hidden_layers=3, name="main")(z)


def test_fit_iteration():
    """One ardae_fit iteration at step 3 (alpha annealed over 10 steps):
    two DSM updates of the res-ARDAE (RMSprop, momentum 0.5) on generator
    samples, then the generator step on alpha E[energy_func4] +
    sum(stopgrad(score(x, 0)) x) / bs (Adam b1 0.5 under step_lr(lr, 5000,
    0.5)); every draw injected."""
    z_dim, h, lr, delta, i_ep = 4, 16, 1e-3, 0.1, 3
    gen_j, dae_j = _JGen(h), jcd.MLPResARDAE(input_dim=2, h_dim=h, num_hidden_layers=3,
                                             nonlinearity="softplus")
    pg = gen_j.init(jax.random.PRNGKey(0), np.zeros((4, z_dim), np.float32))
    pd = dae_j.init(jax.random.PRNGKey(1), np.zeros((4, 2), np.float32), None,
                    np.zeros((4, 1), np.float32))
    gen_t = loaded(ardae_fit.Generator(z_dim, h), pg)
    dae_t = loaded(tcd.MLPResARDAE(2, h_dim=h, num_hidden_layers=3,
                                   nonlinearity="softplus"), pd)
    tx_g = jopt.torch_adam(jopt.step_lr(lr, 5000, 0.5, min_lr=1e-10), b1=0.5)
    tx_d = jopt.torch_rmsprop(lr, momentum=0.5)
    og, od = tx_g.init(pg), tx_d.init(pd)
    opt_g = topt.torch_adam(gen_t.parameters(), topt.step_lr(lr, 5000, 0.5, min_lr=1e-10),
                            b1=0.5)
    opt_d = topt.torch_rmsprop(dae_t.parameters(), lr, momentum=0.5)
    before_g, before_d = _snapshot(gen_t), _snapshot(dae_t)
    cpu = torch.Generator()
    keys = jax.random.split(jax.random.PRNGKey(2), 7)
    pd0 = pd
    for u in range(2):
        z = jax.random.normal(keys[3 * u], (BS, z_dim))
        s = jax.random.normal(keys[3 * u + 1], (BS * NS, 1))
        x = jax.lax.stop_gradient(gen_j.apply(pg, z))
        xr = jnp.broadcast_to(x[:, None, :], (BS, NS, 2)).reshape(-1, 2)
        loss, grads = jax.value_and_grad(
            lambda q: jcd.dae_loss(dae_j, q, keys[3 * u + 2], xr, delta * s))(pd)
        upd, od = tx_d.update(grads, od, pd)
        pd = _apply(pd, upd)
        got = ardae_fit.dae_update(
            gen_t, dae_t, opt_d, BS, z_dim, NS, delta, cpu,
            draws=(t(z), t(s), t(jax.random.normal(keys[3 * u + 2], xr.shape))))
        close(got, loss, 1e-5, 0.0)
    _updates(before_d, dae_t, pd, pd0)

    alpha = jann.annealing_func(0.01, 1.0, 10, i_ep)
    assert abs(tann.annealing_func(0.01, 1.0, 10, i_ep) - float(alpha)) <= 1e-7
    zg = jax.random.normal(keys[6], (BS, z_dim))

    def loss_fn(q):
        x = gen_j.apply(q, zg)
        model_loss = jnp.mean(jenergy.energy_func4(x))
        score = jax.lax.stop_gradient(
            jcd.dae_score(dae_j, pd, jax.lax.stop_gradient(x), 0.0))
        return alpha * model_loss + jnp.sum(score * x) / BS, model_loss

    (_, model_loss), grads = jax.value_and_grad(loss_fn, has_aux=True)(pg)
    upd, og = tx_g.update(grads, og, pg)
    got = ardae_fit.generator_update(gen_t, dae_t, opt_g, float(alpha), BS, z_dim,
                                     tenergy.energy_func4, cpu, z=t(zg))
    close(got, model_loss, 1e-5, 0.0)
    _updates(before_g, gen_t, _apply(pg, upd), pg)


def test_quiver_grid_is_the_twins():
    for args in ((), (5, 41)):
        for a, b in zip(tvis.get_data_for_quiver_plot(*args),
                        jvis.get_data_for_quiver_plot(*args)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_quiver_panel():
    """The JAX panel's shape (a 5 x 5 inch figure at 100 dpi), uint8 on a
    white field; one arrow from each grid point of a radial field, pointing
    outward; the mean arrow about half a 41 x 41 cell long (matplotlib's
    autoscale)."""
    data, xs, ys = tvis.get_data_for_quiver_plot(5, 41)
    img = tvis.get_quiver_plot(data, xs, ys, xlim=5, ylim=5)
    assert img.shape == (tvis.PANEL, tvis.PANEL, 3) and img.dtype == np.uint8
    assert set(np.unique(img)) == {0, 255}
    ink = img[..., 0] == 0
    assert 0.01 < ink.mean() < 0.2
    # the upper-right quadrant's arrows point up and right: ink above and
    # right of the tail at (4, 4), none below-left of it
    col = round((4 + 5) / 10 * tvis.PANEL)
    row = round(tvis.PANEL - (4 + 5) / 10 * tvis.PANEL)
    assert ink[row - 6:row, col:col + 6].any()
    assert not ink[row + 2:row + 6, col - 6:col - 2].any()
    # a zero or non-finite field draws nothing
    blank = tvis.get_quiver_plot(np.zeros_like(data), xs, ys)
    assert (blank == 255).all()
    assert (tvis.get_quiver_plot(np.full_like(data, np.nan), xs, ys) == 255).all()


def _read_png(path):
    """(H, W, 3) uint8 of an 8-bit RGB PNG with filter-0 scanlines."""
    raw = open(path, "rb").read()
    assert raw[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(raw):
        (n,) = struct.unpack(">I", raw[pos:pos + 4])
        kind, body = raw[pos + 4:pos + 8], raw[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", raw[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(kind + body) & 0xFFFFFFFF
        chunks[kind] = chunks.get(kind, b"") + body
        pos += 12 + n
    wid, hgt, depth, color = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    assert (depth, color) == (8, 2) and b"IEND" in chunks
    rows = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8).reshape(hgt, -1)
    assert not rows[:, 0].any()
    return rows[:, 1:].reshape(hgt, wid, 3)


def test_save_png_round_trip(tmp_path):
    img = np.random.default_rng(0).integers(0, 256, (7, 5, 3), dtype=np.uint8)
    tvis.save_png(tmp_path / "a.png", img)
    np.testing.assert_array_equal(_read_png(tmp_path / "a.png"), img)
    with pytest.raises(ValueError, match="uint8"):
        tvis.save_png(tmp_path / "b.png", img.astype(np.float32))


MAINS = {
    "dae_toy": (dae_toy, ["--score-type", "res", "--out", "{d}/q.png"], ["q.png"],
                "score-field quiver saved"),
    "ardae_toy": (ardae_toy, ["--out-prefix", "{d}/q"], ["q_s0.0.png", "q_s1.0.png"],
                  "score field at sigma=1.0 saved"),
    "ardae_fit": (ardae_fit, ["--out", "{d}/h.png"], ["h.png"],
                  "sample histogram saved"),
}


@pytest.mark.parametrize("name", list(MAINS))
def test_main_on_the_cpu(name, tmp_path, capsys):
    """main() with --no-cuda at 2 iterations writes readable PNGs of the
    JAX panel's shape and logs the JAX script's lines."""
    mod, args, outs, said = MAINS[name]
    mod.main([a.format(d=tmp_path) for a in args] + ["--iterations", "2", "--no-cuda"])
    text = capsys.readouterr().out
    assert "|     2/2 |" in text and said in text
    for out in outs:
        img = _read_png(tmp_path / out)
        assert img.shape == (tvis.PANEL, tvis.PANEL, 3)


@pytest.mark.parametrize("name", list(MAINS))
def test_main_needs_a_card(name, tmp_path, monkeypatch):
    """Without --no-cuda an example runs on the card, and raises where
    there is none; it does not fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod, args, outs, _ = MAINS[name]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([a.format(d=tmp_path) for a in args] + ["--iterations", "2"])
    assert not any((tmp_path / out).exists() for out in outs)
