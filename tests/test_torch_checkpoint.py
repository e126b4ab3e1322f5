"""The port's checkpoints (ardae_tpu_torch.io.checkpoint), ported from
tests/test_checkpoint.py: roundtrip, a missing checkpoint, recovery from a
crash inside a save, a newer finished ``.tmp-save`` over the live file, a
live file with malformed meta over a readable ``.tmp-save`` (where the JAX
twin's rule let the temporary win, io/checkpoint.py:121), an RMSprop state
saved without an update count, load_end_iter,
and resume: 2 + 2 train_chunk steps with a save and a load into freshly
built modules, optimizers and generator between them equal 4 uninterrupted
steps bit for bit, for the flagship, implicit-conv and 25-gaussians
implicit lines and for the baseline VAE, whose state has no cdae (its checkpoint leaves both out), at a tiny
width."""

import os

import numpy as np
import pytest
import torch

from ardae_tpu_torch.data.mnist import _synthetic_mnist
from ardae_tpu_torch.io.checkpoint import load_checkpoint, load_end_iter, save_checkpoint
from ardae_tpu_torch.models.registry import build_cdae, build_ivae_model
from ardae_tpu_torch.train.optim import build_optimizer
from ardae_tpu_torch.train.state import create_train_state
from ardae_tpu_torch.train.step import StepConfig, train_chunk

META = {"i_ep": 7, "epoch": 1, "batch_idx": 7, "train_num_iters_per_epoch": 14,
        "best_val_loss": -2.5}


def _small_state(seed=0):
    """Two tiny cdaes stand in for the networks; both optimizers have taken
    one step, so their state is populated."""
    nets = [build_cdae(name, input_dim=2, context_dim=2, h_dim=8, n_layers=1,
                       seed=seed + i, device="cpu")
            for i, name in enumerate(("mlp-grad", "mlp-res"))]
    opts = [build_optimizer("adam", nets[0].parameters(), 1e-3, beta1=0.9),
            build_optimizer("rmsprop", nets[1].parameters(), 1e-3, momentum=0.5)]
    g = torch.Generator().manual_seed(seed)
    for net, o in zip(nets, opts):
        for p in net.parameters():
            p.grad = torch.randn(p.shape, generator=g)
        o.step()
    return create_train_state(nets[0], opts[0], nets[1], opts[1])


def _tensors(state):
    """Every tensor and scalar of a state, flattened, for exact comparison."""
    sd = state.state_dict()
    out = {"step": sd["step"]}
    for part in ("model", "cdae"):
        out.update({f"{part}.{k}": v for k, v in sd.get(part, {}).items()})
    for part in ("opt_model", "opt_cdae"):
        if part in sd:
            out.update({f"{part}.{i}.{n}": x for i, st in sd[part]["state"].items()
                        for n, x in st.items()})
    return out


def _assert_same(a, b):
    ta, tb = _tensors(a), _tensors(b)
    assert ta.keys() == tb.keys()
    for k in ta:
        if isinstance(ta[k], torch.Tensor):
            assert torch.equal(ta[k], tb[k]), k
        else:
            assert ta[k] == tb[k], k


def test_checkpoint_roundtrip(tmp_path):
    state = _small_state(0)
    state.step = 17
    gen = torch.Generator().manual_seed(4)
    gen_state = gen.get_state()
    save_checkpoint(state, META, str(tmp_path), "checkpoint", gen)
    other, gen2 = _small_state(9), torch.Generator().manual_seed(5)
    restored = load_checkpoint(other, str(tmp_path), "checkpoint", gen2)
    assert restored is not None
    state2, meta2 = restored
    assert state2 is other and state2.step == 17 and meta2 == META
    _assert_same(state, state2)
    assert torch.equal(gen2.get_state(), gen_state)
    # overwrite, and a -inf best value ("none yet") survives the trip
    save_checkpoint(state, {**META, "i_ep": 18, "best_val_loss": -float("inf")},
                    str(tmp_path), "checkpoint")
    _, meta3 = load_checkpoint(other, str(tmp_path), "checkpoint")
    assert meta3["i_ep"] == 18 and meta3["best_val_loss"] == -float("inf")
    assert sorted(os.listdir(tmp_path)) == ["checkpoint"]


def test_rmsprop_state_without_count_resumes(tmp_path):
    """A checkpoint whose RMSprop state holds only sq and buf (the format
    written before the optimizers kept an update count) loads and steps as
    the state it was saved from does."""
    live, old = _small_state(0), _small_state(0)
    for st in old.opt_cdae.state.values():
        del st["count"]
    save_checkpoint(old, META, str(tmp_path), "checkpoint")
    resumed, _ = load_checkpoint(_small_state(9), str(tmp_path), "checkpoint")
    g = torch.Generator().manual_seed(3)
    for a, b in zip(live.cdae.parameters(), resumed.cdae.parameters()):
        a.grad = torch.randn(a.shape, generator=g)
        b.grad = a.grad.clone()
    live.opt_cdae.step()
    resumed.opt_cdae.step()
    for a, b in zip(live.cdae.parameters(), resumed.cdae.parameters()):
        assert torch.equal(a, b)
        sa, sb = live.opt_cdae.state[a], resumed.opt_cdae.state[b]
        assert torch.equal(sa["sq"], sb["sq"]) and torch.equal(sa["buf"], sb["buf"])
        assert sb["count"] == 1


def test_missing_checkpoint_returns_none(tmp_path):
    assert load_checkpoint(_small_state(), str(tmp_path), "nope") is None


def test_crash_window_recovery(tmp_path):
    """A crash between the two renames of a save leaves only '.tmp-old' or
    '.tmp-save': the load recovers from them."""
    state, d = _small_state(), str(tmp_path)
    save_checkpoint(state, META, d, "checkpoint")
    target = os.path.join(d, "checkpoint")

    os.rename(target, target + ".tmp-old")
    restored = load_checkpoint(state, d, "checkpoint")
    assert restored is not None and restored[1]["i_ep"] == 7

    os.rename(target + ".tmp-old", target + ".tmp-save")
    restored = load_checkpoint(state, d, "checkpoint")
    assert restored is not None and restored[1]["i_ep"] == 7

    os.rename(target + ".tmp-save", target + ".tmp-old")
    assert load_end_iter(d, "checkpoint") == (1 - 1) * 14 + 7 - 1

    # an unreadable .tmp-save (a partial write) is skipped, not fatal
    os.remove(target + ".tmp-old")
    open(target + ".tmp-save", "wb").close()
    assert load_checkpoint(state, d, "checkpoint") is None
    os.remove(target + ".tmp-save")

    # both temporaries: the finished '.tmp-save' is the newer save
    save_checkpoint(state, {**META, "i_ep": 8}, d, "checkpoint")
    os.rename(target, target + ".newer-aside")
    save_checkpoint(state, META, d, "checkpoint")
    os.rename(target, target + ".tmp-old")
    os.rename(target + ".newer-aside", target + ".tmp-save")
    restored = load_checkpoint(state, d, "checkpoint")
    assert restored is not None and restored[1]["i_ep"] == 8


def test_newer_tmp_save_wins_over_the_live_file(tmp_path):
    """A crash after the new file was complete but before the swap: the
    live file is one save staler than '.tmp-save'. A partial '.tmp-save'
    or a staler one never wins."""
    state, d = _small_state(), str(tmp_path)
    target = os.path.join(d, "checkpoint")
    save_checkpoint(state, {**META, "i_ep": 8, "batch_idx": 8}, d, "checkpoint")
    os.rename(target, target + ".newer-aside")
    save_checkpoint(state, META, d, "checkpoint")
    os.rename(target + ".newer-aside", target + ".tmp-save")
    restored = load_checkpoint(state, d, "checkpoint")
    assert restored is not None and restored[1]["i_ep"] == 8
    assert load_end_iter(d, "checkpoint") == (1 - 1) * 14 + 8 - 1

    with open(target + ".tmp-save", "wb") as f:
        f.write(b"PK\x03\x04 partial")
    restored = load_checkpoint(state, d, "checkpoint")
    assert restored is not None and restored[1]["i_ep"] == 7

    save_checkpoint(state, {**META, "i_ep": 3}, d, "checkpoint")
    os.rename(target, target + ".older-aside")
    save_checkpoint(state, META, d, "checkpoint")
    os.rename(target + ".older-aside", target + ".tmp-save")
    restored = load_checkpoint(state, d, "checkpoint")
    assert restored is not None and restored[1]["i_ep"] == 7


def test_live_file_with_malformed_meta_beats_a_readable_tmp_save(tmp_path):
    """Nothing says a '.tmp-save' is newer than a live file whose meta
    cannot be read, so the live file keeps priority."""
    state, d = _small_state(), str(tmp_path)
    target = os.path.join(d, "checkpoint")
    save_checkpoint(state, {**META, "i_ep": 8}, d, "checkpoint")
    os.rename(target, target + ".aside")
    save_checkpoint(state, {"best_val_loss": -1.0}, d, "checkpoint")  # no stamp
    os.rename(target + ".aside", target + ".tmp-save")
    restored = load_checkpoint(state, d, "checkpoint")
    assert restored is not None and restored[1] == {"best_val_loss": -1.0}


def test_load_end_iter(tmp_path):
    save_checkpoint(_small_state(), {**META, "i_ep": 41, "epoch": 3,
                                     "batch_idx": 13}, str(tmp_path),
                    "best-checkpoint")
    # reference formula: (epoch-1)*iters + batch_idx - 1 (utils/msc.py:98-110)
    assert load_end_iter(str(tmp_path), "best-checkpoint") == (3 - 1) * 14 + 13 - 1
    with pytest.raises(ValueError, match="no checkpoint"):
        load_end_iter(str(tmp_path), "final-checkpoint")


MNIST = dict(nchannels=1, nheight=28)
LINES = {
    "flagship": (dict(name="resconvct-res", z_dim=8, h_dim=16, n_dim=10,
                      n_layers=1, nonlin="elu", **MNIST), "mlp-res", 2, 100.0),
    "implicit-conv": (dict(name="mnist-conv", z_dim=8, h_dim=0, n_dim=10,
                           n_layers=0, nonlin="softplus", **MNIST), "mlp-grad",
                      1, 10000.0),
    "25-gaussians": (dict(name="mlp-concat", z_dim=2, h_dim=16, n_dim=10,
                          n_layers=2, nonlin="relu", nchannels=2, nheight=1),
                     "mlp-grad", 1, 10000.0),
}


def _line_state(line, seed):
    model_kw, cdae_name, _, _ = LINES[line]
    model = build_ivae_model(**model_kw, seed=seed, device="cpu")
    z = model_kw["z_dim"]
    cdae = build_cdae(cdae_name, input_dim=z, context_dim=z, h_dim=16, n_layers=2,
                      nonlin="softplus", seed=seed + 1, device="cpu")
    return create_train_state(
        model, build_optimizer("adam", model.parameters(), 1e-3, beta1=0.9), cdae,
        build_optimizer("rmsprop", cdae.parameters(), 1e-4, momentum=0.9))


@pytest.mark.parametrize("line", list(LINES))
def test_resume_is_bitwise(tmp_path, line):
    _, _, updates, std_scale = LINES[line]
    cfg = StepConfig(std_scale=std_scale, delta=0.1, num_cdae_updates=updates,
                     train_nz_cdae=8, ctx_type="lt0", use_kernels=True)
    toy = LINES[line][0]["nchannels"] == 2
    data = torch.from_numpy(
        np.random.default_rng(3).normal(size=(16, 2)).astype(np.float32) if toy
        else _synthetic_mnist(16, seed=3)[0])
    rng = np.random.default_rng(4)
    c_idx, m_idx = rng.integers(0, 16, (4, updates, 4)), rng.integers(0, 16, (4, 4))

    def steps(state, gen, lo, hi):
        train_chunk(state, cfg, data, c_idx[lo:hi], m_idx[lo:hi], gen,
                    lambda step: 1.0, binarize=not toy)

    full, g_full = _line_state(line, 0), torch.Generator().manual_seed(1)
    steps(full, g_full, 0, 4)

    half, g_half = _line_state(line, 0), torch.Generator().manual_seed(1)
    steps(half, g_half, 0, 2)
    save_checkpoint(half, {**META, "i_ep": 2}, str(tmp_path), "checkpoint", g_half)
    resumed, g_res = _line_state(line, 7), torch.Generator().manual_seed(99)
    _, meta = load_checkpoint(resumed, str(tmp_path), "checkpoint", g_res)
    assert meta["i_ep"] == 2 and resumed.step == 2
    steps(resumed, g_res, 2, 4)

    assert resumed.step == full.step == 4
    _assert_same(full, resumed)
    assert torch.equal(g_res.get_state(), g_full.get_state())


def _vae_state(seed):
    from ardae_tpu_torch.models.registry import build_vae_model

    model = build_vae_model("conv", z_dim=4, seed=seed, device="cpu")
    return create_train_state(
        model, build_optimizer("adam", model.parameters(), 1e-3, beta1=0.5))


def test_baseline_vae_state_roundtrip_and_bitwise_resume(tmp_path):
    """A state without a cdae: its checkpoint holds the model, its optimizer
    and the step only; 2 + 2 chunk steps with a save and a load into a
    fresh state between them equal 4 uninterrupted steps bit for bit."""
    from ardae_tpu_torch.train.vae_step import VAEStepConfig, train_vae_chunk

    cfg = VAEStepConfig(loss_scale=1.0 / 784)
    data = torch.from_numpy(_synthetic_mnist(16, seed=3)[0])
    idx = np.random.default_rng(4).integers(0, 16, (4, 4))

    def steps(state, gen, lo, hi):
        train_vae_chunk(state, cfg, data, idx[lo:hi], gen, lambda step: 1.0,
                        binarize=True)

    full, g_full = _vae_state(0), torch.Generator().manual_seed(1)
    steps(full, g_full, 0, 4)
    half, g_half = _vae_state(0), torch.Generator().manual_seed(1)
    steps(half, g_half, 0, 2)
    assert set(half.state_dict()) == {"step", "model", "opt_model"}
    save_checkpoint(half, {**META, "i_ep": 2}, str(tmp_path), "checkpoint", g_half)
    resumed, g_res = _vae_state(7), torch.Generator().manual_seed(99)
    _, meta = load_checkpoint(resumed, str(tmp_path), "checkpoint", g_res)
    assert meta["i_ep"] == 2 and resumed.step == 2 and resumed.cdae is None
    _assert_same(half, resumed)
    steps(resumed, g_res, 2, 4)
    assert resumed.step == full.step == 4
    _assert_same(full, resumed)
    assert torch.equal(g_res.get_state(), g_full.get_state())
