"""The bf16 compute mode of the grad-style fused DSM op (ops/fused_dsm_grad.py,
``compute_dtype="bfloat16"``), on the CPU, where the op runs its plain
version: the kernel's steps, rounded to bf16 where the TPU row-tile kernel
rounds in its bf16 mode.

It is held against both TPU kernels in interpret mode in their bf16 mode
(ardae_tpu/ops/fused_dsm_grad.py, ``fused_dsm_grad2.py``; bf16 is their
default) at the JAX tests' shapes (tests/test_fused_dsm.py ``_setup_grad``:
h 32, 3 layers, bsz 4, ssz 64, z 8, ctx 6) and at a ragged sample count
(ssz 50), with the DSM noise drawn by jax.random and injected. Against the
row-tile kernel (v1), whose roundings the port takes, each gradient's
relative distance must be at most JAX_FRACTION of that kernel's own
bf16-to-fp32 distance (the worst gradient of a case: 1.4e-5 to 1.0e-2 of
it; the port's fp32 mode, the control, sits at 1.0 of it and must fail the
bound), and the loss within LOSS_RTOL. The item-aligned kernel (v2) rounds
a few values otherwise (csrc/fused_dsm_grad.cu says which), so the worst
gradient of v1 and v2 differs by 0.56 to 1.2 of v2's own bf16-to-fp32
distance; against v2 each gradient may be as far as v1 is, plus
JAX_FRACTION of v2's own distance, and the loss within the JAX package's
bound, 0.02 * (1 + |l|) (tests/test_fused_dsm.py:157).

The fp32 default is held bit for bit against the plain version as it was
before the bf16 mode existed (autograd through the energy chain), and the
explicit bf16 chain with its rounding taken out against that same fp32
autograd (rtol 1e-5: the same function, another order of sums). The CUDA
kernel's bf16 mode is held against this plain version on the card by
tests/test_torch_kernels_cuda.py and chip_smoke.py phase 13a.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from ardae_tpu.models.cdae import MLPGradCARDAE as JGrad
from ardae_tpu.ops.fused_dsm_grad import fused_cdae_dsm_grad_loss as j_fused1
from ardae_tpu.ops.fused_dsm_grad2 import fused_cdae_dsm_grad_loss2 as j_fused2
from ardae_tpu_torch.models.cdae.cardae import MLPGradCARDAE as TGrad
from ardae_tpu_torch.ops import fused_dsm_grad as fg
from ardae_tpu_torch.ops.fused_dsm import chain_reference, prepare_inputs
from torch_parity import grads_as_state_dict, init, loaded, rand, t

H, L, Z, CTX = 32, 3, 8, 6
ACTS = ["softplus", "tanh", "relu"]
HEAD_BIAS = "neglogprob.fc.bias"
# the port's bf16 mode against the row-tile TPU kernel's: each gradient's
# distance as a fraction of that kernel's own bf16-to-fp32 distance, and
# the loss's relative distance (the worst measured: 1.0e-2 and 1.1e-7)
JAX_FRACTION, LOSS_RTOL = 0.1, 1e-6


def _setup(bsz, ssz, nonlin, seed=0):
    jm = JGrad(input_dim=Z, context_dim=CTX, h_dim=H, num_hidden_layers=L,
               nonlinearity=nonlin)
    p = init(jm, np.zeros((4, Z), np.float32), np.zeros((4, CTX), np.float32),
             np.zeros((4, 1), np.float32), seed=seed)
    tm = loaded(TGrad(Z, CTX, H, L, nonlin), p)
    latent = rand(seed + 1, bsz, ssz, Z)
    ctx = rand(seed + 2, bsz, CTX)
    std = np.abs(rand(seed + 3, bsz, ssz, 1, scale=0.3))
    return jm, p, tm, latent, ctx, std


@functools.lru_cache(maxsize=None)
def _jax(ref, bsz, ssz, nonlin, key_seed, compute_dtype):
    """(loss, flax gradient tree) of a TPU kernel in interpret mode on
    ``_setup``'s inputs, once per process."""
    jm, p, _, latent, ctx, std = _setup(bsz, ssz, nonlin)
    key = jax.random.PRNGKey(key_seed)
    if ref == "v1":
        n = bsz * ssz
        tile = 64 if n % 64 == 0 else 40
        fn = lambda q: j_fused1(jm, q, key, latent, ctx, std, tile=tile,
                                interpret=True, compute_dtype=compute_dtype)
    else:
        fn = lambda q: j_fused2(jm, q, key, latent, ctx, std, interpret=True,
                                compute_dtype=compute_dtype, tile=32)
    return jax.value_and_grad(fn)(p)


def _port(tm, latent, ctx, std, eps, fn=fg.fused_cdae_dsm_grad_loss, **kw):
    """(loss, {name: gradient}) of the port's op on CPU tensors; a parameter
    the loss does not reach gets zeros."""
    tm.zero_grad(set_to_none=True)
    loss = fn(tm, t(latent), t(ctx), t(std), eps=t(eps), **kw)
    loss.backward()
    return loss.detach(), {k: (p.grad.clone() if p.grad is not None
                               else torch.zeros_like(p))
                           for k, p in tm.named_parameters()}


def _rel(a, b):
    nb = float(b.norm())
    return float((a - b).norm()) / nb if nb else float(a.norm())


def _check_bf16(ref, bsz, ssz, nonlin, key_seed):
    _, _, tm, latent, ctx, std = _setup(bsz, ssz, nonlin)
    eps = jax.random.normal(jax.random.PRNGKey(key_seed), (bsz * ssz, Z))
    case = (bsz, ssz, nonlin, key_seed)

    def jax_grads(which, compute_dtype):
        loss, tree = _jax(which, *case, compute_dtype)
        return float(loss), grads_as_state_dict(tree, tm)

    jl16, want16 = jax_grads(ref, "bfloat16")
    _, want32 = jax_grads(ref, "float32")
    loss, grads = _port(tm, latent, ctx, std, eps, compute_dtype="bfloat16")
    _, grads32 = _port(tm, latent, ctx, std, eps)
    assert set(want16) == set(grads)
    own = {k: _rel(want16[k], want32[k]) for k in grads}  # JAX's own distance
    if ref == "v1":
        assert abs(float(loss) - jl16) <= LOSS_RTOL * abs(jl16), (float(loss), jl16)
        for k, g in grads.items():
            assert _rel(g, want16[k]) <= JAX_FRACTION * own[k], (
                k, _rel(g, want16[k]), own[k])
        # the control: the port's fp32 mode is not within the bound
        assert max(_rel(g, want16[k]) / own[k] for k, g in grads32.items()
                   if own[k]) > JAX_FRACTION
    else:
        assert abs(float(loss) - jl16) <= 0.02 * (1.0 + abs(jl16)), (float(loss), jl16)
        _, v1 = jax_grads("v1", "bfloat16")
        for k, g in grads.items():
            bound = _rel(v1[k], want16[k]) + JAX_FRACTION * own[k]
            assert _rel(g, want16[k]) <= bound, (k, _rel(g, want16[k]), bound)
    assert not float(grads[HEAD_BIAS].abs().max())


@pytest.mark.parametrize("ref", ["v1", "v2"])
@pytest.mark.parametrize("nonlin", ACTS)
def test_plain_bf16_matches_jax_bf16(nonlin, ref):
    _check_bf16(ref, 4, 64, nonlin, key_seed=7)


@pytest.mark.parametrize("ref", ["v1", "v2"])
def test_plain_bf16_matches_jax_bf16_ragged_rows(ref):
    """ssz 50: the v2 kernel pads its sample axis, the v1 kernel takes tile
    40, and the port's plain version takes the rows as they are."""
    _check_bf16(ref, 4, 50, "softplus", key_seed=8)


def _fp32_as_before(act, l0, xbar, eps, sigma, ctx_l0, *flat):
    """The plain version as it was before the bf16 mode existed."""
    with torch.enable_grad():
        x = xbar.detach().requires_grad_(True)
        energy = chain_reference(act, l0, x, sigma, ctx_l0, flat)
        (g,) = torch.autograd.grad(energy.sum(), x, create_graph=True)
    return torch.mean((eps - sigma * g) ** 2)


def _chain_inputs(nonlin, bsz=4, ssz=16):
    _, _, tm, latent, ctx, std = _setup(bsz, ssz, nonlin)
    eps = t(rand(11, bsz * ssz, Z))
    act, l0, xbar, eps, sigma, ctx_l0, flat = prepare_inputs(
        tm, t(latent), t(ctx), t(std), None, eps)
    leaves = [ctx_l0.detach().requires_grad_(True)] + [
        w.detach().requires_grad_(True) for w in flat]
    return (act, l0, xbar, eps, sigma), leaves


def _value_and_grads(fn, head, leaves, **kw):
    loss = fn(*head, *leaves, **kw)
    gs = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), [torch.zeros_like(x) if g is None else g
                           for g, x in zip(gs, leaves)]


@pytest.mark.parametrize("nonlin", ACTS)
def test_fp32_default_is_unchanged(nonlin):
    """The default mode, through the dispatch on the CPU and through the
    plain version, gives bit for bit what the plain version gave before."""
    head, leaves = _chain_inputs(nonlin)
    want = _value_and_grads(_fp32_as_before, head, leaves)
    for fn, kw in ((fg.dsm_grad_chain, {}),
                   (fg.dsm_grad_chain_reference, {}),
                   (fg.dsm_grad_chain, {"compute_dtype": "float32"})):
        loss, grads = _value_and_grads(fn, head, leaves, **kw)
        assert torch.equal(loss, want[0])
        for a, b in zip(grads, want[1]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("nonlin", ACTS)
def test_bf16_chain_without_rounding_is_the_fp32_function(nonlin, monkeypatch):
    """The explicit bf16 chain (forward, input gradient, tangent and the
    reverse over both chains) with its operand rounding taken out computes
    the fp32 plain version's loss and gradients: the derivation of its
    backward, checked against autograd's double backward."""
    head, leaves = _chain_inputs(nonlin)
    want = _value_and_grads(fg.dsm_grad_chain_reference, head, leaves)
    monkeypatch.setattr(fg, "_bf16", lambda x: x)
    loss, grads = _value_and_grads(fg.dsm_grad_chain_reference, head, leaves,
                                   compute_dtype="bfloat16")
    torch.testing.assert_close(loss, want[0], rtol=1e-5, atol=0)
    for a, b in zip(grads, want[1]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


def test_bf16_rounds_every_product():
    """With the rounding in, the bf16 chain differs from fp32 (by about bf16's
    2^-8 relative). It rounds every weight matrix, w_out and sigma's weight
    included: rounding them by hand first changes neither the loss nor a
    gradient. It keeps the biases in fp32: rounding one by hand changes the
    loss."""
    head, leaves = _chain_inputs("softplus")
    l32, g32 = _value_and_grads(fg.dsm_grad_chain_reference, head, leaves)
    l16, g16 = _value_and_grads(fg.dsm_grad_chain_reference, head, leaves,
                                compute_dtype="bfloat16")
    worst = max(_rel(a, b) for a, b in zip(g16, g32))
    assert 1e-4 < worst < 0.1
    assert abs(float(l16) - float(l32)) <= 0.02 * abs(float(l32))
    ctx_l0, *flat = leaves

    def bf16(w):
        return w.detach().to(torch.bfloat16).float().requires_grad_(True)

    weights = [bf16(w) if w.ndim == 2 else w for w in flat]
    again = _value_and_grads(fg.dsm_grad_chain_reference, head,
                             [ctx_l0] + weights, compute_dtype="bfloat16")
    assert torch.equal(again[0], l16)
    for a, b in zip(again[1], g16):
        assert torch.equal(a, b)
    bias = flat[1].detach() + 1e-3   # off the bf16 grid
    losses = [fg.dsm_grad_chain_reference(*head, ctx_l0, flat[0], b, *flat[2:],
                                          compute_dtype="bfloat16")
              for b in (bias, bias.to(torch.bfloat16).float())]
    assert not torch.equal(*losses)


def test_bf16_on_the_cpu_runs_the_plain_version():
    """On CPU tensors the bf16 mode launches no kernel of either mode and
    equals the plain entry point bit for bit."""
    _, _, tm, latent, ctx, std = _setup(2, 5, "tanh")
    eps = rand(9, 10, Z)
    before = {m: dict(f.launches) for m, f in fg.FUNCTIONS.items()}
    a, ga = _port(tm, latent, ctx, std, eps, compute_dtype="bfloat16")
    b, gb = _port(tm, latent, ctx, std, eps,
                  fn=fg.fused_cdae_dsm_grad_loss_reference,
                  compute_dtype="bfloat16")
    assert {m: dict(f.launches) for m, f in fg.FUNCTIONS.items()} == before
    assert torch.equal(a, b)
    for k in ga:
        assert torch.equal(ga[k], gb[k]), k


def test_each_mode_counts_its_own_launches():
    names = [set(f.launches) for f in fg.FUNCTIONS.values()]
    assert set(fg.FUNCTIONS) == {"float32", "bfloat16"}
    assert not names[0] & names[1]
    assert fg.FUNCTIONS["float32"] is fg.FusedDSMGradFunction
    assert fg.FUNCTIONS["bfloat16"].compute_dtype == "bfloat16"
    assert set(fg.FusedDSMGradBF16Function.launches) == {
        "fused_dsm_grad_fwd_bf16", "fused_dsm_grad_bwd_bf16"}


@pytest.mark.parametrize("compute_dtype", ["float16", "bf16", None])
def test_unknown_compute_dtype_raises(compute_dtype):
    _, _, tm, latent, ctx, std = _setup(2, 5, "tanh")
    head, leaves = _chain_inputs("tanh", 2, 5)
    for call in (
            lambda: fg.fused_cdae_dsm_grad_loss(
                tm, t(latent), t(ctx), t(std), compute_dtype=compute_dtype),
            lambda: fg.fused_cdae_dsm_grad_loss_reference(
                tm, t(latent), t(ctx), t(std), compute_dtype=compute_dtype),
            lambda: fg.dsm_grad_chain(*head, *leaves, compute_dtype=compute_dtype),
            lambda: fg.dsm_grad_chain_reference(*head, *leaves,
                                                compute_dtype=compute_dtype)):
        with pytest.raises(ValueError, match="compute_dtype"):
            call()


def test_bf16_dispatch_raises_off_cpu_and_cuda():
    flat = [torch.zeros(2, 2, device="meta"), torch.zeros(2, device="meta")]
    x = torch.zeros(4, 2, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        fg.dsm_grad_chain("tanh", 0, x, x, torch.zeros(4, 1, device="meta"),
                          torch.zeros(2, 2, device="meta"), *flat,
                          compute_dtype="bfloat16")
