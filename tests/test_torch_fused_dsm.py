"""The fused DSM op of the port (ops/fused_dsm.py).

On the CPU the op runs its plain-PyTorch version; it is held against the JAX
Pallas kernel in interpret mode (as tests/test_fused_dsm.py runs it) and
against jax.value_and_grad of cardae.cdae_loss, loss and every parameter
gradient at rtol 2e-4 / atol 1e-6 (the bound of tests/test_fused_dsm.py).
The DSM noise is drawn by jax.random from the JAX call's key and injected.
The CUDA kernel itself is held against the plain version on the card
(marked ``cuda``; skipped without a GPU, and by chip_smoke.py).
"""

import jax
import numpy as np
import pytest
import torch

from ardae_tpu.models.cdae import MLPResCARDAE as JRes
from ardae_tpu.models.cdae import cdae_loss as j_cdae_loss
from ardae_tpu.ops.fused_dsm import fused_cdae_dsm_loss as j_fused
from ardae_tpu_torch.models.cdae.cardae import MLPGradCARDAE as TGrad
from ardae_tpu_torch.models.cdae.cardae import MLPResCARDAE as TRes
from ardae_tpu_torch.models.registry import build_cdae
from ardae_tpu_torch.ops import fused_dsm as fd
from torch_parity import close, grads_as_state_dict, init, loaded, rand, t

RTOL, ATOL = 2e-4, 1e-6


def _setup(h, L, bsz, ssz, zdim, ctx_dim, nonlin, seed=0):
    jm = JRes(input_dim=zdim, context_dim=ctx_dim, h_dim=h, num_hidden_layers=L,
              nonlinearity=nonlin)
    p = init(jm, np.zeros((4, zdim), np.float32), np.zeros((4, ctx_dim), np.float32),
             np.zeros((4, 1), np.float32), seed=seed)
    tm = loaded(TRes(zdim, ctx_dim, h, L, nonlin), p)
    latent = rand(seed + 1, bsz, ssz, zdim)
    ctx = rand(seed + 2, bsz, ctx_dim)
    std = np.abs(rand(seed + 3, bsz, ssz, 1, scale=0.3))
    return jm, p, tm, latent, ctx, std


def _port_value_and_grads(tm, latent, ctx, std, eps, fn=fd.fused_cdae_dsm_loss):
    tm.zero_grad(set_to_none=True)
    loss = fn(tm, t(latent), t(ctx), t(std), eps=t(eps))
    loss.backward()
    return loss, {k: p.grad for k, p in tm.named_parameters()}


def _compare(jloss, jgrads, tm, loss, grads):
    close(loss, jloss, 1e-5, 0.0, msg="loss")
    want = grads_as_state_dict(jgrads, tm)
    assert set(want) == set(grads)
    for k, g in grads.items():
        close(g, want[k], RTOL, ATOL, msg=k)


def test_plain_matches_pallas_interpret():
    jm, p, tm, latent, ctx, std = _setup(h=16, L=2, bsz=2, ssz=64, zdim=8,
                                         ctx_dim=6, nonlin="softplus")
    key = jax.random.PRNGKey(7)
    jloss, jgrads = jax.value_and_grad(
        lambda q: j_fused(jm, q, key, latent, ctx, std, tile=64,
                          interpret=True))(p)
    eps = jax.random.normal(key, (2 * 64, 8))  # the draw j_fused makes
    loss, grads = _port_value_and_grads(tm, latent, ctx, std, eps)
    _compare(jloss, jgrads, tm, loss, grads)


@pytest.mark.parametrize("nonlin", ["softplus", "relu", "tanh"])
@pytest.mark.parametrize("bsz,ssz", [(4, 50), (3, 37)])  # (3, 37): ragged rows
def test_plain_matches_xla_cdae_loss(nonlin, bsz, ssz):
    jm, p, tm, latent, ctx, std = _setup(h=64, L=3, bsz=bsz, ssz=ssz, zdim=8,
                                         ctx_dim=5, nonlin=nonlin, seed=11)
    key = jax.random.PRNGKey(13)
    jloss, jgrads = jax.value_and_grad(
        lambda q: j_cdae_loss(jm, q, key, latent, ctx, std))(p)
    eps = jax.random.normal(key, (bsz * ssz, 8))  # the draw cdae_loss makes
    loss, grads = _port_value_and_grads(tm, latent, ctx, std, eps)
    _compare(jloss, jgrads, tm, loss, grads)


def test_reference_entry_equals_dispatch_on_cpu():
    _, _, tm, latent, ctx, std = _setup(h=16, L=2, bsz=2, ssz=5, zdim=3,
                                        ctx_dim=4, nonlin="tanh")
    eps = rand(9, 10, 3)
    a, ga = _port_value_and_grads(tm, latent, ctx, std, eps)
    ga = {k: v.clone() for k, v in ga.items()}
    b, gb = _port_value_and_grads(tm, latent, ctx, std, eps,
                                  fn=fd.fused_cdae_dsm_loss_reference)
    assert float(a.detach()) == float(b.detach())
    for k in ga:
        torch.testing.assert_close(ga[k], gb[k], rtol=0, atol=0)


def test_dispatch_raises_off_cpu_and_cuda():
    flat = [torch.zeros(2, 2, device="meta"), torch.zeros(2, device="meta")]
    x = torch.zeros(4, 2, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        fd.dsm_chain("tanh", 0, x, x, torch.zeros(4, 1, device="meta"),
                     torch.zeros(2, 2, device="meta"), *flat)


def test_guard():
    res = TRes(4, 4, 8, 2, "softplus")
    assert fd.supports_fused_dsm(res, 80_000)
    assert fd.supports_fused_dsm(res, 80_001)  # any row count
    assert not fd.supports_fused_dsm(TGrad(4, 4, 8, 2, "softplus"), 512)
    assert not fd.supports_fused_dsm(TRes(4, 4, 8, 2, "elu"), 512)
    assert not fd.supports_fused_dsm(TRes(4, 4, 8, 2, "softplus", enc_input=False), 512)
    assert not fd.supports_fused_dsm(res.double(), 512)
    # the flagship (h=512, 5 layers, 80k rows) keeps a 1.6 GB workspace
    flagship = TRes(32, 32, 512, 5, "softplus")
    assert fd.supports_fused_dsm(flagship, 128 * 625)
    assert not fd.supports_fused_dsm(flagship, 2_000_000)


@pytest.mark.cuda
def test_kernel_matches_plain_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs this comparison")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    tm = build_cdae("mlp-res", input_dim=5, context_dim=6, h_dim=24, n_layers=2,
                    nonlin="softplus", device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    latent = torch.randn(3, 37, 5, generator=g, device=dev)
    ctx = torch.randn(3, 6, generator=g, device=dev)
    std = 0.3 * torch.randn(3, 37, 1, generator=g, device=dev).abs()
    eps = torch.randn(3 * 37, 5, generator=g, device=dev)
    before = fd.FusedDSMFunction.launches["fused_dsm_fwd"]
    a = fd.fused_cdae_dsm_loss(tm, latent, ctx, std, eps=eps)
    ga = torch.autograd.grad(a, list(tm.parameters()))
    b = fd.fused_cdae_dsm_loss_reference(tm, latent, ctx, std, eps=eps)
    gb = torch.autograd.grad(b, list(tm.parameters()))
    assert fd.FusedDSMFunction.launches["fused_dsm_fwd"] == before + 1
    torch.testing.assert_close(a, b, rtol=1e-5, atol=0)
    for x, y in zip(ga, gb):
        assert float((x - y).norm() / y.norm()) <= 1e-4
