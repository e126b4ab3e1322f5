"""The grad-style fused DSM op of the port (ops/fused_dsm_grad.py).

On the CPU the op runs its plain-PyTorch version. It is held against three
JAX references at the JAX tests' own shapes (tests/test_fused_dsm.py
``_setup_grad``: h 32, 3 layers, bsz 4, ssz 64, z 8, ctx 6), for softplus,
relu and tanh, and at a ragged sample count (ssz 50):
  * the v1 Pallas kernel, ops/fused_dsm_grad.py (interpret mode, fp32);
  * the v2 Pallas kernel, ops/fused_dsm_grad2.py (interpret mode, fp32);
  * jax.value_and_grad of cardae.cdae_loss.
The DSM noise is drawn by jax.random from the JAX call's key and injected.
Bounds are the JAX tests': loss rtol 1e-5; every parameter gradient rtol
5e-4 / atol 1e-6. The energy head's bias does not reach the score, so JAX
returns zeros for it and torch no gradient: it compares as zero. The CUDA
kernel itself is held against the plain version on the card (marked
``cuda``; skipped without a GPU, and by chip_smoke.py).
"""

import jax
import numpy as np
import pytest
import torch

from ardae_tpu.models.cdae import MLPGradCARDAE as JGrad
from ardae_tpu.models.cdae import cdae_loss as j_cdae_loss
from ardae_tpu.ops.fused_dsm_grad import fused_cdae_dsm_grad_loss as j_fused1
from ardae_tpu.ops.fused_dsm_grad2 import fused_cdae_dsm_grad_loss2 as j_fused2
from ardae_tpu_torch.models.cdae.cardae import MLPGradCARDAE as TGrad
from ardae_tpu_torch.models.cdae.cardae import MLPResCARDAE as TRes
from ardae_tpu_torch.models.registry import build_cdae
from ardae_tpu_torch.ops import fused_dsm_grad as fg
from torch_parity import close, grads_as_state_dict, init, loaded, rand, t

LOSS_RTOL, RTOL, ATOL = 1e-5, 5e-4, 1e-6
H, L, Z, CTX = 32, 3, 8, 6


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


def _jax_ref(name, jm, key, latent, ctx, std):
    if name == "v1":
        n = latent.shape[0] * latent.shape[1]
        tile = 64 if n % 64 == 0 else 40
        return lambda q: j_fused1(jm, q, key, latent, ctx, std, tile=tile,
                                  interpret=True, compute_dtype="float32")
    if name == "v2":
        return lambda q: j_fused2(jm, q, key, latent, ctx, std, interpret=True,
                                  compute_dtype="float32", tile=32)
    return lambda q: j_cdae_loss(jm, q, key, latent, ctx, std)


def _port_value_and_grads(tm, latent, ctx, std, eps, fn=fg.fused_cdae_dsm_grad_loss):
    tm.zero_grad(set_to_none=True)
    loss = fn(tm, t(latent), t(ctx), t(std), eps=t(eps))
    loss.backward()
    return loss, {k: (p.grad if p.grad is not None else torch.zeros_like(p))
                  for k, p in tm.named_parameters()}


def _check(ref, bsz, ssz, nonlin, key_seed):
    jm, p, tm, latent, ctx, std = _setup(bsz, ssz, nonlin)
    key = jax.random.PRNGKey(key_seed)
    jloss, jgrads = jax.value_and_grad(_jax_ref(ref, jm, key, latent, ctx, std))(p)
    eps = jax.random.normal(key, (bsz * ssz, Z))  # the draw every reference makes
    loss, grads = _port_value_and_grads(tm, latent, ctx, std, eps)
    close(loss, jloss, LOSS_RTOL, 0.0, msg="loss")
    want = grads_as_state_dict(jgrads, tm)
    assert set(want) == set(grads)
    for k, g in grads.items():
        close(g, want[k], RTOL, ATOL, msg=k)
    head_bias = "neglogprob.fc.bias"
    assert not float(grads[head_bias].abs().max())
    assert not float(want[head_bias].abs().max())


@pytest.mark.parametrize("ref", ["v1", "v2", "xla"])
@pytest.mark.parametrize("nonlin", ["softplus", "relu", "tanh"])
def test_plain_matches_jax(nonlin, ref):
    _check(ref, 4, 64, nonlin, key_seed=7)


@pytest.mark.parametrize("ref", ["v1", "v2", "xla"])
def test_plain_matches_jax_ragged_rows(ref):
    """ssz 50: no tile of the v2 kernel divides it (its padding path), and
    the port's kernel masks the edge instead."""
    _check(ref, 4, 50, "softplus", key_seed=8)


def test_reference_entry_equals_dispatch_on_cpu():
    _, _, tm, latent, ctx, std = _setup(2, 5, "tanh")
    eps = rand(9, 10, Z)
    before = dict(fg.FusedDSMGradFunction.launches)
    a, ga = _port_value_and_grads(tm, latent, ctx, std, eps)
    ga = {k: v.clone() for k, v in ga.items()}
    b, gb = _port_value_and_grads(tm, latent, ctx, std, eps,
                                  fn=fg.fused_cdae_dsm_grad_loss_reference)
    assert fg.FusedDSMGradFunction.launches == before  # no kernel on the CPU
    assert float(a.detach()) == float(b.detach())
    for k in ga:
        torch.testing.assert_close(ga[k], gb[k], rtol=0, atol=0)


def test_dispatch_raises_off_cpu_and_cuda():
    flat = [torch.zeros(2, 2, device="meta"), torch.zeros(2, device="meta")]
    x = torch.zeros(4, 2, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        fg.dsm_grad_chain("tanh", 0, x, x, torch.zeros(4, 1, device="meta"),
                          torch.zeros(2, 2, device="meta"), *flat)


def test_guard():
    grad = TGrad(4, 4, 8, 2, "softplus")
    assert fg.supports_fused_dsm_grad(grad, 80_000)
    assert fg.supports_fused_dsm_grad(grad, 80_001)  # any row count
    assert fg.supports_fused_dsm_grad(TGrad(4, 4, 24, 2, "relu"), 111)  # any width
    assert not fg.supports_fused_dsm_grad(TRes(4, 4, 8, 2, "softplus"), 512)
    assert not fg.supports_fused_dsm_grad(TGrad(4, 4, 8, 2, "elu"), 512)
    assert not fg.supports_fused_dsm_grad(
        TGrad(4, 4, 8, 2, "softplus", enc_input=False), 512)
    assert not fg.supports_fused_dsm_grad(grad.double(), 512)
    # the implicit-conv line (h 256, 5 layers, 80k rows) keeps 3.3 GB
    line = TGrad(32, 32, 256, 5, "softplus")
    assert fg.workspace_bytes(line, 128 * 625) == 4 * 10 * 80_000 * 256 * 4
    assert fg.supports_fused_dsm_grad(line, 128 * 625)
    assert not fg.supports_fused_dsm_grad(line, 2_000_000)


@pytest.mark.cuda
def test_kernel_matches_plain_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs this comparison")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    tm = build_cdae("mlp-grad", input_dim=5, context_dim=6, h_dim=24, n_layers=2,
                    nonlin="softplus", device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    latent = torch.randn(3, 37, 5, generator=g, device=dev)
    ctx = torch.randn(3, 6, generator=g, device=dev)
    std = 0.3 * torch.randn(3, 37, 1, generator=g, device=dev).abs()
    eps = torch.randn(3 * 37, 5, generator=g, device=dev)
    params = list(tm.parameters())
    before = fg.FusedDSMGradFunction.launches["fused_dsm_grad_fwd"]
    a = fg.fused_cdae_dsm_grad_loss(tm, latent, ctx, std, eps=eps)
    ga = torch.autograd.grad(a, params)
    b = fg.fused_cdae_dsm_grad_loss_reference(tm, latent, ctx, std, eps=eps)
    gb = torch.autograd.grad(b, params, allow_unused=True)
    assert fg.FusedDSMGradFunction.launches["fused_dsm_grad_fwd"] == before + 1
    torch.testing.assert_close(a, b, rtol=1e-5, atol=0)
    for x, y in zip(ga, gb):
        if y is None:  # the energy head's bias
            assert not float(x.abs().max())
        else:
            assert float((x - y).norm() / y.norm()) <= 1e-4
