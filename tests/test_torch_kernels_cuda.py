"""The hand-written Hopper kernels against their plain PyTorch versions, on
the card (marked ``cuda``; each skips without a GPU).

This file imports torch, numpy, pytest and the port only, so it collects
on a machine without the JAX package's dependencies:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda -q

Each case builds a small cdae on the card, runs the op once through its
kernel (the launch counter must rise by one) and once through its plain
version on the same inputs, and holds loss and every parameter gradient to
the bounds of chip_smoke.py: loss relative error <= 1e-5, gradient
||kernel - plain|| / ||plain|| <= 1e-4. The shapes are ragged (no dimension
divides a tile); the last case has the toy line's d = 2 latent and context
columns, whose rows are not 16-byte aligned.

The grad kernel's bf16 mode (``compute_dtype="bfloat16"``) is held against
its bf16 plain version, on a ragged shape and at the implicit-conv line's
(n = 128 x 625, d 32, h 256, 5 layers), forward and backward, and must
repeat bit for bit. Both round the same fp32 values at the same places and
differ only in the order of the fp32 sums: loss relative error <= 1e-6,
gradient rel-norm <= 1.5e-3 (chip_smoke.py phase 13a's bounds, which say
why). The control, the fp32 kernel against the same bf16 plain version,
must be past the gradient bound.
"""

import pytest
import torch

from ardae_tpu_torch.models.registry import build_cdae
from ardae_tpu_torch.ops import fused_dsm as fd
from ardae_tpu_torch.ops import fused_dsm_grad as fg

LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-4
BF16_LOSS_RTOL, BF16_GRAD_RTOL = 1e-6, 1.5e-3

OPS = {
    "mlp-res": (fd.fused_cdae_dsm_loss, fd.fused_cdae_dsm_loss_reference,
                fd.FusedDSMFunction.launches, "fused_dsm_fwd"),
    "mlp-grad": (fg.fused_cdae_dsm_grad_loss, fg.fused_cdae_dsm_grad_loss_reference,
                 fg.FusedDSMGradFunction.launches, "fused_dsm_grad_fwd"),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cdae,d,ctx_dim", [("mlp-res", 5, 6), ("mlp-grad", 5, 6),
                                            ("mlp-grad", 2, 2)])
def test_kernel_matches_plain_on_cuda(cuda, cdae, d, ctx_dim):
    kernel, plain, launches, entry = OPS[cdae]
    tm = build_cdae(cdae, input_dim=d, context_dim=ctx_dim, h_dim=24, n_layers=2,
                    nonlin="softplus", device=cuda)
    g = torch.Generator(device=cuda).manual_seed(0)
    latent = torch.randn(3, 37, d, generator=g, device=cuda)
    ctx = torch.randn(3, ctx_dim, generator=g, device=cuda)
    std = 0.3 * torch.randn(3, 37, 1, generator=g, device=cuda).abs()
    eps = torch.randn(3 * 37, d, generator=g, device=cuda)
    params = list(tm.parameters())
    before = launches[entry]
    a = kernel(tm, latent, ctx, std, eps=eps)
    ga = torch.autograd.grad(a, params)
    b = plain(tm, latent, ctx, std, eps=eps)
    gb = torch.autograd.grad(b, params, allow_unused=True)
    assert launches[entry] == before + 1
    assert abs(float(a) - float(b)) <= LOSS_RTOL * abs(float(b))
    for x, y in zip(ga, gb):
        if y is None:  # the grad-style energy head's bias
            assert not float(x.abs().max())
        else:
            assert float((x - y).norm() / y.norm()) <= GRAD_RTOL


@pytest.mark.cuda
@pytest.mark.parametrize("bsz,ssz,d,h,layers", [(3, 37, 5, 24, 2),
                                                (128, 625, 32, 256, 5)])
def test_bf16_kernel_matches_plain_on_cuda(cuda, bsz, ssz, d, h, layers):
    tm = build_cdae("mlp-grad", input_dim=d, context_dim=d, h_dim=h,
                    n_layers=layers, nonlin="softplus", device=cuda)
    g = torch.Generator(device=cuda).manual_seed(0)
    latent = torch.randn(bsz, ssz, d, generator=g, device=cuda)
    ctx = torch.randn(bsz, d, generator=g, device=cuda)
    std = 0.3 * torch.randn(bsz, ssz, 1, generator=g, device=cuda).abs()
    eps = torch.randn(bsz * ssz, d, generator=g, device=cuda)
    params = list(tm.parameters())
    launches = fg.FusedDSMGradBF16Function.launches
    fp32_before = dict(fg.FusedDSMGradFunction.launches)
    before = dict(launches)
    runs = []
    for _ in range(2):
        a = fg.fused_cdae_dsm_grad_loss(tm, latent, ctx, std, eps=eps,
                                        compute_dtype="bfloat16")
        runs.append([a.detach()] + list(torch.autograd.grad(a, params)))
    assert launches == {k: v + 2 for k, v in before.items()}
    assert fg.FusedDSMGradFunction.launches == fp32_before
    assert all(torch.equal(x, y) for x, y in zip(*runs))  # bitwise repeat
    b = fg.fused_cdae_dsm_grad_loss_reference(tm, latent, ctx, std, eps=eps,
                                              compute_dtype="bfloat16")
    gb = torch.autograd.grad(b, params, allow_unused=True)
    a, ga = runs[0][0], runs[0][1:]
    assert abs(float(a) - float(b)) <= BF16_LOSS_RTOL * abs(float(b))
    for x, y in zip(ga, gb):
        if y is None or not float(y.norm()):  # the energy head's bias
            assert not float(x.abs().max())
        else:
            assert float((x - y).norm() / y.norm()) <= BF16_GRAD_RTOL
    # the control: the fp32 kernel is past the bound from the bf16 plain version
    c = fg.fused_cdae_dsm_grad_loss(tm, latent, ctx, std, eps=eps)
    gc = torch.autograd.grad(c, params)
    assert max(float((x - y).norm() / y.norm()) for x, y in zip(gc, gb)
               if y is not None and float(y.norm())) > BF16_GRAD_RTOL
