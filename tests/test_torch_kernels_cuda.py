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

The GEMM core both kernels share (csrc/dsm_sgemm.cuh: TMA, wgmma, a
persistent warp-specialised block) is also held alone, through its probe
entry point, against an fp64 product on the card: in both layouts the
kernels use (A and B K-contiguous; both M/N-contiguous, the weight
gradients' split-K layout) and both precisions, at M, N and K that no tile
divides, K shorter than one k-tile, d = 2 rows that TMA cannot take (the
loader's cp.async copies, counted by the library), a base that is not
16-byte aligned, several splits, and a bitwise repeat. fp32: ||C - ref|| /
||ref|| <= 5e-6 (3xTF32 keeps ~21 bits; fp32 sums of up to 2,500 terms a split in another order); bf16:
against the fp64 product of the bf16-rounded operands, <= 5e-6 (the same
rounded values, fp32 accumulation).

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


CORE_RTOL = 5e-6


def _core_case(cuda, kc, prec, M, N, K, splits, lda, ldb, offset):
    """Operands of one probe call, made on the card from a seed: A is (M, lda)
    if kc else (K, lda), B (N, ldb) if kc else (K, ldb), each starting
    ``offset`` floats into its buffer."""
    g = torch.Generator(device=cuda).manual_seed(M * 7 + N * 3 + K)
    rows_a, rows_b = (M, N) if kc else (K, K)
    abuf = torch.randn(rows_a * lda + offset, generator=g, device=cuda)
    bbuf = torch.randn(rows_b * ldb + offset, generator=g, device=cuda)
    a = abuf[offset:].view(rows_a, lda)
    b = bbuf[offset:].view(rows_b, ldb)
    kps = -(-(-(-K // splits)) // 32) * 32
    S = -(-K // kps)
    c = torch.full((S, M, N), float("nan"), device=cuda)
    return a, b, c, S


def _core_run(lib, kc, prec, M, N, K, splits, a, b, c):
    stream = torch.cuda.current_stream().cuda_stream
    # a K-contiguous B is converted first: tf32 hi and lo, rows of ceil4(K)
    scratch = torch.empty(2 * N * (-(-K // 4) * 4), device=a.device)
    err = lib.dsm_sgemm_probe(kc, prec, M, N, K, splits, a.data_ptr(),
                              a.stride(0), b.data_ptr(), b.stride(0),
                              c.data_ptr(), scratch.data_ptr(), stream)
    torch.cuda.synchronize()
    assert err == 0


def _core_reference(kc, prec, M, N, K, a, b):
    a, b = (a[:, :K], b[:, :K]) if kc else (a[:, :M], b[:, :N])
    if prec == 1:
        a, b = a.bfloat16().float(), b.bfloat16().float()
    a, b = a.double(), b.double()
    return a @ b.t() if kc else a.t() @ b


# (layout kc, M, N, K, splits, lda, ldb, offset, operands TMA cannot take)
CORE_CASES = {
    "kc-ragged": (1, 300, 200, 77, 1, 80, 80, 0, 0),
    "kc-short-k-unaligned": (1, 111, 24, 5, 1, 5, 8, 0, 1),
    "kc-d2-rows": (1, 131, 2, 24, 1, 24, 24, 0, 0),
    "kc-d2-k": (1, 257, 136, 2, 1, 2, 4, 0, 1),
    "kc-line": (1, 1000, 256, 256, 1, 256, 256, 0, 0),
    "kc-unaligned-base": (1, 129, 130, 64, 1, 64, 64, 1, 1),
    "mn-splits": (0, 136, 136, 2400, 4, 136, 136, 0, 0),
    "mn-d2": (0, 24, 2, 333, 2, 24, 2, 0, 1),
    "mn-ragged-k": (0, 200, 72, 45, 1, 200, 72, 0, 0),
    "mn-wgrad-line": (0, 256, 256, 20000, 8, 256, 256, 0, 0),
}


@pytest.mark.cuda
@pytest.mark.parametrize("prec", [0, 1], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", list(CORE_CASES))
def test_gemm_core_matches_fp64_on_cuda(cuda, case, prec):
    kc, M, N, K, splits, lda, ldb, offset, copied = CORE_CASES[case]
    lib, _ = fd.build_library()
    a, b, c, S = _core_case(cuda, kc, prec, M, N, K, splits, lda, ldb, offset)
    before = lib.dsm_sgemm_cp_async_operands()
    _core_run(lib, kc, prec, M, N, K, splits, a, b, c)
    assert lib.dsm_sgemm_cp_async_operands() - before == copied
    ref = _core_reference(kc, prec, M, N, K, a, b)
    out = c.double().sum(0) if S > 1 else c[0].double()
    assert bool(torch.isfinite(c).all())   # every split's partial written
    assert float((out - ref).norm() / ref.norm()) <= CORE_RTOL


@pytest.mark.cuda
@pytest.mark.parametrize("prec", [0, 1], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", ["kc-line", "mn-splits", "mn-d2"])
def test_gemm_core_repeats_bitwise_on_cuda(cuda, case, prec):
    kc, M, N, K, splits, lda, ldb, offset, _ = CORE_CASES[case]
    lib, _ = fd.build_library()
    a, b, c, _ = _core_case(cuda, kc, prec, M, N, K, splits, lda, ldb, offset)
    c2 = c.clone()
    _core_run(lib, kc, prec, M, N, K, splits, a, b, c)
    _core_run(lib, kc, prec, M, N, K, splits, a, b, c2)
    assert torch.equal(c, c2)


@pytest.mark.cuda
@pytest.mark.parametrize("cdae", ["mlp-res", "mlp-grad"])
def test_kernel_with_split_weight_gradients_on_cuda(cuda, cdae):
    """2,400 rows at h 136: every weight gradient takes several splits; the
    packed l0 weight (stride in + 1) and ragged tiles everywhere."""
    kernel, plain, launches, entry = OPS[cdae]
    tm = build_cdae(cdae, input_dim=32, context_dim=32, h_dim=136, n_layers=3,
                    nonlin="tanh", device=cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    latent = torch.randn(8, 300, 32, generator=g, device=cuda)
    ctx = torch.randn(8, 32, generator=g, device=cuda)
    std = 0.3 * torch.randn(8, 300, 1, generator=g, device=cuda).abs()
    eps = torch.randn(8 * 300, 32, generator=g, device=cuda)
    params = list(tm.parameters())
    before = launches[entry]
    a = kernel(tm, latent, ctx, std, eps=eps)
    ga = torch.autograd.grad(a, params)
    b = plain(tm, latent, ctx, std, eps=eps)
    gb = torch.autograd.grad(b, params, allow_unused=True)
    assert launches[entry] == before + 1
    assert abs(float(a) - float(b)) <= LOSS_RTOL * abs(float(b))
    for x, y in zip(ga, gb):
        if y is None:
            assert not float(x.abs().max())
        else:
            assert float((x - y).norm() / y.norm()) <= GRAD_RTOL
