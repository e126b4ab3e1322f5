"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each failure exits non-zero):
  1. needs a CUDA device; prints the card's name and power limit;
  2. builds the hand-written kernels from ardae_tpu_torch/csrc/ with nvcc for
     sm_90a (into build/), one nvcc per source, all started together; prints
     each kernel instantiation's registers, shared memory and spills (from
     -Xptxas -v) and the GEMM ring's dynamic shared memory, and counts the
     tensor-core instructions (HMMA) in each library's SASS with cuobjdump,
     where the toolkit has it: a count of 0 fails;
  3. holds the res-style fused DSM kernel (forward and backward) against its
     plain PyTorch version, fp32 with TF32 off for every matmul and
     convolution: at the flagship shape (n = 128 x 625 rows, d 32, h 512, 5
     layers, softplus) and at one ragged small shape per activation; at the
     flagship shape it also runs the kernel twice and fails unless loss and
     gradients are bitwise equal; and at the shape one rank of phase 11a
     gives it (n = 64 x 625 = 40,000 rows, the flagship's data shard);
  3b. the same for the grad-style (second-order) kernel: at the
     implicit-conv line's shape (n = 128 x 625, d 32, h 256, 5 layers,
     softplus; mnist-concat's too), at the 25-gaussians line's (n = 512 x
     256, d 2, h 256, 3 layers, softplus: rows of 2 floats, not 16-byte
     aligned), at the shape one rank of phase 11b gives it (n = 128 x 125
     = 16,000 rows, implicit conv's sample shard) and at ragged small
     shapes, d 2 among them. Bounds for both:
     loss relative error <= 1e-5; every gradient, d/d(ctx_l0) included,
     ||kernel - plain|| / ||plain|| <= 1e-4 (3xTF32 products, fp32 sums in
     another order);
  4. times the res-style kernel and its plain version at the flagship shape
     and its 11a shard,
  4b. and the grad-style pair at the implicit-conv and 25-gaussians shapes
     and the 11b shard
     (CUDA events, warm-up, median of 7, in the order plain, kernel,
     kernel, plain), and
     the chain's matrix products alone as torch.matmul calls (fp32, TF32
     off: the yardstick library_ms, which the port never calls);
  5. drives the main path, cli.ivae_ardae with the flags of the flagship
     dbMNIST line (scripts/run_vae_dbmnist.sh:35) plus --use-kernels, for 6
     steps,
  5b. and with the flags of the implicit-conv line (:41, mnist-conv +
     mlp-grad) plus --use-kernels, for 6 steps. Each run starts with every
     launch counter at 0 and checks that its kernel launched once per cdae
     update and the other kernel never, that every logged loss is finite,
     that the parameters moved, and that the trained encoder gives finite
     latents of the expected shape;
  5d. the same for the mnist-concat line (:47, mnist-concat + mlp-grad), 6
     steps with --use-kernels;
  5e. and for the 25-gaussians line (scripts/run_vae_25gaussians.sh,
     mlp-concat + mlp-grad, d 2) at --toy-train-size 262144 (full widths
     and batch), 6 steps with --use-kernels and then the toy final dump
     (two chunks of 131,072 rows, reconstructed and generated): its
     launches are checked over the whole run, so the dump may launch none,
     and the dump must log its rows and no non-finite value;
  5c. drives the flagship line's flags with --model changed to each of the
     other four resconv fc heads (resconv: mlp; resconvct-res2: res-mlp;
     resconv-res3: res-wn-mlp-lin; resconvct-res4: res-mlp-lin), 4 steps
     each with --use-kernels (the second log interval is past the
     warm-up); each run starts with every launch counter at 0 and checks 2
     fwd + 2 bwd res launches a step and no grad launch, finite losses and
     moved parameters;
  5f. drives the hierarchical-aux lines with the hidden1a context, plus
     --use-kernels --vis-interval 0, each run's launch counters at 0 just
     before and read just after: auxresconvct (:38, mlp-res, context 450
     wide), 6 steps, 2 fwd + 2 bwd res launches a step and no grad one;
  5g. auxconv (:44, mlp-grad, context 1,600) and
  5h. auxmnist (:50, mlp-grad, context 600), 6 steps each, 1 + 1 grad
     launches a step and no res one;
  5i. auxresconvct-clip on :38's flags, 4 steps, as 5c. Each checks the
     context width the driver logs against context_dim_for, finite losses
     and moved parameters;
  6b. on the trained auxmnist IVAE of 5h: a checkpoint save and load of
     its state (model, cdae, both optimizers, generator) bit for bit on the
     card and the CPU, and logprob_iws / cov_gaussian_iws_from_draws with
     the aux jitter 1e-5, card vs CPU (16 val items, the same draws, TF32
     off): per item |card - CPU| <= 1e-3 nats;
  6. drives the flagship pipeline through cli.ivae_ardae with the line's
     flags plus --use-kernels, evals and checkpoints every 2 steps, IWS-256
     at eval batch 128, in one experiment directory: a 4-step run (val
     evals over the whole 5k val split at iters 2 and 4, best-checkpoint,
     checkpoint, the test eval over the whole 10k test split from
     best-checkpoint), a run that resumes it up to iter 6 and must log only
     iter 6, and a --train-mode final run that trains to the best
     checkpoint's iteration less one on train+val and writes
     final-checkpoint. Each run starts with every launch counter at 0 and
     checks 2 fwd + 2 bwd res launches a step (none during eval), that
     every logged IWS is finite and negative, and that its checkpoint files
     exist; it prints each eval's seconds and items/s. It then times a save
     of the trained state and its load into fresh modules on the card and
     on the CPU, each bit for bit equal to the saved tensors, and holds
     logprob_iws and cov_gaussian_iws_from_draws on the card against the
     same functions on the CPU (the trained flagship model, 16 val items,
     the same injected draws, TF32 off): per item |card - CPU| <= 1e-3
     nats.
  7. drives the baseline (Gaussian-posterior) VAE driver, cli.vae, which
     runs no kernel: the resconv line's flags (scripts/run_vae_dbmnist.sh:16
     plus --vis-interval 0) in one experiment directory, a 4-step run with
     val evals at iters 2 and 4 over the whole 5k val split (IWAE-256 at
     eval batch 128), best-checkpoint, checkpoint and the test eval over
     10k, a resume to iter 6 that must log only iter 6, and a --train-mode
     final run that writes final-checkpoint; then 6 steps each of the conv
     (:22) and mlp (:28) lines with no eval. Every run starts with the
     launch counters at 0 and must leave them there; each prints its
     ms/step, each eval its seconds and items/s. It times a save and a load
     of the trained state (card and CPU, bit for bit) and holds
     logprob_iwae and vae_loss(reduce="per_item") on the card against the
     same functions on the CPU (the trained resconv model, 16 val items,
     the same injected draws): per item |card - CPU| <= 1e-3 nats.
  7c. drives cli.vae on the aux baseline lines (auxresconv :19, auxconv
     :25, auxmnist :31, plus --vis-interval 0), 6 steps each, no launch;
     then aux_logprob_iwae and aux_vae_loss(reduce="per_item") on the card
     against the CPU on the trained auxresconv baseline, <= 1e-3 nats per
     item;
  7b. drives cli.vae --model toy on the 25-gaussians data of 5e (z 2, h
     256, 2 layers, bs 512): 6 steps and the toy final dump, no launch.
  8. runs the published lines flag for flag, only the depth cut, with the
     drivers' periodic visualization and weight averaging on. Each run
     replaces the drivers' writer with a recording one (make_writer in
     cli/common.py) and checks its tags against VIS_TAGS (the JAX drivers'
     panels; tests/test_torch_visualization.py holds the lists against
     them), every image CHW float32 in [0, 1], every value finite, and how
     many visualizations ran (each one's seconds printed); a monitor
     around update_weight_avg checks that the averaged model equals the
     live one before the start and differs after it. 8a: the flagship
     line (:35) with --use-kernels --m-weight-avg polyak
     --m-weight-avg-start 2 --vis-interval 2, evals and checkpoints every 2
     steps, 6 steps: 2 fwd + 2 bwd res launches a step, the three val
     IWS-256 evals on the averaged model, then the checkpoint roundtrip with
     the averaging slot (bit for bit, card and CPU, its MiB printed); 8b:
     implicit conv (:41) with --use-kernels --m-weight-avg swa
     --m-weight-avg-start 2 --vis-interval 2, 6 steps, 1 + 1 grad launches
     a step; 8c: the 25-gaussians line of 5e with its --vis-interval 100
     cut to 3, 6 steps with --use-kernels, the final panels and the dump;
     8d: the resconv baseline (:16) with --weight-avg polyak
     --weight-avg-start 2 --vis-interval 2, and cli.vae --model toy-maf on
     5e's data with --vis-interval 2 and the dump, 6 steps each, no
     launch. 8a and 8b time one update_weight_avg call (CUDA events,
     median of 21); 8e drives the flagship line as phase 5 does, 10 steps
     with --use-kernels, without averaging and with Polyak from step 0, in
     the turns none, polyak, polyak, none, and prints each turn's steady
     ms/step (steps 5-10).
  9. runs the notebook workloads and the score-net and toy-encoder zoo
     that no driver builds. 9a: the three examples at their published
     widths (ardae_tpu_torch/examples/, the JAX scripts' defaults) with
     the iteration counts of tests/test_examples.py, each timed (ms per
     iteration, CUDA-synchronised): dae_toy grad and res, 600 iterations,
     finite losses and score field; ardae_toy grad, 1,500, final loss
     below 1 and the score at sigma 1 from (4.5, 4.5), (-4.5, -4.5) and
     (4.5, -4.5) pointing toward the swiss roll; ardae_fit, 2,000 with
     alpha annealed over 400, the mean energy_func4 of 4,000 samples 0.5
     below that of N(0, I) points. Then each example's main() at a cut
     --iterations, its PNGs read back (signature, CRCs, 500 x 500 RGB); and
     one DSM step of each of the six unconditional / fixed-sigma
     constructors (the CDAEs through cdae_loss) from one set of weights and
     one injected eps, card against CPU: loss rel <= 1e-5, every gradient
     rel-norm <= 1e-4. 9b: each of the thirteen toy-encoder fusions
     (ToyIPVAE enc_type) at scripts/run_vae_25gaussians.sh's widths (noise
     10, h 256, 2 layers, relu, z 2) trains 4 joint steps through
     train_chunk with that line's StepConfig and cdae (mlp-grad, h 256, 3
     layers, softplus, lt0, bs 512, nz_cdae 256, std-scale 10000) and the
     grad kernel: launch counters at 0 before each run, 1 + 1 grad launches
     a step and no res one, finite losses, moved parameters; before it,
     sample_z card against CPU from the same weights and eps (rel-norm <=
     1e-5). 9c: the legacy DAEs MLPDAE and MLPCDAE, loss, gradients and
     score card against CPU (as 9a).
  10. runs the canonical sweep's bf16 lines (scripts/run_canonical_sweep.sh
     BF16 = --cdae-compute-dtype bfloat16 --model-compute-dtype bfloat16,
     BF16_VAE = --model-compute-dtype bfloat16) at their published widths
     and batch, 6 steps each, launch counters at 0 before each run and read
     after: 10a the flagship (:35) + BF16, 10b implicit conv (:41) + BF16
     (the grad style's double backward in bf16), 10c mnist-concat (:47) +
     BF16, all three without --use-kernels (the kernels are fp32 only, and a
     bf16 phase A refuses them) and so with no launch; 10d the resconv,
     conv and mlp baselines (:16, :22, :28) + BF16_VAE; 10e the round-5
     bf16 aux row of VALIDATION.md (:38's flags with auxresconvct-clip and
     --m-lr 0.0003) + BF16, hidden1a context, and the aux baseline (:19) +
     BF16_VAE; 10f the flagship and implicit conv with
     --model-compute-dtype bfloat16 --use-kernels: phase A fp32 through
     the res (2 + 2 launches a step) and grad (1 + 1) kernels, phase B
     bf16. Each run: finite losses and sigmas, fp32 master parameters,
     moved parameters. For 10a and 10b, one joint step in bf16 at the
     line's widths and batch from the same weights, batches and injected
     draws on the card, on the CPU and in fp32 on the CPU: the metrics card
     vs CPU within 2e-2 relative, every gradient handed to an optimizer
     within 5e-2 of the CPU's plus twice the CPU's bf16-to-fp32 distance.
     It prints each line's ms/step per log interval beside its fp32 twin's
     (phases 5, 5b, 5d, 5i, 7, 7c).
  11. runs data and sample parallelism on the one card, the ranks sharing
     cuda:0 over gloo (a correctness phase, not a scaling measurement),
     each rank spawned by ardae_tpu_torch/parallel/launch.py with rank 0
     in this process and training through parallel/workers.py: 11a the
     flagship (:35) at its published widths with --use-kernels on
     make_mesh(2), 4 steps through train_chunk, then as a world of one
     from the same seed: the res kernel on 40,000-row shards (2 + 2
     launches a step a rank, counted by each rank from 0, the rows of rank
     0's launches recorded), the replicas bit for bit equal, every step's
     metrics within PAR_METRICS of the world of one's and, after steps 1
     and 4, the parameter update and the optimizer state (rel-norm over a
     module) within max(PAR_FLOOR, twice the same rel-norm between the
     world of one with the kernel and with its plain version); every run
     of 11a-11c, each rank's too, uses torch's deterministic algorithms,
     and the world of one, run twice, must repeat bit for bit; 11b
     implicit conv (:41) on sample_parallel_mesh(1, 5), the grad kernel on
     16,000-row shards, as 11a; 11c the conv baseline (:22) through
     vae_step on make_mesh(2), no launch, as 11a within PAR_FLOOR (its
     world of one repeats, so no control);
     11d graft_entry.dryrun_multichip(4) on cuda:0 four times (dp 4, then
     dp 2 x sp 2); 11e the flagship line through cli.ivae_ardae with
     --use-kernels --profile-dir at phase 5's depth: the Chrome trace of
     steps 3-4 parses and names fused_dsm_fwd / fused_dsm_bwd and their
     kernels (loss_partial_kernel, dloss_dr_kernel), 2 + 2 launches a step.
     Each prints its worst differences and ms/step per rank beside the
     card line.
  12. mnist32, the new bounds, the non-Gaussian DSM noise and the
     driverless modules. 12a: the mnist-concat line (:47) with --dataset
     mnist32 --nheight 32 through cli.ivae_ardae with --use-kernels, 6
     steps (the grad kernel 1 + 1 launches a step at n = 128 x 625, d 32,
     h 256, 5 layers), a val IWS-1024 eval after step 6 and the test eval,
     each finite and negative, at eval batch 128; the mlp baseline (:28)
     on mnist32 through cli.vae, 6 steps, no launch; the splits checked
     gray and 1,024 wide. 12b: logprob_kde, logprob_diag and logprob_prior
     on 12a's trained model at z 32 and S 1024 on 16 test items, card
     against CPU from the same draws (per item <= 1e-3 nats), each
     bound's card ms. 12c: both kernels against their plain versions on a
     Laplace and a uniform draw (phase 3's bounds) at the flagship and
     implicit-conv shapes; then 4 joint steps through train_chunk
     (parallel/workers.py, a world of one, deterministic algorithms) with
     StepConfig(noise_type=..., use_kernels=True) of the flagship with
     Laplace and with uniform noise (2 + 2 res launches a step) and of
     implicit conv with Laplace noise (1 + 1 grad), each against the same
     steps with use_kernels False: the flagship's metrics every step,
     implicit conv's at step 1 (std-scale 10000 makes its later steps
     drift as phase 11's control does), within PAR_METRICS. 12d: CWNconv2d,
     WNBilinear, the relaxed samplers, the Jacobian-clamping loss and
     shuffle, one small call each on the card against the CPU.
Then it prints the kernels' JSON line (each kernel's launches over the
main path's runs, 5-5i but 5c, 8a-8c, 9b, 10f, 11a, 11b, 11e, 12a and
12c's train_chunk runs, and by line under "launched_by"; and at its
first line's shape its error, times, FLOP,
launches per step and bound, the kernel's other shapes beside them under
"at_<line>": the grad kernel's "at_25-gaussians" and each kernel's phase
11 shard, "at_flagship-dp2-shard" and "at_implicit-conv-sp5-shard"; the
bound is the larger of
3 x FLOP over the 495 TFLOP/s TF32 tensor-core peak, the kernel's products
being 3xTF32, and its inputs' and outputs' bytes over 3.35 TB/s; beside it
the fp32 CUDA-core bound, FLOP over 67 TFLOP/s; H100 SXM peaks at 700 W),
the card line, and as its last line {"ok": true, "device": {...}}.
"""

import contextlib
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

FLAGSHIP_ARGS = [
    "--dataset", "dbmnist-val5k", "--nheight", "28", "--nchannels", "1",
    "--train-batch-size", "128", "--eval-batch-size", "1",
    "--m-optimizer", "adam", "--m-momentum", "0.9", "--m-beta1", "0.9",
    "--d-optimizer", "rmsprop", "--d-momentum", "0.9", "--d-beta1", "0.9",
    "--train-nstd-cdae", "1", "--train-nz-cdae", "625", "--train-nz-model", "1",
    "--model", "resconvct-res", "--model-z-dim", "32", "--model-h-dim", "512",
    "--model-n-layers", "1", "--model-nonlin", "elu", "--model-n-dim", "100",
    "--model-clip-z0-logvar", "none", "--model-clip-z-logvar", "none",
    "--cdae", "mlp-res", "--cdae-h-dim", "512", "--cdae-n-layers", "5",
    "--cdae-nonlin", "softplus", "--cdae-ctx-type", "lt0", "--exp-num", "1",
    "--m-lr", "0.001", "--d-lr", "0.0001", "--beta-init", "1.0",
    "--beta-fin", "1.0", "--beta-annealing", "0", "--delta", "0.1",
    "--std-scale", "100", "--num-cdae-updates", "2", "--epochs", "6400",
    "--iws-samples", "256", "--m-weight-avg", "none",
    "--m-weight-avg-start", "-1", "--m-weight-avg-decay", "0.998",
    "--vis-interval", "50000", "--train-mode", "train",
]
IMPLICIT_CONV_ARGS = [
    "--dataset", "dbmnist-val5k", "--nheight", "28", "--nchannels", "1",
    "--train-batch-size", "128", "--eval-batch-size", "1",
    "--m-optimizer", "adam", "--m-momentum", "0.5", "--m-beta1", "0.5",
    "--d-optimizer", "rmsprop", "--d-momentum", "0.5", "--d-beta1", "0.5",
    "--train-nstd-cdae", "1", "--train-nz-cdae", "625", "--train-nz-model", "1",
    "--model", "mnist-conv", "--model-z-dim", "32", "--model-h-dim", "0",
    "--model-n-layers", "0", "--model-nonlin", "softplus", "--model-n-dim", "100",
    "--model-clip-z0-logvar", "none", "--model-clip-z-logvar", "none",
    "--cdae", "mlp-grad", "--cdae-h-dim", "256", "--cdae-n-layers", "5",
    "--cdae-nonlin", "softplus", "--cdae-ctx-type", "lt0", "--exp-num", "1",
    "--m-lr", "0.0001", "--d-lr", "0.0001", "--beta-init", "1.0",
    "--beta-fin", "1.0", "--beta-annealing", "0", "--delta", "0.1",
    "--std-scale", "10000", "--num-cdae-updates", "1", "--epochs", "6400",
    "--iws-samples", "1024", "--m-weight-avg", "none",
    "--m-weight-avg-start", "-1", "--m-weight-avg-decay", "0.998",
    "--vis-interval", "50000", "--train-mode", "train",
]
# scripts/run_vae_dbmnist.sh:47, the mnist-concat line
MNIST_CONCAT_ARGS = list(IMPLICIT_CONV_ARGS)
for _flag, _value in (("--model", "mnist-concat"), ("--model-h-dim", "300"),
                      ("--model-n-layers", "2")):
    MNIST_CONCAT_ARGS[MNIST_CONCAT_ARGS.index(_flag) + 1] = _value
# scripts/run_vae_25gaussians.sh, the 25-gaussians line, depth cut by
# --toy-train-size (two whole dump chunks)
TOY_DATA = ["--dataset", "25gaussians", "--nheight", "1", "--nchannels", "2",
            "--toy-train-size", "262144"]
TOY_ARGS = TOY_DATA + [
    "--model", "mlp-concat", "--model-z-dim", "2", "--model-h-dim", "256",
    "--model-n-layers", "2", "--model-nonlin", "relu", "--model-n-dim", "10",
    "--model-clip-z0-logvar", "none", "--model-clip-z-logvar", "none",
    "--cdae", "mlp-grad", "--cdae-h-dim", "256", "--cdae-n-layers", "3",
    "--cdae-nonlin", "softplus", "--cdae-ctx-type", "lt0",
    "--train-batch-size", "512", "--eval-batch-size", "1",
    "--train-nz-cdae", "256", "--train-nz-model", "1", "--delta", "0.1",
    "--std-scale", "10000", "--num-cdae-updates", "1", "--m-lr", "0.0001",
    "--m-optimizer", "adam", "--m-momentum", "0.5", "--m-beta1", "0.5",
    "--d-lr", "0.0001", "--d-optimizer", "rmsprop", "--d-momentum", "0.5",
    "--d-beta1", "0.5", "--epochs", "16", "--iws-samples", "64", "--exp-num", "1"]
# phase 7b: cli.vae --model toy on the same data and widths
TOY_VAE_ARGS = TOY_DATA + [
    "--model", "toy", "--model-z-dim", "2", "--model-h-dim", "256",
    "--model-n-layers", "2", "--model-nonlin", "softplus",
    "--train-batch-size", "512", "--optimizer", "adam", "--beta1", "0.5",
    "--lr", "0.001", "--epochs", "1", "--iws-samples", "8"]


def with_flags(args, **flags):
    """``args`` with each ``--flag-name`` set to its value."""
    out = list(args)
    for k, v in flags.items():
        out[out.index("--" + k.replace("_", "-")) + 1] = v
    return out


# scripts/run_vae_dbmnist.sh :38 (auxresconvct + mlp-res), :44 (auxconv +
# mlp-grad) and :50 (auxmnist + mlp-grad): the hierarchical-aux lines, each
# with the hidden1a context, plus --vis-interval 0
AUX_LINES = {
    "auxresconvct": with_flags(
        FLAGSHIP_ARGS, model="auxresconvct", model_h_dim="0", model_n_layers="0",
        cdae_ctx_type="hidden1a", beta_init="0.0001", beta_annealing="50000"),
    "auxconv": with_flags(IMPLICIT_CONV_ARGS, model="auxconv",
                          cdae_ctx_type="hidden1a"),
    "auxmnist": with_flags(MNIST_CONCAT_ARGS, model="auxmnist",
                           cdae_ctx_type="hidden1a"),
}
AUX_LINES = {k: v + ["--vis-interval", "0"] for k, v in AUX_LINES.items()}
# phase 5i: the -clip twin on :38's flags
AUX_CLIP_ARGS = with_flags(AUX_LINES["auxresconvct"], model="auxresconvct-clip")
SMOKE_ARGS = ["--log-interval", "2", "--eval-iws-interval", "0",
              "--ckpt-interval", "0", "--skip-final-test-eval", "--no-resume"]
STEPS, HEAD_STEPS = 6, 4
# phase 11: steps of each mesh run. A mesh run sums in another order than
# the world of one (a rank's row blocks, then the world's average), and
# four steps amplify that: a first RMSprop or Adam step moves ~lr * sign(g)
# wherever g sits at the rounding level, and std-scale 10000 feeds that
# back (the cdae update of implicit conv's plain version is 0.145 off the
# kernel's by step 4). So after step 1 and after the last, each rel-norm
# (a module's parameter update, its optimizer state) may be PAR_FLOOR or
# twice the same rel-norm between two valid runs of the world of one, the
# kernel against its plain version, whichever is larger; every step's
# metrics within PAR_METRICS relative. The runs use deterministic
# algorithms: with cuDNN's and torch's default ones the card's world of one
# drifts from its own repeat as far as the mesh does (2.5e-3 of the
# flagship's model update by step 4), and the comparison would be a draw
# that differs from call to call
PAR_STEPS, PAR_FLOOR, PAR_METRICS = 4, 1e-3, 1e-3
# phase 5c: the other four resconv fc heads on the flagship line's flags
HEADS = {"resconv": "mlp", "resconvct-res2": "res-mlp",
         "resconv-res3": "res-wn-mlp-lin", "resconvct-res4": "res-mlp-lin"}
# phase 7: the baseline lines of scripts/run_vae_dbmnist.sh (:16, :22, :28)
_BASELINE = [
    "--dataset", "dbmnist-val5k", "--nheight", "28", "--nchannels", "1",
    "--train-batch-size", "128", "--eval-batch-size", "32",
    "--model-z-dim", "32", "--model-n-dim", "0", "--model-clip-logvar", "none",
    "--exp-num", "1", "--lr", "0.0001", "--beta-fin", "1.0",
    "--beta-annealing", "0", "--eval-iws-interval", "5000", "--iws-samples", "256",
    "--weight-avg", "none", "--weight-avg-start", "-1",
    "--weight-avg-decay", "0.998", "--log-interval", "100",
    "--vis-interval", "10000", "--ckpt-interval", "5000", "--train-mode", "train",
    "--vis-interval", "0"]
BASELINE_LINES = {
    "resconv": _BASELINE + [
        "--optimizer", "adam", "--momentum", "0.9", "--beta1", "0.9",
        "--model", "resconv", "--model-h-dim", "0", "--model-n-layers", "0",
        "--model-nonlin", "elu", "--beta-init", "0.0001", "--epochs", "6400"],
    "conv": _BASELINE + [
        "--optimizer", "adam", "--momentum", "0.5", "--beta1", "0.5",
        "--model", "conv", "--model-h-dim", "0", "--model-n-layers", "0",
        "--model-nonlin", "softplus", "--beta-init", "1.0", "--epochs", "4700"],
    "mlp": _BASELINE + [
        "--optimizer", "adam", "--momentum", "0.5", "--beta1", "0.5",
        "--model", "mnist", "--model-h-dim", "300", "--model-n-layers", "2",
        "--model-nonlin", "softplus", "--beta-init", "1.0", "--epochs", "4700"],
}
# phase 7c: the aux baseline lines (:19, :25, :31), z0 width 100
BASELINE_LINES.update({
    "auxresconv": with_flags(BASELINE_LINES["resconv"], model="auxresconv")
    + ["--model-n-dim", "100"],
    "auxconv": with_flags(BASELINE_LINES["conv"], model="auxconv")
    + ["--model-n-dim", "100"],
    "auxmnist": with_flags(BASELINE_LINES["mlp"], model="auxmnist")
    + ["--model-n-dim", "100"],
})
BASELINE_MODELS = {  # build_vae_model arguments of each line
    "resconv": dict(name="resconv", z_dim=32, nonlin="elu"),
    "conv": dict(name="conv", z_dim=32, nonlin="softplus"),
    "mlp": dict(name="mnist", z_dim=32, h_dim=300, n_layers=2, nonlin="softplus"),
    "auxresconv": dict(name="auxresconv", z_dim=32, n_dim=100, nonlin="elu"),
    "auxconv": dict(name="auxconv", z_dim=32, n_dim=100, nonlin="softplus"),
    "auxmnist": dict(name="auxmnist", z_dim=32, h_dim=300, n_layers=2, n_dim=100,
                     nonlin="softplus"),
}
# phase 8: the published lines' own flags, depth cut: 8a the flagship
# (:35) with Polyak from step 2, panels every 2 steps, evals and checkpoints
# every 2 steps (no test eval); 8b implicit conv (:41) with SWA from step 2
# and panels every 2; 8c 25-gaussians with its --vis-interval 100 cut to 3;
# 8d the resconv baseline (:16) with Polyak and panels every 2, and cli.vae
# --model toy-maf on 8c's data with panels every 2
POLYAK = with_flags(FLAGSHIP_ARGS, m_weight_avg="polyak", m_weight_avg_start="2",
                    vis_interval="2")
SWA = with_flags(IMPLICIT_CONV_ARGS, m_weight_avg="swa", m_weight_avg_start="2",
                 vis_interval="2")
TOY_VIS = TOY_ARGS + ["--vis-interval", "3"]
BASELINE_POLYAK = with_flags(BASELINE_LINES["resconv"], weight_avg="polyak",
                             weight_avg_start="2") + ["--vis-interval", "2"]
TOY_MAF_ARGS = with_flags(TOY_VAE_ARGS, model="toy-maf") + ["--vis-interval", "2"]
# phase 10: the canonical sweep's bf16 lines (scripts/run_canonical_sweep.sh
# BF16 on :35, :41, :47; BF16_VAE on :16, :22, :28), published widths and
# batch, depth cut; 10e VALIDATION.md's round-5 bf16 aux row (:38's flags,
# auxresconvct-clip, --m-lr 0.0003) and the aux baseline :19 in bf16
BF16 = ["--cdae-compute-dtype", "bfloat16", "--model-compute-dtype", "bfloat16"]
BF16_VAE = ["--model-compute-dtype", "bfloat16"]
AUX_BF16_ARGS = with_flags(AUX_LINES["auxresconvct"], model="auxresconvct-clip",
                           m_lr="0.0003") + BF16
# 10a / 10b card vs CPU: one joint step at the line's widths and batch
BF16_CHECK_BS = 128
BF16_RTOL, BF16_GRAD_RTOL = 2e-2, 5e-2


# the tags of one visualization (the JAX drivers' panels, at train mode;
# tests/test_torch_visualization.py holds each list against the JAX driver):
# by driver and data, the images and histograms and the encoder scalars
_IVAE_VIS = {("scalar", "train/enc/logvar_qz/mean/step"),
             ("scalar", "train/enc/logvar_qz/median/step"),
             ("histogram", "train/enc/logvar_qz/hist/step"),
             ("histogram", "traintrain/enc/logvar_qz/hist/item0/step"),
             ("histogram", "traintrain/enc/logvar_qz/hist/item1/step"),
             ("image", "train/latent/scatter"), ("image", "train/gt_latent/heatmap"),
             ("image", "train/latent/heatmap"), ("image", "train/alllatent/heatmap")}
_TOY_PANELS = {("image", "train/data-recon-gen/scatter"),
               ("image", "train/data-recon-gen/heatmap")}
_GRIDS = {("image", "train/data-recon-gen/sample"),
          ("image", "train/data-recon-gen/mean")}
_LATENT = {("image", "train/latent/scatter"), ("image", "train/latent/heatmap")}
VIS_TAGS = {
    ("ivae", "mnist"): _IVAE_VIS | _GRIDS,
    ("ivae", "toy"): _IVAE_VIS | _TOY_PANELS | {("image", "train/gen/heatmap")},
    ("vae", "mnist"): _LATENT | _GRIDS,
    ("vae", "toy"): _LATENT | _TOY_PANELS,
}
# the toy final dump's two images
DUMP_TAGS = {("image", "test/data-recon-gen/heatmap"), ("image", "test/latent/heatmap")}
PIPELINE_ARGS = ["--use-kernels", "--log-interval", "2", "--eval-iws-interval", "2",
                 "--ckpt-interval", "2", "--eval-batch-size", "128"]
IWS_ATOL = 1e-3   # nats, per item, card against CPU
LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-4
TF32_FLOPS, FP32_FLOPS, HBM_BYTES = 495e12, 67e12, 3.35e12   # H100 SXM, 700 W
MS_STEP = {}   # each driver run's ms/step per log interval, by phase label


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"


def ptxas_report(log):
    """[(kernel, registers, static smem bytes, spill stores, spill loads)]
    of every entry function in an nvcc -Xptxas -v log."""
    rows = []
    for block in re.split(r"Compiling entry function '", log)[1:]:
        name = block.split("'", 1)[0]
        regs = re.search(r"Used (\d+) registers", block)
        smem = re.search(r"(\d+) bytes smem", block)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", block)
        rows.append((name, int(regs.group(1)) if regs else -1,
                     int(smem.group(1)) if smem else 0,
                     int(spill.group(1)) if spill else -1,
                     int(spill.group(2)) if spill else -1))
    filt = shutil.which("c++filt")
    if filt and rows:
        out = subprocess.run([filt], input="\n".join(r[0] for r in rows),
                             capture_output=True, text=True, timeout=60).stdout
        names = out.splitlines()
        if len(names) == len(rows):
            rows = [(n.replace("(anonymous namespace)::", "").split("(")[0].replace(
                "void ", ""),) + r[1:] for n, r in zip(names, rows)]
    return rows


def hmma_count(lib):
    """HMMA instructions in a library's SASS, or None without cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    out = subprocess.run([tool, "-sass", lib], capture_output=True, text=True,
                         timeout=300)
    if out.returncode != 0:
        fail(f"cuobjdump -sass {lib} failed: {out.stderr[-2000:]}")
    return sum("HMMA" in ln for ln in out.stdout.splitlines())


def products(kind, args):
    """The matrix products of one kernel entry point, (op, layer), op one of
    forward (x . W^T), input_grad (dp . W), weight_grad (dp^T . h): the res
    kernel's layers all; the grad kernel's hidden layers (its h -> 1 head
    has no product). Returns ({"fwd": [...], "bwd": [...]}, [(out, in)])."""
    ws, l0 = args[6::2], args[1]
    dims = [(w.shape[0], w.shape[1] - (i == l0)) for i, w in enumerate(ws)]
    layers = range(len(dims) if kind == "res" else len(dims) - 1)
    fwd = [("forward", i) for i in layers]
    dgrad = [("input_grad", i) for i in layers if i > 0]
    wgrad = [("weight_grad", i) for i in layers]
    if kind == "res":
        return {"fwd": fwd, "bwd": wgrad + dgrad}, dims
    # grad style: forward + input-gradient chain (down to d e / d xbar);
    # tangent chain + two weight-gradient products a layer + primal adjoint
    return {"fwd": fwd + dgrad + [("input_grad", 0)],
            "bwd": fwd + wgrad + wgrad + dgrad}, dims


def flops(kind, args):
    ops, dims = products(kind, args)
    n = args[2].shape[0]
    return {w: sum(2.0 * n * dims[i][0] * dims[i][1] for _, i in ops[w])
            for w in ops}


def io_bytes(args, leaves):
    """Bytes the function must move: each input read once and each output
    written once (fwd: inputs -> loss; bwd: inputs and the cotangent ->
    every gradient)."""
    inputs = sum(t.numel() for t in args[2:]) * 4
    return {"fwd": inputs + 4, "bwd": inputs + 4 + sum(t.numel() for t in leaves) * 4}


def library_ms(torch, kind, args):
    """Median ms of the entry points' matrix products alone, as
    torch.matmul calls on operands of the kernel's shapes (fp32, TF32 off)."""
    ops, dims = products(kind, args)
    ws, n, dev = args[6::2], args[2].shape[0], args[2].device
    width = max(max(o, i) for o, i in dims)
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(n, width, generator=g, device=dev)
    y = torch.randn(n, width, generator=g, device=dev)

    def run(which):
        for op, i in ops[which]:
            out, inn = dims[i]
            w = ws[i][:, :inn].detach()
            if op == "forward":
                torch.matmul(x[:, :inn], w.t())
            elif op == "input_grad":
                torch.matmul(x[:, :out], w)
            else:
                torch.matmul(x[:, :out].t(), y[:, :inn])

    return {w: time_ms(torch, lambda: run(w)) for w in ("fwd", "bwd")}


def dsm_case(prepare, build_cdae, torch, dev, cdae_name, bsz, ssz, d, h,
             layers, act, seed):
    """Inputs of a DSM chain for one shape, made on the card from a seed."""
    cdae = build_cdae(cdae_name, input_dim=d, context_dim=d, h_dim=h,
                      n_layers=layers, nonlin=act, seed=seed, device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    latent = torch.randn(bsz, ssz, d, generator=g, device=dev)
    ctx = torch.randn(bsz, d, generator=g, device=dev)
    std = 0.3 * torch.randn(bsz, ssz, 1, generator=g, device=dev).abs()
    act, l0, xbar, eps, sigma, _, flat = prepare(cdae, latent, ctx, std, g, None)
    ctx_l0 = cdae.ctx_l0(ctx).detach().requires_grad_(True)
    flat = [w.detach().requires_grad_(True) for w in flat]
    return (act, l0, xbar, eps, sigma, ctx_l0, *flat)


def grads(torch, loss, leaves, **kw):
    """d loss / d leaves; a leaf the loss does not reach (the grad-style
    energy head's bias) gets zeros, as the kernel returns."""
    gs = torch.autograd.grad(loss, leaves, allow_unused=True, **kw)
    return [torch.zeros_like(x) if g is None else g for g, x in zip(gs, leaves)]


def compare(torch, kernel, plain, args):
    """Kernel vs plain on the same inputs: (loss rel err, loss abs err,
    worst grad rel-norm err, worst grad abs err)."""
    leaves = [args[5]] + list(args[6:])
    outs = []
    for fn in (kernel, plain):
        loss = fn(*args)
        gs = grads(torch, loss, leaves)
        torch.cuda.synchronize()
        outs.append((loss.detach(), gs))
    (lk, gk), (lr, gr) = outs
    for t in [lk, *gk]:
        if not bool(torch.isfinite(t).all()):
            fail("kernel produced non-finite values")
    rel = [float((a - b).norm() / b.norm()) if float(b.norm()) else float(a.norm())
           for a, b in zip(gk, gr)]
    absd = [float((a - b).abs().max()) for a, b in zip(gk, gr)]
    return (abs(float(lk) - float(lr)) / abs(float(lr)), abs(float(lk) - float(lr)),
            max(rel), max(absd))


def time_ms(torch, fn, reps=7):
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def check_ragged(torch, dev, build_cdae, k, what):
    """Phase 3/3b: kernel vs plain at the ragged shapes."""
    for bsz, ssz, d, h, layers, act, seed in k["ragged"]:
        args = dsm_case(k["prepare"], build_cdae, torch, dev, k["cdae"], bsz, ssz,
                        d, h, layers, act, seed)
        lrel, _, grel, _ = compare(torch, k["fn"].apply, k["plain"], args)
        print(f"{what} compare {k['cdae']} n={bsz}x{ssz} d={d} h={h} "
              f"layers={layers} {act}: loss rel {lrel:.2e}, worst grad rel-norm "
              f"{grel:.2e}", flush=True)
        if not (lrel <= LOSS_RTOL and grel <= GRAD_RTOL):
            fail(f"{k['cdae']} kernel disagrees with the plain version ({act}, "
                 f"d={d}, h={h})")


def check_line(torch, dev, build_cdae, k, what, line, shape):
    """Phase 3/3b: kernel vs plain at a line's shape, and a bitwise repeat;
    returns the inputs and (loss abs err, grad abs err)."""
    bsz, ssz, d, h, layers, act, seed = shape
    args = dsm_case(k["prepare"], build_cdae, torch, dev, k["cdae"], bsz, ssz, d,
                    h, layers, act, seed)
    lrel, labs, grel, gabs = compare(torch, k["fn"].apply, k["plain"], args)
    print(f"{what} compare {k['cdae']} at the {line} shape n={bsz}x{ssz} "
          f"d={d} h={h} layers={layers} {act}: loss rel {lrel:.2e} (abs "
          f"{labs:.2e}), worst grad rel-norm {grel:.2e} (max abs {gabs:.2e})",
          flush=True)
    if not (lrel <= LOSS_RTOL and grel <= GRAD_RTOL):
        fail(f"{k['cdae']} kernel disagrees with the plain version at the "
             f"{line} shape")
    leaves = [args[5]] + list(args[6:])
    runs = []
    for _ in range(2):
        loss = k["fn"].apply(*args)
        runs.append([loss.detach()] + grads(torch, loss, leaves))
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(*runs)):
        fail(f"{k['cdae']} kernel is not bitwise repeatable at the {line} shape")
    print(f"{what} repeat {k['cdae']} at the {line} shape: loss and "
          f"{len(leaves)} gradients bitwise equal over two runs", flush=True)
    return args, labs, gabs


def time_kernel(torch, k, args, what, line, card):
    """Phase 4/4b: median ms of fwd, bwd and fwd+bwd, kernel and plain, in
    turns plain, kernel, kernel, plain."""
    leaves = [args[5]] + list(args[6:])
    times = {}
    for name, fn in [("plain", k["plain"]), ("kernel", k["fn"].apply)] * 2:
        loss = fn(*args)
        fwd = time_ms(torch, lambda: fn(*args))
        bwd = time_ms(torch, lambda: grads(torch, loss, leaves, retain_graph=True))
        both = time_ms(torch, lambda: grads(torch, fn(*args), leaves))
        times.setdefault(name, []).append((fwd, bwd, both))
        del loss
    med = {n: [statistics.median(x[i] for x in v) for i in range(3)]
           for n, v in times.items()}
    lib = library_ms(torch, k["kind"], args)
    med["library"] = [lib["fwd"], lib["bwd"], lib["fwd"] + lib["bwd"]]
    fl = flops(k["kind"], args)
    print(f"{what} time {k['cdae']} at the {line} shape (median of 7, "
          f"two turns each): kernel fwd {med['kernel'][0]:.3f} ms bwd "
          f"{med['kernel'][1]:.3f} ms fwd+bwd {med['kernel'][2]:.3f} ms | plain "
          f"fwd {med['plain'][0]:.3f} ms bwd {med['plain'][1]:.3f} ms fwd+bwd "
          f"{med['plain'][2]:.3f} ms | products alone (torch.matmul fp32) fwd "
          f"{lib['fwd']:.3f} ms bwd {lib['bwd']:.3f} ms | kernel "
          f"{fl['fwd'] / med['kernel'][0] / 1e9:.1f} / "
          f"{fl['bwd'] / med['kernel'][1] / 1e9:.1f} TFLOP/s fwd / bwd | bound "
          f"3xTF32 {3e3 * fl['fwd'] / TF32_FLOPS:.3f} / "
          f"{3e3 * fl['bwd'] / TF32_FLOPS:.3f} ms, fp32 "
          f"{1e3 * fl['fwd'] / FP32_FLOPS:.3f} / {1e3 * fl['bwd'] / FP32_FLOPS:.3f} "
          f"ms fwd / bwd | {card}", flush=True)
    return med


def reset_counts(kernels):
    for k in kernels:
        for name in k["fn"].launches:
            k["fn"].launches[name] = 0


def read_counts(kernels):
    return {n: c for k in kernels for n, c in k["fn"].launches.items()}


def flag(args, name):
    """The value after the last ``name`` in an argument list."""
    return args[len(args) - 1 - args[::-1].index(name) + 1]


def drive_line(torch, dev, k, kernels, line_args, what, card, steps=STEPS,
               data_root=None, dump=False, use_kernels=True, evals=False):
    """Phase 5/5b-5i, 10, 12a: ``steps`` steps of a line through
    cli.ivae_ardae.run with --use-kernels (without, ``use_kernels`` False:
    no kernel may launch; then, with ``dump``, the toy final dump instead of
    skipping the test eval; with ``evals``, a val IWS eval after the last
    step and the test eval, at eval batch 128, each finite and negative);
    every launch counter is 0 just before and read just after.
    The driver must log the cdae context's width that context_dim_for
    gives; the logged losses and sigmas are finite, the master parameters
    fp32. Returns (this run's launches, the trained state, its ms/step per
    log interval), the last also kept in MS_STEP[what]."""
    from ardae_tpu_torch.cli import ivae_ardae
    from ardae_tpu_torch.models.ivae import api as ivae_api
    from ardae_tpu_torch.models.registry import (
        build_cdae,
        build_ivae_model,
        context_dim_for,
    )

    name = flag(line_args, "--model")
    with tempfile.TemporaryDirectory() as tmp:
        smoke = [a for a in SMOKE_ARGS
                 if not ((dump or evals) and a == "--skip-final-test-eval")]
        evals_args = ["--eval-iws-interval", str(steps), "--eval-batch-size",
                      "128"] if evals else []
        argv = line_args + smoke + evals_args + ["--use-kernels"] * use_kernels + [
            "--max-iters", str(steps),
            "--cache", os.path.join(tmp, "exp"),
            "--data-root", data_root or os.path.join(tmp, "data")]
        reset_counts(kernels)
        t0 = time.perf_counter()
        state, path = ivae_ardae.run(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts(kernels)
        with open(os.path.join(path, "log.txt")) as f:
            log = f.readlines()
    lines = [ln for ln in log if ln.startswith("| iter ")]
    expected = {n: (steps * k["updates"]
                    if use_kernels and n in k["fn"].launches else 0)
                for n in launches}
    if launches != expected:
        fail(f"{what} {name}: kernel launches {launches}, expected {expected}")
    if len(lines) != steps // 2:
        fail(f"expected {steps // 2} log lines, got {len(lines)}")
    losses = [float(v) for ln in lines for v in re.findall(
        r"loss \([a-z]+\) (\S+)", ln)]
    if not losses or not all(math.isfinite(v) for v in losses):
        fail(f"non-finite logged losses: {losses}")
    sigmas = [float(v) for ln in lines for v in re.findall(r"std (\S+)", ln)]
    if len(sigmas) != 4 * len(lines) or not all(math.isfinite(v) for v in sigmas):
        fail(f"{what} {name}: logged sigmas {sigmas} not all finite")
    dtypes = {p.dtype for m in (state.model, state.cdae) for p in m.parameters()}
    if dtypes != {torch.float32}:
        fail(f"{what} {name}: master parameters {dtypes}, expected fp32")
    ms_step = [float(re.search(r"ms/step\s+(\S+)", ln).group(1)) for ln in lines]
    MS_STEP[what] = ms_step
    nchannels, nheight = int(flag(line_args, "--nchannels")), int(flag(line_args, "--nheight"))
    z_dim, h_dim = int(flag(line_args, "--model-z-dim")), int(flag(line_args, "--model-h-dim"))
    ctx_type = flag(line_args, "--cdae-ctx-type")
    ctx_dim = context_dim_for(ctx_type, model_name=name, nchannels=nchannels,
                              nheight=nheight, z_dim=z_dim, h_dim=h_dim)
    logged = [ln.strip() for ln in log if ln.startswith("cdae params")]
    if len(logged) != 1 or not logged[0].endswith(f"context {ctx_type}, {ctx_dim} wide"):
        fail(f"{what} {name}: logged {logged}, expected a {ctx_dim}-wide "
             f"{ctx_type} context")
    init_m = build_ivae_model(
        name, nchannels=nchannels, nheight=nheight, z_dim=z_dim, h_dim=h_dim,
        n_dim=int(flag(line_args, "--model-n-dim")),
        n_layers=int(flag(line_args, "--model-n-layers")),
        nonlin=flag(line_args, "--model-nonlin"), seed=0, device=dev)
    init_d = build_cdae(flag(line_args, "--cdae"), input_dim=z_dim,
                        context_dim=ctx_dim,
                        h_dim=int(flag(line_args, "--cdae-h-dim")),
                        n_layers=int(flag(line_args, "--cdae-n-layers")),
                        nonlin=flag(line_args, "--cdae-nonlin"), seed=1, device=dev)
    for a, b, who in ((state.model, init_m, "model"), (state.cdae, init_d, "cdae")):
        moved = sum(float((p.detach() - q.detach()).abs().max()) > 0
                    for p, q in zip(a.parameters(), b.parameters()))
        total = len(list(a.parameters()))
        print(f"{what} {who}: {moved}/{total} parameter tensors moved", flush=True)
        if moved == 0:
            fail(f"{who} parameters did not change")
    with torch.no_grad():
        x = (torch.rand(8, nchannels * nheight ** 2, device=dev) < 0.3).float()
        z = ivae_api.encode_det(state.model, x)
    if tuple(z.shape) != (8, 1, z_dim) or not bool(torch.isfinite(z).all()):
        fail(f"trained encoder output {tuple(z.shape)} not finite/(8, 1, {z_dim})")
    if dump:
        check_dump(log, line_args, what)
    if evals:
        bounds = [(ln.split("|")[1].strip(), float(m.group(1)), float(t.group(1)))
                  for ln in log for m, t in [(re.search(r"logprob \(iws\) (\S+)", ln),
                                              re.search(r"sec/step\s+(\S+)", ln))]
                  if m and t and ln.startswith(("| val", "| test"))]
        if [b[0] for b in bounds] != ["val", "test"] or not all(
                math.isfinite(v) and v < 0 for _, v, _ in bounds):
            fail(f"{what} {name}: evals {bounds}, expected a finite negative val "
                 "and test IWS")
        print(f"{what} evals (IWS-{flag(line_args, '--iws-samples')}, batch 128): "
              + "; ".join(f"{sp} {v:.4f} in {sec:.2f} s" for sp, v, sec in bounds),
              flush=True)
    print(f"{what} main path: {steps} steps of the {name} line "
          f"{'with' if use_kernels else 'without'} --use-kernels in {wall:.1f} s "
          f"(set-up{' and dump' if dump else ''} "
          f"included); cdae context {ctx_type} {ctx_dim} wide; ms/step per log "
          f"interval {ms_step}; steady {ms_step[-1]:.2f} ms/step = "
          f"{1000.0 / ms_step[-1]:.3f} steps/s; kernel launches {launches}; "
          f"losses finite | {card}", flush=True)
    return launches, state, ms_step


def check_dump(log, line_args, what):
    """The toy final dump's log line: every chunk's rows (whole chunks of
    the first min(1M, n_train) points, as the JAX driver takes them) and no
    non-finite value."""
    from ardae_tpu_torch.cli.common import DUMP_CHUNK as chunk

    n_train = int(flag(line_args, "--toy-train-size"))
    n_dump = min(1_000_000, n_train)
    rows = sum(min(chunk, n_train - lo) for lo in range(0, n_dump, chunk))
    got = [ln for ln in log if ln.startswith("| toy dump")]
    if len(got) != 1:
        fail(f"{what}: expected one toy dump line, got {got}")
    m = re.search(r"sec\s+(\S+) \| rows (\d+) \| non-finite (\d+)", got[0])
    if not m or int(m.group(2)) != rows or int(m.group(3)) != 0:
        fail(f"{what}: toy dump {got[0].strip()}, expected {rows} rows, all finite")
    print(f"{what}: toy final dump of {rows} rows (recon, gen, latent all "
          f"finite) in {float(m.group(1)):.2f} s", flush=True)


def pipeline_run(torch, kernels, path_log, argv, what, driver=None):
    """One driver run (cli.ivae_ardae unless ``driver`` is given) of phase
    6 or 7 with every launch counter at 0 just before; returns (state,
    path, launches, the run's new log lines)."""
    if driver is None:
        from ardae_tpu_torch.cli import ivae_ardae as driver

    before = 0
    if path_log and os.path.exists(path_log):
        with open(path_log) as f:
            before = len(f.readlines())
    reset_counts(kernels)
    t0 = time.perf_counter()
    state, path = driver.run(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(kernels)
    with open(os.path.join(path, "log.txt")) as f:
        lines = f.readlines()[before:]
    print(f"{what}: driver run in {wall:.1f} s", flush=True)
    return state, path, launches, lines


def check_pipeline_run(k, launches, lines, steps, iters, n_evals, files, path,
                       what, bound="IWS-256"):
    """Phase 6's and 7's checks of one run: kernel ``k`` launched its
    updates a step and nothing else did (no launch at all for k None), the
    logged iterations, finite negative bounds, the files. Prints each
    eval's seconds and items/s and the run's ms/step."""
    expected = {n: (steps * k["updates"] if k and n in k["fn"].launches else 0)
                for n in launches}
    if launches != expected:
        fail(f"{what}: kernel launches {launches}, expected {expected}")
    logged = [ln.split("|")[1].strip() for ln in lines if ln.startswith("| iter ")]
    if logged != iters:
        fail(f"{what}: logged {logged}, expected {iters}")
    evals = []
    for ln in lines:
        if ln.startswith("| val") or ln.startswith("| test"):
            split = ln.split("|")[1].strip()
            secs = float(re.search(r"sec/step\s+(\S+)", ln).group(1))
            lp = float(re.search(r"logprob \(iws\) (\S+)", ln).group(1))
            evals.append((split, secs, lp))
    if len(evals) != n_evals:
        fail(f"{what}: {len(evals)} evals logged, expected {n_evals}")
    for split, secs, lp in evals:
        if not (math.isfinite(lp) and lp < 0):
            fail(f"{what}: {split} IWS {lp} is not finite and negative")
        items = 5000 if split == "val" else 10000
        print(f"{what}: {split} {bound} {lp:.4f} over {items} items in "
              f"{secs:.2f} s = {items / secs:.0f} items/s", flush=True)
    ms_step = [float(re.search(r"ms/step\s+(\S+)", ln).group(1))
               for ln in lines if ln.startswith("| iter ")]
    print(f"{what}: ms/step per log interval {ms_step}", flush=True)
    MS_STEP[what] = ms_step
    missing = [f for f in files if not os.path.exists(os.path.join(path, f))]
    if missing:
        fail(f"{what}: missing checkpoint files {missing}")
    return evals


def fresh_like(torch, state, device):
    """A TrainState of ``state``'s structure on ``device``: the modules
    copied with zeroed parameters, new optimizers with empty state."""
    import copy

    from ardae_tpu_torch.train.state import create_train_state

    parts = []
    for net, opt in ((state.model, state.opt_model), (state.cdae, state.opt_cdae)):
        if net is None:
            continue
        m = copy.deepcopy(net).to(device)
        with torch.no_grad():
            for p in m.parameters():
                p.zero_()
        # the load restores the hyperparameters with the state
        parts += [m, type(opt)(m.parameters(), opt.defaults["lr"])]
    return create_train_state(
        *parts, weight_avg="none" if state.avg_model is None else "polyak")


def state_tensors(state):
    """Every tensor and scalar of a TrainState, by name."""
    sd = state.state_dict()
    out = {"step": sd["step"]}
    for part in ("model", "cdae", "avg_model"):
        out.update({f"{part}.{k}": v for k, v in sd.get(part, {}).items()})
    if "avg_count" in sd:
        out["avg_count"] = sd["avg_count"]
    for part in ("opt_model", "opt_cdae"):
        if part in sd:
            out.update({f"{part}.{i}.{n}": x for i, st in sd[part]["state"].items()
                        for n, x in st.items()})
    return out


def checkpoint_roundtrip(torch, state, tmp, what):
    """Save the trained state and load it into fresh states on the card and
    on the CPU, timed; every tensor must come back bit for bit."""
    from ardae_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint

    gen = torch.Generator(device="cuda").manual_seed(5)
    torch.randn(7, generator=gen, device="cuda")
    want = {k: (v.detach().cpu().clone() if isinstance(v, torch.Tensor) else v)
            for k, v in state_tensors(state).items()}
    meta = {"i_ep": state.step, "epoch": 1, "batch_idx": state.step,
            "train_num_iters_per_epoch": 429, "best_val_loss": -100.0}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    target = save_checkpoint(state, meta, tmp, "roundtrip", gen)
    save_s = time.perf_counter() - t0
    print(f"{what}: checkpoint of {os.path.getsize(target) / 2**20:.1f} MiB "
          f"({len(want)} entries) saved from the card in {save_s:.3f} s", flush=True)
    for device in ("cuda", "cpu"):
        fresh = fresh_like(torch, state, device)
        # a generator's state is the card's Philox or the CPU's Mersenne
        # twister: it goes back into a generator of its own device only
        gen2 = torch.Generator(device="cuda").manual_seed(6) if device == "cuda" else None
        t0 = time.perf_counter()
        _, meta2 = load_checkpoint(fresh, tmp, "roundtrip", gen2)
        if device == "cuda":
            torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        got = state_tensors(fresh)
        if got.keys() != want.keys() or meta2 != meta:
            fail(f"{what}: checkpoint keys or meta differ after a load on {device}")
        for key, v in want.items():
            g = got[key]
            same = (torch.equal(g.detach().cpu(), v) and g.device.type == device
                    if isinstance(v, torch.Tensor) else g == v)
            if not same:
                fail(f"{what}: {key} differs after a save and a load on {device}")
        if gen2 is not None and not torch.equal(gen2.get_state(), gen.get_state()):
            fail(f"{what}: generator state differs after a load on {device}")
        print(f"{what}: checkpoint loaded onto {device} in {load_s:.3f} s, every "
              "tensor bit for bit equal", flush=True)
        del fresh


def iws_card_vs_cpu(torch, state, data_root, what, model_name="flagship model"):
    """logprob_iws and cov_gaussian_iws_from_draws on the card against the
    CPU: the trained model copied, 16 binarized val items, the same draws
    (an aux model's pair), the aux models' jitter of 1e-5."""
    import copy

    from ardae_tpu_torch.data import get_dataset
    from ardae_tpu_torch.models.ivae import api as ivae_api

    g = torch.Generator().manual_seed(17)
    val = torch.as_tensor(get_dataset("dbmnist-val5k", root=data_root)["val"][:16])
    x = (torch.rand(val.shape, generator=g) < val).float()
    models = {"cuda": state.model, "cpu": copy.deepcopy(state.model).cpu()}
    ssz, zdim = 256, state.model.z_dim
    eps = ivae_api.make_eps(models["cpu"], 16, ssz, generator=g)
    new_eps = torch.randn(16, ssz, zdim, generator=g)
    jitter = 1e-5 if state.model.family == "aux" else 0.0
    on = lambda e, dev: tuple(t.to(dev) for t in e) if isinstance(e, tuple) else e.to(dev)
    out = {}
    with torch.no_grad():
        z = ivae_api.sample_latents(models["cpu"], x, ssz, eps=eps)
        for dev, m in models.items():
            out[dev] = (
                ivae_api.logprob_iws(m, x.to(dev), ssz, jitter, reduce="per_item",
                                     eps=on(eps, dev), new_eps=new_eps.to(dev)).cpu(),
                ivae_api.cov_gaussian_iws_from_draws(
                    m, x.to(dev), z.to(dev), jitter, eps=new_eps.to(dev)).cpu())
    for i, name in enumerate(("logprob_iws", "cov_gaussian_iws_from_draws")):
        card, cpu = out["cuda"][i], out["cpu"][i]
        if not (bool(torch.isfinite(card).all()) and bool(torch.isfinite(cpu).all())):
            fail(f"{what}: {name} is not finite")
        diff = float((card - cpu).abs().max())
        print(f"{what}: {name} card vs CPU at the {model_name}, 16 items, "
              f"IWS-256, jitter {jitter:g}: max per-item |diff| {diff:.2e} nats (bound "
              f"{IWS_ATOL:.0e}); card mean {float(card.mean()):.4f}", flush=True)
        if not diff <= IWS_ATOL:
            fail(f"{what}: {name} card and CPU differ by {diff:.2e} nats")


def drive_pipeline(torch, res, kernels, card):
    """Phase 6: the flagship pipeline train -> val eval -> best-checkpoint ->
    test eval -> resume -> final mode, then the checkpoint roundtrip and the
    IWS card-vs-CPU check."""
    from ardae_tpu_torch.io.checkpoint import load_end_iter

    what = "phase 6"
    with tempfile.TemporaryDirectory() as tmp:
        base = FLAGSHIP_ARGS + PIPELINE_ARGS + [
            "--cache", os.path.join(tmp, "exp"),
            "--data-root", os.path.join(tmp, "data")]
        t0 = time.perf_counter()
        state, path, launches, lines = pipeline_run(
            torch, kernels, None, base + ["--max-iters", "4", "--no-resume"],
            f"{what} train")
        check_pipeline_run(res, launches, lines, 4, ["iter 2", "iter 4"], 3,
                           ["checkpoint", "best-checkpoint"], path, f"{what} train")
        log = os.path.join(path, "log.txt")
        state, path2, launches, lines = pipeline_run(
            torch, kernels, log, base + ["--max-iters", "6", "--resume"],
            f"{what} resume")
        if path2 != path:
            fail(f"{what} resume: went to {path2}, not {path}")
        check_pipeline_run(res, launches, lines, 2, ["iter 6"], 2,
                           ["checkpoint", "best-checkpoint"], path, f"{what} resume")
        end_iter = load_end_iter(path, "best-checkpoint")
        state, path3, launches, lines = pipeline_run(
            torch, kernels, log, base + ["--train-mode", "final", "--resume"],
            f"{what} final")
        if path3 != path:
            fail(f"{what} final: went to {path3}, not {path}")
        check_pipeline_run(res, launches, lines, end_iter,
                           [f"iter {i}" for i in range(2, end_iter + 1, 2)], 1,
                           ["final-checkpoint"], path, f"{what} final")
        print(f"{what}: train (4 steps), resume (to 6), final mode ({end_iter} "
              f"steps on train+val) in {time.perf_counter() - t0:.1f} s, kernel "
              f"launches checked per run | {card}", flush=True)
        checkpoint_roundtrip(torch, state, tmp, what)
        iws_card_vs_cpu(torch, state, os.path.join(tmp, "data"), what)
        del state
    torch.cuda.empty_cache()


def drive_heads(torch, dev, res, kernels, card):
    """Phase 5c: HEAD_STEPS steps of the flagship line's flags with --model
    set to each of the four other resconv fc heads, one data directory
    shared."""
    with tempfile.TemporaryDirectory() as tmp:
        for name, head in HEADS.items():
            args = list(FLAGSHIP_ARGS)
            args[args.index("resconvct-res")] = name
            drive_line(torch, dev, res, kernels, args, f"phase 5c {head}", card,
                       steps=HEAD_STEPS, data_root=os.path.join(tmp, "data"))
            torch.cuda.empty_cache()


def drive_aux(torch, dev, res, grad, kernels, card, launches):
    """Phases 5f-5i: the three hierarchical-aux lines (hidden1a context)
    and the -clip twin of :38, one data directory shared; each run's
    launches go into ``launches`` by line. Then phase 6b on the trained
    auxmnist IVAE: its checkpoint roundtrip and IWS (jitter 1e-5) card vs
    CPU."""
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "data")
        runs = [(res, "phase 5f", "auxresconvct", AUX_LINES["auxresconvct"], STEPS),
                (grad, "phase 5g", "auxconv", AUX_LINES["auxconv"], STEPS),
                (grad, "phase 5h", "auxmnist", AUX_LINES["auxmnist"], STEPS),
                (res, "phase 5i", "auxresconvct-clip", AUX_CLIP_ARGS, HEAD_STEPS)]
        for k, what, line, args, steps in runs:
            counts, state, _ = drive_line(torch, dev, k, kernels, args, what, card,
                                          steps=steps, data_root=data)
            launches[line] = counts
            if line == "auxmnist":
                trained = state
            del state
            torch.cuda.empty_cache()
        checkpoint_roundtrip(torch, trained, tmp, "phase 6b auxmnist")
        iws_card_vs_cpu(torch, trained, data, "phase 6b", "auxmnist IVAE")
        del trained
    torch.cuda.empty_cache()


def drive_baseline_line(torch, dev, kernels, line, tmp, card, what=None,
                        extra=()):
    """Phase 7/7c/10: STEPS steps of a baseline line (plus ``extra``)
    through cli.vae with no eval; no kernel may launch, the logged losses
    are finite, the master parameters fp32 and moved. Returns the trained
    state."""
    from ardae_tpu_torch.cli import vae

    what = what or f"phase 7 {line}"
    argv = BASELINE_LINES[line] + list(extra) + SMOKE_ARGS + [
        "--max-iters", str(STEPS), "--cache", os.path.join(tmp, "exp"),
        "--data-root", os.path.join(tmp, "data")]
    state, path, launches, lines = pipeline_run(torch, kernels, None, argv, what,
                                                driver=vae)
    baseline_checks(torch, dev, state, launches, lines, path,
                    BASELINE_MODELS[line], what, card)
    return state


def drive_aux_baselines(torch, dev, kernels, card):
    """Phase 7c: STEPS steps of each aux baseline line (:19, :25, :31)
    through cli.vae, no launch; then aux_logprob_iwae and aux_vae_loss card
    vs CPU on the trained auxresconv baseline."""
    with tempfile.TemporaryDirectory() as tmp:
        for line in ("auxresconv", "auxconv", "auxmnist"):
            state = drive_baseline_line(torch, dev, kernels, line, tmp, card,
                                        what=f"phase 7c {line}")
            if line == "auxresconv":
                iwae_card_vs_cpu(torch, state, os.path.join(tmp, "data"),
                                 "phase 7c", "auxresconv baseline")
            del state
            torch.cuda.empty_cache()


def baseline_checks(torch, dev, state, launches, lines, path, model, what, card):
    """Phase 7/7b's checks of a baseline run: no launch, the logged
    iterations and losses finite, the parameters moved."""
    from ardae_tpu_torch.models.registry import build_vae_model

    check_pipeline_run(None, launches, lines, STEPS,
                       [f"iter {i}" for i in range(2, STEPS + 1, 2)], 0, [], path,
                       what)
    values = [float(v) for ln in lines if ln.startswith("| iter ")
              for v in re.findall(r"\| (?:loss(?: \(\w+\))?|elbo) (\S+)", ln)]
    if len(values) != 4 * (STEPS // 2) or not all(math.isfinite(v) for v in values):
        fail(f"{what}: logged losses {values} not all finite")
    dtypes = {p.dtype for p in state.model.parameters()}
    if dtypes != {torch.float32}:
        fail(f"{what}: master parameters {dtypes}, expected fp32")
    init = build_vae_model(**model, seed=0, device=dev)
    moved = sum(float((p.detach() - q.detach()).abs().max()) > 0
                for p, q in zip(state.model.parameters(), init.parameters()))
    total = len(list(init.parameters()))
    print(f"{what}: {STEPS} steps, {moved}/{total} parameter tensors moved, no "
          f"kernel launch, losses finite | {card}", flush=True)
    if moved == 0:
        fail(f"{what}: the parameters did not change")


def drive_toy_baseline(torch, dev, kernels, card):
    """Phase 7b: STEPS steps of cli.vae --model toy on the 25-gaussians
    data, then the toy final dump; no kernel may launch."""
    from ardae_tpu_torch.cli import vae

    what = "phase 7b toy"
    with tempfile.TemporaryDirectory() as tmp:
        argv = TOY_VAE_ARGS + [a for a in SMOKE_ARGS
                               if a != "--skip-final-test-eval"] + [
            "--max-iters", str(STEPS), "--cache", os.path.join(tmp, "exp"),
            "--data-root", os.path.join(tmp, "data")]
        state, path, launches, lines = pipeline_run(torch, kernels, None, argv,
                                                    what, driver=vae)
        model = dict(name="toy", nchannels=2, nheight=1,
                     **{k: int(flag(TOY_VAE_ARGS, f"--model-{k.replace('_', '-')}"))
                        for k in ("z_dim", "h_dim", "n_layers")},
                     nonlin=flag(TOY_VAE_ARGS, "--model-nonlin"))
        baseline_checks(torch, dev, state, launches, lines, path, model, what,
                        card)
        check_dump(lines, TOY_VAE_ARGS, what)


def iwae_card_vs_cpu(torch, state, data_root, what, model_name="resconv baseline"):
    """logprob_iwae and vae_loss(reduce="per_item") on the card against the
    CPU (an aux model's aux_logprob_iwae and aux_vae_loss, through the
    API): the trained model copied, 16 binarized val items, the same
    draws."""
    import copy

    from ardae_tpu_torch.data import get_dataset
    from ardae_tpu_torch.models.vae import api as vae_api

    g = torch.Generator().manual_seed(17)
    val = torch.as_tensor(get_dataset("dbmnist-val5k", root=data_root)["val"][:16])
    x = (torch.rand(val.shape, generator=g) < val).float()
    ssz, zdim = 256, state.model.z_dim
    if state.model.family == vae_api.AUX:
        noise = state.model.noise_dim
        eps = (torch.randn(16 * ssz, noise, generator=g),
               torch.randn(16 * ssz, zdim, generator=g))
        elbo_eps = (torch.randn(16, noise, generator=g),
                    torch.randn(16, zdim, generator=g))
    else:
        eps = torch.randn(16, ssz, zdim, generator=g)
        elbo_eps = torch.randn(16, zdim, generator=g)
    on = lambda e, dev: tuple(t.to(dev) for t in e) if isinstance(e, tuple) else e.to(dev)
    models = {"cuda": state.model, "cpu": copy.deepcopy(state.model).cpu()}
    out = {}
    with torch.no_grad():
        for dev, m in models.items():
            out[dev] = (
                vae_api.logprob_iwae(m, x.to(dev), ssz, reduce="per_item",
                                     eps=on(eps, dev)).cpu(),
                vae_api.vae_loss(m, x.to(dev), reduce="per_item",
                                 eps=on(elbo_eps, dev))[0].cpu())
    for i, name in enumerate(("logprob_iwae", "vae_loss")):
        card, cpu = out["cuda"][i], out["cpu"][i]
        if not (bool(torch.isfinite(card).all()) and bool(torch.isfinite(cpu).all())):
            fail(f"{what}: {name} is not finite")
        diff = float((card - cpu).abs().max())
        print(f"{what}: {name} card vs CPU at the {model_name}, 16 items"
              f"{', IWAE-256' if i == 0 else ''}: max per-item |diff| {diff:.2e} "
              f"nats (bound {IWS_ATOL:.0e}); card mean {float(card.mean()):.4f}",
              flush=True)
        if not diff <= IWS_ATOL:
            fail(f"{what}: {name} card and CPU differ by {diff:.2e} nats")


def drive_baseline(torch, dev, kernels, card):
    """Phase 7: the resconv baseline pipeline train -> val eval ->
    best-checkpoint -> test eval -> resume -> final mode, the checkpoint
    roundtrip, the IWAE card-vs-CPU check, then the conv and mlp lines."""
    from ardae_tpu_torch.cli import vae
    from ardae_tpu_torch.io.checkpoint import load_end_iter

    what = "phase 7 resconv"
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "data")
        base = BASELINE_LINES["resconv"] + [
            "--log-interval", "2", "--eval-iws-interval", "2", "--ckpt-interval",
            "2", "--eval-batch-size", "128", "--cache", os.path.join(tmp, "exp"),
            "--data-root", data]
        t0 = time.perf_counter()
        state, path, launches, lines = pipeline_run(
            torch, kernels, None, base + ["--max-iters", "4", "--no-resume"],
            f"{what} train", driver=vae)
        check_pipeline_run(None, launches, lines, 4, ["iter 2", "iter 4"], 3,
                           ["checkpoint", "best-checkpoint"], path, f"{what} train",
                           "IWAE-256")
        log = os.path.join(path, "log.txt")
        state, path2, launches, lines = pipeline_run(
            torch, kernels, log, base + ["--max-iters", "6", "--resume"],
            f"{what} resume", driver=vae)
        if path2 != path:
            fail(f"{what} resume: went to {path2}, not {path}")
        check_pipeline_run(None, launches, lines, 2, ["iter 6"], 2,
                           ["checkpoint", "best-checkpoint"], path, f"{what} resume",
                           "IWAE-256")
        end_iter = load_end_iter(path, "best-checkpoint")
        state, path3, launches, lines = pipeline_run(
            torch, kernels, log, base + ["--train-mode", "final", "--resume"],
            f"{what} final", driver=vae)
        if path3 != path:
            fail(f"{what} final: went to {path3}, not {path}")
        check_pipeline_run(None, launches, lines, end_iter,
                           [f"iter {i}" for i in range(2, end_iter + 1, 2)], 1,
                           ["final-checkpoint"], path, f"{what} final", "IWAE-256")
        print(f"{what}: train (4 steps), resume (to 6), final mode ({end_iter} "
              f"steps on train+val) in {time.perf_counter() - t0:.1f} s, no kernel "
              f"launch | {card}", flush=True)
        checkpoint_roundtrip(torch, state, tmp, what)
        iwae_card_vs_cpu(torch, state, data, what)
        del state
        torch.cuda.empty_cache()
        for line in ("conv", "mlp"):
            drive_baseline_line(torch, dev, kernels, line, tmp, card)
    torch.cuda.empty_cache()


class RecordingWriter:
    """Phase 8's writer, patched into the drivers' make_writer: keeps what
    a run hands it, (kind, tag, value as numpy), in order."""

    def __init__(self):
        self.items = []

    def add_scalar(self, tag, value, step=None):
        self.items.append(("scalar", tag, _numpy(value)))

    def add_histogram(self, tag, values, step=None):
        self.items.append(("histogram", tag, _numpy(values)))

    def add_image(self, tag, image, step=None):
        self.items.append(("image", tag, _numpy(image)))

    def flush(self):
        pass

    def close(self):
        pass

    def check(self, kind, what):
        """The visualization's tags (and a toy run's dump images) against
        VIS_TAGS; each image CHW float32 in [0, 1], every value finite.
        Returns the number of images."""
        import numpy as np

        want = VIS_TAGS[kind] | (DUMP_TAGS if kind[1] == "toy" else set())
        got = {(k, tag) for k, tag, _ in self.items
               if k != "scalar" or "/enc/" in tag}
        if got != want:
            fail(f"{what}: writer tags {sorted(got ^ want)} differ from the "
                 "JAX driver's")
        for k, tag, v in self.items:
            if not np.isfinite(v).all():
                fail(f"{what}: {k} {tag} is not finite")
            if k == "image" and (v.dtype != np.float32 or v.ndim != 3
                                 or v.min() < 0.0 or v.max() > 1.0):
                fail(f"{what}: image {tag} {v.dtype} {v.shape} "
                     f"[{v.min()}, {v.max()}] is not CHW float32 in [0, 1]")
        return sum(k == "image" for k, _, _ in self.items)


def _numpy(v):
    import numpy as np

    return np.asarray(v.detach().cpu() if hasattr(v, "detach") else v)


class AvgMonitor:
    """Wraps update_weight_avg where the two step modules call it: after
    each call, the step and the largest |averaged - live| parameter, kept
    on the card until the run ends (a few fused launches a step)."""

    def __init__(self, torch):
        from ardae_tpu_torch.train import step, vae_step

        self.torch, self.mods, self.orig = torch, (step, vae_step), step.update_weight_avg
        self.seen = []

    def __enter__(self):
        torch = self.torch

        def wrapped(state, cfg):
            self.orig(state, cfg)
            if state.avg_model is not None:
                live = [p.detach() for p in state.model.parameters()]
                diff = torch._foreach_sub(list(state.avg_model.parameters()), live)
                top = torch.stack(torch._foreach_norm(diff, float("inf"))).max()
                self.seen.append((state.step, top))

        for m in self.mods:
            m.update_weight_avg = wrapped
        return self

    def __exit__(self, *exc):
        for m in self.mods:
            m.update_weight_avg = self.orig

    def check(self, state, start, steps, what, swa=False):
        """The average equals the live model at every step counted before
        ``start`` and differs from it from ``start`` on; SWA's first average
        is the live model itself, a + (p - a), which rounding leaves within
        1e-5 of p, so it differs from ``start + 1`` on."""
        seen = [(step, float(top)) for step, top in self.seen]
        differs = start + int(swa)
        if [s for s, _ in seen] != list(range(1, steps + 1)):
            fail(f"{what}: averaged at steps {[s for s, _ in seen]}")
        for step, top in seen:
            if swa and step == start:
                ok = top <= 1e-5
            else:
                ok = (top == 0.0) == (step < differs)
            if not ok:
                fail(f"{what}: at step {step} max |avg - live| = {top:.3e} "
                     f"(averaging starts at {start})")
        if state.avg_count != steps - start + 1:
            fail(f"{what}: avg_count {state.avg_count}, expected {steps - start + 1}")
        print(f"{what}: the averaged model equals the live one at steps "
              f"1-{differs - 1} and differs from step {differs} on (max |avg - live| "
              f"{', '.join(f'{t:.2e}' for _, t in seen)}); avg_count "
              f"{state.avg_count}", flush=True)


def published_run(torch, kernels, k, driver, argv, what, kind, steps, vis_every):
    """One phase-8 run: ``argv`` through ``driver`` with the recording
    writer and the averaging monitor in place and every launch counter at
    0 just before; kernel ``k`` (None: no kernel) must launch its updates
    a step and nothing else may. Checks the logged losses, the writer's
    tags and values, and the visualizations' count; prints their seconds.
    Returns (state, path, launches, log lines, ms/step per log interval,
    monitor, models the IWS eval was given)."""
    import ardae_tpu_torch.cli.common as common

    rec, evaluated = RecordingWriter(), []
    real_writer, real_eval = common.make_writer, common.evaluate_iws_ivae

    def recorded_eval(model, *a, **kw):
        evaluated.append(model)
        return real_eval(model, *a, **kw)

    common.make_writer = lambda path: rec
    common.evaluate_iws_ivae = recorded_eval
    try:
        with AvgMonitor(torch) as monitor:
            state, path, launches, lines = pipeline_run(
                torch, kernels, None, argv, what, driver=driver)
    finally:
        common.make_writer, common.evaluate_iws_ivae = real_writer, real_eval
    expected = {n: (steps * k["updates"] if k and n in k["fn"].launches else 0)
                for n in launches}
    if launches != expected:
        fail(f"{what}: kernel launches {launches}, expected {expected}")
    iters = [ln for ln in lines if ln.startswith("| iter ")]
    values = [float(v) for ln in iters for v in re.findall(
        r"\| (?:loss(?: \(\w+\))?|elbo) (\S+)", ln)]
    if len(iters) != steps // 2 or not values or not all(map(math.isfinite, values)):
        fail(f"{what}: logged {len(iters)} iterations, losses {values}")
    ms = [float(re.search(r"ms/step\s+(\S+)", ln).group(1)) for ln in iters]
    n_images = rec.check(kind, what)
    vis = [float(re.search(r"sec\s+(\S+)", ln).group(1))
           for ln in lines if ln.startswith("| vis ")]
    n_vis = steps // vis_every + (kind[1] == "toy")
    if len(vis) != n_vis:
        fail(f"{what}: {len(vis)} visualizations logged, expected {n_vis}")
    print(f"{what}: {len(vis)} visualizations ({n_images} images, tags as the "
          f"JAX driver's, finite, in [0, 1]) of {vis} s; ms/step per log "
          f"interval {ms}; kernel launches {launches}", flush=True)
    return state, path, launches, lines, ms, monitor, evaluated


def time_update(torch, state, mode, what, card):
    """One update_weight_avg call on the trained state, CUDA events,
    median of 21 (averaging started)."""
    from ardae_tpu_torch.train.step import StepConfig, update_weight_avg

    cfg = StepConfig(weight_avg=mode, weight_avg_start=0)
    ms = time_ms(torch, lambda: update_weight_avg(state, cfg), reps=21)
    params = list(state.model.parameters())
    print(f"{what}: one {mode} update over {len(params)} tensors, "
          f"{sum(p.numel() for p in params):,} parameters: {ms:.3f} ms (CUDA "
          f"events, median of 21) | {card}", flush=True)


def drive_published(torch, dev, res, grad, kernels, card, by_line, ms_step):
    """Phase 8: the published lines run flag for flag (depth cut) with
    panels and weight averaging on; each main-path run's launches go into
    ``by_line``. 8a the flagship with Polyak, evals and checkpoints every 2
    steps; 8b implicit conv with SWA; 8c 25-gaussians; 8d the resconv
    baseline with Polyak and the toy-maf baseline."""
    from ardae_tpu_torch.cli import ivae_ardae, vae

    with tempfile.TemporaryDirectory() as tmp:
        where = ["--cache", os.path.join(tmp, "exp"),
                 "--data-root", os.path.join(tmp, "data")]
        run = ["--max-iters", str(STEPS)] + where
        dump = [a for a in SMOKE_ARGS if a != "--skip-final-test-eval"]

        what = "phase 8a flagship polyak"
        argv = POLYAK + PIPELINE_ARGS + ["--no-resume", "--skip-final-test-eval"] + run
        state, path, by_line["flagship-polyak"], lines, ms, mon, evaluated = \
            published_run(torch, kernels, res, ivae_ardae, argv, what,
                          ("ivae", "mnist"), STEPS, 2)
        mon.check(state, 2, STEPS, what)
        vals = [float(re.search(r"logprob \(iws\) (\S+)", ln).group(1))
                for ln in lines if ln.startswith("| val")]
        if len(vals) != 3 or not all(math.isfinite(v) and v < 0 for v in vals):
            fail(f"{what}: val IWS {vals}")
        if len(evaluated) != 3 or any(m is not state.avg_model for m in evaluated):
            fail(f"{what}: the val IWS did not run on the averaged model")
        saves = [ln.strip() for ln in lines if ln.startswith("| saved")]
        print(f"{what}: val IWS-256 {vals} over 5,000 items each, on the averaged "
              f"model; {saves}", flush=True)
        checkpoint_roundtrip(torch, state, tmp, what)
        ms_step["flagship-polyak"] = ms
        time_update(torch, state, "polyak", what, card)
        del state
        torch.cuda.empty_cache()

        what = "phase 8b implicit-conv swa"
        argv = SWA + SMOKE_ARGS + ["--use-kernels"] + run
        state, _, by_line["implicit-conv-swa"], _, ms, mon, _ = published_run(
            torch, kernels, grad, ivae_ardae, argv, what, ("ivae", "mnist"), STEPS, 2)
        mon.check(state, 2, STEPS, what, swa=True)
        ms_step["implicit-conv-swa"] = ms
        time_update(torch, state, "swa", what, card)
        del state
        torch.cuda.empty_cache()

        what = "phase 8c 25-gaussians"
        argv = TOY_VIS + dump + ["--use-kernels"] + run
        state, _, by_line["25-gaussians-vis"], lines, _, _, _ = published_run(
            torch, kernels, grad, ivae_ardae, argv, what, ("ivae", "toy"), STEPS, 3)
        check_dump(lines, TOY_VIS, what)
        del state

        what = "phase 8d resconv baseline polyak"
        state, _, _, _, ms, mon, _ = published_run(
            torch, kernels, None, vae, BASELINE_POLYAK + SMOKE_ARGS + run, what,
            ("vae", "mnist"), STEPS, 2)
        mon.check(state, 2, STEPS, what)
        del state
        torch.cuda.empty_cache()

        what = "phase 8d toy-maf"
        state, _, _, lines, _, _, _ = published_run(
            torch, kernels, None, vae, TOY_MAF_ARGS + dump + run, what,
            ("vae", "toy"), STEPS, 2)
        if type(state.model).__name__ != "ToyMAFVAE":
            fail(f"{what}: built {type(state.model).__name__}")
        check_dump(lines, TOY_MAF_ARGS, what)
    # 8e: the flagship line without and with Polyak from step 0, nothing
    # else changed, 10 steps in the turns none, polyak, polyak, none; each
    # turn's steady ms/step is the mean of its last three log intervals
    turns = []
    for on in (False, True, True, False):
        flags = with_flags(FLAGSHIP_ARGS, m_weight_avg="polyak" if on else "none",
                           m_weight_avg_start="0")
        ms = drive_line(torch, dev, res, kernels, flags,
                        f"phase 8e flagship {'polyak' if on else 'none'}", card,
                        steps=10)[2]
        turns.append(round(statistics.mean(ms[2:]), 2))
        torch.cuda.empty_cache()
    print(f"phase 8e flagship steady ms/step (steps 5-10), turns none, polyak, "
          f"polyak, none: {turns}; per log interval, phase 5 {ms_step['flagship']}, "
          f"phase 8a {ms_step['flagship-polyak']}; implicit conv, phase 5b "
          f"{ms_step['implicit-conv']}, phase 8b {ms_step['implicit-conv-swa']} "
          f"| {card}", flush=True)


# phase 9a: tests/test_examples.py's iteration counts at the JAX scripts'
# widths; 9b: scripts/run_vae_25gaussians.sh's widths and step flags
EXAMPLE_STEPS = {"dae_toy": 600, "ardae_toy": 1500, "ardae_fit": 2000}
TOY_ENC = dict(input_dim=2, noise_dim=10, h_dim=256, z_dim=2, nonlinearity="relu",
               num_hidden_layers=2)
TOY_ENC_STEPS = 4


def read_png(path):
    """(height, width) of an 8-bit RGB PNG whose chunks' CRCs hold and whose
    pixels decompress to height x (1 + 3 width) bytes."""
    import struct
    import zlib

    raw = open(path, "rb").read()
    if raw[:8] != b"\x89PNG\r\n\x1a\n":
        fail(f"{path}: not a PNG")
    pos, chunks = 8, {}
    while pos < len(raw):
        (n,) = struct.unpack(">I", raw[pos:pos + 4])
        kind, body = raw[pos + 4:pos + 8], raw[pos + 8:pos + 8 + n]
        if struct.unpack(">I", raw[pos + 8 + n:pos + 12 + n])[0] != \
                zlib.crc32(kind + body) & 0xFFFFFFFF:
            fail(f"{path}: bad CRC in {kind}")
        chunks[kind] = chunks.get(kind, b"") + body
        pos += 12 + n
    wid, hgt, depth, color = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    if (depth, color) != (8, 2) or \
            len(zlib.decompress(chunks[b"IDAT"])) != hgt * (1 + 3 * wid):
        fail(f"{path}: not an 8-bit RGB image of its size")
    return hgt, wid


def rel_norm(a, b):
    return float((a - b).norm()) / max(float(b.norm()), 1e-30)


def card_vs_cpu(torch, module, loss_fn, what):
    """One loss and its gradients from the same weights on the card and on
    the CPU (``loss_fn(module, device)``); fails past LOSS_RTOL / GRAD_RTOL.
    Returns (loss rel err, worst grad rel-norm err)."""
    import copy

    out = []
    for dev in ("cuda", "cpu"):
        m = copy.deepcopy(module).to(dev)
        loss = loss_fn(m, dev)
        loss.backward()
        out.append((float(loss.detach()), {k: p.grad.detach().cpu() for k, p in
                                  m.named_parameters() if p.grad is not None}))
    (lc, gc), (lp, gp) = out
    lrel = abs(lc - lp) / abs(lp)
    if gc.keys() != gp.keys():
        fail(f"{what}: gradients on {sorted(gc)} vs {sorted(gp)}")
    grel = max(rel_norm(gc[k], gp[k]) for k in gp)
    if not (math.isfinite(lc) and lrel <= LOSS_RTOL and grel <= GRAD_RTOL):
        fail(f"{what}: card vs CPU loss {lc} / {lp} (rel {lrel:.2e}), worst grad "
             f"rel-norm {grel:.2e}")
    return lrel, grel


def timed(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def drive_examples(torch, card):
    """Phase 9a."""
    from ardae_tpu_torch.examples import ardae_fit, ardae_toy, dae_toy, published
    from ardae_tpu_torch.models.cdae import cardae
    from ardae_tpu_torch.nn.initializers import init_module

    for example, score_type, log_interval in (
            ("dae_toy", "grad", 200), ("dae_toy", "res", 200),
            ("ardae_toy", "grad", 500), ("ardae_fit", None, 500)):
        kw = {"alpha_annealing": 400} if example == "ardae_fit" else {}
        r = published.run(example, score_type, EXAMPLE_STEPS[example],
                          log_interval=log_interval, **kw)
        what = f"phase 9a {example}{' ' + score_type if score_type else ''}"
        if not r["ok"]:
            fail(f"{what}: {r}")
        if example == "ardae_toy":
            held = (f"final loss < 1; distance to the swiss roll before / after a "
                    f"0.5 step along the score at sigma 1 "
                    f"{[(round(a, 4), round(b, 4)) for a, b in r['toward_the_data']]}")
        elif example == "ardae_fit":
            held = (f"mean energy_func4 of 4,000 samples {r['energy']:.4f} against "
                    f"{r['energy_normal']:.4f} of N(0, I) points")
        else:
            held = "losses and score field finite"
        print(f"{what}: {r['iterations']} iterations in {r['seconds']:.2f} s, "
              f"{r['ms_per_iteration']:.3f} ms/iteration; logged losses "
              f"{r['losses']}; {held} | {card}", flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        for mod, args, outs in (
                (dae_toy, ["--out", f"{tmp}/q.png"], ["q.png"]),
                (ardae_toy, ["--out-prefix", f"{tmp}/q"], ["q_s0.0.png", "q_s1.0.png"]),
                (ardae_fit, ["--out", f"{tmp}/h.png"], ["h.png"])):
            name = mod.__name__.rsplit(".", 1)[1]
            _, sec = timed(torch, lambda: mod.main(args + ["--iterations", "20"]))
            shapes = [read_png(os.path.join(tmp, o)) for o in outs]
            if any(sh != (500, 500) for sh in shapes):
                fail(f"phase 9a {name} main: PNGs {shapes}")
            print(f"phase 9a {name} main(), 20 iterations: {len(outs)} readable "
                  f"500 x 500 PNG(s) in {sec:.2f} s", flush=True)

    g = torch.Generator().manual_seed(9)
    x = 2.0 * torch.randn(2560, 2, generator=g)
    std = torch.randn(2560, 1, generator=g)
    eps = torch.randn(2560, 2, generator=g)
    ctx = torch.randn(256, 2, generator=g)
    for name in ("MLPResCDAE", "MLPGradCDAE", "MLPResARDAE", "MLPGradARDAE",
                 "MLPResDAE", "MLPGradDAE"):
        ctor = getattr(cardae, name)
        widths = dict(h_dim=128, num_hidden_layers=3, nonlinearity="softplus")
        if name.endswith("CDAE"):
            net = ctor(2, 2, **widths)
            loss_fn = lambda m, d: cardae.cdae_loss(
                m, x.to(d).reshape(256, 10, 2), ctx.to(d),
                std.to(d).reshape(256, 10, 1), eps=eps.to(d))
        else:
            net = ctor(2, **widths)
            loss_fn = lambda m, d: cardae.dae_loss(m, x.to(d), std.to(d),
                                                   eps=eps.to(d))
        init_module(net, torch.Generator().manual_seed(3))
        lrel, grel = card_vs_cpu(torch, net, loss_fn, f"phase 9a {name}")
        print(f"phase 9a {name} (h 128, 3 layers, 2,560 rows): card vs CPU loss rel "
              f"{lrel:.2e}, worst grad rel-norm {grel:.2e}", flush=True)


def drive_toy_encoders(torch, dev, grad, kernels, card):
    """Phase 9b: 4 joint steps of each toy-encoder fusion through
    train_chunk with the 25-gaussians line's step flags and the grad
    kernel. Returns the launches of the runs, summed."""
    import copy

    import numpy as np

    from ardae_tpu_torch.data.toy import generate_toy_data
    from ardae_tpu_torch.models.ivae.toy import ENC_TYPES, ToyIPVAE
    from ardae_tpu_torch.models.registry import build_cdae
    from ardae_tpu_torch.nn.initializers import init_module
    from ardae_tpu_torch.train.optim import build_optimizer
    from ardae_tpu_torch.train.state import create_train_state
    from ardae_tpu_torch.train.step import StepConfig, train_chunk

    with tempfile.TemporaryDirectory() as tmp:
        train = generate_toy_data("25gaussians", sizes=dict(train=8192, val=16, test=16),
                                  cache_dir=tmp)["train"][0]
    data = torch.as_tensor(train, device=dev)
    bs, steps = 512, TOY_ENC_STEPS
    cfg = StepConfig(std_scale=10000.0, delta=0.1, num_cdae_updates=1,
                     train_nz_cdae=256, train_nz_model=1, ctx_type="lt0",
                     use_kernels=True)
    rng = np.random.default_rng(0)
    total = {n: 0 for n in read_counts(kernels)}
    for enc_type in ENC_TYPES:
        model = init_module(ToyIPVAE(**TOY_ENC, enc_type=enc_type),
                            torch.Generator().manual_seed(0))
        x = torch.as_tensor(train[:bs])
        eps = torch.randn(bs * 4, TOY_ENC["noise_dim"],
                          generator=torch.Generator().manual_seed(1))
        with torch.no_grad():
            z_cpu = model.sample_z(x, eps)
            model.to(dev)
            z_card = model.sample_z(x.to(dev), eps.to(dev)).cpu()
        zrel = rel_norm(z_card, z_cpu)
        if not (bool(torch.isfinite(z_card).all()) and zrel <= 1e-5):
            fail(f"phase 9b {enc_type}: sample_z card vs CPU rel-norm {zrel:.2e}")
        start = copy.deepcopy(model)
        cdae = build_cdae("mlp-grad", input_dim=2, context_dim=2, h_dim=256,
                          n_layers=3, nonlin="softplus", seed=1, device=dev)
        state = create_train_state(
            model, build_optimizer("adam", model.parameters(), 1e-4, beta1=0.5,
                                   momentum=0.5),
            cdae, build_optimizer("rmsprop", cdae.parameters(), 1e-4, beta1=0.5,
                                  momentum=0.5))
        c_idx = rng.integers(0, len(train), (steps, 1, bs))
        m_idx = rng.integers(0, len(train), (steps, bs))
        gen = torch.Generator(device=dev).manual_seed(0)
        reset_counts(kernels)
        metrics, sec = timed(torch, lambda: train_chunk(
            state, cfg, data, c_idx, m_idx, gen, lambda step: 1.0))
        launches = read_counts(kernels)
        expected = {n: (steps if n in grad["fn"].launches else 0) for n in launches}
        if launches != expected:
            fail(f"phase 9b {enc_type}: kernel launches {launches}, expected {expected}")
        losses = {k: float(v) for k, v in metrics.items()}
        moved = sum(not torch.equal(p, q) for p, q in
                    zip(model.parameters(), start.parameters()))
        if not (all(map(math.isfinite, losses.values())) and moved):
            fail(f"phase 9b {enc_type}: metrics {losses}, {moved} tensors moved")
        for n, c in launches.items():
            total[n] += c
        print(f"phase 9b {enc_type}: sample_z card vs CPU rel-norm {zrel:.2e}; "
              f"{steps} steps in {sec:.2f} s ({1e3 * sec / steps:.1f} ms/step, the "
              f"first included); launches {launches}; loss (cdae) "
              f"{losses['cdae_loss']:.4f}, loss (vae) {losses['model_loss']:.4f}; "
              f"{moved}/{len(list(model.parameters()))} model tensors moved | {card}",
              flush=True)
        del state, model, cdae
    return total


def drive_legacy(torch):
    """Phase 9c."""
    from ardae_tpu_torch.models.cdae import legacy
    from ardae_tpu_torch.nn.initializers import init_module

    g = torch.Generator().manual_seed(11)
    x, ctx = torch.randn(2560, 2, generator=g), torch.randn(2560, 2, generator=g)
    eps = torch.randn(2560, 2, generator=g)
    for name, net, c in (("MLPDAE", legacy.MLPDAE(2), None),
                         ("MLPCDAE", legacy.MLPCDAE(2, 2, enc_input=True), ctx)):
        init_module(net, torch.Generator().manual_seed(4))
        arg = lambda d: None if c is None else c.to(d)
        lrel, grel = card_vs_cpu(torch, net, lambda m, d: legacy.legacy_dae_loss(
            m, x.to(d), 0.3, arg(d), eps=eps.to(d)), f"phase 9c {name}")
        with torch.no_grad():
            s_card = legacy.legacy_dae_score(net.to("cuda"), x.cuda(), 0.3,
                                             arg("cuda")).cpu()
            s_cpu = legacy.legacy_dae_score(net.cpu(), x, 0.3, arg("cpu"))
        srel = rel_norm(s_card, s_cpu)
        if srel > LOSS_RTOL:
            fail(f"phase 9c {name}: score card vs CPU rel-norm {srel:.2e}")
        print(f"phase 9c {name} (2,560 rows): card vs CPU loss rel {lrel:.2e}, worst "
              f"grad rel-norm {grel:.2e}, score rel-norm {srel:.2e}", flush=True)


class _Recorder:
    """An optimizer that keeps the gradients it is handed (on the CPU)."""

    def __init__(self, opt, module):
        self.opt, self.module, self.last = opt, module, None

    def zero_grad(self, set_to_none=True):
        self.opt.zero_grad(set_to_none=set_to_none)

    def step(self):
        self.last = {k: p.grad.detach().float().cpu() for k, p in
                     self.module.named_parameters() if p.grad is not None}
        self.opt.step()


def bf16_step_card_vs_cpu(torch, line_args, what, card):
    """Phase 10a/10b: one joint step of the line in bf16 (both phases,
    the plain score net) from the same weights, batches (BF16_CHECK_BS
    items) and injected draws on the card and on the CPU, and in fp32 on
    the CPU. Bounds: every metric (losses, sigma statistics) card vs CPU
    within BF16_RTOL relative; every gradient handed to an optimizer (the
    last cdae update's and the model's) ||card - CPU|| <= BF16_GRAD_RTOL
    ||CPU|| + 2 ||CPU - CPU fp32||, the bound of tests/test_torch_bf16.py
    (the two devices accumulate bf16 sums in other orders, as JAX and the
    port do)."""
    import copy

    from ardae_tpu_torch.cli import ivae_ardae
    from ardae_tpu_torch.models.registry import (
        build_cdae,
        build_ivae_model,
        context_dim_for,
    )
    from ardae_tpu_torch.train.optim import build_optimizer
    from ardae_tpu_torch.train.state import create_train_state
    from ardae_tpu_torch.train.step import StepConfig, one_step

    opt = ivae_ardae.build_parser().parse_args(line_args)
    ctx_dim = context_dim_for(opt.cdae_ctx_type, model_name=opt.model,
                              nchannels=opt.nchannels, nheight=opt.nheight,
                              z_dim=opt.model_z_dim, h_dim=opt.model_h_dim)
    model = build_ivae_model(
        opt.model, nchannels=opt.nchannels, nheight=opt.nheight,
        z_dim=opt.model_z_dim, h_dim=opt.model_h_dim, n_dim=opt.model_n_dim,
        n_layers=opt.model_n_layers, nonlin=opt.model_nonlin, seed=0,
        device="cpu")
    cdae = build_cdae(opt.cdae, input_dim=opt.model_z_dim, context_dim=ctx_dim,
                      h_dim=opt.cdae_h_dim, n_layers=opt.cdae_n_layers,
                      nonlin=opt.cdae_nonlin, seed=1, device="cpu")
    gen = torch.Generator().manual_seed(10)
    bs, u, nz = BF16_CHECK_BS, opt.num_cdae_updates, opt.train_nz_cdae
    ns, d = nz * opt.train_nstd_cdae, opt.nchannels * opt.nheight ** 2
    cdae_b = (torch.rand(u, bs, d, generator=gen) < 0.3).float()
    model_b = (torch.rand(bs, d, generator=gen) < 0.3).float()
    draws = {"cdae": [{
        "latent_eps": torch.randn(bs * nz, model.noise_dim, generator=gen),
        "std": torch.randn(bs, ns, 1, generator=gen),
        "dsm_eps": torch.randn(bs * ns, opt.model_z_dim, generator=gen)}
        for _ in range(u)],
        "model": {"eps": torch.randn(bs * opt.train_nz_model, model.noise_dim,
                                     generator=gen)}}
    out = {}
    for label, dev, dtype in (("card", "cuda", "bfloat16"),
                              ("cpu", "cpu", "bfloat16"),
                              ("cpu fp32", "cpu", "float32")):
        m, c = copy.deepcopy(model).to(dev), copy.deepcopy(cdae).to(dev)
        # the driver's optimizers (its quirk: the model's rmsprop momentum
        # is --d-momentum)
        opt_m = _Recorder(build_optimizer(opt.m_optimizer, m.parameters(),
                                          opt.m_lr, beta1=opt.m_beta1,
                                          momentum=opt.d_momentum), m)
        opt_d = _Recorder(build_optimizer(opt.d_optimizer, c.parameters(),
                                          opt.d_lr, beta1=opt.d_beta1,
                                          momentum=opt.d_momentum), c)
        state = create_train_state(m, opt_m, c, opt_d)
        cfg = StepConfig(
            std_scale=opt.std_scale, delta=opt.delta, num_cdae_updates=u,
            train_nz_cdae=nz, train_nstd_cdae=opt.train_nstd_cdae,
            train_nz_model=opt.train_nz_model, ctx_type=opt.cdae_ctx_type,
            cdae_compute_dtype=dtype, model_compute_dtype=dtype)
        on = {"cdae": [{k: v.to(dev) for k, v in dd.items()} for dd in draws["cdae"]],
              "model": {"eps": draws["model"]["eps"].to(dev)}}
        t0 = time.perf_counter()
        met = one_step(state, cfg, cdae_b.to(dev), model_b.to(dev), 1.0, None, on)
        if dev == "cuda":
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        out[label] = ({k: float(v) for k, v in met.items()},
                      {**{"cdae." + k: g for k, g in opt_d.last.items()},
                       **{"model." + k: g for k, g in opt_m.last.items()}}, secs)
        del m, c, state
    (mc, gc, sc), (mp, gp, sp), (_, g32, s32) = (out[k] for k in
                                                 ("card", "cpu", "cpu fp32"))
    worst_m = max(abs(mc[k] / mp[k] - 1.0) for k in mp)
    if not all(math.isfinite(v) for v in mc.values()) or worst_m > BF16_RTOL:
        fail(f"{what}: bf16 step metrics card {mc} vs CPU {mp}")
    if gc.keys() != gp.keys():
        fail(f"{what}: gradients on {sorted(gc ^ gp)} differ")
    ratios = {}
    for k in gp:
        err = float((gc[k] - gp[k]).norm())
        bound = (BF16_GRAD_RTOL * float(gp[k].norm())
                 + 2.0 * float((gp[k] - g32[k]).norm()))
        ratios[k] = err / max(bound, 1e-30)
    worst = max(ratios, key=ratios.get)
    if ratios[worst] > 1.0:
        fail(f"{what}: bf16 gradient {worst} card vs CPU past its bound "
             f"({ratios[worst]:.2f} of it)")
    rel = {k: rel_norm(gc[k], gp[k]) for k in gp}
    print(f"{what}: one bf16 step (bs {bs}, the line's widths) card vs CPU: "
          f"metrics worst rel {worst_m:.2e} (bound {BF16_RTOL}); gradients "
          f"worst rel-norm {max(rel.values()):.2e} ({max(rel, key=rel.get)}), "
          f"worst share of the bound {ratios[worst]:.2f} ({worst}); step "
          f"seconds card {sc:.2f}, CPU bf16 {sp:.2f}, CPU fp32 {s32:.2f} | "
          f"{card}", flush=True)


def drive_bf16(torch, dev, res, grad, kernels, card, by_line):
    """Phase 10: the canonical sweep's bf16 lines, STEPS steps each
    (10a-10e without --use-kernels: the kernels are fp32 only, so no launch
    may happen; 10f with a bf16 phase B only and --use-kernels: the
    kernels' launches, into ``by_line``). Each run: finite losses and
    sigmas, fp32 master parameters, moved parameters; 10a and 10b also one
    step card vs CPU. Prints each line's ms/step per log interval beside
    its fp32 twin's."""
    twins = []
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "data")
        for what, k, args, twin in (
                ("phase 10a flagship", res, FLAGSHIP_ARGS, "phase 5"),
                ("phase 10b implicit-conv", grad, IMPLICIT_CONV_ARGS, "phase 5b"),
                ("phase 10c mnist-concat", grad, MNIST_CONCAT_ARGS, "phase 5d")):
            drive_line(torch, dev, k, kernels, args + BF16, what, card,
                       data_root=data, use_kernels=False)
            torch.cuda.empty_cache()
            if what != "phase 10c mnist-concat":
                bf16_step_card_vs_cpu(torch, args + BF16, what, card)
            twins.append((what, twin))
        for line, twin in (("resconv", "phase 7 resconv train"),
                           ("conv", "phase 7 conv"), ("mlp", "phase 7 mlp")):
            what = f"phase 10d {line}"
            drive_baseline_line(torch, dev, kernels, line, tmp, card, what=what,
                                extra=BF16_VAE)
            twins.append((what, twin))
        drive_line(torch, dev, res, kernels, AUX_BF16_ARGS,
                   "phase 10e auxresconvct-clip", card, data_root=data,
                   use_kernels=False)
        drive_baseline_line(torch, dev, kernels, "auxresconv", tmp, card,
                            what="phase 10e auxresconv", extra=BF16_VAE)
        twins += [("phase 10e auxresconvct-clip", "phase 5i"),
                  ("phase 10e auxresconv", "phase 7c auxresconv")]
        for what, k, line, args, twin in (
                ("phase 10f flagship", res, "flagship", FLAGSHIP_ARGS, "phase 5"),
                ("phase 10f implicit-conv", grad, "implicit-conv",
                 IMPLICIT_CONV_ARGS, "phase 5b")):
            by_line[f"{line}-bf16-phase-b"], _, _ = drive_line(
                torch, dev, k, kernels, args + BF16_VAE, what, card,
                data_root=data)
            twins.append((what, twin))
            torch.cuda.empty_cache()
    for what, twin in twins:
        print(f"{what} (bf16) ms/step per log interval {MS_STEP[what]}; fp32 "
              f"twin {twin} {MS_STEP[twin]} | {card}", flush=True)


def line_spec(line_args):
    """A parallel/workers.py joint-step spec of an implicit line's flags:
    its models (seeds 0 and 1), optimizers, step config and beta, on
    synthetic dbMNIST-shaped data (1,024 gray rows from seed 11, binarized
    on the device) and random batches from seed 12."""
    import numpy as np

    from ardae_tpu_torch.data.mnist import _synthetic_mnist
    from ardae_tpu_torch.models.registry import context_dim_for

    f = lambda name: flag(line_args, name)
    name, z, h = f("--model"), int(f("--model-z-dim")), int(f("--model-h-dim"))
    ctx_dim = context_dim_for(f("--cdae-ctx-type"), model_name=name, nchannels=1,
                              nheight=28, z_dim=z, h_dim=h)
    bs, updates = int(f("--train-batch-size")), int(f("--num-cdae-updates"))
    rng = np.random.default_rng(12)
    return {
        "model": (name, dict(nchannels=1, nheight=28, z_dim=z, h_dim=h,
                             n_dim=int(f("--model-n-dim")),
                             n_layers=int(f("--model-n-layers")),
                             nonlin=f("--model-nonlin"), seed=0)),
        "cdae": (f("--cdae"), dict(input_dim=z, context_dim=ctx_dim,
                                   h_dim=int(f("--cdae-h-dim")),
                                   n_layers=int(f("--cdae-n-layers")),
                                   nonlin=f("--cdae-nonlin"), seed=1)),
        "opt_model": (f("--m-optimizer"), float(f("--m-lr")),
                      dict(beta1=float(f("--m-beta1")),
                           momentum=float(f("--d-momentum")))),
        "opt_cdae": (f("--d-optimizer"), float(f("--d-lr")),
                     dict(beta1=float(f("--d-beta1")),
                          momentum=float(f("--d-momentum")))),
        "cfg": dict(std_scale=float(f("--std-scale")), delta=float(f("--delta")),
                    num_cdae_updates=updates,
                    train_nz_cdae=int(f("--train-nz-cdae")),
                    train_nstd_cdae=int(f("--train-nstd-cdae")),
                    train_nz_model=int(f("--train-nz-model")),
                    ctx_type=f("--cdae-ctx-type"), use_kernels=True),
        "beta": float(f("--beta-init")), "seed": 0, "binarize": True,
        "data": _synthetic_mnist(1024, seed=11)[0],
        "cdae_idx": rng.integers(0, 1024, (PAR_STEPS, updates, bs)),
        "model_idx": rng.integers(0, 1024, (PAR_STEPS, bs)),
        "snapshots": (0, 1, PAR_STEPS)}


class RowRecorder:
    """Records the rows of each forward launch of a kernel's autograd
    Function in this process (rank 0 of a mesh)."""

    def __init__(self, fn_cls):
        self.fn_cls, self.rows = fn_cls, []

    def __enter__(self):
        self.real = self.fn_cls.forward
        real, rows = self.real, self.rows

        def forward(ctx, act, l0, xbar, *rest):
            rows.append(xbar.shape[0])
            return real(ctx, act, l0, xbar, *rest)

        self.fn_cls.forward = staticmethod(forward)
        return self

    def __exit__(self, *exc):
        self.fn_cls.forward = staticmethod(self.real)


def rel_norm_tree(a, b):
    """||a - b|| / ||b|| over every floating tensor of two nested state
    dicts, taken as one vector."""
    import torch

    num = den = 0.0

    def walk(x, y):
        nonlocal num, den
        if isinstance(x, torch.Tensor):
            if x.is_floating_point():
                num += float(((x.double() - y.double()) ** 2).sum())
                den += float((y.double() ** 2).sum())
        elif isinstance(x, dict):
            for k in x:
                walk(x[k], y[k])
        elif isinstance(x, (list, tuple)):
            for u, v in zip(x, y):
                walk(u, v)

    walk(a, b)
    return (num / max(den, 1e-300)) ** 0.5


def update_rel_norm(after, before, want):
    """||(after - before) - (want - before)|| / ||want - before|| over a
    module's state dict: the parameter update of a world of N against a
    world of one's."""
    import torch

    num = den = 0.0
    for k, w in want.items():
        d_n = after[k].double() - before[k].double()
        d_1 = w.double() - before[k].double()
        num += float(((d_n - d_1) ** 2).sum())
        den += float((d_1 ** 2).sum())
    return (num / max(den, 1e-300)) ** 0.5


def differences(run, one):
    """Every step's worst metric (rel) and, after step 1 and the last, each
    module's parameter update from step 0 and its optimizer state
    (rel-norm) of ``run`` against the world of one ``one``."""
    out = {"metrics": max(abs(m[k] - v) / max(abs(v), 1e-12)
                          for m, m1 in zip(run["metrics"], one["metrics"])
                          for k, v in m1.items())}
    for step in (1, PAR_STEPS):
        snap, snap1 = run["snapshots"][step], one["snapshots"][step]
        for key in [k for k in ("model", "cdae") if k in snap1]:
            out[f"{key} update @{step}"] = update_rel_norm(
                snap[key], one["snapshots"][0][key], snap1[key])
            out[f"opt_{key} @{step}"] = rel_norm_tree(snap[f"opt_{key}"],
                                                      snap1[f"opt_{key}"])
    return out


def compare_worlds(results, one, control, what):
    """A world's rank results against the world of one: replicas bit for
    bit, finite metrics, and ``differences`` within their bounds against
    those of ``control``, another valid run of the world of one. Returns
    (the world's differences, the control's)."""
    import torch

    for r in results[1:]:
        for step, snap in r["snapshots"].items():
            for key, sd in snap.items():
                if isinstance(sd, dict) and key in ("model", "cdae"):
                    for k, v in sd.items():
                        if not torch.equal(v, results[0]["snapshots"][step][key][k]):
                            fail(f"{what}: rank replicas differ at step {step} {key} {k}")
    if not all(math.isfinite(v) for m in results[0]["metrics"] for v in m.values()):
        fail(f"{what}: metrics {results[0]['metrics']} not finite")
    worst, ctl = differences(results[0], one), differences(control, one)
    if worst["metrics"] > PAR_METRICS:
        fail(f"{what}: a metric {worst['metrics']:.3e} off the world of one's")
    for name, v in worst.items():
        if name != "metrics" and v > max(PAR_FLOOR, 2 * ctl[name]):
            fail(f"{what}: {name} {v:.3e} off the world of one's, over "
                 f"max({PAR_FLOOR}, 2 x {ctl[name]:.3e})")
    return worst, ctl


def show(diffs):
    return {n: f"{v:.3e}" for n, v in diffs.items()}


@contextlib.contextmanager
def deterministic():
    """torch's deterministic algorithms within (cuBLAS with its Hopper
    workspace, ":4096:8", which the flag asks to be named): phase 11's runs
    then repeat bit for bit, in this call and the next."""
    import torch

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)


def deterministic_worker(device, worker, spec):
    """A rank worker of parallel/workers.py under ``deterministic``."""
    with deterministic():
        return worker(device, spec)


def world_of_one(worker, device, spec, what):
    """``worker``'s world of one, deterministic, run twice: the two runs must
    agree bit for bit, or the comparisons that take it for their reference
    would vary from call to call."""
    with deterministic():
        one, again = worker(device, spec), worker(device, spec)
    if again["metrics"] != one["metrics"] or rel_norm_tree(
            again["snapshots"], one["snapshots"]) != 0:
        fail(f"{what}: the world of one does not repeat bit for bit")
    return one


def drive_mesh_line(torch, kernels, k, line_args, what, dp, sp, card, devices=None,
                    clock=None):
    """11a / 11b: PAR_STEPS joint steps of an implicit line at its published
    widths with --use-kernels through train_chunk (parallel/workers.py) on a
    (dp, sp) mesh of ranks on ``devices`` (default: all sharing cuda:0, over
    gloo), counters at 0 just before and read just after (rank 0 here; the
    others report theirs), then as a world of one and as the plain
    version's world of one on devices[0]. ``clock``: an optional context
    manager around the mesh run (scripts/torch_mesh_cards.py times the
    collectives in it). Returns the run's numbers, its launches summed over
    the ranks under "launches"."""
    from contextlib import nullcontext

    from ardae_tpu_torch.parallel.launch import backend_for, launch
    from ardae_tpu_torch.parallel.workers import joint_steps

    spec = line_spec(line_args)
    world = dp * sp
    devices = devices or ["cuda:0"] * world
    t0 = time.perf_counter()
    reset_counts(kernels)
    with RowRecorder(k["fn"]) as rec, clock or nullcontext():
        results = launch(deterministic_worker, devices, joint_steps,
                         dict(spec, dp=dp, sp=sp))
    own = read_counts(kernels)
    wall = time.perf_counter() - t0
    if own != results[0]["launches"]:
        fail(f"{what}: rank 0 counted {own}, its worker {results[0]['launches']}")
    # CPU ranks (a rehearsal of scripts/torch_mesh_cards.py) run the plain version
    on_card = torch.device(devices[0]).type == "cuda"
    per_rank = k["updates"] * PAR_STEPS if on_card else 0
    for r, res in enumerate(results):
        want = {n: (per_rank if n in k["fn"].launches else 0) for n in own}
        if res["launches"] != want:
            fail(f"{what}: rank {r} launched {res['launches']}, expected {want}")
    cfg = spec["cfg"]
    rows = spec["cdae_idx"].shape[2] // dp * cfg["train_nz_cdae"] // sp
    if rec.rows != [rows] * per_rank:
        fail(f"{what}: rank 0's {k['kind']} launches took rows {rec.rows}, "
             f"expected {per_rank} of {rows}")
    one = world_of_one(joint_steps, torch.device(devices[0]), spec, what)
    with deterministic():
        plain = joint_steps(torch.device(devices[0]),
                            dict(spec, cfg=dict(spec["cfg"], use_kernels=False)))
    worst, ctl = compare_worlds(results, one, plain, what)
    ms = [[round(v, 2) for v in r["ms"]] for r in results]
    print(f"{what}: {world} ranks (dp={dp}, sp={sp}) on "
          f"{', '.join(sorted(set(devices)))} over {backend_for(devices)}, "
          f"{PAR_STEPS} steps through train_chunk in {wall:.1f} s (spawn "
          f"included); {k['kind']} kernel on {rows}-row shards, {per_rank} fwd + "
          f"{per_rank} bwd a rank; against the world of one {show(worst)}, the "
          f"plain version's world of one {show(ctl)}; ms/step per rank {ms}, "
          f"world of one {[round(v, 2) for v in one['ms']]} | {card}", flush=True)
    return {"launches": {n: sum(r["launches"][n] for r in results) for n in own},
            "ranks": world, "dp": dp, "sp": sp, "rows": rows,
            "launches_per_rank": results[0]["launches"], "worst": worst,
            "control": ctl, "ms_per_rank": ms, "ms_world_of_one": one["ms"]}


def drive_mesh_baseline(torch, kernels, card):
    """11c: the conv baseline (:22) through vae_step on make_mesh(2) against
    a world of one, no kernel launch allowed."""
    import numpy as np

    from ardae_tpu_torch.data.mnist import _synthetic_mnist
    from ardae_tpu_torch.parallel.launch import launch
    from ardae_tpu_torch.parallel.workers import vae_steps

    line = BASELINE_LINES["conv"]
    kw = {k: v for k, v in BASELINE_MODELS["conv"].items() if k != "name"}
    rng = np.random.default_rng(13)
    spec = {"model": ("conv", dict(kw, seed=0)),
            "opt_model": ("adam", float(flag(line, "--lr")),
                          dict(beta1=float(flag(line, "--beta1")))),
            "cfg": dict(loss_scale=1.0 / 784), "beta": 1.0, "seed": 0,
            "binarize": True, "data": _synthetic_mnist(1024, seed=11)[0],
            "model_idx": rng.integers(0, 1024, (PAR_STEPS, 128)),
            "snapshots": (0, 1, PAR_STEPS)}
    reset_counts(kernels)
    results = launch(deterministic_worker, ["cuda:0"] * 2, vae_steps, dict(spec, dp=2))
    if any(read_counts(kernels).values()) or any(
            any(r["launches"].values()) for r in results):
        fail("phase 11c: a kernel launched in the baseline step")
    one = world_of_one(vae_steps, torch.device("cuda:0"), spec, "phase 11c")
    worst, ctl = compare_worlds(results, one, one, "phase 11c")
    print(f"phase 11c conv baseline (:22): 2 ranks share cuda:0 over gloo, "
          f"{PAR_STEPS} steps through vae_step; against the world of one "
          f"{show(worst)} (the world of one repeats bit for bit); ms/step per rank "
          f"{[[round(v, 2) for v in r['ms']] for r in results]}, world of one "
          f"{[round(v, 2) for v in one['ms']]} | {card}", flush=True)


def drive_profiled(torch, res, kernels, card):
    """11e: the flagship line through cli.ivae_ardae with --use-kernels and
    --profile-dir at phase 5's depth: the trace of steps 3-4 parses and
    names both res entry points and their kernels on the card."""
    from ardae_tpu_torch.cli import ivae_ardae

    with tempfile.TemporaryDirectory() as tmp:
        prof = os.path.join(tmp, "prof")
        argv = FLAGSHIP_ARGS + SMOKE_ARGS + [
            "--use-kernels", "--max-iters", str(STEPS), "--profile-dir", prof,
            "--cache", os.path.join(tmp, "exp"), "--data-root", os.path.join(tmp, "d")]
        reset_counts(kernels)
        _, path = ivae_ardae.run(argv)
        torch.cuda.synchronize()
        launches = read_counts(kernels)
        with open(os.path.join(path, "log.txt")) as f:
            log = f.read()
        traces = sorted(os.listdir(prof))
        if traces != ["iter3-4.trace.json"] or f"profiler trace written to {prof}" not in log:
            fail(f"phase 11e: traces {traces}")
        size = os.path.getsize(os.path.join(prof, traces[0]))
        with open(os.path.join(prof, traces[0])) as f:
            events = json.load(f)["traceEvents"]
    want = {n: (STEPS * res["updates"] if n in res["fn"].launches else 0)
            for n in launches}
    if launches != want:
        fail(f"phase 11e: kernel launches {launches}, expected {want}")
    seen = {}
    for e in events:
        seen.setdefault(e.get("cat"), set()).add(e.get("name"))
    kernels_seen = " ".join(seen.get("kernel", ()))
    marks = seen.get("user_annotation", set()) | seen.get("gpu_user_annotation", set())
    for name, kernel in (("fused_dsm_fwd", "loss_partial_kernel"),
                         ("fused_dsm_bwd", "dloss_dr_kernel")):
        if name not in marks or kernel not in kernels_seen:
            fail(f"phase 11e: the trace lacks {name} or its {kernel}")
    print(f"phase 11e --profile-dir: {traces[0]} ({size / 2**20:.1f} MiB, "
          f"{len(events)} events, {len(seen.get('kernel', ()))} kernel names) names "
          f"fused_dsm_fwd / fused_dsm_bwd ({sorted(c for c in seen if c and 'annotation' in c)}) "
          f"and their kernels on the card; launches {launches} | {card}", flush=True)
    return launches


def drive_parallel(torch, res, grad, kernels, card, by_line):
    """Phase 11: data and sample parallelism on the one card (see the
    module docstring); a correctness phase, the ranks sharing cuda:0."""
    from ardae_tpu_torch import graft_entry

    t0 = time.perf_counter()
    by_line["flagship-dp2"] = drive_mesh_line(
        torch, kernels, res, FLAGSHIP_ARGS, "phase 11a flagship (:35)", 2, 1,
        card)["launches"]
    torch.cuda.empty_cache()
    by_line["implicit-conv-sp5"] = drive_mesh_line(
        torch, kernels, grad, IMPLICIT_CONV_ARGS, "phase 11b implicit conv (:41)",
        1, 5, card)["launches"]
    torch.cuda.empty_cache()
    drive_mesh_baseline(torch, kernels, card)
    t = time.perf_counter()
    graft_entry.dryrun_multichip(4, devices=["cuda:0"] * 4)
    print(f"phase 11d dryrun_multichip(4) on 4 ranks sharing cuda:0 in "
          f"{time.perf_counter() - t:.1f} s | {card}", flush=True)
    by_line["flagship-profiled"] = drive_profiled(torch, res, kernels, card)
    print(f"phase 11 passed in {time.perf_counter() - t0:.1f} s", flush=True)


# phase 12: mnist32 (gray 32 x 32) through both drivers at the published
# widths: the mnist-concat line (:47) and the mlp baseline (:28), each with
# --dataset mnist32 --nheight 32
MNIST32_ARGS = with_flags(MNIST_CONCAT_ARGS, dataset="mnist32", nheight="32")
BASELINE_LINES["mlp-mnist32"] = with_flags(BASELINE_LINES["mlp"], dataset="mnist32",
                                           nheight="32")
BASELINE_MODELS["mlp-mnist32"] = dict(BASELINE_MODELS["mlp"], nheight=32)
P12_NOISES = ("laplace", "uniform")
P12_ITEMS, P12_SAMPLES = 16, 1024   # 12b: test items, draws an item


def check_width(torch, data_root, what):
    """The mnist32 splits the drivers read: gray, 1,024 wide."""
    from ardae_tpu_torch.data import get_dataset

    splits = get_dataset("mnist32", root=data_root)
    widths = {sp: splits[sp].shape[1] for sp in ("train", "val", "test")}
    if set(widths.values()) != {1024} or splits["info"]["binarize"]:
        fail(f"{what}: mnist32 splits {widths}, binarize {splits['info']['binarize']}")
    return splits


def drive_mnist32(torch, dev, grad, kernels, card, by_line, tmp):
    """12a: the mnist-concat line on mnist32 through cli.ivae_ardae with
    --use-kernels (6 steps, a val IWS eval, the test eval) and the mlp
    baseline on it through cli.vae (6 steps, no launch). Returns the
    trained implicit state and the splits."""
    data = os.path.join(tmp, "data")
    by_line["mnist32-concat"], state, _ = drive_line(
        torch, dev, grad, kernels, MNIST32_ARGS, "phase 12a mnist32 mnist-concat",
        card, data_root=data, evals=True)
    splits = check_width(torch, data, "phase 12a")
    torch.cuda.empty_cache()
    drive_baseline_line(torch, dev, kernels, "mlp-mnist32", tmp, card,
                        what="phase 12a mnist32 mlp baseline")
    print(f"phase 12a: both drivers trained on mnist32, splits 1,024 wide "
          f"({splits['train'].shape[0]:,} / {splits['val'].shape[0]:,} / "
          f"{splits['test'].shape[0]:,}), gray | {card}", flush=True)
    return state, splits


def drive_bounds(torch, state, splits, card):
    """12b: logprob_kde, logprob_diag and logprob_prior at z 32 and S 1024
    on 16 mnist32 test items, the model trained in 12a copied to the CPU,
    the same draws: per item |card - CPU| <= IWS_ATOL nats; each bound's
    card ms (median of 3, synchronised)."""
    import copy

    from ardae_tpu_torch.models.ivae import api as ivae_api

    g = torch.Generator().manual_seed(19)
    x = torch.as_tensor(splits["test"][:P12_ITEMS])
    model = state.model
    cpu_model = copy.deepcopy(model).cpu()
    ssz, zdim = P12_SAMPLES, model.z_dim
    eps = ivae_api.make_eps(cpu_model, P12_ITEMS, ssz, generator=g)
    draws = {
        "kde": (ivae_api.logprob_kde, dict(
            eps=eps, idx=torch.randint(0, ssz, (P12_ITEMS, ssz), generator=g),
            new_eps=torch.randn(P12_ITEMS, ssz, zdim, generator=g))),
        "diag": (ivae_api.logprob_diag, dict(
            eps=eps, new_eps=torch.randn(P12_ITEMS, ssz, zdim, generator=g))),
        "prior": (ivae_api.logprob_prior, dict(
            z=torch.randn(P12_ITEMS, ssz, zdim, generator=g))),
    }
    for name, (fn, kw) in draws.items():
        on_card = {k: v.cuda() for k, v in kw.items()}
        with torch.no_grad():
            card_v = fn(model, x.cuda(), ssz, reduce="per_item", **on_card)
            ms = time_ms(torch, lambda: fn(model, x.cuda(), ssz, reduce="per_item",
                                           **on_card), reps=3)
            cpu_v = fn(cpu_model, x, ssz, reduce="per_item", **kw)
        card_v = card_v.cpu()
        if not (bool(torch.isfinite(card_v).all()) and bool(torch.isfinite(cpu_v).all())):
            fail(f"phase 12b {name}: the bound is not finite")
        diff = float((card_v - cpu_v).abs().max())
        print(f"phase 12b logprob_{name} at the mnist32 mnist-concat model, "
              f"{P12_ITEMS} test items, S {ssz}, z {zdim}: card vs CPU max per-item "
              f"|diff| {diff:.2e} nats (bound {IWS_ATOL:.0e}); card mean "
              f"{float(card_v.mean()):.4f}; {ms:.3f} ms on the card | {card}",
              flush=True)
        if not diff <= IWS_ATOL:
            fail(f"phase 12b {name}: card and CPU differ by {diff:.2e} nats")


def check_noise(torch, dev, k, fd, what, line, shape):
    """12c: the kernel against its plain version on Laplace and uniform
    noise at a line's shape (phase 3's bounds)."""
    import functools

    from ardae_tpu_torch.models.registry import build_cdae

    bsz, ssz, d, h, layers, act, seed = shape
    for noise_type in P12_NOISES:
        prepare = functools.partial(fd.prepare_inputs, noise_type=noise_type)
        args = dsm_case(prepare, build_cdae, torch, dev, k["cdae"], bsz, ssz, d,
                        h, layers, act, seed)
        lrel, labs, grel, gabs = compare(torch, k["fn"].apply, k["plain"], args)
        print(f"{what} compare {k['cdae']} with {noise_type} noise at the {line} "
              f"shape n={bsz}x{ssz} d={d} h={h} layers={layers} {act}: loss rel "
              f"{lrel:.2e} (abs {labs:.2e}), worst grad rel-norm {grel:.2e} (max "
              f"abs {gabs:.2e})", flush=True)
        if not (lrel <= LOSS_RTOL and grel <= GRAD_RTOL):
            fail(f"{what}: {k['cdae']} kernel disagrees with the plain version "
                 f"on {noise_type} noise")
        del args
        torch.cuda.empty_cache()


def drive_noise_steps(torch, k, kernels, line_args, line, noise_type, card,
                      every_step):
    """12c: PAR_STEPS joint steps of a line at its published widths through
    train_chunk (parallel/workers.py, a world of one on the card, torch's
    deterministic algorithms) with StepConfig(noise_type, use_kernels=True),
    counters at 0 just before and read just after, then the same steps
    with use_kernels False (cdae_loss in plain PyTorch). The metrics of
    every step (``every_step``; else of step 1, the later ones reported)
    within PAR_METRICS relative. Returns the kernel run's launches."""
    from ardae_tpu_torch.parallel.workers import joint_steps

    what = f"phase 12c {line} {noise_type}"
    spec = line_spec(line_args)
    spec["cfg"] = dict(spec["cfg"], noise_type=noise_type)
    reset_counts(kernels)
    with deterministic():
        run = joint_steps(torch.device("cuda:0"), spec)
        launches = read_counts(kernels)
        plain = joint_steps(torch.device("cuda:0"),
                            dict(spec, cfg=dict(spec["cfg"], use_kernels=False)))
    want = {n: (PAR_STEPS * k["updates"] if n in k["fn"].launches else 0)
            for n in launches}
    if launches != want or run["launches"] != want or any(plain["launches"].values()):
        fail(f"{what}: launches {launches} / {run['launches']}, plain "
             f"{plain['launches']}, expected {want} and none")
    per_step = [max(abs(m[n] - v) / max(abs(v), 1e-12) for n, v in p.items())
                for m, p in zip(run["metrics"], plain["metrics"])]
    bounded = per_step if every_step else per_step[:1]
    if not all(math.isfinite(v) for m in run["metrics"] for v in m.values()):
        fail(f"{what}: metrics {run['metrics']} not finite")
    if max(bounded) > PAR_METRICS:
        fail(f"{what}: metrics {max(bounded):.3e} off the plain version's")
    # the parameter updates from step 0; not the optimizer states: the
    # grad-style energy head's bias has no gradient in the plain version
    # (None, so no state) and a zero one from the kernel
    diffs = {f"{key} update @{step}": update_rel_norm(
        run["snapshots"][step][key], run["snapshots"][0][key],
        plain["snapshots"][step][key])
        for step in (1, PAR_STEPS) for key in ("model", "cdae")}
    print(f"{what}: {PAR_STEPS} steps through train_chunk with the {k['kind']} "
          f"kernel, launches {launches}; worst metric rel per step against the "
          f"plain version {[f'{v:.2e}' for v in per_step]} (bound {PAR_METRICS:.0e} "
          f"{'every step' if every_step else 'at step 1'}), {show(diffs)}; "
          f"loss (cdae) {run['metrics'][-1]['cdae_loss']:.4f}; ms/step "
          f"{[round(v, 2) for v in run['ms']]}, plain "
          f"{[round(v, 2) for v in plain['ms']]} | {card}", flush=True)
    return launches


def drive_extras(torch, card):
    """12d: the driverless modules, one small call each on the card against
    the CPU from the same weights and draws: CWNconv2d and WNBilinear (a
    squared error and every gradient, as card_vs_cpu bounds them), the
    relaxed samplers (rel-norm <= LOSS_RTOL), the Jacobian-clamping loss
    of a tanh layer (card_vs_cpu) and shuffle (bit for bit)."""
    from ardae_tpu_torch.core import jacobian_clamping as jac
    from ardae_tpu_torch.core.stats import shuffle
    from ardae_tpu_torch.nn import heads, torchkit_extras as tk
    from ardae_tpu_torch.nn.initializers import init_module
    from ardae_tpu_torch.nn.linear import Linear

    g = torch.Generator().manual_seed(23)
    img, ctx = torch.randn(16, 32, 16, 16, generator=g), torch.randn(16, 32, generator=g)
    target_img = torch.randn(16, 64, 16, 16, generator=g)
    x1, x2 = torch.randn(256, 64, generator=g), torch.randn(256, 48, generator=g)
    target_bil = torch.randn(256, 32, generator=g)
    gen = lambda: torch.Generator().manual_seed(5)
    cases = {
        "CWNconv2d (16, 32, 16, 16) -> 64 channels": (
            init_module(tk.CWNconv2d(32, 32, 64, 3, 1, 1), gen()),
            lambda m, d: torch.mean((m(img.to(d), ctx.to(d)) - target_img.to(d)) ** 2)),
        "WNBilinear 64 x 48 -> 32, 256 rows": (
            init_module(tk.WNBilinear(64, 48, 32), gen()),
            lambda m, d: torch.mean((m(x1.to(d), x2.to(d)) - target_bil.to(d)) ** 2)),
    }
    z = torch.randn(128, 32, generator=g)
    perturb = torch.randn(128, 4, 32, generator=g)
    layer = init_module(Linear(32, 64), gen())
    cases["jac_clamping_loss, tanh layer 32 -> 64, 128 x 4 perturbations, eta_min 4"] = (
        layer, lambda m, d: jac.jac_clamping_loss(
            lambda zz: torch.tanh(m(zz)), torch.tanh(m(z.to(d))), z.to(d), 4, 4.0,
            perturb=perturb.to(d)))
    for name, (module, loss_fn) in cases.items():
        lrel, grel = card_vs_cpu(torch, module, loss_fn, f"phase 12d {name}")
        print(f"phase 12d {name}: card vs CPU loss rel {lrel:.2e}, worst grad "
              f"rel-norm {grel:.2e}", flush=True)
    logits, u = torch.randn(512, 10, generator=g), torch.rand(512, 10, generator=g)
    for fn in (heads.sample_gumbel_softmax, heads.sample_logistic_sigmoid):
        card_v = fn(logits.cuda(), 0.5, u=u.cuda()).cpu()
        rel = rel_norm(card_v, fn(logits, 0.5, u=u))
        if not (bool(torch.isfinite(card_v).all()) and rel <= LOSS_RTOL):
            fail(f"phase 12d {fn.__name__}: card vs CPU rel-norm {rel:.2e}")
        print(f"phase 12d {fn.__name__} (512 x 10, temperature 0.5): card vs CPU "
              f"rel-norm {rel:.2e}", flush=True)
    perm = torch.stack([torch.randperm(1024, generator=g) for _ in range(32)])
    zs = torch.randn(1024, 32, generator=g)
    drawn = shuffle(zs.cuda(), generator=torch.Generator(device="cuda").manual_seed(0))
    if not (torch.equal(shuffle(zs.cuda(), perm=perm.cuda()).cpu(), shuffle(zs, perm=perm))
            and torch.equal(drawn.sort(0).values.cpu(), zs.sort(0).values)):
        fail("phase 12d shuffle: card and CPU differ, or a column is no permutation")
    print(f"phase 12d shuffle (1,024 x 32): card bit for bit the CPU's on one "
          f"permutation a column; drawn on the card, each column a permutation "
          f"| {card}", flush=True)


def drive_phase12(torch, dev, res, grad, kernels, card, by_line, fd):
    """Phase 12: mnist32 through both drivers (12a), the three new bounds on
    its trained model (12b), the Laplace and uniform DSM noise through both
    kernels and the joint step (12c), the driverless modules (12d)."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        state, splits = drive_mnist32(torch, dev, grad, kernels, card, by_line, tmp)
        drive_bounds(torch, state, splits, card)
    del state, splits
    torch.cuda.empty_cache()
    print(f"phase 12a-b passed in {time.perf_counter() - t0:.1f} s", flush=True)
    check_noise(torch, dev, res, fd, "phase 12c", "flagship", res["lines"]["flagship"])
    check_noise(torch, dev, grad, fd, "phase 12c", "implicit-conv",
                grad["lines"]["implicit-conv"])
    for k, args, line, noise_type, every_step in (
            (res, FLAGSHIP_ARGS, "flagship", "laplace", True),
            (res, FLAGSHIP_ARGS, "flagship", "uniform", True),
            (grad, IMPLICIT_CONV_ARGS, "implicit-conv", "laplace", False)):
        by_line[f"{line}-{noise_type}"] = drive_noise_steps(
            torch, k, kernels, args, line, noise_type, card, every_step)
        torch.cuda.empty_cache()
    drive_extras(torch, card)
    print(f"phase 12 passed in {time.perf_counter() - t0:.1f} s", flush=True)


def kernels_under_test(fd, fg):
    """Each kernel's entry of the checks: its autograd function, plain
    version, input maker, launches a cdae update, ragged shapes and line
    shapes ((bsz, ssz, d, h, layers, act, seed))."""
    acts = ("softplus", "relu", "tanh")
    res = {"cdae": "mlp-res", "kind": "res", "fn": fd.FusedDSMFunction,
           "plain": fd.dsm_chain_reference, "prepare": fd.prepare_inputs,
           "updates": 2,
           "ragged": [(3, 37, 5, 24, 2, a, 1) for a in acts]
           + [(4, 300, 32, 136, 3, "tanh", 2)],
           "lines": {"flagship": (128, 625, 32, 512, 5, "softplus", 3),
                     # one rank's rows in phase 11a (dp 2)
                     "flagship-dp2-shard": (64, 625, 32, 512, 5, "softplus", 5)}}
    grad = {"cdae": "mlp-grad", "kind": "grad", "fn": fg.FusedDSMGradFunction,
            "plain": fg.dsm_grad_chain_reference, "prepare": fd.prepare_inputs,
            "updates": 1,
            "ragged": [(3, 37, d, 24, 2, a, 1) for d in (5, 2) for a in acts]
            + [(4, 50, 32, 136, 3, "tanh", 2)],
            "lines": {"implicit-conv": (128, 625, 32, 256, 5, "softplus", 3),
                      "25-gaussians": (512, 256, 2, 256, 3, "softplus", 4),
                      # one rank's rows in phase 11b (sp 5)
                      "implicit-conv-sp5-shard": (128, 125, 32, 256, 5,
                                                  "softplus", 6)}}
    return res, grad


def main():
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from ardae_tpu_torch.models.registry import build_cdae
        from ardae_tpu_torch.ops import fused_dsm as fd
        from ardae_tpu_torch.ops import fused_dsm_grad as fg
        from ardae_tpu_torch.ops import native
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}", file=sys.stderr)
        return 2

    card = card_line()
    dev = torch.device("cuda")
    print(f"phase 1 device: {torch.cuda.get_device_name(0)} | {card} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    res, grad = kernels_under_test(fd, fg)
    kernels = (res, grad)

    t0 = time.perf_counter()
    info = native.build(["fused_dsm", "fused_dsm_grad"])
    fd.build_library()
    fg.build_library()
    for name, inf in info.items():
        print(f"phase 2 build {name}.cu: nvcc sm_90a {inf['seconds']:.1f} s "
              f"(built now: {inf['built']})", flush=True)
        for kname, regs, smem, st, ld in ptxas_report(inf["log"]):
            print(f"phase 2   {kname}: {regs} registers, {smem} B static smem, "
                  f"spills {st} B stored / {ld} B loaded", flush=True)
    lib, _ = fd.build_library()
    ring = {f"{'K' if a else 'MN'}-contiguous A, {'K' if b else 'MN'}-contiguous B":
            lib.dsm_sgemm_smem_bytes(a, b) for a, b in ((1, 1), (1, 0), (0, 0))}
    print(f"phase 2 GEMM ring dynamic smem per block: {ring}", flush=True)
    for name in info:
        count = hmma_count(native.lib_path(name))
        if count is None:
            print(f"phase 2 {name}: cuobjdump not found, HMMA not counted", flush=True)
            continue
        print(f"phase 2 {name}: {count} HMMA instructions in the SASS", flush=True)
        if count == 0:
            fail(f"{name} has no tensor-core instruction")
    print(f"phase 2 both built and loaded in {time.perf_counter() - t0:.1f} s",
          flush=True)

    # fp32 comparisons: TF32 off for every matmul and convolution
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    shapes = {}   # (cdae, line) -> (errors, medians, (flop, bytes))
    for k, what in ((res, "phase 3"), (grad, "phase 3b")):
        check_ragged(torch, dev, build_cdae, k, what)
        for line, shape in k["lines"].items():
            args, labs, gabs = check_line(torch, dev, build_cdae, k, what, line,
                                          shape)
            med = time_kernel(torch, k, args, what.replace("3", "4"), line, card)
            shapes[k["cdae"], line] = ((labs, gabs), med, (
                flops(k["kind"], args), io_bytes(args, [args[5]] + list(args[6:]))))
            del args
            torch.cuda.empty_cache()

    by_line = {}   # each main-path run's launches, by line
    ms_step = {}   # and its ms/step per log interval
    for k, what, line, line_args, dump in (
            (res, "phase 5", "flagship", FLAGSHIP_ARGS, False),
            (grad, "phase 5b", "implicit-conv", IMPLICIT_CONV_ARGS, False),
            (grad, "phase 5d", "mnist-concat", MNIST_CONCAT_ARGS, False),
            (grad, "phase 5e", "25-gaussians", TOY_ARGS, True)):
        by_line[line], _, ms_step[line] = drive_line(
            torch, dev, k, kernels, line_args, what, card, dump=dump)
        torch.cuda.empty_cache()

    drive_heads(torch, dev, res, kernels, card)
    drive_aux(torch, dev, res, grad, kernels, card, by_line)
    drive_pipeline(torch, res, kernels, card)
    drive_baseline(torch, dev, kernels, card)
    drive_aux_baselines(torch, dev, kernels, card)
    drive_toy_baseline(torch, dev, kernels, card)
    drive_published(torch, dev, res, grad, kernels, card, by_line, ms_step)
    t9 = time.perf_counter()
    drive_examples(torch, card)
    by_line["toy-encoders"] = drive_toy_encoders(torch, dev, grad, kernels, card)
    drive_legacy(torch)
    print(f"phase 9 passed in {time.perf_counter() - t9:.1f} s", flush=True)
    t10 = time.perf_counter()
    drive_bf16(torch, dev, res, grad, kernels, card, by_line)
    print(f"phase 10 passed in {time.perf_counter() - t10:.1f} s", flush=True)
    drive_parallel(torch, res, grad, kernels, card, by_line)
    drive_phase12(torch, dev, res, grad, kernels, card, by_line, fd)
    launches = {n: sum(c[n] for c in by_line.values()) for k in kernels
                for n in k["fn"].launches}
    launched_by = {n: {line: c[n] for line, c in by_line.items() if c[n]}
                   for n in launches}

    def numbers(k, line, which):
        (errs, med, work) = shapes[k["cdae"], line]
        part = ("fwd", "bwd")[which]
        flop, nbytes = (w[part] for w in work)
        ops_ms, bytes_ms = 3 * flop / TF32_FLOPS * 1e3, nbytes / HBM_BYTES * 1e3
        return {"max_abs_err": errs[which], "ms": med["kernel"][which],
                "plain_ms": med["plain"][which], "bound_ms": max(ops_ms, bytes_ms),
                "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
                "library_ms": med["library"][which], "flop": flop,
                "fp32_bound_ms": flop / FP32_FLOPS * 1e3}

    def entry(name, k, source, replaces, which):
        # the numbers of the kernel's first line; the other lines' beside them
        first, *others = k["lines"]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[name],
                "launched_by": launched_by[name],
                **numbers(k, first, which), "launches_per_step": k["updates"],
                **{f"at_{line}": numbers(k, line, which) for line in others}}

    grad_sites = ("ardae_tpu/ops/fused_dsm_grad.py:114 and "
                  "ardae_tpu/ops/fused_dsm_grad2.py:90")
    kernels_line = [
        entry("fused_dsm_fwd", res, "ardae_tpu_torch/csrc/fused_dsm.cu",
              "ardae_tpu/ops/fused_dsm.py:123", 0),
        entry("fused_dsm_bwd", res, "ardae_tpu_torch/csrc/fused_dsm.cu",
              "ardae_tpu/ops/fused_dsm.py:139", 1),
        entry("fused_dsm_grad_fwd", grad, "ardae_tpu_torch/csrc/fused_dsm_grad.cu",
              grad_sites, 0),
        entry("fused_dsm_grad_bwd", grad, "ardae_tpu_torch/csrc/fused_dsm_grad.cu",
              grad_sites, 1),
    ]
    print(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f} s",
          flush=True)
    print(json.dumps({"kernels": kernels_line}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
