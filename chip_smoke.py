#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on the card.

    python3 chip_smoke.py

Needs one CUDA card, nvcc and the checkout around this file; exits
non-zero without them. Phases, each printed as one JSON line with its
seconds:

  device   the card's name and power limit (nvidia-smi);
  build    nvcc build of every kernel source (one nvcc per source, all
           started together), with its seconds and ptxas's register and
           spill lines;
  kernels  each kernel (eigh9 K1, the fused MLP forward K2 and backward
           K2b) against its plain PyTorch version on the card at the main
           paths' shapes, with its bars (K2 and K2b also against the exact
           float64 stack), and timed beside the plain version, a PyTorch
           yardstick and its bound; eigh9's two kernels (a warp a matrix
           below ops/eigh9.py's CROSSOVER_B, a thread a matrix at or above
           it) each at B = 1 to 4097, against each other, on a NaN matrix,
           and as one device operation a call (torch.profiler), timed at
           B = 4 to 4096;
  eval_good  the port's `eval_good` entry point at the full width of
           configs/synthetic_baseline.yaml (B=8, N=1000, depth 5, bf16
           MLP, 512 RANSAC hypotheses), 5 batches, seeded weights, with
           every kernel's launch count read around that run alone;
  breakdown  the same path again, each eigh solve timed by solver and
           shape, with its share of a batch;
  train_good  the port's `train_good` entry point at the same width with
           model.use_pallas_mlp: 6 F-loss steps with 2 validations and
           checkpoints, 2 of them under torch.profiler (top device
           kernels and the device's busy share), then 3 qt-loss steps
           (configs/synthetic_qt.yaml's values) from the F checkpoint;
           kernel launch counts read around each run alone;
  check    the card's results against the CPU path on a small input: one
           eval batch, and one train step in float32 and in bf16 with the
           fused MLP, whose every K2 and K2b call is held on its own
           inputs;
and for the frontend slice:
  kernels  K5 (the fused 3x3 conv + affine + ReLU) at the SuperPoint
           path's layer shapes and K4 (the mutual-NN matcher) at K = 1000
           and 2048 and at MATCH_EDGE's cases (K = 1 and 65, D = 132 and
           250, exact ties across tiles, every keypoint invalid), each
           against its plain version and float64, timed beside the plain
           version, a PyTorch yardstick and its bound;
  val_feature  the port's `val_feature` entry point with the conv switch on
           K5 and K = 1000: (a) SuperPointNet at 120x160, 2 pairs a batch,
           5 batches; (b) SuperPointNetGauss2 at 376x1240, 4 pairs a batch
           (one [8, 376, 1240] encoder pass), 2 batches, from a seeded
           `.pth.tar` through --pretrained's loader; exact launch counts
           around each run;
  frontend_breakdown  each stage of a batch of (a) and (b) timed, and one
           batch of each under torch.profiler;
  check    (a)'s first batch on the card against the CPU's plain routes;
and for the joint slice:
  kernels  K5b (the fused conv's backward) at the joint path's six layer
           shapes and SuperPointNet's conv1b, against its plain version and
           float64, timed beside the plain version, cuDNN's backward and its
           bound;
  joint_train  the port's `train_good` entry point with model.if_SP at the
           reference's production point (SuperPointNetGauss2, 376x1240, 4
           pairs a batch, N = 1000, depth 5, float32, the gauss2 weights of
           val_feature (b)): stage 1 (SuperPoint frozen, conv switch on K5)
           and stage 2 (SuperPoint trained, train-mode BN), 3 steps each,
           exact launch counts around each run (stage 1: K5 6, K5b 6, K4 1,
           eigh9 5 a step; stage 2: K5 0, K5b 0), stage 1 leaving SuperPoint
           untouched and stage 2 moving its parameters and every BN buffer;
  joint_step  single steps of each stage between synchronizes, batches on
           the card up front, and one step each under torch.profiler;
  check    one joint step on the card against the CPU's plain routes, in
           both BatchNorm modes (CHECK_JOINT);
and for the solver-variant slice:
  kernels  K3 (the epipolar residual) and its backward at DeepFNet's, the
           F-loss's and the sample loss's shapes, with a zero-row F, s = 0
           and a residual at the clamp, against the plain version and
           float64, two calls bit-identical, timed beside the plain version
           and its bound; then at each caller's broadcast through
           `compute_epi_residual` (tools/profile_epi.py's cases): one device
           operation a forward and one a backward, the kernels' device ms a
           call and the host's ms a call, beside the bound;
  sample_train  the port's `train_good` with model.if_sample_loss at
           configs/synthetic_baseline.yaml's full width: 4 steps, one
           validation, a checkpoint, step 2 profiled; exact launch counts
           (`sample_expected`), no skipped update; then single steps timed;
  variants  `train_good` with if_learn_offsets, if_tri_depth and
           if_goodCorresArch at the same width, 2 steps each, exact launch
           counts (the learned offsets launch K3's point gradient);
  check    one sample-loss train step on the card against the CPU, which
           replays the card's drawn subsets, each against float64 on its
           own solver branches;
and for the conv-formulation slice:
  kernels  X1-X4 (csrc/conv_formulations.cu) at inc.conv1, x [8, 376,
           1240, 64] -> 64 in bf16 with non-trivial s and t: every kind of
           the port's tools/bench_conv_formulations.py against its plain
           version and float64 (the top rows of the first image and the
           bottom rows of the last), every kind also called twice and
           held bit-identical, timed beside the plain version, cuDNN's
           fused bf16 conv + bias + ReLU and the bound (s2d's own 2x floor
           beside it);
  conv_formulations  that tool's entry point on all nine kinds at the same
           size, with exact launch counts around it (2 + 3 x 10 calls a
           kind), no error line, and each kind's max_err against its cuDNN
           yardstick within 2^-6 of max |y|;
and for the dump-tree slice (before the checks, whose traces can come back
empty after check_sample: PERF.md §7):
  kitti_corr  a correspondence tree of known geometry written to a
           temporary directory (two scenes of 11 frames, KITTI's K and
           cam0 -> cam2 offset, 1,200 matches a pair, 0.5 px noise, 15%
           outliers); the port's `train_good` with the values of
           configs/kitti_corr_baseline.yaml and the fused MLP (B=8, N=1000,
           depth 5, 376x1240), 5 steps over 2.5 epochs, and `eval_good`
           with kitti_corr_baselineEval.yaml's, the whole test split (the
           tail padded), the 8-point then the five-point baseline; exact
           launch counts, median_err_q_gt < 1e-3 and median_err_q_base <
           0.5 with each baseline, the npz dumps read back (20 rows, the
           reference keys), the native loader built, its host ms a batch,
           one profiled eval batch a baseline;
  kitti_sp_dump  two 20-frame SyntheticImageSequence scenes at 376x1240 as
           PNG, `dump_sequence_sp` with a seeded SuperPointNet (K5 6 a
           frame, K4 1 a pair; frames/s), then `val_feature --config` and
           `eval_good` over the tree with its frames, then bf16 joint
           training (stage 1, 4 pairs a batch) over the tree one step past
           its first full epoch;
and for the bf16 joint slice:
  kernels  the bf16 K5 and K5b (csrc/conv3x3_bf16.cu) at the six layers
           that take them on the joint path, B = 8 at full width, each
           against its plain version and float64 on the same bf16 operands
           (X1-X4's ulp bars; a quarter of the channels at scale 1 + 2^-9,
           where a float32 dz shows), K5b twice bit for bit, timed beside
           the plain versions, cuDNN (its fused bf16 conv + bias + ReLU; its
           bf16 backward by autograd) and the bound;
  joint_bf16  `train_good` with model.if_SP and model.mlp_dtype bfloat16 (the
           JAX package's production point, the bf16 SuperPoint), conv switch
           on K5: stage 1 with remat none, stage 1 with remat block, stage 2
           with remat block, 3 steps each, exact launch counts (stage 1: the
           bf16 K5 6 a step, 12 under block, K5b 6, K4 1, eigh9 5, K3 5 +
           5; stage 2: no K5 or K5b), float32 checkpoints, stage 1 leaving
           SuperPoint untouched, stage 2 moving every BN buffer;
  joint_bf16_step  bare stage-1 steps with remat none and block (ms, peak
           device memory), one profiled step (busy share, K5 and K5b device
           ms) whose every bf16 K5/K5b call is held against the plain
           versions, and the SuperPoint gradients of that step's frames and
           cotangents under block equal to none's bit for bit;
and for the VO slice:
  eval_vo  the port's `eval_vo` with the repo's trained flagship solver
           (experiments/flagship/ckpt_qt_best.msgpack through the port's
           msgpack reader; its vo_net config: B = 8, N = 1000, depth 5,
           bf16 MLP) on the 60-frame synthetic sequence (seed 123, 59
           pairs), the net then the RANSAC baseline: trans %, rot, ATE, RPE,
           median err_q/err_t, pairs/s, exact launches (eigh9 5 a batch, 7
           with the baseline; K3 5), the net's median err_t under 5 deg, the
           baseline's median err_q under 0.5 deg, and the net's first batch's
           rotations against the port's CPU replay;
  infer    the serving entry on two 376x1240 frames with the gauss2
           SuperPoint of val_feature (b) and the flagship solver, K = 1000,
           the conv switch on K5: the pose JSON, R a rotation, exact launches
           (K5 6, K4 1, eigh9 5, K3 4) and the call's ms;
and for the BA slice (bundle adjustment and pose-graph fusion):
  eval_vo_ba  `eval_vo` with the flagship in three modes, --refine_ba,
           --pose_graph and both: exact launches (the (i, i + 2) sweep adds
           eigh9 40 and K3 40; the polish and the pose graph none), finite
           reports, the fused rot deg/100 m the chained one's within
           PG_ROT_TOL; then the first batch's refined poses on the card
           against the CPU replay of the polish on the card's solver
           outputs, within REFINE_BAR_DEG (rotation and translation
           direction, by chords), the same pairs accepted but near ties,
           and the polish and its factorizations timed;
  eval_good_ba  `eval_good` on the flagship config, without and with
           --refine_ba (B = 8, N = 1000, 5 batches): exact launches, finite
           summaries, the gt sanity;
  bench_ba  tools/bench_ba.py: the Schur BA at C = 100, P = 10,000, the
           square-root BA at C = 32, P = 10,000, the two-stage pose graph
           at 1,000 and 10,000 frames (CG): convergence, ms an iteration,
           peak memory, no kernel launched;
  vo_pose_graph  tools/vo_pose_graph.py at its defaults (30 frames at
           240x320, the repo's sp_joint_11000 SuperPoint, the flagship
           solver, K5 and K4 on): exact launches, finite metrics;
and for the SuperPoint training slice (conv switch on K5 throughout):
  sp_train  tools/train_sp_full.py at its widths (SuperPointNet, B = 32,
           120x160, lr 1e-3, desc_weight 1e-4) from seeded weights: 50
           detector steps, 20 warped joint steps, stage C (16 HA images x
           24 homographies, 10 fine-tune steps), final_eval; exact launches
           around each stage (the train steps and HA take the module
           forward: none; final_eval K5 2), every loss finite, the
           detector CE's last 10 steps' mean under its first 10's, images/s
           a stage; final_eval of the run's checkpoint and of
           sp_joint_11000 held against the CPU's (SP_FINETUNE_BARS);
  sp_finetune  tools/finetune_sp_corners.py, 10 iterations from
           sp_joint_11000 and with --gauss2 from sp_corners_gauss2:
           eval_before and eval_after (K5 8 each), eval_before held against
           the CPU's (SP_FINETUNE_BARS);
  sp_homography  `val_feature --homography 8` with sp_joint_11000 at K =
           300 and K = 1000: exact launches (K5 2 a pass; K4 1 an epipolar
           batch and 1 a homography pair at K = 1000), every h_* metric
           finite, the rates in [0, 1];
  check_sp  one warped joint step as the tools run it (module route,
           float32, no TF32, no cuDNN) on the card against the CPU in
           float32 and float64 (at most CHECK_SP_FLIPS hinge sides
           differing between the two float32 steps), each
           term and gradient leaf within 4x the CPU float32 step's error
           plus 1e-6 of its largest; the HA heatmap (2 images x 4 views)
           within 1e-5 of the CPU's.

and for the JPEG frames slice:
  jpeg     (right after the build) the native image codec built by g++ here:
           every committed fixture of tests/fixtures/image_io decoded equal
           to its committed cv2 decode, the decoder's and encoder's ms at
           376x1240, 8 decodes in 4 threads equal, a deterministic encoder;
  val_feature_s2d  val_feature (b) with the conv switch on the space-to-
           depth route: K5 0 and K4 1 a batch, num_matches and ratios within
           S2D_VF_BARS of the plain route's, keypoints equal but near ties;
  val_pipeline  `eval.ValPipelineFrontend` in precomputed-match and
           SuperPoint mode on the card against the CPU (VP_BARS), exact
           launches (eigh9 7, K3 4; SuperPoint mode K5 6, K4 1 more);
  kitti_sp_dump and infer now read JPEG frames: the dump writes `%06d.jpg`
           (the loader's ms a batch on them and, rewritten as PNG, on PNG;
           the decoder's ms a tree frame), infer takes two `.jpg` frames and
           holds the card to the CPU within INFER_CPU_BARS;
and for the staged joint recipe and SuperPoint VO slice:
  joint_full  tools/train_joint_full.py at the production point of
           experiments/r5_frozen_qsched (bf16 gauss2 SuperPoint, 376x1240,
           N = 1000, 4 pairs a step, frozen BN, qt loss with the quantile
           clamp scheduler, two Adams clipped to 1.0) from the committed
           joint_fullres_train_qt3 pair, 3 steps a stage: exact launches
           around each evaluation and stage, no skipped update, the
           checkpoints; then a train-mode BN leg with recalibration at
           96x128 on the card and the CPU (JF_CPU_BARS);
  joint_ckpts  tools/eval_joint_ckpts.py over joint_full's pairs and the
           committed pair: exact launches, the committed pair's record
           equal to joint_full's eval_init line, the script's defaults at 2
           batches (the JAX package's CPU run in PERF.md), and 120x160 card
           vs CPU, also the solver and RANSAC on the card's own matches;
  vo_superpoint  tools/vo_superpoint.py at its defaults with sp_joint_11000
           and the flagship solver, without and with --refine_ba: exact
           launches, the same match count in both, 17 frames card vs CPU;
  des_fusion  train_good and eval_good with model.if_img_des_to_pointnet on
           a tree with 128-wide SIFT descriptors (C_in 261 and 264): exact
           launches, no K2 or K2b with use_pallas_mlp, card vs CPU;
  dsac     models/dsac.py on 1,000 matches, the card against the CPU on the
           same draws (DSAC_BARS), eigh9 2 a call;
and for the parallel slice:
  parallel  the launcher as a one-rank NCCL job (TRAIN_F's config, 2
           steps) against train_good without a process group, bit for bit;
           the dry run's flagship step data-parallel at 2 ranks and DP x TP
           at 4 (the ranks sharing the card under gloo) against one
           process; the N-sharded fit against weighted_eight_point; the
           distributed Schur, square-root and pose-graph steps against the
           one-device steps; the data-parallel joint step at 376x1240 with
           SuperPoint frozen (K5 on) and trained (sync BN: buffers equal on
           the ranks, all moved); tools/dryrun_multichip at 4 ranks. Each
           world runs in subprocesses (`--parallel-rank`) with its own
           deadline; launches a rank are exact (PAR_EXPECTED).
and for the SIFT slice:
  sift     S1-S3 (csrc/sift.cu, csrc/knn2.cu) against their plain twins on
           the card's pyramids of the committed KITTI frame and two 376x1240
           synthetic frames (S2a and S2b against their twins on a host copy
           of the pyramid; S3 bit for bit, planted ties too), the kernel
           route and the plain route against OpenCV's committed results
           (tests/fixtures/sift, n_features 2000 and 300,
           frontend.sift.PARITY_BARS), each kernel timed beside its twin,
           its bound and (S3) torch.cdist + topk, a full sift_detect of a
           376x1240 frame timed; the SIFT dump of 8 synthetic 376x1240
           frames (S1, S2a, S2b 8, S3 7: exact), infer without
           --pretrained_SP on two JPEG frames (S1-S2b 2, S3 1, eigh9 5, K3
           4; the card against the CPU) and tools/dump_workflow at 376x1240
           cut in depth (22 frames, 18 pairs, 2 steps).

The line before the card's name line is the kernels' JSON summary (eigh9,
K2, K2b, K5, K4, K5b, K3 and its backward, X1-X4, the bf16 K5 and K5b,
S1, S2a, S2b and S3, each
with its launches
on the path that carries it and on every other path, and a rank's on each
parallel path); the last line is {"ok": true, "device":
{...}}. Any failed check exits 1. K5's and K5b's bounds take their
products as FP32 FFMA or as three TF32 passes on the tensor cores,
whichever is faster (`f32_gemm_bound_ms`); `bound_fp32_ms` beside them is
the FFMA-only bound of the kernels' earlier rows.

    python3 chip_smoke.py --plant FAULT

builds, plants FAULT (one of FAULTS: a wiring fault in the MLP's autograd
Function, K2b built with one line changed, K3's backward built with one
line changed or its cluster sum leaving the last rank's partial out,
conv_formulations.cu built with taps9's centre tap read
one column off, matcher.cu's fold keeping the higher index on equal
values, eigh9.cu's warp kernel skipping rotation (7, 8), conv3x3.cu's
tensor-core kernel reading the centre tap one column off, or its fold of
K5b's gradients dropping the last pixel group, the 64-channel kinds'
halo box one row low (X1, X3, X4), X2's ky = 0 weights streamed from
ky = 1's rows, X4's chunk halo one column to the right, an X3 block
bringing the next tile's halo, conv3x3_bf16.cu's forward dropping the
centre tap, or its weight gradient summing dscale and dbias from a float32
dz; or, in the parallel phase's 4-rank world, the N-sharded fit's last
rank leaving its partial Gram out of the all-reduce) and runs only that
kernel's (or that path's) checks, printing their readings; it exits 1 when a check
caught the fault. `--plant none` runs every set and gives the sound
readings the bars are set against.

    python3 chip_smoke.py --phases eval_vo_ba,bench_ba

builds and runs only the named phases of ALONE_PHASES (the BA slice's, the
SuperPoint training slice's, the joint recipe slice's, `sift`, ...),
a quicker look at those paths; it prints no kernels line.

    python3 chip_smoke.py --window '["NAME", ARG, ...]'

runs one profiled window of WINDOWS (eigh9's or K2/K2b's device
operations, K3 at a caller, a joint step, a KITTI eval batch) and prints
its JSON result. The smoke takes a window again this way, in a fresh
process, when its trace in the smoke's process held no device event
(`fresh_window`), and records `fresh_process` beside the readings;
`--fresh-windows` takes every such window again so, to exercise each
retake.
"""

from __future__ import annotations

import contextlib
import glob
import json
import math
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): FP32 outside the tensor cores, dense
# bf16 on the tensor cores, HBM3.
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES_PER_S = 3.35e12
SOURCES = ("eigh9.cu", "mlp.cu", "conv3x3.cu", "matcher.cu", "epi_residual.cu",
           "conv_formulations.cu", "conv3x3_bf16.cu", "sift.cu", "knn2.cu")

# The synthetic_baseline.yaml values, built in code (no YAML reader needed).
BASELINE = {
    "name": "synthetic_good_corr",
    "data": {"dataset": "synthetic", "batch_size": 8, "good_num": 1000,
             "noise_px": 0.5, "outlier_frac": 0.15,
             "image": {"size": [376, 1241, 3]},
             "preprocessing": {"resize": [376, 1241]}},
    "model": {"depth": 5, "clamp_at": 0.02, "if_quality": True, "quality_size": 1,
              "if_learn_offsets": False, "if_tri_depth": False, "if_qt_loss": False,
              "if_sample_loss": False, "if_SP": False},
    "exps": {"five_point": False, "base_name": "ransac_8p"},
    "training": {"seed": 0},
}
EVAL_BATCHES = 5
# Per eval_good batch: depth (5) weighted 8-point fits in DeepFNet, one
# batched RANSAC hypothesis fan-out and one RANSAC refit; K3 (the epipolar
# residual) depth - 1 times in DeepFNet and once in the F-loss, forward only.
EIGH9_PER_BATCH = 5 + 1 + 1
EPI_PER_BATCH = 4 + 1
BREAKDOWN_BATCHES = 2

# Training at the same width with the fused MLP kernels (model.use_pallas_mlp).
TRAIN_F_STEPS, TRAIN_QT_STEPS = 6, 3
VAL_INTERVAL, VAL_BATCHES = 3, 1
PROFILE_START, PROFILE_STEPS = 3, 2
TRAIN_F = {
    **BASELINE,
    "model": {**BASELINE["model"], "use_pallas_mlp": True, "balance_q": 1, "balance_t": 0.1},
    "training": {"seed": 0, "learning_rate": 1e-4, "lr_decay_step": 10, "lr_decay_rate": 1,
                 "clamp_iter1": 3000, "clamp_iter2": 6000,
                 "clamp_q_params": [0.1, 0.01, 0.001], "clamp_t_params": [0.5, 0.3, 0.1],
                 "train_iter": TRAIN_F_STEPS, "val_interval": VAL_INTERVAL,
                 "val_batches": VAL_BATCHES, "save_interval": VAL_INTERVAL,
                 "profile_start": PROFILE_START, "profile_steps": PROFILE_STEPS},
}
# The synthetic_qt.yaml values (it sets no resize), from the F checkpoint.
TRAIN_QT = {
    "name": "synthetic_qt",
    "data": {"dataset": "synthetic", "batch_size": 8, "good_num": 1000, "noise_px": 0.5,
             "outlier_frac": 0.15, "image": {"size": [376, 1241, 3]}},
    "model": {"depth": 5, "clamp_at": 0.02, "if_quality": True, "quality_size": 1,
              "if_qt_loss": True, "balance_q": 1, "balance_t": 1.0, "use_pallas_mlp": True},
    "training": {"seed": 0, "learning_rate": 1e-4, "clamp_iter1": 3000, "clamp_iter2": 6000,
                 "clamp_q_params": [0.1, 0.01, 0.001], "clamp_t_params": [0.5, 0.3, 0.1],
                 "train_iter": TRAIN_F_STEPS + TRAIN_QT_STEPS, "val_interval": 0,
                 "save_interval": 0},
}
# Each output of K2/K2b is held two ways. Against the plain version on the
# same inputs, at the JAX package's bars (tests/test_mlp_pallas.py):
# forward 2e-2, each gradient 1.5e-1 (bf16 backward transients and the
# InstanceNorm backward's cancellation), relative to the largest entry in
# the kernels phase and to the Frobenius norm in the train step, whose
# gradients are sums over calls with cotangents under which a few entries
# cancel (a sound kernel reached 0.166 of the largest entry there; 0.057
# in the Frobenius norm; planted faults 0.50 and more). And against the
# exact stack (float64, nothing rounded after the bf16 inputs), in the
# Frobenius norm: at most F64_FACTOR times the plain version's own
# distance from it plus F64_FLOOR, so the kernel rounds about as well as
# the formula it ports. Sound readings reach 1.05 times the plain
# version's distance, planted faults 1.94 and more (`--plant`; PERF.md).
MLP_BARS = {"forward": 2e-2, "gradient": 1.5e-1}
F64_FACTOR, F64_FLOOR = 1.3, 1e-3
FAULTS = ("none", "dx_zero", "dgamma_dbeta_swapped", "c1_next_item", "c2_next_item",
          "stats_straddle_next_item", "epi_unsafe_norm_grad", "epi_tie_blocked",
          "epi_cluster_drop_rank", "xconv_tap_shift",
          "matcher_fold_last_index", "eigh9_warp_skip_rotation", "conv_mma_tap_shift",
          "conv_fold_drop_group", "xconv_halo_top_row", "xconv_s2d_next_ky",
          "xconv_strip_halo_column", "xconv_tile_next_halo", "conv_bf16_drop_tap",
          "conv_bf16_dz_f32", "nshard_drop_rank")
# Kernel faults, each planted into one source line: (module under
# deepfepe_tpu_torch.ops, the line, its faulty form). c1/c2_next_item build
# K2b's dh with the next item's coefficient; stats_straddle_next_item
# keeps a straddling 64-row tile's sums of the earlier item in the next
# item's partial (the products' epilogue: the statistics and the
# backward's r1, r2); epi_unsafe_norm_grad takes the norm's
# gradient as x / |x| without the zero-norm guard (the plain sqrt's NaN at
# a zero-row F); epi_tie_blocked stops the gradient at d == clamp_at, where
# torch.clamp passes it; epi_cluster_drop_rank has the first block of each
# cluster group leave the last rank's partial out of a split sum (dF's over
# the points, the points' gradients' over the matrices); xconv_tap_shift
# reads taps9's centre tap one column to the right; matcher_fold_last_index keeps the later tile on
# equal values (the higher index); eigh9_warp_skip_rotation skips rotation
# (7, 8) in the warp kernel; conv_mma_tap_shift reads the centre tap's A
# fragments one column to the right in conv3x3.cu's tensor-core kernel (K5
# for Cin >= 2, K5b's dx); conv_fold_drop_group leaves the last pixel group
# out of the fold of K5b's weight and affine gradients; xconv_halo_top_row
# brings the halo box of the 64-channel kinds (X1, X3, X4) from row r0
# instead of r0 - 1 (the top zero row lost, every row one off);
# xconv_s2d_next_ky streams X2's ky = 0 weight slices from ky = 1's rows;
# xconv_strip_halo_column brings X4's chunk halo from column c0 instead of
# c0 - 1; xconv_tile_next_halo has each X3 block bring the halo of the
# next tile (the last block the first tile's) while it writes its own;
# conv_bf16_drop_tap leaves the centre tap's products out of the bf16 K5's
# wgmma kernel; conv_bf16_dz_f32 sums the bf16 K5b's dscale and dbias from
# dz in float32 (not rounded to bf16).
SOURCE_FAULTS = {
    "c1_next_item": ("mlp", "load8(p.c1b + pi, k.c1);  // c1 of the row's item",
                     "load8(p.c1b + (pi + p.pch) % (static_cast<long long>((p.prow + p.Nn - 1) "
                     "/ p.Nn) * p.pch), k.c1);"),
    "c2_next_item": ("mlp", "load8(p.c2b + pi, k.c2);  // c2 of the row's item",
                     "load8(p.c2b + (pi + p.pch) % (static_cast<long long>((p.prow + p.Nn - 1) "
                     "/ p.Nn) * p.pch), k.c2);"),
    "stats_straddle_next_item": ("mlp", "s1 = 0.0f;  s2 = 0.0f;  // the next item's statistics "
                                 "start here", ";  // planted: the sums run on into the next item"),
    "epi_unsafe_norm_grad": (
        "epi_residual", "const float u1 = t.n1 > 0.f ? (-gd * as * t.r1 * t.r1) / t.n1 : 0.f;",
        "const float u1 = (-gd * as * t.r1 * t.r1) / t.n1;"),
    "epi_tie_blocked": ("epi_residual", "const float gd = t.d <= clamp_at ? g : 0.f;",
                        "const float gd = t.d < clamp_at ? g : 0.f;"),
    "epi_cluster_drop_rank": (
        "epi_residual",
        "for (int r = 0; r < split; ++r) s += cluster.map_shared_rank(bpart, rank + r)[e];",
        "for (int r = 0; r < split - (split > 1); ++r) s += cluster.map_shared_rank(bpart, "
        "rank + r)[e];"),
    "xconv_tap_shift": (
        "conv_formulations", "const int hr = hrb + ky * hc + kx;",
        "const int hr = hrb + ky * hc + kx + (KIND == TAPS9 && s == 4);"),
    "matcher_fold_last_index": ("matcher", "if (v > best) {  // a later tile wins only by a "
                                "larger value", "if (v >= best) {"),
    "eigh9_warp_skip_rotation": ("eigh9", "const float apq = __shfl_sync(FULL, g[q], p);",
                                 "const float apq = (p == 7 && q == 8) ? 0.0f "
                                 ": __shfl_sync(FULL, g[q], p);"),
    "conv_mma_tap_shift": (
        "conv", "const float* arow = sas + ((2 * warp + mi + ky) * HC + kx) * CKP;",
        "const float* arow = sas + ((2 * warp + mi + ky) * HC + kx + (tap == 4)) * CKP;"),
    "conv_fold_drop_group": (
        "conv", "for (int g = 0; g < G; ++g) s += part[g * E + e];  // every group, in order",
        "for (int g = 0; g < G - 1; ++g) s += part[g * E + e];"),
    "xconv_halo_top_row": (
        "conv_formulations",
        "const int hr0 = it.r0 - 1;  // the halo's top row: one above the item's rows",
        "const int hr0 = it.r0 - (CIN == 2 * C);"),
    "xconv_s2d_next_ky": (
        "conv_formulations", "const int krow = 64 * s;  // the slice's rows of the packed weights",
        "const int krow = 64 * (s < 6 ? s + 6 : s);"),
    "xconv_strip_halo_column": (
        "conv_formulations",
        "const int hc0 = it.c0 - 1;  // the halo's left column: one left of the item's",
        "const int hc0 = it.c0 - (FAMILY == STRIP ? 0 : 1);"),
    "xconv_tile_next_halo": (
        "conv_formulations",
        "const int item = wk.first + i * wk.step;  // the item whose halo this stage takes",
        "const int item = FAMILY == TILE2D ? (wk.first + 1) % p.n_items : wk.first + i * wk.step;"),
    "conv_bf16_drop_tap": (
        "conv_bf16", "wgmma_rs(acc[j], a[s & 1][kk], db);  // every tap of every slice",
        "if (s / KH != 4) wgmma_rs(acc[j], a[s & 1][kk], db);"),
    "conv_bf16_dz_f32": (
        "conv_bf16", "const float dzf = __bfloat162float(d[e]);  // the sums take the bf16 dz",
        "const float dzf = __fmul_rn(__bfloat162float(dyv) * (__bfloat162float(yy[e]) > 0.0f "
        "? 1.0f : 0.0f), s_l[e]);"),
}


class CheckFailed(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


class Phases:
    def __init__(self):
        self.t = time.perf_counter()

    def emit(self, phase: str, **fields) -> None:
        now = time.perf_counter()
        print(json.dumps({"phase": phase, "seconds": round(now - self.t, 3), **fields}),
              flush=True)
        self.t = now


def cuda_time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean ms a call of back-to-back calls (`tools/profile_mlp.cuda_time_ms`)."""
    from deepfepe_tpu_torch.tools.profile_mlp import cuda_time_ms as timed

    return timed(fn, iters, warmup)


def gram_batch(B: int, rows: int, gen):
    """Gram matrices of random constraint rows, as the path forms them:
    rows = 8 for RANSAC minimal fits, 1000 for the DeepFNet solves."""
    import torch

    X = torch.randn(B, rows, 9, generator=gen)
    X = X / X.norm(dim=-1, keepdim=True)
    return (X.transpose(-1, -2) @ X).cuda()


def eigh_errors(A, w, V, w_ref, V_ref):
    """Kernel (w, V) against the plain version (w_ref, V_ref) and against
    float64 eigenvalues, with the kernel's own residual and orthogonality.
    Errors are relative to ||A||_2, the largest |eigenvalue| (Weyl's bound
    on an eigenvalue's change is ||dA||_2)."""
    import torch

    w64 = torch.linalg.eigvalsh(A.double())
    scale = w64.abs().amax(-1).clamp_min(1e-30)  # ||A||_2, [B]
    dw = ((w - w_ref).abs().amax(-1) / scale).max().item()
    dw64 = ((w.double() - w64).abs().amax(-1) / scale).max().item()
    dw64_plain = ((w_ref.double() - w64).abs().amax(-1) / scale).max().item()
    # Eigenvector comparison only where the eigenvalue is separated by
    # 1e-2 ||A||_2 from the others; near-repeated eigenvalues leave the
    # vectors free within their subspace, and the residuals cover them.
    gaps = (w_ref[..., :, None] - w_ref[..., None, :]).abs()
    gaps = gaps + torch.eye(9, device=A.device) * 1e30
    sep = gaps.amin(-1) / scale[:, None].float() >= 1e-2  # [B, 9]
    dv_cols = (V.abs() - V_ref.abs()).abs().amax(-2)  # [B, 9]
    dV = dv_cols[sep].max().item() if sep.any() else 0.0
    resid = ((A @ V - V * w[:, None, :]).norm(dim=(-1, -2)) / scale.float()).max().item()
    eye = torch.eye(9, device=A.device)
    ortho = (V.transpose(-1, -2) @ V - eye).abs().amax().item()
    return {"dw_rel": dw, "dw_rel_vs_f64": dw64, "dw_rel_plain_vs_f64": dw64_plain,
            "dV_separated": dV, "separated_share": sep.float().mean().item(),
            "residual_rel": resid, "orthogonality": ortho}


EIGH9_BARS = {"dw_rel": 1e-5, "dw_rel_vs_f64": 1e-5, "dV_separated": 1e-4,
              "residual_rel": 1e-5, "orthogonality": 1e-5}


def eigh9_bound_ms(B: int) -> tuple[float, str]:
    """Least time for B matrices: 7 sweeps x 36 rotations x 180 flops each
    over the FP32 rate, against 81 floats read and 90 written over HBM."""
    flops = B * 7 * 36 * 180
    nbytes = B * (81 + 9 + 81) * 4
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# eigh9 at the path's batches (Gram rows as the path forms them): a
# DeepFNet layer (B=8) and the joint step (4) with 1,000 rows, the sample
# loss's subset fits (800 of 20 rows), RANSAC (4096 of 8); 1 and 4097 for
# the ragged edges. Both kernels at each; their times at the path's
# batches, and at 2048 and 3072 between them, set ops/eigh9.py's
# CROSSOVER_B.
EIGH9_CASES = ((1, 1000), (4, 1000), (8, 1000), (800, 20), (4096, 8), (4097, 8))
EIGH9_TIMED = ((4, 1000), (8, 1000), (800, 20), (2048, 8), (3072, 8), (4096, 8))


def device_ops(fn, tries: int = 3) -> tuple:
    """Names of the device operations (kernels, copies, sets) that one call
    of fn runs, from a torch.profiler trace, and the number of traces
    taken. A trace without any device operation is taken again, up to
    `tries` traces: the profiler on the card's machine has once dropped a
    whole call's device events, while a call that launches nothing reads
    empty every time. The count shows when that recurs."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    for n in range(1, tries + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        path = os.path.join(tempfile.mkdtemp(prefix="device_ops_"), "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        ops = [e["name"] for e in events if e.get("ph") == "X"
               and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
        if ops:
            break
    return ops, n


# `--fresh-windows`: take every window of WINDOWS again in a fresh process,
# whatever its trace here held, so that each retake is exercised.
FRESH_WINDOWS = False


def lost(empty: bool) -> bool:
    """Whether a window is taken again in a fresh process: its trace here
    held no device event, or `--fresh-windows` asks for every retake."""
    return empty or FRESH_WINDOWS


def fresh_window(name: str, *args):
    """WINDOWS[name](*args) in a new process (`chip_smoke.py --window`), for
    a profiled window whose trace in this process held no device event at
    all. After one earlier profiler session, every later trace of a process
    can lose the card's events, retraces included (ROADMAP.md, Queue 3's
    open profiler defect), while a process's first session has always held
    them. Returns the window's JSON result."""
    cmd = [sys.executable, os.path.join(REPO, "chip_smoke.py"), "--window",
           json.dumps([name, *args])]
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True)
    check(proc.returncode == 0, f"the {name} window {args} in a fresh process failed: "
          f"{proc.stderr[-2000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def window_eigh9(B: int, rows: int) -> dict:
    """The device operations of one eigh9 call at B (`device_ops`)."""
    import torch

    from deepfepe_tpu_torch.ops.eigh9 import eigh9

    A = gram_batch(B, rows, torch.Generator().manual_seed(B))
    ops, traces = device_ops(lambda: eigh9(A))
    return {"ops": ops, "traces": traces}


def window_mlp(key: str, c_in: int, B: int) -> dict:
    """One K2 or K2b call profiled (`tools/profile_mlp.device_profile`)."""
    from deepfepe_tpu_torch.ops import mlp
    from deepfepe_tpu_torch.tools.profile_mlp import device_profile

    _, (Ws, gammas, betas, Wf, bf), x, g = mlp_inputs(c_in, B, 1000)
    if key == "K2":
        return device_profile(lambda: mlp.mlp_forward(x, Ws, gammas, betas, Wf, bf))
    return device_profile(lambda: mlp.mlp_backward(x, g, Ws, gammas, betas, Wf))


def window_epi(case: str, direction: str, iters: int) -> dict:
    """K3 at one caller's pattern, as `tools/profile_epi.py` reads it."""
    from deepfepe_tpu_torch.tools import profile_epi

    spec = next(c for c in profile_epi.CASES if c[0] == case)
    return profile_epi.timing(profile_epi.case_fns(*spec)[direction], iters)


def window_joint_step(stage: str, steps: int) -> dict:
    """`steps` joint steps of the stage timed, then one under the profiler
    (`phase_joint_step_times`)."""
    import statistics

    import torch

    from deepfepe_tpu_torch.frontend import frontend_params_from_config
    from deepfepe_tpu_torch.loader import model_loader
    from deepfepe_tpu_torch.train.joint import joint_train_step, make_joint_state
    from deepfepe_tpu_torch.utils.weights import load_superpoint

    dev = torch.device("cuda")
    pretrained = vf_pretrained("b")
    cfg = joint_cfg(stage, pretrained)
    t = cfg.training
    state = make_joint_state(model_loader(cfg, dev, torch.Generator().manual_seed(0),
                                          train=True), load_superpoint(pretrained, dev), cfg)
    fp = frontend_params_from_config(cfg)
    batches = joint_batches(cfg, steps + 1, dev)
    ms = []
    with conv_switch("pallas"):
        for b in batches[:steps]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            joint_train_step(state, b, fp, cfg, 0.1, 0.5, train_sp=t.train_SP)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        trace = os.path.join("logs", f"smoke_joint_{stage}_profile", "trace.json")
        os.makedirs(os.path.dirname(trace), exist_ok=True)
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            joint_train_step(state, batches[steps], fp, cfg, 0.1, 0.5, train_sp=t.train_SP)
            torch.cuda.synchronize()
        prof.export_chrome_trace(trace)
    med = statistics.median(ms[1:])
    del state, batches
    torch.cuda.empty_cache()
    return {"step_ms": ms, "median_step_ms_after_first": med,
            "pairs_per_s": cfg.data.batch_size * 1e3 / med, "profiled_step": read_trace(trace),
            "k5b_device_ms": device_ms(trace, K5B_KERNELS),
            "k5_device_ms": device_ms(trace, K5_KERNELS)}


def window_kitti_eval(root: str, ckpt: str, five: bool, path: str) -> dict:
    """One profiled eval batch of the correspondence dump at `root` with the
    checkpoint `ckpt` (`phase_kitti_corr`, `eval_batch_trace`)."""
    import torch

    from deepfepe_tpu_torch.loader import data_loader, model_loader
    from deepfepe_tpu_torch.train import load_checkpoint
    from deepfepe_tpu_torch.train.config import config_from_dict

    ecfg = config_from_dict({**KITTI_EVAL, "data": {**KITTI_EVAL["data"], "dump_root": root}})
    batch = next(data_loader(ecfg, "test").batches(ecfg.data.batch_size, shuffle=False))
    net = model_loader(ecfg, torch.device("cuda"), torch.Generator().manual_seed(0))
    load_checkpoint(ckpt, net)
    ecfg.exps.five_point = five
    return eval_batch_trace(ecfg, net, batch, path)


WINDOWS = {"eigh9": window_eigh9, "mlp": window_mlp, "epi": window_epi,
           "joint_step": window_joint_step, "kitti_eval": window_kitti_eval}


def phase_kernels(ph: Phases) -> dict:
    """eigh9: both kernels against the plain version and float64 at the
    path's batches, against each other, on a NaN matrix, as one device
    operation a call; timed beside the plain version, torch.linalg.eigh and
    the bound."""
    import torch

    from deepfepe_tpu_torch.ops import eigh9 as eigh9_mod
    from deepfepe_tpu_torch.ops.jacobi import jacobi_eigh

    gen = torch.Generator().manual_seed(0)
    max_err = 0.0
    for B, rows in EIGH9_CASES:
        A = gram_batch(B, rows, gen)
        w_ref, V_ref = jacobi_eigh(A)
        for kernel in eigh9_mod.KERNELS:
            w, V = eigh9_mod.launch(A, kernel=kernel)
            torch.cuda.synchronize()
            errs = eigh_errors(A, w, V, w_ref, V_ref)
            ok = all(errs[k] <= bar for k, bar in EIGH9_BARS.items())
            ph.emit("kernels", kernel="eigh9", route=kernel, B=B, rows=rows, errors=errs,
                    bars=EIGH9_BARS, within_bars=ok)
            check(ok, f"eigh9 ({kernel}) at B={B} is outside its bars: {errs}")
            check(bool(torch.isfinite(w).all() and torch.isfinite(V).all()),
                  f"eigh9 ({kernel}) at B={B} gave non-finite values")
            max_err = max(max_err, errs["dw_rel"], errs["dV_separated"])
        # The wrapper is the routed kernel, one launch and one device op.
        before = eigh9_mod.eigh9.launches
        w, V = eigh9_mod.eigh9(A)
        w_k, V_k = eigh9_mod.launch(A, kernel=eigh9_mod.route(B))
        torch.cuda.synchronize()
        check(eigh9_mod.eigh9.launches == before + 2 and torch.equal(w, w_k)
              and torch.equal(V, V_k), f"eigh9 at B={B} is not its routed kernel")

    # The two kernels against each other (same operations, same order).
    A = gram_batch(8, 1000, gen)
    (w_w, V_w), (w_t, V_t) = (eigh9_mod.launch(A, kernel=k) for k in ("warp", "thread"))
    torch.cuda.synchronize()
    cross = eigh_errors(A, w_w, V_w, w_t, V_t)
    warp_vs_thread = {"w_max_abs": (w_w - w_t).abs().max().item(),
                      "V_max_abs": (V_w - V_t).abs().max().item(),
                      "bitwise_equal": bool(torch.equal(w_w, w_t) and torch.equal(V_w, V_t))}
    ok = all(cross[k] <= bar for k, bar in EIGH9_BARS.items())
    ph.emit("kernels", kernel="eigh9", warp_vs_thread=warp_vs_thread, errors=cross,
            within_bars=ok)
    check(ok, f"eigh9's warp and thread kernels disagree at B=8: {cross}")

    # A NaN matrix: non-finite outputs in its own row only, where the plain
    # version has them, and the other matrices unchanged.
    A_nan = A.clone()
    A_nan[3, 2, 5] = float("nan")
    w_p, V_p = jacobi_eigh(A_nan)
    nan_rows = {}
    for kernel in eigh9_mod.KERNELS:
        w, V = eigh9_mod.launch(A_nan, kernel=kernel)
        w0, V0 = eigh9_mod.launch(A, kernel=kernel)
        torch.cuda.synchronize()
        same = bool(torch.equal(torch.isfinite(w), torch.isfinite(w_p))
                    and torch.equal(torch.isfinite(V), torch.isfinite(V_p)))
        bad = sorted(set(torch.nonzero(~torch.isfinite(w))[:, 0].tolist())
                     | set(torch.nonzero(~torch.isfinite(V))[:, 0].tolist()))
        keep = torch.arange(8, device=A.device) != 3
        rest = bool(torch.equal(w[keep], w0[keep]) and torch.equal(V[keep], V0[keep]))
        nan_rows[kernel] = {"nonfinite_rows": bad, "as_plain": same, "others_unchanged": rest}
        check(bad == [3] and same and rest, f"eigh9 ({kernel}) on a NaN matrix: "
              f"{nan_rows[kernel]}")
    ph.emit("kernels", kernel="eigh9", nan_matrix=nan_rows)

    ops, traces, fresh = {}, {}, []
    for B, rows, A_B in ((8, 1000, A), (4096, 8, gram_batch(4096, 8, gen))):
        ops[B], traces[B] = device_ops(lambda: eigh9_mod.eigh9(A_B))
        if lost(not ops[B]):
            r = fresh_window("eigh9", B, rows)
            ops[B], traces[B] = r["ops"], [traces[B], r["traces"]]
            fresh.append(B)
    ph.emit("kernels", kernel="eigh9", device_ops_a_call=ops, traces_taken=traces,
            fresh_process=fresh)
    check(all(len(v) == 1 and "eigh9_" in v[0] for v in ops.values()),
          f"an eigh9 call is not one kernel launch: {ops}")

    timings = {}
    for B, rows in EIGH9_TIMED:
        A = gram_batch(B, rows, gen)
        bound, bound_by = eigh9_bound_ms(B)
        t = {f"{k}_ms": cuda_time_ms(lambda: eigh9_mod.launch(A, kernel=k), 200)
             for k in eigh9_mod.KERNELS}
        t.update(route=eigh9_mod.route(B), wrapper_ms=cuda_time_ms(lambda: eigh9_mod.eigh9(A), 200),
                 library_ms=cuda_time_ms(lambda: torch.linalg.eigh(A), 20),
                 bound_ms=bound, bound_by=bound_by)
        t["ms"] = t[f"{t['route']}_ms"]
        if B in (8, 4096):
            t["plain_ms"] = cuda_time_ms(lambda: jacobi_eigh(A), 3, warmup=1)
        timings[B] = t
        ph.emit("kernels", kernel="eigh9", timing_B=B, **t)
    t, t8 = timings[4096], timings[8]
    return {"name": "eigh9", "route": "cuda", "source": "deepfepe_tpu_torch/csrc/eigh9.cu",
            "replaces": "deepfepe_tpu/ops/pallas/eigh9_pallas.py:34",
            "launches": None, "max_abs_err": max_err, "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "shape": "[4096, 9, 9] f32",
            "wrapper_ms": t["wrapper_ms"], "wrapper_ms_B8": t8["wrapper_ms"],
            "ms_B8": t8["ms"], "route_B8": t8["route"], "plain_ms_B8": t8["plain_ms"],
            "library_ms_B8": t8["library_ms"], "bound_ms_B8": t8["bound_ms"],
            "crossover_B": eigh9_mod.CROSSOVER_B, "warp_vs_thread_B8": warp_vs_thread,
            "per_B": timings}


def phase_eval_good(ph: Phases, cfg) -> dict:
    import numpy as np
    import torch

    from deepfepe_tpu_torch import cli

    reset_counts()
    summary = cli.eval_good(cfg, EVAL_BATCHES, device="cuda")
    torch.cuda.synchronize()
    launches = read_counts()
    expected = EIGH9_PER_BATCH * EVAL_BATCHES
    ph.emit("eval_good", summary=summary, launches=launches, eigh9_expected=expected,
            epi_residual_expected=EPI_PER_BATCH * EVAL_BATCHES,
            pairs_per_s=summary["pairs"] / summary["seconds"])
    check(launches["eigh9"] == expected,
          f"eigh9 launched {launches['eigh9']} times on the path, expected {expected}")
    check(launches["epi_residual"] == EPI_PER_BATCH * EVAL_BATCHES
          and launches["epi_residual_bwd"] == 0,
          f"K3 launched {launches['epi_residual']} times (backward "
          f"{launches['epi_residual_bwd']}), expected {EPI_PER_BATCH * EVAL_BATCHES} (0)")
    check(launches["mlp_forward"] == launches["mlp_backward"] == 0,
          "the MLP kernels ran on a path configured without them")
    check(launches["conv3x3_affine_relu"] == launches["mutual_nn_kernel"]
          == launches["conv3x3_affine_relu_bwd"] == 0,
          "the frontend kernels ran on the solver's path")
    check(summary["pairs"] == EVAL_BATCHES * cfg.data.batch_size, "wrong number of pairs")
    check(all(np.isfinite(v) for v in summary.values() if isinstance(v, float)),
          f"non-finite summary: {summary}")
    check(summary["median_err_q_gt"] < 1e-3,
          f"median_err_q_gt {summary['median_err_q_gt']} >= 1e-3 deg")
    check(summary["median_err_q_base"] < 0.5,
          f"median_err_q_base {summary['median_err_q_base']} >= 0.5 deg")
    return launches


def phase_breakdown(ph: Phases, cfg) -> None:
    """Where an eval_good batch spends its time: the path once more, each
    eigh solve wrapped in synchronizes and timed on the host clock, by
    solver and shape. Runs after the main path's counts were read."""
    import torch

    from deepfepe_tpu_torch import cli
    from deepfepe_tpu_torch.ops import eigh as eigh_mod

    spent = {}

    def timed(label, fn):
        def run(A, *args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(A, *args)
            torch.cuda.synchronize()
            key = f"{label} {list(A.shape)}"
            calls, s = spent.get(key, (0, 0.0))
            spent[key] = (calls + 1, s + time.perf_counter() - t)
            return out
        return run

    saved = eigh_mod.jacobi_eigh, eigh_mod.eigh9
    eigh_mod.jacobi_eigh = timed("jacobi_eigh", saved[0])
    eigh_mod.eigh9 = timed("eigh9", saved[1])
    try:
        summary = cli.eval_good(cfg, BREAKDOWN_BATCHES, device="cuda")
    finally:
        eigh_mod.jacobi_eigh, eigh_mod.eigh9 = saved
    batch_ms = summary["seconds"] * 1e3 / BREAKDOWN_BATCHES
    solves = {k: {"calls_per_batch": c / BREAKDOWN_BATCHES, "ms_per_call": s * 1e3 / c,
                  "share_of_batch": s * 1e3 / BREAKDOWN_BATCHES / batch_ms}
              for k, (c, s) in sorted(spent.items())}
    ph.emit("breakdown", batch_ms=batch_ms, solves=solves,
            share_all_solves=sum(v["share_of_batch"] for v in solves.values()))


def phase_check(ph: Phases, cfg) -> None:
    """The same small batch, weights and hypotheses through the CPU path
    (plain versions) and the card (kernels), both in float32."""
    import dataclasses

    import numpy as np
    import torch

    from deepfepe_tpu_torch.cli import evaluate
    from deepfepe_tpu_torch.utils.device import batch_to_device
    from deepfepe_tpu_torch.data import SyntheticPairs
    from deepfepe_tpu_torch.eval import draw_hypotheses
    from deepfepe_tpu_torch.loader import model_loader
    from deepfepe_tpu_torch.train import eval_step

    small = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, mlp_dtype="float32"))
    n = 200
    batch = SyntheticPairs(image_size=(376, 1241), good_num=n, seed=7).batch(2)
    idxs = [draw_hypotheses(2, n, 512, torch.Generator().manual_seed(1))]
    res, F = {}, {}
    for dev in ("cpu", "cuda"):
        net = model_loader(small, torch.device(dev), torch.Generator().manual_seed(3))
        F_est = eval_step(net, batch_to_device(batch, torch.device(dev)), small)["F_ests"]
        F_est = F_est.double().cpu().numpy()
        F[dev] = np.abs(F_est / np.linalg.norm(F_est, axis=(-1, -2), keepdims=True))
        res[dev] = evaluate(small, net, [batch], torch.device(dev), ransac_idxs=idxs)
    diffs = {k: float(np.abs(res["cpu"][k] - res["cuda"][k]).max())
             for k in ("err_q_est", "err_t_est", "err_q_gt")}
    dF = float(np.abs(F["cpu"] - F["cuda"]).max())
    d_inl = int(np.abs(res["cpu"]["base_inliers"] - res["cuda"]["base_inliers"]).max())
    # Bars: the solver's F to 1e-3 (f32 sums in another order, fed through
    # 5 layers); pose angles to 0.05 deg (acos near 0 has a float32 floor
    # of about 0.03 deg); the RANSAC baseline only by its inlier count,
    # within 5% of N, since an 8-point minimal fit in float32 is
    # ill-conditioned and another rounding can pick another hypothesis.
    bars = {"F_unit": 1e-3, "angle_deg": 0.05, "inliers": 0.05 * n}
    ph.emit("check", max_abs_diff_cpu_vs_cuda={"F_unit": dF, **diffs,
                                               "base_inliers": d_inl}, bars=bars)
    check(dF <= bars["F_unit"], f"F_est: card and CPU differ by {dF}")
    check(all(d <= bars["angle_deg"] for d in diffs.values()), f"card and CPU disagree: {diffs}")
    check(d_inl <= bars["inliers"], f"RANSAC inlier counts differ by {d_inl}")


def build_all(ph: Phases) -> None:
    """One nvcc per source, all started together."""
    from deepfepe_tpu_torch.utils import build

    def one(src):
        t = time.perf_counter()
        path, log = build.build(src)
        return src, path, log, time.perf_counter() - t

    with ThreadPoolExecutor(len(SOURCES)) as pool:
        results = list(pool.map(one, SOURCES))
    for src, path, log, secs in results:
        ptxas = [ln.split("ptxas info    : ")[-1].strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]
        spills = sum(1 for ln in ptxas if "spill" in ln and not ln.startswith("0 bytes stack")
                     and " 0 bytes spill stores, 0 bytes spill loads" not in ln)
        ph.emit("build", source=src, nvcc_seconds=secs, library=os.path.relpath(path, REPO),
                functions_with_spills=spills, ptxas=ptxas)


def mlp_dims(c_in: int) -> list:
    from deepfepe_tpu_torch.models.error_estimator import FEATURES

    return [c_in, *FEATURES, 1]


def mlp_bound_ms(c_in: int, rows: int, backward: bool) -> tuple[float, str]:
    """Least time for the stack over `rows` points: its bf16 products
    (2 flops a multiply-add; the backward recomputes the forward and adds
    the weight- and input-gradient products, 3x) over the bf16 tensor-core
    rate, against x, the float32 parameters and the logits (and, for the
    backward, g, dx and the parameter gradients) moved once over HBM. The
    elementwise work (statistics, normalization) is not counted."""
    d = mlp_dims(c_in)
    macs = sum(a * b for a, b in zip(d[:-1], d[1:]))
    n_params = macs + 2 * sum(d[1:-1]) + d[-1]  # hidden biases are never read
    flops = 2 * rows * macs * (3 if backward else 1)
    floats = rows * d[0] + n_params + rows * d[-1]
    if backward:
        floats += n_params + rows * d[0]
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = 4 * floats / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def exact_pointnet_mlp(x, g, Ws, gammas, betas, Wf, bf, slope: float = 0.01):
    """The stack in float64 with nothing rounded after its bf16 inputs (x
    and the hidden and final weights, which the kernels read as bf16): the
    logits and, by autograd, the gradients for the cotangent g, in the
    order `reference_pointnet_mlp_bwd` returns them."""
    import torch

    def leaf(t, bf16):
        return (t.to(torch.bfloat16) if bf16 else t).double().detach().requires_grad_(True)

    xb, Wsb, Wfb = leaf(x, True), [leaf(W, True) for W in Ws], leaf(Wf, True)
    gs, bs = [leaf(t, False) for t in gammas], [leaf(t, False) for t in betas]
    bf64 = leaf(bf, False)
    h = xb
    for W, gamma, beta in zip(Wsb, gs, bs):
        z = h @ W.T
        mean = z.mean(-2, keepdim=True)
        var = ((z - mean) ** 2).mean(-2, keepdim=True)
        z = (z - mean) * torch.rsqrt(var + 1e-5) * gamma + beta
        h = torch.where(z >= 0, z, slope * z)
    out = h @ Wfb.T + bf64
    grads = torch.autograd.grad(out, [xb, *Wsb, *gs, *bs, Wfb, bf64], g.double())
    L = len(Ws)
    return (out.detach(), grads[0], list(grads[1:1 + L]), list(grads[1 + L:1 + 2 * L]),
            list(grads[1 + 2 * L:1 + 3 * L]), grads[-2], grads[-1])


def errors3(got, plain, exact) -> dict:
    """The kernel's distance from the plain version (`kp`) and the kernel's
    and the plain version's distances from the exact float64 value (`k64`,
    `p64`), each relative to the second value's largest entry; and the same
    three relative to its Frobenius norm (`kpF`, `k64F`, `p64F`)."""
    got, plain, exact = got.double(), plain.double(), exact.double()
    rel = lambda a, b: ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()  # noqa: E731
    frob = lambda a, b: ((a - b).norm() / b.norm().clamp_min(1e-30)).item()  # noqa: E731
    return {"kp": rel(got, plain), "k64": rel(got, exact), "p64": rel(plain, exact),
            "kpF": frob(got, plain), "k64F": frob(got, exact), "p64F": frob(plain, exact)}


def within(kind: str, e: dict, norm: str = "max") -> bool:
    """`e` within MLP_BARS[kind] of the plain version in `norm` ("max" or
    "frobenius") and within F64_FACTOR of the plain version's distance from
    float64."""
    kp = e["kp"] if norm == "max" else e["kpF"]
    return kp <= MLP_BARS[kind] and e["k64F"] <= F64_FACTOR * e["p64F"] + F64_FLOOR


def grad_names(L: int) -> list:
    """Names of the backward's outputs in their flattened order."""
    return ["dx", *[f"dW{i}" for i in range(L)], *[f"dgamma{i}" for i in range(L)],
            *[f"dbeta{i}" for i in range(L)], "dWf", "dbf"]


def flat_grads(r) -> list:
    """(dx, dWs, dgammas, dbetas, dWf, dbf) -> one list in `grad_names` order."""
    return [r[0], *r[1], *r[2], *r[3], r[4], r[5]]


def worst(errs: dict) -> dict:
    """The largest reading of each kind over named errors, with the largest
    ratio of the kernel's to the plain version's distance from float64 in
    each norm and where it is."""
    out = {k: max(e[k] for e in errs.values()) for k in ("kp", "k64", "kpF", "k64F")}
    for suffix in ("", "F"):
        ratio = {k: e["k64" + suffix] / max(e["p64" + suffix], 1e-30) for k, e in errs.items()}
        out["ratio" + suffix] = max(ratio.values())
        out["ratio" + suffix + "_at"] = max(ratio, key=ratio.get)
    return out


def mlp_inputs(c_in: int, B: int = 8, N: int = 1000):
    """A full-width ErrorEstimator on the card with non-trivial affines and
    final bias, its parameters as the wrappers take them, x and g
    (`tools/profile_mlp.mlp_inputs`)."""
    from deepfepe_tpu_torch.tools.profile_mlp import mlp_inputs as inputs

    return inputs(c_in, B, N)


def mlp_kernel_errors(ph: Phases, c_in: int, B: int = 8, N: int = 1000) -> dict:
    """K2 and K2b at full width against their plain versions and the exact
    stack; emits every output's readings and raises outside the bars."""
    import torch

    from deepfepe_tpu_torch.ops import mlp

    _, (Ws, gammas, betas, Wf, bf), x, g = mlp_inputs(c_in, B, N)
    out = mlp.mlp_forward(x, Ws, gammas, betas, Wf, bf)
    ref = mlp.reference_pointnet_mlp(x, Ws, gammas, betas, Wf, bf)
    got = mlp.mlp_backward(x, g, Ws, gammas, betas, Wf)
    want = mlp.reference_pointnet_mlp_bwd(x, g, Ws, gammas, betas, Wf)
    exact = exact_pointnet_mlp(x, g, Ws, gammas, betas, Wf, bf)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out).all()), f"K2 gave non-finite logits at C_in={c_in}")
    fwd = errors3(out, ref, exact[0])
    bwd = {}
    for name, a, b, e in zip(grad_names(len(Ws)), flat_grads(got), flat_grads(want),
                             flat_grads(exact[1:])):
        check(bool(torch.isfinite(a).all()), f"K2b gave non-finite {name} at C_in={c_in}")
        bwd[name] = errors3(a, b, e)
    ok = within("forward", fwd) and all(within("gradient", e) for e in bwd.values())
    ph.emit("kernels", kernel="mlp", c_in=c_in, B=B, N=N, forward=fwd, gradient=bwd,
            gradient_worst=worst(bwd), bars={**MLP_BARS, "f64_factor": F64_FACTOR,
                                              "f64_floor": F64_FLOOR}, within_bars=ok)
    check(ok, f"K2/K2b at C_in={c_in} are outside their bars: {fwd}, {bwd}")
    max_abs = max((a - b).abs().max().item() for a, b in zip(flat_grads(got), flat_grads(want)))
    return {"fwd_abs": (out - ref).abs().max().item(), "bwd_abs": max_abs}


# K2 and K2b are timed at the path's B = 8 and at bench.py's solver-step
# point, B = 64 (N = 1000 each); one call of each is profiled for its device
# operations, which must be mlp_device_ops (L = 5 hidden layers).
MLP_TIMED_B = (8, 64)


def mlp_device_ops(name: str) -> int:
    """Device operations a call: K2 packs, runs a product and a fold a
    layer and the final pass; K2b runs 5 a layer and 3 more."""
    from deepfepe_tpu_torch.models.error_estimator import FEATURES

    per_layer, more = {"mlp_forward": (2, 2), "mlp_backward": (5, 3)}[name]
    return per_layer * len(FEATURES) + more


def mlp_determinism(ph: Phases, c_in: int) -> bool:
    """Two K2 and two K2b calls on the same inputs give the same bits."""
    import torch

    from deepfepe_tpu_torch.ops import mlp

    _, (Ws, gammas, betas, Wf, bf), x, g = mlp_inputs(c_in)
    outs = [(mlp.mlp_forward(x, Ws, gammas, betas, Wf, bf),
             flat_grads(mlp.mlp_backward(x, g, Ws, gammas, betas, Wf))) for _ in range(2)]
    torch.cuda.synchronize()
    (o1, g1), (o2, g2) = outs
    same = bool(torch.equal(o1, o2) and all(torch.equal(a, b) for a, b in zip(g1, g2)))
    ph.emit("kernels", kernel="mlp", c_in=c_in, bitwise_repeat=same)
    check(same, f"two K2/K2b calls at C_in={c_in} gave different bits")
    return same


def phase_mlp_kernels(ph: Phases) -> list:
    """K2 and K2b against their plain versions at B=8, N=1000, C_in 5 and 8
    (the input and update weight MLPs), bit-identical from call to call,
    timed at B = 8 and 64 beside the plain versions and the port's unfused
    route (cuBLAS bf16 matmuls and torch InstanceNorm, the default
    use_pallas_mlp: false): no single PyTorch call computes the whole
    stack, so that route is the yardstick users have. One call of each is
    profiled: its device operations and their time by kernel."""
    import torch

    from deepfepe_tpu_torch.models import ErrorEstimator
    from deepfepe_tpu_torch.ops import mlp
    from deepfepe_tpu_torch.tools.profile_mlp import device_profile

    N = 1000
    rows_out = {}
    for c_in in (5, 8):
        errs = mlp_kernel_errors(ph, c_in, 8, N)
        mlp_determinism(ph, c_in)
        for B in MLP_TIMED_B:
            est, (Ws, gammas, betas, Wf, bf), x, g = mlp_inputs(c_in, B, N)
            unfused = ErrorEstimator(c_in, 1, dtype=torch.bfloat16).cuda()
            unfused.load_state_dict(est.state_dict())
            xg = x.clone().requires_grad_(True)

            def unfused_fwd():
                with torch.no_grad():
                    unfused(x)

            def unfused_fwd_bwd():
                unfused(xg).backward(g)

            est.use_fused = True

            def fused_fwd_bwd():
                est(xg).backward(g)

            def fwd():
                return mlp.mlp_forward(x, Ws, gammas, betas, Wf, bf)

            def bwd():
                return mlp.mlp_backward(x, g, Ws, gammas, betas, Wf)

            n = 1 if B == 8 else 8
            t = {
                "K2_ms": cuda_time_ms(fwd, 50), "K2b_ms": cuda_time_ms(bwd, 20),
                "fused_fwd_bwd_ms": cuda_time_ms(fused_fwd_bwd, 20),
                "plain_fwd_ms": cuda_time_ms(
                    lambda: mlp.reference_pointnet_mlp(x, Ws, gammas, betas, Wf, bf), 10 // n + 1),
                "plain_bwd_ms": cuda_time_ms(
                    lambda: mlp.reference_pointnet_mlp_bwd(x, g, Ws, gammas, betas, Wf),
                    10 // n + 1),
                "unfused_fwd_ms": cuda_time_ms(unfused_fwd, 50),
                "unfused_fwd_bwd_ms": cuda_time_ms(unfused_fwd_bwd, 20),
            }
            prof = {"K2": device_profile(fwd), "K2b": device_profile(bwd)}
            fresh = [key for key, p in prof.items() if lost(p["device_ops"] == 0)]
            for key in fresh:
                prof[key] = fresh_window("mlp", key, c_in, B)
            fb, fb_by = mlp_bound_ms(c_in, B * N, backward=False)
            bb, bb_by = mlp_bound_ms(c_in, B * N, backward=True)
            ph.emit("kernels", kernel="mlp", c_in=c_in, B=B, timing=t, K2_bound_ms=fb,
                    K2_bound_by=fb_by, K2b_bound_ms=bb, K2b_bound_by=bb_by,
                    K2_device=prof["K2"], K2b_device=prof["K2b"], fresh_process=fresh)
            for name, key in (("mlp_forward", "K2"), ("mlp_backward", "K2b")):
                # A trace may miss the window's first kernel, never add one.
                want = mlp_device_ops(name)
                check(0 < prof[key]["device_ops"] <= want,
                      f"a {key} call ran {prof[key]['device_ops']} device operations, "
                      f"not {want}")
            rows_out[c_in, B] = dict(t=t, fb=(fb, fb_by), bb=(bb, bb_by), prof=prof, **errs)

    def row(name, key, c_in):
        r8, r64 = rows_out[c_in, 8], rows_out[c_in, 64]
        fwd = key == "K2"
        ms, plain = (f"{key}_ms", "plain_fwd_ms" if fwd else "plain_bwd_ms")
        lib, bound = ("unfused_fwd_ms" if fwd else "unfused_fwd_bwd_ms"), ("fb" if fwd else "bb")
        return {"ms": r8["t"][ms], "plain_ms": r8["t"][plain], "bound_ms": r8[bound][0],
                "bound_by": r8[bound][1], "library_ms": r8["t"][lib],
                "device_ms": r8["prof"][key]["device_ms"],
                "device_ops": r8["prof"][key]["device_ops"],
                "ms_B64": r64["t"][ms], "plain_ms_B64": r64["t"][plain],
                "bound_ms_B64": r64[bound][0], "library_ms_B64": r64["t"][lib],
                "device_ms_B64": r64["prof"][key]["device_ms"]}

    r8, r5 = rows_out[8, 8], rows_out[5, 8]
    k2 = {"name": "mlp_forward", "route": "cuda", "source": "deepfepe_tpu_torch/csrc/mlp.cu",
          "replaces": "deepfepe_tpu/ops/pallas/mlp_pallas.py:97", "launches": None,
          "max_abs_err": max(r8["fwd_abs"], r5["fwd_abs"]), **row("mlp_forward", "K2", 8),
          "library": "the port's unfused ErrorEstimator forward (cuBLAS bf16 + torch ops)",
          "shape": "x [8, 1000, 8] f32, 64-128-1024-512-256-1; _B64: x [64, 1000, 8]",
          "cin5": row("mlp_forward", "K2", 5), "bitwise_repeat": True}
    k2b = {"name": "mlp_backward", "route": "cuda", "source": "deepfepe_tpu_torch/csrc/mlp.cu",
           "replaces": "deepfepe_tpu/ops/pallas/mlp_pallas.py:126", "launches": None,
           "max_abs_err": max(r8["bwd_abs"], r5["bwd_abs"]), **row("mlp_backward", "K2b", 8),
           "library": "the port's unfused ErrorEstimator forward+backward (autograd)",
           "fused_fwd_bwd_ms": r8["t"]["fused_fwd_bwd_ms"],
           "shape": "g [8, 1000, 1] f32, as K2", "cin5": row("mlp_backward", "K2b", 5),
           "bitwise_repeat": True}
    return [k2, k2b]


def kernel_counters():
    from deepfepe_tpu_torch.ops import conv_formulations as cf
    from deepfepe_tpu_torch.ops.conv import conv3x3_affine_relu, conv3x3_affine_relu_bwd
    from deepfepe_tpu_torch.ops.conv_bf16 import (conv3x3_affine_relu_bf16,
                                                  conv3x3_affine_relu_bwd_bf16)
    from deepfepe_tpu_torch.ops.eigh9 import eigh9
    from deepfepe_tpu_torch.ops.epi_residual import epi_residual, epi_residual_bwd
    from deepfepe_tpu_torch.ops.knn2 import knn2
    from deepfepe_tpu_torch.ops.matcher import mutual_nn_kernel
    from deepfepe_tpu_torch.ops.mlp import mlp_backward, mlp_forward
    from deepfepe_tpu_torch.ops.sift import sift_descriptor, sift_extrema, sift_orientation

    return {"eigh9": eigh9, "mlp_forward": mlp_forward, "mlp_backward": mlp_backward,
            "conv3x3_affine_relu": conv3x3_affine_relu,
            "conv3x3_affine_relu_bwd": conv3x3_affine_relu_bwd,
            "conv3x3_affine_relu_bf16": conv3x3_affine_relu_bf16,
            "conv3x3_affine_relu_bwd_bf16": conv3x3_affine_relu_bwd_bf16,
            "mutual_nn_kernel": mutual_nn_kernel, "epi_residual": epi_residual,
            "epi_residual_bwd": epi_residual_bwd, "conv_strip": cf.conv_strip,
            "conv_strip_async": cf.conv_strip_async, "conv_tile2d": cf.conv_tile2d,
            "conv_s2d": cf.conv_s2d, "sift_extrema": sift_extrema,
            "sift_orientation": sift_orientation, "sift_descriptor": sift_descriptor,
            "knn2": knn2}


def reset_counts() -> None:
    from deepfepe_tpu_torch.ops.epi_residual import epi_residual_bwd

    for fn in kernel_counters().values():
        fn.launches = 0
    epi_residual_bwd.point_launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in kernel_counters().items()}


def read_trace(path: str) -> dict:
    """Device busy share and top device kernels from a Chrome trace of
    torch.profiler: device events are the 'kernel', 'gpu_memcpy' and
    'gpu_memset' categories; the window spans every timed event."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X" and "dur" in e]
    dev = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    t0 = min(e["ts"] for e in events)
    t1 = max(e["ts"] + e["dur"] for e in events)
    busy, end = 0.0, float("-inf")
    for s, e in sorted((e["ts"], e["ts"] + e["dur"]) for e in dev):
        if e > end:
            busy += e - max(s, end)
            end = e
    by_name = {}
    for e in dev:
        calls, us = by_name.get(e["name"], (0, 0.0))
        by_name[e["name"]] = (calls + 1, us + e["dur"])
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    return {"window_ms": (t1 - t0) / 1e3, "device_busy_ms": busy / 1e3,
            "device_busy_share": busy / (t1 - t0) if dev else None,
            "device_events": len(dev), "kernel_names": len(by_name),
            "top_device_ops": [{"name": n[:120], "calls": c, "ms": us / 1e3}
                               for n, (c, us) in top]}


def phase_train_good(ph: Phases) -> dict:
    """The port's train_good at full width with the fused MLP kernels: an
    F-loss run, then a qt-loss run from its checkpoint. Counts are read
    around each run alone."""
    import numpy as np
    import torch

    from deepfepe_tpu_torch import cli
    from deepfepe_tpu_torch.train.config import config_from_dict

    for exp in ("smoke_train_f", "smoke_train_qt"):
        shutil.rmtree(os.path.join(REPO, "logs", exp), ignore_errors=True)
    prof_dir = os.path.join("logs", "smoke_train_f", "profile")
    total = dict.fromkeys(kernel_counters(), 0)
    runs = {}
    for name, raw, steps, vals, pretrained in (
            ("f_loss", TRAIN_F, TRAIN_F_STEPS, TRAIN_F_STEPS // VAL_INTERVAL, ""),
            ("qt_loss", TRAIN_QT, TRAIN_QT_STEPS, 0,
             f"logs/smoke_train_f/checkpoints/deepFNet_{TRAIN_F_STEPS}_checkpoint.pth.tar")):
        cfg = config_from_dict(raw)
        reset_counts()
        last = cli.train_good(cfg, f"smoke_train_{name[:-5]}", pretrained=pretrained,
                              profile_dir=prof_dir if name == "f_loss" else "", device="cuda")
        torch.cuda.synchronize()
        counts = read_counts()
        depth = cfg.model.depth
        # K3: depth - 1 DeepFNet features and the F-loss a forward; the
        # F-loss's backward only where it is the loss (not under qt).
        expected = {**dict.fromkeys(counts, 0),
                    "mlp_forward": depth * (steps + vals * VAL_BATCHES),
                    "mlp_backward": depth * steps,
                    "eigh9": depth * (steps + vals * VAL_BATCHES),
                    "epi_residual": depth * (steps + vals * VAL_BATCHES),
                    "epi_residual_bwd": (depth if name == "f_loss" else depth - 1) * steps}
        ms = last["wall_s"] * 1e3 / steps
        ph.emit("train_good", run=name, steps=steps, validations=vals, last=last, launches=counts,
                expected_launches=expected, ms_per_step=ms,
                pairs_per_s=cfg.data.batch_size * 1e3 / ms,
                timed="host clock over fit (ending in a synchronize), incl. its validations, "
                      "checkpoints and profiled steps")
        check(counts == expected, f"{name}: kernel launches {counts}, expected {expected}")
        check(last["n_iter"] == TRAIN_F_STEPS + (steps if name == "qt_loss" else 0),
              f"{name}: ended at iteration {last['n_iter']}")
        check(all(np.isfinite(v) for v in last.values()), f"{name}: non-finite metrics {last}")
        check(last["nonfinite"] == 0.0, f"{name}: a step had a non-finite loss or gradient")
        ckpt = os.path.join("logs", f"smoke_train_{name[:-5]}", "checkpoints",
                            f"deepFNet_{last['n_iter']}_checkpoint.pth.tar")
        check(os.path.exists(ckpt), f"{name}: no checkpoint {ckpt}")
        runs[name] = {"ms_per_step": ms, "launches": counts}
        for k, v in counts.items():
            total[k] += v
    trace = read_trace(os.path.join(prof_dir, "trace.json"))
    ph.emit("train_good", profile_steps=PROFILE_STEPS, trace=trace)
    phase_step_times(ph)
    return total


def phase_step_times(ph: Phases, raw: dict = TRAIN_F, phase: str = "train_good",
                     steps: int = 6) -> None:
    """Host-clock time of single train steps of the config `raw` at full
    width (F-loss with the fused MLP by default), each between synchronizes,
    batches made up front, the sample loss's draws from one generator; after
    the counted runs, so it changes no count."""
    import statistics

    import torch

    from deepfepe_tpu_torch.utils.device import batch_to_device
    from deepfepe_tpu_torch.loader import data_loader, model_loader
    from deepfepe_tpu_torch.train import make_optimizer, train_step
    from deepfepe_tpu_torch.train.config import config_from_dict

    cfg = config_from_dict(raw)
    dev = torch.device("cuda")
    net = model_loader(cfg, dev, torch.Generator().manual_seed(0), train=True)
    opt = make_optimizer(net, cfg)
    gen = torch.Generator(device=dev).manual_seed(1)
    batches = [batch_to_device(b, dev) for b in
               data_loader(cfg, "train").batches(cfg.data.batch_size, steps)]
    ms = []
    for b in batches:
        torch.cuda.synchronize()
        t = time.perf_counter()
        train_step(net, opt, b, cfg, 0.1, 0.5, gen)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
    med = statistics.median(ms[1:])
    ph.emit(phase, step_ms=ms, median_step_ms_after_first=med,
            pairs_per_s=cfg.data.batch_size * 1e3 / med,
            timed="host clock between synchronizes, batches on the card up front")


def train_step_grads(cfg, dev: str, state: dict, batch: dict, float64: bool = False):
    """Loss and per-parameter gradients of one train step from `state`;
    `float64` runs the same port code with float64 parameters and batch."""
    import torch

    from deepfepe_tpu_torch.utils.device import batch_to_device
    from deepfepe_tpu_torch.loader import model_loader
    from deepfepe_tpu_torch.train import make_optimizer, train_step

    net = model_loader(cfg, torch.device(dev), train=True)
    tb = batch_to_device(batch, torch.device(dev))
    if float64:
        net = net.double()
        net.input_weights.dtype = net.update_weights.dtype = torch.float64
        tb = {k: v.double() if v.is_floating_point() else v for k, v in tb.items()}
    net.load_state_dict(state)
    opt = make_optimizer(net, cfg)
    m = train_step(net, opt, tb, cfg, 0.1, 0.5)
    return float(m["loss"]), {k: p.grad.detach().double().cpu()
                              for k, p in net.named_parameters()}


def mlp_param_keys(L: int) -> list:
    """An ErrorEstimator's parameter names in the order the backward returns
    their gradients (hidden biases, never read, left out)."""
    return [*[f"fw.{3 * i}.weight" for i in range(L)],
            *[f"fw.{3 * i + 1}.weight" for i in range(L)],
            *[f"fw.{3 * i + 1}.bias" for i in range(L)], f"fw.{3 * L}.weight", f"fw.{3 * L}.bias"]


def call_owner(call: dict, state: dict) -> str:
    """Which weight MLP of DeepFNet made a recorded fused call."""
    return next(n for n in ("input_weights", "update_weights")
                if call["Ws"][0].shape == state[f"{n}.fw.0.weight"].shape
                and bool((call["Ws"][0].cpu() == state[f"{n}.fw.0.weight"]).all()))


def fused_step_report(calls: list, state: dict, grads: dict) -> dict:
    """Hold the fused MLP calls of one train step (recorded by
    `ops.mlp.record_calls`) against the plain versions and the exact stack
    on each call's own inputs: every call's logits and, where the step
    needs it, the x-gradient that reached its input; and each weight MLP's
    step gradients against the sums over its calls, which also shows that
    each parameter got its own gradient. Bars as MLP_BARS and F64_FACTOR,
    in the Frobenius norm; hidden biases, which the fused route never
    reads, get exactly zero. Runs on the calls' device."""
    from deepfepe_tpu_torch.ops import mlp

    L = len(calls[0]["Ws"])
    keys = mlp_param_keys(L)
    per_call, sums, g_abs = {}, {}, {}
    for j, c in enumerate(calls):
        net = call_owner(c, state)
        p = (c["Ws"], c["gammas"], c["betas"], c["Wf"])
        ref = mlp.reference_pointnet_mlp(c["x"], *p, c["bf"], c["slope"])
        plain = flat_grads(mlp.reference_pointnet_mlp_bwd(c["x"], c["g"], *p, c["slope"]))
        exact = exact_pointnet_mlp(c["x"], c["g"], *p, c["bf"], c["slope"])
        errs = {"out": errors3(c["out"], ref, exact[0])}
        if "dx" in c:
            errs["dx"] = errors3(c["dx"], plain[0], exact[1])
        per_call[f"{j}:{net}"] = errs
        s_plain, s_exact = sums.setdefault(net, ([0.0] * len(keys), [0.0] * len(keys)))
        for i, (a, e) in enumerate(zip(plain[1:], flat_grads(exact[1:])[1:])):
            s_plain[i] = s_plain[i] + a.double()
            s_exact[i] = s_exact[i] + e
        g_abs[net] = g_abs.get(net, 0.0) + c["g"].double().abs().sum().item()
    params, vanishing = {}, {}
    for net, (sp, se) in sums.items():
        for i, k in enumerate(keys):
            got = grads[f"{net}.{k}"].to(sp[i].device)
            # The final bias's exact gradient is the sum of the cotangent,
            # zero where the loss sees the logits through a softmax over the
            # points; then only its rounding is left, at most 2^-9 of each
            # |g| from g's bf16 cast, and it is held to twice that.
            if k == keys[-1] and se[i].abs().max().item() <= 2**-9 * g_abs[net]:
                vanishing[f"{net}.{k}"] = {"abs": got.abs().max().item(),
                                           "bound": 2**-8 * g_abs[net]}
            else:
                params[f"{net}.{k}"] = errors3(got, sp[i], se[i])
    hidden_bias = max(grads[f"{net}.fw.{3 * i}.bias"].abs().max().item()
                      for net in sums for i in range(L))
    ok = (all(within("forward", e["out"], "frobenius") for e in per_call.values())
          and all(within("gradient", e["dx"], "frobenius") for e in per_call.values() if "dx" in e)
          and all(within("gradient", e, "frobenius") for e in params.values())
          and all(v["abs"] <= v["bound"] for v in vanishing.values()) and hidden_bias == 0.0)
    dx_errs = {k: e["dx"] for k, e in per_call.items() if "dx" in e}
    return {"calls": len(calls), "calls_with_dx": len(dx_errs),
            "out_worst": worst({k: e["out"] for k, e in per_call.items()}),
            "dx_worst": worst(dx_errs) if dx_errs else None, "param_worst": worst(params),
            "per_call": per_call, "params": params, "vanishing": vanishing,
            "hidden_bias_max": hidden_bias, "within_bars": ok}


def phase_check_train(ph: Phases) -> None:
    """One train step on the card against the CPU path (plain versions) from
    the same weights and batch (B=2, N=200, depth 5).

    float32, unfused MLP: the safe_eigh backward and the eigh9 kernel. The
    loss to 1e-4 relative; the gradients, each relative in the Frobenius
    norm to the same step in float64 on the CPU, the worst over all
    parameters at most twice the CPU's worst plus 1e-3 (two float32 paths,
    each with its own rounding fed through 5 layers; the CPU's worst is
    about 0.3%). Gradients that are zero in exact arithmetic (hidden
    biases, the final bias) stay below 1e-6.

    bfloat16, fused MLP: the loss to 2e-2 relative (the MLP forward bar).
    The whole step's bf16 gradient is mostly rounding at this size (up to
    several times the float64 gradient's norm away, on the CPU as on the
    card), so the fused route is held call by call: `fused_step_report`
    holds every K2 and K2b call of the card's step on its own inputs, and
    each parameter's step gradient against the sum over its calls. The
    model code around the MLP is the float32 route's."""
    import torch

    from deepfepe_tpu_torch.data import SyntheticPairs
    from deepfepe_tpu_torch.loader import model_loader
    from deepfepe_tpu_torch.ops import mlp
    from deepfepe_tpu_torch.train.config import config_from_dict

    batch = SyntheticPairs(image_size=(376, 1241), good_num=200, seed=7).batch(2)
    frob = lambda a, b: float((a - b).norm() / b.norm().clamp_min(1e-30))  # noqa: E731
    cfgs = {route: config_from_dict({**TRAIN_F, "model": {**TRAIN_F["model"], **model}})
            for route, model in (("f32", {"mlp_dtype": "float32", "use_pallas_mlp": False}),
                                 ("bf16_fused", {"mlp_dtype": "bfloat16"}))}
    state = model_loader(cfgs["f32"], torch.device("cpu"),
                         torch.Generator().manual_seed(3)).state_dict()

    cfg = cfgs["f32"]
    l64, g64 = train_step_grads(cfg, "cpu", state, batch, float64=True)
    live = [k for k, g in g64.items() if g.abs().max().item() > 1e-6]
    (l_cpu, g_cpu), (l_gpu, g_gpu) = (train_step_grads(cfg, d, state, batch)
                                      for d in ("cpu", "cuda"))
    dist = {k: (frob(g_gpu[k], g64[k]), frob(g_cpu[k], g64[k])) for k in live}
    card_worst = max(a for a, _ in dist.values())
    cpu_worst = max(b for _, b in dist.values())
    zero_max = max(max(g_gpu[k].abs().max().item(), g_cpu[k].abs().max().item())
                   for k in g64 if k not in live)
    loss_rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    f32_ok = loss_rel <= 1e-4 and zero_max <= 1e-6 and card_worst <= 2.0 * cpu_worst + 1e-3
    f32 = {"loss_rel_card_vs_cpu": loss_rel, "loss_rel_cpu_vs_f64": abs(l_cpu - l64) / abs(l64),
           "worst_param": max(dist, key=lambda k: dist[k][0]), "max_card_vs_f64": card_worst,
           "max_cpu_vs_f64": cpu_worst, "zero_grads_max": zero_max, "within_bars": f32_ok,
           "bars": {"loss_rel": 1e-4, "grad": "card worst <= 2.0 x cpu worst + 0.001"}}

    cfg = cfgs["bf16_fused"]
    l_cpu, _ = train_step_grads(cfg, "cpu", state, batch)
    with mlp.record_calls() as calls:
        l_gpu, g_gpu = train_step_grads(cfg, "cuda", state, batch)
    fused = fused_step_report(calls, state, g_gpu)
    loss_rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    fused.update(loss_rel_card_vs_cpu=loss_rel, loss_bar=2e-2)
    fused["within_bars"] = fused["within_bars"] and loss_rel <= 2e-2
    brief = {k: v for k, v in fused.items() if k not in ("per_call", "params")}
    ph.emit("check", train_step={"f32": f32, "bf16_fused": brief})
    ph.emit("check", train_step_fused_per_call=fused["per_call"],
            train_step_fused_params=fused["params"])
    check(f32_ok, f"float32 train step on the card disagrees with the CPU: {f32}")
    check(fused["within_bars"], f"fused train step on the card is outside its bars: {brief}")


# ---------------------------------------------------------------- frontend

# val_feature at the SuperPoint variants' full widths, K = 1000 keypoints
# (the FrontendParams default; the CLI's 300 sits below K4's K >= 768) and
# the conv switch on the kernel: (a) SuperPointNet at the CLI's 120x160,
# batch 2, 5 batches; (b) SuperPointNetGauss2 at the KITTI frame size,
# batch 4 (one [8, 376, 1240] encoder pass), 2 batches.
VF_K = 1000
VF_RUNS = {
    "a": {"net": "SuperPointNet", "image_size": (120, 160), "batch_size": 2, "batches": 5},
    "b": {"net": "SuperPointNetGauss2", "image_size": (376, 1240), "batch_size": 4,
          "batches": 2},
}
# Launches per batch. K5 runs on the layers with H * W >= 16,384: (a)
# conv1a, conv1b at 120x160; (b) inc x2 at 376x1240, down1 x2 at 188x620,
# down2 x2 at 94x310 (down3's 47x155 = 7,285 px takes the plain route).
# K4 runs once a batch, on both frames' [B, 1000, 256] descriptors.
VF_PER_BATCH = {"a": {"conv3x3_affine_relu": 2, "mutual_nn_kernel": 1},
                "b": {"conv3x3_affine_relu": 6, "mutual_nn_kernel": 1}}
# K5 at the path's shapes (B, H, W, Cin, C): run (b)'s six kernel layers
# (down1's two share one shape) and run (a)'s conv1b.
CONV_SHAPES = (("inc.conv0", 8, 376, 1240, 1, 64), ("inc.conv1", 8, 376, 1240, 64, 64),
               ("down1.conv1", 8, 188, 620, 64, 64), ("down2.conv0", 8, 94, 310, 64, 128),
               ("down2.conv1", 8, 94, 310, 128, 128), ("a.conv1b", 4, 120, 160, 64, 64))
# K5 is held to tests/test_conv_pallas.py's atol of 5e-5, set there for
# outputs of magnitude about 1-10, here scaled by max(1, max|y|) of each
# output, against the plain version and against float64 (on the first
# CONV_F64_ROWS rows of the first image, whose last input row is real).
CONV_ATOL = 5e-5
CONV_F64_ROWS = 32
# K4 at run (a)'s and run (b)'s B with K = 1000, and at K = 2048 (the JAX
# tests' largest); D = 256. Indices must equal the plain version's and the
# float64 argmax except where a row's (or column's) two best masked
# similarities lie within MATCH_TIE in float64; dist12 within MATCH_ATOL.
MATCH_CASES = ((2, 1000), (4, 1000), (2, 2048), (4, 2048))
MATCH_TIE, MATCH_ATOL = 1e-5, 1e-5
# Edge cases (name, B, K, D), held to the same bars: K = 1, K = 65 (a
# ragged second 64-wide tile), D = 132 (not a multiple of the kernel's
# 16-entry chunk) and D = 250 (not of 4: its 4-byte copies), duplicated
# descriptors whose exact ties straddle tile boundaries (MATCH_TIES: the
# lowest index must win both ways), and pairs with every keypoint invalid
# (every masked similarity -1e9: index 0 everywhere).
MATCH_EDGE = (("K1", 2, 1, 256), ("K65", 2, 65, 256), ("D132", 2, 300, 132),
              ("D250", 2, 300, 250), ("ties", 2, 200, 256), ("all_invalid", 2, 300, 256))
MATCH_TIES = {"col": 60, "dup_cols": (70, 130), "row": 5, "dup_rows": (64, 190)}
# Card against CPU on the small val_feature batch: descriptors and
# subpixel offsets (the two convs that run K5 sum in another order than
# the CPU's, ~1e-7 relative, through three more layers and a
# normalization) within 1e-4; keypoints and validity equal; match sets
# equal except at near-ties; ratios within 1 / num_matches.
FRONT_BARS = {"desc": 1e-4, "offsets_px": 1e-4}
# val_feature (b) under conv_impl='s2d': the 64-channel layers of
# >= 16,384 px (inc's second conv, down1's two) take the space-to-depth
# F.conv2d, every other layer the plain route; no K5, K4 1 a batch. Held
# to the plain route on the card within the bars of
# tests/test_torch_frontend.py's S2D_VF_BARS (there measured equal on the
# CPU), keypoints equal but where a score lies within S2D_TIE of the cut.
VF_PER_BATCH_S2D = {"mutual_nn_kernel": 1}
S2D_VF_BARS = {"num_matches_rel": 0.005, "num_matches_abs": 1.0, "ratio_matches": 2.0}
S2D_TIE = 1e-5


def f32_gemm_bound_ms(macs: int, other_flops: int, nbytes: int) -> dict:
    """Least time for float32 products held to float32's bars: `macs`
    multiply-adds either as FP32 FFMA or as three TF32 passes on the tensor
    cores (hi hi + hi lo + lo hi), whichever is faster, plus `other_flops`
    on the FP32 pipes; against `nbytes` over HBM. `bound_by` is "bytes" or
    "operations", `ops_route` the faster route ("fp32" or "tf32x3");
    `bound_fp32_ms` is the bound with FFMA alone, as before the kernels
    took the tensor cores."""
    t_fp32 = (2 * macs + other_flops) / PEAK_FP32_FLOPS * 1e3
    t_tf32 = (3 * 2 * macs / PEAK_TF32_FLOPS + other_flops / PEAK_FP32_FLOPS) * 1e3
    t_ops = min(t_fp32, t_tf32)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "ops_route": "tf32x3" if t_tf32 < t_fp32 else "fp32",
            "bound_fp32_ms": max(t_fp32, t_bytes)}


def conv_bound_ms(B: int, H: int, W: int, Cin: int, C: int) -> dict:
    """Least time for K5 (`f32_gemm_bound_ms`): B H W x 9 Cin x C
    multiply-adds, plus the affine and ReLU (3 flops an output); against x,
    w, scale, bias read once and y written once."""
    px = B * H * W
    nbytes = 4 * (px * Cin + 9 * Cin * C + 2 * C + px * C)
    return f32_gemm_bound_ms(px * 9 * Cin * C, 3 * px * C, nbytes)


def match_bound_ms(B: int, K: int, D: int = 256) -> tuple[float, str]:
    """Least time for K4: the similarity's 2 B K^2 D flops once over the
    FP32 rate (both argmaxes derive from it); against both descriptor sets
    and masks read and nn12, nn21, dist12 written over HBM."""
    flops = 2 * B * K * K * D
    nbytes = 4 * 2 * B * K * D + 2 * B * K + 3 * 4 * B * K
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def conv_inputs(B, H, W, Cin, C, seed: int):
    """Inputs at the path's magnitudes: a grey image in [0, 1] for Cin = 1,
    else ReLU outputs; lecun-scaled weights, folded-BN-like affines."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    kw = {"device": "cuda", "generator": g}
    x = torch.rand(B, H, W, Cin, **kw) if Cin == 1 else torch.relu(torch.randn(B, H, W, Cin, **kw))
    w = torch.randn(3, 3, Cin, C, **kw) / (9 * Cin) ** 0.5
    return x, w, torch.rand(C, **kw) + 0.5, 0.1 * torch.randn(C, **kw)


def conv_f64(x, w, s, t, rows: int = CONV_F64_ROWS):
    """K5's function in float64 on the first `rows` output rows of image 0."""
    import torch
    import torch.nn.functional as F

    xc = x[:1, :rows + 1].double().permute(0, 3, 1, 2)
    z = F.conv2d(xc, w.double().permute(3, 2, 0, 1), padding=1).permute(0, 2, 3, 1)
    return torch.relu(z * s.double() + t.double())[:, :rows]


def phase_conv_kernel(ph: Phases) -> dict:
    """K5 at the path's shapes against its plain version and float64,
    timed beside the plain version, cuDNN's conv + affine + ReLU and its
    bound."""
    import torch
    import torch.nn.functional as F

    from deepfepe_tpu_torch.ops import conv as conv_mod

    shapes, max_err = {}, 0.0
    for i, (name, B, H, W, Cin, C) in enumerate(CONV_SHAPES):
        x, w, s, t = conv_inputs(B, H, W, Cin, C, seed=i)
        with torch.no_grad():
            y = conv_mod.conv3x3_affine_relu(x, w, s, t)
            ref = conv_mod.conv3x3_affine_relu_ref(x, w, s, t)
            y64 = conv_f64(x, w, s, t)
        torch.cuda.synchronize()
        bar = CONV_ATOL * max(1.0, ref.abs().max().item())
        errs = {"kernel_vs_plain": (y - ref).abs().max().item(),
                "kernel_vs_f64": (y[:1, :CONV_F64_ROWS].double() - y64).abs().max().item(),
                "plain_vs_f64": (ref[:1, :CONV_F64_ROWS].double() - y64).abs().max().item(),
                "max_abs_y": ref.abs().max().item(), "relu_zero_share": (ref == 0).float().mean().item()}
        ok = bool(torch.isfinite(y).all()) and errs["kernel_vs_plain"] <= bar \
            and errs["kernel_vs_f64"] <= bar
        x_nchw, w_oihw = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1).contiguous()
        s4, t4 = s[:, None, None], t[:, None, None]

        def library():
            with torch.no_grad():
                torch.relu_(F.conv2d(x_nchw, w_oihw, padding=1).mul_(s4).add_(t4))

        iters = 10 if B * H * W > 1e6 else 50
        with torch.no_grad():
            timing = {"ms": cuda_time_ms(lambda: conv_mod.conv3x3_affine_relu(x, w, s, t), iters),
                      "plain_ms": cuda_time_ms(
                          lambda: conv_mod.conv3x3_affine_relu_ref(x, w, s, t), iters),
                      "library_ms": cuda_time_ms(library, iters),
                      **conv_bound_ms(B, H, W, Cin, C)}
        ph.emit("kernels", kernel="conv3x3_affine_relu", layer=name, shape=[B, H, W, Cin, C],
                errors=errs, bar=bar, within_bars=ok, **timing)
        check(ok, f"K5 at {name} {[B, H, W, Cin, C]} is outside its bar {bar}: {errs}")
        shapes[name] = {"shape": [B, H, W, Cin, C], **timing}
        max_err = max(max_err, errs["kernel_vs_plain"])
        del x, w, s, t, y, ref, y64, x_nchw, w_oihw
        torch.cuda.empty_cache()
    lead = shapes["inc.conv1"]
    return {"name": "conv3x3_affine_relu", "route": "cuda",
            "source": "deepfepe_tpu_torch/csrc/conv3x3.cu",
            "replaces": "deepfepe_tpu/ops/pallas/conv_pallas.py:111", "launches": None,
            "max_abs_err": max_err, "ms": lead["ms"], "plain_ms": lead["plain_ms"],
            "bound_ms": lead["bound_ms"], "bound_by": lead["bound_by"],
            "bound_fp32_ms": lead["bound_fp32_ms"], "ops_route": lead["ops_route"],
            "library_ms": lead["library_ms"],
            "library": "cuDNN F.conv2d (float32, TF32 off) + affine + ReLU in place",
            "shape": "inc.conv1: x [8, 376, 1240, 64] -> 64, f32", "per_layer": shapes}


def match_inputs(B: int, K: int, seed: int, D: int = 256):
    """Unit descriptors, the second set a noisy copy of the first in a
    shuffled order, and validity masks with about a fifth padded."""
    import torch
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(seed)
    kw = {"device": "cuda", "generator": g}
    base = torch.randn(B, K, D, **kw)
    perm = torch.randperm(K, **kw)
    d1 = F.normalize(base, dim=-1)
    d2 = F.normalize(base + 0.3 * torch.randn(B, K, D, **kw), dim=-1)[:, perm].contiguous()
    return d1, d2, torch.rand(B, K, **kw) < 0.8, torch.rand(B, K, **kw) < 0.8


def match_edge_inputs(name: str, B: int, K: int, D: int, seed: int):
    """match_inputs, with MATCH_TIES's duplicates ('ties': every keypoint
    valid, row `row` of desc1 a noisy copy of column `col` of desc2,
    similarity about 0.96: at an exact copy dist12 = sqrt(2 - 2 s) would sit
    where float32 rounding of s near 1 leaves it ~3e-4 from float64 in any
    implementation) or every keypoint invalid ('all_invalid')."""
    import torch.nn.functional as F

    d1, d2, v1, v2 = match_inputs(B, K, seed, D)
    if name == "ties":
        t = MATCH_TIES
        v1[:], v2[:] = True, True
        for c in t["dup_cols"]:
            d2[:, c] = d2[:, t["col"]]
        d1[:, t["row"]] = F.normalize(d2[:, t["col"]] + 0.3 * d1[:, t["row"]], dim=-1)
        for r in t["dup_rows"]:
            d1[:, r] = d1[:, t["row"]]
    elif name == "all_invalid":
        v1[:], v2[:] = False, False
    return d1, d2, v1, v2


def near_ties(d1, d2, v1, v2, tie: float = MATCH_TIE):
    """Float64 masked similarities: (nn12, nn21, best12, rows whose two
    best columns lie within `tie`, columns whose two best rows do). A
    masked entry is -1e9 exactly: float32 rounds dot - 1e9 there for any
    |dot| < 32 (its ulp is 64), so every invalid entry ties."""
    import torch
    import torch.nn.functional as F

    dot = d1.double() @ d2.double().transpose(-1, -2)
    s12 = torch.where(v2[:, None, :], dot, -1e9)
    s21 = torch.where(v1[:, :, None], dot, -1e9)
    top12 = F.pad(s12, (0, 1), value=-float("inf")).topk(2, dim=-1).values
    top21 = F.pad(s21, (0, 0, 0, 1), value=-float("inf")).topk(2, dim=-2).values
    return (s12.argmax(-1), s21.argmax(-2), top12[..., 0],
            top12[..., 0] - top12[..., 1] < tie, top21[:, 0] - top21[:, 1] < tie)


def match_case(name: str, d1, d2, v1, v2) -> tuple[dict, bool]:
    """K4 on one input against its plain version and float64: (errors,
    within the bars)."""
    import torch

    from deepfepe_tpu_torch.ops import matcher

    nn12, nn21, dist12, mutual = matcher.mutual_nn_kernel(d1, d2, v1, v2)
    p12, p21, pdist, pmut = matcher.mutual_nn_plain(d1, d2, v1, v2)
    e12, e21, best, tie12, tie21 = near_ties(d1, d2, v1, v2)
    dist64 = torch.sqrt(torch.clamp(2 - 2 * best, min=0))
    torch.cuda.synchronize()
    # mutual[i] reads nn12[i] and nn21 at nn12[i]: excuse ties there.
    tie_mut = tie12 | torch.gather(tie21, 1, nn12.long()) | torch.gather(tie21, 1, p12.long())
    # dist12 against float64 where a row has a valid column; elsewhere it
    # is sqrt(2 + 2e9) in float32 (ulp 0.004), held to the plain version.
    real = v2.any(-1, keepdim=True).expand_as(dist12)
    errs = {"nn12_vs_plain": int(((nn12 != p12) & ~tie12).sum()),
            "nn21_vs_plain": int(((nn21 != p21) & ~tie21).sum()),
            "nn12_vs_f64": int(((nn12.long() != e12) & ~tie12).sum()),
            "nn21_vs_f64": int(((nn21.long() != e21) & ~tie21).sum()),
            "mutual_vs_plain": int(((mutual != pmut) & ~tie_mut).sum()),
            "near_tie_rows": int(tie12.sum()), "near_tie_cols": int(tie21.sum()),
            "nn12_differs_at_near_ties": int(((nn12 != p12) & tie12).sum()),
            "dist12_vs_plain": (dist12 - pdist).abs().max().item(),
            "dist12_vs_f64": ((dist12.double() - dist64).abs() * real).max().item(),
            "valid_share": v1.float().mean().item(), "mutual_share": mutual.float().mean().item()}
    ok = all(errs[k] == 0 for k in ("nn12_vs_plain", "nn21_vs_plain", "nn12_vs_f64",
                                    "nn21_vs_f64", "mutual_vs_plain")) \
        and errs["dist12_vs_plain"] <= MATCH_ATOL and errs["dist12_vs_f64"] <= MATCH_ATOL
    if name == "ties":
        t = MATCH_TIES
        rows, cols = [t["row"], *t["dup_rows"]], [t["col"], *t["dup_cols"]]
        errs["ties_to_lowest"] = bool((nn12[:, rows] == t["col"]).all()
                                      and (nn21[:, cols] == t["row"]).all())
        errs["plain_ties_to_lowest"] = bool((p12[:, rows] == t["col"]).all()
                                            and (p21[:, cols] == t["row"]).all())
        ok = ok and errs["ties_to_lowest"]
    if name == "all_invalid":
        errs["index_0_everywhere"] = bool((nn12 == 0).all() and (nn21 == 0).all()
                                          and not mutual.any())
        ok = ok and errs["index_0_everywhere"]
    return errs, ok


def phase_matcher_kernel(ph: Phases) -> dict:
    """K4 against its plain version and float64 at the path's shapes and
    MATCH_EDGE's, timed beside the plain version, torch.matmul +
    max/argmax and its bound."""
    import torch

    from deepfepe_tpu_torch.ops import matcher

    runs = [(f"B{B}_K{K}", B, K, 256) for B, K in MATCH_CASES] + list(MATCH_EDGE)
    cases, max_err = {}, 0.0
    for i, (name, B, K, D) in enumerate(runs):
        d1, d2, v1, v2 = match_edge_inputs(name, B, K, D, seed=100 + i)
        errs, ok = match_case(name, d1, d2, v1, v2)
        m1 = torch.where(v1, 0.0, -1e9)[:, :, None]
        m2 = torch.where(v2, 0.0, -1e9)[:, None, :]

        def library():
            dot = torch.matmul(d1, d2.transpose(-1, -2))
            (dot + m2).max(dim=-1)
            (dot + m1).argmax(dim=-2)

        bound, bound_by = match_bound_ms(B, K, D)
        timing = {"ms": cuda_time_ms(lambda: matcher.launch(d1, d2, v1, v2), 50),
                  "wrapper_ms": cuda_time_ms(lambda: matcher.mutual_nn_kernel(d1, d2, v1, v2), 50),
                  "plain_ms": cuda_time_ms(lambda: matcher.mutual_nn_plain(d1, d2, v1, v2), 50),
                  "library_ms": cuda_time_ms(library, 50), "bound_ms": bound, "bound_by": bound_by}
        ph.emit("kernels", kernel="mutual_nn_kernel", case=name, B=B, K=K, D=D, errors=errs,
                bars={"near_tie": MATCH_TIE, "dist12_atol": MATCH_ATOL}, within_bars=ok, **timing)
        check(ok, f"K4 {name} (B={B}, K={K}, D={D}) is outside its bars: {errs}")
        cases[name] = timing
        max_err = max(max_err, errs["dist12_vs_plain"])
    lead = cases["B4_K1000"]
    return {"name": "mutual_nn_kernel", "route": "cuda", "source": "deepfepe_tpu_torch/csrc/matcher.cu",
            "replaces": "deepfepe_tpu/ops/pallas/matcher_pallas.py:20", "launches": None,
            "max_abs_err": max_err, "ms": lead["ms"], "plain_ms": lead["plain_ms"],
            "bound_ms": lead["bound_ms"], "bound_by": lead["bound_by"],
            "library_ms": lead["library_ms"],
            "library": "torch.matmul (float32, TF32 off) + max/argmax both ways",
            "shape": "desc [4, 1000, 256] f32 (run b)", "per_case": cases}


def gauss2_checkpoint(path: str, seed: int = 0) -> None:
    """Seeded SuperPointNetGauss2 weights in the reference `.pth.tar`
    layout, with randomized running statistics: variance |1 + 0.3 N| +
    0.05 as tests/test_conv_pallas.py makes it, mean 0.1 N. That test's
    mean, |0.3 N| + 0.05, is positive everywhere and zeroes every
    activation of the untrained net after its ReLUs (constant descriptors,
    one match a pair), which would leave K4 nothing to match."""
    import torch

    from deepfepe_tpu_torch.frontend import SuperPointNetGauss2
    from deepfepe_tpu_torch.frontend.superpoint import reset_superpoint

    g = torch.Generator().manual_seed(seed)
    net = reset_superpoint(SuperPointNetGauss2(), g)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(0.1 * torch.randn(m.num_features, generator=g))
                m.running_var.copy_((1 + 0.3 * torch.randn(m.num_features, generator=g)).abs()
                                    + 0.05)
    torch.save({"n_iter": 0, "model_state_dict": net.state_dict()}, path)


def vf_pretrained(run: str) -> str:
    """The checkpoint run `run` loads ('' for seeded SuperPointNet weights)."""
    if VF_RUNS[run]["net"] == "SuperPointNet":
        return ""
    path = os.path.join("logs", "smoke_vf_weights", "sp_gauss2.pth.tar")
    if not os.path.exists(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        gauss2_checkpoint(path)
    return path


def vf_params():
    from deepfepe_tpu_torch.frontend import FrontendParams

    return FrontendParams(out_num_points=VF_K, conf_thresh=1e-3, conv_impl="pallas")


def phase_val_feature(ph: Phases) -> dict:
    """The port's `val_feature` entry point, runs (a) and (b); every
    kernel's launches read around each run alone. Returns the sums."""
    import numpy as np
    import torch

    from deepfepe_tpu_torch import cli

    shutil.rmtree(os.path.join(REPO, "logs", "smoke_vf_weights"), ignore_errors=True)
    total = dict.fromkeys(kernel_counters(), 0)
    for run, spec in VF_RUNS.items():
        pretrained = vf_pretrained(run)
        reset_counts()
        summary = cli.val_feature(f"smoke_vf_{run}", max_batches=spec["batches"],
                                  pretrained=pretrained, fp=vf_params(),
                                  image_size=spec["image_size"], batch_size=spec["batch_size"],
                                  device="cuda")
        torch.cuda.synchronize()
        counts = read_counts()
        expected = {k: spec["batches"] * VF_PER_BATCH[run].get(k, 0) for k in counts}
        ratios = [summary[f"ratio@{t}"] for t in (0.1, 0.5, 1.0, 2.0)]
        ph.emit("val_feature", run=run, net=spec["net"], image_size=spec["image_size"],
                batch_size=spec["batch_size"], K=VF_K, summary=summary, launches=counts,
                expected_launches=expected, pairs_per_s=summary["pairs"] / summary["seconds"],
                timed="host clock over the frontend and its scoring, ending in a synchronize")
        check(counts == expected, f"val_feature ({run}): launches {counts}, expected {expected}")
        check(summary["pairs"] == spec["batches"] * spec["batch_size"],
              f"val_feature ({run}): {summary['pairs']} pairs")
        check(all(np.isfinite(v) for v in [*ratios, summary["num_matches"]]),
              f"val_feature ({run}): non-finite summary {summary}")
        check(0 < summary["num_matches"] <= VF_K, f"val_feature ({run}): "
              f"{summary['num_matches']} matches a pair")
        check(all(0 <= a <= b <= 1 for a, b in zip(ratios, ratios[1:])),
              f"val_feature ({run}): ratios not in [0, 1] and rising: {ratios}")
        for k, v in counts.items():
            total[k] += v
    return total


def strong_keypoints(k, b: int, tie: float) -> set:
    """Image b's valid keypoints whose score clears the lowest kept score
    by more than `tie`: the ones no near-equal score can swap out."""
    v = k.valid[b].cpu()
    xy, sc = k.xy[b].cpu()[v], k.scores[b].cpu()[v]
    cut = float(sc.min()) if len(sc) else 0.0
    return {(int(x), int(y)) for (x, y), c in zip(xy.tolist(), sc.tolist()) if c > cut + tie}


def phase_val_feature_s2d(ph: Phases) -> dict:
    """val_feature (b) with the conv switch on the space-to-depth route
    (F.conv2d in full float32 on the 64-channel layers of >= 16,384 px, no
    K5), against the plain route on the card: exact launches (K5 0, K4 1 a
    batch), num_matches and ratios within S2D_VF_BARS (the CPU test's,
    tests/test_torch_frontend.py), the first batch's keypoints equal but
    for near-equal scores. Returns the launch counts."""
    import numpy as np
    import torch

    from deepfepe_tpu_torch import cli
    from deepfepe_tpu_torch.data import SyntheticImagePairs
    from deepfepe_tpu_torch.frontend import FrontendParams, run_superpoint

    spec = VF_RUNS["b"]
    out = {"s2d": [], "xla": []}
    for i, impl in enumerate(("s2d", "xla", "xla", "s2d")):  # the second of each is timed
        fp = FrontendParams(out_num_points=VF_K, conf_thresh=1e-3, conv_impl=impl)
        reset_counts()
        out[impl].append(cli.val_feature(f"smoke_vf_b_{impl}", max_batches=spec["batches"],
                                         pretrained=vf_pretrained("b"), fp=fp,
                                         image_size=spec["image_size"],
                                         batch_size=spec["batch_size"], device="cuda"))
        torch.cuda.synchronize()
        if i == 0:
            counts = read_counts()
    expected = {k: spec["batches"] * VF_PER_BATCH_S2D.get(k, 0) for k in counts}
    a, b = out["s2d"][0], out["xla"][0]
    check(all(out[m][0]["num_matches"] == out[m][1]["num_matches"] for m in out),
          f"val_feature s2d: a route's num_matches moved between its two runs {out}")
    net = vf_net("b", "cuda")
    imgs = torch.as_tensor(SyntheticImagePairs(image_size=spec["image_size"], seed=0).batch(
        spec["batch_size"])["imgs_grey"][:, 0], device="cuda")
    with torch.no_grad():
        k = {impl: run_superpoint(net, imgs, FrontendParams(out_num_points=VF_K, conf_thresh=1e-3,
                                                             conv_impl=impl))
             for impl in ("s2d", "xla")}
    missing = []
    for i in range(imgs.shape[0]):
        sets = {impl: {(int(x), int(y)) for (x, y), v in zip(k[impl].xy[i].tolist(),
                                                             k[impl].valid[i].tolist()) if v}
                for impl in k}
        missing += [len(strong_keypoints(k["s2d"], i, S2D_TIE) - sets["xla"]),
                    len(strong_keypoints(k["xla"], i, S2D_TIE) - sets["s2d"])]
    same = float(np.mean([torch.equal(k["s2d"].xy[i], k["xla"].xy[i])
                          for i in range(imgs.shape[0])]))
    ph.emit("val_feature_s2d", run="b", conv_impl="s2d", summary=a, plain_summary=b,
            launches=counts, expected_launches=expected,
            pairs_per_s=[r["pairs"] / r["seconds"] for r in out["s2d"]],
            plain_pairs_per_s=[r["pairs"] / r["seconds"] for r in out["xla"]],
            strong_keypoints_missing=missing, images_with_equal_keypoints=same,
            bars=S2D_VF_BARS, timed="host clock over the frontend and its scoring, ending in "
                                    "a synchronize; runs in the order s2d, plain, plain, s2d")
    check(counts == expected, f"val_feature s2d: launches {counts}, expected {expected}")
    check(abs(a["num_matches"] - b["num_matches"]) <= S2D_VF_BARS["num_matches_abs"]
          + S2D_VF_BARS["num_matches_rel"] * b["num_matches"],
          f"val_feature s2d: num_matches {a['num_matches']} against {b['num_matches']}")
    check(all(abs(a[r] - b[r]) <= S2D_VF_BARS["ratio_matches"] / b["num_matches"]
              for r in ("ratio@0.1", "ratio@0.5", "ratio@1.0", "ratio@2.0")),
          f"val_feature s2d: ratios {a} against {b}")
    check(max(missing) == 0, f"val_feature s2d: keypoints off the plain route's {missing}")
    return counts


def vf_net(run: str, device):
    from deepfepe_tpu_torch.frontend import SuperPointNet
    from deepfepe_tpu_torch.frontend.superpoint import reset_superpoint
    from deepfepe_tpu_torch.utils.weights import load_superpoint

    import torch

    pretrained = vf_pretrained(run)
    if pretrained:
        return load_superpoint(pretrained, device)
    return reset_superpoint(SuperPointNet(), torch.Generator().manual_seed(0)).eval().to(device)


def phase_frontend_breakdown(ph: Phases, repeats: int = 3) -> None:
    """Where a val_feature batch spends its time, for runs (a) and (b):
    each stage of the path between synchronizes on the host clock, the
    median over `repeats` passes after a warm-up one; then one whole batch
    under torch.profiler (the device's busy share and top kernels). Runs
    after the counted runs."""
    import statistics

    import torch

    from deepfepe_tpu_torch.data import SyntheticImagePairs
    from deepfepe_tpu_torch.eval import frontend_epidist_eval
    from deepfepe_tpu_torch.frontend import (flatten_detection, gather_matches,
                                             mutual_nn_match, nms_heatmap, sample_descriptors,
                                             soft_argmax_refine, topk_keypoints)
    from deepfepe_tpu_torch.frontend.sp_fused import superpoint_forward_fused
    from deepfepe_tpu_torch.geometry.epipolar import epi_distance

    dev = torch.device("cuda")
    fp = vf_params()
    for run, spec in VF_RUNS.items():
        net = vf_net(run, dev)
        batch = SyntheticImagePairs(image_size=spec["image_size"], seed=0).batch(spec["batch_size"])
        imgs = torch.as_tensor(batch["imgs_grey"], device=dev)
        F_gt = torch.as_tensor(batch["F_gts"], device=dev)
        B = imgs.shape[0]
        spent = {}

        def stage(name, fn, *args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            spent.setdefault(name, []).append((time.perf_counter() - t) * 1e3)
            return out

        for _ in range(repeats + 1):
            with torch.no_grad():
                both = torch.cat([imgs[:, 0], imgs[:, 1]])[..., None].contiguous()
                outs = stage("superpoint_cnn", superpoint_forward_fused, net, both, "pallas")
                heat = stage("flatten_detection", flatten_detection, outs["semi"])
                nms = stage("nms", nms_heatmap, heat, fp.nms_dist)
                k = stage("topk", topk_keypoints, nms, fp.out_num_points, fp.conf_thresh)
                k = stage("soft_argmax", soft_argmax_refine, heat, k, fp.patch_size)
                desc = stage("sample_descriptors", sample_descriptors, outs["desc"],
                             k.xy + k.offsets)
                k = k._replace(desc=desc)
                k1, k2 = k.split(B)
                m = stage("match", mutual_nn_match, k1.desc, k2.desc, k1.valid, k2.valid,
                          fp.nn_thresh, fp.out_num_points)
                xy = stage("gather", gather_matches, k1.xy + k1.offsets, k2.xy + k2.offsets, m)
                stage("epi_distance", epi_distance, F_gt, xy[..., :2], xy[..., 2:4])
        ms = {k: statistics.median(v[1:]) for k, v in spent.items()}
        total = sum(ms.values())
        # One whole batch as val_feature runs it, under the profiler.
        trace = os.path.join("logs", f"smoke_vf_{run}_profile", "trace.json")
        os.makedirs(os.path.dirname(trace), exist_ok=True)
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            frontend_epidist_eval(net, (imgs[:, 0], imgs[:, 1]), F_gt, fp)
            torch.cuda.synchronize()
        prof.export_chrome_trace(trace)
        ph.emit("frontend_breakdown", run=run, net=spec["net"], image_size=spec["image_size"],
                batch_size=spec["batch_size"], stage_ms=ms, batch_ms=total,
                share={k: v / total for k, v in ms.items()},
                timed="host clock between synchronizes, median of passes 2..",
                profiled_batch=read_trace(trace))
        del net, outs, nms, heat, k, desc
        torch.cuda.empty_cache()


def match_set(m) -> set:
    import numpy as np

    val, i1, i2 = (np.asarray(t.cpu()) for t in (m.valid, m.idx1, m.idx2))
    return {(b, int(i1[b, k]), int(i2[b, k])) for b in range(val.shape[0])
            for k in range(val.shape[1]) if val[b, k]}


def phase_check_frontend(ph: Phases) -> None:
    """Run (a)'s first batch (2 pairs at 120x160, seeded SuperPointNet,
    K = 1000) on the card (K5 on conv1a/conv1b, K4) and on the CPU (the
    plain routes), compared at FRONT_BARS. Padding and K4's masks are
    exercised: fewer than K keypoints survive NMS on each frame."""
    import numpy as np
    import torch

    from deepfepe_tpu_torch.data import SyntheticImagePairs
    from deepfepe_tpu_torch.eval import frontend_epidist_eval
    from deepfepe_tpu_torch.frontend import get_matches_from_sp

    spec = VF_RUNS["a"]
    batch = SyntheticImagePairs(image_size=spec["image_size"], seed=0).batch(spec["batch_size"])
    fp = vf_params()
    res, ev = {}, {}
    for dev in ("cpu", "cuda"):
        net = vf_net("a", torch.device(dev))
        imgs = torch.as_tensor(batch["imgs_grey"], device=dev)
        frames = (imgs[:, 0], imgs[:, 1])
        F_gt = torch.as_tensor(batch["F_gts"], device=dev)
        reset_counts()
        with torch.no_grad():
            res[dev] = get_matches_from_sp(net, frames, fp)
        res[dev]["launches"] = read_counts()
        ev[dev] = frontend_epidist_eval(net, frames, F_gt, fp)
    cpu, gpu = res["cpu"], res["cuda"]
    kp = {}
    for name in ("kpts1", "kpts2"):
        a, b = cpu[name], gpu[name]
        kp[name] = {"xy_equal": bool(torch.equal(a.xy, b.xy.cpu())),
                    "valid_equal": bool(torch.equal(a.valid, b.valid.cpu())),
                    "valid_per_frame": a.valid.sum(-1).tolist(),
                    "desc": (a.desc - b.desc.cpu()).abs().max().item(),
                    "offsets_px": (a.offsets - b.offsets.cpu()).abs().max().item()}
    _, _, _, tie12, tie21 = near_ties(cpu["kpts1"].desc, cpu["kpts2"].desc,
                                      cpu["kpts1"].valid, cpu["kpts2"].valid)
    differ = match_set(cpu["matches"]) ^ match_set(gpu["matches"])
    unexplained = [(b, i, j) for b, i, j in differ if not (tie12[b, i] or tie21[b, j])]
    nm = ev["cpu"]["num_matches"]
    ratio_diff = max(float(np.max(np.abs(ev["cpu"][k] - ev["cuda"][k]) * np.maximum(nm, 1)))
                     for k in ev["cpu"] if k.startswith("ratio"))
    report = {"keypoints": kp, "matches_cpu": len(match_set(cpu["matches"])),
              "matches_card": len(match_set(gpu["matches"])), "matches_differing": len(differ),
              "differing_not_near_tie": len(unexplained),
              "near_tie_rows": int(tie12.sum()), "near_tie_cols": int(tie21.sum()),
              "num_matches_cpu": nm.tolist(), "num_matches_card": ev["cuda"]["num_matches"].tolist(),
              "ratio_diff_in_matches": ratio_diff, "launches_card": gpu["launches"],
              "launches_cpu": cpu["launches"]}
    ok = (all(v["xy_equal"] and v["valid_equal"] and v["desc"] <= FRONT_BARS["desc"]
              and v["offsets_px"] <= FRONT_BARS["offsets_px"] for v in kp.values())
          and not unexplained and ratio_diff <= 1.0
          and gpu["launches"]["conv3x3_affine_relu"] == 2
          and gpu["launches"]["mutual_nn_kernel"] == 1
          and sum(cpu["launches"].values()) == 0)
    ph.emit("check", frontend=report, bars={**FRONT_BARS, "ratio": "1 / num_matches",
                                            "near_tie": MATCH_TIE}, within_bars=ok)
    check(ok, f"the card's frontend disagrees with the CPU's: {report}")
    check(all(n < VF_K for v in kp.values() for n in v["valid_per_frame"]),
          "every keypoint slot was valid: K4's masks and the padding went untested")


# ------------------------------------------------------------ joint slice

# K5b at the joint path's layer shapes (B, H, W, Cin, C, need_dx): the six
# gauss2 layers that take K5 at 376x1240 (down1's two share one shape) and
# SuperPointNet's conv1b. inc.conv0's input is the image: no dx.
CONV_BWD_SHAPES = (("inc.conv0", 8, 376, 1240, 1, 64, False),
                   ("inc.conv1", 8, 376, 1240, 64, 64, True),
                   ("down1.conv0/1", 8, 188, 620, 64, 64, True),
                   ("down2.conv0", 8, 94, 310, 64, 128, True),
                   ("down2.conv1", 8, 94, 310, 128, 128, True),
                   ("a.conv1b", 4, 120, 160, 64, 64, True))
# Each output of K5b (dx, dw, dscale, dbias) within 1e-4 of float64
# (relative to the plain version's largest entry: tests/test_conv_pallas.py's
# gradient bar for float32 sums of up to 3.7 M products in another order; dw,
# dscale and dbias over all pixels, dx on the first CONV_F64_ROWS rows of the
# first image), and from the plain version by at most that bar plus the plain
# version's own distance from float64: cuDNN's float32 weight gradient, which
# the plain version calls, lands 2.1e-4 from float64 at inc.conv1 (PERF.md).
CONV_BWD_REL = 1e-4

# Joint SuperPoint + DeepF training through the CLI (`train_good` with
# model.if_SP) at the reference's production point (the JAX package's
# bench_joint_fullres: SuperPointNetGauss2, 376x1240, 4 pairs a batch = one
# [8, 376, 1240] encoder pass, N = 1000, DeepFNet depth 5, SP_params with
# conf_thresh 1e-4), float32, the gauss2 weights of val_feature's run (b).
# Stage 1 freezes SuperPoint (BN on running statistics, the fused forward,
# the conv switch on K5); stage 2 trains it (train-mode BN, module forward).
JOINT_STEPS = {"stage1": 3, "stage2": 3}
JOINT = {
    "name": "smoke_joint",
    "data": {"dataset": "synthetic_images", "batch_size": 4, "good_num": 1000,
             "image": {"size": [376, 1240, 1]}, "preprocessing": {"resize": [376, 1240]}},
    "model": {"depth": 5, "clamp_at": 0.02, "if_quality": True, "quality_size": 1,
              "if_qt_loss": False, "if_SP": True, "mlp_dtype": "float32"},
    "training": {"seed": 0, "learning_rate": 1e-4, "train": True, "retrain_SP": False,
                 "save_interval": 0, "tensorboard": False, "workers_train": 4,
                 "SP_params": {"out_num_points": 1000, "conf_thresh": 1e-4, "nn_thresh": 1.0,
                               "nms_dist": 4, "patch_size": 5}},
}
# Launches a step: stage 1 runs K5 and K5b on the six layers with
# H * W >= 16,384, K4 once (K = 1000), eigh9 once a DeepFNet layer, K3 and
# its backward depth - 1 times in DeepFNet and once in the F-loss.
JOINT_PER_STEP = {"stage1": {"conv3x3_affine_relu": 6, "conv3x3_affine_relu_bwd": 6,
                             "mutual_nn_kernel": 1, "eigh9": 5, "epi_residual": 5,
                             "epi_residual_bwd": 5},
                  "stage2": {"mutual_nn_kernel": 1, "eigh9": 5, "epi_residual": 5,
                             "epi_residual_bwd": 5}}
# Device kernel names (substrings of the profiler's) of K5b and K5; a
# stage-1 joint step must read more than 0 ms of each group.
K5B_KERNELS = ("conv3x3_wgrad_mma_kernel", "conv3x3_wgrad_cin1_kernel", "sum_groups_kernel",
               "conv3x3_mma_kernel<true", "conv3x3_dgrad_cin1_kernel")
K5_KERNELS = ("conv3x3_mma_kernel<false", "conv3x3_cin1_kernel")
# check_joint: gauss2 at 128x128 (inc's two convs take K5 and K5b), 2 pairs,
# K = N = 128, depth 3, sign-canonical null vectors (eigh9 and the CPU's
# Jacobi may return opposite signs), running statistics from a calibration
# batch (with the smoke's seeded statistics every descriptor is nearly the
# same). For both bn_modes, one joint step on the card (float32, kernels)
# and one on the CPU (float32, plain routes), each held against the CPU in
# float64 on the same branches of the solver's kinks (`SolverBranches`):
# float32 moves the algebraic residuals of the fit by up to a few percent
# of their median here, so some F-loss point, feature or weight-MLP unit
# lands on the other side of its |.|, clamp or leaky-ReLU kink than in
# float64, and the gradient jumps there (on seed 5's train-mode step
# float64 on the card's choices lands about 5% from float64 on its own in
# g_deepf_norm: the check's `kinks` reading). Replaying a float32 run's
# choices, float64 takes the gradient of the same piece. Each
# bar is twice the CPU's own distance plus a floor, and at most
# CHECK_JOINT_CAP, so that a fault of 10% always shows (the CPU's float32
# train-mode SuperPoint backward is the less exact one: percents from
# float64 on its worst weight leaves, varying with its thread count):
# - the ordered match lists equal on the card, the CPU and float64;
# - the loss (floor 1e-4) and the gradient norms (1e-3), relative;
# - each SuperPoint gradient leaf (1e-3), relative to its largest float64
#   entry, or to the net's where the leaf's is under 1e-4 of that (a leaf
#   that is zero in exact arithmetic: biases ahead of train-mode BN);
# - the same leaves for SuperPoint alone under fixed random cotangents on
#   semi and desc, in the step's route (frozen: the fused forward, K5 and
#   K5b on inc's two convs, val_feature's weights, whose zero-centred BN
#   means keep the folded affine free of cancellation; train: the module
#   forward, train-mode BN in two groups), apart from the solver;
# - train-mode BN buffers within 1e-5 of the CPU's (relative: batch
#   statistics over 16,384 pixels summed in another order), frozen ones
#   unchanged.
CHECK_JOINT = {"size": (128, 128), "pairs": 2, "K": 128, "depth": 3, "seed": 5}
CHECK_JOINT_CAP = 0.1


def conv_bwd_bound_ms(B, H, W, Cin, C, need_dx) -> dict:
    """Least time for K5b (`f32_gemm_bound_ms`): dw's B H W 9 Cin C
    multiply-adds, dx's as many when needed, and the affine gradients' ~6
    flops a pixel-channel; against x, y, dy (and w, scale, bias) read once
    and dx, dw, dscale, dbias written once."""
    px = B * H * W
    macs = (2 if need_dx else 1) * px * 9 * Cin * C
    nbytes = 4 * (px * Cin + 2 * px * C + 2 * 9 * Cin * C + 4 * C + (px * Cin if need_dx else 0))
    return f32_gemm_bound_ms(macs, 6 * px * C, nbytes)


def conv_bwd_f64(x, w, s, t, y, dy):
    """K5b's function in float64: (dx on the first CONV_F64_ROWS rows of
    image 0, dw, dscale, dbias over everything)."""
    import torch

    from deepfepe_tpu_torch.ops import conv as conv_mod

    rows = CONV_F64_ROWS
    d = lambda a: a.double()  # noqa: E731
    _, dw, ds, dt = conv_mod.conv3x3_affine_relu_bwd_ref(d(x), d(w), d(s), d(t), d(y), d(dy),
                                                        need_dx=False)
    sub = [a[:1, :rows + 1] for a in (x, y, dy)]
    dx, _, _, _ = conv_mod.conv3x3_affine_relu_bwd_ref(d(sub[0]), d(w), d(s), d(t), d(sub[1]),
                                                       d(sub[2]))
    del _
    torch.cuda.empty_cache()
    return dx[:, :rows], dw, ds, dt


def phase_conv_bwd_kernel(ph: Phases) -> dict:
    """K5b at the joint path's shapes against its plain version and float64,
    timed beside the plain version, cuDNN's backward of conv + affine + ReLU
    (autograd, TF32 off) and its bound."""
    import torch
    import torch.nn.functional as F

    from deepfepe_tpu_torch.ops import conv as conv_mod

    shapes, max_err, max_rel = {}, 0.0, 0.0
    names = ("dx", "dw", "dscale", "dbias")
    for i, (name, B, H, W, Cin, C, need_dx) in enumerate(CONV_BWD_SHAPES):
        x, w, s, t = conv_inputs(B, H, W, Cin, C, seed=20 + i)
        with torch.no_grad():
            y = conv_mod.conv3x3_affine_relu(x, w, s, t)
        dy = torch.randn(y.shape, device="cuda", generator=torch.Generator(
            device="cuda").manual_seed(40 + i))
        got = conv_mod.conv3x3_affine_relu_bwd(x, w, s, t, y, dy, need_dx)
        plain = conv_mod.conv3x3_affine_relu_bwd_ref(x, w, s, t, y, dy, need_dx)
        f64 = conv_bwd_f64(x, w, s, t, y, dy)
        torch.cuda.synchronize()
        errs = {}
        for n, a, b, e in zip(names, got, plain, f64):
            if n == "dx" and not need_dx:
                errs["dx_abs_max"] = a.abs().max().item()
                continue
            scale = b.abs().max().item() + 1e-30
            a64 = a[:1, :CONV_F64_ROWS] if n == "dx" else a
            p64 = b[:1, :CONV_F64_ROWS] if n == "dx" else b
            errs[n] = {"kernel_vs_plain": (a - b).abs().max().item() / scale,
                       "kernel_vs_f64": (a64.double() - e).abs().max().item() / scale,
                       "plain_vs_f64": (p64.double() - e).abs().max().item() / scale}
        ok = all(torch.isfinite(a).all() for a in got) and errs.get("dx_abs_max", 0.0) == 0.0 \
            and all(v["kernel_vs_f64"] <= CONV_BWD_REL
                    and v["kernel_vs_plain"] <= CONV_BWD_REL + v["plain_vs_f64"]
                    for k, v in errs.items() if k != "dx_abs_max")
        leaves = [a.detach().clone().requires_grad_(need_dx if j == 0 else True)
                  for j, a in enumerate((x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), s, t))]
        out = torch.relu(F.conv2d(leaves[0], leaves[1], padding=1) * leaves[2][:, None, None]
                         + leaves[3][:, None, None])
        dy_nchw = dy.permute(0, 3, 1, 2)
        wanted = [v for v in leaves if v.requires_grad]

        def library():
            torch.autograd.grad(out, wanted, dy_nchw, retain_graph=True)

        iters = 5 if B * H * W > 1e6 else 30
        timing = {"ms": cuda_time_ms(lambda: conv_mod.conv3x3_affine_relu_bwd(
                      x, w, s, t, y, dy, need_dx), iters),
                  "plain_ms": cuda_time_ms(lambda: conv_mod.conv3x3_affine_relu_bwd_ref(
                      x, w, s, t, y, dy, need_dx), iters),
                  "library_ms": cuda_time_ms(library, iters),
                  **conv_bwd_bound_ms(B, H, W, Cin, C, need_dx)}
        ph.emit("kernels", kernel="conv3x3_affine_relu_bwd", layer=name,
                shape=[B, H, W, Cin, C], need_dx=need_dx, errors=errs, bar_rel=CONV_BWD_REL,
                within_bars=ok, **timing)
        check(ok, f"K5b at {name} {[B, H, W, Cin, C]} is outside its bar: {errs}")
        shapes[name] = {"shape": [B, H, W, Cin, C], "need_dx": need_dx, **timing}
        max_err = max(max_err, *((a - b).abs().max().item() for a, b in zip(got, plain)))
        max_rel = max(max_rel, *(v["kernel_vs_plain"] for k, v in errs.items()
                                 if k != "dx_abs_max"))
        del x, w, s, t, y, dy, got, plain, f64, leaves, out, dy_nchw, wanted
        torch.cuda.empty_cache()
    lead = shapes["inc.conv1"]
    return {"name": "conv3x3_affine_relu_bwd", "route": "cuda",
            "source": "deepfepe_tpu_torch/csrc/conv3x3.cu",
            "replaces": "deepfepe_tpu/ops/pallas/conv_pallas.py:175", "launches": None,
            "max_abs_err": max_err, "max_rel_err": max_rel,
            "ms": lead["ms"], "plain_ms": lead["plain_ms"], "bound_ms": lead["bound_ms"],
            "bound_by": lead["bound_by"], "bound_fp32_ms": lead["bound_fp32_ms"],
            "ops_route": lead["ops_route"], "library_ms": lead["library_ms"],
            "library": "cuDNN backward of F.conv2d + affine + ReLU (autograd, float32, TF32 off)",
            "shape": "inc.conv1: x, y, dy [8, 376, 1240, 64] -> dx, dw, dscale, dbias, f32",
            "per_layer": shapes}


def joint_cfg(stage: str, pretrained_sp: str):
    from deepfepe_tpu_torch.train.config import config_from_dict

    raw = {**JOINT, "training": {**JOINT["training"], "train_SP": stage == "stage2",
                                 "pretrained_SP": pretrained_sp,
                                 "train_iter": JOINT_STEPS[stage]}}
    return config_from_dict(raw)


class conv_switch:
    """The SuperPoint conv switch (DEEPFEPE_SP_CONV_IMPL) set to `impl`
    inside the block."""

    def __init__(self, impl: str):
        self.impl = impl

    def __enter__(self):
        from deepfepe_tpu_torch.frontend import sp_fused

        self.saved, sp_fused.CONV_IMPL = sp_fused.CONV_IMPL, self.impl

    def __exit__(self, *exc):
        from deepfepe_tpu_torch.frontend import sp_fused

        sp_fused.CONV_IMPL = self.saved


def phase_joint_train(ph: Phases) -> dict:
    """The port's train_good with model.if_SP, stage 1 then stage 2, each
    from the same gauss2 `.pth.tar`; every kernel's launches read around
    each run alone. Returns the sums."""
    import numpy as np
    import torch

    from deepfepe_tpu_torch import cli

    pretrained = vf_pretrained("b")
    before = torch.load(pretrained, weights_only=True)["model_state_dict"]
    total = dict.fromkeys(kernel_counters(), 0)
    for stage in ("stage1", "stage2"):
        exp = f"smoke_joint_{stage}"
        shutil.rmtree(os.path.join(REPO, "logs", exp), ignore_errors=True)
        steps = JOINT_STEPS[stage]
        reset_counts()
        with conv_switch("pallas"):
            last = cli.train_good(joint_cfg(stage, pretrained), exp, device="cuda")
        torch.cuda.synchronize()
        counts = read_counts()
        expected = {k: steps * JOINT_PER_STEP[stage].get(k, 0) for k in counts}
        after = torch.load(os.path.join("logs", exp, "checkpoints",
                                        f"superPointNet_{steps}_checkpoint.pth.tar"),
                           weights_only=True)["model_state_dict"]
        moved = {k for k, v in after.items() if not torch.equal(v, before[k])}
        buffers = {k for k in after if "running_" in k}
        ph.emit("joint_train", stage=stage, steps=steps, last=last, launches=counts,
                expected_launches=expected, sp_tensors_moved=len(moved),
                bn_buffers_moved=len(moved & buffers), bn_buffers=len(buffers),
                ms_per_step_fit=last["wall_s"] * 1e3 / steps,
                timed="host clock over the CLI's loop (ending in a synchronize); its batches "
                      "are made on the host by a prefetch thread")
        check(counts == expected, f"joint {stage}: launches {counts}, expected {expected}")
        check(last["n_iter"] == steps, f"joint {stage}: ended at iteration {last['n_iter']}")
        check(all(np.isfinite(v) for v in last.values()), f"joint {stage}: non-finite {last}")
        check(last["skipped_update"] == 0.0, f"joint {stage}: the last update was skipped")
        check(0 < last["num_matches"] <= 1000, f"joint {stage}: {last['num_matches']} matches")
        check(os.path.exists(os.path.join("logs", exp, "checkpoints",
                                          f"deepFNet_{steps}_checkpoint.pth.tar")),
              f"joint {stage}: no solver checkpoint")
        if stage == "stage1":
            check(not moved, f"joint stage1: the frozen SuperPoint moved: {sorted(moved)[:5]}")
        else:
            check(buffers <= moved, "joint stage2: not every BN buffer moved")
            check(any(k.endswith(".weight") and k not in buffers for k in moved),
                  "joint stage2: no SuperPoint parameter changed")
        for k, v in counts.items():
            total[k] += v
    return total


def joint_batches(cfg, n: int, device):
    """n batches of the config's train stream on the device, made up front."""
    from deepfepe_tpu_torch.loader import data_loader
    from deepfepe_tpu_torch.utils.device import batch_to_device

    ds = data_loader(cfg, "train")
    return [batch_to_device(b, device) for b in ds.batches(cfg.data.batch_size, n)]


def device_ms(trace_path: str, names) -> float:
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    return sum(e["dur"] for e in events if e.get("cat") == "kernel" and "dur" in e
               and any(n in e.get("name", "") for n in names)) / 1e3


def phase_joint_step_times(ph: Phases, steps: int = 4) -> None:
    """Host-clock time of single joint steps of each stage between
    synchronizes, batches made up front, then one step under torch.profiler
    (the device's busy share, top kernels, K5 and K5b device time); a
    stage whose trace lost every device event is taken again in a fresh
    process (`fresh_window`). After the counted runs, so it changes no
    count."""
    for stage in ("stage1", "stage2"):
        r = window_joint_step(stage, steps)
        fresh = lost(r["profiled_step"]["device_events"] == 0)
        if fresh:
            r = fresh_window("joint_step", stage, steps)
        k5b, k5 = r["k5b_device_ms"], r["k5_device_ms"]
        if stage == "stage1":
            check(k5b > 0 and k5 > 0, f"a stage-1 joint step read K5b {k5b} and K5 {k5} device "
                  f"ms: K5B_KERNELS or K5_KERNELS name no kernel of the trace")
        ph.emit("joint_step", stage=stage, **r,
                k5b_share_of_window=k5b / r["profiled_step"]["window_ms"], fresh_process=fresh,
                timed="host clock between synchronizes, batches on the card up front")


def calibrated_gauss2(seed: int, frames):
    """Seeded SuperPointNetGauss2 whose running statistics are those of
    `frames` [n, H, W] (one train-mode forward at momentum 1), in eval mode."""
    import torch

    from deepfepe_tpu_torch.frontend import SuperPointNetGauss2
    from deepfepe_tpu_torch.frontend.superpoint import reset_superpoint

    net = reset_superpoint(SuperPointNetGauss2(), torch.Generator().manual_seed(seed))
    bns = [m for m in net.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    for m in bns:
        m.momentum = 1.0
    with torch.no_grad():
        net.train()(frames[..., None])
    for m in bns:
        m.momentum = 0.1
        m.num_batches_tracked.zero_()
    return net.eval()


class SolverBranches:
    """The solver's piecewise choices in one joint step, recorded and then
    replayed in another: for each `compute_epi_residual` call (the weight
    MLP's features and the F-loss) the sign of every algebraic residual s
    and whether its distance was clamped, and for each leaky ReLU of the
    weight MLPs the sign of its input. Recording leaves the port's results
    as they are; replaying takes the |.|, the clamp and the leaky ReLU on
    the recorded side (the same value wherever the sides agree)."""

    def __init__(self):
        self.choices: list = []
        self._replay = None

    def flips(self, other: "SolverBranches") -> int:
        """How many choices differ from `other`'s."""
        return sum(int((a != b).sum()) for a, b in zip(self.choices, other.choices))

    def _epi(self, orig):
        import torch

        from deepfepe_tpu_torch.geometry import epipolar

        def epi(pts1_h, pts2_h, F, clamp_at=0.5, eps=1e-6):
            s, Fx1, Ftx2 = epipolar._prep(pts1_h, pts2_h, F, if_homo=True)
            scale = (1.0 / (epipolar.safe_norm(Fx1[..., :2], dim=-1) + eps)
                     + 1.0 / (epipolar.safe_norm(Ftx2[..., :2], dim=-1) + eps))
            if self._replay is None:
                d = orig(pts1_h, pts2_h, F, clamp_at=clamp_at, eps=eps)
                # The clamp as the route decided it (K3 on the card).
                self.choices.append(torch.stack([s >= 0, d >= clamp_at]).cpu())
                return d
            check(bool(self._replay), "a replayed step took more solver choices")
            pos, clamped = self._replay.pop(0).to(s.device)
            d = torch.where(pos, s, -s) * scale
            return torch.where(clamped, torch.full_like(d, clamp_at), d)
        return epi

    def _leaky(self, orig):
        import torch

        def leaky(x, negative_slope=0.01, inplace=False):
            if self._replay is None:
                self.choices.append((x > 0).cpu())
                return orig(x, negative_slope)
            check(bool(self._replay), "a replayed step took more solver choices")
            return torch.where(self._replay.pop(0).to(x.device), x, x * negative_slope)
        return leaky

    @contextlib.contextmanager
    def patched(self, replay: "SolverBranches | None" = None):
        """Record into this object, or replay `replay`'s choices, inside
        the block."""
        import importlib

        import torch

        mods = [importlib.import_module(m) for m in ("deepfepe_tpu_torch.models.deepfnet",
                                                     "deepfepe_tpu_torch.losses.f_loss")]
        saved = [m.compute_epi_residual for m in mods] + [torch.nn.functional.leaky_relu]
        self._replay = None if replay is None else list(replay.choices)
        for m in mods:
            m.compute_epi_residual = self._epi(saved[0])
        torch.nn.functional.leaky_relu = self._leaky(saved[-1])
        try:
            yield self
        finally:
            for m, f in zip(mods, saved):
                m.compute_epi_residual = f
            torch.nn.functional.leaky_relu = saved[-1]
        check(self._replay in (None, []), "a replayed step took fewer solver choices")
        if replay is not None:
            self.choices = replay.choices


def joint_step_report(dev: str, bn_mode: str, sp_state: dict, deepf_state: dict, batch: dict,
                      float64: bool = False, replay: SolverBranches | None = None) -> dict:
    """One joint step (train_sp on) on `dev` from the given weights: loss,
    gradient norms, SuperPoint gradient leaves, new buffers, ordered match
    lists, the kernels' launches and the solver's choices (replaying
    `replay`'s)."""
    import torch

    from deepfepe_tpu_torch.frontend import FrontendParams, SuperPointNetGauss2
    from deepfepe_tpu_torch.frontend import get_matches_from_sp
    from deepfepe_tpu_torch.models import DeepFNet
    from deepfepe_tpu_torch.train.config import config_from_dict
    from deepfepe_tpu_torch.train.joint import joint_train_step, make_joint_state
    from deepfepe_tpu_torch.utils.device import batch_to_device

    c = CHECK_JOINT
    cfg = config_from_dict({"data": {"batch_size": c["pairs"], "good_num": c["K"]},
                            "model": {"depth": c["depth"], "if_quality": True,
                                      "mlp_dtype": "float32"}})
    device = torch.device("cuda" if dev == "card" else dev)
    sp = SuperPointNetGauss2()
    sp.load_state_dict(sp_state)
    deepf = DeepFNet(depth=c["depth"], image_size=c["size"], if_quality=True,
                     sign_canonical=True)
    deepf.load_state_dict(deepf_state)
    tb = batch_to_device(batch, device)
    if float64:
        sp, deepf = sp.double(), deepf.double()
        deepf.input_weights.dtype = deepf.update_weights.dtype = torch.float64
        tb = {k: v.double() if v.is_floating_point() else v for k, v in tb.items()}
    sp, deepf = sp.to(device).eval(), deepf.to(device)
    fp = FrontendParams(out_num_points=c["K"], conf_thresh=1e-4, conv_impl="pallas")
    frames = (tb["imgs_grey"][:, 0], tb["imgs_grey"][:, 1])
    probe = {k: v.clone() for k, v in sp.state_dict().items()}
    with torch.no_grad():
        m = get_matches_from_sp(sp, frames, fp, bn_train=bn_mode == "train")["matches"]
    sp.load_state_dict(probe)  # the probe's train-mode forward moved the buffers
    order = [[(int(a), int(b)) for a, b, v in zip(m.idx1[i].tolist(), m.idx2[i].tolist(),
                                                  m.valid[i].tolist()) if v]
             for i in range(m.valid.shape[0])]
    reset_counts()
    branches = SolverBranches()
    with branches.patched(replay):
        metrics = joint_train_step(make_joint_state(deepf, sp, cfg), tb, fp, cfg, 0.1, 0.5,
                                   bn_mode=bn_mode)
    if device.type == "cuda":
        torch.cuda.synchronize()
    return {"loss": float(metrics["loss"]), "g_deepf_norm": float(metrics["g_deepf_norm"]),
            "g_sp_norm": float(metrics["g_sp_norm"]), "order": order,
            "grads": {k: p.grad.detach().double().cpu() for k, p in sp.named_parameters()},
            "buffers": {k: v.detach().double().cpu() for k, v in sp.named_buffers()
                        if "running_" in k},
            "launches": read_counts(), "branches": branches}


def sp_output_grads(dev: str, bn_mode: str, sp_state: dict, imgs, cot,
                    float64: bool = False) -> dict:
    """SuperPoint parameter gradients of <semi, c1> + <desc, c2> for both
    frames of `imgs` [B, 2, H, W] in the joint step's route for `bn_mode`:
    'frozen' BatchNorm on the running statistics, on the card the fused
    forward with the conv switch on K5 (the stage-1 route), on the CPU the
    module forward; 'train' the module forward with train-mode BatchNorm
    in two groups. `float64` on the CPU; with the kernels' launches."""
    import torch

    from deepfepe_tpu_torch.frontend import SuperPointNetGauss2
    from deepfepe_tpu_torch.frontend.sp_fused import superpoint_forward_fused
    from deepfepe_tpu_torch.ops.conv import exact_convs

    device = torch.device("cuda" if dev == "card" else dev)
    dt = torch.float64 if float64 else torch.float32
    sp = SuperPointNetGauss2()
    sp.load_state_dict(sp_state)
    sp = sp.to(device, dt).train(bn_mode == "train")
    x = torch.as_tensor(imgs, device=device, dtype=dt)
    x = torch.cat([x[:, 0], x[:, 1]])[..., None].contiguous()
    reset_counts()
    with exact_convs():  # the plain convs as the joint step runs them
        if bn_mode == "train":
            outs = sp(x, bn_groups=2)
        else:
            outs = superpoint_forward_fused(sp, x, "pallas") if dev == "card" else sp(x)
        c1, c2 = (torch.as_tensor(a, device=device, dtype=dt) for a in cot)
        (torch.sum(outs["semi"] * c1) + torch.sum(outs["desc"] * c2)).backward()
    if device.type == "cuda":
        torch.cuda.synchronize()
    return {"grads": {k: p.grad.detach().double().cpu() for k, p in sp.named_parameters()},
            "launches": read_counts()}


def leaf_errors(grads: dict, ref: dict) -> dict:
    """Each leaf's largest error, relative to its largest `ref` entry, or
    to the net's largest where the leaf's is under 1e-4 of that (a leaf
    that is zero in exact arithmetic)."""
    top = max(w.abs().max().item() for w in ref.values())
    return {k: (grads[k] - w).abs().max().item()
            / (w.abs().max().item() if w.abs().max().item() >= 1e-4 * top else top)
            for k, w in ref.items()}


def against_cpu(card: float, cpu: float, floor: float) -> dict:
    """A card distance with its bar: 2 x the CPU's + floor, at most
    CHECK_JOINT_CAP."""
    limit = min(2.0 * cpu + floor, CHECK_JOINT_CAP)
    return {"card": card, "cpu": cpu, "limit": limit, "ok": card <= limit}


def leaves_against_cpu(card: dict, cpu: dict, ref_card: dict, ref_cpu: dict) -> dict:
    """Every leaf through `against_cpu` (floor 1e-3); the worst ones."""
    ec, eu = leaf_errors(card, ref_card), leaf_errors(cpu, ref_cpu)
    per = {k: against_cpu(ec[k], eu[k], 1e-3) for k in ec}
    worst = max(per, key=lambda k: per[k]["card"] / per[k]["limit"])
    return {"n": len(per), "all_ok": all(v["ok"] for v in per.values()),
            "worst_card_vs_f64": max(ec.values()), "worst_cpu_vs_f64": max(eu.values()),
            "tightest_leaf": worst, "tightest": per[worst],
            "failing": {k: v for k, v in per.items() if not v["ok"]}}


def joint_compare(r: dict, f: dict, bn_mode: str, sp_state: dict) -> dict:
    """check_joint's readings and verdict for one bn_mode: the joint-step
    reports `r` (card and cpu in float32, f64_card and f64_cpu replaying
    their solver choices in float64, f64 on its own) and the SuperPoint
    output gradients `f` (f64, cpu, card)."""
    card, cpu, ref_card, ref_cpu, f64 = (r[k] for k in ("card", "cpu", "f64_card", "f64_cpu",
                                                         "f64"))
    rel = lambda a, b: abs(a - b) / abs(b)  # noqa: E731
    step = {q: against_cpu(rel(card[q], ref_card[q]), rel(cpu[q], ref_cpu[q]), floor)
            for q, floor in (("loss", 1e-4), ("g_deepf_norm", 1e-3), ("g_sp_norm", 1e-3))}
    leaves = leaves_against_cpu(card["grads"], cpu["grads"], ref_card["grads"], ref_cpu["grads"])
    alone = leaves_against_cpu(f["card"]["grads"], f["cpu"]["grads"], f["f64"]["grads"],
                               f["f64"]["grads"])
    # What float64's own choices would give: the kinks the float32 runs crossed.
    kinks = {"card_flips": card["branches"].flips(f64["branches"]),
             "cpu_flips": cpu["branches"].flips(f64["branches"]),
             **{f"{q}_f64_own_vs_card_branches": rel(f64[q], ref_card[q])
                for q in ("g_deepf_norm", "g_sp_norm")}}
    buf = max(((card["buffers"][k] - cpu["buffers"][k]).abs().max()
               / cpu["buffers"][k].abs().max()).item() for k in cpu["buffers"])
    unchanged = all(bool((card["buffers"][k] == sp_state[k].double()).all())
                    for k in cpu["buffers"])
    n = 2 if bn_mode == "frozen" else 0
    want = {"conv3x3_affine_relu": n, "conv3x3_affine_relu_bwd": n}
    orders = card["order"] == cpu["order"] == f64["order"]
    ok = (orders and all(v["ok"] for v in step.values()) and leaves["all_ok"]
          and alone["all_ok"]
          and all(card["launches"][k] == v and f["card"]["launches"][k] == v
                  for k, v in want.items())
          and (unchanged if bn_mode == "frozen" else buf <= 1e-5 and not unchanged)
          and sum(cpu["launches"].values()) + sum(f["cpu"]["launches"].values()) == 0)
    return {"bn_mode": bn_mode, "matches": [len(o) for o in cpu["order"]],
            "orders_equal": orders, "step": step, "step_sp_leaves": leaves,
            "sp_alone_leaves": alone, "kinks": kinks, "buffers_rel_card_vs_cpu": buf,
            "buffers_unchanged": unchanged, "launches_card_step": card["launches"],
            "launches_card_sp_alone": f["card"]["launches"], "within_bars": ok}


def phase_check_joint(ph: Phases, seed: int | None = None) -> None:
    """One joint step on the card against the CPU's plain routes, each
    against the CPU in float64 on its own solver branches, for both
    bn_modes (CHECK_JOINT; `seed` for another batch); the 'frozen' step
    trains SuperPoint through the fused forward with the conv switch on
    K5, so K5b's gradients reach Adam."""
    import numpy as np
    import torch

    from deepfepe_tpu_torch.data import SyntheticImagePairs
    from deepfepe_tpu_torch.models import DeepFNet

    c = dict(CHECK_JOINT, seed=CHECK_JOINT["seed"] if seed is None else seed)
    batch = SyntheticImagePairs(image_size=c["size"], seed=c["seed"]).batch(c["pairs"])
    calib = SyntheticImagePairs(image_size=c["size"], seed=11).batch(c["pairs"])["imgs_grey"]
    sp_state = calibrated_gauss2(0, torch.from_numpy(calib).reshape(-1, *c["size"])).state_dict()
    leaf_state = {"frozen": torch.load(vf_pretrained("b"), weights_only=True)["model_state_dict"],
                  "train": sp_state}
    deepf = DeepFNet(depth=c["depth"], image_size=c["size"], if_quality=True,
                     sign_canonical=True)
    deepf.reset_parameters(torch.Generator().manual_seed(1))
    rng = np.random.RandomState(4)
    hc, wc = c["size"][0] // 8, c["size"][1] // 8
    cot = (rng.randn(2 * c["pairs"], hc, wc, 65).astype(np.float32),
           rng.randn(2 * c["pairs"], hc, wc, 256).astype(np.float32))
    for bn_mode in ("frozen", "train"):
        step = lambda dev, f64=False, replay=None: joint_step_report(  # noqa: E731
            dev, bn_mode, sp_state, deepf.state_dict(), batch, f64, replay)
        r = {"card": step("card"), "cpu": step("cpu"), "f64": step("cpu", True)}
        r["f64_card"] = step("cpu", True, r["card"]["branches"])
        r["f64_cpu"] = step("cpu", True, r["cpu"]["branches"])
        f = {name: sp_output_grads(dev, bn_mode, leaf_state[bn_mode], batch["imgs_grey"], cot,
                                   f64)
             for name, dev, f64 in (("f64", "cpu", True), ("cpu", "cpu", False),
                                    ("card", "card", False))}
        report = joint_compare(r, f, bn_mode, sp_state)
        ph.emit("check", seed=c["seed"], joint_step=report, bars={
            "each": "card vs float64 on the card's solver branches <= min(2 x (CPU vs "
            f"float64 on the CPU's) + floor, {CHECK_JOINT_CAP})",
            "floors": {"loss": 1e-4, "g_norms": 1e-3, "sp_leaves": 1e-3},
            "buffers_rel": 1e-5})
        check(report["within_bars"],
              f"joint step ({bn_mode}) on the card disagrees with the CPU: {report}")


# ------------------------------------------------- solver-variant slice

# K3 (the epipolar residual) at its three callers' shapes (name, P, M, N,
# clamp): DeepFNet's feature ([B, N, 3] with [B, 3, 3]), the F-loss ([1,
# B, V, 3] with [L, B, 3, 3]) and the sample loss's auxiliary ([1, B, 1,
# V, 3] with [L, B, S, 3, 3], L S = 500 matrices per item). Each shape
# holds a zero-row F (item 0, matrix 0: (F x1)_xy is exactly 0, d is
# clamped), an s = 0 (item 1, last matrix, point 0) and a d exactly at the
# clamp (item 2, last matrix, point 1: small powers of two, so the kernel
# and the plain version compute the same d; the clamp is set to it). The
# forward is held at tests/test_jacobi.py's bar for the Pallas kernel
# (rtol 1e-4, atol 1e-5), against the plain version and float64; each
# gradient (dF, and the points' for the learned offsets) within 1e-4 of the
# largest float64 entry, against both; float64 differentiates on the plain
# float32 run's side of each |s| and clamp (the solver's kinks, as in
# SolverBranches).
EPI_SHAPES = (("deepfnet", 8, 1, 1000, 0.5), ("f_loss", 8, 5, 100, 0.02),
              ("sample_aux", 8, 500, 100, 0.02))
EPI_RTOL, EPI_ATOL, EPI_GRAD_REL = 1e-4, 1e-5, 1e-4
# Operations per (item, matrix, point), counted from csrc/epi_residual.cu:
# the residual ~45 (F x1, (F' x2)_xy, s, two norms, two reciprocals); its
# cotangents ~25; dF's nine products 30; the points' 36.
EPI_FLOPS = {"forward": 45, "dF": 100, "dpts": 106}


def epi_bound_ms(P: int, M: int, N: int, kind: str) -> tuple[float, str]:
    """Least time for K3 ('forward'), its dF ('dF') or dF and the points'
    gradients ('dF+dpts'): the operations above over the FP32 rate, against
    the points, F (and the cotangent) read once and the outputs written
    once over HBM."""
    flops = sum(EPI_FLOPS[k] for k in kind.split("+")) * P * M * N
    pts, mats, res = 2 * P * N * 3, P * M * 9, P * M * N
    floats = pts + mats + res + (mats if kind != "forward" else 0) \
        + (pts if "dpts" in kind else 0)
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS * 1e3, 4 * floats / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def epi_inputs(P: int, M: int, N: int, clamp: float, seed: int):
    """Points in the solver's [-1, 1] frame, x2 on x1's epipolar line of a
    sideways translation (F0) up to noise, and matrices F0 + noise, so that
    some residuals are clamped and most are not; with the three special
    cases of EPI_SHAPES. Returns (pts1 [P, N, 3], pts2, F9 [P, M, 9],
    clamp): the clamp is the tie point's d."""
    import math

    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    kw = {"device": "cuda", "generator": g}
    x1 = torch.rand(P, N, 2, **kw) * 2 - 1
    x2 = torch.stack([torch.rand(P, N, **kw) * 2 - 1,
                      x1[..., 1] + 0.5 * clamp * torch.randn(P, N, **kw)], dim=-1)
    ones = torch.ones(P, N, 1, device="cuda")
    pts1, pts2 = torch.cat([x1, ones], -1), torch.cat([x2, ones], -1)
    F0 = torch.tensor([0.0, 0, 0, 0, 0, -1, 0, 1, 0], device="cuda")
    F9 = F0 + 0.1 * clamp * torch.randn(P, M, 9, **kw)
    F9[0, 0, :6] = 0.0                                        # zero rows
    pts1[1, 0] = pts2[1, 0] = torch.tensor([0.0, 0, 1])       # s = F22 = 0
    F9[1, -1, 8] = 0.0
    s_tie = 2.0 ** -round(math.log2(2.0 / clamp))             # d ~ clamp
    pts1[2, 1] = torch.tensor([0.25, 0.5, 1.0])
    pts2[2, 1] = torch.tensor([0.75, 0.5 - s_tie, 1.0])
    F9[2, -1] = F0
    return pts1, pts2, F9


def epi_case(P: int, M: int, N: int, clamp: float, seed: int) -> dict:
    """One EPI_SHAPES case: the kernels against the plain versions (the
    plain forward with autograd for the gradients) and float64."""
    import torch

    from deepfepe_tpu_torch.geometry.basic import safe_norm
    from deepfepe_tpu_torch.ops import epi_residual as epi

    pts1, pts2, F9 = epi_inputs(P, M, N, clamp, seed)
    F = F9.view(P, M, 3, 3)
    x1, x2 = pts1[:, None], pts2[:, None]
    clamp = float(epi.epi_residual_ref(x1[2:3], x2[2:3], F[2:3, -1:], 1e30)[0, 0, 1])
    g = torch.randn(P, M, N, device="cuda", generator=torch.Generator(device="cuda")
                    .manual_seed(seed + 1))
    d = epi.epi_residual_fwd(pts1, pts2, F9, clamp, 1e-6)
    dF, d1, d2 = epi.epi_residual_bwd(pts1, pts2, F9, g, clamp, 1e-6)
    again = (epi.epi_residual_fwd(pts1, pts2, F9, clamp, 1e-6),
             *epi.epi_residual_bwd(pts1, pts2, F9, g, clamp, 1e-6))

    def plain(dtype, kinks=None):
        """The plain forward and its autograd gradients in `dtype`; with
        `kinks` (a float32 run's sign of s and clamp mask) the |s| and the
        clamp take that run's side, so that float64 differentiates the same
        piece of the residual."""
        a, b, f = (t.detach().to(dtype).requires_grad_() for t in (pts1, pts2, F))
        if kinks is None:
            out = epi.epi_residual_ref(a[:, None], b[:, None], f, clamp, 1e-6)
        else:
            sign, clamped = kinks
            Fx1, Ftx2 = a[:, None] @ f.transpose(-1, -2), b[:, None] @ f
            s = torch.sum(b[:, None] * Fx1, dim=-1)
            scale = (1.0 / (safe_norm(Fx1[..., :2], dim=-1) + 1e-6)
                     + 1.0 / (safe_norm(Ftx2[..., :2], dim=-1) + 1e-6))
            out = torch.where(clamped, torch.full_like(s, clamp), sign.to(dtype) * s * scale)
        grads = torch.autograd.grad(out, (f, a, b), g.to(dtype))
        return out.detach(), grads[0].reshape(P, M, 9), grads[1], grads[2]

    ref = plain(torch.float32)
    s32 = torch.sum(x2 * (x1 @ F.transpose(-1, -2)), dim=-1)
    d32 = epi.epi_residual_ref(x1, x2, F, float("inf"))  # before the clamp
    # Float32 puts some of the 10^5 residuals on the other side of the clamp
    # or of s = 0 than float64 (7.7% of dF's largest entry at the sample
    # aux's shape when float64 takes its own side: a kink, not an error).
    ref64 = plain(torch.float64, (torch.sign(s32), d32 > clamp))
    torch.cuda.synchronize()
    got = (d, dF, d1, d2)
    names = ("residual", "dF", "dpts1", "dpts2")
    errs = {}
    for name, k, r, r64 in zip(names, got, ref, ref64):
        if name == "residual":
            tol = EPI_ATOL + EPI_RTOL * r64.abs()
            errs[name] = {"kernel_vs_plain": ((k - r).abs() / (EPI_ATOL + EPI_RTOL * r.abs()))
                          .max().item(),
                          "kernel_vs_f64": ((k.double() - r64).abs() / tol).max().item(),
                          "plain_vs_f64": ((r.double() - r64).abs() / tol).max().item()}
        else:
            top = r64.abs().max().item()
            errs[name] = {"kernel_vs_plain": (k - r).abs().max().item() / top,
                          "kernel_vs_f64": (k.double() - r64).abs().max().item() / top,
                          "plain_vs_f64": (r.double() - r64).abs().max().item() / top}
    special = {"zero_row_dF_max": dF[0, 0].abs().max().item(),
               "zero_row_d_clamped": bool(d[0, 0].eq(clamp).all()),
               "s0_d": d[1, -1, 0].item(), "tie_d_equals_clamp": d[2, -1, 1].item() == clamp,
               "clamped_share": d.eq(clamp).float().mean().item()}
    finite = all(bool(torch.isfinite(t).all()) for t in got)
    special["bit_identical_twice"] = all(torch.equal(a, b) for a, b in zip(got, again))
    ok = (finite and special["bit_identical_twice"] and special["zero_row_dF_max"] == 0.0
          and special["zero_row_d_clamped"] and special["s0_d"] == 0.0
          and special["tie_d_equals_clamp"]
          and all(e["kernel_vs_plain"] <= 1.0 and e["kernel_vs_f64"] <= 1.0
                  for e in [errs["residual"]])
          and all(errs[n][k] <= EPI_GRAD_REL for n in names[1:]
                  for k in ("kernel_vs_plain", "kernel_vs_f64")))
    return {"errors": errs, "special": special, "clamp": clamp, "within_bars": ok,
            "inputs": (pts1, pts2, F9, g, clamp), "max_abs_err": (d - ref[0]).abs().max().item()}


# The rows of tools/profile_epi.py: its cases by direction.
EPI_CALLERS = ("deepfnet_forward", "deepfnet_backward", "offsets_backward", "f_loss_forward",
               "f_loss_backward", "sample_aux_forward", "sample_aux_backward",
               "sample_aux_points_backward")


def epi_callers(ph: Phases) -> dict:
    """K3 at each caller's pattern through compute_epi_residual: the
    readings of `python -m deepfepe_tpu_torch.tools.profile_epi --iters
    100`, run in a process of its own (its profiler sessions over autograd
    calls left this process's later traces without device events), beside
    the bound; exactly one device operation a forward and one a backward,
    a K3 kernel."""
    proc = subprocess.run([sys.executable, "-m", "deepfepe_tpu_torch.tools.profile_epi",
                           "--iters", "100"], cwd=REPO, capture_output=True, text=True)
    check(proc.returncode == 0, f"tools/profile_epi.py failed: {proc.stderr[-2000:]}")
    rows = [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith("{")]
    callers = {}
    for row in rows[1:]:
        row["fresh_process"] = lost(not row["one_call"])
        if row["fresh_process"]:
            row.update(fresh_window("epi", row["case"], row["direction"], 100))
        name, direction = row["case"], row["direction"]
        P = math.prod(row["points"][:-2])
        M, N = math.prod(row["F"][:-2]) // P, row["points"][-2]
        kind = ("forward" if direction == "forward" else
                "dF+dpts" if row["points_gradient"] else "dF")
        bound, by = epi_bound_ms(P, M, N, kind)
        ops = row["one_call"]
        callers[f"{name}_{direction}"] = {
            "shape": [P, M, N], "device_ops_a_call": ops, "traces_taken": row["traces"],
            "fresh_process": row["fresh_process"],
            **{k: row[k] for k in ("kernel_ms", "device_ms", "device_ops", "ms", "host_ms")},
            "bound_ms": bound, "bound_by": by}
        check(len(ops) == 1 and any(k in ops[0] for k in EPI_KERNELS),
              f"K3 at {name} ({direction}) ran {ops}, expected one K3 kernel")
    check(sorted(callers) == sorted(EPI_CALLERS), f"tools/profile_epi.py gave {sorted(callers)}")
    ph.emit("kernels", kernel="epi_residual", callers=callers, empty_launch_ms=rows[0].get(
                "empty_launch_ms"),
            timed="tools/profile_epi.py: kernel_ms, device_ms: torch.profiler durations over "
                  "100 calls, a call; ms: CUDA events around 100 back-to-back calls; host_ms: "
                  "host clock to issue one")
    return callers


def phase_epi_kernel(ph: Phases) -> list:
    """K3 and its backward at EPI_SHAPES against the plain versions and
    float64, two calls bit-identical, each timed beside the plain version
    and its bound; then at each caller's pattern (`epi_callers`). No single
    PyTorch call computes the residual, so there is no library time."""
    import torch

    from deepfepe_tpu_torch.ops import epi_residual as epi

    cases, max_fwd, max_bwd = {}, 0.0, 0.0
    for i, (name, P, M, N, clamp) in enumerate(EPI_SHAPES):
        c = epi_case(P, M, N, clamp, seed=10 + i)
        pts1, pts2, F9, g, clamp = c.pop("inputs")
        F = F9.view(P, M, 3, 3)
        Fr = F.clone().requires_grad_()

        def plain_fwd_bwd():
            out = epi.epi_residual_ref(pts1[:, None], pts2[:, None], Fr, clamp, 1e-6)
            torch.autograd.grad(out, Fr, g)

        timing = {
            "ms": cuda_time_ms(lambda: epi.epi_residual_fwd(pts1, pts2, F9, clamp, 1e-6), 200),
            "bwd_ms": cuda_time_ms(lambda: epi.epi_residual_bwd(
                pts1, pts2, F9, g, clamp, 1e-6, True, False, False), 200),
            "bwd_points_ms": cuda_time_ms(lambda: epi.epi_residual_bwd(
                pts1, pts2, F9, g, clamp, 1e-6), 200),
            "plain_ms": cuda_time_ms(lambda: epi.epi_residual_ref(
                pts1[:, None], pts2[:, None], F, clamp, 1e-6), 100),
            "plain_fwd_bwd_ms": cuda_time_ms(plain_fwd_bwd, 50)}
        timing["plain_bwd_ms"] = timing["plain_fwd_bwd_ms"] - timing["plain_ms"]
        for key, kind in (("bound_ms", "forward"), ("bwd_bound_ms", "dF"),
                          ("bwd_points_bound_ms", "dF+dpts")):
            timing[key], timing[key.replace("_ms", "_by")] = epi_bound_ms(P, M, N, kind)
        ph.emit("kernels", kernel="epi_residual", caller=name, shape=[P, M, N], **c, **timing,
                bars={"residual": f"|kernel - ref| <= {EPI_ATOL} + {EPI_RTOL} |ref| (errors "
                      "are in units of that bar)", "gradients": f"{EPI_GRAD_REL} of the largest "
                      "float64 entry"})
        check(c["within_bars"], f"K3 at {name} {[P, M, N]} is outside its bars: {c}")
        cases[name] = {"shape": [P, M, N], **timing}
        max_fwd = max(max_fwd, c["max_abs_err"])
        max_bwd = max(max_bwd, *(c["errors"][n]["kernel_vs_plain"] for n in ("dF", "dpts1",
                                                                             "dpts2")))
    callers = epi_callers(ph)
    lead = cases["sample_aux"]
    common = {"route": "cuda", "source": "deepfepe_tpu_torch/csrc/epi_residual.cu",
              "replaces": "deepfepe_tpu/ops/pallas/epi_residual_pallas.py:23", "launches": None,
              "library_ms": None,
              "library": "none: no single PyTorch call computes the residual",
              "shape": "sample aux: points [8, 100, 3] x F [8, 500, 9] f32", "per_caller": cases}
    fwd = {"name": "epi_residual", "max_abs_err": max_fwd, "ms": lead["ms"],
           "device_ms": callers["sample_aux_forward"]["kernel_ms"],
           "plain_ms": lead["plain_ms"], "bound_ms": lead["bound_ms"],
           "bound_by": lead["bound_by"], **common}
    bwd = {"name": "epi_residual_bwd", "max_abs_err": max_bwd, "ms": lead["bwd_ms"],
           "device_ms": callers["sample_aux_backward"]["kernel_ms"],
           "plain_ms": lead["plain_bwd_ms"], "bound_ms": lead["bwd_bound_ms"],
           "bound_by": lead["bwd_bound_by"],
           "max_abs_err_is": "relative to the largest float64 entry of dF, dpts1, dpts2",
           "ms_with_points": lead["bwd_points_ms"],
           "bound_ms_with_points": lead["bwd_points_bound_ms"], **common}
    return [fwd, bwd]


# The sample-loss variant of train_good at configs/synthetic_baseline.yaml's
# full width with model.if_sample_loss (B = 8, N = 1000, depth 5, bf16 MLPs
# on the plain route as configured, 20-point subsets, 100 a layer, V = 100
# virtual points): SAMPLE_STEPS steps, one validation and a checkpoint, step
# 2 under torch.profiler.
SAMPLE_STEPS = 4
SAMPLE = {
    **BASELINE,
    "model": {**BASELINE["model"], "if_sample_loss": True},
    "training": {**TRAIN_F["training"], "train_iter": SAMPLE_STEPS, "val_interval": SAMPLE_STEPS,
                 "val_batches": 1, "save_interval": SAMPLE_STEPS, "profile_start": 2,
                 "profile_steps": 1},
}
# The other ported variants at the same width, 2 steps each.
VARIANT_FLAGS, VARIANT_STEPS = ("if_learn_offsets", "if_tri_depth", "if_goodCorresArch"), 2
EPI_KERNELS = ("epi_fwd_kernel", "epi_bwd_kernel")


def sample_expected(depth: int, steps: int, vals: int) -> dict:
    """Launches of a sample-loss run, counted from the code: a forward fits
    each layer once and its 100 subsets once more (two eigh9 batches a
    layer); K3 runs depth - 1 times in DeepFNet, once in the F-loss and once
    on the subsets' hypotheses (the F-loss's sample auxiliary), each with
    its backward in a train step; validations run forwards only."""
    return {**dict.fromkeys(kernel_counters(), 0), "eigh9": 2 * depth * (steps + vals),
            "epi_residual": (depth + 1) * (steps + vals), "epi_residual_bwd": (depth + 1) * steps}


def train_lines(exp: str, tag: str = "train") -> list:
    with open(os.path.join("logs", exp, "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if r["tag"] == tag]


def phase_sample_train(ph: Phases) -> dict:
    """The port's train_good with model.if_sample_loss at full width; every
    kernel's launches read around the run; then single steps timed between
    synchronizes (after the count)."""
    import numpy as np
    import torch

    from deepfepe_tpu_torch import cli
    from deepfepe_tpu_torch.train.config import config_from_dict

    exp = "smoke_sample"
    shutil.rmtree(os.path.join(REPO, "logs", exp), ignore_errors=True)
    prof_dir = os.path.join("logs", exp, "profile")
    cfg = config_from_dict(SAMPLE)
    reset_counts()
    last = cli.train_good(cfg, exp, profile_dir=prof_dir, device="cuda")
    torch.cuda.synchronize()
    counts = read_counts()
    expected = sample_expected(cfg.model.depth, SAMPLE_STEPS, 1)
    steps, vals = train_lines(exp), train_lines(exp, "val")
    trace_path = os.path.join(prof_dir, "trace.json")
    trace = read_trace(trace_path)
    ms = last["wall_s"] * 1e3 / SAMPLE_STEPS
    ph.emit("sample_train", steps=SAMPLE_STEPS, validations=len(vals), last=last, val=vals,
            launches=counts, expected_launches=expected, ms_per_step_fit=ms,
            pairs_per_s_fit=cfg.data.batch_size * 1e3 / ms, profiled_step=trace,
            k3_device_ms=device_ms(trace_path, EPI_KERNELS),
            eigh9_device_ms=device_ms(trace_path, ("eigh9_warp_kernel", "eigh9_thread_kernel")),
            timed="host clock over fit (ending in a synchronize), incl. its validation, "
                  "checkpoint and profiled step")
    check(counts == expected, f"sample loss: launches {counts}, expected {expected}")
    check(last["n_iter"] == SAMPLE_STEPS and len(steps) == SAMPLE_STEPS and len(vals) == 1,
          f"sample loss: {last['n_iter']} steps, {len(vals)} validations")
    check(all(np.isfinite(v) for v in last.values()), f"sample loss: non-finite metrics {last}")
    check(all(r["nonfinite"] == 0.0 and np.isfinite(r["loss_selected_F"]) for r in steps),
          "sample loss: a step skipped its update or had a non-finite loss_selected_F")
    check(np.isfinite(vals[0]["loss_selected_F"]), "sample loss: non-finite validation")
    check(os.path.exists(os.path.join("logs", exp, "checkpoints",
                                      f"deepFNet_{SAMPLE_STEPS}_checkpoint.pth.tar")),
          "sample loss: no checkpoint")

    phase_step_times(ph, SAMPLE, "sample_train", 5)
    return counts


def phase_variants(ph: Phases) -> dict:
    """The port's train_good with each other ported variant at full width,
    VARIANT_STEPS steps; exact launches (eigh9 once a layer, K3 and its
    backward depth - 1 times in DeepFNet and once in the F-loss; the learned
    offsets' point gradient on the depth - 2 layers whose points moved)."""
    import numpy as np
    import torch

    from deepfepe_tpu_torch import cli
    from deepfepe_tpu_torch.ops.epi_residual import epi_residual_bwd
    from deepfepe_tpu_torch.train.config import config_from_dict

    total = dict.fromkeys(kernel_counters(), 0)
    for flag in VARIANT_FLAGS:
        raw = {**BASELINE, "model": {**BASELINE["model"], flag: True},
               "training": {**TRAIN_F["training"], "train_iter": VARIANT_STEPS,
                            "val_interval": 0, "save_interval": 0, "tensorboard": False}}
        cfg = config_from_dict(raw)
        exp = f"smoke_{flag}"
        shutil.rmtree(os.path.join(REPO, "logs", exp), ignore_errors=True)
        reset_counts()
        last = cli.train_good(cfg, exp, device="cuda")
        torch.cuda.synchronize()
        counts, points = read_counts(), epi_residual_bwd.point_launches
        d, n = cfg.model.depth, VARIANT_STEPS
        expected = {k: 0 for k in counts}
        expected.update(eigh9=d * n, epi_residual=d * n, epi_residual_bwd=d * n)
        want_points = (d - 2) * n if flag == "if_learn_offsets" else 0
        ph.emit("variants", variant=flag, steps=n, last=last, launches=counts,
                expected_launches=expected, k3_point_gradient_launches=points,
                expected_point_gradient_launches=want_points,
                ms_per_step_fit=last["wall_s"] * 1e3 / n,
                timed="host clock over fit incl. the first step's warm-up")
        check(counts == expected and points == want_points,
              f"{flag}: launches {counts} ({points} point gradients), expected {expected} "
              f"({want_points})")
        check(last["n_iter"] == n and all(np.isfinite(v) for v in last.values())
              and all(r["nonfinite"] == 0.0 for r in train_lines(exp)),
              f"{flag}: {last}")
        for k, v in counts.items():
            total[k] += v
    return total


def sample_step_report(cfg, dev: str, state: dict, batch: dict, float64: bool = False,
                       idx: list | None = None, replay: "SolverBranches | None" = None) -> dict:
    """One sample-loss train step from `state` (`train_step_grads`),
    recording each layer's drawn subsets (replaying `idx` when given) and
    the solver's kink choices (replaying `replay`'s)."""
    import importlib

    sample_fit = importlib.import_module("deepfepe_tpu_torch.models.sample_fit")
    drawn, saved = [], sample_fit.sample_loss_fits

    def fits(*a, **k):
        if idx is not None:
            k["idx"] = idx[len(drawn)]
        out = saved(*a, **k)
        drawn.append(out["sample_idx"].cpu())
        return out

    sample_fit.sample_loss_fits = fits
    branches = SolverBranches()
    try:
        with branches.patched(replay):
            loss, grads = train_step_grads(cfg, dev, state, batch, float64)
    finally:
        sample_fit.sample_loss_fits = saved
    return {"loss": loss, "grads": grads, "idx": drawn, "branches": branches}


def phase_check_sample(ph: Phases) -> None:
    """One sample-loss train step (float32, plain MLP route, B = 2, N = 200,
    depth 5) on the card against the CPU: the card draws the subsets, the
    CPU replays them; each run is held against float64 on the CPU on the
    same draws and on that run's own side of every |s|, clamp and
    leaky-ReLU kink (`SolverBranches`, as check_joint). Bars as check_joint:
    the card's distance from float64 at most twice the CPU's plus a floor
    (loss 1e-4; gradients, the worst parameter in the Frobenius norm, 1e-3),
    and at most CHECK_JOINT_CAP; gradients zero in exact arithmetic below
    1e-6."""
    import torch

    from deepfepe_tpu_torch.data import SyntheticPairs
    from deepfepe_tpu_torch.loader import model_loader
    from deepfepe_tpu_torch.train.config import config_from_dict

    batch = SyntheticPairs(image_size=(376, 1241), good_num=200, seed=7).batch(2)
    cfg = config_from_dict({**SAMPLE, "data": {**SAMPLE["data"], "batch_size": 2,
                                               "good_num": 200},
                            "model": {**SAMPLE["model"], "mlp_dtype": "float32"}})
    state = model_loader(cfg, torch.device("cpu"), torch.Generator().manual_seed(3)).state_dict()
    card = sample_step_report(cfg, "cuda", state, batch)
    cpu = sample_step_report(cfg, "cpu", state, batch, idx=card["idx"])
    f64_card = sample_step_report(cfg, "cpu", state, batch, True, card["idx"], card["branches"])
    f64_cpu = sample_step_report(cfg, "cpu", state, batch, True, card["idx"], cpu["branches"])
    f64_own = sample_step_report(cfg, "cpu", state, batch, True, card["idx"])
    frob = lambda a, b: float((a - b).norm() / b.norm().clamp_min(1e-30))  # noqa: E731
    live = [k for k, g in f64_card["grads"].items() if g.abs().max().item() > 1e-6]
    card_d = {k: frob(card["grads"][k], f64_card["grads"][k]) for k in live}
    cpu_d = {k: frob(cpu["grads"][k], f64_cpu["grads"][k]) for k in live}
    rel = lambda a, b: abs(a - b) / abs(b)  # noqa: E731
    step = {"loss": against_cpu(rel(card["loss"], f64_card["loss"]),
                                rel(cpu["loss"], f64_cpu["loss"]), 1e-4),
            "grads": against_cpu(max(card_d.values()), max(cpu_d.values()), 1e-3)}
    zero = max(max(card["grads"][k].abs().max().item(), cpu["grads"][k].abs().max().item())
               for k in card["grads"] if k not in live)
    kinks = {"card_flips": card["branches"].flips(f64_own["branches"]),
             "cpu_flips": cpu["branches"].flips(f64_own["branches"]),
             "worst_grad_f64_own_vs_card_branches": max(
                 frob(f64_own["grads"][k], f64_card["grads"][k]) for k in live)}
    ok = all(v["ok"] for v in step.values()) and zero <= 1e-6
    ph.emit("check", sample_step={"step": step, "worst_param": max(card_d, key=card_d.get),
                                  "zero_grads_max": zero, "kinks": kinks,
                                  "subsets_drawn": [list(i.shape) for i in card["idx"]],
                                  "within_bars": ok})
    check(ok, f"sample-loss train step on the card disagrees with the CPU: {step}, {zero}")


# The conv-formulation slice (X1-X4): the port of
# tools/bench_conv_formulations.py at inc.conv1's [8, 376, 1240, 64] -> 64 in
# bf16. Rows: (summary name = the wrapper, X number, the TPU kernel); each
# row covers the kinds of the port tool's ALL_KINDS that its wrapper runs.
XCONV_ROWS = (("conv_strip", "X4", "tools/bench_conv_formulations.py:67"),
              ("conv_strip_async", "X1", "tools/bench_conv_formulations.py:132"),
              ("conv_tile2d", "X3", "tools/bench_conv_formulations.py:393"),
              ("conv_s2d", "X2", "tools/bench_conv_formulations.py:252"))
# Each kind against its plain version on the same inputs, within one bf16
# ulp plus a float32 floor: |d| <= 2^-7 |plain| + 1e-5 (both sum exact bf16
# products in float32, in other orders, and round once; where the affine
# cancels z s against t, the sums' rounding is left as an absolute error,
# 3.8e-6 at y = 2.9e-4 in tests/test_torch_conv_formulations.py). Against
# float64 on the top XCONV_F64_ROWS rows of the first image and the bottom
# ones of the last (every column: all four edges), half an ulp of the one
# rounding plus that floor: |d| <= 2^-8 |y64| + 1e-5. The tool's max_err
# against its cuDNN yardstick, which rounds twice, within 2^-6 of max |y|.
XCONV_ULP, XCONV_HALF_ULP, XCONV_FLOOR, XCONV_TOOL_REL = 2.0 ** -7, 2.0 ** -8, 1e-5, 2.0 ** -6
XCONV_F64_ROWS = 8
XCONV_ITERS = 10  # the tool's --iters: each kind is called 2 + 3 XCONV_ITERS times


def xconv_specs(name: str) -> list:
    """The specs of the tool's ALL_KINDS that wrapper `name` runs."""
    from deepfepe_tpu_torch.tools import bench_conv_formulations as tool

    return [k for k in tool.ALL_KINDS if tool.ROUTES[k.split("_")[0]][1].__name__ == name]


def xconv_bound_ms(B: int, H: int, W: int, C: int, flop_factor: int = 1) -> tuple[float, str]:
    """Least time for the function: its useful products (2 flops a
    multiply-add, times `flop_factor`: 2 for s2d's own floor) and the affine
    and ReLU (3 an output) over the bf16 tensor-core rate, against x and y
    (bf16), w, s and t (float32) read or written once over HBM."""
    px = B * H * W
    flops = flop_factor * 2 * px * 9 * C * C + 3 * px * C
    nbytes = 2 * 2 * px * C + 4 * (9 * C * C + 2 * C)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def xconv_inputs(seed: int):
    """x [8, 376, 1240, 64] bf16 from N(0, 1), w [3, 3, 64, 64] float32 of
    scale 0.1 (the tool's), s in [0.5, 1.5) and t of scale 0.1."""
    import torch

    from deepfepe_tpu_torch.tools import bench_conv_formulations as tool

    g = torch.Generator(device="cuda").manual_seed(seed)
    kw = {"device": "cuda", "generator": g}
    x = torch.randn(tool.B, tool.H, tool.W, tool.C, **kw).to(torch.bfloat16)
    w = torch.randn(3, 3, tool.C, tool.C, **kw) * 0.1
    return x, w, torch.rand(tool.C, **kw) + 0.5, 0.1 * torch.randn(tool.C, **kw)


def xconv_f64(x, w, s, t, rows: int = XCONV_F64_ROWS):
    """The function in float64 from x's and w's bf16 values on the first
    `rows` output rows of image 0 and the last `rows` of the last image."""
    import torch
    import torch.nn.functional as F

    wd = w.bfloat16().double().permute(3, 2, 0, 1)

    def f(xs):
        z = F.conv2d(xs.double().permute(0, 3, 1, 2), wd, padding=1).permute(0, 2, 3, 1)
        return torch.relu(z * s.double() + t.double())

    return f(x[:1, :rows + 1])[:, :rows], f(x[-1:, -rows - 1:])[:, 1:]


def xconv_case(spec: str, x, w, s, t, y64, library_ms: float) -> dict:
    """One kind: its kernel against the plain version and float64, timed
    beside the plain version, with the bound."""
    import torch

    from deepfepe_tpu_torch.ops import conv_formulations as cf
    from deepfepe_tpu_torch.tools import bench_conv_formulations as tool

    f = tool.build(spec)
    plain_fn = cf.PLAIN[spec.split("_")[0].split("-")[-1]]
    R = XCONV_F64_ROWS
    with torch.no_grad():
        y = f(x, w, s, t)
        # A second call must repeat the first bit for bit (no atomics; a
        # fixed order of sums).
        same = bool(torch.equal(y, f(x, w, s, t)))
        plain = plain_fn(x, w, s, t)
        torch.cuda.synchronize()
        yf, pf = y.float(), plain.float()
        ratio = ((yf - pf).abs() / (XCONV_ULP * pf.abs() + XCONV_FLOOR)).max().item()

        def vs64(v):
            edges = (v[:1, :R].double(), v[-1:, -R:].double())
            d = max((e - r).abs().max().item() for e, r in zip(edges, y64))
            over = max(((e - r).abs() / (XCONV_HALF_ULP * r.abs() + XCONV_FLOOR)).max().item()
                       for e, r in zip(edges, y64))
            return d, over

        k64, k64_over = vs64(y)
        p64, p64_over = vs64(plain)
        errs = {"kernel_vs_plain": (yf - pf).abs().max().item(), "kernel_vs_plain_over_bar": ratio,
                "kernel_vs_f64": k64, "kernel_vs_f64_over_bar": k64_over, "plain_vs_f64": p64,
                "plain_vs_f64_over_bar": p64_over, "max_abs_y": pf.abs().max().item(),
                "relu_zero_share": (plain == 0).float().mean().item(),
                "finite": bool(torch.isfinite(yf).all()), "repeat_bit_identical": same}
        del y, plain, yf, pf
        torch.cuda.empty_cache()
        kind = spec.split("_")[0]
        bound, bound_by = xconv_bound_ms(*x.shape)
        timing = {"ms": cuda_time_ms(lambda: f(x, w, s, t), 20),
                  "plain_ms": cuda_time_ms(lambda: plain_fn(x, w, s, t), 2, warmup=1),
                  "library_ms": library_ms, "bound_ms": bound, "bound_by": bound_by}
    if kind.startswith("s2d"):
        timing["own_floor_ms"] = xconv_bound_ms(*x.shape, flop_factor=2)[0]
    ok = errs["finite"] and ratio <= 1.0 and k64_over <= 1.0 and same
    return {"spec": spec, "errors": errs, "within_bars": ok, **timing}


def phase_xconv_kernels(ph: Phases) -> list:
    """X1-X4 at inc.conv1 in bf16, every kind of the port tool, against
    their plain versions and float64, timed beside the plain version, the
    bound and cuDNN: its fused bf16 conv + bias + ReLU in one call
    (`torch.cudnn_convolution_relu`, s folded into w, so it rounds w s to
    bf16: the same function up to that rounding), and, unfused, its bf16
    conv with the affine and ReLU in place."""
    import torch
    import torch.nn.functional as F

    x, w, s, t = xconv_inputs(seed=0)
    y64 = xconv_f64(x, w, s, t)
    x_nchw = x.permute(0, 3, 1, 2)
    cl = torch.channels_last
    w_cl = w.bfloat16().permute(3, 2, 0, 1).contiguous(memory_format=cl)
    ws_cl = (w * s).bfloat16().permute(3, 2, 0, 1).contiguous(memory_format=cl)
    s4, t4, t16 = s[:, None, None], t[:, None, None], t.bfloat16()

    def unfused():
        with torch.no_grad():
            torch.relu_(F.conv2d(x_nchw, w_cl, padding=1).mul_(s4).add_(t4))

    with torch.no_grad():
        fused = torch.cudnn_convolution_relu(x_nchw, ws_cl, t16, (1, 1), (1, 1), (1, 1), 1)
        fused_err = (fused.permute(0, 2, 3, 1)[:1, :XCONV_F64_ROWS].double() - y64[0]).abs().max()
    del fused
    library_ms = cuda_time_ms(lambda: torch.cudnn_convolution_relu(
        x_nchw, ws_cl, t16, (1, 1), (1, 1), (1, 1), 1), 20)
    unfused_ms = cuda_time_ms(unfused, 20)
    conv_ms = cuda_time_ms(lambda: F.conv2d(x_nchw, w_cl, padding=1), 20)
    ph.emit("kernels", kernel="xconv_library", shape=list(x.shape), library_ms=library_ms,
            library_vs_f64=fused_err.item(), unfused_ms=unfused_ms, conv_only_ms=conv_ms)
    rows = []
    for name, xn, replaces in XCONV_ROWS:
        cases = {}
        for spec in xconv_specs(name):
            case = xconv_case(spec, x, w, s, t, y64, library_ms)
            ph.emit("kernels", kernel=name, x=xn, bars={"ulp": XCONV_ULP, "half_ulp":
                    XCONV_HALF_ULP, "floor": XCONV_FLOOR}, **case)
            check(case["within_bars"], f"{xn} {spec} is outside its bars: {case['errors']}")
            cases[spec] = case
        best = min(cases.values(), key=lambda c: c["ms"])
        rows.append({"name": name, "route": "cuda",
                     "source": "deepfepe_tpu_torch/csrc/conv_formulations.cu",
                     "replaces": replaces, "launches": None,
                     "max_abs_err": max(c["errors"]["kernel_vs_plain"] for c in cases.values()),
                     "ms": best["ms"], "kind": best["spec"], "plain_ms": best["plain_ms"],
                     "bound_ms": best["bound_ms"], "bound_by": best["bound_by"],
                     "library_ms": library_ms,
                     "library": "torch.cudnn_convolution_relu, bf16, channels-last, s folded "
                                "into w", "library_unfused_ms": unfused_ms,
                     "library_conv_only_ms": conv_ms,
                     "shape": "inc.conv1: x [8, 376, 1240, 64] -> 64, bf16",
                     "per_kind": {k: {key: c[key] for key in ("ms", "plain_ms", "bound_ms")
                                      + (("own_floor_ms",) if "own_floor_ms" in c else ())}
                                  for k, c in cases.items()}})
    del x, w, s, t, x_nchw
    torch.cuda.empty_cache()
    return rows


def phase_conv_formulations(ph: Phases) -> dict:
    """The port tool's entry point on all nine kinds at full size, with
    exact launch counts around that run alone and no error line."""
    import io

    import torch

    from deepfepe_tpu_torch.tools import bench_conv_formulations as tool

    reset_counts()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = tool.main(["--kinds=all", f"--iters={XCONV_ITERS}"])
    torch.cuda.synchronize()
    counts = read_counts()
    lines = [json.loads(ln) for ln in out.getvalue().splitlines()]
    per_kind = 2 + 3 * XCONV_ITERS  # the max_err call, timeit's warm-up, k + 2k
    want = {name: 0 for name in counts}
    for name, _, _ in XCONV_ROWS:
        want[name] = per_kind * len(xconv_specs(name))
    ref = lines[0]
    bad = [ln for ln in lines[1:] if "error" in ln
           or not ln["max_err"] <= XCONV_TOOL_REL * ref["max_abs_y"]]
    ph.emit("conv_formulations", rc=rc, lines=lines, launches=counts, expected=want,
            max_err_bar=XCONV_TOOL_REL * ref["max_abs_y"])
    check(rc == 0 and not bad and len(lines) == 1 + len(tool.ALL_KINDS),
          f"the conv-formulation tool failed (rc {rc}): {bad}")
    check(counts == want, f"conv_formulations launches {counts}, expected {want}")
    return counts


# ---------------------------------------------------------------------------
# The bf16 joint slice: the bf16 K5 and K5b (csrc/conv3x3_bf16.cu), the bf16
# SuperPoint, remat, joint training over dump trees.
# ---------------------------------------------------------------------------

# The bf16 K5 and K5b at the six layers that take them on the joint path (B
# = 8 frames; down1's two convs share a shape, both measured), with
# need_dx as the fused forward declares it.
CONV_BF16_SHAPES = (("inc.conv0", 8, 376, 1240, 1, 64, False),
                    ("inc.conv1", 8, 376, 1240, 64, 64, True),
                    ("down1.conv0", 8, 188, 620, 64, 64, True),
                    ("down1.conv1", 8, 188, 620, 64, 64, True),
                    ("down2.conv0", 8, 94, 310, 64, 128, True),
                    ("down2.conv1", 8, 94, 310, 128, 128, True))
# Bars, as X1-X4's (XCONV_*): y, dx and dw (bf16) within one ulp of the
# plain version plus a floor and within half an ulp of float64 on the same
# bf16 operands plus that floor; the floor is XCONV_FLOOR for y and, for the
# gradients, CONV_BF16_REL of their largest entry (float32 sums of up to 3.7
# M products in another order: the f32 K5b's bar); dscale and dbias
# (float32) within CONV_BF16_REL of their largest entry of the plain version
# and of float64 (the float64 formula takes the same bf16 dz). A quarter of
# the channels have scale 1 + 2^-9, where dy s rounds back to dy in bf16: a
# dz kept in float32 moves their dscale and dbias by 2^-9 relative there.
CONV_BF16_REL = 1e-4
CONV_BF16_DZ_SCALE = 1 + 2.0 ** -9
K5_BF16_KERNELS = ("k5_wgmma_kernel", "k5_cin1_kernel")
K5B_BF16_KERNELS = ("k5b_wgrad_kernel", "k5b_wgrad_cin1_kernel", "k5b_dgrad_kernel",
                    "k5b_dgrad_cin1_kernel", "sum_groups_kernel")

# joint_bf16: JOINT with model.mlp_dtype bfloat16 (the JAX CLI then builds
# SuperPointNetGauss2(dtype=bfloat16), as the JAX package trains), the conv
# switch on K5: (run, stage, SP_params.remat, steps).
JOINT_BF16_RUNS = (("stage1_none", "stage1", "none", 3), ("stage1_block", "stage1", "block", 3),
                   ("stage2_block", "stage2", "block", 3))
JOINT_BF16_PER_STEP = {
    "stage1": {"conv3x3_affine_relu_bf16": 6, "conv3x3_affine_relu_bwd_bf16": 6,
               "mutual_nn_kernel": 1, "eigh9": 5, "epi_residual": 5, "epi_residual_bwd": 5},
    "stage2": {"mutual_nn_kernel": 1, "eigh9": 5, "epi_residual": 5, "epi_residual_bwd": 5}}
# remat 'block' reruns the encoder's double-convs in the backward: K5 twice
# a layer of the six.
JOINT_BF16_BLOCK_EXTRA = {"conv3x3_affine_relu_bf16": 6}
JOINT_BF16_STEPS = 3  # bare steps a remat mode (joint_bf16_step)
# The bf16 joint run over the SuperPoint tree (kitti_sp_dump): 4 pairs a
# batch, stage 1, enough steps to wrap the train split's epoch once.
SP_TREE_JOINT_BS = 4


def conv_bf16_inputs(B, H, W, Cin, C, seed: int):
    """bf16 x (a grey image for Cin = 1, else ReLU outputs) and w (lecun
    scale), float32 s in [0.5, 1.5) with every 4th at CONV_BF16_DZ_SCALE, t
    of scale 0.1, and a bf16 cotangent dy."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    kw = {"device": "cuda", "generator": g}
    x = torch.rand(B, H, W, Cin, **kw) if Cin == 1 else torch.relu(torch.randn(B, H, W, Cin, **kw))
    w = torch.randn(3, 3, Cin, C, **kw) / (9 * Cin) ** 0.5
    s = torch.rand(C, **kw) + 0.5
    s[::4] = CONV_BF16_DZ_SCALE
    dy = torch.randn(B, H, W, C, **kw)
    return (x.bfloat16(), w.bfloat16(), s, 0.1 * torch.randn(C, **kw), dy.bfloat16())


def conv_bf16_bound_ms(B, H, W, Cin, C, backward: bool, need_dx: bool = True) -> tuple:
    """Least time for the bf16 K5 (or K5b): its products (2 flops a
    multiply-add; K5b dw's and, with need_dx, dx's) and elementwise work (the
    affine and ReLU, 3 an output; K5b's dz and affine sums, 6) over the bf16
    tensor-core rate, against the bf16 tensors read or written once (K5: x
    and y; K5b: x, y and dy read, dx written) and w, dw, s, t over HBM."""
    px = B * H * W
    macs = px * 9 * Cin * C
    if backward:
        flops = (2 if need_dx else 1) * 2 * macs + 6 * px * C
        nbytes = 2 * (px * Cin + 2 * px * C + (px * Cin if need_dx else 0)) + 4 * 9 * Cin * C \
            + 16 * C
    else:
        flops = 2 * macs + 3 * px * C
        nbytes = 2 * (px * Cin + px * C) + 2 * 9 * Cin * C + 8 * C
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return ((t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")), flops, nbytes


def over_ulp(got, want, ulp: float, floor: float) -> float:
    """max |got - want| / (ulp |want| + floor): at most 1 within the bar."""
    g, w = got.double(), want.double()
    return ((g - w).abs() / (ulp * w.abs() + floor)).max().item()


def conv_bf16_f64(x, w, s, t, y, dy, need_dx, rows: int = XCONV_F64_ROWS):
    """The bf16 K5's y (the top `rows` rows of image 0 and the bottom ones of
    the last image) and K5b's (dx on image 0's top rows, dw, dscale, dbias)
    in float64 on the same bf16 operands and the same bf16 dz."""
    import torch
    import torch.nn.functional as F

    from deepfepe_tpu_torch.ops import conv_bf16 as cb

    wd = w.double().permute(3, 2, 0, 1)

    def fwd(xs):
        z = F.conv2d(xs.double().permute(0, 3, 1, 2), wd, padding=1).permute(0, 2, 3, 1)
        return torch.relu(z * s.double() + t.double())

    y64 = (fwd(x[:1, :rows + 1])[:, :rows], fwd(x[-1:, -rows - 1:])[:, 1:])
    sd = s.double()
    safe = torch.where(sd.abs() < 1e-8, torch.ones_like(sd), sd)
    ds = db = 0.0
    dw = torch.zeros(9 * x.shape[-1] * w.shape[-1], dtype=torch.float64, device=x.device)
    for b in range(x.shape[0]):  # image by image: the float64 tensors of one image
        dz = cb.dz_bf16(y[b:b + 1], dy[b:b + 1], s).double()
        m = dz / safe
        db = db + m.sum((0, 1, 2))
        ds = ds + (m * (y[b:b + 1].double() - t.double()) / safe).sum((0, 1, 2))
        dw += torch.nn.grad.conv2d_weight(x[b:b + 1].double().permute(0, 3, 1, 2), wd.shape,
                                          dz.permute(0, 3, 1, 2), padding=1) \
            .permute(2, 3, 1, 0).reshape(-1)
        del dz, m
    dx = None
    if need_dx:
        dz = cb.dz_bf16(y[:1, :rows + 1], dy[:1, :rows + 1], s).double()
        dx = torch.nn.grad.conv2d_input((1, x.shape[-1], rows + 1, x.shape[2]), wd,
                                        dz.permute(0, 3, 1, 2), padding=1) \
            .permute(0, 2, 3, 1)[:, :rows]
    return y64, (dx, dw.view(w.shape), ds, db)


def conv_bf16_case(name, B, H, W, Cin, C, need_dx, seed) -> dict:
    """The bf16 K5 and K5b at one layer's shape against their plain versions
    and float64, K5b twice bit for bit, timed beside the plain versions,
    cuDNN and the bound."""
    import torch
    import torch.nn.functional as F

    from deepfepe_tpu_torch.ops import conv_bf16 as cb

    x, w, s, t, dy = conv_bf16_inputs(B, H, W, Cin, C, seed)
    R = XCONV_F64_ROWS
    with torch.no_grad():
        y = cb.conv3x3_affine_relu_bf16(x, w, s, t)
        plain = cb.conv3x3_affine_relu_bf16_ref(x, w, s, t)
        got = cb.conv3x3_affine_relu_bwd_bf16(x, w, s, t, y, dy, need_dx)
        again = cb.conv3x3_affine_relu_bwd_bf16(x, w, s, t, y, dy, need_dx)
        pgot = cb.conv3x3_affine_relu_bwd_bf16_ref(x, w, s, t, y, dy, need_dx)
        y64, g64 = conv_bf16_f64(x, w, s, t, y, dy, need_dx)
    torch.cuda.synchronize()
    fwd = {"kernel_vs_plain_over_bar": over_ulp(y, plain, XCONV_ULP, XCONV_FLOOR),
           "kernel_vs_f64_over_bar": max(over_ulp(e, r, XCONV_HALF_ULP, XCONV_FLOOR) for e, r in
                                         zip((y[:1, :R], y[-1:, -R:]), y64)),
           "plain_vs_f64_over_bar": max(over_ulp(e, r, XCONV_HALF_ULP, XCONV_FLOOR) for e, r in
                                        zip((plain[:1, :R], plain[-1:, -R:]), y64)),
           "kernel_vs_plain": (y.float() - plain.float()).abs().max().item(),
           "max_abs_y": plain.float().abs().max().item(),
           "equal_share": (y == plain).float().mean().item(),
           "finite": bool(torch.isfinite(y.float()).all())}
    bwd = {"repeat_bit_identical": all(torch.equal(a, b) for a, b in zip(got, again)),
           "finite": all(bool(torch.isfinite(a.float()).all()) for a in got)}
    for n, a, p, e in zip(("dx", "dw", "dscale", "dbias"), got, pgot, g64):
        if n == "dx" and not need_dx:
            bwd["dx_abs_max"] = a.float().abs().max().item()
            continue
        floor = CONV_BF16_REL * p.float().abs().max().item()
        a64 = a[:1, :R] if n == "dx" else a
        if n in ("dx", "dw"):
            bwd[n] = {"kernel_vs_plain_over_bar": over_ulp(a, p, XCONV_ULP, floor),
                      "kernel_vs_f64_over_bar": over_ulp(a64, e, XCONV_HALF_ULP, floor)}
        else:
            bwd[n] = {"kernel_vs_plain_over_bar": (a - p).abs().max().item() / floor,
                      "kernel_vs_f64_over_bar": (a.double() - e).abs().max().item() / floor}
    ok_fwd = fwd["finite"] and fwd["kernel_vs_plain_over_bar"] <= 1 \
        and fwd["kernel_vs_f64_over_bar"] <= 1
    ok_bwd = bwd["finite"] and bwd["repeat_bit_identical"] and bwd.get("dx_abs_max", 0.0) == 0.0 \
        and all(v["kernel_vs_plain_over_bar"] <= 1 and v["kernel_vs_f64_over_bar"] <= 1
                for k, v in bwd.items() if isinstance(v, dict))
    max_err = {"fwd": fwd["kernel_vs_plain"],
               "bwd": max((a.float() - p.float()).abs().max().item() for a, p in zip(got, pgot))}
    del got, again, pgot, y64, g64, plain
    torch.cuda.empty_cache()

    # cuDNN: its fused bf16 conv + bias + ReLU (s folded into w, channels
    # last), and the backward of its bf16 conv + affine + ReLU by autograd.
    cl = torch.channels_last
    x_nchw = x.permute(0, 3, 1, 2)
    ws_cl = (w.float() * s).bfloat16().permute(3, 2, 0, 1).contiguous(memory_format=cl)
    t16 = t.bfloat16()
    leaves = [a.detach().clone().requires_grad_(need_dx if j == 0 else True)
              for j, a in enumerate((x_nchw, w.permute(3, 2, 0, 1), s, t))]
    out = torch.relu(F.conv2d(leaves[0], leaves[1], padding=1) * leaves[2][:, None, None]
                     + leaves[3][:, None, None])
    dy_lib = dy.permute(0, 3, 1, 2).to(out.dtype)
    wanted = [v for v in leaves if v.requires_grad]
    iters = 10 if B * H * W > 1e6 else 40
    with torch.no_grad():
        fwd_t = {"ms": cuda_time_ms(lambda: cb.conv3x3_affine_relu_bf16(x, w, s, t), iters),
                 "plain_ms": cuda_time_ms(lambda: cb.conv3x3_affine_relu_bf16_ref(x, w, s, t),
                                          3, warmup=1),
                 "library_ms": cuda_time_ms(lambda: torch.cudnn_convolution_relu(
                     x_nchw, ws_cl, t16, (1, 1), (1, 1), (1, 1), 1), iters)}
        bwd_t = {"ms": cuda_time_ms(lambda: cb.conv3x3_affine_relu_bwd_bf16(
                     x, w, s, t, y, dy, need_dx), iters),
                 "plain_ms": cuda_time_ms(lambda: cb.conv3x3_affine_relu_bwd_bf16_ref(
                     x, w, s, t, y, dy, need_dx), 3, warmup=1)}
    bwd_t["library_ms"] = cuda_time_ms(
        lambda: torch.autograd.grad(out, wanted, dy_lib, retain_graph=True), iters)
    (fb, fby), fflops, fbytes = conv_bf16_bound_ms(B, H, W, Cin, C, False)
    (bb, bby), bflops, bbytes = conv_bf16_bound_ms(B, H, W, Cin, C, True, need_dx)
    fwd_t.update(bound_ms=fb, bound_by=fby, flops=fflops, bytes=fbytes)
    bwd_t.update(bound_ms=bb, bound_by=bby, flops=bflops, bytes=bbytes)
    del x, w, s, t, dy, y, x_nchw, ws_cl, leaves, out, dy_lib, wanted
    torch.cuda.empty_cache()
    return {"layer": name, "shape": [B, H, W, Cin, C], "need_dx": need_dx, "fwd": fwd,
            "bwd": bwd, "ok_fwd": ok_fwd, "ok_bwd": ok_bwd, "max_err": max_err,
            "fwd_t": fwd_t, "bwd_t": bwd_t}


def phase_conv_bf16_kernels(ph: Phases) -> list:
    """The bf16 K5 and K5b at the six layer shapes (`conv_bf16_case`);
    returns their two rows for the kernels line (inc.conv1 in front)."""
    from deepfepe_tpu_torch.ops import conv_bf16 as cb

    cases = {}
    for i, (name, B, H, W, Cin, C, need_dx) in enumerate(CONV_BF16_SHAPES):
        case = conv_bf16_case(name, B, H, W, Cin, C, need_dx, seed=60 + i)
        ph.emit("kernels", kernel="conv3x3_affine_relu_bf16", **case,
                bars={"ulp": XCONV_ULP, "half_ulp": XCONV_HALF_ULP, "floor": XCONV_FLOOR,
                      "grad_rel": CONV_BF16_REL},
                block=cb.fwd_layout(Cin, C) if Cin > 1 else "cin1 FFMA")
        check(case["ok_fwd"], f"bf16 K5 at {name}: outside its bars: {case['fwd']}")
        check(case["ok_bwd"], f"bf16 K5b at {name}: outside its bars: {case['bwd']}")
        cases[name] = case
    lead = cases["inc.conv1"]
    rows = []
    for kind, key, replaces, lib in (
            ("conv3x3_affine_relu_bf16", "fwd_t", "deepfepe_tpu/ops/pallas/conv_pallas.py:111",
             "torch.cudnn_convolution_relu, bf16, channels-last, s folded into w"),
            ("conv3x3_affine_relu_bwd_bf16", "bwd_t", "deepfepe_tpu/ops/pallas/conv_pallas.py:175",
             "autograd of cuDNN's bf16 F.conv2d + affine + ReLU")):
        err = "fwd" if key == "fwd_t" else "bwd"
        rows.append({"name": kind, "route": "cuda",
                     "source": "deepfepe_tpu_torch/csrc/conv3x3_bf16.cu", "replaces": replaces,
                     "launches": None,
                     "max_abs_err": max(c["max_err"][err] for c in cases.values()),
                     **{k: lead[key][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                  "library_ms")},
                     "library": lib, "shape": "inc.conv1: x [8, 376, 1240, 64] -> 64, bf16",
                     "per_layer": {n: {k: c[key][k] for k in ("ms", "plain_ms", "bound_ms",
                                                             "bound_by", "library_ms")}
                                   for n, c in cases.items()}})
    return rows


def joint_bf16_cfg(stage: str, remat: str, pretrained_sp: str, steps: int, **data):
    from deepfepe_tpu_torch.train.config import config_from_dict

    sp = {**JOINT["training"]["SP_params"], "remat": remat}
    raw = {**JOINT, "data": {**JOINT["data"], **data},
           "model": {**JOINT["model"], "mlp_dtype": "bfloat16"},
           "training": {**JOINT["training"], "train_SP": stage == "stage2",
                        "pretrained_SP": pretrained_sp, "train_iter": steps, "SP_params": sp}}
    return config_from_dict(raw)


def joint_bf16_expected(stage: str, remat: str, steps: int, counts: dict) -> dict:
    per = dict(JOINT_BF16_PER_STEP[stage])
    if stage == "stage1" and remat != "none":
        for k, v in JOINT_BF16_BLOCK_EXTRA.items():
            per[k] = per.get(k, 0) + v
    return {k: steps * per.get(k, 0) for k in counts}


def phase_joint_bf16(ph: Phases) -> dict:
    """The port's train_good with model.if_SP and model.mlp_dtype bfloat16
    (the bf16 SuperPoint) at the production point, for each of
    JOINT_BF16_RUNS, from val_feature (b)'s gauss2 `.pth.tar`; launches read
    around each run alone. Returns the sums."""
    import numpy as np
    import torch

    from deepfepe_tpu_torch import cli

    pretrained = vf_pretrained("b")
    before = torch.load(pretrained, weights_only=True)["model_state_dict"]
    total = dict.fromkeys(kernel_counters(), 0)
    for run, stage, remat, steps in JOINT_BF16_RUNS:
        exp = f"smoke_joint_bf16_{run}"
        shutil.rmtree(os.path.join(REPO, "logs", exp), ignore_errors=True)
        reset_counts()
        with conv_switch("pallas"):
            last = cli.train_good(joint_bf16_cfg(stage, remat, pretrained, steps), exp,
                                  device="cuda")
        torch.cuda.synchronize()
        counts = read_counts()
        expected = joint_bf16_expected(stage, remat, steps, counts)
        after = torch.load(os.path.join("logs", exp, "checkpoints",
                                        f"superPointNet_{steps}_checkpoint.pth.tar"),
                           weights_only=True)["model_state_dict"]
        moved = {k for k, v in after.items() if not torch.equal(v, before[k])}
        buffers = {k for k in after if "running_" in k}
        f32 = all(v.dtype == torch.float32 for v in after.values() if v.is_floating_point())
        ph.emit("joint_bf16", run=run, stage=stage, remat=remat, steps=steps, last=last,
                launches=counts, expected_launches=expected, sp_tensors_moved=len(moved),
                bn_buffers_moved=len(moved & buffers), bn_buffers=len(buffers),
                checkpoint_float32=f32, ms_per_step_fit=last["wall_s"] * 1e3 / steps,
                timed="host clock over the CLI's loop (ending in a synchronize)")
        check(counts == expected, f"joint_bf16 {run}: launches {counts}, expected {expected}")
        check(last["n_iter"] == steps, f"joint_bf16 {run}: ended at {last['n_iter']}")
        check(all(np.isfinite(v) for v in last.values()), f"joint_bf16 {run}: non-finite {last}")
        check(last["skipped_update"] == 0.0, f"joint_bf16 {run}: the last update was skipped")
        check(f32, f"joint_bf16 {run}: the SuperPoint checkpoint is not float32")
        if stage == "stage1":
            check(not moved, f"joint_bf16 {run}: the frozen SuperPoint moved: {sorted(moved)[:5]}")
        else:
            check(buffers <= moved, f"joint_bf16 {run}: not every BN buffer moved")
        for k, v in counts.items():
            total[k] += v
    return total


def hold_conv_call(c: dict) -> dict:
    """One recorded bf16 K5/K5b call of a step against the plain versions on
    its own inputs and cotangent, at the kernels phase's bars."""
    import torch

    from deepfepe_tpu_torch.ops import conv_bf16 as cb

    x, w, s, t = c["x"], c["w"], c["scale"], c["bias"]
    with torch.no_grad():
        y = cb.conv3x3_affine_relu_bf16_ref(x, w, s, t)
        grads = cb.conv3x3_affine_relu_bwd_bf16_ref(x, w, s, t, c["y"], c["dy"], c["need_dx"])
    r = {"shape": list(x.shape[:3]) + [x.shape[3], w.shape[-1]],
         "y": over_ulp(c["y"], y, XCONV_ULP, XCONV_FLOOR)}
    for n, p in zip(("dx", "dw", "dscale", "dbias"), grads):
        floor = CONV_BF16_REL * p.float().abs().max().item() + 1e-30
        r[n] = (over_ulp(c[n], p, XCONV_ULP, floor) if n in ("dx", "dw")
                else (c[n] - p).abs().max().item() / floor)
    return r


def phase_joint_bf16_step(ph: Phases) -> None:
    """Bare stage-1 bf16 joint steps (batches on the card up front) with
    remat 'none' and 'block': ms a step and peak device memory; one
    profiled 'none' step (busy share, K5 and K5b device ms) whose every K5
    and K5b call is held against the plain versions; then the SuperPoint
    gradients of the step's own frames and cotangents, under 'none' and
    'block', bit for bit. After the counted runs, before the checks."""
    import statistics

    import torch

    from deepfepe_tpu_torch.frontend import frontend_params_from_config, pipeline
    from deepfepe_tpu_torch.frontend.sp_fused import superpoint_forward_fused
    from deepfepe_tpu_torch.loader import model_loader
    from deepfepe_tpu_torch.ops import conv as conv_mod
    from deepfepe_tpu_torch.train.joint import joint_train_step, make_joint_state
    from deepfepe_tpu_torch.utils.weights import load_superpoint

    dev = torch.device("cuda")
    pretrained = vf_pretrained("b")
    steps = JOINT_BF16_STEPS
    batches = None
    readings = {}
    captured = {}
    for remat in ("none", "block"):
        cfg = joint_bf16_cfg("stage1", remat, pretrained, steps)
        if batches is None:
            batches = joint_batches(cfg, steps + 1, dev)
        fp = frontend_params_from_config(cfg)
        sp = load_superpoint(pretrained, dev, dtype=torch.bfloat16)
        state = make_joint_state(model_loader(cfg, dev, torch.Generator().manual_seed(0),
                                              train=True), sp, cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        ms = []
        with conv_switch("pallas"):
            for b in batches[:steps]:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                m = joint_train_step(state, b, fp, cfg, 0.1, 0.5, train_sp=False)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                check(bool(torch.isfinite(m["loss"])) and float(m["skipped_update"]) == 0.0,
                      f"joint_bf16_step {remat}: loss {float(m['loss'])}, skipped "
                      f"{float(m['skipped_update'])}")
        peak = torch.cuda.max_memory_allocated(dev)
        readings[remat] = {"step_ms": ms, "median_step_ms_after_first": statistics.median(ms[1:]),
                           "peak_mb": peak / 2 ** 20, "peak_above_start_mb": (peak - base) / 2 ** 20}
        if remat == "none":
            real = pipeline.superpoint_forward_fused

            def capture(net, x, conv_impl=None, remat="none"):
                out = real(net, x, conv_impl, remat)
                for k in ("semi", "desc"):
                    out[k].retain_grad()
                captured.update(x=x, out=out)
                return out

            trace = os.path.join("logs", "smoke_joint_bf16_profile", "trace.json")
            os.makedirs(os.path.dirname(trace), exist_ok=True)
            acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            pipeline.superpoint_forward_fused = capture
            try:
                with conv_switch("pallas"), conv_mod.record_calls() as calls, \
                        torch.profiler.profile(activities=acts) as prof:
                    joint_train_step(state, batches[steps], fp, cfg, 0.1, 0.5, train_sp=False)
                    torch.cuda.synchronize()
            finally:
                pipeline.superpoint_forward_fused = real
            prof.export_chrome_trace(trace)
            tr = read_trace(trace)
            held = [hold_conv_call(c) for c in calls]
            worst = {k: max(h[k] for h in held) for k in ("y", "dx", "dw", "dscale", "dbias")}
            readings[remat].update(
                profiled_step=tr, k5_device_ms=device_ms(trace, K5_BF16_KERNELS),
                k5b_device_ms=device_ms(trace, K5B_BF16_KERNELS), calls=len(calls),
                calls_over_bar_worst=worst)
            check(len(calls) == 6 and all("dy" in c for c in calls),
                  f"joint_bf16_step: {len(calls)} recorded K5 calls, expected 6 with a backward")
            check(all(v <= 1.0 for v in worst.values()),
                  f"joint_bf16_step: a K5/K5b call is outside its bars: {worst}")
            cot = {k: captured["out"][k].grad.detach().clone() for k in ("semi", "desc")}
            frames = captured["x"].detach()
        del state
        torch.cuda.empty_cache()

    # The SuperPoint gradients of the profiled step's frames and cotangents,
    # without and with remat: K5b's fixed-order sums, and cuDNN held to its
    # deterministic algorithms for the plain layers.
    sp = load_superpoint(pretrained, dev, dtype=torch.bfloat16)
    params = [p for p in sp.parameters()]
    grads = {}
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with conv_switch("pallas"):
            for remat in ("none", "block", "none_again"):
                out = superpoint_forward_fused(sp, frames, "pallas", remat.split("_")[0])
                grads[remat] = torch.autograd.grad([out["semi"], out["desc"]], params,
                                                   [cot["semi"], cot["desc"]],
                                                   allow_unused=True)
    finally:
        torch.backends.cudnn.deterministic = saved
    same = lambda a, b: all((x is None and y is None) or torch.equal(x, y)  # noqa: E731
                            for x, y in zip(a, b))
    rep, blk = same(grads["none"], grads["none_again"]), same(grads["none"], grads["block"])
    ph.emit("joint_bf16_step", readings=readings, remat_grads_bit_equal=blk,
            repeat_grads_bit_equal=rep,
            peak_mb_block_over_none=readings["block"]["peak_above_start_mb"]
            / readings["none"]["peak_above_start_mb"],
            timed="host clock between synchronizes, batches on the card up front; peak "
                  "memory by torch.cuda.max_memory_allocated over the bare steps")
    check(rep, "joint_bf16_step: two 'none' SuperPoint backwards differ")
    check(blk, "joint_bf16_step: 'block' SuperPoint gradients differ from 'none'")


# ---------------------------------------------------------------------------
# The dump-tree slice: the correspondence loader, eval's five-point baseline
# and npz dumps, the SuperPoint dump writer.
# ---------------------------------------------------------------------------

# configs/kitti_corr_baseline.yaml and kitti_corr_baselineEval.yaml, built
# in code (no YAML reader needed); data.dump_root points at the smoke's
# tree, and training takes the fused MLP.
KITTI_CORR = {
    "name": "kitti_odo_good_corr",
    "data": {"dataset": "kitti_odo_corr", "sequence_length": 2, "delta_ij": 1, "batch_size": 8,
             "good_num": 1000, "read_what": {"with_quality": True, "with_pose": True},
             "image": {"size": [376, 1241, 3]}, "preprocessing": {"resize": [376, 1240]}},
    "model": {"name": "GoodCorresNet_layers_deepF", "depth": 5, "clamp_at": 0.02,
              "if_quality": False, "quality_size": 0, "if_learn_offsets": False,
              "if_tri_depth": False, "if_qt_loss": False, "if_sample_loss": False,
              "if_SP": False, "balance_q": 1, "balance_t": 0.1, "use_pallas_mlp": True},
    "exps": {"five_point": False, "base_name": "ransac_8p", "our_name": "DeepF",
             "filename": "err_ratio.npz"},
    "training": {"reproduce": False, "learning_rate": 0.0001, "lr_decay_step": 10,
                 "lr_decay_rate": 1, "clamp_iter1": 3000, "clamp_iter2": 6000,
                 "clamp_q_params": [0.1, 0.01, 0.001], "clamp_t_params": [0.5, 0.3, 0.1],
                 "seed": 0, "train_iter": 100000, "val_interval": 200, "val_batches": 10,
                 "save_interval": 200, "retrain": True, "train": True, "pretrained": ""},
}
KITTI_EVAL = {
    "name": "kitti_odo_good_corr_eval",
    "data": {"dataset": "kitti_odo_corr", "batch_size": 8, "good_num": 1000,
             "image": {"size": [376, 1241, 3]}, "preprocessing": {"resize": [376, 1240]}},
    "model": {"name": "GoodCorresNet_layers_deepF", "depth": 5, "clamp_at": 0.02,
              "if_quality": False},
    "exps": {"base_name": "ransac_8p", "our_name": "DeepF", "filename": "err_ratio.npz"},
    "training": {"reproduce": True, "train_iter": 0, "train": False, "retrain": False,
                 "val_interval": 1, "val_batches": -1, "seed": 0},
}
# The correspondence tree: two scenes of 11 frames (20 pairs: two train
# batches an epoch, the tail of 4 dropped; three eval batches, the last
# padded), 1,200 matches a pair cut to good_num 1,000, 0.5 px of noise, 15%
# outliers, KITTI's intrinsics and cam0 -> cam2 offset.
KITTI_TREE = {"scenes": 2, "frames": 11, "matches": 1200, "noise_px": 0.5,
              "outlier_frac": 0.15, "seed": 0}
KITTI_TRAIN_STEPS = 5  # 2.5 epochs
KITTI_PAIRS = KITTI_TREE["scenes"] * (KITTI_TREE["frames"] - 1)
# Per eval batch, with either baseline: five weighted 8-point fits, the
# baseline's hypotheses (one eigh batch: the 8-point fits, or the five-
# point null spaces) and its refit; K3 four times in DeepFNet and once in
# the F-loss. Per train step: eigh9, K2, K2b, K3 and its backward depth
# times each.
KITTI_EVAL_PER_BATCH = {"eigh9": 7, "epi_residual": 5}
KITTI_TRAIN_PER_STEP = {"eigh9": 5, "mlp_forward": 5, "mlp_backward": 5, "epi_residual": 5,
                        "epi_residual_bwd": 5}
# The SuperPoint tree: two scenes of a SyntheticImageSequence at 376x1240,
# 20 frames each, written as PNG, dumped with a seeded SuperPointNet, K =
# 1000, the conv switch on K5 (six layers of >= 16,384 px a frame) and K4
# on each pair's [1, K_pad, 256] descriptors.
SP_TREE = {"scenes": 2, "frames": 20, "image_size": (376, 1240), "focal": 718.856,
           "n_corners": 400, "K": 1000}
SP_DUMP_PER_FRAME = {"conv3x3_affine_relu": 6}
SP_DUMP_PER_PAIR = {"mutual_nn_kernel": 1}
SP_VF_BATCHES = 5  # val_feature's default: 5 batches of 8 pairs (the last short)
# The committed image fixtures (tests/fixtures/image_io/make_fixtures.py
# writes them with cv2 beside their cv2 grey decodes); a quality-95 round
# trip of the smooth 376x1240 fixture stays within a few grey levels.
FIXTURES = os.path.join(REPO, "tests", "fixtures", "image_io")
JPEG_ROUND_TRIP = {"max": 8, "mean": 1.0}


def expect(per: dict, n: int, keys) -> dict:
    return {k: per.get(k, 0) * n for k in keys}


def read_npz_dumps(exp: str, pairs: int) -> dict:
    """Both npz dumps of an eval_good run read back: the reference keys and
    one row a pair."""
    import numpy as np

    keys = {"err_q", "err_t", "epi_dists", "relative_poses_cam", "relative_poses_body"}
    out = {}
    for name in ("DeepF", "ransac_8p"):
        path = os.path.join("logs", exp, f"{name}_err_ratio.npz")
        check(os.path.exists(path), f"{exp}: no {path}")
        z = np.load(path)
        check(set(z.files) == keys, f"{path}: keys {sorted(z.files)}")
        check(all(len(z[k]) == pairs for k in keys), f"{path}: rows "
              f"{[len(z[k]) for k in sorted(keys)]}, expected {pairs}")
        check(all(np.isfinite(z[k]).all() for k in keys), f"{path}: non-finite entries")
        out[name] = {k: list(z[k].shape) for k in sorted(keys)}
    return out


def eval_batch_trace(cfg, net, batch, path: str) -> dict:
    """One eval batch (solver, val_rt with the config's baseline) under
    torch.profiler after a warm-up call: the device's busy share and top
    kernels (`read_trace`), and the batch's host ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from deepfepe_tpu_torch import cli

    dev = torch.device("cuda")
    cli.evaluate(cfg, net, [batch], dev, generator=torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        cli.evaluate(cfg, net, [batch], dev, generator=torch.Generator().manual_seed(0))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    return {"batch_ms": ms, **read_trace(path)}


def loader_ms(ds, batch_size: int, n: int = 2) -> float:
    """Host ms a batch of the dataset's in-order pass (files read, pairs
    cropped, virtual points), over its first `n` batches."""
    import itertools

    t0 = time.perf_counter()
    got = list(itertools.islice(ds.batches(batch_size, shuffle=False), n))
    return (time.perf_counter() - t0) * 1e3 / len(got)


def phase_kitti_corr(ph: Phases) -> dict:
    """train_good and eval_good (both baselines) on a correspondence dump at
    the paper's KITTI point; launches read around each run alone. Returns
    their sums."""
    import tempfile

    import numpy as np
    import torch

    from deepfepe_tpu_torch import cli
    from deepfepe_tpu_torch.data.native_loader import native_available
    from deepfepe_tpu_torch.data.synthetic_dump import write_corr_dump
    from deepfepe_tpu_torch.train.config import config_from_dict

    check(native_available(), "the native npy loader did not build (g++)")
    total = dict.fromkeys(kernel_counters(), 0)
    with tempfile.TemporaryDirectory(prefix="smoke_kitti_") as root:
        t0 = time.perf_counter()
        write_corr_dump(root, **KITTI_TREE)
        ph.emit("kitti_corr", tree=KITTI_TREE, pairs=KITTI_PAIRS, native_loader=True,
                write_s=time.perf_counter() - t0)
        for exp in ("smoke_kitti_train", "smoke_kitti_eval_8p", "smoke_kitti_eval_5p"):
            shutil.rmtree(os.path.join(REPO, "logs", exp), ignore_errors=True)
        raw = {**KITTI_CORR, "data": {**KITTI_CORR["data"], "dump_root": root}}
        cfg = config_from_dict(raw)
        reset_counts()
        last = cli.train_good(cfg, "smoke_kitti_train", train_iter=KITTI_TRAIN_STEPS,
                              device="cuda")
        torch.cuda.synchronize()
        counts = read_counts()
        expected = expect(KITTI_TRAIN_PER_STEP, KITTI_TRAIN_STEPS, counts)
        ms = last["wall_s"] * 1e3 / KITTI_TRAIN_STEPS
        ph.emit("kitti_corr", run="train_good", steps=KITTI_TRAIN_STEPS, last=last,
                launches=counts, expected_launches=expected,
                launches_per_step={k: v / KITTI_TRAIN_STEPS for k, v in counts.items() if v},
                ms_per_step=ms, pairs_per_s=cfg.data.batch_size * 1e3 / ms,
                timed="host clock over fit (ending in a synchronize), batches read from the "
                      "tree by the prefetch thread")
        check(counts == expected, f"kitti train_good: launches {counts}, expected {expected}")
        check(last["n_iter"] == KITTI_TRAIN_STEPS, f"kitti train_good ended at {last['n_iter']}")
        check(all(np.isfinite(v) for v in last.values()), f"kitti train_good: non-finite {last}")
        check(last["nonfinite"] == 0.0, "kitti train_good: a step had a non-finite loss")
        for k, v in counts.items():
            total[k] += v
        ckpt = os.path.join("logs", "smoke_kitti_train", "checkpoints",
                            f"deepFNet_{KITTI_TRAIN_STEPS}_checkpoint.pth.tar")
        batches = -(-KITTI_PAIRS // KITTI_EVAL["data"]["batch_size"])
        for five, exp in ((False, "smoke_kitti_eval_8p"), (True, "smoke_kitti_eval_5p")):
            raw = {**KITTI_EVAL, "data": {**KITTI_EVAL["data"], "dump_root": root},
                   "exps": {**KITTI_EVAL["exps"], "five_point": five}}
            reset_counts()
            summary = cli.eval_good(config_from_dict(raw), 0, device="cuda", pretrained=ckpt,
                                    exper_name=exp)
            torch.cuda.synchronize()
            counts = read_counts()
            expected = expect(KITTI_EVAL_PER_BATCH, batches, counts)
            dumps = read_npz_dumps(exp, KITTI_PAIRS)
            ph.emit("kitti_corr", run="eval_good", five_point=five, summary=summary,
                    batches=batches, launches=counts, expected_launches=expected,
                    launches_per_batch={k: v / batches for k, v in counts.items() if v},
                    pairs_per_s=summary["pairs"] / summary["seconds"], npz=dumps,
                    timed="host clock over the solver and its evaluation, ending in a "
                          "synchronize; data read up front")
            check(counts == expected, f"kitti eval_good (five_point {five}): launches {counts}, "
                  f"expected {expected}")
            check(summary["pairs"] == KITTI_PAIRS, f"kitti eval_good: {summary['pairs']} pairs")
            check(all(np.isfinite(v) for v in summary.values() if isinstance(v, float)),
                  f"kitti eval_good: non-finite summary {summary}")
            check(summary["median_err_q_gt"] < 1e-3,
                  f"kitti eval_good: median_err_q_gt {summary['median_err_q_gt']} >= 1e-3 deg")
            check(summary["median_err_q_base"] < 0.5, f"kitti eval_good (five_point {five}): "
                  f"median_err_q_base {summary['median_err_q_base']} >= 0.5 deg")
            for k, v in counts.items():
                total[k] += v
        # After the counted runs: the data layer's host ms a batch, and one
        # profiled eval batch with each baseline.
        from deepfepe_tpu_torch.loader import data_loader, model_loader
        from deepfepe_tpu_torch.train import load_checkpoint

        ecfg = config_from_dict({**KITTI_EVAL, "data": {**KITTI_EVAL["data"], "dump_root": root}})
        ds = data_loader(ecfg, "test")
        host_ms = loader_ms(ds, ecfg.data.batch_size)
        batch = next(ds.batches(ecfg.data.batch_size, shuffle=False))
        net = model_loader(ecfg, torch.device("cuda"), torch.Generator().manual_seed(0))
        load_checkpoint(ckpt, net)
        traces, fresh = {}, []
        for five in (False, True):
            ecfg.exps.five_point = five
            name = "five_point" if five else "eight_point"
            path = os.path.join("logs", "smoke_kitti_trace", f"eval_{five}.json")
            traces[name] = eval_batch_trace(ecfg, net, batch, path)
            if lost(traces[name]["device_events"] == 0):
                traces[name] = fresh_window("kitti_eval", root, ckpt, five, path)
                fresh.append(name)
        ph.emit("kitti_corr", loader_ms_per_batch=host_ms, eval_batch_traces=traces,
                fresh_process=fresh)
        for name, tr in traces.items():
            check(tr["device_events"] > 0, f"kitti {name} eval batch trace has no device events")
    return total


def decode_ms(path: str, reps: int = 20) -> float:
    """Host ms to decode one JPEG file from memory (the native decoder),
    the median of `reps` decodes after one warm-up."""
    import statistics

    from deepfepe_tpu_torch.utils.jpeg import read_jpeg_grey

    with open(path, "rb") as f:
        data = f.read()
    read_jpeg_grey(data)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        read_jpeg_grey(data)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def fixture_pairs() -> list:
    """(file, its committed cv2 grey decode) of tests/fixtures/image_io."""
    return sorted((p, os.path.join(FIXTURES, os.path.basename(p).split(".")[0] + ".grey.png"))
                  for p in glob.glob(os.path.join(FIXTURES, "*"))
                  if p.endswith((".jpg", ".png")) and not p.endswith(".grey.png"))


def phase_jpeg(ph: Phases) -> None:
    """The native image codec built by g++ on this machine: every committed
    fixture (JPEG in each form the decoder covers, PNG forms) decoded equal
    to its committed cv2 decode, bit for bit; the decoder's and encoder's
    host ms at 376x1240 (one thread, and 8 frames in 4 threads); the
    encoder's bytes deterministic and decoded back within JPEG_ROUND_TRIP."""
    from concurrent.futures import ThreadPoolExecutor as Pool

    import numpy as np

    from deepfepe_tpu_torch.utils import image_io, jpeg

    fresh = not jpeg.library_path().exists()
    t0 = time.perf_counter()
    jpeg.build()
    build_s = time.perf_counter() - t0
    pairs = fixture_pairs()
    results = {}
    for src, truth in pairs:
        got, want = image_io.read_grey(src), image_io.read_png(truth)
        results[os.path.basename(src)] = bool(got.shape == want.shape
                                             and np.array_equal(got, want))
    big = os.path.join(FIXTURES, "kitti_grey_q95.jpg")
    frame = jpeg.read_jpeg_grey(big)
    enc = jpeg.encode_jpeg_grey(frame)
    back = jpeg.read_jpeg_grey(enc)
    err = np.abs(back.astype(int) - frame.astype(int))
    times = []
    for _ in range(5):
        t = time.perf_counter()
        jpeg.encode_jpeg_grey(frame)
        times.append((time.perf_counter() - t) * 1e3)
    with open(big, "rb") as f:
        data = f.read()
    with Pool(4) as pool:
        list(pool.map(jpeg.read_jpeg_grey, [data] * 4))
        t = time.perf_counter()
        outs = list(pool.map(jpeg.read_jpeg_grey, [data] * 8))
        threaded = (time.perf_counter() - t) * 1e3 / 8
    ph.emit("jpeg", library=os.path.basename(str(jpeg.library_path())), built_here=fresh,
            build_s=build_s, fixtures=results, image_size=frame.shape,
            decode_ms_376x1240=decode_ms(big), decode_ms_a_frame_4_threads=threaded,
            encode_ms_376x1240=sorted(times)[2], round_trip_max_err=int(err.max()),
            round_trip_mean_err=float(err.mean()),
            timed="host clock: the median of 20 decodes (5 encodes) from memory; threads: 8 "
                  "decodes of the same frame in 4 threads, wall ms over 8")
    check(len(pairs) >= 12 and all(results.values()), f"jpeg: fixtures {results}")
    check(all(np.array_equal(o, frame) for o in outs), "jpeg: a threaded decode differs")
    check(jpeg.encode_jpeg_grey(frame) == enc, "jpeg: the encoder's bytes are not deterministic")
    check(err.max() <= JPEG_ROUND_TRIP["max"] and err.mean() <= JPEG_ROUND_TRIP["mean"],
          f"jpeg: round trip at quality 95 off by {err.max()} (mean {err.mean()})")


def write_sp_frames(root: str) -> list:
    """Two SyntheticImageSequence scenes as PNG frames; returns (files,
    poses, K) a scene."""
    import numpy as np

    from deepfepe_tpu_torch.data import SyntheticImageSequence
    from deepfepe_tpu_torch.utils.image_io import write_png

    scenes = []
    for s in range(SP_TREE["scenes"]):
        seq = SyntheticImageSequence(n_frames=SP_TREE["frames"], image_size=SP_TREE["image_size"],
                                     focal=SP_TREE["focal"], n_corners=SP_TREE["n_corners"],
                                     seed=s)
        files = []
        for k in range(seq.n_frames):
            files.append(os.path.join(root, "frames", f"{s:02d}_{k:06d}.png"))
            os.makedirs(os.path.dirname(files[-1]), exist_ok=True)
            write_png(files[-1], np.rint(seq.frame(k) * 255).astype(np.uint8))
        scenes.append((files, seq.cam2world_poses(), seq.K))
    return scenes


def phase_kitti_sp_dump(ph: Phases) -> dict:
    """The SuperPoint dump of rendered frames, then val_feature --config and
    eval_good over the tree with its frames; launches read around each run
    alone. Returns their sums."""
    import tempfile

    import numpy as np
    import torch

    from deepfepe_tpu_torch import cli
    from deepfepe_tpu_torch.data.dump_kitti import dump_sequence_sp
    from deepfepe_tpu_torch.frontend import SuperPointNet
    from deepfepe_tpu_torch.frontend.superpoint import reset_superpoint
    from deepfepe_tpu_torch.train.config import config_from_dict

    total = dict.fromkeys(kernel_counters(), 0)
    H, W = SP_TREE["image_size"]
    n_frames = SP_TREE["scenes"] * SP_TREE["frames"]
    n_pairs = SP_TREE["scenes"] * (SP_TREE["frames"] - 1)
    with tempfile.TemporaryDirectory(prefix="smoke_sp_") as root:
        t0 = time.perf_counter()
        scenes = write_sp_frames(root)
        render_s = time.perf_counter() - t0
        net = reset_superpoint(SuperPointNet(), torch.Generator().manual_seed(0))
        net = net.eval().to("cuda")
        reset_counts()
        t0 = time.perf_counter()
        for s, (files, poses, K) in enumerate(scenes):
            dump_sequence_sp(files, poses, K, os.path.join(root, "tree", f"{s:02d}"), net,
                             out_num_points=SP_TREE["K"], conv_impl="pallas")
        torch.cuda.synchronize()
        dump_s = time.perf_counter() - t0
        counts = read_counts()
        expected = {k: SP_DUMP_PER_FRAME.get(k, 0) * n_frames + SP_DUMP_PER_PAIR.get(k, 0) * n_pairs
                    for k in counts}
        rows = [len(np.load(os.path.join(root, "tree", f"{s:02d}",
                                          f"ij_match_quality_{i}-{i + 1}_good.npy")))
                for s in range(SP_TREE["scenes"]) for i in range(SP_TREE["frames"] - 1)]
        ph.emit("kitti_sp_dump", run="dump_sequence_sp", tree=SP_TREE, frames=n_frames,
                pairs=n_pairs, render_s=render_s, dump_s=dump_s, frames_per_s=n_frames / dump_s,
                launches=counts, expected_launches=expected, matches_per_pair=[min(rows),
                                                                              max(rows)],
                timed="host clock over dump_sequence_sp (PNG reads and writes, SuperPoint, "
                      "matching, .npy writes), ending in a synchronize")
        check(counts == expected, f"SP dump: launches {counts}, expected {expected}")
        check(min(rows) >= 8, f"SP dump: a pair with {min(rows)} matches")
        for k, v in counts.items():
            total[k] += v
        tree_frames = sorted(glob.glob(os.path.join(root, "tree", "*", "*.jpg")))
        check(len(tree_frames) == n_frames and not glob.glob(os.path.join(root, "tree", "*",
                                                                          "*.png")),
              f"SP dump: {len(tree_frames)} .jpg frames in the tree, {n_frames} expected")
        ph.emit("kitti_sp_dump", frames="%06d.jpg", tree_frames=len(tree_frames),
                jpeg_bytes_a_frame=os.path.getsize(tree_frames[0]),
                decode_ms_a_frame=decode_ms(tree_frames[0]), image_size=SP_TREE["image_size"],
                timed="host clock, the median of 20 decodes of one tree frame from memory")

        cfg = config_from_dict({**KITTI_EVAL, "data": {
            **KITTI_EVAL["data"], "dump_root": os.path.join(root, "tree"), "with_imgs": True,
            "image": {"size": [H, W, 1]}, "preprocessing": {"resize": [H, W]}}})
        reset_counts()
        summary = cli.val_feature("smoke_sp_vf", config=cfg, fp=vf_params(), device="cuda")
        torch.cuda.synchronize()
        counts = read_counts()
        expected = {k: SP_VF_BATCHES * VF_PER_BATCH["b"].get(k, 0) for k in counts}
        ratios = [summary[f"ratio@{t}"] for t in (0.1, 0.5, 1.0, 2.0)]
        ph.emit("kitti_sp_dump", run="val_feature --config", summary=summary, launches=counts,
                expected_launches=expected, pairs_per_s=summary["pairs"] / summary["seconds"])
        check(counts == expected, f"SP tree val_feature: launches {counts}, expected {expected}")
        check(summary["pairs"] == min(n_pairs, SP_VF_BATCHES * 8),
              f"SP tree val_feature: {summary['pairs']} pairs")
        check(np.isfinite(summary["num_matches"]) and 0 < summary["num_matches"] <= VF_K,
              f"SP tree val_feature: num_matches {summary['num_matches']}")
        check(all(0 <= a <= b <= 1 for a, b in zip(ratios, ratios[1:])),
              f"SP tree val_feature: ratios not in [0, 1] and rising: {ratios}")
        for k, v in counts.items():
            total[k] += v

        reset_counts()
        summary = cli.eval_good(cfg, 0, device="cuda", exper_name="smoke_sp_eval")
        torch.cuda.synchronize()
        counts = read_counts()
        batches = -(-n_pairs // cfg.data.batch_size)
        expected = expect(KITTI_EVAL_PER_BATCH, batches, counts)
        dumps = read_npz_dumps("smoke_sp_eval", n_pairs)
        ph.emit("kitti_sp_dump", run="eval_good", summary=summary, batches=batches,
                launches=counts, expected_launches=expected,
                pairs_per_s=summary["pairs"] / summary["seconds"], npz=dumps)
        check(counts == expected, f"SP tree eval_good: launches {counts}, expected {expected}")
        check(summary["pairs"] == n_pairs, f"SP tree eval_good: {summary['pairs']} pairs")
        check(all(np.isfinite(v) for v in summary.values() if isinstance(v, float)),
              f"SP tree eval_good: non-finite summary {summary}")
        # The gt sanity bar at float32's acos floor near 0 (~0.03 deg): this
        # sequence turns 0.6 deg at most a frame, and rounding of its gt
        # rotations lands most pairs just off 0.
        check(summary["median_err_q_gt"] < 0.05,
              f"SP tree eval_good: median_err_q_gt {summary['median_err_q_gt']} >= 0.05 deg")
        for k, v in counts.items():
            total[k] += v
        ph.emit("kitti_sp_dump", frames="jpg", loader_ms_per_batch_with_frames=loader_ms(
            cli.data_loader(cfg, "test"), cfg.data.batch_size))

        # bf16 joint training over the tree, stage 1 with the conv switch on
        # K5: one batch drawn first, then the epochs, as the JAX CLI walks
        # them; one step past the first full pass.
        jcfg = joint_bf16_cfg("stage1", "none", vf_pretrained("b"), 1,
                              **{**KITTI_EVAL["data"], "dump_root": os.path.join(root, "tree"),
                                 "batch_size": SP_TREE_JOINT_BS, "image": {"size": [H, W, 1]},
                                 "preprocessing": {"resize": [H, W]}})
        per_pass = len(cli.data_loader(jcfg, "train")) // SP_TREE_JOINT_BS
        steps = jcfg.training.train_iter = per_pass + 1
        seen = []
        real_step = cli.joint_train_step

        def step(state, batch, *a, **k):
            seen.append(batch["frame_ids"].cpu().numpy().tolist())
            return real_step(state, batch, *a, **k)

        exp = "smoke_sp_joint_bf16"
        shutil.rmtree(os.path.join(REPO, "logs", exp), ignore_errors=True)
        reset_counts()
        cli.joint_train_step = step
        try:
            with conv_switch("pallas"):
                t0 = time.perf_counter()
                last = cli.train_good(jcfg, exp, device="cuda")
                torch.cuda.synchronize()
                joint_s = time.perf_counter() - t0
        finally:
            cli.joint_train_step = real_step
        counts = read_counts()
        expected = joint_bf16_expected("stage1", "none", steps, counts)
        ph.emit("kitti_sp_dump", run="train_good if_SP bf16", steps=steps,
                batches_a_pass=per_pass, last=last, launches=counts,
                expected_launches=expected, ms_per_step_fit=joint_s * 1e3 / steps,
                first_batches=seen[:2], wrapped_batch=seen[-1])
        check(counts == expected, f"SP tree joint: launches {counts}, expected {expected}")
        check(len(seen) == steps and per_pass >= 1, f"SP tree joint: {len(seen)} steps")
        check(all(np.isfinite(v) for v in last.values()), f"SP tree joint: non-finite {last}")
        check(last["skipped_update"] == 0.0, "SP tree joint: the last update was skipped")
        for k, v in counts.items():
            total[k] += v

        # The same tree with its frames as lossless PNG (the JPEG decodes),
        # for the loader's PNG figure beside the JPEG one.
        from deepfepe_tpu_torch.utils.image_io import read_grey, write_png

        for f in tree_frames:
            write_png(f[:-4] + ".png", read_grey(f))
            os.remove(f)
        ph.emit("kitti_sp_dump", frames="png", loader_ms_per_batch_with_frames=loader_ms(
            cli.data_loader(cfg, "test"), cfg.data.batch_size))
    return total


# ---------------------------------------------------------------------------
# The VO slice: eval_vo with the repo's trained flagship solver, and the
# serving entry infer on two PNG frames.
# ---------------------------------------------------------------------------

# experiments/flagship/vo_net/config.yml, built in code (no YAML reader
# needed): B = 8, N = 1000, depth 5, the bf16 MLP, 376x1241.
FLAGSHIP_VO = {
    "name": "synthetic_good_corr",
    "data": {"dataset": "synthetic", "batch_size": 8, "good_num": 1000, "noise_px": 0.5,
             "outlier_frac": 0.15, "image": {"size": [376, 1241, 3]},
             "preprocessing": {"resize": [376, 1241]}},
    "model": {"name": "GoodCorresNet_layers_deepF", "depth": 5, "clamp_at": 0.02,
              "if_quality": True, "quality_size": 1, "mlp_dtype": "bfloat16",
              "balance_q": 1, "balance_t": 0.1},
    "exps": {"five_point": False, "base_name": "ransac_8p", "our_name": "DeepF",
             "filename": "err_ratio.npz"},
    "training": {"seed": 0, "clamp_q_params": [0.1, 0.01, 0.001],
                 "clamp_t_params": [0.5, 0.3, 0.1]},
}
FLAGSHIP_CKPT = os.path.join("experiments", "flagship", "ckpt_qt_best.msgpack")
VO_FRAMES = 60  # the JAX CLI's default sequence, seed 123: 59 pairs in 8 batches
VO_PAIRS = VO_FRAMES - 1
# Per eval_vo batch: the net's five weighted 8-point fits, and with the
# baseline one RANSAC fan-out and one refit more; K3 four times in DeepFNet
# and once in eval_step's F-loss, forward only.
VO_PER_BATCH = {"net": {"eigh9": 5, "epi_residual": 5},
                "baseline": {"eigh9": 7, "epi_residual": 5}}
VO_MEDIAN_ERR_T = 5.0  # deg: the committed 3.27 deg (experiments/flagship/README.md)
# The card's first batch against the port's CPU replay of it: the rotation
# between the two packages' per-pair R. The bf16 MLP rounds its products in
# another order on each device, which moves the weights and so F by about
# the gap between the bf16 and float32 MLPs on one device: VO_ROT_BAR is
# twice the largest such gap of this batch on the CPU (`vo_rotation_gap`,
# measured in the same run), plus float32's acos floor of ~0.03 deg.
VO_ACOS_FLOOR = 0.03
# infer: two frames of a SyntheticImageSequence at the joint path's
# 376x1240, the seeded gauss2 SuperPoint of val_feature (b), the flagship
# solver, K = 1000, the conv switch on K5. One pass of both frames through
# SuperPoint (six layers of >= 16,384 px: K5 6), one K4 match, the solver's
# five fits (eigh9 5) and its four residual feedbacks (K3 4: no loss).
INFER = {"image_size": (376, 1240), "focal": 718.856, "n_corners": 400, "K": 1000, "seed": 3}
INFER_LAUNCHES = {"conv3x3_affine_relu": 6, "mutual_nn_kernel": 1, "eigh9": 5,
                  "epi_residual": 4}
# infer on the card against the same call on the CPU (two JPEG frames): the
# match count within 2% (the bar infer's count was held to before: K5's
# float32 sums swap keypoints at near-equal scores; two of 528 swapped on
# an H100). On the card's own matches, the CPU's solver and pose recovery:
# R within 2e-3 (the pose bar of tests/test_torch_infer.py, where both
# packages run on the CPU), t_unit within 0.05 and the 1-px inlier ratio
# within 1%: this pair's translation direction carries the solver's float32
# rounding (five reweighted fits), 0.012 apart card vs CPU on the same
# matches with R 2.3e-4 apart (H100, 700 W), as the solver bars of
# `joint_ckpts` allow 0.1 deg + 30% in err_q and err_t.
INFER_CPU_BARS = {"matches_rel": 0.02, "R": 2e-3, "t_unit": 0.05, "ratio": 0.01}


def vo_rotations(cfg, batch, dev: str):
    """The port's per-pair [R | t] of eval_vo's net on `batch` on `dev`
    (float64 numpy), with the flagship weights."""
    import torch

    from deepfepe_tpu_torch.eval import val_rt_batch
    from deepfepe_tpu_torch.loader import model_loader
    from deepfepe_tpu_torch.train import eval_step, load_checkpoint
    from deepfepe_tpu_torch.utils.device import batch_to_device

    device = torch.device(dev)
    net = model_loader(cfg, device)
    load_checkpoint(FLAGSHIP_CKPT, net)
    tb = batch_to_device(batch, device)
    E = eval_step(net, tb, cfg)["E_ests"]
    with torch.no_grad():
        rt = val_rt_batch(E, tb["Ks"], tb["matches_xy_ori"], tb["E_gts"],
                          tb["delta_Rtijs_4_4"], ransac=False)
    return rt["M_est"].double().cpu().numpy()


def rotation_gaps(a, b):
    """Degrees between the rotations of [B, 3, 4] poses a and b."""
    import numpy as np

    rel = np.einsum("bji,bjk->bik", a[:, :3, :3], b[:, :3, :3])
    cos = np.clip((np.trace(rel, axis1=1, axis2=2) - 1) / 2, -1, 1)
    return np.degrees(np.arccos(cos))


def phase_eval_vo(ph: Phases) -> dict:
    """The port's eval_vo with the flagship checkpoint (read by the port's
    msgpack reader) on the 60-frame synthetic sequence, the net then the
    RANSAC baseline; launches read around each run alone; then the net's
    first batch replayed on the CPU. Returns the launch sums."""
    import dataclasses

    import numpy as np
    import torch

    from deepfepe_tpu_torch import cli
    from deepfepe_tpu_torch.train.config import config_from_dict

    check(os.path.exists(FLAGSHIP_CKPT), f"no {FLAGSHIP_CKPT} in the checkout")
    cfg = config_from_dict(FLAGSHIP_VO)
    batches = -(-VO_PAIRS // cfg.data.batch_size)
    total = dict.fromkeys(kernel_counters(), 0)
    reports = {}
    for run in ("net", "baseline"):
        reset_counts()
        rep = cli.eval_vo(cfg, f"smoke_vo_{run}", pretrained=FLAGSHIP_CKPT,
                          baseline=run == "baseline", n_frames=VO_FRAMES, device="cuda")
        torch.cuda.synchronize()
        counts = read_counts()
        expected = expect(VO_PER_BATCH[run], batches, counts)
        reports[run] = rep
        ph.emit("eval_vo", run=run, report=rep, batches=batches, launches=counts,
                expected_launches=expected,
                launches_per_batch={k: v / batches for k, v in counts.items() if v},
                timed="host clock over the solver (and the baseline) and the pose "
                      "recovery, ending in a synchronize; the sequence made up front")
        check(counts == expected, f"eval_vo ({run}): launches {counts}, expected {expected}")
        check(rep["n_pairs"] == VO_PAIRS, f"eval_vo ({run}): {rep['n_pairs']} pairs")
        check(all(np.isfinite(v) for v in rep.values() if isinstance(v, float)),
              f"eval_vo ({run}): non-finite report {rep}")
        for k, v in counts.items():
            total[k] += v
    net, base = reports["net"], reports["baseline"]
    # The flagship's committed result (experiments/flagship/README.md) is the
    # JAX package's on the TPU, whose RANSAC baseline lost to the net 56.26%
    # to 4.29%; off the TPU the float32 baseline is as good as the net
    # (PERF.md), so the ratio is reported, not held.
    ph.emit("eval_vo", trans_err_pct_net_over_baseline=net["trans_err_pct"]
            / base["trans_err_pct"], committed_jax_tpu={"net": 4.289, "baseline": 56.259})
    check(net["median_err_t"] < VO_MEDIAN_ERR_T,
          f"eval_vo: the flagship's median err_t {net['median_err_t']} >= {VO_MEDIAN_ERR_T} deg")
    check(base["median_err_q"] < 0.5,
          f"eval_vo: the RANSAC baseline's median err_q {base['median_err_q']} >= 0.5 deg")

    # The net's first batch: the card against the port's CPU replay.
    from deepfepe_tpu_torch.data import SyntheticSequence

    d = cfg.data
    first = next(SyntheticSequence(n_frames=VO_FRAMES, good_num=d.good_num, noise_px=d.noise_px,
                                   outlier_frac=d.outlier_frac, seed=123)
                 .pair_batches(d.batch_size))
    card = vo_rotations(cfg, first, "cuda")
    cpu = vo_rotations(cfg, first, "cpu")
    f32 = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, mlp_dtype="float32"))
    gap = rotation_gaps(cpu, vo_rotations(f32, first, "cpu"))
    bar = 2 * float(gap.max()) + VO_ACOS_FLOOR
    diff = rotation_gaps(card, cpu)
    ph.emit("eval_vo", check="first batch, card vs CPU", rotation_deg=diff.tolist(),
            bf16_vs_f32_on_cpu_deg=gap.tolist(), bar_deg=bar)
    check(float(diff.max()) <= bar,
          f"eval_vo: card and CPU rotations differ by {diff.max()} deg (bar {bar})")
    return total


def write_infer_frames(root: str) -> tuple:
    """Two frames of a SyntheticImageSequence as JPEG (quality 95, the
    native encoder: cv2.imwrite's bytes); returns (paths, K)."""
    import numpy as np

    from deepfepe_tpu_torch.data import SyntheticImageSequence
    from deepfepe_tpu_torch.utils.jpeg import write_jpeg

    seq = SyntheticImageSequence(n_frames=2, image_size=INFER["image_size"],
                                 focal=INFER["focal"], n_corners=INFER["n_corners"],
                                 seed=INFER["seed"])
    paths = []
    for k in range(2):
        paths.append(os.path.join(root, f"{k:06d}.jpg"))
        write_jpeg(paths[-1], np.rint(seq.frame(k) * 255).astype(np.uint8))
    return paths, seq.K


def infer_stages(paths, kw) -> dict:
    """One more warm infer call with each stage wrapped in synchronizes and
    timed on the host clock: ms a stage, and the rest of the call."""
    import torch

    from deepfepe_tpu_torch import cli
    from deepfepe_tpu_torch.geometry import decompose
    from deepfepe_tpu_torch.models import DeepFNet
    from deepfepe_tpu_torch.utils import image_io

    spent = {}

    def timed(label, fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            spent[label] = spent.get(label, 0.0) + (time.perf_counter() - t) * 1e3
            return out
        return run

    patches = ((image_io, "read_grey", "read JPEG frames"),
               (cli, "load_superpoint", "load SuperPoint"),
               (cli, "get_matches_from_sp", "SuperPoint and matching"),
               (cli, "load_checkpoint", "load the solver"),
               (DeepFNet, "forward", "solver"),
               (decompose, "recover_pose", "pose recovery (float64)"))
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    for obj, name, label in patches:
        setattr(obj, name, timed(label, getattr(obj, name)))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cli.infer(*paths, **kw)
        torch.cuda.synchronize()
        total = (time.perf_counter() - t0) * 1e3
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)
    spent["rest"] = total - sum(spent.values())
    spent["total"] = total
    return spent


def phase_infer(ph: Phases) -> dict:
    """The port's serving entry on two JPEG frames: launches read around one
    call, then the call timed warm, then the same call on the CPU, the card
    held to it within INFER_CPU_BARS. Returns the launch counts."""
    import tempfile

    import numpy as np
    import torch

    from deepfepe_tpu_torch import cli

    with tempfile.TemporaryDirectory(prefix="smoke_infer_") as root:
        paths, K = write_infer_frames(root)
        kw = dict(pretrained=FLAGSHIP_CKPT, pretrained_SP=vf_pretrained("b"),
                  K=f"{K[0, 0]},{K[1, 1]},{K[0, 2]},{K[1, 2]}", good_num=INFER["K"],
                  out=os.path.join(root, "pose.json"), device="cuda")
        card_sp = {}
        real_matches = cli.get_matches_from_sp

        def keep_matches(*a, **k):
            sp = real_matches(*a, **k)
            card_sp.setdefault("sp", {n: sp[n].cpu() for n in ("matches_xy_ori", "quality",
                                                                  "valid")})
            return sp

        with conv_switch("pallas"):
            reset_counts()
            cli.get_matches_from_sp = keep_matches
            try:
                out = cli.infer(*paths, **kw)
            finally:
                cli.get_matches_from_sp = real_matches
            torch.cuda.synchronize()
            counts = read_counts()
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                cli.infer(*paths, **kw)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            stages = infer_stages(paths, kw)
        with open(kw["out"]) as f:
            written = json.load(f)
        cpu = cli.infer(*paths, **{**kw, "out": "", "device": "cpu"})
        cli.get_matches_from_sp = lambda *a, **k: card_sp["sp"]
        try:  # the CPU's solver and pose recovery on the card's own matches
            replay = cli.infer(*paths, **{**kw, "out": "", "device": "cpu"})
        finally:
            cli.get_matches_from_sp = real_matches
    expected = {k: INFER_LAUNCHES.get(k, 0) for k in counts}

    def gap(key, other):
        return float(np.abs(np.asarray(out[key]) - np.asarray(other[key])).max())

    gaps = {"num_matches": abs(out["num_matches"] - cpu["num_matches"]),
            "R": gap("R", cpu), "t_unit": gap("t_unit", cpu),
            "replay_R": gap("R", replay), "replay_t_unit": gap("t_unit", replay),
            "replay_epi_inlier_ratio_1px": gap("epi_inlier_ratio_1px", replay)}
    R = np.asarray(out["R"])
    ortho = float(np.abs(R @ R.T - np.eye(3)).max())
    ph.emit("infer", result=out, launches=counts, expected_launches=expected,
            ms_per_pair=times, stages_ms=stages, orthonormality=ortho,
            det=float(np.linalg.det(R)),
            timed="host clock over one infer call (two JPEG reads, SuperPoint, matching, the "
                  "solver, the float64 pose recovery), ending in a synchronize; warm",
            cpu_result=cpu, card_vs_cpu=gaps, bars=INFER_CPU_BARS)
    check(counts == expected, f"infer: launches {counts}, expected {expected}")
    check(gaps["num_matches"] <= INFER_CPU_BARS["matches_rel"] * cpu["num_matches"],
          f"infer: card vs CPU matches {out['num_matches']} / {cpu['num_matches']}")
    check(gaps["replay_R"] <= INFER_CPU_BARS["R"]
          and gaps["replay_t_unit"] <= INFER_CPU_BARS["t_unit"],
          f"infer: card vs CPU pose on the card's matches {gaps}")
    check(gaps["replay_epi_inlier_ratio_1px"] <= INFER_CPU_BARS["ratio"],
          f"infer: card vs CPU inlier ratio on the card's matches {gaps}")
    check(written == out, "infer: the --out file differs from the printed result")
    check(out["num_matches"] >= 8, f"infer: {out['num_matches']} matches")
    check(ortho < 1e-9 and abs(np.linalg.det(R) - 1) < 1e-9, f"infer: R is not a rotation: {R}")
    check(abs(np.linalg.norm(out["t_unit"]) - 1) < 1e-9, f"infer: |t_unit| != 1: {out}")
    check(all(np.isfinite(np.asarray(out[k])).all()
              for k in ("R", "t_unit", "E", "epi_inlier_ratio_1px", "epi_median_px")),
          f"infer: non-finite output {out}")
    return counts


# ValPipelineFrontend: one sample of B = 2 pairs in each mode, the
# flagship solver (float32 MLP) from its TrainState `.msgpack`: precomputed
# matches (synthetic pairs, N = 1000, 376x1241), and SuperPoint mode
# (sp_joint_11000, the plain net, at 376x1240, K = 1000, the conv switch on
# K5: six layers of >= 16,384 px, both frames in one pass). A sample: the
# solver's five fits and the RANSAC fan-out and refit (eigh9 7), its four
# residual feedbacks (K3 4); SuperPoint mode adds K5 6 and K4 1. The card
# against the CPU on the same RANSAC draws: the solver's F̂ (unit norm)
# within VP_BARS["F"], err_q/err_t of est and gt within 0.05 deg + 1% (the
# float32 bar of tests/test_torch_eval_good.py), the baseline's within 0.1
# deg + 10% (the RANSAC bar of `joint_ckpts`); in SuperPoint mode the match
# count within 1% + 1 and the solver replayed on the CPU on the card's own
# matches.
VP = {"B": 2, "N": 1000, "image_size": (376, 1240), "K": 1000}
VP_LAUNCHES = {"matches": {"eigh9": 7, "epi_residual": 4},
               "superpoint": {"conv3x3_affine_relu": 6, "mutual_nn_kernel": 1, "eigh9": 7,
                              "epi_residual": 4}}
VP_BARS = {"F": 1e-3, "err": (0.05, 0.01), "base": (0.1, 0.1), "matches_rel": 0.01}


def vp_gaps(card: dict, cpu: dict) -> dict:
    """Card against CPU results of eval_one_sample: F̂ (unit norm, sign
    fixed) and each error's excess over its bar (<= 0 passes)."""
    import numpy as np

    def unit(F):
        F = np.asarray(F, np.float64)
        F = F / np.linalg.norm(F, axis=(-1, -2), keepdims=True)
        flat = F.reshape(len(F), 9)
        return F * np.sign(flat[np.arange(len(F)), np.abs(flat).argmax(-1)])[:, None, None]

    out = {"F": float(np.abs(unit(card["preds"]["F_est_pix"])
                             - unit(cpu["preds"]["F_est_pix"])).max())}
    for k in ("err_q_est", "err_t_est", "err_q_gt", "err_t_gt", "err_q_base", "err_t_base"):
        atol, rtol = VP_BARS["base" if k.endswith("base") else "err"]
        a, b = card["val"][k], cpu["val"][k]
        out[k] = float((np.abs(a - b) - (atol + rtol * np.abs(b))).max())
    return out


def phase_val_pipeline(ph: Phases) -> dict:
    """`eval.ValPipelineFrontend` in both modes on the card against the CPU
    (VP, VP_BARS), exact launches around each card sample; the plot needs
    matplotlib (ImportError without it, as the JAX package's). Returns the
    launch counts."""
    import importlib.util

    import numpy as np
    import torch

    from deepfepe_tpu_torch.data import SyntheticImagePairs
    from deepfepe_tpu_torch.data.synthetic import SyntheticPairs
    from deepfepe_tpu_torch.eval import ValPipelineFrontend
    from deepfepe_tpu_torch.frontend import FrontendParams, SuperPointNet
    from deepfepe_tpu_torch.models import DeepFNet

    total = dict.fromkeys(kernel_counters(), 0)
    B, N = VP["B"], VP["N"]
    idx = torch.randint(0, N, (B, 512, 8), generator=torch.Generator().manual_seed(0))
    samples = {"matches": SyntheticPairs(good_num=N, seed=3).batch(B),
               "superpoint": SyntheticImagePairs(image_size=VP["image_size"], seed=0).batch(B)}

    def pipeline(mode, device):
        size = VP["image_size"] if mode == "superpoint" else (376, 1241)
        net = DeepFNet(depth=5, image_size=size, if_quality=True).to(device)
        if mode == "matches":
            return ValPipelineFrontend(net, FLAGSHIP_CKPT)
        fp = FrontendParams(out_num_points=VP["K"], conf_thresh=1e-3, conv_impl="pallas")
        return ValPipelineFrontend(net, FLAGSHIP_CKPT, sp_net=SuperPointNet().to(device),
                                   sp_params_path=SP_FULL_CKPT, fp=fp)

    for mode, sample in samples.items():
        vp = pipeline(mode, "cuda")
        vp.eval_one_sample(sample, ransac_idxs=idx)  # warm
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card = vp.eval_one_sample(sample, ransac_idxs=idx)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = read_counts()
        expected = {k: VP_LAUNCHES[mode].get(k, 0) for k in counts}
        cpu = pipeline(mode, "cpu").eval_one_sample(sample, ransac_idxs=idx)
        gaps = vp_gaps(card, cpu)
        n_card = card["batch"]["matches_good_unique_nums"]
        n_cpu = cpu["batch"]["matches_good_unique_nums"]
        replay = None
        if mode == "superpoint":  # the CPU's solver on the card's own matches
            solver = ValPipelineFrontend(DeepFNet(depth=5, image_size=VP["image_size"],
                                                  if_quality=True), FLAGSHIP_CKPT)
            replay = vp_gaps(card, solver.eval_one_sample(card["batch"], ransac_idxs=idx))
        if importlib.util.find_spec("matplotlib") is None:
            try:
                vp.plot_one_sample(card)
                plot = "drew without matplotlib"
            except ImportError as e:
                plot = f"ImportError: {e}"
        else:
            plot = sorted(vp.plot_one_sample(card))
        finite = all(np.isfinite(v).all() for v in card["val"].values())
        ph.emit("val_pipeline", mode=mode, B=B, launches=counts, expected_launches=expected,
                ms_a_sample=ms, matches=n_card.tolist(), cpu_matches=n_cpu.tolist(),
                err_q_est=card["val"]["err_q_est"].tolist(),
                err_t_est=card["val"]["err_t_est"].tolist(),
                err_q_base=card["val"]["err_q_base"].tolist(), card_vs_cpu=gaps,
                solver_replay=replay, plot=plot, bars=VP_BARS,
                timed="host clock over one warm eval_one_sample, ending in a synchronize")
        check(counts == expected, f"val_pipeline {mode}: launches {counts}, expected {expected}")
        check(finite, f"val_pipeline {mode}: non-finite validation {card['val']}")
        check(np.all(np.abs(n_card - n_cpu) <= VP_BARS["matches_rel"] * n_cpu + 1),
              f"val_pipeline {mode}: matches {n_card} against the CPU's {n_cpu}")
        held = replay if mode == "superpoint" else gaps
        check(held["F"] <= VP_BARS["F"] and max(v for k, v in held.items() if k != "F") <= 0,
              f"val_pipeline {mode}: card vs CPU {held}")
        check(not str(plot).startswith("drew"), f"val_pipeline {mode}: {plot}")
        for k, v in counts.items():
            total[k] += v
    return total


# ---------------------------------------------------------------------------
# The BA slice: eval_vo's two-view polish and pose-graph fusion, eval_good's
# polish, the BA benchmark and the SuperPoint VO pose-graph tool.
# ---------------------------------------------------------------------------

SP_FULL_CKPT = os.path.join("experiments", "sp_full", "sp_joint_11000.msgpack")
VO_SKIP_PAIRS = VO_FRAMES - 2  # the (i, i + 2) sweep of --pose_graph: 58 pairs in 8 batches
VO_BA_MODES = {"refine_ba": {"refine_ba": True}, "pose_graph": {"pose_graph": True},
               "refine_ba_pose_graph": {"refine_ba": True, "pose_graph": True}}
# The two-stage solve freezes the rotations in its translation stage and
# averages them in its first: rot deg/100 m of the fused trajectory stays
# the chained one's within this.
PG_ROT_TOL = 0.02
# The card's refined poses of the first batch against the CPU replay of the
# polish on the card's solver outputs (matches, weights, R, t): the same
# float32 Gauss-Newton steps in cuSOLVER and LAPACK, 4e-6 deg apart in
# rotation and 1.5e-5 deg in direction (PERF.md §6). A pair whose
# acceptance differs must be a near tie (the polished and the initial robust
# cost within TIE_REL on a device). The whole path's gap is reported only:
# the polish stops where a step is rejected, and from the solver's bf16
# rounding (held in `eval_vo`) it made up to 0.14 deg and 4 deg.
REFINE_BAR_DEG = 1e-3
TIE_REL = 1e-4
# eval_good on the flagship config: a batch's five fits, the RANSAC fan-out
# and its refit (eigh9 7), K3 5; the polish launches no kernel.
EVAL_GOOD_PER_BATCH = {"eigh9": 7, "epi_residual": 5}
# tools/vo_pose_graph.py at its defaults: 30 frames at 240x320 (29 + 28 pairs
# in 4 + 4 batches of 8), the plain SuperPointNet (K5 on its four layers of
# >= 16,384 px, both frames of a batch in one pass), K4 once a batch, the
# solver's fits (eigh9 5) and K3 5 (four in DeepFNet, one in the F-loss).
VOPG_BATCHES = 8
VOPG_PER_BATCH = {"conv3x3_affine_relu": 4, "mutual_nn_kernel": 1, "eigh9": 5,
                  "epi_residual": 5}
BENCH_BA_ARGS = ["--points", "10000", "--cams", "100", "--sqrt_cams", "32",
                 "--pg_frames", "1000", "10000", "--iters", "8", "--device", "cuda"]


def finite_report(rep: dict) -> bool:
    import numpy as np

    vals = [v for v in rep.values() if isinstance(v, float)]
    vals += [v for v in rep.get("pose_graph", {}).values() if isinstance(v, float)]
    return all(np.isfinite(vals))


def vo_refined(cfg, batch, dev: str):
    """The port's eval_vo path on one batch on `dev`, the flagship solver
    then the two-view polish (`cli.refine_batch`): the refined [B, 3, 4]
    forward poses (float64 numpy), the polish's inputs (float32, on the
    CPU) and its info (numpy)."""
    import torch

    from deepfepe_tpu_torch import cli
    from deepfepe_tpu_torch.eval import val_rt_batch
    from deepfepe_tpu_torch.loader import model_loader
    from deepfepe_tpu_torch.train import eval_step, load_checkpoint
    from deepfepe_tpu_torch.utils.device import batch_to_device

    device = torch.device(dev)
    net = model_loader(cfg, device)
    load_checkpoint(FLAGSHIP_CKPT, net)
    tb = batch_to_device(batch, device)
    metrics = eval_step(net, tb, cfg)
    with torch.no_grad():
        rt = val_rt_batch(metrics["E_ests"], tb["Ks"], tb["matches_xy_ori"], tb["E_gts"],
                          tb["delta_Rtijs_4_4"], ransac=False)
        R, t, info = cli.refine_batch(tb, metrics, rt["M_est"], 200)
    inputs = {k: v.float().cpu() for k, v in (
        ("matches", tb["matches_xy_ori"]), ("weights", metrics["weights"]), ("Ks", tb["Ks"]),
        ("M", rt["M_est"]))}
    return (torch.cat([R, t[..., None]], dim=-1).double().cpu().numpy(), inputs,
            {k: v.cpu().numpy() for k, v in info.items()})


def refine_timing(x: dict) -> dict:
    """ms of one polish of the first batch on the card (its inputs `x`), and
    of the batched factorizations inside one of its five square-root steps,
    alone at their shapes: the complete QR of the [B, N, 7, 3] landmark
    blocks, the reduced QR of the [B, 4N + 12, 12] pose system and the
    [B, N, 3, 3] triangular solve (CUDA events, 3 calls after one warm)."""
    import torch

    from deepfepe_tpu_torch.eval import refine

    d = {k: v.cuda() for k, v in x.items()}
    B, N = d["matches"].shape[:2]
    gen = torch.Generator(device="cuda").manual_seed(0)
    blocks = torch.randn(B, N, 7, 3, device="cuda", generator=gen)
    system = torch.randn(B, 4 * N + 12, 12, device="cuda", generator=gen)
    tri = torch.randn(B, N, 3, 3, device="cuda", generator=gen).triu() + 3 * torch.eye(
        3, device="cuda")
    rhs = torch.randn(B, N, 3, 1, device="cuda", generator=gen)
    cases = {
        "polish (5 steps)": lambda: refine.refine_two_view_batch(
            d["matches"], d["weights"], d["Ks"], d["M"][:, :3, :3], d["M"][:, :3, 3], iters=5,
            min_matches=200),
        "complete QR [B, N, 7, 3]": lambda: torch.linalg.qr(blocks, mode="complete"),
        "reduced QR [B, 4N + 12, 12]": lambda: torch.linalg.qr(system, mode="reduced"),
        "solve_triangular [B, N, 3, 3]": lambda: torch.linalg.solve_triangular(tri, rhs,
                                                                               upper=True),
    }
    return {name: cuda_time_ms(fn, 3, warmup=1) for name, fn in cases.items()}


def chordal_gaps(a, b):
    """Degrees between the rotations, and between the translation
    directions, of [B, 3, 4] poses a and b, from chords (2 asin(|x - y| /
    2) on unit vectors, the rotations' over sqrt(2) columns): exact at 0,
    where acos of a float32 trace has a floor of a few 0.01 deg."""
    import numpy as np

    rot = 2 * np.arcsin(np.clip(np.linalg.norm(a[:, :3, :3] - b[:, :3, :3], axis=(1, 2))
                                / np.sqrt(8.0), 0, 1))
    ua = a[:, :3, 3] / np.linalg.norm(a[:, :3, 3], axis=-1, keepdims=True)
    ub = b[:, :3, 3] / np.linalg.norm(b[:, :3, 3], axis=-1, keepdims=True)
    direction = 2 * np.arcsin(np.clip(np.linalg.norm(ua - ub, axis=-1) / 2, 0, 1))
    return np.degrees(rot), np.degrees(direction)


def phase_eval_vo_ba(ph: Phases) -> dict:
    """The port's eval_vo with the flagship on the 60-frame sequence in the
    three BA modes (--refine_ba, --pose_graph, both): exact launches around
    each run (the (i, i + 2) sweep adds eigh9 40 and K3 40; the polish and
    the pose graph none), finite reports, the fused rot equal to the
    chained; then the first batch's refined poses on the card against the
    CPU replay of the polish on the card's solver outputs. Returns the
    launch sums."""
    import numpy as np
    import torch

    from deepfepe_tpu_torch import cli
    from deepfepe_tpu_torch.data import SyntheticSequence
    from deepfepe_tpu_torch.eval import refine
    from deepfepe_tpu_torch.train.config import config_from_dict

    check(os.path.exists(FLAGSHIP_CKPT), f"no {FLAGSHIP_CKPT} in the checkout")
    cfg = config_from_dict(FLAGSHIP_VO)
    bs = cfg.data.batch_size
    total = dict.fromkeys(kernel_counters(), 0)
    for mode, kw in VO_BA_MODES.items():
        reset_counts()
        rep = cli.eval_vo(cfg, f"smoke_vo_{mode}", pretrained=FLAGSHIP_CKPT,
                          n_frames=VO_FRAMES, device="cuda", **kw)
        torch.cuda.synchronize()
        counts = read_counts()
        batches = -(-VO_PAIRS // bs) + (-(-VO_SKIP_PAIRS // bs) if "pose_graph" in kw else 0)
        expected = expect(VO_PER_BATCH["net"], batches, counts)
        ph.emit("eval_vo_ba", mode=mode, report=rep, batches=batches, launches=counts,
                expected_launches=expected,
                timed="host clock: `seconds` over the consecutive pairs' solver, pose recovery "
                      "and polish, `skip_seconds` the (i, i + 2) sweep, `pose_graph_seconds` the "
                      "fusion, each ending in a synchronize; the sequence made up front")
        check(counts == expected, f"eval_vo {mode}: launches {counts}, expected {expected}")
        check(rep["n_pairs"] == VO_PAIRS, f"eval_vo {mode}: {rep['n_pairs']} pairs")
        check(finite_report(rep), f"eval_vo {mode}: non-finite report {rep}")
        if "pose_graph" in kw:
            gap = abs(rep["pose_graph"]["rot_err_deg_per_100m"] - rep["rot_err_deg_per_100m"])
            check(gap <= PG_ROT_TOL, f"eval_vo {mode}: the fused rot moved {gap} deg/100 m "
                  f"from the chained (tolerance {PG_ROT_TOL})")
        for k, v in counts.items():
            total[k] += v

    # The first batch's refined poses: the card against the port's CPU
    # replay of the polish on the card's solver outputs.
    d = cfg.data
    first = next(SyntheticSequence(n_frames=VO_FRAMES, good_num=d.good_num, noise_px=d.noise_px,
                                   outlier_frac=d.outlier_frac, seed=123)
                 .pair_batches(d.batch_size))
    card, x, card_info = vo_refined(cfg, first, "cuda")
    R, t, info = refine.refine_two_view_batch(x["matches"], x["weights"], x["Ks"],
                                              x["M"][:, :3, :3], x["M"][:, :3, 3], iters=5,
                                              min_matches=200)
    info = {k: v.numpy() for k, v in info.items()}
    rot, dirs = chordal_gaps(card, torch.cat([R, t[..., None]], -1).double().numpy())
    same = card_info["accepted"] == info["accepted"]
    tie = np.zeros_like(same)
    for i in (card_info, info):
        tie |= np.abs(i["cost_after"] - i["cost_before"]) <= TIE_REL * i["cost_before"]
    # Reported, not held: the whole path on the CPU (solver and polish).
    e2e_rot, e2e_dir = chordal_gaps(card, vo_refined(cfg, first, "cpu")[0])
    ph.emit("eval_vo_ba", check="first batch: the polish on the card vs its CPU replay",
            rotation_deg=rot.tolist(), direction_deg=dirs.tolist(), bar_deg=REFINE_BAR_DEG,
            accepted_card=card_info["accepted"].tolist(), accepted_cpu=info["accepted"].tolist(),
            near_ties=tie.tolist(), whole_path_vs_cpu={"rotation_deg": e2e_rot.tolist(),
                                                       "direction_deg": e2e_dir.tolist()},
            ms=refine_timing(x), ms_timed="CUDA events, 3 calls after a warm one")
    check(bool(np.all(same | tie)), f"eval_vo --refine_ba: acceptance differs off a near tie: "
          f"card {card_info['accepted']}, CPU {info['accepted']}")
    check(float(rot[same].max(initial=0)) <= REFINE_BAR_DEG
          and float(dirs[same].max(initial=0)) <= REFINE_BAR_DEG,
          f"eval_vo --refine_ba: the polish on the card and its CPU replay differ by "
          f"{rot.max()} deg (rotation), {dirs.max()} deg (direction); bar {REFINE_BAR_DEG}")
    return total


def phase_eval_good_ba(ph: Phases) -> dict:
    """The port's eval_good on the flagship config (B = 8, N = 1000, 5
    batches), without and with --refine_ba: exact launches, finite
    summaries, the gt sanity. Returns the launch sums."""
    import numpy as np
    import torch

    from deepfepe_tpu_torch import cli
    from deepfepe_tpu_torch.train.config import config_from_dict

    total = dict.fromkeys(kernel_counters(), 0)
    out = {}
    for refine_ba in (False, True):
        cfg = config_from_dict(FLAGSHIP_VO)
        reset_counts()
        s = cli.eval_good(cfg, EVAL_BATCHES, device="cuda", pretrained=FLAGSHIP_CKPT,
                          exper_name=f"smoke_eval_good_refine_{int(refine_ba)}",
                          refine_ba=refine_ba)
        torch.cuda.synchronize()
        counts = read_counts()
        expected = expect(EVAL_GOOD_PER_BATCH, EVAL_BATCHES, counts)
        out[refine_ba] = s
        ph.emit("eval_good_ba", refine_ba=refine_ba, summary=s, launches=counts,
                expected_launches=expected, pairs_per_s=s["pairs"] / s["seconds"])
        check(counts == expected, f"eval_good refine_ba={refine_ba}: launches {counts}, "
              f"expected {expected}")
        check(all(np.isfinite(v) for v in s.values() if isinstance(v, float)),
              f"eval_good refine_ba={refine_ba}: non-finite {s}")
        check(s["median_err_q_gt"] < 1e-3, f"eval_good: median_err_q_gt {s['median_err_q_gt']}")
        for k, v in counts.items():
            total[k] += v
    ph.emit("eval_good_ba", median_err_q=[out[False]["median_err_q"], out[True]["median_err_q"]],
            median_err_t=[out[False]["median_err_t"], out[True]["median_err_t"]])
    return total


def phase_bench_ba(ph: Phases) -> None:
    """tools/bench_ba.py at C = 100, P = 10,000 (the square-root rows at C =
    32), the pose graph at 1,000 and 10,000 frames: every BA row converged,
    every number finite, no kernel launched."""
    import numpy as np

    from deepfepe_tpu_torch.tools import bench_ba

    reset_counts()
    rows = bench_ba.main(BENCH_BA_ARGS)
    counts = read_counts()
    ph.emit("bench_ba", rows=rows, launches=counts,
            timed="CUDA events over 8 chained steps (4 for sqrt_ba) after two warm ones; the "
                  "pose graph's host clock over a whole solve, ending in a synchronize")
    check(not any(counts.values()), f"bench_ba: BA launched kernels {counts}")
    for r in rows:
        nums = [v for v in r.values() if isinstance(v, float)]
        check(all(np.isfinite(nums)), f"bench_ba: non-finite row {r}")
        if "converged" in r:
            check(r["converged"], f"bench_ba: {r['solver']} P={r['P']} did not converge")


def phase_vo_pose_graph(ph: Phases) -> dict:
    """tools/vo_pose_graph.py at its defaults with the repo's SuperPoint
    (sp_joint_11000) and the flagship solver: exact launches (K5, K4,
    eigh9, K3), finite metrics. Returns the launch counts."""
    import numpy as np
    import torch

    from deepfepe_tpu_torch.tools import vo_pose_graph

    check(os.path.exists(SP_FULL_CKPT), f"no {SP_FULL_CKPT} in the checkout")
    reset_counts()
    summary = vo_pose_graph.main(["--sp", SP_FULL_CKPT, "--deepf", FLAGSHIP_CKPT,
                                  "--device", "cuda", "--out",
                                  os.path.join("logs", "smoke_vo_pose_graph")])
    torch.cuda.synchronize()
    counts = read_counts()
    expected = expect(VOPG_PER_BATCH, VOPG_BATCHES, counts)
    ph.emit("vo_pose_graph", summary=summary, launches=counts, expected_launches=expected)
    check(counts == expected, f"vo_pose_graph: launches {counts}, expected {expected}")
    for name in ("chained", "pose_graph"):
        check(all(np.isfinite(list(summary[name].values()))),
              f"vo_pose_graph: non-finite {name} {summary[name]}")
    return counts


# ------------------------------------------------- SuperPoint training slice

SP_G2_CKPT = os.path.join("experiments", "g2_corners", "sp_corners_gauss2.msgpack")
# tools/train_sp_full.py at its defaults (SuperPointNet, B = 32, 120x160,
# lr 1e-3, desc_weight 1e-4), cut in depth: 50 detector steps, 20 warped
# joint steps, stage C with 16 HA images x 24 homographies and 10 fine-tune
# steps, then final_eval; a 128-image pool (rendering the default 3,000
# costs ~20 s of host time, nothing of the card's).
SP_TRAIN_ARGS = ["--det_iters", "50", "--joint_iters", "20", "--batch", "32", "--pool", "128",
                 "--ha_iters", "10", "--ha_images", "16", "--ha_homographies", "24",
                 "--seed", "0"]
# K5 launches a stage under the conv switch: the train steps and HA take the
# module forward (none); final_eval's one [16, 120, 160] frontend pass
# takes K5 on conv1a and conv1b. K4 stays off at K = 200 (< 768).
SP_TRAIN_LAUNCHES = {"det": {}, "joint": {}, "ha_labels": {}, "ha_finetune": {},
                     "final_eval": {"conv3x3_affine_relu": 2}}
SP_FINETUNE_ITERS = 10
SP_FINETUNE_RUNS = {"plain": ["--sp", SP_FULL_CKPT],
                    "gauss2": ["--sp", SP_G2_CKPT, "--gauss2"]}
# Each evaluation: 4 batches of 8 pairs at 120x160, one [16] pass a batch,
# K5 on the two 120x160 layers (conv1a/b, or gauss2's inc); K = 200.
SP_FINETUNE_PER_EVAL = {"conv3x3_affine_relu": 8}
# eval_before on the card against the same evaluation on the CPU (means
# over 32 pairs; float32 frontends, keypoints and matches equal but at
# near-ties).
SP_FINETUNE_BARS = {"num_matches": 0.5, "ratio": 0.02}
# val_feature --homography 8 with sp_joint_11000: the CLI's default
# FrontendParams (K = 300) and K = 1000. The epipolar part is 5 batches of 2
# pairs, one [4] pass and one match a batch; each homography pair one [2]
# pass and one match, which serves matching_score_and_map and the
# correctness; K4 at K >= 768 only.
SP_H_PAIRS = 8
SP_H_RUNS = {"default": 300, "k1000": 1000}
SP_H_IN_UNIT = ("repeatability", "mscore", "mAP", "match_inlier_ratio", "correct@1.0",
                "correct@3.0", "correct@5.0")
# check_sp: one warped joint step of sp_joint_11000 on 8 pairs at 120x160.
# Each of loss, det, desc and every gradient leaf (max abs error, against
# the CPU's float64 step on the same run's hinge sides: HingeSides) within
# 4x the CPU float32 step's own error plus 1e-6 of the float64 value's
# largest; the HA heatmap (2 images x 4 views) within 1e-5 of the CPU's.
CHECK_SP = {"batch": 8, "seed": 3, "ha_images": 2, "ha_views": 4}
CHECK_SP_FACTOR, CHECK_SP_FLOOR, CHECK_SP_HA = 4.0, 1e-6, 1e-5
# Hinge sides that may differ between the card's and the CPU's float32 step:
# rounding ties, a few of the B N^2 = 720,000 pairs a hinge call (1 in the
# first run). More is a fault of the step, not rounding.
CHECK_SP_FLIPS = 8


def phase_sp_train(ph: Phases) -> dict:
    """tools/train_sp_full.py (SP_TRAIN_ARGS) with the conv switch on K5:
    exact launches around each stage, every loss finite, the detector CE's
    last 10 steps' mean under its first 10's, images/s a stage, final_eval.
    Returns the launch counts of the whole run."""
    import numpy as np

    from deepfepe_tpu_torch.tools import train_sp_full
    from deepfepe_tpu_torch.utils.weights import load_superpoint

    out = os.path.join("logs", "smoke_sp_train")
    shutil.rmtree(out, ignore_errors=True)
    steps, per_stage = {}, {}
    total = dict.fromkeys(kernel_counters(), 0)

    def on_step(stage, it, o):
        steps.setdefault(stage, []).append(o)

    def on_stage(name):
        per_stage[name] = read_counts()
        for k, v in per_stage[name].items():
            total[k] += v
        reset_counts()

    reset_counts()
    with conv_switch("pallas"):
        summary = train_sp_full.main([*SP_TRAIN_ARGS, "--out", out, "--device", "cuda"],
                                     on_step=on_step, on_stage=on_stage)
    losses = {st: [{k: float(v) for k, v in o.items()} if isinstance(o, dict)
                   else {"loss": float(o)} for o in outs] for st, outs in steps.items()}
    det = [r["loss"] for r in losses["det"]]
    expected = {st: expect(per, 1, total) for st, per in SP_TRAIN_LAUNCHES.items()}
    ph.emit("sp_train", args=SP_TRAIN_ARGS, stages=summary["stages"],
            final_eval=summary["final_eval"], launches=per_stage, expected_launches=expected,
            det_ce_first10=float(np.mean(det[:10])), det_ce_last10=float(np.mean(det[-10:])),
            loss_first_last={st: [v[0], v[-1]] for st, v in losses.items()},
            timed="host clock a stage, ending in a synchronize")
    check(per_stage == expected, f"sp_train: launches {per_stage}, expected {expected}")
    check(all(np.isfinite(x) for v in losses.values() for r in v for x in r.values()),
          "sp_train: a non-finite loss")
    check(np.mean(det[-10:]) < np.mean(det[:10]),
          f"sp_train: the detector CE did not fall: {det[:10]} ... {det[-10:]}")
    # final_eval on the card against the same evaluation on the CPU: of the
    # run's checkpoint (80 steps from seeded weights leave the detector on
    # the dustbin, 0 matches, as the JAX package's CPU run of the command
    # gives) and of the trained sp_joint_11000, whose matches are not 0.
    evals = {"run": (summary["checkpoint"], summary["final_eval"])}
    with conv_switch("pallas"):
        evals["sp_joint_11000"] = (SP_FULL_CKPT, train_sp_full.final_eval(
            load_superpoint(SP_FULL_CKPT, "cuda")))
    held = {}
    for name, (ckpt, card) in evals.items():
        cpu = train_sp_full.final_eval(load_superpoint(ckpt, "cpu"))
        diff = {k: abs(card[k] - v) for k, v in cpu.items()}
        held[name] = {"card": {k: card[k] for k in cpu}, "cpu": cpu, "diff": diff,
                      "ok": all(np.isfinite(card[k]) and d <= SP_FINETUNE_BARS[
                          "num_matches" if k == "num_matches" else "ratio"]
                          for k, d in diff.items())}
    ph.emit("sp_train_final_eval", evals=held, bars=SP_FINETUNE_BARS)
    for name, h in held.items():
        check(h["ok"], f"sp_train: final_eval of {name} on the card {h['card']}, on the CPU "
              f"{h['cpu']}")
    check(held["sp_joint_11000"]["cpu"]["num_matches"] > 0,
          f"sp_train: final_eval of sp_joint_11000 found no match: {held['sp_joint_11000']}")
    return total


def phase_sp_finetune(ph: Phases) -> dict:
    """tools/finetune_sp_corners.py for SP_FINETUNE_ITERS iterations from
    sp_joint_11000 and, with --gauss2, from sp_corners_gauss2, conv switch
    on K5: eval_before and eval_after, exact launches, eval_before held
    against the same evaluation on the CPU (SP_FINETUNE_BARS). Returns the
    launch counts of both runs."""
    import numpy as np
    import torch

    from deepfepe_tpu_torch.tools import finetune_sp_corners
    from deepfepe_tpu_torch.utils.weights import load_superpoint

    total = dict.fromkeys(kernel_counters(), 0)
    for run, argv in SP_FINETUNE_RUNS.items():
        check(os.path.exists(argv[1]), f"no {argv[1]} in the checkout")
        out = os.path.join("logs", f"smoke_sp_finetune_{run}")
        shutil.rmtree(out, ignore_errors=True)
        reset_counts()
        with conv_switch("pallas"):
            r = finetune_sp_corners.main([*argv, "--iters", str(SP_FINETUNE_ITERS), "--out", out,
                                          "--device", "cuda"])
        torch.cuda.synchronize()
        counts = read_counts()
        expected = expect(SP_FINETUNE_PER_EVAL, 2, counts)
        cpu = finetune_sp_corners.eval_frontend(load_superpoint(argv[1], "cpu"), 60)
        diff = {k: abs(r["eval_before"][k] - cpu[k]) for k in cpu}
        within = all(v <= SP_FINETUNE_BARS["num_matches" if k == "num_matches" else "ratio"]
                     for k, v in diff.items())
        records = [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]
        ph.emit("sp_finetune", run=run, checkpoint=argv[1], iters=SP_FINETUNE_ITERS,
                eval_before=r["eval_before"], eval_after=r["eval_after"],
                eval_before_cpu=cpu, diff_card_cpu=diff, bars=SP_FINETUNE_BARS,
                train=r["train"], losses=[(x["loss"], x["det_ce"]) for x in records
                                          if x["stage"] == "train"],
                launches=counts, expected_launches=expected)
        check(counts == expected, f"sp_finetune ({run}): launches {counts}, expected {expected}")
        check(within, f"sp_finetune ({run}): eval_before on the card {r['eval_before']}, on the "
              f"CPU {cpu}")
        check(all(np.isfinite(list(e.values())).all() for e in (r["eval_before"], r["eval_after"]))
              and all(np.isfinite(x["loss"]) for x in records if x["stage"] == "train"),
              f"sp_finetune ({run}): non-finite {records}")
        for k, v in counts.items():
            total[k] += v
    return total


def phase_sp_homography(ph: Phases) -> dict:
    """`val_feature --homography 8` with sp_joint_11000 at the CLI's default
    K and at K = 1000 (K4), conv switch on K5: exact launches, every `h_*`
    metric finite, the rates in [0, 1]. Returns the launch counts."""
    import numpy as np
    import torch

    from deepfepe_tpu_torch import cli
    from deepfepe_tpu_torch.frontend import FrontendParams

    total = dict.fromkeys(kernel_counters(), 0)
    for run, K in SP_H_RUNS.items():
        reset_counts()
        with conv_switch("pallas"):
            summary = cli.val_feature(f"smoke_sp_h_{run}", pretrained=SP_FULL_CKPT,
                                      homography=SP_H_PAIRS,
                                      fp=FrontendParams(out_num_points=K, conf_thresh=1e-3),
                                      device="cuda")
        torch.cuda.synchronize()
        counts = read_counts()
        k4 = K >= 768
        expected = expect({"conv3x3_affine_relu": 2}, 5 + SP_H_PAIRS, counts)
        expected["mutual_nn_kernel"] = (5 + SP_H_PAIRS) if k4 else 0
        h = {k: v for k, v in summary.items() if k.startswith("h_")}
        ph.emit("sp_homography", run=run, K=K, pairs=SP_H_PAIRS, summary=summary,
                launches=counts, expected_launches=expected,
                pairs_per_s=(summary["pairs"] + SP_H_PAIRS) / summary["seconds"],
                timed="host clock over the 10 epipolar and 8 homography pairs, ending in a "
                "synchronize")
        check(counts == expected, f"sp_homography ({run}): launches {counts}, expected {expected}")
        check(len(h) >= 12 and all(np.isfinite(v) for v in h.values()),
              f"sp_homography ({run}): {h}")
        check(all(0.0 <= h[f"h_{k}"] <= 1.0 for k in SP_H_IN_UNIT),
              f"sp_homography ({run}): a rate outside [0, 1]: {h}")
        for k, v in counts.items():
            total[k] += v
    return total


class HingeSides:
    """The descriptor loss's hinge sides (`frontend.train_sp._hinge`): a
    float32 step records which pairs were active (x > 0) or on the kink (x
    = 0), call by call; a float64 step replays them, so it differentiates
    on the float32 run's side of each hinge. A dot product within float32
    rounding of a margin lands on either side, on any device, and moves a
    descriptor-head gradient by about desc_weight / (B N^2) a pair (the
    solver's kinks: SolverBranches)."""

    def __init__(self, replay: list | None = None):
        self.calls = [] if replay is None else list(replay)
        self.replay = replay is not None

    def __enter__(self):
        import torch

        from deepfepe_tpu_torch.frontend import train_sp

        self.saved = train_sp._hinge

        def hinge(x):
            if not self.replay:
                self.calls.append(((x > 0).cpu(), (x == 0).cpu()))
                return self.saved(x)
            pos, tie = (m.to(x.device) for m in self.calls.pop(0))
            return torch.where(pos, x, torch.where(tie, 0.5 * x, torch.zeros_like(x)))

        train_sp._hinge = hinge
        return self

    def __exit__(self, *exc):
        from deepfepe_tpu_torch.frontend import train_sp

        train_sp._hinge = self.saved


def sp_step_report(dev: str, f64: bool, batch: dict, sides: list | None = None) -> dict:
    """One warped joint step of sp_joint_11000 on `dev` (module route,
    float32 or float64), run as the tools run it: the step takes its own
    conv backend (`ops.conv.step_convs`: no TF32, no cuDNN) and the matmuls
    PyTorch's default, no TF32. Its metrics, gradients and hinge sides
    (float64 replays `sides`)."""
    from deepfepe_tpu_torch.frontend.train_sp import adam, make_warped_joint_train_step
    from deepfepe_tpu_torch.utils.weights import load_superpoint

    net = load_superpoint(SP_FULL_CKPT, dev)
    if f64:
        net = net.double()
    step = make_warped_joint_train_step(net, adam(net, 1e-3))
    with HingeSides(sides) as h:
        m = step(batch)
    return {"metrics": {k: float(v) for k, v in m.items()}, "sides": h.calls,
            "grads": {k: p.grad.detach().double().cpu() for k, p in net.named_parameters()}}


def hinge_flips(a: list, b: list) -> int:
    """Pairs whose hinge side differs between two recorded steps."""
    return sum(int((pa != pb).sum() + (ta != tb).sum()) for (pa, ta), (pb, tb) in zip(a, b))


def phase_check_sp(ph: Phases) -> None:
    """check_sp: one warped joint step on the card against the CPU in
    float32 and float64 (CHECK_SP, CHECK_SP_FACTOR, CHECK_SP_FLOOR; the
    float64 steps replay each float32 run's hinge sides), and homographic
    adaptation's heatmap on the card against the CPU's."""
    import numpy as np
    import torch

    from deepfepe_tpu_torch.frontend.train_sp import (SyntheticShapes, homographic_adaptation,
                                                      sample_homography)
    from deepfepe_tpu_torch.tools.train_sp_full import batch_from_pool
    from deepfepe_tpu_torch.utils.weights import load_superpoint

    c = CHECK_SP
    ds = SyntheticShapes(seed=c["seed"])
    batch = batch_from_pool(ds, None, np.random.RandomState(c["seed"]), c["batch"], True)
    r = {"card": sp_step_report("cuda", False, batch), "cpu": sp_step_report("cpu", False, batch)}
    # Float64 on each float32 run's hinge sides.
    r["f64_card"] = sp_step_report("cpu", True, batch, r["card"]["sides"])
    r["f64_cpu"] = sp_step_report("cpu", True, batch, r["cpu"]["sides"])
    ref = r["f64_card"]
    terms = {}
    for k, want in ref["metrics"].items():
        e_card = abs(r["card"]["metrics"][k] - want)
        e_cpu = abs(r["cpu"]["metrics"][k] - r["f64_cpu"]["metrics"][k])
        limit = CHECK_SP_FACTOR * e_cpu + CHECK_SP_FLOOR * abs(want)
        terms[k] = {"card": e_card, "cpu": e_cpu, "limit": limit, "ok": e_card <= limit}
    leaves = {}
    for k, want in ref["grads"].items():
        top = want.abs().max().item()
        e_card = (r["card"]["grads"][k] - want).abs().max().item()
        e_cpu = (r["cpu"]["grads"][k] - r["f64_cpu"]["grads"][k]).abs().max().item()
        limit = CHECK_SP_FACTOR * e_cpu + CHECK_SP_FLOOR * top
        leaves[k] = {"card": e_card, "cpu": e_cpu, "limit": limit, "ok": e_card <= limit}
    worst = max(leaves, key=lambda k: leaves[k]["card"] / max(leaves[k]["limit"], 1e-300))
    flips = hinge_flips(r["card"]["sides"], r["cpu"]["sides"])
    rng = np.random.RandomState(c["seed"] + 1)
    imgs = np.stack([ds.sample()[0] for _ in range(c["ha_images"])])
    Hs = np.stack([sample_homography(rng, (ds.H, ds.W)) for _ in range(c["ha_views"])])
    heat = {}
    for dev in ("cpu", "cuda"):
        net = load_superpoint(SP_FULL_CKPT, dev)
        heat[dev] = homographic_adaptation(net, torch.as_tensor(imgs, device=dev),
                                           torch.as_tensor(Hs, device=dev)).cpu()
    ha_err = (heat["cuda"] - heat["cpu"]).abs().max().item()
    ok = (all(t["ok"] for t in terms.values()) and all(v["ok"] for v in leaves.values())
          and ha_err <= CHECK_SP_HA and flips <= CHECK_SP_FLIPS)
    ph.emit("check_sp", metrics={k: {"card": r["card"]["metrics"][k], "cpu": r["cpu"]["metrics"][k],
                                     "f64": ref["metrics"][k]} for k in ref["metrics"]},
            terms=terms, leaves=len(leaves), leaves_ok=sum(v["ok"] for v in leaves.values()),
            worst_leaf={worst: leaves[worst]},
            failing_leaves={k: v for k, v in leaves.items() if not v["ok"]},
            hinge_flips_card_cpu=flips, ha_max_abs=ha_err,
            ha_max=heat["cpu"].abs().max().item(),
            bars={"each": f"card vs float64 <= {CHECK_SP_FACTOR} x CPU float32 vs float64 + "
                  f"{CHECK_SP_FLOOR} x max |float64|, float64 on each run's hinge sides",
                  "ha": CHECK_SP_HA, "hinge_flips": CHECK_SP_FLIPS}, within_bars=ok)
    check(ok, f"check_sp: the card's SuperPoint step disagrees with the CPU: terms {terms}, "
          f"worst leaf {worst} {leaves[worst]}, HA {ha_err}, hinge flips {flips}")


# ------------------------ the staged joint recipe, SuperPoint VO, if_des, DSAC

JF_DIR = os.path.join("experiments", "joint_fullres_train_qt3")
JF_SP = os.path.join(JF_DIR, "superPoint_stage2_end_to_end.msgpack")
JF_DEEPF = os.path.join(JF_DIR, "deepF_stage2_end_to_end.msgpack")
# tools/train_joint_full.py at the production point of experiments/
# r5_frozen_qsched (the bf16 gauss2 SuperPoint at 376x1240, N = 1000, 4
# pairs a step, the corner-dense pairs of experiments/joint_fullres_train_qt
# (800 blobs, 400 corner stamps: the default textures leave the detector
# about one match a pair at this size), frozen BN, the qt loss under the
# 0.7-quantile clamp scheduler, lr 1e-4 / 1e-6, clip 1.0) from the
# committed pair, cut in depth: 2 steps a stage, a checkpoint every 2 (the
# tag <stage>_it2 beside the stage's own), one evaluation batch. A step
# there takes about 10 s of host clock, the batches rendered by three host
# threads.
JF_STEPS = 2
JF_DATA = ["--n_blobs", "800", "--n_corners", "400"]
JF_ARGS = ["--sp", JF_SP, "--deepf", JF_DEEPF, "--gauss2", "--image", "376", "1240",
           "--npts", "1000", "--batch", "4", *JF_DATA, "--bn_mode", "frozen", "--qt",
           "--clamp_quantile", "0.7", "--lr_deepf", "1e-4", "--lr_sp", "1e-6",
           "--grad_clip", "1.0", "--stage1_iters", str(JF_STEPS), "--stage2_iters",
           str(JF_STEPS), "--save_every", "2", "--eval_batches", "1"]
# Per evaluation batch (8 pairs, one [16, 376, 1240] pass): the bf16 K5 on
# the six layers of >= 16,384 px, K4 1, eigh9 5 + 2 (RANSAC's fan-out and
# refit), K3 4 + 1 (DeepFNet's feedbacks and the F-loss).
JF_PER_EVAL = {"conv3x3_affine_relu_bf16": 6, "mutual_nn_kernel": 1, "eigh9": 7,
               "epi_residual": 5}
# Per train step with frozen BN, in both stages (the fused forward; stage 1
# differentiates SuperPoint too): the bf16 K5 and K5b 6 each, K4 1, eigh9 5,
# K3 5 forward and 4 backward (the qt loss reaches DeepFNet's four only).
JF_PER_STEP = {"conv3x3_affine_relu_bf16": 6, "conv3x3_affine_relu_bwd_bf16": 6,
               "mutual_nn_kernel": 1, "eigh9": 5, "epi_residual": 5, "epi_residual_bwd": 4}
# The train-mode BN leg at 96x128 (no layer reaches 16,384 px: no K5) with
# 60 corner stamps a plane (about 60 matches a pair), run on the card and
# on the CPU with one prefetch thread (the seed-1000 one) so both take the
# same batches: one stage-1 step, BN recalibration over one batch, one
# train-mode stage-2 step (the module forward).
JF_BN_ARGS = ["--sp", JF_SP, "--deepf", JF_DEEPF, "--gauss2", "--image", "96", "128",
              "--npts", "200", "--batch", "2", "--n_corners", "60", "--bn_mode", "train",
              "--bn_recalib", "1", "--qt", "--stage1_iters", "1", "--stage2_iters", "1",
              "--eval_batches", "1"]
JF_BN_LAUNCHES = {
    "eval_init": {"mutual_nn_kernel": 1, "eigh9": 7, "epi_residual": 5},
    "stage1_frozen_sp": {"mutual_nn_kernel": 1, "eigh9": 5, "epi_residual": 5,
                         "epi_residual_bwd": 4},
    "bn_recalib_before_stage2_end_to_end": {"mutual_nn_kernel": 1},
    "stage2_end_to_end": {"mutual_nn_kernel": 1, "eigh9": 5, "epi_residual": 5,
                          "epi_residual_bwd": 4}}
# Card against CPU on the same weights, data and RANSAC draws, both with a
# bf16 SuperPoint and a bf16 weight MLP, whose products round in another
# order on each device, so the two frontends give slightly other matches:
# match counts within 10% + 1 (score ties at the detector's threshold; the
# leg at 60 corner stamps and the 120x160 joint_ckpts run on an H100:
# 4.7% at most, train mode's recalibration count 29 / 30), the share of
# matches within 1 px of the true epipolar line within 0.05 (0.013
# measured), losses within 5% (2.2% measured), the solver's median err_q
# over the 8 pairs within 0.1 deg + 30% (measured: the leg's evaluations
# 1.209 / 1.058, 0.761 / 0.970 and 2.003 / 1.807 deg, the 120x160 run
# 6.811 / 5.504: a median of 8 pairs moves with a few pairs' other
# matches); the rest finite. Median err_t (32-105 deg on both devices:
# these small frames leave the translation direction unrecovered), RANSAC's
# medians and the gradient norms are held finite only; on the card's own
# matches (JC_SAME_BATCHES) the solver is held closer, free of the
# frontends' rounding.
JF_CPU_BARS = {"matches_rel": 0.1, "matches_abs": 1.0, "inlier": 0.05, "loss_rel": 0.05,
               "err_q_abs": 0.1, "err_q_rel": 0.3}
# eval_joint_ckpts over joint_full's four pairs and over the committed pair
# with train_joint_full's data and frontend flags (JC_FLAGS), one batch: the
# committed pair must give joint_full's eval_init line (the same weights and
# the first batch of the same stream) but for RANSAC's medians (another
# generator); the committed pair at the script's defaults with the
# production data and --eval_batches 2, as the JAX package's CPU run of it
# in PERF.md; and at 120x160 on the card and the CPU.
JC_FLAGS = ["--gauss2", "--depth_jitter", "0.0", *JF_DATA, "--conf", "0.010",
            "--nn_thresh", "0.9"]
JC_FULL = ["--image", "376", "1240", "--npts", "1000"]
JC_SMALL = ["--image", "120", "160", "--npts", "200", "--eval_batches", "1"]
# The committed pair at JC_SMALL, the card's frontend giving the matches of
# JC_SAME_BATCHES evaluation batches (16 pairs), the solver and RANSAC (one
# generator seed, the same draws) run on them on the card and on the CPU:
# the solver's median err_q within VOSP_ERR_Q (the bf16 MLP's products
# round in another order on each device; 4.752 / 4.863 deg on an H100);
# RANSAC's refit inlier count equal on the card and the CPU in at least
# JC_RANSAC_SAME of the pairs (14 of 16 measured). Its median err_q
# is not held: on the same draws the devices' float32 fits put a few
# matches on the other side of the 1 px threshold, and in 2 of the 16
# pairs another hypothesis wins (refit counts 71 / 56 and 56 / 62; median
# err_q 2.194 / 1.701 deg). Median err_t is reported only (72.54 / 72.47
# deg: these frames leave the translation unrecovered).
JC_SAME_BATCHES = 2
JC_RANSAC_SAME = 0.75
# tools/vo_superpoint.py at its defaults (SuperPointNet, 120x160, N = 200,
# 60 frames: 59 pairs in 8 batches) with sp_joint_11000 and the flagship
# solver, without and with --refine_ba: per batch K5 on conv1a/b, K4 1,
# eigh9 5 + 2 (RANSAC), K3 4 + 1; the polish launches none. Then 17 frames
# (2 batches) on the card and the CPU.
VOSP_BATCHES = 8
VOSP_PER_BATCH = {"conv3x3_affine_relu": 2, "mutual_nn_kernel": 1, "eigh9": 7,
                  "epi_residual": 5}
VOSP_CHECK_FRAMES = 17
# The float32 frontend on both devices: match means within SP_FINETUNE_BARS'
# 0.5; the bf16 solver's median err_q within 0.1 deg + 10% (its products
# round in another order on each device; 44 matches a pair).
VOSP_ERR_Q = {"abs": 0.1, "rel": 0.1}
# if_des: train_good and eval_good with model.if_img_des_to_pointnet on a
# correspondence tree with 128-wide SIFT descriptors (the loader's 'des' is
# 256 wide: C_in 261 and 264 with the quality column), the kitti_corr
# values (B = 8, N = 1000, depth 5, use_pallas_mlp true, which the routing
# keeps off K2 at these widths): per F-loss step eigh9 5, K3 5 and its
# backward 5; per eval batch eigh9 7, K3 5. The card's eval summary against
# the CPU's eval of the same checkpoint: medians within 0.1 deg + 10%
# (the bf16 MLP's rounding), loss_F within 5%.
DES_TRAIN_STEPS = 3
DES_PER_STEP = {"eigh9": 5, "epi_residual": 5, "epi_residual_bwd": 5}
DES_PER_EVAL = {"eigh9": 7, "epi_residual": 5}
DES_BARS = {"deg_abs": 0.1, "rel": 0.1, "loss_rel": 0.05}
# DSAC (models/dsac.py) on a synthetic pair of 1,000 K-normalized matches
# (30% outliers, 0.5 px noise), 64 hypotheses of 10, the card's run against
# the CPU's on the same draws: two eigh9 launches a call (the hypotheses,
# the refit); the same best hypothesis; E_best (unit norm, sign-aligned)
# within 1e-4 and exp_loss and top_loss within 1e-5 of the CPU's float32
# run. Each hypothesis' E against the CPU's float64 run, within float32's
# eps times the condition number of its fit, computed in float64 from the
# inputs alone (`dsac_conditioning`: lambda_1 / (lambda_8 - lambda_9) of
# its 8-point Gram matrix plus sigma_1 / (sigma_2 - sigma_3) of the 3x3
# before the rank-2 projection): the CPU's float32 run keeps within 0.095
# of that bar on every hypothesis, the H100 within 0.32. Hypotheses whose bar
# passes 1e-2 are ill-posed and left out (6 of 64 here, none the best);
# the best must not be one. Each soft score within 1e-5 of the largest of
# the same score computed in float64 from the card's own E (1.5e-7 in the
# CPU's float32 run): a steep sigmoid (beta 1e5) moves a score far on a
# small change of its E, so the scores are held on the card's E, whose
# error the E check bounds.
DSAC = {"n": 1000, "hyps": 64, "sample_size": 10, "outliers": 0.3, "noise_px": 0.5,
        "seed": 0, "calls": 3}
DSAC_BARS = {"E": 1e-4, "loss": 1e-5, "E_per_cond": 1.0, "ill_posed": 1e-2, "score": 1e-5}


def within_rel(card: float, cpu: float, rel: float, floor: float = 0.0) -> bool:
    import numpy as np

    return bool(np.isfinite(card)) and abs(card - cpu) <= floor + rel * abs(cpu)


def jf_records_close(card: list, cpu: list) -> dict:
    """train_joint_full records of the card's and the CPU's run, held at
    JF_CPU_BARS: {record stage: {key: (card, cpu, ok)}}."""
    import numpy as np

    b = JF_CPU_BARS
    out = {}
    for c, p in zip(card, cpu):
        row = {}
        for k, v in p.items():
            if k in ("stage", "elapsed_s", "tag", "iter", "iters", "q_clamp", "t_clamp",
                     "skipped_total"):
                ok = k in ("stage", "elapsed_s") or c[k] == v
            elif k in ("mean_num_matches", "num_matches", "train_mode_matches"):
                ok = within_rel(c[k], v, b["matches_rel"], b["matches_abs"])
            elif k == "gt_epi_inlier_1px":
                ok = within_rel(c[k], v, 0.0, b["inlier"])
            elif k == "loss":
                ok = within_rel(c[k], v, b["loss_rel"])
            elif k == "median_err_q":
                ok = within_rel(c[k], v, b["err_q_rel"], b["err_q_abs"])
            else:
                ok = bool(np.isfinite(c[k]))
            row[k] = (c[k], v, ok)
        out[p["stage"]] = row
    return out


def phase_joint_full(ph: Phases) -> dict:
    """tools/train_joint_full.py at the production point (JF_ARGS): exact
    launches around each evaluation and stage, no skipped update, the
    checkpoints; then the train-mode BN leg (JF_BN_ARGS) on the card and
    the CPU, held at JF_CPU_BARS. Returns the production run's launches."""
    import unittest.mock

    import numpy as np

    from deepfepe_tpu_torch.tools import train_joint_full

    check(os.path.exists(JF_SP) and os.path.exists(JF_DEEPF), f"no {JF_DIR} pair in the checkout")
    out = os.path.join("logs", "smoke_joint_full")
    shutil.rmtree(out, ignore_errors=True)
    per_stage, total = {}, dict.fromkeys(kernel_counters(), 0)

    def on_stage(name):
        per_stage[name] = read_counts()
        for k, v in per_stage[name].items():
            total[k] += v
        reset_counts()

    reset_counts()
    summary = train_joint_full.main([*JF_ARGS, "--out", out, "--device", "cuda"],
                                    on_stage=on_stage)
    expected = {name: expect(JF_PER_STEP if name.startswith("stage") else JF_PER_EVAL,
                             JF_STEPS if name.startswith("stage") else 1, total)
                for name in per_stage}
    recs = summary["records"]
    ckpts = sorted(n for n in os.listdir(out) if n.endswith(".pth.tar"))
    ph.emit("joint_full", args=JF_ARGS, records=recs, stages=summary["stages"],
            launches=per_stage, expected_launches=expected, checkpoints=ckpts,
            timed="host clock a stage (steps only, batches rendered by three host threads), "
                  "ending in a synchronize")
    check(per_stage == expected, f"joint_full: launches {per_stage}, expected {expected}")
    check(all(np.isfinite(v) for r in recs for v in r.values() if isinstance(v, float)),
          f"joint_full: a non-finite record {recs}")
    check(all(s["skipped"] == 0 for s in summary["stages"].values()),
          f"joint_full: skipped updates {summary['stages']}")
    want = {f"{n}_{t}.pth.tar" for n in ("deepF", "superPoint")
            for t in ("stage1_frozen_sp", "stage1_frozen_sp_it2", "stage2_end_to_end",
                      "stage2_end_to_end_it2")}
    check(set(ckpts) == want, f"joint_full: checkpoints {ckpts}")

    # The train-mode BN leg, on the card (launches) and the CPU.
    legs = {}
    with unittest.mock.patch.object(train_joint_full, "WORKER_SEEDS", (1000,)):
        for dev in ("cuda", "cpu"):
            leg_out = os.path.join("logs", f"smoke_joint_full_bn_{dev}")
            shutil.rmtree(leg_out, ignore_errors=True)
            per = {}

            def leg_stage(name, per=per):
                per[name] = read_counts()
                reset_counts()

            reset_counts()
            legs[dev] = {"summary": train_joint_full.main(
                [*JF_BN_ARGS, "--out", leg_out, "--device", dev], on_stage=leg_stage),
                "launches": per}
    card = legs["cuda"]["launches"]
    expected_bn = {name: expect(JF_BN_LAUNCHES.get(name, JF_BN_LAUNCHES["eval_init"]), 1,
                                card[name]) for name in card}
    held = jf_records_close(legs["cuda"]["summary"]["records"], legs["cpu"]["summary"]["records"])
    ph.emit("joint_full", leg="bn_train", args=JF_BN_ARGS, launches=card,
            expected_launches=expected_bn, card_vs_cpu=held, bars=JF_CPU_BARS)
    check(card == expected_bn, f"joint_full bn leg: launches {card}, expected {expected_bn}")
    bad = {s: {k: v for k, v in row.items() if not v[2]} for s, row in held.items()}
    check(not any(bad.values()), f"joint_full bn leg: card vs CPU off the bars: {bad}")
    check([r["stage"] for r in legs["cuda"]["summary"]["records"]] ==
          [r["stage"] for r in legs["cpu"]["summary"]["records"]], "joint_full bn leg: records")
    return total


def phase_joint_ckpts(ph: Phases) -> dict:
    """tools/eval_joint_ckpts.py over joint_full's output and over the
    committed pair: exact launches, the run's stage-2 pair equal to its own
    eval line but for RANSAC, the committed pair at 120x160 on the card and
    the CPU. Returns the launch sums."""
    import numpy as np
    import torch

    from deepfepe_tpu_torch.tools import eval_joint_ckpts

    run_dir = os.path.join("logs", "smoke_joint_full")
    total = dict.fromkeys(kernel_counters(), 0)
    out = {}
    for name, argv, n_evals in (
            ("run", ["--dir", run_dir, *JC_FLAGS, *JC_FULL, "--eval_batches", "1"], 4),
            ("committed", ["--dir", JF_DIR, *JC_FLAGS, *JC_FULL, "--eval_batches", "1"], 1),
            ("committed_production", ["--dir", JF_DIR, "--gauss2", *JC_FULL, *JF_DATA,
                                      "--eval_batches", "2"], 2)):
        reset_counts()
        t0 = time.perf_counter()
        recs = eval_joint_ckpts.main([*argv, "--device", "cuda"])
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        counts = read_counts()
        expected = expect(JF_PER_EVAL, n_evals, counts)
        out[name] = recs
        ph.emit("joint_ckpts", run=name, args=argv, records=recs, launches=counts,
                expected_launches=expected, seconds_host=sec)
        check(counts == expected, f"joint_ckpts ({name}): launches {counts}, expected {expected}")
        check(all("error" not in r and all(np.isfinite(v) for v in r.values()
                                           if isinstance(v, float)) for r in recs),
              f"joint_ckpts ({name}): {recs}")
        for k, v in counts.items():
            total[k] += v
    tags = [r["tag"] for r in out["run"]]
    check(tags == ["stage1_frozen_sp_it2", "stage2_end_to_end_it2", "stage1_frozen_sp",
                   "stage2_end_to_end"], f"joint_ckpts: tags {tags}")
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        own = json.loads(f.readline())
    swept = out["committed"][0]
    same = {k: (swept[k], own[k]) for k in ("median_err_q", "median_err_t", "mean_num_matches",
                                             "gt_epi_inlier_1px")}
    ph.emit("joint_ckpts", check="the committed pair against joint_full's eval_init line",
            values=same)
    check(all(a == b for a, b in same.values()), f"joint_ckpts: the sweep's record of the "
          f"committed pair {swept} is not joint_full's eval_init line {own}")
    small = {dev: eval_joint_ckpts.main(["--dir", JF_DIR, *JC_FLAGS, *JC_SMALL, "--device", dev])[0]
             for dev in ("cuda", "cpu")}
    held = jf_records_close([dict(small["cuda"], stage="committed")],
                            [dict(small["cpu"], stage="committed")])
    ph.emit("joint_ckpts", check="committed pair at 120x160, card vs CPU", card_vs_cpu=held,
            bars=JF_CPU_BARS)
    bad = {k: v for k, v in held["committed"].items() if not v[2]}
    check(not bad, f"joint_ckpts: card vs CPU off the bars: {bad}")
    same = jc_solver_on_card_matches()
    c, p = same["cuda"], same["cpu"]
    same_inl = float(np.mean(c["ransac_inliers"] == p["ransac_inliers"]))
    held = {"median_err_q": (c["median_err_q"], p["median_err_q"], within_rel(
                c["median_err_q"], p["median_err_q"], VOSP_ERR_Q["rel"], VOSP_ERR_Q["abs"])),
            "ransac_inliers_equal_share": (same_inl, None, same_inl >= JC_RANSAC_SAME)}
    ph.emit("joint_ckpts", check="committed pair at 120x160, the solver and RANSAC on the "
            "card's matches, card vs CPU", held=held,
            card={k: v for k, v in c.items() if k != "ransac_inliers"},
            cpu={k: v for k, v in p.items() if k != "ransac_inliers"},
            ransac_inliers=[c["ransac_inliers"].tolist(), p["ransac_inliers"].tolist()],
            bars={"median_err_q": VOSP_ERR_Q, "ransac_inliers_equal_share": JC_RANSAC_SAME})
    check(all(v[2] for v in held.values()), f"joint_ckpts: on the card's matches {held}")
    return total


def jc_solver_on_card_matches() -> dict:
    """The committed pair at JC_SMALL: the card's bf16 frontend gives the
    matches of JC_SAME_BATCHES evaluation batches, and the solver (the
    curriculum's final clamps, as `joint_eval_step`) and RANSAC (one
    generator seed a device: the same draws) run on them on the card and on
    the CPU -> {device: the medians of evaluate's four pose errors, and
    'ransac_inliers', each pair's RANSAC winner's inlier count}."""
    import numpy as np
    import torch

    from deepfepe_tpu_torch.eval.val_rt import val_rt_batch
    from deepfepe_tpu_torch.frontend import get_matches_from_sp
    from deepfepe_tpu_torch.tools import eval_joint_ckpts
    from deepfepe_tpu_torch.tools.sp_pipeline import (frontend_params, load_frontend,
                                                      load_solver, solver_config)
    from deepfepe_tpu_torch.tools.train_joint_full import EVAL_PAIRS
    from deepfepe_tpu_torch.train.engine import compute_losses
    from deepfepe_tpu_torch.train.joint import build_solver_batch
    from deepfepe_tpu_torch.utils.device import batch_to_device

    args = eval_joint_ckpts.build_parser().parse_args(["--dir", JF_DIR, *JC_FLAGS, *JC_SMALL])
    cfg = solver_config(args.npts, args.batch, tuple(args.image))
    fp = frontend_params(args.npts, args.conf, args.nn_thresh)
    sp_net = load_frontend(JF_SP, "cuda", gauss2=True)
    nets = {dev: load_solver(cfg, JF_DEEPF, dev) for dev in ("cuda", "cpu")}
    gens = {dev: torch.Generator().manual_seed(eval_joint_ckpts.RANSAC_SEED) for dev in nets}
    keys = {"median_err_q": "err_q_est", "median_err_t": "err_t_est",
            "median_err_q_ransac": "err_q_base", "median_err_t_ransac": "err_t_base"}
    errs = {dev: {k: [] for k in [*keys, "ransac_inliers"]} for dev in nets}
    q, t = (float(v[-1]) for v in (cfg.training.clamp_q_params, cfg.training.clamp_t_params))
    ds = eval_joint_ckpts.eval_stream(args)
    with torch.no_grad():
        for _ in range(JC_SAME_BATCHES):
            b = batch_to_device(ds.batch(EVAL_PAIRS), "cuda")
            sp_out = get_matches_from_sp(sp_net, (b["imgs_grey"][:, 0], b["imgs_grey"][:, 1]), fp)
            for dev, net in nets.items():
                bd = {k: v.to(dev) for k, v in b.items()}
                so = {k: v.to(dev) for k, v in sp_out.items() if isinstance(v, torch.Tensor)}
                _, m = compute_losses(net, build_solver_batch(so, bd), cfg, q, t)
                rt = val_rt_batch(m["E_ests"], bd["Ks"], so["matches_xy_ori"], bd["E_gts"],
                                  bd["delta_Rtijs_4_4"], generator=gens[dev])
                for k, src in keys.items():
                    errs[dev][k].append(rt[src].cpu().numpy())
                errs[dev]["ransac_inliers"].append(rt["base_inliers"].cpu().numpy())
    return {dev: {k: np.concatenate(v) if k == "ransac_inliers" else
                  float(np.median(np.concatenate(v))) for k, v in e.items()}
            for dev, e in errs.items()}


def phase_vo_superpoint(ph: Phases) -> dict:
    """tools/vo_superpoint.py at its defaults with sp_joint_11000 and the
    flagship solver, without and with --refine_ba: exact launches, finite
    summaries, the same match count in both; then 17 frames on the card and
    the CPU. Returns the launch sums."""
    import numpy as np
    import torch

    from deepfepe_tpu_torch.tools import vo_superpoint

    check(os.path.exists(SP_FULL_CKPT), f"no {SP_FULL_CKPT} in the checkout")
    base = ["--sp", SP_FULL_CKPT, "--deepf", FLAGSHIP_CKPT]
    total = dict.fromkeys(kernel_counters(), 0)
    runs = {}
    for name, extra in (("plain", []), ("refine_ba", ["--refine_ba"])):
        reset_counts()
        s = vo_superpoint.main([*base, *extra, "--out", os.path.join("logs", f"smoke_vosp_{name}"),
                                "--device", "cuda"])
        torch.cuda.synchronize()
        counts = read_counts()
        expected = expect(VOSP_PER_BATCH, VOSP_BATCHES, counts)
        runs[name] = s
        ph.emit("vo_superpoint", run=name, summary=s, launches=counts,
                expected_launches=expected, pairs_per_s=s["n_pairs"] / s["seconds"],
                timed="host clock over the sweep (frontend, solver, RANSAC, polish), ending "
                      "in a synchronize; frames rendered inside it")
        check(counts == expected, f"vo_superpoint ({name}): launches {counts}, expected {expected}")
        check(s["n_pairs"] == VO_PAIRS, f"vo_superpoint ({name}): {s['n_pairs']} pairs")
        check(all(np.isfinite(list(s[k].values())).all() for k in ("est", "base")),
              f"vo_superpoint ({name}): non-finite {s}")
        for k, v in counts.items():
            total[k] += v
    check(runs["plain"]["mean_num_matches"] == runs["refine_ba"]["mean_num_matches"],
          f"vo_superpoint: match counts {runs['plain']['mean_num_matches']} and "
          f"{runs['refine_ba']['mean_num_matches']} in the two runs")
    short = {dev: vo_superpoint.main([*base, "--n_frames", str(VOSP_CHECK_FRAMES), "--out",
                                      os.path.join("logs", f"smoke_vosp_check_{dev}"),
                                      "--device", dev]) for dev in ("cuda", "cpu")}
    c, p = short["cuda"], short["cpu"]
    held = {"mean_num_matches": (c["mean_num_matches"], p["mean_num_matches"],
                                 within_rel(c["mean_num_matches"], p["mean_num_matches"], 0.0,
                                            SP_FINETUNE_BARS["num_matches"])),
            "median_err_q": (c["est"]["median_err_q"], p["est"]["median_err_q"],
                             within_rel(c["est"]["median_err_q"], p["est"]["median_err_q"],
                                        VOSP_ERR_Q["rel"], VOSP_ERR_Q["abs"]))}
    ph.emit("vo_superpoint", check=f"{VOSP_CHECK_FRAMES} frames, card vs CPU", held=held,
            card=c, cpu=p)
    check(all(v[2] for v in held.values()), f"vo_superpoint: card vs CPU {held}")
    return total


def phase_des_fusion(ph: Phases) -> dict:
    """train_good and eval_good with model.if_img_des_to_pointnet on a tree
    with 128-wide SIFT descriptors: exact launches (no K2 or K2b at C_in 261
    and 264 with use_pallas_mlp), finite, the card's eval against the CPU's.
    Returns the launch sums."""
    import tempfile

    import numpy as np
    import torch

    from deepfepe_tpu_torch import cli
    from deepfepe_tpu_torch.data.synthetic_dump import write_corr_dump
    from deepfepe_tpu_torch.loader import model_loader
    from deepfepe_tpu_torch.train.config import config_from_dict

    total = dict.fromkeys(kernel_counters(), 0)
    model = {"if_img_des_to_pointnet": True, "if_quality": True, "quality_size": 1}
    read = {"with_quality": True, "with_pose": True, "with_sift_des": True}
    with tempfile.TemporaryDirectory(prefix="smoke_des_") as root:
        write_corr_dump(root, **KITTI_TREE, with_sift_des=True, sift_dim=128)
        for exp in ("smoke_des_train", "smoke_des_eval"):
            shutil.rmtree(os.path.join(REPO, "logs", exp), ignore_errors=True)
        tcfg = config_from_dict({**KITTI_CORR, "model": {**KITTI_CORR["model"], **model},
                                 "data": {**KITTI_CORR["data"], "dump_root": root,
                                          "read_what": read}})
        net = model_loader(tcfg, torch.device("cpu"))
        widths = [net.input_weights.fw[0].in_features, net.update_weights.fw[0].in_features]
        reset_counts()
        last = cli.train_good(tcfg, "smoke_des_train", train_iter=DES_TRAIN_STEPS, device="cuda")
        torch.cuda.synchronize()
        counts = read_counts()
        expected = expect(DES_PER_STEP, DES_TRAIN_STEPS, counts)
        ph.emit("des_fusion", run="train_good", weight_net_inputs=widths, last=last,
                launches=counts, expected_launches=expected)
        check(widths == [261, 264], f"des_fusion: weight-net inputs {widths}")
        check(counts == expected, f"des_fusion train_good: launches {counts}, expected {expected}")
        check(all(np.isfinite(v) for v in last.values()) and last["nonfinite"] == 0.0,
              f"des_fusion train_good: {last}")
        for k, v in counts.items():
            total[k] += v
        ckpt = os.path.join("logs", "smoke_des_train", "checkpoints",
                            f"deepFNet_{DES_TRAIN_STEPS}_checkpoint.pth.tar")
        ecfg = {**KITTI_EVAL, "model": {**KITTI_EVAL["model"], **model},
                "data": {**KITTI_EVAL["data"], "dump_root": root, "read_what": read}}
        batches = -(-KITTI_PAIRS // KITTI_EVAL["data"]["batch_size"])
        summaries = {}
        for dev in ("cuda", "cpu"):
            reset_counts()
            summaries[dev] = cli.eval_good(config_from_dict(ecfg), 0, device=dev, pretrained=ckpt,
                                           exper_name="smoke_des_eval" if dev == "cuda" else "")
            if dev == "cuda":
                torch.cuda.synchronize()
                counts = read_counts()
    expected = expect(DES_PER_EVAL, batches, counts)
    c, p = summaries["cuda"], summaries["cpu"]
    b = DES_BARS
    held = {k: (c[k], p[k], within_rel(c[k], p[k], b["loss_rel"] if k == "loss_F" else b["rel"],
                                        0.0 if k == "loss_F" else b["deg_abs"]))
            for k in ("median_err_q", "median_err_t", "median_err_q_base", "loss_F")}
    ph.emit("des_fusion", run="eval_good", summary=c, launches=counts, expected_launches=expected,
            card_vs_cpu=held, bars=DES_BARS, pairs_per_s=c["pairs"] / c["seconds"])
    check(counts == expected, f"des_fusion eval_good: launches {counts}, expected {expected}")
    check(c["pairs"] == KITTI_PAIRS and c["median_err_q_gt"] < 1e-3,
          f"des_fusion eval_good: {c}")
    check(all(v[2] for v in held.values()), f"des_fusion: card vs CPU {held}")
    for k, v in counts.items():
        total[k] += v
    return total


def dsac_inputs():
    """A synthetic pair of DSAC['n'] matches in K-normalized coordinates
    (numpy, seeded) and its unit-norm ground-truth E."""
    import numpy as np

    rng = np.random.RandomState(DSAC["seed"])
    n, f = DSAC["n"], 718.856
    ang = np.radians(rng.uniform(-3, 3, 3))
    cx, cy, cz = np.cos(ang)
    sx, sy, sz = np.sin(ang)
    R = (np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
         @ np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
         @ np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]]))
    t = np.array([0.1, 0.02, 1.0]) + 0.05 * rng.randn(3)
    X = np.stack([rng.uniform(-10, 10, n), rng.uniform(-3, 3, n), rng.uniform(5, 40, n)], -1)
    X2 = X @ R.T + t
    x1, x2 = X[:, :2] / X[:, 2:], X2[:, :2] / X2[:, 2:]
    x1 += rng.randn(n, 2) * DSAC["noise_px"] / f
    x2 += rng.randn(n, 2) * DSAC["noise_px"] / f
    out = rng.choice(n, int(DSAC["outliers"] * n), replace=False)
    x2[out] = rng.uniform(-0.8, 0.8, (len(out), 2))
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    E = tx @ R
    return x1, x2, E / np.linalg.norm(E)


def dsac_conditioning(x1, x2, idx) -> "np.ndarray":
    """Each minimal set's condition number for its float32 E, in float64
    from the points alone: lambda_1 / (lambda_8 - lambda_9) of the 8-point
    Gram matrix that `weighted_eight_point` builds (Hartley-normalized,
    rows normalized; its uniform weights leave the ratio as it is) plus
    sigma_1 / (sigma_2 - sigma_3) of its null vector as a 3x3, which the
    rank-2 projection needs apart."""
    import torch

    from deepfepe_tpu_torch.geometry.basic import homo
    from deepfepe_tpu_torch.ops.fmatrix import epipolar_constraint_matrix, hartley_normalize

    p1, p2 = (homo(torch.as_tensor(x, dtype=torch.float64))[idx] for x in (x1, x2))
    X = epipolar_constraint_matrix(hartley_normalize(p1, None)[0], hartley_normalize(p2, None)[0])
    X = X / torch.linalg.vector_norm(X, dim=-1, keepdim=True)
    lam, V = torch.linalg.eigh(X.transpose(-1, -2) @ X)
    s = torch.linalg.svdvals(V[..., 0].reshape(-1, 3, 3))
    return (lam[:, -1] / (lam[:, 1] - lam[:, 0]) + s[:, 0] / (s[:, 1] - s[:, 2])).numpy()


def dsac_scores(x1, x2, E_hyps) -> "np.ndarray":
    """The soft scores of hypotheses E_hyps, in float64 on the CPU, with
    dsac_essential's defaults (threshold 1e-4, beta 1e5)."""
    import torch

    from deepfepe_tpu_torch.geometry.epipolar import sampson_dist

    E = torch.as_tensor(E_hyps, dtype=torch.float64)
    a, b = (torch.as_tensor(x, dtype=torch.float64) for x in (x1, x2))
    d = sampson_dist(E[:, None], a[None], b[None]).reshape(len(E), -1)
    return (1 - torch.sigmoid(1e5 * (d - 1e-4))).sum(-1).numpy()


def phase_dsac(ph: Phases) -> dict:
    """models/dsac.py on the card against its CPU runs on the same draws:
    two eigh9 launches a call, the outputs within DSAC_BARS, ms a call.
    Returns the launch counts of the counted calls."""
    import numpy as np
    import torch

    from deepfepe_tpu_torch.models import dsac_essential

    x1, x2, E_gt = dsac_inputs()

    def loss_fn(E_ref):
        def f(E):
            En = E / (torch.linalg.norm(E) + 1e-9)
            return torch.minimum(((En - E_ref) ** 2).sum(), ((En + E_ref) ** 2).sum())
        return f

    idx = torch.randint(0, DSAC["n"], (DSAC["hyps"], DSAC["sample_size"]),
                        generator=torch.Generator().manual_seed(DSAC["seed"]))
    outs = {}
    for dev, where, dt in (("cuda", "cuda", torch.float32), ("cpu", "cpu", torch.float32),
                           ("cpu64", "cpu", torch.float64)):
        a, b = (torch.as_tensor(v, dtype=dt, device=where) for v in (x1, x2))
        Eg = torch.as_tensor(E_gt, dtype=dt, device=where)
        if dev == "cuda":
            reset_counts()
            for _ in range(DSAC["calls"]):
                o = dsac_essential(a, b, loss_fn=loss_fn(Eg), idx=idx)
            torch.cuda.synchronize()
            counts = read_counts()
            ms = cuda_time_ms(lambda: dsac_essential(a, b, loss_fn=loss_fn(Eg), idx=idx), 20)
        else:
            o = dsac_essential(a, b, loss_fn=loss_fn(Eg), idx=idx)
        outs[dev] = {k: v.detach().double().cpu().numpy() for k, v in o.items()}
    c, p = outs["cuda"], outs["cpu"]

    def unit(E):
        E = E / np.linalg.norm(E)
        return E * np.sign(E.flat[np.abs(E).argmax()])

    e_gap = np.array([np.abs(unit(a) - unit(b)).max()
                      for a, b in zip(c["E_hyps"], outs["cpu64"]["E_hyps"])])
    e_bar = (DSAC_BARS["E_per_cond"] * np.finfo(np.float32).eps
             * dsac_conditioning(x1, x2, idx.numpy()))
    held = e_bar <= DSAC_BARS["ill_posed"]
    top = np.abs(c["soft_scores"]).max()
    score_gap = np.abs(c["soft_scores"] - dsac_scores(x1, x2, c["E_hyps"])) / top
    worst = int(np.argmax(np.where(held, e_gap / e_bar, 0.0)))
    errs = {"E_best": float(np.abs(unit(c["E_best"]) - unit(p["E_best"])).max()),
            "E_hyps_held": int(held.sum()), "E_hyps_ill_posed": np.flatnonzero(~held).tolist(),
            "E_worst": {"hypothesis": worst, "gap": float(e_gap[worst]),
                        "bar": float(e_bar[worst])},
            "E_hyps_within": bool((e_gap[held] <= e_bar[held]).all()),
            "score_gap": float(score_gap.max()),
            "best": [int(np.argmax(c["soft_scores"])), int(np.argmax(p["soft_scores"]))],
            "exp_loss": float(abs(c["exp_loss"] - p["exp_loss"])),
            "top_loss": float(abs(c["top_loss"] - p["top_loss"]))}
    expected = expect({"eigh9": 2}, DSAC["calls"], counts)
    ph.emit("dsac", case=DSAC, launches=counts, expected_launches=expected, errors=errs,
            bars=DSAC_BARS, ms_per_call=ms, top_loss=float(c["top_loss"]),
            exp_loss=float(c["exp_loss"]),
            timed="CUDA events over 20 back-to-back calls (draws handed in)")
    check(counts == expected, f"dsac: launches {counts}, expected {expected}")
    check(errs["best"][0] == errs["best"][1] and held[errs["best"][0]]
          and errs["E_best"] <= DSAC_BARS["E"] and errs["E_hyps_within"]
          and errs["score_gap"] <= DSAC_BARS["score"] and errs["exp_loss"] <= DSAC_BARS["loss"]
          and errs["top_loss"] <= DSAC_BARS["loss"], f"dsac: card vs CPU {errs}")
    check(float(c["top_loss"]) < 0.5, f"dsac: the best hypothesis' loss {c['top_loss']}")
    return counts


# The parallel slice: the launcher, DP, DP x TP, the N-sharded fit,
# the distributed BA steps, the data-parallel joint step and the dry-run
# tool, each world of ranks in subprocesses (`--parallel-rank`) with its
# own deadline. The card has one H100, so the one-rank deployment runs
# under NCCL and the 2- and 4-rank worlds share cuda:0 under gloo (NCCL
# refuses two ranks on one device). A rank's failure or timeout fails the
# phase. The flagship step is the dry run's: depth 5, N = 1000,
# if_quality, the qt loss and the sample loss, float32 unfused MLPs, a
# global batch of PAR_B, from the trained flagship solver (FLAGSHIP_CKPT):
# with seeded weights the untrained fits are so ill-conditioned that the
# float32 rounding of cuBLAS's other tilings at 4 rows a rank moved the
# qt loss by 4.3e-5 and the gradient's cosine to 1 - 4e-5 against one
# process on 8 rows (PERF.md), past the JAX bars below, which the
# CPU, whose products do not depend on the row count, meets exactly. The
# launcher takes TRAIN_F's config (the fused bf16 MLP: K2/K2b) for
# PAR_LAUNCH_STEPS steps, without validation.
PAR_B = 8
PAR_LAUNCH_STEPS = 2
PAR_TIMEOUT = 420.0
PAR_DRYRUN_TIMEOUT = 660.0  # the tool's own world deadline (600 s) and its start
# The bars: the JAX package's own (tests/test_model_train.py's 8-vs-1
# mesh: loss rtol 1e-5, gradient cosine > 1 - 1e-5; tests/test_tp.py:82,
# 151, 168: DP x TP loss rtol 1e-5, the N-sharded F to 2e-5 and its
# gradient atol 5e-4 / rtol 1e-3; tests/test_ba.py's BA bars).
PAR_BARS = {"loss_rtol": 1e-5, "grad_cos": 1 - 1e-5, "nshard_F": 2e-5,
            "nshard_grad": (5e-4, 1e-3), "schur_poses": 5e-4, "schur_points": (2e-3, 2e-2),
            "sqrt_poses": 1e-9, "sqrt_points": 1e-8, "pg_poses": 2e-5, "pg_two_stage": 5e-5}
# Launches a rank, per path (PERF.md's predictions): the flagship step
# runs eigh9 2 x 5 (the fits and the sample fits), K3 6 forward (4 in
# DeepFNet, the F-loss, the sampled hypotheses) and 4 backward (the qt
# loss leaves the F-loss and the sample loss out of the gradient); the
# launcher's F-mode step eigh9, K2, K2b, K3 and K3's backward 5 each; the
# fit one eigh9; the joint step (depth 2, K = 1000) eigh9 2, K3 2 and 2,
# K4 1, and with SuperPoint frozen (the fused forward, K5 on) K5 6 and K5b
# 6; the dry run a flagship step, a fit and a train-mode joint step.
PAR_FLAGSHIP = {"eigh9": 10, "epi_residual": 6, "epi_residual_bwd": 4}
PAR_EXPECTED = {
    "launcher": {k: PAR_LAUNCH_STEPS * 5 for k in ("eigh9", "mlp_forward", "mlp_backward",
                                                    "epi_residual", "epi_residual_bwd")},
    "dp": PAR_FLAGSHIP, "dptp": PAR_FLAGSHIP, "nshard": {"eigh9": 1},
    "joint_frozen": {"eigh9": 2, "epi_residual": 2, "epi_residual_bwd": 2, "mutual_nn_kernel": 1,
                     "conv3x3_affine_relu": 6, "conv3x3_affine_relu_bwd": 6},
    "joint_sync_bn": {"eigh9": 2, "epi_residual": 2, "epi_residual_bwd": 2,
                      "mutual_nn_kernel": 1},
    "dryrun": {"eigh9": 13, "epi_residual": 8, "epi_residual_bwd": 6, "mutual_nn_kernel": 1},
}


def par_launch_cfg() -> dict:
    return {**TRAIN_F, "training": {**TRAIN_F["training"], "train_iter": PAR_LAUNCH_STEPS,
                                    "val_interval": 0, "save_interval": 0, "profile_start": 0,
                                    "profile_steps": 0, "tensorboard": False}}


def par_counted(fn):
    """fn()'s result and the kernel launches of this process during it."""
    import torch

    reset_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v for k, v in read_counts().items() if v}


def par_nshard_inputs(batch):
    """tests/test_tp.py's shape for the fit's check, B = 3 and N = 256
    (the flagship batch's first items and points), with softmax weights
    (numpy seed 5). At N = 1000 the float32 gradient of sum |F| moves by
    up to 4e-3 with the order of the Hartley sums alone (this check run
    on the CPU), past the test's bar; the dry run fits N = 1000."""
    import numpy as np
    import torch

    from deepfepe_tpu_torch.tools.dryrun_multichip import nshard_inputs

    p1, p2, _ = nshard_inputs({"matches_xy_ori": batch["matches_xy_ori"][:3, :256]})
    z = np.random.RandomState(5).randn(*p1.shape[:-1]) * 0.5
    w = torch.softmax(torch.as_tensor(z, dtype=torch.float32), -1)
    return p1, p2, w


def plant_nshard_drop_rank(rank: int, last: int) -> None:
    """--plant nshard_drop_rank: the last rank's partial Gram left out of
    the N-sharded fit's all-reduce."""
    from deepfepe_tpu_torch.parallel import nshard

    if rank == last:
        partial = nshard.gram_partial
        # Zero, but still on the graph: every rank's backward then runs the
        # same collectives.
        nshard.gram_partial = lambda X: partial(X) * 0.0


def par_case_launcher(spec: dict) -> dict:
    from deepfepe_tpu_torch.launch import train_multihost

    last, counts = par_counted(lambda: train_multihost.main([
        "--config", spec["config"], "--exper", spec["exper"], "--backend", "nccl",
        "--coordinator", spec["coordinator"], "--num_processes", "1", "--process_id", "0"]))
    return {"launcher": {"last": last, "launches": counts}}


def par_case_reference(spec: dict) -> dict:
    from deepfepe_tpu_torch import cli

    cli.main(["train_good", spec["config"], spec["exper"], "--device", "cuda"])
    return {}


def par_case_w2(spec: dict) -> dict:
    """DP at 2 ranks, then the data-parallel joint step twice (SuperPoint
    frozen with K5 on; then trained, BatchNorm synchronized)."""
    import torch

    from deepfepe_tpu_torch.data import SyntheticImagePairs, SyntheticPairs
    from deepfepe_tpu_torch.parallel import make_mesh
    from deepfepe_tpu_torch.tools import dryrun_multichip as dr

    mesh = make_mesh(2, 1)
    batch = SyntheticPairs(good_num=dr.FLAGSHIP_N, seed=0).batch(PAR_B)
    (trainer, m), counts = par_counted(lambda: dr.dp_tp_step(
        mesh, dr.flagship_config(), batch, pretrained=FLAGSHIP_CKPT))
    out = {"dp": {"loss": float(m["loss"]), "launches": counts,
                  "grads": {k: p.grad.cpu() for k, p in trainer.net.named_parameters()}}}
    jbatch = SyntheticImagePairs(image_size=dr.IMAGE, seed=1).batch(2 * dr.PAIRS)
    for name, train_sp in (("joint_frozen", False), ("joint_sync_bn", True)):
        (sp, before, jm), counts = par_counted(lambda: dr.joint_step(
            mesh, jbatch, train_sp=train_sp, conv_impl="pallas"))
        out[name] = {"metrics": {k: float(v) for k, v in jm.items() if v.dim() == 0},
                     "before": {k: v.cpu() for k, v in before.items()},
                     "after": {k: v.cpu() for k, v in sp.named_buffers() if k in before},
                     "launches": counts}
    return out


def par_case_w4(spec: dict) -> dict:
    """DP x TP on (2, 2), the N-sharded fit over a model group of 4, and
    the distributed BA steps over a data group of 4."""
    import torch

    from deepfepe_tpu_torch.ba import graph_from_odometry
    from deepfepe_tpu_torch.ba.distributed import (make_distributed_ba_step,
                                                   make_distributed_pose_graph_step,
                                                   make_distributed_sqrt_ba_step,
                                                   optimize_pose_graph_two_stage_distributed,
                                                   pad_pose_graph_edges, shard_ba_inputs,
                                                   shard_edges)
    from deepfepe_tpu_torch.data import SyntheticPairs
    from deepfepe_tpu_torch.parallel import MODEL_AXIS, make_mesh, make_nsharded_fit, shard, tp
    from deepfepe_tpu_torch.tools import dryrun_multichip as dr

    batch = SyntheticPairs(good_num=dr.FLAGSHIP_N, seed=0).batch(PAR_B)
    mesh = make_mesh(2, 2)
    (trainer, m), counts = par_counted(lambda: dr.dp_tp_step(
        mesh, dr.flagship_config(), batch, pretrained=FLAGSHIP_CKPT))
    names = tp.sharded_names(trainer.net)
    grads = {k: (tp.gather_full(mesh, p.grad) if k in names else p.grad).cpu()
             for k, p in trainer.net.named_parameters()}
    out = {"dptp": {"loss": float(m["loss"]), "launches": counts, "grads": grads}}

    ns = make_mesh(1, 4)
    p1, p2, w = (shard(ns, x.to(ns.device), dim=1, axis=MODEL_AXIS)
                 for x in par_nshard_inputs(batch))
    w = w.clone().requires_grad_(True)

    def fit():
        F, r = make_nsharded_fit(ns)(p1, p2, w)
        F.abs().sum().backward()
        return F

    F, counts = par_counted(fit)
    out["nshard"] = {"F": F.detach().cpu(), "grad": w.grad.cpu(), "launches": counts}

    ba = make_mesh(4, 1)
    dev = ba.device
    prob = [x.to(dev, torch.float64) for x in dr.sqrt_ba_problem(64)]
    poses, X, obs, vis, K = prob
    p, x, c = make_distributed_ba_step(ba, damping=1e-4)(poses, *shard_ba_inputs(ba, X, obs, vis),
                                                          K)
    out["schur"] = {"poses": p.cpu(), "points": x.cpu(), "cost": float(c)}
    p, x, c = make_distributed_sqrt_ba_step(ba, damping=1e-3)(
        poses, *shard_ba_inputs(ba, X, obs, vis), K)
    out["sqrt"] = {"poses": p.cpu(), "points": x.cpu()}
    g = dr.pose_graph_problem()
    g = g._replace(**{k: v.to(dev) for k, v in g._asdict().items()})
    e, mm, w6 = shard_edges(ba, *pad_pose_graph_edges(g.edges, g.measurements, g.weights, 4))
    p, c = make_distributed_pose_graph_step(ba, damping=1e-6)(g.poses, e, mm, w6,
                                                              torch.ones(6, device=dev))
    p2, _ = optimize_pose_graph_two_stage_distributed(ba, g, rot_iters=4, trans_iters=4,
                                                      damping=1e-6)
    out["pose_graph"] = {"poses": p.cpu(), "cost": float(c), "two_stage": p2.cpu()}
    return out


PAR_CASES = {"launcher": par_case_launcher, "reference": par_case_reference,
             "w2": par_case_w2, "w4": par_case_w4}


def parallel_rank(spec: dict) -> int:
    """One rank of a parallel-phase world (`--parallel-rank`): its case's
    results to spec['out']/rank<r>.pt."""
    import torch

    from deepfepe_tpu_torch.parallel import init_distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.chdir(REPO)
    own_world = spec["case"] in ("w2", "w4")
    if own_world:
        init_distributed("gloo", spec["coordinator"], spec["world"], spec["rank"])
        if spec.get("plant") == "nshard_drop_rank":
            plant_nshard_drop_rank(spec["rank"], spec["world"] - 1)
    try:
        res = PAR_CASES[spec["case"]](spec)
        torch.save(res, os.path.join(spec["out"], f"rank{spec['rank']}.pt"))
    finally:
        if own_world:
            torch.distributed.destroy_process_group()
    return 0


def par_world(case: str, n: int, out: str, timeout: float = PAR_TIMEOUT, **extra) -> list:
    """Run `case` at n ranks (chip_smoke.py --parallel-rank each); their
    results. A rank's failure or the deadline raises CheckFailed."""
    import torch

    from deepfepe_tpu_torch.parallel.spawn import WorldFailed, run_world

    os.makedirs(out, exist_ok=True)

    def argv(r, coordinator):
        spec = {"case": case, "rank": r, "world": n, "coordinator": coordinator, "out": out,
                **extra}
        return [sys.executable, os.path.abspath(__file__), "--parallel-rank", json.dumps(spec)]

    try:
        run_world(argv, n, timeout, cwd=REPO)
    except WorldFailed as e:
        raise CheckFailed(f"parallel {case}: {str(e)[-3000:]}") from None
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False) for r in range(n)]


class TPEmulation:
    """The tensor-parallel forward of an ErrorEstimator on one process
    (`parallel.tp.tp_forward`'s operations in its order): each wide layer
    as `n` column slices, each its own product and InstanceNorm, then
    concatenated, so the products run at the shapes the ranks run them."""

    def __init__(self, n: int, layers):
        self.n, self.layers = n, tuple(layers)

    def forward(self, est, x, train):
        import torch

        from deepfepe_tpu_torch.models.error_estimator import _linear

        dt = est.dtype
        acc = torch.promote_types(dt, torch.float32)
        x = x.to(dt)
        for i in range(0, len(est.fw) - 1, est.stride):
            lin, norm = est.fw[i], est.fw[i + est.stride - 2]
            if i in self.layers:
                k = lin.out_features // self.n
                parts = []
                for j in range(self.n):
                    sl = slice(j * k, (j + 1) * k)
                    y = (x @ lin.weight[sl].contiguous().to(dt).T + lin.bias[sl].to(dt)).to(acc)
                    mean = y.mean(dim=-2, keepdim=True)
                    var = ((y - mean) ** 2).mean(dim=-2, keepdim=True)
                    parts.append((y - mean) / torch.sqrt(var + norm.eps) * norm.weight[sl]
                                 + norm.bias[sl])
                y = torch.cat(parts, dim=-1)
            else:
                y = norm(_linear(x, lin, dt).to(acc))
            x = torch.nn.functional.leaky_relu(y.to(dt), est.negative_slope)
        return _linear(x, est.fw[-1], dt).to(acc)


def par_flagship_reference(parts: int = 1, tp_parts: int = 1):
    """The flagship step's loss and gradient (the trained solver) on one
    process, no process group, on the card: the global batch in `parts`
    equal micro-batches, the losses and gradients averaged (parts = 2: the
    rows a rank of the 2-rank worlds takes, so both sides run the same
    products at the same shapes), the wide MLP layers as `tp_parts` column
    slices (`TPEmulation`: the products a rank of the (2, 2) mesh runs).
    The qt loss does not read the sample loss's draws. Returns (loss,
    gradients by name, the batch)."""
    import torch

    from deepfepe_tpu_torch.data import SyntheticPairs
    from deepfepe_tpu_torch.loader import model_loader
    from deepfepe_tpu_torch.tools import dryrun_multichip as dr
    from deepfepe_tpu_torch.train import Trainer, compute_losses, load_checkpoint
    from deepfepe_tpu_torch.utils.device import batch_to_device

    cfg = dr.flagship_config()
    dev = torch.device("cuda")
    net = model_loader(cfg, dev, torch.Generator().manual_seed(0), train=True)
    load_checkpoint(FLAGSHIP_CKPT, net)
    if tp_parts > 1:
        for est in (net.input_weights, net.update_weights):
            est.tp = TPEmulation(tp_parts, [i for i in range(0, len(est.fw) - 1, est.stride)
                                            if est.fw[i].out_features >= 256])
    gen = Trainer(net, cfg).sample_generator
    batch = SyntheticPairs(good_num=dr.FLAGSHIP_N, seed=0).batch(PAR_B)
    k = PAR_B // parts
    losses = []
    for i in range(parts):
        part = batch_to_device({n: v[i * k:(i + 1) * k] for n, v in batch.items()}, dev)
        loss, _ = compute_losses(net, part, cfg, 0.1, 0.5, gen)
        (loss / parts).backward()
        losses.append(loss.detach())
    return (float(torch.stack(losses).mean()),
            {n: p.grad.cpu() for n, p in net.named_parameters()}, batch)


def par_cos(a: dict, b: dict) -> float:
    import torch

    va = torch.cat([a[k].double().reshape(-1) for k in sorted(b)])
    vb = torch.cat([b[k].double().reshape(-1) for k in sorted(b)])
    return float(va @ vb / (va.norm() * vb.norm()))


def par_check_nshard(ph: Phases, w4: list, batch) -> dict:
    """The N-sharded fit's F (every rank the same) and gradient against
    `weighted_eight_point` on the card."""
    import torch

    from deepfepe_tpu_torch.ops.fmatrix import weighted_eight_point

    p1, p2, w = (x.cuda() for x in par_nshard_inputs(batch))
    w = w.clone().requires_grad_(True)
    fit = weighted_eight_point(p1, p2, w)
    fit.F.abs().sum().backward()
    F = w4[0]["nshard"]["F"]
    unit = lambda x: x / x.norm(dim=(-2, -1), keepdim=True)  # noqa: E731
    a, b = unit(F.double()), unit(fit.F.detach().cpu().double())
    sign = torch.sign((a * b).sum((-2, -1)))[:, None, None]
    g = torch.cat([r["nshard"]["grad"] for r in w4], dim=-1).double()
    gref = w.grad.cpu().double()
    atol, rtol = PAR_BARS["nshard_grad"]
    errs = {"F": float((a * sign - b).abs().max()),
            "grad_excess": float(((g - gref).abs() - (atol + rtol * gref.abs())).max()),
            "grad_max_abs": float((g - gref).abs().max()),
            "same_on_ranks": all(torch.equal(r["nshard"]["F"], F) for r in w4)}
    ph.emit("parallel", path="nshard", ranks=4, errors=errs, bars=PAR_BARS)
    check(errs["same_on_ranks"] and errs["F"] <= PAR_BARS["nshard_F"]
          and errs["grad_excess"] <= 0, f"parallel nshard: against weighted_eight_point {errs}")
    return errs


def par_launch_counts(results: list, path: str) -> list:
    counts = [r[path]["launches"] for r in results]
    expected = PAR_EXPECTED[path]
    check(all(c == expected for c in counts),
          f"parallel {path}: launches a rank {counts}, expected {expected}")
    return counts


def phase_parallel(ph: Phases) -> dict:
    """The parallel paths (module comment at PAR_B); returns each path's
    launches a rank."""
    import re

    import torch

    from deepfepe_tpu_torch import ba as tba
    from deepfepe_tpu_torch.tools import dryrun_multichip as dr

    root = os.path.join(REPO, "logs", "smoke_parallel")
    for d in (root, *(os.path.join(REPO, "logs", f"smoke_parallel_{x}")
                      for x in ("launcher", "reference"))):
        shutil.rmtree(d, ignore_errors=True)
    os.makedirs(root)
    launches = {}

    # 1. The one-card deployment: the launcher as a one-rank NCCL job
    # against train_good without a process group, bit for bit.
    cfg_path = os.path.join(root, "flagship_f.json")
    with open(cfg_path, "w") as f:
        json.dump(par_launch_cfg(), f)
    t = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:  # the two processes side by side on the card
        runs = [pool.submit(par_world, case, 1, os.path.join(root, case), config=cfg_path,
                            exper=f"smoke_parallel_{case}") for case in ("launcher", "reference")]
        launcher = runs[0].result()
        runs[1].result()
    launcher_s = time.perf_counter() - t
    lines = {exp: [json.loads(ln) for ln in open(os.path.join(
        REPO, "logs", exp, "metrics.jsonl")) if '"train"' in ln]
        for exp in ("smoke_parallel_launcher", "smoke_parallel_reference")}
    same = lines["smoke_parallel_launcher"] == lines["smoke_parallel_reference"]
    launches["launcher"] = par_launch_counts(launcher, "launcher")
    ph.emit("parallel", path="launcher", backend="nccl", ranks=1, steps=PAR_LAUNCH_STEPS,
            losses=[ln["loss"] for ln in lines["smoke_parallel_launcher"]],
            reference_losses=[ln["loss"] for ln in lines["smoke_parallel_reference"]],
            bitwise_equal=same, launches=launches["launcher"], world_seconds=launcher_s)
    check(same and len(lines["smoke_parallel_launcher"]) == PAR_LAUNCH_STEPS,
          "parallel launcher: the one-rank NCCL run's metrics differ from train_good's")

    # 2. DP at 2 ranks sharing the card (gloo), and the joint step. Held at
    # the JAX bars against one process taking the same rows a rank
    # (micro-batches); against one process on all 8 rows at once only
    # reported: cuBLAS tiles 4,000 and 8,000 rows differently, and the qt
    # loss, a mean of small rotation errors (0.004), carries float32's
    # absolute rounding of the quaternions as 6e-5 of its value (PERF.md),
    # which the CPU, whose products do not depend on the row
    # count, never shows.
    ref_loss, ref_grads, batch = par_flagship_reference(parts=2)
    whole_loss, whole_grads, _ = par_flagship_reference(parts=1)
    t = time.perf_counter()
    w2 = par_world("w2", 2, os.path.join(root, "w2"))
    w2_s = time.perf_counter() - t
    dp = w2[0]["dp"]
    cos = par_cos(dp["grads"], ref_grads)
    rel = abs(dp["loss"] - ref_loss) / abs(ref_loss)
    launches["dp"] = par_launch_counts(w2, "dp")
    ph.emit("parallel", path="dp", backend="gloo", ranks=2, global_batch=PAR_B, loss=dp["loss"],
            reference_loss=ref_loss, loss_rel=rel, grad_cos=cos,
            whole_batch={"loss": whole_loss,
                         "loss_rel": abs(dp["loss"] - whole_loss) / abs(whole_loss),
                         "grad_cos": par_cos(dp["grads"], whole_grads)},
            launches=launches["dp"], world_seconds=w2_s)
    check(rel <= PAR_BARS["loss_rtol"] and cos > PAR_BARS["grad_cos"],
          f"parallel dp: loss {dp['loss']} vs {ref_loss}, gradient cosine {cos}")
    check(all(torch.equal(r["dp"]["grads"][k], dp["grads"][k]) for r in w2 for k in dp["grads"]),
          "parallel dp: the ranks' averaged gradients differ")
    for name in ("joint_frozen", "joint_sync_bn"):
        launches[name] = par_launch_counts(w2, name)
        m = [r[name]["metrics"] for r in w2]
        after = [r[name]["after"] for r in w2]
        equal = all(torch.equal(a[k], after[0][k]) for a in after for k in after[0])
        moved = sum(not torch.equal(w2[0][name]["before"][k], after[0][k]) for k in after[0])
        ph.emit("parallel", path=name, backend="gloo", ranks=2, pairs_a_rank=dr.PAIRS,
                image=dr.IMAGE, loss=m[0]["loss"], num_matches=m[0]["num_matches"],
                skipped=m[0]["skipped_update"], bn_buffers=len(after[0]),
                bn_buffers_moved=moved, bn_buffers_equal_on_ranks=equal,
                launches=launches[name])
        check(all(math.isfinite(x["loss"]) and x == m[0] for x in m),
              f"parallel {name}: metrics {m}")
        check(equal, f"parallel {name}: BN buffers differ between ranks")
        if name == "joint_sync_bn":
            check(moved == len(after[0]), f"parallel {name}: {moved} of {len(after[0])} BN "
                  "buffers moved")
        else:
            check(moved == 0, f"parallel {name}: the frozen SuperPoint's buffers moved")

    # 3. DP x TP, the N-sharded fit and BA at 4 ranks.
    t = time.perf_counter()
    w4 = par_world("w4", 4, os.path.join(root, "w4"))
    w4_s = time.perf_counter() - t
    # Held against one process running the products at the ranks' shapes
    # (TPEmulation); against the replicated products only reported: the
    # half-width products round otherwise, which the qt loss carries as
    # 2.4e-4 of its value (PERF.md).
    tp_loss, tp_grads, _ = par_flagship_reference(parts=2, tp_parts=2)
    rel = abs(w4[0]["dptp"]["loss"] - tp_loss) / abs(tp_loss)
    cos = par_cos(w4[0]["dptp"]["grads"], tp_grads)
    launches["dptp"] = par_launch_counts(w4, "dptp")
    ph.emit("parallel", path="dptp", backend="gloo", ranks=4, mesh=[2, 2],
            loss=w4[0]["dptp"]["loss"], reference_loss=tp_loss, loss_rel=rel, grad_cos=cos,
            replicated={"loss": ref_loss, "loss_rel": abs(w4[0]["dptp"]["loss"] - ref_loss)
                        / abs(ref_loss), "grad_cos": par_cos(w4[0]["dptp"]["grads"], ref_grads)},
            launches=launches["dptp"], world_seconds=w4_s)
    check(rel <= PAR_BARS["loss_rtol"] and cos > PAR_BARS["grad_cos"]
          and all(r["dptp"]["loss"] == w4[0]["dptp"]["loss"] for r in w4),
          f"parallel dptp: loss {[r['dptp']['loss'] for r in w4]} vs {tp_loss}, gradient "
          f"cosine {cos}")
    par_check_nshard(ph, w4, batch)
    launches["nshard"] = par_launch_counts(w4, "nshard")
    prob = [x.cuda().double() for x in dr.sqrt_ba_problem(64)]
    ref, info = tba.ba_step(tba.BAProblem(*prob), damping=1e-4)
    sq, _ = tba.sqrt_ba_step(tba.BAProblem(*prob), damping=1e-3)
    g = dr.pose_graph_problem()
    g = g._replace(**{k: v.cuda() for k, v in g._asdict().items()})
    pg, mean_r2 = tba.gauss_newton_step(g, damping=1e-6)
    pg2, _ = tba.optimize_pose_graph_two_stage(g, rot_iters=4, trans_iters=4, damping=1e-6)
    pts = lambda key: torch.cat([r[key]["points"] for r in w4])  # noqa: E731
    r0 = w4[0]
    errs = {"schur_accepted": bool(info["accepted"]),
            "schur_cost_rel": abs(r0["schur"]["cost"] - float(info["cost"])) / float(info["cost"]),
            "schur_poses": float((r0["schur"]["poses"] - ref.poses.cpu()).abs().max()),
            "schur_points_excess": float(((pts("schur") - ref.points.cpu()).abs()
                                          - PAR_BARS["schur_points"][1]
                                          - PAR_BARS["schur_points"][0]
                                          * ref.points.cpu().abs()).max()),
            "sqrt_poses": float((r0["sqrt"]["poses"] - sq.poses.cpu()).abs().max()),
            "sqrt_points": float((pts("sqrt") - sq.points.cpu()).abs().max()),
            "pg_poses": float((r0["pose_graph"]["poses"] - pg.poses.cpu()).abs().max()),
            "pg_cost_rel": abs(r0["pose_graph"]["cost"] - float(mean_r2) * g.edges.shape[0] * 6)
            / (float(mean_r2) * g.edges.shape[0] * 6),
            "pg_two_stage": float((r0["pose_graph"]["two_stage"] - pg2.poses.cpu()).abs().max())}
    ph.emit("parallel", path="ba", backend="gloo", ranks=4, errors=errs, bars=PAR_BARS,
            dtypes={"schur": "float64", "sqrt": "float64", "pose_graph": "float32"})
    check(errs["schur_accepted"] and errs["schur_cost_rel"] <= 1e-5
          and errs["schur_poses"] <= PAR_BARS["schur_poses"] and errs["schur_points_excess"] <= 0
          and errs["sqrt_poses"] <= PAR_BARS["sqrt_poses"]
          and errs["sqrt_points"] <= PAR_BARS["sqrt_points"]
          and errs["pg_poses"] <= PAR_BARS["pg_poses"] and errs["pg_cost_rel"] <= 1e-5
          and errs["pg_two_stage"] <= PAR_BARS["pg_two_stage"],
          f"parallel ba: against the one-device steps {errs}")

    # 4. The dry-run tool at 4 ranks (it starts its own world).
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "deepfepe_tpu_torch.tools.dryrun_multichip", "4",
                           "--backend", "gloo"], cwd=REPO, capture_output=True, text=True,
                          timeout=PAR_DRYRUN_TIMEOUT)
    dry_s = time.perf_counter() - t
    out_lines = proc.stdout.splitlines()
    summary = [ln for ln in out_lines if ln.startswith("dryrun_multichip(")]
    ranks = [json.loads(ln) for ln in out_lines if ln.startswith('{"rank"')]
    check(proc.returncode == 0 and len(summary) == 1 and len(ranks) == 4,
          f"parallel dryrun: exit {proc.returncode}: {proc.stdout[-1500:]}{proc.stderr[-1500:]}")
    launches["dryrun"] = [{k: v for k, v in r["launches"].items() if v}
                          for r in sorted(ranks, key=lambda r: r["rank"])]
    ph.emit("parallel", path="dryrun", summary=summary[0], launches=launches["dryrun"],
            seconds_of_command=dry_s)
    check(re.search(r"mesh=\(2x2\) .* nshard\[N=1000 ok\] .* sqrt_ba ok .* pose_graph ok", summary[0])
          is not None, f"parallel dryrun: {summary[0]}")
    check(all(c == PAR_EXPECTED["dryrun"] for c in launches["dryrun"]),
          f"parallel dryrun: launches a rank {launches['dryrun']}, "
          f"expected {PAR_EXPECTED['dryrun']}")
    return launches


def run_planted_parallel(ph: Phases, fault: str) -> int:
    """--plant nshard_drop_rank: the 4-rank world with the fault planted in
    its ranks, and the N-sharded fit's check; exits 1 when it caught it."""
    from deepfepe_tpu_torch.data import SyntheticPairs
    from deepfepe_tpu_torch.tools import dryrun_multichip as dr

    root = os.path.join(REPO, "logs", "smoke_parallel_plant")
    shutil.rmtree(root, ignore_errors=True)
    batch = SyntheticPairs(good_num=dr.FLAGSHIP_N, seed=0).batch(PAR_B)
    caught = []
    try:
        par_check_nshard(ph, par_world("w4", 4, root, plant=fault), batch)
    except CheckFailed as e:
        caught.append("parallel_nshard")
        print(f"chip_smoke: --plant {fault}: parallel_nshard failed: {str(e)[:300]}",
              file=sys.stderr, flush=True)
    ph.emit("plant", fault=fault, caught_by=caught)
    return 1 if caught else 0


# The SIFT frontend (S1 sift_extrema, S2a sift_orientation, S2b
# sift_descriptor in csrc/sift.cu; S3 knn2 in csrc/knn2.cu), which stands in
# for the JAX package's OpenCV SIFT and BFMatcher. The frames: the committed
# KITTI frame and two 376x1240 SyntheticImageSequence frames (seed 1, 400
# corners) with OpenCV's results at n_features 2000 and 300
# (tests/fixtures/sift, written by its make_fixtures.py).
SIFT_FIXTURES = os.path.join(REPO, "tests", "fixtures", "sift")
SIFT_DEVICE = "cuda"  # the card (a CPU rehearsal of the phase's host logic sets "cpu")
SIFT_FRAMES = ("kitti", "synthetic0", "synthetic1")
SIFT_N = (2000, 300)
SIFT_ROWS = {"sift_extrema": ("S1", "sift.cu", "deepfepe_tpu/data/dump_kitti.py:37"),
             "sift_orientation": ("S2a", "sift.cu", "deepfepe_tpu/data/dump_kitti.py:37"),
             "sift_descriptor": ("S2b", "sift.cu", "deepfepe_tpu/data/dump_kitti.py:37"),
             "knn2": ("S3", "knn2.cu", "deepfepe_tpu/data/dump_kitti.py:56")}
# The SIFT dump: 8 frames, S1, S2a and S2b once a frame, S3 once a pair.
SIFT_DUMP = {"frames": 8, "image_size": (376, 1240), "focal": 718.856, "n_corners": 400,
             "seed": 4}
# infer without --pretrained_SP: SIFT on both frames, one S3 match, the
# solver's five fits (eigh9 5) and four residual feedbacks (K3 4).
SIFT_INFER_LAUNCHES = {"sift_extrema": 2, "sift_orientation": 2, "sift_descriptor": 2,
                       "knn2": 1, "eigh9": 5, "epi_residual": 4}
# tools/dump_workflow at the full frame, cut in depth: 4 frames a train
# scene, 10 test frames, 2 F-loss steps.
SIFT_WORKFLOW_ARGS = ["--train_frames", "12", "--test_frames", "10", "--train_iter", "2",
                      "--image", "376", "1240", "--n_corners", "400"]
SIFT_WORKFLOW_FRAMES, SIFT_WORKFLOW_PAIRS = 3 * 4 + 10, 3 * 3 + 9
# Operations a window sample (S2a: the gradient, fastAtan2, the magnitude,
# the weight and its bin; S2b: the rotation, the gradient, fastAtan2, the
# magnitude, the weight and the eight trilinear shares), a tested DoG pixel
# (S1: 26 comparisons) and a refined candidate (S1: five Newton steps'
# differences and solves, about 150 each). Counted on FP32's 67 TFLOP/s.
SIFT_OPS = {"s2a_sample": 27, "s2b_sample": 63, "s1_pixel": 26, "s1_candidate": 750}
SIFT_INFER_BARS = {"matches_rel": 0.02, "R": 2e-3}


def sift_frames() -> dict:
    from deepfepe_tpu_torch.utils.image_io import read_grey

    return {f: read_grey(os.path.join(SIFT_FIXTURES, f"{f}.png")) for f in SIFT_FRAMES}


def sift_plain_route(img, n: int):
    """The plain twins composed as `detect_and_compute` composes the kernels,
    on the card's tensors."""
    import torch

    from deepfepe_tpu_torch.frontend import sift
    from deepfepe_tpu_torch.ops import sift as sift_ops

    with torch.no_grad():
        pyr = sift.build_pyramid(torch.as_tensor(img, device=SIFT_DEVICE))
        o = sift.orientation_plain(pyr, sift.extrema_plain(pyr))
        kp = sift.half_scale(o.kp[sift_ops.order_keypoints(o.kp, n)])
        return kp, sift.descriptor_plain(pyr, kp)


def window_bytes(pyr, octave, layer, cy, cx, radius) -> int:
    """4 x the pixels of the Gaussian layers that windows of `radius` (+1 for
    the gradients) around the keypoints cover, each pixel counted once."""
    import torch

    seen = torch.zeros(pyr.gauss.numel(), dtype=torch.bool, device=pyr.gauss.device)
    rows = torch.as_tensor(pyr.rows, device=seen.device)[octave]
    cols = torch.as_tensor(pyr.cols, device=seen.device)[octave]
    base = torch.as_tensor(pyr.g_off, device=seen.device)[octave] + layer * rows * cols
    for s in range(0, len(octave), 256):
        sl = slice(s, s + 256)
        R = int(radius[sl].max()) + 1
        off = torch.arange(-R, R + 1, device=seen.device)
        y = (cy[sl, None] + off[None]).clamp(min=0)
        x = (cx[sl, None] + off[None]).clamp(min=0)
        y = torch.minimum(y, rows[sl, None] - 1)
        x = torch.minimum(x, cols[sl, None] - 1)
        inside = off[None].abs() <= radius[sl, None] + 1
        idx = base[sl, None, None] + y[:, :, None] * cols[sl, None, None] + x[:, None, :]
        keep = inside[:, :, None] & inside[:, None, :]
        seen[idx[keep]] = True
    return 4 * int(seen.sum())


def sift_bounds(pyr, cands, oriented, kp, n1: int, n2: int) -> dict:
    """Each kernel's least time on the card for this frame's work: bytes
    (each input read once, each output written once) over 3.35 TB/s and
    operations over their route's peak, the larger of the two. S1-S2b:
    SIFT_OPS over 67 TFLOP/s (FP32). S3: the n1 n2 128 multiply-adds of
    |a|^2 + |b|^2 - 2 a.b (the norms are O(n)); descriptors hold integers
    0-255, so one pass of u8 tensor-core products with int32 sums (1,979
    TOP/s) is exact, the fastest exact route (one bf16 pass at 989 TFLOP/s
    is exact too; the pair's add and compare on the CUDA cores run beside
    it in less)."""
    import torch

    from deepfepe_tpu_torch.frontend import sift
    from deepfepe_tpu_torch.ops import sift as sift_ops

    def bound(nbytes, ops, peak=PEAK_FP32_FLOPS):
        b, o = nbytes / PEAK_BYTES_PER_S * 1e3, ops / peak * 1e3
        return {"bound_ms": max(b, o), "bound_by": "bytes" if b >= o else "operations"}

    octv = (cands.idx[:, 0] & 255).long()
    scl = cands.kp[:, 2] * 0.5 / torch.pow(2.0, octv.float())
    r_ori = torch.round(scl * 4.5).long()
    geo = sift.descriptor_geometry(pyr, kp)
    ori_samples = int(((2 * r_ori + 1) ** 2).sum())
    desc_samples = int(((2 * geo["radius"] + 1) ** 2).sum())
    return {
        "sift_extrema": bound(pyr.dog.numel() * 4 + len(cands) * 36,
                              SIFT_OPS["s1_pixel"] * sift_ops.tested_pixels(pyr)
                              + SIFT_OPS["s1_candidate"] * len(cands)),
        "sift_orientation": bound(window_bytes(pyr, octv, cands.idx[:, 1].long(),
                                               cands.idx[:, 2].long(), cands.idx[:, 3].long(),
                                               r_ori) + len(cands) * 36 + len(oriented) * 28,
                                  SIFT_OPS["s2a_sample"] * ori_samples),
        "sift_descriptor": bound(window_bytes(pyr, geo["oct"], geo["layer"], geo["cy"],
                                              geo["cx"], geo["radius"])
                                 + len(kp) * (24 + 512), SIFT_OPS["s2b_sample"] * desc_samples),
        "knn2": bound((n1 + n2) * 512 + n1 * 16, 2 * n1 * n2 * 128, PEAK_INT8_OPS),
    }


def sift_kernel_case(frames: dict, timed: bool) -> dict:
    """S1-S3 against their plain twins on the card's pyramid of each frame:
    S1 against its twin on the card, S2a and S2b against theirs on a host
    copy of the pyramid (on the card the twins sum their histograms with
    `scatter_add_`, whose atomics add in no fixed order, so a peak near
    0.8 of the maximum could come and go; on the CPU they sum in raster
    order, the kernels' order). With `timed`, each kernel and twin timed on
    synthetic1 (the most keypoints), beside its bound and yardstick."""
    import numpy as np
    import torch

    from deepfepe_tpu_torch.frontend import sift
    from deepfepe_tpu_torch.ops import knn2 as knn2_ops
    from deepfepe_tpu_torch.ops import sift as sift_ops

    errs = {k: 0.0 for k in SIFT_ROWS}
    detail, timing, descs = {}, {}, {}
    for name, img in frames.items():
        with torch.no_grad():
            pyr = sift.build_pyramid(torch.as_tensor(img, device=SIFT_DEVICE))
            c_k, c_p = sift_ops.sift_extrema(pyr), sift.extrema_plain(pyr)
            check(len(c_k) == len(c_p) > 0 and torch.equal(c_k.idx, c_p.idx),
                  f"sift {name}: S1's candidates {len(c_k)} against the plain twin's {len(c_p)}")
            e1 = float(((c_k.kp - c_p.kp).abs() / c_p.kp.abs().clamp(min=1e-30)).max())
            host = pyr.to("cpu")
            o_k = sift_ops.sift_orientation(pyr, c_p).to("cpu")
            o_p = sift.orientation_plain(host, c_p.to("cpu"))
            check(len(o_k) == len(o_p) and torch.equal(o_k.src, o_p.src),
                  f"sift {name}: S2a's keypoints {len(o_k)} against the twin's {len(o_p)}")
            da = (o_k.kp[:, 3] - o_p.kp[:, 3]).abs()
            e2 = float(torch.minimum(da, 360 - da).max()) if len(da) else 0.0
            kp = sift.half_scale(o_p.kp[sift_ops.order_keypoints(o_p.kp, 2000)])
            d_k = sift_ops.sift_descriptor(pyr, kp.to(SIFT_DEVICE)).cpu()
            d_p = sift.descriptor_plain(host, kp)
            diff = (d_k - d_p).abs()
            e3 = float(diff.max())
            same_rows = float((diff.amax(1) == 0).float().mean())
        check(e1 <= 1e-6 and e2 <= 1e-3 and e3 <= 1 and same_rows >= 0.99,
              f"sift {name}: kernels against plain twins: S1 rel {e1}, S2a {e2} deg, S2b {e3} "
              f"({same_rows} rows equal)")
        errs["sift_extrema"] = max(errs["sift_extrema"], e1)
        errs["sift_orientation"] = max(errs["sift_orientation"], e2)
        errs["sift_descriptor"] = max(errs["sift_descriptor"], e3)
        detail[name] = {"candidates": len(c_k), "oriented": len(o_k), "kept": len(kp),
                        "s2b_rows_equal": same_rows}
        descs[name] = d_p.to(SIFT_DEVICE)
        if timed and name == "synthetic1":
            timing = sift_timings(pyr, c_p, o_k.to(SIFT_DEVICE), kp.to(SIFT_DEVICE),
                                  descs["synthetic0"], descs[name])
    # S3 bit for bit on two frames' descriptors, then with planted ties.
    d1, d2 = descs["synthetic0"], descs["synthetic1"]
    tie = d2.clone()
    tie[255:258] = tie[100]
    q = torch.cat([tie[100:101].repeat(4, 1), d1])
    for a, b in ((d1, d2), (q, tie)):
        nn, dist = knn2_ops.knn2(a, b)
        nn_p, dist_p = knn2_ops.knn2_plain(a.cpu(), b.cpu())
        errs["knn2"] = max(errs["knn2"], float((dist.cpu() - dist_p).abs().max()))
        wrong = int((nn.cpu() != nn_p).sum())
        check(wrong == 0 and torch.equal(dist.cpu(), dist_p),
              f"sift: S3 differs from its plain twin ({wrong} indices, distances "
              f"{errs['knn2']} apart)")
    check(nn[0].tolist() == [100, 255], f"sift: S3's tie order {nn[0].tolist()}")
    return {"max_abs_err": errs, "frames": detail, "timing": timing}


def sift_timings(pyr, cands, oriented, kp, d1, d2) -> dict:
    """Kernel ms (CUDA events over back-to-back raw launches, counters
    untouched), the plain twin's ms, the yardstick's and the bound."""
    import torch

    from deepfepe_tpu_torch.frontend import sift
    from deepfepe_tpu_torch.ops import knn2 as knn2_ops
    from deepfepe_tpu_torch.ops import sift as sift_ops

    lib, klib = sift_ops._load(), knn2_ops._load()
    table = pyr.table()
    stream = torch.cuda.current_stream().cuda_stream
    cap = sift_ops.extrema_capacity(pyr)
    buf_kp = torch.empty((cap, 4), device=SIFT_DEVICE)
    buf_idx = torch.empty((cap, 5), dtype=torch.int32, device=SIFT_DEVICE)
    count = torch.zeros(1, dtype=torch.int32, device=SIFT_DEVICE)
    ocap = len(cands) * sift.MAX_PEAKS
    okp = torch.empty((ocap, 6), device=SIFT_DEVICE)
    osrc = torch.empty((ocap,), dtype=torch.int32, device=SIFT_DEVICE)
    des = torch.empty((len(kp), 128), device=SIFT_DEVICE)
    n1, n2 = d1.shape[0], d2.shape[0]
    nn = torch.empty((n1, 2), dtype=torch.int32, device=SIFT_DEVICE)
    dist = torch.empty((n1, 2), device=SIFT_DEVICE)
    scratch = torch.empty(klib.knn2_scratch_bytes(n1, n2), dtype=torch.uint8, device=SIFT_DEVICE)

    def s1():
        count.zero_()
        lib.sift_extrema(pyr.dog.data_ptr(), table.ctypes.data, pyr.n_octaves, buf_kp.data_ptr(),
                         buf_idx.data_ptr(), count.data_ptr(), cap, stream)

    def s2a():
        count.zero_()
        lib.sift_orientation(pyr.gauss.data_ptr(), table.ctypes.data, pyr.n_octaves,
                             cands.kp.data_ptr(), cands.idx.data_ptr(), len(cands), okp.data_ptr(),
                             osrc.data_ptr(), count.data_ptr(), ocap, stream)

    def s2b():
        lib.sift_descriptor(pyr.gauss.data_ptr(), table.ctypes.data, pyr.n_octaves,
                            kp.data_ptr(), len(kp), des.data_ptr(), stream)

    def s3():
        klib.knn2_f32(d1.data_ptr(), d2.data_ptr(), n1, n2, nn.data_ptr(), dist.data_ptr(),
                      scratch.data_ptr(), stream)

    def yard():
        torch.cdist(d1, d2).topk(2, dim=1, largest=False)

    with torch.no_grad():
        out = {"sift_extrema": {"ms": cuda_time_ms(s1, 20) - cuda_time_ms(count.zero_, 20),
                                "plain_ms": cuda_time_ms(lambda: sift.extrema_plain(pyr), 3),
                                "library_ms": None},
               "sift_orientation": {"ms": cuda_time_ms(s2a, 20) - cuda_time_ms(count.zero_, 20),
                                    "plain_ms": cuda_time_ms(
                                        lambda: sift.orientation_plain(pyr, cands), 3),
                                    "library_ms": None},
               "sift_descriptor": {"ms": cuda_time_ms(s2b, 20),
                                   "plain_ms": cuda_time_ms(
                                       lambda: sift.descriptor_plain(pyr, kp), 3),
                                   "library_ms": None},
               "knn2": {"ms": cuda_time_ms(s3, 50),
                        "plain_ms": cuda_time_ms(lambda: knn2_ops.knn2_plain(d1, d2), 10),
                        "library_ms": cuda_time_ms(yard, 50)}}
    bounds = sift_bounds(pyr, cands, oriented, kp, n1, n2)
    for k in out:
        out[k].update(bounds[k])
    out["shapes"] = {"candidates": len(cands), "oriented": len(oriented), "kept": len(kp),
                     "knn2": [n1, n2], "pyramid_octaves": pyr.n_octaves}
    return out


def sift_against_cv2(frames: dict) -> dict:
    """Both routes (the kernels, and the plain twins on the card) against
    OpenCV's committed results, at frontend.sift.PARITY_BARS."""
    import numpy as np

    from deepfepe_tpu_torch.frontend import sift

    out = {}
    for name, img in frames.items():
        for n in SIFT_N:
            z = np.load(os.path.join(SIFT_FIXTURES, f"{name}_{n}.npz"))
            want_kp, want_des = z["kp"], z["des"].astype(np.float32)
            for route, fn in (("kernels", lambda: sift.detect_and_compute(img, n, SIFT_DEVICE)),
                              ("plain", lambda: sift_plain_route(img, n))):
                kp, des = fn()
                r = sift.compare_keypoints(kp.cpu().numpy(), des.cpu().numpy(), want_kp,
                                           want_des)
                out[f"{name}_{n}_{route}"] = r
                check(r["ok"], f"sift {name} n={n} {route} route against OpenCV: {r}")
    return out


def sift_detect_ms(img, reps: int = 5) -> float:
    """Host ms a full `sift_detect` of one frame, warm, ending in a sync."""
    import torch

    from deepfepe_tpu_torch.data.dump_kitti import sift_detect

    sift_detect(img, 2000, device=SIFT_DEVICE)
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        sift_detect(img, 2000, device=SIFT_DEVICE)
        times.append((time.perf_counter() - t) * 1e3)
    return sorted(times)[reps // 2]


def sift_dump_run(root: str) -> tuple:
    """`dump_sequence` of SIFT_DUMP's frames (PNG) with exact launches;
    returns (launch counts, frames/s)."""
    import numpy as np
    import torch

    from deepfepe_tpu_torch.data import SyntheticImageSequence
    from deepfepe_tpu_torch.data.dump_kitti import dump_sequence
    from deepfepe_tpu_torch.utils.image_io import write_png

    seq = SyntheticImageSequence(n_frames=SIFT_DUMP["frames"],
                                 image_size=SIFT_DUMP["image_size"], focal=SIFT_DUMP["focal"],
                                 n_corners=SIFT_DUMP["n_corners"], seed=SIFT_DUMP["seed"])
    files = []
    for k in range(SIFT_DUMP["frames"]):
        files.append(os.path.join(root, f"frame_{k}.png"))
        write_png(files[-1], np.rint(seq.frame(k) * 255).astype(np.uint8))
    out = os.path.join(root, "00")
    reset_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    dump_sequence(files, seq.cam2world_poses(), seq.K, out, device=SIFT_DEVICE)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    counts = read_counts()
    n, pairs = SIFT_DUMP["frames"], SIFT_DUMP["frames"] - 1
    expected = {k: (n if k.startswith("sift_") else pairs if k == "knn2" else 0) for k in counts}
    check(counts == expected, f"sift dump: launches {counts}, expected {expected}")
    good = [np.load(os.path.join(out, f"ij_match_quality_{i}-{i + 1}_good.npy"))
            for i in range(pairs)]
    check(all(len(g) >= 100 and np.isfinite(g).all() for g in good),
          f"sift dump: good matches a pair {[len(g) for g in good]}")
    return counts, n / secs, [len(g) for g in good]


def sift_infer(root: str) -> tuple:
    """infer without --pretrained_SP on two JPEG frames with the flagship
    solver: launches around one call, the card against the CPU (the match
    count within 2%), and the CPU's solver on the card's matches (R within
    2e-3). Returns (launch counts, report)."""
    import numpy as np
    import torch

    from deepfepe_tpu_torch import cli

    paths, K = write_infer_frames(root)
    kw = dict(pretrained=FLAGSHIP_CKPT, K=f"{K[0, 0]},{K[1, 1]},{K[0, 2]},{K[1, 2]}",
              good_num=INFER["K"], device=SIFT_DEVICE)
    kept = {}
    real = cli.match_pair

    def keep(*a, **k):
        kept.setdefault("m", real(*a, **k))
        return kept["m"]

    reset_counts()
    cli.match_pair = keep
    try:
        out = cli.infer(*paths, **kw)
    finally:
        cli.match_pair = real
    torch.cuda.synchronize()
    counts = read_counts()
    t = time.perf_counter()
    cli.infer(*paths, **kw)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
    cpu = cli.infer(*paths, **{**kw, "device": "cpu"})
    cli.match_pair = lambda *a, **k: kept["m"]
    try:
        replay = cli.infer(*paths, **{**kw, "device": "cpu"})
    finally:
        cli.match_pair = real
    expected = {k: SIFT_INFER_LAUNCHES.get(k, 0) for k in counts}
    gaps = {"num_matches": abs(out["num_matches"] - cpu["num_matches"]),
            "R": float(np.abs(np.asarray(out["R"]) - np.asarray(cpu["R"])).max()),
            "replay_R": float(np.abs(np.asarray(out["R"]) - np.asarray(replay["R"])).max())}
    check(counts == expected, f"sift infer: launches {counts}, expected {expected}")
    check(out["frontend"] == "sift" and out["num_matches"] >= 8, f"sift infer: {out}")
    check(gaps["num_matches"] <= SIFT_INFER_BARS["matches_rel"] * cpu["num_matches"]
          and gaps["replay_R"] <= SIFT_INFER_BARS["R"],
          f"sift infer: card against CPU {gaps}")
    R = np.asarray(out["R"])
    check(np.abs(R @ R.T - np.eye(3)).max() < 1e-9 and all(
        np.isfinite(np.asarray(out[k])).all() for k in ("R", "t_unit", "E")),
        f"sift infer: not a pose {out}")
    return counts, {"result": out, "cpu_result": cpu, "card_vs_cpu": gaps, "ms": ms,
                    "bars": SIFT_INFER_BARS}


def sift_workflow(root: str) -> tuple:
    """tools/dump_workflow at 376x1240, cut in depth, with its launches."""
    import torch

    from deepfepe_tpu_torch.tools import dump_workflow

    reset_counts()
    t = time.perf_counter()
    summary = dump_workflow.main(["--out", os.path.join(root, "dw"), *SIFT_WORKFLOW_ARGS,
                                  "--device", SIFT_DEVICE])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    counts = read_counts()
    for k, want in (("sift_extrema", SIFT_WORKFLOW_FRAMES), ("sift_orientation",
                                                          SIFT_WORKFLOW_FRAMES),
                    ("sift_descriptor", SIFT_WORKFLOW_FRAMES), ("knn2", SIFT_WORKFLOW_PAIRS)):
        check(counts[k] == want, f"dump_workflow: {k} launched {counts[k]} times, not {want}")
    check(counts["eigh9"] > 0 and counts["epi_residual"] > 0,
          f"dump_workflow: the solver's kernels did not launch {counts}")
    ev = summary["eval_good"]
    check(ev["pairs"] == 9 and ev["median_err_q_gt"] < 1e-3 and math.isfinite(ev["median_err_q"])
          and all(math.isfinite(summary[k]["trans_err_pct"]) for k in ("vo_net", "vo_base")),
          f"dump_workflow: {summary}")
    return counts, {"seconds": secs, "eval_good": ev,
                    "vo_net": {k: summary["vo_net"][k] for k in ("trans_err_pct", "n_pairs")},
                    "vo_base": {k: summary["vo_base"][k] for k in ("trans_err_pct", "n_pairs")}}


def phase_sift(ph: Phases) -> dict:
    """The SIFT frontend on the card: S1-S3 against their plain twins, both
    routes against OpenCV's committed results, the kernels timed, a full
    frame's sift_detect timed, the SIFT dump of SIFT_DUMP's frames, infer
    without --pretrained_SP against the CPU, and tools/dump_workflow at
    376x1240. Returns (the kernel rows S1-S3, {path: launch counts})."""
    import tempfile

    frames = sift_frames()
    kernels = sift_kernel_case(frames, timed=True)
    parity = sift_against_cv2(frames)
    detect_ms = sift_detect_ms(frames["synthetic1"])
    with tempfile.TemporaryDirectory(prefix="smoke_sift_") as root:
        dump_counts, fps, good = sift_dump_run(root)
        infer_counts, infer_rep = sift_infer(root)
        wf_counts, wf_rep = sift_workflow(root)
    rows = []
    for name, (tag, src, replaces) in SIFT_ROWS.items():
        t = kernels["timing"][name]
        rows.append({"name": name, "kernel": tag, "route": "cuda",
                     "source": f"deepfepe_tpu_torch/csrc/{src}", "replaces": replaces,
                     "max_abs_err": kernels["max_abs_err"][name], "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                     "library": "torch.cdist + topk" if name == "knn2" else None})
    ph.emit("sift", kernels=kernels, parity={k: {m: v[m] for m in ("n_a", "n_b", "paired_a",
                                                                   "paired_b", "desc_rows",
                                                                   "desc_max", "xy_exact")}
                                             for k, v in parity.items()},
            sift_detect_ms_per_frame=detect_ms, frame="376x1240 (synthetic1), n_features 2000",
            dump={"launches": dump_counts, "frames_per_s": fps, "good_per_pair": good,
                  **SIFT_DUMP},
            infer={"launches": infer_counts, **infer_rep},
            dump_workflow={"launches": wf_counts, **wf_rep})
    return rows, {"sift_dump": dump_counts, "infer_sift": infer_counts,
                  "dump_workflow": wf_counts}


ALONE_PHASES = {"eval_vo_ba": phase_eval_vo_ba, "eval_good_ba": phase_eval_good_ba,
                "bench_ba": phase_bench_ba, "vo_pose_graph": phase_vo_pose_graph,
                "sp_train": phase_sp_train, "sp_finetune": phase_sp_finetune,
                "sp_homography": phase_sp_homography, "check_sp": phase_check_sp,
                "joint_full": phase_joint_full, "joint_ckpts": phase_joint_ckpts,
                "vo_superpoint": phase_vo_superpoint, "des_fusion": phase_des_fusion,
                "dsac": phase_dsac, "jpeg": phase_jpeg, "kitti_sp_dump": phase_kitti_sp_dump,
                "infer": phase_infer, "val_feature_s2d": phase_val_feature_s2d,
                "val_pipeline": phase_val_pipeline, "parallel": phase_parallel,
                "sift": phase_sift}


def plant(fault: str) -> None:
    """Install a deliberate fault for `--plant`. Wiring faults wrap the MLP
    autograd Function's backward; kernel faults (SOURCE_FAULTS) build a
    copy of a csrc source with one line changed and bind it in place of the
    module's library."""
    import torch

    from deepfepe_tpu_torch.ops import mlp

    if fault == "none":
        return
    if fault in SOURCE_FAULTS:
        plant_source(fault)
        return
    backward = mlp.FusedPointNetMLP.backward

    def faulty(ctx, g):
        grads = list(backward(ctx, g))
        L = ctx.L
        if fault == "dx_zero":
            grads[0] = torch.zeros_like(grads[0])
        else:
            dg, db = grads[5 + L:5 + 2 * L], grads[5 + 2 * L:]
            grads[5 + L:] = db + dg
        return tuple(grads)

    mlp.FusedPointNetMLP.backward = staticmethod(faulty)


def plant_source(fault: str) -> None:
    """A module's csrc source built from a copy with SOURCE_FAULTS[fault]'s
    line changed, bound in place of its library."""
    import ctypes
    import importlib
    import tempfile

    from deepfepe_tpu_torch.utils import build

    name, line, changed = SOURCE_FAULTS[fault]
    mod = importlib.import_module(f"deepfepe_tpu_torch.ops.{name}")
    src = (build.CSRC / mod.SOURCE).read_text()
    check(src.count(line) == 1, f"--plant {fault}: the line to change is not in {mod.SOURCE}")
    tmp = tempfile.mkdtemp(prefix=f"{name}_fault_")
    cu, so = os.path.join(tmp, mod.SOURCE), os.path.join(tmp, f"{name}.so")
    with open(cu, "w") as f:
        f.write(src.replace(line, changed))
    subprocess.run([build.find_nvcc(), *build.flags(mod.SOURCE), "-o", so, cu], check=True,
                   capture_output=True)
    mod._lib = mod.bind(ctypes.CDLL(so))


def run_planted(ph: Phases, fault: str) -> int:
    """The checks of the planted kernel with `fault` planted (the MLP checks
    for K2/K2b faults, the K3 checks for K3's, the X1-X4 checks for
    conv_formulations.cu's, the K5 and K5b kernel checks for conv3x3.cu's,
    the K4 or eigh9 kernel checks for theirs; all of them for 'none'): every check runs and reports; exits 1 when any of
    them caught the fault, 0 when none did."""
    if fault == "nshard_drop_rank":
        return run_planted_parallel(ph, fault)
    plant(fault)
    caught = []
    mlp_checks = (("kernels_c_in_5", lambda: mlp_kernel_errors(ph, 5)),
                  ("kernels_c_in_8", lambda: mlp_kernel_errors(ph, 8)),
                  ("check_train", lambda: phase_check_train(ph)))
    epi_checks = (("kernels_epi", lambda: phase_epi_kernel(ph)),
                  ("check_sample", lambda: phase_check_sample(ph)))
    xconv_checks = (("kernels_xconv", lambda: phase_xconv_kernels(ph)),
                    ("conv_formulations", lambda: phase_conv_formulations(ph)))
    by_module = {"mlp": mlp_checks, "epi_residual": epi_checks,
                 "conv_formulations": xconv_checks,
                 "conv": (("kernels_k5", lambda: phase_conv_kernel(ph)),
                          ("kernels_k5b", lambda: phase_conv_bwd_kernel(ph))),
                 "conv_bf16": (("kernels_k5_bf16", lambda: phase_conv_bf16_kernels(ph)),),
                 "matcher": (("kernels_k4", lambda: phase_matcher_kernel(ph)),),
                 "eigh9": (("kernels_eigh9", lambda: phase_kernels(ph)),)}
    chosen = (sum(by_module.values(), ()) if fault == "none" else
              by_module[SOURCE_FAULTS[fault][0]] if fault in SOURCE_FAULTS else mlp_checks)
    for name, fn in chosen:
        try:
            fn()
        except CheckFailed as e:
            caught.append(name)
            print(f"chip_smoke: --plant {fault}: {name} failed: {str(e)[:300]}",
                  file=sys.stderr, flush=True)
    ph.emit("plant", fault=fault, caught_by=caught)
    return 1 if caught else 0


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--plant", choices=FAULTS, help="plant this fault and run only the checks "
                    "of its kernel (K2/K2b, K3, X1-X4, K5/K5b, K4 or eigh9), to show that they catch it "
                    "(exit 1 when caught); 'none' gives the sound readings")
    ap.add_argument("--window", help="a JSON list [name, *args]: run WINDOWS[name](*args), "
                    "one profiled window, and print its JSON result (fresh_window)")
    ap.add_argument("--phases", help="a comma list of ALONE_PHASES to run by themselves after "
                    "the build (a quicker look at those paths; no kernels line)")
    ap.add_argument("--parallel-rank", help="a JSON spec: run one rank of a parallel-phase "
                    "world (parallel_rank)")
    ap.add_argument("--fresh-windows", action="store_true",
                    help="take every profiled window that a check reads again in a fresh "
                    "process (fresh_window), to exercise each retake")
    args = ap.parse_args(argv)
    global FRESH_WINDOWS
    FRESH_WINDOWS = args.fresh_windows
    sys.path.insert(0, REPO)
    from deepfepe_tpu_torch.train.config import config_from_dict

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if args.parallel_rank:
        return parallel_rank(json.loads(args.parallel_rank))

    # Full-precision f32 matmuls on the card, as on the CPU.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    ph = Phases()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    ph.emit("device", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
            name=torch.cuda.get_device_name(0), count=torch.cuda.device_count())

    os.chdir(REPO)  # train_good writes under logs/ (gitignored)
    if args.window:
        name, *window_args = json.loads(args.window)
        print(json.dumps(WINDOWS[name](*window_args)), flush=True)
        return 0
    if args.plant:
        build_all(ph)
        return run_planted(ph, args.plant)
    if args.phases:
        try:
            build_all(ph)
            for name in args.phases.split(","):
                ALONE_PHASES[name](ph)
        except CheckFailed as e:
            print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
            return 1
        return 0
    try:
        build_all(ph)
        phase_jpeg(ph)
        row = phase_kernels(ph)
        mlp_rows = phase_mlp_kernels(ph)
        front_rows = [phase_conv_kernel(ph), phase_matcher_kernel(ph)]
        bwd_row = phase_conv_bwd_kernel(ph)
        epi_rows = phase_epi_kernel(ph)
        xconv_rows = phase_xconv_kernels(ph)
        bf16_rows = phase_conv_bf16_kernels(ph)
        cfg = config_from_dict(BASELINE)
        eval_counts = phase_eval_good(ph, cfg)
        phase_breakdown(ph, cfg)
        train_counts = phase_train_good(ph)
        sample_counts = phase_sample_train(ph)
        variant_counts = phase_variants(ph)
        xconv_counts = phase_conv_formulations(ph)
        vf_counts = phase_val_feature(ph)
        vf_s2d_counts = phase_val_feature_s2d(ph)
        phase_frontend_breakdown(ph)
        joint_counts = phase_joint_train(ph)
        phase_joint_step_times(ph)
        joint_bf16_counts = phase_joint_bf16(ph)
        phase_joint_bf16_step(ph)
        kitti_counts = phase_kitti_corr(ph)
        sp_dump_counts = phase_kitti_sp_dump(ph)
        vo_counts = phase_eval_vo(ph)
        infer_counts = phase_infer(ph)
        vp_counts = phase_val_pipeline(ph)
        sift_rows, sift_counts = phase_sift(ph)
        vo_ba_counts = phase_eval_vo_ba(ph)
        eval_good_ba_counts = phase_eval_good_ba(ph)
        phase_bench_ba(ph)
        vopg_counts = phase_vo_pose_graph(ph)
        sp_train_counts = phase_sp_train(ph)
        sp_finetune_counts = phase_sp_finetune(ph)
        sp_h_counts = phase_sp_homography(ph)
        jf_counts = phase_joint_full(ph)
        jc_counts = phase_joint_ckpts(ph)
        vosp_counts = phase_vo_superpoint(ph)
        des_counts = phase_des_fusion(ph)
        dsac_counts = phase_dsac(ph)
        par_counts = phase_parallel(ph)
        phase_check_sp(ph)
        phase_check(ph, cfg)
        phase_check_train(ph)
        phase_check_sample(ph)
        phase_check_frontend(ph)
        phase_check_joint(ph)
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    rows = [row, *mlp_rows, *front_rows, bwd_row, *epi_rows, *xconv_rows, *bf16_rows, *sift_rows]
    # Each kernel's launches on the path that carries it: train_good for
    # eigh9 and the MLP pair, val_feature (a) + (b) for K5 and K4,
    # joint_train (stages 1 + 2) for K5b, the sample-loss train_good for K3,
    # the conv-formulation tool for X1-X4, joint_bf16 (its three runs) for
    # the bf16 K5 and K5b, the SIFT dump for S1-S3.
    for r in rows:
        path, counts = (("val_feature", vf_counts) if r in front_rows
                        else ("sift_dump", sift_counts["sift_dump"]) if r in sift_rows
                        else ("joint_train", joint_counts) if r is bwd_row
                        else ("joint_bf16", joint_bf16_counts) if r in bf16_rows
                        else ("sample_train", sample_counts) if r in epi_rows
                        else ("conv_formulations", xconv_counts) if r in xconv_rows
                        else ("train_good", train_counts))
        r["launches"] = counts[r["name"]]
        r["launches_path"] = path
        r["launches_eval_good"] = eval_counts[r["name"]]
        r["launches_train_good"] = train_counts[r["name"]]
        r["launches_variants"] = variant_counts[r["name"]]
        r["launches_joint_train"] = joint_counts[r["name"]]
        r["launches_conv_formulations"] = xconv_counts[r["name"]]
        r["launches_kitti_corr"] = kitti_counts[r["name"]]
        r["launches_kitti_sp_dump"] = sp_dump_counts[r["name"]]
        r["launches_joint_bf16"] = joint_bf16_counts[r["name"]]
        r["launches_eval_vo"] = vo_counts[r["name"]]
        r["launches_infer"] = infer_counts[r["name"]]
        r["launches_val_feature_s2d"] = vf_s2d_counts[r["name"]]
        r["launches_val_pipeline"] = vp_counts[r["name"]]
        r["launches_eval_vo_ba"] = vo_ba_counts[r["name"]]
        r["launches_eval_good_ba"] = eval_good_ba_counts[r["name"]]
        r["launches_vo_pose_graph"] = vopg_counts[r["name"]]
        r["launches_sp_train"] = sp_train_counts[r["name"]]
        r["launches_sp_finetune"] = sp_finetune_counts[r["name"]]
        r["launches_sp_homography"] = sp_h_counts[r["name"]]
        r["launches_joint_full"] = jf_counts[r["name"]]
        r["launches_joint_ckpts"] = jc_counts[r["name"]]
        r["launches_vo_superpoint"] = vosp_counts[r["name"]]
        r["launches_des_fusion"] = des_counts[r["name"]]
        r["launches_dsac"] = dsac_counts[r["name"]]
        r["launches_sift_dump"] = sift_counts["sift_dump"][r["name"]]
        r["launches_infer_sift"] = sift_counts["infer_sift"][r["name"]]
        r["launches_dump_workflow"] = sift_counts["dump_workflow"][r["name"]]
        # Each parallel path's launches of this kernel, one entry a rank.
        r["launches_parallel"] = {path: [c.get(r["name"], 0) for c in ranks]
                                  for path, ranks in par_counts.items()}
        if r["launches"] <= 0:
            print(f"chip_smoke: FAILED: {r['name']} never launched on {path}",
                  file=sys.stderr, flush=True)
            return 1
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
