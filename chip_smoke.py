#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's main paths at full width (``adversarial_learning_
on_pointclouds_tpu_torch``: the classifier's configs 1, 2 and 5 (phase
22), the adversarial trainer's ablation controls and batching knobs
(phase 23), serving the part segmenter, its config-3
training step, the config-4 adversarial G+D step in fp32, the G+D step
as the JAX package's ``bench.py`` runs it: bf16 mixed precision,
``augment_fused``, K = 8 steps per call; and the config-3 and bench
steps under ``use_pallas_train``, ``bench.py --pallas_train``, the G+D
step under it at N=2500 too; the discriminator's inference chain; 50
parts, feature transform on) and holds each hand-written kernel against
its plain PyTorch version.
Phases, one or more lines each:

1. device: CUDA must be available; the card's name and power limit;
2. build: the kernels compile from ``csrc/`` (nvcc, sm_90a);
3. kernels: each eval kernel against its plain version at the serving
   shapes (B=32, N=2500), at a ragged point count and at batch 1, the
   trunk's stack also with its last layer's folded scales negative in
   every other channel; conv1 (``fused_linear_affine_act``) also at its
   paths' other widths (``CONV_WIDTHS``: c_in 3 and 64, c_out 64 and 50)
   at B=32 N=2047 and B=1 N=37, and at the main shape and 64 -> 64 by the
   float64 control; at B=32 N=2500 ``fused_stack_maxpool`` and
   ``seg_head_fused`` (on the tensor cores) also by the float64 control:
   each stack's pre-max values on 512 points (each a cloud of its own, so
   the max is the value) and the head's log-probs at most
   ``F64_FACTOR`` times the plain fp32 pass's error, where the plain pass
   with TF32 allowed must fail;
4. slice: a seeded segmenter with random BatchNorm statistics is saved as
   a ``.pth``, served through ``infer.main`` once and through
   ``Predictor.predict`` over 4 batches of 32 clouds, compared with the
   CPU, with the eval kernels' launches checked (3 / 1 / 1 per forward);
5. timing: each eval kernel against its plain version (CUDA events and
   torch.profiler device time; the tensor-core ones bound at the 3xTF32
   rate, the fp32-FMA bound beside it) and the serving forward, whose
   profile must show ``stack_tc_kernel``, ``head_tc_kernel`` and conv1's
   ``conv_group_kernel<3>`` and none of the kernels they replaced
   (``GONE_KERNELS``);
6. train-kernels: every training pass (trunk F1/F2/B1, seg head
   P1/Pmid/P4/B4/Bmid/B1, the pool-fc epilogue at groups 1 and 2, at B=2
   and in ``relu_fc_bn_relu``'s identity fold; in fp32 its z1 and var by
   the float64 control, with a TF32 control on z1 that must fail)
   against its plain pass at B=32 N=2048 (the config-3 step), B=32
   N=2500 (ragged) and B=2 N=2048, on inputs with negative BN3 gammas and
   duplicated points (max ties go to the first point), the seg head's P1
   and P4 also at N=2047 (rows off a 16-byte boundary); trunk F1, F2 and
   B1 and all six seg head passes (on the tensor cores,
   ``csrc/train_bwd_tc.cu``) also, in fp32, held by the float64 control
   (F1's z2, F2's sum and sum of squares, P1's z1, Pmid's z, P4's logits
   (each row less its mean) and logp, B4's dy3 and dW4, dy_prev, dpf and
   dW at most ``F64_FACTOR`` times the plain fp32 pass's error), where the
   plain pass with TF32 allowed must fail; then each autograd
   function's outputs and gradients against its whole-function plain
   reference;
7. train-slice: ``train_step`` of a seeded full-width segmenter with
   random BatchNorm statistics on one batch of 32 x 2048, on the card and
   on the CPU from the same weights: loss, log-probs, every gradient and
   every new running statistic compared; the training kernels' launches
   checked per step; then 10 Adam steps on the fixed batch must lower
   the loss;
8. train-timing: each training pass against its plain pass (TFLOP/s;
   the tensor-core passes, ``TC_PASSES``, bound at the 3xTF32 rate, the
   fp32-FMA bound beside it), the step's median time, points/s and the
   profiler's busy share;
9. disc-kernels: every discriminator pass (fwd, bwd_dx, bwd_dw, the full
   bwd; all on the tensor cores, ``csrc/disc_tc.cu``) against its plain
   pass at B=32 N=2048 (and the D step's 2B=64), B=32 N=2500 (ragged)
   and B=2. The logits (``check_disc_fwd``) against the plain twin, in
   fp32 also by the float64 control with a TF32 control that must fail. The backward passes
   (``check_disc_dw``) whole pass from x to their plain twin (dW, db,
   dx; with the pass's LeakyReLU branch where the two differ, each such
   flip counted and required to lie within the bound of zero; with none,
   the twin unchanged), and product by product on the full pass's own
   operands (every h and dz of its row pass, dx, dW and db against the
   plain PyTorch product; in fp32 each also by the float64 control, with
   TF32 controls on dW4 and dx that must fail); ``bwd_dx``'s dx bit-equal
   to the full pass's; then each ``FCDiscriminator`` autograd method
   against the whole stack composed in plain PyTorch;
10. adv-slice: the config-4 ``adversarial.train_step`` of a seeded
   full-width G (random BatchNorm statistics) and D on one batch of 2 x
   32 x 2048, on the card and on the CPU from the same weights: every
   metric, G and D gradient and new running statistic compared, the semi
   mask held to the CPU's; every kernel's launches checked per step; then
   10 steps on the fixed batch must lower the supervised loss;
11. adv-timing: each discriminator pass against its plain pass (bound at
   the 3xTF32 rate, the fp32-FMA bound beside it, with their
   sub-kernels' launches and times and for dW the scratch's GB/s), the
   G+D step's median time, points/s (both streams) and busy share (its
   profile held as phase 14's), and the discriminator family's FLOP/s;
12. bench-kernels: every training and discriminator pass in bf16 against
   its bf16 plain twin at the shapes of phases 6 and 9 (bf16 stashes may
   sit one bf16 step apart where the two sum in another order: the share
   that differs is printed, and F1's z2, Pmid's z and B4's dy3 may
   differ in at most ``STASH_SHARE`` of their elements, which each
   rounded toward zero must fail; the disc's dW5 takes the pass's own rounding
   of h4, ``pass_h4``, itself held to one bf16 step of the twin's with at
   most ``STASH_SHARE`` of it apart; a dW5 of the unrounded h4 and an h4
   rounded toward zero must fail); ``trunk2_train(groups=2)``'s
   passes at 2B=64 against their plain twins and against two groups=1
   launches (pooled values, statistics and extrema bit-equal);
   ``augment_fused`` against
   its plain twin on the same Philox bits at B=32 N=2048/2500/2047, its
   distribution (angle, jitter, dropout ratio), and another step, seed
   and stream; ``augment_fused_pair`` (both streams in one launch, the
   bench step's) bit for bit against two single-stream launches and
   against its plain twin, also with streams of two shapes;
13. bench-slice: the G+D step of ``AdversarialConfig(augment=True,
   bf16=True, pallas_augment=True)`` (paired heads), and again with
   ``paired_trunks``, on the card and on the CPU from the same weights and
   batch (the Philox augmentation is the same on both), as phase 10 with
   the bounds widened for bf16; launches per step (augment 1, the pair;
   F1/F2/B1 6, or 3 with the paired trunks); ``train_steps_scan`` at K=8
   against 8 ``train_step`` calls on the card;
14. bench-timing: each pass in bf16 against its plain pass (with its
   bound at the tensor cores' bf16 peak; the disc's with their
   sub-kernels and the forward's two tile sizes), ``augment_fused`` and the
   groups=2 passes, and the bench step through ``train_steps_scan`` (K=8:
   per-step ms, points/s of both streams, idle share), one step per call,
   with ``paired_trunks`` and without ``pallas_augment``; the bench
   step's profile, with and without ``paired_trunks``, must show
   ``head_p1_tc_kernel``, ``pmid_tc_kernel``, ``head_p4_tc_kernel``,
   ``head_b1_tc_kernel``, ``f1_tc_kernel``, ``b4_tc_kernel``,
   ``fc_tc_kernel`` (pool-fc) and ``augment_pair_kernel`` and none of the
   kernels they replaced (``GONE_KERNELS``, the ``row_fwd_kernel``,
   ``pool_fc_kernel`` and the one-stream ``augment_kernel`` among them),
   as must phase 11's fp32 G+D step's (but the augmentation, which it
   does not run);
15. pallas-train-kernels: the per-layer training kernels that
   ``dispatch.use_pallas_train`` (the JAX package's
   ``use_pallas(training=True)``) reaches, each pass against its plain
   pass at B=32 N=2048, B=32 N=2500 (ragged), B=2 and 3B=96 N=2500 (the
   discriminator's stacked pass, 240,000 rows): ``pointwise_matmul``
   (forward and dx in fp32 and bf16 at every width of the generator and
   the discriminator, 3 -> 64 up to 128 -> 1024 and 50 -> 64 down to
   512 -> 1, dW/db), ``tnet_apply`` at k=3 (streaming) and 64 (the GEMM
   core), each fp32 pass of both also held by the float64 control: its
   max error against the float64 product at most ``F64_FACTOR`` (2) times
   the plain fp32 pass's (cuBLAS with TF32 off), and ``torch.matmul``
   with TF32 on at K=1024 must fail that control (the flag restored
   after); ``maxpool_points`` on duplicated points (bit-equal, one winner
   per channel, the first), ``fc_head_train`` at k=3 and 64 in fp32 and
   bf16 (at B=32 in fp32 its forward's z1, z2, var1, var2 and its
   backward's dh, dw1, dw2 by the float64 control, with TF32 controls on
   z1 and dh that must fail); then each autograd function against its
   whole-function reference;
16. pallas-train-slice: the config-3 ``train_step`` under the switch at
   B=32 N=2048 (the fused trunks and seg head, the four kernels on conv1,
   the transforms and the fc heads) and N=2500 (every layer through
   ``pointwise_matmul``, ``maxpool_points``), and the bench G+D step under
   it (``bench.py --pallas_train``), card against CPU as phases 7 and 13,
   launches per step checked;
17. pallas-train-timing: each new pass over the calls of the N=2500 step
   (and the bench step's, bf16) against its plain pass and one PyTorch
   call computing the same product where there is one (``library_ms``),
   with its bound and achieved TFLOP/s, each also in device time alone;
   the GEMM core's fp32 passes bound at the 3xTF32 rate (495 / 3
   TFLOP/s), with the bound at the fp32 FMA rate beside it
   (``bound_fma_ms``), and the three largest shapes of each pass, fp32
   and the bench step's, timed alone (events and device time, GB/s); the
   config-3 steps at N=2048 and 2500 and the bench step at K=8, off and
   under the switch in turns;
18. stack-trunk3-kernels: ``fused_mlp_stack`` against its plain version
   on the discriminator's chain at the serving shapes (B=32 N=2500), a
   ragged N and B=1, and on a 3 -> 64 -> 128 -> 1024 ReLU chain with
   non-unit scales, in fp32 and bf16; ``trunk3_train`` at STN3d's and
   STNkd's widths (c_in 3 and 64) at B=32 N=2048, N=2500 and B=2, on
   duplicated points with negative BN3 gammas: each of its six passes
   against its plain pass (F1, Pmid and the head's B1 in fp32 also by
   the float64 control, with TF32 controls at c_in 64, B=32 N=2048), then
   its outputs and 13 gradients against
   ``trunk3_train_reference`` and against conv1 + BN1 + ReLU in front of
   ``trunk2_train``;
19. adv-pallas-slice: the config-4 G+D step at 2 x B=32 x N=2500 under
   the switch (``bench.py --pallas_train --points 2500``: the
   discriminator layer by layer through ``pointwise_matmul``, no known
   logits), in fp32 and in the bench configuration, card against CPU as
   phase 16, launches per step checked, ``train_steps_scan`` at K=8
   launching 8 x as many; 10 steps on the fixed batch lower the
   supervised loss; ``FCDiscriminator.infer`` on the served segmenter's
   probabilities (B=32 N=2500) against ``forward`` and the CPU, one
   ``fused_mlp_stack`` launch; ``trunk3_train`` on its own at STN3d's
   shapes (its six passes, once each);
20. adv-pallas-timing: ``fused_mlp_stack`` and ``trunk3_train`` (forward
   and backward) against their plain versions with their bounds; the
   config-4 step at N=2500 off and under the switch in turns, in fp32
   (one step per call) and as the bench step (K=8);
21. runner: the training runs end to end (``train/runner.py``) on a
   synthetic pts fixture of 704 shapes x 2048 points (528 train, 88
   test; its writing timed): ``run_segmentation`` for two epochs at B=32
   (feature transform, device pools, ``ckpt_policy`` every, eval every
   epoch) with the CSV headers of the JAX package's ``MetricLogger``, the
   training kernels' launches per step as phase 7's and the eval
   kernels' 1 / 3 / 1 per forward, 3 forwards an eval; the epoch-1
   checkpoint evaluated on the CPU (instance mIoU and every category
   within 1e-3 of the card's, at most 2 of 88 shapes' IoUs apart, each
   by an argmax flip within rounding); ``--resume_full`` from the epoch-0
   checkpoint repeating epoch 1 (per-step losses within 1e-5, steps
   continuing); ``--host_data`` against device pools (within 1e-6);
   ``run_adversarial`` for one epoch with the bench flags (``--bf16
   --pallas_augment --paired_trunks --scan 8``: 8 G+D steps, one
   ``augment_fused_pair`` launch a step, the G's eval on the eval
   kernels); ``eval_segmentation --model`` on the seg run reproducing its
   last eval; each epoch's train_s, eval_s and ckpt_s, eval shapes/s, an
   eval pass's host-to-host and device time, and the host's share of an
   epoch (the resumed run's epoch 1: its wall time
   less the device's busy time in one torch.profiler window). The phase
   must finish within 120 s;
22. classify: the classification configs at full width (B=32, N=1024,
   40 classes; a seeded ``PointNetCls`` with random BatchNorm
   statistics), card against CPU: the config-1 and config-2
   (``--feature_transform --augment --pallas_augment``) ``classify.
   train_step`` in fp32 and bf16 (the CPU's step with the card's dropout
   masks, ``MaskReplay``; bf16 bounds widened as phase 13's), launches
   per step (trunk F1/F2/B1 2 and pool-fc 1, or 3 and 2 and one
   ``augment_fused``; no serving kernel), 10 more steps lowering the
   loss; config 5's step, FGSM and PGD-3 (``adv_step_check``: each
   attack iterate's input gradient and next cloud against the CPU's at
   the card's cloud, by the sign-flip rule, the update on the card's
   perturbed clouds; no kernel inside the attack); a grad-enabled eval
   forward outside the attack raising on the card; each step's median
   ms, points/s and idle share; the eval forward of both configs within
   1e-4 of the CPU (fused_linear_affine_act 1, fused_stack_maxpool 2 or
   3 a forward) and its shapes/s; ``infer --model cls`` from a saved
   ``.pth`` and ``Predictor.predict``, card against CPU; then
   ``run_classification`` (config 2's flags, two epochs) and
   ``run_adv_perturb`` (one epoch) on the in-memory ModelNet40 fixture
   (the JAX package's: 64 train and 32 test shapes of 2048 points, cut
   from ModelNet40's 9,843 and 2,468), their launches, and
   ``eval_classification`` and ``eval_robustness`` (eps 0) reproducing
   each run's last eval. The phase must finish within 90 s;
23. ablation: the JAX package's ablation controls and batching knobs
   (``supervised_only``, ``self_training``, ``d_geometry``,
   ``paired_conv1``, ``fused_forward``). The four disc passes at D's
   ``d_geometry`` width, k=53 (rows of 212 bytes), at B=32 and 2B=64
   N=2048, held as phases 9 and 12 hold them at k=50: the plain twin, in
   fp32 the float64 control with TF32 controls that must fail, in bf16
   the pass's own h4; their times and bounds (the kernels line's
   ``disc_fused (d_geometry, k=53)``). Each knob's G+D step with the
   bench flags (``augment``, ``pallas_augment``) at 2 x B=32 x N=512,
   card against CPU from the same weights and batch, in fp32 at phase
   10's bounds and in bf16 at phase 13's, launches per step
   (``KNOB_PER_STEP``: no disc launch under either control), and D
   bit-untouched under the controls (parameters, gradients, Adam moments,
   schedule; ``loss_d`` 0). The bench step by default, with
   ``paired_conv1`` and with ``fused_forward``, timed in turns (median,
   idle share). ``ablation_adversarial_gain --quick`` on the card, modes
   sup adv geo st. The phase must finish within 90 s.

The line before the last is a JSON object of the kernels' numbers: per
kernel its time, its plain version's, and its bound (``bound_ms``: the
larger of its inputs and outputs over the memory rate and the matmul
FLOPs of its plain version, counted by ``torch.utils.flop_counter``,
over the fp32 peak, or for the fp32 kernels on the tensor cores over the
3xTF32 rate with ``bound_fma_ms`` beside it; elementwise work is not
counted); the training and
discriminator passes also carry their bf16 numbers (``bf16_*``, the bound
at the bf16 tensor-core peak). The last line is
``{"ok": true, "device": {...}}``. Any failure raises: the exit code is
non-zero and no result is printed.

    python3 chip_smoke.py

``--runner`` runs only phases 1-2 and 21 and prints no result line;
``--classify`` only phases 1-2 and 22; ``--ablation`` only phases 1-2
and 23.

``--disc-checks SEED`` runs only phases 1-2 and the discriminator's
checks of phases 9 and 12 on data from generator seed ``SEED``, and
prints no result line.

``--time fp32|bench|pallas_train [--root DIR]`` runs only the G+D step's
timing of phase 11, 14 or 17 (the bench step under the switch), on the
port package under ``DIR`` (``time_alone``), for A/B runs of two trees on
one card; ``--time passes`` times the seg head's P1, Pmid, P4, B1 and
B4, trunk F1 (groups 1 and 2), the pool-fc epilogue (groups 1 and 2) and
``fc_head_train``'s forward and backward alone, fp32 and bf16; ``--time
serve`` the
serving kernels (B=32 N=2500: the three stacks of a forward and the seg
head, events and device time), the segmenter's forward and
``Predictor.predict``. They check nothing and print no result line.
"""

import contextlib
import copy
import dataclasses
import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from contextlib import redirect_stdout

import numpy as np
import torch

SEED = 0
B, N, PARTS = 32, 2500, 50
RAGGED_N = 2047
TRAIN_N, TRAIN_RAGGED_N = 2048, 2500
BOUND = 1e-4          # scale-relative: max|a - b| / max(1, max|b|)
# Autograd functions against their whole-function references, a
# different algorithm (two-pass moments, BN applied unfolded): relative
# L2 error. Where a ReLU input or a channel's top two points sit within
# rounding of each other, the two algorithms switch differently and move
# whole gradient elements; at B=32 N=2048 a handful of such flips in the
# head's 59 M ReLU inputs make dpf's relative L2 error about 1e-3 (H100,
# 700 W). With the BN statistic-gradient terms of dz left out of the
# backward, the same inputs read 0.12 (the trunk's dx) to 11 on the input
# and weight gradients (H100, 700 W);
# tests/test_torch_train_kernels.py plants that fault on the CPU.
WHOLE_BOUND = 1e-2
STEP_BOUND = 5e-3     # model level, as tests/test_kernels.py (batch-axis BN)
GRAD_BOUND = 2e-2     # model-level gradients: 2e-2 * (1 + max|g|)
REPS = 20
KERNELS_ROOT = "adversarial_learning_on_pointclouds_tpu_torch"
TPU_KERNELS = "adversarial_learning_on_pointclouds_tpu/ops/kernels"
TRAIN_KERNELS = {   # kernel -> (source, {pass: TPU pallas_call site})
    "trunk2_train": ("trunk_train.cu", {
        "F1": "trunk_train.py:121", "F2": "trunk_train.py:212",
        "B1": "trunk_train.py:309"}),
    "seg_head_train": ("seg_head_train.cu", {
        "P1": "seg_head_train.py:75", "Pmid": "seg_head_train.py:118",
        "P4": "seg_head_train.py:155", "B4": "seg_head_train.py:206",
        "Bmid": "seg_head_train.py:275", "B1": "seg_head_train.py:335"}),
    "pool_fc_epilogue": ("pool_fc_epilogue.cu", {
        "fwd": "pool_fc_epilogue.py:86"}),
}
PER_STEP = {"trunk2_train": {"F1": 3, "F2": 3, "B1": 3},
            "seg_head_train": {"P1": 1, "Pmid": 2, "P4": 1, "B4": 1,
                               "Bmid": 2, "B1": 1},
            "pool_fc_epilogue": {"fwd": 2}}
# The config-4 G+D step: the generator's passes for two streams (the T-Net
# fc heads batched: pool-fc twice, at groups=2) and the discriminator's.
DISC_SITES = {"fwd": "disc_fused.py:101", "bwd_dx": "disc_fused.py:229",
              "bwd_dw": "disc_fused.py:339", "bwd": "disc_fused.py:145"}
ADV_PER_STEP = {"trunk2_train": {"F1": 6, "F2": 6, "B1": 6},
                "seg_head_train": {"P1": 2, "Pmid": 4, "P4": 2, "B4": 2,
                                   "Bmid": 4, "B1": 2},
                "pool_fc_epilogue": {"fwd": 2},
                "disc_fused": {"fwd": 3, "bwd_dx": 2, "bwd_dw": 2, "bwd": 0}}
FP32_PEAK = 67e12     # FLOP/s, fp32 outside the tensor cores (H100 SXM)
# fp32 as 3xTF32 on the tensor cores: three TF32 products per product
# (495 TFLOP/s dense TF32, H100 SXM): the rate of the GEMM core's fp32
# passes, so their bound.
TF32X3_PEAK = 495e12 / 3
# The float64 control of an fp32 pass (phase 15): its max error against
# the float64 product at most this many times that of the plain fp32 pass
# (cuBLAS in full fp32, core.exact_fp32()); TF32 alone is some 200x.
F64_FACTOR = 2.0
BF16_PEAK = 989e12    # FLOP/s, bf16 tensor cores, dense (H100 SXM)
HBM_RATE = 3.35e12    # bytes/s (H100 SXM)
# The bench step (bf16) on the card against the CPU. Both sides round the
# same operands to bf16 at the same places, but where the two sum in
# another order an fp32 value on a rounding boundary rounds to the
# neighbouring bf16 value: one bf16 step, 2^-8 of it, against fp32's 2^-24.
# Such a flip is rounding of the same kind and size as the bf16 rounding
# itself, and the step carries it as far as it carries that rounding: the
# batch-axis BatchNorms of the T-Net heads, the max-pools' winners and
# the pseudo-labels' argmax amplify it (the bf16 rounding moves some G
# gradients by a large part of their norm, in the JAX package as in the
# port: tests/test_torch_bench_step.py). So each quantity is held to the
# larger of the fp32 step's bound (STEP_BOUND, GRAD_BOUND) and twice what
# bf16 rounding moves it by on the CPU (the same step in fp32, the
# yardstick).
YARD_FACTOR = 2.0
BENCH_K = 8           # steps per train_steps_scan call (bench.py --scan 8)
STASH_BOUND = 2.0 ** -8   # one bf16 step of a stash's scale (check_stash)
# The share of a tensor-core pass's bf16 values (the disc pass's h4, dW5's
# operand; the z stashes of Pmid and trunk F1, B4's dy3) that may sit one
# bf16 step from the plain twin's: only fp32 sums of another order on a
# rounding midpoint, about 1e-4 of the elements on an H100 at 700 W (h4
# at K=256 1.0e-4 to 1.3e-4; Pmid's z 0.2e-4 to 1.6e-4 at K=64 to 512;
# F1's z2 and B4's dy3 1.7e-5 to 4.6e-5); a rounding of another kind
# (toward zero, say) moves about half of them.
STASH_SHARE = 1e-3
# A bf16 pass's fp32 outputs against its bf16 twin: where an operand (a
# cotangent dz, say) rounds to its other bf16 neighbour on one side, a
# sum moves by one bf16 step of one of its terms, 2^-8 of it, and at
# these widths a term can carry a tenth or more of the largest output.
BF16_BOUND = 1e-3
AUG_SITE = "augment_fused.py:104"
AUG_PER_STEP = 1      # one augment_fused_pair launch, both streams
GROUPS2_PER_STEP = {"F1": 3, "F2": 3, "B1": 3}   # paired trunks: 3 trunks
# The per-layer training kernels (dispatch.use_pallas_train, the JAX
# package's use_pallas(training=True)): kernel -> (source, {pass: TPU
# pallas_call site}).
PT_KERNELS = {
    "pointwise_matmul": ("pointwise_matmul.cu", {
        "fwd": "shared_mlp.py:123", "dx": "shared_mlp.py:123",
        "dW": "shared_mlp.py:160"}),
    "tnet_apply": ("tnet_apply.cu", {
        "fwd": "tnet_apply.py:32", "dx": "tnet_apply.py:32",
        "dT": "tnet_apply.py:74"}),
    "maxpool_points": ("maxpool_points.cu", {
        "fwd": "maxpool_points.py:76", "bwd": "maxpool_points.py:103"}),
    "fc_head_train": ("fc_head_train.cu", {
        "fwd": "fc_head_train.py:112", "bwd": "fc_head_train.py:192"}),
}
PT_OFF = {k: {p: 0 for p in sites} for k, (_, sites) in PT_KERNELS.items()}
# The kernels on the GEMM core (csrc/strided_gemm.cu): fp32 as 3xTF32.
GEMM_KERNELS = ("pointwise_matmul", "tnet_apply")
# The fused training passes on the tensor cores (csrc/train_bwd_tc.cu, on
# mma.cuh's fragment layer and the GEMM core): fp32 as 3xTF32, bound at
# that rate with the fp32-FMA bound beside it.
TC_PASSES = (("trunk2_train", "F1"), ("trunk2_train", "F2"),
             ("trunk2_train", "B1"), ("seg_head_train", "P1"),
             ("seg_head_train", "Pmid"), ("seg_head_train", "P4"),
             ("seg_head_train", "B4"), ("seg_head_train", "Bmid"),
             ("seg_head_train", "B1"), ("pool_fc_epilogue", "fwd"))
# The T-Net fc layers' kernels on csrc/small_fc.cuh's split-K tensor-core
# product across thread-block clusters (pool-fc is among TC_PASSES; the
# fc head is a per-layer kernel of use_pallas_train): fp32 as 3xTF32.
FC_SOURCE = "small_fc.cuh"
FC_TC = ("fc_head_train",)
# The discriminator's passes, all on the tensor cores (csrc/disc_tc.cu:
# the forward kernel; the backward's row pass, and for dW the GEMM core),
# bound as TC_PASSES.
DISC_TC_PASSES = ("fwd", "bwd_dx", "bwd_dw", "bwd")
DISC_DW_PASSES = ("bwd_dw", "bwd")    # with the scratch for dW
# Launches per config-3 step under the switch. N=2048: conv1 of STN3d, the
# encoder and STNkd (STN3d's sees the points: no dx), both transforms
# (x @ T3's x is the points: no dx), both single-stream fc heads; the
# fused trunks and seg head as by default, the pool-fc epilogue not at
# all. N=2500 (untileable for the JAX kernels): every conv of the three
# trunks and seg head conv2-4 layer by layer, the three max-pools.
PT_SEG_PER_STEP = {
    TRAIN_N: {**PER_STEP, **PT_OFF,
              "pointwise_matmul": {"fwd": 3, "dx": 2, "dW": 3},
              "tnet_apply": {"fwd": 2, "dx": 1, "dT": 2},
              "fc_head_train": {"fwd": 2, "bwd": 2},
              "pool_fc_epilogue": {"fwd": 0}},
    TRAIN_RAGGED_N: {
        "trunk2_train": {"F1": 0, "F2": 0, "B1": 0},
        "seg_head_train": {p: 0 for p in PER_STEP["seg_head_train"]},
        "pool_fc_epilogue": {"fwd": 0},
        "pointwise_matmul": {"fwd": 12, "dx": 11, "dW": 12},
        "tnet_apply": {"fwd": 2, "dx": 1, "dT": 2},
        "maxpool_points": {"fwd": 3, "bwd": 3},
        "fc_head_train": {"fwd": 2, "bwd": 2}},
}
# The bench step under the switch (bench.py --pallas_train): the conv1
# layers and transforms per stream; the paired heads take fc1 + BN in plain
# PyTorch, so no pool-fc epilogue and no fc_head_train (single-stream).
PT_BENCH_PER_STEP = {**ADV_PER_STEP, **PT_OFF,
                     "augment_fused": {"fwd": AUG_PER_STEP},
                     "pool_fc_epilogue": {"fwd": 0},
                     "pointwise_matmul": {"fwd": 6, "dx": 4, "dW": 6},
                     "tnet_apply": {"fwd": 4, "dx": 2, "dT": 4}}
# The config-4 step at N=2500 under the switch (bench.py --pallas_train
# --points 2500): the generator as the config-3 step there, twice (the
# paired heads' fc1 + BN plain: no fc_head_train), and the discriminator
# layer by layer through pointwise_matmul: two frozen passes in the G step
# (forward and dx, 5 + 5 each), one stacked pass at 3B in the D step
# (forward 5, dW 5, dx 4: none into its detached input). No fused
# training or discriminator kernel.
PT_ADV_RAGGED_PER_STEP = {
    **{k: {p: 0 for p in v} for k, v in ADV_PER_STEP.items()}, **PT_OFF,
    "augment_fused": {"fwd": 0},
    "pool_fc_epilogue": {"fwd": 0},
    "pointwise_matmul": {"fwd": 24 + 15, "dx": 22 + 14, "dW": 24 + 5},
    "maxpool_points": {"fwd": 6, "bwd": 6},
    "tnet_apply": {"fwd": 4, "dx": 2, "dT": 4}}
# The serving path's stacks (fused_stack_maxpool) and seg head widths.
SERVE_STACKS = {"stn3d": ((3, 64, 128, 1024), ("relu",) * 3),
                "stnkd": ((64, 64, 128, 1024), ("relu",) * 3),
                "trunk": ((64, 128, 1024), ("relu", None))}
HEAD_WIDTHS = ((1088, 512), (512, 256), (256, 128))
# Of those, the ones on the tensor cores: fp32 as 3xTF32, bound at that
# rate with the fp32-FMA bound beside it.
SERVE_TC = ("fused_stack_maxpool", "seg_head_fused")
STACK_SITE = "shared_mlp.py:296"
TRUNK3_SITE = "trunk_train.py:515"
D_ACTS = ("leaky_relu",) * 4 + (None,)
# trunk3_train's passes, in the order it runs them: (kernel module, pass).
TRUNK3_PASSES = (("trunk_train", "F1"), ("seg_head_train", "Pmid"),
                 ("trunk_train", "F2"), ("trunk_train", "B1"),
                 ("seg_head_train", "Bmid"), ("seg_head_train", "B1"))
# A conv bias in front of a batch-statistic BN has a zero gradient in
# exact arithmetic: held to the norm of the same layer's weight gradient.
TRUNK3_ZERO_GRADS = {2: 1, 6: 5, 10: 9}


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def rel_err(a: torch.Tensor, b: torch.Tensor):
    diff = (a.double() - b.double()).abs().max().item()
    return diff / max(1.0, b.abs().max().item()), diff


def check(name: str, got: torch.Tensor, ref: torch.Tensor,
          bound: float = BOUND, tag: str = "kernels",
          scale=None) -> float:
    """Fail unless ``max|got - ref| <= bound * max(1, max|ref|)``, or
    ``bound * scale`` where a sum cancels to near zero: its rounding is
    bounded by the sum of its terms' magnitudes, which ``scale`` is. A
    tensor ``scale`` holds each element on its own: ``|got - ref| <=
    bound * max(1, scale)`` element by element."""
    if got.shape != ref.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != "
                             f"{tuple(ref.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite output")
    rel, diff = rel_err(got, ref)
    kind = "scale"
    if isinstance(scale, torch.Tensor):
        rel = ((got.double() - ref.double()).abs()
               / scale.double().clamp(min=1.0)).max().item()
        kind = "element"
    elif scale is not None:
        rel, kind = diff / max(1.0, scale), "term-sum"
    phase(tag, f"{name}: max {kind}-relative "
          f"error {rel:.3e} (max abs {diff:.3e}, bound {bound:g})")
    if rel > bound:
        raise AssertionError(f"{name}: error {rel:.3e} above {bound:g}")
    return diff


def check_f64(name: str, got: torch.Tensor, plain: torch.Tensor,
              ref: torch.Tensor, tag: str) -> float:
    """Fail unless ``got``'s max error against the float64 product ``ref``
    is at most ``F64_FACTOR`` times the plain fp32 pass's; return the
    ratio of the two."""
    ek = (got.double() - ref).abs().max().item()
    ep = (plain.double() - ref).abs().max().item()
    ratio = ek / ep if ep else (0.0 if not ek else float("inf"))
    phase(tag, f"{name}: float64 control: max error {ek:.3e} against the "
          f"plain fp32 pass's {ep:.3e}, ratio {ratio:.3f} (at most "
          f"{F64_FACTOR:g})")
    if ek > F64_FACTOR * ep:
        raise AssertionError(f"{name}: {ratio:.3f}x the plain fp32 pass's "
                             "error against float64")
    return ratio


def f64(args):
    """``args`` with every tensor in float64 (the control's product)."""
    return tuple(a.double() if isinstance(a, torch.Tensor) else a
                 for a in args)


def tf32_control(label, fn, ref, plain, tag):
    """The control that must fail: ``fn()``, a plain pass, with TF32
    allowed in its matmuls (one TF32 product, about 2^-11 of each term)
    held to the float64 control ``ref`` at its depth; the flag is restored
    whatever happens."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        ctrl = fn()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    try:
        check_f64(f"control: {label} in TF32", ctrl, plain, ref, tag)
    except AssertionError:
        phase(tag, "control: the TF32 product fails the float64 control, "
              "as it must")
        return
    raise AssertionError("the float64 control passed a TF32 product: it "
                         "does not separate 1xTF32 from 3xTF32")


def check_stash(name: str, got: torch.Tensor, ref: torch.Tensor,
                tag: str = "bench-kernels", max_share: float | None = None):
    """A bf16 stash: equal in value to the plain pass's (-0 is 0), or one
    bf16 step from it (an fp32 value on a rounding boundary, summed in
    another order), or within one bf16 step of the stash's scale,
    ``STASH_BOUND`` (a bf16 operand upstream that rounds to its other
    neighbour moves a sum by one bf16 step of one of its terms); with
    ``max_share``, also at most that share of its elements differ.
    Returns ``(max abs error, share of elements that differ)``."""
    if got.shape != ref.shape or got.dtype != ref.dtype:
        raise AssertionError(f"{name}: {got.dtype} {tuple(got.shape)} != "
                             f"{ref.dtype} {tuple(ref.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite output")
    gi, ri = (t.contiguous().view(torch.int16).int() for t in (got, ref))
    rel, diff = rel_err(got, ref)
    differ = got.float() != ref.float()
    near = (got.float() - ref.float()).abs() <= STASH_BOUND * max(
        1.0, ref.abs().max().item())
    far = int((differ & ((gi - ri).abs() > 1) & ~near).sum())
    share = differ.float().mean().item()
    phase(tag, f"{name}: bf16 stash, {share:.3e} of {ref.numel()} elements "
          f"differ, all by one bf16 step or within {STASH_BOUND:g} of the "
          f"scale but {far} (max scale-relative error {rel:.3e})")
    if far:
        raise AssertionError(f"{name}: {far} stash elements differ by more "
                             "than one bf16 step")
    if max_share is not None and share > max_share:
        raise AssertionError(f"{name}: {share:.3e} of the elements differ, "
                             f"above {max_share:g}")
    return diff, share


def check_norm(name: str, got: torch.Tensor, ref: torch.Tensor,
               denom: float = None, tag: str = "train-kernels") -> None:
    """Fail unless ``||got - ref|| <= WHOLE_BOUND * ||ref||`` (or
    ``* denom``), in the Frobenius norm."""
    if got.shape != ref.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{name}: shape {tuple(got.shape)} or "
                             "non-finite values")
    diff = (got.double() - ref.double())
    rel = diff.norm().item() / max(denom or ref.double().norm().item(),
                                   1e-30)
    phase(tag, f"{name}: relative L2 error {rel:.3e} (max abs "
          f"{diff.abs().max().item():.3e}, bound {WHOLE_BOUND:g})")
    if rel > WHOLE_BOUND:
        raise AssertionError(f"{name}: error {rel:.3e} above "
                             f"{WHOLE_BOUND:g}")


def event_ms(fn, reps: int):
    """CUDA-event times in ms of ``reps`` calls of ``fn``, one by one."""
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return out


def time_pair(kernel_fn, plain_fn, reps: int = REPS):
    """Median ms of each function over ``reps`` runs, in the order plain,
    kernel, kernel, plain, after a warm-up."""
    for fn in (kernel_fn, plain_fn, kernel_fn, plain_fn):
        fn()
    plain = event_ms(plain_fn, reps // 2)
    kernel = event_ms(kernel_fn, reps)
    plain += event_ms(plain_fn, reps // 2)
    return statistics.median(kernel), statistics.median(plain)


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            yield from _tensors(o)


def work(plain, calls):
    """``(flops, bytes)`` of ``calls`` (argument tuples) through ``plain``:
    the matmul FLOPs it does (torch.utils.flop_counter), and its inputs
    read once and its outputs written once."""
    from torch.utils.flop_counter import FlopCounterMode

    flops = nbytes = 0
    with torch.no_grad():
        for a in calls:
            with FlopCounterMode(display=False) as counter:
                out = plain(*a)
            flops += counter.get_total_flops()
            nbytes += sum(t.numel() * t.element_size()
                          for t in _tensors((a, out)))
    return flops, nbytes


def bound(flops, nbytes, peak=FP32_PEAK):
    """``(bound_ms, bound_by)``: the larger of the FLOPs over ``peak`` (by
    default fp32 FMA's) and the bytes over the memory rate."""
    t_ops, t_bytes = flops / peak, nbytes / HBM_RATE
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _device_us(event) -> float:
    us = getattr(event, "self_device_time_total", None)
    return event.self_cuda_time_total if us is None else us


PROFILE_TRIES = 5


def device_profile(fn, reps: int = 10, counts: dict = None):
    """``{kernel name: device ms per call}`` of ``fn``'s GPU work, from
    torch.profiler (device activity only). Now and then a window records
    no device activity at all although ``fn`` launched kernels; such a
    window is taken again, up to ``PROFILE_TRIES`` windows, and then this
    raises: a lost reading never enters the output as 0 ms. A window can
    also lose some kernel records (a kernel counted a number of times that
    is not a multiple of ``reps``, where ``fn`` launches the same kernels
    each call); it is taken again too, and if every window loses some, the
    first is used and a line says that its time is a lower bound.
    ``counts``, a dict, receives ``{kernel name: launches per call}`` of
    the window used."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    partial = None
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if _device_us(e) > 0]
        if not events:
            phase("profile", "a torch.profiler window recorded no device "
                  "activity; profiling again")
            continue
        out = {e.key: _device_us(e) / reps / 1e3 for e in events}
        lost = [(e.key[:40], e.count) for e in events if e.count % reps]
        seen = {e.key: e.count / reps for e in events}
        if not lost:
            if counts is not None:
                counts.update(seen)
            return out
        partial = partial or (out, lost, seen)
    if partial:
        phase("profile", f"every window lost kernel records (counts over "
              f"{reps} calls in the first: {partial[1]}): a device time "
              "taken from it in the next timing line is a lower bound")
        if counts is not None:
            counts.update(partial[2])
        return partial[0]
    raise RuntimeError(f"torch.profiler lost device activity in "
                       f"{PROFILE_TRIES} windows: device time not measured")


def layer_params(gen, c_in, c_out, dev):
    """A random [in, out] weight view (over row-major [out, in] storage)
    with a non-trivial folded-BN shift and scale."""
    bound = c_in ** -0.5
    w = (torch.rand(c_out, c_in, generator=gen) * 2 - 1) * bound
    shift = torch.randn(c_out, generator=gen) * 0.1
    scale = 0.5 + torch.rand(c_out, generator=gen)
    return w.to(dev).t(), shift.to(dev), scale.to(dev)


def randomize_bn(model: torch.nn.Module, gen: torch.Generator) -> None:
    """Random BatchNorm affine and running statistics, so that no fold is
    the identity."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm1d):
                c = m.num_features
                m.weight.copy_(0.5 + torch.rand(c, generator=gen))
                m.bias.copy_(torch.randn(c, generator=gen) * 0.1)
                m.running_mean.copy_(torch.randn(c, generator=gen) * 0.1)
                m.running_var.copy_(0.5 + torch.rand(c, generator=gen))


# ---------------------------------------------------------------------------
# Serving (phases 3-5)
# ---------------------------------------------------------------------------

def serve_params(gen, dev):
    """Phase 3's seeded serving operands: conv1, the three stacks' layers
    (and the trunk again with its last layer's folded scales negative in
    every other channel), the seg head's layers, W4 and b4."""
    conv1 = layer_params(gen, 3, 64, dev)
    stacks = {k: [layer_params(gen, a, b, dev) for a, b in zip(w[:-1], w[1:])]
              for k, (w, _) in SERVE_STACKS.items()}
    w, sh, sc = stacks["trunk"][-1]
    sign = 1.0 - 2.0 * (torch.arange(sc.numel(), device=dev) % 2)
    stacks["trunk, negative scales"] = stacks["trunk"][:-1] + [
        (w, sh, sc * sign)]
    head = [layer_params(gen, a, b, dev) for a, b in HEAD_WIDTHS]
    w4, _, _ = layer_params(gen, 128, PARTS, dev)
    b4 = (torch.randn(PARTS, generator=gen) * 0.1).to(dev)
    return conv1, stacks, head, w4, b4


def serve_stack(key):
    """``(widths, acts)`` of a stack of ``serve_params``."""
    return SERVE_STACKS[key.split(",")[0]]


def serve_f64_checks(encoder_fused, stack_args, head_args, tag="kernels"):
    """The float64 controls of the serving kernels (fp32, on the card):
    each stack's pre-max values on the first 4 tiles of the first cloud
    (each point a cloud of its own, n = 1, so the max is the value) and
    the head's log-probs, each at most ``F64_FACTOR`` times the plain fp32
    pass's error against the float64 pass; the plain passes with TF32
    allowed in their matmuls must fail that."""
    for key, args in stack_args.items():
        x, rest = args[0], args[1:]
        pts = (x[0, :4 * 128].reshape(-1, 1, x.shape[-1]), *rest)
        got = encoder_fused.fused_stack_maxpool(*pts)
        plain = encoder_fused.fused_stack_maxpool_plain(*pts)
        ref = encoder_fused.fused_stack_maxpool_plain(
            pts[0].double(), *[[t.double() for t in ts] for ts in rest[:3]],
            rest[3])
        name = f"fused_stack_maxpool {key} pre-max values"
        check_f64(name, got, plain, ref, tag)
        tf32_control(name, lambda: encoder_fused.fused_stack_maxpool_plain(
            *pts), ref, plain, tag)
    got = encoder_fused.seg_head_fused(*head_args)
    plain = encoder_fused.seg_head_fused_plain(*head_args)
    ref = encoder_fused.seg_head_fused_plain(*f64(head_args))
    check_f64("seg_head_fused log-probs", got, plain, ref, tag)
    tf32_control("seg_head_fused log-probs",
                 lambda: encoder_fused.seg_head_fused_plain(*head_args), ref,
                 plain, tag)


# fused_linear_affine_act's other paths (csrc/shared_mlp.cu): the
# register path at c_in 3 with a leaky ReLU, and the general path (W^T in
# shared memory) at c_in 64 and at c_out 50 (a partial channel group),
# at B=32 N=2047 (rows off a 16-byte boundary at c_in 3) and B=1 N=37.
CONV_WIDTHS = ((3, 64, "leaky_relu"), (64, 64, "relu"), (3, 50, "relu"),
               (64, 50, None))


def conv_width_checks(shared_mlp, gen, dev):
    """``CONV_WIDTHS`` against the plain twin (``BOUND``), the general
    path's 64 -> 64 also by the float64 control; the largest error."""
    err = 0.0
    for c_in, c_out, act in CONV_WIDTHS:
        layer = layer_params(gen, c_in, c_out, dev)
        for bsz, n in ((B, RAGGED_N), (1, 37)):
            x = torch.randn(bsz, n, c_in, generator=gen).to(dev)
            args = (x, *layer, act)
            got = shared_mlp.fused_linear_affine_act(*args)
            plain = shared_mlp.fused_linear_affine_act_plain(*args)
            err = max(err, check(
                f"fused_linear_affine_act {c_in}->{c_out} {act} B={bsz} "
                f"N={n}", got, plain))
            if (c_in, c_out, bsz) == (64, 64, B):
                check_f64(f"fused_linear_affine_act {c_in}->{c_out}", got,
                          plain, shared_mlp.fused_linear_affine_act_plain(
                              *f64(args)), "kernels")
    return err


def serve(dev, card, gen, results):
    from adversarial_learning_on_pointclouds_tpu_torch import infer
    from adversarial_learning_on_pointclouds_tpu_torch.models import (
        PointNetDenseCls,
    )
    from adversarial_learning_on_pointclouds_tpu_torch.ops.kernels import (
        encoder_fused, shared_mlp,
    )

    err = {"fused_linear_affine_act": 0.0, "fused_stack_maxpool": 0.0,
           "seg_head_fused": 0.0}
    main_args = {}
    with torch.inference_mode():
        conv1, stack_params, head, w4, b4 = serve_params(gen, dev)
        for bsz, n in ((B, N), (B, RAGGED_N), (1, N)):
            tag = f"B={bsz} N={n}"
            x3 = torch.randn(bsz, n, 3, generator=gen).to(dev)
            x64 = torch.relu(torch.randn(bsz, n, 64, generator=gen)).to(dev)
            g = torch.relu(torch.randn(bsz, 1024, generator=gen)).to(dev)
            main = (bsz, n) == (B, N)

            args = (x3, *conv1, "relu")
            got = shared_mlp.fused_linear_affine_act(*args)
            plain = shared_mlp.fused_linear_affine_act_plain(*args)
            d = check(f"fused_linear_affine_act conv1 3->64 {tag}", got,
                      plain)
            err["fused_linear_affine_act"] = max(
                err["fused_linear_affine_act"], d)
            if main:
                main_args["fused_linear_affine_act"] = [args]
                check_f64("fused_linear_affine_act conv1 3->64", got, plain,
                          shared_mlp.fused_linear_affine_act_plain(
                              *f64(args)), "kernels")
                err["fused_linear_affine_act"] = max(
                    err["fused_linear_affine_act"],
                    conv_width_checks(shared_mlp, gen, dev))

            stack_args = {}
            for key, layers in stack_params.items():
                widths, acts = serve_stack(key)
                ws, shs, scs = zip(*layers)
                args = (x3 if widths[0] == 3 else x64, ws, shs, scs, acts)
                stack_args[key] = args
                d = check(f"fused_stack_maxpool {key} "
                          f"{'->'.join(map(str, widths))} {tag}",
                          encoder_fused.fused_stack_maxpool(*args),
                          encoder_fused.fused_stack_maxpool_plain(*args))
                err["fused_stack_maxpool"] = max(err["fused_stack_maxpool"], d)
                if main and key in SERVE_STACKS:
                    main_args.setdefault("fused_stack_maxpool", []).append(args)

            args = (x64, g, *head[0], *head[1], *head[2], w4, b4)
            d = check(f"seg_head_fused 1088->512->256->128->{PARTS} {tag}",
                      encoder_fused.seg_head_fused(*args),
                      encoder_fused.seg_head_fused_plain(*args))
            err["seg_head_fused"] = max(err["seg_head_fused"], d)
            if main:
                main_args["seg_head_fused"] = [args]
                serve_f64_checks(encoder_fused, stack_args, args)
        torch.cuda.synchronize()

    # 4. the slice: serve a seeded full-width segmenter
    wrappers = {"fused_stack_maxpool": encoder_fused.fused_stack_maxpool,
                "fused_linear_affine_act": shared_mlp.fused_linear_affine_act,
                "seg_head_fused": encoder_fused.seg_head_fused}
    per_forward = {"fused_stack_maxpool": 3, "fused_linear_affine_act": 1,
                   "seg_head_fused": 1}
    rng = np.random.default_rng(SEED)
    model = PointNetDenseCls(PARTS, feature_transform=True, generator=gen)
    randomize_bn(model, gen)
    with torch.no_grad():  # per-point features decide more of the parts
        model.conv1.weight[:, :64] *= 20
    raw = [rng.normal(size=(int(rng.integers(2000, 3000)), 3)) *
           rng.uniform(0.5, 2.0, size=3) for _ in range(4 * B)]
    clouds = infer.prep(raw, N)
    with tempfile.TemporaryDirectory() as tmp:
        pth = os.path.join(tmp, "g.pth")
        torch.save(model.state_dict(), pth)
        pts = os.path.join(tmp, "shape.pts")
        np.savetxt(pts, raw[0], fmt="%.6f")
        predictor = infer.Predictor(pth, "adv", N, "cuda",
                                    feature_transform=True)

        for w in wrappers.values():
            w.launches = 0
        out = io.StringIO()
        with redirect_stdout(out):
            infer.main(["--checkpoint", pth, "--model", "adv",
                        "--feature_transform", "--input", pts,
                        "--device", "cuda"])
        t0 = time.perf_counter()
        logp = predictor.predict(clouds)
        serve_s = time.perf_counter() - t0
        launches = {k: w.launches for k, w in wrappers.items()}

        phase("slice", f"infer.main: {out.getvalue().strip()}")
        forwards = 1 + len(clouds) // B
        for k, count in launches.items():
            if count != per_forward[k] * forwards:
                raise AssertionError(
                    f"{k} launched {count} times in {forwards} forwards, "
                    f"expected {per_forward[k]} per forward")
        phase("slice", f"launches over {forwards} forwards: {launches}")
        phase("slice", f"Predictor.predict {len(clouds)} clouds x {N} "
              f"points, batch {B}: {serve_s:.3f} s (first use)")

        ref = infer.Predictor(pth, "adv", N, "cpu",
                              feature_transform=True).predict(clouds)
    if logp.shape != (4 * B, N, PARTS) or not np.isfinite(logp).all():
        raise AssertionError(f"log-probs {logp.shape} not finite "
                             f"[{4 * B}, {N}, {PARTS}]")
    mass = np.abs(np.exp(logp.astype(np.float64)).sum(-1) - 1).max()
    if mass > 1e-4:
        raise AssertionError(f"probabilities sum to 1 +- {mass:.2e}")
    rel, diff = rel_err(torch.from_numpy(logp), torch.from_numpy(ref))
    scale = max(1.0, float(np.abs(ref).max()))
    arg_gpu, arg_cpu = logp.argmax(-1), ref.argmax(-1)
    flips = np.nonzero(arg_gpu != arg_cpu)
    margin = (np.take_along_axis(ref, arg_cpu[..., None], -1)
              - np.take_along_axis(ref, arg_gpu[..., None], -1))[flips]
    phase("slice", f"GPU vs CPU log-probs: max scale-relative error "
          f"{rel:.3e} (max abs {diff:.3e}, bound {BOUND:g}); "
          f"{len(flips[0])} of {arg_cpu.size} argmax differ")
    if rel > BOUND:
        raise AssertionError(f"slice error {rel:.3e} above {BOUND:g}")
    if len(flips[0]) and margin.max() >= BOUND * scale:
        raise AssertionError(f"argmax differs at a top-2 margin of "
                             f"{margin.max():.3e}")

    # 5. timing
    with torch.inference_mode():
        for name, src, line in (
                ("fused_linear_affine_act", "shared_mlp.cu", "shared_mlp.py:227"),
                ("fused_stack_maxpool", "encoder_fused.cu", "encoder_fused.py:109"),
                ("seg_head_fused", "encoder_fused.cu", "encoder_fused.py:182")):
            kernel, plain = wrappers[name], getattr(
                shared_mlp if name == "fused_linear_affine_act"
                else encoder_fused, f"{name}_plain")
            calls = main_args[name]
            ms, plain_ms = time_pair(lambda: [kernel(*a) for a in calls],
                                     lambda: [plain(*a) for a in calls])
            dev_ms = sum(device_profile(
                lambda: [kernel(*a) for a in calls]).values())
            plain_dev_ms = sum(device_profile(
                lambda: [plain(*a) for a in calls]).values())
            flops, nbytes = work(plain, calls)
            tc = name in SERVE_TC
            bound_ms, bound_by = bound(flops, nbytes,
                                       TF32X3_PEAK if tc else FP32_PEAK)
            fma_ms = bound(flops, nbytes)[0]
            phase("timing", f"{card}: {name} x{len(calls)} per forward at "
                  f"B={B} N={N}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms;"
                  f" device time alone: kernel {dev_ms:.4f} ms, plain "
                  f"{plain_dev_ms:.4f} ms; bound {bound_ms:.4f} ms "
                  f"({bound_by}" + (f", at 3xTF32; {fma_ms:.4f} at fp32 FMA"
                                    if tc else "") + f"); "
                  f"{flops / dev_ms / 1e9:.1f} TFLOP/s on the device")
            results.append({"name": name, "route": "cuda",
                            "source": f"{KERNELS_ROOT}/csrc/{src}",
                            "replaces": f"{TPU_KERNELS}/{line}",
                            "launches": launches[name],
                            "max_abs_err": err[name], "ms": ms,
                            "plain_ms": plain_ms, "bound_ms": bound_ms,
                            "bound_by": bound_by, "library_ms": None,
                            "device_ms": dev_ms,
                            "plain_device_ms": plain_dev_ms,
                            **({"bound_fma_ms": fma_ms} if tc else {})})

        x = torch.from_numpy(clouds[:B]).to(dev)
        model_gpu = predictor.model
        model_gpu(x)
        fwd_ms = statistics.median(event_ms(lambda: model_gpu(x), REPS))
        kernels = device_profile(lambda: model_gpu(x))
    phase("timing", f"{card}: segmenter forward B={B} N={N} on the device: "
          f"{fwd_ms:.3f} ms, {B / fwd_ms * 1e3:.1f} clouds/s")
    busy = sum(kernels.values())
    phase("profile", f"{card}: forward B={B} N={N}: GPU kernels busy "
          f"{busy:.3f} ms of {fwd_ms:.3f} ms ({100 * (1 - busy / fwd_ms):.1f}%"
          f" idle), {len(kernels)} kernel names")
    for key, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:8]:
        phase("profile", f"  {ms:.4f} ms  {key[:90]}")
    profile_names(kernels, f"the forward B={B} N={N}", SERVE_KERNELS, 1,
                  "profile")
    serve_t = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        predictor.predict(clouds[:B])
        serve_t.append(time.perf_counter() - t0)
    serve_ms = statistics.median(serve_t) * 1e3
    phase("timing", f"{card}: Predictor.predict B={B} N={N} host to host: "
          f"{serve_ms:.3f} ms, {B / serve_ms * 1e3:.1f} clouds/s")


# ---------------------------------------------------------------------------
# Training passes against their plain passes (phase 6)
# ---------------------------------------------------------------------------

class PassRecord:
    """Per training pass: the largest error seen, the largest share of a
    bf16 stash that differed, and the main-shape arguments for timing."""

    def __init__(self, bound=BOUND):
        self.bound = bound
        self.err, self.args, self.share, self.f64 = {}, {}, {}, {}

    def cmp_f64(self, kernel, pas, tag, got, plain, ref, phase_tag):
        """The float64 control of an fp32 pass (``check_f64``); keeps the
        largest ratio seen."""
        ratio = check_f64(f"{kernel} {pas} {tag}", got, plain, ref, phase_tag)
        key = (kernel, pas)
        self.f64[key] = max(self.f64.get(key, 0.0), ratio)

    def cmp(self, kernel, pas, tag, names, got, ref, main, fn_args,
            scales=None, phase_tag="train-kernels", bound=None,
            max_share=None):
        key = (kernel, pas)
        for nm, a, b in zip(names, got, ref):
            if a.dtype == torch.bfloat16:
                d, share = check_stash(f"{kernel} {pas} {nm} {tag}", a, b,
                                       phase_tag, max_share)
                self.share[key] = max(self.share.get(key, 0.0), share)
            else:
                d = check(f"{kernel} {pas} {nm} {tag}", a, b,
                          self.bound if bound is None else bound, phase_tag,
                          (scales or {}).get(nm))
            self.err[key] = max(self.err.get(key, 0.0), d)
        if main:
            self.args.setdefault(key, []).append(fn_args)


def _w(gen, c_in, c_out, dev):
    return layer_params(gen, c_in, c_out, dev)[0]


def _r(gen, *shape, scale=0.1, dev="cuda"):
    return (torch.randn(*shape, generator=gen) * scale).to(dev)


def _gam(gen, c, dev, negative=0.0):
    g = 0.5 + torch.rand(c, generator=gen)
    if negative:
        g = torch.where(torch.rand(c, generator=gen) < negative, -g, g)
    return g.to(dev)


def dz_scales(sh, a):
    """A BN backward's ``dz`` sums to zero over the rows (up to rounding),
    so its column sums (``db``, and ``r`` per cloud) are held to the sum
    of their terms' magnitudes."""
    mag = sh._bn_dz(*a[:7]).abs()
    return {"db": mag.sum((0, 1)).max().item(),
            "db1": mag.sum((0, 1)).max().item(),
            "r": mag.sum(1).max().item()}


def check_winners(tag, got_idx, ref_idx, z3, x, dup_clouds, n, want="max",
                  phase_tag="train-kernels"):
    """Winner indices: equal to the plain pass's, or, where rounding makes
    two distinct points tie, a point of (within the bound) the same value;
    never the second of two duplicated points."""
    bsz, c3 = got_idx.shape
    diff = got_idx != ref_idx
    vg = torch.gather(z3, 1, got_idx.long()[:, None, :])[:, 0]
    vr = torch.gather(z3, 1, ref_idx.long()[:, None, :])[:, 0]
    scale = max(1.0, z3.abs().max().item())
    gap = ((vg - vr).abs() * diff).max().item() / scale
    xg = torch.gather(x, 1, got_idx.long()[:, :, None].expand(-1, -1,
                                                             x.shape[-1]))
    xr = torch.gather(x, 1, ref_idx.long()[:, :, None].expand(-1, -1,
                                                             x.shape[-1]))
    dup = diff & (xg == xr).all(-1) & (got_idx > ref_idx)
    phase(phase_tag, f"trunk2_train F2 arg{want} {tag}: "
          f"{int(diff.sum())} of {bsz * c3} differ from the plain pass, at a "
          f"value gap of {gap:.3e}; {int(dup.sum())} later duplicates won")
    if gap > BOUND or int(dup.sum()):
        raise AssertionError(f"arg{want} {tag}: wrong winners")
    if dup_clouds:
        late = int((got_idx[:dup_clouds] >= n - n // 2).sum())
        if late:
            raise AssertionError(f"arg{want} {tag}: {late} tied maxima went "
                                 "to the later duplicate")


def _rows64(t):
    return t.reshape(-1, t.shape[-1]).double()


def b1_f64(z2, sc2, sh2, w3, b3, mu3, inv3, coef1, coef2, s3dg, idx, mu2,
           inv2):
    """Trunk B1's float64 control (one group, fp32): ``(dy2, dw3)`` with
    every product and sum in float64 and h2, so BN2's ReLU mask, as the
    fp32 passes compute it (a mask that flipped at a value within
    rounding of zero would move a whole element, for every fp32 pass
    alike, and hide the products' error)."""
    h2 = torch.relu(z2.float() * sc2 + sh2)
    z3 = torch.matmul(h2.double(), w3.double()) + b3.double()
    zhat3 = (z3 - mu3.double()) * inv3.double()
    points = torch.arange(z2.shape[1], device=z2.device)[None, :, None]
    sparse = torch.where(points == idx[:, None, :],
                         s3dg.double()[:, None, :],
                         torch.zeros((), device=z2.device, dtype=torch.float64))
    dz3 = (sparse - coef1.double()[:, None, :]
           - zhat3 * coef2.double()[:, None, :])
    return (torch.matmul(dz3, w3.double().t()) * (h2 > 0),
            _rows64(h2).t() @ _rows64(dz3))


def f2_f64(z2, sc2, sh2, w3, b3):
    """Trunk F2's float64 control (one group, fp32): BN3's ``(sum, sum of
    squares)`` of z3 with the product and the sums in float64 and h2 as
    the fp32 passes compute it."""
    h2 = torch.relu(z2.float() * sc2 + sh2)
    z3 = torch.matmul(h2.double(), w3.double()) + b3.double()
    return z3.sum((0, 1)), (z3 * z3).sum((0, 1))


def bmid_f64(zc, dy, sc, mu, inv, coef1, coef2, zp, scp, shp, w, mup, invp):
    """Bmid's float64 control (fp32): ``(dy_prev, dw)`` in float64, the
    previous ReLU's mask as the fp32 passes compute it."""
    hp = torch.relu(zp.float() * scp + shp)
    dz = (dy.double() * sc.double() - coef1.double()
          - ((zc.double() - mu.double()) * inv.double()) * coef2.double())
    return (torch.matmul(dz, w.double().t()) * (hp > 0),
            _rows64(hp).t() @ _rows64(dz))


def pmid_f64(z_prev, sc, sh, w, b):
    """Pmid's float64 control (fp32): ``(z,)``, its product, in float64
    with h as the fp32 passes compute it. Its sums are held to the plain
    twin only: sum z^2 adds up the 3xTF32 step sums' truncation toward
    zero (about 1e-7 of each z) row by row, 2.45x the plain pass's error
    against float64 at B=2 N=2048, 512 -> 256 (PERF.md, PR 11)."""
    h = torch.relu(z_prev.float() * sc + sh)
    return (torch.matmul(h.double(), w.double()) + b.double(),)


def head_b1_f64(z1, dy1, sc1, mu1, inv1, coef1, coef2, pf, w1a):
    """The head's B1's float64 control (fp32): ``(dpf, dw1a)`` in
    float64."""
    dz = (dy1.double() * sc1.double() - coef1.double()
          - ((z1.double() - mu1.double()) * inv1.double()) * coef2.double())
    return torch.matmul(dz, w1a.double().t()), _rows64(pf).t() @ _rows64(dz)


def f1_f64(x, w2, b2):
    """Trunk F1's float64 control (fp32): ``(z2,)``, its product, in
    float64. Its sums are held to the plain twin only, as Pmid's are."""
    return (torch.matmul(x.double(), w2.double()) + b2.double(),)


def p1_f64(pf, g_row, w1a, b1):
    """P1's float64 control (fp32): ``(z1,)``, its product, in float64.
    Its sums are held to the plain twin only, as Pmid's are."""
    return ((torch.matmul(pf.double(), w1a.double())
             + g_row.double()[:, None, :]) + b1.double(),)


def logits(logp):
    """The logits a log-softmax carries: each row of ``logp`` less the
    row's mean, in float64 (the row's constant, lse, removed)."""
    lp = logp.double()
    return lp - lp.mean(-1, keepdim=True)


def p4_f64(z3, sc3, sh3, w4, b4):
    """P4's float64 control (fp32): ``(logits, logp)`` with the product
    and the log_softmax in float64, h3 as the fp32 passes compute it. The
    logits are held as well as logp: log-probs at 1e-4 do not separate one
    TF32 product (PERF.md §6)."""
    h3 = torch.relu(z3.float() * sc3 + sh3).double()
    logp = torch.log_softmax(torch.matmul(h3, w4.double()) + b4.double(),
                             dim=-1)
    return logits(logp), logp


def b4_f64(z3, sc3, sh3, w4, b4, mu3, inv3, dlogp):
    """B4's float64 control (fp32): ``(dy3, dw4)`` with every product and
    sum in float64, h3 and BN3's ReLU mask as the fp32 passes compute
    them."""
    h3 = torch.relu(z3.float() * sc3 + sh3).double()
    dl = dlogp.double()
    p = torch.softmax(torch.matmul(h3, w4.double()) + b4.double(), dim=-1)
    dz = dl - p * dl.sum(-1, keepdim=True)
    return (torch.matmul(dz, w4.double().t()) * (h3 > 0),
            _rows64(h3).t() @ _rows64(dz))


def b4_dy3_bf16(z3, sc3, sh3, w4, b4, mu3, inv3, dlogp):
    """The bf16 plain pass's dy3 before its stash rounds it (fp32)."""
    from adversarial_learning_on_pointclouds_tpu_torch.ops.kernels import (
        seg_head_train as sh,
    )
    h3 = sh._bn_relu(z3, sc3, sh3)
    p = torch.softmax(sh._mm(h3, w4, True) + b4, dim=-1)
    dz = dlogp - p * dlogp.sum(-1, keepdim=True)
    return sh._mm(dz, w4.t(), True) * (h3 > 0)


def truncated_stash_control(name, fp32, ref, ptag):
    """The control of a bf16 stash's share check: the pass's fp32 values
    rounded toward zero (fp32's low 16 bits cleared) must fail it."""
    trunc = (fp32.contiguous().view(torch.int32) & -65536).view(
        torch.float32).to(torch.bfloat16)
    try:
        check_stash(f"control: {name} rounded toward zero", trunc, ref, ptag,
                    STASH_SHARE)
    except AssertionError:
        phase(ptag, f"control: {name} rounded toward zero fails the stash "
              "check, as it must")
    else:
        raise AssertionError(f"the bf16 stash check passed {name} rounded "
                             "toward zero")


def tc_f64(rec, kernel, pas, tag, got, ref, ref64, names, ptag, control):
    """The float64 controls of a tensor-core pass's products (``names``,
    the first outputs), and with ``control`` (a plain pass's thunk) the
    TF32 control, which must fail."""
    for i, nm in enumerate(names):
        rec.cmp_f64(kernel, pas, f"{nm} {tag}", got[i], ref[i], ref64[i],
                    ptag)
    if control is not None:
        tf32_control(f"{kernel} {pas}'s plain pass ({names[0]}, {tag})",
                     control, ref64[0], ref[0], ptag)


def train_kernel_checks(dev, gen, rec, bf16=False):
    """Phase 6 (fp32), or with ``bf16`` the passes' half of phase 12."""
    from adversarial_learning_on_pointclouds_tpu_torch.models import core
    from adversarial_learning_on_pointclouds_tpu_torch.ops.kernels import (
        pool_fc_epilogue as pf, seg_head_train as sh, trunk_train as tt,
    )

    ptag = "bench-kernels" if bf16 else "train-kernels"
    xt = (1, True) if bf16 else ()       # the trunk passes' groups, bf16
    xb = (True,) if bf16 else ()         # the other passes' bf16

    c1, c2, c3 = 64, 128, 1024
    tw = dict(w2=_w(gen, c1, c2, dev), b2=_r(gen, c2, dev=dev),
              g2=_gam(gen, c2, dev), be2=_r(gen, c2, dev=dev),
              w3=_w(gen, c2, c3, dev), b3=_r(gen, c3, dev=dev),
              g3=_gam(gen, c3, dev, negative=0.3), be3=_r(gen, c3, dev=dev))
    hw = [(_w(gen, 1088, 512, dev), 512), (_w(gen, 512, 256, dev), 256),
          (_w(gen, 256, 128, dev), 128), (_w(gen, 128, PARTS, dev), PARTS)]
    hp = [(w, _r(gen, c, dev=dev), _gam(gen, c, dev), _r(gen, c, dev=dev))
          for w, c in hw]
    for bsz, n in ((B, TRAIN_N), (B, TRAIN_RAGGED_N), (2, TRAIN_N)):
        main = (bsz, n) == (B, TRAIN_N)
        tag = f"B={bsz} N={n}"
        # Trunk input: post-ReLU features; the first half of the clouds
        # repeat their first half of points in the second, so every
        # extremum there is a tie between two blocks.
        x = torch.relu(torch.randn(bsz, n, c1, generator=gen)).to(dev)
        dup_clouds = bsz // 2
        half = n // 2
        x[:dup_clouds, n - half:] = x[:dup_clouds, :half]
        with torch.no_grad():
            a = (x, tw["w2"], tw["b2"], *xt)
            got, ref = tt.f1(*a), tt.f1_plain(*a)
            rec.cmp("trunk2_train", "F1", tag, ("z2", "sum", "sumsq"), got,
                    ref, main, a, phase_tag=ptag, max_share=STASH_SHARE)
            if not bf16:
                tc_f64(rec, "trunk2_train", "F1", tag, got, ref, f1_f64(*a),
                       ("z2",), ptag,
                       (lambda: tt.f1_plain(*a)[0]) if main else None)
            elif main:
                truncated_stash_control(
                    f"trunk2_train F1 z2 {tag}",
                    torch.matmul(core.operand(x, True),
                                 core.operand(tw["w2"], True)) + tw["b2"],
                    ref[0], ptag)
            z2 = ref[0]
            mu2, _, inv2 = core.batch_moments(ref[1], ref[2], bsz * n)
            sc2 = tw["g2"] * inv2
            sh2 = tw["be2"] - mu2 * sc2
            a = (z2, sc2, sh2, tw["w3"], tw["b3"], *xt)
            got, ref = tt.f2(*a), tt.f2_plain(*a)
            rec.cmp("trunk2_train", "F2", tag, ("sum", "sumsq", "max", "min"),
                    got[:4], ref[:4], main, a, phase_tag=ptag)
            z3 = torch.matmul(
                core.operand(torch.relu(z2.float() * sc2 + sh2), bf16),
                core.operand(tw["w3"], bf16)) + tw["b3"]
            check_winners(tag, got[4], ref[4], z3, x, dup_clouds, n, "max",
                          ptag)
            check_winners(tag, got[5], ref[5], -z3, x, dup_clouds, n, "min",
                          ptag)
            del z3
            if not bf16:
                tc_f64(rec, "trunk2_train", "F2", tag, got, ref,
                       f2_f64(*a[:5]), ("sum", "sumsq"), ptag,
                       (lambda: tt.f2_plain(*a)[0]) if main else None)
            mu3, _, inv3 = core.batch_moments(ref[0], ref[1], bsz * n)
            s3c = tw["g3"] * inv3
            idx = torch.where(s3c >= 0, ref[4], ref[5])
            dg = _r(gen, bsz, c3, scale=1.0, dev=dev)
            a = (z2, sc2, sh2, tw["w3"], tw["b3"], mu3, inv3,
                 _r(gen, bsz, c3, scale=1e-3, dev=dev),
                 _r(gen, bsz, c3, scale=1e-3, dev=dev), s3c * dg, idx, mu2,
                 inv2, *xt)
            got, ref = tt.b1(*a), tt.b1_plain(*a)
            rec.cmp("trunk2_train", "B1", tag,
                    ("dy2", "dw3", "db3", "t1", "t2"), got, ref, main, a,
                    phase_tag=ptag)
            if not bf16:
                tc_f64(rec, "trunk2_train", "B1", tag, got, ref, b1_f64(*a),
                       ("dy2", "dw3"), ptag,
                       (lambda: tt.b1_plain(*a)[0]) if main else None)

            # Seg head, pass by pass on the plain pass's outputs.
            pf_in = x
            g = torch.relu(torch.randn(bsz, 1024, generator=gen)).to(dev)
            m = bsz * n
            (w1, b1, g1, be1), (w2, b2, g2, be2), (w3, b3, g3, be3), \
                (w4, b4, _, _) = hp
            g_row = torch.matmul(g, w1[64:])
            a = (pf_in, g_row, w1[:64], b1, *xb)
            got, ref = sh.p1(*a), sh.p1_plain(*a)
            rec.cmp("seg_head_train", "P1", tag, ("z1", "sum", "sumsq"), got,
                    ref, main, a, phase_tag=ptag, max_share=STASH_SHARE)
            if not bf16:
                tc_f64(rec, "seg_head_train", "P1", tag, got, ref, p1_f64(*a),
                       ("z1",), ptag,
                       (lambda: sh.p1_plain(*a)[0]) if main else None)
            elif main:
                truncated_stash_control(
                    f"seg_head_train P1 z1 {tag}",
                    sh._mm(pf_in, w1[:64], True) + g_row[:, None, :] + b1,
                    ref[0], ptag)
            zs, scs, shs, mus, invs = [ref[0]], [], [], [], []
            for (w, b, ga, be), (wn, bn, _, _) in zip(hp[:3], hp[1:]):
                mu, _, inv = core.batch_moments(ref[1], ref[2], m)
                scs.append(ga * inv)
                shs.append(be - mu * ga * inv)
                mus.append(mu)
                invs.append(inv)
                if wn is w4:
                    break
                a = (zs[-1], scs[-1], shs[-1], wn, bn, *xb)
                got, ref = sh.pmid(*a), sh.pmid_plain(*a)
                t = f"{wn.shape[0]}->{wn.shape[1]} {tag}"
                rec.cmp("seg_head_train", "Pmid", t, ("z", "sum", "sumsq"),
                        got, ref, main, a, phase_tag=ptag,
                        max_share=STASH_SHARE)
                if not bf16:
                    tc_f64(rec, "seg_head_train", "Pmid", t, got, ref,
                           pmid_f64(*a), ("z",), ptag,
                           (lambda: sh.pmid_plain(*a)[0])
                           if main and wn is w2 else None)
                elif main:
                    truncated_stash_control(
                        f"seg_head_train Pmid z {t}",
                        sh._mm(sh._bn_relu(*a[:3]), wn, True) + bn, ref[0],
                        ptag)
                zs.append(ref[0])
            a = (zs[2], scs[2], shs[2], w4, b4, *xb)
            logp, got4 = sh.p4_plain(*a), sh.p4(*a)
            rec.cmp("seg_head_train", "P4", tag, ("logp",), (got4,),
                    (logp,), main, a, phase_tag=ptag)
            if not bf16:
                tc_f64(rec, "seg_head_train", "P4", tag,
                       (logits(got4), got4), (logits(logp), logp),
                       p4_f64(*a), ("logits", "logp"), ptag,
                       (lambda: logits(sh.p4_plain(*a))) if main else None)
            dlogp = _r(gen, bsz, n, PARTS, scale=1.0, dev=dev)
            a = (zs[2], scs[2], shs[2], w4, b4, mus[2], invs[2], dlogp, *xb)
            got, ref = sh.b4(*a), sh.b4_plain(*a)
            rec.cmp("seg_head_train", "B4", tag,
                    ("dy3", "dw4", "db4", "t1", "t2"), got, ref, main, a,
                    phase_tag=ptag, max_share=STASH_SHARE)
            if not bf16:
                tc_f64(rec, "seg_head_train", "B4", tag, got, ref, b4_f64(*a),
                       ("dy3", "dw4"), ptag,
                       (lambda: sh.b4_plain(*a)[0]) if main else None)
            elif main:
                truncated_stash_control(f"seg_head_train B4 dy3 {tag}",
                                        b4_dy3_bf16(*a[:8]), ref[0], ptag)
            dy = ref[0]
            t1, t2 = ref[3], ref[4]
            for cur, prev, w in ((2, 1, w3), (1, 0, w2)):
                a = (zs[cur], dy, scs[cur], mus[cur], invs[cur],
                     scs[cur] * t1 / m, scs[cur] * t2 / m, zs[prev],
                     scs[prev], shs[prev], w, mus[prev], invs[prev], *xb)
                got, ref = sh.bmid(*a), sh.bmid_plain(*a)
                t = f"{w.shape[1]}->{w.shape[0]} {tag}"
                rec.cmp("seg_head_train", "Bmid", t,
                        ("dy_prev", "dw", "db", "t1", "t2"), got, ref, main,
                        a, dz_scales(sh, a), ptag)
                if not bf16:
                    tc_f64(rec, "seg_head_train", "Bmid", t, got, ref,
                           bmid_f64(*a), ("dy_prev", "dw"), ptag,
                           (lambda: sh.bmid_plain(*a)[0])
                           if main and cur == 1 else None)
                dy, t1, t2 = ref[0], ref[3], ref[4]
            a = (zs[0], dy, scs[0], mus[0], invs[0], scs[0] * t1 / m,
                 scs[0] * t2 / m, pf_in, w1[:64], *xb)
            got, ref = sh.b1(*a), sh.b1_plain(*a)
            rec.cmp("seg_head_train", "B1", tag, ("dpf", "dw1a", "db1", "r"),
                    got, ref, main, a, dz_scales(sh, a), ptag)
            if not bf16:
                tc_f64(rec, "seg_head_train", "B1", tag, got, ref,
                       head_b1_f64(*a), ("dpf", "dw1a"), ptag,
                       (lambda: sh.b1_plain(*a)[0]) if main else None)
        torch.cuda.synchronize()

    # P1 and P4 at N=2047 too: the odd clouds' rows start off a 16-byte
    # boundary of z1 and logp (P4's vector stores start after a scalar
    # head).
    tag = f"B={B} N={RAGGED_N}"
    (w1, b1, _, _), (w4, b4, _, _) = hp[0], hp[3]
    with torch.no_grad():
        pf_in = torch.relu(torch.randn(B, RAGGED_N, 64, generator=gen)).to(dev)
        g_row = torch.matmul(
            torch.relu(torch.randn(B, 1024, generator=gen)).to(dev), w1[64:])
        a = (pf_in, g_row, w1[:64], b1, *xb)
        rec.cmp("seg_head_train", "P1", tag, ("z1", "sum", "sumsq"),
                sh.p1(*a), sh.p1_plain(*a), False, a, phase_tag=ptag,
                max_share=STASH_SHARE)
        z3 = _r(gen, B, RAGGED_N, 128, scale=1.0, dev=dev)
        a = (z3.to(torch.bfloat16) if bf16 else z3, _gam(gen, 128, dev),
             _r(gen, 128, dev=dev), w4, b4, *xb)
        rec.cmp("seg_head_train", "P4", tag, ("logp",), (sh.p4(*a),),
                (sh.p4_plain(*a),), False, a, phase_tag=ptag)
    torch.cuda.synchronize()

    # The pool-fc epilogue (csrc/small_fc.cuh's split-K product across
    # clusters) at the T-Net head's shapes: groups 1 (one stream of 32),
    # 2 (two streams of 32 stacked), two rows in a BN (B=2: the moments
    # centred on the batch means, which running means track; about a far
    # centre two rows' one-pass variance cancels to a few bits in any
    # order of sums), and relu_fc_bn_relu's identity fold (mn, s3c, t3
    # None: h = relu(mx)). In fp32 z1 and var also by the float64
    # control, and at B=32 the TF32 control on z1.
    wf = _w(gen, 1024, 512, dev)
    for bsz, groups, ident in ((B, 1, False), (2 * B, 2, False),
                               (2, 1, False), (2 * B, 2, True)):
        mx = torch.randn(bsz, 1024, generator=gen).to(dev)
        fold = (None,) * 3 if ident else (
            mx - torch.rand(bsz, 1024, generator=gen).to(dev),
            _r(gen, 1024, scale=1.0, dev=dev), _r(gen, 1024, dev=dev))
        a = [mx, *fold, wf, _r(gen, 512, dev=dev), _gam(gen, 512, dev),
             _r(gen, 512, dev=dev), _r(gen, 512, dev=dev), groups, *xb]
        if bsz == 2:
            a[8] = pf.pool_fc_fwd_plain(*a)[3][0]
        main = (bsz, groups, ident) == (B, 1, False)
        tag = f"B={bsz} groups={groups}{' identity' if ident else ''}"
        with torch.no_grad():
            got, ref = pf.pool_fc_fwd(*a), pf.pool_fc_fwd_plain(*a)
            rec.cmp("pool_fc_epilogue", "fwd", tag,
                    ("h1", "h", "z1", "mu", "var", "inv"), got, ref, main, a,
                    phase_tag=ptag)
            if not bf16 and bsz > 2:
                ref64 = pf.pool_fc_fwd_plain(*f64(a))
                tc_f64(rec, "pool_fc_epilogue", "fwd", tag,
                       (got[2], got[4]), (ref[2], ref[4]),
                       (ref64[2], ref64[4]), ("z1", "var"), ptag,
                       (lambda: pf.pool_fc_fwd_plain(*a)[2]) if main
                       else None)
    if bf16:   # the bf16 functions are held to the CPU by the bench step
        torch.cuda.synchronize()
        return

    # Each autograd function against its whole-function reference.
    bsz, n = B, TRAIN_N
    cases = {
        "trunk2_train": (tt.trunk2_train, tt.trunk2_train_reference,
                         [torch.relu(torch.randn(bsz, n, c1, generator=gen))
                          .to(dev), *tw.values()]),
        "seg_head_train": (sh.seg_head_train, sh.seg_head_train_reference,
                           [torch.relu(torch.randn(bsz, n, 64, generator=gen))
                            .to(dev), torch.randn(bsz, 1024, generator=gen)
                            .to(dev), *[t for p in hp for t in p][:14]]),
        "pool_fc_epilogue": (pf.pool_fc_epilogue, pf.pool_fc_epilogue_reference,
                             [mx[:B], mx[:B] - 1, _r(gen, 1024, scale=1.0,
                                                     dev=dev),
                              _r(gen, 1024, dev=dev), wf,
                              _r(gen, 512, dev=dev), _gam(gen, 512, dev),
                              _r(gen, 512, dev=dev)]),
    }
    # A bias in front of a batch-statistic BN has a zero gradient in exact
    # arithmetic: what both sides compute is the rounding of a cancelling
    # sum over the rows, held to the norm of the same layer's weight
    # gradient (a sum over the same rows).
    zero_grads = {"trunk2_train": {2: 1, 6: 5},
                  "seg_head_train": {3: 2, 7: 6, 11: 10},
                  "pool_fc_epilogue": {5: 4}}
    for name, (fn, ref_fn, args) in cases.items():
        outs = []
        for f in (fn, ref_fn):
            # clone keeps the strides: weights stay [in, out] views
            leaves = [t.detach().clone().requires_grad_() for t in args]
            out = f(*leaves)
            torch.sin(out[0]).sum().backward()
            outs.append((out, [t.grad for t in leaves]))
        (o, g), (o_ref, g_ref) = outs
        for i, (a_, b_) in enumerate(zip(o, o_ref)):
            check_norm(f"{name} autograd output {i}", a_.detach(),
                       b_.detach())
        for i, (a_, b_) in enumerate(zip(g, g_ref)):
            w = zero_grads[name].get(i)
            check_norm(f"{name} autograd grad {i}", a_, b_,
                       None if w is None else g_ref[w].norm().item())
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# The training step (phases 7-8)
# ---------------------------------------------------------------------------

def pass_counters():
    from adversarial_learning_on_pointclouds_tpu_torch.ops.kernels import (
        pool_fc_epilogue as pf, seg_head_train as sh, trunk_train as tt,
    )
    return {"trunk2_train": tt.PASSES, "seg_head_train": sh.PASSES,
            "pool_fc_epilogue": {"fwd": pf.pool_fc_fwd}}


def seg_setup(cfg, gen, seed):
    """A seeded full-width segmenter (random BatchNorm statistics) and a
    batch of ``cfg.batch_size`` clouds of ``cfg.num_points`` with part
    labels (numpy)."""
    from adversarial_learning_on_pointclouds_tpu_torch.models import (
        PointNetDenseCls,
    )

    bsz, n = cfg.batch_size, cfg.num_points
    model = PointNetDenseCls(cfg.num_parts, cfg.feature_transform,
                             generator=gen)
    randomize_bn(model, gen)
    rng = np.random.default_rng(seed)
    pts = (rng.normal(size=(bsz, n, 3)) * rng.uniform(0.5, 2.0, (bsz, 1, 3))
           ).astype(np.float32)
    labels = (np.arange(n)[None, :] * 7 // n
              + 7 * (pts[..., 1] > 0)).astype(np.int64) % cfg.num_parts
    return model, pts, labels


def seg_step_runs(cfg, model, pts, labels, tag, counters, switch=False,
                  record=None):
    """One ``segment.train_step`` on the card and on the CPU from the same
    weights and batch: ``({where: (state, metrics, log-probs, x, y, tx)},
    launches on the card)``, the counts set to 0 just before the card's
    step and read just after it; ``switch`` and ``record`` as
    ``step_runs``."""
    from adversarial_learning_on_pointclouds_tpu_torch.ops import dispatch
    from adversarial_learning_on_pointclouds_tpu_torch.train import segment

    bsz, n = cfg.batch_size, cfg.num_points
    runs, launches = {}, None
    for where in ("cuda", "cpu"):
        m = copy.deepcopy(model)
        logps = []
        m.register_forward_hook(lambda mod, inp, out: logps.append(
            out[0].detach()))
        state = segment.create_state(cfg, 100, device=where, model=m)
        tx = segment.make_tx(cfg, 100)
        x = torch.from_numpy(pts).to(where)
        y = torch.from_numpy(labels).to(where)
        recorder = PassCalls(pt_counters() if record is not None and
                             where == "cuda" else {})
        reset(counters)
        t0 = time.perf_counter()
        with dispatch.use_pallas_train(switch), recorder as calls:
            metrics = segment.train_step(state, x, y, cfg=cfg, tx=tx)
        if where == "cuda":
            torch.cuda.synchronize()
            launches = read(counters)
            if record is not None:
                record.update(calls)
        phase(tag, f"train_step on {where} B={bsz} N={n}: "
              f"loss {float(metrics['loss']):.6f}, acc "
              f"{float(metrics['acc']):.4f}, "
              f"{time.perf_counter() - t0:.3f} s (first step)")
        runs[where] = (state, metrics, logps[0], x, y, tx)
    return runs, launches


def compare_seg(tag, runs):
    """The card's config-3 step against the CPU's: loss, log-probs, every
    new running statistic and every gradient."""
    (gs, gm, glogp, _, _, _), (cs, cm, clogp, _, _, _) = runs["cuda"], \
        runs["cpu"]
    check("loss GPU vs CPU", gm["loss"].cpu()[None], cm["loss"][None],
          STEP_BOUND, tag)
    check("log-probs GPU vs CPU", glogp.cpu(), clogp, STEP_BOUND, tag)
    gsd, csd = gs.model.state_dict(), cs.model.state_dict()
    stats = [k for k in csd if k.endswith(("running_mean", "running_var"))]
    worst = max(rel_err(gsd[k].cpu(), csd[k])[0] for k in stats)
    phase(tag, f"{len(stats)} new running statistics GPU vs CPU: "
          f"max scale-relative error {worst:.3e} (bound {STEP_BOUND:g})")
    if worst > STEP_BOUND:
        raise AssertionError("running statistics differ")
    gp = dict(gs.model.named_parameters())
    cp = dict(cs.model.named_parameters())
    scale = max(float(p.grad.abs().max()) for p in cp.values())
    worst = max(float((gp[k].grad.cpu() - p.grad).abs().max())
                for k, p in cp.items())
    phase(tag, f"{len(cp)} parameter gradients GPU vs CPU: max abs "
          f"error {worst:.3e}, {worst / (1 + scale):.3e} of (1 + max|g| = "
          f"{1 + scale:.3e}) (bound {GRAD_BOUND:g})")
    if worst > GRAD_BOUND * (1 + scale):
        raise AssertionError("gradients differ")


def train_slice(dev, card, gen):
    from adversarial_learning_on_pointclouds_tpu_torch.configs import (
        SegmentConfig,
    )
    from adversarial_learning_on_pointclouds_tpu_torch.train import segment

    cfg = SegmentConfig()
    model, pts, labels = seg_setup(cfg, gen, SEED)
    runs, launches = seg_step_runs(cfg, model, pts, labels, "train-slice",
                                   pass_counters())
    for k, per in PER_STEP.items():
        if launches[k] != per:
            raise AssertionError(f"{k} launched {launches[k]} in one step, "
                                 f"expected {per}")
    phase("train-slice", f"launches in one step: {launches}")
    compare_seg("train-slice", runs)

    state, _, _, x, y, tx = runs["cuda"]
    losses = [float(segment.train_step(state, x, y, cfg=cfg, tx=tx)["loss"])
              for _ in range(10)]
    phase("train-slice", f"10 more Adam steps on the fixed batch: loss "
          f"{losses[0]:.5f} -> {losses[-1]:.5f}")
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    if not all(torch.isfinite(p).all() for p in state.model.parameters()):
        raise AssertionError("non-finite parameters after training")
    return runs["cuda"], launches


def train_timing(card, rec, cuda_run, launches, results):
    from adversarial_learning_on_pointclouds_tpu_torch.configs import (
        SegmentConfig,
    )
    from adversarial_learning_on_pointclouds_tpu_torch.ops import build
    from adversarial_learning_on_pointclouds_tpu_torch.train import segment

    counters = pass_counters()
    rows = {}
    for (kernel, pas), calls in rec.args.items():
        fn = counters[kernel][pas]
        plain = getattr(sys.modules[fn.__module__], fn.__name__ + "_plain")
        # Times per step: each distinct call once, times its repeats.
        times = PER_STEP[kernel][pas] / len(calls)
        with torch.no_grad():
            ms, plain_ms = time_pair(lambda: [fn(*a) for a in calls],
                                     lambda: [plain(*a) for a in calls])
            dev_ms = sum(device_profile(
                lambda: [fn(*a) for a in calls]).values())
            plain_dev_ms = sum(device_profile(
                lambda: [plain(*a) for a in calls]).values())
        flops, nbytes = work(plain, calls)
        tc = (kernel, pas) in TC_PASSES
        bound_ms, bound_by = bound(flops, nbytes,
                                   TF32X3_PEAK if tc else FP32_PEAK)
        fma_ms = bound(flops, nbytes)[0] * times
        tflops = flops / ms / 1e9
        ms, plain_ms, dev_ms, plain_dev_ms, bound_ms = (
            t * times for t in (ms, plain_ms, dev_ms, plain_dev_ms, bound_ms))
        phase("train-timing", f"{card}: {kernel} {pas} x"
              f"{PER_STEP[kernel][pas]} per step at B={B} N={TRAIN_N}: "
              f"kernel {ms:.4f} ms ({tflops:.1f} TFLOP/s), plain "
              f"{plain_ms:.4f} ms; device time alone: kernel {dev_ms:.4f} "
              f"ms, plain {plain_dev_ms:.4f} ms; bound {bound_ms:.4f} ms"
              + (f" (3xTF32 rate; at the fp32 FMA rate {fma_ms:.4f} ms)"
                 if tc else ""))
        row = {
            "pass": pas,
            "replaces": f"{TPU_KERNELS}/{TRAIN_KERNELS[kernel][1][pas]}",
            "launches": launches[kernel][pas],
            "max_abs_err": rec.err[(kernel, pas)], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "device_ms": dev_ms, "plain_device_ms": plain_dev_ms,
            "tflops": tflops}
        if tc:
            tc_src = (FC_SOURCE if kernel == "pool_fc_epilogue"
                      else "train_bwd_tc.cu")
            row.update(bound_fma_ms=fma_ms,
                       source=f"{KERNELS_ROOT}/csrc/{tc_src}")
        if kernel == "pool_fc_epilogue":
            row["f64_ratio"] = rec.f64.get((kernel, pas))
        rows.setdefault(kernel, []).append(row)
    for kernel, passes in rows.items():
        src, sites = TRAIN_KERNELS[kernel]
        results.append(kernel_entry(
            kernel, src, sites[next(iter(sites))],
            sum(launches[kernel].values()), passes, "per config-3 step"))
        if kernel == "pool_fc_epilogue":
            results[-1]["sources"] = [results[-1]["source"],
                                      f"{KERNELS_ROOT}/csrc/{FC_SOURCE}"]
            results[-1]["ptxas"] = ptxas_report(build, src)

    state, _, _, x, y, tx = cuda_run
    cfg = SegmentConfig()

    def step():
        segment.train_step(state, x, y, cfg=cfg, tx=tx)

    for _ in range(3):
        step()
    step_ms = statistics.median(event_ms(step, 12))
    pts = cfg.batch_size * cfg.num_points
    phase("train-timing", f"{card}: train_step B={cfg.batch_size} "
          f"N={cfg.num_points}: median {step_ms:.3f} ms over 12 steps, "
          f"{pts / step_ms * 1e3:.1f} points/s")
    kernels = device_profile(step, reps=5)
    busy = sum(kernels.values())
    phase("train-timing", f"{card}: step B={cfg.batch_size} "
          f"N={cfg.num_points}: GPU kernels busy {busy:.3f} ms of "
          f"{step_ms:.3f} ms ({100 * (1 - busy / step_ms):.1f}% idle), "
          f"{len(kernels)} kernel names")
    for key, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:12]:
        phase("train-timing", f"  {ms:.4f} ms  {key[:90]}")


# ---------------------------------------------------------------------------
# The discriminator's passes against their plain passes (phase 9)
# ---------------------------------------------------------------------------

def disc_params(gen, dev, k=PARTS):
    """Random [in, out] weight views and biases of the k -> 64 -> 128 ->
    256 -> 512 -> 1 stack."""
    ws, bs, c = [], [], k
    for o in (64, 128, 256, 512, 1):
        ws.append(_w(gen, c, o, dev))
        bs.append(_r(gen, o, dev=dev))
        c = o
    return ws, bs


def prob_maps(gen, bsz, n, dev):
    """Softmax maps with every fifth point one-hot (the D step's reals)."""
    x = torch.softmax(torch.randn(bsz, n, PARTS, generator=gen) * 3, -1)
    hot = torch.randint(0, PARTS, (bsz, len(range(0, n, 5))), generator=gen)
    x[:, ::5] = torch.nn.functional.one_hot(hot, PARTS).float()
    return x.to(dev)


def _disc_operands(x, g, sc):
    """The weight-gradient pass's own operands from its scratch: the rows
    of x and g, h0..h3 (h0 = x) and dz1..dz4 (views)."""
    from adversarial_learning_on_pointclouds_tpu_torch.ops.kernels import (
        disc_fused as df,
    )

    cut = [0]
    for c in df.WIDTHS[:4]:
        cut.append(cut[-1] + c)
    xs, gs = x.reshape(-1, x.shape[-1]), g.reshape(-1, 1)
    hs = [xs] + [sc["hs"][:, cut[i]:cut[i + 1]] for i in range(3)]
    dzs = [sc["dzs"][:, cut[i]:cut[i + 1]] for i in range(4)]
    return xs, gs, hs, dzs


def disc_products(x, g, ws, bs, sc, bf16=False, dx=False, f64=False,
                  h4p=None):
    """Every product and sum of the discriminator's weight-gradient pass
    (``disc_tc.cu``) computed in plain PyTorch on the pass's own operands
    (its scratch ``sc``: h1..h3 and dz1..dz4), as ``{name: value}``:
    h1..h3 = leaky(h W + b), dz4 = g w5 leaky'(h4) with the pass's own
    LeakyReLU branches for h4 (read back from dz4), dz3..dz1 = (dz W^T)
    leaky'(h) with the branches of the pass's h, dx, dW1..dW4 = h^T dz,
    dW5 = leaky(h3 W4 + b4)^T g (``h4p``, the pass's own rounding of h4
    from ``pass_h4``, in its place when given) and db1..db5; with ``f64``
    every product and sum in float64 (the control), else bf16 operands
    under ``bf16`` and fp32 sums. Also returns h4's pre-activation and the
    pass's branches for it. A kernel's forward and cuBLAS's legitimately take
    different LeakyReLU branches where a pre-activation lies within
    rounding of zero (a few per 10^7 at these widths), which moves a whole
    dz element; held on its own operands, each of the pass's products is
    compared with the same product, branch for branch."""
    from adversarial_learning_on_pointclouds_tpu_torch.models import core
    from adversarial_learning_on_pointclouds_tpu_torch.ops.kernels import (
        disc_fused as df,
    )

    op = (lambda t: t.double()) if f64 else (
        lambda t: core.operand(t, bf16))
    fb = (lambda t: t.double()) if f64 else (lambda t: t)
    xs, gs, hs, dzs = _disc_operands(x, g, sc)
    out = {}
    for i in range(3):
        out[f"h{i + 1}"] = df.leaky(op(hs[i]) @ op(ws[i]) + fb(bs[i]))
    z4 = op(hs[3]) @ op(ws[3]) + fb(bs[3])
    gw5 = core.operand(gs, bf16) * core.operand(ws[4][:, 0], bf16)
    branch4 = dzs[3] == gw5                     # h4 >= 0 in the pass
    out["dz4"] = (op(gs) * op(ws[4][:, 0])) * torch.where(
        branch4, 1.0, df.SLOPE).to(z4.dtype)
    for i in (3, 2, 1):
        out[f"dz{i}"] = (op(dzs[i]) @ op(ws[i]).t()) * df._dleaky(
            hs[i]).to(z4.dtype)
    if dx:
        out["dx"] = (op(dzs[0]) @ op(ws[0]).t()).reshape(x.shape)
    for i in range(4):
        out[f"dw{i + 1}"] = op(hs[i]).t() @ op(dzs[i])
    out["dw5"] = (op(df.leaky(z4)) if h4p is None else h4p).t() @ op(gs)
    for i in range(4):
        out[f"db{i + 1}"] = fb(dzs[i]).sum(0)
    out["db5"] = fb(gs).sum(0)
    return out, z4, branch4


def disc_plain_branched(x, g, ws, bs, bf16, full, branches, near, bound,
                        h4p=None):
    """The plain twin from ``x`` (``disc_bwd_plain``'s products, operands
    and sums; ``disc_bwd_dw_plain``'s without ``full``) with the pass's
    LeakyReLU branch (``branches``: h1..h4 >= 0 in the pass) at each
    pre-activation where the two take different ones. Each such flip
    must lie within ``bound`` of the scale of zero, in the plain twin's
    pre-activation and in the pass's own (``near``), else it raises.
    ``h4p`` (bf16: the pass's own rounding of h4, ``pass_h4``) is dW5's
    operand where given. Returns ``(dx or None, dws, dbs)`` and the flips
    per layer."""
    from adversarial_learning_on_pointclouds_tpu_torch.ops.kernels import (
        disc_fused as df,
    )

    hs, masks, flips = [x], [], []
    for i in range(4):
        z = df._mm(hs[-1], ws[i], bf16) + bs[i]
        mask = branches[i].reshape(z.shape)
        diff = mask != (z >= 0)
        for t in (z, near[i].reshape(z.shape)):
            worst = t[diff].abs().max().item() if diff.any() else 0.0
            if worst > bound * max(1.0, t.abs().max().item()):
                raise AssertionError(
                    f"h{i + 1} takes another LeakyReLU branch in the pass "
                    f"than in the plain twin at |pre-activation| "
                    f"{worst:.3e}")
        flips.append(int(diff.sum()))
        masks.append(mask)
        hs.append(torch.where(mask, z, df.SLOPE * z))
    dh, dws, dbs = g, [], []
    for i in reversed(range(5)):
        dz = dh if i == 4 else dh * torch.where(masks[i], 1.0, df.SLOPE)
        h = h4p if i == 4 and h4p is not None else df._rows(hs[i])
        dws.insert(0, df._mm(h.t(), df._rows(dz), bf16))
        dbs.insert(0, dz.sum((0, 1)))
        if i > 0 or full:
            dh = df._mm(dz, ws[i].t(), bf16)
    return (dh if full else None), dws, dbs, flips


def pass_h4(x, ws, bs, bf16):
    """The pass's own h4 as its dW5 product takes it (``operand(h4)``,
    ``[m, 512]``), read back from its per-tile dW5 partials: with a
    cotangent that is 1 at row j of every 64-row tile and 0 elsewhere,
    tile t's partial is row j's h4 exactly (one term; every other adds
    0), so ``DISC_TILE`` launches give every row. h4 does not depend on
    g, so this is the h4 of every launch on ``x``."""
    from adversarial_learning_on_pointclouds_tpu_torch.ops import launch
    from adversarial_learning_on_pointclouds_tpu_torch.ops.kernels import (
        disc_fused as df,
    )

    m, tile = x.shape[0] * x.shape[1], launch.DISC_TILE
    h4 = torch.empty(-(-m // tile) * tile, df.WIDTHS[3], device=x.device)
    for j in range(tile):
        g = torch.zeros(m, device=x.device)
        g[j::tile] = 1.0
        sc = {}
        df._bwd_dw_launch(x, g.view(*x.shape[:2], 1), ws, bs, None, bf16,
                          scratch=sc)
        h4[j::tile] = sc["part"][:, :df.WIDTHS[3]]
    return h4[:m]


def check_disc_dw(rec, tag, x, g, ws, bs, bf16, full, main, ptag, h4p=None):
    """``disc_bwd_dw`` (``full``: ``disc_bwd``) on the card, held whole
    pass to its plain twin from ``x`` at ``rec.bound``: dW, db (and dx),
    with the pass's LeakyReLU branch at each pre-activation within
    rounding of zero where the two differ (``disc_plain_branched``:
    counted, and bounded; with none, the twin unchanged). Also product by
    product on the pass's own operands (``disc_products``: every h and dz
    of its row pass, dx, every dW and db), which locates a fault; in fp32
    each output is held to the float64 control (``F64_FACTOR`` times the
    plain pass's error), and on the main shape a TF32 product (dW4) must
    fail it. With ``full``, ``disc_bwd_dx`` on the same inputs too: its dx
    bit-equal to the full pass's (the same products in the same order),
    so held by the same references (recorded as its own pass).

    bf16 (``h4p``, the pass's own rounding of h4 from ``pass_h4``): dW5 =
    h4^T g sums 10^5 terms of both signs to a few units at most; where the
    pass's fp32 z4 and cuBLAS's straddle a bf16 rounding midpoint, h4
    rounds to the other neighbour, which moves dW5 by one bf16 step of a
    term (about 4e-3 on a term near 1), past 1e-3 of a small max|dW5|. So
    dW5 takes the pass's own h4 as its operand, at the same bound, and
    with the rounding the same on both sides each element is held to its
    own magnitude (``check``'s element-wise scale: ``bound * max(1,
    |dW5|)``, tighter than ``bound * max(1, max|dW5|)``). h4 itself is
    held to the plain twin's: each element equal or one bf16 step apart,
    and at most ``STASH_SHARE`` of them apart. On the main shape two
    controls must fail: a dW5 taken from the unrounded fp32 h4, and h4
    rounded toward zero in place of the pass's. The same rule holds dx:
    its product takes the pass's own dz1, rounded as the pass rounds
    it."""
    from adversarial_learning_on_pointclouds_tpu_torch.models import core
    from adversarial_learning_on_pointclouds_tpu_torch.ops.kernels import (
        disc_fused as df,
    )

    pas = "bwd" if full else "bwd_dw"
    sc = {}
    a = (x, g, ws, bs, bf16)
    dxk = torch.empty_like(x) if full else None
    got = df._bwd_dw_launch(x, g, ws, bs, dxk, bf16, scratch=sc)
    xs, gs, hs, dzs = _disc_operands(x, g, sc)
    kern = {f"h{i}": hs[i] for i in (1, 2, 3)}
    kern.update({f"dz{i + 1}": dzs[i] for i in range(4)})
    if full:
        kern["dx"] = dxk
    kern.update({f"dw{i + 1}": w for i, w in enumerate(got[0])})
    kern.update({f"db{i + 1}": b for i, b in enumerate(got[1])})
    plain, z4, branch4 = disc_products(x, g, ws, bs, sc, bf16, full,
                                       h4p=h4p)
    own = None if h4p is None else {"dw5": plain["dw5"].abs()}
    rec.cmp("disc_fused", pas, f"{tag} on its operands", list(kern),
            list(kern.values()), [plain[k] for k in kern], False, a, own,
            phase_tag=ptag)
    if h4p is not None:
        ref4 = core.operand(df.leaky(z4), True).to(torch.bfloat16)
        check_stash(f"disc_fused {pas} h4 {tag} (the pass's rounding, read "
                    "from its dW5 partials)", h4p.to(torch.bfloat16), ref4,
                    ptag, STASH_SHARE)
        terms = (ref4.float().abs().t()
                 @ core.operand(gs, True).abs()).max().item()
        phase(ptag, f"disc_fused {pas} dW5 {tag}: max|dW5| "
              f"{got[0][4].abs().max().item():.3f}, its terms' magnitudes "
              f"max sum |h4||g| {terms:.1f}")
        if main and not full:
            ctrl = df.leaky(z4).t() @ core.operand(gs, True)
            try:
                check(f"control: disc_fused {pas} dW5 {tag} against the "
                      "unrounded fp32 h4", kern["dw5"], ctrl, rec.bound,
                      ptag, ctrl.abs())
            except AssertionError:
                phase(ptag, "control: a dW5 of the unrounded h4 fails the "
                      "bound, as it must")
            else:
                raise AssertionError("the bf16 dW5 check passed a dW5 of "
                                     "the unrounded fp32 h4")
            truncated_stash_control(f"disc_fused {pas} h4 {tag}",
                                    df.leaky(z4), ref4, ptag)

    names = [k for k in kern if k[:2] in ("dx", "dw", "db")]
    dx, dws, dbs, flips = disc_plain_branched(
        x, g, ws, bs, bf16, full, [hs[1] >= 0, hs[2] >= 0, hs[3] >= 0,
                                   branch4], [hs[1], hs[2], hs[3], z4],
        rec.bound, h4p)
    phase(ptag, f"disc_fused {pas} {tag}: LeakyReLU branches other than "
          f"the plain twin's in h1..h4: {flips} of {xs.shape[0]} x "
          f"{list(df.WIDTHS[:4])}, each within {rec.bound:g} of the scale "
          "of zero")
    # With no flip this is the plain twin unchanged, bit for bit.
    twin = ("plain twin, the pass's branches at the flips" if sum(flips)
            else "plain twin unchanged: no flip")
    rec.cmp("disc_fused", pas, f"{tag} from x ({twin})", names,
            [kern[k] for k in names],
            ([dx] if full else []) + list(dws) + list(dbs), main, a,
            None if h4p is None else {"dw5": dws[4].abs()}, phase_tag=ptag)
    if full:
        dxo = df.disc_bwd_dx(*a)
        if not torch.equal(dxo, dxk):
            raise AssertionError(f"disc_fused bwd_dx {tag}: dx differs from "
                                 "the full backward's")
        phase(ptag, f"disc_fused bwd_dx {tag}: dx bit-equal to the full "
              "backward's")
        rec.cmp("disc_fused", "bwd_dx", f"{tag} from x ({twin})", ("dx",),
                (dxo,), (dx,), main, a, phase_tag=ptag)
        rec.cmp("disc_fused", "bwd_dx", f"{tag} on the full pass's dz1",
                ("dx",), (dxo,), (plain["dx"],), False, a, phase_tag=ptag)
    del dx, dws, dbs
    if not bf16:
        ref, _, _ = disc_products(x, g, ws, bs, sc, dx=full, f64=True)
        for k in kern:
            rec.cmp_f64("disc_fused", pas, f"{k} {tag}", kern[k], plain[k],
                        ref[k], ptag)
        if full:
            rec.cmp_f64("disc_fused", "bwd_dx", f"dx {tag}", dxo,
                        plain["dx"], ref["dx"], ptag)
        if main and not full:
            tf32_control("disc_fused bwd_dw's plain dW4 product",
                         lambda: hs[3].t() @ dzs[3], ref["dw4"],
                         plain["dw4"], ptag)
        if main and full:
            tf32_control("disc_fused bwd_dx's plain dx product",
                         lambda: (dzs[0] @ ws[0].t()).reshape(x.shape),
                         ref["dx"], plain["dx"], ptag)
    return got


def check_disc_fwd(rec, tag, x, ws, bs, bf16, main, ptag):
    """``disc_fwd`` on the card against its plain twin at ``rec.bound``
    (LeakyReLU is continuous, so a branch taken the other way within
    rounding of zero moves the logits by that rounding alone); in fp32
    also the float64 control, and on the main shape a TF32 plain pass
    must fail it."""
    from adversarial_learning_on_pointclouds_tpu_torch.ops.kernels import (
        disc_fused as df,
    )

    a = (x, ws, bs, bf16)
    got, plain = df.disc_fwd(*a), df.disc_fwd_plain(*a)
    rec.cmp("disc_fused", "fwd", tag, ("logits",), (got,), (plain,), main, a,
            phase_tag=ptag)
    if not bf16:
        ref = df.disc_fwd_plain(x.double(), f64(ws), f64(bs))
        rec.cmp_f64("disc_fused", "fwd", f"logits {tag}", got, plain, ref,
                    ptag)
        if main:
            tf32_control("disc_fused fwd's plain pass",
                         lambda: df.disc_fwd_plain(x, ws, bs), ref, plain,
                         ptag)


def disc_kernel_checks(dev, gen, rec, bf16=False):
    """Phase 9 (fp32), or with ``bf16`` the disc passes of phase 12."""
    from adversarial_learning_on_pointclouds_tpu_torch.models import (
        FCDiscriminator,
    )
    from adversarial_learning_on_pointclouds_tpu_torch.ops.kernels import (
        disc_fused as df,
    )

    ptag = "bench-kernels" if bf16 else "disc-kernels"
    ws, bs = disc_params(gen, dev)
    for bsz, n in ((B, TRAIN_N), (2 * B, TRAIN_N), (B, TRAIN_RAGGED_N),
                   (2, TRAIN_N)):
        tag = f"B={bsz} N={n}"
        main = n == TRAIN_N and bsz == B
        x = prob_maps(gen, bsz, n, dev)
        g = _r(gen, bsz, n, 1, scale=1.0, dev=dev)
        with torch.no_grad():
            h4p = pass_h4(x, ws, bs, True) if bf16 else None
            if bsz != 2 * B:   # the 2B batch is the D step's dW-only pass
                check_disc_fwd(rec, tag, x, ws, bs, bf16, main, ptag)
                check_disc_dw(rec, tag, x, g, ws, bs, bf16, True, main,
                              ptag, h4p)
            check_disc_dw(rec, tag, x, g, ws, bs, bf16, False,
                          n == TRAIN_N and bsz >= B, ptag, h4p)
        torch.cuda.synchronize()
    if bf16:   # the bf16 methods are held to the CPU by the bench step
        return

    # Each FCDiscriminator method against the stack composed in plain
    # PyTorch under autograd: its output and the gradients it returns;
    # the ones it must not return stay None.
    model = FCDiscriminator(PARTS, generator=gen).to(dev)
    x = prob_maps(gen, B, TRAIN_N, dev)
    layers = [model.conv1, model.conv2, model.conv3, model.conv4,
              model.classifier]
    leaves = [t.detach().clone().requires_grad_() for t in
              [x, *model._params()[0], *model._params()[1]]]
    ref = df.disc_fwd_plain(leaves[0], leaves[1:6], leaves[6:])
    torch.sin(ref).sum().backward()
    for method in ("forward", "frozen", "detached", "with_known_logits"):
        model.zero_grad(set_to_none=True)
        xl = x.detach().clone().requires_grad_()
        out = (model.with_known_logits(xl, ref.detach())
               if method == "with_known_logits" else getattr(model, method)(xl))
        torch.sin(out).sum().backward()
        check_norm(f"FCDiscriminator.{method} output", out.detach(),
                   ref.detach(), tag="disc-kernels")
        if method in ("forward", "frozen"):
            check_norm(f"FCDiscriminator.{method} dx", xl.grad,
                       leaves[0].grad, tag="disc-kernels")
        elif xl.grad is not None:
            raise AssertionError(f"{method} returned an input gradient")
        for i, m in enumerate(layers):
            if method == "frozen":
                if m.weight.grad is not None or m.bias.grad is not None:
                    raise AssertionError("frozen gave D a gradient")
                continue
            check_norm(f"FCDiscriminator.{method} dw{i + 1}",
                       m.weight.grad.flatten(1).t(), leaves[1 + i].grad,
                       tag="disc-kernels")
            check_norm(f"FCDiscriminator.{method} db{i + 1}", m.bias.grad,
                       leaves[6 + i].grad, tag="disc-kernels")
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# The config-4 G+D step (phases 10-11)
# ---------------------------------------------------------------------------

def adv_counters():
    from adversarial_learning_on_pointclouds_tpu_torch.ops.kernels import (
        augment_fused, disc_fused,
    )
    return {**pass_counters(), "disc_fused": disc_fused.PASSES,
            "augment_fused": {"fwd": augment_fused.augment_fused},
            **pt_counters()}


def pt_counters():
    """The per-layer training kernels' passes (their launch counts)."""
    from adversarial_learning_on_pointclouds_tpu_torch.ops.kernels import (
        fc_head_train, maxpool_points, shared_mlp, tnet_apply,
    )
    return {"pointwise_matmul": shared_mlp.PM_PASSES,
            "tnet_apply": tnet_apply.PASSES,
            "maxpool_points": maxpool_points.PASSES,
            "fc_head_train": fc_head_train.PASSES}


class _Recording:
    """A pass wrapper that keeps each call's arguments; its ``launches`` is
    the pass's own, which the pass counts through its module's name."""

    def __init__(self, fn, seen):
        self.fn, self.seen = fn, seen

    def __call__(self, *a):
        self.seen.append(a)
        return self.fn(*a)

    @property
    def launches(self):
        return self.fn.launches

    @launches.setter
    def launches(self, value):
        self.fn.launches = value


class PassCalls:
    """Records the arguments of every call of the given passes for one run
    (the calls still launch, and count, as they would)."""

    def __init__(self, counters):
        self.counters, self.calls, self.saved = counters, {}, []

    def __enter__(self):
        for kernel, passes in self.counters.items():
            for pas, fn in passes.items():
                module = sys.modules[fn.__module__]
                self.saved.append((module, fn.__name__, fn))
                setattr(module, fn.__name__, _Recording(
                    fn, self.calls.setdefault((kernel, pas), [])))
        return self.calls

    def __exit__(self, *exc):
        for module, name, fn in self.saved:
            setattr(module, name, fn)


class Recorder:
    """Wraps a module function for one run and keeps each call's
    ``(args, result)``."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.fn, self.seen = getattr(module, name), []

    def __enter__(self):
        def wrapped(*a, **k):
            out = self.fn(*a, **k)
            self.seen.append((a, out))
            return out
        setattr(self.module, self.name, wrapped)
        return self.seen

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def adv_setup(cfg, gen, dev):
    """A seeded full-width G (random BatchNorm statistics) and D for the
    G+D step, and a batch of 2 x B x N points with part labels (numpy)."""
    from adversarial_learning_on_pointclouds_tpu_torch.data import augment
    from adversarial_learning_on_pointclouds_tpu_torch.models import (
        FCDiscriminator, PointNetDenseCls,
    )
    from adversarial_learning_on_pointclouds_tpu_torch.train import (
        adversarial,
    )

    bsz, n = cfg.batch_size, cfg.num_points
    g_model = PointNetDenseCls(cfg.num_parts, cfg.feature_transform,
                               generator=gen)
    randomize_bn(g_model, gen)
    d_model = FCDiscriminator(cfg.num_parts + (3 if cfg.d_geometry else 0),
                              generator=gen)
    rng = np.random.default_rng(SEED + 1)
    pts = [(rng.normal(size=(bsz, n, 3)) * rng.uniform(0.5, 2.0, (bsz, 1, 3))
            ).astype(np.float32) for _ in range(2)]
    labels = (np.arange(n)[None, :] * 7 // n
              + 7 * (pts[0][..., 1] > 0)).astype(np.int64) % cfg.num_parts
    with torch.no_grad():
        # D's logits spread and centred so that sigmoid(D) straddles the
        # semi threshold on the unlabeled stream (at init they all sit
        # near 0, above it), so the mask keeps some points and drops
        # others; the card finds the centre. (Scaling G's last layer up
        # as well, for maps farther from argmax ties, makes the fp32
        # gradients of the input T-Net ill-conditioned, on the CPU as on
        # the card, and the gradient comparison then fails.)
        d_model.classifier.weight *= 100
        g_probe, d_probe = copy.deepcopy(g_model).to(dev).train(), \
            copy.deepcopy(d_model).to(dev)
        x = torch.from_numpy(pts[1]).to(dev)
        x = augment.normalize_unit_sphere(x)
        d_u = d_probe(adversarial.d_in(g_probe(x)[0].exp(), x,
                                       cfg.d_geometry))
        target = float(np.log(cfg.semi_threshold / (1 - cfg.semi_threshold)))
        d_model.classifier.bias += target - d_u.median().item()
        del g_probe, d_probe, x, d_u
    return g_model, d_model, pts, labels


def reset(counters):
    for passes in counters.values():
        for f in passes.values():
            f.launches = 0


def read(counters):
    return {k: {p: f.launches for p, f in passes.items()}
            for k, passes in counters.items()}


def step_runs(cfg, g_model, d_model, pts, labels, tag, dev,
              wheres=("cuda", "cpu"), switch=False, record=None):
    """One ``adversarial.train_step`` on the card and on the CPU from the
    same weights and batch: ``({where: (state, metrics, g_loss_fn's aux,
    batch, txs)}, launches on the card)``, the launch counts set to 0
    just before the card's step and read just after it. ``switch``: under
    ``use_pallas_train``; ``record``: a dict that takes the per-layer
    training kernels' calls of the card's step (``PassCalls``)."""
    from adversarial_learning_on_pointclouds_tpu_torch.ops import dispatch
    from adversarial_learning_on_pointclouds_tpu_torch.train import (
        adversarial,
    )

    runs, launches = {}, None
    counters = adv_counters()
    for where in wheres:
        state = adversarial.create_state(
            cfg, 100, device=where, g_model=copy.deepcopy(g_model),
            d_model=copy.deepcopy(d_model))
        txs = adversarial.make_txs(cfg, 100)
        x_l, x_u = (torch.from_numpy(p).to(where) for p in pts)
        y_l = torch.from_numpy(labels).to(where)
        recorder = PassCalls(pt_counters() if record is not None and
                             where == "cuda" else {})
        reset(counters)
        t0 = time.perf_counter()
        with Recorder(adversarial, "g_loss_fn") as seen, \
                dispatch.use_pallas_train(switch), recorder as calls:
            metrics = adversarial.train_step(state, x_l, y_l, x_u, cfg=cfg,
                                             g_tx=txs[0], d_tx=txs[1])
        if where == "cuda":
            torch.cuda.synchronize()
            launches = read(counters)
            if record is not None:
                record.update(calls)
        phase(tag, f"train_step on {where} 2 x B={cfg.batch_size} "
              f"N={cfg.num_points}: " +
              ", ".join(f"{k} {float(v):.6f}" for k, v in metrics.items()) +
              f", {time.perf_counter() - t0:.3f} s (first step)")
        runs[where] = (state, metrics, seen[0][1][1], (x_l, y_l, x_u), txs)
    return runs, launches


def check_launches(tag, launches, want):
    for k, per in want.items():
        if launches[k] != per:
            raise AssertionError(f"{k} launched {launches[k]} in one "
                                 f"step, expected {per}")
    phase(tag, f"launches in one step: {launches}")


def compare_step(tag, runs, cfg, step_bound, grad_bound, yard=None):
    """The card's step against the CPU's: every metric, D's logits and
    the maps, the semi mask, every new running statistic and every G and
    D gradient (where the step ran D: under the ablation controls D has
    no gradient on either side, and its logits and the mask are not
    made). With ``yard`` (the CPU's step in fp32) each bound is the
    larger of the given one and ``YARD_FACTOR`` times the CPU's own bf16
    against fp32 difference of the same quantity. Each BatchNorm has
    tracked two batches after the step, or one where G ran one forward
    (``supervised_only``, ``fused_forward``)."""
    (gs, gm, gaux, _, _), (cs, cm, caux, _, _) = runs["cuda"], runs["cpu"]
    tracked = 1 if cfg.supervised_only or cfg.fused_forward else 2

    def bound_for(cpu_val, yard_val, base):
        if yard is None:
            return base
        return max(base, YARD_FACTOR * rel_err(cpu_val, yard_val)[0])

    for k in gm:
        check(f"{k} GPU vs CPU", gm[k].cpu()[None], cm[k][None],
              bound_for(cm[k][None], yard and yard[1][k][None], step_bound),
              tag)
    for k in ("logp_l", "probs_u", "d_l", "d_u"):
        if k not in caux:
            continue
        check(f"{k} GPU vs CPU", gaux[k].detach().cpu(), caux[k].detach(),
              bound_for(caux[k].detach(), yard and yard[2][k].detach(),
                        step_bound), tag)
    if "d_u" in caux:
        semi_mask_check(gaux, caux, cfg.semi_threshold, tag)
    gsd, csd = gs.g_model.state_dict(), cs.g_model.state_dict()
    ysd = yard[0].g_model.state_dict() if yard else None
    stats = [k for k in csd if k.endswith(("running_mean", "running_var"))]
    worst = max(rel_err(gsd[k].cpu(), csd[k])[0] for k in stats)
    sbound = max(bound_for(csd[k], ysd and ysd[k], step_bound)
                 for k in stats)
    phase(tag, f"{len(stats)} new running statistics GPU vs CPU: max "
          f"scale-relative error {worst:.3e} (bound {sbound:.3g})")
    if worst > sbound or any(int(v) != tracked for k, v in gsd.items()
                             if k.endswith("num_batches_tracked")):
        raise AssertionError("running statistics differ")
    for net in ("g_model", "d_model"):
        gp = dict(getattr(gs, net).named_parameters())
        cp = dict(getattr(cs, net).named_parameters())
        if all(p.grad is None for p in (*gp.values(), *cp.values())):
            phase(tag, f"{net}: no gradient on the card or the CPU")
            continue
        scale = max(float(p.grad.abs().max()) for p in cp.values())
        worst, name = max((float((gp[k].grad.cpu() - p.grad).abs().max()), k)
                          for k, p in cp.items())
        gbound = grad_bound
        if yard:
            yp = dict(getattr(yard[0], net).named_parameters())
            moved = max(float((yp[k].grad - p.grad).abs().max())
                        for k, p in cp.items())
            gbound = max(grad_bound, YARD_FACTOR * moved / (1 + scale))
            phase(tag, f"{net}: bf16 rounding moves the CPU's gradients by "
                  f"{moved / (1 + scale):.3e} of (1 + max|g|)")
        phase(tag, f"{net}: {len(cp)} parameter gradients GPU vs CPU: max "
              f"abs error {worst:.3e} ({name}), {worst / (1 + scale):.3e} "
              f"of (1 + max|g| = {1 + scale:.3e}) (bound {gbound:.3g})")
        if worst > gbound * (1 + scale):
            raise AssertionError(f"{net} gradients differ")


def adv_slice(dev, card, gen):
    from adversarial_learning_on_pointclouds_tpu_torch.configs import (
        AdversarialConfig,
    )

    cfg = AdversarialConfig()
    runs, launches = step_runs(cfg, *adv_setup(cfg, gen, dev), "adv-slice",
                               dev)
    check_launches("adv-slice", launches, {**ADV_PER_STEP, **PT_OFF})
    compare_step("adv-slice", runs, cfg, STEP_BOUND, GRAD_BOUND)

    ten_steps("adv-slice", cfg, runs["cuda"])
    return runs["cuda"], launches


def ten_steps(tag, cfg, cuda_run):
    """10 more G+D steps on the card's fixed batch: the supervised loss
    must fall and every parameter stay finite."""
    from adversarial_learning_on_pointclouds_tpu_torch.train import (
        adversarial,
    )

    state, _, _, batch, txs = cuda_run
    seen = [adversarial.train_step(state, *batch, cfg=cfg, g_tx=txs[0],
                                   d_tx=txs[1]) for _ in range(10)]
    ce = [float(m["loss_ce"]) for m in seen]
    phase(tag, f"10 more G+D steps on the fixed batch: loss_ce "
          f"{ce[0]:.5f} -> {ce[-1]:.5f}, loss_d {float(seen[0]['loss_d']):.5f}"
          f" -> {float(seen[-1]['loss_d']):.5f}")
    if not np.isfinite(ce).all() or not ce[-1] < ce[0]:
        raise AssertionError(f"loss_ce did not fall: {ce}")
    for net in (state.g_model, state.d_model):
        if not all(torch.isfinite(p).all() for p in net.parameters()):
            raise AssertionError("non-finite parameters after training")


def semi_mask_check(gaux, caux, threshold, tag="adv-slice"):
    """The semi mask (sigmoid(D) > threshold) and pseudo-labels (argmax)
    on the card equal the CPU's, except at points within the comparison's
    own error of the threshold or of a tie: a flip needs the error to
    exceed the margin. The windows are twice the largest difference of
    sigmoid(D), and of the log-probs of each point's top two classes,
    and at least 1e-4 and 1e-5."""
    sig_g = torch.sigmoid(gaux["d_u"].detach().cpu()[..., 0])
    sig_c = torch.sigmoid(caux["d_u"].detach()[..., 0])
    lp_g = gaux["probs_u"].detach().cpu().log()
    lp_c = caux["probs_u"].detach().log()
    top2, at = lp_c.topk(2, -1)
    win_s = max(1e-4, 2 * (sig_g - sig_c).abs().max().item())
    win_l = max(1e-5, 2 * (lp_g.gather(-1, at) - top2).abs().max().item())
    tie = (top2[..., 0] - top2[..., 1]) <= win_l
    near = (sig_c - threshold).abs() <= win_s
    mask_g, mask_c = sig_g > threshold, sig_c > threshold
    bad_mask = int(((mask_g != mask_c) & ~near).sum())
    bad_label = int(((lp_g.argmax(-1) != lp_c.argmax(-1)) & ~tie).sum())
    phase(tag, f"semi mask: {float(mask_c.float().mean()):.3f} of "
          f"the points kept; {int((mask_g != mask_c).sum())} differ, all "
          f"within {win_s:.2e} of the threshold but {bad_mask}; "
          f"{int((lp_g.argmax(-1) != lp_c.argmax(-1)).sum())} pseudo-labels "
          f"differ, all at top-two gaps within {win_l:.2e} but {bad_label}")
    if bad_mask or bad_label:
        raise AssertionError("semi mask or pseudo-labels differ")


def adv_timing(card, rec, cuda_run, launches, results):
    from adversarial_learning_on_pointclouds_tpu_torch.configs import (
        AdversarialConfig,
    )
    from adversarial_learning_on_pointclouds_tpu_torch.ops.kernels import (
        disc_fused as df,
    )

    passes, family_flops, family_dev = [], 0, 0.0
    for pas, fn in df.PASSES.items():
        calls = rec.args[("disc_fused", pas)]
        plain = getattr(df, fn.__name__ + "_plain")
        per = ADV_PER_STEP["disc_fused"][pas]
        # Per step: each distinct call once (bwd_dw: at 2B and at B), or
        # times its repeats; the full bwd, off the step, per call.
        times = per / len(calls) if per else 1.0
        kernels = {}
        with torch.no_grad():
            ms, plain_ms = time_pair(lambda: [fn(*a) for a in calls],
                                     lambda: [plain(*a) for a in calls])
            by_name = device_profile(lambda: [fn(*a) for a in calls],
                                     counts=kernels)
            dev_ms = sum(by_name.values())
            plain_dev_ms = sum(device_profile(
                lambda: [plain(*a) for a in calls]).values())
        flops, nbytes = work(plain, calls)
        tc = pas in DISC_TC_PASSES
        bound_ms, bound_by = bound(flops, nbytes,
                                   TF32X3_PEAK if tc else FP32_PEAK)
        fma_ms = bound(flops, nbytes)[0] * times
        ms, plain_ms, dev_ms, plain_dev_ms, bound_ms, flops = (
            t * times for t in (ms, plain_ms, dev_ms, plain_dev_ms, bound_ms,
                                flops))
        if per:
            family_flops += flops
            family_dev += dev_ms
        phase("adv-timing", f"{card}: disc_fused {pas} "
              f"{'x%d per G+D step' % per if per else 'per call (off the step)'}"
              f" at B={B} N={TRAIN_N}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms; device time alone: kernel {dev_ms:.4f} ms, "
              f"plain {plain_dev_ms:.4f} ms; bound {bound_ms:.4f} ms "
              f"({bound_by}"
              + (f", 3xTF32 rate; at the fp32 FMA rate {fma_ms:.4f} ms"
                 if tc else "") + f"); {flops / dev_ms / 1e9:.2f} TFLOP/s")
        row = {"pass": pas, "replaces": f"{TPU_KERNELS}/{DISC_SITES[pas]}",
               "launches": launches["disc_fused"][pas],
               "max_abs_err": rec.err[("disc_fused", pas)], "ms": ms,
               "plain_ms": plain_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "device_ms": dev_ms,
               "plain_device_ms": plain_dev_ms,
               "tflops": flops / dev_ms / 1e9}
        if tc:
            row.update(bound_fma_ms=fma_ms,
                       source=f"{KERNELS_ROOT}/csrc/disc_tc.cu")
            disc_tc_report(card, pas, calls, by_name, kernels, per)
        passes.append(row)
    phase("adv-timing", f"{card}: disc family per G+D step: {family_dev:.3f} "
          f"ms of device time for {family_flops / 1e9:.1f} GFLOP, "
          f"{family_flops / family_dev / 1e9:.2f} TFLOP/s, "
          f"{100 * family_flops / family_dev / 1e-3 / FP32_PEAK:.1f}% of the "
          f"{FP32_PEAK / 1e12:.0f} TFLOP/s fp32 peak")
    step_passes = [p for p in passes if p["pass"] != "bwd"]
    entry = kernel_entry("disc_fused", "disc_tc.cu", DISC_SITES["fwd"],
                         sum(launches["disc_fused"].values()), step_passes,
                         "per G+D step")
    entry["passes"] = passes
    results.append(entry)
    for r in results:
        if r["name"] in launches:
            r["launches_g_d_step"] = sum(launches[r["name"]].values())

    state, _, _, batch, txs = cuda_run
    time_step(card, "adv-timing", AdversarialConfig(), state, batch, txs,
              names=True)


def disc_tc_report(card, pas, calls, by_name, kernels, per,
                   tag="adv-timing"):
    """The tensor-core disc pass's sub-kernels (``csrc/disc_tc.cu``: the
    forward kernel; the backward's row pass, for dW then dW1..dW4 on the
    GEMM core with their split sums, colsum and sum_g_kernel), from one
    profile of its ``calls``: launches per call and per G+D step, device
    time by kernel, and for dW the scratch's rate (the 1,408 floats a row
    the row pass writes and the GEMM core reads back, over the whole
    pass's device time)."""
    from adversarial_learning_on_pointclouds_tpu_torch.ops.kernels import (
        disc_fused as df,
    )

    rows = sum(a[0].shape[0] * a[0].shape[1] for a in calls)
    scratch = 2 * rows * (df.DZ_COLS + df.H_COLS) * 4
    n = len(calls)
    dev_ms = sum(by_name.values())
    row_ms = sum(v for k, v in by_name.items() if "disc_row_tc" in k)
    launched = sum(kernels.values())
    def short(key):   # the kernel's name and template arguments
        key = re.sub(r"^void |\(anonymous namespace\)::|pointtpu::", "", key)
        return re.sub(r"\(.*", "", key)

    phase(tag, f"{card}: disc_fused {pas}: {launched / n:g} "
          f"launches a call ({launched / n * max(per, 1):g} per G+D step"
          f"{'' if per else ', off the step'}): " + ", ".join(
              f"{short(k)} x{c / n:g} {by_name[k] / n:.4f} ms"
              for k, c in sorted(kernels.items(),
                                 key=lambda kv: -by_name[kv[0]])))
    if pas not in DISC_DW_PASSES:
        return
    phase(tag, f"{card}: disc_fused {pas}: scratch written and "
          f"read back {scratch / n / 1e9:.3f} GB a call, "
          f"{scratch / dev_ms / 1e6:.1f} GB/s over the pass's device time "
          f"(the row pass alone {row_ms / n:.4f} ms a call)")


def time_step(card, tag, cfg, state, batch, txs, names=False):
    """The G+D step, one synchronized ``train_step`` per call: the median
    of 12 (CUDA events, after 3 warm-ups), points/s of both streams, and
    the profiler's kernel time (5 steps) with its largest kernels; with
    ``names``, the profile must show ``TC_HEAD_KERNELS`` and none of
    ``GONE_KERNELS`` (``profile_names``)."""
    from adversarial_learning_on_pointclouds_tpu_torch.train import (
        adversarial,
    )

    def step():
        adversarial.train_step(state, *batch, cfg=cfg, g_tx=txs[0],
                               d_tx=txs[1])

    for _ in range(3):
        step()
    step_ms = statistics.median(event_ms(step, 12))
    pts = 2 * cfg.batch_size * cfg.num_points
    phase(tag, f"{card}: G+D train_step 2 x B={cfg.batch_size} "
          f"N={cfg.num_points}: median {step_ms:.3f} ms over 12 steps, "
          f"{pts / step_ms * 1e3:.1f} points/s (both streams)")
    kernels = device_profile(step, reps=5)
    busy = sum(kernels.values())
    phase(tag, f"{card}: G+D step: GPU kernels busy {busy:.3f} ms "
          f"of {step_ms:.3f} ms ({100 * (1 - busy / step_ms):.1f}% idle), "
          f"{len(kernels)} kernel names")
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:14]
    for key, ms in top:
        phase(tag, f"  {ms:.4f} ms  {key[:90]}")
    if names:
        profile_names(kernels, "the fp32 G+D step", per=1, tag=tag)
    return {"step_ms": step_ms, "busy_ms": busy,
            "top": [[k[:60], ms] for k, ms in top[:5]]}


# ---------------------------------------------------------------------------
# The G+D step as bench.py runs it (phases 12-14)
# ---------------------------------------------------------------------------

def check_equal(name, got, ref, tag="bench-kernels"):
    """Bit-equality, tensor by tensor."""
    for i, (a, b) in enumerate(zip(got, ref)):
        if a.shape != b.shape or not torch.equal(a, b):
            d = (a.double() - b.double()).abs().max().item() \
                if a.shape == b.shape else float("nan")
            raise AssertionError(f"{name}: output {i} not bit-equal (max abs "
                                 f"difference {d:.3e})")
    phase(tag, f"{name}: {len(got)} outputs bit-equal")


def groups2_checks(dev, gen, rec):
    """``trunk2_train(groups=2)`` at 2B = 64: each pass against its plain
    twin and against two groups=1 launches on the halves (per-stream
    statistics, extrema, winners, dy2 and BN2's sums bit-equal; dW3 and
    db3, one sum over both streams, within BOUND of the halves' sum), and
    the whole function's pooled values and statistics bit-equal to two
    groups=1 calls, in fp32 and in bf16."""
    from adversarial_learning_on_pointclouds_tpu_torch.models import core
    from adversarial_learning_on_pointclouds_tpu_torch.ops.kernels import (
        trunk_train as tt,
    )

    c1, c2, c3 = 64, 128, 1024
    w2, b2, w3, b3 = (_w(gen, c1, c2, dev), _r(gen, c2, dev=dev),
                      _w(gen, c2, c3, dev), _r(gen, c3, dev=dev))
    g2, be2 = _gam(gen, c2, dev), _r(gen, c2, dev=dev)
    g3, be3 = _gam(gen, c3, dev, negative=0.3), _r(gen, c3, dev=dev)
    bsz, n, h = 2 * B, TRAIN_N, B
    for bf16 in (False, True):
        tag = f"2B={bsz} N={n} {'bf16' if bf16 else 'fp32'}"
        x = torch.relu(torch.randn(bsz, n, c1, generator=gen)).to(dev)
        halves = (slice(0, h), slice(h, bsz))
        with torch.no_grad():
            a = (x, w2, b2, 2, bf16)
            got, ref = tt.f1(*a), tt.f1_plain(*a)
            rec.cmp("trunk2_train(groups=2)", "F1", tag, ("z2", "sum",
                    "sumsq"), got, ref, bf16, a, phase_tag="bench-kernels",
                    bound=None if bf16 else BOUND, max_share=STASH_SHARE)
            one = [tt.f1(x[c], w2, b2, 1, bf16) for c in halves]
            check_equal(f"trunk2_train(groups=2) F1 {tag} vs two groups=1 "
                        "launches", got, [torch.cat([o[0] for o in one])] +
                        [torch.stack([o[i] for o in one]) for i in (1, 2)])
            z2 = got[0]
            mu2, _, inv2 = core.batch_moments(got[1], got[2], h * n)
            sc2, sh2 = g2 * inv2, be2 - mu2 * (g2 * inv2)
            a = (z2, sc2, sh2, w3, b3, 2, bf16)
            got, ref = tt.f2(*a), tt.f2_plain(*a)
            rec.cmp("trunk2_train(groups=2)", "F2", tag, ("sum", "sumsq",
                    "max", "min"), got[:4], ref[:4], bf16, a,
                    phase_tag="bench-kernels", bound=None if bf16 else BOUND)
            one = [tt.f2(z2[c], sc2[i], sh2[i], w3, b3, 1, bf16)
                   for i, c in enumerate(halves)]
            check_equal(f"trunk2_train(groups=2) F2 {tag} vs two groups=1 "
                        "launches", got,
                        [torch.stack([o[i] for o in one]) for i in (0, 1)] +
                        [torch.cat([o[i] for o in one]) for i in range(2, 6)])
            mu3, _, inv3 = core.batch_moments(got[0], got[1], h * n)
            s3c = (g3 * inv3).repeat_interleave(h, 0)
            idx = torch.where(s3c >= 0, got[4], got[5])
            dg = _r(gen, bsz, c3, scale=1.0, dev=dev)
            co1, co2 = (_r(gen, bsz, c3, scale=1e-3, dev=dev)
                        for _ in range(2))
            a = (z2, sc2, sh2, w3, b3, mu3, inv3, co1, co2, s3c * dg, idx,
                 mu2, inv2, 2, bf16)
            got, ref = tt.b1(*a), tt.b1_plain(*a)
            rec.cmp("trunk2_train(groups=2)", "B1", tag,
                    ("dy2", "dw3", "db3", "t1", "t2"), got, ref, bf16, a,
                    phase_tag="bench-kernels", bound=None if bf16 else BOUND)
            one = [tt.b1(z2[c], sc2[i], sh2[i], w3, b3, mu3[i], inv3[i],
                         co1[c], co2[c], (s3c * dg)[c], idx[c], mu2[i],
                         inv2[i], 1, bf16) for i, c in enumerate(halves)]
            check_equal(f"trunk2_train(groups=2) B1 dy2, t1, t2 {tag} vs two "
                        "groups=1 launches", (got[0], got[3], got[4]),
                        (torch.cat([o[0] for o in one]),
                         torch.stack([o[3] for o in one]),
                         torch.stack([o[4] for o in one])))
            for i, nm in ((1, "dw3"), (2, "db3")):
                check(f"trunk2_train(groups=2) B1 {nm} {tag} vs the sum of "
                      "two groups=1 launches", got[i],
                      one[0][i] + one[1][i], BOUND, "bench-kernels")
            leaves = (w2, b2, g2, be2, w3, b3, g3, be3)
            with core.mixed_precision(enabled=bf16):
                whole = tt.trunk2_train(x, *leaves, groups=2)
                parts = [tt.trunk2_train(x[c], *leaves) for c in halves]
            check_equal(f"trunk2_train(groups=2) {tag}: pooled values and "
                        "statistics vs two groups=1 calls", whole,
                        [torch.cat([p[0] for p in parts])] +
                        [torch.stack([p[i] for p in parts])
                         for i in range(1, 5)])
        torch.cuda.synchronize()


def augment_checks(dev, gen, rec):
    """``augment_fused`` against its plain twin on the same Philox bits
    (the key derived from the device step count by the kernel, and by
    ``step_seed`` for the twin); then its distribution on 4096 clouds x
    256 points, and another step, seed and stream."""
    from adversarial_learning_on_pointclouds_tpu_torch.ops.kernels import (
        augment_fused as af,
    )

    step = torch.tensor(7, dtype=torch.int64, device=dev)
    modes = {"rotate+jitter": (True, True, False),
             "rotate+jitter+dropout": (True, True, True),
             "dropout": (False, False, True)}
    names = ("points_a", "points_b")
    for n in (TRAIN_N, TRAIN_RAGGED_N, RAGGED_N):
        x = torch.randn(B, n, 3, generator=gen).to(dev)
        x_b = torch.randn(B, n, 3, generator=gen).to(dev)
        for i, (mode, flags) in enumerate(modes.items()):
            a = (step, x, SEED, i % 2, *flags)
            main = n == TRAIN_N and mode == "rotate+jitter"
            rec.cmp("augment_fused", "fwd", f"B={B} N={n} {mode}", ("points",),
                    (af.augment_fused(*a),), (af.augment_fused_plain(*a),),
                    main, a, phase_tag="bench-kernels", bound=BOUND)
            # The bench step's launch: both streams at once, each bit for
            # bit its own single-stream launch.
            pa = (step, x, x_b, SEED, *flags)
            pair = af.augment_fused_pair(*pa)
            check_equal(f"augment_fused_pair B={B} N={n} {mode} against two "
                        "single-stream launches", pair,
                        [af.augment_fused(step, p, SEED, k, *flags)
                         for k, p in enumerate((x, x_b))])
            rec.cmp("augment_fused", "pair", f"B={B} N={n} {mode}", names,
                    pair, af.augment_fused_pair_plain(*pa), main, pa,
                    phase_tag="bench-kernels", bound=BOUND)
    # Streams of two shapes in one launch.
    x, x_b = (torch.randn(bsz, n, 3, generator=gen).to(dev)
              for bsz, n in ((B, TRAIN_RAGGED_N), (3, 100)))
    pa = (step, x, x_b, SEED, True, True, True)
    pair = af.augment_fused_pair(*pa)
    check_equal("augment_fused_pair B=32 N=2500 with B=3 N=100 against two "
                "single-stream launches", pair,
                [af.augment_fused(step, p, SEED, k, True, True, True)
                 for k, p in enumerate((x, x_b))])
    rec.cmp("augment_fused", "pair", "B=32 N=2500 with B=3 N=100", names,
            pair, af.augment_fused_pair_plain(*pa), False, pa,
            phase_tag="bench-kernels", bound=BOUND)
    x = torch.randn(4096, 256, 3, generator=gen).to(dev)
    y = af.augment_fused(step, x, SEED, 0, True, False, False)
    r2 = x[..., 0] ** 2 + x[..., 2] ** 2
    c = (x[..., 0] * y[..., 0] + x[..., 2] * y[..., 2]) / r2
    s_ = (x[..., 0] * y[..., 2] - x[..., 2] * y[..., 0]) / r2
    angle = torch.remainder(torch.atan2(s_[:, 0], c[:, 0]), 2 * np.pi)
    spread = (angle.max() - angle.min()).item()
    same = (angle[:, None] - torch.atan2(s_, c).remainder(2 * np.pi))
    same = torch.minimum(same.abs(), 2 * np.pi - same.abs()).max().item()
    stats = {"mean angle": (angle.mean().item(), np.pi, 0.15),
             "mean cos": (torch.cos(angle).mean().item(), 0.0, 0.06),
             "mean sin": (torch.sin(angle).mean().item(), 0.0, 0.06)}
    y = af.augment_fused(step, x, SEED, 0, False, True, False)
    noise = y - x
    stats.update({"jitter mean": (noise.mean().item(), 0.0, 3e-5),
                  "jitter std": (noise.std().item(), 0.01, 1e-4),
                  "jitter max |.|": (noise.abs().max().item(), 0.05, 1e-5)})
    y = af.augment_fused(step, x, SEED, 0, False, False, True)
    frac = (y[:, 1:] == y[:, :1]).all(-1).float().mean(1)
    stats.update({"dropout mean ratio": (frac.mean().item(), 0.4375, 0.02),
                  "dropout max ratio": (frac.max().item(), 0.875, 0.1)})
    base = af.augment_fused(step, x, SEED, 0, True, True, False)
    moved = min((other != base).float().mean().item() for other in (
        af.augment_fused(step + 1, x, SEED, 0, True, True, False),
        af.augment_fused(step, x, SEED + 1, 0, True, True, False),
        af.augment_fused(step, x, SEED, 1, True, True, False)))
    phase("bench-kernels", f"augment_fused on 4096 clouds x 256 points: "
          + ", ".join(f"{k} {v:.5g} (want {w:g} +- {t:g})"
                      for k, (v, w, t) in stats.items())
          + f"; angles span {spread:.4f} of 2 pi, each cloud's points turned"
          f" by one angle within {same:.2e}; another step, seed or stream "
          f"changed at least {moved:.4f} of the coordinates")
    bad = [k for k, (v, w, t) in stats.items()
           if (v > w + t if k.endswith("max ratio") or "|" in k
               else abs(v - w) > t)]
    if bad or spread < 6.0 or same > 1e-3 or moved < 0.6:
        raise AssertionError(f"augment_fused distribution off: {bad}")
    torch.cuda.synchronize()


def scan_check(cfg, g_model, d_model, batch_k, dev):
    """``train_steps_scan`` at K against K ``train_step`` calls from the
    same state on the same batches: every metric bit-equal."""
    from adversarial_learning_on_pointclouds_tpu_torch.train import (
        adversarial,
    )

    txs = adversarial.make_txs(cfg, 100)
    states = [adversarial.create_state(cfg, 100, device=dev,
                                       g_model=copy.deepcopy(g_model),
                                       d_model=copy.deepcopy(d_model))
              for _ in range(2)]
    scan = adversarial.train_steps_scan(states[0], *batch_k, cfg=cfg,
                                        g_tx=txs[0], d_tx=txs[1])
    loop = [adversarial.train_step(states[1], *(t[k] for t in batch_k),
                                   cfg=cfg, g_tx=txs[0], d_tx=txs[1])
            for k in range(BENCH_K)]
    check_equal(f"train_steps_scan K={BENCH_K} vs {BENCH_K} train_step "
                "calls: metrics", [scan[k] for k in sorted(scan)],
                [torch.stack([m[k] for m in loop]) for k in sorted(scan)],
                "bench-slice")
    if not all(s.step == BENCH_K and int(s.device_step) == BENCH_K
               for s in states):
        raise AssertionError("step counts")
    ce = scan["loss_ce"].tolist()
    phase("bench-slice", f"train_steps_scan: loss_ce over the {BENCH_K} "
          f"batches {', '.join(f'{v:.5f}' for v in ce)}")
    if not np.isfinite(ce).all():
        raise AssertionError("non-finite metrics")
    return states[0], txs


def bench_slice(dev, card, gen):
    """Phase 13."""
    from adversarial_learning_on_pointclouds_tpu_torch.configs import (
        AdversarialConfig,
    )

    cfg = AdversarialConfig(augment=True, bf16=True, pallas_augment=True)
    setup = adv_setup(cfg, gen, dev)
    want = {**ADV_PER_STEP, "augment_fused": {"fwd": AUG_PER_STEP}, **PT_OFF}
    yard = step_runs(dataclasses.replace(cfg, bf16=False), *setup,
                     "bench-slice yardstick (fp32)", dev, ("cpu",))[0]["cpu"]
    out = {}
    for paired in (False, True):
        c = dataclasses.replace(cfg, paired_trunks=paired)
        tag = "bench-slice" + (" paired_trunks" if paired else "")
        runs, launches = step_runs(c, *setup, tag, dev)
        check_launches(tag, launches,
                       {**want, "trunk2_train": GROUPS2_PER_STEP} if paired
                       else want)
        compare_step(tag, runs, c, STEP_BOUND, GRAD_BOUND, yard)
        out[paired] = (c, runs["cuda"], launches)
    # The paired trunks change no value of the forward: the two card
    # steps' metrics are bit-equal (tests/test_round4.py:489 in the JAX
    # package), and their gradients differ by summation order only.
    (_, base, _), (_, pt, _) = out[False], out[True]
    check_equal("bench step with paired_trunks vs without: metrics",
                [pt[1][k] for k in sorted(pt[1])],
                [base[1][k] for k in sorted(base[1])], "bench-slice")
    gb = dict(base[0].g_model.named_parameters())
    scale = max(float(p.grad.abs().max()) for p in gb.values())
    worst = max(float((p.grad - gb[k].grad).abs().max())
                for k, p in pt[0].g_model.named_parameters())
    yp = dict(yard[0].g_model.named_parameters())
    gbound = max(GRAD_BOUND, YARD_FACTOR * max(
        float((yp[k].grad - p.grad.cpu()).abs().max())
        for k, p in gb.items()) / (1 + scale))
    phase("bench-slice", f"paired_trunks vs not, G gradients on the card: "
          f"{worst / (1 + scale):.3e} of (1 + max|g|) (bound {gbound:.3g})")
    if worst > gbound * (1 + scale):
        raise AssertionError("paired_trunks gradients differ")

    g_model, d_model, pts, labels = setup
    rng = np.random.default_rng(SEED + 2)
    bsz, n = cfg.batch_size, cfg.num_points
    x_k = [torch.from_numpy(rng.normal(size=(BENCH_K, bsz, n, 3)).astype(
        np.float32)).to(dev) for _ in range(2)]
    y_k = torch.from_numpy(rng.integers(0, cfg.num_parts, (
        BENCH_K, bsz, n))).to(dev)
    batch_k = (x_k[0], y_k, x_k[1])
    scan_state, txs = scan_check(cfg, g_model, d_model, batch_k, dev)
    return out, setup, batch_k, scan_state, txs


def time_passes(card, rec, key, fn, plain, times, bf16, peak=None,
                tag="bench-timing"):
    """One pass's kernel and plain times and its bound (at ``peak``, by
    default the bf16 tensor cores' or fp32 FMA's), per step."""
    calls = rec.args[key]
    with torch.no_grad():
        ms, plain_ms = time_pair(lambda: [fn(*a) for a in calls],
                                 lambda: [plain(*a) for a in calls])
        dev_ms = sum(device_profile(lambda: [fn(*a) for a in calls]).values())
        plain_dev_ms = sum(device_profile(
            lambda: [plain(*a) for a in calls]).values())
    flops, nbytes = work(plain, calls)
    bound_ms, bound_by = bound(flops, nbytes, peak or (
        BF16_PEAK if bf16 else FP32_PEAK))
    row = dict(zip(("ms", "plain_ms", "device_ms", "plain_device_ms",
                    "bound_ms"), (t * times / len(calls) for t in (
                        ms, plain_ms, dev_ms, plain_dev_ms, bound_ms))))
    row.update(bound_by=bound_by, max_abs_err=rec.err[key],
               tflops=flops / ms / 1e9)
    if key in rec.share:
        row["stash_diff_share"] = rec.share[key]
    phase(tag, f"{card}: {key[0]} {key[1]} "
          f"{'bf16 ' if bf16 else ''}x{times} per step: kernel "
          f"{row['ms']:.4f} ms ({row['tflops']:.1f} TFLOP/s), plain "
          f"{row['plain_ms']:.4f} ms; device time "
          f"alone: kernel {row['device_ms']:.4f} ms, plain "
          f"{row['plain_device_ms']:.4f} ms; bound {row['bound_ms']:.4f} ms "
          f"({bound_by})")
    return row


def time_scan(card, tag, cfg, state, batch_k, txs):
    """The step through ``train_steps_scan`` at K: per-step ms (CUDA
    events around the call), points/s of both streams, idle share, and
    the port's kernels by name (device ms per step)."""
    from adversarial_learning_on_pointclouds_tpu_torch.train import (
        adversarial,
    )

    def call():
        adversarial.train_steps_scan(state, *batch_k, cfg=cfg, g_tx=txs[0],
                                     d_tx=txs[1])

    call()
    per = statistics.median(event_ms(call, 3)) / BENCH_K
    kernels = device_profile(call, reps=1)
    busy = sum(kernels.values()) / BENCH_K
    pts = 2 * cfg.batch_size * cfg.num_points
    phase("bench-timing", f"{card}: {tag}: train_steps_scan K={BENCH_K}, "
          f"2 x B={cfg.batch_size} N={cfg.num_points}: {per:.3f} ms per step"
          f", {pts / per * 1e3:.1f} points/s (both streams), GPU kernels "
          f"busy {busy:.3f} ms per step ({100 * (1 - busy / per):.1f}% idle)")
    ours = {re.sub(r"^(void )?pointtpu::\(anonymous namespace\)::", "", k)
            .split("(")[0]: ms / BENCH_K for k, ms in kernels.items()
            if k.startswith(("void pointtpu::", "pointtpu::"))}
    return {"step_ms": per, "busy_ms": busy, "kernels": ours}


def bench_timing(card, rec, results, bench):
    """Phase 14."""
    from adversarial_learning_on_pointclouds_tpu_torch.ops.kernels import (
        augment_fused as af, trunk_train as tt,
    )
    from adversarial_learning_on_pointclouds_tpu_torch.train import (
        adversarial,
    )

    out, setup, batch_k, scan_state, txs = bench
    counters = adv_counters()
    by_name = {r["name"]: r for r in results}
    for (kernel, pas) in list(rec.args):
        if kernel not in by_name:
            continue
        fn = counters[kernel][pas]
        plain = getattr(sys.modules[fn.__module__], fn.__name__ + "_plain")
        per = (ADV_PER_STEP if kernel == "disc_fused" else PER_STEP)[
            kernel][pas] or 1
        row = time_passes(card, rec, (kernel, pas), fn, plain, per, True)
        if kernel == "disc_fused":
            calls, kernels = rec.args[(kernel, pas)], {}
            with torch.no_grad():
                by_kernel = device_profile(lambda: [fn(*a) for a in calls],
                                           counts=kernels)
            disc_tc_report(card, pas, calls, by_kernel, kernels,
                           ADV_PER_STEP[kernel][pas], "bench-timing")
        entry = by_name[kernel]
        match = [p for p in entry["passes"] if p["pass"] == pas][0]
        match.update({f"bf16_{k}": v for k, v in row.items()})
    for entry in by_name.values():
        if "passes" in entry and "bf16_ms" in entry["passes"][0]:
            step = [p for p in entry["passes"] if p["pass"] != "bwd"]
            for k in ("ms", "plain_ms", "bound_ms", "device_ms",
                      "plain_device_ms"):
                entry[f"bf16_{k}"] = sum(p[f"bf16_{k}"] for p in step)
            entry["bf16_bound_by"] = max(step, key=lambda p: p[
                "bf16_bound_ms"])["bf16_bound_by"]

    cfg, _, launches = out[False]
    cfg_pt, _, launches_pt = out[True]
    row = time_passes(card, rec, ("augment_fused", "pair"),
                      af.augment_fused_pair, af.augment_fused_pair_plain,
                      AUG_PER_STEP, False)
    row["max_abs_err"] = max(rec.err[("augment_fused", p)]
                             for p in ("fwd", "pair"))
    results.append({"name": "augment_fused", "route": "cuda",
                    "source": f"{KERNELS_ROOT}/csrc/augment_fused.cu",
                    "replaces": f"{TPU_KERNELS}/{AUG_SITE}",
                    "launches": launches["augment_fused"]["fwd"],
                    "library_ms": None,
                    "times": "per bench G+D step (both streams, one "
                             "augment_fused_pair launch)", **row})
    passes = []
    for pas, fn in tt.PASSES.items():
        row = time_passes(card, rec, ("trunk2_train(groups=2)", pas), fn,
                          getattr(tt, fn.__name__ + "_plain"),
                          GROUPS2_PER_STEP[pas], True)
        passes.append({"pass": pas, "replaces": f"{TPU_KERNELS}/"
                       f"{TRAIN_KERNELS['trunk2_train'][1][pas]}",
                       "launches": launches_pt["trunk2_train"][pas], **row})
    results.append(kernel_entry(
        "trunk2_train(groups=2)", "trunk_train.cu",
        TRAIN_KERNELS["trunk2_train"][1]["F1"],
        sum(launches_pt["trunk2_train"].values()), passes,
        "per bench G+D step with paired trunks, bf16"))

    # The step: one call per step, then K per call.
    state, _, _, batch, step_txs = out[False][1]

    def step():
        adversarial.train_step(state, *batch, cfg=cfg, g_tx=step_txs[0],
                               d_tx=step_txs[1])

    for _ in range(3):
        step()
    one = statistics.median(event_ms(step, 12))
    pts = 2 * cfg.batch_size * cfg.num_points
    phase("bench-timing", f"{card}: bench step (bf16, augment_fused, paired "
          f"heads), one train_step per call, synchronized after each (as "
          f"phase 11): median {one:.3f} ms over 12 steps, "
          f"{pts / one * 1e3:.1f} points/s (both streams)")
    scan = time_scan(card, "bench step", cfg, scan_state, batch_k,
                     txs)["step_ms"]
    phase("bench-timing", f"{card}: K={BENCH_K} steps per call against one "
          f"synchronized step: {scan:.3f} ms against {one:.3f} ms per step; "
          f"{one - scan:.3f} ms of the host's work per step runs under the "
          "device's when the steps are not synchronized one by one")
    time_scan(card, "bench step with paired_trunks", cfg_pt,
              out[True][1][0], batch_k, out[True][1][4])
    cfg_np = dataclasses.replace(cfg, pallas_augment=False)
    state_np = adversarial.create_state(
        cfg_np, 100, device="cuda", g_model=copy.deepcopy(setup[0]),
        d_model=copy.deepcopy(setup[1]))
    time_scan(card, "bench step without pallas_augment", cfg_np, state_np,
              batch_k, adversarial.make_txs(cfg_np, 100))
    kernels = device_profile(lambda: adversarial.train_steps_scan(
        scan_state, *batch_k, cfg=cfg, g_tx=txs[0], d_tx=txs[1]), reps=1)
    for key, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:14]:
        phase("bench-timing", f"  {ms / BENCH_K:.4f} ms per step  {key[:90]}")
    profile_names(kernels, "the bench step", BENCH_KERNELS)
    profile_names(device_profile(lambda: adversarial.train_steps_scan(
        out[True][1][0], *batch_k, cfg=cfg_pt, g_tx=out[True][1][4][0],
        d_tx=out[True][1][4][1]), reps=1), "the bench step with paired_trunks",
        BENCH_KERNELS)


# The tensor-core passes that replaced CUDA-core kernels (the seg head's
# P1, Pmid, P4, B1 and B4, trunk F1), which the bench step and the fp32
# G+D step must show under their own names, and the CUDA-core kernels
# they replaced, which they must not: the head's B1 and B4 row and
# weight-gradient kernels and the forward row kernel (the seg head's P1
# and P4, and F1's grouped one for the paired trunks); and the serving
# path's stack and seg head kernels, which no profile may show.
TC_HEAD_KERNELS = ("head_p1_tc_kernel<", "pmid_tc_kernel<",
                   "head_p4_tc_kernel<", "head_b1_tc_kernel<",
                   "f1_tc_kernel<", "b4_tc_kernel<", "fc_tc_kernel<")
GONE_KERNELS = ("row_bwd_kernel<128", "wgrad_kernel<2", "row_bwd_kernel<64",
                "wgrad_kernel<4", "row_fwd_kernel", "stack_maxpool_kernel",
                "seg_head_kernel", "pool_fc_kernel<", "fc_layer_kernel<",
                "fc_bn_bwd_kernel<", "linear_affine_act_kernel",
                "augment_kernel(")
# The serving kernels on the tensor cores (csrc/encoder_fused.cu), which
# the forward's profile must show in place of the CUDA-core
# stack_maxpool_kernel and seg_head_kernel (GONE_KERNELS), and conv1's
# channel-group kernel (csrc/shared_mlp.cu) in place of the
# element-per-thread linear_affine_act_kernel.
SERVE_KERNELS = ("stack_tc_kernel<", "head_tc_kernel<false>",
                 "conv_group_kernel<3, false>")
SERVE_NAMES = ("stack_tc_kernel", "head_tc_kernel", "conv_group_kernel")
# The bench step (pallas_augment) also augments both streams in one
# augment_pair_kernel launch, where the one-stream augment_kernel ran twice.
BENCH_KERNELS = TC_HEAD_KERNELS + ("augment_pair_kernel(",)


def profile_names(kernels, what, want=None, per=BENCH_K,
                  tag="bench-timing"):
    """Fail unless the profile ``kernels`` (by name, over ``per`` steps or
    forwards) ran each of ``want`` (``TC_HEAD_KERNELS``) and none of
    ``GONE_KERNELS``; prints each one's device ms per step."""
    want = TC_HEAD_KERNELS if want is None else want
    ran = {k: [n for n in kernels if k in n] for k in want + GONE_KERNELS}
    missing = [k for k in want if not ran[k]]
    stale = [n for k in GONE_KERNELS for n in ran[k]]
    phase(tag, f"profile of {what}: " + "; ".join(
        f"{k}..> {len(ran[k])} name(s), "
        f"{sum(kernels[n] for n in ran[k]) / per:.4f} ms per step"
        for k in ran))
    if missing or stale:
        raise AssertionError(f"{what}: kernels missing {missing}, removed "
                             f"kernels that ran {stale}")


# ---------------------------------------------------------------------------
# The per-layer training kernels, use_pallas_train (phases 15-17)
# ---------------------------------------------------------------------------

def check_rounded(name, got, ref, tag="pallas-train-kernels"):
    """A bf16-operand product of a rounded operand that the pass computes
    (``fc_head_train``'s dz as dW's operand): where the kernel's and the
    plain pass's fp32 dz straddle a rounding boundary the operand differs
    by one bf16 step, and at 32 rows one term can carry a large part of a
    sum; so at most 1% of the elements beyond ``BOUND`` of the scale and
    every one within ``2^-7`` of it (a missing or extra rounding moves
    most elements by about 2^-9)."""
    err = (got.double() - ref.double()).abs() / max(1.0, ref.abs().max()
                                                   .item())
    share = (err > BOUND).double().mean().item()
    worst = err.max().item()
    phase(tag, f"{name}: {share:.3e} of the elements beyond {BOUND:g} of "
          f"the scale (at most 1e-2), max {worst:.3e} (at most 2^-7)")
    if not torch.isfinite(got).all() or share > 1e-2 or worst > 2.0 ** -7:
        raise AssertionError(f"{name}: differs")
    return (got.double() - ref.double()).abs().max().item()


def fc_head_args(gen, bsz, k, dev):
    """Inputs of ``fc_head_fwd``: pooled ReLU features, the three layers,
    both BN affines and nonzero running means."""
    args = [torch.relu(torch.randn(bsz, 1024, generator=gen)).to(dev)]
    for c_in, c_out, bn in ((1024, 512, True), (512, 256, True),
                            (256, k * k, False)):
        args += [_w(gen, c_in, c_out, dev), _r(gen, c_out, dev=dev)]
        if bn:
            args += [_gam(gen, c_out, dev), _r(gen, c_out, dev=dev)]
    return args + [_r(gen, 512, scale=0.3, dev=dev),
                   _r(gen, 256, scale=0.3, dev=dev)]


def fc_head_layers(got, args, bf16):
    """The plain forward of ``fc_head_fwd`` layer by layer on the kernel's
    own stashes: z1 from the inputs, each BN's statistics from the
    kernel's z, fc2 and fc3 from h1 and h2 made of the kernel's z and
    statistics. Each layer is then held to its operands as the kernel saw
    them: fc2 and fc3 take h1 and h2 rounded to bf16, and where the two
    sides' h1 sits on a rounding boundary one element moves a whole row of
    z2 and, through BN2, of h2 and out (1.7e-3 of out at k=3, half of what
    bf16 moves it); and at B=2 a variance is a squared difference of two
    rows, whose relative error an fp32 sum-order difference in z blows up
    (inv 1.2e-4 off)."""
    from adversarial_learning_on_pointclouds_tpu_torch.models import core
    from adversarial_learning_on_pointclouds_tpu_torch.ops.kernels import (
        fc_head_train as fh,
    )

    h, w1, b1, g1, be1, w2, b2, g2, be2, w3, b3, rm1, rm2 = args
    _, z1k, z2k = got[:3]
    op = lambda t: core.operand(t, bf16)  # noqa: E731
    mu1, var1, inv1 = fh._moments(z1k, rm1)
    mu2, var2, inv2 = fh._moments(z2k, rm2)
    h1 = torch.relu((z1k - mu1) * (inv1 * g1) + be1)
    h2 = torch.relu((z2k - mu2) * (inv2 * g2) + be2)
    return (torch.matmul(op(h2), op(w3)) + b3,
            torch.matmul(op(h), op(w1)) + b1,
            torch.matmul(op(h1), op(w2)) + b2, mu1, var1, inv1, mu2, var2,
            inv2)


def pt_kernel_checks(dev, gen, rec, rec_bf):
    """Phase 15: each pass against its plain pass, then each autograd
    function against its whole-function reference."""
    from adversarial_learning_on_pointclouds_tpu_torch.ops.kernels import (
        fc_head_train as fh, maxpool_points as mp, shared_mlp as sm,
        tnet_apply as ta,
    )

    tag = "pallas-train-kernels"
    # The generator's widths, then the discriminator's not among them
    # (PARTS -> 64 -> 128 -> 256 -> 512 -> 1).
    widths = ((3, 64), (64, 64), (64, 128), (128, 1024), (512, 256),
              (256, 128), (128, PARTS), (PARTS, 64), (128, 256), (256, 512),
              (512, 1))
    with torch.no_grad():
        # 3B x N: the discriminator's stacked pass over [fake_l; fake_u;
        # real] at N=2500 (240,000 rows).
        for bsz, n in ((B, TRAIN_N), (B, TRAIN_RAGGED_N), (2, TRAIN_N),
                       (3 * B, TRAIN_RAGGED_N)):
            at = f"B={bsz} N={n}"
            for c_in, c_out in widths:
                x = _r(gen, bsz, n, c_in, scale=1.0, dev=dev)
                w, b = _w(gen, c_in, c_out, dev), _r(gen, c_out, dev=dev)
                g = _r(gen, bsz, n, c_out, scale=1.0, dev=dev)
                for pas, fn, plain, a in (
                        ("fwd", sm.pm_fwd, sm.pm_fwd_plain, (x, w, b)),
                        ("dx", sm.pm_dx, sm.pm_dx_plain, (g, w))):
                    for bf16, r in ((False, rec), (True, rec_bf)):
                        # Both sides round the same inputs: fp32-level
                        # bound.
                        t = f"{c_in}->{c_out} {at}{' bf16' if bf16 else ''}"
                        got, ref = fn(*a, bf16), plain(*a, bf16)
                        r.cmp("pointwise_matmul", pas, t, (pas,), (got,),
                              (ref,), False, (*a, bf16), phase_tag=tag,
                              bound=BOUND)
                        if not bf16:
                            ref64 = plain(*f64(a))
                            rec.cmp_f64("pointwise_matmul", pas, t, got, ref,
                                        ref64, tag)
                            if (pas, c_in, c_out, n) == (
                                    "dx", 128, 1024, TRAIN_RAGGED_N) and \
                                    bsz == B:
                                tf32_control(
                                    f"torch.matmul at K={g.shape[-1]}",
                                    lambda: sm.pm_dx_plain(g, w), ref64, ref,
                                    tag)
                a = (x, g)
                t = f"{c_in}->{c_out} {at}"
                got, ref = sm.pm_dwdb(*a), sm.pm_dwdb_plain(*a)
                rec.cmp("pointwise_matmul", "dW", t, ("dw", "db"), got, ref,
                        False, a, phase_tag=tag)
                rec.cmp_f64("pointwise_matmul", "dW", t, got[0], ref[0],
                            sm.pm_dwdb_plain(*f64(a))[0], tag)
            for k in (3, 64):
                x = _r(gen, bsz, n, k, scale=1.0, dev=dev)
                t = (torch.eye(k) + torch.randn(bsz, k, k, generator=gen)
                     * 0.2).to(dev)
                g = _r(gen, bsz, n, k, scale=1.0, dev=dev)
                for pas, fn, plain, a in (
                        ("fwd", ta.tnet_fwd, ta.tnet_fwd_plain, (x, t)),
                        ("dx", ta.tnet_dx, ta.tnet_dx_plain, (g, t)),
                        ("dT", ta.tnet_dt, ta.tnet_dt_plain, (x, g))):
                    got, ref = fn(*a), plain(*a)
                    rec.cmp("tnet_apply", pas, f"k={k} {at}", (pas,), (got,),
                            (ref,), False, a, phase_tag=tag)
                    rec.cmp_f64("tnet_apply", pas, f"k={k} {at}", got, ref,
                                plain(*f64(a)), tag)
            # Post-ReLU features (a channel all zeros ties at every point);
            # the first half of the clouds repeat their first half of
            # points in the second: every max there is attained twice.
            x = torch.relu(torch.randn(bsz, n, 1024, generator=gen)).to(dev)
            dup, half = max(1, bsz // 2), n // 2
            x[:dup, n - half:] = x[:dup, :half]
            x[:, :, 7] = 0.0
            y, win = mp.maxpool_fwd(x)
            py, pwin = mp.maxpool_fwd_plain(x)
            rec.cmp("maxpool_points", "fwd", at, ("y", "winner"), (y, win),
                    (py, pwin), False, (x,), phase_tag=tag, bound=0.0)
            if int((win[:dup] >= n - half).sum()) or (win[:, 7] != 0).any():
                raise AssertionError("maxpool_points: a tie went to a later "
                                     "point")
            g = _r(gen, bsz, 1024, scale=1.0, dev=dev)
            dx = mp.maxpool_bwd(g, win, n)
            rec.cmp("maxpool_points", "bwd", at, ("dx",), (dx,),
                    (mp.maxpool_bwd_plain(g, pwin, n),), False, (g, win, n),
                    phase_tag=tag, bound=0.0)
            if int(((dx != 0).sum(1) > 1).sum()):
                raise AssertionError("maxpool_points: two winners")
        for bsz in (B, 2):
            for k in (3, 64):
                args = fc_head_args(gen, bsz, k, dev)
                if bsz == 2:
                    # Two rows: the one-pass variance about a random
                    # centre cancels to a few bits (an fp32 sum-order
                    # difference moved inv by 2e-2 here), so centre the
                    # moments on the batch means, which running means
                    # track.
                    ref = fh.fc_head_fwd_plain(*args)
                    args[11], args[12] = ref[3], ref[6]
                for bf16, r in ((False, rec), (True, rec_bf)):
                    t = f"B={bsz} k={k}{' bf16' if bf16 else ''}"
                    # In fp32 at B=32 the float64 controls: the forward's
                    # z1, z2, var1 and var2, the backward's dh, dw1 and
                    # dw2; at k=64 the TF32 controls on z1 and dh.
                    f64_checks = not bf16 and bsz == B
                    control = f64_checks and k == 64
                    a = (*args, bf16)
                    got = fh.fc_head_fwd(*a)
                    r.cmp("fc_head_train", "fwd", t, ("out", "z1", "z2",
                          "mu1", "var1", "inv1", "mu2", "var2", "inv2"),
                          got, fc_head_layers(got, args, bf16), False, a,
                          phase_tag=tag, bound=BOUND)
                    ref = fh.fc_head_fwd_plain(*a)
                    if f64_checks:
                        ref64 = fh.fc_head_fwd_plain(*f64(a))
                        pick = (1, 2, 4, 7)
                        tc_f64(rec, "fc_head_train", "fwd", t,
                               [got[i] for i in pick], [ref[i] for i in pick],
                               [ref64[i] for i in pick],
                               ("z1", "z2", "var1", "var2"), tag,
                               (lambda: fh.fc_head_fwd_plain(*a)[1])
                               if control else None)
                    _, z1, z2, mu1, _, inv1, mu2, _, inv2 = ref
                    dh2 = _r(gen, bsz, 256, scale=1.0, dev=dev)
                    a = (dh2, args[0], z1, z2, args[1], args[5], args[3],
                         args[4], args[7], args[8], mu1, inv1, mu2, inv2,
                         bf16)
                    got, ref = fh.fc_head_bwd(*a), fh.fc_head_bwd_plain(*a)
                    names = ("dh", "dw1", "db1", "dg1", "dbe1", "dw2", "db2",
                             "dg2", "dbe2")
                    # db sums a BN's dz over the rows, which cancels to
                    # zero: held to the sum of its terms' magnitudes.
                    h1 = fh.recompute_h(z1, mu1, inv1, args[3], args[4])
                    dz2 = fh._bn_bwd(dh2, z2, mu2, inv2, args[7], args[8],
                                     h1, False)[0]
                    dz1 = fh._bn_bwd(torch.matmul(dz2, args[5].t()), z1, mu1,
                                     inv1, args[3], args[4], args[0], False)[0]
                    scales = {"db1": dz1.abs().sum(0).max().item(),
                              "db2": dz2.abs().sum(0).max().item()}
                    keep = [i for i, nm in enumerate(names)
                            if not (bf16 and nm in ("dw1", "dw2"))]
                    r.cmp("fc_head_train", "bwd", t,
                          [names[i] for i in keep], [got[i] for i in keep],
                          [ref[i] for i in keep], False, a, scales, tag,
                          BOUND)
                    if f64_checks:
                        ref64 = fh.fc_head_bwd_plain(*f64(a))
                        pick = (0, 1, 5)
                        tc_f64(rec, "fc_head_train", "bwd", t,
                               [got[i] for i in pick], [ref[i] for i in pick],
                               [ref64[i] for i in pick],
                               ("dh", "dw1", "dw2"), tag,
                               (lambda: fh.fc_head_bwd_plain(*a)[0])
                               if control else None)
                    if bf16:
                        for i in (1, 5):
                            d = check_rounded(f"fc_head_train bwd {names[i]} "
                                              f"{t}", got[i], ref[i])
                            key = ("fc_head_train", "bwd")
                            r.err[key] = max(r.err.get(key, 0.0), d)
    torch.cuda.synchronize()

    # Each autograd function against its whole-function reference.
    bsz, n = B, TRAIN_N
    x64 = torch.randn(bsz, n, 64, generator=gen).to(dev)
    xr = torch.relu(torch.randn(bsz, n, 1024, generator=gen)).to(dev)
    xr[:, n // 2:] = xr[:, :n // 2]
    t64 = (torch.eye(64) + torch.randn(bsz, 64, 64, generator=gen) * 0.2
           ).to(dev)
    fc = fc_head_args(gen, bsz, 64, dev)
    cases = {
        "pointwise_matmul": (sm.pointwise_matmul,
                             lambda x, w, b: sm.pm_fwd_plain(x, w, b),
                             [x64, _w(gen, 64, 128, dev),
                              _r(gen, 128, dev=dev)], {}),
        "tnet_apply": (ta.tnet_apply, torch.matmul, [x64, t64], {}),
        "maxpool_points": (mp.maxpool_points, mp.maxpool_points_reference,
                           [xr], {}),
        # b1 and b2 precede a batch-statistic BN: their gradients are
        # zero in exact arithmetic, held to the norm of the same layer's
        # weight gradient.
        "fc_head_train": (fh.fc_head_train, fh.fc_head_train_reference, fc,
                          {2: 1, 6: 5}),
    }
    for name, (fn, ref_fn, args, zero) in cases.items():
        outs = []
        for f in (fn, ref_fn):
            leaves = [a.detach().clone().requires_grad_() for a in args]
            out = f(*leaves)
            out = out if isinstance(out, tuple) else (out,)
            torch.sin(out[0]).sum().backward()
            outs.append((out, [lf.grad for lf in leaves]))
        (o, g), (o_ref, g_ref) = outs
        for i, (a_, b_) in enumerate(zip(o, o_ref)):
            check_norm(f"{name} autograd output {i}", a_.detach(),
                       b_.detach(), tag=tag)
        for i, (a_, b_) in enumerate(zip(g, g_ref)):
            if b_ is None:       # the running means: constants
                continue
            w = zero.get(i)
            check_norm(f"{name} autograd grad {i}", a_, b_,
                       None if w is None else g_ref[w].norm().item(), tag)
    torch.cuda.synchronize()


def pt_slice(dev, card, gen):
    """Phase 16: the config-3 step under the switch at N=2048 and 2500 and
    the bench G+D step under it, card against CPU, launches checked."""
    from adversarial_learning_on_pointclouds_tpu_torch.configs import (
        AdversarialConfig, SegmentConfig,
    )

    tag = "pallas-train-slice"
    counters = {**pass_counters(), **pt_counters()}
    seg = {}
    for n in (TRAIN_N, TRAIN_RAGGED_N):
        cfg = SegmentConfig(batch_size=B, num_points=n)
        model, pts, labels = seg_setup(cfg, gen, SEED + n)
        calls = {}
        t = f"{tag} N={n}"
        runs, launches = seg_step_runs(cfg, model, pts, labels, t, counters,
                                       True, calls)
        check_launches(t, launches, PT_SEG_PER_STEP[n])
        compare_seg(t, runs)
        seg[n] = (cfg, model, runs["cuda"], launches, calls)

    cfg = AdversarialConfig(batch_size=B, num_points=TRAIN_N, augment=True,
                            bf16=True, pallas_augment=True)
    setup = adv_setup(cfg, gen, dev)
    t = f"{tag} bench step"
    yard = step_runs(dataclasses.replace(cfg, bf16=False), *setup,
                     f"{t} yardstick (fp32)", dev, ("cpu",),
                     switch=True)[0]["cpu"]
    calls = {}
    runs, launches = step_runs(cfg, *setup, t, dev, switch=True,
                               record=calls)
    check_launches(t, launches, PT_BENCH_PER_STEP)
    compare_step(t, runs, cfg, STEP_BOUND, GRAD_BOUND, yard)
    return seg, (cfg, setup, runs["cuda"], launches, calls)


# One PyTorch call computing each pass's function, timed beside it as a
# yardstick (the port never calls these); a pass not named has none.
PT_LIBRARY = {
    ("pointwise_matmul", "fwd"): lambda x, w, b, bf16: torch.addmm(
        b, x.reshape(-1, x.shape[-1]), w),
    ("pointwise_matmul", "dx"): lambda g, w, bf16: torch.matmul(g, w.t()),
    ("pointwise_matmul", "dW"): lambda x, g: torch.matmul(
        x.reshape(-1, x.shape[-1]).t(), g.reshape(-1, g.shape[-1])),
    ("tnet_apply", "fwd"): torch.bmm,
    ("tnet_apply", "dx"): lambda g, t: torch.bmm(g, t.transpose(1, 2)),
    ("tnet_apply", "dT"): lambda x, g: torch.bmm(x.transpose(1, 2), g),
    ("maxpool_points", "fwd"): lambda x: torch.max(x, dim=1),
}


def time_calls(card, key, fn, plain, calls, err, bf16=False,
               step=f"config-3 step at N={TRAIN_RAGGED_N}"):
    """One pass over the calls of a step: kernel, plain and library ms
    (CUDA events), each one's device time alone (profiler), the bound, all
    per step (``step`` names it). An fp32 pass of the GEMM core is bound
    at the 3xTF32 rate, the rate of the product it does, and also states
    its bound at the fp32 FMA rate (``bound_fma_ms``)."""
    lib = PT_LIBRARY.get(key)
    with torch.no_grad():
        ms, plain_ms = time_pair(lambda: [fn(*a) for a in calls],
                                 lambda: [plain(*a) for a in calls])
        dev_ms = sum(device_profile(lambda: [fn(*a) for a in calls]).values())
        plain_dev_ms = sum(device_profile(
            lambda: [plain(*a) for a in calls]).values())
        lib_ms = lib_dev_ms = None
        if lib is not None:
            lib_ms = time_pair(lambda: [lib(*a) for a in calls],
                               lambda: None)[0]
            lib_dev_ms = sum(device_profile(
                lambda: [lib(*a) for a in calls]).values())
    flops, nbytes = work(plain, calls)
    tf32x3 = key[0] in GEMM_KERNELS + FC_TC and not bf16
    rate = (BF16_PEAK, "bf16 tensor-core") if bf16 else (
        TF32X3_PEAK, "3xTF32 tensor-core") if tf32x3 else (FP32_PEAK,
                                                           "fp32 FMA")
    bound_ms, bound_by = bound(flops, nbytes, rate[0])
    row = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
           "bound_ms": bound_ms, "bound_by": bound_by, "device_ms": dev_ms,
           "plain_device_ms": plain_dev_ms,
           "library_device_ms": lib_dev_ms, "max_abs_err": err,
           "tflops": flops / ms / 1e9}
    fma = ""
    if tf32x3:
        row["bound_fma_ms"] = bound(flops, nbytes)[0]
        fma = f"; at the fp32 FMA rate {row['bound_fma_ms']:.4f} ms"
    phase("pallas-train-timing", f"{card}: {key[0]} {key[1]}"
          f"{' bf16' if bf16 else ''} x{len(calls)} per {step}: kernel "
          f"{ms:.4f} ms ({row['tflops']:.1f} TFLOP/s), plain {plain_ms:.4f} "
          f"ms, library {'none' if lib_ms is None else f'{lib_ms:.4f} ms'}; "
          f"device time alone: kernel {dev_ms:.4f} ms, plain "
          f"{plain_dev_ms:.4f} ms, library "
          f"{'none' if lib_dev_ms is None else f'{lib_dev_ms:.4f} ms'}; "
          f"bound {bound_ms:.4f} ms ({bound_by}; {rate[1]} rate){fma}")
    return row


def largest_calls(card, key, fn, plain, calls, count=3, tag=""):
    """The ``count`` largest shapes among a pass's calls (by FLOPs, then
    bytes), each timed alone: kernel, plain and library ms (CUDA events),
    the kernel's and the library's device time alone (profiler), and the
    kernel's TFLOP/s and GB/s over its device time."""
    lib = PT_LIBRARY.get(key)
    shapes = {}
    for a in calls:
        shapes.setdefault(tuple(tuple(t.shape) for t in _tensors(a)), a)
    ranked = sorted(shapes.items(), key=lambda kv: tuple(
        -v for v in work(plain, [kv[1]])))
    rows = []
    with torch.no_grad():
        for sig, a in ranked[:count]:
            ms, plain_ms = time_pair(lambda: fn(*a), lambda: plain(*a))
            dev_ms = sum(device_profile(lambda: fn(*a)).values())
            lib_ms = lib_dev_ms = None
            if lib is not None:
                lib_ms = time_pair(lambda: lib(*a), lambda: None)[0]
                lib_dev_ms = sum(device_profile(lambda: lib(*a)).values())
            flops, nbytes = work(plain, [a])
            shape = " @ ".join("x".join(map(str, t)) for t in sig)
            rows.append({"shape": shape, "ms": ms, "plain_ms": plain_ms,
                         "library_ms": lib_ms, "device_ms": dev_ms,
                         "library_device_ms": lib_dev_ms,
                         "tflops": flops / ms / 1e9,
                         "device_gb_s": nbytes / dev_ms / 1e6})
            phase("pallas-train-timing", f"{card}: {key[0]} {key[1]}{tag} "
                  f"{shape}: kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} "
                  f"TFLOP/s), plain {plain_ms:.4f} ms, library "
                  f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'}; "
                  f"device time alone: kernel {dev_ms:.4f} ms "
                  f"({flops / dev_ms / 1e9:.1f} TFLOP/s, "
                  f"{nbytes / dev_ms / 1e6:.1f} GB/s), library "
                  f"{'none' if lib_dev_ms is None else f'{lib_dev_ms:.4f} ms'}")
    return rows


def time_seg_step(card, tag, cfg, state, x, y, tx, switch):
    """The config-3 step, one synchronized ``train_step`` per call, on or
    off the switch: median of 12 (CUDA events), points/s, idle share."""
    from adversarial_learning_on_pointclouds_tpu_torch.ops import dispatch
    from adversarial_learning_on_pointclouds_tpu_torch.train import segment

    def step():
        segment.train_step(state, x, y, cfg=cfg, tx=tx)

    with dispatch.use_pallas_train(switch):
        for _ in range(3):
            step()
        step_ms = statistics.median(event_ms(step, 12))
        busy = sum(device_profile(step, reps=5).values())
    pts = cfg.batch_size * cfg.num_points
    phase("pallas-train-timing", f"{card}: {tag}: config-3 train_step "
          f"B={cfg.batch_size} N={cfg.num_points} "
          f"{'under' if switch else 'off'} the switch: median {step_ms:.3f} "
          f"ms over 12 steps, {pts / step_ms * 1e3:.1f} points/s, GPU "
          f"kernels busy {busy:.3f} ms ({100 * (1 - busy / step_ms):.1f}% "
          "idle)")
    return {"step_ms": step_ms, "busy_ms": busy}


def pt_timing(card, rec, rec_bf, results, seg, bench):
    """Phase 17."""
    from adversarial_learning_on_pointclouds_tpu_torch.ops import (
        build, dispatch,
    )
    from adversarial_learning_on_pointclouds_tpu_torch.train import (
        adversarial, segment,
    )

    _, _, _, launches, calls = seg[TRAIN_RAGGED_N]
    bcfg, setup, brun, blaunches, bcalls = bench
    counters = pt_counters()
    for kernel, (src, sites) in PT_KERNELS.items():
        passes = []
        for pas, fn in counters[kernel].items():
            plain = getattr(sys.modules[fn.__module__],
                            fn.__name__ + "_plain")
            row = time_calls(card, (kernel, pas), fn, plain,
                             calls[(kernel, pas)], rec.err[(kernel, pas)])
            if kernel in GEMM_KERNELS + FC_TC:
                row["f64_ratio"] = rec.f64[(kernel, pas)]
            if kernel in GEMM_KERNELS:
                row["largest"] = largest_calls(card, (kernel, pas), fn,
                                               plain, calls[(kernel, pas)])
            if bcalls[(kernel, pas)]:       # the bench step: bf16 operands
                bf = time_calls(card, (kernel, pas), fn, plain,
                                bcalls[(kernel, pas)],
                                rec_bf.err.get((kernel, pas),
                                               rec.err[(kernel, pas)]),
                                kernel == "pointwise_matmul", "bench step")
                if kernel in GEMM_KERNELS:
                    bf["largest"] = largest_calls(
                        card, (kernel, pas), fn, plain,
                        bcalls[(kernel, pas)], tag=" bench step")
                row.update({f"bench_{k}": v for k, v in bf.items()})
            passes.append({"pass": pas, "replaces": f"{TPU_KERNELS}/"
                           f"{sites[pas]}",
                           "launches": launches[kernel][pas], **row})
        entry = kernel_entry(kernel, src, sites["fwd"],
                             sum(launches[kernel].values()), passes,
                             f"per config-3 step at B={B} "
                             f"N={TRAIN_RAGGED_N} under use_pallas_train")
        # One PyTorch call per pass where every pass has one (the sum of
        # those calls' times), else null; each pass keeps its own.
        libs = [p["library_ms"] for p in passes]
        entry["library_ms"] = None if None in libs else sum(libs)
        if kernel in GEMM_KERNELS:
            entry["sources"] = [entry["source"],
                                f"{KERNELS_ROOT}/csrc/strided_gemm.cu"]
            entry["ptxas"] = {**ptxas_report(build, src), **ptxas_report(
                build, "strided_gemm.cu")}
            entry["bound_fma_ms"] = sum(p["bound_fma_ms"] for p in passes)
        if kernel in FC_TC:
            entry["sources"] = [entry["source"],
                                f"{KERNELS_ROOT}/csrc/{FC_SOURCE}"]
            entry["ptxas"] = ptxas_report(build, src)
            entry["bound_fma_ms"] = sum(p["bound_fma_ms"] for p in passes)
        if all("bench_ms" in p for p in passes):
            for k in ("ms", "plain_ms", "bound_ms", "device_ms",
                      "plain_device_ms"):
                entry[f"bench_{k}"] = sum(p[f"bench_{k}"] for p in passes)
        entry["launches_n2048"] = sum(seg[TRAIN_N][3][kernel].values())
        entry["launches_bench_step"] = sum(blaunches[kernel].values())
        results.append(entry)

    # The steps, on and off the switch, in turns.
    for n in (TRAIN_N, TRAIN_RAGGED_N):
        cfg, model, (state, _, _, x, y, tx), _, _ = seg[n]
        off = segment.create_state(cfg, 100, device="cuda",
                                   model=copy.deepcopy(model))
        for switch, st in ((False, off), (True, state), (True, state),
                           (False, off)):
            time_seg_step(card, f"N={n}", cfg, st, x, y, tx, switch)
    rng = np.random.default_rng(SEED + 3)
    bsz, n = bcfg.batch_size, bcfg.num_points
    x_k = [torch.from_numpy(rng.normal(size=(BENCH_K, bsz, n, 3)).astype(
        np.float32)).cuda() for _ in range(2)]
    y_k = torch.from_numpy(rng.integers(0, bcfg.num_parts, (
        BENCH_K, bsz, n))).cuda()
    states = {s: adversarial.create_state(
        bcfg, 100, device="cuda", g_model=copy.deepcopy(setup[0]),
        d_model=copy.deepcopy(setup[1])) for s in (False, True)}
    txs = adversarial.make_txs(bcfg, 100)
    for switch in (False, True, True, False):
        with dispatch.use_pallas_train(switch):
            time_scan(card, "bench step " + ("under" if switch else "off")
                      + " the switch", bcfg, states[switch],
                      (x_k[0], y_k, x_k[1]), txs)
    with dispatch.use_pallas_train():
        kernels = device_profile(lambda: adversarial.train_steps_scan(
            states[True], x_k[0], y_k, x_k[1], cfg=bcfg, g_tx=txs[0],
            d_tx=txs[1]), reps=1)
    for key, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:14]:
        phase("pallas-train-timing", f"  {ms / BENCH_K:.4f} ms per step "
              f"under the switch  {key[:90]}")


# ---------------------------------------------------------------------------
# fused_mlp_stack, trunk3_train and the config-4 step at N=2500 under the
# switch (phases 18-20)
# ---------------------------------------------------------------------------

def trunk3_args(gen, bsz, n, c0, dev):
    """Inputs of ``trunk3_train`` at a T-Net's widths: STN3d's raw points
    (c0=3) or STNkd's post-ReLU features (c0=64), the first half of the
    clouds repeating their first half of points in the second (every
    extremum there a tie), 64 -> 128 -> 1024 with negative BN3 gammas."""
    x = torch.randn(bsz, n, c0, generator=gen)
    if c0 > 3:
        x = torch.relu(x)
    x[:bsz // 2, n - n // 2:] = x[:bsz // 2, :n // 2]
    args = [x.to(dev)]
    for c_in, c_out, neg in ((c0, 64, 0.0), (64, 128, 0.0), (128, 1024, 0.3)):
        args += [_w(gen, c_in, c_out, dev), _r(gen, c_out, dev=dev),
                 _gam(gen, c_out, dev, negative=neg), _r(gen, c_out, dev=dev)]
    return args


def conv1_then_trunk2(x, w1, b1, g1, be1, *rest):
    """conv1 + BN1 + ReLU in plain PyTorch (two-pass moments) in front of
    the port's ``trunk2_train``: trunk3_train composed another way."""
    from adversarial_learning_on_pointclouds_tpu_torch.models.core import (
        BN_EPS,
    )
    from adversarial_learning_on_pointclouds_tpu_torch.ops.kernels import (
        trunk_train as tt,
    )

    z1 = torch.matmul(x, w1) + b1
    mu1, var1 = z1.mean((0, 1)), z1.var((0, 1), unbiased=False)
    h1 = torch.relu((z1 - mu1) * torch.rsqrt(var1 + BN_EPS) * g1 + be1)
    g, mu2, var2, mu3, var3 = tt.trunk2_train(h1, *rest)
    return g, mu1.detach(), var1.detach(), mu2, var2, mu3, var3


def fwd_bwd(fn, args):
    """``fn``'s outputs and the gradients of ``sum(sin(out[0]))`` with
    respect to every argument."""
    leaves = [t.detach().clone().requires_grad_() for t in args]
    out = fn(*leaves)
    torch.sin(out[0]).sum().backward()
    return [o.detach() for o in out], [t.grad for t in leaves]


def trunk3_pass_checks(dev, gen, rec, args, tag, ptag, bf16=False,
                       control=False):
    """trunk3_train's six passes at its shapes, each against its plain
    pass on the plain chain's outputs (as phase 6 runs trunk2's); Pmid and
    the head's B1 in fp32 also against float64, with TF32 controls that
    must fail under ``control``; with ``bf16`` the passes as
    ``trunk3_train`` runs them under ``core.mixed_precision`` (bf16
    operands and stashes, as phase 12 runs trunk2's), held to
    ``BF16_BOUND`` and ``check_stash``."""
    from adversarial_learning_on_pointclouds_tpu_torch.models import core
    from adversarial_learning_on_pointclouds_tpu_torch.ops.kernels import (
        seg_head_train as sh, trunk_train as tt,
    )

    x, w1, b1, g1, be1, w2, b2, g2, be2, w3, b3, g3, be3 = args
    bsz, n, _ = x.shape
    m = bsz * n
    k = "trunk3_train bf16" if bf16 else "trunk3_train"
    xt = (1, True) if bf16 else ()       # the trunk passes' groups, bf16
    xb = (True,) if bf16 else ()         # the seg-head passes' bf16
    bnd = BF16_BOUND if bf16 else None
    a = (x, w1, b1, *xt)
    got, ref = tt.f1(*a), tt.f1_plain(*a)
    rec.cmp(k, "F1", tag, ("z1", "sum", "sumsq"), got, ref, False, a,
            phase_tag=ptag, bound=bnd, max_share=STASH_SHARE)
    if not bf16:
        tc_f64(rec, k, "F1", tag, got, ref, f1_f64(*a), ("z1",), ptag,
               (lambda: tt.f1_plain(*a)[0]) if control else None)
    z1 = ref[0]
    mu1, _, inv1 = core.batch_moments(ref[1], ref[2], m)
    sc1, sh1 = g1 * inv1, be1 - mu1 * g1 * inv1
    a = (z1, sc1, sh1, w2, b2, *xb)
    got, ref = sh.pmid(*a), sh.pmid_plain(*a)
    rec.cmp(k, "Pmid", tag, ("z2", "sum", "sumsq"), got, ref, False, a,
            phase_tag=ptag, bound=bnd, max_share=STASH_SHARE)
    if not bf16:
        tc_f64(rec, k, "Pmid", tag, got, ref, pmid_f64(*a), ("z2",), ptag,
               (lambda: sh.pmid_plain(*a)[0]) if control else None)
    z2 = ref[0]
    mu2, _, inv2 = core.batch_moments(ref[1], ref[2], m)
    sc2, sh2 = g2 * inv2, be2 - mu2 * g2 * inv2
    a = (z2, sc2, sh2, w3, b3, *xt)
    got, ref = tt.f2(*a), tt.f2_plain(*a)
    rec.cmp(k, "F2", tag, ("sum", "sumsq", "max", "min"), got[:4], ref[:4],
            False, a, phase_tag=ptag, bound=bnd)
    z3 = torch.matmul(core.operand(torch.relu(z2.float() * sc2 + sh2), bf16),
                      core.operand(w3, bf16)) + b3
    check_winners(f"(trunk3) {tag}", got[4], ref[4], z3, x, bsz // 2, n,
                  "max", ptag)
    check_winners(f"(trunk3) {tag}", got[5], ref[5], -z3, x, bsz // 2, n,
                  "min", ptag)
    del z3
    mu3, _, inv3 = core.batch_moments(ref[0], ref[1], m)
    s3c = g3 * inv3
    idx = torch.where(s3c >= 0, ref[4], ref[5])
    dg = _r(gen, bsz, 1024, scale=1.0, dev=dev)
    a = (z2, sc2, sh2, w3, b3, mu3, inv3,
         _r(gen, bsz, 1024, scale=1e-3, dev=dev),
         _r(gen, bsz, 1024, scale=1e-3, dev=dev), s3c * dg, idx, mu2, inv2,
         *xt)
    got, ref = tt.b1(*a), tt.b1_plain(*a)
    rec.cmp(k, "B1", tag, ("dy2", "dw3", "db3", "t1", "t2"), got, ref, False,
            a, phase_tag=ptag, bound=bnd)
    dy2, t1, t2 = ref[0], ref[3], ref[4]
    a = (z2, dy2, sc2, mu2, inv2, sc2 * t1 / m, sc2 * t2 / m, z1, sc1, sh1,
         w2, mu1, inv1, *xb)
    got, ref = sh.bmid(*a), sh.bmid_plain(*a)
    rec.cmp(k, "Bmid", tag, ("dy_prev", "dw", "db", "t1", "t2"), got, ref,
            False, a, dz_scales(sh, a), ptag, bnd)
    dy1, t1, t2 = ref[0], ref[3], ref[4]
    a = (z1, dy1, sc1, mu1, inv1, sc1 * t1 / m, sc1 * t2 / m, x, w1, *xb)
    got, ref = sh.b1(*a), sh.b1_plain(*a)
    rec.cmp(k, "head B1", tag, ("dpf", "dw1a", "db1", "r"), got, ref, False,
            a, dz_scales(sh, a), ptag, bnd)
    if not bf16:
        tc_f64(rec, k, "head B1", tag, got, ref, head_b1_f64(*a),
               ("dpf", "dw1a"), ptag,
               (lambda: sh.b1_plain(*a)[0]) if control else None)


def stack_trunk3_checks(dev, gen):
    """Phase 18: ``fused_mlp_stack`` against its plain version, and
    ``trunk3_train``'s passes and whole function, at the shapes of their
    paths. Returns the record of the largest errors."""
    from adversarial_learning_on_pointclouds_tpu_torch.models import core
    from adversarial_learning_on_pointclouds_tpu_torch.ops.kernels import (
        shared_mlp as sm, trunk_train as tt,
    )

    tag = "stack-trunk3-kernels"
    rec = PassRecord()
    ws, bs = disc_params(gen, dev)
    chains = {"disc": (ws, bs, [torch.ones_like(b) for b in bs], D_ACTS)}
    tw = [layer_params(gen, c_in, c_out, dev)
          for c_in, c_out in ((3, 64), (64, 128), (128, 1024))]
    chains["3->64->128->1024 relu"] = ([t[0] for t in tw], [t[1] for t in tw],
                                       [t[2] for t in tw], ("relu",) * 3)
    with torch.no_grad():
        for name, (cw, csh, csc, acts) in chains.items():
            shapes = ((B, N), (B, RAGGED_N), (1, N)) if name == "disc" \
                else ((B, N),)
            for bsz, n in shapes:
                x = (prob_maps(gen, bsz, n, dev) if name == "disc" else
                     _r(gen, bsz, n, cw[0].shape[0], scale=1.0, dev=dev))
                for bf16 in (False, True):
                    t = f"{name} B={bsz} N={n}{' bf16' if bf16 else ''}"
                    with core.mixed_precision(enabled=bf16):
                        got = sm.fused_mlp_stack(x, cw, csh, csc, acts)
                    ref = sm.fused_mlp_stack_plain(x, cw, csh, csc, acts,
                                                   bf16)
                    rec.cmp("fused_mlp_stack", "fwd", t, ("out",), (got,),
                            (ref,), False, (), phase_tag=tag,
                            bound=BF16_BOUND if bf16 else BOUND)
        torch.cuda.synchronize()

    for c0 in (3, 64):
        for bsz, n in ((B, TRAIN_N), (B, TRAIN_RAGGED_N), (2, TRAIN_N)):
            at = f"c_in={c0} B={bsz} N={n}"
            args = trunk3_args(gen, bsz, n, c0, dev)
            with torch.no_grad():
                trunk3_pass_checks(dev, gen, rec, args, at, tag,
                                   control=(c0, bsz, n) == (64, B, TRAIN_N))
            out, grads = fwd_bwd(tt.trunk3_train, args)
            for other, fn in (("reference", tt.trunk3_train_reference),
                              ("conv1 + trunk2_train", conv1_then_trunk2)):
                o_ref, g_ref = fwd_bwd(fn, args)
                for i, (a_, b_) in enumerate(zip(out, o_ref)):
                    check_norm(f"trunk3_train output {i} vs {other} {at}",
                               a_, b_, tag=tag)
                for i, (a_, b_) in enumerate(zip(grads, g_ref)):
                    w = TRUNK3_ZERO_GRADS.get(i)
                    check_norm(f"trunk3_train grad {i} vs {other} {at}", a_,
                               b_, None if w is None else
                               g_ref[w].norm().item(), tag)
            torch.cuda.synchronize()
    # bf16 at STN3d's input width, new to the passes: F1 on raw points and
    # the head's B1 with a 3-wide dpf, each on a 32-column pad.
    at = f"c_in=3 B={B} N={TRAIN_RAGGED_N} bf16"
    with torch.no_grad():
        trunk3_pass_checks(dev, gen, rec,
                           trunk3_args(gen, B, TRAIN_RAGGED_N, 3, dev), at,
                           tag, bf16=True)
    torch.cuda.synchronize()
    return rec


def adv_pt_slice(dev, card, gen):
    """Phase 19: the config-4 step at N=2500 under the switch in fp32 and
    in the bench configuration (K=8 through ``train_steps_scan``), card
    against CPU, launches per step; 10 steps on the fixed batch; D
    inference on the served segmenter's probabilities; ``trunk3_train``
    on its own. Returns what phase 20 times and the launches."""
    from adversarial_learning_on_pointclouds_tpu_torch.configs import (
        AdversarialConfig,
    )
    from adversarial_learning_on_pointclouds_tpu_torch.data import augment
    from adversarial_learning_on_pointclouds_tpu_torch.models import (
        FCDiscriminator, PointNetDenseCls,
    )
    from adversarial_learning_on_pointclouds_tpu_torch.ops import dispatch
    from adversarial_learning_on_pointclouds_tpu_torch.ops.kernels import (
        seg_head_train as sh, shared_mlp as sm, trunk_train as tt,
    )
    from adversarial_learning_on_pointclouds_tpu_torch.train import (
        adversarial,
    )

    tag = "adv-pallas-slice"
    out = {}
    cfg = AdversarialConfig(batch_size=B, num_points=TRAIN_RAGGED_N)
    setup = adv_setup(cfg, gen, dev)
    t = f"{tag} fp32"
    runs, launches = step_runs(cfg, *setup, t, dev, switch=True)
    check_launches(t, launches, PT_ADV_RAGGED_PER_STEP)
    compare_step(t, runs, cfg, STEP_BOUND, GRAD_BOUND)
    with dispatch.use_pallas_train():
        ten_steps(f"{tag} under the switch", cfg, runs["cuda"])
    _, _, _, batch, txs = runs["cuda"]
    out["fp32"] = (cfg, setup, batch, txs, launches)

    bcfg = AdversarialConfig(batch_size=B, num_points=TRAIN_RAGGED_N,
                             augment=True, bf16=True, pallas_augment=True,
                             scan=BENCH_K)
    bsetup = adv_setup(bcfg, gen, dev)
    t = f"{tag} bench step"
    yard = step_runs(dataclasses.replace(bcfg, bf16=False), *bsetup,
                     f"{t} yardstick (fp32)", dev, ("cpu",),
                     switch=True)[0]["cpu"]
    runs, blaunches = step_runs(bcfg, *bsetup, t, dev, switch=True)
    want = {**PT_ADV_RAGGED_PER_STEP, "augment_fused": {"fwd": AUG_PER_STEP}}
    check_launches(t, blaunches, want)
    compare_step(t, runs, bcfg, STEP_BOUND, GRAD_BOUND, yard)
    rng = np.random.default_rng(SEED + 4)
    x_k = [torch.from_numpy(rng.normal(size=(BENCH_K, B, TRAIN_RAGGED_N, 3))
                            .astype(np.float32)).to(dev) for _ in range(2)]
    y_k = torch.from_numpy(rng.integers(0, PARTS, (
        BENCH_K, B, TRAIN_RAGGED_N))).to(dev)
    batch_k = (x_k[0], y_k, x_k[1])
    bstate, _, _, _, btxs = runs["cuda"]
    counters = adv_counters()
    reset(counters)
    with dispatch.use_pallas_train():
        scan = adversarial.train_steps_scan(bstate, *batch_k, cfg=bcfg,
                                            g_tx=btxs[0], d_tx=btxs[1])
    torch.cuda.synchronize()
    got = read(counters)
    for kern, per in want.items():
        if got[kern] != {p: BENCH_K * c for p, c in per.items()}:
            raise AssertionError(f"{kern} launched {got[kern]} in "
                                 f"train_steps_scan K={BENCH_K}")
    ce = scan["loss_ce"].tolist()
    phase(tag, f"bench step: train_steps_scan K={BENCH_K} launched "
          f"{BENCH_K} x the per-step counts; loss_ce over the batches "
          + ", ".join(f"{v:.5f}" for v in ce))
    if not np.isfinite(ce).all():
        raise AssertionError("non-finite metrics")
    out["bench"] = (bcfg, bsetup, batch_k, btxs, blaunches)

    # D inference on the served segmenter's probabilities.
    g = PointNetDenseCls(PARTS, feature_transform=True, generator=gen)
    randomize_bn(g, gen)
    d = FCDiscriminator(PARTS, generator=gen)
    g, d_card = g.to(dev).eval(), copy.deepcopy(d).to(dev)
    x = augment.normalize_unit_sphere(torch.randn(B, N, 3, generator=gen)
                                      .to(dev))
    with torch.no_grad():
        probs = g(x)[0].exp()
        sm.fused_mlp_stack.launches = 0
        logits = d_card.infer(probs)
        torch.cuda.synchronize()
        stack_launches = sm.fused_mlp_stack.launches
        fwd = d_card(probs)
        cpu = d.infer(probs.cpu())
    if stack_launches != 1 or logits.grad_fn is not None:
        raise AssertionError(f"infer launched fused_mlp_stack "
                             f"{stack_launches} times")
    check("FCDiscriminator.infer vs forward (disc_fused) on the card",
          logits, fwd, tag=tag)
    check("FCDiscriminator.infer GPU vs CPU", logits.cpu(), cpu, tag=tag)
    phase(tag, f"D inference B={B} N={N}: fused_mlp_stack launched "
          f"{stack_launches} time, logits {tuple(logits.shape)}")
    out["stack"] = ((probs, *d_card._params(),
                     [torch.ones_like(b) for b in d_card._params()[1]]),
                    stack_launches)

    # trunk3_train on its own, at STN3d's shapes.
    args = trunk3_args(gen, B, TRAIN_RAGGED_N, 3, dev)
    passes = {"trunk_train": tt.PASSES, "seg_head_train": sh.PASSES}
    reset(passes)
    res = fwd_bwd(tt.trunk3_train, args)
    torch.cuda.synchronize()
    got = read(passes)
    t3 = {f"{mod} {p}": got[mod][p] for mod, p in TRUNK3_PASSES}
    if set(t3.values()) != {1} or sum(map(sum, (v.values() for v in
                                                 got.values()))) != 6:
        raise AssertionError(f"trunk3_train launched {got}")
    if not all(torch.isfinite(v).all() for v in res[0] + res[1]):
        raise AssertionError("trunk3_train: non-finite values")
    phase(tag, f"trunk3_train B={B} N={TRAIN_RAGGED_N} c_in=3, forward and "
          f"backward: launches {t3}")
    out["trunk3"] = (args, sum(t3.values()))
    return out


def trunk3_work(args):
    """``(fma_flops, tc_flops, bytes)`` of one trunk3_train forward and
    backward: each layer's product forward and its two products backward
    (dx, dW), split by the unit that runs them (layer 1's forward, F1, as
    fp32 FMAs; every other product, Pmid, F2, trunk B1, Bmid and the
    head's B1, on the tensor cores in 3xTF32), and x, the parameters, the
    pooled output, the statistics and every gradient once."""
    x, w1, _, _, _, w2, _, _, _, w3 = args[:10]
    m = x.shape[0] * x.shape[1]
    fma = 2 * m * w1.numel()
    tc = 3 * 2 * m * sum(w.numel() for w in (w1, w2, w3)) - fma
    params = sum(t.numel() for t in args[1:])
    nbytes = 4 * (2 * x.numel() + 2 * params + x.shape[0] * w3.shape[1]
                  + 2 * sum(w.shape[1] for w in (w1, w2, w3)))
    return fma, tc, nbytes


def adv_pt_timing(card, rec, slice_out, results):
    """Phase 20: each new kernel against its plain version, with its
    bound, and the D's chain also against disc_fused's forward (the D's
    other forward kernel) on the same inputs; the config-4 step at N=2500
    under the switch and off it, in turns (one synchronized step per call
    in fp32; the bench step through ``train_steps_scan`` at K=8)."""
    from adversarial_learning_on_pointclouds_tpu_torch.ops import dispatch
    from adversarial_learning_on_pointclouds_tpu_torch.ops.kernels import (
        disc_fused, shared_mlp as sm, trunk_train as tt,
    )
    from adversarial_learning_on_pointclouds_tpu_torch.train import (
        adversarial,
    )

    tag = "adv-pallas-timing"
    (probs, ws, bs, ones), stack_launches = slice_out["stack"]
    call = (probs, ws, bs, ones, D_ACTS)
    with torch.no_grad():
        ms, plain_ms = time_pair(lambda: sm.fused_mlp_stack(*call),
                                 lambda: sm.fused_mlp_stack_plain(*call))
        dev_ms = sum(device_profile(lambda: sm.fused_mlp_stack(*call))
                     .values())
        stack_ms, disc_ms = time_pair(
            lambda: sm.fused_mlp_stack(*call),
            lambda: disc_fused.disc_forward(probs, ws, bs))
    bound_ms, bound_by = bound(*work(sm.fused_mlp_stack_plain, [call]))
    phase(tag, f"{card}: fused_mlp_stack (the D's chain) B={B} N={N}: "
          f"kernel {ms:.4f} ms (device {dev_ms:.4f}), plain {plain_ms:.4f} "
          f"ms, bound {bound_ms:.4f} ms ({bound_by}); in turns with "
          f"disc_fused's forward under no_grad: fused_mlp_stack "
          f"{stack_ms:.4f} ms, disc_fused fwd {disc_ms:.4f} ms")
    results.append({
        "name": "fused_mlp_stack", "route": "cuda",
        "source": f"{KERNELS_ROOT}/csrc/mlp_stack.cu",
        "replaces": f"{TPU_KERNELS}/{STACK_SITE}",
        "launches": stack_launches,
        "max_abs_err": rec.err[("fused_mlp_stack", "fwd")], "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None, "device_ms": dev_ms,
        "turns_ms": stack_ms, "disc_fused_fwd_turns_ms": disc_ms,
        "times": f"per D inference at B={B} N={N}"})

    args, t3_launches = slice_out["trunk3"]

    def kernel():
        fwd_bwd(tt.trunk3_train, args)

    def plain():
        fwd_bwd(tt.trunk3_train_reference, args)

    ms, plain_ms = time_pair(kernel, plain)
    dev_ms = sum(device_profile(kernel).values())
    fma, tc, nbytes = trunk3_work(args)
    t_ops, t_bytes = fma / FP32_PEAK + tc / TF32X3_PEAK, nbytes / HBM_RATE
    bound_ms = max(t_ops, t_bytes) * 1e3
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    fma_ms = bound(fma + tc, nbytes)[0]
    phase(tag, f"{card}: trunk3_train forward + backward B={B} "
          f"N={TRAIN_RAGGED_N} c_in=3: kernels {ms:.4f} ms (device "
          f"{dev_ms:.4f}), plain reference {plain_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}; {tc / 1e9:.2f} of "
          f"{(fma + tc) / 1e9:.2f} GFLOP at the 3xTF32 rate, all at the "
          f"fp32 FMA rate {fma_ms:.4f} ms)")
    results.append({
        "name": "trunk3_train", "route": "cuda",
        "source": f"{KERNELS_ROOT}/csrc/trunk_train.cu",
        "sources": [f"{KERNELS_ROOT}/csrc/trunk_train.cu",
                    f"{KERNELS_ROOT}/csrc/seg_head_train.cu",
                    f"{KERNELS_ROOT}/csrc/train_bwd_tc.cu"],
        "replaces": f"{TPU_KERNELS}/{TRUNK3_SITE}", "launches": t3_launches,
        "max_abs_err": max(v for (kern, _), v in rec.err.items()
                           if kern == "trunk3_train"),
        "bf16_max_abs_err": max(v for (kern, _), v in rec.err.items()
                                if kern == "trunk3_train bf16"),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "bound_fma_ms": fma_ms, "library_ms": None,
        "device_ms": dev_ms,
        "times": f"per forward + backward at B={B} N={TRAIN_RAGGED_N} "
                 "c_in=3 (six passes)"})

    cfg, setup, batch, txs, _ = slice_out["fp32"]
    states = {s: adversarial.create_state(
        cfg, 100, device="cuda", g_model=copy.deepcopy(setup[0]),
        d_model=copy.deepcopy(setup[1])) for s in (False, True)}
    for switch in (False, True, True, False):
        with dispatch.use_pallas_train(switch):
            time_step(card, f"{tag} N={TRAIN_RAGGED_N} "
                      f"{'under' if switch else 'off'} the switch", cfg,
                      states[switch], batch, txs)
    bcfg, bsetup, batch_k, btxs, _ = slice_out["bench"]
    states = {s: adversarial.create_state(
        bcfg, 100, device="cuda", g_model=copy.deepcopy(bsetup[0]),
        d_model=copy.deepcopy(bsetup[1])) for s in (False, True)}
    for switch in (False, True, True, False):
        with dispatch.use_pallas_train(switch):
            time_scan(card, f"bench step N={TRAIN_RAGGED_N} "
                      f"{'under' if switch else 'off'} the switch", bcfg,
                      states[switch], batch_k, btxs)


# Phase 21: the runners of configs 3 and 4 end to end on a synthetic
# pts fixture (704 shapes of 2048 points: 528 train, 88 test).
RUNNER_SHAPES = 704
RUNNER_BUDGET_S = 120.0
SERVE_PER_FORWARD = {"fused_linear_affine_act": 1, "fused_stack_maxpool": 3,
                     "seg_head_fused": 1}
RESUME_RTOL = 1e-5    # a resumed epoch's per-step losses (card, in turn)
HOST_DATA_RTOL = 1e-6  # --host_data against device pools
EVAL_CPU_ATOL = 1e-3   # instance mIoU and each category's, card vs CPU
EVAL_CPU_SHAPES = 2    # shapes whose IoU may differ, card vs CPU


def serve_wrappers():
    from adversarial_learning_on_pointclouds_tpu_torch.ops.kernels import (
        encoder_fused, shared_mlp,
    )
    return {"fused_linear_affine_act": shared_mlp.fused_linear_affine_act,
            "fused_stack_maxpool": encoder_fused.fused_stack_maxpool,
            "seg_head_fused": encoder_fused.seg_head_fused}


def read_csv(path):
    import csv

    with open(path) as f:
        return list(csv.DictReader(f))


def step_losses(out_dir, name, key):
    return [(int(r["step"]), float(r[key]))
            for r in read_csv(os.path.join(out_dir, f"{name}_metrics.csv"))]


def check_losses(tag, got, ref, rtol):
    if [s for s, _ in got] != [s for s, _ in ref]:
        raise AssertionError(f"{tag}: steps {[s for s, _ in got]} != "
                             f"{[s for s, _ in ref]}")
    worst = max(abs(g - r) / max(abs(r), 1e-12)
                for (_, g), (_, r) in zip(got, ref))
    phase("runner", f"{tag}: {len(got)} per-step losses, max relative "
          f"difference {worst:.3e} (bound {rtol:g})")
    if not worst <= rtol:
        raise AssertionError(f"{tag}: losses differ by {worst:.3e}")


def counted_run(run, cfg, counters, wrappers):
    """``run(cfg)`` on the card with every count set to 0 just before and
    read just after: ``(result, training launches, serving launches)``."""
    reset(counters)
    for w in wrappers.values():
        w.launches = 0
    result = run(cfg, device="cuda")
    torch.cuda.synchronize()
    return result, read(counters), {k: w.launches
                                    for k, w in wrappers.items()}


def check_run_launches(tag, train, serve, steps, per_step, forwards):
    for k, passes in per_step.items():
        for p, per in passes.items():
            if train[k][p] != per * steps:
                raise AssertionError(
                    f"{tag}: {k} {p} launched {train[k][p]} times in "
                    f"{steps} steps, expected {per} a step")
    for k, per in SERVE_PER_FORWARD.items():
        if serve[k] != per * forwards:
            raise AssertionError(f"{tag}: {k} launched {serve[k]} times in "
                                 f"{forwards} eval forwards, expected {per} "
                                 "a forward")
    phase("runner", f"{tag}: launches over {steps} steps and {forwards} "
          f"eval forwards: training {train}; serving {serve}")


class EpochProfile:
    """Wraps ``runner._single_net_epoch``: the epoch ``epoch`` runs inside
    one torch.profiler window (device activity only) between two
    synchronizations; keeps its wall time and the device's busy time."""

    def __init__(self, runner_mod, epoch):
        self.mod, self.epoch, self.fn = runner_mod, epoch, \
            runner_mod._single_net_epoch
        self.wall = self.busy = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        def wrapped(cfg, mod, state, tx, epoch, *a, **k):
            if epoch != self.epoch:
                return self.fn(cfg, mod, state, tx, epoch, *a, **k)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA],
                         acc_events=True) as prof:
                t0 = time.perf_counter()
                out = self.fn(cfg, mod, state, tx, epoch, *a, **k)
                torch.cuda.synchronize()
                self.wall = time.perf_counter() - t0
            self.busy = sum(_device_us(e) * 1e-6 for e in prof.key_averages()
                            if _device_us(e) > 0)
            return out
        self.mod._single_net_epoch = wrapped
        return self

    def __exit__(self, *exc):
        self.mod._single_net_epoch = self.fn


def ious_and_logp(model, x, y, c, batch):
    """Per-shape IoUs (eval_scan) and log-probs of ``model`` on its device
    over the test split, as numpy."""
    from adversarial_learning_on_pointclouds_tpu_torch import eval as ev
    from adversarial_learning_on_pointclouds_tpu_torch.train import segment

    dev = next(model.parameters()).device
    pools = [torch.from_numpy(a).to(dev) for a in (x, y, c)]
    idx, mask = ev._eval_indices(len(x), batch)
    ious = segment.eval_scan(model, *pools, idx)["ious"].cpu().numpy()
    with segment.eval_mode(model):
        logp = torch.cat([model(pools[0][s:s + batch])[0].cpu()
                          for s in range(0, len(x), batch)]).numpy()
    return ious.reshape(-1)[mask], logp


def eval_on_cpu(cfg, seg_out, gpu_model, test, ev_gpu):
    """Check 2: the epoch-1 checkpoint evaluated on the CPU against the
    card's eval of the same weights."""
    from adversarial_learning_on_pointclouds_tpu_torch import eval as ev
    from adversarial_learning_on_pointclouds_tpu_torch.train import segment
    from adversarial_learning_on_pointclouds_tpu_torch.utils import (
        checkpoint,
    )

    x, y, c = test
    cpu = segment.create_state(cfg, 1, device="cpu")
    checkpoint.load_params_only(seg_out, cpu, step=1)
    t0 = time.perf_counter()
    summary, table = ev.evaluate_segmenter_device(
        cpu.model, *(torch.from_numpy(a) for a in test), y, c,
        cfg.batch_size)
    cpu_s = time.perf_counter() - t0
    ev_summary, ev_table = ev_gpu
    diffs = [abs(summary["instance_miou"] - ev_summary["instance_miou"])] + [
        abs(table[k] - ev_table[k]) for k in ev_table]
    if table.keys() != ev_table.keys():
        raise AssertionError("per-category tables list other categories")
    iou_g, logp_g = ious_and_logp(gpu_model, x, y, c, cfg.batch_size)
    iou_c, logp_c = ious_and_logp(cpu.model, x, y, c, cfg.batch_size)
    differ = np.nonzero(iou_g != iou_c)[0]
    arg_g, arg_c = logp_g.argmax(-1), logp_c.argmax(-1)
    flips = np.nonzero(arg_g != arg_c)
    margin = (np.take_along_axis(logp_c, arg_c[..., None], -1)
              - np.take_along_axis(logp_c, arg_g[..., None], -1))[flips]
    scale = max(1.0, float(np.abs(logp_c).max()))
    phase("runner", f"epoch-1 checkpoint on the CPU ({cpu_s:.1f} s): "
          f"instance mIoU {summary['instance_miou']:.6f} against the card's "
          f"{ev_summary['instance_miou']:.6f}; max difference over the "
          f"mIoU and {len(table)} categories {max(diffs):.3e} (bound "
          f"{EVAL_CPU_ATOL:g}); {len(differ)} of {len(x)} shapes' IoUs "
          f"differ (at most {EVAL_CPU_SHAPES}); {len(flips[0])} of "
          f"{arg_c.size} argmax differ, largest CPU top-2 margin there "
          f"{margin.max() if len(margin) else 0.0:.3e}")
    if max(diffs) > EVAL_CPU_ATOL or len(differ) > EVAL_CPU_SHAPES:
        raise AssertionError("the card's eval differs from the CPU's")
    if len(flips[0]) and margin.max() >= BOUND * scale:
        raise AssertionError(f"argmax differs at a top-2 margin of "
                             f"{margin.max():.3e}")
    flip_shapes = set(flips[0].tolist())
    if not set(differ.tolist()) <= flip_shapes:
        raise AssertionError("a shape's IoU differs without an argmax flip")


def eval_pass_times(card, model, test, reps=5):
    """The runner's eval pass (``evaluate_segmenter_device`` over the
    test split) on the card: host-clock ms a pass over synchronized
    passes, and its device time by kernel (torch.profiler)."""
    from adversarial_learning_on_pointclouds_tpu_torch import eval as ev

    x, y, c = test
    pools = [torch.from_numpy(a).cuda() for a in test]

    def one():
        ev.evaluate_segmenter_device(model, *pools, y, c, B)

    one()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        one()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / reps * 1e3
    per = device_profile(one, reps=reps)
    busy = sum(per.values())
    top = sorted(per.items(), key=lambda kv: -kv[1])[:3]
    phase("runner", f"{card}: eval pass of {len(x)} shapes (B={B}, "
          f"{-(-len(x) // B)} forwards): {wall:.3f} ms host to host, "
          f"device busy {busy:.3f} ms ({1 - busy / wall:.1%} idle); "
          + "; ".join(f"{short_name(k)} {v:.3f}" for k, v in top))


def short_name(kernel: str) -> str:
    """A profiler kernel name without ``void`` and the namespaces."""
    return re.sub(r"^void |pointtpu::|\(anonymous namespace\)::", "",
                  kernel)[:32]


def runner_phase(dev, card):
    """Phase 21."""
    from adversarial_learning_on_pointclouds_tpu_torch import (
        eval_segmentation,
    )
    from adversarial_learning_on_pointclouds_tpu_torch.configs import (
        AdversarialConfig, SegmentConfig,
    )
    from adversarial_learning_on_pointclouds_tpu_torch.data.shapenet_part \
        import make_synthetic_shapenet
    from adversarial_learning_on_pointclouds_tpu_torch.train import (
        runner as runner_lib,
    )

    t_phase = time.perf_counter()
    counters, wrappers = adv_counters(), serve_wrappers()
    seg_want = {**PER_STEP, **PT_OFF,
                "disc_fused": {p: 0 for p in DISC_SITES},
                "augment_fused": {"fwd": 0}}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        root = make_synthetic_shapenet(os.path.join(tmp, "data"),
                                       RUNNER_SHAPES, TRAIN_N, seed=SEED)
        phase("runner", f"pts fixture of {RUNNER_SHAPES} shapes x {TRAIN_N} "
              f"points written in {time.perf_counter() - t0:.1f} s")
        base = SegmentConfig(batch_size=B, num_points=TRAIN_N, epochs=2,
                             dataset=root, quiet=True, feature_transform=True,
                             ckpt_policy="every", eval_every=1)

        # 1. run_segmentation, two epochs, device pools.
        seg_out = os.path.join(tmp, "seg")
        cfg = dataclasses.replace(base, out_dir=seg_out)
        out = io.StringIO()
        with redirect_stdout(out):
            result, train, serve = counted_run(
                runner_lib.run_segmentation, cfg, counters, wrappers)
        phase("runner", out.getvalue().strip().splitlines()[0])
        steps = result["state"].step
        spe = steps // 2
        rows = read_csv(os.path.join(seg_out, "seg_epochs.csv"))
        n_test = int(float(rows[0]["num_shapes"]))
        forwards = 2 * -(-n_test // B)
        check_run_launches("run_segmentation", train, serve, steps,
                           seg_want, forwards)
        for name, header in (("seg_metrics.csv", [
                "epoch", "batch", "step", "step_time_s",
                "points_per_sec_per_chip", "loss", "acc"]),
                ("seg_epochs.csv", [
                    "epoch", "instance_miou", "point_accuracy",
                    "num_shapes", "train_s", "eval_s", "ckpt_s"])):
            with open(os.path.join(seg_out, name)) as f:
                got = f.readline().strip().split(",")
            if got != header:
                raise AssertionError(f"{name} header {got} != {header}")
        losses = step_losses(seg_out, "seg", "loss")
        if [s for s, _ in losses] != list(range(1, steps + 1)) or \
                not np.isfinite([v for _, v in losses]).all():
            raise AssertionError(f"per-step losses: {losses}")
        if sorted(d for d in os.listdir(seg_out) if d.isdigit()) != ["0", "1"]:
            raise AssertionError(f"checkpoints: {os.listdir(seg_out)}")
        for r in rows:
            phase("runner", f"{card}: run_segmentation epoch {r['epoch']} "
                  f"(B={B} N={TRAIN_N}, {spe} steps, {n_test} test shapes): "
                  f"train_s {float(r['train_s']):.3f}, eval_s "
                  f"{float(r['eval_s']):.3f} ({n_test / float(r['eval_s']):.0f}"
                  f" shapes/s), ckpt_s {float(r['ckpt_s']):.3f}; instance "
                  f"mIoU {float(r['instance_miou']):.4f}, point accuracy "
                  f"{float(r['point_accuracy']):.4f}")

        # 2. the same eval on the CPU from the epoch-1 checkpoint; the
        # card's eval pass timed alone first.
        with redirect_stdout(io.StringIO()):
            (_, _, _), test = runner_lib._shapenet_arrays(cfg)
        eval_pass_times(card, result["state"].model, test)
        ev_gpu = ({k: float(rows[1][k]) for k in ("instance_miou",)},
                  result["category_miou"])
        eval_on_cpu(cfg, seg_out, result["state"].model, test, ev_gpu)

        # 3. --resume_full from the epoch-0 checkpoint runs epoch 1 again,
        # in one torch.profiler window (the host's share of an epoch).
        first = os.path.join(tmp, "first")
        os.makedirs(first)
        os.rename(os.path.join(seg_out, "0"), os.path.join(first, "0"))
        res_out = os.path.join(tmp, "resumed")
        with EpochProfile(runner_lib, 1) as prof, \
                redirect_stdout(io.StringIO()):
            resumed = runner_lib.run_segmentation(dataclasses.replace(
                base, out_dir=res_out, resume=first, resume_full=True),
                device="cuda")
        check_losses("--resume_full from epoch 0, epoch 1 again",
                     step_losses(res_out, "seg", "loss"), losses[spe:],
                     RESUME_RTOL)
        if resumed["state"].step != steps:
            raise AssertionError("the resumed run's step count")
        phase("runner", f"{card}: epoch 1 again in one torch.profiler "
              f"window (device activity only): wall {prof.wall:.3f} s, "
              f"device busy {prof.busy:.3f} s, the host's share "
              f"{1 - prof.busy / prof.wall:.1%} ({spe} steps, "
              f"{prof.wall / spe * 1e3:.2f} ms a step)")

        # 4. --host_data against device pools (epoch 0).
        host_out = os.path.join(tmp, "host")
        with redirect_stdout(io.StringIO()):
            runner_lib.run_segmentation(dataclasses.replace(
                base, out_dir=host_out, epochs=1, device_data=False),
                device="cuda")
        check_losses("--host_data against device pools, epoch 0",
                     step_losses(host_out, "seg", "loss"), losses[:spe],
                     HOST_DATA_RTOL)

        # 5. run_adversarial, one epoch with the bench flags.
        adv_out = os.path.join(tmp, "adv")
        acfg = AdversarialConfig(
            batch_size=B, num_points=TRAIN_N, epochs=1, dataset=root,
            quiet=True, feature_transform=True, out_dir=adv_out, augment=True,
            bf16=True, pallas_augment=True, paired_trunks=True,
            scan=BENCH_K)
        with redirect_stdout(io.StringIO()):
            t0 = time.perf_counter()
            adv, train, serve = counted_run(runner_lib.run_adversarial, acfg,
                                            counters, wrappers)
            adv_s = time.perf_counter() - t0
        adv_steps = adv["state"].step
        check_run_launches(
            "run_adversarial --bf16 --pallas_augment --paired_trunks "
            f"--scan {BENCH_K}", train, serve, adv_steps,
            {**ADV_PER_STEP, **PT_OFF, "trunk2_train": GROUPS2_PER_STEP,
             "augment_fused": {"fwd": AUG_PER_STEP}}, -(-n_test // B))
        adv_losses = [v for r in read_csv(os.path.join(
            adv_out, "adv_metrics.csv")) for k, v in r.items()
            if k.startswith("loss")]
        if not np.isfinite(np.asarray(adv_losses, float)).all():
            raise AssertionError("non-finite adversarial losses")
        arow = read_csv(os.path.join(adv_out, "adv_epochs.csv"))[0]
        phase("runner", f"{card}: run_adversarial (bench flags, K={BENCH_K})"
              f" epoch 0: {adv_steps} G+D steps, train_s "
              f"{float(arow['train_s']):.3f}, eval_s "
              f"{float(arow['eval_s']):.3f}, ckpt_s "
              f"{float(arow['ckpt_s']):.3f}; G's instance mIoU "
              f"{float(arow['instance_miou']):.4f}; {len(adv_losses)} losses "
              f"finite; the run {adv_s:.1f} s")

        # 6. the eval CLI on the seg run's directory (its epoch-1 ckpt).
        out = io.StringIO()
        with redirect_stdout(out):
            ev_cli, _ = eval_segmentation.main([
                "--model", seg_out, "--dataset", root, "--num_points",
                str(TRAIN_N)])
        last = float(rows[-1]["instance_miou"])
        line = [s for s in out.getvalue().splitlines()
                if s.startswith("instance mIoU")][0]
        phase("runner", f"eval_segmentation --model <seg run>: {line!r}; "
              f"the run's last eval {last:.6f}")
        if abs(ev_cli["instance_miou"] - last) > 1e-6 or \
                line != f"instance mIoU: {last:.4f}":
            raise AssertionError("the eval CLI does not reproduce the run")
    spent = time.perf_counter() - t_phase
    phase("runner", f"{card}: the runner phase took {spent:.1f} s (budget "
          f"{RUNNER_BUDGET_S:g} s)")
    if spent > RUNNER_BUDGET_S:
        raise AssertionError(f"the runner phase took {spent:.1f} s")


# Phase 22: the classification configs (1, 2 and 5) end to end.
CLS_N, CLASSES = 1024, 40
CLS_BUDGET_S = 90.0
# The runners' in-memory ModelNet40 fixture: a quarter of ModelNet40's
# 9,843 train and 2,468 test shapes, at its schema (2048 points a shape,
# 40 classes), so that the phase fits its budget on a slow host: 76
# steps an epoch at B=32, 20 eval forwards.
CLS_FIXTURE = (2461, 617)
# Launches of the classifier's train step: a trunk and a T-Net head per
# T-Net, the encoder's trunk; with the feature transform (config 2) one
# T-Net more; augment_fused once under --pallas_augment. Config 5's step
# launches the same in its update and nothing in its attack.
CLS_OFF = {**{k: {p: 0 for p in v} for k, v in ADV_PER_STEP.items()},
           **PT_OFF, "augment_fused": {"fwd": 0}}
# The sign-flip rule of the attack (card against CPU): where the CPU's
# input gradient is below this share of its largest element, sign() may
# flip by rounding; at most ATTACK_SHARE of the elements may be so
# exempted.
ATTACK_NEAR, ATTACK_SHARE = 1e-6, 1e-2


def cls_want(ft, aug=False):
    return {**CLS_OFF, "trunk2_train": {p: 2 + ft for p in ("F1", "F2",
                                                            "B1")},
            "pool_fc_epilogue": {"fwd": 1 + ft},
            "augment_fused": {"fwd": int(aug)}}


def cls_serve(ft):
    return {"fused_linear_affine_act": 1, "fused_stack_maxpool": 2 + ft,
            "seg_head_fused": 0}


class MaskReplay:
    """For one run, records the dropout masks (``core.dropout_mask``), or,
    given ``masks``, hands those out in order, on the caller's device,
    instead of drawing: the CPU's step takes the card's masks."""

    def __init__(self, masks=None):
        self.masks, self.seen = masks, []

    def __enter__(self):
        from adversarial_learning_on_pointclouds_tpu_torch.models import core

        self.core, self.fn = core, core.dropout_mask

        def wrapped(gen, shape, p, device):
            m = (self.fn(gen, shape, p, device) if self.masks is None
                 else self.masks[len(self.seen)].to(device))
            self.seen.append(m)
            return m
        core.dropout_mask = wrapped
        return self.seen

    def __exit__(self, *exc):
        self.core.dropout_mask = self.fn


class AttackLaunches:
    """Wraps ``attacks.attack`` for one run: every kernel's launches
    inside the attacks (their counts' growth across each call) and each
    call's clouds and perturbed clouds."""

    def __init__(self, counters, wrappers):
        from adversarial_learning_on_pointclouds_tpu_torch import attacks

        self.mod, self.fn = attacks, attacks.attack
        self.counters, self.wrappers = counters, wrappers
        self.launches, self.ins, self.outs = 0, [], []

    def _total(self):
        return (sum(f.launches for passes in self.counters.values()
                    for f in passes.values())
                + sum(w.launches for w in self.wrappers.values()))

    def __enter__(self):
        def wrapped(*a, **k):
            before = self._total()
            out = self.fn(*a, **k)
            self.launches += self._total() - before
            self.ins.append(a[1])
            self.outs.append(out)
            return out
        self.mod.attack = wrapped
        return self

    def __exit__(self, *exc):
        self.mod.attack = self.fn


def cls_setup(ft, gen, seed):
    """A seeded full-width classifier (random BatchNorm statistics) and a
    batch of B=32 clouds of N=1024 with class labels (numpy)."""
    from adversarial_learning_on_pointclouds_tpu_torch.models import (
        PointNetCls,
    )

    model = PointNetCls(CLASSES, ft, generator=gen)
    randomize_bn(model, gen)
    rng = np.random.default_rng(seed)
    pts = (rng.normal(size=(B, CLS_N, 3)) * rng.uniform(0.5, 2.0, (B, 1, 3))
           ).astype(np.float32)
    return model, pts, rng.integers(0, CLASSES, B).astype(np.int64)


def cls_step_runs(mod, cfg, model, pts, labels, wheres=("cuda", "cpu"),
                  masks=None):
    """One ``mod.train_step`` (``classify``) per device from the same
    weights and batch, with the dropout masks ``masks`` where given (the
    CPU's with the card's): ``({where: (state, metrics, train log-probs,
    tx, batch)}, (the card's launches, its serving kernels' launches),
    the masks)``, the counts set to 0 just before the card's step and
    read just after."""
    counters, wrappers = adv_counters(), serve_wrappers()
    runs, launches = {}, None
    for where in wheres:
        m = copy.deepcopy(model)
        logps = []
        m.register_forward_hook(lambda mod_, inp, out: logps.append(
            out[0].detach()))
        state = mod.create_state(cfg, 100, device=where, model=m)
        tx = mod.make_tx(cfg, 100)
        x = torch.from_numpy(pts).to(where)
        y = torch.from_numpy(labels).to(where)
        reset(counters)
        for w in wrappers.values():
            w.launches = 0
        with MaskReplay(masks) as seen:
            metrics = mod.train_step(state, x, y, cfg=cfg, tx=tx)
        if where == "cuda":
            torch.cuda.synchronize()
            launches = (read(counters),
                        {k: w.launches for k, w in wrappers.items()})
            masks = [t.cpu() for t in seen]
        runs[where] = (state, metrics, logps[-1], tx, (x, y))
    return runs, launches, masks


def cls_compare(tag, runs, yard=None):
    """The card's classifier step against the CPU's: loss, accuracy, the
    train forward's log-probs, every new running statistic and every
    gradient; with ``yard`` (the CPU's step in fp32), each bound the
    larger of the fp32 one and ``YARD_FACTOR`` times what bf16 moves the
    CPU's."""
    gs, gm, glogp = runs["cuda"][:3]
    cs, cm, clogp = runs["cpu"][:3]

    def bound_for(cpu_val, yard_val, base):
        if yard_val is None:
            return base
        return max(base, YARD_FACTOR * rel_err(cpu_val, yard_val)[0])

    ys, ym, ylogp = yard[:3] if yard else (None, None, None)
    check("loss GPU vs CPU", gm["loss"].cpu()[None], cm["loss"][None],
          bound_for(cm["loss"][None], ym and ym["loss"][None], STEP_BOUND),
          tag)
    check("log-probs GPU vs CPU", glogp.cpu(), clogp,
          bound_for(clogp, ylogp, STEP_BOUND), tag)
    gsd, csd = gs.model.state_dict(), cs.model.state_dict()
    ysd = ys.model.state_dict() if ys else {}
    stats = [k for k in csd if k.endswith(("running_mean", "running_var"))]
    worst = max(rel_err(gsd[k].cpu(), csd[k])[0] for k in stats)
    sbound = max(bound_for(csd[k], ysd.get(k), STEP_BOUND) for k in stats)
    phase(tag, f"{len(stats)} new running statistics GPU vs CPU: max "
          f"scale-relative error {worst:.3e} (bound {sbound:.3g})")
    if worst > sbound or any(int(v) != 1 for k, v in gsd.items()
                             if k.endswith("num_batches_tracked")):
        raise AssertionError("running statistics differ")
    gp = dict(gs.model.named_parameters())
    cp = dict(cs.model.named_parameters())
    scale = max(float(p.grad.abs().max()) for p in cp.values())
    worst, name = max((float((gp[k].grad.cpu() - p.grad).abs().max()), k)
                      for k, p in cp.items())
    gbound = GRAD_BOUND
    if ys:
        yp = dict(ys.model.named_parameters())
        moved = max(float((yp[k].grad - p.grad).abs().max())
                    for k, p in cp.items())
        gbound = max(GRAD_BOUND, YARD_FACTOR * moved / (1 + scale))
        phase(tag, f"bf16 rounding moves the CPU's gradients by "
              f"{moved / (1 + scale):.3e} of (1 + max|g|)")
    phase(tag, f"{len(cp)} parameter gradients GPU vs CPU: max abs error "
          f"{worst:.3e} ({name}), {worst / (1 + scale):.3e} of (1 + max|g| "
          f"= {1 + scale:.3e}) (bound {gbound:.3g})")
    if worst > gbound * (1 + scale):
        raise AssertionError("gradients differ")


class PoolTops:
    """For one run, wraps the eval stacks' plain version (what the attacks
    run, ``differentiable_eval``): each call returns the port's own
    result, and a detached side computation of the same stack keeps each
    pool's top two values and points per channel (``[B, 2, C]`` each)."""

    def __enter__(self):
        from adversarial_learning_on_pointclouds_tpu_torch.models import core
        from adversarial_learning_on_pointclouds_tpu_torch.ops.kernels import (
            encoder_fused,
        )

        self.mod, self.fn, self.seen = encoder_fused, \
            encoder_fused.fused_stack_maxpool_plain, []

        def plain(x, weights, shifts, scales, acts, bf16=False):
            with torch.no_grad():
                h = x
                for w, sh, sc, act in zip(weights, shifts, scales, acts):
                    z = torch.matmul(core.operand(h, bf16),
                                     core.operand(w, bf16))
                    h = core.activation(z * sc + sh, act)
                top = h.topk(2, dim=1)
            self.seen.append((top.values.cpu(), top.indices.cpu()))
            return self.fn(x, weights, shifts, scales, acts, bf16)
        encoder_fused.fused_stack_maxpool_plain = plain
        return self.seen

    def __exit__(self, *exc):
        self.mod.fused_stack_maxpool_plain = self.fn


def winner_flips(card_tops, cpu_tops, shape):
    """The points to exempt where a pool's winner differs between the card
    and the CPU: both winners of each such channel, whose gradient goes to
    one point or the other. Each such channel's top two values must lie
    within rounding (``BOUND`` of the value) on the CPU. A channel whose
    top two are equal on both sides (all its points at 0 after a ReLU,
    say) is a tie, not a flip: the max's gradient is shared by the tied
    points alike on both sides. ``(exempt [B, N], channels that flipped,
    tied channels)``."""
    exempt = torch.zeros(shape, dtype=torch.bool)
    flips = ties = 0
    for (vg, ig), (vc, ic) in zip(card_tops, cpu_tops):
        tie = (vg[:, 0] == vg[:, 1]) & (vc[:, 0] == vc[:, 1])
        ties += int(tie.sum())
        differ = (ig[:, 0] != ic[:, 0]) & ~tie
        b, c = differ.nonzero(as_tuple=True)
        margin = (vc[:, 0] - vc[:, 1])[b, c]
        if len(b) and (margin >= BOUND * vc[:, 0][b, c].abs().clamp(
                min=1.0)).any():
            raise AssertionError(f"a max-pool winner differs at a top-2 "
                                 f"margin of {float(margin.max()):.3e}")
        exempt[b, ig[:, 0][b, c]] = True
        exempt[b, ic[:, 0][b, c]] = True
        flips += len(b)
    return exempt, flips, ties


def adv_step_check(tag, cfg, model, pts, labels):
    """Config 5's step on the card against the CPU, step by step on the
    card's own operands: at each attack iterate the CPU's input gradient
    at the card's cloud (each element within ``BOUND`` of the largest,
    but at the two points of a max-pool channel whose winner differs
    within rounding) and the CPU's next cloud from it (equal to the
    card's but where the CPU's gradient is below ``ATTACK_NEAR`` of its
    largest element, at most ``ATTACK_SHARE`` of them, or at such a
    point); then the update on the card's perturbed clouds and dropout
    masks. Every kernel's launches in the step and inside its attack.
    Returns the card's ``(state, batch, tx)``."""
    from adversarial_learning_on_pointclouds_tpu_torch import attacks, losses
    from adversarial_learning_on_pointclouds_tpu_torch.train import (
        adv_perturb, classify,
    )

    counters, wrappers = adv_counters(), serve_wrappers()
    runs, logps = {}, {"cuda": [], "cpu": []}
    m = copy.deepcopy(model)
    m.register_forward_hook(lambda mod_, inp, out: logps["cuda"].append(
        out[0].detach()))
    state = adv_perturb.create_state(cfg, 100, device="cuda", model=m)
    tx = adv_perturb.make_tx(cfg, 100)
    x, y = torch.from_numpy(pts).cuda(), torch.from_numpy(labels).cuda()
    reset(counters)
    for w in wrappers.values():
        w.launches = 0
    with MaskReplay() as masks, Recorder(attacks, "input_grad") as grads, \
            PoolTops() as card_tops, \
            AttackLaunches(counters, wrappers) as att:
        metrics = adv_perturb.train_step(state, x, y, cfg=cfg, tx=tx)
    torch.cuda.synchronize()
    train, serve = read(counters), {k: w.launches
                                    for k, w in wrappers.items()}
    check_launches(tag, train, cls_want(False))
    phase(tag, f"launches inside the attack: {att.launches}; serving "
          f"kernels in the step: {serve}")
    if att.launches or any(serve.values()) or len(att.outs) != 1:
        raise AssertionError("a kernel launched inside the attack")
    runs["cuda"] = (state, metrics, logps["cuda"][-1])

    cm = copy.deepcopy(model).eval()   # the weights the attack saw
    yc = torch.from_numpy(labels)

    def loss(xx):
        return losses.nll_loss(cm(xx)[0], yc)

    steps = len(grads)
    alpha = cfg.epsilon / steps if cfg.attack == "pgd" else cfg.epsilon
    x0 = att.ins[0].cpu()
    nexts = [a[1].cpu() for a, _ in grads[1:]] + [att.outs[0].cpu()]
    per = len(card_tops) // steps
    for i, ((a, g_card), nxt) in enumerate(zip(grads, nexts)):
        xi = a[1].cpu()
        with PoolTops() as cpu_tops:
            g = attacks.input_grad(loss, xi)
        exempt, flips, ties = winner_flips(
            card_tops[per * i:per * (i + 1)], cpu_tops, xi.shape[:2])
        scale = float(g.abs().max())
        err = (g_card.cpu() - g).abs()
        worst = float(err[~exempt].max()) / scale
        near = (g.abs() < ATTACK_NEAR * scale) & (g != 0)
        want = xi + alpha * torch.sign(g)
        if cfg.attack == "pgd":
            want = x0 + torch.clamp(want - x0, -cfg.epsilon, cfg.epsilon)
        differ = nxt != want
        far = int((differ & ~near & ~exempt[..., None]).sum())
        phase(tag, f"attack iterate {i}: input gradient GPU vs CPU at the "
              f"card's cloud: max error {worst:.3e} of max|g| {scale:.3e} "
              f"(bound {BOUND:g}) off {int(exempt.sum())} points of "
              f"{flips} max-pool winner flips ({ties} tied channels); "
              f"next cloud: "
              f"{int(near.sum())} of {near.numel()} elements near a zero "
              f"gradient ({float(near.float().mean()):.2e}, at most "
              f"{ATTACK_SHARE:g}), {int((differ & near).sum())} of them "
              f"flipped; {far} differ elsewhere (must be 0)")
        if worst > BOUND or far or \
                float(near.float().mean()) > ATTACK_SHARE:
            raise AssertionError(f"{tag}: the attack differs from the CPU's")
    ball = float((nexts[-1] - x0).abs().max())
    phase(tag, f"max |x_adv - x| {ball:.7f} (eps {cfg.epsilon:g})")
    if ball > cfg.epsilon + 1e-6 * float(x0.abs().max()):
        raise AssertionError("x_adv left the L-inf ball")

    cmod = copy.deepcopy(model)
    cmod.register_forward_hook(lambda mod_, inp, out: logps["cpu"].append(
        out[0].detach()))
    cs = classify.create_state(cfg, 100, device="cpu", model=cmod)
    with MaskReplay([t.cpu() for t in masks]):
        cmet = classify.update(cs, nexts[-1], yc, cfg)
    runs["cpu"] = (cs, cmet, logps["cpu"][-1])
    cls_compare(tag, runs)
    return state, (x, y), tx


def time_cls_step(card, tag, mod, cfg, state, batch, tx):
    """Synchronized ``mod.train_step`` calls: the median of 12 (CUDA
    events, after 3 warm-ups), points/s, and the profiler's kernel time
    over 5 steps (the idle share)."""
    def step():
        mod.train_step(state, *batch, cfg=cfg, tx=tx)

    for _ in range(3):
        step()
    ms = statistics.median(event_ms(step, 12))
    busy = sum(device_profile(step, reps=5).values())
    pts = cfg.batch_size * cfg.num_points
    phase(tag, f"{card}: {tag} train_step B={cfg.batch_size} "
          f"N={cfg.num_points}: median {ms:.3f} ms over 12 steps, "
          f"{pts / ms * 1e3:.1f} points/s; GPU kernels busy {busy:.3f} ms "
          f"({100 * (1 - busy / ms):.1f}% idle)")
    return {"step_ms": ms, "busy_ms": busy, "points_per_s": pts / ms * 1e3}


def cls_steps(card, gen):
    """Configs 1 and 2 (fp32 and bf16) and config 5 (FGSM, PGD-3) at
    B=32 N=1024, card against CPU; launches per step."""
    from adversarial_learning_on_pointclouds_tpu_torch.configs import (
        AdvPerturbConfig, ClassifyConfig,
    )
    from adversarial_learning_on_pointclouds_tpu_torch.train import (
        adv_perturb, classify,
    )

    times = {}
    for ft in (False, True):
        model, pts, labels = cls_setup(ft, gen, SEED + 3)
        fp32 = None
        for bf16 in (False, True):
            cfg = ClassifyConfig(num_points=CLS_N, feature_transform=ft,
                                 augment=ft, pallas_augment=ft, bf16=bf16)
            tag = f"config {1 + ft}{' bf16' if bf16 else ''}"
            runs, (train, serve), masks = cls_step_runs(
                classify, cfg, model, pts, labels, masks=fp32 and fp32[1])
            check_launches(tag, train, cls_want(ft, ft))
            if any(serve.values()):
                raise AssertionError(f"serving kernels in a train step: "
                                     f"{serve}")
            yard = None
            if bf16:
                yard = cls_step_runs(classify, dataclasses.replace(
                    cfg, bf16=False), model, pts, labels, ("cpu",),
                    masks)[0]["cpu"]
            cls_compare(tag, runs, yard)
            state, _, _, tx, batch = runs["cuda"]
            if not bf16:
                fp32 = (runs, masks)
                losses = [float(classify.train_step(
                    state, *batch, cfg=cfg, tx=tx)["loss"])
                    for _ in range(10)]
                phase(tag, f"10 more Adam steps on the fixed batch: loss "
                      f"{losses[0]:.5f} -> {losses[-1]:.5f}")
                if not np.isfinite(losses).all() or \
                        not losses[-1] < losses[0]:
                    raise AssertionError(f"the loss did not fall: {losses}")
            times[tag] = time_cls_step(card, tag, classify, cfg, state, batch,
                                       tx)
    model, pts, labels = cls_setup(False, gen, SEED + 4)
    for attack, steps in (("fgsm", 1), ("pgd", 3)):
        cfg = AdvPerturbConfig(num_points=CLS_N, attack=attack,
                               attack_steps=steps)
        tag = f"config 5 {attack.upper()}-{steps}"
        state, batch, tx = adv_step_check(tag, cfg, model, pts, labels)
        times[tag] = time_cls_step(card, tag, adv_perturb, cfg, state, batch,
                                   tx)
    # Outside the attack's context an eval forward that autograd records
    # still raises on the card (the eval kernels have no backward).
    m = copy.deepcopy(model).cuda().eval()
    try:
        m(torch.from_numpy(pts).cuda())
    except RuntimeError as e:
        if "no backward" not in str(e):
            raise
        phase("classify", f"a grad-enabled eval forward on the card outside "
              f"the attack raises: {str(e)[:60]}...")
    else:
        raise AssertionError("a grad-enabled eval forward ran on the card")
    return times


def cls_eval_and_infer(card, gen):
    """The classifier's eval forward (configs 1 and 2) at B=32 N=1024,
    card against CPU, its launches and time; ``infer --model cls`` from a
    saved ``.pth`` (one ``.pts`` cloud, card against CPU) and
    ``Predictor.predict`` over the 32 clouds."""
    from adversarial_learning_on_pointclouds_tpu_torch import infer

    wrappers = serve_wrappers()
    out = {}
    for ft in (False, True):
        model, pts, _ = cls_setup(ft, gen, SEED + 5)
        gm = copy.deepcopy(model).cuda()
        x = torch.from_numpy(pts)
        with torch.inference_mode():
            ref = model(x)[0]
            for w in wrappers.values():
                w.launches = 0
            got = gm(x.cuda())[0]
            torch.cuda.synchronize()
            seen = {k: w.launches for k, w in wrappers.items()}
            xc = x.cuda()
            ms = statistics.median(event_ms(lambda: gm(xc), REPS))
        tag = f"config {1 + ft} eval"
        check("eval log-probs GPU vs CPU", got.cpu(), ref, BOUND, tag)
        if seen != cls_serve(ft):
            raise AssertionError(f"eval forward launches {seen}, expected "
                                 f"{cls_serve(ft)}")
        out[tag] = {"ms": ms, "shapes_per_s": B / ms * 1e3}
        phase(tag, f"{card}: eval forward B={B} N={CLS_N}: {ms:.3f} ms "
              f"({B / ms * 1e3:.0f} shapes/s); launches {seen}")
    with tempfile.TemporaryDirectory() as tmp:
        pth = os.path.join(tmp, "cls.pth")
        torch.save(model.state_dict(), pth)
        cloud = os.path.join(tmp, "shape.pts")
        np.savetxt(cloud, np.random.default_rng(SEED).normal(
            size=(1500, 3)), fmt="%.6f")
        lines = {}
        for dev in ("cuda", "cpu"):
            buf = io.StringIO()
            with redirect_stdout(buf):
                infer.main(["--checkpoint", pth, "--model", "cls",
                            "--feature_transform", "--input", cloud,
                            "--device", dev])
            lines[dev] = buf.getvalue()
        phase("classify", f"infer --model cls on the card: "
              f"{lines['cuda'].strip()!r}; on the CPU: "
              f"{lines['cpu'].strip()!r}")
        if lines["cuda"] != lines["cpu"] or \
                not lines["cuda"].startswith("cloud 0: class "):
            raise AssertionError("infer --model cls differs from the CPU")
        preds = {dev: infer.Predictor(pth, "cls", CLS_N, dev,
                                      feature_transform=True)
                 for dev in ("cuda", "cpu")}
    clouds = infer.prep(list(pts), CLS_N)
    for w in wrappers.values():
        w.launches = 0
    got = preds["cuda"].predict(clouds)
    seen = {k: w.launches for k, w in wrappers.items()}
    check("Predictor.predict GPU vs CPU", torch.from_numpy(got),
          torch.from_numpy(preds["cpu"].predict(clouds)), BOUND, "classify")
    if seen != cls_serve(True):
        raise AssertionError(f"Predictor launches {seen}")
    return out


def cls_runners(card):
    """``run_classification`` (config 2's flags) for two epochs and
    ``run_adv_perturb`` for one on the in-memory ModelNet40 fixture at
    ``CLS_FIXTURE``'s sizes, their launches; then ``eval_classification``
    and ``eval_robustness`` reproducing each run's last eval."""
    from adversarial_learning_on_pointclouds_tpu_torch import (
        eval_classification, eval_robustness,
    )
    from adversarial_learning_on_pointclouds_tpu_torch.configs import (
        AdvPerturbConfig, ClassifyConfig,
    )
    from adversarial_learning_on_pointclouds_tpu_torch.train import (
        runner as runner_lib,
    )

    from adversarial_learning_on_pointclouds_tpu_torch.data.modelnet40 import (
        synthetic_modelnet,
    )

    counters, wrappers = adv_counters(), serve_wrappers()
    out = {}
    # The runs and the eval CLIs all read the fixture at CLS_FIXTURE's
    # sizes (``_modelnet_arrays`` calls ``runner.synthetic_modelnet``).
    fixture = contextlib.ExitStack()
    fixture.callback(setattr, runner_lib, "synthetic_modelnet",
                     runner_lib.synthetic_modelnet)
    runner_lib.synthetic_modelnet = lambda: synthetic_modelnet(*CLS_FIXTURE)
    with fixture, tempfile.TemporaryDirectory() as tmp:
        for name, run, cfg, ft, epochs in (
                ("cls", runner_lib.run_classification, ClassifyConfig(
                    num_points=CLS_N, epochs=2, quiet=True,
                    feature_transform=True, augment=True,
                    out_dir=os.path.join(tmp, "cls")), True, 2),
                ("advp", runner_lib.run_adv_perturb, AdvPerturbConfig(
                    num_points=CLS_N, epochs=1, quiet=True,
                    out_dir=os.path.join(tmp, "advp")), False, 1)):
            buf = io.StringIO()
            with redirect_stdout(buf):
                result, train, serve = counted_run(run, cfg, counters,
                                                   wrappers)
            phase("classify", buf.getvalue().strip().splitlines()[0])
            steps = result["state"].step
            rows = read_csv(os.path.join(cfg.out_dir, f"{name}_epochs.csv"))
            n_test = int(float(rows[0]["num_examples"]))
            forwards = epochs * -(-n_test // B)
            for k, passes in cls_want(ft).items():
                for p, per in passes.items():
                    if train[k][p] != per * steps:
                        raise AssertionError(
                            f"{name}: {k} {p} launched {train[k][p]} times "
                            f"in {steps} steps, expected {per} a step")
            if serve != {k: v * forwards for k, v in cls_serve(ft).items()}:
                raise AssertionError(f"{name}: serving launches {serve} in "
                                     f"{forwards} eval forwards")
            losses = step_losses(cfg.out_dir, name, "loss")
            if [s for s, _ in losses] != list(range(1, steps + 1)) or \
                    not np.isfinite([v for _, v in losses]).all():
                raise AssertionError(f"{name}: per-step losses {losses}")
            for r in rows:
                phase("classify", f"{card}: {run.__name__} epoch "
                      f"{r['epoch']} (B={B} N={CLS_N}, {steps // epochs} "
                      f"steps, {n_test} test shapes): train_s "
                      f"{float(r['train_s']):.3f}, eval_s "
                      f"{float(r['eval_s']):.3f} ({n_test / float(r['eval_s']):.0f}"
                      f" shapes/s), ckpt_s {float(r['ckpt_s']):.3f}; accuracy "
                      f"{float(r['accuracy']):.4f}")
            phase("classify", f"{name}: launches over {steps} steps and "
                  f"{forwards} eval forwards: training {train}; serving "
                  f"{serve}")
            last = float(rows[-1]["accuracy"])
            with redirect_stdout(io.StringIO()):
                if name == "cls":
                    got = eval_classification.main(
                        ["--model", cfg.out_dir])["accuracy"]
                else:
                    accs = eval_robustness.main(
                        ["--model", cfg.out_dir, "--epsilons", "0",
                         "0.05"])
                    got = accs[0.0]
            if name != "cls":
                phase("classify", f"eval_robustness on the advp run: "
                      f"accuracy at eps 0 and 0.05 (FGSM): {accs}")
            phase("classify", f"{name}: the eval CLI's accuracy {got:.6f}, "
                  f"the run's last eval {last:.6f}")
            if got != last:
                raise AssertionError(f"{name}: the eval CLI does not "
                                     "reproduce the run")
            out[name] = [{k: float(r[k]) for k in ("train_s", "eval_s",
                                                   "ckpt_s")} for r in rows]
    return out


def classify_phase(dev, card):
    """Phase 22."""
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(SEED + 22)
    times = cls_steps(card, gen)
    times.update(cls_eval_and_infer(card, gen))
    times["runners"] = cls_runners(card)
    spent = time.perf_counter() - t0
    phase("classify", f"{card}: the classification phase took {spent:.1f} s "
          f"(budget {CLS_BUDGET_S:g} s)")
    if spent > CLS_BUDGET_S:
        raise AssertionError(f"the classification phase took {spent:.1f} s")
    return times


# ---------------------------------------------------------------------------
# The ablation controls and batching knobs (phase 23)
# ---------------------------------------------------------------------------

ABL_BUDGET_S = 90.0
# The knobs' steps card against CPU at 2 x B=32 x ABL_N (the sigma=0.30
# sweep's point count; fused_forward's batch of 2B=64 kept): the CPU's
# G+D step at N=2048 takes 17-25 s (H100 host, phases 10 and 13), and ten
# of them would hold the phase for minutes. The knobs' launch counts and
# times, and the disc passes at k=53, are taken at N=2048.
ABL_N = 512
KNOBS = ("supervised_only", "self_training", "d_geometry", "paired_conv1",
         "fused_forward")
CONTROLS = ("supervised_only", "self_training")
GEO_K = PARTS + 3     # D's input under --d_geometry: probabilities + xyz
NO_DISC = {"fwd": 0, "bwd_dx": 0, "bwd_dw": 0, "bwd": 0}
# Launches per G+D step: supervised_only runs G's one-stream passes and no
# D; self_training both streams and no D; fused_forward G's passes once at
# 2B, one frozen D pass (fwd + dx) at 2B, the reals' fwd and two dW.
KNOB_PER_STEP = {
    "supervised_only": {**PER_STEP, "disc_fused": NO_DISC},
    "self_training": {**ADV_PER_STEP, "disc_fused": NO_DISC},
    "d_geometry": ADV_PER_STEP,
    "paired_conv1": ADV_PER_STEP,
    "fused_forward": {**PER_STEP, "disc_fused": {
        "fwd": 2, "bwd_dx": 1, "bwd_dw": 2, "bwd": 0}},
}
ABL_TIMED = ("default", "paired_conv1", "fused_forward")
ABL_ROUNDS = 5


def geo_maps(gen, bsz, n, dev):
    """D's input under ``--d_geometry``: ``prob_maps`` with each point's
    coordinates (a cloud normalized to the unit sphere) appended,
    ``[bsz, n, 53]``; rows of 212 bytes, off every 16-byte boundary."""
    xyz = torch.randn(bsz, n, 3, generator=gen)
    xyz = xyz - xyz.mean(1, keepdim=True)
    xyz = xyz / xyz.norm(dim=-1).amax(1)[:, None, None]
    return torch.cat([prob_maps(gen, bsz, n, "cpu"), xyz], -1).to(dev)


def abl_disc_checks(dev, gen, rec, bf16=False):
    """The four disc passes at k=53 (``check_disc_fwd``, ``check_disc_dw``
    as phases 9 and 12: the plain twin, in fp32 the float64 control with
    TF32 controls that must fail, in bf16 the pass's own h4) at B=32 and
    the D step's 2B=64, N=2048."""
    ws, bs = disc_params(gen, dev, k=GEO_K)
    for bsz in (B, 2 * B):
        tag = f"k={GEO_K} B={bsz} N={TRAIN_N}"
        x = geo_maps(gen, bsz, TRAIN_N, dev)
        g = _r(gen, bsz, TRAIN_N, 1, scale=1.0, dev=dev)
        with torch.no_grad():
            h4p = pass_h4(x, ws, bs, True) if bf16 else None
            if bsz == B:
                check_disc_fwd(rec, tag, x, ws, bs, bf16, True, "ablation")
                check_disc_dw(rec, tag, x, g, ws, bs, bf16, True, True,
                              "ablation", h4p)
            check_disc_dw(rec, tag, x, g, ws, bs, bf16, False, True,
                          "ablation", h4p)
        torch.cuda.synchronize()


def d_untouched(tag, state, d_model, metrics):
    """Under an ablation control: D's parameters bit-equal to the ones it
    started from, no gradient, no Adam moment, its schedule not stepped,
    and ``loss_d`` 0."""
    for (name, p), p0 in zip(state.d_model.state_dict().items(),
                             d_model.state_dict().values()):
        if not torch.equal(p.cpu(), p0):
            raise AssertionError(f"{tag}: D's {name} changed")
    if any(p.grad is not None for p in state.d_model.parameters()):
        raise AssertionError(f"{tag}: D has a gradient")
    if state.d_optimizer.state or state.d_scheduler.last_epoch != 0:
        raise AssertionError(f"{tag}: D's optimizer or schedule stepped")
    if float(metrics["loss_d"]) != 0.0:
        raise AssertionError(f"{tag}: loss_d {float(metrics['loss_d'])}")
    phase(tag, "D untouched: parameters bit-equal, no gradient, no Adam "
          "moment, schedule at 0, loss_d 0")


def abl_steps(dev, gen):
    """Each knob's G+D step with the bench flags (``augment``,
    ``pallas_augment``) at 2 x B=32 x ABL_N, card against CPU from the
    same weights and batch: in fp32 at phase 10's bounds, and in bf16 at
    phase 13's (the fp32 CPU step the yardstick); launches per step; D
    untouched under the controls. Returns the d_geometry step's launches
    (fp32)."""
    from adversarial_learning_on_pointclouds_tpu_torch.configs import (
        AdversarialConfig,
    )

    out = {}
    for knob in KNOBS:
        cfg = AdversarialConfig(num_points=ABL_N, augment=True,
                                pallas_augment=True, **{knob: True})
        setup = adv_setup(cfg, gen, dev)
        want = {**KNOB_PER_STEP[knob], **PT_OFF,
                "augment_fused": {"fwd": AUG_PER_STEP}}
        yard = None
        for c in (cfg, dataclasses.replace(cfg, bf16=True)):
            tag = f"ablation {knob}" + (" bf16" if c.bf16 else "")
            runs, launches = step_runs(c, *setup, tag, dev)
            check_launches(tag, launches, want)
            compare_step(tag, runs, c, STEP_BOUND, GRAD_BOUND, yard)
            if knob in CONTROLS:
                d_untouched(tag, runs["cuda"][0], setup[1], runs["cuda"][1])
            yard = runs["cpu"]
            out.setdefault(knob, launches)
    return out["d_geometry"]


def abl_disc_entry(card, rec, rec_bf, launches):
    """The kernels line's entry of the disc passes at k=53: each pass's
    fp32 times and bound (3xTF32 rate) and its bf16 ones, per G+D step
    under ``--d_geometry`` (the full ``bwd`` per call, off the step)."""
    from adversarial_learning_on_pointclouds_tpu_torch.ops.kernels import (
        disc_fused as df,
    )

    passes = []
    for pas, fn in df.PASSES.items():
        plain = getattr(df, fn.__name__ + "_plain")
        per = ADV_PER_STEP["disc_fused"][pas] or 1
        key = ("disc_fused", pas)
        row = time_passes(card, rec, key, fn, plain, per, False,
                          TF32X3_PEAK, "ablation")
        bf = time_passes(card, rec_bf, key, fn, plain, per, True,
                         tag="ablation")
        passes.append({"pass": pas,
                       "replaces": f"{TPU_KERNELS}/{DISC_SITES[pas]}",
                       "launches": launches["disc_fused"][pas], **row,
                       **{f"bf16_{k}": v for k, v in bf.items()}})
    step = [p for p in passes if p["pass"] != "bwd"]
    entry = kernel_entry(f"disc_fused (d_geometry, k={GEO_K})", "disc_tc.cu",
                         DISC_SITES["fwd"],
                         sum(launches["disc_fused"].values()), step,
                         f"per G+D step under --d_geometry, k={GEO_K}")
    for k in ("ms", "plain_ms", "bound_ms", "device_ms", "plain_device_ms"):
        entry[f"bf16_{k}"] = sum(p[f"bf16_{k}"] for p in step)
    entry["passes"] = passes
    return entry


def abl_timing(card):
    """The bench step (``train_steps_scan`` at K=8, 2 x B=32 x N=2048,
    bf16, ``augment_fused``) by default, with ``paired_conv1`` and with
    ``fused_forward``, each from ``create_state``'s seeded weights, timed
    in turns (``ABL_ROUNDS`` rounds, CUDA events): per-step median and the
    idle share of one profiled call."""
    from adversarial_learning_on_pointclouds_tpu_torch.configs import (
        AdversarialConfig,
    )
    from adversarial_learning_on_pointclouds_tpu_torch.train import (
        adversarial,
    )

    rng = np.random.default_rng(SEED + 23)
    x_l, x_u = (torch.from_numpy(rng.normal(size=(BENCH_K, B, TRAIN_N, 3))
                                 .astype(np.float32)).cuda() for _ in range(2))
    y_l = torch.from_numpy(rng.integers(0, PARTS, (BENCH_K, B, TRAIN_N))
                           ).cuda()
    calls = {}
    for name in ABL_TIMED:
        cfg = AdversarialConfig(augment=True, bf16=True, pallas_augment=True,
                                **({} if name == "default" else {name: True}))
        state = adversarial.create_state(cfg, 100)
        txs = adversarial.make_txs(cfg, 100)
        calls[name] = (lambda s=state, c=cfg, t=txs:
                       adversarial.train_steps_scan(s, x_l, y_l, x_u, cfg=c,
                                                    g_tx=t[0], d_tx=t[1]))
        calls[name]()
    times = {name: [] for name in ABL_TIMED}
    for r in range(ABL_ROUNDS):
        for name in (ABL_TIMED if r % 2 == 0 else ABL_TIMED[::-1]):
            times[name] += event_ms(calls[name], 1)
    out = {}
    for name in ABL_TIMED:
        per = statistics.median(times[name]) / BENCH_K
        busy = sum(device_profile(calls[name], reps=1).values()) / BENCH_K
        out[name] = {"step_ms": per, "busy_ms": busy,
                     "idle": 1 - busy / per}
        phase("ablation", f"{card}: bench step ({name}): train_steps_scan "
              f"K={BENCH_K}, 2 x B={B} N={TRAIN_N}, {ABL_ROUNDS} calls in "
              f"turns: median {per:.3f} ms per step "
              f"({per / out['default']['step_ms']:.3f} x the default's), "
              f"GPU kernels busy {busy:.3f} ms ({100 * (1 - busy / per):.1f}"
              f"% idle)")
    return out


def abl_sweep(card):
    """``ablation_adversarial_gain --quick`` (1 seed, 2 epochs, 96 shapes,
    ratio 0.5) on the card, modes sup adv geo st, in a temporary
    directory: four runs, each a finite best mIoU in (0, 1], the artifact
    naming this card."""
    from adversarial_learning_on_pointclouds_tpu_torch import (
        ablation_adversarial_gain as abl,
    )

    prev = tempfile.tempdir
    with tempfile.TemporaryDirectory() as tmp:
        tempfile.tempdir = tmp
        buf = io.StringIO()
        try:
            t0 = time.perf_counter()
            with redirect_stdout(buf):
                art = abl.main(["--quick", "--modes", "sup", "adv", "geo",
                                "st", "--json", os.path.join(tmp, "q.json")])
            spent = time.perf_counter() - t0
        finally:
            tempfile.tempdir = prev
    runs = art["runs"]
    if ([r["mode"] for r in runs] != ["sup", "adv", "geo", "st"]
            or not all(0 < r["best_miou"] <= 1 for r in runs)
            or art["device"] != card):
        raise AssertionError(f"the quick sweep: {art}")
    phase("ablation", f"{card}: ablation_adversarial_gain --quick on the "
          f"card, {spent:.1f} s: " + ", ".join(
              f"{r['mode']} {r['best_miou']:.4f} ({r['wall_s']} s)"
              for r in runs))
    return {r["mode"]: r["wall_s"] for r in runs}


def ablation_phase(dev, card, results=None):
    """Phase 23."""
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(SEED + 23)
    rec, rec_bf = PassRecord(), PassRecord(BF16_BOUND)
    abl_disc_checks(dev, gen, rec)
    abl_disc_checks(dev, gen, rec_bf, bf16=True)
    launches = abl_steps(dev, gen)
    entry = abl_disc_entry(card, rec, rec_bf, launches)
    abl_timing(card)
    abl_sweep(card)
    if results is not None:
        results.append(entry)
    spent = time.perf_counter() - t0
    phase("ablation", f"{card}: the ablation phase took {spent:.1f} s "
          f"(budget {ABL_BUDGET_S:g} s)")
    if spent > ABL_BUDGET_S:
        raise AssertionError(f"the ablation phase took {spent:.1f} s")


# Phase 24: serving artifacts (torch.export) and the eval kernels' bf16 mode.
SERVE_BUDGET_S = 60.0
SERVE_BATCHES = (1, 7, B)     # of the symbolic batch, each artifact
SERVE_SITES = {"fused_linear_affine_act": ("shared_mlp.cu", "shared_mlp.py:227"),
               "fused_stack_maxpool": ("encoder_fused.cu",
                                       "encoder_fused.py:109"),
               "seg_head_fused": ("encoder_fused.cu", "encoder_fused.py:182")}
# Launches per forward of a kernels artifact, counted on its replay: the
# segmenter (feature transform) conv1 1, stacks 3, head 1; the classifier
# (no feature transform) conv1 1, stacks 2.
ARTIFACT_PER_FORWARD = {
    "seg": {"fused_linear_affine_act": 1, "fused_stack_maxpool": 3,
            "seg_head_fused": 1},
    "cls": {"fused_linear_affine_act": 1, "fused_stack_maxpool": 2,
            "seg_head_fused": 0}}
# A fresh process that reloads artifacts: it imports torch and, for the
# kernels artifacts, the op registrations alone. It starts with the phase,
# reaches the card, loads each artifact once its ".done" marker appears,
# runs it at SERVE_BATCHES on the card (the portable ones also at b=1 on
# the CPU) and saves the log-probs and the port's modules it had imported
# once the artifacts were loaded.
RELOAD = r"""
import os, sys, time, torch
from torch.export.passes import move_to_device_pass
paths, inputs, out, ops = sys.argv[1:5]
if ops == "1":
    import adversarial_learning_on_pointclouds_tpu_torch.ops.serving_ops
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.zeros(1, device="cuda")
deadline = time.time() + 240
loaded = {}
for p in paths.split(","):
    while not os.path.exists(p + ".done"):
        if time.time() > deadline:
            raise SystemExit(p + " was never written")
        time.sleep(0.05)
    loaded[p] = torch.export.load(p)
mods = sorted(m for m in sys.modules
              if m.startswith("adversarial_learning_on_pointclouds_tpu"))
xs = torch.load(inputs)
res = {}
with torch.inference_mode():
    for p, ep in loaded.items():
        x = xs[os.path.basename(p).split("_")[0]]
        runs = [("cuda", b) for b in %s] + ([("cpu", 1)] if ops == "0" else [])
        for dev in dict(runs):
            m = move_to_device_pass(ep, dev).module()
            for d, b in runs:
                if d == dev:
                    res[(p, dev, b)] = m(x[:b].to(dev)).cpu()
torch.save({"res": res, "modules": mods}, out)
""" % (SERVE_BATCHES,)


def check_bf16(name, got, ref, tag="serving"):
    """An eval kernel's bf16 mode against its bf16 plain twin: both round
    the same operands to bf16 and sum in fp32, but where two fp32 sums of
    another order straddle a bf16 midpoint a hidden activation rounds one
    bf16 step apart (``check_stash``'s case): at most ``STASH_SHARE`` of
    the outputs beyond ``BOUND`` of the scale, and every one within
    ``BF16_BOUND`` of it. A missing rounding moves most outputs (fp32
    operands against the bf16 twin: 1e-2 to 0.8 of them, H100 80GB HBM3
    at 700 W). Returns ``(max abs error, share)``."""
    if got.shape != ref.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{name}: shape {tuple(got.shape)} against "
                             f"{tuple(ref.shape)}, or non-finite")
    rel, diff = rel_err(got, ref)
    scale = max(1.0, ref.abs().max().item())
    share = ((got.double() - ref.double()).abs() > BOUND * scale).double() \
        .mean().item()
    phase(tag, f"{name}: {share:.3e} of {ref.numel()} outputs beyond "
          f"{BOUND:g} of the scale (at most {STASH_SHARE:g}), max "
          f"scale-relative error {rel:.3e} (at most {BF16_BOUND:g})")
    if share > STASH_SHARE or rel > BF16_BOUND:
        raise AssertionError(f"{name}: differs from its bf16 twin")
    return diff, share


def bf16_control(name, fn, ref, tag="serving"):
    """The control that must fail ``check_bf16``: the bf16 kernel's output
    against the fp32 plain twin."""
    try:
        check_bf16(f"control: {name} against the fp32 twin", fn(), ref, tag)
    except AssertionError:
        phase(tag, "control: the fp32 twin fails the bf16 check, as it must")
        return
    raise AssertionError(f"{name}: the bf16 check passed the fp32 twin: it "
                         "does not see the bf16 rounding")


def serve_bf16_checks(card, gen, dev, results):
    """The three eval kernels' bf16 mode against their bf16 plain twins at
    B=32 N=2500, N=2047 and B=1 (phase 3's operands, the trunk also with
    negative folded scales in every other channel of its last layer), a
    control at the main shape; then their bf16 times (events and device),
    plain times and bounds at the main shape, into ``results``' entries
    (``bf16_*``)."""
    from adversarial_learning_on_pointclouds_tpu_torch.models import core
    from adversarial_learning_on_pointclouds_tpu_torch.ops.kernels import (
        encoder_fused as ef, shared_mlp as sm,
    )

    err = {k: 0.0 for k in SERVE_SITES}
    share = {k: 0.0 for k in SERVE_SITES}
    main = {}
    with torch.inference_mode(), core.mixed_precision():
        conv1, stack_params, head, w4, b4 = serve_params(gen, dev)
        for bsz, n in ((B, N), (B, RAGGED_N), (1, N)):
            tag = f"B={bsz} N={n} bf16"
            x3 = torch.randn(bsz, n, 3, generator=gen).to(dev)
            x64 = torch.relu(torch.randn(bsz, n, 64, generator=gen)).to(dev)
            g = torch.relu(torch.randn(bsz, 1024, generator=gen)).to(dev)
            calls = {"fused_linear_affine_act": [(x3, *conv1, "relu")],
                     "fused_stack_maxpool": [
                         (x3 if serve_stack(k)[0][0] == 3 else x64,
                          *zip(*layers), serve_stack(k)[1])
                         for k, layers in stack_params.items()],
                     "seg_head_fused": [(x64, g, *head[0], *head[1],
                                         *head[2], w4, b4)]}
            for name, args in calls.items():
                module = sm if name == "fused_linear_affine_act" else ef
                fn, plain = (getattr(module, name + t) for t in ("", "_plain"))
                for i, a in enumerate(args):
                    label = f"{name}{f' stack {i}' if len(args) > 1 else ''}"
                    d, sh = check_bf16(f"{label} {tag}", fn(*a),
                                       plain(*a, True))
                    err[name], share[name] = max(err[name], d), \
                        max(share[name], sh)
                if (bsz, n) == (B, N):
                    # A forward's calls: the three stacks of SERVE_STACKS,
                    # not the trunk again with negative scales.
                    main[name] = (fn, plain, args[:len(SERVE_STACKS)])
                    bf16_control(f"{name} {tag}", lambda: fn(*args[-1]),
                                 plain(*args[-1], False))
        out = {}
        for name, (fn, plain, args) in main.items():
            ms, plain_ms = time_pair(lambda: [fn(*a) for a in args],
                                     lambda: [plain(*a, True) for a in args])
            dev_ms = sum(device_profile(
                lambda: [fn(*a) for a in args]).values())
            flops, nbytes = work(plain, args)
            peak = FP32_PEAK if name == "fused_linear_affine_act" \
                else BF16_PEAK
            bound_ms, bound_by = bound(flops, nbytes, peak)
            out[name] = {"bf16_ms": ms, "bf16_plain_ms": plain_ms,
                         "bf16_bound_ms": bound_ms, "bf16_bound_by": bound_by,
                         "bf16_device_ms": dev_ms,
                         "bf16_max_abs_err": err[name],
                         "bf16_share_beyond_bound": share[name]}
            phase("serving", f"{card}: {name} bf16 x{len(args)} per forward "
                  f"at B={B} N={N}: kernel {ms:.4f} ms, plain {plain_ms:.4f}"
                  f" ms; device {dev_ms:.4f} ms; bound {bound_ms:.4f} ms "
                  f"({bound_by}); {flops / dev_ms / 1e9:.1f} TFLOP/s on the "
                  "device")
    for entry in results or ():
        entry.update(out.get(entry["name"], {}))
    return out


def serve_models(gen, dev):
    """The full-width segmenter (50 parts, feature transform) and
    classifier (40 classes, no feature transform) with seeded weights and
    random BatchNorm statistics, on the card, and seeded prepared clouds
    (N=2500 and 1024, ``SERVE_BATCHES``' largest)."""
    from adversarial_learning_on_pointclouds_tpu_torch import infer
    from adversarial_learning_on_pointclouds_tpu_torch.models import (
        PointNetCls, PointNetDenseCls,
    )

    rng = np.random.default_rng(SEED + 24)
    out = {}
    for kind, model, npts in (
            ("seg", PointNetDenseCls(PARTS, True, generator=gen), N),
            ("cls", PointNetCls(CLASSES, False, generator=gen), CLS_N)):
        randomize_bn(model, gen)
        raw = [rng.normal(size=(int(rng.integers(npts, 2 * npts)), 3))
               * rng.uniform(0.5, 2.0, size=3) for _ in range(B)]
        out[kind] = (model.to(dev).eval(), npts,
                     torch.from_numpy(infer.prep(raw, npts)))
    return out


def artifact_path(tmp, kind, bf16, kernels):
    return os.path.join(tmp, f"{kind}_{'bf16' if bf16 else 'fp32'}_"
                        f"{'kernels' if kernels else 'portable'}.pt2")


def export_artifacts(model, kind, npts, tmp, tag="serving"):
    """``model``'s four artifacts (fp32 and bf16, portable and kernels),
    each saved and then marked ``.done``; ``{(bf16, kernels): Exported}``.
    A portable artifact holds no registered op, a kernels artifact the
    eval kernels'."""
    from adversarial_learning_on_pointclouds_tpu_torch.utils import serving

    export = serving.export_segmenter if kind == "seg" \
        else serving.export_classifier
    out = {}
    for kernels in (False, True):
        for bf16 in (False, True):
            t0 = time.perf_counter()
            exp = export(model, npts, None,
                         ("cuda",) if kernels else serving.DEFAULT_DEVICES,
                         bf16=bf16, kernels=kernels)
            path = artifact_path(tmp, kind, bf16, kernels)
            serving.save_exported(exp, path)
            open(path + ".done", "w").close()
            ops = sorted({str(n.target) for n in exp.program.graph.nodes
                          if "pointtpu" in str(n.target)})
            phase(tag, f"exported {os.path.basename(path)} "
                  f"({os.path.getsize(path) / 1e6:.1f} MB) in "
                  f"{time.perf_counter() - t0:.1f} s: registered ops {ops}")
            if bool(ops) != kernels:
                raise AssertionError(f"{path}: registered ops {ops}")
            out[(bf16, kernels)] = exp
    return out


def replay_launches(served, x, kind, what, tag="serving"):
    """Launches of one forward of a kernels artifact, counted on replay."""
    wrappers = serve_wrappers()
    for w in wrappers.values():
        w.launches = 0
    served(x)
    seen = {k: w.launches for k, w in wrappers.items()}
    phase(tag, f"{what}: launches in one forward, counted on replay: {seen}")
    if seen != ARTIFACT_PER_FORWARD[kind]:
        raise AssertionError(f"{what}: launches {seen}, expected "
                             f"{ARTIFACT_PER_FORWARD[kind]}")


def serve_helper(state_dict, tmp, out):
    """The phase's second process: the classifier's four artifacts
    (loaded from ``state_dict``), its kernels artifacts' launches on
    replay, then ``serve_bench`` at B=32 N=2500; writes what it saw to
    ``out`` (JSON)."""
    from adversarial_learning_on_pointclouds_tpu_torch import serve_bench
    from adversarial_learning_on_pointclouds_tpu_torch.models import (
        PointNetCls, core,
    )
    from adversarial_learning_on_pointclouds_tpu_torch.utils import serving

    core.exact_fp32()
    dev = torch.device("cuda", 0)
    model = PointNetCls(CLASSES, False)
    model.load_state_dict(torch.load(state_dict))
    model = model.to(dev).eval()
    buf = io.StringIO()
    with redirect_stdout(buf):
        exps = export_artifacts(model, "cls", CLS_N, tmp, "serving helper")
        x = torch.randn(B, CLS_N, 3, device=dev)
        for bf16 in (False, True):
            replay_launches(serving.serve(exps[(bf16, True)], dev), x, "cls",
                            f"cls {'bf16' if bf16 else 'fp32'} kernels "
                            "artifact", "serving helper")
        bench = io.StringIO()
        with redirect_stdout(bench):
            serve_bench.main(["--model", "seg", "--batch", str(B),
                              "--num_points", str(N), "--iters", "10",
                              "--device", "cuda"])
    with open(out, "w") as f:
        json.dump({"lines": buf.getvalue().splitlines(),
                   "serve_bench": bench.getvalue().splitlines()}, f)


def start(cmd, tmp):
    """A helper process of the phase, its output into a file in ``tmp``
    (read if it fails)."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(os.path.abspath(__file__)),
         os.environ.get("PYTHONPATH", "")]))
    log = open(os.path.join(tmp, f"helper{len(os.listdir(tmp))}.log"), "w+")
    proc = subprocess.Popen([sys.executable, *cmd], stdout=log, stderr=log,
                            env=env)
    proc.log = log
    return proc


def finish(proc, what, timeout=240):
    """Wait for a helper; raise with its output unless it ended well."""
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    if proc.returncode != 0:
        proc.log.seek(0)
        raise AssertionError(f"{what} failed ({proc.returncode}):\n"
                             f"{proc.log.read()[-3000:]}")


def serving_phase(dev, card, results=None):
    """Phase 24."""
    from adversarial_learning_on_pointclouds_tpu_torch import infer
    from adversarial_learning_on_pointclouds_tpu_torch.models import core
    from adversarial_learning_on_pointclouds_tpu_torch.utils import serving

    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(SEED + 24)
    models = serve_models(gen, dev)
    procs = []
    with tempfile.TemporaryDirectory() as tmp:
        paths = {(kind, bf16, kernels): artifact_path(tmp, kind, bf16,
                                                      kernels)
                 for kind in models for bf16 in (False, True)
                 for kernels in (False, True)}
        inputs, cls_sd = (os.path.join(tmp, f) for f in ("inputs.pt",
                                                         "cls.pt"))
        torch.save({k: x for k, (_, _, x) in models.items()}, inputs)
        torch.save(models["cls"][0].state_dict(), cls_sd)
        outs = {k: os.path.join(tmp, f"reload_{k}.pt") for k in (0, 1)}
        helper_out = os.path.join(tmp, "helper.json")
        try:
            # Two fresh processes reload the portable and the kernels
            # artifacts as they are written; a third exports the
            # classifier's and runs serve_bench while this one exports the
            # segmenter's.
            for kernels in (False, True):
                procs.append(start(["-c", RELOAD, ",".join(
                    p for (_, _, k), p in paths.items() if k == kernels),
                    inputs, outs[int(kernels)], str(int(kernels))], tmp))
            procs.append(start(["-c", "import sys, chip_smoke; "
                                "chip_smoke.serve_helper(*sys.argv[1:])",
                                cls_sd, tmp, helper_out], tmp))
            serve_bf16_checks(card, gen, dev, results)
            phase("serving", f"bf16 kernels checked and timed at "
                  f"{time.perf_counter() - t0:.1f} s")
            live, cpu = {}, {}
            for kind, (model, npts, x) in models.items():
                cpu_model = copy.deepcopy(model).cpu()
                for bf16 in (False, True):
                    # The eval forward is per cloud: the CPU's runs once, at
                    # the largest batch, and its first b rows stand for b.
                    with torch.inference_mode(), \
                            core.mixed_precision(enabled=bf16):
                        for b in SERVE_BATCHES:
                            live[(kind, bf16, b)] = model(
                                x[:b].to(dev))[0].cpu()
                        cpu[(kind, bf16)] = cpu_model(x)[0]
            seg_model, _, x_seg = models["seg"]
            exps = export_artifacts(seg_model, "seg", N, tmp)
            phase("serving", f"the segmenter's artifacts exported at "
                  f"{time.perf_counter() - t0:.1f} s")
            xb = x_seg.to(dev)
            for bf16 in (False, True):
                served = serving.serve(exps[(bf16, True)], dev)
                what = f"seg {'bf16' if bf16 else 'fp32'} kernels artifact"
                replay_launches(served, xb, "seg", what)
                want = ("stack_tc_kernel<", f"head_tc_kernel<{str(bf16).lower()}>",
                        f"conv_group_kernel<3, {str(bf16).lower()}>")
                profile_names(device_profile(lambda: served(xb), reps=3),
                              what, want, 1, "serving")
            portable = serving.serve(exps[(False, False)], dev)
            names = device_profile(lambda: portable(xb), reps=3)
            found = [n for n in names for k in SERVE_NAMES if k in n]
            phase("serving", f"seg fp32 portable artifact's profile: "
                  f"{len(names)} kernel names, none of {SERVE_NAMES}: "
                  f"{not found}")
            if found:
                raise AssertionError(f"the portable artifact ran {found}")
            finish(procs[2], "the serving helper")
            for kind in models:
                try:
                    serving.load_exported(paths[(kind, False, True)], "cpu")
                except ValueError as e:
                    phase("serving", f"loading the {kind} kernels artifact "
                          f"on the CPU raises: {str(e)[:60]}...")
                else:
                    raise AssertionError("a kernels artifact loaded on the "
                                         "CPU")
            with open(helper_out) as f:
                helper = json.load(f)
            for line in helper["lines"]:
                print(line)
            fresh = {}
            for kernels in (False, True):
                finish(procs[kernels], "the fresh reloading process")
                got = torch.load(outs[int(kernels)])
                phase("serving", f"a fresh process reloaded the "
                      f"{'kernels' if kernels else 'portable'} artifacts, "
                      f"importing of the port {got['modules']}")
                if not kernels and got["modules"]:
                    raise AssertionError("the portable artifacts' process "
                                         "imported the port")
                if kernels and not any(m.endswith("serving_ops")
                                       for m in got["modules"]):
                    raise AssertionError("the kernels artifacts' process "
                                         "did not import the op "
                                         "registrations")
                fresh.update(got["res"])
            compare_artifacts(paths, fresh, live, cpu)

            # infer --artifact on a .pts file, with --ply.
            pts, ply_path = os.path.join(tmp, "shape.pts"), \
                os.path.join(tmp, "out.ply")
            np.savetxt(pts, x_seg[0].numpy(), fmt="%.6f")
            buf = io.StringIO()
            with redirect_stdout(buf):
                infer.main(["--artifact", paths[("seg", False, True)],
                            "--input", pts, "--ply", ply_path, "--device",
                            "cuda"])
            with open(ply_path) as f:
                vertices = sum(1 for line in f) - 10
            phase("serving", f"infer --artifact: {buf.getvalue().strip()!r};"
                  f" the .ply holds {vertices} points")
            if vertices != N:
                raise AssertionError(f"the .ply holds {vertices} points")
            for line in helper["serve_bench"]:
                phase("serving", f"{card}: serve_bench (beside the phase's "
                      f"other work): {line}")
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                proc.log.close()
    spent = time.perf_counter() - t0
    phase("serving", f"{card}: the serving phase took {spent:.1f} s (budget "
          f"{SERVE_BUDGET_S:g} s)")
    if spent > SERVE_BUDGET_S:
        raise AssertionError(f"the serving phase took {spent:.1f} s")


def compare_artifacts(paths, fresh, live, cpu):
    """Each artifact, as the fresh process served it, against the live
    model on the card and the CPU's forward at ``SERVE_BATCHES`` (the
    portable ones also on the CPU at b=1); fp32 within ``BOUND``; bf16, as
    phase 13 holds bf16 steps, within the larger of ``BOUND`` and
    ``YARD_FACTOR`` times what bf16 moves the CPU's fp32 forward, and
    beyond ``BOUND`` of the fp32 forward (it computes in bf16)."""
    for (kind, bf16, kernels), path in paths.items():
        name = os.path.basename(path)
        moved = rel_err(cpu[(kind, True)], cpu[(kind, False)])[0]
        bnd = max(BOUND, YARD_FACTOR * moved) if bf16 else BOUND
        for b in SERVE_BATCHES:
            card_out = fresh[(path, "cuda", b)]
            check(f"{name} b={b} on the card against the live model on the "
                  "card", card_out, live[(kind, bf16, b)], bnd, "serving")
            check(f"{name} b={b} on the card against the CPU", card_out,
                  cpu[(kind, bf16)][:b], bnd, "serving")
        if not kernels:
            check(f"{name} b=1 on the CPU against the CPU",
                  fresh[(path, "cpu", 1)], cpu[(kind, bf16)][:1], bnd,
                  "serving")
        if bf16:
            off = rel_err(fresh[(path, "cuda", B)], cpu[(kind, False)])[0]
            phase("serving", f"{name}: bf16 moves the CPU's fp32 forward by "
                  f"{moved:.3e} of its scale; the artifact is {off:.3e} off "
                  f"the fp32 forward (beyond {BOUND:g})")
            if off <= BOUND:
                raise AssertionError(f"{name} serves fp32, not bf16")


def ptxas_report(build, src):
    """``{name<template arguments>: (registers, spill store bytes, spill
    load bytes)}`` of ``src``'s kernels in this run's build (empty when
    the library was loaded, not built)."""
    out = {}
    for mangled, usage in build.resource_usage.get(src, {}).items():
        rest, name = mangled.removeprefix("_ZN"), mangled
        while m := re.match(r"\d+", rest):
            size = int(m[0])
            name, rest = rest[len(m[0]):len(m[0]) + size], \
                rest[len(m[0]) + size:]
        args = re.findall(r"L[a-z](-?\d+)E", rest)
        out[f"{name}<{','.join(args)}>" if args else name] = usage
    return out


def kernel_entry(name, src, site, launches, passes, times):
    """One kernel's line in the JSON: its passes' numbers summed; the
    bound is the sum of the passes' bounds, bound by what bounds the
    largest of them."""
    tot = {k: sum(p[k] for p in passes)
           for k in ("ms", "plain_ms", "bound_ms", "device_ms",
                     "plain_device_ms")}
    return {"name": name, "route": "cuda",
            "source": f"{KERNELS_ROOT}/csrc/{src}",
            "replaces": f"{TPU_KERNELS}/{site}", "launches": launches,
            "max_abs_err": max(p["max_abs_err"] for p in passes),
            **tot, "bound_by": max(passes, key=lambda p: p["bound_ms"])[
                "bound_by"], "library_ms": None,
            "times": times, "passes": passes}


def pool_fc_path(g, w1, b1, g1, be1, rm1, groups, bf16):
    """The pool-fc epilogue as the T-Net heads call it (``relu_fc_bn_relu``,
    its wrapper's allocations included), forward only."""
    from adversarial_learning_on_pointclouds_tpu_torch.models import core
    from adversarial_learning_on_pointclouds_tpu_torch.ops.kernels import (
        pool_fc_epilogue as pf,
    )

    with core.mixed_precision() if bf16 else contextlib.nullcontext():
        return pf.relu_fc_bn_relu(g, w1, b1, g1, be1, rm1, groups)


def head_passes(card):
    """``--time passes``: the seg head's P1 (64 -> 512, one launch), Pmid
    (512 -> 256 and 256 -> 128, a config-3 step's two launches), P4 (128
    -> 50, one launch), B1 (512 -> 64, one launch) and B4 (128 -> 50, one
    launch), and trunk F1 (64 -> 128, a config-3 step's
    three launches; and at groups=2 on 2B=64, the paired trunks' three) at
    B=32 N=2048 on seeded data; the pool-fc epilogue (1024 -> 512 through
    ``relu_fc_bn_relu``, the two T-Net heads' launches of a config-3 step
    at B=32, and at groups=2 on 2B=64 those of a bench step) and the fc
    head's forward and backward (``fc_head_fwd`` / ``fc_head_bwd`` at
    k=3 and 64, a config-3 step's launches under the switch) at B=32; fp32
    and bf16 (the fc head's backward: dW in bf16): median ms of ``REPS``
    calls (CUDA events), device ms (profiler), TFLOP/s and GB/s of each
    (the bytes of its inputs and outputs, each once)."""
    from adversarial_learning_on_pointclouds_tpu_torch.ops.kernels import (
        fc_head_train as fh, seg_head_train as sh, trunk_train as tt,
    )

    dev, gen, m = torch.device("cuda", 0), torch.Generator().manual_seed(
        SEED), B * TRAIN_N
    out = {}
    for bf16 in (False, True):
        def stash(c, scale=1.0, bsz=B):
            t = _r(gen, bsz, TRAIN_N, c, scale=scale, dev=dev)
            return t.to(torch.bfloat16) if bf16 else t

        w1 = _w(gen, 1088, 512, dev)      # pf is fp32 in both precisions
        p1 = [(torch.relu(_r(gen, B, TRAIN_N, 64, scale=1.0, dev=dev)),
               _r(gen, B, 512, scale=1.0, dev=dev), w1[:64],
               _r(gen, 512, dev=dev), bf16)]
        pmid = [(stash(ci), _gam(gen, ci, dev), _r(gen, ci, dev=dev),
                 _w(gen, ci, co, dev), _r(gen, co, dev=dev), bf16)
                for ci, co in ((512, 256), (256, 128))]
        p4 = [(stash(128), _gam(gen, 128, dev), _r(gen, 128, dev=dev),
               _w(gen, 128, PARTS, dev), _r(gen, PARTS, dev=dev), bf16)]
        b1 = [(stash(512), stash(512, 0.2), _gam(gen, 512, dev),
               _r(gen, 512, dev=dev), _gam(gen, 512, dev),
               _r(gen, 512, scale=1e-2, dev=dev),
               _r(gen, 512, scale=1e-2, dev=dev),
               torch.relu(_r(gen, B, TRAIN_N, 64, scale=1.0, dev=dev)),
               _w(gen, 64, 512, dev), bf16)]
        b4 = [(stash(128), _gam(gen, 128, dev), _r(gen, 128, dev=dev),
               _w(gen, 128, PARTS, dev), _r(gen, PARTS, dev=dev),
               _r(gen, 128, dev=dev), _gam(gen, 128, dev),
               _r(gen, B, TRAIN_N, PARTS, scale=1.0, dev=dev), bf16)]
        # Three trunks' launches, each on its own input (none left in L2).
        f1 = {g: [(torch.relu(_r(gen, g * B, TRAIN_N, 64, scale=1.0,
                                 dev=dev)),
                   _w(gen, 64, 128, dev), _r(gen, 128, dev=dev), g, bf16)
                  for _ in range(3)] for g in (1, 2)}
        # The T-Net heads: STN3d's and STNkd's pooled rows and fc layers.
        pool = {g: [(torch.relu(_r(gen, g * B, 1024, scale=1.0, dev=dev)),
                     _w(gen, 1024, 512, dev), _r(gen, 512, dev=dev),
                     _gam(gen, 512, dev), _r(gen, 512, dev=dev),
                     _r(gen, 512, dev=dev), g, bf16) for _ in range(2)]
                for g in (1, 2)}
        fwd, bwd = [], []
        for k in (3, 64):
            a = fc_head_args(gen, B, k, dev)
            fwd.append((*a, bf16))
            _, z1, z2, mu1, _, inv1, mu2, _, inv2 = fh.fc_head_fwd_plain(
                *a, bf16)
            bwd.append((_r(gen, B, 256, scale=1.0, dev=dev), a[0], z1, z2,
                        a[1], a[5], a[3], a[4], a[7], a[8], mu1, inv1, mu2,
                        inv2, bf16))
        fc = 2 * B * (1024 * 512 + 512 * 256)
        for name, fn, calls, flops in (
                ("P1", sh.p1, p1, 2 * m * 64 * 512),
                ("Pmid", sh.pmid, pmid, 2 * m * (512 * 256 + 256 * 128)),
                ("P4", sh.p4, p4, 2 * m * 128 * PARTS),
                ("B1", sh.b1, b1, 2 * 2 * m * 512 * 64),
                ("B4", sh.b4, b4, 3 * 2 * m * 128 * PARTS),
                ("F1", tt.f1, f1[1], 3 * 2 * m * 64 * 128),
                ("F1 groups=2", tt.f1, f1[2], 3 * 2 * 2 * m * 64 * 128),
                ("pool-fc", pool_fc_path, pool[1], 2 * 2 * B * 1024 * 512),
                ("pool-fc groups=2", pool_fc_path, pool[2],
                 2 * 2 * 2 * B * 1024 * 512),
                ("fc_head fwd", fh.fc_head_fwd, fwd,
                 2 * fc + 2 * B * 256 * (9 + 4096)),
                ("fc_head bwd", fh.fc_head_bwd, bwd, 2 * 2 * fc)):
            def run():
                return [fn(*a) for a in calls]

            with torch.no_grad():
                outs = run()
                nbytes = sum(t.numel() * t.element_size()
                             for t in _tensors((calls, outs)))
                ms = statistics.median(event_ms(run, REPS))
                dev_ms = sum(device_profile(run).values())
            key = f"{name} {'bf16' if bf16 else 'fp32'}"
            out[key] = {"ms": ms, "device_ms": dev_ms,
                        "tflops": flops / ms / 1e9,
                        "gbps": nbytes / dev_ms / 1e6}
            x0 = calls[0][0]
            at = f"B={x0.shape[0]}" + (f" N={x0.shape[1]}" if x0.dim() > 2
                                       else "")
            phase("time", f"{card}: {key} x{len(calls)} at {at}: "
                  f"{ms:.4f} ms ({flops / ms / 1e9:.1f} "
                  f"TFLOP/s), device {dev_ms:.4f} ms "
                  f"({nbytes / dev_ms / 1e6:.1f} GB/s)")
    return out


def serve_times(card):
    """``--time serve``: at B=32 N=2500 on phase 3's seeded operands, conv1
    (``fused_linear_affine_act``, 3 -> 64), the three stacks of a forward
    (``fused_stack_maxpool``) and the seg head (``seg_head_fused``), each
    the median ms of ``REPS`` forwards' launches (CUDA events), device ms
    (profiler), TFLOP/s on the device and the plain twin's events ms; then a
    seeded full-width segmenter (random BatchNorm statistics, as phase 4's)
    on 32 seeded clouds: its forward (events, and device busy ms) and
    ``Predictor.predict`` host to host, medians of ``REPS``."""
    from adversarial_learning_on_pointclouds_tpu_torch import infer
    from adversarial_learning_on_pointclouds_tpu_torch.models import (
        PointNetDenseCls,
    )
    from adversarial_learning_on_pointclouds_tpu_torch.ops.kernels import (
        encoder_fused, shared_mlp,
    )

    dev, gen = torch.device("cuda", 0), torch.Generator().manual_seed(SEED)
    out = {}
    with torch.inference_mode():
        conv1, stacks, head, w4, b4 = serve_params(gen, dev)
        x3 = torch.randn(B, N, 3, generator=gen).to(dev)
        x64 = torch.relu(torch.randn(B, N, 64, generator=gen)).to(dev)
        g = torch.relu(torch.randn(B, 1024, generator=gen)).to(dev)
        calls = {
            "fused_linear_affine_act": [(x3, *conv1, "relu")],
            "fused_stack_maxpool": [
                (x3 if widths[0] == 3 else x64, *zip(*stacks[key]), acts)
                for key, (widths, acts) in SERVE_STACKS.items()],
            "seg_head_fused": [(x64, g, *head[0], *head[1], *head[2], w4,
                                b4)]}
        for name, args in calls.items():
            module = shared_mlp if name in vars(shared_mlp) else encoder_fused
            fn, plain = (getattr(module, name + s) for s in ("", "_plain"))
            ms, plain_ms = time_pair(lambda: [fn(*a) for a in args],
                                     lambda: [plain(*a) for a in args])
            dev_ms = sum(device_profile(
                lambda: [fn(*a) for a in args]).values())
            flops = work(plain, args)[0]
            out[name] = {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                         "tflops": flops / dev_ms / 1e9}
            phase("time", f"{card}: {name} x{len(args)} at B={B} N={N}: "
                  f"{ms:.4f} ms, device {dev_ms:.4f} ms "
                  f"({flops / dev_ms / 1e9:.1f} TFLOP/s), plain "
                  f"{plain_ms:.4f} ms")
    model = PointNetDenseCls(PARTS, feature_transform=True, generator=gen)
    randomize_bn(model, gen)
    rng = np.random.default_rng(SEED)
    clouds = infer.prep([rng.normal(size=(N, 3)) for _ in range(B)], N)
    with tempfile.TemporaryDirectory() as tmp:
        pth = os.path.join(tmp, "g.pth")
        torch.save(model.state_dict(), pth)
        predictor = infer.Predictor(pth, "adv", N, "cuda",
                                    feature_transform=True)
    x = torch.from_numpy(clouds).to(dev)
    with torch.inference_mode():
        predictor.model(x)
        fwd_ms = statistics.median(event_ms(lambda: predictor.model(x), REPS))
        busy = sum(device_profile(lambda: predictor.model(x)).values())
    predictor.predict(clouds)
    host = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        predictor.predict(clouds)
        host.append(time.perf_counter() - t0)
    out["forward"] = {"ms": fwd_ms, "device_busy_ms": busy,
                      "predict_ms": statistics.median(host) * 1e3}
    phase("time", f"{card}: segmenter forward B={B} N={N}: {fwd_ms:.3f} ms "
          f"(device busy {busy:.3f} ms); Predictor.predict host to host "
          f"{out['forward']['predict_ms']:.3f} ms")
    return out


def augment_times(card):
    """``--time bench``: the bench step's augmentation alone, 2 x B=32 x
    N=2048 (rotate and jitter, streams 0 and 1), as the tree's step
    launches it: one ``augment_fused_pair`` where the tree has it, else
    ``augment_fused`` once a stream. Median events ms of ``REPS`` steps'
    launches, device ms (profiler), the kernels' launches, and the plain
    twin's events ms."""
    from adversarial_learning_on_pointclouds_tpu_torch.ops.kernels import (
        augment_fused as af,
    )

    dev, gen = torch.device("cuda", 0), torch.Generator().manual_seed(SEED)
    xs = [torch.randn(B, TRAIN_N, 3, generator=gen).to(dev) for _ in (0, 1)]
    step = torch.tensor(3, dtype=torch.int64, device=dev)
    flags = (True, True, False)
    if hasattr(af, "augment_fused_pair"):
        def run():
            return af.augment_fused_pair(step, *xs, SEED, *flags)
    else:
        def run():
            return [af.augment_fused(step, x, SEED, k, *flags)
                    for k, x in enumerate(xs)]
    ms, plain_ms = time_pair(run, lambda: [af.augment_fused_plain(
        step, x, SEED, k, *flags) for k, x in enumerate(xs)])
    counts = {}
    dev_ms = sum(device_profile(run, counts=counts).values())
    launches = sum(counts.values())
    phase("time", f"{card}: the bench step's augmentation, 2 x B={B} "
          f"N={TRAIN_N}: {ms:.4f} ms, device {dev_ms:.4f} ms in {launches:g} "
          f"launch(es), plain {plain_ms:.4f} ms")
    return {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
            "launches": launches}


def time_alone(mode: str, root: str, card: str) -> None:
    """``--time fp32|bench|pallas_train|passes|serve --root
    DIR``: the G+D step's timing alone, of the port package under ``DIR``
    (a checkout, or a ``git archive`` of the parent commit, say), from
    ``create_state``'s
    weights seeded by ``cfg.seed`` on seeded batches: ``fp32`` as phase 11
    (synchronized ``train_step`` calls of ``AdversarialConfig()``),
    ``bench`` as phase 14 (``train_steps_scan`` at K=8 of the bench
    configuration), ``pallas_train`` the same under ``use_pallas_train``
    (``bench.py --pallas_train``; a tree without the switch fails);
    ``passes`` the seg head's P1, Pmid, P4, B1 and B4, trunk F1 and the
    T-Net fc layers alone (``head_passes``), ``serve`` the serving kernels
    (conv1 too), forward and ``Predictor.predict`` (``serve_times``);
    ``bench`` also times the step's augmentation alone
    (``augment_times``). Prints one JSON line, and no result line. To compare two trees, alternate
    them within one call (A B B A): the host's share of a step moves
    between calls."""
    from adversarial_learning_on_pointclouds_tpu_torch.configs import (
        AdversarialConfig,
    )
    from adversarial_learning_on_pointclouds_tpu_torch.train import (
        adversarial,
    )

    from adversarial_learning_on_pointclouds_tpu_torch.ops import dispatch

    if mode in ("passes", "serve"):
        times = {"passes": head_passes, "serve": serve_times}[mode](card)
        print(json.dumps({"root": root, "mode": mode, "card": card,
                          **times}), flush=True)
        return
    if mode == "fp32":
        cfg, k = AdversarialConfig(), 1
    else:
        cfg, k = AdversarialConfig(augment=True, bf16=True,
                                   pallas_augment=True), BENCH_K
    txs = adversarial.make_txs(cfg, 100)
    state = adversarial.create_state(cfg, 100)
    rng = np.random.default_rng(cfg.seed)
    b, n = cfg.batch_size, cfg.num_points
    x_l, x_u = (torch.from_numpy(rng.normal(size=(k, b, n, 3)).astype(
        np.float32)).cuda() for _ in range(2))
    y_l = torch.from_numpy(rng.integers(0, cfg.num_parts, (k, b, n))).cuda()
    if mode == "fp32":
        out = time_step(card, "time fp32", cfg, state,
                        (x_l[0], y_l[0], x_u[0]), txs)
    else:
        with dispatch.use_pallas_train(mode == "pallas_train"):
            out = time_scan(card, f"time {mode}", cfg, state,
                            (x_l, y_l, x_u), txs)
        if mode == "bench":
            out["augment"] = augment_times(card)
    print(json.dumps({"root": root, "mode": mode, "card": card, **out}),
          flush=True)


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--time", choices=("fp32", "bench", "pallas_train",
                                       "passes", "serve"),
                    help="time the G+D step, the seg head's P1, Pmid, "
                         "P4, B1 and B4, trunk F1 and the T-Net fc layers, "
                         "or serving, alone (no checks, no result line)")
    ap.add_argument("--disc-checks", type=int, metavar="SEED",
                    help="run only the discriminator's checks of phases 9 "
                         "and 12 on data from this generator seed (no "
                         "result line)")
    ap.add_argument("--runner", action="store_true",
                    help="run only phases 1-2 and 21 (the runners end to "
                         "end; no result line)")
    ap.add_argument("--classify", action="store_true",
                    help="run only phases 1-2 and 22 (the classification "
                         "configs end to end; no result line)")
    ap.add_argument("--ablation", action="store_true",
                    help="run only phases 1-2 and 23 (the ablation "
                         "controls and batching knobs; no result line)")
    ap.add_argument("--serve", action="store_true",
                    help="run only phases 1-2 and 24 (serving artifacts and "
                         "the eval kernels' bf16 mode; no result line)")
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(
        __file__)), help="with --time: the tree whose port package to time")
    args = ap.parse_args()
    # 1. device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this check needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    card = card.splitlines()[0]
    phase("device", f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} visible")

    sys.path.insert(0, os.path.abspath(args.root))
    from adversarial_learning_on_pointclouds_tpu_torch.models import core
    from adversarial_learning_on_pointclouds_tpu_torch.ops import build
    core.exact_fp32()

    # 2. build
    t0 = time.perf_counter()
    built = not build.library_path().exists()
    build.library()
    phase("build", f"{'compiled' if built else 'loaded'} "
          f"{build.library_path().name} in {time.perf_counter() - t0:.1f} s"
          + "".join(f"; {k} {v:.1f} s" for k, v in sorted(
              getattr(build, "compile_seconds", {}).items(),
              key=lambda kv: -kv[1])))
    for src in ("strided_gemm.cu", "pointwise_matmul.cu", "tnet_apply.cu",
                "train_bwd_tc.cu", "disc_tc.cu", "encoder_fused.cu",
                "pool_fc_epilogue.cu", "fc_head_train.cu", "shared_mlp.cu",
                "augment_fused.cu"):
        for label, (regs, st, ld) in ptxas_report(build, src).items():
            phase("build", f"ptxas: {src} {label}: {regs} registers, spill "
                  f"stores {st} bytes, spill loads {ld} bytes")
    if args.time:
        time_alone(args.time, args.root, card)
        return
    if args.runner:
        runner_phase(dev, card)
        return
    if args.classify:
        classify_phase(dev, card)
        return
    if args.ablation:
        ablation_phase(dev, card)
        return
    if args.serve:
        serving_phase(dev, card)
        return
    if args.disc_checks is not None:
        gen = torch.Generator().manual_seed(args.disc_checks)
        disc_kernel_checks(dev, gen, PassRecord())
        disc_kernel_checks(dev, gen, PassRecord(BF16_BOUND), bf16=True)
        phase("disc-checks", f"generator seed {args.disc_checks}: every "
              "discriminator check passed")
        return

    gen = torch.Generator().manual_seed(SEED)
    results = []
    serve(dev, card, gen, results)
    rec = PassRecord()
    train_kernel_checks(dev, gen, rec)
    cuda_run, launches = train_slice(dev, card, gen)
    train_timing(card, rec, cuda_run, launches, results)
    disc_kernel_checks(dev, gen, rec)
    cuda_run, launches = adv_slice(dev, card, gen)
    adv_timing(card, rec, cuda_run, launches, results)
    rec_bf = PassRecord(BF16_BOUND)
    train_kernel_checks(dev, gen, rec_bf, bf16=True)
    disc_kernel_checks(dev, gen, rec_bf, bf16=True)
    groups2_checks(dev, gen, rec_bf)
    augment_checks(dev, gen, rec_bf)
    bench = bench_slice(dev, card, gen)
    bench_timing(card, rec_bf, results, bench)
    rec_pt, rec_pt_bf = PassRecord(), PassRecord(BF16_BOUND)
    pt_kernel_checks(dev, gen, rec_pt, rec_pt_bf)
    seg, bench_pt = pt_slice(dev, card, gen)
    pt_timing(card, rec_pt, rec_pt_bf, results, seg, bench_pt)
    rec_st = stack_trunk3_checks(dev, gen)
    slice_out = adv_pt_slice(dev, card, gen)
    adv_pt_timing(card, rec_st, slice_out, results)
    runner_phase(dev, card)
    classify_phase(dev, card)
    ablation_phase(dev, card, results)
    serving_phase(dev, card, results)

    print(json.dumps({"kernels": results}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
