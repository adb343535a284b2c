#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``cotnet_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the run exits non-zero without
printing the last line:

1. Device: the card's name and power limit (nvidia-smi), and the set-up
   time, which includes building the CUDA kernels from the sources in
   ``cotnet_tpu_torch/ops/csrc`` with nvcc, one compiler per source, all
   started together; per kernel function, its registers, shared memory
   and spills (ptxas) and its SASS instruction count (cuobjdump).
2. Model, eval: cotnet50 with seeded random weights (random BN running
   stats and a non-zero ``bn3`` scale, so every residual branch reaches the
   logits).  f32 logits through the kernel against the plain path; the
   kernel's launch count per forward; then the eval main path, the bf16
   eval step at 224x224 bs128, with its images/s, its kernel launches
   counted by input shape, the bf16 logits against the f32 ones, and one
   step under torch.profiler.
3. Model, training: f32 gradients of one loss through the three kernels
   against the plain path (bs16, TF32 off), with 16 forward, 16 dx and 16
   dw launches and no plain call, and every backward launch held against
   the plain backward on the model's own tensors; five f32 steps on one
   batch at a constant LR, which must lower the loss; then the train main
   path, the bf16 ``make_train_step`` at 224x224 bs128 under the CoTNet-50
   recipe (mixup and cutmix, dropout 0.25, stochastic depth 0.1, nesterov
   SGD with masked weight decay, cosine warm-up, EMA), 2 warm-up and 8
   timed steps, with its images/s, peak memory, launches of each kernel by
   input shape, and one step under torch.profiler.
4. The training stack: every optimizer name of the port's
   ``create_optimizer`` (adahessian apart) and ``lookahead_adamp``, each
   from the same start, through cotnet50's bf16 ``make_train_step`` at
   224x224 bs128 under the recipe's model, mixup and EMA settings, from
   epoch 150 on (past the warm-up): 3 steps each, 7 for Lookahead (its
   sync fires at the sixth); ``adamw`` with AGC 0.01 and tanh, ``lamb``
   with norm clipping 1.0 and step decay, ``adafactor`` with multistep
   decay and LR noise, ``lookahead_adamp`` with value clipping 0.01 and
   the plateau schedule scaled by a ``PlateauController``.  Each with 16
   forward, dx and dw launches a step on ``k3``, no plain call, finite
   losses and gradient norms, the schedule's LRs, the parameters moved,
   its images/s, peak memory and device kernels a step (torch.profiler)
   beside sgd's.  Then one f32 update of each optimizer and AdaHessian on
   the card against the CPU from one cotnet50 backward (rtol 1e-5), and
   ``make_train_step(second_order=True)`` refusing cotnet50.
5. The switches and CoTNeXt.  For cotnet50 and for cotnext50_2x48d, in f32
   at bs16 with TF32 off: the logits of the fused-embed eval
   (``mega_fuse=True``) against the unfused ones of the same weights; one
   loss and backward of the folded model (``gn_fold_train=True``) with
   every affine backward launch held against the plain affine backward on
   the model's own tensors; five f32 steps of the folded model, which must
   lower the loss.  Then the bf16 main paths at 224x224 bs128, each with
   its images/s, launches of every kernel by input shape, no plain call
   and one step under torch.profiler: path A, the folded train step, and
   path B, the fused-embed eval, for both models; for cotnext50_2x48d its
   default eval and train steps as well.
6. SE-CoTNetD: se_cotnetd_152 with seeded random weights, calibrated
   as in phase 2.  In f32 at bs4 and 256x256 with TF32 off: logits
   through the kernels against the plain path, 21 forward launches and no
   plain call; every dx and dw launch of one backward held against the
   plain backward on the model's own tensors; five steps that lower the
   loss.  Then its bf16 main paths: the eval step at 256x256 bs128 and the
   train step at 256x256 bs64 under its recipe
   (``cot_experiments/SE-CoTNetD-152_350epoch/config.yaml``: drop 0.25,
   drop path 0.15, LR 0.2, the rest as CoTNet-50's), each with images/s,
   peak memory, launches by kernel and input shape (21 a step, at the
   pre-pool 32x32 and 16x16 maps too), no plain call and a profile.
7. The op entry points: the mix op's main path, one autograd call of
   ``local_aggregate_mix`` (and of ``_merge`` with the packed weight) at
   cotnet50's four geometries in bf16 at bs128, each one launch of each
   mix kernel, the forward, dx and dw on their ``tiles`` route, and no
   plain call;
   ``local_aggregate_dilated`` with dilations 1 and 2 in f32, forward and
   gradients against the plain path, one forward, dx and dw launch per
   distinct dilation.
8. The data pipeline (``cotnet_tpu_torch.data``): the host's CPUs, its
   Pillow and the g++ that builds the native batch ops, which must load.
   Seeded JPEGs (500x375 and 375x500, quality 90, 10 classes: 3 x 128 +
   16 train, 165 val) in a temporary directory; without Pillow, seeded
   uint8 samples at 224 from a numpy dataset instead, and the log says
   that decode and the host transforms did not run.  The train
   ``Loader`` under the CoTNet-50 recipe's augmentation (RandomResizedCrop
   bicubic, hflip, host ``rand-m15-mstd0.5-n2``) on 6 worker processes
   at bs128: images/s over an epoch, H2D + device augment a batch, epoch
   0 twice the same bytes and epoch 1 others; cotnet50's bf16 recipe
   train step fed by it for two epochs (images/s, the device busy share
   of a profiled steady-state step beside the train main path's, 16
   forward, dx and dw launches a step, recorded as the path "cotnet50
   train (loader)"); the eval step over the val loader (two batches,
   37 valid in the second, 165 counted, the step's top-1 count equal to
   the unpadded logits', recorded as "cotnet50 eval (loader)"); then one
   bs128 224 batch of each device augment (RandAugment, AutoAugment
   ``v0``, AugMix with 3 splits, RandomErasing ``pixel`` 0.25 x3) with
   its ms a batch, and each on the card against the CPU given the same
   draws.
9. The CLI, checkpoints and the bench (``train_cli``, ``utils/checkpoint``,
   ``evaler``, ``bench``).  The CoTNet-50 recipe, copied to a temporary
   folder with its ``recovery_interval`` set to 1, through
   ``train_cli.main`` in-process: synthetic data at the recipe's batch (80)
   and vbatch (128) at 224, 3 steps an epoch for 2 epochs, launches
   recorded as "cotnet50 train (cli)" (16 forward, dx and dw a step) and
   "cotnet50 eval (cli)" (16 affine forwards a step, the live weights and
   the EMA), no plain call; ``log.txt``'s eval and "done; best" lines, the
   checkpoints, ``index.json``, ``last.pth.tar`` and the recovery files;
   then ``--eval-only`` with ``model.resume`` set to the best checkpoint,
   whose top-1 and top-5 must equal that epoch's eval and whose weights
   the checkpoint's.  One CLI epoch of 3 steps on phase 8's seeded JPEG
   tree, whose eval counts 165 samples.  Resume at full width: cotnet50
   bf16 at 224 under the recipe's solver with EMA and mixup, 2N
   uninterrupted steps against N steps, ``save_recovery``, a restore into
   a fresh model and optimizer and N more, with cuDNN deterministic: the
   parameters, BN stats, EMA, optimizer state, step and LR trace must be
   the same bits; the save and restore ms.  The CLI-built train step's ms
   at the recipe's batch, one step under ``utils.profiler.trace``, whose
   Chrome trace must hold 16 launches each of the ``k3`` forward, dx and
   dw; then ``cotnet_tpu_torch.bench.main()`` at its defaults, whose JSON
   line comes before the kernels line.
10. Data parallelism (``cotnet_tpu_torch.parallel``).  (a) A world-size-1
   NCCL group under torchrun's environment variables:
   ``torch.distributed.is_nccl_available()``, the NCCL version, an
   all-reduce of a card tensor of cotnet50's 22,222,416 gradients (raw,
   timed, and through ``scaled_all_reduce``, which must leave it as it
   is); then ``train_cli.main`` inside that group (synthetic, the recipe's
   bs80, 3 steps, one epoch), launches recorded as "cotnet50 train (cli,
   nccl)" and "cotnet50 eval (cli, nccl)", no plain call and no
   all-reduce (the collectives are the identity at world size 1), rank
   0's checkpoint.  (b) Two gloo ranks sharing the card with CUDA tensors
   (NCCL refuses two ranks on one device), spawned: cotnet50 in f32 at
   224, global batch 128 (64 a rank), 3 recipe steps at the base LR with
   mixup over the global batch (TF32 off, cuDNN deterministic); the two
   ranks must hold the same bits, each launch the ``k3`` forward, dx and
   dw 16 times a step at N=64 and make no plain call, and the loss and the
   sums of |parameters| and |BN running means| must be within
   ``tests/test_multiproc.py``'s tolerances (2e-5, 1e-4) of one process
   on the whole batch, or within 3x that process's own noise (the same
   run on images scaled by 1 + 1e-7); each rank's collectives a step by
   helper (``parallel.collectives.CollectiveTimer``: the BN sums, the
   gradients, mixup's gather): calls, MB, ms on the stream.
11. The plain ResNet chassis: seresnet50, resnet18 and ecaresnet50d, f32
   logits on the card against the port on the CPU (seeded weights, BN
   statistics calibrated on the images, TF32 off) at 1e-3 of the largest
   logit; each one's bf16 eval step at 224 bs128 (images/s, device
   kernels and busy ms a step, peak memory); seresnet50's bf16 train step
   under the CoTNet-50 recipe (3 timed steps after one warm-up, images/s,
   device kernels a step, peak memory).  No launch of the op and no plain
   call.
12. Kernels: each Hopper kernel against its plain PyTorch version on the
   card.  The forward at the four aggregation geometries of cotnet50
   (N=128 and 80, the CLI's train batch), the four per-group ones of cotnext50_2x48d (N=256) and those
   of se_cotnetd_152 (N=128 and 64), bf16, with and without the GroupNorm
   affine; san19's five (K = 3 on 112x112 with Cw = 2, K = 7 at 56, 28,
   14 and 7) and lrnet50's three pre-pool ones (C = 128, 256, 512 at 56,
   28, 14), N=128, bf16, without the affine (no path of theirs runs it);
   general f32 cases (heads=2, K=5 and 7, dilation 2, odd H != W),
   a reflect-padded case, the edges of the halo tiles in bf16 (a 3x3 map,
   57x57, 13x11 with Cw=6, N=1 at 56x56) and the geometries beyond them
   (K=5 on 3x513 and K=3 on 2x2049 in bf16, K=9 in bf16, K=7 at dilation
   8 on 16x256 in f32), each forward, dx, dw and affine dw entry naming
   the route its launcher took (``variant``: ``k3``, ``k7``, ``general``
   or ``pointwise``; the geometries beyond the tiles must take
   ``pointwise``, every main path ``k3`` but san19's K = 7 launches, whose
   forward, dx and dw must take ``k7`` (the affine dw, on no path there,
   ``general``), ``GEOMETRY_ROUTE``); the ``k7`` forward, dx and dw also
   at san19's four K = 7 maps in f32 (N=32) and at the edges of their
   tiles (13x11 and 17x23 in bf16 and f32, N=1 at 56x56, a 5x5 map with
   two groups, and 16 groups, which the k7 tiles refuse and which must
   take ``general``),
   each ``k7`` launch made twice for the same bits, f32 within 1e-5 of the
   largest, with the ptxas registers and spills of the ``k7`` and
   ``general`` instantiations beside their times (no ``k7`` spill
   allowed); the backward kernels (dx, dw, and with the
   affine dx and dw+ds+db) at the same geometries, the reflect case
   through autograd as well, each affine dw launched twice and its dw, ds
   and db bit-identical; the fused embed kernels at the eight
   geometries of the two models with a fused-embed path, at general f32
   cases (K=5 with dilation 2 and K=7, non-square maps, two groups), at
   the halo tiles' edges in bf16 and f32, at whole 7x7 planes with Cp=256
   and at K=3 on 2x2049 (which must take ``pointwise``), each naming its
   route (``ops.local_agg.embed_gn_route``), launched twice for the same
   bits, with the device time of its statistics and aggregation kernels
   (torch.profiler; no statistics launch where a block holds whole
   planes, ``embed_gn_stats_rows`` on the tiled routes), the statistics
   pass's own bound, and the device time of one torch.matmul that forms
   w_raw of the same shapes; where a plane spans several row tiles (57x57,
   N=1 at 56x56, the two models' 56x56), the statistics pass's plane totals
   against the pointwise route's, in bf16 and f32 within 1e-6 of the
   largest, and equal on integer inputs; the
   three mix kernels (forward, dx, dw) at cotnet50's four geometries in
   bf16, at a general f32 case (heads 2, 13x11, Cw dividing C four
   times), at the edges of the dx and dw tiles in bf16 (3x3, 57x57, 13x11
   with Cw=6, N=1 at 56x56) and at 2x2049 (which must take
   ``pointwise``), the weights separate and packed, each naming its route
   (``ops.local_agg.mix_route``: ``tiles`` or ``pointwise``; the mix
   path's launches must take ``tiles``), launched twice for the same bits,
   and timed on the pointwise route too (the first kernels, one thread per
   output, which are that route), the forward's and dw's two routes
   compared bit for bit (the forward's must agree).  CUDA-event times of kernel and plain version beside the bound
   (data-sheet rates) and the byte bound at the device copy rate measured
   first; each case's launches in the main paths' runs (0 for a shape no
   main path launches).

13. The CoT paper's comparison families (run before phase 12, whose cases
   account for their launches): san19, lrnet50, BoTNetS1_59 (256),
   lambdanet50 and resnet50_dw in f32 at bs4 with TF32 off, seeded
   weights and BN statistics calibrated on the images: logits on the card
   against the port on the CPU at 1e-3 of the largest logit; for san19
   and lrnet50 also through the kernels against the plain path on the
   card (19 and 16 forward launches and no plain call a forward) and
   every dx and dw launch of one backward against the plain backward on
   the model's own tensors (1e-5 of the largest); five steps that lower
   each loss.  The bf16 main paths of san19 and lrnet50 at 224 bs128: the
   eval step (the plain forward once an aggregation) and the train step
   under the CoTNet-50 recipe's solver, mixup and EMA (forward, dx, dw
   once an aggregation), with images/s, peak memory, launches by shape
   and a profile; BoTNetS1_59's, lambdanet50's and resnet50_dw's bf16
   eval steps at bs128 (images/s, device kernels and busy ms, peak
   memory, no launch of the op).  cotnet50's bf16 recipe train step at
   bs128 with ``remat`` beside without it (images/s, peak memory; with it
   the forward launches twice a layer), and in f32 at bs16 two steps with
   drop path and dropout: the same losses, parameter and BN bits and
   generator state.  ``features_only`` cotnet50's five maps against its
   ``FeatureInfo``; ``output_stride=16`` cotnet50's bf16 eval at bs128,
   every launch on ``k3`` with stage 4 at 14x14.  The phase's seconds.
14. The transformer core (after phase 13; no op on its paths):
   vit_base_patch16_224, deit_base_distilled_patch16_224,
   resnetv2_50x1_bitm (at 224), resnetv2_50d, vit_base_r50_s16_224 and
   vit_small_resnet26d_224 in f32 at bs4 with TF32 off, seeded weights and
   BN statistics calibrated on the images: logits on the card against the
   port on the CPU at 1e-3 of the largest logit; five f32 steps of
   vit_tiny_patch16_224 on one batch lower the loss.  The bf16 main paths:
   vit_base_patch16_224's eval and train at 224 bs128 (the train step
   under DeiT-B's solver, ``DEIT_RECIPE``), resnetv2_50x1_bitm's eval at
   its 448 bs64 and train at 224 bs128 under the CoTNet-50 recipe's
   solver, mixup and EMA, vit_base_r50_s16_384's eval at 384 bs64: 2
   warm-up and 4 timed steps each, images/s, peak memory, and one
   profiled step (device kernels, busy share); no launch of the op and no
   plain call.  The fused embed op's plain gradient (``impl="torch"``) on
   the card in f32 against the CPU's (1e-5 of the largest), and ``auto``
   at a compiled K*K refusing a gradient.  The phase's seconds.
15. The ViT-built transformers (after phase 14; no op on their paths):
   swin_tiny_patch4_window7_224, swin_base_patch4_window12_384 (at 384,
   bs2: window 12, no shift in stage 4), xcit_nano_12_p8_224 (patch 8,
   tokens_norm off), xcit_tiny_24_p16_224 (depth 24, eta 1e-5),
   cait_xxs24_224 and pit_ti_distilled_224 in f32 at bs4 with TF32 off,
   seeded weights and XCiT's BN statistics calibrated on the images:
   logits on the card against the port on the CPU at 1e-3 of the largest
   logit; five f32 steps of xcit_nano_12_p16_224 on one batch lower the
   loss.  The bf16 main paths: swin_tiny_patch4_window7_224's eval and
   train at 224 bs128 (the train step under Swin-T's solver,
   ``SWIN_RECIPE``), xcit_small_12_p16_224's eval and train at 224 bs128
   (DeiT-B's solver with drop path 0.05), cait_s24_224's and pit_b_224's
   eval at 224 bs128, swin_base_patch4_window12_384's eval at 384 bs64: 2
   warm-up and 4 timed steps each, images/s, peak memory, and one
   profiled step (device kernels, busy share); no launch of the op and no
   plain call.  The phase's seconds.
16. The last ViT-built transformers (after phase 15; no op on their
   paths): convit_tiny, tnt_s_patch16_224, twins_pcpvt_small,
   visformer_tiny, levit_128s and coat_lite_tiny in f32 at bs4 with TF32
   off, seeded weights and the BN statistics of Visformer and LeViT (its
   BNs over tokens too) calibrated on the images: logits on the card
   against the port on the CPU at 1e-3 of the largest logit; five f32
   steps of levit_128s on one batch lower the loss (the BN over tokens in
   training).  The bf16 main paths at 224 bs128: the eval steps of
   twins_svt_small, visformer_small, coat_tiny (its parallel blocks),
   levit_256, convit_small and tnt_s_patch16_224, and the train steps of
   twins_svt_small and visformer_small under DeiT-B's solver with drop
   path 0.1: 2 warm-up and 4 timed steps each, images/s, peak memory, and
   one profiled step (device kernels, busy share); no launch of the op and
   no plain call.  The phase's seconds.
17. The EfficientNet superfamily (after phase 16; no op on its paths):
   efficientnet_b0, tf_efficientnet_b0 (TF-SAME, eps 1e-3), mixnet_s
   (MixedConv), efficientnet_cc_b0_4e (CondConv), efficientnet_es
   (EdgeResidual) and mobilenetv3_large_100 in f32 at bs4 and 224 with
   TF32 off, seeded weights and BN statistics calibrated on the images:
   logits on the card against the port on the CPU at 1e-3 of the largest
   logit; five f32 steps of efficientnet_cc_b0_4e at bs16 on one batch
   lower the loss (CondConv's per-sample backward).  The bf16 main paths
   at 224 bs128: the eval steps of efficientnet_b0, mobilenetv3_large_100,
   mixnet_m and efficientnet_cc_b0_4e, and the train steps of
   efficientnet_b0 and mobilenetv3_large_100 under timm's recipes
   (``EFFNET_RECIPE``, ``MNV3_RECIPE``): 2 warm-up and 4 timed steps
   each, images/s, peak memory, and one profiled step (device kernels,
   busy share); no launch of the op and no plain call.  The phase's
   seconds.
18. The CNN tail (after phase 17; no op on its paths): resnest14d,
   skresnet18, skresnext50_32x4d, res2net50_26w_4s, resnet_rs50,
   psresnet50, regnety_002, densenetblur121d and rexnet_100 at 224 and
   xception at 299, in f32 at bs4 with TF32 off, seeded weights and BN
   statistics calibrated on the images: logits on the card against the
   port on the CPU at 1e-3 of the largest logit; five f32 steps of
   psresnet50 at bs16 on one batch lower the loss, and every PSConv's
   masked dense weights are still exactly zero after them (the mask's
   zero gradient under SGD with weight decay).  The bf16 main paths at
   bs128: the eval steps of resnest50d, skresnext50_32x4d,
   res2net50_26w_4s, resnet_rs50, psresnet50, regnety_032, densenet121
   and rexnet_100 at 224 and xception at 299, and the train steps of
   resnest50d and densenet121 at 224 under the CoTNet-50 recipe
   (densenet121 without drop path, which it has not): 2 warm-up and 4
   timed steps each, images/s, peak memory, and one profiled step
   (device kernels, busy share); no launch of the op and no plain call.
   The phase's seconds.
19. The last of the JAX package's API (after phase 18).
   ``local_aggregate_wt`` (the weight ``[Cw, K*K, Ho, Wo, N]``): one
   autograd call at each of cotnet50's four geometries in bf16 at bs128,
   recorded as the path "local_aggregate_wt" (one ``k3`` forward, dx and
   dw launch each, no plain call), the output, dx and dw the same bits as
   ``local_aggregate``'s on the permuted weight, and one f32 call against
   the plain version at 1e-5 of the largest.  cotnet50 with its key convs
   swapped for ``DenseGroupedConv`` (``dense_key_convs``: the JAX
   package's ``COTNET_DENSE_GROUPED`` form, dense convs with block-diagonal
   kernels and the same weights) on phase 2's calibrated state, f32 at
   bs16 with TF32 off: logits against the grouped net within 1e-3 of the
   largest logit (16 forward launches, no plain call), and one loss and
   backward through the kernels (16 forward, dx and dw launches, each
   backward launch against the plain backward) against the grouped net's
   gradient, held to 3x that net's own noise as in phase 3; then its bf16
   main paths at 224 bs128, the train step under the CoTNet-50 recipe and
   the eval step, recorded as "cotnet50 train (dense key convs)" and
   "cotnet50 eval (dense key convs)", their images/s beside phases 2 and
   3's, after the 16 key convs' own device ms, grouped against dense, in
   bf16 at bs128 (forward; forward, dx and dw).  The layer
   tail at bs128 on 56x56 maps of 256 channels: ``avg_pool2d_same``,
   ``median_pool2d`` (3x3, and 2x2 for an even window), ``Shiftlution``,
   ``TBConv``, ``Kerv2d``, ``space_to_depth``, ``EvoNorm2dB0`` /
   ``EvoNorm2dS0``, ``instance_std``, ``group_std``, ``SplitBatchNorm``,
   ``test_time_pool`` (a 1x1 classifier to 1000 classes) and
   ``DenseGroupedConv``, each in f32 with TF32 off on the card against the
   same module on the CPU with the same seeded weights (1e-5 of the
   largest, 1e-4 for the convs), EvoNorm B0 and SplitBatchNorm in eval and
   in training with their running statistics, and in bf16, where the
   results must be finite.  The phase's seconds.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import torch

# H100 SXM data sheet: HBM3 rate, the f32 rate outside the tensor cores (the
# taps' products and sums are f32 FMAs), and the dense tensor-core rate of a
# matrix product by the type of its operands (an f32 product at the f32 rate)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
MATMUL_FLOPS_PER_S = {torch.bfloat16: 989e12, torch.float16: 989e12,
                      torch.float32: 67e12}
L2_FLUSH_BYTES = 256 << 20
# the main paths' batch; the train step of se_cotnetd_152 takes its
# recipe's per-process batch instead (TRAIN_BATCH)
BATCH = 128
# the image size of cotnet50 and cotnext50_2x48d
IMAGE = 224
# (C, map size, CoT layers at that size): the launches per forward the
# main path must make at each shape
COTNET50_GEOMETRIES = ((64, 56, 3), (128, 28, 4), (256, 14, 6), (512, 7, 3))
# se_cotnetd_152 at 256 px: stage 3's even blocks (the first before its
# BlurPool, at 32x32) and all of stage 4 (the first at 16x16)
SE_COTNETD_152_GEOMETRIES = ((256, 32, 1), (256, 16, 17), (512, 16, 1),
                             (512, 8, 2))
# phase 13: SAN19's aggregations (C = mid planes, Cw = C/8, one a block):
# K = 3 on stage 0's 112x112 map, K = 7 on stages 1-4; a fourth element is
# the K where it is not 3
SAN19_GEOMETRIES = ((16, 112, 3), (64, 56, 3, 7), (128, 28, 4, 7),
                    (256, 14, 6, 7), (512, 7, 3, 7))
# LR-Net50's (C = width, Cw = C/8 heads): a stage's first block aggregates
# at the map before its stride, which its avg-pool applies after
LRNET50_GEOMETRIES = ((64, 56, 3), (128, 56, 1), (128, 28, 3), (256, 28, 1),
                      (256, 14, 5), (512, 14, 1), (512, 7, 2))
# model -> (channel groups of its CoT layers, geometries per group, image
# size): the groups of a CoXtLayer run as images of a batch BATCH * groups
MODELS = {
    "cotnet50": (1, COTNET50_GEOMETRIES, 224),
    "cotnext50_2x48d": (2, ((48, 56, 3), (96, 28, 4), (192, 14, 6),
                            (384, 7, 3)), 224),
    "se_cotnetd_152": (1, SE_COTNETD_152_GEOMETRIES, 256),
    "san19": (1, SAN19_GEOMETRIES, 224),
    "lrnet50": (1, LRNET50_GEOMETRIES, 224),
}
# the models whose aggregation runs without the GroupNorm affine: their
# eval path launches the plain forward, and no affine kernel is on any of
# their paths
UNFOLDED_MODELS = ("san19", "lrnet50")
# the route of each kernel at K = 7, dilation 1, zero pad 3, one head and
# at most 8 channel groups: the forward, dx and dw on their k7 tiles, the
# affine dw (on no model's path there) on the general route
K7_ROUTES = {"fwd": "k7", "dx": "k7", "dw": "k7", "dw_affine": "general"}
# the route every main-path launch of the forward, dx and dw takes at a
# geometry (C, map, K) where it is not k3: SAN19's K = 7 aggregations
GEOMETRY_ROUTE = {(c, hw, 7): K7_ROUTES for c, hw, _, *k in SAN19_GEOMETRIES
                  if k == [7]}
# the kernel functions of the k7 route, as the build report and the
# profiler name them
K7_FUNCTIONS = ("local_agg_fwd_k7", "local_agg_bwd_dx_k7",
                "local_agg_bwd_dw_k7")
# what build_report read from ptxas: kernel function -> its line
PTXAS: dict = {}
# phase 13, the other comparison families: image size, and no op on their
# path
FAMILY_EVAL_MODELS = {"BoTNetS1_59": 256, "lambdanet50": 224,
                      "resnet50_dw": 224}
# the models whose main paths include path B (the fused-embed eval)
FUSED_MODELS = ("cotnet50", "cotnext50_2x48d")
TRAIN_BATCH = {"se_cotnetd_152": 64}
REPLACES = ("cotnet_tpu/ops/local_agg_pallas.py:447 _fwd_kernel, "
            ":451 _fwd_kernel_affine, :952 _fwd_chwn_kernel, "
            ":1066 _fwd_chwn_strip_kernel")
_REPLACES_FUSED_BWD = (
    "cotnet_tpu/ops/local_agg_pallas.py:1210 _bwd_chwn_strip_g_kernel, "
    ":977 _dxdw_chwn_kernel, :571 _dxdw_gather_kernel, "
    ":628 _dxdw_scatter_kernel")
REPLACES_BWD = {
    "dx": _REPLACES_FUSED_BWD + ", :481 _dx_gather_kernel, :477 _dx_kernel",
    "dw": _REPLACES_FUSED_BWD + ", :516 _dw_kernel, :548 _dw_kernel_dot, "
          ":765 _dw_wloop_kernel, :836 _dw_strip_kernel",
}
# the recipe of cot_experiments/CoTNet-50-350epoch/config.yaml
RECIPE = {
    "model": dict(drop_rate=0.25, drop_path_rate=0.1),
    "mixup": dict(mixup_alpha=0.8, cutmix_alpha=1.0, prob=1.0,
                  switch_prob=0.5, mode="batch", label_smoothing=0.1,
                  num_classes=1000),
    "loss": dict(smoothing=0.1),
    "solver": dict(opt="sgd", momentum=0.9, weight_decay=4e-5,
                   sched="cosine", lr=0.25, warmup_lr=1e-4, min_lr=1e-5,
                   epochs=350, warmup_epochs=5, decay_rate=0.1),
    "ema_decay": 0.9999,
}
# the recipe of cot_experiments/SE-CoTNetD-152_350epoch/config.yaml: drop
# path 0.15 and LR 0.2, the rest as CoTNet-50's
RECIPES = {
    "cotnet50": RECIPE,
    "cotnext50_2x48d": RECIPE,
    "se_cotnetd_152": dict(
        RECIPE, model=dict(drop_rate=0.25, drop_path_rate=0.15),
        solver=dict(RECIPE["solver"], lr=0.2)),
    # the CoTNet-50 recipe's solver, mixup and EMA; SAN's chassis has no
    # dropout or stochastic depth
    "san19": dict(RECIPE, model={}),
    "lrnet50": RECIPE,
}
REPLACES_MIX = {
    "fwd": "cotnet_tpu/ops/local_agg_pallas.py:2217 _mix_fwd_kernel",
    "dx": "cotnet_tpu/ops/local_agg_pallas.py:2233 _mix_dx_kernel",
    "dw": "cotnet_tpu/ops/local_agg_pallas.py:2248 _mix_dw_kernel",
}
# the route of every main-path launch of a kernel; "k3" where neither this
# nor GEOMETRY_ROUTE names another
MAIN_ROUTE = {"local_agg_mix_fwd": "tiles", "local_agg_mix_dx": "tiles",
              "local_agg_mix_dw": "tiles"}
REPLACES_AFFINE_BWD = {
    "dx": "cotnet_tpu/ops/local_agg_pallas.py:512 _dx_kernel_affine",
    "dw": "cotnet_tpu/ops/local_agg_pallas.py:697 _dw_kernel_affine",
}
REPLACES_EMBED_GN = "cotnet_tpu/ops/local_agg_pallas.py:1985 _fused_embed_kernel"
# the fused embed op's kernels, as the profiler names them: the statistics
# pass (not launched where a block holds whole planes) on its tiled routes
# or its pointwise one, and the aggregation on each
EMBED_GN_STATS = ("embed_gn_stats_rows", "embed_gn_stats")
EMBED_GN_AGG = ("embed_gn_agg", "embed_gn_agg_pointwise")
IMAGENET_TRAIN_IMAGES = 1281167
# phase 4, the training stack: every optimizer name of the port's
# create_optimizer but adahessian (whose second-order step refuses a model
# with the op), and the Lookahead form of one, each from the same start;
# four carry the stack's other pieces (clipping, schedules, LR noise, the
# plateau scale)
STACK_OPTIMIZERS = ("sgd", "nesterov", "momentum", "adam", "adamw", "nadam",
                    "radam", "adamp", "sgdp", "adadelta", "rmsprop",
                    "rmsproptf", "rmsprop_tf", "novograd", "nvnovograd",
                    "adafactor", "lamb", "lars", "lookahead_adamp")
STACK_SOLVERS = {
    "adamw": dict(clip_mode="agc", clip_grad=0.01, sched="tanh"),
    "lamb": dict(clip_mode="norm", clip_grad=1.0, sched="step",
                 decay_epochs=100),
    "adafactor": dict(sched="multistep", decay_milestones=[100, 200],
                      lr_noise=0.4),
    "lookahead_adamp": dict(clip_mode="value", clip_grad=0.01,
                            sched="plateau"),
}
# the recipe's LR (0.25) is SGD's: the optimizers that normalize their
# update take 1e-3, Adadelta its customary 1.0
SGD_LIKE = ("sgd", "nesterov", "momentum", "sgdp", "lars")
# the phase's first step: past the warm-up, inside the LR noise's window
STACK_EPOCH = 150
# the kernels a main path of each kind must launch once per CoT layer a
# step (16 in cotnet50 and cotnext50_2x48d, 21 in se_cotnetd_152); every
# other count, the plain versions' and the mix kernels' included, must be 0
PATH_KERNELS = {
    "eval": ("fwd_affine",),
    "eval_fused": ("embed_gn",),
    "train": ("fwd", "dx", "dw"),
    "train_fold": ("fwd_affine", "dx_affine", "dw_affine"),
}
# phase 8, the data pipeline: the train loader of
# cot_experiments/CoTNet-50-350epoch/config.yaml (its augmentation section
# and its 6 workers) at the main path's batch, over 3 batches and 16 more
# train images and 165 val images (two eval batches, the second with 37
# valid), JPEGs of ImageNet's common sizes
DATA_LOADER = dict(scale=(0.08, 1.0), ratio=(0.75, 1.333333333333),
                   hflip=0.5, auto_augment="rand-m15-mstd0.5-n2", reprob=0.0,
                   interpolation="bicubic")
DATA_WORKERS = 6
DATA_CLASSES = 10
DATA_TRAIN_IMAGES = 3 * BATCH + 16
DATA_VAL_IMAGES = 165
DATA_SIZES = ((500, 375), (375, 500))
# phase 9, the CLI: the recipe it runs, its train batch (the recipe's
# batch_size; its vbatch_size is BATCH) and the smoke run's length
CLI_RECIPE = "cot_experiments/CoTNet-50-350epoch"
CLI_BATCH = 80
CLI_STEPS = 3
CLI_EPOCHS = 2
# the batches of each model's main paths besides BATCH and TRAIN_BATCH
CLI_BATCHES = {"cotnet50": (CLI_BATCH,)}
# the resume check: 2N uninterrupted steps against N, save, restore, N
RESUME_STEPS = 2
# phase 10, data parallelism: check (b)'s global batch, ranks and steps
DP_BATCH = 128
DP_RANKS = 2
DP_STEPS = 3
# the CoTNet-50 recipe without its warm-up, so that three updates at the
# base LR move the weights well beyond rounding
DP_RECIPE = dict(RECIPE, solver=dict(RECIPE["solver"], warmup_epochs=0))
# phase 11, the plain ResNet chassis: the models, and seresnet50's timed
# train steps
CHASSIS_MODELS = ("seresnet50", "resnet18", "ecaresnet50d")
CHASSIS_TRAIN_STEPS = 3
# phase 14, the transformer core: the models of the f32 checks (at 224),
# and the bf16 main paths (model, kind, image size, batch)
TRANSFORMER_F32_MODELS = ("vit_base_patch16_224",
                          "deit_base_distilled_patch16_224",
                          "resnetv2_50x1_bitm", "resnetv2_50d",
                          "vit_base_r50_s16_224", "vit_small_resnet26d_224")
TRANSFORMER_PATHS = (("vit_base_patch16_224", "eval", 224, 128),
                     ("vit_base_patch16_224", "train", 224, 128),
                     ("resnetv2_50x1_bitm", "eval", 448, 64),
                     ("resnetv2_50x1_bitm", "train", 224, 128),
                     ("vit_base_r50_s16_384", "eval", 384, 64))
# DeiT-B's published solver (Touvron et al. 2021, "Training data-efficient
# image transformers", Table 9): AdamW at 5e-4 per 512 images, weight decay
# 0.05, cosine with 5 warm-up epochs over 300, drop path 0.1, mixup 0.8
# with cutmix 1.0, label smoothing 0.1, EMA 0.99996
DEIT_RECIPE = {
    "model": dict(drop_path_rate=0.1),
    "mixup": dict(RECIPE["mixup"]),
    "loss": dict(smoothing=0.1),
    "solver": dict(opt="adamw", weight_decay=0.05, sched="cosine",
                   lr=5e-4 * BATCH / 512, warmup_lr=1e-6, min_lr=1e-5,
                   epochs=300, warmup_epochs=5, decay_rate=0.1),
    "ema_decay": 0.99996,
}
# Swin-T's published ImageNet-1k solver (Liu et al. 2021, "Swin
# Transformer", section 4.1): AdamW at 1e-3 per 1024 images (the warm-up
# and least LRs scaled alike), weight decay 0.05, cosine over 300 epochs
# with 20 of warm-up, drop path 0.2, mixup 0.8 with cutmix 1.0, label
# smoothing 0.1, no EMA
SWIN_RECIPE = {
    "model": dict(drop_path_rate=0.2),
    "mixup": dict(RECIPE["mixup"]),
    "loss": dict(smoothing=0.1),
    "solver": dict(opt="adamw", weight_decay=0.05, sched="cosine",
                   lr=1e-3 * BATCH / 1024, warmup_lr=1e-6 * BATCH / 1024,
                   min_lr=1e-5 * BATCH / 1024, epochs=300, warmup_epochs=20,
                   decay_rate=0.1),
    "ema_decay": 0.0,
}
# ResNetV2 takes no drop path: the CoTNet-50 recipe's dropout, solver,
# mixup and EMA; XCiT trains on DeiT's solver, with drop path 0.05 at S12;
# Twins-SVT-S and Visformer-S on DeiT's solver with its drop path 0.1, a
# choice made here for one solver across the phase's two train paths, not
# either paper's own recipe
TRANSFORMER_RECIPES = {"vit_base_patch16_224": DEIT_RECIPE,
                       "resnetv2_50x1_bitm": dict(
                           RECIPE, model=dict(drop_rate=0.25)),
                       "swin_tiny_patch4_window7_224": SWIN_RECIPE,
                       "xcit_small_12_p16_224": dict(
                           DEIT_RECIPE, model=dict(drop_path_rate=0.05)),
                       "twins_svt_small": DEIT_RECIPE,
                       "visformer_small": DEIT_RECIPE}
# phase 15, the ViT-built transformers: the f32 checks (model, image size,
# batch), the model of the five f32 steps, and the bf16 main paths (model,
# kind, image size, batch)
VIT_ZOO_F32 = (("swin_tiny_patch4_window7_224", 224, 4),
               ("swin_base_patch4_window12_384", 384, 2),
               ("xcit_nano_12_p8_224", 224, 4),
               ("xcit_tiny_24_p16_224", 224, 4),
               ("cait_xxs24_224", 224, 4),
               ("pit_ti_distilled_224", 224, 4))
VIT_ZOO_STEPS_MODEL = "xcit_nano_12_p16_224"
VIT_ZOO_PATHS = (("swin_tiny_patch4_window7_224", "eval", 224, 128),
                 ("swin_tiny_patch4_window7_224", "train", 224, 128),
                 ("xcit_small_12_p16_224", "eval", 224, 128),
                 ("xcit_small_12_p16_224", "train", 224, 128),
                 ("cait_s24_224", "eval", 224, 128),
                 ("pit_b_224", "eval", 224, 128),
                 ("swin_base_patch4_window12_384", "eval", 384, 64))
# phase 16, the last ViT-built transformers: the f32 checks (model, image
# size, batch), the model of the five f32 steps, and the bf16 main paths
# (model, kind, image size, batch)
VIT_TAIL_F32 = (("convit_tiny", 224, 4), ("tnt_s_patch16_224", 224, 4),
                ("twins_pcpvt_small", 224, 4), ("visformer_tiny", 224, 4),
                ("levit_128s", 224, 4), ("coat_lite_tiny", 224, 4))
VIT_TAIL_STEPS_MODEL = "levit_128s"
VIT_TAIL_PATHS = (("twins_svt_small", "eval", 224, 128),
                  ("twins_svt_small", "train", 224, 128),
                  ("visformer_small", "eval", 224, 128),
                  ("visformer_small", "train", 224, 128),
                  ("coat_tiny", "eval", 224, 128),
                  ("levit_256", "eval", 224, 128),
                  ("convit_small", "eval", 224, 128),
                  ("tnt_s_patch16_224", "eval", 224, 128))
# phase 17, the EfficientNet superfamily: the f32 checks (model, image
# size, batch), the model of the five f32 steps (CondConv's per-sample
# backward), and the bf16 main paths (model, kind, image size, batch)
EFFNET_F32 = (("efficientnet_b0", 224, 4), ("tf_efficientnet_b0", 224, 4),
              ("mixnet_s", 224, 4), ("efficientnet_cc_b0_4e", 224, 4),
              ("efficientnet_es", 224, 4), ("mobilenetv3_large_100", 224, 4))
EFFNET_STEPS_MODEL = "efficientnet_cc_b0_4e"
EFFNET_PATHS = (("efficientnet_b0", "eval", 224, 128),
                ("efficientnet_b0", "train", 224, 128),
                ("mobilenetv3_large_100", "eval", 224, 128),
                ("mobilenetv3_large_100", "train", 224, 128),
                ("mixnet_m", "eval", 224, 128),
                ("efficientnet_cc_b0_4e", "eval", 224, 128))
# timm's README, "Training Examples", its efficientnet_b0 line (2 cards x
# 384 images): RMSpropTF with eps 1e-3 and momentum 0.9 (train.py's
# default), weight decay 1e-5, LR 0.048 per 768 images scaled to the
# batch, a step schedule decaying 0.97 every 2.4 epochs over 450, warm-up
# from 1e-6 over train.py's default 3 epochs, dropout 0.2, drop path
# ("drop-connect") 0.2, EMA 0.9999, label smoothing 0.1 (train.py's
# default), no mixup; its mobilenetv3_large_100 line (2 x 512 images):
# LR 0.064 per 1024 images, decay 0.973 over 600 epochs, LR noise over
# epochs 0.42 to 0.9 of them, the rest the same
EFFNET_RECIPE = {
    "model": dict(drop_rate=0.2, drop_path_rate=0.2),
    "mixup": None,
    "loss": dict(smoothing=0.1),
    "solver": dict(opt="rmsproptf", opt_eps=1e-3, momentum=0.9,
                   weight_decay=1e-5, sched="step", lr=0.048 * BATCH / 768,
                   warmup_lr=1e-6, warmup_epochs=3, epochs=450,
                   decay_epochs=2.4, decay_rate=0.97),
    "ema_decay": 0.9999,
}
MNV3_RECIPE = dict(EFFNET_RECIPE, solver=dict(
    EFFNET_RECIPE["solver"], lr=0.064 * BATCH / 1024, epochs=600,
    decay_rate=0.973, lr_noise=(0.42, 0.9)))
TRANSFORMER_RECIPES.update({"efficientnet_b0": EFFNET_RECIPE,
                            "mobilenetv3_large_100": MNV3_RECIPE})
# phase 18, the CNN tail: the f32 checks (model, image size, batch), the
# model of the five f32 steps (PSConv's masked weight), and the bf16 main
# paths (model, kind, image size, batch); the two train paths under the
# CoTNet-50 recipe, densenet121 without drop path
CNN_TAIL_F32 = (("resnest14d", 224, 4), ("skresnet18", 224, 4),
                ("skresnext50_32x4d", 224, 4), ("res2net50_26w_4s", 224, 4),
                ("resnet_rs50", 224, 4), ("psresnet50", 224, 4),
                ("regnety_002", 224, 4), ("densenetblur121d", 224, 4),
                ("rexnet_100", 224, 4), ("xception", 299, 4))
CNN_TAIL_STEPS_MODEL = "psresnet50"
CNN_TAIL_PATHS = (("resnest50d", "eval", 224, 128),
                  ("resnest50d", "train", 224, 128),
                  ("skresnext50_32x4d", "eval", 224, 128),
                  ("res2net50_26w_4s", "eval", 224, 128),
                  ("resnet_rs50", "eval", 224, 128),
                  ("psresnet50", "eval", 224, 128),
                  ("regnety_032", "eval", 224, 128),
                  ("densenet121", "eval", 224, 128),
                  ("densenet121", "train", 224, 128),
                  ("rexnet_100", "eval", 224, 128),
                  ("xception", "eval", 299, 128))
TRANSFORMER_RECIPES.update({"resnest50d": RECIPE,
                            "densenet121": dict(
                                RECIPE, model=dict(drop_rate=0.25))})
# phase 19, the layer tail: each piece at bs128 on 56x56 maps of 256
# channels (a cotnet50 stage-1 bottleneck's output), the classifier of
# test_time_pool to ImageNet's 1000 classes; the f32 tolerance of the convs
# (a sum of 256 to 2304 products in cuDNN's order against oneDNN's)
LAYER_TAIL_SHAPE = (BATCH, 256, 56, 56)
LAYER_TAIL_CLASSES = 1000
LAYER_TAIL_CONV_RTOL = 1e-4
LAYER_TAIL_RTOL = 1e-5


def log(*args):
    print(*args, flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def device_ms(fn, runs: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn()`` in ms over ``runs`` CUDA-event timed
    calls.  Before each call the L2 is flushed and the stream is held busy
    with a spin, so the timed window holds the device work only, started
    cold, and not the host's time to enqueue it."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_ms_by_name(fn, names, runs: int = 20, warmup: int = 3) -> dict:
    """Device time a call of ``fn()`` spends in the kernels of each name
    (a template's name ends at its "<", any other at its "("), in ms: under
    torch.profiler over ``runs`` cold-L2 calls as ``device_ms`` makes them,
    the total by name over ``runs``.  None where the profiler recorded no
    device time at all (not measured)."""
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            flush.zero_()
            torch.cuda._sleep(2_000_000)
            fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    if not rows:
        return {name: None for name in names}
    return {name: sum(ms for key, ms in rows
                      if f"{name}<" in key or f"{name}(" in key) / runs
            for name in names}


def copy_rate() -> float:
    """Device memory rate in bytes/s, measured: a 1 GiB device-to-device
    copy reads and writes 1 GiB each."""
    src = torch.empty(1 << 30, dtype=torch.uint8, device="cuda")
    dst = torch.empty_like(src)
    ms = device_ms(lambda: dst.copy_(src), runs=10)
    return 2 * src.numel() / (ms * 1e-3)


def bounds_ms(nbytes: int, flops: int, matmul_flops: int = 0,
              matmul_dtype=torch.float32) -> tuple:
    """(bound ms, 'bytes' or 'operations') at the data-sheet rates: the
    bytes, or the f32 operations plus those of a matrix product at the
    rate of its operands' type, whichever takes longer."""
    bounds = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
              "operations": (flops / F32_FLOPS_PER_S + matmul_flops
                             / MATMUL_FLOPS_PER_S[matmul_dtype]) * 1e3}
    by = max(bounds, key=bounds.get)
    return bounds[by], by


def tolerance(dtype, ref) -> tuple:
    """(rtol, atol) of a kernel against its plain version."""
    if dtype == torch.float32:
        # only the summation order differs
        return 1e-5, 1e-5
    # both sides sum in f32 from the same 16-bit inputs and round once: at
    # most 1 bf16 ulp of the reference apart
    return 8e-3, 1e-3 * float(ref.float().abs().max())


def check_close(what, got, ref, dtype) -> tuple:
    """Raise unless ``got`` is within the tolerance of ``ref``; returns
    (max |err|, rtol, atol)."""
    rtol, atol = tolerance(dtype, ref)
    err = (got.float() - ref.float()).abs()
    bad = int((err > atol + rtol * ref.float().abs()).sum())
    if bad:
        raise AssertionError(f"kernel != plain at {what}: {bad} elements, "
                             f"max |err| {float(err.max())}")
    return float(err.max()), rtol, atol


def kernel_cases() -> list:
    cases = []
    for name, (groups, geometries, _) in MODELS.items():
        for batch in sorted({BATCH, TRAIN_BATCH.get(name, BATCH),
                             *CLI_BATCHES.get(name, ())}, reverse=True):
            for c, hw, _, *k in geometries:
                k = k[0] if k else 3
                case = dict(n=batch * groups, c=c, h=hw, w=hw, heads=1,
                            cw=c // 8, k=k, dil=1, pad_mode="zeros",
                            dtype=torch.bfloat16)
                if (c, hw, k) in GEOMETRY_ROUTE:
                    case["main_route"] = GEOMETRY_ROUTE[(c, hw, k)]
                if name in UNFOLDED_MODELS:
                    # no main path of these models runs the affine
                    case["affine"] = False
                if not any(_same_case(case, other) for other in cases):
                    cases.append(case)
    for k in (5, 7):
        cases.append(dict(n=4, c=32, h=13, w=11, heads=2, cw=8, k=k, dil=2,
                          pad_mode="zeros", dtype=torch.float32,
                          route="general"))
    # the k7 forward, dx and dw: SAN19's four K = 7 maps in f32, then the
    # edges of their tiles (an odd map whose width is no multiple of the
    # four positions of a thread, in both dtypes; N = 1; two groups on a
    # map smaller than a tile) and 16 groups, which they refuse (general)
    for c, hw, _, *k in SAN19_GEOMETRIES:
        if k == [7]:
            cases.append(dict(n=32, c=c, h=hw, w=hw, heads=1, cw=c // 8,
                              k=7, dil=1, pad_mode="zeros",
                              dtype=torch.float32, route=K7_ROUTES))
    for n, c, cw, h, w, dt in ((2, 64, 8, 13, 11, torch.bfloat16),
                               (2, 64, 8, 13, 11, torch.float32),
                               (3, 40, 5, 17, 23, torch.float32),
                               (1, 64, 8, 56, 56, torch.bfloat16),
                               (2, 16, 8, 5, 5, torch.float32)):
        cases.append(dict(n=n, c=c, h=h, w=w, heads=1, cw=cw, k=7, dil=1,
                          pad_mode="zeros", dtype=dt, route=K7_ROUTES))
    cases.append(dict(n=2, c=64, h=14, w=14, heads=1, cw=4, k=7, dil=1,
                      pad_mode="zeros", dtype=torch.bfloat16,
                      route="general"))
    cases.append(dict(n=8, c=64, h=14, w=14, heads=1, cw=8, k=3, dil=1,
                      pad_mode="reflect", dtype=torch.float32))
    # the edges of the forward's and dx's row tiles and vectors: a map
    # smaller than one tile, a height no multiple of the tile, an odd width
    # with Cw no multiple of the vector width, N = 1
    for n, c, cw, h, w in ((2, 64, 8, 3, 3), (2, 64, 8, 57, 57),
                           (4, 48, 6, 13, 11), (1, 64, 8, 56, 56)):
        cases.append(dict(n=n, c=c, h=h, w=w, heads=1, cw=cw, k=3, dil=1,
                          pad_mode="zeros", dtype=torch.bfloat16))
    # the geometries the halo tiles do not take, which the forward, dx and
    # dw run on their pointwise route: a row of more than 512 thread items
    # in the general instantiation (K = 5, Wo = 513) and at K = 3 (Wo =
    # 2049), K = 9, and an f32 halo tile beyond a block's shared memory
    # (K = 7 at dilation 8 on 16x256: 49 staged rows of 304 elements, four
    # stages, 238 KB)
    for n, c, cw, h, w, k, dil, dt in (
            (1, 16, 8, 3, 513, 5, 1, torch.bfloat16),
            (1, 16, 8, 2, 2049, 3, 1, torch.bfloat16),
            (2, 16, 4, 13, 11, 9, 1, torch.bfloat16),
            (1, 16, 8, 16, 256, 7, 8, torch.float32)):
        cases.append(dict(n=n, c=c, h=h, w=w, heads=1, cw=cw, k=k, dil=dil,
                          pad_mode="zeros", dtype=dt, route="pointwise"))
    return cases


def _same_case(a: dict, b: dict) -> bool:
    """Whether two cases launch the same shapes (an affine case covers the
    same case without it)."""
    keys = set(a) | set(b)
    return all(a.get(k) == b.get(k) for k in keys - {"affine"})


def route(la, kernel: str, cs, x, w, pad: int) -> str:
    """The route (``k3``, ``k7``, ``general`` or ``pointwise``) that the
    launcher of ``kernel`` (fwd, dx, dw or dw_affine) takes for x and w with
    the kernel's own padding, as the kernel's library decides it; raises
    unless it is the case's own (``route``, where the case names one: one
    for every kernel, or a dict by kernel)."""
    k, dil = cs["k"], cs["dil"]
    got = la.kernel_route(kernel, x, w, kernel_size=(k, k),
                          dilation=(dil, dil), padding=(pad, pad))
    want = cs.get("route", got)
    if isinstance(want, dict):
        want = want[kernel]
    if got != want:
        raise AssertionError(f"{kernel} at {describe(cs, pad)} took the "
                             f"{got} route, not {want}")
    return got


def main_route(cs, kernel: str) -> dict:
    """The entry's ``main_route`` key: the route the launches of
    ``kernel`` on a main path must take where it is not k3
    (``GEOMETRY_ROUTE``)."""
    return ({"main_route": cs["main_route"][kernel]} if "main_route" in cs
            else {})


def k7_checks(what: str, again, got, ref, dtype) -> dict:
    """A k7 entry's extra checks: a second launch (``again()``) gives the
    same bits; in f32, max|err| within 1e-5 of the reference's largest.
    Returns the entry's keys for them."""
    if not torch.equal(again(), got):
        raise AssertionError(f"k7 at {what}: a second launch gave other "
                             "bits")
    scale = float(ref.float().abs().max())
    err = float((got.float() - ref.float()).abs().max())
    if dtype == torch.float32 and not err <= 1e-5 * scale:
        raise AssertionError(f"k7 at {what}: f32 max|err| {err} beyond "
                             f"1e-5 of the largest {scale}")
    return {"deterministic": True, "err_of_max": err / scale}


# the kernels' template argument of each dtype, as ptxas names it
PTXAS_TYPES = {torch.float32: "float", torch.float16: "__half",
               torch.bfloat16: "__nv_bfloat16"}


def ptxas_note(variant: str, name: str, w, affine: bool) -> dict:
    """The build report's ptxas lines, where build_report read them, for
    the k7 instantiation that a launch on weight ``w`` runs (for dw, ``w``
    is dw: its pieces are the widest of 4, 2 or 1 elements that w's
    address, a row and a tap plane are multiples of, as the launcher picks
    them) and for the general one of the same dtype and affine (dw's
    instantiations have no affine argument)."""
    if variant != "k7":
        return {}
    elem, (ho, wo) = w.element_size(), w.shape[-2:]
    piece = 4 * elem
    while piece > elem and (w.data_ptr() % piece or wo * elem % piece
                            or ho * wo * elem % piece):
        piece //= 2
    args = PTXAS_TYPES[w.dtype]
    if not name.endswith("_dw"):
        args += f", {str(affine).lower()}"
    return {"ptxas": PTXAS.get(f"{name}_k7<{args}, {piece}>", "not measured"),
            "ptxas_general": PTXAS.get(f"{name}<{args}, 0>", "not measured")}


def describe(cs, pad, affine=False) -> str:
    return (f"N={cs['n']} C={cs['c']} {cs['h']}x{cs['w']} "
            f"heads={cs['heads']} Cw={cs['cw']} K={cs['k']} dil={cs['dil']} "
            f"pad={pad} {cs['pad_mode']} "
            f"{str(cs['dtype']).replace('torch.', '')}"
            f"{' affine' if affine else ''}")


def new_key(counts: dict, before: dict):
    """The one key of ``counts`` that grew by one since ``before``."""
    new = [key for key, count in counts.items()
           if count != before.get(key, 0)]
    if len(new) != 1 or counts[new[0]] != before.get(new[0], 0) + 1:
        raise AssertionError("the kernel did not launch once")
    return new[0]


def launch_snapshot(la) -> dict:
    """The wrappers' counts as they stand: ``by_key`` maps (kernel, launch
    key) to launches, with the kernel named fwd, dx, dw (``_affine`` added
    where the GroupNorm affine was folded in) or embed_gn; ``plain`` is the
    number of calls of any plain version."""
    by_key = {}
    for key, count in la.LAUNCHES_BY_SHAPE.items():
        by_key[("fwd_affine" if key[1] else "fwd", key)] = count
    for (kernel, key), count in la.BWD_LAUNCHES_BY_SHAPE.items():
        by_key[(kernel + ("_affine" if key[1] else ""), key)] = count
    for key, count in la.EMBED_GN_LAUNCHES_BY_SHAPE.items():
        by_key[("embed_gn", key)] = count
    for (kernel, key), count in la.MIX_LAUNCHES_BY_SHAPE.items():
        by_key[("mix_" + kernel, key)] = count

    def total(*kernels):
        return sum(c for (k, _), c in by_key.items() if k in kernels)

    # the totals and the counts by shape are kept apart in the wrappers
    if (la.LAUNCHES, la.BWD_LAUNCHES, la.AFFINE_BWD_LAUNCHES,
            la.EMBED_GN_LAUNCHES, la.MIX_LAUNCHES) != (
            total("fwd", "fwd_affine"),
            {"dx": total("dx"), "dw": total("dw")},
            {"dx": total("dx_affine"), "dw": total("dw_affine")},
            total("embed_gn"),
            {k: total("mix_" + k) for k in ("fwd", "dx", "dw")}):
        raise AssertionError("launch totals disagree with the counts by "
                             "shape")
    return {"by_key": by_key,
            "plain": (la.PLAIN_CALLS + la.PLAIN_BWD_CALLS
                      + la.PLAIN_EMBED_GN_CALLS + la.PLAIN_MIX_CALLS)}


class PathCounts:
    """What each main path launched: (kernel, launch key) -> {path label:
    (launches, steps of that path's run)}."""

    def __init__(self):
        self.by_key = {}

    def record(self, la, label: str, steps: int) -> dict:
        """Read the counts a main path's run left; returns the snapshot."""
        return self.record_snapshot(launch_snapshot(la), label, steps)

    def record_snapshot(self, snapshot: dict, label: str, steps: int) -> dict:
        for key, count in snapshot["by_key"].items():
            self.by_key.setdefault(key, {})[label] = (count, steps)
        return snapshot

    def entry(self, kernel: str, key) -> dict:
        """The ``launches`` keys of a kernel entry."""
        by_path = self.by_key.get((kernel, key), {})
        return {"launches": sum(c for c, _ in by_path.values()),
                "launches_by_path": {
                    label: {"launches": c, "steps": n}
                    for label, (c, n) in by_path.items()}}


def path_kernels_of(model_name: str, kind: str) -> tuple:
    """The kernels a main path of ``kind`` launches once per aggregation a
    step: ``PATH_KERNELS``, but the plain forward where a model's eval
    folds no GroupNorm."""
    if kind == "eval" and model_name in UNFOLDED_MODELS:
        return ("fwd",)
    return PATH_KERNELS[kind]


def check_path_launches(snapshot: dict, kind: str, model_name: str,
                        steps: int, batch: int = BATCH):
    """Raise unless a main path's run launched exactly the kernels of its
    kind, each once per CoT layer and step at the model's bf16 geometries
    at ``batch``, no other kernel of the op (the mix kernels included), and
    called no plain version."""
    groups, geometries, _ = MODELS[model_name]
    want = {(c, hw): per_step * steps for c, hw, per_step, *_ in geometries}
    path_kernels = path_kernels_of(model_name, kind)
    kernels = {kernel for kernel, _ in snapshot["by_key"]}
    for kernel in kernels | set(path_kernels):
        got = {}
        for (kern, key), count in snapshot["by_key"].items():
            if kern != kernel:
                continue
            if kernel not in path_kernels:
                raise AssertionError(f"{model_name} {kind}: {kernel} "
                                     f"launched {count} times at {key}")
            if kernel == "embed_gn":
                dtype, (n, c, h, w), _, key_groups, *_ = key
                n, c = n * key_groups, c // key_groups
            else:
                dtype, _, (n, c, h, w), *_ = key
            if not (dtype == "bfloat16" and n == batch * groups and h == w):
                raise AssertionError(f"{model_name} {kind}: {kernel} "
                                     f"launched at {key}")
            got[(c, h)] = got.get((c, h), 0) + count
        if got != (want if kernel in path_kernels else {}):
            raise AssertionError(f"{model_name} {kind}: {kernel} launches by "
                                 f"(C, map) {got} in {steps} steps")
    if snapshot["plain"]:
        raise AssertionError(f"{model_name} {kind}: {snapshot['plain']} "
                             "calls of a plain version")


def kernel_phase(la, hbm_rate: float, paths: PathCounts) -> list:
    """Forward kernel vs plain version on the card; returns the kernel
    entries.  ``hbm_rate`` is the measured copy rate, for a second byte
    bound; ``paths`` holds what the main paths launched."""
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, dtype=torch.float32, scale=1.0, shift=0.0):
        t = torch.randn(*shape, generator=gen, device="cuda") * scale + shift
        return t.to(dtype)

    entries = []
    for cs in kernel_cases():
        for affine in ((True,) if cs["pad_mode"] == "reflect"
                       else (False, True) if cs.get("affine", True)
                       else (False,)):
            n, c, h, w, heads, cw, k = (cs[key] for key in (
                "n", "c", "h", "w", "heads", "cw", "k"))
            dt, dil = cs["dtype"], cs["dil"]
            pad = (dil * (k - 1) + 1) // 2
            x = randn(n, c, h, w, dtype=dt)
            wt = randn(n, heads, cw, k * k, h, w, dtype=dt)
            # what the kernel sees: a reflect pad is made outside it
            xk, kpad = x, pad
            if cs["pad_mode"] == "reflect":
                xk = x.new_empty(n, c, h + 2 * pad, w + 2 * pad,
                                 device="meta")
                kpad = 0
            s = b = None
            if affine:
                s = randn(n, heads, cw, k * k, scale=0.5, shift=1.0)
                b = randn(n, heads, cw, k * k, scale=0.5)
            kw = dict(kernel_size=k, padding=pad, dilation=dil,
                      pad_mode=cs["pad_mode"], w_scale=s, w_bias=b)
            before = dict(la.LAUNCHES_BY_SHAPE)
            with torch.no_grad():
                got = la.local_aggregate(x, wt, impl="hopper", **kw)
                torch.cuda.synchronize()
                launches = paths.entry(
                    "fwd_affine" if affine else "fwd",
                    new_key(la.LAUNCHES_BY_SHAPE, before))
                ref = la.local_aggregate(x, wt, impl="torch", **kw)
                geometry = describe(cs, pad, affine)
                max_err, rtol, atol = check_close(geometry, got, ref, dt)
                variant = route(la, "fwd", cs, xk, wt, kpad)
                extra = {}
                if variant == "k7":
                    extra = k7_checks(geometry, lambda: la.local_aggregate(
                        x, wt, impl="hopper", **kw), got, ref, dt)
                ms = device_ms(lambda: la.local_aggregate(
                    x, wt, impl="hopper", **kw))
                plain_ms = device_ms(lambda: la.local_aggregate(
                    x, wt, impl="torch", **kw))
            item = x.element_size()
            nbytes = (x.numel() + wt.numel() + got.numel()) * item
            if s is not None:
                nbytes += (s.numel() + b.numel()) * 4
            # a multiply and an add per tap, and w*s + b once per weight
            flops = 2 * got.numel() * k * k + (2 * wt.numel() if affine
                                               else 0)
            bound, bound_by = bounds_ms(nbytes, flops)
            entries.append({
                "name": "local_agg_fwd", "route": "cuda",
                "source": "cotnet_tpu_torch/ops/csrc/local_agg_fwd.cu",
                "replaces": REPLACES, "geometry": geometry,
                "variant": variant, **main_route(cs, "fwd"), **launches,
                "max_abs_err": max_err, "tol": {"rtol": rtol, "atol": atol},
                **extra, **ptxas_note(variant, "local_agg_fwd", wt, affine),
                "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound, "bound_by": bound_by,
                "bound_ms_at_copy_rate": nbytes / hbm_rate * 1e3,
                "library_ms": None})
            log_entry(entries[-1])
    return entries


def log_entry(e):
    variant_note = f" ({e['variant']})" if "variant" in e else ""
    if "pointwise_ms" in e:
        variant_note += (f" [pointwise route {e['pointwise_ms']:.4f} ms"
                         + (f", same bits: {e['same_bits_as_pointwise']}"
                            if "same_bits_as_pointwise" in e else "") + "]")
    log(f"kernel {e['name']}{variant_note} {e['geometry']}: max|err| "
        f"{e['max_abs_err']:.3g} (rtol {e['tol']['rtol']}, atol "
        f"{e['tol']['atol']:.3g}); kernel {e['ms']:.4f} ms, plain "
        f"{e['plain_ms']:.4f} ms, bound {e['bound_ms']:.4f} ms "
        f"({e['bound_by']}; {100 * e['bound_ms'] / e['ms']:.1f}% of it), "
        f"{e['bound_ms_at_copy_rate']:.4f} ms at the copy rate; "
        f"{e['launches']} launches in the main paths")
    if "ptxas" in e:
        log(f"  ptxas {e['name']} k7: {e['ptxas']}; general: "
            f"{e['ptxas_general']}")


def valid_taps(size_in, size_out, k, pad, dil) -> int:
    """Along one axis: the (output position, tap) pairs whose input
    position lies inside the image."""
    return sum(1 for o in range(size_out) for i in range(k)
               if 0 <= o - pad + i * dil < size_in)


def bwd_kernel_phase(la, hbm_rate: float, paths: PathCounts) -> list:
    """The two backward kernels vs the plain backward on the card; returns
    their entries."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(1)

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    entries = []
    for cs in kernel_cases():
        n, c, h, w, heads, cw, k = (cs[key] for key in (
            "n", "c", "h", "w", "heads", "cw", "k"))
        dt, dil = cs["dtype"], cs["dil"]
        pad = (dil * (k - 1) + 1) // 2
        x = randn(n, c, h, w, dtype=dt)
        wt = randn(n, heads, cw, k * k, h, w, dtype=dt)
        dy = randn(n, heads * c, h, w, dtype=dt)
        geometry = describe(cs, pad)
        if cs["pad_mode"] == "reflect":
            # through autograd: the reflect pad is differentiated outside
            # the op, the kernels see the padded input with no pad of
            # their own
            grads = {}
            for impl in ("hopper", "torch"):
                xg, wg = x.clone().requires_grad_(), wt.clone().requires_grad_()
                out = la.local_aggregate(xg, wg, kernel_size=k, padding=pad,
                                         dilation=dil, pad_mode="reflect",
                                         impl=impl)
                grads[impl] = torch.autograd.grad(out, (xg, wg), dy)
            for name, got, ref in zip(("dx", "dw"), *grads.values()):
                check_close(f"{geometry} autograd {name}", got, ref, dt)
            x, kpad = F.pad(x, (pad,) * 4, mode="reflect"), 0
        else:
            kpad = pad
        xp = F.pad(x, (kpad,) * 4)
        hi, wi = x.shape[2:]
        geo = dict(kernel_size=(k, k), dilation=(dil, dil),
                   padding=(kpad, kpad))
        pairs = (valid_taps(hi, h, k, kpad, dil)
                 * valid_taps(wi, w, k, kpad, dil))
        for kernel in ("dx", "dw"):
            need = dict(need_dx=kernel == "dx", need_dw=kernel == "dw")
            pick = 0 if kernel == "dx" else 1
            before = dict(la.BWD_LAUNCHES_BY_SHAPE)
            got = la.local_aggregate_bwd_hopper(x, wt, dy, **geo, **need)[pick]
            torch.cuda.synchronize()
            launches = paths.entry(
                kernel, new_key(la.BWD_LAUNCHES_BY_SHAPE, before)[1])
            ref = la.local_aggregate_bwd_plain(xp, wt, dy, (k, k), (dil, dil),
                                               **need)[pick]
            if kernel == "dx":
                ref = ref[..., kpad:kpad + hi, kpad:kpad + wi]
            max_err, rtol, atol = check_close(f"{geometry} {kernel}", got,
                                              ref, dt)
            variant = route(la, kernel, cs, x, wt, kpad)
            extra = {}
            if variant == "k7":
                extra = k7_checks(
                    f"{geometry} {kernel}",
                    lambda: la.local_aggregate_bwd_hopper(
                        x, wt, dy, **geo, **need)[pick], got, ref, dt)
            ms = device_ms(lambda: la.local_aggregate_bwd_hopper(
                x, wt, dy, **geo, **need))
            plain_ms = device_ms(lambda: la.local_aggregate_bwd_plain(
                xp, wt, dy, (k, k), (dil, dil), **need))
            # dx reads w and dy and writes dx; dw reads x and dy and writes
            # dw; a multiply and an add per (channel, head, in-image tap)
            other = wt if kernel == "dx" else x
            nbytes = (other.numel() + dy.numel() + got.numel()) \
                * x.element_size()
            flops = 2 * n * heads * c * pairs
            bound, bound_by = bounds_ms(nbytes, flops)
            entries.append({
                "name": f"local_agg_bwd_{kernel}", "route": "cuda",
                "source": "cotnet_tpu_torch/ops/csrc/local_agg_bwd.cu",
                "replaces": REPLACES_BWD[kernel], "geometry": geometry,
                "variant": variant, **main_route(cs, kernel), **launches,
                "max_abs_err": max_err, "tol": {"rtol": rtol, "atol": atol},
                **extra,
                **ptxas_note(variant, f"local_agg_bwd_{kernel}",
                             wt if kernel == "dx" else got, False),
                "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound, "bound_by": bound_by,
                "bound_ms_at_copy_rate": nbytes / hbm_rate * 1e3,
                "library_ms": None})
            log_entry(entries[-1])
    return entries


def check_sums(what, got, ref, factor: float = 1.0) -> float:
    """ds and db are f32 sums over Ho*Wo positions of f32 terms that kernel
    and plain version form alike; only the order of the sum differs (a
    thread's stride, a warp's butterfly, the warps in turn, against
    torch's own).  So they are held as a whole: ``max|err| <= factor *
    1e-5 * max|ref|``; the largest ratio seen at any geometry is 3e-7.
    Returns max|err|."""
    err = float((got - ref).abs().max())
    if not err <= factor * 1e-5 * float(ref.abs().max()):
        raise AssertionError(f"kernel != plain at {what}: max|err| {err}, "
                             f"max|ref| {float(ref.abs().max())}")
    return err


def affine_bwd_kernel_phase(la, hbm_rate: float, paths: PathCounts) -> list:
    """The two backward kernels of the aggregation with the folded affine
    (dx; dw with ds and db) vs the plain affine backward on the card;
    returns their entries."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(8)

    def randn(*shape, dtype=torch.float32, scale=1.0, shift=0.0):
        t = torch.randn(*shape, generator=gen, device="cuda") * scale + shift
        return t.to(dtype)

    entries = []
    for cs in kernel_cases():
        if not cs.get("affine", True):
            continue
        n, c, h, w, heads, cw, k = (cs[key] for key in (
            "n", "c", "h", "w", "heads", "cw", "k"))
        dt, dil = cs["dtype"], cs["dil"]
        pad = (dil * (k - 1) + 1) // 2
        x = randn(n, c, h, w, dtype=dt)
        wt = randn(n, heads, cw, k * k, h, w, dtype=dt)
        s = randn(n, heads, cw, k * k, scale=0.5, shift=1.0)
        b = randn(n, heads, cw, k * k, scale=0.5)
        dy = randn(n, heads * c, h, w, dtype=dt)
        geometry = describe(cs, pad, affine=True)
        if cs["pad_mode"] == "reflect":
            # through autograd: the reflect pad is differentiated outside
            # the op, the kernels see the padded input
            grads = {}
            for impl in ("hopper", "torch"):
                leaves = [t.clone().requires_grad_() for t in (x, wt, s, b)]
                out = la.local_aggregate(
                    leaves[0], leaves[1], kernel_size=k, padding=pad,
                    dilation=dil, pad_mode="reflect", impl=impl,
                    w_scale=leaves[2], w_bias=leaves[3])
                grads[impl] = torch.autograd.grad(out, leaves, dy)
            for name, got, ref in zip(("dx", "dw"), *grads.values()):
                check_close(f"{geometry} autograd {name}", got, ref, dt)
            for name, got, ref in zip(("ds", "db"), grads["hopper"][2:],
                                      grads["torch"][2:]):
                check_sums(f"{geometry} autograd {name}", got, ref)
            x, kpad = F.pad(x, (pad,) * 4, mode="reflect"), 0
        else:
            kpad = pad
        xp = F.pad(x, (kpad,) * 4)
        hi, wi = x.shape[2:]
        geo = dict(kernel_size=(k, k), dilation=(dil, dil),
                   padding=(kpad, kpad))
        pairs = (valid_taps(hi, h, k, kpad, dil)
                 * valid_taps(wi, w, k, kpad, dil))
        item = x.element_size()
        for kernel in ("dx", "dw"):
            need = dict(need_dx=kernel == "dx", need_dw=kernel == "dw")
            before = dict(la.BWD_LAUNCHES_BY_SHAPE)
            got = la.local_aggregate_bwd_affine_hopper(x, wt, s, b, dy, **geo,
                                                       **need)
            torch.cuda.synchronize()
            launches = paths.entry(
                f"{kernel}_affine",
                new_key(la.BWD_LAUNCHES_BY_SHAPE, before)[1])
            ref = la.local_aggregate_bwd_affine_plain(
                xp, wt, s, b, dy, (k, k), (dil, dil), **need)
            extra = {}
            if kernel == "dx":
                ref_dx = ref[0][..., kpad:kpad + hi, kpad:kpad + wi]
                max_err, rtol, atol = check_close(f"{geometry} dx", got[0],
                                                  ref_dx, dt)
                if route(la, "dx", cs, x, wt, kpad) == "k7":
                    extra = k7_checks(
                        f"{geometry} dx",
                        lambda: la.local_aggregate_bwd_affine_hopper(
                            x, wt, s, b, dy, **geo, **need)[0], got[0],
                        ref_dx, dt)
                # reads w, dy, s and b, writes dx; per (channel, head,
                # in-image tap) a multiply and an add, and w*s + b once per
                # weight
                nbytes = (wt.numel() + dy.numel() + x.numel()) * item \
                    + (s.numel() + b.numel()) * 4
                flops = 2 * n * heads * c * pairs + 2 * wt.numel()
            else:
                max_err, rtol, atol = check_close(f"{geometry} dw", got[1],
                                                  ref[1], dt)
                # a second launch gives the same bits: ds and db are summed
                # in a fixed order, across a plane's row tiles too
                again = la.local_aggregate_bwd_affine_hopper(
                    x, wt, s, b, dy, **geo, **need)
                if not all(torch.equal(a, g)
                           for a, g in zip(again[1:], got[1:])):
                    raise AssertionError(f"affine dw at {geometry}: a second "
                                         "launch gave other bits")
                # ds's and db's partial sums across a plane's row tiles,
                # written once and read once (0: one tile a plane)
                part = la.dw_affine_workspace_bytes(x, wt, **geo)
                extra = {"ds_max_abs_err": check_sums(f"{geometry} ds",
                                                      got[2], ref[2]),
                         "db_max_abs_err": check_sums(f"{geometry} db",
                                                      got[3], ref[3]),
                         "sums_tol": "1e-5 * max|ref|",
                         "deterministic": True, "workspace_bytes": part,
                         "bound_ms_with_workspace": (
                             ((x.numel() + dy.numel() + 2 * wt.numel())
                              * item + 3 * s.numel() * 4 + 2 * part)
                             / HBM_BYTES_PER_S * 1e3)}
                # reads x, dy, w and s, writes dw, ds and db; the group sum
                # per in-image tap, then gn*s, gn*w summed and gn summed
                nbytes = (x.numel() + dy.numel() + 2 * wt.numel()) * item \
                    + 3 * s.numel() * 4
                flops = 2 * n * heads * c * pairs + 4 * wt.numel()
            ms = device_ms(lambda: la.local_aggregate_bwd_affine_hopper(
                x, wt, s, b, dy, **geo, **need))
            plain_ms = device_ms(lambda: la.local_aggregate_bwd_affine_plain(
                xp, wt, s, b, dy, (k, k), (dil, dil), **need))
            bound, bound_by = bounds_ms(nbytes, flops)
            entries.append({
                "name": f"local_agg_bwd_{kernel}_affine", "route": "cuda",
                "source": "cotnet_tpu_torch/ops/csrc/local_agg_bwd.cu",
                "replaces": REPLACES_AFFINE_BWD[kernel], "geometry": geometry,
                "variant": route(la, "dx" if kernel == "dx" else "dw_affine",
                                 cs, x, wt, kpad),
                **launches, "max_abs_err": max_err,
                "tol": {"rtol": rtol, "atol": atol}, **extra,
                "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound, "bound_by": bound_by,
                "bound_ms_at_copy_rate": nbytes / hbm_rate * 1e3,
                "library_ms": None})
            log_entry(entries[-1])
    return entries


def embed_gn_cases() -> list:
    """x ``[n, c, h, w]``, w_pre ``[n, cp, h, w]`` as the models call the
    fused op (cp = c/2, Cw = c/8 over all groups), then general f32 cases.
    ``stats_check``: the cases whose planes span several row tiles, where
    ``stats_totals_check`` holds the statistics pass against the pointwise
    route's."""
    cases = []
    for name in FUSED_MODELS:
        groups, geometries, _ = MODELS[name]
        for c, hw, _ in geometries:
            cases.append(dict(n=BATCH, c=c * groups, cp=c * groups // 2,
                              h=hw, w=hw, k=3, dil=1, groups=groups,
                              dtype=torch.bfloat16, stats_check=hw == 56))
    cases.append(dict(n=3, c=32, cp=24, h=13, w=11, k=5, dil=2, groups=1,
                      dtype=torch.float32))
    cases.append(dict(n=2, c=16, cp=40, h=6, w=5, k=7, dil=1, groups=1,
                      dtype=torch.float32))
    cases.append(dict(n=4, c=96, cp=48, h=9, w=14, k=3, dil=1, groups=2,
                      dtype=torch.float32))
    # the edges of the aggregation's halo tiles (as the forward's): a map
    # smaller than one tile, planes over several row tiles with a height no
    # multiple of the tile (57x57: the statistics kernel runs), an odd width
    # with Cw no multiple of the vector width, N = 1; whole 7x7 planes at
    # cotnet50's Cp = 256, several to a block; and a geometry beyond the
    # tiles (a row of 513 thread items), which must take the pointwise route
    for dt in (torch.bfloat16, torch.float32):
        for n, c, cw, h, w in ((2, 64, 8, 3, 3), (2, 64, 8, 57, 57),
                               (4, 48, 6, 13, 11), (1, 64, 8, 56, 56)):
            cases.append(dict(n=n, c=c, cp=c // 2, cw=cw, h=h, w=w, k=3,
                              dil=1, groups=1, dtype=dt,
                              stats_check=h >= 56))
    cases.append(dict(n=4, c=512, cp=256, h=7, w=7, k=3, dil=1, groups=1,
                      dtype=torch.bfloat16))
    cases.append(dict(n=1, c=16, cp=8, h=2, w=2049, k=3, dil=1, groups=1,
                      dtype=torch.bfloat16, route="pointwise"))
    return cases


def embed_gn_inputs(cs, gen) -> tuple:
    """Seeded inputs of an embed_gn case from the CUDA generator ``gen``:
    (x, w_pre, w2, b2, gamma, beta), the op's keyword arguments, and the
    case's description."""
    def randn(*shape, dtype=torch.float32, scale=1.0, shift=0.0):
        t = torch.randn(*shape, generator=gen, device="cuda") * scale + shift
        return t.to(dtype)

    n, c, cp, h, w, k, dil, groups = (cs[key] for key in (
        "n", "c", "cp", "h", "w", "k", "dil", "groups"))
    dt = cs["dtype"]
    pad = (dil * (k - 1) + 1) // 2
    cw = cs.get("cw", c // 8)
    f = cw * k * k
    x = randn(n, c, h, w, dtype=dt)
    w_pre = randn(n, cp, h, w, dtype=dt).relu()      # it follows a ReLU
    w2 = randn(f, cp // groups, scale=(2.0 / f) ** 0.5).to(dt)
    b2, beta = randn(f, scale=0.1), randn(f, scale=0.2)
    gamma = randn(f, scale=0.2, shift=1.0)
    kw = dict(kernel_size=k, padding=pad, dilation=dil, groups=groups)
    geometry = (f"N={n} C={c} Cp={cp} {h}x{w} groups={groups} "
                f"Cw={cw} K={k} dil={dil} pad={pad} "
                f"{str(dt).replace('torch.', '')}")
    return (x, w_pre, w2, b2, gamma, beta), kw, geometry


def stats_totals_check(la, cs, geometry) -> dict:
    """The statistics pass of the case's route (``embed_gn_stats_rows``)
    against the pointwise route's (``embed_gn_stats``) on the same inputs,
    in the case's dtype and, for a bf16 case, in f32 too: each plane's
    totals (sum over its tiles' partial sums) of w_raw and w_raw^2 within
    ``1e-6 * max|ref|`` (f32 sums in another order); then on integer-valued
    w_pre, w2 and b2 small enough that every product and sum is exact in
    f32, equal.  Returns the entry's fields."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    errs = {}
    for dt in dict.fromkeys((cs["dtype"], torch.float32)):
        (x, w_pre, w2, b2, _, _), kw, _ = embed_gn_inputs(
            dict(cs, dtype=dt), gen)
        geo = {key: (v, v) for key, v in kw.items() if key != "groups"}
        cpg = w2.shape[1]
        # w_pre in {0, 1, 2}, w2 in {-1, 0, 1} at every fourth cp and 0
        # elsewhere, b2 in {-2, ..., 2}: |w_raw| <= bound, and a plane's
        # sum of squares stays below 2^24
        ints = (torch.randint(0, 3, w_pre.shape, generator=gen,
                              device="cuda").to(dt),
                (torch.randint(-1, 2, w2.shape, generator=gen, device="cuda")
                 * (torch.arange(cpg, device="cuda") % 4 == 0)).to(dt),
                torch.randint(-2, 3, b2.shape, generator=gen,
                              device="cuda").float())
        bound = 2 * ((cpg + 3) // 4) + 2
        if cs["k"] ** 2 * cs["h"] * cs["w"] * bound ** 2 >= 2 ** 24:
            raise AssertionError(f"stats check at {geometry}: integer sums "
                                 "not exact in f32")
        for integer, (wp, ww, bb) in ((False, (w_pre, w2, b2)),
                                      (True, ints)):
            tiled, ref = (la.embed_gn_statistics(
                x, wp, ww, bb, **geo, groups=kw["groups"], pointwise=pw)
                          for pw in (False, True))
            torch.cuda.synchronize()
            got, want = tiled.double().sum(2), ref.double().sum(2)
            if integer:
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"stats totals at {geometry} {dt}, integer inputs: "
                        f"max|diff| {float((got - want).abs().max())}")
                continue
            rel = [float((got[..., i] - want[..., i]).abs().max()
                         / want[..., i].abs().max()) for i in (0, 1)]
            if max(rel) > 1e-6:
                raise AssertionError(f"stats totals at {geometry} {dt}: "
                                     f"max|err|/max|ref| {rel}")
            errs[str(dt).replace("torch.", "")] = max(rel)
    log(f"  statistics pass at {geometry}: plane totals against the "
        f"pointwise route's within {errs} of max|ref| (limit 1e-6), equal "
        "on integer inputs")
    return {"stats_totals_max_rel_err": errs,
            "stats_totals_exact_on_integers": True}


def embed_gn_kernel_phase(la, hbm_rate: float, paths: PathCounts) -> list:
    """The fused embed conv + GroupNorm + aggregation kernels vs the plain
    version on the card, each case launched twice (the same bits), with
    the route its launcher takes and the device time of each of its
    kernels; returns their entries."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    entries = []
    for cs in embed_gn_cases():
        args, kw, geometry = embed_gn_inputs(cs, gen)
        x, w_pre, w2 = args[:3]
        n, cp, h, w, k, dil, groups = (cs[key] for key in (
            "n", "cp", "h", "w", "k", "dil", "groups"))
        dt = cs["dtype"]
        f = w2.shape[0]
        pad = kw["padding"]
        geo = dict(kernel_size=(k, k), dilation=(dil, dil),
                   padding=(pad, pad), groups=groups)
        variant = la.embed_gn_route(x, w_pre, w2, **geo)
        if variant != cs.get("route", variant):
            raise AssertionError(f"embed_gn at {geometry} took the {variant} "
                                 f"route, not {cs['route']}")
        workspace = la.embed_gn_workspace_bytes(x, w_pre, w2, **geo)
        before = dict(la.EMBED_GN_LAUNCHES_BY_SHAPE)
        with torch.no_grad(), tf32_off():
            got = la.local_aggregate_embed_gn(*args, impl="hopper", **kw)
            torch.cuda.synchronize()
            launches = paths.entry(
                "embed_gn", new_key(la.EMBED_GN_LAUNCHES_BY_SHAPE, before))
            # every sum has one owner and a fixed order
            if not torch.equal(la.local_aggregate_embed_gn(
                    *args, impl="hopper", **kw), got):
                raise AssertionError(f"embed_gn at {geometry}: a second "
                                     "launch gave other bits")
            ref = la.local_aggregate_embed_gn(*args, impl="torch", **kw)
            scale = float(ref.float().abs().max())
            if dt == torch.float32:
                # the product's and the statistics' sums in another order
                rtol, atol = 1e-5, 1e-5 * scale
            else:
                # besides the output's own rounding, a w_raw whose f32 sum
                # lies at a rounding boundary may round to the neighbouring
                # bf16 value in one of the two, which moves that tap's
                # weight by one bf16 ulp
                rtol, atol = 8e-3, 4e-3 * scale
            err = (got.float() - ref.float()).abs()
            bad = int((err > atol + rtol * ref.float().abs()).sum())
            if bad:
                raise AssertionError(
                    f"kernel != plain at {geometry}: {bad} elements, max "
                    f"|err| {float(err.max())}")

            def run():
                return la.local_aggregate_embed_gn(*args, impl="hopper", **kw)

            ms = device_ms(run)
            split = kernel_ms_by_name(run, EMBED_GN_STATS + EMBED_GN_AGG)
            plain_ms = device_ms(lambda: la.local_aggregate_embed_gn(
                *args, impl="torch", **kw))
            # the yardstick of a tensor-core product: w_raw of the same
            # shapes in T by one torch.matmul (no bias, no rounding step)
            w2g = w2.view(groups, f // groups, cp // groups)
            wp = w_pre.view(n, groups, cp // groups, h * w)
            product_matmul_ms = device_ms(lambda: torch.matmul(w2g, wp))
        # a statistics kernel runs exactly where its partial sums need a
        # workspace: not where a block holds whole planes; on the tiled
        # routes it is embed_gn_stats_rows
        stats_ms = (None if split[EMBED_GN_STATS[0]] is None
                    else sum(split[name] for name in EMBED_GN_STATS))
        if stats_ms is not None and (
                bool(stats_ms) != bool(workspace)
                or (variant != "pointwise"
                    and bool(split[EMBED_GN_STATS[0]]) != bool(workspace))):
            raise AssertionError(f"embed_gn at {geometry}: workspace "
                                 f"{workspace} bytes, statistics kernels "
                                 f"{[split[n] for n in EMBED_GN_STATS]} ms")
        # the statistics pass alone, where it runs: its bytes (w_pre and w2
        # read, the partial sums written), or its product at the tensor
        # cores' rate for its type, whichever takes longer; beside it the
        # floor of its design, the product in f32 FMAs (two operations
        # each) at the f32 rate, which the bit-identity with the
        # aggregation's w_raw keeps it to
        stats_bound = stats_bound_by = stats_fma_floor = None
        item = x.element_size()
        if workspace:
            product = 2 * n * f * h * w * (cp // groups)
            stats_bound, stats_bound_by = bounds_ms(
                (w_pre.numel() + w2.numel()) * item + workspace, 0,
                matmul_flops=product, matmul_dtype=dt)
            stats_fma_floor = product / F32_FLOPS_PER_S * 1e3
        totals = {}
        if cs.get("stats_check"):
            totals = stats_totals_check(la, cs, geometry)
            # the statistics pass alone at these inputs, on this route
            # (embed_gn_stats_rows) and on the pointwise one (embed_gn_stats,
            # the tiled routes' statistics kernel before it)
            for key, pw in (("stats_alone_ms", False),
                            ("stats_pointwise_ms", True)):
                totals[key] = device_ms(lambda: la.embed_gn_statistics(
                    *args[:4], **geo, pointwise=pw))
            log(f"  statistics pass alone {totals['stats_alone_ms']:.4f} ms, "
                f"on the pointwise route {totals['stats_pointwise_ms']:.4f} "
                "ms")
        # x, w_pre and w2 read, out written, the three f32 vectors; the
        # product w_pre @ w2 once, at the tensor cores' rate for its type
        # (that this kernel forms it in f32 FMAs, and twice where the
        # statistics kernel runs, is its own cost), then per w_raw element
        # the bias, the two statistics' terms and the normalize, and the
        # taps, in f32
        nbytes = (2 * x.numel() + w_pre.numel() + w2.numel()) * item \
            + 3 * f * 4
        w_raw = n * f * h * w
        bound, bound_by = bounds_ms(
            nbytes, 8 * w_raw + 2 * x.numel() * k * k,
            matmul_flops=2 * w_raw * (cp // groups), matmul_dtype=dt)
        entries.append({
            "name": "local_agg_embed_gn", "route": "cuda",
            "source": "cotnet_tpu_torch/ops/csrc/local_agg_embed_gn.cu",
            "replaces": REPLACES_EMBED_GN, "geometry": geometry,
            "variant": variant, **launches,
            "max_abs_err": float(err.max()),
            "mean_abs_err": float(err.mean()),
            "tol": {"rtol": rtol, "atol": atol},
            "deterministic": True, "workspace_bytes": workspace,
            "ms": ms, "plain_ms": plain_ms,
            "stats_ms": stats_ms,
            "stats_bound_ms": stats_bound, "stats_bound_by": stats_bound_by,
            "stats_fma_floor_ms": stats_fma_floor,
            **totals,
            "agg_ms": (None if split[EMBED_GN_AGG[0]] is None
                       else sum(split[name] for name in EMBED_GN_AGG)),
            "product_matmul_ms": product_matmul_ms,
            "bound_ms": bound, "bound_by": bound_by,
            "bound_ms_at_copy_rate": nbytes / hbm_rate * 1e3,
            "library_ms": None})
        log_entry(entries[-1])
        log(f"  stats {fmt_ms(entries[-1]['stats_ms'])}"
            + (f" (bound {stats_bound:.4f} ms, {stats_bound_by}; f32-FMA "
               f"floor {stats_fma_floor:.4f} ms)" if stats_bound else "")
            + f", aggregation {fmt_ms(entries[-1]['agg_ms'])} "
            "(torch.profiler); "
            f"workspace {workspace} bytes; w_raw by torch.matmul "
            f"{product_matmul_ms:.4f} ms")
    return entries


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def calibrate_bn(model, x, seed: int):
    """Seeded BN running stats drawn from each BN's real input on ``x``, and
    a small non-zero scale in the last BN of each residual branch (bn3;
    LeViT's ``m.proj.1.bn`` and ``m.2.bn``, which timm starts at zero).
    Random stats unrelated to the input let the activations grow block
    after block; with the default zero-init bn3 every residual branch is
    multiplied by zero and the logits never see the aggregation; with
    LeViT's branches at unit scale its 22 residual blocks amplify f32
    rounding to 2.5e-3 of the largest logit (the CPU against f64, bs4)."""
    from cotnet_tpu_torch.nn import BatchNorm2d

    gen = torch.Generator(device=x.device).manual_seed(seed)

    def rand(like):
        return torch.rand(like.shape, generator=gen, device=like.device)

    def set_stats(m, args):
        # a random part of the mean, and the second moment about it: the
        # BN then scales each channel to about unit size without the
        # cancellation of centring a channel whose mean dwarfs its spread;
        # the channels on axis 1 (NCHW), or last (LeViT's tokens)
        xin = args[0].float()
        axis = m.channel_axis % xin.dim()
        red = tuple(d for d in range(xin.dim()) if d != axis)
        shape = [1] * xin.dim()
        shape[axis] = -1
        mean = xin.mean(red) * 0.5 * rand(m.running_mean)
        msq = (xin - mean.view(shape)).square().mean(red)
        m.running_mean.copy_(mean)
        m.running_var.copy_(msq * (0.5 + rand(msq)))

    bns = [(n, m) for n, m in model.named_modules()
           if isinstance(m, BatchNorm2d)]
    hooks = [m.register_forward_pre_hook(set_stats) for _, m in bns]
    try:
        with torch.no_grad():
            for name, m in bns:
                if name.endswith(("bn3", ".m.proj.1.bn", ".m.2.bn")):
                    m.weight.copy_(0.1 + 0.2 * rand(m.weight))
            model(x)
    finally:
        for h in hooks:
            h.remove()



class tf32_off:
    """TF32 off in cuDNN and in matmuls, for an f32 comparison."""

    def __enter__(self):
        self.old = (torch.backends.cudnn.allow_tf32,
                    torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = self.old


def images_f32(n: int = 16, size: int = IMAGE):
    """n f32 images, each with its own contrast and brightness: with images
    of one distribution the pooled vector that feeds each CotLayer's se BN
    is nearly the same for all samples, its one-pass variance cancels, and
    f32 rounding alone moves the train-mode gradients by 1e-4 relative."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn(n, 3, size, size, generator=gen, device="cuda")
    return x * torch.linspace(0.3, 2.0, n, device="cuda")[:, None, None, None] \
        + torch.linspace(-1, 1, n, device="cuda")[:, None, None, None]


def make_batch(n: int = BATCH, size: int = IMAGE) -> dict:
    """A main path's batch: bf16 images, labels, and 8 invalid samples."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    return {
        "image": torch.randn(n, 3, size, size, generator=gen,
                             device="cuda").to(torch.bfloat16),
        "label": torch.randint(0, 1000, (n,), generator=gen, device="cuda"),
        "valid": (torch.arange(n, device="cuda") < n - 8).float(),
    }


def model_phase(la, paths: PathCounts) -> tuple:
    """Phases 2 and 3, on cotnet50; records the two main paths' launches
    in ``paths``.  Returns the calibrated f32 state_dict, for phase 5, and
    the train main path's images/s and profile, for phase 8."""
    from cotnet_tpu_torch.models import create_model
    from cotnet_tpu_torch.train.step import make_eval_step

    model = create_model("cotnet50", device="cuda", seed=0)
    x = images_f32()
    calibrate_bn(model, x, seed=1)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    plain = create_model("cotnet50", device="cuda",
                         block_args=dict(impl="torch"))
    plain.load_state_dict(state)

    # f32: the kernel path against the plain path, TF32 off on both
    with tf32_off(), torch.no_grad():
        la.reset_counts()
        got = model(x)
        torch.cuda.synchronize()
        counts = (la.LAUNCHES, la.PLAIN_CALLS)
        ref = plain(x)
    if counts != (16, 0):
        raise AssertionError(f"one f32 forward: {counts[0]} kernel launches "
                             f"and {counts[1]} plain calls, want 16 and 0")
    if not (torch.isfinite(got).all() and got.shape == (16, 1000)):
        raise AssertionError(f"f32 logits {tuple(got.shape)} not finite")
    diff = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    if not diff <= 1e-3 * scale:
        raise AssertionError(f"f32 logits: max|diff| {diff} > 1e-3 * "
                             f"max|logit| {scale}")
    log(f"model f32 parity: max|logit diff| {diff:.3g} (max|logit| "
        f"{scale:.3g}); per forward {counts[0]} kernel launches, "
        f"{counts[1]} plain calls")
    f32_logits = got
    del ref, got

    gradient_parity(la, model, plain, x)
    del plain
    loss_falls(la, model, x)
    del model
    torch.cuda.empty_cache()

    # the eval main path: bf16 eval step at 224x224 bs128
    model16 = create_model("cotnet50", device="cuda", dtype=torch.bfloat16)
    model16.load_state_dict(state)
    with torch.no_grad():
        d16 = (model16(x.to(torch.bfloat16)).float() - f32_logits).abs()
    d_max, d_mean = float(d16.max()) / scale, float(d16.mean()) / scale
    # loose: bf16 keeps 8 bits through some 50 layers
    if not d_max <= 0.2:
        raise AssertionError(f"bf16 logits differ from f32 by {d_max} of "
                             "max|logit|, more than 0.2")
    log(f"bf16 eval logits against f32, same weights and batch of 16: max "
        f"|diff| {d_max:.4g}, mean |diff| {d_mean:.4g} of max|logit| "
        f"{scale:.3g} (limit 0.2 on the max)")
    eval_step = make_eval_step(model16)
    batch = make_batch()
    warmup, timed = 2, 10
    steps = warmup + timed
    la.reset_counts()
    times = []
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eval_step(batch)
        torch.cuda.synchronize()
        if i >= warmup:
            times.append(time.perf_counter() - t0)
    launches = la.LAUNCHES
    # 16 affine forward launches a step, by map size as cotnet50's
    # (3, 4, 6, 3) CoT layers, and nothing else
    check_path_launches(paths.record(la, "cotnet50 eval", steps), "eval",
                        "cotnet50", steps)
    top1, top5, n = (float(out[key]) for key in
                     ("top1_count", "top5_count", "n"))
    if not (0 <= top1 <= top5 <= n == BATCH - 8):
        raise AssertionError(f"eval counts top1 {top1} top5 {top5} n {n}")
    eval_img_s = BATCH / statistics.median(times)
    log(f"bf16 eval cotnet50 {IMAGE}x{IMAGE} bs{BATCH}: "
        f"{eval_img_s:.1f} img/s (median of {timed} "
        f"eval steps) on {nvidia_smi()}; top1 {top1:.0f} top5 {top5:.0f} of "
        f"{n:.0f}; {launches} kernel launches in {steps} forwards, 0 plain "
        f"calls")
    profile_step(lambda: eval_step(batch), "bf16 eval step")
    del model16, eval_step
    torch.cuda.empty_cache()

    return state, dict(train_main_path(la, batch, paths),
                       eval_img_s=eval_img_s)


def train_loss(model, x, labels):
    from cotnet_tpu_torch.train.loss import label_smoothing_cross_entropy

    return label_smoothing_cross_entropy(model(x), labels, 0.1)


def gradient_parity(la, model, plain, x,
                    plain_counts=(0, {"dx": 0, "dw": 0}, 16, 16),
                    what: str = "kernel path against plain path"):
    """f32, TF32 off: one loss and backward in training mode through the
    three kernels against the same model on the plain versions (or, with
    ``plain_counts`` of a run through the kernels, against another model
    of the same function: phase 19's grouped cotnet50).

    The net's f32 gradients are ill-conditioned: each CotLayer's ``se`` BN
    normalizes 16 pooled vectors that are nearly alike, and its one-pass
    variance amplifies rounding layer after layer.  So the plain model's
    gradients are taken a second time with the input perturbed by one f32
    ulp (relative 1e-7), and the kernel path is held to be no further from
    the plain path than the plain path is from itself: the relative L2
    distance of the whole gradient, and the median and the worst over the
    parameters of ``max|dg| / max|g|``, each within 3 times that noise (or
    1e-3 where the noise is smaller).  What is held strictly is each
    backward launch inside the model: ``backward_launches_match_plain``."""
    labels = torch.randint(0, 1000, (x.shape[0],), device="cuda",
                           generator=torch.Generator("cuda").manual_seed(4))
    noise = torch.randn(x.shape, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(7))
    runs = {}
    with tf32_off():
        for name, m, inp in (("kernel", model, x), ("plain", plain, x),
                             ("perturbed", plain, x * (1 + 1e-7 * noise))):
            m.train()
            m.zero_grad(set_to_none=True)
            la.reset_counts()
            loss = train_loss(m, inp, labels)
            loss.backward()
            torch.cuda.synchronize()
            runs[name] = (float(loss.detach()),
                          (la.LAUNCHES, dict(la.BWD_LAUNCHES), la.PLAIN_CALLS,
                           la.PLAIN_BWD_CALLS),
                          [p.grad for p in m.parameters()])
            m.zero_grad(set_to_none=True)
            m.eval()
    (loss, counts, grads), (ref_loss, ref_counts, ref_grads) = \
        runs["kernel"], runs["plain"]
    if counts != (16, {"dx": 16, "dw": 16}, 0, 0):
        raise AssertionError(f"one f32 loss and backward through the kernels: "
                             f"(launches, bwd launches, plain, plain bwd) = "
                             f"{counts}")
    if ref_counts != plain_counts:
        raise AssertionError(f"the plain model's counts: {ref_counts}")
    if not abs(loss - ref_loss) <= 1e-5 * abs(ref_loss):
        raise AssertionError(f"f32 train loss {loss} != plain {ref_loss}")
    if any(g.dtype != torch.float32 for g in grads):
        raise AssertionError("a parameter's gradient is not f32")

    def distance(got):
        """(relative L2 of the whole gradient, median and worst over the
        parameters of max|dg| / max|g|) against the plain gradients."""
        num = sum(float((g - r).double().square().sum())
                  for g, r in zip(got, ref_grads))
        den = sum(float(r.double().square().sum()) for r in ref_grads)
        # a bias that a train-mode BN cancels has a zero gradient but for
        # rounding, and is left out
        rel = [float((g - r).abs().max() / r.abs().max())
               for g, r in zip(got, ref_grads) if float(r.abs().max()) > 1e-6]
        return (num / den) ** 0.5, statistics.median(rel), max(rel)

    got, floor = distance(grads), distance(runs["perturbed"][2])
    strict = backward_launches_match_plain(la, model, x, labels)
    for what, g, f in zip(("relative L2", "median", "worst"), got, floor):
        if not g <= max(1e-3, 3 * f):
            raise AssertionError(
                f"f32 gradients, {what}: kernel path {g} from the plain "
                f"path, the plain path {f} from itself under a 1e-7 input "
                "perturbation")
    log(f"model f32 gradient parity (bs{x.shape[0]}, train mode): loss "
        f"{loss:.6f} against {ref_loss:.6f}; {what} "
        f"(in brackets: plain path against itself with the input perturbed "
        f"by 1e-7, the limit being 3 times that): relative L2 of the whole "
        f"gradient {got[0]:.3g} ({floor[0]:.3g}); max|dg|/max|g| per "
        f"parameter: median {got[1]:.3g} ({floor[1]:.3g}), worst "
        f"{got[2]:.3g} ({floor[2]:.3g}); launches fwd {counts[0]}, dx "
        f"{counts[1]['dx']}, dw {counts[1]['dw']}; {counts[2]} plain "
        f"forward and {counts[3]} plain backward calls; each of the 16 dx "
        f"and 16 dw launches against the plain backward on the model's own "
        f"tensors: worst max|err| {strict:.3g} of max|ref| (limit 1e-5)")


def backward_launches_match_plain(la, model, x, labels,
                                  layers: int = 16) -> float:
    """One more f32 loss and backward through the kernels, with every
    backward launch held, on the model's own x, w and dy, against the plain
    backward: ``max|err| <= 1e-5 * max|ref|`` for dx and for dw (f32 sums of
    9 and of 8 to 72 products in another order).  Unlike the end-to-end
    gradients this compares like with like at every layer, so the net's
    conditioning does not enter.  Returns the worst ratio seen."""
    import torch.nn.functional as F

    launch = la.local_aggregate_bwd_hopper
    ratios = []

    def checked(x_, w_, dy, *, kernel_size, dilation, padding, **need):
        got = launch(x_, w_, dy, kernel_size=kernel_size, dilation=dilation,
                     padding=padding, **need)
        ph, pw = padding
        dxp, dw = la.local_aggregate_bwd_plain(
            F.pad(x_, (pw, pw, ph, ph)), w_, dy, kernel_size, dilation,
            **need)
        ref = (dxp[..., ph:ph + x_.shape[2], pw:pw + x_.shape[3]], dw)
        for g, r in zip(got, ref):
            if g is not None:
                ratios.append(float((g - r).abs().max() / r.abs().max()))
        return got

    la.local_aggregate_bwd_hopper = checked
    try:
        with tf32_off():
            model.train()
            train_loss(model, x, labels).backward()
            torch.cuda.synchronize()
    finally:
        la.local_aggregate_bwd_hopper = launch
        model.zero_grad(set_to_none=True)
        model.eval()
    if len(ratios) != 2 * layers or not max(ratios) <= 1e-5:
        raise AssertionError(f"backward launches in the model against the "
                             f"plain backward: {len(ratios)} gradients, "
                             f"max|err| / max|ref| {ratios}")
    return max(ratios)


def loss_falls(la, model, x, steps: int = 5, lr: float = 0.01):
    """Five f32 train steps on one fixed batch at a constant LR, no mixup
    and no drop: the loss of the last step is below that of the first."""
    from cotnet_tpu_torch.train.loss import create_loss_fn
    from cotnet_tpu_torch.train.optim import create_optimizer
    from cotnet_tpu_torch.train.state import TrainState
    from cotnet_tpu_torch.train.step import make_train_step

    optimizer = create_optimizer(RECIPE["solver"], model.parameters())
    loss_fn, _ = create_loss_fn(RECIPE["loss"], False)
    step = make_train_step(model, optimizer, lambda s: lr, loss_fn)
    state = TrainState.create(model, optimizer)
    labels = torch.randint(0, 1000, (x.shape[0],), device="cuda",
                           generator=torch.Generator("cuda").manual_seed(5))
    batch = {"image": x, "label": labels}
    losses = []
    la.reset_counts()
    for _ in range(steps):
        state, metrics = step(state, batch, None)
        losses.append(metrics["loss"])
    losses = [float(v) for v in losses]
    if la.PLAIN_CALLS or la.PLAIN_BWD_CALLS:
        raise AssertionError("the f32 train steps made plain calls")
    if not (all(v == v for v in losses) and losses[-1] < losses[0]):
        raise AssertionError(f"the loss did not fall: {losses}")
    log(f"f32 train, {steps} steps on one batch of {x.shape[0]} at LR {lr}: "
        f"loss {', '.join(f'{v:.4f}' for v in losses)}")


def recipe_train_step(model, recipe=RECIPE, batch: int = BATCH):
    """``make_train_step`` on ``model`` under ``recipe`` at ``batch`` images
    a step (no mixup where the recipe's is None); returns (step, its
    TrainState with an EMA)."""
    from cotnet_tpu_torch.data.mixup import Mixup
    from cotnet_tpu_torch.train.loss import create_loss_fn
    from cotnet_tpu_torch.train.optim import create_optimizer
    from cotnet_tpu_torch.train.schedule import create_scheduler
    from cotnet_tpu_torch.train.state import TrainState
    from cotnet_tpu_torch.train.step import make_train_step

    schedule_fn, _ = create_scheduler(recipe["solver"],
                                      IMAGENET_TRAIN_IMAGES // batch)
    optimizer = create_optimizer(recipe["solver"], model.parameters())
    mixup = recipe["mixup"]
    loss_fn, _ = create_loss_fn(recipe["loss"], mixup_active=bool(mixup))
    step = make_train_step(model, optimizer, schedule_fn, loss_fn,
                           ema_decay=recipe["ema_decay"],
                           mixup_fn=Mixup(**mixup) if mixup else None)
    return step, TrainState.create(model, optimizer, ema=True)


def train_main_path(la, batch, paths: PathCounts):
    """The train main path: bf16 ``make_train_step`` on cotnet50 at 224x224
    bs128 under the recipe."""
    from cotnet_tpu_torch.models import create_model
    from cotnet_tpu_torch.train.state import float_state

    torch.cuda.reset_peak_memory_stats()
    model = create_model("cotnet50", device="cuda", dtype=torch.bfloat16,
                         seed=0, **RECIPE["model"])
    start = {k: v.detach().clone() for k, v in float_state(model).items()}
    step, state = recipe_train_step(model)
    gen = torch.Generator(device="cuda").manual_seed(6)
    batch = {"image": batch["image"], "label": batch["label"]}

    warmup, timed = 2, 8
    steps = warmup + timed
    la.reset_counts()
    times, metrics = [], []
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch, gen)
        torch.cuda.synchronize()
        if i >= warmup:
            times.append(time.perf_counter() - t0)
        metrics.append(m)
    peak = torch.cuda.max_memory_allocated()
    # 16 forward, 16 dx and 16 dw launches a step without the affine, by
    # map size as cotnet50's (3, 4, 6, 3) CoT layers, and nothing else
    check_path_launches(paths.record(la, "cotnet50 train", steps), "train",
                        "cotnet50", steps)
    totals = (la.LAUNCHES, dict(la.BWD_LAUNCHES))

    losses = [float(m["loss"]) for m in metrics]
    norms = [float(m["grad_norm"]) for m in metrics]
    lrs = [m["lr"] for m in metrics]
    if not all(v == v and abs(v) < float("inf") for v in losses + norms):
        raise AssertionError(f"train losses {losses}, grad norms {norms}")
    if not (state.step == steps and lrs[0] == 1e-4
            and all(a < b for a, b in zip(lrs, lrs[1:]))):
        raise AssertionError(f"step {state.step}, warm-up LRs {lrs}")
    live = float_state(model)
    # what must have changed, live and in the EMA: every bn3 scale (it
    # starts at zero, so any update shows, and its gradient comes through
    # the whole backward) and the running stats; of all the weights only
    # half, since in ten warm-up steps at an LR of 1e-4 an update of a BN
    # scale of 1.0 can round away in f32, and an EMA moves by 1e-4 of that
    for what, now in (("live", live), ("EMA", state.ema)):
        for kind, share in (("bn3.weight", 1.0), ("running_mean", 0.9),
                            ("running_var", 0.9), ("weight", 0.5)):
            if (what, kind) == ("EMA", "weight"):
                continue
            keys = [k for k in start if k.endswith(kind)]
            moved = sum(not torch.equal(now[k], start[k]) for k in keys)
            if moved < share * len(keys):
                raise AssertionError(f"{what} {kind}: only {moved} of "
                                     f"{len(keys)} tensors changed")
    if any(not torch.isfinite(v).all() for v in live.values()):
        raise AssertionError("a parameter or running stat is not finite")
    log(f"bf16 train cotnet50 {IMAGE}x{IMAGE} bs{BATCH} (mixup/cutmix, drop "
        f"0.25, drop_path 0.1, nesterov, cosine warm-up, EMA): "
        f"{BATCH / statistics.median(times):.1f} img/s (median of {timed} "
        f"train steps, {statistics.median(times) * 1e3:.1f} ms a step) on "
        f"{nvidia_smi()}; peak memory {peak / 2 ** 30:.2f} GiB; loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}, grad norm {norms[0]:.3f} -> "
        f"{norms[-1]:.3f}, LR {lrs[0]:.3g} -> {lrs[-1]:.3g}; launches in "
        f"{steps} steps: fwd {totals[0]}, dx {totals[1]['dx']}, dw "
        f"{totals[1]['dw']}, 0 plain calls")
    busy = profile_step(lambda: step(state, batch, gen), "bf16 train step")
    return {"img_s": BATCH / statistics.median(times), "busy": busy}


def stack_solver(name: str) -> dict:
    """Phase 4's solver config for an optimizer name: the CoTNet-50
    recipe's, with the name's LR and ``STACK_SOLVERS``' pieces."""
    lr = 1.0 if name == "adadelta" else (
        RECIPE["solver"]["lr"] if name in SGD_LIKE else 1e-3)
    return dict(RECIPE["solver"], opt=name, lr=lr,
                **STACK_SOLVERS.get(name, {}))


def train_stack_phase(la, paths: PathCounts):
    """Phase 4: every optimizer name through cotnet50's bf16 train step at
    224x224 bs128 under the recipe's model, mixup and EMA settings, from
    the same start; then one f32 update of each optimizer on the card
    against the CPU, and the second-order step's refusal of the op."""
    from cotnet_tpu_torch.data.mixup import Mixup
    from cotnet_tpu_torch.models import create_model
    from cotnet_tpu_torch.train.loss import create_loss_fn
    from cotnet_tpu_torch.train.optim import create_optimizer
    from cotnet_tpu_torch.train.schedule import (PlateauController,
                                                 create_scheduler)
    from cotnet_tpu_torch.train.state import TrainState, float_state
    from cotnet_tpu_torch.train.step import make_train_step

    t0 = time.perf_counter()
    model = create_model("cotnet50", device="cuda", dtype=torch.bfloat16,
                         seed=0, **RECIPE["model"])
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}
    batch = make_batch()
    images = {"image": batch["image"], "label": batch["label"]}
    spe = IMAGENET_TRAIN_IMAGES // BATCH
    loss_fn, _ = create_loss_fn(RECIPE["loss"], mixup_active=True)
    table = []
    for name in STACK_OPTIMIZERS:
        model.load_state_dict(start)
        cfg = stack_solver(name)
        schedule_fn, _ = create_scheduler(cfg, spe)
        optimizer = create_optimizer(cfg, model.parameters())
        step = make_train_step(model, optimizer, schedule_fn, loss_fn,
                               ema_decay=RECIPE["ema_decay"],
                               mixup_fn=Mixup(**RECIPE["mixup"]))
        state = TrainState.create(model, optimizer, ema=True)
        state.step = first = STACK_EPOCH * spe
        if cfg["sched"] == "plateau":
            # an epoch's top-1 below the one before, patience 0
            plateau = PlateauController(patience=0)
            plateau.update(0.5)
            state.lr_scale = plateau.update(0.4)
        steps = 7 if name.startswith("lookahead") else 3
        gen = torch.Generator(device="cuda").manual_seed(6)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        la.reset_counts()
        times, metrics = [], []
        for i in range(steps):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            state, m = step(state, images, gen)
            torch.cuda.synchronize()
            if i:
                times.append(time.perf_counter() - t1)
            metrics.append(m)
        peak = torch.cuda.max_memory_allocated()
        # 16 forward, dx and dw launches a step on k3, no plain call
        check_path_launches(paths.record(la, f"cotnet50 train {name}", steps),
                            "train", "cotnet50", steps)
        losses = [float(m["loss"]) for m in metrics]
        norms = [float(m["grad_norm"]) for m in metrics]
        lrs = [m["lr"] for m in metrics]
        want = [float(schedule_fn(first + i)) * state.lr_scale
                for i in range(steps)]
        if not all(v == v and abs(v) < float("inf") for v in losses + norms):
            raise AssertionError(f"{name}: losses {losses}, grad norms "
                                 f"{norms}")
        if lrs != want or optimizer.param_groups[0]["lr"] != want[-1]:
            raise AssertionError(f"{name}: LRs {lrs}, the schedule's {want}")
        if name.startswith("lookahead") and optimizer.count != steps:
            raise AssertionError(f"{name}: {optimizer.count} steps counted")
        # every bn3 scale (it starts at zero, so any update shows) and a
        # quarter of the weights: a small update of a weight rounds away in
        # f32 (RAdam's first steps are momentum SGD at its LR of 1e-3)
        live = float_state(model)
        for kind, share in (("bn3.weight", 1.0), ("weight", 0.25)):
            keys = [k for k in live if k.endswith(kind)]
            moved = sum(not torch.equal(live[k], start[k]) for k in keys)
            if moved < share * len(keys):
                raise AssertionError(f"{name}: only {moved} of {len(keys)} "
                                     f"{kind} tensors moved")
        if any(not torch.isfinite(v).all() for v in live.values()):
            raise AssertionError(f"{name}: a parameter is not finite")
        median = statistics.median(times)
        kernels, busy_ms = device_kernels(lambda: step(state, images, gen))
        table.append((name, BATCH / median, peak / 2 ** 30, kernels))
        log(f"bf16 train cotnet50 {IMAGE}x{IMAGE} bs{BATCH}, {name} "
            f"({', '.join(f'{k} {v}' for k, v in STACK_SOLVERS.get(name, {}).items()) or cfg['sched']}"
            f", LR scale {state.lr_scale}): {BATCH / median:.1f} img/s "
            f"(median of {steps - 1} steps, {median * 1e3:.1f} ms a step); "
            f"peak memory {peak / 2 ** 30:.2f} GiB; loss {losses[0]:.4f} -> "
            f"{losses[-1]:.4f}, grad norm {norms[0]:.3f} -> {norms[-1]:.3f}, "
            f"LR {lrs[0]:.6g} -> {lrs[-1]:.6g} (the schedule's); per step 16 "
            f"launches each of fwd, dx, dw, 0 plain calls; one more step: "
            f"{kernels} device kernels busy {busy_ms:.3f} ms (torch.profiler); "
            f"done at {time.perf_counter() - t0:.1f} s")
        del optimizer, step, state
    base = table[0]
    log(f"train stack on {nvidia_smi()}: optimizer, img/s, peak GiB, device "
        "kernels a step (sgd's in brackets): " + "; ".join(
            f"{n} {ips:.1f} ({base[1]:.1f}), {gib:.2f} ({base[2]:.2f}), "
            f"{k} ({base[3]})" for n, ips, gib, k in table))
    del model
    torch.cuda.empty_cache()
    optimizers_card_against_cpu()
    log(f"train-stack phase: {time.perf_counter() - t0:.1f} s")


def optimizers_card_against_cpu(rtol: float = 1e-5):
    """One f32 update of each optimizer (and AdaHessian's, given a Hessian
    diagonal) on the card against the same optimizer on the CPU, from the
    same parameters and gradients of one cotnet50 backward; and
    ``make_train_step(second_order=True)`` refusing cotnet50.  The same
    function in other rounding: each tensor within ``rtol`` of the CPU's
    value and of its largest update."""
    from cotnet_tpu_torch.models import create_model
    from cotnet_tpu_torch.train.loss import cross_entropy
    from cotnet_tpu_torch.train.optim import create_optimizer
    from cotnet_tpu_torch.train.step import make_train_step

    model = create_model("cotnet50", device="cuda", seed=0)
    x = images_f32(8)
    labels = torch.arange(8, device="cuda") * 97 % 1000
    with tf32_off():
        train_loss(model, x, labels).backward()
    names = [n for n, p in model.named_parameters()]
    start = [p.detach().clone() for p in model.parameters()]
    grads = [p.grad.clone() for p in model.parameters()]
    worst = {}
    for name in STACK_OPTIMIZERS + ("adahessian",):
        cfg = stack_solver(name)
        out = []
        for device in ("cuda", "cpu"):
            params = [p.to(device, copy=True).requires_grad_()
                      for p in start]
            # copies: an update may write into its gradients (SGD's
            # Nesterov term, the clipping)
            for p, g in zip(params, grads):
                p.grad = g.to(device, copy=True)
            optimizer = create_optimizer(cfg, params)
            for group in optimizer.param_groups:
                group["lr"] = cfg["lr"]
            extra = {"hessian_diag": [g.to(device, copy=True)
                                      for g in grads]} \
                if name == "adahessian" else {}
            optimizer.step(**extra)
            out.append([p.detach().cpu() for p in params])
        ratio = 0.0
        for n, got, ref, s in zip(names, *out, start):
            moved = (ref - s.cpu()).abs().max()
            bound = rtol * (ref.abs() + moved)
            ratio = max(ratio, float(((got - ref).abs() / bound.clamp_min(
                1e-30)).max()))
            if not (got - ref).abs().le(bound).all():
                raise AssertionError(f"{name}: {n} on the card against the "
                                     "CPU beyond rtol 1e-5")
        worst[name] = ratio
    log("f32 update of each optimizer, card against CPU (largest |err| over "
        f"rtol x (|ref| + the tensor's largest update), limit 1): "
        + ", ".join(f"{n} {r:.3g}" for n, r in worst.items()))
    optimizer = create_optimizer(dict(opt="adahessian"), model.parameters())
    try:
        make_train_step(model, optimizer, lambda s: 0.1, cross_entropy,
                        second_order=True)
    except ValueError as err:
        if "aggregation" not in str(err):
            raise
        log(f"make_train_step(second_order=True) on cotnet50 refuses: {err}")
    else:
        raise AssertionError("the second-order step took a model with the "
                             "aggregation op")
    del model
    torch.cuda.empty_cache()


def affine_backward_launches_match_plain(la, model, x, labels) -> tuple:
    """One f32 loss and backward of a folded model through the kernels,
    with every affine backward launch held, on the model's own x, w, s, b
    and dy, against the plain affine backward: ``max|err| <= 1e-5 *
    max|ref|`` for dx and dw, and ``check_sums`` for ds and db.  Returns
    the worst ratio of (dx and dw, ds and db)."""
    import torch.nn.functional as F

    launch = la.local_aggregate_bwd_affine_hopper
    ratios = {"dx": [], "dw": [], "ds": [], "db": []}

    def checked(x_, w_, s_, b_, dy, *, kernel_size, dilation, padding,
                **need):
        got = launch(x_, w_, s_, b_, dy, kernel_size=kernel_size,
                     dilation=dilation, padding=padding, **need)
        ph, pw = padding
        ref = la.local_aggregate_bwd_affine_plain(
            F.pad(x_, (pw, pw, ph, ph)), w_, s_, b_, dy, kernel_size,
            dilation, **need)
        ref = (ref[0][..., ph:ph + x_.shape[2], pw:pw + x_.shape[3]],) \
            + ref[1:]
        for name, g, r in zip(ratios, got, ref):
            if g is not None:
                ratios[name].append(float((g - r).abs().max()
                                          / r.abs().max()))
        return got

    la.local_aggregate_bwd_affine_hopper = checked
    try:
        with tf32_off():
            model.train()
            la.reset_counts()
            train_loss(model, x, labels).backward()
            torch.cuda.synchronize()
    finally:
        la.local_aggregate_bwd_affine_hopper = launch
        model.zero_grad(set_to_none=True)
        model.eval()
    counts = (la.LAUNCHES, dict(la.AFFINE_BWD_LAUNCHES), dict(la.BWD_LAUNCHES),
              la.PLAIN_CALLS)
    if counts != (16, {"dx": 16, "dw": 16}, {"dx": 0, "dw": 0}, 0):
        raise AssertionError(f"one f32 loss and backward of the folded "
                             f"model: (fwd, affine bwd, plain-form bwd, "
                             f"plain forward calls) = {counts}")
    worst = (max(ratios["dx"] + ratios["dw"]), max(ratios["ds"] + ratios["db"]))
    if any(len(v) != 16 for v in ratios.values()) or not max(worst) <= 1e-5:
        raise AssertionError(f"affine backward launches in the model "
                             f"against the plain affine backward: {ratios}")
    return worst


def switch_checks_f32(la, model_name: str, state=None):
    """Phase 5's f32 checks for one model, at bs16 with TF32 off: the
    fused-embed eval against the unfused one, and the folded model's
    backward and five train steps.  ``state`` is a calibrated f32
    state_dict; without one the model is calibrated here."""
    from cotnet_tpu_torch.models import create_model

    x = images_f32()
    if state is None:
        model = create_model(model_name, device="cuda", seed=0)
        calibrate_bn(model, x, seed=1)
        state = {k: v.clone() for k, v in model.state_dict().items()}
        del model

    logits = {}
    for fused in (False, True):
        model = create_model(model_name, device="cuda", mega_fuse=fused)
        model.load_state_dict(state)
        with tf32_off(), torch.no_grad():
            la.reset_counts()
            logits[fused] = model(x)
            torch.cuda.synchronize()
        counts = (la.LAUNCHES, la.EMBED_GN_LAUNCHES,
                  launch_snapshot(la)["plain"])
        if counts != ((0, 16, 0) if fused else (16, 0, 0)):
            raise AssertionError(f"{model_name} f32 forward, mega_fuse="
                                 f"{fused}: (fwd launches, fused launches, "
                                 f"plain calls) = {counts}")
        del model
    diff = float((logits[True] - logits[False]).abs().max())
    scale = float(logits[False].abs().max())
    if not (torch.isfinite(logits[True]).all()
            and logits[True].shape == (16, 1000) and diff <= 1e-3 * scale):
        raise AssertionError(f"{model_name} f32 logits, fused embed against "
                             f"unfused: max|diff| {diff}, max|logit| {scale}")

    model = create_model(model_name, device="cuda", gn_fold_train=True)
    model.load_state_dict(state)
    labels = torch.randint(0, 1000, (x.shape[0],), device="cuda",
                           generator=torch.Generator("cuda").manual_seed(4))
    worst = affine_backward_launches_match_plain(la, model, x, labels)
    log(f"{model_name} f32, bs{x.shape[0]}: fused-embed eval logits against "
        f"the unfused ones max|diff| {diff:.3g} of max|logit| {scale:.3g} "
        f"(limit 1e-3), 16 fused launches and no aggregation launch per "
        f"forward; folded backward, each of the 16 affine dx and 16 affine "
        f"dw launches against the plain affine backward on the model's own "
        f"tensors: worst max|err|/max|ref| {worst[0]:.3g} for dx and dw, "
        f"{worst[1]:.3g} for ds and db (limit 1e-5)")
    loss_falls(la, model, x)
    if la.AFFINE_BWD_LAUNCHES != {"dx": 80, "dw": 80} or la.BWD_LAUNCHES != {
            "dx": 0, "dw": 0}:
        raise AssertionError(f"five folded f32 steps: affine backward "
                             f"launches {la.AFFINE_BWD_LAUNCHES}, others "
                             f"{la.BWD_LAUNCHES}")


def run_main_path(la, paths: PathCounts, model_name: str, kind: str,
                  timed: int, dense_keys: bool = False) -> float:
    """One bf16 main path at the model's image size with seeded random
    weights: ``kind`` is eval, eval_fused (path B, ``mega_fuse``), train, or
    train_fold (path A, ``gn_fold_train``); eval at bs128, the train kinds
    at the model's train batch under its recipe; ``dense_keys`` swaps the
    CoT key convs for ``DenseGroupedConv`` (phase 19).  2 warm-up and ``timed`` timed steps;
    the launches are checked against the kind's and recorded in ``paths``.
    Returns the images/s."""
    from cotnet_tpu_torch.models import create_model
    from cotnet_tpu_torch.train.step import make_eval_step

    label = f"{model_name} {kind}" + (" (dense key convs)" if dense_keys
                                      else "")
    training = kind.startswith("train")
    recipe, size = RECIPES[model_name], MODELS[model_name][2]
    n = TRAIN_BATCH.get(model_name, BATCH) if training else BATCH
    batch = make_batch(n, size)
    torch.cuda.reset_peak_memory_stats()
    # the CoT switches, where the kind turns one on
    switches = {key: True for key, on in (
        ("gn_fold_train", kind == "train_fold"),
        ("mega_fuse", kind == "eval_fused")) if on}
    model = create_model(model_name, device="cuda", dtype=torch.bfloat16,
                         seed=0, **switches,
                         **(recipe["model"] if training else {}))
    if dense_keys:
        dense_key_convs(model)
    if training:
        step, state = recipe_train_step(model, recipe, n)
        gen = torch.Generator(device="cuda").manual_seed(6)
        images = {"image": batch["image"], "label": batch["label"]}

        def run():
            return step(state, images, gen)[1]
    else:
        eval_step = make_eval_step(model)

        def run():
            return eval_step(batch)

    warmup = 2
    steps = warmup + timed
    la.reset_counts()
    times, outs = [], []
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(run())
        torch.cuda.synchronize()
        if i >= warmup:
            times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    check_path_launches(paths.record(la, label, steps), kind, model_name,
                        steps, n)
    if training:
        values = [float(m[key]) for m in outs for key in ("loss", "grad_norm")]
        if not (all(v == v and abs(v) < float("inf") for v in values)
                and state.step == steps):
            raise AssertionError(f"{label}: step {state.step}, losses and "
                                 f"grad norms {values}")
        result = (f"loss {values[0]:.4f} -> {values[-2]:.4f}, peak memory "
                  f"{peak / 2 ** 30:.2f} GiB")
    else:
        top1, top5, valid = (float(outs[-1][key]) for key in
                             ("top1_count", "top5_count", "n"))
        if not (0 <= top1 <= top5 <= valid == n - 8):
            raise AssertionError(f"{label}: top1 {top1} top5 {top5} n "
                                 f"{valid}")
        result = (f"top1 {top1:.0f} top5 {top5:.0f} of {valid:.0f}, peak "
                  f"memory {peak / 2 ** 30:.2f} GiB")
    median = statistics.median(times)
    layers = sum(per_step for _, _, per_step, *_ in MODELS[model_name][1])
    log(f"bf16 {label} {size}x{size} bs{n}: {n / median:.1f} img/s "
        f"(median of {timed} steps, {median * 1e3:.1f} ms a step) on "
        f"{nvidia_smi()}; {result}; per step {layers} launches each of "
        f"{', '.join(path_kernels_of(model_name, kind))}, no other kernel "
        f"of the op, 0 plain calls")
    profile_step(run, f"bf16 {label} step")
    torch.cuda.empty_cache()
    return n / median


def switches_phase(la, paths: PathCounts, cotnet50_state):
    """Phase 5: the two switches on cotnet50, and cotnext50_2x48d with and
    without them."""
    switch_checks_f32(la, "cotnet50", cotnet50_state)
    switch_checks_f32(la, "cotnext50_2x48d")
    torch.cuda.empty_cache()
    for model_name, kinds in (
            ("cotnet50", ("train_fold", "eval_fused")),
            ("cotnext50_2x48d", ("eval", "train", "train_fold",
                                 "eval_fused"))):
        for kind in kinds:
            run_main_path(la, paths, model_name, kind,
                          timed=6 if kind.startswith("train") else 8)


def hybrid_phase(la, paths: PathCounts):
    """Phase 6: se_cotnetd_152.  f32 at bs4 and 256x256, TF32 off: logits
    through the kernels against the plain path, every backward launch
    inside the model against the plain backward, five steps that lower the
    loss; then its bf16 main paths, the eval step at 256 bs128 and the
    train step at 256 bs64 under its recipe."""
    from cotnet_tpu_torch.models import create_model

    name = "se_cotnetd_152"
    _, geometries, size = MODELS[name]
    layers = sum(per_step for _, _, per_step, *_ in geometries)
    x = images_f32(4, size)
    model = create_model(name, device="cuda", seed=0)
    calibrate_bn(model, x, seed=1)
    plain = create_model(name, device="cuda", block_args=dict(impl="torch"))
    plain.load_state_dict(model.state_dict())
    with tf32_off(), torch.no_grad():
        la.reset_counts()
        got = model(x)
        torch.cuda.synchronize()
        counts = (la.LAUNCHES, la.PLAIN_CALLS)
        ref = plain(x)
    del plain
    if counts != (layers, 0):
        raise AssertionError(f"{name} f32 forward: {counts[0]} kernel "
                             f"launches and {counts[1]} plain calls, want "
                             f"{layers} and 0")
    diff, scale = float((got - ref).abs().max()), float(ref.abs().max())
    if not (torch.isfinite(got).all() and got.shape == (4, 1000)
            and diff <= 1e-3 * scale):
        raise AssertionError(f"{name} f32 logits {tuple(got.shape)}: "
                             f"max|diff| {diff}, max|logit| {scale}")
    labels = torch.randint(0, 1000, (x.shape[0],), device="cuda",
                           generator=torch.Generator("cuda").manual_seed(4))
    strict = backward_launches_match_plain(la, model, x, labels, layers)
    log(f"{name} f32, bs{x.shape[0]} {size}x{size}: logits through the "
        f"kernels against the plain path max|diff| {diff:.3g} of max|logit| "
        f"{scale:.3g} (limit 1e-3), {counts[0]} launches and no plain call "
        f"a forward; each of the {layers} dx and {layers} dw launches of a "
        f"backward against the plain backward on the model's own tensors: "
        f"worst max|err|/max|ref| {strict:.3g} (limit 1e-5)")
    loss_falls(la, model, x)
    del model
    torch.cuda.empty_cache()
    run_main_path(la, paths, name, "eval", timed=6)
    run_main_path(la, paths, name, "train", timed=4)


def mix_cases() -> list:
    """The mix kernels' cases: cotnet50's four CoT geometries in bf16 at
    bs128 (heads 1, Cw = C/8; ``main``, the mix path's), then a general f32
    case (heads 2, 13x11, Cw dividing C four times), the edges of the dx
    and dw tiles in bf16 (a map smaller than the 5x5 window, 57x57, 13x11
    with Cw=6, N=1 at 56x56) and a row too wide for one block (2x2049),
    which dx and dw must run on their pointwise route; each with the
    weights separate and packed."""
    cases = [dict(n=BATCH, c=c, h=hw, w=hw, heads=1, cw=c // 8,
                  dtype=torch.bfloat16, main=True)
             for c, hw, _ in COTNET50_GEOMETRIES]
    cases.append(dict(n=4, c=32, h=13, w=11, heads=2, cw=8,
                      dtype=torch.float32))
    for n, c, cw, h, w in ((2, 64, 8, 3, 3), (2, 64, 8, 57, 57),
                           (4, 48, 6, 13, 11), (1, 64, 8, 56, 56)):
        cases.append(dict(n=n, c=c, h=h, w=w, heads=1, cw=cw,
                          dtype=torch.bfloat16))
    cases.append(dict(n=1, c=16, h=2, w=2049, heads=1, cw=8,
                      dtype=torch.bfloat16, route="pointwise"))
    return [dict(cs, merged=merged) for cs in cases
            for merged in (False, True)]


def mix_tensors(cs, seed: int) -> tuple:
    """x, w1, w2 (w1 packed and w2 None when ``merged``) and dy of a case."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    n, c, h, w, heads, cw, dt = (cs[key] for key in (
        "n", "c", "h", "w", "heads", "cw", "dtype"))

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dt)

    x = randn(n, c, h, w)
    w1, w2 = randn(n, heads, cw, 9, h, w), randn(n, heads, cw, 25, h, w)
    if cs["merged"]:
        w1, w2 = torch.cat([w1, w2], dim=3), None
    return x, w1, w2, randn(n, 2 * heads * c, h, w)


def mix_path(la, paths: PathCounts):
    """The mix kernels' main path, the op's own entry points (no model of
    the zoo calls them): one autograd call of ``local_aggregate_mix`` (or
    ``local_aggregate_mix_merge`` for the packed weight) at each bf16 case,
    each one launch of each mix kernel and no plain call or other
    aggregation kernel, the forward, dx and dw on their ``tiles`` route;
    the counts are set to 0 before and read after."""
    cases = [cs for cs in mix_cases() if cs.get("main")]
    la.reset_counts()
    for i, cs in enumerate(cases):
        x, w1, w2, dy = mix_tensors(cs, seed=20 + i)
        routes = {k: la.mix_route(k, x, w1, w2) for k in ("fwd", "dx", "dw")}
        if set(routes.values()) != {"tiles"}:
            raise AssertionError(f"mix op at {cs}: routes {routes}")
        leaves = [t.requires_grad_() for t in (x, w1, w2) if t is not None]
        before = dict(la.MIX_LAUNCHES)
        if cs["merged"]:
            out = la.local_aggregate_mix_merge(*leaves)
        else:
            out = la.local_aggregate_mix(*leaves)
        out.backward(dy)
        torch.cuda.synchronize()
        if ({k: la.MIX_LAUNCHES[k] - before[k] for k in before}
                != {"fwd": 1, "dx": 1, "dw": 1}
                or not all(t.grad.shape == t.shape for t in leaves)):
            raise AssertionError(f"mix op at {cs}: launches "
                                 f"{la.MIX_LAUNCHES} after {before}")
    snapshot = paths.record(la, "mix op", 1)
    others = {kernel for kernel, _ in snapshot["by_key"]
              if not kernel.startswith("mix_")}
    if snapshot["plain"] or others or la.MIX_LAUNCHES != {
            k: len(cases) for k in ("fwd", "dx", "dw")}:
        raise AssertionError(f"mix op: {snapshot['plain']} plain calls, "
                             f"other kernels {others}, launches "
                             f"{la.MIX_LAUNCHES}")
    log(f"mix op: one autograd call at each of {len(cases)} bf16 cases "
        f"(cotnet50's geometries at bs128, weights separate and packed): "
        f"launches {la.MIX_LAUNCHES}, 0 plain calls, the forward, dx and dw "
        "on the tiles route")


def mix_kernel_phase(la, hbm_rate: float, paths: PathCounts) -> list:
    """The three mix kernels against the plain mix on the card; returns
    their entries.  Each names its route (``variant``, from
    ``ops.local_agg.mix_route``: ``tiles``, or ``pointwise`` where the case
    says so), is launched twice for the same bits (``deterministic``), and
    is timed on the pointwise route too (``pointwise_ms``, the first
    kernels at the same inputs); the forward's and dw's
    ``same_bits_as_pointwise`` say whether the two routes' outputs are bit
    for bit the same, which the forward's must be."""
    entries = []
    for i, cs in enumerate(mix_cases()):
        x, w1, w2, dy = mix_tensors(cs, seed=40 + i)
        n, c, h, w, heads, dt = (cs[key] for key in (
            "n", "c", "h", "w", "heads", "dtype"))
        geometry = (f"N={n} C={c} {h}x{w} heads={heads} Cw={cs['cw']} "
                    f"{str(dt).replace('torch.', '')}"
                    f"{' packed' if cs['merged'] else ''}")
        # taps inside the image, 3x3 (pad 1) and 5x5 (pad 2)
        pairs = sum(valid_taps(h, h, k, k // 2, 1) * valid_taps(w, w, k,
                                                                k // 2, 1)
                    for k in (3, 5))
        flops = 2 * n * heads * c * pairs
        weights = w1.numel() + (0 if w2 is None else w2.numel())
        # each pass reads or writes x (or dx), the weights (or dw) and dy
        # (or out) once
        nbytes = (x.numel() + weights + dy.numel()) * x.element_size()
        bound, bound_by = bounds_ms(nbytes, flops)
        for kernel in ("fwd", "dx", "dw"):
            if kernel == "fwd":
                def run(pointwise=False):
                    return (la.local_aggregate_mix_hopper(
                        x, w1, w2, pointwise=pointwise),)

                def plain():
                    return (la.local_aggregate_mix_plain(x, w1, w2),)
            else:
                need = dict(need_dx=kernel == "dx", need_dw=kernel == "dw")
                pick = 0 if kernel == "dx" else 1

                def run(pointwise=False):
                    return la.local_aggregate_mix_bwd_hopper(
                        x, w1, w2, dy, pointwise=pointwise,
                        **need)[pick:pick + 2]

                def plain():
                    return la.local_aggregate_mix_bwd_plain(
                        x, w1, w2, dy, **need)[pick:pick + 2]
            before = dict(la.MIX_LAUNCHES_BY_SHAPE)
            with torch.no_grad():
                got = run()
                torch.cuda.synchronize()
                launches = paths.entry(
                    "mix_" + kernel, new_key(la.MIX_LAUNCHES_BY_SHAPE,
                                             before)[1])
                ref = plain()
                again = run()
                routed = {
                    "variant": la.mix_route(kernel, x, w1, w2),
                    "deterministic": all(
                        torch.equal(a, b) for a, b in zip(got, again)
                        if a is not None)}
                if routed["variant"] != cs.get("route", "tiles"):
                    raise AssertionError(
                        f"mix {kernel} at {geometry} took the "
                        f"{routed['variant']} route")
                if not routed["deterministic"]:
                    raise AssertionError(f"mix {kernel} at {geometry}: "
                                         "two launches differ")
                if kernel != "dx":
                    routed["same_bits_as_pointwise"] = all(
                        torch.equal(a, b)
                        for a, b in zip(got, run(pointwise=True))
                        if a is not None)
                # the forward's two accumulators take the taps in the
                # pointwise kernel's order, from the same zeros
                if kernel == "fwd" and not routed["same_bits_as_pointwise"]:
                    raise AssertionError(f"mix fwd at {geometry}: not the "
                                         "pointwise route's bits")
                errs = [check_close(f"{geometry} {kernel}", g, r, dt)
                        for g, r in zip(got, ref) if r is not None]
                ms = device_ms(run)
                plain_ms = device_ms(plain)
                routed["pointwise_ms"] = device_ms(
                    lambda: run(pointwise=True))
            max_err, rtol, atol = max(errs)
            entries.append({
                "name": f"local_agg_mix_{kernel}", "route": "cuda",
                "source": "cotnet_tpu_torch/ops/csrc/local_agg_mix.cu",
                "replaces": REPLACES_MIX[kernel], "geometry": geometry,
                **routed, **launches, "max_abs_err": max_err,
                "tol": {"rtol": rtol, "atol": atol},
                "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound, "bound_by": bound_by,
                "bound_ms_at_copy_rate": nbytes / hbm_rate * 1e3,
                "library_ms": None})
            log_entry(entries[-1])
    return entries


def dilated_check(la):
    """``local_aggregate_dilated`` on the card at cotnet50's first geometry
    (56x56, C=64, Cw=8) in f32 at bs16 with dilations 1 and 2: forward and
    gradients against the plain path (rtol/atol 1e-5); one forward, one dx
    and one dw launch per distinct dilation, and no plain call."""
    gen = torch.Generator(device="cuda").manual_seed(30)
    x0 = torch.randn(16, 64, 56, 56, generator=gen, device="cuda")
    w0 = torch.randn(16, 1, 8, 9, 56, 56, generator=gen, device="cuda")
    dy = torch.randn(16, 64, 56, 56, generator=gen, device="cuda")
    dilations = (1, 2, 1, 1, 2, 2, 1, 2)
    results = {}
    for impl in ("hopper", "torch"):
        x, w = x0.clone().requires_grad_(), w0.clone().requires_grad_()
        la.reset_counts()
        out = la.local_aggregate_dilated(x, w, dilations, impl=impl)
        out.backward(dy)
        torch.cuda.synchronize()
        results[impl] = (out.detach(), x.grad, w.grad)
        counts = (la.LAUNCHES, dict(la.BWD_LAUNCHES), la.PLAIN_CALLS,
                  la.PLAIN_BWD_CALLS)
        if impl == "hopper" and counts != (2, {"dx": 2, "dw": 2}, 0, 0):
            raise AssertionError(f"dilated op: (fwd, bwd launches, plain, "
                                 f"plain bwd) = {counts}")
    errs = [check_close(f"dilated op {name}", g, r, torch.float32)[0]
            for name, g, r in zip(("out", "dx", "dw"), *results.values())]
    log(f"dilated op (N=16 C=64 56x56 Cw=8 f32, dilations {dilations}): "
        f"2 forward, 2 dx and 2 dw launches, 0 plain calls; max|err| "
        f"against the plain path out {errs[0]:.3g}, dx {errs[1]:.3g}, dw "
        f"{errs[2]:.3g} (rtol/atol 1e-5)")


# ---- phase 8: the data pipeline -------------------------------------------

class SeededImages:
    """A map-style dataset of seeded uint8 HWC images at the crop size and
    their labels, for a host without Pillow: what the loader's transform
    would have produced, which is then not applied.  Module-level, so that
    the loader's worker processes can unpickle it."""

    def __init__(self, n: int, size: int, seed: int):
        self.n, self.size, self.seed = n, size, seed
        self.transform = self.draft_size = None

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        import numpy as np

        rng = np.random.RandomState(self.seed * 100003 + i)
        return (rng.randint(0, 256, (self.size, self.size, 3), np.uint8),
                i % DATA_CLASSES)


def write_image_tree(root: str, n: int, seed: int):
    """``n`` seeded JPEGs (quality 90) in DATA_CLASSES class folders under
    ``root``, alternately 500x375 and 375x500: smooth colour fields with
    noise, so that decode and resampling do the work of photographs."""
    import os

    import numpy as np
    from PIL import Image

    rng = np.random.RandomState(seed)
    fields = {}
    for w, h in DATA_SIZES:
        # a field twice the image's size, each image a seeded crop of it
        yy, xx = np.mgrid[0:2 * h, 0:2 * w].astype(np.float32)
        field = np.stack([
            120 + 70 * np.sin(xx / (17 + 9 * c)) + 50 * np.cos(yy / (23 + 7 * c))
            for c in range(3)], -1) + rng.normal(0, 12, (2 * h, 2 * w, 3))
        fields[(w, h)] = np.clip(field, 0, 255).astype(np.uint8)
    for i in range(n):
        w, h = DATA_SIZES[i % 2]
        y, x = rng.randint(0, h), rng.randint(0, w)
        d = os.path.join(root, f"class_{i % DATA_CLASSES}")
        os.makedirs(d, exist_ok=True)
        Image.fromarray(fields[(w, h)][y:y + h, x:x + w]).save(
            os.path.join(d, f"img_{i:05d}.jpg"), quality=90)


def wall_ms(fn, runs: int = 10, warmup: int = 2) -> float:
    """Median ms of ``fn()`` from a synchronized start to its synchronized
    end, on the host's clock: the device work and every host wait inside
    (the device augment reads its op draws back to the host)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def data_phase(la, paths: PathCounts, main_train: dict):
    """Phase 8: the port's loader on the card: the host, a written dataset,
    the train loader alone, cotnet50's bf16 recipe train step and eval step
    fed by it (launches recorded in ``paths``), and the device backend."""
    import os
    import shutil
    import tempfile

    from cotnet_tpu_torch.data import native
    from cotnet_tpu_torch.data.dataset import ImageFolderDataset
    from cotnet_tpu_torch.data.loader import Loader

    t0 = time.perf_counter()
    try:
        import PIL
        pil = PIL.__version__
    except ImportError:
        pil = None
    cxx = shutil.which(native.CXX)
    cxx_version = (subprocess.run([cxx, "--version"], capture_output=True,
                                  text=True).stdout.splitlines()[0]
                   if cxx else "absent")
    log(f"data: host {os.cpu_count()} CPUs; Pillow {pil or 'absent'}; "
        f"{native.CXX} {cxx}: {cxx_version}")
    if not native.available():
        raise AssertionError(f"{native.CXX} did not build "
                             f"{native.SOURCE} into {native.library_path()}")
    log(f"data: native batch ops loaded from {native.library_path()}")
    kw = dict(batch_size=BATCH, image_size=IMAGE, workers=DATA_WORKERS,
              worker_procs=True, dtype=torch.bfloat16, device="cuda")
    with tempfile.TemporaryDirectory() as tmp:
        if pil:
            t1 = time.perf_counter()
            for split, n, seed in (("train", DATA_TRAIN_IMAGES, 0),
                                   ("val", DATA_VAL_IMAGES, 1)):
                write_image_tree(os.path.join(tmp, split), n, seed)
            train_ds = ImageFolderDataset(os.path.join(tmp, "train"))
            val_ds = ImageFolderDataset(os.path.join(tmp, "val"))
            log(f"data: wrote {len(train_ds)} train and {len(val_ds)} val "
                f"JPEGs ({DATA_SIZES[0][0]}x{DATA_SIZES[0][1]} and "
                f"{DATA_SIZES[1][0]}x{DATA_SIZES[1][1]}, quality 90, "
                f"{DATA_CLASSES} classes) in "
                f"{time.perf_counter() - t1:.1f} s")
        else:
            log("PIL absent: decode and host transforms not run on the card")
            train_ds = SeededImages(DATA_TRAIN_IMAGES, IMAGE, 0)
            val_ds = SeededImages(DATA_VAL_IMAGES, IMAGE, 1)
        train = Loader(train_ds, train=True, seed=0, **DATA_LOADER, **kw)
        val = Loader(val_ds, train=False, crop_pct=0.875,
                     interpolation="bicubic", **kw)
        try:
            loader_alone(train)
            loader_fed_train(la, paths, train, main_train)
            loader_fed_eval(la, paths, val)
        finally:
            train.close()
            val.close()
    device_backend_phase()
    log(f"data phase: {time.perf_counter() - t0:.1f} s")


def loader_alone(loader):
    """The train loader's images/s over an epoch and its H2D + device
    augment per batch; epoch 0 twice gives the same bytes, epoch 1 others."""
    t = time.perf_counter()
    loader.start_workers()
    # a spawned process re-imports the main script: through chip_smoke.py
    # the workers import torch, which the library's own modules do not
    log(f"data: {loader.workers} worker processes spawned in "
        f"{time.perf_counter() - t:.1f} s (they imported "
        f"{', '.join(loader.worker_imports) or 'neither torch nor jax'}; "
        f"the card hidden from them)")

    def epoch(e):
        loader.set_epoch(e)
        torch.cuda.synchronize()
        t = time.perf_counter()
        images = [b["image"] for b in loader]
        torch.cuda.synchronize()
        return images, time.perf_counter() - t

    first, secs = epoch(0)
    again, secs_again = epoch(0)
    other, _ = epoch(1)
    n = sum(x.shape[0] for x in first)
    if not (len(first) == len(loader) == DATA_TRAIN_IMAGES // BATCH
            and all(x.shape == (BATCH, 3, IMAGE, IMAGE)
                    and x.dtype == torch.bfloat16 and x.is_contiguous()
                    and x.is_cuda for x in first)):
        raise AssertionError(f"train loader batches: {len(first)}, "
                             f"{[tuple(x.shape) for x in first]}")
    if not all(torch.equal(a, b) for a, b in zip(first, again)):
        raise AssertionError("epoch 0 iterated twice gave other bytes")
    if any(torch.equal(a, b) for a, b in zip(first, other)):
        raise AssertionError("epoch 1 repeated a batch of epoch 0")
    host = loader.host_batches()
    imgs = next(host)[0]
    host.close()
    gen = torch.Generator(device="cuda")

    def h2d_augment():
        return loader.device_augment(imgs.to("cuda", non_blocking=True), gen)

    ms = wall_ms(h2d_augment)
    log(f"data: train loader ({', '.join(f'{k} {v}' for k, v in DATA_LOADER.items())}, "
        f"{loader.workers} worker processes, bs{BATCH} at {IMAGE}): "
        f"{n / secs_again:.1f} img/s over epoch 0's second pass ({n} "
        f"images in {secs_again:.3f} s; the first {n / secs:.1f} img/s); "
        f"H2D of the pinned uint8 batch + device augment {ms:.3f} ms a "
        f"batch (pinned: {imgs.is_pinned()}); epoch 0 twice the same bytes, "
        f"epoch 1 other bytes, on {nvidia_smi()}")


def loader_fed_train(la, paths: PathCounts, loader, main_train: dict):
    """cotnet50's bf16 recipe train step fed by the loader, two epochs: 2
    warm-up steps and the rest timed, launches recorded and checked."""
    from cotnet_tpu_torch.models import create_model

    model = create_model("cotnet50", device="cuda", dtype=torch.bfloat16,
                         seed=0, **RECIPE["model"])
    step, state = recipe_train_step(model)
    gen = torch.Generator(device="cuda").manual_seed(6)
    warmup, losses = 2, []
    la.reset_counts()
    torch.cuda.synchronize()
    for e in range(2):
        loader.set_epoch(e)
        for batch in loader:
            if len(losses) == warmup:
                torch.cuda.synchronize()
                t = time.perf_counter()
            state, m = step(state, batch, gen)
            losses.append(m["loss"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    steps = len(losses)
    check_path_launches(paths.record(la, "cotnet50 train (loader)", steps),
                        "train", "cotnet50", steps)
    losses = [float(v) for v in losses]
    if not all(v == v and abs(v) < float("inf") for v in losses):
        raise AssertionError(f"loader-fed train losses {losses}")
    # a step in the steady state: the loader has had a step's time to
    # prefetch the batch it takes
    loader.set_epoch(2)
    batches = iter(loader)
    state, _ = step(state, next(batches), gen)
    busy = profile_step(lambda: step(state, next(batches), gen),
                        "bf16 train step fed by the loader")
    batches.close()
    ips = (steps - warmup) * BATCH / secs

    def share(b):
        return "not measured" if b is None else (
            f"{100 * b[0] / b[1]:.1f}% ({b[0]:.1f} of {b[1]:.1f} ms)")

    log(f"data: bf16 train cotnet50 {IMAGE}x{IMAGE} bs{BATCH} fed by the "
        f"loader: {ips:.1f} img/s ({steps - warmup} timed steps after "
        f"{warmup}, across an epoch boundary; the train main path "
        f"{main_train['img_s']:.1f} img/s on random tensors in this call); "
        f"device busy in one profiled step with its batch fetch "
        f"{share(busy)}, the main path's {share(main_train['busy'])}; loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}; per step 16 launches each of "
        f"fwd, dx, dw, 0 plain calls")
    del model, step, state
    torch.cuda.empty_cache()


def loader_fed_eval(la, paths: PathCounts, loader):
    """cotnet50's bf16 eval step over the val loader: 165 images in two
    batches, the second padded with 37 valid; the step's counts against the
    unpadded logits."""
    from cotnet_tpu_torch.models import create_model
    from cotnet_tpu_torch.train.step import make_eval_step

    model = create_model("cotnet50", device="cuda", dtype=torch.bfloat16,
                         seed=0)
    eval_step = make_eval_step(model)
    loader.start_workers()
    la.reset_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    runs = [(b, eval_step(b)) for b in loader]
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    check_path_launches(paths.record(la, "cotnet50 eval (loader)", len(runs)),
                        "eval", "cotnet50", len(runs))
    torch.cuda.synchronize()
    t = time.perf_counter()
    for b in loader:
        eval_step(b)
    torch.cuda.synchronize()
    secs_again = time.perf_counter() - t
    valid = [int(b["valid"].sum()) for b, _ in runs]
    total = sum(float(out["n"]) for _, out in runs)
    if valid != [BATCH, DATA_VAL_IMAGES - BATCH] or total != DATA_VAL_IMAGES:
        raise AssertionError(f"eval valid counts {valid}, n {total}")
    top1 = 0
    with torch.no_grad():
        for (b, out), v in zip(runs, valid):
            # the step's rule for the top class (topk's first), so that a
            # tie of bf16 logits counts alike
            top = model(b["image"])[:v].float().topk(1).indices[:, 0]
            want = int((top == b["label"][:v]).sum())
            if float(out["top1_count"]) != want:
                raise AssertionError(f"eval top1 count {float(out['top1_count'])}"
                                     f", the unpadded logits' {want}")
            top1 += want
    log(f"data: bf16 eval cotnet50 {IMAGE}x{IMAGE} bs{BATCH} over the val "
        f"loader (ResizeCenterCrop 0.875 bicubic, draft decode): "
        f"{DATA_VAL_IMAGES} images in {len(runs)} batches ({valid} valid), "
        f"{DATA_VAL_IMAGES / secs_again:.1f} img/s on a second pass (the "
        f"first, the workers' first epoch, {DATA_VAL_IMAGES / secs:.1f}); "
        f"top1 {top1} (random weights), equal to the unpadded logits' "
        f"argmax; per step 16 fwd_affine launches, 0 plain calls")
    del model, eval_step
    torch.cuda.empty_cache()


def device_backend_phase(parity_n: int = 32):
    """One bs128 224 batch of each device augment (its ms a batch), then
    each policy on the card against the port's CPU result given the same
    draws, on ``parity_n`` images, at the CPU tests' tolerances
    (``tests/test_torch_augment.py``)."""
    import numpy as np

    from cotnet_tpu_torch.data.auto_augment import (
        augment_and_mix_transform, auto_augment_transform)
    from cotnet_tpu_torch.data.loader import make_device_augment
    from cotnet_tpu_torch.data.rand_augment import rand_augment_transform
    from cotnet_tpu_torch.data.random_erasing import RandomErasing

    cpu = torch.Generator().manual_seed(7)
    x_u8 = torch.randint(0, 256, (BATCH, IMAGE, IMAGE, 3), generator=cpu,
                         dtype=torch.uint8).cuda()
    gen = torch.Generator(device="cuda").manual_seed(0)
    normalized = make_device_augment(dtype=torch.bfloat16)(x_u8)
    cases = [
        ("rand-m15-mstd0.5-n2 (aug_backend='device')",
         rand_augment_transform("rand-m15-mstd0.5-n2"), None, 0),
        ("AutoAugment v0", auto_augment_transform("v0"), None, 0),
        ("augmix-m3-w3, num_aug_splits=3",
         augment_and_mix_transform("augmix-m3-w3"), None, 3),
        ("RandomErasing pixel, reprob 0.25, count 3", None,
         RandomErasing(0.25, mode="pixel", count=3), 0),
    ]
    for label, policy, erasing, splits in cases:
        fn = make_device_augment(policy=policy, random_erasing=erasing,
                                 dtype=torch.bfloat16, num_aug_splits=splits)
        out = fn(x_u8, gen)
        rows = BATCH * max(splits, 1)
        if not (out.shape == (rows, 3, IMAGE, IMAGE)
                and torch.isfinite(out.float()).all()):
            raise AssertionError(f"{label}: {tuple(out.shape)}")
        if splits and not torch.equal(out[:BATCH], normalized):
            raise AssertionError(f"{label}: the first split is not clean")
        ms = wall_ms(lambda: fn(x_u8, gen))
        # given the same draws: the policy on 0..255 images, the erasing on
        # normalized ones
        aug = policy or erasing
        x = x_u8[:parity_n].permute(0, 3, 1, 2).float().contiguous()
        if erasing is not None:
            x = torch.randn(x.shape, generator=cpu).cuda()
            draws = aug.draw(cpu, parity_n, 3, IMAGE, IMAGE)
        else:
            draws = aug.draw(cpu, parity_n, IMAGE, IMAGE)
        t = time.perf_counter()
        want = aug.apply(x.cpu(), draws).numpy()
        cpu_s = time.perf_counter() - t
        got = aug.apply(x, draws).cpu().numpy()
        err = np.abs(got - want)
        # the CPU tests' bounds (tests/test_torch_augment.py): erasing
        # exact; a policy's chain of ops within three times the affine
        # ops' bound, four roundings of a coordinate up to twice the image
        # size times a bilinear slope of 255 a pixel, on all but 0.1%
        tol = (0.0 if erasing is not None else
               float(3 * 4 * 255 * np.spacing(np.float32(2 * IMAGE))))
        beyond = int((err > tol).sum())
        if beyond > (0 if erasing is not None else 1e-3 * err.size):
            raise AssertionError(f"{label}: card against CPU, {beyond} of "
                                 f"{err.size} elements beyond {tol}, max "
                                 f"{err.max()}")
        log(f"data: device augment {label}: {ms:.3f} ms a bs{BATCH} "
            f"{IMAGE}x{IMAGE} batch ({rows} images out; host clock around "
            f"a synchronized call); card against CPU given the same draws "
            f"on {parity_n} images: max |err| {err.max():.3g}, {beyond} "
            f"elements beyond {tol} (CPU {cpu_s:.1f} s)")


# ---- phase 9: the CLI, checkpoints and the bench ---------------------------

def _edit_recipe(exp: str, old: str, new: str):
    """Replace one line of ``exp``'s config.yaml; raises if it is absent."""
    import os

    path = os.path.join(exp, "config.yaml")
    with open(path) as f:
        text = f.read()
    if text.count(old) != 1:
        raise AssertionError(f"{path}: {old!r} found {text.count(old)} times")
    with open(path, "w") as f:
        f.write(text.replace(old, new))


def cli_phase(la, paths: PathCounts, main_train: dict):
    """Phase 9: ``train_cli`` on the recipe (synthetic data, then JPEGs),
    ``--eval-only`` from the best checkpoint, resume at full width, the
    profiler around a CLI-built step, and the bench."""
    import os
    import shutil
    import tempfile

    t0 = time.perf_counter()
    recipe = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          CLI_RECIPE)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        exp = os.path.join(tmp, "exp")
        shutil.copytree(recipe, exp)
        _edit_recipe(exp, "recovery_interval: 10", "recovery_interval: 1")
        top1 = cli_synthetic(la, paths, exp)
        cli_eval_only(exp, top1)
        cli_jpegs(recipe, tmp)
        resume_check(exp)
        cli_step_profile(exp, tmp, main_train)
        bench_check()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"CLI phase: {time.perf_counter() - t0:.1f} s")


def _eval_lines(log_text: str) -> dict:
    """``(tag, epoch) -> (top1, top5, samples)`` from a log's eval lines,
    the first of each."""
    import re

    out = {}
    for m in re.finditer(r"eval(\(ema\))? epoch (\d+): top1 ([\d.]+) top5 "
                         r"([\d.]+) \((\d+) samples\)", log_text):
        out.setdefault((m.group(1) or "", int(m.group(2))),
                       (float(m.group(3)), float(m.group(4)),
                        int(m.group(5))))
    return out


def cli_synthetic(la, paths: PathCounts, exp: str) -> dict:
    """The recipe through ``train_cli.main`` on synthetic data: launches of
    its train and eval steps checked and recorded; the log and the files.
    Returns the log's eval lines."""
    import json
    import os

    from cotnet_tpu_torch import train_cli

    la.reset_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = train_cli.main(["--folder", exp, "--synthetic", "--steps",
                          str(CLI_STEPS), "--epochs", str(CLI_EPOCHS)])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    snapshot = launch_snapshot(la)
    train_steps = CLI_EPOCHS * CLI_STEPS
    # an eval a epoch of the live weights and one of the EMA, one batch each
    eval_steps = 2 * CLI_EPOCHS
    split = {kind: {"by_key": {k: c for k, c in snapshot["by_key"].items()
                               if (k[0] in PATH_KERNELS["train"])
                               == (kind == "train")},
                    "plain": snapshot["plain"]}
             for kind in ("train", "eval")}
    check_path_launches(split["train"], "train", "cotnet50", train_steps,
                        batch=CLI_BATCH)
    check_path_launches(split["eval"], "eval", "cotnet50", eval_steps)
    paths.record_snapshot(split["train"], "cotnet50 train (cli)", train_steps)
    paths.record_snapshot(split["eval"], "cotnet50 eval (cli)", eval_steps)

    with open(os.path.join(exp, "log.txt")) as f:
        text = f.read()
    evals = _eval_lines(text)
    want = {(tag, e) for tag in ("", "(ema)")
            for e in range(1, CLI_EPOCHS + 1)}
    if set(evals) != want or "done; best top1:" not in text \
            or any(v[2] != BATCH for v in evals.values()):
        raise AssertionError(f"CLI log: eval lines {evals}; 'done; best' "
                             f"{'done; best' in text}")
    ckpts = os.path.join(exp, "checkpoints")
    with open(os.path.join(ckpts, "index.json")) as f:
        index = json.load(f)
    with open(os.path.join(ckpts, "recovery.json")) as f:
        recovery = json.load(f)
    names = sorted(os.listdir(ckpts))
    want_names = sorted([f"checkpoint-{e}.pth.tar"
                         for e in range(1, CLI_EPOCHS + 1)]
                        + ["index.json", "last.pth.tar", "recovery.json",
                           "recovery.pth.tar"])
    if (names != want_names
            or sorted(e["epoch"] for e in index) != list(
                range(1, CLI_EPOCHS + 1))
            or os.readlink(os.path.join(ckpts, "last.pth.tar"))
            != f"checkpoint-{CLI_EPOCHS}.pth.tar"
            or recovery != {"epoch": CLI_EPOCHS}
            or out["state"].step != train_steps):
        raise AssertionError(f"CLI files {names}, index {index}, recovery "
                             f"{recovery}, step {out['state'].step}")
    sizes = {n: os.path.getsize(os.path.join(ckpts, n)) for n in names}
    log(f"cli: train_cli.main on {CLI_RECIPE} (synthetic, bs{CLI_BATCH} "
        f"train, bs{BATCH} eval, 224, {CLI_STEPS} steps x {CLI_EPOCHS} "
        f"epochs) in {secs:.1f} s: per train step 16 launches each of fwd, "
        f"dx, dw, per eval step 16 fwd_affine (the live weights and the EMA),"
        f" 0 plain calls; evals {evals}; best top1 {out['best']}; files "
        f"{sizes}")
    del out
    torch.cuda.empty_cache()
    return evals


def cli_eval_only(exp: str, evals: dict):
    """``--eval-only`` with ``model.resume`` at the best checkpoint: the
    same weights, and that epoch's top-1 and top-5."""
    import os

    from cotnet_tpu_torch import train_cli
    from cotnet_tpu_torch.utils.checkpoint import CheckpointSaver

    best = CheckpointSaver(os.path.join(exp, "checkpoints")).best()
    _edit_recipe(exp, "model:\n", f"model:\n  resume: '{best['path']}'\n")
    t = time.perf_counter()
    out = train_cli.main(["--folder", exp, "--synthetic", "--steps",
                          str(CLI_STEPS), "--eval-only"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    _edit_recipe(exp, f"model:\n  resume: '{best['path']}'\n", "model:\n")
    saved = torch.load(best["path"], map_location="cuda", weights_only=True)
    live = out["state"].model.state_dict()
    if not all(torch.equal(live[k], v) for k, v in saved["state_dict"].items()):
        raise AssertionError("--eval-only did not restore the best "
                             "checkpoint's weights")
    # as the log line prints them
    got = (float(f"{out['eval']['top1']:.3f}"),
           float(f"{out['eval']['top5']:.3f}"), int(out["eval"]["samples"]))
    want = evals[("", best["epoch"])]
    if got != want:
        raise AssertionError(f"--eval-only from epoch {best['epoch']}: "
                             f"{got}, that epoch's eval {want}")
    log(f"cli: --eval-only from the best checkpoint (epoch {best['epoch']}, "
        f"metric {best['metric']}) in {secs:.1f} s: top1/top5/samples {got}, "
        f"that epoch's eval {want}; the checkpoint's weights bit for bit")
    del out, saved, live
    torch.cuda.empty_cache()


def cli_jpegs(recipe: str, tmp: str):
    """One CLI epoch of 3 steps on phase 8's seeded JPEG tree (the recipe's
    loader, augmentation and 6 workers); its eval counts 165 samples."""
    import os
    import shutil

    from cotnet_tpu_torch import train_cli

    root = os.path.join(tmp, "images")
    for split, n, seed in (("train", DATA_TRAIN_IMAGES, 0),
                           ("val", DATA_VAL_IMAGES, 1)):
        write_image_tree(os.path.join(root, split), n, seed)
    exp = os.path.join(tmp, "exp_jpeg")
    shutil.copytree(recipe, exp)
    _edit_recipe(exp, "data_path: '/export/dataset/imagenet'",
                 f"data_path: '{root}'")
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = train_cli.main(["--folder", exp, "--steps", str(CLI_STEPS),
                          "--epochs", "1"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    if out["eval"]["samples"] != DATA_VAL_IMAGES or out["state"].step != \
            CLI_STEPS:
        raise AssertionError(f"CLI on JPEGs: eval {out['eval']}, step "
                             f"{out['state'].step}")
    log(f"cli: train_cli.main on {DATA_TRAIN_IMAGES} train and "
        f"{DATA_VAL_IMAGES} val JPEGs (the recipe's loader, 6 worker "
        f"processes, bs{CLI_BATCH}, {CLI_STEPS} steps, one epoch) in "
        f"{secs:.1f} s: eval {out['eval']}")
    del out
    torch.cuda.empty_cache()


def _recipe_state(cfg, seed: int):
    """A fresh cotnet50 TrainState and train step as ``train_cli`` builds
    them, the weights from ``seed``."""
    from cotnet_tpu_torch import train_cli
    from cotnet_tpu_torch.config import Config
    from cotnet_tpu_torch.train.state import TrainState
    from cotnet_tpu_torch.train.step import make_train_step

    cfg = Config(cfg, seed=float(seed))
    model, _ = train_cli.build_model(cfg, "cuda")
    schedule_fn, _, optimizer, loss, mixup_fn = train_cli.build_solver(
        cfg, model, CLI_STEPS)
    state = TrainState.create(model, optimizer, ema=True)
    step = make_train_step(model, optimizer, schedule_fn, loss,
                           ema_decay=cfg.model.model_ema_decay,
                           mixup_fn=mixup_fn)
    return state, step


def _cli_batch(i: int) -> dict:
    """The i-th batch of the resume check: seeded by i alone."""
    gen = torch.Generator(device="cuda").manual_seed(1000 + i)
    return {"image": torch.randn((CLI_BATCH, 3, IMAGE, IMAGE), generator=gen,
                                 device="cuda"),
            "label": torch.randint(0, 1000, (CLI_BATCH,), generator=gen,
                                   device="cuda")}


def _run_steps(state, step, cfg, first: int, last: int) -> list:
    from cotnet_tpu_torch import train_cli

    gen = torch.Generator(device="cuda")
    lrs = []
    for i in range(first, last):
        gen.manual_seed(train_cli.step_seed(int(cfg.seed) + 777, state.step))
        state, m = step(state, _cli_batch(i), gen)
        lrs.append(m["lr"])
    return lrs


def _state_tensors(state) -> dict:
    """Every tensor a resumed state must match, by name."""
    out = {f"model.{k}": v for k, v in state.model.state_dict().items()}
    out.update({f"ema.{k}": v for k, v in state.ema.items()})
    for i, s in state.optimizer.state_dict()["state"].items():
        out.update({f"optimizer.{i}.{k}": v for k, v in s.items()
                    if torch.is_tensor(v)})
    return out


def resume_check(exp: str):
    """2N uninterrupted steps against N, ``save_recovery``, a restore into a
    fresh model and optimizer, N more: the same bits, with cuDNN
    deterministic (the port's kernels use no atomics)."""
    import os

    from cotnet_tpu_torch.config import load_experiment
    from cotnet_tpu_torch.utils.checkpoint import CheckpointSaver

    cfg = load_experiment(exp)
    n = RESUME_STEPS
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    try:
        state_a, step_a = _recipe_state(cfg, int(cfg.seed))
        lrs_a = _run_steps(state_a, step_a, cfg, 0, 2 * n)
        want = {k: v.clone() for k, v in _state_tensors(state_a).items()}
        want_step = state_a.step
        del state_a, step_a
        torch.cuda.empty_cache()

        state_b, step_b = _recipe_state(cfg, int(cfg.seed))
        lrs_b = _run_steps(state_b, step_b, cfg, 0, n)
        saver = CheckpointSaver(os.path.join(exp, "resume"),
                                recovery_interval=1, arch="cotnet50")
        torch.cuda.synchronize()
        t = time.perf_counter()
        saver.save_recovery(state_b, 1)
        save_ms = (time.perf_counter() - t) * 1e3
        del state_b, step_b
        torch.cuda.empty_cache()
        # a fresh model of other weights and a fresh optimizer
        state_c, step_c = _recipe_state(cfg, int(cfg.seed) + 1)
        torch.cuda.synchronize()
        t = time.perf_counter()
        saver.restore(state_c, saver.find_recovery()["path"])
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t) * 1e3
        lrs_b += _run_steps(state_c, step_c, cfg, n, 2 * n)
        got = _state_tensors(state_c)
        bad = sorted(k for k, v in want.items()
                     if k not in got or not torch.equal(got[k], v))
        if bad or set(got) != set(want) or lrs_a != lrs_b \
                or state_c.step != want_step:
            raise AssertionError(
                f"resumed run differs from the uninterrupted one: "
                f"{len(bad)} tensors ({bad[:8]}), LRs {lrs_a} / {lrs_b}, "
                f"step {state_c.step} / {want_step}")
        size = os.path.getsize(saver.find_recovery()["path"])
        tensors = len(want)
        del state_c, step_c, got, want
    finally:
        torch.backends.cudnn.deterministic, \
            torch.backends.cudnn.benchmark = flags
    torch.cuda.empty_cache()
    log(f"cli: resume at full width (cotnet50 bf16 224 bs{CLI_BATCH}, the "
        f"recipe's nesterov SGD, cosine warm-up, EMA, mixup and cutmix, "
        f"drop 0.25, drop path 0.1; cuDNN deterministic): {2 * n} "
        f"uninterrupted steps against {n}, save_recovery, restore into a "
        f"fresh model and optimizer, {n} more: parameters, BN stats, EMA, "
        f"optimizer state ({tensors} tensors), step "
        f"and LRs {lrs_a} the same bits; save {save_ms:.1f} ms, restore "
        f"{restore_ms:.1f} ms, {size / 2**20:.1f} MiB")


def cli_step_profile(exp: str, tmp: str, main_train: dict):
    """The CLI-built train step at the recipe's batch: its ms over timed
    steps, and one step under ``utils.profiler.trace``, whose Chrome trace
    must hold 16 launches each of the k3 forward, dx and dw."""
    import json
    import os
    import re

    from cotnet_tpu_torch.config import load_experiment
    from cotnet_tpu_torch.utils import profiler

    cfg = load_experiment(exp)
    state, step = _recipe_state(cfg, int(cfg.seed))
    _run_steps(state, step, cfg, 0, 2)
    torch.cuda.synchronize()
    t, timed = time.perf_counter(), 5
    _run_steps(state, step, cfg, 2, 2 + timed)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3 / timed
    trace_dir = os.path.join(tmp, "trace")
    with profiler.trace(trace_dir):
        with profiler.annotate("cli train step"):
            _run_steps(state, step, cfg, 7, 8)
    with open(os.path.join(trace_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    counts = {name: sum(1 for k in kernels
                        if re.search(rf"\b{name}<[^<>]*,\s*3>", k))
              for name in ("local_agg_fwd", "local_agg_bwd_dx",
                           "local_agg_bwd_dw")}
    annotated = any(e.get("name") == "cli train step" for e in events)
    if set(counts.values()) != {16} or not annotated:
        raise AssertionError(f"the trace's k3 kernels {counts}, annotation "
                             f"{annotated}")
    size = os.path.getsize(os.path.join(trace_dir, "trace.json"))
    log(f"cli: the CLI-built bf16 train step (bs{CLI_BATCH} 224, the "
        f"recipe): {ms:.1f} ms a step, {CLI_BATCH * 1e3 / ms:.1f} img/s over "
        f"{timed} steps (host clock, synchronized; the train main path "
        f"{main_train['img_s']:.1f} img/s at bs{BATCH} in this call); "
        f"utils.profiler.trace wrote a {size / 2**20:.1f} MiB Chrome trace "
        f"of one step with {len(kernels)} device kernels, the k3 ones "
        f"{counts}")
    del state, step
    torch.cuda.empty_cache()


def bench_check():
    """``cotnet_tpu_torch.bench.main()`` at its defaults (it prints its JSON
    line); both sides of each pair finite and positive."""
    from cotnet_tpu_torch import bench

    t = time.perf_counter()
    result = bench.main()
    d = result["detail"]
    sides = [d[k] for k in ("pallas_ips", "xla_ips", "train_imgs_per_sec",
                            "train_imgs_per_sec_xla")]
    if d["platform"] != "gpu" or not all(0 < v < float("inf")
                                         for v in sides):
        raise AssertionError(f"bench result {result}")
    log(f"bench: {time.perf_counter() - t:.1f} s; eval kernels/plain "
        f"{result['vs_baseline']:.4f}, train {d['train_vs_baseline']:.4f}")


# ---- phase 10: data parallelism ---------------------------------------------

def _dp_model_and_batch(rows: slice):
    """Check (b)'s cotnet50 in f32 without drop layers, its recipe train
    step (mixup over the global batch, nesterov SGD, the EMA) and this
    process's rows of the global batch of DP_BATCH seeded images."""
    from cotnet_tpu_torch.models import create_model

    model = create_model("cotnet50", device="cuda", seed=0)
    step, state = recipe_train_step(model, DP_RECIPE, DP_BATCH)
    gen = torch.Generator(device="cuda").manual_seed(4)
    labels = torch.randint(0, 1000, (DP_BATCH,), generator=gen,
                           device="cuda")
    return step, state, {"image": images_f32(DP_BATCH)[rows],
                         "label": labels[rows]}


def _dp_fingerprint(state, loss: float) -> dict:
    """test_multiproc's fingerprints (the loss, the sums of |parameters| and
    of |BN running means| in f64), a digest of every parameter and buffer's
    bits, and the parameters as one f64 vector on the CPU."""
    import hashlib

    sd = state.model.state_dict()
    digest = hashlib.sha256()
    for k in sorted(sd):
        digest.update(sd[k].detach().cpu().numpy().tobytes())
    params = torch.cat([p.detach().double().flatten()
                        for p in state.model.parameters()])
    return {"loss": loss, "p": float(params.abs().sum()),
            "b": float(sum(v.double().abs().sum() for k, v in sd.items()
                           if k.endswith("running_mean"))),
            "digest": digest.hexdigest(), "params": params.cpu()}


def _dp_steps(step, state, batch, gen_seed: int = 6):
    """DP_STEPS steps; (losses, ms of each step)."""
    gen = torch.Generator(device="cuda")
    losses, times = [], []
    for i in range(DP_STEPS):
        gen.manual_seed(gen_seed + i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch, gen)
        losses.append(float(m["loss"]))
        times.append((time.perf_counter() - t0) * 1e3)
    return losses, times


def _dp_rank(rank: int, world: int, backend: str, init_method: str, queue):
    """One rank of a data-parallel group of ``world`` CUDA ranks: under
    gloo all on card 0 (check (b)), under NCCL rank r on card r
    (``tools/torch_dp_cards.py``).  Puts (rank, result or the error's
    text)."""
    try:
        import torch.distributed as dist

        from cotnet_tpu_torch.ops import local_agg as la
        from cotnet_tpu_torch.parallel import mesh
        from cotnet_tpu_torch.parallel.collectives import CollectiveTimer

        torch.cuda.set_device(rank if backend == "nccl" else 0)
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        with tf32_off():
            mesh.initialize_distributed(init_method, world, rank,
                                        backend=backend, device="cuda")
            step, state, batch = _dp_model_and_batch(
                mesh.rank_rows(DP_BATCH))
            la.reset_counts()
            with CollectiveTimer() as timer:
                losses, times = _dp_steps(step, state, batch)
            snapshot = launch_snapshot(la)
            routes = sorted({la.kernel_route(
                kernel, torch.empty(key[2], device="cuda"),
                torch.empty(key[3], device="cuda"), kernel_size=(3, 3),
                dilation=key[4], padding=key[5])
                for kernel, key in snapshot["by_key"]})
            fp = _dp_fingerprint(state, losses[-1])
            if rank:  # rank 0's parameters stand for both (same digest)
                fp.pop("params")
            dist.barrier()
            dist.destroy_process_group()
        queue.put((rank, dict(
            fp, losses=losses, times=times, routes=routes,
            plain=snapshot["plain"],
            launches={k: sum(c for (kern, _), c in snapshot["by_key"].items()
                             if kern == k) for k in ("fwd", "dx", "dw")},
            batch_shapes=sorted({key[2][0] for _, key in snapshot["by_key"]}),
            collectives=timer.by,
            peak=torch.cuda.max_memory_allocated())))
    except BaseException as e:  # reported to the parent, which raises
        import traceback
        queue.put((rank, traceback.format_exc()))
        raise SystemExit(1) from e


def dp_nccl_cli(la, paths: PathCounts):
    """Check (a): a world-size-1 NCCL group under torchrun's environment
    variables; an all-reduce of a card tensor in it (raw, and through
    ``scaled_all_reduce``); then the CLI's synthetic run inside the group,
    whose launches are recorded as "cotnet50 train (cli, nccl)" and
    "cotnet50 eval (cli, nccl)"."""
    import os
    import shutil
    import tempfile

    import torch.distributed as dist

    from cotnet_tpu_torch import train_cli
    from cotnet_tpu_torch.parallel import mesh
    from cotnet_tpu_torch.parallel.collectives import (CollectiveTimer,
                                                       scaled_all_reduce)

    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(mesh.free_port())}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    try:
        if not mesh.initialize_distributed():
            raise AssertionError("no group under torchrun's environment")
        backend = dist.get_backend()
        nccl = torch.cuda.nccl.version()
        t = torch.randn(22222416, device="cuda")
        raw = t.clone()
        dist.all_reduce(raw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            dist.all_reduce(raw)
        torch.cuda.synchronize()
        ar_ms = (time.perf_counter() - t0) * 100
        scaled = scaled_all_reduce([t])[0]
        if backend != "nccl" or not (torch.equal(raw, t)
                                     and torch.equal(scaled, t)):
            raise AssertionError(f"world-size-1 {backend} all-reduce "
                                 "changed the tensor")
        log(f"dp (a): torch.distributed.is_nccl_available() "
            f"{dist.is_nccl_available()}, NCCL {nccl}, backend {backend}, "
            f"world {dist.get_world_size()}, device {mesh.local_device()}; "
            f"an all-reduce of cotnet50's {t.numel()} f32 gradients "
            f"(88.9 MB) at world size 1: {ar_ms:.3f} ms, and "
            "scaled_all_reduce leaves it as it is")
        exp = os.path.join(tmp, "exp")
        shutil.copytree(os.path.join(os.path.dirname(
            os.path.abspath(__file__)), CLI_RECIPE), exp)
        la.reset_counts()
        with CollectiveTimer() as timer:
            out = train_cli.main(["--folder", exp, "--synthetic", "--steps",
                                  str(CLI_STEPS), "--epochs", "1"])
        torch.cuda.synchronize()
        if not dist.is_initialized():
            raise AssertionError("the CLI left the caller's group")
        if timer.by:  # every collective is the identity at world size 1
            raise AssertionError(f"all-reduces at world size 1: {timer.by}")
        snapshot = launch_snapshot(la)
        split = {kind: {"by_key": {
            k: c for k, c in snapshot["by_key"].items()
            if (k[0] in PATH_KERNELS["train"]) == (kind == "train")},
            "plain": snapshot["plain"]} for kind in ("train", "eval")}
        check_path_launches(split["train"], "train", "cotnet50", CLI_STEPS,
                            batch=CLI_BATCH)
        check_path_launches(split["eval"], "eval", "cotnet50", 2)
        paths.record_snapshot(split["train"], "cotnet50 train (cli, nccl)",
                              CLI_STEPS)
        paths.record_snapshot(split["eval"], "cotnet50 eval (cli, nccl)", 2)
        files = sorted(os.listdir(os.path.join(exp, "checkpoints")))
        if "checkpoint-1.pth.tar" not in files or out["state"].step != \
                CLI_STEPS:
            raise AssertionError(f"CLI in the NCCL group: files {files}, "
                                 f"step {out['state'].step}")
        log(f"dp (a): train_cli.main in the world-size-1 NCCL group "
            f"(synthetic, bs{CLI_BATCH}, {CLI_STEPS} steps, one epoch): 16 "
            f"launches each of fwd, dx, dw a train step, 16 fwd_affine an "
            f"eval step, 0 plain calls, 0 all-reduces; rank 0 wrote "
            f"{files}")
        del out
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()


def dp_against_one_process(la, world: int = DP_RANKS, backend: str = "gloo",
                           label: str = "dp (b)"):
    """``world`` CUDA ranks, each on its rows of cotnet50's global batch of
    DP_BATCH in f32 (TF32 off, cuDNN deterministic), DP_STEPS recipe steps;
    held against one process on the whole batch, and against that
    process's own noise (the same run on images scaled by 1 + 1e-7).
    Check (b) is two gloo ranks sharing the card (NCCL refuses two ranks
    on a device); ``tools/torch_dp_cards.py`` runs NCCL ranks, one a
    card.  Returns rank 0's collectives a step by helper (calls, MB,
    ms)."""
    import torch.multiprocessing as mp

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        with tf32_off():
            runs = {}
            for run, scale in (("one", 1.0), ("noise", 1.0 + 1e-7)):
                step, state, batch = _dp_model_and_batch(slice(0, DP_BATCH))
                batch["image"] = batch["image"] * scale
                la.reset_counts()
                losses, times = _dp_steps(step, state, batch)
                if run == "one":
                    plain, fwd = launch_snapshot(la)["plain"], la.LAUNCHES
                runs[run] = dict(_dp_fingerprint(state, losses[-1]),
                                   losses=losses, times=times)
                del step, state, batch
                torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = False
    if plain or fwd != 16 * DP_STEPS:
        raise AssertionError(f"one process: {fwd} forward launches, {plain} "
                             "plain calls")

    import queue as queues

    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    from cotnet_tpu_torch.parallel.mesh import free_port

    init = f"tcp://127.0.0.1:{free_port()}"
    t0 = time.perf_counter()
    procs = [ctx.Process(target=_dp_rank, args=(r, world, backend, init,
                                                queue))
             for r in range(world)]
    for p in procs:
        p.start()
    ranks = {}
    try:
        # read before joining: a rank exits once its result is read
        while len(ranks) < world:
            r, res = queue.get(timeout=max(1.0, 300 - (time.perf_counter()
                                                       - t0)))
            ranks[r] = res
            if isinstance(res, str):
                break
        for p in procs:
            p.join(max(1.0, 300 - (time.perf_counter() - t0)))
    except queues.Empty:
        pass
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    if len(ranks) != world or any(isinstance(v, str)
                                  for v in ranks.values()) \
            or any(p.exitcode for p in procs):
        raise AssertionError(f"{label}: exit codes "
                             f"{[p.exitcode for p in procs]}: {ranks}")
    secs = time.perf_counter() - t0
    a = ranks[0]
    if any((res["digest"], res["losses"]) != (a["digest"], a["losses"])
           for res in ranks.values()):
        raise AssertionError(f"{label}: the ranks hold different bits")
    for r, res in ranks.items():
        if (res["launches"] != {k: 16 * DP_STEPS for k in ("fwd", "dx", "dw")}
                or res["plain"] or res["routes"] != ["k3"]
                or res["batch_shapes"] != [DP_BATCH // world]):
            raise AssertionError(f"{label} rank {r}: launches "
                                 f"{res['launches']}, plain {res['plain']}, "
                                 f"routes {res['routes']}, batches "
                                 f"{res['batch_shapes']}")
    one, noise = runs["one"], runs["noise"]

    def rel(x, y):
        return abs(x - y) / abs(y)

    def dist_params(x):
        return float((x["params"] - one["params"]).norm()
                     / one["params"].norm())

    got = {k: rel(a[k], one[k]) for k in ("loss", "p", "b")}
    floor = {k: rel(noise[k], one[k]) for k in ("loss", "p", "b")}
    limits = {"loss": 2e-5, "p": 1e-4, "b": 1e-4}
    bad = {k: v for k, v in got.items()
           if v > max(limits[k], 3 * floor[k])}
    if bad:
        raise AssertionError(f"{label} against one process: {bad}, limits "
                             f"{limits}, the one process's noise {floor}")
    per_step = {k: (round(c / DP_STEPS, 1), round(b / DP_STEPS / 1e6, 3),
                    round(ms / DP_STEPS, 2))
                for k, (c, b, ms) in a["collectives"].items()}
    where = "on one card" if backend == "gloo" else "one a card"
    log(f"{label}: {world} {backend} ranks {where} (CUDA tensors), cotnet50 "
        f"f32 224 global bs{DP_BATCH} ({DP_BATCH // world} a rank), "
        f"{DP_STEPS} recipe steps at the base LR (mixup over the global "
        f"batch, nesterov, EMA; TF32 off, cuDNN deterministic) in {secs:.1f} s with the "
        f"spawn: the ranks hold the same bits ({a['digest'][:16]}); each "
        f"{16 * DP_STEPS} launches of fwd, dx and dw on the k3 route, 0 "
        f"plain calls; losses {a['losses']} against one process's "
        f"{one['losses']}; relative differences {got} (limits {limits}, "
        f"one process's own noise {floor}); parameters' relative L2 "
        f"distance {dist_params(a):.3e} (noise {dist_params(noise):.3e}); "
        f"rank step ms {[round(t, 1) for t in a['times']]} against one "
        f"process's {[round(t, 1) for t in one['times']]}; rank 0's "
        f"collectives a step by helper (calls, MB, ms on the stream): "
        f"{per_step}; peak "
        f"memory {a['peak'] / 2 ** 30:.2f} GiB a rank")
    return per_step


def dp_phase(la, paths: PathCounts):
    """Phase 10: checks (a) and (b)."""
    t0 = time.perf_counter()
    dp_nccl_cli(la, paths)
    dp_against_one_process(la)
    log(f"data-parallel phase: {time.perf_counter() - t0:.1f} s")


# ---- phase 11: the plain ResNet chassis --------------------------------------

def chassis_logits(name: str):
    """f32 logits of ``name`` (seeded weights, BN stats calibrated on the
    images, the last BN of each block not zero) on the card against the
    port on the CPU, TF32 off, at 1e-3 of the largest logit."""
    from cotnet_tpu_torch.models import create_model

    cpu = create_model(name, device="cpu", seed=0, zero_init_last_bn=False)
    gen = torch.Generator().manual_seed(9)
    x = torch.randn(4, 3, IMAGE, IMAGE, generator=gen) \
        * torch.linspace(0.5, 2.0, 4)[:, None, None, None]
    calibrate_bn(cpu, x, seed=1)
    card = create_model(name, device="cuda", seed=0,
                        zero_init_last_bn=False)
    card.load_state_dict(cpu.state_dict())
    with torch.no_grad(), tf32_off():
        ref = cpu(x)
        got = card(x.cuda()).cpu()
    err = float((got - ref).abs().max())
    limit = 1e-3 * float(ref.abs().max())
    if not err <= limit:
        raise AssertionError(f"{name} f32 logits, card against CPU: max "
                             f"|err| {err} > {limit}")
    return err, limit


def chassis_phase(la):
    """Phase 11: seresnet50's bf16 eval and train steps at 224 bs128 (the
    CoTNet-50 recipe's drop rates, mixup, solver and EMA), resnet18's and
    ecaresnet50d's eval, and each model's f32 logits on the card against
    the CPU.  The chassis runs no op of the port: no launch and no plain
    call."""
    from cotnet_tpu_torch.models import create_model
    from cotnet_tpu_torch.train.step import make_eval_step

    t_phase = time.perf_counter()
    batch = make_batch()
    la.reset_counts()
    for name in CHASSIS_MODELS:
        err, limit = chassis_logits(name)
        torch.cuda.reset_peak_memory_stats()
        model = create_model(name, device="cuda", dtype=torch.bfloat16,
                             seed=0)
        eval_step = make_eval_step(model)
        times = []
        for i in range(2 + 5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = eval_step(batch)
            torch.cuda.synchronize()
            if i >= 2:
                times.append(time.perf_counter() - t0)
        top1, top5, n = (float(out[k]) for k in ("top1_count", "top5_count",
                                                  "n"))
        if not 0 <= top1 <= top5 <= n == BATCH - 8:
            raise AssertionError(f"{name} eval: {top1} {top5} {n}")
        kernels, busy = device_kernels(lambda: eval_step(batch))
        median = statistics.median(times)
        log(f"chassis: {name} f32 logits, card against CPU: max |err| "
            f"{err:.3e} (limit {limit:.3e}); bf16 eval 224 bs{BATCH}: "
            f"{BATCH / median:.1f} img/s ({median * 1e3:.2f} ms a step, "
            f"median of 5), {kernels} device kernels busy {busy:.2f} ms a "
            f"step, peak memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB on "
            f"{nvidia_smi()}")
        if name == "seresnet50":
            del eval_step, out
            torch.cuda.reset_peak_memory_stats()
            model = create_model(name, device="cuda", dtype=torch.bfloat16,
                                 seed=0, **RECIPE["model"])
            step, state = recipe_train_step(model)
            gen = torch.Generator(device="cuda").manual_seed(6)
            images = {"image": batch["image"], "label": batch["label"]}
            times, losses = [], []
            for i in range(1 + CHASSIS_TRAIN_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, m = step(state, images, gen)
                losses.append(float(m["loss"]))
                if i >= 1:
                    times.append(time.perf_counter() - t0)
            peak = torch.cuda.max_memory_allocated()
            kernels, busy = device_kernels(
                lambda: step(state, images, gen))
            if not all(v == v and abs(v) < float("inf") for v in losses):
                raise AssertionError(f"{name} train losses {losses}")
            median = statistics.median(times)
            log(f"chassis: {name} bf16 train 224 bs{BATCH} (the CoTNet-50 "
                f"recipe: mixup/cutmix, drop 0.25, drop path 0.1, nesterov, "
                f"EMA): {BATCH / median:.1f} img/s ({median * 1e3:.1f} ms a "
                f"step, median of {CHASSIS_TRAIN_STEPS} after one warm-up), "
                f"{kernels} device kernels busy {busy:.2f} ms a step, peak "
                f"memory {peak / 2 ** 30:.2f} GiB, losses {losses}")
            del step, state
        del model
        torch.cuda.empty_cache()
    snapshot = launch_snapshot(la)
    if snapshot["by_key"] or snapshot["plain"]:
        raise AssertionError(f"the chassis reached the op: {snapshot}")
    log(f"chassis phase: {time.perf_counter() - t_phase:.1f} s")


# ---- phase 13: the CoT paper's comparison families --------------------------

def family_f32_checks(la, name: str):
    """f32 at bs4 with TF32 off, seeded weights with BN statistics
    calibrated on the images: the logits on the card against the port on
    the CPU at 1e-3 of the largest logit; for the models with the op, the
    logits through the kernels against the plain path on the card, each
    aggregation one forward launch and no plain call, and every dx and dw
    launch of one backward held against the plain backward on the model's
    own tensors (1e-5 of the largest); five steps that lower the loss."""
    from cotnet_tpu_torch.models import create_model

    size = MODELS[name][2] if name in MODELS else FAMILY_EVAL_MODELS[name]
    layers = (sum(per_step for _, _, per_step, *_ in MODELS[name][1])
              if name in UNFOLDED_MODELS else 0)
    from cotnet_tpu_torch.nn import BatchNorm2d

    cpu = create_model(name, device="cpu", seed=0)
    gen = torch.Generator().manual_seed(9)
    x = torch.randn(4, 3, size, size, generator=gen) \
        * torch.linspace(0.5, 2.0, 4)[:, None, None, None]
    if any(isinstance(m, BatchNorm2d) for m in cpu.modules()):
        calibrate_bn(cpu, x, seed=1)
    card = create_model(name, device="cuda", seed=0)
    card.load_state_dict(cpu.state_dict())
    xc = x.cuda()
    with torch.no_grad(), tf32_off():
        ref = cpu(x)
        la.reset_counts()
        got = card(xc)
        torch.cuda.synchronize()
        counts = (la.LAUNCHES, la.PLAIN_CALLS)
        got = got.cpu()
    del cpu
    scale = float(ref.abs().max())
    err = float((got - ref).abs().max())
    if not (torch.isfinite(got).all() and got.shape == (4, 1000)
            and err <= 1e-3 * scale):
        raise AssertionError(f"{name} f32 logits {tuple(got.shape)}, card "
                             f"against CPU: max|err| {err}, max|logit| "
                             f"{scale}")
    if counts != (layers, 0):
        raise AssertionError(f"{name} f32 forward: (launches, plain calls) "
                             f"{counts}, want ({layers}, 0)")
    note = ""
    if layers:
        plain = create_model(name, device="cuda",
                             block_args=dict(impl="torch"))
        plain.load_state_dict(card.state_dict())
        with torch.no_grad(), tf32_off():
            ref_card = plain(xc).cpu()
        del plain
        err_plain = float((got - ref_card).abs().max())
        if not err_plain <= 1e-3 * scale:
            raise AssertionError(f"{name} f32 logits, kernels against the "
                                 f"plain path: max|err| {err_plain}")
        labels = torch.randint(0, 1000, (4,), device="cuda",
                               generator=torch.Generator("cuda").manual_seed(4))
        strict = backward_launches_match_plain(la, card, xc, labels, layers)
        note = (f"; kernels against the plain path on the card max|diff| "
                f"{err_plain:.3g}, {layers} launches and no plain call a "
                f"forward; each of the {layers} dx and {layers} dw launches "
                f"of a backward against the plain backward on the model's "
                f"own tensors: worst max|err|/max|ref| {strict:.3g} (limit "
                f"1e-5)")
    log(f"{name} f32 bs4 {size}x{size}: logits on the card against the CPU "
        f"max|err| {err:.3g} of max|logit| {scale:.3g} (limit 1e-3){note}")
    loss_falls(la, card, xc)
    del card
    torch.cuda.empty_cache()


def family_eval_without_op(la, name: str, size: int, timed: int = 4):
    """The bf16 eval step of a family without the op at bs128: images/s,
    device kernels and busy ms a step, peak memory; no launch of the op
    and no plain call."""
    from cotnet_tpu_torch.models import create_model
    from cotnet_tpu_torch.train.step import make_eval_step

    batch = make_batch(BATCH, size)
    torch.cuda.reset_peak_memory_stats()
    model = create_model(name, device="cuda", dtype=torch.bfloat16, seed=0)
    eval_step = make_eval_step(model)
    la.reset_counts()
    times = []
    for i in range(2 + timed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eval_step(batch)
        torch.cuda.synchronize()
        if i >= 2:
            times.append(time.perf_counter() - t0)
    top1, top5, n = (float(out[k]) for k in ("top1_count", "top5_count",
                                              "n"))
    if not 0 <= top1 <= top5 <= n == BATCH - 8:
        raise AssertionError(f"{name} eval: {top1} {top5} {n}")
    snapshot = launch_snapshot(la)
    if snapshot["by_key"] or snapshot["plain"]:
        raise AssertionError(f"{name} reached the op: {snapshot}")
    kernels, busy = device_kernels(lambda: eval_step(batch))
    median = statistics.median(times)
    log(f"bf16 {name} eval {size}x{size} bs{BATCH}: {BATCH / median:.1f} "
        f"img/s ({median * 1e3:.2f} ms a step, median of {timed}), {kernels} "
        f"device kernels busy {busy:.2f} ms a step, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB on "
        f"{nvidia_smi()}; no launch of the op, 0 plain calls")
    del model, eval_step
    torch.cuda.empty_cache()


def remat_card(la, paths: PathCounts, timed: int = 4):
    """``remat`` on the card: cotnet50's bf16 recipe train step at bs128
    with it and without it (images/s, peak memory; with it the forward
    kernel launches again in the recompute, dx and dw once a layer, no
    plain call), then in f32 at bs16 (TF32 off, cuDNN deterministic) two
    steps with drop path and dropout on: the same losses and parameter and
    BN bits with and without it."""
    from cotnet_tpu_torch.models import create_model
    from cotnet_tpu_torch.train.loss import create_loss_fn
    from cotnet_tpu_torch.train.optim import create_optimizer
    from cotnet_tpu_torch.train.state import TrainState, float_state
    from cotnet_tpu_torch.train.step import make_train_step

    batch = make_batch()
    images = {"image": batch["image"], "label": batch["label"]}
    line = []
    for remat in (False, True):
        torch.cuda.reset_peak_memory_stats()
        model = create_model("cotnet50", device="cuda", dtype=torch.bfloat16,
                             seed=0, remat=remat, **RECIPE["model"])
        step, state = recipe_train_step(model)
        gen = torch.Generator(device="cuda").manual_seed(6)
        steps = 2 + timed
        la.reset_counts()
        times = []
        for i in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, images, gen)
            torch.cuda.synchronize()
            if i >= 2:
                times.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated()
        fwd, bwd = la.LAUNCHES, dict(la.BWD_LAUNCHES)
        if remat:
            snapshot = paths.record(la, "cotnet50 train (remat)", steps)
            if not (bwd == {"dx": 16 * steps, "dw": 16 * steps}
                    and 16 * steps < fwd <= 32 * steps
                    and not snapshot["plain"]
                    and {k for k, _ in snapshot["by_key"]}
                    == {"fwd", "dx", "dw"}):
                raise AssertionError(f"remat train: fwd {fwd}, bwd {bwd}, "
                                     f"{snapshot}")
        if not float(m["loss"]) == float(m["loss"]):
            raise AssertionError(f"remat={remat} train loss {m['loss']}")
        median = statistics.median(times)
        line.append(f"remat={remat}: {BATCH / median:.1f} img/s "
                    f"({median * 1e3:.1f} ms a step), peak memory "
                    f"{peak / 2 ** 30:.2f} GiB, launches a step fwd "
                    f"{fwd / steps:.0f} dx {bwd['dx'] / steps:.0f} dw "
                    f"{bwd['dw'] / steps:.0f}")
        del model, step, state
        torch.cuda.empty_cache()
    log(f"bf16 cotnet50 train {IMAGE}x{IMAGE} bs{BATCH} under the recipe on "
        f"{nvidia_smi()}: " + "; ".join(line))

    x = images_f32()
    batch16 = {"image": x, "label": torch.randint(
        0, 1000, (x.shape[0],), device="cuda",
        generator=torch.Generator("cuda").manual_seed(5))}
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    runs = {}
    try:
        with tf32_off():
            for remat in (False, True):
                model = create_model("cotnet50", device="cuda", seed=0,
                                     remat=remat, drop_rate=0.25,
                                     drop_path_rate=0.1)
                optimizer = create_optimizer(RECIPE["solver"],
                                             model.parameters())
                loss_fn, _ = create_loss_fn(RECIPE["loss"], False)
                step = make_train_step(model, optimizer, lambda s: 0.01,
                                       loss_fn)
                state = TrainState.create(model, optimizer)
                gen = torch.Generator("cuda").manual_seed(11)
                losses = []
                for _ in range(2):
                    state, m = step(state, batch16, gen)
                    losses.append(torch.as_tensor(m["loss"]).clone())
                runs[remat] = (losses, {k: v.detach().clone() for k, v in
                                        float_state(model).items()},
                               gen.get_state())
                del model, optimizer, step, state
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark \
            = flags
    (l0, p0, g0), (l1, p1, g1) = runs[False], runs[True]
    differ = [k for k in p0 if not torch.equal(p0[k], p1[k])]
    if not (all(torch.equal(a, b) for a, b in zip(l0, l1)) and not differ
            and torch.equal(g0, g1)):
        raise AssertionError(f"f32 remat: losses {l0} against {l1}, "
                             f"{len(differ)} tensors differ ({differ[:5]})")
    log(f"f32 cotnet50 bs{x.shape[0]}, two steps with drop path 0.1 and "
        f"dropout 0.25 (TF32 off, cuDNN deterministic): remat gives the "
        f"same losses ({', '.join(f'{float(v):.6f}' for v in l1)}), the "
        f"same bits in all {len(p0)} parameters and BN statistics, and the "
        f"same generator state")
    torch.cuda.empty_cache()


def feature_and_dilation_smoke(la, timed: int = 4):
    """cotnet50 with ``features_only``: its five maps' channels and
    reductions at 224 equal ``FeatureInfo``'s; cotnet50 at output stride
    16: the bf16 eval step at bs128, whose stage-4 CoT layers run at 14x14
    and still launch the forward on k3, with no plain call."""
    from cotnet_tpu_torch.models import create_model
    from cotnet_tpu_torch.models.features import FeatureListNet
    from cotnet_tpu_torch.train.step import make_eval_step

    model = create_model("cotnet50", device="cuda", seed=0,
                         features_only=True, out_indices=(0, 1, 2, 3, 4))
    info = FeatureListNet(model).feature_info
    with torch.no_grad():
        feats = model(images_f32(4))
    chans = [f.shape[1] for f in feats]
    reductions = [IMAGE // f.shape[-1] for f in feats]
    if (chans, reductions) != (info.channels(), info.reduction()):
        raise AssertionError(f"features_only cotnet50: channels {chans}, "
                             f"reductions {reductions}; FeatureInfo "
                             f"{info.channels()} {info.reduction()}")
    del model, feats

    model = create_model("cotnet50", device="cuda", dtype=torch.bfloat16,
                         seed=0, output_stride=16)
    eval_step = make_eval_step(model)
    batch = make_batch()
    la.reset_counts()
    times = []
    for i in range(2 + timed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eval_step(batch)
        torch.cuda.synchronize()
        if i >= 2:
            times.append(time.perf_counter() - t0)
    snapshot = launch_snapshot(la)
    routes = {}
    for (kernel, key), count in snapshot["by_key"].items():
        _, affine, xs, ws, dil, pad = key
        meta = dict(device="meta", dtype=torch.bfloat16)
        routes[(kernel, xs)] = la.kernel_route(
            "fwd", torch.empty(xs, **meta), torch.empty(ws, **meta),
            kernel_size=(3, 3), dilation=dil, padding=pad)
    if (snapshot["plain"] or {k for k, _ in routes} != {"fwd_affine"}
            or set(routes.values()) != {"k3"}
            or (("fwd_affine", (BATCH, 512, 14, 14)) not in routes)):
        raise AssertionError(f"output_stride=16 eval: routes {routes}, "
                             f"{snapshot['plain']} plain calls")
    median = statistics.median(times)
    log(f"features_only cotnet50 at {IMAGE}: channels {chans}, reductions "
        f"{reductions}, as FeatureInfo; bf16 eval cotnet50 output_stride=16 "
        f"bs{BATCH}: {BATCH / median:.1f} img/s ({median * 1e3:.1f} ms a "
        f"step), {la.LAUNCHES // (2 + timed)} affine forward launches a "
        f"step, all on k3, stage 4 at 14x14, 0 plain calls")
    del model, eval_step
    torch.cuda.empty_cache()


def family_phase(la, paths: PathCounts):
    """Phase 13: the comparison families (f32 checks, bf16 main paths of
    san19 and lrnet50, the eval steps of the other three), ``remat``, and
    the feature and dilation smoke."""
    t_phase = time.perf_counter()
    for name in (*UNFOLDED_MODELS, *FAMILY_EVAL_MODELS):
        family_f32_checks(la, name)
    for name in UNFOLDED_MODELS:
        run_main_path(la, paths, name, "eval", timed=4)
        run_main_path(la, paths, name, "train", timed=3)
    for name, size in FAMILY_EVAL_MODELS.items():
        family_eval_without_op(la, name, size)
    remat_card(la, paths)
    feature_and_dilation_smoke(la)
    log(f"families phase: {time.perf_counter() - t_phase:.1f} s")


# ---- phase 14: the transformer core ----------------------------------------

def no_op(la, what: str):
    """Raise if the op launched or a plain version ran since the counts
    were last reset."""
    snapshot = launch_snapshot(la)
    if snapshot["by_key"] or snapshot["plain"]:
        raise AssertionError(f"{what} reached the op: {snapshot}")


def transformer_f32_check(name: str, size: int = IMAGE, n: int = 4):
    """f32 logits of ``name`` at bs ``n`` (seeded weights, BN statistics
    calibrated on the images) on the card against the port on the CPU,
    TF32 off, at 1e-3 of the largest logit."""
    from cotnet_tpu_torch.models import create_model

    from cotnet_tpu_torch.nn import BatchNorm2d

    cpu = create_model(name, device="cpu", seed=0)
    gen = torch.Generator().manual_seed(9)
    x = torch.randn(n, 3, size, size, generator=gen) \
        * torch.linspace(0.5, 2.0, n)[:, None, None, None]
    if any(isinstance(m, BatchNorm2d) for m in cpu.modules()):
        calibrate_bn(cpu, x, seed=1)
    card = create_model(name, device="cuda", seed=0)
    card.load_state_dict(cpu.state_dict())
    with torch.no_grad(), tf32_off():
        ref = cpu(x)
        got = card(x.cuda()).cpu()
    del cpu, card
    scale = float(ref.abs().max())
    err = float((got - ref).abs().max())
    if not (torch.isfinite(got).all() and got.shape == (n, 1000)
            and err <= 1e-3 * scale):
        raise AssertionError(f"{name} f32 logits {tuple(got.shape)}, card "
                             f"against CPU: max|err| {err}, max|logit| "
                             f"{scale}")
    return err / scale


def transformer_path(la, name: str, kind: str, size: int, n: int,
                     timed: int = 4):
    """One bf16 main path of the transformer core: the eval step, or the
    train step under ``TRANSFORMER_RECIPES[name]``; 2 warm-up and
    ``timed`` timed steps, images/s, peak memory and one profiled step; no
    launch of the op and no plain call."""
    from cotnet_tpu_torch.models import create_model
    from cotnet_tpu_torch.train.step import make_eval_step

    training = kind == "train"
    recipe = TRANSFORMER_RECIPES.get(name)
    batch = make_batch(n, size)
    torch.cuda.reset_peak_memory_stats()
    extra = dict(img_size=size) if "vit" in name else {}
    model = create_model(name, device="cuda", dtype=torch.bfloat16, seed=0,
                         **extra, **(recipe["model"] if training else {}))
    if training:
        step, state = recipe_train_step(model, recipe, n)
        gen = torch.Generator(device="cuda").manual_seed(6)
        images = {"image": batch["image"], "label": batch["label"]}

        def run():
            return step(state, images, gen)[1]
    else:
        eval_step = make_eval_step(model)

        def run():
            return eval_step(batch)

    la.reset_counts()
    times, outs = [], []
    for i in range(2 + timed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(run())
        torch.cuda.synchronize()
        if i >= 2:
            times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    no_op(la, f"{name} {kind}")
    if training:
        values = [float(m[key]) for m in outs for key in ("loss", "grad_norm")]
        if not (all(v == v and abs(v) < float("inf") for v in values)
                and state.step == 2 + timed):
            raise AssertionError(f"{name} train: step {state.step}, losses "
                                 f"and grad norms {values}")
        result = f"loss {values[0]:.4f} -> {values[-2]:.4f}"
    else:
        top1, top5, valid = (float(outs[-1][key]) for key in
                             ("top1_count", "top5_count", "n"))
        if not 0 <= top1 <= top5 <= valid == n - 8:
            raise AssertionError(f"{name} eval: {top1} {top5} {valid}")
        result = f"top1 {top1:.0f} top5 {top5:.0f} of {valid:.0f}"
    median = statistics.median(times)
    label = f"bf16 {name} {kind} {size}x{size} bs{n}"
    log(f"{label}: {n / median:.1f} img/s (median of {timed} steps, "
        f"{median * 1e3:.2f} ms a step) on {nvidia_smi()}; {result}; peak "
        f"memory {peak / 2 ** 30:.2f} GiB; no launch of the op, 0 plain "
        f"calls")
    profile_step(run, f"{label} step", top=6)
    del model, run, outs
    torch.cuda.empty_cache()


def embed_gn_gradient_card(la):
    """The fused embed op's plain version differentiated on the card
    (``impl="torch"``, f32, TF32 off) against the same on the CPU, all six
    gradients within 1e-5 of each one's largest, at cotnet50's 14x14
    stage-3 geometry at N = 2 (C 256, Cp 128, K 3); ``impl="auto"`` at
    that K*K, one the kernels are compiled for, refuses a gradient."""
    gen = torch.Generator().manual_seed(12)
    n, c, cp, hw, k = 2, 256, 128, 14, 3
    f = k * k * c // 8
    base = [torch.randn(n, c, hw, hw, generator=gen),
            torch.randn(n, cp, hw, hw, generator=gen).clamp_min(0),
            0.1 * torch.randn(f, cp, generator=gen),
            0.1 * torch.randn(f, generator=gen),
            1 + 0.2 * torch.randn(f, generator=gen),
            0.2 * torch.randn(f, generator=gen)]
    r = torch.randn(n, c, hw, hw, generator=gen)
    grads = {}
    with tf32_off():
        for device in ("cpu", "cuda"):
            leaves = [t.to(device, copy=True).requires_grad_()
                      for t in base]
            out = la.local_aggregate_embed_gn(*leaves, kernel_size=k,
                                              impl="torch")
            (out * r.to(device)).sum().backward()
            grads[device] = [t.grad.cpu() for t in leaves]
    worst = max(float((g - ref).abs().max() / ref.abs().max())
                for g, ref in zip(grads["cuda"], grads["cpu"]))
    if not worst <= 1e-5:
        raise AssertionError(f"embed op plain gradient, card against CPU: "
                             f"{worst} of the largest")
    leaves = [t.cuda().requires_grad_() for t in base]
    try:
        la.local_aggregate_embed_gn(*leaves, kernel_size=k)
    except NotImplementedError as err:
        refusal = str(err)
    else:
        raise AssertionError("impl='auto' at a compiled K*K gave a gradient")
    log(f"embed op, impl='torch' on the card: all six f32 gradients within "
        f"{worst:.3g} of the CPU's largest (limit 1e-5); impl='auto' at "
        f"K=3 with a gradient raises: {refusal[:60]}...")


def transformer_phase(la):
    """Phase 14: the f32 checks of the six models, vit_tiny's five steps,
    the five bf16 main paths, and the embed op's gradient."""
    from cotnet_tpu_torch.models import create_model

    t_phase = time.perf_counter()
    la.reset_counts()
    errs = {name: transformer_f32_check(name)
            for name in TRANSFORMER_F32_MODELS}
    no_op(la, "the f32 checks")
    log("transformer core f32 bs4 224x224, logits on the card against the "
        "CPU, max|err| / max|logit| (limit 1e-3): "
        + ", ".join(f"{name} {e:.3g}" for name, e in errs.items()))
    model = create_model("vit_tiny_patch16_224", device="cuda", seed=0)
    with tf32_off():
        loss_falls(la, model, images_f32(16))
    del model
    no_op(la, "vit_tiny's f32 steps")
    for name, kind, size, n in TRANSFORMER_PATHS:
        transformer_path(la, name, kind, size, n)
    embed_gn_gradient_card(la)
    log(f"transformer core phase: {time.perf_counter() - t_phase:.1f} s")


# ---- phase 15: the ViT-built transformers ----------------------------------

def vit_zoo_phase(la):
    """Phase 15: the f32 checks of the six models, xcit_nano_12_p16's five
    steps and the seven bf16 main paths."""
    zoo_phase(la, "ViT-built transformers", VIT_ZOO_F32,
              VIT_ZOO_STEPS_MODEL, VIT_ZOO_PATHS)


# ---- phase 16: the last ViT-built transformers -----------------------------

def vit_tail_phase(la):
    """Phase 16: the f32 checks of the six models, levit_128s's five steps
    and the eight bf16 main paths."""
    zoo_phase(la, "last ViT-built transformers", VIT_TAIL_F32,
              VIT_TAIL_STEPS_MODEL, VIT_TAIL_PATHS)


# ---- phase 17: the EfficientNet superfamily ---------------------------------

def effnet_phase(la):
    """Phase 17: the f32 checks of the six models, efficientnet_cc_b0_4e's
    five steps and the six bf16 main paths."""
    zoo_phase(la, "EfficientNet superfamily", EFFNET_F32,
              EFFNET_STEPS_MODEL, EFFNET_PATHS)


# ---- phase 18: the CNN tail ---------------------------------------------------

def psconv_masks_zero(model):
    """Every PSConv's masked dense weights exactly zero (PS-ResNet's
    mask, whose gradient is zero too)."""
    from cotnet_tpu_torch.models.psresnet import MaskedConv2d

    convs = [m for m in model.modules() if isinstance(m, MaskedConv2d)]
    nonzero = sum(int(m.weight[(m.mask == 0).expand_as(m.weight)]
                      .count_nonzero()) for m in convs)
    if not convs or nonzero:
        raise AssertionError(f"PSConv masked weights: {nonzero} non-zero "
                             f"in {len(convs)} convs")
    log(f"{len(convs)} PSConv masked weights still exactly zero after the "
        f"f32 steps")


def cnn_tail_phase(la):
    """Phase 18: the f32 checks of the ten models, psresnet50's five steps
    and its masked weights, and the eleven bf16 main paths."""
    zoo_phase(la, "CNN tail", CNN_TAIL_F32, CNN_TAIL_STEPS_MODEL,
              CNN_TAIL_PATHS, after_steps=psconv_masks_zero)


def zoo_phase(la, label: str, f32_models, steps_model: str, paths,
              after_steps=None):
    """A phase of models without the op: each of ``f32_models`` (model,
    image size, batch) in f32 on the card against the CPU, five f32 steps
    of ``steps_model`` (then ``after_steps(model)``), then the bf16 main
    ``paths``; no launch of the op and no plain call.  Logs the phase's
    seconds."""
    from cotnet_tpu_torch.models import create_model

    t_phase = time.perf_counter()
    la.reset_counts()
    errs = {name: transformer_f32_check(name, size, n)
            for name, size, n in f32_models}
    no_op(la, "the f32 checks")
    log(f"{label} f32, logits on the card against the CPU, max|err| / "
        "max|logit| (limit 1e-3): "
        + ", ".join(f"{name} ({size}, bs{n}) {errs[name]:.3g}"
                    for name, size, n in f32_models))
    model = create_model(steps_model, device="cuda", seed=0)
    with tf32_off():
        loss_falls(la, model, images_f32(16))
    if after_steps is not None:
        after_steps(model)
    del model
    no_op(la, f"{steps_model}'s f32 steps")
    for name, kind, size, n in paths:
        transformer_path(la, name, kind, size, n)
    log(f"{label} phase: {time.perf_counter() - t_phase:.1f} s")


def local_aggregate_wt_path(la, paths: PathCounts):
    """Phase 19's op entry point: one autograd call of
    ``local_aggregate_wt`` (the weight ``[Cw, K*K, Ho, Wo, N]``) at each of
    cotnet50's four geometries in bf16 at bs128, recorded as the path
    "local_aggregate_wt": one forward, one dx and one dw launch each on
    ``k3`` (the kernel phase checks the route), no plain call.  Then the
    same inputs through ``local_aggregate`` on the permuted weight, which
    must give the same bits in the output, dx and dw (the kernels see the
    same contiguous tensors), and one f32 call at 14x14 C=256 against the
    plain version at 1e-5 of the largest."""
    gen = torch.Generator(device="cuda").manual_seed(11)

    def inputs(c, hw, dtype):
        return tuple(torch.randn(*shape, generator=gen, device="cuda").to(
            dtype) for shape in ((BATCH, c, hw, hw),
                                 (c // 8, 9, hw, hw, BATCH),
                                 (BATCH, c, hw, hw)))

    def run(x, wt, dy, impl=None):
        xg, wg = x.clone().requires_grad_(), wt.clone().requires_grad_()
        if impl is None:
            y = la.local_aggregate_wt(xg, wg)
        else:
            y = la.local_aggregate(
                xg, wg.permute(4, 0, 1, 2, 3).unsqueeze(1), impl=impl)
        y.backward(dy)
        return y.detach(), xg.grad, wg.grad

    cases = [inputs(c, hw, torch.bfloat16)
             for c, hw, _ in COTNET50_GEOMETRIES]
    la.reset_counts()
    outs = [run(*case) for case in cases]
    torch.cuda.synchronize()
    snapshot = paths.record(la, "local_aggregate_wt", 1)
    kernels = sorted(kernel for kernel, _ in snapshot["by_key"])
    shapes = {key[2] for _, key in snapshot["by_key"]}
    if (kernels != sorted(("fwd", "dx", "dw") * len(cases))
            or set(snapshot["by_key"].values()) != {1}
            or len(shapes) != len(cases) or snapshot["plain"]):
        raise AssertionError(f"local_aggregate_wt: launches {snapshot}")
    for (c, hw, _), case, got in zip(COTNET50_GEOMETRIES, cases, outs):
        ref = run(*case, impl="auto")
        for what, a, b in zip(("output", "dx", "dw"), got, ref):
            if not torch.equal(a, b):
                raise AssertionError(
                    f"local_aggregate_wt at {c}/{hw}: its {what} differs "
                    f"from local_aggregate's on the permuted weight by "
                    f"{float((a.float() - b.float()).abs().max())}")
    del cases, outs
    f32 = inputs(256, 14, torch.float32)
    got, ref = (run(*f32, impl=impl) for impl in (None, "torch"))
    errs = [float((g - r).abs().max() / r.abs().max())
            for g, r in zip(got, ref)]
    if not max(errs) <= 1e-5:
        raise AssertionError(f"local_aggregate_wt f32 against the plain "
                             f"version: max|err| / max|ref| {errs}")
    log(f"local_aggregate_wt bf16 bs{BATCH} at cotnet50's four geometries: "
        f"one fwd, dx and dw launch each, 0 plain calls; output, dx and dw "
        f"the same bits as local_aggregate on the permuted weight; f32 at "
        f"14x14 C=256 against the plain version: max|err| / max|ref| "
        f"output {errs[0]:.3g}, dx {errs[1]:.3g}, dw {errs[2]:.3g} (limit "
        f"1e-5)")


def dense_key_convs(model):
    """Swap each CoT layer's key conv ``key_embed.0`` for a
    ``DenseGroupedConv`` with the same weights, in place: the net the JAX
    package builds under ``COTNET_DENSE_GROUPED``."""
    from cotnet_tpu_torch.models.cotnet import CotLayer
    from cotnet_tpu_torch.nn import DenseGroupedConv

    for layer in list(model.modules()):
        if isinstance(layer, CotLayer):
            conv = layer.key_embed[0]
            dense = DenseGroupedConv(
                conv.weight.shape[1] * conv.groups, conv.weight.shape[0],
                conv.kernel_size, conv.stride, conv.padding, conv.dilation,
                conv.groups, conv.bias is not None, conv.dtype)
            dense.load_state_dict(conv.state_dict())
            layer.key_embed[0] = dense.to(conv.weight.device)
    return model


def key_conv_times() -> dict:
    """Device ms of cotnet50's 16 key convs (3x3, 4 groups) in bf16 at
    bs128, the grouped ``Conv2d`` against ``DenseGroupedConv`` on the same
    weights, each geometry timed alone (``device_ms``) and summed over its
    blocks: the forward under no_grad (eval) and the forward with its
    backward to the input and the weight (train).  Keyed (form, mode)."""
    from cotnet_tpu_torch.nn import Conv2d, DenseGroupedConv

    gen = torch.Generator(device="cuda").manual_seed(23)
    totals = {(form, mode): 0.0 for form in ("grouped", "dense")
              for mode in ("eval", "train")}
    parts = []
    for c, hw, blocks in COTNET50_GEOMETRIES:
        x, dy = (torch.randn(BATCH, c, hw, hw, device="cuda", generator=gen)
                 .to(torch.bfloat16) for _ in range(2))
        grouped = Conv2d(c, c, 3, 1, 1, groups=4, dtype=torch.bfloat16).cuda()
        dense = DenseGroupedConv(c, c, 3, 1, 1, groups=4,
                                 dtype=torch.bfloat16).cuda()
        dense.load_state_dict(grouped.state_dict())
        xg = x.clone().requires_grad_()
        times = []
        for form, conv in (("grouped", grouped), ("dense", dense)):
            def fwd():
                with torch.no_grad():
                    conv(x)

            def train():
                torch.autograd.grad(conv(xg), (xg, conv.weight), dy)

            for mode, fn in (("eval", fwd), ("train", train)):
                ms = device_ms(fn)
                totals[form, mode] += blocks * ms
                times.append(ms)
        parts.append(f"{hw}x{hw} C={c} x{blocks}: eval {times[0]:.4f} / "
                     f"{times[2]:.4f}, train {times[1]:.4f} / {times[3]:.4f}")
    log(f"cotnet50's 16 key convs bf16 bs{BATCH} (3x3, 4 groups), device ms "
        f"grouped / dense: eval {totals['grouped', 'eval']:.4f} / "
        f"{totals['dense', 'eval']:.4f}, train (forward, dx, dw) "
        f"{totals['grouped', 'train']:.4f} / {totals['dense', 'train']:.4f} "
        f"a step on {nvidia_smi()}; per conv " + "; ".join(parts))
    return totals


def dense_grouped_phase(la, paths: PathCounts, state, main_train: dict):
    """Phase 19's cotnet50 with its key convs as ``DenseGroupedConv``
    (dense convs with block-diagonal kernels, ``dense_key_convs``).  f32
    at bs16, TF32 off, on phase 2's calibrated state: logits against the
    grouped net within 1e-3 of the largest, 16 forward launches and no
    plain call a forward; one loss and backward through the kernels (16
    forward, dx and dw launches, no plain call, each backward launch
    against the plain backward) against the grouped net's, held to 3x that
    net's own noise (``gradient_parity``).  Then its bf16 train step under
    the recipe and its eval step at 224 bs128, beside phases 2 and 3's
    grouped images/s of this call, after the key convs' own device times
    (``key_conv_times``)."""
    from cotnet_tpu_torch.models import create_model

    x = images_f32()
    on, off = (create_model("cotnet50", device="cuda") for _ in range(2))
    for model in (on, off):
        model.load_state_dict(state)
    dense_key_convs(on)
    with tf32_off(), torch.no_grad():
        la.reset_counts()
        got = on(x)
        torch.cuda.synchronize()
        counts = (la.LAUNCHES, la.PLAIN_CALLS)
        ref = off(x)
    diff, scale = float((got - ref).abs().max()), float(ref.abs().max())
    if not (counts == (16, 0) and torch.isfinite(got).all()
            and got.shape == (16, 1000) and diff <= 1e-3 * scale):
        raise AssertionError(f"cotnet50 dense key convs f32 logits: "
                             f"(launches, plain) {counts}, max|diff| {diff} "
                             f"against the grouped net, max|logit| {scale}")
    log(f"cotnet50 dense key convs f32 bs{x.shape[0]}: logits against the "
        f"grouped net on the same state max|diff| {diff:.3g} of max|logit| "
        f"{scale:.3g} (limit 1e-3); {counts[0]} launches, {counts[1]} plain "
        f"calls a forward")
    gradient_parity(la, on, off, x,
                    plain_counts=(16, {"dx": 16, "dw": 16}, 0, 0),
                    what="dense key convs against the grouped net")
    del on, off
    torch.cuda.empty_cache()
    key_conv_times()
    train = run_main_path(la, paths, "cotnet50", "train", timed=6,
                          dense_keys=True)
    evl = run_main_path(la, paths, "cotnet50", "eval", timed=8,
                        dense_keys=True)
    log(f"cotnet50 dense key convs bf16 {IMAGE}x{IMAGE} bs{BATCH}: train "
        f"{train:.1f} img/s (grouped, phase 3: "
        f"{main_train['img_s']:.1f}), eval {evl:.1f} img/s (phase 2: "
        f"{main_train['eval_img_s']:.1f}) on {nvidia_smi()}; a record: the "
        f"dense key convs do 4x the grouped convs' products")


class _Apply(torch.nn.Module):
    """A function of the layer tail as a module: ``fn(x)``, or ``fn(child,
    x)`` with its child (test_time_pool's classifier)."""

    def __init__(self, fn, child=None):
        super().__init__()
        self.fn, self.child = fn, child

    def forward(self, x):
        return self.fn(x) if self.child is None else self.fn(self.child, x)


def layer_tail_pieces() -> list:
    """(name, build(dtype), f32 tolerance of the largest, modes) of phase
    19: each piece of the pools, ``nn/extra.py``'s layer tail and
    ``DenseGroupedConv``; a norm with statistics in eval and in training."""
    from cotnet_tpu_torch import nn as pnn

    c = LAYER_TAIL_SHAPE[1]
    conv, el = LAYER_TAIL_CONV_RTOL, LAYER_TAIL_RTOL
    both = ("eval", "train")
    return [
        ("avg_pool2d_same 3x3 s2",
         lambda dt: _Apply(lambda x: pnn.avg_pool2d_same(x, 3, 2)), el,
         ("eval",)),
        ("median_pool2d 3x3 pad 1",
         lambda dt: _Apply(lambda x: pnn.median_pool2d(x, 3, 1, 1)), el,
         ("eval",)),
        ("median_pool2d 2x2 s2 (even)",
         lambda dt: _Apply(lambda x: pnn.median_pool2d(x, 2, 2, 0)), el,
         ("eval",)),
        ("Shiftlution 3x3", lambda dt: pnn.Shiftlution(c), el, ("eval",)),
        ("TBConv 3x3, 4 blocks",
         lambda dt: pnn.TBConv(c, c, 3, blocks=4, dtype=dt), conv,
         ("eval",)),
        ("Kerv2d, learnable balance",
         lambda dt: pnn.Kerv2d(c, c, learnable_kernel=True, dtype=dt), conv,
         ("eval",)),
        ("space_to_depth 4",
         lambda dt: _Apply(lambda x: pnn.space_to_depth(x, 4)), el,
         ("eval",)),
        ("EvoNorm2dB0", lambda dt: pnn.EvoNorm2dB0(c), el, both),
        ("EvoNorm2dS0, 32 groups", lambda dt: pnn.EvoNorm2dS0(c), el,
         ("eval",)),
        ("instance_std", lambda dt: _Apply(pnn.instance_std), el, ("eval",)),
        ("group_std, 32 groups", lambda dt: _Apply(pnn.group_std), el,
         ("eval",)),
        ("SplitBatchNorm, 2 splits",
         lambda dt: pnn.SplitBatchNorm(c, dtype=dt), el, both),
        (f"test_time_pool, 1x1 to {LAYER_TAIL_CLASSES}",
         lambda dt: _Apply(lambda head, x: pnn.test_time_pool(head, x, 224),
                           pnn.Conv2d(c, LAYER_TAIL_CLASSES, 1, bias=True,
                                      dtype=dt)), conv, ("eval",)),
        ("DenseGroupedConv 3x3, 4 groups",
         lambda dt: pnn.DenseGroupedConv(c, c, 3, 1, 1, groups=4, dtype=dt),
         conv, ("eval",)),
    ]


def seed_tail_state(module, gen):
    """Seeded weights for a piece: each module's own initialization from
    ``gen``, then the norms' scales, ``v``, balances and running variances
    in [0.5, 1.5] and the biases and running means near 0, so that no
    factor is the identity."""
    from cotnet_tpu_torch.nn import Conv2d

    for m in module.modules():
        if hasattr(m, "reset_parameters"):
            m.reset_parameters(gen)
    with torch.no_grad():
        for m in module.modules():
            tensors = [*m.named_parameters(recurse=False),
                       *m.named_buffers(recurse=False)]
            for leaf, t in tensors:
                if not t.is_floating_point():
                    continue
                if leaf in ("bias", "running_mean"):
                    t.copy_(0.1 * torch.randn(t.shape, generator=gen))
                elif leaf in ("v", "balance", "running_var") or (
                        leaf == "weight" and not isinstance(m, Conv2d)):
                    t.copy_(0.5 + torch.rand(t.shape, generator=gen))


def layer_tail_card():
    """Phase 19's layer tail at ``LAYER_TAIL_SHAPE``: each piece on the card
    in f32 with TF32 off against the same module on the CPU with the same
    weights (``LAYER_TAIL_RTOL`` of the largest for the elementwise pieces,
    ``LAYER_TAIL_CONV_RTOL`` for the convs), in eval and, for EvoNorm B0 and
    SplitBatchNorm, in training, where the running statistics are compared
    too; then in bf16 (the compute dtype of the pieces that take one),
    whose results must be finite.  Returns the worst f32 ratio by piece."""
    gen = torch.Generator().manual_seed(12)
    n, c, h, w = LAYER_TAIL_SHAPE
    x = torch.randn(LAYER_TAIL_SHAPE, generator=gen) \
        * torch.linspace(0.5, 2.0, n)[:, None, None, None]
    xc = x.cuda()
    worst = {}
    for name, build, rtol, modes in layer_tail_pieces():
        cpu = build(torch.float32)
        seed_tail_state(cpu, gen)
        card = build(torch.float32).cuda()
        card.load_state_dict(cpu.state_dict())
        card16 = build(torch.bfloat16).cuda()
        card16.load_state_dict(cpu.state_dict())
        ratios = []
        for mode in modes:
            training = mode == "train"
            with torch.no_grad(), tf32_off():
                ref = cpu.train(training)(x)
                got = card.train(training)(xc).cpu()
                got16 = card16.train(training)(xc.to(torch.bfloat16))
                torch.cuda.synchronize()
            pairs = [("out", got, ref)]
            if training:
                pairs += [(k, v.cpu(), cpu.state_dict()[k])
                          for k, v in card.state_dict().items()
                          if k.endswith(("running_mean", "running_var"))]
            for what, g, r in pairs:
                scale = float(r.abs().max())
                ratio = float((g - r).abs().max()) / scale
                if not (g.shape == r.shape and ratio <= rtol):
                    raise AssertionError(
                        f"{name} {mode} f32 {what}, card against CPU: "
                        f"shape {tuple(g.shape)} / {tuple(r.shape)}, max|err| "
                        f"/ max|ref| {ratio} (limit {rtol})")
                ratios.append(ratio)
            if not (got16.shape == ref.shape
                    and bool(torch.isfinite(got16).all())):
                raise AssertionError(f"{name} {mode} bf16: not finite or "
                                     f"shape {tuple(got16.shape)}")
            del ref, got, got16
        worst[name] = max(ratios)
        del cpu, card, card16
        torch.cuda.empty_cache()
    return worst


def api_tail_phase(la, paths: PathCounts, state, main_train: dict):
    """Phase 19: ``local_aggregate_wt``, cotnet50 with dense key convs
    and the layer tail at a real size; logs the phase's seconds."""
    t_phase = time.perf_counter()
    local_aggregate_wt_path(la, paths)
    dense_grouped_phase(la, paths, state, main_train)
    t_tail = time.perf_counter()
    worst = layer_tail_card()
    log(f"layer tail {'x'.join(map(str, LAYER_TAIL_SHAPE))} on the card "
        f"against the CPU, f32 max|err| / max|ref| (limit "
        f"{LAYER_TAIL_RTOL:g}, convs {LAYER_TAIL_CONV_RTOL:g}; EvoNorm B0 "
        f"and SplitBatchNorm in eval and training, with their running "
        f"statistics); bf16 finite: "
        + ", ".join(f"{name} {ratio:.3g}" for name, ratio in worst.items())
        + f"; {time.perf_counter() - t_tail:.1f} s")
    log(f"API tail phase: {time.perf_counter() - t_phase:.1f} s")


def expected_route(e) -> str:
    """The route a main-path launch of entry ``e`` must take."""
    return e.get("main_route", MAIN_ROUTE.get(e["name"], "k3"))


def profile_step(fn, label: str, top: int = 12):
    """One step under torch.profiler: the device time by kernel name and the
    device's busy share of the step's wall time (the profiler's own cost is
    in that wall time).  Returns (busy ms, wall ms), None where the profiler
    recorded no device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only: the operators' own rows repeat their kernels
    rows = [(e.self_device_time_total / 1e3, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    if not rows:
        log(f"profile of one {label}: the profiler recorded no device time "
            "(not measured)")
        return None
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    # a template's name ends at its "<", any other at its "("
    agg = {name: sum(r[0] for r in rows
                     if f"{name}<" in r[2] or f"{name}(" in r[2])
           for name in ("local_agg_fwd", "local_agg_bwd_dx",
                        *K7_FUNCTIONS,
                        "local_agg_bwd_dw", "local_agg_bwd_dw_affine",
                        "local_agg_bwd_dw_affine_sums",
                        *EMBED_GN_STATS, *EMBED_GN_AGG)}
    log(f"profile of one {label}: {sum(r[1] for r in rows)} device kernels "
        f"busy {busy_ms:.3f} ms of {wall_ms:.3f} ms wall "
        f"({100 * busy_ms / wall_ms:.1f}%); "
        + ", ".join(f"{name} {ms:.3f} ms ({100 * ms / busy_ms:.1f}%)"
                    for name, ms in agg.items() if ms)
        + f"; the aggregation kernels {100 * sum(agg.values()) / busy_ms:.1f}% "
        "of device time")
    for ms, count, name in rows[:top]:
        log(f"  {ms:9.3f} ms {100 * ms / busy_ms:5.1f}% x{count:<4d} "
            f"{name[:100]}")
    return busy_ms, wall_ms


def device_kernels(fn) -> tuple:
    """(device kernels, their busy ms) of one call of ``fn`` under
    torch.profiler, counted from its raw device events: the same kernels
    ``profile_step`` counts, without building its per-name table, which
    takes seconds for a train step."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == torch.autograd.DeviceType.CUDA]
    if not events:
        raise AssertionError("the profiler recorded no device event")
    return len(events), sum(e.duration_ns() for e in events) / 1e6


def per_step_summary(entries, path: str):
    """Each case a main path launched, at its launches per step there; and
    by kernel, the ms a step it loses to its bound, launches x (ms - bound),
    which ranks the kernels for speed work."""
    per_step = [(e, by["launches"] / by["steps"]) for e in entries
                for label, by in e["launches_by_path"].items()
                if label == path]
    lost = {}
    for e, n in per_step:
        lost[e["name"]] = lost.get(e["name"], 0.0) + n * (
            e["ms"] - e["bound_ms"])
    log(f"aggregation kernels per step of {path} "
        f"({sum(n for _, n in per_step):.0f} launches): " + ", ".join(
            f"{key} {sum(e[key] * n for e, n in per_step):.4f} ms"
            for key in ("ms", "plain_ms", "bound_ms",
                        "bound_ms_at_copy_rate"))
        + "; lost to the bound: " + ", ".join(
            f"{name} {ms:.4f} ms" for name, ms in lost.items()))


def build_report(build):
    """Build every kernel source (``build`` is the port's ``ops._build``)
    and log, per kernel function, what ``nvcc -Xptxas=-v`` reported for it
    (registers, shared memory, spills; nothing for a library that was built
    already) and the number of SASS instructions in the built library
    (``cuobjdump -sass``)."""
    import re
    import shutil

    outputs = build.build_all()
    cuobjdump = (shutil.which("cuobjdump")
                 or "/usr/local/cuda/bin/cuobjdump")
    for source in build.sources():
        ptxas, fn = {}, None
        for line in outputs[source].splitlines():
            m = re.search(r"(?:entry function|properties for) '?(\w+)", line)
            if m:
                fn = m.group(1)
            elif fn and ("spill" in line or "Used" in line):
                ptxas.setdefault(fn, []).append(
                    line.replace("ptxas info    :", "").strip())
        sass = {}
        try:
            dump = subprocess.run(
                [cuobjdump, "-sass", str(build.library_path(source))],
                check=True, capture_output=True, text=True,
                timeout=120).stdout
        except (OSError, subprocess.CalledProcessError) as err:
            log(f"build {source}: SASS not measured ({err})")
            dump = ""
        for line in dump.splitlines():
            m = re.match(r"\s*Function : (\w+)", line)
            if m:
                fn = m.group(1)
                sass[fn] = 0
            elif fn in sass and re.match(r"\s*/\*[0-9a-f]{4,}\*/", line):
                sass[fn] += 1
        names = sorted(set(ptxas) | set(sass))
        demangled = dict(zip(names, subprocess.run(
            ["c++filt"], input="\n".join(names), capture_output=True,
            text=True).stdout.splitlines())) if shutil.which("c++filt") \
            else {}
        for fn in names:
            short = demangled.get(fn, fn).replace(
                "(anonymous namespace)::", "").replace("void ", "").split(
                "(")[0]
            line = "; ".join(ptxas.get(fn, []))
            log(f"build {source}: {short}: {line}"
                f"; {sass.get(fn, 'not measured')} SASS instructions")
            if line:
                PTXAS[short] = line
    # the k7 instantiations keep every value in registers
    spills = {fn: line for fn, line in PTXAS.items()
              if fn.startswith(K7_FUNCTIONS)
              and not re.search(r"\b0 bytes spill stores, 0 bytes spill "
                                r"loads", line)}
    if spills:
        raise AssertionError(f"k7 kernels spill: {spills}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    from cotnet_tpu_torch.ops import _build, local_agg as la

    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    log(f"device: {name}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    log(smi)
    build_report(_build)
    torch.zeros(1, device="cuda")
    log(f"set-up (kernel build included): {time.perf_counter() - t0:.1f} s")

    paths = PathCounts()
    state, main_train = model_phase(la, paths)
    torch.cuda.empty_cache()
    train_stack_phase(la, paths)
    switches_phase(la, paths, state)
    torch.cuda.empty_cache()
    hybrid_phase(la, paths)
    torch.cuda.empty_cache()
    mix_path(la, paths)
    dilated_check(la)
    log(f"model and op phases done at {time.perf_counter() - t0:.1f} s")
    data_phase(la, paths, main_train)
    log(f"data phase done at {time.perf_counter() - t0:.1f} s")
    cli_phase(la, paths, main_train)
    log(f"CLI phase done at {time.perf_counter() - t0:.1f} s")
    dp_phase(la, paths)
    chassis_phase(la)
    log(f"data-parallel and chassis phases done at "
        f"{time.perf_counter() - t0:.1f} s")
    family_phase(la, paths)
    log(f"families phase done at {time.perf_counter() - t0:.1f} s")
    transformer_phase(la)
    log(f"transformer core phase done at {time.perf_counter() - t0:.1f} s")
    vit_zoo_phase(la)
    log(f"ViT-built transformers phase done at "
        f"{time.perf_counter() - t0:.1f} s")
    vit_tail_phase(la)
    log(f"last ViT-built transformers phase done at "
        f"{time.perf_counter() - t0:.1f} s")
    effnet_phase(la)
    log(f"EfficientNet superfamily phase done at "
        f"{time.perf_counter() - t0:.1f} s")
    cnn_tail_phase(la)
    log(f"CNN tail phase done at {time.perf_counter() - t0:.1f} s")
    api_tail_phase(la, paths, state, main_train)
    del state
    torch.cuda.empty_cache()
    log(f"API tail phase done at {time.perf_counter() - t0:.1f} s")

    hbm_rate = copy_rate()
    log(f"device copy rate: {hbm_rate / 1e12:.3f} TB/s (data sheet "
        f"{HBM_BYTES_PER_S / 1e12:.2f})")
    entries = (kernel_phase(la, hbm_rate, paths)
               + bwd_kernel_phase(la, hbm_rate, paths)
               + affine_bwd_kernel_phase(la, hbm_rate, paths)
               + embed_gn_kernel_phase(la, hbm_rate, paths)
               + mix_kernel_phase(la, hbm_rate, paths))
    # every shape a main path launched was held against its plain version
    launched = sum(c for by in paths.by_key.values() for c, _ in by.values())
    if sum(e["launches"] for e in entries) != launched:
        raise AssertionError(
            f"the main paths made {launched} launches, the kernel phase "
            f"accounts for {sum(e['launches'] for e in entries)}")
    # every main path runs the K = 3 route of the forward, dx and dw but at
    # the geometries GEOMETRY_ROUTE names (SAN19's K = 7: the forward, dx
    # and dw on k7), the mix path the tiles route of the mix's forward, dx
    # and dw
    off_route = sorted({f"{e['name']} ({e['variant']}, want "
                        f"{expected_route(e)}) {e['geometry']}"
                        for e in entries
                        if e["launches"] and e.get("variant", expected_route(
                            e)) != expected_route(e)})
    if off_route:
        raise AssertionError(f"main-path launches off their route: "
                             f"{off_route}")
    path_labels = []
    for by_path in paths.by_key.values():
        path_labels += [label for label in by_path
                        if label not in path_labels]
    for label in path_labels:
        per_step_summary(entries, label)
    log(f"total {time.perf_counter() - t0:.1f} s")
    log(smi)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
