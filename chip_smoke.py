#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``sinnerf_tpu_torch``) on the
visible cards (one is enough).

    python3 chip_smoke.py
    python3 chip_smoke.py --phases ddp   # the build and phase 23 alone

Phases, any failure exits non-zero without the final result line:
1. print the card (``nvidia-smi`` name and power limit) and build the CUDA
   kernels from ``sinnerf_tpu_torch/csrc`` (build seconds, and every
   kernel's ``-Xptxas -v`` registers, shared memory and spills printed);
   count the Hopper kernels' (K3, K1 and K4 in bf16, K1, K3 and K4 in f32)
   and K2's, and the kernel experiments' Hopper variants' (phases 12-13),
   HGMMA, bulk-copy (UBLKCP, UTMALDG; multicast ones), vector-reduction, FFMA,
   128-bit shared load and 128-bit global load and store instructions in
   ``cuobjdump -sass`` of their libraries, and fail without wgmma (bf16) or
   FFMA (f32), or without bulk copies, or (the f32 training kernels) without
   vector reductions in a backward or with a spill, or (K2) without 128-bit
   global loads and stores, or (X1's ``pe_ilp2_t2x``) without the multicast
   copy;
2. hold K1 (``fused_render_level``, the Hopper kernels) against its plain
   version, float32 and bfloat16, at 4096 rays x S = 64 and 192, at 1000
   rays x S = 12, and at every ragged shape of K1_RAGGED (1 to 5292 rays, S
   = 1 to 192), each with the white background on and off; at one ray the
   bfloat16 mean is held over K1_SINGLE_RAYS launches of one ray each;
3. hold K2 (``fused_sample_pdf_merge``, the many-lanes kernel) against its
   plain version, also on adversarial rows (z in equal pairs, so that fine
   depths tie with coarse ones; all-zero and one-hot weights; S = 3);
4. on a synthetic 504x378 LLFF scene with a reference-format ``.ckpt``,
   hold each kernel against its plain version on the inputs and at the
   shapes the eval path gives it (one val image in tiles of 131,072 rays:
   K1 at 131072 and 59440 rays x S = 64 and 192, K2 at 131072 and 59440
   rays x 64 -> 192), timing each launch and its plain version; at 131072
   rays x S = 64 and 192 the earlier K1 (``launch_render_block64``) held
   against the plain version too and timed beside the Hopper kernel in
   K1_ROUNDS rounds that alternate them; at each tile the first port of K2
   (``launch_sample_pdf_merge_earlier``) held against the plain version and
   timed beside the kernel on the path in K2_ROUNDS rounds; then hold the
   kernel render of the whole image against the plain render path and time
   it;
5. the eval main path: ``sinnerf_tpu_torch.eval`` on the val and test
   splits at 64 + 128 samples in bfloat16 and float32, with every launch
   count set to 0 just before and read just after; check PSNR and PNGs;
6. hold K3 (``fused_render_level_train``), forward and backward, against
   its plain versions, float32 and bfloat16, with and without noise, white
   background on and off, with nonzero cotangents on all three outputs, at
   small shapes (1000 x 12, 333 x 9, the 56x70 patch x 16, the 63x84 patch x 9); the
   backward's sums are order-dependent, so the spread of its gradient over
   two runs on the same inputs is printed; K1 and K3-fwd without noise must
   agree bit for bit in both dtypes (one kernel template each);
7. the same at the training path's own shapes and inputs: the 16,384 rays of
   a Step-1 batch x S = 64 and 192 as ``train_step`` chains them (K3-fwd,
   K2 with drawn ``u``, K3-fwd, then both backwards), timing each launch and
   its plain version, K2 also beside its first port in K2_ROUNDS rounds;
   then K3_ROUNDS rounds that alternate the Hopper
   kernels with the earlier ones on the same inputs: the forward with the
   earlier forward (``launch_train_fwd_block64``: wmma in bfloat16, FMA in
   float32; first held against the plain forward), the
   backward with its ablations (``launch_train_bwd_ablated``: bfloat16 flush
   and wgrad, float32 flush and scratch) and the earlier backward (bfloat16
   X2's ``base``, float32 ``launch_train_bwd_block64``);
8. the training main path: ``train_step`` (4 bundles of 4096 rays, 64 + 128
   samples, depth, photometric and smoothness losses, Adam at 2e-4) in
   bfloat16 and float32: a first step whose parameter gradients are held
   against a ``train_step`` on the plain path (``mlp_impl="xla"``) with the
   same draws, then 3 timed steps with every launch count set to 0 just
   before and read just after (per step K3-fwd 2, K3-bwd 2, K2 1); the loss
   must be finite and fall on the fixed batch;
9. hold K4 (``fused_nerf_mlp``), forward and backward, against its plain
   versions, float32 and bfloat16, with and without ``sigma_only``, at point
   counts that are no tile multiple (20,001, 70,001, and a short tail of 333
   over several draws), with nonzero cotangents on rgb and sigma: every
   dW/db leaf, dxyz and ddir; the spread of the backward over two runs is
   printed;
10. the deterministic training path (``perturb=0``, ``noise_std=0``): K4 at
   its shapes (1,048,576 and 3,145,728 points, the points of the 16,384 rays
   x 64 and x 192 samples) against its plain version and timed, and in
   K4_ROUNDS alternating rounds the Hopper kernels beside the earlier ones
   of ``fused_mlp.cu``, each held against the plain version first: float32
   K4-bwd (``launch_mlp_bwd_block64``) and K4-fwd (``launch_mlp_fwd_block64``)
   with the sigma-only K4-fwd, bfloat16 K4-bwd (``launch_mlp_bwd_wmma``)
   with itself without its dW flush (``launch_mlp_bwd_ablated``) and K4-fwd
   (``launch_mlp_fwd_wmma``) with the sigma-only K4-fwd; the first
   ``train_step``'s gradients against the plain path's; 3 timed steps with
   the counts set to 0 just before and read just after (per step K1 2, K2 1,
   K4-fwd 2, K4-bwd 2, K3 0), the loss finite and falling;
11. the train CLI, ``python -m sinnerf_tpu_torch.train``'s ``main``, on the
   504x378 LLFF scene at 64 + 128 samples for 2 epochs (5 steps each,
   validation over the 5 val images after each): bfloat16 with the default
   (stochastic) flags, bfloat16 and float32 with ``--perturb 0 --noise_std
   0``; per run the counts set to 0 just before and read just after, the
   time per step and the val PSNR of each epoch, whose best must clear a
   black render's by 1 dB; the top-2 and ``last`` checkpoints must exist.
   Then the float32 run resumed from its ``last.ckpt`` for a third epoch on
   the plain path and on the kernels, their val PSNRs held together; and
   the eval CLI renders one of the checkpoints;
12. X1, the forward-kernel variants of K4-fwd
   (``sinnerf_tpu_torch.scripts.exp_kernel_variants``) on the production
   Hopper body (``exp_kernel_variants_sm90.cu``; ``pe`` is production K4-fwd
   bf16, ``k4_fwd_sm90``, and must equal it bit for bit; phase 1 fails a
   variant without HGMMA or bulk copies, ``pe_ilp2_t2x`` without the
   multicast copy): every variant's kernel against its plain version and against
   ``pe`` at 4096 and 333 points; then the experiment's entry point
   (``main``) at 8,388,608 points with every count set to 0 just before and
   read just after (each variant launched, finite, within K4-fwd's limit of
   ``pe``, timed beside its earlier ``wmma`` port in alternating rounds, the
   depth merge equal to ``torch.sort``); on the inputs it ran on, each
   variant held against its plain version (timed there) and ``pe`` against
   production K4-fwd, bit for bit;
13. X2, the pipelining variants of K3-bwd
   (``sinnerf_tpu_torch.scripts.exp_bwd_pipeline``) on the production Hopper
   K3-bwd bf16 (``exp_bwd_pipeline_sm90.cu``; ``base`` is
   ``train_bwd_sm90<0>``; phase 1 fails a variant without HGMMA or bulk
   copies): at 128 rays x S = 8 (a partly open field) and 333 x 10 (an open one),
   production K3-fwd bf16, which gives the variants their residuals, and
   the earlier forward against their plain version, every variant's kernel
   against its plain version, the exact ones also against production K3-bwd
   bf16 within its run-to-run spread; then the entry point at 16,384 rays x
   192 samples over all eight variants (both two_stream tiles), each timed
   beside ``base`` and beside its earlier ``wmma`` port in alternating
   rounds, with the counts set to 0 just before and read just after; on the
   inputs it ran on, each variant held against its plain version (timed
   there);
14. ``torch.profiler`` over PROFILED_STEPS bfloat16 stochastic
   ``train_step``s: the device's busy and idle share and its time by kernel;
15. the Step-2 training path: ``train_step`` with the full ViT-S/16 loss
   and the PatchGAN (ndf 64, hinge; STEP2_FIELDS) on the same batch, bf16
   and f32: STEP2_STEPS steps on the kernels and on the plain path with the
   same render and Step-2 draws (from generators of their own): every step's
   losses, and the first step's NeRF and discriminator gradients, to
   STEP_GRAD_TOL; then STEP2_STEPS timed steps with the counts set to 0 just before and
   read just after (per step K3-fwd 2, K3-bwd 2, K2 1), and in STEP2_ROUNDS
   alternating rounds phase 8's step, the Step-1 recipe's (the ViT on, the
   GAN off) and the Step-2 step;
16. ``torch.profiler`` over PROFILED_STEPS bf16 Step-2 steps with the ViT's
   and the discriminator's work marked (``StepParts``): the device's busy
   and idle share, and its time in the K3 launches, K2, the ViT (forward and
   backward), the discriminator's calls and the rest;
17. SinNeRF's two-step recipe through the train CLI on the 504x378 scene
   (bf16, 2 epochs of 5 steps each): Step 1 with ``--vit_weight 10
   --allow_random_pretrained``, Step 2 with ``--dis_weight 0.01 --vit_weight
   0 --pt_model <step1>/last.ckpt --nerf_only``, then Step 2 resumed for a
   third epoch: launch counts, ms per step, val PSNR, what the checkpoints
   hold;
18. the Blender and DTU training sets: write the rich lego stand-in at
   400x400 (under ``lego``: ref 20 and the true mytest val slice) and the
   rich DTU scan4 at 640x512; build ``BlenderRot3D``, ``BlenderProj`` and
   ``DTUProj`` on the card with the recipes' flags, sample SLICE_ITEMS items
   of each from a generator of their own (schema, ranges, ms per item); the
   rot3d items again from the same seed on the card (equal) and on a scene
   built on the CPU (the same random rays and real patch: the card's reads
   in the fresh warp change no draw);
19. the slice's kernel shapes against the plain versions, bf16 and f32, with
   the white background: K3-fwd and K3-bwd at 16,384, 20,480 and 16,032
   rays x S = 64 and, after K2 (64 -> 128, drawn ``u``), S = 128; K1 and K2
   (deterministic) at the eval tiles of a 400x400 and a 640x512 image
   (131,072, 28,928 and 65,536 rays) x S = 64 and 128;
20. the train CLI on each training set, bf16, counted: lego Step 1 with the
   README's flags (``--patch_size 64 --sW 6 --sH 6 --N_importance 64
   --depth_weight 8 --proj_weight 1 --depth_smooth_weight 0.5 --dis_weight
   0 --vit_weight 10``, one epoch of 125 steps) and lego Step 2 from it
   (``--dis_weight 0.01 --pt_model <ck> --nerf_only``, one epoch), their
   best val PSNR above a black render's by EMPTY_MARGIN_DB;
   ``BlenderProj`` (2 epochs of 60 steps, without the random-weight ViT)
   and DTU scan4 (``--patch_size_x 56 --patch_size_y 70 --sW 8 --sH 8``, one
   epoch of 8 steps), their best val PSNR above an empty field's (the
   larger of a black and a white render's) by EMPTY_MARGIN_DB; ms per
   step, launches;
21. the eval CLI on each run's best checkpoint (bf16; Blender's own
   defaults otherwise: the mytest slice at ``--angle 64``), counted; the
   weights-only tool on lego Step 2's checkpoint, and the eval CLI on the
   stripped file: the same mean PSNR;
22. ``sinnerf_tpu_torch.scripts.demo_convergence`` at its defaults on the
   kernels in bf16, counted: val PSNR up by more than 3 dB and above an
   empty field's by EMPTY_MARGIN_DB (rot3d's on-card run that must learn),
   steps/s;
23. data parallelism (``parallel/ddp.py``) on the visible cards: min(4,
   cards) ranks over NCCL, or with one card two ranks sharing it over gloo
   (NCCL refuses two ranks on one device; it says which), in one launch of
   the ranks.  DDP_STEPS sharded bf16 ``train_step``s (a lego rot3d batch of
   one item per rank, the ViT and D random, hinge) against the same steps
   in one process on the global batch: each step's loss and the first
   step's NeRF and D gradients to STEP_GRAD_TOL, one hash of every rank's
   parameters, ``u`` and optimizer state; ms per step per rank and the
   all-reduce's ms (CUDA events).  The train CLI's ranks on lego Step 1
   (phase 20's flags at ``--num_gpus <world>``, one epoch of ceil(125 /
   world) steps; gate: a black render + EMPTY_MARGIN_DB), Step 2 from its
   checkpoint and Step 2 resumed for an epoch, counted per rank.  The eval
   CLI's ranks on Step 1's checkpoint against the eval CLI on one card:
   mean PSNR within DDP_EVAL_PSNR_TOL, every PNG within one level, ms per
   image.  With two cards or more, a K3 step on ``cuda:1`` from this
   process on ``cuda:0``.  ``--phases ddp`` runs phase 1 and this phase
   alone (on a lego stand-in of its own);
24. print one ``kernels`` JSON line (with the Step-2 phases' numbers under
   ``step2``, the slice's under ``slice``, the multi-GPU phase's under
   ``ddp``), then, last, ``{"ok": true, "device": {...}}``.

Errors of renders are max and mean absolute differences of rgb, weights and
depth (as a share of the far bound).  Errors of gradients are per parameter
leaf: the largest difference over the leaf's largest entry, and the relative
L2 difference; the worst leaf is held to the limit.  Kernel and plain version cast at the same points;
in bfloat16 an f32 sum taken in another order can round an activation to the
neighbouring bf16 value, which the max sees and the mean hardly does.  A
cast point missed shifts every point, which the mean sees (the planted
faults of ``tests/test_torch_kernels_plain.py`` show it).

The script imports nothing of JAX.  It exits non-zero without a card, and in
a directory that does not hold the port.
"""

from __future__ import annotations

import glob
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published dense peaks (NVIDIA data sheet, 700 W)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
MAC_PER_POINT = 593_408  # the 13 products of the reference NeRF, per point
IMG_WH = (504, 378)
N_SAMPLES, N_IMPORTANCE = 64, 128
PLAIN_CHUNK = 8192  # rays per call of a plain version at the eval shapes
# kernel vs plain version: (max, mean) absolute error allowed.  Measured on
# an H100 (PERF.md): max 1.3e-6 and mean 2.4e-7 in float32, max 9.2e-5 and
# mean 2.9e-7 in bfloat16; the planted bf16 faults reach means of 4.1e-6
K1_TOL = {"float32": (2e-5, 1e-6), "bfloat16": (1e-3, 1e-6)}
K2_TOL = (1e-5, 1e-6)  # rtol, atol; measured bit-equal
# kernel render path vs plain render path on a whole image: (max, mean);
# measured max 2.0e-6, mean 2.5e-7 (float32) and 7.3e-5, 3.6e-7 (bfloat16)
IMAGE_TOL = {"float32": (2e-5, 1e-6), "bfloat16": (1e-3, 2e-6)}
# multiply-adds per point of the training backward: recompute, dgrad (no
# gradient to x or the direction PE) and wgrad (the direction-PE block once
# per ray)
MAC_PER_POINT_BWD = 593_408 + 556_544 + 589_312
TRAIN_RAYS, TRAIN_PATCH = 4096, 64  # a Step-1 batch: 4 bundles of 4096 rays
TRAIN_STEPS = 3
# The trained field starts opaque: its rays are absorbed before their last
# sample.  That sample's interval is 1e10 long, so its alpha is a step
# function of sigma that no gradient sees.  On the half-empty field of the
# other phases (+0.3) one Adam step moves the last weight of a sixth of the
# rays, the loss along the step is jagged and rises, on the plain path as on
# the kernels; tests/test_torch_train_kernels.py::
# test_half_empty_field_on_the_card reads both fields on the card.
TRAIN_SIGMA_SHIFT = 3.0
# K3-fwd vs its plain version (outputs and residuals): (max, mean), as K1
K3_FWD_TOL = K1_TOL
# gradients, worst leaf: (largest difference over the leaf's largest entry,
# relative L2).  A ReLU mask or a bf16 rounding that flips between two sum
# orders changes one unit's delta at one point by its whole size, so the
# gradient's error is far above the forward's; fewer points average less.
# Measured on an H100 (PERF.md): float32 up to (4.3e-4, 2.8e-4) (5292 rays x
# S = 9 of tests/test_torch_train_kernels.py; chip_smoke's own shapes stay
# below 3.2e-5), bfloat16 up to (7.9e-4, 5.7e-4); the first limits were 1e-3
# and 3e-2.
K3_BWD_TOL = {"float32": (2e-3, 1e-3), "bfloat16": (1e-2, 5e-3)}
# first train_step: kernel path vs plain path gradients, worst leaf.  The
# plain path rounds at other points in bfloat16 (autograd sends the weight
# gradients through its bf16 casts).  Measured: float32 (1.5e-4, 1.6e-4),
# bfloat16 (2.2e-3, 1.0e-3); the first limits were 1e-3 and 3e-2.
STEP_GRAD_TOL = {"float32": (1e-3, 1e-3), "bfloat16": (1e-2, 5e-3)}
# K4: the forward as K1.  The backward: (worst parameter leaf's largest
# difference over its largest entry, the worst relative L2 of a parameter
# leaf, dxyz and ddir).  A ReLU mask or a bf16 rounding that flips between
# the kernel's and the plain version's sum orders at one point changes one
# unit's delta there by its whole size: that moves a leaf, and the point's
# own dxyz, in either dtype (the input gradients are held by their relative
# L2 only; their largest difference is printed).  How far, the inputs decide:
# on the CPU, moving xyz by one float32 ulp moves the plain backward's worst
# leaf by 1.4e-2 to 3.7e-2 / 1.0e-2 to 1.2e-2 in float32 and 4.2e-2 to
# 7.0e-2 / 4.1e-2 to 4.5e-2 in bfloat16 (tests/test_torch_fused_mlp.py::
# test_k4_gradient_band_is_one_input_ulp).  Readings on an H100 at 20001 and
# 70001 points and at the path's: float32 up to 2.7e-2 / 6.6e-3, bfloat16 up
# to 2.1e-2 / 8.8e-3.  A call with fewer points than one tile (the tail
# chunks of the test_time and fast_eval=False branches) sums each leaf over
# few points, so one point's flip moves a leaf by ~1/sqrt(n) of its size and
# the relative L2 of dxyz by ~1/sqrt(n) (at 333 points ~5e-2).  Such calls
# are held to K4_BWD_TOL_SHORT; readings at 333 points over K4_SHORT_SEEDS
# draws: up to 1.3e-1 / 3.4e-2 (bfloat16) and 1.6e-2 / 3.5e-3 (float32).
K4_FWD_TOL = K1_TOL
K4_BWD_TOL = (5e-2, 3e-2)
K4_TILE = 4096
K4_BWD_TOL_SHORT = (3e-1, 1e-1)
K4_SHORT_SEEDS = 8
# X1 (K4-fwd's variants) is held to K4-fwd's limits; X2 (K3-bwd's) to
# K3-bwd's against its plain versions, and its exact variants against
# production K3-bwd to exp_bwd_pipeline.EXACT_TOL_SMALL at the small shapes and
# EXACT_TOL at the experiment's size (the same function, summed by atomics in
# another order)
X1_SMALL = (4096, 333)
# (rays, samples, seed): seed 60's weights open the sigma gate at 30% of the
# samples, seed 62's at all.  The ragged shape is held on an open field: on
# JAX's initial weights sigma lies within 2e-2 of 0 everywhere, and at 333 x
# 10 on seed 60's field a flip of the gate at one sample moves the sigma
# bias's gradient by 8% for production K3-bwd as for its variants (one ulp
# of the rays moves the plain version's by 4e9)
X2_SMALL = ((128, 8, 60), (333, 10, 62))
# the Hopper K3 kernels against the earlier ones at the path's shapes:
# (rounds that alternate them, launches of each per round) per dtype
K3_ROUNDS = {"bfloat16": (6, 2), "float32": (4, 1)}
# the Hopper K4 kernels against the earlier ones at the path's shapes:
# (rounds that alternate them, launches of each per round) per dtype
K4_ROUNDS = {"bfloat16": (4, 1), "float32": (4, 1)}
# the Hopper K1 kernels against the earlier ones at 131072 rays x S = 64 and
# 192: (rounds, launches of each per round) per dtype
K1_ROUNDS = {"bfloat16": (6, 2), "float32": (4, 1)}
# K2 beside its first port at each of its path's shapes: (rounds, launches
# of each per round).  K2 is timed behind a spin kernel of K2_LEAD_CYCLES
# clock cycles (about 11 ms), so that the host has queued a round's launches
# before the first one runs: at 16,384 rays the kernel is shorter than its
# wrapper's host time
K2_ROUNDS = (6, 20)
K2_LEAD_CYCLES = 20_000_000
# ragged K1 shapes: ray counts about one tile of 128 and none, and sample
# counts down to one; at one ray the mean error is that of one ray's few
# elements, where one bf16 rounding taken apart from the plain version
# decides it, so the bf16 mean is held over K1_SINGLE_RAYS single-ray
# launches (as tests/test_torch_k3_sm90.py holds K3-fwd's)
K1_RAGGED = ((1, 127, 128, 129, 1000, 5292), (1, 9, 12, 64, 192))
K1_SINGLE_RAYS = 64
# the Hopper kernels and K2, whose SASS phase 1 reads: (source, a tag of the
# mangled name, what the SASS must hold)
SASS_KERNELS = {
    "train_fwd_sm90": ("fused_render_train_sm90.cu", "train_fwd_sm90ILb1E", ("HGMMA", "BULK")),
    "train_bwd_sm90": ("fused_render_train_sm90.cu", "train_bwd_sm90ILi0E", ("HGMMA", "BULK")),
    "k1_sm90[bfloat16]": ("fused_render_sm90.cu", "train_fwd_sm90ILb0E", ("HGMMA", "BULK")),
    "k1_sm90[float32]": ("fused_render_sm90.cu", "render_f32_sm90ILb0E", ("FFMA", "BULK")),
    "k3_f32_fwd": ("f32_train_sm90.cu", "render_f32_sm90ILb1E", ("FFMA", "BULK", "NO_SPILLS")),
    "k3_f32_bwd": ("f32_train_sm90.cu", "k3_bwd_f32_sm90ILi0E", ("FFMA", "BULK", "RED_V4", "NO_SPILLS")),
    "k4_f32_bwd": ("f32_train_sm90.cu", "k4_bwd_f32_sm90", ("FFMA", "BULK", "RED_V4", "NO_SPILLS")),
    "k4_f32_fwd": ("f32_train_sm90.cu", "k4_fwd_f32_sm90ILb0E", ("FFMA", "BULK", "NO_SPILLS")),
    "k4_f32_fwd_sigma": ("f32_train_sm90.cu", "k4_fwd_f32_sm90ILb1E", ("FFMA", "BULK", "NO_SPILLS")),
    "k4_bwd_sm90": ("fused_mlp_sm90.cu", "k4_bwd_sm90ILi0E", ("HGMMA", "BULK", "RED_V4")),
    "k4_fwd_sm90": ("fused_mlp_sm90.cu", "k4_fwd_sm90ILb0E", ("HGMMA", "BULK")),
    "k4_fwd_sm90_sigma": ("fused_mlp_sm90.cu", "k4_fwd_sm90ILb1E", ("HGMMA", "BULK")),
    "k2_lanes": ("fused_sample_pdf.cu", "sample_pdf_lanes_kernelILi3E", ("LDG_128", "STG_128")),
    # the kernel experiments' Hopper variants (phases 12-13); pe is k4_fwd_sm90 itself
    **{f"x1[{name}]": ("exp_kernel_variants_sm90.cu", tag, ("HGMMA", "BULK") + extra) for name, tag, extra in (
        ("pe", "k4_fwd_sm90ILb0E", ()), ("base", "x1_fwd_sm90ILb0ELi1ELb0E", ()),
        ("ilp2", "x1_fwd_sm90ILb0ELi2ELb0E", ()), ("pe_ilp2", "x1_fwd_sm90ILb1ELi2ELb0E", ()),
        ("pe_ilp4", "x1_fwd_sm90ILb1ELi4ELb0E", ()), ("pe_ilp2_t2x", "x1_fwd_sm90ILb1ELi2ELb1E", ("MULTICAST",)))},
    # train_bwd_sm90's Ablate bits (mlp_backward_wgmma.cuh): base 0, no_db 4, no_mask 8, no_dw 2 | 16, mxu_floor
    # 32 | 8 | 4, cheap_pe 64, pe_pipe 128
    **{f"x2[{tag}]": ("exp_bwd_pipeline_sm90.cu", kernel, ("HGMMA", "BULK")) for tag, kernel in (
        ("base:128:1", "train_bwd_sm90ILi0E"), ("no_db:128:1", "train_bwd_sm90ILi4E"),
        ("no_mask:128:1", "train_bwd_sm90ILi8E"), ("no_dw:128:1", "train_bwd_sm90ILi18E"),
        ("mxu_floor:128:1", "train_bwd_sm90ILi44E"), ("cheap_pe:128:1", "train_bwd_sm90ILi64E"),
        ("pe_pipe:128:1", "train_bwd_sm90ILi128E"), ("two_stream:64:2", "two_stream_sm90ILi64E"),
        ("two_stream:32:2", "two_stream_sm90ILi32E"))},
}
# the bf16 stochastic steps that torch.profiler traces
PROFILED_STEPS = 3
# the Step-2 phases: the recipe's ViT and GAN weights (hinge) on the Step-1
# batch, whose 64x64 patches take the discriminator's 64 branch; their draws
# come from generators of their own, so that the phases before them draw as
# they did
STEP2_FIELDS = dict(vit_weight=10.0, dis_weight=0.01, dloss="hinge")
STEP2_SEED = 2024
STEP2_STEPS = 3
STEP2_ROUNDS = 6  # rounds that alternate the Step-1, Step-1 recipe and Step-2 steps
# what the names of the bf16 K3 kernels hold, for the profiler's split
K3_KERNEL_TAGS = ("train_fwd_sm90", "train_bwd_sm90")
MAC_PER_POINT_K4_BWD = 3 * MAC_PER_POINT  # recompute, dgrad with the input gradient, wgrad
CLI_EPOCHS = 2
# a training run's best val PSNR must clear what an empty field scores by
# this much: a black render's, and on Blender's white background the larger
# of a black and a white render's
EMPTY_MARGIN_DB = 1.0
# the resumed float32 epoch: kernel path vs plain path val PSNR (dB)
RESUME_PSNR_TOL = 1e-2
# the Blender and DTU slice (phases 18-22): the README's lego recipe at
# 400x400 and DTU scan4 at 640x512, 64 + 64 samples, the recipes' patches;
# draws from generators of their own, seeded by SLICE_SEED
SLICE_SEED = 4242
LEGO_WH, DTU_WH = (400, 400), (640, 512)
SLICE_N_IMPORTANCE = 64
LEGO_DATA = dict(patch_size=64, sW=6, sH=6, num_rays=4096, angle=20)
DTU_DATA = dict(patch_size_x=56, patch_size_y=70, sW=8, sH=8, num_rays=4096)
SLICE_ITEMS = 3  # items sampled per training set, after one more
# rays per training step: rot3d 4096 + 4096 + 2 x 64^2, proj 8192 + 4096 + 2
# x 64^2, DTU 4096 + 4096 + 2 x 56 x 70; the eval tiles of a 400x400 and a
# 640x512 image (131,072 + 28,928 and 2 x 131,072 + 65,536)
SLICE_TRAIN_RAYS = (16384, 20480, 16032)
SLICE_EVAL_TILES = (131072, 28928, 65536)
# the multi-GPU phase (23): up to DDP_MAX_WORLD ranks, DDP_STEPS sharded
# steps, draws from generators of their own seeded by DDP_SEED; the eval
# CLI's ranks against one card: mean PSNR (dB)
DDP_MAX_WORLD = 4
DDP_STEPS = 3
DDP_SEED = 5151
DDP_EVAL_PSNR_TOL = 1e-2


def k4_bwd_tol(n: int, cd: str):
    return K4_BWD_TOL_SHORT if n < K4_TILE else K4_BWD_TOL


class Failed(Exception):
    pass


def tf32_off() -> None:
    """cuBLAS and cuDNN in full float32, for every comparison of the run
    (this process's and the ranks' it starts)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def timed(fn, reps: int, lead_cycles: int = 0):
    """The port's timing rule (``sinnerf_tpu_torch.utils.timing.timed``): one
    warm-up call, then the mean of ``reps`` calls in ms by CUDA events (queued
    behind a spin kernel of ``lead_cycles`` when > 0).  Returns (the warm-up
    call's result, ms)."""
    from sinnerf_tpu_torch.utils.timing import timed as cuda_timed

    return cuda_timed(fn, reps, lead_cycles)


def make_params(seed: int, sigma_shift: float = 0.3):
    """Reference-width NeRF params from a numpy seed; the sigma head is
    shifted so that the random field is partly opaque (a field that is all
    empty composites to zeros and checks nothing)."""
    from sinnerf_tpu_torch.models.nerf import random_params

    p = random_params(np.random.default_rng(seed))
    p["sigma"]["b"] = p["sigma"]["b"] + np.float32(sigma_shift)
    return p


def make_model(seed: int, device, sigma_shift: float = 0.3):
    from sinnerf_tpu_torch.models.nerf import nerf_from_state, state_dict_from_jax

    return nerf_from_state(state_dict_from_jax(make_params(seed, sigma_shift))).to(device).eval()


def make_rays(rng, n: int, s: int, device):
    """Rays (N, 6) and ascending jittered depths (N, S) in [2, 6]."""
    import torch

    from sinnerf_tpu_torch.core.sampling import stratified_z_vals

    o = rng.normal(scale=0.3, size=(n, 3))
    d = rng.normal(scale=0.3, size=(n, 3)) + [0.0, 0.0, -1.0]
    rays = torch.tensor(np.concatenate([o, d], 1), dtype=torch.float32, device=device)
    near = torch.full((n, 1), 2.0, device=device)
    far = torch.full((n, 1), 6.0, device=device)
    u = torch.tensor(rng.uniform(size=(n, s)), dtype=torch.float32, device=device)
    z = stratified_z_vals(near, far, s, perturb=1.0, u=u)
    return rays, z


def k1_error(got, ref, far: float = 6.0):
    """(max, mean) absolute error of a render (rgb, depth, weights) against
    its reference, depth as a share of ``far``."""
    for t in got:
        if not bool(t.isfinite().all()):
            raise Failed("fused_render_level returned non-finite values")
    diffs = [(g.float() - r.float()).abs() / scale for g, r, scale in zip(got, ref, (1.0, far, 1.0))]
    return max(d.max().item() for d in diffs), max(d.mean().item() for d in diffs)


def hold(what: str, err, tol) -> None:
    print(f"{what}: max err {err[0]:.3e} (tol {tol[0]:.0e}), mean {err[1]:.3e} (tol {tol[1]:.0e})")
    if not (err[0] <= tol[0] and err[1] <= tol[1]):
        raise Failed(f"{what} disagrees with its plain version")


def grad_errors(got, ref):
    """Worst leaf of two lists of gradient tensors: (largest absolute
    difference over the reference leaf's largest entry, relative L2)."""
    worst_max = worst_l2 = 0.0
    for g, r in zip(got, ref):
        if g.shape != r.shape or not bool(g.isfinite().all()):
            raise Failed(f"gradient leaf of shape {tuple(g.shape)} (want {tuple(r.shape)}) or non-finite values")
        diff = g.double() - r.double()
        worst_max = max(worst_max, (diff.abs().max() / (r.abs().max().double() + 1e-30)).item())
        worst_l2 = max(worst_l2, (diff.norm() / (r.double().norm() + 1e-30)).item())
    return worst_max, worst_l2


def hold_grads(what: str, err, tol) -> None:
    print(f"{what}: worst leaf max/|max| {err[0]:.3e} (tol {tol[0]:.0e}), rel L2 {err[1]:.3e} (tol {tol[1]:.0e})")
    if not (err[0] <= tol[0] and err[1] <= tol[1]):
        raise Failed(f"{what} disagrees with its plain version")


def k2_error(got, ref, what: str) -> float:
    if got.shape != ref.shape or not bool(got.isfinite().all()):
        raise Failed(f"{what}: shape {tuple(got.shape)} or non-finite values")
    if not bool((got[:, 1:] >= got[:, :-1]).all()):
        raise Failed(f"{what}: rows are not ascending")
    rtol, atol = K2_TOL
    err = (got - ref).abs()
    print(f"{what}: max err {err.max().item():.3e} (tol {atol:.0e} + {rtol:.0e}|z|)")
    if (err - (atol + rtol * ref.abs())).max().item() > 0:
        raise Failed(f"{what} disagrees with its plain version")
    return err.max().item()


def in_chunks(fn, n: int, *args):
    """A plain version over rays [i, i + PLAIN_CHUNK), concatenated; rays
    are independent, and the chunks keep its (P, 256) activations small."""
    import torch

    outs = [fn(*(a[i : i + PLAIN_CHUNK] for a in args)) for i in range(0, n, PLAIN_CHUNK)]
    if isinstance(outs[0], torch.Tensor):
        return torch.cat(outs)
    return tuple(torch.cat(parts) for parts in zip(*outs))


def k1_bound(n: int, s: int, cd: str):
    from sinnerf_tpu_torch.ops.fused_mlp import BIAS_SIZE, WEIGHT_SIZE

    flops = 2.0 * MAC_PER_POINT * n * s
    wbytes = WEIGHT_SIZE * (2 if cd == "bfloat16" else 4) + BIAS_SIZE * 4
    nbytes = n * 6 * 4 + n * s * 4 + wbytes + n * 3 * 4 + n * 4 + n * s * 4
    t_ops, t_bytes = flops / PEAK_FLOPS[cd] * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def k2_bound(n: int, s: int, k: int, det: bool) -> float:
    """Bytes over the peak rate: z and w read, the (s + k) row written, and
    the n * k u-values read when the launch is stochastic."""
    return (2 * n * s * 4 + (0 if det else n * k * 4) + n * (s + k) * 4) / PEAK_BYTES * 1e3


def phase_k1_checks(device, rng):
    import torch

    from sinnerf_tpu_torch.ops.fused_render import fused_render_level, render_level_plain

    model = make_model(1, device)
    worst = {}
    shapes = [(4096, 64, False), (4096, 192, False), (1000, 12, False), (1000, 12, True)]
    shapes += [(n, s, wb) for n in K1_RAGGED[0] for s in K1_RAGGED[1] for wb in (False, True)]
    for n, s, white_back in shapes:
        rays, z = make_rays(rng, n, s, device)
        for cd in ("float32", "bfloat16"):
            got = fused_render_level(model, rays, z, True, white_back, cd)
            torch.cuda.synchronize()
            ref = render_level_plain(model, rays, z, True, white_back, cd)
            if got[2].shape != (n, s) or got[0].shape != (n, 3):
                raise Failed(f"fused_render_level shapes {[tuple(g.shape) for g in got]}")
            err = k1_error(got, ref)
            what = f"K1 {cd:8s} n={n:5d} S={s:3d} white_back={int(white_back)}"
            if n == 1 and cd == "bfloat16":  # its mean is held over single-ray launches below
                print(f"{what}: max err {err[0]:.3e} (tol {K1_TOL[cd][0]:.0e}), mean {err[1]:.3e} (one ray)")
                if not err[0] <= K1_TOL[cd][0]:
                    raise Failed(f"{what} disagrees with its plain version")
                err = (err[0], 0.0)
            else:
                hold(what, err, K1_TOL[cd])
            worst[cd] = tuple(max(a, b) for a, b in zip(worst.get(cd, (0.0, 0.0)), err))
    means = k1_single_ray_means(model, device, rng)
    hold(f"K1 bfloat16 n=1, the worst output's mean over {K1_SINGLE_RAYS} single-ray launches per case "
         f"(rgb, depth, weights: {', '.join(f'{m:.3e}' for m in means)})", (worst["bfloat16"][0], max(means)),
         K1_TOL["bfloat16"])
    worst["bfloat16"] = (worst["bfloat16"][0], max(worst["bfloat16"][1], max(means)))
    return worst


def k1_single_ray_means(model, device, rng):
    """K1 bf16's mean error per output (rgb, depth / far, weights) over
    K1_SINGLE_RAYS launches of one ray each, at S = 9 and at S = 12 with the
    white background."""
    from sinnerf_tpu_torch.ops.fused_render import fused_render_level, render_level_plain

    sums, counts = [0.0] * 3, [0] * 3
    for s, white_back in ((9, False), (12, True)):
        for _ in range(K1_SINGLE_RAYS):
            rays, z = make_rays(rng, 1, s, device)
            got = fused_render_level(model, rays, z, True, white_back, "bfloat16")
            ref = render_level_plain(model, rays, z, True, white_back, "bfloat16")
            for k, (g, r, scale) in enumerate(zip(got, ref, (1.0, 6.0, 1.0))):
                d = (g - r).abs() / scale
                if not bool(d.isfinite().all()):
                    raise Failed("fused_render_level returned non-finite values")
                sums[k] += d.double().sum().item()
                counts[k] += d.numel()
    return [sm / c for sm, c in zip(sums, counts)]


def phase_k2_checks(device, rng):
    import torch

    from sinnerf_tpu_torch.ops.fused_sample_pdf import fused_sample_pdf_merge, sample_pdf_merge_plain

    worst = 0.0
    cases = [(n, s, k, det, "", rng) for n, s, k, det in (
        (4096, 64, 64, True), (4096, 64, 64, False), (4096, 64, 128, True), (4096, 64, 128, False),
        (4096, 64, 1, True), (4096, 64, 1, False), (1000, 64, 128, True), (1000, 64, 128, False))]
    # adversarial rows: z in equal pairs (the edge between a pair is its value: the first fine depth,
    # at u = 0, ties with z), all-zero and one-hot weights (the pdf's guard bins), three samples.  They
    # draw from a generator of their own, so that the phases after this one draw what they drew before
    adv = np.random.default_rng(90)
    cases += [(1000, 64, 128, det, kind, adv) for kind in ("pairs", "zero_w", "one_hot") for det in (True, False)]
    cases += [(1000, 3, 40, det, "", adv) for det in (True, False)]
    for n, s, k, det, kind, gen in cases:
        _, z = make_rays(gen, n, s, device)
        w = torch.tensor(gen.uniform(size=(n, s)) ** 4, dtype=torch.float32, device=device)
        u = None if det else torch.tensor(gen.uniform(size=(n, k)), dtype=torch.float32, device=device)
        if kind == "pairs":
            z = z[:, ::2].repeat_interleave(2, dim=1).contiguous()
            if u is not None:
                u[:, ::3] = 0.0
        elif kind in ("zero_w", "one_hot"):
            w.zero_()
            if kind == "one_hot":
                w[:, 17] = 1.0
        got = fused_sample_pdf_merge(z, w, k, u, det)
        torch.cuda.synchronize()
        ref = sample_pdf_merge_plain(z, w, k, u, det)
        worst = max(worst, k2_error(got, ref, f"K2 n={n:5d} S={s:2d} K={k:3d} det={int(det)} {kind}"))
    return worst


def k2_timings(z, w, u, det: bool, ref, what: str):
    """K2 on one launch's inputs: the kernel on the path timed (behind the
    spin kernel), and its first port (``launch_sample_pdf_merge_earlier``),
    first held against ``ref``, the plain version's rows, timed beside it in
    K2_ROUNDS rounds that alternate them, with the kernel cut after its rows
    and after its CDF (``launch_sample_pdf_merge_parts``).  Returns the
    kernel's ms, the rounds' mean ms of each, each ratio's mean and range
    (the first port's and the cuts' to the kernel), and the first port's
    error."""
    import torch

    from sinnerf_tpu_torch.ops import fused_sample_pdf as fsp
    from sinnerf_tpu_torch.utils.timing import interleaved_ms

    n, s = z.shape
    _, ms = timed(lambda: fsp.fused_sample_pdf_merge(z, w, N_IMPORTANCE, u, det), K2_ROUNDS[1], K2_LEAD_CYCLES)
    earlier = fsp.launch_sample_pdf_merge_earlier(z, w, N_IMPORTANCE, u, det)
    torch.cuda.synchronize()
    earlier_err = k2_error(earlier, ref, f"{what} first port (one thread per ray)")
    del earlier
    fns = {"new": lambda: fsp.fused_sample_pdf_merge(z, w, N_IMPORTANCE, u, det),
           "earlier": lambda: fsp.launch_sample_pdf_merge_earlier(z, w, N_IMPORTANCE, u, det)}
    for part in fsp.PARTS:
        fns[f"to_{part}"] = lambda part=part: fsp.launch_sample_pdf_merge_parts(part, z, w, N_IMPORTANCE, u, det)
    count = fsp.fused_sample_pdf_merge.launches
    rounds, reps = K2_ROUNDS
    per_round = interleaved_ms(fns, rounds, reps, K2_LEAD_CYCLES)
    # these launches compare kernels: they do not count as the path's
    fsp.fused_sample_pdf_merge.launches = count

    def ratio(a, b):
        r = [x / y for x, y in zip(per_round[a], per_round[b])]
        return sum(r) / rounds, min(r), max(r)

    out = dict(ms=ms, new_ms=sum(per_round["new"]) / rounds, earlier_ms=sum(per_round["earlier"]) / rounds,
               ratio=ratio("new", "earlier"), earlier_err=earlier_err,
               parts_ms={p: sum(per_round[f"to_{p}"]) / rounds for p in fsp.PARTS},
               parts_vs_new={p: ratio(f"to_{p}", "new") for p in fsp.PARTS})
    print(f"  {rounds} rounds: K2 {out['new_ms']:.4f} ms, first port {out['earlier_ms']:.4f} ms (ratio "
          f"{out['ratio'][0]:.4f}, {out['ratio'][1]:.4f}-{out['ratio'][2]:.4f}); cut after "
          + ", ".join(f"{p} {out['parts_ms'][p]:.4f} ms ({out['parts_vs_new'][p][0]:.4f})" for p in fsp.PARTS)
          + f"; bound {k2_bound(n, s, N_IMPORTANCE, det):.4f} ms")
    return out


def make_scene(workdir: str):
    """The 504x378 LLFF scene and a reference-format .ckpt of random weights."""
    from sinnerf_tpu_torch.data.synthetic import make_llff_scene
    from sinnerf_tpu_torch.models.nerf import state_dict_from_jax
    from sinnerf_tpu_torch.train.checkpoints import save_torch_nerf_checkpoint

    root = make_llff_scene(os.path.join(workdir, "llff"), IMG_WH)
    ckpt = save_torch_nerf_checkpoint(
        os.path.join(workdir, "ckpts", "smoke.ckpt"),
        {"coarse": state_dict_from_jax(make_params(10)), "fine": state_dict_from_jax(make_params(11))},
    )
    return root, ckpt


def eval_tile() -> int:
    from sinnerf_tpu_torch.render.renderer import pick_val_tile

    w, h = IMG_WH
    return pick_val_tile(w * h, 32 * 1024 * 4)  # eval.py's default --chunk


def phase_path(device, root: str, ckpt: str):
    """Each kernel against its plain version at the eval path's shapes, on
    the rays of one val image and the inputs the path gives each launch
    (as ``render_rays`` chains them); then the kernel render path against
    the plain render path on the whole image."""
    import torch

    from sinnerf_tpu_torch import eval as port_eval
    from sinnerf_tpu_torch.core.sampling import stratified_z_vals
    from sinnerf_tpu_torch.data.llff import LLFFEval
    from sinnerf_tpu_torch.ops.fused_render import fused_render_level, render_level_plain
    from sinnerf_tpu_torch.ops.fused_sample_pdf import fused_sample_pdf_merge, sample_pdf_merge_plain
    from sinnerf_tpu_torch.render.renderer import RenderSettings, render_chunked

    models = port_eval.load_models(ckpt, device)
    rays = torch.from_numpy(LLFFEval(root, split="val", img_wh=IMG_WH).val_item(0)["rays"]).to(device)
    n_all, tile = rays.shape[0], eval_tile()
    far = rays[:, 7].max().item()
    out = {"k1": {}, "k2": [], "image": {}}
    for cd in ("bfloat16", "float32"):
        launches, worst = [], (0.0, 0.0)

        first_tile = []  # (level, rays, z, plain outputs) of the first tile's launches, for the rounds

        def k1(level, r, z):
            nonlocal worst
            n, s = z.shape
            got, ms = timed(lambda: fused_render_level(models[level], r, z, True, False, cd), 2)
            ref, plain_ms = timed(lambda: in_chunks(
                lambda rr, zz: render_level_plain(models[level], rr, zz, True, False, cd), n, r, z), 1)
            err = k1_error(got, ref, far)
            bound_ms, bound_by = k1_bound(n, s, cd)
            hold(f"path K1 {cd:8s} {level:6s} n={n:6d} S={s:3d} ({ms:.3f} ms, plain {plain_ms:.3f} ms, "
                 f"bound {bound_ms:.3f} ms)", err, K1_TOL[cd])
            worst = tuple(max(a, b) for a, b in zip(worst, err))
            launches.append(dict(shape=f"{n}x{s}", ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by))
            if n == tile:
                first_tile.append((level, r, z, ref))
            return got

        for i in range(0, n_all, tile):
            r = rays[i : i + tile]
            n = r.shape[0]
            z = stratified_z_vals(r[:, 6:7], r[:, 7:8], N_SAMPLES, False, 0.0)
            _, _, w_c = k1("coarse", r, z)
            z_all = fused_sample_pdf_merge(z, w_c, N_IMPORTANCE, None, True)
            torch.cuda.synchronize()
            ref, plain_ms = timed(lambda: in_chunks(
                lambda zz, ww: sample_pdf_merge_plain(zz, ww, N_IMPORTANCE, None, True), n, z, w_c), 3)
            what = f"path K2 {cd:8s} n={n:6d}"
            err = k2_error(z_all, ref, what)
            t = k2_timings(z, w_c, None, True, ref, what)
            print(f"  {t['ms']:.4f} ms, plain {plain_ms:.3f} ms")
            out["k2"].append(dict(shape=f"{n}x{N_SAMPLES}+{N_IMPORTANCE}", plain_ms=plain_ms,
                                  bound_ms=k2_bound(n, N_SAMPLES, N_IMPORTANCE, True), err=err, **t))
            k1("fine", r, z_all)
        rounds = {}
        for level, r, z, ref in first_tile:
            n, s = z.shape
            what = f"path K1 {cd:8s} {level:6s} n={n} S={s:3d}"
            x = rounds[f"{n}x{s}"] = k1_rounds(models[level], r, z, ref, cd, far, what)
            print(f"  {K1_ROUNDS[cd][0]} rounds: K1 {x['new_ms']:.3f} ms, earlier {x['earlier_ms']:.3f} ms "
                  f"(ratio {x['ratio'][0]:.4f}, {x['ratio'][1]:.4f}-{x['ratio'][2]:.4f})")
        del first_tile
        out["k1"][cd] = dict(launches=launches, err=worst, rounds=rounds)

        settings = RenderSettings(n_samples=N_SAMPLES, n_importance=N_IMPORTANCE, compute_dtype=cd)
        res, ms = timed(lambda: render_chunked(models, rays, settings, tile), 2)
        ref = render_chunked(models, rays, RenderSettings(
            n_samples=N_SAMPLES, n_importance=N_IMPORTANCE, compute_dtype=cd, mlp_impl="xla"), PLAIN_CHUNK)
        if res["rgb_fine"].shape != (n_all, 3):
            raise Failed(f"eval render has shape {tuple(res['rgb_fine'].shape)}")
        err = k1_error(*[(x["rgb_fine"], x["depth_fine"], x["opacity_fine"]) for x in (res, ref)], far)
        hold(f"image {cd:8s} kernel path vs plain path, {ms:.1f} ms per image", err, IMAGE_TOL[cd])
        k1_ms = sum(x["ms"] for x in launches)
        k2_ms = sum(x["ms"] for x in out["k2"][-math.ceil(n_all / tile):])
        print(f"image {cd:8s}: {ms:.1f} ms = K1 {k1_ms:.1f} + K2 {k2_ms:.3f} + rest {ms - k1_ms - k2_ms:.1f} ms")
        out["image"][cd] = dict(ms=ms, err=err)
        torch.cuda.empty_cache()
    return out


def k1_rounds(model, rays, z, ref, cd: str, far: float, what: str):
    """The Hopper K1 against the earlier one (``launch_render_block64``, first
    held against ``ref``, the plain version's outputs) on one launch's
    inputs, in K1_ROUNDS[cd] rounds that alternate them (each round's ratio
    is the one to compare).  Returns the mean ms of each, the ratio's mean
    and range over the rounds, and the earlier kernel's error."""
    import torch

    from sinnerf_tpu_torch.ops import fused_render as fr
    from sinnerf_tpu_torch.ops.fused_mlp import pack_tensors, param_tensors, torch_dtype
    from sinnerf_tpu_torch.utils.timing import interleaved_ms

    packed = pack_tensors(param_tensors(model), torch_dtype(cd))
    r6 = rays[:, :6].contiguous()
    earlier = fr.launch_render_block64(packed, r6, z, True, False)
    torch.cuda.synchronize()
    earlier_err = k1_error(earlier, ref, far)
    hold(f"{what} earlier kernel (64-ray blocks)", earlier_err, K1_TOL[cd])
    del earlier
    fns = {"new": lambda: fr.launch_render(packed, r6, z, True, False),
           "earlier": lambda: fr.launch_render_block64(packed, r6, z, True, False)}
    count = fr.fused_render_level.launches
    for fn in fns.values():  # warm-up
        fn()
    torch.cuda.synchronize()
    rounds, reps = K1_ROUNDS[cd]
    per_round = interleaved_ms(fns, rounds, reps)
    # these launches compare kernels: they do not count as the path's
    fr.fused_render_level.launches = count
    ratio = [a / b for a, b in zip(per_round["new"], per_round["earlier"])]
    return dict(new_ms=sum(per_round["new"]) / rounds, earlier_ms=sum(per_round["earlier"]) / rounds,
                ratio=(sum(ratio) / rounds, min(ratio), max(ratio)), earlier_err=earlier_err)


def phase_eval(device, workdir: str, root: str, ckpt: str, splits):
    """The main path: the port's eval CLI on the 504x378 LLFF scene."""
    import torch

    from sinnerf_tpu_torch import eval as port_eval
    from sinnerf_tpu_torch.ops.fused_render import fused_render_level
    from sinnerf_tpu_torch.ops.fused_sample_pdf import fused_sample_pdf_merge

    w, h = IMG_WH
    tiles = math.ceil(w * h / eval_tile())
    out = {"launches": {}, "psnr": {}}
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        for cd, cd_splits in splits:
            n_images = 0
            zero_counts((fused_render_level, fused_sample_pdf_merge))
            for split in cd_splits:
                args = port_eval.get_opts([
                    "--root_dir", root, "--dataset_name", "llff", "--split", split,
                    "--scene_name", f"smoke_{cd}_{split}", "--img_wh", str(w), str(h),
                    "--N_samples", str(N_SAMPLES), "--N_importance", str(N_IMPORTANCE),
                    "--ckpt_path", ckpt, "--compute_dtype", cd, "--device", "cuda",
                ])
                t0 = time.perf_counter()
                psnr = port_eval.main(args)
                torch.cuda.synchronize()
                n_split = len(glob.glob(os.path.join(workdir, "results", "llff", args.scene_name, "*", "*.png")))
                n_images += n_split
                print(f"eval {cd} {split}: {n_split} images in {time.perf_counter() - t0:.1f} s, PSNR {psnr}")
                if split == "val":
                    if psnr is None or not math.isfinite(psnr):
                        raise Failed(f"eval {cd} val PSNR is {psnr}")
                    out["psnr"][cd] = psnr
                if n_split == 0:
                    raise Failed(f"eval {cd} {split} wrote no PNG")
            k1, k2 = read_counts((fused_render_level, fused_sample_pdf_merge), cd)
            out["launches"][cd] = (k1, k2, n_images)
            print(f"launches {cd}: K1 {k1}, K2 {k2} over {n_images} images of {tiles} tiles")
            if k1 != 2 * tiles * n_images or k2 != tiles * n_images:
                raise Failed(f"launch counts K1 {k1}, K2 {k2} != {2 * tiles * n_images}, {tiles * n_images}")
    finally:
        os.chdir(cwd)
    return out


def k3_bound(n: int, s: int, cd: str, backward: bool):
    from sinnerf_tpu_torch.ops.fused_mlp import BIAS_SIZE, WEIGHT_SIZE

    wbytes = WEIGHT_SIZE * (2 if cd == "bfloat16" else 4) + BIAS_SIZE * 4
    ray_in = n * 6 * 4 + 2 * n * s * 4           # rays, depths, noise
    residuals = 2 * n * s * 4 + n * s * 3 * 4    # weights, alphas, per-sample rgb
    if backward:
        flops = 2.0 * MAC_PER_POINT_BWD * n * s
        nbytes = ray_in + residuals + wbytes + n * 4 * 4 + n * s * 4 + (WEIGHT_SIZE + BIAS_SIZE) * 4
    else:
        flops = 2.0 * MAC_PER_POINT * n * s
        nbytes = ray_in + wbytes + n * 4 * 4 + residuals
    t_ops, t_bytes = flops / PEAK_FLOPS[cd] * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def cotangents(out, target):
    """Nonzero cotangents on all three outputs: those of
    sum((rgb - target)^2) + 0.1 sum(depth^2) + 0.01 sum(weights^2)."""
    rgb, depth, weights = out[:3]
    return 2.0 * (rgb - target), 0.2 * depth, 0.02 * weights


def k3_fwd_error(out, ref, far: float):
    """A K3 forward's (largest, mean) error against its plain version: over
    rgb, depth / far and weights, and over the residuals rgb_s and alphas."""
    err_f = k1_error(out[:3], ref[:3], far)
    err_res = k1_error((out[4], out[3]), (ref[4], ref[3]), 1.0)
    return max(err_f[0], err_res[0]), max(err_f[1], err_res[1])


def k3_check(model, rays, z, noise, target, cd: str, white_back: bool, what: str, reps: int = 0):
    """K3-fwd and K3-bwd on one set of inputs against their plain versions.
    Returns the kernel forward's outputs, the plain forward's, the errors
    and, with ``reps``, the times (ms) of both kernels and both plain
    versions."""
    import torch

    from sinnerf_tpu_torch.ops import fused_render_train as frt
    from sinnerf_tpu_torch.ops.fused_mlp import pack_weights, torch_dtype, unpack_grads

    packed = pack_weights(model, torch_dtype(cd))
    n, s = z.shape
    far = rays[:, 7].max().item() if rays.shape[1] > 7 else 6.0
    out = frt.launch_train_fwd(packed, rays[:, :6].contiguous(), z, noise, True, white_back)
    torch.cuda.synchronize()
    ref = frt.render_level_train_forward_plain(packed, rays[:, :6], z, noise, True, white_back)
    if out[0].shape != (n, 3) or out[1].shape != (n,) or out[2].shape != (n, s):
        raise Failed(f"{what}: output shapes {[tuple(o.shape) for o in out[:3]]}")
    err_f = k3_fwd_error(out, ref, far)
    hold(f"{what} fwd", err_f, K3_FWD_TOL[cd])

    args = (packed, rays[:, :6].contiguous(), z, noise, out[2], out[3], out[4], *cotangents(out, target), True, white_back)
    got = unpack_grads(*frt.launch_train_bwd(*args))
    torch.cuda.synchronize()
    again = unpack_grads(*frt.launch_train_bwd(*args))
    want = unpack_grads(*frt.render_level_train_backward_plain(*args))
    err_b = grad_errors(got, want)
    spread = grad_errors(again, got)
    hold_grads(f"{what} bwd (two runs differ by {spread[0]:.1e}, {spread[1]:.1e})", err_b, K3_BWD_TOL[cd])
    times = None
    if reps:
        r6 = args[1]
        times = dict(
            fwd=timed(lambda: frt.launch_train_fwd(packed, r6, z, noise, True, white_back), reps)[1],
            bwd=timed(lambda: frt.launch_train_bwd(*args), reps)[1],
            fwd_plain=timed(lambda: frt.render_level_train_forward_plain(packed, r6, z, noise, True, white_back), 1)[1],
            bwd_plain=timed(lambda: frt.render_level_train_backward_plain(*args), 1)[1],
        )
    return out, ref, err_f, err_b, spread, times


def merge_worst(worst, cd, err_f, err_b, spread):
    w = worst.setdefault(cd, dict(fwd=(0.0, 0.0), bwd=(0.0, 0.0), spread=(0.0, 0.0)))
    for key, err in (("fwd", err_f), ("bwd", err_b), ("spread", spread)):
        w[key] = tuple(max(a, b) for a, b in zip(w[key], err))


def k1_equals_k3_fwd(model, device, rng):
    """K1 and K3-fwd without noise share one kernel template per dtype: the
    same rgb, depth and weights, bit for bit, at ragged shapes."""
    import torch

    from sinnerf_tpu_torch.ops import fused_render as fr
    from sinnerf_tpu_torch.ops import fused_render_train as frt
    from sinnerf_tpu_torch.ops.fused_mlp import pack_weights, torch_dtype

    for cd in ("float32", "bfloat16"):
        packed = pack_weights(model, torch_dtype(cd))
        for n, s, white_back in ((129, 13, False), (1000, 64, True)):
            rays, z = make_rays(rng, n, s, device)
            k1 = fr.launch_render(packed, rays, z, True, white_back)
            k3 = frt.launch_train_fwd(packed, rays, z, None, True, white_back)
            if not all(torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in zip(k1, k3[:3])):
                raise Failed(f"K1 {cd} and K3-fwd {cd} without noise differ at n={n} S={s}")
    print("K1 equals K3-fwd without noise, bit for bit, in both dtypes")


def phase_k3_checks(device, rng):
    import torch

    model = make_model(2, device)
    k1_equals_k3_fwd(model, device, rng)
    worst = {}
    # 1000 and 333 rays are no tile multiple; 56x70 and 63x84 are patch sizes;
    # S = 12 and 9 are no multiple of 8
    for n, s, white_back, use_noise in ((1000, 12, True, True), (333, 9, False, False),
                                        (56 * 70, 16, True, False), (63 * 84, 9, False, True)):
        rays, z = make_rays(rng, n, s, device)
        noise = torch.tensor(rng.normal(size=(n, s)), dtype=torch.float32, device=device) if use_noise else None
        target = torch.tensor(rng.uniform(size=(n, 3)), dtype=torch.float32, device=device)
        for cd in ("float32", "bfloat16"):
            what = f"K3 {cd:8s} n={n:5d} S={s:3d} white_back={int(white_back)} noise={int(use_noise)}"
            _, _, err_f, err_b, spread, _ = k3_check(model, rays, z, noise, target, cd, white_back, what)
            merge_worst(worst, cd, err_f, err_b, spread)
    return worst


def make_train_batch(rng, device):
    """A synthetic Step-1 batch with the sampler's schema at the shapes of
    the JAX package's ``bench.py::bench_train_step``: batch 1, 4096 random
    and 4096 projected rays, two 64x64 patches."""
    import torch

    n, ps = TRAIN_RAYS, TRAIN_PATCH

    def rays(m):
        o = rng.normal(size=(m, 3))
        d = rng.normal(size=(m, 3))
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        return np.concatenate([o, d, np.full((m, 1), 2.0), np.full((m, 1), 6.0)], axis=1).reshape(1, m, 8)

    def pos(*shape):
        return rng.uniform(2.0, 6.0, size=shape)

    batch = {
        "rays": rays(n),
        "rgbs": rng.uniform(size=(1, n, 3)),
        "depth": pos(1, n, 1),
        "rays_proj": rays(n),
        "depth_proj": pos(1, n, 1),
        "real_patch": rng.uniform(size=(1, 3, ps, ps)),
        "rays_full": rays(ps * ps),
        "warp_patch": rng.uniform(size=(1, 3, ps, ps)),
        "warp_patch_depth": pos(1, ps * ps, 1) * (rng.uniform(size=(1, ps * ps, 1)) > 0.5),
        "depth_ray": rays(ps * ps),
        "depth_gt": pos(1, ps * ps, 1),
        "depth_ray_rgb": rng.uniform(size=(1, ps * ps, 3)),
    }
    return {k: torch.tensor(v, dtype=torch.float32, device=device) for k, v in batch.items()}


def train_config(cd: str, mlp_impl: str = "pallas"):
    from sinnerf_tpu_torch.render.renderer import RenderSettings
    from sinnerf_tpu_torch.train.step import TrainConfig

    settings = RenderSettings(n_samples=N_SAMPLES, n_importance=N_IMPORTANCE, perturb=1.0, noise_std=1.0,
                              white_back=True, compute_dtype=cd, mlp_impl=mlp_impl)
    return TrainConfig(render=settings, depth_weight=8.0, proj_weight=1.0, depth_smooth_weight=0.5)


def make_draws(rng, n: int, device):
    import torch

    from sinnerf_tpu_torch.train.step import RenderDraws

    def t(a):
        return torch.tensor(a, dtype=torch.float32, device=device)

    return RenderDraws(
        perturb_u=t(rng.uniform(size=(n, N_SAMPLES))), noise_coarse=t(rng.normal(size=(n, N_SAMPLES))),
        pdf_u=t(rng.uniform(size=(n, N_IMPORTANCE))), noise_fine=t(rng.normal(size=(n, N_SAMPLES + N_IMPORTANCE))),
    )


def k3_rounds(model, rays, z, noise, out, ref, target, what: str, cd: str):
    """The Hopper K3 kernels against the earlier ones on one level's inputs,
    in K3_ROUNDS[cd] rounds that alternate them (each round's ratio is the
    one to compare).  The forward against the earlier forward
    (``launch_train_fwd_block64``: wmma in bfloat16, FMA in float32), first
    held against ``ref``, the plain forward's outputs, on the path's inputs;
    the backward and its ablations (``launch_train_bwd_ablated``; bfloat16:
    ``flush`` removes the weight gradients' reductions and nothing else,
    ``wgrad`` their products too; float32: ``flush``, and ``scratch`` the kept
    tiles' round trip through global memory) against the earlier backward:
    in bfloat16 X2's earlier ``base`` (``launch_variant_earlier``, the first
    port's wmma body) on the inputs without noise and with a black background,
    which X2's kernels take (the same work), in float32
    ``launch_train_bwd_block64`` on the path's own.  Returns per name the
    mean ms, per ratio its mean and range, and the earlier forward's error."""
    import torch

    from sinnerf_tpu_torch.ops import fused_render_train as frt
    from sinnerf_tpu_torch.ops.fused_mlp import pack_weights, torch_dtype
    from sinnerf_tpu_torch.scripts import exp_bwd_pipeline as x2
    from sinnerf_tpu_torch.utils.timing import interleaved_ms

    bf16 = cd == "bfloat16"
    packed = pack_weights(model, torch_dtype(cd))
    slabs = frt._slabs(packed, None)
    r6 = rays[:, :6].contiguous()
    # the earlier forward times beside the new one (and gives X2 its
    # residuals): held against its plain version as the new one is
    earlier = frt.launch_train_fwd_block64(packed, r6, z, noise, True, True)
    torch.cuda.synchronize()
    earlier_err = k3_fwd_error(earlier, ref, rays[:, 7].max().item())
    hold(f"{what} earlier fwd", earlier_err, K3_FWD_TOL[cd])
    del earlier
    g_rgb, g_depth, g_w = (g.contiguous() for g in cotangents(out, target))
    if bf16:
        bwd = (packed, r6, z, None, out[2], out[3], out[4], g_rgb, g_depth, g_w, True, False)
        base_in = x2.BwdInputs(packed, r6, z, out[2], out[3], out[4], g_rgb, g_depth, g_w)
        bwd_earlier = lambda: x2.launch_variant_earlier("base", 64, 1, base_in)  # noqa: E731
    else:
        bwd = (packed, r6, z, noise, out[2], out[3], out[4], g_rgb, g_depth, g_w, True, True)
        bwd_earlier = lambda: frt.launch_train_bwd_block64(*bwd)  # noqa: E731
    fns = {
        "fwd": lambda: frt.launch_train_fwd(packed, r6, z, noise, True, True, slabs),
        "fwd_earlier": lambda: frt.launch_train_fwd_block64(packed, r6, z, noise, True, True),
        "bwd": lambda: frt.launch_train_bwd(*bwd, slabs=slabs),
        "bwd_earlier": bwd_earlier,
    }
    parts = frt.ABLATE if bf16 else frt.ABLATE_F32
    for part in parts:
        fns[f"bwd_no_{part}"] = lambda part=part: frt.launch_train_bwd_ablated(part, *bwd, slabs=slabs)
    for fn in fns.values():  # warm-up
        fn()
    torch.cuda.synchronize()
    counts = (frt.launch_train_fwd.launches, frt.launch_train_bwd.launches)
    rounds, reps = K3_ROUNDS[cd]
    per_round = interleaved_ms(fns, rounds, reps)
    # these launches compare kernels: they do not count as the path's
    frt.launch_train_fwd.launches, frt.launch_train_bwd.launches = counts
    ms = {k: sum(v) / rounds for k, v in per_round.items()}
    ratios = {}
    for num, den in [("fwd", "fwd_earlier"), ("bwd", "bwd_earlier")] + [(f"bwd_no_{p}", "bwd") for p in parts]:
        r = [a / b for a, b in zip(per_round[num], per_round[den])]
        ratios[f"{num}/{den}"] = (sum(r) / len(r), min(r), max(r))
    return ms, ratios, earlier_err


def phase_train_path(device, rng, batch, draws):
    """K3 and K2 at the training path's shapes, on the inputs ``train_step``
    gives each launch: the batch's 16,384 rays, S = 64 then 192."""
    import torch

    from sinnerf_tpu_torch.core.sampling import stratified_z_vals
    from sinnerf_tpu_torch.ops import fused_render_train as frt
    from sinnerf_tpu_torch.ops.fused_sample_pdf import fused_sample_pdf_merge, sample_pdf_merge_plain

    rays = torch.cat([batch[k].reshape(-1, 8) for k in ("rays", "depth_ray", "rays_full", "rays_proj")])
    n = rays.shape[0]
    target = torch.tensor(rng.uniform(size=(n, 3)), dtype=torch.float32, device=device)
    models = {"coarse": make_model(20, device), "fine": make_model(21, device)}
    out = {"k3": {}, "k2": []}
    for cd in ("bfloat16", "float32"):
        worst, launches = {}, []
        z = stratified_z_vals(rays[:, 6:7], rays[:, 7:8], N_SAMPLES, False, 1.0, u=draws.perturb_u)
        for level, noise in (("coarse", draws.noise_coarse), ("fine", draws.noise_fine)):
            s = z.shape[1]
            res, ref, err_f, err_b, spread, ms = k3_check(
                models[level], rays, z, noise, target, cd, True, f"path K3 {cd:8s} {level:6s} n={n} S={s:3d}", reps=3)
            merge_worst(worst, cd, err_f, err_b, spread)
            bounds = {d: k3_bound(n, s, cd, d == "bwd") for d in ("fwd", "bwd")}
            print(f"  fwd {ms['fwd']:.3f} ms (plain {ms['fwd_plain']:.1f}, bound {bounds['fwd'][0]:.3f}); "
                  f"bwd {ms['bwd']:.3f} ms (plain {ms['bwd_plain']:.1f}, bound {bounds['bwd'][0]:.3f})")
            row = dict(shape=f"{n}x{s}", ms=ms, bounds=bounds)
            row["rounds_ms"], row["ratios"], row["earlier_fwd_err"] = k3_rounds(
                models[level], rays, z, noise, res, ref, target, f"path K3 {cd:8s} {level:6s} n={n} S={s:3d}", cd)
            r, rm = row["ratios"], row["rounds_ms"]
            parts = frt.ABLATE if cd == "bfloat16" else frt.ABLATE_F32
            print(f"  {K3_ROUNDS[cd][0]} rounds: fwd {rm['fwd']:.3f} ms, earlier fwd {rm['fwd_earlier']:.3f} ms "
                  f"(ratio {r['fwd/fwd_earlier'][0]:.4f}, {r['fwd/fwd_earlier'][1]:.4f}-{r['fwd/fwd_earlier'][2]:.4f}); "
                  f"bwd {rm['bwd']:.3f} ms, earlier ({'X2 first-port base' if cd == 'bfloat16' else 'block64'}) "
                  f"{rm['bwd_earlier']:.3f} ms (ratio {r['bwd/bwd_earlier'][0]:.4f}, {r['bwd/bwd_earlier'][1]:.4f}-"
                  f"{r['bwd/bwd_earlier'][2]:.4f}); bwd without each part: "
                  + ", ".join(f"{p} {rm[f'bwd_no_{p}']:.3f} ms ({r[f'bwd_no_{p}/bwd'][0]:.4f}, "
                              f"{r[f'bwd_no_{p}/bwd'][1]:.4f}-{r[f'bwd_no_{p}/bwd'][2]:.4f})" for p in parts))
            launches.append(row)
            if level == "coarse":
                w_c = res[2]
                z_all = fused_sample_pdf_merge(z, w_c, N_IMPORTANCE, draws.pdf_u, False)
                torch.cuda.synchronize()
                ref, plain_ms = timed(lambda: in_chunks(
                    lambda zz, ww, uu: sample_pdf_merge_plain(zz, ww, N_IMPORTANCE, uu, False), n, z, w_c, draws.pdf_u), 3)
                what = f"path K2 {cd:8s} n={n} drawn u"
                err = k2_error(z_all, ref, what)
                t = k2_timings(z, w_c, draws.pdf_u, False, ref, what)
                print(f"  {t['ms']:.4f} ms, plain {plain_ms:.3f} ms")
                out["k2"].append(dict(shape=f"{n}x{N_SAMPLES}+{N_IMPORTANCE}u", plain_ms=plain_ms,
                                      bound_ms=k2_bound(n, N_SAMPLES, N_IMPORTANCE, False), err=err, **t))
                z = z_all
        out["k3"][cd] = dict(launches=launches, **worst[cd])
        torch.cuda.empty_cache()
    return out


def new_train_state(device, sigma_shift: float = TRAIN_SIGMA_SHIFT, lr: float = 2e-4):
    """Fresh coarse and fine models from fixed seeds, and Adam over both."""
    import argparse

    from sinnerf_tpu_torch.train.optimizers import get_optimizer
    from sinnerf_tpu_torch.train.step import TrainState

    models = {"coarse": make_model(30, device, sigma_shift).train(), "fine": make_model(31, device, sigma_shift).train()}
    hp = argparse.Namespace(optimizer="adam", lr=lr, momentum=0.9, weight_decay=0.0)
    return TrainState(models=models, opt_g=get_optimizer(hp, [p for m in models.values() for p in m.parameters()]))


def phase_profile(device, batch, draws):
    """``torch.profiler`` over PROFILED_STEPS bf16 stochastic ``train_step``s
    (after one untraced step), last of all so that the tracer touches no
    other measurement: the device's busy share of the host-clock window (the
    sum of the kernels' and copies' device times over it; one stream, so
    they do not overlap), its idle share, and device time by kernel name
    (ms per step, largest first)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from sinnerf_tpu_torch.train.step import train_step

    cfg = train_config("bfloat16")
    state, _ = train_step(new_train_state(device), batch, cfg, 0.0, draws)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILED_STEPS):
            state, _ = train_step(state, batch, cfg, 0.0, draws)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    out = dict(wall_ms_per_step=wall_ms / PROFILED_STEPS, busy_ms_per_step=busy / PROFILED_STEPS,
               busy_share=busy / wall_ms if busy else None, idle_share=1 - busy / wall_ms if busy else None,
               kernels_ms_per_step={k[:80]: v / PROFILED_STEPS for k, v in top})
    if busy:
        print(f"profiler, {PROFILED_STEPS} steps: {out['wall_ms_per_step']:.2f} ms per step (host clock, traced), "
              f"device busy {out['busy_ms_per_step']:.2f} ms ({100 * out['busy_share']:.1f}%), idle "
              f"{100 * out['idle_share']:.1f}%; by kernel, ms per step: "
              + "; ".join(f"{k[:60]} {v:.3f}" for k, v in out["kernels_ms_per_step"].items()))
    else:
        print("profiler: the trace holds no device time (device idle share: not measured)")
    return out


def step2_config(cd: str, mlp_impl: str = "pallas", **fields):
    """``train_config`` with the Step-2 extras of STEP2_FIELDS (``fields``
    overriding)."""
    import dataclasses

    return dataclasses.replace(train_config(cd, mlp_impl), **{**STEP2_FIELDS, **fields})


def make_step2_draws(gen, b: int, device):
    """One step's Step-2 draws from the CPU generator ``gen``: the ViT
    refresh coins (on the host, as the step takes them), then each
    discriminator call's coin and DiffAugment draws (on the card)."""
    import torch

    from sinnerf_tpu_torch.models.diffaug import DiffAugDraws, fill_draws
    from sinnerf_tpu_torch.models.discriminator import DCallDraws
    from sinnerf_tpu_torch.train.step import POLICY, Step2Draws, refresh_coins

    x = torch.zeros(b, 3, TRAIN_PATCH, TRAIN_PATCH)

    def call():
        coin = torch.rand((), generator=gen) < 0.5
        aug = fill_draws(x, POLICY, generator=gen)
        return DCallDraws(coin.to(device), DiffAugDraws(*(None if t is None else t.to(device) for t in aug)))

    return Step2Draws(refresh=refresh_coins(b, gen), d_fake_g=call(), d_real=call(), d_fake=call())


def new_step2_state(device, lr: float = 2e-4):
    """``new_train_state`` with the Step-2 extras: the full ViT-S/16 and the
    discriminator (ndf 64, the 64 branch), random from STEP2_SEED, and
    Adam at 0.2x for the discriminator, as the trainer builds them."""
    import argparse

    import torch

    from sinnerf_tpu_torch.models.discriminator import Discriminator
    from sinnerf_tpu_torch.models.vit import EMBED_DIM, load_vit
    from sinnerf_tpu_torch.train.optimizers import get_optimizer

    state = new_train_state(device, lr=lr)
    gen = torch.Generator().manual_seed(STEP2_SEED)
    state.discriminator = Discriminator(imsize=TRAIN_PATCH, generator=gen).to(device)
    hp = argparse.Namespace(optimizer="adam", lr=lr, momentum=0.9, weight_decay=0.0)
    state.opt_d = get_optimizer(hp, state.discriminator.parameters(), rate=0.2)
    state.vit = load_vit(None, gen).to(device)
    state.ref_feature = torch.zeros((1, EMBED_DIM), device=device)
    state.ref_feature_valid = torch.zeros((1,), dtype=torch.bool)
    return state


STEP2_LOSSES = ("train/loss", "train/loss_vit", "train/loss_d", "train/loss_g_adv")


def phase_step2(device, batch, draws):
    """The Step-2 training path: ``train_step`` with the ViT loss and the
    PatchGAN at full width, bf16 and f32.  STEP2_STEPS steps on the kernels
    and on the plain path with the same render and Step-2 draws (the losses
    of every step, the NeRFs' and the discriminator's gradients of the
    first, to STEP_GRAD_TOL); then, from fresh weights, one step and
    STEP2_STEPS timed steps with every launch count set to 0 just before and
    read just after (per step K3-fwd 2, K3-bwd 2, K2 1); then in
    STEP2_ROUNDS alternating rounds one step each of phase 8's Step-1 step,
    the Step-1 recipe's (the ViT on, the GAN off) and this one."""
    import torch

    from sinnerf_tpu_torch.ops.fused_render_train import launch_train_bwd, launch_train_fwd
    from sinnerf_tpu_torch.ops.fused_sample_pdf import fused_sample_pdf_merge
    from sinnerf_tpu_torch.train.step import train_step
    from sinnerf_tpu_torch.utils.timing import interleaved_ms

    gen = torch.Generator().manual_seed(STEP2_SEED + 1)
    step_draws = [make_step2_draws(gen, 1, device) for _ in range(1 + STEP2_STEPS)]
    out = {}
    for cd in ("bfloat16", "float32"):
        # STEP2_STEPS steps on the kernels and on the plain path, the same
        # render and Step-2 draws: the losses of every step, the gradients
        # of the first (later ones start from weights that differ)
        tol = STEP_GRAD_TOL[cd]
        states = {impl: new_step2_state(device) for impl in ("pallas", "xla")}
        loss_err, err_g, err_d = 0.0, None, None
        for i in range(STEP2_STEPS):
            seen = {}
            for impl in states:
                states[impl], aux = train_step(states[impl], batch, step2_config(cd, impl), 0.0, draws,
                                               step2_draws=step_draws[i])
                seen[impl] = dict(losses={t: aux["metrics"][t].item() for t in STEP2_LOSSES},
                                  g=[p.grad for m in states[impl].models.values() for p in m.parameters()],
                                  d=[p.grad for p in states[impl].discriminator.parameters()])
            k, x = seen["pallas"], seen["xla"]
            if i == 0:
                err_g, err_d = grad_errors(k["g"], x["g"]), grad_errors(k["d"], x["d"])
            step_err = max(abs(k["losses"][t] - x["losses"][t]) / max(abs(x["losses"][t]), 1e-30)
                           for t in STEP2_LOSSES)
            loss_err = max(loss_err, step_err)
            print(f"Step-2 train_step {cd} step {i + 1}: " + ", ".join(
                f"{t[6:]} {k['losses'][t]:.6f} (plain {x['losses'][t]:.6f})" for t in STEP2_LOSSES))
            if not all(math.isfinite(v) and v != 0.0 for v in k["losses"].values()):
                raise Failed(f"Step-2 train_step {cd}: a loss is zero or not finite: {k['losses']}")
        print(f"Step-2 train_step {cd:8s} losses over {STEP2_STEPS} steps, kernel path vs plain path: worst "
              f"relative difference {loss_err:.3e} (tol {tol[0]:.0e})")
        if not loss_err <= tol[0]:
            raise Failed(f"Step-2 train_step {cd}: the kernel path's losses leave the plain path's")
        hold_grads(f"Step-2 train_step {cd:8s} first step's NeRF gradients, kernel path vs plain path", err_g, tol)
        hold_grads(f"Step-2 train_step {cd:8s} first step's discriminator gradients, kernel path vs plain path",
                   err_d, tol)
        del states, seen, k, x
        torch.cuda.empty_cache()

        # the path's run: STEP2_STEPS steps from fresh weights, counted and timed
        state, _ = train_step(new_step2_state(device), batch, step2_config(cd), 0.0, draws, step2_draws=step_draws[0])
        torch.cuda.synchronize()
        counters = (launch_train_fwd, launch_train_bwd, fused_sample_pdf_merge)
        zero_counts(counters)
        losses = []
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(STEP2_STEPS):
            state, aux = train_step(state, batch, step2_config(cd), 0.0, draws, step2_draws=step_draws[1 + i])
            losses.append(aux["metrics"]["train/loss"])
        end.record()
        end.synchronize()
        counts = read_counts(counters, cd)
        step_ms = start.elapsed_time(end) / STEP2_STEPS
        losses = [float(v) for v in losses]
        u_moved = state.discriminator.u()[0].norm().item()
        if counts != (2 * STEP2_STEPS, 2 * STEP2_STEPS, STEP2_STEPS):
            raise Failed(f"Step-2 train_step {cd}: launch counts {counts}")
        if not all(math.isfinite(v) for v in losses) or not math.isfinite(u_moved):
            raise Failed(f"Step-2 train_step {cd}: losses {losses}, |u| {u_moved}")

        # beside it, in rounds that alternate them: phase 8's step (no
        # extras), the Step-1 recipe's (the ViT on, the GAN off) and this one
        states = {"step1": new_train_state(device), "step1_vit": new_step2_state(device), "step2": state}
        states["step1_vit"].discriminator = states["step1_vit"].opt_d = None
        cfgs = {"step1": train_config(cd), "step1_vit": step2_config(cd, dis_weight=0.0), "step2": step2_config(cd)}

        def stepper(name):
            def run():
                states[name], _ = train_step(states[name], batch, cfgs[name], 0.0, draws, step2_draws=step_draws[1])
            return run

        fns = {name: stepper(name) for name in states}
        for fn in fns.values():  # warm-up
            fn()
        torch.cuda.synchronize()
        saved = tuple(c.launches for c in counters)
        per_round = interleaved_ms(fns, STEP2_ROUNDS, 1)
        for c, n in zip(counters, saved):  # these steps compare the variants: not the path's launches
            c.launches = n
        rounds_ms = {k: (sum(v) / len(v), min(v), max(v)) for k, v in per_round.items()}
        del states, state, fns
        torch.cuda.empty_cache()
        print(f"Step-2 train_step {cd}: {step_ms:.2f} ms per step; launches over {STEP2_STEPS} steps: K3-fwd "
              f"{counts[0]}, K3-bwd {counts[1]}, K2 {counts[2]}; loss {' -> '.join(f'{v:.6f}' for v in losses)}; "
              f"in {STEP2_ROUNDS} alternating rounds, ms per step (mean, min-max): " + ", ".join(
                  f"{k} {m:.2f} ({lo:.2f}-{hi:.2f})" for k, (m, lo, hi) in rounds_ms.items()))
        out[cd] = dict(step_ms=step_ms, rounds_ms=rounds_ms, counts=counts, losses=losses, loss_err=loss_err,
                       grad_err=err_g, d_grad_err=err_d)
    return out


class StepParts:
    """Marks where the ViT's and the discriminator's work starts and ends in
    a step, forward and backward, by launching a one-cycle spin kernel at
    each mark and keeping the marks' order on the host: the device runs one
    stream, so in a profiler trace the kernels between a part's marks are
    that part's.  Forward marks wrap ``vit_cls`` and the discriminator's
    ``forward``; backward marks sit on their outputs (the gradient arrives)
    and inputs (it leaves), and on the discriminator's first weight (its
    gradient is complete, which ends the backward of the calls whose input
    takes none)."""

    def __init__(self):
        self.tags = []  # (part, "open" | "close" | "close_all"), in launch order

    def mark(self, part: str, what: str) -> None:
        import torch

        self.tags.append((part, what))
        torch.cuda._sleep(1)

    def passthrough(self, x, part: str, what: str):
        import torch

        parts = self

        class Mark(torch.autograd.Function):
            @staticmethod
            def forward(ctx, t):
                return t.view_as(t)

            @staticmethod
            def backward(ctx, g):
                parts.mark(part, what)
                return g

        return Mark.apply(x) if x.requires_grad else x

    def install(self, step_module, discriminator):
        """Patch ``step_module.vit_cls`` and ``discriminator.forward``;
        returns a function that removes the patches."""
        real_vit, real_d = step_module.vit_cls, discriminator.forward

        def vit_cls(model, x):
            self.mark("vit", "open")
            x = self.passthrough(x, "vit", "close")
            out = real_vit(model, x)
            self.mark("vit", "close")
            return self.passthrough(out, "vit", "open")

        def d_forward(x, *args, **kwargs):
            self.mark("d", "open")
            x = self.passthrough(x, "d", "close")
            out, u = real_d(x, *args, **kwargs)
            self.mark("d", "close")
            return self.passthrough(out, "d", "open"), u

        hook = discriminator.convs()[0].weight_orig.register_hook(lambda g: self.mark("d", "close_all"))
        step_module.vit_cls, discriminator.forward = vit_cls, d_forward

        def remove():
            step_module.vit_cls = real_vit
            del discriminator.forward
            hook.remove()

        return remove

    def attribute(self, kernels):
        """Device ms per part over ``kernels`` [(name, start, end)] in device
        order: each kernel goes to the part whose mark opened last among the
        open ones, else to "rest".  None when the trace's spin kernels do not
        match the marks one for one."""
        spins = [kv for kv in kernels if "spin_kernel" in kv[0]]
        if len(spins) != len(self.tags):
            return None
        ms = {"vit": 0.0, "d": 0.0, "rest": 0.0}
        open_stack = []
        marks = iter(self.tags)
        for name, t0, t1 in kernels:
            if "spin_kernel" in name:
                part, what = next(marks)
                if what == "open":
                    open_stack.append(part)
                elif what == "close" and part in open_stack:
                    open_stack.reverse()
                    open_stack.remove(part)
                    open_stack.reverse()
                elif what == "close_all":
                    open_stack = [p for p in open_stack if p != part]
                continue
            ms[open_stack[-1] if open_stack else "rest"] += (t1 - t0) / 1e3
        return ms


def phase_step2_profile(device, batch, draws):
    """``torch.profiler`` over PROFILED_STEPS bf16 Step-2 steps (after one
    untraced step) with the ViT's and the discriminator's work marked
    (``StepParts``): the device's busy and idle share of the host-clock
    window, and its time by part: the K3 launches, K2, the ViT forward and
    backward, the discriminator's calls forward and backward, the rest."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from sinnerf_tpu_torch.train import step as step_module

    cfg = step2_config("bfloat16")
    gen = torch.Generator().manual_seed(STEP2_SEED + 2)
    step_draws = [make_step2_draws(gen, 1, device) for _ in range(1 + PROFILED_STEPS)]
    state, _ = step_module.train_step(new_step2_state(device), batch, cfg, 0.0, draws, step2_draws=step_draws[0])
    torch.cuda.synchronize()
    parts = StepParts()
    remove = parts.install(step_module, state.discriminator)
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(PROFILED_STEPS):
                state, _ = step_module.train_step(state, batch, cfg, 0.0, draws, step2_draws=step_draws[1 + i])
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        remove()
    kernels = sorted(((e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                      if e.device_type == DeviceType.CUDA), key=lambda kv: kv[1])
    busy = sum((t1 - t0) / 1e3 for name, t0, t1 in kernels if "spin_kernel" not in name)
    n = PROFILED_STEPS
    k3 = sum((t1 - t0) / 1e3 for name, t0, t1 in kernels if any(t in name for t in K3_KERNEL_TAGS))
    k2 = sum((t1 - t0) / 1e3 for name, t0, t1 in kernels if "sample_pdf" in name)
    by_part = parts.attribute(kernels)
    out = dict(wall_ms_per_step=wall_ms / n, busy_ms_per_step=busy / n, k3_ms_per_step=k3 / n,
               k2_ms_per_step=k2 / n, idle_share=1 - busy / wall_ms if busy else None,
               marks=len(parts.tags))
    if by_part is not None:
        out.update({f"{p}_ms_per_step": v / n for p, v in by_part.items()})
    if not busy:
        print("Step-2 profiler: the trace holds no device time (device idle share: not measured)")
        return out
    split = (f"ViT fwd+bwd {out['vit_ms_per_step']:.2f} ms, discriminator calls fwd+bwd {out['d_ms_per_step']:.2f} ms"
             if by_part is not None else "ViT and discriminator: not measured (the marks did not match the trace)")
    print(f"Step-2 profiler, {n} bf16 steps: {out['wall_ms_per_step']:.2f} ms per step (host clock, traced), device "
          f"busy {out['busy_ms_per_step']:.2f} ms, idle {100 * out['idle_share']:.1f}%; per step: K3 "
          f"{out['k3_ms_per_step']:.2f} ms ({100 * k3 / busy:.1f}% of busy), K2 {out['k2_ms_per_step']:.3f} ms, {split} "
          f"({len(parts.tags) // n} marks per step)")
    return out


def phase_step2_cli(device):
    """SinNeRF's two-step LLFF recipe through the train CLI on the 504x378
    scene, bf16, each step cut to CLI_EPOCHS epochs of 5 steps: Step 1 with
    the random-weight ViT (``--vit_weight 10 --allow_random_pretrained``),
    Step 2 with the PatchGAN warm-started from Step 1's ``last.ckpt``
    (``--dis_weight 0.01 --vit_weight 0 --nerf_only``), then Step 2 resumed
    for one more epoch.  Per run the launch counts, ms per step and val PSNR
    (the two steps' best must clear a black render's by EMPTY_MARGIN_DB)."""
    import torch

    out = {}
    with tempfile.TemporaryDirectory() as workdir:
        root, _ = make_scene(workdir)
        ckpts = os.path.join(workdir, "train_ckpts")
        step1_last = os.path.join(ckpts, "smoke_step1", "last.ckpt")
        step2 = ["--dis_weight", "0.01", "--vit_weight", "0", "--pt_model", step1_last, "--nerf_only"]
        runs = (
            ("step1", cli_flags(root, workdir, "bfloat16", "smoke_step1") + ["--vit_weight", "10",
                                                                               "--allow_random_pretrained"]),
            ("step2", cli_flags(root, workdir, "bfloat16", "smoke_step2") + step2),
            ("step2_resumed", cli_flags(root, workdir, "bfloat16", "smoke_step2") + step2 + [
                "--num_epochs", str(CLI_EPOCHS + 1), "--ckpt_path", os.path.join(ckpts, "smoke_step2", "last.ckpt")]),
        )
        empty = None
        for name, flags in runs:
            trainer, counts, wall = run_cli(flags)
            hold_dtype(counts, "bfloat16", f"train CLI {name}")
            if empty is None:
                empty = empty_render_psnr(trainer.val_dataset)
            steps = sum(e[1] for e in trainer.epoch_log)
            step_ms = 1e3 * sum(e[2] for e in trainer.epoch_log) / steps
            blob = torch.load(os.path.join(ckpts, trainer.hparams.exp_name, "last.ckpt"), map_location="cpu",
                              weights_only=False)
            d_keys = sum(k.startswith("D.") for k in blob["state_dict"])
            print(f"train CLI {name}: {steps} steps, {step_ms:.1f} ms per step (host clock over each epoch), "
                  f"{wall:.1f} s in all; val PSNR per epoch {trainer.val_log} (black render {empty:.4f}); launches "
                  f"{counts}; last.ckpt: {d_keys} discriminator tensors, {len(blob['optimizer_states'])} optimizer "
                  f"states, ViT cache {'ref_feature' in blob}")
            want_epochs = [CLI_EPOCHS] if name == "step2_resumed" else list(range(CLI_EPOCHS))
            if [e[0] for e in trainer.epoch_log] != want_epochs or not math.isfinite(trainer.best_psnr):
                raise Failed(f"train CLI {name}: epochs {trainer.epoch_log}, PSNR {trainer.best_psnr}")
            if name != "step2_resumed" and trainer.best_psnr < empty + EMPTY_MARGIN_DB:
                raise Failed(f"train CLI {name}: best val PSNR {trainer.best_psnr}, a black render scores {empty}")
            if counts["K3-fwd"] != 2 * steps or counts["K3-bwd"] != 2 * steps or counts["K2"] < steps:
                raise Failed(f"train CLI {name}: launch counts {counts}")
            gan = name != "step1"
            if (d_keys > 0) != gan or len(blob["optimizer_states"]) != 1 + gan or ("ref_feature" in blob) == gan:
                raise Failed(f"train CLI {name}: checkpoint holds {d_keys} D tensors, "
                             f"{len(blob['optimizer_states'])} optimizer states")
            out[name] = dict(counts=counts, steps=steps, step_ms=step_ms, wall_s=wall, psnr=trainer.best_psnr,
                             val_log=trainer.val_log)
            del trainer
            torch.cuda.empty_cache()
    out["empty_psnr"] = empty
    return out


def phase_train(device, batch, draws):
    """The training main path: ``train_step`` at full width."""
    import torch

    from sinnerf_tpu_torch.ops.fused_render_train import launch_train_bwd, launch_train_fwd
    from sinnerf_tpu_torch.ops.fused_sample_pdf import fused_sample_pdf_merge
    from sinnerf_tpu_torch.train.step import train_step

    out = {}
    for cd in ("bfloat16", "float32"):
        def grads(state):
            return [p.grad.clone() for m in state.models.values() for p in m.parameters()]

        # first step: the kernel path's gradients against the plain path's
        state = new_train_state(device)
        state, aux = train_step(state, batch, train_config(cd), 0.0, draws)
        torch.cuda.synchronize()
        losses = [aux["metrics"]["train/loss"].item()]
        plain, plain_aux = train_step(new_train_state(device), batch, train_config(cd, "xla"), 0.0, draws)
        err = grad_errors(grads(state), grads(plain))
        print(f"train_step {cd}: first loss {losses[0]:.6f} (plain path {plain_aux['metrics']['train/loss'].item():.6f})")
        hold_grads(f"train_step {cd:8s} first step's gradients, kernel path vs plain path", err, STEP_GRAD_TOL[cd])
        del plain, plain_aux
        torch.cuda.empty_cache()

        counters = (launch_train_fwd, launch_train_bwd, fused_sample_pdf_merge)
        zero_counts(counters)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(TRAIN_STEPS):
            state, aux = train_step(state, batch, train_config(cd), 0.0, draws)
            losses.append(aux["metrics"]["train/loss"])
        end.record()
        end.synchronize()
        counts = read_counts(counters, cd)
        step_ms = start.elapsed_time(end) / TRAIN_STEPS
        losses = [float(x) for x in losses]
        print(f"train_step {cd}: {step_ms:.2f} ms per step; launches over {TRAIN_STEPS} steps: K3-fwd {counts[0]}, "
              f"K3-bwd {counts[1]}, K2 {counts[2]}; loss {' -> '.join(f'{x:.6f}' for x in losses)}")
        if counts != (2 * TRAIN_STEPS, 2 * TRAIN_STEPS, TRAIN_STEPS):
            raise Failed(f"train_step {cd}: launch counts {counts}")
        if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
            raise Failed(f"train_step {cd}: the loss did not fall: {losses}")
        if state.step != 1 + TRAIN_STEPS:
            raise Failed(f"train_step {cd}: step counter {state.step}")
        out[cd] = dict(counts=counts, step_ms=step_ms, losses=losses, grad_err=err)
        del state
        torch.cuda.empty_cache()
    return out


def k4_bound(n: int, cd: str, backward: bool):
    from sinnerf_tpu_torch.ops.fused_mlp import BIAS_SIZE, WEIGHT_SIZE

    wbytes = WEIGHT_SIZE * (2 if cd == "bfloat16" else 4) + BIAS_SIZE * 4
    if backward:  # xyz, dirs, g in; dxyz, ddir, dW, db out
        flops = 2.0 * MAC_PER_POINT_K4_BWD * n
        nbytes = n * 6 * 4 + n * 4 * 4 + wbytes + n * 6 * 4 + (WEIGHT_SIZE + BIAS_SIZE) * 4
    else:  # xyz, dirs in; rgb, sigma out
        flops = 2.0 * MAC_PER_POINT * n
        nbytes = n * 6 * 4 + wbytes + n * 4 * 4
    t_ops, t_bytes = flops / PEAK_FLOPS[cd] * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def input_grad_error(got, ref):
    """(largest difference over the largest entry, relative L2) of dxyz or ddir."""
    if got.shape != ref.shape or not bool(got.isfinite().all()):
        raise Failed(f"input gradient of shape {tuple(got.shape)} (want {tuple(ref.shape)}) or non-finite values")
    diff = got.double() - ref.double()
    return ((diff.abs().max() / (ref.abs().max() + 1e-30)).item(), (diff.norm() / (ref.double().norm() + 1e-30)).item())


def k4_bwd_error(got, want):
    """K4-bwd's (dw, db, dxyz, ddir) against its plain version's: the worst
    (the worst parameter leaf's largest difference over its largest entry,
    the worst relative L2 of a leaf, dxyz and ddir) and the parts (parameters,
    dxyz, ddir when there is one)."""
    from sinnerf_tpu_torch.ops import fused_mlp as fm

    errs = [grad_errors(fm.unpack_grads(*got[:2]), fm.unpack_grads(*want[:2])), input_grad_error(got[2], want[2])]
    if want[3] is not None:
        errs.append(input_grad_error(got[3], want[3]))
    return (errs[0][0], max(e[1] for e in errs)), errs


def k4_check(model, xyz, dirs, g, cd: str, sigma_only: bool, what: str, reps: int = 0, refs=None):
    """K4-fwd and K4-bwd on one set of inputs against their plain versions.
    Returns the errors (fwd (max, mean), bwd worst of the parameter leaves,
    dxyz and ddir, spread of two runs) and, with ``reps``, the times (ms).
    A dict passed as ``refs`` receives the plain versions' results (``fwd``,
    ``bwd``)."""
    import torch

    from sinnerf_tpu_torch.ops import fused_mlp as fm

    packed = fm.pack_weights(model, fm.torch_dtype(cd))
    n = xyz.shape[0]
    out = fm.launch_mlp_fwd(packed, xyz, dirs, True, sigma_only)
    torch.cuda.synchronize()
    ref = fm.nerf_mlp_forward_plain(packed, xyz, dirs, True, sigma_only)
    if out.shape != (n, 1 if sigma_only else 4) or not bool(out.isfinite().all()):
        raise Failed(f"{what}: forward shape {tuple(out.shape)} or non-finite values")
    diff = (out - ref).abs()
    err_f = (diff.max().item(), diff.mean().item())
    hold(f"{what} fwd", err_f, K4_FWD_TOL[cd])

    args = (packed, xyz, dirs, g, True, sigma_only)
    got = fm.launch_mlp_bwd(*args)
    torch.cuda.synchronize()
    again = fm.launch_mlp_bwd(*args)
    want = fm.nerf_mlp_backward_plain(*args)
    if sigma_only and (got[3] is not None):
        raise Failed(f"{what}: a sigma-only backward returned ddir")
    err_b, errs = k4_bwd_error(got, want)
    if refs is not None:
        refs.update(fwd=ref, bwd=want)
    spread = grad_errors(fm.unpack_grads(*again[:2]) + again[2:3], fm.unpack_grads(*got[:2]) + got[2:3])
    hold_grads(f"{what} bwd (params {errs[0][0]:.1e}/{errs[0][1]:.1e}, dxyz {errs[1][0]:.1e}/{errs[1][1]:.1e}"
               + ("" if sigma_only else f", ddir {errs[2][0]:.1e}/{errs[2][1]:.1e}")
               + f"; two runs differ by {spread[0]:.1e}, {spread[1]:.1e})", err_b, k4_bwd_tol(n, cd))
    times = None
    if reps:
        times = dict(
            fwd=timed(lambda: fm.launch_mlp_fwd(packed, xyz, dirs, True, sigma_only), reps)[1],
            bwd=timed(lambda: fm.launch_mlp_bwd(*args), reps)[1],
            fwd_plain=timed(lambda: fm.nerf_mlp_forward_plain(packed, xyz, dirs, True, sigma_only), 1)[1],
            bwd_plain=timed(lambda: fm.nerf_mlp_backward_plain(*args), 1)[1],
        )
    return err_f, err_b, spread, times




def k4_rounds(model, xyz, dirs, g, cd: str, refs):
    """The Hopper K4 kernels against the earlier ones of ``fused_mlp.cu`` on
    one launch's inputs, in K4_ROUNDS rounds that alternate them: K4-bwd and
    K4-fwd with the sigma-only K4-fwd in both dtypes, and bfloat16 K4-bwd
    without its dW flush.  The earlier kernels and the sigma-only
    pass are first held against the plain versions' results ``refs``
    (``k4_check``).  Returns per name the mean ms, per ratio its mean and
    range, and the earlier kernels' errors."""
    import torch

    from sinnerf_tpu_torch.ops import fused_mlp as fm
    from sinnerf_tpu_torch.utils.timing import interleaved_ms

    packed = fm.pack_weights(model, fm.torch_dtype(cd))
    args = (packed, xyz, dirs, g)
    if cd == "float32":
        fns = {"bwd": lambda: fm.launch_mlp_bwd(*args), "bwd_earlier": lambda: fm.launch_mlp_bwd_block64(*args),
               "fwd": lambda: fm.launch_mlp_fwd(packed, xyz, dirs),
               "fwd_earlier": lambda: fm.launch_mlp_fwd_block64(packed, xyz, dirs),
               "fwd_sigma": lambda: fm.launch_mlp_fwd(packed, xyz, None, True, True)}
        pairs = (("bwd", "bwd_earlier"), ("fwd", "fwd_earlier"), ("fwd_sigma", "fwd"))
    else:
        fns = {"bwd": lambda: fm.launch_mlp_bwd(*args), "bwd_earlier": lambda: fm.launch_mlp_bwd_wmma(*args),
               "bwd_no_flush": lambda: fm.launch_mlp_bwd_ablated(*args),
               "fwd": lambda: fm.launch_mlp_fwd(packed, xyz, dirs),
               "fwd_earlier": lambda: fm.launch_mlp_fwd_wmma(packed, xyz, dirs),
               "fwd_sigma": lambda: fm.launch_mlp_fwd(packed, xyz, None, True, True)}
        pairs = (("bwd", "bwd_earlier"), ("bwd_no_flush", "bwd"), ("fwd", "fwd_earlier"), ("fwd_sigma", "fwd"))
    counts = fm.launch_mlp_fwd.launches, fm.launch_mlp_bwd.launches
    outs = {name: fn() for name, fn in fns.items()}  # warm-up
    torch.cuda.synchronize()
    errs = {"bwd_earlier": k4_bwd_error(outs["bwd_earlier"], refs["bwd"])[0]}
    hold_grads(f"  earlier K4-bwd {cd}", errs["bwd_earlier"], K4_BWD_TOL)
    if not torch.equal(outs["fwd_sigma"][:, 0].view(torch.int32), outs["fwd"][:, 3].view(torch.int32)):
        raise Failed(f"sigma-only K4-fwd {cd} differs from the full pass's sigma")
    print(f"  sigma-only K4-fwd {cd} equals the full pass's sigma bit for bit")
    for name, ref in (("fwd_earlier", refs["fwd"]), ("fwd_sigma", refs["fwd"][:, 3:])):
        if name in outs:
            diff = (outs[name] - ref).abs()
            errs[name] = (diff.max().item(), diff.mean().item())
            hold(f"  {'earlier K4-fwd' if name == 'fwd_earlier' else 'sigma-only K4-fwd'} {cd}", errs[name],
                 K4_FWD_TOL[cd])
    del outs
    rounds, reps = K4_ROUNDS[cd]
    per_round = interleaved_ms(fns, rounds, reps)
    # these launches compare kernels: they do not count as the path's
    fm.launch_mlp_fwd.launches, fm.launch_mlp_bwd.launches = counts
    ratios = {}
    for a, b in pairs:
        r = [x / y for x, y in zip(per_round[a], per_round[b])]
        ratios[f"{a}/{b}"] = (sum(r) / len(r), min(r), max(r))
    return {k: sum(v) / rounds for k, v in per_round.items()}, ratios, errs


def phase_k4_checks(device, rng):
    import torch

    model = make_model(4, device)
    worst = {}
    # 20001 and 70001 points are no tile multiple; 333 points, a short tail
    # of less than one tile, over K4_SHORT_SEEDS draws each (its worst is kept
    # apart, under "<dtype>_short")
    shapes = [(20001, False), (20001, True), (70001, False), (70001, True)]
    shapes += [(333, sigma_only) for _ in range(K4_SHORT_SEEDS) for sigma_only in (False, True)]
    for n, sigma_only in shapes:
        xyz = torch.tensor(rng.normal(scale=2.0, size=(n, 3)), dtype=torch.float32, device=device)
        dirs = torch.tensor(rng.normal(size=(n, 3)), dtype=torch.float32, device=device)
        g = torch.tensor(rng.normal(size=(n, 1 if sigma_only else 4)), dtype=torch.float32, device=device)
        for cd in ("float32", "bfloat16"):
            err_f, err_b, spread, _ = k4_check(model, xyz, dirs, g, cd, sigma_only,
                                               f"K4 {cd:8s} n={n:6d} sigma_only={int(sigma_only)}")
            merge_worst(worst, cd if n >= K4_TILE else f"{cd}_short", err_f, err_b, spread)
    return worst


def det_config(cd: str, mlp_impl: str = "pallas"):
    import dataclasses

    cfg = train_config(cd, mlp_impl)
    return dataclasses.replace(cfg, render=dataclasses.replace(cfg.render, perturb=0.0, noise_std=0.0))


def phase_det_train(device, rng, batch):
    """The deterministic training path: K4 at its shapes on the inputs a
    step gives it, then ``train_step`` (K1 forward, K2 det, K4 in K1's
    backward) against the plain path and timed."""
    import torch

    from sinnerf_tpu_torch.core.sampling import stratified_z_vals
    from sinnerf_tpu_torch.ops.fused_mlp import launch_mlp_bwd, launch_mlp_fwd
    from sinnerf_tpu_torch.ops.fused_render import fused_render_level
    from sinnerf_tpu_torch.ops.fused_render_train import launch_train_bwd, launch_train_fwd
    from sinnerf_tpu_torch.ops.fused_sample_pdf import fused_sample_pdf_merge
    from sinnerf_tpu_torch.train.step import train_step

    rays = torch.cat([batch[k].reshape(-1, 8) for k in ("rays", "depth_ray", "rays_full", "rays_proj")])
    n = rays.shape[0]
    model = make_model(40, device)
    out = {"k4": {}, "step": {}}
    for cd in ("bfloat16", "float32"):
        z = stratified_z_vals(rays[:, 6:7], rays[:, 7:8], N_SAMPLES, False, 0.0)
        w_c = fused_render_level(model, rays, z, True, True, cd)[2]
        z_all = fused_sample_pdf_merge(z, w_c.detach(), N_IMPORTANCE, None, True)
        rows, worst = [], {}
        for zz in (z, z_all):
            s = zz.shape[1]
            xyz = (rays[:, None, 0:3] + rays[:, None, 3:6] * zz[..., None]).reshape(-1, 3).contiguous()
            dirs = rays[:, None, 3:6].expand(n, s, 3).reshape(-1, 3).contiguous()
            g = torch.tensor(rng.normal(scale=1e-3, size=(n * s, 4)), dtype=torch.float32, device=device)
            refs = {}
            err_f, err_b, spread, ms = k4_check(model, xyz, dirs, g, cd, False,
                                                f"path K4 {cd:8s} n={n}x{s}={n * s}", reps=3, refs=refs)
            merge_worst(worst, cd, err_f, err_b, spread)
            bounds = {d: k4_bound(n * s, cd, d == "bwd") for d in ("fwd", "bwd")}
            print(f"  fwd {ms['fwd']:.3f} ms (plain {ms['fwd_plain']:.1f}, bound {bounds['fwd'][0]:.3f}); "
                  f"bwd {ms['bwd']:.3f} ms (plain {ms['bwd_plain']:.1f}, bound {bounds['bwd'][0]:.3f})")
            rm, ratios, earlier_err = k4_rounds(model, xyz, dirs, g, cd, refs)
            rows.append(dict(shape=f"{n * s}", ms=ms, bounds=bounds, rounds_ms=rm, ratios=ratios,
                             earlier_err=earlier_err))
            print(f"  {K4_ROUNDS[cd][0]} rounds: " + ", ".join(f"{k} {v:.3f} ms" for k, v in rm.items()) + "; "
                  + ", ".join(f"{k} {v[0]:.4f} ({v[1]:.4f}-{v[2]:.4f})" for k, v in ratios.items()))
            del xyz, dirs, g, refs
            torch.cuda.empty_cache()
        out["k4"][cd] = dict(launches=rows, **worst[cd])

        def grads(state):
            return [p.grad.clone() for m in state.models.values() for p in m.parameters()]

        state = new_train_state(device)
        state, aux = train_step(state, batch, det_config(cd), 0.0)
        torch.cuda.synchronize()
        losses = [aux["metrics"]["train/loss"].item()]
        plain, plain_aux = train_step(new_train_state(device), batch, det_config(cd, "xla"), 0.0)
        err = grad_errors(grads(state), grads(plain))
        print(f"det train_step {cd}: first loss {losses[0]:.6f} (plain path {plain_aux['metrics']['train/loss'].item():.6f})")
        hold_grads(f"det train_step {cd:8s} first step's gradients, kernel path vs plain path", err, STEP_GRAD_TOL[cd])
        del plain, plain_aux
        torch.cuda.empty_cache()

        counters = (fused_render_level, fused_sample_pdf_merge, launch_mlp_fwd, launch_mlp_bwd, launch_train_fwd,
                    launch_train_bwd)
        zero_counts(counters)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(TRAIN_STEPS):
            state, aux = train_step(state, batch, det_config(cd), 0.0)
            losses.append(aux["metrics"]["train/loss"])
        end.record()
        end.synchronize()
        counts = read_counts(counters[:4], cd) + tuple(c.launches for c in counters[4:])
        step_ms = start.elapsed_time(end) / TRAIN_STEPS
        losses = [float(x) for x in losses]
        print(f"det train_step {cd}: {step_ms:.2f} ms per step; launches over {TRAIN_STEPS} steps: K1 {counts[0]}, "
              f"K2 {counts[1]}, K4-fwd {counts[2]}, K4-bwd {counts[3]}, K3 {counts[4]}+{counts[5]}; "
              f"loss {' -> '.join(f'{x:.6f}' for x in losses)}")
        t = TRAIN_STEPS
        if counts != (2 * t, t, 2 * t, 2 * t, 0, 0):
            raise Failed(f"det train_step {cd}: launch counts {counts}")
        if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
            raise Failed(f"det train_step {cd}: the loss did not fall: {losses}")
        out["step"][cd] = dict(counts=counts, step_ms=step_ms, losses=losses, grad_err=err)
        del state
        torch.cuda.empty_cache()
    return out


def cli_flags(root: str, workdir: str, cd: str, exp: str):
    w, h = IMG_WH
    return [
        "--dataset_name", "llff_ray_patch_1image_proj", "--root_dir", root, "--img_wh", str(w), str(h),
        "--N_samples", str(N_SAMPLES), "--N_importance", str(N_IMPORTANCE), "--num_rays", str(TRAIN_RAYS),
        "--depth_weight", "8", "--proj_weight", "1", "--depth_smooth_weight", "0.5",
        "--num_epochs", str(CLI_EPOCHS), "--check_val_every_n_epoch", "1",
        # the reference's LLFF patch (63x84 at stride 6 spans the image), one
        # item per step on one card, and the Step-1 recipe's depth and no GAN
        "--patch_size_x", "63", "--patch_size_y", "84", "--sW", "6", "--sH", "6",
        "--batch_size", "1", "--num_gpus", "1", "--dis_weight", "0", "--load_depth",
        "--lr", "2e-4", "--compute_dtype", cd, "--device", "cuda",
        "--ckpt_dir", os.path.join(workdir, "train_ckpts"), "--log_dir", os.path.join(workdir, "train_logs"),
        "--exp_name", exp,
    ]


def white_render_psnr(val_dataset) -> float:
    """The val PSNR of an all-white render: what an empty field scores on a
    scene with a white background (Blender), where a black render's is the
    gate."""
    import torch

    from sinnerf_tpu_torch.utils.metrics import psnr

    gts = [torch.from_numpy(val_dataset.val_item(i)["rgbs"]) for i in range(val_dataset.val_len())]
    return float(torch.stack([psnr(torch.ones_like(gt), gt) for gt in gts]).mean())


def empty_render_psnr(val_dataset) -> float:
    """The val PSNR of a black render (the trainer's mean over the val
    images): what a field whose sigma ReLU is closed at every sample scores
    on a scene without a white background."""
    import torch

    from sinnerf_tpu_torch.utils.metrics import psnr

    gts = [torch.from_numpy(val_dataset.val_item(i)["rgbs"]) for i in range(val_dataset.val_len())]
    return float(torch.stack([psnr(torch.zeros_like(gt), gt) for gt in gts]).mean())


def zero_counts(counters):
    """Set each wrapper's launch count to 0, and its counts per dtype."""
    for c in counters:
        c.launches = 0
        for cd in getattr(c, "launches_by_dtype", {}):
            c.launches_by_dtype[cd] = 0


def read_counts(counters, cd: str):
    """Each wrapper's launches of its ``cd`` kernel, as the wrapper counted
    them per dtype (K2 has one dtype: all its launches)."""
    return tuple(c.launches_by_dtype[cd] if hasattr(c, "launches_by_dtype") else c.launches for c in counters)


def counted(fn):
    """``fn()`` with every kernel's launch count set to 0 just before and
    read just after: (its result, the counts, seconds in all).  The counts
    hold each kernel's launches ("K1") and, as the wrapper counted them,
    those of each dtype ("K1[bfloat16]"; K2 has one dtype)."""
    import torch

    from sinnerf_tpu_torch.ops.fused_mlp import launch_mlp_bwd, launch_mlp_fwd
    from sinnerf_tpu_torch.ops.fused_render import fused_render_level
    from sinnerf_tpu_torch.ops.fused_render_train import launch_train_bwd, launch_train_fwd
    from sinnerf_tpu_torch.ops.fused_sample_pdf import fused_sample_pdf_merge

    names = ("K1", "K2", "K3-fwd", "K3-bwd", "K4-fwd", "K4-bwd")
    counters = (fused_render_level, fused_sample_pdf_merge, launch_train_fwd, launch_train_bwd, launch_mlp_fwd,
                launch_mlp_bwd)
    zero_counts(counters)
    t0 = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    counts = {k: c.launches for k, c in zip(names, counters)}
    counts.update({f"{k}[{cd}]": n for k, c in zip(names, counters)
                   for cd, n in getattr(c, "launches_by_dtype", {}).items()})
    return result, counts, time.perf_counter() - t0


def hold_dtype(counts, cd: str, what: str):
    """Fails unless each kernel that ``counted`` saw launch ran its ``cd``
    kernel alone."""
    names = [k for k in counts if f"{k}[{cd}]" in counts]
    if any(counts[f"{k}[{cd}]"] != counts[k] for k in names):
        raise Failed(f"{what}: a run in {cd} launched kernels of another dtype: {counts}")


def run_cli(flags):
    """``python -m sinnerf_tpu_torch.train``'s ``main`` on ``flags``, counted:
    (the trainer, the counts, seconds in all)."""
    from sinnerf_tpu_torch.opt import get_opts
    from sinnerf_tpu_torch.train.__main__ import main as train_main

    return counted(lambda: train_main(get_opts(flags)))


def phase_train_cli(device, workdir: str, root: str):
    """The train CLI's ``main`` in both configurations, a resume on the
    kernel and the plain path, and the eval CLI on one of its checkpoints."""
    import torch

    from sinnerf_tpu_torch import eval as port_eval

    out = {}
    empty = None
    # From the random weights, without the sigma noise, the first steps close
    # sigma's ReLU at every sample and the render turns black for good (on
    # the card and, from the same weights, in the JAX trainer on the CPU:
    # scripts/det_training_witness.py, PERF.md).  The deterministic runs
    # warm-start from the stochastic run instead (--pt_model, as Step 2
    # consumes Step 1).
    det = ["--perturb", "0", "--noise_std", "0", "--pt_model",
           os.path.join(workdir, "train_ckpts", "smoke_stochastic_bfloat16", "last.ckpt")]
    runs = (("stochastic", "bfloat16", []), ("deterministic", "bfloat16", det), ("deterministic", "float32", det))
    for mode, cd, extra in runs:
        exp = f"smoke_{mode}_{cd}"
        trainer, counts, wall = run_cli(cli_flags(root, workdir, cd, exp) + extra)
        hold_dtype(counts, cd, f"train CLI {mode} {cd}")
        if empty is None:
            empty = empty_render_psnr(trainer.val_dataset)
        steps = sum(e[1] for e in trainer.epoch_log)
        step_ms = 1e3 * sum(e[2] for e in trainer.epoch_log) / steps
        ckpt_dir = os.path.join(workdir, "train_ckpts", exp)
        files = sorted(os.listdir(ckpt_dir))
        print(f"train CLI {mode} {cd}: {steps} steps, {step_ms:.1f} ms per step (host clock over each epoch), "
              f"{wall:.1f} s in all; val PSNR per epoch {trainer.val_log} (black render {empty:.4f}); "
              f"launches {counts}; checkpoints {files}")
        if not math.isfinite(trainer.best_psnr) or trainer.best_psnr < empty + EMPTY_MARGIN_DB:
            raise Failed(f"train CLI {mode} {cd}: best val PSNR {trainer.best_psnr}, a black render scores {empty}")
        if "last.ckpt" not in files or sum(f.startswith("epoch_") for f in files) != 2:
            raise Failed(f"train CLI {mode} {cd}: checkpoints {files}")
        stochastic = mode == "stochastic"
        want = dict(zip(("K3-fwd", "K3-bwd", "K4-fwd", "K4-bwd"),
                        (2 * steps, 2 * steps, 0, 0) if stochastic else (0, 0, 2 * steps, 2 * steps)))
        if any(counts[k] != v for k, v in want.items()) or counts["K1"] == 0 or counts["K2"] < steps:
            raise Failed(f"train CLI {mode} {cd}: launch counts {counts}, want {want} and K1, K2 > 0")
        out[f"{mode}_{cd}"] = dict(counts=counts, steps=steps, step_ms=step_ms, wall_s=wall, psnr=trainer.best_psnr,
                                   val_log=trainer.val_log, files=files)
        del trainer
        torch.cuda.empty_cache()

    # Resume the float32 deterministic run from its last checkpoint for a
    # third epoch, first on the plain path (into another directory), then on
    # the kernels: the same weights, Adam state and batches.  That epoch
    # closes the field on both paths (PERF.md), so it is held to the plain
    # path's PSNR rather than above a black render's.
    exp = "smoke_deterministic_float32"
    last = os.path.join(workdir, "train_ckpts", exp, "last.ckpt")
    resume = det + ["--num_epochs", str(CLI_EPOCHS + 1), "--ckpt_path", last]
    resumed = {}
    for impl, name in (("xla", exp + "_plain"), ("pallas", exp)):
        trainer, counts, wall = run_cli(cli_flags(root, workdir, "float32", name) + resume + ["--mlp_impl", impl])
        hold_dtype(counts, "float32", f"train CLI resumed on mlp_impl={impl}")
        epochs = [e[0] for e in trainer.epoch_log]
        print(f"train CLI resumed from {os.path.basename(last)} on mlp_impl={impl}: epochs {epochs}, step "
              f"{trainer.state.step}, val PSNR {trainer.best_psnr:.4f} (black render {empty:.4f}), {wall:.1f} s, "
              f"launches {counts}")
        if epochs != [CLI_EPOCHS] or trainer.state.step != 5 * (CLI_EPOCHS + 1) or not math.isfinite(trainer.best_psnr):
            raise Failed(f"resume: epochs {epochs}, step {trainer.state.step}, PSNR {trainer.best_psnr}")
        if impl == "xla" and any(counts.values()):
            raise Failed(f"resume on the plain path launched kernels: {counts}")
        resumed[impl] = dict(counts=counts, psnr=trainer.best_psnr, step=trainer.state.step)
        del trainer
        torch.cuda.empty_cache()
    gap = abs(resumed["pallas"]["psnr"] - resumed["xla"]["psnr"])
    print(f"resumed epoch, kernel path vs plain path: val PSNR differs by {gap:.2e} dB (tol {RESUME_PSNR_TOL:.0e})")
    if gap > RESUME_PSNR_TOL:
        raise Failed(f"resumed epoch: kernel path PSNR {resumed['pallas']['psnr']}, plain {resumed['xla']['psnr']}")
    out["resume"] = dict(resumed["pallas"], plain_psnr=resumed["xla"]["psnr"], empty_psnr=empty)

    # the eval CLI renders the best checkpoint of the bf16 deterministic run
    ckpts = sorted(f for f in out["deterministic_bfloat16"]["files"] if f.startswith("epoch_"))
    ckpt = os.path.join(workdir, "train_ckpts", "smoke_deterministic_bfloat16", ckpts[-1])
    w, h = IMG_WH
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        args = port_eval.get_opts([
            "--root_dir", root, "--dataset_name", "llff", "--split", "val", "--scene_name", "smoke_trained",
            "--img_wh", str(w), str(h), "--N_samples", str(N_SAMPLES), "--N_importance", str(N_IMPORTANCE),
            "--ckpt_path", ckpt, "--compute_dtype", "bfloat16", "--device", "cuda",
        ])
        psnr = port_eval.main(args)
    finally:
        os.chdir(cwd)
    print(f"eval CLI on {os.path.basename(ckpt)}: val PSNR {psnr}")
    if psnr is None or not math.isfinite(psnr):
        raise Failed(f"eval of the trained checkpoint: PSNR {psnr}")
    out["eval_psnr"] = psnr
    return out


def phase_x1_checks(device, rng):
    """Each X1 variant's kernel against its plain version and against
    ``pe``, at a tile multiple and at a ragged count; ``pe`` equal to
    production K4-fwd bit for bit."""
    import torch

    from sinnerf_tpu_torch.ops import fused_mlp as fm
    from sinnerf_tpu_torch.scripts import exp_kernel_variants as x1

    packed = fm.pack_weights(make_model(50, device), torch.bfloat16)
    worst = {}
    for n in X1_SMALL:
        xyz = torch.tensor(rng.normal(scale=2.0, size=(n, 3)), dtype=torch.float32, device=device)
        dirs = torch.tensor(rng.normal(size=(n, 3)), dtype=torch.float32, device=device)
        xpe, dpe = x1.encode(xyz, dirs)
        pe = x1.make_variant(True, 1, x1.TILE)(packed, xyz, dirs)
        if not torch.equal(pe, fm.launch_mlp_fwd(packed, xyz, dirs)):
            raise Failed(f"X1 pe at n={n} is not production K4-fwd bf16 bit for bit")
        for name, (in_pe, ilp, tile) in x1.GRID.items():
            a, b = (xyz, dirs) if in_pe else (xpe, dpe)
            got = x1.make_variant(in_pe, ilp, tile)(packed, a, b)
            torch.cuda.synchronize()
            if got.shape != (n, 4) or not bool(got.isfinite().all()):
                raise Failed(f"X1 {name}: shape {tuple(got.shape)} or non-finite values")
            errs = []
            for what, ref in (("plain version", x1.variant_plain(packed, in_pe, a, b)), ("pe", pe)):
                diff = (got - ref).abs()
                errs.append((diff.max().item(), diff.mean().item()))
                hold(f"X1 {name:12s} n={n:5d} vs {what}", errs[-1], K4_FWD_TOL["bfloat16"])
            w = worst.setdefault(name, dict(plain=(0.0, 0.0), pe=(0.0, 0.0), equal_pe=True))
            for key, err in zip(("plain", "pe"), errs):
                w[key] = tuple(map(max, w[key], err))
            w["equal_pe"] &= bool(torch.equal(got, pe))
    return worst


def phase_x1(device):
    """X1's entry point at full size, counts set to 0 just before and read
    just after; then, on the inputs it ran on, each variant held against its
    plain version (timed there) and ``pe`` against production K4-fwd, bit
    for bit."""
    import torch

    from sinnerf_tpu_torch.ops import fused_mlp as fm
    from sinnerf_tpu_torch.scripts import exp_kernel_variants as x1

    i = x1.make_inputs(x1.N_POINTS, 0, device)
    x1.launch_variant.launches.clear()
    res = x1.main(i)
    counts = {name: x1.launch_variant.launches[name] for name in x1.GRID}
    print(f"X1 entry point: launches {counts}")
    for name in x1.GRID:
        r = res[name]
        if "failed" in r or not r["finite"] or counts[name] == 0:
            raise Failed(f"X1 {name} at {x1.N_POINTS} points: {r}, {counts[name]} launches")
        hold(f"X1 {name:12s} at {x1.N_POINTS} points vs pe", (r["max_err_vs_pe"], r["mean_err_vs_pe"]),
             K4_FWD_TOL["bfloat16"])
    if not res["z_merge"]["equal"]:
        raise Failed("X1 z-merge: bitonic_merge_sorted differs from torch.sort")
    plain = {}  # one plain version per input form
    for name, (in_pe, ilp, tile) in x1.GRID.items():
        a, b = i.args(in_pe)
        if in_pe not in plain:
            plain[in_pe] = timed(lambda: x1.variant_plain(i.packed, in_pe, a, b), 1)
            print(f"X1 plain version (in_pe={in_pe}) {plain[in_pe][1]:.1f} ms at {x1.N_POINTS} points")
        got = x1.make_variant(in_pe, ilp, tile)(i.packed, a, b, i.tiles, i.slabs)
        diff = (got - plain[in_pe][0]).abs()
        res[name]["err_vs_plain"] = (diff.max().item(), diff.mean().item())
        hold(f"X1 {name:12s} at {x1.N_POINTS} points vs its plain version", res[name]["err_vs_plain"],
             K4_FWD_TOL["bfloat16"])
        if name == "pe":
            prod = fm.launch_mlp_fwd(i.packed, i.xyz, i.dirs)
            diff = (got - prod).abs()
            res[name]["err_vs_production"] = (diff.max().item(), diff.mean().item())
            if not torch.equal(got, prod):
                raise Failed(f"X1 pe at {x1.N_POINTS} points is not production K4-fwd bf16 bit for bit: "
                             f"{res[name]['err_vs_production']}")
            del prod
        res[name]["plain_ms"] = plain[in_pe][1]
        del got, diff
    del i, plain
    torch.cuda.empty_cache()
    return res, counts


def phase_x2_checks(device):
    """Production K3-fwd bf16, which gives X2 its residuals, and the earlier
    forward against their plain version; each X2
    variant's kernel against its plain version; the exact ones also against
    production K3-bwd bf16 within its run-to-run spread."""
    import torch

    from sinnerf_tpu_torch.ops import fused_render_train as frt
    from sinnerf_tpu_torch.ops.fused_mlp import unpack_grads
    from sinnerf_tpu_torch.scripts import exp_bwd_pipeline as x2

    worst, earlier_worst = {}, (0.0, 0.0)
    for n, s, seed in X2_SMALL:
        i = x2.make_inputs(n, s, seed, device)
        plain_fwd = frt.render_level_train_forward_plain(i.packed, i.rays6, i.z, None, True, False)
        err = k3_fwd_error(frt.launch_train_fwd(i.packed, i.rays6, i.z, None, True, False), plain_fwd, float(i.z.max()))
        hold(f"X2 inputs n={n} S={s}: production K3 bfloat16 fwd (the residuals' source)", err, K3_FWD_TOL["bfloat16"])
        earlier = frt.launch_train_fwd_block64(i.packed, i.rays6, i.z, None, True, False)
        torch.cuda.synchronize()
        err = k3_fwd_error(earlier, plain_fwd, float(i.z.max()))
        hold(f"X2 inputs n={n} S={s}: earlier K3 bfloat16 fwd (wmma)", err, K3_FWD_TOL["bfloat16"])
        earlier_worst = tuple(map(max, earlier_worst, err))
        prod_args = (i.packed, i.rays6, i.z, None, i.weights, i.alphas, i.rgb_s, i.g_rgb, i.g_depth, i.g_w, True, False)
        prod = frt.launch_train_bwd(*prod_args)
        if not bool(prod[0].any()):
            raise Failed(f"X2 inputs at n={n} S={s}: an empty field, every gradient is 0 and nothing is held")
        spread = x2.leaf_errors(frt.launch_train_bwd(*prod_args), prod)
        for variant, rays, streams in x2.parse_spec(x2.ALL_SPEC):
            tag = f"{variant}:{rays}:{streams}"
            got = x2.run_variant(variant, rays, streams, i)
            torch.cuda.synchronize()
            err = grad_errors(unpack_grads(*got), unpack_grads(*x2.variant_plain(variant, i)))
            hold_grads(f"X2 {tag:16s} n={n} S={s} vs its plain version", err, K3_BWD_TOL["bfloat16"])
            w = worst.setdefault(tag, dict(plain=(0.0, 0.0), production=None, spread=(0.0, 0.0)))
            w["plain"] = tuple(map(max, w["plain"], err))
            if variant in x2.EXACT:
                err_p = x2.leaf_errors(got, prod)
                hold_grads(f"X2 {tag:16s} n={n} S={s} vs production K3-bwd (two production runs differ by "
                           f"{spread[0]:.1e}, {spread[1]:.1e})", err_p, x2.EXACT_TOL_SMALL)
                w["production"] = tuple(map(max, w["production"] or (0.0, 0.0), err_p))
                w["spread"] = tuple(map(max, w["spread"], spread))
                w["tolerance"] = x2.EXACT_TOL_SMALL
    return worst, earlier_worst


def phase_x2(device):
    """X2's entry point at full size over every variant, counts set to 0
    just before and read just after; then, on the inputs it ran on, each
    variant held against its plain version (timed there)."""
    import torch

    from sinnerf_tpu_torch.ops.fused_mlp import unpack_grads
    from sinnerf_tpu_torch.scripts import exp_bwd_pipeline as x2

    i = x2.make_inputs(x2.N_RAYS, x2.N_SAMPLES, 0, device)
    x2.launch_variant.launches.clear()
    res = x2.main(["--variants", x2.ALL_SPEC], inputs=i)
    spec = x2.parse_spec(x2.ALL_SPEC)
    tags = [f"{v}:{r}:{st}" for v, r, st in spec]
    counts = {tag: x2.launch_variant.launches[tag] for tag in tags}
    print(f"X2 entry point: launches {counts}")
    for tag in tags:
        r = res[tag]
        if "failed" in r or not r["finite"] or not r.get("exact_ok", True) or counts[tag] == 0:
            raise Failed(f"X2 {tag} at {x2.N_RAYS} x {x2.N_SAMPLES}: {r}, {counts[tag]} launches")
    plain = {}
    for (variant, rays, streams), tag in zip(spec, tags):
        key = "exact" if variant in x2.EXACT else variant  # one plain version serves the exact variants
        if key not in plain:
            plain[key] = timed(lambda: x2.variant_plain(variant, i), 1)
            print(f"X2 {variant:10s} plain version {plain[key][1]:.1f} ms at {x2.N_RAYS} x {x2.N_SAMPLES}")
        got = x2.run_variant(variant, rays, streams, i)
        res[tag]["err_vs_plain"] = grad_errors(unpack_grads(*got), unpack_grads(*plain[key][0]))
        hold_grads(f"X2 {tag:16s} at {x2.N_RAYS} x {x2.N_SAMPLES} vs its plain version", res[tag]["err_vs_plain"],
                   K3_BWD_TOL["bfloat16"])
        res[tag]["plain_ms"] = plain[key][1]
    del i, plain
    torch.cuda.empty_cache()
    return res, counts


# --------------------------------------------------------------------------
# phases 18-22: the Blender and DTU slice (the README's lego and DTU scan4
# recipes), after every earlier phase, each drawing from generators of its
# own
# --------------------------------------------------------------------------


def slice_items(ds, gen, steps):
    """``steps`` items of ``ds`` drawn from ``gen``, and the ms per item
    (host clock around each draw, synchronised)."""
    import torch

    items, ms = [], []
    for step in steps:
        t0 = time.perf_counter()
        items.append(ds.sample(step, 1, gen))
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    return items, ms


def check_item(item, cfg, near_far, what: str) -> None:
    """The batch schema of ``sampler.sample_item`` and its ranges."""
    n_rays, n_proj, patch = cfg.num_rays, cfg.n_proj or cfg.num_rays, cfg.psx * cfg.psy
    shapes = {
        "rays": (1, n_rays, 8), "rgbs": (1, n_rays, 3), "depth": (1, n_rays, 1), "rays_proj": (1, n_proj, 8),
        "depth_proj": (1, n_proj, 1), "real_patch": (1, 3, cfg.psx, cfg.psy), "rays_full": (1, patch, 8),
        "warp_patch": (1, 3, cfg.psx, cfg.psy), "warp_patch_depth": (1, cfg.psx, cfg.psy),
        "depth_ray": (1, patch, 8), "depth_gt": (1, patch, 1), "depth_ray_rgb": (1, patch, 3),
    }
    got = {k: tuple(v.shape) for k, v in item.items()}
    if got != shapes:
        raise Failed(f"{what}: batch shapes {got}, want {shapes}")
    bad = [k for k, v in item.items() if not bool(v.isfinite().all())]
    rgb_keys = ("rgbs", "real_patch", "warp_patch", "depth_ray_rgb")
    bad += [k for k in rgb_keys if not bool(((item[k] >= 0) & (item[k] <= 1)).all())]
    bad += [k for k in ("rays", "rays_proj", "rays_full", "depth_ray")
            if not bool((item[k][..., 6:8] == item[k].new_tensor(near_far)).all())]
    if not bool((item["depth_proj"] > 0).all()):
        bad.append("depth_proj")
    if float(item["real_patch"].amax()) <= 0:
        bad.append("real_patch")
    if cfg.reject_warp_patch and float(item["warp_patch_depth"].sum()) <= 0:
        bad.append("warp_patch_depth")
    if bad:
        raise Failed(f"{what}: out of range or non-finite: {bad}")


def phase_slice_datasets(device, workdir: str):
    """Write the rich lego stand-in at 400x400 (under a directory named
    ``lego``: ref 20, the true mytest val slice) and the rich DTU scan4 at
    640x512; build ``BlenderRot3D``, ``BlenderProj`` and ``DTUProj`` on the
    card with the recipes' flags; sample SLICE_ITEMS items of each (schema,
    ranges, ms per item).  Rot3d's fresh warp reads the card three times per
    item: the same seed gives the same item twice on the card, and the
    draws that need no warp (the random rays and the real patch) equal those
    of the same seed on a scene built on the CPU."""
    import torch

    from sinnerf_tpu_torch.data import dataset_dict
    from sinnerf_tpu_torch.data.synthetic import make_blender_scene_rich, make_dtu_scene_rich

    out = {}
    t0 = time.perf_counter()
    lego = make_blender_scene_rich(os.path.join(workdir, "lego"), LEGO_WH)
    t1 = time.perf_counter()
    dtu = make_dtu_scene_rich(os.path.join(workdir, "dtu_scan4"), DTU_WH)
    t2 = time.perf_counter()
    print(f"scenes: lego {LEGO_WH[0]}x{LEGO_WH[1]} written in {t1 - t0:.1f} s, DTU scan4 {DTU_WH[0]}x{DTU_WH[1]} "
          f"in {t2 - t1:.1f} s")
    out["write_s"] = {"lego": t1 - t0, "dtu": t2 - t1}
    builds = {
        "blender_ray_patch_1image_rot3d": (lego, dict(img_wh=LEGO_WH, **LEGO_DATA)),
        "blender_ray_patch_1image_proj": (lego, dict(img_wh=LEGO_WH, **LEGO_DATA)),
        "dtu_proj": (dtu, dict(img_wh=DTU_WH, **DTU_DATA)),
    }
    for name, (root, kw) in builds.items():
        t0 = time.perf_counter()
        ds = dataset_dict[name](root, split="train", device=device, **kw)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        near_far = ds.scene["near_far"].tolist()
        items, ms = slice_items(ds, torch.Generator().manual_seed(SLICE_SEED), range(SLICE_ITEMS + 1))
        for i, item in enumerate(items):
            check_item(item, ds.cfg, near_far, f"{name} item {i}")
        rays = ds.cfg.num_rays + (ds.cfg.n_proj or ds.cfg.num_rays) + 2 * ds.cfg.psx * ds.cfg.psy
        row = dict(build_s=build_s, item_ms=sum(ms[1:]) / SLICE_ITEMS, first_item_ms=ms[0], len=len(ds),
                   rays_per_step=rays, valid_warped=int(ds.scene["proj_depth"].shape[0]))
        if ds.cfg.fresh_warp:
            again, _ = slice_items(ds, torch.Generator().manual_seed(SLICE_SEED), range(SLICE_ITEMS + 1))
            for a, b in zip(items, again):
                if any(not torch.equal(a[k], b[k]) for k in a):
                    raise Failed(f"{name}: the same seed drew another item on the card")
            host = dataset_dict[name](root, split="train", device=torch.device("cpu"), **kw)
            cpu_items, _ = slice_items(host, torch.Generator().manual_seed(SLICE_SEED), range(SLICE_ITEMS + 1))
            for a, b in zip(items, cpu_items):
                if any(not torch.equal(a[k].cpu(), b[k]) for k in ("rays", "rgbs", "depth", "real_patch")):
                    raise Failed(f"{name}: the card's reads changed a draw (its random rays or real patch differ "
                                 f"from the CPU's on the same seed)")
            row["same_draws"] = True
            del host, cpu_items
        print(f"dataset {name}: built on the card in {build_s:.2f} s, {len(ds)} items per epoch, "
              f"{row['valid_warped']} valid warped pixels, {rays} rays per step; sampler {row['item_ms']:.2f} ms per "
              f"item (first {ms[0]:.2f} ms)" + ("; the same draws twice and as on the CPU" if ds.cfg.fresh_warp else ""))
        out[name] = row
        del ds, items
        torch.cuda.empty_cache()
    return out, lego, dtu


def phase_slice_kernels(device):
    """The shapes the slice gives the kernels, each against its plain
    version in both dtypes with the white background: K3-fwd and K3-bwd at
    the training batches of rot3d (16,384 rays), proj (20,480) and DTU
    (16,032) at S = 64 and, after K2 (64 -> 128 with drawn ``u``), S = 128;
    K1 and K2 (deterministic) at the eval tiles of a 400x400 Blender image
    (131,072 + 28,928 rays) and a 640x512 DTU image (131,072 + 131,072 +
    65,536; 65,536 is new) at S = 64 and 128."""
    import torch

    from sinnerf_tpu_torch.ops.fused_render import fused_render_level, render_level_plain
    from sinnerf_tpu_torch.ops.fused_sample_pdf import fused_sample_pdf_merge, sample_pdf_merge_plain

    rng = np.random.default_rng(SLICE_SEED)
    models = {"coarse": make_model(30, device), "fine": make_model(31, device)}
    s, k = N_SAMPLES, SLICE_N_IMPORTANCE
    out = {"k3": {}, "k2": [], "k1": {}}
    for n in SLICE_TRAIN_RAYS:
        rays, z = make_rays(rng, n, s, device)
        target = torch.tensor(rng.uniform(size=(n, 3)), dtype=torch.float32, device=device)
        noise = [torch.tensor(rng.normal(size=(n, m)), dtype=torch.float32, device=device) for m in (s, s + k)]
        u = torch.tensor(rng.uniform(size=(n, k)), dtype=torch.float32, device=device)
        for cd in ("bfloat16", "float32"):
            zz = z
            for level, nz in zip(("coarse", "fine"), noise):
                m = zz.shape[1]
                what = f"slice K3 {cd:8s} {level:6s} n={n} S={m:3d}"
                res, _, err_f, err_b, spread, ms = k3_check(models[level], rays, zz, nz, target, cd, True, what, reps=2)
                merge_worst(out["k3"], cd, err_f, err_b, spread)
                bounds = {d: k3_bound(n, m, cd, d == "bwd")[0] for d in ("fwd", "bwd")}
                print(f"  fwd {ms['fwd']:.3f} ms (plain {ms['fwd_plain']:.1f}, bound {bounds['fwd']:.3f}); "
                      f"bwd {ms['bwd']:.3f} ms (plain {ms['bwd_plain']:.1f}, bound {bounds['bwd']:.3f})")
                out["k3"][cd].setdefault("launches", []).append(dict(shape=f"{n}x{m}", ms=ms, bounds=bounds))
                if level == "coarse":
                    z_all = fused_sample_pdf_merge(zz, res[2], k, u, False)
                    torch.cuda.synchronize()
                    ref = sample_pdf_merge_plain(zz, res[2], k, u, False)
                    err = k2_error(z_all, ref, f"slice K2 {cd:8s} n={n} {s}+{k} drawn u")
                    _, k2_ms = timed(lambda: fused_sample_pdf_merge(zz, res[2], k, u, False), 20, K2_LEAD_CYCLES)
                    out["k2"].append(dict(shape=f"{n}x{s}+{k}u", ms=k2_ms, err=err, bound_ms=k2_bound(n, s, k, False)))
                    zz = z_all
        torch.cuda.empty_cache()
    for n in SLICE_EVAL_TILES:
        rays, z = make_rays(rng, n, s, device)
        for cd in ("bfloat16", "float32"):
            w = out["k1"].setdefault(cd, dict(err=(0.0, 0.0), launches=[]))
            zz = z
            for level in ("coarse", "fine"):
                m = zz.shape[1]
                got, ms = timed(lambda: fused_render_level(models[level], rays, zz, True, True, cd), 2)
                ref, plain_ms = timed(lambda: in_chunks(
                    lambda rr, z2: render_level_plain(models[level], rr, z2, True, True, cd), n, rays, zz), 1)
                err = k1_error(got, ref)
                bound_ms = k1_bound(n, m, cd)[0]
                hold(f"slice K1 {cd:8s} {level:6s} n={n:6d} S={m:3d} white_back=1 ({ms:.3f} ms, plain "
                     f"{plain_ms:.1f} ms, bound {bound_ms:.3f} ms)", err, K1_TOL[cd])
                w["err"] = tuple(max(a, b) for a, b in zip(w["err"], err))
                w["launches"].append(dict(shape=f"{n}x{m}", ms=ms, plain_ms=plain_ms, bound_ms=bound_ms))
                if level == "coarse":
                    z_all = fused_sample_pdf_merge(zz, got[2], k, None, True)
                    torch.cuda.synchronize()
                    ref2 = in_chunks(lambda z2, w2: sample_pdf_merge_plain(z2, w2, k, None, True), n, zz, got[2])
                    err = k2_error(z_all, ref2, f"slice K2 {cd:8s} n={n} {s}+{k} det")
                    out["k2"].append(dict(shape=f"{n}x{s}+{k}", err=err, bound_ms=k2_bound(n, s, k, True)))
                    zz = z_all
            del got, ref
        torch.cuda.empty_cache()
    return out


def slice_flags(dataset: str, root: str, workdir: str, exp: str):
    """The train CLI's flags of the slice's recipes: Step 1 of the README's
    lego recipe (ViT on, random under --allow_random_pretrained), at 400x400
    for Blender and with DTU's 56x70 patches at 640x512; one epoch each."""
    common = [
        "--root_dir", root, "--dataset_name", dataset, "--N_importance", str(SLICE_N_IMPORTANCE),
        "--num_epochs", "1", "--batch_size", "1", "--num_gpus", "1", "--optimizer", "adam", "--lr", "2e-4",
        "--lr_scheduler", "steplr", "--decay_step", "500", "1000", "--decay_gamma", "0.5", "--with_ref",
        "--proj_weight", "1", "--depth_smooth_weight", "0.5", "--dis_weight", "0", "--load_depth",
        "--depth_type", "nerf", "--model", "sinnerf", "--depth_weight", "8", "--vit_weight", "10",
        "--allow_random_pretrained", "--check_val_every_n_epoch", "1", "--compute_dtype", "bfloat16",
        "--device", "cuda", "--ckpt_dir", os.path.join(workdir, "slice_ckpts"),
        "--log_dir", os.path.join(workdir, "slice_logs"), "--exp_name", exp,
    ]
    if dataset == "dtu_proj":
        return common + ["--img_wh", *map(str, DTU_WH), "--patch_size_x", str(DTU_DATA["patch_size_x"]),
                         "--patch_size_y", str(DTU_DATA["patch_size_y"]), "--sW", "8", "--sH", "8"]
    return common + ["--img_wh", *map(str, LEGO_WH), "--patch_size", "64", "--sW", "6", "--sH", "6"]


def phase_slice_cli(device, workdir: str, lego: str, dtu: str):
    """The train CLI on each training set, bf16: lego Step 1 (one epoch of
    the 125-pose rot3d grid), lego Step 2 from its ``last.ckpt``
    (``--dis_weight 0.01 --pt_model <ck> --nerf_only``, one epoch),
    ``BlenderProj`` (2 epochs of its 60 poses, validated after the last)
    and DTU scan4 (one epoch of its 8 source views).  Per run the launch
    counts (set to 0 just before, read just after), ms per step, and the
    best val PSNR against an empty field's, which renders the background:
    black on DTU, white on Blender (a white render outscores a black one by
    ~5 dB on the lego stand-in).

    Lego Step 1 and 2 keep the README's ``--vit_weight 10``, whose weights
    are random here (``--allow_random_pretrained``: no DINO weights on the
    card).  Those features' loss holds the lego field near an empty one
    (chip runs B and C of this phase; PERF.md), so these two runs must clear
    only a black render (a lit, finite render), and rot3d's run that must
    learn is the demo's (phase 22).  ``BlenderProj`` trains without the ViT
    and DTU with it; both must clear an empty field by EMPTY_MARGIN_DB."""
    import torch

    ckpts = os.path.join(workdir, "slice_ckpts")
    runs = (
        ("lego_step1", False, slice_flags("blender_ray_patch_1image_rot3d", lego, workdir, "lego_step1")),
        ("lego_step2", False, slice_flags("blender_ray_patch_1image_rot3d", lego, workdir, "lego_step2")
         + ["--dis_weight", "0.01", "--pt_model", os.path.join(ckpts, "lego_step1", "last.ckpt"), "--nerf_only"]),
        ("lego_proj", True, slice_flags("blender_ray_patch_1image_proj", lego, workdir, "lego_proj")
         + ["--vit_weight", "0", "--num_epochs", "2", "--check_val_every_n_epoch", "2"]),
        ("dtu_scan4", True, slice_flags("dtu_proj", dtu, workdir, "dtu_scan4")),
    )
    out = {}
    for name, learns, flags in runs:
        trainer, counts, wall = run_cli(flags)
        hold_dtype(counts, "bfloat16", f"train CLI {name}")
        empty, white = empty_render_psnr(trainer.val_dataset), white_render_psnr(trainer.val_dataset)
        steps = sum(e[1] for e in trainer.epoch_log)
        step_ms = 1e3 * sum(e[2] for e in trainer.epoch_log) / steps
        files = sorted(os.listdir(os.path.join(ckpts, name)))
        print(f"train CLI {name}: {steps} steps, {step_ms:.1f} ms per step (host clock over the epochs), {wall:.1f} s "
              f"in all; val PSNR {trainer.val_log} over {trainer.val_dataset.val_len()} images (black render "
              f"{empty:.4f}, white render {white:.4f}); launches {counts}; checkpoints {files}")
        epochs = len(trainer.epoch_log)
        if steps != epochs * len(trainer.train_dataset) or not math.isfinite(trainer.best_psnr):
            raise Failed(f"train CLI {name}: {steps} steps over {epochs} epochs, PSNR {trainer.best_psnr}")
        floor = max(empty, white) if learns else empty
        if trainer.best_psnr < floor + EMPTY_MARGIN_DB:
            raise Failed(f"train CLI {name}: best val PSNR {trainer.best_psnr} is not {EMPTY_MARGIN_DB} dB above "
                         f"{floor} (black render {empty}, white render {white})")
        want = {"K3-fwd": 2 * steps, "K3-bwd": 2 * steps, "K4-fwd": 0, "K4-bwd": 0}
        if any(counts[k] != v for k, v in want.items()) or counts["K1"] == 0 or counts["K2"] < steps:
            raise Failed(f"train CLI {name}: launch counts {counts}, want {want} and K1 > 0, K2 >= {steps}")
        best = [f for f in files if f.startswith("epoch_")]
        if "last.ckpt" not in files or len(best) != 1:
            raise Failed(f"train CLI {name}: checkpoints {files}")
        out[name] = dict(counts=counts, steps=steps, epochs=epochs, step_ms=step_ms, wall_s=wall,
                         psnr=trainer.best_psnr, val_log=trainer.val_log, empty_psnr=empty, white_psnr=white,
                         gate_psnr=floor + EMPTY_MARGIN_DB, val_images=trainer.val_dataset.val_len(),
                         best_ckpt=os.path.join(ckpts, name, best[0]))
        del trainer
        torch.cuda.empty_cache()
    return out


def phase_slice_eval(device, workdir: str, lego: str, dtu: str, cli):
    """The eval CLI on each run's best checkpoint, bf16, with its own
    defaults otherwise (Blender: the ``test`` split, the mytest slice at
    ``--angle 64``; DTU: the reference view and its sources): ms per image,
    PSNR, launches (K1 2 per tile, K2 1).  Then the weights-only tool on lego
    Step 2's checkpoint, and the eval CLI on the stripped file, which must
    give the same mean PSNR."""
    from sinnerf_tpu_torch import eval as port_eval
    from sinnerf_tpu_torch.render.renderer import pick_val_tile
    from sinnerf_tpu_torch.utils.save_weights_only import save_weights_only

    out = {}
    evals = [(name, cli[name]["best_ckpt"]) for name in cli]
    stripped = save_weights_only(cli["lego_step2"]["best_ckpt"], os.path.join(workdir, "lego_step2_weights.ckpt"))
    evals.append(("lego_step2_weights_only", stripped))
    for name, ckpt in evals:
        is_dtu = name.startswith("dtu")
        wh, root = (DTU_WH, dtu) if is_dtu else (LEGO_WH, lego)
        flags = ["--root_dir", root, "--img_wh", *map(str, wh), "--N_importance", str(SLICE_N_IMPORTANCE),
                 "--ckpt_path", ckpt, "--compute_dtype", "bfloat16", "--scene_name", name, "--timestamp", "t"]
        if is_dtu:
            flags += ["--dataset_name", "dtu_proj"]
        cwd = os.getcwd()
        os.chdir(workdir)
        try:
            psnr, counts, wall = counted(lambda: port_eval.main(port_eval.get_opts(flags)))
        finally:
            os.chdir(cwd)
        hold_dtype(counts, "bfloat16", f"eval CLI {name}")
        ds = "dtu_proj" if is_dtu else "blender_ray_patch_1image_rot3d"
        images = len(glob.glob(os.path.join(workdir, "results", ds, name, "t", "*.png")))
        tiles = math.ceil(wh[0] * wh[1] / pick_val_tile(wh[0] * wh[1], 32 * 1024 * 4))
        print(f"eval CLI {name}: {images} images in {wall:.1f} s ({1e3 * wall / max(images, 1):.1f} ms per image "
              f"incl. PNG writes), mean PSNR {psnr}, launches {counts}")
        if psnr is None or not math.isfinite(psnr) or images == 0:
            raise Failed(f"eval CLI {name}: PSNR {psnr}, {images} images")
        if counts["K1"] != 2 * tiles * images or counts["K2"] != tiles * images:
            raise Failed(f"eval CLI {name}: launches {counts}, want K1 {2 * tiles * images}, K2 {tiles * images}")
        out[name] = dict(psnr=psnr, images=images, wall_s=wall, image_ms=1e3 * wall / images, counts=counts)
    gap = abs(out["lego_step2_weights_only"]["psnr"] - out["lego_step2"]["psnr"])
    print(f"weights-only file vs the training checkpoint: mean PSNR differs by {gap:.2e} dB")
    if gap > 0:
        raise Failed(f"the weights-only checkpoint renders another PSNR ({gap} dB off)")
    return out


def phase_demo(device, workdir: str):
    """``sinnerf_tpu_torch.scripts.demo_convergence`` at its defaults (300
    steps at 128x128, 64 + 64 samples, 1024 rays, 32x32 patches), on the
    kernels in bf16, counted: the val PSNR must rise by more than 3 dB and
    clear an empty field's (a black and a white render's of the demo's val
    images, the same scene written here) by EMPTY_MARGIN_DB."""
    from sinnerf_tpu_torch.data import dataset_dict
    from sinnerf_tpu_torch.data.synthetic import make_blender_scene
    from sinnerf_tpu_torch.scripts import demo_convergence

    img = demo_convergence.get_args([]).img
    val = dataset_dict["blender_ray_patch_1image_rot3d"](
        make_blender_scene(os.path.join(workdir, "demo_scene"), (img, img)), split="val", img_wh=(img, img),
        ref_idx=0)
    empty, white = empty_render_psnr(val), white_render_psnr(val)
    try:
        res, counts, wall = counted(lambda: demo_convergence.main([]))
    except AssertionError as e:
        raise Failed(f"demo_convergence: {e}")
    hold_dtype(counts, "bfloat16", "demo_convergence")
    print(f"demo_convergence: val PSNR {res['psnr_before']:.2f} -> {res['psnr_after']:.2f} dB (black render "
          f"{empty:.4f}, white render {white:.4f}), {res['steps_per_s']:.2f} steps/s, {wall:.1f} s in all, "
          f"launches {counts}")
    if counts["K3-fwd"] != 2 * res["steps"] or counts["K3-bwd"] != 2 * res["steps"]:
        raise Failed(f"demo_convergence: launch counts {counts}")
    if res["psnr_after"] < max(empty, white) + EMPTY_MARGIN_DB:
        raise Failed(f"demo_convergence: val PSNR {res['psnr_after']} after training, an empty field scores "
                     f"{max(empty, white)}")
    return dict(res, counts=counts, wall_s=wall, empty_psnr=empty, white_psnr=white)


# --------------------------------------------------------------------------
# phase 23: data parallelism over cards (parallel/ddp.py)
# --------------------------------------------------------------------------


def ddp_plan():
    """(world, backend) of the multi-GPU phase: min(DDP_MAX_WORLD, cards)
    ranks over NCCL with two cards or more, else two ranks on the one card
    over gloo (NCCL refuses two ranks on one device)."""
    import torch

    n = torch.cuda.device_count()
    return (min(DDP_MAX_WORLD, n), "nccl") if n >= 2 else (2, "gloo")


def ddp_step_config(cd: str = "bfloat16"):
    """The lego recipe's step (64 + 64 samples, the white background, its
    depth weights) with STEP2_FIELDS: the ViT at 10, D at 0.01, hinge."""
    import dataclasses

    cfg = step2_config(cd, dataset_name="blender_ray_patch_1image_rot3d")
    return dataclasses.replace(cfg, render=dataclasses.replace(cfg.render, n_importance=SLICE_N_IMPORTANCE))


def ddp_state(device, items: int):
    """``new_step2_state`` with a ViT cache of ``items`` rows: every rank
    and the one-process run build the same weights from the same seeds."""
    import torch

    from sinnerf_tpu_torch.models.vit import EMBED_DIM

    state = new_step2_state(device)
    state.ref_feature = torch.zeros((items, EMBED_DIM), device=device)
    state.ref_feature_valid = torch.zeros((items,), dtype=torch.bool)
    return state


def ddp_draws(step: int, items: int, n_rays: int, device):
    """Step ``step``'s draws over a global batch of ``items`` items and
    ``n_rays`` rays, from generators of their own (on the host, so that
    every rank and the one-process run draw the same): the render's and the
    Step-2 losses'."""
    import torch

    from sinnerf_tpu_torch.train.step import RenderDraws

    g = torch.Generator().manual_seed(DDP_SEED + step)
    s, k = N_SAMPLES, SLICE_N_IMPORTANCE
    render = RenderDraws(*(t.to(device) for t in (
        torch.rand((n_rays, s), generator=g), torch.randn((n_rays, s), generator=g),
        torch.rand((n_rays, k), generator=g), torch.randn((n_rays, s + k), generator=g))))
    return render, make_step2_draws(torch.Generator().manual_seed(DDP_SEED + 1000 + step), items, device)


def state_digest(state) -> str:
    """sha256 of every NeRF and discriminator parameter, D's ``u`` and both
    optimizers' state, bit for bit."""
    import hashlib

    import torch

    h = hashlib.sha256()
    tensors = [p for m in state.models.values() for p in m.parameters()]
    tensors += list(state.discriminator.parameters()) + state.discriminator.u()
    for opt in (state.opt_g, state.opt_d):
        tensors += [t for g in opt.param_groups for p in g["params"] for _, t in sorted(opt.state[p].items())
                    if isinstance(t, torch.Tensor)]
    for t in tensors:
        h.update(t.detach().reshape(-1).contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def ddp_grads(state):
    """(NeRF gradients, discriminator gradients), copied to the host."""
    return ([p.grad.detach().cpu().clone() for m in state.models.values() for p in m.parameters()],
            [p.grad.detach().cpu().clone() for p in state.discriminator.parameters()])


def ddp_rank(rank: int, world: int, path: str, runs, eval_flags, workdir: str):
    """One rank of the phase: (a) DDP_STEPS sharded ``train_step``s, the
    gradients all-reduced, each step and the all-reduce timed (CUDA events);
    (b) the train CLI's runs (``loop.run``, what ``python -m
    sinnerf_tpu_torch.train --num_gpus N`` starts on each card), each
    counted; (c) the eval CLI's rank (``eval.run``) on Step 1's checkpoint,
    counted and timed."""
    import torch

    from sinnerf_tpu_torch import eval as port_eval
    from sinnerf_tpu_torch.opt import get_opts
    from sinnerf_tpu_torch.parallel import ddp
    from sinnerf_tpu_torch.train import loop
    from sinnerf_tpu_torch.train.step import train_step

    tf32_off()
    device = ddp.rank_device("cuda")
    inputs = torch.load(path, weights_only=False)
    items, per_item = inputs["items"], inputs["per_item"]
    batch = ddp.shard_rows({k: v.to(device) for k, v in inputs["batch"].items()}, rank, world)
    rows = ddp.bundle_rows(per_item, rank, world, items)
    mine = slice(rank * items // world, (rank + 1) * items // world)
    state, cfg = ddp_state(device, items // world), ddp_step_config()
    hook, reduce_events, step_events = ddp.gradient_hook(world), [], []

    def timed_hook(optimizers):
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        hook(optimizers)
        ev[1].record()
        reduce_events.append(ev)

    losses, grads = [], None
    for i in range(DDP_STEPS):
        render, step2 = ddp_draws(i, items, sum(per_item) * items, device)
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        state, aux = train_step(state, batch, cfg, 0.0, ddp.shard_draws(render, rows),
                                step2_draws=ddp.shard_draws(step2, mine), grad_hook=timed_hook)
        ev[1].record()
        step_events.append(ev)
        losses.append(aux["metrics"]["train/loss"])
        if i == 0:
            grads = ddp_grads(state)  # the all-reduced gradients: the global batch's
    torch.cuda.synchronize()
    out = dict(rank=rank, losses=[float(v) for v in losses], digest=state_digest(state),
               step_ms=[a.elapsed_time(b) for a, b in step_events], allreduce_ms=[a.elapsed_time(b) for a, b in reduce_events],
               grads=grads if rank == 0 else None, cli={})
    del state, batch, grads
    torch.cuda.empty_cache()

    for name, flags in runs:
        trainer, counts, wall = counted(lambda: loop.run(rank, world, get_opts(flags)))
        steps = sum(e[1] for e in trainer.epoch_log)
        out["cli"][name] = dict(loop.summary(trainer), counts=counts, wall_s=wall, steps=steps,
                                step_ms=1e3 * sum(e[2] for e in trainer.epoch_log) / steps,
                                epochs=len(trainer.epoch_log), len=len(trainer.train_dataset))
        del trainer
        torch.cuda.empty_cache()
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        psnr, counts, wall = counted(lambda: port_eval.run(rank, world, port_eval.get_opts(eval_flags)))
    finally:
        os.chdir(cwd)
    out["eval"] = dict(psnr=psnr, counts=counts, wall_s=wall)
    return out


def set_flag(flags, name: str, *values):
    """``flags`` with ``name``'s values replaced (appended if absent)."""
    flags = list(flags)
    if name in flags:
        i = flags.index(name)
        j = i + 1
        while j < len(flags) and not flags[j].startswith("--"):
            j += 1
        flags[i:j] = [name, *values]
    else:
        flags += [name, *values]
    return flags


def phase_ddp(device, workdir: str, lego: str):
    """Data parallelism on the visible cards (``ddp_plan``), in one launch of
    the ranks.  (a) DDP_STEPS sharded ``train_step``s (bf16, lego rot3d
    batch of ``world`` items, the ViT and D random, hinge) against the same
    steps in this process on the global batch: each step's loss and the
    first step's NeRF and D gradients within STEP_GRAD_TOL, every rank's
    parameters, ``u`` and optimizer state bit-identical after the steps; ms
    per step per rank and the all-reduce's ms.  (b) the README's lego Step 1
    at ``--num_gpus <world> --batch_size 1`` with phase 20's flags, one epoch
    of ceil(125 / world) steps and validation (gate: a black render +
    EMPTY_MARGIN_DB), Step 2 from its checkpoint, and Step 2 resumed for an
    epoch: ms per step, launches per rank per kernel, val PSNR.  (c) the
    eval CLI's ranks on Step 1's checkpoint beside the eval CLI on one card:
    mean PSNR within DDP_EVAL_PSNR_TOL dB, every PNG within one level, ms per
    image.  With two cards or more, one K3 forward and backward on the
    second card from this process, whose current card is the first."""
    import torch

    from sinnerf_tpu_torch import eval as port_eval
    from sinnerf_tpu_torch.data import dataset_dict
    from sinnerf_tpu_torch.parallel import ddp
    from sinnerf_tpu_torch.train.step import train_step

    world, backend = ddp_plan()
    how = f"NCCL across {world} cards" if backend == "nccl" else "gloo, two ranks on one card"
    print(f"multi-GPU phase: {world} ranks, {how}")
    t0 = time.perf_counter()
    rot3d = "blender_ray_patch_1image_rot3d"
    ds = dataset_dict[rot3d](lego, split="train", device=device, img_wh=LEGO_WH, **LEGO_DATA)
    batch = ds.sample(0, world, torch.Generator().manual_seed(DDP_SEED))
    per_item = [batch[k].shape[1] for k in ("rays", "depth_ray", "rays_full", "rays_proj")]
    path = os.path.join(workdir, "ddp_inputs.pt")
    torch.save(dict(batch={k: v.cpu() for k, v in batch.items()}, items=world, per_item=per_item), path)
    empty = empty_render_psnr(dataset_dict[rot3d](lego, split="val", img_wh=LEGO_WH, **LEGO_DATA))
    del ds

    ck = os.path.join(workdir, "ddp_ckpts")
    step1 = set_flag(set_flag(slice_flags(rot3d, lego, workdir, "ddp_step1"), "--num_gpus", str(world)),
                     "--ckpt_dir", ck)
    step2 = set_flag(set_flag(step1, "--exp_name", "ddp_step2"), "--dis_weight", "0.01") + [
        "--pt_model", os.path.join(ck, "ddp_step1", "last.ckpt"), "--nerf_only"]
    resumed = set_flag(set_flag(step2, "--num_epochs", "2"), "--ckpt_path", os.path.join(ck, "ddp_step2", "last.ckpt"))
    runs = (("step1", step1), ("step2", step2), ("step2_resumed", resumed))
    eval_flags = ["--root_dir", lego, "--img_wh", *map(str, LEGO_WH), "--N_importance", str(SLICE_N_IMPORTANCE),
                  "--ckpt_path", os.path.join(ck, "ddp_step1", "last.ckpt"), "--compute_dtype", "bfloat16",
                  "--scene_name", "ddp", "--timestamp", f"n{world}", "--num_gpus", str(world)]
    t_launch = time.perf_counter()
    ranks = ddp.launch(ddp_rank, world, "cuda", path, runs, eval_flags, workdir, backend=backend)
    launch_s = time.perf_counter() - t_launch
    out = dict(world=world, backend=backend, launch_s=launch_s)

    # (a) the same steps in this process on the global batch
    tol = STEP_GRAD_TOL["bfloat16"]
    state, cfg = ddp_state(device, world), ddp_step_config()
    batch = {k: v.to(device) for k, v in batch.items()}
    losses, grads = [], None
    for i in range(DDP_STEPS):
        render, step2_draws = ddp_draws(i, world, sum(per_item) * world, device)
        state, aux = train_step(state, batch, cfg, 0.0, render, step2_draws=step2_draws)
        losses.append(float(aux["metrics"]["train/loss"]))
        if i == 0:
            grads = ddp_grads(state)
    del state, batch
    torch.cuda.empty_cache()
    sharded = [sum(r["losses"][i] for r in ranks) / world for i in range(DDP_STEPS)]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(sharded, losses))
    for r in ranks:
        print(f"sharded train_step rank {r['rank']}: losses {[round(v, 4) for v in r['losses']]}, ms per step "
              f"{[round(v, 2) for v in r['step_ms']]}, all-reduce ms {[round(v, 3) for v in r['allreduce_ms']]}")
    print(f"sharded train_step vs one process on the global batch of {world} items: losses {sharded} vs {losses} "
          f"(worst relative difference {loss_err:.3e}, tol {tol[0]:.0e})")
    if not loss_err <= tol[0] or not all(math.isfinite(v) for v in sharded):
        raise Failed("the sharded train_step's losses leave the one-process step's")
    err_g, err_d = grad_errors(ranks[0]["grads"][0], grads[0]), grad_errors(ranks[0]["grads"][1], grads[1])
    hold_grads("sharded train_step's first all-reduced NeRF gradients vs one process", err_g, tol)
    hold_grads("sharded train_step's first all-reduced discriminator gradients vs one process", err_d, tol)
    digests = {r["digest"] for r in ranks}
    print(f"after {DDP_STEPS} steps the ranks' parameters, u and optimizer state hash to {len(digests)} value(s)")
    if len(digests) != 1:
        raise Failed("the ranks' states differ after the sharded steps")
    out["step"] = dict(losses=sharded, one_process_losses=losses, loss_err=loss_err, grad_err=err_g, d_grad_err=err_d,
                       step_ms={r["rank"]: r["step_ms"] for r in ranks},
                       allreduce_ms={r["rank"]: r["allreduce_ms"] for r in ranks})

    # (b) the train CLI's runs
    spe = math.ceil(ranks[0]["cli"]["step1"]["len"] / world)
    out["cli"] = {}
    for name, _ in runs:
        per = [r["cli"][name] for r in ranks]
        for r in per:
            hold_dtype(r["counts"], "bfloat16", f"multi-GPU train CLI {name} rank {r['rank']}")
        want = {"K3-fwd": 2 * spe, "K3-bwd": 2 * spe, "K4-fwd": 0, "K4-bwd": 0}
        bad = [r["counts"] for r in per if any(r["counts"][k] != v for k, v in want.items())
               or r["counts"]["K1"] == 0 or r["counts"]["K2"] < spe]
        psnrs = {r["best_psnr"] for r in per}
        print(f"multi-GPU train CLI {name}: {per[0]['steps']} steps per rank ({per[0]['epochs']} epoch), ms per step "
              f"by rank {[round(r['step_ms'], 1) for r in per]}, val PSNR {per[0]['val_log']} (black render "
              f"{empty:.4f}); launches by rank {[r['counts'] for r in per]}")
        if bad or any(r["steps"] != spe or r["steps_per_epoch"] != spe for r in per) or len(psnrs) != 1:
            raise Failed(f"multi-GPU train CLI {name}: steps {[r['steps'] for r in per]} (want {spe}), launches "
                         f"{bad} (want {want}), best PSNR by rank {psnrs}")
        if not math.isfinite(per[0]["best_psnr"]):
            raise Failed(f"multi-GPU train CLI {name}: best val PSNR {per[0]['best_psnr']}")
        out["cli"][name] = dict(steps=spe, step_ms={r["rank"]: r["step_ms"] for r in per},
                                counts={r["rank"]: r["counts"] for r in per}, psnr=per[0]["best_psnr"],
                                val_log=per[0]["val_log"], wall_s=max(r["wall_s"] for r in per))
    step1_psnr = out["cli"]["step1"]["psnr"]
    if step1_psnr < empty + EMPTY_MARGIN_DB:
        raise Failed(f"multi-GPU lego Step 1: best val PSNR {step1_psnr} is not {EMPTY_MARGIN_DB} dB above a black "
                     f"render's {empty}")
    out["cli"]["empty_psnr"] = empty

    # (c) the eval CLI on one card beside its ranks
    one_flags = set_flag(set_flag(eval_flags, "--num_gpus", "1"), "--timestamp", "n1")
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        psnr1, counts1, wall1 = counted(lambda: port_eval.main(port_eval.get_opts(one_flags)))
    finally:
        os.chdir(cwd)
    from PIL import Image

    res = os.path.join(workdir, "results", rot3d, "ddp")
    names = sorted(f for f in os.listdir(os.path.join(res, "n1")) if f.endswith(".png"))
    worst = 0
    for f in names:
        a, b = (np.asarray(Image.open(os.path.join(res, d, f)), dtype=np.int16) for d in ("n1", f"n{world}"))
        worst = max(worst, int(np.abs(a - b).max()))
    gap = abs(ranks[0]["eval"]["psnr"] - psnr1)
    ms = {1: 1e3 * wall1 / len(names), world: 1e3 * max(r["eval"]["wall_s"] for r in ranks) / len(names)}
    print(f"eval CLI on {world} ranks vs one card: mean PSNR {ranks[0]['eval']['psnr']} vs {psnr1} (differ by "
          f"{gap:.2e} dB, tol {DDP_EVAL_PSNR_TOL}), {len(names)} PNGs differ by at most {worst} level(s); ms per "
          f"image {ms[world]:.1f} on {world} ranks, {ms[1]:.1f} on one card; launches by rank "
          f"{[r['eval']['counts'] for r in ranks]}")
    if not names or gap > DDP_EVAL_PSNR_TOL or worst > 1:
        raise Failed(f"the sharded eval CLI leaves the one-card eval CLI: {gap} dB, {worst} levels, {len(names)} PNGs")
    out["eval"] = dict(psnr=ranks[0]["eval"]["psnr"], one_card_psnr=psnr1, psnr_gap=gap, png_levels=worst,
                       images=len(names), image_ms=ms[world], one_card_image_ms=ms[1],
                       counts={r["rank"]: r["eval"]["counts"] for r in ranks}, one_card_counts=counts1)

    if torch.cuda.device_count() >= 2:
        out["second_card"] = ddp_second_card()
    out["seconds"] = time.perf_counter() - t0
    print(f"multi-GPU phase ({how}): {out['seconds']:.1f} s, the ranks' launch {launch_s:.1f} s")
    return out


def ddp_second_card():
    """One K3 forward and backward (bf16, 16,384 rays x 64) on tensors on the
    second card, from this process, whose current card is the first: the
    wrapper launches on its tensors' card (against the plain version)."""
    import torch

    second = torch.device("cuda", 1)
    rng = np.random.default_rng(DDP_SEED)
    rays, z = make_rays(rng, SLICE_TRAIN_RAYS[0], N_SAMPLES, second)
    noise = torch.tensor(rng.normal(size=z.shape), dtype=torch.float32, device=second)
    target = torch.tensor(rng.uniform(size=(z.shape[0], 3)), dtype=torch.float32, device=second)
    current = torch.cuda.current_device()
    _, _, err_f, err_b, _, _ = k3_check(make_model(30, second), rays, z, noise, target, "bfloat16", True,
                                        f"K3 bf16 on cuda:1 from a process on cuda:{current}")
    return dict(current=current, fwd_err=err_f, bwd_err=err_b)


def sass_counts():
    """Per kernel of SASS_KERNELS, from its built library: the count of the
    SASS instructions that show the design (``cuobjdump -sass``): HGMMA
    (wgmma), UBLKCP and UTMALDG (bulk and tensor copies into shared memory),
    vector reductions (RED ... x4 or .128), FFMA, LDS.128, 128-bit global
    loads and stores, and all of them; and what ``-Xptxas -v`` reported
    (registers, stack, spills).  Fails if a kernel lacks what SASS_KERNELS
    says it must hold."""
    import re

    from sinnerf_tpu_torch.ops import _build

    counts, usage, libs = {}, {}, {}
    for name, (source, tag, needs) in SASS_KERNELS.items():
        lib = _build.lib_path(source)
        if source not in libs:
            libs[source] = (_build.sass_opcodes(lib), _build.ptxas_usage(lib.with_suffix(".log")))
        sass, ptxas = libs[source]
        mangled = [m for m in sass if tag in m]
        if len(mangled) != 1:
            raise Failed(f"{name}: {len(mangled)} kernels named *{tag}* in {source}")
        ops = sass[mangled[0]]

        def n(pred):
            return sum(v for k, v in ops.items() if pred(k))

        c = dict(HGMMA=n(lambda k: k.startswith("HGMMA")), UBLKCP=n(lambda k: k.startswith("UBLKCP")),
                 MULTICAST=n(lambda k: k.startswith(("UBLKCP", "UTMALDG")) and "MULTICAST" in k),
                 UTMALDG=n(lambda k: k.startswith("UTMALDG")),
                 RED_V4=n(lambda k: re.match(r"REDG?\.\S*(x4|\.128)", k) is not None),
                 FFMA=n(lambda k: k.startswith("FFMA")), LDS_128=n(lambda k: k.startswith("LDS.128")),
                 LDG_128=n(lambda k: k.startswith("LDG") and ".128" in k),
                 STG_128=n(lambda k: k.startswith("STG") and ".128" in k), total=sum(ops.values()))
        counts[name], usage[name] = c, ptxas.get(mangled[0], {})
        print(f"SASS {name}: {c}; ptxas {usage[name]}")
        have = dict(c, BULK=c["UBLKCP"] + c["UTMALDG"],
                    NO_SPILLS=int(usage[name].get("spill_stores", 1) == 0 == usage[name].get("spill_loads", 1)))
        if any(have[x] == 0 for x in needs):
            raise Failed(f"{name}: its SASS lacks one of {needs} (NO_SPILLS: no spill stores or loads): "
                         f"{c}, ptxas {usage[name]}")
    return counts, usage


def slice_launches(name: str, cd: str, cli, ev, demo, ddp_out):
    """A kernel's launches on the Blender and DTU slice and on the multi-GPU
    phase for the ``kernels`` line, as its wrapper counted those of dtype
    ``cd`` (K2: all of them): in each train CLI run, each eval CLI run and
    the demo; per rank in each multi-GPU run and in the sharded eval."""
    key = f"{name}[{cd}]" if f"{name}[{cd}]" in demo["counts"] else name
    return dict(
        slice_cli_launches={run: r["counts"][key] for run, r in cli.items()},
        slice_eval_launches={run: r["counts"][key] for run, r in ev.items()},
        slice_demo_launches=demo["counts"][key],
        ddp_cli_launches={run: {rank: c[key] for rank, c in r["counts"].items()}
                          for run, r in ddp_out["cli"].items() if run != "empty_psnr"},
        ddp_eval_launches={rank: c[key] for rank, c in ddp_out["eval"]["counts"].items()},
    )


def mean_of(rows, key: str) -> float:
    return sum(r[key] for r in rows) / len(rows)


def x_kernel_entries(x1_err, x1_res, x1_counts, x2_err, x2_res, x2_counts, sass, ptxas):
    """The ``kernels`` line's X1 and X2 entries, one per variant, from
    phases 12-13 (and phase 1's SASS counts): errors, times, bound share, the
    ratio to ``pe`` or ``base`` and to the earlier ``wmma`` port (mean and
    range over the rounds), SASS counts and launches."""
    kernels = []
    for name, r in ((n, x1_res[n]) for n in x1_err):
        e = x1_err[name]
        kernels.append(dict(
            name=f"exp_kernel_variants[{name}]", route="cuda",
            source="sinnerf_tpu_torch/csrc/exp_kernel_variants_sm90.cu",
            body="sinnerf_tpu_torch/csrc/" + ("k4_fwd_sm90.cuh + mlp_wgmma.cuh" if name == "pe"
                                              else "exp_kernel_variants_sm90.cu + mlp_wgmma.cuh"),
            replaces="scripts/exp_kernel_variants.py:79", launches=x1_counts[name],
            max_abs_err=max(e["plain"][0], r["err_vs_plain"][0]), mean_abs_err=max(e["plain"][1], r["err_vs_plain"][1]),
            tolerance=K4_FWD_TOL["bfloat16"], err_vs_plain_full=r["err_vs_plain"], err_vs_pe=e["pe"],
            equal_to_pe=e["equal_pe"], err_vs_pe_full=[r["max_err_vs_pe"], r["mean_err_vs_pe"]],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by="operations", library_ms=None,
            tflops=r["tflops"], bound_share=r["bound_share"], vs_pe=r["vs_pe"], vs_production=r["vs_production"],
            vs_production_range=r["vs_production_range"], production_ms=x1_res["production"]["ms"],
            earlier_source="sinnerf_tpu_torch/csrc/exp_kernel_variants.cu", earlier=r["earlier"],
            earlier_ms=r["earlier_ms"], vs_earlier=r["vs_earlier"], sass=sass[f"x1[{name}]"],
            ptxas=ptxas[f"x1[{name}]"],
        ))
        if "err_vs_production" in r:
            kernels[-1].update(err_vs_production_k4_full=r["err_vs_production"])
    for tag, r in ((t, x2_res[t]) for t in x2_err):
        e = x2_err[tag]
        entry = dict(
            name=f"exp_bwd_pipeline[{tag}]", route="cuda", source="sinnerf_tpu_torch/csrc/exp_bwd_pipeline_sm90.cu",
            body="sinnerf_tpu_torch/csrc/" + ("exp_bwd_pipeline_sm90.cu (two_stream_sm90)" if tag.startswith("two")
                                              else "mlp_backward_wgmma.cuh (train_bwd_sm90)") + " + mlp_wgmma.cuh",
            replaces="scripts/exp_bwd_pipeline.py:73", launches=x2_counts[tag],
            max_abs_err=max(e["plain"][0], r["err_vs_plain"][0]),
            rel_l2_err=max(e["plain"][1], r["err_vs_plain"][1]), err_vs_plain_full=r["err_vs_plain"],
            tolerance=K3_BWD_TOL["bfloat16"], ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by="operations", library_ms=None, bound_share=r["bound_share"], vs_production=r["vs_production"],
            vs_base=r["vs_base"], vs_base_range=r["vs_base_range"], production_ms=x2_res["production"]["ms"],
            production_vs_base_range=x2_res["production"]["vs_base_range"],
            earlier_source="sinnerf_tpu_torch/csrc/exp_bwd_pipeline.cu", earlier=r["earlier"],
            earlier_ms=r["earlier_ms"], vs_earlier=r["vs_earlier"], sass=sass[f"x2[{tag}]"],
            ptxas=ptxas[f"x2[{tag}]"],
        )
        if e["production"] is not None:
            entry.update(err_vs_production=e["production"], err_vs_production_full=r["err_vs_production"],
                         production_run_to_run=e["spread"], production_tolerance=e["tolerance"],
                         production_tolerance_full=r["exact_tol"])
        kernels.append(entry)
    return kernels


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description="Smoke run of the port on the visible cards.")
    parser.add_argument("--phases", choices=("all", "ddp"), default="all",
                        help="ddp: the card, the build and the multi-GPU phase alone")
    phases = parser.parse_args(argv).phases
    if not os.path.isdir(os.path.join(ROOT, "sinnerf_tpu_torch")):
        print("chip_smoke: the sinnerf_tpu_torch package is not beside this script", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from sinnerf_tpu_torch.ops import _build

    tf32_off()
    device = torch.device("cuda")
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    try:
        print(f"build: {_build.build():.1f} s")
        for log in sorted(glob.glob(str(_build.BUILD_DIR / "*.log"))):
            with open(log) as f:
                usage = [ln.strip() for ln in f if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
            print(os.path.basename(log), *usage, sep="\n  ")
        if phases == "ddp":
            with tempfile.TemporaryDirectory() as workdir:
                from sinnerf_tpu_torch.data.synthetic import make_blender_scene_rich

                ddp_out = phase_ddp(device, workdir, make_blender_scene_rich(os.path.join(workdir, "lego"), LEGO_WH))
            print(json.dumps({"ddp": ddp_out, "card": card}))
            print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                                     "count": torch.cuda.device_count()}}))
            return 0
        sass, ptxas = sass_counts()
        rng = np.random.default_rng(0)
        k1_err = phase_k1_checks(device, rng)
        k2_err = phase_k2_checks(device, rng)
        splits = (("bfloat16", ("val", "test")), ("float32", ("val", "test")))
        with tempfile.TemporaryDirectory() as workdir:
            root, ckpt = make_scene(workdir)
            path = phase_path(device, root, ckpt)
            ev = phase_eval(device, workdir, root, ckpt, splits)
            k3_err = phase_k3_checks(device, rng)
            batch = make_train_batch(rng, device)
            draws = make_draws(rng, 4 * TRAIN_RAYS, device)
            tpath = phase_train_path(device, rng, batch, draws)
            train = phase_train(device, batch, draws)
            k4_err = phase_k4_checks(device, rng)
            det = phase_det_train(device, rng, batch)
            cli = phase_train_cli(device, workdir, root)
        x1_err = phase_x1_checks(device, rng)
        x1_res, x1_counts = phase_x1(device)
        x2_err, x2_earlier_fwd_err = phase_x2_checks(device)
        x2_res, x2_counts = phase_x2(device)
        profile = phase_profile(device, batch, draws)
        step2 = phase_step2(device, batch, draws)
        step2_profile = phase_step2_profile(device, batch, draws)
        step2_cli = phase_step2_cli(device)
        t_slice = time.perf_counter()
        with tempfile.TemporaryDirectory() as workdir:
            slice_data, lego, dtu = phase_slice_datasets(device, workdir)
            slice_k = phase_slice_kernels(device)
            slice_cli = phase_slice_cli(device, workdir, lego, dtu)
            slice_ev = phase_slice_eval(device, workdir, lego, dtu, slice_cli)
            demo = phase_demo(device, workdir)
            slice_s = time.perf_counter() - t_slice
            print(f"phases 18-22 (the Blender and DTU slice): {slice_s:.1f} s")
            ddp_out = phase_ddp(device, workdir, lego)
    except Failed as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1

    kernels = []
    for cd in ("bfloat16", "float32"):
        p = path["k1"][cd]
        launches, rounds = p["launches"], p["rounds"]
        kernels.append(dict(
            name=f"fused_render_level[{cd}]", route="cuda",
            source="sinnerf_tpu_torch/csrc/fused_render_sm90.cu",
            body="sinnerf_tpu_torch/csrc/" + ("render_level_sm90.cuh + mlp_wgmma.cuh" if cd == "bfloat16"
                                              else "mlp_f32_sm90.cuh"),
            replaces="sinnerf_tpu/ops/fused_render_t.py:61",
            launches=ev["launches"][cd][0],
            max_abs_err=max(k1_err[cd][0], p["err"][0]), mean_abs_err=max(k1_err[cd][1], p["err"][1]),
            tolerance=K1_TOL[cd],
            ms=mean_of(launches, "ms"), plain_ms=mean_of(launches, "plain_ms"),
            bound_ms=mean_of(launches, "bound_ms"), bound_by=launches[0]["bound_by"], library_ms=None,
            per_launch={x["shape"]: [x["ms"], x["plain_ms"], x["bound_ms"]] for x in launches},
            image_ms=path["image"][cd]["ms"], image_err=path["image"][cd]["err"], images=ev["launches"][cd][2],
            # the earlier kernel (fused_render.cu) timed beside it in alternating rounds at the first tile's shapes
            earlier_source="sinnerf_tpu_torch/csrc/fused_render.cu",
            earlier_ms=mean_of(list(rounds.values()), "earlier_ms"), rounds_ms=mean_of(list(rounds.values()), "new_ms"),
            vs_earlier={k: v["ratio"] for k, v in rounds.items()}, rounds=K1_ROUNDS[cd][0],
            earlier_err=tuple(map(max, *(v["earlier_err"] for v in rounds.values()))),
            sass=sass[f"k1_sm90[{cd}]"], ptxas=ptxas[f"k1_sm90[{cd}]"],
            # the Blender and DTU slice: its eval tiles with the white background, and its runs' launches
            slice_per_launch={x["shape"]: [x["ms"], x["plain_ms"], x["bound_ms"]]
                              for x in slice_k["k1"][cd]["launches"]},
            **slice_launches("K1", cd, slice_cli, slice_ev, demo, ddp_out),
        ))
        kernels[-1]["max_abs_err"] = max(kernels[-1]["max_abs_err"], slice_k["k1"][cd]["err"][0])
        kernels[-1]["mean_abs_err"] = max(kernels[-1]["mean_abs_err"], slice_k["k1"][cd]["err"][1])
    for cd in ("bfloat16", "float32"):
        p, t = tpath["k3"][cd], train[cd]
        for i, (d, line, tol) in enumerate((("fwd", 86, K3_FWD_TOL[cd]), ("bwd", 164, K3_BWD_TOL[cd]))):
            err = tuple(max(a, b, c) for a, b, c in zip(k3_err[cd][d], p[d], slice_k["k3"][cd][d]))
            rows = [dict(ms=x["ms"][d], plain_ms=x["ms"][d + "_plain"], bound_ms=x["bounds"][d][0]) for x in p["launches"]]
            bf16 = cd == "bfloat16"
            entry = dict(
                name=f"fused_render_level_train_{d}[{cd}]", route="cuda",
                source="sinnerf_tpu_torch/csrc/" + ("fused_render_train_sm90.cu" if bf16 else "f32_train_sm90.cu"),
                body="sinnerf_tpu_torch/csrc/" + {("fwd", True): "render_level_sm90.cuh + mlp_wgmma.cuh",
                                                  ("bwd", True): "mlp_backward_wgmma.cuh + mlp_wgmma.cuh",
                                                  ("fwd", False): "render_f32_sm90.cuh + mlp_f32_sm90.cuh",
                                                  ("bwd", False): "mlp_backward_f32_sm90.cuh + mlp_f32_sm90.cuh"}[d, bf16],
                replaces=f"sinnerf_tpu/ops/fused_render_train_t.py:{line}",
                launches=t["counts"][i], max_abs_err=err[0], tolerance=tol,
                ms=mean_of(rows, "ms"), plain_ms=mean_of(rows, "plain_ms"), bound_ms=mean_of(rows, "bound_ms"),
                bound_by=p["launches"][0]["bounds"][d][1], library_ms=None,
                per_launch={x["shape"]: [r["ms"], r["plain_ms"], r["bound_ms"]] for x, r in zip(p["launches"], rows)},
                step_ms=t["step_ms"], steps=TRAIN_STEPS,
                # the Step-2 path (phase 15): its launches over STEP2_STEPS steps and its step
                step2_launches=step2[cd]["counts"][i], step2_step_ms=step2[cd]["step_ms"],
                step2_cli_launches=step2_cli["step2"]["counts"][f"K3-{d}[{cd}]"],
                slice_per_launch={x["shape"]: [x["ms"][d], x["ms"][d + "_plain"], x["bounds"][d]]
                                  for x in slice_k["k3"][cd]["launches"]},
                **slice_launches(f"K3-{d}", cd, slice_cli, slice_ev, demo, ddp_out),
            )
            if d == "fwd":
                entry.update(mean_abs_err=err[1])
            else:  # max_abs_err is the worst leaf's largest difference over its largest entry
                entry.update(rel_l2_err=err[1], run_to_run=max(k3_err[cd]["spread"], p["spread"]),
                             step_grad_err=t["grad_err"], step_grad_tolerance=STEP_GRAD_TOL[cd], losses=t["losses"])
            # the Hopper kernels: the earlier ones timed beside them in alternating rounds
            x = p["launches"]
            sass_key = f"train_{d}_sm90" if bf16 else f"k3_f32_{d}"
            entry.update(
                earlier_ms=mean_of([r["rounds_ms"] for r in x], f"{d}_earlier"),
                rounds_ms=mean_of([r["rounds_ms"] for r in x], d),
                earlier_source="sinnerf_tpu_torch/csrc/" + ("exp_bwd_pipeline.cu (X2's earlier base)" if bf16 and d == "bwd"
                                                           else "fused_render_train.cu"),
                vs_earlier={r["shape"]: r["ratios"][f"{d}/{d}_earlier"] for r in x},
                rounds=K3_ROUNDS[cd][0], sass=sass[sass_key], ptxas=ptxas[sass_key],
            )
            if d == "fwd":  # the earlier forward against its plain version, path (and X2) inputs
                entry.update(earlier_err=tuple(map(max, *([x2_earlier_fwd_err] if bf16 else []),
                                                   *(r["earlier_fwd_err"] for r in x))))
            if d == "bwd":
                entry.update(ablation_ms={r["shape"]: {k[len("bwd_no_"):]: v for k, v in r["rounds_ms"].items()
                                                       if k.startswith("bwd_no_")} for r in x},
                             ablation_vs_bwd={r["shape"]: {k[len("bwd_no_"):].split("/")[0]: v
                                                           for k, v in r["ratios"].items()
                                                           if k.startswith("bwd_no_")} for r in x})
                if bf16:
                    entry.update(step_profile=profile)
            kernels.append(entry)
    for cd in ("bfloat16", "float32"):
        p, t = det["k4"][cd], det["step"][cd]
        counts = cli[f"deterministic_{cd}"]["counts"]
        for d, line, tol in (("fwd", 232, K4_FWD_TOL[cd]), ("bwd", 298, K4_BWD_TOL)):
            # the short tails' forward errors are held to the same limit
            err = tuple(map(max, k4_err[cd][d], p[d], *([k4_err[f"{cd}_short"][d]] if d == "fwd" else [])))
            rows = [dict(ms=x["ms"][d], plain_ms=x["ms"][d + "_plain"], bound_ms=x["bounds"][d][0]) for x in p["launches"]]
            # (source, body, SASS key) per kernel: every K4 kernel runs on Hopper
            source, body, sass_key = {
                ("fwd", "bfloat16"): ("fused_mlp_sm90.cu", "mlp_wgmma.cuh", "k4_fwd_sm90"),
                ("fwd", "float32"): ("f32_train_sm90.cu", "mlp_f32_sm90.cuh", "k4_f32_fwd"),
                ("bwd", "bfloat16"): ("fused_mlp_sm90.cu", "mlp_backward_wgmma.cuh + mlp_wgmma.cuh", "k4_bwd_sm90"),
                ("bwd", "float32"): ("f32_train_sm90.cu", "mlp_backward_f32_sm90.cuh + mlp_f32_sm90.cuh", "k4_f32_bwd"),
            }[d, cd]
            entry = dict(
                name=f"fused_nerf_mlp_{d}[{cd}]", route="cuda", source="sinnerf_tpu_torch/csrc/" + source,
                body="sinnerf_tpu_torch/csrc/" + body, replaces=f"sinnerf_tpu/ops/fused_mlp_t.py:{line}",
                launches=counts[f"K4-{d}[{cd}]"], max_abs_err=err[0], tolerance=tol,
                ms=mean_of(rows, "ms"), plain_ms=mean_of(rows, "plain_ms"), bound_ms=mean_of(rows, "bound_ms"),
                bound_by=p["launches"][0]["bounds"][d][1], library_ms=None,
                per_launch={x["shape"]: [r["ms"], r["plain_ms"], r["bound_ms"]] for x, r in zip(p["launches"], rows)},
                det_step_ms=t["step_ms"], det_step_launches=t["counts"][2 if d == "fwd" else 3],
                cli_step_ms=cli[f"deterministic_{cd}"]["step_ms"], cli_steps=cli[f"deterministic_{cd}"]["steps"],
            )
            if d == "fwd":
                entry.update(mean_abs_err=err[1])
            else:  # max_abs_err is the worst parameter leaf's largest difference over its largest entry
                entry.update(rel_l2_err=err[1], run_to_run=max(k4_err[cd]["spread"], p["spread"]),
                             short_tail_err=k4_err[f"{cd}_short"]["bwd"], short_tail_tolerance=K4_BWD_TOL_SHORT,
                             step_grad_err=t["grad_err"], step_grad_tolerance=STEP_GRAD_TOL[cd], losses=t["losses"])
            x = p["launches"]
            # the earlier kernel (fused_mlp.cu) timed beside it in alternating rounds
            entry.update(earlier_source="sinnerf_tpu_torch/csrc/fused_mlp.cu",
                         earlier_ms=mean_of([r["rounds_ms"] for r in x], f"{d}_earlier"),
                         rounds_ms=mean_of([r["rounds_ms"] for r in x], d),
                         vs_earlier={r["shape"]: r["ratios"][f"{d}/{d}_earlier"] for r in x},
                         rounds=K4_ROUNDS[cd][0],
                         earlier_err=tuple(map(max, *(r["earlier_err"][f"{d}_earlier"] for r in x))),
                         sass=sass[sass_key], ptxas=ptxas[sass_key])
            if d == "fwd":  # the sigma-only pass, on the same points
                sigma_key = f"{sass_key}_sigma"
                entry.update(sigma_only_ms=mean_of([r["rounds_ms"] for r in x], "fwd_sigma"),
                             sigma_only_vs_full={r["shape"]: r["ratios"]["fwd_sigma/fwd"] for r in x},
                             sigma_only_err=tuple(map(max, *(r["earlier_err"]["fwd_sigma"] for r in x))),
                             sigma_only_sass=sass[sigma_key], sigma_only_ptxas=ptxas[sigma_key])
            if (d, cd) == ("bwd", "bfloat16"):  # without its dW flush, in the same rounds
                entry.update(ablation_ms={r["shape"]: {"flush": r["rounds_ms"]["bwd_no_flush"]} for r in x},
                             ablation_vs_bwd={r["shape"]: {"flush": r["ratios"]["bwd_no_flush/bwd"]} for r in x})
            kernels.append(entry)
    k2 = path["k2"] + tpath["k2"]
    kernels.append(dict(
        name="fused_sample_pdf_merge", route="cuda",
        source="sinnerf_tpu_torch/csrc/fused_sample_pdf.cu", kernel="sample_pdf_lanes_kernel",
        replaces="sinnerf_tpu/ops/fused_sample_pdf_t.py:61",
        launches=sum(ev["launches"][cd][1] for cd in ev["launches"]) + sum(train[cd]["counts"][2] for cd in train),
        step2_launches=sum(step2[cd]["counts"][2] for cd in step2),
        max_abs_err=max([k2_err] + [x["err"] for x in k2]), tolerance=f"{K2_TOL[1]} + {K2_TOL[0]}|z|",
        ms=mean_of(k2, "ms"), plain_ms=mean_of(k2, "plain_ms"), bound_ms=mean_of(k2, "bound_ms"),
        bound_by="bytes", library_ms=None,
        per_launch={x["shape"]: [x["ms"], x["plain_ms"], x["bound_ms"]] for x in k2[:2] + tpath["k2"][:1]},
        # the first port (sample_pdf_merge_kernel, one thread per ray) timed beside it in alternating rounds
        earlier_source="sinnerf_tpu_torch/csrc/fused_sample_pdf.cu", earlier_kernel="sample_pdf_merge_kernel",
        earlier_ms=mean_of(k2, "earlier_ms"), rounds_ms=mean_of(k2, "new_ms"),
        vs_earlier={x["shape"]: x["ratio"] for x in k2[:2] + tpath["k2"][:1]}, rounds=K2_ROUNDS[0],
        earlier_err=max(x["earlier_err"] for x in k2), sass=sass["k2_lanes"], ptxas=ptxas["k2_lanes"],
        # the kernel cut after its rows and after its CDF, in the same rounds
        parts_ms={x["shape"]: x["parts_ms"] for x in k2[:2] + tpath["k2"][:1]},
        parts_vs_whole={x["shape"]: x["parts_vs_new"] for x in k2[:2] + tpath["k2"][:1]},
        # the slice's shapes: [ms (timed at the training batches), bound ms, error]
        slice_per_launch={x["shape"]: [x.get("ms"), x["bound_ms"], x["err"]] for x in slice_k["k2"]},
        **slice_launches("K2", "bfloat16", slice_cli, slice_ev, demo, ddp_out),
    ))
    kernels[-1]["max_abs_err"] = max(kernels[-1]["max_abs_err"], max(x["err"] for x in slice_k["k2"]))
    kernels += x_kernel_entries(x1_err, x1_res, x1_counts, x2_err, x2_res, x2_counts, sass, ptxas)
    print(f"total {time.perf_counter() - t0:.1f} s; ms, plain_ms and bound_ms are means over a path's launches "
          f"(K1: one eval image; K3 and K4: one train step; K2: both; X1 and X2: one launch of the experiment's "
          f"size); no single PyTorch call computes any kernel's function")
    print(json.dumps({"kernels": kernels, "card": card, "psnr": ev["psnr"], "train_cli": cli,
                      "step2": {"step": step2, "profile": step2_profile, "cli": step2_cli},
                      "slice": {"datasets": slice_data, "cli": slice_cli, "eval": slice_ev, "demo": demo,
                                "seconds": slice_s},
                      "ddp": ddp_out}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
