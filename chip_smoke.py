#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card

Phases (any failed check raises and the script exits non-zero):

1. environment: torch / CUDA versions, the card's name and power limit;
2. build: nvcc compiles ``bayer_low_light_image_enhancement_tpu_torch/csrc``;
3. each kernel against its plain PyTorch twin on the card, at the shapes the
   RawFormer-S serving path gives it (batch 8 @ 512x512 and one 2832x4240
   frame), with the tolerances below; then the backward kernels B1/B2
   against their twins at the training shapes (batch 8 @ 512x512), and the
   weight-grad pass they call at C >= 96 (TMA-fed wgmma tiles, K split over
   thread-block clusters) against its twin on the products B1/B2 hand it
   there;
4. serving: RawFormer-S (dim 32, heads 8/8/8/8, FFN 2, seeded random
   weights, bf16 compute) answers 3 requests of 8 uint16 mosaics at 512x512
   through ``Predictor.raw_u16`` and two float frames (2832x4240, 1000x1500)
   through ``Predictor.__call__``; the launch counters must show every
   kernel ran (and no backward kernel), and the kernel path must match the
   twin path;
4b. training: RawFormer-S (fp32 params, bf16 compute) takes Adam steps on
   synthetic batch-8 @ 512x512 crops fed by ``Loader`` +
   ``prefetch_to_device`` through ``Trainer.train_step``; the counters must
   show K2, K3, B1 and B2 7 times per step (and the weight-grad pass twice
   per block of width >= 96: 6 times), the first loss and every first-step
   grad leaf must match a twin-path trainer (against a nudged and a bf16
   twin as yardsticks), 20 steps on one batch must lower its loss, and
   ``eval_step`` must give finite PSNRs;
5. timing with CUDA events after warmup: each kernel against its twin (K2,
   K3 and K3P with their plans: tile, threads, shared memory, CTAs,
   launches; the weight-grad pass on B1's three products and B2's one with
   its plans and beside one bf16 ``torch.matmul`` of B2's product), the
   batch-8 forward, the full-resolution frame, B1 and B2 as whole wrapper
   calls (the weight-grad pass included) at the block shapes of batch 8
   and 16, and the train step at batch 8 and 16 @ 512x512 on the kernel and
   the twin path (with peak memory and B1 + B2's launch-weighted share);
6. RawFormer-WFB: the selective-scan kernels S1 (with and without saved
   states) and S2 against their twins at the four distinct scan shapes of
   WFB-48 at batch 2 @ 512x512 (b = 3 high bands x 2 images); WFB-48
   (seeded random weights, bf16 compute) serves 3 batch-2 @ 512x512 float
   requests through ``Predictor.__call__`` (pad_to 32) against the twin
   path, and one 2832x4240 frame; it trains through ``Trainer`` on
   synthetic crops (``Loader`` + ``prefetch_to_device``), kernel path
   against twin path at batch 2 @ 256x256, 20 steps on one batch, and the
   step timed at batch 8 @ 512x512; the counters must show S1 7 times per
   forward (S2 never) when serving and S1 with states and S2 7 times per
   train step; S1 / S2 and the WFB forward and step are timed, S1 (with
   and without states) and S2 also at the scan shapes of a batch-8 @
   512x512 train step (b = 24), where they are held against their twins
   too; S1's plan (chunks, launches a call) is printed at every scan shape,
   S2's plan and the resident warps per SM of both. The first-step
   comparison runs once more in fp32 compute, where every grad leaf, the
   FEB ones included, is held to max(3 x the nudged twin's change,
   WFB_GRAD_FLOOR) (``wfb_fp32_first_step``, C10).
7. the pipelined apply pass K3P and the retired kernels A1 (standalone
   channel attention: its gram pass, finalise kernel and apply pass) and T1
   (stage tail, on the stage's own t from ``fused_transformer_block``)
   against their twins at the block shapes of phase 3 (inside phase 3; A1
   also at C = 48, 96, 192, and its finalise kernel alone against
   ``finalize_attention`` at every width and 1, 2, 4 and 8 heads); RawFormer-S serves 3 batch-8 @ 512x512 uint16
   requests and one 2832x4240 uint16 frame through
   ``Predictor(model, apply_kernel="pipelined").raw_u16`` (K3P 7 times and
   K3 never per forward, against the twin path) and takes one train step at
   batch 8 @ 512x512 with ``set_apply_kernel(model, "pipelined")`` (K3P in
   the forward, B1/B2 in the backward, first loss against the tiled path's);
   K3P (one kernel: its two phases on two groups of warps, y handed over
   on chip) is timed beside K3, A1 beside the ChannelAttention module, T1
   (two kernels split at y, printed with their plans) beside the module
   tail (``fused_stage.module_tail``: cuDNN convs, LeakyReLUs, concat,
   reduce);
8. the probe ladders: the floor ladder (load strategies, the TMA window
   ring included, x levels x tile heights) at [8,256,256,32], with
   ``Tensor.copy_`` of the same tensor beside level c, and the bisect ladder (K3 and K3P cut after
   each stage; K3's stages 1-3 cut its first kernel, stage 4 adds its
   second cut after the FFN expand) at the four RawFormer-S block shapes,
   every rung that computes a result against its twin, ms and effective
   GB/s per rung;
9. the real-data path: SID-layout trees written from a seed
   (``data.synthetic.write_sid_tree``: 8 training pairs at 1424x2128, 2
   test pairs at 2832x4240, a second tree with one ragged 2838x4250 frame;
   npz cache, codes in [512, 16383], uint16 GT); the train CLI on RawFormer-S
   with ``--loader native`` at batch 8 @ 512x512 (compact 16-bit triples
   through the kernel path, validation at full frame): K2 / K3 7 times a
   step and a validation forward, B1 / B2 7 and the weight-grad pass 6 times
   a step, K1 never; the eval CLI from its checkpoint, compact (K1 once an
   image) and ``--no_compact_h2d`` (K1 never), K2 / K3 7 times an image, one
   CSV row an image, the two runs' per-image PSNR within EVAL_PSNR_TOL and
   SSIM within EVAL_SSIM_TOL; on one frame ``Predictor.raw_u16`` against
   ``__call__`` of the frame decoded on the host in K1's expression within
   DECODE_TOL, a doubled ratio moving the output by more than DECODE_SEEN,
   and both forwards' device time; the MCR device decode of two dark
   in-memory uint8 frames (the two amplifications) against the host decode,
   held the same way; the eval CLI on WFB-48 over the ragged
   frame (S1 7 times, pad 32). Host seconds per image and forward device
   ms are printed beside the card's name and power limit; without
   ``imageio`` no JPEG is written, and a line says so;
10. the FLCA / TrueColor family: ``flca_rawformer``,
   ``multilvl_flca_rawformer``, ``truecolor_rawformer`` and
   ``bayertorgb_rawformer`` at dim 48 (heads 8/8/8/8, FFN 2, seeded random
   weights, fp32 params, bf16 compute) each serve a batch-2 @ 512x512 float
   request through ``Predictor.__call__`` on the kernel path and on the
   module path (``set_fused_blocks(model, False)``), held to E2E_MAX_TOL /
   E2E_MEAN_TOL (the RGB, and the head's input relative to its largest
   magnitude), with K2 and K3 6 times a forward (the C = 48, 96, 192
   blocks; the C = 384 one takes the module path) and no other kernel;
   both paths' forward device ms are printed; ``raw_u16`` raises TypeError
   (no prepacked entry); ``flca_rawformer`` and
   ``bayertorgb_rawformer`` also serve a 2832x4240 SID uint16 frame
   through ``Predictor.codes`` (the same counts), its forward's device ms
   and the peak memory printed beside the card's name and power limit;
11. the FLCA / TrueColor family trains: the four models of phase 10 (dim
   48, seeded random weights, BayerTORGB's colour correction moved off
   saturation as in phase 10, fp32 params, bf16 compute, phase 4b's
   ``TrainConfig``) each take ``Trainer.train_step`` on a synthetic batch-2
   @ 256x256 batch (``Loader`` + ``prefetch_to_device``), held to phase
   4b's yardstick against the twin path (``held_train_step``; the median
   over the leaves also against MEDIAN_YARD x the bf16 twin path's;
   BayerTORGB's ``log_temperature`` leaves are logged by name); the
   counters must show
   K2, K3, B1 and B2 once per kernel block (C = 48, 96, 192, twice each: 6)
   and the weight-grad pass twice per block of width >= 96 (8) a step, K1,
   K3P and the scans never (the counts derived from the model's blocks);
   20 steps on one batch must lower the loss with no step skipped by the
   NaN guard; one step at batch 8 @ 512x512 is timed on the kernel and the
   module path (CUDA events, peak memory), and one kernel-path step
   profiled (device time against host clock, B1 + B2's share). For
   ``flca_rawformer`` and ``bayertorgb_rawformer`` each kernel block's (x,
   dy, weights) is captured from one step and K2 / K3 and B1 / B2 are held
   on them by the per-leaf rule (``capture_blocks``,
   ``hold_captured_blocks``, C12);
12. ``luma_mhsa_rawformer`` (heads 8/8/8/8) and ``wavkan_rawformer`` (heads
   8/16/32/32) at dim 48 (seeded random weights, fp32 params, bf16
   compute), whose token attention and KAN layers run as chunked plain
   PyTorch: each serves a batch-2 @ 512x512 float request through
   ``Predictor.__call__`` (finite in [0, 1], the default chunks against
   256 MiB chunks within E2E_MAX_TOL / E2E_MEAN_TOL, no hand kernel
   launched, the forward's device time and the peak memory printed) and
   trains at batch 2 @ 256x256 (first loss and every first-step grad leaf
   of the default chunks against 256 MiB chunks by phase 6's rule, the
   median also against MEDIAN_YARD x the nudged run's, the BatchNorm
   running stats within WFB_BN_TOL; the same in fp32 compute with phase
   6's median bar; 20 steps on one batch lower the loss with no step
   skipped, the step time and peak memory printed);
13. the four raw-domain models, ``flca_unet``, ``unet_luma_dwt`` (base 48,
   blocks 3/3/3, 4 heads), ``simple_flca_unet`` (base 32, 4 heads) and
   ``lumachroma_transformer`` (base 48, 2 blocks, box filters 7/15/31, 4
   heads), seeded random weights, fp32 params, bf16 compute, packed planes
   in and out, no hand kernel: each serves a batch-2 request of packed
   256x256 planes (512x512 mosaics; the default chunks against 256 MiB ones
   within E2E_MAX_TOL / E2E_MEAN_TOL x the output's largest magnitude;
   device ms by the profiler, peak memory), the first two a packed
   1416x2120 SID frame (device ms, peak), and each trains at batch 2 @
   packed 128x128 (phase 12's rule in bf16 and fp32 compute; 20 steps
   lower the loss with no step skipped, the step time and peak memory
   printed); then ``F.scaled_dot_product_attention`` is timed beside the
   chunked token attention at lumachroma's largest attention, [2, 4,
   65536, 12] bf16 (a library measurement; no model calls SDPA);
14. serving artifacts (``serving/export.py``, ``torch.export``): opcheck of
   the four ``torch.ops.blle`` operators (K2, K3, K3P, S1) on CUDA inputs;
   each wrapper's host microseconds a call beside its operator called
   directly and the kernel function it dispatches to (K2 / K3 at
   [8,256,256,32], S1 at [6,16384,96,32]); RawFormer-S (seed 0, bf16
   compute) exported at batch 8 @ 512x512 and at one 2832x4240 frame, with
   the tiled and the pipelined apply pass, WFB-48 at batch 2 @ 512x512 and
   ``flca_rawformer`` at dim 48 at batch 2 @ 512x512; a fresh process
   (``EXPORT_CHILD``) loads each artifact through ``load_artifact`` alone
   and runs it on the frames ``Predictor.__call__`` served here: within
   ARTIFACT_TOL of Predictor, K2 and K3 (or K3P) 7 times a RawFormer-S
   forward and 6 times a ``flca_rawformer`` one, S1 7 times a WFB forward,
   no other kernel; each artifact call timed against Predictor's in turns
   (host clock and CUDA events, numpy in and out); ``model_complexity`` of
   RawFormer-S at 1x512x512 the same on the card and on the CPU;
15. multi-GPU training (``core/mesh.py``, ``parallel/tensor.py``, the
   ``Trainer`` over a mesh); its ranks are processes of this script
   (``--dist-rank``) and the parent holds their results: (a) RawFormer-S
   (bf16 compute) at global batch 8 @ 512x512 from compact uint16 batches
   over every card, at most 4 (NCCL; with one card its one rank is this
   process, in a one-rank group), data-parallel through the kernels
   (K2 / K3 / B1 / B2 7 times and the weight-grad pass 6 times in the
   step); with one card the params after two steps equal one process's
   bitwise (cuDNN deterministic in that rank), with more they are held by
   phase 4b's rule; (b) two ranks sharing the one card over gloo with CUDA
   tensors (data=2): RawFormer-S at global batch 8 @ 512x512 through the
   kernels, the first loss and every first-step grad leaf against one
   process by the floor of phase 4b's yardstick, the two ranks' averaged
   grads bitwise equal; WFB-48 at global batch 4 @ 256x256 in fp32 compute
   (S1 with states and S2 7 times): the BatchNorm running statistics
   (global) and the params after two steps (the first at lr 0) against one
   process (DDP_BN_TOL, TRAIN_PARAM_ATOL; grads by phase 6c's fp32 rule);
   (c) tensor parallelism over gloo on the card, tensor=2 (the same two
   ranks) then data=2 x tensor=2 (four ranks), RawFormer-S in fp32 compute
   at batch 4 @ 256x256: the forward and two steps against the unsharded
   module path (TP_*; the sharded blocks take the module path, so no hand
   kernel launches), the gathered checkpoint the single-device state; (d)
   the train CLI with ``--num_chips <cards>`` for one synthetic epoch, then
   ``--resume``. The DDP and mesh step times are printed beside one
   process's, with the gradient all-reduce's share. Gloo runs on one card
   because the machine the script is held on has one card, and gloo is
   the backend that lets several ranks share one; the code is the code
   that runs on NCCL across cards, and its times on one card are labelled
   as not a multi-GPU figure;
16. tiled full-resolution inference (``parallel/tiled.py``): four ranks,
   processes of this script as in phase 15 (NCCL with a card each where
   the machine has four, else gloo with the ranks sharing card 0), run
   RawFormer-S at full width (dim 32, seed 16) on one 2832x4240 frame
   H-sharded over 4 ranks and over a 2 x 2 mesh, and WFB-48 H-sharded over
   4 ranks at 1024x1024, each in fp32 compute (TF32 off) against one
   process's monolithic module path / scan twin and in bf16 against the
   monolithic kernel path (the serving bar); every rank receives the whole
   RGB; K2 / K3 / K3P / S1 launch 0 times on the tiled path (sharded
   blocks take the module path and sharded scans the twin) and 7 times on
   the monolithic kernel paths; the tiled frame forward's host clock per
   rank with its all-reduces' share and the output gather's, beside the
   monolithic kernel path's; then the eval CLI with ``--spatial_chips 2``
   (ranks started as torchrun would) on two 2832x4240 SID frames against
   the unsharded CLI (``--no_fused``), both in fp32;
17. tiled inference of the rest of the zoo: four ranks as in phase 16
   run the ten other registry models, seeded at full width (dim 48, the
   raw-domain models at their JAX default widths, BayerTORGB's colour
   correction spread as in phase 10): the FLCA / TrueColor family on the
   phase-16 frame H-sharded over 4 ranks (``flca_rawformer`` and
   ``bayertorgb_rawformer`` also over 2 x 2), ``flca_unet`` /
   ``unet_luma_dwt`` on its packed planes (``flca_unet`` also 2 x 2),
   WavKAN at 1024x1024, luma-MHSA at 512x512 and ``simple_flca_unet`` /
   ``lumachroma_transformer`` on packed 256x256 planes (luma-MHSA and
   lumachroma also 2 x 2), each in fp32 against one process's monolithic
   module path and in bf16 against the monolithic bf16 forward (the
   family's kernel path), the family's head input too; every rank
   receives the same whole output; K2 / K3 / K3P launch 0 times on every
   tiled forward and 6 times on the family's kernel-path references; the
   timed cases' tiled forward per rank beside the monolithic one; then the
   eval CLI with ``--model flca_rawformer`` over 2 x 2 ranks on two SID
   frames against the unsharded CLI in fp32;
18. band mode, the single-card full-frame forward (``models/fused_apply.py``):
   K2 / K3 in band mode against their band twins at the band shapes of the
   Sony ARW frame (2848x4256 padded to 2944x4352, 8 bands of 368 mosaic
   rows: [8,184,2176,32] ... [8,23,272,256], and the B / L bottleneck's
   [8,23,272,384] / [8,23,272,512], where the plain K2 / K3 are held too,
   each kernel of the wide chain (LayerNorm, the wgmma GEMMs each beside a
   bf16 torch.matmul / bmm, the dw passes, the gram through the weight-grad
   pass, the finish) is held against its twin and timed, and the bf16
   band-aware module-path block is timed beside the whole block on the
   kernels), timed beside the frame's monolithic K2 / K3 and their bounds; RawFormer-S on the frame banded against its
   monolithic kernel path (7 band-mode K2 and K3, no other block kernel,
   also with ``apply_kernel="pipelined"``), banded and monolithic timed
   (CUDA events, host clock, profiler device time, peak memory); the fp32
   twin path banded against monolithic (TF32 off); RawFormer-B and -L on
   the frame, banded against monolithic (7 band-mode K2 / K3 each, one at
   the 384 / 512-wide bottleneck through the wide chain, and no module-path
   attention), with times, peak memory and the chain's scratch, and their
   fp32 twin paths banded against monolithic;
   the eval CLI's band route on a synthetic SID frame
   against its monolithic route at the same pad. Since the band route, the
   eval CLI of phase 9 runs its 2832x4240 frames banded too;
19. RawFormer-B and -L at crop size (dim 48 / 64, heads 8/8/8/8, FFN 2,
   seeded random weights, fp32 params, bf16 compute): each serves 3
   batch-8 @ 512x512 uint16 requests through ``Predictor.raw_u16`` (per
   forward K1 once, K2 / K3 six times, no other kernel, one module-path
   attention: the 384 / 512-wide bottleneck) against the twin path, the
   forward timed by CUDA events, profiler device time and host clock with
   peak memory; trains at batch 8 @ 512x512 (the first step by
   ``held_train_step`` with phase 11's MEDIAN_YARD; per step K2 / K3 / B1 /
   B2 six times and the weight-grad pass eight times; 20 steps lower the
   loss with no NaN-guard skip; the step at batch 8 and 16 on the kernel
   and the module path, peak memory, B1 + B2's share of a profiled step);
   K2 / K3 / B1 / B2 held against their twins at RawFormer-L's three block
   shapes and timed beside twins and bounds at B's and L's block shapes of
   batch 8 and 16 (the weight-grad pass at the split widths beside its
   twin, bound and a bf16 ``torch.matmul``); RawFormer-L's train CLI
   (``--loader native``) for one epoch on a phase-9 SID tree, then
   ``--resume``, then the eval CLI from its checkpoint on the 2832x4240
   frames, band route against ``--no_fused``.

Every kernel row carries its bound: the larger of the bytes it must move
(each input read once, each output written once) over 3.35 TB/s and its
operations over the peak rate of their unit (bf16 tensor cores 989
TFLOP/s, fp32 67 TFLOP/s, exp on the SFU 16 per SM per clock at 132 SMs x
1.98 GHz), computed from this run's shapes. The line before the last is the
JSON kernel table; the last line is ``{"ok": true, "device": {...}}``.
Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

# Tolerances, stated before the run:
# K1 bf16 output (values <= 1 with clamp01) vs the fp32 twin: bf16 rounding.
K1_TOL = 4e-3
# K2 compared on the attention cosines gram / (|q| |k|), which lie in
# [-1, 1] (q and k are rounded to bf16 before the gram on the card).
K2_COS_TOL = 2e-2
# K3 and the whole block, bf16 kernel vs fp32 twin on the same bf16 input:
# |err| <= atol + rtol * |ref| as in tests/test_fused_block.py.
BLOCK_RTOL = BLOCK_ATOL = 2.5e-2
# End to end, kernel path vs twin path (both with bf16 convs): RGB in [0, 1].
# Phase 10 also holds the head's input (``conv_out``'s output, before the
# activation) to these fractions of its largest magnitude, and moves the
# TrueColor models' colour correction off saturation first
# (``spread_color_correction``), so that their RGB sees the blocks.
E2E_MAX_TOL, E2E_MEAN_TOL = 5e-2, 5e-3
# B1/B2, each output leaf (dx2, d_apply, dx, every folded-weight grad): the
# kernel's max error relative to the fp32 twin's leaf max must be within
# max(3 x the bf16 twin's, BWD_FLOOR) (tests/test_fused_bwd.py's yardstick;
# the bf16 twin is the fp32 twin under torch.autocast(bfloat16)).
BWD_FLOOR = 2e-2
# Training, kernel path vs twin path from the same init on the same batch:
# the first loss relative; the first-step grad of every parameter within
# max(3 x the twin path's own change when its input is nudged by half a bf16
# ulp, 3 x the bf16 twin path's error, TRAIN_GRAD_FLOOR) of the twin's leaf
# max, the median over the leaves within TRAIN_GRAD_MEDIAN_TOL. The bf16
# twin path is the twin path under torch.autocast(bfloat16), the yardstick
# B1/B2 are held to: the kernels round activations to bf16 inside the
# blocks, which a nudge of the input does not measure (at batch 8 @ 512^2
# the nudge moves a leaf by ~2e-3, bf16 rounding by up to ~1e-1). The params after two Adam steps (the first at
# the warmup's lr 0) within TRAIN_PARAM_ATOL: Adam moves each param by about
# lr = 1e-4 whatever its grad, so that bound is a ceiling set by Adam's step
# size, not a test of the grads.
TRAIN_LOSS_RTOL, TRAIN_PARAM_ATOL = 2e-2, 5e-4
TRAIN_GRAD_FLOOR, TRAIN_GRAD_MEDIAN_TOL = 2e-2, 2e-2
# S1 on bf16 inputs vs the fp32 twin on the same inputs: y within its bf16
# output rounding, |err| <= SCAN_RTOL |ref| + SCAN_ATOL_REL max|ref|; the
# saved fp32 states within STATE_TOL of their max.
SCAN_RTOL, SCAN_ATOL_REL, STATE_TOL = 8e-3, 1e-3, 1e-4
# S2 vs the explicit backward twin: each leaf within SCAN_BWD_TOL of its max
# (fp32 sums over up to 6 x 16384 terms, taken in another order).
SCAN_BWD_TOL = 1e-3
# WFB training, kernel path vs twin path (bf16 activations; only the scan
# differs): the first-step grad of every parameter outside the FEB
# frequency islands within max(3 x the twin path's own change when its
# input is nudged by half a bf16 ulp, WFB_GRAD_FLOOR) of the twin's leaf
# max; the median over all leaves within WFB_GRAD_MEDIAN_TOL. The FEB
# leaves are only logged: their phase (an atan2 with a branch cut) turns
# rounding-level input changes into large grad changes (the log shows the
# nudged twin's own change, FEB vs other leaves), so no single nudge bounds
# them. BN running stats within WFB_BN_TOL of their max; loss and params as
# TRAIN_* (the params bound again only Adam's ceiling). In fp32 compute the
# FEB leaves are held per leaf like the others (C10: there the nudged twin
# moves the worst FEB leaf by 9.2e-2 and the kernel path by 4.4e-2).
WFB_GRAD_FLOOR, WFB_GRAD_MEDIAN_TOL, WFB_BN_TOL = 2e-2, 2e-2, 1e-2
# Phases 11 and 12 hold the median over the leaves to the larger of its bar
# and MEDIAN_YARD x the yardstick's own median over the leaves (phase 11:
# the bf16 twin path's; phase 12: the nudged run's), beside the per-leaf
# rule. Phase 11's models round more inside their blocks than RawFormer-S
# does: their bf16 twin path's median is 2.0-5.4e-2 of the fp32 twin's leaf
# max at batch 2 @ 256^2 and 2.4-5.1e-2 at batch 8 @ 512^2, above
# TRAIN_GRAD_MEDIAN_TOL, and the kernel path's is 0.6-1.2x that (RawFormer-S
# at batch 8 @ 512^2: 1.1e-2 against the bf16 twin's 3.4e-2). WavKAN's
# train-mode BatchNorms over batch statistics make its bf16 grads chaotic:
# a half-ulp input nudge moves the median leaf by 1.3x its max, so phase 12
# also holds both models to the absolute bar in fp32 compute. MEDIAN_YARD is
# the consequence of a model hazard, not of a kernel fault (C12): on each
# block's own (x, dy, weights) from a step of flca_rawformer and BayerTORGB,
# every K2 / K3 / B1 / B2 leaf is within its per-leaf yardstick and each
# block's median leaf is below its bf16 twin's (2.3-4.2e-3 against
# 3.9-7.3e-3), so the model-level excess (1.2x the bf16 twin path's median)
# is bf16 noise inside the blocks carried through the bf16 layers around
# them: the kernels' rounding and autocast's are two samples of it. Phase 13
# holds the raw-domain models' bf16 medians against the nudged run's, as
# phase 12.
MEDIAN_YARD = 1.5
# A1 and T1 (bf16 kernels vs fp32 twins on the same bf16 inputs) are held to
# the block rule. The probe rungs: level "c" copies exactly; every other rung
# that computes a result (all but "center" at level "v") within PROBE_TOL of
# its twin's max (bf16 rounding between chained products).
PROBE_TOL = 3e-2
# A1's finalise kernel (bf16 apply) vs finalize_attention (fp32): one bf16
# rounding of the value, at most one bf16 step (2^-8 of it) where the two
# fp32 sums fall on either side of a rounding boundary; FINALIZE_ATOL for
# values near zero.
FINALIZE_RTOL, FINALIZE_ATOL = 2.0 ** -8, 1e-6
# WFB-48 at batch 2 @ 512^2: the scan's (b, L, d_inner) at stages 1-4
# (stages 5-7 repeat 3-1); b = 3 high bands x 2 images, N = 32.
SCAN_SHAPES = [(6, 16384, 96), (6, 4096, 192), (6, 1024, 384), (6, 256, 768)]
# The same at the WFB-48 train step's batch 8 @ 512^2 (b = 3 bands x 8).
SCAN_TRAIN_SHAPES = [(24, 16384, 96), (24, 4096, 192), (24, 1024, 384), (24, 256, 768)]
# The weight-grad pass (bf16 operands, fp32 sums over up to 2^19 pixels
# taken in another order than the fp32 twin's): within WG_TOL of each
# product's max.
WG_TOL = 1e-4

# The real-data phase (9): the eval CLI's compact run (K1 packs in bf16 with
# the model's clamp folded in) against its host-decode run (numpy fp32
# decode, the model's clamp and bf16 cast): the same function up to the
# decode's fp32 rounding, so per-image PSNR on the uint8 grid within
# EVAL_PSNR_TOL dB and SSIM within EVAL_SSIM_TOL.
EVAL_PSNR_TOL, EVAL_SSIM_TOL = 0.1, 2e-3
# raw_u16 and Predictor.codes against __call__ of the frame decoded on the
# host in the device's own fp32 expression: the model sees the same bf16
# input either way, so the outputs agree to DECODE_TOL; a doubled ratio or
# amplification must move the output by more than DECODE_SEEN, or the
# comparison could not see one.
DECODE_TOL, DECODE_SEEN = 1e-6, 1e-3
REAL_TRAIN_FRAME, REAL_TEST_FRAME = (1424, 2128), (2832, 4240)
REAL_RAGGED_FRAME, REAL_MCR_FRAME = (2838, 4250), (1024, 1280)

BATCH_SHAPES = [(8, 256, 256, 32), (8, 128, 128, 64), (8, 64, 64, 128), (8, 32, 32, 256)]
FULLRES_SHAPES = [(1, 1416, 2120, 32), (1, 177, 265, 256)]
PACK_SHAPES = [(8, 512, 512), (1, 2832, 4240)]
TPU = "bayer_low_light_image_enhancement_tpu/kernels/"
PKG = "bayer_low_light_image_enhancement_tpu_torch/"

# Peak rates of one H100 SXM (NVIDIA data sheet; exp: MUFU.EX2 throughput of
# compute capability 9.0 in the CUDA C++ Programming Guide, 16 per SM per
# clock, 132 SMs at the 1980 MHz boost clock).
HBM_BYTES_PER_S, TC_BF16, FP32, SFU = 3.35e12, 989e12, 67e12, 16 * 132 * 1.98e9


def bound(nbytes: float, tc: float = 0.0, fp32: float = 0.0, sfu: float = 0.0):
    """(least ms, "bytes" or "operations"): bytes over the memory rate
    against the slowest unit's operations over its peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(tc / TC_BF16, fp32 / FP32, sfu / SFU)
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def block_counts(kind: str, b: int, h: int, w: int, c: int) -> dict:
    """Bytes and operations K2 / K3 / B1 / B2 need at [b, h, w, c] bf16: x
    (and dy / dx2) read once, outputs written once, the [C, C] tensors; the
    1x1 and gram products on the tensor cores (B1 / B2: only the backward
    products, twice the forward's, no recompute), the depthwise convs,
    LayerNorms and GELU in fp32."""
    p = b * h * w
    if kind == "gram":
        return dict(nbytes=p * c * 2 + b * c * c * 4 + 8 * b * c + 4 * c * c,
                    tc=2.0 * p * c * 2 * c + 2.0 * p * c * c, fp32=48.0 * p * c)
    if kind == "apply":
        return dict(nbytes=2 * p * c * 2 + b * c * c * 2 + 10 * c * c,
                    tc=12.0 * p * c * c, fp32=110.0 * p * c)
    if kind == "bwd1":
        return dict(nbytes=3 * p * c * 2 + b * c * c * 6 + 10 * c * c, tc=20.0 * p * c * c,
                    fp32=72.0 * p * c)
    return dict(nbytes=3 * p * c * 2 + b * c * c * 8 + 6 * c * c, tc=16.0 * p * c * c,
                fp32=108.0 * p * c)


def weight_grad_counts(shapes) -> dict:
    """The weight-grad pass on (G, K, M, N) products: a and b bf16 read once,
    the fp32 out written once, 2 G K M N flops on the tensor cores."""
    return dict(nbytes=sum(g * k * (m + n) * 2 + g * m * n * 4 for g, k, m, n in shapes),
                tc=sum(2.0 * g * k * m * n for g, k, m, n in shapes))


def tail_counts(b: int, h: int, w: int, c: int) -> dict:
    """T1 at [b, h, w, c] bf16: x and t read once, the output written once,
    the weights; two 3x3 convs (9 C^2 MACs a pixel each) and the split
    reduce (2 C^2) on the tensor cores, bias and LeakyReLU in fp32."""
    p = b * h * w
    return dict(nbytes=3 * p * c * 2 + 22 * c * c * 2 + 12 * c, tc=40.0 * p * c * c,
                fp32=6.0 * p * c)


def attention_counts(b: int, h: int, w: int, c: int, heads: int = 8) -> dict:
    """A1 at [b, h, w, c] bf16 with ``heads`` heads: x read once, the output
    written once, the bf16 apply [b, C, C]; the qkv 1x1 (6 p C^2), the
    heads' diagonal gram blocks (2 p C^2 / heads: the head mask drops the
    rest) and the apply (2 p C^2) on the tensor cores, the depthwise conv of
    3C channels in fp32."""
    p = b * h * w
    return dict(nbytes=2 * p * c * 2 + b * c * c * 2 + 8 * c * c,
                tc=(8.0 + 2.0 / heads) * p * c * c, fp32=60.0 * p * c)


def stage_counts(stage: int, b: int, h: int, w: int, c: int) -> dict:
    """The bisect rung cut after ``stage`` at [b, h, w, c]: x read once, the
    stage's tensor written once; the products and fp32 work of the stages up
    to it (stage 5 is the apply pass, block_counts("apply"))."""
    p = b * h * w
    tc = (0.0, 2.0, 4.0, 4.0, 8.0, 12.0)[stage] * p * c * c
    fp32 = (0.0, 10.0, 30.0, 32.0, 42.0, 110.0)[stage] * p * c
    return dict(nbytes=2 * p * c * 2 + b * c * c * 2 + 10 * c * c, tc=tc, fp32=fp32)


def floor_counts(level: str, b: int, h: int, w: int, c: int) -> dict:
    """The floor rung at ``level``: x read once, the output written once; 6
    products at "m" and "v", the two depthwise convs and GELU at "v"."""
    p = b * h * w
    return dict(nbytes=2 * p * c * 2, tc=0.0 if level == "c" else 12.0 * p * c * c,
                fp32=60.0 * p * c if level == "v" else 0.0)


def scan_counts(b: int, L: int, d: int, n: int, in_bytes: int, backward: bool,
                states: bool = False) -> dict:
    """Bytes and operations of the scan: u, dt (dy) [b, L, d] and B, C
    [b, L, n] in, y (or du, ddt, dB, dC, dA, dD fp32) out, the saved states
    [b, ceil(L/32), d, n] fp32 out of the forward with ``states`` and into
    the backward; per (b, t, d, n) one exp and the fp32 arithmetic of the
    recurrence (forward 6 flops: dt A, a h + ., (dt u) B, C h + .; backward
    18: h again, lam, its products and sums)."""
    bld, bln = b * L * d, b * L * n
    state_bytes = 4 * b * -(-L // 32) * d * n
    if backward:
        nbytes = ((3 * bld + 2 * bln) * in_bytes + state_bytes
                  + 4 * (2 * bld + 2 * bln + 2 * d * n + 2 * d))
        return dict(nbytes=nbytes, fp32=18.0 * bld * n, sfu=float(bld * n))
    return dict(nbytes=(3 * bld + 2 * bln) * in_bytes + 4 * (d * n + d)
                + (state_bytes if states else 0), fp32=6.0 * bld * n, sfu=float(bld * n))


def log(*a):
    print(*a, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def ptxas_summary(build_log: str):
    """One line per compiled kernel: registers, barriers, stack and spills,
    from nvcc's -Xptxas -v output."""
    name, spill = None, ""
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            # Itanium mangling: <length><identifier>, then the template args;
            # the length may follow digits of the namespace hash.
            mangled, name = m.group(1), m.group(1)
            for k in re.finditer(r"(?<=\d)(?=([a-z]\w*?_kernel))", mangled):
                ident = k.group(1)
                if re.search(r"\d+$", mangled[: k.start()]).group().endswith(str(len(ident))):
                    rest, args = mangled[k.start() + len(ident):], []
                    pos = 1 if rest.startswith("I") else len(rest)
                    while t := re.match(r"Li(\d+)E|Lb(\d)E|(f)|13__nv_(bfloat16)", rest[pos:]):
                        i, b_, f_, h_ = t.groups()
                        args.append(i or h_ or ("float" if f_ else
                                                "true" if b_ == "1" else "false"))
                        pos += t.end()
                    name = ident + (f"<{','.join(args)}>" if args else "")
                    break
            spill = ""
        elif "spill" in line:
            spill = line.strip()
        elif name and "Used" in line and "registers" in line:
            yield f"{name}: {line.split(':', 1)[1].strip()}; {spill}"
            name = None


def block_plan_line(fb, shape) -> str:
    """K2's, K3's two kernels' and (at a pipelined width) K3P's plans at
    ``shape`` as the wrappers launch them: tile, threads, shared memory,
    persistent CTAs, launches a call."""
    parts = []
    kinds = [("gram", "K2"), ("apply1", "K3 kernel 1"), ("apply2", "K3 kernel 2")]
    if shape[-1] in fb.PIPELINED_WIDTHS:
        kinds.append((fb.PIPE, "K3P"))
    for kind, name in kinds:
        p = fb.plan_for(kind, *shape, 0)
        cfg = p.config
        ctas = (f"{p.ctas} CTAs per image and channel block ({p.blocks} blocks)"
                if kind == "gram" else f"{p.ctas} CTAs")
        parts.append(f"{name} tile {cfg.th}x{cfg.tw}, {cfg.threads} threads, {cfg.smem} B shared, "
                     f"{ctas}, {p.launches} launch{'es' if p.launches > 1 else ''}")
    return "; ".join(parts)


def weight_grad_plan_line(wgk, pairs) -> str:
    """The weight-grad pass's plan for ``pairs`` as its wrapper launches it:
    tile width, cluster, CTAs, K slices per product, workspace."""
    p = wgk.plan_for(tuple((a.shape[0], a.shape[1], a.shape[2], b.shape[2]) for a, b in pairs))
    return (f"128x{p.tn} tiles, clusters of {p.cluster}, {p.blocks} CTAs, slices "
            f"{[sp.slices for sp in p.splits]}, {p.ws_floats * 4 / 2 ** 20:.2f} MiB of partials")


def tail_plan_line(fs, shape) -> str:
    """T1's two kernels' plans at ``shape`` as the wrapper launches them:
    tile, threads, shared memory, weights resident or streamed, windows,
    persistent CTAs."""
    p = fs.plan_for(*shape, 0)
    parts = []
    for name, cfg, ctas in (("conv kernel", p.conv, p.ctas_conv),
                            ("out kernel", p.out, p.ctas_out)):
        weights = ("weights resident" if cfg.resident else
                   f"weights streamed in {cfg.kc}-row chunks through {cfg.slots} slots")
        parts.append(f"{name} tile {cfg.th}x{cfg.tw}, {cfg.threads} threads, {cfg.smem} B shared, "
                     f"{weights}, {'wgmma' if cfg.wgmma else 'mma.sync'}, "
                     f"{cfg.windows} window{'s' if cfg.windows > 1 else ''}"
                     f"{', conv over the x window' if cfg.vx else ''}, {ctas} CTAs")
    return f"{p.tiles} tiles; " + "; ".join(parts)


def u16_to_device(a: np.ndarray) -> torch.Tensor:
    """uint16 numpy -> CUDA uint16 tensor (moved as int16 bits)."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).cuda().view(torch.uint16)


def mosaics(rng, shape) -> np.ndarray:
    """Sensor-like codes below white, with 0.1% hot pixels >= 32768."""
    m = rng.integers(0, 17000, shape, dtype=np.uint16)
    hot = rng.random(shape) < 1e-3
    m[hot] = rng.integers(32768, 65536, int(hot.sum()), dtype=np.uint16)
    return m


def peak_memory(fn):
    """fn() with the peak-memory counter reset just before; -> (its result,
    the peak GiB allocated during it, the GiB held just before: earlier
    phases' tensors and the kernels' workspaces)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() / 2 ** 30, held / 2 ** 30


def no_kernel(got: dict, what: str) -> None:
    """Check that the counts ``counted`` returned show no hand kernel."""
    check(sum(got.values()) == 0, f"{what}: a hand kernel launched ({got})")


def counted(counters, fn):
    """fn() with every counter at 0 just before; -> (its result, the counts
    just after)."""
    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {c.__name__: c.launches for c in counters}


def kernel_counters() -> tuple:
    """The launch counters of the kernels a model's path may run: K1, K2,
    K3, K3P, the weight-grad pass, B1, B2, S1 (S1 with states too), S2, K2 /
    K3 in band mode."""
    from bayer_low_light_image_enhancement_tpu_torch.kernels import bayer_pack as bp
    from bayer_low_light_image_enhancement_tpu_torch.kernels import fused_block as fb
    from bayer_low_light_image_enhancement_tpu_torch.kernels import fused_block_bwd as fbb
    from bayer_low_light_image_enhancement_tpu_torch.kernels import ssm_scan as ssk
    from bayer_low_light_image_enhancement_tpu_torch.kernels import weight_grad as wgk

    return (bp.bayer_pack_normalize, fb.gram_pass, fb.apply_pass, fb.apply_pass_pipelined,
            wgk.weight_grad, fbb.bwd1, fbb.bwd2, ssk.selective_scan_fwd, ssk.selective_scan_bwd,
            fb.gram_pass_banded, fb.apply_pass_banded)


@contextlib.contextmanager
def twin_blocks():
    """Every TransformerBlock through ``fused_transformer_block_plain`` (the
    fp32 twins, differentiated by autograd): the twin path."""
    from bayer_low_light_image_enhancement_tpu_torch.kernels import fused_block as fb
    from bayer_low_light_image_enhancement_tpu_torch.models import common

    saved = common.fused_transformer_block
    common.fused_transformer_block = fb.fused_transformer_block_plain
    try:
        yield
    finally:
        common.fused_transformer_block = saved


def twin_u16_forward(model, mosaic, ratio) -> np.ndarray:
    """The twin path of ``Predictor.raw_u16`` on device tensors (uint16
    [B, H, W] mosaics, fp32 ratios): K1's fp32 twin, then the model's
    prepacked forward with every TransformerBlock on its fp32 twin; ->
    RGB [B, H, W, 3] in [0, 1]."""
    from bayer_low_light_image_enhancement_tpu_torch.kernels import bayer_pack as bp

    with torch.inference_mode(), twin_blocks():
        x4 = bp.bayer_pack_normalize_plain(mosaic, ratio, torch.float32, clamp01=True)
        y = model(x4.permute(0, 3, 1, 2), prepacked=True).clamp(0, 1)
    return y.permute(0, 2, 3, 1).float().cpu().numpy()


def block_backward_leaves(x, dy, wts, run, heads: int = 8) -> dict:
    """dx2, d_apply, dx and every folded-weight grad of B1 -> finalize
    backward -> B2 of a block, each pass through run(1 or 2, *args)."""
    from bayer_low_light_image_enhancement_tpu_torch.kernels import fused_block as fb
    from bayer_low_light_image_enhancement_tpu_torch.kernels import fused_block_bwd as fbb

    gram, qss, kss = fb.gram_pass_plain(x, wts)
    apply = fb.finalize_attention(gram, qss, kss, wts.temperature, wts.wproj, heads)
    dx2, d_apply, g1 = run(1, x, dy, apply, wts)
    d = fbb.finalize_backward(gram, qss, kss, wts.temperature, wts.wproj, d_apply, heads)
    dx, g2 = run(2, x, dx2.to(torch.bfloat16), apply, *d[:3], wts)
    return {"dx2": dx2, "d_apply": d_apply, "dx": dx, **g1, **g2}


def bwd_kernels(k, *args):
    from bayer_low_light_image_enhancement_tpu_torch.kernels import fused_block_bwd as fbb

    return (fbb.bwd1 if k == 1 else fbb.bwd2)(*args)


def bwd_twins(k, *args):
    from bayer_low_light_image_enhancement_tpu_torch.kernels import fused_block_bwd as fbb

    return (fbb.bwd1_plain if k == 1 else fbb.bwd2_plain)(*args)


def bwd_bf16_twins(k, *args):
    with torch.autocast("cuda", torch.bfloat16):
        return bwd_twins(k, *args)


def backward_against_twins(x, dy, wts, heads: int = 8):
    """B1 / B2 (and the weight-grad pass they call at the split widths) on
    (x, dy) against the fp32 and the bf16 twins: -> (kernel leaves, fp32
    twin leaves, {leaf: (kernel error, bf16 twin error)} relative to the fp32
    twin's leaf max)."""
    got = block_backward_leaves(x, dy, wts, bwd_kernels, heads)
    ref = block_backward_leaves(x, dy, wts, bwd_twins, heads)
    noisy = block_backward_leaves(x, dy, wts, bwd_bf16_twins, heads)
    rel = {}
    for name, r in ref.items():
        scale = r.float().abs().max().item() + 1e-8
        rel[name] = tuple((t[name].float() - r.float()).abs().max().item() / scale
                          for t in (got, noisy))
    return got, ref, rel


def weight_grad_pairs(x, dy, wts):
    """The (a, b) products the split regime hands the weight-grad pass at
    x's shape: B1's and B2's operands as their twins compute them, in bf16
    as the kernels write them."""
    from bayer_low_light_image_enhancement_tpu_torch.kernels import fused_block as fb
    from bayer_low_light_image_enhancement_tpu_torch.kernels import fused_block_bwd as fbb
    from bayer_low_light_image_enhancement_tpu_torch.kernels import weight_grad as wgk

    gram, qss, kss = fb.gram_pass_plain(x, wts)
    apply = fb.finalize_attention(gram, qss, kss, wts.temperature, wts.wproj, 8)
    o1 = fbb.bwd1_operands_plain(x, dy, apply, wts)
    d_apply = wgk.weight_grad_plain(fbb.bwd1_product_pairs(
        o1["v"], o1["dx2"], o1["yh"], o1["dt"], o1["g"], dy))[0]
    d = fbb.finalize_backward(gram, qss, kss, wts.temperature, wts.wproj, d_apply, 8)
    o2 = fbb.bwd2_operands_plain(x, o1["dx2"], apply, *d[:3], wts)
    bf = lambda t: t.to(torch.bfloat16).contiguous()  # noqa: E731
    return [fbb.bwd1_product_pairs(*(bf(o1[k]) for k in ("v", "dx2", "yh", "dt", "g")), dy),
            fbb.bwd2_product_pairs(bf(o2["xh"]), bf(o2["dz"]))]


def hold_backward(x, dy, wts, what) -> tuple:
    """``backward_against_twins`` on (x, dy), held per leaf: each within
    max(3 x the bf16 twin's error, BWD_FLOOR) of the fp32 twin's leaf max;
    logs the worst leaf against its allowance, the median and every leaf.
    -> (dx2's max abs error, dx's)."""
    got, ref, rel = backward_against_twins(x, dy, wts)
    allowed = {n: max(3 * e16, BWD_FLOOR) for n, (_, e16) in rel.items()}
    bad = [f"{n} {rel[n][0]:.3e} (bf16 twin {rel[n][1]:.3e})" for n in rel
           if rel[n][0] > allowed[n]]
    worst = max(rel, key=lambda n: rel[n][0] / allowed[n])
    e1 = (got["dx2"].float() - ref["dx2"].float()).abs().max().item()
    e2 = (got["dx"].float() - ref["dx"].float()).abs().max().item()
    log(f"{what}: worst leaf against its allowance {worst} rel err {rel[worst][0]:.3e} (bf16 "
        f"twin {rel[worst][1]:.3e}, floor {BWD_FLOOR}); median leaf "
        f"{np.median([e for e, _ in rel.values()]):.3e}; dx2 max abs err {e1:.3e}, dx {e2:.3e}")
    log("  per leaf, kernel / bf16 twin error relative to the fp32 leaf max: "
        + ", ".join(f"{n} {ek:.2e}/{e16:.2e}" for n, (ek, e16) in rel.items()))
    check(not bad, f"{what}: B1/B2 disagree with their twins: {bad}")
    return e1, e2


def capture_blocks(model, step) -> list:
    """Run ``step()`` (a train step of ``model``) with hooks on every
    TransformerBlock that takes the kernels: -> one (x, dy, folded weights,
    heads) a block call, in forward order; x and dy NHWC bf16 as the block's
    kernels got them, the weights folded in the forward (before the step's
    update)."""
    from bayer_low_light_image_enhancement_tpu_torch.kernels import fused_block as fb
    from bayer_low_light_image_enhancement_tpu_torch.models import common

    seen, hooks = [], []

    def hook(blk, inputs, out):
        rec = {"x": inputs[0].detach().permute(0, 2, 3, 1).to(torch.bfloat16).contiguous(),
               "heads": blk.num_heads}
        with torch.no_grad():
            rec["wts"] = fb.fold_block_params({k: v.detach() for k, v in blk.named_parameters()})
        out.register_hook(lambda g: rec.update(
            dy=g.detach().permute(0, 2, 3, 1).to(torch.bfloat16).contiguous()))
        seen.append(rec)

    for m in model.modules():
        if (isinstance(m, common.TransformerBlock) and m.fused
                and m.norm1.body.weight.shape[0] <= common.FUSE_CMAX):
            hooks.append(m.register_forward_hook(hook))
    try:
        step()
    finally:
        for h in hooks:
            h.remove()
    return [(r["x"], r["dy"], r["wts"], r["heads"]) for r in seen]


def hold_captured_blocks(captured, what) -> None:
    """C12: K2, K3 and B1 / B2 (with the weight-grad pass at the split
    widths) on each captured block's own (x, dy, weights) against their fp32
    twins by ``check_backward_against_twins``'s per-leaf rule: every leaf
    within max(3 x the bf16 twin's error, BWD_FLOOR) of the fp32 twin's leaf
    max. K2's leaves are the gram's cosines and the sums of squares, K3's
    the block output; the bf16 twin is the fp32 twin under
    ``torch.autocast(bfloat16)``. Logs each block's worst leaf against its
    allowance, and K2's cosine error beside phase 3's fixed K2_COS_TOL."""
    from bayer_low_light_image_enhancement_tpu_torch.kernels import fused_block as fb

    def forward_leaves(x, wts, heads, gram_pass, apply_pass):
        g, qs, ks = gram_pass(x, wts)
        g0, qs0, ks0 = fb.gram_pass_plain(x, wts)
        apply = fb.finalize_attention(g0, qs0, ks0, wts.temperature, wts.wproj, heads)
        norms = torch.sqrt(qs.float()[:, :, None] * ks.float()[:, None, :])
        return {"gram cosines": g.float() / norms, "sum q^2": qs, "sum k^2": ks,
                "block output": apply_pass(x, apply, wts)}

    def bf16(fn):
        def run(*args):
            with torch.autocast("cuda", torch.bfloat16):
                return fn(*args)
        return run

    for i, (x, dy, wts, heads) in enumerate(captured):
        with torch.no_grad():
            fwd = [forward_leaves(x, wts, heads, *fns) for fns in (
                (fb.gram_pass, fb.apply_pass), (fb.gram_pass_plain, fb.apply_pass_plain),
                (bf16(fb.gram_pass_plain), bf16(fb.apply_pass_plain)))]
            rel = {}
            for name, r in fwd[1].items():
                scale = r.float().abs().max().item() + 1e-8
                rel[name] = tuple((t[name].float() - r.float()).abs().max().item() / scale
                                  for t in (fwd[0], fwd[2]))
            rel.update(backward_against_twins(x, dy, wts, heads)[2])
        allowed = {n: max(3 * e16, BWD_FLOOR) for n, (_, e16) in rel.items()}
        worst = max(rel, key=lambda n: rel[n][0] / allowed[n])
        bad = [f"{n} {rel[n][0]:.3e} (bf16 twin {rel[n][1]:.3e})" for n in rel
               if rel[n][0] > allowed[n]]
        cos, cos16 = rel["gram cosines"]
        k3, k3_16 = rel["block output"]
        log(f"{what} block {i} {list(x.shape)} (captured x, dy): K2 cosine err {cos:.3e} (bf16 "
            f"twin {cos16:.3e}; phase 3's fixed bar {K2_COS_TOL}), K3 output {k3:.3e} (bf16 twin "
            f"{k3_16:.3e}); worst leaf {worst} {rel[worst][0]:.3e} "
            f"(bf16 twin {rel[worst][1]:.3e}, allowed {allowed[worst]:.3e}); median leaf "
            f"{np.median([e for e, _ in rel.values()]):.3e} (bf16 twin "
            f"{np.median([e for _, e in rel.values()]):.3e})")
        check(not bad, f"{what} block {i}: the kernels disagree with their twins on the block's "
              f"own inputs: {bad}")


def held_train_step(make_model, train_cfg, batch, counters, what, show=lambda name: False,
                    median_yard: float = 0.0):
    """The training yardstick of phases 4b and 11: a kernel-path and a
    twin-path ``Trainer`` from one init (``make_model()``) take two steps on
    ``batch`` (the first at the warmup's lr 0). Checks the first loss within
    TRAIN_LOSS_RTOL; every first-step grad leaf within max(3 x the twin
    path's own change when its input is nudged by half a bf16 ulp, 3 x the
    bf16 twin path's error, TRAIN_GRAD_FLOOR) of the twin's leaf max; the
    median over the leaves within TRAIN_GRAD_MEDIAN_TOL, or within
    ``median_yard`` x the bf16 twin path's median where that is larger; the
    params after the two steps within TRAIN_PARAM_ATOL. Logs every leaf
    whose name ``show`` accepts. -> (the kernel-path trainer, its two
    losses, the launches of its first step)."""
    from bayer_low_light_image_enhancement_tpu_torch.train import Trainer

    kern, twin = Trainer(make_model(), train_cfg), Trainer(make_model(), train_cfg)
    first, launches = counted(counters, lambda: float(kern.train_step(batch)))
    kern_grads = {n: p.grad.float().clone() for n, p in kern.model.named_parameters()}
    kern_losses = [first, float(kern.train_step(batch))]
    with twin_blocks():
        twin_losses = [float(twin.train_step(batch))]
        twin_grads = {n: p.grad.float().clone() for n, p in twin.model.named_parameters()}
        twin_losses.append(float(twin.train_step(batch)))

    def twin_change(b, autocast):
        """Each leaf's first-step grad change of a twin-path trainer on b
        (under autocast(bfloat16) or not), relative to the twin's leaf max."""
        tr = Trainer(make_model(), train_cfg)
        with twin_blocks(), torch.autocast("cuda", torch.bfloat16, enabled=autocast):
            tr.train_step(b)
        return {n: ((p.grad.float() - twin_grads[n]).abs().max()
                    / (twin_grads[n].abs().max() + 1e-12)).item()
                for n, p in tr.model.named_parameters()}

    yard = twin_change((batch[0] * (1.0 + 2.0 ** -9), batch[1]), False)
    bf16 = twin_change(batch, True)
    grad_err = {n: ((kern_grads[n] - g).abs().max() / (g.abs().max() + 1e-12)).item()
                for n, g in twin_grads.items()}
    allowed = {n: max(3 * yard[n], 3 * bf16[n], TRAIN_GRAD_FLOOR) for n in grad_err}
    worst = max(grad_err, key=lambda n: grad_err[n] / allowed[n])
    bad = [n for n in grad_err if grad_err[n] > allowed[n]]
    median = float(np.median(list(grad_err.values())))
    bf16_median = float(np.median(list(bf16.values())))
    median_tol = max(TRAIN_GRAD_MEDIAN_TOL, median_yard * bf16_median)
    dp = max((a.detach().float() - b.detach().float()).abs().max().item()
             for a, b in zip(kern.model.parameters(), twin.model.parameters()))
    dl = abs(kern_losses[0] - twin_losses[0]) / abs(twin_losses[0])
    log(f"{what}, kernel path vs twin path: losses {kern_losses} vs {twin_losses} (first rel "
        f"err {dl:.3e}, tol {TRAIN_LOSS_RTOL}); first-step grads of the twin's leaf max, worst "
        f"against its yardstick {worst} {grad_err[worst]:.3e} (nudged twin {yard[worst]:.3e}, "
        f"bf16 twin {bf16[worst]:.3e}, floor {TRAIN_GRAD_FLOOR}); "
        f"{sum(grad_err[n] > max(3 * yard[n], TRAIN_GRAD_FLOOR) for n in grad_err)} of "
        f"{len(grad_err)} leaves beyond the nudge alone; median {median:.3e} (tol "
        f"{median_tol:.3e}; nudged twin {float(np.median(list(yard.values()))):.3e}, bf16 "
        f"twin {bf16_median:.3e}); params after 2 Adam steps max abs diff "
        f"{dp:.3e} (tol {TRAIN_PARAM_ATOL}, Adam's ceiling ~2 lr, not a grad test)")
    for n in filter(show, grad_err):
        log(f"  {n}: grad err {grad_err[n]:.3e} of the twin's leaf max (nudged twin "
            f"{yard[n]:.3e}, bf16 twin {bf16[n]:.3e}; allowed {allowed[n]:.3e})")
    check(dl <= TRAIN_LOSS_RTOL, f"{what}: train loss disagrees with the twin path")
    check(not bad and median <= median_tol,
          f"{what}: first-step grads disagree with the twin path: "
          f"{[(n, grad_err[n], yard[n], bf16[n]) for n in bad]}")
    check(dp <= TRAIN_PARAM_ATOL,
          f"{what}: params after Adam steps exceed Adam's step-size ceiling")
    return kern, kern_losses, launches


def wfb_fp32_first_step(dev, train_cfg, batch, counters) -> None:
    """C10: phase 6c's WFB first-step comparison once more in fp32 compute
    (kernel path: S1 with states and S2 on fp32 inputs; twin path: the scan
    twin), every leaf against max(3 x the nudged twin's change,
    WFB_GRAD_FLOOR), the FEB leaves among them."""
    from bayer_low_light_image_enhancement_tpu_torch.models import get_model
    from bayer_low_light_image_enhancement_tpu_torch.train import Trainer

    def grads(fused, b):
        tr = Trainer(get_model("rawformer_wfb", device=dev, dtype=torch.float32,
                               generator=torch.Generator().manual_seed(0)),
                     dataclasses.replace(train_cfg, fused_blocks=fused))
        (loss, got) = counted(counters, lambda: float(tr.train_step(b)))
        return loss, got, {n: p.grad.float().clone() for n, p in tr.model.named_parameters()
                           if p.grad is not None}

    kl, kern_launches, kern = grads(True, batch)
    tl, _, twin = grads(False, batch)
    _, _, nudged = grads(False, (batch[0] * (1.0 + 2.0 ** -9), batch[1]))
    check(kern_launches["selective_scan_fwd"] == kern_launches["selective_scan_bwd"] == 7,
          "WFB fp32 step: S1 with states and S2 did not run 7 times")
    rel = lambda g, ref: ((g - ref).abs().max() / (ref.abs().max() + 1e-12)).item()  # noqa: E731
    yard = {n: rel(nudged[n], g) for n, g in twin.items()}
    err = {n: rel(kern[n], g) for n, g in twin.items()}
    feb = [n for n in err if "frequency_process" in n]
    allowed = {n: max(3 * yard[n], WFB_GRAD_FLOOR) for n in err}
    bad = [n for n in err if err[n] > allowed[n]]
    fw = max(feb, key=lambda n: err[n] / allowed[n])
    ow = max((n for n in err if n not in feb), key=lambda n: err[n] / allowed[n])
    dl = abs(kl - tl) / abs(tl)
    log(f"WFB train step in fp32 compute, kernel path vs twin path (C10): first loss rel err "
        f"{dl:.3e}; FEB leaves ({len(feb)}) worst against its yardstick {fw} {err[fw]:.3e} "
        f"(nudged twin {yard[fw]:.3e}), largest FEB error {max(err[n] for n in feb):.3e}, "
        f"median FEB error {np.median([err[n] for n in feb]):.3e}; other leaves worst {ow} "
        f"{err[ow]:.3e} (nudged twin {yard[ow]:.3e}); median over all leaves "
        f"{np.median(list(err.values())):.3e}; {len(bad)} leaves beyond max(3 x nudged, "
        f"{WFB_GRAD_FLOOR})")
    check(dl <= TRAIN_LOSS_RTOL, "WFB fp32 step: the first loss disagrees with the twin path")
    check(not bad, f"WFB fp32 step: first-step grads disagree with the twin path: {bad}")


def real_data_phase(dev, card, counters) -> None:
    """Phase 9: the train and eval CLIs on SID-layout trees at full frame
    size, WFB-48 on a ragged frame, the MCR device decode."""
    import importlib.util
    import tempfile

    from bayer_low_light_image_enhancement_tpu_torch.cli import test_cli, train_cli
    from bayer_low_light_image_enhancement_tpu_torch.data.synthetic import (
        mosaic_rggb,
        synth_scene,
        write_sid_tree,
    )
    from bayer_low_light_image_enhancement_tpu_torch.models import get_model
    from bayer_low_light_image_enhancement_tpu_torch.serving import Predictor
    from bayer_low_light_image_enhancement_tpu_torch.train.checkpoint import CheckpointManager
    from bayer_low_light_image_enhancement_tpu_torch.utils.profiling import cuda_time_ms

    def run(what, fn):
        t0 = time.perf_counter()
        out, got = counted(counters, fn)
        log(f"{what}: {time.perf_counter() - t0:.2f} s; launches {got}")
        return out, got

    rng = np.random.default_rng(9)
    have_imageio = importlib.util.find_spec("imageio") is not None
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sid_") as tmp:
        root, ragged = f"{tmp}/sid", f"{tmp}/sid_ragged"
        t0 = time.perf_counter()
        write_sid_tree(root, f"{root}/cache",
                       {"train": [REAL_TRAIN_FRAME] * 8, "test": [REAL_TEST_FRAME] * 2}, rng)
        write_sid_tree(ragged, f"{ragged}/cache", {"test": [REAL_RAGGED_FRAME]}, rng)
        log(f"real data: SID trees written in {time.perf_counter() - t0:.1f} s (8 training pairs "
            f"at {REAL_TRAIN_FRAME}, 2 test pairs at {REAL_TEST_FRAME}, one ragged at "
            f"{REAL_RAGGED_FRAME}; npz cache, codes in [512, 16383], uint16 GT)")

        # The train CLI: compact native batches through the kernel path, then
        # validation at full frame (2 frames, one forward an epoch).
        save = f"{tmp}/run"
        _, tl = run("train CLI, SID, native loader, batch 8 @ 512^2, 2 epochs", lambda: (
            train_cli.main(["--dataset", "SID", "--data_root", root, "--cache_dir",
                            f"{root}/cache", "--loader", "native", "--batch_size", "8",
                            "--patch_size", "512", "--epochs", "1", "--model_size", "S",
                            "--save_dir", save])))
        steps, val_forwards = 2, 2
        check(tl["gram_pass"] == tl["apply_pass"] == 7 * (steps + val_forwards),
              "K2 / K3 did not run 7 times per train step and validation forward")
        check(tl["bwd1"] == tl["bwd2"] == 7 * steps and tl["weight_grad"] == 6 * steps,
              "B1 / B2 / the weight-grad pass did not run on every train step")
        check(tl["bayer_pack_normalize"] == 0, "K1 ran in training (compact batches decode "
              "in the trainer)")
        with open(f"{save}/SID/log.txt") as f:
            check("Epoch 1/1" in f.read(), "train CLI wrote no epoch line")

        # The eval CLI from that checkpoint, compact (K1) and not.
        ckpt = f"{save}/SID/weights"
        base = ["--dataset", "SID", "--data_root", root, "--cache_dir", f"{root}/cache",
                "--ckpt", ckpt]
        if not have_imageio:
            log("imageio is not installed: no JPEG or PNG is written")
        runs = {}
        for name, extra in (("compact", ["--save_images"] if have_imageio else []),
                            ("host", ["--no_compact_h2d"])):
            out, el = run(f"eval CLI, SID, {name} decode, 2 x {REAL_TEST_FRAME}", lambda: (
                test_cli.main(base + extra + ["--save_dir", f"{tmp}/eval_{name}"])))
            with open(f"{tmp}/eval_{name}/SID/csv/test_metrics.csv") as f:
                rows = f.read().splitlines()
            check(len(rows) == 2, f"eval CLI ({name}) wrote {len(rows)} CSV rows, not 2")
            check(el["bayer_pack_normalize"] == (2 if name == "compact" else 0),
                  f"K1 did not run once per image in the {name} run")
            # Canonical RawFormer frames of H >= 1024 take the band route (phase 18).
            check(el["gram_pass_banded"] == el["apply_pass_banded"] == 14
                  and el["gram_pass"] == el["apply_pass"] == 0, f"K2 / K3 in band mode did not "
                  f"run 7 times per image in the {name} eval run")
            check(all(np.isfinite(out["psnr"])), f"eval CLI ({name}) PSNR not finite")
            log(f"eval CLI ({name}): PSNR {out['psnr']}, SSIM {out['ssim']}, host seconds per "
                f"image {[round(t, 3) for t in out['seconds']]} ({card})")
            runs[name] = out
        dp = np.abs(np.subtract(runs["compact"]["psnr"], runs["host"]["psnr"])).max()
        ds = np.abs(np.subtract(runs["compact"]["ssim"], runs["host"]["ssim"])).max()
        log(f"eval CLI compact vs host decode: max PSNR difference {dp:.4f} dB (tol "
            f"{EVAL_PSNR_TOL}), max SSIM difference {ds:.2e} (tol {EVAL_SSIM_TOL})")
        check(dp <= EVAL_PSNR_TOL and ds <= EVAL_SSIM_TOL, "compact eval disagrees with host decode")
        if have_imageio:
            check(len(os.listdir(f"{tmp}/eval_compact/SID/images")) == 4, "eval CLI wrote no JPEGs")

        # One frame: raw_u16 (K1 + the prepacked model) against __call__ of the
        # frame decoded on the host in K1's own fp32 expression, so that both
        # paths feed the model the same bf16 planes; and both forwards' device
        # time. The frame's codes are dark (the scene over the ratio), so the
        # decode stays below the clamp and a doubled ratio must show.
        model = get_model("rawformer_s", device=dev, dtype=torch.bfloat16)
        state, _ = CheckpointManager(ckpt).restore(map_location=dev)
        pred = Predictor(model, state["trainer"]["model"], device=dev)
        with np.load(f"{root}/cache/10000_00_0.1s.ARW.npz") as z:
            m = z["mosaic"]
        host = (np.clip(m.astype(np.float32), 512.0, 16383.0) - np.float32(512.0)) * np.float32(
            1.0 / (16383.0 - 512.0 + 1e-6)) * np.float32(100.0)
        y_u16, y_host = pred.raw_u16(m, 100.0), pred(host)
        d = np.abs(y_u16 - y_host)
        moved = float(np.abs(pred.raw_u16(m, 200.0) - y_u16).max())
        unclamped = float((host < 1.0).mean())
        log(f"raw_u16 vs __call__ of the host-decoded {REAL_TEST_FRAME} frame: max abs err "
            f"{d.max():.3e} (tol {DECODE_TOL}); input below the clamp {unclamped:.1%}; a doubled "
            f"ratio moves the output by {moved:.3e} (must exceed {DECODE_SEEN}); output mean "
            f"{y_host.mean():.4f}, max {y_host.max():.4f}")
        check(y_u16.shape == m.shape + (3,) and d.max() <= DECODE_TOL,
              "raw_u16 disagrees with the host-decoded frame")
        check(unclamped >= 0.9 and moved > DECODE_SEEN,
              "the comparison would not see a wrong ratio: the input is clamped or the output "
              "does not depend on it")
        m_dev, r_dev = u16_to_device(m)[None], torch.full((1,), 100.0, device=dev)
        x_dev = torch.from_numpy(host).to(dev)[None, None]
        with torch.inference_mode():
            ms_u16 = cuda_time_ms(lambda: pred._u16_forward(m_dev, r_dev), 5, warmup=1)
            ms_f32 = cuda_time_ms(lambda: pred.model(x_dev), 5, warmup=1)
        log(f"time RawFormer-S forward, one {REAL_TEST_FRAME} frame on the device: from uint16 "
            f"(K1) {ms_u16:.3f} ms, from the host-decoded fp32 frame {ms_f32:.3f} ms ({card})")

        # MCR: two dark uint8 frames (a scene over each image's amplification,
        # the two of mcr_amplification: 12287 and 1023 over exposure 0x00FF)
        # decoded on the device against the same expression on the host.
        amp = np.array([12287 / 0x00FF, 1023 / 0x00FF], np.float32)
        scenes = [mosaic_rggb(synth_scene(rng, *REAL_MCR_FRAME)) for _ in amp]
        raw8 = np.stack([np.clip(np.round(sc * 255.0 / a), 0, 255) for sc, a in zip(scenes, amp)])
        raw8 = raw8.astype(np.uint8)[..., None]
        host = raw8.astype(np.float32) / 255.0 * amp[:, None, None, None]
        y_mcr, ml = run(f"MCR device decode, two {REAL_MCR_FRAME} uint8 frames",
                        lambda: pred.codes(raw8, amp, "mcr"))
        d = np.abs(y_mcr - pred(host))
        moved = float(np.abs(pred.codes(raw8, 2 * amp, "mcr") - y_mcr).max())
        unclamped = float((host < 1.0).mean())
        log(f"MCR codes vs host decode: max abs err {d.max():.3e} (tol {DECODE_TOL}); input "
            f"below the clamp {unclamped:.1%}, codes up to {raw8.max()}; a doubled "
            f"amplification moves the output by {moved:.3e} (must exceed {DECODE_SEEN})")
        check(ml["gram_pass"] == ml["apply_pass"] == 7 and ml["bayer_pack_normalize"] == 0,
              "the MCR decode did not run K2 / K3 7 times, or ran K1")
        check(d.max() <= DECODE_TOL, "the MCR device decode disagrees with the host decode")
        check(unclamped >= 0.9 and moved > DECODE_SEEN,
              "the MCR comparison would not see a wrong amplification")
        del pred, model, state, m_dev, x_dev
        torch.cuda.empty_cache()

        # WFB-48 (seeded random weights) on the ragged frame: compact SID
        # codes through normalize_sid on the device, pad to 32.
        out, wl = run(f"eval CLI, WFB-48, one ragged {REAL_RAGGED_FRAME} frame", lambda: (
            test_cli.main(["--dataset", "SID", "--data_root", ragged, "--cache_dir",
                           f"{ragged}/cache", "--model", "rawformer_wfb",
                           "--save_dir", f"{tmp}/eval_wfb"])))
        check(out["pad_to"] == 32, "WFB eval did not pad to 32")
        check(wl["selective_scan_fwd"] == 7 and sum(wl.values()) == 7,
              "S1 did not run 7 times for the WFB image, or another kernel ran")
        check(all(np.isfinite(out["psnr"])), "WFB eval PSNR not finite")
        log(f"eval CLI (WFB-48, ragged): PSNR {out['psnr']}, SSIM {out['ssim']}, host seconds "
            f"{[round(t, 3) for t in out['seconds']]} ({card})")


ZOO = ("flca_rawformer", "multilvl_flca_rawformer", "truecolor_rawformer",
       "bayertorgb_rawformer")
ZOO_FRAME_MODELS = ("flca_rawformer", "bayertorgb_rawformer")
ZOO_BATCH = (2, 512, 512)
# The K2 / K3 block shapes of the family at dim 48: stages 1-3 at batch 2 @
# 512^2 and on the 2832x4240 frame (checked in phase 3 on log_temperature
# blocks, as BayerTORGB stores them).
ZOO_BLOCK_SHAPES = [(2, 256, 256, 48), (2, 128, 128, 96), (2, 64, 64, 192),
                    (1, 1416, 2120, 48), (1, 708, 1060, 96), (1, 354, 530, 192)]


def spread_color_correction(model, run) -> None:
    """Move BayerTORGB's bounded colour correction off saturation (no-op for
    other models). At a seeded init the head's output is small, so the
    colour transform is near a constant below 0: the RGB clips to 0
    everywhere and would not see the blocks. On the input ``run()`` feeds
    the colour correction, shift the bias of the colour transform's last
    layer so that each channel's mean is 0.5. Only a bias moves: the map
    keeps the model's own gain from the head to the RGB. (TrueColor's
    plain correction is not clipped at init: its sigmoid tone curve is
    flat, and its RGB varies by ~2e-3.)"""
    cc = getattr(model, "color_correction", None)
    if cc is None or not cc.bounded:
        return
    seen = []
    hook = cc.register_forward_pre_hook(lambda m, a: seen.append(a[0].clone()))
    run()
    hook.remove()
    with torch.no_grad():
        gamma = torch.nn.functional.softplus(cc.gamma_param) + 1e-6
        xg = seen[0].float().clamp(0.0, 1.0).pow(1.0 / gamma.float())
        ct = cc.color_transform
        ct[2].bias.add_(0.5 - ct[2](ct[1](ct[0](xg))).float().mean((0, 2, 3)))


def zoo_phase(dev, card, counters) -> dict:
    """Phase 10: the FLCA / TrueColor family at dim 48 through ``Predictor``;
    returns each forward's launches by model."""
    from bayer_low_light_image_enhancement_tpu_torch.models import get_model
    from bayer_low_light_image_enhancement_tpu_torch.models.common import set_fused_blocks
    from bayer_low_light_image_enhancement_tpu_torch.ops.bayer import normalize_sid
    from bayer_low_light_image_enhancement_tpu_torch.serving import Predictor
    from bayer_low_light_image_enhancement_tpu_torch.utils.profiling import profile

    def check_counts(got, what):
        check(got["gram_pass"] == got["apply_pass"] == 6 and sum(got.values()) == 12,
              f"{what}: K2 / K3 did not run 6 times each, or another kernel ran ({got})")

    def both_paths(model, fn, what):
        """fn() on the kernel path, then on the module path; checks the
        launches, the output and the head's input of the two -> (the kernel
        path's output, its launches, its peak memory in GiB)."""
        heads = []
        hook = model.conv_out.register_forward_hook(lambda m, i, o: heads.append(o.float()))
        torch.cuda.reset_peak_memory_stats()
        y, got = counted(counters, fn)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        check_counts(got, what)
        set_fused_blocks(model, False)
        y0, got0 = counted(counters, fn)
        set_fused_blocks(model, True)
        hook.remove()
        check(sum(got0.values()) == 0, f"{what}: a kernel ran on the module path ({got0})")
        check(y.shape == y0.shape and bool(np.isfinite(y).all()),
              f"{what}: output not finite of shape {y0.shape}")
        d = np.abs(y - y0)
        dh, scale = (heads[0] - heads[1]).abs(), float(heads[1].abs().max())
        log(f"{what}: kernel path vs module path max abs err {d.max():.3e} (tol {E2E_MAX_TOL}), "
            f"mean {d.mean():.3e} (tol {E2E_MEAN_TOL}); output mean {y.mean():.4f}, std "
            f"{y.std():.4f}, {(y <= 0).mean():.4f} of it at 0 and {(y >= 1).mean():.4f} at 1; "
            f"the head's input: max abs err {float(dh.max()):.3e}, mean {float(dh.mean()):.3e} "
            f"against its largest magnitude {scale:.3e} (tol {E2E_MAX_TOL} / {E2E_MEAN_TOL} of "
            f"it); launches {got}")
        check(d.max() <= E2E_MAX_TOL and d.mean() <= E2E_MEAN_TOL,
              f"{what}: kernel path disagrees with the module path")
        check(float(dh.max()) <= E2E_MAX_TOL * scale and float(dh.mean()) <= E2E_MEAN_TOL * scale,
              f"{what}: the head's input on the kernel path disagrees with the module path")
        return y, got, peak

    def timed(model, fn, steps):
        """torch.profiler over fn() on each path, after one warmup call:
        (host ms, device ms, busy %) a call. Each profile costs ~1-3 s of
        host time in the profiler itself, so steps stay few."""
        with torch.inference_mode():
            r = profile(fn, steps, warmup=1)
            set_fused_blocks(model, False)
            r0 = profile(fn, steps, warmup=1)
            set_fused_blocks(model, True)
        return [(q["host_ms"], q["device_ms"], 100 * q["busy"]) for q in (r, r0)]

    rng = np.random.default_rng(10)
    x = rng.uniform(0.0, 1.5, ZOO_BATCH + (1,)).astype(np.float32)
    # A dark SID frame: codes up to 160 above black, [0, 1] at ratio 100.
    frame = (512 + rng.integers(0, 160, REAL_TEST_FRAME)).astype(np.uint16)
    t_phase = time.perf_counter()
    launches = {}
    for name in ZOO:
        t0 = time.perf_counter()
        model = get_model(name, device=dev, dtype=torch.bfloat16,
                          generator=torch.Generator().manual_seed(10))
        pred = Predictor(model, device=dev)
        set_fused_blocks(model, False)
        spread_color_correction(model, lambda: pred(x))
        set_fused_blocks(model, True)
        _, launches[name], _ = both_paths(model, lambda: pred(x),
                                          f"{name} dim 48, {ZOO_BATCH} float mosaics")
        xb = pred._padded(torch.from_numpy(x).to(dev))
        (h, d, busy), (h0, d0, busy0) = timed(model, lambda: pred.model(xb), 3)
        log(f"time {name} dim 48 forward, {ZOO_BATCH} float mosaics (torch.profiler, after "
            f"warmup): kernel path {h:.3f} ms host clock, {d:.3f} ms device ({busy:.1f}% busy); "
            f"module path {h0:.3f} ms host clock, {d0:.3f} ms device ({busy0:.1f}% busy) ({card})")
        try:
            pred.raw_u16(frame[:32, :32], 100.0)
        except TypeError:
            pass
        else:
            check(False, f"{name}: raw_u16 served a model without a prepacked entry")
        if name in ZOO_FRAME_MODELS:
            yf, got, peak = both_paths(
                model, lambda: pred.codes(frame, 100.0, "sid"),
                f"{name} dim 48, one {REAL_TEST_FRAME} SID uint16 frame through Predictor.codes")
            check(yf.shape == REAL_TEST_FRAME + (3,),
                  f"{name}: frame output not of shape {REAL_TEST_FRAME + (3,)}")
            codes = torch.from_numpy(frame.view(np.int16)).to(dev)[None, None]
            xf = normalize_sid(codes.to(torch.int32) & 0xFFFF, 100.0)
            (h, d, busy), (h0, d0, busy0) = timed(model, lambda: pred.model(xf), 2)
            log(f"time {name} dim 48 forward, one {REAL_TEST_FRAME} SID uint16 frame "
                f"(torch.profiler, after warmup): kernel path {h:.3f} ms host clock, {d:.3f} ms "
                f"device ({busy:.1f}% busy); module path {h0:.3f} ms host clock, {d0:.3f} ms "
                f"device ({busy0:.1f}% busy); peak memory of the kernel path's "
                f"Predictor.codes {peak:.2f} GiB; launches {got} "
                f"({torch.cuda.get_device_name(0)}; nvidia-smi: {card})")
        log(f"{name}: {time.perf_counter() - t0:.1f} s")
        del pred, model
        torch.cuda.empty_cache()
    log(f"phase 10: {time.perf_counter() - t_phase:.1f} s ({card})")
    return launches


ZOO_TRAIN_BATCH, ZOO_TIME_BATCH = (2, 256, 256), (8, 512, 512)
# The models whose first-step median sat at or above the bf16 twin path's
# (MEDIAN_YARD): phase 11 holds K2 / K3 and B1 / B2 on each of their blocks'
# own inputs from a step (C12).
C12_MODELS = ("flca_rawformer", "bayertorgb_rawformer")
# The kernel blocks of the family's batch-8 @ 512^2 train step (C = 48, 96,
# 192), where phase 11 times K2 / K3 / B1 / B2 beside their bounds.
ZOO_TIME_SHAPES = [(8, 256, 256, 48), (8, 128, 128, 96), (8, 64, 64, 192)]


def synthetic_batch(dev, b: int, size: int):
    """One synthetic (input, GT) batch of b crops at size^2 through ``Loader``
    + ``prefetch_to_device``, as the trainer is fed."""
    from bayer_low_light_image_enhancement_tpu_torch.data import (
        Loader,
        SyntheticBayerDataset,
        prefetch_to_device,
    )

    ds = SyntheticBayerDataset(num_images=b, full_size=(size + 64, size + 64), patch_size=size,
                               training=True)
    loader = Loader(ds, b, seed=0, num_threads=min(b, 8))
    return next(iter(prefetch_to_device(((i, g) for i, g, _ in loader), dev)))


def fused_block_widths(model) -> list:
    """The widths of the model's TransformerBlocks that run the kernels
    (fused, C <= FUSE_CMAX), one entry a block."""
    from bayer_low_light_image_enhancement_tpu_torch.models import common

    return [c for m in model.modules() if isinstance(m, common.TransformerBlock) and m.fused
            for c in [m.norm1.body.weight.shape[0]] if c <= common.FUSE_CMAX]


def block_kernel_times(x, dy, wts, card, what) -> dict:
    """K2, K3, B1 and B2 (the weight-grad pass inside B1 / B2 at C >= 96) as
    whole wrapper calls on x [b, h, w, C] bf16 with dy (CUDA events over 10
    calls after warmup), beside their fp32 twins (3 calls) and their bounds;
    logs one line. -> {"gram" | "apply" | "bwd1" | "bwd2": (ms, twin ms,
    (bound ms, bound by))}."""
    from bayer_low_light_image_enhancement_tpu_torch.kernels import fused_block as fb
    from bayer_low_light_image_enhancement_tpu_torch.kernels import fused_block_bwd as fbb
    from bayer_low_light_image_enhancement_tpu_torch.utils.profiling import cuda_time_ms

    names = {"gram": "K2", "apply": "K3", "bwd1": "B1", "bwd2": "B2"}
    g0, qs0, ks0 = fb.gram_pass_plain(x, wts)
    apply = fb.finalize_attention(g0, qs0, ks0, wts.temperature, wts.wproj, 8)
    dx2, d_apply, _ = fbb.bwd1(x, dy, apply, wts)
    d = fbb.finalize_backward(g0, qs0, ks0, wts.temperature, wts.wproj, d_apply, 8)
    dx2 = dx2.to(torch.bfloat16)
    calls = {"gram": (lambda: fb.gram_pass(x, wts), lambda: fb.gram_pass_plain(x, wts)),
             "apply": (lambda: fb.apply_pass(x, apply, wts),
                       lambda: fb.apply_pass_plain(x, apply, wts)),
             "bwd1": (lambda: fbb.bwd1(x, dy, apply, wts),
                      lambda: fbb.bwd1_plain(x, dy, apply, wts)),
             "bwd2": (lambda: fbb.bwd2(x, dx2, apply, *d[:3], wts),
                      lambda: fbb.bwd2_plain(x, dx2, apply, *d[:3], wts))}
    out, parts = {}, []
    for kind, (kern, twin) in calls.items():
        ms, twin_ms = cuda_time_ms(kern, 10), cuda_time_ms(twin, 3, warmup=1)
        b_ms, by = bound(**block_counts(kind, *x.shape))
        out[kind] = (ms, twin_ms, (b_ms, by))
        parts.append(f"{names[kind]} {ms:.4f} ms (twin {twin_ms:.3f}; bound {b_ms:.4f} by {by})")
    log(f"time {list(x.shape)} bf16 ({what}, whole wrapper calls, CUDA events): "
        + "; ".join(parts) + f" ({card})")
    return out


def zoo_kernel_times(dev, card) -> None:
    """``block_kernel_times`` at ZOO_TIME_SHAPES on a seeded
    log_temperature block."""
    from bayer_low_light_image_enhancement_tpu_torch.kernels import fused_block as fb
    from bayer_low_light_image_enhancement_tpu_torch.models import common

    gen = torch.Generator().manual_seed(14)
    with torch.no_grad():
        for shape in ZOO_TIME_SHAPES:
            blk = common.TransformerBlock(shape[-1], 8, 2, log_temperature=True, device=dev)
            common.reset_parameters_(blk, gen)
            wts = fb.fold_block_params({k: v.detach() for k, v in blk.named_parameters()})
            x = torch.randn(shape, generator=gen).to(dev, torch.bfloat16)
            dy = (0.05 * torch.randn(shape, generator=gen)).to(dev, torch.bfloat16)
            block_kernel_times(x, dy, wts, card, "the family's block")
            del x, dy, blk
    torch.cuda.empty_cache()


def zoo_train_phase(dev, card, counters, train_cfg) -> dict:
    """Phase 11: the FLCA / TrueColor family at dim 48 trains through
    ``Trainer`` on the kernel path (K2 / K3 forward, B1 / B2 and the
    weight-grad pass backward); returns each step's launches by model."""
    from bayer_low_light_image_enhancement_tpu_torch.kernels import fused_block_bwd as fbb
    from bayer_low_light_image_enhancement_tpu_torch.models import get_model
    from bayer_low_light_image_enhancement_tpu_torch.models.common import set_fused_blocks
    from bayer_low_light_image_enhancement_tpu_torch.train import Trainer
    from bayer_low_light_image_enhancement_tpu_torch.utils.profiling import cuda_time_ms, profile

    t_phase = time.perf_counter()
    small = synthetic_batch(dev, *ZOO_TRAIN_BATCH[:2])
    big = synthetic_batch(dev, *ZOO_TIME_BATCH[:2])
    launches = {}
    for name in ZOO:
        t0 = time.perf_counter()
        base = get_model(name, device=dev, dtype=torch.bfloat16,
                         generator=torch.Generator().manual_seed(11))
        set_fused_blocks(base, False)
        with torch.no_grad():
            spread_color_correction(base, lambda: base(small[0].permute(0, 3, 1, 2)))
        set_fused_blocks(base, True)
        init = {k: v.clone() for k, v in base.state_dict().items()}
        widths = fused_block_widths(base)
        del base

        def make():
            m = get_model(name, device=dev, dtype=torch.bfloat16,
                          generator=torch.Generator().manual_seed(11))
            m.load_state_dict(init)
            return m

        # Each kernel block runs K2 / K3 forward and B1 / B2 backward once a
        # step, the weight-grad pass twice (B1's products, B2's) at the
        # split widths; nothing else launches.
        want = dict.fromkeys((c.__name__ for c in counters), 0)
        want.update(gram_pass=len(widths), apply_pass=len(widths), bwd1=len(widths),
                    bwd2=len(widths),
                    weight_grad=2 * sum(fbb.weight_grad_regime(c) == "split" for c in widths))
        what = f"{name} dim 48 train step, batch {ZOO_TRAIN_BATCH[0]} @ {ZOO_TRAIN_BATCH[1]}^2"
        kern, losses, got = held_train_step(make, train_cfg, small, counters, what,
                                            show=lambda n: "log_temperature" in n,
                                            median_yard=MEDIAN_YARD)
        log(f"{what}: launches {got} (kernel blocks at widths {widths})")
        check(got == want, f"{what}: launches {got}, expected {want}")
        launches[name] = got
        if name in C12_MODELS:
            tr = Trainer(make(), train_cfg)
            hold_captured_blocks(capture_blocks(tr.model, lambda: tr.train_step(small)),
                                 f"{what}, C12")
            del tr
        for _ in range(18):
            losses.append(float(kern.train_step(small)))
        log(f"{name} 20 steps on one batch: loss {losses[0]:.5f} -> {losses[-1]:.5f}; "
            f"{kern.step - kern.applied} of {kern.step} steps skipped by the NaN guard")
        check(bool(np.isfinite(losses).all()) and losses[-1] < losses[0],
              f"{name}: 20 steps on one batch did not lower its loss")
        check(kern.applied == kern.step == 20, f"{name}: the NaN guard skipped a step")
        del kern

        for path in ("kernel", "module"):
            tr = Trainer(make(), dataclasses.replace(train_cfg, fused_blocks=path == "kernel"))
            tr.train_step(big)
            ms, peak, held = peak_memory(lambda: cuda_time_ms(lambda: tr.train_step(big), 2,
                                                              warmup=1))
            split = ""
            if path == "kernel":
                r = profile(lambda: tr.train_step(big), 1, warmup=0)
                bwd = sum(t for k, t, _ in r["kernels"]
                          if re.search(r"bwd[12]_kernel|sum_partials_kernel", k))
                wg = sum(t for k, t, _ in r["kernels"] if "weight_grad_kernel" in k)
                split = (f"; one profiled step: {r['device_ms']:.3f} ms of device time in "
                         f"{r['host_ms']:.3f} ms of host clock ({100 * r['busy']:.1f}% busy, "
                         f"{sum(c for _, _, c in r['kernels']):.0f} kernels), B1 + B2 "
                         f"{bwd:.3f} ms ({bwd / r['device_ms']:.1%} of the device time), the "
                         f"weight-grad pass {wg:.3f} ms")
            log(f"time {name} dim 48 train step, batch {ZOO_TIME_BATCH[0]} @ "
                f"{ZOO_TIME_BATCH[1]}^2, {path} path (CUDA events, after warmup): {ms:.3f} ms, "
                f"{ZOO_TIME_BATCH[0] * ZOO_TIME_BATCH[1] ** 2 / 1e6 / ms * 1e3:.1f} MP/s, peak "
                f"memory {peak:.2f} GiB, {peak - held:.2f} above the {held:.2f} held before"
                f"{split} ({torch.cuda.get_device_name(0)}; nvidia-smi: {card})")
            del tr
            torch.cuda.empty_cache()
        log(f"{name}: {time.perf_counter() - t0:.1f} s")
    zoo_kernel_times(dev, card)
    log(f"phase 11: {time.perf_counter() - t_phase:.1f} s ({card})")
    return launches


# Phase 12: the two models without a TransformerBlock, at dim 48 with their
# default heads; each serves and trains through chunked plain modules, held
# against a second chunk size.
PLAIN_ZOO = ("luma_mhsa_rawformer", "wavkan_rawformer")
OTHER_CHUNK_BYTES = 1 << 28


def held_chunk_step(make_model, train_cfg, batch, counters, what, median_yard: float = 0.0,
                    other: int = OTHER_CHUNK_BYTES):
    """Phase 12's rule (phase 6's): trainers of ``make_model()`` (its
    default chunks) and ``make_model(other)`` take one step on ``batch``
    and launch no hand kernel. Checks the first loss within
    TRAIN_LOSS_RTOL; every first-step grad leaf within max(3 x the change of
    a ``make_model(other)`` trainer whose input is nudged by half a bf16
    ulp, WFB_GRAD_FLOOR) of the other's leaf max; the median
    over the leaves within WFB_GRAD_MEDIAN_TOL, or ``median_yard`` x the
    nudged run's median where that is larger; the BN running stats within
    WFB_BN_TOL of their max. -> (the default-chunk trainer, its loss)."""
    from bayer_low_light_image_enhancement_tpu_torch.train import Trainer

    def step(chunk, b):
        tr = Trainer(make_model() if chunk is None else make_model(chunk), train_cfg)
        loss, got = counted(counters, lambda: float(tr.train_step(b)))
        no_kernel(got, what)
        return tr, loss, {n: p.grad.float().clone() for n, p in tr.model.named_parameters()}

    kern, first, grads = step(None, batch)
    second, other_first, other_grads = step(other, batch)
    _, _, nudged = step(other, (batch[0] * (1.0 + 2.0 ** -9), batch[1]))
    rel = lambda g, ref: ((g - ref).abs().max() / (ref.abs().max() + 1e-12)).item()  # noqa: E731
    yard = {n: rel(nudged[n], g) for n, g in other_grads.items()}
    grad_err = {n: rel(grads[n], g) for n, g in other_grads.items()}
    allowed = {n: max(3 * yard[n], WFB_GRAD_FLOOR) for n in grad_err}
    worst = max(grad_err, key=lambda n: grad_err[n] / allowed[n])
    bad = [n for n in grad_err if grad_err[n] > allowed[n]]
    median = float(np.median(list(grad_err.values())))
    yard_median = float(np.median(list(yard.values())))
    median_tol = max(WFB_GRAD_MEDIAN_TOL, median_yard * yard_median)
    sk, so = kern.model.state_dict(), second.model.state_dict()
    stats = [n for n in sk if "running" in n]
    dbn = max((((sk[n] - so[n]).abs().max() / so[n].abs().max()).item() for n in stats),
              default=0.0)
    dl = abs(first - other_first) / abs(other_first)
    log(f"{what}, default chunks vs {other / 2 ** 20:g} MiB: first loss {first} vs "
        f"{other_first} (rel err {dl:.3e}, tol {TRAIN_LOSS_RTOL}); first-step grads of the other's "
        f"leaf max, worst against its yardstick {worst} {grad_err[worst]:.3e} (nudged "
        f"{yard[worst]:.3e}, floor {WFB_GRAD_FLOOR}); median {median:.3e} (tol {median_tol:.3e}; "
        f"nudged {yard_median:.3e}); {len(stats)} BN running stats within {dbn:.3e} of their max "
        f"(tol {WFB_BN_TOL}); no hand kernel launched")
    check(dl <= TRAIN_LOSS_RTOL, f"{what}: the first loss differs between chunk sizes")
    check(not bad and median <= median_tol,
          f"{what}: first-step grads differ between chunk sizes: {bad}")
    check(dbn <= WFB_BN_TOL, f"{what}: BN running stats differ between chunk sizes")
    return kern, first


def plain_zoo_phase(dev, card, counters, train_cfg) -> None:
    """Phase 12: ``luma_mhsa_rawformer`` and ``wavkan_rawformer`` serve a
    batch-2 @ 512^2 request and train at batch 2 @ 256^2 (in bf16 and, for
    the absolute median bar, in fp32 compute), their chunked token
    attention / KAN layers at the default chunk against OTHER_CHUNK_BYTES;
    no hand kernel launches."""
    from bayer_low_light_image_enhancement_tpu_torch.models import get_model
    from bayer_low_light_image_enhancement_tpu_torch.models.common import set_chunk_bytes
    from bayer_low_light_image_enhancement_tpu_torch.serving import Predictor
    from bayer_low_light_image_enhancement_tpu_torch.utils.profiling import cuda_time_ms, profile

    t_phase = time.perf_counter()
    rng = np.random.default_rng(12)
    x = rng.uniform(0.0, 1.5, ZOO_BATCH + (1,)).astype(np.float32)
    small = synthetic_batch(dev, *ZOO_TRAIN_BATCH[:2])
    for name in PLAIN_ZOO:
        t0 = time.perf_counter()

        def make(chunk_bytes=None, dtype=torch.bfloat16):
            m = get_model(name, device=dev, dtype=dtype,
                          generator=torch.Generator().manual_seed(12))
            if chunk_bytes is not None:
                set_chunk_bytes(m, chunk_bytes)
            return m

        # Serving: the default chunks against OTHER_CHUNK_BYTES, the same weights.
        pred = Predictor(make(), device=dev)
        what = f"{name} dim 48, {ZOO_BATCH} float mosaics"
        (y, got), peak, held = peak_memory(lambda: counted(counters, lambda: pred(x)))
        no_kernel(got, what)
        check(y.shape == x.shape[:3] + (3,) and bool(np.isfinite(y).all()) and y.min() >= 0.0
              and y.max() <= 1.0, f"{what}: output not finite in [0, 1] of shape {y.shape}")
        set_chunk_bytes(pred.model, OTHER_CHUNK_BYTES)
        y2, got = counted(counters, lambda: pred(x))
        no_kernel(got, what)
        d = np.abs(y - y2)
        log(f"{what}: default chunks vs {OTHER_CHUNK_BYTES >> 20} MiB chunks max abs err "
            f"{d.max():.3e} (tol {E2E_MAX_TOL}), mean {d.mean():.3e} (tol {E2E_MEAN_TOL}); output "
            f"mean {y.mean():.4f}, std {y.std():.4f}; no hand kernel launched")
        check(d.max() <= E2E_MAX_TOL and d.mean() <= E2E_MEAN_TOL,
              f"{what}: the chunk sizes disagree")
        xb = pred._padded(torch.from_numpy(x).to(dev))
        with torch.inference_mode():  # warm: the two requests ran the same shapes
            r = profile(lambda: pred.model(xb), 1, warmup=0)
        log(f"time {name} dim 48 forward, {ZOO_BATCH} float mosaics (torch.profiler, after "
            f"two requests, {OTHER_CHUNK_BYTES >> 20} MiB chunks): {r['host_ms']:.3f} ms host "
            f"clock, {r['device_ms']:.3f} ms device ({100 * r['busy']:.1f}% busy); peak memory of "
            f"Predictor.__call__ at the default chunks {peak:.2f} GiB, {peak - held:.2f} above "
            f"the {held:.2f} held before ({torch.cuda.get_device_name(0)}; nvidia-smi: {card})")
        del pred, xb
        torch.cuda.empty_cache()

        # Training: first-step grads and BN running stats of the default
        # chunks against OTHER_CHUNK_BYTES, in bf16 and in fp32 compute.
        kern, first = held_chunk_step(make, train_cfg, small, counters, f"{name} train step, batch "
                                      f"{ZOO_TRAIN_BATCH[0]} @ {ZOO_TRAIN_BATCH[1]}^2",
                                      median_yard=MEDIAN_YARD)
        held_chunk_step(lambda chunk=None: make(chunk, torch.float32), train_cfg, small, counters,
                        f"{name} train step in fp32 compute, batch {ZOO_TRAIN_BATCH[0]} @ "
                        f"{ZOO_TRAIN_BATCH[1]}^2")
        torch.cuda.empty_cache()

        losses = [first]
        step_ms, peak, held = peak_memory(
            lambda: cuda_time_ms(lambda: losses.append(kern.train_step(small)), 2, warmup=1))
        while len(losses) < 20:
            losses.append(kern.train_step(small))
        losses = [float(v) for v in losses]
        log(f"{name} 20 steps on one batch: loss {losses[0]:.5f} -> {losses[-1]:.5f}; "
            f"{kern.step - kern.applied} of {kern.step} steps skipped by the NaN guard")
        check(bool(np.isfinite(losses).all()) and losses[-1] < losses[0],
              f"{name}: 20 steps on one batch did not lower its loss")
        check(kern.applied == kern.step == 20, f"{name}: the NaN guard skipped a step")
        log(f"time {name} dim 48 train step, batch {ZOO_TRAIN_BATCH[0]} @ {ZOO_TRAIN_BATCH[1]}^2 "
            f"(CUDA events, after warmup, default chunks): {step_ms:.3f} ms, peak memory "
            f"{peak:.2f} GiB, {peak - held:.2f} above the {held:.2f} held before "
            f"({torch.cuda.get_device_name(0)}; nvidia-smi: {card})")
        del kern
        torch.cuda.empty_cache()
        log(f"{name}: {time.perf_counter() - t0:.1f} s")
    log(f"phase 12: {time.perf_counter() - t_phase:.1f} s ({card})")


# Phase 13: the four raw-domain models at their JAX default widths; packed
# planes in and out, no TransformerBlock and no hand kernel. Serving at
# packed 256^2 (512^2 mosaics), a packed SID frame for the two bottleneck-
# attention U-Nets, training at packed 128^2.
RAW_ZOO = ("flca_unet", "unet_luma_dwt", "simple_flca_unet", "lumachroma_transformer")
RAW_ZOO_FRAME_MODELS = ("flca_unet", "unet_luma_dwt")
RAW_BATCH, RAW_TRAIN_BATCH, RAW_FRAME = (2, 256, 256), (2, 128, 128), (1, 1416, 2120)
RAW_TRAIN_STEPS = 20
# The largest token attention of the phase: lumachroma_transformer's
# enc1.trans at packed 256^2, [B, heads, N, head dim] bf16.
SDPA_SHAPE = (2, 4, 65536, 12)


def packed_pairs(dev, b: int, size: int):
    """Packed (input, target) pairs [b, size, size, 4] for the raw-domain
    models: the synthetic batch's mosaic at 2 size packed RGGB (R, G1, G2,
    B), and its RGB target sampled on the same sites."""
    inp, gt = synthetic_batch(dev, b, 2 * size)
    x = torch.nn.functional.pixel_unshuffle(inp.permute(0, 3, 1, 2), 2)
    y = torch.stack([gt[:, 0::2, 0::2, 0], gt[:, 0::2, 1::2, 1], gt[:, 1::2, 0::2, 1],
                     gt[:, 1::2, 1::2, 2]], -1)
    return x.permute(0, 2, 3, 1).contiguous(), y.contiguous()


def sdpa_beside_chunks(dev, card) -> None:
    """Time ``F.scaled_dot_product_attention`` beside the port's chunked
    token attention (flax's dtypes) at SDPA_SHAPE: a library measurement
    only, no model calls SDPA. Head dim 12 is off the fused backends'
    grid of 8, so SDPA also runs on q / k / v zero-padded to 16 with the
    scale of 12 (the same function)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from bayer_low_light_image_enhancement_tpu_torch.models.luma_variants import (
        ATTN_CHUNK_BYTES,
        token_attention,
    )
    from bayer_low_light_image_enhancement_tpu_torch.utils.profiling import cuda_time_ms

    gen = torch.Generator().manual_seed(13)
    q, k, v = (torch.randn(SDPA_SHAPE, generator=gen).to(dev, torch.bfloat16) for _ in "qkv")
    with torch.inference_mode():
        ref = token_attention(q, k, v, ATTN_CHUNK_BYTES, fp32_scores=False)
        chunk_ms = cuda_time_ms(
            lambda: token_attention(q, k, v, ATTN_CHUNK_BYTES, fp32_scores=False), 3, warmup=1)
        log(f"time token attention {list(SDPA_SHAPE)} bf16, the port's chunks "
            f"({ATTN_CHUNK_BYTES >> 20} MiB of bf16 scores a chunk; flax's dtypes): "
            f"{chunk_ms:.3f} ms ({card})")
        pad = lambda t: torch.nn.functional.pad(t, (0, 16 - t.shape[-1]))  # noqa: E731
        for dh, args in ((12, (q, k, v)), (16, (pad(q), pad(k), pad(v)))):
            for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                            SDPBackend.CUDNN_ATTENTION):
                def run():
                    with sdpa_kernel([backend]):
                        return torch.nn.functional.scaled_dot_product_attention(
                            *args, scale=12 ** -0.5)[..., :12]
                try:
                    out = run()
                except RuntimeError as e:  # a library backend's shape gate, not a check
                    log(f"SDPA {backend.name} at head dim {dh}: not available "
                        f"({str(e).splitlines()[0][:120]})")
                    continue
                ms = cuda_time_ms(run, 3, warmup=1)
                err = (out.float() - ref.float()).abs().max().item()
                log(f"time SDPA {backend.name} at head dim {dh} (library, beside the chunks): "
                    f"{ms:.3f} ms, max abs diff from the chunked attention {err:.3e} ({card})")
    del q, k, v, ref
    torch.cuda.empty_cache()


def raw_zoo_phase(dev, card, counters, train_cfg) -> None:
    """Phase 13: the four raw-domain models (fp32 params, bf16 compute,
    seeded random weights) serve a batch-2 request of packed 256^2 planes
    (the default chunks against OTHER_CHUNK_BYTES, the bar scaled to the
    output's largest magnitude: packed planes are not in [0, 1]), the two
    bottleneck-attention U-Nets a packed 2832x4240 SID frame, and each
    trains at batch 2 @ packed 128^2 (``held_chunk_step`` in bf16 with the
    median against MEDIAN_YARD x the nudged run's, and in fp32 compute by
    the full rule; RAW_TRAIN_STEPS steps lower the loss with no NaN-guard
    skip); no hand kernel launches. Then SDPA beside the chunked attention."""
    from bayer_low_light_image_enhancement_tpu_torch.models import get_model
    from bayer_low_light_image_enhancement_tpu_torch.models.common import set_chunk_bytes
    from bayer_low_light_image_enhancement_tpu_torch.models.luma_variants import (
        ATTN_CHUNK_BYTES,
    )
    from bayer_low_light_image_enhancement_tpu_torch.utils.profiling import cuda_time_ms, profile

    def finite(y, shape, what):
        check(tuple(y.shape) == shape and bool(torch.isfinite(y).all()),
              f"{what}: output not finite of shape {shape} ({tuple(y.shape)})")

    t_phase = time.perf_counter()
    rng = np.random.default_rng(13)
    x = torch.from_numpy(rng.uniform(0.0, 1.5, RAW_BATCH + (4,)).astype(np.float32)).to(dev)
    frame = torch.from_numpy(rng.uniform(0.0, 1.5, RAW_FRAME + (4,)).astype(np.float32)).to(dev)
    pairs = packed_pairs(dev, *RAW_TRAIN_BATCH[:2])
    for name in RAW_ZOO:
        t0 = time.perf_counter()

        def make(chunk_bytes=None, dtype=torch.bfloat16):
            m = get_model(name, device=dev, dtype=dtype,
                          generator=torch.Generator().manual_seed(13))
            if chunk_bytes is not None:
                set_chunk_bytes(m, chunk_bytes)
            return m

        # Serving: the default chunks against OTHER_CHUNK_BYTES, the same weights.
        model = make()
        what = f"{name}, {RAW_BATCH[0]} x packed {RAW_BATCH[1]}x{RAW_BATCH[2]}"
        xt = x.permute(0, 3, 1, 2)
        with torch.inference_mode():
            (y, got), peak, held = peak_memory(lambda: counted(counters, lambda: model(xt)))
            no_kernel(got, what)
            finite(y, tuple(xt.shape), what)
            set_chunk_bytes(model, OTHER_CHUNK_BYTES)
            y2, got = counted(counters, lambda: model(xt))
            no_kernel(got, what)
            set_chunk_bytes(model, ATTN_CHUNK_BYTES)
            scale = y.abs().max().item()
            d = (y - y2).abs()
            log(f"{what}: default chunks vs {OTHER_CHUNK_BYTES >> 20} MiB chunks max abs err "
                f"{d.max().item():.3e}, mean {d.mean().item():.3e} (tols {E2E_MAX_TOL} / "
                f"{E2E_MEAN_TOL} x the output's max {scale:.3f}); output mean "
                f"{y.mean().item():.4f}, std {y.float().std().item():.4f}; no hand kernel "
                "launched")
            check(d.max().item() <= E2E_MAX_TOL * scale and d.mean().item() <= E2E_MEAN_TOL * scale,
                  f"{what}: the chunk sizes disagree")
            r = profile(lambda: model(xt), 1, warmup=0)
        log(f"time {name} forward, {what} bf16 (torch.profiler, after two requests, default "
            f"chunks): {r['host_ms']:.3f} ms host clock, {r['device_ms']:.3f} ms device "
            f"({100 * r['busy']:.1f}% busy, {sum(c for _, _, c in r['kernels']):.0f} kernels); "
            f"peak memory {peak:.2f} GiB, {peak - held:.2f} above the {held:.2f} held before "
            f"({torch.cuda.get_device_name(0)}; nvidia-smi: {card})")
        del y, y2
        if name in RAW_ZOO_FRAME_MODELS:
            ft = frame.permute(0, 3, 1, 2)
            what = f"{name}, one packed {RAW_FRAME[1]}x{RAW_FRAME[2]} SID frame"
            with torch.inference_mode():
                (y, got), peak, held = peak_memory(lambda: counted(counters, lambda: model(ft)))
                no_kernel(got, what)
                finite(y, tuple(ft.shape), what)
                r = profile(lambda: model(ft), 1, warmup=0)
            log(f"time {name} forward, {what} (2832x4240 mosaic) bf16 (torch.profiler, after one "
                f"frame): {r['host_ms']:.3f} ms host clock, {r['device_ms']:.3f} ms device "
                f"({100 * r['busy']:.1f}% busy); peak memory {peak:.2f} GiB, {peak - held:.2f} "
                f"above the {held:.2f} held before ({torch.cuda.get_device_name(0)}; "
                f"nvidia-smi: {card})")
            del y
        del model
        torch.cuda.empty_cache()

        # Training: first-step grads of the default chunks against
        # OTHER_CHUNK_BYTES, in bf16 and in fp32 compute.
        what = f"{name} train step, batch {RAW_TRAIN_BATCH[0]} @ packed {RAW_TRAIN_BATCH[1]}^2"
        kern, first = held_chunk_step(make, train_cfg, pairs, counters, what,
                                      median_yard=MEDIAN_YARD)
        held_chunk_step(lambda chunk=None: make(chunk, torch.float32), train_cfg, pairs, counters,
                        f"{what} in fp32 compute")
        losses = [first]
        step_ms, peak, held = peak_memory(
            lambda: cuda_time_ms(lambda: losses.append(kern.train_step(pairs)), 2, warmup=1))
        while len(losses) < RAW_TRAIN_STEPS:
            losses.append(kern.train_step(pairs))
        losses = [float(v) for v in losses]
        log(f"{name} {RAW_TRAIN_STEPS} steps on one batch: loss {losses[0]:.5f} -> "
            f"{losses[-1]:.5f}; {kern.step - kern.applied} of {kern.step} steps skipped by the "
            "NaN guard")
        check(bool(np.isfinite(losses).all()) and losses[-1] < losses[0],
              f"{name}: {RAW_TRAIN_STEPS} steps on one batch did not lower its loss")
        check(kern.applied == kern.step == RAW_TRAIN_STEPS, f"{name}: the NaN guard skipped a step")
        log(f"time {what} (CUDA events, after warmup, default chunks): {step_ms:.3f} ms, peak "
            f"memory {peak:.2f} GiB, {peak - held:.2f} above the {held:.2f} held before "
            f"({torch.cuda.get_device_name(0)}; nvidia-smi: {card})")
        del kern
        torch.cuda.empty_cache()
        log(f"{name}: {time.perf_counter() - t0:.1f} s")
    sdpa_beside_chunks(dev, card)
    log(f"phase 13: {time.perf_counter() - t_phase:.1f} s ({card})")


# Phase 14: serving artifacts (``serving/export.py``) of RawFormer-S (batch
# 8 @ 512^2 and a 2832x4240 frame, tiled and pipelined), WFB-48 (batch 2 @
# 512^2) and ``flca_rawformer`` at dim 48 (batch 2 @ 512^2), seeded random
# weights, bf16 compute; each is loaded in a fresh process (``EXPORT_CHILD``)
# and held against ``Predictor`` on the same frames: the same kernels on the
# same inputs, so ARTIFACT_TOL on [0, 1] RGB.
ARTIFACT_TOL = 1e-3
# The artifacts timed against Predictor in this process (phase 14).
TIMED_ARTIFACTS = ("rawformer_s_tiled", "flca_rawformer")
S_BATCH, S_FRAME, WFB_BATCH = (8, 512, 512), (1, 2832, 4240), (2, 512, 512)
DISPATCH_CALLS, DISPATCH_TURNS = 20, 30
# K2 / K3 (or K3P) 7 times a RawFormer-S forward, 6 a flca_rawformer forward
# (its C = 384 block takes the module path), S1 7 times a WFB forward.
ARTIFACT_LAUNCHES = {
    "rawformer_s_tiled": {"gram_pass": 7, "apply_pass": 7},
    "rawformer_s_pipelined": {"gram_pass": 7, "apply_pass_pipelined": 7},
    "rawformer_wfb": {"selective_scan_fwd": 7},
    "flca_rawformer": {"gram_pass": 6, "apply_pass": 6},
}
# Run by phase 14 as `python -c EXPORT_CHILD <dir>` from the repository root:
# loads each artifact of <dir>/cases.json through load_artifact alone (no
# model class, no checkpoint), runs it on the case's input, compares with
# the Predictor output saved beside it and counts every kernel's launches
# in that call; prints one JSON line.
EXPORT_CHILD = r"""
import json, sys, time
import numpy as np
import torch
from bayer_low_light_image_enhancement_tpu_torch.serving.export import load_artifact
from bayer_low_light_image_enhancement_tpu_torch.kernels import (
    bayer_pack, fused_block, fused_block_bwd, ssm_scan, weight_grad)
counters = (bayer_pack.bayer_pack_normalize, fused_block.gram_pass, fused_block.apply_pass,
            fused_block.apply_pass_pipelined, weight_grad.weight_grad, fused_block_bwd.bwd1,
            fused_block_bwd.bwd2, ssm_scan.selective_scan_fwd, ssm_scan.selective_scan_bwd)
# Predictor's run in the parent has TF32 off; so has this one (WFB's FEB
# runs fp32 convolutions, which cuDNN would take in TF32 by default).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
root = sys.argv[1]
out = {}
for case in json.load(open(root + "/cases.json")):
    t0 = time.perf_counter()
    fn, meta = load_artifact(f"{root}/{case['artifact']}")
    load_s = time.perf_counter() - t0
    x = np.load(f"{root}/{case['input']}")
    fn(x)  # the first call builds nothing: the library is in the package's _build
    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0
    y = fn(x)
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters if c.launches}
    want = np.load(f"{root}/{case['want']}")
    out[case["name"]] = {"launches": launches, "load_s": load_s, "shape": list(y.shape),
                         "finite": bool(np.isfinite(y).all()),
                         "max_abs_err": float(np.abs(y - want).max()),
                         "mean_abs_err": float(np.abs(y - want).mean()), "meta": meta}
print(json.dumps(out), flush=True)
"""


def dispatch_costs(dev, card) -> None:
    """Host microseconds a call of each wrapper (through its torch.ops.blle
    operator), of the operator called directly and of the kernel function
    it dispatches to, at [8,256,256,32] (K2, K3) and WFB-48's stage-1 scan
    [6,16384,96,32] (S1): ``DISPATCH_CALLS`` calls right after a
    synchronisation, so that the launch queue takes them without waiting on
    the card, in turns; each variant's excess over the kernel function in
    the same turn, median and quartiles over ``DISPATCH_TURNS`` turns (the
    host's noise is of the size of the excess)."""
    from bayer_low_light_image_enhancement_tpu_torch.kernels import fused_block as fb
    from bayer_low_light_image_enhancement_tpu_torch.kernels import ssm_scan as ssk
    from bayer_low_light_image_enhancement_tpu_torch.models import common

    g = torch.Generator().manual_seed(14)
    blk = common.TransformerBlock(32, 8, 2, device=dev)
    common.reset_parameters_(blk, g)
    w = fb.fold_block_params({k: v.detach() for k, v in blk.named_parameters()})
    x = torch.randn(BATCH_SHAPES[0], generator=g).to(dev, torch.bfloat16)
    apply = fb.finalize_attention(*fb.gram_pass_plain(x, w), w.temperature, w.wproj, 8)
    b, L, d = SCAN_SHAPES[0]
    u, dt = (torch.randn(b, L, d, generator=g).to(dev, torch.bfloat16) for _ in "12")
    dt = torch.nn.functional.softplus(dt.float()).to(torch.bfloat16)
    A = -torch.rand(d, 32, generator=g).add(0.5).to(dev)
    Bm, Cm = (torch.randn(b, L, 32, generator=g).to(dev, torch.bfloat16) for _ in "12")
    D = torch.ones(d, device=dev)
    gt, at = w.gram_tensors(), w.apply_tensors()
    cases = {
        "K2": [("wrapper", lambda: fb.gram_pass(x, w)),
               ("operator", lambda: torch.ops.blle.gram_pass(x, *gt)),
               ("kernel function", lambda: fb._gram_pass_kernel(x, *gt))],
        "K3": [("wrapper", lambda: fb.apply_pass(x, apply, w)),
               ("operator", lambda: torch.ops.blle.apply_pass(x, apply, *at)),
               ("kernel function", lambda: fb._apply_pass_kernel(x, apply, *at))],
        "S1": [("wrapper", lambda: ssk.selective_scan_fwd(u, dt, A, Bm, Cm, D)),
               ("operator", lambda: torch.ops.blle.selective_scan_fwd(u, dt, A, Bm, Cm, D)),
               ("kernel function", lambda: ssk._fwd_kernel(u, dt, A, Bm, Cm, D, False))],
    }
    with torch.inference_mode():
        for kernel, fns in cases.items():
            us = {name: [] for name, _ in fns}
            for turn in range(DISPATCH_TURNS):
                for name, fn in (fns if turn % 2 == 0 else fns[::-1]):
                    fn()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(DISPATCH_CALLS):
                        fn()
                    us[name].append((time.perf_counter() - t0) * 1e6 / DISPATCH_CALLS)
                    torch.cuda.synchronize()
            base = np.array(us["kernel function"])
            above = {name: np.percentile(np.array(us[name]) - base, [25, 50, 75])
                     for name in ("operator", "wrapper")}
            shape = list(SCAN_SHAPES[0]) + [32] if kernel == "S1" else list(BATCH_SHAPES[0])
            log(f"dispatch {kernel} ({shape} bf16): host us a call over {DISPATCH_TURNS} turns "
                f"of {DISPATCH_CALLS} calls, medians "
                + ", ".join(f"{k} {np.median(v):.2f}" for k, v in us.items())
                + "; above the kernel function in the same turn (median [quartiles]): "
                + ", ".join(f"{k} {q[1]:.2f} [{q[0]:.2f}, {q[2]:.2f}]" for k, q in above.items())
                + f" ({card})")


def opcheck_on_card(dev) -> None:
    """``torch.library.opcheck`` of the four operators on CUDA inputs (its
    schema, fake-tensor and AOT-dispatch tests run the kernels)."""
    from bayer_low_light_image_enhancement_tpu_torch.kernels import fused_block as fb
    from bayer_low_light_image_enhancement_tpu_torch.models import common

    g = torch.Generator().manual_seed(15)
    blk = common.TransformerBlock(64, 8, 2, device=dev)
    common.reset_parameters_(blk, g)
    w = fb.fold_block_params({k: v.detach() for k, v in blk.named_parameters()})
    x = torch.randn(2, 37, 45, 64, generator=g).to(dev, torch.bfloat16)
    apply = fb.finalize_attention(*fb.gram_pass_plain(x, w), w.temperature, w.wproj, 8)
    u = torch.randn(6, 1000, 96, generator=g).to(dev, torch.bfloat16)
    dt = torch.rand(6, 1000, 96, generator=g).mul(0.1).to(dev, torch.bfloat16)
    A = -torch.rand(96, 32, generator=g).add(0.5).to(dev)
    Bm, Cm = (torch.randn(6, 1000, 32, generator=g).to(dev, torch.bfloat16) for _ in "12")
    cases = [(torch.ops.blle.gram_pass.default, (x, *w.gram_tensors())),
             (torch.ops.blle.apply_pass.default, (x, apply, *w.apply_tensors())),
             (torch.ops.blle.apply_pass_pipelined.default, (x, apply, *w.apply_tensors())),
             (torch.ops.blle.selective_scan_fwd.default,
              (u, dt, A, Bm, Cm, torch.ones(96, device=dev)))]
    for op, args in cases:
        t0 = time.perf_counter()
        res = torch.library.opcheck(op, args)
        log(f"opcheck {op} on CUDA inputs: {res} ({time.perf_counter() - t0:.1f} s)")
        check(all(v == "SUCCESS" for v in res.values()), f"opcheck of {op} failed: {res}")


def export_phase(dev, card) -> dict:
    """Phase 14: serving artifacts on the card; returns each artifact's
    launches per forward in the fresh process."""
    import copy
    import tempfile

    from bayer_low_light_image_enhancement_tpu_torch.models import get_model
    from bayer_low_light_image_enhancement_tpu_torch.serving import (
        Predictor,
        export_artifact,
        load_artifact,
    )
    from bayer_low_light_image_enhancement_tpu_torch.utils.flops import model_complexity

    t_phase = time.perf_counter()
    opcheck_on_card(dev)
    dispatch_costs(dev, card)

    rng = np.random.default_rng(14)

    def raw_frames(shape, ratios):
        raw = mosaics(rng, shape).astype(np.float32)
        return (np.clip((raw - 512.0) / (16383.0 - 512.0), 0.0, None)
                * ratios.reshape((-1,) + (1,) * (len(shape) - 1)))[..., None]

    s_batch = raw_frames(S_BATCH, rng.uniform(50.0, 300.0, S_BATCH[0]).astype(np.float32))
    s_frame = raw_frames(S_FRAME, np.full(S_FRAME[0], 100.0, np.float32))
    w_batch = raw_frames(WFB_BATCH, rng.uniform(50.0, 300.0, WFB_BATCH[0]).astype(np.float32))
    f_batch = rng.uniform(0.0, 1.5, ZOO_BATCH + (1,)).astype(np.float32)

    def seeded(name, seed, **kw):
        return get_model(name, device=dev, dtype=torch.bfloat16,
                         generator=torch.Generator().manual_seed(seed), **kw)

    preds = {
        "rawformer_s_tiled": Predictor(seeded("rawformer_s", 0), device=dev),
        "rawformer_s_pipelined": Predictor(seeded("rawformer_s", 0), device=dev,
                                           apply_kernel="pipelined"),
        "rawformer_wfb": Predictor(seeded("rawformer_wfb", 0), device=dev, pad_to=32),
        "flca_rawformer": Predictor(seeded("flca_rawformer", 10), device=dev),
    }
    cases = [(f"{m}_{tag}", m, x) for m in ("rawformer_s_tiled", "rawformer_s_pipelined")
             for tag, x in (("8x512", s_batch), ("frame", s_frame))]
    cases += [("rawformer_wfb_2x512", "rawformer_wfb", w_batch),
              ("flca_rawformer_2x512", "flca_rawformer", f_batch)]
    root = tempfile.mkdtemp(prefix="blle_artifacts_")
    try:
        listing, wants = [], {}
        for name, model_key, x in cases:
            pred = preds[model_key]
            t0 = time.perf_counter()
            meta = export_artifact(pred.model, None, f"{root}/{name}.zip", *x.shape[:3],
                                   device=dev, meta_extra={"model": model_key})
            export_s = time.perf_counter() - t0
            wants[name] = pred(x)
            np.save(f"{root}/{name}.in.npy", x)
            np.save(f"{root}/{name}.want.npy", wants[name])
            listing.append({"name": name, "artifact": f"{name}.zip", "input": f"{name}.in.npy",
                            "want": f"{name}.want.npy"})
            log(f"export {name} ({list(x.shape)}): {export_s:.1f} s, "
                f"{os.path.getsize(f'{root}/{name}.zip') / 2 ** 20:.1f} MiB; meta {meta}")
            check(meta["device"] == "cuda:0" and meta["input_shape"] == list(x.shape),
                  f"{name}: artifact meta {meta}")
        with open(f"{root}/cases.json", "w") as f:
            json.dump(listing, f)
        t0 = time.perf_counter()
        child = subprocess.run([sys.executable, "-c", EXPORT_CHILD, root], capture_output=True,
                               text=True, timeout=600,
                               cwd=os.path.dirname(os.path.abspath(__file__)))
        child_s = time.perf_counter() - t0
        if child.returncode != 0:
            log(child.stdout[-4000:], child.stderr[-8000:])
        check(child.returncode == 0, f"the artifact process exited {child.returncode}")
        got = json.loads(child.stdout.strip().splitlines()[-1])
        log(f"fresh process: loaded and ran {len(got)} artifacts in {child_s:.1f} s")
        launches = {}
        for name, model_key, x in cases:
            r = got[name]
            want = ARTIFACT_LAUNCHES[model_key]
            log(f"artifact {name} in a fresh process: load {r['load_s']:.1f} s, max abs err "
                f"{r['max_abs_err']:.3e} (tol {ARTIFACT_TOL}), mean {r['mean_abs_err']:.3e} "
                f"against Predictor; launches a forward {r['launches']} (want {want}); ops "
                f"{r['meta']['ops']}")
            check(r["finite"] and r["shape"] == list(x.shape[:3]) + [3],
                  f"{name}: artifact output not finite of shape {list(x.shape[:3]) + [3]}")
            check(r["max_abs_err"] <= ARTIFACT_TOL, f"{name}: artifact disagrees with Predictor")
            check(r["launches"] == want, f"{name}: the artifact's launches {r['launches']} are "
                  f"not {want} (a kernel missing, or a backward kernel ran)")
            launches[name] = r["launches"]

        # The artifact's call against Predictor's, in turns in this process,
        # for TIMED_ARTIFACTS (every artifact is held above, in the fresh
        # process; reloading the WFB and pipelined ones here too cost the
        # script's time limit more than their timings were worth).
        for name, model_key, x in cases:
            if model_key not in TIMED_ARTIFACTS:
                continue
            fn, _ = load_artifact(f"{root}/{name}.zip")
            pred = preds[model_key]
            calls = {"Predictor": lambda: pred(x), "artifact": lambda: fn(x)}
            host, dev_ms = {k: [] for k in calls}, {k: [] for k in calls}
            for k in calls:
                calls[k]()
            for turn in range(2):
                for k in (("Predictor", "artifact") if turn == 0 else ("artifact", "Predictor")):
                    for _ in range(3):
                        start = torch.cuda.Event(enable_timing=True)
                        end = torch.cuda.Event(enable_timing=True)
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        start.record()
                        calls[k]()
                        end.record()
                        torch.cuda.synchronize()
                        host[k].append((time.perf_counter() - t0) * 1e3)
                        dev_ms[k].append(start.elapsed_time(end))
            log(f"time {name} ({list(x.shape)}), numpy in and out, 6 calls each in turns: "
                + "; ".join(f"{k} host median {np.median(host[k]):.3f} ms "
                            f"[{min(host[k]):.3f}-{max(host[k]):.3f}], CUDA events median "
                            f"{np.median(dev_ms[k]):.3f} ms" for k in calls)
                + f" ({torch.cuda.get_device_name(0)}; nvidia-smi: {card})")
            del fn
    finally:
        for f in os.listdir(root):
            os.remove(os.path.join(root, f))
        os.rmdir(root)

    model = preds["rawformer_s_tiled"].model
    t0 = time.perf_counter()
    on_card = model_complexity(model, (1,) + S_BATCH[1:] + (1,))
    t1 = time.perf_counter()
    on_cpu = model_complexity(copy.deepcopy(model), (1,) + S_BATCH[1:] + (1,), device="cpu")
    log(f"model_complexity RawFormer-S 1x{S_BATCH[1]}x{S_BATCH[2]}: card {on_card} ({t1 - t0:.1f} s), CPU "
        f"{on_cpu} ({time.perf_counter() - t1:.1f} s): {on_card['flops'] / 1e9:.3f} GFLOPs, "
        f"{on_card['params']} params")
    check(on_card == on_cpu, "model_complexity differs between the card and the CPU")
    log(f"phase 14: {time.perf_counter() - t_phase:.1f} s ({card})")
    return launches


# Phase 15 (multi-GPU training): its ranks are processes of this script,
# `python3 chip_smoke.py --dist-rank <job dir> <task> <rendezvous>`, started
# with torchrun's rank variables by core.mesh.run_ranks; each writes its
# result to <job dir>/<task>.rank<r>.pt and the parent holds them.
# Tolerances of phase 15, stated before the run:
# (b) WFB-48 in fp32 compute, two ranks against one process (the same
# function, sums taken in another order): the first loss within
# FP32_LOSS_RTOL, the BatchNorm running statistics after each step within
# DDP_BN_TOL of their max, the first-step grads by phase 6c's fp32 rule
# (max(3 x the nudged twin's change, WFB_GRAD_FLOOR)), the params after the
# second step (the first at a nonzero lr) within TRAIN_PARAM_ATOL.
# (c) tensor parallelism in fp32 compute against the unsharded module path:
# the forward's RGB within TP_FWD_ATOL, the losses within FP32_LOSS_RTOL
# (and atol 1e-6), the params after two steps within rtol TP_PARAM_RTOL /
# atol TP_PARAM_ATOL (tests/test_tensor_parallel.py's bars).
FP32_LOSS_RTOL, DDP_BN_TOL = 1e-5, 1e-4
TP_FWD_ATOL, TP_PARAM_RTOL, TP_PARAM_ATOL = 1e-4, 1e-4, 1e-5
DIST_TIMEOUT = 300  # seconds for the ranks of one task


def dist_models(dev, dtype):
    """-> make(name, state): the registry model ``name`` on ``dev`` computing
    in ``dtype``, holding ``state``."""
    from bayer_low_light_image_enhancement_tpu_torch.models import get_model

    def make(name, state):
        model = get_model(name, device=dev, dtype=dtype)
        model.load_state_dict(state)
        return model

    return make


def _cpu(tensors: dict) -> dict:
    return {k: v.detach().float().cpu().clone() for k, v in tensors.items()}


def _grads(model) -> dict:
    return {n: p.grad.detach().float().cpu().clone() for n, p in model.named_parameters()
            if p.grad is not None}


def _step_ms(step, n: int = 3) -> float:
    """Median host ms of n synchronised calls of step() (after one)."""
    step()
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def _allreduce_ms(model, group, dev) -> float:
    """Median ms of one all-reduce of a flat fp32 tensor of the model's
    gradient size over ``group`` (what DDP's buckets move a step)."""
    import torch.distributed as dist

    flat = torch.zeros(sum(p.numel() for p in model.parameters() if p.requires_grad),
                       device=dev)
    return _step_ms(lambda: dist.all_reduce(flat, group=group))


def dist_task_nccl(job: dict, dev) -> dict:
    """(a): RawFormer-S at global batch 8 @ 512^2 from compact uint16
    batches through the kernels, over every rank (NCCL, one card each):
    rank 0 also runs one process's Trainer on the whole batches. cuDNN is
    deterministic here so that one rank can equal one process bitwise."""
    from bayer_low_light_image_enhancement_tpu_torch.core import mesh as meshlib
    from bayer_low_light_image_enhancement_tpu_torch.data.pipeline import to_device
    from bayer_low_light_image_enhancement_tpu_torch.train import Trainer

    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    make = dist_models(dev, torch.bfloat16)
    batches = [tuple(to_device(a, dev) for a in b) for b in job["batches"]]
    out = {"world": meshlib.world_size()}
    if meshlib.rank() == 0:
        single = Trainer(make("rawformer_s", job["state"]), job["cfg"])
        single.train_step(batches[0])
        out["single_grads"] = _grads(single.model)
        single.train_step(batches[1])
        out["single"] = _cpu(single.model.state_dict())
        out["single_ms"] = _step_ms(lambda: single.train_step(batches[0]))
        del single
    mesh = meshlib.create_mesh(data=meshlib.world_size())
    tr = Trainer(make("rawformer_s", job["state"]), job["cfg"], mesh=mesh)
    local = [tr.shard_batch(b) for b in batches]
    loss, out["launches"] = counted(job["counters"], lambda: float(tr.train_step(local[0])))
    out["grads"] = _grads(tr.model)
    out["losses"] = [loss, float(tr.train_step(local[1]))]
    out["mesh"] = _cpu(tr.model.state_dict())
    out["mesh_ms"] = _step_ms(lambda: tr.train_step(local[0]))
    if tr.data_group is not None:
        out["allreduce_ms"] = _allreduce_ms(tr.model, tr.data_group, dev)
    return out


def _tp_run(job: dict, dev, mesh) -> dict:
    """(c): RawFormer-S in fp32 compute sharded over ``mesh``: its forward
    on the first batch and two steps; the gathered checkpoint state."""
    from bayer_low_light_image_enhancement_tpu_torch.train import Trainer

    make = dist_models(dev, torch.float32)
    tr = Trainer(make("rawformer_s", job["tp_state"]), job["tp_cfg"], mesh=mesh)
    batches = [tuple(t.to(dev) for t in b) for b in job["tp_batches"]]
    tr.model.eval()
    with torch.no_grad():
        fwd = tr.model(batches[0][0].permute(0, 3, 1, 2)).permute(0, 2, 3, 1).cpu()
    losses, launches = counted(job["counters"], lambda: [
        float(tr.train_step(tr.shard_batch(b))) for b in batches])
    return {"forward": fwd, "losses": losses, "launches": launches,
            "state": _cpu(tr.state_dict()["model"]), "replicated": tr.layout.replicated}


def dist_task_gloo2(job: dict, dev) -> dict:
    """(b) and the first half of (c), two ranks sharing the one card over
    gloo: RawFormer-S data=2 through the kernels, WFB-48 data=2 in fp32
    compute, RawFormer-S tensor=2 in fp32 compute."""
    from bayer_low_light_image_enhancement_tpu_torch.core import mesh as meshlib
    from bayer_low_light_image_enhancement_tpu_torch.data.pipeline import to_device
    from bayer_low_light_image_enhancement_tpu_torch.train import Trainer

    out, t0 = {"seconds": {}}, time.perf_counter()
    data2 = meshlib.create_mesh(data=2)
    tr = Trainer(dist_models(dev, torch.bfloat16)("rawformer_s", job["state"]), job["cfg"],
                 mesh=data2)
    local = tr.shard_batch(tuple(to_device(a, dev) for a in job["batches"][0]))
    out["loss"], out["launches"] = counted(job["counters"], lambda: float(tr.train_step(local)))
    out["grads"] = _grads(tr.model)
    out["ddp_ms"] = _step_ms(lambda: tr.train_step(local))
    out["allreduce_ms"] = _allreduce_ms(tr.model, tr.data_group, dev)
    del tr, local
    out["seconds"]["rawformer"], t0 = time.perf_counter() - t0, time.perf_counter()

    wtr = Trainer(dist_models(dev, torch.float32)("rawformer_wfb", job["wfb_state"]),
                  job["cfg"], mesh=data2)
    wlocal = wtr.shard_batch(tuple(t.to(dev) for t in job["wfb_batch"]))
    wloss, out["wfb_launches"] = counted(job["counters"],
                                         lambda: float(wtr.train_step(wlocal)))
    out["wfb_losses"] = [wloss]
    out["wfb_grads"] = _grads(wtr.model)
    out["wfb_states"] = [_cpu(wtr.model.state_dict())]
    out["wfb_losses"].append(float(wtr.train_step(wlocal)))
    out["wfb_states"].append(_cpu(wtr.model.state_dict()))
    del wtr, wlocal
    out["seconds"]["wfb"], t0 = time.perf_counter() - t0, time.perf_counter()
    out["tp"] = _tp_run(job, dev, meshlib.create_mesh(data=1, tensor=2))
    out["seconds"]["tp"] = time.perf_counter() - t0
    return out


def dist_task_gloo4(job: dict, dev) -> dict:
    """The second half of (c): data=2 x tensor=2, four ranks on the card."""
    from bayer_low_light_image_enhancement_tpu_torch.core import mesh as meshlib

    return {"tp": _tp_run(job, dev, meshlib.create_mesh(data=2, tensor=2))}


def dist_task_tiled(job: dict, dev) -> dict:
    """Phase 16 on every rank: each case of TILED_CASES through
    ``make_tiled_forward`` on this rank's block of the case's frame, with the
    launches; rank 0 holds the gathered RGB against the parent's reference;
    the timed cases' frame forward by the host clock, and one instrumented
    forward's all-reduces (see ``collective_ms``)."""
    from bayer_low_light_image_enhancement_tpu_torch.core import mesh as meshlib
    from bayer_low_light_image_enhancement_tpu_torch.models import get_model
    from bayer_low_light_image_enhancement_tpu_torch.parallel.tiled import (
        make_tiled_forward,
        shard_image,
    )

    meshes = {"h4": (meshlib.create_mesh(data=1, spatial=4), None),
              "2x2": (meshlib.create_mesh(data=1, spatial=2, spatial_w=2), "spatial_w")}
    out = {"world": meshlib.world_size(), "cases": {}}
    for name, model_name, layout, dtype, frame, timed in TILED_CASES:
        t0 = time.perf_counter()
        mesh, w = meshes[layout]
        model = get_model(model_name, generator=torch.Generator().manual_seed(TILED_SEED),
                          dtype=dtype, spatial_axis=("spatial", w) if w else "spatial").to(dev)
        fn = make_tiled_forward(model, mesh, "spatial", w)
        x = torch.from_numpy(shard_image(job[frame], mesh, "spatial", w)).to(dev).contiguous()
        y, launches = counted(job["counters"], lambda: fn(x))
        rec = {"launches": launches, "sum": float(y.double().sum()), "shape": tuple(y.shape)}
        if meshlib.rank() == 0:
            d = (y.cpu() - torch.load(f"{job['dir']}/ref_{name}.pt")).abs()
            rec["max"], rec["mean"] = d.max().item(), d.mean().item()
        del y
        if timed:
            rec["ms"] = _step_ms(lambda: fn(x))
            rec["collective"] = collective_ms(lambda: fn(x), x.shape[0] * 3 * np.prod(
                job[frame].shape[1:3]))
        rec["seconds"] = time.perf_counter() - t0
        out["cases"][name] = rec
        del model, fn, x
        torch.cuda.empty_cache()
    return out


def collective_ms(fn, out_numel: int) -> dict:
    """One run of fn() with every ``torch.distributed.all_reduce`` timed by
    the host clock between synchronisations: -> the whole run's ms, the
    all-reduces' count and ms, and of them the output gather's (the calls
    of at least ``out_numel`` elements)."""
    import torch.distributed as dist

    real, calls = dist.all_reduce, []

    def timed(t, *a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = real(t, *a, **k)
        torch.cuda.synchronize()
        calls.append((t.numel(), (time.perf_counter() - t0) * 1e3))
        return r

    dist.all_reduce = timed
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        total = (time.perf_counter() - t0) * 1e3
    finally:
        dist.all_reduce = real
    return {"ms": total, "calls": len(calls), "all_reduce_ms": sum(c[1] for c in calls),
            "gather_ms": sum(c[1] for c in calls if c[0] >= out_numel)}


DIST_TASKS = {"nccl": dist_task_nccl, "gloo2": dist_task_gloo2, "gloo4": dist_task_gloo4,
              "tiled": dist_task_tiled}


def dist_rank_main(jobdir: str, task: str, rendezvous: str) -> int:
    """One rank of a phase-15 task (see DIST_TASKS)."""
    import torch.distributed as dist

    from bayer_low_light_image_enhancement_tpu_torch.core import mesh as meshlib
    from bayer_low_light_image_enhancement_tpu_torch.kernels import (
        bayer_pack, fused_block, fused_block_bwd, ssm_scan, weight_grad)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = meshlib.initialize_multihost(rendezvous, device_type="cuda")
    try:
        job = torch.load(f"{jobdir}/job.pt", weights_only=False)
        job["dir"] = jobdir
        job["counters"] = (bayer_pack.bayer_pack_normalize, fused_block.gram_pass,
                           fused_block.apply_pass, fused_block.apply_pass_pipelined,
                           weight_grad.weight_grad, fused_block_bwd.bwd1, fused_block_bwd.bwd2,
                           ssm_scan.selective_scan_fwd, ssm_scan.selective_scan_bwd)
        out = DIST_TASKS[task](job, dev)
        out["backend"] = dist.get_backend()
        torch.save(out, f"{jobdir}/{task}.rank{meshlib.rank()}.pt")
    finally:
        dist.destroy_process_group()
    return 0


def one_card_env() -> dict:
    """The environment that puts every rank on the first visible card."""
    return {"CUDA_VISIBLE_DEVICES": os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]}


def run_dist_task(jobdir: str, task: str, world: int, one_card: bool = False,
                  phase: int = 15) -> list:
    """Start ``world`` ranks of ``task`` on one rendezvous file (all on the
    first visible card when ``one_card``, which makes them gloo ranks); ->
    their results (raises when a rank fails)."""
    from bayer_low_light_image_enhancement_tpu_torch.core import mesh as meshlib

    env = one_card_env() if one_card else {}
    t0 = time.perf_counter()
    meshlib.run_ranks([sys.executable, os.path.abspath(__file__), "--dist-rank", jobdir, task,
                       f"file://{jobdir}/{task}.rdzv"], world, env=env, timeout=DIST_TIMEOUT)
    log(f"phase {phase} {task}: {world} rank(s) in {time.perf_counter() - t0:.1f} s")
    return [torch.load(f"{jobdir}/{task}.rank{r}.pt", weights_only=False) for r in range(world)]


def nccl_in_process(jobdir: str, job: dict, dev) -> dict:
    """(a) with one card: its one rank is this process, in a one-rank NCCL
    group, torn down after (cuDNN's flags restored)."""
    import torch.distributed as dist

    from bayer_low_light_image_enhancement_tpu_torch.core import mesh as meshlib

    t0 = time.perf_counter()
    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    meshlib.initialize_multihost(f"file://{jobdir}/nccl.rdzv", 1, 0)
    try:
        out = dist_task_nccl(job, dev)
        out["backend"] = dist.get_backend()
    finally:
        dist.destroy_process_group()
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags
    log(f"phase 15 nccl: 1 rank (this process) in {time.perf_counter() - t0:.1f} s")
    return out


def leaf_errors(got: dict, want: dict) -> dict:
    """Each leaf's max abs error relative to ``want``'s leaf max."""
    return {n: ((got[n] - w).abs().max() / (w.abs().max() + 1e-12)).item()
            for n, w in want.items()}


def hold_tp(what: str, got: dict, ref: dict) -> None:
    """(c): a tensor-parallel run against the unsharded module path."""
    e_fwd = (got["forward"] - ref["forward"]).abs().max().item()
    dl = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"]))
    bad = [n for n, w in ref["state"].items()
           if not torch.allclose(got["state"][n], w, rtol=TP_PARAM_RTOL, atol=TP_PARAM_ATOL)]
    dp = max((got["state"][n] - w).abs().max().item() for n, w in ref["state"].items())
    log(f"{what}: forward max abs err {e_fwd:.3e} (tol {TP_FWD_ATOL}); losses {got['losses']} "
        f"vs {ref['losses']} (rel err {dl:.3e}, tol {FP32_LOSS_RTOL}); params after 2 steps "
        f"max abs diff {dp:.3e}, {len(bad)} leaves outside rtol {TP_PARAM_RTOL} / atol "
        f"{TP_PARAM_ATOL}; blocks kept replicated {got['replicated']}; launches "
        f"{got['launches']}")
    check(e_fwd <= TP_FWD_ATOL, f"{what}: the forward disagrees with the unsharded module path")
    check(dl <= FP32_LOSS_RTOL, f"{what}: the losses disagree with the unsharded module path")
    check(not bad, f"{what}: params after two steps disagree: {bad[:5]}")
    check(sorted(got["state"]) == sorted(ref["state"])
          and all(got["state"][n].shape == w.shape for n, w in ref["state"].items()),
          f"{what}: the gathered checkpoint is not the single-device state")
    check(got["replicated"] == [], f"{what}: a RawFormer-S block stayed replicated")
    no_kernel(got["launches"], f"{what} (sharded blocks take the module path)")


def phase15_job(dev, train_cfg) -> dict:
    """The inputs every rank of phase 15 loads: compact uint16 batches (8 @
    512^2), fp32 float batches, RawFormer-S / WFB-48 weights from seed 0."""
    from bayer_low_light_image_enhancement_tpu_torch.data import SyntheticBayerDataset, native
    from bayer_low_light_image_enhancement_tpu_torch.models import get_model

    g = torch.Generator().manual_seed(15)
    ds = SyntheticBayerDataset(num_images=8, full_size=(576, 576), patch_size=512, training=True)
    sampler = native.sampler_for_dataset(ds, seed=15, compact=True)
    check(sampler is not None, f"phase 15: the native batch engine is unavailable "
          f"({native._build_error})")
    compact = [sampler.sample_batch(list(range(8)), e) for e in range(2)]  # 8 @ 512^2, uint16

    def state_of(name, dtype):
        m = get_model(name, device=dev, generator=torch.Generator().manual_seed(0), dtype=dtype)
        return {k: v.detach().cpu().clone() for k, v in m.state_dict().items()}

    def floats(b, size):
        return (torch.rand((b, size, size, 1), generator=g) * 2.0,
                torch.rand((b, size, size, 3), generator=g))

    tp_cfg = dataclasses.replace(train_cfg, fused_blocks=False)
    job = {"cfg": train_cfg, "tp_cfg": tp_cfg, "batches": compact,
           "state": state_of("rawformer_s", torch.bfloat16),
           "wfb_state": state_of("rawformer_wfb", torch.float32), "wfb_batch": floats(4, 256),
           "tp_state": state_of("rawformer_s", torch.float32),
           "tp_batches": [floats(4, 256), floats(4, 256)]}
    return job


def phase15_references(job, dev) -> dict:
    """One process's runs on the card that (b) and (c) are held to."""
    from bayer_low_light_image_enhancement_tpu_torch.data.pipeline import to_device
    from bayer_low_light_image_enhancement_tpu_torch.train import Trainer

    train_cfg, tp_cfg, compact = job["cfg"], job["tp_cfg"], job["batches"]
    make16, make32 = dist_models(dev, torch.bfloat16), dist_models(dev, torch.float32)
    single = Trainer(make16("rawformer_s", job["state"]), train_cfg)
    full = tuple(to_device(a, dev) for a in compact[0])
    ref_loss = float(single.train_step(full))
    ref_grads = _grads(single.model)
    single_ms = _step_ms(lambda: single.train_step(full))
    del single
    wfb_batch = tuple(t.to(dev) for t in job["wfb_batch"])
    wfb_ref = Trainer(make32("rawformer_wfb", job["wfb_state"]), train_cfg)
    wfb_losses = [float(wfb_ref.train_step(wfb_batch))]
    wfb_grads, wfb_states = _grads(wfb_ref.model), [_cpu(wfb_ref.model.state_dict())]
    wfb_losses.append(float(wfb_ref.train_step(wfb_batch)))
    wfb_states.append(_cpu(wfb_ref.model.state_dict()))
    nudged = Trainer(make32("rawformer_wfb", job["wfb_state"]), tp_cfg)
    nudged.train_step((wfb_batch[0] * (1.0 + 2.0 ** -9), wfb_batch[1]))
    wfb_twin = Trainer(make32("rawformer_wfb", job["wfb_state"]), tp_cfg)
    wfb_twin.train_step(wfb_batch)
    wfb_yard = leaf_errors(_grads(nudged.model), _grads(wfb_twin.model))
    del wfb_ref, nudged, wfb_twin
    tp_ref_tr = Trainer(make32("rawformer_s", job["tp_state"]), tp_cfg)
    tp_batches = [tuple(t.to(dev) for t in b) for b in job["tp_batches"]]
    tp_ref_tr.model.eval()
    with torch.no_grad():
        tp_fwd = tp_ref_tr.model(tp_batches[0][0].permute(0, 3, 1, 2)).permute(0, 2, 3, 1).cpu()
    tp_ref = {"forward": tp_fwd, "losses": [float(tp_ref_tr.train_step(b)) for b in tp_batches],
              "state": _cpu(tp_ref_tr.model.state_dict())}
    del tp_ref_tr
    torch.cuda.empty_cache()
    return {"ref_loss": ref_loss, "ref_grads": ref_grads, "single_ms": single_ms,
            "wfb_losses": wfb_losses, "wfb_grads": wfb_grads, "wfb_states": wfb_states,
            "wfb_yard": wfb_yard, "tp": tp_ref}


def phase15_a(jobdir, job, dev, card, counters) -> None:
    """(a): data parallelism over every card (at most 4) on NCCL."""
    cards = torch.cuda.device_count()
    world = max(1, min(cards, 4))
    res = (run_dist_task(jobdir, "nccl", world) if world > 1
           else [nccl_in_process(jobdir, dict(job, counters=counters), dev)])
    r0 = res[0]
    check(all(r["backend"] == "nccl" for r in res), "(a) did not run on NCCL")
    la = r0["launches"]
    log(f"(a) RawFormer-S data={world} (NCCL), global batch 8 @ 512^2 compact uint16: losses "
        f"{r0['losses']}; first-step launches {la}")
    for name in ("gram_pass", "apply_pass", "bwd1", "bwd2"):
        check(la[name] == 7, f"(a) {name} did not run 7 times in the data-parallel step")
    check(la["weight_grad"] == 6, "(a) the weight-grad pass did not run 6 times")
    for r in res[1:]:
        check(all(torch.equal(r["mesh"][k], v) for k, v in r0["mesh"].items()),
              "(a) the ranks' params differ")
    if world == 1:
        same = [k for k, v in r0["single"].items() if not torch.equal(r0["mesh"][k], v)]
        log(f"(a) one rank against one process after 2 steps: {len(r0['single']) - len(same)}"
            f" of {len(r0['single'])} leaves bitwise equal")
        check(not same, f"(a) one rank is not bitwise one process: {same[:5]}")
    else:
        err = leaf_errors(r0["grads"], r0["single_grads"])
        dp = max((r0["mesh"][k] - v).abs().max().item() for k, v in r0["single"].items())
        log(f"(a) {world} ranks against one process: first-step grads worst "
            f"{max(err.values()):.3e} (floor {TRAIN_GRAD_FLOOR}), median "
            f"{np.median(list(err.values())):.3e}; params after 2 steps {dp:.3e} (tol "
            f"{TRAIN_PARAM_ATOL})")
        check(max(err.values()) <= TRAIN_GRAD_FLOOR and dp <= TRAIN_PARAM_ATOL,
              "(a) the data-parallel step disagrees with one process")
    share = (f", all-reduce of the grads {r0['allreduce_ms']:.3f} ms "
             f"({r0['allreduce_ms'] / r0['mesh_ms']:.1%} of the step)"
             if "allreduce_ms" in r0 else " (one rank: no gradient all-reduce)")
    log(f"(a) train step at global batch 8 @ 512^2: data={world} mesh path "
        f"{r0['mesh_ms']:.2f} ms, one process {r0['single_ms']:.2f} ms{share} ({card})")


def phase15_bc(jobdir, refs, card) -> None:
    """(b) and (c): gloo ranks sharing the one card."""
    ref_loss, ref_grads, single_ms = refs["ref_loss"], refs["ref_grads"], refs["single_ms"]
    wfb_losses, wfb_grads, wfb_states = refs["wfb_losses"], refs["wfb_grads"], refs["wfb_states"]
    wfb_yard, tp_ref = refs["wfb_yard"], refs["tp"]
    res = run_dist_task(jobdir, "gloo2", 2, one_card=True)
    r0, r1 = res
    check(all(r["backend"] == "gloo" for r in res), "(b) did not run on gloo")
    lb = r0["launches"]
    for name in ("gram_pass", "apply_pass", "bwd1", "bwd2"):
        check(lb[name] == 7, f"(b) {name} did not run 7 times in the DDP step")
    check(lb["weight_grad"] == 6, "(b) the weight-grad pass did not run 6 times")
    check(all(torch.equal(r1["grads"][k], v) for k, v in r0["grads"].items()),
          "(b) the two ranks' averaged grads differ")
    err = leaf_errors(r0["grads"], ref_grads)
    median = float(np.median(list(err.values())))
    dl = abs(r0["loss"] - ref_loss) / abs(ref_loss)
    worst = max(err, key=err.get)
    log(f"(b) RawFormer-S data=2 (gloo, one card), global batch 8 @ 512^2: first loss "
        f"{r0['loss']} vs one process {ref_loss} (rel err {dl:.3e}, tol {TRAIN_LOSS_RTOL}); "
        f"first-step grads of the leaf max: worst {worst} {err[worst]:.3e} (phase 4b's floor "
        f"{TRAIN_GRAD_FLOOR}), median {median:.3e} (tol {TRAIN_GRAD_MEDIAN_TOL}); launches "
        f"{lb}")
    check(dl <= TRAIN_LOSS_RTOL, "(b) the DDP loss disagrees with one process")
    check(err[worst] <= TRAIN_GRAD_FLOOR and median <= TRAIN_GRAD_MEDIAN_TOL,
          "(b) the DDP grads disagree with one process")
    log(f"(b) DDP step, 2 ranks sharing the card over gloo (not a multi-GPU figure): "
        f"{r0['ddp_ms']:.2f} ms at 4 rows a rank, one process {single_ms:.2f} ms at 8 rows; "
        f"gloo all-reduce of the grads {r0['allreduce_ms']:.2f} ms "
        f"({r0['allreduce_ms'] / r0['ddp_ms']:.1%} of the step) ({card}); rank 0's seconds "
        f"{ {k: round(v, 1) for k, v in r0['seconds'].items()} }")

    lw = r0["wfb_launches"]
    check(lw["selective_scan_fwd"] == lw["selective_scan_bwd"] == 7,
          "(b) S1 with states and S2 did not run 7 times in the WFB DDP step")
    werr = leaf_errors(r0["wfb_grads"], wfb_grads)
    allowed = {n: max(3 * wfb_yard[n], WFB_GRAD_FLOOR) for n in werr}
    wbad = [n for n in werr if werr[n] > allowed[n]]
    dlw = abs(r0["wfb_losses"][0] - wfb_losses[0]) / abs(wfb_losses[0])
    dbn = max(((r[1][n] - w).abs().max() / w.abs().max()).item()
              for r in zip(wfb_states, r0["wfb_states"]) for n, w in r[0].items()
              if "running" in n)
    dpw = max((r0["wfb_states"][1][n] - wfb_states[1][n]).abs().max().item()
              for n in r0["wfb_grads"])
    log(f"(b) WFB-48 data=2 in fp32 compute, global batch 4 @ 256^2: losses "
        f"{r0['wfb_losses']} vs {wfb_losses} (first rel err {dlw:.3e}, tol {FP32_LOSS_RTOL});"
        f" BN running stats after steps 1-2 {dbn:.3e} of their max (tol {DDP_BN_TOL}); "
        f"first-step grads worst {max(werr.values()):.3e}, {len(wbad)} leaves beyond max(3 x "
        f"nudged, {WFB_GRAD_FLOOR}); params after 2 steps {dpw:.3e} (tol {TRAIN_PARAM_ATOL}); "
        f"launches {lw}")
    check(dlw <= FP32_LOSS_RTOL, "(b) the WFB DDP loss disagrees with one process")
    check(dbn <= DDP_BN_TOL, "(b) the WFB BatchNorm statistics are not the global batch's")
    check(not wbad, f"(b) WFB DDP grads disagree with one process: {wbad[:5]}")
    check(dpw <= TRAIN_PARAM_ATOL, "(b) WFB params after 2 steps disagree")
    for i, r in enumerate(res):
        hold_tp(f"(c) RawFormer-S tensor=2 rank {i}", r["tp"], tp_ref)

    # (c) data=2 x tensor=2: four ranks on the card.
    res = run_dist_task(jobdir, "gloo4", 4, one_card=True)
    for i, r in enumerate(res):
        hold_tp(f"(c) RawFormer-S data=2 x tensor=2 rank {i}", r["tp"], tp_ref)


def phase15_d(jobdir, card) -> None:
    """(d): the train CLI over every card for one synthetic epoch, then
    ``--resume``."""
    from bayer_low_light_image_enhancement_tpu_torch.cli import train_cli

    cards = torch.cuda.device_count()
    argv = ["--dataset", "synthetic", "--patch_size", "128", "--batch_size", "8",
            "--num_chips", str(cards), "--save_dir", jobdir, "--loader", "native"]
    t0 = time.perf_counter()
    train_cli.main(argv + ["--epochs", "1"])
    train_cli.main(argv + ["--epochs", "2", "--resume"])
    log_txt = open(f"{jobdir}/synthetic/log.txt").read()
    steps = sorted(int(f[:-3]) for f in os.listdir(f"{jobdir}/synthetic/weights")
                   if f.endswith(".pt"))
    state = torch.load(f"{jobdir}/synthetic/weights/2.pt", weights_only=False)["state"]
    log(f"(d) train CLI --num_chips {cards}: one epoch, then --resume to epoch 2 in "
        f"{time.perf_counter() - t0:.1f} s; checkpoints {steps}, {state['trainer']['applied']}"
        f" updates applied")
    check(steps == [0, 1, 2] and log_txt.count("Training start time") == 2
          and "Epoch 2/2" in log_txt and state["trainer"]["step"] == 3 * 2,
          "(d) the train CLI did not resume from its checkpoint")


def dist_phase(dev, card, counters, train_cfg) -> None:
    """Phase 15: multi-GPU training (see the module doc)."""
    import tempfile

    t_phase = time.perf_counter()
    job = phase15_job(dev, train_cfg)
    refs = phase15_references(job, dev)
    log(f"phase 15 references on one process: {time.perf_counter() - t_phase:.1f} s")
    with tempfile.TemporaryDirectory() as jobdir:
        torch.save(job, f"{jobdir}/job.pt")
        phase15_a(jobdir, job, dev, card, counters)
        phase15_bc(jobdir, refs, card)
        phase15_d(jobdir, card)
    log(f"phase 15: {time.perf_counter() - t_phase:.1f} s ({card})")


# Phase 16 (tiled full-resolution inference, ``parallel/tiled.py``): four
# ranks, processes of this script as in phase 15 (NCCL where each rank has
# its own card, else gloo with the ranks sharing card 0), run each case of
# TILED_CASES; the parent computes the references on one process first.
# Tolerances, stated before the run: in fp32 compute with TF32 off (C5), the
# tiled RGB against one process's monolithic module path (WFB: its scan
# twin) within TILED_FP32_ATOL max abs; in bf16 compute against the
# monolithic kernel path by the serving bar (E2E_MAX_TOL, E2E_MEAN_TOL).
# Every tiled forward launches K2 / K3 / K3P / S1 0 times (sharded blocks
# take the module path and sharded scans the twin: the JAX package's
# fused_apply._fusable and ssm.MambaBlock routes); the monolithic kernel
# paths 7 times each. The eval CLI with --spatial_chips 2 on two
# TILED_CLI_FRAME frames against the unsharded CLI (--no_fused, its frames
# decoded on the host in the expression the sharded ranks evaluate on the
# card), both in fp32 and padded alike: per-image PSNR within TILED_PSNR_TOL dB and SSIM
# within TILED_SSIM_TOL. WFB-48 runs at TILED_WFB_FRAME: its scan twin at
# full-frame token counts would take minutes.
TILED_FP32_ATOL = 1e-4
TILED_PSNR_TOL, TILED_SSIM_TOL = 1e-3, 1e-5
TILED_FRAME, TILED_WFB_FRAME, TILED_CLI_FRAME = (2832, 4240), (1024, 1024), (2832, 4240)
TILED_SEED = 16
# (case, model, mesh layout, compute dtype, frame key, timed)
TILED_CASES = (
    ("rawformer_s_h4_fp32", "rawformer_s", "h4", torch.float32, "frame", False),
    ("rawformer_s_h4_bf16", "rawformer_s", "h4", torch.bfloat16, "frame", True),
    ("rawformer_s_2x2_fp32", "rawformer_s", "2x2", torch.float32, "frame", False),
    ("rawformer_s_2x2_bf16", "rawformer_s", "2x2", torch.bfloat16, "frame", True),
    ("wfb48_h4_fp32", "rawformer_wfb", "h4", torch.float32, "wfb_frame", False),
    ("wfb48_h4_bf16", "rawformer_wfb", "h4", torch.bfloat16, "wfb_frame", False),
)


def tile_frame(x: np.ndarray, multiple: int) -> np.ndarray:
    """[1, H, W, 1] zero-padded so that H splits into 4 blocks and W into 2
    (the h4 and 2x2 layouts) of a multiple of ``multiple`` each, as the
    eval CLI pads a frame for its mesh (``parallel/tiled.pad_to_tile``)."""
    from bayer_low_light_image_enhancement_tpu_torch.parallel.tiled import pad_to_tile

    x, _ = pad_to_tile(x, 4, multiple)
    pw = (-x.shape[2]) % (2 * multiple)
    return np.pad(x, ((0, 0), (0, 0), (0, pw), (0, 0)))


def tiled_references(jobdir: str, job: dict, dev, counters, card) -> dict:
    """Phase 16's references on this one process, saved for rank 0: each
    model on its whole frame through the monolithic module path (fp32, the
    scan twin) and the kernel path (bf16), the kernel paths' launches, and
    the RawFormer-S kernel-path frame's host ms."""
    from bayer_low_light_image_enhancement_tpu_torch.models import get_model
    from bayer_low_light_image_enhancement_tpu_torch.models.common import set_fused_blocks

    out = {}
    for model_name, frame, tag in (("rawformer_s", "frame", "rawformer_s"),
                                   ("rawformer_wfb", "wfb_frame", "wfb48")):
        x = torch.from_numpy(job[frame]).to(dev).permute(0, 3, 1, 2)
        for dtype, kind in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
            model = get_model(model_name, generator=torch.Generator().manual_seed(TILED_SEED),
                              dtype=dtype).to(dev).eval()
            set_fused_blocks(model, kind == "bf16")

            def fwd():
                with torch.inference_mode():
                    return model(x).clamp(0.0, 1.0).permute(0, 2, 3, 1)

            t0 = time.perf_counter()
            y, launches = counted(counters, fwd)
            ref = y.float().cpu()
            for name, *_ in TILED_CASES:
                if name.startswith(tag) and name.endswith(kind):
                    torch.save(ref, f"{jobdir}/ref_{name}.pt")
            rec = {"launches": launches, "seconds": time.perf_counter() - t0}
            if model_name == "rawformer_s" and kind == "bf16":
                rec["ms"] = _step_ms(fwd, 5)
            out[f"{tag}_{kind}"] = rec
            log(f"phase 16 reference {tag} {kind} ({'kernel path' if kind == 'bf16' else 'module path'}"
                f") on {tuple(x.shape[2:])}: {rec['seconds']:.1f} s, launches {launches}")
            del model, y
            torch.cuda.empty_cache()
    return out


# A CLI rank with this process's TF32 flags (off), run as `python -c`: the
# CLI sets none, and cuDNN's default allows TF32 in fp32 convs.
TF32_OFF_CLI = ("import runpy, torch; torch.backends.cudnn.allow_tf32 = False; "
                "torch.backends.cuda.matmul.allow_tf32 = False; "
                "runpy.run_module({!r}, run_name='__main__')")


def tiled_cli(card, counters, one_card: bool, model_args=(), mesh=(2, 1),
              phase: int = 16) -> None:
    """The eval CLI of ``model_args`` (RawFormer-S by default) over a
    ``mesh`` = (N, M) spatial mesh (--spatial_chips N --spatial_w_chips M:
    N x M ranks it does not start itself, torchrun's variables from
    run_ranks, TF32 off as in this process; the SID codes decoded on the
    card by ``normalize_sid``) against the unsharded CLI in this process on
    the module path, its frames decoded on the host in the same fp32
    expression (RawFormer's compact route, K1, scales by a rounded
    reciprocal instead: an ulp off, enough to move SSIM by ~3e-5 on these
    frames)."""
    import tempfile

    from bayer_low_light_image_enhancement_tpu_torch.cli import test_cli
    from bayer_low_light_image_enhancement_tpu_torch.core import mesh as meshlib
    from bayer_low_light_image_enhancement_tpu_torch.data.synthetic import write_sid_tree

    with tempfile.TemporaryDirectory(prefix="chip_smoke_tiled_") as tmp:
        root = f"{tmp}/sid"
        write_sid_tree(root, f"{root}/cache", {"test": [TILED_CLI_FRAME] * 2},
                       np.random.default_rng(16))
        base = ["--dataset", "SID", "--data_root", root, "--cache_dir", f"{root}/cache",
                "--fp32", "--pad_to", "32", *model_args]
        n, m = mesh
        flags = ["--spatial_chips", str(n)] + (["--spatial_w_chips", str(m)] if m > 1 else [])
        t0 = time.perf_counter()
        one, launches = counted(counters, lambda: test_cli.main(
            base + ["--no_fused", "--no_compact_h2d", "--save_dir", f"{tmp}/one"]))
        t_one = time.perf_counter() - t0
        no_kernel(launches, f"phase {phase}: the unsharded --no_fused --no_compact_h2d eval CLI")
        root_dir = os.path.dirname(os.path.abspath(__file__))
        path = os.pathsep.join(p for p in (root_dir, os.environ.get("PYTHONPATH")) if p)
        env = dict(one_card_env() if one_card else {}, PYTHONPATH=path)
        t0 = time.perf_counter()
        meshlib.run_ranks([sys.executable, "-c", TF32_OFF_CLI.format(test_cli.MODULE), *base,
                           *flags, "--save_dir", f"{tmp}/tiled", "--rendezvous",
                           f"file://{tmp}/cli.rdzv", "--result_file", f"{tmp}/cli.json"], n * m,
                          env=env, timeout=DIST_TIMEOUT)
        t_tiled = time.perf_counter() - t0
        with open(f"{tmp}/cli.json") as f:
            tiled = json.load(f)
    dp = np.abs(np.subtract(tiled["psnr"], one["psnr"])).max()
    ds = np.abs(np.subtract(tiled["ssim"], one["ssim"])).max()
    log(f"({phase}) eval CLI {' '.join([*model_args, *flags])} "
        f"({'gloo, one card' if one_card else 'NCCL'}) on 2 SID "
        f"frames at {TILED_CLI_FRAME}, fp32: PSNR {tiled['psnr']} vs unsharded {one['psnr']}, "
        f"SSIM {tiled['ssim']} vs {one['ssim']}: max differences {dp:.2e} dB (tol "
        f"{TILED_PSNR_TOL}), {ds:.2e} (tol {TILED_SSIM_TOL}); pad_to {tiled['pad_to']}; "
        f"{t_tiled:.1f} s with the ranks' start, unsharded {t_one:.1f} s; host seconds per image "
        f"{[round(t, 3) for t in tiled['seconds']]} vs {[round(t, 3) for t in one['seconds']]} "
        f"({card})")
    check(dp <= TILED_PSNR_TOL and ds <= TILED_SSIM_TOL,
          f"phase {phase}: the sharded eval CLI's metrics differ from the unsharded CLI's")


def tiled_phase(dev, card, counters) -> None:
    """Phase 16: spatially sharded full-resolution inference (see the
    module doc and the tolerances above)."""
    import tempfile

    t_phase = time.perf_counter()
    cards = torch.cuda.device_count()
    one_card = cards < 4
    backend = "gloo, 4 ranks sharing card 0" if one_card else "NCCL, one card a rank"
    rng = np.random.default_rng(16)
    job = {name: tile_frame((mosaics(rng, (1, *shape, 1)).astype(np.float32) - 512.0)
                            / (16383.0 - 512.0), multiple)
           for name, shape, multiple in (("frame", TILED_FRAME, 16),
                                         ("wfb_frame", TILED_WFB_FRAME, 32))}
    log(f"phase 16 frames: {TILED_FRAME} zero-padded to {job['frame'].shape[1:3]}, "
        f"{TILED_WFB_FRAME} to {job['wfb_frame'].shape[1:3]} (every rank's block a multiple "
        "of 16 rows and columns, 32 for WFB, in both layouts)")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tiled_") as jobdir:
        refs = tiled_references(jobdir, job, dev, counters, card)
        for kind in ("rawformer_s_bf16", "wfb48_bf16"):
            got = refs[kind]["launches"]
            name = ("gram_pass", "apply_pass") if kind.startswith("rawformer") else (
                "selective_scan_fwd",)
            check(all(got[n] == 7 for n in name),
                  f"phase 16: the monolithic {kind} kernel path did not launch {name} 7 times")
        torch.save(job, f"{jobdir}/job.pt")
        res = run_dist_task(jobdir, "tiled", 4, one_card=one_card, phase=16)
    label = " (not a multi-GPU figure)" if one_card else ""
    r0 = res[0]
    for name, model_name, layout, dtype, frame, timed in TILED_CASES:
        rec = r0["cases"][name]
        sums = {r["cases"][name]["sum"] for r in res}
        launched = {k: v for r in res for k, v in r["cases"][name]["launches"].items() if v}
        fp32 = dtype == torch.float32
        ok = (rec["max"] <= TILED_FP32_ATOL if fp32
              else rec["max"] <= E2E_MAX_TOL and rec["mean"] <= E2E_MEAN_TOL)
        bar = (f"tol {TILED_FP32_ATOL} against the module path" if fp32 else
               f"tol {E2E_MAX_TOL} / {E2E_MEAN_TOL} against the kernel path")
        log(f"(16) {name} ({backend}): {rec['shape']} on every rank, max abs err {rec['max']:.3e}"
            f", mean {rec['mean']:.3e} ({bar}); launches on every rank {launched or 'none'}; "
            f"rank 0 {rec['seconds']:.1f} s")
        check(ok, f"phase 16: {name} disagrees with the monolithic reference")
        check(len(sums) == 1, f"phase 16: {name}: the ranks received different outputs")
        check(not launched, f"phase 16: {name}: a hand kernel launched on the tiled path "
              f"({launched})")
        if timed:
            per_rank = [round(r["cases"][name]["ms"], 2) for r in res]
            c = rec["collective"]
            log(f"time {name} tiled frame forward, host clock per rank (median of 3){label}: "
                f"{per_rank} ms; one instrumented forward on rank 0: {c['ms']:.2f} ms, "
                f"{c['calls']} all-reduces {c['all_reduce_ms']:.2f} ms "
                f"({c['all_reduce_ms'] / c['ms']:.1%}), of them the output gather "
                f"{c['gather_ms']:.2f} ms; the monolithic kernel path "
                f"{refs['rawformer_s_bf16']['ms']:.2f} ms on one process ({card})")
    tiled_cli(card, counters, cards < 2)
    log(f"phase 16: {time.perf_counter() - t_phase:.1f} s ({card})")


# Phase 17 (tiled inference of the rest of the zoo, ``parallel/tiled.py``):
# four ranks, processes of this script as in phase 16 (NCCL where each rank
# has its own card, else gloo with the ranks sharing card 0), run each case
# of ``zoo_tiled_cases``; the parent computes the references on one process
# first. The models are seeded at full width as phases 10, 12 and 13 build
# them (dim 48; the raw-domain models at their JAX default widths), with
# BayerTORGB's colour correction moved off saturation by phase 10's
# spread_color_correction before both runs (ROADMAP C14), and the weights
# shipped to the ranks. Tolerances, stated before the run: in fp32 compute
# with TF32 off (C5), the tiled output against one process's monolithic
# module path within TILED_FP32_ATOL max abs (the [0, 1] RGB; the
# raw-domain planes, which are not clipped, within TILED_FP32_ATOL x their
# largest magnitude, as phase 13 scales its bar); in bf16 compute against
# the monolithic bf16 forward by the serving bar (E2E_MAX_TOL,
# E2E_MEAN_TOL, x the largest magnitude for the raw-domain planes), the
# FLCA / TrueColor family's reference being the kernel path. For the FLCA /
# TrueColor family the head's input (conv_out's whole output) is held the
# same way relative to its largest magnitude (TrueColor's seeded RGB is
# flat: C14). Every rank receives the same whole output; K2 / K3 / K3P
# launch 0 times on every tiled forward (sharded blocks take the module
# path) and 6 times each on the FLCA / TrueColor kernel-path references
# (phase 10's count); the other six models launch no hand kernel. Then the
# eval CLI with --model flca_rawformer over 2 x 2 ranks on two
# TILED_CLI_FRAME SID frames against the unsharded CLI, both fp32: PSNR
# within TILED_PSNR_TOL dB and SSIM within TILED_SSIM_TOL. The token
# attention models run on the small ZOO_TILED_FRAMES: their gathered keys
# make each rank's attention quadratic in the whole image's tokens.
ZOO_TILED_SEED = 17
ZOO_TILED_GUIDED = ("flca_rawformer", "multilvl_flca_rawformer", "truecolor_rawformer",
                    "bayertorgb_rawformer")
# The inputs beside phase 16's frame ("frame") and its packed planes
# ("packed"): key -> (shape [H, W], channels: 1 a mosaic, 4 packed planes).
ZOO_TILED_FRAMES = {"wavkan": ((1024, 1024), 1), "luma": ((512, 512), 1),
                    "packed256": ((256, 256), 4)}
# (model, frame key, layouts, timing: 0 none, 1 the bf16 forward by H by the
# host clock, 2 also one instrumented forward's all-reduces, ``collective_ms``)
ZOO_TILED_MODELS = (
    ("flca_rawformer", "frame", ("h4", "2x2"), 2),
    ("multilvl_flca_rawformer", "frame", ("h4",), 0),
    ("truecolor_rawformer", "frame", ("h4",), 0),
    ("bayertorgb_rawformer", "frame", ("h4", "2x2"), 0),
    ("flca_unet", "packed", ("h4", "2x2"), 1),
    ("unet_luma_dwt", "packed", ("h4",), 0),
    ("wavkan_rawformer", "wavkan", ("h4",), 0),
    ("luma_mhsa_rawformer", "luma", ("h4", "2x2"), 1),
    ("simple_flca_unet", "packed256", ("h4",), 1),
    ("lumachroma_transformer", "packed256", ("h4", "2x2"), 2),
)


def zoo_tiled_cases(models=ZOO_TILED_MODELS):
    """(case, model, layout, compute dtype, frame key, timing) of phase 17:
    each model over each of its layouts in fp32 and in bf16 (a timed
    model's bf16 run by H timed: the gloo ranks' times on one card vary by
    2x between runs, and every timed forward adds to the phase)."""
    return [(f"{name}_{layout}_{tag}", name, layout, dtype, frame,
             timed if (tag, layout) == ("bf16", "h4") else 0)
            for name, frame, layouts, timed in models for layout in layouts
            for dtype, tag in ((torch.float32, "fp32"), (torch.bfloat16, "bf16"))]


def zoo_tiled_frames(rng) -> dict:
    """Phase 17's inputs: the phase-16 frame's normalised mosaic and its
    packed planes at 2832x4240, and smaller mosaics / packed planes for the
    WavKAN and token-attention models, each zero-padded as phase 16 pads
    (``tile_frame``: 4 blocks of a multiple of 16 rows by H, 2 x 2 too)."""
    def norm(shape):
        return (mosaics(rng, (1, *shape, 1)).astype(np.float32) - 512.0) / (16383.0 - 512.0)

    def pack(x):
        t = torch.nn.functional.pixel_unshuffle(torch.from_numpy(x).permute(0, 3, 1, 2), 2)
        return t.permute(0, 2, 3, 1).contiguous().numpy()

    frame = norm(TILED_FRAME)
    out = {"frame": tile_frame(frame, 16), "packed": tile_frame(pack(frame), 16)}
    for key, ((h, w), c) in ZOO_TILED_FRAMES.items():
        out[key] = tile_frame(norm((h, w)) if c == 1 else pack(norm((2 * h, 2 * w))), 16)
    return out


def zoo_tiled_references(jobdir: str, job: dict, dev, counters, card,
                         models=ZOO_TILED_MODELS) -> dict:
    """Phase 17's references on this one process, saved for rank 0: each
    model's seeded weights (BayerTORGB's spread first) on its whole input
    through the fp32 module path and the bf16 forward (the kernel path of
    the FLCA / TrueColor family), with the head's input of that family; the
    launches; the timed models' bf16 forward by the host clock (median of
    2). The weights
    go into ``job["states"]``."""
    from bayer_low_light_image_enhancement_tpu_torch.models import get_model
    from bayer_low_light_image_enhancement_tpu_torch.models.common import set_fused_blocks
    from bayer_low_light_image_enhancement_tpu_torch.models.registry import is_raw_domain

    out, job["states"] = {}, {}
    for name, frame, _, timed in models:
        x = torch.from_numpy(job[frame]).to(dev).permute(0, 3, 1, 2)
        guided, raw = name in ZOO_TILED_GUIDED, is_raw_domain(name)
        state = None
        for dtype, tag in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
            t0 = time.perf_counter()
            model = get_model(name, generator=torch.Generator().manual_seed(ZOO_TILED_SEED),
                              dtype=dtype).to(dev).eval()
            if state is None:
                set_fused_blocks(model, False)
                with torch.no_grad():
                    spread_color_correction(model, lambda: model(x[..., :512, :512]))
                state = {k: v.cpu() for k, v in model.state_dict().items()}
                job["states"][name] = state
            model.load_state_dict(state)
            set_fused_blocks(model, tag == "bf16")
            heads, hook = [], None
            if guided:
                hook = model.conv_out.register_forward_hook(
                    lambda m, i, o: heads.append(o.float()))

            def fwd():
                with torch.inference_mode():
                    y = model(x)
                    return (y if raw else y.clamp(0.0, 1.0)).permute(0, 2, 3, 1)

            y, launches = counted(counters, fwd)
            torch.save({"out": y.float().cpu(),
                        "head": heads[0].permute(0, 2, 3, 1).cpu() if heads else None},
                       f"{jobdir}/ref_{name}_{tag}.pt")
            rec = {"launches": launches, "seconds": time.perf_counter() - t0,
                   "shape": tuple(y.shape), "finite": bool(torch.isfinite(y).all())}
            if hook is not None:
                hook.remove()
            if timed and tag == "bf16":
                rec["ms"] = _step_ms(fwd, 2)
            out[f"{name}_{tag}"] = rec
            path = ("kernel path" if guided and tag == "bf16" else "module path" if guided
                    else "no hand kernel")
            log(f"phase 17 reference {name} {tag} ({path}) on {tuple(x.shape[2:])}: "
                f"{rec['seconds']:.1f} s, launches {launches}")
            del model, y, heads
            torch.cuda.empty_cache()
    return out


def dist_task_zoo_tiled(job: dict, dev) -> dict:
    """Phase 17 on every rank: each case of ``job["cases"]`` through
    ``make_tiled_forward`` on this rank's block of its input (the raw-domain
    planes not clipped), with the launches; rank 0 holds the whole output
    (and the FLCA / TrueColor family's gathered head input) against the
    parent's references; the timed cases' forward by the host clock (median
    of 2) and, at timing 2, one instrumented forward's all-reduces."""
    from bayer_low_light_image_enhancement_tpu_torch.core import mesh as meshlib
    from bayer_low_light_image_enhancement_tpu_torch.models import get_model
    from bayer_low_light_image_enhancement_tpu_torch.models.registry import is_raw_domain
    from bayer_low_light_image_enhancement_tpu_torch.ops.conv import gather_axis
    from bayer_low_light_image_enhancement_tpu_torch.parallel.tiled import (
        make_tiled_forward,
        shard_image,
    )

    meshes = {"h4": (meshlib.create_mesh(data=1, spatial=4), None),
              "2x2": (meshlib.create_mesh(data=1, spatial=2, spatial_w=2), "spatial_w")}
    out = {"world": meshlib.world_size(), "cases": {}}
    for name, model_name, layout, dtype, frame, timed in job["cases"]:
        t0 = time.perf_counter()
        mesh, w = meshes[layout]
        raw = is_raw_domain(model_name)
        model = get_model(model_name, dtype=dtype,
                          spatial_axis=("spatial", w) if w else "spatial")
        model.load_state_dict(job["states"][model_name])
        fn = make_tiled_forward(model.to(dev), mesh, "spatial", w, clip01=not raw)
        heads, hook = [], None
        if model_name in ZOO_TILED_GUIDED:
            hook = model.conv_out.register_forward_hook(lambda m, i, o: heads.append(
                gather_axis(gather_axis(o.float(), fn.axes[0], 2), fn.axes[1], 3)))
        x = torch.from_numpy(shard_image(job[frame], mesh, "spatial", w)).to(dev).contiguous()
        y, launches = counted(job["counters"], lambda: fn(x))
        rec = {"launches": launches, "sum": float(y.double().sum()), "shape": tuple(y.shape)}
        if meshlib.rank() == 0:
            ref = torch.load(f"{job['dir']}/ref_{model_name}_{name.rsplit('_', 1)[1]}.pt")
            for key, got in (("out", y), ("head", heads[0].permute(0, 2, 3, 1) if heads else None)):
                if got is None:
                    continue
                d = (got.float().cpu() - ref[key]).abs()
                rec[key] = {"max": d.max().item(), "mean": d.mean().item(),
                            "scale": ref[key].abs().max().item(),
                            "finite": bool(torch.isfinite(got).all())}
        del y
        heads.clear()
        if hook is not None:
            hook.remove()
        if timed:
            rec["ms"] = _step_ms(lambda: fn(x), 2)
        if timed == 2:
            rec["collective"] = collective_ms(lambda: fn(x), int(np.prod(rec["shape"])))
        rec["seconds"] = time.perf_counter() - t0
        out["cases"][name] = rec
        del model, fn, x, heads
        torch.cuda.empty_cache()
    return out


DIST_TASKS["zoo_tiled"] = dist_task_zoo_tiled


def zoo_tiled_phase(dev, card, counters, models=ZOO_TILED_MODELS, cli: bool = True) -> None:
    """Phase 17: spatially sharded inference of the rest of the zoo (see the
    tolerances above); ``models`` and ``cli`` cut it to a part."""
    import tempfile

    from bayer_low_light_image_enhancement_tpu_torch.models.registry import is_raw_domain

    t_phase = time.perf_counter()
    cards = torch.cuda.device_count()
    one_card = cards < 4
    backend = "gloo, 4 ranks sharing card 0" if one_card else "NCCL, one card a rank"
    log(f"phase 17 backend: {backend}")
    job = zoo_tiled_frames(np.random.default_rng(ZOO_TILED_SEED))
    job["cases"] = zoo_tiled_cases(models)
    log("phase 17 inputs: " + ", ".join(f"{k} {tuple(v.shape[1:])}" for k, v in job.items()
                                        if k != "cases")
        + " (zero-padded as phase 16 pads)")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_zoo_tiled_") as jobdir:
        refs = zoo_tiled_references(jobdir, job, dev, counters, card, models)
        for name, *_ in models:
            for tag in ("fp32", "bf16"):
                got = refs[f"{name}_{tag}"]["launches"]
                check(refs[f"{name}_{tag}"]["finite"], f"phase 17: {name} {tag} reference "
                      "not finite")
                if name in ZOO_TILED_GUIDED and tag == "bf16":
                    check(got["gram_pass"] == got["apply_pass"] == 6 and sum(got.values()) == 12,
                          f"phase 17: the {name} kernel path did not launch K2 / K3 6 times "
                          f"each and nothing else ({got})")
                else:
                    no_kernel(got, f"phase 17: the monolithic {name} {tag} forward")
        torch.save(job, f"{jobdir}/job.pt")
        res = run_dist_task(jobdir, "zoo_tiled", 4, one_card=one_card, phase=17)
    label = " (not a multi-GPU figure)" if one_card else ""
    r0 = res[0]
    for name, model_name, layout, dtype, frame, timed in job["cases"]:
        rec = r0["cases"][name]
        sums = {r["cases"][name]["sum"] for r in res}
        launched = {k: v for r in res for k, v in r["cases"][name]["launches"].items() if v}
        fp32, raw = dtype == torch.float32, is_raw_domain(model_name)
        for key in ("out", "head"):
            if key not in rec:
                continue
            e = rec[key]
            scale = e["scale"] if raw or key == "head" else 1.0
            ok = e["finite"] and (e["max"] <= TILED_FP32_ATOL * scale if fp32 else
                                  e["max"] <= E2E_MAX_TOL * scale
                                  and e["mean"] <= E2E_MEAN_TOL * scale)
            bar = (f"tol {TILED_FP32_ATOL}" if fp32 else f"tols {E2E_MAX_TOL} / {E2E_MEAN_TOL}")
            bar += f" x {scale:.3e}" if scale != 1.0 else ""
            what = "output" if key == "out" else "head's input"
            path = ("module path" if fp32 else "kernel path" if model_name in ZOO_TILED_GUIDED
                    else "bf16 forward")
            log(f"(17) {name} ({backend}): {what} max abs err {e['max']:.3e}, mean "
                f"{e['mean']:.3e} ({bar}, against the monolithic {path})")
            check(ok, f"phase 17: {name}: the tiled {what} disagrees with the monolithic one")
        log(f"(17) {name}: {rec['shape']} on every rank; launches on every rank "
            f"{launched or 'none'}; rank 0 {rec['seconds']:.1f} s")
        check(len(sums) == 1, f"phase 17: {name}: the ranks received different outputs")
        check(not launched, f"phase 17: {name}: a hand kernel launched on the tiled path "
              f"({launched})")
        if timed:
            per_rank = [round(r["cases"][name]["ms"], 2) for r in res]
            c = rec.get("collective")
            inst = "" if c is None else (
                f"; one instrumented forward on rank 0: {c['ms']:.2f} ms, {c['calls']} "
                f"all-reduces {c['all_reduce_ms']:.2f} ms ({c['all_reduce_ms'] / c['ms']:.1%}), "
                f"of them the output gather {c['gather_ms']:.2f} ms")
            log(f"time {name} tiled forward on {tuple(job[frame].shape[1:3])}, host clock per "
                f"rank (median of 2){label}: {per_rank} ms{inst}; the monolithic bf16 forward "
                f"{refs[f'{model_name}_bf16']['ms']:.2f} ms on one process ({card})")
    if cli:
        tiled_cli(card, counters, one_card, ["--model", "flca_rawformer"], (2, 2), 17)
    log(f"phase 17: {time.perf_counter() - t_phase:.1f} s ({card})")


# Phase 18, band mode: the single-card full-frame forward
# (models/fused_apply.py). The Sony ARW frame, 2848x4256, padded by the eval
# CLI's band route to 2944x4352 (pad 128) and cut into 8 bands of 368 mosaic
# rows: K2 / K3 see the bands at [8, 184, 2176, 32] ... [8, 23, 272, 256],
# and RawFormer-B's / -L's bottleneck at [8, 23, 272, 384] / [8, 23, 272,
# 512] (the wide widths, kernels/wide_block.py's chain, also held plain, and
# each kernel of the chain held and timed: wide_chain_kernels).
# Tolerances, stated before the run: the kernels in band mode against their
# band twins by phase 3's rules (K2_COS_TOL on the frame's cosines and
# relative sums of squares, BLOCK_ATOL / BLOCK_RTOL on K3); a banded frame
# against the monolithic forward of the same model at the serving bar
# (E2E_MAX_TOL / E2E_MEAN_TOL); the fp32 twin path, banded against
# monolithic with TF32 off, within BAND_FP32_TOL (the same fp32 function,
# its convs at other shapes and its grams summed by bands); the eval CLI's
# band route against its monolithic route at the same pad within
# EVAL_PSNR_TOL / EVAL_SSIM_TOL.
BAND_FRAME, BAND_PAD, BAND_SEED = (2848, 4256), 128, 18
BAND_FP32_TOL = 1e-4
BAND_SHAPES = [(8, 184, 2176, 32), (8, 92, 1088, 64), (8, 46, 544, 128), (8, 23, 272, 256),
               (8, 23, 272, 384), (8, 23, 272, 512)]
WIDE_BAND_SHAPE = BAND_SHAPES[-1]  # the wide rows of the kernel line


def band_counts(kind: str, b: int, hb: int, w: int, c: int) -> dict:
    """``block_counts`` of K2 / K3 in band mode on b bands of hb rows: the
    products on the bands' own rows, the 4 halo rows of each band's input
    read besides."""
    d = block_counts(kind, b, hb, w, c)
    d["nbytes"] += b * 4 * w * c * 2
    return d


def plain_block_kernels(x, wts, shape) -> tuple:
    """The plain K2 / K3 (no bands) on x [b, h, w, C] against their twins by
    phase 3's rules (phase 18 at a wide width: the bands as b images; phase
    19 at RawFormer-L's block shapes). -> (K2's cosine error, K3's max abs
    error)."""
    from bayer_low_light_image_enhancement_tpu_torch.kernels import fused_block as fb

    g, qs, ks = fb.gram_pass(x, wts)
    g0, qs0, ks0 = fb.gram_pass_plain(x, wts)
    e_cos = (g / torch.sqrt(qs[:, :, None] * ks[:, None, :])
             - g0 / torch.sqrt(qs0[:, :, None] * ks0[:, None, :])).abs().max().item()
    e_ss = max(((qs - qs0).abs() / qs0).max().item(), ((ks - ks0).abs() / ks0).max().item())
    apply = fb.finalize_attention(g0, qs0, ks0, wts.temperature, wts.wproj, 8)
    got = fb.apply_pass(x, apply, wts).float()
    ref = fb.apply_pass_plain(x, apply, wts).float()
    d = (got - ref).abs()
    bad = (d > BLOCK_ATOL + BLOCK_RTOL * ref.abs()).sum().item()
    log(f"K2 plain {shape}: cosine max abs err {e_cos:.3e}, sum-of-squares rel err {e_ss:.3e} "
        f"(tol {K2_COS_TOL}); K3 plain: max abs err {d.max().item():.3e}, mean "
        f"{d.mean().item():.3e}, {bad} elements outside atol=rtol={BLOCK_ATOL}")
    check(e_cos <= K2_COS_TOL and e_ss <= K2_COS_TOL, f"K2 disagrees with its twin at {shape}")
    check(bad == 0, f"K3 disagrees with its twin at {shape}")
    return e_cos, d.max().item()


def module_block_beside_kernels(x, c: int, bands: int, frame_h: int):
    """(module ms, kernels ms): a seeded bf16 TransformerBlock of width c on
    the bands x [b, hb, w, c] in band mode, through its band-aware module
    path (``fused`` False: what a wide block ran before the wide kernels)
    and through the kernels (the halo copy, K2, the frame sums, the
    finalise, K3), by CUDA events."""
    from bayer_low_light_image_enhancement_tpu_torch.kernels import fused_block as fb
    from bayer_low_light_image_enhancement_tpu_torch.models import common
    from bayer_low_light_image_enhancement_tpu_torch.utils.profiling import cuda_time_ms

    with torch.inference_mode(False):  # parameters, not inference tensors
        blk = common.TransformerBlock(c, 8, 2, device=x.device, dtype=torch.bfloat16,
                                      compute_dtype=torch.bfloat16)
        common.reset_parameters_(blk, torch.Generator().manual_seed(BAND_SEED + c))
    common.bind_bands(blk, bands)
    blk.fused = False
    xn = x.permute(0, 3, 1, 2)
    module_ms = cuda_time_ms(lambda: blk(xn), 10)
    params = dict(blk.named_parameters())
    kernel_ms = cuda_time_ms(lambda: fb.fused_transformer_block(x, params, 8, bands=bands,
                                                                frame_h=frame_h), 10)
    return module_ms, kernel_ms


# The rows of the wide chain's kernels (kernels/wide_block.py), K2 / K3 at C
# = 384 / 512: the kernel line holds them at WIDE_BAND_SHAPE, each row the
# kernel's launches in one banded bottleneck block (K2 then K3).
WIDE_ROWS = ("wide_layernorm", "wide_gemm", "wide_dw3x3", "wide_gram_finish")


def wide_chain_kernels(xh, bapply, wts, shape, card) -> dict:
    """Phase 18 at a wide width: each kernel of the wide K2 / K3 chain on the
    main path's tensors of one banded frame at ``shape`` (each step fed by
    the kernels' own outputs): held against its twin by phase 3's rule
    (BLOCK_ATOL / BLOCK_RTOL), timed by CUDA events beside its twin and,
    where one PyTorch call computes the same function (F.layer_norm, one
    bf16 torch.matmul / torch.bmm of the GEMM's shape, a depthwise
    F.conv2d), that call; the gram through the weight-grad pass timed
    too. -> {row: dict(err, ms, plain_ms, bound, library_ms)} summed over
    the row's launches in one block."""
    import torch.nn.functional as F

    from bayer_low_light_image_enhancement_tpu_torch.kernels import fused_block as fb
    from bayer_low_light_image_enhancement_tpu_torch.kernels import weight_grad as wgk
    from bayer_low_light_image_enhancement_tpu_torch.kernels import wide_block as wb
    from bayer_low_light_image_enhancement_tpu_torch.utils.profiling import cuda_time_ms

    b, hb, w, c = shape
    pg, pa = (wb.wide_plan(k, b, hb, w, c, b, b * hb) for k in ("gram", "apply"))
    wqk, bqk, dwqk, bdwqk = fb._gram_args(c, xh.device, *wts.gram_tensors())
    apply, wv, bv, dwv, bdwv, bproj, wp1, bp1, dwf, bdwf, wp2, bp2 = fb._apply_pass_args(
        xh, bapply, *wts.apply_tensors())
    acc = {r: dict(err=0.0, ms=0.0, plain_ms=0.0, nbytes=0.0, tc=0.0, fp32=0.0, library_ms=0.0)
           for r in WIDE_ROWS}
    acc["wide_gram_finish"]["library_ms"] = None  # no one PyTorch call places and sums

    def step(row, what, fn, twin, lib, **counts):
        got, ref = fn(), twin()
        pairs = zip(got, ref) if isinstance(got, tuple) else [(got, ref)]
        err = 0.0
        for a, r in pairs:
            d = (a.float() - r.float()).abs()
            bad = (d > BLOCK_ATOL + BLOCK_RTOL * r.float().abs()).sum().item()
            check(bad == 0, f"phase 18: {what} disagrees with its twin ({bad} elements)")
            err = max(err, d.max().item())
        ms, pms = cuda_time_ms(fn, 10), cuda_time_ms(twin, 3, warmup=1)
        lms = None if lib is None else cuda_time_ms(lib, 10)
        bms, by = bound(**counts)
        log(f"time wide {shape} {what}: {ms:.4f} ms (twin {pms:.4f}, bound {bms:.4f} by {by}"
            + ("" if lms is None else f", library call {lms:.4f}") + f"), max abs err {err:.3e} "
            f"({card})")
        a = acc[row]
        a["err"], a["ms"], a["plain_ms"] = max(a["err"], err), a["ms"] + ms, a["plain_ms"] + pms
        for key, v in counts.items():
            a[key] += v
        if lms is not None and a["library_ms"] is not None:
            a["library_ms"] += lms
        return got

    def ln(x, first, rows, what):
        n = x.shape[0] * rows * w * c
        return step("wide_layernorm", what, lambda: wb.layernorm_rows(x, first, rows),
                    lambda: wb.layernorm_rows_plain(x, first, rows),
                    lambda: F.layer_norm(x[:, first: first + rows], (c,)), nbytes=4.0 * n,
                    fp32=8.0 * n)

    def gemm(a, bm, bias, g, what, res=None):
        out_bytes = (2 if res is not None else 4) * g.g * g.m * g.n
        nbytes = (2 * g.g * g.m * g.k + 2 * (g.g if g.batched else 1) * g.k * g.n + 4 * g.n
                  + out_bytes + (0 if res is None else 2 * g.g * g.m * g.n))
        am = a.view(g.g, g.m, g.k) if g.batched else a.view(-1, g.k)
        lib = (lambda: torch.bmm(am, bm)) if g.batched else (lambda: torch.matmul(am, bm))
        return step("wide_gemm", f"{what} GEMM [{g.g * g.m}, {g.k}] @ [{g.k}, {g.n}]"
                    + (" per image" if g.batched else ""), lambda: wb.gemm(a, bm, bias, g, res),
                    lambda: wb.gemm_plain(a, bm, bias, g, res), lib, nbytes=float(nbytes),
                    tc=float(g.flops))

    def dw(z, taps, bias, d, what):
        outs = d.b * d.ro * d.w * d.f
        nbytes = 4 * d.b * d.rz * d.w * d.f + 2 * outs + 40 * d.f
        if d.epi == "qk":
            nbytes += 4 * d.b * d.nx * d.f
        zc = z.permute(0, 3, 1, 2)
        wk = taps.t().reshape(d.f, 1, 3, 3)
        return step("wide_dw3x3", f"{what} dw3x3 ({d.epi})", lambda: wb.dw3x3(z, taps, bias, d),
                    lambda: wb.dw3x3_plain(z, taps, bias, d),
                    lambda: F.conv2d(zc, wk, bias, padding=1, groups=d.f),
                    nbytes=float(nbytes), fp32=18.0 * outs)

    with torch.inference_mode():
        ((first, rows),), (gz,), (dg,) = pg.ln, pg.gemms, pg.dws
        z = gemm(ln(xh, first, rows, "K2 LayerNorm"), wqk, bqk, gz, "K2 [q|k]")
        q, k, part = dw(z, dwqk, bdwqk, dg, "K2")
        del z
        g_, kk, m, n = pg.gram
        pair = [(q.view(g_, kk, m), k.view(g_, kk, n))]
        gram = wgk.weight_grad(pair)[0]
        ref = wgk.weight_grad_plain(pair)[0]
        e_g = ((gram - ref).abs().max() / ref.abs().max()).item()
        t_g = cuda_time_ms(lambda: wgk.weight_grad(pair), 10)
        t_gt = cuda_time_ms(lambda: wgk.weight_grad_plain(pair), 3)
        t_gl = cuda_time_ms(lambda: torch.bmm(pair[0][0].transpose(1, 2), pair[0][1]), 10)
        bg, yg = bound(**weight_grad_counts([pg.gram]))
        log(f"time wide {shape} K2 gram through the weight-grad pass {pg.gram}: {t_g:.4f} ms "
            f"(twin {t_gt:.4f}, bf16 torch.bmm {t_gl:.4f}, bound {bg:.4f} by {yg}), max err "
            f"relative to the twin's max {e_g:.3e} ({card})")
        check(e_g <= 1e-3, "phase 18: the wide gram through the weight-grad pass disagrees")
        step("wide_gram_finish", "K2 finish", lambda: wb.gram_finish(gram, part),
             lambda: wb.gram_finish_plain(gram, part), None,
             nbytes=4.0 * (2 * b * c * c + b * dg.nx * 2 * c + 2 * b * c))
        del q, k, part, gram, ref
        (f1, r1), (f2, r2) = pa.ln
        gv, gy, gt, go = pa.gemms
        dv, df = pa.dws
        zv = gemm(ln(xh, f1, r1, "K3 LayerNorm 1"), wv, bv, gv, "K3 v")
        v = dw(zv, dwv, bdwv, dv, "K3 v")
        del zv
        y = gemm(v, apply, bproj, gy, "K3 y = x + v @ apply", res=xh)
        del v
        t = gemm(ln(y, f2, r2, "K3 LayerNorm 2"), wp1, bp1, gt, "K3 FFN expand")
        f = dw(t, dwf, bdwf, df, "K3 FFN")
        del t
        gemm(f, wp2, bp2, go, "K3 out = y + f @ wp2", res=y)
    log(f"wide chain scratch at {shape}: K2 {pg.scratch_bytes() / 1e9:.3f} GB, K3 "
        f"{pa.scratch_bytes() / 1e9:.3f} GB")
    return {r: dict(err=a["err"], ms=a["ms"], plain_ms=a["plain_ms"],
                    bound=bound(nbytes=a["nbytes"], tc=a["tc"], fp32=a["fp32"]),
                    library_ms=a["library_ms"]) for r, a in acc.items()}


def host_ms(fn, n: int = 5) -> float:
    """Host clock of one synchronised call of fn, mean over n after one."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


# What one K2 + K3 at C = 384 / 512 launches (kernels/wide_block.py): the
# chain's kernels and the weight-grad pass for the gram.
WIDE_CHAIN_LAUNCHES = {"layernorm_rows": 3, "gemm": 5, "dw3x3": 3, "gram_finish": 1,
                       "weight_grad": 1}


def wide_counters(counters) -> tuple:
    """``counters`` with the wide K2 / K3's and the wide chain's kernels'."""
    from bayer_low_light_image_enhancement_tpu_torch.kernels import fused_block as fb
    from bayer_low_light_image_enhancement_tpu_torch.kernels import wide_block as wb

    return tuple(counters) + (fb.gram_pass_banded_wide, fb.apply_pass_banded_wide, *wb.WRAPPERS)


def hold_launches(got, n, what, wide=0) -> None:
    """Check the counts of band-mode forwards (``counted`` over
    ``wide_counters``): K2 / K3 in band mode n times, ``wide`` of them at C
    = 384 / 512 through the wide chain (WIDE_CHAIN_LAUNCHES each), no other
    kernel."""
    band = ("gram_pass_banded", "apply_pass_banded")
    others = {k: v for k, v in got.items()
              if k not in band and k not in WIDE_CHAIN_LAUNCHES and not k.endswith("_wide")}
    check(got["gram_pass_banded"] == got["apply_pass_banded"] == n and sum(others.values()) == 0,
          f"{what} did not launch K2 / K3 in band mode {n} times and no other kernel: {got}")
    check(got["gram_pass_banded_wide"] == got["apply_pass_banded_wide"] == wide
          and all(got[k] == v * wide for k, v in WIDE_CHAIN_LAUNCHES.items()),
          f"{what} did not launch K2 / K3 in band mode at C >= 384 {wide} times through the "
          f"wide chain ({WIDE_CHAIN_LAUNCHES} each): {got}")


def serving_bar(a, b, what) -> None:
    """Check two outputs (RGB in [0, 1]) against each other at the serving
    bar, E2E_MAX_TOL / E2E_MEAN_TOL; numpy arrays or tensors."""
    d = (torch.as_tensor(a).float() - torch.as_tensor(b).float()).abs()
    log(f"{what}: max abs err {d.max().item():.3e} (tol {E2E_MAX_TOL}), mean "
        f"{d.mean().item():.3e} (tol {E2E_MEAN_TOL})")
    check(d.max().item() <= E2E_MAX_TOL and d.mean().item() <= E2E_MEAN_TOL, f"{what} disagrees")


def banded_phase(dev, card, counters) -> dict:
    """Phase 18: K2 / K3 in band mode against their twins at the frame's
    band shapes (timed beside the frame's monolithic K2 / K3; at the wide
    widths also the plain kernels against their twins, and the bf16
    band-aware module-path block timed beside them), the RawFormer-S frame
    banded against the monolithic kernel path with the launch counts (7
    band-mode K2 and K3, no other block kernel; a pipelined model runs K3
    too), the fp32 twin path banded against monolithic, RawFormer-B and -L
    banded against their monolithic forwards (7 band-mode K2 / K3 each, one
    of them at the 384 / 512-wide bottleneck; no module-path block), and the
    eval CLI's band route against its monolithic route on a synthetic SID
    frame. -> the band-mode kernel rows' launches, errors, times and
    bounds."""
    import tempfile

    import torch.nn.functional as F

    from bayer_low_light_image_enhancement_tpu_torch.cli import test_cli
    from bayer_low_light_image_enhancement_tpu_torch.data.synthetic import write_sid_tree
    from bayer_low_light_image_enhancement_tpu_torch.kernels import fused_block as fb
    from bayer_low_light_image_enhancement_tpu_torch.kernels import wide_block as wb
    from bayer_low_light_image_enhancement_tpu_torch.models import common, get_model
    from bayer_low_light_image_enhancement_tpu_torch.models.fused_apply import (
        make_banded_forward,
        pick_bands,
    )
    from bayer_low_light_image_enhancement_tpu_torch.ops.conv import band_halo
    from bayer_low_light_image_enhancement_tpu_torch.probes import floor as probes
    from bayer_low_light_image_enhancement_tpu_torch.utils.profiling import cuda_time_ms, profile

    t_phase = time.perf_counter()
    rng = np.random.default_rng(BAND_SEED)
    gen = torch.Generator().manual_seed(BAND_SEED)
    names = ("fused_block_gram_banded", "fused_block_apply_banded")
    wide_names = ("fused_block_gram_banded_wide", "fused_block_apply_banded_wide")
    out = {"errs": dict.fromkeys(names + wide_names, 0.0), "times": {}, "bounds": {},
           "library": {}}

    # (a) The kernels against their band twins, one frame of 8 bands a level.
    with torch.inference_mode():
        for shape in BAND_SHAPES:
            b, hb, w, c = shape
            wts = probes.block_weights(c, BAND_SEED + c, dev)
            x = torch.randn(shape, generator=gen).to(dev, torch.bfloat16)
            xh, fh = band_halo(x, 2, b), b * hb
            g, qs, ks = (fb._banded_sums(t, b) for t in fb.gram_pass_banded(xh, wts, b, fh))
            g0, qs0, ks0 = (fb._banded_sums(t, b)
                            for t in fb.gram_pass_banded_plain(xh, wts, b, fh))
            cos = g / torch.sqrt(qs[:, :, None] * ks[:, None, :])
            cos0 = g0 / torch.sqrt(qs0[:, :, None] * ks0[:, None, :])
            e_cos = (cos - cos0).abs().max().item()
            e_ss = max(((qs - qs0).abs() / qs0).max().item(), ((ks - ks0).abs() / ks0).max().item())
            apply = fb.finalize_attention(g0, qs0, ks0, wts.temperature, wts.wproj, 8)
            bapply = apply.repeat_interleave(b, 0)
            got = fb.apply_pass_banded(xh, bapply, wts, b, fh).float()
            ref = fb.apply_pass_banded_plain(xh, bapply, wts, b, fh).float()
            d = (got - ref).abs()
            bad = (d > BLOCK_ATOL + BLOCK_RTOL * ref.abs()).sum().item()
            log(f"K2 band mode {shape}: frame cosine max abs err {e_cos:.3e}, sum-of-squares rel "
                f"err {e_ss:.3e} (tol {K2_COS_TOL}); K3 band mode: max abs err "
                f"{d.max().item():.3e}, mean {d.mean().item():.3e}, {bad} elements outside "
                f"atol=rtol={BLOCK_ATOL}")
            check(e_cos <= K2_COS_TOL and e_ss <= K2_COS_TOL,
                  f"K2 in band mode disagrees with its twin at {shape}")
            check(bad == 0, f"K3 in band mode disagrees with its twin at {shape}")
            row = wide_names if c in fb.WIDE_WIDTHS else names
            out["errs"][row[0]] = max(out["errs"][row[0]], e_cos)
            out["errs"][row[1]] = max(out["errs"][row[1]], d.max().item())
            del got, ref, d
            if c in fb.WIDE_WIDTHS:
                plain_block_kernels(x, wts, shape)
                chain = wide_chain_kernels(xh, bapply, wts, shape, card)
                if shape == WIDE_BAND_SHAPE:
                    for r, v in chain.items():
                        out["errs"][r] = v["err"]
                        out["times"][r] = (v["ms"], v["plain_ms"])
                        out["bounds"][r] = v["bound"]
                        out["library"][r] = v["library_ms"]
            frame = x.reshape(1, b * hb, w, c)
            n = 10
            ka = cuda_time_ms(lambda: fb.gram_pass_banded(xh, wts, b, fh), n)
            kb = cuda_time_ms(lambda: fb.apply_pass_banded(xh, bapply, wts, b, fh), n)
            pa = cuda_time_ms(lambda: fb.gram_pass_banded_plain(xh, wts, b, fh), 3, warmup=1)
            pb = cuda_time_ms(lambda: fb.apply_pass_banded_plain(xh, bapply, wts, b, fh), 3,
                              warmup=1)
            ma = cuda_time_ms(lambda: fb.gram_pass(frame, wts), n)
            mb = cuda_time_ms(lambda: fb.apply_pass(frame, apply, wts), n)
            kh = cuda_time_ms(lambda: band_halo(x, 2, b), n)
            (b2, y2), (b3, y3) = (bound(**band_counts(k, *shape)) for k in ("gram", "apply"))
            log(f"time band mode {shape}: K2 {ka:.4f} ms (twin {pa:.3f}, bound {b2:.4f} by {y2}), "
                f"K3 {kb:.4f} ms (twin {pb:.3f}, bound {b3:.4f} by {y3}), the halo copy "
                f"{kh:.4f} ms; the frame [1, {b * hb}, {w}, {c}] monolithic: K2 {ma:.4f} ms, K3 "
                f"{mb:.4f} ms ({card})")
            if c in fb.WIDE_WIDTHS:
                blk_ms, kern_ms = module_block_beside_kernels(x, c, b, fh)
                log(f"time band mode {shape}: the whole block on the kernels (halo copy, K2, "
                    f"frame sums, finalise, K3) {kern_ms:.4f} ms beside the bf16 band-aware "
                    f"module-path block {blk_ms:.4f} ms ({card})")
            if shape in (BAND_SHAPES[0], WIDE_BAND_SHAPE):
                row = wide_names if c in fb.WIDE_WIDTHS else names
                out["times"].update({row[0]: (ka, pa), row[1]: (kb, pb)})
                out["bounds"].update({row[0]: (b2, y2), row[1]: (b3, y3)})
            del x, xh, frame
        torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # (b) RawFormer-S on the frame, banded against monolithic.
    raw = mosaics(rng, BAND_FRAME).astype(np.float32)
    img = np.clip((raw - 512.0) / (16383.0 - 512.0), 0.0, None) * 100.0
    ph, pw = (-BAND_FRAME[0]) % BAND_PAD, (-BAND_FRAME[1]) % BAND_PAD
    xp = F.pad(torch.from_numpy(img).to(dev)[None, None], (0, pw, 0, ph))
    k = pick_bands(xp.shape[2])
    check(k == 8 and tuple(xp.shape[2:]) == (2944, 4352),
          f"phase 18: the frame pads to {tuple(xp.shape[2:])} in {k} bands, not 2944x4352 in 8")
    log(f"phase 18 frame: {BAND_FRAME} zero-padded to {tuple(xp.shape[2:])}, {k} bands of "
        f"{xp.shape[2] // k} mosaic rows")
    band_counters = wide_counters(counters)

    model = get_model("rawformer_s", device=dev, dtype=torch.bfloat16,
                      generator=torch.Generator().manual_seed(0)).eval()
    banded = make_banded_forward(model, k)
    with torch.inference_mode():
        y_band, launches = counted(band_counters, lambda: banded(xp))
        hold_launches(launches, 7, "phase 18: the banded RawFormer-S frame")
        out["launches"] = launches
        y_mono, mono_launches = counted(band_counters, lambda: model(xp))
        check(mono_launches["gram_pass"] == mono_launches["apply_pass"] == 7
              and mono_launches["gram_pass_banded"] == 0,
              f"phase 18: the monolithic frame's launches {mono_launches}")
        check(y_band.shape == (1, 3, *xp.shape[2:]) and bool(torch.isfinite(y_band).all()),
              "phase 18: the banded frame is not finite of the frame's shape")
        serving_bar(y_band, y_mono, "phase 18: RawFormer-S frame, banded vs monolithic kernel path")
        common.set_apply_kernel(model, "pipelined")
        y_pipe, pipe_launches = counted(band_counters, lambda: banded(xp))
        common.set_apply_kernel(model, "tiled")
        hold_launches(pipe_launches, 7, "phase 18: the banded frame with apply_kernel='pipelined'")
        check(torch.equal(y_pipe, y_band), "phase 18: the pipelined model's banded frame differs")
        del y_pipe
        t_band, t_mono = (cuda_time_ms(fn, 10, warmup=3) for fn in (lambda: banded(xp),
                                                                      lambda: model(xp)))
        h_band, h_mono = (host_ms(fn) for fn in (lambda: banded(xp), lambda: model(xp)))
        p_band, p_mono = (profile(fn, steps=3, warmup=1) for fn in (lambda: banded(xp),
                                                                      lambda: model(xp)))
        _, peak_band, held = peak_memory(lambda: banded(xp))
        _, peak_mono, _ = peak_memory(lambda: model(xp))
    log(f"time RawFormer-S frame {tuple(xp.shape[2:])}: banded ({k} bands) {t_band:.3f} ms by CUDA "
        f"events, {h_band:.3f} ms host clock, {p_band['device_ms']:.3f} ms device "
        f"({p_band['busy']:.0%} busy), peak {peak_band:.2f} GiB; monolithic {t_mono:.3f} ms, "
        f"{h_mono:.3f} ms host, {p_mono['device_ms']:.3f} ms device ({p_mono['busy']:.0%} busy), "
        f"peak {peak_mono:.2f} GiB (above {held:.2f} GiB held) ({card})")
    log("  banded frame's kernels by device time: " + ", ".join(
        f"{name[:60]} {ms:.3f} ms x{calls:g}" for name, ms, calls in p_band["kernels"][:8]))
    del y_band, y_mono, banded, model
    torch.cuda.empty_cache()

    # (c) The fp32 twin path, banded against monolithic (TF32 off).
    m32 = get_model("rawformer_s", device=dev, generator=torch.Generator().manual_seed(0)).eval()
    with torch.inference_mode(), twin_blocks():
        y32_band = make_banded_forward(m32, k)(xp)
        y32_mono = m32(xp)
        d32 = (y32_band - y32_mono).abs().max().item()
    log(f"fp32 twin path, RawFormer-S frame banded vs monolithic: max abs err {d32:.3e} (tol "
        f"{BAND_FP32_TOL}; TF32 {torch.backends.cuda.matmul.allow_tf32} / "
        f"{torch.backends.cudnn.allow_tf32})")
    check(d32 <= BAND_FP32_TOL, "phase 18: the banded fp32 twin path disagrees with monolithic")
    del m32, y32_band, y32_mono
    torch.cuda.empty_cache()

    # (d) RawFormer-B and -L: every block on the kernels in band mode, the
    # bottleneck at the wide widths.
    out["wide_launches"] = dict.fromkeys(("gram_pass_banded_wide", "apply_pass_banded_wide",
                                          *WIDE_CHAIN_LAUNCHES), 0)
    for size in ("B", "L"):
        mdl = get_model(f"rawformer_{size.lower()}", device=dev, dtype=torch.bfloat16,
                        generator=torch.Generator().manual_seed(0)).eval()
        fwd = make_banded_forward(mdl, k)
        attn = []
        hooks = [m.register_forward_hook(lambda *a: attn.append(1))
                 for m in mdl.modules() if isinstance(m, common.ChannelAttention)]
        with torch.inference_mode():
            (y_b, got), peak_b, held = peak_memory(lambda: counted(band_counters,
                                                                   lambda: fwd(xp)))
            hold_launches(got, 7, f"phase 18: the banded RawFormer-{size} frame", wide=1)
            check(not attn, f"phase 18: the banded RawFormer-{size} frame ran {len(attn)} "
                  f"module-path attention blocks")
            for kk in out["wide_launches"]:
                out["wide_launches"][kk] += got[kk]
            for h in hooks:
                h.remove()
            y_m, peak_m, _ = peak_memory(lambda: mdl(xp))
            check(bool(torch.isfinite(y_b).all()), f"phase 18: RawFormer-{size} not finite")
            serving_bar(y_b, y_m, f"phase 18: RawFormer-{size} frame, banded vs monolithic")
            del y_b, y_m
            tb, tm = (cuda_time_ms(fn, 3, warmup=1) for fn in (lambda: fwd(xp),
                                                                 lambda: mdl(xp)))
        hw = (xp.shape[2] // 16 // k, xp.shape[3] // 16)  # the bottleneck's band rows, width
        wc = mdl.config.dim * 8
        scratch = [wb.wide_plan(kind, k, hw[0], hw[1], wc, k, k * hw[0]).scratch_bytes()
                   for kind in ("gram", "apply")]
        log(f"time RawFormer-{size} frame {tuple(xp.shape[2:])}: banded {tb:.3f} ms, monolithic "
            f"{tm:.3f} ms by CUDA events; peak {peak_b:.2f} / {peak_m:.2f} GiB above {held:.2f} "
            f"GiB held; the wide chain's scratch at its [{k}, {hw[0]}, {hw[1]}, {wc}] bottleneck: "
            f"K2 {scratch[0] / 1e9:.3f} GB, K3 {scratch[1] / 1e9:.3f} GB ({card})")
        del mdl, fwd
        torch.cuda.empty_cache()
        # Its fp32 twin path, banded (every block on the band twins) against
        # monolithic (the bottleneck on the fp32 module path), TF32 off.
        m32 = get_model(f"rawformer_{size.lower()}", device=dev,
                        generator=torch.Generator().manual_seed(0)).eval()
        with torch.inference_mode(), twin_blocks():
            d32 = (make_banded_forward(m32, k)(xp) - m32(xp)).abs().max().item()
        log(f"fp32 twin path, RawFormer-{size} frame banded vs monolithic: max abs err "
            f"{d32:.3e} (tol {BAND_FP32_TOL})")
        check(d32 <= BAND_FP32_TOL,
              f"phase 18: RawFormer-{size}'s banded fp32 twin path disagrees with monolithic")
        del m32
        torch.cuda.empty_cache()

    # (e) The eval CLI's band route against its monolithic route at pad 128.
    with tempfile.TemporaryDirectory(prefix="chip_smoke_band_") as tmp:
        root = f"{tmp}/sid"
        write_sid_tree(root, f"{root}/cache", {"test": [BAND_FRAME]}, rng)
        base = ["--dataset", "SID", "--data_root", root, "--cache_dir", f"{root}/cache"]
        t0 = time.perf_counter()
        res_band, bl = counted(band_counters, lambda: test_cli.main(
            base + ["--save_dir", f"{tmp}/band"]))
        t_cli = time.perf_counter() - t0
        check(bl["bayer_pack_normalize"] == 1, f"phase 18: the eval CLI's launches {bl}")
        hold_launches({kk: v for kk, v in bl.items() if kk != "bayer_pack_normalize"}, 7,
                      "phase 18: the eval CLI's band route")
        route = test_cli.band_count
        test_cli.band_count = lambda *a: 1
        try:
            res_mono, ml = counted(band_counters, lambda: test_cli.main(
                base + ["--pad_to", str(BAND_PAD), "--save_dir", f"{tmp}/mono"]))
        finally:
            test_cli.band_count = route
        check(ml["gram_pass"] == ml["apply_pass"] == 7 and ml["gram_pass_banded"] == 0,
              f"phase 18: the monolithic eval CLI's launches {ml}")
    dp = abs(res_band["psnr"][0] - res_mono["psnr"][0])
    ds = abs(res_band["ssim"][0] - res_mono["ssim"][0])
    log(f"eval CLI on a {BAND_FRAME} SID frame: band route PSNR {res_band['psnr']} SSIM "
        f"{res_band['ssim']} ({res_band['seconds'][0]:.3f} s an image, {t_cli:.1f} s the CLI), "
        f"monolithic route at pad {BAND_PAD} PSNR {res_mono['psnr']} SSIM {res_mono['ssim']} "
        f"({res_mono['seconds'][0]:.3f} s): differences {dp:.2e} dB (tol {EVAL_PSNR_TOL}), "
        f"{ds:.2e} (tol {EVAL_SSIM_TOL}) ({card})")
    check(dp <= EVAL_PSNR_TOL and ds <= EVAL_SSIM_TOL,
          "phase 18: the eval CLI's band route disagrees with its monolithic route")
    log(f"phase 18: {time.perf_counter() - t_phase:.1f} s ({card})")
    return out


# Phase 19: RawFormer-B and -L (dim 48 / 64, heads 8/8/8/8, FFN 2, seeded
# random weights, fp32 params, bf16 compute) served and trained at crop
# size. Every block of width <= 256 runs the kernels (K2 / K3 serving, K2 /
# K3 / B1 / B2 and the weight-grad pass from C = 96 on training), where the
# JAX package runs its Pallas kernels or wider (JAX serving fuses up to
# models/fused_apply.py's FUSE_CMAX = 256, JAX training only C <= 64,
# kernels/fused_block_bwd.py's trainable_fusable); the 384 / 512-wide
# bottleneck takes the module path in both, as the JAX package's does.
# Tolerances, stated before the run: serving, kernel path vs twin path at
# the serving bar (E2E_MAX_TOL / E2E_MEAN_TOL); the first train step by
# ``held_train_step`` with phase 11's MEDIAN_YARD; K2 / K3 / B1 / B2 at
# RawFormer-L's block shapes by phase 3's rules (K2_COS_TOL, BLOCK_ATOL /
# BLOCK_RTOL, max(3 x the bf16 twin's error, BWD_FLOOR) a backward leaf);
# RawFormer-L's eval CLI from its train CLI checkpoint, band route against
# --no_fused, within EVAL_PSNR_TOL / EVAL_SSIM_TOL an image.
SIZES, SIZES_SEED = ("B", "L"), 19
SIZES_REQUESTS, SIZES_BATCH, SIZES_CROP = 3, 8, 512
# The kernel blocks of a batch-8 @ 512^2 forward or step (levels 1-3, each
# level twice); all timed at batch 8 and 16, L's held against the twins.
SIZES_BLOCK_SHAPES = {"B": [(8, 256, 256, 48), (8, 128, 128, 96), (8, 64, 64, 192)],
                      "L": [(8, 256, 256, 64), (8, 128, 128, 128), (8, 64, 64, 256)]}
# The kernel line's rows of the phase: K2 / K3 / B1 / B2 at L's first level.
SIZES_ROWS = {"gram": "fused_block_gram_l", "apply": "fused_block_apply_l",
              "bwd1": "fused_block_bwd1_l", "bwd2": "fused_block_bwd2_l"}


def seeded_block(c: int, gen, dev, log_temperature: bool = False):
    """A TransformerBlock of width c (8 heads, FFN 2) reset from ``gen``,
    its LN affines and temperatures moved off their init by U(-0.3, 0.3)."""
    from bayer_low_light_image_enhancement_tpu_torch.models import common

    blk = common.TransformerBlock(c, 8, 2, log_temperature=log_temperature, device=dev)
    common.reset_parameters_(blk, gen)
    with torch.no_grad():
        for name, p in blk.named_parameters():
            if "norm" in name or "temperature" in name:
                p.add_(torch.empty(p.shape).uniform_(-0.3, 0.3, generator=gen).to(dev))
    return blk


def size_model(size: str, dev, dtype=torch.bfloat16):
    from bayer_low_light_image_enhancement_tpu_torch.models import get_model

    return get_model(f"rawformer_{size.lower()}", device=dev, dtype=dtype,
                     generator=torch.Generator().manual_seed(SIZES_SEED))


def module_attention_widths(model, fn):
    """fn() with a hook on every ChannelAttention of ``model``: -> (its
    result, the widths of the module-path attentions it ran, in order)."""
    from bayer_low_light_image_enhancement_tpu_torch.models import common

    seen = []
    hooks = [m.register_forward_hook(lambda m, i, o: seen.append(i[0].shape[1]))
             for m in model.modules() if isinstance(m, common.ChannelAttention)]
    try:
        return fn(), seen
    finally:
        for h in hooks:
            h.remove()


def sizes_kernels(dev, card) -> dict:
    """Phase 19 (c): K2, K3, B1 and B2 (the weight-grad pass inside B1 / B2
    at C >= 96) at RawFormer-L's three block shapes against their twins by
    phase 3's rules; the four as whole wrapper calls at B's and L's block
    shapes of batch 8 and 16 beside their twins and bounds
    (``block_kernel_times``), and at the split widths the weight-grad pass
    on B1's three products and B2's one beside its twin, its bound and one
    bf16 ``torch.matmul`` of B2's product. -> the rows SIZES_ROWS (L at
    [8,256,256,64]; max_abs_err over L's three shapes)."""
    from bayer_low_light_image_enhancement_tpu_torch.kernels import fused_block as fb
    from bayer_low_light_image_enhancement_tpu_torch.kernels import fused_block_bwd as fbb
    from bayer_low_light_image_enhancement_tpu_torch.kernels import weight_grad as wgk
    from bayer_low_light_image_enhancement_tpu_torch.utils.profiling import cuda_time_ms

    gen = torch.Generator().manual_seed(SIZES_SEED)
    out = {"errs": dict.fromkeys(SIZES_ROWS.values(), 0.0), "times": {}, "bounds": {},
           "library": {}}
    errs = out["errs"]
    with torch.no_grad():  # not inference mode: the twins differentiate with autograd
        for size in SIZES:
            for first in SIZES_BLOCK_SHAPES[size]:
                c = first[-1]
                blk = seeded_block(c, gen, dev)
                wts = fb.fold_block_params({k: v.detach() for k, v in blk.named_parameters()})
                for b in (8, 16):
                    shape = (b,) + first[1:]
                    x = torch.randn(shape, generator=gen).to(dev, torch.bfloat16)
                    dy = (0.05 * torch.randn(shape, generator=gen)).to(dev, torch.bfloat16)
                    if size == "L" and b == 8:
                        e_cos, e_k3 = plain_block_kernels(x, wts, shape)
                        e1, e2 = hold_backward(x, dy, wts,
                                               f"phase 19: B1/B2 {shape} (RawFormer-L's block)")
                        for kind, e in zip(SIZES_ROWS, (e_cos, e_k3, e1, e2)):
                            errs[SIZES_ROWS[kind]] = max(errs[SIZES_ROWS[kind]], e)
                    what = f"RawFormer-{size}'s block"
                    times = block_kernel_times(x, dy, wts, card, what)
                    if size == "L" and shape == SIZES_BLOCK_SHAPES["L"][0]:
                        for kind, (ms, twin_ms, bnd) in times.items():
                            out["times"][SIZES_ROWS[kind]] = (ms, twin_ms)
                            out["bounds"][SIZES_ROWS[kind]] = bnd
                    if fbb.weight_grad_regime(c) == "split":
                        p1, p2 = weight_grad_pairs(x, dy, wts)
                        w1 = cuda_time_ms(lambda: wgk.weight_grad(p1), 20)
                        w2 = cuda_time_ms(lambda: wgk.weight_grad(p2), 20)
                        pw2 = cuda_time_ms(lambda: wgk.weight_grad_plain(p2), 3, warmup=1)
                        (a2, b2), = p2
                        lw2 = cuda_time_ms(lambda: torch.matmul(a2.mT, b2), 20)
                        (bw1, yw1), (bw2, yw2) = (bound(**weight_grad_counts(
                            [(a.shape[0], a.shape[1], a.shape[2], bb.shape[2]) for a, bb in ps]))
                            for ps in (p1, p2))
                        log(f"time weight-grad pass {shape} ({what}): B1's products {w1:.4f} ms "
                            f"(bound {bw1:.4f} by {yw1}), B2's {w2:.4f} ms (twin {pw2:.3f}, "
                            f"torch.matmul bf16 {lw2:.4f}, bound {bw2:.4f} by {yw2}); products "
                            f"{[tuple(a.shape) + (bb.shape[2],) for a, bb in p1 + p2]} ({card})")
                        del p1, p2, a2, b2
                    del x, dy
                del blk
            torch.cuda.empty_cache()
    return out


def sizes_serving(dev, card, counters) -> dict:
    """Phase 19 (a): RawFormer-B and -L answer SIZES_REQUESTS batch-8 @
    512^2 uint16 requests through ``Predictor.raw_u16``: per forward K1
    once, K2 / K3 six times, no other kernel and one module-path attention
    (the bottleneck); the first request against the twin path (K1's and
    the blocks' fp32 twins) at the serving bar; the forward timed by CUDA
    events, the profiler's device time and the host clock, with the
    kernels' and the twin path's times and the peak memory. -> each size's
    launches."""
    from bayer_low_light_image_enhancement_tpu_torch.serving import Predictor
    from bayer_low_light_image_enhancement_tpu_torch.utils.profiling import cuda_time_ms, profile

    rng = np.random.default_rng(SIZES_SEED)
    launches = {}
    for size in SIZES:
        model = size_model(size, dev)
        d = model.config.dim
        pred = Predictor(model, device=dev)
        requests = [(mosaics(rng, (SIZES_BATCH, SIZES_CROP, SIZES_CROP)),
                     rng.uniform(50.0, 300.0, SIZES_BATCH).astype(np.float32))
                    for _ in range(SIZES_REQUESTS)]
        t0 = time.perf_counter()
        (outs, got), attn = module_attention_widths(model, lambda: counted(
            counters, lambda: [pred.raw_u16(m, r) for m, r in requests]))
        serve_s = time.perf_counter() - t0
        what = (f"phase 19: RawFormer-{size} serving {SIZES_REQUESTS} x {SIZES_BATCH} x "
                f"{SIZES_CROP}^2 u16 requests")
        n = SIZES_REQUESTS
        want = dict.fromkeys(got, 0)
        want.update(bayer_pack_normalize=n, gram_pass=6 * n, apply_pass=6 * n)
        log(f"{what} in {serve_s:.2f} s; launches {got}; module-path attention widths {attn}")
        check(got == want, f"{what}: launches {got}, expected {want}")
        check(attn == [8 * d] * n, f"{what}: module-path attentions {attn}, expected one at "
              f"{8 * d} a forward")
        for (m, _), y in zip(requests, outs):
            check(y.shape == m.shape + (3,) and bool(np.isfinite(y).all()) and y.min() >= 0.0
                  and y.max() <= 1.0, f"{what}: output not finite in [0, 1] of shape {m.shape}")
        launches[size] = got
        md, rd = u16_to_device(requests[0][0]), torch.from_numpy(requests[0][1]).to(dev)
        serving_bar(outs[0], twin_u16_forward(model, md, rd),
                    f"phase 19: RawFormer-{size} kernel path vs twin path, "
                    f"{SIZES_BATCH} x {SIZES_CROP}^2")
        with torch.inference_mode():
            fwd = lambda: pred._u16_forward(md, rd)  # noqa: E731
            ms = cuda_time_ms(fwd, 10, warmup=3)
            h_ms = host_ms(fwd)
            prof = profile(fwd, steps=3, warmup=1)
            _, peak, held = peak_memory(fwd)
            with twin_blocks():
                twin_ms = cuda_time_ms(fwd, 3, warmup=1)
        k23 = sum(t for k, t, _ in prof["kernels"] if re.search(r"gram|apply[12]_kernel", k))
        mp = SIZES_BATCH * SIZES_CROP ** 2 / 1e6
        log(f"time RawFormer-{size} u16 forward, batch {SIZES_BATCH} @ {SIZES_CROP}^2: {ms:.3f} "
            f"ms by CUDA events ({mp / ms * 1e3:.1f} MP/s), {h_ms:.3f} ms host clock, "
            f"{prof['device_ms']:.3f} ms device ({prof['busy']:.0%} busy, K2 + K3 {k23:.3f} ms); "
            f"twin blocks {twin_ms:.3f} ms; peak {peak:.2f} GiB ({peak - held:.2f} above the "
            f"{held:.2f} held) ({torch.cuda.get_device_name(0)}; nvidia-smi: {card})")
        log(f"  RawFormer-{size} forward's kernels by device time: " + ", ".join(
            f"{k[:60]} {t:.3f} ms x{c:g}" for k, t, c in prof["kernels"][:8]))
        del pred, model, outs, md, rd
        torch.cuda.empty_cache()
    return launches


def sizes_training(dev, card, counters, train_cfg) -> dict:
    """Phase 19 (b): RawFormer-B and -L train through ``Trainer`` on
    synthetic batch-8 @ 512^2 crops: the first step by ``held_train_step``
    (phase 11's MEDIAN_YARD; the bottleneck's attention leaves logged), per
    step K2 / K3 / B1 / B2 six times and the weight-grad pass eight times
    (twice a block of width >= 96), nothing else; 20 steps on one batch
    lower the loss with no NaN-guard skip; the step at batch 8 and 16 on the
    kernel and the module path (CUDA events, peak memory; one profiled
    kernel-path step at batch 8: B1 + B2's and the weight-grad pass's
    device time). -> each size's launches of a step."""
    from bayer_low_light_image_enhancement_tpu_torch.kernels import fused_block_bwd as fbb
    from bayer_low_light_image_enhancement_tpu_torch.train import Trainer
    from bayer_low_light_image_enhancement_tpu_torch.utils.profiling import cuda_time_ms, profile

    batch = synthetic_batch(dev, SIZES_BATCH, SIZES_CROP)
    launches = {}
    for size in SIZES:
        t0 = time.perf_counter()
        model = size_model(size, dev)
        widths, d = fused_block_widths(model), model.config.dim
        del model
        want = {c.__name__: 0 for c in counters}
        want.update(gram_pass=len(widths), apply_pass=len(widths), bwd1=len(widths),
                    bwd2=len(widths),
                    weight_grad=2 * sum(fbb.weight_grad_regime(c) == "split" for c in widths))
        what = f"phase 19: RawFormer-{size} train step, batch {SIZES_BATCH} @ {SIZES_CROP}^2"
        kern, losses, got = held_train_step(
            lambda: size_model(size, dev), train_cfg, batch, counters, what,
            show=lambda n: n.startswith("conv_tran4.Transformer.attn."), median_yard=MEDIAN_YARD)
        log(f"{what}: launches {got} (kernel blocks at widths {widths})")
        check(widths == [d, 2 * d, 4 * d, 4 * d, 2 * d, d] and got == want,
              f"{what}: launches {got}, expected {want}")
        launches[size] = got
        for _ in range(18):
            losses.append(float(kern.train_step(batch)))
        log(f"RawFormer-{size} 20 steps on one batch: loss {losses[0]:.5f} -> {losses[-1]:.5f}; "
            f"{kern.step - kern.applied} of {kern.step} steps skipped by the NaN guard")
        check(bool(np.isfinite(losses).all()) and losses[-1] < losses[0],
              f"{what}: 20 steps on one batch did not lower its loss")
        check(kern.applied == kern.step == 20, f"{what}: the NaN guard skipped a step")
        del kern
        torch.cuda.empty_cache()
        for bs in (8, 16):
            b = batch if bs == SIZES_BATCH else tuple(torch.cat([t] * (bs // SIZES_BATCH))
                                                       for t in batch)
            for path in ("kernel", "module"):
                tr = Trainer(size_model(size, dev),
                             dataclasses.replace(train_cfg, fused_blocks=path == "kernel"))
                tr.train_step(b)
                ms, peak, held = peak_memory(lambda: cuda_time_ms(lambda: tr.train_step(b), 5,
                                                                  warmup=2))
                split = ""
                if path == "kernel" and bs == SIZES_BATCH:
                    r = profile(lambda: tr.train_step(b), 1, warmup=0)
                    bwd = sum(t for k, t, _ in r["kernels"]
                              if re.search(r"bwd[12]_kernel|sum_partials_kernel", k))
                    wg = sum(t for k, t, _ in r["kernels"] if "weight_grad_kernel" in k)
                    split = (f"; one profiled step: {r['device_ms']:.3f} ms of device time in "
                             f"{r['host_ms']:.3f} ms of host clock ({100 * r['busy']:.1f}% busy), "
                             f"B1 + B2 {bwd:.3f} ms ({bwd / r['device_ms']:.1%} of the device "
                             f"time), the weight-grad pass {wg:.3f} ms")
                log(f"time RawFormer-{size} train step, batch {bs} @ {SIZES_CROP}^2, {path} path "
                    f"(CUDA events, after warmup): {ms:.3f} ms, "
                    f"{bs * SIZES_CROP ** 2 / 1e6 / ms * 1e3:.1f} MP/s, peak memory {peak:.2f} "
                    f"GiB, {peak - held:.2f} above the {held:.2f} held before{split} "
                    f"({torch.cuda.get_device_name(0)}; nvidia-smi: {card})")
                del tr
                torch.cuda.empty_cache()
        log(f"RawFormer-{size} training: {time.perf_counter() - t0:.1f} s")
    del batch
    torch.cuda.empty_cache()
    return launches


def sizes_cli(card, counters) -> None:
    """Phase 19 (d): the user's workflow for RawFormer-L on a phase-9 SID
    tree (8 training pairs at REAL_TRAIN_FRAME, 2 test pairs at
    REAL_TEST_FRAME): the train CLI with ``--model_size L --loader native``
    for one epoch (K2 / K3 six times a step and a validation forward, B1 /
    B2 six and the weight-grad pass eight times a step, K1 never), then
    ``--resume`` for one more; the eval CLI from its checkpoint on the
    2832x4240 frames, whose band route runs K2 / K3 in band mode (7 an
    image, one of them at the 512-wide bottleneck through the wide chain)
    and K1 once an image, against ``--no_fused`` (the module path, K1 only)
    within EVAL_PSNR_TOL / EVAL_SSIM_TOL an image, one CSV row an image."""
    import tempfile

    from bayer_low_light_image_enhancement_tpu_torch.cli import test_cli, train_cli
    from bayer_low_light_image_enhancement_tpu_torch.data.synthetic import write_sid_tree

    def run(what, fn):
        t0 = time.perf_counter()
        out, got = counted(counters, fn)
        log(f"{what}: {time.perf_counter() - t0:.2f} s; launches {got} ({card})")
        return out, got

    rng = np.random.default_rng(SIZES_SEED)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sizes_") as tmp:
        root, save = f"{tmp}/sid", f"{tmp}/run"
        write_sid_tree(root, f"{root}/cache",
                       {"train": [REAL_TRAIN_FRAME] * 8, "test": [REAL_TEST_FRAME] * 2}, rng)
        data = ["--dataset", "SID", "--data_root", root, "--cache_dir", f"{root}/cache",
                "--model_size", "L"]
        train = data + ["--loader", "native", "--batch_size", "8", "--patch_size", "512",
                        "--save_dir", save]
        for epochs, resume in ((0, []), (1, ["--resume"])):
            _, tl = run(f"phase 19: train CLI, RawFormer-L, SID, native loader, batch 8 @ "
                        f"512^2, --epochs {epochs} {' '.join(resume)}",
                        lambda: train_cli.main(train + ["--epochs", str(epochs)] + resume))
            want = dict.fromkeys(tl, 0)
            # One step and one validation forward (both test frames) an epoch.
            want.update(gram_pass=12, apply_pass=12, bwd1=6, bwd2=6, weight_grad=8)
            check(tl == want, f"phase 19: the train CLI's launches {tl}, expected {want}")
        with open(f"{save}/SID/log.txt") as f:
            text = f.read()
        check("Epoch 0/0" in text and "Epoch 1/1" in text,
              "phase 19: the train CLI did not log epoch 0 and, resumed, epoch 1")
        saved = sorted(f for f in os.listdir(f"{save}/SID/weights") if f.endswith(".pt"))
        check(saved == ["0.pt", "1.pt"], f"phase 19: the train CLI saved {saved}")
        runs = {}
        for name, extra in (("band route", []), ("--no_fused", ["--no_fused"])):
            out, el = run(f"phase 19: eval CLI, RawFormer-L from the train CLI's checkpoint, "
                          f"2 x {REAL_TEST_FRAME}, {name}", lambda: test_cli.main(
                              data + ["--ckpt", f"{save}/SID/weights", "--save_dir",
                                      f"{tmp}/eval_{len(runs)}"] + extra))
            check(el["bayer_pack_normalize"] == 2, f"phase 19: eval CLI ({name}) ran K1 "
                  f"{el['bayer_pack_normalize']} times for 2 images")
            rest = {k: v for k, v in el.items() if k != "bayer_pack_normalize"}
            if extra:
                no_kernel(rest, f"phase 19: the eval CLI with {name}")
            else:
                hold_launches(rest, 14, f"phase 19: the eval CLI's band route", wide=2)
            with open(f"{tmp}/eval_{len(runs)}/SID/csv/test_metrics.csv") as f:
                rows = f.read().splitlines()
            check(len(rows) == 2 and all(np.isfinite(out["psnr"])),
                  f"phase 19: eval CLI ({name}) wrote {len(rows)} CSV rows, PSNR {out['psnr']}")
            log(f"eval CLI ({name}): PSNR {out['psnr']}, SSIM {out['ssim']}, host seconds per "
                f"image {[round(t, 3) for t in out['seconds']]} ({card})")
            runs[name] = out
    dp = np.abs(np.subtract(*(r["psnr"] for r in runs.values()))).max()
    ds = np.abs(np.subtract(*(r["ssim"] for r in runs.values()))).max()
    log(f"phase 19: RawFormer-L eval CLI, band route vs --no_fused: max PSNR difference "
        f"{dp:.4f} dB (tol {EVAL_PSNR_TOL}), max SSIM difference {ds:.2e} (tol {EVAL_SSIM_TOL})")
    check(dp <= EVAL_PSNR_TOL and ds <= EVAL_SSIM_TOL,
          "phase 19: RawFormer-L's band route disagrees with --no_fused")


def sizes_counters(counters) -> tuple:
    """``wide_counters(counters)`` with A1's and T1's: phase 19 holds that
    no kernel of theirs runs."""
    from bayer_low_light_image_enhancement_tpu_torch.kernels import fused_attention as fa
    from bayer_low_light_image_enhancement_tpu_torch.kernels import fused_stage as fs

    return wide_counters(counters) + (fa.fused_channel_attention, fs.fused_stage_tail)


def sizes_phase(dev, card, counters, train_cfg) -> dict:
    """Phase 19: RawFormer-B and -L at crop size (serving, training, the
    kernels at their block shapes, RawFormer-L's train -> eval CLI
    workflow). -> the kernel line's rows SIZES_ROWS ("errs", "times",
    "bounds", "library") and "launches" ({row: launches}: K2 / K3 of
    RawFormer-L's serving, B1 / B2 of its train step)."""
    t_phase = time.perf_counter()
    counters = sizes_counters(counters)
    serve = sizes_serving(dev, card, counters)
    log(f"phase 19 serving: {time.perf_counter() - t_phase:.1f} s")
    steps = sizes_training(dev, card, counters, train_cfg)
    log(f"phase 19 training: {time.perf_counter() - t_phase:.1f} s")
    out = sizes_kernels(dev, card)
    log(f"phase 19 kernels: {time.perf_counter() - t_phase:.1f} s")
    sizes_cli(card, counters)
    out["launches"] = {SIZES_ROWS["gram"]: serve["L"]["gram_pass"],
                       SIZES_ROWS["apply"]: serve["L"]["apply_pass"],
                       SIZES_ROWS["bwd1"]: steps["L"]["bwd1"],
                       SIZES_ROWS["bwd2"]: steps["L"]["bwd2"]}
    log("phase 19 launches, serving (3 requests) / a train step: "
        + json.dumps({"serving": serve, "train step": steps}))
    log(f"phase 19: {time.perf_counter() - t_phase:.1f} s ({card})")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--dist-rank"]:
        return dist_rank_main(*sys.argv[2:5])
    from bayer_low_light_image_enhancement_tpu_torch.kernels import _build
    from bayer_low_light_image_enhancement_tpu_torch.kernels import bayer_pack as bp
    from bayer_low_light_image_enhancement_tpu_torch.data import (
        Loader,
        SyntheticBayerDataset,
        prefetch_to_device,
    )
    from bayer_low_light_image_enhancement_tpu_torch.kernels import fused_attention as fa
    from bayer_low_light_image_enhancement_tpu_torch.kernels import fused_block as fb
    from bayer_low_light_image_enhancement_tpu_torch.kernels import fused_block_bwd as fbb
    from bayer_low_light_image_enhancement_tpu_torch.kernels import fused_stage as fs
    from bayer_low_light_image_enhancement_tpu_torch.kernels import ssm_scan as ssk
    from bayer_low_light_image_enhancement_tpu_torch.kernels import weight_grad as wgk
    from bayer_low_light_image_enhancement_tpu_torch.models import common, get_model
    from bayer_low_light_image_enhancement_tpu_torch.ops import ssm
    from bayer_low_light_image_enhancement_tpu_torch.probes import floor as probes
    from bayer_low_light_image_enhancement_tpu_torch.serving import Predictor
    from bayer_low_light_image_enhancement_tpu_torch.train import TrainConfig, Trainer
    from bayer_low_light_image_enhancement_tpu_torch.utils.profiling import cuda_time_ms

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    # 1. environment --------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    card = smi[0].strip()
    log(f"torch {torch.__version__}  CUDA {torch.version.cuda}  python {sys.version.split()[0]}")
    log(f"devices: {torch.cuda.device_count()}  {torch.cuda.get_device_name(0)}")

    # 2. build --------------------------------------------------------------
    t0 = time.perf_counter()
    so = _build.build()
    _build.library()
    log(f"build: {time.perf_counter() - t0:.1f} s -> {so.name}")
    for line in ptxas_summary(open(f"{so}.log").read()):
        log("  ptxas:", line)

    # 3. kernels against twins ------------------------------------------------
    errs = {"bayer_pack": 0.0, "fused_block_gram": 0.0, "fused_block_apply": 0.0,
            "fused_block_bwd1": 0.0, "fused_block_bwd2": 0.0, "weight_grad": 0.0,
            "fused_block_apply_pipelined": 0.0, "fused_attention": 0.0, "fused_stage_tail": 0.0}

    def held_to_block_rule(name, what, got, ref):
        """Log and check got against ref under atol = rtol = BLOCK_*; keep the
        max abs err as errs[name] (name None: not a kernel row)."""
        d = (got.float() - ref.float()).abs()
        bad = (d > BLOCK_ATOL + BLOCK_RTOL * ref.float().abs()).sum().item()
        log(f"{what}: max abs err {d.max().item():.3e}, mean {d.mean().item():.3e}, "
            f"{bad} elements outside atol=rtol={BLOCK_ATOL}")
        check(bad == 0, f"{what}: kernel disagrees with its twin")
        if name:
            errs[name] = max(errs[name], d.max().item())

    def check_gram_apply(shape, x, params, wts, what=""):
        """K2, K3 and the K2+K3 block against their twins on x; -> (K3's
        attention input, K3's twin output, the block's output)."""
        g, qs, ks = fb.gram_pass(x, wts)
        g0, qs0, ks0 = fb.gram_pass_plain(x, wts)
        cos = g / torch.sqrt(qs[:, :, None] * ks[:, None, :])
        cos0 = g0 / torch.sqrt(qs0[:, :, None] * ks0[:, None, :])
        e_cos = (cos - cos0).abs().max().item()
        e_ss = max(((qs - qs0).abs() / qs0).max().item(), ((ks - ks0).abs() / ks0).max().item())
        log(f"K2 gram {shape}{what}: cosine max abs err {e_cos:.3e} (tol {K2_COS_TOL}); "
            f"sum-of-squares rel err {e_ss:.3e} (tol {K2_COS_TOL})")
        check(e_cos <= K2_COS_TOL and e_ss <= K2_COS_TOL, f"K2 disagrees with its twin at {shape}")
        errs["fused_block_gram"] = max(errs["fused_block_gram"], e_cos)

        apply = fb.finalize_attention(g0, qs0, ks0, wts.temperature, wts.wproj, 8)
        ref = fb.apply_pass_plain(x, apply, wts)
        held_to_block_rule("fused_block_apply", f"K3 apply {shape}{what}",
                           fb.apply_pass(x, apply, wts), ref)
        full = fb.fused_transformer_block(x, params, 8)
        held_to_block_rule(None, f"K2+K3 block {shape}{what}", full,
                           fb.fused_transformer_block_plain(x, params, 8))
        return apply, ref, full

    def attn_params(c):
        return {k.removeprefix("attn."): v for k, v in blocks[c].named_parameters()
                if k.startswith("attn.")}

    def tail_params(c):
        return {k: v.detach() for k, v in tails[c].state_dict().items()
                if not k.startswith("Transformer.")}
    with torch.inference_mode():
        for shape in PACK_SHAPES:
            m = u16_to_device(mosaics(rng, shape))
            r = torch.from_numpy(rng.uniform(1.0, 300.0, shape[0]).astype(np.float32)).cuda()
            got = bp.bayer_pack_normalize(m, r, torch.bfloat16, clamp01=True)
            ref = bp.bayer_pack_normalize_plain(m, r, torch.float32, clamp01=True)
            e = (got.float() - ref).abs().max().item()
            got32 = bp.bayer_pack_normalize(m, r, torch.float32, clamp01=False)
            ref32 = bp.bayer_pack_normalize_plain(m, r, torch.float32, clamp01=False)
            e32 = ((got32 - ref32).abs() / ref32.abs().clamp_min(1.0)).max().item()
            log(f"K1 bayer_pack {shape}: bf16+clamp max abs err {e:.3e} (tol {K1_TOL}); "
                f"fp32 rel err {e32:.3e} (tol 1e-5)")
            check(e <= K1_TOL and e32 <= 1e-5, f"K1 disagrees with its twin at {shape}")
            errs["bayer_pack"] = max(errs["bayer_pack"], e)

        gen = torch.Generator().manual_seed(1)
        tail_gen = torch.Generator().manual_seed(2)
        blocks, tails = {}, {}
        for fn in (fa.fused_channel_attention, fs.fused_stage_tail):
            fn.launches = 0
        for shape in BATCH_SHAPES + FULLRES_SHAPES:
            b, h, w, c = shape
            if c not in tails:
                tails[c] = common.ConvTransformer(c, 8, 2, device=dev,
                                                  compute_dtype=torch.bfloat16)
                common.reset_parameters_(tails[c], tail_gen)
            if c not in blocks:
                blocks[c] = seeded_block(c, gen, dev)
            params = dict(blocks[c].named_parameters())
            wts = fb.fold_block_params(params)
            x = torch.randn(shape, generator=gen).to(dev, torch.bfloat16)
            apply, ref, full = check_gram_apply(shape, x, params, wts)
            held_to_block_rule("fused_block_apply_pipelined", f"K3P apply {shape}",
                               fb.apply_pass_pipelined(x, apply, wts), ref)
            held_to_block_rule("fused_attention", f"A1 attention {shape}",
                               fa.fused_channel_attention(x, attn_params(c), 8),
                               fa.fused_channel_attention_plain(x, attn_params(c), 8))
            t = full.to(torch.bfloat16)  # the stage's own transformer-branch output
            held_to_block_rule("fused_stage_tail", f"T1 stage tail {shape}",
                               fs.fused_stage_tail(x, t, tail_params(c)),
                               fs.fused_stage_tail_plain(x, t, tail_params(c)))
            del x, ref, full, t
        torch.cuda.synchronize()
    aux_launches = {"fused_attention": fa.fused_channel_attention.launches,
                    "fused_stage_tail": fs.fused_stage_tail.launches}
    check(min(aux_launches.values()) == len(BATCH_SHAPES + FULLRES_SHAPES),
          f"A1 / T1 did not launch once per shape: {aux_launches}")
    # K2 / K3 at the FLCA / TrueColor family's block shapes, on blocks that
    # store log_temperature (BayerTORGB's), with non-trivial LN affines.
    with torch.inference_mode():
        for shape in ZOO_BLOCK_SHAPES:
            blk = seeded_block(shape[-1], gen, dev, log_temperature=True)
            params = dict(blk.named_parameters())
            x = torch.randn(shape, generator=gen).to(dev, torch.bfloat16)
            check_gram_apply(shape, x, params, fb.fold_block_params(params), ", log_temperature")
            del x, blk, params
        torch.cuda.synchronize()
    # A1 at the widths the block shapes skip, and its finalise kernel against
    # finalize_attention at every width and head count 1-8 (random q, k).
    with torch.inference_mode():
        for c in (48, 96, 192):
            amod = common.ChannelAttention(c, 8, device=dev)
            common.reset_parameters_(amod, gen)
            ap = {k: v.detach() for k, v in amod.state_dict().items()}
            x = torch.randn(2, 40, 60, c, generator=gen).to(dev, torch.bfloat16)
            held_to_block_rule("fused_attention", f"A1 attention [2, 40, 60, {c}]",
                               fa.fused_channel_attention(x, ap, 8),
                               fa.fused_channel_attention_plain(x, ap, 8))
        fin_err = 0.0
        for c in fb.KERNEL_WIDTHS:
            q, k = (torch.randn(2, 64, c, generator=gen).to(dev) for _ in "qk")
            gram, qss, kss = torch.einsum("bpc,bpd->bcd", q, k), (q * q).sum(1), (k * k).sum(1)
            sums = torch.cat([gram.reshape(2, c * c), qss, kss], dim=1).contiguous()
            wproj = (torch.randn(c, c, generator=gen) / c ** 0.5).to(dev)
            for heads in (1, 2, 4, 8):
                temp = torch.empty(heads).uniform_(0.5, 3.0, generator=gen).to(dev)
                got = fa.attention_finalize(sums, temp, wproj, heads).float()
                want = fb.finalize_attention(gram, qss, kss, temp, wproj, heads)
                d = (got - want).abs()
                bad = (d > FINALIZE_ATOL + FINALIZE_RTOL * want.abs()).sum().item()
                check(bad == 0, f"A1 finalise C={c} heads={heads}: {bad} elements outside "
                      f"rtol={FINALIZE_RTOL} atol={FINALIZE_ATOL}")
                fin_err = max(fin_err, d.max().item())
        log(f"A1 finalise at C in {fb.KERNEL_WIDTHS}, heads 1/2/4/8: max abs err {fin_err:.3e} "
            f"(rtol {FINALIZE_RTOL}, atol {FINALIZE_ATOL})")
        del x, q, k, gram, sums

    bwd_inputs, wg_inputs = {}, {}
    with torch.no_grad():
        for shape in BATCH_SHAPES:
            c = shape[-1]
            wts = fb.fold_block_params({k: v.detach() for k, v in blocks[c].named_parameters()})
            x = torch.randn(shape, generator=gen).to(dev, torch.bfloat16)
            dy = (0.05 * torch.randn(shape, generator=gen)).to(dev, torch.bfloat16)
            bwd_inputs[shape] = (x, dy, wts)
            e1, e2 = hold_backward(x, dy, wts, f"B1/B2 {shape}")
            errs["fused_block_bwd1"] = max(errs["fused_block_bwd1"], e1)
            errs["fused_block_bwd2"] = max(errs["fused_block_bwd2"], e2)
            if fbb.weight_grad_regime(c) == "split":
                # The weight-grad pass on the operands B1 and B2 write here.
                pairs = weight_grad_pairs(x, dy, wts)
                before = wgk.weight_grad.launches
                outs = [o for ps in pairs for o in wgk.weight_grad(ps)]
                check(wgk.weight_grad.launches == before + len(pairs), "weight_grad did not launch")
                wants = [o for ps in pairs for o in wgk.weight_grad_plain(ps)]
                rel = max(((o - r).abs().max() / r.abs().max()).item() for o, r in zip(outs, wants))
                log(f"weight-grad pass {shape} on B1's and B2's operands: max error {rel:.3e} of "
                    f"each product's max (tol {WG_TOL})")
                check(rel <= WG_TOL, f"weight_grad disagrees with its twin at {shape}")
                errs["weight_grad"] = max(errs["weight_grad"], rel)
                wg_inputs[shape] = pairs
        torch.cuda.synchronize()

    # 4. serving --------------------------------------------------------------
    model = get_model("rawformer_s", device=dev, generator=torch.Generator().manual_seed(0),
                      dtype=torch.bfloat16)
    pred = Predictor(model, device=dev)
    requests = [(mosaics(rng, (8, 512, 512)),
                 rng.uniform(50.0, 300.0, 8).astype(np.float32)) for _ in range(3)]
    frames = []
    for hw in ((2832, 4240), (1000, 1500)):
        raw = mosaics(rng, hw).astype(np.float32)
        frames.append(np.clip((raw - 512.0) / (16383.0 - 512.0), 0.0, None) * 100.0)
    counters = kernel_counters()
    torch.cuda.synchronize()
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    outs = [pred.raw_u16(m, r) for m, r in requests] + [pred(f) for f in frames]
    serve_s = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    log(f"served 3 x 8 x 512^2 u16 requests + 2 frames in {serve_s:.2f} s; launches {launches}")
    forwards = len(requests) + len(frames)
    check(launches["bayer_pack_normalize"] == len(requests), "K1 did not run once per u16 request")
    check(launches["gram_pass"] == 7 * forwards, "K2 did not run 7 times per forward")
    check(launches["apply_pass"] == 7 * forwards, "K3 did not run 7 times per forward")
    check(launches["apply_pass_pipelined"] == 0, "K3P ran on the tiled path")
    check(launches["bwd1"] == launches["bwd2"] == launches["weight_grad"] == 0,
          "a backward kernel ran while serving")
    check(launches["selective_scan_fwd"] == 0, "a scan kernel ran in RawFormer-S")
    for (m, _), y in zip(requests, outs):
        check(y.shape == m.shape + (3,), f"bad output shape {y.shape}")
    for f, y in zip(frames, outs[len(requests):]):
        check(y.shape == f.shape + (3,), f"bad output shape {y.shape}")
    for y in outs:
        check(bool(np.isfinite(y).all()) and y.min() >= 0.0 and y.max() <= 1.0,
              "output not finite in [0, 1]")

    m0, r0 = requests[0]
    twin = twin_u16_forward(model, u16_to_device(m0), torch.from_numpy(r0).to(dev))
    d = np.abs(outs[0] - twin)
    log(f"kernel path vs twin path, 8 x 512^2: max abs err {d.max():.3e} (tol {E2E_MAX_TOL}), "
        f"mean {d.mean():.3e} (tol {E2E_MEAN_TOL})")
    check(d.max() <= E2E_MAX_TOL and d.mean() <= E2E_MEAN_TOL, "kernel path disagrees with twin path")

    # 4a. serving with the pipelined apply pass: a model of the same seed
    # (Predictor sets the apply kernel on the model it is given).
    pmodel = get_model("rawformer_s", device=dev, generator=torch.Generator().manual_seed(0),
                       dtype=torch.bfloat16)
    ppred = Predictor(pmodel, device=dev, apply_kernel="pipelined")
    frame_u16 = (mosaics(rng, (2832, 4240)), 100.0)
    torch.cuda.synchronize()
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    pouts = [ppred.raw_u16(m, r) for m, r in requests + [frame_u16]]
    pserve_s = time.perf_counter() - t0
    pipe_launches = {fn.__name__: fn.launches for fn in counters}
    log(f"pipelined path served 3 x 8 x 512^2 u16 requests + one 2832x4240 u16 frame in "
        f"{pserve_s:.2f} s; launches {pipe_launches}")
    pforwards = len(requests) + 1
    check(pipe_launches["apply_pass_pipelined"] == 7 * pforwards,
          "K3P did not run 7 times per forward")
    check(pipe_launches["apply_pass"] == 0, "K3 ran on the pipelined path")
    check(pipe_launches["gram_pass"] == 7 * pforwards
          and pipe_launches["bayer_pack_normalize"] == pforwards,
          "K1 / K2 did not run on the pipelined path")
    check(pipe_launches["bwd1"] == pipe_launches["bwd2"] == pipe_launches["weight_grad"] == 0,
          "a backward kernel ran while serving")
    for (m, _), y in zip(requests + [frame_u16], pouts):
        check(y.shape == m.shape + (3,) and bool(np.isfinite(y).all()) and y.min() >= 0.0
              and y.max() <= 1.0, f"pipelined output not finite in [0, 1] of shape {m.shape}")
    d = np.abs(pouts[0] - twin)
    log(f"pipelined kernel path vs twin path, 8 x 512^2: max abs err {d.max():.3e} (tol "
        f"{E2E_MAX_TOL}), mean {d.mean():.3e} (tol {E2E_MEAN_TOL})")
    check(d.max() <= E2E_MAX_TOL and d.mean() <= E2E_MEAN_TOL,
          "pipelined kernel path disagrees with twin path")

    # 4b. training ------------------------------------------------------------
    train_ds = SyntheticBayerDataset(num_images=8, full_size=(576, 576), patch_size=512,
                                     training=True)
    loader = Loader(train_ds, 8, seed=0, num_threads=8)

    def device_batches(n):
        """n synthetic batch-8 @ 512^2 crops through Loader + prefetch_to_device."""
        out = []
        while len(out) < n:
            out += list(prefetch_to_device(((i, g) for i, g, _ in loader), dev))
        return out[:n]

    def rawformer_s():
        return get_model("rawformer_s", device=dev, generator=torch.Generator().manual_seed(0),
                         dtype=torch.bfloat16)

    # The CLI's default lr. The second step is the first at a nonzero lr; Adam
    # moves each param by about lr, so params can differ by at most ~2 lr: the
    # grads are held on their own (TRAIN_GRAD_*).
    train_cfg = TrainConfig(base_lr=1e-4, warmup_epochs=1, steps_per_epoch=1)
    trainer = Trainer(rawformer_s(), train_cfg)
    steps = device_batches(3)
    torch.cuda.synchronize()
    for fn in counters:
        fn.launches = 0
    train_losses = [float(trainer.train_step(b)) for b in steps]
    torch.cuda.synchronize()
    train_launches = {fn.__name__: fn.launches for fn in counters}
    log(f"trained RawFormer-S 3 steps at batch 8 @ 512^2: losses {train_losses}; "
        f"launches {train_launches}")
    for name in ("gram_pass", "apply_pass", "bwd1", "bwd2"):
        check(train_launches[name] == 7 * len(steps), f"{name} did not run 7 times per train step")
    check(train_launches["weight_grad"] == 6 * len(steps),
          "the weight-grad pass did not run 6 times per train step")
    check(all(np.isfinite(train_losses)), "non-finite training loss")

    fixed = steps[0]
    kern, kern_losses, _ = held_train_step(
        rawformer_s, train_cfg, fixed, counters, "RawFormer-S train step, batch 8 @ 512^2",
        show=lambda n: n == "conv_tran3.Transformer.attn.temperature")
    for _ in range(18):
        kern_losses.append(float(kern.train_step(fixed)))
    log(f"20 steps on one batch: loss {kern_losses[0]:.5f} -> {kern_losses[-1]:.5f}")
    check(kern_losses[-1] < kern_losses[0], "20 steps on one batch did not lower its loss")
    val = SyntheticBayerDataset(num_images=4, full_size=(512, 512), patch_size=512,
                                training=False, seed=1)
    vin, vgt, _ = next(iter(Loader(val, 4, shuffle=False, drop_last=False)))
    _, val_psnr = kern.eval_step((torch.from_numpy(vin).to(dev), torch.from_numpy(vgt).to(dev)))
    log(f"eval_step per-image PSNR: {val_psnr.tolist()}")
    check(val_psnr.shape == (4,) and bool(torch.isfinite(val_psnr).all()), "eval PSNR not finite")
    del kern

    # 4c. one train step with the pipelined apply pass, from the same init on
    # the same batch as the tiled kernel path's first step.
    pm = rawformer_s()
    common.set_apply_kernel(pm, "pipelined")
    ptrain = Trainer(pm, train_cfg)
    torch.cuda.synchronize()
    for fn in counters:
        fn.launches = 0
    ploss = float(ptrain.train_step(fixed))
    torch.cuda.synchronize()
    ptrain_launches = {fn.__name__: fn.launches for fn in counters}
    dl = abs(ploss - kern_losses[0]) / abs(kern_losses[0])
    log(f"pipelined train step at batch 8 @ 512^2: loss {ploss} vs tiled {kern_losses[0]} (rel "
        f"err {dl:.3e}, tol {TRAIN_LOSS_RTOL}); launches {ptrain_launches}")
    for name in ("gram_pass", "apply_pass_pipelined", "bwd1", "bwd2"):
        check(ptrain_launches[name] == 7, f"{name} did not run 7 times in the pipelined step")
    check(ptrain_launches["weight_grad"] == 6, "the weight-grad pass did not run 6 times")
    check(ptrain_launches["apply_pass"] == 0, "K3 ran in the pipelined train step")
    check(dl <= TRAIN_LOSS_RTOL, "pipelined train loss disagrees with the tiled path")
    del ptrain, pm

    # 5. timing ---------------------------------------------------------------
    times, bounds, library, bwd_ms = {}, {}, {}, {}
    with torch.inference_mode():
        for shape in PACK_SHAPES:
            m = u16_to_device(mosaics(rng, shape))
            r = torch.full((shape[0],), 100.0, device=dev)
            k = cuda_time_ms(lambda: bp.bayer_pack_normalize(m, r, torch.bfloat16, True), 20)
            p = cuda_time_ms(lambda: bp.bayer_pack_normalize_plain(m, r, torch.bfloat16, True), 20)
            gbs = m.numel() * 4 / (k * 1e-3) / 1e9
            bk1, by1 = bound(nbytes=m.numel() * 4 + 4 * shape[0], fp32=4.0 * m.numel())
            log(f"time K1 {shape}: kernel {k:.4f} ms ({gbs:.0f} GB/s), twin {p:.4f} ms, "
                f"bound {bk1:.4f} ms by {by1}")
            times.setdefault("bayer_pack", (k, p))
        for shape in BATCH_SHAPES + FULLRES_SHAPES:
            c = shape[-1]
            params = dict(blocks[c].named_parameters())
            wts = fb.fold_block_params(params)
            x = torch.randn(shape, device=dev).to(torch.bfloat16)
            g0, qs0, ks0 = fb.gram_pass_plain(x, wts)
            apply = fb.finalize_attention(g0, qs0, ks0, wts.temperature, wts.wproj, 8)
            n = 10
            ka = cuda_time_ms(lambda: fb.gram_pass(x, wts), n)
            pa = cuda_time_ms(lambda: fb.gram_pass_plain(x, wts), n)
            kb = cuda_time_ms(lambda: fb.apply_pass(x, apply, wts), n)
            pb = cuda_time_ms(lambda: fb.apply_pass_plain(x, apply, wts), n)
            kf = cuda_time_ms(lambda: fb.fused_transformer_block(x, params, 8), n)
            pf = cuda_time_ms(lambda: fb.fused_transformer_block_plain(x, params, 8), n)
            (b2, y2), (b3, y3) = (bound(**block_counts(kind, *shape)) for kind in ("gram", "apply"))
            log(f"plan {shape}: {block_plan_line(fb, shape)}")
            log(f"time block {shape}: K2 {ka:.3f} ms (twin {pa:.3f}, bound {b2:.4f} by {y2}), K3 "
                f"{kb:.3f} ms (twin {pb:.3f}, bound {b3:.4f} by {y3}), whole block {kf:.3f} ms "
                f"(twin {pf:.3f})")
            times.setdefault("fused_block_gram", (ka, pa))
            times.setdefault("fused_block_apply", (kb, pb))

            # K3P beside K3 (in turns: K3, K3P, K3P, K3), A1 beside its twin
            # and the ChannelAttention module, T1 beside its twin and the
            # module tail (cuDNN convs + LeakyReLU + concat + reduce).
            kb0 = cuda_time_ms(lambda: fb.apply_pass(x, apply, wts), n)
            kp = [cuda_time_ms(lambda: fb.apply_pass_pipelined(x, apply, wts), n) for _ in "12"]
            kb1 = cuda_time_ms(lambda: fb.apply_pass(x, apply, wts), n)
            kp, kb3 = sum(kp) / 2, (kb0 + kb1) / 2
            log(f"time K3P {shape}: {kp:.3f} ms (K3 in the same turns {kb3:.3f} ms, twin "
                f"{pb:.3f}, bound {b3:.4f} by {y3})")
            ap = attn_params(c)
            amod = common.ChannelAttention(c, 8, device=dev, compute_dtype=torch.bfloat16)
            amod.load_state_dict(blocks[c].attn.state_dict())
            x4 = x.permute(0, 3, 1, 2)  # NCHW view of the NHWC tensor (channels_last)
            k1 = cuda_time_ms(lambda: fa.fused_channel_attention(x, ap, 8), n)
            p1 = cuda_time_ms(lambda: fa.fused_channel_attention_plain(x, ap, 8), n)
            m1 = cuda_time_ms(lambda: amod(x4), n)
            ba, ya = bound(**attention_counts(*shape))
            log(f"time A1 {shape}: {k1:.3f} ms (twin {p1:.3f}, ChannelAttention module bf16 "
                f"{m1:.3f}, bound {ba:.4f} by {ya})")
            tp, stg = tail_params(c), tails[c]
            t = fb.fused_transformer_block(x, params, 8)
            t4 = t.permute(0, 3, 1, 2)
            k2 = cuda_time_ms(lambda: fs.fused_stage_tail(x, t, tp), n)
            p2 = cuda_time_ms(lambda: fs.fused_stage_tail_plain(x, t, tp), n)
            m2 = cuda_time_ms(lambda: fs.module_tail(stg, x4, t4), n)
            bt, yt = bound(**tail_counts(*shape))
            log(f"plan T1 {shape}: {tail_plan_line(fs, shape)}")
            log(f"time T1 {shape}: {k2:.3f} ms (twin {p2:.3f}, module tail bf16 {m2:.3f}, bound "
                f"{bt:.4f} by {yt})")
            times.setdefault("fused_block_apply_pipelined", (kp, pb))
            times.setdefault("fused_attention", (k1, p1))
            times.setdefault("fused_stage_tail", (k2, p2))
            del x, g0, t, t4, x4
        md = u16_to_device(requests[0][0])
        rd = torch.from_numpy(requests[0][1]).to(dev)
        fwd = cuda_time_ms(lambda: pred._u16_forward(md, rd), 20, warmup=5)
        with twin_blocks():
            fwd_twin = cuda_time_ms(lambda: pred._u16_forward(md, rd), 5)
        pfwd = cuda_time_ms(lambda: ppred._u16_forward(md, rd), 20, warmup=5)
        mp = 8 * 512 * 512 / 1e6
        log(f"time RawFormer-S u16 forward, batch 8 @ 512^2: {fwd:.3f} ms, {mp / fwd * 1e3:.1f} MP/s "
            f"(twin blocks: {fwd_twin:.3f} ms; pipelined apply pass: {pfwd:.3f} ms)")
        xf = torch.from_numpy(frames[0]).to(dev)[None, None]
        full = cuda_time_ms(lambda: model(xf), 3, warmup=1)
        pfull = cuda_time_ms(lambda: pmodel(xf), 3, warmup=1)
        log(f"time RawFormer-S full-res frame 2832x4240: {full:.3f} ms, "
            f"{2832 * 4240 / 1e6 / full * 1e3:.1f} MP/s (pipelined apply pass: {pfull:.3f} ms)")
        log(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    with torch.no_grad():  # not inference mode: the twins differentiate with autograd
        for shape in BATCH_SHAPES:
            x, dy, wts = bwd_inputs[shape]
            g0, qs0, ks0 = fb.gram_pass_plain(x, wts)
            apply = fb.finalize_attention(g0, qs0, ks0, wts.temperature, wts.wproj, 8)
            dx2, d_apply, _ = fbb.bwd1(x, dy, apply, wts)
            d = fbb.finalize_backward(g0, qs0, ks0, wts.temperature, wts.wproj, d_apply, 8)
            k1 = cuda_time_ms(lambda: fbb.bwd1(x, dy, apply, wts), 10)
            p1 = cuda_time_ms(lambda: fbb.bwd1_plain(x, dy, apply, wts), 5)
            k2 = cuda_time_ms(lambda: fbb.bwd2(x, dx2, apply, *d[:3], wts), 10)
            p2 = cuda_time_ms(lambda: fbb.bwd2_plain(x, dx2, apply, *d[:3], wts), 5)
            (bb1, yb1), (bb2, yb2) = (bound(**block_counts(kind, *shape))
                                      for kind in ("bwd1", "bwd2"))
            log(f"time backward {shape}: B1 {k1:.3f} ms (twin {p1:.3f}, bound {bb1:.4f} by {yb1}), "
                f"B2 {k2:.3f} ms (twin {p2:.3f}, bound {bb2:.4f} by {yb2})")
            times.setdefault("fused_block_bwd1", (k1, p1))
            times.setdefault("fused_block_bwd2", (k2, p2))
            bwd_ms[shape] = k1 + k2
            # The same weights at the batch-16 block shape (kernels only).
            s16 = (16,) + shape[1:]
            x16 = torch.randn(s16, device=dev).to(torch.bfloat16)
            dy16 = (0.05 * torch.randn(s16, device=dev)).to(torch.bfloat16)
            g16, q16, kk16 = fb.gram_pass_plain(x16, wts)
            a16 = fb.finalize_attention(g16, q16, kk16, wts.temperature, wts.wproj, 8)
            dx2_16, da16, _ = fbb.bwd1(x16, dy16, a16, wts)
            d16 = fbb.finalize_backward(g16, q16, kk16, wts.temperature, wts.wproj, da16, 8)
            k16 = (cuda_time_ms(lambda: fbb.bwd1(x16, dy16, a16, wts), 10)
                   + cuda_time_ms(lambda: fbb.bwd2(x16, dx2_16, a16, *d16[:3], wts), 10))
            bwd_ms[s16] = k16
            log(f"time backward {s16}: B1 + B2 {k16:.3f} ms")
            del x16, dy16, dx2_16, d16
        del bwd_inputs
        # The weight-grad pass at the split shapes: B1's three products (one
        # launch), B2's one; beside its twin and, for B2's single product, one
        # PyTorch call of the same function (a bf16 matmul, fp32 sums).
        for shape, (p1_, p2_) in wg_inputs.items():
            w1 = cuda_time_ms(lambda: wgk.weight_grad(p1_), 20)
            w2 = cuda_time_ms(lambda: wgk.weight_grad(p2_), 20)
            pw2 = cuda_time_ms(lambda: wgk.weight_grad_plain(p2_), 5)
            (a2, b2_), = p2_
            lw2 = cuda_time_ms(lambda: torch.matmul(a2.mT, b2_), 20)
            bw, ybw = bound(**weight_grad_counts([(t[0].shape[0], t[0].shape[1], t[0].shape[2],
                                                   t[1].shape[2]) for t in p2_]))
            log(f"time weight-grad pass {shape}: B1's products {w1:.4f} ms, B2's {w2:.4f} ms (twin "
                f"{pw2:.3f}, torch.matmul bf16 {lw2:.4f}, bound {bw:.4f} by {ybw}); plans "
                + "; ".join(weight_grad_plan_line(wgk, ps) for ps in (p1_, p2_)))
            if "weight_grad" not in times:
                times["weight_grad"] = (w2, pw2)
                bounds["weight_grad"] = (bw, ybw)
                library["weight_grad"] = lw2
        del wg_inputs

    for bs in (8, 16):
        batch = tuple(torch.cat([a, b]) for a, b in zip(*device_batches(2))) if bs == 16 \
            else device_batches(1)[0]
        for path in ("kernel", "pipelined", "twin") if bs == 8 else ("kernel", "twin"):
            ctx = twin_blocks() if path == "twin" else contextlib.nullcontext()
            with ctx:
                tm = rawformer_s()
                if path == "pipelined":
                    common.set_apply_kernel(tm, "pipelined")
                tr = Trainer(tm, train_cfg)
                tr.train_step(batch)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                ms = cuda_time_ms(lambda: tr.train_step(batch), 5, warmup=2)
                peak = torch.cuda.max_memory_allocated() / 2**30
            # B1 + B2 at the step's 7 block shapes (levels 1, 2, 3, 4, 3, 2, 1).
            bwd = sum(n * bwd_ms[(bs,) + s[1:]] for n, s in zip((2, 2, 2, 1), BATCH_SHAPES))
            share = f", B1 + B2 {bwd:.3f} ms a step ({bwd / ms:.1%})" if path != "twin" else ""
            log(f"time train step RawFormer-S batch {bs} @ 512^2, {path} path: {ms:.3f} ms "
                f"({bs * 512 * 512 / 1e6 / ms * 1e3:.1f} MP/s), peak device memory {peak:.2f} GiB"
                + share)
            del tr, tm
            torch.cuda.empty_cache()

    # 6. RawFormer-WFB ----------------------------------------------------------
    # 6a. S1 / S2 against their twins at the WFB-48 batch-2 @ 512^2 scan shapes.
    def scan_inputs(b, L, d, seed):
        """bf16 u, dt, B, C, dy and fp32 A, D as a random Mamba block makes
        them: dt softplus of N(-2.5, 1), A near -(1..32)."""
        g = torch.Generator(device=dev).manual_seed(seed)
        r = lambda *shape: torch.randn(*shape, generator=g, device=dev)  # noqa: E731
        u, B, C, dy = r(b, L, d), r(b, L, 32), r(b, L, 32), 0.1 * r(b, L, d)
        dt = torch.nn.functional.softplus(r(b, L, d) - 2.5)
        A = -torch.arange(1, 33, device=dev, dtype=torch.float32).repeat(d, 1) * torch.exp(
            0.1 * r(d, 32))
        D = 1.0 + 0.1 * r(d)
        u, dt, B, C, dy = (t.to(torch.bfloat16) for t in (u, dt, B, C, dy))
        return (u, dt, A, B, C, D), dy

    def max_rel(got, ref):
        return ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item()

    def check_s1(args, name):
        """S1 without and with states against the twins on the same inputs
        (y in fp32, the states on the bf16 inputs); prints S1's plan, adds
        y's max abs err to errs[name] and returns the states."""
        b, L, d = args[0].shape
        plan = ssk.fwd_plan(b, L, d, ssk.fwd_resident(dev.index or 0, True))
        y = ssk.selective_scan_fwd(*args)
        y_s, states = ssk.selective_scan_fwd(*args, save_states=True)
        y_ref, st_ref = ssm.selective_scan(*args, chunk_size=ssk.TWIN_CHUNK,
                                           state_every=ssk.STATE_EVERY)
        y_ref = ssm.selective_scan(*(t.float() for t in args), chunk_size=ssk.TWIN_CHUNK)
        err = (y.float() - y_ref).abs()
        scale = y_ref.abs().max().item()
        bad = (err > SCAN_RTOL * y_ref.abs() + SCAN_ATOL_REL * scale).sum().item()
        e_st = max_rel(states, st_ref)
        log(f"S1 scan [{b},{L},{d},32] bf16: y max abs err {err.max().item():.3e} (max|y| "
            f"{scale:.3e}), {bad} elements outside {SCAN_RTOL}|ref| + {SCAN_ATOL_REL} "
            f"max|ref|; with states: y identical {torch.equal(y, y_s)}, states err {e_st:.3e} of "
            f"their max (tol {STATE_TOL}); plan {plan.chunks} chunks of {plan.chunk} steps, "
            f"{plan.launches} kernel launches a call")
        check(bad == 0 and torch.equal(y, y_s) and e_st <= STATE_TOL,
              f"S1 disagrees with its twin at {(b, L, d)}")
        errs[name] = max(errs[name], err.max().item())
        return states

    errs.update({"ssm_scan_fwd": 0.0, "ssm_scan_fwd_states": 0.0, "ssm_scan_bwd": 0.0})
    scan_args = {}
    with torch.no_grad():
        for b, L, d in SCAN_SHAPES:
            args, dy = scan_inputs(b, L, d, seed=L)
            scan_args[(b, L, d)] = (args, dy)
            states = check_s1(args, "ssm_scan_fwd")
            got = ssk.selective_scan_bwd(*args, dy, states)
            want = ssm.selective_scan_bwd_ref(*args, dy)
            rel = {n: max_rel(g_, w_) for n, g_, w_ in
                   zip(("du", "ddt", "dA", "dB", "dC", "dD"), got, want)}
            e_du = (got[0] - want[0]).abs().max().item()
            log(f"S2 scan backward [{b},{L},{d},32]: per leaf error of its max "
                + ", ".join(f"{n} {e:.2e}" for n, e in rel.items())
                + f" (tol {SCAN_BWD_TOL}); du max abs err {e_du:.3e}")
            check(max(rel.values()) <= SCAN_BWD_TOL, f"S2 disagrees with its twin at {(b, L, d)}")
            errs["ssm_scan_bwd"] = max(errs["ssm_scan_bwd"], e_du)
            del states, got, want
        torch.cuda.synchronize()

    # 6b. serving: WFB-48 through Predictor.__call__ (pad_to 32).
    def rawformer_wfb():
        return get_model("rawformer_wfb", device=dev, generator=torch.Generator().manual_seed(0),
                         dtype=torch.bfloat16)

    wfb = rawformer_wfb()
    wpred = Predictor(wfb, device=dev, pad_to=32)
    wreqs = []
    for _ in range(3):
        raw = mosaics(rng, (2, 512, 512, 1)).astype(np.float32)
        wreqs.append(np.clip((raw - 512.0) / (16383.0 - 512.0), 0.0, None)
                     * rng.uniform(50.0, 300.0, (2, 1, 1, 1)).astype(np.float32))
    torch.cuda.synchronize()
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    wouts = [wpred(x) for x in wreqs] + [wpred(frames[0])]
    wserve_s = time.perf_counter() - t0
    wfb_launches = {fn.__name__: fn.launches for fn in counters}
    log(f"RawFormer-WFB-48 served 3 x 2 x 512^2 float requests + one 2832x4240 frame in "
        f"{wserve_s:.2f} s; launches {wfb_launches}")
    check(wfb_launches["selective_scan_fwd"] == 7 * len(wouts),
          "S1 did not run 7 times per forward")
    check(sum(wfb_launches.values()) == wfb_launches["selective_scan_fwd"],
          "another kernel ran while serving RawFormer-WFB")
    for y, shape in zip(wouts, [x.shape[:3] for x in wreqs] + [frames[0].shape]):
        check(y.shape == shape + (3,) and bool(np.isfinite(y).all()),
              f"WFB output not finite of shape {shape + (3,)}")
    common.set_fused_blocks(wfb, False)
    wtwin = wpred(wreqs[0])
    common.set_fused_blocks(wfb, True)
    d = np.abs(wouts[0] - wtwin)
    log(f"WFB kernel path vs twin path, 2 x 512^2: max abs err {d.max():.3e} (tol {E2E_MAX_TOL}), "
        f"mean {d.mean():.3e} (tol {E2E_MEAN_TOL})")
    check(d.max() <= E2E_MAX_TOL and d.mean() <= E2E_MEAN_TOL,
          "WFB kernel path disagrees with the twin path")

    # 6c. training: Trainer on synthetic crops, kernel path vs twin path.
    small_ds = SyntheticBayerDataset(num_images=2, full_size=(320, 320), patch_size=256,
                                     training=True)
    small = list(prefetch_to_device(((i, g) for i, g, _ in Loader(small_ds, 2, seed=0)), dev))[0]
    kern = Trainer(rawformer_wfb(), train_cfg)
    twin = Trainer(rawformer_wfb(), dataclasses.replace(train_cfg, fused_blocks=False))
    runs = []
    for tr in (kern, twin):
        torch.cuda.synchronize()
        for fn in counters:
            fn.launches = 0
        losses = [float(tr.train_step(small))]
        grads = {n: p.grad.float().clone() for n, p in tr.model.named_parameters()
                 if p.grad is not None}
        losses.append(float(tr.train_step(small)))
        torch.cuda.synchronize()
        runs.append((losses, grads, {fn.__name__: fn.launches for fn in counters}))
    (kern_losses, kern_grads, wfb_train_launches), (twin_losses, twin_grads, twin_launches) = runs
    log(f"WFB train steps at batch 2 @ 256^2: launches kernel path {wfb_train_launches}, "
        f"twin path {twin_launches}")
    check(wfb_train_launches["selective_scan_fwd"] == wfb_train_launches["selective_scan_bwd"]
          == 7 * 2, "S1 with states and S2 did not run 7 times per train step")
    check(sum(twin_launches.values()) == 0, "a kernel ran on the twin path")
    nudged = Trainer(rawformer_wfb(), dataclasses.replace(train_cfg, fused_blocks=False))
    nudged.train_step((small[0] * (1.0 + 2.0 ** -9), small[1]))
    yard = {n: ((p.grad.float() - twin_grads[n]).abs().max()
                / (twin_grads[n].abs().max() + 1e-12)).item()
            for n, p in nudged.model.named_parameters() if p.grad is not None}
    del nudged
    grad_err = {n: ((kern_grads[n] - g).abs().max() / (g.abs().max() + 1e-12)).item()
                for n, g in twin_grads.items()}
    held = [n for n in grad_err if "frequency_process" not in n]
    worst = max(held, key=lambda n: grad_err[n] / max(3 * yard[n], WFB_GRAD_FLOOR))
    bad = [n for n in held if grad_err[n] > max(3 * yard[n], WFB_GRAD_FLOOR)]
    feb_worst = max((n for n in grad_err if n not in held), key=grad_err.get)
    log("WFB nudged twin vs twin, first-step grads: largest change of a FEB leaf "
        f"{max(yard[n] for n in yard if n not in held):.3e}, of another leaf "
        f"{max(yard[n] for n in held):.3e} (of the twin's leaf max)")
    median = float(np.median(list(grad_err.values())))
    sk, st = kern.model.state_dict(), twin.model.state_dict()
    dp = max((sk[n].float() - st[n].float()).abs().max().item() for n, _ in
             kern.model.named_parameters())
    dbn = max(((sk[n] - st[n]).abs().max() / st[n].abs().max()).item() for n in sk
              if "running" in n)
    dl = abs(kern_losses[0] - twin_losses[0]) / abs(twin_losses[0])
    log(f"WFB train step kernel path vs twin path: losses {kern_losses} vs {twin_losses} (first "
        f"rel err {dl:.3e}, tol {TRAIN_LOSS_RTOL}); first-step grads of the twin's leaf max, "
        f"outside the FEB islands worst against its yardstick {worst} {grad_err[worst]:.3e} "
        f"(nudged twin {yard[worst]:.3e}, floor {WFB_GRAD_FLOOR}); FEB worst {feb_worst} "
        f"{grad_err[feb_worst]:.3e} (nudged twin {yard[feb_worst]:.3e}, not held); median "
        f"{median:.3e} (tol {WFB_GRAD_MEDIAN_TOL}), nudged "
        f"twin median {float(np.median(list(yard.values()))):.3e}; params after 2 Adam steps "
        f"max abs diff {dp:.3e} (tol {TRAIN_PARAM_ATOL}, Adam's ceiling ~2 lr, not a grad "
        f"test); BN running stats {dbn:.3e} of their max (tol {WFB_BN_TOL})")
    check(dl <= TRAIN_LOSS_RTOL, "WFB train loss disagrees with the twin path")
    check(not bad and median <= WFB_GRAD_MEDIAN_TOL,
          f"WFB grads disagree with the twin path: {bad}")
    check(dp <= TRAIN_PARAM_ATOL, "WFB params after Adam steps exceed Adam's step-size ceiling")
    check(dbn <= WFB_BN_TOL, "WFB BatchNorm running stats disagree with the twin path")
    wfb_fp32_first_step(dev, train_cfg, small, counters)
    twin_ms = cuda_time_ms(lambda: twin.train_step(small), 3, warmup=1)
    del twin
    small_ms = cuda_time_ms(lambda: kern.train_step(small), 3, warmup=1)  # steps 3-6
    for _ in range(20 - 6):
        kern_losses.append(float(kern.train_step(small)))
    log(f"WFB 20 steps on one batch: loss {kern_losses[0]:.5f} -> {kern_losses[-1]:.5f}")
    check(kern_losses[-1] < kern_losses[0], "20 WFB steps on one batch did not lower its loss")
    log(f"time WFB-48 train step batch 2 @ 256^2: kernel path {small_ms:.3f} ms, twin path "
        f"{twin_ms:.3f} ms")
    del kern
    torch.cuda.empty_cache()

    # 6d. timing: S1 / S2 vs twins with their bounds, the WFB forward and step.
    with torch.no_grad():
        for (b, L, d), (args, dy) in scan_args.items():
            _, states = ssk.selective_scan_fwd(*args, save_states=True)
            n_it = 20 if L >= 4096 else 50
            k = cuda_time_ms(lambda: ssk.selective_scan_fwd(*args), n_it)
            kst = cuda_time_ms(lambda: ssk.selective_scan_fwd(*args, save_states=True), n_it)
            p = cuda_time_ms(lambda: ssm.selective_scan(*args, chunk_size=ssk.TWIN_CHUNK), 3, 1)
            kb = cuda_time_ms(lambda: ssk.selective_scan_bwd(*args, dy, states), n_it)
            pb = cuda_time_ms(lambda: ssm.selective_scan_bwd_ref(*args, dy), 2, 1)
            bf, byf = bound(**scan_counts(b, L, d, 32, 2, backward=False))
            bb, byb = bound(**scan_counts(b, L, d, 32, 2, backward=True))
            log(f"time scan [{b},{L},{d},32] bf16: S1 {k:.4f} ms (with states {kst:.4f}; twin "
                f"{p:.3f}; bound {bf:.4f} by {byf}), S2 {kb:.4f} ms (twin {pb:.3f}; bound "
                f"{bb:.4f} by {byb})")
            times.setdefault("ssm_scan_fwd", (k, p))
            times.setdefault("ssm_scan_bwd", (kb, pb))
            bounds.setdefault("ssm_scan_fwd", (bf, byf))
            bounds.setdefault("ssm_scan_bwd", (bb, byb))
            del states
    del scan_args
    with torch.no_grad():  # S1 and S2 at the batch-8 @ 512^2 train step's scan shapes
        lib = _build.library()
        for b, L, d in SCAN_TRAIN_SHAPES:
            args, dy = scan_inputs(b, L, d, seed=L + 1)
            states = check_s1(args, "ssm_scan_fwd_states")
            kst = cuda_time_ms(lambda: ssk.selective_scan_fwd(*args, save_states=True), 10)
            pst = cuda_time_ms(lambda: ssm.selective_scan(*args, chunk_size=ssk.TWIN_CHUNK,
                                                          state_every=ssk.STATE_EVERY), 2, 1)
            bst, byst = bound(**scan_counts(b, L, d, 32, 2, backward=False, states=True))
            log(f"time scan forward S1 with states [{b},{L},{d},32] bf16 (train step shape): "
                f"{kst:.4f} ms (twin {pst:.3f}; bound {bst:.4f} by {byst})")
            times.setdefault("ssm_scan_fwd_states", (kst, pst))
            bounds.setdefault("ssm_scan_fwd_states", (bst, byst))
            plan = ssk.bwd_plan(b, L, d, ssk.bwd_resident(dev.index or 0, True))
            per_sm = lib.blle_ssm_bwd_blocks_per_sm(plan.dgroup, 1)
            got = ssk.selective_scan_bwd(*args, dy, states)
            want = ssm.selective_scan_bwd_ref(*args, dy)
            rel = {n: max_rel(g_, w_) for n, g_, w_ in
                   zip(("du", "ddt", "dA", "dB", "dC", "dD"), got, want)}
            del got, want
            check(max(rel.values()) <= SCAN_BWD_TOL, f"S2 disagrees with its twin at {(b, L, d)}")
            kb = cuda_time_ms(lambda: ssk.selective_scan_bwd(*args, dy, states), 10)
            bb, byb = bound(**scan_counts(b, L, d, 32, 2, backward=True))
            log(f"time scan backward S2 [{b},{L},{d},32] bf16 (train step shape): {kb:.4f} ms "
                f"(bound {bb:.4f} by {byb}); per leaf error of its max "
                + ", ".join(f"{n} {e:.2e}" for n, e in rel.items())
                + f" (tol {SCAN_BWD_TOL}); plan {plan.dgroup} channels a block, {plan.per_warp} a "
                f"warp, {plan.groups} groups, {plan.blocks} blocks; {per_sm} blocks = "
                f"{per_sm * ssk.BWD_WARPS} warps resident per SM")
            del args, dy, states
        log(f"S1 resident: {lib.blle_ssm_fwd_blocks_per_sm(1)} blocks "
            f"of {ssk.FWD_WARPS} warps per SM")
    xw = torch.from_numpy(wreqs[0]).to(dev).permute(0, 3, 1, 2).contiguous()
    with torch.inference_mode():
        fwd = cuda_time_ms(lambda: wfb(xw), 10, warmup=3)
        common.set_fused_blocks(wfb, False)
        fwd_twin = cuda_time_ms(lambda: wfb(xw), 3, warmup=1)
        common.set_fused_blocks(wfb, True)
        xf = torch.nn.functional.pad(torch.from_numpy(frames[0]).to(dev)[None, None],
                                     (0, 16, 0, 16))
        torch.cuda.reset_peak_memory_stats()
        full = cuda_time_ms(lambda: wfb(xf), 3, warmup=1)
        full_peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"time RawFormer-WFB-48 forward, batch 2 @ 512^2: {fwd:.3f} ms, "
        f"{2 * 512 * 512 / 1e6 / fwd * 1e3:.1f} MP/s (twin scan: {fwd_twin:.3f} ms); one "
        f"2832x4240 frame (padded to 2848x4256): {full:.3f} ms, peak {full_peak:.2f} GiB")
    del wfb, wpred
    torch.cuda.empty_cache()
    for bs in (8, 4, 2):
        try:
            batch = device_batches(1)[0]
            batch = tuple(t[:bs] for t in batch)
            tr = Trainer(rawformer_wfb(), train_cfg)
            tr.train_step(batch)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ms = cuda_time_ms(lambda: tr.train_step(batch), 3, warmup=1)
            peak = torch.cuda.max_memory_allocated() / 2**30
        except torch.cuda.OutOfMemoryError:
            log(f"WFB-48 train step at batch {bs} @ 512^2: out of device memory")
            tr = batch = None
            torch.cuda.empty_cache()
            continue
        log(f"time train step RawFormer-WFB-48 batch {bs} @ 512^2, kernel path: {ms:.3f} ms "
            f"({bs * 512 * 512 / 1e6 / ms * 1e3:.1f} MP/s), peak device memory {peak:.2f} GiB")
        break
    del tr
    torch.cuda.empty_cache()

    # 8. the probe ladders ------------------------------------------------------
    del pmodel, ppred
    torch.cuda.empty_cache()
    for fn in (probes.floor_probe, probes.bisect_probe, fb.apply_pass, fb.apply_pass_pipelined):
        fn.launches = 0
    probes.floor_probe.launches_by_strategy = dict.fromkeys(probes.STRATEGIES, 0)
    t0 = time.perf_counter()
    floor_rows = probes.run_floor_ladder(BATCH_SHAPES[0], iters=10)
    for r in floor_rows:
        err = "-" if r["err"] is None else f"{r['err']:.2e}"
        bf_, byf_ = bound(**floor_counts(r["level"], *BATCH_SHAPES[0]))
        log(f"probe floor {list(BATCH_SHAPES[0])} {r['strategy']:6s} {r['level']} th={r['th']:2d}: "
            f"{r['ms']:.4f} ms, {r['gbs']:.1f} GB/s, err {err} (bound {bf_:.4f} by {byf_})")
        if r["err"] is not None:
            check(r["err"] <= (0.0 if r["level"] == "c" else PROBE_TOL),
                  f"floor probe {r['strategy']}/{r['level']} th={r['th']} disagrees with its twin")
    bisect_rows = probes.run_bisect_ladder(BATCH_SHAPES, iters=10)
    for r in bisect_rows:
        bs_, bys_ = bound(**stage_counts(r["stage"], *r["shape"]))
        log(f"probe bisect {list(r['shape'])} {r['apply_kernel']:9s} stage {r['stage']}: "
            f"{r['ms']:.4f} ms, {r['gbs']:.1f} GB/s, err {r['err']:.2e} (bound {bs_:.4f} by "
            f"{bys_})")
        check(r["err"] <= PROBE_TOL, f"bisect probe {r} disagrees with its twin")
    copy_ms = probes.copy_ms(BATCH_SHAPES[0], iters=10)
    log(f"probe floor {list(BATCH_SHAPES[0])} copy_  c: {copy_ms:.4f} ms, "
        f"{4 * np.prod(BATCH_SHAPES[0]) / (copy_ms * 1e-3) / 1e9:.1f} GB/s (Tensor.copy_, the "
        f"library call of level c)")
    floor_tma = probes.floor_probe.launches_by_strategy["tma"]
    probe_launches = {"probe_floor": probes.floor_probe.launches - floor_tma,
                      "probe_floor_tma": floor_tma, "probe_bisect": probes.bisect_probe.launches}
    log(f"probe ladders in {time.perf_counter() - t0:.1f} s; launches {probe_launches} (stage 5 "
        f"rungs: K3 {fb.apply_pass.launches}, K3P {fb.apply_pass_pipelined.launches})")
    with torch.no_grad():  # the twins' times for the table's rows
        g = torch.Generator().manual_seed(0)
        x = torch.randn(BATCH_SHAPES[0], generator=g).to(dev, torch.bfloat16)
        w = (torch.randn(32, 32, generator=g) / 32 ** 0.5).to(dev, torch.bfloat16)
        dw = (torch.randn(9, 32, generator=g) / 3.0).to(dev)
        floor_twin = cuda_time_ms(lambda: probes.floor_probe_plain(x, w, dw, "c"), 10)
        wts = probes.block_weights(32, 32, dev)
        apply = fb.finalize_attention(*fb.gram_pass_plain(x, wts), wts.temperature, wts.wproj, 8)
        bisect_twin = cuda_time_ms(lambda: probes.bisect_probe_plain(x, apply, wts, 1), 10)
        del x, apply
    # probe_floor: the plain/c/th=8 rung, as before the tma rung came;
    # probe_floor_tma: the tma/c/th=8 rung. Each row's error is its own
    # strategy's largest over the ladder.
    for name, strategy in (("probe_floor", "plain"), ("probe_floor_tma", "tma")):
        floor_row = next(r for r in floor_rows
                         if (r["strategy"], r["level"], r["th"]) == (strategy, "c", 8))
        times[name] = (floor_row["ms"], floor_twin)
        errs[name] = max(r["err"] for r in floor_rows
                         if r["err"] is not None and (r["strategy"] == "tma") == (strategy == "tma"))
        bounds[name] = bound(**floor_counts("c", *BATCH_SHAPES[0]))
        library[name] = copy_ms
    bisect_row = next(r for r in bisect_rows if r["shape"] == BATCH_SHAPES[0]
                      and (r["apply_kernel"], r["stage"]) == ("tiled", 1))
    times["probe_bisect"] = (bisect_row["ms"], bisect_twin)
    errs["probe_bisect"] = max(r["err"] for r in bisect_rows)
    bounds["probe_bisect"] = bound(**stage_counts(1, *BATCH_SHAPES[0]))

    # 9. the real-data path ---------------------------------------------------
    torch.cuda.empty_cache()
    real_data_phase(dev, card, counters)

    # 10. the FLCA / TrueColor family -------------------------------------------
    torch.cuda.empty_cache()
    zoo_launches = zoo_phase(dev, card, counters)
    log("phase 10 launches per forward (FLCA / TrueColor family at dim 48, 2 x 512^2): "
        + json.dumps(zoo_launches))

    # 11. the FLCA / TrueColor family trains -------------------------------------
    torch.cuda.empty_cache()
    zoo_train_launches = zoo_train_phase(dev, card, counters, train_cfg)
    log("phase 11 launches per train step (FLCA / TrueColor family at dim 48, 2 x 256^2): "
        + json.dumps(zoo_train_launches))

    # 12. luma-MHSA and WavKAN ----------------------------------------------------
    torch.cuda.empty_cache()
    plain_zoo_phase(dev, card, counters, train_cfg)

    # 13. the raw-domain models ---------------------------------------------------
    torch.cuda.empty_cache()
    raw_zoo_phase(dev, card, counters, train_cfg)

    # 14. serving artifacts -------------------------------------------------------
    torch.cuda.empty_cache()
    export_launches = export_phase(dev, card)
    log("phase 14 launches per artifact forward in a fresh process: "
        + json.dumps(export_launches))

    # 15. multi-GPU training ------------------------------------------------------
    torch.cuda.empty_cache()
    dist_phase(dev, card, counters, train_cfg)

    # 16. tiled full-resolution inference -------------------------------------------
    torch.cuda.empty_cache()
    tiled_phase(dev, card, counters)

    # 17. tiled inference of the rest of the zoo --------------------------------------
    torch.cuda.empty_cache()
    zoo_tiled_phase(dev, card, counters)

    # 18. band mode: the single-card full-frame forward --------------------------------
    torch.cuda.empty_cache()
    band = banded_phase(dev, card, counters)
    for table, part in ((errs, "errs"), (times, "times"), (bounds, "bounds"),
                        (library, "library")):
        table.update(band[part])

    # 19. RawFormer-B and -L at crop size ------------------------------------------------
    torch.cuda.empty_cache()
    sizes = sizes_phase(dev, card, counters, train_cfg)
    for table, part in ((errs, "errs"), (times, "times"), (bounds, "bounds"),
                        (library, "library")):
        table.update(sizes[part])

    for name, kind in (("fused_block_gram", "gram"), ("fused_block_apply", "apply"),
                       ("fused_block_bwd1", "bwd1"), ("fused_block_bwd2", "bwd2"),
                       ("fused_block_apply_pipelined", "apply")):
        bounds[name] = bound(**block_counts(kind, *BATCH_SHAPES[0]))
    bounds["fused_attention"] = bound(**attention_counts(*BATCH_SHAPES[0]))
    bounds["fused_stage_tail"] = bound(**tail_counts(*BATCH_SHAPES[0]))
    b, h, w = PACK_SHAPES[0]
    bounds["bayer_pack"] = bound(nbytes=b * h * w * 4 + 4 * b, fp32=4.0 * b * h * w)

    rows = [
        ("bayer_pack", PKG + "csrc/bayer_pack.cu", TPU + "bayer_pack.py:34",
         launches["bayer_pack_normalize"]),
        ("weight_grad", PKG + "csrc/weight_grad.cu",
         TPU + "fused_block_bwd.py:194, " + TPU + "fused_block_bwd.py:318",
         train_launches["weight_grad"]),
        ("fused_block_gram", PKG + "csrc/block_tiles.cuh", TPU + "fused_block.py:406",
         launches["gram_pass"]),
        ("fused_block_apply", PKG + "csrc/block_tiles.cuh", TPU + "fused_block.py:683",
         launches["apply_pass"]),
        ("fused_block_bwd1", PKG + "csrc/fused_block_bwd.cu", TPU + "fused_block_bwd.py:194",
         train_launches["bwd1"]),
        ("fused_block_bwd2", PKG + "csrc/fused_block_bwd.cu", TPU + "fused_block_bwd.py:318",
         train_launches["bwd2"]),
        ("ssm_scan_fwd", PKG + "csrc/ssm_scan.cu", TPU + "ssm_scan.py:92",
         wfb_launches["selective_scan_fwd"]),
        ("ssm_scan_fwd_states", PKG + "csrc/ssm_scan.cu", TPU + "ssm_scan.py:272",
         wfb_train_launches["selective_scan_fwd"]),
        ("ssm_scan_bwd", PKG + "csrc/ssm_scan.cu", TPU + "ssm_scan.py:299",
         wfb_train_launches["selective_scan_bwd"]),
        ("fused_block_apply_pipelined", PKG + "csrc/apply_pipelined.cuh", TPU + "fused_block.py:494",
         pipe_launches["apply_pass_pipelined"]),
        ("fused_attention", PKG + "csrc/fused_attention.cu (attn_finalize_kernel), " + PKG
         + "csrc/block_tiles.cuh (gram_kernel, gram_reduce_kernel, apply1_kernel)",
         "attic/fused_attention.py:67", aux_launches["fused_attention"]),
        ("fused_stage_tail", PKG + "csrc/fused_stage.cu", "attic/fused_stage.py:75",
         aux_launches["fused_stage_tail"]),
        ("probe_floor", PKG + "csrc/probes_floor.cu",
         "benchmarks/probe_floor.py:60, benchmarks/exp_dma_floor.py:113, "
         "benchmarks/exp_dma_floor.py:125, benchmarks/exp_dma_floor.py:147, "
         "benchmarks/exp_dma_bw.py:83",
         probe_launches["probe_floor"]),
        ("probe_floor_tma", PKG + "csrc/probes_floor.cu (floor_tma_kernel)",
         "benchmarks/exp_dma_floor.py:147", probe_launches["probe_floor_tma"]),
        ("probe_bisect", PKG + "csrc/probes_bisect.cu", "benchmarks/bisect_b5.py:106",
         probe_launches["probe_bisect"]),
        ("fused_block_gram_banded", PKG + "csrc/fused_block_banded.cu (+ block_tiles.cuh)",
         TPU + "fused_block.py:406", band["launches"]["gram_pass_banded"]),
        ("fused_block_apply_banded", PKG + "csrc/fused_block_banded.cu (+ block_tiles.cuh)",
         TPU + "fused_block.py:683", band["launches"]["apply_pass_banded"]),
        ("fused_block_gram_banded_wide", PKG + "kernels/wide_block.py (gram_pass_wide: "
         "csrc/wide_block.cu, csrc/weight_grad.cu)", TPU + "fused_block.py:406",
         band["wide_launches"]["gram_pass_banded_wide"]),
        ("fused_block_apply_banded_wide", PKG + "kernels/wide_block.py (apply_pass_wide: "
         "csrc/wide_block.cu)", TPU + "fused_block.py:683, " + TPU + "fused_block.py:609",
         band["wide_launches"]["apply_pass_banded_wide"]),
        ("wide_layernorm", PKG + "csrc/wide_block.cu (wide_ln_kernel)",
         TPU + "fused_block.py:406, " + TPU + "fused_block.py:683",
         band["wide_launches"]["layernorm_rows"]),
        ("wide_gemm", PKG + "csrc/wide_block.cu (wide_gemm_kernel)",
         TPU + "fused_block.py:406, " + TPU + "fused_block.py:683", band["wide_launches"]["gemm"]),
        ("wide_dw3x3", PKG + "csrc/wide_block.cu (wide_dw_kernel)",
         TPU + "fused_block.py:406, " + TPU + "fused_block.py:683",
         band["wide_launches"]["dw3x3"]),
        ("wide_gram_finish", PKG + "csrc/wide_block.cu (wide_gram_finish_kernel)",
         TPU + "fused_block.py:406", band["wide_launches"]["gram_finish"]),
        *((SIZES_ROWS[kind], PKG + src, TPU + at, sizes["launches"][SIZES_ROWS[kind]])
          for kind, src, at in (("gram", "csrc/block_tiles.cuh", "fused_block.py:406"),
                                ("apply", "csrc/block_tiles.cuh", "fused_block.py:683"),
                                ("bwd1", "csrc/fused_block_bwd.cu", "fused_block_bwd.py:194"),
                                ("bwd2", "csrc/fused_block_bwd.cu", "fused_block_bwd.py:318"))),
    ]
    log("kernel table: times and bounds of bayer_pack at [8,512,512] u16, fused_block_*, "
        "fused_attention, fused_stage_tail and the probes at [8,256,256,32] bf16 (probe_floor: "
        "the plain/c/th=8 rung, launches of its plain/center/async/async4 rungs; "
        "probe_floor_tma: the tma/c/th=8 rung, launches of its tma rungs; probe_bisect: K3 "
        "cut after stage 1), ssm_scan_fwd and "
        "ssm_scan_bwd at [6,16384,96,32] bf16 (ssm_scan_fwd without states), "
        "ssm_scan_fwd_states at [24,16384,96,32] bf16; launches of K1-K3 from RawFormer-S "
        "serving, of K3P from its pipelined serving, of B1/B2 from its training (B1/B2 and "
        "the weight-grad pass also run 6 and 8 times a step in FLCA / TrueColor training, "
        "phase 11), of "
        "ssm_scan_fwd from WFB serving, of ssm_scan_fwd_states and ssm_scan_bwd from WFB "
        "training, of A1, T1 and the "
        "probes from their own experiments (no model calls them); weight_grad at [8,64,64,128] "
        "on B2's product (1, 32768, 128, 384), launches from RawFormer-S training; max_abs_err "
        "of B1/B2 on dx2 / dx, of ssm_scan_fwd(_states) on y, of ssm_scan_bwd on du, of the "
        "probes and "
        "weight_grad relative to the twin's max; library_ms: weight_grad beside torch.matmul "
        "(bf16), probe_floor and probe_floor_tma beside Tensor.copy_ (level c's function); no single PyTorch call "
        "computes any other of these functions (null); fused_block_gram_banded / "
        "fused_block_apply_banded: K2 / K3 in band mode at the frame's first-level bands "
        "[8,184,2176,32] bf16 (the halo'd input [8,188,2176,32]), launches from the banded "
        "RawFormer-S 2944x4352 frame (phase 18), max_abs_err K2's frame cosines / K3's output "
        "over the four band shapes of C <= 256; fused_block_gram_banded_wide / "
        "fused_block_apply_banded_wide: K2 / K3 at C = 384 / 512 (the wide chain) timed at "
        "[8,23,272,512] bf16 (RawFormer-L's bottleneck bands), launches from the banded "
        "RawFormer-B and -L frames (one each a frame), max_abs_err over [8,23,272,384] and "
        "[8,23,272,512]; wide_layernorm / wide_gemm / wide_dw3x3 / wide_gram_finish: the wide "
        "chain's kernels at [8,23,272,512], each row the sum over its launches in one banded "
        "block (3 / 5 / 3 / 1) with its bound from the summed bytes and operations, launches "
        "from the banded RawFormer-B and -L frames, max_abs_err the largest of its launches "
        "against its twin, library_ms the sum of F.layer_norm / bf16 torch.matmul and "
        "torch.bmm / depthwise F.conv2d on the same inputs (wide_gram_finish: null); "
        "fused_block_*_l: K2 / K3 / B1 / B2 at RawFormer-L's first-level block [8,256,256,64] "
        "bf16 (phase 19), launches of K2 / K3 from its 3 batch-8 @ 512^2 u16 requests and of "
        "B1 / B2 from its batch-8 @ 512^2 train step, max_abs_err over L's three block shapes "
        "(K2: cosines, K3: output, B1 / B2: dx2 / dx)")
    log(card)
    log(json.dumps({"kernels": [
        {"name": n, "route": "cuda", "source": s, "replaces": r, "launches": l,
         "max_abs_err": errs[n], "ms": times[n][0], "plain_ms": times[n][1],
         "bound_ms": bounds[n][0], "bound_by": bounds[n][1], "library_ms": library.get(n)}
        for n, s, r, l in rows
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
