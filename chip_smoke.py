#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``fcvsr_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, one line or more each:
  0. the toolchain probe: ``python -m fcvsr_tpu_torch.tools.gpu_probe`` in a
     subprocess (a matrix product on the card, cuDNN's bf16 against float32
     conv, and the probe kernel K12 built alone by nvcc, loaded by ctypes
     and checked), its JSON printed;
  1. device and build: the card's name and power limit (nvidia-smi), torch
     and CUDA versions, the nvcc build of ``fcvsr_tpu_torch/csrc`` (one nvcc
     a source, in parallel); the SASS of the conv pair's, the single
     conv's and the quad's kernels (K2, K3, K6, ``cuobjdump -sass`` of the
     library) must hold wgmma (HGMMA) and no FFMA main loop, the BlockRCB
     level's (K11) wgmma, and that of
     the IAC kernel's
     fused-prediction instantiations (K1 kf) mma.sync (HMMA), their FFMA
     counts printed;
  2. every kernel of the serving and training paths against its plain
     PyTorch version on the card, at the shapes FCVSR and the zoo give it,
     with the max abs error against the stated tolerance, both CUDA-event
     times (median of 7 after 2 warm-ups, the versions timed in turns) and
     the least time the card could take: the IAC iteration (K1, both
     modes, B 1 and 2, also warm: 20 launches an event pair) and the
     conv kernels (K2, K3) at the serving shape, in float32 and bf16
     storage, K3 (64->64 with its residual, also warm) at SCNet's three
     levels and at conv_last0's 1088x1920 (also on bf16 maps, as
     tail_dtype='bf16' runs it), its bound its bytes and the
     function's flops at the bf16 tensor-core rate, the float32 pipes'
     beside, K2 at SCNet's three levels (both pair shapes, each timed,
     its bound, the function's flops at the bf16 tensor-core rate,
     beside the float32 pipes', its route's passes' and, for float32
     maps, 3xTF32's); the resident IAC chain (K4) at 272x480x64, 6
     iterations, B 1 and 2, float32 and bf16, also against 6 K1 launches,
     bit for bit; the BlockRCB quad (K6) at SCNet's three levels, float32
     and bf16, also against 2 K2 launches, bit for bit, its bound K2's
     kind; the IAC adjoint (K5, one launch a call) at the training shape
     and at small odd shapes (C 5; B 3 with flows far out of the frame),
     the deformable conv (K7, on wgmma) at EDVR-M's and
     BasicVSR++'s serving and training shapes, without a mask and at small
     odd shapes, its adjoint (K8, one launch on wgmma) at the same cases
     (each gradient's error over its max), both bound at the bf16 tensor
     cores' rate with the float32 pipes' beside, the BlockRCB
     level (K11, K6's wgmma phases and the ContextBlock) at 272x480x64 with
     C1 64 and 128, at SCNet's levels 2 and 3 with both, and at B 2, beside
     the unfused path (2 K2 launches and the ContextBlock), its y and r
     against a K6 launch on bf16-rounded weights, bit for bit, the probe kernel (K12; also warm, 200 launches an
     event pair beside ``torch.mul``, in turns,
     ``benchmarks/launch_path.py``), and the conv autograd
     Functions' gradients at the three SCNet levels;
  3. model parity, seeded weights, the GPU (kernels) against the same model
     on the CPU (plain versions): FCVSR full, Y, the output at
     (1, 7, 1, 64, 96) (also under each serving flag set: the exact flags,
     ``--fast``, ``--fast`` with the resident chain and the quad) and
     ``loss.backward()``'s gradients at (1, 7, 1, 32,
     48), per parameter tensor; the zoo (EDVR-M, BasicVSR++, BasicVSR,
     IconVSR, TDAN) at full width, with their offset convs seeded
     non-zero, the output at (1, 5, 3, 64, 96) (TDAN's aligned frames
     too) and the DCN launches per forward; and the DCN models' training
     loss gradients (``VideoRestorer.loss_fn``; TDAN's SR centre frame) at
     (1, 5, 3, 64, 64) per parameter tensor, beside the CPU's own floor,
     with the K7 and K8 launches; FTVSR (mid 64, 72 blocks, FTT at
     d_model 144, 8 heads) and TTVSR (60 blocks), the output and every
     frame's loss gradients at (1, 8, 3, 64, 64), no kernel launched, and
     LTAM's tracked locations and keyframe picks (up to 3 keyframes)
     equal on both devices, with their counts;
  3b. the CVCP family (``cvcp_zoo``) at its full widths, seeded weights,
     every CAB2's ``beta`` and batch norm's running statistics drawn
     non-zero: SIDECVSR (nf 64, 4 groups; smooth MVs that reach the STN's
     clamp, both outputs), FCVSR-TFDC (64 features, 3 groups) at 1 x 7 x
     1 x 64 x 96 and RAFT (12 updates, ``raft_flow``) on a 64 x 96 pair,
     the card against the CPU within MODEL_ATOL; then, on the card only,
     FCVSR-TFDC through ``sliding_window_sr`` over a 10-frame 272 x 480 Y
     clip, SIDECVSR a forward a window over it with synthetic side
     information and ``raft_flow`` on a 436 x 1024 pair: ms a frame (a
     pair, CUDA events, the median of 3 after a warm-up), the peak, one
     window's device profile; no kernel of the port launched;
  3c. the single-image zoo (``sisr_zoo``) at the published x4 widths,
     seeded weights: EDSR, SRCNN, MSRResNet, RRDBNet, RDN, TOFlow,
     LIIF-EDSR, LIIF-RDN and TTSR, the card against the CPU within
     MODEL_ATOL (LR 24 x 32; TOFlow 7 x 64 x 96; LIIF at every pixel of
     the x4 grid; TTSR against a 96 x 128 reference, its hard-attention
     picks on both devices counted); then, on the card only, each built
     by ``build(BACKBONES, cfg)`` and served under ``no_grad`` at a real
     size (a 510 x 339 DIV2K LR; a 7 x 256 x 448 Vimeo-90K septuplet for
     TOFlow; 262 144 queries of a 128 x 128 LR for LIIF; 80 x 120 against
     320 x 480 for TTSR): ms a frame (median of 3 after a warm-up), the
     flops counted on the meta device and their rate, the peak; RDN's,
     RRDBNet's and TOFlow's device profiles; no kernel of the port
     launched;
  3d. the rest of the JAX package's library (``library``), which no entry
     point calls: the blocks of ``models/blocks_ext.py`` at 64 features
     (FSAS, FSAS_freq, FFTSpatialModule, MultiFreqAgg at K 3,
     EncoderShiftBlock and Encoder2 over 7 frames, TFRUNet, CABEncoder
     then CABDecoder, ResidualBlocksWithInputConv of 30 blocks), seeded,
     every gate's ``beta`` non-zero, the card against the CPU at 64 x 96
     within MODEL_ATOL, then on the card at 272 x 480: ms (median of 5
     after a warm-up) and the peak, TFRUNet's and EncoderShiftBlock's
     device profiles; a ``SpaFreqBlock(train=True)`` SGD
     step (batch statistics, flax's running-statistics update), its output,
     running statistics and weights against the CPU's, then timed at 2 x
     272 x 480; LPIPS (AlexNet, seeded) on a 2 x 3 x 256 x 256 pair, card
     against CPU, timed; the native PNG decoder built by g++, a 10-frame
     270 x 480 RGB clip decoded byte-equal to PIL, ms a frame beside PIL's;
     NIQE and NRQM on a 270 x 480 Y frame with synthetic model files, host
     seconds; no kernel of the port launched;
  4. serving: ``fcvsr_tpu_torch.cli`` evaluates a synthetic 10-frame 480x270
     clip on preset fcvsr_cvcpLD_QP22 (270 -> 272 pad, output crop, PSNR /
     SSIM; ``--no-tof``), with the kernel launch counts per frame checked,
     then ``--fps`` at 1 x 7 x 1 x 272 x 480;
  4b. fast serving: the same with ``--fast`` (the JAX package's set), then
     with ``--fast --iac-chain resident --scnet-fuse quad``: the clip with
     the launches per frame checked, ``--fps`` with the peak memory, then
     the exact path, each serving flag alone (the bf16 head, MFFR and tail
     and the phase-blocked fold among them), ``--fast`` and ``--fast`` +
     resident + quad timed in turns on one model
     (``profiling.serving_compare``), each held to the --fast bars against
     the exact path with its launches a forward;
  4c. serving modes, exact and ``--fast``: ETC (``fcvsr_etc_forward``, a
     13-frame 272x480 clip, the 7 windows one batch with one frame's
     launches, each output against its window's single forward) and tiled
     serving (``tiled_sr``, a smooth 7 x 540 x 960 window in 15 tiles of
     272, overlap 32, one batched forward, against the whole-frame
     forward), with ms, peak memory and launches;
  5. zoo serving: ``apis.restoration_video_inference`` restores a synthetic
     10-frame RGB clip with EDVR-M (180x320, 5-frame windows), BasicVSR++,
     BasicVSR, IconVSR, FTVSR and TTVSR (192x320, the whole clip in one
     recurrent forward; IconVSR's keyframes 0, 5 and 9), and TDAN its
     forward a 5-frame window (180x320); shapes, finite values and DCN
     launches per forward (FTVSR and TTVSR: no kernel), checked; ms per
     restored frame (``cli.fps_benchmark``) and peak memory; FTVSR's and
     TTVSR's stages (``profiling.stage_times``: SPyNet on the LR frames and
     on the x4 outputs, the trunk, LTAM, the upsampler, the FTT head);
  6. zoo training: ``VideoRestorer`` trains EDVR-M (4 windows of 5 frames),
     BasicVSR++ (1 sequence of 30 frames), BasicVSR and IconVSR (1
     sequence of 15 frames), SPyNet and IconVSR's refill extractor frozen
     by fix_iter, and TDAN its own step (4 windows of 5 frames), on 64x64
     LR patches that ``ClipFolderDataset`` samples from a synthetic RGB
     clip, Adam (0.9, 0.999), Charbonnier-mean: 1 warm-up and 3 timed
     steps, the losses, ms per step, peak memory and K7 / K8 launches per
     step, checked, the frozen tensors unmoved and every other tensor
     moved; then one ``torch.profiler`` step each (device time by kernel,
     idle share); then ``fcvsr_tpu_torch.train.cli`` trains FTVSR (preset
     ftvsr_cvcpLD_QP22: 1 sequence of 7 frames, every frame's GT, 64x64 LR
     patches, Adam 2e-4, Charbonnier-mean) and TTVSR (the same config,
     ``model.name`` ttvsr) on the clip, 1 warm-up step and a resumed run of
     3 timed steps: losses, ms per step, peak memory and no kernel
     launched, checked; then a profiled step each;
  7. training: ``fcvsr_tpu_torch.train.cli`` trains the same preset (batch
     6, 128x128 LR patches from the clip, Adam, Charbonnier-sum) for one
     warm-up step, then resumes from its checkpoint for 5 timed steps; the
     losses, ms per step, peak memory and launch counts per step, checked;
     then ``cli --checkpoint`` serves that checkpoint directory on the
     clip: frame 0's SR the loaded model's forward, not the seed's, PSNR,
     SSIM and tOF finite, tOF's host seconds printed; then the Vimeo
     recipe (preset fcvsr_vimeoLD_QP22, RGB, batch 2, 64x64 LR patches)
     through the same CLI on a synthetic Vimeo-90K tree with its meta
     file, 5 steps, ``--val-lr-root`` / ``--val-gt-root`` with
     eval_interval 2, ``--tensorboard`` and ``--fast``: losses, ms per
     step, the eval PSNRs and CSV rows, the event file, and the launches
     of the steps and the eval forwards, checked; then the whole model in
     bf16 (``utils.precision.bf16_apply``) at 1 x 7 x 1 x 272 x 480
     against the exact path at the --fast bars, its launches (K1, K2, K3
     on bf16 maps) checked, both timed in turns with their peaks;
  7a. data parallelism (``ddp``, right after the training slice):
     ``train/cli.py --multihost`` at world size 1 on NCCL (DDP's
     broadcast, gradient buckets and all-reduce hooks), phase 7's preset,
     batch and patch, 1 + 2 steps with a resume, against the same runs
     without it, before and after (two plain runs need not agree bit for
     bit: the IAC adjoint sums by atomics; their deviation is printed and
     DDP held to DDP_WORLD1_RTOL of the parameters' norm), the launches
     per step phase 7's, ms per step beside the plain run's; EDVR-M's restorer
     step under DDP at world size 1 (``initialize_multihost`` with a
     coordinator, as ``--multihost`` calls it), 2 steps of phase 6's
     recipe, K7 and K8 launched, against the plain step the same way; 2
     ranks on the one card under Gloo (NCCL refuses two ranks on one
     device), spawned with a join timeout, each loading the library built
     above (never building it), TF32 off: FCVSR Y at a global batch of 2
     (1 a rank) of 64^2 patches, 2 steps, the replicas equal bit for bit
     and held to one process's steps on the whole batch (DDP_RTOL), each
     rank's launches; then ``tiled_sr`` over those 2 ranks at phase 4c's
     540x960 window (15 tiles of 272 padded to 16, 8 a rank) against one
     process's, DDP_TILES_RTOL of max|out|;
  7b. the BlockRCB A/B (``python -m
     fcvsr_tpu_torch.benchmarks.microbench_blockrcb_kernel``) at 272x480x64
     with C1 64 and 128: K11 against the unfused path, both timed, their
     deviation held to 2e-2 of max|unfused|;
  7c. the rows-conv probes (K9, ``python -m
     fcvsr_tpu_torch.benchmarks.microbench_conv2``) and the window-copy
     probes (K10, ``... .microbench_dma``, float32 and bf16) at their real
     shapes (17 tiles of 16 rows, C 64, WP 512): their library built from
     ``csrc/microbench/``, each kernel held to its plain version (K9 within
     MB_RTOL of max|plain|, every tile's checksum finite and the same; K10
     bit for bit, the copied row and the fold of every copied byte), timed
     (mm probes warm, the rest cold) beside its bound, its plain version,
     its library call (held to the plain version too) and its yardstick,
     the mm probes also with the L2 bytes they read and that rate; then the
     probes' SASS (``cuobjdump -sass`` of the library): the mm kernel must
     hold wgmma (HGMMA) and TMA tensor loads (UTMALDG) and no mma.sync or
     ldmatrix, the window kernel's six instantiations TMA tensor loads,
     the copy kernel TMA bulk copies (UBLKCP), and none cp.async (LDGSTS);
  7d. the GAN family (``gan_models``), seeded weights at the presets' full
     widths, on the card against the CPU: RealBasicVSR at 1 x 7 x 3 x 64 x
     96 with the default cleaning threshold (1 pass) and with 0 (3), its
     SR and cleaned frames; GLEAN 32 -> 256 (RRDB 64 x 23, style 512,
     channel multiplier 2); DIC 16 -> 128 (4 steps: every step's SR and
     heatmaps); the U-Net at 256^2, StyleGAN2's discriminator at 256 and
     LightCNN at 128, each output's max abs error over its max against
     GAN_RTOL; one ``GANRestorer`` step a family, the generator's and the
     discriminator's gradients (whole, median, worst tensor); each
     generator's forward at its preset's batch and patch (CUDA events,
     median of 5 after 2 warm-ups) and its peak; no kernel launched;
  7e. GAN training (``gan_train``): ``fcvsr_tpu_torch.train.cli`` on each
     of the 5 GAN presets (GAN_TRAIN: RealBasicVSR, GLEAN and DICGAN 1 + 1
     steps with a resume, the ``wogan`` and ``dic_celeba`` recipes a step)
     at its own batch and patch, RealBasicVSR's LQ made from synthetic
     256^2 GT clips by the degradation chain, GLEAN on 32 / 256 and DIC on
     16 / 128 pairs: finite losses, ms per step (CUDA events), the host's
     seconds a step in sampling and in the chain, the peak, the
     checkpoint's keys after the resume, no kernel launched; then one
     profiled step each (device idle share);
  7f. the tools (``tools``): ``fcvsr_tpu_torch.tools.test_FCVSR_FPS``
     for FCVSR and FCVSR-S on Y at its three shapes (184x320, 272x480,
     400x640), exact, ``--fast`` and ``--fast`` + resident + quad (2
     forwards after 1 warm-up a rung): ms a frame, the peak and the
     launches a frame, checked; FCVSR-S (Y) on the card against the CPU
     at 184x320 within MODEL_ATOL; a synthetic 10-frame RGB clip served
     through ``test_REDS_FCVSR`` (180x320) and ``test_Vid4_FCVSR_S``
     (144x176), the launches a frame checked; the trained-proxy rehearsal
     (FCVSR-S RGB trained 30 steps, saved, evaluated, validated through
     ``validate_released_ckpt``), a PASS within 0.01 dB; ``tools.export``
     of the exact FCVSR at 272x480 (``torch.export``, K1-K3 as the custom
     ops ``fcvsr::iac_fused``, ``fcvsr::conv3x3_pair``, ``fcvsr::conv3x3``),
     saved, loaded and run: its launches a frame (36, 180, 31) and its
     output against the eager forward within 1e-6 of max |out|, both timed
     in turns, with the export, save and load seconds;
  8. the seconds each phase took, a JSON line of the kernels (launches
     from the run of the path that launches each: FCVSR training for
     FCVSR's, fast serving with the
     resident chain and the quad for K4 and K6, zoo training for K7 and K8,
     the BlockRCB A/B for K11, the probe for K12, the probes' entry points
     for K9 and K10; each kernel's least time on the card from its bytes
     and operations), the nvidia-smi line, and the result line.

Any failure exits non-zero without a result line; so does a run without a
CUDA device or outside the repository.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
PRESET = "fcvsr_cvcpLD_QP22"
# per frame of the full Y model: 6 iterations x 2 directions x 3 MGAA calls;
# 2 pairs x 3 BlockRCBs x 3 levels x 10 groups; 3 group convs x 10 + conv_last0
PER_FRAME = {"iac": 36, "iac_chain": 0, "iac_bwd": 0, "conv3x3_pair": 180,
             "conv3x3_quad": 0, "conv3x3": 31, "dcn": 0, "dcn_bwd": 0}
# --fast: MGAA(f1, f3) batched, so 2 MGAA calls x 2 directions x 6
# iterations; conv_last0 folded into the tail (no conv3x3 launch)
FAST_PER_FRAME = dict(PER_FRAME, iac=24, conv3x3=30)
# --fast --iac-chain resident --scnet-fuse quad: one launch a chain, one a
# BlockRCB body (3 BlockRCBs x 3 levels x 10 groups)
FUSED_PER_FRAME = dict(PER_FRAME, iac=0, iac_chain=4, conv3x3_pair=0,
                       conv3x3_quad=90, conv3x3=30)
FAST_RUNS = {"fast": ["--fast"],
             "fast_resident_quad": ["--fast", "--iac-chain", "resident",
                                    "--scnet-fuse", "quad"]}
# the JAX package's --fast (test.py:183-187), cli.FAST
FAST_FLAGS = dict(batch_mgaa=True, k_fused=True, tail_impl="folded",
                  iac_dtype="bf16", scnet_dtype="bf16", head_dtype="bf16",
                  mffr_dtype="bf16")
# each serving flag alone over the exact path, the two fast sets, the two
# flags that won alone on the H100 (PERF.md), and the JAX --fast set
# without its folded tail, timed in turns on one model; each held to the
# --fast bars against the exact path
FLAG_VARIANTS = {
    "exact": {}, "batch_mgaa": dict(batch_mgaa=True),
    "folded": dict(tail_impl="folded"), "folded_pb": dict(tail_impl="folded_pb"),
    "k_fused": dict(k_fused=True),
    "iac_bf16": dict(iac_dtype="bf16"), "scnet_bf16": dict(scnet_dtype="bf16"),
    "head_bf16": dict(head_dtype="bf16"), "mffr_bf16": dict(mffr_dtype="bf16"),
    "tail_bf16": dict(tail_dtype="bf16"),
    "resident": dict(iac_chain="resident"), "quad": dict(scnet_fuse="quad"),
    "fast": FAST_FLAGS,
    "fast_resident_quad": dict(FAST_FLAGS, k_fused=False,
                               iac_chain="resident", scnet_fuse="quad"),
    "batch_mgaa_scnet_bf16": dict(batch_mgaa=True, scnet_dtype="bf16"),
    "fast_unfolded": dict(FAST_FLAGS, tail_impl="xla")}
# the serving modes (phase modes): ETC's 13-frame clip at the FPS shape,
# and a 540x960 window in tiles of 272 with an overlap of 32 (15 tiles, a
# 2160x3840 output)
ETC_SHAPE = (1, 13, 1, 272, 480)
TILE_SHAPE = (7, 1, 540, 960)
TILE, OVERLAP = 272, 32
# tiled serving against the whole frame: the JAX package's tiled_sr (which
# the port follows) pads the frame by edge replication to its tile grid,
# where the whole frame's convs pad its border with zeros, so SR pixels
# within OVERLAP LR pixels of a padded side (the bottom and right of a
# 540x960 window) see other context; the --fast bars hold the seams, every
# pixel with at least OVERLAP pixels of the whole frame's context, and the
# whole frame's mean; the whole frame's max, in that band, is printed
TILE_BORDER_BAND = 4 * OVERLAP  # SR pixels
# ETC's windows against single forwards under the same flags: the exact
# path at 1e-4 (f32 sums in another order as the batch changes); under
# --fast that noise moves values across bf16 rounding boundaries at the
# storage handoffs (each bf16 type alone does it, on the CPU too), so
# --fast is held to its own bars, FAST_MAX and FAST_MEAN
ETC_ATOL = 1e-4
# per training step: the forward's launches; the IAC adjoint is one
# launch an iteration; each pair's backward rebuilds its intermediate
# with one conv3x3 launch
PER_STEP = dict(PER_FRAME, iac_bwd=36, conv3x3=211)
ZOO_T = 10  # frames of the zoo's serving clip


def dcn_per_forward(model: str, t: int) -> int:
    """DCN launches a forward of t frames: EDVR's levels 3, 2, 1 and the
    cascade, once each (T folded into the batch); BasicVSR++'s 4 branches
    at every frame but the first of each; BasicVSR, FTVSR and TTVSR
    none; IconVSR the 4 of
    its refill's PCD (EDVR's) at each keyframe, every ICON_STRIDE frames
    and the last; TDAN its 4 DCNv1s, the 4 neighbours one batch."""
    if model == "EDVRNet" or model == "TDANNet":
        return 4
    if model in ("BasicVSRNet",) + RECURRENT_PLAIN:
        return 0
    if model == "IconVSR":
        keys = set(range(0, t, ICON_STRIDE)) | {t - 1}
        return 4 * len(keys)
    return 4 * (t - 1)


ICON_STRIDE = 5  # IconVSR's keyframe stride (mmedit's iconvsr_reds4)
# the zoo the smoke serves and trains: the DCN models, then BasicVSR, FTVSR
# and TTVSR
ZOO = ("EDVRNet", "BasicVSRPlusPlus", "BasicVSRNet", "IconVSR", "TDANNet",
       "FTVSRNet", "TTVSRNet")
# the recurrent models whose path runs no kernel of the port: cuDNN convs,
# GEMMs and attention, flow warps and gathers
RECURRENT_PLAIN = ("FTVSRNet", "TTVSRNet")
# the input of the GPU-against-CPU checks: FTVSR and TTVSR take 8 frames
# of 64x64 (H and W as the JAX package's FTVSR golden shape; at keyframes
# every 3 frames, LTAM chooses between 2 keyframes at 8 steps and between
# 3 at 2), the rest 5 of 64x96
ZOO_CHECK = {"FTVSRNet": (1, 8, 3, 64, 64), "TTVSRNet": (1, 8, 3, 64, 64)}
# gradients that are 0 in exact arithmetic: the attention's softmax does
# not see one vector added to every key, so FTVSR's key-embedding bias
# gets rounding only; held under ZERO_GRAD_RTOL of the whole gradient's
# norm on both devices, outside the per-tensor bars
ZERO_GRAD = {"FTVSRNet": ("ftta.layer_k.bias",)}
ZERO_GRAD_RTOL = 1e-6
# the models whose gradients the card holds to the CPU's
ZOO_GRADS = ("EDVRNet", "BasicVSRPlusPlus", "IconVSR", "TDANNet") \
    + RECURRENT_PLAIN


KERNELS = {
    "iac": ("fcvsr_tpu_torch/csrc/iac.cu", "fcvsr_tpu/ops/pallas_iac.py:98"),
    "iac_chain": ("fcvsr_tpu_torch/csrc/iac_chain.cu",
                  "fcvsr_tpu/ops/pallas_iac.py:421"),
    "conv3x3_pair": ("fcvsr_tpu_torch/csrc/conv3x3.cu",
                     "fcvsr_tpu/ops/pallas_conv.py:236"),
    "conv3x3_quad": ("fcvsr_tpu_torch/csrc/conv3x3_quad.cu",
                     "fcvsr_tpu/ops/pallas_conv.py:410"),
    "conv3x3": ("fcvsr_tpu_torch/csrc/conv3x3.cu",
                "fcvsr_tpu/ops/pallas_conv.py:108"),
    "iac_bwd": ("fcvsr_tpu_torch/csrc/iac_bwd.cu",
                "fcvsr_tpu/ops/pallas_iac.py:926"),
    "dcn": ("fcvsr_tpu_torch/csrc/dcn.cu", "fcvsr_tpu/ops/pallas_dcn.py:58"),
    "dcn_bwd": ("fcvsr_tpu_torch/csrc/dcn_bwd.cu",
                "fcvsr_tpu/ops/pallas_dcn.py:397"),
    "blockrcb": ("fcvsr_tpu_torch/csrc/blockrcb.cu",
                 "benchmarks/microbench_blockrcb_kernel.py:76"),
    "scale2": ("fcvsr_tpu_torch/csrc/probe/scale2.cu", "tools/tpu_probe.py:89"),
}
# K9 and K10: the probes' kernels, on their own entry points
MICROBENCH = {
    "mm_stream": "benchmarks/microbench_conv2.py:62",
    "mm_stream3": "benchmarks/microbench_conv2.py:82",
    "im2col": "benchmarks/microbench_conv2.py:107",
    "dma_window": "benchmarks/microbench_conv2.py:140",
    "dma_one_shot": "benchmarks/microbench_dma.py:60",
    "dma_serial": "benchmarks/microbench_dma.py:80",
    "dma_dbuf": "benchmarks/microbench_dma.py:102",
}
# the probes' routes within CUDA: Hopper's warpgroup MMA fed by TMA; the
# window and copy probes as persistent TMA streams on mbarrier rings
PROBE_DESIGN = {**dict.fromkeys(("mm_stream", "mm_stream3"), "wgmma + TMA"),
             **dict.fromkeys(("im2col", "dma_window"),
                             "TMA tensor-map ring, row units"),
             **dict.fromkeys(("dma_one_shot", "dma_serial", "dma_dbuf"),
                             "TMA bulk-copy ring, a block an SM")}
KERNELS.update({name: ("fcvsr_tpu_torch/csrc/microbench/"
                       + ("dma.cu" if "microbench_dma" in where
                          else "conv2.cu"), where)
                for name, where in MICROBENCH.items()})
# f32 kernels against f32 plain versions that sum in another order: the
# bound scales with the output's magnitude (IAC: 3x3 taps of a warped value
# and a 64-term kernel dot in kf mode; convs: up to 1152-term dot products;
# the IAC adjoint: dflow sums 64 channels, dsrc sums by atomics in an order
# that changes from run to run; conv gradients: sums over every pixel)
IAC_RTOL = 2e-5
IAC_BWD_RTOL = 1e-5
CONV_RTOL = 1e-4
# the resident chain (K4) against the plain chain: IAC_RTOL carried through
# 6 iterations (against K1 launched once an iteration, which runs the same
# tile body on the same values: exact)
IAC_CHAIN_RTOL = 1e-4
# bf16 storage, kernel against plain version: both round at the same
# handoffs, but a value within reassociation noise of a rounding boundary
# rounds either way, one bf16 step (2^-8 to 2^-7 of the value) that later
# iterations or convs carry on: two steps of the output's magnitude
BF16_RTOL = 1.6e-2
# the JAX package's --fast bars on the model's output against the exact
# path (tests/test_inference_precision.py)
FAST_MAX, FAST_MEAN = 0.02, 2e-3
# GPU vs CPU model output in [0, 1]: well under one 8-bit grey level (3.9e-3)
MODEL_ATOL = 1e-3
# GPU vs CPU gradients, relative to their norm.  The whole gradient and the
# median tensor are held to GRAD_RTOL, the per-tensor bar of the CPU test
# against JAX; each tensor to FLIP_RTOL.  At f32 noise the gradient is not a
# continuous function of the inputs: a (leaky) relu whose input lies within
# that noise of 0 takes the other branch, and a flow within it of an integer
# (the random model's flows sit near 0) moves the warp's floor.  The phase
# measures that floor on the CPU (the same step with the input moved by 1e-6
# of itself) and prints it beside the GPU's deviation.  A gradient that is
# missing, or wrong in a kernel, is off by its own size.
GRAD_RTOL = 1e-3
FLIP_RTOL = 5e-2
# the DCN adjoint against the plain VJP, each gradient relative to its own
# max: dW sums up to 288,000 pixels (dx up to 36 contributions a value) by
# atomics in an order that changes from run to run, against cuBLAS-style
# sums in the plain version; f32 rounding of such sums stays near 1e-6 of
# the max
DCN_BWD_RTOL = 1e-4
# K11 against the unfused path in the A/B: the unfused pair kernels keep
# their weights float32 where K11 rounds them to bf16, as the TPU kernel
# does; the JAX A/B's "max dev 2% of scale" for the same comparison
AB_RTOL = 2e-2
# K9 against its plain versions: float32 sums of up to 576 bf16 values
# (exact products in the mm probes) taken in another order
MB_RTOL = 1e-4
# K2's kernel issues wgmma (HGMMA in SASS); its float32 work outside them
# is the epilogue's bias, activation and splits (FADD, FMUL).  The FMA
# kernel it replaced ran its main loop as FFMA on register tiles
PAIR_SASS_FFMA_MAX = 32
# K7's and K8's kernels issue wgmma; their FFMA are the sampler's
# bilinear sums and the adjoint's derivatives, unrolled over a quad's 4
# channels: 96 and 104 on the H100's toolkit (PERF.md §6); the FMA
# kernels they replaced ran each contraction on register tiles of FFMA
DCN_SASS_FFMA_MAX = 160
# K11's mean abs error against its plain version, relative to max|plain|, as
# tests/test_torch_blockrcb.py holds the plain version to JAX: the bf16 bar
# above allows a flipped rounding here and there, not a shifted map
BF16_MEAN_RTOL = 1e-3


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(phase: str, **kw) -> None:
    print(f"[{phase}] " + json.dumps(kw), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def mixed_flows(rng, b, h, w, c=2):
    """Small displacements, +-20 px in the top third, out of the frame at
    the bottom and at the left edge: c channels of (first, second) axis
    pairs, a flow's (dx, dy) or a DCN offset's (dy, dx) per tap."""
    flow = rng.standard_normal((b, h, w, c)) * 1.5
    flow[:, : h // 3] = rng.uniform(-20, 20, (b, h // 3, w, c))
    flow[:, -max(1, h // 6):, :, 0::2] += 600.0
    flow[:, :, : max(1, w // 8), 1::2] -= 400.0
    return flow


def phase_kernels(torch, dev):
    import torch.nn.functional as F

    from fcvsr_tpu_torch.profiling import (BF16_FLOP_S, TF32_FLOP_S, bound,
                                           cuda_ms, warm_ms)
    from fcvsr_tpu_torch.ops import fused_conv, fused_dcn, fused_iac
    from fcvsr_tpu_torch.ops.dcn import modulated_deform_conv2d

    rng = np.random.default_rng(0)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    results = {name: {"max_abs_err": 0.0} for name in KERNELS}

    def check(name, label, kern, plain, rtol, work=None, library=None,
              yardstick=None, mean_rtol=None, beside=None, notes=None,
              warm=False):
        """Kernel against plain version; a tuple of outputs is checked one
        by one (in float32, whatever the storage).  ``work`` = (bytes,
        flops[, flop/s]) marks a timed case, with its bound at that rate
        (default the float32 pipes'); the first such case of a kernel goes
        into the result line.  ``notes``: more items for the case's line.
        ``yardstick`` = (label, fn[, rtol]): the
        same function by other kernels, checked at its own rtol (default
        ``rtol``) and timed beside.  ``mean_rtol`` also holds the kernel's
        mean abs error to that share of max|plain|.  ``library`` is one
        PyTorch call computing the same function; ``beside`` = (label, fn)
        one that does not (a plain conv beside a deformable one), timed
        beside it and not checked.  ``warm`` also times the kernel and the
        plain version warm (``warm_ms``: 20 calls an event pair, in turns).
        The result line's max_abs_err is the kernel's against its plain
        version."""
        outs, refs = kern(), plain()
        if isinstance(outs, torch.Tensor):
            outs, refs = (outs,), (refs,)
        torch.cuda.synchronize()
        errs = [float((o.float() - r.float()).abs().max())
                for o, r in zip(outs, refs)]
        tols = [rtol * max(1.0, float(r.float().abs().max())) for r in refs]
        line = dict(kernel=name, case=label, max_abs_err=errs, tol=tols)
        if mean_rtol is not None:
            means = [float((o.float() - r.float()).abs().mean())
                     for o, r in zip(outs, refs)]
            mean_tols = [mean_rtol * float(r.float().abs().max())
                         for r in refs]
            line.update(mean_abs_err=means, mean_tol=mean_tols)
            for e, tol in zip(means, mean_tols):
                if not e <= tol:
                    fail(f"{name} {label}: mean abs error {e} > {tol}")
        if yardstick is not None:
            ys = yardstick[1]()
            ys = (ys,) if isinstance(ys, torch.Tensor) else ys
            yerrs = [float((o.float() - r.float()).abs().max())
                     for o, r in zip(outs, ys)]
            yrtol = yardstick[2] if len(yardstick) > 2 else rtol
            errs = errs + yerrs
            tols = tols + [yrtol * max(1.0, float(r.float().abs().max()))
                           for r in ys]
            line.update(max_abs_err=errs, tol=tols, yardstick=yardstick[0])
        if work is not None:
            extra = {"library_ms": library,
                     "yardstick_ms": yardstick and yardstick[1],
                     "beside_ms": beside and beside[1]}
            extra = {k: f for k, f in extra.items() if f}
            times = cuda_ms([kern, plain, *extra.values()])
            bound_ms, bound_by = bound(*work)
            line.update(ms=times[0], plain_ms=times[1], bound_ms=bound_ms,
                        bound_by=bound_by, library_ms=None)
            line.update(zip(extra, times[2:]))
            if yardstick:
                line["ms_over_yardstick"] = line["ms"] / line["yardstick_ms"]
            if warm:
                line["warm_ms"], line["warm_plain_ms"] = warm_ms([kern, plain])
            if beside:
                line["beside"] = beside[0]
            if len(work) > 2:
                line["f32_pipes_bound_ms"] = bound(*work[:2])[0]
            line.update(notes or {})
            if "ms" not in results[name]:
                results[name].update((k, line[k]) for k in (
                    "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"))
        say("kernels", **line)
        for e, tol in zip(errs, tols):
            if not e <= tol:
                fail(f"{name} {label}: max abs error {e} > {tol}")
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"],
                                           *errs[:len(refs)])

    # IAC at the FCVSR shape: B=1, C=64, 272x480, 6 iterations of kernels;
    # flows mix small, +-20 px and out-of-frame displacements
    b, h, w, c, n_it = 1, 272, 480, 64, 6
    feat = t(rng.standard_normal((b, h, w, c)))
    fin = t(rng.standard_normal((b, h, w, c)))
    flow = t(mixed_flows(rng, b, h, w))
    k = t(rng.standard_normal((b, h, w, n_it * 3 * c)) * 0.3)
    f0 = t(rng.standard_normal((b, h, w, c)))
    wsel = t(rng.standard_normal((c, n_it * 3 * c)) * 0.1)
    bsel = t(rng.standard_normal((n_it * 3 * c,)) * 0.1)
    # the materialised-kernel variant first: it is the one the slice serves,
    # so its times are the ones the result line reports.  Work: feat, flow,
    # the 3C kernels and feat_in read, out written; ~22 flops a value (the
    # 4-corner warp, two 3-tap passes, residual, activation)
    px = b * h * w

    def iac_work(px, c, kf, sb=4):
        """K1's bytes (feat, the kernels or f0, feat_in read, out written;
        flows float32) and flops: ~22 a value, plus the kf prediction's
        2 C0 3C a pixel, on the tensor cores (their rate the bound's)."""
        if kf:
            return (px * (sb * 4 * c + 8), (22 + 6 * c) * px * c, BF16_FLOP_S)
        return (px * (sb * 6 * c + 8), 22 * px * c)

    for it, act in ((0, True), (5, False)):
        check("iac", f"materialised it={it} act={act} 272x480x64",
              lambda: fused_iac.warp_sac_fused(feat, flow, k, fin, act, it),
              lambda: fused_iac.warp_sac_plain(feat, flow, k, fin, act, it),
              IAC_RTOL, work=iac_work(px, c, False) if it == 0 else None,
              warm=True)
        check("iac", f"kf it={it} act={act} 272x480x64",
              lambda: fused_iac.warp_sac_fused_kf(feat, flow, f0, wsel, bsel,
                                                  fin, act, it),
              lambda: fused_iac.warp_sac_plain(
                  feat, flow, fused_iac.predict_kernels(f0, wsel, bsel, it, c),
                  fin, act),
              IAC_RTOL, work=iac_work(px, c, True) if it == 0 else None,
              warm=True)
    del feat, fin, flow, k, f0

    # SCNet convs at its three levels.  Work: x read, out (and res) written
    # once, the weights; 2 flops a multiply-add
    def conv_work(px, *chans, storage=4, outputs=None):
        """Bytes (the input map read, the output maps written, the float32
        weights) and flops (2 a multiply-add) of a chain of 3x3 convs."""
        macs = sum(9 * a * b for a, b in zip(chans, chans[1:]))
        maps = chans[0] + sum(outputs or (chans[-1],))
        return (storage * px * maps + 4 * macs, 2 * px * macs)

    def _two_pairs(xs, quad):
        y = fused_conv.conv3x3_pair(xs, *quad[:4], 0.1)
        return y, fused_conv.conv3x3_pair(y, *quad[4:], 0.2)

    def pair_work(px, *chans, storage=4):
        """K2's work: the function's flops at the bf16 tensor cores' rate
        (its products' rate) with the float32 pipes' bound beside; notes:
        the route's passes (3 bf16 products a multiply-add for float32
        maps, 2 for bf16) at that rate, and for float32 maps 3xTF32's."""
        nbytes, flops = conv_work(px, *chans, storage=storage)
        passes = 3 if storage == 4 else 2
        notes = {"route": "bf16x3" if storage == 4 else "bf16 x (w_hi + w_lo)",
                 "route_passes": passes,
                 "route_passes_bound_ms": bound(nbytes, passes * flops,
                                                BF16_FLOP_S)[0]}
        if storage == 4:
            notes["tf32x3_bound_ms"] = bound(nbytes, 3 * flops, TF32_FLOP_S)[0]
        return (nbytes, flops, BF16_FLOP_S), notes

    for (h, w) in ((272, 480), (136, 240), (68, 120)):
        px = h * w
        x = t(rng.standard_normal((1, h, w, 64)))
        w1 = t(rng.standard_normal((3, 3, 64, 128)) * 0.04)
        b1 = t(rng.standard_normal(128) * 0.1)
        w2 = t(rng.standard_normal((3, 3, 128, 64)) * 0.03)
        b2 = t(rng.standard_normal(64) * 0.1)
        work, notes = pair_work(px, 64, 128, 64)
        check("conv3x3_pair", f"64->128->64 bias ns0.1 {h}x{w}",
              lambda: fused_conv.conv3x3_pair(x, w1, b1, w2, b2, 0.1),
              lambda: fused_conv.conv3x3_pair_plain(x, w1, b1, w2, b2, 0.1),
              CONV_RTOL, work=work, notes=notes)
        r1 = t(rng.standard_normal((3, 3, 64, 64)) * 0.04)
        r2 = t(rng.standard_normal((3, 3, 64, 64)) * 0.04)
        quad = (w1, b1, w2, b2, r1, None, r2, None)
        work, notes = pair_work(px, 64, 64, 64)
        check("conv3x3_pair", f"64->64->64 nobias ns0.2 {h}x{w}",
              lambda: fused_conv.conv3x3_pair(x, r1, None, r2, None, 0.2),
              lambda: fused_conv.conv3x3_pair_plain(x, r1, None, r2, None,
                                                    0.2),
              CONV_RTOL, work=work, notes=notes)
        res = t(rng.standard_normal((1, h, w, 64)))
        rw = conv_work(px, 64, 64)
        # K3's bound: its bytes (the residual too) and the function's own
        # flops at the tensor cores' rate, the float32 pipes' beside; no
        # single call adds the residual: one cuDNN conv with bias is timed
        # beside it
        check("conv3x3", f"64->64 +res {h}x{w}",
              lambda: fused_conv.conv3x3(x, r1, b2, res=res),
              lambda: fused_conv.conv3x3_plain(x, r1, b2, res=res),
              CONV_RTOL, work=(rw[0] + 4 * px * 64, rw[1], BF16_FLOP_S),
              notes={"route": "bf16x3"}, warm=True,
              beside=("cuDNN conv, no residual",
                      lambda: F.conv2d(x.permute(0, 3, 1, 2),
                                       r1.permute(3, 2, 0, 1), b2,
                                       padding=1)))
        # bf16 storage (float32 weights): 2-byte maps
        xb, resb = x.bfloat16(), res.bfloat16()
        work, notes = pair_work(px, 64, 128, 64, storage=2)
        check("conv3x3_pair", f"bf16 64->128->64 bias ns0.1 {h}x{w}",
              lambda: fused_conv.conv3x3_pair(xb, w1, b1, w2, b2, 0.1),
              lambda: fused_conv.conv3x3_pair_plain(xb, w1, b1, w2, b2, 0.1),
              BF16_RTOL, work=work, notes=notes)
        work, notes = pair_work(px, 64, 64, 64, storage=2)
        check("conv3x3_pair", f"bf16 64->64->64 nobias ns0.2 {h}x{w}",
              lambda: fused_conv.conv3x3_pair(xb, r1, None, r2, None, 0.2),
              lambda: fused_conv.conv3x3_pair_plain(xb, r1, None, r2, None,
                                                    0.2),
              BF16_RTOL, work=work, notes=notes)
        rw = conv_work(px, 64, 64, storage=2)
        check("conv3x3", f"bf16 64->64 +res {h}x{w}",
              lambda: fused_conv.conv3x3(xb, r1, b2, res=resb),
              lambda: fused_conv.conv3x3_plain(xb, r1, b2, res=resb),
              BF16_RTOL, work=(rw[0] + 2 * px * 64, rw[1], BF16_FLOP_S),
              notes={"route": "bf16 x (w_hi + w_lo)"}, warm=True)
        # the BlockRCB quad (K6): the block pair (64->128->64, biases) and
        # the RCB pair (64->64->64, none), y and out; against two pairs,
        # which run the same loop on the same partition: bit for bit.  Its
        # bound, as K2's: the function's flops at the bf16 tensor-core
        # rate, the float32 pipes' beside; bytes x read, y and out written
        for st, xs in (("f32", x), ("bf16", xb)):
            sb = 4 if st == "f32" else 2
            nbytes, flops = conv_work(px, 64, 128, 64, 64, 64, storage=sb,
                                      outputs=(64, 64))
            passes = 3 if sb == 4 else 2
            check("conv3x3_quad", f"{st} 64->128->64->64->64 {h}x{w}",
                  lambda: fused_conv.conv3x3_quad(xs, *quad),
                  lambda: fused_conv.conv3x3_quad_plain(xs, *quad),
                  CONV_RTOL if st == "f32" else BF16_RTOL,
                  work=(nbytes, flops, BF16_FLOP_S),
                  notes={"route_passes": passes,
                         "route_passes_bound_ms": bound(
                             nbytes, passes * flops, BF16_FLOP_S)[0]},
                  yardstick=("2 K2 launches", lambda: _two_pairs(xs, quad),
                             0.0))
        del xb, resb

    # the resident IAC chain (K4) at FCVSR's shape: 6 iterations, B 1 (the
    # g2 call) and 2 (the batched f1/f3 call), float32 and bf16; flows as
    # above.  Work: feat_in, the 6 x 3C kernels and the 6 flows read once,
    # out written once; ~22 flops a value an iteration
    h, w, c = 272, 480, 64
    for b in (1, 2):
        fin32 = t(rng.standard_normal((b, h, w, c)))
        k32 = t(rng.standard_normal((b, h, w, n_it * 3 * c)) * 0.3)
        offs = torch.stack([t(mixed_flows(rng, b, h, w)) for _ in range(n_it)])
        px = b * h * w
        for st in ("f32", "bf16"):
            fin, k = (fin32, k32) if st == "f32" else (fin32.bfloat16(),
                                                       k32.bfloat16())
            sb = 4 if st == "f32" else 2
            check("iac_chain", f"{st} B{b} ac6 272x480x64",
                  lambda: fused_iac.iac_fused_resident(fin, k, offs, n_it),
                  lambda: fused_iac.iac_chain_plain(fin, k, offs, n_it),
                  IAC_CHAIN_RTOL if st == "f32" else BF16_RTOL,
                  work=(px * (sb * (2 * c + n_it * 3 * c) + 4 * 2 * n_it),
                        22 * px * c * n_it),
                  yardstick=("6 K1 launches", lambda: fused_iac.iac_fused(
                      fin, k, offs, n_it, c), 0.0))
            del fin, k
        # K1, both variants, float32 (B 2; B 1 above) and bf16, at the
        # same shape
        f032 = t(rng.standard_normal((b, h, w, c)))
        for st in ("f32", "bf16") if b == 2 else ("bf16",):
            cast = (lambda a: a) if st == "f32" else (lambda a: a.bfloat16())
            sb = 4 if st == "f32" else 2
            featb, finb = cast(fin32), cast(fin32.flip(-1).contiguous())
            kb, f0b = cast(k32), cast(f032)
            tol = IAC_RTOL if st == "f32" else BF16_RTOL
            check("iac", f"{st} materialised B{b} it=0 272x480x64",
                  lambda: fused_iac.warp_sac_fused(featb, offs[0], kb, finb),
                  lambda: fused_iac.warp_sac_plain(featb, offs[0], kb, finb),
                  tol, work=iac_work(px, c, False, sb), warm=True)
            check("iac", f"{st} kf B{b} it=0 272x480x64",
                  lambda: fused_iac.warp_sac_fused_kf(featb, offs[0], f0b,
                                                      wsel, bsel, finb),
                  lambda: fused_iac.warp_sac_plain(
                      featb, offs[0], fused_iac.predict_kernels(
                          f0b, wsel, bsel, 0, c), finb),
                  tol, work=iac_work(px, c, True, sb), warm=True)
            del featb, finb, kb, f0b
        del fin32, k32, offs, f032

    # the BlockRCB level (K11) at SCNet's level 1 with C1 = C (the JAX A/B's
    # configuration) and FCVSR's C1 = 128, at levels 2 and 3, and at B 2:
    # input uniform(-1, 1), weights N(0, 0.2) as the A/B draws them (at B 2
    # the second image from another seed, so that a softmax partial mixed
    # across images shows); beside the unfused path (2 K2 launches, the
    # ContextBlock, lrelu and the add) on the same weights; its work is
    # ab.level_work's, its bound at the bf16 tensor-core rate (bf16 maps
    # times bf16-rounded weights), with the float32 pipes' beside it
    from fcvsr_tpu_torch.benchmarks import microbench_blockrcb_kernel as ab
    from fcvsr_tpu_torch.models.scnet_rows import block_rcb_level
    from fcvsr_tpu_torch.ops.fused_blockrcb import block_rcb, block_rcb_plain
    from fcvsr_tpu_torch.utils.convert import block_rcb_args

    for (b, h, w, c1) in ((1, 272, 480, 64), (1, 272, 480, 128),
                          (1, 136, 240, 128), (1, 68, 120, 128),
                          (1, 136, 240, 64), (1, 68, 120, 64),
                          (2, 272, 480, 128)):
        xs, blk = ab.seeded_level(0, h, w, 64, c1)
        xs = torch.cat([xs] + [ab.seeded_level(s, h, w, 64, c1)[0]
                               for s in range(1, b)])
        xs, blk = xs.to(dev), blk.to(dev)
        with torch.no_grad():
            kw = block_rcb_args(blk)
            check("blockrcb", f"B{b} {h}x{w}x64 C1 {c1}",
                  lambda: block_rcb(xs, **kw),
                  lambda: block_rcb_plain(xs, **kw), BF16_RTOL,
                  work=(*ab.level_work(b, h, w, 64, c1), BF16_FLOP_S),
                  yardstick=("unfused: 2 K2 launches + ContextBlock",
                             lambda: block_rcb_level(blk, xs, "pair"),
                             AB_RTOL), mean_rtol=BF16_MEAN_RTOL)
            if c1 == 128 and b == 1:
                # its conv phases: y and r equal a K6 launch on the same
                # input with the weights rounded to bf16, bit for bit
                scratch = (torch.empty_like(xs), torch.empty_like(xs))
                rw = [kw[n].bfloat16().float()
                      for n in ("wb0", "wb1", "wr0", "wr1")]
                check("blockrcb", f"y, r against K6 B{b} {h}x{w}x64 C1 {c1}",
                      lambda: (block_rcb(xs, **kw, scratch=scratch),
                               scratch)[1],
                      lambda: fused_conv.conv3x3_quad(
                          xs, rw[0], kw["bb0"], rw[1], kw["bb1"], rw[2],
                          None, rw[3], None, 0.1, 0.2), 0.0)
        del xs, blk, kw

    # the probe kernel (K12): o = 2 x on an (8, 128) float32 tensor, exact;
    # 8 KB of traffic, so its time is a launch's latency
    from fcvsr_tpu_torch.tools import gpu_probe

    x = t(rng.standard_normal((8, 128)))
    check("scale2", "(8, 128) float32", lambda: gpu_probe.scale2(x),
          lambda: gpu_probe.scale2_plain(x), 0.0,
          work=(2 * 4 * x.numel(), x.numel()),
          library=lambda: torch.mul(x, 2.0))
    # and warm: 200 launches between one event pair, beside torch.mul, in
    # turns, with the cold figures (benchmarks/launch_path.py)
    from fcvsr_tpu_torch.benchmarks import launch_path

    say("k12_launch_path", **launch_path.measure())

    x = t(rng.uniform(-1, 1, (1, 1088, 1920, 64)))
    wl = t(rng.standard_normal((3, 3, 64, 1)) * 0.04)
    bl = t(rng.standard_normal(1))
    check("conv3x3", "64->1 conv_last0 1088x1920",
          lambda: fused_conv.conv3x3(x, wl, bl),
          lambda: fused_conv.conv3x3_plain(x, wl, bl), CONV_RTOL,
          work=(*conv_work(1088 * 1920, 64, 1), BF16_FLOP_S),
          notes={"route": "bf16x3, N padded to 8"}, warm=True)
    # and on bf16 maps, as conv_last0 runs under tail_dtype='bf16'
    xb = x.bfloat16()
    check("conv3x3", "bf16 64->1 conv_last0 1088x1920",
          lambda: fused_conv.conv3x3(xb, wl, bl),
          lambda: fused_conv.conv3x3_plain(xb, wl, bl), BF16_RTOL,
          work=(*conv_work(1088 * 1920, 64, 1, storage=2), BF16_FLOP_S),
          notes={"route": "bf16 x (w_hi + w_lo), N padded to 8"}, warm=True)
    del x, xb

    # the IAC adjoint (K5) at the training shape: B=6, 128x128, C=64, its
    # dk written into one buffer as the chain does; the cotangent masked by
    # the activation (it 0) or not (it 5).  Work: src, flow, the 3C kernels
    # and gz read, dk, dflow and dsrc written; ~40 flops a value
    b, h, w, c = 6, 128, 128, 64
    px = b * h * w
    src = t(rng.standard_normal((b, h, w, c)))
    flow = t(mixed_flows(rng, b, h, w))
    k = t(rng.standard_normal((b, h, w, n_it * 3 * c)) * 0.3)
    g = t(rng.standard_normal((b, h, w, c)))
    for it, act in ((0, True), (5, False)):
        gz = torch.where(src > 0, g, 0.1 * g) if act else g
        dk = torch.zeros_like(k)
        check("iac_bwd", f"it={it} act={act} 6x128x128x64",
              lambda: fused_iac.warp_sac_bwd(src, flow, k, gz, it, dk),
              lambda: fused_iac.warp_sac_vjp_plain(src, flow, k, gz, it),
              IAC_BWD_RTOL,
              work=(4 * px * (9 * c + 4), 40 * px * c) if it == 0 else None)
    del src, flow, k, g, dk, gz
    # and at small odd shapes: tiles cut at the frame's edges, channel
    # chunks cut short, C not a multiple of 4 (scalar loads and atomics),
    # and B 3 with most flows pushed 5 frames' size out of the frame
    for (b, h, w, c, far) in ((2, 5, 7, 8, False), (2, 13, 29, 20, False),
                              (2, 9, 21, 5, False), (3, 11, 18, 24, True)):
        src = t(rng.standard_normal((b, h, w, c)))
        fl = mixed_flows(rng, b, h, w)
        if far:
            side = rng.integers(0, 5, (b, h, w))
            for i, (dx, dy) in enumerate(((5 * w, 0), (-5 * w, 0),
                                          (0, 5 * h), (0, -5 * h))):
                fl[..., 0] += (side == i) * dx
                fl[..., 1] += (side == i) * dy
        flow = t(fl)
        k = t(rng.standard_normal((b, h, w, 3 * 3 * c)) * 0.3)
        gz = t(rng.standard_normal((b, h, w, c)))
        check("iac_bwd", f"it=1 {b}x{h}x{w}x{c}{' far' if far else ''}",
              lambda: fused_iac.warp_sac_bwd(src, flow, k, gz, 1),
              lambda: fused_iac.warp_sac_vjp_plain(src, flow, k, gz, 1),
              IAC_BWD_RTOL)
    del src, flow, k, gz

    # the deformable conv (K7) at EDVR-M's level 1 (the 5 frames of a REDS
    # window, 64 -> 64, 8 deform groups) and its training batch (4 windows
    # of 5 frames at 64x64), BasicVSR++'s alignment (128 -> 64, 16 groups),
    # serving 192x320 and training 64x64 (the shape of its 116 launches a
    # step), offsets mixed as the flows above; without a mask; TDAN's DCNv1
    # (64 -> 64, 8 groups, no mask, no bias) at its serving batch (the 4
    # neighbours of a 180x320 window); at small odd shapes (a group width
    # of 3 reads scalars).  Work: x, offsets, mask and
    # weights read, out written; 2 flops a multiply-add of the 9 * Cin *
    # Cout contraction and 8 a sampled value (4 corner products and their
    # sum, the weights), at the bf16 tensor cores' rate (the contraction's),
    # the float32 pipes' beside.  The yardstick beside it is cuDNN's conv of
    # the same shapes, the zero-offset special case
    for (b, h, w, cin, cout, dg, with_mask, timed, bias) in (
            (5, 180, 320, 64, 64, 8, True, True, True),
            (1, 192, 320, 128, 64, 16, True, True, True),
            (1, 64, 64, 128, 64, 16, True, True, True),
            (20, 64, 64, 64, 64, 8, True, True, True),
            (4, 180, 320, 64, 64, 8, False, True, False),
            (2, 64, 96, 64, 64, 8, False, False, True),
            (2, 13, 29, 24, 40, 3, True, False, True),
            (1, 5, 7, 8, 70, 1, True, False, True),
            (2, 9, 11, 6, 20, 2, True, False, True)):
        x = t(rng.standard_normal((b, h, w, cin)))
        off = t(mixed_flows(rng, b, h, w, dg * 18))
        mask = t(1 / (1 + np.exp(-rng.standard_normal((b, h, w, dg * 9))))) \
            if with_mask else None
        wd = t(rng.standard_normal((3, 3, cin, cout)) / np.sqrt(9 * cin))
        bd = t(rng.standard_normal(cout) * 0.1) if bias else None
        px = b * h * w
        work = (4 * (px * (cin + dg * 18 + (dg * 9 if with_mask else 0)
                           + cout) + 9 * cin * cout + (cout if bias else 0)),
                px * 9 * cin * (2 * cout + 8), BF16_FLOP_S)
        check("dcn", f"{b}x{h}x{w} {cin}->{cout} dg{dg} "
              f"{'v2' if with_mask else 'v1'}{'' if bias else ' no bias'}",
              lambda: fused_dcn.modulated_deform_conv2d_fused(
                  x, off, mask, wd, bd, deform_groups=dg),
              lambda: modulated_deform_conv2d(x, off, mask, wd, bd,
                                              deform_groups=dg),
              CONV_RTOL, work=work if timed else None,
              beside=("cuDNN plain conv (no offsets, no mask)",
                      lambda: F.conv2d(x.permute(0, 3, 1, 2),
                                       wd.permute(3, 2, 0, 1), bd,
                                       padding=1)))
    del x, off, mask
    return results


def phase_dcn_bwd(torch, dev):
    """The DCN adjoint (K8, one launch a call) against the plain VJP
    (autograd through the plain forward) on the card, at K7's cases.  Each of the five gradients is held to
    DCN_BWD_RTOL of its own max; the timed cases time K8, the plain VJP and,
    beside them, cuDNN's convolution_backward (input, weight and bias
    gradients of the plain conv of the same shapes: not the same function,
    so no library call) in turns.
    Work: x, offsets, mask, weights and g read, the five gradients
    written; 2 flops a multiply-add of both 9 * Cin * Cout contractions
    (g W^T and cols^T g) and 32 a sampled value (the sample, its two
    derivatives, the 4-corner scatter and the re-sample the two-launch
    version took), at the bf16 tensor cores' rate, the float32 pipes'
    beside.  Returns the result-line fields of the first timed case."""
    from fcvsr_tpu_torch.ops import fused_dcn
    from fcvsr_tpu_torch.ops.dcn import modulated_deform_conv2d_vjp
    from fcvsr_tpu_torch.profiling import BF16_FLOP_S, bound, cuda_ms

    rng = np.random.default_rng(7)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    result = {"max_abs_err": 0.0}
    names = ("dx", "doffset", "dmask", "dweight", "dbias")
    for (label, b, h, w, cin, cout, dg, with_mask, timed) in (
            ("EDVR-M l1 serving", 5, 180, 320, 64, 64, 8, True, True),
            ("BasicVSR++ serving", 1, 192, 320, 128, 64, 16, True, True),
            ("EDVR-M l1 training", 20, 64, 64, 64, 64, 8, True, True),
            ("BasicVSR++ training", 1, 64, 64, 128, 64, 16, True, True),
            ("TDAN training, no bias", 16, 64, 64, 64, 64, 8, False, True),
            ("v1", 2, 64, 96, 64, 64, 8, False, False),
            ("odd", 2, 13, 29, 24, 40, 3, True, False),
            ("odd", 1, 5, 7, 8, 70, 1, True, False),
            ("odd", 2, 9, 11, 6, 20, 2, True, False)):
        x = t(rng.standard_normal((b, h, w, cin)))
        off = t(mixed_flows(rng, b, h, w, dg * 18))
        mask = t(1 / (1 + np.exp(-rng.standard_normal((b, h, w, dg * 9))))) \
            if with_mask else None
        wd = t(rng.standard_normal((3, 3, cin, cout)) / np.sqrt(9 * cin))
        bd = None if label.startswith("TDAN") else \
            t(rng.standard_normal(cout) * 0.1)
        g = t(rng.standard_normal((b, h, w, cout)))

        def kern():
            return fused_dcn.modulated_deform_conv2d_fused_vjp(
                x, off, mask, wd, bd, g, deform_groups=dg)

        def plain():
            return modulated_deform_conv2d_vjp(x, off, mask, wd, bd, g, dg)

        def beside():
            return torch.ops.aten.convolution_backward(
                g.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2),
                wd.permute(3, 2, 0, 1), [cout], [1, 1], [1, 1], [1, 1], False,
                [0, 0], 1, [True, True, True])

        got, ref = kern(), plain()
        torch.cuda.synchronize()
        errs, scaled = {}, {}
        for n, a, r in zip(names, got, ref):
            if (a is None) != (r is None):
                fail(f"dcn_bwd {label}: {n} is {a is not None} vs "
                     f"{r is not None}")
            if r is not None:
                errs[n] = float((a - r).abs().max())
                scaled[n] = errs[n] / float(r.abs().max())
        line = dict(kernel="dcn_bwd", case=f"{label} {b}x{h}x{w} {cin}->"
                    f"{cout} dg{dg} {'v2' if with_mask else 'v1'}",
                    max_abs_err=errs, err_over_max=scaled, tol=DCN_BWD_RTOL)
        if timed:
            px = b * h * w
            chans = cin + dg * 18 + (dg * 9 if with_mask else 0)
            work = (4 * (px * (2 * chans + cout) + 2 * 9 * cin * cout
                         + 2 * cout),
                    px * 9 * cin * (4 * cout + 32))
            times = cuda_ms([kern, plain, beside])
            bound_ms, bound_by = bound(*work, BF16_FLOP_S)
            line.update(ms=times[0], plain_ms=times[1], library_ms=None,
                        beside="cuDNN plain conv backward (no offsets, no "
                        "mask)", beside_ms=times[2],
                        bound_ms=bound_ms, bound_by=bound_by,
                        f32_pipes_bound_ms=bound(*work)[0],
                        gflop=work[1] / 1e9, gbytes=work[0] / 1e9)
            if "ms" not in result:
                result.update((k, line[k]) for k in (
                    "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"))
        say("kernels", **line)
        for n, e in scaled.items():
            if not e <= DCN_BWD_RTOL:
                fail(f"dcn_bwd {label}: {n} error {e} of its max > "
                     f"{DCN_BWD_RTOL}")
        result["max_abs_err"] = max(result["max_abs_err"], *errs.values())
        del x, off, mask, g, got, ref
    return result


def phase_conv_grads(torch, dev):
    """The conv autograd Functions' gradients against autograd through the
    plain versions, at SCNet's three levels of a training batch.

    The pair's backward masks its leaky relu by the intermediate that the
    conv3x3 kernel rebuilds; cuDNN's intermediate differs from it by f32
    noise, so the few values within that noise of 0 (~10 of 12.6M at
    6x128x128x128) take the other branch.  The plain reference therefore
    takes its mask from the kernel's intermediate (its values stay cuDNN's),
    and the line reports how many signs differ."""
    from fcvsr_tpu_torch.ops import fused_conv

    rng = np.random.default_rng(3)
    flips = []

    def pair_plain(x, w1, b1, w2, b2, ns1):
        with torch.no_grad():
            pos = fused_conv.conv3x3(x.detach(), w1.detach(),
                                     None if b1 is None else b1.detach(),
                                     act=True, neg_slope=ns1) > 0
        pre = fused_conv.conv3x3_plain(x, w1, b1)
        flips.append(int((pos != (pre > 0)).sum()))
        return fused_conv.conv3x3_plain(torch.where(pos, pre, ns1 * pre), w2,
                                        b2)

    def t(shape, scale=1.0):
        a = rng.standard_normal(shape) * scale
        return torch.from_numpy(a.astype(np.float32)).to(dev).requires_grad_()

    for (h, w) in ((128, 128), (64, 64), (32, 32)):
        x = t((6, h, w, 64))
        w1, b1 = t((3, 3, 64, 128), 0.04), t((128,), 0.1)
        w2, b2 = t((3, 3, 128, 64), 0.03), t((64,), 0.1)
        r1, r2 = t((3, 3, 64, 64), 0.04), t((3, 3, 64, 64), 0.04)
        res = t((6, h, w, 64))
        g = torch.from_numpy(rng.standard_normal((6, h, w, 64))
                             .astype(np.float32)).to(dev)
        cases = [
            ("pair 64->128->64 bias ns0.1", (x, w1, b1, w2, b2),
             lambda: fused_conv.conv3x3_pair(x, w1, b1, w2, b2, 0.1),
             lambda: pair_plain(x, w1, b1, w2, b2, 0.1)),
            ("pair 64->64->64 nobias ns0.2", (x, r1, r2),
             lambda: fused_conv.conv3x3_pair(x, r1, None, r2, None, 0.2),
             lambda: pair_plain(x, r1, None, r2, None, 0.2)),
            ("conv 64->64 +res", (x, r1, b2, res),
             lambda: fused_conv.conv3x3(x, r1, b2, res=res),
             lambda: fused_conv.conv3x3_plain(x, r1, b2, res=res)),
        ]
        for label, ins, kern, plain in cases:
            flips.clear()
            got = torch.autograd.grad(kern(), ins, g)
            ref = torch.autograd.grad(plain(), ins, g)
            torch.cuda.synchronize()
            errs = [float((a - r).abs().max()) for a, r in zip(got, ref)]
            tols = [CONV_RTOL * max(1.0, float(r.abs().max())) for r in ref]
            say("conv_grads", case=f"{label} 6x{h}x{w}", max_abs_err=errs,
                tol=tols, mask_flips=flips[0] if flips else None)
            if not all(e <= tol for e, tol in zip(errs, tols)):
                fail(f"conv gradients {label} {h}x{w}: {errs} > {tols}")


def deviation(got, ref):
    """(whole, median, max) relative deviation of one gradient dict from
    another, and the tensors over GRAD_RTOL."""
    rel, diff2, norm2 = {}, 0.0, 0.0
    for k, r in ref.items():
        g = got[k]
        if (r is None) != (g is None):
            fail(f"gradient of {k}: {r is not None} vs {g is not None}")
        if r is None:
            continue
        d = float((g - r).norm())
        diff2, norm2 = diff2 + d * d, norm2 + float(r.norm()) ** 2
        rel[k] = d / float(r.norm()) if r.any() else d
    over = {k: v for k, v in rel.items() if v > GRAD_RTOL}
    return ((diff2 / norm2) ** 0.5, float(np.median(list(rel.values()))),
            max(rel.values()), over)


def phase_model(torch, dev):
    from fcvsr_tpu_torch.models import FCVSRNet, init_weights

    x = np.random.default_rng(1).uniform(0, 1, (1, 7, 1, 64, 96))
    x = x.astype(np.float32)
    for k_fused in (False, True):
        model = init_weights(FCVSRNet(in_channels=1, k_fused=k_fused),
                             torch.Generator().manual_seed(0)).eval()
        with torch.no_grad():
            ref = model(torch.from_numpy(x)).numpy()
            model.to(dev)
            got = model(torch.from_numpy(x).to(dev)).cpu().numpy()
        err = float(np.abs(got - ref).max())
        say("model", model="FCVSR full Y", k_fused=k_fused,
            shape=list(got.shape), max_abs_err=err, tol=MODEL_ATOL)
        if got.shape != (1, 1, 256, 384) or not np.isfinite(got).all():
            fail(f"model output shape {got.shape} or non-finite values")
        if not err <= MODEL_ATOL:
            fail(f"GPU vs CPU model error {err} > {MODEL_ATOL}")

    # the serving flag sets: the exact ones at MODEL_ATOL, the bf16 ones at
    # the --fast bars; the same weights on both devices
    from fcvsr_tpu_torch import cli

    flag_sets = {"exact flags": dict(batch_mgaa=True, tail_impl="folded",
                                     iac_chain="resident", scnet_fuse="quad"),
                 "fast": cli.serving_flags(True),
                 "fast resident quad": cli.serving_flags(True, "resident",
                                                         "quad")}
    for name, flags in flag_sets.items():
        model = init_weights(FCVSRNet(in_channels=1, **flags),
                             torch.Generator().manual_seed(0)).eval()
        with torch.no_grad():
            ref = model(torch.from_numpy(x)).numpy()
            model.to(dev)
            got = model(torch.from_numpy(x).to(dev)).cpu().numpy()
        d = np.abs(got - ref)
        bf16 = "bf16" in flags.values()
        say("model", model="FCVSR full Y", flags=name, shape=list(got.shape),
            max_abs_err=float(d.max()), mean_abs_err=float(d.mean()),
            tol=[FAST_MAX, FAST_MEAN] if bf16 else MODEL_ATOL)
        if got.shape != (1, 1, 256, 384) or not np.isfinite(got).all():
            fail(f"{name}: model output shape {got.shape} or non-finite")
        if not (d.max() < FAST_MAX and d.mean() < FAST_MEAN if bf16
                else d.max() <= MODEL_ATOL):
            fail(f"{name}: GPU vs CPU model error {d.max()} (mean "
                 f"{d.mean()})")
        del model

    # gradients: one Charbonnier-sum backward on each device
    from fcvsr_tpu_torch.train.losses import charbonnier_sum

    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.uniform(0, 1, (1, 7, 1, 32, 48))
                         .astype(np.float32))
    gt = torch.from_numpy(rng.uniform(0, 1, (1, 1, 128, 192))
                          .astype(np.float32))
    model = init_weights(FCVSRNet(in_channels=1),
                         torch.Generator().manual_seed(0))

    def grads(inp, device):
        model.zero_grad(set_to_none=True)
        model.to(device)
        charbonnier_sum(model(inp.to(device)), gt.to(device)).backward()
        return {k: None if p.grad is None else p.grad.cpu()
                for k, p in model.named_parameters()}

    ref = grads(x, "cpu")
    moved = x * (1 + 1e-6 * torch.from_numpy(
        rng.standard_normal(x.shape).astype(np.float32)))
    floor = deviation(grads(moved, "cpu"), ref)
    whole, median, worst, over = deviation(grads(x, dev), ref)
    say("model_grads", model="FCVSR full Y", shape=[1, 7, 1, 32, 48],
        tensors=sum(g is not None for g in ref.values()),
        whole_rel_err=whole, median_rel_err=median,
        max_rel_err=worst, over_grad_rtol=over, grad_rtol=GRAD_RTOL,
        flip_rtol=FLIP_RTOL, cpu_floor_1e6=dict(
            whole=floor[0], median=floor[1], max=floor[2],
            n_over_grad_rtol=len(floor[3])))
    if not (whole <= GRAD_RTOL and median <= GRAD_RTOL
            and worst <= FLIP_RTOL):
        fail(f"GPU vs CPU gradients beyond the bounds: whole {whole}, "
             f"median {median}, over {over}")


def zoo_model(torch, name: str):
    """A zoo model at mmedit's published widths, seeded weights, every DCN's
    last offset conv drawn non-zero (it is zero-initialised, which would
    leave the DCN a plain conv): offsets +-3 px about zero (EDVR, IconVSR's
    refill, TDAN), BasicVSR++'s residues 10 * tanh(+-1.5) about the
    flows.  IconVSR's keyframes every ICON_STRIDE frames."""
    from fcvsr_tpu_torch.models import BACKBONES, build, init_weights
    from fcvsr_tpu_torch.models.basicvsr import ModulatedDeformConv2d

    kw = dict(keyframe_stride=ICON_STRIDE) if name == "IconVSR" else {}
    model = init_weights(build(BACKBONES, dict(type=name, **kw)),
                         torch.Generator().manual_seed(0)).eval()
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, ModulatedDeformConv2d):
                last = [m for m in mod.conv_offset.modules()
                        if isinstance(m, torch.nn.Conv2d)][-1]
                last.weight.normal_(0, 0.3 / math.sqrt(last.weight[0].numel()),
                                    generator=gen)
                last.bias.normal_(0, 1.5 if name == "BasicVSRPlusPlus"
                                  else 3.0, generator=gen)
    return model


def zoo_sr(out):
    """The SR of a zoo forward: TDAN returns (SR centre, aligned LRs)."""
    return out[0] if isinstance(out, tuple) else out


def ltam_choices(model, record: list):
    """A forward hook on ``model.LTAM``: each call appends its tracked
    locations and keyframe picks, on the host, to ``record``."""
    import torch

    def hook(mod, args, out):
        cur, idx, _, _, loc = args
        with torch.no_grad():
            pick = mod.scores(cur, idx, loc).argmax(1)
        record.append((loc.cpu().numpy(), pick.cpu().numpy()))

    return model.LTAM.register_forward_hook(hook)


def compare_choices(ref: list, got: list) -> dict:
    """LTAM's discrete choices on two devices, call by call: the tracked
    locations that differ, and over the calls with 2 or more keyframes the
    picks, those that differ and the keyframes picked."""
    if len(ref) != len(got) or not ref:
        fail(f"LTAM calls: {len(ref)} against {len(got)}")
    n = flipped = moved = most = 0
    picked = set()
    for (rl, rp), (gl, gp) in zip(ref, got):
        moved += int(np.any(rl != gl, -1).sum())
        most = max(most, rl.shape[1])
        if rl.shape[1] > 1:
            n += rp.size
            flipped += int((rp != gp).sum())
            picked |= set(np.unique(rp).tolist())
    return dict(calls=len(ref), most_keyframes=most,
                picks_over_2_keyframes=n, flipped_picks=flipped,
                moved_locations=moved, keyframes_picked=sorted(picked))


def phase_zoo_models(torch, dev):
    """The zoo at full width, the GPU (the DCN kernel) against the same
    model on the CPU (the plain DCN), with the launches per forward (TDAN:
    both of its outputs); no other kernel of the port launched.  FTVSR's
    and TTVSR's LTAM choices (tracked locations, keyframe picks) are
    compared call by call, and must agree."""
    from fcvsr_tpu_torch.ops import launch_counts, reset_launch_counts

    for name in ZOO:
        shape = ZOO_CHECK.get(name, (1, 5, 3, 64, 96))
        x = torch.from_numpy(np.random.default_rng(5).uniform(0, 1, shape)
                             .astype(np.float32))
        model = zoo_model(torch, name)
        records = ([], [])
        hooks = name in RECURRENT_PLAIN
        with torch.no_grad():
            hook = hooks and ltam_choices(model, records[0])
            ref = model(x)
            model.to(dev)
            if hooks:
                hook.remove()
                hook = ltam_choices(model, records[1])
            reset_launch_counts()
            got = model(x.to(dev))
            counts = launch_counts()
            launches = counts.pop("dcn")
            if hooks:
                hook.remove()
        pairs = list(zip(got, ref)) if isinstance(ref, tuple) \
            else [(got, ref)]
        err = max(float((g.cpu() - r).abs().max()) for g, r in pairs)
        out_shape = list(zoo_sr(got).shape)
        choices = compare_choices(*records) if hooks else None
        say("model", model=name, input=list(shape), shape=out_shape,
            max_abs_err=err, tol=MODEL_ATOL, dcn_launches=launches,
            **({"ltam_choices": choices} if hooks else {}))
        if hooks and (choices["flipped_picks"] or choices["moved_locations"]
                      or choices["most_keyframes"] < 3
                      or len(choices["keyframes_picked"]) < 2):
            fail(f"{name}: LTAM's choices on the card and the CPU "
                 f"{choices}: flipped or moved, or no choice between "
                 "keyframes")
        if not all(torch.isfinite(g).all() and g.shape == r.shape
                   for g, r in pairs):
            fail(f"{name}: output shape {out_shape} or non-finite values")
        if not err <= MODEL_ATOL:
            fail(f"{name}: GPU vs CPU model error {err} > {MODEL_ATOL}")
        if launches != dcn_per_forward(name, shape[1]) or any(
                counts.values()):
            fail(f"{name}: {launches} DCN launches a forward, expected "
                 f"{dcn_per_forward(name, shape[1])}, and no other kernel: "
                 f"{counts}")
        del model


def smooth_clip(torch, seed: int, n: int, h: int, w: int) -> np.ndarray:
    """A smooth random RGB clip (n, h, w, 3) in [0, 1]: each frame a
    bilinear upsampling of a coarse grid, drifting a little from frame to
    frame."""
    rng = np.random.default_rng(seed)
    coarse = rng.uniform(0, 1, (1, 3, h // 8 + 1, w // 8 + 1))
    frames = []
    for i in range(n):
        c = torch.nn.functional.interpolate(
            torch.from_numpy(np.roll(coarse, i, axis=-1)), size=(h, w),
            mode="bilinear", align_corners=False)
        frames.append(c[0].permute(1, 2, 0).numpy())
    return np.stack(frames).astype(np.float32)


# the zoo's serving shapes: (h, w) and the window (0: the whole clip in
# one recurrent forward)
ZOO_SERVE = {"EDVRNet": ((180, 320), 5), "BasicVSRPlusPlus": ((192, 320), 0),
             "BasicVSRNet": ((192, 320), 0), "IconVSR": ((192, 320), 0),
             "TDANNet": ((180, 320), 5), "FTVSRNet": ((192, 320), 0),
             "TTVSRNet": ((192, 320), 0)}


def serve_windows(torch, model, frames: np.ndarray, window: int):
    """TDAN's serving: each frame the SR centre of its ``window`` frames
    (replicate-padded at the clip's ends), one forward a frame; its
    forward's pair is what ``apis.restoration_video_inference`` does not
    take."""
    from fcvsr_tpu_torch.data.pipelines import padded_window_indices

    t = frames.shape[0]
    outs = []
    with torch.no_grad():
        for i in range(t):
            idx = padded_window_indices(i, t, window)
            x = torch.from_numpy(np.ascontiguousarray(np.transpose(
                frames[idx], (0, 3, 1, 2))[None])).to("cuda")
            outs.append(zoo_sr(model(x))[0].permute(1, 2, 0).cpu().numpy())
    return np.stack(outs)


def phase_zoo(torch, card):
    """Zoo serving: a synthetic 10-frame RGB clip restored by each zoo
    model, through ``apis.restoration_video_inference`` (EDVR-M in 5-frame
    windows; BasicVSR++, BasicVSR, IconVSR, FTVSR and TTVSR the whole clip)
    or its own forward a window (TDAN), then ms per restored frame, and
    FTVSR's and TTVSR's stages."""
    from fcvsr_tpu_torch import apis, cli, profiling
    from fcvsr_tpu_torch.ops import launch_counts, reset_launch_counts

    counts = {}
    for name in ZOO:
        (h, w), window = ZOO_SERVE[name]
        model = zoo_model(torch, name).to("cuda")
        frames = smooth_clip(torch, 6, ZOO_T, h, w)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        if name == "TDANNet":
            out = serve_windows(torch, model, frames, window)
        else:
            out = apis.restoration_video_inference(model, frames,
                                                   window_size=window)
        torch.cuda.synchronize()
        counts[name] = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        forwards = ZOO_T if window else 1
        t = window or ZOO_T
        per_forward = counts[name]["dcn"] / forwards
        with torch.no_grad():
            fps = cli.fps_benchmark(model, h, w, c=3, t=t,
                                    frames_per_forward=1 if window else t,
                                    n_iter=10 if window else 5)
        fps["fps_max_memory_allocated"] = fps.pop("max_memory_allocated")
        say("zoo", model=name, clip=[ZOO_T, h, w, 3], window=window,
            out_shape=list(out.shape), forwards=forwards,
            dcn_launches_per_forward=per_forward, launches=counts[name],
            max_memory_allocated=peak, card=card, **fps)
        if out.shape != (ZOO_T, 4 * h, 4 * w, 3) or not np.isfinite(out).all():
            fail(f"{name}: output {out.shape} or non-finite values")
        if per_forward != dcn_per_forward(name, t):
            fail(f"{name}: {per_forward} DCN launches a forward, expected "
                 f"{dcn_per_forward(name, t)}")
        if any(v for k, v in counts[name].items() if k != "dcn"):
            fail(f"{name}: FCVSR kernels launched on the zoo path "
                 f"{counts[name]}")
        if not fps["ms_per_frame"] > 0:
            fail(f"{name}: bad timing {fps}")
        if name in RECURRENT_PLAIN:
            x = torch.from_numpy(np.ascontiguousarray(np.transpose(
                frames, (0, 3, 1, 2))[None])).to("cuda")
            stages = profiling.stage_times(model, x, reps=3, warmup=1,
                                           stages=profiling.FTVSR_STAGES)
            say("zoo_stages", model=name, clip=[ZOO_T, h, w, 3], reps=3,
                stages_ms=stages,
                stages_ms_per_frame={k: v / ZOO_T for k, v in stages.items()},
                card=card)
            del x
        del model
    return {k: sum(c[k] for c in counts.values())
            for k in next(iter(counts.values()))}


def zoo_loss(torch, model, name: str, lq, gt):
    """The zoo's training loss, Charbonnier-mean: ``VideoRestorer.loss_fn``
    (EDVR on the centre frame of a 5-D GT), or for TDAN, which the
    restorer does not take, its SR centre frame against the GT's."""
    from fcvsr_tpu_torch.models import VideoRestorer
    from fcvsr_tpu_torch.train.losses import LOSSES

    if name == "TDANNet":
        if gt.ndim == 5:
            gt = gt[:, gt.shape[1] // 2]
        return LOSSES["charbonnier_mean"](zoo_sr(model(lq)), gt)
    return VideoRestorer(model, center_frame_only=name == "EDVRNet") \
        .loss_fn(lq, gt)[0]


def phase_zoo_grads(torch, dev):
    """The DCN models of the zoo at full width, their training loss's
    gradients on the card (K7 forward, K8 backward) against the CPU (plain
    versions), per parameter tensor, beside the CPU's own floor (the same
    step with the input moved by 1e-6 of itself); then FTVSR and TTVSR,
    every frame's loss, no kernel launched, each tensor but SPyNet's
    within GRAD_RTOL."""
    from fcvsr_tpu_torch.ops import launch_counts, reset_launch_counts

    for name in ZOO_GRADS:
        rng = np.random.default_rng(8)
        shape = ZOO_CHECK.get(name, (1, 5, 3, 64, 64))
        x = torch.from_numpy(rng.uniform(0, 1, shape).astype(np.float32))
        gt = torch.from_numpy(rng.uniform(0, 1, shape[:3] + (256, 256))
                              .astype(np.float32))
        moved = x * (1 + 1e-6 * torch.from_numpy(
            rng.standard_normal(x.shape).astype(np.float32)))
        model = zoo_model(torch, name).train()

        def grads(inp, device):
            model.zero_grad(set_to_none=True)
            model.to(device)
            zoo_loss(torch, model, name, inp.to(device),
                     gt.to(device)).backward()
            return {k: None if p.grad is None else p.grad.cpu()
                    for k, p in model.named_parameters()}

        ref = grads(x, "cpu")
        cpu_moved = grads(moved, "cpu")
        reset_launch_counts()
        got = grads(x, dev)
        counts = launch_counts()
        # the tensors whose gradient is 0 in exact arithmetic, apart
        norm = sum(float(r.norm()) ** 2 for r in ref.values()
                   if r is not None) ** 0.5
        zero = {k: max(float(d[k].norm()) for d in (ref, cpu_moved, got))
                / norm for k in ZERO_GRAD.get(name, ())}
        for d in (ref, cpu_moved, got):
            for k in zero:
                d.pop(k)
        floor = deviation(cpu_moved, ref)
        whole, median, worst, over = deviation(got, ref)
        say("zoo_grads", model=name, shape=list(x.shape),
            tensors=sum(g is not None for g in ref.values()),
            whole_rel_err=whole, median_rel_err=median, max_rel_err=worst,
            over_grad_rtol=over, grad_rtol=GRAD_RTOL, flip_rtol=FLIP_RTOL,
            cpu_floor_1e6=dict(whole=floor[0], median=floor[1],
                               max=floor[2], over_grad_rtol=floor[3]),
            zero_grads=zero, zero_grad_rtol=ZERO_GRAD_RTOL, launches=counts)
        want = dcn_per_forward(name, shape[1])
        if counts != {k: want if k in ("dcn", "dcn_bwd") else 0
                      for k in counts}:
            fail(f"{name}: launches {counts}, expected {want} DCN forward "
                 f"and {want} adjoint and no other kernel")
        if any(v > ZERO_GRAD_RTOL for v in zero.values()):
            fail(f"{name}: gradients that are 0 in exact arithmetic: {zero}")
        if not (whole <= GRAD_RTOL and median <= GRAD_RTOL
                and worst <= FLIP_RTOL):
            fail(f"{name}: GPU vs CPU gradients beyond the bounds: whole "
                 f"{whole}, median {median}, over {over}")
        if name in RECURRENT_PLAIN and any(not k.startswith("spynet.")
                                           for k in over):
            fail(f"{name}: tensors other than SPyNet's over {GRAD_RTOL}: "
                 f"{over}")
        del model


# the CVCP compressed-VSR family at its JAX-default (full) widths
CVCP = {"SIDECVSR": dict(nf=64, sc_groups=4),
        "FCVSRTFDCNet": dict(n_feats=64, sc_groups=3),
        "RAFT": dict(iters=12)}
CVCP_CHECK = (64, 96)       # card against CPU: 1 x 7 x 1 x 64 x 96, a pair
CVCP_CLIP = (10, 272, 480)  # the CVCP eval's padded LR size, Y
RAFT_PAIR = (436, 1024)     # Sintel's frame size
CVCP_REPS = 3
CVCP_MV_PX = 3.0            # the MVs' amplitude; x32 in the STN: clamped


def cvcp_model(torch, name: str):
    """A CVCP-family model at full width, seeded weights, every CAB2's
    ``beta`` and every batch norm's running statistics drawn non-zero (at
    init they are 0 and 0 / 1, which would leave CAB2 the identity and the
    batch norms an affine map)."""
    from fcvsr_tpu_torch.models import BACKBONES, build, init_weights
    from fcvsr_tpu_torch.models.blocks_ext import CAB2

    model = init_weights(build(BACKBONES, dict(type=name, **CVCP[name])),
                         torch.Generator().manual_seed(0)).eval()
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, CAB2):
                mod.beta.uniform_(-0.5, 0.5, generator=gen)
            elif isinstance(mod, torch.nn.BatchNorm2d):
                mod.running_mean.uniform_(-0.2, 0.2, generator=gen)
                mod.running_var.uniform_(0.5, 1.5, generator=gen)
    return model


def side_window_inputs(torch, seed: int, t: int, h: int, w: int):
    """A synthetic Y clip with side information, (1, t, c, h, w) each:
    smooth frames, smooth MVs of up to CVCP_MV_PX px (the STN's x32 takes
    most of them to its clamp, some stay inside), and the partition map,
    residue and unfiltered prediction in [0, 1]."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)

    def smooth(n, amp, off):
        a, b, c = rng.uniform(0.02, 0.2, (3, n, 1, 1))
        return off + amp * np.sin(a * xx + b * yy + 6 * c)

    y = smooth(t, 0.4, 0.5)[:, None]
    mvs = np.stack([smooth(t, CVCP_MV_PX, 0), smooth(t, CVCP_MV_PX, 0)], 1)
    side = [smooth(t, 0.5, 0.5)[:, None] for _ in range(3)]
    return [torch.from_numpy(np.asarray(v, np.float32)[None])
            for v in [y, mvs] + side]


def raft_images(torch, seed: int, h: int, w: int):
    """Two smooth RGB images in [0, 1], (1, h, w, 3), the second the first
    moved by about (3.0, 1.5) px."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    waves = rng.uniform(0.02, 0.3, (8, 3))
    imgs = []
    for dx, dy in ((0.0, 0.0), (3.0, 1.5)):
        v = sum(np.sin(a * (xx - dx) + b * (yy - dy) + 6 * c)
                for a, b, c in waves)
        v = (v - v.min()) / (v.max() - v.min())
        imgs.append(torch.from_numpy(np.repeat(v[..., None], 3, -1)[None]
                                     .astype(np.float32)))
    return imgs


def cvcp_forward(name, model, inputs):
    """The model's outputs as a list: SIDECVSR (SR, L1), RAFT the flow of
    ``raft_flow`` at the inputs' size, FCVSR-TFDC the SR."""
    from fcvsr_tpu_torch.models import raft_flow

    if name == "RAFT":
        return [raft_flow(model, *inputs)]
    out = model(*inputs)
    return list(out) if isinstance(out, tuple) else [out]


def cvcp_profile(profiling, name: str, model, *inputs) -> None:
    """One window's forward under ``torch.profiler``: its device busy ms,
    idle share and the kernels that take the most device time."""
    prof = profiling.device_profile(model, *inputs, n=1)
    say("cvcp_profile", model=name, wall_ms=prof["wall_ms"],
        busy_ms=prof["busy_ms"], idle_share=prof["idle_share"],
        top_kernels=prof["kernels"][:8])


def phase_cvcp_zoo(torch, card):
    """The CVCP family at full width: (a) each model on the card against
    the same model on the CPU (SIDECVSR with smooth MVs that reach the
    STN's clamp, FCVSR-TFDC, RAFT through ``raft_flow`` on a 64 x 96 pair)
    within MODEL_ATOL; (b) no kernel of the port launched; (c) on the card
    only, warm, CUDA events, the median of CVCP_REPS: FCVSR-TFDC through
    ``sliding_window_sr`` over a 10-frame 272 x 480 Y clip, SIDECVSR window
    by window over the same clip with synthetic side information, and
    ``raft_flow`` on a Sintel-sized pair; ms a frame (a pair), the peak,
    and one window's device profile of the two SR models."""
    from fcvsr_tpu_torch import profiling
    from fcvsr_tpu_torch.data.pipelines import padded_window_indices
    from fcvsr_tpu_torch.models import raft_flow, sliding_window_sr
    from fcvsr_tpu_torch.ops import launch_counts, reset_launch_counts

    dev = torch.device("cuda", 0)
    reset_launch_counts()
    h, w = CVCP_CHECK
    check_inputs = {
        "SIDECVSR": side_window_inputs(torch, 11, 7, h, w),
        "FCVSRTFDCNet": [torch.from_numpy(np.random.default_rng(12).uniform(
            0, 1, (1, 7, 1, h, w)).astype(np.float32))],
        "RAFT": raft_images(torch, 13, h, w)}
    for name in CVCP:
        model = cvcp_model(torch, name)
        inputs = check_inputs[name]
        with torch.no_grad():
            ref = cvcp_forward(name, model, inputs)
            got = cvcp_forward(name, model.to(dev),
                               [v.to(dev) for v in inputs])
        errs = [float((g.cpu() - r).abs().max()) for g, r in zip(got, ref)]
        scale = [float(r.abs().max()) for r in ref]
        say("cvcp_model", model=name, config=CVCP[name],
            input=[list(v.shape) for v in inputs],
            shapes=[list(g.shape) for g in got], max_abs_err=errs,
            max_abs_out=scale, rel_err=[e / s for e, s in zip(errs, scale)],
            tol=MODEL_ATOL)
        if not all(torch.isfinite(g).all() and g.shape == r.shape
                   for g, r in zip(got, ref)):
            fail(f"{name}: output shapes {[g.shape for g in got]} or "
                 "non-finite values")
        if not max(errs) <= MODEL_ATOL:
            fail(f"{name}: GPU vs CPU model error {errs} > {MODEL_ATOL}")
        del model, got

    t, hh, ww = CVCP_CLIP
    clip = smooth_clip(torch, 14, t, hh, ww)[..., :1]
    # FCVSR-TFDC: the sliding-window eval (its default 8 windows a forward)
    model = cvcp_model(torch, "FCVSRTFDCNet").to(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out = {}

    def tfdc_clip():
        out["sr"] = sliding_window_sr(model, clip, device=dev)

    (ms,) = profiling.cuda_ms([tfdc_clip], reps=CVCP_REPS, warmup=1)
    peak = torch.cuda.max_memory_allocated()
    say("cvcp_serve", model="FCVSRTFDCNet", entry="sliding_window_sr",
        clip=[t, hh, ww, 1], reps=CVCP_REPS, ms_per_clip=ms,
        ms_per_frame=ms / t, max_memory_allocated=peak, card=card)
    with torch.no_grad():
        cvcp_profile(profiling, "FCVSRTFDCNet", model, torch.from_numpy(
            np.ascontiguousarray(np.transpose(clip[:7], (0, 3, 1, 2))[None]))
            .to(dev))
    if out["sr"].shape != (t, 4 * hh, 4 * ww, 1) or not np.isfinite(
            out["sr"]).all():
        fail(f"FCVSR-TFDC: sliding_window_sr gave {out['sr'].shape} or "
             "non-finite values")
    del model, out

    # SIDECVSR: a forward a window, the side information on the card
    model = cvcp_model(torch, "SIDECVSR").to(dev)
    side = [v.to(dev) for v in side_window_inputs(torch, 15, t, hh, ww)]
    side[0] = torch.from_numpy(np.ascontiguousarray(np.transpose(
        clip, (0, 3, 1, 2))[None])).to(dev)
    windows = [padded_window_indices(i, t, 7) for i in range(t)]
    srs = []

    def side_clip():
        srs.clear()
        with torch.no_grad():
            for idx in windows:
                srs.append(model(*[v[:, idx] for v in side])[0])

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    (ms,) = profiling.cuda_ms([side_clip], reps=CVCP_REPS, warmup=1)
    peak = torch.cuda.max_memory_allocated()
    say("cvcp_serve", model="SIDECVSR", entry="forward a window",
        clip=[t, hh, ww, 1], reps=CVCP_REPS, ms_per_clip=ms,
        ms_per_frame=ms / t, max_memory_allocated=peak, card=card)
    if len(srs) != t or any(s.shape != (1, 1, 4 * hh, 4 * ww)
                            or not torch.isfinite(s).all() for s in srs):
        fail("SIDECVSR: window outputs of the wrong shape or non-finite")
    with torch.no_grad():
        cvcp_profile(profiling, "SIDECVSR", model,
                     *[v[:, windows[t // 2]] for v in side])
    del model, side, srs

    # RAFT: raft_flow on a Sintel-sized pair (436 -> 440 and back)
    model = cvcp_model(torch, "RAFT").to(dev)
    pair = [v.to(dev) for v in raft_images(torch, 16, *RAFT_PAIR)]
    flow = {}

    def raft_pair():
        with torch.no_grad():
            flow["f"] = raft_flow(model, *pair)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    (ms,) = profiling.cuda_ms([raft_pair], reps=CVCP_REPS, warmup=1)
    peak = torch.cuda.max_memory_allocated()
    say("cvcp_serve", model="RAFT", entry="raft_flow", iters=12,
        pair=list(RAFT_PAIR), reps=CVCP_REPS, ms_per_pair=ms,
        max_memory_allocated=peak, card=card)
    if flow["f"].shape != (1, *RAFT_PAIR, 2) or not torch.isfinite(
            flow["f"]).all():
        fail(f"RAFT: raft_flow gave {tuple(flow['f'].shape)} or non-finite "
             "values")
    del model, pair, flow

    counts = launch_counts()
    say("cvcp_launches", launches=counts)
    if any(counts.values()):
        fail(f"a kernel of the port launched on the CVCP path: {counts}")


# the single-image zoo, TOFlow, LIIF and TTSR at the JAX defaults (the
# published x4 widths, not cut); sizes (H, W) of the LR (TOFlow: its HR
# frames, 7 of them)
SISR_ZOO = ("EDSR", "SRCNN", "MSRResNet", "RRDBNet", "RDN", "TOFlow",
            "LIIFEDSR", "LIIFRDN", "TTSR")
SISR_CHECK = {"TOFlow": (64, 96)}   # card against CPU; the rest LR 24 x 32
SISR_SERVE = {"TOFlow": (256, 448),  # a Vimeo-90K septuplet
              "LIIFEDSR": (128, 128), "LIIFRDN": (128, 128),
              "TTSR": (80, 120)}      # CUFED-sized: 320 x 480 reference
SISR_LR = (339, 510)     # a DIV2K validation image's x4 LR (2040 x 1356 out)
SISR_REPS = 3
# the two heaviest forwards, and TOFlow, the one furthest under the convs'
# rate (5.0 TFLOP/s on an H100 at 700 W, against 20-27 for the others)
SISR_PROFILE = ("RDN", "RRDBNet", "TOFlow")


def sisr_inputs(torch, name: str, hw, seed: int, device="cpu"):
    """A model's inputs at LR size ``hw``: an image (1, 3, h, w) in [0, 1],
    smooth; TOFlow 7 smooth frames (1, 7, 3, h, w); LIIF the image and
    every pixel of its x4 grid as queries (coordinates and cells); TTSR
    a random LR and a random x4 reference (noise: its relevances have no
    near-ties for the card's and the CPU's rounding to split)."""
    from fcvsr_tpu_torch.models.liif import make_coord

    h, w = hw
    if name == "TOFlow":
        clip = smooth_clip(torch, seed, 7, h, w)
        return [torch.from_numpy(np.ascontiguousarray(
            clip.transpose(0, 3, 1, 2))[None]).to(device)]
    if name == "TTSR":
        rng = np.random.default_rng(seed)
        return [torch.from_numpy(rng.uniform(0, 1, shape).astype(
            np.float32)).to(device) for shape in ((1, 3, h, w),
                                                  (1, 3, 4 * h, 4 * w))]
    img = torch.from_numpy(np.ascontiguousarray(
        smooth_clip(torch, seed, 1, h, w).transpose(0, 3, 1, 2))).to(device)
    if not name.startswith("LIIF"):
        return [img]
    coord = make_coord((4 * h, 4 * w), device=device)[None]
    cell = torch.tensor([2.0 / (4 * h), 2.0 / (4 * w)],
                        device=device).expand_as(coord).contiguous()
    return [img, coord, cell]


def sisr_model(torch, name: str, device="cpu"):
    from fcvsr_tpu_torch.models import BACKBONES, build, init_weights

    return init_weights(build(BACKBONES, dict(type=name)),
                        torch.Generator().manual_seed(0)).eval().to(device)


def sisr_flops(torch, name: str, hw) -> float:
    """The model's forward flops at LR size ``hw``, counted by
    ``torch.utils.flop_counter`` on the meta device (no data, no time)."""
    from torch.utils.flop_counter import FlopCounterMode

    from fcvsr_tpu_torch.models import BACKBONES, build

    with torch.device("meta"):
        model = build(BACKBONES, dict(type=name)).eval()
    inputs = sisr_inputs(torch, name, hw, 0, "cpu")
    inputs = [torch.empty(v.shape, device="meta") for v in inputs]
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model(*inputs)
    return float(counter.get_total_flops())


def phase_sisr_zoo(torch, card):
    """The single-image zoo (EDSR, SRCNN, MSRResNet, RRDBNet, RDN), TOFlow,
    LIIF-EDSR, LIIF-RDN and TTSR at their published widths: (a) each on
    the card against the same model on the CPU within MODEL_ATOL (LR 24 x
    32; TOFlow 7 x 64 x 96; LIIF queried at every pixel of the x4 grid;
    TTSR against a 96 x 128 reference, its hard-attention picks on both
    devices counted); (b) on the card only, ``build(BACKBONES, cfg)`` and a
    forward under ``no_grad``, warm, CUDA events, the median of SISR_REPS:
    the SISR models on a 510 x 339 LR (2040 x 1356 out), TOFlow on a
    Vimeo-90K septuplet, LIIF on a 128 x 128 LR at all 262 144 queries of
    its x4 grid, TTSR 80 x 120 against 320 x 480: ms a frame, the flops
    (meta-device count) and their rate, the peak; (c) the device profile
    of RDN's, RRDBNet's and TOFlow's forwards; (d) no kernel of the port
    launched."""
    from fcvsr_tpu_torch import profiling
    from fcvsr_tpu_torch.ops import launch_counts, reset_launch_counts

    dev = torch.device("cuda", 0)
    reset_launch_counts()
    for i, name in enumerate(SISR_ZOO):
        model = sisr_model(torch, name)
        hw = SISR_CHECK.get(name, (24, 32))
        inputs = sisr_inputs(torch, name, hw, 20 + i)
        with torch.no_grad():
            ref = model(*inputs)
            got = model.to(dev)(*[v.to(dev) for v in inputs])
            extra = {}
            if name == "TTSR":
                on_card = model.search(*[v.to(dev) for v in inputs])[3]
                on_cpu = model.to("cpu").search(*inputs)[3]
                extra = dict(picks=on_cpu.numel(), picks_differ=int(
                    (on_card.cpu() != on_cpu).sum()))
        err = float((got.cpu() - ref).abs().max())
        say("sisr_model", model=name, input=[list(v.shape) for v in inputs],
            shape=list(got.shape), max_abs_err=err,
            max_abs_out=float(ref.abs().max()), tol=MODEL_ATOL, **extra)
        if got.shape != ref.shape or not torch.isfinite(got).all():
            fail(f"{name}: output shape {tuple(got.shape)} or non-finite "
                 "values")
        if not err <= MODEL_ATOL:
            fail(f"{name}: GPU vs CPU model error {err} > {MODEL_ATOL}")
        del model, got

    for i, name in enumerate(SISR_ZOO):
        hw = SISR_SERVE.get(name, SISR_LR)
        flops = sisr_flops(torch, name, hw)
        model = sisr_model(torch, name, dev)
        inputs = sisr_inputs(torch, name, hw, 40 + i, dev)
        out = {}

        def forward():
            with torch.no_grad():
                out["y"] = model(*inputs)

        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        (ms,) = profiling.cuda_ms([forward], reps=SISR_REPS, warmup=1)
        peak = torch.cuda.max_memory_allocated()
        say("sisr_serve", model=name, input=[list(v.shape) for v in inputs],
            output=list(out["y"].shape), reps=SISR_REPS, ms_per_frame=ms,
            tflop=flops / 1e12, tflops_per_s=flops / ms / 1e9,
            max_memory_allocated=peak, card=card)
        if not torch.isfinite(out["y"]).all():
            fail(f"{name}: non-finite values at the serving size")
        if name in SISR_PROFILE:
            with torch.no_grad():
                prof = profiling.device_profile(model, *inputs, n=1)
            say("sisr_profile", model=name, wall_ms=prof["wall_ms"],
                busy_ms=prof["busy_ms"], idle_share=prof["idle_share"],
                top_kernels=prof["kernels"][:8])
        del model, inputs, out

    counts = launch_counts()
    say("sisr_launches", launches=counts)
    if any(counts.values()):
        fail(f"a kernel of the port launched on the SISR path: {counts}")


# the block library (models/blocks_ext.py) at FCVSR's width, n_feats 64,
# on FCVSR's feature map at the FPS shape; card against CPU at LIB_CHECK
LIB_NF = 64
LIB_SHAPE = (272, 480)
LIB_CHECK = (64, 96)
LIB_FRAMES = 7          # the shift encoders' clip: its frames are the batch
LIB_BANDS = 3           # MultiFreqAgg's K
LIB_RES_BLOCKS = 30
LIB_TRAIN_BATCH = 2     # SpaFreqBlock's training step
LIB_LR = 1e-2
LIB_REPS = 5
# profiled: TFRUNet (61 ms on an H100 at 700 W, its widths 76 and 88,
# against 8 ms for CABEncoder -> CABDecoder at 64, 96 and 128 with twice
# its flops) and the shift encoder over its 7 frames
LIB_PROFILE = ("TFRUNet", "EncoderShiftBlock")
LPIPS_PAIR = (2, 3, 256, 256)
LOADER_CLIP = (10, 270, 480)   # a 10-frame RGB clip at FCVSR's LR size
LOADER_REPS = 3


def library_blocks(torch):
    """name -> (the block on the CPU in eval mode, seeded by
    ``init_weights``, every CAB1's and CAB2's ``beta`` drawn non-zero,
    the batch, the input channels, the number of inputs)."""
    from fcvsr_tpu_torch.models import blocks_ext as B
    from fcvsr_tpu_torch.models import init_weights

    n = LIB_NF
    blocks = {
        "FSAS": (B.FSAS(n), 1, n, 1),
        "FSAS_freq": (B.FSAS_freq(n, 8 * (n // 16)), 1, n + 8 * (n // 16), 1),
        "FFTSpatialModule": (B.FFTSpatialModule(n), 1, n, 1),
        "MultiFreqAgg": (B.MultiFreqAgg(n, LIB_BANDS), 1, n, LIB_BANDS),
        "EncoderShiftBlock": (B.EncoderShiftBlock(n), LIB_FRAMES, n, 1),
        "TFRUNet": (B.TFRUNet(n), 1, n, 1),
        "Encoder2": (B.Encoder2(72, n), LIB_FRAMES, 72, 1),
        "CABEncoder+CABDecoder": (torch.nn.Sequential(
            B.CABEncoder(n), B.CABDecoder(n)), 1, n, 1),
        "ResidualBlocksWithInputConv": (B.ResidualBlocksWithInputConv(
            n, n, LIB_RES_BLOCKS), 1, n, 1),
    }
    gen = torch.Generator().manual_seed(0)
    beta = torch.Generator().manual_seed(1)
    for model, *_ in blocks.values():
        init_weights(model, gen).eval()
        with torch.no_grad():
            for m in model.modules():
                if isinstance(m, (B.CAB1, B.CAB2)):
                    m.beta.uniform_(-0.5, 0.5, generator=beta)
    return blocks


def library_inputs(torch, seed: int, b: int, h: int, w: int, c: int,
                   k: int, device="cpu"):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.uniform(-1, 1, (b, h, w, c)).astype(
        np.float32)).to(device) for _ in range(k)]


def library_call(name, model, inputs):
    """The block's outputs as a list (MultiFreqAgg takes its bands as one
    list)."""
    out = model(inputs) if name == "MultiFreqAgg" else model(*inputs)
    return list(out) if isinstance(out, (list, tuple)) else [out]


def spafreq_step(torch, model, opt, x):
    """One training step of a ``SpaFreqBlock(train=True)``: the output's
    mean square as the loss, SGD; returns the output."""
    opt.zero_grad(set_to_none=True)
    out = model(x)
    out.square().mean().backward()
    opt.step()
    return out


def spafreq_state(model) -> dict:
    return {k: v.detach().float().cpu() for k, v in model.state_dict().items()
            if not k.endswith("num_batches_tracked")}


def write_synthetic_metric_models(root: str):
    """(NIQE's pristine-model .mat, NRQM's model .mat) of the released
    layouts, with random values: mu (1, 36) and an SPD cov (36, 36); a
    linear blend and three random forests (18, 45 and 75 features) of
    perfect binary trees, MATLAB's 1-based layout."""
    import scipy.io

    rng = np.random.default_rng(30)
    a = rng.normal(size=(36, 36))
    niqe = os.path.join(root, "niqe_modelparameters.mat")
    scipy.io.savemat(niqe, {"mu_prisparam": rng.uniform(0, 2, (1, 36)),
                            "cov_prisparam": a @ a.T / 36 + np.eye(36)})
    cells = np.empty((1, 3), object)
    nodes, trees = 15, 8
    for i, n_feat in enumerate((18, 45, 75)):
        ldau = np.zeros((nodes, trees), np.int64)
        rdau = np.zeros((nodes, trees), np.int64)
        for j in range(nodes // 2):
            ldau[j], rdau[j] = 2 * j + 2, 2 * j + 3
        rec = np.zeros((1, 1), dtype=[(f, object) for f in (
            "ldau", "rdau", "x2", "x3", "threshold", "pred", "attr")])
        rec[0, 0] = (ldau, rdau, np.zeros(1), np.zeros(1),
                     rng.normal(size=(nodes, trees)),
                     rng.normal(size=(nodes, trees)),
                     rng.integers(1, n_feat + 1, size=(nodes, trees)))
        cells[0, i] = rec
    model = np.zeros((1, 1), dtype=[("linear", object), ("rf", object)])
    model[0, 0] = (np.array([[0.5], [1.0], [-1.0], [2.0]]), cells)
    nrqm = os.path.join(root, "NRQM_model.mat")
    scipy.io.savemat(nrqm, {"model": model})
    return niqe, nrqm


def library_loader(torch, root: str) -> np.ndarray:
    """The native PNG decoder: built (g++), a written 10-frame 270 x 480
    RGB clip decoded byte-equal to PIL, ms a frame beside PIL's (host
    clock, the median of LOADER_REPS); returns the first frame."""
    from PIL import Image

    from fcvsr_tpu_torch.data import native_loader
    from fcvsr_tpu_torch.data.datasets import load_image

    n, h, w = LOADER_CLIP
    frames = (smooth_clip(torch, 31, n, h, w) * 255).round().astype(np.uint8)
    paths = []
    for i, frame in enumerate(frames):
        paths.append(os.path.join(root, f"{i:08d}.png"))
        Image.fromarray(frame).save(paths[-1])
    t0 = time.perf_counter()
    try:
        native_loader.load_library()
    except (RuntimeError, OSError) as err:
        fail(f"the native PNG decoder did not build or load: {err}")
    build_s = time.perf_counter() - t0
    if not native_loader.native_available():
        fail("native_loader.native_available() is False")
    got = native_loader.load_batch_native(paths, h, w, num_threads=8)
    pil = np.stack([load_image(p) for p in paths])
    if got.shape != pil.shape or not np.array_equal(got, pil) \
            or not np.array_equal(got, frames):
        fail("the native decoder's frames differ from PIL's")
    times = {"native_batch": [], "native_one": [], "pil": []}
    for _ in range(LOADER_REPS):
        for key, fn in (
                ("native_batch", lambda: native_loader.load_batch_native(
                    paths, h, w, num_threads=8)),
                ("native_one", lambda: [native_loader.load_image_native(p)
                                        for p in paths]),
                ("pil", lambda: [load_image(p) for p in paths])):
            t = time.perf_counter()
            fn()
            times[key].append((time.perf_counter() - t) * 1e3 / n)
    say("library_loader", clip=[n, h, w, 3], byte_equal_to_pil=True,
        build_s=build_s, threads=8, reps=LOADER_REPS,
        **{f"{k}_ms_per_frame": float(np.median(v))
           for k, v in times.items()})
    return frames[0]


def phase_library(torch, card):
    """The rest of the JAX package's library, which no entry point calls:
    (a) the blocks (FSAS, FSAS_freq, FFTSpatialModule, MultiFreqAgg at K 3,
    EncoderShiftBlock over 7 frames, TFRUNet, Encoder2 over 7 frames,
    CABEncoder then CABDecoder, ResidualBlocksWithInputConv of 30 blocks)
    at 64 features, seeded, ``beta`` non-zero, on the card against the CPU
    at 64 x 96 within MODEL_ATOL, then on the card alone at 272 x 480: ms
    (CUDA events, the median of LIB_REPS after a warm-up) and the peak,
    and the device profile of the LIB_PROFILE blocks;
    (b) a ``SpaFreqBlock(train=True)`` training step (SGD) on 2 x 64 x 96
    x 64, its output, running statistics and updated weights on the card
    against the CPU, then timed at 2 x 272 x 480 x 64; (c) LPIPS (AlexNet,
    seeded) on a 2 x 3 x 256 x 256 pair, card against CPU, timed; (d) the
    native PNG decoder, built and byte-equal to PIL on a 10-frame 270 x
    480 RGB clip, ms a frame beside PIL's; (e) NIQE and NRQM on a 270 x 480
    Y frame with synthetic model files, host seconds; (f) no kernel of the
    port launched."""
    import copy

    from fcvsr_tpu_torch import profiling
    from fcvsr_tpu_torch.metrics import lpips, noref, nrqm
    from fcvsr_tpu_torch.metrics.psnr_ssim import rgb2y
    from fcvsr_tpu_torch.models import init_weights
    from fcvsr_tpu_torch.models.blocks_ext import SpaFreqBlock
    from fcvsr_tpu_torch.ops import launch_counts, reset_launch_counts

    dev = torch.device("cuda", 0)
    reset_launch_counts()
    h, w = LIB_CHECK
    blocks = library_blocks(torch)
    for i, (name, (model, b, c, k)) in enumerate(blocks.items()):
        inputs = library_inputs(torch, 40 + i, b, h, w, c, k)
        with torch.no_grad():
            ref = library_call(name, model, inputs)
            got = library_call(name, copy.deepcopy(model).to(dev),
                               [v.to(dev) for v in inputs])
        err = max(float((g.cpu() - r).abs().max()) for g, r in zip(got, ref))
        say("library_block", block=name, input=[b, h, w, c], inputs=k,
            outputs=[list(r.shape) for r in ref], max_abs_err=err,
            max_abs_out=max(float(r.abs().max()) for r in ref),
            tol=MODEL_ATOL)
        if not all(torch.isfinite(g).all() for g in got) or \
                [g.shape for g in got] != [r.shape for r in ref]:
            fail(f"{name}: non-finite values or shapes differ")
        if not err <= MODEL_ATOL:
            fail(f"{name}: GPU vs CPU error {err} > {MODEL_ATOL}")
    h, w = LIB_SHAPE
    for i, (name, (model, b, c, k)) in enumerate(blocks.items()):
        model = model.to(dev)
        inputs = library_inputs(torch, 60 + i, b, h, w, c, k, dev)
        out = {}

        def forward():
            with torch.no_grad():
                out["y"] = library_call(name, model, inputs)

        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        (ms,) = profiling.cuda_ms([forward], reps=LIB_REPS, warmup=1)
        say("library_serve", block=name, input=[b, h, w, c], inputs=k,
            ms=ms, ms_per_frame=ms / b,
            max_memory_allocated=torch.cuda.max_memory_allocated(),
            card=card)
        if not all(torch.isfinite(y).all() for y in out["y"]):
            fail(f"{name}: non-finite values at {h} x {w}")
        if name in LIB_PROFILE:
            with torch.no_grad():
                prof = profiling.device_profile(model, *inputs, n=1)
            say("library_profile", block=name, wall_ms=prof["wall_ms"],
                busy_ms=prof["busy_ms"], idle_share=prof["idle_share"],
                top_kernels=prof["kernels"][:8])
        del model, inputs, out
    del blocks

    # SpaFreqBlock's training step: batch statistics, flax's update
    cpu = init_weights(SpaFreqBlock(LIB_NF, train=True),
                       torch.Generator().manual_seed(2)).train()
    card_model = copy.deepcopy(cpu).to(dev)
    x = library_inputs(torch, 80, LIB_TRAIN_BATCH, *LIB_CHECK, LIB_NF, 1)[0]
    ref = spafreq_step(torch, cpu, torch.optim.SGD(cpu.parameters(),
                                                   lr=LIB_LR), x)
    got = spafreq_step(torch, card_model, torch.optim.SGD(
        card_model.parameters(), lr=LIB_LR), x.to(dev))
    errs = {"output": float((got.detach().cpu() - ref.detach()).abs().max())}
    want, have = spafreq_state(cpu), spafreq_state(card_model)
    for group, keys in (("running_stats", [k for k in want
                                           if ".running_" in k]),
                        ("weights", [k for k in want
                                     if ".running_" not in k])):
        errs[group] = max(float((have[k] - want[k]).abs().max())
                          for k in keys)
    moved = max(float(cpu.fu0.bn.running_var.sub(1).abs().max()),
                float(cpu.fu0.bn.running_mean.abs().max()))
    say("library_train_check", block="SpaFreqBlock(train=True)",
        input=[LIB_TRAIN_BATCH, *LIB_CHECK, LIB_NF], lr=LIB_LR,
        max_abs_err=errs, running_stats_moved=moved, tol=MODEL_ATOL)
    if not moved > 0 or not max(errs.values()) <= MODEL_ATOL:
        fail(f"SpaFreqBlock training step: GPU vs CPU {errs} (tol "
             f"{MODEL_ATOL}), running statistics moved {moved}")
    x = library_inputs(torch, 81, LIB_TRAIN_BATCH, *LIB_SHAPE, LIB_NF, 1,
                       dev)[0]
    opt = torch.optim.SGD(card_model.parameters(), lr=LIB_LR)
    torch.cuda.reset_peak_memory_stats()
    (ms,) = profiling.cuda_ms([lambda: spafreq_step(torch, card_model, opt,
                                                    x)],
                              reps=LIB_REPS, warmup=1)
    say("library_train", block="SpaFreqBlock(train=True)",
        input=[LIB_TRAIN_BATCH, *LIB_SHAPE, LIB_NF], ms_per_step=ms,
        max_memory_allocated=torch.cuda.max_memory_allocated(), card=card)
    del cpu, card_model, x, opt

    # LPIPS, seeded AlexNet and heads (non-negative, as the released ones)
    net = init_weights(lpips.LPIPSAlex(device="cpu"),
                       torch.Generator().manual_seed(3))
    with torch.no_grad():
        for i in range(5):
            getattr(net, f"lin{i}").weight.abs_()
    rng = np.random.default_rng(82)
    a, b = (torch.from_numpy(rng.uniform(0, 1, LPIPS_PAIR).astype(
        np.float32)) for _ in range(2))
    card_net = copy.deepcopy(net).to(dev)
    with torch.no_grad():
        ref = lpips.lpips_distance(net, a, b)
        got = lpips.lpips_distance(card_net, a, b)
        a, b = a.to(dev), b.to(dev)
        (ms,) = profiling.cuda_ms([lambda: lpips.lpips_distance(
            card_net, a, b)], reps=LIB_REPS, warmup=1)
    err = float((got.cpu() - ref).abs().max())
    say("library_lpips", input=list(LPIPS_PAIR), distances=ref.tolist(),
        max_abs_err=err, tol=MODEL_ATOL, ms=ms, card=card)
    if not err <= MODEL_ATOL or not torch.isfinite(got).all():
        fail(f"LPIPS: GPU vs CPU error {err} > {MODEL_ATOL}")
    del net, card_net, a, b

    with tempfile.TemporaryDirectory() as root:
        frame = library_loader(torch, root)
        niqe_mat, nrqm_mat = write_synthetic_metric_models(root)
        y = rgb2y(frame.astype(np.float32))
        t = time.perf_counter()
        niqe = noref.calculate_niqe(y, niqe_mat)
        niqe_s = time.perf_counter() - t
        t = time.perf_counter()
        score = nrqm.calculate_nrqm(y, nrqm_mat)
        nrqm_s = time.perf_counter() - t
    say("library_host_metrics", frame=list(y.shape), niqe=niqe,
        niqe_s=niqe_s, nrqm=score, nrqm_s=nrqm_s,
        note="synthetic model files of the released layouts")
    if not (np.isfinite(niqe) and np.isfinite(score)):
        fail(f"NIQE {niqe} or NRQM {score} is not finite")

    counts = launch_counts()
    say("library_launches", launches=counts)
    if any(counts.values()):
        fail(f"a kernel of the port launched on the library path: {counts}")


def write_rgb_clip(torch, root: str, n: int, h: int, w: int):
    """A smooth random RGB clip as PNGs: GT at 4x (``smooth_clip`` plus
    noise), LR its 4x4 block mean."""
    from PIL import Image

    rng = np.random.default_rng(9)
    for i, frame in enumerate(smooth_clip(torch, 9, n, 4 * h, 4 * w)):
        gt = np.clip(frame * 255 + rng.normal(0, 4, frame.shape), 0, 255)
        lr = gt.reshape(h, 4, w, 4, 3).mean((1, 3))
        for sub, img in (("lr", lr), ("gt", gt)):
            d = os.path.join(root, sub, "clip")
            os.makedirs(d, exist_ok=True)
            Image.fromarray(img.astype(np.uint8)).save(
                os.path.join(d, f"{i:08d}.png"))


# the recipes' per-GPU batches: mmedit's edvrm_x4_g8_600k_reds (4 windows
# of 5 frames, centre GT) and basicvsr_plusplus_c64n7_8x1_600k_reds4 (1
# sequence of 30 frames, per-frame GT, SPyNet frozen for 5000 steps);
# BasicVSR and IconVSR 1 sequence of 15 frames, their SPyNet (and
# IconVSR's refill extractor) frozen for 5000 steps, as basicvsr_reds4 and
# iconvsr_reds4 freeze them; TDAN 4 windows of 5 frames, centre GT, as
# the JAX package's TDAN step trains it; LR patches of 64; Adam (0.9,
# 0.999), Charbonnier-mean
ZOO_TRAIN = {
    "EDVRNet": dict(batch=4, frames=5, lr=4e-4, fix_iter=0),
    "BasicVSRPlusPlus": dict(batch=1, frames=30, lr=1e-4, fix_iter=5000),
    "BasicVSRNet": dict(batch=1, frames=15, lr=2e-4, fix_iter=5000),
    "IconVSR": dict(batch=1, frames=15, lr=2e-4, fix_iter=5000),
    "TDANNet": dict(batch=4, frames=5, lr=1e-4, fix_iter=0),
}


def tdan_train_step(torch, model, state):
    """TDAN's step (``VideoRestorer`` does not take its output pair):
    forward, the Charbonnier-mean loss of its SR centre frame, backward,
    one Adam update."""

    def step(lq, gt):
        state.optimizer.zero_grad(set_to_none=True)
        loss = zoo_loss(torch, model, "TDANNet", lq, gt)
        loss.backward()
        state.apply_gradients()
        return {"loss": loss.detach()}
    return step


def phase_zoo_train(torch, card):
    """Training of the zoo on the card through ``VideoRestorer`` (TDAN
    through its own step): batches sampled from a synthetic RGB clip by
    ``ClipFolderDataset``, 1 warm-up and 3 timed steps, the launches of
    all 4 checked, the ``spynet`` and ``edvr`` tensors frozen by fix_iter
    and every other tensor moving; then one ``torch.profiler`` step.
    Returns the launch counts of the 6 steps of every model."""
    from fcvsr_tpu_torch import profiling
    from fcvsr_tpu_torch.data import ClipFolderDataset
    from fcvsr_tpu_torch.models import VideoRestorer
    from fcvsr_tpu_torch.ops import launch_counts, reset_launch_counts
    from fcvsr_tpu_torch.train.trainer import TrainState

    dev = torch.device("cuda", 0)
    totals = {}
    with tempfile.TemporaryDirectory() as tmp:
        write_rgb_clip(torch, tmp, 32, 72, 96)
        for name, cfg in ZOO_TRAIN.items():
            seq = cfg["frames"] > 5
            data = ClipFolderDataset(os.path.join(tmp, "lr"),
                                     os.path.join(tmp, "gt"),
                                     window=cfg["frames"])
            rng = np.random.default_rng(10)
            batches = []
            for _ in range(4):
                pairs = [(data.sample_train_sequence(rng, 64) if seq
                          else data.sample_train_window(rng, 64))
                         for _ in range(cfg["batch"])]
                lq = np.stack([p[0] for p in pairs]).transpose(0, 1, 4, 2, 3)
                gt = np.stack([p[1] for p in pairs])
                gt = gt.transpose(0, 1, 4, 2, 3) if seq \
                    else gt.transpose(0, 3, 1, 2)
                batches.append((torch.from_numpy(np.ascontiguousarray(lq))
                                .to(dev),
                                torch.from_numpy(np.ascontiguousarray(gt))
                                .to(dev)))
            model = zoo_model(torch, name).train().to(dev)
            restorer = VideoRestorer(model, center_frame_only=not seq,
                                     fix_iter=cfg["fix_iter"])
            state = TrainState(model, lambda s, lr=cfg["lr"]: lr,
                               betas=(0.9, 0.999))
            step = restorer.make_train_step(state) if name != "TDANNet" \
                else tdan_train_step(torch, model, state)
            start = {k: p.detach().clone()
                     for k, p in model.named_parameters()}
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            losses, ms = [], []
            for lq, gt in batches:
                t0 = torch.cuda.Event(enable_timing=True)
                t1 = torch.cuda.Event(enable_timing=True)
                t0.record()
                out = step(lq, gt)
                t1.record()
                torch.cuda.synchronize()
                losses.append(float(out["loss"]))
                ms.append(t0.elapsed_time(t1))
            counts = launch_counts()
            peak = torch.cuda.max_memory_allocated()
            totals[name] = counts
            per_step = {k: v / len(batches) for k, v in counts.items()}
            now = dict(model.named_parameters())
            frozen = sorted(k for k in start if restorer.is_frozen(k))
            still = sorted(k for k in start if torch.equal(now[k], start[k]))
            want = dcn_per_forward(name, cfg["frames"])
            say("zoo_train", model=name, batch=cfg["batch"],
                frames=cfg["frames"], lr_patch=64, steps=len(batches),
                losses=losses, warmup_ms=ms[0], ms_per_step=ms[1:],
                ms_median=float(np.median(ms[1:])), ms_min=min(ms[1:]),
                ms_max=max(ms[1:]), max_memory_allocated=peak,
                launches=counts, launches_per_step=per_step,
                frozen_tensors=len(frozen), unmoved_tensors=len(still),
                tensors=len(start), card=card)
            if not all(math.isfinite(v) for v in losses):
                fail(f"{name}: non-finite training loss {losses}")
            if per_step != {k: float(want if k in ("dcn", "dcn_bwd") else 0)
                            for k in counts}:
                fail(f"{name}: launches per step {per_step}, expected "
                     f"{want} forward and {want} adjoint DCN launches and "
                     "no other kernel")
            if still != frozen or (seq and not frozen):
                fail(f"{name}: unmoved tensors {still[:8]} differ from the "
                     f"frozen ones {frozen[:8]}")
            lq, gt = batches[-1]
            prof = profiling._profile(lambda: step(lq, gt), dev, 1)
            prof["kernels"] = prof["kernels"][:12]
            say("zoo_train_profile", model=name, card=card, **prof)
            del model, state, batches
        for name, model_name in zip(RECURRENT_PLAIN, ("ftvsr", "ttvsr")):
            totals[name] = train_recurrent(torch, card, tmp, model_name)
    return {k: sum(c[k] for c in totals.values())
            for k in next(iter(totals.values()))}


FTVSR_PRESET = "ftvsr_cvcpLD_QP22"


def train_recurrent(torch, card, root: str, model_name: str) -> dict:
    """FTVSR (preset FTVSR_PRESET) or TTVSR (the same config, its
    ``model.name`` ttvsr) trained by ``train/cli.py`` on the clip under
    ``root``: one warm-up step, then a resumed run of 3 timed steps, with
    the launch counts (none) and the peak; then one ``torch.profiler`` step
    of the same recipe.  Returns the launch counts."""
    from fcvsr_tpu_torch import profiling
    from fcvsr_tpu_torch.data import ClipFolderDataset
    from fcvsr_tpu_torch.train import cli as train_cli
    from fcvsr_tpu_torch.train.losses import LOSSES
    from fcvsr_tpu_torch.train.lr_schedule import build_schedule
    from fcvsr_tpu_torch.train.trainer import TrainState
    from fcvsr_tpu_torch.utils.config import preset

    dev = torch.device("cuda", 0)
    cfg = preset(FTVSR_PRESET)
    cfg.model.name = model_name
    cfg.name = f"{model_name}_{FTVSR_PRESET.split('_', 1)[1]}"
    path = os.path.join(root, f"{cfg.name}.json")
    with open(path, "w") as f:
        f.write(cfg.to_json())
    args = ["--config", path, "--seed", "0",
            "--lr-root", os.path.join(root, "lr"),
            "--gt-root", os.path.join(root, "gt"),
            "--work-dir", os.path.join(root, "work")]
    (warm, timed), counts, peak = train_cli_runs(torch, cfg.name, args,
                                                 (1, 4))
    ms = timed["ms_per_step"]
    say("zoo_train", model=cfg.name, entry="train/cli.py",
        batch=cfg.data.batch_size, frames=cfg.model.num_frames,
        lr_patch=cfg.data.lr_patch, steps=4, resumed_at=timed["start"],
        losses=warm["losses"] + timed["losses"],
        warmup_ms=warm["ms_per_step"][0], ms_per_step=ms,
        ms_median=float(np.median(ms)), ms_min=min(ms), ms_max=max(ms),
        max_memory_allocated=peak, launches=counts, card=card)
    if any(counts.values()):
        fail(f"{cfg.name}: kernels launched on a path that has none: "
             f"{counts}")
    model = train_cli.build_model(cfg, 0, dev).train()
    state = TrainState(model, build_schedule(cfg.train),
                       betas=cfg.train.betas)
    data = ClipFolderDataset(os.path.join(root, "lr"),
                             os.path.join(root, "gt"),
                             window=cfg.model.num_frames)
    lq, gt = (torch.from_numpy(a).to(dev) for a in train_cli.sample_batch(
        np.random.default_rng(11), data, cfg.data.batch_size,
        cfg.data.lr_patch, sequence=True))
    prof = profiling.train_profile(state, LOSSES[cfg.train.loss], lq, gt,
                                   n=1)
    prof["kernels"] = prof["kernels"][:12]
    say("zoo_train_profile", model=cfg.name, card=card, **prof)
    del model, state
    return counts


def write_clip(root: str, n: int = 10, h: int = 270, w: int = 480):
    """A smooth random Y clip: GT at 4x, LR its 4x4 block mean."""
    from PIL import Image

    rng = np.random.default_rng(2)
    base = rng.uniform(0, 255, (n + 3, h // 6 + 2, w // 6 + 2))
    for i in range(n):
        coarse = base[i:i + 4].mean(0)
        gt = np.kron(coarse, np.ones((24, 24)))[: 4 * h, : 4 * w]
        gt = np.clip(gt + rng.normal(0, 4, gt.shape), 0, 255)
        lr = gt.reshape(h, 4, w, 4).mean((1, 3))
        for sub, img in (("lr", lr), ("gt", gt)):
            d = os.path.join(root, sub, "clip")
            os.makedirs(d, exist_ok=True)
            Image.fromarray(img.astype(np.uint8)).save(
                os.path.join(d, f"{i:08d}.png"))


def phase_slice(torch, card):
    from PIL import Image

    from fcvsr_tpu_torch import cli
    from fcvsr_tpu_torch.ops import launch_counts, reset_launch_counts

    with tempfile.TemporaryDirectory() as tmp:
        write_clip(tmp)
        out_dir = os.path.join(tmp, "sr")
        reset_launch_counts()
        summary = cli.main(["--preset", PRESET, "--seed", "0",
                            "--lr-root", os.path.join(tmp, "lr"),
                            "--gt-root", os.path.join(tmp, "gt"),
                            "--save-dir", out_dir, "--no-tof"])
        counts = launch_counts()
        r = summary["per_sequence"]["clip"]
        sr = np.asarray(Image.open(os.path.join(out_dir, "clip",
                                                "00000000.png")))
    per_frame = {k: v / r["forwards"] for k, v in counts.items()}
    say("slice", preset=PRESET, frames=r["frames"], forwards=r["forwards"],
        psnr=r["psnr"], ssim=r["ssim"], ms_per_frame=r["ms_per_frame"],
        sr_shape=list(sr.shape), launches=counts,
        launches_per_frame=per_frame, card=card)
    if r["frames"] != 10 or sr.shape != (1080, 1920):
        fail(f"expected 10 frames cropped to 1080x1920, got {r['frames']} "
             f"and {sr.shape}")
    if not (math.isfinite(r["psnr"]) and math.isfinite(r["ssim"])):
        fail(f"non-finite PSNR/SSIM {r['psnr']} {r['ssim']}")
    if per_frame != {k: float(v) for k, v in PER_FRAME.items()}:
        fail(f"launches per frame {per_frame}, expected {PER_FRAME}")
    fps = cli.main(["--preset", PRESET, "--seed", "0", "--fps"])
    say("fps", preset=PRESET, shape=[1, 7, 1, 272, 480], card=card, **fps)
    if not fps["ms_per_frame"] > 0:
        fail(f"bad FPS result {fps}")
    return counts


def phase_fast(torch, card):
    """Fast serving: the clip through ``cli --fast``, then with the
    resident IAC chain and the quad SCNet bodies, the launches per frame
    checked, and ``--fps`` of each with the peak memory; then each serving
    flag alone and both fast sets timed in turns on one model, and the
    stage times of the two fast sets.  Returns the launches of the
    resident + quad clip run."""
    from PIL import Image

    from fcvsr_tpu_torch import cli, profiling
    from fcvsr_tpu_torch.ops import launch_counts, reset_launch_counts
    from fcvsr_tpu_torch.utils.config import preset

    want = {"fast": FAST_PER_FRAME, "fast_resident_quad": FUSED_PER_FRAME}
    counts = {}
    with tempfile.TemporaryDirectory() as tmp:
        write_clip(tmp)
        for name, extra in FAST_RUNS.items():
            out_dir = os.path.join(tmp, name)
            reset_launch_counts()
            summary = cli.main(["--preset", PRESET, "--seed", "0",
                                "--lr-root", os.path.join(tmp, "lr"),
                                "--gt-root", os.path.join(tmp, "gt"),
                                "--save-dir", out_dir, "--no-tof"] + extra)
            counts[name] = launch_counts()
            r = summary["per_sequence"]["clip"]
            sr = np.asarray(Image.open(os.path.join(out_dir, "clip",
                                                    "00000000.png")))
            per_frame = {k: v / r["forwards"]
                         for k, v in counts[name].items()}
            say("fast", run=name, flags=summary["flags"], frames=r["frames"],
                forwards=r["forwards"], psnr=r["psnr"], ssim=r["ssim"],
                ms_per_frame=r["ms_per_frame"], sr_shape=list(sr.shape),
                launches_per_frame=per_frame, card=card)
            if r["frames"] != 10 or sr.shape != (1080, 1920):
                fail(f"{name}: expected 10 frames at 1080x1920, got "
                     f"{r['frames']} and {sr.shape}")
            if not (math.isfinite(r["psnr"]) and math.isfinite(r["ssim"])):
                fail(f"{name}: non-finite PSNR/SSIM {r['psnr']} {r['ssim']}")
            if per_frame != {k: float(v) for k, v in want[name].items()}:
                fail(f"{name}: launches per frame {per_frame}, expected "
                     f"{want[name]}")
            torch.cuda.empty_cache()
            fps = cli.main(["--preset", PRESET, "--seed", "0", "--fps"]
                           + extra)
            say("fps", run=name, preset=PRESET, shape=[1, 7, 1, 272, 480],
                card=card, **fps)
            if not fps["ms_per_frame"] > 0:
                fail(f"{name}: bad FPS result {fps}")
    model = cli.build_model(preset(PRESET), 0, "cuda")
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 1, (1, 7, 1, 272, 480)).astype(np.float32)).to("cuda")
    runs = profiling.serving_compare(model, x, reps=5, warmup=2,
                                     variants=FLAG_VARIANTS)
    say("serving_compare", shape=[1, 7, 1, 272, 480], reps=5, card=card,
        **runs)
    # each variant against the exact path at the --fast bars, with its
    # launches a forward
    with torch.no_grad():
        model.set_serving_flags(**cli.EXACT)
        exact = model(x)
        for name, flags in FLAG_VARIANTS.items():
            model.set_serving_flags(**{**cli.EXACT, **flags})
            reset_launch_counts()
            d = (model(x) - exact).abs()
            dev = (float(d.max()), float(d.mean()))
            say("flag_bars", variant=name, max_abs_dev=dev[0],
                mean_abs_dev=dev[1], tol=[FAST_MAX, FAST_MEAN],
                launches=launch_counts())
            if not (dev[0] < FAST_MAX and dev[1] < FAST_MEAN):
                fail(f"serving flags {name} against the exact path: max "
                     f"{dev[0]}, mean {dev[1]}")
        del exact, d
    model.set_serving_flags(**cli.EXACT)
    for name in FAST_RUNS:
        model.set_serving_flags(**{**cli.EXACT, **FLAG_VARIANTS[name]})
        say("stages", run=name, shape=[1, 7, 1, 272, 480], card=card,
            stages_ms=profiling.stage_times(model, x, reps=5))
    del model, x
    return counts["fast_resident_quad"]


def train_cli_runs(torch, label: str, args, totals):
    """``train/cli.py`` with ``args``, run to each total of steps in turn
    (each run after the first resumes the one before), from zeroed launch
    counts and peak memory: the runs' results, the launch counts and the
    peak.  Fails unless each run started where the one before ended and
    reached its total, with every loss finite."""
    from fcvsr_tpu_torch.ops import launch_counts, reset_launch_counts
    from fcvsr_tpu_torch.train import cli as train_cli

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    outs = [train_cli.main(args + ["--total-iters", str(n)]) for n in totals]
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    for start, out, n in zip((0,) + tuple(totals), outs, totals):
        if (out["start"], out["step"]) != (start, n):
            fail(f"{label}: a run started at {out['start']} and ended at "
                 f"{out['step']}, expected {start} and {n}")
        if not all(math.isfinite(v) for v in out["losses"]):
            fail(f"{label}: non-finite training loss {out['losses']}")
    return outs, counts, peak


def phase_train(torch, card):
    """The training slice: one warm-up step, then a resumed run of 5 timed
    steps, with the launch counts of all 6 steps."""
    with tempfile.TemporaryDirectory() as tmp:
        write_clip(tmp)
        args = ["--preset", PRESET, "--seed", "0",
                "--lr-root", os.path.join(tmp, "lr"),
                "--gt-root", os.path.join(tmp, "gt"),
                "--work-dir", os.path.join(tmp, "work")]
        (warm, timed), counts, peak = train_cli_runs(torch, PRESET, args,
                                                     (1, 6))
        serve_trained(torch, card, tmp, os.path.join(timed["work_dir"],
                                                     "ckpt"))
    per_step = {k: v / 6 for k, v in counts.items()}
    ms = timed["ms_per_step"]
    say("train", preset=PRESET, batch=6, lr_patch=128, steps=6,
        resumed_at=timed["start"], losses=warm["losses"] + timed["losses"],
        warmup_ms=warm["ms_per_step"][0], ms_per_step=ms,
        ms_median=float(np.median(ms)), ms_min=min(ms), ms_max=max(ms),
        max_memory_allocated=peak, launches=counts,
        launches_per_step=per_step, card=card)
    if per_step != {k: float(v) for k, v in PER_STEP.items()}:
        fail(f"launches per step {per_step}, expected {PER_STEP}")
    return counts


def write_vimeo_tree(torch, root: str, keys: int = 4, h: int = 64,
                     w: int = 112):
    """A Vimeo-90K-style tree: ``keys`` septuplets ``lr/0000k/0001/im1..7``
    of h x w RGB LR frames (the 4x4 block mean of the GT) and their 4h x 4w
    GT, and a meta-info file listing them as ``meta_info_Vimeo90K_*.txt``
    does."""
    from PIL import Image

    rng = np.random.default_rng(12)
    names = []
    for k in range(keys):
        key = f"{k + 1:05d}/0001"
        names.append(key)
        for i, frame in enumerate(smooth_clip(torch, 20 + k, 7, 4 * h, 4 * w)):
            gt = np.clip(frame * 255 + rng.normal(0, 4, frame.shape), 0, 255)
            lr = gt.reshape(h, 4, w, 4, 3).mean((1, 3))
            for sub, img in (("lr", lr), ("gt", gt)):
                d = os.path.join(root, sub, key)
                os.makedirs(d, exist_ok=True)
                Image.fromarray(img.astype(np.uint8)).save(
                    os.path.join(d, f"im{i + 1}.png"))
    meta = os.path.join(root, "meta_info_Vimeo90K_train_GT.txt")
    with open(meta, "w") as f:
        f.write("".join(f"{k} ({4 * h},{4 * w},3)\n" for k in names))
    return meta


# the Vimeo recipe through the CLI (tools/train_FCVSR_Vimeo_LD22.py's
# preset): FCVSR full, RGB, its batch of 2; LR patches of 64 (Vimeo's LR
# frames are 64 high; the preset's 128 is REDS's), 5 steps, evaluation
# every 2 on 8 windows of a 64 x 112 validation clip
VIMEO_PRESET, VIMEO_STEPS, VIMEO_EVAL = "fcvsr_vimeoLD_QP22", 5, 2


def phase_vimeo_train(torch, card):
    """``train.cli.main`` on a synthetic Vimeo tree through a meta file,
    with ``--val-lr-root`` / ``--val-gt-root`` (eval every VIMEO_EVAL
    steps), ``--tensorboard`` and ``--fast``: the losses, ms per step, the
    eval PSNRs and the CSV's eval rows, the event file (where
    ``torch.utils.tensorboard`` imports), and the launches: each step's,
    and each eval window's forward (K1, K2, K3, K5); then one step of the
    same recipe under ``torch.profiler`` (device time by kernel, idle
    share)."""
    import importlib.util

    from fcvsr_tpu_torch import cli, profiling
    from fcvsr_tpu_torch.train import cli as train_cli
    from fcvsr_tpu_torch.train.losses import LOSSES
    from fcvsr_tpu_torch.train.lr_schedule import build_schedule
    from fcvsr_tpu_torch.train.trainer import TrainState
    from fcvsr_tpu_torch.utils.config import preset

    with tempfile.TemporaryDirectory() as tmp:
        meta = write_vimeo_tree(torch, tmp)
        val = os.path.join(tmp, "val")
        write_rgb_clip(torch, val, 10, 64, 112)
        cfg = preset(VIMEO_PRESET)
        cfg.train.eval_interval = VIMEO_EVAL
        cfg.data.lr_patch = 64
        cfg.work_dir = os.path.join(tmp, "work")
        path = os.path.join(tmp, "config.json")
        with open(path, "w") as f:
            f.write(cfg.to_json())
        (out,), counts, peak = train_cli_runs(torch, VIMEO_PRESET, [
            "--config", path, "--seed", "0",
            "--lr-root", os.path.join(tmp, "lr"),
            "--gt-root", os.path.join(tmp, "gt"), "--meta-file", meta,
            "--val-lr-root", os.path.join(val, "lr"),
            "--val-gt-root", os.path.join(val, "gt"),
            "--tensorboard", "--fast"], (VIMEO_STEPS,))
        with open(os.path.join(out["work_dir"], "train_log.csv")) as f:
            rows = [r for r in f.read().split() if "eval_psnr" in r]
        events = os.listdir(os.path.join(out["work_dir"], "tb")) \
            if os.path.isdir(os.path.join(out["work_dir"], "tb")) else []
        cfg.data.lr_root, cfg.data.gt_root = (os.path.join(tmp, "lr"),
                                              os.path.join(tmp, "gt"))
        cfg.data.meta_file = meta
        lrs, gt = (torch.from_numpy(a).to("cuda") for a in
                   train_cli.sample_batch(np.random.default_rng(0),
                                          train_cli.build_dataset(cfg),
                                          cfg.data.batch_size, 64))
    model = cli.build_model(cfg, 0, "cuda").train()
    state = TrainState(model, build_schedule(cfg.train), cfg.train.betas)
    prof = profiling.train_profile(state, LOSSES[cfg.train.loss], lrs, gt, 1)
    prof["kernels"] = prof["kernels"][:12]
    del model, state
    tb = importlib.util.find_spec("tensorboard") is not None
    evals = VIMEO_STEPS // VIMEO_EVAL
    want = {k: VIMEO_STEPS * PER_STEP[k] + 8 * evals * PER_FRAME[k]
            for k in PER_STEP}
    ms = out["ms_per_step"]
    say("vimeo_train", preset=VIMEO_PRESET, batch=cfg.data.batch_size,
        lr_patch=64, steps=out["step"], losses=out["losses"],
        warmup_ms=ms[0], ms_per_step=ms, ms_median=float(np.median(ms[1:])),
        eval_psnr=out["eval_psnr"], csv_eval_rows=rows,
        tensorboard=tb, event_files=len(events),
        max_memory_allocated=peak, launches=counts, expected=want,
        card=card)
    if [s for s, _ in out["eval_psnr"]] != [VIMEO_EVAL * (i + 1)
                                           for i in range(evals)] or \
            len(rows) != evals or not all(math.isfinite(v)
                                          for _, v in out["eval_psnr"]):
        fail(f"vimeo training: eval {out['eval_psnr']}, CSV rows {rows}")
    if tb and len(events) != 1:
        fail(f"vimeo training: {len(events)} TensorBoard event files")
    if counts != want:
        fail(f"vimeo training: launches {counts}, expected {want}")
    say("vimeo_train_profile", preset=VIMEO_PRESET, card=card, **prof)
    return counts


def phase_bf16(torch, card):
    """The whole model in bf16 (``utils.precision``) at the FPS shape, 1 x
    7 x 1 x 272 x 480, FCVSR full Y: against the exact path at the --fast
    bars, its launches a forward (K1, K2, K3 on bf16 maps), and the two
    timed in turns (``cli.fps_benchmark``, twice each), with their
    peaks."""
    from fcvsr_tpu_torch import cli
    from fcvsr_tpu_torch.ops import launch_counts, reset_launch_counts
    from fcvsr_tpu_torch.utils.config import preset
    from fcvsr_tpu_torch.utils.precision import bf16_apply, cast_params

    model = cli.build_model(preset(PRESET), 0, "cuda")
    m16 = cast_params(model)
    x = torch.from_numpy(np.random.default_rng(13).uniform(
        0, 1, (1, 7, 1, 272, 480)).astype(np.float32)).to("cuda")
    with torch.no_grad():
        ref = model(x)
        reset_launch_counts()
        got = bf16_apply(m16, x)
        torch.cuda.synchronize()
        counts = launch_counts()
        runs = {"exact": model, "bf16": lambda v: bf16_apply(m16, v)}
        fps = {k: [] for k in runs}
        for _ in range(2):
            for name, fn in runs.items():
                torch.cuda.empty_cache()
                fps[name].append(cli.fps_benchmark(fn, n_iter=10))
    d = (got - ref).abs()
    dmax, dmean = float(d.max()), float(d.mean())
    say("bf16", preset=PRESET, shape=list(x.shape), dtype=str(got.dtype),
        max_abs_dev=dmax, mean_abs_dev=dmean, max_tol=FAST_MAX,
        mean_tol=FAST_MEAN, launches=counts,
        ms_per_frame={k: [r["ms_per_frame"] for r in v]
                      for k, v in fps.items()},
        max_memory_allocated={k: [r["max_memory_allocated"] for r in v]
                              for k, v in fps.items()}, card=card)
    if got.dtype != torch.float32 or not torch.isfinite(got).all():
        fail(f"bf16: output {got.dtype} or non-finite values")
    if not (dmax <= FAST_MAX and dmean <= FAST_MEAN):
        fail(f"bf16: {dmax} max / {dmean} mean from the exact path")
    if counts != PER_FRAME:
        fail(f"bf16: launches {counts}, expected {PER_FRAME}")


def serve_trained(torch, card, root, ckpt_dir):
    """Serve the checkpoint the training phase wrote through ``cli.main``
    (``--checkpoint`` its directory) on the clip under ``root``: frame 0's
    SR must be a forward of the model given ``load_weights`` of the newest
    checkpoint (its PNG, and its PSNR within 1e-4 dB), unlike the seed-0
    model's; PSNR, SSIM and tOF finite; tOF's host seconds printed."""
    from PIL import Image

    from fcvsr_tpu_torch import cli
    from fcvsr_tpu_torch.data import ClipFolderDataset
    from fcvsr_tpu_torch.metrics import calculate_psnr
    from fcvsr_tpu_torch.utils.checkpoint import (latest_checkpoint,
                                                  load_weights)
    from fcvsr_tpu_torch.utils.config import preset

    lr, gt = os.path.join(root, "lr"), os.path.join(root, "gt")
    out_dir = os.path.join(root, "served")
    t0 = time.perf_counter()
    summary = cli.main(["--preset", PRESET, "--checkpoint", ckpt_dir,
                        "--lr-root", lr, "--gt-root", gt,
                        "--save-dir", out_dir])
    wall = time.perf_counter() - t0
    r = summary["per_sequence"]["clip"]
    ckpt = latest_checkpoint(ckpt_dir)

    _, window, gt0 = next(ClipFolderDataset(lr, gt, grayscale=True)
                          .iter_test_windows("clip"))
    window, (h, w) = cli.pad_to_multiple(window)
    x = torch.from_numpy(np.ascontiguousarray(np.transpose(
        window.astype(np.float32) / 255.0, (0, 3, 1, 2))[None])).to("cuda")
    model = cli.build_model(preset(PRESET), 0, "cuda")

    def sr255():
        with torch.no_grad():
            y = model(x)[0].permute(1, 2, 0).cpu().numpy()
        return np.clip(y[:4 * h, :4 * w] * 255.0, 0, 255)

    seeded = sr255()
    load_weights(ckpt, model)
    own = sr255()
    png = np.asarray(Image.open(os.path.join(out_dir, "clip",
                                             "00000000.png")))
    png_dev = np.abs(png.astype(np.float64)
                     - own[..., 0].astype(np.uint8).astype(np.float64))
    psnr0 = calculate_psnr(own, gt0.astype(np.float32), 0, None, "rgb")
    moved = float(np.abs(own - seeded).max())
    say("serve_trained", preset=PRESET, weights=summary["weights"],
        frames=r["frames"], psnr=r["psnr"], ssim=r["ssim"], tof=r["tof"],
        tof_seconds=r["tof_seconds"], tof_wall_seconds=r["tof_wall_seconds"],
        ms_per_frame=r["ms_per_frame"], wall_s=wall,
        frame0_psnr=r["psnr_frames"][0], frame0_psnr_own_forward=psnr0,
        png_pixels_off=int((png_dev > 0).sum()),
        png_max_dev=float(png_dev.max()), seed_to_trained_max_dev=moved,
        card=card)
    if summary["weights"] != {"checkpoint": os.path.abspath(ckpt)} or \
            not ckpt.endswith("iter_6.pt"):
        fail(f"served {summary['weights']}, expected {ckpt} (iter_6.pt)")
    if not all(math.isfinite(r[k]) for k in ("psnr", "ssim", "tof")):
        fail(f"served checkpoint: non-finite PSNR/SSIM/tOF {r}")
    if r["frames"] != 10 or png.shape != (1080, 1920):
        fail(f"served {r['frames']} frames of {png.shape}")
    if abs(r["psnr_frames"][0] - psnr0) > 1e-4 or png_dev.max() > 1 or \
            (png_dev > 0).mean() > 1e-4:
        fail(f"frame 0 is not the loaded model's forward: PSNR "
             f"{r['psnr_frames'][0]} against {psnr0}, PNG off by up to "
             f"{png_dev.max()} at {(png_dev > 0).sum()} pixels")
    if not moved > 1e-3:
        fail(f"the served SR equals the seed-0 model's (max dev {moved})")


def phase_modes(torch, card):
    """ETC and tiled serving on the card, exact and ``--fast``: a 13-frame
    272x480 clip through ``fcvsr_etc_forward`` (its 7 windows one batch,
    so a frame's launches), each output within ETC_ATOL of its window's
    single forward under the same flags (the --fast bars under --fast);
    a smooth 7 x 540 x 960 window
    through ``tiled_sr`` (15 tiles of 272, overlap 32, one batched forward)
    within the --fast bars of the whole-frame forward, its max outside the
    band of the padded sides (see the note at TILE_BORDER_BAND).  ms (CUDA events;
    the tiles' wall time, stitching included), peak memory and launches of
    each."""
    from fcvsr_tpu_torch import cli
    from fcvsr_tpu_torch.models import fcvsr_etc_forward, tiled_sr
    from fcvsr_tpu_torch.ops import launch_counts, reset_launch_counts
    from fcvsr_tpu_torch.utils.config import preset

    dev = torch.device("cuda", 0)
    model = cli.build_model(preset(PRESET), 0, "cuda")
    n, c, h, w = ETC_SHAPE[1:]
    clip = torch.from_numpy(np.ascontiguousarray(np.transpose(
        smooth_clip(torch, 12, n, h, w)[..., :c], (0, 3, 1, 2))[None])).to(dev)
    t, tc, th, tw = TILE_SHAPE
    window = np.ascontiguousarray(np.transpose(
        smooth_clip(torch, 13, t, th, tw)[..., :tc], (0, 3, 1, 2)))
    want = {"exact": PER_FRAME, "fast": FAST_PER_FRAME}

    def events_ms(fn, reps=3):
        fn()
        times = []
        for _ in range(reps):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        return float(np.median(times)), times

    for name, flags in (("exact", {}), ("fast", FAST_FLAGS)):
        model.set_serving_flags(**{**cli.EXACT, **flags})
        with torch.no_grad():
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            out, base = fcvsr_etc_forward(model, clip)
            torch.cuda.synchronize()
            launches = launch_counts()
            peak = torch.cuda.max_memory_allocated()
            diffs = [(out[:, i] - model(clip[:, i:i + 7])).abs()
                     for i in range(n - 6)]
            devs = [float(d.max()) for d in diffs]
            means = [float(d.mean()) for d in diffs]
            del diffs
            ms, times = events_ms(lambda: fcvsr_etc_forward(model, clip))
            say("etc", flags=name, clip=list(clip.shape),
                out_shape=list(out.shape), ms=ms, ms_per_frame=ms / (n - 6),
                ms_runs=times, max_memory_allocated=peak, launches=launches,
                window_max_abs_dev=devs, window_mean_abs_dev=means,
                tol=ETC_ATOL if name == "exact" else [FAST_MAX, FAST_MEAN],
                card=card)
            if out.shape != (1, n - 6, c, 4 * h, 4 * w) or \
                    base.shape != out.shape or not torch.isfinite(out).all():
                fail(f"ETC {name}: output {tuple(out.shape)} or non-finite")
            if launches != {k: v for k, v in want[name].items()}:
                fail(f"ETC {name}: launches {launches}, expected a frame's "
                     f"{want[name]} (the windows one batch)")
            if not (max(devs) <= ETC_ATOL if name == "exact" else
                    max(devs) < FAST_MAX and max(means) < FAST_MEAN):
                fail(f"ETC {name}: windows off their single forwards by "
                     f"{devs} (mean {means})")
            del out, base

            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            full = model(torch.from_numpy(window[None]).to(dev)).cpu().numpy()
            full_peak = torch.cuda.max_memory_allocated()
            full_ms, _ = events_ms(
                lambda: model(torch.from_numpy(window[None]).to(dev)))
            tiled_sr(model, window, TILE, OVERLAP)  # warm-up at B 15
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            t0 = time.perf_counter()
            sr = tiled_sr(model, window, TILE, OVERLAP)
            wall_ms = 1e3 * (time.perf_counter() - t0)
            launches = launch_counts()
            peak = torch.cuda.max_memory_allocated()
            d = np.abs(sr - full)[0]
            step = TILE - 2 * OVERLAP
            band = TILE_BORDER_BAND
            seams = d[:, :4 * th - band if (th - 2 * OVERLAP) % step else None,
                      :4 * tw - band if (tw - 2 * OVERLAP) % step else None]
            say("tiles", flags=name, window=list(window.shape), tile=TILE,
                overlap=OVERLAP, out_shape=list(sr.shape), wall_ms=wall_ms,
                max_memory_allocated=peak, launches=launches,
                whole_frame_ms=full_ms, whole_frame_max_memory_allocated=
                full_peak, max_abs_dev=float(seams.max()),
                mean_abs_dev=float(d.mean()),
                whole_frame_max_abs_dev=float(d.max()),
                tol=[FAST_MAX, FAST_MEAN], card=card)
            if sr.shape != (1, tc, 4 * th, 4 * tw) or \
                    not np.isfinite(sr).all():
                fail(f"tiles {name}: output {sr.shape} or non-finite")
            if launches != {k: v for k, v in want[name].items()}:
                fail(f"tiles {name}: launches {launches}, expected one "
                     f"forward's {want[name]}")
            if not (seams.max() < FAST_MAX and d.mean() < FAST_MEAN):
                fail(f"tiles {name} against the whole frame: max "
                     f"{seams.max()} off the padded border, mean "
                     f"{d.mean()}")
            del full, sr
    del model, clip


# phase ddp: data parallelism on the one card.  (a) phase train's preset,
# batch and patch through ``train/cli.py --multihost`` at world size 1 on
# NCCL, 1 + 2 steps, against the same runs without it; (b) 2 ranks on the
# one card under Gloo (NCCL refuses two ranks on one device), spawned,
# FCVSR Y at a global batch of 2 (1 a rank) of DDP_PATCH^2 patches, 2
# steps, against one process's steps on the whole batch; (c) EDVR-M's
# restorer step under DDP at world size 1, 2 steps, against the plain
# step; (d) tiled_sr over the ranks of (b) at phase modes' window against
# one process.  Two runs of one process on the card need not agree bit
# for bit: the IAC adjoint and the DCN adjoint sum by atomics (the plain
# path's final parameters against its own rerun: 3.5e-8 of their norm in
# (a), 3.3e-8 in (c), H100 80GB HBM3 at 700 W), so (a) and (c) run the
# plain path twice, print that floor, and hold DDP to DDP_WORLD1_RTOL of
# the parameters' norm (DDP at world size 1 measured 4.3e-8 and 1.5e-8)
DDP_WORLD1_RTOL = 1e-6
DDP_STEPS = (1, 3)
DDP_PATCH = 64
DDP_TIMEOUT_S = 300.0
DDP_EDVR_STEPS = 2
# (b): 2 ranks against one process on the whole batch, whole-model
# relative deviation of the parameters after each step
DDP_RTOL = 1e-5
# (d): tiles over 2 ranks against one process, over max|out|
DDP_TILES_RTOL = 1e-5


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def param_deviation(got: dict, ref: dict) -> dict:
    """Max abs and whole-model relative deviation of two state dicts (or
    flat dicts of parameters)."""
    num = den = worst = 0.0
    for k, r in ref.items():
        d = (got[k].double() - r.double())
        num += float((d ** 2).sum())
        den += float((r.double() ** 2).sum())
        worst = max(worst, float(d.abs().max()) if d.numel() else 0.0)
    return {"max_abs": worst, "whole_rel": math.sqrt(num / max(den, 1e-300))}


def ddp_cli(torch, tmp: str, label: str, multihost: bool):
    """Phase train's preset, batch and patch through ``train/cli.py`` for
    DDP_STEPS (a fresh run, then a resumed one), with ``--multihost`` at
    world size 1 or without: the runs, the launch counts and the final
    parameters."""
    from fcvsr_tpu_torch.ops import launch_counts, reset_launch_counts
    from fcvsr_tpu_torch.train import cli as train_cli
    from fcvsr_tpu_torch.utils.checkpoint import latest_checkpoint

    args = ["--preset", PRESET, "--seed", "0",
            "--lr-root", os.path.join(tmp, "lr"),
            "--gt-root", os.path.join(tmp, "gt"),
            "--work-dir", os.path.join(tmp, label)]
    torch.cuda.empty_cache()
    reset_launch_counts()
    outs = []
    for n in DDP_STEPS:
        extra = ["--multihost", "--num-processes", "1", "--process-id", "0",
                 "--coordinator", f"127.0.0.1:{free_port()}"] \
            if multihost else []
        outs.append(train_cli.main(args + extra + ["--total-iters", str(n)]))
    counts = launch_counts()
    for start, out, n in zip((0,) + DDP_STEPS, outs, DDP_STEPS):
        if (out["start"], out["step"]) != (start, n):
            fail(f"ddp {label}: a run started at {out['start']} and ended "
                 f"at {out['step']}, expected {start} and {n}")
    final = torch.load(latest_checkpoint(os.path.join(
        outs[-1]["work_dir"], "ckpt")), map_location="cpu",
        weights_only=True)["model"]
    return outs, counts, final


def ddp_edvr(torch, batches, group):
    """EDVR-M's restorer steps (phase zoo_train's recipe) on ``batches``,
    under DDP over ``group`` or plain: the losses, launch counts and
    final parameters."""
    from fcvsr_tpu_torch.models import VideoRestorer
    from fcvsr_tpu_torch.ops import launch_counts, reset_launch_counts
    from fcvsr_tpu_torch.train.trainer import TrainState

    cfg = ZOO_TRAIN["EDVRNet"]
    model = zoo_model(torch, "EDVRNet").train().to("cuda")
    state = TrainState(model, lambda s: cfg["lr"], betas=(0.9, 0.999))
    step = VideoRestorer(model, center_frame_only=True).make_train_step(
        state, group=group)
    reset_launch_counts()
    losses = [float(step(lq, gt)["loss"]) for lq, gt in batches]
    counts = launch_counts()
    return losses, counts, {k: v.detach().to("cpu", copy=True)
                            for k, v in model.state_dict().items()}


def ddp_rank(rank: int, world: int, store: str, batches, window) -> dict:
    """One rank of (b) and (d), in its own process: TF32 off, the kernel
    library the parent built loaded (never built here), FCVSR Y seeded as
    the CLI seeds it under DDP over Gloo, a step on the rank's share of
    each global batch; then ``tiled_sr`` of ``window`` over the ranks."""
    import torch
    import torch.distributed as dist

    from fcvsr_tpu_torch import cli
    from fcvsr_tpu_torch.models import tiled_sr
    from fcvsr_tpu_torch.ops import _native, launch_counts, reset_launch_counts
    from fcvsr_tpu_torch.parallel import (initialize_multihost, make_mesh,
                                          rank_share, shutdown)
    from fcvsr_tpu_torch.train.lr_schedule import build_schedule
    from fcvsr_tpu_torch.train.trainer import TrainState, make_train_step
    from fcvsr_tpu_torch.utils.config import preset

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _native.lib()
    initialize_multihost(f"file://{store}", world, rank, backend="gloo",
                         device="cuda")
    try:
        group = dist.group.WORLD
        mesh = make_mesh("cuda", group)
        cfg = preset(PRESET)
        model = cli.build_model(cfg, 0, mesh.device).train()
        state = TrainState(model, build_schedule(cfg.train),
                           betas=cfg.train.betas)
        step = make_train_step(state, cfg.train.loss, group=group)
        reset_launch_counts()
        params, losses = [], []
        for lrs, gt in batches:
            out = step(*(torch.from_numpy(rank_share(a, mesh)).to(mesh.device)
                         for a in (lrs, gt)))
            losses.append(float(out["loss"]))
            params.append({k: p.detach().to("cpu", copy=True)
                           for k, p in model.named_parameters()})
        train_counts = launch_counts()
        served = cli.build_model(cfg, 0, mesh.device)
        reset_launch_counts()
        sr = tiled_sr(served, window, TILE, OVERLAP, device=mesh.device,
                      group=group)
        return {"rank": rank, "device": str(mesh.device),
                "build_seconds": _native.build_seconds, "losses": losses,
                "params": params, "train_launches": train_counts,
                "tile_launches": launch_counts(), "sr": sr}
    finally:
        shutdown()


def phase_ddp(torch, card):
    """Data parallelism on the one card, (a)-(d) of the note at
    DDP_STEPS."""
    import torch.distributed as dist

    from fcvsr_tpu_torch import cli
    from fcvsr_tpu_torch.data import ClipFolderDataset
    from fcvsr_tpu_torch.models import tiled_sr
    from fcvsr_tpu_torch.parallel import initialize_multihost, shutdown, spawn
    from fcvsr_tpu_torch.train import cli as train_cli
    from fcvsr_tpu_torch.train.lr_schedule import build_schedule
    from fcvsr_tpu_torch.train.trainer import TrainState, make_train_step
    from fcvsr_tpu_torch.utils.config import preset

    with tempfile.TemporaryDirectory() as tmp:
        write_clip(tmp)
        # (a) the CLI at world size 1 on NCCL, between two plain runs
        plain, _, plain_final = ddp_cli(torch, tmp, "plain", False)
        multi, counts, final = ddp_cli(torch, tmp, "multihost", True)
        again, _, again_final = ddp_cli(torch, tmp, "plain_again", False)
        floor = param_deviation(again_final, plain_final)
        dev = param_deviation(final, plain_final)
        losses = [o["losses"] for o in multi]
        plain_losses = [o["losses"] for o in plain]
        per_step = {k: v / DDP_STEPS[-1] for k, v in counts.items()}
        ms, plain_ms = multi[-1]["ms_per_step"], plain[-1]["ms_per_step"]
        say("ddp_world1", preset=PRESET, backend="nccl", steps=DDP_STEPS,
            world_size=multi[-1]["world_size"], losses=losses,
            plain_losses=plain_losses,
            plain_again_losses=[o["losses"] for o in again],
            params_vs_plain=dev, plain_run_to_run=floor,
            bitwise=dev["max_abs"] == 0.0, ms_per_step=ms,
            ms_median=float(np.median(ms)), plain_ms_per_step=plain_ms,
            plain_ms_median=float(np.median(plain_ms)),
            plain_again_ms_per_step=again[-1]["ms_per_step"],
            launches_per_step=per_step, card=card)
        if per_step != {k: float(v) for k, v in PER_STEP.items()}:
            fail(f"ddp world 1: launches per step {per_step}, expected "
                 f"phase train's {PER_STEP}")
        if dev["whole_rel"] > DDP_WORLD1_RTOL:
            fail(f"ddp world 1: parameters {dev} off the plain run's (its "
                 f"own run-to-run deviation {floor})")
        if not all(math.isfinite(v) for run in losses for v in run):
            fail(f"ddp world 1: non-finite losses {losses}")

        # (c) EDVR-M's restorer under DDP at world size 1
        data = ClipFolderDataset(os.path.join(tmp, "lr"),
                                 os.path.join(tmp, "gt"), window=5)
        rng = np.random.default_rng(10)
        edvr_batches = []
        for _ in range(DDP_EDVR_STEPS):
            lq, gt = train_cli.sample_batch(rng, data,
                                            ZOO_TRAIN["EDVRNet"]["batch"],
                                            DDP_PATCH)
            edvr_batches.append((torch.from_numpy(lq).to("cuda"),
                                 torch.from_numpy(gt).to("cuda")))
        e_plain = ddp_edvr(torch, edvr_batches, None)
        initialize_multihost(f"127.0.0.1:{free_port()}", 1, 0, device="cuda")
        try:
            e_ddp = ddp_edvr(torch, edvr_batches, dist.group.WORLD)
        finally:
            shutdown()
        e_again = ddp_edvr(torch, edvr_batches, None)
        e_floor = param_deviation(e_again[2], e_plain[2])
        e_dev = param_deviation(e_ddp[2], e_plain[2])
        want = dcn_per_forward("EDVRNet", 5) * DDP_EDVR_STEPS
        say("ddp_edvr", backend="nccl", world_size=1,
            batch=ZOO_TRAIN["EDVRNet"]["batch"], frames=5,
            lr_patch=DDP_PATCH, losses=e_ddp[0], plain_losses=e_plain[0],
            params_vs_plain=e_dev, plain_run_to_run=e_floor,
            launches=e_ddp[1], card=card)
        if {k: v for k, v in e_ddp[1].items() if v} != {"dcn": want,
                                                         "dcn_bwd": want}:
            fail(f"ddp EDVR-M: launches {e_ddp[1]}, expected {want} K7 and "
                 f"{want} K8")
        if e_dev["whole_rel"] > DDP_WORLD1_RTOL:
            fail(f"ddp EDVR-M: parameters {e_dev} off the plain run's (its "
                 f"own run-to-run deviation {e_floor})")

        # (b) and (d): 2 ranks on the one card under Gloo
        cfg = preset(PRESET)
        data = ClipFolderDataset(os.path.join(tmp, "lr"),
                                 os.path.join(tmp, "gt"), grayscale=True)
        rng = np.random.default_rng(11)
        batches = [train_cli.sample_batch(rng, data, 2, DDP_PATCH)
                   for _ in range(2)]
        t, tc, th, tw = TILE_SHAPE
        window = np.ascontiguousarray(np.transpose(
            smooth_clip(torch, 13, t, th, tw)[..., :tc], (0, 3, 1, 2)))
        t0 = time.perf_counter()
        ranks = spawn(ddp_rank, 2, (os.path.join(tmp, "store"), batches,
                                    window), timeout_s=DDP_TIMEOUT_S)
        ranks_s = time.perf_counter() - t0
        model = cli.build_model(cfg, 0, "cuda").train()
        state = TrainState(model, build_schedule(cfg.train),
                           betas=cfg.train.betas)
        step = make_train_step(state, cfg.train.loss)
        ref_losses, devs = [], []
        for i, (lrs, gt) in enumerate(batches):
            ref_losses.append(float(step(torch.from_numpy(lrs).to("cuda"),
                                         torch.from_numpy(gt).to("cuda"))
                                    ["loss"]))
            ref = {k: p.detach().to("cpu", copy=True)
                   for k, p in model.named_parameters()}
            devs.append(param_deviation(ranks[0]["params"][i], ref))
            if param_deviation(ranks[1]["params"][i],
                               ranks[0]["params"][i])["max_abs"] != 0.0:
                fail(f"ddp 2 ranks: the replicas differ after step {i}")
        del model, state
        torch.cuda.empty_cache()
        served = cli.build_model(cfg, 0, "cuda")
        one = tiled_sr(served, window, TILE, OVERLAP, device="cuda")
        scale = float(np.abs(one).max())
        tile_devs = [float(np.abs(r["sr"] - one).max()) / scale
                     for r in ranks]
        del served
        say("ddp_two_ranks", backend="gloo", world_size=2, global_batch=2,
            lr_patch=DDP_PATCH, steps=len(batches),
            losses=[r["losses"] for r in ranks], one_process_losses=
            ref_losses, params_vs_one_process=devs, tol=DDP_RTOL,
            devices=[r["device"] for r in ranks],
            rank_build_seconds=[r["build_seconds"] for r in ranks],
            launches=[r["train_launches"] for r in ranks], seconds=ranks_s,
            card=card)
        say("ddp_tiles", world_size=2, window=list(window.shape), tile=TILE,
            overlap=OVERLAP, tiles_per_rank=8, out_shape=list(one.shape),
            max_abs_dev_over_max=tile_devs, tol=DDP_TILES_RTOL,
            launches=[r["tile_launches"] for r in ranks], card=card)
        for r in ranks:
            if r["build_seconds"] is not None:
                fail(f"ddp rank {r['rank']} built the kernel library")
            if r["train_launches"] != {k: 2 * v for k, v in
                                       PER_STEP.items()}:
                fail(f"ddp rank {r['rank']}: launches {r['train_launches']}"
                     f", expected 2 steps of {PER_STEP}")
            if r["tile_launches"] != PER_FRAME:
                fail(f"ddp rank {r['rank']}: tile launches "
                     f"{r['tile_launches']}, expected one forward's")
            if not all(math.isfinite(v) for v in r["losses"]):
                fail(f"ddp rank {r['rank']}: non-finite losses")
        if max(d["whole_rel"] for d in devs) > DDP_RTOL:
            fail(f"ddp 2 ranks against one process: {devs}, bar {DDP_RTOL}")
        if max(tile_devs) > DDP_TILES_RTOL:
            fail(f"ddp tiles against one process: {tile_devs}")


# the GAN family: its models' GPU vs CPU output, over the output's max
# (DIC's float32 evaluation is itself 3e-4 of its max from float64 on the
# CPU, tests/test_torch_gan_models.py; so MODEL_ATOL's 1e-3 for all)
GAN_RTOL = 1e-3
# train/cli.py on each GAN preset: the totals of steps of its runs (each
# run after the first resumes the one before)
GAN_TRAIN = {"realbasicvsr_reds": (1, 2), "glean_cat_8x": (1, 2),
             "dic_gan_celeba": (1, 2), "realbasicvsr_wogan_reds": (1,),
             "dic_celeba": (1,)}
# the synthetic clips they train on: (data, LR side, scale)
GAN_DATA = {"realbasicvsr": ("rbv", 64, 4), "glean": ("glean", 32, 8),
            "dic": ("dic", 16, 8)}


def gan_check(torch, label: str, got, ref, bar: float = GAN_RTOL) -> dict:
    """The max abs error of ``got`` (any device) against ``ref`` (CPU) over
    ``ref``'s max, failing above ``bar``."""
    got = got.detach().float().cpu()
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    rel = err / max(scale, 1e-12)
    if got.shape != ref.shape or not rel <= bar:
        fail(f"{label}: GPU vs CPU {rel} of max |out| (bar {bar}), shapes "
             f"{tuple(got.shape)} {tuple(ref.shape)}")
    return dict(max_abs_err=err, max_abs=scale, rel_err=rel, bar=bar)


def gan_grads(torch, restorer, lq, gt) -> dict:
    """The generator's and the discriminator's gradients of one
    ``GANRestorer`` step (the generator's loss first, D frozen; then D's
    loss on the detached SR), by tensor, on the CPU."""
    gen, disc = restorer.generator, restorer.discriminator
    for m in (gen, disc):
        m.zero_grad(set_to_none=True)
    disc.requires_grad_(False)
    loss, _, sr = restorer.generator_loss(lq, gt)
    loss.backward()
    disc.requires_grad_(True)
    restorer.disc_loss(sr, gt)[0].backward()
    return {f"{tag}.{k}": None if p.grad is None else p.grad.cpu()
            for tag, m in (("G", gen), ("D", disc))
            for k, p in m.named_parameters()}


def phase_gan_models(torch, dev):
    """The GAN family at the presets' full widths, seeded weights, on the
    card against the CPU: RealBasicVSR (mid 64, 20 + 20 blocks) at 1 x 7 x
    3 x 64 x 96 with the default threshold (1 cleaning pass) and with 0
    (3), its SR and cleaned frames; GLEAN 32 -> 256 (RRDB 64 x 23, style
    512, channel multiplier 2); DIC 16 -> 128 (mid 64, 6 blocks, 68
    keypoints, 4 steps: every step's SR and heatmaps); the U-Net at 256^2,
    StyleGAN2's discriminator at 256 and LightCNN at 128.  Then one
    ``GANRestorer`` step of each family (the preset's discriminator), its
    generator's and discriminator's gradients on the card against the
    CPU's (the whole, the median and the worst tensor); then each
    generator's forward at its preset's batch and patch (CUDA events,
    median of 5 after 2 warm-ups) and its peak memory.  No kernel of
    ``ops.launch_counts()`` lies on these paths."""
    from fcvsr_tpu_torch import profiling
    from fcvsr_tpu_torch.models import (LightCNN, StyleGAN2Discriminator,
                                        UNetDiscriminatorWithSpectralNorm,
                                        init_weights)
    from fcvsr_tpu_torch.ops import launch_counts, reset_launch_counts
    from fcvsr_tpu_torch.train import cli as train_cli
    from fcvsr_tpu_torch.utils.config import preset

    cpu = torch.device("cpu")
    reset_launch_counts()

    def data(seed, *shape):
        return torch.from_numpy(np.random.default_rng(seed).uniform(
            0, 1, shape).astype(np.float32))

    # RealBasicVSR on both sides of its cleaning threshold
    rbv = preset("realbasicvsr_reds")
    x = data(20, 1, 7, 3, 64, 96)
    for thres, passes in ((255.0, 1), (0.0, 3)):
        model = train_cli.build_model(rbv, 0, cpu).eval()
        model.dynamic_refine_thres = thres
        with torch.no_grad():
            ref, ref_lq = model(x, return_lqs=True)
            p_cpu = model.cleaning_passes
            got, got_lq = model.to(dev)(x.to(dev), return_lqs=True)
            p_gpu = model.cleaning_passes
        say("gan_models", model="RealBasicVSRNet", threshold=thres,
            shape=list(x.shape), passes=[p_cpu, p_gpu],
            sr=gan_check(torch, "RealBasicVSR SR", got, ref),
            cleaned=gan_check(torch, "RealBasicVSR cleaned", got_lq, ref_lq))
        if p_cpu != passes or p_gpu != passes:
            fail(f"RealBasicVSR at threshold {thres}: {p_cpu} cleaning "
                 f"passes on the CPU, {p_gpu} on the card, expected {passes}")
        del model
    # GLEAN and DIC
    for name, shape in (("glean_cat_8x", (1, 3, 32, 32)),
                        ("dic_gan_celeba", (1, 3, 16, 16))):
        cfg = preset(name)
        model = train_cli.build_model(cfg, 0, cpu).eval()
        x = data(21, *shape)
        with torch.no_grad():
            ref = model(x)
            got = model.to(dev)(x.to(dev))
        if isinstance(ref, tuple):    # DIC: every step's SR and heatmaps
            checks = {f"{kind}{k}": gan_check(torch, f"DIC {kind} {k}", g, r)
                      for kind, rs, gs in (("sr", ref[0], got[0]),
                                           ("heatmap", ref[1], got[1]))
                      for k, (r, g) in enumerate(zip(rs, gs))}
        else:
            checks = {"sr": gan_check(torch, name, got, ref)}
        say("gan_models", model=type(model).__name__, preset=name,
            shape=list(x.shape), params=sum(p.numel()
                                           for p in model.parameters()),
            **checks)
        del model
    # the discriminators
    for disc, shape in ((UNetDiscriminatorWithSpectralNorm(), (1, 256, 256, 3)),
                        (StyleGAN2Discriminator(256), (2, 256, 256, 3)),
                        (LightCNN(), (2, 128, 128, 3))):
        disc = init_weights(disc, torch.Generator().manual_seed(1)).eval()
        x = data(22, *shape)
        with torch.no_grad():
            ref = disc(x)
            got = disc.to(dev)(x.to(dev))
        say("gan_models", model=type(disc).__name__, shape=list(shape),
            logits=gan_check(torch, type(disc).__name__, got, ref))
        del disc
    # one GANRestorer step a family: gradients on the card against the CPU
    for name, lq_shape, gt_shape in (
            ("realbasicvsr_reds", (1, 3, 3, 64, 64), (1, 3, 3, 256, 256)),
            ("glean_cat_8x", (1, 3, 32, 32), (1, 3, 256, 256)),
            ("dic_gan_celeba", (1, 3, 16, 16), (1, 3, 128, 128))):
        cfg = preset(name)
        lq, gt = data(23, *lq_shape), data(24, *gt_shape)
        ref = gan_grads(torch, train_cli.gan_trainer(cfg, cpu)[0], lq, gt)
        got = gan_grads(torch, train_cli.gan_trainer(cfg, dev)[0],
                        lq.to(dev), gt.to(dev))
        out = {}
        for tag in ("G", "D"):
            part = lambda d: {k: v for k, v in d.items()
                              if k.startswith(tag + ".")}
            whole, median, worst, over = deviation(part(got), part(ref))
            out[tag] = dict(whole_rel_err=whole, median_rel_err=median,
                            max_rel_err=worst, over_grad_rtol=over,
                            tensors=sum(v is not None
                                        for v in part(ref).values()))
            if not (whole <= GRAD_RTOL and median <= GRAD_RTOL
                    and worst <= FLIP_RTOL):
                fail(f"{name} {tag}: GPU vs CPU gradients beyond the "
                     f"bounds: {out[tag]}")
        say("gan_grads", preset=name, lq=list(lq_shape), gt=list(gt_shape),
            grad_rtol=GRAD_RTOL, flip_rtol=FLIP_RTOL, **out)
    # each generator's forward at its preset's batch and patch
    for name, shape in (("realbasicvsr_reds", (2, 7, 3, 64, 64)),
                        ("glean_cat_8x", (2, 3, 32, 32)),
                        ("dic_gan_celeba", (2, 3, 16, 16))):
        model = train_cli.build_model(preset(name), 0, dev).eval()
        x = data(25, *shape).to(dev)
        with torch.no_grad():
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            ms = profiling.cuda_ms([lambda: model(x)], reps=5, warmup=2)[0]
            peak = torch.cuda.max_memory_allocated()
        say("gan_forward", model=type(model).__name__, preset=name,
            shape=list(shape), ms=ms, max_memory_allocated=peak,
            card=nvidia_smi())
        del model
    counts = launch_counts()
    if any(counts.values()):
        fail(f"GAN models: kernels launched on a path that has none: "
             f"{counts}")


def write_pair_clip(torch, root: str, n: int, lr: int, scale: int) -> None:
    """A smooth random RGB clip of n frames as PNGs: GT (lr * scale)^2
    (``smooth_clip`` plus noise), LR its block mean."""
    from PIL import Image

    side = lr * scale
    rng = np.random.default_rng(26)
    for i, frame in enumerate(smooth_clip(torch, 26, n, side, side)):
        gt = np.clip(frame * 255 + rng.normal(0, 4, frame.shape), 0, 255)
        low = gt.reshape(lr, scale, lr, scale, 3).mean((1, 3))
        for sub, img in (("lr", low), ("gt", gt)):
            d = os.path.join(root, sub, "clip")
            os.makedirs(d, exist_ok=True)
            Image.fromarray(img.round().astype(np.uint8)).save(
                os.path.join(d, f"{i:08d}.png"))


def phase_gan_train(torch, card):
    """``train/cli.py`` trains each GAN preset on the card at its own
    width, batch and patch (GAN_TRAIN's runs; RealBasicVSR on synthetic
    256^2 GT clips of 8 frames, its LQ made by the degradation chain;
    GLEAN on 32 / 256 pairs, DIC on 16 / 128): the losses (finite), ms per
    step (CUDA events), the host seconds a step spends sampling and, for
    RealBasicVSR, in the degradation chain, the peak memory, the
    checkpoint's keys after the resume, and no kernel launched; then one
    ``torch.profiler`` step of each recipe (device idle share)."""
    from fcvsr_tpu_torch import profiling
    from fcvsr_tpu_torch.ops import launch_counts, reset_launch_counts
    from fcvsr_tpu_torch.train import cli as train_cli
    from fcvsr_tpu_torch.utils.checkpoint import latest_checkpoint
    from fcvsr_tpu_torch.utils.config import preset

    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as tmp:
        for data, lr, scale in GAN_DATA.values():
            write_pair_clip(torch, os.path.join(tmp, data), 8, lr, scale)
        for name, totals in GAN_TRAIN.items():
            cfg = preset(name)
            data = os.path.join(tmp, GAN_DATA[cfg.model.name][0])
            args = ["--preset", name, "--lr-root", os.path.join(data, "lr"),
                    "--gt-root", os.path.join(data, "gt"),
                    "--work-dir", os.path.join(tmp, "work")]
            t0 = time.perf_counter()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            outs = [train_cli.main(args + ["--total-iters", str(n)])
                    for n in totals]
            seconds = time.perf_counter() - t0
            counts = launch_counts()
            peak = torch.cuda.max_memory_allocated()
            for start, out, n in zip((0,) + totals, outs, totals):
                if (out["start"], out["step"], out["counter"]) != \
                        (start, n, n):
                    fail(f"{name}: a run started at {out['start']} and "
                         f"ended at {out['step']} (counter "
                         f"{out['counter']}), expected {start} and {n}")
            logs = [h for out in outs for h in out["logs"]]
            if not all(math.isfinite(v) for h in logs for v in h.values()):
                fail(f"{name}: non-finite losses {logs}")
            if any(counts.values()):
                fail(f"{name}: kernels launched on a path that has none: "
                     f"{counts}")
            ckpt_dir = os.path.join(outs[-1]["work_dir"], "ckpt")
            keys = sorted(torch.load(latest_checkpoint(ckpt_dir),
                                     map_location="cpu", weights_only=True,
                                     mmap=True))
            want = {"model", "optimizer", "counter", "step"} | (
                {"discriminator", "d_optimizer"}
                if cfg.gan.disc != "none" else set())
            if set(keys) != want:
                fail(f"{name}: checkpoint keys {keys}, expected "
                     f"{sorted(want)}")
            ms = [m for out in outs for m in out["ms_per_step"]]
            timed = outs[-1]["ms_per_step"]
            sample_s = [v for out in outs for v in out["sample_seconds"]]
            degrade_s = [v for out in outs for v in out["degrade_seconds"]]
            say("gan_train", preset=name, entry="train/cli.py",
                batch=cfg.data.batch_size, lr_patch=cfg.data.lr_patch,
                frames=cfg.model.num_frames if cfg.model.name ==
                "realbasicvsr" else 1, runs=list(totals),
                resumed_at=[out["start"] for out in outs],
                loss_g=[h["loss_g"] for h in logs],
                loss_d=[h.get("loss_d") for h in logs], ms_per_step=ms,
                ms_median_resumed=float(np.median(timed)),
                sample_s_per_step=sample_s,
                degrade_s_per_step=degrade_s,
                max_memory_allocated=peak, checkpoint_keys=keys,
                launches=counts, cli_seconds=seconds, card=card)
            # one profiled step of the recipe, on a random batch of its
            # shapes (the host's sampling is not in the profile)
            restorer, g_opt, d_opt = train_cli.gan_trainer(cfg, dev)
            step = restorer.make_train_step(g_opt, d_opt)
            b, p = cfg.data.batch_size, cfg.data.lr_patch
            s = train_cli.gan_scale(cfg)
            lead = (b, cfg.model.num_frames, 3) \
                if cfg.model.name == "realbasicvsr" else (b, 3)
            rng = np.random.default_rng(27)
            lq, gt = (torch.from_numpy(rng.uniform(0, 1, lead + (n, n))
                                       .astype(np.float32)).to(dev)
                      for n in (p, s * p))
            prof = profiling._profile(lambda: step(lq, gt), dev, 1)
            prof["kernels"] = prof["kernels"][:10]
            say("gan_train_profile", preset=name, card=card, **prof)
            del restorer, g_opt, d_opt, step


# phase tools: the port's tools on the card.  The FPS tool's rungs run
# FCVSR and FCVSR-S under each of these flag sets at its three shapes
FPS_MODES = {"exact": [], "fast": ["--fast"],
             "fast_resident_quad": ["--fast", "--iac-chain", "resident",
                                    "--scnet-fuse", "quad"]}
FPS_N_ITER, FPS_WARMUP = 2, 1
# per frame of FCVSR-S (ac_num 3, 4 SCGroups): 3 iterations x 2
# directions x 3 MGAA calls; 2 pairs x 3 BlockRCBs x 3 levels x 4 groups;
# 3 group convs x 4 + conv_last0; --fast and resident / quad as above
S_PER_FRAME = dict(PER_FRAME, iac=18, conv3x3_pair=72, conv3x3=13)
S_FAST_PER_FRAME = dict(S_PER_FRAME, iac=12, conv3x3=12)
S_FUSED_PER_FRAME = dict(S_PER_FRAME, iac=0, iac_chain=4, conv3x3_pair=0,
                         conv3x3_quad=36, conv3x3=12)
FPS_WANT = {("fcvsr", "exact"): PER_FRAME, ("fcvsr", "fast"): FAST_PER_FRAME,
            ("fcvsr", "fast_resident_quad"): FUSED_PER_FRAME,
            ("fcvsr_s", "exact"): S_PER_FRAME,
            ("fcvsr_s", "fast"): S_FAST_PER_FRAME,
            ("fcvsr_s", "fast_resident_quad"): S_FUSED_PER_FRAME}
S_CHECK = (184, 320)         # FCVSR-S Y, card against CPU (Johnny's size)
# RGB serving through the pinned test scripts: REDS's LR frames (180 x
# 320) for FCVSR, Vid4's (144 x 176) for FCVSR-S, 10 frames each
RGB_SERVE = {"test_REDS_FCVSR": (180, 320), "test_Vid4_FCVSR_S": (144, 176)}
REHEARSAL_STEPS = 30
EXPORT_SHAPE = (272, 480)    # FCVSR full Y, exact, the FPS shape
EXPORT_RTOL = 1e-6           # loaded program against eager, of max|out|
EXPORT_REPS = 5


def fps_rungs(torch, card, log: str) -> dict:
    """The FPS tool for FCVSR and FCVSR-S under each of FPS_MODES: every
    rung's ms a frame, peak and launches a frame, the launches checked."""
    from fcvsr_tpu_torch.tools import test_FCVSR_FPS

    out = {}
    for model in ("fcvsr", "fcvsr_s"):
        for mode, extra in FPS_MODES.items():
            torch.cuda.empty_cache()
            line = test_FCVSR_FPS.main(
                ["--model", model, "--log", log, "--n-iter", str(FPS_N_ITER),
                 "--warmup", str(FPS_WARMUP)] + extra)
            want = {k: float(v) for k, v in FPS_WANT[model, mode].items()}
            for seq, per_frame in line["launches_per_frame"].items():
                say("tools_fps", model=model, mode=mode, seq=seq,
                    shape=line["shapes"][seq],
                    ms_per_frame=line["ms_per_frame"][seq],
                    fps=line["fps"][seq],
                    max_memory_allocated=line["max_memory_allocated"][seq],
                    launches_per_frame=per_frame, n_iter=FPS_N_ITER,
                    warmup=FPS_WARMUP, card=line["card"])
                if per_frame != want:
                    fail(f"FPS {model} {mode} {seq}: launches a frame "
                         f"{per_frame}, expected {want}")
                if not line["ms_per_frame"][seq] > 0:
                    fail(f"FPS {model} {mode} {seq}: {line}")
            out[model, mode] = line
    return out


def serve_rgb(torch, card, root: str) -> None:
    """A synthetic 10-frame RGB clip of each RGB_SERVE size through its
    pinned test script on the card: 10 frames, SR at 4x, PSNR and SSIM
    finite, the launches a frame of the full model or of FCVSR-S."""
    from PIL import Image

    from fcvsr_tpu_torch.ops import launch_counts, reset_launch_counts
    from fcvsr_tpu_torch.tools import test_REDS_FCVSR, test_Vid4_FCVSR_S

    scripts = {"test_REDS_FCVSR": (test_REDS_FCVSR, PER_FRAME),
               "test_Vid4_FCVSR_S": (test_Vid4_FCVSR_S, S_PER_FRAME)}
    for name, (h, w) in RGB_SERVE.items():
        script, want = scripts[name]
        clip = os.path.join(root, name)
        write_rgb_clip(torch, clip, 10, h, w)
        torch.cuda.empty_cache()
        reset_launch_counts()
        summary = script.main(["--lr-root", os.path.join(clip, "lr"),
                               "--gt-root", os.path.join(clip, "gt"),
                               "--save-dir", os.path.join(clip, "sr"),
                               "--no-tof"])
        counts = launch_counts()
        r = summary["per_sequence"]["clip"]
        sr = np.asarray(Image.open(os.path.join(clip, "sr", "clip",
                                                "00000000.png")))
        per_frame = {k: v / r["forwards"] for k, v in counts.items()}
        say("tools_serve", script=name, preset=script.PRESET,
            lr=[h, w], frames=r["frames"], forwards=r["forwards"],
            psnr=r["psnr"], ssim=r["ssim"], ms_per_frame=r["ms_per_frame"],
            sr_shape=list(sr.shape), launches_per_frame=per_frame, card=card)
        if r["frames"] != 10 or sr.shape != (4 * h, 4 * w, 3):
            fail(f"{name}: {r['frames']} frames of {sr.shape}")
        if not (math.isfinite(r["psnr"]) and math.isfinite(r["ssim"])):
            fail(f"{name}: non-finite PSNR/SSIM {r['psnr']} {r['ssim']}")
        if per_frame != {k: float(v) for k, v in want.items()}:
            fail(f"{name}: launches a frame {per_frame}, expected {want}")


def export_check(torch, card, root: str) -> None:
    """``tools.export`` of FCVSR full Y, exact, at EXPORT_SHAPE on the
    card: the program's ops, its export, save and load seconds; loaded
    again, its output against the eager forward (EXPORT_RTOL of max|out|),
    its launches a frame (PER_FRAME) and both timed in turns (CUDA
    events, the median of EXPORT_REPS after a warm-up)."""
    from fcvsr_tpu_torch import cli
    from fcvsr_tpu_torch.ops import launch_counts, reset_launch_counts
    from fcvsr_tpu_torch.tools import export
    from fcvsr_tpu_torch.utils.config import preset

    path = os.path.join(root, "fcvsr.pt2")
    t0 = time.perf_counter()
    program, model = export.export_model(preset(PRESET), *EXPORT_SHAPE,
                                         device="cuda")
    t1 = time.perf_counter()
    torch.export.save(program, path)
    t2 = time.perf_counter()
    loaded = torch.export.load(path).module()
    t3 = time.perf_counter()
    ops = export.op_counts(program)
    del program
    x = torch.from_numpy(np.random.default_rng(17).uniform(
        0, 1, (1, 7, 1) + EXPORT_SHAPE).astype(np.float32)).to("cuda")
    with torch.no_grad():
        reset_launch_counts()
        got = loaded(x)
        torch.cuda.synchronize()
        counts = launch_counts()
        ref = model(x)
        dev = float((got - ref).abs().max())
        scale = float(ref.abs().max())
        del got, ref
        runs = {"eager": model, "loaded": loaded}
        ms = {k: [] for k in runs}
        for order in (("eager", "loaded"), ("loaded", "eager")):
            for name in order:
                torch.cuda.empty_cache()
                ms[name].append(cli.fps_benchmark(
                    runs[name], *EXPORT_SHAPE, n_iter=EXPORT_REPS,
                    warmup=1)["ms_per_frame"])
    say("tools_export", preset=PRESET, shape=[1, 7, 1, *EXPORT_SHAPE],
        ops=ops, bytes=os.path.getsize(path), export_s=t1 - t0,
        save_s=t2 - t1, load_s=t3 - t2, launches=counts, max_abs_dev=dev,
        max_abs_out=scale, ms_per_frame=ms, card=card)
    if ops != {"iac_fused": 6, "conv3x3_pair": 180, "conv3x3": 31}:
        fail(f"export: the program's fcvsr ops {ops}")
    if counts != PER_FRAME:
        fail(f"export: the loaded program launched {counts}, expected "
             f"{PER_FRAME}")
    if not dev <= EXPORT_RTOL * scale:
        fail(f"export: the loaded program is {dev} off the eager forward "
             f"(max |out| {scale})")


def phase_tools(torch, card):
    """The port's tools on the card: the FPS tool's rungs (FPS_MODES, the
    launches a frame checked), FCVSR-S Y on the card against the CPU at
    S_CHECK within MODEL_ATOL, RGB serving through the pinned test scripts
    (RGB_SERVE), the trained-proxy rehearsal (FCVSR-S RGB trained
    REHEARSAL_STEPS steps, published, validated: a PASS within 0.01 dB),
    and the export of FCVSR's exact forward, loaded and run again
    (``export_check``)."""
    from fcvsr_tpu_torch.tools import test_FCVSR_FPS, trained_proxy_rehearsal

    with tempfile.TemporaryDirectory() as tmp:
        fps_rungs(torch, card, os.path.join(tmp, "fps.txt"))
        with torch.no_grad():
            model = test_FCVSR_FPS.build_fps_model("fcvsr_s", {}, 3, "cpu")
            x = np.random.default_rng(19).uniform(
                0, 1, (1, 7, 1) + S_CHECK).astype(np.float32)
            ref = model(torch.from_numpy(x))
            got = model.to("cuda")(torch.from_numpy(x).to("cuda")).cpu()
        dev = float((got - ref).abs().max())
        say("tools_s_check", shape=list(x.shape), max_abs_err=dev,
            tol=MODEL_ATOL, finite=bool(torch.isfinite(got).all()))
        if not dev <= MODEL_ATOL or not torch.isfinite(got).all():
            fail(f"FCVSR-S on the card against the CPU: {dev}")
        del model, ref, got
        serve_rgb(torch, card, tmp)
        torch.cuda.empty_cache()
        r = trained_proxy_rehearsal.rehearse(
            ["--steps", str(REHEARSAL_STEPS)])
        say("tools_rehearsal", card=card, **r)
        if not r["pass"] or abs(r["delta_db"]) > r["tolerance_db"]:
            fail(f"rehearsal: {r}")
        torch.cuda.empty_cache()
        export_check(torch, card, tmp)


def phase_probe(torch):
    """The toolchain probe in its own process: every probe must pass.
    Returns its kernel's launches (the checked one)."""
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "gpu_probe.json")
        proc = subprocess.run(
            [sys.executable, "-m", "fcvsr_tpu_torch.tools.gpu_probe",
             "--out", out], cwd=HERE, capture_output=True, text=True,
            timeout=900)
        if not os.path.isfile(out):
            fail(f"gpu_probe wrote no JSON (exit {proc.returncode}): "
                 f"{proc.stderr[-2000:]}")
        with open(out) as f:
            res = json.load(f)
    say("probe", **res)
    if proc.returncode != 0 or not res["ok"]:
        fail(f"gpu_probe failed (exit {proc.returncode}): {res}")
    return res["kernel"]["launches"]


def phase_blockrcb_ab(torch):
    """The BlockRCB A/B entry point at 272x480x64, C1 64 and 128: K11
    against the unfused path, AB_RTOL of max|unfused|.  Returns K11's
    launches over both runs."""
    from fcvsr_tpu_torch.benchmarks import microbench_blockrcb_kernel as ab
    from fcvsr_tpu_torch.ops.fused_blockrcb import block_rcb

    block_rcb.launches = 0
    for c1 in (64, 128):
        rep = ab.main(["--c1", str(c1)])
        say("blockrcb_ab", tol=AB_RTOL, **rep)
        if not (rep["finite"] and rep["rel_dev"] <= AB_RTOL):
            fail(f"BlockRCB A/B C1 {c1}: fused against unfused "
                 f"{rep['rel_dev']} of max|unfused| > {AB_RTOL}")
        if not (rep["fused_ms"] > 0 and rep["unfused_ms"] > 0):
            fail(f"BlockRCB A/B C1 {c1}: bad timing {rep}")
    return block_rcb.launches


def phase_microbench(torch):
    """The K9 and K10 entry points in-process on cuda:0 at their real
    shapes; every probe held to its plain version (K9 within MB_RTOL of
    max|plain|, each tile's checksum finite and the same, and within its
    tolerance of the plain version's; K10's row and folds bit for bit,
    float32 and bf16), every library call within MB_RTOL of the plain
    version and every time positive.  Returns the launches of the seven wrappers
    over both runs and each kernel's line for the result (the first case
    timed; its max error over all cases)."""
    from fcvsr_tpu_torch.benchmarks import microbench_common as common
    from fcvsr_tpu_torch.benchmarks import microbench_conv2 as conv2
    from fcvsr_tpu_torch.benchmarks import microbench_dma as dma

    wrappers = {name: getattr(conv2 if "microbench_conv2" in where else dma,
                              name) for name, where in MICROBENCH.items()}
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    reports = conv2.main([])["probes"] + dma.main([])["probes"]
    launches = {name: fn.launches for name, fn in wrappers.items()}
    results = {}
    for rep in reports:
        name = rep["probe"]
        label = f"{name} {rep.get('case', 'f32')}"
        say("microbench", tol=0.0 if "case" in rep else MB_RTOL, **rep)
        if "case" in rep:
            if not rep["equal"]:
                fail(f"{label}: differs from its plain version: row by "
                     f"{rep['max_abs_dev']}, {rep['folds_differing']} of "
                     f"the folds {rep['folds']}")
        elif not (rep["finite"] and rep["rel_dev"] <= MB_RTOL):
            fail(f"{label}: {rep['rel_dev']} of max|plain| > {MB_RTOL}")
        if "checksums" in rep and not (
                rep["checksums_finite"] and rep["checksums_equal"]
                and rep["checksum_dev"] <= rep["checksum_tol"]):
            fail(f"{label}: tile checksums {rep['checksums']} against the "
                 f"plain {rep['checksum_plain']}")
        has_lib = not rep["library"].startswith("none")
        if has_lib and not rep["library_rel_dev"] <= MB_RTOL:
            fail(f"{label}: the library call {rep['library']} is "
                 f"{rep['library_rel_dev']} of max|plain| off")
        times = [rep["ms"], rep["plain_ms"], rep["yardstick_ms"]] + (
            [rep["library_ms"]] if has_lib else [])
        if not all(v is not None and v > 0 for v in times):
            fail(f"{label}: bad timing {times}")
        line = results.setdefault(name, dict(
            max_abs_err=0.0, **{k: rep[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}))
        line["max_abs_err"] = max(line["max_abs_err"], rep["max_abs_dev"])
    sass = common.sass()
    say("microbench_sass", kernels=sass, wants=common.SASS_WANTS,
        note=None if sass is not None else "no cuobjdump in the toolkit")
    faults = common.sass_faults(sass or {}) if sass is not None else []
    if faults:
        fail(f"the probes' SASS: {faults}")
    say("microbench_phase", seconds=time.perf_counter() - t0,
        launches=launches)
    return launches, results


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a "
             "CUDA GPU")
    if not os.path.isdir(os.path.join(HERE, "fcvsr_tpu_torch")):
        fail(f"no fcvsr_tpu_torch package beside {__file__}: run it from a "
             "checkout of the repository")
    sys.path.insert(0, HERE)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)

    card = nvidia_smi()
    print(card, flush=True)
    probe_launches = phase_probe(torch)
    from fcvsr_tpu_torch.ops import _native

    t0 = time.perf_counter()
    _native.lib()
    say("device", nvidia_smi=card, name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda, python=sys.version.split()[0],
        build_s=_native.build_seconds, load_s=time.perf_counter() - t0)

    sass = _native.sass_ops(_native.lib()._name, "conv3x3_pair_kernel",
                            ("HGMMA", "FFMA", "HMMA"))
    say("pair_sass", kernels=sass,
        note=None if sass is not None else "no cuobjdump in the toolkit")
    if not sass or any(not ops["HGMMA"] or ops["FFMA"] > PAIR_SASS_FFMA_MAX
                       for ops in sass.values()):
        fail(f"conv3x3_pair_kernel's SASS: {sass}, expected HGMMA and at "
             f"most {PAIR_SASS_FFMA_MAX} FFMA in each")
    # K1's kf kernels (KF = true: "Lb1E" in the mangled name) predict the
    # kernels on mma.sync (HMMA); K3's kernels run K2's wgmma loop
    iac_sass = _native.sass_ops(_native.lib()._name, "iac_kernel",
                                ("HMMA", "FFMA"))
    one_sass = _native.sass_ops(_native.lib()._name, "conv3x3_one",
                                ("HGMMA", "FFMA"))
    kf_sass = {n: ops for n, ops in (iac_sass or {}).items() if "Lb1E" in n}
    quad_sass = _native.sass_ops(_native.lib()._name, "conv3x3_quad_kernel",
                                 ("HGMMA", "FFMA"))
    say("iac_conv_sass", iac_kernels=iac_sass, conv3x3_kernels=one_sass,
        quad_kernels=quad_sass)
    if len(kf_sass) != 2 or any(not ops["HMMA"] for ops in kf_sass.values()):
        fail(f"iac_kernel's kf SASS: {iac_sass}, expected HMMA in both")
    if not one_sass or len(one_sass) != 4 or any(
            not ops["HGMMA"] or ops["FFMA"] > PAIR_SASS_FFMA_MAX
            for ops in one_sass.values()):
        fail(f"conv3x3_one_kernel's SASS: {one_sass}, expected HGMMA and "
             f"at most {PAIR_SASS_FFMA_MAX} FFMA in each of 4")
    # K6 runs K2's loop twice: 4 (N1, N1) instantiations a storage type
    if not quad_sass or len(quad_sass) != 8 or any(
            not ops["HGMMA"] or ops["FFMA"] > PAIR_SASS_FFMA_MAX
            for ops in quad_sass.values()):
        fail(f"conv3x3_quad_kernel's SASS: {quad_sass}, expected HGMMA and "
             f"at most {PAIR_SASS_FFMA_MAX} FFMA in each of 8")
    # K11's two instantiations (C1 up to 64, up to 128) run K2's loop
    rcb_sass = _native.sass_ops(_native.lib()._name, "blockrcb_kernel",
                                ("HGMMA", "FFMA"))
    say("blockrcb_sass", kernels=rcb_sass)
    if not rcb_sass or len(rcb_sass) != 2 or any(
            not ops["HGMMA"] for ops in rcb_sass.values()):
        fail(f"blockrcb_kernel's SASS: {rcb_sass}, expected HGMMA in each "
             "of 2")
    # K7 (one kernel) and K8 (Cout padded to 64 and to 128) contract on
    # wgmma; their FFMA are the sampler's
    dcn_sass = _native.sass_ops(_native.lib()._name, "dcn_",
                                ("HGMMA", "FFMA"))
    say("dcn_sass", kernels=dcn_sass, ffma_max=DCN_SASS_FFMA_MAX)
    if not dcn_sass or len(dcn_sass) != 3 or any(
            not ops["HGMMA"] or ops["FFMA"] > DCN_SASS_FFMA_MAX
            for ops in dcn_sass.values()):
        fail(f"the DCN kernels' SASS: {dcn_sass}, expected HGMMA and at most "
             f"{DCN_SASS_FFMA_MAX} FFMA in each of 3")

    seconds = {}

    def run(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        torch.cuda.empty_cache()
        seconds[name] = time.perf_counter() - t
        return out

    results = run("kernels", phase_kernels, torch, dev)
    results["dcn_bwd"] = run("dcn_bwd", phase_dcn_bwd, torch, dev)
    run("conv_grads", phase_conv_grads, torch, dev)
    run("model", phase_model, torch, dev)
    run("zoo_models", phase_zoo_models, torch, dev)
    run("zoo_grads", phase_zoo_grads, torch, dev)
    run("cvcp_zoo", phase_cvcp_zoo, torch, card)
    run("sisr_zoo", phase_sisr_zoo, torch, card)
    run("library", phase_library, torch, card)
    run("slice", phase_slice, torch, card)
    fast_counts = run("fast", phase_fast, torch, card)
    run("modes", phase_modes, torch, card)
    run("zoo", phase_zoo, torch, card)
    zoo_counts = run("zoo_train", phase_zoo_train, torch, card)
    train_counts = run("train", phase_train, torch, card)
    run("ddp", phase_ddp, torch, card)
    run("vimeo_train", phase_vimeo_train, torch, card)
    run("bf16", phase_bf16, torch, card)
    run("gan_models", phase_gan_models, torch, dev)
    run("gan_train", phase_gan_train, torch, card)
    run("tools", phase_tools, torch, card)
    ab_counts = {"blockrcb": run("blockrcb_ab", phase_blockrcb_ab, torch)}
    mb_counts, mb_results = run("microbench", phase_microbench, torch)
    results.update(mb_results)
    say("phase_seconds", **seconds)

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        path, counts = ("zoo training", zoo_counts) \
            if name in ("dcn", "dcn_bwd") else \
            ("fast serving (resident, quad)", fast_counts) \
            if name in ("iac_chain", "conv3x3_quad") else \
            ("BlockRCB A/B", ab_counts) if name == "blockrcb" else \
            ("microbench", mb_counts) if name in MICROBENCH else \
            ("gpu probe", {"scale2": probe_launches}) if name == "scale2" \
            else ("training", train_counts)
        if counts[name] == 0:
            fail(f"kernel {name} was not launched on the {path} path")
        kernels.append(dict(name=name, route="cuda", source=source,
                            replaces=replaces, launches=counts[name],
                            **results[name]))
        if name in PROBE_DESIGN:
            kernels[-1]["design"] = PROBE_DESIGN[name]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
