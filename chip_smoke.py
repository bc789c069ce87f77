"""Drive the PyTorch port's training and serving paths once on one CUDA card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.

1. Prints the card's name and power limit (nvidia-smi), builds the port's
   CUDA kernels from ``multimodal_neuroimage_tpu_torch/csrc`` with nvcc, and
   prints how the fusion forward and backward run on the card (blocks an
   SM, windows in flight, shared memory).
2. Holds every kernel against its plain PyTorch version on the card at the
   shapes its path gives it (float32, TF32 off) and times both with CUDA
   events, beside the least time the card could take (``bound_ms``) and,
   where one PyTorch call computes the same function, that call's time
   (kernel, plain and library timed in turns; a backward's library call is
   autograd through the library forward, its graph built once): K1's
   float32 forward (its products on 3xTF32 tensor cores) at batch 4, 16 and
   64, the training forward with every saved residual and the inference
   forward, twice bitwise equal, beside both its bounds (3xTF32 and f32)
   and, at batch 4, its float64 error within 4x of the float32-FMA
   yardstick's; K1-K4 backward and K2-K4 forward (dropout on; K4 at
   attention dropout 0 and 0.1, with each call's device time beside its
   call time: one replay of a CUDA graph of 20 calls; K4's backward also at
   batch 16 and 64, one launch a call, twice bitwise equal) and K5 at the
   flagship's shapes (B = 4); K6 forward
   and backward at HCP's (8, 2, 1201, 11), dropout 0 and 0.1 (dq/dk/dv
   against autograd through the plain forward); K2/K3's forward at batch
   4, 16 and 64, shifts 0 and 3, as inference and as the training forward
   (dropout 0.1, DropPath), its saved x2r held too (at 16 and 64 its work
   items, several subjects' windows of one window position, fill the card;
   the batch-4 inference, the serving shape, also with its device time);
   K7 forward and backward at the bp
   flagship's shapes (B = 16, two groups of G = 8, shifts 0 and 3, dropout
   0.1 and DropPath), also timed beside K2/K3 on the same inputs in the std
   layout; K8, every dot-shape variant at f32 and bf16 (one chain pair over
   its 7 cells), then the dot-shape entry point
   (``python -m multimodal_neuroimage_tpu_torch.bench.dot_shapes``) with its
   slope times per pair beside the plain chain's and ``torch.bmm``'s, and
   the fastest formulation on each. The bf16 policy's kernels: K1's mm16
   form forward and backward at batches 4, 16 and 64 beside
   ``nn.TransformerEncoderLayer`` in bf16 (then each entry's device scratch
   and the split of a batch-16 call into its launches), and K7 on bf16
   streams at the bp flagship's shapes beside K7 on float32 streams
   (bounds with the products at the bf16 tensor rate).
3. The flagship ``FuncStructCross`` (random weights from a seeded
   generator): trains with ``Trainer`` on a synthetic in-memory cohort with
   a label-linked signal (16 train and 8 val subjects, batch 4, 2 epochs,
   the config's dropout rates); every loss must be finite, each of its nine
   kernels must have launched in that run, and a best-AUROC checkpoint must
   be written. Serves the 8 val subjects from it with ``Predictor`` (the
   four forward kernels launch; logits match the CPU through the plain
   versions). Takes one training step on the card and the same step on the
   CPU from the same weights, batch and generator state, at a cut depth (2
   BERT layers a band, one fusion stage of depth 2 a group: the CPU's side
   at full depth took 83-100 s), and the full-depth step on the card
   against the port's plain twins there, and compares the loss, every
   gradient and the updated parameters. Times the training
   step (CUDA-synchronised median of 12 steps after 3 of warm-up),
   subjects/s and peak device memory.
4. The same flagship on the bp fusion layout at batch 16 (G = 8, two
   groups): a 1-epoch ``Trainer`` run on 32 train and 16 val subjects (K1,
   K4, K5 and the four K7 kernels launch, K2/K3 never); serving the 16 val
   subjects, logits against the std layout on the card; one training step
   bp vs std from the same weights, batch and generator state with the
   fusion dropout rates at 0 and DropPath on (loss, every gradient, the
   updated parameters; exactly 48 K7-self and 12 K7-cross launches each
   way); training and predict steps of both layouts timed in turns.
5. The flagship at its shipping policy, ``compute_dtype="bfloat16"``: a
   2-epoch ``Trainer`` run at batch 4 (std layout; exactly K1 mm16 forward
   and backward, K2/K3, K4 and K5 launch), serving its checkpoint (logits
   vs the CPU at the same policy), one training step card vs CPU on std
   (batch 4) and on bp (batch 8), both at a cut depth (2 BERT layers a
   band, one fusion stage of depth 2 a group: the CPU's side at full depth
   took minutes), and the std step at full depth against the port's plain
   twins on the card (``_plain_twins``: every kernel's plain forward and
   backward, float32, TF32 off), each gradient within ``GRAD_REL`` of its
   max-abs plus ``TWIN_ORDER_X`` times its spread over three other sum
   orders of the twins, a fourth order printed beside the kernels as a
   control (the BERTs' printed by layer); a
   1-epoch bp run at batch 16 (exactly K1 mm16, the four K7 bf16 kernels,
   K4 and K5), its serving against the std
   layout; bf16 and float32 training steps timed in turns at batch 4 (std)
   and 16 (std and bp), with peak memory. The bf16 tolerances against
   plain versions and the CPU are stated at their constants.
6. The HCP phase-1 ``TransformerNet`` (22 ROIs x 1200 TRs + CLS, 16 layers,
   2 heads, FFN 3072; every layer on the K6 route) in float32: the same
   four phases on a synthetic HCP cohort (series of 900-1200 TRs, 16 train
   and 8 val subjects, batch 8, 2 epochs), the card-vs-CPU step at
   ``HCP_CPU_LAYERS`` (2) layers (the CPU's side at 16 took 35-50 s on the
   host of an NVIDIA H100 80GB HBM3, 700 W). K6
   forward must launch 16 times
   per forward pass and K6 backward 16 times per backward pass, K5 once
   per step, and no other kernel. Also times the predict step.
7. HCP phase 1 at its default bf16 policy (``compute_dtype`` left at
   ``Config``'s default): K6's bf16 form first alone at HCP shapes (bf16
   q/k/v, dropout 0 and 0.1): the tensor-core kernels against their plain
   versions and, with the CUDA-core form (``attention._K6_SIMT``), against
   a float64 truth (the share of bit-equal bf16 outputs printed), the
   backward twice bitwise equal; timed in turns beside the CUDA-core form
   and ``scaled_dot_product_attention`` on the same bf16 tensors, whose
   backend is printed; bounds with q k^T and dO v^T at the bf16 rate, the
   other products and the exponentials at the float32 rate; then the same
   cohort through a 2-epoch ``Trainer`` run and serving, exactly 16 bf16 K6
   forwards a pass, 16 bf16 K6 backwards and one K5 a step and no float32
   K6; one step card vs CPU at ``HCP_CPU_LAYERS`` layers; float32 and bf16
   steps timed in turns with peak memory.
8. The flagship at its full ``Config`` defaults (bf16 and the ``device``
   FIR gear): the card's band split of the val subjects against the host
   split within 2e-4 and both gears' times; a 1-epoch ``Trainer`` run
   (exactly the bf16 flagship's kernels) and its serving.
9. The flagship and HCP from cohorts on disk (data/synthetic.py writes
   them; the subject index, ``SplitManager`` and ``DataPipeline`` read
   them): 40 ABCD subjects (28 train, 6 val, 6 test), the flagship at its
   full defaults at batch 4 through ``Trainer(cfg).training()`` (1 epoch,
   7 steps, exactly the bf16 flagship's kernels, a best-AUROC
   checkpoint), ``Trainer(cfg, sets=["test"]).testing()`` and
   ``run_predict(cfg)`` (every subject once in ``predictions.csv``, scores
   bit-equal to an in-memory ``Predictor`` on the same arrays); the
   ``native`` gear's bands against the host split within 1e-4 and its
   struct matrices within 2e-3, ``run_predict`` through the native and
   host gears, the three gears' host-side items/s at batch 4 and 16; 16
   HCP subjects served by ``run_predict`` at HCP's defaults from phase 7's
   checkpoint (exactly 16 bf16 K6 forwards a pass); the phase's wall time.
10. The structural phases from a synthetic cohort on disk (40 subjects:
   28 train, 6 val, 6 test), each at its ``Config`` defaults (bf16 policy;
   phase 3 at batch 4 with Adam, phase 6 at batch 8 with AdamW and fusion
   dropout 0.8). First K5 in adam mode (L2 into the gradient) at the
   phase-3 models' parameter counts, with and without clipping, beside
   ``torch.optim.Adam(fused=True)`` and K5 in adamw mode, and K2/K3 at
   dropout 0.8, batch 8, shifts 0 and 3, forward and backward, each
   against its plain version. Then phase 3's ``SwinClassifier`` on sMRI
   (bench #1, ``smri_swin``: 2 epochs), its VAE front on DTI and its UNet
   front on DTI+sMRI (1 epoch each) and phase 6's ``SwinFusionNet`` on the
   sMRI + DTI pair (bench #4, ``swinfusion_struct``: 2 epochs), each
   through ``Trainer(cfg).training()`` (exactly K4 ten times a forward and
   a step's backward, K5 once a step, and for SwinFusionNet the flagship
   backbone's 48 K2 and 12 K3; a best-AUROC checkpoint for the bench
   models; for the one-epoch fronts the run's best checkpoint, or its last
   weights where validation never improved),
   ``Trainer(cfg, sets=["test"]).testing()``, ``run_predict(cfg)`` (equal
   to an in-memory ``Predictor`` on the same batches) and serving its val
   and test subjects (logits vs the CPU at the float32 tolerances: the
   models compute in float32 on bf16-rounded values); for ``smri_swin``
   and ``swinfusion_struct`` one training step card vs CPU (the second's
   backbone at the cut depth of phase 5's), and for ``swinfusion_struct``
   the full-depth step against the plain twins on the card at ``GRAD_REL``.
   DTI and
   DTI+sMRI through the ``native`` gear (matrices vs the host items within
   2e-3, one ``run_predict`` each). Training and predict steps of the four
   models at the phase's batch and at 64, bf16 and float32 in turns, with
   peak memory.
11. The phase chain through the CLI (``cli.main``, ``phase_chain``) on a
   synthetic cohort on disk (40 subjects: 28 train, 6 val, 6 test), each
   step at its phase's defaults: ``--step 3`` trains ``SwinClassifier`` on
   DTI+sMRI; ``--step 5`` trains each of phase 5's five combiners
   (``FuncStructAdd``, ``FuncStructTransfer``, ``FuncStructUNetAdd``,
   ``FuncStructUNetCross`` and ``FuncStructUNetCrossPRS`` with the UNet on
   the struct; batch 8, bf16, AdamW) for one epoch from step 3's
   checkpoint (the copied keys printed), exactly K1 mm16 32 a pass and 32 a
   step, K4 10 and 10, K5 once a step, and K2 48 / K3 12 each way for the
   cross combiners; ``--step 4`` tests ``FuncStructAdd`` from step 3's
   weights; ``--predict_only`` serves the step-5 ``FuncStructAdd``,
   bit-equal to an in-memory ``Predictor``; a step-5 run stopped after
   epoch 1 and resumed equals the 2-epoch run bit for bit. Then one
   training step of each combiner at full depth and float32, kernels
   against their plain twins on the card (loss, every gradient within
   ``GRAD_REL`` of its max-abs, the updated parameters; no launch on the
   twins' side), and the training and predict steps of each at batch 8
   and 64, bf16 and float32 in turns, with peak memory; the phase's wall
   time.
12. Phase 2's fMRI nets (``phase2_nets``): K1 at the ``different``
   ultralow BERT's length (t_valid 129 padded to 136, batch 8; float32
   form training and inference forward and backward, mm16 forward and
   backward) and K5 in adamw mode at the MulT net's and the two-channel
   net's parameter counts, against their plain versions and library
   calls; the chain through the CLI on a synthetic cohort on disk (40
   subjects; series of 350-361 TRs, so the bands' zero-padded ends reach
   the MulT net's pad probe and its readout of the last time step) at
   ``--fmri_type divided_frequency``, each step at its phase's defaults:
   ``--step 1`` trains ``TransformerNet``, ``--step 2`` the MulT net
   (exactly K5 once a step and no other kernel) and the two-channel net
   (K1 mm16 32 a pass and 32 a step, K5 once a step), each chained from
   step 1's best checkpoint (the copied keys printed), ``--step 4`` tests
   each from its step-2 checkpoint, ``--predict_only`` serves the
   two-channel checkpoint bit-equal to an in-memory ``Predictor``; one HCP
   two-channel training step at phase 2's bf16 policy (22 ROIs, 1200 TRs
   + CLS: exactly 32 bf16 K6 forwards, 32 backwards and K5 once); one
   float32 step at full width of the two-channel net against the plain
   twins on the card and of the MulT net (no kernel to twin) against the
   CPU, each at ``GRAD_REL``; both nets' training and predict steps at
   batch 8 and 64, bf16 and float32 in turns, with peak memory (a batch
   that does not fit is timed at half, and why is printed); the phase's
   wall time.
13. The training run's outer shell (``outer_shell``): K1 at the head dims
   ``Config.validate()`` admits beyond the flagship's 7 (hd 21 and 14 at
   T 369, batch 8, every entry timed beside its plain version and
   ``nn.TransformerEncoderLayer``; hd 28 and 84 at batch 4, checked
   only); on the 40-subject cohort through the CLI a 4-trial study of
   step 1 (every trial completed or pruned, exactly the launches its
   drawn depths and batches need, ``best_params.pkl`` with the search
   space's keys), a run on its best parameters and a 4-head run (hd 21),
   exact launches each; step 5's ``FuncStructUNetAdd`` with the UNet
   loss, grad norms every step, ``--profiling`` and ``--profile_dir``
   (exactly 10 train steps, the ``unet`` and ``grad/global`` columns in
   ``full_scores.csv``, a Chrome trace naming the K1, K4 and K5 kernels);
   one full-width float32 ``FuncStructUNetCross`` step with the UNet loss
   against the plain twins at ``GRAD_REL``; a reconstruction loss set
   card vs CPU; the phase's wall time.
14. The flagship's data-parallel step across ranks (``multi_gpu``,
   parallel/mesh.py; full width, bf16 default, std layout): (a) NCCL at
   world size 1 (a launcher's environment, ``RANK=0 WORLD_SIZE=1``): three
   steps at batch 4 bitwise the steps without a process group (cuDNN's
   deterministic algorithms on both sides; parameters,
   K5's moments, losses) with equal launches, then ``--distributed --step
   5`` through the CLI (batch 8, 1 epoch on the 40-subject cohort, exactly
   the flagship's kernels a pass and a step); (b) two ranks on the one card
   under gloo (``bench/dp_step.py`` a rank; NCCL refuses two ranks on one
   device): batch 4 a rank, dropout off, two updates, the ranks'
   parameters bitwise equal and rank 0's within ``MG_REL`` of one process
   with ``accumulation_steps=2`` over the same rows (cuDNN's deterministic
   algorithms on both sides; largest difference printed), each rank's
   launches exact; (c) where the machine has two cards, K5 and K1 on
   ``cuda:1`` tensors with ``cuda:0`` current bitwise their ``cuda:0``
   launches and NCCL across the two as (b) (else printed as not run); the
   all-reduce's time at
   the flagship's K5 buffer under each backend; the phase's wall time.
15. Repeatable steps (``reproducible_steps``, F16): two bf16 flagship
   steps under the ``Trainer`` (which selects cuDNN's deterministic
   algorithms) bitwise equal; the bf16 step at batch 16 and 64 with and
   without those algorithms, timed in turns, and the ratio.
16. The exported serving artifact (``export_phase``, serve/export.py): the
   registered ops' host cost a call beside the direct call (K1 mm16, K4,
   batch 4); the flagship (bf16, std), the flagship (float32, bp) and HCP
   (bf16) exported at full width and depth with their registered ops and
   portable, six worker processes at once, each artifact served in a
   fresh interpreter without a model module (TF32 at torch's defaults):
   scores within ``EXPORT_TOL`` of the live Predictor's and launches a
   batch equal to its, the portable artifacts within the serving
   tolerance and without a launch; sizes, times; the flagship's weights
   mapped from the reference's layout (torch_import) served bitwise; an
   fMRI_image cohort in the native gear equal to the host gear.
17. The count of a step's work (``work_counts``, obs/profiling.py): each
   ``bench.py`` config at full width (the flagship at float32 and bf16 on
   the std layout at batch 4, at float32 on std and at float32 and bf16
   on ``bp`` at batch 8, G 8; ``smri_swin``,
   ``fmri_bert``, ``swinfusion_struct`` and HCP phase 1 at their bf16
   default, batch 4): ``traced_flops`` of one training and one predict
   step on the kernel route (every kernel of the path launched, each
   counted by its formula) equal to the products the same steps run on
   the plain route (every kernel's plain forward on the card, autograd
   through it; ``compiled_cost``, no formula), ``compiled_cost`` of the
   kernel route lower by exactly the kernels' share, the flagship's forms
   equal at one batch; each config's counts per subject printed
   (JAX's analytic flagship estimate, bench.py, beside the flagship's),
   and the phase's wall time. Phase 13's study also runs 4 trials twice,
   the second with trial 1 under a cap on the card's memory: that trial
   fails with ``torch.cuda.OutOfMemoryError``, is recorded as failed, and
   the other trials' objectives and the best parameters equal those of the
   uncapped study's other trials; phase 16's artifacts carry the count of
   a batch (the sidecar's ``flops``, ``graph_flops``), equal to the live
   predict step's ``traced_flops``.
18. Prints one JSON line of per-kernel results (launches by path:
   flagship, flagship_bp, flagship_bf16, flagship_bp_bf16, hcp, hcp_bf16,
   flagship_defaults, flagship_disk, hcp_disk, dot_shapes, smri_swin,
   smri_swin_vae, smri_swin_unet, swinfusion_struct, struct_disk,
   chain_step3, the five combiners' step-5 runs and twin steps,
   chain_step4, chain_predict, and phase 2's phase2_step1, phase2_mult,
   phase2_two_channels, their step-4 runs, phase2_predict,
   phase2_hcp_two_channels, phase2_two_channels_twin_step and
   phase2_mult_step, and the outer shell's outer_shell_study,
   outer_shell_best_params, outer_shell_heads4, outer_shell_unet_profiled
   and outer_shell_unet_cross_twin_step, and the multi-GPU phase's
   multi_gpu_nccl1 (the CLI run), multi_gpu_gloo2_rank0 and _rank1 (and
   multi_gpu_nccl2_rank* on two cards), and the export phase's
   export_flagship_bf16, export_flagship_bp and export_hcp_bf16 (the
   artifacts' launches); K5's and K2/K3's cases on the
   structural paths, K1's at T = 129, at hd 21 and 14 and K5's at phase
   2's sizes under ``path_cases``) and, last, the ok line.

Any failed phase raises, so the exit code is non-zero and no ok line is
printed. Without a CUDA card it exits with code 2 before doing anything;
without the package beside it, it fails at import.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import glob
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from multimodal_neuroimage_tpu_torch.bench import k1_split
from multimodal_neuroimage_tpu_torch.bench.timing import events_ms, graph_ms

SEED = 20261016
BATCH = 4
N_TRAIN, N_VAL = 16, 8
# kernel vs plain version on the card: |got - want| <= ATOL + RTOL * |want|
ATOL, RTOL = 1e-4, 2e-4
# a gradient summed over many rows (weights, biases, LN scales, the bias
# table) is held relative to its tensor's max-abs: both sides add thousands
# of float32 terms in different orders; SUM_ATOL is the floor for a
# gradient that is zero in exact arithmetic (the key bias: softmax ignores a
# shift shared by every key), whose computed value is rounding noise
SUM_REL, SUM_ATOL = 1e-4, 1e-5
# card vs CPU logits / loss of the whole 2x16-layer BERT + 60-block
# SwinFusion + SwinV2 forward: float32 summation-order drift over depth
LOGIT_ATOL, LOGIT_RTOL = 1e-3, 1e-3
# card vs CPU gradients of one training step, per tensor relative to its
# max-abs: the same drift, carried back through the whole depth
GRAD_REL = 1e-2
SOURCES = "multimodal_neuroimage_tpu_torch/csrc/"
TPU = "multimodal_neuroimage_tpu/ops/"
# NVIDIA H100 SXM data sheet: float32 outside the tensor cores, HBM3 rate,
# dense TF32 on the tensor cores
PEAK_F32_OPS, PEAK_BYTES, PEAK_TF32_OPS = 67e12, 3.35e12, 495e12
HCP_BATCH = 8
HCP_CPU_LAYERS = 2   # the HCP card-vs-CPU step's depth (16 at full width)
FLAGSHIP_KERNELS = ("K1 bert_layer", "K2 fusion_block",
                    "K3 cross_fusion_block", "K4 window_attention",
                    "K1 bert_layer backward", "K2 fusion_block backward",
                    "K3 cross_fusion_block backward",
                    "K4 window_attention backward", "K5 fused_adam")
# the flagship on the bp fusion layout: batch 16, two groups of G = 8
BP_BATCH, BP_TRAIN, BP_VAL = 16, 32, 16
# launches of one bp training step: 2 x 16 BERT layers, 48 self blocks, 6
# bidirectional cross blocks (12 directed calls), 10 SwinV2 blocks, K5 once
BP_STEP = {"K1 bert_layer": 32, "K1 bert_layer backward": 32,
           "K7 fusion_block_bp": 48, "K7 fusion_block_bp backward": 48,
           "K7 cross_fusion_block_bp": 12,
           "K7 cross_fusion_block_bp backward": 12,
           "K4 window_attention": 10, "K4 window_attention backward": 10,
           "K5 fused_adam": 1}
# the bf16 policy's kernels (K1 mm16, K7 on bf16 streams) vs their plain
# versions: both round the same operands to bf16, in other orders of float32
# sums, so a value can land on the other side of a bf16 rounding boundary
# (2^-8 relative) and carry that step on: K1's float32 output |err| <=
# ATOL16 + RTOL16 |want|; K7's bf16 outputs (the residual plus a branch that
# carries such a step at the branch's scale, then rounded to bf16) and every
# gradient within REL16 of their tensor's max-abs (the key bias, zero in
# exact arithmetic, at the scale of the key weight's gradient)
ATOL16, RTOL16, REL16 = 1e-2, 2.0 ** -7, 1e-2
# NVIDIA H100 SXM data sheet: dense bf16 on the tensor cores
PEAK_BF16_OPS = 989e12
# the bf16 flagship: the kernels of its std path, and of its bp path
FLAGSHIP16_KERNELS = ("K1 bert_layer mm16", "K1 bert_layer backward mm16",
                      "K2 fusion_block", "K3 cross_fusion_block",
                      "K4 window_attention", "K2 fusion_block backward",
                      "K3 cross_fusion_block backward",
                      "K4 window_attention backward", "K5 fused_adam")
BP16_STEP = {"K1 bert_layer mm16": 32, "K1 bert_layer backward mm16": 32,
             "K7 fusion_block_bp bf16": 48,
             "K7 fusion_block_bp backward bf16": 48,
             "K7 cross_fusion_block_bp bf16": 12,
             "K7 cross_fusion_block_bp backward bf16": 12,
             "K4 window_attention": 10, "K4 window_attention backward": 10,
             "K5 fused_adam": 1}
# card vs CPU at the bf16 policy, whole model: both sides round at the same
# points, but a value one float32 ulp apart can round to neighbouring bf16
# values, and the backbone's near-constant LayerNorm rows amplify those
# steps (tests/test_torch_bf16.py: 7-35% between the JAX package's own bf16
# and float32 gradients). Logits and loss within LOGIT16; each gradient
# within a share of its component's largest gradient
LOGIT16 = 5e-2
GRAD16 = {"swin": 5e-2, "fusion": 0.5, "fmri_embed": 0.5}
# the device FIR gear's bands on the card vs the host split (float64 scipy):
# tests/test_filters.py's bound for the JAX package's gear
FIR_ATOL = 2e-4
# on-disk cohorts written by the port's writer: 40 ABCD subjects (28 train,
# 6 val, 6 test at the default 0.7 / 0.15 split) and 16 HCP subjects; the
# native gear's bands vs the host split within NATIVE_ATOL, its float32
# struct matrices at float16 grain within NATIVE_STRUCT (atol and rtol):
# the JAX package's bounds (tests/test_native_pipeline.py)
DISK_SUBJECTS, DISK_HCP = 40, 16
NATIVE_ATOL, NATIVE_STRUCT = 1e-4, 2e-3
GEAR_BATCHES = (4, 16)
# the structural phases (phase 3's SwinV2 classifier and its VAE and UNet
# fronts, phase 6's SwinFusionNet) from a synthetic cohort on disk of
# DISK_SUBJECTS (28 train, 6 val, 6 test): K4 ten times a SwinV2 forward
# (depths 2 + 2 + 6) and a step's backward, K5 once a step; SwinFusionNet
# adds the flagship backbone's 48 K2 and 12 K3 a forward and a backward.
# Training and predict steps timed at the phase's batch and at 64
# (bench.py's BENCH_PER_CHIP_BATCH default)
SWIN_FORWARD = {"K4 window_attention": 10}
SWIN_BACKWARD = {"K4 window_attention backward": 10}
FUSION_FORWARD = {"K2 fusion_block": 48, "K3 cross_fusion_block": 12,
                  **SWIN_FORWARD}
FUSION_BACKWARD = {"K2 fusion_block backward": 48,
                   "K3 cross_fusion_block backward": 12, **SWIN_BACKWARD}
STRUCT_BENCH_BATCH = 64
# the card-vs-CPU training steps of the fusion models (the bf16 flagship,
# phase 6) at a cut depth: one RSTB / CRSTB of depth 2 a stage group (the
# flagship's widths: C = 12, 6 heads, 6x6 windows over 84x84), and 2 BERT
# layers a band for the flagship; at full depth the CPU's side of these
# steps took minutes
CPU_STEP_DEPTH = dict(fusion_ex_depths=(2,), fusion_depths=(2,),
                      fusion_re_depths=(2,), fusion_ex_heads=(6,),
                      fusion_heads=(6,), fusion_re_heads=(6,))
# card vs CPU gradients of phase 6's step, per tensor relative to its
# max-abs: at dropout 0.8 every kept activation of the 60 fusion blocks is
# scaled by 5 (1 / 0.2, against 1 / 0.9 at the flagship's 0.1), and the
# float32 rounding of the sums over them grows with it
GRAD_REL_DROP8 = 5e-2
# the K4-backward launch-split windows in which the profiler recorded no
# device event at all (each measured again)
EMPTY_WINDOWS = []
# K6's bf16 form vs its plain version: both compute in float32 and round the
# output (or dq/dk/dv) to bf16 once; a float32 sum taken in another order
# can land on the neighbouring bf16 value: forward |err| <= K6_RTOL16 |want|
# + K6_ATOL16 max|want|, gradients within K6_REL16 of their max-abs
K6_RTOL16, K6_ATOL16, K6_REL16 = 2.0 ** -7, 1e-3, 1e-2
# K6's bf16 form (tensor cores, the f32 operand of p v, p^T dO, ds^T q, ds k
# split into bf16 hi + lo) against a float64 truth on the same bf16 inputs:
# out32 within K6_OUT64 max|truth|, dq/dk/dv within K6_GRAD64_RTOL |truth|
# + K6_GRAD64_REL max|truth| (one bf16 rounding and a float32 error;
# tests/test_torch_k6_mma.py holds the CPU model of the split to the same)
K6_OUT64, K6_GRAD64_RTOL, K6_GRAD64_REL = 2.0 ** -14, 2.0 ** -8, 2.0 ** -12
# and each of its gradients' float64 error (as a share of that bound) within
# K6_SIMT_GRAD_MULT times the CUDA-core form's (attention._K6_SIMT, float32
# on the CUDA cores): both are held by the one bf16 rounding, while a bf16 p
# or ds (no lo half) adds its own 8-bit error (tests/test_torch_k6_mma.py)
K6_SIMT_GRAD_MULT = 1.25
# K6's float32 form (3xTF32 tensor cores) against a float64 truth: the worst
# error of out, dq, dk, dv (each relative to its tensor's max-abs) within
# K6_F64_MULT times the CUDA-core form's (attention._K6_SIMT) on the same
# inputs; max over (b, h, d) of |sum_j dk_j|, zero in exact arithmetic,
# within K6_SUM_MULT times the CUDA-core form's or SUM_ATOL, whichever is
# larger (tests/test_torch_cuda.py holds the same)
K6_F64_MULT, K6_SUM_MULT = 4.0, 2.0
# HCP card vs CPU at the bf16 policy: every layer keeps a bf16 stream (no
# float32 stream on the K6 route), so a neighbouring-bf16 step in one
# layer carries through the 16 layers; each gradient within a share of its
# component's largest (measured on an H100: 2.4% for the encoder, 7.1% for
# the 23 values of the head)
GRAD16_HCP = {"transformer": 0.1, "regression_head": 0.25}
# K8 chain vs its plain chain: |got - want| <= REL * max|want|; bf16: a score
# the two summation orders leave on either side of a bf16 rounding boundary
# rounds to neighbouring values before the context product
DOT_REL = {False: 1e-5, True: 5e-3}


@contextlib.contextmanager
def _layout(name: str):
    """Run the SwinFusion stacks in fusion layout ``name`` (std or bp)."""
    from multimodal_neuroimage_tpu_torch.nn import swinfusion
    saved, swinfusion._LAYOUT = swinfusion._LAYOUT, name
    try:
        yield
    finally:
        swinfusion._LAYOUT = saved


def _twin(fwd, bwd, tensors):
    """A kernel's plain forward and its plain backward (``bwd(g, *tensors)``
    returning a gradient for each of ``tensors``) as one autograd node."""
    class Twin(torch.autograd.Function):
        @staticmethod
        def forward(ctx, *ts):
            ctx.save_for_backward(*ts)
            with torch.no_grad():
                return fwd(*ts)

        @staticmethod
        def backward(ctx, g):
            return tuple(bwd(g.contiguous(), *ctx.saved_tensors))

    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return Twin.apply(*tensors)
    with torch.no_grad():
        return fwd(*tensors)


@contextlib.contextmanager
def _plain_twins(slices=None):
    """Within the block the models call each kernel's plain PyTorch twin
    instead of its wrapper, on whatever device their tensors are: K1's
    forward and backward (``bert_layer_reference`` and, mm16,
    ``bert_layer_reference_backward16``), K2/K3's, K4's, and K5
    (``fused_adam_reference``). No kernel launches (the counts stay 0): a
    step on the card in this block is the twins' step, the kernels' oracle
    at full depth. ``slices``: K1's mm16 twin in another order of its
    float32 sums (``bert_layer_model16``: the FFN's F slices added in
    order, the merged q/k/v products), the same roundings to bf16."""
    from multimodal_neuroimage_tpu_torch.nn import bert, swin2d, swinfusion
    from multimodal_neuroimage_tpu_torch.ops import attention as att
    from multimodal_neuroimage_tpu_torch.ops import bert_layer as bl
    from multimodal_neuroimage_tpu_torch.ops import fusion_block as fb
    from multimodal_neuroimage_tpu_torch.ops import fused_update as fu

    def bert_twin(x, params, heads, t_valid, seed=0, rates=(0.0, 0.0),
                  training=False, mm16=False):
        args = (heads, t_valid, seed, rates, training)
        if mm16 and slices:
            def fwd(x_, *ps):
                return bl.bert_layer_model16(x_, ps, *args, slices)

            def bwd(g, x_, *ps):
                r = bl.bert_layer_model_backward16(g, x_, ps, *args, slices)
                return (r["dx"], *r["dparams"])
            return _twin(fwd, bwd, (x, *params))

        def bwd(g, x_, *ps):
            back = (bl.bert_layer_reference_backward16 if mm16
                    else bl.bert_layer_reference_backward)
            dx, dps = back(g, x_, ps, *args)
            return (dx, *dps)
        return _twin(lambda x_, *ps: bl.bert_layer_reference(
            x_, ps, *args, mm16), bwd, (x, *params))

    def self_twin(x, params, bias, mask=None, dp=None, seed=0,
                  rates=(0.0, 0.0), training=False):
        def bwd(g, x_, b, *ps):
            dx, _, db, dps = fb.fusion_block_reference_backward(
                g, x_, None, ps, b, mask, dp, seed, rates, training, False)
            return (dx, db, *dps)
        return _twin(lambda x_, b, *ps: fb.fusion_block_reference(
            x_, ps, b, mask, dp, seed, rates, training), bwd,
            (x, bias, *params))

    def cross_twin(x, y, params, bias, mask=None, dp=None, seed=0,
                   rates=(0.0, 0.0), training=False):
        def bwd(g, x_, y_, b, *ps):
            dx, dy, db, dps = fb.fusion_block_reference_backward(
                g, x_, y_, ps, b, mask, dp, seed, rates, training, True)
            return (dx, dy, db, *dps)
        return _twin(lambda x_, y_, b, *ps: fb.cross_fusion_block_reference(
            x_, y_, ps, b, mask, dp, seed, rates, training), bwd,
            (x, y, bias, *params))

    def k4_twin(q, k, v, bias, mask=None, seed=0, rate=0.0):
        return _twin(lambda *t: att.attention_reference(*t, mask, seed, rate),
                     lambda g, *t: att.attention_reference_backward(
                         g, *t, mask, seed, rate), (q, k, v, bias))

    patches = ((bert, "bert_layer_call", bert_twin),
               (swin2d, "fused_window_attention", k4_twin),
               (swinfusion, "fused_fusion_block", self_twin),
               (swinfusion, "fused_cross_fusion_block", cross_twin),
               (fu, "fused_adam_update", fu.fused_adam_reference))
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    for mod, name, fn in patches:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _close(name: str, got: torch.Tensor, want: torch.Tensor,
           atol: float, rtol: float) -> float:
    err = (got - want).abs()
    bound = atol + rtol * want.abs()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite output")
    if (err > bound).any():
        raise AssertionError(f"{name}: max |err| {err.max().item():.3e} over "
                             f"atol {atol} + rtol {rtol} * |want|")
    return err.max().item()


def _close_rel(name: str, got: torch.Tensor, want: torch.Tensor,
               rel: float, atol: float = SUM_ATOL) -> float:
    """max |got - want| <= rel * max|want| + atol."""
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite output")
    err = (got - want).abs().max().item()
    bound = rel * want.abs().max().item() + atol
    if err > bound:
        raise AssertionError(f"{name}: max |err| {err:.3e} over {bound:.3e} "
                             f"({rel} * max|want| + {atol})")
    return err


def _turns(fns, iters: int = 20):
    """Mean ms of each function, timed in turns (a, b, ..., ..., b, a) on
    one card."""
    order = list(range(len(fns)))
    ms = [0.0] * len(fns)
    for i in order + order[::-1]:
        ms[i] += events_ms(fns[i], iters) / 2
    return ms


def _alternate(kernel, plain, iters: int = 20):
    """Times in turns (plain, kernel, kernel, plain) on one card."""
    plain_ms, ms = _turns([plain, kernel], iters)
    return ms, plain_ms


def _uniform(gen, shape, bound):
    return (torch.rand(shape, generator=gen) * 2 - 1) * bound


def _lin(gen, o, i):
    b = 1.0 / np.sqrt(i)
    return [_uniform(gen, (o, i), b), _uniform(gen, (o,), b)]


def _ln(gen, c):
    return [1 + 0.1 * torch.randn(c, generator=gen),
            0.1 * torch.randn(c, generator=gen)]


def _plain_backward(fwd, inputs, g):
    """The plain backward alone: autograd through the plain forward,
    graph built once (retained), so that timing it leaves the forward
    out."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_() for t in inputs]
        out = fwd(*ins)
    return ins, lambda: torch.autograd.grad(out, ins, g, retain_graph=True)


def _nbytes(*tensors) -> int:
    """Bytes of the tensors (None skipped)."""
    return sum(t.element_size() * t.numel() for t in tensors
               if t is not None)


def _bound(ops: float, nbytes: float):
    """Least time (ms) the card could take: the larger of the operations
    over the f32 peak and the bytes (each input read once, each output
    written once) over the memory rate; and which of the two it is."""
    t_ops, t_bytes = ops / PEAK_F32_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# Operations counted: 2 per multiply-add of the products and 1 per
# exponential; a backward as twice its forward's products (the least that
# its gradients need, with no recomputation).
def _bert_ops(B, T, H, heads, F_):
    return (2 * B * T * (4 * H * H + 2 * H * F_) + 4 * B * T * T * H,
            B * heads * T * T)


def _bound16(prod_ops: float, exp_ops: float, nbytes: float):
    """_bound for the bf16 policy's kernels: products of bf16 operands at
    the bf16 tensor rate, exponentials at the float32 rate."""
    t_ops = (prod_ops / PEAK_BF16_OPS + exp_ops / PEAK_F32_OPS) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _fusion_ops(B, nW, N, C, heads):
    return (2 * B * nW * N * 12 * C * C + 4 * B * nW * N * N * C,
            B * nW * heads * N * N)


def _attention_ops(q):
    *lead, N, D = q.shape
    bh = int(np.prod(lead))
    return 4 * bh * N * N * D, bh * N * N


class Results:
    """Per-kernel max error, times and bounds, summed over its cases."""

    def __init__(self):
        self.rows = {}

    def add(self, key, source, replaces, err, ms, plain_ms, ops, nbytes,
            library_ms=None, std_ms=None, bound=None, device_ms=None,
            library_device_ms=None, f32_ms=None, simt_ms=None):
        """One case of a kernel; ``bound`` (ms, by) replaces the float32
        bound of ``ops`` and ``nbytes`` (K8's bf16 cases, the bf16 policy's
        kernels)."""
        timed = ("library", "std", "device", "library_device", "f32",
                 "simt")
        r = self.rows.setdefault(key, {"name": key, "route": "cuda",
                                       "source": source,
                                       "replaces": replaces,
                                       "max_abs_err": 0.0, "ms": 0.0,
                                       "plain_ms": 0.0, "bound_ms": 0.0,
                                       "bound_by": None, "worst_bound": -1.0,
                                       "cases": 0,
                                       **{f"{n}_ms": 0.0 for n in timed},
                                       **{f"{n}_cases": 0 for n in timed}})
        bound, by = bound or _bound(ops, nbytes)
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["ms"] += ms
        r["plain_ms"] += plain_ms
        r["bound_ms"] += bound
        if bound > r["worst_bound"]:
            r["worst_bound"], r["bound_by"] = bound, by
        for name, t in zip(timed, (library_ms, std_ms, device_ms,
                                   library_device_ms, f32_ms, simt_ms)):
            if t is not None:
                r[f"{name}_ms"] += t
                r[f"{name}_cases"] += 1
        r["cases"] += 1
        return bound, by

    def path_case(self, key, path, label, err, ms, plain_ms, ops, nbytes,
                  library_ms=None, bound=None, **extra):
        """One case of a kernel in a mode, at a rate or at a shape that its
        other cases do not run (K5's adam mode, K2/K3 at dropout 0.8, K1 at
        T = 129), kept apart from its averages under ``path_cases[path]``;
        ``bound`` (ms, by) replaces the float32 bound of ``ops`` and
        ``nbytes``; returns (bound ms, by)."""
        bound, by = bound or _bound(ops, nbytes)
        self.rows[key].setdefault("path_cases", {}).setdefault(
            path, []).append({"case": label, "max_abs_err": err, "ms": ms,
                              "plain_ms": plain_ms, "bound_ms": bound,
                              "bound_by": by, "library_ms": library_ms,
                              **extra})
        return bound, by

    def line(self, key, launches):
        """The kernel's entry of the JSON line (times averaged over its
        cases)."""
        r = self.rows[key]
        n = r["cases"]

        def mean(name):
            c = r[f"{name}_cases"]
            return r[f"{name}_ms"] / c if c else None
        return {"name": key, "route": r["route"], "source": r["source"],
                "replaces": r["replaces"],
                "launches": sum(c.get(key, 0) for c in launches.values()),
                "launches_by_path": {p: c.get(key, 0)
                                     for p, c in launches.items()},
                "max_abs_err": r["max_abs_err"], "ms": r["ms"] / n,
                "plain_ms": r["plain_ms"] / n, "bound_ms": r["bound_ms"] / n,
                "bound_by": r["bound_by"], "library_ms": mean("library"),
                # K2/K3 (the batch-4 inference), K4 and K8 only: device
                # time, kernel and library
                "device_ms": mean("device"),
                "library_device_ms": mean("library_device"),
                # K7 only: K2/K3 on the same inputs in the std layout
                "std_layout_ms": mean("std"),
                # K7's bf16 form: K7 on float32 streams, same inputs
                "f32_form_ms": mean("f32"),
                # K1 and K6 float32: float64 errors of the tensor-core and
                # the CUDA-core route; K6 also max |sum_j dk_j| of each
                **{k: r[k] for k in ("float64_rel_err",
                                     "simt_float64_rel_err", "sum_dk",
                                     "simt_sum_dk") if k in r},
                # K6's two forms: the CUDA-core form on the same inputs and
                # the rates the bound counts; the bf16 form also both forms'
                # worst float64 error (as a share of its bound) and the
                # backend scaled_dot_product_attention took
                "simt_form_ms": mean("simt"),
                **{k: r[k] for k in ("float64_share", "simt_float64_share",
                                     "bound_rates", "bound_ms_f32_rate",
                                     "library_backend", "path_cases")
                   if k in r}}


def _report(res, key, label, err, ms, plain_ms, ops, nbytes, src, rep,
            library_ms=None, tol=f"atol {ATOL} + rtol {RTOL}", std_ms=None,
            bound=None, device=None, f32_ms=None, simt_ms=None):
    """Record and print one case; ``rep`` is the TPU kernel's file:line
    under ``TPU``, or from the repository root where it has a ``/``;
    ``device``: (kernel, library or None, method) device times."""
    dev_ms, lib_dev_ms, method = device or (None, None, None)
    bound, by = res.add(key, SOURCES + src, rep if "/" in rep else TPU + rep,
                        err, ms, plain_ms, ops, nbytes, library_ms, std_ms,
                        bound, dev_ms, lib_dev_ms, f32_ms, simt_ms)
    lib = ("" if library_ms is None
           else f"  library {library_ms:.4f} ms")
    std = "" if std_ms is None else f"  std layout (K2/K3) {std_ms:.4f} ms"
    if f32_ms is not None:
        std += f"  float32 streams {f32_ms:.4f} ms"
    if simt_ms is not None:
        std += f"  CUDA-core form {simt_ms:.4f} ms"
    dev = ("" if device is None else
           f"  device ({method}): kernel {dev_ms:.4f} ms" + (
               "" if lib_dev_ms is None else f", library {lib_dev_ms:.4f} ms"))
    print(f"{key} {label}: max|err| {err:.3e} ({tol})  kernel {ms:.4f} ms  "
          f"plain {plain_ms:.4f} ms  bound {bound:.6f} ms ({by}){lib}{std}"
          f"{dev}")


def forward_kernels(gen, res: Results):
    """K2-K4 forward against their plain versions, beside the one PyTorch
    call that computes the same function where there is one: K4
    ``scaled_dot_product_attention`` with bias + mask as ``attn_mask``
    (K1's forward: :func:`k1_forward_kernels`). K2/K3 at batch 4, 16 and
    64, each as inference
    and as the training forward with its saved x2r held too (the plain
    block with fc2 zeroed is x2r); the batch-4 inference (the serving
    shape) and K4 also with their device times."""
    from multimodal_neuroimage_tpu_torch.nn.swin2d import shift_attn_mask
    from multimodal_neuroimage_tpu_torch.ops import attention as att
    from multimodal_neuroimage_tpu_torch.ops import fusion_block as fb
    sdpa = torch.nn.functional.scaled_dot_product_attention
    dev = "cuda"
    cases = []

    def case(key, label, kernel, plain, src, rep, ops, nbytes, library=None,
             x2r=None, device=False):
        """``x2r``: the plain x2r where ``kernel`` returns (out, x2r);
        ``device``: time the call's device work too."""
        cases.append((key, label, kernel, plain, src, rep, ops, nbytes,
                      library, x2r, device))
    C, Hh, N, nW = 12, 6, 36, 196
    self_p, cross_p, bias, xw, yw = _fusion_inputs(gen)
    # batch 4 is the flagship's; at 16 and 64 the multi-window forward's
    # work items (several subjects' windows of one position) fill the card
    for B in (BATCH, 16, 64):
        xb, yb = ((xw, yw) if B == BATCH else
                  (torch.randn(B, nW, N, C, generator=gen).to(dev)
                   for _ in "xy"))
        dp = ((torch.rand(B, 2, generator=gen) > 0.1).float() / 0.9).to(dev)
        train = (dp, 4321, (0.1, 0.1), True)
        fops = sum(_fusion_ops(B, nW, N, C, Hh))
        for shift in (0, 3):
            m = shift_attn_mask(84, 84, 6, shift)
            mask = None if m is None else torch.from_numpy(m).to(dev)
            for cross, key, p_ in ((False, "K2 fusion_block", self_p),
                                   (True, "K3 cross_fusion_block", cross_p)):
                y_ = yb if cross else None
                no_fc2 = p_[:-2] + tuple(torch.zeros_like(t) for t in p_[-2:])
                if cross:
                    def infer(x_=xb, y_=y_, p_=p_, mask=mask):
                        return fb.fused_cross_fusion_block(x_, y_, p_, bias,
                                                           mask)

                    def plain(x_=xb, y_=y_, p_=p_, mask=mask):
                        return fb.cross_fusion_block_reference(x_, y_, p_,
                                                               bias, mask)
                else:
                    def infer(x_=xb, p_=p_, mask=mask):
                        return fb.fused_fusion_block(x_, p_, bias, mask)

                    def plain(x_=xb, p_=p_, mask=mask):
                        return fb.fusion_block_reference(x_, p_, bias, mask)
                case(key, f"inference B {B} shift {shift}", infer, plain,
                     "fusion_block.cu", "fusion_block.py:855", fops,
                     _nbytes(xb, y_, xb, bias, mask, *p_),
                     device=B == BATCH)
                case(key, f"training B {B} shift {shift}",
                     lambda x_=xb, y_=y_, p_=p_, mask=mask, cross=cross,
                         t=train: fb._launch_forward(x_, y_, p_, bias, mask,
                                                     *t, True, cross),
                     lambda x_=xb, y_=y_, p_=p_, mask=mask, cross=cross,
                         t=train: fb._block_reference(x_, y_, p_, bias, mask,
                                                      *t, cross),
                     "fusion_block.cu", "fusion_block.py:855", fops,
                     _nbytes(xb, y_, xb, xb, bias, mask, dp, *p_),
                     x2r=lambda x_=xb, y_=y_, p_=no_fc2, mask=mask,
                         cross=cross, t=train: fb._block_reference(
                             x_, y_, p_, bias, mask, *t, cross))
    for args, rate in ((a, r) for a in _k4_inputs(gen, BATCH)
                       for r in (0.0, 0.1)):
        q4, k4, v4, b4, m4 = args[:5]
        B_, nw4, heads4, N4, D4 = q4.shape
        full = b4[None] + (0.0 if m4 is None else m4[:, None])
        full = full.expand(B_, *full.shape).reshape(B_ * nw4, heads4, N4,
                                                    N4).contiguous()
        flat = [t.reshape(B_ * nw4, heads4, N4, D4) for t in (q4, k4, v4)]
        # with dropout the library call computes another function: none;
        # at rate 0 SDPA on the materialised bias + mask (what the kernel
        # reads), no mask arithmetic timed
        library = (None if rate else
                   lambda f=flat, m=full: sdpa(*f, attn_mask=m, scale=1.0))
        # K4 is a few microseconds of device work a call: its device time
        # beside the call time, which measures the host's enqueue
        case("K4 window_attention", f"{args[-1]} rate {rate}",
             lambda a=args, r=rate: att.fused_window_attention(*a[:5], 515, r),
             lambda a=args, r=rate: att.attention_reference(*a[:5], 515, r),
             "window_attention.cu", "attention.py:305",
             sum(_attention_ops(q4)), _nbytes(q4, k4, v4, q4, b4, m4),
             library, device=True)
    for (key, label, kernel, plain, src, rep, ops, nbytes, library, x2r,
         device) in cases:
        got, want = kernel(), plain()
        if x2r is not None:
            got, got_x2r = got
        torch.cuda.synchronize()
        err = _close(f"{key} {label}", got, want, ATOL, RTOL)
        if x2r is not None:
            err = max(err, _close(f"{key} {label} x2r", got_x2r, x2r(),
                                  ATOL, RTOL))
        ms, plain_ms, lib_ms = _call_times(kernel, plain, library)
        _report(res, key, label, err, ms, plain_ms, ops, nbytes, src, rep,
                lib_ms, device=_device_pair(kernel, library) if device
                else None)


def _call_times(kernel, plain, library=None, iters: int = 20):
    """(kernel, plain, library or None) call times in turns on one card:
    plain, kernel, library, library, kernel, plain."""
    if library is None:
        return (*_alternate(kernel, plain, iters), None)
    plain_ms, ms, lib_ms = _turns([plain, kernel, library], iters)
    return ms, plain_ms, lib_ms


def _device_pair(kernel, library=None, stream=None):
    """(kernel, library or None, method) device times of one call."""
    k_ms, k_how = graph_ms(kernel)
    if library is None:
        return k_ms, None, k_how
    l_ms, l_how = graph_ms(library, stream=stream)
    return k_ms, l_ms, k_how if k_how == l_how else f"{k_how} / {l_how}"


def _encoder_layer(p, H, heads, F_):
    """torch's own post-LN encoder layer carrying K1's weights, dropout 0:
    the library call K1 is timed against (forward in eval under no_grad,
    backward in train through autograd)."""
    layer = torch.nn.TransformerEncoderLayer(
        H, heads, F_, dropout=0.0, activation="gelu", layer_norm_eps=1e-12,
        batch_first=True, norm_first=False).cuda()
    wq, bq, wk, bk, wv, bv, wo, bo, g1, b1, w1, b1m, w2, b2m, g2, b2 = p
    with torch.no_grad():
        for dst, src in ((layer.self_attn.in_proj_weight,
                          torch.cat([wq, wk, wv])),
                         (layer.self_attn.in_proj_bias,
                          torch.cat([bq, bk, bv])),
                         (layer.self_attn.out_proj.weight, wo),
                         (layer.self_attn.out_proj.bias, bo),
                         (layer.norm1.weight, g1), (layer.norm1.bias, b1),
                         (layer.linear1.weight, w1),
                         (layer.linear1.bias, b1m),
                         (layer.linear2.weight, w2),
                         (layer.linear2.bias, b2m),
                         (layer.norm2.weight, g2), (layer.norm2.bias, b2)):
            dst.copy_(src)
    return layer


def _fusion_inputs(gen):
    C, Hh, N, nW = 12, 6, 36, 196
    dev = "cuda"
    self_p = tuple(t.to(dev) for t in _ln(gen, C) + _lin(gen, 3 * C, C)
                   + _lin(gen, C, C) + _ln(gen, C) + _lin(gen, 4 * C, C)
                   + _lin(gen, C, 4 * C))
    cross_p = tuple(t.to(dev) for t in _ln(gen, C) + _ln(gen, C)
                    + _lin(gen, C, C) + _lin(gen, 2 * C, C) + _lin(gen, C, C)
                    + _ln(gen, C) + _lin(gen, 4 * C, C) + _lin(gen, C, 4 * C))
    bias = (0.5 * torch.randn(Hh, N, N, generator=gen)).to(dev)
    xw = torch.randn(BATCH, nW, N, C, generator=gen).to(dev)
    yw = torch.randn(BATCH, nW, N, C, generator=gen).to(dev)
    return self_p, cross_p, bias, xw, yw


def _sdpa_window(q, k, v, bias, mask):
    """K4's function at rate 0 in one ``scaled_dot_product_attention``
    call over (B * nW, H, N, D), bias + mask as its ``attn_mask``."""
    B_, nw, heads, N, D = q.shape
    full = bias[None] + (0.0 if mask is None else mask[:, None])
    full = full.expand(B_, nw, heads, N, N).reshape(B_ * nw, heads, N, N)
    out = torch.nn.functional.scaled_dot_product_attention(
        *(t.reshape(B_ * nw, heads, N, D) for t in (q, k, v)),
        attn_mask=full, scale=1.0)
    return out.reshape(q.shape)


def _k4_inputs(gen, B):
    """The SwinV2 head's three stages at batch B: (q, k, v, bias, mask,
    label)."""
    from multimodal_neuroimage_tpu_torch.nn.swin2d import shift_attn_mask
    out = []
    for N4, res, heads, shift in ((36, 12, 3, 3), (36, 6, 6, 0),
                                  (9, 3, 12, 0)):
        ws = int(np.sqrt(N4))
        nw4 = (res // ws) ** 2
        shape = (B, nw4, heads, N4, 4)
        q = torch.nn.functional.normalize(
            torch.randn(shape, generator=gen), dim=-1) * 10.0
        k = torch.nn.functional.normalize(torch.randn(shape, generator=gen),
                                          dim=-1)
        v = torch.randn(shape, generator=gen)
        b4 = 16 * torch.sigmoid(torch.randn(heads, N4, N4, generator=gen))
        m = shift_attn_mask(res, res, ws, shift)
        mask = None if m is None else torch.from_numpy(m).cuda()
        out.append(tuple(t.cuda() for t in (q, k, v, b4)) + (
            mask, f"N{N4} nW{nw4} heads{heads}"))
    return out


def backward_kernels(gen, res: Results, n_params: int):
    """K1-K4 backward (dropout on) and K5 against their plain versions."""
    from multimodal_neuroimage_tpu_torch.nn.swin2d import shift_attn_mask
    from multimodal_neuroimage_tpu_torch.ops import attention as att
    from multimodal_neuroimage_tpu_torch.ops import bert_layer as bl
    from multimodal_neuroimage_tpu_torch.ops import fusion_block as fb
    from multimodal_neuroimage_tpu_torch.ops import fused_update as fu
    dev = "cuda"
    rates, seed = (0.1, 0.1), 12345

    def report(key, label, errs, kernel, plain, src, rep, ops, nbytes,
               library=None, device=None, bound=None):
        ms, plain_ms, lib_ms = _call_times(kernel, plain, library, 10)
        _report(res, key, label, max(errs), ms, plain_ms, ops, nbytes, src,
                rep, lib_ms, tol=f"dx/dy: atol {ATOL} + rtol {RTOL}; sums: "
                                 f"{SUM_REL} * max|ref| + {SUM_ATOL}",
                device=device, bound=bound)
        return ms

    # K1: B 4 x T 369 x H 84, 12 heads, F 3072
    H, F_, T = 84, 3072, 369
    p = tuple(t.to(dev) for t in (_lin(gen, H, H) + _lin(gen, H, H)
                                  + _lin(gen, H, H) + _lin(gen, H, H)
                                  + _ln(gen, H) + _lin(gen, F_, H)
                                  + _lin(gen, H, F_) + _ln(gen, H)))
    x = torch.randn(BATCH, T, H, generator=gen).to(dev)
    g = torch.randn(BATCH, T, H, generator=gen).to(dev)
    _, resid = bl._launch_forward(x, p, 12, T, seed, rates, True, True)

    def k1():
        return bl.bert_layer_backward(g, x, p, resid, 12, T, seed, rates,
                                      True)

    dx, dps = k1()
    ins, plain = _plain_backward(
        lambda x_, *p_: bl.bert_layer_reference(x_, p_, 12, T, seed, rates,
                                                True), (x,) + p, g)
    want = plain()
    torch.cuda.synchronize()
    errs = [_close("K1 backward dx", dx, want[0], ATOL, RTOL)]
    errs += [_close_rel(f"K1 backward dparams[{i}]", a, b, SUM_REL)
             for i, (a, b) in enumerate(zip(dps, want[1:]))]
    # the library call: autograd through torch's encoder layer (train,
    # dropout 0) on the same weights, graph built once
    layer = _encoder_layer(p, H, 12, F_).train()
    with torch.enable_grad():
        xl = x.detach().requires_grad_()
        ins, out = [xl] + list(layer.parameters()), layer(xl)
    report("K1 bert_layer backward", "", errs, k1, plain, "bert_layer.cu",
           "bert_layer.py:1008", 2 * _bert_ops(BATCH, T, H, 12, F_)[0],
           _nbytes(x, g, x, *p, *p),
           lambda: torch.autograd.grad(out, ins, g, retain_graph=True),
           bound=_k1_backward_bound(BATCH, x, g, p))
    del layer, ins, out
    k1_float64_check(res, x, g, p, resid, seed, rates)
    k1_batch16(gen, p, seed, rates)

    # K2 / K3: B 4 x 196 windows x 36 x 12, 6 heads, dropout and DropPath
    self_p, cross_p, bias, xw, yw = _fusion_inputs(gen)
    fops = 2 * _fusion_ops(BATCH, 196, 36, 12, 6)[0]
    gw = torch.randn(xw.shape, generator=gen).to(dev)
    dp = (torch.rand(BATCH, 2, generator=gen) > 0.1).float().to(dev) / 0.9
    for shift in (0, 3):
        m = shift_attn_mask(84, 84, 6, shift)
        mask = None if m is None else torch.from_numpy(m).to(dev)
        for cross, params in ((False, self_p), (True, cross_p)):
            key = ("K3 cross_fusion_block backward" if cross
                   else "K2 fusion_block backward")
            _, x2r = fb._launch_forward(xw, yw if cross else None, params,
                                        bias, mask, dp, seed, rates, True,
                                        True, cross)
            if cross:
                def kern(params=params, mask=mask, x2r=x2r):
                    return fb.fused_cross_fusion_block_backward(
                        gw, xw, yw, params, bias, mask, dp, seed, rates, True,
                        x2r)
                got = kern()
                ins, plain = _plain_backward(
                    lambda x_, y_, b_, *p_, mask=mask:
                        fb.cross_fusion_block_reference(
                            x_, y_, p_, b_, mask, dp, seed, rates, True),
                    (xw, yw, bias) + params, gw)
                want = plain()
                torch.cuda.synchronize()
                errs = [_close(f"{key} dx", got[0], want[0], ATOL, RTOL),
                        _close(f"{key} dy", got[1], want[1], ATOL, RTOL),
                        _close_rel(f"{key} dbias", got[2], want[2], SUM_REL)]
                grads = got[3]
            else:
                def kern(params=params, mask=mask, x2r=x2r):
                    return fb.fused_fusion_block_backward(
                        gw, xw, params, bias, mask, dp, seed, rates, True,
                        x2r)
                got = kern()
                ins, plain = _plain_backward(
                    lambda x_, b_, *p_, mask=mask: fb.fusion_block_reference(
                        x_, p_, b_, mask, dp, seed, rates, True),
                    (xw, bias) + params, gw)
                want = [None] + list(plain())
                torch.cuda.synchronize()
                errs = [_close(f"{key} dx", got[0], want[1], ATOL, RTOL),
                        _close_rel(f"{key} dbias", got[1], want[2], SUM_REL)]
                grads = got[2]
            errs += [_close_rel(f"{key} dparams[{i}]", a, b, SUM_REL)
                     for i, (a, b) in enumerate(zip(grads, want[3:]))]
            streams = (xw, yw) if cross else (xw,)
            report(key, f"shift {shift}", errs, kern, plain,
                   "fusion_block.cu", "fusion_block.py:905", fops,
                   _nbytes(*streams, *streams, gw, dp, mask, bias, bias,
                           *params, *params))

    # K4: the SwinV2 head's three stages at batch 4, 16 and 64, attention
    # dropout 0 and 0.1: one launch a call (torch.profiler), two calls
    # bitwise equal (dbias too), the last blocks' counters left at zero;
    # the gradients at g 2^-20 bitwise 2^-20 times those at g (a sum whose
    # accuracy does not depend on the gradient's size), and a NaN in g
    # giving NaN where the plain version has it
    k4_batch4 = []
    for B in (BATCH, BP_BATCH, 64):
        for (q, k, v, b4, mask, label), rate in (
                (a, r) for a in _k4_inputs(gen, B) for r in (0.0, 0.1)):
            out = att.fused_window_attention(q, k, v, b4, mask, seed, rate)
            g4 = torch.randn(q.shape, generator=gen).to(dev)

            def kern(q=q, k=k, v=v, b4=b4, mask=mask, out=out, g4=g4,
                     rate=rate):
                return att.window_attention_backward(g4, q, k, v, b4, mask,
                                                     out, seed, rate)

            got, again = kern(), kern()
            ins, plain = _plain_backward(
                lambda q_, k_, v_, b_, mask=mask, rate=rate:
                    att.attention_reference(q_, k_, v_, b_, mask, seed, rate),
                (q, k, v, b4), g4)
            want = plain()
            torch.cuda.synchronize()
            tag = f"B {B} {label} rate {rate}"
            errs = [_close(f"K4 backward d{n} {tag}", a, b, ATOL, RTOL)
                    for n, a, b in zip("qkv", got[:3], want[:3])]
            # the floor of a sum that is zero in exact arithmetic grows with
            # the windows it adds (batch 4's at SUM_ATOL)
            errs.append(_close_rel(f"K4 backward dbias {tag}", got[3],
                                   want[3], SUM_REL, SUM_ATOL * B / BATCH))
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"K4 backward {tag}: two calls differ")
            tiny = att.window_attention_backward(
                g4 * 2.0 ** -20, q, k, v, b4, mask, out, seed, rate)
            if not all(torch.equal(a * 2.0 ** -20, b)
                       for a, b in zip(got, tiny)):
                raise AssertionError(f"K4 backward {tag}: not bitwise "
                                     f"scale-invariant at g 2^-20")
            gn = g4.clone()
            gn[-1, 0, 0, 2, 1] = float("nan")
            nan_got = att.window_attention_backward(gn, q, k, v, b4, mask,
                                                    out, seed, rate)
            nan_want = att.attention_reference_backward(gn, q, k, v, b4,
                                                        mask, seed, rate)
            if not (nan_got[3].isnan().any() and all(
                    torch.equal(a.isnan(), b.isnan())
                    for a, b in zip(nan_got, nan_want))):
                raise AssertionError(f"K4 backward {tag}: a NaN in g does "
                                     f"not reach the gradients as in the "
                                     f"plain version")
            # one kernel, launched once a call (the profiler can drop the
            # first event of a window: 9 of 10 calls read 0.9)
            split = k1_split.launch_split(kern)
            if not split:
                # the profiler recorded no device event at all (seen once
                # on an H100 at B 64): nothing was measured, measure again,
                # and count it (printed after the K4 cases)
                EMPTY_WINDOWS.append(f"K4 backward {tag}")
                split = k1_split.launch_split(kern)
            launched = sum(n for n, _ in split.values())
            if (len(split) != 1 or round(launched) != 1
                    or att._K4_COUNTERS[q.device].any()):
                raise AssertionError(f"K4 backward {tag}: {split} (expected "
                                     f"one kernel, once a call) or its "
                                     f"counters not reset")
            library, side = None, None
            if not rate:
                # autograd through SDPA with the mask built in the graph from
                # bias (expanded) + mask, so that dbias is among its
                # gradients; built on a side stream, where its backward is
                # then captured
                side = torch.cuda.Stream()
                side.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(side):
                    _, library = _plain_backward(
                        lambda q_, k_, v_, b_, mask=mask: _sdpa_window(
                            q_, k_, v_, b_, mask), (q, k, v, b4), g4)
                torch.cuda.current_stream().wait_stream(side)
            ms = report("K4 window_attention backward", tag, errs, kern,
                        plain, "window_attention.cu", "attention.py:332",
                        2 * _attention_ops(q)[0],
                        _nbytes(q, k, v, g4, mask, b4, q, k, v, b4), library,
                        _device_pair(kern, library, side))
            if B == BATCH:
                k4_batch4.append(ms)
    print(f"K4 backward launch splits: {len(EMPTY_WINDOWS)} profiler "
          f"window(s) with no device event, measured again: "
          f"{EMPTY_WINDOWS}")
    # the flagship's step (batch 4) calls each stage's backward at its rate
    res.rows["K4 window_attention backward"]["batch4_ms"] = (
        sum(k4_batch4) / len(k4_batch4))

    # K5 over the flagship's parameter count, AdamW with clipping
    pk, gk, mk = (torch.randn(n_params, generator=gen).to(dev)
                  for _ in range(3))
    nk = torch.rand(n_params, generator=gen).to(dev)
    clip = torch.tensor([0.5], device=dev)
    state = [t.clone() for t in (pk, mk, nk)]
    args = (clip, 1e-3, 10.0, 1000.0, 0.9, 0.999, 1e-8, 1e-5, True)
    fu.fused_adam_update(pk, gk, mk, nk, *args)
    fu.fused_adam_reference(state[0], gk, state[1], state[2], *args)
    torch.cuda.synchronize()
    errs = [_close(f"K5 {n}", a, b, ATOL, RTOL)
            for n, a, b in zip(("p", "mu", "nu"), (pk, mk, nk), state)]
    # the library call: torch's fused AdamW over one flat parameter (no
    # clipping: torch.optim has none inside the step)
    flat = torch.nn.Parameter(pk.clone())
    flat.grad = gk.clone()
    adamw = torch.optim.AdamW([flat], lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                              weight_decay=1e-5, fused=True)
    # ~16 operations an element; p, g, mu, nu read, p, mu, nu written
    report("K5 fused_adam", f"{n_params} params", errs,
           lambda: fu.fused_adam_update(pk, gk, mk, nk, *args),
           lambda: fu.fused_adam_reference(state[0], gk, state[1], state[2],
                                           *args),
           "fused_update.cu", "fused_update.py:106", 16 * n_params,
           7 * 4 * n_params, adamw.step)


def _k1_backward_bound(B, x, g, p, T=369, H=84, F_=3072):
    """K1 backward's bound on its route: the products (twice the forward's)
    as 3xTF32, three TF32 products each at the dense TF32 tensor-core peak,
    the rest of the attention on the CUDA cores at the f32 peak; beside
    the bytes. (ms, by)."""
    dense = 2 * 2 * B * T * (4 * H * H + 2 * H * F_)
    attention = 2 * 4 * B * T * T * H
    t_ops = (3 * dense / PEAK_TF32_OPS + attention / PEAK_F32_OPS) * 1e3
    t_bytes = _nbytes(x, g, x, *p, *p) / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _k1_forward_bound(B, nbytes, T=369, H=84, heads=12, F_=3072):
    """K1 forward's bound on its route: the dense products as 3xTF32, three
    TF32 products each at the dense TF32 tensor-core peak, the attention's
    products and exponentials on the CUDA cores at the f32 peak; beside the
    bytes. (ms, by)."""
    dense = 2 * B * T * (4 * H * H + 2 * H * F_)
    prod, exps = _bert_ops(B, T, H, heads, F_)
    t_ops = (3 * dense / PEAK_TF32_OPS
             + (prod - dense + exps) / PEAK_F32_OPS) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def k1_forward_kernels(gen, res: Results):
    """K1's float32 forward (every dense product on 3xTF32 tensor cores) at
    batch 4, 16 and 64 (T 369, H 84, 12 heads, F 3072): the training
    forward (dropout 0.1) with every saved residual and the inference
    forward against their plain versions (plain products, TF32 off), two
    training calls bitwise equal; beside ``nn.TransformerEncoderLayer``
    (post-LN, erf-GELU, eps 1e-12) in eval on the same weights, the one
    PyTorch call that computes the layer; bounds on its route (3xTF32) and
    with every product at the f32 rate; its device scratch beside the
    yardstick's. Then, at batch 4, its float64 error against the forward on
    float32 FMAs (``_GEMM_SIMT``): within 4x."""
    from multimodal_neuroimage_tpu_torch.ops import bert_layer as bl
    from multimodal_neuroimage_tpu_torch.ops import build
    H, F_, T, heads = 84, 3072, 369, 12
    rates, seed = (0.1, 0.1), 24680
    p = tuple(t.cuda() for t in (_lin(gen, H, H) + _lin(gen, H, H)
                                 + _lin(gen, H, H) + _lin(gen, H, H)
                                 + _ln(gen, H) + _lin(gen, F_, H)
                                 + _lin(gen, H, F_) + _ln(gen, H)))
    key, f32_bounds = "K1 bert_layer", []
    for B in (BATCH, BP_BATCH, 64):
        x = torch.randn(B, T, H, generator=gen).cuda()
        encoder = _encoder_layer(p, H, heads, F_).eval()

        @torch.no_grad()
        def library(encoder=encoder, x=x):
            return encoder(x)

        def train(x=x):
            return bl._launch_forward(x, p, heads, T, seed, rates, True, True)

        def plain_train(x=x):
            return bl.bert_layer_reference_parts(x, p, heads, T, seed, rates,
                                                 True)

        def infer(x=x):
            return bl.bert_layer_call(x, p, heads, T)

        def plain_infer(x=x):
            return bl.bert_layer_reference(x, p, heads, T)
        (out, resid), again, want = train(), train(), plain_train()
        torch.cuda.synchronize()
        err = _close(f"K1 forward B {B} out", out, want["out"], ATOL, RTOL)
        for name, got in bl.resid_parts(resid, B, T, H, heads).items():
            err = max(err, _close(f"K1 forward B {B} {name}", got,
                                  want[name], ATOL, RTOL))
        if not (torch.equal(out, again[0]) and torch.equal(resid, again[1])):
            raise AssertionError(f"K1 forward B {B}: two training calls "
                                 f"differ")
        tc_b, simt_b = (4 * build.library().value(n, B, T, H, F_) for n in (
            "bert_layer_scratch_floats", "bert_layer_scratch_simt_floats"))
        print(f"K1 f32 forward device scratch, batch {B}: {tc_b} B (the "
              f"float32-FMA yardstick's {simt_b} B; residuals "
              f"{resid.numel() * 4} B)")
        ops = sum(_bert_ops(B, T, H, heads, F_))
        for label, kern, plain, nbytes in (
                (f"training B {B}", train, plain_train,
                 _nbytes(x, x, resid, *p)),
                (f"inference B {B}", infer, plain_infer, _nbytes(x, x, *p))):
            if kern is infer:
                got, ref = infer(), plain_infer()
                torch.cuda.synchronize()
                err = _close(f"K1 forward {label}", got, ref, ATOL, RTOL)
            ms, plain_ms, lib_ms = _call_times(kern, plain, library)
            bound = _k1_forward_bound(B, nbytes)
            f32_bound, _ = _bound(ops, nbytes)
            f32_bounds.append(f32_bound)
            _report(res, key, label, err, ms, plain_ms, ops, nbytes,
                    "bert_layer.cu", "bert_layer.py:914", lib_ms,
                    bound=bound)
            print(f"  K1 forward {label}: {bound[0] / ms:.3f} of its 3xTF32 "
                  f"bound, {f32_bound / ms:.3f} of the f32 one "
                  f"({f32_bound:.6f} ms); kernel / library "
                  f"{ms / lib_ms:.3f}")
        del encoder
    res.rows[key]["bound_ms_f32_rate"] = sum(f32_bounds) / len(f32_bounds)
    k1_forward_float64_check(res, p, gen, seed, rates)


def k1_forward_float64_check(res, p, gen, seed, rates, T=369, H=84):
    """K1's float32 forward on 3xTF32 tensor cores and on float32 FMAs (the
    first forward, kept as the yardstick), each against a float64 forward
    of the same inputs at batch 4: the worst error of the output and of
    every saved residual relative to its tensor's max-abs. The tensor-core
    route must stay within 4x the yardstick's."""
    from multimodal_neuroimage_tpu_torch.ops import bert_layer as bl
    x = torch.randn(BATCH, T, H, generator=gen).cuda()
    want = bl.bert_layer_reference_parts(
        x.double(), [t.double() for t in p], 12, T, seed, rates, True)
    worst = {}
    for simt in (False, True):
        bl._GEMM_SIMT = simt
        try:
            out, resid = bl._launch_forward(x, p, 12, T, seed, rates, True,
                                            True)
        finally:
            bl._GEMM_SIMT = False
        got = {"out": out, **bl.resid_parts(resid, BATCH, T, H, 12)}
        worst[simt] = max(((got[n].double() - want[n]).abs().max()
                           / want[n].abs().max()).item() for n in want)
    res.rows["K1 bert_layer"].update(float64_rel_err=worst[False],
                                     simt_float64_rel_err=worst[True])
    print(f"K1 bert_layer forward vs a float64 forward (worst max|err| / "
          f"max|ref| over the output and the 8 residuals): 3xTF32 tensor "
          f"cores {worst[False]:.3e}, float32 FMAs {worst[True]:.3e} "
          f"(limit 4x: {worst[False] / worst[True]:.2f}x)")
    if worst[False] > 4 * worst[True]:
        raise AssertionError("K1 forward on 3xTF32 exceeds 4x the float32 "
                             "FMA route's float64 error")


def k1_float64_check(res, x, g, p, resid, seed, rates):
    """K1 backward on 3xTF32 tensor cores and on the float32 SIMT GEMM (the
    earlier route, kept as the yardstick), each against a float64 backward
    of the same inputs: the worst error of dx and of every parameter
    gradient relative to its tensor's max-abs, leaving out the key bias's
    gradient (zero in exact arithmetic: its float64 value is rounding
    noise, so no relative error exists). The tensor-core route must stay
    within 4x the SIMT route's."""
    from multimodal_neuroimage_tpu_torch.ops import bert_layer as bl
    want = bl.bert_layer_reference_backward(
        g.double(), x.double(), [t.double() for t in p], 12, x.shape[1], seed,
        rates, True)
    want = [want[0], *want[1]]
    scale = max(t.abs().max().item() for t in want)
    kept = [i for i, t in enumerate(want) if t.abs().max() > 1e-9 * scale]
    worst = {}
    for simt in (False, True):
        bl._GEMM_SIMT = simt
        try:
            dx, dps = bl.bert_layer_backward(g, x, p, resid, 12, x.shape[1],
                                             seed, rates, True)
        finally:
            bl._GEMM_SIMT = False
        got = [dx, *dps]
        worst[simt] = max(((got[i].double() - want[i]).abs().max()
                           / want[i].abs().max()).item() for i in kept)
    res.rows["K1 bert_layer backward"].update(
        float64_rel_err=worst[False], simt_float64_rel_err=worst[True])
    print(f"K1 bert_layer backward vs a float64 backward (worst max|err| / "
          f"max|ref| over dx and {len(kept) - 1} of the 16 gradients): "
          f"3xTF32 tensor cores "
          f"{worst[False]:.3e}, float32 SIMT GEMM {worst[True]:.3e} "
          f"(limit 4x: {worst[False] / worst[True]:.2f}x)")
    if worst[False] > 4 * worst[True]:
        raise AssertionError("K1 backward on 3xTF32 exceeds 4x the SIMT "
                             "route's float64 error")


def k1_batch16(gen, p, seed, rates, T=369, H=84, F_=3072):
    """K1 backward at batch 16 (the bp flagship's batch): against its plain
    version, kernel and plain times, both bounds."""
    from multimodal_neuroimage_tpu_torch.ops import bert_layer as bl
    B = BP_BATCH
    x, g = (torch.randn(B, T, H, generator=gen).cuda() for _ in "xg")
    _, resid = bl._launch_forward(x, p, 12, T, seed, rates, True, True)

    def k1():
        return bl.bert_layer_backward(g, x, p, resid, 12, T, seed, rates,
                                      True)
    dx, dps = k1()
    _, plain = _plain_backward(
        lambda x_, *p_: bl.bert_layer_reference(x_, p_, 12, T, seed, rates,
                                                True), (x,) + p, g)
    want = plain()
    torch.cuda.synchronize()
    # the floor of a gradient that is zero in exact arithmetic (the key
    # bias) is rounding noise of a sum over B * T rows: 4x batch 4's rows
    floor = SUM_ATOL * B / BATCH
    err = max([_close("K1 backward batch 16 dx", dx, want[0], ATOL, RTOL)]
              + [_close_rel(f"K1 backward batch 16 dparams[{i}]", a, b,
                            SUM_REL, floor)
                 for i, (a, b) in enumerate(zip(dps, want[1:]))])
    ms, plain_ms = _alternate(k1, plain, 10)
    tc, _ = _k1_backward_bound(B, x, g, p)
    f32, _ = _bound(2 * _bert_ops(B, T, H, 12, F_)[0],
                    _nbytes(x, g, x, *p, *p))
    print(f"K1 bert_layer backward batch 16: max|err| {err:.3e}  kernel "
          f"{ms:.4f} ms  plain {plain_ms:.4f} ms  bound {tc:.6f} ms (3xTF32 "
          f"tensor cores), {f32:.6f} ms (f32 CUDA cores)")


def _bound_k6_3xtf32(prod: float, exps: float, nbytes: float):
    """_bound for K6's float32 form on its route: every product as 3xTF32,
    three TF32 products at the dense TF32 tensor-core peak, the
    exponentials at the f32 peak; beside the bytes. (ms, by)."""
    t_ops = (3 * prod / PEAK_TF32_OPS + exps / PEAK_F32_OPS) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def mha_kernels(gen, res: Results):
    """K6's float32 form (every product on 3xTF32 tensor cores) at HCP
    shapes (B 8, 2 heads, T 1201 = 1200 TRs + CLS, head dim 11), dropout 0
    and 0.1: against the plain version on the same hash masks (dq/dk/dv
    against autograd through the plain forward); it and the CUDA-core form
    (``attention._K6_SIMT``) against a float64 truth, the worst error of
    out, dq, dk, dv (each relative to its tensor's max-abs) within
    K6_F64_MULT times the CUDA-core form's, and max over (b, h, d) of
    |sum_j dk_j| (zero in exact arithmetic) within K6_SUM_MULT times the
    CUDA-core form's or SUM_ATOL; two backward calls bitwise equal. Timed
    in turns: plain, kernel, CUDA-core form and, at rate 0, the yardstick
    ``scaled_dot_product_attention`` (backward: autograd through it), which
    the port never calls. Bounds on its route (3xTF32) and with every
    product at the f32 rate. The kernels' ptxas registers and spills are
    printed first."""
    from multimodal_neuroimage_tpu_torch.ops import attention as att
    from multimodal_neuroimage_tpu_torch.ops import build
    for line in _ptxas_summary(build.library().build_log):
        if "mha_" in line and "_t32_kernel" in line:
            print(f"K6 f32 tensor-core kernel{line}")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    shape = (HCP_BATCH, 2, 1201, 11)
    q, k, v, g = (torch.randn(shape, generator=gen).cuda() for _ in range(4))
    q = q * 11 ** -0.5                  # pre-scaled, as the BERT layer does
    prod, exps = _attention_ops(q)
    fwd_bytes, bwd_bytes = _nbytes(q, k, v, q), _nbytes(q, k, v, g, q, k, v)
    fwd_bound = _bound_k6_3xtf32(prod, exps, fwd_bytes)
    bwd_bound = _bound_k6_3xtf32(2 * prod, exps, bwd_bytes)
    f32_bounds = (_bound(prod + exps, fwd_bytes)[0],
                  _bound(2 * prod, bwd_bytes)[0])
    print(f"K6 f32 bounds (ms, forward / backward): 3xTF32 "
          f"{fwd_bound[0]:.6f} / {bwd_bound[0]:.6f}; every product at the "
          f"f32 rate {f32_bounds[0]:.6f} / {f32_bounds[1]:.6f}")
    worst, sums = {}, {}
    for rate in (0.0, 0.1):
        seed = 4242
        out, lse = att._launch_mha_forward(q, k, v, seed, rate)

        def fwd(rate=rate, seed=seed):
            return att._launch_mha_forward(q, k, v, seed, rate)[0]

        def simt_fwd(rate=rate, seed=seed):
            with _k6_simt():
                return fwd(rate, seed)

        def plain_fwd(rate=rate, seed=seed):
            return att.mha_reference(q, k, v, seed, rate)

        def bwd(rate=rate, seed=seed, out=out, lse=lse):
            return att.fused_attention_backward(g, q, k, v, out, lse, seed,
                                                rate)

        with _k6_simt():
            s_out, s_lse = att._launch_mha_forward(q, k, v, seed, rate)

        def simt_bwd(rate=rate, seed=seed, out=s_out, lse=s_lse):
            with _k6_simt():
                return bwd(rate, seed, out, lse)

        want = plain_fwd()
        torch.cuda.synchronize()
        err = _close(f"K6 forward rate {rate}", out, want, ATOL, RTOL)
        del want
        fns = [plain_fwd, fwd, simt_fwd] + (
            [] if rate else [lambda: sdpa(q, k, v, scale=1.0)])
        plain_ms, ms, simt_ms, *lib = _turns(fns)
        _report(res, "K6 fused_attention", f"rate {rate}", err, ms, plain_ms,
                0, 0, "mha_attention.cu", "attention.py:137",
                lib[0] if lib else None, bound=fwd_bound, simt_ms=simt_ms)
        got = bwd()
        if not all(torch.equal(a, b) for a, b in zip(got, bwd())):
            raise AssertionError(f"K6 backward rate {rate}: two calls "
                                 f"differ")
        ins, plain = _plain_backward(
            lambda q_, k_, v_, rate=rate, seed=seed: att.mha_reference(
                q_, k_, v_, seed, rate), (q, k, v), g)
        want = plain()
        torch.cuda.synchronize()
        errs = [_close(f"K6 backward d{n} rate {rate}", a, b, ATOL, RTOL)
                for n, a, b in zip("qkv", got, want)]
        del want
        # both forms against float64 on the same inputs and masks
        s_got = simt_bwd()
        d = [t.double() for t in (g, q, k, v)]
        truth = [att.mha_reference(*d[1:], seed, rate)] + list(
            att.mha_reference_backward(*d, seed, rate))
        rel = {simt: [((a.double() - t).abs().max() / t.abs().max()).item()
                      for a, t in zip(outs, truth)]
               for simt, outs in ((False, (out,) + tuple(got)),
                                  (True, (s_out,) + tuple(s_got)))}
        dk_sum = {simt: dk.double().sum(2).abs().max().item()
                  for simt, dk in ((False, got[1]), (True, s_got[1]))}
        del d, truth
        print(f"K6 f32 rate {rate} vs float64 (max|err| / max|truth| of "
              f"out, dq, dk, dv): tensor cores "
              f"{[f'{x:.3e}' for x in rel[False]]}, CUDA cores "
              f"{[f'{x:.3e}' for x in rel[True]]} (worst "
              f"{max(rel[False]) / max(rel[True]):.2f}x, limit "
              f"{K6_F64_MULT}x); max |sum_j dk_j| {dk_sum[False]:.3e} vs "
              f"{dk_sum[True]:.3e} (limit {K6_SUM_MULT}x or {SUM_ATOL})")
        if max(rel[False]) > K6_F64_MULT * max(rel[True]):
            raise AssertionError(f"K6 f32 rate {rate}: the tensor-core "
                                 f"kernels' float64 error exceeds "
                                 f"{K6_F64_MULT}x the CUDA-core form's")
        if dk_sum[False] > max(K6_SUM_MULT * dk_sum[True], SUM_ATOL):
            raise AssertionError(f"K6 f32 rate {rate}: max |sum_j dk_j| "
                                 f"{dk_sum[False]:.3e} against the CUDA-core "
                                 f"form's {dk_sum[True]:.3e}")
        for simt in (False, True):
            worst[simt] = max(worst.get(simt, 0.0), *rel[simt])
            sums[simt] = max(sums.get(simt, 0.0), dk_sum[simt])
        fns = [plain, bwd, simt_bwd]
        if not rate:   # autograd through SDPA, graph built once
            _, fn = _plain_backward(
                lambda q_, k_, v_: sdpa(q_, k_, v_, scale=1.0), (q, k, v), g)
            fns.append(fn)
        plain_ms, ms, simt_ms, *lib = _turns(fns, 10)
        _report(res, "K6 fused_attention backward", f"rate {rate}",
                max(errs), ms, plain_ms, 0, 0, "mha_attention.cu",
                "attention.py:159", lib[0] if lib else None,
                bound=bwd_bound, simt_ms=simt_ms)
    rates = ("every product as three TF32 products at 495 TFLOP/s; "
             "exponentials at 67 TFLOP/s (f32); bound_ms_f32_rate: the "
             "products at 67 TFLOP/s")
    for key, loose in (("K6 fused_attention", f32_bounds[0]),
                       ("K6 fused_attention backward", f32_bounds[1])):
        res.rows[key].update(bound_rates=rates, bound_ms_f32_rate=loose,
                             float64_rel_err=worst[False],
                             simt_float64_rel_err=worst[True],
                             sum_dk=sums[False], simt_sum_dk=sums[True])


def _bound_k6_16(prod16: float, prod32: float, exps: float, nbytes: float,
                 split: bool = True):
    """_bound for K6's bf16 form: the products of two bf16-valued operands
    (q k^T, dO v^T) at the bf16 tensor rate, the exponentials at the
    float32 rate, and those with a float32 operand (p v, p^T dO, ds k,
    ds^T q) as the tensor-core kernels run them, two bf16 products each (hi
    and lo) at the bf16 tensor rate; ``split=False``: at the float32 rate,
    as the CUDA-core form runs them (the looser figure, kept beside it as
    ``bound_ms_f32_rate``)."""
    t32 = (2 * prod32 / PEAK_BF16_OPS if split
           else prod32 / PEAK_F32_OPS)
    t_ops = (prod16 / PEAK_BF16_OPS + t32 + exps / PEAK_F32_OPS) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _sdpa_backend(fn) -> str:
    """The device kernels one call of ``fn`` (a scaled_dot_product_attention
    call) ran, by name, largest device time first: which backend PyTorch
    picked for its inputs."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = sorted(prof.key_averages(),
                  key=lambda e: -getattr(e, "device_time_total",
                                         getattr(e, "cuda_time_total", 0)))
    names = [e.key for e in rows
             if getattr(e, "device_time_total",
                        getattr(e, "cuda_time_total", 0)) > 0][:3]
    return "; ".join(n[:60] for n in names) or "no device kernel seen"


@contextlib.contextmanager
def _k6_simt():
    """Run K6 (either form) on the CUDA cores (attention._K6_SIMT)."""
    from multimodal_neuroimage_tpu_torch.ops import attention as att
    att._K6_SIMT = True
    try:
        yield
    finally:
        att._K6_SIMT = False


def _k6_float64_shares(out32, grads, out_t, grads_t):
    """(out32's float64 error / its bound, each gradient's worst error /
    its bound), the bounds K6_OUT64 and K6_GRAD64_*."""
    out = ((out32.double() - out_t).abs().max().item()
           / (K6_OUT64 * out_t.abs().max().item()))
    return out, [((a.double() - b).abs()
                  / (K6_GRAD64_RTOL * b.abs()
                     + K6_GRAD64_REL * b.abs().max())).max().item()
                 for a, b in zip(grads, grads_t)]


def mha16_kernels(gen, res: Results):
    """K6's bf16 form (HCP at the bf16 policy) at HCP shapes (B 8, 2 heads,
    T 1201, head dim 11), bf16 q/k/v/dO, dropout 0 and 0.1: the tensor-core
    kernels against their plain versions on the same hash masks (bf16 in,
    float32 arithmetic, rounded once), and they and the CUDA-core form
    (``attention._K6_SIMT``) against a float64 truth (the tensor-core
    kernels held to K6_OUT64 / K6_GRAD64_*, and their gradients to
    K6_SIMT_GRAD_MULT times the CUDA-core form's error; the share of bf16
    outputs bit-equal between the forms printed). Timed in turns: plain, kernel,
    CUDA-core form and, at rate 0, the yardstick
    ``scaled_dot_product_attention`` on the same bf16 tensors (backward:
    autograd through it), which the port never calls; the backend it takes
    is printed. The new kernels' ptxas registers, spills and shared memory
    are printed first."""
    from multimodal_neuroimage_tpu_torch.ops import attention as att
    from multimodal_neuroimage_tpu_torch.ops import build
    for line in _ptxas_summary(build.library().build_log):
        if "_tc_kernel" in line:
            print(f"K6 bf16 tensor-core kernel{line}")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    shape = (HCP_BATCH, 2, 1201, 11)
    q, k, v, g = (torch.randn(shape, generator=gen).cuda()
                  .to(torch.bfloat16) for _ in range(4))
    q = (q.float() / 3.3125).to(torch.bfloat16)   # pre-scaled, as the layer
    prod, exps = _attention_ops(q)                # 4 BH T^2 D, BH T^2
    bounds = {split: (_bound_k6_16(prod / 2, prod / 2, exps,
                                   _nbytes(q, k, v, q), split),
                      _bound_k6_16(prod / 2, 3 * prod / 2, exps,
                                   _nbytes(q, k, v, g, q, k, v), split))
              for split in (True, False)}
    fwd_bound, bwd_bound = bounds[True]
    rates = "q k^T, dO v^T at 989 TFLOP/s (bf16); p v, p^T dO, ds k, " \
            "ds^T q as two bf16 products each (hi, lo) at 989 TFLOP/s; " \
            "exponentials at 67 TFLOP/s (f32); bound_ms_f32_rate: the " \
            "float32-operand products at 67 TFLOP/s"
    print(f"K6 bf16 bounds (ms, forward / backward): {fwd_bound[0]:.6f} / "
          f"{bwd_bound[0]:.6f}; with the float32-operand products at the "
          f"float32 rate: {bounds[False][0][0]:.6f} / "
          f"{bounds[False][1][0]:.6f}")
    fwd_tol = f"rtol {K6_RTOL16} + {K6_ATOL16} * max|ref|"
    backend = _sdpa_backend(lambda: sdpa(q, k, v, scale=1.0))
    print(f"scaled_dot_product_attention on bf16 (8, 2, 1201, 11): {backend}")
    shares = {}
    for rate in (0.0, 0.1):
        seed = 4243
        out, out32, lse = att._launch_mha_forward16(q, k, v, seed, rate,
                                                    True)

        def fwd(rate=rate, seed=seed):
            return att._launch_mha_forward16(q, k, v, seed, rate, False)[0]

        def simt_fwd(rate=rate, seed=seed):
            with _k6_simt():
                return fwd(rate, seed)

        def plain_fwd(rate=rate, seed=seed):
            return att.mha_reference16(q, k, v, seed, rate)

        def bwd(rate=rate, seed=seed, out32=out32, lse=lse):
            return att.fused_attention_backward16(g, q, k, v, out32, lse,
                                                  seed, rate)

        def simt_bwd(rate=rate, seed=seed, out32=out32, lse=lse):
            with _k6_simt():
                return bwd(rate, seed, out32, lse)

        want = plain_fwd().float()
        torch.cuda.synchronize()
        got = out.float()
        err = _close(f"K6 bf16 forward rate {rate}", got, want,
                     K6_ATOL16 * want.abs().max().item(), K6_RTOL16)
        if not torch.equal(fwd(), out):
            raise AssertionError("K6 bf16 forward: the inference launch "
                                 "differs from the training launch")
        # both forms against float64 on the same bf16 inputs and masks
        grads = bwd()
        if not all(torch.equal(a, b) for a, b in zip(grads, bwd())):
            raise AssertionError("K6 bf16 backward: two calls differ")
        with _k6_simt():
            s_out, s_out32, s_lse = att._launch_mha_forward16(
                q, k, v, seed, rate, True)
            s_grads = bwd(rate, seed, s_out32, s_lse)
        out_t = att.mha_reference(q.double(), k.double(), v.double(), seed,
                                  rate)
        grads_t = att.mha_reference_backward(g.double(), q.double(),
                                             k.double(), v.double(), seed,
                                             rate)
        torch.cuda.synchronize()
        tc64 = _k6_float64_shares(out32, grads, out_t, grads_t)
        simt64 = _k6_float64_shares(s_out32, s_grads, out_t, grads_t)
        same = [(a == b).float().mean().item()
                for a, b in zip((out,) + tuple(grads),
                                (s_out,) + tuple(s_grads))]
        del out_t, grads_t
        print(f"K6 bf16 rate {rate} vs float64 (error / bound: out32 "
              f"{K6_OUT64} max|truth|; dq, dk, dv {K6_GRAD64_RTOL} |truth| "
              f"+ {K6_GRAD64_REL} max|truth|): tensor cores out32 "
              f"{tc64[0]:.4f}, grads {[round(x, 4) for x in tc64[1]]}; "
              f"CUDA-core form out32 {simt64[0]:.4f}, grads "
              f"{[round(x, 4) for x in simt64[1]]}; bf16 out, dq, dk, dv "
              f"bit-equal between the forms: "
              f"{[round(x, 5) for x in same]}")
        if max(tc64[0], *tc64[1]) > 1.0:
            raise AssertionError(f"K6 bf16 rate {rate}: the tensor-core "
                                 f"kernels exceed their float64 bounds "
                                 f"{tc64}")
        if any(a > K6_SIMT_GRAD_MULT * b for a, b in zip(tc64[1],
                                                           simt64[1])):
            raise AssertionError(f"K6 bf16 rate {rate}: a tensor-core "
                                 f"gradient's float64 error exceeds "
                                 f"{K6_SIMT_GRAD_MULT}x the CUDA-core "
                                 f"form's: {tc64[1]} vs {simt64[1]}")
        shares[rate] = (tc64, simt64)
        fns = [plain_fwd, fwd, simt_fwd] + (
            [] if rate else [lambda: sdpa(q, k, v, scale=1.0)])
        plain_ms, ms, simt_ms, *lib = _turns(fns)
        _report(res, "K6 fused_attention bf16", f"rate {rate}", err, ms,
                plain_ms, 0, 0, "mha_attention.cu", "attention.py:137",
                lib[0] if lib else None, tol=fwd_tol, bound=fwd_bound,
                simt_ms=simt_ms)
        want = att.mha_reference_backward16(g, q, k, v, seed, rate)
        torch.cuda.synchronize()
        errs = [_close_rel(f"K6 bf16 backward d{n} rate {rate}", a.float(),
                           b.float(), K6_REL16, 0.0)
                for n, a, b in zip("qkv", grads, want)]
        fns = [None, bwd, simt_bwd]
        if not rate:   # autograd through SDPA, graph built once
            _, fn = _plain_backward(lambda q_, k_, v_: sdpa(q_, k_, v_,
                                                            scale=1.0),
                                    (q, k, v), g)
            fns.append(fn)
        # the plain backward alone (graph built once), rounded as the
        # bf16 form's plain backward rounds
        _, plain = _plain_backward(
            lambda q_, k_, v_, rate=rate, seed=seed: att.mha_reference(
                q_, k_, v_, seed, rate), (q.float(), k.float(), v.float()),
            g.float())
        fns[0] = lambda plain=plain: [t.to(torch.bfloat16) for t in plain()]
        plain_ms, ms, simt_ms, *lib = _turns(fns, 10)
        _report(res, "K6 fused_attention backward bf16", f"rate {rate}",
                max(errs), ms, plain_ms, 0, 0, "mha_attention.cu",
                "attention.py:159", lib[0] if lib else None,
                tol=f"{K6_REL16} * max|ref|", bound=bwd_bound,
                simt_ms=simt_ms)
    for key, part, loose in (("K6 fused_attention bf16", lambda x: x[0],
                              bounds[False][0][0]),
                             ("K6 fused_attention backward bf16",
                              lambda x: max(x[1]), bounds[False][1][0])):
        res.rows[key]["bound_rates"] = rates
        res.rows[key]["bound_ms_f32_rate"] = loose
        res.rows[key]["library_backend"] = backend
        res.rows[key]["float64_share"] = max(part(tc)
                                             for tc, _ in shares.values())
        res.rows[key]["simt_float64_share"] = max(
            part(simt) for _, simt in shares.values())


def bp_kernels(gen, res: Results):
    """K7 forward and backward at the bp flagship's shapes (B 16, two groups
    of G = 8, 196 windows x 36 x 12, 6 heads; dropout 0.1 and DropPath)
    against the bp plain versions, timed beside K2/K3 on the same inputs in
    the std layout (the same function up to the dropout masks). Bound as
    K2/K3's at B = 16."""
    from multimodal_neuroimage_tpu_torch.nn.swin2d import shift_attn_mask
    from multimodal_neuroimage_tpu_torch.ops import fusion_block as fb
    from multimodal_neuroimage_tpu_torch.ops import fusion_block_bp as fbp
    dev = "cuda"
    B, C, Hh, N, nW = BP_BATCH, 12, 6, 36, 196
    G = fbp.group_size(B)
    if (G, B // G) != (8, 2):
        raise AssertionError(f"bp groups at B = {B}: G = {G} (FUSION_BP_GROUP "
                             f"set?); expected two groups of 8")
    rates, seed = (0.1, 0.1), 24680
    self_p, cross_p, bias, _, _ = _fusion_inputs(gen)
    xw, yw, gw = (torch.randn(B, nW, N, C, generator=gen).to(dev)
                  for _ in range(3))
    xg, yg, gg = (fbp.to_groups(t, G).contiguous() for t in (xw, yw, gw))
    dp = (torch.rand(B, 2, generator=gen) > 0.1).float().to(dev) / 0.9
    fops, bops = sum(_fusion_ops(B, nW, N, C, Hh)), 2 * _fusion_ops(
        B, nW, N, C, Hh)[0]
    train = (dp, seed, rates, True)
    for shift in (0, 3):
        m = shift_attn_mask(84, 84, 6, shift)
        mask = None if m is None else torch.from_numpy(m).to(dev)
        for cross, params in ((False, self_p), (True, cross_p)):
            name = "cross_fusion_block_bp" if cross else "fusion_block_bp"
            ys, yb = (yw, yg) if cross else (None, None)
            streams = (xg, yg) if cross else (xg,)
            if cross:
                def kern(p=params, mask=mask):
                    return fbp.fused_cross_fusion_block_bp(xg, yg, p, bias,
                                                           mask, *train)

                def plain(p=params, mask=mask):
                    return fbp.cross_fusion_block_bp_reference(
                        xg, yg, p, bias, mask, *train)

                def std(p=params, mask=mask):
                    return fb.fused_cross_fusion_block(xw, yw, p, bias, mask,
                                                       *train)
            else:
                def kern(p=params, mask=mask):
                    return fbp.fused_fusion_block_bp(xg, p, bias, mask,
                                                     *train)

                def plain(p=params, mask=mask):
                    return fbp.fusion_block_bp_reference(xg, p, bias, mask,
                                                         *train)

                def std(p=params, mask=mask):
                    return fb.fused_fusion_block(xw, p, bias, mask, *train)
            got, want = kern(), plain()
            torch.cuda.synchronize()
            err = _close(f"K7 {name} shift {shift}", got, want, ATOL, RTOL)
            plain_ms, std_ms, ms = _turns([plain, std, kern])
            _report(res, f"K7 {name}", f"shift {shift}", err, ms, plain_ms,
                    fops, _nbytes(*streams, xg, bias, mask, dp, *params),
                    "fusion_block_bp.cu", "fusion_block_bp.py:745",
                    std_ms=std_ms)

            # backward, from the x2r of a training forward of each layout
            _, x2r = fbp._launch_forward(xg, yb, params, bias, mask, dp, seed,
                                         rates, True, True, cross, G)
            _, x2r_std = fb._launch_forward(xw, ys, params, bias, mask, dp,
                                            seed, rates, True, True, cross)
            key = f"K7 {name} backward"
            if cross:
                def kern(p=params, mask=mask, x2r=x2r):
                    return fbp.fused_cross_fusion_block_bp_backward(
                        gg, xg, yg, p, bias, mask, *train, x2r)

                def std(p=params, mask=mask, x2r=x2r_std):
                    return fb.fused_cross_fusion_block_backward(
                        gw, xw, yw, p, bias, mask, *train, x2r)
                ins, plain = _plain_backward(
                    lambda x_, y_, b_, *p_, mask=mask:
                        fbp.cross_fusion_block_bp_reference(
                            x_, y_, p_, b_, mask, *train),
                    (xg, yg, bias) + params, gg)
            else:
                def kern(p=params, mask=mask, x2r=x2r):
                    return fbp.fused_fusion_block_bp_backward(
                        gg, xg, p, bias, mask, *train, x2r)

                def std(p=params, mask=mask, x2r=x2r_std):
                    return fb.fused_fusion_block_backward(
                        gw, xw, p, bias, mask, *train, x2r)
                ins, plain = _plain_backward(
                    lambda x_, b_, *p_, mask=mask:
                        fbp.fusion_block_bp_reference(x_, p_, b_, mask,
                                                      *train),
                    (xg, bias) + params, gg)
            got, want = kern(), plain()
            torch.cuda.synchronize()
            # got: (dx, [dy,] dbias, dparams); want: the inputs' gradients
            n = len(streams)
            errs = [_close(f"{key} d{s}", a, b, ATOL, RTOL)
                    for s, a, b in zip("xy", got[:n], want[:n])]
            errs.append(_close_rel(f"{key} dbias", got[n], want[n], SUM_REL))
            errs += [_close_rel(f"{key} dparams[{i}]", a, b, SUM_REL)
                     for i, (a, b) in enumerate(zip(got[n + 1], want[n + 1:]))]
            plain_ms, std_ms, ms = _turns([plain, std, kern], iters=10)
            _report(res, key, f"shift {shift}", max(errs), ms, plain_ms, bops,
                    _nbytes(*streams, *streams, gg, dp, mask, bias, bias,
                            *params, *params),
                    "fusion_block_bp.cu", "fusion_block_bp.py:808",
                    tol=f"dx/dy: atol {ATOL} + rtol {RTOL}; sums: {SUM_REL} "
                        f"* max|ref| + {SUM_ATOL}", std_ms=std_ms)


def _k1_params16(gen, H=84, F_=3072):
    """K1's 16 parameters as the bf16 policy gives them to the kernel: bf16
    values in float32 tensors."""
    p = (_lin(gen, H, H) + _lin(gen, H, H) + _lin(gen, H, H) + _lin(gen, H, H)
         + _ln(gen, H) + _lin(gen, F_, H) + _lin(gen, H, F_) + _ln(gen, H))
    return tuple(t.to(torch.bfloat16).float().cuda() for t in p)


def _grads16(name, got, want, key_bias=None):
    """The bf16 policy's gradients against their plain versions: each within
    REL16 of its max-abs; ``key_bias`` = (index of the key bias, index of
    the key weight), the key bias held at the key weight's scale."""
    errs = []
    for i, (a, b) in enumerate(zip(got, want)):
        if key_bias and i == key_bias[0]:
            scale = want[key_bias[1]].abs().max().item()
            errs.append(_close_rel(f"{name}[{i}]", a, b, 0.0, REL16 * scale))
        else:
            errs.append(_close_rel(f"{name}[{i}]", a.float(), b.float(),
                                   REL16, 0.0))
    return errs


def bf16_kernels(gen, res: Results):
    """The bf16 policy's kernels against their plain versions on the card:
    K1's mm16 form forward (inference) and backward (dropout 0.1) at
    batches 4, 16 and 64 (bf16-valued weights, float32 stream) beside
    ``nn.TransformerEncoderLayer`` in bf16 on the same weights, then each
    entry's device scratch at batches 16 and 64 and the split of one
    batch-16 call into its launches (``bench/k1_split.py``); K7 on bf16
    streams at the bp flagship's shapes (B 16, two groups of 8, shifts 0 and
    3, dropout 0.1 and DropPath), beside K7 on float32 streams on the same
    inputs. Bounds: products at the bf16 tensor rate, exponentials at the
    float32 rate."""
    from multimodal_neuroimage_tpu_torch.nn.swin2d import shift_attn_mask
    from multimodal_neuroimage_tpu_torch.ops import bert_layer as bl
    from multimodal_neuroimage_tpu_torch.ops import fusion_block_bp as fbp
    dev = "cuda"
    rates, seed = (0.1, 0.1), 13579
    H, F_, T = 84, 3072, 369
    p = _k1_params16(gen)
    tol16 = f"atol {ATOL16} + rtol {RTOL16}; gradients {REL16} * max|ref|"
    tol7 = f"outputs and gradients {REL16} * max|ref|"
    lib_ratio = {}
    for B in (BATCH, BP_BATCH, 64):
        x, g = (torch.randn(B, T, H, generator=gen).to(dev) for _ in "xg")
        prod, exps = _bert_ops(B, T, H, 12, F_)
        layer = _encoder_layer(p, H, 12, F_).to(torch.bfloat16)
        x16 = x.to(torch.bfloat16)

        def fwd(x=x):
            return bl.bert_layer_call16(x, p, 12, T)

        def plain(x=x):
            return bl.bert_layer_reference(x, p, 12, T, mm16=True)

        @torch.no_grad()
        def library(layer=layer, x16=x16):
            return layer.eval()(x16)
        got, want = fwd(), plain()
        torch.cuda.synchronize()
        err = _close(f"K1 mm16 batch {B}", got, want, ATOL16, RTOL16)
        ms, plain_ms, lib_ms = _call_times(fwd, plain, library)
        _report(res, "K1 bert_layer mm16", f"batch {B}", err, ms, plain_ms,
                0, 0, "bert_layer.cu", "bert_layer.py:914", lib_ms,
                tol=tol16, bound=_bound16(prod, exps, _nbytes(x, x, *p)))

        _, resid = bl._launch_forward(x, p, 12, T, seed, rates, True, True,
                                      True)

        def bwd(x=x, g=g, resid=resid):
            return bl.bert_layer_backward16(g, x, p, resid, 12, T, seed,
                                            rates, True)

        def plain_bwd(x=x, g=g):
            return bl.bert_layer_reference_backward16(g, x, p, 12, T, seed,
                                                      rates, True)
        (dx, dps), (wdx, wdps) = bwd(), plain_bwd()
        torch.cuda.synchronize()
        errs = [_close_rel(f"K1 mm16 backward batch {B} dx", dx, wdx, REL16,
                           0.0)]
        errs += _grads16(f"K1 mm16 backward batch {B} dparams", dps, wdps,
                         key_bias=(3, 2))
        layer.train()
        with torch.enable_grad():
            xl = x16.detach().requires_grad_()
            ins, out = [xl] + list(layer.parameters()), layer(xl)
        g16 = g.to(torch.bfloat16)
        ms, plain_ms, lib_ms = _call_times(
            bwd, plain_bwd,
            lambda: torch.autograd.grad(out, ins, g16, retain_graph=True), 10)
        _report(res, "K1 bert_layer backward mm16", f"batch {B}", max(errs),
                ms, plain_ms, 0, 0, "bert_layer.cu", "bert_layer.py:1008",
                lib_ms, tol=tol16,
                bound=_bound16(2 * prod, 2 * exps,
                               _nbytes(x, g, x, *p, *p)))
        lib_ratio[B] = ms / lib_ms
        del layer, ins, out
    print("K1 mm16 backward / its library call (bf16 nn.TransformerEncoderLayer"
          " autograd): " + ", ".join(f"batch {B} {r:.3f}"
                                     for B, r in lib_ratio.items()))
    for B in (BP_BATCH, 64):
        nbytes = k1_split.scratch_bytes(B)
        print(f"K1 mm16 device scratch, batch {B}: forward "
              f"{nbytes['forward']} B, backward {nbytes['backward']} B "
              f"(residuals {nbytes['resid']} B)")
    k1_split.report(BP_BATCH, gen)

    B, C, Hh, N, nW = BP_BATCH, 12, 6, 36, 196
    G = fbp.group_size(B)
    self_p, cross_p, bias, _, _ = _fusion_inputs(gen)
    self_p = tuple(t.to(torch.bfloat16).float() for t in self_p)
    cross_p = tuple(t.to(torch.bfloat16).float() for t in cross_p)
    xg, yg, gg = (fbp.to_groups(torch.randn(B, nW, N, C, generator=gen), G)
                  .contiguous().to(dev).to(torch.bfloat16) for _ in range(3))
    dp = (torch.rand(B, 2, generator=gen) > 0.1).float().to(dev) / 0.9
    train = (dp, seed, rates, True)
    prod, exps = _fusion_ops(B, nW, N, C, Hh)
    for shift in (0, 3):
        m = shift_attn_mask(84, 84, 6, shift)
        mask = None if m is None else torch.from_numpy(m).to(dev)
        for cross, params in ((False, self_p), (True, cross_p)):
            name = "cross_fusion_block_bp" if cross else "fusion_block_bp"
            y16 = yg if cross else None
            streams = (xg, yg) if cross else (xg,)
            x32, y32 = xg.float(), (yg.float() if cross else None)

            def kern(p_=params, mask=mask):
                return fbp._launch_forward(xg, y16, p_, bias, mask, dp, seed,
                                           rates, True, False, cross, G)[0]

            def f32(p_=params, mask=mask):
                return fbp._launch_forward(x32, y32, p_, bias, mask, dp,
                                           seed, rates, True, False, cross,
                                           G)[0]

            def plain(p_=params, mask=mask):
                return fbp.fusion_block_bp_reference16(
                    xg, p_, bias, mask, *train, y=y16, group=G)[0]
            got, want = kern(), plain()
            torch.cuda.synchronize()
            err = _close_rel(f"K7 bf16 {name} shift {shift}", got.float(),
                             want.float(), REL16, 0.0)
            plain_ms, f32_ms, ms = _turns([plain, f32, kern])
            _report(res, f"K7 {name} bf16", f"shift {shift}", err, ms,
                    plain_ms, 0, 0, "fusion_block_bp16.cu",
                    "fusion_block_bp.py:745", tol=tol7, f32_ms=f32_ms,
                    bound=_bound16(prod, exps, _nbytes(
                        *streams, xg, bias, mask, dp, *params)))

            _, x2r = fbp._launch_forward(xg, y16, params, bias, mask, dp,
                                         seed, rates, True, True, cross, G)
            _, x2r32 = fbp._launch_forward(x32, y32, params, bias, mask, dp,
                                           seed, rates, True, True, cross, G)
            key = f"K7 {name} backward bf16"

            def kern(p_=params, mask=mask, x2r=x2r):
                return fbp._backward(gg, xg, y16, p_, bias, mask, dp, seed,
                                     rates, True, x2r, cross, G)

            def f32(p_=params, mask=mask, x2r=x2r32):
                return fbp._backward(gg.float(), x32, y32, p_, bias, mask,
                                     dp, seed, rates, True, x2r, cross, G)

            def plain(p_=params, mask=mask):
                return fbp.fusion_block_bp_reference_backward16(
                    gg, xg, y16, p_, bias, mask, *train, cross=cross,
                    group=G)
            got, want = kern(), plain()
            torch.cuda.synchronize()
            errs = [_close_rel(f"{key} dx", got[0].float(), want[0].float(),
                               REL16, 0.0)]
            if cross:
                errs.append(_close_rel(f"{key} dy", got[1].float(),
                                       want[1].float(), REL16, 0.0))
            errs.append(_close_rel(f"{key} dbias", got[2], want[2], REL16,
                                   0.0))
            errs += _grads16(f"{key} dparams", got[3], want[3])
            plain_ms, f32_ms, ms = _turns([plain, f32, kern], iters=10)
            _report(res, key, f"shift {shift}", max(errs), ms, plain_ms, 0, 0,
                    "fusion_block_bp16.cu", "fusion_block_bp.py:808",
                    tol=tol7, f32_ms=f32_ms,
                    bound=_bound16(2 * prod, 2 * exps, _nbytes(
                        *streams, *streams, gg, dp, mask, bias, bias,
                        *params, *params)))


def dot_shape_kernels(res: Results):
    """K8: each variant's chain at reps 1 over its 7 cells, f32 and bf16,
    against the plain (einsum) chain; then the dot-shape entry point
    (``bench/dot_shapes.py``) with every launch count set to 0 just before
    it, its slope times beside the plain chain's and ``torch.bmm``'s.
    Returns the entry point's launch counts."""
    from multimodal_neuroimage_tpu_torch import ops
    from multimodal_neuroimage_tpu_torch.bench import dot_shapes as bench
    from multimodal_neuroimage_tpu_torch.ops import dot_shapes as ds
    errs = {}
    for bf16 in (False, True):
        for v in ds.VARIANTS:
            operands = ds.inputs(v, device="cuda")
            got = ds.dot_chain(v, *operands, 1, bf16)
            want = ds.dot_chain_reference(v, *operands, 1, bf16)
            torch.cuda.synchronize()
            if got.shape != (ds.NCH,) + ds.shapes(v)[0]:
                raise AssertionError(f"K8 {v}: output {tuple(got.shape)}")
            err = (got - want).abs().max().item()
            limit = DOT_REL[bf16] * want.abs().max().item()
            if not torch.isfinite(got).all() or err > limit:
                raise AssertionError(f"K8 {v} bf16={bf16}: max|err| {err:.3e} "
                                     f"over {limit:.3e}")
            errs[v, bf16] = err
    torch.cuda.synchronize()
    ops.reset_launches()
    timed = {bf16: bench.run("bf16" if bf16 else "f32", device=False)
             for bf16 in (False, True)}
    torch.cuda.synchronize()
    # read before the graph-timed slopes: a captured launch counts once, at
    # capture, and its replays not at all
    counts = ops.launches()
    print(f"launches in the dot-shape run: {counts}")
    if counts["K8 dot_shapes"] == 0 or any(
            n for k, n in counts.items() if k != "K8 dot_shapes"):
        raise AssertionError(f"the dot-shape run launched {counts}")
    for (v, bf16), err in errs.items():
        operands = ds.inputs(v, device="cuda")
        plain = bench.slope_ms(
            lambda r: ds.dot_chain_reference(v, *operands, r, bf16))
        t = {**timed[bf16][v], **bench.device_variant(v, bf16)}
        _report(res, "K8 dot_shapes", f"{v} {'bf16' if bf16 else 'f32'} "
                f"(ms per pair)", err, t["ms"], plain, 0, 0,
                "dot_shapes.cu", "scripts/bench_dot_shapes.py:138",
                library_ms=t["bmm_ms"], bound=bench.bound_ms(v, bf16),
                tol=f"{DOT_REL[bf16]} * max|ref|",
                device=(t["device_ms"], t["bmm_device_ms"], "graph"))
    return counts


def _cohort(rng, n, first):
    """In-memory records {subject, fmri (84, T), struct, target} with a
    label-linked signal: positives carry a slow fMRI oscillation and a
    stronger struct diagonal."""
    records = []
    for i in range(n):
        y = float(i % 2)
        T = int(rng.integers(350, 369))
        t = np.arange(T)[None, :]
        drift = np.sin(2 * np.pi * t / rng.uniform(150, 400, (84, 1)))
        fmri = (rng.normal(size=(84, T)) + 2.0 * drift + 100.0
                + 1.5 * y * np.sin(2 * np.pi * t / 40.0))
        s = rng.normal(size=(84, 84))
        records.append({"subject": f"sub-{first + i:03d}", "fmri": fmri,
                        "struct": (s + s.T) / 2 + 3.0 * y * np.eye(84),
                        "target": y})
    return records


def _flagship_cfg(**kw):
    from multimodal_neuroimage_tpu_torch.config import Config
    args = dict(task="FuncStruct", dataset_name="multimodal",
                multimodality_type="cross_attention", target="sex",
                fine_tune_task="binary_classification", batch_size=BATCH,
                compute_dtype="float32", preprocess="host", nEpochs=2,
                experiment_title="flagship", seed=SEED)
    return Config(**{**args, **kw}).validate()


def _hcp_cohort(rng, n, first):
    """In-memory HCP records {subject, fmri (22, T), target}, T drawn from
    900-1200 TRs, with the same label-linked slow oscillation."""
    records = []
    for i in range(n):
        y = float(i % 2)
        T = int(rng.integers(900, 1201))
        t = np.arange(T)[None, :]
        drift = np.sin(2 * np.pi * t / rng.uniform(150, 400, (22, 1)))
        fmri = (rng.normal(size=(22, T)) + 2.0 * drift + 100.0
                + 1.5 * y * np.sin(2 * np.pi * t / 40.0))
        records.append({"subject": f"hcp-{first + i:03d}", "fmri": fmri,
                        "target": y})
    return records


def _hcp_cfg(**kw):
    """Phase 1 on HCP at full width: validate() sets 22 ROIs, 1200 TRs and 2
    heads; batch 8, AdamW, lr 1e-3 and the step policy are the defaults.
    ``preprocess`` and ``compute_dtype`` (bfloat16) stay at their defaults
    unless given: HCP items take no FIR gear."""
    from multimodal_neuroimage_tpu_torch.config import Config
    args = dict(step=1, task="2DBERT", dataset_name="hcp", target="sex",
                nEpochs=2, experiment_title="hcp", seed=SEED)
    return Config(**{**args, **kw}).validate()


def _sign_stable_update_check(name, p_gpu, p_cpu, g_gpu, g_cpu, lr):
    """Updated parameters after one Adam step: where the gradient's sign is
    the same on both sides (|g_cpu| > 10 |g_gpu - g_cpu| + 1e-7) the update
    is +-lr(1 - O(eps/|g|)) on both, so the parameters must agree to 1e-5;
    where a gradient is so small that its sign differs between the two
    summation orders, the step may differ by up to 2 lr."""
    diff = (p_gpu - p_cpu).abs()
    stable = g_cpu.abs() > 10 * (g_gpu - g_cpu).abs() + 1e-7
    if not torch.isfinite(p_gpu).all():
        raise AssertionError(f"{name}: non-finite parameters")
    if stable.any() and diff[stable].max() > 1e-5:
        raise AssertionError(f"{name}: updated params differ by "
                             f"{diff[stable].max().item():.3e} where the "
                             f"gradient sign is stable")
    if diff.max() > 2 * lr + 1e-5:
        raise AssertionError(f"{name}: update differs by more than 2 lr")
    return diff.max().item(), int((~stable).sum())


def _train(cfg, train_records, val_records, folder, label):
    """One Trainer run on the card with every launch count set to 0 just
    before it; returns (trainer, metrics, counts, wall seconds)."""
    from multimodal_neuroimage_tpu_torch import ops
    from multimodal_neuroimage_tpu_torch.train.trainer import Trainer
    trainer = Trainer(cfg, train_records, val_records, device="cuda",
                      experiment_folder=folder)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    metrics = trainer.training()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launches()
    print(f"launches in the {label} training run: {counts}")
    if not np.isfinite(trainer.step_losses).all():
        raise AssertionError(f"non-finite {label} training loss: "
                             f"{trainer.step_losses}")
    if trainer.best_checkpoint() is None:
        raise AssertionError(f"no {label} best-AUROC checkpoint was written")
    return trainer, metrics, counts, wall


def _print_run(label, cfg, trainer, metrics, wall, ckpt=None):
    from multimodal_neuroimage_tpu_torch.ckpt.checkpoint import load_checkpoint
    ckpt = ckpt or trainer.best_checkpoint()
    meta = load_checkpoint(ckpt)["metadata"]
    print(f"{label}: trained {cfg.nEpochs} epochs x {trainer.steps_per_epoch} "
          f"steps in {wall:.1f} s; step losses "
          f"{[round(v, 4) for v in trainer.step_losses]}; "
          f"train_AUROC {metrics.get('train_AUROC')}, val_AUROC "
          f"{metrics.get('val_AUROC')}; best checkpoint "
          f"{os.path.basename(ckpt)} (val_AUROC {meta.get('best_auroc')}, "
          f"val_threshold {meta['val_threshold']})")


def _serve(cfg, ckpt, requests, folder, label, card, reference="CPU",
           f32_compute=False):
    """Serve ``requests`` from ``ckpt`` on the card (counts set to 0 just
    before the timed pass); logits must match the CPU through the plain
    versions or, with ``reference="std"`` (the caller runs the bp layout),
    the std fusion layout on the card, whose predict step is then timed in
    turns beside the served layout's. ``f32_compute``: the model computes in
    float32 under either policy, so the float32 tolerances hold. Returns
    the serving run's launch counts."""
    from multimodal_neuroimage_tpu_torch import ops
    from multimodal_neuroimage_tpu_torch.ckpt.checkpoint import load_checkpoint
    from multimodal_neuroimage_tpu_torch.models.registry import create_model
    from multimodal_neuroimage_tpu_torch.serve.predictor import (
        Predictor, make_predict_step)
    pred = Predictor(cfg, ckpt, requests, device="cuda")
    pred.predict()                                   # warm-up
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    csv_path = os.path.join(folder, "predictions.csv")
    scores = pred.predict(write_csv=csv_path)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launches()
    with open(csv_path) as f:
        rows = f.read().strip().splitlines()
    print(f"launches in the {label} serving run: {counts}")
    n = len(requests)
    if len(scores) != n or len(rows) != n + 1:
        raise AssertionError(f"expected {n} subjects, got {len(scores)} "
                             f"scores, {len(rows) - 1} rows")
    for subject, row in scores.items():
        if not (0.0 < row["score"] < 1.0) or row["label"] != float(
                row["score"] > pred.threshold):
            raise AssertionError(f"bad prediction for {subject}: {row}")
    if reference == "std":
        def ref_step(batch):
            with _layout("std"):
                return pred.step(batch)["binary_classification"].cpu()
    else:
        cpu_model = create_model(cfg)
        cpu_model.load_state_dict(load_checkpoint(ckpt)["state_dict"])
        cpu_step = make_predict_step(cpu_model, cfg.compute_dtype,
                                     device="cpu")

        def ref_step(batch):
            return cpu_step(batch)["binary_classification"]
    atol, rtol = ((LOGIT16, LOGIT16) if cfg.compute_dtype == "bfloat16"
                  and not f32_compute else (LOGIT_ATOL, LOGIT_RTOL))
    logit_err = 0.0
    t_ref = time.perf_counter()
    for batch, _ in pred.batches():
        got = pred.step(batch)["binary_classification"].cpu()
        logit_err = max(logit_err, _close(f"{label} serving logits", got,
                                          ref_step(batch), atol, rtol))
    t_ref = time.perf_counter() - t_ref
    first, _ = next(pred.batches())
    beside = ""
    if reference == "std":
        fwd, ref = _turns([lambda: pred.step(first),
                           lambda: ref_step(first)], iters=5)
        beside = (f"; std layout predict step {ref:.2f} ms "
                  f"({cfg.batch_size / ref * 1e3:.2f} subjects/s)")
    else:
        fwd = events_ms(lambda: pred.step(first), iters=5)
    print(f"{label}: served {n} requests in {wall:.3f} s: {n / wall:.2f} "
          f"requests/s end to end (host preprocessing included); predict "
          f"step {fwd:.2f} ms per batch of {cfg.batch_size} "
          f"({cfg.batch_size / fwd * 1e3:.2f} subjects/s){beside}; logits vs "
          f"{reference} max|err| {logit_err:.3e} (atol {atol} + rtol "
          f"{rtol}; the comparison took {t_ref:.1f} s); card: {card}")
    return counts


def _step_compare(cfg, batch, label, sides, optim="AdamW",
                  f32_compute=False, grad_rel=GRAD_REL, twin16=False):
    """One training step on each of ``sides`` ((name, device, fusion
    layout)), from the same weights, batch and generator state: the first
    side's loss, every gradient and the updated parameters against the
    second's. Device ``"twins"`` is the card with every kernel's plain twin
    (``_plain_twins``), ``"twins-order-N"`` the same with K1's mm16 twin in
    another order of its float32 sums (its F slices added in N parts).
    ``f32_compute``: the model computes in float32 under either policy (the
    struct nets: bf16-rounded weights and inputs, float32 streams), so the
    float32 tolerances hold, each gradient within ``grad_rel`` of its
    max-abs; ``twin16``: at the bf16 policy against the plain twins, with
    more sides, the twins in other sum orders and last a control order:
    each gradient within ``grad_rel`` of its own max-abs plus
    ``TWIN_ORDER_X`` times its spread, the largest distance of the other
    orders from the twins (the BERTs' printed by layer), and the control
    order's distance printed beside the kernels';
    else at the bf16 policy each gradient within GRAD16's share of its
    component's largest.
    Returns each side's launch counts."""
    from multimodal_neuroimage_tpu_torch import ops
    from multimodal_neuroimage_tpu_torch.models.registry import (
        create_model, init_random_weights)
    from multimodal_neuroimage_tpu_torch.train.state import (create_optimizer,
                                                             make_train_step)
    specs = _loss_specs(cfg)
    lr = 1e-3
    models, out, counts = {}, {}, {}
    took = {}
    for side, where, layout in sides:
        t0 = time.perf_counter()
        dev = "cuda" if where.startswith("twins") else where
        m = init_random_weights(create_model(cfg),
                                torch.Generator().manual_seed(SEED + 1))
        init = {n: p.detach().clone() for n, p in m.named_parameters()}
        m.to(dev)
        opt = create_optimizer(optim, m.parameters(), lambda t: lr,
                               cfg.weight_decay)
        step = make_train_step(m, specs, opt, cfg.compute_dtype, dev)
        twins = (_plain_twins(int(where.split("-")[-1])
                              if where.startswith("twins-order-") else None)
                 if dev != where else contextlib.nullcontext())
        with _layout(layout), twins:
            torch.cuda.synchronize()
            ops.reset_launches()
            out[side] = step(batch, torch.Generator().manual_seed(SEED + 2))
            torch.cuda.synchronize()
            counts[side] = ops.launches()
        models[side] = m
        took[side] = time.perf_counter() - t0
    (a, _, _), (b, _, _) = sides[:2]
    loss_a = out[a][0]["total"].item()
    loss_b = out[b][0]["total"].item()
    bf16 = cfg.compute_dtype == "bfloat16" and not f32_compute
    l2 = cfg.weight_decay if optim.lower() == "adam" else 0.0
    shares = GRAD16_HCP if cfg.dataset_name == "hcp" else GRAD16
    tol = (LOGIT16, LOGIT16) if bf16 else (LOGIT_ATOL, LOGIT_RTOL)
    _close(f"{label} step loss", torch.tensor([loss_a]),
           torch.tensor([loss_b]), *tol)
    grad_err = upd_err = 0.0
    unstable = n_params = 0
    named = dict(models[b].named_parameters())
    # the twins in other sum orders: the spread's, then the control
    orders = [dict(models[side].named_parameters())
              for side, _, _ in sides[2:]]
    control = orders.pop() if twin16 else None
    scale, worst = {}, {}
    layers = {}                 # BERT layer -> worst own shares (k, o)
    ratios = []                 # (err / (grad_rel own + spread), name)
    controls = []               # the same of the control order
    for n, q in named.items():
        part = n.split(".")[0]
        scale[part] = max(scale.get(part, 0.0), q.grad.abs().max().item())
    for n, p in models[a].named_parameters():
        q = named[n]
        ga, gb = p.grad.cpu(), q.grad.cpu()
        part = n.split(".")[0]
        if twin16:
            own = gb.abs().max().item()
            spread = max((o[n].grad.cpu() - gb).abs().max().item()
                         for o in orders)
            e = _close_rel(f"grad {n}", ga, gb, grad_rel,
                           TWIN_ORDER_X * spread + SUM_ATOL)
            unit = grad_rel * own + spread + SUM_ATOL
            ratios.append((e / unit, n))
            c = (control[n].grad.cpu() - gb).abs().max().item()
            controls.append((c / unit, n))
            k, o = worst.get(part, (0.0, 0.0))
            worst[part] = (max(k, e / scale[part]),
                           max(o, spread / scale[part]))
            if ".layer." in n:
                i = int(n.split(".layer.")[1].split(".")[0])
                k, o = layers.get(i, (0.0, 0.0))
                layers[i] = (max(k, e / max(own, 1e-30)),
                             max(o, spread / max(own, 1e-30)))
            grad_err = max(grad_err, e)
        elif bf16 and not twin16 and part in shares:
            # each gradient against its component's largest (GRAD16)
            e = _close_rel(f"grad {n}", ga, gb, 0.0,
                           shares[part] * scale[part])
            worst[part] = max(worst.get(part, 0.0), e / scale[part])
            grad_err = max(grad_err, e)
        else:
            grad_err = max(grad_err, _close_rel(f"grad {n}", ga, gb,
                                                grad_rel))
        # Adam's update follows the gradient with the L2 term added
        e, u = _sign_stable_update_check(f"param {n}", p.detach().cpu(),
                                         q.detach().cpu(), ga + l2 * init[n],
                                         gb + l2 * init[n], lr)
        upd_err, unstable = max(upd_err, e), unstable + u
        n_params += p.numel()
    within = (f"every gradient within {shares} of its component's largest "
              f"(worst share {worst})" if bf16 else
              f"every gradient within {grad_rel} * its max-abs")
    if twin16:
        ratios.sort(reverse=True)
        controls.sort(reverse=True)
        within = (f"every gradient within {grad_rel} * its max-abs plus "
                  f"{TWIN_ORDER_X} * its spread over the twins in "
                  f"{len(orders)} other sum orders (err / (that share + the "
                  f"spread), the worst five: " + ", ".join(
                      f"{n} {r:.3f}" for r, n in ratios[:5])
                  + f"; above 1: {sum(r > 1 for r, _ in ratios)} of "
                  f"{len(ratios)}; the control order's, {sides[-1][0]} vs "
                  f"{b}, for the same: worst {controls[0][1]} "
                  f"{controls[0][0]:.3f}, above 1: "
                  f"{sum(r > 1 for r, _ in controls)}; worst component "
                  f"shares, {a} vs {b} / spread: {worst})")
        print(f"{label}: BERT layer, worst own share {a} vs {b} / the "
              f"spread over the other sum orders: " + ", ".join(
                  f"{i} {k:.3e}/{o:.3e}"
                  for i, (k, o) in sorted(layers.items(), reverse=True)))
    print(f"one {label} training step, {a} vs {b}: loss {loss_a:.6f} vs "
          f"{loss_b:.6f}; {within} (worst abs err {grad_err:.3e}); updated "
          f"params max|diff| {upd_err:.3e}, {unstable} of {n_params} "
          f"elements with a sign-unstable gradient; each side's model and "
          f"step took {', '.join(f'{k} {v:.1f} s' for k, v in took.items())}")
    return counts


def _time_train_step(trainer, label, card, layouts=("std",), steps=12):
    """CUDA-synchronised median of ``steps`` training steps of each fusion
    layout, after 3 of warm-up; two layouts run in turns (a, b, b, a), half
    the steps a turn."""
    bs = trainer.cfg.batch_size
    batches = [b for b, _ in trainer.batches("train")]
    order = list(layouts) + (list(layouts[::-1]) if len(layouts) > 1 else [])
    per = steps * len(layouts) // len(order)
    times = {lay: [] for lay in layouts}
    peak = dict.fromkeys(layouts, 0.0)
    for lay in order:
        with _layout(lay):
            for i in range(3):
                trainer.train_step(batches[i % len(batches)],
                                   trainer.generator)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for i in range(per):
                t0 = time.perf_counter()
                trainer.train_step(batches[i % len(batches)],
                                   trainer.generator)
                torch.cuda.synchronize()
                times[lay].append(1e3 * (time.perf_counter() - t0))
            peak[lay] = max(peak[lay],
                            torch.cuda.max_memory_allocated() / 2 ** 20)
    for lay in layouts:
        q1, med, q3 = np.percentile(times[lay], [25, 50, 75])
        name = label if len(layouts) == 1 else f"{label} ({lay} layout)"
        print(f"{name} training step (fwd + bwd + K5, batch {bs}, host batch "
              f"prepared): median {med:.3f} ms (q1 {q1:.3f}, q3 {q3:.3f}) "
              f"over {len(times[lay])} steps; {bs / med * 1e3:.2f} "
              f"subjects/s; peak device memory {peak[lay]:.0f} MiB; card: "
              f"{card}")


def flagship_bp(rng, card):
    """The flagship on the bp fusion layout at batch 16 (G = 8, two
    groups): a 1-epoch ``Trainer`` run (32 train, 16 val subjects, the
    config's dropout rates) that launches K1, K4, K5 and the four K7
    kernels and never K2/K3; serving the val subjects from its checkpoint,
    logits against the std layout on the card; one training step bp vs std
    from the same weights, batch and generator state with the fusion
    dropout rates at 0 and DropPath on (exact K7 launch counts a step); the
    training and predict steps of both layouts, timed in turns. Returns the
    training run's launch counts."""
    from multimodal_neuroimage_tpu_torch.ops import build
    cfg = _flagship_cfg(batch_size=BP_BATCH, nEpochs=1,
                        experiment_title="flagship_bp")
    train_records = _cohort(rng, BP_TRAIN, 100)
    val_records = _cohort(rng, BP_VAL, 100 + BP_TRAIN)
    path = set(BP_STEP)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp, \
            _layout("bp"):
        trainer, metrics, counts, wall = _train(
            cfg, train_records, val_records, tmp, "flagship bp")
        if (any(counts[k] == 0 for k in path)
                or any(n for k, n in counts.items() if k not in path)):
            raise AssertionError(f"the bp training run did not launch "
                                 f"exactly {sorted(path)}: {counts}")
        _print_run("flagship bp", cfg, trainer, metrics, wall)
        requests = [{k: r[k] for k in ("subject", "fmri", "struct")}
                    for r in val_records]
        serve = _serve(cfg, trainer.best_checkpoint(), requests, tmp,
                       "flagship bp", card, reference="std")
        forward = {k for k in path if "backward" not in k and "adam" not in k}
        if (any(serve[k] == 0 for k in forward)
                or any(n for k, n in serve.items() if k not in forward)):
            raise AssertionError(f"the bp serving run did not launch exactly "
                                 f"{sorted(forward)}: {serve}")
    batch, _ = next(trainer.batches("train"))
    step_cfg = _flagship_cfg(batch_size=BP_BATCH, fusion_drop_rate=0.0,
                             fusion_attn_drop_rate=0.0)
    steps = _step_compare(step_cfg, batch, "flagship batch 16",
                          (("bp", "cuda", "bp"), ("std", "cuda", "std")))
    want = {k: BP_STEP.get(k, 0) for k in steps["bp"]}
    if steps["bp"] != want:
        raise AssertionError(f"one bp training step launched {steps['bp']}, "
                             f"expected {want}")
    print(f"launches in one bp training step: {steps['bp']}")
    _time_train_step(trainer, "flagship batch 16", card, ("bp", "std"))
    return counts


def _time_dtypes(cfg, batches, combos, label, card, steps=12,
                 optim="AdamW"):
    """Training steps of one model at each (fusion layout, compute dtype) of
    ``combos``, timed in turns (the combos, then again in reverse, half the
    steps a turn) after 3 of warm-up each: CUDA-synchronised median and
    quartiles, subjects/s and peak device memory."""
    from multimodal_neuroimage_tpu_torch.models.registry import (
        create_model, init_random_weights)
    from multimodal_neuroimage_tpu_torch.train.losses import active_losses
    from multimodal_neuroimage_tpu_torch.train.state import (create_optimizer,
                                                             make_train_step)
    model = init_random_weights(create_model(cfg),
                                torch.Generator().manual_seed(SEED + 3))
    model.cuda()
    opt = create_optimizer(optim, model.parameters(), lambda t: 1e-4,
                           cfg.weight_decay)
    specs = active_losses(cfg.task, cfg.fine_tune_task)
    gen = torch.Generator().manual_seed(SEED + 4)
    fns = {d: make_train_step(model, specs, opt, d, "cuda")
           for d in {d for _, d in combos}}
    times = {c: [] for c in combos}
    peak = dict.fromkeys(combos, 0.0)
    for turn in list(combos) + list(combos)[::-1]:
        lay, dtype = turn
        with _layout(lay):
            for i in range(3):
                fns[dtype](batches[i % len(batches)], gen)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for i in range(steps // 2):
                t0 = time.perf_counter()
                fns[dtype](batches[i % len(batches)], gen)
                torch.cuda.synchronize()
                times[turn].append(1e3 * (time.perf_counter() - t0))
            peak[turn] = max(peak[turn],
                             torch.cuda.max_memory_allocated() / 2 ** 20)
    bs = cfg.batch_size
    for lay, dtype in combos:
        q1, med, q3 = np.percentile(times[lay, dtype], [25, 50, 75])
        print(f"{label} training step, {lay} layout, {dtype} (fwd + bwd + "
              f"K5, batch {bs}, timed in turns): median {med:.3f} ms (q1 "
              f"{q1:.3f}, q3 {q3:.3f}) over {len(times[lay, dtype])} steps; "
              f"{bs / med * 1e3:.2f} subjects/s; peak device memory "
              f"{peak[lay, dtype]:.0f} MiB; card: {card}")


def _exact_path(counts, path, label):
    """Every kernel of ``path`` launched, and no other."""
    if (any(counts[k] == 0 for k in path)
            or any(n for k, n in counts.items() if k not in path)):
        raise AssertionError(f"the {label} did not launch exactly "
                             f"{sorted(path)}: {counts}")


def _bp16_step(cfg):
    """The launches of one bp training step of the bf16 flagship ``cfg``:
    a K1 mm16 layer a band, the stacks' self blocks (two branches of Ex,
    the CRSTBs' two streams, Re) and the CRSTBs' two directed cross calls a
    block, on K7's bf16 form; 10 SwinV2 blocks; K5 once (BP16_STEP at the
    full depth)."""
    layers = 2 * cfg.transformer_hidden_layers
    own = (2 * sum(cfg.fusion_ex_depths) + 2 * sum(cfg.fusion_depths)
           + sum(cfg.fusion_re_depths))
    cross = 2 * sum(cfg.fusion_depths)
    return {"K1 bert_layer mm16": layers, "K1 bert_layer backward mm16": layers,
            "K7 fusion_block_bp bf16": own,
            "K7 fusion_block_bp backward bf16": own,
            "K7 cross_fusion_block_bp bf16": cross,
            "K7 cross_fusion_block_bp backward bf16": cross,
            "K4 window_attention": 10, "K4 window_attention backward": 10,
            "K5 fused_adam": 1}


def flagship_bf16(rng, card, train_records, val_records):
    """The flagship at its shipping policy, compute_dtype="bfloat16" (K1's
    mm16 form; K2/K3 on float32 streams with bf16 weights; K7 on bf16
    streams): a 2-epoch ``Trainer`` run at batch 4 on the std layout that
    launches exactly FLAGSHIP16_KERNELS; serving its best checkpoint, logits
    against the CPU at the same policy; one training step card vs CPU on the
    std layout (batch 4) and on bp (batch 8, one group of 8), both at
    CPU_STEP_DEPTH with 2 BERT layers a band; a 1-epoch run
    on bp at batch 16 (exactly the BP16_STEP kernels) and its serving
    against the std layout; bf16 and float32 training steps timed in turns
    at batch 4 (std) and batch 16 (std and bp), with peak memory. Returns
    the launch counts of the two training runs."""
    from multimodal_neuroimage_tpu_torch.ops import build
    cfg = _flagship_cfg(compute_dtype="bfloat16",
                        experiment_title="flagship_bf16")
    forward = [k for k in FLAGSHIP16_KERNELS
               if "backward" not in k and "adam" not in k]
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        trainer, metrics, counts, wall = _train(
            cfg, train_records, val_records, tmp, "flagship bf16")
        _exact_path(counts, FLAGSHIP16_KERNELS, "bf16 training run")
        _print_run("flagship bf16", cfg, trainer, metrics, wall)
        requests = [{k: r[k] for k in ("subject", "fmri", "struct")}
                    for r in val_records]
        serve = _serve(cfg, trainer.best_checkpoint(), requests, tmp,
                       "flagship bf16", card)
        _exact_path(serve, forward, "bf16 serving run")
    batch, _ = next(trainer.batches("train"))
    _step_compare(dataclasses.replace(cfg, transformer_hidden_layers=2,
                                      **CPU_STEP_DEPTH), batch,
                  "flagship bf16 (cut depth)",
                  (("card", "cuda", "std"), ("CPU", "cpu", "std")))
    # the full-depth step, kernels against their plain twins on the card
    _step_compare(cfg, batch, "flagship bf16 (full depth)",
                  (("card", "cuda", "std"),
                   ("plain twins on the card", "twins", "std"))
                  + tuple((f"plain twins, F in {n} slices",
                           f"twins-order-{n}", "std")
                          for n in TWIN_ORDER_SLICES + (TWIN_CONTROL,)),
                  twin16=True)
    batches4 = [b for b, _ in trainer.batches("train")]
    del trainer

    cfg16 = _flagship_cfg(compute_dtype="bfloat16", batch_size=BP_BATCH,
                          nEpochs=1, experiment_title="flagship_bp_bf16")
    train16 = _cohort(rng, BP_TRAIN, 200)
    val16 = _cohort(rng, BP_VAL, 200 + BP_TRAIN)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp, \
            _layout("bp"):
        trainer, metrics, bp_counts, wall = _train(
            cfg16, train16, val16, tmp, "flagship bp bf16")
        _exact_path(bp_counts, set(BP16_STEP), "bp bf16 training run")
        _print_run("flagship bp bf16", cfg16, trainer, metrics, wall)
        requests = [{k: r[k] for k in ("subject", "fmri", "struct")}
                    for r in val16]
        serve = _serve(cfg16, trainer.best_checkpoint(), requests, tmp,
                       "flagship bp bf16", card, reference="std")
        _exact_path(serve, {k for k in BP16_STEP
                            if "backward" not in k and "adam" not in k},
                    "bp bf16 serving run")
    batches16 = [b for b, _ in trainer.batches("train")]
    del trainer
    # card vs CPU on bp: batch 8, one group of G = 8, at CPU_STEP_DEPTH (the
    # CPU's step at the full width of batch 16 would take minutes)
    batch8 = {k: v[:8] for k, v in batches16[0].items()}
    step_cfg = _flagship_cfg(compute_dtype="bfloat16", batch_size=8,
                             transformer_hidden_layers=2, **CPU_STEP_DEPTH)
    steps = _step_compare(step_cfg, batch8,
                          "flagship bp bf16 batch 8 (cut depth)",
                          (("card", "cuda", "bp"), ("CPU", "cpu", "bp")))
    want = {k: _bp16_step(step_cfg).get(k, 0) for k in steps["card"]}
    if steps["card"] != want:
        raise AssertionError(f"one bp bf16 training step launched "
                             f"{steps['card']}, expected {want}")

    _time_dtypes(_flagship_cfg(), batches4,
                 (("std", "float32"), ("std", "bfloat16")),
                 "flagship batch 4", card)
    _time_dtypes(_flagship_cfg(batch_size=BP_BATCH), batches16,
                 (("std", "float32"), ("std", "bfloat16"),
                  ("bp", "float32"), ("bp", "bfloat16")),
                 "flagship batch 16", card)
    return counts, bp_counts


def hcp_bf16(card, train_records, val_records, keep):
    """HCP phase 1 at its default bf16 policy (``compute_dtype`` left at
    its default): every layer keeps a bf16 stream through K6's bf16 form. A
    2-epoch ``Trainer`` run that launches exactly 16 bf16 K6 forwards a
    pass, 16 bf16 K6 backwards and one K5 a step, and nothing else (no f32
    K6); serving its checkpoint (16 bf16 K6 forwards a pass, logits vs the
    CPU at the same policy); one training step card vs CPU (the same exact
    launches); float32 and bf16 steps timed in turns with peak memory.
    Returns the training run's launch counts and a copy of its best
    checkpoint in the directory ``keep``."""
    from multimodal_neuroimage_tpu_torch.ops import build
    cfg = _hcp_cfg(experiment_title="hcp_bf16")
    if cfg.compute_dtype != "bfloat16":
        raise AssertionError(f"HCP's default compute dtype is "
                             f"{cfg.compute_dtype}, expected bfloat16")
    layers = cfg.transformer_hidden_layers
    fwd16, bwd16 = "K6 fused_attention bf16", "K6 fused_attention backward bf16"
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        trainer, metrics, counts, wall = _train(
            cfg, train_records, val_records, tmp, "HCP bf16")
        steps = cfg.nEpochs * trainer.steps_per_epoch
        passes = -(-len(val_records) // cfg.batch_size)
        expect = {fwd16: layers * (steps + cfg.nEpochs * passes),
                  bwd16: layers * steps, "K5 fused_adam": steps}
        if counts != {k: expect.get(k, 0) for k in counts}:
            raise AssertionError(f"HCP bf16 training launches {counts}, "
                                 f"expected {expect} and no other kernel")
        _print_run("HCP bf16", cfg, trainer, metrics, wall)
        requests = [{k: r[k] for k in ("subject", "fmri")}
                    for r in val_records]
        serve = _serve(cfg, trainer.best_checkpoint(), requests, tmp,
                       "HCP bf16", card)
        if serve != {k: layers * passes if k == fwd16 else 0 for k in serve}:
            raise AssertionError(f"HCP bf16 serving launches {serve}: "
                                 f"expected {fwd16} {layers} x {passes} only")
        ckpt = shutil.copy(trainer.best_checkpoint(),
                           os.path.join(keep, "hcp_bf16.ckpt"))
    batches = [b for b, _ in trainer.batches("train")]
    del trainer
    # at a cut depth, as phase 6's HCP step (HCP_CPU_LAYERS)
    step = _step_compare(
        dataclasses.replace(cfg, transformer_hidden_layers=HCP_CPU_LAYERS),
        batches[0], "HCP bf16 (cut depth)",
        (("card", "cuda", "std"), ("CPU", "cpu", "std")))
    want = {k: {fwd16: HCP_CPU_LAYERS, bwd16: HCP_CPU_LAYERS,
                "K5 fused_adam": 1}.get(k, 0) for k in step["card"]}
    if step["card"] != want:
        raise AssertionError(f"one HCP bf16 training step launched "
                             f"{step['card']}, expected {want}")
    print(f"launches in one HCP bf16 training step: {want}")
    _time_dtypes(cfg, batches, (("std", "float32"), ("std", "bfloat16")),
                 "HCP batch 8", card)
    return counts, ckpt


def flagship_defaults(card, train_records, val_records):
    """The flagship at its full ``Config`` defaults: compute_dtype
    "bfloat16" and preprocess "device" (items carry the raw series, each
    batch is band-split on the card by ``ops/fir.py``). The device gear's
    bands of the val subjects against the host split within FIR_ATOL, each
    gear's time; a 1-epoch ``Trainer`` run (exactly FLAGSHIP16_KERNELS) and
    serving its checkpoint (logits vs the CPU at the same policy). Returns
    the training run's launch counts."""
    from multimodal_neuroimage_tpu_torch.config import Config
    from multimodal_neuroimage_tpu_torch.data.loader import (
        collate, device_preprocess, item_for)
    from multimodal_neuroimage_tpu_torch.ops import build
    cfg = Config(task="FuncStruct", dataset_name="multimodal",
                 multimodality_type="cross_attention", target="sex",
                 fine_tune_task="binary_classification", batch_size=BATCH,
                 nEpochs=1, experiment_title="flagship_defaults",
                 seed=SEED).validate()
    if (cfg.compute_dtype, cfg.preprocess) != ("bfloat16", "device"):
        raise AssertionError(f"the flagship's defaults are "
                             f"{cfg.compute_dtype}, {cfg.preprocess}")
    host = dataclasses.replace(cfg, preprocess="host")
    t0 = time.perf_counter()
    want, _ = collate([item_for(host)(r, host) for r in val_records])
    host_ms = (time.perf_counter() - t0) * 1e3 / len(val_records)
    raw, _ = collate([item_for(cfg)(r, cfg) for r in val_records])
    got = device_preprocess(raw, cfg, "cuda")
    torch.cuda.synchronize()
    errs = {k: _close(f"device gear {k}", got[k].cpu(),
                      torch.from_numpy(want[k]), FIR_ATOL, 0.0)
            for k in ("fmri_raw_sequence", "fmri_lowfreq_sequence",
                      "fmri_ultralowfreq_sequence")}
    four = {k: v[:BATCH] for k, v in raw.items()}
    dev_ms = events_ms(lambda: device_preprocess(four, cfg, "cuda"), 10)
    print(f"device FIR gear on the card vs the host split, {len(val_records)}"
          f" subjects: max|err| {errs} (atol {FIR_ATOL}); device split "
          f"{dev_ms:.3f} ms a batch of {BATCH} (raw batch copied in), host "
          f"split {host_ms:.3f} ms a subject; card: {card}")
    forward = [k for k in FLAGSHIP16_KERNELS
               if "backward" not in k and "adam" not in k]
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        trainer, metrics, counts, wall = _train(
            cfg, train_records, val_records, tmp, "flagship defaults")
        _exact_path(counts, FLAGSHIP16_KERNELS, "defaults training run")
        _print_run("flagship defaults", cfg, trainer, metrics, wall)
        requests = [{k: r[k] for k in ("subject", "fmri", "struct")}
                    for r in val_records]
        serve = _serve(cfg, trainer.best_checkpoint(), requests, tmp,
                       "flagship defaults", card)
        _exact_path(serve, forward, "defaults serving run")
    return counts


def _gear_rates(cfg, records, card):
    """Host-side items/s of the three gears on the on-disk ``records`` at
    batch 4 and 16: each gear's batches made on the host (``to_device``
    off; the device gear's band split is not in it), one pass to warm up
    (the native gear builds its library there), then the median of three
    timed passes; real items only (the padded tail's pad rows not
    counted). Prints them."""
    from multimodal_neuroimage_tpu_torch.data.loader import DataPipeline
    rates = {}
    for gear in ("host", "device", "native"):
        for bs in GEAR_BATCHES:
            gcfg = dataclasses.replace(cfg, preprocess=gear, batch_size=bs)
            pipe = DataPipeline(gcfg, splits={"predict": records},
                                device="cuda")

            def one_pass():
                t0 = time.perf_counter()
                n = sum(x is not None for _, names in pipe.epoch(
                    "predict", to_device=False) for x in names)
                return n / (time.perf_counter() - t0)
            one_pass()
            rates[f"{gear} batch {bs}"] = statistics.median(
                one_pass() for _ in range(3))
    print(f"host data path, {len(records)} on-disk subjects, {cfg.workers} "
          f"workers, items/s (host side): " + ", ".join(
              f"{k} {v:.1f}" for k, v in rates.items()) + f"; card: {card}")


def _native_vs_host(cfg, records):
    """The native gear's batches against the host gear's on the same
    subjects: bands within NATIVE_ATOL, structural matrices at float16
    grain within NATIVE_STRUCT. Returns the worst errors."""
    from multimodal_neuroimage_tpu_torch.data.loader import DataPipeline

    def batches(gear):
        pipe = DataPipeline(dataclasses.replace(cfg, preprocess=gear),
                            splits={"predict": records}, device="cuda")
        return list(pipe.epoch("predict", to_device=False))
    errs = {}
    for (nb, nn), (hb, hn) in zip(batches("native"), batches("host")):
        if nn != hn:
            raise AssertionError(f"native and host batches differ: {nn} "
                                 f"vs {hn}")
        matrices = [k for k in ("struct", "smri", "dti") if k in nb]
        got = {k: nb[k] for k in ("fmri_raw_sequence", "fmri_lowfreq_sequence",
                                  "fmri_ultralowfreq_sequence") if k in nb}
        got.update({k: nb[k].astype(np.float16) for k in matrices})
        if not matrices or set(got) - set(hb):
            raise AssertionError(f"native batch keys {sorted(nb)}")
        for key, value in got.items():
            tol = NATIVE_STRUCT if key in matrices else NATIVE_ATOL
            np.testing.assert_allclose(value, hb[key], atol=tol,
                                       rtol=tol if key in matrices else 0,
                                       err_msg=f"native gear {key}")
            err = float(np.abs(value.astype(np.float64) - hb[key]).max())
            errs[key] = max(errs.get(key, 0.0), err)
    return errs


def disk_cohorts(card, hcp_ckpt):
    """The flagship and HCP from cohorts on disk written by the port's
    writer (data/synthetic.py), through the entry points a user calls. The
    flagship at its full ``Config`` defaults (bf16, device gear, std
    layout, batch 4): ``Trainer(cfg).training()`` for one epoch (7 steps,
    exactly FLAGSHIP16_KERNELS, a best-AUROC checkpoint),
    ``Trainer(cfg, sets=["test"]).testing()``, ``run_predict(cfg)`` (the
    40 subjects once each, scores bit-equal to an in-memory ``Predictor``
    on the same arrays in the same order); the native gear's batches
    against the host gear's, one ``run_predict`` through each, each gear's
    host-side items/s. HCP at its ``Config`` defaults: 16 subjects served
    by ``run_predict`` from phase 7's checkpoint (``hcp_ckpt``), exactly
    16 bf16 K6 forwards a pass and nothing else. Returns the flagship's
    training-run and the HCP serving-run launch counts."""
    from multimodal_neuroimage_tpu_torch import ops
    from multimodal_neuroimage_tpu_torch.ckpt.checkpoint import (
        latest_checkpoint)
    from multimodal_neuroimage_tpu_torch.data import synthetic
    from multimodal_neuroimage_tpu_torch.data.datasets import ItemLoader
    from multimodal_neuroimage_tpu_torch.data.index import build_subject_index
    from multimodal_neuroimage_tpu_torch.ops import build
    from multimodal_neuroimage_tpu_torch.serve.predictor import (Predictor,
                                                                 run_predict)
    from multimodal_neuroimage_tpu_torch.train.trainer import Trainer
    t_phase = time.perf_counter()
    forward = [k for k in FLAGSHIP16_KERNELS
               if "backward" not in k and "adam" not in k]
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        root = synthetic.generate_synthetic_cohort(
            os.path.join(tmp, "abcd"), n_subjects=DISK_SUBJECTS, seed=SEED)
        exp = os.path.join(tmp, "exp")
        cfg = synthetic.synthetic_config(
            root, task="FuncStruct", dataset_name="multimodal",
            multimodality_type="cross_attention", target="sex",
            fine_tune_task="binary_classification", batch_size=BATCH,
            nEpochs=1, experiment_folder=exp,
            experiment_title="flagship_disk", seed=SEED).validate()
        if (cfg.compute_dtype, cfg.preprocess) != ("bfloat16", "device"):
            raise AssertionError(f"the flagship's defaults are "
                                 f"{cfg.compute_dtype}, {cfg.preprocess}")
        trainer = Trainer(cfg, device="cuda")
        sizes = {k: len(v) for k, v in trainer.pipeline.splits.items()}
        if sizes != {"train": 28, "val": 6, "test": 6}:
            raise AssertionError(f"on-disk split sizes {sizes}")
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        metrics = trainer.training()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launches()
        print(f"launches in the on-disk flagship training run: {counts}")
        _exact_path(counts, FLAGSHIP16_KERNELS, "on-disk training run")
        if (trainer.steps_per_epoch != 7
                or not np.isfinite(trainer.step_losses).all()):
            raise AssertionError(f"on-disk training: {trainer.step_losses}")
        ckpt = trainer.best_checkpoint()
        if ckpt is None:
            raise AssertionError("no on-disk best-AUROC checkpoint")
        _print_run("flagship from disk", cfg, trainer, metrics, wall)
        del trainer

        t0 = time.perf_counter()
        tester = Trainer(cfg, sets=["test"], device="cuda")
        test = tester.testing()
        if (tester.checkpoint_path != latest_checkpoint(exp)
                or "test_AUROC" not in test):
            raise AssertionError(f"testing from {tester.checkpoint_path}: "
                                 f"{test}")
        print(f"flagship from disk: testing() on the 6 test subjects from "
              f"{os.path.basename(tester.checkpoint_path)} at its frozen "
              f"threshold {tester.val_threshold} in "
              f"{time.perf_counter() - t0:.2f} s: test_AUROC "
              f"{test['test_AUROC']}, test_Balanced_Accuracy "
              f"{test['test_Balanced_Accuracy']}")
        del tester

        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        scores = run_predict(cfg)
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t0
        _exact_path(ops.launches(), forward, "on-disk serving run")
        records = build_subject_index(cfg, require_target=False)
        names = [r.subject for r in records]
        with open(os.path.join(exp, "predictions.csv")) as f:
            rows = [line.split(",")[0] for line in f.read().splitlines()[1:]]
        if (len(names) != DISK_SUBJECTS or list(scores) != names
                or sorted(rows) != sorted(names)):
            raise AssertionError(f"run_predict scored {len(scores)} "
                                 f"subjects, {len(rows)} rows")
        loader = ItemLoader(cfg)
        memory = Predictor(cfg, ckpt, [loader.load(r) for r in records],
                           device="cuda").predict()
        if memory != scores:
            raise AssertionError("on-disk scores differ from the in-memory "
                                 "Predictor's on the same arrays")
        print(f"flagship from disk: run_predict scored {len(scores)} "
              f"subjects in {pwall:.2f} s ({len(scores) / pwall:.2f} "
              f"subjects/s end to end, disk reads included), each once in "
              f"predictions.csv, bit-equal to the in-memory Predictor; "
              f"card: {card}")

        errs = _native_vs_host(cfg, records)
        print(f"native gear vs the host split, {len(records)} subjects: "
              f"max|err| {errs} (bands atol {NATIVE_ATOL}, struct at "
              f"float16 grain atol/rtol {NATIVE_STRUCT})")
        for gear in ("native", "host"):
            ops.reset_launches()
            other = run_predict(dataclasses.replace(cfg, preprocess=gear))
            _exact_path(ops.launches(), forward, f"{gear}-gear serving run")
            if list(other) != names:
                raise AssertionError(f"{gear} gear scored {len(other)} "
                                     f"subjects")
            print(f"run_predict through the {gear} gear: max |score - device "
                  f"gear's| " + str(max(abs(other[n]["score"]
                                            - scores[n]["score"])
                                        for n in names)))
        _gear_rates(cfg, records, card)

        hroot = synthetic.generate_synthetic_hcp(
            os.path.join(tmp, "hcp"), n_subjects=DISK_HCP, seed=SEED)
        hcp = _hcp_cfg(base_path=hroot,
                       hcp_path=os.path.join(hroot, "data", "hcp"),
                       experiment_folder=os.path.join(tmp, "hexp"),
                       model_weights_path=hcp_ckpt)
        layers = hcp.transformer_hidden_layers
        passes = -(-DISK_HCP // hcp.batch_size)
        fwd16 = "K6 fused_attention bf16"
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        hscores = run_predict(hcp)
        torch.cuda.synchronize()
        hwall = time.perf_counter() - t0
        hcounts = ops.launches()
        if hcounts != {k: layers * passes if k == fwd16 else 0
                       for k in hcounts}:
            raise AssertionError(f"HCP on-disk serving launches {hcounts}: "
                                 f"expected {fwd16} {layers} x {passes} only")
        if len(hscores) != DISK_HCP:
            raise AssertionError(f"HCP run_predict scored {len(hscores)}")
        print(f"HCP from disk: run_predict scored {len(hscores)} subjects "
              f"in {hwall:.2f} s from {os.path.basename(hcp_ckpt)}; "
              f"launches {hcounts}")
    print(f"on-disk phase took {time.perf_counter() - t_phase:.1f} s; "
          f"card: {card}")
    return counts, hcounts


def _struct_cfg(root, phase, dataset, folder, title, **kw):
    """Phase ``phase``'s ``Config`` (its defaults: bf16 policy; phase 3
    batch 4 and Adam, phase 6 batch 8, AdamW and fusion dropout 0.8) on the
    cohort at ``root``; ``kw`` and the names here are set by the user."""
    from multimodal_neuroimage_tpu_torch.config import config_for_phase
    from multimodal_neuroimage_tpu_torch.data import synthetic
    user = dict(dataset_name=dataset, target="sex",
                fine_tune_task="binary_classification", seed=SEED,
                experiment_folder=folder, experiment_title=title, **kw)
    return config_for_phase(synthetic.synthetic_config(root, **user), phase,
                            user_set=set(user))


def _per_pass(counts, forward, backward, steps, passes, label):
    """Exactly ``forward`` a forward pass (``passes`` of them),
    ``backward`` a step (``steps``), K5 once a step, and no other kernel."""
    want = {k: n * passes for k, n in forward.items()}
    want.update({k: n * steps for k, n in backward.items()})
    if steps:
        want["K5 fused_adam"] = steps
    _exact(counts, want, label)


def _exact(counts, want, label):
    """``want`` launches of each kernel and none of any other."""
    if counts != {k: want.get(k, 0) for k in counts}:
        raise AssertionError(f"the {label} launched {counts}, expected "
                             f"exactly {want}")


def struct_kernels(gen, res: Results, n_params):
    """K5 in adam mode (L2 into the gradient, phase 3's optimizer) at the
    phase-3 models' parameter counts, with and without clipping, against
    ``fused_adam_reference``, timed in turns beside its plain version,
    ``torch.optim.Adam(fused=True)`` and K5 in adamw mode on the same
    buffers; K2/K3 at phase 6's dropout 0.8 (hidden and attention) and
    DropPath, batch 8, shifts 0 and 3: the training forward (its saved x2r
    too) and the backward against their plain versions on the same hash
    masks, timed in turns beside their plain versions and themselves at the
    flagship's rate 0.1. Recorded as the kernels' path cases."""
    from multimodal_neuroimage_tpu_torch.nn.swin2d import shift_attn_mask
    from multimodal_neuroimage_tpu_torch.ops import fused_update as fu
    from multimodal_neuroimage_tpu_torch.ops import fusion_block as fb
    dev = "cuda"
    for label, n in n_params.items():
        pk, gk, mk = (torch.randn(n, generator=gen).to(dev) for _ in range(3))
        nk = torch.rand(n, generator=gen).to(dev)
        for clip in (None, torch.tensor([0.5], device=dev)):
            state = [t.clone() for t in (pk, mk, nk)]
            args = (clip, 1e-4, 10.0, 1000.0, 0.9, 0.999, 1e-8, 1e-5, False)
            fu.fused_adam_update(pk, gk, mk, nk, *args)
            fu.fused_adam_reference(state[0], gk, state[1], state[2], *args)
            torch.cuda.synchronize()
            err = max(_close(f"K5 adam {label} {name}", a, b, ATOL, RTOL)
                      for name, a, b in zip(("p", "mu", "nu"), (pk, mk, nk),
                                            state))
            flat = torch.nn.Parameter(pk.clone())
            flat.grad = gk.clone()
            adam = torch.optim.Adam([flat], lr=1e-4, betas=(0.9, 0.999),
                                    eps=1e-8, weight_decay=1e-5, fused=True)
            plain_ms, ms, lib_ms, adamw_ms = _turns([
                lambda: fu.fused_adam_reference(state[0], gk, state[1],
                                                state[2], *args),
                lambda: fu.fused_adam_update(pk, gk, mk, nk, *args),
                adam.step,
                lambda: fu.fused_adam_update(pk, gk, mk, nk, *args[:-1],
                                             True)])
            # ~18 operations an element (L2 adds one multiply-add);
            # p, g, mu, nu read, p, mu, nu written
            tag = f"adam, {label}, {n} params, clip {clip is not None}"
            bound, by = res.path_case("K5 fused_adam", "smri_swin", tag, err,
                                      ms, plain_ms, 18 * n, 7 * 4 * n,
                                      lib_ms, adamw_ms=adamw_ms)
            print(f"K5 fused_adam {tag}: max|err| {err:.3e} (atol {ATOL} + "
                  f"rtol {RTOL})  kernel {ms:.4f} ms  plain {plain_ms:.4f} "
                  f"ms  bound {bound:.6f} ms ({by})  torch.optim.Adam(fused="
                  f"True) {lib_ms:.4f} ms  K5 adamw {adamw_ms:.4f} ms")

    C, Hh, N, nW, B = 12, 6, 36, 196, 8
    self_p, cross_p, bias, _, _ = _fusion_inputs(gen)
    xb, yb, gw = (torch.randn(B, nW, N, C, generator=gen).to(dev)
                  for _ in range(3))
    dp = ((torch.rand(B, 2, generator=gen) > 0.1).float() / 0.9).to(dev)
    seed, rates = 2468, (0.8, 0.8)
    fops = _fusion_ops(B, nW, N, C, Hh)
    for shift in (0, 3):
        m = shift_attn_mask(84, 84, 6, shift)
        mask = None if m is None else torch.from_numpy(m).to(dev)
        for cross, key, p_ in ((False, "K2 fusion_block", self_p),
                               (True, "K3 cross_fusion_block", cross_p)):
            y_ = yb if cross else None
            streams = (xb, yb) if cross else (xb,)
            tag = f"rate 0.8 B {B} shift {shift}"

            def fwd(p_=p_, y_=y_, mask=mask, cross=cross, r=rates):
                return fb._launch_forward(xb, y_, p_, bias, mask, dp, seed,
                                          r, True, True, cross)

            def ref(p_=p_, y_=y_, mask=mask, cross=cross):
                return fb._block_reference(xb, y_, p_, bias, mask, dp, seed,
                                           rates, True, cross)
            (out, x2r), want = fwd(), ref()
            no_fc2 = p_[:-2] + tuple(torch.zeros_like(t) for t in p_[-2:])
            want_x2r = fb._block_reference(xb, y_, no_fc2, bias, mask, dp,
                                           seed, rates, True, cross)
            torch.cuda.synchronize()
            err = max(_close(f"{key} {tag}", out, want, ATOL, RTOL),
                      _close(f"{key} {tag} x2r", x2r, want_x2r, ATOL, RTOL))
            # the flagship's rate 0.1 on the same inputs, timed in turns
            plain_ms, ms, ms01 = _turns([ref, fwd,
                                         lambda: fwd(r=(0.1, 0.1))])
            bound, by = res.path_case(key, "swinfusion_struct", tag, err, ms,
                                      plain_ms, sum(fops),
                                      _nbytes(*streams, xb, xb, bias, mask,
                                              dp, *p_), rate_01_ms=ms01)
            print(f"{key} {tag} (training forward): max|err| {err:.3e}  "
                  f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  bound "
                  f"{bound:.6f} ms ({by})  kernel at rate 0.1 {ms01:.4f} ms")

            x2r01 = fwd(r=(0.1, 0.1))[1]
            if cross:
                def kern(p_=p_, mask=mask, x2r=x2r, r=rates):
                    return fb.fused_cross_fusion_block_backward(
                        gw, xb, yb, p_, bias, mask, dp, seed, r, True, x2r)
                ins, plain = _plain_backward(
                    lambda x_, y2, b_, *q, mask=mask:
                        fb.cross_fusion_block_reference(
                            x_, y2, q, b_, mask, dp, seed, rates, True),
                    (xb, yb, bias) + p_, gw)
            else:
                def kern(p_=p_, mask=mask, x2r=x2r, r=rates):
                    return fb.fused_fusion_block_backward(
                        gw, xb, p_, bias, mask, dp, seed, r, True, x2r)
                ins, plain = _plain_backward(
                    lambda x_, b_, *q, mask=mask: fb.fusion_block_reference(
                        x_, q, b_, mask, dp, seed, rates, True),
                    (xb, bias) + p_, gw)
            got, want = kern(), plain()
            torch.cuda.synchronize()
            n_in = len(streams)
            d_streams = got[:n_in]
            dbias, dparams = got[n_in], got[n_in + 1]
            errs = [_close(f"{key} backward {tag} d{'xy'[i]}", a, w, ATOL,
                           RTOL)
                    for i, (a, w) in enumerate(zip(d_streams, want))]
            errs.append(_close_rel(f"{key} backward {tag} dbias", dbias,
                                   want[n_in], SUM_REL))
            errs += [_close_rel(f"{key} backward {tag} dparams[{i}]", a, w,
                                SUM_REL)
                     for i, (a, w) in enumerate(zip(dparams,
                                                    want[n_in + 1:]))]
            plain_ms, ms, ms01 = _turns(
                [plain, kern,
                 lambda kern=kern: kern(x2r=x2r01, r=(0.1, 0.1))], 10)
            bkey = f"{key} backward"
            bound, by = res.path_case(
                bkey, "swinfusion_struct", tag, max(errs), ms, plain_ms,
                2 * fops[0], _nbytes(*streams, *streams, gw, dp, mask, bias,
                                     bias, *p_, *p_), rate_01_ms=ms01)
            print(f"{bkey} {tag}: max|err| {max(errs):.3e} (streams atol "
                  f"{ATOL} + rtol {RTOL}; sums {SUM_REL} * max|ref| + "
                  f"{SUM_ATOL})  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
                  f"bound {bound:.6f} ms ({by})  kernel at rate 0.1 "
                  f"{ms01:.4f} ms")


def _struct_batches(cfg, B, n=3):
    """``n`` host batches of B random matrices under ``cfg``'s keys, with
    targets (the timing inputs, as bench.py's)."""
    from multimodal_neuroimage_tpu_torch.data.loader import STRUCT_INPUTS
    rng = np.random.default_rng(SEED + B)
    return [{**{k: rng.normal(size=(B, 84, 84)).astype(np.float32)
                for k in STRUCT_INPUTS[cfg.dataset_name]},
             "target": (np.arange(B) % 2).astype(np.float32)}
            for _ in range(n)]


def _time_predict(cfg, batches, dtypes, label, card, steps=12):
    """Predict steps of one model at each compute dtype, timed in turns (the
    dtypes, then in reverse, half the steps a turn) after 3 of warm-up:
    CUDA-synchronised median and quartiles, subjects/s, peak memory."""
    from multimodal_neuroimage_tpu_torch.models.registry import (
        create_model, init_random_weights)
    from multimodal_neuroimage_tpu_torch.serve.predictor import (
        make_predict_step)
    from multimodal_neuroimage_tpu_torch.train.state import (
        flatten_parameters)
    model = init_random_weights(create_model(cfg),
                                torch.Generator().manual_seed(SEED + 5))
    model.cuda()
    flatten_parameters(model)
    fns = {d: make_predict_step(model, d, "cuda") for d in dtypes}
    times = {d: [] for d in dtypes}
    peak = dict.fromkeys(dtypes, 0.0)
    for d in list(dtypes) + list(dtypes)[::-1]:
        for i in range(3):
            fns[d](batches[i % len(batches)])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for i in range(steps // 2):
            t0 = time.perf_counter()
            fns[d](batches[i % len(batches)])
            torch.cuda.synchronize()
            times[d].append(1e3 * (time.perf_counter() - t0))
        peak[d] = max(peak[d], torch.cuda.max_memory_allocated() / 2 ** 20)
    bs = cfg.batch_size
    for d in dtypes:
        q1, med, q3 = np.percentile(times[d], [25, 50, 75])
        print(f"{label} predict step, {d} (batch {bs}, host batch prepared, "
              f"timed in turns): median {med:.3f} ms (q1 {q1:.3f}, q3 "
              f"{q3:.3f}) over {len(times[d])} steps; {bs / med * 1e3:.2f} "
              f"subjects/s; peak device memory {peak[d]:.0f} MiB; card: "
              f"{card}")


def _struct_phase(cfg, label, card, forward, backward, step_rel=None):
    """One phase from the cohort on disk, through the entry points a user
    calls: ``Trainer(cfg).training()`` with every count set to 0 just
    before it (exactly ``forward`` a forward, ``backward`` and K5 a step,
    nothing else; a best-AUROC checkpoint where the step is checked, else
    the run's default checkpoint or its last weights), ``Trainer(cfg,
    sets=["test"]).testing()``, ``run_predict(cfg)`` (every subject once,
    exactly ``forward`` a batch, equal to an in-memory ``Predictor`` on
    the same arrays in the same order), serving the val and test subjects
    in memory with the logits against the CPU's, and given ``step_rel`` one
    training step card vs CPU (SwinFusionNet's backbone at
    CPU_STEP_DEPTH), each gradient within ``step_rel`` of its max-abs. Returns the training run's counts and the checkpoint."""
    from multimodal_neuroimage_tpu_torch import ops
    from multimodal_neuroimage_tpu_torch.ckpt.checkpoint import (
        default_checkpoint, latest_checkpoint)
    from multimodal_neuroimage_tpu_torch.data.datasets import ItemLoader
    from multimodal_neuroimage_tpu_torch.data.index import build_subject_index
    from multimodal_neuroimage_tpu_torch.serve.predictor import (Predictor,
                                                                 run_predict)
    from multimodal_neuroimage_tpu_torch.train.trainer import Trainer
    t_run = time.perf_counter()
    trainer = Trainer(cfg, device="cuda")
    splits = trainer.pipeline.splits
    if {k: len(v) for k, v in splits.items()} != {"train": 28, "val": 6,
                                                 "test": 6}:
        raise AssertionError(f"{label}: split sizes of {cfg.dataset_name}")
    if trainer.optimizer.adamw != (cfg.optim.lower() == "adamw"):
        raise AssertionError(f"{label}: K5 is not in {cfg.optim} mode")
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    metrics = trainer.training()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launches()
    steps = cfg.nEpochs * trainer.steps_per_epoch
    evals = cfg.nEpochs * -(-len(splits["val"]) // cfg.batch_size)
    _per_pass(counts, forward, backward, steps, steps + evals,
              f"{label} training run")
    if not np.isfinite(trainer.step_losses).all():
        raise AssertionError(f"{label}: {trainer.step_losses}")
    # the serving rule's file: the best-AUROC one, or (one epoch on 6 val
    # subjects can leave validation AUROC and accuracy at 0, and
    # BestCheckpointPolicy then writes nothing) the last epoch's
    ckpt = default_checkpoint(cfg)
    if step_rel is not None and ckpt != trainer.best_checkpoint():
        raise AssertionError(f"{label}: no best-AUROC checkpoint ({ckpt})")
    _print_run(label, cfg, trainer, metrics, wall, ckpt)
    print(f"launches in the {label} training run: "
          f"{ {k: n for k, n in counts.items() if n} }")

    # testing() restores as JAX's Trainer: the newest file of the folder
    tester = Trainer(cfg, sets=["test"], device="cuda")
    test = tester.testing()
    if (tester.checkpoint_path != latest_checkpoint(cfg.experiment_folder)
            or "test_AUROC" not in test):
        raise AssertionError(f"{label} testing(): {test}")
    print(f"{label}: testing() on the 6 test subjects from "
          f"{os.path.basename(tester.checkpoint_path)} at its frozen "
          f"threshold {tester.val_threshold}: test_AUROC "
          f"{test['test_AUROC']}, test_Balanced_Accuracy "
          f"{test['test_Balanced_Accuracy']}")

    records = build_subject_index(cfg, require_target=False)
    names = [r.subject for r in records]
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    scores = run_predict(cfg)
    torch.cuda.synchronize()
    pwall = time.perf_counter() - t0
    _per_pass(ops.launches(), forward, {}, 0,
              -(-len(names) // cfg.batch_size), f"{label} run_predict")
    with open(os.path.join(cfg.experiment_folder, "predictions.csv")) as f:
        rows = [line.split(",")[0] for line in f.read().splitlines()[1:]]
    loader = ItemLoader(cfg)
    memory = Predictor(cfg, ckpt, [loader.load(r) for r in records],
                       device="cuda").predict()
    if list(scores) != names or sorted(rows) != sorted(names) or (
            memory != scores):
        raise AssertionError(f"{label}: run_predict scored {len(scores)} "
                             f"subjects, not each once as the in-memory "
                             f"Predictor on the same batches")
    print(f"{label}: run_predict scored {len(scores)} subjects in "
          f"{pwall:.2f} s ({len(scores) / pwall:.2f} subjects/s, disk reads "
          f"included), each once, equal to the in-memory Predictor")

    requests = [loader.load(r) for r in splits["val"] + splits["test"]]
    with tempfile.TemporaryDirectory(dir=cfg.experiment_folder) as tmp:
        served = _serve(cfg, ckpt, requests, tmp, label, card,
                        f32_compute=True)
    _per_pass(served, forward, {}, 0, -(-len(requests) // cfg.batch_size),
              f"{label} serving run")
    if step_rel is not None:
        batch, _ = next(trainer.batches("train"))
        step_cfg = (dataclasses.replace(cfg, **CPU_STEP_DEPTH)
                    if cfg.task == "SwinFusion" else cfg)
        _step_compare(step_cfg, batch, label,
                      (("card", "cuda", "std"), ("CPU", "cpu", "std")),
                      optim=cfg.optim, f32_compute=True, grad_rel=step_rel)
        if cfg.task == "SwinFusion":
            # the full depth, kernels against their plain twins on the card
            _step_compare(cfg, batch, f"{label} (full depth)",
                          (("card", "cuda", "std"),
                           ("plain twins on the card", "twins", "std")),
                          optim=cfg.optim, f32_compute=True,
                          grad_rel=GRAD_REL)
    print(f"{label} phase took {time.perf_counter() - t_run:.1f} s")
    return counts, ckpt


def struct_phases(card, gen, res: Results):
    """The structural phases from a synthetic cohort on disk
    (data/synthetic.py writes its DTI, sMRI and DTI+sMRI matrices), each at
    its ``Config`` defaults through ``_struct_phase``: phase 3's
    ``SwinClassifier`` on sMRI (bench #1's ``smri_swin``: 2 epochs, the
    step card vs CPU), its VAE front on DTI and its UNet front on DTI+sMRI
    (1 epoch each), phase 6's ``SwinFusionNet`` on the sMRI + DTI pair
    (bench #4's ``swinfusion_struct``: 2 epochs, the step card vs CPU);
    first their kernels' new forms (``struct_kernels``). Then DTI and
    DTI+sMRI through the native gear (matrices vs the host items, one
    ``run_predict`` each), and the training and predict steps of the four
    models at the phase's batch and at 64, bf16 and float32 in turns.
    Returns the launch counts by path."""
    from multimodal_neuroimage_tpu_torch import ops
    from multimodal_neuroimage_tpu_torch.data import synthetic
    from multimodal_neuroimage_tpu_torch.data.index import build_subject_index
    from multimodal_neuroimage_tpu_torch.models.registry import create_model
    from multimodal_neuroimage_tpu_torch.ops import build
    from multimodal_neuroimage_tpu_torch.serve.predictor import run_predict
    t_phase = time.perf_counter()
    launches = {}
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        root = synthetic.generate_synthetic_cohort(
            os.path.join(tmp, "cohort"), n_subjects=DISK_SUBJECTS, seed=SEED)
        cfgs = {
            "smri_swin": _struct_cfg(root, 3, "sMRI",
                                     os.path.join(tmp, "smri_swin"),
                                     "smri_swin", nEpochs=2),
            "smri_swin_vae": _struct_cfg(root, 3, "DTI",
                                         os.path.join(tmp, "vae"),
                                         "smri_swin_vae", nEpochs=1,
                                         use_vae=True),
            "smri_swin_unet": _struct_cfg(root, 3, "DTI+sMRI",
                                          os.path.join(tmp, "unet"),
                                          "smri_swin_unet", nEpochs=1,
                                          use_unet=True),
            "swinfusion_struct": _struct_cfg(root, 6, "struct",
                                             os.path.join(tmp, "fusion"),
                                             "swinfusion_struct", nEpochs=2)}
        p3, p6 = cfgs["smri_swin"], cfgs["swinfusion_struct"]
        if ((p3.task, p3.batch_size, p3.optim, p3.compute_dtype)
                != ("VIT", 4, "Adam", "bfloat16")
                or (p6.task, p6.batch_size, p6.optim, p6.fusion_drop_rate,
                    p6.fusion_attn_drop_rate)
                != ("SwinFusion", 8, "AdamW", 0.8, 0.8)):
            raise AssertionError(f"phase defaults: {p3}, {p6}")
        struct_kernels(gen, res, {
            name: sum(p.numel() for p in create_model(cfgs[name]).parameters())
            for name in ("smri_swin", "smri_swin_unet", "smri_swin_vae")})
        ckpts = {}
        step_rel = {"smri_swin": GRAD_REL, "swinfusion_struct": GRAD_REL_DROP8}
        for name, cfg in cfgs.items():
            fusion = name == "swinfusion_struct"
            launches[name], ckpts[name] = _struct_phase(
                cfg, name, card, FUSION_FORWARD if fusion else SWIN_FORWARD,
                FUSION_BACKWARD if fusion else SWIN_BACKWARD,
                step_rel.get(name))

        # DTI and DTI+sMRI through the native gear, served from the VAE's
        # and the UNet's checkpoints
        disk = {}
        for name in ("smri_swin_vae", "smri_swin_unet"):
            cfg = dataclasses.replace(cfgs[name], preprocess="native",
                                      model_weights_path=ckpts[name])
            records = build_subject_index(cfg, require_target=False)
            errs = _native_vs_host(cfg, records)
            torch.cuda.synchronize()
            ops.reset_launches()
            scores = run_predict(cfg)
            counts = ops.launches()
            _per_pass(counts, SWIN_FORWARD, {}, 0,
                      -(-len(records) // cfg.batch_size),
                      f"{cfg.dataset_name} native run_predict")
            for k, n in counts.items():
                disk[k] = disk.get(k, 0) + n
            if len(scores) != len(records):
                raise AssertionError(f"native {cfg.dataset_name}: "
                                     f"{len(scores)} scores")
            print(f"{cfg.dataset_name} through the native gear: matrices "
                  f"vs the host items max|err| {errs} (float16 grain, "
                  f"atol/rtol {NATIVE_STRUCT}); run_predict scored "
                  f"{len(scores)} subjects")
        launches["struct_disk"] = disk

        for name, cfg in cfgs.items():
            for B in (cfg.batch_size, STRUCT_BENCH_BATCH):
                bcfg = dataclasses.replace(cfg, batch_size=B)
                batches = _struct_batches(bcfg, B)
                _time_dtypes(bcfg, batches, (("std", "bfloat16"),
                                             ("std", "float32")),
                             name, card, optim=cfg.optim)
                _time_predict(bcfg, batches, ("bfloat16", "float32"), name,
                              card)
    print(f"structural phases took {time.perf_counter() - t_phase:.1f} s; "
          f"card: {card}")
    return launches


# phase 5's combiners at their Config defaults (bf16 policy, batch 8,
# AdamW): the two 16-layer BERTs on K1's mm16 form, SwinV2 "large" on K4,
# and for the cross combiners the flagship backbone's K2/K3 (std layout);
# the CLI flags of each, from the step-3 checkpoint of the same cohort
K1_16_FORWARD = {"K1 bert_layer mm16": 32}
K1_16_BACKWARD = {"K1 bert_layer backward mm16": 32}
ADD_FORWARD = {**K1_16_FORWARD, **SWIN_FORWARD}
ADD_BACKWARD = {**K1_16_BACKWARD, **SWIN_BACKWARD}
CROSS_FORWARD = {**K1_16_FORWARD, **FUSION_FORWARD}
CROSS_BACKWARD = {**K1_16_BACKWARD, **FUSION_BACKWARD}
COMBINERS = {
    "funcstruct_add": (["--multimodality_type", "add"], "FuncStructAdd",
                       ADD_FORWARD, ADD_BACKWARD),
    "funcstruct_transfer": (["--multimodality_type", "transfer"],
                            "FuncStructTransfer", ADD_FORWARD,
                            ADD_BACKWARD),
    "funcstruct_unet_add": (["--multimodality_type", "add", "--use_unet"],
                            "FuncStructUNetAdd", ADD_FORWARD, ADD_BACKWARD),
    "funcstruct_unet_cross": (["--use_unet", "--use_unet_struct"],
                              "FuncStructUNetCross", CROSS_FORWARD,
                              CROSS_BACKWARD),
    "funcstruct_unet_cross_prs": (
        ["--use_unet", "--use_unet_struct", "--use_prs", "--dataset_name",
         "multimodal_prs"], "FuncStructUNetCrossPRS", CROSS_FORWARD,
        CROSS_BACKWARD),
}
CHAIN_BATCH = 8
# the full-depth bf16 flagship step against its plain twins on the card:
# each gradient within GRAD_REL of its own max-abs plus TWIN_ORDER_X times
# its spread, the largest distance from the twins of the twins in other
# orders of their float32 sums (K1's F slices added in each of
# TWIN_ORDER_SLICES parts, the merged q/k/v products). K1's mm16 form
# rounds the same products to bf16 as its twin, in other orders of float32
# sums, so a value can land on the other side of a bf16 rounding boundary,
# and the 16 layers, the fusion and the SwinV2 downstream carry it. The
# twin in one more order (TWIN_CONTROL slices) is measured against the
# same spread beside the kernels, a control: the kernels should sit where
# another sum order does.
TWIN_ORDER_SLICES = (2, 4, 8)
TWIN_CONTROL = 16
TWIN_ORDER_X = 2.0


class _Tee:
    """stdout kept while it is printed."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, text):
        self.parts.append(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()


def _cli(argv, label, card):
    """``cli.main(argv)`` on the card with every launch count set to 0 just
    before it: (metrics, counts, wall seconds, what it printed)."""
    from multimodal_neuroimage_tpu_torch import ops
    from multimodal_neuroimage_tpu_torch.cli import main as cli
    tee = _Tee(sys.stdout)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        metrics = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launches()
    print(f"[cli {label}] {wall:.1f} s; launches "
          f"{ {k: n for k, n in counts.items() if n} }; card: {card}")
    return metrics, counts, wall, "".join(tee.parts)


def _experiment(base, exp_name):
    """The one experiment folder of ``exp_name`` under ``base``."""
    found = glob.glob(os.path.join(base, "experiments", f"{exp_name}_*"))
    if len(found) != 1:
        raise AssertionError(f"experiment folders of {exp_name}: {found}")
    return found[0]


def _combiner_batches(B, prs, n=2):
    """``n`` host batches of B subjects in the combiners' keys (the bands
    as (B, 368, 84), struct, targets and, for the PRS model, ``prs``):
    the timing inputs."""
    rng = np.random.default_rng(SEED + B)
    out = []
    for _ in range(n):
        b = {k: rng.normal(size=(B, 368, 84)).astype(np.float32)
             for k in ("fmri_lowfreq_sequence",
                       "fmri_ultralowfreq_sequence")}
        b["struct"] = rng.normal(size=(B, 84, 84)).astype(np.float32)
        b["target"] = (np.arange(B) % 2).astype(np.float32)
        if prs:
            b["prs"] = rng.normal(size=(B, 3)).astype(np.float32)
        out.append(b)
    return out


def _state_equal(a, b, what):
    """Bit-equal state dicts, else raise naming the worst tensor."""
    worst = max(((a[k].float() - b[k].float()).abs().max().item(), k)
                for k in a)
    if worst[0] != 0.0:
        raise AssertionError(f"{what}: {worst[1]} differs by {worst[0]:.3e}")


def phase_chain(card):
    """The phase chain and phase 5's combiners through the port's CLI
    (``cli.main``) on a synthetic cohort on disk of DISK_SUBJECTS (28
    train, 6 val, 6 test), each step at its phase's ``Config`` defaults
    (bf16 policy; step 3 at batch 4 with Adam, steps 5 and 4 at batch 8 and
    4): step 3 trains ``SwinClassifier`` on DTI+sMRI (1 epoch, a best-AUROC
    checkpoint); step 5 trains each of the five combiners for one epoch at
    batch 8, every one chained from step 3 by ``weight_loader`` and
    ``partial_restore`` (the copied keys printed), exactly its kernels a
    pass and a step; step 4 tests ``FuncStructAdd`` from step 3's
    checkpoint; ``--predict_only`` serves the step-5 ``FuncStructAdd``,
    bit-equal to an in-memory ``Predictor``; a step-5 run stopped after
    epoch 1 and resumed equals a 2-epoch run bit for bit. Then one training
    step of each combiner at full depth, kernels against their plain twins
    on the card (float32, TF32 off: loss, every gradient within GRAD_REL of
    its max-abs, the updated parameters), and the training and predict
    steps of each at batch 8 and 64, bf16 and float32 in turns, with peak
    memory. Returns the launch counts by path."""
    from multimodal_neuroimage_tpu_torch.ckpt.checkpoint import (
        default_checkpoint, load_checkpoint)
    from multimodal_neuroimage_tpu_torch.cli.main import config_from_args
    from multimodal_neuroimage_tpu_torch.config import Config
    from multimodal_neuroimage_tpu_torch.data import synthetic
    from multimodal_neuroimage_tpu_torch.data.datasets import ItemLoader
    from multimodal_neuroimage_tpu_torch.data.index import build_subject_index
    from multimodal_neuroimage_tpu_torch.data.loader import DataPipeline
    from multimodal_neuroimage_tpu_torch.models.registry import create_model
    from multimodal_neuroimage_tpu_torch.ops import build
    from multimodal_neuroimage_tpu_torch.serve.predictor import Predictor
    t_phase = time.perf_counter()
    launches = {}
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        root = synthetic.generate_synthetic_cohort(
            os.path.join(tmp, "cohort"), n_subjects=DISK_SUBJECTS, seed=SEED)
        common = ["--base_path", root, "--target", "sex", "--seed",
                  str(SEED), "--nEpochs", "1", "--dti_smri_path",
                  os.path.join(root, "data", "dti+smri_cortical_thickness")]

        # ---- step 3: SwinClassifier on DTI+sMRI ------------------------------
        _, counts, _, _ = _cli(["--step", "3", "--dataset_name", "DTI+sMRI",
                                "--exp_name", "p3"] + common, "step 3", card)
        _per_pass(counts, SWIN_FORWARD, SWIN_BACKWARD, 7, 7 + 2,
                  "step-3 run")
        launches["chain_step3"] = counts
        p3 = default_checkpoint(Config(
            experiment_folder=_experiment(root, "p3"),
            experiment_title="p3_sex"))
        if p3 is None or "_BEST_val_AUROC" not in p3:
            raise AssertionError(f"step 3 wrote no best-AUROC file: {p3}")

        # ---- step 5: the five combiners, each chained from step 3 ----------
        folders = {}
        for name, (flags, cls, fwd, bwd) in COMBINERS.items():
            argv = (["--step", "5", "--dataset_name", "multimodal",
                     "--exp_name", name] + flags + common)
            _, counts, wall, out = _cli(argv, f"step 5 {name}", card)
            _per_pass(counts, fwd, bwd, 3, 3 + 1, f"step-5 {name} run")
            if (f"phase-chained weights from {p3}" not in out
                    or "swin.layers.*.blocks.*.attn.qkv.weight" not in out):
                raise AssertionError(f"{name} was not chained from {p3}")
            folders[name] = _experiment(root, name)
            cfg = config_from_args(argv)
            if type(create_model(cfg)).__name__ != cls:
                raise AssertionError(f"{name} does not build {cls}")
            if (cfg.batch_size, cfg.optim, cfg.compute_dtype) != (
                    CHAIN_BATCH, "AdamW", "bfloat16"):
                raise AssertionError(f"phase 5 defaults: {cfg}")
            launches[name] = counts
            print(f"step 5 {name} ({cls}): 1 epoch x 3 steps at batch 8 in "
                  f"{wall:.1f} s from {os.path.basename(p3)}")

        # ---- step 4: FuncStructAdd tested from step 3's checkpoint ---------
        metrics, counts, wall, out = _cli(
            ["--step", "4", "--dataset_name", "multimodal",
             "--multimodality_type", "add", "--exp_name", "p4"] + common,
            "step 4", card)
        _per_pass(counts, ADD_FORWARD, {}, 0, 2, "step-4 run")
        if f"phase-chained weights from {p3}" not in out or (
                "test_AUROC" not in metrics):
            raise AssertionError(f"step 4: {metrics}")
        launches["chain_step4"] = counts
        print(f"step 4 (FuncStructAdd from step 3's weights, the threshold "
              f"fitted on the 6 test subjects): "
              f"{ {k: v for k, v in metrics.items()} }")

        # ---- --predict_only: the step-5 FuncStructAdd, vs a Predictor ------
        add_ckpt = default_checkpoint(Config(
            experiment_folder=folders["funcstruct_add"],
            experiment_title="funcstruct_add_sex"))
        argv = (["--step", "5", "--dataset_name", "multimodal",
                 "--multimodality_type", "add",
                 "--predict_only", "--exp_name", "serve",
                 "--model_weights_path", add_ckpt] + common)
        scores, counts, wall, _ = _cli(argv, "predict_only", card)
        _per_pass(counts, ADD_FORWARD, {}, 0, -(-DISK_SUBJECTS // 8),
                  "--predict_only run")
        cfg = config_from_args(argv)
        records = build_subject_index(cfg, require_target=False)
        loader = ItemLoader(cfg)
        memory = Predictor(cfg, add_ckpt, [loader.load(r) for r in records],
                           device="cuda").predict()
        if memory != scores or len(scores) != DISK_SUBJECTS:
            raise AssertionError("--predict_only differs from the in-memory "
                                 "Predictor on the same arrays")
        launches["chain_predict"] = counts
        print(f"--predict_only scored {len(scores)} subjects in {wall:.2f} s "
              f"from {os.path.basename(add_ckpt)}, bit-equal to the "
              f"in-memory Predictor")

        # ---- resume: 1 epoch, resumed to 2, against 2 in one run -----------
        runs = {}
        for run, epochs in (("stopped", "1"), ("stopped", "2"),
                            ("whole", "2")):
            folder = os.path.join(tmp, f"resume_{run}")
            _, counts, wall, out = _cli(
                ["--step", "5", "--dataset_name", "multimodal",
                 "--multimodality_type", "add",
                 "--experiment_folder", folder, "--experiment_title", "r",
                 "--exp_name", "resume"] + common + ["--nEpochs", epochs],
                f"resume {run} {epochs}", card)
            runs[run] = load_checkpoint(os.path.join(folder,
                                                     "r_last_epoch.ckpt"))
            if run == "stopped" and epochs == "2":
                if "resumed from" not in out or counts[
                        "K5 fused_adam"] != 3:
                    raise AssertionError(f"the resumed run: {counts}")
        a, b = runs["stopped"], runs["whole"]
        _state_equal(a["state_dict"], b["state_dict"], "resumed weights")
        _state_equal({k: a["optimizer"][k] for k in ("mu", "nu")},
                     {k: b["optimizer"][k] for k in ("mu", "nu")},
                     "resumed Adam moments")
        if (a["optimizer"]["count"], a["epoch"], a["step"]) != (
                b["optimizer"]["count"], b["epoch"], b["step"]) or not \
                torch.equal(a["generator"], b["generator"]):
            raise AssertionError("resumed counts or generator differ")
        print(f"a step-5 run stopped after epoch 1 and resumed equals the "
              f"2-epoch run bit for bit (weights, Adam moments, count "
              f"{a['optimizer']['count']}, generator)")

        # ---- one full-depth step, kernels vs plain twins on the card -------
        for name, (flags, cls, fwd, bwd) in COMBINERS.items():
            cfg = dataclasses.replace(config_from_args(
                ["--step", "5", "--dataset_name", "multimodal", "--exp_name",
                 name] + flags + common), compute_dtype="float32")
            pipe = DataPipeline(cfg, splits={
                "train": build_subject_index(cfg)[:CHAIN_BATCH]},
                device="cuda")
            batch, _ = next(pipe.epoch("train", shuffle=False))
            steps = _step_compare(
                cfg, batch, f"{name} (full depth, float32)",
                (("card", "cuda", "std"),
                 ("plain twins on the card", "twins", "std")))
            f32 = {k.replace(" mm16", ""): n
                   for k, n in {**fwd, **bwd}.items()}   # K1's float32 form
            want = {k: f32.get(k, 0) for k in steps["card"]}
            want["K5 fused_adam"] = 1
            if steps["card"] != want or any(steps["plain twins on the card"]
                                            .values()):
                raise AssertionError(f"{name} twin step launches {steps}")
            launches[f"{name}_twin_step"] = steps["card"]

        # ---- training and predict steps, batch 8 and 64, bf16 and f32 ------
        for name, (flags, cls, fwd, bwd) in COMBINERS.items():
            cfg = config_from_args(["--step", "5", "--dataset_name",
                                    "multimodal", "--exp_name", name]
                                   + flags + common)
            for B in (CHAIN_BATCH, STRUCT_BENCH_BATCH):
                bcfg = dataclasses.replace(cfg, batch_size=B)
                batches = _combiner_batches(B, cfg.use_prs)
                _time_dtypes(bcfg, batches, (("std", "bfloat16"),
                                             ("std", "float32")),
                             name, card, steps=6)
                _time_predict(bcfg, batches, ("bfloat16", "float32"), name,
                              card, steps=6)
    print(f"phase-chain phase took {time.perf_counter() - t_phase:.1f} s; "
          f"card: {card}")
    return launches


# ---- phase 2's fMRI nets ----------------------------------------------------

# phase 2 (ROADMAP M7) at its Config defaults (bf16 policy, batch 8,
# AdamW): the MulT net runs no kernel but K5 (its attention is plain torch,
# as JAX's is outside any Pallas kernel), the two-channel net two 16-layer
# BERTs on K1 (mm16 at bf16, the float32 form at float32); step 1's
# TransformerNet one
P2_STEP1 = ({"K1 bert_layer mm16": 16}, {"K1 bert_layer backward mm16": 16})
P2_MULT = ({}, {})
P2_TWO = ({"K1 bert_layer mm16": 32}, {"K1 bert_layer backward mm16": 32})
# the ultralow BERT under feature_map_size='different': 128 steps + CLS,
# padded to 136 inside K1
P2_SHORT_T = 129
# HCP at phase 2 (22 ROIs, 1200 TRs + CLS, 2 heads): every layer on K6
P2_HCP = ({"K6 fused_attention bf16": 32},
          {"K6 fused_attention backward bf16": 32})


def k1_case(gen, res: Results, card, T, heads, B, path, timed=True):
    """K1 at H 84, F 3072, ``heads`` heads (head dim 84 / heads), t_valid T
    padded to a multiple of 8, batch B: the float32 form's training forward
    (every saved residual), inference forward and backward, and the mm16
    form's inference forward and backward (dropout 0.1 where training),
    each against its plain version at the script's K1 tolerances; when
    ``timed``, also timed in turns beside it and
    ``nn.TransformerEncoderLayer`` (bf16 for mm16) on the same weights and
    recorded as the kernels' path cases ``path`` beside the T = 369, 12-head
    rows."""
    from multimodal_neuroimage_tpu_torch.ops import bert_layer as bl
    H, F_ = 84, 3072
    TP = T + (-T % 8)
    rates, seed = (0.1, 0.1), 97531
    tag = f"T {T} (padded {TP}) B {B} heads {heads} (hd {H // heads})"
    prod, exps = _bert_ops(B, T, H, heads, F_)
    x, g = (torch.randn(B, T, H, generator=gen).cuda() for _ in "xg")
    p = tuple(t.cuda() for t in (_lin(gen, H, H) + _lin(gen, H, H)
                                 + _lin(gen, H, H) + _lin(gen, H, H)
                                 + _ln(gen, H) + _lin(gen, F_, H)
                                 + _lin(gen, H, F_) + _ln(gen, H)))
    sum_tol = f"sums {SUM_REL} * max|ref| + {SUM_ATOL}"
    f32_tol = f"atol {ATOL} + rtol {RTOL}"
    tol16 = f"atol {ATOL16} + rtol {RTOL16}; gradients {REL16} * max|ref|"

    def case(key, label, err, tol, timing=None, nbytes=0, bound=None):
        """Record a case (``timing``: kernel, plain and library calls in
        turns) or, untimed, print its error."""
        if not timed:
            print(f"{key} {tag} {label}: max|err| {err:.3e} ({tol}); card: "
                  f"{card}")
            return
        kernel, plain, library, iters = timing
        ms, plain_ms, lib_ms = _call_times(kernel, plain, library, iters)
        b, by = res.path_case(key, path, f"{tag} {label}", err, ms, plain_ms,
                              0, nbytes, lib_ms, bound=bound)
        print(f"{key} {tag} {label}: max|err| {err:.3e} ({tol})  kernel "
              f"{ms:.4f} ms  plain {plain_ms:.4f} ms  bound {b:.6f} ms "
              f"({by})  library {lib_ms:.4f} ms; card: {card}")

    # the float32 form: training forward, inference forward, backward
    encoder = _encoder_layer(p, H, heads, F_).eval() if timed else None
    (out, resid) = bl._launch_forward(x, p, heads, T, seed, rates, True, True)
    want = bl.bert_layer_reference_parts(x, p, heads, T, seed, rates, True)
    torch.cuda.synchronize()
    err = _close(f"K1 {tag} out", out, want["out"], ATOL, RTOL)
    for name, got in bl.resid_parts(resid, B, T, H, heads).items():
        err = max(err, _close(f"K1 {tag} {name}", got, want[name], ATOL,
                              RTOL))
    del want

    @torch.no_grad()
    def library():
        return encoder(x)
    nbytes = _nbytes(x, x, resid, *p)
    case("K1 bert_layer", "training", err, f32_tol,
         (lambda: bl._launch_forward(x, p, heads, T, seed, rates, True, True),
          lambda: bl.bert_layer_reference_parts(x, p, heads, T, seed, rates,
                                                True), library, 20), nbytes,
         _k1_forward_bound(B, nbytes, T=T, heads=heads))
    err = _close(f"K1 {tag} inference", bl.bert_layer_call(x, p, heads, T),
                 bl.bert_layer_reference(x, p, heads, T), ATOL, RTOL)
    nbytes = _nbytes(x, x, *p)
    case("K1 bert_layer", "inference", err, f32_tol,
         (lambda: bl.bert_layer_call(x, p, heads, T),
          lambda: bl.bert_layer_reference(x, p, heads, T), library, 20),
         nbytes, _k1_forward_bound(B, nbytes, T=T, heads=heads))

    def k1():
        return bl.bert_layer_backward(g, x, p, resid, heads, T, seed, rates,
                                      True)
    dx, dps = k1()
    _, plain = _plain_backward(
        lambda x_, *p_: bl.bert_layer_reference(x_, p_, heads, T, seed,
                                                rates, True), (x,) + p, g)
    want = plain()
    torch.cuda.synchronize()
    errs = [_close(f"K1 backward {tag} dx", dx, want[0], ATOL, RTOL)]
    errs += [_close_rel(f"K1 backward {tag} dparams[{i}]", a, b, SUM_REL)
             for i, (a, b) in enumerate(zip(dps, want[1:]))]
    del want
    timing = None
    if timed:
        layer = _encoder_layer(p, H, heads, F_).train()
        with torch.enable_grad():
            xl = x.detach().requires_grad_()
            ins, o = [xl] + list(layer.parameters()), layer(xl)
        timing = (k1, plain, lambda: torch.autograd.grad(
            o, ins, g, retain_graph=True), 10)
    case("K1 bert_layer backward", "", max(errs),
         f"dx: {f32_tol}; {sum_tol}", timing, _nbytes(x, g, x, *p, *p),
         _k1_backward_bound(B, x, g, p, T=T))
    del encoder, timing, resid

    # the mm16 form: inference forward and backward
    p16 = _k1_params16(gen)
    x16 = x.to(torch.bfloat16)
    err = _close(f"K1 mm16 {tag}", bl.bert_layer_call16(x, p16, heads, T),
                 bl.bert_layer_reference(x, p16, heads, T, mm16=True),
                 ATOL16, RTOL16)
    timing = None
    if timed:
        layer16 = _encoder_layer(p16, H, heads, F_).to(torch.bfloat16)

        @torch.no_grad()
        def library16():
            return layer16.eval()(x16)
        timing = (lambda: bl.bert_layer_call16(x, p16, heads, T),
                  lambda: bl.bert_layer_reference(x, p16, heads, T,
                                                  mm16=True), library16, 20)
    case("K1 bert_layer mm16", "", err, tol16, timing, 0,
         _bound16(prod, exps, _nbytes(x, x, *p16)))
    _, resid16 = bl._launch_forward(x, p16, heads, T, seed, rates, True,
                                    True, True)

    def bwd16():
        return bl.bert_layer_backward16(g, x, p16, resid16, heads, T, seed,
                                        rates, True)

    def plain16():
        return bl.bert_layer_reference_backward16(g, x, p16, heads, T, seed,
                                                  rates, True)
    (dx, dps), (wdx, wdps) = bwd16(), plain16()
    torch.cuda.synchronize()
    errs = [_close_rel(f"K1 mm16 backward {tag} dx", dx, wdx, REL16, 0.0)]
    errs += _grads16(f"K1 mm16 backward {tag} dparams", dps, wdps,
                     key_bias=(3, 2))
    timing = None
    if timed:
        layer16.train()
        with torch.enable_grad():
            xl = x16.detach().requires_grad_()
            ins, o = [xl] + list(layer16.parameters()), layer16(xl)
        g16 = g.to(torch.bfloat16)
        timing = (bwd16, plain16, lambda: torch.autograd.grad(
            o, ins, g16, retain_graph=True), 10)
    case("K1 bert_layer backward mm16", "", max(errs), tol16, timing, 0,
         _bound16(2 * prod, 2 * exps, _nbytes(x, g, x, *p16, *p16)))


def k5_phase2_kernels(gen, res: Results, card):
    """K5 in adamw mode (phase 2's optimizer), without and with clipping,
    at the MulT net's and the two-channel net's parameter counts, against
    ``fused_adam_reference``, timed in turns beside its plain version and
    ``torch.optim.AdamW(fused=True)`` on the same buffers; path cases
    ``phase2``."""
    from multimodal_neuroimage_tpu_torch.cli.main import config_from_args
    from multimodal_neuroimage_tpu_torch.models.registry import create_model
    from multimodal_neuroimage_tpu_torch.ops import fused_update as fu
    base = ["--step", "2", "--fmri_type", "divided_frequency"]
    for label, flags in (("MulT", []), ("two channels", [
            "--fmri_multimodality_type", "two_channels"])):
        cfg = config_from_args(base + flags)
        n = sum(q.numel() for q in create_model(cfg).parameters())
        pk, gk, mk = (torch.randn(n, generator=gen).cuda() for _ in range(3))
        nk = torch.rand(n, generator=gen).cuda()
        for clip in (None, torch.tensor([0.5], device="cuda")):
            state = [t.clone() for t in (pk, mk, nk)]
            args = (clip, 1e-3, 10.0, 1000.0, 0.9, 0.999, 1e-8, 1e-5, True)
            fu.fused_adam_update(pk, gk, mk, nk, *args)
            fu.fused_adam_reference(state[0], gk, state[1], state[2], *args)
            torch.cuda.synchronize()
            err = max(_close(f"K5 adamw {label} {name}", a, b, ATOL, RTOL)
                      for name, a, b in zip(("p", "mu", "nu"), (pk, mk, nk),
                                            state))
            flat = torch.nn.Parameter(pk.clone())
            flat.grad = gk.clone()
            adamw = torch.optim.AdamW([flat], lr=1e-3, betas=(0.9, 0.999),
                                      eps=1e-8, weight_decay=1e-5,
                                      fused=True)
            plain_ms, ms, lib_ms = _turns([
                lambda: fu.fused_adam_reference(state[0], gk, state[1],
                                                state[2], *args),
                lambda: fu.fused_adam_update(pk, gk, mk, nk, *args),
                adamw.step])
            tag = f"adamw, {label}, {n} params, clip {clip is not None}"
            bound, by = res.path_case("K5 fused_adam", "phase2", tag, err,
                                      ms, plain_ms, 17 * n, 7 * 4 * n,
                                      lib_ms)
            print(f"K5 fused_adam {tag}: max|err| {err:.3e} (atol {ATOL} + "
                  f"rtol {RTOL})  kernel {ms:.4f} ms  plain {plain_ms:.4f} "
                  f"ms  bound {bound:.6f} ms ({by})  torch.optim.AdamW("
                  f"fused=True) {lib_ms:.4f} ms; card: {card}")


def _phase2_batches(B, T=368, R=84, n=2):
    """``n`` host batches of B subjects in phase 2's keys (the raw series
    and both bands, (B, T, R), the ends zero-padded as a short series is,
    and targets): the timing and one-step inputs."""
    rng = np.random.default_rng(SEED + B + T)
    out = []
    for _ in range(n):
        b = {k: rng.normal(size=(B, T, R)).astype(np.float32)
             for k in ("fmri_sequence", "fmri_lowfreq_sequence",
                       "fmri_ultralowfreq_sequence")}
        for k in list(b):
            b[k][:, :4] = 0.0
            b[k][:, -4:] = 0.0
        b["target"] = (np.arange(B) % 2).astype(np.float32)
        out.append(b)
    return out


def _phase2_times(cfg, label, card):
    """Training and predict steps at batch 8 and 64, bf16 and float32 in
    turns, with peak memory; a batch that does not fit the card is timed at
    half of it instead, and why is printed."""
    for B in (CHAIN_BATCH, STRUCT_BENCH_BATCH):
        while True:
            bcfg = dataclasses.replace(cfg, batch_size=B)
            try:
                batches = _phase2_batches(B)
                _time_dtypes(bcfg, batches, (("std", "bfloat16"),
                                             ("std", "float32")),
                             label, card, steps=6)
                _time_predict(bcfg, batches, ("bfloat16", "float32"), label,
                              card, steps=6)
                break
            except torch.cuda.OutOfMemoryError as e:
                why = str(e).splitlines()[0]
            gc.collect()
            torch.cuda.empty_cache()
            print(f"{label} at batch {B} does not fit the card ({why}); "
                  f"timing batch {B // 2}; card: {card}")
            B //= 2
        gc.collect()
        torch.cuda.empty_cache()


def phase2_nets(card, gen, res: Results):
    """Phase 2's fMRI nets (``phase2_nets``): K1 at T = 129 and K5 at the
    nets' sizes against their plain versions; the chain through the CLI on
    a synthetic ABCD cohort on disk at ``--fmri_type divided_frequency``
    (DISK_SUBJECTS: 28 train, 6 val, 6 test; series of 350-361 TRs, so the
    bands' zero-padded ends reach the MulT net's pad probe and its readout
    of the last, padded, time step), each step at its phase's defaults
    (steps 1 and 2: bf16, batch 8, AdamW): ``--step 1`` trains
    ``TransformerNet`` (1 epoch); ``--step 2`` trains the MulT net and
    ``--fmri_multimodality_type two_channels`` the two-channel net, each
    chained from step 1's best checkpoint (the copied keys printed), the
    MulT run exactly K5 once a step and no other kernel, the two-channel
    run K1 mm16 32 a pass and 32 a step and K5 once a step; ``--step 4``
    tests each from its step-2 checkpoint; ``--predict_only`` serves the
    two-channel checkpoint, bit-equal to an in-memory ``Predictor``. Then
    one HCP two-channel training step at phase 2's policy (22 ROIs, 1200
    TRs + CLS, 2 heads; the HCP index makes no bands, in JAX neither, so the
    bands are drawn): 32 bf16 K6 forwards and 32 backwards and K5 once. One
    float32 training step of each net at full width: the two-channel net's
    kernels against their plain twins on the card at ``GRAD_REL``, the MulT
    net (no kernel to twin) on the card against the CPU from the same
    weights, batch and generator state at ``GRAD_REL``. Last the training
    and predict steps of both nets at batch 8 and 64, bf16 and float32 in
    turns, with peak memory. Returns the launch counts by path."""
    from multimodal_neuroimage_tpu_torch import ops
    from multimodal_neuroimage_tpu_torch.ckpt.checkpoint import (
        latest_checkpoint)
    from multimodal_neuroimage_tpu_torch.cli.main import config_from_args
    from multimodal_neuroimage_tpu_torch.data import synthetic
    from multimodal_neuroimage_tpu_torch.data.datasets import ItemLoader
    from multimodal_neuroimage_tpu_torch.data.index import build_subject_index
    from multimodal_neuroimage_tpu_torch.models.registry import (
        create_model, init_random_weights)
    from multimodal_neuroimage_tpu_torch.ops import build
    from multimodal_neuroimage_tpu_torch.serve.predictor import Predictor
    from multimodal_neuroimage_tpu_torch.train.losses import active_losses
    from multimodal_neuroimage_tpu_torch.train.state import (create_optimizer,
                                                             make_train_step)
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    k1_case(gen, res, card, P2_SHORT_T, 12, CHAIN_BATCH, "phase2_different")
    print(f"K1 at T = 369 (B 4, 16, 64): the rows above; at T = "
          f"{P2_SHORT_T} the path cases phase2_different; card: {card}")
    k5_phase2_kernels(gen, res, card)
    launches = {}
    two = ["--fmri_multimodality_type", "two_channels"]
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        root = synthetic.generate_synthetic_cohort(
            os.path.join(tmp, "cohort"), n_subjects=DISK_SUBJECTS, seed=SEED)
        common = ["--base_path", root, "--target", "sex", "--seed",
                  str(SEED), "--nEpochs", "1", "--dataset_name",
                  "fMRI_timeseries", "--fmri_type", "divided_frequency"]

        def best(exp_name):
            found = glob.glob(os.path.join(_experiment(root, exp_name),
                                           "*_BEST_val_AUROC.ckpt"))
            if len(found) != 1:
                raise AssertionError(f"{exp_name} wrote no best-AUROC file "
                                     f"(validation never improved): {found}")
            return found[0]

        _, counts, wall, _ = _cli(["--step", "1", "--exp_name", "p1"]
                                  + common, "phase 2: step 1", card)
        _per_pass(counts, *P2_STEP1, 3, 3 + 1, "step-1 run")
        launches["phase2_step1"] = counts
        p1 = best("p1")
        print(f"step 1 (TransformerNet): 1 epoch x 3 steps at batch 8 in "
              f"{wall:.1f} s")
        folders = {}
        for name, flags, cls, path in (
                ("phase2_mult", [], "TransformerNetCrossAttention", P2_MULT),
                ("phase2_two_channels", two, "TransformerNetTwoChannels",
                 P2_TWO)):
            argv = ["--step", "2", "--exp_name", name] + flags + common
            _, counts, wall, out = _cli(argv, f"phase 2: step 2 {cls}", card)
            _per_pass(counts, *path, 3, 3 + 1, f"step-2 {cls} run")
            cfg = config_from_args(argv)
            if (type(create_model(cfg)).__name__ != cls
                    or (cfg.batch_size, cfg.optim, cfg.compute_dtype,
                        cfg.intermediate_vec, cfg.sequence_length,
                        cfg.nlevels) != (CHAIN_BATCH, "AdamW", "bfloat16",
                                         84, 368, 12)):
                raise AssertionError(f"phase 2 defaults: {cfg}")
            chained = [line for line in out.splitlines()
                       if line.startswith(f"phase-chained weights from {p1}")]
            if len(chained) != 1:
                raise AssertionError(f"{cls} was not chained from {p1}")
            print(f"step 2 {cls}: 1 epoch x 3 steps at batch 8 in "
                  f"{wall:.1f} s; {chained[0].split(': ', 1)[1]}")
            folders[name] = _experiment(root, name)
            launches[name] = counts

        # ---- step 4: each net tested from its step-2 checkpoint ------------
        for name, flags, path in (("phase2_mult", [], P2_MULT),
                                  ("phase2_two_channels", two, P2_TWO)):
            ckpt = latest_checkpoint(folders[name])
            metrics, counts, wall, out = _cli(
                ["--step", "4", "--exp_name", f"p4_{name}",
                 "--model_weights_path", ckpt] + flags + common,
                f"phase 2: step 4 {name}", card)
            _per_pass(counts, path[0], {}, 0, 2, f"step-4 {name} run")
            if "'missing': 0" not in out or "test_AUROC" not in metrics:
                raise AssertionError(f"step 4 {name}: {metrics}")
            launches[f"{name}_step4"] = counts
            print(f"step 4 {name} (from {os.path.basename(ckpt)}, the "
                  f"threshold fitted on the 6 test subjects) in {wall:.1f} "
                  f"s: {metrics}")

        # ---- --predict_only: the two-channel checkpoint, vs a Predictor ---
        ckpt = latest_checkpoint(folders["phase2_two_channels"])
        argv = (["--step", "2", "--predict_only", "--exp_name", "serve2",
                 "--model_weights_path", ckpt] + two + common)
        scores, counts, wall, _ = _cli(argv, "phase 2: predict_only", card)
        _per_pass(counts, P2_TWO[0], {}, 0, -(-DISK_SUBJECTS // 8),
                  "phase-2 --predict_only run")
        cfg = config_from_args(argv)
        records = build_subject_index(cfg, require_target=False)
        loader = ItemLoader(cfg)
        memory = Predictor(cfg, ckpt, [loader.load(r) for r in records],
                           device="cuda").predict()
        if memory != scores or len(scores) != DISK_SUBJECTS:
            raise AssertionError("phase 2 --predict_only differs from the "
                                 "in-memory Predictor on the same arrays")
        launches["phase2_predict"] = counts
        print(f"--predict_only scored {len(scores)} subjects with the "
              f"two-channel net in {wall:.2f} s, bit-equal to the in-memory "
              f"Predictor; card: {card}")

    # ---- one HCP two-channel step at phase 2's policy: K6 ------------------
    hcp = config_from_args(["--step", "2", "--dataset_name", "hcp",
                            "--fmri_type", "divided_frequency"] + two)
    if (hcp.intermediate_vec, hcp.sequence_length, hcp.num_heads_2DBert,
            hcp.compute_dtype) != (22, 1200, 2, "bfloat16"):
        raise AssertionError(f"unexpected HCP phase-2 config: {hcp}")
    model = init_random_weights(create_model(hcp),
                                torch.Generator().manual_seed(SEED)).cuda()
    opt = create_optimizer("AdamW", model.parameters(), lambda t: 1e-3,
                           hcp.weight_decay)
    step = make_train_step(model, active_losses(hcp.task, hcp.fine_tune_task),
                           opt, hcp.compute_dtype, "cuda")
    batch = _phase2_batches(HCP_BATCH, T=1200, R=22, n=1)[0]
    step(batch, torch.Generator().manual_seed(SEED))     # warm-up
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    losses, _, _ = step(batch, torch.Generator().manual_seed(SEED))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launches()
    _per_pass(counts, *P2_HCP, 1, 1, "HCP two-channel step")
    if not torch.isfinite(losses["total"]):
        raise AssertionError(f"HCP two-channel loss {losses}")
    launches["phase2_hcp_two_channels"] = counts
    print(f"one HCP two-channel training step (batch {HCP_BATCH}, 22 ROIs x "
          f"1201, bf16): {1e3 * wall:.1f} ms, loss "
          f"{losses['total'].item():.6f}; launches {counts}; card: {card}")
    del model, opt, step

    # ---- one float32 step at full width of each net ------------------------
    base = ["--step", "2", "--fmri_type", "divided_frequency"]
    batch = _phase2_batches(CHAIN_BATCH, n=1)[0]
    cfg = dataclasses.replace(config_from_args(base + two),
                              compute_dtype="float32")
    steps = _step_compare(cfg, batch, "two-channel net (full width, "
                          "float32)", (("card", "cuda", "std"),
                                       ("plain twins on the card", "twins",
                                        "std")))
    want = {"K1 bert_layer": 32, "K1 bert_layer backward": 32,
            "K5 fused_adam": 1}
    if (steps["card"] != {k: want.get(k, 0) for k in steps["card"]}
            or any(steps["plain twins on the card"].values())):
        raise AssertionError(f"two-channel twin step launches {steps}")
    launches["phase2_two_channels_twin_step"] = steps["card"]
    cfg = dataclasses.replace(config_from_args(base), compute_dtype="float32")
    steps = _step_compare(cfg, batch, "MulT net (full width, float32)",
                          (("card", "cuda", "std"), ("CPU", "cpu", "std")))
    if steps["card"] != {k: int(k == "K5 fused_adam") for k in steps["card"]}:
        raise AssertionError(f"MulT step launches {steps['card']}")
    launches["phase2_mult_step"] = steps["card"]

    # ---- training and predict steps, batch 8 and 64, bf16 and float32 -----
    for label, flags in (("MulT net", []), ("two-channel net", two)):
        _phase2_times(config_from_args(base + flags), label, card)
    print(f"phase-2 phase took {time.perf_counter() - t_phase:.1f} s; "
          f"card: {card}")
    return launches


# ---- phase 13: the training run's outer shell -------------------------------

# step 1 at its defaults (bf16, batch 8, 16 layers): TransformerNet's one
# BERT on K1's mm16 form, L a pass and L a step
P13_T = 369
P13_TRAIN, P13_VAL = 28, 6          # the 40-subject cohort's splits
# FuncStructUNetAdd at phase 5's defaults, 10 train steps and 3 val passes
# of batch 2 under --profiling
P13_UNET_BATCH = 2
# the CUDA kernel names the profiled step-5 run's trace must show
P13_TRACE = {"K1": "k16_", "K4": "window_attention", "K5": "fused_adam_kernel"}


def _loss_specs(cfg):
    """The task's losses as the Trainer activates them from ``cfg``."""
    from multimodal_neuroimage_tpu_torch.train.losses import active_losses
    return active_losses(
        cfg.task, cfg.fine_tune_task, use_merge_loss=cfg.use_merge_loss,
        use_unet_loss=cfg.use_unet_loss, use_cont_loss=cfg.use_cont_loss,
        use_mask_loss=cfg.use_mask_loss,
        intensity_factor=cfg.intensity_factor,
        perceptual_factor=cfg.perceptual_factor,
        reconstruction_factor=cfg.reconstruction_factor)


def _step1_launches(layers, batch, epochs=1):
    """Exact launches of a step-1 run of ``epochs`` on the cohort: K1 mm16
    ``layers`` a pass (train steps and val passes) and a step, K5 a step."""
    steps = epochs * (P13_TRAIN // batch)
    passes = steps + epochs * -(-P13_VAL // batch)
    return {"K1 bert_layer mm16": layers * passes,
            "K1 bert_layer backward mm16": layers * steps,
            "K5 fused_adam": steps}


def _reconstruction_losses(card):
    """``compute_losses`` for a ``transformer_reconstruction`` loss set with
    the contrastive and mask losses (perceptual, reconstruction, intensity,
    contrastive, mask; weighted), card against CPU on the same seeded
    outputs, VGG weights and slices, TF32 off: every loss at the float32
    kernel tolerance."""
    from multimodal_neuroimage_tpu_torch.nn.perceptual import PerceptualLoss
    from multimodal_neuroimage_tpu_torch.train.losses import (active_losses,
                                                              compute_losses)
    task = "transformer_reconstruction"
    specs = active_losses(task, "regression", use_cont_loss=True,
                          use_mask_loss=True, intensity_factor=0.5,
                          perceptual_factor=2.0, reconstruction_factor=3.0)
    rng = np.random.default_rng(SEED)
    B, T, E = 8, 64, 84
    seq = np.abs(rng.normal(size=(B, 40, 48, 40, 4))).astype(np.float32)
    out = {"rec": (seq + 0.1 * rng.normal(size=seq.shape)).astype(np.float32),
           "encoded_inputs": rng.normal(size=(B, T, E)).astype(np.float32),
           "seq": rng.normal(size=(B, T, E)).astype(np.float32),
           "mask_list": np.stack([rng.choice(T, 8, replace=False)
                                  for _ in range(B)]).astype(np.int64)}
    got = {}
    for where in ("cuda", "cpu"):
        fn = PerceptualLoss(task, seed=SEED, device=where)
        t = {k: torch.from_numpy(v).to(where) for k, v in out.items()}
        vol = compute_losses({"reconstructed_fmri_sequence": t["rec"]},
                             {"fmri_sequence": torch.from_numpy(seq).to(
                                 where)},
                             {k: specs[k] for k in ("perceptual",
                                                    "reconstruction",
                                                    "intensity")},
                             {"perceptual": fn},
                             torch.Generator().manual_seed(SEED))
        pair = compute_losses({"reconstructed_fmri_sequence": t["seq"],
                               "encoded_inputs": t["encoded_inputs"],
                               "mask_list": t["mask_list"]}, {},
                              {k: specs[k] for k in ("contrastive", "mask")})
        got[where] = {**{k: v.item() for k, v in vol.items()},
                      **{f"{k} (pairs)": v.item() for k, v in pair.items()}}
    errs = {k: _close(f"reconstruction set {k}", torch.tensor([v]),
                      torch.tensor([got["cpu"][k]]), ATOL, RTOL)
            for k, v in got["cuda"].items()}
    print(f"compute_losses, transformer_reconstruction set (perceptual on "
          f"{B}x4x40 slices of 40x48, intensity over {B}x4 frames), card vs "
          f"CPU: {got['cuda']}; max|err| {max(errs.values()):.3e} (atol "
          f"{ATOL} + rtol {RTOL}); card: {card}")


P13_TRIALS = 4
P13_OOM_TRIAL = 1          # the trial of the second study run out of memory


@contextlib.contextmanager
def _objectives():
    """Within the block: {trial number: objective} of every trial the
    study (hpo/optuna_harness.py) completes."""
    from multimodal_neuroimage_tpu_torch.hpo import optuna_harness as oh
    values, real = {}, oh._objective_value

    def record(cfg, metrics, trainer):
        value = real(cfg, metrics, trainer)
        trial = os.path.basename(trainer.cfg.experiment_folder)
        values[int(trial.rsplit("_", 1)[1])] = value
        return value

    oh._objective_value = record
    try:
        yield values
    finally:
        oh._objective_value = real


@contextlib.contextmanager
def _memory_cap(trial: str):
    """Within the block the ``Trainer`` of study trial ``trial`` runs with
    the card's memory capped 16 MiB above what the process holds
    (``torch.cuda.set_per_process_memory_fraction``), so that the trial
    truly runs out of memory; the cap is lifted when it ends."""
    from multimodal_neuroimage_tpu_torch.train import trainer as tmod
    base = tmod.Trainer
    total = torch.cuda.get_device_properties(0).total_memory

    def uncap():
        torch.cuda.set_per_process_memory_fraction(1.0)

    class Capped(base):
        def __init__(self, cfg, *args, **kwargs):
            if os.path.basename(cfg.experiment_folder or "") == trial:
                torch.cuda.empty_cache()
                torch.cuda.set_per_process_memory_fraction(
                    (torch.cuda.memory_reserved() + (16 << 20)) / total)
            try:
                super().__init__(cfg, *args, **kwargs)
            except BaseException:
                uncap()
                raise

        def training(self):
            try:
                return super().training()
            finally:
                uncap()

    tmod.Trainer = Capped
    try:
        yield
    finally:
        tmod.Trainer = base
        uncap()


def _study_out_of_memory(argv, values, drawn, root, card):
    """Phase 13's study again under another name, its trial
    ``P13_OOM_TRIAL`` under ``_memory_cap``: that trial fails with
    ``torch.cuda.OutOfMemoryError`` and is recorded as failed, the study
    goes on, and the other trials' objectives and the best parameters
    equal those of the uncapped study's other trials (``values``)."""
    import pickle
    # a name that the first study's globs (``*hpo*``) do not match
    argv = [a if a != "hpo" else "capped" for a in argv]
    held = torch.cuda.memory_allocated()
    with _objectives() as got, _memory_cap(f"trial_{P13_OOM_TRIAL}"):
        best, _, wall, out = _cli(argv, "outer shell: study, one trial out "
                                  "of memory", card)
    failed = [line for line in out.splitlines()
              if line.startswith(f"trial {P13_OOM_TRIAL} failed: ")]
    want = {n: v for n, v in values.items() if n != P13_OOM_TRIAL}
    if not failed or "out of memory" not in failed[0]:
        raise AssertionError(f"trial {P13_OOM_TRIAL} was not recorded as "
                             f"failed out of memory: {failed}")
    if got != want:
        raise AssertionError(f"the other trials' objectives {got} differ "
                             f"from the uncapped study's {want}")
    top = max(want, key=lambda n: (want[n], -n))
    with open(os.path.join(_experiment(root, "capped"),
                           "best_params.pkl"), "rb") as f:
        params = pickle.load(f)
    if params != drawn[top] or best["best_value"] != want[top]:
        raise AssertionError(f"best parameters {params} ({best}), expected "
                             f"trial {top}'s {drawn[top]} at {want[top]}")
    print(f"study with trial {P13_OOM_TRIAL} out of memory: recorded "
          f"'{failed[0][:110]}', the other {len(got)} trials' objectives "
          f"and the best (trial {top}) equal the uncapped study's, in "
          f"{wall:.1f} s; memory held {held} B before, "
          f"{torch.cuda.memory_allocated()} B after; card: {card}")


def outer_shell(card, gen, res: Results):
    """Phase 13 (``outer_shell``): K1 at the head dims the HPO space and
    ``Config.validate()`` admit (hd 21 and 14 at heads 4 and 6: T 369
    padded to 376, batch 8, timed beside its plain version and
    ``nn.TransformerEncoderLayer``; hd 28 and 84 at batch 4 for correctness
    only); then through the CLI on the 40-subject cohort on disk: a 4-trial
    study (``--step 1 --use_optuna --opt_num_epochs 1``: the fallback
    search, every trial completed or pruned, K1 and K5 launched exactly as
    each trial's drawn depth and batch need, ``best_params.pkl`` with the
    search space's keys), the same study with one trial out of memory
    (``_study_out_of_memory``), a ``--use_best_params_from_optuna`` run on
    them,
    a fixed ``--num_heads_2DBert 4`` run (hd 21 whatever the study drew);
    step 5's ``FuncStructUNetAdd`` with the UNet loss, grad norms every
    step, ``--profiling`` and ``--profile_dir`` (exactly 10 train batches,
    ``unet`` and ``grad/global`` columns in ``full_scores.csv``, a Chrome
    trace naming the K1, K4 and K5 kernels); one full-width float32 step
    of ``FuncStructUNetCross`` with the UNet loss against the plain twins
    on the card at ``GRAD_REL``; a reconstruction loss set card vs CPU.
    Returns the launch counts by path."""
    import csv
    import pickle
    from multimodal_neuroimage_tpu_torch.cli.main import config_from_args
    from multimodal_neuroimage_tpu_torch.data import synthetic
    from multimodal_neuroimage_tpu_torch.hpo import optuna_harness as oh
    from multimodal_neuroimage_tpu_torch.models.registry import create_model
    from multimodal_neuroimage_tpu_torch.ops import build
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    for heads in (4, 6):
        k1_case(gen, res, card, P13_T, heads, CHAIN_BATCH, "outer_shell")
    for heads in (3, 1):
        k1_case(gen, res, card, P13_T, heads, 4, "outer_shell", timed=False)
    t_k1 = time.perf_counter() - t_phase
    launches = {}
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        root = synthetic.generate_synthetic_cohort(
            os.path.join(tmp, "cohort"), n_subjects=DISK_SUBJECTS, seed=SEED)
        common = ["--base_path", root, "--target", "sex", "--seed",
                  str(SEED), "--nEpochs", "1", "--dti_smri_path",
                  os.path.join(root, "data", "dti+smri_cortical_thickness")]

        # ---- the study: P13_TRIALS trials of step 1, 1 epoch each ----------
        argv = ["--step", "1", "--exp_name", "hpo", "--use_optuna",
                "--num_trials", str(P13_TRIALS), "--opt_num_epochs",
                "1"] + common
        with _objectives() as values:
            best, counts, wall, out = _cli(argv, "outer shell: study", card)
        cfg = config_from_args(argv)
        if (cfg.batch_size, cfg.intermediate_vec, cfg.compute_dtype) != (
                CHAIN_BATCH, 84, "bfloat16"):
            raise AssertionError(f"step 1 defaults: {cfg}")
        rng = np.random.default_rng(cfg.seed)     # the fallback's draws
        drawn = [oh._suggest(oh._FallbackTrial(n, rng, {}, True), cfg)
                 for n in range(P13_TRIALS)]
        folder = _experiment(root, "hpo")
        done = [os.path.exists(os.path.join(folder, f"trial_{n}",
                                            "full_scores.csv"))
                for n in range(P13_TRIALS)]
        pruned = [f"trial {n} pruned" in out for n in range(P13_TRIALS)]
        if not all(d or p for d, p in zip(done, pruned)):
            raise AssertionError(f"trials neither completed nor pruned: "
                                 f"completed {done}, pruned {pruned}")
        want = {}
        for d in drawn:
            for k, n in _step1_launches(d["transformer_hidden_layers"],
                                        d["batch_size"]).items():
                want[k] = want.get(k, 0) + n
        _exact(counts, want, "study")
        with open(os.path.join(folder, "best_params.pkl"), "rb") as f:
            params = pickle.load(f)
        if set(params) != set(oh.SEARCH_SPACE) or params not in drawn:
            raise AssertionError(f"best_params.pkl: {params}")
        launches["outer_shell_study"] = counts
        print(f"study: {P13_TRIALS} trials of step 1 in {wall:.1f} s "
              f"(completed "
              f"{sum(done)}, pruned {sum(pruned)}), drawn heads "
              f"{[d['num_heads_2DBert'] for d in drawn]} (hd "
              f"{[84 // d['num_heads_2DBert'] for d in drawn]}), depths "
              f"{[d['transformer_hidden_layers'] for d in drawn]}, batches "
              f"{[d['batch_size'] for d in drawn]}; best {best}; card: "
              f"{card}")

        # ---- the same study with trial 1 out of the card's memory ------------
        _study_out_of_memory(argv, values, drawn, root, card)

        # ---- a run on the best parameters -----------------------------------
        _, counts, wall, out = _cli(
            ["--step", "1", "--exp_name", "hpo",
             "--use_best_params_from_optuna"] + common,
            "outer shell: best params", card)
        if "[hpo] loaded best params from" not in out:
            raise AssertionError("the best-params run found no best_params")
        _exact(counts, _step1_launches(params["transformer_hidden_layers"],
                                       params["batch_size"]),
               "best-params run")
        launches["outer_shell_best_params"] = counts
        print(f"--use_best_params_from_optuna: 1 epoch at {params} in "
              f"{wall:.1f} s")

        # ---- a fixed run at 4 heads (hd 21) ----------------------------------
        _, counts, wall, _ = _cli(["--step", "1", "--exp_name", "heads4",
                                   "--num_heads_2DBert", "4"] + common,
                                  "outer shell: 4 heads", card)
        _exact(counts, _step1_launches(16, CHAIN_BATCH), "4-head run")
        launches["outer_shell_heads4"] = counts
        print(f"step 1 at --num_heads_2DBert 4 (hd 21): 1 epoch in "
              f"{wall:.1f} s")

        # ---- step 5: FuncStructUNetAdd, UNet loss, norms, profiling --------
        prof = os.path.join(tmp, "profile")
        argv = (["--step", "5", "--dataset_name", "multimodal",
                 "--exp_name", "p5unet", "--multimodality_type", "add",
                 "--use_unet", "--use_unet_loss", "--batch_size",
                 str(P13_UNET_BATCH), "--log_grad_norms_every", "1",
                 "--profiling", "--profile_dir", prof] + common)
        _, counts, wall, _ = _cli(argv, "outer shell: step 5 UNet loss",
                                  card)
        if type(create_model(config_from_args(argv))).__name__ != \
                "FuncStructUNetAdd":
            raise AssertionError("step 5 --use_unet add: not FuncStructUNetAdd")
        steps, passes = 10, 10 + -(-P13_VAL // P13_UNET_BATCH)
        _per_pass(counts, ADD_FORWARD, ADD_BACKWARD, steps, passes,
                  "profiled step-5 UNet-loss run")
        with open(os.path.join(_experiment(root, "p5unet"),
                               "full_scores.csv")) as f:
            rows = list(csv.DictReader(f))
        norms = [r["norm/grad/global"] for r in rows]
        if (sum(v != "" for v in norms) != steps
                or not rows[0].get("unet_train_loss_history")
                or not rows[0].get("norm/grad/unet")):
            raise AssertionError(f"full_scores.csv: {list(rows[0])}")
        traces = glob.glob(os.path.join(prof, "*.json"))
        if len(traces) != 1:
            raise AssertionError(f"profile_dir holds {traces}")
        with open(traces[0]) as f:
            events = json.load(f)["traceEvents"]
        kernels = {e["name"] for e in events if e.get("cat") == "kernel"}
        found = {k: sorted(n for n in kernels if v in n)[:3]
                 for k, v in P13_TRACE.items()}
        if not all(found.values()):
            raise AssertionError(f"the trace names no kernel of {found}")
        launches["outer_shell_unet_profiled"] = counts
        print(f"step 5 FuncStructUNetAdd with --use_unet_loss "
              f"--log_grad_norms_every 1 --profiling: {steps} train steps, "
              f"{passes - steps} val passes in {wall:.1f} s (the profiler "
              f"on); full_scores.csv unet loss "
              f"{rows[0]['unet_train_loss_history']}, grad/global "
              f"{norms[:3]}...; trace {os.path.getsize(traces[0])} bytes, "
              f"{len(kernels)} kernel names, e.g. {found}; card: {card}")

        # ---- one float32 step of FuncStructUNetCross with the UNet loss ----
        cfg = dataclasses.replace(config_from_args(
            ["--step", "5", "--dataset_name", "multimodal", "--exp_name",
             "twin", "--use_unet", "--use_unet_struct", "--use_unet_loss"]
            + common), compute_dtype="float32")
        if set(_loss_specs(cfg)) != {"unet", "binary_classification"}:
            raise AssertionError(f"losses {_loss_specs(cfg)}")
        batch = _combiner_batches(CHAIN_BATCH, False, n=1)[0]
        steps = _step_compare(cfg, batch, "FuncStructUNetCross with the UNet "
                              "loss (full width, float32)",
                              (("card", "cuda", "std"),
                               ("plain twins on the card", "twins", "std")))
        f32 = {k.replace(" mm16", ""): n
               for k, n in {**CROSS_FORWARD, **CROSS_BACKWARD}.items()}
        _exact(steps["card"], {**f32, "K5 fused_adam": 1}, "UNet-loss twin step")
        if any(steps["plain twins on the card"].values()):
            raise AssertionError(f"the twins launched {steps}")
        launches["outer_shell_unet_cross_twin_step"] = steps["card"]
    _reconstruction_losses(card)
    print(f"outer-shell phase took {time.perf_counter() - t_phase:.1f} s "
          f"(K1 cases {t_k1:.1f} s); card: {card}")
    return launches


# ---- phase 14: the flagship's data-parallel step across ranks ------------

MG_REL = 1e-5   # two ranks vs accumulation_steps=2, each tensor's
                # max|diff| against its max-abs


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


@contextlib.contextmanager
def _launcher_env(world, rank=0):
    """A launcher's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``MASTER_ADDR``, ``MASTER_PORT`` on a free port) within the block."""
    keys = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
    saved = {k: os.environ.get(k) for k in keys}
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(_free_port()))
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _all_counts(counts):
    """A launch-count dict with every kernel of the port, zeros included."""
    from multimodal_neuroimage_tpu_torch import ops
    return {k: counts.get(k, 0) for k in ops.kernels()}


def _dp_ranks(backend, devices, tmp, label, card, timeout=600):
    """``bench/dp_step.py`` as one process a rank on ``devices`` (a launcher's
    environment each, cuDNN's deterministic algorithms on), every rank
    within ``timeout`` s of the start (then all are killed and the phase
    fails); each rank's result."""
    out = os.path.join(tmp, label)
    port = _free_port()
    procs = []
    for r, dev in enumerate(devices):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(len(devices)),
                   LOCAL_RANK=str(r), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port))
        log = open(f"{out}.rank{r}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-m",
             "multimodal_neuroimage_tpu_torch.bench.dp_step", out,
             "--backend", backend, "--device", dev],
            stdout=log, stderr=subprocess.STDOUT, env=env), log))
    t0 = time.perf_counter()
    try:
        for proc, _ in procs:
            proc.wait(timeout=max(timeout - (time.perf_counter() - t0), 1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for proc, log in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    wall = time.perf_counter() - t0
    for r, (proc, _) in enumerate(procs):
        text = open(f"{out}.rank{r}.log").read()
        print(f"[{label} rank {r}, rc {proc.returncode}] "
              + "\n".join(text.strip().splitlines()[-3:]))
        if proc.returncode != 0:
            raise AssertionError(f"{label}: rank {r} failed "
                                 f"(rc {proc.returncode}):\n{text[-4000:]}")
    print(f"{label}: {len(devices)} ranks in {wall:.1f} s; card: {card}")
    return [torch.load(f"{out}.rank{r}.pt", weights_only=False)
            for r in range(len(devices))]


def _check_dp(ranks, reference, label, card):
    """The ranks' parameters and K5 moments bitwise equal, each rank's
    launches exactly the flagship's a step, and rank 0's parameters within
    ``MG_REL`` of ``reference`` (one process, accumulation_steps=W) per
    tensor; the largest difference printed."""
    from multimodal_neuroimage_tpu_torch.bench.dp_step import (
        STEPS, worst_difference)
    first = ranks[0]
    for res in ranks[1:]:
        for k in ("params", "mu", "nu"):
            if not torch.equal(res[k], first[k]):
                d = (res[k] - first[k]).abs().max().item()
                raise AssertionError(f"{label}: rank {res['rank']}'s {k} "
                                     f"differ from rank 0's by {d:.3e}")
        if res["losses"] != first["losses"]:
            raise AssertionError(f"{label}: the ranks' losses differ")
    for res in ranks:
        counts = _all_counts(res["launches"])
        _per_pass(counts, CROSS_FORWARD, CROSS_BACKWARD, STEPS, STEPS,
                  f"{label} rank {res['rank']}")
        print(f"{label} rank {res['rank']} ({res['backend']}, "
              f"{res['device']}): launches over {STEPS} steps "
              f"{res['launches']}; losses {res['losses']}")
    worst = worst_difference(first, reference)
    if worst[0] > MG_REL:
        raise AssertionError(f"{label}: {worst[1]} differs from "
                             f"accumulation_steps={len(ranks)} by "
                             f"{worst[0]:.3e} of its max-abs (bound "
                             f"{MG_REL})")
    print(f"{label}: ranks bitwise equal; rank 0 vs one process at "
          f"accumulation_steps={len(ranks)} over the same rows: largest "
          f"max|diff| / max-abs {worst[0]:.3e} ({worst[1]}), bound "
          f"{MG_REL}; card: {card}")


def _launch_device_check(card):
    """K5 and K1's mm16 forward on ``cuda:1`` tensors while ``cuda:0`` is
    current, bitwise their launches on ``cuda:0`` (``KernelLibrary.call``
    makes the first tensor's device current for a launch)."""
    from multimodal_neuroimage_tpu_torch.ops import bert_layer as bl
    from multimodal_neuroimage_tpu_torch.ops import fused_update as fu
    gen = torch.Generator().manual_seed(SEED)
    n = 1 << 20
    host = [torch.randn(n, generator=gen) for _ in range(2)] + [
        torch.zeros(n), torch.zeros(n)]
    x = torch.randn(4, 369, 84, generator=gen)
    params = [p.cpu() for p in _k1_params16(gen)]
    outs = {}
    for dev in ("cuda:0", "cuda:1"):
        p, g, mu, nu = (t.to(dev) for t in host)
        with torch.cuda.device(0):
            fu.fused_adam_update(p, g, mu, nu, None, 1e-3, 10.0, 1000.0)
            y = bl.bert_layer_call16(x.to(dev), [q.to(dev) for q in params],
                                     12, 369)
        torch.cuda.synchronize(dev)
        outs[dev] = (p.cpu(), mu.cpu(), y.cpu())
    for a, b in zip(outs["cuda:0"], outs["cuda:1"]):
        if not torch.equal(a, b):
            raise AssertionError("a kernel launched on cuda:1 tensors with "
                                 "cuda:0 current differs from its launch "
                                 "on cuda:0")
    print(f"launch device: K5 and K1 mm16 on cuda:1 tensors with cuda:0 "
          f"current bitwise their cuda:0 launches; card: {card}")


def multi_gpu(card):
    """Phase 14 (``multi_gpu``): the flagship (full width, bf16 default,
    std layout) as ranks of ``torch.distributed`` (parallel/mesh.py).
    (a) NCCL at world size 1: three steps of the flagship at batch 4 with
    and without the process group (cuDNN's deterministic algorithms on
    both sides), bitwise equal (parameters, K5's moments, losses) with
    equal launches; then the CLI under a launcher's environment
    (``--distributed --step 5``, the 40-subject cohort on disk, batch 8,
    1 epoch: exactly the flagship's kernels a pass and a step). (b) Two
    ranks on the one card under gloo (``bench/dp_step.py``; NCCL refuses
    two ranks on one device), batch 4 a rank, dropout off, two updates:
    the ranks bitwise equal, rank 0 against one process with
    ``accumulation_steps=2`` on the same rows at ``MG_REL`` (cuDNN's
    deterministic algorithms on both sides), each rank's launches
    printed. (c) Where the machine has two cards: the kernels on
    ``cuda:1`` tensors with ``cuda:0`` current (``_launch_device_check``)
    and two NCCL ranks as (b). The all-reduce's time at the flagship's K5
    buffer under each backend. Returns the launch counts by path."""
    from multimodal_neuroimage_tpu_torch import ops
    from multimodal_neuroimage_tpu_torch.bench import dp_step
    from multimodal_neuroimage_tpu_torch.data import synthetic
    from multimodal_neuroimage_tpu_torch.ops import build
    from multimodal_neuroimage_tpu_torch.parallel import mesh
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    launches, allreduce = {}, {}

    # ---- (a) NCCL at world size 1: bitwise the step without a group ------
    # under cuDNN's deterministic algorithms on both sides, which
    # dp_step.build_step selects as the Trainer does (F16: at cuDNN's
    # default the backbone's conv gradients vary run to run)
    cfg = dp_step.flagship_config()
    batches = dp_step.global_batches(1, dp_step.BATCH, 3)

    def steps():
        _, opt, step = dp_step.build_step(cfg, "cuda")
        gen = torch.Generator().manual_seed(SEED)
        torch.cuda.synchronize()
        ops.reset_launches()
        losses = [{k: float(v) for k, v in step(b, gen, i)[0].items()}
                  for i, b in enumerate(batches)]
        torch.cuda.synchronize()
        return opt, losses, ops.launches()

    ref_opt, ref_losses, ref_counts = steps()
    with _launcher_env(1):
        device = mesh.maybe_initialize_distributed(
            dataclasses.replace(cfg, distributed=True), "cuda")
        import torch.distributed as dist
        if (dist.get_backend(), mesh.world(), device) != ("nccl", 1,
                                                          "cuda:0"):
            raise AssertionError(f"NCCL world 1: {dist.get_backend()}, "
                                 f"{mesh.world()}, {device}")
        opt, losses, counts = steps()
        allreduce["NCCL, world 1"] = (dp_step.allreduce_ms(
            opt.grads.clone()), 4 * opt.grads.numel())
        mesh.shutdown()
    for k in ("params", "mu", "nu"):
        if not torch.equal(getattr(opt, k), getattr(ref_opt, k)):
            raise AssertionError(f"NCCL world 1: K5's {k} differ from the "
                                 f"step without a process group")
    if losses != ref_losses or counts != ref_counts:
        raise AssertionError(f"NCCL world 1: losses {losses} / launches "
                             f"{counts} vs {ref_losses} / {ref_counts}")
    _per_pass(_all_counts(counts), CROSS_FORWARD, CROSS_BACKWARD, 3, 3,
              "NCCL world-1 steps")
    print(f"multi-GPU (a) NCCL world 1: 3 flagship steps (batch 4, bf16, "
          f"cuDNN deterministic on both sides) "
          f"bitwise the steps without a process group (parameters, K5's "
          f"moments, losses {[round(l['total'], 6) for l in losses]}); "
          f"launches a step equal: "
          f"{ {k: n // 3 for k, n in counts.items() if n} }")
    del opt, ref_opt
    gc.collect()
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        root = synthetic.generate_synthetic_cohort(
            os.path.join(tmp, "cohort"), n_subjects=DISK_SUBJECTS, seed=SEED)
        argv = ["--distributed", "--step", "5", "--dataset_name",
                "multimodal", "--exp_name", "dp1", "--base_path", root,
                "--target", "sex", "--seed", str(SEED), "--nEpochs", "1",
                "--dti_smri_path",
                os.path.join(root, "data", "dti+smri_cortical_thickness")]
        with _launcher_env(1):
            metrics, counts, wall, _ = _cli(argv, "multi-GPU: NCCL world 1",
                                            card)
        if mesh.initialized() or "val_AUROC" not in metrics:
            raise AssertionError(f"NCCL world-1 CLI run: group left "
                                 f"{mesh.initialized()}, metrics {metrics}")
        _per_pass(counts, CROSS_FORWARD, CROSS_BACKWARD, 3, 3 + 1,
                  "NCCL world-1 CLI run")
        launches["multi_gpu_nccl1"] = counts
        print(f"multi-GPU (a) CLI --distributed at world size 1: 1 epoch x 3 "
              f"steps at batch 8 in {wall:.1f} s, val_AUROC "
              f"{metrics['val_AUROC']:.4f}")

        # ---- (b) two gloo ranks on the one card -----------------------------
        gc.collect()
        torch.cuda.empty_cache()
        ranks = _dp_ranks("gloo", ["cuda:0", "cuda:0"], tmp,
                          "gloo_2_ranks_1_card", card)
        reference = dp_step.accumulated_reference(2)
        _check_dp(ranks, reference, "multi-GPU (b) gloo, 2 ranks, 1 card",
                  card)
        for res in ranks:
            launches[f"multi_gpu_gloo2_rank{res['rank']}"] = _all_counts(
                res["launches"])
        allreduce["gloo, 2 ranks on 1 card"] = (ranks[0]["allreduce_ms"],
                                                ranks[0]["allreduce_bytes"])

        # ---- (c) NCCL across two cards ------------------------------------
        if torch.cuda.device_count() >= 2:
            _launch_device_check(card)
            ranks = _dp_ranks("nccl", ["cuda", "cuda"], tmp,
                              "nccl_2_cards", card)
            _check_dp(ranks, reference, "multi-GPU (c) NCCL, 2 cards", card)
            for res in ranks:
                launches[f"multi_gpu_nccl2_rank{res['rank']}"] = _all_counts(
                    res["launches"])
            allreduce["NCCL, 2 cards"] = (ranks[0]["allreduce_ms"],
                                          ranks[0]["allreduce_bytes"])
        else:
            print(f"multi-GPU (c) NCCL across two cards: not run, this "
                  f"machine has {torch.cuda.device_count()} card")
    for what, (ms, nbytes) in allreduce.items():
        print(f"all-reduce mean of K5's flat gradient buffer ({nbytes} B), "
              f"{what}: median {ms:.3f} ms; card: {card}")
    print(f"multi-GPU phase: {time.perf_counter() - t_phase:.1f} s; "
          f"card: {card}")
    return launches


# ---- phase 15: repeatable steps on the card (F16) ---------------------------

F16_TIMED_BATCHES = (16, 64)


def reproducible_steps(card, rng):
    """Phase 15 (F16): (a) two ``Trainer``s of one seed (the flagship at
    its bf16 default, batch 4, std layout) take one step each on the same
    batch: the gradients, the updated parameters and the losses bitwise
    equal, the Trainer having selected cuDNN's deterministic algorithms
    (utils/reproducibility.py); (b) the same step at batch 16 and 64 with
    and without them, timed in turns (with, without, without, with), each
    side's median and the ratio: what F16's repair costs a step."""
    from multimodal_neuroimage_tpu_torch import ops
    from multimodal_neuroimage_tpu_torch.data.loader import DataPipeline
    from multimodal_neuroimage_tpu_torch.models.registry import (
        create_model, init_random_weights)
    from multimodal_neuroimage_tpu_torch.ops import build
    from multimodal_neuroimage_tpu_torch.train.losses import active_losses
    from multimodal_neuroimage_tpu_torch.train.state import (create_optimizer,
                                                             make_train_step)
    from multimodal_neuroimage_tpu_torch.train.trainer import Trainer
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = _flagship_cfg(compute_dtype="bfloat16")
    records = _cohort(rng, 2 * cfg.batch_size, 700)
    runs = []
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        for i in range(2):
            torch.backends.cudnn.deterministic = False
            trainer = Trainer(cfg, records, records[:cfg.batch_size],
                              device="cuda",
                              experiment_folder=os.path.join(tmp, str(i)))
            if not torch.backends.cudnn.deterministic:
                raise AssertionError("the Trainer on the card did not select "
                                     "cuDNN's deterministic algorithms")
            batch, _ = next(trainer.batches("train"))
            torch.cuda.synchronize()
            ops.reset_launches()
            losses, _, _ = trainer.train_step(batch, trainer.generator)
            torch.cuda.synchronize()
            runs.append((trainer.optimizer.grads.clone(),
                         trainer.optimizer.params.clone(),
                         {k: float(v) for k, v in losses.items()},
                         ops.launches()))
            del trainer
    (g0, p0, l0, c0), (g1, p1, l1, c1) = runs
    if not (torch.equal(g0, g1) and torch.equal(p0, p1) and l0 == l1
            and c0 == c1):
        raise AssertionError(
            f"F16: two bf16 flagship steps under the Trainer differ: "
            f"gradients max|diff| {(g0 - g1).abs().max().item():.3e}, "
            f"parameters {(p0 - p1).abs().max().item():.3e}, losses {l0} "
            f"vs {l1}")
    print(f"F16: two bf16 flagship training steps (batch 4, std layout) "
          f"under the Trainer, cuDNN's deterministic algorithms selected by "
          f"it: gradients ({g0.numel()} floats), updated parameters and "
          f"losses ({l0['total']:.6f}) bitwise equal; launches equal")
    del runs, g0, g1, p0, p1

    for B in F16_TIMED_BATCHES:
        gc.collect()
        torch.cuda.empty_cache()
        cfg_b = _flagship_cfg(compute_dtype="bfloat16", batch_size=B)
        pipe = DataPipeline(cfg_b, splits={"train": _cohort(rng, B, 800)},
                            device="cuda")
        batch = next(pipe.epoch("train", to_device=False))[0]
        model = init_random_weights(create_model(cfg_b),
                                    torch.Generator().manual_seed(SEED + 9))
        model.cuda()
        opt = create_optimizer("AdamW", model.parameters(), lambda t: 1e-4,
                               cfg_b.weight_decay)
        step = make_train_step(model, active_losses(cfg_b.task,
                                                    cfg_b.fine_tune_task),
                               opt, "bfloat16", "cuda")
        gen = torch.Generator().manual_seed(SEED + 10)
        times = {True: [], False: []}
        for det in (True, False, False, True):
            torch.backends.cudnn.deterministic = det
            for _ in range(2):
                step(batch, gen)
            torch.cuda.synchronize()
            for _ in range(4):
                t0 = time.perf_counter()
                step(batch, gen)
                torch.cuda.synchronize()
                times[det].append(1e3 * (time.perf_counter() - t0))
        torch.backends.cudnn.deterministic = True
        on, off = (statistics.median(times[d]) for d in (True, False))
        print(f"F16 cost: bf16 flagship training step at batch {B} (fwd + "
              f"bwd + K5, std layout, timed in turns, 8 steps a side): "
              f"deterministic cuDNN median {on:.3f} ms, cuDNN's default "
              f"{off:.3f} ms, ratio {on / off:.4f}; card: {card}")
        del model, opt, step
    print(f"F16 phase: {time.perf_counter() - t_phase:.1f} s; card: {card}")


# ---- phase 16: the exported serving artifact ---------------------------------

# the artifacts of the export phase: (label, config, fusion layout), each at
# full width and depth, exported with its registered ops and portable
EXPORTS = (("flagship_bf16", dict(compute_dtype="bfloat16"), "std"),
           ("flagship_bp", dict(compute_dtype="float32"), "bp"),
           ("hcp_bf16", dict(compute_dtype="bfloat16"), "std"))
# an artifact's scores against the live Predictor's (atol, rtol), at either
# compute dtype: about one float32 ulp apart (read: at most 4.2e-7, bf16
# and float32), as the live model on copies of its weights is
# (serve/export.py)
EXPORT_TOL = (1e-5, 1e-5)
# one served batch of the bf16 std flagship (the live Predictor's too)
EXPORT_STD16 = {"K1 bert_layer mm16": 32, "K2 fusion_block": 48,
                "K3 cross_fusion_block": 12, "K4 window_attention": 10}
# the export phase's worker processes, all started together (each traces
# and saves one artifact, then serves it in a fresh interpreter)
EXPORT_TIMEOUT = 900


def _export_cfg(label):
    """The config of an ``EXPORTS`` label and its fusion layout."""
    kw, lay = next((kw, lay) for name, kw, lay in EXPORTS if name == label)
    return (_hcp_cfg(**kw) if label.startswith("hcp")
            else _flagship_cfg(**kw)), lay


# a worker: argv[1] is the JSON of _export_and_serve's arguments
_EXPORT_WORKER = r"""
import json, sys
import chip_smoke
chip_smoke._export_and_serve(*json.loads(sys.argv[1]))
"""

# serves one artifact in a fresh interpreter that imports serve/export.py
# and ops/library.py only (argv: artifact, batches .npz, lock file): the
# scores of each batch (to artifact.scores.npy) and its launches; then,
# holding the lock (one artifact timed at a time), the median batch ms.
# Writes artifact.served.json: launches a batch, ms, ops, load s and the
# port modules loaded. torch's TF32 settings are left at their defaults,
# as a user's process has them.
_SERVE_ARTIFACT = r"""
import fcntl, json, statistics, sys, time
import numpy as np
import torch
from multimodal_neuroimage_tpu_torch.serve.export import load_exported
from multimodal_neuroimage_tpu_torch import ops
path, batches, lock = sys.argv[1:4]
t0 = time.perf_counter()
art = load_exported(path)
load_s = time.perf_counter() - t0
data = np.load(batches)
scores, counts = [], []
for i in range(int(data["n"])):
    batch = {k.split("/", 1)[1]: data[k] for k in data.files
             if k.startswith(f"{i}/")}
    torch.cuda.synchronize()
    ops.reset_launches()
    scores.append(art(batch))
    torch.cuda.synchronize()
    counts.append({k: v for k, v in ops.launches().items() if v})
first = {k.split("/", 1)[1]: torch.as_tensor(data[k], device="cuda")
         for k in data.files if k.startswith("0/")}
ms = []
with open(lock, "w") as f:
    fcntl.flock(f, fcntl.LOCK_EX)
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        art(first)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
np.save(path + ".scores.npy", np.stack(scores))
model = [m for m in sys.modules if m.startswith("multimodal_neuroimage_tpu")
         and not m.startswith("multimodal_neuroimage_tpu_torch.ops")
         and m not in ("multimodal_neuroimage_tpu_torch",
                       "multimodal_neuroimage_tpu_torch.serve",
                       "multimodal_neuroimage_tpu_torch.serve.export")]
with open(path + ".served.json", "w") as f:
    json.dump({"counts": counts, "ms": statistics.median(ms[1:]),
               "ops": art.meta["ops"], "load_s": load_s,
               "model_modules": sorted(model)}, f)
"""


def _export_and_serve(label, portable, tmp):
    """A worker of the export phase: ``label``'s Predictor on the card from
    the checkpoint and requests the phase left in ``tmp``, exported
    (``portable`` or with its registered ops) to ``tmp/{label}_{portable}
    .pt2``; then that artifact served by ``_SERVE_ARTIFACT`` in a fresh
    interpreter on the phase's batches. Writes the export's seconds to
    ``.pt2.export.json``; raises when either fails."""
    import pickle
    from multimodal_neuroimage_tpu_torch.serve.export import export_model
    from multimodal_neuroimage_tpu_torch.serve.predictor import Predictor
    cfg, lay = _export_cfg(label)
    with open(os.path.join(tmp, f"{label}.requests.pkl"), "rb") as f:
        requests = pickle.load(f)
    dest = os.path.join(tmp, f"{label}_{portable}.pt2")
    with _layout(lay):
        pred = Predictor(cfg, os.path.join(tmp, f"{label}.ckpt"), requests,
                         device="cuda")
        t0 = time.perf_counter()
        export_model(pred, dest, portable=portable)
        with open(dest + ".export.json", "w") as f:
            json.dump({"s": time.perf_counter() - t0}, f)
    del pred
    subprocess.run([sys.executable, "-c", _SERVE_ARTIFACT, dest,
                    os.path.join(tmp, f"{label}_batches.npz"),
                    os.path.join(tmp, "serve.lock")], check=True,
                   timeout=EXPORT_TIMEOUT)


def _export_workers(tmp, env):
    """``_export_and_serve`` for every artifact (each ``EXPORTS`` label,
    with its registered ops and portable) in worker processes started
    together, each logging to ``tmp``; all within ``EXPORT_TIMEOUT`` s of
    the start (then all are killed and the phase fails). Returns the wall
    seconds."""
    jobs = [(label, portable) for label, *_ in EXPORTS
            for portable in (False, True)]
    procs = []
    for label, portable in jobs:
        log = open(os.path.join(tmp, f"{label}_{portable}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-c", _EXPORT_WORKER,
             json.dumps([label, portable, tmp])],
            stdout=log, stderr=subprocess.STDOUT, env=env), log))
    t0 = time.perf_counter()
    try:
        for proc, _ in procs:
            proc.wait(timeout=max(EXPORT_TIMEOUT - (time.perf_counter() - t0),
                                  1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for proc, log in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    for (label, portable), (proc, _) in zip(jobs, procs):
        if proc.returncode != 0:
            text = open(os.path.join(tmp, f"{label}_{portable}.log")).read()
            raise AssertionError(f"export {label} (portable {portable}): "
                                 f"the worker failed (rc {proc.returncode})"
                                 f":\n{text[-4000:]}")
    return time.perf_counter() - t0


def _host_cost(op, direct, rounds=6, calls=40):
    """Host microseconds a call (the time until the call returns, launches
    queued, CUDA-synchronised between rounds) of ``op`` and ``direct``, in
    turns (op, direct, direct, op, ...), median over the rounds; and each
    one's device ms (CUDA events)."""
    host = {"op": [], "direct": []}
    fns = {"op": op, "direct": direct}
    order = ["op", "direct", "direct", "op"] * (rounds // 2)
    for name in order:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fns[name]()
        host[name].append(1e6 * (time.perf_counter() - t0) / calls)
        torch.cuda.synchronize()
    dev_op, dev_direct = _turns([op, direct], iters=20)
    return (statistics.median(host["op"]), statistics.median(host["direct"]),
            dev_op, dev_direct)


def _op_host_costs(card, gen):
    """One call through a registered op beside the same direct wrapper
    call (inference, no autograd): K1 mm16 and K4 at the flagship's batch
    4. Prints the host cost a call."""
    from multimodal_neuroimage_tpu_torch.ops import attention as att
    from multimodal_neuroimage_tpu_torch.ops import bert_layer as bl
    from multimodal_neuroimage_tpu_torch.ops import library
    x = torch.randn(4, 369, 84, generator=gen).cuda()
    p = _k1_params16(gen)
    q, k, v, b4, mask, label = _k4_inputs(gen, 4)[0]
    cases = (
        ("K1 bert_layer mm16 (batch 4, T 369, H 84, 12 heads)",
         lambda: library.bert_layer_forward(x, list(p), 12, 369, True),
         lambda: bl.bert_layer_call16(x, p, 12, 369)),
        (f"K4 window_attention (batch 4, {label})",
         lambda: library.window_attention_forward(q, k, v, b4, mask),
         lambda: att.fused_window_attention(q, k, v, b4, mask)))
    with torch.no_grad():
        for name, op, direct in cases:
            if not torch.equal(op(), direct()):
                raise AssertionError(f"{name}: the registered op and the "
                                     f"direct call differ")
            h_op, h_dir, d_op, d_dir = _host_cost(op, direct)
            print(f"registered op vs direct call, {name}: host "
                  f"{h_op:.1f} us vs {h_dir:.1f} us a call (op costs "
                  f"{h_op - h_dir:+.1f} us), call time (CUDA events) "
                  f"{d_op:.4f} ms vs {d_dir:.4f} ms; card: {card}")


def _reference_sd(state):
    """The reference's ``.pth`` layout of a flagship state: the BERTs and
    the SwinFusion backbone at the top level, the classifier under
    ``swin.``, HF's two token-type rows and word embeddings."""
    sd = {}
    for k, v in state.items():
        for p in ("fmri_embed.", "fusion."):
            if k.startswith(p):
                k = k[len(p):]
        sd[k] = v
        if k.endswith("token_type_embeddings.weight"):
            sd[k] = torch.cat([v, torch.randn_like(v)])
            sd[k.replace("token_type", "word")] = torch.randn(3, v.shape[1])
    return sd


def export_phase(card, gen, rng):
    """Phase 16 (``export``): serve/export.py on the card at full width and
    depth. Exports (``EXPORTS``) the flagship at its bf16 default on the std
    layout, the flagship at float32 on ``bp`` and HCP phase 1 at its bf16
    default, each with its registered ops and ``portable=True``, from
    random weights of a seed; the six exports run at once in worker
    processes, each serving its artifact in a fresh interpreter that
    imports serve/export.py and ops/library.py only (checked: no model
    module of the port is loaded there) on the live Predictor's batches:
    the artifacts' scores within ``EXPORT_TOL`` of the Predictor's and
    their launches a batch equal to its (the bf16 std flagship's K1 mm16
    32, K2 48, K3 12, K4 10), the portable ones within the serving
    tolerance of them and without a launch. Prints the export and load
    times, the artifact sizes (the bf16 flagship's against the float32
    one's), the served batch's time beside the live step's, the registered
    ops' host cost a call (``_op_host_costs``); maps the flagship's weights
    from the reference's layout on the CPU (utils/torch_import.py, its
    BERTs' token-type rows as utils/hf_import.py) and serves them on the
    card bitwise the original's; loads a synthetic ``fMRI_image`` cohort
    in the native gear, equal to the host gear. Returns the artifacts'
    launches by path."""
    import pickle
    from multimodal_neuroimage_tpu_torch.ckpt.checkpoint import (
        load_checkpoint, save_checkpoint)
    from multimodal_neuroimage_tpu_torch.data import synthetic
    from multimodal_neuroimage_tpu_torch.data.loader import DataPipeline
    from multimodal_neuroimage_tpu_torch.models.registry import (
        create_model, init_random_weights)
    from multimodal_neuroimage_tpu_torch import ops
    from multimodal_neuroimage_tpu_torch.obs.profiling import traced_flops
    from multimodal_neuroimage_tpu_torch.ops import build
    from multimodal_neuroimage_tpu_torch.serve.predictor import Predictor
    from multimodal_neuroimage_tpu_torch.utils import torch_import
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    _op_host_costs(card, gen)
    launches, live, work = {}, {}, {}
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        # ---- the live Predictors: their scores, launches and step ------
        for label, _, lay in EXPORTS:
            cfg, _ = _export_cfg(label)
            if label.startswith("hcp"):
                requests = [{k: r[k] for k in ("subject", "fmri")}
                            for r in _hcp_cohort(np.random.default_rng(SEED),
                                                 2 * cfg.batch_size, 900)]
            else:
                requests = [{k: r[k] for k in ("subject", "fmri", "struct")}
                            for r in _cohort(rng, 2 * cfg.batch_size, 900)]
            with open(os.path.join(tmp, f"{label}.requests.pkl"), "wb") as f:
                pickle.dump(requests, f)
            model = init_random_weights(
                create_model(cfg), torch.Generator().manual_seed(SEED))
            ckpt = save_checkpoint(os.path.join(tmp, f"{label}.ckpt"),
                                   model.state_dict(),
                                   {"val_threshold": 0.5})
            n_params = sum(p.numel() for p in model.parameters())
            del model
            with _layout(lay):
                pred = Predictor(cfg, ckpt, requests, device="cuda")
                batches = [b for b, _ in pred.batches()]
                counts, scores = [], []
                for b in batches:
                    torch.cuda.synchronize()
                    ops.reset_launches()
                    scores.append(pred.step(b)[pred.head].reshape(-1).cpu()
                                  .numpy())
                    torch.cuda.synchronize()
                    counts.append({k: v for k, v in ops.launches().items()
                                   if v})
                step_ms = events_ms(lambda: pred.step(batches[0]), iters=5)
                work[label] = traced_flops(pred.step, batches[0])
            np.savez(os.path.join(tmp, f"{label}_batches.npz"),
                     n=len(batches), **{
                         f"{j}/{k}": v.cpu().numpy()
                         for j, b in enumerate(batches)
                         for k, v in b.items() if torch.is_tensor(v)})
            live[label] = (cfg, np.stack(scores), counts, step_ms, n_params)
            del pred
            gc.collect()
            torch.cuda.empty_cache()

        # ---- the six artifacts, exported and served at once ------------
        wall = _export_workers(tmp, dict(
            os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(
                __file__)) + os.pathsep + os.environ.get("PYTHONPATH", "")))
        print(f"export: {2 * len(EXPORTS)} artifacts exported and served at "
              f"once in {wall:.1f} s (worker processes; each served in a "
              f"fresh interpreter importing serve/export.py and "
              f"ops/library.py, its batch times taken one artifact at a "
              f"time)")
        sizes = {}
        for label, (cfg, want, counts, step_ms, n_params) in live.items():
            got, art = {}, {}
            for portable in (False, True):
                dest = os.path.join(tmp, f"{label}_{portable}.pt2")
                with open(dest + ".served.json") as f:
                    art[portable] = json.load(f)
                with open(dest + ".export.json") as f:
                    art[portable]["export_s"] = json.load(f)["s"]
                with open(dest + ".json") as f:
                    art[portable]["flops"] = json.load(f)["flops"]
                if art[portable]["flops"] != work[label]:
                    raise AssertionError(
                        f"export {label} (portable {portable}): the "
                        f"artifact's graph_flops {art[portable]['flops']} vs "
                        f"the live predict step's traced_flops "
                        f"{work[label]}")
                art[portable]["bytes"] = os.path.getsize(dest)
                if art[portable]["model_modules"]:
                    raise AssertionError(
                        f"export {label}: the serving interpreter loaded "
                        f"model modules {art[portable]['model_modules']}")
                got[portable] = torch.from_numpy(np.load(
                    dest + ".scores.npy"))
            art_err = _close(f"export {label} scores vs the live Predictor",
                             got[False], torch.from_numpy(want), *EXPORT_TOL)
            if art[False]["counts"] != counts:
                raise AssertionError(f"export {label}: artifact launches "
                                     f"{art[False]['counts']} vs live "
                                     f"{counts}")
            if label == "flagship_bf16" and counts[0] != EXPORT_STD16:
                raise AssertionError(f"export {label}: launches a batch "
                                     f"{counts[0]}, expected {EXPORT_STD16}")
            if any(art[True]["counts"]) or art[True]["ops"]:
                raise AssertionError(f"export {label}: the portable artifact "
                                     f"launched {art[True]['counts']}, ops "
                                     f"{art[True]['ops']}")
            atol, rtol = ((LOGIT16, LOGIT16) if cfg.compute_dtype ==
                          "bfloat16" else (LOGIT_ATOL, LOGIT_RTOL))
            port_err = _close(f"export {label} portable scores", got[True],
                              got[False], atol, rtol)
            total = {}
            for c in art[False]["counts"]:
                for k, n in c.items():
                    total[k] = total.get(k, 0) + n
            launches[f"export_{label}"] = total
            sizes[label] = (art[False]["bytes"], n_params, cfg.compute_dtype)
            a, p = art[False], art[True]
            print(f"export {label}: {n_params} parameters at "
                  f"{cfg.compute_dtype}, {len(want)} batches of "
                  f"{cfg.batch_size}; graph_flops of both artifacts "
                  f"{work[label]} a batch, the live step's traced_flops; "
                  f"artifact scores vs the live "
                  f"Predictor's max|err| {art_err:.3e} (atol {EXPORT_TOL[0]}"
                  f" + rtol {EXPORT_TOL[1]}), launches a batch equal "
                  f"({counts[0]}); ops {a['ops']}; traced and saved in "
                  f"{a['export_s']:.1f} s, {a['bytes']} B, loaded in "
                  f"{a['load_s']:.1f} s; served batch {a['ms']:.2f} ms vs "
                  f"live predict step {step_ms:.2f} ms; portable artifact: "
                  f"no launch, scores vs the artifact's max|err| "
                  f"{port_err:.3e} (atol {atol} + rtol {rtol}), traced and "
                  f"saved in {p['export_s']:.1f} s, {p['bytes']} B, loaded "
                  f"in {p['load_s']:.1f} s, served batch {p['ms']:.2f} ms; "
                  f"card: {card}")
        (s16, n16, _), (s32, n32, _) = sizes["flagship_bf16"], \
            sizes["flagship_bp"]
        print(f"export artifact size, the flagship's model and weights "
              f"({n16} and {n32} parameters): bf16 (std) {s16} B vs float32 "
              f"(bp) {s32} B, ratio {s16 / s32:.3f}")

        # ---- weights from the reference's layout, mapped on the CPU -------
        cfg, *_ = live["flagship_bf16"]
        ckpt = os.path.join(tmp, "flagship_bf16.ckpt")
        state = load_checkpoint(ckpt)["state_dict"]
        mapped = torch_import.reference_model_state(_reference_sd(state), cfg)
        if sorted(mapped) != sorted(state) or not all(
                torch.equal(mapped[k], state[k]) for k in state):
            raise AssertionError("torch_import did not give back the "
                                 "flagship's state")
        mckpt = save_checkpoint(os.path.join(tmp, "mapped.ckpt"), mapped,
                                {"val_threshold": 0.5})
        requests = [{k: r[k] for k in ("subject", "fmri", "struct")}
                    for r in _cohort(rng, cfg.batch_size, 950)]
        a = Predictor(cfg, ckpt, requests, device="cuda").predict()
        b = Predictor(cfg, mckpt, requests, device="cuda").predict()
        if a != b:
            raise AssertionError("the mapped weights serve otherwise on the "
                                 "card")
        print(f"export: the flagship's weights in the reference's layout "
              f"(HF BERTs with two token types) mapped on the CPU by "
              f"utils/torch_import.py reference_model_state served on the "
              f"card bitwise the original's ({len(a)} subjects)")

        # ---- an fMRI_image cohort in the native gear ---------------------
        root = synthetic.generate_synthetic_cohort(
            os.path.join(tmp, "img"), n_subjects=12, seed=SEED,
            include_fmri_image=True)
        got = {}
        for gear in ("native", "host"):
            icfg = synthetic.synthetic_config(
                root, dataset_name="fMRI_image", target="sex", batch_size=4,
                preprocess=gear, workers=4).validate()
            t0 = time.perf_counter()
            got[gear] = list(DataPipeline(icfg, device="cuda").epoch(
                "train", to_device=False))
            got[gear + "_s"] = time.perf_counter() - t0
        for (nb, nn_), (hb, hn) in zip(got["native"], got["host"]):
            if nn_ != hn or not np.array_equal(nb["fmri_sequence"],
                                               hb["fmri_sequence"]):
                raise AssertionError("fMRI_image: the native gear's batch "
                                     "differs from the host gear's")
        shape = got["native"][0][0]["fmri_sequence"].shape
        print(f"export: fMRI_image cohort (12 subjects, NIfTI volumes) in "
              f"the native gear: {len(got['native'])} train batches of "
              f"{shape} in {got['native_s']:.3f} s, equal to the host "
              f"gear's ({got['host_s']:.3f} s)")
    print(f"export phase: {time.perf_counter() - t_phase:.1f} s; card: "
          f"{card}")
    return launches


# ---- phase 17: the count of a step's work ---------------------------------------

WORK_BATCH = 4
WORK_BP_BATCH = 8          # the bp layout at G = 8


@contextlib.contextmanager
def _plain_route():
    """Within the block every kernel's call site runs the kernel's plain
    forward, on whatever device its tensors are, and autograd through it:
    the step's products as the plain versions compute them, with no
    formula and no recompute (unlike ``_plain_twins``, whose backwards
    recompute their forward)."""
    from multimodal_neuroimage_tpu_torch.nn import bert, swin2d, swinfusion
    from multimodal_neuroimage_tpu_torch.ops import attention as att
    from multimodal_neuroimage_tpu_torch.ops import bert_layer as bl
    from multimodal_neuroimage_tpu_torch.ops import fusion_block as fb
    from multimodal_neuroimage_tpu_torch.ops import fusion_block_bp as fbp
    from multimodal_neuroimage_tpu_torch.ops import fused_update as fu

    def k6(q, k, v, seed=0, rate=0.0):
        plain = (att.mha_reference16 if q.dtype == torch.bfloat16
                 else att.mha_reference)
        return plain(q, k, v, seed, rate)

    def k7(x, params, bias, mask=None, dp=None, seed=0, rates=(0.0, 0.0),
           training=False, group=None):
        if x.dtype == torch.bfloat16:
            return fbp.fusion_block_bp_reference16(
                x, params, bias, mask, dp, seed, rates, training, None,
                group)[0]
        return fbp.fusion_block_bp_reference(x, params, bias, mask, dp, seed,
                                             rates, training, group)

    def k7_cross(x, y, params, bias, mask=None, dp=None, seed=0,
                 rates=(0.0, 0.0), training=False, group=None):
        if x.dtype == torch.bfloat16:
            return fbp.fusion_block_bp_reference16(
                x, params, bias, mask, dp, seed, rates, training, y,
                group)[0]
        return fbp.cross_fusion_block_bp_reference(
            x, y, params, bias, mask, dp, seed, rates, training, group)

    patches = ((bert, "bert_layer_call", bl.bert_layer_reference),
               (bert, "fused_attention", k6),
               (swin2d, "fused_window_attention", att.attention_reference),
               (swinfusion, "fused_fusion_block", fb.fusion_block_reference),
               (swinfusion, "fused_cross_fusion_block",
                fb.cross_fusion_block_reference),
               (swinfusion, "fused_fusion_block_bp", k7),
               (swinfusion, "fused_cross_fusion_block_bp", k7_cross),
               (fu, "fused_adam_update", fu.fused_adam_reference))
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    for mod, name, fn in patches:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _work_configs():
    """(label, Config, fusion layout, numpy batch) of each ``bench.py``
    config at full width (``bench.py`` ``_bench_setup``; the host gear)."""
    from multimodal_neuroimage_tpu_torch.config import Config
    rng = np.random.default_rng(SEED)

    def f32(*shape):
        return rng.normal(size=shape).astype(np.float32)

    def flagship(B):
        return {**{k: f32(B, 368, 84) for k in (
            "fmri_raw_sequence", "fmri_lowfreq_sequence",
            "fmri_ultralowfreq_sequence")}, "struct": f32(B, 84, 84),
            "target": (np.arange(B) % 2).astype(np.float32)}

    B = WORK_BATCH
    target = (np.arange(B) % 2).astype(np.float32)
    common = dict(fine_tune_task="binary_classification", batch_size=B,
                  preprocess="host", seed=SEED)
    bert_cfg = Config(task="2DBERT", dataset_name="fMRI_timeseries",
                      target="ADHD_label", fmri_type="timeseries",
                      **common).validate()
    hcp = _hcp_cfg(batch_size=B, preprocess="host")
    out = [("flagship", _flagship_cfg(batch_size=B), "std", flagship(B)),
           ("flagship_bf16", _flagship_cfg(batch_size=B,
                                           compute_dtype="bfloat16"),
            "std", flagship(B)),
           ("flagship_b8", _flagship_cfg(batch_size=WORK_BP_BATCH), "std",
            flagship(WORK_BP_BATCH)),
           ("flagship_bp", _flagship_cfg(batch_size=WORK_BP_BATCH), "bp",
            flagship(WORK_BP_BATCH)),
           ("flagship_bp_bf16", _flagship_cfg(batch_size=WORK_BP_BATCH,
                                              compute_dtype="bfloat16"),
            "bp", flagship(WORK_BP_BATCH)),
           ("smri_swin", Config(task="VIT", dataset_name="sMRI",
                                target="sex", **common).validate(), "std",
            {"smri": f32(B, 84, 84), "target": target}),
           ("fmri_bert", bert_cfg, "std",
            {"fmri_sequence": f32(B, bert_cfg.sequence_length,
                                  bert_cfg.intermediate_vec),
             "target": target}),
           ("swinfusion_struct", Config(task="SwinFusion",
                                        dataset_name="struct", target="sex",
                                        **common).validate(), "std",
            {"smri": f32(B, 84, 84), "dti": f32(B, 84, 84),
             "target": target}),
           ("hcp", hcp, "std",
            {"fmri_sequence": f32(B, hcp.sequence_length,
                                  hcp.intermediate_vec), "target": target})]
    return out


def _count_steps(cfg, batch, layout, device: str = "cuda"):
    """One predict and one training step of ``cfg`` from random weights of
    a seed, counted on the kernel route and then on the plain route
    (``_plain_route``): ({"predict", "train": Census with formulas,
    "compiled": the training step's compiled_cost, "launches": the steps'
    launches}, {"predict", "train": Census without, "launches"})."""
    from multimodal_neuroimage_tpu_torch import ops
    from multimodal_neuroimage_tpu_torch.models.registry import (
        create_model, init_random_weights)
    from multimodal_neuroimage_tpu_torch.obs.profiling import (
        Census, compiled_cost)
    from multimodal_neuroimage_tpu_torch.serve.predictor import (
        make_predict_step)
    from multimodal_neuroimage_tpu_torch.train.state import (
        create_optimizer, make_train_step)
    routes = []
    with _layout(layout):
        model = init_random_weights(create_model(cfg),
                                    torch.Generator().manual_seed(SEED))
        model.to(device)
        opt = create_optimizer(cfg.optim, model.parameters(),
                               lambda t: 1e-3, cfg.weight_decay)
        train = make_train_step(model, _loss_specs(cfg), opt,
                                cfg.compute_dtype, device)
        gen = torch.Generator().manual_seed(SEED)
        for plain in (False, True):
            with _plain_route() if plain else contextlib.nullcontext():
                # the predict step puts the model in eval mode when built
                predict = make_predict_step(model, cfg.compute_dtype, device)
                ops.reset_launches()
                out = {}
                with Census(formulas=not plain) as out["predict"]:
                    predict(batch)
                with Census(formulas=not plain) as out["train"]:
                    train(batch, gen)
                out["launches"] = {k: n for k, n in ops.launches().items()
                                   if n}
                if not plain:
                    out["compiled"] = compiled_cost(train, batch,
                                                    gen)["flops"]
            routes.append(out)
    del model, opt, train, predict
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return routes


def _jax_analytic_flagship(cfg) -> float:
    """JAX's hand model of one flagship training step per subject
    (bench.py:372-389): 3 x forward x 1.05 over the BERTs and the fusion
    blocks."""
    T = cfg.sequence_length + 1
    Hd, I = cfg.intermediate_vec, cfg.bert_intermediate_size
    L = int(cfg.transformer_hidden_layers)
    bert = L * 2 * (2 * T * Hd * (4 * Hd + 2 * I) + 4 * T * T * Hd)
    R, C = Hd * Hd, cfg.fusion_embed_dim
    n_blocks = (2 * sum(cfg.fusion_ex_depths) + 4 * sum(cfg.fusion_depths)
                + sum(cfg.fusion_re_depths))
    nw, n2 = (Hd // 6) ** 2, (6 * 6) ** 2
    fusion = n_blocks * (2 * R * C * 12 * C + 4 * nw * 6 * n2
                         * max(C // 6, 1))
    return 3 * (bert + fusion) * 1.05


def work_counts(card):
    """Phase 17 (``work_counts``; module docstring): the count of each
    ``bench.py`` config's training and predict step at full width on the
    kernel route against the plain route's products on the card. Returns
    {label: (train, predict) per subject}."""
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    per_subject, totals = {}, {}
    for label, cfg, layout, batch in _work_configs():
        t0 = time.perf_counter()
        B = cfg.batch_size
        kern, plain = _count_steps(cfg, batch, layout)
        train, predict = kern["train"].total, kern["predict"].total
        share = sum(kern["train"].kernels.values())
        if (plain["train"].total, plain["predict"].total) != (train,
                                                              predict):
            raise AssertionError(
                f"{label}: the kernel route counts {train} (training step) "
                f"and {predict} (predict step), the plain route's products "
                f"are {plain['train'].total} and {plain['predict'].total}")
        if kern["compiled"] != train - share:
            raise AssertionError(
                f"{label}: compiled_cost of the kernel route "
                f"{kern['compiled']:.0f} is not the count {train} less the "
                f"kernels' share {share}")
        unlaunched = [k for k, n in {**kern["train"].kernels,
                                     **kern["predict"].kernels}.items()
                      if n and k not in kern["launches"]]
        if unlaunched or not share or plain["launches"]:
            raise AssertionError(
                f"{label}: kernels counted but not launched {unlaunched}; "
                f"launches on the plain route {plain['launches']}")
        if train % B or predict % B:
            raise AssertionError(f"{label}: counts {train}, {predict} not "
                                 f"a multiple of the batch {B}")
        per_subject[label] = (train // B, predict // B)
        totals[label] = (train, predict)
        print(f"work {label} (batch {B}, {layout}, {cfg.compute_dtype}): "
              f"training step {train // B} products a subject, predict "
              f"step {predict // B}; kernels' share of the training step "
              f"{share / train:.4f} ({', '.join(sorted(kern['launches']))});"
              f" plain route equal; compiled_cost {kern['compiled']:.0f} = "
              f"count - kernels' share; {time.perf_counter() - t0:.1f} s")
    # the same batch in every form (the SwinV2 head's relative-position
    # MLP runs once a batch, so a count a subject depends on the batch)
    for same in (("flagship", "flagship_bf16"),
                 ("flagship_b8", "flagship_bp", "flagship_bp_bf16")):
        if len({totals[k] for k in same}) != 1:
            raise AssertionError(f"the flagship's forms count differently "
                                 f"at one batch: "
                                 f"{ {k: totals[k] for k in same} }")
    analytic = _jax_analytic_flagship(_flagship_cfg())
    print(f"work flagship: {per_subject['flagship'][0]} products a subject "
          f"a training step against JAX's analytic {analytic:.0f} (bench.py"
          f":372-389; ratio {per_subject['flagship'][0] / analytic:.4f})")
    print(f"work phase: {len(per_subject)} configs in "
          f"{time.perf_counter() - t_phase:.1f} s; card: {card}")
    return per_subject


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from multimodal_neuroimage_tpu_torch import ops
    from multimodal_neuroimage_tpu_torch.models.registry import create_model
    from multimodal_neuroimage_tpu_torch.ops import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {name}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()

    def elapsed(done):
        print(f"[{time.perf_counter() - t_start:.1f} s] {done}")

    lib = build.library()
    print(f"kernels built in {lib.build_seconds:.1f} s -> {lib.path.name}")
    for line in _ptxas_summary(lib.build_log):
        print(line)
    _fusion_occupancy()

    cfg = _flagship_cfg()
    n_params = sum(p.numel() for p in create_model(cfg).parameters())
    gen = torch.Generator().manual_seed(SEED)
    results = Results()
    k1_forward_kernels(gen, results)
    forward_kernels(gen, results)
    backward_kernels(gen, results, n_params)
    mha_kernels(gen, results)
    mha16_kernels(gen, results)
    bp_kernels(gen, results)
    bf16_kernels(gen, results)
    dot_counts = dot_shape_kernels(results)
    elapsed("kernel phases")

    rng = np.random.default_rng(SEED)
    train_records = _cohort(rng, N_TRAIN, 0)
    val_records = _cohort(rng, N_VAL, N_TRAIN)
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        # ---- (b) the flagship training run --------------------------------
        trainer, metrics, train_counts, wall = _train(
            cfg, train_records, val_records, tmp, "flagship")
        missing = [k for k in FLAGSHIP_KERNELS if train_counts[k] == 0]
        if missing:
            raise AssertionError(f"kernels not launched by the training "
                                 f"run: {missing}")
        if any(train_counts[k] for k in train_counts
               if k not in FLAGSHIP_KERNELS):
            raise AssertionError(f"a kernel off the flagship's path ran: "
                                 f"{train_counts}")
        _print_run("flagship", cfg, trainer, metrics, wall)

        # ---- serving from the trained checkpoint --------------------------
        requests = [{k: r[k] for k in ("subject", "fmri", "struct")}
                    for r in val_records]
        serve_counts = _serve(cfg, trainer.best_checkpoint(), requests,
                              tmp, "flagship", card)
        forward = [k for k in FLAGSHIP_KERNELS
                   if "backward" not in k and "adam" not in k]
        if (any(serve_counts[k] == 0 for k in forward)
                or any(n for k, n in serve_counts.items()
                       if k not in forward)):
            raise AssertionError(f"the serving run did not launch exactly "
                                 f"the four forward kernels: {serve_counts}")

    # ---- (c) one flagship training step on the card against the CPU -------
    # at a cut depth (the CPU's side at full depth took 83-100 s), and the
    # full-depth step against the plain twins on the card
    batch, _ = next(trainer.batches("train"))
    _step_compare(dataclasses.replace(cfg, transformer_hidden_layers=2,
                                      **CPU_STEP_DEPTH), batch,
                  "flagship (cut depth)",
                  (("card", "cuda", "std"), ("CPU", "cpu", "std")))
    _step_compare(cfg, batch, "flagship (full depth)",
                  (("card", "cuda", "std"),
                   ("plain twins on the card", "twins", "std")))

    # ---- (d) flagship training-step time ------------------------------------
    _time_train_step(trainer, "flagship", card)
    calls = {"K1 bert_layer backward": 32, "K2 fusion_block backward": 48,
             "K3 cross_fusion_block backward": 12,
             "K4 window_attention backward": 10, "K5 fused_adam": 1}
    share = {k: results.rows[k].get("batch4_ms", results.rows[k]["ms"]
                                    / results.rows[k]["cases"]) * n
             for k, n in calls.items()}
    print("backward kernels per step (kernel ms x calls): " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in sorted(share.items(),
                                             key=lambda kv: -kv[1])))
    del trainer

    # ---- the flagship on the bp fusion layout at batch 16 ------------------
    elapsed("flagship phase")
    bp_counts = flagship_bp(rng, card)
    elapsed("flagship bp phase")

    # ---- the flagship at its shipping bf16 policy, std and bp ---------------
    bf16_counts, bp_bf16_counts = flagship_bf16(rng, card, train_records,
                                                val_records)

    # ---- the HCP phase-1 path: TransformerNet, every layer on K6 -----------
    elapsed("flagship bf16 phase")
    hcp = _hcp_cfg(compute_dtype="float32")
    if (hcp.intermediate_vec, hcp.sequence_length, hcp.num_heads_2DBert,
            hcp.batch_size, hcp.transformer_hidden_layers) != (
                22, 1200, 2, HCP_BATCH, 16):
        raise AssertionError(f"unexpected HCP config: {hcp}")
    hcp_train = _hcp_cohort(rng, N_TRAIN, 0)
    hcp_val = _hcp_cohort(rng, N_VAL, N_TRAIN)
    layers = hcp.transformer_hidden_layers
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        # ---- (b) the HCP training run ---------------------------------------
        htrainer, hmetrics, hcp_counts, wall = _train(
            hcp, hcp_train, hcp_val, tmp, "HCP")
        steps = hcp.nEpochs * htrainer.steps_per_epoch
        evals = hcp.nEpochs * -(-N_VAL // hcp.batch_size)
        expect = {"K6 fused_attention": layers * (steps + evals),
                  "K6 fused_attention backward": layers * steps,
                  "K5 fused_adam": steps}
        if hcp_counts != {k: expect.get(k, 0) for k in hcp_counts}:
            raise AssertionError(f"HCP training launches {hcp_counts}, "
                                 f"expected {expect} and no other kernel")
        _print_run("HCP", hcp, htrainer, hmetrics, wall)

        # ---- (c) serving the HCP val subjects ---------------------------------
        requests = [{k: r[k] for k in ("subject", "fmri")} for r in hcp_val]
        counts = _serve(hcp, htrainer.best_checkpoint(), requests, tmp,
                        "HCP", card)
        passes = -(-N_VAL // hcp.batch_size)
        if counts != {k: layers * passes if k == "K6 fused_attention" else 0
                      for k in counts}:
            raise AssertionError(f"HCP serving launches {counts}: expected "
                                 f"K6 forward {layers} x {passes} only")

    # ---- (d) one HCP training step on the card against the CPU -------------
    # at a cut depth (HCP_CPU_LAYERS: the CPU's side at 16 layers took
    # 35-50 s on the host of an NVIDIA H100 80GB HBM3, 700 W); K6 runs every
    # layer alike, and the 2-epoch run above holds the full depth's launches
    batch, _ = next(htrainer.batches("train"))
    cut = dataclasses.replace(hcp, transformer_hidden_layers=HCP_CPU_LAYERS)
    _step_compare(cut, batch, "HCP (cut depth)",
                  (("card", "cuda", "std"), ("CPU", "cpu", "std")))

    # ---- (e) HCP training-step time ----------------------------------------
    _time_train_step(htrainer, "HCP", card)
    del htrainer

    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as keep:
        # ---- HCP phase 1 at its default bf16 policy: K6's bf16 form ---------
        elapsed("HCP phase")
        hcp16_counts, hcp16_ckpt = hcp_bf16(card, hcp_train, hcp_val, keep)
        elapsed("HCP bf16 phase")

        # ---- the flagship at its full Config defaults (bf16, device gear) ---
        defaults_counts = flagship_defaults(card, train_records, val_records)
        elapsed("flagship defaults phase")

        # ---- the flagship and HCP from cohorts on disk ----------------------
        disk_counts, hcp_disk_counts = disk_cohorts(card, hcp16_ckpt)

    # ---- the structural phases: phase 3's SwinV2 nets, phase 6's fusion -----
    elapsed("on-disk phase")
    struct_counts = struct_phases(card, gen, results)
    elapsed("structural phases")

    # ---- the phase chain and phase 5's combiners through the CLI ------------
    chain_counts = phase_chain(card)
    elapsed("phase-chain phase")

    # ---- phase 2's fMRI nets: the MulT and the two-channel net --------------
    phase2_counts = phase2_nets(card, gen, results)
    elapsed("phase-2 phase")

    # ---- the training run's outer shell: K1 at every head dim, the study,
    # the UNet loss, the Writer's norms, the profiler ------------------------
    outer_counts = outer_shell(card, gen, results)
    elapsed("outer-shell phase")

    # ---- the flagship's data-parallel step across ranks ---------------------
    multi_counts = multi_gpu(card)
    elapsed("multi-GPU phase")

    # ---- repeatable steps on the card (F16) and what they cost --------------
    reproducible_steps(card, rng)
    elapsed("F16 phase")

    # ---- the exported serving artifact ---------------------------------------
    export_counts = export_phase(card, gen, rng)
    elapsed("export phase")

    # ---- the count of a step's work -------------------------------------------
    work_counts(card)
    elapsed("work phase")

    launches = {"flagship": train_counts, "flagship_bp": bp_counts,
                "flagship_bf16": bf16_counts,
                "flagship_bp_bf16": bp_bf16_counts,
                "hcp": hcp_counts, "hcp_bf16": hcp16_counts,
                "flagship_defaults": defaults_counts,
                "flagship_disk": disk_counts, "hcp_disk": hcp_disk_counts,
                "dot_shapes": dot_counts, **struct_counts, **chain_counts,
                **phase2_counts, **outer_counts, **multi_counts,
                **export_counts}
    kernels = [results.line(key, launches) for key in ops.kernels()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


def _fusion_occupancy():
    """How the multi-window fusion forward and backward run on this card at
    the flagship's shapes: resident blocks an SM, windows in flight a block
    (forward: and subjects a work item), shared memory a block, blocks in
    the grid."""
    from multimodal_neuroimage_tpu_torch.ops import fusion_block as fb
    print("fusion forward occupancy (K2/K3 training forward, "
          "cudaOccupancyMaxActiveBlocksPerMultiprocessor):")
    for B in (4, 16, 64):
        for cross in (False, True):
            occ = fb.forward_occupancy(cross, B, 196, 36, 12, 6, 48)
            print(f"  K{3 if cross else 2}, B {B}: {occ['blocks_per_sm']} "
                  f"block(s) an SM, {occ['windows_per_block']} windows in "
                  f"flight a block, {occ['per_item']} subjects a work item, "
                  f"{occ['smem_bytes']} B of shared memory a block, "
                  f"{occ['grid_blocks']} blocks")
    print("fusion backward occupancy "
          "(cudaOccupancyMaxActiveBlocksPerMultiprocessor):")
    for label, entry, cross, dims in (
            ("K2 self, B 4", "fusion_block_backward", False, (4, 196)),
            ("K3 cross, B 4", "fusion_block_backward", True, (4, 196)),
            ("K2 self, B 16", "fusion_block_backward", False, (16, 196)),
            ("K3 cross, B 16", "fusion_block_backward", True, (16, 196)),
            ("K7 self, 2 groups of 8", "fusion_block_bp_backward", False,
             (2, 8, 196)),
            ("K7 cross, 2 groups of 8", "fusion_block_bp_backward", True,
             (2, 8, 196))):
        occ = fb.backward_occupancy(entry, cross, dims, 36, 12, 6, 48)
        print(f"  {label}: {occ['blocks_per_sm']} block(s) an SM, "
              f"{occ['windows_per_block']} windows in flight a block, "
              f"{occ['smem_bytes']} B of shared memory a block, "
              f"{occ['grid_blocks']} blocks")


def _ptxas_summary(log: str):
    """One line per compiled kernel: registers, shared memory, spills."""
    lines, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '_Z(\d+)(\w+)'", line)
        if m:
            n = int(m.group(1))
            rest = m.group(2)[n:]
            # integer template arguments, mangled as I (L <type> <value> E)+ E
            args = re.match(r"I((?:L[a-z]+-?\d+E)+)E", rest)
            name = m.group(2)[:n] + (
                "<" + ", ".join(re.findall(r"L[a-z]+(-?\d+)E", args.group(1)))
                + ">" if args else "")
        elif name and ("registers" in line or "spill" in line):
            lines.append(f"  {name}: {line.split(':', 1)[-1].strip()}")
    return lines


if __name__ == "__main__":
    sys.exit(main())
