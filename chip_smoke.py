#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pytorch_quantize_impls_tpu_torch``)
on one NVIDIA GPU (built for Hopper, sm_90a).

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi) and refuses to run
   without a CUDA device: there is no CPU fallback.
2. Builds every CUDA kernel from ``pytorch_quantize_impls_tpu_torch/csrc``
   with nvcc, one process per source, all at once.
3. Holds each kernel against its plain PyTorch version on the card, at the
   shapes the main paths give it and at edge shapes: K1 binary_gemm, K2
   decode_binary_weights, K3 int8_gemm, K5 int8_conv2d, K6 dorefa_gemm, K7
   decode_dorefa_weights, K10 binary_gemm_ws, K11 dorefa_gemm_ws and P1
   tiled_mm (int8, int4) bit for bit, K9 decode_log_weights bit for bit as
   int16 patterns, K4 decode_attention within a float32 tolerance, K8
   shift_gemm, K12 shift_gemm_ws and P1 tiled_mm (bf16) within 1e-5 of
   |bf16(x)| @ |w| per element and deterministic. K1, K3, K6 and K8 (the
   streamed tensor-core schedule of csrc/stream_tile.cuh) also run at
   4096^3 and, K6 and K8, the VGG head's shape, K1 and K3 the decode LM's
   four projections at M = 32 (timed beside their main rows), and at cases
   whose launch plan splits K (ragged last chunks, M = 1 and 65, N = 10,
   zeros, unaligned x), K6 also at the digits MLP's three layers at W1A2
   with the one-bit scale in its epilogue (b = 64 and 256); each check
   line shows the plan (BM, S), the main
   rows (and K1's and K3's M = 32 rows) the host's microseconds per call.
   K5 runs at the ResNet's block convs at b = 256 and b = 1 and shows its
   tile; its packed weight stage (int8_conv2d(..., w_bits=), the packed
   conv's fused route, which decodes K2's and K7's words inside K5) runs at
   the same convs, BNN LeNet's conv2 and K5's edges with 1-, 2- and 4-bit
   DoReFa, binary and xnor words, bit for bit against decode + the plain
   conv, and at the ResNet's and LeNet's own weights it is timed beside the
   two-launch route (K7 or K2, then the raw K5) by CUDA events and device
   time; its lines show the slab (packed groups, shared memory) and the
   route kernels/common.py conv_route picks. K5's threshold epilogue (the
   binary fused chains' boundary) runs on the raw tile and the packed stage
   at xnor_cifar's five hidden convs and LeNet's conv2 at b = 1 and 256 and
   at edges (odd cout; thresholds of -inf for gamma = 0, constant codes for
   alpha = 0, ties on the exact sums), bit for bit, and at conv3 is timed
   beside the scale epilogue plus a torch.where. K4 (one thread-block cluster
   per (b, h), split over the cache, csrc/decode_attention.cu) runs at the
   decode LM's five shapes and at edges (cl 1, 37, 300 and 8192, fully
   masked rows, head dims 16 to 256); its check lines show the plan
   (blocks per cluster C, rows per block, grid). Device times are read after every CUDA-event time (a
   torch.profiler session slows each later launch on the host), and then
   the launch floor: the device time of a one-element add. K10-K12
   run at the JAX tests' shapes, 4096^3, a served conv as im2col and edges
   (every m_tiles, all-zero activations, K off the 16-byte pitch; K11 there
   at 1, 2 and 4 bits), K10's lines with its tile (rows x columns); P1 at
   256x512x256 and 4096^3 over every tiling (every one of them runs on the
   TMA + wgmma tile of csrc/wgmma_tile.cuh: K12 and P1 bf16 on its bf16
   path; K10, K11 and P1 int8/int4 on its s8 path, K10 and K11 through the
   shared body of csrc/packed_ws.cuh). Prints kernel, plain, library-call and bound
   times; the bf16 GEMMs' (K8, K12, P1 bf16) library call is torch.mm of
   the bf16 operands with a float32 output, with cuBLAS's float32 and bf16
   matmuls beside it.
4. Main path 1, BNN LeNet (``bnn_lenet``, width 128) from seeded random
   weights: bridge -> pack_model -> save_packed -> load_packed ->
   InferenceEngine over the unprepared artifact (K1, K2, K5) -> prepare ->
   InferenceEngine over the prepared artifact (K2, K3, K5), from several
   client threads. Every answer is checked against packed_apply on its
   padded batch; unprepared, prepared and fake-quant agree exactly; a small
   input agrees with the CPU. K2 must have launched exactly for conv1's
   unprepared calls, conv2's calls on the two-launch route and prepare():
   a conv2 on the fused route launches no decoder. The route of every
   packed conv is printed at each bucket size (every one fused at b = 1).
   Then its fused chain: export_fused_lenet (float32 first conv) ->
   InferenceEngine.from_fused_chain, K5 (threshold) at conv2 and K3 at fc1
   once per forward, every batch replayed bit-equal, held against
   packed_apply by the JAX package's logit rule on grid images.
   Then training (path 10, after the fused chain): bnn_lenet built at
   width 128 on the card through build_model (weights drawn as flax draws
   them from the config's seed) and trained with train.make_train_step
   (fake-quant forward, float32 cross-entropy, STE backward, Adam, the
   clamp, BatchNorm in training mode) on the synthetic MNIST stand-in at
   batch 128. Its first three steps are held against a CPU copy, each from
   the card's state (free-running BNN trajectories part after one step
   from any float reassociation): the loss within 1e-5 relative; in every
   tensor, the entries outside tolerance, once its output channel that
   holds most of them is set aside (a sign that ties after BatchNorm),
   at most 0.1% of its entries, for its gradient (within GRAD_TOL of the
   tensor's max |g|), its parameters (within 1e-5) and its running
   statistics (within 1e-5 relative); the kernels in [-1, 1] on both. TF32
   in the conv backward must fail that gate at conv2, and the port pass it. Then to 1000 steps: the clamp
   and finite statistics every 100 steps, the mean loss of the last 100
   steps <= 0.8 x the first 100's, ms per step and images/s by CUDA events,
   a profile over 20 steps, no kernel of the port launched; a rerun from
   the same seed bit-equal at step 100. The trained model is served as
   path 1 is (every check of path 1; packed test accuracy equal to
   fake-quant's on the whole test split, test accuracy >= 0.2) and as its
   fused chain (JAX's logit rule). Then binaryconnect_mlp (784-512-512-10)
   and its float32 twin, 500 steps each (accuracies and Δacc reported),
   the quantized one served through InferenceEngine (K2 three times per
   forward on the real-input branch; packed bit-equal to fake-quant), and
   the stochastic MLP (bin_stoch) 50 steps three times from one init: the
   same generator seed twice bit-equal, another seed different.
   Then path 11, the CIFAR BASELINE configs (xnor_cifar, dorefa_resnet20
   with PACT and its alpha penalty, dorefa_resnet20_w4, logquant_vgg) at
   their published widths, built through build_model and trained through
   train.make_train_step on the synthetic CIFAR stand-in: card against CPU
   per step from the card's state at b = 32 (cut from 128 for the CPU's
   time), three steps of the quantized model and one of its twin, in
   float64 under the gate above (enforced) and in float32 (the shares
   reported: a ReLU mask, a PACT code or a sign at its boundary flips under
   another summation order and moves what follows it); then 160 steps at
   b = 128 (cosine, the config's elastic weight), the twin first and the
   quantized model warm-started from it where the config says so (the
   matched-entry count: every entry but PACT's alphas), the loss falls, the
   clamp and finite statistics every 50 steps, ms per step by CUDA events
   and a profile, steps 101-120 replayed from a snapshot bit for bit, no
   kernel launched; on the trained PACT ResNet every alpha moved and the
   penalty's part of its gradient is 2 lambda alpha, and one step with
   remat=True is bit-equal to remat=False with the statistics moved once.
   The trained weights are served: save_packed -> load_packed ->
   packed_apply over the whole test split unprepared and prepared, packed
   accuracy beside fake-quant's; xnor_cifar (K2, K5 with alpha, K1 in
   conv3's im2col check) by the JAX logit rule, then with the K map off and
   BatchNorm recalibrated as the fused chain (K5 threshold x4, affine x1 per
   forward), the float32 first conv held to the JAX rule and the bf16 first
   conv's agreement reported; the ResNets (K7 decoding every real-input
   block conv) each packed conv within 1e-5 of |x| conv |w_q| of its
   fake-quant forward on the same input, argmax on 99% of rows, and the
   rows within 5e-2 (enforced for W4, reported for W4A4: chaotic in code
   space); VGG (K9, K8 at the unprepared head) within 5e-2 + 5e-2 |ref|.
   Launches per path: xnor_cifar_trained(_fused), dorefa_resnet20_trained,
   dorefa_resnet20_w4_trained, logquant_vgg_trained.
   Then the 8-bit Adam path (phase ``bnn_lenet adam8``, after path 11):
   bnn_lenet (width 128) built on the card and trained with
   train.QuantizedAdam (int8/uint8 log codes per block of 256, float32
   absmax), the clamp and the cosine schedule. (a) One update from one
   state on the card and in a CPU copy from the card's gradients: each
   parameter tensor by the per-tensor gate above, each tensor's codes equal
   but for at most 0.1% off by one, the scales and the small tensors'
   float32 moments within 1e-6 relative. (b) To 300 steps at b = 128,
   checkpointing every 100 (utils.CheckpointManager, async): the loss falls,
   the clamp holds; the optimizer state is 10,221,548 bytes as the JAX
   package counts it; ms per step by CUDA events and a profile (busy, idle,
   launches) of the step and of the update alone, for QuantizedAdam and
   torch Adam. (c) ``python -m ...train.run --config bnn_lenet --steps 300
   --checkpoint-dir D --ckpt-every 100`` SIGKILLed right after its first
   finalized checkpoint and run again beside an uninterrupted run: the rerun
   prints ``resumed from step``, and the two final checkpoints are bit-equal
   tensor by tensor, Adam's state included. (d) A fresh QuantizedAdam state
   restored from (b)'s step-100 checkpoint and run to 200: bit-equal to (b)
   at 200, codes included. (e) (b)'s newest checkpoint truncated: restore()
   returns the one before it. (f) ``python -m ...infer.host_export`` with no
   card visible, on (c)'s final checkpoint, through the native codec
   (utils.native, g++): its artifact equals pack_model + save_packed of the
   same weights on the card in every array and record. (g) That artifact
   served as path 1 serves (load_packed on the card, InferenceEngine
   unprepared, prepare, prepared) on all 2560 test images, in rounds of 256
   requests (full batches; one request at a time the backlogged engine
   batches ~1 and the path took 108 s): packed == fake-quant bit for bit;
   launches ``bnn_lenet_exported`` (K1, K2, K3, K5).
   Then the digits MLPs (phase ``digits g6 + elastic train``, after the
   8-bit Adam): ``dorefa_digits_g6`` (W1A2G6) and ``elastic_digits`` (the
   binary grid's penalty, lambda ramped to 100) at 64-512-512-10, b = 64,
   built through build_model on the card and trained on the port's
   synthetic stand-in of the digits (data.synthetic_digits: the card's
   machine has no sklearn). After 3 warm steps on the card (every
   BatchNorm bias off 0: one-bit weights times 2-bit codes tie BatchNorm
   inputs with their batch mean, and at a bias of 0 the ReLU reads a
   rounding residue), 2 steps card against CPU under path 10's per-tensor
   gate, for the W1A2 MLP with G0 and the elastic MLP under its ramp;
   dorefa_gradient's backward on a shared u at the MLP's input shapes,
   card == CPU bit for bit; 300 steps each (the task loss, the loss less
   the weighted penalty, falls to <= 0.8 x; the clamp), the G6 run twice
   from one seed bit-equal and once from another generator seed
   different; elastic_digits hard-projected (train.accuracy_sweep.
   project_elastic: every kernel entry +-its channel's alpha). The trained
   G6 model served packed through InferenceEngine, its records carrying
   E|W|: unprepared (K6 exactly 3 per forward), prepare() (K7 3),
   prepared (K3 3 per forward); every batch replayed bit-equal; each
   layer within 1e-5 (1 + |ref|) of its fake-quant forward on the same
   input, the argmax >= 99% on the test split, the 2-bit codes that flip
   reported; launches ``digits_g6_trained``.
   Then the XNOR digits convnets and bnn_lenet_as (phase ``xnor digits +
   bnn_lenet_as``): xnor_digits (binary weights, real activations, widths
   32, 64) and xnor_digits_a1 (full XNOR with the K map, widths 128, 128) on
   the synthetic digits as 8x8x1 images at b = 64, and bnn_lenet_as (the
   learnable per-input-channel scale g on every binarized input, width 128)
   on the synthetic MNIST at b = 128, built through build_model on the card.
   Card against CPU per step (3 steps after 3 warm ones; bnn_lenet_as after
   20, so that every g has left 1) under path 10's gate in float32, and
   where float32 fails it (a sign or a pool tie at its boundary, summed in
   another order) in float64 from the same weights, gated, the float32
   shares reported; nn.ShiftNormBatch (the BNN paper's power-of-two
   BatchNorm) train forward and backward and eval forward card against CPU,
   its AP2 scales bit-equal; 300 steps each (the loss falls, the clamp), the
   XNOR pair's float32 twins too (Δacc reported), a rerun from the same seed
   bit-equal at step 100, no kernel launched by training; every trained
   act_scale finite and moved from 1. The XNOR pair served: save_packed ->
   load_packed -> InferenceEngine over the unprepared and the prepared
   artifact from 4 clients, every batch replayed bit-equal, packed against
   fake-quant by the JAX rule on the whole test split, launches exact:
   ``xnor_digits_trained`` K2 once per unprepared forward (conv1 takes real
   inputs: K2 + cuDNN + alpha) and once in prepare(); ``xnor_digits_a1_
   trained`` K5 once per forward (the fused route or K2 + the raw K5, as
   conv_route picks), K2 in prepare() and conv1's check (direct == fused K5
   == K2 + raw K5 == im2col through K1 with alpha, bit for bit).
   bnn_lenet_as served through InferenceEngine over its fake-quant forward
   (``bnn_lenet_as_served``: no launch, every batch bit-equal to the model),
   and pack_model, the host export, export_fused_lenet and packed_apply all
   refuse it (ValueError naming act_scale: its packed forms would drop g).
   K5 is checked at xnor_digits_a1's conv1 (b = 1, 64, 256, the packed
   weight stage and the raw tile) and K2 at both digits convs' words, bit
   for bit, beside their main rows.
   Then the compute dtype (phase ``bf16 compute``, bf16_path) and the
   switch-routed MoE FFN (phase ``moe LM``, moe_lm_path): nn.QuantMoE of
   every expert scheme card against CPU at capacity factors 2, 1 and 1e-9
   (routing and keep masks equal, outputs, aux losses and gradients within
   tolerance); the serving LM's shape with 8 binary experts per block
   (capacity factor 2, ~2.1 GB of expert masters built once) through
   DecodeEngine fake-quant, packed unprepared (K1 on the attention
   projections, exactly 32 per forward) and prepared (K2 32 in prepare(),
   K3 32 per forward), the experts fake-quant, as in the JAX package;
   every engine's batches replayed through the next backend bit for bit;
   prepared against fake-quant in lockstep (argmax >= 99%); prefill ms,
   ms per step and tok/s at b = 1, 8, 32 with profiles; then a 2-layer
   MoE LM (d 256, 8 experts) trained on a seeded next-token task: card
   against CPU for one step under path 10's gate on its float twin (the
   binary experts' shares reported), 20 steps with the clamp on the expert
   kernels and not on the router, the loss falling, no kernel launched.
5. Main path 2, the 1-bit transformer LM that scripts/perf_bench.py serves
   (d 1024, 8 layers, cache 1024, W1A1, int8 KV) from seeded random weights:
   bridge -> export_fused_decode (int8 and packed) -> DecodeEngine(fused=)
   with 32 slots, 64 requests from 4 client threads (K4, K3, K1). Every
   batch the engines ran is replayed through fused_decode_apply of the other
   export and must give the same bits, tokens and final cache; the fused
   step is held against the fake-quant decode model, teacher-forced; at the
   JAX tests' size the two agree token for token.
6. Main path 3, the DoReFa ResNet-20 W4A4 at width 64 (scripts/perf_bench.py
   :211-213, fixed clip) from seeded weights with BatchNorm statistics
   calibrated on seeded images (the codes of each stage's input must spread
   over [0, 15]): pack_model -> save_packed -> load_packed ->
   InferenceEngine over the unprepared and the prepared artifact (K7, K5),
   then export_fused_resnet20 -> InferenceEngine.from_fused_resnet (K5).
   Every batch is replayed bit-equal (unprepared == prepared); direct by
   both routes == im2col (K6) at the stride-2 stage-1 conv; packed and
   fused agree with fake-quant (argmax, logit gap within RESNET_LOGIT_TOL)
   and with the CPU. K7 must have launched exactly for the block convs on
   the two-launch route and prepare() (the parent launched it for every
   conv call); the routes are printed as for LeNet.
7. Main path 4, the serving LM's shape with DoReFa W4A4: DecodeEngine(
   packed=) over the unprepared records (K6), then prepare() (K7) and the
   prepared records (K3); the same tokens for every request, and
   teacher-forced argmax against the fake-quant model.
8. Main path 5, the log-quant VGG-small (``logquant_vgg``, widths
   128..512, W4 log, fsr 1) from build_model with seeded weights and
   BatchNorm calibrated on seeded images: pack_model -> save_packed ->
   load_packed -> InferenceEngine over the unprepared records (K9 at every
   conv call, K8 at the head), then prepare() (K9) and the prepared records
   (no K8). Every batch is replayed bit-equal; packed against fake-quant
   (argmax, logits within the JAX seam tolerance), unprepared against
   prepared (the head's bf16 input rounding), direct (K9 + conv) against
   im2col (K8) at conv3, card against CPU.
9. Main path 6, the serving LM's shape with W4 log weights (fsr 0):
   DecodeEngine(packed=) over the unprepared records (K8 on every
   projection), then prepare() (K9) and the prepared records; each packed
   projection held to its fake-quant GEMM on the same input, and
   teacher-forced argmax against the fake-quant model.
10. Main path 7, xnor_cifar (BASELINE config 3: XNORConvNet, widths 128..512,
    full XNOR, K map on) from build_model with seeded weights and BatchNorm
    calibrated on seeded images (every conv input's share of +1 in [0.05,
    0.95]): pack_model -> save_packed -> load_packed -> InferenceEngine over
    the unprepared artifact (K2 for conv0 and the head, K5 with alpha for the
    hidden convs) -> prepare -> the prepared artifact, 64 requests from 4
    clients. Every batch replayed bit-equal, unprepared == prepared; conv3
    direct by both routes == im2col (K1 with alpha); packed against
    fake-quant by the JAX rule; card against CPU layer by layer. K2 must
    launch exactly for conv0 and the head on unprepared calls, the hidden
    convs on the two-launch route and prepare().
11. Main path 8, the same weights in XNORConvNet(use_input_scale_map=False)
    -> export_fused_chain (float32 first conv) -> InferenceEngine.
    from_fused_chain: K5 five times per forward (four threshold, one
    affine), batches replayed bit-equal, every stage's share of +1 codes in
    [0.05, 0.95], fused against packed_apply of the K-off model by the JAX
    rule (the bf16 first conv's agreement printed beside it); images/s per
    bucket and profiles of the packed, prepared, fused and fake-quant
    xnor_cifar.
12. Main path 9, the serving LM's shape with ternary weights through
    DecodeEngine(packed=) unprepared and prepared: the same tokens, no kernel
    launched (the ternary decode is plain, as in the JAX package), each
    projection within 1e-5 (|x| @ |w|) of its fake-quant GEMM,
    teacher-forced argmax >= 99%.
13. Path 10, the headline GEMM bench at 4096^3 (bench.headline.run, the
    counterpart of bench.py): binary fused (K1), binary ws (K10), binary
    decoded (K2 once, K3), dorefa4 packed (K6) and log shift (K8) against a
    float32 matmul with TF32 off; prints its JSON line.
14. Path 11, the kernel bench (bench.kernel_bench.run) of binary_ws,
    dorefa_ws and shift_ws at 4096^3 over every m_tiles (K10, K11, K12).
15. Path 12, the dtype probe (bench.mxu_probe.run): P1 at 4096^3 for bf16,
    int8 and int4 over every tiling, beside torch.matmul and torch._int_mm;
    prints its launches by dtype.
16. For each path the kernels' launch counters are zeroed just before it
    and read just after; each kernel of the path must be > 0 (the trained
    paths: bnn_lenet_trained, bnn_lenet_trained_fused, bc_mlp_trained,
    bnn_lenet_exported, digits_g6_trained, xnor_digits_trained,
    xnor_digits_a1_trained; the MoE LM's moe_lm_unprepared and
    moe_lm_prepared; bnn_lenet_as_served, moe_lm_fake_quant and
    moe_lm_train launch none).
17. Prints engine images/s, decode prefill ms and tokens/s, one JSON line
    with the kernels and their launches per path, and last
    ``{"ok": true, "device": {...}}``.

Exits non-zero, without the last line, if any phase fails.
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

# the GEMM measurements' M = N = K and the card's published peak rates
from pytorch_quantize_impls_tpu_torch.bench.common import (
    BF16_FLOPS_PER_S, F32_FLOPS_PER_S, HBM_BYTES_PER_S, INT8_OPS_PER_S)
from pytorch_quantize_impls_tpu_torch.bench.common import SHAPE as HEADLINE_SHAPE

SEED = 0
WIDTH = 128
BUCKETS = (1, 4, 16, 64, 256)
CLIENTS = 4
REQUESTS_PER_CLIENT = 24
SMALL_M = (1, 16, 256)
PORT = "pytorch_quantize_impls_tpu_torch"

# the serving LM of scripts/perf_bench.py:273-276
LM_CFG = dict(vocab=8192, d_model=1024, n_heads=8, n_layers=8, d_ff=4096, max_len=1024,
              scheme="binary", w_bits=1, a_bits=1, kv_bits=8)
# the JAX package's fused-decode test model, tests/test_fused_decode.py:22-28
SMALL_LM_CFG = dict(vocab=128, d_model=64, n_heads=4, n_layers=2, d_ff=128, max_len=64,
                    scheme="binary", w_bits=1, a_bits=1)
SLOTS = 32
DECODE_REQUESTS = 64
PROMPT_LENS = (16, 128)
MAX_NEW = 32
DECODE_BATCHES = (1, 8, 32)
PREFILL_LEN = 128
# Logits of the fused step against the fake-quant model where no ±1 code
# differs: the JAX package's own tolerance for this seam
# (tests/test_fused_decode.py:47); only LayerNorm statistics and the f32 head
# differ in summation order there.
LOGIT_TOL = 2e-4

# the production-width DoReFa ResNet-20 of scripts/perf_bench.py:211-213,
# W4A4 with the fixed [0, 1] clip, on CIFAR-10-shaped images
RESNET_WIDTH = 64
RESNET_SHAPE = (32, 32, 3)
RESNET_BATCH = BUCKETS[-1]
RESNET_CALIB = 256  # images whose statistics set every BatchNorm's
RESNET_EVAL = 512  # rows held against the fake-quant forward
RESNET_IM2COL_BATCH = 16
# Packed and fused logits against the fake-quant forward (and card against
# CPU). The block convs' k-bit grid amplifies float rounding: where a float32
# sum lands within an ulp of a .5 code boundary, the two paths round it to
# neighbouring codes, and such flips cascade through the later convs, so
# logits differ by about 1e-2 (on logits of std ~0.3) even where every
# integer is exact; against_fake_quant prints the spread. The JAX package
# holds this seam to 5e-2 (tests/test_infer.py:47): 99% of rows must be
# within it, and argmax must agree on 99% of rows.
RESNET_LOGIT_TOL = 5e-2
# The serving LM's shape, W4A4 DoReFa (scheme="dorefa"), served packed
W4A4_LM_CFG = dict(LM_CFG, scheme="dorefa", w_bits=4, a_bits=4)
# A packed projection against its fake-quant GEMM on the same input: the
# float32 sum of up to 4096 products of the fake-quant GEMM, in another order
# than the exact integer sum, is off by some tens of ulps of its largest
# output; this allows ~800 (2^-13)
W4A4_GEMM_RTOL = 1e-4
# End-to-end argmax of the W4A4 LM in lockstep: see lm_teacher_forced
W4A4_ARGMAX_FLOOR = 0.85

# BASELINE config 5, logquant_vgg (utils/config.py): VGG-small at its
# published widths 128/128/256/256/512/512, W4 log weights, fsr 1, on
# CIFAR-10-shaped images; its head is 8192 -> 10
VGG_CALIB = 256  # images whose statistics set every BatchNorm's
VGG_EVAL = 512  # rows held against the fake-quant forward
VGG_IM2COL_BATCH = 8  # conv3 as im2col: M 2048, K 2304, N 256
# Packed against fake-quant logits (and card against CPU): the JAX package's
# tolerance for this seam, tests/test_infer.py:50-52 (atol 5e-2, rtol 5e-2).
# The unprepared head rounds its input to bf16 (2^-9 relative) and the
# float32 sums run in another order; 99% of rows must have every logit
# within it, and argmax must agree on 99% of rows.
VGG_LOGIT_ATOL = VGG_LOGIT_RTOL = 5e-2
# K8 against its plain version: |K8 - plain| <= rtol * (|bf16(x)| @ |w|) per
# element, the JAX test's rtol (tests/test_kernels.py:162): the products are
# exact, only the order of the float32 sum differs
SHIFT_RTOL = 1e-5
# Rounding a value to bf16 moves it by at most 2^-9 of itself; an output of
# the unprepared (bf16 x) and the prepared (float32 x) path then differs by at
# most 2^-9 (|x| @ |w|) plus float32 sums: hazard bound 2^-8, plus SHIFT_RTOL
BF16_INPUT_RTOL = 2.0**-8
# The serving LM's shape with W4 log weights (weights only: a_bits 0), levels
# 2^-16 .. 2^0 (fsr 0); served packed through DecodeEngine(packed=)
LOG_LM_CFG = dict(LM_CFG, scheme="log", w_bits=4, a_bits=0, fsr=0.0)
# End-to-end argmax of the log LM in lockstep: no activation is quantized, so
# the prepared path (float32 x, the same weights) differs from fake-quant by
# float32 sum order only; the unprepared one also rounds every projection
# input to bf16
LOG_ARGMAX_FLOOR = {"prepared": 0.99, "unprepared": 0.95}
# BASELINE config 3, xnor_cifar (utils/config.py): the XNOR convnet at its
# published widths, full XNOR with the K map, on CIFAR-10-shaped images
XNOR_WIDTHS = (128, 128, 256, 256, 512, 512)
XNOR_CALIB = 256  # images whose statistics set every BatchNorm's
XNOR_EVAL = 256  # rows held against fake-quant, and fused against packed
XNOR_IM2COL_BATCH = 8  # conv3 as im2col: M 2048, K 2304, N 256
XNOR_REQUESTS = 64  # served by each xnor_cifar engine, from CLIENTS threads
# Whole binary models by the JAX package's rule (tests/test_fused_chain.py:
# 47-68): every logit within LOGIT_TOL + LOGIT_TOL |ref|, or else at least
# 99% of them and every argmax equal. A value within an ulp of a sign
# boundary, computed in another float order (the fused chain's threshold
# against BatchNorm, a real-input conv), flips one code and moves that
# image's logits.
XNOR_MIN_WITHIN = 0.99
# each binarized activation's share of +1: BatchNorm statistics calibrated
# on seeded images keep every stage away from saturation
CODE_SHARE = (0.05, 0.95)
# the serving LM's shape with ternary weights (deterministic, weights only);
# the records carry the LM's w_bits (1) as the JAX package writes them
TERNARY_LM_CFG = dict(LM_CFG, scheme="ternary", a_bits=0)
TERNARY_REQUESTS = 16
# a ternary projection against its fake-quant GEMM: the same float32 x and
# {-1, 0, 1} weights, summed in another order
TERNARY_RTOL = 1e-5
TERNARY_ARGMAX_FLOOR = 0.99


# path 10: BNN LeNet and the BinaryConnect MLP trained on the card
TRAIN_BATCH = 128
TRAIN_CHECKED_STEPS = 3  # card against CPU, each from the card's state
TRAIN_STEPS = 1000  # the bnn_lenet run on the card
TRAIN_WINDOW = 100  # loss windows, clamp checks
TRAIN_TOL = 1e-5  # card against CPU: parameters absolute, statistics times 1 + |ref|
# card against CPU: gradient entries, times the tensor's max |g|. cuDNN's
# float32 weight gradient at conv2's shape lands up to ~2e-5 of it off the
# CPU's sum; TF32 ~4e-4 (PERF.md, PR 15)
GRAD_TOL = 5e-5
NOISE_GRAD = 1e-6  # |g| at or below this is the rounding noise of a zero gradient
TRAIN_MIN_WITHIN = 0.999
TRAIN_LOSS_DROP = 0.8  # mean loss of the last window / the first
TRAIN_MIN_ACC = 0.2  # held-out accuracy, twice chance
RERUN_STEPS = 100  # the second run from the same seed, bit for bit
MLP_STEPS = 500  # binaryconnect_mlp and its twin
STOCH_STEPS = 50
MLP_TOL = 1e-5  # packed (K2 + cuBLAS) against fake-quant logits, times 1 + |ref|

# path 11: the CIFAR BASELINE configs trained on the card
CIFAR_CONFIGS = ("xnor_cifar", "dorefa_resnet20", "dorefa_resnet20_w4", "logquant_vgg")
CIFAR_CHECK_BATCH = 32  # card against CPU: cut from 128 for the CPU's time at full width
CIFAR_CHECKED_STEPS = 3  # card against CPU, each from the card's state
# each cut training run (the configs' budgets: 2000-12000), cut from 200 to keep the
# whole run's length as phases were added
CIFAR_STEPS = 160
CIFAR_WINDOW = 50  # loss windows, clamp checks
CIFAR_RERUN_FROM = 100  # the snapshot the replay starts from
CIFAR_RERUN_STEPS = 20
# the 8-bit Adam path (PR 18): bnn_lenet with train.QuantizedAdam
ADAM8_STEPS = 300  # cosine over these; the config's budget is 12000
ADAM8_WINDOW = 50  # loss windows, clamp checks; torch Adam's timed steps
ADAM8_SAVE_EVERY = 100  # in-process checkpoints
ADAM8_RESUME_TO = 200  # restored at ADAM8_SAVE_EVERY, run to here, against the run
ADAM8_STATE_BYTES = 10_221_548  # JAX's count: codes, scales, small moments, the count
ADAM8_CODE_SHARE = 1e-3  # card vs CPU: a tensor's codes off by one (log2's rounding)
ADAM8_RTOL = 1e-6  # card vs CPU: scales, small moments; host vs card: alpha
KILL_STEPS = 300  # train.run killed after its first checkpoint, then resumed
KILL_EVERY = 100
KILL_WAIT_S = 300
# the digits MLPs: DoReFa W1A2G6 and the elastic scheme at 64-512-512-10
DIGITS_STEPS = 300  # each run, cosine over these; the configs' budgets: 1600, 3200
DIGITS_WINDOW = 50  # loss windows, clamp checks
DIGITS_WARM = 3  # steps on the card before card vs CPU: every BatchNorm bias off 0
DIGITS_CHECKED_STEPS = 2  # card against CPU, each from the card's state
DIGITS_OTHER_SEED_STEPS = 50  # a G6 run from another generator seed
DIGITS_TOL = 1e-5  # packed against fake-quant, per layer, times 1 + |ref|
DIGITS_ARGMAX_FLOOR = 0.99
# the XNOR digits convnets and bnn_lenet_as
XD_SHAPE = (8, 8, 1)  # the digits as images
XD_STEPS = 300  # each run and twin, cosine over DIGITS_STEPS; the budgets: 1600, 12000
XD_LENET_WARM = 20  # steps on the card before card vs CPU: every g off 1
XD_CHECKED_STEPS = 3  # card against CPU, each from the card's state
XD_RERUN_STEPS = 100  # a second run from the same seed, bit for bit at this step
XD_IM2COL_BATCH = 8  # xnor_digits_a1's conv1 as im2col: M 512, K 1152, N 128
XD_SNB_SHAPE = (TRAIN_BATCH, 8 * WIDTH)  # ShiftNormBatch: bn3's input at width 128
XD_AP2_MARGIN = 1e-4  # AP2 scales this far (in log2) from a rounding point must agree
XD_CONV = (8, 128, 128)  # xnor_digits_a1's conv1: input side, cin, cout (3x3 SAME)
# path 13: the compute dtype (bf16 compute, float32 masters)
BF16_STEPS = 200  # bnn_lenet at width 128 with dtype=torch.bfloat16; rerun at RERUN_STEPS
# card against CPU per bf16 step: every gradient and cotangent is rounded to bf16
# (2^-9 relative) at each layer, in another order on each device; the port's CPU
# step against JAX's lands within 2^-6.2 of a tensor's max |g| (PERF.md section 2)
BF16_GRAD_TOL = 2.0 ** -5
BF16_LOSS_RTOL = 1e-3  # the loss of bf16 logits, some a bf16 ulp apart
BF16_EVAL = 1024  # test images: packed bit-equal to fake-quant
BF16_LM_REQUESTS = 16  # per DecodeEngine(packed=) of the bf16 W1A1 LM
BF16_LM_ARGMAX_FLOOR = 0.99
BF16_RESNET_B1_ROWS = 32  # ResNet rows at b=1; RESNET_EVAL at b=RESNET_BATCH
BF16_CIFAR_STEPS = (20, 20)  # xnor_cifar bf16 at b=128: untimed, then timed by events
# path 14: the switch-routed MoE FFN (nn.QuantMoE) in the LM
MOE_LM_CFG = dict(LM_CFG, n_experts=8, capacity_factor=2.0)  # the JAX LM's default factor
MOE_REQUESTS = 32  # per DecodeEngine of the MoE LM, from CLIENTS threads
MOE_ARGMAX_FLOOR = 0.99  # packed against fake-quant in lockstep, as the W1A1 LM phase
MOE_LAYER = (64, 4, 128, 256)  # the layer card against CPU: d, E, d_ff, tokens
MOE_LAYER_SCHEMES = {"binary": {}, "ternary": {}, "dorefa": dict(w_bits=4),
                     "log": dict(w_bits=4), "lin": dict(w_bits=4, fsr=1.0), "none": {}}
MOE_LAYER_FACTORS = (2.0, 1.0, 1e-9)
MOE_TOL = 1e-5  # the layer card against CPU, times 1 + the magnitude of the sums
# the MoE LM trained on the card: 2 layers at d 256, BinaryConnect weights and real
# activations, on a next-token task; its card-vs-CPU step is gated in float64
MOE_TRAIN_CFG = dict(vocab=512, d_model=256, n_heads=8, n_layers=2, d_ff=1024, max_len=128,
                     scheme="binary", w_bits=1, a_bits=0, n_experts=8, capacity_factor=2.0)
MOE_TRAIN_BATCH = 16
MOE_TRAIN_STEPS = (5, 15)  # untimed, then timed by CUDA events
MOE_ELASTIC = 0.01  # the weight of the aux losses in the train loss
# path 15: serving over a (data, model) mesh on torch.distributed (a world of one NCCL rank)
MESH_REQUESTS = 32  # per DecodeEngine of the serving LM, with and without the mesh
MESH_MAX_NEW = 16
MESH_TP = (2, 4, 8)  # emulated model ranks: the LM's dense records cut into column shards
MESH_LENET_INPUTS = 512  # bnn_lenet requests per engine: two full rounds of 256
MESH_MOE_LAYER = (1024, 8, 4096, 256)  # the MoE LM's layer: d, E, d_ff, tokens
# the MoE layer's schemes and one-bit DoReFa, whose E|W| is the other statistic of the stack
MESH_MOE_SCHEMES = tuple(MOE_LAYER_SCHEMES.items()) + (("dorefa", dict(w_bits=1)),)
MESH_TP_TOKENS = (4, 64)  # the serving LM through packed_apply(tp_group=) on the NCCL mesh
MESH_GROUP_TIMEOUT_S = 120
MESH_PHASE_S = 60  # the phase's budget


def cuda():
    """The card this script runs on."""
    import torch

    return torch.device("cuda", 0)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        fail(f"nvidia-smi exited {out.returncode}: {out.stderr.strip()}")
    return out.stdout.strip()


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Time of ``fn`` per call on the card, by CUDA events over ``iters``
    back-to-back calls (wrapper overhead included): the median of three
    such runs, so that one stalled by the shared host's load does not set
    it."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        runs.append(start.elapsed_time(end) / iters)
    return sorted(runs)[len(runs) // 2]


def host_us(fn, calls: int = 2000) -> float:
    """Host time per call of ``fn`` in microseconds, by the CPU clock over
    ``calls`` back-to-back calls (the wrapper's checks, allocation and
    launch); the card runs behind and is synchronized after the clock
    stops."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e6 * (t1 - t0) / calls


# the CUDA function each wrapper launches, as torch.profiler names it: a
# substring of the name, so binary_gemm's, dorefa_gemm's and shift_gemm's
# second pass over a split K (*_kernel_sum) counts with them
KERNEL_SYMBOLS = {
    "binary_gemm": "binary_gemm_kernel", "decode_binary_weights": "decode_binary_kernel",
    "int8_gemm": "int8_gemm_kernel", "decode_attention": "decode_attention_kernel",
    "int8_conv2d": "int8_conv_kernel", "dorefa_gemm": "dorefa_gemm_kernel",
    "decode_dorefa_weights": "decode_dorefa_kernel", "shift_gemm": "shift_gemm_kernel",
    "decode_log_weights": "decode_log_kernel", "binary_gemm_ws": "binary_gemm_ws_kernel",
    "dorefa_gemm_ws": "dorefa_gemm_ws_kernel", "shift_gemm_ws": "shift_gemm_ws_kernel",
    "tiled_mm": "tiled_mm_kernel",
}


def device_times(fn, iters: int = 20):
    """Run ``fn`` ``iters`` times under torch.profiler (CUDA activity);
    returns ({kernel name: (device ms, launches) per call}, wall ms per
    call). Device times carry no host time; the wall clock ends in a
    synchronize."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0) / iters
    per_call = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", 0.0)
        if us > 0:
            ms, n = per_call.get(e.key, (0.0, 0.0))
            per_call[e.key] = (ms + us / 1e3 / iters, n + e.count / iters)
    return per_call, wall


def profile_line(fn, unit: str, iters: int) -> str:
    """torch.profiler over ``iters`` calls of ``fn``: wall and device-busy
    ms per call, the idle share, launches, and the four largest kernels."""
    per_call, wall = device_times(fn, iters=iters)
    if not per_call:  # the profiler once saw no device activity at all: try again
        per_call, wall = device_times(fn, iters=iters)
    if not per_call:
        return f"profile: wall {wall:.3f} ms/{unit}; device time not measured (no device events)"
    busy = sum(ms for ms, _ in per_call.values())
    launches = sum(n for _, n in per_call.values())
    top = sorted(per_call.items(), key=lambda kv: -kv[1][0])[:4]
    return (f"profile: wall {wall:.3f} ms/{unit}, device busy {busy:.3f} ms "
            f"({100 * (1 - busy / wall):.1f}% idle) in {launches:.0f} launches; largest: "
            + "; ".join(f"{k[:48]} {ms:.3f} ms x{n:.0f}" for k, (ms, n) in top))


def kernel_device_ms(fn, kernel: str):
    """Device time per call of the kernel that ``kernel``'s wrapper
    launches, or None if the profiler saw no device time for it."""
    per_call, _ = device_times(fn)
    got = [ms for name, (ms, _) in per_call.items() if KERNEL_SYMBOLS[kernel] in name]
    return sum(got) if got else None


def launches_device_ms(fn):
    """Device time per call of every kernel ``fn`` launches, or None if the
    profiler saw none."""
    per_call, _ = device_times(fn)
    return sum(ms for ms, _ in per_call.values()) if per_call else None


def bound_ms(nbytes: float, ops: float, ops_per_s: float):
    """(least time in ms, what sets it): bytes over the memory rate or
    operations over the peak rate for their type, whichever is larger."""
    t_bytes, t_ops = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / ops_per_s
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --- kernels vs plain versions ---------------------------------------------


def gemm_bound(m, k, n, w_bytes, scales):
    """K1/K3: x (M,K) int8 + weights + out (M,N) f32 (+ scales) once each;
    2*M*K*N int8 operations."""
    return bound_ms(m * k + w_bytes + 4 * m * n + scales, 2 * m * k * n, INT8_OPS_PER_S)


def code_bytes(k, n, bits):
    """The bytes of a (K, N) weight at ``bits`` per entry, without the
    packed layout's padding of K to its group (the function needs K rows)."""
    return -(-k * bits // 8) * n


def attention_bound(b, h, cl, hd, lens):
    """K4: what these inputs need: q, the mask row and the output once, and
    the K/V codes and scales of the attended positions only (the kernel
    skips masked ones); 4 flops per attended code pair element."""
    valid = int(np.sum(lens)) * h
    nbytes = 4 * b * h * hd * 2 + 4 * b * cl + valid * (2 * hd + 8)
    return bound_ms(nbytes, 4 * valid * hd, F32_FLOPS_PER_S)


def int8_gemm_case(label, xi, wi, alpha, row, main, lib, also=False):
    """A K3 check: int8_gemm against its plain version, ``torch._int_mm``
    as the library call where it runs (no scales, its shape rules), the
    launch plan (BM, S) of ``stream_plan``; ``also`` rows are timed beside
    the main row (the M=32 ones with the host's us per call)."""
    import torch

    from pytorch_quantize_impls_tpu_torch.kernels import int8_matmul as im
    from pytorch_quantize_impls_tpu_torch.kernels.common import stream_plan

    (m, k), n = xi.shape, wi.shape[1]
    nscale = 4 * ((0 if alpha is None else n) + (0 if row is None else m))
    plan = stream_plan(m, n, k, im.STAGE_K)[:2]
    return dict(
        kernel="int8_gemm", label=label,
        fn=lambda: im.int8_gemm(xi, wi, alpha, row),
        plain=lambda: im.int8_gemm_reference(xi, wi, alpha, row),
        library=(lambda: torch._int_mm(xi, wi)) if lib else None,
        bound=gemm_bound(m, k, n, k * n, nscale), main=main, plan=plan,
        split=label.startswith("edge"),
        also=also, host=main or (also and m <= 32),
    )


def kernel_cases(rng, dev):
    """Every comparison: dicts with the kernel, a label, the kernel call, its
    plain version, the library call (or None), the bound and whether it is
    the main-path shape reported in the JSON line."""
    import torch

    from pytorch_quantize_impls_tpu_torch.kernels import decode_attention as da
    from pytorch_quantize_impls_tpu_torch.kernels import xnor_gemm as bg
    from pytorch_quantize_impls_tpu_torch.kernels.common import attention_plan, stream_plan

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def pm1(m, k):  # binarized activations
        return bg.binarize_to_int8(t(rng.normal(size=(m, k)).astype(np.float32)))

    def packed(k, n):
        return bg.pack_binary_weights(t(rng.normal(size=(k, n)).astype(np.float32)))

    def scales(m, n, use_alpha, use_row):
        alpha = t(rng.uniform(0.5, 1.5, n).astype(np.float32)) if use_alpha else None
        row = t(rng.uniform(0.5, 1.5, m).astype(np.float32)) if use_row else None
        return alpha, row

    def int_mm(m, k, n):
        """torch._int_mm takes M > 16 and K, N multiples of 8."""
        return m > 16 and k % 8 == 0 and n % 8 == 0

    cases = []
    # K2 at every layer's packed shape, and K = 2304 (decode once dropped the
    # last partial K tile there)
    for label, (k, n) in {
        "conv1 (32,128)": (25, 128), "conv2 (128,256)": (3200, 256),
        "fc1 (128,1024)": (4096, 1024), "head (32,10)": (1024, 10),
        "K=2304 (96,256)": (2304, 256), "headline (128,4096)": (HEADLINE_SHAPE, HEADLINE_SHAPE),
    }.items():
        wp = packed(k, n)
        cases.append(dict(
            kernel="decode_binary_weights", label=label,
            fn=lambda wp=wp: bg.decode_binary_weights(wp),
            plain=lambda wp=wp: bg.decode_binary_weights_reference(wp),
            library=None, bound=bound_ms(code_bytes(k, n, 1) + k * n, 0, INT8_OPS_PER_S),
            main=label.startswith("conv2"),
        ))
    # K1 and K3 at LeNet's fc1/head with M in SMALL_M and at the decode LM's
    # four projections (no scales: the binary scheme)
    gemm_shapes = [(f"{name} M={m}", m, k, n, False, False)
                   for name, k, n in (("fc1", 4096, 1024), ("head", 1024, 10))
                   for m in SMALL_M]
    gemm_shapes += [(f"lm {name} M={m}", m, k, n, False, False)
                    for name, k, n, ms in (
                        ("qkv", 1024, 3072, (1, 32)), ("out", 1024, 1024, (32,)),
                        ("ffn_in", 1024, 4096, (32,)), ("ffn_out", 4096, 1024, (1, 32)))
                    for m in ms]
    # edges: odd M, N=10 and odd N, un-padded K, K % 4 != 0, scales on/off;
    # every one of them splits K (S 2 to 9, ragged last chunks)
    gemm_shapes += [
        ("edge M=33 K=300 N=130 alpha+row", 33, 300, 130, True, True),
        ("edge M=255 K=2100 N=257 alpha", 255, 2100, 257, True, False),
        ("edge M=1 K=1000 N=10 row", 1, 1000, 10, False, True),
        ("edge M=17 K=301 N=64 alpha+row", 17, 301, 64, True, True),
    ]
    def binary_case(label, m, k, n, ua, ur, main=False, also=False, zeros=False):
        """A K1 check: binary_gemm against its plain version, torch._int_mm
        on K2's decoded weights as the library call where it runs (no
        scales, its shape rules), the launch plan (BM, S) of stream_plan;
        ``also`` rows are timed beside the main row (the M=32 ones with the
        host's us per call)."""
        x = pm1(m, k)
        if zeros:  # as in padding
            x = x * t(rng.integers(0, 2, size=(m, k)).astype(np.int8))
        wp = packed(k, n)
        alpha, row = scales(m, n, ua, ur)
        nscale = 4 * ((n if ua else 0) + (m if ur else 0))
        lib = int_mm(m, k, n) and not (ua or ur)
        w8 = bg.decode_binary_weights(wp)[:k].contiguous() if lib else None
        return dict(
            kernel="binary_gemm", label=label,
            fn=lambda x=x, wp=wp, a=alpha, r=row: bg.binary_gemm(x, wp, a, r),
            plain=lambda x=x, wp=wp, a=alpha, r=row: bg.binary_gemm_reference(x, wp, a, r),
            library=(lambda x=x, w=w8: torch._int_mm(x, w)) if lib else None,
            bound=gemm_bound(m, k, n, code_bytes(k, n, 1), nscale), main=main,
            plan=stream_plan(m, n, k, bg.STAGE_K)[:2], split=label.startswith("edge"),
            also=also, host=main or (also and m <= 32),
        ), alpha, row

    for label, m, k, n, ua, ur in gemm_shapes:
        main = label == "fc1 M=256"
        # beside the main rows of K1 and K3 in the JSON line: the LM's
        # projections at M=32 (with the host's us per call)
        beside = label.startswith("lm") and label.endswith(f"M={SLOTS}")
        case, alpha, row = binary_case(label, m, k, n, ua, ur, main=main, also=beside,
                                       zeros=label.startswith("edge M=17"))
        cases.append(case)
        lib = case["library"] is not None
        xi = t(rng.integers(-127, 128, size=(m, k)).astype(np.int8))
        wi = t(rng.integers(-127, 128, size=(k, n)).astype(np.int8))
        cases.append(int8_gemm_case(label, xi, wi, alpha, row, main, lib, also=beside))
    # K1 at the headline's 4096^3, beside the main row; then splits over K at
    # ragged K (the last chunk short, K % 4 != 0 at 1501: byte loads), M = 1
    # and 65, N = 10, and zeros
    big = HEADLINE_SHAPE
    cases.append(binary_case(f"{big}^3", big, big, big, False, False, also=True)[0])
    for label, m, k, n, ua, ur in (("edge split M=1 K=300 N=10", 1, 300, 10, False, False),
                                   ("edge split M=65 K=1500 N=10 alpha", 65, 1500, 10, True, False),
                                   ("edge split M=65 K=1501 N=10 row", 65, 1501, 10, False, True),
                                   ("edge split M=1 K=2100 N=10 alpha+row", 1, 2100, 10, True,
                                    True),
                                   ("edge split zeros M=65 K=2100 N=10", 65, 2100, 10, False,
                                    False)):
        cases.append(binary_case(label, m, k, n, ua, ur, zeros="zeros" in label)[0])
    # K3 at the headline's 4096^3, beside the main row; then the copy paths
    # of unaligned operands (x's rows at an odd address: byte loads; K % 16
    # != 0 and N % 16 != 0 with K, N % 4 == 0: 4-byte copies), each split
    xi = t(rng.integers(-127, 128, size=(big, big)).astype(np.int8))
    wi = t(rng.integers(-127, 128, size=(big, big)).astype(np.int8))
    cases.append(int8_gemm_case(f"{big}^3", xi, wi, None, None, False, True, also=True))
    for label, m, k, n, ua, ur in (("edge unaligned x M=32 K=1024 N=256 alpha", 32, 1024, 256,
                                    True, False),
                                   ("edge 4-byte M=8 K=1028 N=260 alpha+row", 8, 1028, 260,
                                    True, True)):
        flat = t(rng.integers(-127, 128, size=m * k + 1).astype(np.int8))
        xi = flat[1:].view(m, k) if "unaligned" in label else flat[:-1].view(m, k)
        wi = t(rng.integers(-127, 128, size=(k, n)).astype(np.int8))
        alpha, row = scales(m, n, ua, ur)
        cases.append(int8_gemm_case(label, xi, wi, alpha, row, False, False))
    # K4 at the decode LM's shapes (h 8, cache 1024, hd 128) with per-slot
    # cursors: as the engine has them (prompt 16..128 + up to 32 new), spread
    # over the whole cache, and full; then edge shapes
    hi = PROMPT_LENS[1] + MAX_NEW
    attn_shapes = [
        ("b=32 engine cursors", 32, 8, 1024, 128, rng.integers(PROMPT_LENS[0] + 1, hi + 1, 32)),
        ("b=1 varied", 1, 8, 1024, 128, rng.integers(1, 1025, 1)),
        ("b=8 varied", 8, 8, 1024, 128, rng.integers(1, 1025, 8)),
        ("b=32 varied", 32, 8, 1024, 128, rng.integers(1, 1025, 32)),
        ("b=32 full", 32, 8, 1024, 128, np.full(32, 1024)),
        ("edge cl=1", 3, 8, 1, 128, np.ones(3, int)),
        ("edge cl=37 hd=64 b=5", 5, 4, 37, 64, np.array([1, 37, 20, 2, 36])),
        ("edge hd=64 one valid row", 3, 8, 1024, 64, np.array([1, 512, 1024])),
        ("edge hd=16 b=7", 7, 2, 300, 16, rng.integers(1, 301, 7)),
    ]
    # edges of the clustered split, drawn from their own stream so that the
    # cases above and after keep their data: fully masked rows (a cursor of
    # 0), one (b, h) spread over the most blocks, the largest head dim, a
    # cache 8x the LM's
    edge_rng = np.random.default_rng(SEED + 4)
    attn_shapes = [(rng, *shape) for shape in attn_shapes] + [(edge_rng, *shape) for shape in (
        ("edge fully masked rows", 4, 8, 1024, 128, np.array([0, 5, 0, 1024])),
        ("edge b=1 full", 1, 8, 1024, 128, np.full(1, 1024)),
        ("edge hd=256 full b=4", 4, 8, 1024, 256, np.full(4, 1024)),
        ("edge cl=8192 b=2", 2, 8, 8192, 128, np.array([8192, 3000])),
    )]
    for draw, label, b, h, cl, hd, lens in attn_shapes:
        q = t(draw.normal(size=(b, h, hd)).astype(np.float32))
        kc = t(draw.integers(-127, 128, (b, h, cl, hd)).astype(np.int8))
        vc = t(draw.integers(-127, 128, (b, h, cl, hd)).astype(np.int8))
        ks = t(draw.uniform(0.01, 0.1, (b, h, cl)).astype(np.float32))
        vs = t(draw.uniform(0.01, 0.1, (b, h, cl)).astype(np.float32))
        bias = t(np.where(np.arange(cl)[None, :] < lens[:, None], 0.0, -1e30).astype(np.float32))
        args = (q, kc, ks, vc, vs, bias)
        cases.append(dict(
            kernel="decode_attention", label=label,
            fn=lambda a=args: da.decode_attention(*a),
            plain=lambda a=args: da.decode_attention_reference(*a),
            library=None, sdpa=sdpa_yardstick(args),
            bound=attention_bound(b, h, cl, hd, lens),
            full_bound=attention_bound(b, h, cl, hd, np.full(b, cl)),
            main=label == "b=32 engine cursors", attn_plan=attention_plan(b, h, cl, hd),
        ))
    return cases


def resnet_convs():
    """The DoReFa ResNet-20's block convs at RESNET_WIDTH: (label, input
    size, cin, cout, stride), one of each shape."""
    w = RESNET_WIDTH
    return (
        (f"stage0 conv 32x32x{w}", 32, w, w, 1),
        (f"stage1 conv1 s2 32x32x{w}", 32, w, 2 * w, 2),
        (f"stage1 conv 16x16x{2 * w}", 16, 2 * w, 2 * w, 1),
        (f"stage2 conv1 s2 16x16x{2 * w}", 16, 2 * w, 4 * w, 2),
        (f"stage2 conv 8x8x{4 * w}", 8, 4 * w, 4 * w, 1),
    )


def lm_gemms(cfg: dict):
    """The LM's projection GEMMs (name, K, N), one per GEMM_INPUTS entry."""
    d, ff = cfg["d_model"], cfg["d_ff"]
    return (("qkv", d, d), ("out", d, d), ("ffn_in", d, ff), ("ffn_out", ff, d))


def kbit_cases(rng, dev):
    """K5 int8_conv2d, K6 dorefa_gemm and K7 decode_dorefa_weights: every
    shape the ResNet (b = RESNET_BATCH) and W4A4 LM paths give them, the
    im2col cross-check's, BNN LeNet's conv2, and edges. Same dicts as
    :func:`kernel_cases`."""
    import torch
    import torch.nn.functional as F

    from pytorch_quantize_impls_tpu_torch import ops
    from pytorch_quantize_impls_tpu_torch.kernels import int8_conv as ic
    from pytorch_quantize_impls_tpu_torch.kernels import packed_matmul as pm
    from pytorch_quantize_impls_tpu_torch.kernels.common import conv_plan, stream_plan
    from pytorch_quantize_impls_tpu_torch.kernels.conv import conv_pads

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def dorefa_packed(k, n, w_bits):
        w = t(rng.normal(size=(k, n)).astype(np.float32))
        return pm.pack_dorefa_weights(ops.dorefa_weight(w, w_bits), w_bits)

    cases = []
    # K7 at every ResNet block conv's and LM projection's weights, then edges
    k7 = {f"resnet {label} ({9 * cin},{cout})": (9 * cin, cout, 4)
          for label, _, cin, cout, _ in resnet_convs()}
    k7.update({f"lm {name} ({k},{n})": (k, n, 4) for name, k, n in lm_gemms(W4A4_LM_CFG)})
    k7.update({"edge w2 K=300 N=10": (300, 10, 2), "edge w1 K=1500 N=130": (1500, 130, 1),
               "edge w4 K=25 N=7": (25, 7, 4)})
    for label, (k, n, w_bits) in k7.items():
        wp = dorefa_packed(k, n, w_bits)
        cases.append(dict(
            kernel="decode_dorefa_weights", label=label,
            fn=lambda wp=wp, b=w_bits: pm.decode_dorefa_weights(wp, w_bits=b),
            plain=lambda wp=wp, b=w_bits: pm.decode_dorefa_weights_reference(wp, w_bits=b),
            library=None, bound=bound_ms(code_bytes(k, n, w_bits) + k * n, 0,
                                         INT8_OPS_PER_S),
            main=label.startswith("resnet stage2 conv 8x8"),
        ))
    # K6 at the LM's GEMMs (decode step M = SLOTS, prefill M = 128), the
    # im2col cross-check of the stage-1 stride-2 conv (RESNET_IM2COL_BATCH
    # images), the VGG head's shape and the headline's 4096^3 (timed beside
    # the main row), then edges over w_bits x a_bits, M = 1, ragged N, K off
    # the group and K % 4 != 0, and splits over K (S > 1: ragged last
    # chunks at K = 300, 1500, 2100, N = 10, M = 1 and 65, zero codes)
    w = RESNET_WIDTH
    big = HEADLINE_SHAPE
    k6 = [(f"lm {name} M={m}", m, k, n, 4, 4)
          for name, k, n in lm_gemms(W4A4_LM_CFG) for m in (SLOTS, 128)]
    k6 += [(f"resnet im2col stage1 conv1 b={RESNET_IM2COL_BATCH}",
            RESNET_IM2COL_BATCH * 16 * 16, 9 * w, 2 * w, 4, 4),
           ("vgg head shape M=256 K=8192 N=10 w4a4", 256, 8192, 10, 4, 4),
           (f"{big}^3 w4a4", big, big, big, 4, 4)]
    k6 += [("edge M=1 K=576 N=64 w4a4", 1, 576, 64, 4, 4),
           ("edge M=33 K=2304 N=130 w4a2", 33, 2304, 130, 4, 2),
           ("edge M=17 K=301 N=64 w4a1", 17, 301, 64, 4, 1),
           ("edge M=64 K=700 N=24 w2a4", 64, 700, 24, 2, 4),
           ("edge M=5 K=300 N=40 w2a2", 5, 300, 40, 2, 2),
           ("edge M=8 K=1500 N=24 w1a1", 8, 1500, 24, 1, 1),
           ("edge M=3 K=64 N=8 w1a4", 3, 64, 8, 1, 4)]
    # the digits MLP's three layers (64-512-512-10) at W1A2, b = 64 and 256,
    # with the one-bit weights' E|W| in the epilogue
    k6 += [(f"digits {name} M={m} K={k} N={n} w1a2 E|W|", m, k, n, 1, 2)
           for m in (64, 256) for name, k, n in (("layer0", 64, 512), ("layer1", 512, 512),
                                                ("head", 512, 10))]
    k6 += [("edge split M=1 K=300 N=10 w4a4", 1, 300, 10, 4, 4),
           ("edge split M=65 K=1500 N=130 w2a4", 65, 1500, 130, 2, 4),
           ("edge split M=65 K=2100 N=130 w4a4", 65, 2100, 130, 4, 4),
           ("edge split M=256 K=8192 N=10 w1a2", 256, 8192, 10, 1, 2),
           ("edge split zeros M=32 K=1024 N=1024 w4a4", 32, 1024, 1024, 4, 4)]
    for label, m, k, n, w_bits, a_bits in k6:
        a = t(rng.integers(0, 2**a_bits, size=(m, k)).astype(np.int8))
        a = a * 0 if "zeros" in label else a
        wp = dorefa_packed(k, n, w_bits)
        # E|W| of a digits layer's glorot-drawn weights, ~0.03-0.05
        alpha = float(rng.uniform(0.02, 0.06)) if "E|W|" in label else None
        lib = m > 16 and k % 8 == 0 and n % 8 == 0  # torch._int_mm's shape rules
        w8 = pm.decode_dorefa_weights(wp, w_bits=w_bits)[:k].contiguous() if lib else None
        cases.append(dict(
            kernel="dorefa_gemm", label=label,
            fn=lambda a=a, wp=wp, wb=w_bits, ab=a_bits, al=alpha: pm.dorefa_gemm(
                a, wp, w_bits=wb, a_bits=ab, alpha=al),
            plain=lambda a=a, wp=wp, wb=w_bits, ab=a_bits, al=alpha: pm.dorefa_gemm_reference(
                a, wp, w_bits=wb, a_bits=ab, alpha=al),
            library=(lambda a=a, w8=w8: torch._int_mm(a, w8)) if lib else None,
            bound=gemm_bound(m, k, n, code_bytes(k, n, w_bits), 0),
            main=label == f"lm ffn_in M={SLOTS}",
            plan=stream_plan(m, n, k, pm.STAGE_K)[:2], split="split" in label,
            also=label.startswith(("vgg head", f"{big}^3")),
        ))
    # K5 at the ResNet's block convs (b = RESNET_BATCH, and b = 1): the
    # packed path's scale epilogue at every shape, the fused path's codes and
    # affine ones at stage 1; BNN LeNet's conv2 (±1, no scale); then edges
    n_a = 15
    conv_cases = [(label, RESNET_BATCH, h, cin, cout, 3, (s, s), "SAME", "scale")
                  for label, h, cin, cout, s in resnet_convs()]
    conv_cases += [(f"stage1 conv 16x16x{2 * w} {epi}", RESNET_BATCH, 16, 2 * w, 2 * w, 3,
                    (1, 1), "SAME", epi) for epi in ("codes", "affine")]
    conv_cases += [(f"bnn_lenet conv2 12x12x{WIDTH}", BUCKETS[-1], 12, WIDTH, 2 * WIDTH, 5,
                    (1, 1), "VALID", "none")]
    conv_cases += [(f"b=1 {label}", 1, h, cin, cout, 3, (s, s), "SAME", "scale")
                   for label, h, cin, cout, s in resnet_convs()]
    conv_cases += [
        ("edge b=1 3x3 VALID C=5 N=7 -> 1x1", 1, 3, 5, 7, 3, (1, 1), "VALID", "scale"),
        ("edge 5x5 VALID C=6 N=10 codes", 2, 12, 6, 10, 5, (1, 1), "VALID", "codes"),
        ("edge 1x1 s2 SAME C=12 N=20 affine", 3, 9, 12, 20, 1, (2, 2), "SAME", "affine"),
        ("edge s2 SAME 15x15 C=64 N=130", 2, 15, 64, 130, 3, (2, 2), "SAME", "scale"),
        ("edge s2 SAME 16x16 C=3 N=65 codes", 2, 16, 3, 65, 3, (2, 2), "SAME", "codes"),
        ("edge pads ((1,2),(0,1)) s(2,1) C=33", 2, 15, 33, 70, 3, (2, 1), ((1, 2), (0, 1)),
         "affine"),
        ("edge codes ties a=0.5 b=0", 2, 8, 16, 20, 3, (1, 1), "SAME", "ties"),
    ]
    for label, b, h, cin, cout, k, strides, padding, epi in conv_cases:
        kk = cin * k * k
        if label.startswith("bnn_lenet"):
            x = t(np.where(rng.normal(size=(b, h, h, cin)) >= 0, 1, -1).astype(np.int8))
            wc = t(np.where(rng.normal(size=(kk, cout)) >= 0, 1, -1).astype(np.int8))
        else:
            x = t(rng.integers(0, n_a + 1, size=(b, h, h, cin)).astype(np.int8))
            wc = t((2 * rng.integers(0, 16, size=(kk, cout)) - 15).astype(np.int8))
        pads = conv_pads(padding, (h, h), (k, k), strides)
        # codes: y = a acc + b spread over [0, n_a] (acc's spread is about
        # 1e3 sqrt(K) for uniform codes); ties: every odd acc lands on .5
        acc_scale = n_a / (4.0e3 * np.sqrt(kk))
        a = b_ = None
        if epi == "scale":
            a = t(rng.uniform(0.5, 1.5, cout).astype(np.float32) / np.float32(1e3))
        elif epi in ("codes", "affine"):
            a = t((rng.uniform(0.5, 1.5, cout) * acc_scale).astype(np.float32))
            b_ = t(rng.uniform(0, n_a, cout).astype(np.float32))
        elif epi == "ties":
            a, b_ = t(np.full(cout, 0.5, np.float32)), t(np.zeros(cout, np.float32))
        kind = {"none": "scale", "ties": "codes"}.get(epi, epi)
        args = (x, wc, (k, k), strides, pads, kind, a, b_, n_a)
        (pt, pb), (pl, pr) = pads
        ho, wo = ic.out_size(h, k, strides[0], pads[0]), ic.out_size(h, k, strides[1], pads[1])
        m = b * ho * wo
        xf = F.pad(x.permute(0, 3, 1, 2).to(torch.float32), (pl, pr, pt, pb))
        wf = wc.T.reshape(cout, cin, k, k).to(torch.float32).contiguous()

        def cudnn(xf=xf, wf=wf, strides=strides):
            with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
                return F.conv2d(xf, wf, stride=strides)

        out_bytes = m * cout * (1 if kind == "codes" else 4)
        nvec = (a is not None) + (b_ is not None)
        plan = conv_plan(m, cout)
        cases.append(dict(
            kernel="int8_conv2d", label=label,
            fn=lambda args=args: ic.int8_conv2d(*args),
            plain=lambda args=args: ic.int8_conv2d_reference(*args),
            library=cudnn,
            bound=bound_ms(x.numel() + wc.numel() + out_bytes + 4 * cout * nvec,
                           2 * m * kk * cout, INT8_OPS_PER_S),
            main=label == f"stage1 conv 16x16x{2 * w}", tile=(plan["bm"], plan["bn"]),
            also=not label.startswith("edge"),
        ))
    return cases


def fused_conv_cases(rng, dev):
    """K5 with the packed weight stage (``int8_conv2d(..., w_bits=)``, the
    packed conv's fused route): at every ResNet block conv at b = 1 and b =
    RESNET_BATCH, BNN LeNet's conv2 (b = 1 and BUCKETS[-1]) and K5's edge
    shapes, each with 1-, 2- and 4-bit DoReFa words (scale 1/(n_w n_a)),
    binary words (no scale) and xnor words (alpha), held bit for bit to
    int8_conv2d_reference on the decoded words. The ResNet's own 4-bit
    weights at its convs and LeNet's binary conv2 are timed beside the
    two-launch route, K7 or K2 then the raw K5 (``two_launch``), by CUDA
    events and device time. Same dicts as :func:`kernel_cases`."""
    import torch

    from pytorch_quantize_impls_tpu_torch.kernels import int8_conv as ic
    from pytorch_quantize_impls_tpu_torch.kernels import packed_matmul as pm
    from pytorch_quantize_impls_tpu_torch.kernels import xnor_gemm as bg
    from pytorch_quantize_impls_tpu_torch.kernels.common import conv_route, conv_slab_plan
    from pytorch_quantize_impls_tpu_torch.kernels.conv import conv_pads
    from pytorch_quantize_impls_tpu_torch.ops import pack as packlib

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    shapes = [(f"b={b} {label}", b, h, cin, cout, 3, (s, s), "SAME", "scale")
              for b in (1, RESNET_BATCH) for label, h, cin, cout, s in resnet_convs()]
    shapes += [(f"b={b} bnn_lenet conv2 12x12x{WIDTH}", b, 12, WIDTH, 2 * WIDTH, 5, (1, 1), "VALID",
                "scale") for b in (1, BUCKETS[-1])]
    shapes += [
        ("edge b=1 3x3 VALID C=5 N=7 -> 1x1", 1, 3, 5, 7, 3, (1, 1), "VALID", "scale"),
        ("edge 5x5 VALID C=6 N=10 codes", 2, 12, 6, 10, 5, (1, 1), "VALID", "codes"),
        ("edge 1x1 s2 SAME C=12 N=20 affine", 3, 9, 12, 20, 1, (2, 2), "SAME", "affine"),
        ("edge s2 SAME 15x15 C=64 N=130", 2, 15, 64, 130, 3, (2, 2), "SAME", "scale"),
        ("edge s2 SAME 16x16 C=3 N=65 codes", 2, 16, 3, 65, 3, (2, 2), "SAME", "codes"),
        ("edge pads ((1,2),(0,1)) s(2,1) C=33", 2, 15, 33, 70, 3, (2, 1), ((1, 2), (0, 1)),
         "affine"),
        ("edge codes ties a=0.5 b=0", 2, 8, 16, 20, 3, (1, 1), "SAME", "ties"),
    ]
    n_a = 15
    cases = []
    for label, b, h, cin, cout, k, strides, padding, epi in shapes:
        kk = cin * k * k
        x = t(rng.integers(0, n_a + 1, size=(b, h, h, cin)).astype(np.int8))
        if "lenet" in label:
            x = t(np.where(rng.normal(size=(b, h, h, cin)) >= 0, 1, -1).astype(np.int8))
        pads = conv_pads(padding, (h, h), (k, k), strides)
        ho, wo = ic.out_size(h, k, strides[0], pads[0]), ic.out_size(h, k, strides[1], pads[1])
        m = b * ho * wo
        for kind, bits in (("w1", 1), ("w2", 2), ("w4", 4), ("binary", 1), ("xnor", 1)):
            codes = t(rng.integers(0, 2**bits, size=(kk, cout)).astype(np.int32))
            wp = packlib.pack_bitplanes(codes, bits)
            a = b_ = None
            if epi == "scale" and kind.startswith("w"):
                a = torch.full((cout,), pm.inv_scale(bits, 4), dtype=torch.float32, device=dev)
            elif epi == "scale" and kind == "xnor":
                a = t(rng.uniform(0.5, 1.5, cout).astype(np.float32))
            elif epi in ("codes", "affine"):
                spread = rng.uniform(0.5, 1.5, cout) * n_a / (4.0e3 * np.sqrt(kk))
                a = t(spread.astype(np.float32))
                b_ = t(rng.uniform(0, n_a, cout).astype(np.float32))
            elif epi == "ties":
                a, b_ = t(np.full(cout, 0.5, np.float32)), t(np.zeros(cout, np.float32))
            mode = {"ties": "codes"}.get(epi, epi)
            args = (x, wp, (k, k), strides, pads, mode, a, b_, n_a)
            timed = (not label.startswith("edge")
                     and kind == ("binary" if "lenet" in label else "w4"))
            decode = (lambda wp=wp: bg.decode_binary_weights(wp)) if kind in ("binary", "xnor") \
                else (lambda wp=wp, bits=bits: pm.decode_dorefa_weights(wp, w_bits=bits))
            out_bytes = m * cout * (1 if mode == "codes" else 4)
            nvec = (a is not None) + (b_ is not None)
            plan = conv_slab_plan(cin, k * k, bits)
            cases.append(dict(
                kernel="int8_conv2d", label=f"fused {label} {kind}",
                fn=lambda args=args, bits=bits: ic.int8_conv2d(*args, w_bits=bits),
                plain=lambda args=args, bits=bits: ic.int8_conv2d_reference(*args, w_bits=bits),
                two_launch=lambda args=args, decode=decode, kk=kk: ic.int8_conv2d(
                    args[0], decode()[:kk], *args[2:]),
                library=None, timed=timed, also=timed,
                bound=bound_ms(x.numel() + code_bytes(kk, cout, bits) + out_bytes
                               + 4 * cout * nvec, 2 * m * kk * cout, INT8_OPS_PER_S),
                main=False, tile=(128, plan["bn"]), slab=(plan["groups"], plan["smem"]),
                route=conv_route(b, m, cout, cin, k * k, bits),
            ))
    return cases


def digits_conv_cases(rng, dev):
    """K5 and K2 at the XNOR digits convs: xnor_digits_a1's conv1 (8x8x128
    -> 128, 3x3 SAME, xnor words, alpha in the scale epilogue) at b = 1, 64
    and 256 by both routes, the packed weight stage (``fused``) and the raw
    tile on K2's decoded words (``raw``), each held bit for bit to
    int8_conv2d_reference, with its bound; K2 at both digits convs' packed
    words (xnor_digits' conv1 32 -> 64, K 288; xnor_digits_a1's 128 -> 128,
    K 1152). All timed beside their kernel's main row; the raw rows' library
    call is cuDNN's float32 conv on the codes, as in :func:`kernel_cases`.
    Same dicts as :func:`kernel_cases`."""
    import torch
    import torch.nn.functional as F

    from pytorch_quantize_impls_tpu_torch.kernels import int8_conv as ic
    from pytorch_quantize_impls_tpu_torch.kernels import xnor_gemm as bg
    from pytorch_quantize_impls_tpu_torch.kernels.common import (conv_plan, conv_route,
                                                                 conv_slab_plan)
    from pytorch_quantize_impls_tpu_torch.kernels.conv import conv_pads

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    cases = []
    for label, k, n in (("xnor_digits conv1 (32,64)", 9 * 32, 64),
                        ("xnor_digits_a1 conv1 (128,128)", 9 * 128, 128)):
        wp = bg.pack_binary_weights(t(rng.normal(size=(k, n)).astype(np.float32)))
        cases.append(dict(
            kernel="decode_binary_weights", label=label,
            fn=lambda wp=wp: bg.decode_binary_weights(wp),
            plain=lambda wp=wp: bg.decode_binary_weights_reference(wp),
            library=None, bound=bound_ms(code_bytes(k, n, 1) + k * n, 0, INT8_OPS_PER_S),
            main=False, also=True,
        ))
    h, cin, cout = XD_CONV
    kk = 9 * cin
    pads = conv_pads("SAME", (h, h), (3, 3), (1, 1))
    for b in (1, 64, 256):
        x = t(np.where(rng.normal(size=(b, h, h, cin)) >= 0, 1, -1).astype(np.int8))
        words = bg.pack_binary_weights(t(rng.normal(size=(kk, cout)).astype(np.float32)))
        w8 = bg.decode_binary_weights(words)[:kk].contiguous()
        alpha = t(rng.uniform(0.5, 1.5, cout).astype(np.float32))
        m = b * h * h
        route = conv_route(b, m, cout, cin, 9, 1)
        (pt, pb), (pl, pr) = pads
        xf = F.pad(x.permute(0, 3, 1, 2).to(torch.float32), (pl, pr, pt, pb))
        wf = w8.T.reshape(cout, cin, 3, 3).to(torch.float32).contiguous()

        def cudnn(xf=xf, wf=wf):
            with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
                return F.conv2d(xf, wf)

        for mode, w, bits in (("fused", words, 1), ("raw", w8, 0)):
            args = (x, w, (3, 3), (1, 1), pads, "scale", alpha)
            plan = conv_slab_plan(cin, 9, 1) if bits else conv_plan(m, cout)
            w_bytes = code_bytes(kk, cout, 1) if bits else kk * cout
            case = dict(
                kernel="int8_conv2d", label=f"{mode} b={b} xnor_digits_a1 conv1 8x8x128",
                fn=lambda args=args, bits=bits: ic.int8_conv2d(*args, w_bits=bits),
                plain=lambda args=args, bits=bits: ic.int8_conv2d_reference(*args, w_bits=bits),
                library=None if bits else cudnn, main=False, also=True,
                bound=bound_ms(x.numel() + w_bytes + 4 * m * cout + 4 * cout,
                               2 * m * kk * cout, INT8_OPS_PER_S),
                tile=(128, plan["bn"]),
            )
            if bits:
                case["slab"] = (plan["groups"], plan["smem"])
                case["route"] = f"{route} (conv_route's pick at b={b})"
            cases.append(case)
    return cases


def xnor_convs():
    """XNORConvNet's hidden convs at its published widths (BASELINE config
    3): (label, input size, cin, cout), 3x3 SAME, a 2x2 pool after every
    second conv."""
    convs, hw, cin = [], RESNET_SHAPE[0], XNOR_WIDTHS[0]
    for i, w in enumerate(XNOR_WIDTHS[1:], start=1):
        convs.append((f"conv{i} {hw}x{hw}x{cin}", hw, cin, w))
        cin = w
        if i % 2 == 1:
            hw //= 2
    return convs


def threshold_cases(rng, dev):
    """K5's threshold epilogue (the binary fused chains' boundary), on the
    raw tile (+-1 int8 weights) and the packed weight stage (1-bit words), at
    xnor_cifar's five hidden convs and BNN LeNet's conv2 at b = 1 and b =
    RESNET_BATCH, and edges (odd cout, 5x5 VALID). Per channel: a threshold
    equal to one of the channel's sums (ties, which give hi) on a third of
    them, halves and random values on the rest, -inf (gamma = 0) on channel
    0 and a constant code (alpha = 0: -inf with hi = lo) on channel 1; hi
    and lo +-1 with either sign (gamma < 0 flips them). Held bit for bit to
    the plain version; conv3 at b = RESNET_BATCH (raw) and b = 1 (packed)
    are timed beside the scale epilogue plus a ``torch.where``
    (``scale_where``). Same dicts as :func:`kernel_cases`."""
    import torch

    from pytorch_quantize_impls_tpu_torch.kernels import int8_conv as ic
    from pytorch_quantize_impls_tpu_torch.kernels import xnor_gemm as bg
    from pytorch_quantize_impls_tpu_torch.kernels.common import conv_plan, conv_slab_plan
    from pytorch_quantize_impls_tpu_torch.kernels.conv import conv_pads

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    shapes = [(f"b={b} xnor {label}", b, h, cin, cout, 3, "SAME")
              for b in (1, RESNET_BATCH) for label, h, cin, cout in xnor_convs()]
    shapes += [(f"b={b} bnn_lenet conv2 12x12x{WIDTH}", b, 12, WIDTH, 2 * WIDTH, 5, "VALID")
               for b in (1, BUCKETS[-1])]
    shapes += [("edge odd cout 9x9x24->17", 2, 9, 24, 17, 3, "SAME"),
               ("edge 5x5 VALID 12x12x6->65", 3, 12, 6, 65, 5, "VALID")]
    cases = []
    for label, b, h, cin, cout, k, padding in shapes:
        kk = cin * k * k
        x = t(np.where(rng.normal(size=(b, h, h, cin)) >= 0, 1, -1).astype(np.int8))
        wf = t(rng.normal(size=(kk, cout)).astype(np.float32))
        w8 = torch.where(wf >= 0, 1, -1).to(torch.int8)
        words = bg.pack_binary_weights(wf)
        pads = conv_pads(padding, (h, h), (k, k), (1, 1))
        f = ic.int8_conv2d(x, w8, (k, k), (1, 1), pads).reshape(-1, cout).cpu().numpy()
        thr = (rng.normal(size=cout) * np.sqrt(kk) / 4).astype(np.float32)
        thr[1::3] = np.round(thr[1::3]) + np.float32(0.5)
        ties = np.arange(2, cout, 3)
        thr[ties] = f[rng.integers(0, f.shape[0], ties.size), ties]
        hi = np.where(rng.uniform(size=cout) < 0.25, -1.0, 1.0)
        lo = -hi
        thr[0], lo[0] = -np.inf, hi[0]  # gamma = 0: the constant sign(beta)
        thr[1], hi[1], lo[1] = -np.inf, -1.0, -1.0  # alpha = 0: a constant code
        thr, codes = t(thr), t(np.stack([hi, lo]).astype(np.float32))
        m = f.shape[0]
        main = label == f"b={RESNET_BATCH} xnor conv3 16x16x256"
        for mode, w, bits in (("raw", w8, 0), ("packed", words, 1)):
            args = (x, w, (k, k), (1, 1), pads, "threshold", thr, codes)
            timed = main if mode == "raw" else label == "b=1 xnor conv3 16x16x256"
            plan = conv_plan(m, cout) if mode == "raw" else conv_slab_plan(cin, k * k, 1)
            case = dict(
                kernel="int8_conv2d", label=f"threshold {mode} {label}",
                fn=lambda args=args, bits=bits: ic.int8_conv2d(*args, w_bits=bits),
                plain=lambda args=args, bits=bits: ic.int8_conv2d_reference(*args, w_bits=bits),
                scale_where=lambda args=args, bits=bits: ic.threshold_codes(
                    ic.int8_conv2d(*args[:5], w_bits=bits), args[6], args[7]),
                library=None, timed=timed, also=timed, main=False,
                bound=bound_ms(x.numel() + w.numel() * w.element_size() + m * cout + 12 * cout,
                               2 * m * kk * cout, INT8_OPS_PER_S),
                tile=(128, plan["bn"]),
            )
            if mode == "packed":
                case["slab"] = (plan["groups"], plan["smem"])
                case["route"] = "fused (forced)"
            cases.append(case)
    return cases


def vgg_convs(widths):
    """LogQuantVGGSmall's convs: (label, input size, cin, cout), a 2x2 pool
    after every second one."""
    convs, hw, cin = [], RESNET_SHAPE[0], RESNET_SHAPE[2]
    for i, w in enumerate(widths):
        convs.append((f"conv{i} {hw}x{hw}x{cin}", hw, cin, w))
        cin = w
        if i % 2 == 1:
            hw //= 2
    return convs


def log_cases(rng, dev):
    """K8 shift_gemm and K9 decode_log_weights: every shape the VGG and log
    LM paths give them, conv3 as im2col, and edges (K off the 128-row group,
    N = 10, (fsr, bits) = (0, 3) and (1, 6)). Same dicts as
    :func:`kernel_cases`, plus ``abs_ref``, K8's |bf16(x)| @ |w| in float64,
    and, beside the library call (torch.mm of the bf16 values with a float32
    output), ``cublas_f32`` and ``cublas_bf16``, cuBLAS's float32 matmul of
    the bf16 values and its bf16 matmul."""
    import torch

    from pytorch_quantize_impls_tpu_torch.kernels import shift_matmul as sm
    from pytorch_quantize_impls_tpu_torch.kernels.common import stream_plan
    from pytorch_quantize_impls_tpu_torch.utils import SCHEME_CONFIGS, RunConfig

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def packed(k, n, fsr, bits):
        w = t(rng.normal(size=(k, n)).astype(np.float32) * np.float32((2.0 / k) ** 0.5))
        return sm.pack_log_weights(w, fsr, bits)

    cfg = RunConfig(**SCHEME_CONFIGS["logquant_vgg"])
    vgg = (cfg.fsr, cfg.w_bits)
    lm = (LOG_LM_CFG["fsr"], LOG_LM_CFG["w_bits"])
    head_k = 512 * 4 * 4
    cases = []
    # K9 at every VGG conv's and the head's weights (prepare), the log LM's
    # projections, then edges
    k9 = {f"vgg {label} ({9 * cin},{cout})": (9 * cin, cout, *vgg)
          for label, _, cin, cout in vgg_convs((128, 128, 256, 256, 512, 512))}
    k9[f"vgg head ({head_k},10)"] = (head_k, 10, *vgg)
    k9.update({f"lm {name} ({k},{n})": (k, n, *lm) for name, k, n in lm_gemms(LOG_LM_CFG)})
    k9.update({"edge K=300 N=10 fsr0 b3": (300, 10, 0.0, 3),
               "edge K=27 N=7 fsr1 b6": (27, 7, 1.0, 6),
               "edge K=2100 N=130 fsr0 b4": (2100, 130, 0.0, 4)})
    for label, (k, n, fsr, bits) in k9.items():
        wp = packed(k, n, fsr, bits)
        cases.append(dict(
            kernel="decode_log_weights", label=label,
            fn=lambda wp=wp, f=fsr, b=bits: sm.decode_log_weights(wp, fsr=f, bits=b),
            plain=lambda wp=wp, f=fsr, b=bits: sm.decode_log_weights_reference(wp, fsr=f, bits=b),
            library=None, bound=bound_ms(code_bytes(k, n, sm.CODE_BITS) + 2 * k * n, 0,
                                         BF16_FLOPS_PER_S),
            main=label.startswith("vgg conv5"),
        ))
    # K8 at the VGG head (M = 1, 16, 256; 256 timed beside the main row), the
    # log LM's projections at M = SLOTS, conv3 as im2col, the headline's
    # 4096^3 (timed beside the main row), then edges, and splits over K
    # (S > 1: ragged last chunks at K = 300, 1500, 2100, M = 1 and 65, x
    # unaligned (K % 4 != 0), zero activations)
    big = HEADLINE_SHAPE
    k8 = [(f"vgg head M={m}", m, head_k, 10, *vgg) for m in SMALL_M]
    k8 += [(f"lm {name} M={SLOTS}", SLOTS, k, n, *lm) for name, k, n in lm_gemms(LOG_LM_CFG)]
    k8 += [(f"vgg im2col conv3 b={VGG_IM2COL_BATCH}", VGG_IM2COL_BATCH * 16 * 16, 9 * 256, 256,
            *vgg), (f"{big}^3 fsr1 b4", big, big, big, 1.0, 4)]
    k8 += [("edge M=1 K=27 N=128 fsr1 b4", 1, 27, 128, 1.0, 4),
           ("edge M=33 K=300 N=10 fsr0 b3", 33, 300, 10, 0.0, 3),
           ("edge M=70 K=2100 N=130 fsr1 b6", 70, 2100, 130, 1.0, 6),
           ("edge M=5 K=128 N=65 fsr0 b4", 5, 128, 65, 0.0, 4)]
    k8 += [("edge split M=1 K=300 N=10 fsr0 b3", 1, 300, 10, 0.0, 3),
           ("edge split M=65 K=1500 N=130 fsr1 b4", 65, 1500, 130, 1.0, 4),
           ("edge split M=8 K=2100 N=64 fsr0 b4", 8, 2100, 64, 0.0, 4),
           ("edge split M=65 K=1501 N=130 fsr1 b6", 65, 1501, 130, 1.0, 6),
           ("edge split zeros M=32 K=1024 N=1024 fsr1 b4", 32, 1024, 1024, 1.0, 4)]
    for label, m, k, n, fsr, bits in k8:
        x = t(rng.normal(size=(m, k)).astype(np.float32) * (0 if "zeros" in label else 1))
        wp = packed(k, n, fsr, bits)
        wb = sm.decode_log_weights(wp, fsr=fsr, bits=bits)[:k].contiguous()
        xb = x.to(torch.bfloat16)
        xf, wf = xb.to(torch.float32), wb.to(torch.float32)
        cases.append(dict(
            kernel="shift_gemm", label=label,
            fn=lambda x=x, wp=wp, f=fsr, b=bits: sm.shift_gemm(x, wp, fsr=f, bits=b),
            plain=lambda x=x, wp=wp, f=fsr, b=bits: sm.shift_gemm_reference(x, wp, fsr=f, bits=b),
            # the same function in one PyTorch call: bf16 products into a
            # float32 output on the tensor cores; beside it cuBLAS's float32
            # matmul of the bf16 values (TF32 off) and its bf16 matmul
            library=bf16_library(xb, wb),
            cublas_f32=lambda xf=xf, wf=wf: torch.matmul(xf, wf),
            cublas_bf16=lambda xb=xb, wb=wb: torch.matmul(xb, wb),
            abs_ref=lambda xf=xf, wf=wf: xf.abs().double() @ wf.abs().double(),
            bound=bound_ms(4 * m * k + code_bytes(k, n, bits) + 4 * m * n, 2 * m * k * n,
                           BF16_FLOPS_PER_S),
            main=label == f"lm ffn_in M={SLOTS}",
            plan=stream_plan(m, n, k, sm.STAGE_K)[:2], split="split" in label,
            also=label in ("vgg head M=256", f"{big}^3 fsr1 b4"),
        ))
    return cases


def ws_cases(rng, dev):
    """K10 binary_gemm_ws, K11 dorefa_gemm_ws and K12 shift_gemm_ws: the
    JAX tests' shapes (tests/test_kernels.py:53-62, 111-124, 172-180), the
    headline's 4096^3 (the main row), one served conv as im2col, and edges
    (M = 1, M = 64 R + 1 for the default R, N = 130, K = 300 off the group,
    every m_tiles, all-zero activations). Same dicts as :func:`log_cases`
    (``abs_ref``, ``cublas_f32`` and ``cublas_bf16`` for K12)."""
    import torch

    from pytorch_quantize_impls_tpu_torch import ops
    from pytorch_quantize_impls_tpu_torch.kernels import packed_matmul as pm
    from pytorch_quantize_impls_tpu_torch.kernels import shift_matmul as sm
    from pytorch_quantize_impls_tpu_torch.kernels import xnor_gemm as bg
    from pytorch_quantize_impls_tpu_torch.kernels.common import (
        WS_DEFAULT_M_TILES, WS_M_TILES, binary_ws_plan)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def normal(*shape):
        return t(rng.normal(size=shape).astype(np.float32))

    def shapes(kernel, im2col):
        """(label, M, K, N, m_tiles, zero activations)"""
        r, big = WS_DEFAULT_M_TILES[kernel], HEADLINE_SHAPE
        return ([("jax test 64x128x128", 64, 128, 128, None, False),
                 ("jax test 300x2100x260", 300, 2100, 260, None, False),
                 (f"main {big}^3", big, big, big, None, False), (*im2col, None, False),
                 ("edge M=1 K=1000 N=64", 1, 1000, 64, None, False),
                 (f"edge M={64 * r + 1} K=300 N=130", 64 * r + 1, 300, 130, None, False),
                 ("edge zeros M=200 K=300 N=130", 200, 300, 130, None, True)]
                + [(f"edge M=257 K=2100 N=130 m_tiles={mt}", 257, 2100, 130, mt, False)
                   for mt in WS_M_TILES])

    def int_mm(m, k, n):  # torch._int_mm's shape rules
        return m > 16 and k % 8 == 0 and n % 8 == 0

    cases = []
    # K10: with alpha and row scale except at the main and im2col rows, whose
    # library call (_int_mm on K2's output) computes the unscaled product
    for label, m, k, n, mt, zeros in shapes("binary_gemm_ws", (
            "bnn_lenet conv2 im2col b=16", 16 * 8 * 8, 25 * WIDTH, 2 * WIDTH)):
        plan = binary_ws_plan(WS_DEFAULT_M_TILES["binary_gemm_ws"] if mt is None else mt)
        x = bg.binarize_to_int8(normal(m, k)) * (0 if zeros else 1)
        wp = bg.pack_binary_weights(normal(k, n))
        scaled = not (label.startswith("main") or "im2col" in label)
        alpha = t(rng.uniform(0.5, 1.5, n).astype(np.float32)) if scaled else None
        row = t(rng.uniform(0.5, 1.5, m).astype(np.float32)) if scaled else None
        lib = not scaled and int_mm(m, k, n)
        w8 = bg.decode_binary_weights(wp)[:k].contiguous() if lib else None
        cases.append(dict(
            kernel="binary_gemm_ws", label=label,
            fn=lambda x=x, wp=wp, a=alpha, r=row, mt=mt: bg.binary_gemm_ws(x, wp, a, r, m_tiles=mt),
            plain=lambda x=x, wp=wp, a=alpha, r=row: bg.binary_gemm_ws_reference(x, wp, a, r),
            library=(lambda x=x, w=w8: torch._int_mm(x, w)) if lib else None,
            bound=gemm_bound(m, k, n, code_bytes(k, n, 1), 4 * (n + m) if scaled else 0),
            main=label.startswith("main"), tile=(plan["bm"], plan["bn"]),
        ))
    # K11: w2a2 and w4a4 at the JAX tests' shapes, w1a2, w2a2 and w4a4 at
    # the edges (K 1000, 300 and 2100: off the 128-deep stage, the 16-byte
    # pitch and the group), w4a4 elsewhere
    w = RESNET_WIDTH
    k11 = []
    for label, m, k, n, mt, zeros in shapes("dorefa_gemm_ws", (
            f"resnet im2col stage1 conv1 b={RESNET_IM2COL_BATCH}",
            RESNET_IM2COL_BATCH * 16 * 16, 9 * w, 2 * w)):
        bits = (((2, 2), (4, 4)) if label.startswith("jax")
                else ((1, 2), (2, 2), (4, 4)) if label.startswith("edge") else ((4, 4),))
        k11 += [(f"{label} w{wb}a{ab}", m, k, n, mt, zeros, wb, ab) for wb, ab in bits]
    for label, m, k, n, mt, zeros, wb, ab in k11:
        a = t(rng.integers(0, 2**ab, size=(m, k)).astype(np.int8)) * (0 if zeros else 1)
        wp = pm.pack_dorefa_weights(ops.dorefa_weight(normal(k, n), wb), wb)
        lib = int_mm(m, k, n)
        w8 = pm.decode_dorefa_weights(wp, w_bits=wb)[:k].contiguous() if lib else None
        cases.append(dict(
            kernel="dorefa_gemm_ws", label=label,
            fn=lambda a=a, wp=wp, wb=wb, ab=ab, mt=mt: pm.dorefa_gemm_ws(
                a, wp, w_bits=wb, a_bits=ab, m_tiles=mt),
            plain=lambda a=a, wp=wp, wb=wb, ab=ab: pm.dorefa_gemm_ws_reference(
                a, wp, w_bits=wb, a_bits=ab),
            library=(lambda a=a, w8=w8: torch._int_mm(a, w8)) if lib else None,
            bound=gemm_bound(m, k, n, code_bytes(k, n, wb), 0), main=label.startswith("main"),
        ))
    # K12: (fsr 1, bits 4) and (fsr 0, bits 3) at the JAX tests' shapes, the
    # headline's (1, 4) at 4096^3, logquant_vgg's conv3 as im2col
    k12 = []
    for label, m, k, n, mt, zeros in shapes("shift_gemm_ws", (
            f"vgg im2col conv3 b={VGG_IM2COL_BATCH}", VGG_IM2COL_BATCH * 16 * 16, 9 * 256, 256)):
        pairs = ((1.0, 4), (0.0, 3)) if label.startswith("jax") else ((1.0, 4),)
        k12 += [(f"{label} fsr{fsr:g} b{bits}", m, k, n, mt, zeros, fsr, bits)
                for fsr, bits in pairs]
    for label, m, k, n, mt, zeros, fsr, bits in k12:
        x = normal(m, k) * (0 if zeros else 1)
        wp = sm.pack_log_weights(normal(k, n) * np.float32((2.0 / k) ** 0.5), fsr, bits)
        wb = sm.decode_log_weights(wp, fsr=fsr, bits=bits)[:k].contiguous()
        xb = x.to(torch.bfloat16)
        xf, wf = xb.to(torch.float32), wb.to(torch.float32)
        cases.append(dict(
            kernel="shift_gemm_ws", label=label,
            fn=lambda x=x, wp=wp, f=fsr, b=bits, mt=mt: sm.shift_gemm_ws(
                x, wp, fsr=f, bits=b, m_tiles=mt),
            plain=lambda x=x, wp=wp, f=fsr, b=bits: sm.shift_gemm_ws_reference(
                x, wp, fsr=f, bits=b),
            library=bf16_library(xb, wb),
            cublas_f32=lambda xf=xf, wf=wf: torch.matmul(xf, wf),
            cublas_bf16=lambda xb=xb, wb=wb: torch.matmul(xb, wb),
            abs_ref=lambda xf=xf, wf=wf: xf.abs().double() @ wf.abs().double(),
            bound=bound_ms(4 * m * k + code_bytes(k, n, bits) + 4 * m * n, 2 * m * k * n,
                           BF16_FLOPS_PER_S),
            main=label.startswith("main"),
        ))
    return cases


def probe_cases(rng, dev):
    """P1 tiled_mm for each dtype at 256x512x256 and at 4096^3 over every
    tiling: bf16 within SHIFT_RTOL * (|x| @ |w|) (the tensor cores' float32
    sum), int8 and int4 bit for bit. The int8 case at 4096^3 and the default
    tiles is the main row; the bf16 and int4 ones are timed beside it."""
    import torch

    from pytorch_quantize_impls_tpu_torch.bench import mxu_probe as mp

    cases = []
    for m, k, n in ((256, 512, 256), (HEADLINE_SHAPE,) * 3):
        ops_by_dtype = mp.operands(m, n, k, dev, seed=int(rng.integers(2**31)))
        for dt, (x, w) in ops_by_dtype.items():
            lib = mp.library_call(dt, x, w)
            if dt == "bf16":
                xf, wf = x.to(torch.float32), w.to(torch.float32)
            nbytes = x.numel() * x.element_size() + w.numel() * w.element_size() + 4 * m * n
            rate = BF16_FLOPS_PER_S if dt == "bf16" else INT8_OPS_PER_S
            for tiles in mp.TILES:
                default = tiles == mp.TILES[0]
                case = dict(
                    kernel="tiled_mm", label=f"{dt} {m}x{k}x{n} tiles {tiles[0]}x{tiles[1]}",
                    fn=lambda x=x, w=w, tl=tiles, i4=dt == "int4": mp.tiled_mm(
                        x, w, tiles=tl, int4=i4),
                    plain=lambda x=x, w=w, i4=dt == "int4": mp.tiled_mm_reference(x, w, int4=i4),
                    library=lib, bound=bound_ms(nbytes, 2 * m * k * n, rate),
                    main=default and dt == "int8" and m == HEADLINE_SHAPE,
                    timed=default, also=default and m == HEADLINE_SHAPE and dt != "int8",
                )
                if dt == "bf16":
                    case["abs_ref"] = lambda x=x, w=w: x.double().abs() @ w.double().abs()
                    case["cublas_bf16"] = lambda x=x, w=w: torch.matmul(x, w)
                    case["cublas_f32"] = lambda xf=xf, wf=wf: torch.matmul(xf, wf)
                cases.append(case)
    return cases


def bf16_library(xb, wb):
    """The library call of the bf16 GEMMs (K8, K12, P1 bf16): torch.mm of the
    bf16 operands with a float32 output, the same function in one call; bf16
    torch.matmul where this torch lacks that overload (a yardstick only)."""
    import torch

    from pytorch_quantize_impls_tpu_torch.bench import common

    if common.mm_f32_out_supported(xb.device):
        return lambda: torch.mm(xb, wb, out_dtype=torch.float32)
    return lambda: torch.matmul(xb, wb)


def sdpa_yardstick(args):
    """No one PyTorch call computes decode attention over int8 codes and
    scales. As a labelled yardstick only: scaled_dot_product_attention over
    K/V dequantized to float32 beforehand (outside the timed call)."""
    import torch
    import torch.nn.functional as F

    q, kc, ks, vc, vs, bias = args
    kf = kc.to(torch.float32) * ks[..., None]
    vf = vc.to(torch.float32) * vs[..., None]
    mask = bias[:, None, None, :]
    return lambda: F.scaled_dot_product_attention(q[:, :, None, :], kf, vf, attn_mask=mask)[:, :, 0]


def hold(kernel: str, label: str, fn, plain, abs_ref=None):
    """Compare ``fn()`` with ``plain()`` on the card and fail on a
    mismatch: K4 within ``rtol 1e-5, atol 1e-5 * max|plain|`` (float32 sums
    over up to 1024 positions in another order; exp carries an ulp of a
    score near 20, 2e-6, into every probability); where ``abs_ref`` is given
    (K8, K12, P1 bf16) within ``SHIFT_RTOL * abs_ref()`` per element; K9 bit
    for bit as int16 patterns; anything else bit for bit. K4, the
    ``abs_ref`` kernels and the bit-exact ones must also give the same bits
    twice. Returns (max |err|, verdict)."""
    import torch

    got, ref = fn(), plain()
    torch.cuda.synchronize()
    if got.shape != ref.shape or got.dtype != ref.dtype:
        fail(f"{kernel} {label}: {got.dtype} {tuple(got.shape)} vs plain "
             f"{ref.dtype} {tuple(ref.shape)}")
    err = (got.double() - ref.double()).abs().max().item()
    if kernel == "decode_attention":
        scale = ref.abs().max().item()
        if not torch.allclose(got, ref, rtol=1e-5, atol=1e-5 * scale):
            fail(f"{kernel} {label}: max |err| {err} beyond 1e-5 of max |plain| {scale}")
        if not torch.equal(got, fn()):
            fail(f"{kernel} {label}: two launches gave different bits")
        return err, f"max |err| {err:.3g} (of {scale:.3g}), deterministic"
    if abs_ref is not None:
        bound = abs_ref()
        ratio = ((got.double() - ref.double()).abs() / bound.clamp_min(1e-300)).max().item()
        if not ((got.double() - ref.double()).abs() <= SHIFT_RTOL * bound).all():
            fail(f"{kernel} {label}: |err| / (|bf16(x)| @ |w|) reaches {ratio:.3g}, beyond "
                 f"{SHIFT_RTOL}")
        if not torch.equal(got, fn()):
            fail(f"{kernel} {label}: two launches gave different bits")
        return err, f"max |err| {err:.3g}, largest |err| / (|x|@|w|) {ratio:.3g}, deterministic"
    if kernel == "decode_log_weights":
        if not torch.equal(got.view(torch.int16), ref.view(torch.int16)):
            n = int((got.view(torch.int16) != ref.view(torch.int16)).sum())
            fail(f"{kernel} {label}: {n} bf16 patterns differ from its plain version")
        return err, "bit-equal (int16 patterns)"
    if not torch.equal(got, ref):
        fail(f"{kernel} {label}: differs from its plain version, max |err| {err}")
    if not torch.equal(got, fn()):
        fail(f"{kernel} {label}: two launches gave different bits")
    return err, "bit-equal"


def check_kernels(card: str, timed: bool = True):
    """Compare every kernel with its plain version on the card (:func:`hold`):
    K1-K3, K5-K7, K10, K11 and P1 int8/int4 bit for bit, K9 bit for bit as
    int16 patterns, K4 within a float32 tolerance, K8, K12 and P1 bf16
    within ``SHIFT_RTOL * (|bf16(x)| @ |w|)`` per element and deterministic.
    The timed rows' device times (torch.profiler) are read last, after every
    CUDA-event and host-clock time: once a profiler session has run, every
    later launch in the process costs the host several us more. Returns
    {kernel: summary for the JSON line}."""
    dev = cuda()
    rng = np.random.default_rng(SEED)
    summary = {}
    # the packed conv stage's cases draw from their own stream, so the other
    # cases keep their data
    cases = (kernel_cases(rng, dev) + kbit_cases(rng, dev) + log_cases(rng, dev)
             + ws_cases(rng, dev) + probe_cases(rng, dev)
             + fused_conv_cases(np.random.default_rng(SEED + 13), dev)
             + threshold_cases(np.random.default_rng(SEED + 14), dev)
             + digits_conv_cases(np.random.default_rng(SEED + 15), dev))
    deferred = []  # timed rows awaiting their device time
    for c in cases:
        kernel, label, fn, plain = c["kernel"], c["label"], c["fn"], c["plain"]
        err, verdict = hold(kernel, label, fn, plain, c.get("abs_ref"))
        s = summary.setdefault(kernel, {"max_abs_err": 0.0})
        s["max_abs_err"] = max(s["max_abs_err"], err)
        if "plan" in c:  # K1, K3, K6, K8: the launch plan (BM, splits over K)
            if c["split"] and c["plan"][1] == 1:
                fail(f"{kernel} {label}: the launch plan does not split K")
            verdict += f", plan BM {c['plan'][0]} S {c['plan'][1]}"
        if "tile" in c:  # K5: the output tile (pixels x channels); K10: rows x columns
            verdict += f", tile {c['tile'][0]}x{c['tile'][1]}"
        if "slab" in c:  # K5's packed stage: the slab's packed groups, shared memory
            verdict += f", slab {c['slab'][0]} groups, {c['slab'][1]} B, route {c['route']}"
        if "attn_plan" in c:  # K4: blocks per (b, h) cluster, rows per block, grid
            p = c["attn_plan"]
            verdict += f", plan C {p['clusters']} chunk {p['chunk']} blocks {p['blocks']}"
        line = f"check {kernel:22s} {label:32s} {verdict}"
        if not (timed and c.get("timed", not label.startswith("edge"))):
            print(line, flush=True)
            continue
        bms, by = c["bound"]
        record = dict(ms=cuda_ms(fn), plain_ms=cuda_ms(plain), bound_ms=bms, bound_by=by,
                      library_ms=cuda_ms(c["library"]) if c["library"] else None)
        tail = ""
        if "plan" in c:
            record["plan"] = {"bm": c["plan"][0], "splits": c["plan"][1]}
        if "tile" in c:
            record["tile"] = {"bm": c["tile"][0], "bn": c["tile"][1]}
        if "attn_plan" in c:
            record["plan"] = {k: c["attn_plan"][k] for k in ("clusters", "chunk", "blocks")}
        if c.get("host", c["main"]) and "plan" in c:
            record["host_us"] = host_us(fn)
            tail += f"  host {record['host_us']:.2f} us/call (CPU clock, 2000 calls)"
        if "two_launch" in c:  # the packed conv's other route: K2 or K7, then the raw K5
            record["two_launch_ms"] = cuda_ms(c["two_launch"])
            record["route"] = c["route"]
        if "scale_where" in c:  # K5's threshold epilogue against scale + a torch.where
            record["scale_where_ms"] = cuda_ms(c["scale_where"])
        if "sdpa" in c:
            sdpa_ms = cuda_ms(c["sdpa"])
            yard_err = (c["sdpa"]() - plain()).abs().max().item()
            tail += (f"  [yardstick: SDPA on dequantized f32 K/V {sdpa_ms:.4f} ms, "
                     f"max |diff| {yard_err:.3g}; full-cache bound "
                     f"{c['full_bound'][0]:.4f} ms]")
            record["sdpa_dequantized_ms"] = sdpa_ms
        if "cublas_f32" in c:
            f32_ms = cuda_ms(c["cublas_f32"])
            tail += f"  [yardstick: cuBLAS f32 matmul of the bf16 values {f32_ms:.4f} ms]"
            record["cublas_f32_ms"] = f32_ms
        if "cublas_bf16" in c:
            bf16_ms = cuda_ms(c["cublas_bf16"])
            tail += f"  [yardstick: cuBLAS bf16 matmul (bf16 out) {bf16_ms:.4f} ms]"
            record["cublas_bf16_ms"] = bf16_ms
        deferred.append((c, line, tail, record, s))
    for c, line, tail, record, s in deferred:
        dev_ms = kernel_device_ms(c["fn"], c["kernel"])
        record["device_ms"] = dev_ms
        if "two_launch" in c:
            two = launches_device_ms(c["two_launch"])
            record["two_launch_device_ms"] = two
            tail += (f"  [two launches (decode + raw K5): {record['two_launch_ms']:.4f} ms (device "
                     f"{'not measured' if two is None else f'{two:.4f} ms'}); route "
                     f"{c['route']}]")
        if "scale_where" in c:
            sw = launches_device_ms(c["scale_where"])
            record["scale_where_device_ms"] = sw
            tail += (f"  [scale epilogue + torch.where: {record['scale_where_ms']:.4f} ms (device "
                     f"{'not measured' if sw is None else f'{sw:.4f} ms'})]")
        lib_ms = record["library_ms"]
        print(f"{line}  kernel {record['ms']:.4f} ms (device "
              f"{'not measured' if dev_ms is None else f'{dev_ms:.4f} ms'})  plain "
              f"{record['plain_ms']:.4f} ms  bound {record['bound_ms']:.4f} ms "
              f"({record['bound_by']})  library {'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}"
              f"{tail}  [{card}]", flush=True)
        if c["main"]:
            s.update(shape=c["label"], **record)
        elif c.get("also"):  # timed beside the main row, in its JSON row
            s.setdefault("also", {})[c["label"]] = record
    if timed:
        print(launch_floor(card), flush=True)
    return summary


def launch_floor(card: str) -> str:
    """The card's launch floor: the device time of the smallest launch, a
    one-element in-place add, read as the kernels' device times are (after
    every CUDA-event time) -- what no kernel's device time can beat."""
    import torch

    x = torch.zeros(1, device=cuda())
    per_call, _ = device_times(lambda: x.add_(1), iters=100)
    got = list(per_call.values())
    if len(got) != 1:
        return f"launch floor: device time not measured ({len(got)} kernels seen)  [{card}]"
    ms, n = got[0]
    return (f"launch floor: one-element add_ {ms / n:.5f} ms device per launch "
            f"(torch.profiler, 100 launches)  [{card}]")


# --- main path 1: BNN LeNet -------------------------------------------------


def seeded_variables(width: int, rng) -> dict:
    """BNN LeNet variables in the JAX package's (flax) layout, as numpy.
    BatchNorm statistics are set to the scale of each layer's output (an
    integer sum of cin*kh*kw or K terms of ±1) so every sign sees a spread
    of values around its threshold."""
    w = width

    def normal(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    def bn(c, fan_in):
        return (
            {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32), "bias": normal(c, scale=0.1)},
            {"mean": normal(c, scale=0.2 * np.sqrt(fan_in)),
             "var": (fan_in * rng.uniform(0.5, 2.0, c)).astype(np.float32)},
        )

    p, s = {}, {}
    p["conv1"] = {"conv": {"kernel": normal(5, 5, 1, w, scale=0.2)}}
    p["bn1"], s["bn1"] = bn(w, 25)
    p["conv2"] = {"conv": {"kernel": normal(5, 5, w, 2 * w, scale=0.05)}}
    p["bn2"], s["bn2"] = bn(2 * w, 25 * w)
    p["fc1"] = {"dense": {"kernel": normal(32 * w, 8 * w, scale=0.02)}}
    p["bn3"], s["bn3"] = bn(8 * w, 32 * w)
    p["head"] = {"dense": {"kernel": normal(8 * w, 10, scale=0.03)}}
    return {"params": p, "batch_stats": s}


def serve(submit, n: int):
    """Call ``submit(i)`` for i < n from CLIENTS threads with small random
    gaps; return the futures' results in order."""
    answers = [None] * n
    errors = []

    def client(idx):
        r = np.random.default_rng(SEED + 1 + idx[0])
        try:
            futs = []
            for i in idx:
                futs.append((i, submit(i)))
                time.sleep(r.uniform(0, 1e-3))
            for i, f in futs:
                answers[i] = f.result(timeout=300)
        except Exception as e:  # reported by the caller
            errors.append(e)

    threads = [threading.Thread(target=client, args=(list(range(c, n, CLIENTS)),))
               for c in range(CLIENTS)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
        if th.is_alive():
            fail("a client thread did not finish")
    if errors:
        fail(f"a request failed: {errors[0]!r}")
    return answers


def serve_rounds(submit, n: int):
    """Call ``submit(i)`` for i < n in rounds of the largest bucket, each
    round submitted at once and answered before the next: full batches for
    an engine whose deadline outlasts a round's submissions. Returns the
    results in order."""
    answers = []
    for lo in range(0, n, BUCKETS[-1]):
        futs = [submit(i) for i in range(lo, min(lo + BUCKETS[-1], n))]
        answers += [f.result(timeout=300) for f in futs]
    return answers


def all_kernels():
    """Every kernel wrapper of the port, K1-K12 and P1, in the JSON line's
    order."""
    from pytorch_quantize_impls_tpu_torch.bench import mxu_probe as mp
    from pytorch_quantize_impls_tpu_torch.kernels import decode_attention as da
    from pytorch_quantize_impls_tpu_torch.kernels import int8_conv as ic
    from pytorch_quantize_impls_tpu_torch.kernels import int8_matmul as im
    from pytorch_quantize_impls_tpu_torch.kernels import packed_matmul as pm
    from pytorch_quantize_impls_tpu_torch.kernels import shift_matmul as sm
    from pytorch_quantize_impls_tpu_torch.kernels import xnor_gemm as bg

    return (bg.binary_gemm, bg.decode_binary_weights, im.int8_gemm, da.decode_attention,
            ic.int8_conv2d, pm.dorefa_gemm, pm.decode_dorefa_weights, sm.shift_gemm,
            sm.decode_log_weights, bg.binary_gemm_ws, pm.dorefa_gemm_ws, sm.shift_gemm_ws,
            mp.tiled_mm)


def zero_launches() -> None:
    from pytorch_quantize_impls_tpu_torch.kernels import int8_conv as ic

    for k in all_kernels():
        k.launches = 0
    ic.int8_conv2d.packed_launches = 0
    ic.int8_conv2d.epilogue_launches = dict.fromkeys(ic.EPILOGUES, 0)


def read_launches(path: str, required) -> dict:
    """Every kernel's count since zero_launches, and K5's launches with the
    packed weight stage (``int8_conv2d.packed``) and by epilogue
    (``int8_conv2d.threshold`` ...), all counted in ``int8_conv2d`` too;
    each kernel in ``required`` (the path's) must be > 0."""
    import torch

    from pytorch_quantize_impls_tpu_torch.kernels import int8_conv as ic

    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in all_kernels()}
    launches["int8_conv2d.packed"] = ic.int8_conv2d.packed_launches
    launches.update({f"int8_conv2d.{e}": n for e, n in ic.int8_conv2d.epilogue_launches.items()})
    print(f"launches on the {path} path: {launches}", flush=True)
    for k in required:
        if launches[k.__name__] <= 0:
            fail(f"kernel {k.__name__} was not launched on the {path} path")
    return launches


def drive_main_path(card: str, model, example_shape, inputs, label: str = "bnn_lenet",
                    artifact: str = None, rounds: bool = False, dtype=None):
    """The main path, from a packed model to served answers: save_packed ->
    load_packed -> InferenceEngine (unprepared artifact) -> prepare ->
    InferenceEngine (prepared artifact); with ``artifact``, load_packed of
    that file instead of the model's own pack. The requests come from
    CLIENTS threads, or with ``rounds`` in rounds of the largest bucket
    (serve_rounds); ``dtype`` is the engines' input dtype (float32 unless
    given). The kernels' launch counters are zeroed just before and read
    just after. Returns (loaded artifact, engine answers and logged (batch,
    output) pairs per artifact, launch counts)."""
    from pytorch_quantize_impls_tpu_torch import infer
    from pytorch_quantize_impls_tpu_torch.kernels import int8_conv as ic
    from pytorch_quantize_impls_tpu_torch.kernels import int8_matmul as im
    from pytorch_quantize_impls_tpu_torch.kernels import xnor_gemm as bg
    from pytorch_quantize_impls_tpu_torch.serve import InferenceEngine

    dev = cuda()
    # conv2 runs K2 + K5, fc1 and head K1 (unprepared) or K3 (prepared)
    kernels = (bg.binary_gemm, bg.decode_binary_weights, im.int8_gemm, ic.int8_conv2d)
    logs = {"unprepared": [], "prepared": []}
    answers = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = artifact or os.path.join(tmp, f"{label}.npz")
        if artifact is None:
            infer.save_packed(path, infer.pack_model(model))
        zero_launches()
        loaded = infer.load_packed(path, device=dev)
        for name in ("unprepared", "prepared"):
            if name == "unprepared":
                recs = loaded
            else:
                before = bg.decode_binary_weights.launches
                recs = infer.prepare(loaded)
                k2_prepare = bg.decode_binary_weights.launches - before

            def forward(x, recs=recs, log=logs[name]):
                y = infer.packed_apply(model, recs, x)
                log.append((x.clone(), y.clone()))
                return y

            delay = {"max_delay_ms": 1000.0} if rounds else {}
            if dtype is not None:
                delay["dtype"] = dtype
            engine = InferenceEngine(forward, example_shape, batch_sizes=BUCKETS, device=dev,
                                     **delay)
            try:
                engine.warmup()
                answers[name] = (serve_rounds if rounds else serve)(
                    lambda i: engine.submit(inputs[i]), len(inputs))
            finally:
                engine.shutdown()
            st = engine.stats
            print(f"engine[{name}]: {st.requests} requests in {st.batches} batches, "
                  f"mean batch {st.mean_batch_size:.2f}, mean latency "
                  f"{st.mean_latency_ms:.3f} ms  [{card}]", flush=True)
            if st.requests != len(inputs):
                fail(f"engine[{name}] answered {st.requests} of {len(inputs)}")
            if name == "unprepared":  # one conv2 (K5) per forward
                unprepared_forwards = ic.int8_conv2d.launches
        launches = read_launches(label, kernels)
    # conv1 (real inputs) decodes its weights (K2) on every unprepared
    # forward; conv2 launches K2 only where its route is two launches
    decoded = launches["int8_conv2d"] - launches["int8_conv2d.packed"]
    want = unprepared_forwards + decoded + k2_prepare
    print(f"{label}: conv2 ran {launches['int8_conv2d']} times, "
          f"{launches['int8_conv2d.packed']} fused (no decoder), {decoded} as K2 + raw K5; K2 "
          f"launches {launches['decode_binary_weights']} = {unprepared_forwards} conv1 "
          f"(unprepared) + {decoded} conv2 + {k2_prepare} in prepare() (parent: 282 on this path, conv2 decoded every call)", flush=True)
    if launches["decode_binary_weights"] != want:
        fail(f"{label}: K2 launched {launches['decode_binary_weights']} times, expected {want}: "
             f"a fused conv2 launched its decoder")
    return loaded, answers, logs, launches


def conv_routes(forward, x) -> list:
    """The route of every packed conv call in one ``forward(x)``: (input
    shape, cin, cout, kernel size, strides, route), read by wrapping
    ``kernels.conv.packed_conv_route``."""
    import torch

    from pytorch_quantize_impls_tpu_torch.kernels import conv as kconv

    seen = []
    route_of = kconv.packed_conv_route

    def logged(x_shape, pw, strides, pads):
        route = route_of(x_shape, pw, strides, pads)
        seen.append((tuple(x_shape), pw.cin, pw.cout, tuple(pw.kernel_size), tuple(strides), route))
        return route

    kconv.packed_conv_route = logged
    try:
        with torch.inference_mode():
            forward(x)
    finally:
        kconv.packed_conv_route = route_of
    return seen


def print_routes(card: str, label: str, forward, example_shape) -> dict:
    """Print the route of every packed conv of ``forward`` at each bucket
    size (distinct convs with their call counts); fail unless every conv is
    fused at b = 1. Returns {b: routes}."""
    import torch

    out = {}
    for b in BUCKETS:
        routes = conv_routes(forward, torch.zeros((b, *example_shape), device=cuda()))
        counts = {}
        for shape, cin, cout, ks, strides, route in routes:
            key = (f"{shape[1]}x{shape[2]}x{cin}->{cout} {ks[0]}x{ks[1]} s{strides[0]}", route)
            counts[key] = counts.get(key, 0) + 1
        print(f"routes {label} b={b}: " + "; ".join(
            f"{conv} {route} x{n}" for (conv, route), n in counts.items()) + f"  [{card}]",
            flush=True)
        if b == 1 and any(r[-1] != "fused" for r in routes):
            fail(f"{label}: a packed conv at b=1 is not fused")
        out[b] = [r[-1] for r in routes]
    return out


def check_main_path(model, loaded, inputs, answers, logs) -> None:
    """Every logged batch: finite (B, 10), and identical to packed_apply on
    the same batch, to the other artifact and to the fake-quant forward.
    Every answer: the row of the batch its request rode in."""
    import torch

    from pytorch_quantize_impls_tpu_torch import infer

    artifacts = {"unprepared": loaded, "prepared": infer.prepare(loaded)}
    by_input = {}
    for name in answers:
        for x, y in zip(inputs, answers[name]):
            by_input.setdefault(x.tobytes(), {})[name] = y
    matched = 0
    for name, log in logs.items():
        other = "prepared" if name == "unprepared" else "unprepared"
        for xb, yb in log:
            if yb.shape != (xb.shape[0], 10) or not torch.isfinite(yb).all():
                fail(f"engine[{name}] batch output {tuple(yb.shape)} not finite (B, 10)")
            for ref_name, ref in (
                ("packed_apply on the same batch", infer.packed_apply(model, artifacts[name], xb)),
                (f"the {other} artifact", infer.packed_apply(model, artifacts[other], xb)),
                ("the fake-quant forward", torch.no_grad()(model)(xb)),
            ):
                if not torch.equal(yb, ref):
                    fail(f"engine[{name}] batch of {xb.shape[0]} differs from {ref_name}: "
                         f"{int((yb != ref).sum())} logits")
            for x_row, y_row in zip(xb.float().cpu().numpy(), yb.float().cpu().numpy()):
                got = by_input.get(x_row.tobytes(), {}).get(name)
                if got is not None:
                    if not np.array_equal(got, y_row):
                        fail(f"engine[{name}] answer differs from its batch row")
                    matched += 1
    if matched != len(answers) * len(inputs):
        fail(f"matched {matched} of {len(answers) * len(inputs)} answers to their batches")
    print(f"checked {matched} answers against packed_apply on their padded batches; "
          f"unprepared == prepared == fake-quant on every batch", flush=True)


def main_path(card: str):
    """Build bnn_lenet at full width from seeded weights, drive the main
    path, check it, and check a small input against the CPU."""
    import torch

    from pytorch_quantize_impls_tpu_torch import infer
    from pytorch_quantize_impls_tpu_torch.utils import (
        SCHEME_CONFIGS, RunConfig, build_model, load_flax_variables,
    )

    dev = cuda()
    rng = np.random.default_rng(SEED)
    cfg = RunConfig(**SCHEME_CONFIGS["bnn_lenet"])
    model, example_shape, _ = build_model(cfg, device=dev)
    if cfg.width != WIDTH:
        fail(f"bnn_lenet width {cfg.width}, expected {WIDTH}")
    load_flax_variables(model, seeded_variables(cfg.width, rng), device=dev)
    model.eval()
    cpu_model = copy.deepcopy(model).cpu()
    inputs = [rng.normal(size=example_shape).astype(np.float32)
              for _ in range(CLIENTS * REQUESTS_PER_CLIENT)]

    loaded, answers, logs, launches = drive_main_path(card, model, example_shape, inputs)
    check_main_path(model, loaded, inputs, answers, logs)
    print_routes(card, "bnn_lenet", lambda x: infer.packed_apply(model, loaded, x), example_shape)

    # A small input on a grid where conv1 is exact in any summation order,
    # against the same model on the CPU (plain kernel versions).
    prepared = infer.prepare(loaded)
    xs = np.round(rng.normal(size=(8, *example_shape)) * 8).astype(np.float32) / 8
    gpu = infer.packed_apply(model, prepared, torch.from_numpy(xs).to(dev)).cpu()
    cpu = infer.packed_apply(cpu_model, infer.pack_model(cpu_model), torch.from_numpy(xs))
    if not torch.equal(gpu, cpu):
        fail(f"card and CPU differ on {int((gpu != cpu).sum())} of {gpu.numel()} logits")
    print("card == CPU (plain versions) on an 8-image grid input", flush=True)
    return model, prepared, example_shape, launches


def throughput(card: str, label: str, backends: dict, example_shape):
    """Engine images/s per bucket ``b`` for each backend (name -> forward),
    closed loop: an engine whose largest bucket is ``b`` serves rounds of
    exactly ``b`` requests submitted at once. Its deadline (1 s) is far
    beyond a round's submissions (which at b=256 took over 50 ms on the H100
    host), so each round is one full batch and no deadline is waited out. At
    least 100 rounds, so the p90 round time has 10 samples beyond it. Beside
    it, the forward alone on a batch of ``b`` (CUDA events)."""
    import torch

    from pytorch_quantize_impls_tpu_torch.serve import InferenceEngine

    dev = cuda()
    rng = np.random.default_rng(SEED + 100)
    for b in BUCKETS:
        xs = rng.normal(size=(b, *example_shape)).astype(np.float32)
        xb = torch.from_numpy(xs).to(dev)
        for name, forward in backends.items():
            engine = InferenceEngine(forward, example_shape, batch_sizes=(b,),
                                     max_delay_ms=1000.0, device=dev)
            try:
                engine.warmup()
                rounds = max(100, 1024 // b)
                round_ms = []
                t0 = time.perf_counter()
                for _ in range(rounds):
                    t1 = time.perf_counter()
                    futs = [engine.submit(x) for x in xs]
                    for f in futs:
                        f.result(timeout=120)
                    round_ms.append(1e3 * (time.perf_counter() - t1))
                dt = time.perf_counter() - t0
            finally:
                engine.shutdown()
            with torch.inference_mode():
                fwd_ms = cuda_ms(lambda: forward(xb), iters=20)
            p50, p90 = np.percentile(round_ms, [50, 90])
            print(f"{label} {name:16s} bucket {b:3d}: engine {rounds * b / dt:10.1f} images/s, "
                  f"round p50 {p50:.3f} ms p90 {p90:.3f} ms ({rounds} rounds in "
                  f"{engine.stats.batches} batches); forward {fwd_ms:.3f} ms "
                  f"({1e3 * b / fwd_ms:.1f} images/s)  [{card}]", flush=True)


# --- main path 2: the 1-bit transformer LM, fused decode ---------------------


def seeded_lm_variables(cfg: dict, rng) -> dict:
    """QuantTransformerLM variables in the flax layout, as numpy. Only the
    signs of the projection kernels matter (W1A1). LayerNorm scales and
    biases are spread so that each sign after a LayerNorm sees values on
    both sides; the FFN biases are on the scale of the integer sums they
    shift (sqrt(fan_in) terms of ±1), so the hidden threshold is live."""
    d, ff, vocab = cfg["d_model"], cfg["d_ff"], cfg["vocab"]

    def normal(*shape, scale=1.0):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)

    def ln():
        return {"scale": rng.uniform(0.5, 1.5, d).astype(np.float32), "bias": normal(d, scale=0.1)}

    p = {"embed": {"embedding": normal(vocab, d, scale=d ** -0.5)},
         "pos_embed": normal(cfg["max_len"], d, scale=0.02), "ln_f": ln()}
    for i in range(cfg["n_layers"]):
        p[f"block{i}"] = {
            "ln1": ln(), "ln2": ln(),
            "attn": {n: {"kernel": normal(d, d)} for n in ("q", "k", "v", "out")},
            "ffn_in": {"kernel": normal(d, ff), "bias": normal(ff, scale=0.25 * d ** 0.5)},
            "ffn_out": {"kernel": normal(ff, d), "bias": normal(d, scale=0.25 * ff ** 0.5)},
        }
    return {"params": p}


def seeded_dorefa_lm_variables(cfg: dict, rng) -> dict:
    """:func:`seeded_lm_variables` for the DoReFa scheme. DoReFa's weight
    quantizer divides by max|tanh(W)|, so the kernels' scale alone sets
    nothing: a kernel of N(0, 1) entries puts codes all over the 4-bit grid,
    and each projection output (1024 terms in [0, 1] x [-1, 1]) is ~10 wide,
    which saturates the next [0, 1] quantizer at codes 0 and 15. Here each
    kernel is N(0, 0.05^2) with its first entry set to 1, as a trained
    kernel's bell shape and outliers do: most codes fall on the two central
    levels, ±1/15, each projection's output is O(1), and the next quantizer
    sees a spread of codes. The FFN biases are on that scale."""
    v = seeded_lm_variables(cfg, rng)
    for i in range(cfg["n_layers"]):
        blk = v["params"][f"block{i}"]
        for node in (*blk["attn"].values(), blk["ffn_in"], blk["ffn_out"]):
            k = node["kernel"] * np.float32(0.05)
            k.flat[0] = 1.0
            node["kernel"] = k
        for name in ("ffn_in", "ffn_out"):
            blk[name]["bias"] = rng.normal(size=blk[name]["bias"].shape).astype(np.float32) * 0.25
    return v


def seeded_moe_lm_variables(cfg: dict, rng) -> dict:
    """:func:`seeded_lm_variables` with each block's FFN a switch MoE:
    ``moe/router`` N(0, 1/d), so that the LayerNorm's output gives router
    logits of unit spread and every expert is chosen; the stacked expert
    kernels uniform(-1, 1), whose signs are the binary experts (a uniform
    draw takes a quarter of a normal one's host time for the 2.1 GB)."""
    v = seeded_lm_variables(dict(cfg, d_ff=1), rng)
    d, e, f = cfg["d_model"], cfg["n_experts"], cfg["d_ff"]
    for i in range(cfg["n_layers"]):
        blk = v["params"][f"block{i}"]
        del blk["ffn_in"], blk["ffn_out"]
        router = rng.standard_normal((d, e), dtype=np.float32) * np.float32(d ** -0.5)
        blk["moe"] = {"router": router,
                      "wi_kernel": rng.random((e, d, f), dtype=np.float32) * 2 - 1,
                      "wo_kernel": rng.random((e, f, d), dtype=np.float32) * 2 - 1}
    return v


def build_lm(cfg: dict, seed: int, dtype=None):
    """(port QuantTransformerLM on the card, eval mode, compute ``dtype``)
    from seeded weights through the bridge."""
    from pytorch_quantize_impls_tpu_torch.models import QuantTransformerLM
    from pytorch_quantize_impls_tpu_torch.utils import load_flax_variables

    seeded = {"dorefa": seeded_dorefa_lm_variables, "log": seeded_log_lm_variables}.get(
        cfg["scheme"], seeded_lm_variables)
    if cfg.get("n_experts"):
        seeded = seeded_moe_lm_variables
    variables = seeded(cfg, np.random.default_rng(seed))
    return load_flax_variables(QuantTransformerLM(**cfg, dtype=dtype), variables,
                               device=cuda()).eval()


def logged_engine(model, dev, **backend):
    """A DecodeEngine with ``backend`` (``fused=``, ``packed=`` or neither,
    the fake-quant model) that records every batch it runs, in order:
    ("admit", slot, prompt), ("step", active mask) and after each of those
    ("batch", tokens, logits)."""
    from pytorch_quantize_impls_tpu_torch.serve import DecodeEngine

    class LoggedEngine(DecodeEngine):
        def __init__(self, *args, **kwargs):
            self.log = []
            super().__init__(*args, **kwargs)

        def _admit(self, req, slot_idx):
            self.log.append(("admit", slot_idx, req.prompt))
            super()._admit(req, slot_idx)

        def _step(self, toks, active):
            self.log.append(("step", active.clone()))
            return super()._step(toks, active)

        def _apply(self, cache, toks):
            logits, cache = super()._apply(cache, toks)
            self.log.append(("batch", toks.clone(), logits.clone()))
            return logits, cache

    return LoggedEngine(model, n_slots=SLOTS, device=dev, **backend)


def drive_decode_path(card: str, model, fms: dict, prompts):
    """The decode main path: DecodeEngine(fused=) over the int8 and the
    packed export, 64 requests each from 4 client threads. Launch counters
    of K4, K3 and K1 are zeroed just before and read just after. Returns
    {export: (answers, log, final cache)} and the launch counts."""
    from pytorch_quantize_impls_tpu_torch.kernels import decode_attention as da
    from pytorch_quantize_impls_tpu_torch.kernels import int8_matmul as im
    from pytorch_quantize_impls_tpu_torch.kernels import xnor_gemm as bg

    dev = cuda()
    kernels = (da.decode_attention, im.int8_gemm, bg.binary_gemm)
    runs = {}
    zero_launches()
    for name, fm in fms.items():
        engine = logged_engine(model, dev, fused=fm)
        t0 = time.perf_counter()
        try:
            answers = serve(lambda i: engine.submit(prompts[i], max_new=MAX_NEW), len(prompts))
        finally:
            engine.shutdown()
        dt = time.perf_counter() - t0
        st = engine.stats
        print(f"decode engine[fused {name}]: {st.requests} requests, {st.tokens} tokens in "
              f"{dt:.2f} s ({st.tokens / dt:.1f} tok/s), {st.steps} steps, mean occupancy "
              f"{st.mean_occupancy:.3f}  [{card}]", flush=True)
        if st.requests != len(prompts) or st.tokens != MAX_NEW * len(prompts):
            fail(f"decode engine[{name}] answered {st.requests} requests, {st.tokens} tokens")
        runs[name] = (answers, engine.log, engine._cache)
    launches = read_launches("decode_lm", kernels)
    return runs, launches


def _clone_cache(cache):
    return {k: _clone_cache(v) if isinstance(v, dict) else v.clone() for k, v in cache.items()}


def _pin_cursors(cache, active):
    import torch

    for key, sub in cache.items():
        if key == "pos_index":
            cache[key] = torch.where(active, sub, 0)
        else:
            sub["attn"]["index"] = torch.where(active, sub["attn"]["index"], 0)


def _insert_row(cache, one, slot: int, n: int):
    for key, sub in one.items():
        if key == "pos_index":
            cache[key][slot] = n
            continue
        for leaf, value in sub["attn"].items():
            cache[key]["attn"][leaf][slot] = n if leaf == "index" else value[0]


def replay(name: str, apply, cache, log, answers, prompts, final_cache) -> int:
    """Replay every batch an engine ran through ``apply(cache, tokens) ->
    (logits, cache)`` (a fused program's ``fused_decode_apply``, or a decode
    model's own forward or ``packed_apply``) from the fresh engine cache
    ``cache``, rebuilt the same way (prefill rows inserted at their slot,
    idle cursors pinned to 0): every batch's tokens and logits, every
    request's answer and the final cache must be the same bits. Returns the
    number of batches."""
    import torch

    owner = [None] * SLOTS  # prompt bytes of the request in each slot
    tokens = {}
    i = batches = 0
    while i < len(log):
        event, (kind, toks, logits) = log[i], log[i + 1]
        i += 2
        if kind != "batch":
            fail(f"replay[{name}]: event {event[0]} not followed by its batch")
        if event[0] == "admit":
            _, slot, prompt = event
            n = prompt.size
            want = np.zeros((1, toks.shape[1]), np.int32)
            want[0, :n] = prompt
            if not np.array_equal(toks.cpu().numpy(), want):
                fail(f"replay[{name}]: prefill batch is not the padded prompt")
            got, one = apply(None, toks)
            _insert_row(cache, one, slot, n)
            owner[slot] = prompt.tobytes()
            tokens[owner[slot]] = [int(got[0, n - 1].argmax())]
        else:
            active = event[1]
            want = [s is not None for s in owner]
            if active.tolist() != want:
                fail(f"replay[{name}]: active slots {active.tolist()} vs {want}")
            last = [tokens[s][-1] if s is not None else 0 for s in owner]
            if toks[:, 0].tolist() != last:
                fail(f"replay[{name}]: step tokens are not the slots' last tokens")
            got, cache = apply(cache, toks)
            _pin_cursors(cache, active)
            for slot, nxt in enumerate(got[:, 0].argmax(-1).tolist()):
                if owner[slot] is not None:
                    tokens[owner[slot]].append(nxt)
        if not torch.equal(got, logits):
            fail(f"replay[{name}]: batch {batches} logits differ in "
                 f"{int((got != logits).sum())} places")
        for slot, key in enumerate(owner):
            if key is not None and len(tokens[key]) >= MAX_NEW:
                owner[slot] = None
        batches += 1
    for p, a in zip(prompts, answers):
        if not np.array_equal(np.asarray(tokens[p.tobytes()], np.int32), a):
            fail(f"replay[{name}]: an engine answer differs from its replayed batches")
    for key, sub in cache.items():
        pairs = ([(key, sub, final_cache[key])] if key == "pos_index" else
                 [(f"{key}/{leaf}", v, final_cache[key]["attn"][leaf])
                  for leaf, v in sub["attn"].items()])
        for leaf, mine, theirs in pairs:
            if not torch.equal(mine, theirs):
                fail(f"replay[{name}]: final cache {leaf} differs")
    return batches


GEMM_INPUTS = ("LN1 -> QKV", "context -> out", "LN2 -> ffn_in", "hidden -> ffn_out")


def teacher_forced(card: str, model, fm, lockstep: bool):
    """The fused step against the port's fake-quant decode model
    (QuantTransformerLM decode mode) at full width, both fed the same tokens
    (the fake-quant model's greedy choice): a 64-token prefill, then 32
    steps, 8 rows. Each GEMM input's ±1 codes are captured on both sides.
    Where a layer's Q/K/V input codes agree for a position, its K/V codes and
    scales must be equal; logits of rows with no differing code must agree
    within LOGIT_TOL.

    A single flipped code (an input within ~1e-7 of zero, where the two
    LayerNorm variance formulas or attention sum orders disagree) sends a
    W1A1 slot down another path for the rest of the run. With ``lockstep``
    every call starts from the fake-quant model's cache (copied into the
    fused layout), so each step is compared on equal state and a flip
    counts only where it happens: argmax must then agree on at least 99% of
    the (step, row) pairs. Without it the run is free, and its agreement is
    reported."""
    import torch

    from pytorch_quantize_impls_tpu_torch import serve
    from pytorch_quantize_impls_tpu_torch.infer import fused_decode as fd
    from pytorch_quantize_impls_tpu_torch.nn import intercept_quant_layers

    dev = cuda()
    b, steps = 8, 32
    rng = np.random.default_rng(SEED + 7)
    toks = torch.from_numpy(rng.integers(0, LM_CFG["vocab"], (b, 64)).astype(np.int32)).to(dev)
    md = serve.decode_model(model)
    tapped = {id(getattr(blk, n) if n.startswith("ffn") else getattr(blk.attn, n))
              for blk in model.blocks() for n in ("q", "out", "ffn_in", "ffn_out")}
    fake_codes, fused_codes = [], []

    def interceptor(m, x, fake_quant_forward):
        if id(m) in tapped:
            fake_codes.append(torch.where(x >= 0, 1, -1).to(torch.int8).reshape(-1, x.shape[-1]))
        return fake_quant_forward(x)

    gemm = fd._gemm_i8

    def tap(c, w):
        fused_codes.append(c.clone())
        return gemm(c, w)

    def both(cache_f, cache_g, t):
        fake_codes.clear()
        fused_codes.clear()
        with torch.no_grad(), intercept_quant_layers(interceptor):
            ref, cache_f = md(t, cache_f)
        fd._gemm_i8 = tap
        try:
            got, cache_g = fd.fused_decode_apply(fm, cache_g, t)
        finally:
            fd._gemm_i8 = gemm
        if len(fake_codes) != len(fused_codes):
            fail(f"teacher-forced: {len(fake_codes)} vs {len(fused_codes)} GEMM inputs")
        return ref, cache_f, got, cache_g

    kv = ("k_codes", "k_scale", "v_codes", "v_scale")
    flips = kv_rows = kv_skipped = agree = total = clean_rows = 0
    first_flips = [0] * len(GEMM_INPUTS)  # flips in slots clean until that GEMM
    clean = torch.ones(b, dtype=torch.bool, device=dev)
    max_clean_err = 0.0
    ref, cf, got, cg = both(None, None, toks)
    for step in range(steps + 1):
        s = toks.shape[1] if step == 0 else 1
        cur = int(cg["pos_index"][0]) - s
        if lockstep:
            clean = torch.ones(b, dtype=torch.bool, device=dev)
        for layer in range(LM_CFG["n_layers"]):
            for j in range(len(GEMM_INPUTS)):
                bad = (fused_codes[4 * layer + j] != fake_codes[4 * layer + j]).reshape(b, s, -1)
                flips += int(bad.sum())
                first_flips[j] += int(bad[clean].sum())
                if j == 0:
                    same = ~bad.any(dim=-1)  # Q/K/V input codes of each (slot, position)
                clean &= ~bad.any(dim=-1).any(dim=-1)
            fa, ga = cf[f"block{layer}"]["attn"], cg[f"block{layer}"]["attn"]
            for name in kv:
                f = fa[name][:, cur:cur + s].transpose(1, 2)  # (b, h, s, ...)
                g = ga[name][:, :, cur:cur + s]
                eq = (f == g).reshape(b, f.shape[1], s, -1).all(dim=-1).all(dim=1)  # (b, s)
                if not eq[same].all():
                    fail(f"teacher-forced: layer {layer} {name} differs where the "
                         f"Q/K/V input codes agree")
            kv_rows += int(same.sum())
            kv_skipped += int((~same).sum())
        if step > 0:
            total += b
            agree += int((ref[:, 0].argmax(-1) == got[:, 0].argmax(-1)).sum())
            if clean.any():
                err = (ref[clean, 0] - got[clean, 0]).abs().max().item()
                max_clean_err = max(max_clean_err, err)
                if err > LOGIT_TOL:
                    fail(f"teacher-forced: step {step} logits differ by {err} in rows "
                         f"with no flipped code")
                clean_rows += int(clean.sum())
        if step == steps:
            break
        if lockstep:
            for layer in range(LM_CFG["n_layers"]):
                fa, ga = cf[f"block{layer}"]["attn"], cg[f"block{layer}"]["attn"]
                for name in kv:
                    ga[name].copy_(fa[name].transpose(1, 2))
        t = ref[:, -1].argmax(-1).to(torch.int32)[:, None]
        ref, cf, got, cg = both(cf, cg, t)
    origin = ", ".join(f"{k}: {n}" for k, n in zip(GEMM_INPUTS, first_flips))
    print(f"teacher-forced fused vs fake-quant at full width, "
          f"{'lockstep' if lockstep else 'free-running'}: {steps} steps x {b} rows, argmax "
          f"agrees on {agree}/{total} ({100 * agree / total:.2f}%); {flips} flipped ±1 codes "
          f"over all GEMM inputs, first flips by GEMM input ({origin}); K/V codes and scales "
          f"equal on {kv_rows} (layer, slot, position) rows with equal Q/K/V codes "
          f"({kv_skipped} rows had a flipped code); max |logit err| {max_clean_err:.3g} over "
          f"{clean_rows} rows with no flipped code (tolerance {LOGIT_TOL})  [{card}]", flush=True)
    if lockstep and agree < 0.99 * total:
        fail(f"teacher-forced (lockstep): argmax agrees on only {agree} of {total}")


def small_token_exact(card: str):
    """At the JAX package's fused-decode test size (seeded weights): the
    fused step and the fake-quant decode model agree within LOGIT_TOL,
    teacher-forced, and greedy generation gives the same tokens through
    serve.generate (fake-quant) and DecodeEngine(fused=)."""
    import torch

    from pytorch_quantize_impls_tpu_torch import infer, serve

    dev = cuda()
    model = build_lm(SMALL_LM_CFG, SEED)
    fm = infer.export_fused_decode(model, device=dev)
    rng = np.random.default_rng(SEED + 1)
    toks = torch.from_numpy(rng.integers(0, 128, (3, 8)).astype(np.int32)).to(dev)
    md = serve.decode_model(model)
    with torch.no_grad():
        ref, cf = md(toks)
        got, cg = infer.fused_decode_apply(fm, None, toks)
        for _ in range(7):
            err = (ref - got).abs().max().item()
            if err > LOGIT_TOL or not torch.equal(ref[:, -1].argmax(-1), got[:, -1].argmax(-1)):
                fail(f"small LM: fused vs fake-quant logits differ by {err}")
            t = ref[:, -1].argmax(-1).to(torch.int32)[:, None]
            ref, cf = md(t, cf)
            got, cg = infer.fused_decode_apply(fm, cg, t)
    prompts = [rng.integers(0, 128, (n,)).astype(np.int32) for n in (5, 9, 12)]
    engine = serve.DecodeEngine(model, fused=fm, n_slots=4, device=dev)
    try:
        fused = [engine(p, max_new=6) for p in prompts]
    finally:
        engine.shutdown()
    for p, f in zip(prompts, fused):
        want = serve.generate(model, p[None], 6, device=dev)[0].cpu().numpy()
        if not np.array_equal(f, want):
            fail(f"small LM: fused engine {f} vs fake-quant generate {want}")
    print("small LM (JAX test size): fused == fake-quant within 2e-4 for 8 teacher-forced "
          "calls; greedy tokens identical for 3 prompts  [" + card + "]", flush=True)


def decode_speed(card: str, backends: dict):
    """scripts/perf_bench.py:bench_decode's metrics on the card: 128-token
    prefill ms (b = 1) and decode tokens/s at each of DECODE_BATCHES, by
    CUDA events over N steps with the cache advancing (each step feeds the
    previous step's argmax, on the card), for each backend (name ->
    ``apply(cache, tokens) -> (logits, cache)``)."""
    import torch

    dev = cuda()
    rng = np.random.default_rng(SEED + 2)
    n_steps = 32
    profiles = []
    with torch.no_grad():
        for name, apply in backends.items():
            toks1 = torch.from_numpy(
                rng.integers(0, LM_CFG["vocab"], (1, PREFILL_LEN)).astype(np.int32)).to(dev)
            prefill_ms = cuda_ms(lambda: apply(None, toks1), iters=5, warmup=1)
            line = f"decode {name:13s}: prefill {PREFILL_LEN} tok {prefill_ms:.3f} ms"
            for b in DECODE_BATCHES:
                tb = torch.from_numpy(
                    rng.integers(0, LM_CFG["vocab"], (b, PREFILL_LEN)).astype(np.int32)).to(dev)
                logits, cache = apply(None, tb)
                t = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
                for _ in range(3):
                    logits, cache = apply(cache, t)
                    t = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(n_steps):
                    logits, cache = apply(cache, t)
                    t = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
                end.record()
                end.synchronize()
                step_ms = start.elapsed_time(end) / n_steps
                line += f"; b={b}: {step_ms:.3f} ms/step {1e3 * b / step_ms:.1f} tok/s"
                if b == DECODE_BATCHES[-1]:
                    state = {"cache": cache, "t": t}

                    def step():
                        logits, state["cache"] = apply(state["cache"], state["t"])
                        state["t"] = logits[:, -1].argmax(-1).to(torch.int32)[:, None]

                    profiles.append(f"decode {name} b={b} " + profile_line(step, "step", 8))
                    cache = state["cache"]
                del cache
            print(line + f"  [{card}]", flush=True)
    for line in profiles:
        print(line + f"  [{card}]", flush=True)


def decode_path(card: str):
    """Build the serving LM at full width, export it both ways, drive and
    replay the engine, then the seam checks and the speeds."""
    import torch

    from pytorch_quantize_impls_tpu_torch import infer
    from pytorch_quantize_impls_tpu_torch.serve import decode_model

    dev = cuda()
    t0 = time.perf_counter()
    model = build_lm(LM_CFG, SEED)
    fms = {w: infer.export_fused_decode(model, weights=w, device=dev) for w in ("int8", "packed")}
    print(f"decode LM built and exported in {time.perf_counter() - t0:.1f} s: "
          f"{torch.cuda.memory_allocated() / 2**20:.0f} MiB allocated", flush=True)
    rng = np.random.default_rng(SEED + 3)
    prompts = [rng.integers(0, LM_CFG["vocab"], rng.integers(PROMPT_LENS[0], PROMPT_LENS[1] + 1))
               .astype(np.int32) for _ in range(DECODE_REQUESTS)]
    runs, launches = drive_decode_path(card, model, fms, prompts)
    other = {"int8": "packed", "packed": "int8"}
    for name, (answers, log, final_cache) in runs.items():
        fm = fms[other[name]]
        n = replay(name, lambda c, t, fm=fm: infer.fused_decode_apply(fm, c, t),
                   infer.fused_init_cache(fm, SLOTS, device=dev), log, answers, prompts,
                   final_cache)
        print(f"replayed the fused {name} engine's {n} batches through the {other[name]} "
              f"export: same logits, tokens and final cache, bit for bit", flush=True)
        del log
    if any(not np.array_equal(a, b) for a, b in zip(runs["int8"][0], runs["packed"][0])):
        fail("the int8 and packed engines answered differently")
    del runs
    for lockstep in (True, False):
        teacher_forced(card, model, fms["int8"], lockstep)
    small_token_exact(card)
    md = decode_model(model)
    backends = {"fake-quant": lambda c, t: md(t, c)}
    for name, fm in fms.items():
        backends[f"fused {name}"] = lambda c, t, fm=fm: infer.fused_decode_apply(fm, c, t)
    decode_speed(card, backends)
    return launches, model


# --- main path 3: DoReFa ResNet-20 W4A4, packed and fused --------------------


def seeded_resnet_variables(width: int, rng, a_quant: str = "fixed") -> dict:
    """DorefaResNet20 variables in the flax layout, as numpy: He-scaled conv
    kernels, BatchNorm scales and biases by role, statistics left for
    :func:`calibrate_batchnorm`. After calibration each BatchNorm output is
    about N(bias, scale) per channel: the stem's and bn1's around 0.2-0.5
    (their relu'd output is a block conv's input on the [0, 1] grid), bn2's
    small and centred a little below 0 (it is added to the residual stream,
    which must not drift past 1 and saturate the codes), the projections'
    like the stem's. PACT clips (``a_quant="pact"``) are drawn in [1, 2]."""
    f32 = np.float32

    def normal(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(f32)

    def bn(c, gamma, beta):
        return ({"scale": rng.uniform(*gamma, c).astype(f32),
                 "bias": rng.uniform(*beta, c).astype(f32)},
                {"mean": np.zeros(c, f32), "var": np.ones(c, f32)})

    def kernel(k, cin, cout):
        return normal(k, k, cin, cout, scale=np.sqrt(2.0 / (k * k * cin)))

    w = width
    p = {"stem": {"kernel": kernel(3, 3, w)}}
    s = {}
    p["bn_stem"], s["bn_stem"] = bn(w, (0.3, 0.6), (0.2, 0.5))
    cin = w
    for stage, (f, stride) in enumerate([(w, 1), (2 * w, 2), (4 * w, 2)]):
        for b in range(3):
            bp, bs = {}, {}
            for i, c_in in ((1, cin), (2, f)):
                bp[f"conv{i}"] = {"conv": {"kernel": kernel(3, c_in, f)}}
                if a_quant == "pact":
                    bp[f"conv{i}"]["act"] = {"alpha": np.asarray(rng.uniform(1.0, 2.0), f32)}
            bp["bn1"], bs["bn1"] = bn(f, (0.3, 0.5), (0.2, 0.5))
            bp["bn2"], bs["bn2"] = bn(f, (0.1, 0.3), (-0.15, 0.05))
            if b == 0 and (stride != 1 or cin != f):
                bp["proj"] = {"kernel": kernel(1, cin, f)}
                bp["bn_proj"], bs["bn_proj"] = bn(f, (0.2, 0.4), (0.2, 0.4))
            p[f"stage{stage}_block{b}"], s[f"stage{stage}_block{b}"] = bp, bs
            cin = f
    p["head"] = {"kernel": normal(4 * w, 10, scale=(4 * w) ** -0.5), "bias": normal(10, scale=0.1)}
    return {"params": p, "batch_stats": s}


def calibrate_batchnorm(model, x) -> dict:
    """Set every BatchNorm's running statistics to the per-channel mean and
    (biased) variance of its input on ``x``, in one forward pass in order,
    so each sees inputs already normalized by the ones before it. Returns
    the statistics in the flax ``batch_stats`` layout (numpy)."""
    import torch

    from pytorch_quantize_impls_tpu_torch.models.lenet import BatchNorm

    def hook(bn, args):
        dims = tuple(range(args[0].dim() - 1))
        bn.running_mean.copy_(args[0].mean(dim=dims))
        bn.running_var.copy_(args[0].var(dim=dims, unbiased=False))

    bns = [(name, m) for name, m in model.named_modules() if isinstance(m, BatchNorm)]
    handles = [m.register_forward_pre_hook(hook) for _, m in bns]
    try:
        with torch.no_grad():
            model(x)
    finally:
        for h in handles:
            h.remove()
    stats = {}
    for name, m in bns:
        node = stats
        for part in name.split("."):
            node = node.setdefault(part, {})
        node["mean"] = m.running_mean.cpu().numpy()
        node["var"] = m.running_var.cpu().numpy()
    return stats


def calibrated_resnet(width: int, rng, x, device, a_quant: str = "fixed"):
    """(port DorefaResNet20 W4 on ``device`` in eval mode, its variables in
    the flax layout): seeded weights through the bridge, BatchNorm
    statistics calibrated on the images ``x`` (numpy NHWC)."""
    import torch

    from pytorch_quantize_impls_tpu_torch.models import DorefaResNet20
    from pytorch_quantize_impls_tpu_torch.utils import load_flax_variables

    variables = seeded_resnet_variables(width, rng, a_quant)
    model = DorefaResNet20(w_bits=4, a_bits=4, a_quant=a_quant, width=width)
    load_flax_variables(model, variables, device=device).eval()
    variables["batch_stats"] = calibrate_batchnorm(model, torch.from_numpy(x).to(device))
    return model, variables


def stage_code_histograms(model, x) -> None:
    """The codes of each stage's first block-conv input on the images ``x``
    (fake-quant forward); fail if one code holds more than 90% of them, which
    would leave the integer paths nothing to disagree on."""
    import torch

    n_a = 2**model.a_bits - 1
    seen = {}

    def hook(s):
        def fn(m, args):
            codes = torch.round(torch.clamp(args[0], 0, 1) * n_a).flatten().to(torch.int64)
            seen[s] = torch.bincount(codes, minlength=n_a + 1).cpu()
        return fn

    hooks = [getattr(model, f"stage{s}_block0").conv1.conv.register_forward_pre_hook(hook(s))
             for s in range(3)]
    try:
        with torch.no_grad():
            model(x)
    finally:
        for h in hooks:
            h.remove()
    for s, counts in sorted(seen.items()):
        share = (counts.double() / counts.sum()).tolist()
        print(f"stage{s}_block0.conv1 input code shares 0..{n_a}: "
              + " ".join(f"{v:.3f}" for v in share), flush=True)
        if max(share) > 0.9:
            fail(f"stage {s}: one code holds {max(share):.3f} of the conv inputs")


def logged_engine_class():
    """InferenceEngine that records every batch it runs after its warmup, as
    (input, output) numpy arrays; ``from_fused_resnet`` builds one too."""
    from pytorch_quantize_impls_tpu_torch.serve import InferenceEngine

    class LoggedInferenceEngine(InferenceEngine):
        def __init__(self, *args, **kwargs):
            self.log = []
            super().__init__(*args, **kwargs)

        def warmup(self):
            super().warmup()
            self.log.clear()

        def _run(self, x):
            y = super()._run(x)
            self.log.append((x, y))
            return y

    return LoggedInferenceEngine


def run_engine(card: str, label: str, engine, inputs):
    """Warm ``engine`` up, serve ``inputs`` from CLIENTS threads, shut it
    down; returns the answers."""
    try:
        engine.warmup()
        answers = serve(lambda i: engine.submit(inputs[i]), len(inputs))
    finally:
        engine.shutdown()
    st = engine.stats
    print(f"engine[{label}]: {st.requests} requests in {st.batches} batches, mean batch "
          f"{st.mean_batch_size:.2f}, mean latency {st.mean_latency_ms:.3f} ms  [{card}]",
          flush=True)
    if st.requests != len(inputs):
        fail(f"engine[{label}] answered {st.requests} of {len(inputs)}")
    return answers


def check_logged(label: str, log, inputs, answers, refs: dict) -> None:
    """Every batch the engine ran: finite (B, 10) and bit-equal to each
    forward in ``refs`` on the same batch; every answer: its batch's row."""
    import torch

    dev = cuda()
    rows = {}
    for xb, yb in log:
        if yb.shape != (xb.shape[0], 10) or not np.isfinite(yb).all():
            fail(f"engine[{label}] batch output {yb.shape} not finite (B, 10)")
        with torch.inference_mode():
            xt = torch.from_numpy(xb).to(dev)
            for name, forward in refs.items():
                ref = forward(xt).cpu().numpy()
                if not np.array_equal(yb, ref):
                    fail(f"engine[{label}] batch of {xb.shape[0]} differs from {name} in "
                         f"{int((yb != ref).sum())} logits")
        for xr, yr in zip(xb, yb):
            rows[xr.tobytes()] = yr
    for x, a in zip(inputs, answers):
        row = rows.get(x.tobytes())
        if row is None or not np.array_equal(a, row):
            fail(f"engine[{label}] answer differs from its batch row")
    print(f"engine[{label}]: {len(log)} batches bit-equal to {' and '.join(refs)} on the same "
          f"batch; {len(answers)} answers are their batch rows", flush=True)


def against_fake_quant(card: str, label: str, model, forward, xs, atol=RESNET_LOGIT_TOL,
                       rtol=0.0, rows_gated: bool = True, batch: int = RESNET_BATCH) -> None:
    """``forward`` against the fake-quant forward on the images ``xs``, in
    batches of ``batch``: argmax agreement and the row-max logit gap. A
    row is within the tolerance when every logit is within ``atol + rtol *
    |fake-quant logit|``; 99% of rows must be (unless ``rows_gated`` is off:
    then the share is reported), and argmax must agree on 99% of rows."""
    import torch

    dev = cuda()
    gaps, inside, agree = [], [], 0
    with torch.inference_mode():
        for i in range(0, len(xs), batch):
            xb = torch.from_numpy(xs[i:i + batch]).to(dev)
            ref, got = model(xb), forward(xb)
            gaps.append((got - ref).abs().amax(dim=1).cpu())
            inside.append(((got - ref).abs() <= atol + rtol * ref.abs()).all(dim=1).cpu())
            agree += int((got.argmax(1) == ref.argmax(1)).sum())
    gaps = torch.cat(gaps).double()
    n = len(xs)
    within = float(torch.cat(inside).double().mean())
    tol = f"{atol}" + (f" + {rtol} |ref|" if rtol else "")
    q50, q99 = np.quantile(gaps.numpy(), [0.5, 0.99])
    print(f"{label} vs fake-quant on {n} rows: argmax agrees on {agree}/{n}; row max |logit "
          f"gap| median {q50:.4g} p99 {q99:.4g} max {gaps.max():.4g}; {100 * within:.2f}% of "
          f"rows within {tol}  [{card}]", flush=True)
    if agree < 0.99 * n or (rows_gated and within < 0.99):
        fail(f"{label}: argmax agrees on {agree}/{n}, {100 * within:.2f}% of rows within "
             f"{tol} of the fake-quant logits")


def direct_vs_im2col(model, loaded, x) -> None:
    """The stride-2 first conv of stage 1 (JAX's (0, 1) SAME pads) on its
    real input: direct (the route conv_route picks), both routes called
    directly (the fused K5, and K7 + the raw K5) and im2col (F.unfold + K6)
    bit for bit."""
    import torch

    from pytorch_quantize_impls_tpu_torch.kernels import int8_conv as ic
    from pytorch_quantize_impls_tpu_torch.kernels import packed_matmul as pm
    from pytorch_quantize_impls_tpu_torch.kernels.conv import (
        PackedConv, conv_pads, decode_conv_weights, packed_conv2d, packed_conv_route)

    conv = model.stage1_block0.conv1.conv
    rec = loaded[("stage1_block0", "conv1", "conv")]
    kh, kw, cin, cout = rec.kernel_shape
    pc = PackedConv("dorefa", rec.packed, (kh, kw), cin, cout, None, rec.w_bits, rec.a_bits)
    seen = []
    hook = conv.register_forward_pre_hook(lambda m, args: seen.append(args[0]))
    try:
        with torch.no_grad():
            model(x)
    finally:
        hook.remove()
    xq = conv.input_quant(seen[0])
    kw_ = dict(strides=conv.strides, padding=conv.padding)
    pads = conv_pads(conv.padding, xq.shape[1:3], (kh, kw), conv.strides)
    route = packed_conv_route(xq.shape, pc, conv.strides, pads)
    direct = packed_conv2d(xq, pc, **kw_)
    codes = pm.dorefa_act_to_int8(xq, rec.a_bits)
    scale = torch.full((cout,), pm.inv_scale(rec.w_bits, rec.a_bits), dtype=torch.float32,
                       device=xq.device)
    args = ((kh, kw), tuple(conv.strides), pads, "scale", scale)
    fused = ic.int8_conv2d(codes, rec.packed, *args, w_bits=rec.w_bits)
    two = ic.int8_conv2d(codes, decode_conv_weights(pc), *args)
    im2col = packed_conv2d(xq, pc, mode="im2col", **kw_)
    for name, y in ((f"direct ({route})", direct), ("fused K5", fused), ("K7 + raw K5", two)):
        if not torch.equal(y, im2col):
            fail(f"stage1 conv1: {name} and im2col differ in {int((y != im2col).sum())} places")
    print(f"stage1_block0.conv1 (stride 2) on {x.shape[0]} images: direct ({route} route) == "
          f"fused K5 == K7 + raw K5 == im2col (F.unfold + K6), {tuple(direct.shape)}, bit for "
          f"bit", flush=True)


def resnet_path(card: str):
    """Main path 3: the DoReFa ResNet-20 W4A4 at width 64, packed
    (unprepared, then prepared) and fused, each through InferenceEngine, with
    every served batch replayed; then the seams and the speeds."""
    import torch

    from pytorch_quantize_impls_tpu_torch import infer
    from pytorch_quantize_impls_tpu_torch.kernels import int8_conv as ic
    from pytorch_quantize_impls_tpu_torch.kernels import packed_matmul as pm

    dev = cuda()
    rng = np.random.default_rng(SEED + 20)
    calib = rng.normal(size=(RESNET_CALIB, *RESNET_SHAPE)).astype(np.float32)
    model, _ = calibrated_resnet(RESNET_WIDTH, rng, calib, dev)
    stage_code_histograms(model, torch.from_numpy(calib[:64]).to(dev))
    cpu_model = copy.deepcopy(model).cpu()
    inputs = [rng.normal(size=RESNET_SHAPE).astype(np.float32)
              for _ in range(CLIENTS * REQUESTS_PER_CLIENT)]
    Logged = logged_engine_class()
    launches, answers, logs = {}, {}, {}

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "dorefa_resnet20_w64.npz")
        infer.save_packed(path, infer.pack_model(model))
        zero_launches()
        loaded = infer.load_packed(path, device=dev)
        for name in ("unprepared", "prepared"):
            if name == "unprepared":
                recs = loaded
            else:
                before = pm.decode_dorefa_weights.launches
                recs = infer.prepare(loaded)
                k7_prepare = pm.decode_dorefa_weights.launches - before
            engine = Logged(lambda x, recs=recs: infer.packed_apply(model, recs, x), RESNET_SHAPE,
                            batch_sizes=BUCKETS, device=dev)
            answers[name] = run_engine(card, f"resnet {name}", engine, inputs)
            logs[name] = engine.log
        launches["resnet_w4a4_packed"] = packed = read_launches(
            "resnet_w4a4_packed", (pm.decode_dorefa_weights, ic.int8_conv2d))
    # every K5 launch of the packed path is a packed block conv: fused, or
    # K7 + the raw K5; prepare() decodes each block conv once more
    decoded = packed["int8_conv2d"] - packed["int8_conv2d.packed"]
    print(f"resnet packed: {packed['int8_conv2d']} block conv calls, "
          f"{packed['int8_conv2d.packed']} fused (no decoder), {decoded} as K7 + raw K5; K7 "
          f"launches {packed['decode_dorefa_weights']} = {decoded} + {k7_prepare} in prepare() "
          f"(parent: 3402, every conv decoded)", flush=True)
    if packed["decode_dorefa_weights"] != decoded + k7_prepare:
        fail(f"resnet packed: K7 launched {packed['decode_dorefa_weights']} times, expected "
             f"{decoded + k7_prepare}: a fused conv launched its decoder")
    print_routes(card, "resnet packed", lambda x: infer.packed_apply(model, loaded, x),
                 RESNET_SHAPE)
    prepared = infer.prepare(loaded)
    net = infer.export_fused_resnet20(model)
    zero_launches()
    engine = Logged.from_fused_resnet(net, RESNET_SHAPE, batch_sizes=BUCKETS, device=dev)
    answers["fused"] = run_engine(card, "resnet fused", engine, inputs)
    logs["fused"] = engine.log
    launches["resnet_w4a4_fused"] = read_launches("resnet_w4a4_fused", (ic.int8_conv2d,))

    forwards = {
        "packed_apply (unprepared)": lambda x: infer.packed_apply(model, loaded, x),
        "packed_apply (prepared)": lambda x: infer.packed_apply(model, prepared, x),
    }
    check_logged("resnet unprepared", logs["unprepared"], inputs, answers["unprepared"], forwards)
    check_logged("resnet prepared", logs["prepared"], inputs, answers["prepared"], forwards)
    fused = {"fused_resnet_apply": lambda x: infer.fused_resnet_apply(net, x)}
    check_logged("resnet fused", logs["fused"], inputs, answers["fused"], fused)
    del logs
    direct_vs_im2col(model, loaded, torch.from_numpy(calib[:RESNET_IM2COL_BATCH]).to(dev))

    xs = rng.normal(size=(RESNET_EVAL, *RESNET_SHAPE)).astype(np.float32)
    against_fake_quant(card, "resnet packed", model, forwards["packed_apply (prepared)"], xs)
    against_fake_quant(card, "resnet fused", model, fused["fused_resnet_apply"], xs)

    # a small input against the same model on the CPU (plain kernel versions)
    xs = rng.normal(size=(8, *RESNET_SHAPE)).astype(np.float32)
    with torch.inference_mode():
        xt = torch.from_numpy(xs)
        pairs = {
            "packed": (infer.packed_apply(model, prepared, xt.to(dev)),
                       infer.packed_apply(cpu_model, infer.pack_model(cpu_model), xt)),
            "fused": (infer.fused_resnet_apply(net, xt.to(dev)),
                      infer.fused_resnet_apply(infer.export_fused_resnet20(cpu_model), xt)),
        }
    for name, (gpu, cpu) in pairs.items():
        gap = (gpu.cpu() - cpu).abs().max().item()
        if gap > RESNET_LOGIT_TOL or not torch.equal(gpu.argmax(1).cpu(), cpu.argmax(1)):
            fail(f"resnet {name}: card and CPU logits differ by {gap} on 8 images")
        print(f"resnet {name}: card vs CPU (plain versions) on 8 images: max |logit gap| "
              f"{gap:.4g} (tolerance {RESNET_LOGIT_TOL}), same argmax", flush=True)

    backends = {
        "packed": forwards["packed_apply (unprepared)"],
        "packed prepared": forwards["packed_apply (prepared)"],
        "fused": fused["fused_resnet_apply"],
        "fake-quant": model,
    }
    throughput(card, "resnet", backends, RESNET_SHAPE)
    for b in (1, RESNET_BATCH):
        xb = torch.from_numpy(rng.normal(size=(b, *RESNET_SHAPE)).astype(np.float32)).to(dev)
        for name, forward in backends.items():
            with torch.inference_mode():
                line = profile_line(lambda: forward(xb), "forward", 10)
            print(f"resnet {name} b={b} {line}  [{card}]", flush=True)
    return launches


# --- main path 5: log-quant VGG-small, packed --------------------------------


def seeded_vgg_variables(widths, rng) -> dict:
    """LogQuantVGGSmall variables in the flax layout, as numpy: He-scaled
    conv kernels (the exponent indices of each layer spread over several
    levels), BatchNorm scales and biases that leave each ReLU about half
    open, statistics left for :func:`calibrate_batchnorm`, and a head of
    scale 1/sqrt(fan_in) with a small bias."""
    f32 = np.float32
    p, s = {}, {}
    cin = RESNET_SHAPE[2]
    for i, w in enumerate(widths):
        kernel = rng.normal(size=(3, 3, cin, w)) * np.sqrt(2.0 / (9 * cin))
        p[f"conv{i}"] = {"conv": {"kernel": kernel.astype(f32)}}
        p[f"bn{i}"] = {"scale": rng.uniform(0.5, 1.5, w).astype(f32),
                       "bias": rng.uniform(-0.2, 0.4, w).astype(f32)}
        s[f"bn{i}"] = {"mean": np.zeros(w, f32), "var": np.ones(w, f32)}
        cin = w
    side = RESNET_SHAPE[0] // 2 ** (len(widths) // 2)
    k = side * side * cin
    p["head"] = {"dense": {"kernel": (rng.normal(size=(k, 10)) * k ** -0.5).astype(f32),
                           "bias": (rng.normal(size=10) * 0.1).astype(f32)}}
    return {"params": p, "batch_stats": s}


def calibrated_vgg(model, rng, x):
    """Load seeded variables into the port LogQuantVGGSmall ``model`` through
    the bridge (eval mode) and calibrate its BatchNorm statistics on the
    images ``x`` (numpy NHWC). Returns (model, its variables in the flax
    layout)."""
    import torch

    from pytorch_quantize_impls_tpu_torch.utils import load_flax_variables

    dev = next(model.parameters()).device
    variables = seeded_vgg_variables(model.widths, rng)
    load_flax_variables(model, variables, device=dev).eval()
    variables["batch_stats"] = calibrate_batchnorm(model, torch.from_numpy(x).to(dev))
    return model, variables


def exponent_histograms(label: str, model, min_levels: int, show=("",)) -> None:
    """Per log layer, the shares of its weights' exponent indices 0..2^bits
    (``ops.log_quant_exponent`` of the master weight), printed for the
    layers whose name starts with one of ``show``; fail unless every layer
    has at least ``min_levels`` indices holding 1% or more."""
    import torch

    from pytorch_quantize_impls_tpu_torch import ops
    from pytorch_quantize_impls_tpu_torch.nn import QuantConv, QuantDense

    fewest = None
    for name, m in model.named_modules():
        if not isinstance(m, (QuantConv, QuantDense)) or m.scheme != "log":
            continue
        _, idx = ops.log_quant_exponent(m.weight.detach(), m.fsr, m.w_bits)
        counts = torch.bincount(idx.flatten().long(), minlength=2**m.w_bits + 1).double()
        share = (counts / counts.sum()).tolist()
        live = sum(v >= 0.01 for v in share)
        fewest = live if fewest is None else min(fewest, live)
        if name.startswith(show):
            print(f"{label} {name:20s} exponent index shares 0..{2**m.w_bits}: "
                  + " ".join(f"{v:.3f}" for v in share), flush=True)
        if live < min_levels:
            fail(f"{label} {name}: only {live} exponent levels hold 1% of the weights")
    print(f"{label}: every log layer has >= {fewest} exponent levels holding 1% of its weights",
          flush=True)


def packed_words_vs_cpu(label: str, model, card_recs, cpu_recs) -> None:
    """Codes packed on the card against codes packed on the CPU from the same
    master weights: log2 may round the other way where |w| is within an ulp
    of 2^(k + 1/2). Print how many differ; fail if one is not at such a
    boundary."""
    import torch

    from pytorch_quantize_impls_tpu_torch.nn import QuantConv, QuantDense
    from pytorch_quantize_impls_tpu_torch.ops import pack as packlib

    masters = {tuple(n.split(".")): m.weight.detach().cpu() for n, m in model.named_modules()
               if isinstance(m, (QuantConv, QuantDense)) and m.scheme == "log"}
    total = differ = 0
    for path, rec in cpu_recs.items():
        w = masters[path]
        w2d = w.reshape(w.shape[0], -1).T  # (K, N) in the packed order
        k = w2d.shape[0]
        a = packlib.unpack_bitplanes(card_recs[path].packed.cpu(), 8, k)
        b = packlib.unpack_bitplanes(rec.packed, 8, k)
        bad = a != b
        total += a.numel()
        differ += int(bad.sum())
        if bad.any():
            frac = torch.log2(w2d[bad].abs().double()) % 1.0
            if ((frac - 0.5).abs() > 1e-6).any():
                fail(f"{label} {path}: a code packed on the card differs from the CPU's away "
                     f"from an exponent boundary")
    print(f"{label}: codes packed on the card and on the CPU differ in {differ} of {total} "
          f"(each at an exponent boundary)", flush=True)


def vgg_direct_vs_im2col(model, loaded, x) -> None:
    """conv3 (16x16x256 -> 256) on its real input: packed_conv2d(scheme=
    "log") direct (K9 + float conv) against im2col (F.unfold + K8), within
    SHIFT_RTOL of |bf16(x)| conv |w|: both round x to bf16, only the float32
    sums differ."""
    import torch

    from pytorch_quantize_impls_tpu_torch.kernels.conv import (
        PackedConv, conv2d_nhwc, decode_conv_weights, packed_conv2d,
    )

    conv = model.conv3.conv
    rec = loaded[("conv3", "conv")]
    kh, kw, cin, cout = rec.kernel_shape
    pc = PackedConv("log", rec.packed, (kh, kw), cin, cout, None, rec.w_bits, 0, rec.fsr)
    seen = []
    hook = conv.register_forward_pre_hook(lambda m, args: seen.append(args[0]))
    try:
        with torch.no_grad():
            model(x)
    finally:
        hook.remove()
    xin = seen[0]
    kw_ = dict(strides=conv.strides, padding=conv.padding)
    with torch.no_grad():
        direct = packed_conv2d(xin, pc, **kw_)
        im2col = packed_conv2d(xin, pc, mode="im2col", **kw_)
        w = decode_conv_weights(pc).double().abs().T.reshape(cout, cin, kh, kw)
        bound = conv2d_nhwc(xin.to(torch.bfloat16).double().abs(), w, conv.strides, conv.padding)
    diff = (direct.double() - im2col.double()).abs()
    ratio = (diff / bound.clamp_min(1e-300)).max().item()
    if (diff > SHIFT_RTOL * bound).any():
        fail(f"vgg conv3: direct and im2col differ by {ratio:.3g} of |x| conv |w|")
    print(f"vgg conv3 on {x.shape[0]} images: direct (K9 + conv) vs im2col (F.unfold + K8) "
          f"{tuple(direct.shape)}, max |diff| {diff.max().item():.3g}, largest |diff| / "
          f"(|bf16(x)| conv |w|) {ratio:.3g} (tolerance {SHIFT_RTOL})", flush=True)


def vgg_unprepared_vs_prepared(card: str, model, records, xs) -> None:
    """The convs of both paths run the same float conv on the same K9
    weights, so the head sees the same input h; the unprepared head rounds h
    to bf16 (K8), the prepared one does not: per logit within
    (BF16_INPUT_RTOL + SHIFT_RTOL) (|h| @ |W_head|)."""
    import torch

    from pytorch_quantize_impls_tpu_torch import infer

    dev = cuda()
    seen = []
    hook = model.head.dense.register_forward_pre_hook(lambda m, args: seen.append(args[0]))
    try:
        with torch.inference_mode():
            xb = torch.from_numpy(xs).to(dev)
            y = {name: infer.packed_apply(model, recs, xb) for name, recs in records.items()}
    finally:
        hook.remove()
    if not torch.equal(seen[0], seen[1]):
        fail("vgg: the head's input differs between the unprepared and prepared paths")
    w = records["prepared"][("head", "dense")].decoded.double()
    bound = seen[0].abs().double() @ w.abs() + model.head.dense.bias.detach().abs().double()
    diff = (y["unprepared"] - y["prepared"]).abs().double()
    ratio = (diff / bound).max().item()
    print(f"vgg unprepared vs prepared on {len(xs)} images: max |logit diff| "
          f"{diff.max().item():.3g}, largest |diff| / (|h| @ |W_head|) {ratio:.3g} (bf16 "
          f"rounding of the head's input; tolerance {BF16_INPUT_RTOL + SHIFT_RTOL:.6g})  "
          f"[{card}]", flush=True)
    if ratio > BF16_INPUT_RTOL + SHIFT_RTOL:
        fail(f"vgg: unprepared and prepared logits differ by {ratio:.3g} of |h| @ |W_head|")


def vgg_path(card: str):
    """Main path 5: logquant_vgg at its published widths through build_model,
    seeded weights and calibrated BatchNorm, packed and served through
    InferenceEngine: the unprepared records (K9 at every conv call, K8 at the
    head), then prepare() (K9) and the prepared records (no K8), each path's
    counters zeroed just before it; every served batch replayed; then the
    seams and the speeds."""
    import torch

    from pytorch_quantize_impls_tpu_torch import infer
    from pytorch_quantize_impls_tpu_torch.kernels import shift_matmul as sm
    from pytorch_quantize_impls_tpu_torch.utils import SCHEME_CONFIGS, RunConfig, build_model

    dev = cuda()
    rng = np.random.default_rng(SEED + 30)
    cfg = RunConfig(**SCHEME_CONFIGS["logquant_vgg"])
    model, shape, _ = build_model(cfg, device=dev)
    head = tuple(model.head.dense.weight.shape)
    if model.widths != (128, 128, 256, 256, 512, 512) or head != (10, 8192):
        fail(f"logquant_vgg widths {model.widths}, head {head}")
    calib = rng.normal(size=(VGG_CALIB, *shape)).astype(np.float32)
    calibrated_vgg(model, rng, calib)
    exponent_histograms("vgg", model, 4)
    cpu_model = copy.deepcopy(model).cpu()
    inputs = [rng.normal(size=shape).astype(np.float32)
              for _ in range(CLIENTS * REQUESTS_PER_CLIENT)]
    Logged = logged_engine_class()
    launches, answers, logs, records = {}, {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "logquant_vgg.npz")
        infer.save_packed(path, infer.pack_model(model))
        loaded = infer.load_packed(path, device=dev)
    for name, required in (("unprepared", (sm.decode_log_weights, sm.shift_gemm)),
                           ("prepared", (sm.decode_log_weights,))):
        zero_launches()
        recs = loaded if name == "unprepared" else infer.prepare(loaded)
        engine = Logged(lambda x, recs=recs: infer.packed_apply(model, recs, x), shape,
                        batch_sizes=BUCKETS, device=dev)
        answers[name] = run_engine(card, f"vgg {name}", engine, inputs)
        logs[name] = engine.log
        launches[f"vgg_{name}"] = read_launches(f"vgg_{name}", required)
        records[name] = recs
    if launches["vgg_prepared"]["shift_gemm"]:
        fail("the prepared VGG path launched shift_gemm")

    forwards = {name: (lambda x, recs=recs: infer.packed_apply(model, recs, x))
                for name, recs in records.items()}
    for name in records:
        check_logged(f"vgg {name}", logs[name], inputs, answers[name],
                     {f"packed_apply ({name})": forwards[name]})
    del logs
    vgg_direct_vs_im2col(model, loaded, torch.from_numpy(calib[:VGG_IM2COL_BATCH]).to(dev))
    xs = rng.normal(size=(VGG_EVAL, *shape)).astype(np.float32)
    for name in records:
        against_fake_quant(card, f"vgg packed {name}", model, forwards[name], xs,
                           atol=VGG_LOGIT_ATOL, rtol=VGG_LOGIT_RTOL)
    vgg_unprepared_vs_prepared(card, model, records, xs[:RESNET_BATCH])

    # a small input against the same model on the CPU (plain kernel versions)
    cpu_recs = infer.pack_model(cpu_model)
    packed_words_vs_cpu("vgg", cpu_model, loaded, cpu_recs)
    xs = rng.normal(size=(8, *shape)).astype(np.float32)
    for name, recs in (("unprepared", cpu_recs), ("prepared", infer.prepare(cpu_recs))):
        with torch.inference_mode():
            gpu = forwards[name](torch.from_numpy(xs).to(dev)).cpu()
            cpu = infer.packed_apply(cpu_model, recs, torch.from_numpy(xs))
        gap = (gpu - cpu).abs().max().item()
        inside = ((gpu - cpu).abs() <= VGG_LOGIT_ATOL + VGG_LOGIT_RTOL * cpu.abs()).all()
        if not inside or not torch.equal(gpu.argmax(1), cpu.argmax(1)):
            fail(f"vgg packed {name}: card and CPU logits differ by {gap} on 8 images")
        print(f"vgg packed {name}: card vs CPU (plain versions) on 8 images: max |logit gap| "
              f"{gap:.4g} (tolerance {VGG_LOGIT_ATOL} + {VGG_LOGIT_RTOL} |ref|), same argmax",
              flush=True)

    backends = {"packed": forwards["unprepared"], "packed prepared": forwards["prepared"],
                "fake-quant": model}
    throughput(card, "vgg", backends, shape)
    xb = torch.from_numpy(rng.normal(size=(RESNET_BATCH, *shape)).astype(np.float32)).to(dev)
    for name, forward in backends.items():
        with torch.inference_mode():
            line = profile_line(lambda: forward(xb), "forward", 10)
        print(f"vgg {name} b={RESNET_BATCH} {line}  [{card}]", flush=True)
    return launches


def lm_code_shares(model, md, toks) -> None:
    """Print, for the first and last block, the code shares of each GEMM
    input (the [0, 1] grid of a_bits) on one prefill of ``toks``."""
    import torch

    from pytorch_quantize_impls_tpu_torch.nn import intercept_quant_layers

    n_a = 2**model.a_bits - 1
    names = {}
    for i in (0, model.n_layers - 1):
        blk = getattr(model, f"block{i}")
        for label, m in zip(GEMM_INPUTS, (blk.attn.q, blk.attn.out, blk.ffn_in, blk.ffn_out)):
            names[id(m)] = f"block{i} {label}"
    shares = {}

    def interceptor(m, x, fake_quant_forward):
        if id(m) in names:
            codes = torch.round(torch.clamp(x, 0, 1) * n_a).flatten().to(torch.int64)
            counts = torch.bincount(codes, minlength=n_a + 1).double()
            shares[names[id(m)]] = (counts / counts.sum()).tolist()
        return fake_quant_forward(x)

    with torch.no_grad(), intercept_quant_layers(interceptor):
        md(toks, None)
    for name, share in shares.items():
        print(f"W4A4 LM {name:24s} input code shares 0..{n_a}: "
              + " ".join(f"{v:.3f}" for v in share), flush=True)


def lm_teacher_forced(card: str, model, recs) -> None:
    """The packed W4A4 LM against the fake-quant decode model, both fed the
    fake-quant model's greedy tokens: a 64-token prefill, then 32 steps over
    SLOTS rows.

    Per projection (the gate): inside the fake-quant forward, every
    QuantDense also runs its packed record on the same input, and the two
    outputs must agree within W4A4_GEMM_RTOL of the call's largest output.

    End to end (reported, with a floor): each packed call starts from a copy
    of the fake-quant model's cache (lockstep). A W4A4 model of this width
    is chaotic in code space: a code flipped by float rounding (a sum within
    an ulp of a .5 boundary) moves every output of the next projection by
    ~1/225, which flips ~7% of the codes after it, so one step's 8 layers
    amplify a few first flips into logit gaps of ~0.1 and argmax moves where
    the top two logits are that close. The floor catches a wrong scale or
    code mapping (argmax would agree on ~1/8192), not this."""
    import torch

    from pytorch_quantize_impls_tpu_torch import infer
    from pytorch_quantize_impls_tpu_torch.nn import intercept_quant_layers
    from pytorch_quantize_impls_tpu_torch.serve import decode_model

    dev = cuda()
    b, steps = SLOTS, 32
    rng = np.random.default_rng(SEED + 8)
    toks = torch.from_numpy(rng.integers(0, LM_CFG["vocab"], (b, 64)).astype(np.int32)).to(dev)
    md = decode_model(model)
    lm_code_shares(model, md, toks[:4])
    paths = {id(m): tuple(n.split(".")) for n, m in md.named_modules()}
    kind = {"q": 0, "k": 0, "v": 0, "out": 1, "ffn_in": 2, "ffn_out": 3}
    worst = [0.0] * len(GEMM_INPUTS)
    calls = [0]

    def per_gemm(m, x, fake_quant_forward):
        y = fake_quant_forward(x)
        path = paths[id(m)]
        got = infer.packed_apply(m, {("",): recs[path]}, x)
        rel = ((got - y).abs().max() / y.abs().max()).item()
        j = kind[path[-1]]
        worst[j] = max(worst[j], rel)
        calls[0] += 1
        return y

    agree = total = 0
    gaps = []
    cache, t = None, toks
    with torch.no_grad():
        for step in range(steps + 1):
            got, _ = infer.packed_apply(md, recs, t, None if cache is None else _clone_cache(cache))
            with intercept_quant_layers(per_gemm):
                ref, cache = md(t, cache)
            gaps.append((got[:, -1] - ref[:, -1]).abs().amax(dim=1).cpu())
            if step > 0:
                total += b
                agree += int((got[:, -1].argmax(-1) == ref[:, -1].argmax(-1)).sum())
            t = ref[:, -1].argmax(-1).to(torch.int32)[:, None]
    gaps = torch.cat(gaps).double().numpy()
    per = ", ".join(f"{k}: {w:.3g}" for k, w in zip(GEMM_INPUTS, worst))
    print(f"W4A4 LM packed vs fake-quant, teacher-forced: per projection on the same input, "
          f"{calls[0]} calls, max |diff| / max |output| by GEMM input ({per}; tolerance "
          f"{W4A4_GEMM_RTOL}); end to end in lockstep, {steps} steps x {b} rows, argmax agrees "
          f"on {agree}/{total} ({100 * agree / total:.2f}%, floor "
          f"{100 * W4A4_ARGMAX_FLOOR:.0f}%), row max |logit gap| median {np.median(gaps):.4g} "
          f"max {gaps.max():.4g}  [{card}]", flush=True)
    if max(worst) > W4A4_GEMM_RTOL:
        fail(f"W4A4 LM: a packed projection differs from its fake-quant GEMM by "
             f"{max(worst):.3g} of its largest output")
    if agree < W4A4_ARGMAX_FLOOR * total:
        fail(f"W4A4 LM teacher-forced: argmax agrees on only {agree} of {total}")


def w4a4_lm_path(card: str):
    """Main path 4: the serving LM's shape with DoReFa W4A4 weights and
    activations, through DecodeEngine(packed=): the unprepared records (K6),
    then prepare() (K7) and the prepared ones (K3), each path's counters
    zeroed just before it. Both must answer every request with the same
    tokens: the GEMMs are integer-exact and share one f32 scale."""
    import torch

    from pytorch_quantize_impls_tpu_torch import infer
    from pytorch_quantize_impls_tpu_torch.kernels import int8_matmul as im
    from pytorch_quantize_impls_tpu_torch.kernels import packed_matmul as pm
    from pytorch_quantize_impls_tpu_torch.serve import DecodeEngine, decode_model

    dev = cuda()
    t0 = time.perf_counter()
    model = build_lm(W4A4_LM_CFG, SEED + 9)
    packed = infer.pack_model(model)
    print(f"W4A4 LM built and packed in {time.perf_counter() - t0:.1f} s: "
          f"{torch.cuda.memory_allocated() / 2**20:.0f} MiB allocated", flush=True)
    rng = np.random.default_rng(SEED + 10)
    prompts = [rng.integers(0, LM_CFG["vocab"], rng.integers(PROMPT_LENS[0], PROMPT_LENS[1] + 1))
               .astype(np.int32) for _ in range(DECODE_REQUESTS)]
    answers, launches, records = {}, {}, {}
    for name, required in (("unprepared", (pm.dorefa_gemm,)),
                           ("prepared", (pm.decode_dorefa_weights, im.int8_gemm))):
        zero_launches()
        recs = packed if name == "unprepared" else infer.prepare(packed)
        engine = DecodeEngine(model, packed=recs, n_slots=SLOTS, device=dev)
        t1 = time.perf_counter()
        try:
            answers[name] = serve(lambda i: engine.submit(prompts[i], max_new=MAX_NEW),
                                  len(prompts))
        finally:
            engine.shutdown()
        dt = time.perf_counter() - t1
        st = engine.stats
        print(f"decode engine[W4A4 packed {name}]: {st.requests} requests, {st.tokens} tokens "
              f"in {dt:.2f} s ({st.tokens / dt:.1f} tok/s), {st.steps} steps, mean occupancy "
              f"{st.mean_occupancy:.3f}  [{card}]", flush=True)
        if st.requests != len(prompts) or st.tokens != MAX_NEW * len(prompts):
            fail(f"W4A4 engine[{name}] answered {st.requests} requests, {st.tokens} tokens")
        launches[f"lm_w4a4_{name}"] = read_launches(f"lm_w4a4_{name}", required)
        records[name] = recs
    if any(not np.array_equal(a, b) for a, b in zip(answers["unprepared"], answers["prepared"])):
        fail("the W4A4 LM's unprepared and prepared engines answered differently")
    print(f"W4A4 LM: unprepared and prepared engines gave the same {MAX_NEW} tokens for all "
          f"{len(prompts)} requests", flush=True)
    lm_teacher_forced(card, model, records["prepared"])
    md = decode_model(model)
    backends = {"fake-quant": lambda c, t: md(t, c)}
    for name, recs in records.items():
        backends[f"packed {name}"] = lambda c, t, recs=recs: infer.packed_apply(md, recs, t, c)
    decode_speed(card, backends)
    return launches


# --- main path 6: the serving LM's shape with W4 log weights, packed ----------


def seeded_log_lm_variables(cfg: dict, rng) -> dict:
    """:func:`seeded_lm_variables` for W4 log weights: each projection kernel
    is N(0, 1/fan_in), so every projection output stays O(1) and the
    exponent indices of a kernel spread over about 7 levels around
    2^-5 (fsr 0: levels 2^-16 .. 2^0); the FFN biases are 0.1-scale."""
    v = seeded_lm_variables(cfg, rng)
    for i in range(cfg["n_layers"]):
        blk = v["params"][f"block{i}"]
        for node in (*blk["attn"].values(), blk["ffn_in"], blk["ffn_out"]):
            node["kernel"] = node["kernel"] * np.float32(node["kernel"].shape[0] ** -0.5)
        for name in ("ffn_in", "ffn_out"):
            blk[name]["bias"] = rng.normal(size=blk[name]["bias"].shape).astype(np.float32) * 0.1
    return v


def lm_teacher_forced_by_projection(card: str, label: str, model, records: dict, rtol: dict,
                                    floor: dict, seed: int) -> None:
    """The packed LM's ``records`` (name -> records: unprepared, prepared)
    against the fake-quant decode model, all fed the fake-quant model's
    greedy tokens: a 64-token prefill, then 32 steps over SLOTS rows.

    Per projection (the gate): inside the fake-quant forward, every
    QuantDense also runs each packed record on the same input x, and each
    output must be within ``rtol[name]`` (|x| @ |w| + |bias|) of the
    fake-quant one.

    End to end: each packed call starts from a copy of the fake-quant
    model's cache (lockstep); argmax must agree on ``floor[name]`` of the
    (step, row) pairs."""
    import torch

    from pytorch_quantize_impls_tpu_torch import infer
    from pytorch_quantize_impls_tpu_torch.nn import intercept_quant_layers
    from pytorch_quantize_impls_tpu_torch.serve import decode_model

    dev = cuda()
    b, steps = SLOTS, 32
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, LM_CFG["vocab"], (b, 64)).astype(np.int32)).to(dev)
    md = decode_model(model)
    paths = {id(m): tuple(n.split(".")) for n, m in md.named_modules()}
    kind = {"q": 0, "k": 0, "v": 0, "out": 1, "ffn_in": 2, "ffn_out": 3}
    worst = {name: [0.0] * len(GEMM_INPUTS) for name in records}
    calls = [0]

    def per_gemm(m, x, fake_quant_forward):
        y = fake_quant_forward(x)
        path = paths[id(m)]
        bound = x.abs().double() @ m.weight_quant(m.weight).abs().double().T
        if m.bias is not None:
            bound = bound + m.bias.abs().double()
        for name, recs in records.items():
            got = infer.packed_apply(m, {("",): recs[path]}, x)
            rel = ((got - y).abs().double() / bound.clamp_min(1e-300)).max().item()
            j = kind[path[-1]]
            worst[name][j] = max(worst[name][j], rel)
        calls[0] += 1
        return y

    agree = {name: 0 for name in records}
    total = 0
    cache, t = None, toks
    with torch.no_grad():
        for step in range(steps + 1):
            got = {name: infer.packed_apply(md, recs, t,
                                            None if cache is None else _clone_cache(cache))[0]
                   for name, recs in records.items()}
            with intercept_quant_layers(per_gemm):
                ref, cache = md(t, cache)
            if step > 0:
                total += b
                for name in records:
                    agree[name] += int((got[name][:, -1].argmax(-1) == ref[:, -1].argmax(-1)).sum())
            t = ref[:, -1].argmax(-1).to(torch.int32)[:, None]
    for name in records:
        per = ", ".join(f"{k}: {w:.3g}" for k, w in zip(GEMM_INPUTS, worst[name]))
        print(f"{label} packed {name} vs fake-quant, teacher-forced: per projection on the same "
              f"input, {calls[0]} calls, largest |diff| / (|x| @ |w|) by GEMM input ({per}; "
              f"tolerance {rtol[name]:.6g}); end to end in lockstep, {steps} steps x {b} rows, "
              f"argmax agrees on {agree[name]}/{total} ({100 * agree[name] / total:.2f}%, floor "
              f"{100 * floor[name]:.0f}%)  [{card}]", flush=True)
        if max(worst[name]) > rtol[name]:
            fail(f"{label} {name}: a packed projection differs from its fake-quant GEMM by "
                 f"{max(worst[name]):.3g} of |x| @ |w|")
        if agree[name] < floor[name] * total:
            fail(f"{label} {name} teacher-forced: argmax agrees on only {agree[name]} of {total}")


def log_lm_path(card: str):
    """Main path 6: the serving LM's shape with W4 log weights, through
    DecodeEngine(packed=): the unprepared records (K8 on every projection),
    then prepare() (K9) and the prepared records (no K8), each path's
    counters zeroed just before it; then the seams and the speeds."""
    import torch

    from pytorch_quantize_impls_tpu_torch import infer
    from pytorch_quantize_impls_tpu_torch.kernels import shift_matmul as sm
    from pytorch_quantize_impls_tpu_torch.serve import DecodeEngine, decode_model

    dev = cuda()
    t0 = time.perf_counter()
    model = build_lm(LOG_LM_CFG, SEED + 40)
    last = f"block{LOG_LM_CFG['n_layers'] - 1}."
    exponent_histograms("log LM", model, 6, show=("block0.", last))
    packed = infer.pack_model(model)
    print(f"log LM built and packed in {time.perf_counter() - t0:.1f} s: "
          f"{torch.cuda.memory_allocated() / 2**20:.0f} MiB allocated", flush=True)
    rng = np.random.default_rng(SEED + 42)
    prompts = [rng.integers(0, LM_CFG["vocab"], rng.integers(PROMPT_LENS[0], PROMPT_LENS[1] + 1))
               .astype(np.int32) for _ in range(DECODE_REQUESTS)]
    answers, launches, records = {}, {}, {}
    for name, required, absent in (("unprepared", sm.shift_gemm, sm.decode_log_weights),
                                   ("prepared", sm.decode_log_weights, sm.shift_gemm)):
        zero_launches()
        recs = packed if name == "unprepared" else infer.prepare(packed)
        engine = DecodeEngine(model, packed=recs, n_slots=SLOTS, device=dev)
        t1 = time.perf_counter()
        try:
            answers[name] = serve(lambda i: engine.submit(prompts[i], max_new=MAX_NEW),
                                  len(prompts))
        finally:
            engine.shutdown()
        dt = time.perf_counter() - t1
        st = engine.stats
        print(f"decode engine[log packed {name}]: {st.requests} requests, {st.tokens} tokens in "
              f"{dt:.2f} s ({st.tokens / dt:.1f} tok/s), {st.steps} steps, mean occupancy "
              f"{st.mean_occupancy:.3f}  [{card}]", flush=True)
        if st.requests != len(prompts) or st.tokens != MAX_NEW * len(prompts):
            fail(f"log LM engine[{name}] answered {st.requests} requests, {st.tokens} tokens")
        launches[f"lm_log_{name}"] = read_launches(f"lm_log_{name}", (required,))
        if launches[f"lm_log_{name}"][absent.__name__]:
            fail(f"the {name} log LM path launched {absent.__name__}")
        records[name] = recs
    same = sum(np.array_equal(a, b) for a, b in zip(answers["unprepared"], answers["prepared"]))
    print(f"log LM: the unprepared (bf16 x) and prepared (float32 x) engines gave the same "
          f"{MAX_NEW} tokens for {same} of {len(prompts)} requests", flush=True)
    # the prepared record multiplies the same float32 x and weights (the
    # fake-quant exp2 may sit an ulp off the exact decoded level); K8 also
    # rounds x to bf16
    lm_teacher_forced_by_projection(
        card, "log LM", model, records,
        {"unprepared": BF16_INPUT_RTOL + SHIFT_RTOL, "prepared": SHIFT_RTOL},
        LOG_ARGMAX_FLOOR, SEED + 41)
    md = decode_model(model)
    backends = {"fake-quant": lambda c, t: md(t, c)}
    for name, recs in records.items():
        backends[f"packed {name}"] = lambda c, t, recs=recs: infer.packed_apply(md, recs, t, c)
    decode_speed(card, backends)
    return launches


# --- main path 7: the XNOR-Net convnet, packed and fused ----------------------


def seeded_xnor_variables(widths, rng, fp32_first_last: bool = False,
                          image_shape=RESNET_SHAPE) -> dict:
    """XNORConvNet variables in the flax layout, as numpy: He-scaled conv
    kernels, BatchNorm scales of magnitude 0.5-1.5 with about a quarter of
    them negative (the fused chains' (hi, lo) flip), statistics left for
    :func:`calibrate_batchnorm`, and a head whose logits are O(1). Once
    calibrated, a BatchNorm output is about N(beta, gamma^2) per channel:
    biases around 0 leave half the signs +1; before a 2x2 max pool (odd
    stages) they sit near -0.85 |gamma|, a fifth of the signs +1, so that
    about half survive the max of four. ``fp32_first_last`` puts conv0's and
    the head's kernels where flax's plain Conv and Dense keep them;
    ``image_shape`` is the NHWC input without the batch (CIFAR's, or the
    digits' 8x8x1)."""
    f32 = np.float32

    def normal(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(f32)

    p, s = {}, {}
    cin = image_shape[2]
    for i, w in enumerate(widths):
        kernel = normal(3, 3, cin, w, scale=np.sqrt(2.0 / (9 * cin)))
        p[f"conv{i}"] = ({"kernel": kernel} if fp32_first_last and i == 0
                         else {"conv": {"kernel": kernel}})
        gamma = np.where(rng.uniform(size=w) < 0.25, -1.0, 1.0) * rng.uniform(0.5, 1.5, w)
        beta = rng.normal(size=w) * 0.2 - (0.85 * np.abs(gamma) if i % 2 == 1 else 0.0)
        p[f"bn{i}"] = {"scale": gamma.astype(f32), "bias": beta.astype(f32)}
        s[f"bn{i}"] = {"mean": np.zeros(w, f32), "var": np.ones(w, f32)}
        cin = w
    pools = 2 ** (len(widths) // 2)
    k = (image_shape[0] // pools) * (image_shape[1] // pools) * cin
    head = {"kernel": normal(k, 10, scale=k ** -0.5), "bias": normal(10, scale=0.1)}
    p["head"] = head if fp32_first_last else {"dense": head}
    return {"params": p, "batch_stats": s}


def calibrated_xnor(model, variables, x, device):
    """(``model``, a port XNORConvNet, on ``device`` in eval mode; its
    variables in the flax layout): ``variables`` through the bridge, then
    every BatchNorm's statistics calibrated on the images ``x`` (numpy NHWC).
    Full XNOR from seeded weights saturates its signs unless each BatchNorm
    centres its input; the K-off model of the fused path gets its own
    statistics from the same images."""
    import torch

    from pytorch_quantize_impls_tpu_torch.utils import load_flax_variables

    load_flax_variables(model, variables, device=device).eval()
    stats = calibrate_batchnorm(model, torch.from_numpy(x).to(device))
    return model, {"params": variables["params"], "batch_stats": stats}


def grid_images(rng, n: int, shape) -> np.ndarray:
    """Seeded images on a 1/8 grid in [-4, 4]: a real-input conv of +-1
    weights sums them exactly in any order, so its output sits on the same
    grid on every path, and a sign boundary moves with a channel's threshold
    only (as 8-bit pixels do), not with float rounding of each pixel sum."""
    return (np.clip(np.round(rng.normal(size=(n, *shape)) * 8), -32, 32) / 8).astype(np.float32)


def logit_rule(card: str, label: str, got, ref) -> None:
    """The JAX package's rule for whole binary models (XNOR_MIN_WITHIN):
    print the spread, fail if it does not hold."""
    got = got.double().cpu().numpy() if hasattr(got, "cpu") else np.asarray(got, np.float64)
    ref = ref.double().cpu().numpy() if hasattr(ref, "cpu") else np.asarray(ref, np.float64)
    if got.shape != ref.shape or not np.isfinite(got).all():
        fail(f"{label}: {got.shape} logits, not finite {ref.shape}")
    gap = np.abs(got - ref)
    bad = float((gap > LOGIT_TOL + LOGIT_TOL * np.abs(ref)).mean())
    agree = int((got.argmax(1) == ref.argmax(1)).sum())
    n = got.shape[0]
    print(f"{label} on {n} rows: max |logit gap| {gap.max():.4g}, {100 * bad:.3f}% of logits "
          f"beyond {LOGIT_TOL} + {LOGIT_TOL} |ref|, argmax agrees on {agree}/{n}  [{card}]",
          flush=True)
    if bad and (bad > 1 - XNOR_MIN_WITHIN or agree != n):
        fail(f"{label}: {100 * bad:.3f}% of logits out of tolerance, argmax agrees on {agree}/{n}")


def check_shares(label: str, shares: dict) -> None:
    """Print each binarized activation's share of +1; fail outside
    CODE_SHARE."""
    print(f"{label} share of +1 codes: " + ", ".join(f"{k} {v:.3f}" for k, v in shares.items()),
          flush=True)
    for k, v in shares.items():
        if not CODE_SHARE[0] <= v <= CODE_SHARE[1]:
            fail(f"{label}: {k} has a share of +1 codes {v:.3f}, outside {CODE_SHARE}")


def xnor_input_shares(model, x) -> dict:
    """The share of +1 among the sign-binarized inputs of each full-XNOR
    conv of ``model`` on the images ``x`` (fake-quant forward)."""
    import torch

    shares = {}

    def hook(name):
        def fn(m, args):
            shares[name] = float((args[0] >= 0).double().mean())
        return fn

    convs = [(f"conv{i}", getattr(model, f"conv{i}")) for i in range(1, len(model.widths))]
    hooks = [m.register_forward_pre_hook(hook(name)) for name, m in convs]
    try:
        with torch.no_grad():
            model(x)
    finally:
        for h in hooks:
            h.remove()
    return shares


def xnor_direct_vs_im2col(model, loaded, x, name: str = "conv3") -> str:
    """A full-XNOR conv of ``model`` (xnor_cifar's conv3, 16x16x256 -> 256;
    xnor_digits_a1's conv1, 8x8x128 -> 128) on its real input: direct (the
    route conv_route picks), both routes called directly (the fused K5 with
    the packed weight stage, and K2 + the raw K5, each with alpha in the
    scale epilogue) and im2col (F.unfold + K1 with alpha) bit for bit.
    Returns the direct route."""
    import torch

    from pytorch_quantize_impls_tpu_torch.kernels import int8_conv as ic
    from pytorch_quantize_impls_tpu_torch.kernels import xnor_gemm as bg
    from pytorch_quantize_impls_tpu_torch.kernels.conv import (
        PackedConv, conv_pads, decode_conv_weights, packed_conv2d, packed_conv_route)

    conv = getattr(model, name).conv
    rec = loaded[(name, "conv")]
    kh, kw, cin, cout = rec.kernel_shape
    pc = PackedConv("xnor", rec.packed, (kh, kw), cin, cout, rec.alpha, 1, 1)
    seen = []
    hook = conv.register_forward_pre_hook(lambda m, args: seen.append(args[0]))
    try:
        with torch.no_grad():
            model(x)
    finally:
        hook.remove()
    xr = seen[0]
    kw_ = dict(strides=conv.strides, padding=conv.padding)
    pads = conv_pads(conv.padding, xr.shape[1:3], (kh, kw), conv.strides)
    route = packed_conv_route(xr.shape, pc, conv.strides, pads)
    direct = packed_conv2d(xr, pc, **kw_)
    codes = bg.binarize_to_int8(xr)
    args = ((kh, kw), tuple(conv.strides), pads, "scale", rec.alpha)
    fused = ic.int8_conv2d(codes, rec.packed, *args, w_bits=1)
    two = ic.int8_conv2d(codes, decode_conv_weights(pc), *args)
    im2col = packed_conv2d(xr, pc, mode="im2col", **kw_)
    for label, y in ((f"direct ({route})", direct), ("fused K5", fused), ("K2 + raw K5", two)):
        if not torch.equal(y, im2col):
            fail(f"xnor {name}: {label} and im2col differ in {int((y != im2col).sum())} places")
    print(f"xnor {name} on {x.shape[0]} images: direct ({route} route) == fused K5 == K2 + raw "
          f"K5 == im2col (F.unfold + K1 with alpha), {tuple(direct.shape)}, bit for bit",
          flush=True)
    return route


def records_on(recs: dict, device) -> dict:
    """The packed records' words and alpha copied to ``device``, without
    ``prepare()``'s buffers: the same artifact on another device."""
    import dataclasses

    return {path: dataclasses.replace(
        r, packed=r.packed.to(device), decoded=None,
        alpha=None if r.alpha is None else r.alpha.to(device)) for path, r in recs.items()}


def layers_vs_cpu(card: str, label: str, model, recs, cpu_model, cpu_recs, x) -> None:
    """Card against CPU, layer by layer on the same inputs: packed_apply of
    ``model`` on the card records every packed layer's input and output;
    each layer's CPU record (the same artifact, plain kernel versions) then
    runs on that input.
    Binarized-input convs must agree bit for bit (integer sums, alpha);
    real-input layers (conv0, the head) within 1e-5 (|x| @ |w|) alpha (float
    sums in another order)."""
    import torch

    from pytorch_quantize_impls_tpu_torch import infer
    from pytorch_quantize_impls_tpu_torch.kernels.conv import conv2d_nhwc
    from pytorch_quantize_impls_tpu_torch.nn import QuantConv

    seen = {}
    paths = {m: tuple(n.split(".")) for n, m in model.named_modules() if tuple(n.split(".")) in recs}
    hooks = [m.register_forward_hook(lambda m, args, out: seen.__setitem__(
        paths[m], (args[0].clone(), out.clone()))) for m in paths]
    try:
        with torch.inference_mode():
            infer.packed_apply(model, recs, x)
    finally:
        for h in hooks:
            h.remove()
    cpu_layers = dict((tuple(n.split(".")), m) for n, m in cpu_model.named_modules())
    worst = 0.0
    for path, (xin, yout) in sorted(seen.items()):
        m = cpu_layers[path]
        xc = xin.cpu()
        got = infer.packed_apply(m, {("",): cpu_recs[path]}, xc)
        ref = yout.cpu()
        if m.a_bits:
            if not torch.equal(got, ref):
                fail(f"{label} {'.'.join(path)}: card and CPU differ in "
                     f"{int((got != ref).sum())} places on the same input")
            continue
        w = torch.ones_like(m.weight, dtype=torch.float64)  # |sign(w)|
        if isinstance(m, QuantConv):
            bound = conv2d_nhwc(xc.abs().double(), w, m.strides, m.padding)
        else:
            bound = xc.abs().double() @ w.T
        bound = bound * cpu_recs[path].alpha.double()
        ratio = ((got.double() - ref.double()).abs() / bound.clamp_min(1e-30)).max().item()
        worst = max(worst, ratio)
        if ratio > SHIFT_RTOL:
            fail(f"{label} {'.'.join(path)}: card and CPU differ by {ratio:.3g} of (|x| @ |w|) alpha")
    print(f"{label}: card == CPU (plain versions) layer by layer on {x.shape[0]} images: the "
          f"binarized-input convs bit for bit, the real-input layers within {worst:.3g} of "
          f"(|x| @ |w|) alpha (tolerance {SHIFT_RTOL})  [{card}]", flush=True)


def xnor_packed_path(card: str):
    """Main path 7: xnor_cifar (BASELINE config 3, the K map on) at its
    published widths from build_model with seeded weights and BatchNorm
    calibrated on seeded images: pack_model -> save_packed -> load_packed ->
    InferenceEngine over the unprepared artifact, then prepare() and the
    prepared artifact, every batch replayed bit-equal; conv3 direct by both
    routes == im2col (K1 with alpha); packed against fake-quant by the JAX
    rule; card against CPU layer by layer. K2 must launch exactly for conv0
    and the head on unprepared calls, the hidden convs on the two-launch
    route and prepare(). Returns (launches, what the fused path reuses)."""
    import torch

    from pytorch_quantize_impls_tpu_torch import infer
    from pytorch_quantize_impls_tpu_torch.kernels import int8_conv as ic
    from pytorch_quantize_impls_tpu_torch.kernels import xnor_gemm as bg
    from pytorch_quantize_impls_tpu_torch.utils import SCHEME_CONFIGS, RunConfig, build_model

    dev = cuda()
    rng = np.random.default_rng(SEED + 50)
    model, example_shape, _ = build_model(RunConfig(**SCHEME_CONFIGS["xnor_cifar"]))
    if model.widths != XNOR_WIDTHS or next(model.parameters()).device != dev:
        fail(f"xnor_cifar built with widths {model.widths} on {next(model.parameters()).device}")
    calib = rng.normal(size=(XNOR_CALIB, *example_shape)).astype(np.float32)
    variables = seeded_xnor_variables(XNOR_WIDTHS, rng)
    model, variables = calibrated_xnor(model, variables, calib, dev)
    check_shares("xnor_cifar (K map on) conv inputs",
                 xnor_input_shares(model, torch.from_numpy(calib[:64]).to(dev)))
    cpu_model = copy.deepcopy(model).cpu()
    inputs = [rng.normal(size=example_shape).astype(np.float32) for _ in range(XNOR_REQUESTS)]
    Logged = logged_engine_class()
    answers, logs = {}, {}
    n_convs = len(XNOR_WIDTHS) - 1  # the hidden convs, one K5 launch each per forward
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "xnor_cifar.npz")
        infer.save_packed(path, infer.pack_model(model))
        zero_launches()
        loaded = infer.load_packed(path, device=dev)
        for name in ("unprepared", "prepared"):
            if name == "unprepared":
                recs = loaded
            else:
                before = bg.decode_binary_weights.launches
                recs = infer.prepare(loaded)
                k2_prepare = bg.decode_binary_weights.launches - before
            engine = Logged(lambda x, recs=recs: infer.packed_apply(model, recs, x),
                            example_shape, batch_sizes=BUCKETS, device=dev)
            answers[name] = run_engine(card, f"xnor_cifar {name}", engine, inputs)
            logs[name] = engine.log
            if name == "unprepared":
                unprepared_forwards = ic.int8_conv2d.launches // n_convs
        xnor_direct_vs_im2col(model, loaded,
                              torch.from_numpy(calib[:XNOR_IM2COL_BATCH]).to(dev))
        launches = read_launches("xnor_cifar_packed",
                                 (bg.decode_binary_weights, bg.binary_gemm, ic.int8_conv2d))
    # conv0 and the head (real inputs) decode their words (K2) on every
    # unprepared forward; a hidden conv launches K2 only on the two-launch
    # route (the engines' and the im2col check's)
    decoded = launches["int8_conv2d"] - launches["int8_conv2d.packed"]
    want = 2 * unprepared_forwards + decoded + k2_prepare
    print(f"xnor_cifar packed: {launches['int8_conv2d']} hidden conv calls, "
          f"{launches['int8_conv2d.packed']} fused (no decoder), {decoded} as K2 + raw K5; K2 "
          f"launches {launches['decode_binary_weights']} = 2 x {unprepared_forwards} unprepared "
          f"forwards (conv0, head) + {decoded} + {k2_prepare} in prepare()", flush=True)
    if launches["decode_binary_weights"] != want:
        fail(f"xnor_cifar: K2 launched {launches['decode_binary_weights']} times, expected {want}")
    print_routes(card, "xnor_cifar packed", lambda x: infer.packed_apply(model, loaded, x),
                 example_shape)
    prepared = infer.prepare(loaded)
    forwards = {
        "packed_apply (unprepared)": lambda x: infer.packed_apply(model, loaded, x),
        "packed_apply (prepared)": lambda x: infer.packed_apply(model, prepared, x),
    }
    for name in ("unprepared", "prepared"):
        check_logged(f"xnor_cifar {name}", logs[name], inputs, answers[name], forwards)
    del logs
    xs = torch.from_numpy(rng.normal(size=(XNOR_EVAL, *example_shape)).astype(np.float32)).to(dev)
    with torch.inference_mode():
        got, ref = forwards["packed_apply (prepared)"](xs), model(xs)
    logit_rule(card, "xnor_cifar packed vs fake-quant", got, ref)
    cpu_recs = records_on(loaded, "cpu")
    layers_vs_cpu(card, "xnor_cifar packed", model, prepared, cpu_model, infer.prepare(cpu_recs),
                  xs[:8])
    with torch.inference_mode():
        gpu, cpu = got[:8].cpu(), infer.packed_apply(cpu_model, cpu_recs, xs[:8].cpu())
    gap = (gpu - cpu).abs().max().item()
    same = int((gpu.argmax(1) == cpu.argmax(1)).sum())
    print(f"xnor_cifar packed: card vs CPU end to end on 8 images (reported; a sign within an "
          f"ulp of 0 after the K map may flip): max |logit gap| {gap:.4g}, argmax agrees on "
          f"{same}/8", flush=True)
    ctx = dict(model=model, loaded=loaded, prepared=prepared, variables=variables, calib=calib,
               inputs=inputs, example_shape=example_shape, rng=rng)
    return {"xnor_cifar_packed": launches}, ctx


def fused_stage_shares(chain, x) -> dict:
    """The share of +1 codes after each threshold stage of a fused chain on
    the images ``x``."""
    import torch

    from pytorch_quantize_impls_tpu_torch.infer.fused_chain import fused_stage_outputs

    with torch.inference_mode():
        return {f"stage{i}": float((h == 1).double().mean())
                for i, h in enumerate(fused_stage_outputs(chain, x)) if h.dtype == torch.int8}


def fused_chain_engine(card: str, label: str, chain, example_shape, inputs, per_forward: dict):
    """Serve ``inputs`` through InferenceEngine.from_fused_chain, counters
    zeroed just before; every batch replayed bit-equal through fused_apply;
    K5 (and K3) must have launched ``per_forward`` times per forward, by
    epilogue (warmup included). Returns the launches."""
    from pytorch_quantize_impls_tpu_torch import infer

    dev = cuda()
    zero_launches()
    engine = logged_engine_class().from_fused_chain(chain, example_shape, batch_sizes=BUCKETS,
                                                    device=dev)
    answers = run_engine(card, label, engine, inputs)
    required = [k for k in all_kernels() if k.__name__ in per_forward]
    launches = read_launches(label.replace(" ", "_"), required)
    forwards = len(BUCKETS) + len(engine.log)
    for key, n in per_forward.items():
        if launches[key] != n * forwards:
            fail(f"{label}: {key} launched {launches[key]} times, expected {n} per forward x "
                 f"{forwards} forwards")
    print(f"{label}: {forwards} forwards, " + ", ".join(
        f"{key} {launches[key]} ({n} per forward)" for key, n in per_forward.items()), flush=True)
    check_logged(label, engine.log, inputs, answers,
                 {"fused_apply": lambda x: infer.fused_apply(chain, x)})
    return launches


def xnor_fused_path(card: str, ctx: dict):
    """Main path 8: the same weights in XNORConvNet(use_input_scale_map=
    False), BatchNorm recalibrated on the same images ->
    export_fused_chain(first_dtype=float32) -> InferenceEngine.
    from_fused_chain: batches replayed bit-equal, K5 five times per forward
    (four threshold, one affine), every stage's codes spread, fused against
    packed_apply of the K-off model by the JAX rule (bf16 first conv
    reported beside it). Then images/s and profiles of the four xnor_cifar
    backends."""
    import torch

    from pytorch_quantize_impls_tpu_torch import infer
    from pytorch_quantize_impls_tpu_torch.models import XNORConvNet

    dev = cuda()
    rng, shape = ctx["rng"], ctx["example_shape"]
    model_k, _ = calibrated_xnor(XNORConvNet(widths=XNOR_WIDTHS, use_input_scale_map=False),
                                 ctx["variables"], ctx["calib"], dev)
    chain = infer.export_fused_chain(model_k, first_dtype=torch.float32)
    check_shares("xnor_cifar fused stages",
                 fused_stage_shares(chain, torch.from_numpy(ctx["calib"][:64]).to(dev)))
    launches = fused_chain_engine(card, "xnor_cifar fused", chain, shape, ctx["inputs"],
                                  {"int8_conv2d": 5, "int8_conv2d.threshold": 4,
                                   "int8_conv2d.affine": 1})
    packed_k = infer.prepare(infer.pack_model(model_k))
    xs = torch.from_numpy(grid_images(rng, XNOR_EVAL, shape)).to(dev)
    with torch.inference_mode():
        got, ref = infer.fused_apply(chain, xs), infer.packed_apply(model_k, packed_k, xs)
    logit_rule(card, "xnor_cifar fused (float32 first conv) vs packed_apply (K off)", got, ref)
    # JAX's default first_dtype rounds the pixels to bf16 (grid images are
    # bf16-exact): reported on normal images, beside the float32 chain there
    xs = torch.from_numpy(rng.normal(size=(XNOR_EVAL, *shape)).astype(np.float32)).to(dev)
    with torch.inference_mode():
        ref = infer.packed_apply(model_k, packed_k, xs)
        for name, ch in (("float32", chain), ("bf16", infer.export_fused_chain(model_k))):
            y = infer.fused_apply(ch, xs)
            within = float(((y - ref).abs() <= LOGIT_TOL + LOGIT_TOL * ref.abs()).double().mean())
            print(f"xnor_cifar fused, {name} first conv, on normal images (reported): "
                  f"{100 * within:.2f}% of logits within {LOGIT_TOL} + {LOGIT_TOL} |ref| of "
                  f"packed_apply (K off), argmax agrees on "
                  f"{int((y.argmax(1) == ref.argmax(1)).sum())}/{XNOR_EVAL}  [{card}]", flush=True)
    model, loaded, prepared = ctx["model"], ctx["loaded"], ctx["prepared"]
    backends = {
        "packed": lambda x: infer.packed_apply(model, loaded, x),
        "packed prepared": lambda x: infer.packed_apply(model, prepared, x),
        "fused": lambda x: infer.fused_apply(chain, x),
        "fake-quant": model,
    }
    throughput(card, "xnor_cifar", backends, shape)
    for b in (1, RESNET_BATCH):
        xb = torch.from_numpy(rng.normal(size=(b, *shape)).astype(np.float32)).to(dev)
        for name, forward in backends.items():
            with torch.inference_mode():
                line = profile_line(lambda: forward(xb), "forward", 10)
            print(f"xnor_cifar {name} b={b} {line}  [{card}]", flush=True)
    return {"xnor_cifar_fused": launches}


def lenet_fused_path(card: str, model, prepared, example_shape):
    """Main path 9: path 1's BNN LeNet -> export_fused_lenet(first_dtype=
    float32) -> InferenceEngine.from_fused_chain: K5 (threshold) at conv2
    and K3 at fc1 once per forward, batches replayed bit-equal, every
    stage's codes spread, fused against packed_apply by the JAX rule."""
    import torch

    from pytorch_quantize_impls_tpu_torch import infer

    dev = cuda()
    rng = np.random.default_rng(SEED + 55)
    chain = infer.export_fused_lenet(model, first_dtype=torch.float32)
    xs = torch.from_numpy(grid_images(rng, XNOR_EVAL, example_shape)).to(dev)
    shares = fused_stage_shares(chain, xs[:64])
    print("bnn_lenet fused stages share of +1 codes (reported: path 1's weights, whose pooled "
          "codes lean to +1): " + ", ".join(f"{k} {v:.3f}" for k, v in shares.items()), flush=True)
    inputs = [rng.normal(size=example_shape).astype(np.float32)
              for _ in range(CLIENTS * REQUESTS_PER_CLIENT)]
    launches = fused_chain_engine(card, "bnn_lenet fused", chain, example_shape, inputs,
                                  {"int8_conv2d": 1, "int8_conv2d.threshold": 1, "int8_gemm": 1})
    with torch.inference_mode():
        got, ref = infer.fused_apply(chain, xs), infer.packed_apply(model, prepared, xs)
    logit_rule(card, "bnn_lenet fused (float32 first conv) vs packed_apply", got, ref)
    return {"bnn_lenet_fused": launches}


# --- path 10: training on the card, then the trained weights served -------------


def _batches(train_set, seed: int = 0):
    from pytorch_quantize_impls_tpu_torch import data

    return data.iterate_batches(train_set, TRAIN_BATCH, seed=seed)


def _copy_state(dst, src) -> None:
    """dst's model and Adam state := src's (the CPU copy takes the card's)."""
    import torch

    dst.model.load_state_dict(src.model.state_dict())
    for pd, ps in zip(dst.model.parameters(), src.model.parameters()):
        dst.optimizer.state[pd] = {k: v.detach().to("cpu", copy=True)
                                   for k, v in src.optimizer.state[ps].items()}
        if isinstance(dst.optimizer.state[pd].get("step"), torch.Tensor):
            dst.optimizer.state[pd]["step"] = dst.optimizer.state[pd]["step"].float()
    dst.step = src.step


def _clamped(state) -> float:
    """The largest |w| over the clamped kernels."""
    return max(float(p.detach().abs().max()) for p, _ in state.clamp.params)


def _within(got, ref, grad=None, atol=TRAIN_TOL, rtol=0.0, lr=None, moved=None):
    """Which entries lie within ``atol + rtol |ref|``; where ``grad`` (the
    step's gradient) is rounding noise, or where ``moved`` (a mask: the two
    devices' gradients differ there) is set, within 4 lr instead (Adam
    moves an entry by up to lr from any gradient)."""
    d = (got.double() - ref.double()).abs()
    ok = d <= atol + rtol * ref.double().abs()
    if grad is not None:
        ok = ok | ((grad.abs() <= NOISE_GRAD) & (d <= 4 * lr + atol))
    if moved is not None:
        ok = ok | (moved & (d <= 4 * lr + atol))
    return ok


def _tensor_gate(ok) -> tuple:
    """One tensor's gate on its entries within tolerance: (share within,
    entries outside once the channel (axis 0) that holds most of them is
    set aside, passes). It passes when those others are at most
    1 - TRAIN_MIN_WITHIN of its entries: a sign that ties after BatchNorm
    moves one output channel's gradient, rounding a few scattered ones."""
    miss = (~ok).reshape(ok.shape[0] if ok.dim() else 1, -1).sum(1)  # a scalar: one channel
    rest = int(miss.sum() - miss.max())
    return float(ok.double().mean()), rest, rest <= (1.0 - TRAIN_MIN_WITHIN) * ok.numel()


def train_card_vs_cpu(card: str, state, cpu_state, step_fn, batches, label: str = "bnn_lenet",
                      steps: int = TRAIN_CHECKED_STEPS, gate: bool = True,
                      noise_grads: bool = False, grad_tol: float = GRAD_TOL,
                      loss_rtol: float = 1e-5) -> bool:
    """``steps`` train steps of ``label`` on the card and on the CPU, each
    from the card's state (free-running BNN trajectories part after one
    step from any float reassociation, the JAX package's jitted and unjitted
    steps too): the loss within 1e-5 relative; each tensor held by
    _tensor_gate on its gradient entries within GRAD_TOL max|g| of the
    tensor (TF32 would round the conv gradients to 10 mantissa bits), its
    parameters within TRAIN_TOL, its running statistics within TRAIN_TOL
    |ref| (conv2's variance is ~3e3); the clamp exact on both. With ``gate``
    off the shares are printed and the verdict returned, not enforced. With
    ``noise_grads`` a tensor whose whole gradient is at or below NOISE_GRAD
    on both devices passes its gradient gate: the rounding noise of a
    gradient that is 0 in exact arithmetic (a bias before BatchNorm), which
    has no scale of its own to hold it to; every other tensor keeps the
    per-entry rule. A bf16 model's step passes a looser ``grad_tol`` and
    ``loss_rtol`` (PERF.md section 2); where its two gradient entries differ
    beyond GRAD_TOL, the parameter entry may differ by up to 4 lr."""
    lr = state.lr
    passed = True
    for i in range(steps):
        _copy_state(cpu_state, state)
        batch = next(batches)
        _, m = step_fn(state, batch)
        _, mc = step_fn(cpu_state, batch)
        loss, loss_cpu = float(m["loss"]), float(mc["loss"])
        loss_ok = abs(loss - loss_cpu) <= loss_rtol * abs(loss_cpu)
        gates = {"gradients": {}, "parameters": {}, "statistics": {}}
        noise = {}  # the tensors passed as noise: max |g| on the card, on the CPU
        cpu_params = dict(cpu_state.model.named_parameters())
        for name, p in state.model.named_parameters():
            pc = cpu_params[name]
            g, gc = p.grad.detach().cpu(), pc.grad.detach()
            scale = float(gc.abs().max())
            ok = _within(g, gc, atol=grad_tol * scale)
            if noise_grads and max(scale, float(g.abs().max())) <= NOISE_GRAD:
                noise[name] = (float(g.abs().max()), scale)
                ok = ok.new_ones(ok.shape)
            moved = (g - gc).abs() > GRAD_TOL * scale if grad_tol > GRAD_TOL else None
            gates["gradients"][name] = _tensor_gate(ok)
            gates["parameters"][name] = _tensor_gate(_within(p.detach().cpu(), pc.detach(),
                                                             grad=gc, lr=lr, moved=moved))
        cpu_buffers = dict(cpu_state.model.named_buffers())
        for name, b in state.model.named_buffers():
            gates["statistics"][name] = _tensor_gate(_within(b.cpu(), cpu_buffers[name],
                                                             rtol=TRAIN_TOL))
        shares = {kind: min((sh for sh, _, _ in c.values()), default=1.0)
                  for kind, c in gates.items()}
        off = [f"{kind[:-1]} {name} {sh:.6f} ({rest} outside its worst channel)"
               for kind, c in gates.items() for name, (sh, rest, _) in c.items() if sh < 1.0]
        failed = [f"{kind[:-1]} {name}" for kind, c in gates.items()
                  for name, (_, _, ok) in c.items() if not ok]
        clamp = (_clamped(state), _clamped(cpu_state))
        noise_note = ("; gradients passed as noise (max |g| card / CPU): " + (", ".join(
            f"{k} {a:.3g} / {c:.3g}" for k, (a, c) in noise.items()) or "none")
            if noise_grads else "")
        print(f"{label} train step {i + 1}, card vs CPU from the card's state: loss "
              f"{loss:.6f} / {loss_cpu:.6f}; least share of a tensor's entries within "
              "tolerance: " + ", ".join(f"{k} {v:.7f}" for k, v in shares.items())
              + f" (tensors not all within: {'; '.join(off) or 'none'}){noise_note}; max |kernel| "
              f"{clamp[0]} / {clamp[1]}; gate {'passes' if loss_ok and not failed else 'fails'}"
              f"{'' if gate else ' (reported)'}  [{card}]", flush=True)
        if max(clamp) > 1.0:
            fail(f"{label} train step {i + 1}: a kernel left [-1, 1] {clamp}")
        passed = passed and loss_ok and not failed
        if gate and not passed:
            fail(f"{label} train step {i + 1}: card and CPU differ beyond tolerance (loss "
                 f"{loss} / {loss_cpu}) in {failed}")
    return passed


def conv2_precision(card: str) -> None:
    """The gradient gate against TF32 in the conv backward (the fault
    conv2d_nhwc keeps out): conv2's input and weight gradients at
    bnn_lenet's shapes (+-1 codes, a normal upstream gradient) by the port
    and by cuDNN with TF32 on, each against the CPU's under the gate of
    train_card_vs_cpu; the port must pass it and TF32 must not, or the gate
    could not see the fault. Beside it, how far cuDNN's float32 conv of the
    +-1 codes lands from the integer sums (which QuantConv rounds to)."""
    import torch

    from pytorch_quantize_impls_tpu_torch.kernels.conv import conv2d_nhwc

    g = torch.Generator().manual_seed(SEED)
    x = torch.where(torch.rand(TRAIN_BATCH, 12, 12, WIDTH, generator=g) < 0.5, 1.0, -1.0)
    w = torch.where(torch.rand(2 * WIDTH, WIDTH, 5, 5, generator=g) < 0.5, 1.0, -1.0)
    gy = torch.randn(TRAIN_BATCH, 8, 8, 2 * WIDTH, generator=g)

    def grads(dev, tf32=None):
        xd = x.to(dev, copy=True).requires_grad_(True)
        wd = w.to(dev, copy=True).requires_grad_(True)
        if tf32 is None:
            (conv2d_nhwc(xd, wd, (1, 1), "VALID") * gy.to(dev)).sum().backward()
        else:
            with torch.backends.cudnn.flags(enabled=True, allow_tf32=tf32):
                y = torch.nn.functional.conv2d(xd.permute(0, 3, 1, 2), wd).permute(0, 2, 3, 1)
                (y * gy.to(dev)).sum().backward()
        return xd.grad.cpu(), wd.grad.cpu()

    ref = grads("cpu")
    results = {}
    for name, got in (("port", grads(cuda())), ("cuDNN with TF32 on", grads(cuda(), True))):
        results[name] = [(*_tensor_gate(_within(a, r, atol=GRAD_TOL * float(r.abs().max()))),
                          float((a - r).abs().max() / r.abs().max())) for a, r in zip(got, ref)]
    print("conv2 gradients against the CPU's (input, weight: share within "
          f"{GRAD_TOL} max|g|, passes the gate, max |diff| / max |g|): " + "; ".join(
              f"{name} " + ", ".join(f"{sh:.6f} {ok} {err:.3g}" for sh, _, ok, err in r)
              for name, r in results.items()) + f"  [{card}]", flush=True)
    if not all(ok for _, _, ok, _ in results["port"]):
        fail("the conv gradients on the card are not float32's")
    if all(ok for _, _, ok, _ in results["cuDNN with TF32 on"]):
        fail("the gradient gate passes TF32's conv gradients: it cannot see the fault")
    with torch.inference_mode(), torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        y = torch.nn.functional.conv2d(x.to(cuda()).permute(0, 3, 1, 2), w.to(cuda()))
    print(f"cuDNN's float32 conv of the +-1 codes at conv2's shape: max |sum - nearest integer| "
          f"{float((y - y.round()).abs().max()):.3g} (QuantConv rounds +-1 sums to the exact "
          f"integers)  [{card}]", flush=True)


def train_on_card(card: str, state, step_fn, batches, first_step: int,
                  steps: int = TRAIN_STEPS, label: str = "bnn_lenet"):
    """Train to ``steps``: the clamp and finite statistics every
    TRAIN_WINDOW steps, the loss falls, ms per step and images/s by CUDA
    events, a profile over 20 steps. Returns the state dict at RERUN_STEPS
    (for the rerun)."""
    import torch

    losses, snapshot = [], None
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    timed_from = None
    for step in range(first_step, steps):
        if step == TRAIN_WINDOW:
            start.record()
            timed_from = step
        _, m = step_fn(state, next(batches))
        losses.append(m["loss"])
        if state.step == RERUN_STEPS:
            snapshot = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
        if state.step % TRAIN_WINDOW == 0:
            stats_ok = all(bool(torch.isfinite(b).all()) for b in state.model.buffers())
            if _clamped(state) > 1.0 or not stats_ok:
                fail(f"{label} train step {state.step}: a kernel left [-1, 1] "
                     f"({_clamped(state)}) or a running statistic is not finite")
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / (steps - timed_from)
    loss = torch.stack(losses).cpu().numpy()
    first, last = float(loss[:TRAIN_WINDOW].mean()), float(loss[-TRAIN_WINDOW:].mean())
    print(f"{label} trained {state.step} steps on the card (batch {TRAIN_BATCH}): mean loss "
          f"of the first {TRAIN_WINDOW} steps {first:.4f}, of the last {last:.4f}; every "
          f"{TRAIN_WINDOW} steps the kernels in [-1, 1] and the statistics finite; "
          f"{step_ms:.3f} ms per step, {1e3 * TRAIN_BATCH / step_ms:.1f} images/s (CUDA events "
          f"over {steps - timed_from} steps)  [{card}]", flush=True)
    if last > TRAIN_LOSS_DROP * first:
        fail(f"{label}: the loss fell from {first:.4f} only to {last:.4f}")
    line = profile_line(lambda: step_fn(state, next(batches)), "step", 20)
    print(f"{label} train step {line}  [{card}]", flush=True)
    return snapshot


def train_rerun(card: str, snapshot, make_model=None, label: str = "bnn_lenet") -> None:
    """A second run from the same seed on the same batches gives the same
    bits at RERUN_STEPS; ``make_model()`` builds the model (the config's
    unless given)."""
    from pytorch_quantize_impls_tpu_torch import data, train
    from pytorch_quantize_impls_tpu_torch.utils import SCHEME_CONFIGS, RunConfig, build_model

    cfg = RunConfig(**SCHEME_CONFIGS["bnn_lenet"])
    model = make_model() if make_model else build_model(cfg, device=cuda())[0]
    state = train.QuantTrainState.create_for(model, lr=cfg.lr, seed=cfg.seed)
    step_fn = train.make_train_step()
    batches = _batches(data.mnist()[0], cfg.seed)
    for _ in range(RERUN_STEPS):
        step_fn(state, next(batches))
    sd = model.state_dict()
    differ = [k for k, v in snapshot.items() if not sd[k].equal(v)]
    print(f"{label} rerun from the same seed: {RERUN_STEPS} steps, "
          f"{len(snapshot) - len(differ)} of {len(snapshot)} tensors bit-equal  [{card}]",
          flush=True)
    if differ:
        fail(f"{label}: a rerun from the same seed differs in {differ}")


def serve_trained_lenet(card: str, model, example_shape, test_set) -> dict:
    """The trained LeNet in eval mode through path 1's drive and checks
    (unprepared and prepared artifacts, replays, packed == fake-quant bit for
    bit), the packed test accuracy equal to fake-quant's, and its fused
    chain against packed_apply by the JAX rule."""
    import torch

    from pytorch_quantize_impls_tpu_torch import infer

    dev = cuda()
    model.eval()
    xs, ys = test_set
    inputs = [xs[i] for i in range(CLIENTS * REQUESTS_PER_CLIENT)]
    loaded, answers, logs, launches = drive_main_path(card, model, example_shape, inputs,
                                                      label="bnn_lenet_trained")
    check_main_path(model, loaded, inputs, answers, logs)
    prepared = infer.prepare(loaded)
    with torch.inference_mode():
        xt = torch.from_numpy(xs).to(dev)
        fq = torch.cat([model(xt[i:i + 256]) for i in range(0, len(xs), 256)])
        pk = torch.cat([infer.packed_apply(model, prepared, xt[i:i + 256])
                        for i in range(0, len(xs), 256)])
    yt = torch.from_numpy(ys).to(dev)
    acc_fq = float((fq.argmax(1) == yt).double().mean())
    acc_pk = float((pk.argmax(1) == yt).double().mean())
    print(f"bnn_lenet trained, {len(xs)} test images: fake-quant accuracy {acc_fq:.4f}, packed "
          f"(prepared) {acc_pk:.4f}; logits bit-equal: {bool(torch.equal(fq, pk))}  [{card}]",
          flush=True)
    if not torch.equal(fq, pk) or acc_fq != acc_pk:
        fail("bnn_lenet trained: packed and fake-quant test logits differ")
    if acc_fq < TRAIN_MIN_ACC:
        fail(f"bnn_lenet trained: test accuracy {acc_fq:.4f} below {TRAIN_MIN_ACC}")
    chain = infer.export_fused_lenet(model, first_dtype=torch.float32)
    fused = fused_chain_engine(card, "bnn_lenet trained fused", chain, example_shape, inputs,
                               {"int8_conv2d": 1, "int8_conv2d.threshold": 1, "int8_gemm": 1})
    rng = np.random.default_rng(SEED + 66)
    grid = torch.from_numpy(grid_images(rng, XNOR_EVAL, example_shape)).to(dev)
    with torch.inference_mode():
        got, ref = infer.fused_apply(chain, grid), infer.packed_apply(model, prepared, grid)
        fa = torch.cat([infer.fused_apply(chain, xt[i:i + 256]) for i in range(0, len(xs), 256)])
    logit_rule(card, "bnn_lenet trained fused (float32 first conv) vs packed_apply", got, ref)
    shares = fused_stage_shares(chain, xt[:256])
    print(f"bnn_lenet trained fused chain: test accuracy "
          f"{float((fa.argmax(1) == yt).double().mean()):.4f}; stage shares of +1 codes "
          + ", ".join(f"{k} {v:.3f}" for k, v in shares.items()) + f"  [{card}]", flush=True)
    return {"bnn_lenet_trained": launches, "bnn_lenet_trained_fused": fused}


def train_mlp(cfg, fp32: bool, steps: int):
    """Train ``cfg``'s model (or its twin) on the card for ``steps`` steps of
    the synthetic MNIST stand-in. Returns (model in eval mode, state)."""
    from pytorch_quantize_impls_tpu_torch import data, train
    from pytorch_quantize_impls_tpu_torch.utils import build_model

    model = build_model(cfg, fp32=fp32, device=cuda())[0]
    state = train.QuantTrainState.create_for(model, lr=cfg.lr, seed=cfg.seed)
    step_fn = train.make_train_step()
    batches = _batches(data.mnist(flatten=True)[0], cfg.seed)
    for _ in range(steps):
        step_fn(state, next(batches))
    return model.eval(), state


def mlp_path(card: str) -> dict:
    """binaryconnect_mlp (784-512-512-10) and its float32 twin trained on the
    card, their accuracies and Δacc (reported); the quantized one packed and
    served once through InferenceEngine (K2 on the real-input branch),
    against fake-quant. Then the stochastic MLP: two runs from one seed end
    bit-equal, one from another seed differs."""
    import torch

    from pytorch_quantize_impls_tpu_torch import data, infer, models, nn as tnn, train
    from pytorch_quantize_impls_tpu_torch.kernels import xnor_gemm as bg
    from pytorch_quantize_impls_tpu_torch.train import run as trun
    from pytorch_quantize_impls_tpu_torch.utils import SCHEME_CONFIGS, RunConfig

    dev = cuda()
    cfg = RunConfig(**SCHEME_CONFIGS["binaryconnect_mlp"])
    test_set = data.mnist(flatten=True)[1]
    t = time.perf_counter()
    model, state = train_mlp(cfg, False, MLP_STEPS)
    twin, _ = train_mlp(cfg, True, MLP_STEPS)
    acc, acc_twin = (trun.accuracy(m, test_set, dev) for m in (model, twin))
    print(f"binaryconnect_mlp: {MLP_STEPS} steps each, quantized and float32 twin, in "
          f"{time.perf_counter() - t:.1f} s; test accuracy {acc:.4f} / {acc_twin:.4f}, Δacc "
          f"{acc - acc_twin:+.4f} (reported)  [{card}]", flush=True)
    if _clamped(state) > 1.0:
        fail("binaryconnect_mlp: a kernel left [-1, 1]")
    xs = test_set[0][:CLIENTS * REQUESTS_PER_CLIENT]
    zero_launches()
    packed = infer.pack_model(model)
    engine = logged_engine_class()(lambda x: infer.packed_apply(model, packed, x), (28 * 28,),
                                   batch_sizes=BUCKETS, device=dev)
    answers = run_engine(card, "bc_mlp_trained", engine, list(xs))
    launches = read_launches("bc_mlp_trained", (bg.decode_binary_weights,))
    forwards = len(BUCKETS) + len(engine.log)
    if launches["decode_binary_weights"] != 3 * forwards:
        fail(f"bc_mlp_trained: K2 launched {launches['decode_binary_weights']} times, expected "
             f"3 per forward x {forwards}")
    check_logged("bc_mlp_trained", engine.log, list(xs), answers,
                 {"packed_apply": lambda x: infer.packed_apply(model, packed, x)})
    with torch.inference_mode():
        xt = torch.from_numpy(test_set[0]).to(dev)
        pk, fq = infer.packed_apply(model, packed, xt), model(xt)
    gap = float(((pk - fq).abs() / (1 + fq.abs())).max())
    agree = float((pk.argmax(1) == fq.argmax(1)).double().mean())
    print(f"binaryconnect_mlp packed (K2 + float GEMMs) vs fake-quant on {len(xt)} test images: "
          f"bit-equal {bool(torch.equal(pk, fq))}, max |gap| / (1 + |ref|) {gap:.3g}, argmax "
          f"agrees on {agree:.4f}  [{card}]", flush=True)
    if gap > MLP_TOL or agree < 1.0:
        fail(f"binaryconnect_mlp: packed and fake-quant differ by {gap:.3g} / argmax {agree}")

    def stoch_run(seed: int):
        model = models.MLP(28 * 28, (512, 512, 10), layer="bin_stoch")
        tnn.init_like_flax(model, cfg.seed)
        state = train.QuantTrainState.create_for(model.to(dev), lr=cfg.lr, seed=seed)
        step_fn = train.make_train_step()
        batches = _batches(data.mnist(flatten=True)[0], cfg.seed)
        for _ in range(STOCH_STEPS):
            step_fn(state, next(batches))
        return torch.cat([p.detach().flatten() for p in model.parameters()])

    runs = [stoch_run(0), stoch_run(0), stoch_run(1)]
    same, other = torch.equal(runs[0], runs[1]), torch.equal(runs[0], runs[2])
    print(f"stochastic MLP (bin_stoch, 784-512-512-10), {STOCH_STEPS} steps from one init: "
          f"generator seed 0 twice bit-equal {same}; seed 1 equal to seed 0 {other}  [{card}]",
          flush=True)
    if not same or other:
        fail("stochastic MLP: the draws are not deterministic per (seed, step)")
    return {"bc_mlp_trained": launches}


def lenet_train_path(card: str) -> dict:
    """Path 10: bnn_lenet (width 128) built and trained on the card through
    the entry points (card against CPU first, each step from the same state),
    its loss falls, the clamp holds, a rerun gives the same bits; no kernel
    of the port launched by training; the trained weights served packed and
    fused; then the BinaryConnect MLPs (mlp_path)."""
    from pytorch_quantize_impls_tpu_torch import data, train
    from pytorch_quantize_impls_tpu_torch.utils import SCHEME_CONFIGS, RunConfig, build_model

    cfg = RunConfig(**SCHEME_CONFIGS["bnn_lenet"])
    model, example_shape, dataset = build_model(cfg, device=cuda())
    if (cfg.width, dataset) != (WIDTH, "mnist"):
        fail(f"bnn_lenet: width {cfg.width}, data {dataset}")
    cpu_model = copy.deepcopy(model).cpu()
    state = train.QuantTrainState.create_for(model, lr=cfg.lr, seed=cfg.seed)
    cpu_state = train.QuantTrainState.create_for(cpu_model, lr=cfg.lr, seed=cfg.seed)
    step_fn = train.make_train_step()
    train_set, test_set = data.mnist()
    batches = _batches(train_set, cfg.seed)
    zero_launches()
    train_card_vs_cpu(card, state, cpu_state, step_fn, batches)
    conv2_precision(card)
    del cpu_model, cpu_state
    snapshot = train_on_card(card, state, step_fn, batches, TRAIN_CHECKED_STEPS)
    trained = read_launches("bnn_lenet training", ())
    if any(trained.values()):
        fail(f"training launched a serving kernel: {trained}")
    train_rerun(card, snapshot)
    launches = serve_trained_lenet(card, model, example_shape, test_set)
    launches.update(mlp_path(card))
    return launches


# --- path 11: the CIFAR BASELINE configs trained on the card, then served -------


def _cast_batches(batches, dtype):
    """The batches' images at ``dtype`` (numpy), the labels as they are."""
    return ((x.astype(dtype), y) for x, y in batches)


def cifar_card_vs_cpu(card: str, cfg, train_set) -> None:
    """Card against CPU per step from one state (train_card_vs_cpu) at
    CIFAR_CHECK_BATCH: CIFAR_CHECKED_STEPS steps of the quantized model and
    one of its twin, first in float64 (gated: the same function on both
    devices, every tensor), then in float32 (the shares reported: a ReLU
    mask, a PACT code or a log level at its boundary flips under the other
    summation order, and the flip moves what follows it)."""
    import torch

    from pytorch_quantize_impls_tpu_torch import data, train
    from pytorch_quantize_impls_tpu_torch.utils import build_model

    dev = cuda()
    verdicts = {}
    for fp32, steps in ((False, CIFAR_CHECKED_STEPS), (True, 1)):
        base = build_model(cfg, fp32=fp32, device=dev)[0]
        for dtype in (torch.float64, torch.float32):
            model = copy.deepcopy(base).to(dtype)
            cpu_model = copy.deepcopy(model).cpu()
            state, cpu_state = (train.QuantTrainState.create_for(m, lr=cfg.lr, seed=cfg.seed)
                                for m in (model, cpu_model))
            batches = _cast_batches(data.iterate_batches(train_set, CIFAR_CHECK_BATCH,
                                                         seed=cfg.seed),
                                    np.float64 if dtype == torch.float64 else np.float32)
            label = f"{cfg.config}{' twin' if fp32 else ''} {str(dtype)[6:]}"
            verdicts[label] = train_card_vs_cpu(
                card, state, cpu_state, train.make_train_step(elastic_weight=cfg.elastic_weight),
                batches, label=label, steps=steps, gate=dtype == torch.float64)
    print(f"{cfg.config} card vs CPU gates (float64 enforced, float32 reported): "
          + ", ".join(f"{k} {'passes' if v else 'fails'}" for k, v in verdicts.items()),
          flush=True)


def cifar_train_run(card: str, cfg, fp32: bool, splits, init_from=None):
    """Train ``cfg``'s model (or twin) for CIFAR_STEPS steps on the card, as
    train.accuracy_sweep.run_one does (cosine-decayed Adam, the clamp, the
    config's elastic weight, warm-started from ``init_from``): the clamp and
    finite statistics every CIFAR_WINDOW steps, the loss falls, ms per step
    by CUDA events; CIFAR_RERUN_STEPS steps replayed from a snapshot at step
    CIFAR_RERUN_FROM give the same bits. Returns (model in eval mode,
    result dict)."""
    import torch

    from pytorch_quantize_impls_tpu_torch import data, train
    from pytorch_quantize_impls_tpu_torch.train import accuracy_sweep
    from pytorch_quantize_impls_tpu_torch.train.run import accuracy
    from pytorch_quantize_impls_tpu_torch.utils import build_model

    dev = cuda()
    label = f"{cfg.config}{' twin' if fp32 else ''}"
    model = build_model(cfg, fp32=fp32, device=dev)[0]
    out = {}
    if init_from is not None:
        out["warm_matched"] = accuracy_sweep.warm_start(model, init_from)
        alphas = sum(1 for k in model.state_dict() if k.endswith(".alpha"))
        want = len(model.state_dict()) - alphas
        print(f"{label}: warm start from the trained twin matched {out['warm_matched']} of "
              f"{len(model.state_dict())} entries (expected {want}: all but {alphas} PACT "
              "alphas)", flush=True)
        if out["warm_matched"] != want:
            fail(f"{label}: the warm start matched {out['warm_matched']} entries, not {want}")
    state = train.QuantTrainState.create_for(
        model, lr=train.cosine_decay_schedule(cfg.lr, CIFAR_STEPS), seed=cfg.seed)
    step_fn = train.make_train_step(
        elastic_weight=accuracy_sweep.elastic_weight(cfg, CIFAR_STEPS))
    batches = data.iterate_batches(splits[0], cfg.batch_size, seed=cfg.seed)
    losses, replay = [], []
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(CIFAR_STEPS):
        if state.step == CIFAR_WINDOW:
            start.record()
        if state.step == CIFAR_RERUN_FROM:
            snapshot = (copy.deepcopy(model.state_dict()),
                        copy.deepcopy(state.optimizer.state_dict()))
        batch = next(batches)
        if CIFAR_RERUN_FROM <= state.step < CIFAR_RERUN_FROM + CIFAR_RERUN_STEPS:
            replay.append(batch)
        _, m = step_fn(state, batch)
        losses.append(m["loss"])
        if state.step == CIFAR_RERUN_FROM + CIFAR_RERUN_STEPS:
            after = copy.deepcopy(model.state_dict())
        if state.step % CIFAR_WINDOW == 0:
            stats_ok = all(bool(torch.isfinite(b).all()) for b in model.buffers())
            if _clamped(state) > 1.0 or not stats_ok:
                fail(f"{label} step {state.step}: a kernel left [-1, 1] ({_clamped(state)}) or "
                     "a running statistic is not finite")
    end.record()
    torch.cuda.synchronize()
    out["ms_per_step"] = start.elapsed_time(end) / (CIFAR_STEPS - CIFAR_WINDOW)
    loss = torch.stack(losses).cpu().numpy()
    first, last = float(loss[:CIFAR_WINDOW].mean()), float(loss[-CIFAR_WINDOW:].mean())
    profiled = copy.deepcopy(state)
    out["profile"] = profile_line(lambda: step_fn(profiled, next(batches)), "step", 10)
    del profiled
    model.eval()
    out["accuracy"] = accuracy(model, splits[1], dev)
    print(f"{label} trained {state.step} steps on the card (batch {cfg.batch_size}, cosine from "
          f"lr {cfg.lr}{', elastic weight ' + str(cfg.elastic_weight) if cfg.elastic_weight else ''}"
          f"): mean loss of the first {CIFAR_WINDOW} steps {first:.4f}, of the last {last:.4f}; "
          f"every {CIFAR_WINDOW} steps the kernels in [-1, 1] (max {_clamped(state)}) and the "
          f"statistics finite; {out['ms_per_step']:.3f} ms per step, "
          f"{1e3 * cfg.batch_size / out['ms_per_step']:.1f} images/s (CUDA events over "
          f"{CIFAR_STEPS - CIFAR_WINDOW} steps); test accuracy {out['accuracy']:.4f}  [{card}]",
          flush=True)
    print(f"{label} train step {out['profile']}  [{card}]", flush=True)
    if not last < first:
        fail(f"{label}: the loss did not fall ({first:.4f} -> {last:.4f})")
    final = copy.deepcopy(model.state_dict())
    model.train()
    model.load_state_dict(snapshot[0])
    state.optimizer.load_state_dict(snapshot[1])
    state.step = CIFAR_RERUN_FROM
    for batch in replay:
        step_fn(state, batch)
    sd = model.state_dict()
    differ = [k for k, v in after.items() if not sd[k].equal(v)]
    print(f"{label}: steps {CIFAR_RERUN_FROM + 1}-{CIFAR_RERUN_FROM + CIFAR_RERUN_STEPS} "
          f"replayed from a snapshot: {len(after) - len(differ)} of {len(after)} tensors "
          f"bit-equal  [{card}]", flush=True)
    if differ:
        fail(f"{label}: a replay from the same snapshot differs in {differ}")
    model.load_state_dict(final)
    return model.eval(), out


def pact_alpha_check(card: str, cfg, model, x, y) -> None:
    """The trained PACT ResNet: every alpha moved from its init, and its
    gradient with the penalty less its gradient without is 2 lambda alpha
    (deterministic cuDNN: the cross-entropy part is the same bits in both)."""
    import torch

    from pytorch_quantize_impls_tpu_torch import nn as tnn, train

    m = copy.deepcopy(model).train()
    alphas = [a for a in (p.alpha for p in m.modules() if isinstance(p, tnn.PACT))]
    init = tnn.PACT().alpha.item()
    grads = []
    for weight in (cfg.elastic_weight, 0.0):
        m.zero_grad(set_to_none=True)
        with train.steps.fp32_cudnn():
            loss = train.cross_entropy(m(x), y)
            (loss + weight * tnn.collect_elastic_losses(m)).backward()
        grads.append(torch.stack([a.grad for a in alphas]))
    a = torch.stack(alphas).detach()
    term, want = grads[0] - grads[1], 2 * cfg.elastic_weight * a
    # a float32 rounding of the sum of the two parts, and a few of the
    # penalty's gradient (lambda, 2, alpha) and of 2 lambda alpha
    bound = torch.finfo(torch.float32).eps * (grads[0].abs() + 2 * want.abs())
    ratio = float(((term - want).abs() / bound).max())
    moved = int((a != init).sum())
    print(f"{cfg.config} trained: {moved} of {len(alphas)} PACT alphas moved from {init} (now "
          f"{float(a.min()):.4f}..{float(a.max()):.4f}); the penalty's part of their gradients "
          f"is 2 lambda alpha within {ratio:.3g} roundings (at most 1)  [{card}]", flush=True)
    if moved != len(alphas) or ratio > 1.0:
        fail(f"{cfg.config}: {moved} alphas moved; the penalty term is {ratio:.3g} roundings off "
             "2 lambda alpha")


def remat_check(card: str, cfg, model, x, y) -> None:
    """One step of the trained ResNet with remat=True against remat=False,
    from the same state on the same batch: the same loss, gradients,
    parameters and running statistics, bit for bit, the statistics moved
    once (as one training forward moves them)."""
    import torch

    from pytorch_quantize_impls_tpu_torch import train

    runs = []
    for remat in (False, True):
        m = copy.deepcopy(model)
        m.remat = remat
        state = train.QuantTrainState.create_for(m, lr=cfg.lr, seed=cfg.seed)
        _, met = train.make_train_step(elastic_weight=cfg.elastic_weight)(state, (x, y))
        runs.append((m, float(met["loss"]), {k: p.grad.clone() for k, p in m.named_parameters()}))
    once = copy.deepcopy(model).train()
    with torch.no_grad(), train.steps.fp32_cudnn():
        once(x)
    (plain, loss, grads), (remat, loss_r, grads_r) = runs
    differ = [k for k in grads if not torch.equal(grads[k], grads_r[k])]
    sd, sd_r, sd_once = plain.state_dict(), remat.state_dict(), once.state_dict()
    differ += [k for k in sd if not torch.equal(sd[k], sd_r[k])]
    moved_twice = [k for k in sd_r if "running" in k and not torch.equal(sd_r[k], sd_once[k])]
    print(f"{cfg.config} trained, one step remat=True against remat=False: loss {loss_r} / "
          f"{loss}; {len(grads) + len(sd) - len(differ)} of {len(grads) + len(sd)} gradient and "
          f"state tensors bit-equal; running statistics as one forward moves them: "
          f"{not moved_twice}  [{card}]", flush=True)
    if loss != loss_r or differ or moved_twice:
        fail(f"{cfg.config} remat: loss {loss_r} / {loss}, differ in {differ}, statistics "
             f"moved otherwise in {moved_twice}")


def _split_logits(forward, xs, dev):
    import torch

    with torch.inference_mode():
        return torch.cat([forward(torch.from_numpy(xs[i:i + RESNET_BATCH]).to(dev))
                          for i in range(0, len(xs), RESNET_BATCH)])


def _accuracy_line(card: str, label: str, ys, logits: dict) -> None:
    import torch

    yt = torch.from_numpy(ys).to(cuda())
    print(f"{label}, {len(ys)} test images: accuracy " + ", ".join(
        f"{name} {float((y.argmax(1) == yt).double().mean()):.4f}" for name, y in logits.items())
        + f"  [{card}]", flush=True)


def convs_vs_fake_quant(card: str, label: str, model, recs, x) -> None:
    """Every packed conv of ``model`` on the input packed_apply gives it,
    against the layer's fake-quant forward on that input: within SHIFT_RTOL
    of |x| conv |w_q| (the decoded grid (2c - n) / n and fake-quant's
    2 c / n - 1 differ by an ulp). End to end a W4A4 model is chaotic in code
    space (a PACT code at its boundary flips and moves what follows), so this
    is where the packed path is held exactly."""
    import torch

    from pytorch_quantize_impls_tpu_torch import infer
    from pytorch_quantize_impls_tpu_torch.kernels.conv import conv2d_nhwc
    from pytorch_quantize_impls_tpu_torch.nn import QuantConv

    convs = {m: name for name, m in model.named_modules()
             if isinstance(m, QuantConv) and m.weight_quant is not None}
    seen = {}
    hooks = [m.register_forward_hook(lambda m, args, out: seen.__setitem__(
        convs[m], (args[0].clone(), out.clone()))) for m in convs]
    try:
        with torch.inference_mode():
            infer.packed_apply(model, recs, x)
    finally:
        for h in hooks:
            h.remove()
    worst = 0.0
    with torch.inference_mode():
        for m, name in convs.items():
            xin, y = seen[name]
            ref = m.fake_quant_forward(xin)
            wq = m.weight_quant(m.weight).abs()
            bound = conv2d_nhwc(xin.abs(), wq, m.strides, m.padding).clamp_min(1e-30)
            worst = max(worst, float(((y - ref).abs() / bound).max()))
    print(f"{label}: each of {len(convs)} packed convs on its packed_apply input within "
          f"{worst:.3g} of (|x| conv |w_q|) of its fake-quant forward (tolerance {SHIFT_RTOL}) "
          f"on {x.shape[0]} images  [{card}]", flush=True)
    if worst > SHIFT_RTOL:
        fail(f"{label}: a packed conv is {worst:.3g} of (|x| conv |w_q|) off its fake-quant forward")


def serve_trained_cifar(card: str, cfg, model, test_set, train_set) -> dict:
    """The trained model in eval mode: pack_model -> save_packed ->
    load_packed -> packed_apply over the test split unprepared and prepared
    (xnor_cifar: K2 and K5 with alpha, K1 in conv3's im2col check, against
    fake-quant by the JAX logit rule; the ResNets: K7 decoding every
    real-input block conv, VGG: K9 and K8 at the head, against fake-quant
    within the seam), the packed accuracy beside fake-quant's; xnor_cifar
    also as its fused chain (K5 threshold, affine) with the K map off and
    BatchNorm recalibrated, the float32 first conv held to the JAX rule
    against packed_apply of that model, the bf16 first conv's agreement
    reported. Returns the launches by path."""
    import torch

    from pytorch_quantize_impls_tpu_torch import infer
    from pytorch_quantize_impls_tpu_torch.kernels import int8_conv as ic
    from pytorch_quantize_impls_tpu_torch.kernels import packed_matmul as pm
    from pytorch_quantize_impls_tpu_torch.kernels import shift_matmul as sm
    from pytorch_quantize_impls_tpu_torch.kernels import xnor_gemm as bg
    from pytorch_quantize_impls_tpu_torch.models import XNORConvNet

    dev = cuda()
    xs, ys = test_set
    required = {"xnor_cifar": (bg.decode_binary_weights, ic.int8_conv2d, bg.binary_gemm),
                "dorefa_resnet20": (pm.decode_dorefa_weights,),
                "dorefa_resnet20_w4": (pm.decode_dorefa_weights,),
                "logquant_vgg": (sm.decode_log_weights, sm.shift_gemm)}[cfg.config]
    path_name = f"{cfg.config}_trained"
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, f"{cfg.config}.npz")
        infer.save_packed(path, infer.pack_model(model))
        zero_launches()
        loaded = infer.load_packed(path, device=dev)
        logits = {"fake-quant": _split_logits(model, xs, dev)}
        logits["packed"] = _split_logits(lambda x: infer.packed_apply(model, loaded, x), xs, dev)
        prepared = infer.prepare(loaded)
        logits["packed prepared"] = _split_logits(
            lambda x: infer.packed_apply(model, prepared, x), xs, dev)
        if cfg.config == "xnor_cifar":
            xnor_direct_vs_im2col(model, loaded,
                                  torch.from_numpy(xs[:XNOR_IM2COL_BATCH]).to(dev))
        elif cfg.config != "logquant_vgg":
            for name, recs in (("packed", loaded), ("packed prepared", prepared)):
                convs_vs_fake_quant(card, f"{cfg.config} trained {name}", model, recs,
                                    torch.from_numpy(xs[:RESNET_BATCH]).to(dev))
        launches = {path_name: read_launches(path_name, required)}
    fq = logits["fake-quant"]
    for name in ("packed", "packed prepared"):
        if cfg.config == "xnor_cifar":
            logit_rule(card, f"{cfg.config} trained {name} vs fake-quant", logits[name], fq)
        else:
            tol = ((VGG_LOGIT_ATOL, VGG_LOGIT_RTOL) if cfg.config == "logquant_vgg"
                   else (RESNET_LOGIT_TOL, 0.0))
            forward = (lambda x: infer.packed_apply(model, loaded, x)) if name == "packed" else (
                lambda x: infer.packed_apply(model, prepared, x))
            # W4A4 with PACT: held per conv above, its rows' seam reported
            against_fake_quant(card, f"{cfg.config} trained {name}", model, forward, xs, *tol,
                               rows_gated=cfg.config != "dorefa_resnet20")
    _accuracy_line(card, f"{cfg.config} trained", ys, logits)
    if cfg.config != "xnor_cifar":
        return launches
    # the fused chain needs the K map off: the same weights, their own statistics
    model_k = XNORConvNet(widths=model.widths, use_input_scale_map=False).to(dev)
    model_k.load_state_dict(model.state_dict())
    model_k.eval()
    calibrate_batchnorm(model_k, torch.from_numpy(train_set[0][:XNOR_CALIB]).to(dev))
    packed_k = infer.prepare(infer.pack_model(model_k))
    zero_launches()
    chain = infer.export_fused_chain(model_k, first_dtype=torch.float32)
    fused = _split_logits(lambda x: infer.fused_apply(chain, x), xs, dev)
    forwards = -(-len(xs) // RESNET_BATCH)
    launches[path_name + "_fused"] = counts = read_launches(path_name + "_fused",
                                                            (ic.int8_conv2d,))
    per_forward = {"int8_conv2d": 5, "int8_conv2d.threshold": 4, "int8_conv2d.affine": 1}
    if any(counts[k] != n * forwards for k, n in per_forward.items()):
        fail(f"{path_name}_fused: K5 launches {counts}, expected {per_forward} per forward x "
             f"{forwards}")
    ref = _split_logits(lambda x: infer.packed_apply(model_k, packed_k, x), xs, dev)
    logit_rule(card, "xnor_cifar trained fused (float32 first conv) vs packed_apply (K off)",
               fused, ref)
    bf16 = _split_logits(lambda x: infer.fused_apply(infer.export_fused_chain(model_k), x), xs,
                         dev)
    gap = (bf16 - ref).abs()
    bad = float((gap > LOGIT_TOL + LOGIT_TOL * ref.abs()).double().mean())
    agree = int((bf16.argmax(1) == ref.argmax(1)).sum())
    holds = not bad or (bad <= 1 - XNOR_MIN_WITHIN and agree == len(xs))
    print(f"xnor_cifar trained fused, bf16 first conv (the JAX default; reported): "
          f"{100 * bad:.3f}% of logits beyond {LOGIT_TOL} + {LOGIT_TOL} |ref| of packed_apply "
          f"(K off), argmax agrees on {agree}/{len(xs)}; the JAX rule "
          f"{'holds' if holds else 'does not hold'}  [{card}]", flush=True)
    _accuracy_line(card, "xnor_cifar trained, K map off, BatchNorm recalibrated", ys,
                   {"packed": ref, "fused float32 first conv": fused, "fused bf16 first conv": bf16})
    return launches


def cifar_train_path(card: str) -> dict:
    """Path 11: xnor_cifar, dorefa_resnet20 (PACT, its alpha penalty),
    dorefa_resnet20_w4 and logquant_vgg at their published widths, built and
    trained on the card through the entry points: card against CPU per step
    (cifar_card_vs_cpu), the twin trained CIFAR_STEPS steps and the
    quantized model warm-started from it where the config says so, then the
    quantized model CIFAR_STEPS steps (cifar_train_run; no kernel launched
    by training), PACT's alpha (pact_alpha_check) and remat (remat_check) on
    the trained PACT ResNet, and the trained weights served
    (serve_trained_cifar)."""
    import torch

    from pytorch_quantize_impls_tpu_torch import data
    from pytorch_quantize_impls_tpu_torch.utils import SCHEME_CONFIGS, RunConfig

    dev = cuda()
    train_set, test_set = data.cifar10()
    launches = {}
    for name in CIFAR_CONFIGS:
        cfg = RunConfig(**SCHEME_CONFIGS[name])
        t = time.perf_counter()
        cifar_card_vs_cpu(card, cfg, train_set)
        t_check = time.perf_counter() - t
        zero_launches()
        twin = None
        if cfg.warm_start:
            twin, twin_out = cifar_train_run(card, cfg, True, (train_set, test_set))
        model, out = cifar_train_run(card, cfg, False, (train_set, test_set), init_from=twin)
        trained = read_launches(f"{name} training", ())
        if any(trained.values()):
            fail(f"{name}: training launched a serving kernel: {trained}")
        if twin is not None:
            print(f"{name}: {CIFAR_STEPS} steps each, twin {twin_out['accuracy']:.4f}, quantized "
                  f"(warm) {out['accuracy']:.4f}, Δacc {out['accuracy'] - twin_out['accuracy']:+.4f} "
                  f"(reported; the full budget runs through train.accuracy_sweep)  [{card}]",
                  flush=True)
        del twin
        if name == "dorefa_resnet20":
            x, y = (torch.from_numpy(a[:cfg.batch_size]).to(dev) for a in train_set)
            pact_alpha_check(card, cfg, model, x, y)
            remat_check(card, cfg, model, x, y)
        launches.update(serve_trained_cifar(card, cfg, model, test_set, train_set))
        print(f"{name} path 11 took {time.perf_counter() - t:.1f} s ({t_check:.1f} s card vs "
              "CPU)", flush=True)
    return launches


# --- the 8-bit Adam path: train, checkpoint, kill and resume, export, serve ---


def _adam8_state(cfg, model, optimizer: str = "adam8"):
    """A train state of ``model`` with the cosine schedule over ADAM8_STEPS:
    QuantizedAdam ("adam8") or torch Adam ("adam")."""
    from pytorch_quantize_impls_tpu_torch import train

    sched = train.cosine_decay_schedule(cfg.lr, ADAM8_STEPS)
    if optimizer == "adam8":
        return train.QuantTrainState.create_for(
            model, optimizer=train.QuantizedAdam(model.parameters(), lr=sched), seed=cfg.seed)
    return train.QuantTrainState.create_for(model, lr=sched, seed=cfg.seed)


def _checkpoint_tensors(ckpt: dict) -> dict:
    """A checkpoint's (or a state's) model and optimizer tensors by name,
    copied to the host."""
    out = {("model", k): v.detach().to("cpu", copy=True) for k, v in ckpt["model"].items()}
    out.update({("optimizer", i, k): v.detach().to("cpu", copy=True)
                for i, st in ckpt["optimizer"]["state"].items() for k, v in st.items()})
    out[("count",)] = tuple(g.get("count", -1) for g in ckpt["optimizer"]["param_groups"])
    return out


def _state_tensors(state) -> dict:
    return _checkpoint_tensors({"model": state.model.state_dict(),
                                "optimizer": state.optimizer.state_dict()})


def _bit_equal(label: str, got: dict, ref: dict) -> None:
    """Every entry of ``ref`` in ``got`` with its dtype and bits."""
    import torch

    def same(a, b):
        if isinstance(a, torch.Tensor):
            return a.dtype == b.dtype and torch.equal(a, b)
        return a == b

    differ = [k for k in ref if k not in got or not same(got[k], ref[k])]
    print(f"{label}: {len(ref) - len(differ)} of {len(ref)} entries bit-equal", flush=True)
    if differ or got.keys() != ref.keys():
        fail(f"{label}: differs in {differ[:8]} (the same entries: {got.keys() == ref.keys()})")


def adam8_card_vs_cpu(card: str, state, batch) -> None:
    """(a) One QuantizedAdam update of bnn_lenet from one state, on the card
    and in a CPU copy, from the card's gradients: each parameter tensor by
    _tensor_gate, each tensor's codes equal but for at most ADAM8_CODE_SHARE
    of them off by one, the scales and the small tensors' float32 moments
    within ADAM8_RTOL."""
    import torch

    from pytorch_quantize_impls_tpu_torch import train
    from pytorch_quantize_impls_tpu_torch.nn import quant_generator
    from pytorch_quantize_impls_tpu_torch.train.steps import fp32_cudnn

    model, opt = state.model, state.optimizer
    cpu_model = copy.deepcopy(model).cpu()
    cpu_opt = train.QuantizedAdam(cpu_model.parameters(), lr=opt.schedule)
    cpu_opt.load_state_dict(opt.state_dict())
    cpu_state = train.QuantTrainState.create_for(cpu_model, optimizer=cpu_opt, seed=state.seed)
    cpu_state.step = state.step
    x, y = (torch.from_numpy(a).to(cuda()) for a in batch)
    model.train()
    opt.zero_grad(set_to_none=True)
    with fp32_cudnn(), quant_generator(state.step_generator()):
        train.cross_entropy(model(x), y).backward()
    for p, pc in zip(model.parameters(), cpu_model.parameters()):
        pc.grad = p.grad.detach().cpu()
    lr = opt.schedule(opt.param_groups[0]["count"])
    state.apply_gradients()
    cpu_state.apply_gradients()
    failed, worst = [], {"parameters": 1.0, "codes": 0.0, "scales": 0.0, "moments": 0.0}
    cpu_params = dict(cpu_model.named_parameters())
    for name, p in model.named_parameters():
        pc = cpu_params[name]
        share, _, ok = _tensor_gate(_within(p.detach().cpu(), pc.detach(), grad=pc.grad, lr=lr))
        worst["parameters"] = min(worst["parameters"], share)
        if not ok:
            failed.append(f"parameter {name}")
        for key, ref in cpu_opt.state[pc].items():
            got = opt.state[p][key].cpu()
            if key.endswith("_codes"):
                d = (got.to(torch.int32) - ref.to(torch.int32)).abs()
                off = float((d > 0).double().mean())
                worst["codes"] = max(worst["codes"], off)
                if off > ADAM8_CODE_SHARE or int(d.max()) > 1:
                    failed.append(f"{name} {key}: {off:.2e} off, by up to {int(d.max())}")
                continue
            rel = float(((got - ref).abs() / ref.abs().clamp_min(1e-30)).max())
            kind = "scales" if key.endswith("_scale") else "moments"
            worst[kind] = max(worst[kind], rel)
            if rel > ADAM8_RTOL:
                failed.append(f"{name} {key}: {rel:.2e} relative")
    print(f"bnn_lenet QuantizedAdam update {state.step}, card vs CPU from one state and the "
          f"card's gradients: least share of a parameter tensor's entries within tolerance "
          f"{worst['parameters']:.7f}; largest share of a tensor's codes off by one "
          f"{worst['codes']:.2e}; largest relative difference of a scale {worst['scales']:.3g}, "
          f"of a float32 moment {worst['moments']:.3g}  [{card}]", flush=True)
    if failed:
        fail(f"bnn_lenet QuantizedAdam: card and CPU differ: {failed[:6]}")


def adam8_train(card: str, state, batches, ckpt_dir: str):
    """(b) Train to ADAM8_STEPS with QuantizedAdam, the clamp and the cosine
    schedule, saving a checkpoint every ADAM8_SAVE_EVERY steps (async): the
    clamp and finite statistics every ADAM8_WINDOW steps, the loss falls, ms
    per step by CUDA events. Returns (ms per step, the state's tensors at
    ADAM8_RESUME_TO)."""
    import torch

    from pytorch_quantize_impls_tpu_torch import train
    from pytorch_quantize_impls_tpu_torch.utils import CheckpointManager

    step_fn = train.make_train_step()
    mgr = CheckpointManager(ckpt_dir, max_to_keep=ADAM8_STEPS // ADAM8_SAVE_EVERY)
    losses, snapshot = [], None
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    timed_from = None
    while state.step < ADAM8_STEPS:
        if state.step == ADAM8_WINDOW:
            start.record()
            timed_from = state.step
        _, m = step_fn(state, next(batches))
        losses.append(m["loss"])
        if state.step % ADAM8_SAVE_EVERY == 0:
            mgr.save(state)
        if state.step == ADAM8_RESUME_TO:
            snapshot = _state_tensors(state)
        if state.step % ADAM8_WINDOW == 0:
            stats_ok = all(bool(torch.isfinite(b).all()) for b in state.model.buffers())
            if _clamped(state) > 1.0 or not stats_ok:
                fail(f"bnn_lenet QuantizedAdam step {state.step}: a kernel left [-1, 1] "
                     f"({_clamped(state)}) or a running statistic is not finite")
    end.record()
    torch.cuda.synchronize()
    mgr.close()
    step_ms = start.elapsed_time(end) / (ADAM8_STEPS - timed_from)
    loss = torch.stack(losses).cpu().numpy()
    first, last = float(loss[:ADAM8_WINDOW].mean()), float(loss[-ADAM8_WINDOW:].mean())
    print(f"bnn_lenet trained {state.step} steps with QuantizedAdam (cosine over {ADAM8_STEPS}, "
          f"batch {TRAIN_BATCH}): mean loss of the first {ADAM8_WINDOW} steps {first:.4f}, of "
          f"the last {last:.4f}; the kernels in [-1, 1] and the statistics finite every "
          f"{ADAM8_WINDOW} steps; {step_ms:.3f} ms per step (CUDA events over "
          f"{ADAM8_STEPS - timed_from} steps, checkpoint saves included); checkpoints "
          f"{mgr.all_steps()}, {os.path.getsize(mgr.path(ADAM8_STEPS))} B each file  [{card}]",
          flush=True)
    if last > TRAIN_LOSS_DROP * first:
        fail(f"bnn_lenet QuantizedAdam: the loss fell from {first:.4f} only to {last:.4f}")
    return step_ms, snapshot


def adam8_costs(card: str, cfg, train_set, state, step_ms: float) -> None:
    """(b) What the 8-bit Adam costs against torch Adam: the optimizer state
    in bytes (QuantizedAdam's must be ADAM8_STATE_BYTES, counted as the JAX
    package counts it), ms per step by CUDA events (torch Adam's over
    ADAM8_WINDOW steps after as many), each step's profile (wall, busy,
    idle, launches) and the update alone (CUDA events and profile)."""
    from pytorch_quantize_impls_tpu_torch import train
    from pytorch_quantize_impls_tpu_torch.utils import build_model

    adam = _adam8_state(cfg, build_model(cfg, device=cuda())[0], "adam")
    step_fn = train.make_train_step()
    batches = _batches(train_set, cfg.seed)
    for _ in range(ADAM8_WINDOW):
        step_fn(adam, next(batches))
    adam_ms = cuda_ms(lambda: step_fn(adam, next(batches)), iters=ADAM8_WINDOW, warmup=0)
    sizes = {name: train.optimizer_state_bytes(s.optimizer)
             for name, s in (("QuantizedAdam", state), ("torch Adam", adam))}
    print(f"bnn_lenet optimizer state: QuantizedAdam {sizes['QuantizedAdam']} B, torch Adam "
          f"{sizes['torch Adam']} B (a step count per tensor; optax's Adam state is 40238084 "
          f"B), ratio {sizes['QuantizedAdam'] / sizes['torch Adam']:.4f}  [{card}]", flush=True)
    if sizes["QuantizedAdam"] != ADAM8_STATE_BYTES:
        fail(f"QuantizedAdam state {sizes['QuantizedAdam']} B, expected {ADAM8_STATE_BYTES}")
    for name, s, ms, it in (("QuantizedAdam", state, step_ms, _batches(train_set, cfg.seed + 1)),
                            ("torch Adam", adam, adam_ms, batches)):
        line = profile_line(lambda: step_fn(s, next(it)), "step", 20)
        update_ms = cuda_ms(s.optimizer.step, iters=20, warmup=2)
        update = profile_line(s.optimizer.step, "update", 20)
        print(f"bnn_lenet train step with {name}: {ms:.3f} ms per step by CUDA events; step "
              f"{line}; the optimizer update alone {update_ms:.4f} ms by CUDA events, "
              f"{update}  [{card}]", flush=True)


def adam8_kill_and_resume(card: str, workdir: str) -> str:
    """(c) ``train.run --config bnn_lenet`` on the card, checkpointing every
    KILL_EVERY steps: one run SIGKILLed right after its first finalized
    checkpoint and run again (it must print ``resumed from step`` below
    KILL_STEPS), one uninterrupted run beside it; their final checkpoints
    bit-equal tensor by tensor, Adam's state included. Returns the
    uninterrupted run's checkpoint directory."""
    import signal

    import torch

    from pytorch_quantize_impls_tpu_torch.utils.checkpoint import MARKER

    repo = os.path.dirname(os.path.abspath(__file__))
    args = [sys.executable, "-m", f"{PORT}.train.run", "--config", "bnn_lenet", "--steps",
            str(KILL_STEPS), "--ckpt-every", str(KILL_EVERY), "--device", str(cuda())]
    dirs = {name: os.path.join(workdir, name) for name in ("whole", "killed")}
    t0 = time.perf_counter()
    procs = {}
    try:
        for name, d in dirs.items():
            with open(os.path.join(workdir, f"{name}.log"), "w") as log:
                procs[name] = subprocess.Popen(args + ["--checkpoint-dir", d], cwd=repo,
                                               stdout=log, stderr=subprocess.STDOUT)
        first = os.path.join(dirs["killed"], str(KILL_EVERY), MARKER)
        while not os.path.exists(first):
            if procs["killed"].poll() is not None or time.perf_counter() - t0 > KILL_WAIT_S:
                fail(f"train.run made no checkpoint at step {KILL_EVERY} (exit "
                     f"{procs['killed'].returncode}; see {workdir}/killed.log)")
            time.sleep(0.002)
        procs["killed"].send_signal(signal.SIGKILL)
        procs["killed"].wait(timeout=60)
        killed_with = sorted(os.listdir(dirs["killed"]))
        rerun = subprocess.run(args + ["--checkpoint-dir", dirs["killed"]], cwd=repo,
                               capture_output=True, text=True, timeout=KILL_WAIT_S)
        procs["whole"].wait(timeout=KILL_WAIT_S)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    resumed = [ln for ln in rerun.stdout.splitlines() if ln.startswith("resumed from step")]
    print(f"train.run killed (SIGKILL) with {killed_with} in its directory; the rerun: "
          f"{resumed[0] if resumed else 'no resume line'}; exit codes {rerun.returncode} "
          f"(rerun), {procs['whole'].returncode} (uninterrupted); "
          f"{time.perf_counter() - t0:.1f} s for the three runs  [{card}]", flush=True)
    if rerun.returncode or procs["whole"].returncode:
        fail(f"train.run failed: {rerun.stdout[-2000:]} {rerun.stderr[-2000:]}")
    if not resumed or int(resumed[0].split()[-1]) >= KILL_STEPS:
        fail(f"the rerun did not resume from a checkpoint before {KILL_STEPS}: {resumed}")
    ckpts = {name: torch.load(os.path.join(d, str(KILL_STEPS), "state.pt"), weights_only=True)
             for name, d in dirs.items()}
    if ckpts["killed"]["step"] != KILL_STEPS or ckpts["whole"]["step"] != KILL_STEPS:
        fail("train.run's final checkpoints are not at its last step")
    _bit_equal(f"train.run killed and resumed against uninterrupted, the final checkpoint "
               f"(step {KILL_STEPS}, model and Adam's state, "
               f"{os.path.getsize(os.path.join(dirs['whole'], str(KILL_STEPS), 'state.pt'))} B)",
               _checkpoint_tensors(ckpts["killed"]), _checkpoint_tensors(ckpts["whole"]))
    return dirs["whole"]


def adam8_resume(card: str, cfg, train_set, ckpt_dir: str, snapshot: dict) -> None:
    """(d) A fresh QuantizedAdam state (weights of another seed) restored
    from the step-ADAM8_SAVE_EVERY checkpoint and run to ADAM8_RESUME_TO on
    the batch stream from there: bit-equal to the uninterrupted run at that
    step, codes, scales and count included. (e) The newest checkpoint
    truncated: restore() returns the one before it, bit-equal to the run at
    its step."""
    import dataclasses

    from pytorch_quantize_impls_tpu_torch import data, train
    from pytorch_quantize_impls_tpu_torch.utils import CheckpointManager, build_model

    def fresh():
        other = dataclasses.replace(cfg, seed=cfg.seed + 1)
        return _adam8_state(cfg, build_model(other, device=cuda())[0])

    mgr = CheckpointManager(ckpt_dir)
    state = mgr.restore(fresh(), step=ADAM8_SAVE_EVERY)
    step_fn = train.make_train_step()
    batches = data.iterate_batches(train_set, TRAIN_BATCH, seed=cfg.seed, start_step=state.step)
    while state.step < ADAM8_RESUME_TO:
        step_fn(state, next(batches))
    _bit_equal(f"QuantizedAdam restored at step {ADAM8_SAVE_EVERY} into other weights and run "
               f"to {ADAM8_RESUME_TO}, against the uninterrupted run", _state_tensors(state),
               snapshot)
    newest = mgr.latest_step()
    with open(mgr.path(newest), "r+b") as f:
        f.truncate(os.path.getsize(mgr.path(newest)) // 2)
    restored = mgr.restore(fresh())
    print(f"the newest checkpoint (step {newest}) truncated: restore() returned step "
          f"{restored.step if restored is not None else None}  [{card}]", flush=True)
    if restored is None or restored.step != ADAM8_RESUME_TO:
        fail(f"a torn checkpoint at step {newest} did not fall back to {ADAM8_RESUME_TO}")
    _bit_equal(f"the checkpoint before the torn one, against the run at step "
               f"{ADAM8_RESUME_TO}", _state_tensors(restored), snapshot)


def _artifact(path: str):
    with np.load(path, allow_pickle=False) as f:
        return json.loads(str(f["__meta__"])), {k: f[k] for k in f.files if k != "__meta__"}


def adam8_export(card: str, ckpt_dir: str, workdir: str):
    """(f) The export CLI (``infer.host_export``) in a process that sees no
    card, from (c)'s final checkpoint, with the native codec: its artifact
    equals pack_model + save_packed of the same weights on the card in every
    array and record field (alpha, where there is one, within ADAM8_RTOL).
    Returns (the artifact's path, the model on the card with those weights,
    its input shape)."""
    from pytorch_quantize_impls_tpu_torch import infer
    from pytorch_quantize_impls_tpu_torch.utils import (
        SCHEME_CONFIGS, CheckpointManager, RunConfig, build_model, native)

    if not native.available():
        fail("the host codec (utils.native, g++) did not build")
    out = os.path.join(workdir, "exported.npz")
    t = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", f"{PORT}.infer.host_export", "--config",
                        "bnn_lenet", "--checkpoint-dir", ckpt_dir, "--out", out],
                       cwd=os.path.dirname(os.path.abspath(__file__)),
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""), capture_output=True,
                       text=True, timeout=KILL_WAIT_S)
    print(f"host export (no card visible), {time.perf_counter() - t:.1f} s: "
          f"{r.stdout.strip()}", flush=True)
    if r.returncode or "native C++" not in r.stdout:
        fail(f"the host export failed or ran without the native codec: {r.stderr[-2000:]}")
    model, example_shape, _ = build_model(RunConfig(**SCHEME_CONFIGS["bnn_lenet"]),
                                          device=cuda())
    model.load_state_dict(CheckpointManager(ckpt_dir).load(map_location=cuda())["model"])
    ref = os.path.join(workdir, "card.npz")
    infer.save_packed(ref, infer.pack_model(model))
    (meta, arrays), (meta_ref, arrays_ref) = _artifact(out), _artifact(ref)
    if meta != meta_ref or arrays.keys() != arrays_ref.keys():
        fail(f"the host artifact's records differ from the card's: {meta} / {meta_ref}")
    for k, ref_arr in arrays_ref.items():
        got = arrays[k]
        same = (np.allclose(got, ref_arr, rtol=ADAM8_RTOL, atol=0) if k.endswith("_alpha")
                else got.dtype == ref_arr.dtype and np.array_equal(got, ref_arr))
        if not same:
            fail(f"the host artifact's {k} differs from pack_model's on the card")
    print(f"host artifact == pack_model + save_packed on the card: {len(meta)} records, "
          f"{len(arrays)} arrays ({sum(a.nbytes for a in arrays.values())} B)  [{card}]",
          flush=True)
    return out, model, example_shape


def adam8_path(card: str) -> dict:
    """The 8-bit Adam path (after path 11): bnn_lenet (width 128) on the card
    with QuantizedAdam, card against CPU for one update (a), 300 steps with
    the state's bytes and both optimizers' costs (b), train.run killed and
    resumed bit for bit (c), an in-process resume and a torn checkpoint (d,
    e), the export CLI on the host (f), and its artifact served through
    InferenceEngine on the whole test split, packed == fake-quant bit for
    bit (g, launches ``bnn_lenet_exported``: K1, K2, K3, K5)."""
    from pytorch_quantize_impls_tpu_torch import data, train
    from pytorch_quantize_impls_tpu_torch.utils import SCHEME_CONFIGS, RunConfig, build_model

    cfg = RunConfig(**SCHEME_CONFIGS["bnn_lenet"])
    train_set, test_set = data.mnist()
    with tempfile.TemporaryDirectory() as workdir:
        zero_launches()
        state = _adam8_state(cfg, build_model(cfg, device=cuda())[0])
        batches = _batches(train_set, cfg.seed)
        step_fn = train.make_train_step()
        for _ in range(TRAIN_CHECKED_STEPS):
            step_fn(state, next(batches))
        adam8_card_vs_cpu(card, state, next(batches))
        step_ms, snapshot = adam8_train(card, state, batches, os.path.join(workdir, "adam8"))
        trained = read_launches("bnn_lenet QuantizedAdam training", ())
        if any(trained.values()):
            fail(f"training launched a serving kernel: {trained}")
        adam8_costs(card, cfg, train_set, state, step_ms)
        del state
        adam8_resume(card, cfg, train_set, os.path.join(workdir, "adam8"), snapshot)
        ckpt_dir = adam8_kill_and_resume(card, workdir)
        artifact, model, example_shape = adam8_export(card, ckpt_dir, workdir)
        model.eval()
        xs, ys = test_set
        inputs = list(xs)
        loaded, answers, logs, launches = drive_main_path(
            card, model, example_shape, inputs, label="bnn_lenet_exported", artifact=artifact,
            rounds=True)
        check_main_path(model, loaded, inputs, answers, logs)
    for name in answers:
        acc = float(np.mean([int(np.argmax(a)) == y for a, y in zip(answers[name], ys)]))
        print(f"bnn_lenet exported artifact served {name} on all {len(xs)} test images: "
              f"accuracy {acc:.4f} (train.run's {KILL_STEPS} steps)  [{card}]", flush=True)
    return {"bnn_lenet_exported": launches}


# --- the digits MLPs: DoReFa's gradient quantizer and the elastic scheme ---


def digits_splits():
    """The digits' shape on the card's machine, which has no sklearn: the
    port's seeded synthetic stand-in (64 features, 10 classes)."""
    from pytorch_quantize_impls_tpu_torch import data

    return data.synthetic_digits(flatten=True)


def digits_card_vs_cpu(card: str, cfg, train_set, label: str) -> None:
    """DIGITS_WARM steps on the card, then DIGITS_CHECKED_STEPS steps on the
    card and on the CPU, each from the card's state, under the gate of
    train_card_vs_cpu (bnn_lenet's per-tensor rule, float32; the hidden
    layers' biases feed a BatchNorm, so their gradients are rounding noise
    on both devices: ``noise_grads``). The warm steps
    move every BatchNorm bias off 0: one-bit weights times 2-bit codes put
    the BatchNorm inputs on a coarse grid, where a row often equals its
    batch mean, and with the bias at 0 the ReLU then reads the sign of a
    rounding residue."""
    from pytorch_quantize_impls_tpu_torch import data, train
    from pytorch_quantize_impls_tpu_torch.train import accuracy_sweep
    from pytorch_quantize_impls_tpu_torch.utils import build_model

    model = build_model(cfg, device=cuda())[0]
    cpu_model = copy.deepcopy(model).cpu()
    state, cpu_state = (train.QuantTrainState.create_for(m, lr=cfg.lr, seed=cfg.seed)
                        for m in (model, cpu_model))
    step_fn = train.make_train_step(
        elastic_weight=accuracy_sweep.elastic_weight(cfg, DIGITS_STEPS))
    batches = data.iterate_batches(train_set, cfg.batch_size, seed=cfg.seed)
    for _ in range(DIGITS_WARM):
        step_fn(state, next(batches))
    train_card_vs_cpu(card, state, cpu_state, step_fn, batches, label=label,
                      steps=DIGITS_CHECKED_STEPS, noise_grads=True)


def dorefa_gradient_card_vs_cpu(card: str, cfg) -> None:
    """dorefa_gradient's backward (6 bits) on the card and on the CPU on one
    shared draw u, at the MLP's input shapes (b = 64: 64, 512, 512
    features): bit for bit."""
    import torch

    from pytorch_quantize_impls_tpu_torch import ops

    g = torch.Generator().manual_seed(SEED + 19)
    for k in (64, 512, 512):
        x = torch.randn(cfg.batch_size, k, generator=g)
        u = torch.rand(x.shape, generator=g)
        gy = torch.randn(x.shape, generator=g) * 1e-3
        grads = []
        for dev in ("cpu", cuda()):
            xd = x.to(dev).detach().requires_grad_(True)
            ops.dorefa_grad_prim(xd, u.to(dev), cfg.g_bits).backward(gy.to(dev))
            grads.append(xd.grad.cpu())
        levels = len(torch.unique(grads[1]))
        print(f"dorefa_gradient G{cfg.g_bits} on a shared u at ({cfg.batch_size}, {k}): card "
              f"== CPU bit for bit {torch.equal(*grads)}, {levels} distinct values  [{card}]",
              flush=True)
        if not torch.equal(*grads):
            fail(f"dorefa_gradient at ({cfg.batch_size}, {k}): card and CPU differ")


def digits_run(card: str, cfg, splits, steps=None, seed=None, log: bool = True,
               fp32: bool = False, snapshot_at=None):
    """Train ``cfg``'s model (``fp32``: its twin) on the card for ``steps``
    steps (default DIGITS_STEPS; cosine over DIGITS_STEPS, the config's
    ramped elastic weight, the generator from ``seed``, default the
    config's): the clamp and finite statistics every DIGITS_WINDOW steps;
    with ``log`` the task loss (the loss less the weighted penalty) must
    fall, and ms per step by CUDA events and a profile are printed; with
    ``snapshot_at`` the state dict at that step is kept (``snapshot``).
    Returns (model, state, result dict)."""
    import torch

    from pytorch_quantize_impls_tpu_torch import data, nn as tnn, train
    from pytorch_quantize_impls_tpu_torch.train import accuracy_sweep
    from pytorch_quantize_impls_tpu_torch.utils import build_model

    label = cfg.config + (" twin" if fp32 else "")
    steps = DIGITS_STEPS if steps is None else steps
    model = build_model(cfg, fp32=fp32, device=cuda())[0]
    state = train.QuantTrainState.create_for(
        model, lr=train.cosine_decay_schedule(cfg.lr, DIGITS_STEPS),
        seed=cfg.seed if seed is None else seed)
    weight = accuracy_sweep.elastic_weight(cfg, DIGITS_STEPS)
    step_fn = train.make_train_step(elastic_weight=weight)
    batches = data.iterate_batches(splits[0], cfg.batch_size, seed=cfg.seed)
    task, out = [], {}
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(steps):
        if state.step == DIGITS_WINDOW:
            start.record()
        lam = float(weight(state.step)) if callable(weight) else float(weight)
        penalty = tnn.collect_elastic_losses(model).detach() if lam else 0.0
        _, m = step_fn(state, next(batches))
        task.append(m["loss"] - lam * penalty)
        if state.step == snapshot_at:
            out["snapshot"] = copy.deepcopy(model.state_dict())
        if state.step % DIGITS_WINDOW == 0:
            stats_ok = all(bool(torch.isfinite(b).all()) for b in model.buffers())
            if _clamped(state) > 1.0 or not stats_ok:
                fail(f"{label} step {state.step}: a kernel left [-1, 1] ({_clamped(state)}) or "
                     "a running statistic is not finite")
    end.record()
    torch.cuda.synchronize()
    if log:
        out["ms_per_step"] = start.elapsed_time(end) / (steps - DIGITS_WINDOW)
        loss = torch.stack([torch.as_tensor(t) for t in task]).cpu().numpy()
        first, last = float(loss[:DIGITS_WINDOW].mean()), float(loss[-DIGITS_WINDOW:].mean())
        out["penalty"] = float(tnn.collect_elastic_losses(model).detach())
        profiled = copy.deepcopy(state)
        out["profile"] = profile_line(lambda: step_fn(profiled, next(batches)), "step", 10)
        del profiled
        ramp = f", elastic weight ramped to {cfg.elastic_weight}" if callable(weight) else ""
        print(f"{label} trained {state.step} steps on the card (batch {cfg.batch_size}, cosine "
              f"from lr {cfg.lr}{ramp}): mean task loss of the first {DIGITS_WINDOW} steps "
              f"{first:.4f}, of the last "
              f"{last:.4f}; penalty at the end {out['penalty']:.6f}; every {DIGITS_WINDOW} steps "
              f"the kernels in [-1, 1] (max {_clamped(state)}) and the statistics finite; "
              f"{out['ms_per_step']:.3f} ms per step (CUDA events over "
              f"{steps - DIGITS_WINDOW} steps, the penalty read before each)  [{card}]",
              flush=True)
        print(f"{label} train step {out['profile']}  [{card}]", flush=True)
        if not last < 0.8 * first:
            fail(f"{label}: the task loss fell from {first:.4f} only to {last:.4f}")
    return model, state, out


def digits_codes(model, records, x):
    """Each layer's 2-bit input codes in the packed forward and in the
    fake-quant forward of the same images: {layer: share of codes that
    differ}. Each chain quantizes its own inputs; a code flips where the
    packed chain's float rounding moves an input across a level boundary."""
    import torch

    from pytorch_quantize_impls_tpu_torch import infer
    from pytorch_quantize_impls_tpu_torch.infer.packed import _quant_layers
    from pytorch_quantize_impls_tpu_torch.ops import dorefa_activation

    layers = dict(_quant_layers(model))
    seen = {}
    hooks = [m.register_forward_pre_hook(
        lambda mod, args, path=path: seen.setdefault(path, []).append(
            torch.round(dorefa_activation(args[0], mod.a_bits) * (2**mod.a_bits - 1))))
        for path, m in layers.items()]
    try:
        with torch.inference_mode():
            model(x)
            infer.packed_apply(model, records, x)
    finally:
        for h in hooks:
            h.remove()
    return {"/".join(path): float((fq != pk).double().mean()) for path, (fq, pk) in seen.items()}


def digits_layer_gaps(model, records, x) -> float:
    """The largest per-layer gap |packed - fake-quant| / (1 + |ref|), each
    layer's packed output against its fake-quant forward on the same input
    (the fake-quant chain's)."""
    import torch

    from pytorch_quantize_impls_tpu_torch import nn as tnn
    from pytorch_quantize_impls_tpu_torch.infer import packed as packed_mod

    paths = {id(m): path for path, m in packed_mod._quant_layers(model)}
    gap = 0.0

    def interceptor(m, xin, fake_quant_forward):
        nonlocal gap
        ref = fake_quant_forward(xin)
        got = packed_mod._dense_forward(records[paths[id(m)]], xin, m.bias)
        gap = max(gap, float(((got - ref).abs() / (1 + ref.abs())).max()))
        return ref

    with torch.inference_mode(), tnn.intercept_quant_layers(interceptor):
        model(x)
    return gap


def serve_digits_g6(card: str, model, test_set) -> dict:
    """The trained W1A2G6 MLP served packed through InferenceEngine:
    unprepared records (K6 three times per forward, E|W| in its scalar
    epilogue), then prepare() (K7 three times) and the prepared records (K3
    three times per forward, E|W| in its alpha vector); every batch
    replayed bit-equal; each layer within DIGITS_TOL (1 + |ref|) of its
    fake-quant forward on the same input; argmax against fake-quant on the
    whole test split at least DIGITS_ARGMAX_FLOOR, the codes that flip
    reported."""
    import torch

    from pytorch_quantize_impls_tpu_torch import infer
    from pytorch_quantize_impls_tpu_torch.kernels import int8_matmul as im
    from pytorch_quantize_impls_tpu_torch.kernels import packed_matmul as pm

    dev = cuda()
    model.eval()
    xs, ys = test_set
    inputs = [xs[i] for i in range(CLIENTS * REQUESTS_PER_CLIENT)]
    zero_launches()
    packed = infer.pack_model(model)
    alphas = {"/".join(p): r.alpha_host for p, r in packed.items()}
    engines = {}
    engines["unprepared"] = logged_engine_class()(
        lambda x: infer.packed_apply(model, packed, x), (64,), batch_sizes=BUCKETS, device=dev)
    answers = {"unprepared": run_engine(card, "digits_g6 unprepared", engines["unprepared"],
                                        inputs)}
    k6_unprepared = pm.dorefa_gemm.launches
    prepared = infer.prepare(packed)
    k7_prepare = pm.decode_dorefa_weights.launches
    engines["prepared"] = logged_engine_class()(
        lambda x: infer.packed_apply(model, prepared, x), (64,), batch_sizes=BUCKETS, device=dev)
    answers["prepared"] = run_engine(card, "digits_g6 prepared", engines["prepared"], inputs)
    launches = read_launches("digits_g6_trained", (pm.dorefa_gemm, pm.decode_dorefa_weights,
                                                   im.int8_gemm))
    forwards = {k: len(BUCKETS) + len(e.log) for k, e in engines.items()}
    want = {"dorefa_gemm": 3 * forwards["unprepared"], "decode_dorefa_weights": 3,
            "int8_gemm": 3 * forwards["prepared"]}
    got = {k: launches[k] for k in want}
    print(f"digits_g6 served: E|W| per layer {alphas}; launches {got}, expected {want} "
          f"({forwards['unprepared']} unprepared and {forwards['prepared']} prepared forwards, "
          f"the warmups included; K6 {k6_unprepared} before prepare(), K7 {k7_prepare} in it)  "
          f"[{card}]", flush=True)
    if got != want or k6_unprepared != want["dorefa_gemm"] or k7_prepare != 3:
        fail(f"digits_g6 served: launches {got}, expected {want}")
    for name, recs in (("unprepared", packed), ("prepared", prepared)):
        check_logged(f"digits_g6 {name}", engines[name].log, inputs, answers[name],
                     {"packed_apply": lambda x, r=recs: infer.packed_apply(model, r, x)})
    with torch.inference_mode():
        xt, yt = torch.from_numpy(xs).to(dev), torch.from_numpy(ys).to(dev)
        fq = model(xt)
        pk = {name: infer.packed_apply(model, recs, xt)
              for name, recs in (("unprepared", packed), ("prepared", prepared))}
    gaps = {name: digits_layer_gaps(model, recs, xt)
            for name, recs in (("unprepared", packed), ("prepared", prepared))}
    agree = {name: float((y.argmax(1) == fq.argmax(1)).double().mean()) for name, y in pk.items()}
    flips = digits_codes(model, packed, xt)
    acc = {"fake-quant": float((fq.argmax(1) == yt).double().mean()),
           **{name: float((y.argmax(1) == yt).double().mean()) for name, y in pk.items()}}
    print(f"digits_g6 packed vs fake-quant on {len(xs)} test images: per-layer max |gap| / "
          f"(1 + |ref|) {gaps} (gate {DIGITS_TOL}); end-to-end argmax agrees {agree} (gate "
          f"{DIGITS_ARGMAX_FLOOR}); share of 2-bit input codes that flip, by layer {flips}; "
          f"unprepared == prepared bit for bit "
          f"{bool(torch.equal(pk['unprepared'], pk['prepared']))}; test accuracy {acc}  [{card}]",
          flush=True)
    if max(gaps.values()) > DIGITS_TOL or min(agree.values()) < DIGITS_ARGMAX_FLOOR:
        fail(f"digits_g6 packed vs fake-quant: gaps {gaps}, argmax {agree}")
    return {"digits_g6_trained": launches}


def digits_path(card: str) -> dict:
    """The digits MLPs (after ``bnn_lenet adam8``): dorefa_digits_g6 (W1A2G6)
    and elastic_digits at their published widths (64-512-512-10, b = 64) on
    the synthetic digits stand-in. Card against CPU per step (the W1A2 MLP
    with G0, the elastic MLP under its ramp); dorefa_gradient on a shared u;
    DIGITS_STEPS steps each (task loss falls, clamp), the G6 run twice from
    one seed bit-equal and once from another seed different; elastic_digits
    hard-projected (every kernel entry +-its channel's alpha); the trained
    G6 model served packed (launches ``digits_g6_trained``: K6, K7, K3)."""
    import dataclasses

    import torch

    from pytorch_quantize_impls_tpu_torch.train import accuracy_sweep
    from pytorch_quantize_impls_tpu_torch.train.run import accuracy
    from pytorch_quantize_impls_tpu_torch.utils import SCHEME_CONFIGS, RunConfig

    dev = cuda()
    splits = digits_splits()
    g6 = RunConfig(**SCHEME_CONFIGS["dorefa_digits_g6"])
    elastic = RunConfig(**SCHEME_CONFIGS["elastic_digits"])
    zero_launches()
    digits_card_vs_cpu(card, dataclasses.replace(g6, g_bits=0), splits[0], "dorefa_digits W1A2G0")
    digits_card_vs_cpu(card, elastic, splits[0], "elastic_digits")
    dorefa_gradient_card_vs_cpu(card, g6)
    model, state, out = digits_run(card, g6, splits)
    again = digits_run(card, g6, splits, log=False)[0]
    other = digits_run(card, g6, splits, steps=DIGITS_OTHER_SEED_STEPS, seed=g6.seed + 1,
                       log=False)[0]
    first = digits_run(card, g6, splits, steps=DIGITS_OTHER_SEED_STEPS, log=False)[0]
    same = all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                 again.state_dict().values()))
    differ = not all(torch.equal(a, b) for a, b in zip(first.state_dict().values(),
                                                       other.state_dict().values()))
    print(f"dorefa_digits_g6: two runs from seed {g6.seed} bit-equal after {DIGITS_STEPS} steps "
          f"{same}; a run from generator seed {g6.seed + 1} differs from seed {g6.seed}'s after "
          f"{DIGITS_OTHER_SEED_STEPS} steps {differ}  [{card}]", flush=True)
    if not same or not differ:
        fail("dorefa_digits_g6: the gradient draws are not deterministic per (seed, step)")
    del again, other, first
    em, _, eout = digits_run(card, elastic, splits)
    acc_before = accuracy(em.eval(), splits[1], dev)
    projected = accuracy_sweep.project_elastic(em)
    kernels = [em.layer0.weight, em.layer1.weight, em.head.weight]
    on_grid = all(torch.equal(w.abs(), w.abs().amax(1, keepdim=True).expand_as(w))
                  for w in kernels)
    alpha = [float(w.detach().abs().amax(1).mean()) for w in kernels]
    acc_after = accuracy(em, splits[1], dev)
    print(f"elastic_digits hard-projected: {projected} kernels, every entry +-its channel's alpha "
          f"{on_grid} (mean alpha by layer {[round(a, 4) for a in alpha]}); test accuracy "
          f"{acc_before:.4f} before, {acc_after:.4f} after  [{card}]", flush=True)
    if projected != 3 or not on_grid:
        fail("elastic_digits: the projection left an entry off +-alpha")
    trained = read_launches("digits training", ())
    if any(trained.values()):
        fail(f"training launched a serving kernel: {trained}")
    return serve_digits_g6(card, model, splits[1])


# --- the XNOR digits convnets and bnn_lenet_as: trained, served, refused -------


def xd_card_vs_cpu(card: str, cfg, train_set, label: str, warm: int) -> dict:
    """``warm`` steps on the card, then XD_CHECKED_STEPS steps on the card
    and on the CPU, each from the card's state, under path 10's per-tensor
    gate in float32. Where float32 fails it (a sign or a max pool's tie at
    its boundary, summed in another order, sends a gradient elsewhere), the
    same warmed weights take XD_CHECKED_STEPS steps in float64 on both
    devices, gated, and the float32 shares stand as reported. Returns the
    verdicts by dtype."""
    import torch

    from pytorch_quantize_impls_tpu_torch import data, train
    from pytorch_quantize_impls_tpu_torch.utils import build_model

    model = build_model(cfg, device=cuda())[0]
    state = train.QuantTrainState.create_for(model, lr=cfg.lr, seed=cfg.seed)
    step_fn = train.make_train_step()
    batches = data.iterate_batches(train_set, cfg.batch_size, seed=cfg.seed)
    for _ in range(warm):
        step_fn(state, next(batches))
    warmed = copy.deepcopy(model.state_dict())
    cpu_state = train.QuantTrainState.create_for(copy.deepcopy(model).cpu(), lr=cfg.lr,
                                                 seed=cfg.seed)
    verdicts = {"float32": train_card_vs_cpu(card, state, cpu_state, step_fn, batches,
                                             label=f"{label} float32", steps=XD_CHECKED_STEPS,
                                             gate=False, noise_grads=True)}
    if not verdicts["float32"]:
        model64 = build_model(cfg, device=cuda())[0]
        model64.load_state_dict(warmed)
        model64.double()
        state64, cpu64 = (train.QuantTrainState.create_for(m, lr=cfg.lr, seed=cfg.seed)
                          for m in (model64, copy.deepcopy(model64).cpu()))
        verdicts["float64"] = train_card_vs_cpu(
            card, state64, cpu64, step_fn, _cast_batches(batches, np.float64),
            label=f"{label} float64", steps=XD_CHECKED_STEPS, noise_grads=True)
    print(f"{label} card vs CPU after {warm} warm steps: " + ", ".join(
        f"{k} {'passes' if v else 'fails (reported)'}" for k, v in verdicts.items())
        + f"  [{card}]", flush=True)
    del model, state, cpu_state
    torch.cuda.empty_cache()
    return verdicts


def shift_norm_card_vs_cpu(card: str) -> None:
    """nn.ShiftNormBatch at bn3's input shape of bnn_lenet width 128
    (XD_SNB_SHAPE), |gamma| in [0.2, 3] with a quarter negative: one
    train-mode forward and backward and one eval forward on the card and on
    the CPU. The outputs within TRAIN_TOL (1 + |ref|), the gradients of x,
    scale and bias under path 10's per-tensor gate, the running statistics
    within TRAIN_TOL relative, the AP2 scales of the eval forward bit-equal
    (each |log2| at least XD_AP2_MARGIN from a rounding point)."""
    import torch

    from pytorch_quantize_impls_tpu_torch import nn as tnn
    from pytorch_quantize_impls_tpu_torch.nn.binary import _ap2

    g = torch.Generator().manual_seed(SEED + 21)
    n, c = XD_SNB_SHAPE
    x = torch.randn(n, c, generator=g) * 3 + 1
    gy = torch.randn(n, c, generator=g)
    ref = tnn.ShiftNormBatch(c)
    with torch.no_grad():
        sign = torch.where(torch.rand(c, generator=g) < 0.25, -1.0, 1.0)
        ref.weight.copy_(sign * (0.2 + 2.8 * torch.rand(c, generator=g)))
        ref.bias.copy_(0.3 * torch.randn(c, generator=g))
    out = {}
    for dev in ("cpu", cuda()):
        m = copy.deepcopy(ref).to(dev).train()
        xd = x.to(dev, copy=True).requires_grad_(True)  # a leaf on either device
        y = m(xd)
        (y * gy.to(dev)).sum().backward()
        m.eval()
        with torch.no_grad():
            ye = m(x.to(dev))
            scale = m.weight * torch.rsqrt(m.running_var + m.epsilon)
        out[dev if dev == "cpu" else "card"] = {
            "train": y.detach().cpu(), "eval": ye.cpu(), "x": xd.grad.cpu(),
            "scale": m.weight.grad.cpu(), "bias": m.bias.grad.cpu(),
            "running_mean": m.running_mean.cpu(), "running_var": m.running_var.cpu(),
            "ap2": _ap2(scale).cpu(), "log2": scale.abs().log2().cpu()}
    a, b = out["card"], out["cpu"]
    fwd = max(float(((a[k] - b[k]).abs() / (1 + b[k].abs())).max()) for k in ("train", "eval"))
    grads = {k: _tensor_gate(_within(a[k], b[k], atol=GRAD_TOL * float(b[k].abs().max())))
             for k in ("x", "scale", "bias")}
    stats = max(float(((a[k] - b[k]).abs() / b[k].abs().clamp_min(1.0)).max())
                for k in ("running_mean", "running_var"))
    margin = float((b["log2"] - b["log2"].floor() - 0.5).abs().min())
    ap2_equal = torch.equal(a["ap2"], b["ap2"])
    print(f"ShiftNormBatch {tuple(x.shape)} card vs CPU: forwards (train, eval) within "
          f"{fwd:.3g} (1 + |ref|); gradients (share within {GRAD_TOL} max|g|) "
          + ", ".join(f"{k} {sh:.6f}" for k, (sh, _, _) in grads.items())
          + f"; running statistics within {stats:.3g} relative; eval AP2 scales bit-equal "
          f"{ap2_equal} (nearest |log2| to a rounding point {margin:.4f}; powers of two "
          f"{sorted(set(a['ap2'].abs().log2().int().tolist()))})  [{card}]", flush=True)
    if (fwd > TRAIN_TOL or stats > TRAIN_TOL or not all(ok for _, _, ok in grads.values())
            or (margin >= XD_AP2_MARGIN and not ap2_equal)):
        fail("ShiftNormBatch: card and CPU differ beyond tolerance")


def xd_train(card: str, name: str, splits) -> tuple:
    """``name``'s model (and for the XNOR pair its twin, Δacc reported)
    trained XD_STEPS steps on the card (digits_run: cosine, the clamp, the
    loss falls, ms per step, a profile), the state dict kept at
    XD_RERUN_STEPS; a second run from the same seed bit-equal there.
    Returns (model in eval mode, result dict)."""
    import torch

    from pytorch_quantize_impls_tpu_torch.train.run import accuracy
    from pytorch_quantize_impls_tpu_torch.utils import SCHEME_CONFIGS, RunConfig

    dev = cuda()
    cfg = RunConfig(**SCHEME_CONFIGS[name])
    model, _, out = digits_run(card, cfg, splits, steps=XD_STEPS, snapshot_at=XD_RERUN_STEPS)
    again = digits_run(card, cfg, splits, steps=XD_RERUN_STEPS, log=False)[0]
    differ = [k for k, v in out["snapshot"].items() if not again.state_dict()[k].equal(v)]
    print(f"{name}: a second run from seed {cfg.seed} bit-equal at step {XD_RERUN_STEPS} in "
          f"{len(out['snapshot']) - len(differ)} of {len(out['snapshot'])} tensors  [{card}]",
          flush=True)
    if differ:
        fail(f"{name}: a rerun from the same seed differs in {differ}")
    del again, out["snapshot"]
    out["accuracy"] = accuracy(model.eval(), splits[1], dev)
    if name != "bnn_lenet_as":
        twin, _, tout = digits_run(card, cfg, splits, steps=XD_STEPS, fp32=True)
        out["twin_accuracy"] = accuracy(twin.eval(), splits[1], dev)
        print(f"{name}: {XD_STEPS} steps each, twin {out['twin_accuracy']:.4f}, quantized "
              f"{out['accuracy']:.4f}, Δacc {out['accuracy'] - out['twin_accuracy']:+.4f} "
              f"(reported; the full budget runs through train.accuracy_sweep); twin "
              f"{tout['ms_per_step']:.3f} ms per step  [{card}]", flush=True)
        del twin
    torch.cuda.empty_cache()
    return model, out


def act_scales_moved(card: str, model) -> None:
    """Every act_scale of the trained bnn_lenet_as finite and moved from 1."""
    scales = {k: p.detach() for k, p in model.named_parameters() if k.endswith("act_scale")}
    print("bnn_lenet_as trained act_scale (min, mean, max): " + ", ".join(
        f"{k} ({float(g.min()):.4f}, {float(g.mean()):.4f}, {float(g.max()):.4f})"
        for k, g in scales.items()) + f"  [{card}]", flush=True)
    if sorted(scales) != ["conv2.act_scale", "fc1.act_scale", "head.act_scale"]:
        fail(f"bnn_lenet_as: act_scale on {sorted(scales)}")
    for k, g in scales.items():
        if not bool(g.isfinite().all()) or float((g - 1).abs().max()) == 0.0:
            fail(f"bnn_lenet_as: {k} is not finite or did not move from 1")


def serve_trained_xnor_digits(card: str, name: str, model, test_set) -> dict:
    """The trained XNOR digits model: pack_model -> save_packed ->
    load_packed -> InferenceEngine over the unprepared artifact, prepare(),
    InferenceEngine over the prepared one, from CLIENTS threads; every batch
    replayed bit-equal through packed_apply of both artifacts; packed
    against fake-quant by the JAX rule and both accuracies on the whole
    test split. Launches exact: xnor_digits' conv1 (real inputs) K2 once per
    unprepared forward and once in prepare(); xnor_digits_a1's conv1
    (binarized inputs) K5 once per forward, with the packed weight stage on
    the fused route and after K2 on the two-launch one, K2 once in
    prepare(), and conv1's im2col check (K5 three times, K2 once, K1 once)."""
    import torch

    from pytorch_quantize_impls_tpu_torch import infer
    from pytorch_quantize_impls_tpu_torch.kernels import int8_conv as ic
    from pytorch_quantize_impls_tpu_torch.kernels import xnor_gemm as bg
    from pytorch_quantize_impls_tpu_torch.kernels.conv import (PackedConv, conv_pads,
                                                                packed_conv_route)

    dev = cuda()
    a1 = name == "xnor_digits_a1"
    path_name = f"{name}_trained"
    xs, ys = test_set
    inputs = [xs[i] for i in range(CLIENTS * REQUESTS_PER_CLIENT)]
    Logged = logged_engine_class()
    engines, answers = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, f"{name}.npz")
        infer.save_packed(path, infer.pack_model(model))
        zero_launches()
        loaded = infer.load_packed(path, device=dev)
        recs = {"unprepared": loaded}
        before = bg.decode_binary_weights.launches
        recs["prepared"] = infer.prepare(loaded)
        k2_prepare = bg.decode_binary_weights.launches - before
        for kind in ("unprepared", "prepared"):
            engines[kind] = Logged(lambda x, r=recs[kind]: infer.packed_apply(model, r, x),
                                   XD_SHAPE, batch_sizes=BUCKETS, device=dev)
            answers[kind] = run_engine(card, f"{name} {kind}", engines[kind], inputs)
        check_route = None
        if a1:
            check_route = xnor_direct_vs_im2col(
                model, loaded, torch.from_numpy(xs[:XD_IM2COL_BATCH]).to(dev), name="conv1")
        required = (bg.decode_binary_weights, ic.int8_conv2d, bg.binary_gemm) if a1 else (
            bg.decode_binary_weights,)
        launches = read_launches(path_name, required)
    sizes = {kind: list(BUCKETS) + [xb.shape[0] for xb, _ in e.log]
             for kind, e in engines.items()}
    rec = loaded[("conv1", "conv")]
    kh, kw, cin, cout = rec.kernel_shape
    if a1:
        pc = PackedConv("xnor", rec.packed, (kh, kw), cin, cout, rec.alpha, 1, 1)
        pads = conv_pads("SAME", XD_SHAPE[:2], (kh, kw), (1, 1))
        routes = [packed_conv_route((b, *XD_SHAPE[:2], cin), pc, (1, 1), pads)
                  for bs in sizes.values() for b in bs]
        fused = routes.count("fused")
        want = {"int8_conv2d": len(routes) + 3,
                "int8_conv2d.packed": fused + 1 + (check_route == "fused"),
                "decode_binary_weights": len(routes) - fused + k2_prepare + 1
                + (check_route == "decode"),
                "binary_gemm": 1}
        how = (f"{len(routes)} forwards, {fused} on the fused route; K2 {k2_prepare} in "
               f"prepare(); the im2col check on the {check_route} route")
    else:
        want = {"decode_binary_weights": len(sizes["unprepared"]) + k2_prepare,
                "int8_conv2d": 0, "binary_gemm": 0}
        how = (f"{len(sizes['unprepared'])} unprepared and {len(sizes['prepared'])} prepared "
               f"forwards; K2 {k2_prepare} in prepare()")
    got = {k: launches[k] for k in want}
    print(f"{name} served: launches {got}, expected {want} ({how})  [{card}]", flush=True)
    if got != want or k2_prepare != 1:
        fail(f"{name} served: launches {got}, expected {want}")
    forwards = {f"packed_apply ({kind})": lambda x, r=r: infer.packed_apply(model, r, x)
                for kind, r in recs.items()}
    for kind in ("unprepared", "prepared"):
        check_logged(f"{name} {kind}", engines[kind].log, inputs, answers[kind], forwards)
    logits = {"fake-quant": _split_logits(model, xs, dev)}
    for kind, r in recs.items():
        logits[f"packed {kind}"] = _split_logits(
            lambda x, r=r: infer.packed_apply(model, r, x), xs, dev)
        logit_rule(card, f"{name} trained packed {kind} vs fake-quant", logits[f"packed {kind}"],
                   logits["fake-quant"])
    _accuracy_line(card, f"{name} trained", ys, logits)
    return {path_name: launches}


def serve_lenet_as(card: str, model, test_set) -> dict:
    """The trained bnn_lenet_as through InferenceEngine over its fake-quant
    forward (its packed paths refuse act_scale): no kernel launched, every
    batch replayed bit-equal through the model, every answer its batch's
    row; pack_model, the host export (on a CPU copy) and export_fused_lenet
    raise, naming act_scale."""
    import torch

    from pytorch_quantize_impls_tpu_torch import infer
    from pytorch_quantize_impls_tpu_torch.infer import host_export

    dev = cuda()
    model.eval()
    xs, _ = test_set
    inputs = [xs[i] for i in range(CLIENTS * REQUESTS_PER_CLIENT)]
    zero_launches()
    engine = logged_engine_class()(model, (28, 28, 1), batch_sizes=BUCKETS, device=dev)
    answers = run_engine(card, "bnn_lenet_as fake-quant", engine, inputs)
    launches = read_launches("bnn_lenet_as_served", ())
    if any(launches.values()):
        fail(f"bnn_lenet_as served as fake-quant launched a kernel: {launches}")
    check_logged("bnn_lenet_as fake-quant", engine.log, inputs, answers, {"the model": model})
    cpu_model = copy.deepcopy(model).cpu()
    refused = {}
    for what, fn in (("pack_model", lambda: infer.pack_model(model)),
                     ("host export", lambda: host_export.host_pack_model(cpu_model)),
                     ("export_fused_lenet", lambda: infer.export_fused_lenet(model)),
                     ("packed_apply", lambda: infer.packed_apply(
                         model, {}, torch.zeros(1, 28, 28, 1, device=dev)))):
        try:
            fn()
        except ValueError as e:
            refused[what] = "act_scale" in str(e)
        else:
            refused[what] = False
    print(f"bnn_lenet_as refused (ValueError naming act_scale): {refused}  [{card}]", flush=True)
    if not all(refused.values()):
        fail(f"bnn_lenet_as: a pack or export path did not refuse act_scale: {refused}")
    return {"bnn_lenet_as_served": launches}


def xnor_digits_path(card: str) -> dict:
    """The XNOR digits convnets and bnn_lenet_as (phase ``xnor digits +
    bnn_lenet_as``, after ``digits g6 + elastic train``) at their published
    widths, built through build_model on the card: xnor_digits (BWN, widths
    32, 64) and xnor_digits_a1 (full XNOR, 128, 128) on the synthetic digits
    as 8x8x1 images at b = 64, bnn_lenet_as (width 128) on the synthetic
    MNIST at b = 128. Card against CPU per step (xd_card_vs_cpu; LeNet after
    XD_LENET_WARM steps, so that every g has left 1); ShiftNormBatch card
    against CPU; XD_STEPS steps each, the XNOR pair's twins too (Δacc
    reported), reruns bit-equal at XD_RERUN_STEPS, no kernel launched by
    training; every trained act_scale finite and moved; the XNOR pair served
    packed (launches ``xnor_digits_trained``: K2; ``xnor_digits_a1_trained``:
    K5, K2, K1), bnn_lenet_as as fake-quant (``bnn_lenet_as_served``: none)
    and refused by every pack and export path."""
    from pytorch_quantize_impls_tpu_torch import data
    from pytorch_quantize_impls_tpu_torch.utils import SCHEME_CONFIGS, RunConfig

    digits = data.synthetic_digits()
    mnist = data.mnist()
    t = time.perf_counter()
    for name, splits, warm in (("xnor_digits", digits, DIGITS_WARM),
                               ("xnor_digits_a1", digits, DIGITS_WARM),
                               ("bnn_lenet_as", mnist, XD_LENET_WARM)):
        cfg = RunConfig(**SCHEME_CONFIGS[name])
        xd_card_vs_cpu(card, cfg, splits[0], name, warm)
    shift_norm_card_vs_cpu(card)
    print(f"xnor digits + bnn_lenet_as: card vs CPU {time.perf_counter() - t:.1f} s", flush=True)
    zero_launches()
    trained = {name: xd_train(card, name, splits)
               for name, splits in (("xnor_digits", digits), ("xnor_digits_a1", digits),
                                    ("bnn_lenet_as", mnist))}
    counts = read_launches("xnor digits + bnn_lenet_as training", ())
    if any(counts.values()):
        fail(f"training launched a serving kernel: {counts}")
    act_scales_moved(card, trained["bnn_lenet_as"][0])
    launches = {}
    for name in ("xnor_digits", "xnor_digits_a1"):
        launches.update(serve_trained_xnor_digits(card, name, trained[name][0], digits[1]))
    launches.update(serve_lenet_as(card, trained["bnn_lenet_as"][0], mnist[1]))
    return launches


# --- path 13: the compute dtype (bf16 compute, float32 masters) ---------------


def bf16_lenet():
    """(config, bnn_lenet at width 128 with dtype=torch.bfloat16 on the card,
    its weights drawn as build_model draws the config's)."""
    import torch

    from pytorch_quantize_impls_tpu_torch import models, nn as tnn
    from pytorch_quantize_impls_tpu_torch.utils import SCHEME_CONFIGS, RunConfig

    cfg = RunConfig(**SCHEME_CONFIGS["bnn_lenet"])
    model = models.BNNLeNet(width=cfg.width, dtype=torch.bfloat16)
    return cfg, tnn.init_like_flax(model, cfg.seed).to(cuda())


def masters_float32(label: str, model) -> None:
    import torch

    dtypes = {p.dtype for p in model.parameters()} | {b.dtype for b in model.buffers()}
    if dtypes != {torch.float32}:
        fail(f"{label}: master weights or statistics at {dtypes}, not float32")


def bf16_sums_probe(card: str) -> None:
    """How far cuDNN's bf16 conv and cuBLAS's bf16 GEMM of +-1 codes land
    from the exact integer sums rounded once to bf16, at bnn_lenet's conv2
    and fc1 and xnor_cifar's conv3 (reported: the port takes such sums in
    float32 and rounds them once, ``nn.base``)."""
    import torch
    import torch.nn.functional as F

    from pytorch_quantize_impls_tpu_torch.train.steps import fp32_cudnn

    dev = cuda()
    g = torch.Generator().manual_seed(SEED + 93)

    def codes(*shape):
        return torch.where(torch.rand(*shape, generator=g) < 0.5, 1.0, -1.0).to(dev)

    cases = {
        "bnn_lenet conv2": (codes(TRAIN_BATCH, WIDTH, 12, 12), codes(2 * WIDTH, WIDTH, 5, 5), 0),
        "xnor_cifar conv3": (codes(TRAIN_BATCH, 256, 16, 16), codes(256, 256, 3, 3), 1),
        "bnn_lenet fc1": (codes(TRAIN_BATCH, 32 * WIDTH), codes(8 * WIDTH, 32 * WIDTH), None),
    }
    out = []
    with torch.inference_mode(), fp32_cudnn():
        for name, (x, w, pad) in cases.items():
            if pad is None:
                exact = (x @ w.T).round()
                got = x.bfloat16() @ w.bfloat16().T
            else:
                exact = F.conv2d(x, w, padding=pad).round()
                got = F.conv2d(x.bfloat16(), w.bfloat16(), padding=pad)
            want = exact.bfloat16()
            off = int((got != want).sum())
            out.append(f"{name} {off} of {got.numel()} off (|sum| up to "
                       f"{int(exact.abs().max())})")
    print("bf16 products of +-1 codes against the exact sums rounded once to bf16: "
          + "; ".join(out) + f"  [{card}]", flush=True)


def bf16_lenet_train(card: str):
    """bnn_lenet bf16: card against CPU per step from one state, BF16_STEPS
    steps on the card (the clamp, the loss falls, ms per step, a profile),
    a rerun bit-equal at RERUN_STEPS, the masters float32, no serving kernel
    launched. Returns (model, example shape, test set)."""
    from pytorch_quantize_impls_tpu_torch import data, train

    cfg, model = bf16_lenet()
    cpu_model = copy.deepcopy(model).cpu()
    state = train.QuantTrainState.create_for(model, lr=cfg.lr, seed=cfg.seed)
    cpu_state = train.QuantTrainState.create_for(cpu_model, lr=cfg.lr, seed=cfg.seed)
    step_fn = train.make_train_step()
    train_set, test_set = data.mnist()
    batches = _batches(train_set, cfg.seed)
    zero_launches()
    train_card_vs_cpu(card, state, cpu_state, step_fn, batches, label="bnn_lenet bf16",
                      steps=TRAIN_CHECKED_STEPS, grad_tol=BF16_GRAD_TOL,
                      loss_rtol=BF16_LOSS_RTOL)
    del cpu_model, cpu_state
    snapshot = train_on_card(card, state, step_fn, batches, TRAIN_CHECKED_STEPS,
                             steps=BF16_STEPS, label="bnn_lenet bf16")
    trained = read_launches("bnn_lenet bf16 training", ())
    if any(trained.values()):
        fail(f"bf16 training launched a serving kernel: {trained}")
    masters_float32("bnn_lenet bf16", model)
    train_rerun(card, snapshot, make_model=lambda: bf16_lenet()[1], label="bnn_lenet bf16")
    return model, (28, 28, 1), test_set


def bf16_lenet_serve(card: str, model, example_shape, test_set) -> dict:
    """The trained bf16 LeNet packed: save_packed -> load_packed ->
    InferenceEngine(dtype=torch.bfloat16), unprepared and prepared, from
    CLIENTS threads; every batch equal to packed_apply on it, to the other
    artifact and to the bf16 fake-quant forward bit for bit; on BF16_EVAL
    test images packed equal to fake-quant. K1, K2, K3 and K5 launch
    exactly where drive_main_path counts them."""
    import torch

    from pytorch_quantize_impls_tpu_torch import infer

    dev = cuda()
    model.eval()
    xs, ys = test_set
    # images on the bf16 grid, so each logged bf16 batch row is its request's image
    inputs = [torch.from_numpy(xs[i]).bfloat16().float().numpy()
              for i in range(CLIENTS * REQUESTS_PER_CLIENT)]
    loaded, answers, logs, launches = drive_main_path(
        card, model, example_shape, inputs, label="bnn_lenet_bf16", dtype=torch.bfloat16)
    check_main_path(model, loaded, inputs, answers, logs)
    prepared = infer.prepare(loaded)
    with torch.inference_mode():
        xt = torch.from_numpy(xs[:BF16_EVAL]).to(dev, torch.bfloat16)
        fq, pk = model(xt), infer.packed_apply(model, prepared, xt)
    acc = float((pk.argmax(1).cpu() == torch.from_numpy(ys[:BF16_EVAL])).double().mean())
    print(f"bnn_lenet bf16 trained, {BF16_EVAL} test images: logits {pk.dtype}, packed "
          f"(prepared) bit-equal to fake-quant {bool(torch.equal(fq, pk))}, accuracy {acc:.4f}"
          f"  [{card}]", flush=True)
    if fq.dtype != torch.bfloat16 or not torch.equal(fq, pk):
        fail("bnn_lenet bf16: packed and fake-quant logits differ")
    if acc < TRAIN_MIN_ACC:
        fail(f"bnn_lenet bf16: test accuracy {acc:.4f} below {TRAIN_MIN_ACC}")
    return {"bnn_lenet_bf16": launches}


def bf16_resnet(card: str) -> dict:
    """The W4A4 ResNet-20 at width 64 with dtype=torch.bfloat16 (the
    resnet path's seeded, calibrated weights), packed at b=1 and b=256
    (unprepared; then prepare() and b=256 prepared) against its bf16
    fake-quant forward by the 5e-2 seam; float32 logits; K5 and K7 launches
    counted as the resnet path counts them."""
    import torch

    from pytorch_quantize_impls_tpu_torch import infer
    from pytorch_quantize_impls_tpu_torch.kernels import int8_conv as ic
    from pytorch_quantize_impls_tpu_torch.kernels import packed_matmul as pm
    from pytorch_quantize_impls_tpu_torch.models import DorefaResNet20
    from pytorch_quantize_impls_tpu_torch.utils import load_flax_variables

    dev = cuda()
    rng = np.random.default_rng(SEED + 94)
    calib = rng.normal(size=(RESNET_CALIB, *RESNET_SHAPE)).astype(np.float32)
    _, variables = calibrated_resnet(RESNET_WIDTH, rng, calib, dev)
    model = load_flax_variables(
        DorefaResNet20(w_bits=4, a_bits=4, width=RESNET_WIDTH, dtype=torch.bfloat16),
        variables, device=dev).eval()
    masters_float32("resnet bf16", model)
    xs = rng.normal(size=(RESNET_EVAL, *RESNET_SHAPE)).astype(np.float32)
    packed = infer.pack_model(model)
    zero_launches()
    with torch.inference_mode():
        y = infer.packed_apply(model, packed, torch.from_numpy(xs[:2]).to(dev))
    if y.dtype != torch.float32:
        fail(f"resnet bf16: packed logits at {y.dtype}, not float32 (the head's)")
    against_fake_quant(card, "resnet bf16 packed b=1", model,
                       lambda x: infer.packed_apply(model, packed, x),
                       xs[:BF16_RESNET_B1_ROWS], batch=1)
    against_fake_quant(card, f"resnet bf16 packed b={RESNET_BATCH}", model,
                       lambda x: infer.packed_apply(model, packed, x), xs)
    before = pm.decode_dorefa_weights.launches
    prepared = infer.prepare(packed)
    k7_prepare = pm.decode_dorefa_weights.launches - before
    against_fake_quant(card, f"resnet bf16 packed prepared b={RESNET_BATCH}", model,
                       lambda x: infer.packed_apply(model, prepared, x), xs)
    launches = read_launches("resnet_w4a4_bf16", (pm.decode_dorefa_weights, ic.int8_conv2d))
    decoded = launches["int8_conv2d"] - launches["int8_conv2d.packed"]
    print(f"resnet bf16 packed: {launches['int8_conv2d']} block conv calls, "
          f"{launches['int8_conv2d.packed']} fused, {decoded} as K7 + raw K5; K7 launches "
          f"{launches['decode_dorefa_weights']} = {decoded} + {k7_prepare} in prepare()",
          flush=True)
    if launches["decode_dorefa_weights"] != decoded + k7_prepare:
        fail(f"resnet bf16: K7 launched {launches['decode_dorefa_weights']} times, expected "
             f"{decoded + k7_prepare}")
    return {"resnet_w4a4_bf16": launches}


def projections_at(model, dtype):
    """A context in which every QuantDense of ``model`` computes at ``dtype``
    (None: at its input's), restored after."""
    import contextlib

    from pytorch_quantize_impls_tpu_torch.nn import QuantDense

    @contextlib.contextmanager
    def ctx():
        layers = [m for m in model.modules() if isinstance(m, QuantDense)]
        saved = [m.dtype for m in layers]
        for m in layers:
            m.dtype = dtype
        try:
            yield
        finally:
            for m, d in zip(layers, saved):
                m.dtype = d

    return ctx()


def bf16_lm(card: str) -> dict:
    """The serving LM's shape at W1A1 with dtype=torch.bfloat16 through
    DecodeEngine(packed=), unprepared (K1) and prepared (K2 in prepare(),
    K3), BF16_LM_REQUESTS requests each, the same tokens from both. Then the
    prepared records teacher-forced by the bf16 fake-quant decode model's
    greedy tokens, each packed call from a copy of its cache (lockstep):

    - per projection, inside the bf16 fake-quant forward, the packed layer
      on the same input: rounded to the fake-quant output's dtype, equal to
      it bit for bit where the layer has no bias (the exact integer sum
      rounded once); where it has one (the FFN), within 2^-6 (|s| + |b|)
      (the fake-quant layer rounds the sum, the bias and then their sum to
      bf16, the packed one rounds s + b once: four roundings, each at most
      2^-8 of an operand no larger than (1 + 2^-8)(|s| + |b|));
    - end to end, against the same model with every projection at its
      input's dtype: the function the JAX package's packed_apply computes,
      which returns each projection at its input's dtype (float32 after a
      LayerNorm), so the packed LM's residual stream is float32 after the
      first block. Argmax must agree on BF16_LM_ARGMAX_FLOOR of the (step,
      row) pairs; the agreement with the bf16 fake-quant model (a W1A1 LM
      this wide turns the stream's bf16 rounding into other codes) is
      reported."""
    import torch

    from pytorch_quantize_impls_tpu_torch import infer
    from pytorch_quantize_impls_tpu_torch.kernels import int8_matmul as im
    from pytorch_quantize_impls_tpu_torch.kernels import xnor_gemm as bg
    from pytorch_quantize_impls_tpu_torch.nn import intercept_quant_layers
    from pytorch_quantize_impls_tpu_torch.serve import DecodeEngine, decode_model

    dev = cuda()
    model = build_lm(LM_CFG, SEED + 95, dtype=torch.bfloat16)
    masters_float32("W1A1 LM bf16", model)
    packed = infer.pack_model(model)
    rng = np.random.default_rng(SEED + 96)
    prompts = [rng.integers(0, LM_CFG["vocab"], rng.integers(PROMPT_LENS[0], PROMPT_LENS[1] + 1))
               .astype(np.int32) for _ in range(BF16_LM_REQUESTS)]
    answers, launches, records = {}, {}, {}
    for name, required in (("unprepared", (bg.binary_gemm,)),
                           ("prepared", (bg.decode_binary_weights, im.int8_gemm))):
        zero_launches()
        recs = packed if name == "unprepared" else infer.prepare(packed)
        engine = DecodeEngine(model, packed=recs, n_slots=SLOTS, device=dev)
        t1 = time.perf_counter()
        try:
            answers[name] = serve(lambda i: engine.submit(prompts[i], max_new=MAX_NEW),
                                  len(prompts))
        finally:
            engine.shutdown()
        dt = time.perf_counter() - t1
        st = engine.stats
        print(f"decode engine[W1A1 bf16 packed {name}]: {st.requests} requests, {st.tokens} "
              f"tokens in {dt:.2f} s ({st.tokens / dt:.1f} tok/s), {st.steps} steps  [{card}]",
              flush=True)
        if st.requests != len(prompts) or st.tokens != MAX_NEW * len(prompts):
            fail(f"W1A1 bf16 engine[{name}] answered {st.requests} requests, {st.tokens} tokens")
        launches[f"lm_w1a1_bf16_{name}"] = read_launches(f"lm_w1a1_bf16_{name}", required)
        records[name] = recs
    if any(not np.array_equal(a, b) for a, b in zip(answers["unprepared"], answers["prepared"])):
        fail("the bf16 W1A1 LM's unprepared and prepared engines answered differently")

    recs = records["prepared"]
    md = decode_model(model)
    paths = {id(m): tuple(n.split(".")) for n, m in md.named_modules()}
    calls, off, worst = [0], [], [0.0]

    def per_gemm(m, x, fake_quant_forward):
        y = fake_quant_forward(x)
        got = infer.packed_apply(m, {("",): recs[paths[id(m)]]}, x).float()
        calls[0] += 1
        if m.bias is None:
            ok = torch.equal(got.to(y.dtype), y)
        else:
            b = m.bias.float()
            err = (got - y.float()).abs() / ((got - b).abs() + b.abs() + 1e-30)
            worst[0] = max(worst[0], float(err.max()))
            ok = bool((err <= 2.0 ** -6).all())
        if not ok:
            off.append(".".join(paths[id(m)]))
        return y

    b, steps = SLOTS, 32
    toks = torch.from_numpy(rng.integers(0, LM_CFG["vocab"], (b, 64)).astype(np.int32)).to(dev)
    agree = agree_bf16 = total = 0
    gap = 0.0
    cache, t = None, toks
    with torch.no_grad():
        for step in range(steps + 1):
            got, _ = infer.packed_apply(md, recs, t, None if cache is None else _clone_cache(cache))
            with projections_at(md, None):
                want, _ = md(t, None if cache is None else _clone_cache(cache))
            with intercept_quant_layers(per_gemm):
                ref, cache = md(t, cache)
            if {ref.dtype, got.dtype, want.dtype} != {torch.float32}:
                fail(f"W1A1 LM bf16: logits at {ref.dtype} / {got.dtype}, not float32")
            if step > 0:
                total += b
                agree += int((got[:, -1].argmax(-1) == want[:, -1].argmax(-1)).sum())
                agree_bf16 += int((got[:, -1].argmax(-1) == ref[:, -1].argmax(-1)).sum())
                gap = max(gap, float((got[:, -1] - want[:, -1]).abs().max()))
            t = ref[:, -1].argmax(-1).to(torch.int32)[:, None]
    print(f"W1A1 LM bf16 packed, teacher-forced by the bf16 fake-quant model: {calls[0]} "
          f"projection calls on its inputs, {len(off)} off (bias-free: bit-equal once rounded "
          f"to bf16; FFN: worst |diff| / (|s| + |b|) {worst[0]:.3g}, bound 2^-6); in lockstep "
          f"over {steps} steps x {b} rows, argmax agrees with the projections-at-input-dtype "
          f"model on {agree}/{total} ({100 * agree / total:.2f}%, floor "
          f"{100 * BF16_LM_ARGMAX_FLOOR:.0f}%, max |logit gap| {gap:.3g}), with the bf16 "
          f"fake-quant model on {agree_bf16}/{total} (reported)  [{card}]", flush=True)
    if off:
        fail(f"W1A1 LM bf16: packed projections differ from fake-quant in {sorted(set(off))}")
    if agree < BF16_LM_ARGMAX_FLOOR * total:
        fail(f"W1A1 LM bf16 teacher-forced: argmax agrees on only {agree} of {total}")
    return launches


def bf16_cifar_step(card: str) -> None:
    """xnor_cifar at its published widths with dtype=torch.bfloat16, b=128:
    BF16_CIFAR_STEPS steps on the synthetic CIFAR stand-in, ms per step by
    CUDA events over the timed ones and a profile (a reading); the loss
    finite and falling, the clamp, the masters float32."""
    import torch

    from pytorch_quantize_impls_tpu_torch import data, models, nn as tnn, train
    from pytorch_quantize_impls_tpu_torch.utils import SCHEME_CONFIGS, RunConfig

    cfg = RunConfig(**SCHEME_CONFIGS["xnor_cifar"])
    model = tnn.init_like_flax(models.XNORConvNet(dtype=torch.bfloat16), cfg.seed).to(cuda())
    state = train.QuantTrainState.create_for(model, lr=cfg.lr, seed=cfg.seed)
    step_fn = train.make_train_step()
    batches = data.iterate_batches(data.cifar10()[0], cfg.batch_size, seed=cfg.seed)
    warm, timed = BF16_CIFAR_STEPS
    losses = []
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for i in range(warm + timed):
        if i == warm:
            start.record()
        losses.append(step_fn(state, next(batches))[1]["loss"])
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / timed
    loss = torch.stack(losses).cpu().double().numpy()
    first, last = float(loss[:10].mean()), float(loss[-10:].mean())
    line = profile_line(lambda: step_fn(state, next(batches)), "step", 10)
    print(f"xnor_cifar bf16 train (batch {cfg.batch_size}): {ms:.3f} ms per step by CUDA events "
          f"over {timed} steps; mean loss of the first 10 steps {first:.4f}, of the last 10 "
          f"{last:.4f}; max |kernel| {_clamped(state)}; step {line}  [{card}]", flush=True)
    masters_float32("xnor_cifar bf16", model)
    if not (np.isfinite(loss).all() and last < first) or _clamped(state) > 1.0:
        fail(f"xnor_cifar bf16: the loss went {first:.4f} -> {last:.4f}, max |kernel| "
             f"{_clamped(state)}")


def bf16_path(card: str) -> dict:
    """Path 13: the compute dtype, bf16 compute with float32 masters, across
    the paths: bnn_lenet trained and served packed (K1, K2, K3, K5), the
    W4A4 ResNet-20 packed (K5, K7), the W1A1 LM decoded packed (K1, K2, K3),
    an xnor_cifar train step, and how the card's bf16 products of +-1 codes
    land."""
    bf16_sums_probe(card)
    model, example_shape, test_set = bf16_lenet_train(card)
    launches = bf16_lenet_serve(card, model, example_shape, test_set)
    del model
    launches.update(bf16_resnet(card))
    launches.update(bf16_lm(card))
    bf16_cifar_step(card)
    return launches


# --- path 14: the switch-routed MoE FFN in the LM, served and trained ---------


def _moe_layer_pair(scheme, kw, cf, params, where, shape=MOE_LAYER):
    """A QuantMoE of ``shape`` (d, E, d_ff, tokens) on ``where`` with
    ``params`` (numpy)."""
    import torch

    from pytorch_quantize_impls_tpu_torch.nn import QuantMoE

    d, e, f, _ = shape
    m = QuantMoE(d, e, f, scheme=scheme, capacity_factor=cf, device=where, **kw)
    with torch.no_grad():
        for k, v in params.items():
            getattr(m, k).copy_(torch.from_numpy(v))
    return m


def _moe_sums_magnitude(m, x, cf):
    """The magnitude of the layer's sums on ``x``: every term of both expert
    products taken as |term|, on the layer's routing."""
    import torch

    from pytorch_quantize_impls_tpu_torch.nn.moe import switch_route

    with torch.no_grad():
        r = switch_route(x, m.router, cf)
        wi, wo = m.quantized_kernels()
        return torch.einsum("tec,ecd->td", r.combine, torch.einsum(
            "tec,td->ecd", r.dispatch, x.abs()) @ wi.abs() @ wo.abs())


def moe_layer_card_vs_cpu(card: str) -> None:
    """nn.QuantMoE of every expert scheme from the same seeded weights and
    tokens (d 64, E 4, d_ff 128, 256 tokens) on the card and on the CPU, at
    capacity factors 2, 1 and 1e-9 (one slot per expert): the expert of
    every token and the keep mask equal; the output within MOE_TOL (1 + the
    magnitude of its sums, as the GEMM checks hold K8 to |x| @ |w|), the aux
    loss within MOE_TOL (1 + |ref|), the gradients of sum(out^2) + aux
    within GRAD_TOL of their tensor's max |g|; a dropped token's output 0;
    at most cap tokens kept per expert. A control: the card's layer at dtype
    bf16 (the same float32 routing) against the CPU's float32 at capacity
    factor 2 must fail the output gate for every scheme, or the gate could
    not tell bf16 from float32."""
    import torch

    from pytorch_quantize_impls_tpu_torch.nn.moe import switch_route

    dev = cuda()
    d, e, f, t = MOE_LAYER
    rng = np.random.default_rng(SEED + 140)
    x = rng.standard_normal((t, d), dtype=np.float32)
    worst = {"out": 0.0, "aux": 0.0, "grad": 0.0}
    kept, controls = {}, {}
    for scheme, kw in MOE_LAYER_SCHEMES.items():
        params = {"router": rng.standard_normal((d, e), dtype=np.float32) * np.float32(d ** -0.5),
                  "wi_kernel": rng.uniform(-1, 1, (e, d, f)).astype(np.float32),
                  "wo_kernel": rng.uniform(-1, 1, (e, f, d)).astype(np.float32)}
        for cf in MOE_LAYER_FACTORS:
            runs = []
            for where in (dev, "cpu"):
                m = _moe_layer_pair(scheme, kw, cf, params, where)
                xt = torch.from_numpy(x).to(where).requires_grad_(True)
                y = m(xt)
                ((y ** 2).sum() + m.penalty()).backward()
                with torch.no_grad():
                    r = switch_route(xt, m.router, cf)
                grads = [g.detach().cpu() for g in (xt.grad, m.router.grad, m.wi_kernel.grad,
                                                     m.wo_kernel.grad)]
                runs.append((y.detach().cpu(), m.penalty().item(), r.expert.cpu(), r.keep.cpu(),
                             r.cap, grads, _moe_sums_magnitude(m, xt.detach(), cf).cpu()))
            (y, aux, ex, keep, cap, g, mag), (yc, auxc, exc, keepc, _, gc, _) = runs
            label = f"MoE layer {scheme} at capacity factor {cf}"
            if not (torch.equal(ex, exc) and torch.equal(keep, keepc)):
                fail(f"{label}: the card routes or keeps other tokens than the CPU")
            worst["out"] = max(worst["out"], float(((y - yc).abs() / (1 + mag)).max()))
            worst["aux"] = max(worst["aux"], abs(aux - auxc) / (1 + abs(auxc)))
            for a, b in zip(g, gc):
                worst["grad"] = max(worst["grad"], float((a - b).abs().max() / b.abs().max()))
            if worst["out"] > MOE_TOL or worst["aux"] > MOE_TOL or worst["grad"] > GRAD_TOL:
                fail(f"{label}: card against CPU {worst}")
            if (y[~keep.any(-1)] != 0).any() or int(keep.sum(0).max()) > cap:
                fail(f"{label}: a dropped token gave a nonzero output, or an expert holds "
                     f"more than {cap} tokens")
            kept[(scheme, cf)] = (int(keep.sum()), cap)
        cpu = _moe_layer_pair(scheme, kw, 2.0, params, "cpu")
        bf16 = _moe_layer_pair(scheme, dict(kw, dtype=torch.bfloat16), 2.0, params, dev)
        xc = torch.from_numpy(x)
        with torch.no_grad():
            gap = (bf16(xc.to(dev)).float().cpu() - cpu(xc)).abs()
        controls[scheme] = float((gap / (1 + _moe_sums_magnitude(cpu, xc, 2.0))).max())
    print(f"MoE layer card vs CPU, {len(MOE_LAYER_SCHEMES)} schemes x capacity factors "
          f"{MOE_LAYER_FACTORS}: routing and keep masks equal; worst output gap "
          f"{worst['out']:.3g} of 1 + its sums' magnitude, aux {worst['aux']:.3g} (1 + |ref|), "
          f"gradients {worst['grad']:.3g} "
          f"of max |g|; tokens kept of {t} (cap per expert): "
          + ", ".join(f"{cf}: {kept[('binary', cf)][0]} ({kept[('binary', cf)][1]})"
                      for cf in MOE_LAYER_FACTORS) + f" (binary); control, the card's bf16 layer "
          f"against the CPU's float32 (output gate {MOE_TOL:g}): "
          + ", ".join(f"{k} {v:.3g}" for k, v in controls.items()) + f"  [{card}]", flush=True)
    if min(controls.values()) <= MOE_TOL:
        fail(f"MoE layer: the bf16 control passes the float32 output gate {controls}")


def moe_lm_lockstep(card: str, model, recs) -> None:
    """The prepared records against the fake-quant decode model, teacher-
    forced by its greedy tokens: a 64-token prefill of SLOTS rows, then 32
    steps, each packed call from a copy of the fake-quant cache. Argmax must
    agree on MOE_ARGMAX_FLOOR of the (step, row) pairs; the calls whose
    logits are bit-equal are counted (the ±1 projections' sums are exact
    integers on both, and the MoE is the same code)."""
    import torch

    from pytorch_quantize_impls_tpu_torch import infer
    from pytorch_quantize_impls_tpu_torch.serve import decode_model

    dev = cuda()
    md = decode_model(model)
    rng = np.random.default_rng(SEED + 144)
    b, steps = SLOTS, 32
    t = torch.from_numpy(rng.integers(0, MOE_LM_CFG["vocab"], (b, 64)).astype(np.int32)).to(dev)
    cache = None
    agree = total = equal = 0
    gap = 0.0
    with torch.no_grad():
        for step in range(steps + 1):
            got, _ = infer.packed_apply(md, recs, t, None if cache is None else _clone_cache(cache))
            ref, cache = md(t, cache)
            equal += int(torch.equal(got, ref))
            if step > 0:
                total += b
                agree += int((got[:, -1].argmax(-1) == ref[:, -1].argmax(-1)).sum())
                gap = max(gap, float((got[:, -1] - ref[:, -1]).abs().max()))
            t = ref[:, -1].argmax(-1).to(torch.int32)[:, None]
    print(f"MoE LM packed (prepared) against fake-quant, teacher-forced in lockstep: "
          f"{steps} steps x {b} rows, argmax agrees on {agree}/{total} "
          f"({100 * agree / total:.2f}%, floor {100 * MOE_ARGMAX_FLOOR:.0f}%), max |logit gap| "
          f"{gap:.3g}, {equal}/{steps + 1} calls bit-equal  [{card}]", flush=True)
    if agree < MOE_ARGMAX_FLOOR * total:
        fail(f"MoE LM teacher-forced: argmax agrees on only {agree} of {total}")


def moe_lm_serve(card: str, model) -> dict:
    """The full-width W1A1 MoE LM through DecodeEngine, fake-quant (no
    kernel), packed unprepared (K1 on every attention projection) and
    prepared (K2 once per record in prepare(), K3 on every projection): the
    experts stay fake-quant, as in the JAX package. MOE_REQUESTS requests of
    the decode phase's prompt lengths from CLIENTS threads per engine; the
    counts exact (4 records per layer, per forward); every batch of each
    engine replayed through the next backend (fake-quant -> unprepared ->
    prepared -> fake-quant) bit for bit: the ±1 projections' sums are exact
    integers on every route. Then lockstep against fake-quant and the decode
    speeds."""
    import torch

    from pytorch_quantize_impls_tpu_torch import infer
    from pytorch_quantize_impls_tpu_torch.kernels import int8_matmul as im
    from pytorch_quantize_impls_tpu_torch.kernels import xnor_gemm as bg
    from pytorch_quantize_impls_tpu_torch.serve import decode_model

    dev = cuda()
    per_forward = 4 * MOE_LM_CFG["n_layers"]  # q, k, v, out
    packed = infer.pack_model(model)
    if len(packed) != per_forward or any(p[-2] != "attn" for p in packed):
        fail(f"MoE LM: pack_model gave {sorted(packed)}, not the attention projections alone")
    md = decode_model(model)
    rng = np.random.default_rng(SEED + 141)
    lens = rng.integers(PROMPT_LENS[0], PROMPT_LENS[1] + 1, MOE_REQUESTS)
    prompts = [rng.integers(0, MOE_LM_CFG["vocab"], n).astype(np.int32) for n in lens]
    kernels = {"fake-quant": (), "unprepared": (bg.binary_gemm,),
               "prepared": (bg.decode_binary_weights, im.int8_gemm)}
    launches, runs = {}, {}
    for name, required in kernels.items():
        zero_launches()
        recs = {"fake-quant": None, "unprepared": packed}.get(name) if name != "prepared" \
            else infer.prepare(packed)
        engine = logged_engine(model, dev, packed=recs)
        t1 = time.perf_counter()
        try:
            answers = serve(lambda i: engine.submit(prompts[i], max_new=MAX_NEW), len(prompts))
        finally:
            engine.shutdown()
        dt = time.perf_counter() - t1
        st = engine.stats
        forwards = sum(1 for event in engine.log if event[0] == "batch")
        print(f"decode engine[MoE {name}]: {st.requests} requests, {st.tokens} tokens in "
              f"{dt:.2f} s ({st.tokens / dt:.1f} tok/s), {st.steps} steps, {forwards} forwards, "
              f"mean occupancy {st.mean_occupancy:.3f}  [{card}]", flush=True)
        if st.requests != len(prompts) or st.tokens != MAX_NEW * len(prompts):
            fail(f"MoE engine[{name}] answered {st.requests} requests, {st.tokens} tokens")
        path = f"moe_lm_{name.replace('-', '_')}"
        counts = read_launches(path, required)
        want = {"binary_gemm": per_forward * forwards * (name == "unprepared"),
                "decode_binary_weights": per_forward * (name == "prepared"),
                "int8_gemm": per_forward * forwards * (name == "prepared")}
        off = {k: n for k, n in counts.items() if n != want.get(k, 0)}
        if off:
            fail(f"MoE engine[{name}]: launches {off}, expected {want} and no other")
        launches[path] = counts
        runs[name] = (answers, engine.log, engine._cache, recs)
    names = list(runs)
    for i, name in enumerate(names):
        answers, log, final_cache, _ = runs[name]
        other = names[(i + 1) % len(names)]

        @torch.no_grad()
        def apply(c, t, recs=runs[other][3]):
            return md(t, c) if recs is None else infer.packed_apply(md, recs, t, c)

        n = replay(f"MoE {name}", apply, md.init_cache(SLOTS, device=dev), log, answers, prompts,
                   final_cache)
        print(f"replayed the MoE {name} engine's {n} batches through the {other} backend: same "
              f"logits, tokens and final cache, bit for bit", flush=True)
    # the slots share the experts' capacity, so an answer depends on which
    # requests the client threads' timing put beside it: reported, not held
    same = sum(np.array_equal(a, b) for a, b in zip(runs["fake-quant"][0], runs["prepared"][0]))
    print(f"MoE LM: {same}/{len(prompts)} answers of the prepared engine equal the fake-quant "
          f"engine's (the batches differ with the threads' timing)  [{card}]", flush=True)
    ready = runs["prepared"][3]
    del runs
    moe_lm_lockstep(card, model, ready)
    decode_speed(card, {
        "MoE fake-quant": lambda c, t: md(t, c),
        "MoE unprepared": lambda c, t: infer.packed_apply(md, packed, t, c),
        "MoE prepared": lambda c, t: infer.packed_apply(md, ready, t, c),
    })
    return launches


def moe_train_model(cfg: dict, seed: int):
    """The MoE LM to train, on the CPU: the quantized projections and the
    MoE's router and expert stacks drawn by init_like_flax from ``seed``,
    the embedding N(0, 1/d) and the positions N(0, 0.02^2) (flax's
    initializers) from a numpy generator of the same seed; then one entry of
    each router past the clamp's bound (1.5) and the first row of each
    wi_kernel at it (1.0), so that the clamp and its filter both act."""
    import torch

    from pytorch_quantize_impls_tpu_torch import nn as tnn
    from pytorch_quantize_impls_tpu_torch.models import QuantTransformerLM

    model = tnn.init_like_flax(QuantTransformerLM(**cfg), seed)
    rng = np.random.default_rng(seed)
    d = cfg["d_model"]
    with torch.no_grad():
        model.embed.weight.copy_(torch.from_numpy(
            rng.standard_normal((cfg["vocab"], d), dtype=np.float32) * np.float32(d ** -0.5)))
        model.pos_embed.copy_(torch.from_numpy(
            rng.standard_normal((cfg["max_len"], d), dtype=np.float32) * np.float32(0.02)))
        for blk in model.blocks():
            blk.moe.router[0, 0] = 1.5
            blk.moe.wi_kernel[:, 0] = 1.0
    return model


def moe_task(cfg: dict, seed: int):
    """Next-token batches made from ``seed``: token j + 1 is perm[token j]
    for a seeded permutation of the vocabulary, each row from a random start;
    ``(inputs, labels)`` of (MOE_TRAIN_BATCH, max_len) int32."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(cfg["vocab"]).astype(np.int32)
    while True:
        seq = np.empty((MOE_TRAIN_BATCH, cfg["max_len"] + 1), np.int32)
        seq[:, 0] = rng.integers(0, cfg["vocab"], MOE_TRAIN_BATCH)
        for j in range(cfg["max_len"]):
            seq[:, j + 1] = perm[seq[:, j]]
        yield seq[:, :-1], seq[:, 1:]


def moe_card_vs_cpu(card: str, step_fn) -> None:
    """The MoE LM's card-against-CPU step from one state and one batch, by
    path 10's gate (loss within 1e-5, each gradient within GRAD_TOL of its
    tensor's max |g|): the binary experts in float64, gated (the same
    function on both devices, as cifar_card_vs_cpu gates the CIFAR models),
    and in float32, reported; the float twin (scheme none) in float32,
    gated. The float32 binary step's own conditioning is read on the CPU:
    its gradients against the float64 step's."""
    import torch

    from pytorch_quantize_impls_tpu_torch import train

    dev = cuda()
    verdicts, cpu_grads = {}, {}
    for scheme, dtype, gate in (("binary", torch.float64, True), ("binary", torch.float32, False),
                                ("none", torch.float32, True)):
        model = moe_train_model(dict(MOE_TRAIN_CFG, scheme=scheme), SEED + 142).to(dtype)
        state = train.QuantTrainState.create_for(copy.deepcopy(model).to(dev))
        cpu_state = train.QuantTrainState.create_for(model)
        label = f"MoE LM ({'float twin' if scheme == 'none' else 'binary'} {str(dtype)[6:]})"
        verdicts[label] = train_card_vs_cpu(card, state, cpu_state, step_fn,
                                            moe_task(MOE_TRAIN_CFG, SEED + 143), steps=1,
                                            gate=gate, label=label)
        if scheme == "binary":
            cpu_grads[dtype] = {n: p.grad.detach().double() for n, p in model.named_parameters()}
        del state, cpu_state, model
    g32, g64 = cpu_grads[torch.float32], cpu_grads[torch.float64]
    rows = [((g32[n] - g64[n]).abs() / g64[n].abs().max()) for n in g64]
    share = min(float((r <= GRAD_TOL).double().mean()) for r in rows)
    gap = max(float(r.max()) for r in rows)
    print("MoE LM card vs CPU gates (binary float64 and the float twin enforced, binary float32 "
          "reported): " + ", ".join(f"{k} {'passes' if v else 'fails'}"
                                    for k, v in verdicts.items())
          + f"; the binary float32 CPU step against its float64 CPU step: least share of a "
          f"tensor's gradient entries within GRAD_TOL {share:.6f}, worst gap {gap:.3g} of "
          f"max |g|  [{card}]", flush=True)


def moe_lm_train(card: str) -> dict:
    """The MoE LM of MOE_TRAIN_CFG through train.make_train_step(
    elastic_weight=MOE_ELASTIC) with Adam and the clamp, on the next-token
    task: card against CPU for one step (moe_card_vs_cpu), then
    MOE_TRAIN_STEPS on the card: the loss falls, wi_kernel and wo_kernel
    stay in [-1, 1], every router keeps its entry past 1 (the default filter
    leaves it), the aux losses are each >= 1; ms per step by CUDA events, a
    profile, and no kernel of the port launched."""
    import torch

    from pytorch_quantize_impls_tpu_torch import train

    dev = cuda()
    step_fn = train.make_train_step(elastic_weight=MOE_ELASTIC)
    moe_card_vs_cpu(card, step_fn)
    batches = moe_task(MOE_TRAIN_CFG, SEED + 143)
    model = moe_train_model(MOE_TRAIN_CFG, SEED + 142).to(dev)
    state = train.QuantTrainState.create_for(model)
    clamped = {id(p) for p, _ in state.clamp.params}
    for blk in model.blocks():
        if id(blk.moe.router) in clamped or not {id(blk.moe.wi_kernel),
                                                 id(blk.moe.wo_kernel)} <= clamped:
            fail("MoE LM: the clamp's default filter does not take wi/wo_kernel and leave router")
    zero_launches()
    warm, timed = MOE_TRAIN_STEPS
    losses = []
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for i in range(warm + timed):
        if i == warm:
            start.record()
        losses.append(step_fn(state, next(batches))[1]["loss"])
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / timed
    line = profile_line(lambda: step_fn(state, next(batches)), "step", 5)
    counts = read_launches("moe_lm_train", ())
    loss = torch.stack(losses).cpu().double().numpy()
    first, last = float(loss[:5].mean()), float(loss[-5:].mean())
    routers = [blk.moe.router[0, 0].item() for blk in model.blocks()]
    aux = [blk.moe.penalty().item() for blk in model.blocks()]
    print(f"MoE LM train (d {MOE_TRAIN_CFG['d_model']}, E {MOE_TRAIN_CFG['n_experts']}, batch "
          f"{MOE_TRAIN_BATCH} x {MOE_TRAIN_CFG['max_len']}): {ms:.3f} ms per step by CUDA events "
          f"over {timed} steps; mean loss of the first 5 steps {first:.4f}, of the last 5 "
          f"{last:.4f}; max |kernel| {_clamped(state)}; the routers' entry past the bound "
          f"{routers}; aux losses {[round(a, 4) for a in aux]}; step {line}  [{card}]", flush=True)
    if not (np.isfinite(loss).all() and last < first):
        fail(f"MoE LM train: the loss went {first:.4f} -> {last:.4f}")
    if _clamped(state) > 1.0 or min(routers) <= 1.0 or min(aux) < 1.0 - 1e-3:
        fail(f"MoE LM train: max |kernel| {_clamped(state)}, routers {routers}, aux {aux}")
    if any(counts.values()):
        fail(f"MoE LM train launched a kernel of the port: {counts}")
    return {"moe_lm_train": counts}


def moe_lm_path(card: str) -> dict:
    """Path 14: the switch-routed MoE FFN (nn.QuantMoE): the layer card
    against CPU for every expert scheme; the serving LM's shape with 8
    binary experts per block (MOE_LM_CFG, ~2.1 GB of expert masters, built
    once) served fake-quant and packed (K1; K2, K3 on its attention
    projections); a 2-layer MoE LM trained (no kernel)."""
    import torch

    moe_layer_card_vs_cpu(card)
    t0 = time.perf_counter()
    model = build_lm(MOE_LM_CFG, SEED + 140)
    print(f"MoE LM built in {time.perf_counter() - t0:.1f} s: "
          f"{torch.cuda.memory_allocated() / 2**20:.0f} MiB allocated", flush=True)
    launches = moe_lm_serve(card, model)
    del model
    torch.cuda.empty_cache()
    launches.update(moe_lm_train(card))
    return launches


def ternary_lm_path(card: str):
    """Main path 10: the serving LM's shape with deterministic ternary
    weights (weights only), through DecodeEngine(packed=) unprepared and
    prepared: the same tokens for every request, no kernel launched (the
    JAX package decodes ternary words in plain code and runs a float dot),
    each projection within TERNARY_RTOL (|x| @ |w|) of its fake-quant GEMM,
    teacher-forced argmax against the fake-quant model."""
    import torch

    from pytorch_quantize_impls_tpu_torch import infer
    from pytorch_quantize_impls_tpu_torch.serve import DecodeEngine

    dev = cuda()
    t0 = time.perf_counter()
    model = build_lm(TERNARY_LM_CFG, SEED + 60)
    packed = infer.pack_model(model)
    metas = {(r.scheme, r.w_bits) for r in packed.values()}
    print(f"ternary LM built and packed in {time.perf_counter() - t0:.1f} s: {len(packed)} "
          f"records (scheme, w_bits) {sorted(metas)}, "
          f"{torch.cuda.memory_allocated() / 2**20:.0f} MiB allocated", flush=True)
    if metas != {("ternary", TERNARY_LM_CFG["w_bits"])}:
        fail(f"ternary LM records {metas}: expected the LM's w_bits, as the JAX package writes")
    rng = np.random.default_rng(SEED + 61)
    prompts = [rng.integers(0, LM_CFG["vocab"], rng.integers(PROMPT_LENS[0], PROMPT_LENS[1] + 1))
               .astype(np.int32) for _ in range(TERNARY_REQUESTS)]
    answers, launches, records = {}, {}, {}
    for name in ("unprepared", "prepared"):
        zero_launches()
        recs = packed if name == "unprepared" else infer.prepare(packed)
        engine = DecodeEngine(model, packed=recs, n_slots=SLOTS, device=dev)
        t1 = time.perf_counter()
        try:
            answers[name] = serve(lambda i: engine.submit(prompts[i], max_new=MAX_NEW),
                                  len(prompts))
        finally:
            engine.shutdown()
        dt = time.perf_counter() - t1
        st = engine.stats
        print(f"decode engine[ternary packed {name}]: {st.requests} requests, {st.tokens} tokens "
              f"in {dt:.2f} s ({st.tokens / dt:.1f} tok/s), {st.steps} steps, mean occupancy "
              f"{st.mean_occupancy:.3f}  [{card}]", flush=True)
        if st.requests != len(prompts) or st.tokens != MAX_NEW * len(prompts):
            fail(f"ternary LM engine[{name}] answered {st.requests} requests, {st.tokens} tokens")
        launches[f"lm_ternary_{name}"] = counts = read_launches(f"lm_ternary_{name}", ())
        if any(counts[k.__name__] for k in all_kernels()):
            fail(f"the ternary LM's {name} path launched a kernel: the ternary decode is plain")
        records[name] = recs
    if any(not np.array_equal(a, b) for a, b in zip(answers["unprepared"], answers["prepared"])):
        fail("the ternary LM's unprepared and prepared engines answered differently")
    print(f"ternary LM: unprepared and prepared engines gave the same {MAX_NEW} tokens for all "
          f"{len(prompts)} requests", flush=True)
    lm_teacher_forced_by_projection(
        card, "ternary LM", model, records,
        {"unprepared": TERNARY_RTOL, "prepared": TERNARY_RTOL},
        {"unprepared": TERNARY_ARGMAX_FLOOR, "prepared": TERNARY_ARGMAX_FLOOR}, SEED + 62)
    return launches


# --- path 15: serving over a (data, model) mesh -----------------------------


def mesh_group(card: str, workdir: str):
    """A world of one NCCL rank (``file://`` store, a timeout) and its (1, 1)
    mesh on the card; fails on any other backend."""
    import datetime

    import torch
    import torch.distributed as dist

    from pytorch_quantize_impls_tpu_torch import parallel

    parallel.initialize("file://" + os.path.join(workdir, "store"), world_size=1, rank=0,
                        device="cuda",
                        timeout=datetime.timedelta(seconds=MESH_GROUP_TIMEOUT_S))
    backend = dist.get_backend()
    nccl = torch.cuda.nccl.version()
    nccl = ".".join(map(str, nccl)) if isinstance(nccl, tuple) else str(nccl)
    print(f"mesh group: backend {backend}, NCCL {nccl}, world size {dist.get_world_size()}  "
          f"[{card}]", flush=True)
    if backend != "nccl":
        fail(f"the mesh group runs {backend}, not nccl, on a machine with a GPU")
    mesh = parallel.make_mesh((1, 1), device="cuda")
    if mesh.device_type != "cuda" or tuple(mesh.shape) != (1, 1):
        fail(f"make_mesh((1, 1)) gave a {mesh.device_type} mesh of shape {tuple(mesh.shape)}")
    # NCCL builds a communicator at a group's first collective: time those
    # here, apart from the engines' ticks
    t = torch.ones(4, device=cuda())
    firsts = {}
    for name, group in (("world", None), ("data", mesh.get_group("data")),
                        ("model", mesh.get_group("model"))):
        t0 = time.perf_counter()
        dist.all_reduce(t, group=group)
        torch.cuda.synchronize()
        firsts[name] = time.perf_counter() - t0
    if t.tolist() != [1.0] * 4:
        fail(f"an all_reduce over one rank changed its tensor: {t.tolist()}")
    print("mesh group: first collective (communicator set-up) per group, s: "
          + ", ".join(f"{k} {v:.3f}" for k, v in firsts.items()), flush=True)
    return mesh


def mesh_decode(card: str, model, mesh) -> dict:
    """The serving LM through DecodeEngine(packed=) without and with the
    mesh, unprepared and prepared, MESH_REQUESTS prompts each from CLIENTS
    threads: every request's tokens bit-equal, and on the mesh runs K1
    exactly 48 per forward unprepared (8 layers x 6 projections; forwards =
    prefills + steps), K2 48 in prepare() and K3 48 per forward prepared."""
    from pytorch_quantize_impls_tpu_torch import infer
    from pytorch_quantize_impls_tpu_torch.kernels import int8_matmul as im
    from pytorch_quantize_impls_tpu_torch.kernels import xnor_gemm as bg
    from pytorch_quantize_impls_tpu_torch.serve import DecodeEngine

    dev = cuda()
    rng = np.random.default_rng(SEED + 150)
    prompts = [rng.integers(0, LM_CFG["vocab"], rng.integers(PROMPT_LENS[0], PROMPT_LENS[1] + 1))
               .astype(np.int32) for _ in range(MESH_REQUESTS)]
    per_forward = 6 * LM_CFG["n_layers"]
    packed = infer.pack_model(model)
    launches = {}
    for name in ("unprepared", "prepared"):
        answers = {}
        for where in ("alone", "mesh"):
            if where == "mesh":
                zero_launches()
            recs = packed if name == "unprepared" else infer.prepare(packed)
            engine = DecodeEngine(model, packed=recs, n_slots=SLOTS, device=dev,
                                  mesh=mesh if where == "mesh" else None)
            t0 = time.perf_counter()
            try:
                answers[where] = serve(
                    lambda i: engine.submit(prompts[i], max_new=MESH_MAX_NEW), len(prompts))
            finally:
                engine.shutdown()
            dt = time.perf_counter() - t0
            st = engine.stats
            print(f"decode engine[packed {name}, {where}]: {st.requests} requests, {st.tokens} "
                  f"tokens in {dt:.2f} s ({st.tokens / dt:.1f} tok/s), {st.steps} steps  [{card}]",
                  flush=True)
            if st.requests != len(prompts) or st.tokens != MESH_MAX_NEW * len(prompts):
                fail(f"mesh decode[{name}, {where}]: {st.requests} requests, {st.tokens} tokens")
        label = f"mesh_lm_{name}"
        launches[label] = counts = read_launches(
            label, (bg.binary_gemm,) if name == "unprepared" else (bg.decode_binary_weights,
                                                                   im.int8_gemm))
        forwards = st.requests + st.steps
        want = ({"binary_gemm": per_forward * forwards, "decode_binary_weights": 0, "int8_gemm": 0}
                if name == "unprepared" else
                {"binary_gemm": 0, "decode_binary_weights": per_forward,
                 "int8_gemm": per_forward * forwards})
        got = {k: counts[k] for k in want}
        if got != want:
            fail(f"mesh decode[{name}]: launches {got}, expected {want} ({forwards} forwards)")
        bad = [i for i, (a, b) in enumerate(zip(answers["alone"], answers["mesh"]))
               if not np.array_equal(a, b)]
        if bad:
            fail(f"mesh decode[{name}]: requests {bad[:8]} answered otherwise than without the "
                 "mesh")
        print(f"mesh decode[{name}]: all {len(prompts)} requests bit-equal to the engine without "
              f"the mesh; launches {got} over {forwards} forwards", flush=True)
    return launches


def mesh_tp_shards(card: str, model) -> None:
    """Every dense record of the serving LM cut by infer.shard_packed_columns
    for n in MESH_TP model ranks, every rank: K1 on the shard's words, and K2
    on them then K3 on the decoded shard, bit-equal to the matching columns
    of the unsharded K1, K2 and K3 calls at M = SLOTS rows; the prepared
    records' cut ``decoded`` equal to K2 of the shard. Then ms per call by
    CUDA events, unsharded and per shard, at the LM's three GEMM shapes."""
    import torch

    from pytorch_quantize_impls_tpu_torch import infer
    from pytorch_quantize_impls_tpu_torch.kernels import xnor_gemm as bg

    dev = cuda()
    packed = infer.pack_model(model)
    prepared = infer.prepare(packed)
    rng = np.random.default_rng(SEED + 151)
    checked, timed, full = 0, {}, {}
    for path, rec in packed.items():
        k = rec.kernel_shape[0]
        xi = torch.from_numpy(rng.choice(np.array([-1, 1], np.int8), (SLOTS, k))).to(dev)
        full[path] = (xi, bg.binary_gemm(xi, rec.packed, rec.alpha),
                      bg.binary_gemm_decoded(xi, prepared[path].decoded, rec.alpha))
        if not torch.equal(full[path][1], full[path][2]):
            fail(f"{'/'.join(path)}: K1 and K3 differ unsharded")
    for n in MESH_TP:
        for r in range(n):
            shards = infer.shard_packed_columns(packed, n, r)
            cut = infer.shard_packed_columns(prepared, n, r)
            for path, sh in shards.items():
                k, cols = sh.kernel_shape
                xi, full_k1, full_k3 = full[path]
                block = slice(r * cols, (r + 1) * cols)
                dec = bg.decode_binary_weights(sh.packed)[:k]
                ok = (torch.equal(bg.binary_gemm(xi, sh.packed, sh.alpha), full_k1[:, block])
                      and torch.equal(dec, prepared[path].decoded[:, block])
                      and torch.equal(dec, cut[path].decoded)
                      and torch.equal(bg.binary_gemm_decoded(xi, dec, sh.alpha),
                                      full_k3[:, block]))
                if not ok:
                    fail(f"{'/'.join(path)}: rank {r} of {n}: a shard's K1, K2 or K3 differs "
                         "from the unsharded columns")
                checked += 1
    for path, rec in packed.items():
        if rec.kernel_shape in timed:
            continue
        xi, dec = full[path][0], prepared[path].decoded
        row = {"K1": cuda_ms(lambda: bg.binary_gemm(xi, rec.packed, rec.alpha)),
               "K3": cuda_ms(lambda: bg.binary_gemm_decoded(xi, dec, rec.alpha))}
        for n in MESH_TP:
            sh = infer.shard_packed_columns({path: prepared[path]}, n, 0)[path]
            row[f"K1/{n}"] = cuda_ms(lambda: bg.binary_gemm(xi, sh.packed, sh.alpha))
            row[f"K3/{n}"] = cuda_ms(lambda: bg.binary_gemm_decoded(xi, sh.decoded, sh.alpha))
        timed[rec.kernel_shape] = row
    print(f"TP shards: {checked} (record, n, rank) shards of {len(packed)} dense records for n in "
          f"{MESH_TP}: K1, K2 and K3 bit-equal to the unsharded columns", flush=True)
    for (k, n_out), row in timed.items():
        print(f"TP shard ms per call at M={SLOTS}, K={k}, N={n_out} (CUDA events): "
              + ", ".join(f"{key} {v:.4f}" for key, v in row.items()) + f"  [{card}]", flush=True)


def mesh_tp_nccl(card: str, model, mesh) -> None:
    """The TP path on the (1, 1) NCCL mesh at full width: the serving LM's
    records cut by infer.shard_packed over "model" and run through
    packed_apply(tp_group=) on MESH_TP_TOKENS tokens, unprepared and
    prepared. Each of the 48 dense layers per forward all-gathers its
    columns over the model group (counted); the logits must be bit-equal to
    packed_apply on the whole records."""
    import torch

    from pytorch_quantize_impls_tpu_torch import infer
    from pytorch_quantize_impls_tpu_torch.infer import packed as ip

    dev = cuda()
    rng = np.random.default_rng(SEED + 153)
    toks = torch.from_numpy(rng.integers(0, LM_CFG["vocab"], MESH_TP_TOKENS)
                            .astype(np.int32)).to(dev)
    group = mesh.get_group("model")
    packed = infer.pack_model(model)
    real, gathers = ip._gather_columns, [0]

    def counted(y, tp_group):
        gathers[0] += 1
        return real(y, tp_group)

    for name, recs in (("unprepared", packed), ("prepared", infer.prepare(packed))):
        whole = infer.packed_apply(model, recs, toks)
        gathers[0] = 0
        ip._gather_columns = counted
        try:
            tp = infer.packed_apply(model, infer.shard_packed(recs, mesh, "model"), toks,
                                    tp_group=group)
        finally:
            ip._gather_columns = real
        want = 6 * LM_CFG["n_layers"]
        if gathers[0] != want:
            fail(f"TP over NCCL ({name}): {gathers[0]} column all-gathers, expected {want}")
        if not torch.equal(tp, whole):
            fail(f"TP over NCCL ({name}): packed_apply(tp_group=) on the shards differs from "
                 f"packed_apply on the whole records by {float((tp - whole).abs().max()):.3g}")
        print(f"TP over NCCL ({name}): the serving LM on {MESH_TP_TOKENS} tokens through "
              f"shard_packed and packed_apply(tp_group=), {gathers[0]} column all-gathers: "
              f"logits {tuple(tp.shape)} bit-equal to the whole records  [{card}]", flush=True)


def mesh_lenet(card: str, mesh) -> dict:
    """bnn_lenet (width 128, path 1's seeded weights) through
    InferenceEngine without and with the mesh, unprepared and prepared, in
    rounds of the largest bucket: every answer bit-equal; the mesh runs
    launch K5, K1, K2 and K3."""
    from pytorch_quantize_impls_tpu_torch import infer
    from pytorch_quantize_impls_tpu_torch.kernels import int8_conv as ic
    from pytorch_quantize_impls_tpu_torch.kernels import int8_matmul as im
    from pytorch_quantize_impls_tpu_torch.kernels import xnor_gemm as bg
    from pytorch_quantize_impls_tpu_torch.serve import InferenceEngine
    from pytorch_quantize_impls_tpu_torch.utils import (
        SCHEME_CONFIGS, RunConfig, build_model, load_flax_variables,
    )

    dev = cuda()
    rng = np.random.default_rng(SEED)
    cfg = RunConfig(**SCHEME_CONFIGS["bnn_lenet"])
    model, example_shape, _ = build_model(cfg, device=dev)
    load_flax_variables(model, seeded_variables(cfg.width, rng), device=dev)
    model.eval()
    inputs = [rng.normal(size=example_shape).astype(np.float32) for _ in range(MESH_LENET_INPUTS)]
    packed = infer.pack_model(model)
    answers = {}
    for where in ("alone", "mesh"):
        if where == "mesh":
            zero_launches()
        for name in ("unprepared", "prepared"):
            recs = packed if name == "unprepared" else infer.prepare(packed)
            engine = InferenceEngine(lambda x, recs=recs: infer.packed_apply(model, recs, x),
                                     example_shape, batch_sizes=BUCKETS, max_delay_ms=1000.0,
                                     device=dev, mesh=mesh if where == "mesh" else None)
            try:
                engine.warmup()
                answers[(name, where)] = serve_rounds(lambda i: engine.submit(inputs[i]),
                                                      len(inputs))
            finally:
                engine.shutdown()
            st = engine.stats
            print(f"bnn_lenet engine[{name}, {where}]: {st.requests} requests in {st.batches} "
                  f"batches, mean latency {st.mean_latency_ms:.3f} ms  [{card}]", flush=True)
    launches = read_launches("mesh_bnn_lenet", (ic.int8_conv2d, bg.binary_gemm,
                                                bg.decode_binary_weights, im.int8_gemm))
    for name in ("unprepared", "prepared"):
        a, b = answers[(name, "alone")], answers[(name, "mesh")]
        if any(not np.array_equal(x, y) for x, y in zip(a, b)):
            fail(f"bnn_lenet over the mesh ({name}) answered otherwise than without it")
    print(f"bnn_lenet over the mesh: all {len(inputs)} answers bit-equal to the engine without "
          "the mesh, unprepared and prepared", flush=True)
    return {"mesh_bnn_lenet": launches}


def _moe_label(scheme: str, kw: dict) -> str:
    return scheme + (f" w{kw['w_bits']}" if "w_bits" in kw else "")


def mesh_moe_ep(card: str, mesh) -> None:
    """Expert parallelism on the card at the MoE LM's layer (d 1024, E 8,
    d_ff 4096, 256 tokens), for every scheme of MESH_MOE_SCHEMES.

    On the (1, 1) NCCL mesh: the layer placed by parallel.shard_experts
    (routing over the data group, the stack's statistic reduced over the
    model group, xin all-reduced, hout all-gathered) must give the unsharded
    layer's output bit for bit, its expert and keep masks exactly and its
    aux loss within 1e-6 (1 + |ref|).

    Emulated rank by rank for n in MESH_TP model ranks: each rank quantizes
    its experts with the whole stack's statistic (nn.moe.stack_statistic
    over the model group, then ops.dorefa_weight(stat=)) and runs
    nn.moe.expert_ffn on its slots; its hout rows must be within MOE_TOL
    (1 + the magnitude of the sums) of the whole stack's rows. The dispatch
    einsum split over 2 and 4 emulated data ranks and summed must equal the
    whole one bit for bit (one token at most per expert slot)."""
    import torch

    from pytorch_quantize_impls_tpu_torch import parallel
    from pytorch_quantize_impls_tpu_torch.nn.base import _apply_quant
    from pytorch_quantize_impls_tpu_torch.nn.moe import expert_ffn, stack_statistic, switch_route
    from pytorch_quantize_impls_tpu_torch.ops import dorefa_weight

    dev = cuda()
    d, e, f, t = MESH_MOE_LAYER
    rng = np.random.default_rng(SEED + 152)
    x = torch.from_numpy(rng.standard_normal((t, d), dtype=np.float32)).to(dev)
    model_group = mesh.get_group("model")
    worst, worst_aux = 0.0, 0.0
    with torch.no_grad():
        for scheme, kw in MESH_MOE_SCHEMES:
            label = _moe_label(scheme, kw)
            params = {
                "router": rng.standard_normal((d, e), dtype=np.float32) * np.float32(d ** -0.5),
                "wi_kernel": rng.uniform(-1, 1, (e, d, f)).astype(np.float32),
                "wo_kernel": rng.uniform(-1, 1, (e, f, d)).astype(np.float32)}
            m = _moe_layer_pair(scheme, kw, 2.0, params, dev, shape=MESH_MOE_LAYER)
            ep = parallel.shard_experts(
                _moe_layer_pair(scheme, kw, 2.0, params, dev, shape=MESH_MOE_LAYER), mesh)
            y, y_ep = m(x), ep(x)
            r = switch_route(x, m.router, 2.0)
            r_ep = switch_route(x, ep.router, 2.0, ep.ep.data_group)
            aux, aux_ep = float(m.penalty()), float(ep.penalty())
            worst_aux = max(worst_aux, abs(aux_ep - aux) / (1 + abs(aux)))
            if not (torch.equal(y_ep, y) and torch.equal(r_ep.expert, r.expert)
                    and torch.equal(r_ep.keep, r.keep) and r_ep.cap == r.cap):
                fail(f"MoE EP {label} over NCCL: output, routing or capacity differs from the "
                     f"unsharded layer (output by {float((y_ep - y).abs().max()):.3g})")
            if abs(aux_ep - aux) > 1e-6 * (1 + abs(aux)):
                fail(f"MoE EP {label} over NCCL: aux {aux_ep!r} against {aux!r}")
            xin = torch.einsum("tec,td->ecd", r.dispatch, x)
            for n_data in (2, 4):
                rows = t // n_data
                parts = sum(torch.einsum("tec,td->ecd", r.dispatch[i * rows:(i + 1) * rows],
                                         x[i * rows:(i + 1) * rows]) for i in range(n_data))
                if not torch.equal(parts, xin):
                    fail(f"MoE EP {label}: the dispatch over {n_data} data ranks, summed, "
                         "differs from the whole")
            wi_q, wo_q = m.quantized_kernels()
            hout = expert_ffn(xin, wi_q, wo_q)
            mag = expert_ffn(xin.abs(), wi_q.abs(), wo_q.abs())
            stats = [stack_statistic(scheme, m.w_bits, w, model_group)
                     for w in (m.wi_kernel, m.wo_kernel)]
            for n in MESH_TP:
                per = e // n
                for rank in range(n):
                    lo = rank * per
                    shard = [_apply_quant(m.quantizer, w[lo:lo + per], m) if stat is None
                             else dorefa_weight(w[lo:lo + per], m.w_bits, stat=stat)
                             for w, stat in zip((m.wi_kernel, m.wo_kernel), stats)]
                    mine = expert_ffn(xin[lo:lo + per], *shard)
                    gap = float(((mine - hout[lo:lo + per]).abs()
                                 / (1 + mag[lo:lo + per])).max())
                    worst = max(worst, gap)
                    if gap > MOE_TOL:
                        fail(f"MoE EP {label}: rank {rank} of {n}: hout {gap:.3g} from the "
                             "whole stack's (1 + |sums|), over MOE_TOL")
    labels = ", ".join(_moe_label(sc, kw) for sc, kw in MESH_MOE_SCHEMES)
    print(f"MoE EP over NCCL, d {d}, E {e}, d_ff {f}, {t} tokens ({labels}): shard_experts on "
          f"the (1, 1) mesh bit-equal to the unsharded layer, routing equal, aux within "
          f"{worst_aux:.3g} (1 + |ref|)  [{card}]", flush=True)
    print(f"MoE EP emulated on the card, n in {MESH_TP}: every rank's hout rows within "
          f"{worst:.3g} (1 + |sums|) of the whole stack's (gate {MOE_TOL:g}); the dispatch split "
          f"over 2 and 4 data ranks sums to the whole bit for bit  [{card}]", flush=True)


def mesh_serving_path(card: str, model=None) -> dict:
    """Path 15: serving over a (data, model) mesh on torch.distributed, in a
    world of one NCCL rank (one card): the serving LM (path 2's seeded
    weights; built again when the phase runs alone) through
    DecodeEngine(packed=, mesh=) unprepared and prepared, bit-equal to the
    engine without the mesh (mesh_decode); every column shard of its dense
    records through K1, K2 and K3 for 2, 4 and 8 model ranks
    (mesh_tp_shards); the LM through shard_packed and packed_apply(tp_group=)
    over the NCCL model group, bit-equal to the whole records (mesh_tp_nccl);
    bnn_lenet through InferenceEngine(mesh=) (mesh_lenet); a QuantMoE placed
    by shard_experts on the NCCL mesh, bit-equal to the unsharded layer, and
    expert parallelism emulated rank by rank (mesh_moe_ep). Multi-rank NCCL
    runs need more than one card: the CPU tests run them over gloo."""
    import torch
    import torch.distributed as dist

    t0 = time.perf_counter()
    if model is None:
        model = build_lm(LM_CFG, SEED)
    parts = {"build": time.perf_counter() - t0}

    def part(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        parts[name] = time.perf_counter() - t
        return out

    with tempfile.TemporaryDirectory() as workdir:
        mesh = part("group", mesh_group, card, workdir)
        try:
            launches = part("decode", mesh_decode, card, model, mesh)
            part("tp shards", mesh_tp_shards, card, model)
            part("tp over nccl", mesh_tp_nccl, card, model, mesh)
            del model
            torch.cuda.empty_cache()
            launches.update(part("bnn_lenet", mesh_lenet, card, mesh))
            part("moe ep", mesh_moe_ep, card, mesh)
        finally:
            dist.destroy_process_group()
    dt = time.perf_counter() - t0
    print(f"mesh serving: {dt:.1f} s of its {MESH_PHASE_S} s budget; by part, s: "
          + ", ".join(f"{k} {v:.1f}" for k, v in parts.items()) + f"  [{card}]", flush=True)
    if dt - parts["build"] > MESH_PHASE_S:
        fail(f"mesh serving took {dt - parts['build']:.1f} s past the LM's build, over its "
             f"{MESH_PHASE_S} s")
    return launches


# --- paths 10-12: the GEMM measurements ------------------------------------


def headline_path(card: str) -> dict:
    """Path 7: the headline bench (bench.headline.run, bench.py's counterpart)
    at 4096^3, which runs K1, K10, K2 (its one-time decode), K3, K6 and K8.
    Its result must be finite and positive; its JSON line is printed. Then,
    outside the timed windows and after the launch count, every kernel row
    and the int8 yardstick is held against its plain version on the bench's
    own inputs (:func:`hold`): the exact rows bit for bit (binary decoded
    checks K2's decode through K3), log shift within SHIFT_RTOL of
    |bf16(x)| @ |w|. The float yardsticks are library calls, not checked."""
    from pytorch_quantize_impls_tpu_torch.bench import headline
    from pytorch_quantize_impls_tpu_torch.kernels import int8_matmul as im
    from pytorch_quantize_impls_tpu_torch.kernels import packed_matmul as pm
    from pytorch_quantize_impls_tpu_torch.kernels import shift_matmul as sm
    from pytorch_quantize_impls_tpu_torch.kernels import xnor_gemm as bg

    zero_launches()
    rows = headline.build_rows(HEADLINE_SHAPE, HEADLINE_SHAPE, HEADLINE_SHAPE, cuda())
    res = headline.run(cuda(), window_s=0.1, repeats=3, log=lambda s: print(s, flush=True),
                       rows=rows)
    launches = read_launches("headline", (
        bg.binary_gemm, bg.binary_gemm_ws, bg.decode_binary_weights, im.int8_gemm,
        pm.dorefa_gemm, sm.shift_gemm))
    numbers = [res["value"], res["vs_baseline"], res["pct_of_int8_peak"],
               *res["detail_tflops"].values()]
    if not all(np.isfinite(v) and v > 0 for v in numbers):
        fail(f"headline result has a non-finite or non-positive number: {res}")
    for r in rows:
        if r["exact"] or "abs_ref" in r:
            _, verdict = hold(r["name"], "headline", r["fn"], r["plain"], r.get("abs_ref"))
            print(f"check headline {HEADLINE_SHAPE}^3 {r['label']:38s} {verdict}", flush=True)
    print(json.dumps(res), flush=True)
    return launches


def kernel_bench_path(card: str) -> dict:
    """Path 8: the kernel bench (bench.kernel_bench.run) of binary_ws,
    dorefa_ws and shift_ws at 4096^3 over every m_tiles (K10, K11, K12)."""
    from pytorch_quantize_impls_tpu_torch.bench import kernel_bench
    from pytorch_quantize_impls_tpu_torch.kernels import packed_matmul as pm
    from pytorch_quantize_impls_tpu_torch.kernels import shift_matmul as sm
    from pytorch_quantize_impls_tpu_torch.kernels import xnor_gemm as bg

    zero_launches()
    for kernel in ("binary_ws", "dorefa_ws", "shift_ws"):
        kernel_bench.run(kernel, (HEADLINE_SHAPE,) * 3, 4, cuda(), window_s=0.1, repeats=3,
                         log=lambda s: print(s, flush=True))
    return read_launches("kernel_bench", (bg.binary_gemm_ws, pm.dorefa_gemm_ws, sm.shift_gemm_ws))


def probe_path(card: str) -> dict:
    """Path 9: the dtype probe (bench.mxu_probe.run) at 4096^3, every dtype
    over every tiling, beside torch.matmul bf16 and torch._int_mm (P1)."""
    from pytorch_quantize_impls_tpu_torch.bench import mxu_probe as mp

    zero_launches()
    res = mp.run(cuda(), window_s=0.1, repeats=3, log=lambda s: print(s, flush=True))
    print(json.dumps({"probe": res, "device": card}), flush=True)
    print("probe launches by dtype: " + json.dumps({dt: r["launches"] for dt, r in res.items()}),
          flush=True)
    return read_launches("probe", (mp.tiled_mm,))


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA GPU")
    card = card_line()
    print(card, flush=True)
    if torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 matmul is on; the fake-quant forward must run in float32")

    from pytorch_quantize_impls_tpu_torch import infer
    from pytorch_quantize_impls_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    reports = _build.build()
    print(f"built {sorted(reports) or 'nothing (cached)'} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, report in reports.items():
        for line in report.splitlines():
            if "entry function" in line or "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}", flush=True)

    def phase(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        print(f"phase {name}: {time.perf_counter() - t:.1f} s", flush=True)
        return out

    summary = phase("kernel checks", check_kernels, card)
    model, prepared, example_shape, launches = phase("bnn_lenet", main_path, card)
    launches = {"bnn_lenet": launches}
    phase("bnn_lenet throughput", throughput, card, "bnn_lenet", {
        "packed prepared": lambda x: infer.packed_apply(model, prepared, x),
        "fake-quant": model,
    }, example_shape)
    launches.update(phase("bnn_lenet fused", lenet_fused_path, card, model, prepared,
                          example_shape))
    del model, prepared
    launches.update(phase("bnn_lenet train", lenet_train_path, card))
    launches.update(phase("cifar train", cifar_train_path, card))
    launches.update(phase("bnn_lenet adam8", adam8_path, card))
    launches.update(phase("digits g6 + elastic train", digits_path, card))
    launches.update(phase("xnor digits + bnn_lenet_as", xnor_digits_path, card))
    launches.update(phase("bf16 compute", bf16_path, card))
    launches.update(phase("moe LM", moe_lm_path, card))
    launches["decode_lm"], lm = phase("decode LM", decode_path, card)
    launches.update(phase("mesh serving", mesh_serving_path, card, lm))
    del lm
    launches.update(phase("resnet", resnet_path, card))
    launches.update(phase("W4A4 LM", w4a4_lm_path, card))
    launches.update(phase("vgg", vgg_path, card))
    launches.update(phase("log LM", log_lm_path, card))
    xnor_launches, ctx = phase("xnor_cifar packed", xnor_packed_path, card)
    launches.update(xnor_launches)
    launches.update(phase("xnor_cifar fused", xnor_fused_path, card, ctx))
    del ctx
    launches.update(phase("ternary LM", ternary_lm_path, card))
    launches["headline"] = phase("headline", headline_path, card)
    launches["kernel_bench"] = phase("kernel bench", kernel_bench_path, card)
    launches["probe"] = phase("probe", probe_path, card)

    src = f"{PORT}/csrc"
    tpu = "pytorch_quantize_impls_tpu"
    meta = {
        "binary_gemm": ("xnor_gemm.cu", f"{tpu}/kernels/xnor_gemm.py:132"),
        "decode_binary_weights": ("xnor_gemm.cu", f"{tpu}/kernels/xnor_gemm.py:308"),
        "int8_gemm": ("int8_matmul.cu", f"{tpu}/kernels/int8_matmul.py:99"),
        "decode_attention": ("decode_attention.cu", f"{tpu}/kernels/decode_attention.py:113"),
        # not a pallas_call: XLA's int8 conv_general_dilated
        "int8_conv2d": ("int8_conv.cu", f"{tpu}/kernels/conv.py:121"),
        "dorefa_gemm": ("dorefa_gemm.cu", f"{tpu}/kernels/packed_matmul.py:156"),
        "decode_dorefa_weights": ("dorefa_gemm.cu", f"{tpu}/kernels/packed_matmul.py:315"),
        "shift_gemm": ("shift_gemm.cu", f"{tpu}/kernels/shift_matmul.py:112"),
        "decode_log_weights": ("shift_gemm.cu", f"{tpu}/kernels/shift_matmul.py:260"),
        "binary_gemm_ws": ("xnor_gemm.cu", f"{tpu}/kernels/xnor_gemm.py:249"),
        "dorefa_gemm_ws": ("dorefa_gemm.cu", f"{tpu}/kernels/packed_matmul.py:257"),
        "shift_gemm_ws": ("shift_gemm.cu", f"{tpu}/kernels/shift_matmul.py:205"),
        "tiled_mm": ("mxu_probe.cu", "scripts/mxu_probe.py:47"),
    }
    # the decoders' work done inside K5's packed stage: binary words on the
    # bnn_lenet path, xnor words on xnor_cifar's, 4-bit DoReFa words on the
    # ResNet's
    fused_paths = {"decode_binary_weights": ("bnn_lenet", "xnor_cifar_packed",
                                             "bnn_lenet_trained", "xnor_cifar_trained",
                                             "bnn_lenet_exported", "xnor_digits_a1_trained",
                                             "bnn_lenet_bf16", "mesh_bnn_lenet"),
                   "decode_dorefa_weights": ("resnet_w4a4_packed", "resnet_w4a4_bf16")}
    rows = []
    for name, (cu, replaces) in meta.items():
        s = summary[name]
        by_path = {path: counts[name] for path, counts in launches.items()}
        if name in fused_paths:
            s = dict(s, fused_launches_by_path={
                path: launches[path]["int8_conv2d.packed"] for path in fused_paths[name]})
        if name == "int8_conv2d":
            s = dict(s, packed_launches_by_path={
                path: counts["int8_conv2d.packed"] for path, counts in launches.items()},
                threshold_launches_by_path={
                path: counts["int8_conv2d.threshold"] for path, counts in launches.items()})
        rows.append({
            "name": name, "route": "cuda", "source": f"{src}/{cu}", "replaces": replaces,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": s["max_abs_err"], "ms": s["ms"], "plain_ms": s["plain_ms"],
            "bound_ms": s["bound_ms"], "bound_by": s["bound_by"], "library_ms": s["library_ms"],
            **{k: v for k, v in s.items()
               if k in ("shape", "device_ms", "sdpa_dequantized_ms", "cublas_f32_ms",
                        "cublas_bf16_ms", "also", "fused_launches_by_path",
                        "packed_launches_by_path", "threshold_launches_by_path", "plan",
                        "tile", "host_us")},
        })
    print(f"whole run from the kernel builds on: {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
