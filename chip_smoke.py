#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU: PCM -> text serving
and training of the flagship Chorowski model and of the conv+BiLSTM
TIMIT model, and training of each with the other decoder (the flagship
with location-aware attention, the conv+BiLSTM model without it), and
the flagship's encoder by two more BiGRU paths (one GRU layer per
direction, and the direction-stacked scan), through their nineteen CUDA
kernels; then the trainer: the committed checkpoint's held-out beam PER,
an epoch loop with checkpoints and resume, and greedy decode; then the
reference recipe's regularisers: the committed AWN stage restarted from
the checkpoint, the monotonic penalty on each decoder, dropout and
weight noise; then the flagship's bf16 evaluation through the bf16
entries of K1, K2 and K4, and that of conv+BiLSTM, flagship_loc, VGG
and conv_bilstm_content through those of K7, K10, K12, K14 and K8, and
the bf16 training of the flagship and VGG through those of K6 and K5; then
the LibriSpeech recipes (the VGG model,
the character and word Chorowski recipes, the chunked out-of-core
epoch, the stacked front end) and K2 with a word vocabulary spread over
its cluster; then the convergence harness (tools/convergence_torch.py)
on the card against the CPU; then the bf16 entries of K16-K19, and the
mesh trainer of parallel/ in a world of one NCCL rank and of two gloo
ranks that share the card.

    python3 chip_smoke.py

Phases, each fatal when it fails:
  1. the card's name and power limit (nvidia-smi);
  2. build the nineteen kernels and the bf16 entries of K1, K2, K4-K8,
     K10, K12 and K14 from csrc/ (one nvcc per library, in parallel);
  3. hold each kernel to its plain PyTorch version through its public
     wrapper: K1-K3 at the flagship's serving shapes, batch 1 and 8 (max
     abs error 1e-4; K3 also twice, the two calls bitwise equal, one
     launch each); K4 (1e-4 abs) and K5, K6 (max|got - plain| <= 5e-4
     * max|plain| + 5e-5 for each output; K4 and K5 also twice, the two
     calls bitwise equal, one launch each) at the training shape, B = 16,
     L = 144, T = 56, encoder lengths ragged in 96-144 and label lengths
     in 20-56; K7 on the conv stack's output of the 3.5 s PCM (the
     conv+BiLSTM recipe's only BiLSTM layer, L' = 14) and K8 at K = 5 in
     its three instances: the recipe's decoder (LSTM, location-aware,
     filter 5), the flagship's widths with location-aware attention
     (GRU, filter 10, 16 feature maps, maxout readout) and the recipe's
     widths without the location term (LSTM), batch 1 and 8 (1e-4 abs);
     and K8's content-only GRU instance on K2's inputs; K2 and K8 (which
     run a batch row on a thread-block cluster, each block taking 1/C of
     the encoder positions) also at L < C, L not a multiple of C, a batch
     row with every position masked (alpha and c exactly 0), K = 1 and 8,
     B = 16 and K = 8 with L = 1500, each with two calls bitwise equal
     and one launch a call, K8 in its four instances under each cluster
     size the card holds (K8_EDGES); K9 and K11 (the
     backward tolerance; K10, K11, K14 and K15 also twice, the two calls
     bitwise equal, one launch each) and K10 (1e-4 abs) at the conv+BiLSTM recipe's
     training shape, B = 16, 144 frames (L' = 16), T = 56, on the conv
     stack's and the encoder's output of the same batch; K12 (1e-4 abs;
     also twice, bitwise equal) and K13 (the backward tolerance), the
     location-aware GRU decoder
     scan, at the flagship's training shape on the encoder output of the
     flagship with 16 feature maps of filter 10 (flagship_loc), and K14
     and K15, the content-only LSTM decoder scan, at the conv+BiLSTM
     recipe's training shape on the encoder output of that recipe without
     the location term (conv_bilstm_content); K16-K19, the one-direction
     GRU scan (K16, K17: direction 0) and the direction-stacked one (K18,
     K19), on the flagship encoder's first layer from nonzero initial
     states with a random cotangent, at the training batch (B = 16, L =
     144) and at B = 1, L = 132 (1e-4 abs forward, the backward tolerance
     on dxproj, dh0, dWzr and dWh); K1, K16 and K18 also twice, the two
     calls bitwise equal; the decoder forwards K10, K14, K12 and K4
     (which run on thread-block clusters of C blocks, R batch rows a
     cluster) at FWD_EDGES under every plan that fits the card (each C, R
     and W_cx layout): the conv+BiLSTM recipe's widths (K10, K14) and the
     flagship's (K12 with filter 10, K4) at B = 16 and 128, L < C with St
     and A not multiples of 4 and an even filter, L not a multiple of C at
     B not a multiple of R, each with a fully masked row (alpha and c
     exactly 0), two calls bitwise equal and one launch a call;
  4. serve 3.5 s of PCM with seeded random flagship weights: exact=False
     at batch 1 and 8 (kernels K1, K2, K3), exact=True at batch 1 (K1,
     K2), with the launch counts zeroed just before each request;
  5. the same requests on the CPU: tokens equal, scores within 5e-3, and
     one fused_attention_step launch per beam step the CPU run took; then
     two more requests at exact=False batch 8 with the readout's eos
     bias raised, so that hypotheses finish on eos and the beam stops
     early; then the same for the conv+BiLSTM recipe
     (timit_conv_bilstm, orthogonal init from the seed): exact=False at
     batch 1 and 8 (K3, K7, K8), exact=True at batch 1 (K7, K8) and one
     exact=False batch 8 request with the eos bias raised until a
     hypothesis finishes on eos, each with exactly one K7 launch and one
     K8 launch per beam step of the CPU run;
  6. train the recipe timit_chorowski_normnll_colnorm at full width
     (orthogonal init from seed 0, one seeded batch at the training
     shape): 3 steps on the card with the launch counts zeroed before
     each step and exactly 3 / 3 / 1 / 1 launches of K1 / K6 / K4 / K5
     (none of K2, K3) after it, the same 3 steps on the CPU (loss, nll,
     grad_norm and param_norm within rtol 1e-3), then 30 more card steps,
     the last with a lower loss than the first; then the same for the
     recipe timit_conv_bilstm (orthogonal init from seed 0), with exactly
     one launch each of K7, K9, K10 and K11 per step and none of K1-K6,
     K8; then for flagship_loc (the first recipe with
     model_kwargs["feature_maps"] = 16), 3 / 3 / 1 / 1 launches of K1 /
     K6 / K12 / K13, and one flagship_loc step at B = 2, L = 2,048 frames
     (past the 1,018 that K13's one-block body took), on the card and on
     the CPU within rtol 1e-3; and for conv_bilstm_content (the second
     with model_kwargs["feature_maps"] = 0), one each of K7, K9, K14 and
     K15;
  7. the flagship encoder (three BiGRU layers, the recipe's weights) on
     the training batch, forward and the gradient of sum(out * cot) for
     every encoder weight and the input, by three paths: bigru_layer (K1,
     K6 3x each), one rnn.gru_layer per direction (K16, K17 6x each) and
     the stacked scan (K18, K19 3x each), with exact launch counts; each
     path's output equal to bigru_layer's at valid positions (1e-4 abs)
     and exactly 0 at masked ones, its gradients to bigru_layer's and
     each path to its own CPU run (backward tolerance);
  8. kernel (device), wrapper-call, plain-version and bound times per
     kernel; for K7 also cuDNN's bidirectional LSTM on the same input
     (library_ms: the device time of every op it starts; a yardstick the
     port never calls) and K7 with its two input projections; for K9
     cuDNN's bidirectional LSTM backward on the same shapes (the device
     time of every op that autograd.grad on its output starts); K2
     beside K8's instance on K2's inputs, and K2's plan (cluster size,
     waves) at b = 1 and 8 with its time on each cluster size that fits,
     and K8's at the conv+BiLSTM serving shape and the flagship_loc
     widths (its <LSTM, location> and <GRU, location> instances);
     for the cluster-walk backwards
     (K6, K9, K17, K19) the device time by stage (gate pre-pass, walk,
     reduction), the walk's time per step and the plan it ran (cluster
     size, rows per cluster, weights resident or streamed), and K6's walk
     at B = 16 and 128 under each row count the plan can take; for the
     forward GRU walk (K1, K16, K18) at B = 1, L = 132 and B = 16 and 128,
     L = 144 (seeded random inputs, H = 256) and the forward LSTM walk
     (K7) at B = 1 and 8, L' = 14 and B = 16 and 128, L' = 16 (seeded
     random inputs, nonzero initial states, H = 128) the parity, the
     device time, the walk's time per step and the plan it ran (cluster
     size, rows per cluster, resident or streamed, clusters and waves),
     and K1 at B = 16 and 128 and K7 at each of its shapes under each row
     count the plan can take (the sweeps that walk.STEP_COST is read
     from); for K5 at the flagship's training shape, K13 at
     flagship_loc's and K11 and K15 at the conv+BiLSTM
     recipe's, at B = 16 and 128 (parity, a second call bitwise equal
     and one launch a call at B = 128 too) the device time by stage (the
     recompute pre-pass, the walk on thread-block clusters, the reduction
     over the steps, the one over the walk's partials), the walk's time a
     step, the plan it ran (C blocks and R rows a cluster, clusters and
     waves) and the scratch bytes, and the walk under each (C, R) that
     fits, each held to the plain version and run twice (the sweeps that
     attention_scan.STEP_COST is read from); for K10 and K14 at the
     conv+BiLSTM recipe's training shape at B = 16 and 128 the device time
     by stage (the pre-pass, the walk), the walk's time a step, its plan
     (C, R, W_cx resident or streamed, clusters and waves) and the scratch
     bytes, and the walk under each plan that fits, each held to the plain
     version and run twice (the sweeps that attention_scan.FWD_STEP_COST's
     LSTM table is read from); the same for K12 at flagship_loc's and K4 at
     the flagship's training shape (its GRU table); K3's device time at
     b = 8 beside b = 1 with its block size, and the device time of a
     served exact=False b = 1 request's front end by device op (K3, the
     reflect pad, the PyTorch ops of features.assemble);
  9. the p50 request latency over 10 requests of each model, and the
     device idle share: 1 - (device time of one request) / p50; the p50
     train step of each recipe over 10
     steps after 3 warm-up steps at B = 16 and 128, audio seconds per
     second, the device time of one step by kernel, each weight-gradient
     reduction's, and its idle share, for each of the four trained
     configurations; the encoder's forward and backward by each path of
     phase 7 at B = 16 and 128, its device time, time per call and device
     time by kernel;
 10. the trainer (Trainer, the port's training entry point): (i) the
     committed flagship-shape checkpoint (runs/timit_shape_ckpt/full/
     params.npz) scored by Trainer.evaluate on the held-out split of
     timit_shaped(4000, 192) built on the host and staged on the card as
     the trainer stages it (batch 32, the train split's 3 length buckets,
     beam K=5, the 61->39 fold), TF32 off: its beam PER within 0.002 of
     the port's CPU value (HELD_OUT_PER_CPU), launches of K1, K2 and K4
     only, the evaluation's wall time and (a second, profiled run, the
     same PER) its device time; (ii) Trainer.fit of the flagship recipe at
     full width, 2 epochs of timit_shaped(64, 16) at batch 16 into a
     scratch save_dir: the loss finite and falling, valid_per logged,
     ckpt_latest, the best-metric checkpoints and log.jsonl written, K1,
     K2 and K4-K6 launched and no other kernel, then a second Trainer
     that resumes the first's state bit for bit and runs epoch 3 only;
     (iii) greedy decode (K=1) against its plain version (the same call
     on the CPU): the flagship decoder (K2) on the checkpoint's encoding
     of the first held-out batch and the conv+BiLSTM decoder (K8) on its
     recipe's encoding of the serving PCM, with the seeded weights and
     with the eos bias raised; equal tokens and lengths, one launch a
     step; and the phase's wall seconds;
 11. the regularisers at full width: (a) params.npz in an AWN trainer
     (chorowski_dropout, sigma0 0.01, lambda 7.8125e-7, as
     tools/convergence.py:511-527 restarted it), its generator on the
     card, its lambda * KL within 1e-5 of the float64 value and 2e-5 of
     the JAX package's (both from the CPU, AWN_LAMBDA_KL_*); (b) one
     epoch of the timit_shaped(4000) train split at batch 32 over 3
     buckets with AWN and dropout into a scratch save_dir, K1, K2 and
     K4-K6 launched: not collapsed (train_nll < 0.5, awn_sigma_rms in
     [0.0099, 0.0101], param_norm within 5% of 81.96, mu's held-out PER
     < 0.2), a second Trainer resuming (mu, s), the optimizer state and
     the generator bit for bit, on the card, and a step of each giving
     the same loss; the AWN step's p50, device time and idle share
     beside the dropout-only step's; (c) one forward and backward at B =
     16 of each trained configuration with penalty_lambda 0.5: its
     launches, the penalty firing, every parameter's gradient within the
     backward tolerance of the CPU's and more than 1e-4 from the lambda
     = 0 gradient; (d) a chorowski_dropout step and a weight-noise step,
     each twice from one generator state: the same masks and noise and
     the same loss, the mask keeping 0.5 +- 0.01 of its values; and the
     phase's wall seconds;
 12. the bf16 operating point (compute_dtype="bfloat16") of the flagship's
     evaluation path, bf16 products outside the kernels summing in
     float32 under PyTorch's default flags: (a) the bf16 entries of K1
     and K4 at B = 16, L = 144, T = 56 and of K2 at B = 16, K = 5 and b
     = 1, L = 132, each also at B = 1, L = 131 and on the held-out
     split's longest evaluation batch (B = 32), on the committed
     checkpoint's weights in bf16, against their exact plain twins
     element by element (BF16_ULPS) and by the ground-truth rule against
     the plain bf16 versions at the JAX kernels' rounding points (each
     output's relative L2 distance from the float32 plain version's on
     the upcast inputs at most 2 x the plain bf16 version's + 0.02),
     with the max abs error; (b) params.npz as a bf16 model through
     Trainer.evaluate on the held-out split, launching the three bf16
     entries and no other kernel: its beam PER within 0.005 of the
     port's CPU bf16 value (HELD_OUT_PER_CPU_BF16) and within 0.01 of
     the float32 one; (c) each bf16 entry's device time beside its
     float32 kernel's on the upcast inputs, its plain twin's time and
     bound (bf16 bytes, operations at the bf16 tensor-core peak), and
     one B = 32 evaluation batch (the eval step and the beam) in bf16
     beside float32, wall and device time; and the phase's wall seconds;
     then
     (12 b) conv+BiLSTM, flagship_loc, VGG and conv_bilstm_content as
     bf16 models (bf16_models_phase), from each recipe's seeded init: the
     bf16 entries of K7, K10, K12, K14 and K8 (its <LSTM, location>, <GRU,
     location>, <GRU, content> and <LSTM, content> instances) held as
     above at a B = 16 batch's shapes and at each evaluation batch's, each
     also twice with the same bits, with their times beside the float32
     kernels' and cuDNN's bf16 LSTM beside K7; each configuration's
     Trainer.evaluate on one evaluation batch (the held-out split's first
     32, or 16 for flagship_loc; LS_VALID's 8 for VGG) on the card under PyTorch's default flags, unchanged after,
     launching its bf16 entries only (K8 once a beam step), against the
     same evaluation on the CPU (PER within 0.02, NLL within 1e-3
     relative); and the bf16 train step of conv_bilstm, flagship_loc and
     conv_bilstm_content raising NotImplementedError that names item
     5c's training part; then (12 c) bf16 training (bf16_train_phase):
     the bf16 entries of K6 and K5 at B = 16 and 128, L = 144, T = 56 on
     the recipe's weights in bf16, against their exact twins
     (BF16_ULPS), the plain bf16 versions by the ground-truth rule and
     twice with the same bits, with their device times beside the
     float32 kernels' and their bounds; the flagship's bf16 train step
     at B = 16 and 128 launching only the bf16 entries of K1, K6, K4 and
     K5, its loss within 1e-3 of the CPU's bf16 step on the same batch,
     each gradient leaf by the ground-truth rule against the card's
     float32 step (the CPU's bf16 gradient the reference), the same bits
     under either value of allow_bf16_reduced_precision_reduction, the
     loss falling over 10 steps, and its p50, audio s/s and idle share;
     one Trainer.fit epoch of chorowski_dropout in bf16 and one in
     float32, each from params.npz on the host-built split with the same
     batches and masks, the bf16 held-out beam PER within 0.01 of the
     float32 one's; VGG's bf16 step at B = 16 (phase 13's lengths)
     against its float32 step by the ground-truth rule (the CPU's bf16
     step the reference), loss within 1e-3 of the CPU's;
 13. the LibriSpeech recipes at full width, TF32 off: (a) K2 with the
     vocabulary spread over its cluster at V = 34,000 (the word recipe's
     train-clean-100 vocabulary), K = 5 and 8, B = 16, L = 1,094 (35 s)
     with a fully masked row, against its plain version (1e-4 abs), two
     calls bitwise equal, one launch a call, its plan and device time; at
     b = 1 at its cap on clusters of 16 for K = 5 and 8
     (attention_step.step_vocab_cap of the card's shared memory) and the
     refusal one above it; the bf16 entry at V = 34,000 against its
     exact twin (BF16_ULPS) and by the ground-truth rule; (b) K8's <GRU,
     content> instance with VGG's four-layer readout (maxout -> linear ->
     maxout -> linear, 30 characters) at b = 1 and 8 and B = 16, K = 5,
     L' = 543, against its plain version, twice, with its plan and its
     device time at B = 16; (c) librispeech_vgg and librispeech_chorowski
     and (e) librispeech_chorowski_words (V = 34,000), orthogonal init
     from the seed: 3 card steps on a B = 16 batch (lengths ragged in
     375-1,094 frames, labels in 180-512 characters or 32-96 words) with
     pinned launch counts (VGG: K4 and K5 once; the Chorowski recipes:
     K1 and K6 3x, K4 and K5 once) and the loss falling, one step of a
     B = 2, L = 400, T = 64 batch on the card and on the CPU within 1e-3,
     and the p50 of 10 steps with its device time and idle share; (d)
     Trainer.fit(chunked=...) of librispeech_vgg, one epoch over two
     in-memory chunks of 16 such utterances loaded one at a time in the
     epoch seed's order, then the beam CER on 8 short utterances (80-200
     frames, so that a batch's beam of up to 2 L steps stays short):
     only K4, K5 and K8 launched; (e) the word recipe's beam on 4 short
     utterances (K = 5, V = 34,000): K1 3x, K2 once a step, nothing else;
     (f) the stacked front end (logmel_stacked, (B, 3, L, 40)) through K3
     against the CPU's plain version, one K3 launch; and the phase's wall
     seconds;
 14. the convergence harness (tools/convergence_torch.py, main()): two
     epochs of the conv+BiLSTM recipe at full width on 64 synthetic
     utterances (16 held out) at batch 32, beam K=5 every epoch, on the
     card with the launch counts zeroed just before and read just after
     (K7, K9, K10, K11 and K8 launched, no other kernel), meta naming the
     card line, and on the CPU from the same CPU-drawn init over the same
     staged batches (--device-batches): train_loss, train_nll, grad_norm
     and valid_nll within 1e-3 relative, the accuracies and PERs within
     0.02; and the phase's wall seconds;
 15. (a) K8's <GRU, content> instance with VGG's readout over a word
     vocabulary, its last layer spread over the cluster: B = 16, L' =
     543, V = 34,000 at K = 5 and 8, against its plain version (1e-4
     abs), twice, one launch a call, its plan and device time beside its
     bound and the last layer's weight streamed once a row, its bf16
     entry against its exact twin (BF16_ULPS) and by the ground-truth
     rule; V = 3,125 at K = 5 (one past the old cap); at b = 1, K = 8 on
     clusters of 16 its cap from the card's shared memory, and the
     refusal one above; (b) beams of 10 and 16 hypotheses: K2 at the
     flagship's widths and K8 at the conv+BiLSTM recipe's, B = 2, against
     their plain versions, and a flagship Transcriber with a beam of 10
     on 4 utterances against the CPU's tokens and scores (5e-3); (c) the
     port's corpus readers end to end: a LibriSpeech-layout tree of 160 +
     16 FLAC utterances (tests/flac_encoder.py, 2.5-6.4 s of seeded PCM,
     30-60 words each from a seeded lexicon of 8,000), walked, decoded by
     the native FLAC decoder (its count: every file once) and built into
     stacked log-mel features with word targets (V > 3,124); the same
     build through decode_flac_py gives the same PCM and features; one
     epoch of Trainer.fit(chunked=...) of librispeech_vgg at full width
     over two in-memory chunks (K4 and K5 only), then Trainer.evaluate
     with the K = 5 beam on the 16 held-out utterances (K4 and K8 only,
     K8 once a step), its WER from the native edit distance equal to
     edit_distance_np's; and the phase's wall seconds;
 16. (a) the bf16 entries of K16-K19 at the flagship encoder's first
     layer, B = 16, L = 144, H = 256, each against its exact twin
     (BF16_ULPS) and the float32 result (the ground-truth rule), one
     launch a call and two calls bitwise equal, with their device times;
     the bf16 flagship encoder by one gru_layer per direction (K16, K17 6x
     each) and by the stacked scan (K18, K19 3x each), forward and
     backward, bf16 throughout and by the ground-truth rule: these runs'
     launches are the entries'; (b) a one-rank NCCL group: the full-width
     flagship Trainer(mesh=make_mesh(dp=1)), 3 steps at B = 16 and a K = 5
     evaluation, bit for bit the meshless Trainer's with the same
     launches; (c) two gloo ranks spawned on the card (every collective
     staged through the host): dp = 2, the 3 steps on 8 rows each against
     the single-rank steps (K1, K6 3x and K4, K5 once a step on each
     rank), and sp = 2, flagship_loc's teacher-forced decode (the halo
     crossing the shard edge) forward and gradients against K12 and K13
     on one rank (rtol 2e-5 and 5e-4 of the largest magnitude); and the
     phase's wall seconds;
 17. one {"kernels": [...]} JSON line (K2 also at V = 34,000 with its
     plan, its launches the word beam's), the card line, and the last
     line {"ok": true, "device": {...}}.

It exits nonzero without a card, and imports nothing of the JAX package.

    python3 chip_smoke.py --parent DIR

also times another checkout of the repo (DIR, e.g. the parent commit's
port unpacked by `git archive`) beside this one, each in a process of
its own in the order DIR, this, this, DIR: the time per call and the
device time of K3 on the 3.5 s bucket at b = 1 and 8, of the forward GRU
walk's kernels K1, K16 and K18 at B = 1,
L = 132 and B = 16 and 128, L = 144, of the forward LSTM walk K7 at B = 1
and 8, L' = 14 and B = 16 and 128, L' = 16, of the flagship's beam step
K2 and of K8's two instances on
the flagship's widths at b = 1 and 8, the flagship's serving p50 and device time of
one request at b = 1 and 8, the same for K8's <LSTM, location> instance at
the conv+BiLSTM serving shape and for that recipe's requests, the time per
call of each teacher-forced
decoder scan (K4, K5, K10-K15) at its recipe's training shape at B = 16
and 128 and the device time of K4, K5, K10-K12, K14 and K15, and
the p50 train step of each of the four trained configurations at B = 16
and 128.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import inspect
import json
import math
import os
import pathlib
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
SR = 16000
PCM_SECONDS = 3.5
BEAM_K = 5
EOS_ID = 61  # the TIMIT recipe's <EOS>, the last of its 62 outputs
# Added to the readout's eos logit in the "eos" requests. With seed 0,
# 0.2 makes one hypothesis per sample finish on eos at the first step and
# the rest run to max_steps; 0.3 makes every hypothesis finish on eos and
# the beam leave its loop after two steps.
EOS_BIASES = (0.2, 0.3)
PAD_FRAMES = 10  # zero frames at both ends, as the TIMIT pipeline adds
TOL = 1e-4  # kernel vs plain version, max abs error
SCORE_TOL = 5e-3  # card vs CPU beam scores (sums of ~130 log-probs)
# Published peaks of one H100 SXM at 700 W (NVIDIA data sheet): float32
# outside the tensor cores, bf16 on the tensor cores (dense), and HBM3
# bandwidth. A bound counts a function's operations at the rate of its
# inputs' type: float32 for the float32 kernels, bf16 for the bf16
# entries (their products are bf16 x bf16 summed in float32, which the
# tensor cores run at the bf16 rate), whatever units the kernel uses.
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
# Training: the padded TIMIT shapes (L frames, T labels), the recipe's
# batch, and the larger batch the train step is also timed at.
TRAIN_L, TRAIN_T, TRAIN_B, BIG_B = 144, 56, 16, 128
TRAIN_RTOL = 1e-3  # card vs CPU train-step metrics
MORE_STEPS = 30
HOP = 512  # samples per frame at 16 kHz: audio seconds of a batch = B * L * HOP / SR
STEP_LAUNCHES = {"bigru_scan2": 3, "bigru_scan2_bwd": 3, "attention_decode_scan_fwd": 1,
                 "attention_decode_scan_bwd": 1}
CB_STEP_LAUNCHES = {"bilstm_scan": 1, "bilstm_scan_bwd": 1,
                    "attention_decode_scan_loc_lstm_fwd": 1,
                    "attention_decode_scan_loc_lstm_bwd": 1}
LOC_STEP_LAUNCHES = {"bigru_scan2": 3, "bigru_scan2_bwd": 3, "attention_decode_scan_loc_fwd": 1,
                     "attention_decode_scan_loc_bwd": 1}
CBC_STEP_LAUNCHES = {"bilstm_scan": 1, "bilstm_scan_bwd": 1, "attention_decode_scan_lstm_fwd": 1,
                     "attention_decode_scan_lstm_bwd": 1}
# Phase 10, the trainer. The committed flagship-shape checkpoint's
# parameters (tools/ckpt_to_npz.py) and its held-out beam PER on the
# host-built valid split of timit_shaped(4000, 192, noise=0.35, seed=1),
# batched at 32 over the train split's 3 length buckets and cached from
# one shuffle with seed 1, as the port's Trainer.evaluate gives it on the
# CPU (tests/test_torch_quality.py, equal to the JAX package's there).
HELD_OUT_NPZ = pathlib.Path(__file__).resolve().parent / "runs" / "timit_shape_ckpt" / "full" / \
    "params.npz"
HELD_OUT_PER_CPU = 0.10673786888100345
HELD_OUT_PER_TOL = 2e-3  # card vs CPU: a few of 192 utterances may take another near-tie
HELD_OUT = dict(n_train=4000, n_valid=192, noise=0.35, seed=1, batch=32, buckets=3)
FIT = dict(n_train=64, n_valid=16, batch=16, epochs=2)  # Trainer.fit, then a resumed 3rd epoch
# Phase 11: the committed AWN stage restarted from params.npz
# (tools/convergence.py:511-527: sigma0 0.01, lambda 7.8125e-7, seed 2,
# dropout 0.5), and its lambda * KL at the start: the float64 formula and
# the JAX package's float32 awn.kl on the CPU (tests/test_torch_awn.py).
AWN_LAMBDA = 7.8125e-7
AWN_SIGMA0 = 0.01
AWN_SEED = 2
AWN_LAMBDA_KL_F64 = 4.822490046589026
AWN_LAMBDA_KL_JAX = 4.82254921875
GREEDY_EOS_BIAS = 0.06  # with seed 0, ends 6 of 8 conv+BiLSTM greedy rows on eos before the cap
FIT_KERNELS = ("bigru_scan2", "fused_attention_step", "attention_decode_scan_fwd",
               "attention_decode_scan_bwd", "bigru_scan2_bwd")  # K1, K2, K4, K5, K6
SERVE_L = 132  # encoder frames of the 3.5 s PCM: 110, padded to 112, plus 2 x 10 pad frames
CB_PAD_LEN = 130  # encoder frames of the 3.5 s PCM: 110, padded to 112, plus 2 x 10 pad frames
CB_SERVE_L = 14  # the conv+BiLSTM encoder's frames of that PCM: 130 through three pools of 2
CB_TRAIN_L = 16  # the conv+BiLSTM encoder's frames of a TRAIN_L-frame batch
# K8's device kernel by trace name: a substring of cluster_step_loc_lstm_kernel's name and of
# the single-block kernel's before it (attention_step_loc_lstm_kernel), so that --parent
# traces either.
K8_SYMBOLS = ("step_loc_lstm_kernel",)
# Tried in turn on the CPU for the conv+BiLSTM eos request, smallest
# first: with seed 0, 0.02 ends 2 of 8 best hypotheses on eos while the
# beam runs on to max_steps for the others; 0.06 and up end all of them.
CB_EOS_BIASES = (0.01, 0.02, 0.04, 0.08, 0.16, 0.32, 0.64)
# Device kernels of each recipe's train step, by the name each carries in
# a trace.
# The backward recurrences K6, K17, K19 (GRU) and K9 (LSTM) start a gate
# pre-pass (gru_gates_kernel twice, lstm_gates_kernel once), their walk
# and a reduction (atb_kernel).
# The decoder scans' backwards K5, K11 and K15 start a recompute pre-pass
# (gru_decoder_prepass_kernel four times, lstm_decoder_prepass_kernel
# three times), their walk and two reductions.
# The decoder forwards start a pre-pass (lstm_fwd_prepass_kernel or
# gru_fwd_prepass_kernel twice) and their walk.
STEP_KERNELS = ("bigru_scan2_bwd_kernel", "gru_gates_kernel", "bigru_scan2_kernel",
                "gru_fwd_prepass_kernel", "content_gru_fwd_kernel", "gru_decoder_prepass_kernel",
                "content_gru_walk_kernel", "atb_kernel")
CB_STEP_KERNELS = ("bilstm_scan_bwd_kernel", "lstm_gates_kernel", "bilstm_scan_kernel",
                   "loc_lstm_fwd_kernel", "lstm_fwd_prepass_kernel", "loc_lstm_bwd_kernel",
                   "lstm_decoder_prepass_kernel", "atb_kernel")
LOC_STEP_KERNELS = ("bigru_scan2_bwd_kernel", "gru_gates_kernel", "bigru_scan2_kernel",
                    "gru_fwd_prepass_kernel", "loc_gru_fwd_kernel", "gru_decoder_prepass_kernel",
                    "loc_gru_bwd_kernel", "atb_kernel")
CBC_STEP_KERNELS = ("bilstm_scan_bwd_kernel", "lstm_gates_kernel", "bilstm_scan_kernel",
                    "scan_lstm_fwd_kernel", "lstm_fwd_prepass_kernel", "scan_lstm_bwd_kernel",
                    "lstm_decoder_prepass_kernel", "atb_kernel")
# The flagship encoder's three BiGRU layers by each path (phase 7): the
# port's flip-free bigru_layer (K1, K6), one gru_layer per direction
# (K16, K17) and the direction-stacked scan (K18, K19); the launches of
# one forward and backward, and the device kernels of the paths by trace
# name.
ENC_LAYERS = ("bigru1", "bigru2", "bigru3")
ENC_LAUNCHES = {"bigru_layer": {"bigru_scan2": 3, "bigru_scan2_bwd": 3},
                "per_direction": {"gru_scan": 6, "gru_scan_bwd": 6},
                "stacked": {"bigru_scan": 3, "bigru_scan_bwd": 3}}
ENC_KERNELS = ("bigru_scan2_bwd_kernel", "bigru_scan2_kernel", "gru1_walk_fwd_kernel",
               "gru1_walk_bwd_kernel", "gru2_stacked_fwd_kernel", "gru2_stacked_bwd_kernel",
               "gru_gates_kernel", "atb_kernel")
# The forward walks' kernels: the GRU's (K1, K16, K18; csrc/gru_walk.cuh)
# and the LSTM's (K7; csrc/bilstm_scan.cu). Each one's trace symbol,
# directions and plan cell (ops/cuda/walk.py), and the shapes phase 8 and
# --parent time them at: (B, L) of serving one utterance and of the two
# training batches at the flagship encoder's width (the GRU's), and of
# serving one and eight utterances and of the two training batches at the
# conv+BiLSTM recipe's (K7's).
FWD_WALKS = {"bigru_scan2": ("bigru_scan2_kernel", 2, "gru_fwd"),
             "gru_scan": ("gru1_walk_fwd_kernel", 1, "gru_fwd"),
             "bigru_scan": ("gru2_stacked_fwd_kernel", 2, "gru_fwd"),
             "bilstm_scan": ("bilstm_scan_kernel", 2, "lstm_fwd")}
FWD_WALK_SHAPES = ((1, SERVE_L), (TRAIN_B, TRAIN_L), (BIG_B, TRAIN_L))
FWD_WALK_H = 256
LSTM_WALK_SHAPES = ((1, CB_SERVE_L), (8, CB_SERVE_L), (TRAIN_B, CB_TRAIN_L), (BIG_B, CB_TRAIN_L))
LSTM_WALK_H = 128
# The redesigned backward walks: each kernel's walk, its pre-pass and the
# cell its plan is for (ops/cuda/walk.py).
WALKS = {"bigru_scan2_bwd": ("bigru_scan2_bwd_kernel", "gru_gates_kernel", "gru"),
         "gru_scan_bwd": ("gru1_walk_bwd_kernel", "gru_gates_kernel", "gru"),
         "bigru_scan_bwd": ("gru2_stacked_bwd_kernel", "gru_gates_kernel", "gru"),
         "bilstm_scan_bwd": ("bilstm_scan_bwd_kernel", "lstm_gates_kernel", "lstm")}
GRU_GATES = ("gru_gates_kernel", "gru_gates_kernel")  # two pre-pass launches a call
# The decoder scans' backwards on thread-block clusters (K5, K11, K13,
# K15): each call runs the recompute pre-pass (four launches for the GRU,
# three for the LSTM), the walk, then atb_kernel over the steps and
# atb_kernel over the walk's partials. Each one's walk and pre-pass by
# trace name.
PREPASS = ("lstm_decoder_prepass_kernel",) * 3
GRU_PREPASS = ("gru_decoder_prepass_kernel",) * 4
WALK_BWDS = {"attention_decode_scan_bwd": ("content_gru_walk_kernel", GRU_PREPASS),
             "attention_decode_scan_loc_lstm_bwd": ("loc_lstm_bwd_kernel", PREPASS),
             "attention_decode_scan_loc_bwd": ("loc_gru_bwd_kernel", GRU_PREPASS),
             "attention_decode_scan_lstm_bwd": ("scan_lstm_bwd_kernel", PREPASS)}
# The decoder forwards on thread-block clusters (K10, K14, K12, K4): each
# call runs the pre-pass (two launches) and the walk. Each one's walk and
# pre-pass by trace name.
FWD_PREPASS = ("lstm_fwd_prepass_kernel",) * 2
GRU_FWD_PREPASS = ("gru_fwd_prepass_kernel",) * 2
FWD_SCANS = {"attention_decode_scan_loc_lstm_fwd": ("loc_lstm_fwd_kernel", FWD_PREPASS),
             "attention_decode_scan_lstm_fwd": ("scan_lstm_fwd_kernel", FWD_PREPASS),
             "attention_decode_scan_loc_fwd": ("loc_gru_fwd_kernel", GRU_FWD_PREPASS),
             "attention_decode_scan_fwd": ("content_gru_fwd_kernel", GRU_FWD_PREPASS)}

REPLACES = {
    "bigru_scan2": "seq2seq_attention_asr_tpu/ops/pallas/gru_scan.py:666",
    "fused_attention_step": "seq2seq_attention_asr_tpu/ops/pallas/attention_step.py:371",
    "stft_logmel_power": "seq2seq_attention_asr_tpu/ops/pallas/logmel.py:119",
    "bigru_scan2_bwd": "seq2seq_attention_asr_tpu/ops/pallas/gru_scan.py:716",
    "attention_decode_scan_fwd": "seq2seq_attention_asr_tpu/ops/pallas/attention_scan.py:355",
    "attention_decode_scan_bwd": "seq2seq_attention_asr_tpu/ops/pallas/attention_scan.py:851",
    "bilstm_scan": "seq2seq_attention_asr_tpu/ops/pallas/lstm_scan.py:107",
    "fused_attention_step_loc_lstm": "seq2seq_attention_asr_tpu/ops/pallas/attention_step.py:371",
    "bilstm_scan_bwd": "seq2seq_attention_asr_tpu/ops/pallas/lstm_scan.py:145",
    "attention_decode_scan_loc_lstm_fwd":
        "seq2seq_attention_asr_tpu/ops/pallas/attention_scan.py:254",
    "attention_decode_scan_loc_lstm_bwd":
        "seq2seq_attention_asr_tpu/ops/pallas/attention_scan.py:624",
    "attention_decode_scan_loc_fwd": "seq2seq_attention_asr_tpu/ops/pallas/attention_scan.py:219",
    "attention_decode_scan_loc_bwd": "seq2seq_attention_asr_tpu/ops/pallas/attention_scan.py:710",
    "attention_decode_scan_lstm_fwd": "seq2seq_attention_asr_tpu/ops/pallas/attention_scan.py:189",
    "attention_decode_scan_lstm_bwd": "seq2seq_attention_asr_tpu/ops/pallas/attention_scan.py:577",
    "gru_scan": "seq2seq_attention_asr_tpu/ops/pallas/gru_scan.py:147",
    "gru_scan_bwd": "seq2seq_attention_asr_tpu/ops/pallas/gru_scan.py:177",
    "bigru_scan": "seq2seq_attention_asr_tpu/ops/pallas/gru_scan.py:407",
    "bigru_scan_bwd": "seq2seq_attention_asr_tpu/ops/pallas/gru_scan.py:445",
}
SOURCES = {
    "bigru_scan2": "seq2seq_attention_asr_tpu_torch/csrc/bigru_scan2.cu",
    "fused_attention_step": "seq2seq_attention_asr_tpu_torch/csrc/attention_step.cu",
    "stft_logmel_power": "seq2seq_attention_asr_tpu_torch/csrc/logmel.cu",
    "bigru_scan2_bwd": "seq2seq_attention_asr_tpu_torch/csrc/bigru_scan2_bwd.cu",
    "attention_decode_scan_fwd":
        "seq2seq_attention_asr_tpu_torch/csrc/attention_scan_loc_lstm.cu",
    "attention_decode_scan_bwd": "seq2seq_attention_asr_tpu_torch/csrc/attention_scan_loc_lstm.cu",
    "bilstm_scan": "seq2seq_attention_asr_tpu_torch/csrc/bilstm_scan.cu",
    "fused_attention_step_loc_lstm": "seq2seq_attention_asr_tpu_torch/csrc/attention_step.cu",
    "bilstm_scan_bwd": "seq2seq_attention_asr_tpu_torch/csrc/bilstm_scan_bwd.cu",
    "attention_decode_scan_loc_lstm_fwd":
        "seq2seq_attention_asr_tpu_torch/csrc/attention_scan_loc_lstm.cu",
    "attention_decode_scan_loc_lstm_bwd":
        "seq2seq_attention_asr_tpu_torch/csrc/attention_scan_loc_lstm.cu",
    "attention_decode_scan_loc_fwd":
        "seq2seq_attention_asr_tpu_torch/csrc/attention_scan_loc_lstm.cu",
    "attention_decode_scan_loc_bwd":
        "seq2seq_attention_asr_tpu_torch/csrc/attention_scan_loc_lstm.cu",
    "attention_decode_scan_lstm_fwd":
        "seq2seq_attention_asr_tpu_torch/csrc/attention_scan_loc_lstm.cu",
    "attention_decode_scan_lstm_bwd":
        "seq2seq_attention_asr_tpu_torch/csrc/attention_scan_loc_lstm.cu",
    "gru_scan": "seq2seq_attention_asr_tpu_torch/csrc/gru_scan.cu",
    "gru_scan_bwd": "seq2seq_attention_asr_tpu_torch/csrc/gru_scan_bwd.cu",
    "bigru_scan": "seq2seq_attention_asr_tpu_torch/csrc/gru_scan.cu",
    "bigru_scan_bwd": "seq2seq_attention_asr_tpu_torch/csrc/gru_scan_bwd.cu",
}
NO_LIBRARY = {
    "bigru_scan2": "cuDNN's GRU carries biases and applies the reset gate after its matmul",
    "fused_attention_step": "no PyTorch call computes the attention step with its readout",
    "stft_logmel_power": "torch.stft gives the spectrum only, not the mel dB and energy",
    "bigru_scan2_bwd": "no PyTorch call computes the bias-free, reset-before-matmul GRU backward",
    "attention_decode_scan_fwd": "no PyTorch call computes the attention decoder scan",
    "attention_decode_scan_bwd": "no PyTorch call computes the attention decoder scan's backward",
    "fused_attention_step_loc_lstm": "no PyTorch call computes the location-aware or LSTM "
                                     "attention step with its readout",
    "attention_decode_scan_loc_lstm_fwd": "no PyTorch call computes the location-aware LSTM "
                                          "attention decoder scan",
    "attention_decode_scan_loc_lstm_bwd": "no PyTorch call computes the location-aware LSTM "
                                          "attention decoder scan's backward",
    "attention_decode_scan_loc_fwd": "no PyTorch call computes the location-aware GRU attention "
                                     "decoder scan",
    "attention_decode_scan_loc_bwd": "no PyTorch call computes the location-aware GRU attention "
                                     "decoder scan's backward",
    "attention_decode_scan_lstm_fwd": "no PyTorch call computes the LSTM attention decoder scan",
    "attention_decode_scan_lstm_bwd": "no PyTorch call computes the LSTM attention decoder scan's "
                                      "backward",
}
_NO_CUDNN_GRU = ("cuDNN's GRU carries biases and applies the reset gate after its product; this "
                 "GRU is bias-free and applies it before")
NO_LIBRARY.update({name: _NO_CUDNN_GRU for name in ("gru_scan", "gru_scan_bwd", "bigru_scan",
                                                    "bigru_scan_bwd")})


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def make_pcm(n_utt: int, seed: int) -> list:
    """Speech-like test PCM: a few drifting harmonics under a syllable-
    rate envelope, plus noise."""
    rng = np.random.RandomState(seed)
    n = int(PCM_SECONDS * SR)
    t = np.arange(n) / SR
    pcms = []
    for _ in range(n_utt):
        f0 = rng.uniform(90, 220) * (1 + 0.1 * np.sin(2 * np.pi * rng.uniform(0.5, 2) * t))
        phase = 2 * np.pi * np.cumsum(f0) / SR
        voiced = sum(np.sin(k * phase) / k for k in range(1, 8))
        env = 0.5 * (1 + np.sin(2 * np.pi * rng.uniform(3, 6) * t + rng.uniform(0, 6)))
        x = 0.2 * env * voiced + 0.02 * rng.randn(n)
        pcms.append(x.astype(np.float32))
    return pcms


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Time per call of `fn` over `iters` back-to-back calls (CUDA events):
    the device's time, or the host's where the host is the slower side."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


# A device op near either end of a profiler trace may be left out of it:
# the device's timestamps, mapped to the host's clock, can fall outside
# the window the host opened. A host pause after the trace opens and
# before it closes keeps every launch inside the window.
TRACE_PAD_S = 0.02


@contextlib.contextmanager
def traced(activities, pad: float = TRACE_PAD_S):
    """A profiler trace of the block, with `pad` seconds of host pause at
    each end; the block's device work is synchronised before it closes."""
    from torch.profiler import profile

    with profile(activities=activities) as prof:
        time.sleep(pad)
        yield prof
        torch.cuda.synchronize()
        time.sleep(pad)


def device_ms(fn, symbols, iters: int) -> float:
    """Mean device time of one call of `fn`, from a profiler trace of
    `iters` calls: the summed time of the device kernels whose names hold
    one of `symbols` (a C entry point may start more than one; a symbol
    listed n times is launched n times a call), or of every device op the
    call starts when `symbols` is None, without the host's time between
    launches. A trace that kept fewer than nine tenths of the launches (or,
    for `symbols` None, no device record: nan after three) is taken again,
    at most twice, with ten times the host pause at its ends each time
    (late in a long run, a trace at TRACE_PAD_S kept 6 of 10 K1 launches
    three times over); after three, the mean is over the launches the
    third kept if it kept at least half of each symbol's (late in a long
    run, K1's bf16 entry kept 6 of 10 at every pause), else the run
    stops."""
    return sum(device_parts(fn, symbols, iters).values())


def device_parts(fn, symbols, iters: int) -> dict:
    """device_ms by symbol: {symbol: mean device ms of its launches in one
    call}, or {None: every device op's} when `symbols` is None."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        with traced([ProfilerActivity.CPU, ProfilerActivity.CUDA],
                    TRACE_PAD_S * 10 ** attempt) as prof:
            for _ in range(iters):
                fn()
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if symbols is None:
            if events:
                return {None: sum(e.time_range.elapsed_us() for e in events) / iters / 1e3}
            print(f"device_ms: trace {attempt + 1} kept no device record")
            continue
        ms, short, half = {}, [], True
        for symbol in dict.fromkeys(symbols):
            per_call = symbols.count(symbol)
            durs = [e.time_range.elapsed_us() for e in events if symbol in e.name]
            if len(durs) > iters * per_call:
                raise SystemExit(f"profiler saw {len(durs)} launches of {symbol}, expected "
                                 f"{iters * per_call}")
            if len(durs) < 0.9 * iters * per_call:
                short.append(f"{len(durs)} launches of {symbol}, expected {iters * per_call}")
                half = half and len(durs) >= 0.5 * iters * per_call
            # The mean is over the records the trace kept.
            ms[symbol] = per_call * sum(durs) / max(len(durs), 1) / 1e3
        if not short:
            return ms
        print(f"device_ms: trace {attempt + 1} kept {'; '.join(short)}")
    if symbols is None:
        return {None: float("nan")}
    if half:
        print("device_ms: the mean over the launches trace 3 kept (each record's duration is "
              "whole; the lost ones are absent, not cut)")
        return ms
    raise SystemExit(f"profiler saw {'; '.join(short)} in each of 3 traces")


def bound(flops: float, nbytes: float, peak_flops: float = PEAK_F32_FLOPS):
    """Least time on this card for the work, its operations at
    `peak_flops`: (ms, "operations"|"bytes")."""
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes")


def cpu_transcribe(tr, pcms):
    """The CPU run of Transcriber `tr` and the number of decoder steps
    its beam took: calls of the step function, which on CPU tensors runs
    the plain version and launches nothing."""
    from seq2seq_attention_asr_tpu_torch.decode import beam

    step, calls = beam.fused_attention_step, []

    def counted(*args):
        calls.append(1)
        return step(*args)

    beam.fused_attention_step = counted
    try:
        with torch.no_grad():
            out = tr.transcribe(pcms)
    finally:
        beam.fused_attention_step = step
    return out, len(calls)


def check_repeat(c, kernel, got, tag: str) -> None:
    """A second call of case `c` gives the bits of the first (`got`:
    fixed-order sums), and each call is exactly one launch of `kernel`."""
    before = kernel.launches
    with torch.no_grad():
        again = c.kernel(*c.args)
    torch.cuda.synchronize()
    if kernel.launches != before + 1:
        raise SystemExit(f"{c.label} {tag}: {kernel.launches - before} launches in a call")
    if not all(torch.equal(g, a) for g, a in zip(got, again)):
        raise SystemExit(f"{c.label} {tag}: two calls differ")
    print(f"repeat {c.label} {tag}: two calls bitwise equal, one launch each")


def max_err(got, want) -> float:
    return max(float((g - w).abs().max()) for g, w in zip(got, want))


def bwd_err(got, want) -> float:
    """The backward tolerance's measure: the largest, over the output
    tensors, of max|got - plain| - 5e-4 * max|plain|; it must be at most
    5e-5 (sums over B*L or B*T rows are taken in another order)."""
    return max(float((g - w).abs().max()) - 5e-4 * float(w.abs().max())
               for g, w in zip(got, want))


class Case:
    """Inputs of one kernel at the shapes of its path, its wrapper, its
    plain version, the device kernels its entry point starts, and what
    the work costs at the least. A backward case is held to bwd_err.
    `label` names an instance of a kernel that has several; `library`,
    where one PyTorch call computes the same function, is that call."""

    def __init__(self, name, symbols, kernel, plain, args, flops, nbytes, backward=False,
                 label=None, library=None):
        self.name, self.symbols, self.kernel, self.plain, self.args = name, symbols, kernel, plain, args
        self.flops, self.nbytes, self.backward = flops, nbytes, backward
        self.label, self.library = label or name, library

    def check(self, got, want, tag: str) -> float:
        """Max abs error of the kernel against the plain version; exits
        when it is out of tolerance or not finite."""
        err = max_err(got, want)
        finite = all(bool(torch.isfinite(g).all()) for g in got)
        if self.backward:
            excess = bwd_err(got, want)
            ok, tol = excess <= 5e-5, f"max|plain| * 5e-4 + 5e-5, excess {excess:.3e}"
        else:
            ok, tol = err <= TOL, f"{TOL}"
        print(f"parity {self.label} {tag}: max_abs_err={err:.3e} (tol {tol}), finite={finite}")
        if not finite or not ok:
            raise SystemExit(f"{self.label} {tag} disagrees with its plain version")
        return err


def cases(params, cfg, loc_dec, b: int, gen: torch.Generator):
    """K1 and K2 at the flagship's serving shapes, and K8 on the flagship's
    widths with location-aware attention (decoder weights `loc_dec`)."""
    from seq2seq_attention_asr_tpu_torch.ops import attention, cells
    from seq2seq_attention_asr_tpu_torch.ops.cuda import attention_step, gru_scan

    dev = torch.device("cuda")
    n_frames = 1 + int(PCM_SECONDS * SR) // 512
    l_pad = -(-n_frames // 16) * 16
    l_enc = l_pad + 20  # pad_frames = 10 at both ends
    lens = torch.full((b,), n_frames + 20, device=dev)
    valid = (torch.arange(l_enc, device=dev)[None] < lens[:, None]).float()
    rnd = lambda *s: torch.randn(*s, generator=gen).to(dev)

    # K1 at the first encoder layer.
    enc = params["encoder"]["bigru1"]
    hd = enc["fwd"]["w_zr"].shape[1] // 2
    x = rnd(b, l_enc, cfg.input_frame_size) * valid[:, :, None]
    xf = cells.gru_input_proj(enc["fwd"], x).contiguous()
    xb = cells.gru_input_proj(enc["bwd"], x).contiguous()
    wzr2 = torch.stack([enc["fwd"]["w_zr"][:hd], enc["bwd"]["w_zr"][:hd]]).contiguous()
    wh2 = torch.stack([enc["fwd"]["w_h"][:hd], enc["bwd"]["w_h"][:hd]]).contiguous()
    k1 = Case(
        "bigru_scan2", ("bigru_scan2_kernel",), gru_scan.bigru_scan2, gru_scan.bigru_scan2_plain,
        (xf, xb, wzr2, wh2),
        flops=2 * b * l_enc * (6 * hd * hd + 12 * hd),
        nbytes=4 * (2 * b * l_enc * 3 * hd + 2 * 3 * hd * hd + 2 * b * l_enc * hd),
    )

    # K2 at a beam step.
    dec = params["decoder"]
    acfg = cfg.attention_config()
    a, s_dim, st, v = acfg.annotation_depth, acfg.score_depth, acfg.state_depth, acfg.output_depth
    h = rnd(b, l_enc, a) * valid[:, :, None]
    vh = attention.precompute_vh(dec, h).contiguous()
    alpha0 = torch.softmax(rnd(b, BEAM_K, l_enc), -1)
    s0 = rnd(b, BEAM_K, st) * 0.3
    y = torch.nn.functional.one_hot(
        torch.randint(0, v, (b, BEAM_K), generator=gen), v).float().to(dev)
    state = (alpha0, s0, torch.zeros_like(s0))
    step_args = (dec, acfg, state, y, vh, h, valid)
    mo_w = dec["readout"][-2]["w"]
    read = [dec["ws"]["w"], dec["ws"]["b"], dec["w_e"], dec["c_in"]["w"], dec["c_in"]["b"],
            dec["dec_in"]["w"], dec["dec_in"]["b"], dec["cell"]["w_zr"], dec["cell"]["w_h"],
            *[t for layer in dec["readout"] for t in layer.values()]]
    w_bytes = 4 * sum(t.numel() for t in read)  # the weights the kernel reads
    mvs = (st * s_dim + a * st + 2 * st * st + 4 * st * st + 2 * st * st + mo_w.numel()
           + cfg.mlp_depth * v)
    k2 = Case(
        "fused_attention_step", ("attention_step_kernel",),
        lambda *args: _step_outputs(attention_step.fused_attention_step(*args)),
        lambda *args: _step_outputs(attention_step.fused_attention_step_plain(*args)),
        step_args,
        flops=b * BEAM_K * (4 * l_enc * s_dim + 2 * l_enc * a + 2 * mvs),
        nbytes=4 * (b * l_enc * (s_dim + a + 1) + 2 * b * BEAM_K * st
                    + b * BEAM_K * (l_enc + a + st + v)) + w_bytes,
    )

    # K8's content-only GRU instance on K2's inputs (the wrapper routes
    # this configuration to K2), to set the two kernels side by side.
    k8_gru = Case(
        "fused_attention_step_loc_lstm", K8_SYMBOLS,
        lambda *args: _step_outputs(k8_direct(*args)), k2.plain, step_args, k2.flops, k2.nbytes,
        label="fused_attention_step_loc_lstm[gru]",
    )
    loc_cfg = dataclasses.replace(acfg, feature_maps=16, filt_size=10)
    return [k1, k2, k8_gru, step_case("gru+loc", loc_dec, loc_cfg, h, valid, gen)]


def k3_case(b: int, gen: torch.Generator):
    """K3 at the serving shape: b rows of the 3.5 s bucket (k3_input)."""
    from seq2seq_attention_asr_tpu_torch.ops.cuda import logmel

    yp = k3_input(b, gen)
    taps = int((logmel._consts(SR, str(yp.device)).melw != 0).sum())
    frames = 1 + (yp.shape[1] - 2048) // 512
    fft = 2.5 * 2048 * math.log2(2048)  # real-input FFT
    return Case(
        "stft_logmel_power", ("stft_logmel_kernel",),
        lambda yp_: logmel.stft_logmel_power(yp_, SR),
        lambda yp_: logmel.stft_logmel_power_plain(yp_, SR),
        (yp,),
        flops=b * frames * (fft + 3 * 1025 + 2 * taps + 1025 + 2 * 128),
        # The PCM, the window, the filters' nonzero taps and their bin
        # ranges read once; dB and energy written.
        nbytes=4 * (yp.numel() + 2048 + taps + 2 * logmel.N_MELS + b * frames * 129),
    )


def k3_threads(src: str) -> int:
    """The block size of a K3 source (its kThreads)."""
    return int(re.search(r"constexpr int kThreads = (\d+);", src).group(1))


def k3_input(b: int, gen: torch.Generator) -> torch.Tensor:
    """K3's input at the serving shape: b rows of 3.5 s of seeded noise
    (0.1 rms) in the bucket of 112 frames, reflect-padded as logmel_fused
    does: (b, 112 * 512 - 1 + 2048) on the card."""
    n_frames = 1 + int(PCM_SECONDS * SR) // 512
    n_samp = -(-n_frames // 16) * 16 * 512 - 1
    y = torch.randn(b, n_samp, generator=gen).cuda() * 0.1
    return torch.nn.functional.pad(y[:, None], (1024, 1024), mode="reflect")[:, 0].contiguous()


# K2's edge shapes on the flagship decoder (phase 3): (B, K, L, a batch
# row with every position masked or None). Each batch row runs on a
# cluster of C blocks, each taking 1/C of the encoder positions: L < C,
# L not a multiple of C, K = 1 and 8, more clusters than one wave of 16
# holds, and L = 1500 at K = 8, beyond one block's shared memory.
K2_EDGES = [(2, BEAM_K, 3, None), (3, BEAM_K, 37, 1), (8, 1, SERVE_L, None), (8, 8, SERVE_L, 7),
            (16, BEAM_K, SERVE_L, None), (1, 8, 1500, None)]


def k2_inputs(dec, acfg, b, k, l, gen, dead=None):
    """fused_attention_step's arguments at a beam step of (B, K, L) on the
    decoder `dec`: encoder lengths ragged, batch row `dead` fully masked."""
    from seq2seq_attention_asr_tpu_torch.ops import attention

    dev = torch.device("cuda")
    a, st, v = acfg.annotation_depth, acfg.state_depth, acfg.output_depth
    rnd = lambda *s: torch.randn(*s, generator=gen).to(dev)
    lens = torch.randint(1, l + 1, (b,), generator=gen).to(dev)
    mask = (torch.arange(l, device=dev)[None] < lens[:, None]).float()
    if dead is not None:
        mask[dead] = 0.0
    h = rnd(b, l, a) * mask[:, :, None]
    vh = attention.precompute_vh(dec, h).contiguous()
    s0 = rnd(b, k, st) * 0.3
    y = torch.nn.functional.one_hot(torch.randint(0, v, (b, k), generator=gen), v).float().to(dev)
    return dec, acfg, (torch.softmax(rnd(b, k, l), -1), s0, torch.zeros_like(s0)), y, vh, h, mask


def k2_edge_phase(dec, acfg, kernel, gen) -> float:
    """K2 at K2_EDGES: parity with the plain version (TOL), alpha and c
    exactly 0 on a row with no valid position, two calls bitwise equal,
    one launch a call. Returns the largest max abs error."""
    from seq2seq_attention_asr_tpu_torch.ops.cuda import attention_step

    worst = 0.0
    for b, k, l, dead in K2_EDGES:
        args = k2_inputs(dec, acfg, b, k, l, gen, dead)
        before = kernel.launches
        with torch.no_grad():
            got = _step_outputs(attention_step.fused_attention_step(*args))
            again = _step_outputs(attention_step.fused_attention_step(*args))
            want = _step_outputs(attention_step.fused_attention_step_plain(*args))
        torch.cuda.synchronize()
        launches = kernel.launches - before
        plan = attention_step.step_plan_on(b, k, l, acfg.score_depth, acfg.annotation_depth,
                                           acfg.state_depth, *acfg.readout[-2][1:],
                                           acfg.output_depth, torch.device("cuda"))
        err = max_err(got, want)
        finite = all(bool(torch.isfinite(g).all()) for g in got)
        same = all(torch.equal(g, w) for g, w in zip(got, again))
        zero = dead is None or not (got[0][dead].any() or got[1][dead].any())
        print(f"parity fused_attention_step B={b} K={k} L={l}"
              f"{'' if dead is None else f' (row {dead} fully masked)'}: max_abs_err={err:.3e} "
              f"(tol {TOL}), finite={finite}, on clusters of {plan.cluster} in {plan.waves} "
              f"wave(s), two calls bitwise equal: {same}, masked row 0: {zero}, launches "
              f"{launches} for 2 calls")
        if not (err <= TOL and finite and same and zero and launches == 2):
            raise SystemExit(f"fused_attention_step B={b} K={k} L={l} fails on the card")
        worst = max(worst, err)
    return worst


# The decoder forwards' edge shapes (phase 3): (kind, B, L, T, (S, A, St,
# FM, F)), K10 ("loc"), K14 ("lstm"), K12 ("gru_loc") and K4 ("gru"), the
# last batch row with every position masked: the conv+BiLSTM recipe's
# widths (K10, K14) and the flagship's (K12 with its filter of 10, K4) at
# B = 16 and 128; L = 13 < C with St = 9 and A = 12 (not multiples of 4),
# FM = 3 and an even filter; L = 37, not a multiple of C, at B = 5, not a
# multiple of R, with an odd filter.
FWD_EDGES = [("loc", TRAIN_B, 16, TRAIN_T, (150, 256, 400, 16, 5)),
             ("lstm", TRAIN_B, 16, TRAIN_T, (150, 256, 400, 0, 0)),
             ("loc", BIG_B, 16, TRAIN_T, (150, 256, 400, 16, 5)),
             ("lstm", BIG_B, 16, TRAIN_T, (150, 256, 400, 0, 0)),
             ("loc", 3, 13, 5, (17, 12, 9, 3, 4)), ("lstm", 3, 13, 5, (17, 12, 9, 0, 0)),
             ("loc", 5, 37, 9, (64, 40, 33, 16, 5)), ("lstm", 5, 37, 9, (64, 40, 33, 0, 0)),
             ("gru_loc", TRAIN_B, TRAIN_L, TRAIN_T, (512, 512, 256, 16, 10)),
             ("gru", TRAIN_B, TRAIN_L, TRAIN_T, (512, 512, 256, 0, 0)),
             ("gru_loc", BIG_B, TRAIN_L, TRAIN_T, (512, 512, 256, 16, 10)),
             ("gru", BIG_B, TRAIN_L, TRAIN_T, (512, 512, 256, 0, 0)),
             ("gru_loc", 3, 13, 5, (17, 12, 9, 3, 4)), ("gru", 3, 13, 5, (17, 12, 9, 0, 0)),
             ("gru_loc", 5, 37, 9, (64, 40, 33, 16, 5)), ("gru", 5, 37, 9, (64, 40, 33, 0, 0))]
FWD_EDGE_NAMES = {"loc": "attention_decode_scan_loc_lstm_fwd",
                  "lstm": "attention_decode_scan_lstm_fwd",
                  "gru_loc": "attention_decode_scan_loc_fwd", "gru": "attention_decode_scan_fwd"}


def fwd_edge_inputs(kind, b, l, t, dims, gen):
    """The arguments of the forward of `kind` (a key of FWD_EDGE_NAMES) at
    (B, L, T) and widths `dims`: encoder lengths ragged, the last row
    fully masked, weights at the scale of torch's default init."""
    s_dim, a, st, fm, f = dims
    dev = torch.device("cuda")
    rnd = lambda *shape, scale=1.0: (torch.randn(*shape, generator=gen) * scale).to(dev)
    lens = torch.randint(1, l + 1, (b,), generator=gen).to(dev)
    lens[0] = l
    mask = (torch.arange(l, device=dev)[None] < lens[:, None]).float()
    mask[-1] = 0.0
    h = rnd(b, l, a, scale=0.5) * mask[:, :, None]
    u = lambda *shape: rnd(*shape, scale=shape[0] ** -0.5)
    weights = [u(st, s_dim), u(st, s_dim)[0], u(s_dim, s_dim)[0], u(a, st), u(a, st)[0],
               u(2 * st, st), u(2 * st, st)[0]]
    if kind.startswith("gru"):
        weights += [u(2 * st, 2 * st), u(2 * st, st)]
    else:
        weights += [u(st, 4 * st), u(st, 4 * st), u(st, 4 * st)[0]]
    if fm:
        weights += [u(f, fm), u(f, fm)[0], u(fm, s_dim)]
    vh = (h @ u(a, s_dim)).contiguous()
    return (vh, h, mask, rnd(b, t, st, scale=0.5), *(w.contiguous() for w in weights))


def fwd_plans(kernel, b, l, s_dim, a, st, fm, f):
    """The forward walk's plans that fit the card at these shapes: every
    (C, R) and, where W_cx's slice fits a block, both layouts."""
    from seq2seq_attention_asr_tpu_torch.ops.cuda import attention_scan

    smem, resident = attention_scan.scan_limits(kernel, torch.device("cuda"))
    cell = attention_scan.FWD_CELL[kernel.symbol]
    return [attention_scan.FwdPlan(c, r, held) for c in attention_scan.WALK_CLUSTERS
            for r in attention_scan.WALK_ROWS for held in (False, True)
            if resident[c] >= 1 and attention_scan.fwd_smem_bytes(
                r, c, l, s_dim, a, st, fm, f, held, cell) <= smem]


def fwd_edge_phase(kernels, gen) -> dict:
    """K10, K14, K12 and K4 at FWD_EDGES under each plan that fits: parity
    with the plain version (TOL), alpha and c exactly 0 on the fully
    masked row, two calls bitwise equal, one launch a call. Returns the
    largest max abs error of each."""
    from seq2seq_attention_asr_tpu_torch.ops.cuda import attention_scan

    names = FWD_EDGE_NAMES
    worst = dict.fromkeys(names.values(), 0.0)
    default = attention_scan.fwd_plan_on
    try:
        for kind, b, l, t, dims in FWD_EDGES:
            name = names[kind]
            fwd = getattr(attention_scan, name[:-4])
            args = fwd_edge_inputs(kind, b, l, t, dims, gen)
            with torch.no_grad():
                want = getattr(attention_scan, name[:-4] + "_plain")(*args)
            runs = fwd_plans(kernels[name], b, l, *dims)
            line = []
            for run in runs:
                attention_scan.fwd_plan_on = lambda *_, run=run: run
                before = kernels[name].launches
                with torch.no_grad():
                    got, again = fwd(*args), fwd(*args)
                torch.cuda.synchronize()
                err = max_err(got, want)
                finite = all(bool(torch.isfinite(g).all()) for g in got)
                same = all(torch.equal(g, w) for g, w in zip(got, again))
                zero = not (got[1][-1].any() or got[2][-1].any())
                launches = kernels[name].launches - before
                if not (err <= TOL and finite and same and zero and launches == 2):
                    raise SystemExit(f"{name} B={b} L={l} T={t} {dims} on {run} fails on the "
                                     f"card: err {err:.3e}, finite {finite}, repeat {same}, "
                                     f"masked row 0 {zero}, {launches} launches for 2 calls")
                worst[name] = max(worst[name], err)
                line.append(f"C={run.cluster} R={run.rows}{' resident' if run.resident else ''} "
                            f"{err:.3e}")
            print(f"parity {name} B={b} L={l} T={t} (S, A, St, FM, F)={dims}, last row fully "
                  f"masked (alpha and c exactly 0), two calls bitwise equal and one launch a "
                  f"call under each plan, max_abs_err (tol {TOL}): " + "; ".join(line))
    finally:
        attention_scan.fwd_plan_on = default
    return worst


def k2_plan_sweep(c, card: str) -> None:
    """Phase 8: K2's plan at the flagship serving shape (its case `c`),
    and its device time on each cluster size that fits the device."""
    from seq2seq_attention_asr_tpu_torch.ops.cuda import attention_step

    dec, acfg, state, *_ = c.args
    b, k, st = state[1].shape
    dims = (acfg.score_depth, acfg.annotation_depth, st, *acfg.readout[-2][1:],
            acfg.output_depth)
    dev = torch.device("cuda")
    smem_limit, resident = attention_step.step_limits(dev)
    plan = attention_step.step_plan_on(b, k, c.args[4].shape[1], *dims, dev)
    times = {}
    default = attention_step.step_plan_on
    try:
        for cl in attention_step.CLUSTERS:
            if resident[cl] < 1:
                continue
            attention_step.step_plan_on = lambda *_, cl=cl: attention_step.StepPlan(
                cl, -(-b // resident[cl]))
            with torch.no_grad():
                times[cl] = device_ms(lambda: c.kernel(*c.args), c.symbols, 200)
    finally:
        attention_step.step_plan_on = default
    print(f"plan fused_attention_step B={b} K={k}: clusters of {plan.cluster} in {plan.waves} "
          f"wave(s) (resident clusters {resident}, {smem_limit} B of shared memory a block); "
          f"device ms by cluster size: "
          + ", ".join(f"C={cl} {ms:.4f}" for cl, ms in times.items()) + f" ({card})")


def k8_direct(params, cfg, state, y_prev, vh, h, enc_mask):
    """fused_attention_step through K8 whatever the configuration: the
    wrapper's yin, then K8's launch."""
    from seq2seq_attention_asr_tpu_torch.ops.cuda import attention_step

    b, k, st = state[1].shape
    yin = (y_prev.reshape(b * k, -1) @ params["y_in"]["w"] + params["y_in"]["b"]).reshape(b, k, st)
    return attention_step._step_k8(params, cfg, state, yin, vh, h, enc_mask)


# K8's edge shapes (phase 3), as K2's: (B, K, L, a batch row with every
# position masked or None). Each batch row runs on a cluster of C blocks,
# each taking 1/C of the encoder positions: L < C, L not a multiple of C,
# K = 1 and 8, and B = 16, K = 8, L = 1500, each under every cluster size.
K8_EDGES = [(2, BEAM_K, 3, None), (3, BEAM_K, 37, 1), (8, 1, CB_SERVE_L, 7),
            (8, 8, CB_SERVE_L, None), (16, 8, 1500, None)]


def k8_plans(acfg, b, k, l):
    """Every plan K8 can take at this shape on the card: each cluster size
    the card holds whose shared memory fits, in the waves it needs."""
    from seq2seq_attention_asr_tpu_torch.ops.cuda import attention_step as step

    lstm, fm = acfg.cell == "lstm", acfg.feature_maps
    f = acfg.filt_size if fm else 0
    dev = torch.device("cuda")
    smem_limit, resident = step.step_loc_lstm_limits(dev, lstm, fm > 0)
    dense = step.k8_dense(step.k8_layers(acfg))
    groups, kg = step.hyp_groups(k)
    return [step.StepPlan(c, -(-b * groups // resident[c])) for c in step.CLUSTERS
            if resident[c] >= 1 and step.step_loc_lstm_smem_bytes(
                kg, l, acfg.score_depth, acfg.annotation_depth, acfg.state_depth, fm, f, c, lstm,
                dense) <= smem_limit]


def k8_edge_phase(decoders, kernel, gen) -> float:
    """K8's four instances (`decoders`: {variant: (decoder weights,
    config)}, the content-only GRU through k8_direct) at K8_EDGES under
    every plan that fits: parity with the plain version (TOL, the LSTM's
    cell state too), alpha and c exactly 0 on a row with no valid
    position, two calls bitwise equal, one launch a call. Returns the
    largest max abs error."""
    from seq2seq_attention_asr_tpu_torch.ops.cuda import attention_step

    worst, default = 0.0, attention_step.step_loc_lstm_plan_on
    try:
        for variant, (dec, acfg) in decoders.items():
            call = k8_direct if variant == "gru" else attention_step.fused_attention_step
            for b, k, l, dead in K8_EDGES:
                dec_, acfg_, state, y, vh, h, mask = k2_inputs(dec, acfg, b, k, l, gen, dead)
                mem = torch.randn(state[1].shape, generator=gen).cuda() * 0.3
                state = (state[0], state[1], mem)
                args = (dec_, acfg_, state, y, vh, h, mask)
                with torch.no_grad():
                    want = _step_outputs(attention_step.fused_attention_step_plain(*args))
                line = []
                for plan in k8_plans(acfg, b, k, l):
                    attention_step.step_loc_lstm_plan_on = lambda *_, p=plan: p
                    before = kernel.launches
                    with torch.no_grad():
                        got, again = _step_outputs(call(*args)), _step_outputs(call(*args))
                    torch.cuda.synchronize()
                    err = max_err(got, want)
                    finite = all(bool(torch.isfinite(g).all()) for g in got)
                    same = all(torch.equal(g, w) for g, w in zip(got, again))
                    zero = dead is None or not (got[0][dead].any() or got[1][dead].any())
                    launches = kernel.launches - before
                    if not (err <= TOL and finite and same and zero and launches == 2):
                        raise SystemExit(f"fused_attention_step_loc_lstm[{variant}] B={b} K={k} "
                                         f"L={l} on {plan} fails on the card: err {err:.3e}, "
                                         f"finite {finite}, repeat {same}, masked row 0 {zero}, "
                                         f"{launches} launches for 2 calls")
                    worst = max(worst, err)
                    line.append(f"C={plan.cluster} in {plan.waves} wave(s) {err:.3e}")
                print(f"parity fused_attention_step_loc_lstm[{variant}] B={b} K={k} L={l}"
                      f"{'' if dead is None else f' (row {dead} fully masked: alpha and c 0)'}, "
                      f"two calls bitwise equal and one launch a call under each plan, "
                      f"max_abs_err (tol {TOL}): " + "; ".join(line))
    finally:
        attention_step.step_loc_lstm_plan_on = default
    return worst


def k8_plan_sweep(c, card: str) -> None:
    """Phase 8: K8's plan at its case `c`'s shape, and its device time on
    each cluster size that fits the device."""
    from seq2seq_attention_asr_tpu_torch.ops.cuda import attention_step

    dec, acfg, state, _, vh = c.args[:5]
    b, k, l = vh.shape[0], state[1].shape[1], vh.shape[1]
    dev = torch.device("cuda")
    fm = acfg.feature_maps
    plan = attention_step.step_loc_lstm_plan_on(
        b, k, l, acfg.score_depth, acfg.annotation_depth, acfg.state_depth, fm,
        acfg.filt_size if fm else 0, acfg.cell == "lstm",
        attention_step.k8_dense(attention_step.k8_layers(acfg)), dev)
    smem_limit, resident = attention_step.step_loc_lstm_limits(dev, acfg.cell == "lstm", fm > 0)
    times, default = {}, attention_step.step_loc_lstm_plan_on
    try:
        for p in k8_plans(acfg, b, k, l):
            attention_step.step_loc_lstm_plan_on = lambda *_, p=p: p
            with torch.no_grad():
                times[p.cluster] = device_ms(lambda: c.kernel(*c.args), c.symbols, 200)
    finally:
        attention_step.step_loc_lstm_plan_on = default
    print(f"plan {c.label} B={b} K={k} L={l}: clusters of {plan.cluster} in {plan.waves} "
          f"wave(s) (resident clusters {resident}, {smem_limit} B of shared memory a block); "
          f"device ms by cluster size: "
          + ", ".join(f"C={cl} {ms:.4f}" for cl, ms in times.items()) + f" ({card})")


def step_case(variant, dec, acfg, h, valid, gen):
    """K8 at a beam step of K = BEAM_K hypotheses on annotations h (B, L,
    A) with mask `valid`, for the decoder `dec` of config `acfg`."""
    from seq2seq_attention_asr_tpu_torch.ops import attention
    from seq2seq_attention_asr_tpu_torch.ops.cuda import attention_step

    b, l, a = h.shape
    dev = h.device
    s_dim, st, v = acfg.score_depth, acfg.state_depth, acfg.output_depth
    lstm, fm, f = acfg.cell == "lstm", acfg.feature_maps, acfg.filt_size
    rnd = lambda *s: torch.randn(*s, generator=gen).to(dev)
    vh = attention.precompute_vh(dec, h).contiguous()
    state = (torch.softmax(rnd(b, BEAM_K, l), -1), rnd(b, BEAM_K, st) * 0.3,
             rnd(b, BEAM_K, st) * 0.3)
    y = torch.nn.functional.one_hot(
        torch.randint(0, v, (b, BEAM_K), generator=gen), v).float().to(dev)
    # The weights the kernel reads; y_in is applied by the wrapper, and
    # its output yin (K x St a row) is counted in state_floats.
    read = [dec["ws"]["w"], dec["ws"]["b"], dec["w_e"], dec["c_in"]["w"], dec["c_in"]["b"],
            dec["dec_in"]["w"], dec["dec_in"]["b"], *dec["cell"].values(),
            *[t for layer in dec["readout"] for t in layer.values()]]
    if fm:
        read += [dec["loc_conv"]["w"], dec["loc_conv"]["b"], dec["u"]]
    # One hypothesis's weight products as multiply-adds: s -> Ws, c_in,
    # dec_in, the cell's gates (and the GRU's candidate), the readout.
    ro_mv = sum(layer["w"].numel() for layer in dec["readout"] if "w" in layer)
    cell_mv = 2 * st * 4 * st if lstm else 2 * st * 2 * st + 2 * st * st
    mvs = st * s_dim + a * st + 2 * st * st + cell_mv + ro_mv
    # Per hypothesis: energies 4 L S, the location term (conv 2 L FM f,
    # feat . U 2 L S FM), context 2 L A, the products, softmax and cell.
    per_hyp = 4 * l * s_dim + 2 * l * a + 2 * mvs + 5 * l + 10 * st
    if fm:
        per_hyp += 2 * l * fm * f + 2 * l * s_dim * fm
    state_floats = BEAM_K * (2 * st + (st if lstm else 0) + (l if fm else 0))  # yin, s, mem, alpha
    out_floats = BEAM_K * (l + a + st + v + (st if lstm else 0))
    return Case(
        "fused_attention_step_loc_lstm", K8_SYMBOLS,
        lambda *args: _step_outputs(attention_step.fused_attention_step(*args)),
        lambda *args: _step_outputs(attention_step.fused_attention_step_plain(*args)),
        (dec, acfg, state, y, vh, h, valid),
        flops=b * BEAM_K * per_hyp,
        nbytes=4 * (b * (l * (s_dim + a + 1) + state_floats + out_floats)
                    + sum(t.numel() for t in read)),
        label=f"fused_attention_step_loc_lstm[{variant}]",
    )


def cudnn_lstm(p, device):
    """One bidirectional torch.nn.LSTM layer (cuDNN) holding the weights
    of the BiLSTM `p`. PyTorch's gate order is also (in, forget, cell,
    out): weight_ih = w_x^T, weight_hh = w_h^T, bias_ih = b, bias_hh = 0.
    On rows that all run to L its output is bilstm_layer's. A yardstick
    only: the port never calls cuDNN."""
    dim_in, hd = p["fwd"]["w_x"].shape[0], p["fwd"]["w_h"].shape[0]
    lstm = torch.nn.LSTM(dim_in, hd, batch_first=True, bidirectional=True).to(device)
    with torch.no_grad():
        for sfx, d in (("", "fwd"), ("_reverse", "bwd")):
            getattr(lstm, f"weight_ih_l0{sfx}").copy_(p[d]["w_x"].T)
            getattr(lstm, f"weight_hh_l0{sfx}").copy_(p[d]["w_h"].T)
            getattr(lstm, f"bias_ih_l0{sfx}").copy_(p[d]["b"])
            getattr(lstm, f"bias_hh_l0{sfx}").zero_()
    return lstm


def cudnn_bilstm(p, x):
    """cuDNN's bidirectional LSTM with the weights of `p`, as a call on x (B, L, I)."""
    lstm = cudnn_lstm(p, x.device)
    return lambda: lstm(x)[0]


def cudnn_bilstm_bwd(p, x, dy):
    """cuDNN's backward of its bidirectional LSTM with the weights of `p`
    on x (B, L, I), given the output's cotangent dy (B, L, 2H), as a call:
    autograd.grad of the output for the input and every weight, in x's
    type (float32 or bf16). Besides what K9 computes it forms dx and the
    input weights' gradient."""
    lstm = cudnn_lstm(p, x.device).to(x.dtype)
    xin = x.detach().requires_grad_(True)
    with torch.enable_grad():
        out = lstm(xin)[0]
    wrt = [xin, *lstm.parameters()]
    return lambda: torch.autograd.grad(out, wrt, dy, retain_graph=True)


def conv_bilstm_cases(cb_params, cb_cfg, noloc_dec, feats, gen):
    """K7 on the conv stack's output of `feats` (B, 110, 123), padded as
    the Transcriber pads them (bucket 112 frames, 10 zero frames at both
    ends), and K8 at a beam step on the BiLSTM's output: the recipe's
    decoder and the recipe's widths without the location term
    (`noloc_dec`). Returns (cases, the K7 call with its two input
    projections)."""
    from seq2seq_attention_asr_tpu_torch.models import conv_bilstm
    from seq2seq_attention_asr_tpu_torch.ops import cells, conv
    from seq2seq_attention_asr_tpu_torch.ops.cuda import lstm_scan
    from seq2seq_attention_asr_tpu_torch.ops.masking import flip_sequences, length_mask

    b, n, _ = feats.shape
    x = torch.nn.functional.pad(feats, (0, 0, PAD_FRAMES, -(-n // 16) * 16 - n + PAD_FRAMES))
    enc = cb_params["encoder"]
    p = enc["bilstm"]
    with torch.no_grad():
        hc = x
        for name in ("conv1", "conv2", "conv3"):
            hc = conv.temporal_max_pool(torch.relu(conv.temporal_conv(enc[name], hc)), 2)
        lens = conv_bilstm.encode_lengths(
            cb_cfg, torch.full((b,), n + 2 * PAD_FRAMES, device=x.device))

        def projections():
            return torch.stack([cells.lstm_input_proj(p["fwd"], hc),
                                cells.lstm_input_proj(p["bwd"], flip_sequences(hc, lens))])

        xproj2 = projections().contiguous()
        hd = p["fwd"]["w_h"].shape[0]
        z2 = hc.new_zeros((2, b, hd))
        wh2 = torch.stack([p["fwd"]["w_h"], p["bwd"]["w_h"]]).contiguous()
        hs, _ = lstm_scan.bilstm_scan_plain(xproj2, z2, z2, wh2)
        h_enc = torch.cat([hs[0], flip_sequences(hs[1], lens)], dim=-1).contiguous()
        cudnn = cudnn_bilstm(p, hc)
        lib_err = float((cudnn() - h_enc).abs().max())
    l = hc.shape[1]
    print(f"K7 input B={b}: conv stack output {tuple(hc.shape)}, lengths {lens.tolist()}; cuDNN's "
          f"LSTM on it differs from the port's BiLSTM layer by {lib_err:.3e} (max abs)")
    k7 = Case(
        "bilstm_scan", ("bilstm_scan_kernel",), lstm_scan.bilstm_scan, lstm_scan.bilstm_scan_plain,
        (xproj2, z2, z2, wh2),
        # Per row, step and direction: h @ W_h (8 H^2) and ~30 H elementwise.
        flops=2 * b * l * (8 * hd * hd + 30 * hd),
        nbytes=4 * (2 * b * l * 4 * hd + 4 * b * hd + 2 * hd * 4 * hd  # inputs
                    + 2 * 2 * b * l * hd),  # hidden and cell states
        library=cudnn,
    )
    valid = length_mask(lens, l)
    acfg = cb_cfg.attention_config()
    noloc_cfg = dataclasses.replace(acfg, feature_maps=0)
    with_proj = lambda: lstm_scan.bilstm_scan(projections().contiguous(), z2, z2, wh2)
    return [k7, step_case("lstm+loc", cb_params["decoder"], acfg, h_enc, valid, gen),
            step_case("lstm", noloc_dec, noloc_cfg, h_enc, valid, gen)], with_proj


def shape_tag(key) -> str:
    """The shape a case ran at: its batch, or a training shape."""
    if key == "train":
        return f"B={TRAIN_B} L={TRAIN_L} T={TRAIN_T}"
    if key in ("cbtrain", "cbctrain"):
        return f"B={TRAIN_B} {TRAIN_L} frames T={TRAIN_T}"
    if key == "loctrain":
        return f"B={TRAIN_B} L={TRAIN_L} T={TRAIN_T}, 16 maps, filter 10"
    if key == "enc":
        return f"B={TRAIN_B} L={TRAIN_L} H=256"
    if key == "enc1":
        return f"B=1 L={SERVE_L} H=256"
    return f"B={key}"


def _step_outputs(res):
    (_, _, mem), out = res
    return out["alpha"], out["c"], out["s"], mem, out["logp"]


def train_batch(b: int, seed: int):
    """One padded training batch (x, x_len, y, dec_mask) at the training
    shape, on the CPU: seeded features, encoder lengths ragged in
    96..L and label lengths in 20..T (the first row at full length)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(b, TRAIN_L, 123).astype(np.float32)
    x_len = rng.randint(96, TRAIN_L + 1, b)
    labels = rng.randint(20, TRAIN_T + 1, b)
    x_len[0], labels[0] = TRAIN_L, TRAIN_T
    y = rng.randint(0, 62, (b, TRAIN_T))
    dec_mask = (np.arange(TRAIN_T)[None] < labels[:, None]).astype(np.float32)
    return tuple(torch.from_numpy(a) for a in (x, x_len.astype(np.int64), y, dec_mask))


def train_cases(params, cfg, batch, gen: torch.Generator):
    """K6, K4 and K5 at the training shape, for the model of `cfg` with
    weights `params`: K6 on the first encoder layer's projections of the
    batch, K4 and K5 on the batch's encoder output (computed without
    gradient), with random cotangents."""
    from seq2seq_attention_asr_tpu_torch.models import chorowski
    from seq2seq_attention_asr_tpu_torch.ops import attention, cells, readout
    from seq2seq_attention_asr_tpu_torch.ops.cuda import attention_scan, gru_scan
    from seq2seq_attention_asr_tpu_torch.ops.masking import length_mask

    dev = torch.device("cuda")
    x, x_len, y, dec_mask = (t.to(dev) for t in batch)
    b, l, _ = x.shape
    t_len = y.shape[1]
    enc_mask = length_mask(x_len, l)
    rnd = lambda *s: torch.randn(*s, generator=gen).to(dev)

    # K6 at the first encoder layer: inputs zero past each row's length,
    # as bigru_layer hands them over, and so are the output cotangents.
    enc = params["encoder"]["bigru1"]
    hd = enc["fwd"]["w_zr"].shape[1] // 2
    xm = x * enc_mask[:, :, None]
    xf = cells.gru_input_proj(enc["fwd"], xm).contiguous()
    xb = cells.gru_input_proj(enc["bwd"], xm).contiguous()
    wzr2 = torch.stack([enc["fwd"]["w_zr"][:hd], enc["bwd"]["w_zr"][:hd]]).contiguous()
    wh2 = torch.stack([enc["fwd"]["w_h"][:hd], enc["bwd"]["w_h"][:hd]]).contiguous()
    with torch.no_grad():
        ysf, ysb = gru_scan.bigru_scan2_plain(xf, xb, wzr2, wh2)
    dys = [rnd(b, l, hd) * enc_mask[:, :, None] for _ in range(2)]
    rows = b * l
    k6 = Case(
        "bigru_scan2_bwd", ("bigru_scan2_bwd_kernel", *GRU_GATES, "atb_kernel"),
        gru_scan.bigru_scan2_bwd,
        gru_scan.bigru_scan2_bwd_plain, (xf, xb, wzr2, wh2, ysf, ysb, *dys),
        # Per row step and direction: the pre-pass's two gate products
        # (6 H^2), the walk's two transposed products (6 H^2), the
        # weight-gradient outer products (6 H^2) and ~30 H elementwise.
        flops=2 * rows * (18 * hd * hd + 30 * hd),
        nbytes=4 * (2 * rows * 3 * hd + 4 * rows * hd + 2 * 3 * hd * hd  # inputs
                    + 2 * rows * 3 * hd + 2 * 3 * hd * hd),  # dx and dW
        backward=True,
    )

    # K4 and K5 on the encoder output of the batch.
    dec = params["decoder"]
    with torch.no_grad():
        h = chorowski.encode(params, cfg, x, x_len).contiguous()
        vh = attention.precompute_vh(dec, h).contiguous()
        onehot = (torch.nn.functional.one_hot(y.long(), cfg.output_depth).float()
                  * dec_mask[..., None])
        y_prev = torch.cat([torch.zeros_like(onehot[:, :1]), onehot[:, :-1]], dim=1)
        yin = readout.linear_apply(dec["y_in"], y_prev).contiguous()
    weights = (dec["ws"]["w"], dec["ws"]["b"], dec["w_e"], dec["c_in"]["w"], dec["c_in"]["b"],
               dec["dec_in"]["w"], dec["dec_in"]["b"], dec["cell"]["w_zr"], dec["cell"]["w_h"])
    s_dim, a, st = vh.shape[2], h.shape[2], yin.shape[2]
    scan_args = (vh, h, enc_mask, yin, *weights)
    w_floats = sum(w.numel() for w in weights)
    steps = b * t_len
    # One step's weight products (s -> Ws, c_in, dec_in, the gates, the
    # candidate), as multiply-adds.
    step_mv = st * s_dim + a * st + 2 * st * st + 4 * st * st + 2 * st * st
    in_floats = b * l * (s_dim + a + 1) + steps * st + w_floats
    k4 = Case(
        "attention_decode_scan_fwd", GRU_FWD_PREPASS + ("content_gru_fwd_kernel",),
        attention_scan.attention_decode_scan,
        attention_scan.attention_decode_scan_plain, scan_args,
        # Per step: energies (add, tanh, multiply-add) 4 L S, context 2 L A,
        # the weight products, softmax ~5 L and ~10 St elementwise.
        flops=steps * (4 * l * s_dim + 2 * l * a + 2 * step_mv + 5 * l + 10 * st),
        nbytes=4 * (in_floats + steps * (st + a + l)),
    )
    with torch.no_grad():
        saved = attention_scan.attention_decode_scan_plain(*scan_args)
    if "alpha_seq" not in inspect.signature(attention_scan.attention_decode_scan_bwd).parameters:
        saved = saved[:2]  # a port whose K5 recomputes alpha (--parent may time one)
    cot = (rnd(b, t_len, st) * dec_mask[..., None], rnd(b, t_len, a) * dec_mask[..., None],
           rnd(b, t_len, l) * dec_mask[..., None])
    k5 = Case(
        "attention_decode_scan_bwd", WALK_BWDS["attention_decode_scan_bwd"][1] + (
            WALK_BWDS["attention_decode_scan_bwd"][0], "atb_kernel", "atb_kernel"),
        attention_scan.attention_decode_scan_bwd, attention_scan.attention_decode_scan_bwd_plain,
        (*scan_args, *saved, *cot),
        # Per step: the recompute (the forward's work without the
        # context), the energies' backward (~6 L S), the context's backward
        # (4 L A), the softmax's (~4 L), and the same weight products
        # twice more, transposed and as weight-gradient outer products.
        flops=steps * (4 * l * s_dim + 5 * l + 10 * st + 6 * l * s_dim + 4 * l * a + 4 * l
                       + 3 * 2 * step_mv),
        nbytes=4 * (in_floats + steps * (2 * st + 2 * a + 2 * l)  # inputs, saved and cotangents
                    + b * l * (s_dim + a) + steps * st + w_floats),  # dvh, dh, dyin, dW
        backward=True,
    )
    return [k6, k4, k5]


def cb_train_cases(params, cfg, batch, gen: torch.Generator):
    """K9, K10 and K11 at the conv+BiLSTM recipe's training shape, for the
    model of `cfg` with weights `params`: K9 on the BiLSTM's projections
    of the batch's conv-stack output (h_prev and c_prev from K7's plain
    forward, shifted as BiLSTMScan shifts them), K10 and K11 on the
    batch's encoder output (computed without gradient). The cotangents
    are random and zero past each row's length; K11 gets them on s, c
    and alpha (so that alpha's carry through the location term runs) and
    none on mem, as on the path."""
    from seq2seq_attention_asr_tpu_torch.models import conv_bilstm
    from seq2seq_attention_asr_tpu_torch.ops import cells, conv
    from seq2seq_attention_asr_tpu_torch.ops.cuda import lstm_scan
    from seq2seq_attention_asr_tpu_torch.ops.masking import flip_sequences, length_mask

    dev = torch.device("cuda")
    x, x_len, y, dec_mask = (t.to(dev) for t in batch)
    b, t_len = y.shape
    rnd = lambda *s: torch.randn(*s, generator=gen).to(dev)
    enc = params["encoder"]
    p = enc["bilstm"]
    with torch.no_grad():
        hc = x
        for name in ("conv1", "conv2", "conv3"):
            hc = conv.temporal_max_pool(torch.relu(conv.temporal_conv(enc[name], hc)), 2)
        lens = conv_bilstm.encode_lengths(cfg, x_len)
        l = hc.shape[1]
        enc_mask = length_mask(lens, l)
        xproj2 = torch.stack([cells.lstm_input_proj(p["fwd"], hc),
                              cells.lstm_input_proj(p["bwd"], flip_sequences(hc, lens))])
        xproj2 = xproj2.contiguous()
        hd = p["fwd"]["w_h"].shape[0]
        z2 = hc.new_zeros((2, b, hd))
        wh2 = torch.stack([p["fwd"]["w_h"], p["bwd"]["w_h"]]).contiguous()
        hs, cs = lstm_scan.bilstm_scan_plain(xproj2, z2, z2, wh2)
        h_prev = torch.cat([z2[:, :, None], hs[:, :, :-1]], dim=2)
        c_prev = torch.cat([z2[:, :, None], cs[:, :, :-1]], dim=2)
        h_enc = torch.cat([hs[0], flip_sequences(hs[1], lens)], dim=-1).contiguous()
    print(f"K9-K11 input B={b}: conv stack output {tuple(hc.shape)}, encoder lengths "
          f"{lens.tolist()}")
    dys = rnd(2, b, l, hd) * enc_mask[None, :, :, None]
    rows = b * l
    k9 = Case(
        "bilstm_scan_bwd", ("bilstm_scan_bwd_kernel", "lstm_gates_kernel", "atb_kernel"),
        lstm_scan.bilstm_scan_bwd,
        lstm_scan.bilstm_scan_bwd_plain, (xproj2, h_prev, c_prev, dys, wh2),
        # Per row, step and direction: the pre-pass's product h_prev @ W_h,
        # the walk's transposed product da @ W_h^T and the weight-gradient
        # outer product (8 H^2 each), and ~40 H elementwise.
        flops=2 * rows * (24 * hd * hd + 40 * hd),
        nbytes=4 * (2 * rows * 4 * hd + 3 * 2 * rows * hd + 2 * 4 * hd * hd  # inputs
                    + 2 * rows * 4 * hd + 2 * 2 * b * hd + 2 * 4 * hd * hd),  # dxproj2, dh0, dc0, dW_h
        backward=True,
        library=cudnn_bilstm_bwd(p, hc, torch.cat([dys[0], dys[1]], dim=-1)),
    )

    return [k9] + decoder_scan_cases("loc_lstm", params["decoder"], cfg.output_depth, h_enc,
                                     enc_mask, y, dec_mask, gen)


# The kernels of each teacher-forced decoder scan that shares
# attention_scan_loc_lstm.cu: (forward name, its trace symbols: the
# pre-pass and the walk; backward name, its trace symbols: for the LSTM
# the pre-pass, the walk, then one reduction over the steps and one over
# the walk's partials; for the location-aware GRU the walk, the steps'
# reduction and one over the rows' location-term partials).
DECODER_SCANS = {
    "loc_lstm": ("attention_decode_scan_loc_lstm_fwd", FWD_PREPASS + ("loc_lstm_fwd_kernel",),
                 "attention_decode_scan_loc_lstm_bwd",
                 PREPASS + ("loc_lstm_bwd_kernel", "atb_kernel", "atb_kernel")),
    "loc": ("attention_decode_scan_loc_fwd", GRU_FWD_PREPASS + ("loc_gru_fwd_kernel",),
            "attention_decode_scan_loc_bwd",
            GRU_PREPASS + ("loc_gru_bwd_kernel", "atb_kernel", "atb_kernel")),
    "lstm": ("attention_decode_scan_lstm_fwd", FWD_PREPASS + ("scan_lstm_fwd_kernel",),
             "attention_decode_scan_lstm_bwd",
             PREPASS + ("scan_lstm_bwd_kernel", "atb_kernel", "atb_kernel")),
}


def decoder_scan_cases(kind, dec, output_depth, h, enc_mask, y, dec_mask, gen):
    """The forward and backward kernels of the decoder scan `kind` (a key
    of DECODER_SCANS: K10 and K11, K12 and K13, or K14 and K15) on the
    annotations h (B, L, A) of a training batch (labels y, mask dec_mask),
    for the decoder weights `dec`. The backward gets random cotangents on
    s, c and alpha, zero past each row's label length (alpha's runs the
    carry through the location term), and none on mem, as on the path."""
    from seq2seq_attention_asr_tpu_torch.ops import attention, readout
    from seq2seq_attention_asr_tpu_torch.ops.cuda import attention_scan

    b, l, a = h.shape
    t_len = y.shape[1]
    rnd = lambda *s: torch.randn(*s, generator=gen).to(h.device)
    lstm, loc = kind != "loc", kind != "lstm"
    with torch.no_grad():
        vh = attention.precompute_vh(dec, h).contiguous()
        onehot = (torch.nn.functional.one_hot(y.long(), output_depth).float()
                  * dec_mask[..., None])
        y_prev = torch.cat([torch.zeros_like(onehot[:, :1]), onehot[:, :-1]], dim=1)
        yin = readout.linear_apply(dec["y_in"], y_prev).contiguous()
    cell = dec["cell"]
    weights = (dec["ws"]["w"], dec["ws"]["b"], dec["w_e"], dec["c_in"]["w"], dec["c_in"]["b"],
               dec["dec_in"]["w"], dec["dec_in"]["b"])
    weights += (cell["w_h"], cell["w_x"], cell["b"]) if lstm else (cell["w_zr"], cell["w_h"])
    if loc:
        weights += (dec["loc_conv"]["w"][:, 0, :], dec["loc_conv"]["b"], dec["u"])
    s_dim, st = vh.shape[2], yin.shape[2]
    fm, f = (dec["u"].shape[0], dec["loc_conv"]["w"].shape[0]) if loc else (0, 0)
    scan_args = (vh, h, enc_mask, yin, *weights)
    w_floats = sum(w.numel() for w in weights)
    steps = b * t_len
    # One step's weight products (s -> Ws, c_in, dec_in, the LSTM's two
    # gate products or the GRU's gates and candidate), as multiply-adds;
    # the location features and UF.
    step_mv = st * s_dim + a * st + 2 * st * st + (8 * st * st if lstm else 6 * st * st)
    loc_flops = 2 * l * fm * f + 2 * l * s_dim * fm
    in_floats = b * l * (s_dim + a + 1) + steps * st + w_floats
    out_floats = steps * ((2 if lstm else 1) * st + a + l)  # s, c, alpha, and mem
    fwd_name, fwd_symbols, bwd_name, bwd_symbols = DECODER_SCANS[kind]
    fwd = Case(
        fwd_name, fwd_symbols, getattr(attention_scan, fwd_name[:-4]),
        getattr(attention_scan, fwd_name[:-4] + "_plain"), scan_args,
        # Per step: energies (add, tanh, multiply-add) 4 L S, the location
        # term, context 2 L A, the weight products, softmax ~5 L and ~10 St
        # elementwise.
        flops=steps * (4 * l * s_dim + loc_flops + 2 * l * a + 2 * step_mv + 5 * l + 10 * st),
        nbytes=4 * (in_floats + out_floats),
    )
    with torch.no_grad():
        saved = fwd.plain(*scan_args)
    m = dec_mask[..., None]
    cot = (rnd(b, t_len, st) * m, rnd(b, t_len, a) * m, rnd(b, t_len, l) * m,
           None)[:4 if lstm else 3]
    bwd = Case(
        bwd_name, bwd_symbols, getattr(attention_scan, bwd_name),
        getattr(attention_scan, bwd_name + "_plain"), (*scan_args, *saved, *cot),
        # Per step: the recompute (the weight products, the location
        # features and UF), the energies' backward (~8 L S), dfeat and
        # alpha_prev's cotangent, the context's backward (4 L A), the
        # softmax's (~4 L), ~30 St elementwise, the transposed products and
        # the weight-gradient outer products (2 x 2 step_mv), dU and dwconv.
        flops=steps * (6 * step_mv + 8 * l * s_dim + 3 * loc_flops + 4 * l * a + 4 * l
                       + 30 * st),
        nbytes=4 * (in_floats + out_floats  # inputs and saved sequences
                    + steps * (st + a + l)  # the cotangents of s, c and alpha
                    + b * l * (s_dim + a) + steps * st + w_floats),  # dvh, dh, dyin, dW
        backward=True,
    )
    return [fwd, bwd]


def loc_train_cases(params, cfg, batch, gen: torch.Generator):
    """K12 and K13 at the flagship's training shape, for the flagship_loc
    model of `cfg` with weights `params`, on the batch's encoder output
    (computed without gradient)."""
    from seq2seq_attention_asr_tpu_torch.models import chorowski
    from seq2seq_attention_asr_tpu_torch.ops.masking import length_mask

    x, x_len, y, dec_mask = (t.cuda() for t in batch)
    with torch.no_grad():
        h = chorowski.encode(params, cfg, x, x_len).contiguous()
    return decoder_scan_cases("loc", params["decoder"], cfg.output_depth, h,
                              length_mask(x_len, x.shape[1]), y, dec_mask, gen)


def cbc_train_cases(params, cfg, batch, gen: torch.Generator):
    """K14 and K15 at the conv+BiLSTM recipe's training shape, for the
    conv_bilstm_content model of `cfg` with weights `params`, on the
    batch's encoder output (computed without gradient)."""
    from seq2seq_attention_asr_tpu_torch.models import conv_bilstm
    from seq2seq_attention_asr_tpu_torch.ops.masking import length_mask

    x, x_len, y, dec_mask = (t.cuda() for t in batch)
    with torch.no_grad():
        h, lens = conv_bilstm.encode(params, cfg, x, x_len)
    return decoder_scan_cases("lstm", params["decoder"], cfg.output_depth, h.contiguous(),
                              length_mask(lens, h.shape[1]), y, dec_mask, gen)


def gru_scan_cases(enc, x, lens, gen):
    """K16-K19 on the first encoder layer (`enc`, on the card) over x (B,
    L, 123) with lengths `lens`, as the stacked path hands them over: x
    masked, each direction's projection, direction 1's input flipped into
    its scan order; nonzero initial states (0.5 randn) and a random
    cotangent of the outputs. K16 and K17 take direction 0, or K18 and
    K19 both."""
    from seq2seq_attention_asr_tpu_torch.ops import cells
    from seq2seq_attention_asr_tpu_torch.ops.cuda import gru_scan
    from seq2seq_attention_asr_tpu_torch.ops.masking import flip_sequences, length_mask

    b, l, _ = x.shape
    p = enc["bigru1"]
    hd = p["fwd"]["w_zr"].shape[1] // 2
    rnd = lambda *s: torch.randn(*s, generator=gen).to(x.device)
    with torch.no_grad():
        xm = x * length_mask(lens, l)[:, :, None]
        xproj2 = torch.stack([cells.gru_input_proj(p["fwd"], xm),
                              cells.gru_input_proj(p["bwd"], flip_sequences(xm, lens))])
        xproj2 = xproj2.contiguous()
        wzr2 = torch.stack([p["fwd"]["w_zr"][:hd], p["bwd"]["w_zr"][:hd]]).contiguous()
        wh2 = torch.stack([p["fwd"]["w_h"][:hd], p["bwd"]["w_h"][:hd]]).contiguous()
        h02 = rnd(2, b, hd) * 0.5
        ys2 = gru_scan.bigru_scan_plain(xproj2, h02, wzr2, wh2)
        h_prevs2 = torch.cat([h02[:, :, None], ys2[:, :, :-1]], dim=2).contiguous()
    dys2 = rnd(2, b, l, hd)
    rows = b * l
    # One direction: per row and step the two recurrent products (3 H^2
    # multiply-adds) and ~12 H elementwise; the backward the two
    # recompute products, the two transposed ones and the weight-gradient
    # outer products (9 H^2 multiply-adds) and ~30 H elementwise: the
    # recompute is the pre-pass's.
    fwd_flops, bwd_flops = rows * (6 * hd * hd + 12 * hd), rows * (18 * hd * hd + 30 * hd)
    fwd_bytes = 4 * (rows * 3 * hd + b * hd + 3 * hd * hd + rows * hd)
    bwd_bytes = 4 * (rows * 3 * hd + 2 * rows * hd + 3 * hd * hd  # xproj, h_prevs, dys, W
                     + rows * 3 * hd + b * hd + 3 * hd * hd)  # dxproj, dh0, dW
    one = lambda *ts: tuple(t[0] for t in ts)
    tup = lambda fn: lambda *a: (fn(*a),)  # forward kernels return one tensor
    return [
        Case("gru_scan", ("gru1_walk_fwd_kernel",), tup(gru_scan.gru_scan),
             tup(gru_scan.gru_scan_plain), one(xproj2, h02, wzr2, wh2), fwd_flops, fwd_bytes),
        Case("gru_scan_bwd", ("gru1_walk_bwd_kernel", *GRU_GATES, "atb_kernel"),
             gru_scan.gru_scan_bwd,
             gru_scan.gru_scan_bwd_plain, one(xproj2, h_prevs2, dys2, wzr2, wh2), bwd_flops,
             bwd_bytes, backward=True),
        Case("bigru_scan", ("gru2_stacked_fwd_kernel",), tup(gru_scan.bigru_scan),
             tup(gru_scan.bigru_scan_plain), (xproj2, h02, wzr2, wh2), 2 * fwd_flops,
             2 * fwd_bytes),
        Case("bigru_scan_bwd", ("gru2_stacked_bwd_kernel", *GRU_GATES, "atb_kernel"),
             gru_scan.bigru_scan_bwd,
             gru_scan.bigru_scan_bwd_plain, (xproj2, h_prevs2, dys2, wzr2, wh2), 2 * bwd_flops,
             2 * bwd_bytes, backward=True),
    ]


def per_direction_layer(p, x, lengths):
    """A BiGRU layer as the JAX package's unfused branch builds it
    (seq2seq_attention_asr_tpu/ops/rnn.py:160-166, 182-188): mask x, one
    rnn.gru_layer per direction (K16, K17 on the card), concatenate, mask."""
    from seq2seq_attention_asr_tpu_torch.ops import rnn
    from seq2seq_attention_asr_tpu_torch.ops.masking import length_mask

    mask = length_mask(lengths, x.shape[1], x.dtype)[:, :, None]
    x = x * mask
    ys = torch.cat([rnn.gru_layer(p["fwd"], x, lengths),
                    rnn.gru_layer(p["bwd"], x, lengths, reverse=True)], dim=-1)
    return ys * mask


def stacked_layer(p, x, lengths):
    """A BiGRU layer through gru_scan.BiGRUScan (K18, K19 on the card):
    mask x, project each direction (the backward one's input flipped into
    its scan order), scan both from zero states, flip direction 1 back,
    concatenate, mask."""
    from seq2seq_attention_asr_tpu_torch.ops import cells
    from seq2seq_attention_asr_tpu_torch.ops.cuda import gru_scan
    from seq2seq_attention_asr_tpu_torch.ops.masking import flip_sequences, length_mask

    mask = length_mask(lengths, x.shape[1], x.dtype)[:, :, None]
    x = x * mask
    h = p["fwd"]["w_zr"].shape[1] // 2
    xproj2 = torch.stack([cells.gru_input_proj(p["fwd"], x),
                          cells.gru_input_proj(p["bwd"], flip_sequences(x, lengths))])
    wzr2 = torch.stack([p["fwd"]["w_zr"][:h], p["bwd"]["w_zr"][:h]])
    wh2 = torch.stack([p["fwd"]["w_h"][:h], p["bwd"]["w_h"][:h]])
    ys = gru_scan.BiGRUScan.apply(xproj2.contiguous(), x.new_zeros((2, x.shape[0], h)), wzr2, wh2)
    return torch.cat([ys[0], flip_sequences(ys[1], lengths)], dim=-1) * mask


def encoder_call(path, enc, x, lengths, cot):
    """A call that runs the encoder layers ENC_LAYERS of `enc` on x by
    `path` (a key of ENC_LAUNCHES) and returns the output and the
    gradients of sum(out * cot) for every encoder weight, then x."""
    from seq2seq_attention_asr_tpu_torch.ops import rnn

    layer = {"bigru_layer": rnn.bigru_layer, "per_direction": per_direction_layer,
             "stacked": stacked_layer}[path]
    params = {n: {d: {k: v.detach().clone().requires_grad_(True) for k, v in enc[n][d].items()}
                  for d in ("fwd", "bwd")} for n in ENC_LAYERS}
    leaves = [v for n in ENC_LAYERS for d in ("fwd", "bwd") for v in params[n][d].values()]
    xin = x.detach().clone().requires_grad_(True)

    def call():
        h = xin
        for n in ENC_LAYERS:
            h = layer(params[n], h, lengths)
        return h.detach(), torch.autograd.grad((h * cot).sum(), leaves + [xin])

    return call


def encoder_phase(kernels, enc_cpu, batch):
    """Phase 7: the flagship encoder (weights `enc_cpu`) on the training
    batch by each path of ENC_LAUNCHES, forward and backward, on the card
    with the launch counts zeroed just before and read just after (every
    kernel not in the path's entry 0), then on the CPU. Each path's card
    output must match bigru_layer's (K1, K6) at valid positions within
    TOL and be exactly 0 at masked ones, its gradients bigru_layer's
    within the backward tolerance, and its own CPU run (the plain
    versions) the same way. Returns the launch counts of each path."""
    from seq2seq_attention_asr_tpu_torch import interop
    from seq2seq_attention_asr_tpu_torch.ops.masking import length_mask

    x, x_len = batch[0], batch[1]
    b, l, _ = x.shape
    width = 2 * enc_cpu["bigru3"]["fwd"]["w_h"].shape[1]
    cot = torch.randn(b, l, width, generator=torch.Generator().manual_seed(SEED + 7))
    runs, counts = {}, {}
    for dev in ("cuda", "cpu"):
        enc = interop.to_torch(enc_cpu, dev)
        for path, expected in ENC_LAUNCHES.items():
            call = encoder_call(path, enc, x.to(dev), x_len.to(dev), cot.to(dev))
            for k in kernels.values():
                k.launches = 0
            out, grads = call()
            if dev == "cuda":
                torch.cuda.synchronize()
                counts[path] = {n: k.launches for n, k in kernels.items()}
                want = dict.fromkeys(kernels, 0)
                want.update(expected)
                print(f"encoder {path} B={b} L={l}: launches of one forward and backward on the "
                      f"card { {n: c for n, c in counts[path].items() if c} }")
                if counts[path] != want:
                    raise SystemExit(f"encoder {path}: launch counts {counts[path]}, "
                                     f"expected {want}")
            runs[(dev, path)] = (out.cpu(), [g.cpu() for g in grads])
    valid = length_mask(x_len, l)[:, :, None].expand(-1, -1, width).bool()
    ref_out, ref_grads = runs[("cuda", "bigru_layer")]
    for path in ENC_LAUNCHES:
        out, grads = runs[("cuda", path)]
        cpu_out, cpu_grads = runs[("cpu", path)]
        finite = bool(torch.isfinite(out).all()) and all(bool(torch.isfinite(g).all())
                                                         for g in grads)
        vs_k1 = float((out - ref_out)[valid].abs().max())
        masked = float(out[~valid].abs().max())
        g_vs_k1 = bwd_err(grads, ref_grads)
        vs_cpu, g_vs_cpu = max_err([out], [cpu_out]), bwd_err(grads, cpu_grads)
        print(f"encoder {path} B={b} L={l}: output vs bigru_layer (K1, K6) at valid positions "
              f"{vs_k1:.3e} (tol {TOL}), max |output| at masked positions {masked:.3e} (must be "
              f"0), "
              f"gradients vs bigru_layer's excess {g_vs_k1:.3e} (tol 5e-5 over 5e-4 * max); vs its "
              f"CPU run: output {vs_cpu:.3e} (tol {TOL}), gradients excess {g_vs_cpu:.3e}; "
              f"finite={finite}")
        if not (finite and vs_k1 <= TOL and masked == 0 and g_vs_k1 <= 5e-5 and vs_cpu <= TOL
                and g_vs_cpu <= 5e-5):
            raise SystemExit(f"encoder {path}: disagrees with bigru_layer or with its CPU run")
    return counts


def encoder_timing(enc_cpu, b: int, card: str) -> None:
    """Phase 9 for the encoder: each path's forward and backward at batch
    b on a training batch: its device time (every device op of a call,
    from the profiler), its time per call (CUDA events), and one traced
    call's device time by kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    from seq2seq_attention_asr_tpu_torch import interop

    x, x_len = (t.cuda() for t in train_batch(b, SEED + 5)[:2])
    enc = interop.to_torch(enc_cpu, "cuda")
    width = 2 * enc["bigru3"]["fwd"]["w_h"].shape[1]
    cot = torch.randn(b, TRAIN_L, width, generator=torch.Generator().manual_seed(SEED + 8)).cuda()
    for path in ENC_LAUNCHES:
        call = encoder_call(path, enc, x, x_len, cot)
        call_ms = time_ms(call, 5)
        dev_ms = device_ms(call, None, 5)
        with traced([ProfilerActivity.CUDA]) as prof:
            call()
        groups = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                key = next((s for s in ENC_KERNELS if s in e.name), "other device ops")
                n, ms = groups.get(key, (0, 0.0))
                groups[key] = (n + 1, ms + e.time_range.elapsed_us() / 1e3)
        print(f"encoder {path} B={b} L={TRAIN_L}: forward and backward {dev_ms:.4f} ms on the "
              f"device, {call_ms:.4f} ms per call; one traced call by kernel: " + ", ".join(
                  f"{key} {ms:.4f} ms in {n} ({ms / n:.4f} ms each)"
                  for key, (n, ms) in sorted(groups.items(), key=lambda kv: -kv[1][1]))
              + f" ({card})")


def walk_split(c, kernel, tag, iters: int, card: str) -> None:
    """Phase 8 for a redesigned backward (a key of WALKS): its device time
    by stage (gate pre-pass, walk, reduction), the walk's time per step,
    and the plan it ran."""
    from seq2seq_attention_asr_tpu_torch.ops.cuda import walk

    walk_sym, gates_sym, cell = WALKS[c.name]
    with torch.no_grad():
        parts = device_parts(lambda: c.kernel(*c.args), c.symbols, iters)
    x = c.args[0]
    lead = x.dim() - 3  # 1 for the direction-stacked inputs of K19 and K9
    b, l, h = x.shape[lead], x.shape[lead + 1], x.shape[-1] // walk.WIDTH[cell]
    directions = 1 if c.name == "gru_scan_bwd" else 2
    smem, clusters = walk.limits(kernel, x.device)
    plan = walk.plan(b, h, cell, directions, smem, clusters)
    print(f"time {c.label} {tag} by stage: pre-pass {parts[gates_sym]:.4f} ms, walk "
          f"{parts[walk_sym]:.4f} ms ({1e3 * parts[walk_sym] / l:.2f} us a step over {l} steps), "
          f"reduction {parts['atb_kernel']:.4f} ms; plan C={plan.cluster} R={plan.rows} "
          f"{'resident' if plan.resident else 'streamed'}, {directions * -(-b // plan.rows)} "
          f"clusters ({clusters} resident at once, {smem} bytes of shared memory a block) ({card})")


def _stage_times(c, order, iters: int):
    """Device ms of the stages of one call of `c` over `iters` traced calls:
    `order` lists (the trace symbol, its stage) of the kernels one call
    launches, in launch order; a stage's records are told apart by their
    order in the call. Returns ({stage: mean ms}, {stage: records kept})."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    symbols = {sym for sym, _ in order}
    with torch.no_grad():
        c.kernel(*c.args)
        torch.cuda.synchronize()
        with traced([ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                c.kernel(*c.args)
    events = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA
                     and any(sym in e.name for sym in symbols)),
                    key=lambda e: e.time_range.start)
    stages, at = {stage: [] for _, stage in order}, -1
    for e in events:
        # The next position in the call whose symbol this record holds: a
        # record the trace dropped at its ends leaves the order intact.
        at = next(k for k in range(at + 1, at + 1 + len(order))
                  if order[k % len(order)][0] in e.name) % len(order)
        stages[order[at][1]].append(e.time_range.elapsed_us() / 1e3)
    n_of = {stage: sum(1 for _, s in order if s == stage) for stage in stages}
    ms = {k: n_of[k] * statistics.mean(v) if v else float("nan") for k, v in stages.items()}
    return ms, {k: len(v) for k, v in stages.items()}


def walk_case_dims(c):
    """(B, L, S, A, St, FM, F) of a case of WALK_BWDS (K5, K11, K13 or K15)."""
    vh, h, yin = c.args[0], c.args[1], c.args[3]
    b, l, s_dim = vh.shape
    fm, f = 0, 0
    if c.name == "attention_decode_scan_loc_lstm_bwd":
        f, fm = c.args[14].shape  # after vh, h, mask, yin, the 7 step and 3 cell weights
    elif c.name == "attention_decode_scan_loc_bwd":
        f, fm = c.args[13].shape  # after vh, h, mask, yin, the 7 step and 2 cell weights
    return b, l, s_dim, h.shape[2], yin.shape[2], fm, f


def decoder_walk_split(c, kernel, tag: str, iters: int, card: str) -> None:
    """Phase 8 for K5, K11, K13 and K15 (`c`, a case of WALK_BWDS): the device
    time by stage over `iters` traced calls (the recompute pre-pass, the
    walk, the reduction over the steps, the one over the walk's partials),
    the walk's time a step, the plan it ran and the scratch the call
    takes."""
    from seq2seq_attention_asr_tpu_torch.ops.cuda import attention_scan

    walk_sym, prepass = WALK_BWDS[c.name]
    ms, kept = _stage_times(c, tuple((sym, "pre-pass") for sym in prepass) + (
        (walk_sym, "walk"), ("atb_kernel", "steps"), ("atb_kernel", "partials")), iters)
    b, l, s_dim, a, st, fm, f = walk_case_dims(c)
    t_len = c.args[3].shape[1]
    cell = attention_scan.WALK_CELL[kernel.symbol]
    plan = attention_scan.scan_plan_on(kernel, b, l, s_dim, a, st, fm, f, c.args[0].device)
    smem, resident = attention_scan.scan_limits(kernel, c.args[0].device)
    floats = attention_scan.stash_floats(cell == "lstm", b, t_len, l, s_dim, st, fm, f,
                                         plan.partials(b))
    print(f"time {c.label} {tag} by stage: pre-pass {ms['pre-pass']:.4f} ms, walk "
          f"{ms['walk']:.4f} ms ({1e3 * ms['walk'] / t_len:.2f} us a step over {t_len} steps), "
          f"the steps' reduction {ms['steps']:.4f} ms, the partials' {ms['partials']:.4f} ms "
          f"(records kept: {', '.join(f'{k} {n}' for k, n in kept.items())} of {iters} calls); "
          f"plan C={plan.cluster} R={plan.rows}, {-(-b // plan.rows)} clusters in {plan.waves} "
          f"waves ({resident} resident at once, "
          f"{attention_scan.walk_smem_bytes(cell, plan.rows, plan.cluster, l, s_dim, a, st, fm, f)}"
          f" of {smem} bytes of shared memory a block); scratch {floats} floats "
          f"({4 * floats / 1e6:.1f} MB) ({card})")


def plan_sweep(c, kernel, tag: str, card: str, walk_sym: str, attr: str, runs, plan, describe,
               check, iters: int = 10) -> None:
    """Phase 8: the walk of case `c` (of `kernel`) under each plan of
    `runs`, each set in place of attention_scan.<attr> and held to the
    plain version (`check`
    of the kernel's and the plain outputs, True where within tolerance)
    and run twice with the same bits: the walk's (trace symbol `walk_sym`)
    device time, its time a step, and a step and wave; `plan` is the
    wrapper's own, `describe` names a plan. One profiler trace holds
    `iters` calls of every plan in turn, the walk's records told apart by
    their launch order; a trace that lost one of them is taken again, at
    most twice."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    from seq2seq_attention_asr_tpu_torch.ops.cuda import attention_scan

    b, t_len = c.args[0].shape[0], c.args[3].shape[1]
    _, resident = attention_scan.scan_limits(kernel, c.args[0].device)
    with torch.no_grad():
        want = c.plain(*c.args)
    call = lambda: c.kernel(*c.args)
    default = getattr(attention_scan, attr)
    try:
        for run in runs:
            setattr(attention_scan, attr, lambda *_, run=run: run)
            with torch.no_grad():
                got, again = call(), call()
            torch.cuda.synchronize()
            if not check(got, want) or not all(torch.equal(x, y) for x, y in zip(got, again)):
                raise SystemExit(f"{c.label} {tag} with {run}: disagrees with its plain "
                                 f"version ({max_err(got, want):.3e}) or between two calls")
        for attempt in range(3):
            with torch.no_grad(), traced([ProfilerActivity.CUDA]) as prof:
                for run in runs:
                    setattr(attention_scan, attr, lambda *_, run=run: run)
                    for _ in range(iters):
                        call()
            durs = [e.time_range.elapsed_us() / 1e3 for e in sorted(
                (e for e in prof.events()
                 if e.device_type == DeviceType.CUDA and walk_sym in e.name),
                key=lambda e: e.time_range.start)]
            if len(durs) == iters * len(runs):
                break
            print(f"sweep {c.label} {tag}: trace {attempt + 1} kept {len(durs)} of "
                  f"{iters * len(runs)} walk launches")
        else:
            raise SystemExit(f"sweep {c.label} {tag}: every trace lost walk launches")
    finally:
        setattr(attention_scan, attr, default)
    line = []
    for i, run in enumerate(runs):
        ms = statistics.mean(durs[i * iters:(i + 1) * iters])
        waves = -(-(-(-b // run.rows)) // resident[run.cluster])
        line.append(f"{describe(run)} {ms:.4f} ms, {1e3 * ms / t_len:.2f} us a step in {waves} "
                    f"waves ({1e3 * ms / t_len / waves:.2f} a wave)")
    print(f"time {c.label} walk by plan {tag} (parity and repeat hold at each; the plan takes "
          f"{describe(plan)}): " + "; ".join(line) + f" ({card})")


def decoder_walk_sweep(c, kernel, tag: str, card: str) -> None:
    """Phase 8: K5, K11, K13 or K15 (`c`) under each (C, R) the walk can take
    that fits the device (plan_sweep, the backward tolerance).
    attention_scan.STEP_COST is read from these times."""
    from seq2seq_attention_asr_tpu_torch.ops.cuda import attention_scan

    b, l, s_dim, a, st, fm, f = walk_case_dims(c)
    cell = attention_scan.WALK_CELL[kernel.symbol]
    smem, resident = attention_scan.scan_limits(kernel, c.args[0].device)
    plan = attention_scan.scan_plan_on(kernel, b, l, s_dim, a, st, fm, f, c.args[0].device)
    runs = [attention_scan.ScanPlan(cluster, rows) for cluster in attention_scan.WALK_CLUSTERS
            for rows in attention_scan.WALK_ROWS
            if resident[cluster] >= 1 and attention_scan.walk_smem_bytes(
                cell, rows, cluster, l, s_dim, a, st, fm, f) <= smem]
    plan_sweep(c, kernel, tag, card, WALK_BWDS[c.name][0], "scan_plan_on", runs, plan,
               lambda run: f"C={run.cluster} R={run.rows}",
               lambda got, want: bwd_err(got, want) <= 5e-5)


def fwd_case_dims(c):
    """(B, L, S, A, St, FM, F) of a case of FWD_SCANS (K10, K14, K12 or K4)."""
    vh, h, yin = c.args[0], c.args[1], c.args[3]
    b, l, s_dim = vh.shape
    fm, f = 0, 0
    if c.name == "attention_decode_scan_loc_lstm_fwd":
        f, fm = c.args[14].shape  # after vh, h, mask, yin, the 7 step and 3 cell weights
    elif c.name == "attention_decode_scan_loc_fwd":
        f, fm = c.args[13].shape  # after vh, h, mask, yin, the 7 step and 2 cell weights
    return b, l, s_dim, h.shape[2], yin.shape[2], fm, f


def fwd_walk_split(c, kernel, tag: str, iters: int, card: str) -> None:
    """Phase 8 for K10, K14, K12 and K4 (`c`, a case of FWD_SCANS): the
    device time by stage over `iters` traced calls (the pre-pass, the
    walk), the walk's time a step, the plan it ran and the scratch the
    call takes."""
    from seq2seq_attention_asr_tpu_torch.ops.cuda import attention_scan

    walk_sym, prepass = FWD_SCANS[c.name]
    ms, kept = _stage_times(c, tuple((sym, "pre-pass") for sym in prepass)
                            + ((walk_sym, "walk"),), iters)
    b, l, s_dim, a, st, fm, f = fwd_case_dims(c)
    t_len = c.args[3].shape[1]
    cell = attention_scan.FWD_CELL[kernel.symbol]
    plan = attention_scan.fwd_plan_on(kernel, b, l, s_dim, a, st, fm, f, c.args[0].device)
    smem, resident = attention_scan.scan_limits(kernel, c.args[0].device)
    floats = attention_scan.fwd_scratch_floats(b, t_len, a, st, cell)
    block_bytes = attention_scan.fwd_smem_bytes(plan.rows, plan.cluster, l, s_dim, a, st, fm, f,
                                                plan.resident, cell)
    print(f"time {c.label} {tag} by stage: pre-pass {ms['pre-pass']:.4f} ms, walk "
          f"{ms['walk']:.4f} ms ({1e3 * ms['walk'] / t_len:.2f} us a step over {t_len} steps) "
          f"(records kept: {', '.join(f'{k} {n}' for k, n in kept.items())} of {iters} calls); "
          f"plan C={plan.cluster} R={plan.rows} W_cx "
          f"{'resident' if plan.resident else 'streamed'}, {-(-b // plan.rows)} clusters in "
          f"{plan.waves} waves ({resident} resident at once, "
          f"{block_bytes} of {smem} bytes of shared memory a block); scratch {floats} floats "
          f"({4 * floats / 1e6:.1f} MB) ({card})")


def fwd_walk_sweep(c, kernel, tag: str, card: str) -> None:
    """Phase 8: K10, K14, K12 or K4 (`c`) under each plan that fits the
    device (fwd_plans; plan_sweep, 1e-4 abs). attention_scan.FWD_STEP_COST
    is read from these times (the resident layout where it fits)."""
    from seq2seq_attention_asr_tpu_torch.ops.cuda import attention_scan

    b, l, s_dim, a, st, fm, f = fwd_case_dims(c)
    plan = attention_scan.fwd_plan_on(kernel, b, l, s_dim, a, st, fm, f, c.args[0].device)
    plan_sweep(c, kernel, tag, card, FWD_SCANS[c.name][0], "fwd_plan_on",
               fwd_plans(kernel, b, l, s_dim, a, st, fm, f), plan,
               lambda run: f"C={run.cluster} R={run.rows} W_cx "
                           f"{'resident' if run.resident else 'streamed'}",
               lambda got, want: max_err(got, want) <= TOL)


def k6_plan_sweep(kernel, b: int, card: str) -> None:
    """Phase 8: K6's walk at B=b, L=TRAIN_L, H=256 under each row count of
    ops/cuda/walk.py (weights resident), on seeded random inputs: the
    walk's device time, its time per step, and the waves its clusters take
    on this card. walk.STEP_ROWS is read from these times."""
    from seq2seq_attention_asr_tpu_torch.ops.cuda import build, gru_scan, walk

    h, l, dev = 256, TRAIN_L, torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 9)
    rnd = lambda *s, scale=1.0: (torch.randn(*s, generator=gen) * scale).to(dev)
    xf, xb = rnd(b, l, 3 * h), rnd(b, l, 3 * h)
    wzr2, wh2 = rnd(2, h, 2 * h, scale=h ** -0.5), rnd(2, h, h, scale=h ** -0.5)
    with torch.no_grad():
        ysf, ysb = gru_scan.bigru_scan2_plain(xf, xb, wzr2, wh2)
        ins = (xf, xb, wzr2, wh2, ysf, ysb, rnd(b, l, h), rnd(b, l, h))
        want = gru_scan.bigru_scan2_bwd_plain(*ins)
    outs = (torch.empty_like(xf), torch.empty_like(xb), torch.empty_like(wzr2),
            torch.empty_like(wh2), torch.empty(2, b, l, h, device=dev))
    smem, clusters = walk.limits(kernel, dev)
    line = []
    for rows in walk.ROWS:
        plan = walk.Plan(8, rows, True)
        call = lambda: kernel.launch(*[build.ptr(t) for t in ins + outs], b, l, h, *plan.args(),
                                     build.stream_of(xf))
        call()
        torch.cuda.synchronize()
        excess = bwd_err(outs[:4], want)
        if excess > 5e-5:
            raise SystemExit(f"K6 with {plan}: disagrees with its plain version ({excess:.3e})")
        ms = device_parts(call, ("bigru_scan2_bwd_kernel",), 10)["bigru_scan2_bwd_kernel"]
        waves = -(-2 * -(-b // rows) // clusters)
        line.append(f"R={rows} {ms:.4f} ms, {1e3 * ms / l:.2f} us a step in {waves} waves "
                    f"({1e3 * ms / l / waves:.2f} a wave)")
    print(f"time K6 walk by rows per cluster B={b} L={l} H={h} (C=8, resident, {clusters} "
          f"clusters at once; the plan takes R={walk.plan(b, h, 'gru', 2, smem, clusters).rows}): "
          + "; ".join(line) + f" ({card})")


def fwd_walk_calls(b: int, l: int):
    """K1, K16 and K18 at batch b and L steps, H = FWD_WALK_H, on seeded
    random inputs (weights at 1/sqrt(H), K16/K18 from 0.5 randn initial
    states): {name: (args, wrapper, plain version)}."""
    from seq2seq_attention_asr_tpu_torch.ops.cuda import gru_scan

    h, dev = FWD_WALK_H, torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 10 + b)
    rnd = lambda *s, scale=1.0: (torch.randn(*s, generator=gen) * scale).to(dev)
    x2, h02 = rnd(2, b, l, 3 * h), rnd(2, b, h, scale=0.5)
    wzr2, wh2 = rnd(2, h, 2 * h, scale=h ** -0.5), rnd(2, h, h, scale=h ** -0.5)
    return {"bigru_scan2": ((x2[0], x2[1], wzr2, wh2), gru_scan.bigru_scan2,
                            gru_scan.bigru_scan2_plain),
            "gru_scan": ((x2[0], h02[0], wzr2[0], wh2[0]), gru_scan.gru_scan,
                         gru_scan.gru_scan_plain),
            "bigru_scan": ((x2, h02, wzr2, wh2), gru_scan.bigru_scan, gru_scan.bigru_scan_plain)}


def lstm_walk_call(b: int, l: int):
    """K7 at batch b and L steps, H = LSTM_WALK_H, on seeded random inputs
    (weights at 1/sqrt(H), 0.5 randn initial states): (args, wrapper,
    plain version)."""
    from seq2seq_attention_asr_tpu_torch.ops.cuda import lstm_scan

    h, dev = LSTM_WALK_H, torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 20 + b)
    rnd = lambda *s, scale=1.0: (torch.randn(*s, generator=gen) * scale).to(dev)
    args = (rnd(2, b, l, 4 * h), rnd(2, b, h, scale=0.5), rnd(2, b, h, scale=0.5),
            rnd(2, h, 4 * h, scale=h ** -0.5))
    return args, lstm_scan.bilstm_scan, lstm_scan.bilstm_scan_plain


def fwd_walk_cases():
    """(name, B, L, H, args, wrapper, plain version) of each forward walk
    of FWD_WALKS at each of its shapes: the GRU's at FWD_WALK_SHAPES, K7's
    at LSTM_WALK_SHAPES."""
    for b, l in FWD_WALK_SHAPES:
        for name, (args, fn, plain) in fwd_walk_calls(b, l).items():
            yield name, b, l, FWD_WALK_H, args, fn, plain
    for b, l in LSTM_WALK_SHAPES:
        yield ("bilstm_scan", b, l, LSTM_WALK_H, *lstm_walk_call(b, l))


def rows_sweep(kernel, label: str, symbol: str, cell: str, b: int, l: int, h: int, args, plain,
               card: str) -> None:
    """A forward walk's kernel (inputs `args`, two outputs) at B=b, L=l
    under each row count of ops/cuda/walk.py (C=8, weights resident),
    each held to the plain version: the device time, the time a step, and
    a step and wave. walk.STEP_COST[cell] is read from these times."""
    from seq2seq_attention_asr_tpu_torch.ops.cuda import build, walk

    with torch.no_grad():
        want = plain(*args)
    outs = [torch.empty_like(w) for w in want]
    smem, clusters = walk.limits(kernel, args[0].device)
    line = []
    for rows in walk.ROWS:
        plan = walk.Plan(8, rows, True)
        call = lambda: kernel.launch(*[build.ptr(t) for t in (*args, *outs)], b, l, h,
                                     *plan.args(), build.stream_of(args[0]))
        call()
        torch.cuda.synchronize()
        err = max_err(outs, want)
        if err > TOL:
            raise SystemExit(f"{label} with {plan}: disagrees with its plain version ({err:.3e})")
        ms = device_ms(call, (symbol,), 10)
        waves = -(-2 * -(-b // rows) // clusters)
        line.append(f"R={rows} {ms:.4f} ms, {1e3 * ms / l:.2f} us a step in {waves} "
                    f"waves ({1e3 * ms / l / waves:.2f} a wave)")
    print(f"time {label} walk by rows per cluster B={b} L={l} H={h} (C=8, resident, {clusters} "
          f"clusters at once; the plan takes R={walk.plan(b, h, cell, 2, smem, clusters).rows}): "
          + "; ".join(line) + f" ({card})")


def fwd_walk_timing(kernels, errs: dict, card: str) -> None:
    """Phase 8 for the forward walks: K1, K16 and K18 at each of
    FWD_WALK_SHAPES and K7 at each of LSTM_WALK_SHAPES, held to their plain
    versions (1e-4 abs, into `errs`), with the device time, the walk's
    time a step and the plan each ran (C, R, resident or streamed, its
    clusters and the waves they take on this card); then K1 at B=16 and
    128 and K7 at each of its shapes under each row count of
    ops/cuda/walk.py (rows_sweep), each held to the plain version."""
    from seq2seq_attention_asr_tpu_torch.ops.cuda import walk

    k7_s = 0.0
    for name, b, l, h, args, fn, plain in fwd_walk_cases():
        t0 = time.perf_counter()
        symbol, directions, cell = FWD_WALKS[name]
        with torch.no_grad():
            got, want = fn(*args), plain(*args)
            torch.cuda.synchronize()
            got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
            err = max_err(got, want)
            print(f"parity {name} B={b} L={l} H={h} (random inputs): max_abs_err={err:.3e} "
                  f"(tol {TOL})")
            if err > TOL or not all(bool(torch.isfinite(g).all()) for g in got):
                raise SystemExit(f"{name} B={b} L={l} disagrees with its plain version")
            errs[name] = max(errs[name], err)
            ms = device_ms(lambda: fn(*args), (symbol,), 20 if b < BIG_B else 10)
        smem, clusters = walk.limits(kernels[name], args[0].device)
        plan = walk.plan(b, h, cell, directions, smem, clusters)
        n = directions * -(-b // plan.rows)
        print(f"time {name} walk B={b} L={l} H={h}: {ms:.4f} ms on the device, "
              f"{1e3 * ms / l:.2f} us a step; plan C={plan.cluster} R={plan.rows} "
              f"{'resident' if plan.resident else 'streamed'}, {n} clusters in "
              f"{-(-n // clusters)} waves ({clusters} resident at once, {smem} bytes of shared "
              f"memory a block) ({card})")
        if name == "bilstm_scan":
            rows_sweep(kernels[name], "K7", symbol, cell, b, l, h, args, plain, card)
            k7_s += time.perf_counter() - t0
    print(f"K7's walk lines took {k7_s:.1f} s")
    for b in (TRAIN_B, BIG_B):
        args, _, plain = fwd_walk_calls(b, TRAIN_L)["bigru_scan2"]
        rows_sweep(kernels["bigru_scan2"], "K1", "bigru_scan2_kernel", "gru_fwd", b, TRAIN_L,
                   FWD_WALK_H, args, plain, card)


def flagship_loc():
    """The flagship recipe with location-aware attention: 16 feature maps,
    the recipe's filter of 10, column-norm on."""
    from seq2seq_attention_asr_tpu_torch.train import experiment

    exp = experiment.timit_chorowski_normnll_colnorm()
    exp.model_kwargs["feature_maps"] = 16
    return exp


def conv_bilstm_content():
    """The conv+BiLSTM recipe without the location term."""
    from seq2seq_attention_asr_tpu_torch.train import experiment

    exp = experiment.timit_conv_bilstm()
    exp.model_kwargs["feature_maps"] = 0
    return exp


def make_trainer(recipe, params_cpu, device: str):
    """The train state and step of `recipe` (an experiment) on `device`,
    from the CPU weights `params_cpu`."""
    from seq2seq_attention_asr_tpu_torch import interop
    from seq2seq_attention_asr_tpu_torch.train import optim, trainer

    exp = recipe()
    model = exp.build_model()
    tx = optim.build_optimizer(exp.optim)
    init_fn, step_fn = trainer.make_train_step(model.forward, tx, exp.optim, exp.train,
                                               model.output_depth)
    return init_fn(interop.to_torch(params_cpu, device), torch.Generator().manual_seed(SEED)), step_fn


def train_phase(kernels, recipe, params_cpu, expected, label: str):
    """Phase 6 for one recipe: 3 steps on the card and on the CPU, the
    launch counts of each card step (`expected`, every other kernel 0),
    then 30 more card steps. Returns the launch counts of the first card
    step."""
    batch = train_batch(TRAIN_B, SEED + 3)
    runs, first_counts = {}, None
    want = dict.fromkeys(kernels, 0)
    want.update(expected)
    for dev in ("cuda", "cpu"):
        state, step_fn = make_trainer(recipe, params_cpu, dev)
        t0 = time.perf_counter()
        b = tuple(t.to(dev) for t in batch)
        runs[dev] = []
        for i in range(3):
            for k in kernels.values():
                k.launches = 0
            state, m = step_fn(state, b)
            if dev == "cuda":
                torch.cuda.synchronize()
                counts = {n: k.launches for n, k in kernels.items()}
                print(f"train {label} step {i + 1} on the card: launches {counts}")
                if counts != want:
                    raise SystemExit(f"train {label} step: launch counts {counts}, expected {want}")
                first_counts = first_counts or counts
            runs[dev].append({k: float(v) for k, v in m.items()})
        print(f"train {label}: 3 steps on {dev} took {time.perf_counter() - t0:.1f} s wall")
        if dev == "cuda":
            card_state, card_step, card_batch = state, step_fn, b
    for i, (got, ref) in enumerate(zip(runs["cuda"], runs["cpu"])):
        rel = {k: abs(got[k] - ref[k]) / abs(ref[k])
               for k in ("loss", "nll", "grad_norm", "param_norm")}
        print(f"train {label} step {i + 1}: card {got}, CPU {ref}, relative differences "
              f"{ {k: f'{v:.2e}' for k, v in rel.items()} } (tol {TRAIN_RTOL})")
        if not all(np.isfinite(v) for v in got.values()) or max(rel.values()) > TRAIN_RTOL:
            raise SystemExit(f"train {label} step {i + 1}: the card disagrees with the CPU run")
    losses = [r["loss"] for r in runs["cuda"]]
    for _ in range(MORE_STEPS):
        card_state, m = card_step(card_state, card_batch)
        losses.append(float(m["loss"]))
    print(f"train {label}: loss over {len(losses)} card steps on one batch: first "
          f"{losses[0]:.6f}, last {losses[-1]:.6f}, every fifth "
          f"{[round(v, 6) for v in losses[::5]]}")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise SystemExit(f"train {label}: the loss did not fall")
    return first_counts


# Phase 6's long flagship_loc step: two utterances of up to 2,048 frames
# (66 s), past the L = 1,018 that K13's one-block body took.
LONG_B, LONG_L = 2, 2048


def loc_long_step(kernels, params_cpu) -> None:
    """Phase 6: one flagship_loc train step at B = LONG_B, L = LONG_L (the
    second row 300 frames shorter, labels of TRAIN_T and 40), on the card
    with LOC_STEP_LAUNCHES' launches and no other kernel, and on the CPU:
    loss, nll, grad_norm and param_norm within TRAIN_RTOL."""
    rng = np.random.RandomState(SEED + 27)
    x = rng.randn(LONG_B, LONG_L, 123).astype(np.float32)
    x_len = np.array([LONG_L, LONG_L - 300])
    y = rng.randint(0, 62, (LONG_B, TRAIN_T))
    dec_mask = (np.arange(TRAIN_T)[None] < np.array([TRAIN_T, 40])[:, None]).astype(np.float32)
    batch = tuple(torch.from_numpy(a) for a in (x, x_len, y, dec_mask))
    want = dict.fromkeys(kernels, 0)
    want.update(LOC_STEP_LAUNCHES)
    runs = {}
    for dev in ("cuda", "cpu"):
        state, step_fn = make_trainer(flagship_loc, params_cpu, dev)
        b = tuple(t.to(dev) for t in batch)
        t0 = time.perf_counter()
        (_, m), counts = counted(kernels, lambda: step_fn(state, b))
        runs[dev] = {k: float(v) for k, v in m.items()}
        print(f"train flagship_loc step B={LONG_B} L={LONG_L} T={TRAIN_T} on {dev}: {runs[dev]}, "
              f"{time.perf_counter() - t0:.1f} s wall" + (f"; launches {counts}" if dev == "cuda"
                                                          else ""))
        if dev == "cuda" and counts != want:
            raise SystemExit(f"train flagship_loc step L={LONG_L}: launch counts {counts}, "
                             f"expected {want}")
    rel = {k: abs(runs["cuda"][k] - runs["cpu"][k]) / abs(runs["cpu"][k])
           for k in ("loss", "nll", "grad_norm", "param_norm")}
    print(f"train flagship_loc step B={LONG_B} L={LONG_L}: relative differences card vs CPU "
          f"{ {k: f'{v:.2e}' for k, v in rel.items()} } (tol {TRAIN_RTOL})")
    if not all(np.isfinite(v) for v in runs["cuda"].values()) or max(rel.values()) > TRAIN_RTOL:
        raise SystemExit(f"train flagship_loc step L={LONG_L}: the card disagrees with the CPU")


def timed_steps(recipe, params_cpu, b: int):
    """10 card train steps of `recipe` at batch b after 3 warm-up steps:
    (their host times in ms, the state, the step function, the batch)."""
    state, step_fn = make_trainer(recipe, params_cpu, "cuda")
    batch = tuple(t.cuda() for t in train_batch(b, SEED + 5))
    lat, state = step_latencies(step_fn, state, batch)
    return lat, state, step_fn, batch


def step_latencies(step_fn, state, batch, n: int = 10):
    """The host times in ms of n card train steps after 3 warm-up steps,
    each ending in a synchronize; (the times, the state after them)."""
    for _ in range(3):
        state, _ = step_fn(state, batch)
    torch.cuda.synchronize()
    lat = []
    for _ in range(n):
        t0 = time.perf_counter()
        state, _ = step_fn(state, batch)
        torch.cuda.synchronize()
        lat.append(1e3 * (time.perf_counter() - t0))
    return lat, state


def train_timing(recipe, params_cpu, b: int, card: str, step_kernels, label: str) -> None:
    """Phase 9 for training: p50 of 10 steps after 3 warm-up steps, audio
    seconds per second, the device time of one profiled step (device
    activity only) by kernel (`step_kernels`, by trace name) and the idle
    share 1 - device / p50."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    torch.cuda.reset_peak_memory_stats()
    lat, state, step_fn, batch = timed_steps(recipe, params_cpu, b)
    with traced([ProfilerActivity.CUDA]) as prof:
        state, _ = step_fn(state, batch)
    p50 = statistics.median(lat)
    dev_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in dev_events) / 1e3
    idle = f"{1 - busy / p50:.4f}" if dev_events else "not measured"
    audio_s = b * TRAIN_L * HOP / SR
    print(f"train {label} step B={b} L={TRAIN_L} T={TRAIN_T}: p50 {p50:.2f} ms (min {min(lat):.2f}, "
          f"max {max(lat):.2f}) over 10 steps; {audio_s / (p50 / 1e3):.1f} audio s/s "
          f"({audio_s:.3f} s of audio per step); device busy {busy:.2f} ms in {len(dev_events)} "
          f"device ops of one profiled step, idle share 1 - busy/p50 = {idle}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 20:.0f} MiB ({card})")
    # The step's device time by kernel; atb_kernel is the weight-gradient
    # reduction of the backward kernels (K5 two launches and K6 three; K9
    # one and K11 two; K13 two and K6 three; K9 one and K15 two).
    groups = {}
    for e in dev_events:
        key = next((s for s in step_kernels if s in e.name), "other device ops")
        n, ms = groups.get(key, (0, 0.0))
        groups[key] = (n + 1, ms + e.time_range.elapsed_us() / 1e3)
    print(f"train {label} step B={b}: device time by kernel: " + ", ".join(
        f"{key} {ms:.2f} ms in {n} ({ms / busy:.1%})"
        for key, (n, ms) in sorted(groups.items(), key=lambda kv: -kv[1][1])))
    # Each reduction in launch order: the decoder's backward comes first
    # (its reduction over the steps, then, with the location term, the
    # one over the (step, position) pairs), then the encoder's.
    atb = sorted((e for e in dev_events if "atb_kernel" in e.name),
                 key=lambda e: e.time_range.start)
    print(f"train {label} step B={b}: atb_kernel launches in order: "
          + ", ".join(f"{e.time_range.elapsed_us() / 1e3:.3f}" for e in atb) + " ms")
    # One more step traced on the host too: the CUDA runtime calls it
    # makes, by name; a call that waits for the device shows here.
    with traced([ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state, _ = step_fn(state, batch)
    calls = {}
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.name.startswith("cuda"):
            n, ms = calls.get(e.name, (0, 0.0))
            calls[e.name] = (n + 1, ms + e.time_range.elapsed_us() / 1e3)
    print(f"train {label} step B={b}: host CUDA runtime calls of one step traced on the host: "
          + ", ".join(f"{name} {n}x {ms:.2f} ms" for name, (n, ms) in
                      sorted(calls.items(), key=lambda kv: -kv[1][1])[:6]))


def serve_requests(label, model, weights, requests, pcms, kw, kernels, launches, max_steps):
    """Phases 4 and 5 for one model: each request (weights name, exact,
    b) on the card with the launch counts zeroed just before it, then on
    the CPU; tokens equal, scores within SCORE_TOL, and the counts equal
    to launches(exact, beam steps of the CPU run) (every other kernel 0).
    A request on weights other than "random" must finish at least one
    best hypothesis on eos. Returns the counts of the first request and
    the beam steps of each eos request."""
    from seq2seq_attention_asr_tpu_torch import interop, serve

    first, eos_steps = None, []
    for name, exact, b in requests:
        tr = serve.Transcriber(model, weights[name], exact=exact, pad_frames=PAD_FRAMES, **kw)
        for k in kernels.values():
            k.launches = 0
        with torch.no_grad():
            out = tr.transcribe(pcms[:b])
        torch.cuda.synchronize()
        counts = {n: k.launches for n, k in kernels.items()}
        tag = f"serve {label} {name} exact={exact} b={b}"
        print(f"{tag}: launches {counts}, tokens {[len(r.ids) for r in out]}, "
              f"scores {[round(r.score, 3) for r in out]}")
        if not all(np.isfinite(r.score) and r.ids.ndim == 1 and
                   (r.ids.size == 0 or 0 <= r.ids.min() and r.ids.max() < model.output_depth)
                   for r in out):
            raise SystemExit(f"{tag}: malformed transcription")
        first = first or counts
        ref = serve.Transcriber(model, interop.to_torch(weights[name], "cpu"), exact=exact,
                                pad_frames=PAD_FRAMES, device="cpu", **kw)
        ref_out, steps = cpu_transcribe(ref, pcms[:b])
        same = all(np.array_equal(r.ids, q.ids) for r, q in zip(out, ref_out))
        dscore = max(abs(r.score - q.score) for r, q in zip(out, ref_out))
        print(f"{tag}: tokens equal to the CPU run: {same}, max score diff {dscore:.3e} "
              f"(tol {SCORE_TOL}), beam steps on the CPU {steps}")
        if not same or not dscore <= SCORE_TOL:
            raise SystemExit(f"{tag}: the card disagrees with the CPU run")
        want = dict.fromkeys(kernels, 0)
        want.update(launches(exact, steps))
        if counts != want:
            raise SystemExit(f"{tag}: launch counts {counts}, expected {want}")
        if name != "random":
            on_eos = sum(len(r.ids) < max_steps for r in out)
            print(f"{tag}: {on_eos} of {b} best hypotheses finished on eos, the beam took "
                  f"{steps} of {max_steps + 1} steps")
            if not on_eos:
                raise SystemExit(f"{tag}: no hypothesis finished on eos")
            eos_steps.append(steps)
    return first, eos_steps


def with_eos_bias(params, bias):
    """A copy of `params` whose readout favours eos by `bias`."""
    out = copy.deepcopy(params)
    out["decoder"]["readout"][-1]["b"][EOS_ID] += bias
    return out


def pick_eos_bias(model, params_cpu, pcms, kw, max_steps):
    """The first of CB_EOS_BIASES with which a batch-8 exact=False
    request on the CPU finishes at least one best hypothesis on eos."""
    from seq2seq_attention_asr_tpu_torch import serve

    for bias in CB_EOS_BIASES:
        tr = serve.Transcriber(model, with_eos_bias(params_cpu, bias), exact=False,
                               pad_frames=PAD_FRAMES, device="cpu", **kw)
        out, _ = cpu_transcribe(tr, pcms[:8])
        if any(len(r.ids) < max_steps for r in out):
            return bias
    raise SystemExit(f"serve conv_bilstm: no eos bias in {CB_EOS_BIASES} ends a hypothesis on eos")


def serve_timing(label, model, params, pcms, kw, runs, card) -> dict:
    """Phase 9 for serving: p50 of 10 requests after one warm-up and the
    device idle share, 1 - (device time of one profiled request) / p50.
    Returns {(exact, b): (p50 ms, device ms of one request)}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    from seq2seq_attention_asr_tpu_torch import serve

    out = {}
    for exact, b in runs:
        tr = serve.Transcriber(model, params, exact=exact, pad_frames=PAD_FRAMES, **kw)
        lat = []
        with torch.no_grad():
            tr.transcribe(pcms[:b])
            for _ in range(10):
                t0 = time.perf_counter()
                tr.transcribe(pcms[:b])
                lat.append(1e3 * (time.perf_counter() - t0))
            with traced([ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                tr.transcribe(pcms[:b])
                wall = 1e3 * (time.perf_counter() - t0)
        p50 = statistics.median(lat)
        dev_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        busy = sum(e.time_range.elapsed_us() for e in dev_events) / 1e3
        idle = f"{1 - busy / p50:.4f}" if dev_events else "not measured"
        print(f"serve {label} exact={exact} b={b}: p50 {p50:.2f} ms (min {min(lat):.2f}, max "
              f"{max(lat):.2f}) over 10 sequential requests of {PCM_SECONDS} s PCM; device "
              f"busy {busy:.2f} ms in {len(dev_events)} device ops of one profiled request "
              f"({wall:.2f} ms wall under the profiler), idle share 1 - busy/p50 = {idle} "
              f"({card})")
        out[(exact, b)] = (p50, busy)
    return out


_HELD_OUT_SPLITS = {}


def held_out_split(device: str):
    """The corpus and its held-out split as the trainer sees them: (train,
    valid, batcher, vocab), built once a run (phases 10 and 11 share it)."""
    from seq2seq_attention_asr_tpu_torch.data import batching, synthetic

    if device not in _HELD_OUT_SPLITS:
        h = HELD_OUT
        train, valid, vocab = synthetic.timit_shaped(h["n_train"], h["n_valid"],
                                                     noise=h["noise"], seed=h["seed"])
        base = batching.BucketedBatcher.from_dataset(train, h["batch"], n_buckets=h["buckets"])
        _HELD_OUT_SPLITS[device] = (train, valid, batching.CachedDeviceBatcher(
            base, seed=h["seed"], device=device), vocab)
    return _HELD_OUT_SPLITS[device]


def counted(kernels, fn):
    """fn() with every launch count zeroed just before it; (its result, the
    counts just after it)."""
    for k in kernels.values():
        k.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {n: k.launches for n, k in kernels.items()}


def check_counts(tag: str, counts: dict, launched, exact=None) -> None:
    """Every kernel in `launched` ran (`exact`: {name: count} pins some),
    every other kernel did not."""
    bad = [n for n, c in counts.items() if (c > 0) != (n in launched)]
    bad += [n for n, c in (exact or {}).items() if counts[n] != c]
    if bad:
        raise SystemExit(f"{tag}: launch counts {counts}, wrong for {bad}")


def held_out_phase(kernels, card: str):
    """Phase 10 (i): the committed checkpoint's held-out beam PER on the
    card, through Trainer.evaluate, within HELD_OUT_PER_TOL of the port's
    CPU value; the evaluation's wall time and (a second, profiled run) its
    device time. Returns the model, its parameters on the card and the split."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    from seq2seq_attention_asr_tpu_torch.models import registry
    from seq2seq_attention_asr_tpu_torch.train import checkpoint, experiment, optim, trainer

    t0 = time.perf_counter()
    _, valid, batcher, vocab = held_out_split("cuda")
    params = checkpoint.load_params_npz(str(HELD_OUT_NPZ), "cuda")
    print(f"held-out: {len(valid)} utterances staged on the card, params.npz "
          f"({HELD_OUT_NPZ.stat().st_size} bytes) loaded, {time.perf_counter() - t0:.1f} s wall")
    kw = dict(experiment.timit_chorowski_normnll_colnorm().model_kwargs, dropout=0.5)
    tcfg = trainer.TrainConfig(batch_size=HELD_OUT["batch"], normalize_nll=True, beam_k=BEAM_K,
                               seed=HELD_OUT["seed"])
    model = registry.build("chorowski", **kw)
    tr = trainer.Trainer(model, optim.OptimConfig(), tcfg, vocab=vocab, device="cuda")
    tr.init(params)
    t0 = time.perf_counter()
    row, counts = counted(kernels, lambda: tr.evaluate(valid, batcher))
    wall = time.perf_counter() - t0
    per = row["valid_per"]
    print(f"held-out beam PER on the card {per!r} (the port on the CPU {HELD_OUT_PER_CPU!r}, "
          f"tol {HELD_OUT_PER_TOL}; TPU run 0.1049), valid_nll {row['valid_nll']:.6f}, "
          f"valid_accuracy {row['valid_accuracy']:.6f}; launches {counts}")
    check_counts("held-out evaluate", counts,
                 ("bigru_scan2", "attention_decode_scan_fwd", "fused_attention_step"))
    if not abs(per - HELD_OUT_PER_CPU) <= HELD_OUT_PER_TOL:
        raise SystemExit(f"held-out PER {per} on the card, {HELD_OUT_PER_CPU} on the CPU")
    with traced([ProfilerActivity.CUDA]) as prof:
        again = tr.evaluate(valid, batcher)["valid_per"]
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in events) / 1e3
    print(f"time held-out evaluate ({len(valid)} utterances, {HELD_OUT['batch']} a batch, "
          f"K={BEAM_K}): {1e3 * wall:.1f} ms wall; device busy {busy:.1f} ms in "
          f"{len(events)} device ops (a second, profiled run, PER {again!r}), idle share "
          f"{1 - busy / (1e3 * wall):.4f} ({card})")
    if again != per:
        raise SystemExit(f"held-out: a second evaluation gave PER {again}, the first {per}")
    return model, params, valid, batcher


def fit_phase(kernels, card: str) -> None:
    """Phase 10 (ii): Trainer.fit of the flagship recipe at full width on a
    small TIMIT-shaped corpus with a scratch save_dir: the loss finite and
    falling, valid_per logged, ckpt_latest and log.jsonl written, and a
    second Trainer resuming for a third epoch from the first's state."""
    import tempfile

    from seq2seq_attention_asr_tpu_torch import tree
    from seq2seq_attention_asr_tpu_torch.data import batching, synthetic
    from seq2seq_attention_asr_tpu_torch.train import checkpoint, experiment, trainer

    f = FIT
    train, valid, vocab = synthetic.timit_shaped(f["n_train"], f["n_valid"], seed=SEED)
    exp = experiment.timit_chorowski_normnll_colnorm()
    tcfg = dataclasses.replace(exp.train, num_epochs=f["epochs"], batch_size=f["batch"])
    params = exp.init_params(torch.Generator().manual_seed(SEED), device="cuda")
    batcher = batching.CachedDeviceBatcher(
        batching.BucketedBatcher.from_dataset(train, f["batch"], n_buckets=3), seed=SEED,
        device="cuda")
    with tempfile.TemporaryDirectory() as save_dir:
        tr = trainer.Trainer(exp.build_model(), exp.optim, tcfg, vocab=vocab, save_dir=save_dir,
                             device="cuda")
        tr.init(params)
        t0 = time.perf_counter()
        rows, counts = counted(kernels, lambda: list(tr.fit(train, valid, batcher)))
        for r in rows:
            print(f"fit epoch {r['epoch']}: " + ", ".join(
                f"{k} {r[k]:.6f}" for k in ("train_loss", "train_accuracy", "grad_norm",
                                            "valid_nll", "valid_accuracy", "valid_per")))
        print(f"fit: {f['epochs']} epochs of {f['n_train']} utterances at batch {f['batch']} "
              f"with evaluation, {time.perf_counter() - t0:.1f} s wall; launches {counts}")
        check_counts("fit", counts, FIT_KERNELS)
        losses = [r["train_loss"] for r in rows]
        if not (len(rows) == f["epochs"] and np.isfinite(losses).all()
                and losses[-1] < losses[0] and all("valid_per" in r for r in rows)):
            raise SystemExit(f"fit: rows {rows}")
        files = sorted(os.listdir(save_dir))
        print(f"fit: {save_dir} holds {files}")
        if not {"ckpt_latest", "log.jsonl", "ckpt_best_valid_PER"} <= set(files) or \
                len(trainer.MetricLog.load(os.path.join(save_dir, "log.jsonl"))) != f["epochs"]:
            raise SystemExit("fit: the checkpoint or the log is missing")
        saved = checkpoint.load(os.path.join(save_dir, "ckpt_latest"), device="cuda")
        tr2 = trainer.Trainer(exp.build_model(), exp.optim,
                              dataclasses.replace(tcfg, num_epochs=f["epochs"] + 1),
                              vocab=vocab, save_dir=save_dir, device="cuda")
        tr2.init(exp.init_params(torch.Generator().manual_seed(SEED + 1), device="cuda"))
        if not tr2.resume() or tr2.epoch != f["epochs"] or tr2.best != saved["best"] or not all(
                torch.equal(a, b) for a, b in zip(tree.leaves(list(tr2.state[:2])),
                                                  tree.leaves(list(saved["state"][:2])))):
            raise SystemExit("fit: the resumed Trainer differs from the checkpoint")
        rows2, counts = counted(kernels, lambda: list(tr2.fit(train, valid, batcher,
                                                              resume=True)))
        print(f"fit resumed: epochs {[r['epoch'] for r in rows2]}, train_loss "
              f"{rows2[0]['train_loss']:.6f}; launches {counts}")
        check_counts("fit resumed", counts, FIT_KERNELS)
        if [r["epoch"] for r in rows2] != [f["epochs"] + 1]:
            raise SystemExit("fit: the resumed Trainer did not run exactly one more epoch")


def greedy_phase(kernels, held_out, cb_model, cb_params, cb_feats) -> None:
    """Phase 10 (iii): greedy decode (K=1) on the card against its plain
    version (the same call on the CPU): the flagship decoder through K2 on
    the checkpoint's encoding of the first held-out batch, the conv+BiLSTM
    decoder through K8 on its recipe's encoding of the serving PCM, with
    seeded weights and with the eos bias raised by GREEDY_EOS_BIAS; equal
    tokens and lengths, one launch a step, and rows ending on eos in all
    but the seeded conv+BiLSTM run."""
    from seq2seq_attention_asr_tpu_torch import interop
    from seq2seq_attention_asr_tpu_torch.decode import greedy

    model, params, valid, batcher = held_out
    b = next(batcher.batches(valid))
    with torch.no_grad():
        h, h_len = model.encode(params, b.x, b.x_len)
    runs = [("chorowski", "K2", "fused_attention_step", model, params["decoder"], h, h_len,
             b.y[torch.arange(len(b.y_len)), torch.from_numpy(b.y_len - 1).long().cuda()])]
    lens = torch.full((cb_feats.shape[0],), cb_feats.shape[1], dtype=torch.long, device="cuda")
    cb_weights = {"random": cb_params, f"eos+{GREEDY_EOS_BIAS}": with_eos_bias(cb_params,
                                                                             GREEDY_EOS_BIAS)}
    for name, weights in cb_weights.items():
        with torch.no_grad():
            ch, ch_len = cb_model.encode(weights, cb_feats, lens)
        runs.append((f"conv_bilstm {name}", "K8", "fused_attention_step_loc_lstm", cb_model,
                     weights["decoder"], ch, ch_len, EOS_ID))
    for label, kname, kernel, m, dec, enc, enc_len, eos in runs:
        res, counts = counted(kernels, lambda: greedy.greedy_decode(
            dec, m.attention_cfg, enc, enc_len, eos, max_steps=enc_len,
            max_steps_cap=enc.shape[1], device="cuda"))
        ref = greedy.greedy_decode(interop.to_torch(dec, "cpu"), m.attention_cfg, enc.cpu(),
                                   enc_len.cpu(), eos.cpu() if torch.is_tensor(eos) else eos,
                                   max_steps=enc_len.cpu(), max_steps_cap=enc.shape[1],
                                   device="cpu")
        steps = int(ref.lengths.max())
        same = torch.equal(res.tokens.cpu(), ref.tokens) and torch.equal(res.lengths.cpu(),
                                                                         ref.lengths)
        on_eos = int((ref.lengths < enc_len.cpu()).sum())
        gap = float((res.logprob.cpu() - ref.logprob).abs().max())
        print(f"greedy {label} B={enc.shape[0]} L={enc.shape[1]} ({kname}, K=1): tokens and "
              f"lengths equal to the plain version: {same}, {steps} steps, {on_eos} rows ended "
              f"on eos, max logprob gap {gap:.3e}; launches {counts}")
        check_counts(f"greedy {label}", counts, (kernel,), {kernel: steps})
        if not same:
            raise SystemExit(f"greedy {label}: the card disagrees with the plain version")
        if not on_eos and label != "conv_bilstm random":
            raise SystemExit(f"greedy {label}: no row ended on eos")


def trainer_phase(kernels, cb_model, cb_params, cb_feats, card: str) -> float:
    """Phase 10: the held-out PER, Trainer.fit with resume, greedy decode.
    Returns its wall seconds."""
    t0 = time.perf_counter()
    held_out = held_out_phase(kernels, card)
    fit_phase(kernels, card)
    greedy_phase(kernels, held_out, cb_model, cb_params, cb_feats)
    took = time.perf_counter() - t0
    print(f"trainer phase: {took:.1f} s wall ({card})")
    return took


# Phase 11's limits: gate (b)'s "not collapsed", and gate (c)'s lambda.
# The TPU run's first AWN epoch had train_nll 0.1839, awn_sigma_rms
# 0.01000005 and param_norm 81.96, and a PER of 0.1049 at epoch 5; a
# collapsed run sits at train_nll ~4.13 and PER ~0.96
# (runs/timit_shape_ckpt/awn/log.jsonl). The TPU run trained on the
# features the checkpoint had memorized (DeviceSynth draws, an eval-mode
# NLL of 0.077 a step on the first three batches); the card trains on
# the host-built draws of the same utterances (0.68: test_torch_quality.py
# ::test_train_split_by_staging), so its train_nll is held below half the
# collapsed plateau, not near the TPU's.
AWN_NOT_COLLAPSED = dict(train_nll=2.0, sigma_rms=(0.0099, 0.0101), param_norm=81.96,
                         param_norm_rtol=0.05, valid_per=0.2)
PENALTY_LAMBDA = 0.5


def awn_trainer(vocab, save_dir):
    """The committed AWN stage's Trainer on the card: the dropout recipe
    (adadelta, normalized NLL, column norm 1 on mu) with noise="awn" at
    the stage's sigma0, lambda and seed, batch 32, one epoch."""
    from seq2seq_attention_asr_tpu_torch.train import experiment, trainer

    exp = experiment.timit_chorowski_dropout()
    tcfg = dataclasses.replace(exp.train, num_epochs=1, batch_size=HELD_OUT["batch"],
                               beam_k=BEAM_K, seed=AWN_SEED, noise="awn",
                               awn_lambda=AWN_LAMBDA, awn_sigma_init=AWN_SIGMA0)
    return trainer.Trainer(exp.build_model(), exp.optim, tcfg, vocab=vocab, save_dir=save_dir,
                           device="cuda")


def step_p50(step_fn, state, batch):
    """p50 of 10 card steps after 3 warm-up steps, then the device time of
    one profiled step; (p50 ms, device ms, device ops)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    lat, state = step_latencies(step_fn, state, batch)
    with traced([ProfilerActivity.CUDA]) as prof:
        step_fn(state, batch)
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return statistics.median(lat), sum(e.time_range.elapsed_us() for e in events) / 1e3, len(events)


def step_nll(model, params, batcher, ds) -> float:
    """The eval-mode NLL a step of `params` on every batch of `ds`, averaged
    over utterances (the train_nll of normalize_nll)."""
    from seq2seq_attention_asr_tpu_torch.train import trainer

    per_utt = []
    with torch.no_grad():
        for b in batcher.batches(ds):
            dm = b.dec_mask
            oh = trainer._one_hot_labels(b.y, dm, model.output_depth)
            lp = model.forward(params, b.x, b.x_len, oh, dm)["logprobs"]
            per_utt.append(torch.sum(-torch.sum(oh * lp, dim=-1) * dm, dim=-1) / dm.sum(-1))
    return float(torch.cat(per_utt).mean())


def awn_stage_phase(kernels, card: str) -> None:
    """Phase 11 (a) and (b): the committed AWN stage restarted from
    params.npz, its lambda * KL at the start, one epoch with its held-out
    PER at mu, checkpoint and resume on the card, and the step's time."""
    import tempfile

    from seq2seq_attention_asr_tpu_torch import tree
    from seq2seq_attention_asr_tpu_torch.train import awn, checkpoint, trainer

    train, valid, batcher, vocab = held_out_split("cuda")
    params = checkpoint.load_params_npz(str(HELD_OUT_NPZ), "cuda")
    with tempfile.TemporaryDirectory() as save_dir:
        tr = awn_trainer(vocab, save_dir)
        tr.init(params)
        lam_kl = AWN_LAMBDA * float(awn.kl(tr.state[0]))
        rel64, reljax = abs(lam_kl / AWN_LAMBDA_KL_F64 - 1), abs(lam_kl / AWN_LAMBDA_KL_JAX - 1)
        print(f"awn (a): lambda * KL at the start on the card {lam_kl!r}; float64 "
              f"{AWN_LAMBDA_KL_F64!r} (relative {rel64:.2e}, tol 1e-5), the JAX package's "
              f"float32 {AWN_LAMBDA_KL_JAX!r} (relative {reljax:.2e}, tol 2e-5); generator on "
              f"{tr.state[2].device}")
        if not (rel64 <= 1e-5 and reljax <= 2e-5) or tr.state[2].device.type != "cuda":
            raise SystemExit("awn (a): lambda * KL or the generator's device is wrong")
        t0 = time.perf_counter()
        start_nll = step_nll(tr.model, params, batcher, train)
        print(f"awn (b): the checkpoint's eval-mode NLL a step on the host-built train split "
              f"{start_nll!r}, {time.perf_counter() - t0:.1f} s wall")
        t0 = time.perf_counter()
        (row,), counts = counted(kernels, lambda: list(tr.fit(train, valid, batcher)))
        g = AWN_NOT_COLLAPSED
        print(f"awn (b): one epoch of {len(train)} utterances at batch {HELD_OUT['batch']} with "
              f"AWN and dropout, {time.perf_counter() - t0:.1f} s wall with the evaluation: "
              f"train_nll {row['train_nll']!r} (TPU run 0.18390472351558626; limit "
              f"{g['train_nll']}), awn_sigma_rms {row['awn_sigma_rms']!r} (TPU 0.01000005379319191; "
              f"{g['sigma_rms']}), param_norm {row['param_norm']!r} (TPU 81.96167755126953; "
              f"within {g['param_norm_rtol']:.0%}), mu's held-out PER {row['valid_per']!r} (limit "
              f"{g['valid_per']}), train_loss {row['train_loss']!r}, grad_norm "
              f"{row['grad_norm']!r}, valid_nll {row['valid_nll']!r}, train_seconds "
              f"{row['train_seconds']:.2f}, valid_seconds {row['valid_seconds']:.2f}; "
              f"launches {counts}")
        check_counts("awn fit", counts, FIT_KERNELS)
        if not (row["train_nll"] < g["train_nll"]
                and g["sigma_rms"][0] <= row["awn_sigma_rms"] <= g["sigma_rms"][1]
                and abs(row["param_norm"] / g["param_norm"] - 1) <= g["param_norm_rtol"]
                and row["valid_per"] < g["valid_per"]):
            raise SystemExit(f"awn (b): the restarted stage collapsed: {row}")
        saved = checkpoint.load(os.path.join(save_dir, "ckpt_latest"), device="cuda")
        tr2 = awn_trainer(vocab, save_dir)
        tr2.init(params)
        same = tr2.resume() and all(torch.equal(a, b) for a, b in zip(
            tree.leaves(list(tr.state[:2])), tree.leaves(list(tr2.state[:2]))))
        gen = tr2.state[2]
        same = same and gen.device.type == "cuda" and torch.equal(
            gen.get_state(), tr.state[2].get_state()) and set(saved["state"][0]) == {"mu", "s"}
        b = max(batcher.batches(train), key=lambda b: b.x.shape[1])
        arrs = tr._batch_arrays(b)
        losses = [float(t.step_fn(t.state, arrs)[1]["loss"]) for t in (tr, tr2)]
        print(f"awn (b): a second Trainer resumed ckpt_latest ((mu, s), the optimizer state and "
              f"the {gen.device} generator bit for bit: {same}); one more step of each on a "
              f"{tuple(arrs[0].shape)} batch: loss {losses[0]!r} and {losses[1]!r}")
        if not same or losses[0] != losses[1]:
            raise SystemExit("awn (b): the resumed AWN trainer differs from the checkpoint")
    plain = trainer.make_step_core(tr.model.forward, tr.tx, tr.ocfg,
                                   dataclasses.replace(tr.tcfg, noise="none"),
                                   tr.model.output_depth)
    mu = awn.mode(tr.state[0])
    runs = {"awn": (tr.step_fn, tr.state),
            "dropout only": (plain, (mu, tr.tx.init(mu), tr.state[2]))}
    for label, (step_fn, state) in runs.items():
        p50, busy, ops = step_p50(step_fn, state, arrs)
        print(f"time awn stage step ({label}) B={arrs[0].shape[0]} L={arrs[0].shape[1]} "
              f"T={arrs[2].shape[1]}: p50 {p50:.2f} ms over 10 steps; device busy {busy:.2f} ms "
              f"in {ops} device ops of one profiled step, idle share 1 - busy/p50 = "
              f"{1 - busy / p50:.4f} ({card})")


def penalty_grads(recipe, params_cpu, lam: float, device: str, batch, active=None):
    """One forward and backward of `recipe` with penalty_lambda `lam` on
    `device`: (the parameter gradients of the mean NLL, the summed
    penalty, the steps' unscaled penalties that decide where the ramp is
    injected). `active`, another run's penalties, takes the place of this
    run's in that decision."""
    from seq2seq_attention_asr_tpu_torch import interop, tree
    from seq2seq_attention_asr_tpu_torch.ops.monotonic import MonotonicAlignmentSeq
    from seq2seq_attention_asr_tpu_torch.train import trainer

    exp = recipe()
    exp.model_kwargs["penalty_lambda"] = lam
    model = exp.build_model()
    leaves = [t.detach().requires_grad_(True)
              for t in tree.leaves(interop.to_torch(params_cpu, device))]
    x, x_len, y, dm = (t.to(device) for t in batch)
    oh = trainer._one_hot_labels(y, dm, model.output_depth)
    decided = []
    apply = MonotonicAlignmentSeq.apply

    def decide(alpha_seq, base_ramp, dec_mask, own):
        decided.append(own)
        return apply(alpha_seq, base_ramp, dec_mask,
                     own if active is None else active.to(own.device))

    MonotonicAlignmentSeq.apply = decide
    try:
        out = model.forward(tree.unflatten(params_cpu, leaves), x, x_len, oh, dm, train=True)
    finally:
        del MonotonicAlignmentSeq.apply  # the inherited torch.autograd.Function.apply again
    nll = torch.sum(-torch.sum(oh * out["logprobs"], dim=-1) * dm) / x.shape[0]
    grads = torch.autograd.grad(nll, leaves)
    return grads, float(out["penalty"].detach().sum()), (decided[0] if decided else None)


def penalty_phase(kernels, recipes) -> None:
    """Phase 11 (c): each trained configuration at B = 16 with the
    penalty on: the kernels' gradients against the CPU's, and against
    the gradients without the penalty. The ramp goes in where a step's
    penalty is > 0, a cliff: at the seeded init most steps' penalties are
    ~1e-4, and the 1e-7 that the kernels' alignments differ by from the
    plain version's tip a few steps over it, each a whole ramp (up to
    lambda * L = 72) in the gradient. So the CPU run injects where the
    card's run did, and the steps that its own penalties would tip are
    counted."""
    batch = train_batch(TRAIN_B, SEED + 3)
    for label, (recipe, params_cpu, expected) in recipes.items():
        (grads, pen, active), counts = counted(kernels, lambda: penalty_grads(
            recipe, params_cpu, PENALTY_LAMBDA, "cuda", batch))
        active = active.detach()
        want, want_pen, own = penalty_grads(recipe, params_cpu, PENALTY_LAMBDA, "cpu", batch,
                                             active=active)
        grads0, _, _ = penalty_grads(recipe, params_cpu, 0.0, "cuda", batch)
        valid = batch[3] > 0
        fired = int((active.cpu() > 0)[valid].sum())
        tipped = int(((active.cpu() > 0) != (own > 0))[valid].sum())
        excess = bwd_err([g.cpu() for g in grads], want)
        delta = max(float((a - b).abs().max()) for a, b in zip(grads, grads0))
        print(f"penalty {label} B={TRAIN_B} L={TRAIN_L} T={TRAIN_T} lambda {PENALTY_LAMBDA}: "
              f"penalty {pen:.6f} on the card, {want_pen:.6f} on the CPU, {fired} steps fire "
              f"({tipped} would not, or would, by the CPU's own penalties); gradients against "
              f"the CPU's: excess over 5e-4 * max|CPU| {excess:.3e} (tol 5e-5); largest change "
              f"from lambda 0 {delta:.3e} (limit > 1e-4); launches {counts}")
        check_counts(f"penalty {label}", counts, tuple(expected), expected)
        if not (fired and excess <= 5e-5 and delta > 1e-4
                and abs(pen - want_pen) <= 1e-4 * abs(want_pen)):
            raise SystemExit(f"penalty {label}: the penalty's gradient is wrong on the card")


def repeat_phase(kernels) -> None:
    """Phase 11 (d): a chorowski_dropout step and a noise="weight" step on
    the card, each twice from one generator state, from its recipe's
    seeded init."""
    from seq2seq_attention_asr_tpu_torch import tree
    from seq2seq_attention_asr_tpu_torch.ops import readout
    from seq2seq_attention_asr_tpu_torch.train import awn, experiment, optim, trainer

    batch = tuple(t.cuda() for t in train_batch(TRAIN_B, SEED + 3))
    draw_fns = {"dropout": (readout, "dropout_keep"), "weight": (awn, "normal_like")}
    for case, tcfg_kw in (("dropout", {}), ("weight", dict(noise="weight",
                                                           weight_noise_sigma=0.01))):
        exp = (experiment.timit_chorowski_dropout() if case == "dropout"
               else experiment.timit_chorowski_normnll_colnorm())
        model = exp.build_model()
        params = exp.init_params(torch.Generator().manual_seed(SEED), device="cuda")
        init_fn, step_fn = trainer.make_train_step(
            model.forward, optim.build_optimizer(exp.optim), exp.optim,
            dataclasses.replace(exp.train, **tcfg_kw), model.output_depth)
        gen_state = torch.Generator(device="cuda").manual_seed(SEED).get_state()
        module, name = draw_fns[case]
        draw, runs = getattr(module, name), []
        for _ in range(2):
            drawn = []
            setattr(module, name, lambda *a: drawn.append(draw(*a)) or drawn[-1])
            try:
                gen = torch.Generator(device="cuda")
                gen.set_state(gen_state)
                (state, m), counts = counted(kernels, lambda: step_fn(init_fn(params, gen), batch))
            finally:
                setattr(module, name, draw)
            runs.append((state, m, tree.leaves(drawn)))
        check_counts(f"{case} step", counts, tuple(STEP_LAUNCHES), STEP_LAUNCHES)
        (s1, m1, d1), (s2, m2, d2) = runs
        same_draws = len(d1) == len(d2) > 0 and all(torch.equal(a, b) for a, b in zip(d1, d2))
        gap = max(float((a - b).abs().max()) for a, b in zip(tree.leaves(s1[0]),
                                                              tree.leaves(s2[0])))
        if case == "dropout":
            stat = float(d1[0].float().mean())
            what = f"mask {tuple(d1[0].shape)} keeps {stat:.6f} (0.5 +- 0.01)"
            stat_ok = abs(stat - 0.5) <= 0.01
        else:
            flat = torch.cat([t.reshape(-1) for t in d1])
            stat = float(flat.std())
            what = f"noise over {flat.numel()} weights: eps std {stat:.6f} (1 +- 0.01)"
            stat_ok = abs(stat - 1.0) <= 0.01
        print(f"{case} step twice from one generator state on the card: the same draws "
              f"{same_draws}, {what}; loss {float(m1['loss'])!r} and {float(m2['loss'])!r}, "
              f"params after the step {gap:.3e} apart; launches {counts}")
        if not (same_draws and stat_ok and float(m1["loss"]) == float(m2["loss"]) and gap <= 1e-6):
            raise SystemExit(f"{case} step: two steps from one generator state differ")


def regulariser_phase(kernels, penalty_recipes, card: str) -> float:
    """Phase 11: the AWN stage, the penalty, dropout and weight noise.
    Returns its wall seconds."""
    t0 = time.perf_counter()
    awn_stage_phase(kernels, card)
    penalty_phase(kernels, penalty_recipes)
    repeat_phase(kernels)
    took = time.perf_counter() - t0
    print(f"regulariser phase: {took:.1f} s wall ({card})")
    return took


# Phase 12: the bf16 operating point (compute_dtype="bfloat16") of the
# flagship's evaluation path: K1, K4 and K2 through their bf16 entries.
# Each is held to its exact plain twin (the entry's own rounding points
# in plain PyTorch: bigru_scan2_plain, gru_folded_scan_plain,
# fused_attention_step_plain), element by element, within BF16_ULPS bf16
# ulps at max(|twin|, 1), and on fewer elements than the float32 result
# rounded at its outputs (BF16_ROUNDED_SHARE); and by the ground-truth
# rule: each output's relative L2 distance from the float32 plain
# version's on the same bf16-valued inputs, upcast, at most 2 x the plain
# bf16 version's at the JAX kernel's rounding points + 0.02 (the rule the
# CPU tests hold the plain versions to against the JAX package). The
# held-out PER of the committed checkpoint as a bf16 model: the port's on
# the CPU (tests/test_torch_bf16.py -m slow; the JAX package's XLA path
# there gives 0.10548065162836319).
HELD_OUT_PER_CPU_BF16 = 0.10682398127180333
HELD_OUT_PER_BF16_TOL = 0.005  # card vs CPU, bf16
HELD_OUT_PER_BF16_F32_TOL = 0.01  # bf16 vs the float32 PER (HELD_OUT_PER_CPU)
# Each bf16 entry's kernel by name, and the float32 kernel it is an
# instance of (its source, the TPU kernel it replaces, why no library call).
BF16_OF = {"bigru_scan2_bf16": "bigru_scan2", "attention_decode_scan_fwd_bf16":
           "attention_decode_scan_fwd", "fused_attention_step_bf16": "fused_attention_step"}
# Their device kernels by trace name (K2's bf16 instance is the template
# attention_step_kernel<ArgsT<bf16>>: timed alone, it is its only launch).
BF16_SYMBOLS = {"bigru_scan2_bf16": ("bigru_scan2_bf16_kernel",),
                "attention_decode_scan_fwd_bf16": ("gru_fwd_prepass_bf16_kernel",) * 2
                + ("content_gru_fwd_bf16_kernel",),
                "fused_attention_step_bf16": ("attention_step_kernel",)}
F32_SYMBOLS = {"bigru_scan2_bf16": ("bigru_scan2_kernel",),
               "attention_decode_scan_fwd_bf16": GRU_FWD_PREPASS + ("content_gru_fwd_kernel",),
               "fused_attention_step_bf16": ("attention_step_kernel",)}
# Phase 12 (b)'s entries (BF16_MODEL_OF): K7's, K10's, K12's, K14's and K8's (K8's
# bf16 instances are the template cluster_step_loc_lstm_kernel<..., bf16>).
BF16_SYMBOLS.update({
    "bilstm_scan_bf16": ("bilstm_scan_bf16_kernel",),
    "attention_decode_scan_loc_lstm_fwd_bf16": ("lstm_fwd_prepass_bf16_kernel",) * 2
    + ("loc_lstm_fwd_bf16_kernel",),
    "attention_decode_scan_loc_fwd_bf16": ("gru_fwd_prepass_bf16_kernel",) * 2
    + ("loc_gru_fwd_bf16_kernel",),
    "attention_decode_scan_lstm_fwd_bf16": ("lstm_fwd_prepass_bf16_kernel",) * 2
    + ("scan_lstm_fwd_bf16_kernel",),
    "fused_attention_step_loc_lstm_bf16": K8_SYMBOLS})
F32_SYMBOLS.update({
    "bilstm_scan_bf16": ("bilstm_scan_kernel",),
    "attention_decode_scan_loc_lstm_fwd_bf16": FWD_PREPASS + ("loc_lstm_fwd_kernel",),
    "attention_decode_scan_loc_fwd_bf16": GRU_FWD_PREPASS + ("loc_gru_fwd_kernel",),
    "attention_decode_scan_lstm_fwd_bf16": FWD_PREPASS + ("scan_lstm_fwd_kernel",),
    "fused_attention_step_loc_lstm_bf16": K8_SYMBOLS})
BF16_ODD_L = 131  # the edge shapes: one batch row, an odd encoder length
# Kernel vs exact twin, each element, in bf16 ulps at max(|twin|, 1). The
# kernels sum in another order than the twins, which flips a rounding now
# and then; K4's recurrence carries a flipped operand over its 56-64 steps
# (at most 0.5, 2.4 and 18.5 ulps on the card for K1, K2 and K4, and a K4
# twin that skips the operand roundings lands 59-65 ulps from its own on
# the CPU; PERF.md §6).
BF16_ULPS = {"bigru_scan2_bf16": 2, "attention_decode_scan_fwd_bf16": 32,
             "fused_attention_step_bf16": 4,
             # K7's bf16 entry stores float32 and rounds nothing: the float32
             # kernels' TOL (1e-4 at 1.0), in bf16 ulps. K10's, K12's and K14's
             # carry their flips over the steps as K4's do; K8 is one step, as K2.
             "bilstm_scan_bf16": TOL / 2 ** -7, "attention_decode_scan_loc_lstm_fwd_bf16": 32,
             "attention_decode_scan_loc_fwd_bf16": 32, "attention_decode_scan_lstm_fwd_bf16": 32,
             "fused_attention_step_loc_lstm_bf16": 4}
# The rounding check: a kernel that skipped the bf16 rounding points would
# be the float32 result rounded at its outputs, and would differ from the
# twin on as many elements as that does; the kernel must differ on at most
# this share of them, on each output where that result differs on at
# least BF16_ROUNDED_MIN of the elements (K2's alpha and c come before
# its first rounding point, on bf16 inputs).
BF16_ROUNDED_SHARE = 0.75
BF16_ROUNDED_MIN = 0.01
# The decoder backwards of phase 12 (d) carry float noise through 56 steps
# of an LSTM or through the location term's long sums: the same rounded
# function evaluated in float64 lands as far from the float32 twin as
# skipping the rounding points does on some outputs (on the CPU, at B=16:
# 94% of dbconv's elements either way, 8.5% against 16.8% of dvh's). The
# rounding check can tell the two apart only where the float32 result
# rounded at the output differs from the twin on at least this many times
# the share the float64 twin does; it is made on those outputs, and at
# least one output of each case must be one.
BF16_NOISE_FACTOR = 2.0
# Phase 12 (c): bf16 training of the flagship and of VGG through the bf16
# entries of K6 and K5 (BF16_TRAIN_OF), with K1's and K4's (K4's writing
# the float32 alpha and c the backward reads). The two entries are held to
# their exact twins (K6's: bigru_scan2_bwd_plain_bf16, which rounds where
# the entry rounds; K5's: attention_decode_scan_bwd_twin_bf16, the plain
# bf16 version with the softmax's sum formed as the entry forms it) within
# BF16_ULPS, and to the plain bf16 versions at the JAX kernels' rounding
# points by the ground-truth rule, at B = 16 and 128, L = 144, T = 56.
# Their BF16_ULPS are K4's (32): each walks a recurrence whose carry takes
# an operand that another summation order may round the other way, over
# 144 (K6) or 56 (K5) steps, as K4's forward does over 56.
BF16_TRAIN_OF = {"bigru_scan2_bwd_bf16": "bigru_scan2_bwd",
                 "attention_decode_scan_bwd_bf16": "attention_decode_scan_bwd"}
BF16_SYMBOLS.update({
    "bigru_scan2_bwd_bf16": ("bigru_scan2_bwd_bf16_kernel",) + GRU_GATES + ("atb_kernel",),
    "attention_decode_scan_bwd_bf16": ("content_gru_walk_bf16_kernel",)
    + ("gru_decoder_prepass_bf16_kernel",) * 4 + ("atb_kernel",) * 2
    + ("round_to_bf16_kernel",) * 2})
F32_SYMBOLS.update({
    "bigru_scan2_bwd_bf16": ("bigru_scan2_bwd_kernel",) + GRU_GATES + ("atb_kernel",),
    "attention_decode_scan_bwd_bf16": ("content_gru_walk_kernel",) + GRU_PREPASS
    + ("atb_kernel",) * 2})
BF16_ULPS.update({"bigru_scan2_bwd_bf16": 32, "attention_decode_scan_bwd_bf16": 32})
# Phase 16 (a): the bf16 entries of K16-K19 (BF16_GRU_OF), K1's and K6's
# walks in their one-direction and direction-stacked forms: the forwards
# at K1's ulps, the backwards at K6's.
BF16_GRU_OF = {"gru_scan_bf16": "gru_scan", "gru_scan_bwd_bf16": "gru_scan_bwd",
               "bigru_scan_bf16": "bigru_scan", "bigru_scan_bwd_bf16": "bigru_scan_bwd"}
BF16_ULPS.update({"gru_scan_bf16": 2, "bigru_scan_bf16": 2, "gru_scan_bwd_bf16": 32,
                  "bigru_scan_bwd_bf16": 32})
# The bf16 flagship train step's launches: the bf16 entries of K1, K6, K4
# and K5, nothing else; VGG's: K4's and K5's.
BF16_STEP_LAUNCHES = {"bigru_scan2_bf16": 3, "bigru_scan2_bwd_bf16": 3,
                      "attention_decode_scan_fwd_bf16": 1, "attention_decode_scan_bwd_bf16": 1}
BF16_VGG_LAUNCHES = {"attention_decode_scan_fwd_bf16": 1, "attention_decode_scan_bwd_bf16": 1}
BF16_STEP_KERNELS = ("bigru_scan2_bwd_bf16_kernel", "gru_gates_kernel", "bigru_scan2_bf16_kernel",
                     "gru_fwd_prepass_bf16_kernel", "content_gru_fwd_bf16_kernel",
                     "gru_decoder_prepass_bf16_kernel", "content_gru_walk_bf16_kernel",
                     "round_to_bf16_kernel", "atb_kernel")
BF16_STEP_RTOL = 1e-3  # the card's bf16 step's loss against the CPU's on the same batch
BF16_FIT_PER_TOL = 0.01  # the bf16 epoch's held-out PER against the float32 epoch's
BF16_FIT_SEED = 3
# Phase 12 (d): bf16 training of conv_bilstm, conv_bilstm_content and
# flagship_loc through the bf16 entries of K9, K11, K15 and K13 (with K7's,
# K10's, K14's, K12's, K1's and K6's; the forwards writing the float32
# alpha and c the backwards read). Each is held to its exact twin (K9's:
# bilstm_scan_bwd_plain on the widened inputs, which rounds nothing, as
# the JAX kernel; K11's, K15's and K13's: the plain bf16 versions with the
# softmax's sum formed as the entries form it) within BF16_ULPS, and to the
# plain bf16 version by the ground-truth rule: K9, K11 and K15 at B = 16
# and 128, 144 frames (L' = 16), T = 56; K13 at B = 16 and 128, L = 144,
# T = 56.
BF16_OTHER_TRAIN_OF = {
    "bilstm_scan_bwd_bf16": "bilstm_scan_bwd",
    "attention_decode_scan_loc_lstm_bwd_bf16": "attention_decode_scan_loc_lstm_bwd",
    "attention_decode_scan_lstm_bwd_bf16": "attention_decode_scan_lstm_bwd",
    "attention_decode_scan_loc_bwd_bf16": "attention_decode_scan_loc_bwd"}
_ATB_ROUND = ("atb_kernel",) * 2 + ("round_to_bf16_kernel",) * 2
BF16_SYMBOLS.update({
    "bilstm_scan_bwd_bf16": ("bilstm_scan_bwd_bf16_kernel", "lstm_gates_bf16_kernel",
                             "atb_kernel"),
    "attention_decode_scan_loc_lstm_bwd_bf16": ("lstm_decoder_prepass_bf16_kernel",) * 3
    + ("loc_lstm_bwd_bf16_kernel",) + _ATB_ROUND,
    "attention_decode_scan_lstm_bwd_bf16": ("lstm_decoder_prepass_bf16_kernel",) * 3
    + ("scan_lstm_bwd_bf16_kernel",) + _ATB_ROUND,
    "attention_decode_scan_loc_bwd_bf16": ("gru_decoder_prepass_bf16_kernel",) * 4
    + ("loc_gru_bwd_bf16_kernel",) + _ATB_ROUND})
F32_SYMBOLS.update({
    "bilstm_scan_bwd_bf16": ("bilstm_scan_bwd_kernel", "lstm_gates_kernel", "atb_kernel"),
    "attention_decode_scan_loc_lstm_bwd_bf16": PREPASS + ("loc_lstm_bwd_kernel",)
    + ("atb_kernel",) * 2,
    "attention_decode_scan_lstm_bwd_bf16": PREPASS + ("scan_lstm_bwd_kernel",)
    + ("atb_kernel",) * 2,
    "attention_decode_scan_loc_bwd_bf16": GRU_PREPASS + ("loc_gru_bwd_kernel",)
    + ("atb_kernel",) * 2})
# K9's bf16 entry stores float32 and rounds nothing: the float32
# backwards' 5e-4 of the output's scale (bwd_err), in bf16 ulps. The
# decoder backwards carry their flips over the 56 steps as K5's do.
BF16_ULPS.update({"bilstm_scan_bwd_bf16": 5e-4 / 2 ** -7,
                  "attention_decode_scan_loc_lstm_bwd_bf16": 32,
                  "attention_decode_scan_lstm_bwd_bf16": 32,
                  "attention_decode_scan_loc_bwd_bf16": 32})
# Each configuration's bf16 train step: its recipe's label, the batch it
# is checked and timed at, its launches (the bf16 entries of its kernels,
# nothing else) and its device kernels by trace name.
BF16_OTHER_STEPS = {
    "conv_bilstm": (BIG_B, {"bilstm_scan_bf16": 1, "bilstm_scan_bwd_bf16": 1,
                            "attention_decode_scan_loc_lstm_fwd_bf16": 1,
                            "attention_decode_scan_loc_lstm_bwd_bf16": 1},
                    ("bilstm_scan_bwd_bf16_kernel", "lstm_gates_bf16_kernel",
                     "bilstm_scan_bf16_kernel", "loc_lstm_fwd_bf16_kernel",
                     "lstm_fwd_prepass_bf16_kernel", "loc_lstm_bwd_bf16_kernel",
                     "lstm_decoder_prepass_bf16_kernel", "round_to_bf16_kernel", "atb_kernel")),
    "conv_bilstm_content": (TRAIN_B, {"bilstm_scan_bf16": 1, "bilstm_scan_bwd_bf16": 1,
                                      "attention_decode_scan_lstm_fwd_bf16": 1,
                                      "attention_decode_scan_lstm_bwd_bf16": 1},
                            ("bilstm_scan_bwd_bf16_kernel", "lstm_gates_bf16_kernel",
                             "bilstm_scan_bf16_kernel", "scan_lstm_fwd_bf16_kernel",
                             "lstm_fwd_prepass_bf16_kernel", "scan_lstm_bwd_bf16_kernel",
                             "lstm_decoder_prepass_bf16_kernel", "round_to_bf16_kernel",
                             "atb_kernel")),
    "flagship_loc": (TRAIN_B, {"bigru_scan2_bf16": 3, "bigru_scan2_bwd_bf16": 3,
                               "attention_decode_scan_loc_fwd_bf16": 1,
                               "attention_decode_scan_loc_bwd_bf16": 1},
                     ("bigru_scan2_bwd_bf16_kernel", "gru_gates_kernel",
                      "bigru_scan2_bf16_kernel", "gru_fwd_prepass_bf16_kernel",
                      "loc_gru_fwd_bf16_kernel", "gru_decoder_prepass_bf16_kernel",
                      "loc_gru_bwd_bf16_kernel", "round_to_bf16_kernel", "atb_kernel")),
}
# Phase 12 (d)'s short fit: three Trainer.fit epochs of conv_bilstm in bf16
# and in float32 from one seeded init on the synthetic corpus, the same
# batches; each bf16 epoch's mean train NLL within this of the float32
# one's (relative), and both falling.
BF16_FIT_NLL_RTOL = 0.02
BF16_FIT_CORPUS = dict(n_train=128, n_valid=16, n_phones=61, feat_dim=123, min_len=5, max_len=12,
                       frames_per_phone=(8, 12), noise=0.3)


def rel_dist(got, truth) -> float:
    t = truth.float()
    return float((got.float() - t).norm()) / max(float(t.norm()), 1e-6)


def bf16_ulps(got, twin):
    """(the largest distance of an element of `got` from `twin` in bf16 ulps
    at max(|twin|, 1), the share of elements that differ)."""
    g, w = got.float(), twin.float()
    ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp(min=1.0))) - 7)
    d = (g - w).abs()
    return float((d / ulp).max()) if d.numel() else 0.0, float((d != 0).float().mean())


def bf16_check(name, tag, got, twin, plain, truth, noise=None) -> float:
    """The bf16 kernel's outputs `got` against its exact twin's: each
    element within BF16_ULPS[name] ulps, and differing on at most
    BF16_ROUNDED_SHARE of the share of elements on which the float32
    `truth`, rounded to the output's type, differs from the twin (where
    that share is BF16_ROUNDED_MIN or more, and, given `noise`, the twin
    evaluated in float64, BF16_NOISE_FACTOR times the share on which that
    differs from the twin or more; at least one output must then be
    checked); and by the ground-truth rule against the plain bf16
    version's (`plain`, the JAX kernel's rounding points). Exits when one
    fails or an output is not finite. Returns the max abs error against
    the twin."""
    err = max_err([g.float() for g in got], [w.float() for w in twin])
    checked = 0
    for i, (g, w, p, t) in enumerate(zip(got, twin, plain, truth)):
        kd, pd = rel_dist(g, t), rel_dist(p, t)
        ulps, differ = bf16_ulps(g, w)
        _, unrounded = bf16_ulps(t.to(g.dtype), w)
        floor = None if noise is None else bf16_ulps(noise[i].to(g.dtype), w)[1]
        finite = bool(torch.isfinite(g.float()).all())
        print(f"parity {name} {tag} output {i}: {ulps:.3f} ulps from the exact twin at most "
              f"(<= {BF16_ULPS[name]}), {differ:.4f} of the elements differ (the float32 result "
              f"rounded at the output: {unrounded:.4f}"
              + ("" if floor is None else f"; the float64 twin: {floor:.4f}")
              + f"); rel L2 from the f32 truth, kernel "
              f"{kd:.3e}, plain bf16 {pd:.3e} (kernel <= 2 x plain + 0.02), dtype {g.dtype}, "
              f"finite={finite}")
        if not finite or g.dtype != w.dtype or not ulps <= BF16_ULPS[name]:
            raise SystemExit(f"{name} {tag}: the bf16 kernel is not its exact twin")
        if unrounded >= BF16_ROUNDED_MIN and (floor is None
                                              or unrounded >= BF16_NOISE_FACTOR * floor):
            checked += 1
            if not differ <= BF16_ROUNDED_SHARE * unrounded:
                raise SystemExit(f"{name} {tag}: the bf16 kernel differs from its twin about as "
                                 f"often as the float32 result rounded at its output does")
        if not kd <= 2.0 * pd + 0.02:
            raise SystemExit(f"{name} {tag}: the bf16 kernel fails the ground-truth rule")
    if noise is not None and not checked:
        raise SystemExit(f"{name} {tag}: no output on which the rounding check can tell the "
                         f"rounding points from float noise")
    print(f"parity {name} {tag}: max_abs_err={err:.3e} against the exact plain twin"
          + ("" if noise is None else f"; rounding check made on {checked} of {len(got)} outputs"))
    return err


def float64_twin(twin_call, args):
    """A decoder backward's exact twin evaluated in float64 (the same
    rounding points, the arithmetic of another precision), bf16 out: how
    far float noise alone moves the twin's outputs."""
    from seq2seq_attention_asr_tpu_torch.ops.cuda import attention_scan

    io = attention_scan._io

    def io64(vh, h, enc_mask, yin, weights):
        vh, h, enc_mask, yin, *weights = (t.double() for t in (vh, h, enc_mask, yin, *weights))
        return ((vh, h, enc_mask, yin, tuple(weights)), torch.bfloat16,
                lambda x: x.to(torch.bfloat16).double())

    attention_scan._io = io64
    try:
        return twin_call(*args)
    finally:
        attention_scan._io = io


def bf16_cases(p16, cfg, gen, eval_batch):
    """The bf16 entries' inputs, bf16 on the card, from the committed
    checkpoint's weights in bf16 (p16): {name: [(tag, args, flops,
    nbytes, library)]} (library None: no PyTorch call computes theirs), the first of each at the shapes phase 12 times: K1 on the
    first encoder layer and K4 on the encoder's output of a B = 16, L =
    144, T = 56 batch, K2 at B = 16, K = 5 on that output and at b = 1, L
    = 132; then the edges, B = 1 at an odd L; then `eval_batch` (x, x_len,
    y, dec_mask), a held-out evaluation batch (B = 32) as the bf16
    model's evaluation gives it to the three."""
    from seq2seq_attention_asr_tpu_torch.models import chorowski
    from seq2seq_attention_asr_tpu_torch.ops import attention, cells, readout
    from seq2seq_attention_asr_tpu_torch.ops.masking import length_mask

    dev, bf = torch.device("cuda"), torch.bfloat16
    enc, dec = p16["encoder"]["bigru1"], p16["decoder"]
    hd = enc["fwd"]["w_zr"].shape[1] // 2
    wzr2 = torch.stack([enc["fwd"]["w_zr"][:hd], enc["bwd"]["w_zr"][:hd]]).contiguous()
    wh2 = torch.stack([enc["fwd"]["w_h"][:hd], enc["bwd"]["w_h"][:hd]]).contiguous()
    weights = (dec["ws"]["w"], dec["ws"]["b"], dec["w_e"], dec["c_in"]["w"], dec["c_in"]["b"],
               dec["dec_in"]["w"], dec["dec_in"]["b"], dec["cell"]["w_zr"], dec["cell"]["w_h"])
    acfg = cfg.attention_config()
    a, s_dim, st, v = acfg.annotation_depth, acfg.score_depth, acfg.state_depth, acfg.output_depth
    read = list(weights) + [t for layer in dec["readout"] for t in layer.values()]
    mvs = (st * s_dim + a * st + 2 * st * st + 4 * st * st + 2 * st * st
           + dec["readout"][-2]["w"].numel() + cfg.mlp_depth * v)
    w_elems = sum(t.numel() for t in weights)
    out = {name: [] for name in BF16_OF}
    ex = eval_batch[0]
    for tag, batch in ((f"B={TRAIN_B} L={TRAIN_L} T={TRAIN_T}", train_batch(TRAIN_B, SEED + 5)),
                       (f"B=1 L={BF16_ODD_L} T=23", train_batch(1, SEED + 6)),
                       (f"held-out B={ex.shape[0]} L={ex.shape[1]} T={eval_batch[2].shape[1]}",
                        eval_batch)):
        x, x_len, y, dec_mask = (t.to(dev) for t in batch)
        if x.shape[0] == 1:  # the edge: an odd length, 23 labels
            x, x_len, y, dec_mask = x[:, :BF16_ODD_L], x_len.clamp(max=BF16_ODD_L), y[:, :23], \
                dec_mask[:, :23]
        b, l = x.shape[:2]
        t_len = y.shape[1]
        mask = length_mask(x_len, l, bf)
        x16 = (x * mask[:, :, None].float()).to(bf)
        xf = cells.gru_input_proj(enc["fwd"], x16).contiguous()
        xb = cells.gru_input_proj(enc["bwd"], x16).contiguous()
        out["bigru_scan2_bf16"].append((
            tag, (xf, xb, wzr2, wh2), 2 * b * l * (6 * hd * hd + 12 * hd),
            2 * (2 * b * l * 3 * hd + 2 * 3 * hd * hd + 2 * b * l * hd), None))
        with torch.no_grad():
            h = chorowski.encode(p16, cfg, x16, x_len).contiguous()
            vh = attention.precompute_vh(dec, h).contiguous()
            onehot = torch.nn.functional.one_hot(y.long(), v).to(bf) * dec_mask[..., None].to(bf)
            y_prev = torch.cat([torch.zeros_like(onehot[:, :1]), onehot[:, :-1]], dim=1)
            yin = readout.linear_apply(dec["y_in"], y_prev).contiguous()
        steps = b * t_len
        step_mv = st * s_dim + a * st + 2 * st * st + 4 * st * st + 2 * st * st
        out["attention_decode_scan_fwd_bf16"].append((
            tag, (vh, h, mask, yin, *weights),
            steps * (4 * l * s_dim + 2 * l * a + 2 * step_mv + 5 * l + 10 * st),
            2 * (b * l * (s_dim + a + 1) + steps * st + w_elems + steps * (st + a + l)), None))
        k2_shapes = [(h, vh, mask)]
        if b == TRAIN_B:  # and b = 1 at the serving length
            x1 = torch.randn(1, SERVE_L, cfg.input_frame_size, generator=gen).to(dev).to(bf)
            with torch.no_grad():
                h1 = chorowski.encode(p16, cfg, x1, torch.tensor([SERVE_L], device=dev))
            k2_shapes.append((h1.contiguous(), attention.precompute_vh(dec, h1).contiguous(),
                              torch.ones(1, SERVE_L, device=dev, dtype=bf)))
        for hh, vv, mm in k2_shapes:
            bb, ll = hh.shape[:2]
            s0 = (torch.randn(bb, BEAM_K, st, generator=gen) * 0.3).to(dev).to(bf)
            yk = torch.nn.functional.one_hot(torch.randint(0, v, (bb, BEAM_K), generator=gen),
                                             v).to(dev).to(bf)
            state = (torch.zeros(bb, BEAM_K, ll, device=dev, dtype=bf), s0, torch.zeros_like(s0))
            out["fused_attention_step_bf16"].append((
                ("held-out " if tag.startswith("held-out") else "") + f"B={bb} K={BEAM_K} L={ll}",
                (dec, acfg, state, yk, vv, hh, mm),
                bb * BEAM_K * (4 * ll * s_dim + 2 * ll * a + 2 * mvs),
                2 * (bb * ll * (s_dim + a + 1) + 2 * bb * BEAM_K * st + sum(t.numel() for t in read)
                     + bb * BEAM_K * (ll + a + st)) + 4 * bb * BEAM_K * v, None))
    return out


def bf16_calls(name):
    """(kernel call, its exact plain twin, the plain bf16 version at the
    JAX kernel's rounding points) of a bf16 entry, each returning a tuple
    of tensors. Only K4's, K10's, K12's and K14's twin and plain version
    differ: their entries fold c_in and dec_in into the gates, so they do
    not round cc or r."""
    from seq2seq_attention_asr_tpu_torch.ops.cuda import (attention_scan, attention_step,
                                                          gru_scan, lstm_scan)

    if name == "bigru_scan2_bf16":
        return gru_scan.bigru_scan2, gru_scan.bigru_scan2_plain, gru_scan.bigru_scan2_plain
    if name in BF16_GRU_OF:  # the forwards' twins are their plain bf16 versions
        tup = lambda fn: lambda *a: (fn(*a),)  # forward wrappers return one tensor
        if name in ("gru_scan_bf16", "bigru_scan_bf16"):
            fwd = gru_scan.gru_scan if name == "gru_scan_bf16" else gru_scan.bigru_scan
            plain = tup(gru_scan.gru_scan_plain if name == "gru_scan_bf16"
                        else gru_scan.bigru_scan_plain)
            return tup(fwd), plain, plain
        if name == "gru_scan_bwd_bf16":
            twin = lambda *a: tuple(g[0] for g in gru_scan.bigru_scan_bwd_twin_bf16(
                *(t[None] for t in a)))
            return gru_scan.gru_scan_bwd, twin, gru_scan.gru_scan_bwd_plain
        return (gru_scan.bigru_scan_bwd, gru_scan.bigru_scan_bwd_twin_bf16,
                gru_scan.bigru_scan_bwd_plain)
    if name == "bigru_scan2_bwd_bf16":  # its plain bf16 version is its exact twin
        return (gru_scan.bigru_scan2_bwd, gru_scan.bigru_scan2_bwd_plain,
                gru_scan.bigru_scan2_bwd_plain)
    if name == "attention_decode_scan_bwd_bf16":  # its last argument is c32
        return (lambda *a: attention_scan.attention_decode_scan_bwd(*a[:-1], c32=a[-1]),
                attention_scan.attention_decode_scan_bwd_twin_bf16,
                lambda *a: (attention_scan.attention_decode_scan_bwd_plain_bf16
                            if a[0].dtype == torch.bfloat16 else
                            attention_scan.attention_decode_scan_bwd_plain)(*a[:-1]))
    if name == "bilstm_scan_bf16":
        return lstm_scan.bilstm_scan, lstm_scan.bilstm_scan_plain, lstm_scan.bilstm_scan_plain
    if name == "bilstm_scan_bwd_bf16":  # its plain version, on the widened inputs, rounds nothing
        return (lstm_scan.bilstm_scan_bwd, lstm_scan.bilstm_scan_bwd_plain,
                lstm_scan.bilstm_scan_bwd_plain)
    if name in BF16_OTHER_TRAIN_OF:  # K11's, K15's, K13's: the last argument is c32
        bwd = getattr(attention_scan, name[:-len("_bf16")])
        twin = getattr(attention_scan, name[:-len("_bf16")] + "_twin_bf16")
        plain16 = getattr(attention_scan, name[:-len("_bf16")] + "_plain_bf16")
        plain32 = getattr(attention_scan, name[:-len("_bf16")] + "_plain")
        return (lambda *a: bwd(*a[:-1], c32=a[-1]), twin,
                lambda *a: (plain16 if a[0].dtype == torch.bfloat16 else plain32)(*a[:-1]))
    if name == "attention_decode_scan_fwd_bf16":
        return (attention_scan.attention_decode_scan, attention_scan.gru_folded_scan_plain,
                attention_scan.attention_decode_scan_plain)
    if name in ("attention_decode_scan_loc_lstm_fwd_bf16", "attention_decode_scan_loc_fwd_bf16",
                "attention_decode_scan_lstm_fwd_bf16"):
        lstm = name != "attention_decode_scan_loc_fwd_bf16"
        fwd = getattr(attention_scan, name[:-len("_fwd_bf16")])
        return (fwd, lambda *a: attention_scan.folded_scan_plain(*a[:4], a[4:], lstm),
                lambda *a: attention_scan._scan_plain(*a[:4], a[4:], lstm))
    plain = lambda *args: _step_outputs(attention_step.fused_attention_step_plain(*args))
    return (lambda *args: _step_outputs(attention_step.fused_attention_step(*args)), plain,
            plain)


def upcast(args):
    """The f32 twin of a bf16 call's arguments: every bf16 tensor, in a
    parameter tree or the beam's state too, widened."""
    from seq2seq_attention_asr_tpu_torch import tree

    return tree.tree_map(lambda a: a.float() if isinstance(a, torch.Tensor) and
                         a.dtype == torch.bfloat16 else a, list(args))


def f32_kernel_of(name: str) -> str:
    """The float32 kernel a bf16 entry is an instance of."""
    return (BF16_OF.get(name) or BF16_TRAIN_OF.get(name) or BF16_OTHER_TRAIN_OF.get(name)
            or BF16_GRU_OF.get(name) or BF16_MODEL_OF[name])


def bf16_parity_rows(cases_, card: str) -> dict:
    """Phase 12's (a) and (c) for the bf16 entries of `cases_` ({name:
    [(tag, args, flops, nbytes, library)]}): each case run twice with the
    same bits and held to the entry's exact twin and to the plain bf16
    version (bf16_check); at each entry's first case, and at each other
    case of a B = TRAIN_B training batch (K8's instances after its
    first), its device time beside its float32 kernel's on the upcast
    inputs, its twin's time, its bound at the bf16 peak and, where
    `library` is a call, that call's device time. Returns {name: its
    {"kernels"} numbers (its first case's) but the launches}."""
    rows = {}
    for name, cs in cases_.items():
        kernel_call, twin_call, plain_call = bf16_calls(name)
        errs = []
        for i, (tag, args, flops, nbytes, library) in enumerate(cs):
            with torch.no_grad():
                got = kernel_call(*args)
                again = kernel_call(*args)
                twin = twin_call(*args)
                plain = plain_call(*args)
                truth = plain_call(*upcast(args))
                noise = (float64_twin(twin_call, args) if name in BF16_OTHER_TRAIN_OF
                         and name != "bilstm_scan_bwd_bf16" else None)
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(got, again)):
                raise SystemExit(f"{name} {tag}: two calls of the bf16 kernel disagree")
            errs.append(bf16_check(name, tag, got, twin, plain, truth, noise))
            if i and (f"B={TRAIN_B} " not in tag or "evaluation" in tag or "held-out" in tag):
                continue
            up = upcast(args)
            with torch.no_grad():
                ms = device_ms(lambda: kernel_call(*args), BF16_SYMBOLS[name], 10)
                f32_ms = device_ms(lambda: kernel_call(*up), F32_SYMBOLS[name], 10)
                plain_ms = time_ms(lambda: twin_call(*args), 2, warmup=1)
                lib_ms = None if library is None else device_ms(library, None, 10)
            b_ms, b_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
            lib = (f"null ({NO_LIBRARY.get(f32_kernel_of(name), 'cuDNN refused bf16')})"
                   if library is None else f"{lib_ms:.4f} ms (cuDNN's bidirectional "
                   f"torch.nn.LSTM in bf16{', its backward' if 'bwd' in name else ''}, the "
                   f"input projection included)")
            print(f"time {name} {tag}: bf16 kernel {ms:.4f} ms on the device, float32 kernel "
                  f"{f32_ms:.4f} ms on the upcast inputs, plain twin {plain_ms:.4f} ms per call, "
                  f"bound {b_ms:.4f} ms ({b_by}: {flops:.3e} flop at the bf16 peak, "
                  f"{nbytes:.3e} B in bf16), library {lib} ({card})")
            rows.setdefault(name, dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                                       library_ms=lib_ms))
        rows[name]["max_abs_err"] = max(errs)
    return rows


def bf16_kernel_rows(rows: dict) -> list:
    """The {"kernels"} line's rows of bf16 entries from bf16_parity_rows'
    numbers and their launches."""
    return [{"name": name, "route": "cuda", "source": SOURCES[f32_kernel_of(name)],
             "replaces": REPLACES[f32_kernel_of(name)], "launches": r["launches"],
             "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
             "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
             "library_ms": r["library_ms"]} for name, r in rows.items()]


def eval_batch_ms(tr, params, batch, card: str, label: str):
    """One evaluation batch through `tr` (teacher-forced eval step, then
    the beam): p50 of 5 wall times and the device time of one."""
    arrs, _, eos = tr._prepare_batch(batch, with_eos=True)
    x, x_len = arrs[:2]
    cap = int(math.ceil(tr.tcfg.eval_len_factor * x.shape[1]))

    def run():
        tr.eval_fn(params, arrs)
        return tr.decode_fn(params, x, x_len, eos, max_steps_cap=cap)

    run()
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    busy = device_ms(run, None, 1)
    wall = statistics.median(walls)
    print(f"time evaluation batch {label} (B={x.shape[0]}, L={x.shape[1]}, K={BEAM_K}): p50 "
          f"{wall:.3f} ms wall, {busy:.4f} ms on the device, idle share "
          f"{1 - busy / wall:.4f} ({card})")
    return wall, busy


def bf16_phase(kernels, card: str) -> list:
    """Phase 12: (a) K1, K4 and K2 in bf16 against their plain bf16 versions
    at bf16_cases' shapes; (b) the committed checkpoint as a bf16 model
    through Trainer.evaluate on the card, launching the bf16 entries only:
    its held-out beam PER within HELD_OUT_PER_BF16_TOL of the port's CPU
    value and within HELD_OUT_PER_BF16_F32_TOL of the float32 PER; (c) each
    entry's device time beside its float32 kernel's on the upcast inputs,
    and one B = 32 evaluation batch in bf16 beside float32 (its bf16
    training is phase 12 (c)'s). Returns the bf16 entries' {"kernels"}
    rows."""
    from seq2seq_attention_asr_tpu_torch.models import chorowski, registry
    from seq2seq_attention_asr_tpu_torch.train import checkpoint, experiment, optim, trainer

    t0 = time.perf_counter()
    bf = torch.bfloat16
    params = checkpoint.load_params_npz(str(HELD_OUT_NPZ), "cuda")
    kw = dict(experiment.timit_chorowski_normnll_colnorm().model_kwargs, dropout=0.5)
    model16 = registry.build("chorowski", compute_dtype="bfloat16", **kw)
    p16 = chorowski.cast_float32(params, bf)
    gen = torch.Generator().manual_seed(SEED + 12)
    _, valid, batcher, vocab = held_out_split("cuda")
    tcfg = trainer.TrainConfig(batch_size=HELD_OUT["batch"], normalize_nll=True, beam_k=BEAM_K,
                               seed=HELD_OUT["seed"])
    tr16 = trainer.Trainer(model16, optim.OptimConfig(), tcfg, vocab=vocab, device="cuda")
    tr16.init(params)
    batches = list(batcher.batches(valid, shuffle=False))
    longest = max(batches, key=lambda b: b.x.shape[1])  # the evaluation's longest bucket
    cases_ = bf16_cases(p16, model16.cfg, gen, tr16._prepare_batch(longest)[0])

    # (a) parity, and (c) the times at each entry's first shape.
    rows = bf16_parity_rows(cases_, card)

    # (b) the held-out PER of the bf16 model, the bf16 entries only, under
    # PyTorch's default allow_bf16_reduced_precision_reduction (True):
    # the model's bf16 products sum in float32 whatever the flag says.
    matmul = torch.backends.cuda.matmul
    flag = matmul.allow_bf16_reduced_precision_reduction
    t1 = time.perf_counter()
    row, counts = counted(kernels, lambda: tr16.evaluate(valid, batcher))
    wall = time.perf_counter() - t1
    if not flag or matmul.allow_bf16_reduced_precision_reduction != flag:
        raise SystemExit(f"allow_bf16_reduced_precision_reduction {flag} before the bf16 "
                         f"evaluation, {matmul.allow_bf16_reduced_precision_reduction} after: "
                         f"expected PyTorch's default, True, and kept")
    per = row["valid_per"]
    print(f"held-out beam PER, bf16 model, on the card {per!r} (the port on the CPU, bf16, "
          f"{HELD_OUT_PER_CPU_BF16!r}, tol {HELD_OUT_PER_BF16_TOL}; float32 {HELD_OUT_PER_CPU!r}, "
          f"tol {HELD_OUT_PER_BF16_F32_TOL}), valid_nll {row['valid_nll']:.6f}, valid_accuracy "
          f"{row['valid_accuracy']:.6f}, {1e3 * wall:.1f} ms wall; launches {counts}")
    check_counts("held-out evaluate bf16", counts, tuple(BF16_OF))
    if not abs(per - HELD_OUT_PER_CPU_BF16) <= HELD_OUT_PER_BF16_TOL:
        raise SystemExit(f"held-out bf16 PER {per} on the card, {HELD_OUT_PER_CPU_BF16} on the CPU")
    if not abs(per - HELD_OUT_PER_CPU) <= HELD_OUT_PER_BF16_F32_TOL:
        raise SystemExit(f"held-out bf16 PER {per}, float32 {HELD_OUT_PER_CPU}")
    for name in BF16_OF:
        rows[name]["launches"] = counts[name]

    # (c) one B = 32 evaluation batch, bf16 beside float32.
    tr32 = trainer.Trainer(registry.build("chorowski", **kw), optim.OptimConfig(), tcfg,
                           vocab=vocab, device="cuda")
    batch = batches[0]
    with torch.no_grad():
        eval_batch_ms(tr32, params, batch, card, "float32")
        eval_batch_ms(tr16, params, batch, card, "bf16")

    print(f"bf16 phase: {time.perf_counter() - t0:.1f} s wall ({card})")
    return bf16_kernel_rows(rows)


# Phase 13: the LibriSpeech recipes (train/experiment.py:106-179 of the
# JAX package) at full width. Their longest segments are ~35 s: 1,094
# frames at 32 ms a frame (VGG's encoder halves them, less 4); a batch's
# lengths are ragged in 375-1,094 frames (12-35 s). The word recipe's
# output layer is the word vocabulary: ~34k words over train-clean-100.
LS_B = 16
LS_L = 1094
LS_MIN_L = 375
WORDS_V = 34000
LS_CHARS = 30  # a character vocabulary: 26 letters, space, apostrophe, <eos> and one more


def k2_step_case(dec, acfg, b: int, k: int, l: int, gen, dead=None):
    """K2 at a beam step of (B, K, L) on the decoder `dec` (its V the
    config's output_depth): a Case whose bound counts the step's inputs,
    outputs and weights once."""
    from seq2seq_attention_asr_tpu_torch.ops.cuda import attention_step

    args = k2_inputs(dec, acfg, b, k, l, gen, dead)
    a, s_dim, st, v = acfg.annotation_depth, acfg.score_depth, acfg.state_depth, acfg.output_depth
    ro = dec["readout"]
    weights = [dec["ws"]["w"], dec["ws"]["b"], dec["w_e"], dec["c_in"]["w"], dec["c_in"]["b"],
               dec["dec_in"]["w"], dec["dec_in"]["b"], dec["cell"]["w_zr"], dec["cell"]["w_h"],
               *[t for layer in ro for t in layer.values()]]
    mvs = (st * s_dim + a * st + 2 * st * st + 4 * st * st + 2 * st * st + ro[-2]["w"].numel()
           + ro[-1]["w"].numel())
    esize = args[4].element_size()
    return Case(
        "fused_attention_step", ("attention_step_kernel",),
        lambda *xs: _step_outputs(attention_step.fused_attention_step(*xs)),
        lambda *xs: _step_outputs(attention_step.fused_attention_step_plain(*xs)), args,
        flops=b * k * (4 * l * s_dim + 2 * l * a + 2 * mvs + 3 * v),
        nbytes=esize * (b * l * (s_dim + a + 1) + 2 * b * k * st + b * k * (l + a + st)
                        + sum(t.numel() for t in weights)) + 4 * b * k * v,
        label=f"fused_attention_step[V={v}]")


def words_decoder(v: int, gen):
    """The flagship's decoder with a V-word output layer: (weights on the
    card, its attention config)."""
    from seq2seq_attention_asr_tpu_torch import interop
    from seq2seq_attention_asr_tpu_torch.models import registry
    from seq2seq_attention_asr_tpu_torch.ops import attention

    acfg = registry.build("chorowski", output_depth=v).cfg.attention_config()
    return interop.to_torch(attention.attention_init(gen, acfg), "cuda"), acfg


def checked_twice(c, kernel, tag: str) -> float:
    """Case `c` against its plain version (Case.check), then a second call
    bitwise equal and one launch of `kernel` a call (check_repeat);
    returns the max abs error."""
    with torch.no_grad():
        got = c.kernel(*c.args)
        want = c.plain(*c.args)
    torch.cuda.synchronize()
    err = c.check(got, want, tag)
    check_repeat(c, kernel, got, tag)
    return err


def k2_words_phase(kernels, card: str) -> dict:
    """Phase 13 (a): K2 with the vocabulary spread over its cluster. At V =
    WORDS_V, K = 5 and 8, B = LS_B, L = LS_L (a fully masked row) against
    the plain version, twice, with its plan; at b = 1, L = LS_L its cap on
    clusters of 16 at K = 5 and 8, from the card's shared memory, and the
    refusal one above it; the bf16 entry at V = WORDS_V against its exact
    twin. Returns the float32 K = 5 case's numbers for the kernels line.
    The cap is the largest V up to which every vocabulary fits
    (attention_step.step_vocab_cap)."""
    from seq2seq_attention_asr_tpu_torch.ops.cuda import attention_step

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 13)
    kernel = kernels["fused_attention_step"]
    smem_limit, resident = attention_step.step_limits(dev)
    dec, acfg = words_decoder(WORDS_V, gen)
    row = None
    for k in (BEAM_K, 8):
        c = k2_step_case(dec, acfg, LS_B, k, LS_L, gen, dead=3)
        tag = f"B={LS_B} K={k} L={LS_L} V={WORDS_V}"
        err = checked_twice(c, kernel, tag)
        plan = attention_step.step_plan_on(LS_B, k, LS_L, 512, 512, 256, 64, 7, WORDS_V, dev)
        with torch.no_grad():
            ms = device_ms(lambda: c.kernel(*c.args), c.symbols, 20)
            plain_ms = time_ms(lambda: c.plain(*c.args), 3)
        b_ms, b_by = bound(c.flops, c.nbytes)
        print(f"time {c.label} {tag}: kernel {ms:.4f} ms on the device, plain {plain_ms:.4f} ms "
              f"per call, bound {b_ms:.4f} ms ({b_by}), on clusters of {plan.cluster} in "
              f"{plan.waves} wave(s) (resident {resident}, {smem_limit} B a block) ({card})")
        if k == BEAM_K:
            row = dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                       plan=plan)
    del dec
    for k in (BEAM_K, 8):
        cap = attention_step.step_vocab_cap(k, LS_L, 512, 512, 256, 64, 7, 16, smem_limit)
        dec, acfg = words_decoder(cap, gen)
        c = k2_step_case(dec, acfg, 1, k, LS_L, gen)
        checked_twice(c, kernel, f"b=1 K={k} L={LS_L} V={cap} (the cap on clusters of 16)")
        dec_over, acfg_over = words_decoder(cap + 1, gen)
        over = k2_inputs(dec_over, acfg_over, 1, k, LS_L, gen)
        try:
            attention_step.fused_attention_step(*over)
        except RuntimeError as e:
            print(f"refuse fused_attention_step b=1 K={k} L={LS_L} V={cap + 1}: {e}")
        else:
            raise SystemExit(f"fused_attention_step took V={cap + 1} at K={k}, over its cap")
        del dec, dec_over, over
    from seq2seq_attention_asr_tpu_torch import tree

    dec, acfg = words_decoder(WORDS_V, gen)
    c = k2_step_case(dec, acfg, LS_B, BEAM_K, LS_L, gen)
    bf16_args = tree.tree_map(lambda a: a.to(torch.bfloat16) if isinstance(a, torch.Tensor)
                              and a.dtype == torch.float32 else a, list(c.args))
    kbf = kernels["fused_attention_step_bf16"]
    before = kbf.launches
    with torch.no_grad():
        got = c.kernel(*bf16_args)
        again = c.kernel(*bf16_args)
        twin = c.plain(*bf16_args)
        truth = c.plain(*upcast(bf16_args))
    torch.cuda.synchronize()
    tag = f"B={LS_B} K={BEAM_K} L={LS_L} V={WORDS_V}"
    bf16_check("fused_attention_step_bf16", tag, got, twin, twin, truth)
    if kbf.launches - before != 2 or not all(torch.equal(g, a) for g, a in zip(got, again)):
        raise SystemExit(f"fused_attention_step_bf16 {tag}: two calls differ or launch more")
    with torch.no_grad():
        ms = device_ms(lambda: c.kernel(*bf16_args), c.symbols, 20)
    print(f"time fused_attention_step_bf16 {tag}: kernel {ms:.4f} ms on the device ({card})")
    return row


# The LibriSpeech train batch: B = LS_B, lengths ragged in LS_MIN_L..LS_L
# (the first row at LS_L), characters ragged in 180..LS_T (~15 a second)
# and words in 32..LS_WORDS_T; the CPU's step a batch of LS_CPU_B rows of
# at most LS_CPU_L frames and LS_CPU_T labels, the same recipe.
LS_T = 512
LS_WORDS_T = 96
LS_CPU_B, LS_CPU_L, LS_CPU_T = 2, 400, 64
# The chunked epoch (d): two chunks of LS_B utterances as the train batch
# draws them, and a valid split of 8 short ones (80-200 frames), so that
# a batch's beam of up to 2 L steps stays short.
LS_VALID = dict(n=8, min_l=80, max_l=200, t=40)
LS_VGG_LAUNCHES = {"attention_decode_scan_fwd": 1, "attention_decode_scan_bwd": 1}


def ls_batch(b: int, l: int, t: int, v: int, seed: int, stacked: bool, min_l=LS_MIN_L,
             min_t=180):
    """A padded LibriSpeech batch (x, x_len, y, dec_mask) on the CPU: seeded
    features ((B, L, 40, 3) stacked, else (B, L, 123)), lengths ragged in
    min_l..l and labels in min_t..t, the first row at full length."""
    rng = np.random.RandomState(seed)
    x = rng.randn(b, l, *((40, 3) if stacked else (123,))).astype(np.float32)
    x_len = rng.randint(min(min_l, l), l + 1, b)
    labels = rng.randint(min(min_t, t), t + 1, b)
    x_len[0], labels[0] = l, t
    x *= (np.arange(l)[None, :] < x_len[:, None]).reshape((b, l) + (1,) * (x.ndim - 2))
    y = rng.randint(0, v, (b, t))
    dec_mask = (np.arange(t)[None] < labels[:, None]).astype(np.float32)
    return tuple(torch.from_numpy(a) for a in (x, x_len.astype(np.int64), y, dec_mask))


def ls_recipes():
    """(label, recipe function, output depth, stacked input, the kernels a
    train step launches) of the three LibriSpeech recipes."""
    from seq2seq_attention_asr_tpu_torch.train import experiment

    return [("librispeech_vgg", lambda: experiment.librispeech_vgg(LS_CHARS), LS_CHARS, True,
             LS_VGG_LAUNCHES),
            ("librispeech_chorowski", lambda: experiment.librispeech_chorowski(LS_CHARS),
             LS_CHARS, False, STEP_LAUNCHES),
            ("librispeech_chorowski_words",
             lambda: experiment.librispeech_chorowski_words(WORDS_V), WORDS_V, False,
             STEP_LAUNCHES)]


def k8_vgg_phase(kernels, card: str) -> float:
    """Phase 13 (b): K8's <GRU, content> instance with VGG's four-layer
    readout (maxout -> linear -> maxout -> linear, the recipe's widths and
    LS_CHARS outputs) at b = 1 and 8 and B = LS_B, K = 5, on VGG's
    encoder length for LS_L frames: against its plain version (TOL), two
    calls bitwise equal, one launch a call, with its plan; its device
    time at B = LS_B. Returns the largest max abs error."""
    from seq2seq_attention_asr_tpu_torch import interop
    from seq2seq_attention_asr_tpu_torch.models import vgg
    from seq2seq_attention_asr_tpu_torch.ops import attention
    from seq2seq_attention_asr_tpu_torch.ops.cuda import attention_step

    gen = torch.Generator().manual_seed(SEED + 14)
    cfg = vgg.VGGConfig(output_depth=LS_CHARS)
    acfg = cfg.attention_config()
    dec = interop.to_torch(attention.attention_init(gen, acfg), "cuda")
    lv = int(vgg.encode_lengths(cfg, torch.tensor(LS_L)))
    kernel, worst = kernels["fused_attention_step_loc_lstm"], 0.0
    if attention_step.uses_k2(acfg):
        raise SystemExit("the VGG readout went to K2")
    dense = attention_step.k8_dense(attention_step.k8_layers(acfg))
    for b, dead in ((1, None), (8, 5), (LS_B, 3)):
        c = Case("fused_attention_step_loc_lstm", K8_SYMBOLS,
                 lambda *xs: _step_outputs(attention_step.fused_attention_step(*xs)),
                 lambda *xs: _step_outputs(attention_step.fused_attention_step_plain(*xs)),
                 k2_inputs(dec, acfg, b, BEAM_K, lv, gen, dead), 0, 0,
                 label="fused_attention_step_loc_lstm[vgg]")
        plan = attention_step.step_loc_lstm_plan_on(b, BEAM_K, lv, 512, 512, 256, 0, 0, False,
                                                    dense, torch.device("cuda"))
        tag = f"B={b} K={BEAM_K} L'={lv} V={LS_CHARS}, on clusters of {plan.cluster} in " \
              f"{plan.waves} wave(s)"
        worst = max(worst, checked_twice(c, kernel, tag))
    with torch.no_grad():
        ms = device_ms(lambda: c.kernel(*c.args), c.symbols, 50)
        plain_ms = time_ms(lambda: c.plain(*c.args), 5)
    print(f"time fused_attention_step_loc_lstm[vgg] B={LS_B} K={BEAM_K} L'={lv}: kernel {ms:.4f} "
          f"ms on the device, plain {plain_ms:.4f} ms per call ({card})")
    return worst


def ls_train_phase(kernels, card: str) -> dict:
    """Phase 13 (c) and (e): for each LibriSpeech recipe at full width
    (orthogonal init from the seed), 3 card steps on one B = LS_B batch
    (lengths ragged in LS_MIN_L..LS_L, TF32 off) with the launch counts
    zeroed before each and pinned after it, the loss finite and falling;
    one step on the card and on the CPU of a LS_CPU_B-row batch, within
    TRAIN_RTOL; the p50 of 10 card steps, its device time and idle share.
    Returns {label: the first card step's launch counts}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    launches = {}
    for label, recipe, v, stacked, expected in ls_recipes():
        t0 = time.perf_counter()
        exp = recipe()
        params_cpu = exp.init_params(torch.Generator().manual_seed(SEED), device="cpu")
        t = LS_WORDS_T if v == WORDS_V else LS_T
        batch = tuple(a.cuda() for a in ls_batch(LS_B, LS_L, t, v, SEED + 15, stacked,
                                                 min_t=32 if v == WORDS_V else 180))
        state, step_fn = make_trainer(recipe, params_cpu, "cuda")
        want = dict.fromkeys(kernels, 0)
        want.update(expected)
        losses = []
        for i in range(3):
            (state, m), counts = counted(kernels, lambda: step_fn(state, batch))
            losses.append(float(m["loss"]))
            if counts != want:
                raise SystemExit(f"train {label} step {i + 1}: launch counts {counts}, expected "
                                 f"{want}")
            launches.setdefault(label, counts)
        print(f"train {label} B={LS_B} L={LS_L} T={t} V={v}: card losses {losses}, launches "
              f"{launches[label]}")
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
            raise SystemExit(f"train {label}: the loss did not fall over 3 card steps")
        small = ls_batch(LS_CPU_B, LS_CPU_L, LS_CPU_T, v, SEED + 16, stacked, min_t=16)
        runs = {}
        for dev in ("cuda", "cpu"):
            st, fn = make_trainer(recipe, params_cpu, dev)
            _, m = fn(st, tuple(a.to(dev) for a in small))
            runs[dev] = {k: float(val) for k, val in m.items()}
        rel = {k: abs(runs["cuda"][k] - runs["cpu"][k]) / abs(runs["cpu"][k])
               for k in ("loss", "nll", "grad_norm", "param_norm")}
        print(f"train {label} B={LS_CPU_B} L={LS_CPU_L} T={LS_CPU_T}: card {runs['cuda']}, CPU "
              f"{runs['cpu']}, relative differences {rel} (tol {TRAIN_RTOL})")
        if not all(np.isfinite(val) for val in runs["cuda"].values()) or \
                max(rel.values()) > TRAIN_RTOL:
            raise SystemExit(f"train {label}: the card's step disagrees with the CPU's")
        lat, state = step_latencies(step_fn, state, batch)
        with traced([ProfilerActivity.CUDA]) as prof:
            state, _ = step_fn(state, batch)
        p50 = statistics.median(lat)
        dev_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        busy = sum(e.time_range.elapsed_us() for e in dev_events) / 1e3
        idle = f"{1 - busy / p50:.4f}" if dev_events else "not measured"
        audio_s = float(batch[1].sum()) * HOP / SR
        print(f"time train {label} step B={LS_B} L={LS_L} T={t}: p50 {p50:.2f} ms (min "
              f"{min(lat):.2f}, max {max(lat):.2f}) over 10 steps, {audio_s / (p50 / 1e3):.1f} "
              f"audio s/s ({audio_s:.1f} s of audio a step), device busy {busy:.2f} ms in "
              f"{len(dev_events)} device ops, idle share {idle}; {time.perf_counter() - t0:.1f} "
              f"s wall for the recipe ({card})")
        del state, step_fn, batch
    return launches


def ls_dataset(n: int, seed: int, min_l: int, max_l: int, t: int, v: int, stacked: bool,
               prefix: str):
    """n seeded utterances of the LibriSpeech shapes as a Dataset: (L, 40, 3)
    stacked features or (L, 123), L in min_l..max_l, t // 2..t labels."""
    from seq2seq_attention_asr_tpu_torch.data import timit

    rng = np.random.RandomState(seed)
    lens, labels = rng.randint(min_l, max_l + 1, n), rng.randint(t // 2, t + 1, n)
    shape = (40, 3) if stacked else (123,)
    return timit.Dataset(uids=[f"{prefix}{i}" for i in range(n)],
                         x=[rng.randn(li, *shape).astype(np.float32) for li in lens],
                         y=[rng.randint(0, v, ti).astype(np.int32) for ti in labels], y39=None,
                         start=[np.zeros(0)] * n, finish=[np.zeros(0)] * n)


def ls_fit_phase(kernels, card: str) -> None:
    """Phase 13 (d): Trainer.fit(chunked=...) of librispeech_vgg at full
    width, one epoch over two in-memory chunks of LS_B utterances each
    (lengths in LS_MIN_L..LS_L) in the order the epoch's seed draws,
    one resident at a time, then the beam CER on LS_VALID's short split:
    the chunks loaded in that order, K4, K5 and K8 launched and no other
    kernel, the train NLL finite and the CER logged."""
    import tempfile

    from seq2seq_attention_asr_tpu_torch.data import batching
    from seq2seq_attention_asr_tpu_torch.train import experiment, trainer

    t0 = time.perf_counter()
    exp = experiment.librispeech_vgg(LS_CHARS)
    tcfg = dataclasses.replace(exp.train, num_epochs=1)
    chunks = [ls_dataset(LS_B, SEED + 17 + c, LS_MIN_L, LS_L, LS_T, LS_CHARS, True, f"c{c}_")
              for c in range(2)]
    valid = ls_dataset(LS_VALID["n"], SEED + 19, LS_VALID["min_l"], LS_VALID["max_l"],
                       LS_VALID["t"], LS_CHARS, True, "v")
    loaded = []
    load_chunk = lambda i: loaded.append(i) or chunks[i]
    batcher_fn = lambda ds: batching.BucketedBatcher.from_dataset(ds, tcfg.batch_size, 2)
    with tempfile.TemporaryDirectory() as save:
        tr = trainer.Trainer(exp.build_model(), exp.optim, tcfg, save_dir=save, device="cuda")
        tr.init(exp.init_params(torch.Generator().manual_seed(SEED), device="cuda"))
        rows, counts = counted(kernels, lambda: list(tr.fit(
            None, valid, batching.BucketedBatcher.from_dataset(valid, tcfg.batch_size, 2),
            chunked=(load_chunk, 2, batcher_fn))))
        saved = sorted(os.listdir(save))
    order = list(np.random.RandomState(tcfg.seed + 1).permutation(2))
    row = rows[-1]
    print(f"fit librispeech_vgg chunked: chunks loaded {loaded} (the epoch's order {order}), row "
          f"{ {k: row[k] for k in ('train_nll', 'valid_nll', 'valid_per', 'train_seconds')} }, "
          f"launches {counts}, saved {saved}; {time.perf_counter() - t0:.1f} s wall ({card})")
    check_counts("fit librispeech_vgg chunked", counts,
                 ("attention_decode_scan_fwd", "attention_decode_scan_bwd",
                  "fused_attention_step_loc_lstm"))
    if loaded != order or not np.isfinite(row["train_nll"]) or "valid_per" not in row:
        raise SystemExit("fit librispeech_vgg chunked: wrong chunk order, or no finite row")


def ls_words_beam_phase(kernels, card: str) -> int:
    """Phase 13 (e), the beam: one batch of 4 short utterances (80-200
    frames) through the word recipe's beam (K = 5, V = WORDS_V, up to 2 L
    steps), with the recipe's weights: K1 three times (the encoder) and K2
    once a beam step, no other kernel; scores finite, tokens in the
    vocabulary. Returns K2's launches."""
    from seq2seq_attention_asr_tpu_torch.train import experiment, trainer

    exp = experiment.librispeech_chorowski_words(WORDS_V)
    model = exp.build_model()
    params = exp.init_params(torch.Generator().manual_seed(SEED), device="cuda")
    x, x_len, _, _ = (a.cuda() for a in ls_batch(4, LS_VALID["max_l"], 8, WORDS_V, SEED + 20,
                                                  False, min_l=LS_VALID["min_l"], min_t=4))
    decode_fn = trainer.make_decode_step(model.encode, model.attention_cfg, exp.train.beam_k,
                                         exp.train.eval_len_factor, "cuda")
    cap = int(math.ceil(exp.train.eval_len_factor * x.shape[1]))
    eos = torch.full((4,), WORDS_V - 1, device="cuda")
    t0 = time.perf_counter()
    res, counts = counted(kernels, lambda: decode_fn(params, x, x_len, eos, max_steps_cap=cap))
    took = time.perf_counter() - t0
    tokens = res.tokens
    print(f"beam librispeech_chorowski_words B=4 L={x.shape[1]} K={exp.train.beam_k} V={WORDS_V}: "
          f"lengths {res.lengths.tolist()}, scores {res.scores.tolist()}, launches {counts}, "
          f"{took:.2f} s wall ({card})")
    check_counts("beam librispeech_chorowski_words", counts, ("bigru_scan2", "fused_attention_step"),
                 {"bigru_scan2": 3})
    if not (bool(torch.isfinite(res.scores).all()) and int(tokens.min()) >= 0
            and int(tokens.max()) < WORDS_V):
        raise SystemExit("beam librispeech_chorowski_words: scores not finite or tokens out of "
                         "the vocabulary")
    return counts["fused_attention_step"]


def stacked_front_end_phase(kernels, card: str) -> None:
    """Phase 13 (f): the VGG recipe's stacked front end (logmel_stacked)
    through K3 on the card against the same call on the CPU (K3's plain
    version): one K3 launch, (B, 3, L, 40), dB within TOL and the deltas
    and delta-deltas within 20 and 400 times that; and its device time."""
    from seq2seq_attention_asr_tpu_torch.ops.cuda import logmel

    pcm = torch.stack([torch.from_numpy(p) for p in make_pcm(2, SEED + 21)])
    got, counts = counted(kernels, lambda: logmel.logmel_stacked(pcm.cuda(), SR))
    want = logmel.logmel_stacked(pcm, SR)
    errs = [float((got[:, c].cpu() - want[:, c]).abs().max()) for c in range(3)]
    print(f"parity logmel_stacked B=2 {tuple(got.shape)}: max abs err by channel {errs} (tol "
          f"{TOL} x 1, 20, 400), launches {counts['stft_logmel_power']}")
    check_counts("logmel_stacked", counts, ("stft_logmel_power",), {"stft_logmel_power": 1})
    if not all(e <= TOL * s for e, s in zip(errs, (1, 20, 400))):
        raise SystemExit("logmel_stacked: the card's stacked features disagree with the CPU's")
    with torch.no_grad():
        ms = device_ms(lambda: logmel.logmel_stacked(pcm.cuda(), SR), None, 20)
    print(f"time logmel_stacked B=2: {ms:.4f} ms on the device, every op ({card})")


def librispeech_phase(kernels, errs: dict, card: str) -> dict:
    """Phase 13: the LibriSpeech recipes. K8's error with VGG's readout
    joins its row's in `errs`. Returns the kernels line's row of K2 at the
    word vocabulary, with its plan (its launches: the word beam's)."""
    t0 = time.perf_counter()
    k2 = k2_words_phase(kernels, card)
    errs["fused_attention_step_loc_lstm"] = max(errs["fused_attention_step_loc_lstm"],
                                                k8_vgg_phase(kernels, card))
    ls_train_phase(kernels, card)
    ls_fit_phase(kernels, card)
    words_launches = ls_words_beam_phase(kernels, card)
    stacked_front_end_phase(kernels, card)
    print(f"librispeech phase: {time.perf_counter() - t0:.1f} s wall ({card})")
    plan = k2["plan"]
    return {"name": f"fused_attention_step[V={WORDS_V}]", "route": "cuda",
            "source": SOURCES["fused_attention_step"],
            "replaces": REPLACES["fused_attention_step"],
            "plan": {"cluster": plan.cluster, "waves": plan.waves, "B": LS_B, "K": BEAM_K,
                     "L": LS_L}, "launches": words_launches, "max_abs_err": k2["err"], "ms": k2["ms"],
            "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"],
            "library_ms": None}



# Phase 14: the convergence harness (tools/convergence_torch.py) at the
# conv+BiLSTM recipe's full width on a small synthetic corpus, on the card
# and on the CPU from the same CPU-drawn init over the same staged
# batches; rows held by the train-step gate (the losses, the grad norm
# and the valid NLL within TRAIN_RTOL) and the token decisions (the
# accuracies and PERs) within CONVERGENCE_PER_TOL.
CONVERGENCE_ARGV = ["--model", "conv_bilstm", "--train-utts", "64", "--valid-utts", "16",
                    "--batch-size", "32", "--epochs", "2", "--decode-every", "1"]
CONVERGENCE_PER_TOL = 0.02
CONVERGENCE_KERNELS = ("bilstm_scan", "bilstm_scan_bwd", "attention_decode_scan_loc_lstm_fwd",
                       "attention_decode_scan_loc_lstm_bwd",
                       "fused_attention_step_loc_lstm")  # K7, K9, K10, K11, K8


def convergence_phase(kernels, card: str) -> None:
    """Phase 14: two epochs of the conv+BiLSTM recipe through the harness's
    main() on the card (launch counts zeroed just before, read just after:
    K7, K9, K10, K11 and K8, nothing else) and on the CPU (--cpu
    --device-batches), the rows held to each other; its wall seconds."""
    import importlib.util
    import tempfile

    t0 = time.perf_counter()
    path = pathlib.Path(__file__).resolve().parent / "tools" / "convergence_torch.py"
    spec = importlib.util.spec_from_file_location("convergence_torch", path)
    harness = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(harness)
    with tempfile.TemporaryDirectory() as d:
        card_rows, counts = counted(kernels, lambda: harness.main(
            CONVERGENCE_ARGV + ["--out", os.path.join(d, "card.json")]))
        card_s = time.perf_counter() - t0
        with open(os.path.join(d, "card.json")) as f:
            meta = json.load(f)["meta"]
        cpu_rows = harness.main(CONVERGENCE_ARGV + ["--cpu", "--device-batches",
                                                    "--out", os.path.join(d, "cpu.json")])
    print(f"convergence harness on the card: launches {counts}; meta backend "
          f"{meta['backend']}, device {meta.get('device')}")
    check_counts("convergence harness", counts, CONVERGENCE_KERNELS)
    if meta["backend"] != "cuda" or meta.get("device") != card:
        raise SystemExit(f"convergence harness: meta {meta}")
    if not len(card_rows) == len(cpu_rows) == 2:
        raise SystemExit(f"convergence harness: {len(card_rows)} card rows, {len(cpu_rows)} CPU")
    for g, w in zip(card_rows, cpu_rows):
        gate = {k: abs(g[k] - w[k]) / abs(w[k]) for k in ("train_loss", "train_nll",
                                                          "grad_norm", "valid_nll")}
        decisions = {k: abs(g[k] - w[k]) for k in ("train_accuracy", "valid_accuracy",
                                                   "valid_per")}
        print(f"convergence harness epoch {g['epoch']}: card " + ", ".join(
            f"{k} {g[k]:.6f}" for k in (*gate, *decisions)) + "; CPU " + ", ".join(
            f"{k} {w[k]:.6f}" for k in (*gate, *decisions)))
        if g["epoch"] != w["epoch"] or max(gate.values()) > TRAIN_RTOL or \
                max(decisions.values()) > CONVERGENCE_PER_TOL or not np.isfinite(g["valid_per"]):
            raise SystemExit(f"convergence harness epoch {g['epoch']}: relative {gate}, "
                             f"absolute {decisions}")
    print(f"convergence phase: {time.perf_counter() - t0:.1f} s wall, the card's run "
          f"{card_s:.1f} s ({card})")

# Phase 12 (b): the bf16 evaluation path of four more configurations,
# conv_bilstm, flagship_loc (the flagship recipe with 16 feature maps),
# vgg and conv_bilstm_content (the conv+BiLSTM recipe without the
# location term): K7, K10, K12, K14 and K8 through their bf16 entries (the JAX
# kernels' rounding points: their sources' heads), each held as K1, K4
# and K2 are above; then each configuration's bf16 Trainer.evaluate on
# the card, under PyTorch's default flags, launching the bf16 entries
# only, against the same evaluation on the CPU (the plain bf16 versions
# at the JAX kernels' rounding points). The weights are each recipe's
# seeded init: no trained checkpoint exists for these four, so their
# beams are the untrained models'. The CPU's PER and NLL are taken in the
# same run (BF16_EVAL_PER_TOL, BF16_EVAL_NLL_RTOL: on the CPU, these
# batches evaluated with the entries' exact twins in place of the plain
# versions gave the same PER and NLLs 1e-7 to 1e-5 apart).
BF16_MODEL_OF = {"bilstm_scan_bf16": "bilstm_scan",
                 "attention_decode_scan_loc_lstm_fwd_bf16": "attention_decode_scan_loc_lstm_fwd",
                 "attention_decode_scan_loc_fwd_bf16": "attention_decode_scan_loc_fwd",
                 "attention_decode_scan_lstm_fwd_bf16": "attention_decode_scan_lstm_fwd",
                 "fused_attention_step_loc_lstm_bf16": "fused_attention_step_loc_lstm"}
BF16_EVAL_PER_TOL = 0.02  # card vs CPU, bf16, untrained weights
BF16_EVAL_NLL_RTOL = 1e-3
# The utterances of each configuration's evaluation: the held-out split's
# first batch (flagship_loc's first 16: its untrained beam runs to the
# cap, which costs the CPU ~0.5 s an utterance), and LS_VALID's split.
BF16_EVAL_N = {"conv_bilstm": 32, "flagship_loc": 16, "vgg": LS_VALID["n"],
               "conv_bilstm_content": 32}


def bf16_recipes():
    """(label, recipe, the bf16 entries one evaluation batch launches
    besides K8 once a beam step: {name: launches}) of the four
    configurations, their model_kwargs in bf16."""
    from seq2seq_attention_asr_tpu_torch.train import experiment

    out = []
    for label, exp, launches in (
            ("conv_bilstm", experiment.timit_conv_bilstm(),
             {"bilstm_scan_bf16": 2, "attention_decode_scan_loc_lstm_fwd_bf16": 1}),
            ("flagship_loc", flagship_loc(),
             {"bigru_scan2_bf16": 6, "attention_decode_scan_loc_fwd_bf16": 1}),
            ("vgg", experiment.librispeech_vgg(LS_CHARS), {"attention_decode_scan_fwd_bf16": 1}),
            ("conv_bilstm_content", conv_bilstm_content(),
             {"bilstm_scan_bf16": 2, "attention_decode_scan_lstm_fwd_bf16": 1})):
        exp.model_kwargs["compute_dtype"] = "bfloat16"
        out.append((label, exp, launches))
    return out


def bf16_eval_batch(label: str):
    """The configuration's evaluation batch (a DeviceBatch on the card;
    the trainer moves it where it runs) and its vocabulary."""
    from seq2seq_attention_asr_tpu_torch.data import batching

    n = BF16_EVAL_N[label]
    if label == "vgg":
        ds = ls_dataset(n, SEED + 26, LS_VALID["min_l"], LS_VALID["max_l"], LS_VALID["t"],
                        LS_CHARS, True, "v")
        base = batching.BucketedBatcher.from_dataset(ds, n, n_buckets=1)
        return next(iter(batching.CachedDeviceBatcher(base, device="cuda").batches(ds))), None
    _, valid, batcher, vocab = held_out_split("cuda")
    b = next(iter(batcher.batches(valid, shuffle=False)))
    return dataclasses.replace(b, x=b.x[:n], x_len=b.x_len[:n], y=b.y[:n],
                               dec_mask=b.dec_mask[:n], y_len=b.y_len[:n],
                               y39=None if b.y39 is None else b.y39[:n], uids=b.uids[:n]), vocab


def _bf16_scan_args(dec16, h16, x_len, y, dec_mask, v, lstm):
    """A decoder scan's arguments in bf16 as the bf16 model's forward forms
    them (vh, the mask, yin from the labels), the location term's weights
    where the decoder has them, and its cost: (args, flops, bytes at 2 a
    value)."""
    from seq2seq_attention_asr_tpu_torch.models.chorowski import float32_sums
    from seq2seq_attention_asr_tpu_torch.ops import attention, readout
    from seq2seq_attention_asr_tpu_torch.ops.masking import length_mask

    bf = torch.bfloat16
    b, l, a = h16.shape
    with torch.no_grad(), float32_sums(bf):
        vh = attention.precompute_vh(dec16, h16).contiguous()
        mask = length_mask(x_len, l, bf)
        onehot = torch.nn.functional.one_hot(y.long(), v).to(bf) * dec_mask[..., None].to(bf)
        y_prev = torch.cat([torch.zeros_like(onehot[:, :1]), onehot[:, :-1]], dim=1)
        yin = readout.linear_apply(dec16["y_in"], y_prev).contiguous()
    cell = dec16["cell"]
    weights = (dec16["ws"]["w"], dec16["ws"]["b"], dec16["w_e"], dec16["c_in"]["w"],
               dec16["c_in"]["b"], dec16["dec_in"]["w"], dec16["dec_in"]["b"])
    weights += (cell["w_h"], cell["w_x"], cell["b"]) if lstm else (cell["w_zr"], cell["w_h"])
    fm, f = 0, 0
    if "u" in dec16:
        weights += (dec16["loc_conv"]["w"][:, 0, :], dec16["loc_conv"]["b"], dec16["u"])
        fm, f = dec16["u"].shape[0], dec16["loc_conv"]["w"].shape[0]
    s_dim, st, t_len = vh.shape[2], yin.shape[2], yin.shape[1]
    steps = b * t_len
    # As decoder_scan_cases counts the float32 forward's work.
    step_mv = st * s_dim + a * st + 2 * st * st + (8 * st * st if lstm else 6 * st * st)
    flops = steps * (4 * l * s_dim + 2 * l * fm * f + 2 * l * s_dim * fm + 2 * l * a
                     + 2 * step_mv + 5 * l + 10 * st)
    values = (b * l * (s_dim + a + 1) + steps * st + sum(w.numel() for w in weights)
              + steps * ((2 if lstm else 1) * st + a + l))
    return (vh, h16, mask, yin, *weights), flops, 2 * values


def _bf16_step_args(dec16, acfg, h16, x_len, gen):
    """K8's arguments at a beam step of K = BEAM_K on the bf16 annotations
    h16, the state in bf16, and its cost: (args, flops, bytes: bf16 but
    logp's float32)."""
    from seq2seq_attention_asr_tpu_torch.ops.masking import length_mask

    case = step_case("bf16", upcast([dec16])[0], acfg, h16.float(), length_mask(x_len,
                                                                               h16.shape[1]), gen)
    b, v = h16.shape[0], acfg.output_depth
    return tuple(bf16_tree(case.args)), case.flops, case.nbytes // 2 + 2 * b * BEAM_K * v


def bf16_tree(args):
    """Every float32 tensor of `args` (parameter trees and the beam's state
    too) in bf16."""
    from seq2seq_attention_asr_tpu_torch import tree

    return tree.tree_map(lambda a: a.to(torch.bfloat16) if isinstance(a, torch.Tensor) and
                         a.dtype == torch.float32 else a, list(args))


def bf16_model_cases(models, gen):
    """The five entries' inputs at the shapes of their configurations'
    paths, bf16 on the card: {name: [(tag, args, flops, nbytes, library)]},
    the first of each at a training batch's shape (B = 16, 144 frames; the
    VGG step at B = 16 on LibriSpeech's short split), then the evaluation
    batch's. `models`: {label: (bf16 model, its params on the card)}.
    library: cuDNN's bf16 LSTM on K7's input, where it computes K7's
    function with the input projection (a yardstick), else None."""
    from seq2seq_attention_asr_tpu_torch.models import conv_bilstm
    from seq2seq_attention_asr_tpu_torch.models.chorowski import cast_float32, float32_sums
    from seq2seq_attention_asr_tpu_torch.ops import cells, conv
    from seq2seq_attention_asr_tpu_torch.ops.masking import flip_sequences

    dev, bf = torch.device("cuda"), torch.bfloat16
    out = {name: [] for name in BF16_MODEL_OF}
    batches = {label: [(f"B={TRAIN_B} {TRAIN_L} frames T={TRAIN_T}",
                        tuple(t.to(dev) for t in train_batch(TRAIN_B, SEED + 26)))]
               for label in ("conv_bilstm", "flagship_loc", "conv_bilstm_content")}
    batches["vgg"] = [(f"B={TRAIN_B} L={LS_VALID['max_l']} T={LS_VALID['t']}",
                       tuple(t.to(dev) for t in ls_batch(TRAIN_B, LS_VALID["max_l"],
                                                         LS_VALID["t"], LS_CHARS, SEED + 26,
                                                         True, LS_VALID["min_l"], 20)))]
    for label in batches:
        eb, _ = bf16_eval_batch(label)
        batches[label].append((f"evaluation B={eb.x.shape[0]} L={eb.x.shape[1]}",
                               (eb.x, eb.x_len, eb.y, eb.dec_mask)))
    for label, cases_ in batches.items():
        model, params = models[label]
        p16 = cast_float32(params, bf)
        cfg, acfg = model.cfg, model.attention_cfg
        for tag, (x, x_len, y, dec_mask) in cases_:
            with torch.no_grad(), float32_sums(bf):
                h16, h_len = model.encode(p16, cast_float32(x, bf), x_len)
                h16 = h16.contiguous()
            if label == "conv_bilstm":
                enc = p16["encoder"]
                with torch.no_grad(), float32_sums(bf):
                    hc = cast_float32(x, bf)
                    for name in ("conv1", "conv2", "conv3"):
                        hc = conv.temporal_max_pool(torch.relu(conv.temporal_conv(enc[name], hc)),
                                                    2)
                    lens = conv_bilstm.encode_lengths(cfg, x_len)
                    p = enc["bilstm"]
                    xproj2 = torch.stack([cells.lstm_input_proj(p["fwd"], hc),
                                          cells.lstm_input_proj(p["bwd"],
                                                                flip_sequences(hc, lens))])
                b, l, hd = hc.shape[0], hc.shape[1], p["fwd"]["w_h"].shape[0]
                z2 = torch.zeros((2, b, hd), device=dev)
                wh2 = torch.stack([p["fwd"]["w_h"], p["bwd"]["w_h"]]).contiguous()
                lstm = cudnn_lstm(upcast([params["encoder"]["bilstm"]])[0], dev).to(bf)
                library = lambda lstm=lstm, hc=hc: lstm(hc)[0]
                try:
                    with torch.no_grad():
                        library()
                except RuntimeError as e:
                    print(f"cuDNN's LSTM refused bf16 inputs ({e}): K7's library call is null")
                    library = None
                # As conv_bilstm_cases counts K7's work; xproj2 and wh2 in
                # bf16, the states float32.
                out["bilstm_scan_bf16"].append((
                    tag, (xproj2.contiguous(), z2, z2, wh2),
                    2 * b * l * (8 * hd * hd + 30 * hd),
                    2 * (2 * b * l * 4 * hd + 2 * hd * 4 * hd) + 4 * (4 * b * hd + 4 * b * l * hd),
                    library))
            if label != "vgg":
                lstm_dec = label != "flagship_loc"
                name = {"conv_bilstm": "attention_decode_scan_loc_lstm_fwd_bf16",
                        "flagship_loc": "attention_decode_scan_loc_fwd_bf16",
                        "conv_bilstm_content": "attention_decode_scan_lstm_fwd_bf16"}[label]
                args, flops, nbytes = _bf16_scan_args(p16["decoder"], h16, h_len, y, dec_mask,
                                                      acfg.output_depth, lstm_dec)
                out[name].append((tag, args, flops, nbytes, None))
            args, flops, nbytes = _bf16_step_args(p16["decoder"], acfg, h16, h_len, gen)
            out["fused_attention_step_loc_lstm_bf16"].append((f"{label} {tag}", args, flops,
                                                              nbytes, None))
    return out


class OneBatch:
    """A batcher that yields one batch, whatever the dataset."""

    def __init__(self, batch):
        self.batch = batch

    def batches(self, ds, **kw):
        return iter([self.batch])


def counted_steps(fn):
    """fn() with the beam's step calls counted: (its result, the calls)."""
    from seq2seq_attention_asr_tpu_torch.decode import beam

    step, calls = beam.fused_attention_step, []

    def counting(*args):
        calls.append(1)
        return step(*args)

    beam.fused_attention_step = counting
    try:
        return fn(), len(calls)
    finally:
        beam.fused_attention_step = step


def default_flags():
    """PyTorch's defaults of the flags a bf16 evaluation could be changed
    by: TF32 for cuBLAS off, for cuDNN on, cuBLAS's reduced-precision bf16
    reduction on."""
    return {"matmul.allow_tf32": False, "cudnn.allow_tf32": True,
            "matmul.allow_bf16_reduced_precision_reduction": True}


def read_flags():
    m, c = torch.backends.cuda.matmul, torch.backends.cudnn
    return {"matmul.allow_tf32": m.allow_tf32, "cudnn.allow_tf32": c.allow_tf32,
            "matmul.allow_bf16_reduced_precision_reduction":
                m.allow_bf16_reduced_precision_reduction}


def set_flags(flags):
    m, c = torch.backends.cuda.matmul, torch.backends.cudnn
    m.allow_tf32 = flags["matmul.allow_tf32"]
    c.allow_tf32 = flags["cudnn.allow_tf32"]
    m.allow_bf16_reduced_precision_reduction = flags[
        "matmul.allow_bf16_reduced_precision_reduction"]


def bf16_models_phase(kernels, card: str) -> list:
    """Phase 12 (b): (a) K7, K10, K12, K14 and K8 in bf16 against their
    exact twins and the plain bf16 versions at bf16_model_cases' shapes,
    each twice with the same bits; (b)
    each configuration's bf16 Trainer.evaluate on its evaluation batch on
    the card under PyTorch's default flags (unchanged after), launching
    only its bf16 entries, exactly as many times as the batch and the
    beam's steps call for, with PER within BF16_EVAL_PER_TOL and NLL
    within BF16_EVAL_NLL_RTOL of the CPU's; (c) each entry's device time
    beside its float32 kernel's on the upcast inputs (their bf16 training:
    phase 12 (c) and (d)). Returns the five entries' {"kernels"} rows."""
    from seq2seq_attention_asr_tpu_torch import interop
    from seq2seq_attention_asr_tpu_torch.train import optim, trainer

    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(SEED + 26)
    recipes = bf16_recipes()
    models, cpu_params = {}, {}
    for label, exp, _ in recipes:
        cpu_params[label] = exp.init_params(torch.Generator().manual_seed(SEED), device="cpu")
        models[label] = (exp.build_model(), interop.to_torch(cpu_params[label], "cuda"))
    cases_ = bf16_model_cases(models, gen)

    # (a) parity, and (c) the times at each entry's first shape.
    rows = bf16_parity_rows(cases_, card)
    for r in rows.values():
        r["launches"] = 0

    # (b) each configuration's bf16 evaluation, the card's under PyTorch's
    # default flags, then the CPU's.
    main_flags = read_flags()
    tcfg_kw = dict(batch_size=32, beam_k=BEAM_K, seed=1)
    for label, exp, launches in recipes:
        model, params = models[label]
        batch, vocab = bf16_eval_batch(label)
        tcfg = dataclasses.replace(exp.train, **tcfg_kw)
        runs = {}
        for device, p in (("cuda", params), ("cpu", cpu_params[label])):
            tr = trainer.Trainer(model, optim.OptimConfig(), tcfg, vocab=vocab, device=device)
            tr.state = (p, None, None)
            fixed = OneBatch(batch)
            t1 = time.perf_counter()
            if device == "cuda":
                set_flags(default_flags())
                try:
                    (row, steps), counts = counted(kernels, lambda: counted_steps(
                        lambda: tr.evaluate(None, fixed)))
                    after = read_flags()
                finally:
                    set_flags(main_flags)
                if after != default_flags():
                    raise SystemExit(f"{label} bf16 evaluation changed the flags: {after}")
                exact = dict(launches, fused_attention_step_loc_lstm_bf16=steps)
                check_counts(f"{label} evaluate bf16", counts, tuple(exact), exact)
                rows["fused_attention_step_loc_lstm_bf16"]["launches"] += steps
                for name in launches:
                    if name in rows:
                        rows[name]["launches"] += launches[name]
            else:
                row, steps = counted_steps(lambda: tr.evaluate(None, fixed))
            runs[device] = (row, steps, time.perf_counter() - t1)
        (card_row, card_steps, card_s), (cpu_row, cpu_steps, cpu_s) = runs["cuda"], runs["cpu"]
        dper = abs(card_row["valid_per"] - cpu_row["valid_per"])
        dnll = abs(card_row["valid_nll"] - cpu_row["valid_nll"]) / abs(cpu_row["valid_nll"])
        print(f"{label} bf16 evaluation ({BF16_EVAL_N[label]} utterances, K={BEAM_K}, seeded "
              f"weights): PER card {card_row['valid_per']!r}, CPU {cpu_row['valid_per']!r} (tol "
              f"{BF16_EVAL_PER_TOL}); NLL card {card_row['valid_nll']!r}, CPU "
              f"{cpu_row['valid_nll']!r} (rel {dnll:.2e}, tol {BF16_EVAL_NLL_RTOL}); accuracy card "
              f"{card_row['valid_accuracy']!r}, CPU {cpu_row['valid_accuracy']!r}; beam steps card "
              f"{card_steps}, CPU {cpu_steps}; wall card {1e3 * card_s:.1f} ms, CPU "
              f"{1e3 * cpu_s:.1f} ms; PyTorch's default flags, unchanged after ({card})")
        if not (dper <= BF16_EVAL_PER_TOL and dnll <= BF16_EVAL_NLL_RTOL):
            raise SystemExit(f"{label}: the card's bf16 evaluation is not the CPU's")

    print(f"bf16 models phase: {time.perf_counter() - t0:.1f} s wall ({card})")
    return bf16_kernel_rows(rows)


def bf16_train_cases(p16, cfg, gen):
    """The inputs of K6's and K5's bf16 entries as the bf16 flagship's
    train step gives them, on the card: {name: [(tag, args, flops,
    nbytes, None)]} at B = TRAIN_B and BIG_B, L = TRAIN_L, T = TRAIN_T,
    from the recipe's weights in bf16 (p16): K6 on the first encoder
    layer (its projections, K1's bf16 outputs and a random cotangent zero
    on the padding), K5 on the encoder's output (K4's bf16 outputs with
    its float32 alpha and c, random cotangents); K5's last argument is
    c32. No PyTorch call computes either function (library null)."""
    from seq2seq_attention_asr_tpu_torch.models import chorowski
    from seq2seq_attention_asr_tpu_torch.ops import attention, cells, readout
    from seq2seq_attention_asr_tpu_torch.ops.cuda import attention_scan, gru_scan
    from seq2seq_attention_asr_tpu_torch.ops.masking import length_mask

    dev, bf = torch.device("cuda"), torch.bfloat16
    enc, dec = p16["encoder"]["bigru1"], p16["decoder"]
    hd = enc["fwd"]["w_zr"].shape[1] // 2
    wzr2 = torch.stack([enc["fwd"]["w_zr"][:hd], enc["bwd"]["w_zr"][:hd]]).contiguous()
    wh2 = torch.stack([enc["fwd"]["w_h"][:hd], enc["bwd"]["w_h"][:hd]]).contiguous()
    weights = (dec["ws"]["w"], dec["ws"]["b"], dec["w_e"], dec["c_in"]["w"], dec["c_in"]["b"],
               dec["dec_in"]["w"], dec["dec_in"]["b"], dec["cell"]["w_zr"], dec["cell"]["w_h"])
    acfg = cfg.attention_config()
    a, s_dim, st, v = acfg.annotation_depth, acfg.score_depth, acfg.state_depth, acfg.output_depth
    w_elems = sum(t.numel() for t in weights)
    rnd = lambda *shape: (torch.randn(*shape, generator=gen) * 0.1).to(dev)
    out = {name: [] for name in BF16_TRAIN_OF}
    for b in (TRAIN_B, BIG_B):
        x, x_len, y, dec_mask = (t.to(dev) for t in train_batch(b, SEED + 7))
        l, t_len = x.shape[1], y.shape[1]
        tag = f"B={b} L={l} T={t_len}"
        mask = length_mask(x_len, l, bf)
        x16 = (x * mask[:, :, None].float()).to(bf)
        with torch.no_grad():
            xf = cells.gru_input_proj(enc["fwd"], x16).contiguous()
            xb = cells.gru_input_proj(enc["bwd"], x16).contiguous()
            ysf, ysb = gru_scan.bigru_scan2(xf, xb, wzr2, wh2)
        valid = mask[:, :, None]
        dys = [(rnd(b, l, hd) * valid.float()).to(bf) for _ in range(2)]
        # Per direction and (row, step): the six products (zr, c, drh, the
        # carry's, dWzr, dWh: 9 H^2 multiply-adds) and ~30 H elementwise.
        out["bigru_scan2_bwd_bf16"].append((
            tag, (xf, xb, wzr2, wh2, ysf, ysb, *dys), 2 * b * l * (18 * hd * hd + 30 * hd),
            2 * (2 * (2 * b * l * 3 * hd + 2 * b * l * hd) + 2 * 2 * 3 * hd * hd), None))
        with torch.no_grad():
            h = chorowski.encode(p16, cfg, x16, x_len).contiguous()
            vh = attention.precompute_vh(dec, h).contiguous()
            onehot = torch.nn.functional.one_hot(y.long(), v).to(bf) * dec_mask[..., None].to(bf)
            y_prev = torch.cat([torch.zeros_like(onehot[:, :1]), onehot[:, :-1]], dim=1)
            yin = readout.linear_apply(dec["y_in"], y_prev).contiguous()
            (s_seq, c_seq, _), (alpha32, c32) = attention_scan.attention_decode_scan_train(
                vh, h, mask, yin, *weights)
        cots = [rnd(b, t_len, n).to(bf) for n in (st, a, l)]
        steps = b * t_len
        # A (row, step): the recompute's and the backward's products and the
        # weight gradients' (3 St S + 3 A St + 26 St^2 multiply-adds), the
        # context's dalpha and dh (2 L A) and the energies (~5 L S).
        out["attention_decode_scan_bwd_bf16"].append((
            tag, (vh, h, mask, yin, *weights, s_seq, c_seq, alpha32, *cots, c32),
            steps * (2 * (3 * st * s_dim + 3 * a * st + 26 * st * st + 2 * l * a) + 5 * l * s_dim),
            2 * (2 * b * l * (s_dim + a) + b * l + 2 * steps * st + 2 * w_elems
                 + steps * (2 * st + 2 * a + l)) + 4 * steps * (l + a), None))
    return out


def grads_of_step(model, params, batch, tcfg, ocfg, seed: int):
    """(the metrics, the gradients the optimizer receives) of one train step
    of `model` from `params`: a transform that records them (as its state)
    and updates nothing stands in for the optimizer."""
    from seq2seq_attention_asr_tpu_torch import tree
    from seq2seq_attention_asr_tpu_torch.train import optim, trainer

    tx = optim.Transform(lambda p: tree.tree_map(torch.zeros_like, p),
                         lambda g, s, p=None: (tree.tree_map(torch.zeros_like, g), g))
    step = trainer.make_step_core(model.forward, tx, ocfg, tcfg, model.output_depth)
    dev = next(iter(tree.leaves(params))).device
    state, m = step((params, tx.init(params), torch.Generator(device=dev).manual_seed(seed)),
                    batch)
    return {k: float(v) for k, v in m.items()}, state[1]


def ground_truth_leaves(label, got, ref, truth) -> float:
    """Each leaf of the card's bf16 gradient `got`: finite, float32 (the
    masters'), and within the ground-truth rule of the float32 gradient
    `truth` against the reference bf16 gradient `ref` (rel L2 <= 2 x ref's
    + 0.02). Returns the largest rel L2 of got. Exits on a failure."""
    from seq2seq_attention_asr_tpu_torch import tree

    worst = (0.0, 0.0, "")
    for i, (g, r, t) in enumerate(zip(tree.leaves(got), tree.leaves(ref), tree.leaves(truth))):
        kd, rd = rel_dist(g, t), rel_dist(r.to(g.device), t)
        worst = max(worst, (kd, rd, str(i)))
        if g.dtype != torch.float32 or not bool(torch.isfinite(g).all()):
            raise SystemExit(f"{label}: gradient leaf {i} is not a finite float32 gradient")
        if not kd <= 2.0 * rd + 0.02:
            raise SystemExit(f"{label}: gradient leaf {i} fails the ground-truth rule: card bf16 "
                             f"{kd:.3e}, reference bf16 {rd:.3e} from the float32 gradient")
    print(f"{label}: every one of {len(tree.leaves(got))} gradient leaves within the ground-truth "
          f"rule of the float32 step's (largest rel L2: card bf16 {worst[0]:.3e}, reference bf16 "
          f"{worst[1]:.3e}, leaf {worst[2]})")
    return worst[0]


def bf16_flagship_steps(kernels, train_params, card: str) -> dict:
    """Phase 12 (c), the flagship's bf16 train step (the recipe
    timit_chorowski_normnll_colnorm, its orthogonal init from the seed) at
    B = TRAIN_B and BIG_B, by bf16_steps: its launches BF16_STEP_LAUNCHES
    and nothing else. Returns the launches of one step at TRAIN_B."""
    from seq2seq_attention_asr_tpu_torch.train import experiment

    def recipe16():
        exp = experiment.timit_chorowski_normnll_colnorm()
        exp.model_kwargs["compute_dtype"] = "bfloat16"
        return exp

    return bf16_steps(kernels, "flagship", recipe16, experiment.timit_chorowski_normnll_colnorm,
                      train_params, (TRAIN_B, BIG_B), BF16_STEP_LAUNCHES, BF16_STEP_KERNELS, card)


def bf16_fit_phase(kernels, card: str) -> dict:
    """Phase 12 (c), one Trainer.fit epoch of the chorowski_dropout recipe
    in bf16 and in float32, each restarted from params.npz, on the
    host-built held-out split (batch 32 over 3 buckets, as phase 10), the
    same batches and the same dropout masks (one generator seed): each
    epoch's held-out beam PER, the bf16 one within BF16_FIT_PER_TOL of
    the float32 one; the bf16 epoch launching the bf16 entries only.
    Returns its launches."""
    import tempfile

    from seq2seq_attention_asr_tpu_torch.train import checkpoint, experiment, trainer

    train, valid, batcher, vocab = held_out_split("cuda")
    rows, launched = {}, None
    for dt in ("float32", "bfloat16"):
        params = checkpoint.load_params_npz(str(HELD_OUT_NPZ), "cuda")
        exp = experiment.timit_chorowski_dropout()
        exp.model_kwargs["compute_dtype"] = dt
        tcfg = dataclasses.replace(exp.train, num_epochs=1, batch_size=HELD_OUT["batch"],
                                   beam_k=BEAM_K, seed=BF16_FIT_SEED)
        with tempfile.TemporaryDirectory() as save_dir:
            tr = trainer.Trainer(exp.build_model(), exp.optim, tcfg, vocab=vocab,
                                 save_dir=save_dir, device="cuda")
            tr.init(params)
            t0 = time.perf_counter()
            (row,), counts = counted(kernels, lambda: list(tr.fit(train, valid, batcher)))
        rows[dt] = row
        print(f"bf16 fit: one {dt} epoch of chorowski_dropout from params.npz ({len(train)} "
              f"utterances, batch {HELD_OUT['batch']}, seed {BF16_FIT_SEED}): "
              f"{time.perf_counter() - t0:.1f} s wall with the evaluation; train_nll "
              f"{row['train_nll']!r}, train_loss {row['train_loss']!r}, grad_norm "
              f"{row['grad_norm']!r}, held-out beam PER {row['valid_per']!r}, valid_nll "
              f"{row['valid_nll']!r}, train_seconds {row['train_seconds']:.2f}, valid_seconds "
              f"{row['valid_seconds']:.2f}; launches {counts} ({card})")
        if dt == "bfloat16":
            check_counts("bf16 fit", counts,
                         tuple(BF16_STEP_LAUNCHES) + ("fused_attention_step_bf16",))
            launched = counts
    gap = abs(rows["bfloat16"]["valid_per"] - rows["float32"]["valid_per"])
    print(f"bf16 fit: held-out PER bf16 {rows['bfloat16']['valid_per']!r}, float32 "
          f"{rows['float32']['valid_per']!r}, gap {gap:.4f} (tol {BF16_FIT_PER_TOL})")
    if not (np.isfinite(rows["bfloat16"]["train_nll"]) and gap <= BF16_FIT_PER_TOL):
        raise SystemExit("bf16 fit: the bf16 epoch's held-out PER is not the float32 one's")
    return launched


def bf16_vgg_step(kernels, card: str) -> None:
    """Phase 12 (c), VGG's bf16 train step (librispeech_vgg, orthogonal init
    from the seed) at B = LS_B on a phase-13 batch (lengths ragged in
    375-1,094 frames, labels in 180-512 characters): K4's and K5's bf16
    entries only, and each gradient leaf by the ground-truth rule against
    the card's float32 step, with the CPU's bf16 step on the same batch as
    the reference; the loss within BF16_STEP_RTOL of the CPU's."""
    from seq2seq_attention_asr_tpu_torch import interop
    from seq2seq_attention_asr_tpu_torch.train import experiment

    exps = {dt: experiment.librispeech_vgg(LS_CHARS) for dt in ("float32", "bfloat16")}
    exps["bfloat16"].model_kwargs["compute_dtype"] = "bfloat16"
    params_cpu = exps["float32"].init_params(torch.Generator().manual_seed(SEED), device="cpu")
    batch = ls_batch(LS_B, LS_L, LS_T, LS_CHARS, SEED + 13, True)
    out = {}
    for dt, exp in exps.items():
        model = exp.build_model()
        for dev in ("cuda", "cpu") if dt == "bfloat16" else ("cuda",):
            t0 = time.perf_counter()
            (m, g), counts = counted(kernels, lambda: grads_of_step(
                model, interop.to_torch(params_cpu, dev), tuple(t.to(dev) for t in batch),
                exp.train, exp.optim, SEED))
            out[(dt, dev)] = (m, g)
            print(f"bf16 vgg step ({dt} on {dev}, B={LS_B}, L={LS_L}, T={LS_T}): loss "
                  f"{m['loss']!r}, grad_norm {m['grad_norm']!r}, {time.perf_counter() - t0:.1f} s "
                  f"wall; launches {counts}")
            if dt == "bfloat16" and dev == "cuda":
                check_counts("bf16 vgg step", counts, tuple(BF16_VGG_LAUNCHES), BF16_VGG_LAUNCHES)
    (card_m, card_g), (cpu_m, cpu_g) = out[("bfloat16", "cuda")], out[("bfloat16", "cpu")]
    rel = abs(card_m["loss"] - cpu_m["loss"]) / abs(cpu_m["loss"])
    print(f"bf16 vgg step: loss card {card_m['loss']!r}, CPU {cpu_m['loss']!r}, relative "
          f"{rel:.2e} (tol {BF16_STEP_RTOL}); float32 on the card "
          f"{out[('float32', 'cuda')][0]['loss']!r}")
    if not rel <= BF16_STEP_RTOL:
        raise SystemExit("bf16 vgg step: the card's loss is not the CPU's")
    ground_truth_leaves("bf16 vgg step", card_g, cpu_g, out[("float32", "cuda")][1])


def bf16_train_phase(kernels, train_params, card: str) -> list:
    """Phase 12 (c): bf16 training. (a) K6's and K5's bf16 entries against
    their exact twins and the plain bf16 versions (bf16_parity_rows) at
    bf16_train_cases' shapes, twice with the same bits, with their device
    times beside the float32 kernels' and their bounds; (b) the flagship's
    bf16 step (bf16_flagship_steps); (c) a bf16 and a float32 epoch
    (bf16_fit_phase); (d) VGG's bf16 step (bf16_vgg_step). Returns the two
    entries' {"kernels"} rows, their launches the flagship step's."""
    from seq2seq_attention_asr_tpu_torch import interop
    from seq2seq_attention_asr_tpu_torch.models import chorowski
    from seq2seq_attention_asr_tpu_torch.train import experiment

    t0 = time.perf_counter()
    exp = experiment.timit_chorowski_normnll_colnorm()
    p16 = chorowski.cast_float32(interop.to_torch(train_params, "cuda"), torch.bfloat16)
    cases_ = bf16_train_cases(p16, exp.build_model().cfg, torch.Generator().manual_seed(SEED + 28))
    rows = bf16_parity_rows(cases_, card)
    del cases_
    launches = bf16_flagship_steps(kernels, train_params, card)
    for name in rows:
        rows[name]["launches"] = launches[name]
    bf16_fit_phase(kernels, card)
    bf16_vgg_step(kernels, card)
    print(f"bf16 train phase: {time.perf_counter() - t0:.1f} s wall ({card})")
    return bf16_kernel_rows(rows)


def _bf16_decoder_bwd_case(kind, dec16, output_depth, h16, enc_mask16, y, dec_mask, gen):
    """The bf16 backward of the decoder scan `kind` ("loc_lstm": K11,
    "lstm": K15, "loc": K13) on the bf16 annotations h16 of a training
    batch, as the bf16 train step gives it: the bf16 forward's outputs
    with its float32 alpha and c (the forward's f32 outputs), random bf16
    cotangents on s, c and alpha, zero past each row's label length, none
    on mem; its last argument c32. (tag, args, flops, nbytes, None): no
    PyTorch call computes the function."""
    from seq2seq_attention_asr_tpu_torch.ops import attention, readout
    from seq2seq_attention_asr_tpu_torch.ops.cuda import attention_scan

    bf = torch.bfloat16
    b, l, a = h16.shape
    t_len = y.shape[1]
    lstm, loc = kind != "loc", kind != "lstm"
    with torch.no_grad():
        vh = attention.precompute_vh(dec16, h16).contiguous()
        onehot = torch.nn.functional.one_hot(y.long(), output_depth).to(bf) * \
            dec_mask[..., None].to(bf)
        y_prev = torch.cat([torch.zeros_like(onehot[:, :1]), onehot[:, :-1]], dim=1)
        yin = readout.linear_apply(dec16["y_in"], y_prev).contiguous()
    cell = dec16["cell"]
    weights = (dec16["ws"]["w"], dec16["ws"]["b"], dec16["w_e"], dec16["c_in"]["w"],
               dec16["c_in"]["b"], dec16["dec_in"]["w"], dec16["dec_in"]["b"])
    weights += (cell["w_h"], cell["w_x"], cell["b"]) if lstm else (cell["w_zr"], cell["w_h"])
    if loc:
        weights += (dec16["loc_conv"]["w"][:, 0, :].contiguous(), dec16["loc_conv"]["b"],
                    dec16["u"])
    key = {"loc_lstm": "LOC_LSTM", "loc": "LOC", "lstm": "LSTM"}[kind]
    kernels = (getattr(attention_scan, f"KERNEL_{key}_FWD"),
               getattr(attention_scan, f"KERNEL_{key}_FWD_BF16"))
    with torch.no_grad():
        outs, (alpha32, c32) = attention_scan._scan(*kernels, lstm, vh, h16, enc_mask16, yin,
                                                     weights, f32=True)
    saved = list(outs)
    saved[2] = alpha32
    m = dec_mask[..., None].to(h16.device)
    rnd = lambda *shape: (torch.randn(*shape, generator=gen).to(h16.device) * 0.1 * m).to(bf)
    cots = [rnd(b, t_len, st) for st in (yin.shape[2], a, l)] + ([None] if lstm else [])
    s_dim, st = vh.shape[2], yin.shape[2]
    fm, f = (dec16["u"].shape[0], dec16["loc_conv"]["w"].shape[0]) if loc else (0, 0)
    w_elems = sum(w.numel() for w in weights)
    steps = b * t_len
    step_mv = st * s_dim + a * st + 2 * st * st + (8 * st * st if lstm else 6 * st * st)
    loc_flops = 2 * l * fm * f + 2 * l * s_dim * fm
    # decoder_scan_cases' count of the backward's operations; its bytes:
    # the bf16 inputs, saved sequences (s, c, mem), cotangents and outputs,
    # and the float32 alpha and c.
    flops = steps * (6 * step_mv + 8 * l * s_dim + 3 * loc_flops + 4 * l * a + 4 * l + 30 * st)
    nbytes = (2 * (b * l * (s_dim + a + 1) + steps * st + w_elems  # inputs
                   + steps * ((2 if lstm else 1) * st + a)  # s, c (and mem)
                   + steps * (st + a + l)  # the cotangents of s, c and alpha
                   + b * l * (s_dim + a) + steps * st + w_elems)  # dvh, dh, dyin, dW
              + 4 * steps * (l + a))  # alpha32 and c32
    return (f"B={b} L={l} T={t_len}", (vh, h16, enc_mask16, yin, *weights, *saved, *cots, c32),
            flops, nbytes, None)


def bf16_other_train_cases(params_cpu, gen):
    """The inputs of the bf16 entries of K9, K11, K15 and K13 as the bf16
    train steps of conv_bilstm, conv_bilstm_content and flagship_loc give
    them, on the card, at B = TRAIN_B and BIG_B: {name: [(tag, args,
    flops, nbytes, library)]}. K9 on conv_bilstm's BiLSTM (the bf16
    projections of the bf16 conv stack's output, K7's bf16 entry's float32
    states shifted as BiLSTMScan shifts them, a float32 cotangent of bf16
    values zero past each row's length), beside cuDNN's bf16 bidirectional
    LSTM backward; the decoders on each configuration's bf16 encoder
    output (_bf16_decoder_bwd_case)."""
    from seq2seq_attention_asr_tpu_torch import interop
    from seq2seq_attention_asr_tpu_torch.models import chorowski, conv_bilstm
    from seq2seq_attention_asr_tpu_torch.ops import cells, conv
    from seq2seq_attention_asr_tpu_torch.ops.cuda import lstm_scan
    from seq2seq_attention_asr_tpu_torch.ops.masking import flip_sequences, length_mask

    dev, bf = torch.device("cuda"), torch.bfloat16
    out = {name: [] for name in BF16_OTHER_TRAIN_OF}
    for label, exp in bf16_train_recipes().items():
        model = exp.build_model()
        cfg = model.cfg
        p16 = chorowski.cast_float32(interop.to_torch(params_cpu[label], "cuda"), bf)
        for b in (TRAIN_B, BIG_B):
            x, x_len, y, dec_mask = (t.to(dev) for t in train_batch(b, SEED + 29))
            with torch.no_grad(), chorowski.float32_sums(bf):
                if label == "flagship_loc":
                    h16 = chorowski.encode(p16, cfg, x.to(bf), x_len).contiguous()
                    lens = x_len
                else:
                    enc = p16["encoder"]
                    hc = x.to(bf)
                    for name in ("conv1", "conv2", "conv3"):
                        hc = conv.temporal_max_pool(torch.relu(conv.temporal_conv(enc[name], hc)),
                                                    2)
                    lens = conv_bilstm.encode_lengths(cfg, x_len)
                    p = enc["bilstm"]
                    xproj2 = torch.stack([cells.lstm_input_proj(p["fwd"], hc),
                                          cells.lstm_input_proj(p["bwd"],
                                                                flip_sequences(hc, lens))])
                    xproj2 = xproj2.contiguous()
                    hd = p["fwd"]["w_h"].shape[0]
                    z2 = torch.zeros(2, b, hd, device=dev)
                    wh2 = torch.stack([p["fwd"]["w_h"], p["bwd"]["w_h"]]).contiguous()
                    hs, cs = lstm_scan.bilstm_scan(xproj2, z2, z2, wh2)
                    h16 = torch.cat([hs[0], flip_sequences(hs[1], lens)], -1).to(bf).contiguous()
            l = h16.shape[1]
            enc_mask16 = length_mask(lens, l, bf)
            if label == "conv_bilstm":
                rows = b * l
                m = enc_mask16.float()[None, :, :, None]
                dys = (torch.randn(2, b, l, hd, generator=gen).to(dev) * 0.1 * m).to(bf).float()
                h_prev = torch.cat([z2[:, :, None], hs[:, :, :-1]], dim=2)
                c_prev = torch.cat([z2[:, :, None], cs[:, :, :-1]], dim=2)
                out["bilstm_scan_bwd_bf16"].append((
                    f"B={b} L'={l}", (xproj2, h_prev, c_prev, dys, wh2),
                    # K9's operations (cb_train_cases); bf16 xproj2 and W_h, the
                    # float32 states, cotangent and outputs.
                    2 * rows * (24 * hd * hd + 40 * hd),
                    2 * (2 * rows * 4 * hd + 2 * 4 * hd * hd)
                    + 4 * (3 * 2 * rows * hd + 2 * rows * 4 * hd + 2 * 2 * b * hd
                           + 2 * 4 * hd * hd),
                    cudnn_bilstm_bwd(p, hc, torch.cat([dys[0], dys[1]], -1).to(bf))))
            kind, name = {"conv_bilstm": ("loc_lstm", "attention_decode_scan_loc_lstm_bwd_bf16"),
                          "conv_bilstm_content": ("lstm", "attention_decode_scan_lstm_bwd_bf16"),
                          "flagship_loc": ("loc", "attention_decode_scan_loc_bwd_bf16")}[label]
            out[name].append(_bf16_decoder_bwd_case(kind, p16["decoder"], cfg.output_depth, h16,
                                                    enc_mask16, y, dec_mask, gen))
    return out


def bf16_train_recipes():
    """The three configurations of phase 12 (d), their model_kwargs in
    bf16: {label: experiment}."""
    from seq2seq_attention_asr_tpu_torch.train import experiment

    out = {"conv_bilstm": experiment.timit_conv_bilstm(),
           "conv_bilstm_content": conv_bilstm_content(), "flagship_loc": flagship_loc()}
    for exp in out.values():
        exp.model_kwargs["compute_dtype"] = "bfloat16"
    return out


def bf16_steps(kernels, label: str, recipe16, recipe32, params_cpu, sizes, expected,
               step_kernels, card: str) -> dict:
    """The bf16 train step of `recipe16` (an experiment builder; `recipe32`
    its float32 twin) from `params_cpu` at each batch of `sizes`: its
    launches (`expected`, nothing else); its loss within BF16_STEP_RTOL of
    the CPU's bf16 step on the same batch; each gradient leaf by the
    ground-truth rule against the card's float32 step, the CPU's bf16
    gradient the reference; under either value of
    allow_bf16_reduced_precision_reduction the same bits, the flag
    restored; the loss falling over 10 optimizer steps at sizes[0]; p50,
    audio s/s and the idle share at each size (train_timing). Returns the
    launches of one step at sizes[0]."""
    from seq2seq_attention_asr_tpu_torch import interop, tree

    exp16, exp32 = recipe16(), recipe32()
    m16, m32 = exp16.build_model(), exp32.build_model()
    params = interop.to_torch(params_cpu, "cuda")
    matmul = torch.backends.cuda.matmul
    launches = None
    for b in sizes:
        batch = tuple(t.cuda() for t in train_batch(b, SEED + 3))
        runs = {}
        for flag in (True, False):
            before = matmul.allow_bf16_reduced_precision_reduction
            matmul.allow_bf16_reduced_precision_reduction = flag
            try:
                runs[flag], counts = counted(kernels, lambda: grads_of_step(
                    m16, params, batch, exp16.train, exp16.optim, SEED))
                after = matmul.allow_bf16_reduced_precision_reduction
            finally:
                matmul.allow_bf16_reduced_precision_reduction = before
            print(f"bf16 {label} step B={b} (allow_bf16_reduced_precision_reduction {flag}, "
                  f"{after} after): loss {runs[flag][0]['loss']!r}, grad_norm "
                  f"{runs[flag][0]['grad_norm']!r}; launches {counts}")
            check_counts(f"bf16 {label} step B={b}", counts, tuple(expected), expected)
            if after != flag:
                raise SystemExit("the bf16 step did not restore the caller's flag")
            launches = launches or counts
        same = runs[True][0] == runs[False][0] and all(torch.equal(x, y) for x, y in zip(
            tree.leaves(runs[True][1]), tree.leaves(runs[False][1])))
        print(f"bf16 {label} step B={b}: the same bits under either flag: {same}")
        if not same:
            raise SystemExit(f"the bf16 {label} step's gradient depends on PyTorch's "
                             "reduced-precision flag: its products do not all sum in float32")
        metrics, grads = runs[False]
        t0 = time.perf_counter()
        cpu_metrics, cpu_grads = grads_of_step(m16, interop.to_torch(params_cpu, "cpu"),
                                               tuple(t.cpu() for t in batch), exp16.train,
                                               exp16.optim, SEED)
        cpu_s = time.perf_counter() - t0
        f32_metrics, truth = grads_of_step(m32, params, batch, exp32.train, exp32.optim, SEED)
        rel = abs(metrics["loss"] - cpu_metrics["loss"]) / abs(cpu_metrics["loss"])
        print(f"bf16 {label} step B={b}: loss card {metrics['loss']!r}, CPU (plain bf16 "
              f"versions) {cpu_metrics['loss']!r}, relative {rel:.2e} (tol {BF16_STEP_RTOL}; the "
              f"CPU step took {cpu_s:.1f} s); the float32 step's loss on the card "
              f"{f32_metrics['loss']!r}")
        if not rel <= BF16_STEP_RTOL:
            raise SystemExit(f"bf16 {label} step B={b}: the card's loss is not the CPU's")
        ground_truth_leaves(f"bf16 {label} step B={b}", grads, cpu_grads, truth)
    # 10 optimizer steps on one batch: the loss falls.
    state, step_fn = make_trainer(recipe16, params_cpu, "cuda")
    batch = tuple(t.cuda() for t in train_batch(sizes[0], SEED + 3))
    losses = []
    for _ in range(10):
        state, m = step_fn(state, batch)
        losses.append(float(m["loss"]))
    print(f"bf16 {label}: loss over 10 card steps on one batch {[round(v, 6) for v in losses]}")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise SystemExit(f"bf16 {label}: the loss did not fall")
    for b in sizes:
        train_timing(recipe16, params_cpu, b, card, step_kernels, f"{label} bf16")
    return launches


def bf16_conv_fit(kernels, params_cpu, card: str) -> None:
    """Phase 12 (d)'s short fit: three Trainer.fit epochs of conv_bilstm in
    bf16 and three in float32 from one seeded init (`params_cpu`), on the
    port's synthetic corpus (BF16_FIT_CORPUS), the same batches (one
    batcher seed; the recipe has no dropout), no beam decode: each bf16
    epoch's mean train NLL within BF16_FIT_NLL_RTOL of the float32 one's,
    both falling over the epochs, and the bf16 epochs launching the bf16
    entries only. No convergence claim."""
    import tempfile

    from seq2seq_attention_asr_tpu_torch import interop
    from seq2seq_attention_asr_tpu_torch.data import batching, synthetic
    from seq2seq_attention_asr_tpu_torch.train import experiment, trainer

    corpus = dict(BF16_FIT_CORPUS)
    train, valid, _ = synthetic.train_valid(corpus.pop("n_train"), corpus.pop("n_valid"),
                                            seed=SEED, **corpus)
    nll = {}
    for dt in ("float32", "bfloat16"):
        exp = experiment.timit_conv_bilstm()
        exp.model_kwargs["compute_dtype"] = dt
        tcfg = dataclasses.replace(exp.train, num_epochs=3, batch_size=TRAIN_B,
                                   seed=BF16_FIT_SEED)
        batcher = batching.CachedDeviceBatcher(
            batching.BucketedBatcher.from_dataset(train, TRAIN_B, 2), seed=BF16_FIT_SEED,
            device="cuda")
        with tempfile.TemporaryDirectory() as save_dir:
            tr = trainer.Trainer(exp.build_model(), exp.optim, tcfg, vocab=None,
                                 save_dir=save_dir, device="cuda")
            tr.init(interop.to_torch(params_cpu, "cuda"))
            t0 = time.perf_counter()
            rows, counts = counted(kernels, lambda: list(tr.fit(train, valid, batcher,
                                                                decode_every=0)))
        nll[dt] = [r["train_nll"] for r in rows]
        print(f"bf16 fit conv_bilstm ({dt}, {len(train.x)} utterances, batch {TRAIN_B}, 3 "
              f"epochs): mean train NLL by epoch {nll[dt]!r}, valid NLL "
              f"{[r['valid_nll'] for r in rows]!r}, {time.perf_counter() - t0:.1f} s wall; "
              f"launches {counts} ({card})")
        if dt == "bfloat16":
            check_counts("bf16 fit conv_bilstm", counts,
                         tuple(BF16_OTHER_STEPS["conv_bilstm"][1]))
    for e, (a, b) in enumerate(zip(nll["bfloat16"], nll["float32"])):
        gap = abs(a - b) / abs(b)
        print(f"bf16 fit conv_bilstm epoch {e + 1}: train NLL bf16 {a!r}, float32 {b!r}, "
              f"relative {gap:.2e} (tol {BF16_FIT_NLL_RTOL})")
        if not (np.isfinite(a) and gap <= BF16_FIT_NLL_RTOL):
            raise SystemExit("bf16 fit conv_bilstm: the bf16 epoch's train NLL is not the "
                             "float32 one's")
    for dt, v in nll.items():
        if not all(later < earlier for earlier, later in zip(v, v[1:])):
            raise SystemExit(f"bf16 fit conv_bilstm: the {dt} train NLL did not fall: {v}")


def bf16_other_train_phase(kernels, card: str) -> list:
    """Phase 12 (d): bf16 training of conv_bilstm, conv_bilstm_content and
    flagship_loc. (a) the bf16 entries of K9, K11, K15 and K13 against
    their exact twins and the plain bf16 versions (bf16_parity_rows) at
    bf16_other_train_cases' shapes, twice with the same bits, with their
    device times beside the float32 kernels' and their bounds; (b) each
    configuration's bf16 step (bf16_steps, BF16_OTHER_STEPS); (c) the
    short conv_bilstm fit (bf16_conv_fit). Returns the four entries'
    {"kernels"} rows, their launches from the steps."""
    from seq2seq_attention_asr_tpu_torch.train import experiment

    t0 = time.perf_counter()
    recipes = bf16_train_recipes()
    params_cpu = {label: exp.init_params(torch.Generator().manual_seed(SEED), device="cpu")
                  for label, exp in recipes.items()}
    cases_ = bf16_other_train_cases(params_cpu, torch.Generator().manual_seed(SEED + 29))
    rows = bf16_parity_rows(cases_, card)
    del cases_
    for r in rows.values():
        r["launches"] = 0
    f32_recipes = {"conv_bilstm": experiment.timit_conv_bilstm,
                   "conv_bilstm_content": conv_bilstm_content, "flagship_loc": flagship_loc}
    for label, (b, expected, step_kernels) in BF16_OTHER_STEPS.items():
        launches = bf16_steps(kernels, label, lambda label=label: bf16_train_recipes()[label],
                              f32_recipes[label], params_cpu[label], (b,), expected,
                              step_kernels, card)
        for name in rows:
            rows[name]["launches"] += launches.get(name, 0)
    bf16_conv_fit(kernels, params_cpu["conv_bilstm"], card)
    print(f"bf16 other train phase: {time.perf_counter() - t0:.1f} s wall ({card})")
    return bf16_kernel_rows(rows)


# The instance of each kernel whose numbers stand in the {"kernels"} line:
# the one on its main path, at batch 1 (serving) or the training shape.
# Phase 15 (a) and (b): K8 with VGG's readout over a word vocabulary (its
# last layer spread over the cluster), and beams of more than 8
# hypotheses in K2 and K8 (a cluster a batch row and group).
VGG_WORDS_L = 543  # VGG's encoder positions for LS_L frames
VGG_OLD_CAP = 3124  # the largest V at K = 5 while block 0 alone took the last layer
WIDE_K = (10, 16)
WIDE_SERVE_K = 10


def k8_step_case(dec, acfg, b: int, k: int, l: int, gen, dead=None, label=None):
    """K8 at a beam step of (B, K, L) on the decoder `dec` (its V the
    config's output_depth; the LSTM's cell state drawn too): a Case whose
    bound counts the kernel's inputs (vh, h, the mask, yin and the state),
    outputs and weights once, and the products and the energies' tanh."""
    from seq2seq_attention_asr_tpu_torch import tree
    from seq2seq_attention_asr_tpu_torch.ops.cuda import attention_step

    dec_, acfg_, state, y, vh, h, mask = k2_inputs(dec, acfg, b, k, l, gen, dead)
    if acfg.cell == "lstm":
        state = (state[0], state[1], torch.randn(state[1].shape, generator=gen).cuda() * 0.3)
    args = (dec_, acfg_, state, y, vh, h, mask)
    a, s_dim, st, v = acfg.annotation_depth, acfg.score_depth, acfg.state_depth, acfg.output_depth
    # the kernel's weights: all but y_in, whose product the wrapper forms
    leaves = tree.leaves({key: val for key, val in dec.items() if key != "y_in"})
    mvs = sum(t.numel() for t in leaves if t.dim() == 2)
    esize = vh.element_size()
    return Case("fused_attention_step_loc_lstm", K8_SYMBOLS,
                lambda *xs: _step_outputs(attention_step.fused_attention_step(*xs)),
                lambda *xs: _step_outputs(attention_step.fused_attention_step_plain(*xs)), args,
                flops=b * k * (4 * l * s_dim + 2 * l * a + 2 * mvs + 3 * v),
                nbytes=esize * (b * l * (s_dim + a + 1) + 3 * b * k * st + b * k * (l + a + st)
                                + sum(t.numel() for t in leaves)) + 4 * b * k * v,
                label=label or f"fused_attention_step_loc_lstm[V={v}]")


def vgg_decoder(v: int, gen):
    """VGG's decoder (content-only GRU, maxout 64 x 7 -> linear 64 ->
    maxout 64 x 7 -> linear v): (weights on the card, its config)."""
    from seq2seq_attention_asr_tpu_torch import interop
    from seq2seq_attention_asr_tpu_torch.models import vgg
    from seq2seq_attention_asr_tpu_torch.ops import attention

    acfg = vgg.VGGConfig(output_depth=v).attention_config()
    return interop.to_torch(attention.attention_init(gen, acfg), "cuda"), acfg


def k8_vgg_words_phase(kernels, card: str) -> dict:
    """Phase 15 (a). Returns the float32 K = 5 case's numbers and plan."""
    from seq2seq_attention_asr_tpu_torch import tree
    from seq2seq_attention_asr_tpu_torch.ops.cuda import attention_step as step

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 31)
    kernel = kernels["fused_attention_step_loc_lstm"]
    kbf = kernels["fused_attention_step_loc_lstm_bf16"]
    smem_limit, resident = step.step_loc_lstm_limits(dev, False, False)
    dec, acfg = vgg_decoder(WORDS_V, gen)
    dense = step.k8_dense(step.k8_layers(acfg))
    row = None
    for k in (BEAM_K, 8):
        c = k8_step_case(dec, acfg, LS_B, k, VGG_WORDS_L, gen, dead=3 if k == BEAM_K else None,
                         label="fused_attention_step_loc_lstm[vgg]")
        tag = f"B={LS_B} K={k} L'={VGG_WORDS_L} V={WORDS_V}"
        err = checked_twice(c, kernel, tag)
        plan = step.step_loc_lstm_plan_on(LS_B, k, VGG_WORDS_L, 512, 512, 256, 0, 0, False, dense,
                                          dev)
        with torch.no_grad():
            ms = device_ms(lambda: c.kernel(*c.args), c.symbols, 20)
            plain_ms = time_ms(lambda: c.plain(*c.args), 3)
        b_ms, b_by = bound(c.flops, c.nbytes)
        stream_ms = 1e3 * LS_B * 64 * WORDS_V * 4 / PEAK_BYTES_PER_S
        print(f"time {c.label} {tag}: kernel {ms:.4f} ms on the device, plain {plain_ms:.4f} ms "
              f"per call, bound {b_ms:.4f} ms ({b_by}: {c.flops:.3e} flop, {c.nbytes:.3e} B, "
              f"each input once), the last layer's 64 x V weight streamed once a row "
              f"{stream_ms:.4f} ms (bytes), on clusters of {plan.cluster} in {plan.waves} "
              f"wave(s) (resident {resident}, {smem_limit} B a block) ({card})")
        if k == BEAM_K:
            row = dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, plan=plan)
        bf16_args = tree.tree_map(lambda a: a.to(torch.bfloat16) if isinstance(a, torch.Tensor)
                                  and a.dtype == torch.float32 else a, list(c.args))
        before = kbf.launches
        with torch.no_grad():
            got = c.kernel(*bf16_args)
            again = c.kernel(*bf16_args)
            twin = c.plain(*bf16_args)
            truth = c.plain(*upcast(bf16_args))
        torch.cuda.synchronize()
        bf16_check("fused_attention_step_loc_lstm_bf16", tag, got, twin, twin, truth)
        if kbf.launches - before != 2 or not all(torch.equal(g, a) for g, a in zip(got, again)):
            raise SystemExit(f"fused_attention_step_loc_lstm_bf16 {tag}: two calls differ or "
                             f"launch more")
        with torch.no_grad():
            bf_ms = device_ms(lambda: c.kernel(*bf16_args), c.symbols, 20)
        logp_bytes = 4 * LS_B * k * WORDS_V  # float32 either way
        bf_bound = bound(c.flops, (c.nbytes - logp_bytes) / 2 + logp_bytes)
        print(f"time fused_attention_step_loc_lstm_bf16[vgg] {tag}: kernel {bf_ms:.4f} ms on the "
              f"device, bound {bf_bound[0]:.4f} ms ({bf_bound[1]}) with bf16 inputs ({card})")
        del c, bf16_args, got, again, twin, truth
    del dec
    dec, acfg = vgg_decoder(VGG_OLD_CAP + 1, gen)
    checked_twice(k8_step_case(dec, acfg, 4, BEAM_K, VGG_WORDS_L, gen, dead=1), kernel,
                  f"B=4 K={BEAM_K} L'={VGG_WORDS_L} V={VGG_OLD_CAP + 1} (one past the old cap)")
    vgg_cap = lambda k, c: step.step_loc_lstm_vocab_cap(k, VGG_WORDS_L, 512, 512, 256, 0, 0, c,
                                                        False, dense, smem_limit)
    cap = vgg_cap(8, 16)
    dec, acfg = vgg_decoder(cap, gen)
    checked_twice(k8_step_case(dec, acfg, 1, 8, VGG_WORDS_L, gen), kernel,
                  f"b=1 K=8 L'={VGG_WORDS_L} V={cap} (the cap on clusters of 16)")
    dec_over, acfg_over = vgg_decoder(cap + 1, gen)
    over = k2_inputs(dec_over, acfg_over, 1, 8, VGG_WORDS_L, gen)
    before = kernel.launches
    try:
        step.fused_attention_step(*over)
    except RuntimeError as e:
        print(f"refuse fused_attention_step_loc_lstm[vgg] b=1 K=8 L'={VGG_WORDS_L} V={cap + 1}: "
              f"{e}")
    else:
        raise SystemExit(f"fused_attention_step_loc_lstm took V={cap + 1} at K=8, over its cap")
    if kernel.launches != before:
        raise SystemExit("fused_attention_step_loc_lstm launched on a refused shape")
    print(f"K8 with VGG's readout: V caps at L'={VGG_WORDS_L} on the card's {smem_limit} B a "
          f"block, clusters of 16: K=5 {vgg_cap(5, 16)}, K=8 {cap}; clusters of 8: K=5 "
          f"{vgg_cap(5, 8)}, K=8 {vgg_cap(8, 8)}; "
          f"phase 15 (a) {time.perf_counter() - t0:.1f} s wall ({card})")
    return row


def wide_beam_phase(kernels, model, params, cb_dec, cb_acfg, pcms, mean, std, card: str):
    """Phase 15 (b). Returns the largest max abs errors of K2 and K8."""
    from seq2seq_attention_asr_tpu_torch.data import features
    from seq2seq_attention_asr_tpu_torch.ops.cuda import attention_step as step

    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(SEED + 32)
    dev = torch.device("cuda")
    acfg = model.cfg.attention_config()
    errs = {"fused_attention_step": 0.0, "fused_attention_step_loc_lstm": 0.0}
    for k in WIDE_K:
        c = k2_step_case(params["decoder"], acfg, 2, k, SERVE_L, gen, dead=1)
        plan = step.step_plan_on(2, k, SERVE_L, 512, 512, 256, 64, 7, acfg.output_depth, dev)
        tag = (f"B=2 K={k} L={SERVE_L} (row 1 fully masked; {step.hyp_groups(k)[0]} groups a "
               f"row, on clusters of {plan.cluster} in {plan.waves} wave(s))")
        errs[c.name] = max(errs[c.name], checked_twice(c, kernels[c.name], tag))
        c = k8_step_case(cb_dec, cb_acfg, 2, k, CB_SERVE_L, gen, dead=1,
                         label="fused_attention_step_loc_lstm[lstm+loc]")
        tag = f"B=2 K={k} L'={CB_SERVE_L} (row 1 fully masked)"
        errs[c.name] = max(errs[c.name], checked_twice(c, kernels[c.name], tag))
    max_steps = features.frames_for_samples(len(pcms[0])) + 2 * PAD_FRAMES
    serve_requests(f"chorowski K={WIDE_SERVE_K}", model, {"random": params},
                   [("random", False, 4)], pcms,
                   dict(eos_id=EOS_ID, mean=mean, std=std, beam_k=WIDE_SERVE_K), kernels,
                   lambda exact, steps: {"bigru_scan2": 3, "fused_attention_step": steps,
                                         "stft_logmel_power": 1}, max_steps)
    print(f"phase 15 (b) {time.perf_counter() - t0:.1f} s wall ({card})")
    return errs


# Phase 15 (c): the port's corpus readers, from FLAC on disk to a
# word-vocabulary VGG epoch and its beam on the card.
CORPUS = dict(n_train=160, n_valid=16, min_frames=80, max_frames=200, min_words=30, max_words=60,
              lexicon=8000, workers=8)


def corpus_speech(n: int, seed: int) -> np.ndarray:
    """n samples of speech-like 16-bit PCM (make_pcm's harmonics under a
    syllable envelope, plus noise), from `seed`."""
    rng = np.random.RandomState(seed)
    t = np.arange(n) / SR
    f0 = rng.uniform(90, 220) * (1 + 0.1 * np.sin(2 * np.pi * rng.uniform(0.5, 2) * t))
    phase = 2 * np.pi * np.cumsum(f0) / SR
    voiced = sum(np.sin(k * phase) / k for k in range(1, 8))
    env = 0.5 * (1 + np.sin(2 * np.pi * rng.uniform(3, 6) * t + rng.uniform(0, 6)))
    return ((0.2 * env * voiced + 0.02 * rng.randn(n)) * 32767).astype(np.int32)


def corpus_write_flac(job) -> None:
    """A worker: one utterance's PCM encoded by tests/flac_encoder.py."""
    path, n, seed = job
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "tests"))
    from flac_encoder import encode_flac

    with open(path, "wb") as f:
        f.write(encode_flac(corpus_speech(n, seed), blocksize=4096))


def corpus_decode_py(path: str):
    """A worker: one file through the pure-Python FLAC decoder."""
    from seq2seq_attention_asr_tpu_torch.data import flac

    with open(path, "rb") as f:
        data = f.read()
    return flac.decode_flac_py(data)


def corpus_tree(root: str, pool) -> list:
    """The LibriSpeech layout under root: train/ (CORPUS n_train
    utterances over 8 speakers) and valid/ (n_valid over 2), FLAC audio
    of min_frames..max_frames frames and <speaker>-<chapter>.trans.txt
    lines of min_words..max_words words drawn from a lexicon of
    synthetic words; encoded in `pool`. Returns the FLAC paths."""
    rng = np.random.RandomState(SEED + 33)
    letters = np.array(list("ABCDEFGHIJKLMNOPQRSTUVWXYZ"))
    lexicon = set()
    while len(lexicon) < CORPUS["lexicon"]:
        lexicon.add("".join(rng.choice(letters, rng.randint(3, 10))))
    lexicon = sorted(lexicon)
    jobs = []
    for split, n, speakers in (("train", CORPUS["n_train"], 8), ("valid", CORPUS["n_valid"], 2)):
        per = n // speakers
        for s in range(speakers):
            spk, chap = f"{100 + s + (50 if split == 'valid' else 0)}", f"{1000 + s}"
            d = os.path.join(root, split, spk, chap)
            os.makedirs(d)
            lines = []
            for u in range(per):
                uid = f"{spk}-{chap}-{u:04d}"
                frames = rng.randint(CORPUS["min_frames"], CORPUS["max_frames"] + 1)
                n_samples = (frames - 1) * HOP + rng.randint(0, HOP)
                words = rng.choice(len(lexicon), rng.randint(CORPUS["min_words"],
                                                             CORPUS["max_words"] + 1))
                lines.append(f"{uid} " + " ".join(lexicon[w] for w in words))
                jobs.append((os.path.join(d, uid + ".flac"), n_samples, int(rng.randint(1 << 30))))
            with open(os.path.join(d, f"{spk}-{chap}.trans.txt"), "w") as f:
                f.write("\n".join(lines) + "\n")
    pool.map(corpus_write_flac, jobs)
    return [p for p, _, _ in jobs]


def corpus_phase(kernels, card: str) -> dict:
    """Phase 15 (c). Returns the evaluation's K8 launches and V."""
    import hashlib
    import multiprocessing
    import tempfile

    from seq2seq_attention_asr_tpu_torch.data import batching, features, flac
    from seq2seq_attention_asr_tpu_torch.data import librispeech as ls
    from seq2seq_attention_asr_tpu_torch.data import timit
    from seq2seq_attention_asr_tpu_torch.decode import metrics
    from seq2seq_attention_asr_tpu_torch.native import build as native_build
    from seq2seq_attention_asr_tpu_torch.native import editdist, flacdec
    from seq2seq_attention_asr_tpu_torch.train import experiment, trainer

    t0 = time.perf_counter()
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as root, ctx.Pool(CORPUS["workers"]) as pool:
        paths = corpus_tree(root, pool)
        t_tree = time.perf_counter() - t0
        roots = {"train": os.path.join(root, "train"), "valid": os.path.join(root, "valid")}
        t1 = time.perf_counter()
        before = flacdec.decodes
        datasets, vocab, mean, std = ls.build_datasets(roots, feature_fn=features.logmel_stacked_np,
                                                       pad=1, labelset="words")
        decodes = flacdec.decodes - before
        t_build = time.perf_counter() - t1
        # The same walk and build through the pure-Python decoder (its
        # decodes made in the pool, looked up by the file's bytes).
        py = dict(zip(paths, pool.map(corpus_decode_py, paths)))
        by_bytes, same_pcm = {}, True
        for p in paths:
            with open(p, "rb") as f:
                data = f.read()
            by_bytes[hashlib.sha1(data).hexdigest()] = py[p]
            native, sr = flac.decode_flac(data)
            same_pcm = same_pcm and sr == py[p][1] and np.array_equal(native, py[p][0])
        native_decode = flac.decode_flac
        flac.decode_flac = lambda data: by_bytes[hashlib.sha1(data).hexdigest()]
        try:
            py_sets, py_vocab, py_mean, py_std = ls.build_datasets(
                roots, feature_fn=features.logmel_stacked_np, pad=1, labelset="words")
        finally:
            flac.decode_flac = native_decode
    same_features = all(
        datasets[s].uids == py_sets[s].uids
        and all(np.array_equal(a, b) for a, b in zip(datasets[s].x, py_sets[s].x))
        and all(np.array_equal(a, b) for a, b in zip(datasets[s].y, py_sets[s].y))
        for s in datasets) and np.array_equal(mean, py_mean) and np.array_equal(std, py_std)
    v = vocab.num_words
    n_train, n_valid = len(datasets["train"]), len(datasets["valid"])
    print(f"corpus: {n_train} train and {n_valid} valid FLAC utterances written in {t_tree:.1f} s "
          f"({CORPUS['workers']} processes); walked, decoded and featurized in {t_build:.1f} s "
          f"(native FLAC decodes {decodes}, native libraries built in "
          f"{ {k: round(s, 2) for k, s in native_build.BUILD_SECONDS.items()} } s); word "
          f"vocabulary V={v} (<eos> last: {list(vocab.wordmap)[-1] == ls.EOS}); decode_flac_py "
          f"gives the same PCM: {same_pcm}, the same features: {same_features}")
    if decodes != len(paths) or not (same_pcm and same_features) or v <= VGG_OLD_CAP or \
            (n_train, n_valid) != (CORPUS["n_train"], CORPUS["n_valid"]):
        raise SystemExit("corpus: the port's readers disagree, or the word vocabulary is small")
    for ds in datasets.values():  # (3, L, 40) -> (L, 40, 3), NHWC as vgg.encode takes it
        ds.x[:] = [np.ascontiguousarray(np.transpose(f, (1, 2, 0)), np.float32) for f in ds.x]
    train, valid = datasets["train"], datasets["valid"]
    half = n_train // 2
    chunks = [timit.Dataset(uids=train.uids[lo:hi], x=train.x[lo:hi], y=train.y[lo:hi], y39=None,
                            start=train.start[lo:hi], finish=train.finish[lo:hi])
              for lo, hi in ((0, half), (half, n_train))]
    exp = experiment.librispeech_vgg(v)
    tcfg = dataclasses.replace(exp.train, num_epochs=1)
    batcher_fn = lambda ds: batching.BucketedBatcher.from_dataset(ds, tcfg.batch_size, 2)
    valid_batcher = batching.BucketedBatcher.from_dataset(valid, tcfg.batch_size, 2)
    with tempfile.TemporaryDirectory() as save:
        tr = trainer.Trainer(exp.build_model(), exp.optim, tcfg, save_dir=save, device="cuda")
        tr.init(exp.init_params(torch.Generator().manual_seed(SEED), device="cuda"))
        t2 = time.perf_counter()
        chunked = (lambda i: chunks[i], 2, batcher_fn)
        rows, fit_counts = counted(kernels, lambda: list(tr.fit(
            None, valid, valid_batcher, decode_every=0, chunked=chunked)))
        t_fit = time.perf_counter() - t2
        check_counts("corpus fit librispeech_vgg", fit_counts,
                     ("attention_decode_scan_fwd", "attention_decode_scan_bwd"))
        scored = []
        native_bed = metrics.batch_edit_distance

        def both(pred, plen, targets, y_len):
            d = native_bed(pred, plen, targets, y_len)
            d_np = np.array([metrics.edit_distance_np(pred[i, :int(plen[i])],
                                                      targets[i, :int(y_len[i])])
                             for i in range(len(d))])
            scored.append((d, d_np, np.maximum(np.asarray(y_len), 1)))
            return d

        metrics.batch_edit_distance = both
        ed_before = editdist.calls
        t3 = time.perf_counter()
        try:
            ev, ev_counts = counted(kernels, lambda: tr.evaluate(valid, valid_batcher, decode=True))
        finally:
            metrics.batch_edit_distance = native_bed
        t_eval = time.perf_counter() - t3
    wer = float(np.mean(np.concatenate([d / n for d, _, n in scored])))
    wer_np = float(np.mean(np.concatenate([d / n for _, d, n in scored])))
    row = rows[-1]
    print(f"corpus fit librispeech_vgg V={v}, one epoch over 2 chunks of {half}: row "
          f"{ {k: row[k] for k in ('train_nll', 'valid_nll', 'valid_accuracy')} }, "
          f"launches {fit_counts}, {t_fit:.1f} s wall ({card})")
    print(f"corpus evaluate librispeech_vgg K={tcfg.beam_k} V={v} on {n_valid} held-out "
          f"utterances: WER {ev['valid_per']:.4f} (native edit distance {wer:.6f}, numpy "
          f"{wer_np:.6f}; {editdist.calls - ed_before} native calls), launches {ev_counts}, "
          f"{t_eval:.1f} s wall ({card})")
    check_counts("corpus evaluate librispeech_vgg", ev_counts,
                 ("attention_decode_scan_fwd", "fused_attention_step_loc_lstm"))
    if not (all(np.array_equal(d, dn) for d, dn, _ in scored) and wer == wer_np
            and abs(wer - ev["valid_per"]) <= 1e-12 and np.isfinite(row["train_nll"])
            and editdist.calls - ed_before == len(scored) > 0):
        raise SystemExit("corpus: the native WER differs from numpy's, or the run is not finite")
    print(f"phase 15 (c) {time.perf_counter() - t0:.1f} s wall ({card})")
    return {"launches": ev_counts["fused_attention_step_loc_lstm"], "v": v}


def readers_and_wide_beams_phase(kernels, errs: dict, model, params, cb_dec, cb_acfg, pcms,
                                 mean, std, card: str) -> None:
    """Phase 15: (a) K8 over VGG's word vocabulary, (b) beams of more than 8
    hypotheses, (c) the corpus readers to a VGG epoch and its beam."""
    t0 = time.perf_counter()
    vgg_row = k8_vgg_words_phase(kernels, card)
    errs["fused_attention_step_loc_lstm"] = max(errs["fused_attention_step_loc_lstm"],
                                                vgg_row["err"])
    for name, err in wide_beam_phase(kernels, model, params, cb_dec, cb_acfg, pcms, mean, std,
                                     card).items():
        errs[name] = max(errs[name], err)
    corpus = corpus_phase(kernels, card)
    plan = vgg_row["plan"]
    print(f"K8 over VGG's words: B={LS_B} K={BEAM_K} L'={VGG_WORDS_L} V={WORDS_V} kernel "
          f"{vgg_row['ms']:.4f} ms, plain {vgg_row['plain_ms']:.4f} ms, bound "
          f"{vgg_row['bound_ms']:.4f} ms ({vgg_row['bound_by']}), clusters of {plan.cluster} in "
          f"{plan.waves} wave(s); the corpus beam (V={corpus['v']}) launched it "
          f"{corpus['launches']} times; phase 15 {time.perf_counter() - t0:.1f} s wall ({card})")


MAIN_LABEL = {"fused_attention_step_loc_lstm": "fused_attention_step_loc_lstm[lstm+loc]"}


def front_end_ops(pcm, mean, std, card: str) -> None:
    """Phase 8: the device time of a served exact=False b=1 request's front
    end (features.logmel_device on the PCM packed into its 112-frame
    bucket, as serve.Transcriber calls it), by device op: K3, the reflect
    pad and the PyTorch ops of features.assemble (profiler, 50 calls)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    from seq2seq_attention_asr_tpu_torch import serve
    from seq2seq_attention_asr_tpu_torch.data import features

    t0 = time.perf_counter()
    n_frames = features.frames_for_samples(len(pcm))
    x, _, _ = serve.pack_bucket([pcm], [0], [n_frames], -(-n_frames // 16) * 16)
    y = torch.from_numpy(x).cuda()
    kw = dict(device="cuda", dtype=torch.float32)
    mean_t, std_t = torch.as_tensor(mean, **kw), torch.as_tensor(std, **kw)
    call = lambda: features.logmel_device(y, SR, mean=mean_t, std=std_t)
    iters = 50
    with torch.no_grad():
        call()
        torch.cuda.synchronize()
        with traced([ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                call()
    by_op = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n, us = by_op.get(e.name, (0, 0.0))
            by_op[e.name] = (n + 1, us + e.time_range.elapsed_us())
    total = sum(us for _, us in by_op.values()) / iters / 1e3
    ops = sum(n for n, _ in by_op.values()) / iters
    print(f"time front end of a served exact=False b=1 request: {total:.4f} ms on the device in "
          f"{ops:.0f} device ops a call, traced in {time.perf_counter() - t0:.2f} s ({card}); "
          "by op: " + "; ".join(
              f"{name[:70]} x{n / iters:.0f} {us / iters / 1e3:.4f} ms"
              for name, (n, us) in sorted(by_op.items(), key=lambda kv: -kv[1][1])))


def serve_setup():
    """The test PCM (8 utterances), its features, and their mean and std."""
    from seq2seq_attention_asr_tpu_torch.data import features

    pcms = make_pcm(8, SEED + 2)
    feats = features.logmel_rfft(torch.from_numpy(np.stack(pcms)), SR)
    return pcms, feats, feats.mean(dim=(0, 1)).numpy(), feats.std(dim=(0, 1)).numpy()


def tree_timing() -> dict:
    """For the port's package first on sys.path: the time per wrapper call
    (CUDA events; a fresh process's first profiler trace can drop
    records) and the device time (profiler) of the forward walks' kernels
    K1, K16 and K18 at FWD_WALK_SHAPES and K7 at LSTM_WALK_SHAPES, of the
    flagship's beam step
    K2 and of K8's two instances on the flagship's widths at the serving
    shape, b=1 and 8, and of K8's <LSTM, location> instance at the
    conv+BiLSTM serving shape; the flagship's and the conv+BiLSTM
    recipe's serving p50 and device time of one request (exact=False, b=1
    and 8);
    of each teacher-forced decoder scan, forward and backward (K4, K5,
    K10-K15), at its recipe's training shape at B=16 and 128, and the
    device time of K4, K5, K10-K12, K14 and K15 (every device op of a
    call); the p50 train step of each trained configuration at B=16
    and 128; and K3 on the 3.5 s bucket at b=1 and 8."""
    from seq2seq_attention_asr_tpu_torch import interop
    from seq2seq_attention_asr_tpu_torch.models import registry
    from seq2seq_attention_asr_tpu_torch.ops.cuda import logmel
    from seq2seq_attention_asr_tpu_torch.train import experiment

    out = {}
    for name, b, l, _, args, fn, _ in fwd_walk_cases():
        with torch.no_grad():
            out[f"{name} B={b} L={l} ms per call"] = time_ms(lambda: fn(*args), 20)
            out[f"{name} B={b} L={l} device ms"] = device_ms(lambda: fn(*args),
                                                            (FWD_WALKS[name][0],), 20)
    gen = torch.Generator().manual_seed(SEED + 1)
    model = registry.build("chorowski")
    params = model.init(torch.Generator().manual_seed(SEED), device="cuda")
    loc_dec = registry.build("chorowski", feature_maps=16, filt_size=10).init(
        torch.Generator().manual_seed(SEED))["decoder"]
    for b in (1, 8):
        for c in cases(params, model.cfg, loc_dec, b, gen):
            if c.name.startswith("fused_attention_step"):
                with torch.no_grad():
                    out[f"{c.label} B={b} ms per call"] = time_ms(lambda: c.kernel(*c.args), 200)
                    out[f"{c.label} B={b} device ms"] = device_ms(lambda: c.kernel(*c.args),
                                                                  c.symbols, 200)
    pcms, feats, mean, std = serve_setup()
    kw = dict(eos_id=EOS_ID, mean=mean, std=std, beam_k=BEAM_K)
    served = serve_timing("chorowski", model, params, pcms, kw, [(False, 1), (False, 8)], "")
    for (_, b), (p50, busy) in served.items():
        out[f"chorowski serve b={b} p50 ms"] = p50
        out[f"chorowski serve b={b} device ms a request"] = busy
    del params
    # The conv+BiLSTM recipe: K8's <LSTM, location> instance at its serving
    # shape, and its requests.
    cb_exp = experiment.timit_conv_bilstm()
    cb_model = cb_exp.build_model()
    cb_params = interop.to_torch(
        cb_exp.init_params(torch.Generator().manual_seed(SEED), device="cpu"), "cuda")
    noloc_dec = registry.build("conv_bilstm", feature_maps=0).init(
        torch.Generator().manual_seed(SEED))["decoder"]
    norm = ((feats - torch.from_numpy(mean)) / torch.from_numpy(std)).cuda()
    for b in (1, 8):
        cb_cases, _ = conv_bilstm_cases(cb_params, cb_model.cfg, noloc_dec, norm[:b], gen)
        c = next(c for c in cb_cases if c.label == MAIN_LABEL["fused_attention_step_loc_lstm"])
        with torch.no_grad():
            out[f"{c.label} conv_bilstm B={b} ms per call"] = time_ms(lambda: c.kernel(*c.args),
                                                                     200)
            out[f"{c.label} conv_bilstm B={b} device ms"] = device_ms(lambda: c.kernel(*c.args),
                                                                      c.symbols, 200)
    served = serve_timing("conv_bilstm", cb_model, cb_params, pcms, kw, [(False, 1), (False, 8)],
                          "")
    for (_, b), (p50, busy) in served.items():
        out[f"conv_bilstm serve b={b} p50 ms"] = p50
        out[f"conv_bilstm serve b={b} device ms a request"] = busy
    del cb_params
    for recipe, make_cases, label in (
            (experiment.timit_chorowski_normnll_colnorm, train_cases, "chorowski"),
            (experiment.timit_conv_bilstm, cb_train_cases, "conv_bilstm"),
            (flagship_loc, loc_train_cases, "flagship_loc"),
            (conv_bilstm_content, cbc_train_cases, "conv_bilstm_content")):
        params_cpu = recipe().init_params(torch.Generator().manual_seed(SEED), device="cpu")
        params = interop.to_torch(params_cpu, "cuda")
        for b in (TRAIN_B, BIG_B):
            for c in make_cases(params, recipe().build_model().cfg, train_batch(b, SEED + 3), gen):
                if c.name.startswith("attention_decode_scan") and (
                        b == TRAIN_B or c.backward or c.name in FWD_SCANS):
                    with torch.no_grad():
                        out[f"{c.name} B={b} ms per call"] = time_ms(lambda: c.kernel(*c.args), 10)
                        if c.name in WALK_BWDS or c.name in FWD_SCANS:  # every device op of a call
                            out[f"{c.name} B={b} device ms"] = device_ms(
                                lambda: c.kernel(*c.args), None, 10)
        del params
        for b in (TRAIN_B, BIG_B):
            out[f"{label} step B={b} p50 ms"] = statistics.median(timed_steps(recipe, params_cpu,
                                                                            b)[0])
    for b in (1, 8):
        yp = k3_input(b, torch.Generator().manual_seed(SEED + 4))
        call = lambda: logmel.stft_logmel_power(yp, SR)
        with torch.no_grad():
            out[f"stft_logmel_power B={b} ms per call"] = time_ms(call, 200)
            out[f"stft_logmel_power B={b} device ms"] = device_ms(call, ("stft_logmel_kernel",),
                                                                  200)
    return out


def compare_trees(parent: str, card: str) -> None:
    """tree_timing of the checkout `parent` and of this one, each in a
    process of its own, in the order parent, this, this, parent."""
    here = str(pathlib.Path(__file__).resolve().parent)
    runs = {parent: [], here: []}
    torch.cuda.empty_cache()
    for tree in (parent, here, here, parent):
        out = subprocess.run([sys.executable, __file__, "--time-tree", tree],
                             capture_output=True, text=True, timeout=900)
        if out.returncode != 0:
            raise SystemExit(f"tree timing of {tree} failed ({out.returncode}):\n"
                             f"{out.stderr[-4000:]}")
        line = next(x for x in out.stdout.splitlines() if x.startswith("tree-timing "))
        runs[tree].append(json.loads(line[len("tree-timing "):]))
    for key in runs[here][0]:
        print(f"compare {key}: parent {', '.join(f'{r[key]:.4f}' for r in runs[parent])}; "
              f"this tree {', '.join(f'{r[key]:.4f}' for r in runs[here])} ({card})")


# Phase 16: the bf16 entries of K16-K19 (a), and the mesh trainer of
# parallel/: a world of one NCCL rank (b), then two gloo ranks that share
# the card (c). (a) holds each entry to its exact twin within BF16_ULPS and
# to the float32 result by the ground-truth rule at the flagship encoder's
# first layer, B = TRAIN_B, L = TRAIN_L, H = 256 (bf16_parity_rows, one
# launch a call, two calls with the same bits), then runs the bf16 flagship
# encoder by one gru_layer per direction (K16, K17) and by the stacked
# scan (K18, K19), forward and backward, the launch counts zeroed just
# before: these are the entries' launches in the kernels line. (b) holds a
# full-width flagship Trainer(mesh=make_mesh(dp=1)) over a one-rank NCCL
# group to the meshless Trainer from the same weights and seed: MESH_STEPS
# steps at B = TRAIN_B and a K = BEAM_K evaluation, bit for bit, and the
# same launches. (c) spawns two ranks (multihost.spawn, gloo: NCCL refuses
# two ranks on one card, so every collective is staged through the host):
# dp = 2, MESH_STEPS flagship steps of 8 rows each, against the
# single-rank steps on the card (TRAIN_RTOL, and 1e-5 at the first step),
# each rank launching K1, K6, K4 and K5 as a step does; sp = 2, the
# teacher-forced decode of flagship_loc (16 feature maps, filter 10: the
# halo crosses the shard edge) on the encoder's output at full width, L =
# TRAIN_L, its forward and gradients against K12's and K13's on one rank.
# Two ranks on one card measure correctness, not scaling.
MESH_STEPS = 3
MESH_EVAL = dict(n_train=32, n_valid=16, batch=16, seed=4)
MESH_TIMEOUT = 300.0  # seconds for the two spawned ranks, their start included
SP_FWD_RTOL, SP_GRAD_RTOL = 2e-5, 5e-4  # of max |single-rank result|, per output
DP_STEP_RTOL1 = 1e-5  # the first step's metrics (tests/test_torch_train.py); TRAIN_RTOL after
BF16_GRU_SYMBOLS = {"gru_scan_bf16": ("gru1_walk_fwd_bf16_kernel",),
                    "bigru_scan_bf16": ("gru2_stacked_fwd_bf16_kernel",),
                    "gru_scan_bwd_bf16": ("gru1_walk_bwd_bf16_kernel",) + GRU_GATES
                    + ("atb_kernel",),
                    "bigru_scan_bwd_bf16": ("gru2_stacked_bwd_bf16_kernel",) + GRU_GATES
                    + ("atb_kernel",)}
BF16_SYMBOLS.update(BF16_GRU_SYMBOLS)
F32_SYMBOLS.update({"gru_scan_bf16": ("gru1_walk_fwd_kernel",),
                    "bigru_scan_bf16": ("gru2_stacked_fwd_kernel",),
                    "gru_scan_bwd_bf16": ("gru1_walk_bwd_kernel",) + GRU_GATES + ("atb_kernel",),
                    "bigru_scan_bwd_bf16": ("gru2_stacked_bwd_kernel",) + GRU_GATES
                    + ("atb_kernel",)})
BF16_ENC_LAUNCHES = {"per_direction": {"gru_scan_bf16": 6, "gru_scan_bwd_bf16": 6},
                     "stacked": {"bigru_scan_bf16": 3, "bigru_scan_bwd_bf16": 3}}


def bf16_gru_cases(enc_cpu, gen):
    """The bf16 entries' inputs on the card: the flagship encoder's first
    layer in bf16 over the training batch (B = TRAIN_B, L = TRAIN_L),
    projected as the stacked path projects it, nonzero bf16 initial
    states, the backward's states from the plain bf16 forward and a bf16
    cotangent: {name: [(tag, args, flops, nbytes, None)]}, the bounds with
    bf16 IO."""
    from seq2seq_attention_asr_tpu_torch import interop

    enc = interop.to_torch(enc_cpu, "cuda")
    x, lens = (t.cuda() for t in train_batch(TRAIN_B, SEED + 3)[:2])
    c32 = gru_scan_cases(enc, x, lens, gen)
    bf = torch.bfloat16
    fwd = {c.name: c for c in c32}
    xproj2, h02, wzr2, wh2 = (t.to(bf) for t in fwd["bigru_scan"].args)
    from seq2seq_attention_asr_tpu_torch.ops.cuda import gru_scan

    with torch.no_grad():
        ys2 = gru_scan.bigru_scan_plain(xproj2, h02, wzr2, wh2)
    h_prevs2 = torch.cat([h02[:, :, None], ys2[:, :, :-1]], dim=2).contiguous()
    dys2 = fwd["bigru_scan_bwd"].args[2].to(bf)
    tag = f"B={TRAIN_B} L={TRAIN_L} H={wh2.shape[-1]}"
    half = lambda c: (c.flops, c.nbytes / 2)  # the float32 cases' bytes at 2 bytes an element
    one = lambda *ts: tuple(t[0] for t in ts)
    return {
        "gru_scan_bf16": [(tag, one(xproj2, h02, wzr2, wh2), *half(fwd["gru_scan"]), None)],
        "gru_scan_bwd_bf16": [(tag, one(xproj2, h_prevs2, dys2, wzr2, wh2),
                               *half(fwd["gru_scan_bwd"]), None)],
        "bigru_scan_bf16": [(tag, (xproj2, h02, wzr2, wh2), *half(fwd["bigru_scan"]), None)],
        "bigru_scan_bwd_bf16": [(tag, (xproj2, h_prevs2, dys2, wzr2, wh2),
                                 *half(fwd["bigru_scan_bwd"]), None)],
    }


def bf16_encoder_launches(kernels, enc_cpu) -> dict:
    """(a)'s main path: the bf16 flagship encoder on the training batch by
    one rnn.gru_layer per direction and by the stacked scan, forward and
    backward, each run with the launch counts zeroed just before: exactly
    BF16_ENC_LAUNCHES and no other kernel; bf16 outputs and gradients,
    finite, and each output by the ground-truth rule against the float32
    encoder (bigru_layer) beside the bf16 bigru_layer's (K1, K6 bf16).
    Returns {name: launches} of the four entries."""
    from seq2seq_attention_asr_tpu_torch import interop
    from seq2seq_attention_asr_tpu_torch.models.chorowski import cast_float32
    from seq2seq_attention_asr_tpu_torch.ops.masking import length_mask

    x, x_len = (t.cuda() for t in train_batch(TRAIN_B, SEED + 3)[:2])
    enc32 = interop.to_torch(enc_cpu, "cuda")
    enc16 = cast_float32(enc32, torch.bfloat16)
    width = 2 * enc_cpu["bigru3"]["fwd"]["w_h"].shape[1]
    cot = torch.randn(TRAIN_B, TRAIN_L, width, generator=torch.Generator().manual_seed(SEED + 7))
    cot = cot.cuda()
    valid = length_mask(x_len, TRAIN_L)[:, :, None].expand(-1, -1, width).bool()
    truth, _ = encoder_call("bigru_layer", enc32, x, x_len, cot)()
    k1_16, _ = encoder_call("bigru_layer", enc16, x.bfloat16(), x_len, cot.bfloat16())()
    launches = {}
    for path, expected in BF16_ENC_LAUNCHES.items():
        call = encoder_call(path, enc16, x.bfloat16(), x_len, cot.bfloat16())
        (out, grads), counts = counted(kernels, call)
        check_counts(f"bf16 encoder {path}", counts, tuple(expected), expected)
        launches.update(expected)
        finite = bool(torch.isfinite(out.float()).all()) and all(
            bool(torch.isfinite(g.float()).all()) for g in grads)
        dtypes = {g.dtype for g in grads} | {out.dtype}
        kd, pd = rel_dist(out[valid], truth[valid]), rel_dist(k1_16[valid], truth[valid])
        print(f"bf16 encoder {path} B={TRAIN_B} L={TRAIN_L}: launches "
              f"{ {n: c for n, c in counts.items() if c} }, output and {len(grads)} gradients "
              f"in {sorted(str(d) for d in dtypes)}, finite={finite}; rel L2 from the float32 "
              f"encoder at valid positions {kd:.3e}, the bf16 bigru_layer's {pd:.3e} "
              f"(<= 2 x + 0.02)")
        if not finite or dtypes != {torch.bfloat16} or not kd <= 2.0 * pd + 0.02:
            raise SystemExit(f"bf16 encoder {path}: not finite, not bf16, or off the float32 "
                             f"encoder")
    return launches


def mesh_eval_split():
    """A small TIMIT-shaped valid split, its batcher and vocabulary."""
    from seq2seq_attention_asr_tpu_torch.data import batching, synthetic

    m = MESH_EVAL
    train, valid, vocab = synthetic.timit_shaped(m["n_train"], m["n_valid"], seed=m["seed"])
    return valid, batching.BucketedBatcher.from_dataset(train, m["batch"], n_buckets=1), vocab


def mesh_trainer_run(kernels, train_params, mesh, batch, valid, batcher, vocab):
    """MESH_STEPS flagship steps from `train_params` (Trainer, with `mesh`
    or without), then a K = BEAM_K evaluation, each with the launch counts
    zeroed just before: ([(metrics, counts)], (eval row, counts), the
    train params after)."""
    from seq2seq_attention_asr_tpu_torch import tree
    from seq2seq_attention_asr_tpu_torch.train import experiment, trainer

    exp = experiment.timit_chorowski_normnll_colnorm()
    tr = trainer.Trainer(exp.build_model(), exp.optim, exp.train, vocab=vocab, device="cuda",
                         mesh=mesh)
    tr.init(train_params)
    arrs = tuple(t.cuda() for t in batch)
    steps = []
    for _ in range(MESH_STEPS):
        (tr.state, m), counts = counted(kernels, lambda: tr.step_fn(tr.state, arrs))
        steps.append(({k: float(v) for k, v in m.items()}, counts))
    row, counts = counted(kernels, lambda: tr.evaluate(valid, batcher))
    row.pop("valid_seconds")
    return steps, (row, counts), [t.cpu() for t in tree.leaves(tr.state[0])]


def mesh_one_rank(kernels, train_params, card: str) -> None:
    """(b): a one-rank NCCL group (a HashStore, no network), the mesh
    trainer on it against the meshless trainer: every step's metrics and
    the evaluation's row equal (bit for bit; where a sum were reordered,
    within 1e-6 relative), the parameters after bit for bit, and the same
    launches at every step and in the evaluation."""
    import torch.distributed as dist

    from seq2seq_attention_asr_tpu_torch.parallel import make_mesh

    batch = train_batch(TRAIN_B, SEED + 3)
    valid, batcher, vocab = mesh_eval_split()
    dist.init_process_group("nccl", store=dist.HashStore(), world_size=1, rank=0)
    try:
        mesh = make_mesh(dp=1)
        runs = {label: mesh_trainer_run(kernels, train_params, m, batch, valid, batcher, vocab)
                for label, m in (("meshless", None), ("mesh", mesh))}
    finally:
        dist.destroy_process_group()
    (s0, e0, p0), (s1, e1, p1) = runs["meshless"], runs["mesh"]
    worst = 0.0
    for i, ((m0, c0), (m1, c1)) in enumerate(zip(s0, s1)):
        rel = max(abs(m1[k] - m0[k]) / max(abs(m0[k]), 1e-30) for k in m0)
        worst = max(worst, rel)
        print(f"mesh dp=1 (one NCCL rank) step {i + 1}: {m1}, meshless {m0}; largest relative "
              f"difference {rel:.3e}; launches equal: {c0 == c1} "
              f"{ {n: c for n, c in c1.items() if c} }")
        if set(m0) != set(m1) or rel > 1e-6 or c0 != c1:
            raise SystemExit(f"mesh dp=1 step {i + 1} differs from the meshless step")
    same = all(torch.equal(a, b) for a, b in zip(p0, p1))
    erel = max(abs(e1[0][k] - e0[0][k]) / max(abs(e0[0][k]), 1e-30) for k in e0[0])
    print(f"mesh dp=1 evaluation (K={BEAM_K}, {MESH_EVAL['n_valid']} utterances): {e1[0]}, "
          f"meshless {e0[0]}; largest relative difference {erel:.3e}; launches equal: "
          f"{e0[1] == e1[1]} { {n: c for n, c in e1[1].items() if c} }; parameters after "
          f"{MESH_STEPS} steps bit for bit: {same}; the steps' largest relative difference "
          f"{worst:.3e} ({card})")
    if set(e0[0]) != set(e1[0]) or erel > 1e-6 or e0[1] != e1[1] or not same:
        raise SystemExit("mesh dp=1 evaluation or parameters differ from the meshless trainer")


def sp_decode_inputs(loc_params_cpu):
    """flagship_loc's decoder and the encoder's output on the training
    batch (on the card, K1), with the labels: numpy arrays."""
    from seq2seq_attention_asr_tpu_torch import interop

    model = flagship_loc().build_model()
    params = interop.to_torch(loc_params_cpu, "cuda")
    x, x_len, y, dec_mask = (t.cuda() for t in train_batch(TRAIN_B, SEED + 3))
    with torch.no_grad():
        h, h_len = model.encode(params, x, x_len)
    onehot = torch.nn.functional.one_hot(y.long(), model.output_depth).float() * dec_mask[..., None]
    return dict(dec=interop.to_numpy(params["decoder"]), h=h.cpu().numpy(),
                lens=h_len.cpu().numpy(), onehot=onehot.cpu().numpy(),
                dec_mask=dec_mask.cpu().numpy())


def sp_decode(mesh, case):
    """The teacher-forced decode of `case` on the card and the gradient of
    (1 / n) sum(logprobs * onehot * dec_mask) for the decoder's weights and
    h, n the ranks of mesh's sp group (mesh None: one rank, K12 and K13):
    (outputs, gradients, wall seconds of the forward and backward)."""
    from seq2seq_attention_asr_tpu_torch import interop, tree
    from seq2seq_attention_asr_tpu_torch.ops import attention
    from seq2seq_attention_asr_tpu_torch.parallel import seq_attention

    acfg = flagship_loc().build_model().attention_cfg
    dec = interop.to_torch(case["dec"], "cuda")
    leaves = [t.requires_grad_(True) for t in tree.leaves(dec)]
    h = torch.from_numpy(case["h"]).cuda().requires_grad_(True)
    lens, onehot, dmask = (torch.from_numpy(case[k]).cuda() for k in ("lens", "onehot",
                                                                      "dec_mask"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if mesh is None:
        out, n = attention.decode_teacher_forced(dec, acfg, h, lens, onehot, dmask), 1
    else:
        out = seq_attention.sharded_decode_teacher_forced(mesh, dec, acfg, h, lens, onehot, dmask)
        n = mesh.sp
    loss = torch.sum(out["logprobs"] * onehot * dmask[..., None]) / n
    grads = torch.autograd.grad(loss, leaves + [h])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    outs = {k: out[k].detach() for k in ("logprobs", "alpha", "penalty", "s", "c")}
    return outs, list(grads), wall


def mesh_rank(rank, inputs):
    """(c) on one of two gloo ranks sharing the card: the dp = 2 flagship
    steps on this rank's rows, then the sp = 2 decode of flagship_loc.
    Returns the step metrics, walls and launch counts, and the decode's
    outputs (alpha over this rank's positions), gradients and walls."""
    from seq2seq_attention_asr_tpu_torch.ops.cuda import attention_scan, gru_scan
    from seq2seq_attention_asr_tpu_torch.parallel import make_mesh, mesh as mesh_lib
    from seq2seq_attention_asr_tpu_torch.train import experiment, trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels = {k.name: k for k in (gru_scan.KERNEL, gru_scan.KERNEL_BWD, attention_scan.KERNEL_FWD,
                                   attention_scan.KERNEL_BWD, attention_scan.KERNEL_LOC_FWD,
                                   attention_scan.KERNEL_LOC_BWD)}
    mesh = make_mesh(dp=2, device="cuda")
    exp = experiment.timit_chorowski_normnll_colnorm()
    tr = trainer.Trainer(exp.build_model(), exp.optim, exp.train, mesh=mesh)
    tr.init(inputs["train_params"])
    rows = mesh_lib.put_batch(mesh, [torch.from_numpy(a) for a in inputs["batch"]])
    steps = []
    for _ in range(MESH_STEPS):
        t0 = time.perf_counter()
        (tr.state, m), counts = counted(kernels, lambda: tr.step_fn(tr.state, rows))
        steps.append(({k: float(v) for k, v in m.items()}, counts, time.perf_counter() - t0))
    sp_mesh = make_mesh(dp=1, sp=2, device="cuda")
    (outs, grads, wall), counts = counted(kernels, lambda: sp_decode(sp_mesh, inputs["sp"]))
    walls = [wall] + [sp_decode(sp_mesh, inputs["sp"])[2] for _ in range(2)]
    return {"steps": steps, "rows": tuple(rows[0].shape), "sp": outs, "sp_grads": grads,
            "sp_walls": walls, "sp_counts": counts, "device": str(torch.cuda.current_device())}


def mesh_two_ranks(kernels, train_params, loc_params_cpu, card: str) -> None:
    """(c): the single-rank references on the card, then the two ranks."""
    from seq2seq_attention_asr_tpu_torch import interop
    from seq2seq_attention_asr_tpu_torch.parallel import multihost
    from seq2seq_attention_asr_tpu_torch.train import experiment, trainer

    batch = train_batch(TRAIN_B, SEED + 3)
    exp = experiment.timit_chorowski_normnll_colnorm()
    tr = trainer.Trainer(exp.build_model(), exp.optim, exp.train, device="cuda")
    tr.init(train_params)
    arrs = tuple(t.cuda() for t in batch)
    single = []
    for _ in range(MESH_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.state, m = tr.step_fn(tr.state, arrs)
        torch.cuda.synchronize()
        single.append(({k: float(v) for k, v in m.items()}, time.perf_counter() - t0))
    sp_case = sp_decode_inputs(loc_params_cpu)
    (want, want_grads, _), counts = counted(kernels, lambda: sp_decode(None, sp_case))
    check_counts("sp reference decode", counts,
                 ("attention_decode_scan_loc_fwd", "attention_decode_scan_loc_bwd"))
    single_walls = [sp_decode(None, sp_case)[2] for _ in range(3)]
    t0 = time.perf_counter()
    ranks = multihost.spawn(mesh_rank, 2, {"train_params": interop.to_numpy(train_params),
                                           "batch": [t.numpy() for t in batch], "sp": sp_case},
                            timeout=MESH_TIMEOUT)
    took = time.perf_counter() - t0
    for r, res in enumerate(ranks):
        for i, ((m, counts, wall), (ref, ref_wall)) in enumerate(zip(res["steps"], single)):
            rel = {k: abs(m[k] - ref[k]) / max(abs(ref[k]), 1e-30) for k in ref}
            tol = DP_STEP_RTOL1 if i == 0 else TRAIN_RTOL
            launched = {n: c for n, c in counts.items() if c}
            print(f"mesh dp=2 rank {r} (rows {res['rows']}) step {i + 1}: {m}; single-rank "
                  f"{ref}; largest relative difference {max(rel.values()):.3e} (tol {tol}); "
                  f"launches {launched}; {1e3 * wall:.1f} ms wall, single-rank "
                  f"{1e3 * ref_wall:.1f} ms ({card})")
            if set(m) != set(ref) or max(rel.values()) > tol or launched != STEP_LAUNCHES:
                raise SystemExit(f"mesh dp=2 rank {r} step {i + 1} disagrees with the "
                                 f"single-rank step or launches {launched}")
    got = {k: [torch.from_numpy(res["sp"][k]) for res in ranks] for k in want}
    got["alpha"] = [torch.cat(got["alpha"], dim=-1)] * 2  # the ranks' positions, in order
    fwd = max(float((g - want[k].cpu()).abs().max()) / max(float(want[k].abs().max()), 1e-30)
              for k in want for g in got[k])
    summed = [sum(torch.from_numpy(res["sp_grads"][i]) for res in ranks)
              for i in range(len(want_grads))]
    grad = max(float((g - w.cpu()).abs().max()) / max(float(w.abs().max()), 1e-30)
               for g, w in zip(summed, want_grads))
    counts = [{n: c for n, c in res["sp_counts"].items() if c} for res in ranks]
    print(f"mesh sp=2 flagship_loc decode B={TRAIN_B} L={TRAIN_L} T={TRAIN_T} (2 ranks, "
          f"{TRAIN_L // 2} positions each): forward max |diff| / max |K12| {fwd:.3e} (tol "
          f"{SP_FWD_RTOL}), gradients (the ranks' sum) max |diff| / max |K13| {grad:.3e} (tol "
          f"{SP_GRAD_RTOL}); launches of the ranks {counts} (the step loop: no decoder kernel); "
          f"forward and backward {[round(1e3 * w, 1) for w in ranks[0]['sp_walls']]} ms wall "
          f"on rank 0, K12 + K13 on one rank {[round(1e3 * w, 1) for w in single_walls]} ms "
          f"({card})")
    if not fwd <= SP_FWD_RTOL or not grad <= SP_GRAD_RTOL or any(counts):
        raise SystemExit("mesh sp=2 decode disagrees with K12/K13 on one rank")
    print(f"mesh two ranks on the card: {took:.1f} s wall, the ranks' start included; every "
          f"collective staged through the host (gloo) ({card})")


def mesh_phase(kernels, train_params, loc_params_cpu, card: str) -> list:
    """Phase 16; returns the bf16 entries' {"kernels"} rows."""
    t0 = time.perf_counter()
    rows = bf16_parity_rows(bf16_gru_cases(train_params["encoder"],
                                           torch.Generator().manual_seed(SEED + 16)), card)
    for name, n in bf16_encoder_launches(kernels, train_params["encoder"]).items():
        rows[name]["launches"] = n
    print(f"phase 16 (a) {time.perf_counter() - t0:.1f} s wall ({card})")
    t1 = time.perf_counter()
    mesh_one_rank(kernels, train_params, card)
    print(f"phase 16 (b) {time.perf_counter() - t1:.1f} s wall ({card})")
    t1 = time.perf_counter()
    mesh_two_ranks(kernels, train_params, loc_params_cpu, card)
    print(f"phase 16 (c) {time.perf_counter() - t1:.1f} s wall; phase 16 "
          f"{time.perf_counter() - t0:.1f} s wall ({card})")
    return bf16_kernel_rows(rows)


def main(parent=None) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from seq2seq_attention_asr_tpu_torch import interop
    from seq2seq_attention_asr_tpu_torch.data import features
    from seq2seq_attention_asr_tpu_torch.models import conv_bilstm, registry
    from seq2seq_attention_asr_tpu_torch.ops.cuda import (attention_scan, attention_step, build,
                                                          gru_scan, logmel, lstm_scan)
    from seq2seq_attention_asr_tpu_torch.train import experiment

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(f"device: {torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} visible")

    kernels = {k.name: k for k in (gru_scan.KERNEL, attention_step.KERNEL, logmel.KERNEL,
                                   gru_scan.KERNEL_BWD, attention_scan.KERNEL_FWD,
                                   attention_scan.KERNEL_BWD, lstm_scan.KERNEL,
                                   attention_step.KERNEL_LOC_LSTM, lstm_scan.KERNEL_BWD,
                                   attention_scan.KERNEL_LOC_LSTM_FWD,
                                   attention_scan.KERNEL_LOC_LSTM_BWD,
                                   attention_scan.KERNEL_LOC_FWD, attention_scan.KERNEL_LOC_BWD,
                                   attention_scan.KERNEL_LSTM_FWD,
                                   attention_scan.KERNEL_LSTM_BWD, gru_scan.KERNEL_GRU,
                                   gru_scan.KERNEL_GRU_BWD, gru_scan.KERNEL_BI,
                                   gru_scan.KERNEL_BI_BWD, gru_scan.KERNEL_BF16,
                                   attention_scan.KERNEL_FWD_BF16, attention_step.KERNEL_BF16,
                                   lstm_scan.KERNEL_BF16, attention_scan.KERNEL_LOC_LSTM_FWD_BF16,
                                   attention_scan.KERNEL_LOC_FWD_BF16,
                                   attention_scan.KERNEL_LSTM_FWD_BF16,
                                   attention_step.KERNEL_LOC_LSTM_BF16,
                                   gru_scan.KERNEL_BWD_BF16, attention_scan.KERNEL_BWD_BF16,
                                   lstm_scan.KERNEL_BWD_BF16,
                                   attention_scan.KERNEL_LOC_LSTM_BWD_BF16,
                                   attention_scan.KERNEL_LSTM_BWD_BF16,
                                   attention_scan.KERNEL_LOC_BWD_BF16,
                                   gru_scan.KERNEL_GRU_BF16, gru_scan.KERNEL_GRU_BWD_BF16,
                                   gru_scan.KERNEL_BI_BF16, gru_scan.KERNEL_BI_BWD_BF16)}
    started = t0 = time.perf_counter()
    build.build_all(kernels.values())
    print(f"build: {time.perf_counter() - t0:.1f} s wall for {len(kernels)} kernels")
    for k in kernels.values():
        took = "already built" if k.build_seconds is None else f"{k.build_seconds:.1f} s"
        print(f"build {k.name} ({k.source.name}): {took}")
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line:
                print("  " + line.strip())

    model = registry.build("chorowski")
    cfg = model.cfg
    params = model.init(torch.Generator().manual_seed(SEED), device="cuda")
    # The training recipe's weights: orthogonal init from the seed, on the CPU.
    train_params = experiment.timit_chorowski_normnll_colnorm().init_params(
        torch.Generator().manual_seed(SEED), device="cpu")
    # The conv+BiLSTM recipe's weights (orthogonal init, LSTM branch
    # included), and the decoders of K8's other two instances.
    cb_recipe = experiment.timit_conv_bilstm()
    cb_model = cb_recipe.build_model()
    cb_params_cpu = cb_recipe.init_params(torch.Generator().manual_seed(SEED), device="cpu")
    cb_params = interop.to_torch(cb_params_cpu, "cuda")
    loc_dec = registry.build("chorowski", feature_maps=16, filt_size=10).init(
        torch.Generator().manual_seed(SEED))["decoder"]
    noloc_dec = registry.build("conv_bilstm", feature_maps=0).init(
        torch.Generator().manual_seed(SEED))["decoder"]
    # The two recipes with the other decoder, their orthogonal init from the seed.
    loc_params_cpu = flagship_loc().init_params(torch.Generator().manual_seed(SEED), device="cpu")
    cbc_params_cpu = conv_bilstm_content().init_params(torch.Generator().manual_seed(SEED),
                                                       device="cpu")

    pcms, feats, mean, std = serve_setup()
    norm_feats = ((feats - torch.from_numpy(mean)) / torch.from_numpy(std)).cuda()

    # Phase 3: each kernel against its plain version, at the serving
    # shapes (K1-K3, K7, K8) and at the training shapes (K4-K6 for the
    # flagship, K9-K11 for the conv+BiLSTM recipe, K12 and K13 for
    # flagship_loc, K14 and K15 for conv_bilstm_content), K16-K19 at both.
    errs = {name: 0.0 for name in kernels}
    timing, with_proj = {}, {}
    gen = torch.Generator().manual_seed(SEED + 1)
    all_cases = {}
    for b in (1, 8):
        cb_cases, with_proj[b] = conv_bilstm_cases(cb_params, cb_model.cfg, noloc_dec,
                                                   norm_feats[:b], gen)
        all_cases[b] = cases(params, cfg, loc_dec, b, gen) + [k3_case(b, gen)] + cb_cases
    recipe = experiment.timit_chorowski_normnll_colnorm()
    all_cases["train"] = train_cases(interop.to_torch(train_params, "cuda"),
                                     recipe.build_model().cfg, train_batch(TRAIN_B, SEED + 3), gen)
    all_cases["cbtrain"] = cb_train_cases(cb_params, cb_model.cfg, train_batch(TRAIN_B, SEED + 3),
                                          gen)
    all_cases["loctrain"] = loc_train_cases(interop.to_torch(loc_params_cpu, "cuda"),
                                            flagship_loc().build_model().cfg,
                                            train_batch(TRAIN_B, SEED + 3), gen)
    all_cases["cbctrain"] = cbc_train_cases(interop.to_torch(cbc_params_cpu, "cuda"),
                                            conv_bilstm_content().build_model().cfg,
                                            train_batch(TRAIN_B, SEED + 3), gen)
    # K16-K19 on the flagship encoder's first layer: the training batch,
    # and one utterance at the serving length.
    enc_cuda = interop.to_torch(train_params["encoder"], "cuda")
    x_tr, len_tr = (t.cuda() for t in train_batch(TRAIN_B, SEED + 3)[:2])
    all_cases["enc"] = gru_scan_cases(enc_cuda, x_tr, len_tr, gen)
    all_cases["enc1"] = gru_scan_cases(enc_cuda, torch.randn(1, SERVE_L, 123, generator=gen).cuda(),
                                       torch.tensor([SERVE_L]).cuda(), gen)
    for b, cs in all_cases.items():
        for c in cs:
            with torch.no_grad():
                got = c.kernel(*c.args)
                want = c.plain(*c.args)
            torch.cuda.synchronize()
            errs[c.name] = max(errs[c.name], c.check(got, want, shape_tag(b)))
            if c.name in FWD_WALKS or c.name in WALK_BWDS or c.name in FWD_SCANS or \
                    c.name == "stft_logmel_power":
                check_repeat(c, kernels[c.name], got, shape_tag(b))
    errs["fused_attention_step"] = max(errs["fused_attention_step"], k2_edge_phase(
        params["decoder"], cfg.attention_config(), kernels["fused_attention_step"], gen))
    k8_decoders = {"lstm+loc": (cb_params["decoder"], cb_model.cfg.attention_config()),
                   "gru+loc": (loc_dec, dataclasses.replace(cfg.attention_config(),
                                                            feature_maps=16, filt_size=10)),
                   "lstm": (noloc_dec, dataclasses.replace(cb_model.cfg.attention_config(),
                                                           feature_maps=0)),
                   "gru": (params["decoder"], cfg.attention_config())}
    t0 = time.perf_counter()
    errs["fused_attention_step_loc_lstm"] = max(
        errs["fused_attention_step_loc_lstm"],
        k8_edge_phase(k8_decoders, kernels["fused_attention_step_loc_lstm"], gen))
    print(f"K8's edges took {time.perf_counter() - t0:.1f} s")
    for name, err in fwd_edge_phase(kernels, gen).items():
        errs[name] = max(errs[name], err)

    # Phases 4 and 5: serve on the card, then the same requests on the CPU.
    # The "eos" weights raise the readout's bias at eos, so that
    # hypotheses finish on eos; the seeded random weights alone never
    # pick eos.
    kw = dict(eos_id=EOS_ID, mean=mean, std=std, beam_k=BEAM_K)
    weights = {"random": params}
    for bias in EOS_BIASES:
        weights[f"eos+{bias}"] = with_eos_bias(params, bias)
    # A hypothesis forced to finish at max_steps holds max_steps + 1 tokens.
    max_steps = features.frames_for_samples(len(pcms[0])) + 2 * PAD_FRAMES
    runs = [(False, 1), (False, 8), (True, 1)]
    main_launches, eos_steps = serve_requests(
        "chorowski", model, weights,
        [("random", *r) for r in runs] + [(f"eos+{bias}", False, 8) for bias in EOS_BIASES],
        pcms, kw, kernels,
        lambda exact, steps: {"bigru_scan2": 3, "fused_attention_step": steps,
                              "stft_logmel_power": 0 if exact else 1},
        max_steps)
    if min(eos_steps) > max_steps:
        raise SystemExit("serve eos: the beam never left its loop before max_steps")
    # The conv+BiLSTM recipe: the beam runs for the encoder's lengths.
    cb_steps = int(conv_bilstm.encode_lengths(cb_model.cfg, torch.tensor(CB_PAD_LEN)))
    bias = pick_eos_bias(cb_model, cb_params_cpu, pcms, kw, cb_steps)
    print(f"serve conv_bilstm: eos bias {bias} (the first of {CB_EOS_BIASES} that ends a "
          f"hypothesis on eos on the CPU), beam steps capped at {cb_steps}")
    cb_weights = {"random": cb_params, f"eos+{bias}": with_eos_bias(cb_params, bias)}
    cb_launches, _ = serve_requests(
        "conv_bilstm", cb_model, cb_weights,
        [("random", *r) for r in runs] + [(f"eos+{bias}", False, 8)], pcms, kw, kernels,
        lambda exact, steps: {"bilstm_scan": 1, "fused_attention_step_loc_lstm": steps,
                              "stft_logmel_power": 0 if exact else 1},
        cb_steps)

    # Phase 6: train each recipe on the card, against the CPU.
    train_launches = train_phase(kernels, experiment.timit_chorowski_normnll_colnorm,
                                 train_params, STEP_LAUNCHES, "chorowski")
    cb_train_launches = train_phase(kernels, experiment.timit_conv_bilstm, cb_params_cpu,
                                    CB_STEP_LAUNCHES, "conv_bilstm")
    loc_train_launches = train_phase(kernels, flagship_loc, loc_params_cpu, LOC_STEP_LAUNCHES,
                                     "flagship_loc")
    loc_long_step(kernels, loc_params_cpu)
    cbc_train_launches = train_phase(kernels, conv_bilstm_content, cbc_params_cpu,
                                     CBC_STEP_LAUNCHES, "conv_bilstm_content")

    # Phase 7: the flagship encoder by each path, against bigru_layer and the CPU.
    enc_launches = encoder_phase(kernels, train_params["encoder"], train_batch(TRAIN_B, SEED + 3))

    # Phase 8: times at the shapes of each kernel's path, kernel and plain in turns.
    iters = {"bigru_scan2": 20, "fused_attention_step": 200, "stft_logmel_power": 200,
             "bigru_scan2_bwd": 10, "attention_decode_scan_fwd": 10,
             "attention_decode_scan_bwd": 10, "bilstm_scan": 200,
             "fused_attention_step_loc_lstm": 100, "bilstm_scan_bwd": 100,
             "attention_decode_scan_loc_lstm_fwd": 10, "attention_decode_scan_loc_lstm_bwd": 10,
             "attention_decode_scan_loc_fwd": 10, "attention_decode_scan_loc_bwd": 10,
             "attention_decode_scan_lstm_fwd": 10, "attention_decode_scan_lstm_bwd": 10,
             "gru_scan": 20, "gru_scan_bwd": 10, "bigru_scan": 20, "bigru_scan_bwd": 10}
    library = {}
    for b, cs in all_cases.items():
        for c in cs:
            n = iters[c.name]
            with torch.no_grad():
                call_ms = time_ms(lambda: c.kernel(*c.args), n)
                plain_ms = time_ms(lambda: c.plain(*c.args), max(3, n // 10))
                ms = device_ms(lambda: c.kernel(*c.args), c.symbols, n)
                # The library call as the kernel is timed: the device time
                # of every device op it starts.
                lib_ms = device_ms(c.library, None, n) if c.library else None
            b_ms, b_by = bound(c.flops, c.nbytes)
            timing[(c.label, b)] = (ms, plain_ms, b_ms, b_by)
            tag = shape_tag(b)
            lib = "null" if lib_ms is None else f"{lib_ms:.4f} ms on the device"
            print(f"time {c.label} {tag}: kernel {ms:.4f} ms on the device ({call_ms:.4f} ms "
                  f"per wrapper call), plain {plain_ms:.4f} ms per call, bound {b_ms:.4f} ms "
                  f"({b_by}: {c.flops:.3e} flop, {c.nbytes:.3e} B), library {lib} ({card})")
            if lib_ms is not None:
                library[(c.name, b)] = lib_ms
            if c.name in WALKS:
                walk_split(c, kernels[c.name], tag, n, card)
            if c.name in WALK_BWDS:
                decoder_walk_split(c, kernels[c.name], tag, n, card)
                decoder_walk_sweep(c, kernels[c.name], tag, card)
            if c.name in FWD_SCANS:
                fwd_walk_split(c, kernels[c.name], tag, n, card)
                fwd_walk_sweep(c, kernels[c.name], tag, card)
            if c.name == "bilstm_scan_bwd":
                with torch.no_grad():
                    lib_call = time_ms(c.library, n)
                print(f"time bilstm_scan_bwd {tag}: cuDNN bidirectional LSTM backward (TF32 off; "
                      f"dx and the input weights' gradient too) {lib_ms:.4f} ms on the device, "
                      f"{lib_call:.4f} ms per call; K9 {ms:.4f} ms on the device, {call_ms:.4f} "
                      f"ms per wrapper call ({card})")
            elif lib_ms is not None:
                with torch.no_grad():
                    proj_dev = device_ms(with_proj[b], None, n)
                    proj_call = time_ms(with_proj[b], n)
                    lib_call = time_ms(c.library, n)
                print(f"time bilstm_scan {tag} with its two input projections, the flip and "
                      f"the stack (the work of cuDNN's call): {proj_dev:.4f} ms on the device, "
                      f"{proj_call:.4f} ms per call; cuDNN bidirectional LSTM (TF32 off) "
                      f"{lib_ms:.4f} ms on the device, {lib_call:.4f} ms per call; K7 alone "
                      f"{call_ms:.4f} ms per wrapper call ({card})")
    for b in (TRAIN_B, BIG_B):
        k6_plan_sweep(kernels["bigru_scan2_bwd"], b, card)
    fwd_walk_timing(kernels, errs, card)
    # K4, K5 and K10-K15 at B=128: parity, a second call, the device time
    # by stage and the walk under each plan.
    big = train_batch(BIG_B, SEED + 3)
    big_cases = train_cases(interop.to_torch(train_params, "cuda"),
                            experiment.timit_chorowski_normnll_colnorm().build_model().cfg, big,
                            gen)
    big_cases += loc_train_cases(interop.to_torch(loc_params_cpu, "cuda"),
                                 flagship_loc().build_model().cfg, big, gen)
    big_cases += cb_train_cases(cb_params, cb_model.cfg, big, gen)
    big_cases += cbc_train_cases(interop.to_torch(cbc_params_cpu, "cuda"),
                                 conv_bilstm_content().build_model().cfg, big, gen)
    for c in big_cases:
        if c.name in WALK_BWDS or c.name in FWD_SCANS:
            tag = f"B={BIG_B} L={TRAIN_L} T={TRAIN_T}"
            with torch.no_grad():
                got = c.kernel(*c.args)
                want = c.plain(*c.args)
            torch.cuda.synchronize()
            errs[c.name] = max(errs[c.name], c.check(got, want, tag))
            if c.name in FWD_SCANS:
                check_repeat(c, kernels[c.name], got, tag)
                fwd_walk_split(c, kernels[c.name], tag, 10, card)
                fwd_walk_sweep(c, kernels[c.name], tag, card)
            else:
                check_repeat(c, kernels[c.name], got, tag)
                decoder_walk_split(c, kernels[c.name], tag, 10, card)
                decoder_walk_sweep(c, kernels[c.name], tag, card)
    del big_cases
    for b in (1, 8):
        k2_plan_sweep(next(c for c in all_cases[b] if c.label == "fused_attention_step"), card)
    t0 = time.perf_counter()
    for variant in ("lstm+loc", "gru+loc"):
        for b in (1, 8):
            k8_plan_sweep(next(c for c in all_cases[b]
                               if c.label == f"fused_attention_step_loc_lstm[{variant}]"), card)
    print(f"K8's plan sweep took {time.perf_counter() - t0:.1f} s")
    for b in (1, 8):
        k2_ms, k8_ms = timing[("fused_attention_step", b)][0], \
            timing[("fused_attention_step_loc_lstm[gru]", b)][0]
        print(f"time K2 and K8's content-only GRU instance on K2's inputs B={b}: K2 {k2_ms:.4f} "
              f"ms, K8 {k8_ms:.4f} ms on the device, K8 / K2 = {k8_ms / k2_ms:.3f} ({card})")
    k3_ms = [timing[("stft_logmel_power", b)][0] for b in (1, 8)]
    threads = k3_threads(logmel.KERNEL.source.read_text())
    print(f"time stft_logmel_power on the 3.5 s bucket (112 frames a row), blocks of {threads} "
          f"threads: b=1 {k3_ms[0]:.4f} ms, b=8 {k3_ms[1]:.4f} ms on the device ({card})")
    front_end_ops(pcms[0], mean, std, card)
    for name, why in NO_LIBRARY.items():
        print(f"library null for {name}: {why}")
    print("the recurrences' bounds ignore the dependency chain of their steps; every time is "
          "warm (back-to-back launches, weights resident in L2, as in the beam loop and the "
          "train step); kernel times are device times from the profiler, per-call times are "
          "CUDA events over back-to-back calls and include the host's work between launches")

    # Phase 9: request latency and train-step time, each with the
    # device's idle share: the device time of one request or step,
    # traced with a device-only profiler, over the unprofiled p50.
    serve_timing("chorowski", model, params, pcms, kw, runs, card)
    serve_timing("conv_bilstm", cb_model, cb_params, pcms, kw, [(False, 1), (False, 8)], card)
    for recipe, weights_cpu, step_kernels, label in (
            (experiment.timit_chorowski_normnll_colnorm, train_params, STEP_KERNELS, "chorowski"),
            (experiment.timit_conv_bilstm, cb_params_cpu, CB_STEP_KERNELS, "conv_bilstm"),
            (flagship_loc, loc_params_cpu, LOC_STEP_KERNELS, "flagship_loc"),
            (conv_bilstm_content, cbc_params_cpu, CBC_STEP_KERNELS, "conv_bilstm_content")):
        for b in (TRAIN_B, BIG_B):
            train_timing(recipe, weights_cpu, b, card, step_kernels, label)
    for b in (TRAIN_B, BIG_B):
        encoder_timing(train_params["encoder"], b, card)

    # Phase 10: the trainer: the committed checkpoint's held-out PER,
    # Trainer.fit with checkpoints and resume, greedy decode on K2 and K8.
    trainer_phase(kernels, cb_model, cb_params, norm_feats[:8], card)

    # Phase 11: the reference recipe's regularisers: the committed AWN
    # stage restarted, the monotonic penalty on each decoder, dropout and
    # weight noise.
    regulariser_phase(kernels, {
        "chorowski": (experiment.timit_chorowski_normnll_colnorm, train_params, STEP_LAUNCHES),
        "conv_bilstm": (experiment.timit_conv_bilstm, cb_params_cpu, CB_STEP_LAUNCHES),
        "flagship_loc": (flagship_loc, loc_params_cpu, LOC_STEP_LAUNCHES),
        "conv_bilstm_content": (conv_bilstm_content, cbc_params_cpu, CBC_STEP_LAUNCHES)},
        card)

    # Phase 12: the bf16 operating point of the flagship's evaluation path,
    # then (b) of conv_bilstm's, flagship_loc's, vgg's and conv_bilstm_content's.
    bf16_rows = bf16_phase(kernels, card) + bf16_models_phase(kernels, card)
    # (c) bf16 training of the flagship and of VGG (K5's and K6's bf16 entries).
    bf16_rows += bf16_train_phase(kernels, train_params, card)
    # (d) bf16 training of conv_bilstm, conv_bilstm_content and flagship_loc
    # (the bf16 entries of K9, K11, K15 and K13).
    bf16_rows += bf16_other_train_phase(kernels, card)

    # Phase 13: the LibriSpeech recipes, and K2 at a word vocabulary.
    words_row = librispeech_phase(kernels, errs, card)
    # Phase 14: the convergence harness on the card, against the CPU.
    convergence_phase(kernels, card)
    # Phase 15: K8 over VGG's word vocabulary, beams of more than 8
    # hypotheses, and the port's corpus readers from FLAC to a VGG epoch.
    readers_and_wide_beams_phase(kernels, errs, model, params, cb_params["decoder"],
                                 cb_model.cfg.attention_config(), pcms, mean, std, card)
    # Phase 16: the bf16 entries of K16-K19, and the mesh trainer (dp x sp):
    # a world of one NCCL rank, then two gloo ranks that share the card.
    bf16_rows += mesh_phase(kernels, train_params, loc_params_cpu, card)
    if parent:
        compare_trees(parent, card)

    # Each kernel's numbers at batch 1 (serving) or its training shape,
    # and its launches in the run of its main path; the bf16 entries'
    # from phase 12.
    report = []
    for name in kernels:
        if (name in BF16_OF or name in BF16_MODEL_OF or name in BF16_TRAIN_OF
                or name in BF16_OTHER_TRAIN_OF or name in BF16_GRU_OF):
            continue
        label = MAIN_LABEL.get(name, name)
        key = next(k for k in (1, "train", "cbtrain", "loctrain", "cbctrain", "enc")
                   if (label, k) in timing)
        ms, plain_ms, b_ms, b_by = timing[(label, key)]
        if key == 1:
            served = name in ("bilstm_scan", "fused_attention_step_loc_lstm")
            launches = (cb_launches if served else main_launches)[name]
        elif key == "enc":
            launches = enc_launches["stacked" if name.startswith("bigru") else "per_direction"][name]
        else:
            launches = {"train": train_launches, "cbtrain": cb_train_launches,
                        "loctrain": loc_train_launches, "cbctrain": cbc_train_launches}[key][name]
        report.append({
            "name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
            "launches": launches, "max_abs_err": errs[name], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": library.get((name, key)),
        })
    report += bf16_rows + [words_row]
    print(f"chip_smoke: {time.perf_counter() - started:.1f} s wall, the build included")
    print(json.dumps({"kernels": report}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="Smoke test of the PyTorch port on one GPU.")
    ap.add_argument("--parent", help="another checkout of the repo to time beside this one")
    ap.add_argument("--time-tree", help=argparse.SUPPRESS)  # compare_trees' worker
    args = ap.parse_args()
    if args.time_tree:
        if not torch.cuda.is_available():
            sys.exit(1)
        sys.path.insert(0, args.time_tree)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print("tree-timing " + json.dumps(tree_timing()))
        sys.exit(0)
    sys.exit(main(args.parent))
