#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU: PCM -> text serving
and training of the flagship Chorowski model and of the conv+BiLSTM
TIMIT model, and training of each with the other decoder (the flagship
with location-aware attention, the conv+BiLSTM model without it), and
the flagship's encoder by two more BiGRU paths (one GRU layer per
direction, and the direction-stacked scan), through their nineteen CUDA
kernels.

    python3 chip_smoke.py

Phases, each fatal when it fails:
  1. the card's name and power limit (nvidia-smi);
  2. build the nineteen kernels from csrc/ (one nvcc per source, in parallel);
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
     K6 / K12 / K13; and for conv_bilstm_content (the second with
     model_kwargs["feature_maps"] = 0), one each of K7, K9, K14 and K15;
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
     from); for K13 at B = 16
     and 128 (parity at B = 128 too) the device time by stage (the walk,
     the reduction over the steps, the sum of the rows' location-term
     partials), the walk's time a step and the scratch bytes; for K5 at
     the flagship's training shape and K11 and K15 at the conv+BiLSTM
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
 10. one {"kernels": [...]} JSON line, the card line, and the last line
     {"ok": true, "device": {...}}.

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
# outside the tensor cores, and HBM3 bandwidth. The kernels compute in
# float32 on the CUDA cores.
PEAK_F32_FLOPS = 67e12
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
                    "gru_fwd_prepass_kernel", "loc_gru_fwd_kernel", "scan_loc_gru_bwd_kernel",
                    "atb_kernel")
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
# The location-aware GRU decoder scan's backward (K13): each call runs its
# walk, then atb_kernel over the steps, then atb_kernel over the B rows'
# location-term partials.
LOC_BWDS = ("attention_decode_scan_loc_bwd",)
# The decoder scans' backwards on thread-block clusters (K5, K11, K15):
# each call runs the recompute pre-pass (four launches for the GRU, three
# for the LSTM), the walk, then atb_kernel over the steps and atb_kernel
# over the walk's partials. Each one's walk and pre-pass by trace name.
PREPASS = ("lstm_decoder_prepass_kernel",) * 3
GRU_PREPASS = ("gru_decoder_prepass_kernel",) * 4
WALK_BWDS = {"attention_decode_scan_bwd": ("content_gru_walk_kernel", GRU_PREPASS),
             "attention_decode_scan_loc_lstm_bwd": ("loc_lstm_bwd_kernel", PREPASS),
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
def traced(activities):
    """A profiler trace of the block, with TRACE_PAD_S of host pause at
    each end; the block's device work is synchronised before it closes."""
    from torch.profiler import profile

    with profile(activities=activities) as prof:
        time.sleep(TRACE_PAD_S)
        yield prof
        torch.cuda.synchronize()
        time.sleep(TRACE_PAD_S)


def device_ms(fn, symbols, iters: int) -> float:
    """Mean device time of one call of `fn`, from a profiler trace of
    `iters` calls: the summed time of the device kernels whose names hold
    one of `symbols` (a C entry point may start more than one; a symbol
    listed n times is launched n times a call), or of every device op the
    call starts when `symbols` is None, without the host's time between
    launches. A trace that kept fewer than nine tenths of the launches (or,
    for `symbols` None, no device record: nan after three) is taken again,
    at most twice."""
    return sum(device_parts(fn, symbols, iters).values())


def device_parts(fn, symbols, iters: int) -> dict:
    """device_ms by symbol: {symbol: mean device ms of its launches in one
    call}, or {None: every device op's} when `symbols` is None."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        with traced([ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if symbols is None:
            if events:
                return {None: sum(e.time_range.elapsed_us() for e in events) / iters / 1e3}
            print(f"device_ms: trace {attempt + 1} kept no device record")
            continue
        ms, short = {}, []
        for symbol in dict.fromkeys(symbols):
            per_call = symbols.count(symbol)
            durs = [e.time_range.elapsed_us() for e in events if symbol in e.name]
            if len(durs) > iters * per_call:
                raise SystemExit(f"profiler saw {len(durs)} launches of {symbol}, expected "
                                 f"{iters * per_call}")
            if len(durs) < 0.9 * iters * per_call:
                short.append(f"{len(durs)} launches of {symbol}, expected {iters * per_call}")
                continue
            # The mean is over the records the trace kept.
            ms[symbol] = per_call * sum(durs) / len(durs) / 1e3
        if not short:
            return ms
        print(f"device_ms: trace {attempt + 1} kept {'; '.join(short)}")
    if symbols is None:
        return {None: float("nan")}
    raise SystemExit(f"profiler saw {'; '.join(short)} in each of 3 traces")


def bound(flops: float, nbytes: float):
    """Least time on this card for the work: (ms, "operations"|"bytes")."""
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
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
    return [step.StepPlan(c, -(-b // resident[c])) for c in step.CLUSTERS
            if resident[c] >= 1 and step.step_loc_lstm_smem_bytes(
                k, l, acfg.score_depth, acfg.annotation_depth, acfg.state_depth, fm, f, c, lstm,
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
    autograd.grad of the output for the input and every weight. Besides
    what K9 computes it forms dx and the input weights' gradient."""
    lstm = cudnn_lstm(p, x.device)
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
            ("scan_loc_gru_bwd_kernel", "atb_kernel", "atb_kernel")),
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


def loc_split(c, tag: str, iters: int, card: str) -> None:
    """Phase 8 for K13 (`c`, a case of LOC_BWDS): the device time by stage
    over `iters` traced calls (the walk, the reduction over the steps, the
    sum of the rows' location-term partials), the walk's time a step, and
    the scratch the call takes (attention_scan.stash_floats)."""
    from seq2seq_attention_asr_tpu_torch.ops.cuda import attention_scan

    ms, kept = _stage_times(c, ((c.symbols[0], "walk"), ("atb_kernel", "steps"),
                                ("atb_kernel", "loc")), iters)
    vh, yin = c.args[0], c.args[3]
    b, l, s_dim = vh.shape
    t_len, st = yin.shape[1], yin.shape[2]
    # decoder_scan_cases' order: vh, h, mask, yin, the step's 7 weights,
    # the GRU's 2, then wconv, bconv, U.
    wconv, bconv, u = c.args[13:16]
    f, fm = wconv.shape
    if tuple(bconv.shape) != (fm,) or tuple(u.shape) != (fm, s_dim):
        raise SystemExit(f"loc_split: {c.label}'s location-term weights are not where expected")
    floats = attention_scan.stash_floats(False, b, t_len, l, s_dim, st, fm, f)
    print(f"time {c.label} {tag} by stage: walk {ms['walk']:.4f} ms "
          f"({1e3 * ms['walk'] / t_len:.2f} us a step over {t_len} steps), the steps' reduction "
          f"{ms['steps']:.4f} ms, the location term's row sums {ms['loc']:.4f} ms (records kept: "
          f"{', '.join(f'{k} {n}' for k, n in kept.items())} of {iters}); scratch "
          f"{floats} floats ({4 * floats / 1e6:.1f} MB) ({card})")


def walk_case_dims(c):
    """(B, L, S, A, St, FM, F) of a case of WALK_BWDS (K5, K11 or K15)."""
    vh, h, yin = c.args[0], c.args[1], c.args[3]
    b, l, s_dim = vh.shape
    fm, f = 0, 0
    if c.name == "attention_decode_scan_loc_lstm_bwd":
        f, fm = c.args[14].shape  # after vh, h, mask, yin, the 7 step and 3 cell weights
    return b, l, s_dim, h.shape[2], yin.shape[2], fm, f


def decoder_walk_split(c, kernel, tag: str, iters: int, card: str) -> None:
    """Phase 8 for K5, K11 and K15 (`c`, a case of WALK_BWDS): the device
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
    """Phase 8: K5, K11 or K15 (`c`) under each (C, R) the walk can take
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


def timed_steps(recipe, params_cpu, b: int):
    """10 card train steps of `recipe` at batch b after 3 warm-up steps:
    (their host times in ms, the state, the step function, the batch)."""
    state, step_fn = make_trainer(recipe, params_cpu, "cuda")
    batch = tuple(t.cuda() for t in train_batch(b, SEED + 5))
    for _ in range(3):
        state, _ = step_fn(state, batch)
    torch.cuda.synchronize()
    lat = []
    for _ in range(10):
        t0 = time.perf_counter()
        state, _ = step_fn(state, batch)
        torch.cuda.synchronize()
        lat.append(1e3 * (time.perf_counter() - t0))
    return lat, state, step_fn, batch


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


# The instance of each kernel whose numbers stand in the {"kernels"} line:
# the one on its main path, at batch 1 (serving) or the training shape.
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
                                   gru_scan.KERNEL_BI_BWD)}
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
            if c.name in LOC_BWDS:
                loc_split(c, tag, n, card)
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
    # K4, K5 and K10-K15 at B=128: parity, the device time by stage and,
    # for all but K13, a second call and the walk under each plan.
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
        if c.name in LOC_BWDS or c.name in WALK_BWDS or c.name in FWD_SCANS:
            tag = f"B={BIG_B} L={TRAIN_L} T={TRAIN_T}"
            with torch.no_grad():
                got = c.kernel(*c.args)
                want = c.plain(*c.args)
            torch.cuda.synchronize()
            errs[c.name] = max(errs[c.name], c.check(got, want, tag))
            if c.name in LOC_BWDS:
                loc_split(c, tag, 10, card)
            elif c.name in FWD_SCANS:
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
    if parent:
        compare_trees(parent, card)

    # Each kernel's numbers at batch 1 (serving) or its training shape,
    # and its launches in the run of its main path.
    report = []
    for name in kernels:
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
