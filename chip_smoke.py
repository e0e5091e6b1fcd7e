#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (recalgorithm_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with one NVIDIA GPU (sm_90a: H100
or H200), nvcc and PyTorch built for CUDA.  Phases, each printed:

  1. the card (nvidia-smi name and power limit); TF32 off for matmuls and
     cuDNN, so every f32 product on the card is full f32 (a bf16 product
     sums in f32 because the port's bf16 Dense turns cuBLAS's
     reduced-precision sums off, phase 17);
  2. build the CUDA kernels from recalgorithm_tpu_torch/csrc into build/;
  3. each kernel against its plain torch twin on the card, timed with CUDA
     events beside its bound and, for BST attention, beside
     scaled_dot_product_attention: DIN attention at B = 8, 37, 256, 4096
     with uniform lengths and at B = 4096 with the serving length mix; the
     BST forward, P (f32 and bf16) and dq/dk/dv at (B, H, T) = (37|256|4096,
     3, 51) and (4096, 2, 9) with uniform lengths, at (8, 3, 51), a served
     batch's size, and (4096, 3, 51) with the BST train path's length mix,
     and at AutoInt's (4096, 2, 9) with every key valid (SDPA also without
     a mask);
  4. main path 1: full-width DIN (DINConfig defaults, real WeChat table
     sizes, random weights from a seed) exported, served by the port's
     build_server on cuda, 64 HTTP requests from 4 threads, every response
     held against the same export predicted on the CPU (plain twin);
  5. offline Predictor on cuda at B=4096, both use_softmax values, held
     against the CPU; where a batch's time goes at B = 8, 256 and 4096
     (host wall time against device busy time by kernel, torch.profiler);
  6. full-width DIN trains a few steps through cli.main on cuda (the DIN
     kernel's forward, autograd through the recompute for the backward);
  7. main path 2: full-width BST (BSTConfig defaults, real table sizes)
     trains through cli.main.main on cuda at B=4096 with one step-triggered
     eval and a checkpoint, then resumes once; predictions.csv and the best
     export are checked, and each BST kernel's launches against the steps and
     eval batches the run took;
  8. one BST train step on cuda held against the same step on the CPU, on
     weights that are the same in every run (a seeded init and a few Adam
     steps on the CPU, repeatable_weights): the loss against f32; every
     gradient against f64, allowing the f32 step's own rounding, and for an
     embedding table rtol of the f64 sum of its terms' magnitudes; on the
     batch rows with no relu input at a kink, where rounding could change
     the branch: BST has no relu, and the rows kept are printed); the BST
     kernels at that step's own inputs; the train step's time (CUDA events,
     host wall), ex/s and device idle share (torch.profiler);
  9. the golden recipe of tests/golden_common.py for BST and DIN on the
     card, each eval AUC held to its band of tests/golden_bands.json;
 10. the BST export served over HTTP by build_server, every response held
     against the CPU;
 11. main path 3: full-width AutoInt (AutoIntConfig defaults: 3 layers of
     field attention on the BST kernels, T = 9 fields, H = 2, d = 16; real
     table sizes) trains through cli.main.main on cuda at B=4096 as phase 7
     trains BST, with the exact launches of its three BST kernels; one train
     step against the CPU as phase 8; the BST kernels at the first layer's
     own q, k, v against their twins, their bounds and SDPA with and without
     a mask; the train step profiled; the export served over HTTP; the
     golden recipe, gated on its band;
 12. the rest of the zoo at full width (config defaults, real tables,
     B=4096): PNN, xDeepFM, FiBiNET, DeepCrossing, DCN, DCNv2, GDCN,
     GenericDNN, DeepFM, FFM, FwFM, AFM, NFM, DLRM, FinalMLP, MaskNet and
     WideAndDeep (its 100,000-bucket hashed cross, FTRL on the wide part)
     train 8 steps each through cli.main on cuda with no hand kernel
     launched; each best export predicted by Predictor on cuda against the
     CPU; one DeepFM and one W&D train step (no tower BN, dropout 0) against
     the f64 CPU step as phase 8; the DeepFM and DCNv2 train steps profiled
     as phase 8's;
     each golden recipe on cuda, gated on its band, or on MIN_EDGE with the
     band printed for GOLDEN_EDGE_ONLY, whose bands are under 2 sigma of
     their own rerun spread;
 13. main path 4: training from TFRecord files on cuda.  A WeChat split
     (262,144 train rows, 62,000 eval rows, real table sizes) drawn from
     SyntheticWeChat and written by the port's native writer with a
     vocabulary/ directory of its ids; read back bitwise by the native
     reader and, for 16,384 rows, by the Python parser, with rows/s of the
     writer, both readers and batches() through prefetch; full-width BST
     trains from the files through cli.main (periodic evals, one resume
     that also exports its serving artifact) with exact BST-kernel
     launches, and predictions.csv (file order, id tokens, labels) and its
     exact AUC are checked; full-width DIN streams
     the files for 2 epochs through the chunk cache (its manifest checked)
     with the DIN kernel's launches; DeepFM accumulates gradients over 2
     micro-batches under --profile_dir (trace written); GenericDNN and
     DeepFM train on a Douban-schema split; all with 0 launches where no
     hand kernel runs.  Where the time goes: BST's train step fed from the
     files against the synthetic stream (host wall, ex/s, the share spent
     waiting for the next batch), beside the host CPU model;
 14. main path 5: serving artifacts (serving/export.py, torch.export
     programs) on cuda.  Phase 4's DIN and phase 7's BST exported on cuda,
     f32 and with int8 tables, at B=256: each program holds its kernel's op
     node; HLOPredictor on cuda launches that kernel exactly once a batch
     and equals the live Predictor on cuda (quantized alike) within TOL;
     int8 and f32 within 0.02.  Phase 12's W&D exported f32 and int8: the
     int8 artifact under 0.45x the f32 bytes.  cli/serve.py's build_server
     with --stablehlo din=... --stablehlo bst=... over HTTP (each route
     against its artifact, a bare /predict refused as ambiguous).
     cli/score.py with phase 13's BST artifact on the 62,000-row eval
     split: predictions.csv's rows, tokens and labels, its probabilities to
     the CSV's 6 decimals.  The DIN artifact's batch wall against the live
     Predictor's at B = 8 and 256;
 15. main path 6: the multi-task family, DIEN and TwoTower at full width
     (config defaults, real tables, B=4096): MMOE, PLE, ESMM (its derived
     ctcvr task), SharedBottom, DIEN (T = 50, LazyAdam) and TwoTower (with
     --eval_recall_at 50) train ZOO_TRAIN_STEPS steps each through cli.main
     on cuda, every task's export predictions held to the CPU; a PLE and a
     DIEN train step (no tower BN, dropout 0) against the f64 CPU step as
     phase 8; DIEN's LazyAdam steps replay from the second on (its count on
     the card), and its replayed step leaves every element with a 0 gradient,
     every table row the batch did not read among them, bitwise unchanged;
     the PLE and DIEN train steps profiled; TwoTower's corpus from the eval
     split: brute_force_top_k and quantized_top_k on cuda against their CPU
     twins, the int8 corpus's overlap with the exact top-k (gated on
     tests/test_retrieval.py's own case), Recall@50 beside its random baseline; MMOE
     (three tasks) and TwoTower (the logit) exported on cuda and held to their
     live Predictor; each golden recipe gated on every task's band (MIN_EDGE
     for GOLDEN_EDGE_ONLY).  These paths launch no hand kernel;
 16. main path 7: the port as 2 processes sharing the one card over gloo
     (NCCL refuses two ranks on one device; a subprocess a rank, each with a
     hard time limit).  BST at full width, B=4096 (2048 rows a rank), its
     tables row-sharded over the 2 ranks, phase 8's weights and batch: the
     global loss and every gradient, gathered whole, held to the CPU step
     under phase 8's gate; 8 Adam steps whose losses stay within rtol 1e-4
     of the 1-process run's; each rank's BST-kernel launches exact; each
     rank's step time and idle share (two ranks sharing one card).
     cli.main on 2 processes from phase 13's checkpoint, whole-load and
     --stream: predictions.csv holds the 62,000 eval rows once each in file
     order, the exact AUC and GAUC within 1e-6 of the 1-process run from the
     same checkpoint.  MMOE with 4 experts on a (data 1, model 2) mesh, 2
     experts a rank: its step held to the CPU step.  sharded_top_k over the
     2 ranks against brute_force_top_k on TwoTower's corpus, ties aside;
 17. main path 8: the JAX defaults the port lacked.  BST's held step (phase
     8's weights and batch) with the PAD-compacted table gradient (the
     trainer's default, ops/compact_scatter.py) and without: every gradient
     bitwise the same (the feedid table on rows 1..), both under phase 8's
     gate against the f64 CPU step, the same BST-kernel launches; a batch
     whose histories are all 50 long routed to the full gradient, bitwise
     the full path's; both steps profiled (the embedding backward's kernels,
     busy, wall, ex/s, kernels a step); DIN through cli.main with and
     without --no_compact_grad_scatter, exact launches.  --precision bf16
     for BST, DIN, MMOE, PLE and DeepFM: eval logits against the same
     weights' f32 ones (the JAX zoo test's rule) and against the CPU bf16
     forward (a bar a model's f32 logits must exceed, where they do), the
     port's own switch to f32 sums in cuBLAS's bf16 GEMMs, what the first
     bf16 Dense and expert contraction returned against the CPU's, bf16
     products counted on cuda, a few cli.main steps each with exact
     launches; BST's bf16 step profiled.  fuse_optimizer (accepted, a
     no-op): a BST Adam and an Adagrad update with and without it, the
     parameters bitwise, kernels a step.  cli.sweep (a 2-point DeepFM
     grid), data.stats on phase 13's eval split, and utils.benchmarking's
     step timer against CUDA events around the same step, read in turns
     (and 2 stacked steps against one).
  18. The train step as one CUDA graph (``train/step_graph.py``) at full
     width, each case 8 steps against its eager twin from the same weights
     and seed, within the benchmark's ``correct`` limits or bitwise: BST on
     the compacted and on the full table gradient, DIN, a cosine schedule,
     an evaluate between steps, a checkpoint restore mid-run that resumes
     the loss sequence; a fresh trainer's steps 2 and 3 replays; the
     streaming train metrics (AUC, accuracy, logloss, calibration, loss)
     against the eager step's, and the rows they counted equal; every
     model of the zoo 4 steps at a small size: the 25 whose optimizer can
     be captured (DIEN's LazyAdam among them) replay steps 2-4, the two W&D
     models stay eager.

Each main path's kernel launch counts are set to 0 just before it and read
just after: a kernel of the path that never launched fails the run.  Where
a path's train steps replay a CUDA graph (cli.main on one card with Adam
or SGD), which calls no Python wrapper, its launches and its compacted
gathers are counted by kernel name in a profiler trace of the card
(``card_kernels``); elsewhere the wrappers count them.  The
line before the last is one JSON object with each kernel's numbers; the last
line is {"ok": true, "device": {...}}.  Any failure exits non-zero before
either, as does a machine without CUDA.
"""

from __future__ import annotations

import argparse
import atexit
import contextlib
import csv
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from collections import defaultdict

import numpy as np
import torch

# H100 SXM published peaks (NVIDIA data sheet): f32 outside the tensor cores,
# and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
TOL = dict(rtol=1e-5, atol=1e-5)  # f32 on both sides; summation order only
# GPU sleep that timed launches queue behind: 4e8 cycles last at least 0.2 s
# at the H100's highest clock (1.98 GHz)
SLEEP_CYCLES = 400_000_000
SLEEP_S_MIN = 0.2
SEQ = "his_read_comment_7d_seq"
# phase 5's profile: a small and a full serving bucket, and the offline batch
PROFILE_BATCHES = (8, 256, 4096)
PROFILE_ITERS = 20
PROFILE_TOP = 8
# DIN attention against its twin, all timed: (B, serving length mix?)
DIN_CASES = ((8, False), (37, False), (256, False), (4096, False), (4096, True))
# BST kernels against their twins: shapes (B, H, T) with uniform lengths,
# then a served batch's and the main path's shapes with the train path's
# length mix (bst_case); the gradient bars of the JAX package's own BST kernel
# test, 2e-2 where P was saved in bf16
BST_SHAPES = ((37, 3, 51), (256, 3, 51), (4096, 3, 51), (4096, 2, 9))
BST_SERVED_MIX = (8, 3, 51)
BST_MAIN_MIX = (4096, 3, 51)
AUTOINT_SHAPE = (4096, 2, 9)  # AutoInt's fields as keys, every one valid
AUTOINT_LAYERS = 3  # AutoIntConfig.att_layers: attention calls a forward
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
# phase 8: a cuda gradient may also be off the f64 step by this many times the
# f32 CPU step's own largest error in that tensor (step_gradient_ratios)
STEP_NOISE = 4
# a relu input within this share of its call's max|x| of 0 may change sides
# under the f32 rounding of either device (kink_free_rows)
KINK_MARGIN = 1e-5
# phase 8 (and 16) hold BST's train step on weights that are the same in
# every run (repeatable_weights): a seeded init, then STEP_WEIGHT_STEPS Adam
# steps on the CPU at B = STEP_WEIGHT_BATCH, so that the gate's verdict no
# longer hangs on which weights phase 7's card training happened to reach
STEP_WEIGHT_SEED, STEP_WEIGHT_STEPS, STEP_WEIGHT_BATCH = 8, 4, 1024
# main path 2: cli.main trains full-width BST at B=4096, evals every
# BST_EVAL_EVERY steps, then resumes to BST_RESUME_STEPS
BST_BATCH = 4096
BST_STEPS = 40
BST_EVAL_EVERY = 20
BST_RESUME_STEPS = 50
DIN_TRAIN_STEPS = 8
STEP_ITERS = 20  # train steps timed / profiled in phases 8 and 11
# phase 12: full-width training steps of each model that runs no hand kernel
ZOO_MODELS = ("PNN", "xDeepFM", "FiBiNET", "DeepCrossing", "DCN", "DCNv2", "GDCN",
              "GenericDNN", "DeepFM", "FFM", "FwFM", "AFM", "NFM", "DLRM", "FinalMLP",
              "MaskNet", "WideAndDeep")
ZOO_PROFILED = ("DeepFM", "DCNv2")  # their train steps profiled, as phase 8's
ZOO_TRAIN_STEPS = 8
ZOO_PREDICT_BATCH = 1024
# the golden recipe of tests/golden_common.py (which imports the JAX
# package, so its numbers are copied here): the synthetic stream of seed 3 at
# vocab scale 0.005, B=128, GOLDEN_STEPS steps at GOLDEN_LR unless
# GOLDEN_PER_MODEL says otherwise, the SMALL_OVERRIDES widths that a config
# has, 32 eval batches from seed 5000; MIN_EDGE is the AUC that tells a
# live model from a dead one
GOLDEN_SEED, GOLDEN_BATCH, GOLDEN_STEPS, GOLDEN_LR, GOLDEN_EVAL_BATCHES = 3, 128, 60, 0.005, 32
GOLDEN_PER_MODEL = {"AFM": {"steps": 200, "lr": 0.02}, "DeepFM": {"steps": 800, "lr": 0.02},
                    "FFM": {"steps": 1400, "lr": 0.01}, "FwFM": {"steps": 200, "lr": 0.02},
                    "NFM": {"steps": 200, "lr": 0.02}, "PNN": {"steps": 800, "lr": 0.02},
                    "FiBiNET": {"steps": 200, "lr": 0.02}, "BST": {"steps": 300, "lr": 0.01},
                    "DCN": {"steps": 150}, "MMOE": {"steps": 150}}
GOLDEN_OVERRIDES = {"hidden_units": (64, 32), "expert_hidden_units": 32,
                    "output_dimension": 16, "cin_layer_feature_maps": (8, 8),
                    "attention_factor": 16, "cross_hash_buckets": 5000, "num_experts": 3,
                    "num_experts_per_task": (2, 2, 2), "num_experts_in_shared": 4,
                    "gru_output_units": 8}
# the golden recipe's FTRL rate for the wide part of a model with a
# wide-parameter split (W&D), beside the deep part's Adam at the recipe's rate
GOLDEN_WIDE_LR = 0.01
MIN_EDGE = 0.57
# models whose band (of a task, for a multi-task model) is under 2 sigma of
# their own rerun spread, too narrow for another init draw: every task gated
# on MIN_EDGE
GOLDEN_EDGE_ONLY = ("xDeepFM", "FiBiNET", "AFM", "NFM", "GenericDNN", "FinalMLP",
                    "WideAndDeep", "PLE", "ESMM", "SharedBottom")
# phase 13: the WeChat split written to TFRecords; the reference's 3,322,313
# train rows are cut to 64 batches of 4096 for the time limit, and 62,000
# eval rows leave the last eval batch padded
FILE_TRAIN_ROWS = 262_144
FILE_EVAL_ROWS = 62_000
FILE_PY_ROWS = 16_384  # rows the Python parser reads back
FILE_SEED = 13
# BST from the files: steps, eval and checkpoint period, then the resume
FILE_BST_STEPS, FILE_BST_EVAL_EVERY, FILE_BST_RESUME = 24, 12, 32
# DIN streams the first STREAM_LIMIT rows in chunks for STREAM_EPOCHS epochs
STREAM_CHUNK, STREAM_LIMIT, STREAM_EPOCHS = 16_384, 65_536, 2
ACCUM_MICRO_STEPS = 8  # DeepFM, --grad_accum_steps 2
DOUBAN_TRAIN_ROWS, DOUBAN_EVAL_ROWS, DOUBAN_STEPS = 65_536, 8_000, 8
FEED_WARM, FEED_STEPS = 5, 20  # BST steps per feed in the feed comparison
# phase 14: serving artifacts (serving/export.py) at this baked batch, each
# predicting ARTIFACT_BATCHES batches; int8 against f32 within INT8_ATOL and
# W&D's int8 artifact under INT8_BYTES of its f32 one (the JAX package's
# bounds, tests/test_quantize.py); the artifact against the live Predictor
# timed at TIMED_BATCHES
ARTIFACT_BATCH, ARTIFACT_BATCHES = 256, 3
INT8_ATOL, INT8_BYTES = 0.02, 0.45
TIMED_BATCHES = (8, 256)
# phase 15: the six models the earlier phases do not train, each as phase 12
# trains its models; TwoTower's Recall@K; the int8 corpus's overlap with the
# exact top-k on tests/test_retrieval.py's case at least that test's floor; a
# top-k score gap under TOPK_TIE is a tie between the cuda and CPU f32 sums;
# the PLE and DIEN step profiles over NEW_PROFILE_ITERS steps each, to keep
# the phase in its 90 s (DIEN's step is thousands of launches)
NEW_MODELS = ("MMOE", "PLE", "ESMM", "SharedBottom", "DIEN", "TwoTower")
RECALL_K = 50
QUANTIZED_OVERLAP = 0.9
TOPK_TIE = 1e-5
NEW_PROFILE_ITERS = 4
TWIN_USERS = 1024  # users whose top-k on cuda is held to the CPU twin's
# phase 16: MESH_RANKS processes on the one card over gloo (NCCL refuses two
# ranks on one device), each given MESH_RANK_TIMEOUT_S: BST's held step on
# the tables row-sharded, then MESH_STEPS Adam steps whose global losses stay
# within MESH_LOSS_RTOL of the 1-process run's (tests/test_torch_train.py's
# trainer bar), then MESH_PROFILE_ITERS steps a measurement timed and
# profiled on each rank; MMOE with MESH_EXPERTS experts on a (data 1, model
# 2) mesh (3 experts would not divide); the exact AUC and GAUC of cli.main
# on 2 processes within MESH_AUC_TOL of the 1-process run from the same
# checkpoint
MESH_RANKS = 2
MESH_STEPS = 8
MESH_PROFILE_ITERS = 5
MESH_LOSS_RTOL = 1e-4
MESH_EXPERTS = 4
MESH_AUC_TOL = 1e-6
MESH_RANK_TIMEOUT_S = 600
MESH_BATCH_SEED = 20  # the synthetic batches of the MESH_STEPS steps
# phase 17: the JAX defaults the port lacked.  cli.main runs of
# DEFAULTS_STEPS steps; bf16 eval logits at B = BF16_EVAL_BATCH held to the
# f32 ones under the JAX zoo test's rule (BF16_VS_F32 x max(1, max|logit|))
# and to the CPU bf16 forward within the model's BF16_VS_CPU bar (same
# scale), a bar the same weights' f32 logits on the card must exceed
# against that CPU forward, so it tells bf16 from f32 (PLE has no such gap:
# its f32 logits sit as close to the CPU bf16 ones as the card's bf16 do, so
# its bar is the f32 rule's and the bf16 product counter and the first
# product's check below carry it; PERF.md, PR 13).  The two devices' bf16
# logits differ at all because their f32 sums differ in the last bits and
# move products across bf16 rounding boundaries
# (tests/test_torch_precision.py::test_bf16_under_f32_rounding_noise).  The
# first bf16 Dense of each model returns on both devices within one bf16
# ulp (BF16_ULP relative) for each rounding plus the f32 sums' error bound;
# the first expert contraction within BF16_EXPERTS.  The step timer's slope
# within TIMER_TOL of phase 8's CUDA-event measurement of the step, and 2
# stacked steps' slope within STACKED of one's, each the median of
# TIMER_ROUNDS interleaved rounds (the step is host-bound: its time drifts
# with the host's load within seconds, so the two clocks are read in turns;
# the limits leave room on both sides of tools/timer_repeat.py's 10
# fresh-process runs and phase 17's own readings: 0.92-1.09 and 1.76-2.37,
# PERF.md, PR 13)
DEFAULTS_STEPS = 4
BF16_MODELS = ("BST", "DIN", "MMOE", "PLE", "DeepFM")
BF16_EVAL_BATCH = 1024
BF16_VS_F32 = 0.01
BF16_VS_CPU = {"BST": 3e-3, "DIN": 3.5e-3, "MMOE": 7e-4, "PLE": BF16_VS_F32, "DeepFM": 8e-5}
BF16_NO_GAP = ("PLE",)
BF16_ULP = 2.0 ** -7
BF16_EXPERTS = dict(rtol=1e-5, atol_share=1e-5)
TIMER_K = (2, 14)
# phase 18: train steps a case, and the graph path's limits against its
# eager twin.  Its own: the losses and the streaming metrics' means (loss,
# logloss, calibration) within GRAPH_MEAN_GAP relative (the card's largest
# loss gap over 8-step runs was 1.8e-7, 1.5 f32 ulps; the eager step's own
# table gradients differ from run to run in their last bits), AUC and
# accuracy within GRAPH_RANK_GAP (rows that fall on the other side of a
# bin edge), the rows each metric counted the same; the parameters' change
# norms within the benchmark's `correct` limits
# (portbench/workloads/bst-train-*.json)
GRAPH_STEPS = 8
GRAPH_ZOO_BATCH, GRAPH_ZOO_VOCAB = 512, 0.01
GRAPH_MEAN_GAP = 2e-6
GRAPH_RANK_GAP = 1e-3
GRAPH_LIMITS = {"loss_gap": GRAPH_MEAN_GAP, "metric_gap": GRAPH_MEAN_GAP,
                "rank_metric_gap": GRAPH_RANK_GAP, "change_gap": 3e-4,
                "change_gap_worst": 1e-1}
# phase 19: the row-wise Adagrad kernel at the DLRM-DCNv2 cell's shapes
# (portbench/configs/dlrm-dcnv2-criteo1tb.json): a 5,000,000-row table read
# by the 100-hot bag at B = 8192, and the 3-row table at hot size 1; ids
# floor(n u^2) + 1 as the cell's traffic draws them.  The kernel against
# its twin: each tensor's norm gap within ROW_GAP, untouched rows bitwise.
# Both sum a row's gradient rows in float32 in orders of their own (the
# twin's index_add_ and the kernel's long segments add atomically): a sum
# of K rows of either sign rounds to about sqrt(K) 6e-8 of the sum of its
# terms' magnitudes, and the 3-row table's rows each sum about 2,700 (read
# 2.0e-6 on the accumulator, where one row left out moves a row by about
# 2%; the 5M-row table 2.0e-7).  Then a
# DLRM-DCNv2 trainer at the cell's widths with tables of at most
# ROW_STEP_ROWS rows, ROW_STEPS steps on the row path against the dense
# chain from the same weights, within GRAPH_LIMITS' loss and change limits.
ROW_CASES = ((5_000_000, 100, 8192), (3, 1, 8192))  # (vocabulary, hot size, B)
ROW_DIM = 128
ROW_GAP = 1e-5
ROW_STEP_ROWS, ROW_STEP_BATCH, ROW_STEPS = 100_000, 4096, 3
TIMER_ROUNDS = 7
TIMER_TOL = 0.25
STACKED = (1.5, 2.7)
# the embedding backward's kernels (sort, segment sums, scatter), by name
TABLE_GRAD_KERNELS = ("embedding", "segment", "grad_weight", "sum_and_scatter", "adix")
KERNEL_OPS = {"DIN": "recalgorithm_torch.din_attention.default",
              "BST": "recalgorithm_torch.bst_mha_forward.default"}
REPO = os.path.dirname(os.path.abspath(__file__))


def phase(name: str) -> None:
    print(f"\n== {name}", flush=True)


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Device ms of one call: CUDA events around `iters` calls queued behind
    a GPU sleep, so the card runs them back to back and the host's cost to
    launch them is not in the number."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = time.perf_counter() - t0
    end.record()
    end.synchronize()
    if host_s > SLEEP_S_MIN:
        raise RuntimeError(f"launching {iters} calls took {host_s:.3f} s, longer "
                           "than the GPU sleep: the device time would hold host gaps")
    return start.elapsed_time(end) / iters


def device_events(prof) -> list:
    """The kernels and copies of a torch.profiler run; the GPU-side ranges
    of user annotations (``Optimizer.step#Adam.step``) span kernels already
    counted and are left out."""
    from torch.autograd import DeviceType

    return [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def profile_batch(pred, batch) -> dict:
    """Where a served batch's time goes: host wall time of `predict_batch`
    (numpy in -> numpy out; it ends in a device->host copy, so it is
    synchronous), median of PROFILE_ITERS calls, against the device time of
    every kernel and copy per batch from torch.profiler over PROFILE_ITERS
    more (one stream, so their sum is the busy time)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        pred.predict_batch(batch)
    torch.cuda.synchronize()
    walls = []
    for _ in range(PROFILE_ITERS):
        t0 = time.perf_counter()
        pred.predict_batch(batch)
        walls.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_ITERS):
            pred.predict_batch(batch)
        torch.cuda.synchronize()
    events = device_events(prof)
    by_name: dict[str, float] = defaultdict(float)
    for e in events:
        by_name[e.name] += e.time_range.elapsed_us() / PROFILE_ITERS / 1e3
    att = [e.time_range.elapsed_us() / 1e3 for e in events if "din_attention" in e.name]
    if not att:
        raise AssertionError("the profiled batch ran no din_attention kernel")
    wall_ms = float(np.median(walls)) * 1e3
    busy_ms = sum(by_name.values())
    return {
        "batch": len(batch["dense"]), "wall_ms": wall_ms, "busy_ms": busy_ms,
        "idle_share": 1.0 - busy_ms / wall_ms,
        "device_ops_per_batch": len(events) / PROFILE_ITERS,
        "din_attention_ms": float(np.mean(att)),
        "top": sorted(by_name.items(), key=lambda kv: -kv[1])[:PROFILE_TOP],
    }


def din_attention_bound_ms(lengths: np.ndarray, t: int, use_softmax: bool):
    """Least time for the kernel's work on these lengths (source note of
    csrc/din_attention.cu): 6240 FLOP per valid step + 4096 per example, the
    valid keys read once, q/lengths/out once, the weights once."""
    b = len(lengths)
    steps = np.clip(lengths, 0, t).astype(np.int64)
    flops = 6240 * int(steps.sum()) + 4096 * b
    rows = steps.copy()
    if use_softmax:  # len 0 attends uniformly: all T keys, 16 adds each
        flops += 16 * t * int((steps == 0).sum())
        rows[steps == 0] = t
    nbytes = 4 * (16 * int(rows.sum()) + 33 * b) + 4 * 6273
    t_ops, t_bytes = flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def bst_bound_ms(lengths: np.ndarray, h: int, t: int, kind: str, p_bytes: int = 4):
    """Least time for a BST kernel's work on these lengths (source note of
    csrc/bst_attention.cu), d = 16, per (b, h) with n = min(len, T) valid
    keys.  FLOP: 4 T n d forward, 8 T n d backward, 2 T^2 d for a len = 0
    row.  Bytes: q and o (forward) or q, do, dq, dk and dv (backward) in
    full; the first n rows of k and v (a len = 0 row: all T rows of v
    forward, none backward, where its dl is 0 and P is the constant 1/T);
    P in full where the forward writes it, its first n columns where the
    backward reads it; lengths once."""
    d = 16
    n = np.clip(lengths, 0, t).astype(np.int64)
    per_row = {"forward": 4, "forward_save": 4, "backward": 8}[kind] * t * n * d
    flops = h * int(np.where(n > 0, per_row, 2 * t * t * d).sum())
    b = len(lengths)
    full = 5 if kind == "backward" else 2
    kv_rows = int(n.sum()) + (0 if kind == "backward" else t * int((n == 0).sum()))
    nbytes = 4 * (full * b * h * t * d + h * d * (int(n.sum()) + kv_rows) + b)
    if kind == "forward_save":
        nbytes += b * h * t * t * p_bytes
    elif kind == "backward":
        nbytes += h * t * int(n.sum()) * p_bytes
    t_ops, t_bytes = flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def check_grads(name: str, got, want, tol=GRAD_TOL) -> float:
    """rtol, and atol scaled by max|want| (the JAX kernel test's rule)."""
    worst = 0.0
    for label, a, b in zip(("dq", "dk", "dv"), got, want):
        a, b = a.detach().cpu().numpy(), b.detach().cpu().numpy()
        if not np.isfinite(a).all():
            raise AssertionError(f"{name} {label}: not finite")
        scale = max(float(np.abs(b).max()), 1.0)
        if not np.allclose(a, b, rtol=tol["rtol"], atol=tol["atol"] * scale):
            raise AssertionError(f"{name} {label}: max abs err "
                                 f"{float(np.abs(a - b).max()):.3e} beyond {tol} x {scale:.3g}")
        worst = max(worst, float(np.abs(a - b).max()))
    return worst


def bst_case(b: int, h: int, t: int, seed: int, main_mix: bool = False, full: bool = False):
    """Uniform lengths in [0, t], or with ``main_mix`` the BST train path's
    (history min(geometric(0.15), 50) + 1, data/synthetic.py) clipped to t,
    with rows of n = 0, 1, 31, 32, 33 and t forced in, or with ``full``
    every length t (AutoInt's)."""
    rng = np.random.default_rng(seed)
    q, k, v, g = (torch.from_numpy(rng.normal(size=(b, h, t, 16)).astype(np.float32)).cuda()
                  for _ in range(4))
    if full:
        lengths = np.full(b, t, np.int32)
    elif main_mix:
        lengths = np.minimum(np.minimum(rng.geometric(0.15, b), 50) + 1, t).astype(np.int32)
        lengths[:6] = (0, 1, 31, 32, 33, t)
    else:
        lengths = rng.integers(0, t + 1, b).astype(np.int32)
        lengths[:3] = (0, t, 1)
    return q, k, v, g, torch.from_numpy(lengths).cuda()


def bst_kernels_vs_twins(q, k, v, g, lengths, timed: bool) -> dict:
    """Each BST kernel against its twin on (q, k, v, lengths): forward, P in
    f32 and bf16, dq/dk/dv from both.  With ``timed``: each kernel's ms, its
    twin's, its bound, and scaled_dot_product_attention's (rows with len >= 1:
    SDPA gives NaN on a fully masked row), with the boolean key mask and,
    where every key is valid, also with none (``library_ms_unmasked``: the
    call a PyTorch user makes for AutoInt)."""
    from recalgorithm_tpu_torch.ops.cuda import bst_attention as bk

    b, h, t, _ = q.shape
    want = bk.bst_mha_reference(q, k, v, lengths)
    probs = bk.attention_probs_reference(q, k, lengths)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    twin_out = bk.bst_mha_reference(*leaves, lengths)
    twin_grads = torch.autograd.grad(twin_out, leaves, g, retain_graph=True)
    out = bk.bst_attention_forward(q, k, v, lengths)
    out_s, p32 = bk.bst_attention_forward_save(q, k, v, lengths)
    out_b, p16 = bk.bst_attention_forward_save(q, k, v, lengths, save_bf16=True)
    grads = bk.bst_attention_backward(q, k, v, p32, g, lengths)
    grads16 = bk.bst_attention_backward(q, k, v, p16, g, lengths)
    torch.cuda.synchronize()
    r = {"err": {
        "forward": max(check_close(f"BST forward {tuple(q.shape)}", o.cpu().numpy(),
                                   want.cpu().numpy()) for o in (out, out_s, out_b)),
        "P": check_close("BST P f32", p32.cpu().numpy(), probs.cpu().numpy()),
        "P_bf16": float((p16.float() - probs).abs().max()),
        "backward": check_grads("BST backward", grads, twin_grads),
        "backward_bf16": check_grads("BST backward, bf16 P", grads16, twin_grads, BF16_TOL),
    }}
    if r["err"]["P_bf16"] > BF16_TOL["atol"]:
        raise AssertionError(f"BST P bf16: max abs err {r['err']['P_bf16']:.3e}")
    if not timed:
        return r
    lens = lengths.cpu().numpy()
    mask = (torch.arange(t, device=q.device)[None, :] < lengths[:, None])[:, None, None, :]
    rows = lengths > 0
    sq, sk, sv, sm, sg = (x[rows] for x in (q, k, v, mask, g))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    s_leaves = [x.clone().requires_grad_() for x in (sq, sk, sv)]
    s_out = sdpa(*s_leaves, attn_mask=sm)
    r["ms"] = {
        "forward": cuda_ms(lambda: bk.bst_attention_forward(q, k, v, lengths), iters=100),
        "forward_save": cuda_ms(lambda: bk.bst_attention_forward_save(q, k, v, lengths),
                                iters=100),
        "forward_save_bf16": cuda_ms(
            lambda: bk.bst_attention_forward_save(q, k, v, lengths, True), iters=100),
        "backward": cuda_ms(lambda: bk.bst_attention_backward(q, k, v, p32, g, lengths),
                            iters=100),
        "backward_bf16": cuda_ms(
            lambda: bk.bst_attention_backward(q, k, v, p16, g, lengths), iters=100),
    }
    r["plain_ms"] = {
        "forward": cuda_ms(lambda: bk.bst_mha_reference(q, k, v, lengths)),
        "forward_save": cuda_ms(lambda: torch.einsum(
            "bhij,bhjk->bhik", bk.attention_probs_reference(q, k, lengths), v)),
        "backward": cuda_ms(lambda: torch.autograd.grad(twin_out, leaves, g,
                                                        retain_graph=True)),
    }
    with torch.no_grad():
        sdpa_fwd = cuda_ms(lambda: sdpa(sq, sk, sv, attn_mask=sm))
    r["library_ms"] = {
        "forward": sdpa_fwd,
        "forward_save": cuda_ms(lambda: sdpa(*s_leaves, attn_mask=sm)),
        "backward": cuda_ms(lambda: torch.autograd.grad(s_out, s_leaves, sg,
                                                        retain_graph=True)),
        "sdpa_rows": int(rows.sum()),
    }
    if bool((lengths == t).all()):
        u_leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        u_out = sdpa(*u_leaves)
        r["err"]["sdpa_unmasked"] = float((u_out.detach() - want).abs().max())
        with torch.no_grad():
            u_fwd = cuda_ms(lambda: sdpa(q, k, v))
        r["library_ms_unmasked"] = {
            "forward": u_fwd,
            "forward_save": cuda_ms(lambda: sdpa(*u_leaves)),
            "backward": cuda_ms(lambda: torch.autograd.grad(u_out, u_leaves, g,
                                                            retain_graph=True)),
        }
    r["bound"] = {
        "forward": bst_bound_ms(lens, h, t, "forward"),
        "forward_save": bst_bound_ms(lens, h, t, "forward_save"),
        "forward_save_bf16": bst_bound_ms(lens, h, t, "forward_save", p_bytes=2),
        "backward": bst_bound_ms(lens, h, t, "backward"),
        "backward_bf16": bst_bound_ms(lens, h, t, "backward", p_bytes=2),
    }
    return r


def kernel_counts() -> dict[str, int]:
    """Every kernel wrapper's launch count."""
    from recalgorithm_tpu_torch.ops.cuda import bst_attention as bk
    from recalgorithm_tpu_torch.ops.cuda.din_attention import din_attention

    return {"din_attention": din_attention.launches,
            **{name: getattr(bk, name).launches for name in BST_KERNELS}}


def zero_counts() -> None:
    from recalgorithm_tpu_torch.ops.cuda import bst_attention as bk
    from recalgorithm_tpu_torch.ops.cuda.din_attention import din_attention

    din_attention.launches = 0
    for name in BST_KERNELS:
        getattr(bk, name).launches = 0


BST_KERNELS = ("bst_attention_forward", "bst_attention_forward_save", "bst_attention_backward")
# each wrapper's kernel, as its name reads in a profiler trace of the card
# (csrc/*.cu templates: DIN's on use_softmax, BST's forward on saving P)
KERNEL_NAMES = {"din_attention": "din_attention_kernel<",
                "bst_attention_forward": "bst_attention_fwd_kernel<false",
                "bst_attention_forward_save": "bst_attention_fwd_kernel<true",
                "bst_attention_backward": "bst_attention_bwd_kernel<"}
# the PAD-compacted gather's one kernel of its own: the scatter of each live
# entry's position to its slot (ops/compact_scatter.py, `src.scatter_`), a
# kernel no other op of BST's or DIN's step runs (their full-gradient steps
# run none on an H100)
COMPACT_SCATTER = ("_cuda_scatter_gather_internal_kernel<true", "TensorAssign>")


@contextlib.contextmanager
def card_kernels():
    """While open, a torch.profiler (CUPTI) trace of the card; on exit the
    Counter it yields holds each kernel and copy the card ran, by name:
    eager launches and CUDA graph replays alike.  A replayed train step
    calls no Python wrapper, so the wrappers' ``.launches``
    (``kernel_counts``) and ``compact_lookups`` count eager calls and graph
    captures only: a path whose train steps replay is counted here
    (``hand_counts``, ``compacted_gathers``)."""
    from collections import Counter

    from torch.profiler import ProfilerActivity, profile

    from recalgorithm_tpu_torch.utils import summary

    ran: Counter = Counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        yield ran
        torch.cuda.synchronize()
    summary.clear()  # the spans the trainer recorded while the profiler ran
    ran.update(e.name for e in device_events(prof))


def hand_counts(ran) -> dict[str, int]:
    """Each hand kernel wrapper's kernel in ``card_kernels``'s Counter."""
    return {w: sum(n for name, n in ran.items() if k in name) for w, k in KERNEL_NAMES.items()}


def compacted_gathers(ran) -> int:
    """The PAD-compacted gathers' backward passes in ``card_kernels``'s
    Counter (``COMPACT_SCATTER``)."""
    return sum(n for name, n in ran.items() if all(k in name for k in COMPACT_SCATTER))


def train_cli(model: str, model_dir: str, steps: int, extra=(), synthetic: bool = True) -> dict:
    """One run of the port's training entry point on cuda, full width, on
    the synthetic stream or, with ``synthetic=False``, the data ``extra``
    names."""
    from recalgorithm_tpu_torch.cli.main import main as train_main

    source = ["--synthetic", "--synthetic_vocab_scale", "1.0"] if synthetic else []
    argv = ["--model", model, *source,
            "--batch_size", str(BST_BATCH), "--train_steps", str(steps),
            "--model_dir", model_dir, "--predictions_csv",
            os.path.join(model_dir, "predictions.csv"), "--eval_throttle_secs", "0",
            "--log_every", "10", "--device", "cuda", *extra]
    t0 = time.perf_counter()
    final = train_main(argv)
    torch.cuda.synchronize()
    print(f"cli.main {model} to step {steps}: {time.perf_counter() - t0:.2f} s, "
          f"final eval {final}", flush=True)
    return final


def profile_train_step(trainer, batches, kernel: str | None, iters: int = STEP_ITERS) -> dict:
    """Where a train step's time goes: device ms of one step from CUDA
    events around ``iters`` steps launched back to back (the steady pipeline,
    host gaps included), the median host wall of a step that ends in a
    synchronize, and the device busy time per step (torch.profiler, every
    kernel and copy: one stream, so their sum is the busy time).  Fails if
    no ``kernel`` ran (BST and AutoInt run the BST kernels), or with
    ``kernel=None`` if any hand kernel ran."""
    from torch.profiler import ProfilerActivity, profile

    for hb in batches[:3]:
        trainer.train_step(hb)
    step_ms = event_step_ms(trainer, batches, iters)
    walls = []
    for i in range(iters):
        t0 = time.perf_counter()
        trainer.train_step(batches[i % len(batches)])
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            trainer.train_step(batches[i % len(batches)])
        torch.cuda.synchronize()
    events = device_events(prof)
    by_name: dict[str, float] = defaultdict(float)
    for e in events:
        by_name[e.name] += e.time_range.elapsed_us() / iters / 1e3
    busy_ms = sum(by_name.values())
    if kernel is not None and not any(kernel in name for name in by_name):
        raise AssertionError(f"the profiled train steps ran no {kernel} kernel")
    hand = [n for n in by_name if "din_attention" in n or "bst_attention" in n]
    if kernel is None and hand:
        raise AssertionError(f"the profiled train steps ran hand kernels: {hand}")
    return {"step_ms": step_ms, "wall_ms": float(np.median(walls)) * 1e3,
            "busy_ms": busy_ms, "idle_share": 1.0 - busy_ms / step_ms,
            "device_ops_per_step": len(events) / iters, "by_name": dict(by_name),
            "top": sorted(by_name.items(), key=lambda kv: -kv[1])[:PROFILE_TOP]}


def event_step_ms(trainer, batches, iters: int) -> float:
    """Device ms of one train step: CUDA events around ``iters`` steps
    launched back to back (the steady pipeline, host gaps included)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        trainer.train_step(batches[i % len(batches)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def golden_auc(name: str, device: str, model_dir: str,
               init_seed: int = GOLDEN_SEED) -> dict[str, float]:
    """tests/golden_common.py's fixed-seed recipe for ``name`` (GOLDEN_*
    above) through the port's Trainer; returns every task's eval AUC
    (``<task>_auc``).  ``init_seed`` seeds the weights and the dropout
    stream, as golden_common's trainer seed does; the data stay those of
    GOLDEN_SEED."""
    from recalgorithm_tpu_torch.data.synthetic import SyntheticConfig, SyntheticWeChat
    from recalgorithm_tpu_torch.features.schema import wechat_schema
    from recalgorithm_tpu_torch.models import get_model
    from recalgorithm_tpu_torch.train import optimizers
    from recalgorithm_tpu_torch.train.loop import Trainer, TrainerConfig

    seed, batch = GOLDEN_SEED, GOLDEN_BATCH
    steps = GOLDEN_PER_MODEL.get(name, {}).get("steps", GOLDEN_STEPS)
    lr = GOLDEN_PER_MODEL.get(name, {}).get("lr", GOLDEN_LR)
    gen = SyntheticWeChat(wechat_schema(), SyntheticConfig(seed=seed, vocab_scale=0.005))
    cfg_cls, model_cls = get_model(name)
    fields = {f.name for f in dataclasses.fields(cfg_cls)}
    cfg = cfg_cls(batch_size=batch,
                  **{k: v for k, v in GOLDEN_OVERRIDES.items() if k in fields})
    schema = wechat_schema(gen.vocab_sizes())
    model = model_cls(cfg, schema, torch.Generator().manual_seed(init_seed))
    tasks = tuple(cfg.task_names) or (schema.labels[0],)  # () is the first label
    if hasattr(model_cls, "wide_param_predicate"):
        opt = optimizers.dual_wide_deep(GOLDEN_WIDE_LR, "adam", lr, model_cls.wide_param_predicate,
                                        [n for n, _ in model.named_parameters()])
    else:
        opt = optimizers.build(cfg.optimizer, lr)
    trainer = Trainer(model, tasks, opt,
                      TrainerConfig(model_dir=model_dir, train_steps=steps, log_every=1000,
                                    save_checkpoints_steps=0, seed=init_seed), device=device)
    ev = trainer.train_and_evaluate(
        gen.batches(batch, steps),
        lambda: gen.batches(batch, GOLDEN_EVAL_BATCHES, start_seed=5000),
        log_fn=lambda line: None)
    return {k: v for k, v in ev.items() if k.endswith("_auc")}


def golden_phase(names, work: str) -> None:
    """Each model's golden recipe on cuda, every task's AUC held to its band
    of tests/golden_bands.json (GOLDEN_EDGE_ONLY: to MIN_EDGE, band printed)."""
    with open(os.path.join(REPO, "tests", "golden_bands.json")) as f:
        bands = json.load(f)
    for name in names:
        t0 = time.perf_counter()
        aucs = golden_auc(name, "cuda", os.path.join(work, f"golden_{name}"))
        if set(aucs) != set(bands[name]["auc"]):
            raise AssertionError(f"golden {name}: tasks {sorted(aucs)}, bands for "
                                 f"{sorted(bands[name]['auc'])}")
        for key, auc in sorted(aucs.items()):
            center, width = bands[name]["auc"][key], bands[name]["band"][key]
            inside = abs(auc - center) <= width
            print(f"golden {name} {key} {auc} (band {center} +- {width}: "
                  f"{'inside' if inside else 'outside'}"
                  f"{f'; gated on MIN_EDGE {MIN_EDGE}' if name in GOLDEN_EDGE_ONLY else ''})",
                  flush=True)
            if name in GOLDEN_EDGE_ONLY:
                if not auc >= MIN_EDGE:
                    raise AssertionError(f"golden {name} {key} {auc} below MIN_EDGE {MIN_EDGE}")
            elif not inside:
                raise AssertionError(f"golden {name} {key} {auc} outside {center} +- {width}")
        print(f"golden {name}: {time.perf_counter() - t0:.2f} s", flush=True)


BST_REPLACES = {"forward": "recalgorithm_tpu/ops/pallas/bst_attention.py:52",
                "forward_save": "recalgorithm_tpu/ops/pallas/bst_attention.py:68",
                "backward": "recalgorithm_tpu/ops/pallas/bst_attention.py:95"}


def zero_gradient_params(cfg) -> set[str]:
    """The BST parameters whose true gradient is 0 in a train step: with no
    activation in the tower, a shift that reaches a train-mode BatchNorm
    through linear maps only is taken out by its batch mean.  That holds for
    every dense bias, every BatchNorm bias but the last, and the last block's
    ln2 bias, which sum pooling makes one constant for the whole batch."""
    if cfg.mlp_activation != "none" or not cfg.batch_norm:
        raise ValueError("the zero gradients follow from a linear tower with BatchNorm")
    n = len(cfg.hidden_units)
    return ({f"dense_{i}.bias" for i in range(n)} | {f"bn_{i}.bias" for i in range(n - 1)}
            | {f"transformer_{cfg.num_transformer_block - 1}.ln2.bias"})


def step_gradient_ratios(gpu: dict, cpu: dict, exact: dict, zero: set[str],
                         abs_sums: dict) -> dict[str, float]:
    """Phase 8's gate on a train step's gradients: for each tensor, the largest
    share of its allowance that an element of the cuda gradient uses (it
    passes at <= 1).  The cuda gradient is held to the step's f64 CPU gradient
    ``exact``: within rtol 1e-4 and atol 1e-5 x its own max|g| (x the step's
    largest gradient for the ``zero`` tensors, whose true gradient is 0), plus
    STEP_NOISE x the f32 CPU step's (``cpu``) own largest error in that tensor.
    The last term is the rounding of f32 on this step's weights: an element
    whose sum cancels is off by it on any f32 device, in any summation order.
    For an embedding table's gradient (a key of ``abs_sums``) the rtol term is
    rtol x the f64 sum of |term| over the positions that read each row
    (``lookup_abs_sums``), not rtol x |sum|: each term is right within rtol,
    so the sum is right within rtol x sum|terms|, and a row read by many
    positions (the feedid sequence: 4096 x 51 positions) cancels."""
    step_scale = max(float(g.abs().max()) for g in exact.values())
    ratios = {}
    for name, want in exact.items():
        scale = step_scale if name in zero else float(want.abs().max())
        noise = float((cpu[name] - want).abs().max())
        rel = abs_sums[name] if name in abs_sums else want.abs()
        allowed = (GRAD_TOL["rtol"] * rel + GRAD_TOL["atol"] * scale
                   + STEP_NOISE * noise).clamp(min=torch.finfo(torch.float64).tiny)
        ratios[name] = float(((gpu[name] - want).abs() / allowed).max())
    return ratios


@contextlib.contextmanager
def lookup_abs_sums(model):
    """While open, each embedding-table lookup of ``model`` whose output needs
    a gradient gets a hook on that output; the dict yielded maps each table's
    parameter name to the sum, over the positions that read a row, of
    |dL/d(the row at that position)| (index_add over the lookup's ids): the
    S_abs of step_gradient_ratios, filled by the backward."""
    from recalgorithm_tpu_torch.embed.tables import EmbeddingCollection

    names = {id(m): n for n, m in model.named_modules() if isinstance(m, EmbeddingCollection)}
    sums: dict[str, torch.Tensor] = {}
    plain = EmbeddingCollection._clip_gather

    def hooked(self, table, ids, compact=False):
        out = plain(self, table, ids, compact)
        if out.requires_grad:
            tab = self.tables[table]
            acc = sums.setdefault(f"{names[id(self)]}.tables.{table}", torch.zeros_like(tab))
            rows = ids.long().clamp(0, tab.shape[0] - 1).reshape(-1)

            def add(grad, acc=acc, rows=rows, dim=tab.shape[1]):
                acc.index_add_(0, rows, grad.abs().reshape(-1, dim))  # returns None: grad kept

            out.register_hook(add)
        return out

    EmbeddingCollection._clip_gather = hooked
    try:
        yield sums
    finally:
        EmbeddingCollection._clip_gather = plain


def make_trainer(name: str, schema, weights: dict, cfg, device: str, model_dir: str,
                 mesh=None, global_rows: int | None = None, optimizer=None, **trainer_config):
    """A Trainer of ``name`` at ``cfg`` (its optimizer and learning rate, or
    the factory ``optimizer``) on
    ``device`` from ``weights``, an export's state dict (whole; sharded onto
    ``mesh`` when one is given, whose train steps take ``global_rows`` rows
    over all ranks), with the TrainerConfig fields ``trainer_config``; keys
    the model does not have (a BN tower that ``cfg`` leaves out) are left
    out, and a key the weights lack fails."""
    from recalgorithm_tpu_torch.models import get_model
    from recalgorithm_tpu_torch.train import optimizers
    from recalgorithm_tpu_torch.train.loop import Trainer, TrainerConfig

    model = get_model(name)[1](cfg, schema)
    own = model.state_dict()
    if set(own) - set(weights):
        raise AssertionError(f"{name}: the export lacks {sorted(set(own) - set(weights))}")
    model.load_state_dict({k: v for k, v in weights.items() if k in own})
    return Trainer(model, tuple(cfg.task_names) or (schema.labels[0],),
                   optimizer or optimizers.build(cfg.optimizer, cfg.learning_rate),
                   TrainerConfig(model_dir=os.path.join(model_dir, "unused"), **trainer_config),
                   device=device, mesh=mesh, global_batch_size=global_rows)


def kink_free_rows(model, batch) -> torch.Tensor:
    """The rows of ``batch`` whose every relu input in a train-mode forward
    of ``model`` lies at least KINK_MARGIN x that call's max|x| from 0.  A
    relu input closer to 0 can fall on the other side under either device's
    f32 rounding, and that example's gradient is then another function's, not
    a rounding error away.  Valid for models without a train-mode BatchNorm:
    dropping a row changes no other row (fails otherwise)."""
    from recalgorithm_tpu_torch.ops.activations import BatchNorm

    inputs = []
    relu = torch.relu  # nn.ReLU and F.relu call it too

    def recording(x):
        inputs.append(x.detach())
        return relu(x)

    torch.relu = recording
    try:
        model.train()
        with torch.no_grad():
            model(batch)
    finally:
        torch.relu = relu
    keep = torch.ones(len(batch["labels"]), dtype=torch.bool)
    for x in inputs:
        near = x.abs() < KINK_MARGIN * x.abs().max()
        keep &= ~near.reshape(len(keep), -1).any(dim=1).cpu()
    if not keep.all() and any(isinstance(m, BatchNorm) for m in model.modules()):
        raise AssertionError("rows at a relu kink in a model with a train-mode BatchNorm: "
                             "dropping them would change the other rows")
    return keep


def repeatable_weights(name: str, out_dir: str) -> str:
    """Weights of ``name`` (config defaults, real table sizes) that are the
    same in every run: initialised from STEP_WEIGHT_SEED by a torch.Generator
    on the CPU, then STEP_WEIGHT_STEPS Adam steps on the CPU (f32, dropout 0)
    on the seeded stream, so that every gradient is a trained model's.
    Written as an export; returns its directory."""
    from recalgorithm_tpu_torch import convert
    from recalgorithm_tpu_torch.data.synthetic import SyntheticConfig, SyntheticWeChat
    from recalgorithm_tpu_torch.features.schema import wechat_schema
    from recalgorithm_tpu_torch.models import get_model
    from recalgorithm_tpu_torch.train import optimizers
    from recalgorithm_tpu_torch.train.loop import Trainer, TrainerConfig

    t0 = time.perf_counter()
    gen = SyntheticWeChat(wechat_schema(), SyntheticConfig(seed=STEP_WEIGHT_SEED, vocab_scale=1.0))
    cfg_cls, cls = get_model(name)
    cfg = cfg_cls(dropout_rate=0.0)
    model = cls(cfg, wechat_schema(gen.vocab_sizes()),
                torch.Generator().manual_seed(STEP_WEIGHT_SEED))
    tr = Trainer(model, tuple(cfg.task_names), optimizers.build(cfg.optimizer, cfg.learning_rate),
                 TrainerConfig(model_dir=out_dir), device="cpu")
    losses = [float(tr.train_step(hb)) for hb in gen.batches(STEP_WEIGHT_BATCH, STEP_WEIGHT_STEPS)]
    export = convert.save_export(out_dir, tr.step, 0.0, tr.model)
    print(f"{name}: repeatable weights from seed {STEP_WEIGHT_SEED} and {STEP_WEIGHT_STEPS} CPU "
          f"Adam steps at B={STEP_WEIGHT_BATCH} (losses {losses}) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return export


def step_setup(name: str, best_dir: str, **overrides) -> tuple:
    """What the held train step of ``name`` starts from: the real-size
    schema, the weights of ``best_dir``, the config defaults with
    ``overrides`` and dropout 0 (so no side draws), and its batch (B=4096,
    seed 1)."""
    from recalgorithm_tpu_torch import convert
    from recalgorithm_tpu_torch.data.synthetic import SyntheticConfig, SyntheticWeChat
    from recalgorithm_tpu_torch.features.schema import wechat_schema
    from recalgorithm_tpu_torch.models import get_model

    gen = SyntheticWeChat(wechat_schema(), SyntheticConfig(seed=7, vocab_scale=1.0))
    return (wechat_schema(gen.vocab_sizes()), convert.load_export(best_dir),
            get_model(name)[0](dropout_rate=0.0, **overrides), gen.batch(BST_BATCH, 1))


def one_step(tr, batch, f64: bool = False) -> tuple[float, dict, dict]:
    """One train-mode forward and backward of ``tr``'s model on ``batch`` (in
    f64 with ``f64``): the loss, every gradient (f64, on the CPU) and the
    tables' terms' magnitudes (``lookup_abs_sums``)."""
    if f64:
        tr.model.double()
        batch = {k: x.double() if x.is_floating_point() else x for k, x in batch.items()}
    tr.model.train()
    with lookup_abs_sums(tr.model) as sums:
        loss, _ = tr._loss_and_logits(batch)
        loss.backward()
    return float(loss.detach()), {n: p.grad.double().cpu()
                                  for n, p in tr.model.named_parameters()}, sums


def step_reference(name: str, best_dir: str, **overrides) -> dict:
    """What a train step of ``name`` (``step_setup``) is held to: the batch's
    ``kink_free_rows`` of the f64 model, the f32 CPU step's loss and
    gradients, and the f64 CPU step's gradients and the tables' term
    magnitudes."""
    schema, weights, cfg, hb = step_setup(name, best_dir, **overrides)
    tr = make_trainer(name, schema, weights, cfg, "cpu", best_dir)
    batch = {k: x.double() if x.is_floating_point() else x
             for k, x in tr._put_batch(hb).items()}
    keep = kink_free_rows(tr.model.double(), batch).numpy()
    hb = {k: x[keep] for k, x in hb.items()}
    tr = make_trainer(name, schema, weights, cfg, "cpu", best_dir)
    cpu_loss, cpu_grads, _ = one_step(tr, tr._put_batch(hb))
    tr = make_trainer(name, schema, weights, cfg, "cpu", best_dir)
    _, exact, abs_sums = one_step(tr, tr._put_batch(hb), f64=True)
    return dict(schema=schema, weights=weights, cfg=cfg, hb=hb, keep=keep, cpu_loss=cpu_loss,
                cpu_grads=cpu_grads, exact=exact, abs_sums=abs_sums,
                overrides=overrides)


def hold_step(label: str, ref: dict, loss: float, grads: dict, zero: set[str]) -> float:
    """A train step's loss and gradients held to ``ref`` (``step_reference``):
    the loss to the f32 CPU step's within rtol 1e-5, each gradient to the f64
    step (``step_gradient_ratios``; ``zero``: the parameters whose true
    gradient is 0).  Prints the worst tensor; returns its share of the
    allowance."""
    exact = ref["exact"]

    def max_err(g):
        return max(float((g[n] - exact[n]).abs().max()) for n in exact)

    ratios = step_gradient_ratios(grads, ref["cpu_grads"], exact, zero, ref["abs_sums"])
    worst = max(ratios, key=ratios.get)
    print(f"{label} train step, {int(ref['keep'].sum())} of B={len(ref['keep'])} rows away "
          f"from a relu kink {ref['overrides'] or ''}: loss {loss} cpu {ref['cpu_loss']}; over "
          f"{len(exact)} gradient tensors against the f64 CPU step, within "
          f"{max_err(grads):.3e}, f32 CPU within {max_err(ref['cpu_grads']):.3e}; the worst "
          f"tensor, {worst}, uses {ratios[worst]:.4f} of its allowance", flush=True)
    if not (math.isfinite(loss) and abs(loss - ref["cpu_loss"]) <= 1e-5 * abs(ref["cpu_loss"])):
        raise AssertionError(f"{label}: the train step's loss is not the CPU's within rtol 1e-5")
    beyond = {n: r for n, r in ratios.items() if not r <= 1.0}
    if beyond:
        raise AssertionError(f"{label}: gradients beyond {GRAD_TOL} x max|g| + {STEP_NOISE} x the "
                             f"f32 CPU step's error, as shares of the allowance: {beyond}")
    return ratios[worst]


def step_vs_cpu(name: str, best_dir: str, zero: set[str], **overrides) -> dict:
    """One full-width train step of ``name`` (loss and every gradient) on
    cuda (``step_setup``), held against the same step on the CPU
    (``step_reference``, ``hold_step``).  Returns the reference, with the
    step's ``loss`` and the worst ``ratio``."""
    ref = step_reference(name, best_dir, **overrides)
    tr = make_trainer(name, ref["schema"], ref["weights"], ref["cfg"], "cuda", best_dir)
    loss, grads, _ = one_step(tr, tr._put_batch(ref["hb"]))
    ref["ratio"] = hold_step(f"{name} (cuda)", ref, loss, grads, zero)
    ref["loss"] = loss
    return ref


def train_step_profile(name: str, best_dir: str, card: str, kind: str,
                       kernel: str | None, iters: int = STEP_ITERS, label: str = "",
                       cfg=None, **trainer_config) -> dict:
    """``name``'s train step at ``cfg`` (the config defaults unless given;
    ``label`` names another) from the weights of ``best_dir``, with the
    TrainerConfig fields ``trainer_config``, profiled (``profile_train_step``,
    ``iters`` steps a measurement) and printed; returns the profile."""
    from recalgorithm_tpu_torch import convert
    from recalgorithm_tpu_torch.data.synthetic import SyntheticConfig, SyntheticWeChat
    from recalgorithm_tpu_torch.features.schema import wechat_schema
    from recalgorithm_tpu_torch.models import get_model

    gen = SyntheticWeChat(wechat_schema(), SyntheticConfig(seed=7, vocab_scale=1.0))
    schema = wechat_schema(gen.vocab_sizes())
    tr = make_trainer(name, schema, convert.load_export(best_dir), cfg or get_model(name)[0](),
                      "cuda", best_dir, **trainer_config)
    prof = profile_train_step(tr, [gen.batch(BST_BATCH, 10 + i) for i in range(4)], kernel,
                              iters)
    print(f"{name} train step{label} on {kind} ({card}), B={BST_BATCH}, config defaults: "
          f"{prof['step_ms']} ms a step (CUDA events over {iters} steps back to "
          f"back; {BST_BATCH / prof['step_ms'] * 1e3:.0f} ex/s), host wall of a "
          f"synchronized step {prof['wall_ms']} ms (median), device busy "
          f"{prof['busy_ms']} ms, idle share {prof['idle_share']:.4f}, "
          f"{prof['device_ops_per_step']:.0f} kernels+copies per step")
    for kname, ms in prof["top"]:
        print(f"    {ms:9.5f} ms  {kname[:100]}")
    return prof


def step_phase(name: str, best_dir: str, capture_module, zero: set[str], card: str,
               kind: str) -> dict:
    """``step_vs_cpu`` for ``name``, a model on the BST kernels; the BST
    kernels at the inputs of the first attention call (``capture_module.
    bst_mha``, the entry the model calls) of that step's forward on cuda over
    all of its batch's rows, against their twins, timed beside their bounds
    and SDPA; the train step profiled (config defaults).  Returns
    bst_kernels_vs_twins's report at the captured inputs, the held step's
    reference (``step_vs_cpu``) and the train step's profile."""
    ref = step_vs_cpu(name, best_dir, zero)

    schema, weights, cfg, hb = step_setup(name, best_dir)
    tr = make_trainer(name, schema, weights, cfg, "cuda", best_dir)
    captured = {}
    plain_mha = capture_module.bst_mha

    def capture(q, k, v, lengths, *rest):
        if not captured:
            captured.update(q=q.detach().clone(), k=k.detach().clone(),
                            v=v.detach().clone(), lengths=lengths.clone())
        return plain_mha(q, k, v, lengths, *rest)

    capture_module.bst_mha = capture
    try:
        tr.model.train()
        with torch.no_grad():
            tr.model(tr._put_batch(hb))
    finally:
        capture_module.bst_mha = plain_mha

    q, k, v, lengths = (captured[x] for x in ("q", "k", "v", "lengths"))
    g = torch.from_numpy(np.random.default_rng(0).normal(size=tuple(q.shape))
                         .astype(np.float32)).cuda()
    r = bst_kernels_vs_twins(q, k, v, g, lengths, timed=True)
    lens = lengths.cpu().numpy()
    print(f"BST kernels at the {name} train step's first attention inputs "
          f"({tuple(q.shape)}, mean len {lens.mean():.2f}): {json.dumps(r, default=str)}")
    prof = train_step_profile(name, best_dir, card, kind, "bst_attention")
    return r, ref, prof


def bst_entries(reports: dict[str, dict], counts: dict[str, dict]) -> list[dict]:
    """The BST kernels' entries of the JSON line: the numbers at BST's train
    step inputs (``reports["BST"]``), ``launches`` summed over the main
    paths' runs (``counts``, by path), and ``autoint`` at AutoInt's inputs."""
    def err(r, key):
        return {"forward": r["err"]["forward"],
                "forward_save": max(r["err"]["forward"], r["err"]["P"]),
                "backward": r["err"]["backward"]}[key]

    r, ra = reports["BST"], reports["AutoInt"]
    entries = []
    for key in ("forward", "forward_save", "backward"):
        name = "bst_attention_" + key
        bound, by = r["bound"][key]
        by_path = {path: c[name] for path, c in counts.items()}
        entries.append({
            "name": name, "route": "cuda",
            "source": "recalgorithm_tpu_torch/csrc/bst_attention.cu",
            "replaces": BST_REPLACES[key], "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": err(r, key), "ms": r["ms"][key], "plain_ms": r["plain_ms"][key],
            "bound_ms": bound, "bound_by": by, "library_ms": r["library_ms"][key],
            "autoint": {"ms": ra["ms"][key], "bound_ms": ra["bound"][key][0],
                        "bound_by": ra["bound"][key][1], "plain_ms": ra["plain_ms"][key],
                        "library_ms": ra["library_ms"][key],
                        "library_ms_unmasked": ra["library_ms_unmasked"][key],
                        "max_abs_err": err(ra, key)}})
    return entries


def serve_export(name: str, best_dir: str, gen) -> None:
    """The export of ``name`` (a model on the BST kernels) served by
    build_server on cuda; every response held against the CPU; only the
    inference forward may launch."""
    from recalgorithm_tpu_torch.cli.serve import build_server
    from recalgorithm_tpu_torch.features.schema import wechat_schema
    from recalgorithm_tpu_torch.models import get_model
    from recalgorithm_tpu_torch.serving.predictor import Predictor

    args = argparse.Namespace(
        model=name, model_dir=None, export_dir=best_dir, vocabulary_dir=None,
        synthetic_vocab_scale=1.0, host="127.0.0.1", port=0,
        max_batch_size=256, max_delay_ms=2.0, device="cuda")
    schema = wechat_schema(gen.vocab_sizes())
    hb = gen.batch(32, 4)
    hb[SEQ][0], hb[SEQ + "_len"][0] = 0, 0
    zero_counts()
    httpd, batchers = build_server(args)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    results: dict[int, float] = {}
    errors: list[Exception] = []

    def client(rows):
        try:
            for i in rows:
                results[i] = post(url, payload_of(hb, i, schema))[0]
        except Exception as exc:  # reported below, fails the run
            errors.append(exc)

    try:
        threads = [threading.Thread(target=client, args=(range(j, 32, 4),)) for j in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
    finally:
        httpd.shutdown()
        httpd.server_close()
        for bt in batchers.values():
            bt.close()
    counts = kernel_counts()
    if errors or len(results) != 32:
        raise AssertionError(f"{len(results)}/32 responses; errors: {errors[:3]}")
    cfg_cls, model_cls = get_model(name)
    want = Predictor(model_cls(cfg_cls(), schema), best_dir, device="cpu").predict_batch(hb)
    err = check_close(f"{name} HTTP responses vs CPU", np.array(
        [results[i] for i in range(32)], np.float32), want["read_comment"])
    print(f"32 {name} requests from 4 threads: vs CPU max abs err {err:.3e}; kernel "
          f"launches {counts}")
    if counts["bst_attention_forward"] <= 0 or any(
            n for k, n in counts.items() if k != "bst_attention_forward"):
        raise AssertionError(f"{name} serving must launch the inference forward only")


def train_and_resume(name: str, model_dir: str, layers: int) -> tuple[dict, str]:
    """``name`` (``layers`` attention calls a forward, on the BST kernels)
    trains through cli.main on cuda, BST_STEPS steps with an eval and a
    checkpoint every BST_EVAL_EVERY, then resumes to BST_RESUME_STEPS.
    Checks every kernel's launches exactly, the metrics, predictions.csv,
    the last checkpoint and the best export; returns (launches, best_dir)."""
    from recalgorithm_tpu_torch import convert
    from recalgorithm_tpu_torch.cli.main import EVAL_BATCHES
    from recalgorithm_tpu_torch.serving.predictor import Predictor

    every = ["--eval_every_steps", str(BST_EVAL_EVERY),
             "--save_checkpoints_steps", str(BST_EVAL_EVERY)]
    with card_kernels() as ran:
        first = train_cli(name, model_dir, BST_STEPS, every)
        resumed = train_cli(name, model_dir, BST_RESUME_STEPS, every)
    counts = hand_counts(ran)
    print(f"{name} kernel launches on the training path (the card's trace): {counts}")
    # inference forwards: every step-triggered eval, the final eval and the
    # predictions of each run, EVAL_BATCHES batches each
    evals = (BST_STEPS // BST_EVAL_EVERY + 2
             + (BST_RESUME_STEPS // BST_EVAL_EVERY - BST_STEPS // BST_EVAL_EVERY) + 2)
    want = {"din_attention": 0,
            "bst_attention_forward": layers * EVAL_BATCHES * evals,
            "bst_attention_forward_save": layers * BST_RESUME_STEPS,
            "bst_attention_backward": layers * BST_RESUME_STEPS}
    if counts != want:
        raise AssertionError(f"launches {counts}, want {want} (per attention layer: one "
                             "forward with P and one backward per train step, one forward "
                             "without P per eval or predict batch)")
    for final in (first, resumed):
        if not all(math.isfinite(x) for x in final.values()):
            raise AssertionError(f"non-finite eval metrics: {final}")
    with open(os.path.join(model_dir, "predictions.csv")) as f:
        rows = list(csv.reader(f))
    if rows[0] != ["read_comment_probabilities"] or len(rows) != 1 + EVAL_BATCHES * BST_BATCH:
        raise AssertionError(f"predictions.csv: header {rows[0]}, {len(rows)} lines")
    ckpts = sorted(os.listdir(os.path.join(model_dir, "checkpoints")))
    best_dir = Predictor.latest_best(model_dir)
    print(f"checkpoints {ckpts}; best export {best_dir}; predictions.csv "
          f"{len(rows) - 1} rows; final eval after resume {resumed}")
    if f"ckpt_{BST_RESUME_STEPS}.pt" not in ckpts or not os.path.exists(
            os.path.join(best_dir, convert.EXPORT_FILE)):
        raise AssertionError("missing checkpoint or best export")
    return {k: counts[k] for k in BST_KERNELS}, best_dir


def zoo_phase(work: str, gen, names=ZOO_MODELS, extra=None) -> dict[str, tuple[dict, str]]:
    """Each of ``names`` (config defaults, real tables) trains
    ZOO_TRAIN_STEPS steps at B=4096 through cli.main on cuda (with the
    flags ``extra`` gives a model) with a final eval and predictions (one
    column a task); its best export predicted by Predictor on cuda is held
    to the CPU within TOL, every task.  These paths run no hand kernel.
    Returns each model's final eval and best export directory."""
    from recalgorithm_tpu_torch.cli.main import EVAL_BATCHES
    from recalgorithm_tpu_torch.features.schema import wechat_schema
    from recalgorithm_tpu_torch.models import get_model
    from recalgorithm_tpu_torch.serving.predictor import Predictor

    schema = wechat_schema(gen.vocab_sizes())
    batch = gen.batch(ZOO_PREDICT_BATCH, 5)
    runs = {}
    for name in names:
        t0 = time.perf_counter()
        model_dir = os.path.join(work, name)
        zero_counts()
        final = train_cli(name, model_dir, ZOO_TRAIN_STEPS, (extra or {}).get(name, ()))
        counts = kernel_counts()
        if any(counts.values()):
            raise AssertionError(f"{name} launched hand kernels it does not use: {counts}")
        if not final or not all(math.isfinite(x) for x in final.values()):
            raise AssertionError(f"{name}: final eval {final}")
        cfg_cls, model_cls = get_model(name)
        tasks = cfg_cls().task_names or (schema.labels[0],)
        with open(os.path.join(model_dir, "predictions.csv")) as f:
            rows = list(csv.reader(f))
        if rows[0] != [f"{t}_probabilities" for t in tasks] or \
                len(rows) - 1 != EVAL_BATCHES * BST_BATCH:
            raise AssertionError(f"{name} predictions.csv: header {rows[0]}, {len(rows) - 1} rows")
        best_dir = Predictor.latest_best(model_dir)
        runs[name] = (final, best_dir)
        got = Predictor(model_cls(cfg_cls(), schema), best_dir, device="cuda").predict_batch(batch)
        want = Predictor(model_cls(cfg_cls(), schema), best_dir, device="cpu").predict_batch(batch)
        if set(got) != set(tasks):
            raise AssertionError(f"{name}: Predictor tasks {sorted(got)}, want {tasks}")
        err = max(check_close(f"{name} {t} export on cuda vs CPU", got[t], want[t])
                  for t in tasks)
        print(f"{name}: best export {os.path.basename(best_dir)}; Predictor B="
              f"{ZOO_PREDICT_BATCH} on cuda vs CPU, {len(tasks)} task(s), max abs err "
              f"{err:.3e}; {time.perf_counter() - t0:.2f} s", flush=True)
    return runs


def token_tables(sizes: dict[str, int]) -> dict[str, np.ndarray]:
    """Per vocabulary, the token of each id: b"" for id 0 (missing), then
    ``<vocab>_<id>`` for 1..size, the lines of vocabulary/<vocab>.txt."""
    return {v: np.array([b""] + [f"{v}_{i}".encode() for i in range(1, n + 1)], dtype=object)
            for v, n in sizes.items()}


def write_vocabulary(vocab_dir: str, tables: dict[str, np.ndarray]) -> None:
    os.makedirs(vocab_dir, exist_ok=True)
    for v, tab in tables.items():
        with open(os.path.join(vocab_dir, f"{v}.txt"), "wb") as f:
            f.write(b"\n".join(tab[1:]) + b"\n")


def write_split(path: str, schema, gen, tables, n_rows: int, first_seed: int) -> tuple:
    """``n_rows`` rows of ``gen`` (batches of BST_BATCH from ``first_seed``)
    written to ``path`` by the port's native writer, one append a batch.
    Returns the written arrays (keyed like a batch) and the seconds spent
    marshalling tokens and in the writer."""
    from recalgorithm_tpu_torch.runtime import loader

    cols: dict[str, list] = defaultdict(list)
    marshal_s = write_s = 0.0
    for b in range(-(-n_rows // BST_BATCH)):
        hb = gen.batch(BST_BATCH, first_seed + b)
        hb = {k: v[: n_rows - b * BST_BATCH] for k, v in hb.items()}
        for k, v in hb.items():
            cols[k].append(v)
        t0 = time.perf_counter()
        cat_cols = [tables[f.vocab][hb[f.name]].tolist() for f in schema.categorical]
        seq_cols = [[tables[f.vocab][row[:n]].tolist()
                     for row, n in zip(hb[f.name], hb[f.name + "_len"])]
                    for f in schema.sequence]
        t1 = time.perf_counter()
        loader.write_sequence_examples(
            path, list(schema.dense_names), hb["dense"], list(schema.categorical_names),
            cat_cols, list(schema.labels), hb["labels"], list(schema.sequence_names),
            seq_cols, append=b > 0)
        marshal_s += t1 - t0
        write_s += time.perf_counter() - t1
    return {k: np.concatenate(v) for k, v in cols.items()}, marshal_s, write_s


def check_arrays_equal(name: str, data, want: dict) -> None:
    """A DatasetArrays bitwise equal to the written columns."""
    got = data.as_flat()
    if got.keys() != want.keys():
        raise AssertionError(f"{name}: columns {sorted(got)} vs {sorted(want)}")
    for k, v in want.items():
        if got[k].dtype != v.dtype or not np.array_equal(got[k], v):
            raise AssertionError(f"{name}: column {k} differs from what was written")


def data_cli(model: str, model_dir: str, files: tuple, steps: int, extra=()) -> dict:
    """One run of the port's training entry point on cuda, full width, on
    TFRecord files: ``files`` = (train, eval, vocabulary dir)."""
    train, evals, vocab_dir = files
    return train_cli(model, model_dir, steps, (
        "--train_data", train, "--eval_data", evals, "--vocabulary_dir", vocab_dir,
        *extra), synthetic=False)


def check_predictions(name: str, path: str, ids: tuple, tables, want: dict,
                      schema) -> tuple[np.ndarray, np.ndarray]:
    """predictions.csv in file order: the id columns ``ids`` (sorted, as the
    JAX CLI writes them) carry the written tokens, the label columns the
    written labels.  Returns (labels, first task's probabilities)."""
    with open(path) as f:
        rows = list(csv.reader(f))
    header, rows = rows[0], rows[1:]
    n = len(want["labels"])
    if header[:2] != list(ids) or header[3:] != list(schema.labels) or len(rows) != n:
        raise AssertionError(f"{name} predictions.csv: header {header}, {len(rows)} rows "
                             f"(want {n})")
    cols = list(zip(*rows))
    for i, field in enumerate(ids):
        if list(cols[i]) != [t.decode() for t in tables[schema.vocab_of(field)][want[field]]]:
            raise AssertionError(f"{name} predictions.csv: {field} tokens are not the written ones")
    got_labels = np.array(cols[3:], dtype=np.float32).T
    if not np.array_equal(got_labels, want["labels"]):
        raise AssertionError(f"{name} predictions.csv: labels are not the written ones")
    probs = np.array(cols[2], dtype=np.float64)
    if not ((probs >= 0) & (probs <= 1)).all():
        raise AssertionError(f"{name} predictions.csv: probabilities outside [0, 1]")
    return got_labels, probs


def feed_profile(trainer, it, steps: int) -> dict:
    """Host wall of ``steps`` train steps fed by ``it`` (after FEED_WARM
    steps), ex/s, and the share of the wall spent in ``next(it)``."""
    for _ in range(FEED_WARM):
        trainer.train_step(next(it))
    torch.cuda.synchronize()
    wait = 0.0
    t_start = time.perf_counter()
    for _ in range(steps):
        t0 = time.perf_counter()
        hb = next(it)
        wait += time.perf_counter() - t0
        trainer.train_step(hb)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    return {"step_ms": 1e3 * wall / steps, "ex_per_s": steps * BST_BATCH / wall,
            "wait_share": wait / wall}


def cpu_model() -> str:
    """The host CPU's model name (lscpu, else /proc/cpuinfo) and count."""
    out = subprocess.run(["lscpu"], capture_output=True, text=True, timeout=60).stdout
    with open("/proc/cpuinfo") as f:
        out += f.read()
    for line in out.splitlines():
        key, _, value = line.partition(":")
        if key.strip().lower() == "model name" and value.strip():
            return f"{value.strip()} ({os.cpu_count()} CPUs)"
    return f"not reported ({os.cpu_count()} CPUs)"


def files_phase(work: str) -> tuple[dict[str, dict], dict[str, str]]:
    """Phase 13: training from TFRecord files.  Returns the kernel launches
    of its two paths (BST from the files, DIN streaming them), and what
    phase 14 scores: the serving artifact of BST's resumed run (exported by
    cli.main at B=BST_BATCH), its predictions.csv, the eval split and its
    vocabulary."""
    from recalgorithm_tpu_torch.data import pipeline
    from recalgorithm_tpu_torch.data.synthetic import SyntheticConfig, SyntheticWeChat
    from recalgorithm_tpu_torch.features.schema import douban_schema, wechat_schema
    from recalgorithm_tpu_torch.features.vocab import VocabularyStore
    from recalgorithm_tpu_torch.models.bst import BST, BSTConfig
    from recalgorithm_tpu_torch.runtime import loader
    from recalgorithm_tpu_torch.train import optimizers
    from recalgorithm_tpu_torch.train.loop import Trainer, TrainerConfig
    from recalgorithm_tpu_torch.train.metrics import exact_auc

    root = os.path.join(work, "files")
    os.makedirs(root)
    # ---- the WeChat split, written and read back
    gen = SyntheticWeChat(wechat_schema(), SyntheticConfig(seed=FILE_SEED, vocab_scale=1.0))
    schema = wechat_schema(gen.vocab_sizes())
    tables = token_tables(gen.vocab_sizes())
    vocab_dir = os.path.join(root, "vocabulary")
    write_vocabulary(vocab_dir, tables)
    vocabs = VocabularyStore.from_dir(vocab_dir)
    if wechat_schema(vocabs.sizes()) != schema:
        raise AssertionError("the schema of the vocabulary directory is not the generator's")
    train_path, eval_path = os.path.join(root, "train.tfrecord"), os.path.join(root, "test.tfrecord")
    train_want, m_s, w_s = write_split(train_path, schema, gen, tables, FILE_TRAIN_ROWS, 0)
    eval_want, em_s, ew_s = write_split(eval_path, schema, gen, tables, FILE_EVAL_ROWS, 100_000)
    n_written = FILE_TRAIN_ROWS + FILE_EVAL_ROWS
    n_mb = (os.path.getsize(train_path) + os.path.getsize(eval_path)) / 1e6
    print(f"wrote {FILE_TRAIN_ROWS} + {FILE_EVAL_ROWS} rows ({n_mb:.1f} MB): native writer "
          f"{n_written / (w_s + ew_s):,.0f} rows/s ({n_mb / (w_s + ew_s):.1f} MB/s), token "
          f"marshalling {n_written / (m_s + em_s):,.0f} rows/s")
    native_s = []
    for _ in range(2):  # the second read finds the file in the page cache
        t0 = time.perf_counter()
        train_data = loader.read_dataset(train_path, schema, vocabs)
        native_s.append(time.perf_counter() - t0)
    check_arrays_equal("native reader, train split", train_data, train_want)
    eval_data = loader.read_dataset(eval_path, schema, vocabs)
    check_arrays_equal("native reader, eval split", eval_data, eval_want)
    t0 = time.perf_counter()
    py_data = pipeline.load_dataset(train_path, schema, vocabs, limit=FILE_PY_ROWS,
                                    prefer_native=False)
    py_s = time.perf_counter() - t0
    check_arrays_equal("Python parser", py_data, {k: v[:FILE_PY_ROWS] for k, v in train_want.items()})
    t0 = time.perf_counter()
    n_batches = sum(1 for _ in pipeline.prefetch(pipeline.batches(
        train_data, BST_BATCH, shuffle=True, seed=0, drop_remainder=True)))
    batches_s = time.perf_counter() - t0
    train_mb = os.path.getsize(train_path) / 1e6
    print(f"read back bitwise: native reader {FILE_TRAIN_ROWS / native_s[0]:,.0f} rows/s "
          f"({train_mb / native_s[0]:.1f} MB/s), again {FILE_TRAIN_ROWS / native_s[1]:,.0f} "
          f"rows/s ({train_mb / native_s[1]:.1f} MB/s), Python "
          f"parser {FILE_PY_ROWS / py_s:,.0f} rows/s ({FILE_PY_ROWS} rows); batches() through "
          f"prefetch {n_batches * BST_BATCH / batches_s:,.0f} rows/s ({n_batches} shuffled "
          f"batches of {BST_BATCH})")
    files = (train_path, eval_path, vocab_dir)
    n_eval_batches = -(-FILE_EVAL_ROWS // BST_BATCH)

    # ---- BST from the files, with periodic evals and a resume
    bst_dir = os.path.join(work, "bst_files")
    every = ["--eval_every_steps", str(FILE_BST_EVAL_EVERY),
             "--save_checkpoints_steps", str(FILE_BST_EVAL_EVERY)]
    artifact = os.path.join(bst_dir, "bst.pt2")
    with card_kernels() as ran:
        data_cli("BST", bst_dir, files, FILE_BST_STEPS, every)
        final = data_cli("BST", bst_dir, files, FILE_BST_RESUME,
                         [*every, "--export_stablehlo", artifact])
    bst_counts = hand_counts(ran)
    passes = (FILE_BST_STEPS // FILE_BST_EVAL_EVERY + 2
              + FILE_BST_RESUME // FILE_BST_EVAL_EVERY - FILE_BST_STEPS // FILE_BST_EVAL_EVERY + 2)
    want = {"din_attention": 0, "bst_attention_forward": passes * n_eval_batches,
            "bst_attention_forward_save": FILE_BST_RESUME,
            "bst_attention_backward": FILE_BST_RESUME}
    print(f"BST from the files, kernel launches (the card's trace): {bst_counts}")
    if bst_counts != want:
        raise AssertionError(f"launches {bst_counts}, want {want} (one forward with P and one "
                             "backward per train step, one forward per eval or predict batch)")
    labels, probs = check_predictions(
        "BST", os.path.join(bst_dir, "predictions.csv"), ("feedid", "userid"), tables,
        eval_want, schema)
    recomputed = exact_auc(labels[:, 0], probs)
    print(f"BST final eval after the resume {final}; exact AUC from predictions.csv "
          f"{recomputed}")
    if not all(math.isfinite(x) for x in final.values()) or \
            abs(final["read_comment_exact_auc"] - recomputed) > 1e-4:
        raise AssertionError("BST from the files: non-finite metrics, or the printed exact AUC "
                             "is not the one of predictions.csv")

    # ---- DIN streams the files through the chunk cache
    din_dir, cache_dir = os.path.join(work, "din_stream"), os.path.join(work, "stream_cache")
    din_steps = STREAM_EPOCHS * STREAM_LIMIT // BST_BATCH
    with card_kernels() as ran:
        din_final = data_cli("DIN", din_dir, files, din_steps, (
            "--stream", "--stream_chunk_records", str(STREAM_CHUNK), "--limit_examples",
            str(STREAM_LIMIT), "--stream_cache_dir", cache_dir, "--num_epochs",
            str(STREAM_EPOCHS)))
    din_counts = hand_counts(ran)
    print(f"DIN streaming the files, kernel launches (the card's trace): {din_counts}")
    want = {"din_attention": din_steps + 2 * n_eval_batches, "bst_attention_forward": 0,
            "bst_attention_forward_save": 0, "bst_attention_backward": 0}
    if din_counts != want or not math.isfinite(din_final["loss"]):
        raise AssertionError(f"DIN stream: launches {din_counts}, want {want}; {din_final}")
    manifests = {}
    for key in os.listdir(cache_dir):
        with open(os.path.join(cache_dir, key, "MANIFEST.json")) as f:
            m = json.load(f)
        manifests[m["identity"]["path"]] = m["num_chunks"]
    print(f"stream cache manifests (file: chunks): {manifests}")
    if manifests.get(os.path.abspath(train_path)) != STREAM_LIMIT // STREAM_CHUNK:
        raise AssertionError("the train split's chunk cache was not written after epoch 1")

    # ---- DeepFM accumulates gradients, profiled
    accum_dir = os.path.join(work, "deepfm_accum")
    zero_counts()
    data_cli("DeepFM", accum_dir, files, ACCUM_MICRO_STEPS, (
        "--grad_accum_steps", "2", "--profile_dir", os.path.join(accum_dir, "profile")))
    ck = torch.load(os.path.join(accum_dir, "checkpoints", f"ckpt_{ACCUM_MICRO_STEPS}.pt"),
                    map_location="cpu", weights_only=True)
    trace = os.path.join(accum_dir, "profile", "trace.json")
    print(f"DeepFM, --grad_accum_steps 2: {ACCUM_MICRO_STEPS} micro-steps, optimizer count "
          f"{ck['optimizer']['count']}, launches {kernel_counts()}; trace "
          f"{os.path.getsize(trace) if os.path.exists(trace) else 0} bytes")
    if any(kernel_counts().values()) or ck["optimizer"]["count"] != ACCUM_MICRO_STEPS // 2 \
            or ck["mini_step"] != 0 or not os.path.getsize(trace):
        raise AssertionError("DeepFM grad accumulation: launches, optimizer count or trace")

    # ---- a Douban-schema split: GenericDNN and DeepFM
    dgen = SyntheticWeChat(douban_schema(), SyntheticConfig(seed=FILE_SEED, vocab_scale=1.0))
    dschema = douban_schema(dgen.vocab_sizes())
    dtables = token_tables(dgen.vocab_sizes())
    droot = os.path.join(root, "douban")
    write_vocabulary(os.path.join(droot, "vocabulary"), dtables)
    dtrain, deval = os.path.join(droot, "train.tfrecord"), os.path.join(droot, "test.tfrecord")
    write_split(dtrain, dschema, dgen, dtables, DOUBAN_TRAIN_ROWS, 0)
    deval_want, *_ = write_split(deval, dschema, dgen, dtables, DOUBAN_EVAL_ROWS, 100_000)
    for name in ("GenericDNN", "DeepFM"):
        model_dir = os.path.join(work, f"douban_{name}")
        zero_counts()
        dfinal = data_cli(name, model_dir, (dtrain, deval, os.path.join(droot, "vocabulary")),
                          DOUBAN_STEPS, ("--dataset", "douban"))
        if any(kernel_counts().values()) or not math.isfinite(dfinal["loss"]):
            raise AssertionError(f"{name} on Douban: launches {kernel_counts()}, {dfinal}")
        check_predictions(name, os.path.join(model_dir, "predictions.csv"),
                          ("MOVIE_ID", "USER_MD5"), dtables, deval_want, dschema)
        print(f"{name} on the Douban split: final eval {dfinal}")

    # ---- where the time goes: BST's step fed from the files vs the stream
    print(f"host CPU: {cpu_model()}")
    model = BST(BSTConfig(), schema, torch.Generator().manual_seed(0))
    trainer = Trainer(model, ("read_comment",), optimizers.build("adam", 0.005),
                      TrainerConfig(model_dir=os.path.join(work, "feed")), device="cuda")
    need = FEED_WARM + FEED_STEPS
    for turn, feed in enumerate(("synthetic", "files", "files", "synthetic")):
        if feed == "synthetic":  # as phase 7's cli.main feeds it
            it = gen.batches(BST_BATCH, need, start_seed=1000 * turn)
        else:  # as cli.main feeds the files
            it = pipeline.prefetch(pipeline.batches(train_data, BST_BATCH, seed=turn,
                                                    drop_remainder=True, max_steps=need))
        r = feed_profile(trainer, iter(it), FEED_STEPS)
        print(f"BST train step fed by {feed} (turn {turn}): host wall {r['step_ms']:.3f} ms, "
              f"{r['ex_per_s']:,.0f} ex/s, waiting for the next batch "
              f"{r['wait_share']:.4f} of the wall", flush=True)
    return ({"BST from files": bst_counts, "DIN stream": din_counts},
            {"artifact": artifact, "predictions": os.path.join(bst_dir, "predictions.csv"),
             "eval": eval_path, "vocabulary": vocab_dir, "train": train_path,
             "bst_dir": bst_dir})


def artifact_batches(gen, n: int, rows: int = ARTIFACT_BATCH) -> list[dict]:
    """``n`` batches of ``rows``, an empty and a full history in each."""
    out = []
    for i in range(n):
        hb = gen.batch(rows, 30 + i)
        hb[SEQ][0], hb[SEQ + "_len"][0] = 0, 0
        hb[SEQ][1], hb[SEQ + "_len"][1] = np.arange(1, 51, dtype=np.int32) * 997, 50
        out.append(hb)
    return out


def export_on_cuda(live, path: str, quantize: bool, rows: int = ARTIFACT_BATCH):
    """``live`` (a Predictor on cuda)'s model exported at ``rows``, then served
    by HLOPredictor on cuda; prints the export's time and size."""
    from recalgorithm_tpu_torch.serving.export import export_stablehlo
    from recalgorithm_tpu_torch.serving.predictor import HLOPredictor

    t0 = time.perf_counter()
    export_stablehlo(live.model, live.model.schema, rows, path, quantize_embeddings=quantize)
    t1 = time.perf_counter()
    pred = HLOPredictor(path, device="cuda")
    print(f"  exported {os.path.basename(path)} (B={rows}, int8 tables={quantize}): "
          f"{os.path.getsize(path)} bytes, export {t1 - t0:.2f} s, load onto cuda "
          f"{time.perf_counter() - t1:.2f} s", flush=True)
    return pred


def artifact_checks(name: str, export_dir: str, schema, gen, work: str
                    ) -> tuple[dict[str, int], str]:
    """``name``'s export (config defaults) exported on cuda as an f32 and an
    int8 artifact at ARTIFACT_BATCH: each program holds one node of the
    model's kernel op; served by HLOPredictor on cuda it launches that kernel
    exactly once a batch and nothing else, and equals the live Predictor on
    cuda (quantize as the artifact) within TOL; int8 and f32 agree within
    INT8_ATOL.  Returns the launches of the artifacts' predictions and the
    f32 artifact's path."""
    from recalgorithm_tpu_torch.models import get_model
    from recalgorithm_tpu_torch.serving.predictor import Predictor

    cfg_cls, model_cls = get_model(name)
    kernel = "din_attention" if name == "DIN" else "bst_attention_forward"
    batches = artifact_batches(gen, ARTIFACT_BATCHES)
    probs, launches, paths = {}, defaultdict(int), {}
    f32 = Predictor(model_cls(cfg_cls(), schema), export_dir, device="cuda")
    for quantize in (False, True):
        live = f32 if not quantize else Predictor(model_cls(cfg_cls(), schema), export_dir,
                                                  device="cuda", quantize=True)
        paths[quantize] = os.path.join(work, f"{name}{'_int8' if quantize else ''}.pt2")
        pred = export_on_cuda(f32, paths[quantize], quantize)
        nodes = [str(n.target) for n in pred.program.graph.nodes if n.op == "call_function"]
        ops = [n for n in nodes if n.startswith("recalgorithm_torch.")]
        if ops != [KERNEL_OPS[name]]:
            raise AssertionError(f"{name} artifact: kernel op nodes {ops}, want "
                                 f"[{KERNEL_OPS[name]}]")
        zero_counts()
        got = [pred.predict_batch(hb)["read_comment"] for hb in batches]
        counts = kernel_counts()
        want = {k: (ARTIFACT_BATCHES if k == kernel else 0) for k in counts}
        if counts != want:
            raise AssertionError(f"{name} artifact (int8 {quantize}): launches {counts}, "
                                 f"want {want} (one {kernel} a batch)")
        for k, n in counts.items():
            launches[k] += n
        live_probs = [live.predict_batch(hb)["read_comment"] for hb in batches]
        err = max(check_close(f"{name} artifact (int8 {quantize}) vs the live Predictor", a, b)
                  for a, b in zip(got, live_probs))
        probs[quantize] = np.concatenate(got)
        print(f"  {name} artifact, int8 tables {quantize}: {ARTIFACT_BATCHES} batches of "
              f"{ARTIFACT_BATCH} on cuda vs the live Predictor on cuda max abs err {err:.3e}; "
              f"launches {counts}; op node {ops[0]}", flush=True)
    gap = float(np.abs(probs[True] - probs[False]).max())
    print(f"  {name}: int8 vs f32 artifact max abs diff {gap:.3e} (bound {INT8_ATOL})")
    if not 0 < gap < INT8_ATOL:
        raise AssertionError(f"{name}: int8 vs f32 probabilities differ by {gap}")
    return dict(launches), paths[False]


def artifacts_phase(work: str, gen, din_export: str, bst_export: str, wd_export: str,
                    scoring: dict[str, str], card: str) -> dict[str, dict[str, int]]:
    """Phase 14: serving artifacts on the card.  Returns each path's kernel
    launches: the DIN and BST artifacts' predictions, HTTP, cli.score."""
    from recalgorithm_tpu_torch.cli import score
    from recalgorithm_tpu_torch.cli.serve import build_server
    from recalgorithm_tpu_torch.features.schema import wechat_schema
    from recalgorithm_tpu_torch.models.din import DIN, DINConfig
    from recalgorithm_tpu_torch.models.wide_and_deep import WideAndDeep, WideAndDeepConfig
    from recalgorithm_tpu_torch.serving.predictor import HLOPredictor, Predictor

    root = os.path.join(work, "artifacts")
    os.makedirs(root)
    schema = wechat_schema(gen.vocab_sizes())
    t_phase = time.perf_counter()
    din_launches, din_f32 = artifact_checks("DIN", din_export, schema, gen, root)
    bst_launches, bst_f32 = artifact_checks("BST", bst_export, schema, gen, root)

    # ---- artifact sizes: W&D, whose 100,000-bucket cross table dominates
    sizes, wd_probs = {}, {}
    live = Predictor(WideAndDeep(WideAndDeepConfig(), schema), wd_export, device="cuda")
    for quantize in (False, True):
        path = os.path.join(root, f"WideAndDeep{'_int8' if quantize else ''}.pt2")
        pred = export_on_cuda(live, path, quantize)
        sizes[quantize] = os.path.getsize(path)
        zero_counts()
        wd_probs[quantize] = pred.predict_batch(artifact_batches(gen, 1)[0])["read_comment"]
        if any(kernel_counts().values()):
            raise AssertionError(f"the W&D artifact launched hand kernels: {kernel_counts()}")
    ratio = sizes[True] / sizes[False]
    gap = float(np.abs(wd_probs[True] - wd_probs[False]).max())
    print(f"  WideAndDeep artifact bytes: f32 {sizes[False]}, int8 {sizes[True]}, ratio "
          f"{ratio:.4f} (bound {INT8_BYTES}); int8 vs f32 max abs diff {gap:.3e}")
    if not ratio < INT8_BYTES or not gap < INT8_ATOL:
        raise AssertionError("the W&D int8 artifact is not small enough or not close enough")

    # ---- cli/serve.py --stablehlo din=... --stablehlo bst=... over HTTP
    args = argparse.Namespace(
        stablehlo=[f"din={din_f32}", f"bst={bst_f32}"], model=None, vocabulary_dir=None,
        synthetic_vocab_scale=1.0, host="127.0.0.1", port=0, max_batch_size=256,
        max_delay_ms=2.0, device="cuda")
    hb = artifact_batches(gen, 1, rows=16)[0]
    zero_counts()
    httpd, batchers = build_server(args)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    results: dict[tuple[str, int], float] = {}
    errors: list[Exception] = []

    def client(rows):
        try:
            for name in ("din", "bst"):
                for i in rows:
                    results[name, i] = post(url, payload_of(hb, i, schema), f"/predict/{name}")[0]
        except Exception as exc:  # reported below, fails the run
            errors.append(exc)

    try:
        threads = [threading.Thread(target=client, args=(range(j, 16, 4),)) for j in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        try:
            post(url, payload_of(hb, 0, schema))
            refused = None
        except urllib.error.HTTPError as e:
            refused = (e.code, json.loads(e.read())["error"])
    finally:
        httpd.shutdown()
        httpd.server_close()
        for bt in batchers.values():
            bt.close()
    http_counts = kernel_counts()
    if errors or len(results) != 32:
        raise AssertionError(f"{len(results)}/32 responses; errors: {errors[:3]}")
    if refused is None or refused[0] != 404 or "several models" not in refused[1]:
        raise AssertionError(f"a bare /predict with two artifacts served: {refused}")
    for name, path in (("din", din_f32), ("bst", bst_f32)):
        want = HLOPredictor(path, device="cuda").predict_batch(hb)["read_comment"]
        err = check_close(f"HTTP /predict/{name} vs the artifact", np.array(
            [results[name, i] for i in range(16)], np.float32), want)
        print(f"  16 requests to /predict/{name} from 4 threads: vs its artifact's "
              f"predict_batch max abs err {err:.3e}")
    print(f"  a bare /predict: {refused[0]} ({refused[1]}); launches {http_counts}")
    if http_counts["din_attention"] <= 0 or http_counts["bst_attention_forward"] <= 0 or \
            http_counts["bst_attention_forward_save"] or http_counts["bst_attention_backward"]:
        raise AssertionError(f"HTTP artifacts: launches {http_counts}")

    # ---- cli/score.py: phase 13's BST artifact on its 62,000-row eval split
    out_csv = os.path.join(root, "scored.csv")
    zero_counts()
    t0 = time.perf_counter()
    score.main(["--stablehlo", scoring["artifact"], "--data", scoring["eval"],
                "--vocabulary_dir", scoring["vocabulary"], "--out", out_csv, "--device", "cuda"])
    score_s = time.perf_counter() - t0
    score_counts = kernel_counts()
    n_batches = -(-FILE_EVAL_ROWS // BST_BATCH)
    want_counts = {k: (n_batches if k == "bst_attention_forward" else 0) for k in score_counts}
    if score_counts != want_counts:
        raise AssertionError(f"cli.score: launches {score_counts}, want {want_counts}")
    with open(out_csv) as f:
        got = list(csv.reader(f))
    with open(scoring["predictions"]) as f:
        want = list(csv.reader(f))
    if got[0] != want[0] or len(got) != len(want) or len(got) != 1 + FILE_EVAL_ROWS:
        raise AssertionError(f"cli.score: header {got[0]} vs {want[0]}, {len(got) - 1} rows "
                             f"vs {len(want) - 1}")
    g, w = np.array(got[1:], dtype=object), np.array(want[1:], dtype=object)
    other = [0, 1, *range(3, g.shape[1])]
    if not np.array_equal(g[:, other], w[:, other]):
        raise AssertionError("cli.score: id tokens or labels differ from predictions.csv")
    diff = np.abs(g[:, 2].astype(np.float64) - w[:, 2].astype(np.float64))
    same = int((g[:, 2] == w[:, 2]).sum())
    print(f"  cli.score on the {FILE_EVAL_ROWS}-row eval split: {score_s:.2f} s, launches "
          f"{score_counts}; vs phase 13's predictions.csv: tokens and labels equal, "
          f"probabilities max abs diff {diff.max():.1e} ({same} of {FILE_EVAL_ROWS} strings "
          "equal)")
    if diff.max() > 1e-6 + 1e-12:  # the CSV's last decimal
        raise AssertionError("cli.score's probabilities are not predictions.csv's")

    # ---- where a served batch's time goes: the artifact against the live
    # Predictor, DIN, f32
    print(f"  DIN served batch wall, median of {PROFILE_ITERS} calls after 3 warm ({card}):")
    live = Predictor(DIN(DINConfig(), schema), din_export, device="cuda")
    for rows in TIMED_BATCHES:
        pred = (HLOPredictor(din_f32, device="cuda") if rows == ARTIFACT_BATCH else
                export_on_cuda(live, os.path.join(root, f"DIN_b{rows}.pt2"), False, rows))
        hb = artifact_batches(gen, 1, rows=rows)[0]
        walls = {}
        for label, p in (("artifact", pred), ("live", live), ("live", live),
                         ("artifact", pred)):
            for _ in range(3):
                p.predict_batch(hb)
            ts = []
            for _ in range(PROFILE_ITERS):
                t0 = time.perf_counter()
                p.predict_batch(hb)
                ts.append(time.perf_counter() - t0)
            walls.setdefault(label, []).append(float(np.median(ts)) * 1e3)
        print(f"    B={rows}: artifact {walls['artifact']} ms, live Predictor "
              f"{walls['live']} ms (turns artifact, live, live, artifact)", flush=True)
    print(f"phase 14 took {time.perf_counter() - t_phase:.1f} s")
    return {"DIN artifacts": din_launches, "BST artifacts": bst_launches,
            "HTTP artifacts": http_counts, "cli.score": score_counts}


def lazy_adam_untouched(best_dir: str) -> None:
    """DIEN train steps on cuda (config defaults, LazyAdam, its count on the
    card): the second and third replay the step's graph, and in the third
    every element whose gradient is 0, and so every table row the batch did
    not read, is bitwise what it was before the step."""
    schema, weights, cfg, hb = step_setup("DIEN", best_dir)
    tr = make_trainer("DIEN", schema, weights, cfg, "cuda", best_dir)
    for _ in range(2):  # the warm-up, then the capture and its first replay
        tr.train_step(hb)
    # the batch columns each table is read with
    reads = defaultdict(list)
    for key, vocab, _ in tr.model.embedder.fields + [("feedid", "feedid", ""), (SEQ, "feedid", "")]:
        reads[f"embedder.embed.tables.{vocab}"].append(hb[key].reshape(-1))
    before = {n: p.detach().clone() for n, p in tr.model.named_parameters()}
    tr.train_step(hb)
    if tr.replays != 2:
        raise AssertionError(f"DIEN's steps 2 and 3: {tr.replays} replays, not 2")
    untouched_rows = moved = 0
    for n, p in tr.model.named_parameters():
        zero = p.grad == 0
        if not torch.equal(p.detach()[zero], before[n][zero]):
            raise AssertionError(f"LazyAdam moved elements of {n} whose gradient is 0")
        moved += int((p.detach() != before[n]).sum())
        if n in reads:
            unread = torch.ones(p.shape[0], dtype=torch.bool)
            unread[np.concatenate(reads[n])] = False
            unread = unread.to(p.device)
            if not bool(zero[unread].all()):
                raise AssertionError(f"{n}: a row the batch did not read has a gradient")
            untouched_rows += int(unread.sum())
    print(f"DIEN LazyAdam steps on cuda: steps 2 and 3 replayed; in the third "
          f"{untouched_rows} table rows the batch did not read and every element with a 0 "
          f"gradient bitwise unchanged; {moved} elements moved")


def plain_artifact_check(name: str, export_dir: str, schema, gen, work: str) -> None:
    """``name``'s export (a model without hand kernels) exported on cuda at
    ARTIFACT_BATCH and served by HLOPredictor on cuda: every task equal to
    the live Predictor on cuda within TOL, no hand kernel launched."""
    from recalgorithm_tpu_torch.models import get_model
    from recalgorithm_tpu_torch.serving.predictor import Predictor

    cfg_cls, model_cls = get_model(name)
    live = Predictor(model_cls(cfg_cls(), schema), export_dir, device="cuda")
    pred = export_on_cuda(live, os.path.join(work, f"{name}.pt2"), False)
    zero_counts()
    batches = artifact_batches(gen, ARTIFACT_BATCHES)
    got = [pred.predict_batch(hb) for hb in batches]
    if any(kernel_counts().values()):
        raise AssertionError(f"the {name} artifact launched hand kernels: {kernel_counts()}")
    want = [live.predict_batch(hb) for hb in batches]
    tasks = sorted(want[0])
    if sorted(got[0]) != tasks:
        raise AssertionError(f"{name} artifact outputs {sorted(got[0])}, live {tasks}")
    err = max(check_close(f"{name} artifact {t} vs the live Predictor", g[t], w[t])
              for g, w in zip(got, want) for t in tasks)
    print(f"  {name} artifact: outputs {tasks}; {ARTIFACT_BATCHES} batches of {ARTIFACT_BATCH} "
          f"on cuda vs the live Predictor on cuda max abs err {err:.3e}; 0 hand-kernel launches",
          flush=True)


def topk_vs_cpu(name: str, gpu: tuple, cpu: tuple, k: int) -> int:
    """A top-(k+1) on cuda (scores, ids) against its CPU twin on the same
    inputs, over the first k: every score within TOPK_TIE, and each row the
    same ids, or another set only where the CPU's k-th and (k+1)-th scores
    tie within TOPK_TIE (the rounding of the two devices' f32 sums).
    Returns the rows with the same ids in the same order."""
    (s_gpu, i_gpu), (s_cpu, i_cpu) = ([x.cpu().numpy() for x in r] for r in (gpu, cpu))
    same = (i_gpu[:, :k] == i_cpu[:, :k]).all(axis=1)
    sets = np.array([set(a) == set(b) for a, b in zip(i_gpu[:, :k], i_cpu[:, :k])])
    tie = s_cpu[:, k - 1] - s_cpu[:, k] <= TOPK_TIE
    err = float(np.abs(s_gpu[:, :k] - s_cpu[:, :k]).max())
    if not (err <= TOPK_TIE and (sets | tie).all()):
        raise AssertionError(f"{name} on cuda is not its CPU twin's beyond ties: scores within "
                             f"{err}, {int((~(sets | tie)).sum())} rows another set")
    return int(same.sum())


def quantized_overlap(exact, quant, users, k: int) -> float:
    """The mean share of each user's exact f32 top-k that the int8 corpus's
    top-k finds (the measure of tests/test_retrieval.py)."""
    ids_e, _ = exact.retrieve(users, k)
    ids_q, _ = quant.retrieve(users, k)
    return float(np.mean([len(set(a) & set(b)) / k for a, b in zip(ids_e, ids_q)]))


def retrieval_phase(best_dir: str, schema, recall: float, save_to: str) -> None:
    """TwoTower on cuda.  Full width (``best_dir``, the item corpus of
    cli.main's eval split): brute_force_top_k and quantized_top_k against
    their CPU twins on the same vectors (``topk_vs_cpu``); the int8 corpus's
    overlap with the exact top-k at k = 10 and RECALL_K, with the spread of
    the scores it has to resolve; cli.main's recall beside its random
    baseline.  The floor: tests/test_retrieval.py's own case (8-wide towers
    from a seed, the seed-7 stream at vocab scale 0.002, 4 corpus batches
    of 32, k = 10) on cuda, overlap at least QUANTIZED_OVERLAP.  The users and
    the f32 corpus go to ``save_to`` for phase 16's sharded top-k."""
    from recalgorithm_tpu_torch.cli.main import EVAL_BATCHES, EVAL_START_SEED
    from recalgorithm_tpu_torch.data.synthetic import SyntheticConfig, SyntheticWeChat
    from recalgorithm_tpu_torch.features.schema import wechat_schema
    from recalgorithm_tpu_torch.models.two_tower import TwoTower, TwoTowerConfig
    from recalgorithm_tpu_torch.serving.predictor import Predictor
    from recalgorithm_tpu_torch.serving.retrieval import (
        Retriever,
        brute_force_top_k,
        quantized_top_k,
    )

    # cli.main's eval split: its default seed, B=4096
    gen = SyntheticWeChat(wechat_schema(), SyntheticConfig(seed=42, vocab_scale=1.0))
    evals = list(gen.batches(BST_BATCH, EVAL_BATCHES, start_seed=EVAL_START_SEED))
    model = Predictor(TwoTower(TwoTowerConfig(), schema), best_dir, device="cuda").model
    t0 = time.perf_counter()
    exact = Retriever(model, "cuda")
    n = exact.build_corpus(evals)
    quant = Retriever(model, "cuda", quantize_corpus=True)
    quant.build_corpus(evals)
    build_s = time.perf_counter() - t0
    u = exact._embed(model.user_embedding, evals[0])[:TWIN_USERS]
    np.savez(save_to, users=u.cpu().numpy(), corpus=exact.corpus.cpu().numpy())
    k = RECALL_K
    same = topk_vs_cpu("brute_force_top_k", brute_force_top_k(u, exact.corpus, k + 1),
                       brute_force_top_k(u.cpu(), exact.corpus.cpu(), k + 1), k)
    q_args = (quant.corpus_q, quant.corpus_scale, k + 1)
    q_same = topk_vs_cpu("quantized_top_k", quantized_top_k(u, *q_args),
                         quantized_top_k(u.cpu(), *(x.cpu() for x in q_args[:2]), k + 1), k)
    scores = u @ exact.corpus.T
    top = torch.topk(scores, k + 1, dim=-1).values
    spread = float(scores.std(dim=1).mean())
    gap = float((top[:, k - 1] - top[:, k]).mean())
    overlaps = {kk: quantized_overlap(exact, quant, evals[0], kk) for kk in (10, k)}
    print(f"TwoTower retrieval on cuda, full width: corpus {n} items from the {EVAL_BATCHES} "
          f"eval batches (f32 and int8 built in {build_s:.2f} s); top-{k} of {len(u)} users "
          f"on cuda vs the CPU twin, same ids in the same order: brute_force_top_k {same}, "
          f"quantized_top_k {q_same} rows (every other row a tie within {TOPK_TIE}); int8 "
          f"overlap with the exact top-k {overlaps} (not gated: a user's scores spread "
          f"{spread:.5f} (std), the top-{k} boundary gap {gap:.2e} on average); "
          f"cli.main recall_at_{k} {recall:.4f}, random {k / n:.4f}", flush=True)

    tgen = SyntheticWeChat(wechat_schema(), SyntheticConfig(seed=7, vocab_scale=0.002))
    tschema = wechat_schema(tgen.vocab_sizes())
    tmodel = TwoTower(TwoTowerConfig(hidden_units=(32,), output_dim=8), tschema,
                      torch.Generator().manual_seed(0))
    texact, tquant = Retriever(tmodel, "cuda"), Retriever(tmodel, "cuda", quantize_corpus=True)
    for r in (texact, tquant):
        r.build_corpus(tgen.batch(32, s) for s in (1, 2, 3, 4))
    overlap = quantized_overlap(texact, tquant, tgen.batch(32, 0), 10)
    print(f"tests/test_retrieval.py's int8 case on cuda: overlap {overlap:.4f} "
          f"(floor {QUANTIZED_OVERLAP})", flush=True)
    if overlap < QUANTIZED_OVERLAP:
        raise AssertionError(f"quantized_top_k overlap {overlap} under {QUANTIZED_OVERLAP}")


def multitask_phase(work: str, gen, card: str, kind: str) -> None:
    """Phase 15: the multi-task family, DIEN and TwoTower at full width on
    cuda.  No hand kernel runs on these paths."""
    from recalgorithm_tpu_torch.features.schema import wechat_schema

    t_phase = time.perf_counter()
    schema = wechat_schema(gen.vocab_sizes())
    runs = zoo_phase(work, gen, NEW_MODELS,
                     {"TwoTower": ["--eval_recall_at", str(RECALL_K)]})
    for name, (final, _) in runs.items():
        tasks = [k for k in final if k.endswith("_auc") and not k.endswith("exact_auc")]
        print(f"  {name} final eval AUCs: " + ", ".join(f"{t} {final[t]:.4f}" for t in tasks))
    recall = runs["TwoTower"][0].get(f"recall_at_{RECALL_K}")
    if recall is None or "ctcvr_auc" not in runs["ESMM"][0]:
        raise AssertionError("cli.main reported no recall_at_K for TwoTower or no ctcvr_auc "
                             "for ESMM")
    dirs = {name: run[1] for name, run in runs.items()}
    times = {"cli.main": time.perf_counter() - t_phase}

    def timed(part, fn, *args, **kw):
        t0 = time.perf_counter()
        fn(*args, **kw)
        times[part] = times.get(part, 0.0) + time.perf_counter() - t0

    # no tower BN, as DeepFM's step: a bias in front of a train-mode BN has a
    # rounding-noise gradient; DIEN's Dice keeps its own BN
    timed("steps vs CPU", step_vs_cpu, "PLE", dirs["PLE"], set(), batch_norm=False)
    timed("steps vs CPU", step_vs_cpu, "DIEN", dirs["DIEN"], set(), batch_norm=False)
    timed("LazyAdam", lazy_adam_untouched, dirs["DIEN"])
    for name in ("PLE", "DIEN"):
        timed("profiles", train_step_profile, name, dirs[name], card, kind, kernel=None,
              iters=NEW_PROFILE_ITERS)
    timed("retrieval", retrieval_phase, dirs["TwoTower"], schema, recall,
          os.path.join(work, "retrieval.npz"))
    root = os.path.join(work, "artifacts_new")
    os.makedirs(root)
    for name in ("MMOE", "TwoTower"):
        timed("artifacts", plain_artifact_check, name, dirs[name], schema, gen, root)
    timed("goldens", golden_phase, NEW_MODELS, work)
    print(f"phase 15 took {time.perf_counter() - t_phase:.1f} s: "
          + ", ".join(f"{part} {s:.1f} s" for part, s in times.items()))


def mesh_step(tr, hb) -> tuple[float, dict]:
    """One train-mode forward and backward of a mesh trainer on this rank's
    rows ``hb``: the global loss and every gradient gathered whole (f64, on
    the CPU), each the global batch mean's as a 1-process step's."""
    from recalgorithm_tpu_torch.parallel import mesh as mesh_lib

    tr.model.train()
    loss, _ = tr._loss_and_logits(tr._put_batch(hb, tr.global_batch_size))
    loss.backward()
    global_loss = float(tr._reduce_grads(loss))
    return global_loss, {n: mesh_lib.gather_tensor(p.grad, tr.specs[n], tr.mesh).double().cpu()
                         for n, p in tr.model.named_parameters()}


def mesh_rank(rank: int, world: int, store: str, root: str) -> None:
    """One rank of phase 16 (``chip_smoke.py --mesh-rank``): joins the gloo
    group through ``store``, reads ``root/inputs.json`` and writes
    ``root/rank<r>.json`` (rank 0 also the gathered gradients and top-k)."""
    from recalgorithm_tpu_torch.data.synthetic import SyntheticConfig, SyntheticWeChat
    from recalgorithm_tpu_torch.features.schema import wechat_schema
    from recalgorithm_tpu_torch.parallel import mesh as mesh_lib
    from recalgorithm_tpu_torch.parallel import multihost
    from recalgorithm_tpu_torch.serving.retrieval import sharded_top_k

    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    backend = multihost.initialize(f"file://{store}", world, rank)
    with open(os.path.join(root, "inputs.json")) as f:
        inp = json.load(f)
    out: dict = {"rank": rank, "backend": backend,
                 "device": str(multihost.rank_device("cuda"))}
    print(f"rank {rank} of {world}: backend {backend}, {out['device']}", flush=True)
    try:
        data_mesh = mesh_lib.make_mesh(1)
        # (a) BST: the held step on this rank's rows of phase 8's batch
        schema, weights, cfg, _ = step_setup("BST", inp["bst_weights"])
        with np.load(os.path.join(root, "bst_batch.npz")) as z:
            hb = {k: z[k] for k in z.files}
        lo, hi = multihost.host_shard_range(len(hb["labels"]), data_mesh)
        zero_counts()
        tr = make_trainer("BST", schema, weights, cfg, "cuda", root, data_mesh,
                          len(hb["labels"]))
        out["bst_loss"], grads = mesh_step(tr, {k: v[lo:hi] for k, v in hb.items()})
        out["bst_rows"] = hi - lo
        out["bst_table_rows"] = int(tr.model.embedder.embed.tables["feedid"].shape[0])
        if rank == 0:
            np.savez(os.path.join(root, "bst_grads.npz"), **{k: v.numpy() for k, v in grads.items()})
        # MESH_STEPS steps, then the timed and profiled ones
        tr = make_trainer("BST", schema, weights, cfg, "cuda", root, data_mesh,
                          len(hb["labels"]))
        gen = SyntheticWeChat(wechat_schema(), SyntheticConfig(seed=7, vocab_scale=1.0))
        local = [{k: v[lo:hi] for k, v in gen.batch(len(hb["labels"]), MESH_BATCH_SEED + i).items()}
                 for i in range(MESH_STEPS)]
        out["bst_losses"] = [float(tr.train_step(b)) for b in local]
        prof = profile_train_step(tr, local[:4], "bst_attention", MESH_PROFILE_ITERS)
        out["bst_profile"] = {k: prof[k] for k in ("step_ms", "wall_ms", "busy_ms",
                                                  "idle_share", "device_ops_per_step")}
        out["bst_counts"] = kernel_counts()
        # (c) MMOE on a (data 1, model 2) mesh: every row on both ranks
        model_mesh = mesh_lib.make_mesh(2)
        schema, weights, cfg, _ = step_setup("MMOE", inp["mmoe_weights"], batch_norm=False,
                                            num_experts=MESH_EXPERTS)
        with np.load(os.path.join(root, "mmoe_batch.npz")) as z:
            hb = {k: z[k] for k in z.files}
        tr = make_trainer("MMOE", schema, weights, cfg, "cuda", root, model_mesh,
                          len(hb["labels"]))
        out["mmoe_loss"], grads = mesh_step(tr, hb)
        out["mmoe_local_experts"] = list(tr.model.experts.kernel.shape)
        if rank == 0:
            np.savez(os.path.join(root, "mmoe_grads.npz"), **{k: v.numpy() for k, v in grads.items()})
        # (d) sharded_top_k over every rank
        with np.load(inp["retrieval"]) as z:
            users, corpus = (torch.from_numpy(z[k]).cuda() for k in ("users", "corpus"))
        scores, idx = sharded_top_k(users, corpus, RECALL_K + 1, data_mesh)
        if rank == 0:
            np.savez(os.path.join(root, "top_k.npz"), scores=scores.cpu().numpy(),
                     indices=idx.cpu().numpy())
        # (b) cli.main from phase 13's checkpoint: no step left, eval and predict
        for mode, extra in (("whole", ()), ("stream", ("--stream", "--stream_chunk_records",
                                                        str(STREAM_CHUNK)))):
            zero_counts()
            final = data_cli("BST", os.path.join(root, f"cli_{mode}"), inp["files"],
                             FILE_BST_RESUME, extra)
            out[f"cli_{mode}"] = {"final": final, "counts": kernel_counts()}
    finally:
        multihost.shutdown()
    out["seconds"] = time.perf_counter() - t0
    with open(os.path.join(root, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def run_mesh_ranks(root: str) -> list[dict]:
    """Start MESH_RANKS processes of ``mesh_rank`` (this script with
    ``--mesh-rank``), each with MESH_RANK_TIMEOUT_S; print their logs; fail
    if any rank fails.  Returns each rank's results."""
    store = os.path.join(root, "store")
    logs = [open(os.path.join(root, f"rank{r}.log"), "w+") for r in range(MESH_RANKS)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--mesh-rank",
                               str(r), str(MESH_RANKS), store, root],
                              stdout=logs[r], stderr=subprocess.STDOUT, text=True)
             for r in range(MESH_RANKS)]
    deadline = time.monotonic() + MESH_RANK_TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:  # a rank left behind by a failure or the time limit
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, log in enumerate(logs):
        log.seek(0)
        lines = log.read().splitlines()
        log.close()
        print(f"  -- rank {r} (exit {procs[r].returncode}), last lines of its log:")
        for line in lines[-40:]:
            print(f"  [rank {r}] {line}")
    if any(p.returncode != 0 for p in procs):
        raise AssertionError(f"phase 16: rank exit codes {[p.returncode for p in procs]}")
    results = []
    for r in range(MESH_RANKS):
        with open(os.path.join(root, f"rank{r}.json")) as f:
            results.append(json.load(f))
    return results


def mesh_phase(work: str, bst_ref: dict, step_dir: str, bst_zero: set[str], scoring: dict,
               card: str) -> dict[str, dict]:
    """Phase 16: the port as MESH_RANKS processes sharing the one card over
    gloo.  The 1-process references first (alone on the card), then the
    ranks (``mesh_rank``), then every check.  Returns each rank's launches
    of every kernel over its paths."""
    from recalgorithm_tpu_torch import convert
    from recalgorithm_tpu_torch.data.synthetic import SyntheticConfig, SyntheticWeChat
    from recalgorithm_tpu_torch.features.schema import wechat_schema
    from recalgorithm_tpu_torch.models.mmoe import MMOE, MMOEConfig
    from recalgorithm_tpu_torch.serving.retrieval import brute_force_top_k

    t_phase = time.perf_counter()
    root = os.path.join(work, "mesh")
    os.makedirs(root)
    files = (scoring["train"], scoring["eval"], scoring["vocabulary"])
    # ---- inputs and the 1-process references
    np.savez(os.path.join(root, "bst_batch.npz"), **bst_ref["hb"])
    mmoe_cfg = MMOEConfig(dropout_rate=0.0, batch_norm=False, num_experts=MESH_EXPERTS)
    gen = SyntheticWeChat(wechat_schema(), SyntheticConfig(seed=7, vocab_scale=1.0))
    mmoe = MMOE(mmoe_cfg, wechat_schema(gen.vocab_sizes()),
                torch.Generator().manual_seed(STEP_WEIGHT_SEED))
    mmoe_dir = convert.save_export(os.path.join(root, "mmoe"), 0, 0.0, mmoe)
    mmoe_ref = step_reference("MMOE", mmoe_dir, batch_norm=False, num_experts=MESH_EXPERTS)
    np.savez(os.path.join(root, "mmoe_batch.npz"), **mmoe_ref["hb"])
    tr = make_trainer("MMOE", mmoe_ref["schema"], mmoe_ref["weights"], mmoe_ref["cfg"],
                      "cuda", root)
    loss, grads, _ = one_step(tr, tr._put_batch(mmoe_ref["hb"]))
    hold_step(f"MMOE, {MESH_EXPERTS} experts, 1 process (cuda)", mmoe_ref, loss, grads, set())
    tr = make_trainer("BST", bst_ref["schema"], bst_ref["weights"], bst_ref["cfg"], "cuda", root)
    rows = len(bst_ref["hb"]["labels"])
    one_losses = [float(tr.train_step(gen.batch(rows, MESH_BATCH_SEED + i)))
                  for i in range(MESH_STEPS)]
    for mode in ("one", "whole", "stream"):  # phase 13's BST run, restored in each
        shutil.copytree(scoring["bst_dir"], os.path.join(root, f"cli_{mode}"))
    one_final = data_cli("BST", os.path.join(root, "cli_one"), files, FILE_BST_RESUME)
    with open(os.path.join(root, "inputs.json"), "w") as f:
        json.dump({"bst_weights": step_dir, "mmoe_weights": mmoe_dir, "files": files,
                   "retrieval": os.path.join(work, "retrieval.npz")}, f)
    t_ref = time.perf_counter() - t_phase
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # ---- the ranks
    t0 = time.perf_counter()
    ranks = run_mesh_ranks(root)
    t_ranks = time.perf_counter() - t0

    # ---- (a) BST
    with np.load(os.path.join(root, "bst_grads.npz")) as z:
        grads = {k: torch.from_numpy(z[k]) for k in z.files}
    losses = {r["rank"]: r["bst_loss"] for r in ranks}
    if len(set(losses.values())) != 1:
        raise AssertionError(f"the ranks disagree on the global loss: {losses}")
    tables = [(r["bst_table_rows"], r["bst_rows"]) for r in ranks]
    print(f"BST on {MESH_RANKS} ranks sharing one card over {ranks[0]['backend']}: each rank "
          f"(feedid table rows held, batch rows) {tables} of "
          f"{grads['embedder.embed.tables.feedid'].shape[0]} rows and B={rows}")
    bst_ratio = hold_step(f"BST on {MESH_RANKS} ranks, gradients gathered whole", bst_ref,
                          losses[0], grads, bst_zero)
    print(f"BST, {MESH_STEPS} Adam steps, global loss: 1 process {one_losses}")
    for r in ranks:
        print(f"  rank {r['rank']}: {r['bst_losses']}")
        if not np.allclose(r["bst_losses"], one_losses, rtol=MESH_LOSS_RTOL, atol=0):
            raise AssertionError(f"rank {r['rank']}'s losses beyond rtol {MESH_LOSS_RTOL} of "
                                 "the 1-process run's")
    steps = 1 + MESH_STEPS + 3 + 3 * MESH_PROFILE_ITERS
    want = {"din_attention": 0, "bst_attention_forward": 0,
            "bst_attention_forward_save": steps, "bst_attention_backward": steps}
    for r in ranks:
        if r["bst_counts"] != want:
            raise AssertionError(f"rank {r['rank']}: BST kernel launches {r['bst_counts']}, "
                                 f"want {want}")
        print(f"  rank {r['rank']} BST kernel launches {r['bst_counts']} (want {want})")
        prof = r["bst_profile"]
        print(f"  rank {r['rank']} train step, B={rows // MESH_RANKS} a rank, two ranks "
              f"sharing one card ({card}) over {r['backend']}: {prof['step_ms']} ms a step "
              f"(CUDA events over {MESH_PROFILE_ITERS} steps), host wall "
              f"{prof['wall_ms']} ms, device busy {prof['busy_ms']} ms of this rank's "
              f"kernels, idle share {prof['idle_share']:.4f} (the other rank's kernels "
              f"count as idle here), {prof['device_ops_per_step']:.0f} kernels+copies "
              "per step")
    # ---- (c) MMOE
    with np.load(os.path.join(root, "mmoe_grads.npz")) as z:
        grads = {k: torch.from_numpy(z[k]) for k in z.files}
    whole = list(grads["experts.kernel"].shape)
    print(f"MMOE on a (data 1, model {MESH_RANKS}) mesh: each rank holds experts.kernel "
          f"{[r['mmoe_local_experts'] for r in ranks]} of {whole}")
    if any(r["mmoe_local_experts"] != [whole[0] // MESH_RANKS, *whole[1:]] for r in ranks):
        raise AssertionError("MMOE's experts are not split over the model axis")
    mmoe_ratio = hold_step(f"MMOE on a (1, {MESH_RANKS}) mesh, gradients gathered whole",
                           mmoe_ref, ranks[0]["mmoe_loss"], grads, set())
    # ---- (d) sharded_top_k
    with np.load(os.path.join(work, "retrieval.npz")) as z:
        users, corpus = (torch.from_numpy(z[k]).cuda() for k in ("users", "corpus"))
    with np.load(os.path.join(root, "top_k.npz")) as z:
        sharded = (torch.from_numpy(z["scores"]), torch.from_numpy(z["indices"]))
    same = topk_vs_cpu("sharded_top_k", sharded, brute_force_top_k(users, corpus, RECALL_K + 1),
                       RECALL_K)
    print(f"sharded_top_k over {MESH_RANKS} ranks, corpus {corpus.shape[0]} items, "
          f"{users.shape[0]} users, k={RECALL_K}: the same ids in the same order as "
          f"brute_force_top_k on one rank in {same} rows (every other row a tie within "
          f"{TOPK_TIE})")
    # ---- (b) cli.main on 2 processes
    with open(scoring["predictions"]) as f:
        want_rows = list(csv.reader(f))
    n_batches = 2 * -(-(FILE_EVAL_ROWS // MESH_RANKS + FILE_EVAL_ROWS % MESH_RANKS) // BST_BATCH)
    for mode in ("whole", "stream"):
        finals = [r[f"cli_{mode}"]["final"] for r in ranks]
        counts = [r[f"cli_{mode}"]["counts"] for r in ranks]
        with open(os.path.join(root, f"cli_{mode}", "predictions.csv")) as f:
            got_rows = list(csv.reader(f))
        if len(got_rows) != len(want_rows) or any(
                g[:2] + g[3:] != w[:2] + w[3:] for g, w in zip(got_rows, want_rows)):
            raise AssertionError(f"cli.main on 2 processes ({mode}): predictions.csv is not the "
                                 f"{FILE_EVAL_ROWS} eval rows once each in file order")
        prob_err = max(abs(float(g[2]) - float(w[2])) for g, w in zip(got_rows[1:], want_rows[1:]))
        diffs = {k: max(abs(fin[k] - one_final[k]) for fin in finals)
                 for k in ("read_comment_exact_auc", "read_comment_gauc")}
        print(f"cli.main on {MESH_RANKS} processes ({mode}) from phase 13's checkpoint at step "
              f"{FILE_BST_RESUME}: {len(got_rows) - 1} rows, ids and labels as the 1-process "
              f"predictions.csv, probabilities within {prob_err:.2e}; exact AUC "
              f"{finals[0]['read_comment_exact_auc']} GAUC {finals[0]['read_comment_gauc']}, "
              f"1 process {one_final['read_comment_exact_auc']} / "
              f"{one_final['read_comment_gauc']} (apart {diffs}); forward launches a rank "
              f"{[c['bst_attention_forward'] for c in counts]}")
        if any(d > MESH_AUC_TOL for d in diffs.values()):
            raise AssertionError(f"cli.main on 2 processes ({mode}): AUC/GAUC beyond "
                                 f"{MESH_AUC_TOL} of the 1-process run")
        if (any(c["bst_attention_forward_save"] or c["bst_attention_backward"] for c in counts)
                or (mode == "whole" and any(c["bst_attention_forward"] != n_batches
                                            for c in counts))
                or len({c["bst_attention_forward"] for c in counts}) != 1):
            raise AssertionError(f"cli.main ({mode}) launches {counts}: no train step, one "
                                 "forward per eval or predict batch, the same on each rank")
    print(f"phase 16 took {time.perf_counter() - t_phase:.1f} s (1-process references "
          f"{t_ref:.1f} s, ranks {t_ranks:.1f} s: {[round(r['seconds'], 1) for r in ranks]}); "
          f"held steps at {bst_ratio:.4f} (BST) and {mmoe_ratio:.4f} (MMOE) of the allowance")
    # each rank's launches on its paths: BST's steps and the two cli.main runs
    return {f"mesh rank {r['rank']}": {k: r["bst_counts"][k] + r["cli_whole"]["counts"][k]
                                       + r["cli_stream"]["counts"][k] for k in r["bst_counts"]}
            for r in ranks}


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bitwise equality of two f32 tensors (-0.0 and 0.0 differ, NaNs of one
    pattern agree)."""
    return a.shape == b.shape and torch.equal(a.contiguous().view(torch.int32),
                                              b.contiguous().view(torch.int32))


@contextlib.contextmanager
def low_precision_calls():
    """While open, counts the bf16 products (a Dense with a compute dtype, an
    expert contraction with one) that run on cuda tensors, the proof that
    --precision bf16 did not quietly run f32, and keeps the first of each
    kind: the Dense, its input and what it returned; the experts' inputs
    and output."""
    from recalgorithm_tpu_torch.ops import experts, mlp

    calls = {"dense": 0, "experts": 0}
    dense_forward, run_experts = mlp.Dense.forward, experts.run_experts

    def dense(self, x):
        y = dense_forward(self, x)
        if self.compute_dtype is torch.bfloat16 and x.is_cuda:
            calls["dense"] += 1
            calls.setdefault("first dense", (self, x.detach(), y.detach()))
        return y

    def expert(x, kernel, bias, compute_dtype=None):
        y = run_experts(x, kernel, bias, compute_dtype)
        if compute_dtype is torch.bfloat16 and x.is_cuda:
            calls["experts"] += 1
            calls.setdefault("first experts", (x.detach(), kernel.detach(), bias.detach(),
                                               y.detach()))
        return y

    mlp.Dense.forward, experts.run_experts = dense, expert
    try:
        yield calls
    finally:
        mlp.Dense.forward, experts.run_experts = dense_forward, run_experts


@contextlib.contextmanager
def compact_lookups():
    """While open, counts the lookups that took the PAD-compacted gather:
    its Python calls, an eager step's and a CUDA graph's capture (a replay
    calls none; ``card_kernels`` sees what a replay ran)."""
    from recalgorithm_tpu_torch.ops import compact_scatter as cs

    calls = [0]
    plain = cs.take_compact_bwd

    def counted(table, ids):
        calls[0] += 1
        return plain(table, ids)

    cs.take_compact_bwd = counted
    try:
        yield calls
    finally:
        cs.take_compact_bwd = plain


def bf16_products_vs_cpu(name: str, calls: dict) -> list[str]:
    """What the first bf16 products of a model's cuda forward returned
    (``low_precision_calls``) against the same modules on the CPU on the
    same inputs.  A Dense: within one bf16 ulp of each rounding (the product
    on both devices, and the bias add where the bias is not 0) plus the f32
    sums' error bound, K x 2^-23 x sum_k |x_k w_k| for K terms (a sum that
    cancels can differ by more than an ulp of its small result before
    rounding); an expert contraction (bf16 operands summed in f32) within
    BF16_EXPERTS.  Returns the failures."""
    import copy

    import torch.nn.functional as F

    bad = []
    if "first dense" in calls:
        module, x, got = calls["first dense"]
        got = got.cpu()
        cpu = copy.deepcopy(module).cpu()
        with torch.no_grad():
            want = cpu(x.cpu())
        xb, wb = x.cpu().to(torch.bfloat16).float(), cpu.weight.detach().to(torch.bfloat16).float()
        sum_err = x.shape[-1] * 2.0 ** -23 * F.linear(xb.abs(), wb.abs())
        bias = (cpu.bias.detach().to(torch.bfloat16).float().abs() if cpu.bias is not None
                else torch.zeros(got.shape[-1]))
        rounds = 1.0 + (bias != 0).float()  # the product's rounding, the bias add's
        diff = (got - want).abs()
        allowed = BF16_ULP * (rounds * torch.maximum(got.abs(), want.abs()) + bias) + sum_err
        share = float((got != want).float().mean())
        worst = float(torch.where(diff == 0, 0.0, diff / allowed).max())
        print(f"  {name} first bf16 Dense {tuple(got.shape)}, what it returned on cuda vs the "
              f"same Dense on the CPU: {share:.2e} of the elements differ, the worst at "
              f"{worst:.3f} of one bf16 ulp a rounding plus the f32 sums' error bound")
        if not worst <= 1.0:
            bad.append(f"{name} Dense product")
    if "first experts" in calls:
        from recalgorithm_tpu_torch.ops.experts import run_experts

        x, k, b, got = calls["first experts"]
        got = got.cpu()
        want = run_experts(x.cpu(), k.cpu(), b.cpu(), torch.bfloat16)
        err = float((got - want).abs().max())
        ok = torch.allclose(got, want, rtol=BF16_EXPERTS["rtol"],
                            atol=BF16_EXPERTS["atol_share"] * float(want.abs().max()))
        print(f"  {name} first bf16 expert contraction {tuple(got.shape)}, what it returned on "
              f"cuda vs the CPU: max abs err {err:.3e} (rtol {BF16_EXPERTS['rtol']}, atol "
              f"{BF16_EXPERTS['atol_share']} x max|h|)")
        if not ok:
            bad.append(f"{name} expert contraction")
    return bad


def trainer_grads(tr) -> dict[str, torch.Tensor]:
    """The gradients a train step left on ``tr``'s parameters (cuda)."""
    return {n: p.grad.detach().clone() for n, p in tr.model.named_parameters()}


def table_grad_ms(prof: dict) -> tuple[float, list]:
    """A profiled step's embedding-backward time (sort, segment sums,
    scatter) and the kernels counted."""
    items = [(n, ms) for n, ms in prof["by_name"].items()
             if any(k in n for k in TABLE_GRAD_KERNELS)]
    return sum(ms for _, ms in items), sorted(items, key=lambda kv: -kv[1])


def defaults_phase(work: str, gen, step_dir: str, bst_ref: dict, bst_zero: set[str],
                   bst_prof: dict, scoring: dict, card: str, kind: str) -> dict[str, dict]:
    """Phase 17: the JAX defaults the port lacked, at full width (real
    tables, B=4096).  Returns the hand kernels' launches on its main paths,
    by path."""
    from recalgorithm_tpu_torch.cli import sweep
    from recalgorithm_tpu_torch.cli.main import EVAL_BATCHES
    from recalgorithm_tpu_torch.data import pipeline, stats
    from recalgorithm_tpu_torch.features.schema import wechat_schema
    from recalgorithm_tpu_torch.features.vocab import VocabularyStore
    from recalgorithm_tpu_torch.models import get_model
    from recalgorithm_tpu_torch.ops import compact_scatter as cs

    t_phase = time.perf_counter()
    counts: dict[str, dict] = {}
    ref, hb = bst_ref, bst_ref["hb"]
    schema = ref["schema"]

    def bst_trainer(**config):
        return make_trainer("BST", schema, ref["weights"], ref["cfg"], "cuda", step_dir,
                            **config)

    # ---- (a) compaction on BST's held step (phase 8's weights and batch)
    if not cs.batch_fits_compact(hb, schema):
        raise AssertionError("phase 8's batch does not fit the compact buffer")
    steps = {}
    for label, compact in (("compact", True), ("full", False), ("full again", False)):
        tr = bst_trainer(compact_grad_scatter=compact)
        zero_counts()
        with compact_lookups() as calls:
            loss = float(tr.train_step(hb))
        torch.cuda.synchronize()
        counts[f"phase 17 BST step {label}"] = {k: kernel_counts()[k] for k in BST_KERNELS}
        if calls[0] != (1 if compact else 0):
            raise AssertionError(f"BST step ({label}): {calls[0]} compacted lookups")
        steps[label] = (loss, trainer_grads(tr))
        ratio = hold_step(f"BST ({label} table gradient, cuda)", ref, loss,
                          {n: g.double().cpu() for n, g in steps[label][1].items()}, bst_zero)
        print(f"  {label}: {calls[0]} compacted lookup(s), worst tensor at {ratio:.4f} of "
              f"phase 8's allowance; launches {counts[f'phase 17 BST step {label}']}")
    (loss_c, grads_c), (loss_f, grads_f) = steps["compact"], steps["full"]
    table = "embedder.embed.tables.feedid"

    def not_bitwise(a, b):
        """The tensors of gradients ``a`` and ``b`` that are not bitwise
        equal, the compacted table on its rows 1.. (row 0 is PAD's), each
        with its largest difference over its largest |g|."""
        out = {}
        for n in b:
            x, y = (a[n][1:], b[n][1:]) if n == table else (a[n], b[n])
            if not bits_equal(x, y):
                out[n] = float((x - y).abs().max() / y.abs().max().clamp(min=1e-30))
        return out

    differ = not_bitwise(grads_c, grads_f)
    noise = not_bitwise(steps["full again"][1], grads_f)  # the same path, run again
    row0 = bits_equal(grads_c[table][:1], grads_f[table][:1])
    print(f"compact vs full on cuda: loss {loss_c} vs {loss_f}; tensors not bitwise equal "
          f"(the feedid table on rows 1..): {differ}; feedid row 0 bitwise: {row0}; the full "
          f"step against itself run again: {noise}")
    # the compacted table bitwise; any other difference must be one the full
    # step shows against itself (the card's own run-to-run rounding)
    if table in differ or set(differ) - set(noise) or loss_c != loss_f:
        raise AssertionError(f"compacted step differs from the full one: {differ}")
    if len({str(counts[f"phase 17 BST step {k}"]) for k in steps}) != 1:
        raise AssertionError("the BST kernels launched otherwise on the two paths")
    # a dense batch (every history 50 long): over the cap, the full gradient
    dense = dict(hb)
    rng = np.random.default_rng(17)
    rows, t = hb[SEQ].shape
    dense[SEQ] = rng.integers(1, schema.vocab_sizes["feedid"] + 1, (rows, t)).astype(np.int32)
    dense[SEQ + "_len"] = np.full(rows, t, np.int32)
    if cs.batch_fits_compact(dense, schema):
        raise AssertionError("a full-length batch fits the compact buffer")
    dense_grads = {}
    for label, compact in (("default", True), ("full", False)):
        tr = bst_trainer(compact_grad_scatter=compact)
        with compact_lookups() as calls:
            tr.train_step(dense)
        if calls[0]:
            raise AssertionError(f"the dense batch took the compacted gather ({label})")
        dense_grads[label] = trainer_grads(tr)
    bad = {n: r for n, r in not_bitwise(dense_grads["default"], dense_grads["full"]).items()
           if n == table or n not in noise}
    print(f"dense batch (every history {t} long, {rows * t} live ids > cap "
          f"{max(256, rows * t // cs.CAP_DIVISOR)}): routed to the full gradient; tensors "
          f"not bitwise the full path's, beyond the run-to-run ones above: {bad}")
    if bad:
        raise AssertionError(f"the dense batch's default step differs from the full one: {bad}")
    # where the time goes, both ways (not gated)
    profs = {}
    for label, compact in (("compact", True), ("full", False)):
        profs[label] = train_step_profile("BST", step_dir, card, kind, "bst_attention",
                                          label=f" ({label} table gradient)",
                                          compact_grad_scatter=compact)
        ms, items = table_grad_ms(profs[label])
        print(f"  embedding backward ({label}): {ms} ms a step over {len(items)} kernels: "
              + "; ".join(f"{n[:60]} {v:.5f}" for n, v in items[:6]))
    # DIN through cli.main, with and without --no_compact_grad_scatter
    din_final = {}
    for label, extra in (("compact", ()), ("full", ("--no_compact_grad_scatter",))):
        with card_kernels() as ran:
            din_final[label] = train_cli("DIN", os.path.join(work, f"din_{label}"),
                                         DEFAULTS_STEPS, extra)
        c = hand_counts(ran)
        counts[f"phase 17 DIN cli {label}"] = c
        want = DEFAULTS_STEPS + 2 * EVAL_BATCHES
        if c["din_attention"] != want or any(c[k] for k in BST_KERNELS):
            raise AssertionError(f"DIN cli ({label}): launches {c}, want din_attention {want}")
        gathers = compacted_gathers(ran)
        print(f"DIN cli ({label}): the card ran {gathers} compacted gathers' backward "
              f"passes in {DEFAULTS_STEPS} steps (the trace's {COMPACT_SCATTER} kernels)")
        if gathers != (DEFAULTS_STEPS if label == "compact" else 0):
            raise AssertionError(f"DIN cli ({label}): {gathers} compacted gathers")
    print(f"DIN cli.main final evals equal with and without --no_compact_grad_scatter: "
          f"{din_final['compact'] == din_final['full']}")

    # ---- (b) precision="bf16"
    batch = gen.batch(BF16_EVAL_BATCH, 17)
    beyond = []
    matmul = torch.backends.cuda.matmul
    reduced = matmul.allow_bf16_reduced_precision_reduction
    for name in BF16_MODELS:
        cfg_cls, cls = get_model(name)
        m32 = cls(cfg_cls(), schema, torch.Generator().manual_seed(17))
        m16 = cls(cfg_cls(precision="bf16"), schema)
        m16.load_state_dict(m32.state_dict())
        c16 = cls(cfg_cls(precision="bf16"), schema)
        c16.load_state_dict(m32.state_dict())
        if matmul.allow_bf16_reduced_precision_reduction:
            raise AssertionError(f"{name}: building a bf16 model left cuBLAS's bf16 partial "
                                 "sums on")
        outs = {}
        for label, model, device in (("f32", m32, "cuda"), ("bf16", m16, "cuda"),
                                     ("cpu bf16", c16, "cpu")):
            model.to(device).eval()
            with torch.no_grad(), low_precision_calls() as calls:
                logits, _ = model({k: torch.from_numpy(v).to(device) for k, v in batch.items()})
            outs[label] = {t: v.float().cpu().numpy() for t, v in logits.items()}
            if label == "bf16":
                if not (calls["dense"] or calls["experts"]):
                    raise AssertionError(f"{name}: no bf16 product ran on cuda")
                beyond += bf16_products_vs_cpu(name, calls)
        bar = BF16_VS_CPU[name]
        for t, a in outs["f32"].items():
            b, c = outs["bf16"][t], outs["cpu bf16"][t]
            if b.dtype != np.float32 or not np.isfinite(b).all() or np.array_equal(a, b):
                raise AssertionError(f"{name} {t}: bf16 logits {b.dtype}, finite "
                                     f"{np.isfinite(b).all()}, equal to f32 {np.array_equal(a, b)}")
            scale = max(1.0, float(np.abs(c).max()))
            vs_f32 = float(np.abs(a - b).max()) / max(1.0, float(np.abs(a).max()))
            vs_cpu = float(np.abs(c - b).max()) / scale
            control = float(np.abs(c - a).max()) / scale  # the card's f32 vs the CPU's bf16
            print(f"{name} {t} bf16 eval B={BF16_EVAL_BATCH} on cuda: vs its f32 "
                  f"{vs_f32:.3e} of max(1, max|logit|) (bar {BF16_VS_F32}), vs the CPU bf16 "
                  f"forward {vs_cpu:.3e} (bar {bar}; the card's f32 logits vs the CPU bf16 "
                  f"forward {control:.3e}{'' if name in BF16_NO_GAP else ', must exceed it'})")
            if not (vs_f32 <= BF16_VS_F32 and vs_cpu <= bar
                    and (name in BF16_NO_GAP or control > bar)):
                beyond.append(f"{name} {t}")
        with low_precision_calls() as calls, card_kernels() as ran:
            final = train_cli(name, os.path.join(work, f"bf16_{name}"), DEFAULTS_STEPS,
                              ("--precision", "bf16"))
        c = hand_counts(ran)
        counts[f"phase 17 {name} bf16 cli"] = c
        layers = cfg_cls().num_transformer_block if name == "BST" else 0
        want = {"din_attention": DEFAULTS_STEPS + 2 * EVAL_BATCHES if name == "DIN" else 0,
                "bst_attention_forward": layers * 2 * EVAL_BATCHES,
                "bst_attention_forward_save": layers * DEFAULTS_STEPS,
                "bst_attention_backward": layers * DEFAULTS_STEPS}
        if (c != want or not math.isfinite(final.get("loss", math.nan))
                or not calls["dense"] + calls["experts"]):
            raise AssertionError(f"{name} --precision bf16: launches {c} (want {want}), final "
                                 f"{final}, bf16 products {calls}")
        print(f"{name} --precision bf16 through cli.main: loss {final['loss']}, launches {c}, "
              f"bf16 products on cuda: {calls['dense']} dense, {calls['experts']} experts")
    print(f"cuBLAS's bf16 partial sums (allow_bf16_reduced_precision_reduction): {reduced} "
          f"before the first bf16 model of the run, "
          f"{matmul.allow_bf16_reduced_precision_reduction} after")
    if beyond:
        raise AssertionError(f"bf16 logits beyond their bars, or an f32 control within one: "
                             f"{beyond}")
    bf16_prof = train_step_profile("BST", step_dir, card, kind, "bst_attention", label=" (bf16)",
                                   cfg=get_model("BST")[0](precision="bf16"))
    print(f"BST step f32 vs bf16: {profs['compact']['step_ms']} vs {bf16_prof['step_ms']} ms "
          f"(events), busy {profs['compact']['busy_ms']} vs {bf16_prof['busy_ms']} ms")

    # ---- (c) fuse_optimizer: accepted, and a no-op (every update is already
    # multi-tensor): one BST update with it against one without, bitwise, on
    # the same gradients (a step's own gradients vary in their last bits
    # from run to run: the manual_tag table's, above); the kernels a step
    for opt in ("adam", "adagrad"):
        cfg = dataclasses.replace(ref["cfg"], optimizer=opt)
        trs = {fuse: make_trainer("BST", schema, ref["weights"], cfg, "cuda", step_dir,
                                  fuse_optimizer=fuse) for fuse in (False, True)}
        trs[False].model.train()
        loss, _ = trs[False]._loss_and_logits(trs[False]._put_batch(hb))
        loss.backward()
        for p, q in zip(trs[False].model.parameters(), trs[True].model.parameters()):
            q.grad = p.grad.clone()
        params = {}
        for fuse, tr in trs.items():
            tr.optimizer.step()
            params[fuse] = {n: p.detach().clone() for n, p in tr.model.named_parameters()}
        bad = [n for n in params[False] if not bits_equal(params[False][n], params[True][n])]
        ops = profile_train_step(
            make_trainer("BST", schema, ref["weights"], cfg, "cuda", step_dir),
            [gen.batch(BST_BATCH, 10 + i) for i in range(4)], "bst_attention", 5)
        print(f"BST {opt} update with fuse_optimizer vs without: {len(params[False]) - len(bad)} "
              f"of {len(params[False])} parameters bitwise equal; kernels+copies a step "
              f"{ops['device_ops_per_step']:.0f}, busy {ops['busy_ms']:.5f} ms")
        if bad:
            raise AssertionError(f"the {opt} step with fuse_optimizer differs: {bad}")

    # ---- (d) the utilities
    out = os.path.join(work, "sweep.md")
    zero_counts()
    rows = sweep.main(["--model", "DeepFM", "--synthetic", "--device", "cuda",
                       "--grid", '{"hidden_units": ["64,32", "128,64"]}', "--out", out, "--",
                       "--train_steps", str(DEFAULTS_STEPS), "--batch_size", str(BST_BATCH),
                       "--synthetic_vocab_scale", "1.0", "--eval_throttle_secs", "0",
                       "--log_every", "2", "--save_checkpoints_steps", "0"])
    table_rows = [ln for ln in open(out) if ln.startswith("|")][2:]
    if len(rows) != 2 or len(table_rows) != 2 or any(kernel_counts().values()):
        raise AssertionError(f"sweep: {len(rows)} runs, {len(table_rows)} table rows, "
                             f"launches {kernel_counts()}")
    print(f"cli.sweep DeepFM hidden_units 64,32 | 128,64 on cuda: "
          + "; ".join(f"{r[0]['hidden_units']} auc {r[1]['read_comment_auc']:.5f}" for r in rows))
    vocabs = VocabularyStore.from_dir(scoring["vocabulary"])
    vschema = wechat_schema(vocabs.sizes())
    t0 = time.perf_counter()
    got = stats.compute_stats(pipeline.load_dataset(scoring["eval"], vschema, vocabs), vschema)
    print(f"data.stats on phase 13's eval split in {time.perf_counter() - t0:.2f} s: "
          f"num_examples {got['num_examples']}, label rates {got['label_positive_rate']}, "
          f"{SEQ} {got[SEQ + '_length']}")
    if got["num_examples"] != FILE_EVAL_ROWS:
        raise AssertionError(f"data.stats counted {got['num_examples']} of {FILE_EVAL_ROWS} rows")
    # the timer against CUDA events around the same step, read in turns
    # (phase 8's own measurement, minutes earlier, is printed beside)
    tr = make_trainer("BST", schema, ref["weights"], get_model("BST")[0](), "cuda", step_dir)
    events_us, t1, t2 = step_timer_rounds(tr, [gen.batch(BST_BATCH, 10 + i) for i in range(4)])
    print(f"  (phase 8's own CUDA-event step, earlier in the run: {bst_prof['step_ms'] * 1e3} us)")
    if not (abs(t1 / events_us - 1.0) <= TIMER_TOL and STACKED[0] <= t2 / t1 <= STACKED[1]):
        raise AssertionError("the step timer disagrees with CUDA events or does not scale")
    print(f"phase 17 took {time.perf_counter() - t_phase:.1f} s")
    return counts


def step_timer_rounds(tr, batches) -> tuple[float, float, float]:
    """utils.benchmarking's step timer on ``tr``'s train step against CUDA
    events around STEP_ITERS steps back to back, read in TIMER_ROUNDS
    interleaved rounds: the medians (us) of the events' step, the timer's
    step and the timer's slope of 2 stacked steps.  Prints every round."""
    from recalgorithm_tpu_torch.utils.benchmarking import loop_step_time_us

    for b in batches[:3]:
        tr.train_step(b)
    one = lambda st, b, rng: (st, tr.train_step(b))
    two = lambda st, b, rng: (st, [tr.train_step(b), tr.train_step(b)][1])
    rounds = []
    for _ in range(TIMER_ROUNDS):
        rounds.append((event_step_ms(tr, batches, STEP_ITERS) * 1e3,
                       *(loop_step_time_us(f, None, batches[0], k_small=TIMER_K[0],
                                           k_big=TIMER_K[1], repeats=1, device="cuda")
                         for f in (one, two))))
    events_us, t1, t2 = (float(np.median(x)) for x in zip(*rounds))
    print(f"loop_step_time_us on BST's step, {TIMER_ROUNDS} rounds (events, 1 step, 2 steps; "
          f"us): {[tuple(round(x, 1) for x in r) for r in rounds]}; medians: the timer {t1} us "
          f"a step against CUDA events {events_us} us: ratio {t1 / events_us:.4f} (limit 1 +- "
          f"{TIMER_TOL}); 2 stacked steps {t2} us, {t2 / t1:.4f}x one (limits {STACKED})",
          flush=True)
    return events_us, t1, t2


def metric_gaps(graph, eager) -> tuple[dict[str, float], bool, bool]:
    """Two trainers' streaming train metrics (``Trainer.metrics``): the
    largest relative gap of the means' snapshots (loss, logloss,
    calibration) and the largest gap of AUC and accuracy; whether every
    state counted the same rows (its ``count``; the AUC's confusion counts
    of each threshold summed); whether the snapshots are equal."""
    snap = {who: tr._metrics_snapshot(tr.metrics) for who, tr in (("graph", graph),
                                                                  ("eager", eager))}
    rank = [k for k in snap["eager"] if k.endswith(("_auc", "_accuracy"))]
    means = [k for k in snap["eager"] if k not in rank]
    gaps = {"metric_gap": max(abs(snap["graph"][k] - snap["eager"][k]) / abs(snap["eager"][k])
                              for k in means),
            "rank_metric_gap": max(abs(snap["graph"][k] - snap["eager"][k]) for k in rank)}

    def rows(tr):
        out = [tr.metrics.loss_mean.count]
        for tm in tr.metrics.task_metrics.values():
            out += [tm.acc.count, tm.logloss.count, tm.auc.tp + tm.auc.fp + tm.auc.tn + tm.auc.fn]
        return out

    same_rows = all(torch.equal(a, b) for a, b in zip(rows(graph), rows(eager)))
    return gaps, same_rows, snap["graph"] == snap["eager"]


def graph_gaps(label: str, losses: list, eager_losses: list, graph, eager, init: dict,
               metrics: bool = True) -> bool:
    """Phase 18's gate: a trainer's steps replayed as a CUDA graph against
    the same steps of its twin run eagerly from the same weights and seed:
    the largest relative gap of a loss; with ``metrics``, the two streaming
    train metrics (``metric_gaps``); and, as the benchmark's ``correct``
    compares a program with its reference, the gaps of each parameter's
    change norm over max(its eager norm, the median's), on the parameters
    whose eager gradient is at least 1e-3 of the median one's (median and
    worst).  Prints whether the two are bitwise equal, or the gaps and the
    largest element gap, beside GRAPH_LIMITS; raises beyond them or where
    the metrics counted other rows.  Returns bitwise."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, eager_losses))
    grads = {n: float(p.grad.double().norm()) for n, p in eager.model.named_parameters()
             if p.grad is not None}
    floor = 1e-3 * float(np.median(list(grads.values())))
    leaves = [n for n, g in grads.items() if g >= floor]
    change = {who: {n: float((p.detach() - init[n]).double().norm())
                    for n, p in tr.model.named_parameters()}
              for who, tr in (("graph", graph), ("eager", eager))}
    median = float(np.median([change["eager"][n] for n in leaves]))
    gaps = {n: abs(change["graph"][n] - change["eager"][n]) / max(change["eager"][n], median)
            for n in leaves}
    element = max(float((p.detach() - q.detach()).abs().max())
                  for p, q in zip(graph.model.parameters(), eager.model.parameters()))
    got = {"loss_gap": loss_gap}
    same_rows = same = True
    if metrics:
        mgaps, same_rows, same = metric_gaps(graph, eager)
        got.update(mgaps)
    got.update(change_gap=float(np.median(list(gaps.values()))),
               change_gap_worst=max(gaps.values()))
    bitwise = losses == eager_losses and element == 0.0 and same
    print(f"{label}: graph vs eager over {len(losses)} steps: "
          + ("bitwise equal" if bitwise else
             f"{got} (worst leaf {max(gaps, key=gaps.get)}); largest element gap "
             f"{element:.3e}; limits {GRAPH_LIMITS}"), flush=True)
    if not same_rows:
        raise AssertionError(f"{label}: the graph path's metrics counted other rows than the "
                             "eager step's")
    beyond = {k: v for k, v in got.items() if not v <= GRAPH_LIMITS[k]}
    if beyond:
        raise AssertionError(f"{label}: the graph path beyond its limits: {beyond}")
    return bitwise


def graph_case(label: str, make, batches: list, between=None) -> bool:
    """``len(batches)`` train steps of ``make()``'s trainer, replayed from
    the second, against its eager twin (``make()`` with its graphs off);
    ``between(trainer, i)`` runs on both after step i.  ``graph_gaps``."""
    graph, eager = make(), make()
    eager._step_graphs = None
    init = {n: p.detach().clone() for n, p in graph.model.named_parameters()}
    losses = {}
    for who, tr in (("graph", graph), ("eager", eager)):
        losses[who] = []
        for i, b in enumerate(batches):
            losses[who].append(float(tr.train_step(b)))
            if between is not None:
                between(tr, i)
    if graph.replays != len(batches) - 1 or eager.replays:
        raise AssertionError(f"{label}: {graph.replays} and {eager.replays} replays")
    return graph_gaps(label, losses["graph"], losses["eager"], graph, eager, init)


def graph_phase(work: str, gen, step_dir: str, din_dir: str) -> None:
    """Phase 18: the train step as one CUDA graph at full width (B=4096,
    real tables, dropout on), each case against the eager step: BST on
    the compacted and on the full table gradient (two keys), DIN, a cosine
    schedule, an evaluate between steps, a checkpoint restore mid-run; a
    fresh trainer's third step a replay."""
    from recalgorithm_tpu_torch import convert
    from recalgorithm_tpu_torch.features.schema import wechat_schema
    from recalgorithm_tpu_torch.models.bst import BSTConfig
    from recalgorithm_tpu_torch.models.din import DINConfig
    from recalgorithm_tpu_torch.ops import compact_scatter as cs
    from recalgorithm_tpu_torch.train import optimizers
    from recalgorithm_tpu_torch.train.loop import _Checkpointer

    schema = wechat_schema(gen.vocab_sizes())
    bst_w, din_w = convert.load_export(step_dir), convert.load_export(din_dir)

    def bst(**kw):
        return make_trainer("BST", schema, bst_w, BSTConfig(), "cuda", work, **kw)

    batches = [gen.batch(BST_BATCH, 300 + i) for i in range(GRAPH_STEPS)]
    dense = []
    for i, hb in enumerate(batches):
        hb = dict(hb)
        rows, t = hb[SEQ].shape
        hb[SEQ] = np.random.default_rng(i).integers(
            1, schema.vocab_sizes["feedid"] + 1, (rows, t)).astype(np.int32)
        hb[SEQ + "_len"] = np.full(rows, t, np.int32)
        dense.append(hb)
    if not (all(cs.batch_fits_compact(b, schema) for b in batches)
            and not any(cs.batch_fits_compact(b, schema) for b in dense)):
        raise AssertionError("phase 18's batches do not take the two keys")
    held = [gen.batch(BST_BATCH, 399)]
    cosine = optimizers.build("adam", optimizers.make_schedule(0.005, "cosine", 2, 4))
    bitwise = {
        "BST, compacted key": graph_case("BST, compacted key", bst, batches),
        "BST, full key": graph_case("BST, full key", bst, dense),
        "DIN": graph_case("DIN", lambda: make_trainer("DIN", schema, din_w, DINConfig(), "cuda",
                                                      work), batches),
        "BST, cosine schedule": graph_case("BST, cosine schedule",
                                           lambda: bst(optimizer=cosine), batches),
        "BST, an evaluate between steps": graph_case(
            "BST, an evaluate between steps", bst, batches,
            lambda tr, i: tr.evaluate(held) if i == GRAPH_STEPS // 2 - 1 else None),
    }
    # a checkpoint restore mid-run: the same trainer back to step 4 captures
    # again and resumes the loss sequence of its first run
    tr, half = bst(), GRAPH_STEPS // 2
    ck = _Checkpointer(os.path.join(work, "graph_ckpt"))
    first = [float(tr.train_step(b)) for b in batches[:half]]
    ck.save(tr)
    first += [float(tr.train_step(b)) for b in batches[half:]]
    ck.restore_latest(tr)
    again = [float(tr.train_step(b)) for b in batches[half:]]
    gap = max(abs(a - b) / abs(b) for a, b in zip(again, first[half:]))
    print(f"BST, a checkpoint restore at step {half}: the resumed losses {again} against the "
          f"first run's {first[half:]}: " + ("bitwise equal" if again == first[half:] else
                                              f"largest relative gap {gap:.3e}"))
    if not gap <= GRAPH_LIMITS["loss_gap"] or tr.step != GRAPH_STEPS:
        raise AssertionError(f"the restored run does not resume its losses ({gap}, {tr.step})")
    fresh = bst()
    for i, b in enumerate(batches[:3]):
        fresh.train_step(b)
        if fresh.replays != i:
            raise AssertionError(f"step {i + 1} of a fresh trainer: {fresh.replays} replays")
    print(f"a fresh trainer's steps 2 and 3 replayed its graph; bitwise against eager: "
          f"{bitwise}")
    graph_zoo(work)


def graph_zoo(work: str) -> None:
    """Every registered model (config defaults, tables at GRAPH_ZOO_VOCAB of
    their size, B=GRAPH_ZOO_BATCH) 4 train steps on cuda with its optimizer
    as cli.main builds it: a model whose optimizer can be captured replays
    steps 2-4 (a capture that fails raises), the others step eagerly."""
    from recalgorithm_tpu_torch.data.synthetic import SyntheticConfig, SyntheticWeChat
    from recalgorithm_tpu_torch.features.schema import wechat_schema
    from recalgorithm_tpu_torch.models import MODEL_REGISTRY, get_model
    from recalgorithm_tpu_torch.train import optimizers
    from recalgorithm_tpu_torch.train.loop import Trainer, TrainerConfig

    gen = SyntheticWeChat(wechat_schema(), SyntheticConfig(seed=7, vocab_scale=GRAPH_ZOO_VOCAB))
    schema = wechat_schema(gen.vocab_sizes())
    batches = [gen.batch(GRAPH_ZOO_BATCH, 500 + i) for i in range(4)]
    eager = []
    for name in sorted(MODEL_REGISTRY):
        cfg_cls, model_cls = get_model(name)
        cfg = cfg_cls()
        model = model_cls(cfg, schema, torch.Generator().manual_seed(0))
        if hasattr(model_cls, "wide_param_predicate"):  # as cli.main
            opt = optimizers.dual_wide_deep(
                cfg.wide_part_learning_rate, cfg.deep_part_optimizer, cfg.deep_part_learning_rate,
                model_cls.wide_param_predicate, [n for n, _ in model.named_parameters()])
        else:
            opt = optimizers.build(cfg.optimizer, cfg.learning_rate)
        tr = Trainer(model, tuple(cfg.task_names) or (schema.labels[0],), opt,
                     TrainerConfig(model_dir=os.path.join(work, "graph_zoo", name)), device="cuda")
        losses = [float(tr.train_step(b)) for b in batches]
        want = 3 if tr._step_graphs is not None else 0
        if tr.replays != want or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"{name}: {tr.replays} replays (want {want}), losses {losses}")
        if not want:
            eager.append(f"{name} ({type(getattr(tr.optimizer, 'opt', tr.optimizer)).__name__})")
    print(f"{len(MODEL_REGISTRY) - len(eager)} of {len(MODEL_REGISTRY)} models replayed steps "
          f"2-4 of 4 (B={GRAPH_ZOO_BATCH}, tables at {GRAPH_ZOO_VOCAB} of their size); eager, "
          f"their optimizer not capturable: {eager}", flush=True)


def row_ids(vocab: int, n: int, gen: torch.Generator) -> torch.Tensor:
    """``n`` ids ``floor(vocab u^2) + 1`` on the card (the cell's traffic)."""
    u = torch.rand(n, device="cuda", generator=gen, dtype=torch.float64)
    return (torch.floor(vocab * u * u) + 1).long()


def kernel_device_ms(fn, name: str, iters: int = 20) -> tuple[float, float]:
    """Device ms a call of ``fn`` spends in kernels whose name holds
    ``name``, and in all its kernels and copies (a profiler trace)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = device_events(prof)
    took = [(e.name, e.time_range.elapsed_us()) for e in events]
    return (sum(us for n, us in took if name in n) / 1e3 / iters,
            sum(us for _, us in took) / 1e3 / iters)


def events_ms(fn, iters: int = 5) -> float:
    """ms a call from CUDA events around ``iters`` calls (for calls that
    wait on the device themselves, which ``cuda_ms`` refuses)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def row_adagrad_phase(card: str) -> dict:
    """Phase 19 (constants ROW_*): the kernel against its twin and its byte
    bound at the cell's shapes, the dense chain's time on the same table
    beside it; DLRM-DCNv2's row-path step against the dense one; the row
    path's backward and update under ``set_sync_debug_mode("error")``."""
    import copy
    import warnings

    from recalgorithm_tpu_torch.embed import tables
    from recalgorithm_tpu_torch.features.schema import CRITEO_HOT_SIZES, criteo_schema
    from recalgorithm_tpu_torch.models.dlrm import DLRM, DLRMConfig
    from recalgorithm_tpu_torch.ops.cuda import row_adagrad as ra
    from recalgorithm_tpu_torch.train import optimizers
    from recalgorithm_tpu_torch.train.loop import Trainer, TrainerConfig

    def gap(a, b):
        a, b = a.double(), b.double()
        return float((a - b).norm() / b.norm().clamp(min=1e-300))

    gen = torch.Generator(device="cuda").manual_seed(19)
    entries = []
    for vocab, hot, b in ROW_CASES:
        rows = tables.TableSpec("t", vocab, ROW_DIM).num_rows
        ids = row_ids(vocab, hot * b, gen)
        values = torch.randn(len(ids), ROW_DIM, device="cuda", generator=gen)
        p = torch.randn(rows, ROW_DIM, device="cuda", generator=gen) * 0.1
        acc = torch.zeros_like(p)  # the cell's accumulator start
        distinct = int(torch.unique(ids).numel())
        got_p, got_acc = p.clone(), acc.clone()
        launches = ra.row_adagrad.launches
        ra.row_adagrad(got_p, got_acc, ids, values, 0.004, 1e-8)
        ra.row_adagrad_reference(p, acc, ids, values, 0.004, 1e-8)
        torch.cuda.synchronize()
        if ra.row_adagrad.launches != launches + 1:
            raise AssertionError("row_adagrad did not launch its kernel")
        untouched = torch.ones(rows, dtype=torch.bool, device="cuda")
        untouched[ids] = False
        gaps = {"param": gap(got_p, p), "acc": gap(got_acc, acc)}
        still = bits_equal(got_p[untouched], p[untouched])
        if max(gaps.values()) > ROW_GAP or not still:
            raise AssertionError(f"row_adagrad at {vocab} rows, {len(ids)} ids: gaps {gaps} "
                                 f"(limit {ROW_GAP}); untouched rows bitwise: {still}")
        needed = 12 * len(ids) + 4 * ROW_DIM * len(ids) + 16 * ROW_DIM * distinct
        bound_ms = needed / PEAK_BYTES * 1e3
        call = lambda: ra.row_adagrad(got_p, got_acc, ids, values, 0.004, 1e-8)
        kernel_ms, call_ms = kernel_device_ms(call, "row_adagrad_kernel")
        twin_ms = events_ms(lambda: ra.row_adagrad_reference(p, acc, ids, values, 0.004, 1e-8))
        # the dense chain this replaces: a dense gradient's Adagrad step over the table
        dense_p = torch.nn.Parameter(p.clone())
        opt = optimizers.Adagrad([dense_p], lr=0.004, initial_accumulator_value=0.0, eps=1e-8)
        dense_p.grad = torch.zeros_like(p).index_add_(0, ids, values)
        dense_ms = events_ms(opt.step)
        del opt, dense_p
        entry = {"rows": rows, "ids": len(ids), "distinct": distinct, "gaps": gaps,
                 "kernel_ms": kernel_ms, "call_ms": call_ms, "bound_ms": bound_ms,
                 "roofline_pct": 100 * bound_ms / kernel_ms, "twin_ms": twin_ms,
                 "dense_chain_ms": dense_ms}
        print(f"  {rows} rows x {ROW_DIM}, {len(ids)} ids ({distinct} distinct): kernel "
              f"{kernel_ms:.5f} ms against a {bound_ms:.5f} ms byte bound "
              f"({entry['roofline_pct']:.1f}%); the call (sort, scratch, kernel) {call_ms:.5f} "
              f"ms; twin {twin_ms:.4f} ms; the dense chain over the table {dense_ms:.4f} ms; "
              f"gaps {gaps}")
        entries.append(entry)
        del p, acc, got_p, got_acc, values, ids
        torch.cuda.empty_cache()

    # DLRM-DCNv2 at the cell's widths, tables capped at ROW_STEP_ROWS rows
    vocabs = {f"cat_{i}": min(n, ROW_STEP_ROWS)
              for i, n in enumerate(criteo_schema().vocab_sizes.values())}
    schema = criteo_schema(vocabs)
    cfg = DLRMConfig(interaction="dcn", embedding_dim=ROW_DIM, bottom_hidden_units=(512, 256, 128),
                     hidden_units=(1024, 1024, 512, 256), batch_norm=False, dropout_rate=0.0,
                     num_cross_layers=3, cross_low_rank=512, optimizer="adagrad",
                     learning_rate=0.004, adagrad_initial_accumulator_value=0.0,
                     adagrad_eps=1e-8, task_names=("click",), batch_size=ROW_STEP_BATCH)
    torch.manual_seed(19)
    model = DLRM(cfg, schema)
    rng = np.random.default_rng(19)
    batches = []
    for _ in range(ROW_STEPS + 2):
        hb = {"dense": np.log1p(rng.poisson(3.0, (ROW_STEP_BATCH, 13))).astype(np.float32),
              "labels": (rng.random((ROW_STEP_BATCH, 1)) < 0.034).astype(np.float32)}
        for i, hot in enumerate(CRITEO_HOT_SIZES):
            n = vocabs[f"cat_{i}"]
            ids = (np.floor(n * rng.random((ROW_STEP_BATCH, hot)) ** 2) + 1).astype(np.int32)
            hb[f"cat_{i}"] = ids[:, 0] if hot == 1 else ids
            if hot > 1:
                hb[f"cat_{i}_len"] = np.full(ROW_STEP_BATCH, hot, np.int32)
        batches.append(hb)
    runs, trainers = {}, {}
    for rows in (True, False):
        tr = trainers[rows] = Trainer(
            copy.deepcopy(model), ("click",),
            optimizers.build("adagrad", 0.004, **cfg.optimizer_options()),
            TrainerConfig(model_dir=tempfile.mkdtemp(), save_checkpoints_steps=0,
                          handle_sigterm=False), device="cuda")
        if tr.row_grads is not True:
            raise AssertionError("DLRM-DCNv2's Adagrad trainer does not take row gradients")
        tr.row_grads = rows
        launches = ra.row_adagrad.launches
        losses = [float(tr.train_step(hb)) for hb in batches[:ROW_STEPS]]
        runs[rows] = (losses, ra.row_adagrad.launches - launches)
    if runs[True][1] != 26 * ROW_STEPS or runs[False][1] != 0:
        raise AssertionError(f"row kernel launches {runs[True][1]} (row path), "
                             f"{runs[False][1]} (dense): want {26 * ROW_STEPS} and 0")
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(runs[True][0], runs[False][0]))
    init = dict(model.named_parameters())
    changes = []
    for (name, p), q in zip(trainers[True].model.named_parameters(),
                            trainers[False].model.parameters()):
        want = q.detach() - init[name].detach().cuda()
        changes.append(gap(p.detach() - init[name].detach().cuda(), want))
    acc_gaps = [gap(trainers[True].optimizer.opt.state[p]["sum_of_squares"],
                    trainers[False].optimizer.opt.state[q]["sum_of_squares"])
                for p, q in zip(trainers[True].model.parameters(),
                                trainers[False].model.parameters())]
    numbers = {"loss_gap": loss_gap, "change_gap": float(np.median(changes)),
               "change_gap_worst": max(changes), "acc_gap_worst": max(acc_gaps)}
    print(f"  DLRM-DCNv2 at the cell's widths, tables <= {ROW_STEP_ROWS} rows, B="
          f"{ROW_STEP_BATCH}: {ROW_STEPS} steps on the row path against the dense chain: "
          f"{json.dumps(numbers)}; losses {runs[True][0]} vs {runs[False][0]}")
    limits = {k: GRAPH_LIMITS[k] for k in ("change_gap", "change_gap_worst")}
    limits |= {"loss_gap": 1e-3, "acc_gap_worst": GRAPH_LIMITS["change_gap"]}
    beyond = {k: (v, limits[k]) for k, v in numbers.items() if not v <= limits[k]}
    if beyond:
        raise AssertionError(f"the row path's DLRM-DCNv2 steps beyond their limits: {beyond}")

    # host-device synchronizations of the backward and the update, each path,
    # two steps each under the "warn" mode (torch's message, and where in
    # Python it came from), then a row-path step under the "error" mode
    def backward_and_update(tr, rows, hb, mode):
        batch = tr._put_batch(hb)
        tr.optimizer.zero_grad()
        with tables.row_sparse_grads(rows):
            loss, _ = tr._loss_and_logits(batch)
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode(mode)
            try:
                loss.backward()
                tr.optimizer.step()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        return [f"{os.path.basename(w.filename)}:{w.lineno}" for w in caught
                if "called a synchronizing CUDA operation" in str(w.message)]

    syncs = {rows: [backward_and_update(tr, rows, hb, "warn") for hb in batches[-2:]]
             for rows, tr in trainers.items()}
    backward_and_update(trainers[True], True, batches[0], "error")
    print(f"  synchronizing calls in two steps' backward and update (where): row path "
          f"{syncs[True]}, dense path {syncs[False]}; a row-path step then ran under "
          "set_sync_debug_mode('error')")
    if syncs[True][-1]:
        raise AssertionError(f"the row path's backward and update synchronized: {syncs[True]}")
    profs = {}
    for rows, tr in trainers.items():
        tr.row_grads = rows
        prof = profile_train_step(tr, batches, None, iters=4)
        profs[rows] = prof
        print(f"  DLRM-DCNv2 step (tables <= {ROW_STEP_ROWS} rows, B={ROW_STEP_BATCH}), "
              f"{'row path' if rows else 'dense chain'}: "
              + json.dumps({k: v for k, v in prof.items() if k != "by_name"}))
    del trainers, model
    torch.cuda.empty_cache()
    print(card)
    return {"kernel": entries, "dlrm_step": numbers,
            "syncs": {"row path": syncs[True], "dense chain": syncs[False]},
            "step_busy_ms": {"row path": profs[True]["busy_ms"],
                             "dense chain": profs[False]["busy_ms"]}}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def random_attention_case(b: int, seed: int, serving_mix: bool = False):
    """DIN attention inputs at T=50, H=16: uniform lengths in [0, 50] with 0
    and 50 forced in, or with ``serving_mix`` the serving path's history
    lengths (min(geometric(0.15), 50), data/synthetic.py) with 0, 1, 49 and
    50 forced in."""
    from recalgorithm_tpu_torch.ops.attention import DINAttention

    rng = np.random.default_rng(seed)
    t, h = 50, 16
    q = rng.normal(size=(b, h)).astype(np.float32)
    k = rng.normal(size=(b, t, h)).astype(np.float32)
    if serving_mix:
        lengths = np.minimum(rng.geometric(0.15, b), t).astype(np.int32)
        lengths[:4] = (0, 1, t - 1, t)
    else:
        lengths = rng.integers(0, t + 1, b).astype(np.int32)
        lengths[:2] = (0, t)
    att = DINAttention(h, generator=torch.Generator().manual_seed(seed))
    weights = [p.detach().cuda() for p in (
        att.f1_att.weight, att.f1_att.bias, att.f2_att.weight,
        att.f2_att.bias, att.f3_att.weight, att.f3_att.bias)]
    dev = [torch.from_numpy(x).cuda() for x in (q, k, lengths)]
    return dev, weights, lengths


def check_close(name: str, got: np.ndarray, want: np.ndarray) -> float:
    if got.shape != want.shape or not np.isfinite(got).all():
        raise AssertionError(f"{name}: shape {got.shape} vs {want.shape}, "
                             f"finite={np.isfinite(got).all()}")
    err = float(np.max(np.abs(got - want))) if got.size else 0.0
    if not np.allclose(got, want, **TOL):
        raise AssertionError(f"{name}: max abs err {err:.3e} beyond {TOL}")
    return err


def payload_of(hb, i, schema) -> dict:
    return {
        "dense": hb["dense"][i].tolist(),
        **{f.name: int(hb[f.name][i]) for f in schema.categorical},
        **{f.name: hb[f.name][i][: int(hb[f.name + "_len"][i])].tolist()
           for f in schema.sequence},
    }


def post(url: str, payload: dict, route: str = "/predict") -> tuple[float, float]:
    req = urllib.request.Request(url + route, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=120) as r:
        body = json.loads(r.read())
        if r.status != 200:
            raise AssertionError(f"POST {route} -> {r.status}: {body}")
    return body["predictions"]["read_comment"], time.perf_counter() - t0


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: no GPU to run on",
              file=sys.stderr)
        return 1
    if len(sys.argv) > 1 and sys.argv[1] == "--mesh-rank":  # one rank of phase 16
        rank, world, store, root = sys.argv[2:6]
        mesh_rank(int(rank), int(world), store, root)
        return 0

    from recalgorithm_tpu_torch import convert
    from recalgorithm_tpu_torch.cli.serve import build_server
    from recalgorithm_tpu_torch.data.synthetic import SyntheticConfig, SyntheticWeChat
    from recalgorithm_tpu_torch.features.schema import wechat_schema
    from recalgorithm_tpu_torch.models.din import DIN, DINConfig
    from recalgorithm_tpu_torch.ops.cuda import _build
    from recalgorithm_tpu_torch.ops.cuda.din_attention import (
        din_attention,
        din_attention_reference,
    )
    from recalgorithm_tpu_torch.serving.predictor import Predictor

    phase("1. card")
    card = card_line()
    print(card)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; device 0: {kind}; "
          f"count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
          "torch.backends.cudnn.allow_tf32 = False")

    phase("2. build kernels (nvcc, sm_90a) and the native TFRecord reader and writer (g++)")
    from concurrent.futures import ThreadPoolExecutor

    from recalgorithm_tpu_torch.runtime import loader

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        host_libs = [pool.submit(loader.build, n) for n in ("tfrecord_reader", "tfrecord_writer")]
        libs = _build.build()
        host_libs = [f.result() for f in host_libs]
    print(f"built {sorted(libs)} and {[p.name for p in host_libs]} in "
          f"{time.perf_counter() - t0:.2f} s")
    for name, log in _build.build_logs.items():
        for line in log.splitlines():
            if "entry function" in line:  # names the kernel of the lines below it
                print(f"  {name}: {line.strip()[:120]}")
            elif any(w in line for w in ("registers", "spill", "smem", "error")):
                print(f"  {name}: {line.strip()}")

    phase(f"3. kernel vs plain twin on the card (tolerance {TOL})")
    print("  DIN attention, T=50: B, lengths (uniform in [0, 50], or the serving "
          "mix), softmax, max abs err, kernel ms, twin ms, bound ms (bound by)")
    for b, mix in DIN_CASES:
        for sm in (False, True):
            dev, weights, lengths = random_attention_case(b, seed=b, serving_mix=mix)
            got = din_attention(*dev, *weights, use_softmax=sm)
            want = din_attention_reference(*dev, *weights, use_softmax=sm)
            torch.cuda.synchronize()
            label = f"din_attention B={b} {'serving mix' if mix else 'uniform'} softmax={sm}"
            err = check_close(label, got.cpu().numpy(), want.cpu().numpy())
            k_ms = cuda_ms(lambda: din_attention(*dev, *weights, use_softmax=sm), iters=200)
            # 20 calls of the twin's ~20 launches stay inside the launch queue,
            # which would otherwise block the host behind the GPU sleep
            p_ms = cuda_ms(lambda: din_attention_reference(*dev, *weights, use_softmax=sm),
                           iters=20)
            bound, by = din_attention_bound_ms(lengths, 50, sm)
            print(f"  {label}: err {err:.3e}  kernel {k_ms:.5f} ms  twin {p_ms:.5f} ms  "
                  f"bound {bound:.5f} ms ({by})", flush=True)
    print("  BST attention: forward, P (f32, bf16) and dq/dk/dv vs the twin; "
          f"gradients {GRAD_TOL} x max|g|, bf16 P {BF16_TOL}")
    bst_cases = (*((*s, "uniform") for s in BST_SHAPES), (*BST_SERVED_MIX, "main_mix"),
                 (*BST_MAIN_MIX, "main_mix"), (*AUTOINT_SHAPE, "full"))
    labels = {"uniform": "uniform lengths", "main_mix": "the train path's length mix",
              "full": "every length T (AutoInt)"}
    for b, h, t, mix in bst_cases:
        r = bst_kernels_vs_twins(*bst_case(b, h, t, seed=b + t, main_mix=mix == "main_mix",
                                           full=mix == "full"), timed=True)
        print(f"  B={b} H={h} T={t}, {labels[mix]}: max abs err {json.dumps(r['err'])}",
              flush=True)
        unmasked = r.get("library_ms_unmasked", {})
        for kname, ms in r["ms"].items():
            base = kname.replace("_bf16", "")
            bound, by = r["bound"][kname]
            print(f"    {kname:<18} kernel {ms:.5f} ms  twin "
                  f"{r['plain_ms'].get(base, float('nan')):.5f} ms  sdpa "
                  f"{r['library_ms'].get(base, float('nan')):.5f} ms  sdpa unmasked "
                  f"{unmasked.get(base, float('nan')):.5f} ms  bound "
                  f"{bound:.5f} ms ({by})", flush=True)

    phase("4. main path 1: full-width DIN served over HTTP on cuda")
    schema = wechat_schema()
    model = DIN(DINConfig(), schema, torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():  # non-trivial BatchNorm statistics
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(0.1 * torch.randn(buf.shape, generator=g))
            elif name.endswith("running_var"):
                buf.copy_(torch.rand(buf.shape, generator=g) * 1.5 + 0.5)
    model_dir = tempfile.mkdtemp(prefix="chip_smoke_")
    atexit.register(shutil.rmtree, model_dir, ignore_errors=True)
    export_dir = convert.save_export(model_dir, 1, 0.5, model)
    print(f"exported full-width DIN to {export_dir}: feedid table "
          f"{tuple(model.embedder.embed.tables['feedid'].shape)}, fcn "
          f"{model.fcn.dense_0.in_features}->{DINConfig().hidden_units}->1")
    args = argparse.Namespace(
        model="DIN", model_dir=model_dir, export_dir=None, vocabulary_dir=None,
        synthetic_vocab_scale=1.0, host="127.0.0.1", port=0,
        max_batch_size=256, max_delay_ms=2.0, device="cuda")

    zero_counts()
    t0 = time.perf_counter()
    httpd, batchers = build_server(args)
    print(f"build_server (load export + warm every bucket "
          f"{batchers['DIN'].buckets}): {time.perf_counter() - t0:.2f} s")
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    gen = SyntheticWeChat(schema, SyntheticConfig(seed=0, vocab_scale=1.0))
    hb = gen.batch(64, 1)
    hb[SEQ][0], hb[SEQ + "_len"][0] = 0, 0  # empty history
    hb[SEQ][1] = np.arange(1, 51, dtype=np.int32) * 997
    hb[SEQ + "_len"][1] = 50                # full 50-long history
    results: dict[int, tuple[float, float]] = {}
    errors: list[Exception] = []

    def client(rows):
        try:
            for i in rows:
                results[i] = post(url, payload_of(hb, i, schema))
        except Exception as exc:  # reported below, fails the run
            errors.append(exc)

    try:
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            if r.read() != b"ok":
                raise AssertionError("GET /healthz did not answer ok")
        threads = [threading.Thread(target=client, args=(range(j, 64, 4),))
                   for j in range(4)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        wall = time.perf_counter() - t0
        with urllib.request.urlopen(url + "/metrics", timeout=60) as r:
            metrics = json.loads(r.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        gpu_pred = batchers["DIN"].predictor
        for bt in batchers.values():
            bt.close()
    serve_launches = din_attention.launches
    if errors or len(results) != 64:
        raise AssertionError(f"{len(results)}/64 responses; errors: {errors[:3]}")
    cpu_pred = Predictor(DIN(DINConfig(), schema), export_dir, device="cpu")
    want = cpu_pred.predict_batch(hb)["read_comment"]
    got = np.array([results[i][0] for i in range(64)], np.float32)
    err = check_close("HTTP responses vs CPU twin", got, want)
    lat = np.sort([results[i][1] * 1e3 for i in range(64)])
    print(f"64 requests from 4 threads in {wall:.3f} s; responses vs CPU: "
          f"max abs err {err:.3e}")
    print(f"request latency ms: p50 {np.percentile(lat, 50):.3f} "
          f"p99 {np.percentile(lat, 99):.3f}")
    print(f"server stats: {json.dumps(metrics)}")
    print(f"din_attention launches on the serving path: {serve_launches}")
    if serve_launches <= 0:
        raise AssertionError("the serving path never launched the din_attention kernel")

    phase("5. offline Predictor on cuda, B=4096, and where a batch's time goes")
    big = gen.batch(4096, 2)
    captured = {}

    def capture(module, inputs, output):
        captured["inputs"] = [x.clone() for x in inputs]

    din_attention.launches = 0
    hook = gpu_pred.model.attention.register_forward_hook(capture)
    probs = gpu_pred.predict(iter([big]))["read_comment"]  # keeps the kernel's inputs
    hook.remove()
    offline_launches = din_attention.launches
    if offline_launches <= 0:
        raise AssertionError("offline predict never launched the din_attention kernel")
    err_off = check_close("offline B=4096 vs CPU", probs,
                          cpu_pred.predict_batch(big)["read_comment"])
    print(f"Predictor.predict B=4096: vs CPU max abs err {err_off:.3e}; "
          f"kernel launches {offline_launches}")
    print(f"Predictor.predict_batch on {kind} ({card}): wall = median host time of "
          f"{PROFILE_ITERS} calls; busy = device time of its kernels and copies "
          "(torch.profiler)")
    for b in PROFILE_BATCHES:
        r = profile_batch(gpu_pred, big if b == len(big["dense"]) else gen.batch(b, 3))
        print(f"  B={b}: wall {r['wall_ms']} ms ({b / r['wall_ms'] * 1e3:.0f} ex/s), "
              f"device busy {r['busy_ms']} ms, idle share {r['idle_share']:.4f}, "
              f"{r['device_ops_per_batch']:.0f} kernels+copies per batch, "
              f"din_attention {r['din_attention_ms']} ms")
        for kname, ms in r["top"]:
            print(f"    {ms:9.5f} ms  {kname[:100]}")
    sm_pred = Predictor(DIN(DINConfig(use_softmax=True), schema), export_dir,
                        device="cuda")
    din_attention.launches = 0
    sm_probs = sm_pred.predict_batch(big)["read_comment"]
    sm_launches = din_attention.launches
    sm_cpu = Predictor(DIN(DINConfig(use_softmax=True), schema), export_dir, device="cpu")
    err_sm = check_close("offline softmax B=4096 vs CPU", sm_probs,
                         sm_cpu.predict_batch(big)["read_comment"])
    if sm_launches <= 0:
        raise AssertionError("use_softmax=True never launched the kernel")
    print(f"use_softmax=True B=4096: vs CPU max abs err {err_sm:.3e}; "
          f"kernel launches {sm_launches}")

    # the kernel at the main path's own inputs (offline B=4096 batch)
    q, keys, lengths = captured["inputs"]
    att = gpu_pred.model.attention
    weights = [p.detach() for p in (att.f1_att.weight, att.f1_att.bias,
                                    att.f2_att.weight, att.f2_att.bias,
                                    att.f3_att.weight, att.f3_att.bias)]
    with torch.inference_mode():
        got = din_attention(q, keys, lengths, *weights)
        want = din_attention_reference(q, keys, lengths, *weights)
        torch.cuda.synchronize()
        max_err = check_close("din_attention at main-path inputs",
                              got.cpu().numpy(), want.cpu().numpy())
        k_ms = cuda_ms(lambda: din_attention(q, keys, lengths, *weights), iters=200)
        p_ms = cuda_ms(lambda: din_attention_reference(q, keys, lengths, *weights))
    lens = lengths.cpu().numpy()
    bound, by = din_attention_bound_ms(lens, keys.shape[1], False)
    print(f"din_attention at the offline batch's inputs (B={len(lens)}, "
          f"mean len {lens.mean():.2f}): kernel {k_ms:.5f} ms, twin {p_ms:.5f} ms, "
          f"bound {bound:.5f} ms ({by}), max abs err {max_err:.3e}")

    din_entry = {
        "name": "din_attention", "route": "cuda",
        "source": "recalgorithm_tpu_torch/csrc/din_attention.cu",
        "replaces": "recalgorithm_tpu/ops/pallas/din_attention.py:35",
        "launches": serve_launches, "max_abs_err": max_err,
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound, "bound_by": by,
        "library_ms": None,
    }

    phase("6. full-width DIN trains on cuda through cli.main")
    work = tempfile.mkdtemp(prefix="chip_smoke_train_")
    atexit.register(shutil.rmtree, work, ignore_errors=True)
    with card_kernels() as ran:
        din_final = train_cli("DIN", os.path.join(work, "din"), DIN_TRAIN_STEPS)
    din_train_launches = hand_counts(ran)["din_attention"]
    print(f"din_attention launches in DIN training (the card's trace): {din_train_launches}")
    if din_train_launches <= 0 or not math.isfinite(din_final["loss"]):
        raise AssertionError("DIN training never launched din_attention or lost finiteness")

    phase(f"7. main path 2: full-width BST trains through cli.main on cuda, "
          f"B={BST_BATCH}, {BST_STEPS} steps (eval every {BST_EVAL_EVERY}), "
          f"then resumes to {BST_RESUME_STEPS}")
    bst_counts_run, best_dir = train_and_resume("BST", os.path.join(work, "bst"), 1)

    phase("8. one BST train step on cuda vs the CPU; kernels at its inputs; "
          "where a train step's time goes")
    import recalgorithm_tpu_torch.ops.attention as attention
    from recalgorithm_tpu_torch.models.bst import BSTConfig
    from recalgorithm_tpu_torch.ops.cuda import bst_attention

    step_dir = repeatable_weights("BST", os.path.join(work, "bst_step"))
    bst_zero = zero_gradient_params(BSTConfig())
    reports = {}
    reports["BST"], bst_ref, bst_prof = step_phase("BST", step_dir, attention, bst_zero, card,
                                                   kind)

    phase("9. golden recipe (tests/golden_common.py) for BST and DIN on cuda")
    golden_phase(("BST", "DIN"), work)

    phase("10. the BST export served over HTTP on cuda")
    serve_export("BST", best_dir, gen)

    phase(f"11. main path 3: full-width AutoInt trains through cli.main on cuda, "
          f"B={BST_BATCH}, {BST_STEPS} steps (eval every {BST_EVAL_EVERY}), then resumes "
          f"to {BST_RESUME_STEPS}; a train step vs the CPU; the BST kernels at its "
          "inputs; its export served; its golden recipe")
    autoint_counts, autoint_dir = train_and_resume(
        "AutoInt", os.path.join(work, "autoint"), AUTOINT_LAYERS)
    # AutoInt has no BatchNorm: no gradient of its step is zero
    reports["AutoInt"] = step_phase("AutoInt", autoint_dir, bst_attention, set(), card, kind)[0]
    serve_export("AutoInt", autoint_dir, gen)
    golden_phase(("AutoInt",), work)

    phase(f"12. {', '.join(ZOO_MODELS)} at full width on cuda: {ZOO_TRAIN_STEPS} steps "
          "through cli.main, the best export against the CPU; a DeepFM train step vs "
          f"the CPU; {' and '.join(ZOO_PROFILED)} train steps profiled; the golden recipes")
    zoo_dirs = {name: run[1] for name, run in zoo_phase(work, gen).items()}
    # no tower BN: a bias in front of a train-mode BN has a rounding-noise
    # gradient (PNN's case in tests/test_torch_train.py); nothing else is 0
    step_vs_cpu("DeepFM", zoo_dirs["DeepFM"], set(), batch_norm=False)
    step_vs_cpu("WideAndDeep", zoo_dirs["WideAndDeep"], set(), batch_norm=False)
    for name in ZOO_PROFILED:
        train_step_profile(name, zoo_dirs[name], card, kind, kernel=None)
    golden_phase(ZOO_MODELS, work)

    phase("13. main path 4: training from TFRecord files on cuda: the native writer and "
          "readers, BST from the files, DIN streaming them, DeepFM accumulating gradients, "
          "GenericDNN and DeepFM on a Douban split; where the time goes")
    file_counts, scoring = files_phase(work)

    phase("14. serving artifacts on cuda: DIN and BST exported (f32, int8) and served by "
          "HLOPredictor, W&D's artifact sizes, two artifacts over HTTP, cli/score.py on "
          "phase 13's eval split; the artifact's batch time against the live Predictor")
    artifact_counts = artifacts_phase(work, gen, export_dir, best_dir, zoo_dirs["WideAndDeep"],
                                      scoring, card)

    phase("15. main path 6: the multi-task family, DIEN and TwoTower at full width on cuda: "
          f"{', '.join(NEW_MODELS)} through cli.main ({ZOO_TRAIN_STEPS} steps, TwoTower with "
          f"--eval_recall_at {RECALL_K}); PLE and DIEN train steps vs the f64 CPU step, "
          "DIEN's replayed LazyAdam step's untouched rows, both steps profiled; retrieval; "
          "MMOE and TwoTower artifacts; the golden recipes")
    zero_counts()
    multitask_phase(work, gen, card, kind)
    if any(kernel_counts().values()):
        raise AssertionError(f"phase 15 launched hand kernels: {kernel_counts()}")

    phase(f"16. several processes: {MESH_RANKS} ranks sharing the one card over gloo (NCCL "
          "refuses two ranks on one device): BST's step on row-sharded tables held to the "
          f"1-process step, {MESH_STEPS} steps, exact launches, time a rank; cli.main from "
          "phase 13's checkpoint, whole-load and --stream; MMOE's experts split over a "
          "(1, 2) mesh; sharded_top_k")
    mesh_counts = mesh_phase(work, bst_ref, step_dir, bst_zero, scoring, card)

    phase("17. main path 8: the JAX defaults the port lacked: the PAD-compacted table "
          "gradient on BST's held step (against the full one and the f64 CPU step, a dense "
          "batch routed to the full one, both profiled) and DIN through cli.main with and "
          "without --no_compact_grad_scatter; --precision bf16 (BST, DIN, MMOE, PLE, DeepFM) "
          "against f32 and the CPU, through cli.main, BST's bf16 step profiled; "
          "fuse_optimizer a no-op; cli.sweep, data.stats and the step timer")
    default_counts = defaults_phase(work, gen, step_dir, bst_ref, bst_zero, bst_prof, scoring,
                                    card, kind)

    phase(f"18. the train step as one CUDA graph: BST (compacted and full key), DIN, a cosine "
          f"schedule, an evaluate between steps and a checkpoint restore, {GRAPH_STEPS} steps "
          "each against the eager step; a fresh trainer's third step a replay")
    graph_phase(work, SyntheticWeChat(wechat_schema(), SyntheticConfig(seed=7, vocab_scale=1.0)),
                step_dir, export_dir)

    phase("19. the row-wise Adagrad kernel at DLRM-DCNv2's shapes against its twin and its "
          "byte bound; DLRM-DCNv2 steps on the row path against the dense chain; no host "
          "synchronization in the row path's backward and update")
    row_report = row_adagrad_phase(card)

    din_by_path = {"serving": serve_launches,
                   "DIN stream": file_counts["DIN stream"]["din_attention"],
                   **{path: c["din_attention"] for path, c in artifact_counts.items()},
                   **{path: c["din_attention"] for path, c in default_counts.items()
                      if "DIN" in path}}
    din_entry.update(launches=sum(din_by_path.values()), launches_by_path=din_by_path)
    report = {"kernels": [din_entry, *bst_entries(
        reports, {"BST": bst_counts_run, "AutoInt": autoint_counts,
                  "BST from files": file_counts["BST from files"], **artifact_counts,
                  **mesh_counts, **{path: c for path, c in default_counts.items()
                                    if "BST" in path}})], "row_adagrad": row_report}
    print(f"\nchip_smoke.py took {time.perf_counter() - t_start:.1f} s, the kernels' build "
          "included")
    print(card)
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
