#!/usr/bin/env python3
"""Card-side smoke run of the PyTorch port (``pylidar_slam_tpu_torch``).

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device: require CUDA; print the card's name and power limit;
2. build: the CUDA kernels (one nvcc per source, started together) and the
   native host encoder, from the sources;
3. B1 vs plain: kernel B1 (``assoc_gn``) against its plain PyTorch version
   at the aggregated path's shapes (64x1024, window 1x2), on a model image
   from frame 0 and a target from frame 1 of the acceptance sequence, for
   all 8 robust schemes with the plane gate off and on;
4. aggregated main path: ``ICPFrameToModel`` with the aggregated champion
   over the 140-frame acceptance sequence (64x1024, rimg8, batch 12, EI
   bootstrap), counting B1's launches and scoring tr_err / ATE against
   ground truth and the round's bar;
5. surfel main path: the surfel champion (K = 30 x S = 4096 map surfels,
   M = 16384 targets, exact NN by kernel B2 at every one of 20 GN
   iterations, knn map normals, f32 uploads, the previous pose as prior)
   over the same 140 frames, counting B2's launches and the ones that did
   work, scoring tr_err / ATE;
6. B2 vs plain: kernel B2 (``nn_argmin``) against its plain version on the
   surfel map left by phase 5 and the next frame's 16384 grid-sampled
   targets at its prior, plus a map with duplicate rows, an all-invalid map,
   odd sizes and the cases planted at the kernel's seams
   (``ops/kernels/seams.py``: exact ties across sub-tile, tile and split
   boundaries, empty sub-tiles, M and V off the kernel's multiples);
7. highway: the ``aggregated_highway`` profile (merged-model normal
   refits with the centered fit, batch 12, rimg8) over the 60-frame
   2 m/frame sequence at 64x1024, counting B1's launches (12 x 59) and
   holding tr_err to the JAX package's 0.95%;
8. ct_icp: the ``ct_icp`` profile (elastic warp, mid-sweep poses, plane
   gate, beta priors; f32 uploads) over the 100-frame rolling-shutter
   sequence at 64x1024, then the same run with the warp off: B1's launches
   (12 x 99), ATE < 0.12 m on the reported mid-sweep poses, and the elastic
   tr_err on the scan-start surface (the ground truth's) below the rigid
   one;
9. profiles: the other four CT-ICP profiles (``ct_icp_robust_shaky`` on
   B1's generic window) and the aggregated champion with point-to-point GN,
   procrustes and deskew, 20 frames each of that sequence: finite poses
   and B1's launch count (0 for the point-to-point modes);
   every path of phases 7-9 then runs one more step under
   ``torch.cuda.set_sync_debug_mode("error")`` (no host sync in the step),
   and the highway and ct_icp paths three steps under ``torch.profiler``
   (kernels and device ms per step) and under a wall clock (the device's
   idle share of a step);
9b. datasets: on-disk sequences fabricated under ``build/chip_datasets/``
   by ``scripts/fabricate_datasets.py`` (cached by settings): the acceptance
   sequence's 140 frames raycast at 64 x 2,048 rays with 0.05 degree beam
   jitter as KITTI sequence ``00`` (float32 ``.bin`` scans, ``calib.txt``,
   camera-frame poses), and the 100 rolling-shutter frames, with the same
   jitter, as CT-ICP PLY frames with a per-point ``timestamp`` and
   ``trajectory.txt``; the KITTI
   reader's own rate (``seq[i]`` on this host); then three runs through
   the port's CLI in this process (``pylidar_slam_tpu_torch.run.main``, no
   device override, so on the card): ``dataset=kitti
   slam/odometry/local_map=aggregated`` twice (B1's launches counted and
   equal between the two), ``dataset=kitti`` with ``config/slam.yaml``'s
   defaults (the surfel map with hash NN: no kernel launch), and
   ``dataset=ct_icp slam/odometry=ct_icp`` (the elastic aggregated map,
   B1): tr_err at most the JAX package's on the same files on the CPU + 0.1
   pt (``scripts/jax_cpu_dataset_bars.py``), ATE < 0.05 m (KITTI) and <
   0.12 m (CT-ICP), every KITTI scan read by the native one-pass reader;
   one step of each configuration under sync-debug "error" and three under
   the profiler and a wall clock;
9c. parallel: the surfel champion over the 140 frames with
   ``shard_points=2``, 2 ranks spawned on cuda:0 in a gloo group (NCCL
   refuses two ranks on one card): the round's bar, both ranks' poses bit
   for bit, 2,780 B2 launches per rank, the all-reduces (host round trips)
   per frame, the gap to phase 5's unsharded trajectory; in the same ranks
   one PoseResNet-18 train step at 64x1024 and batch 8 with dp=2 and with
   tp=2 against the one-process step on the same batch and weights (loss and
   every weight's update); then ``-m ... parallel_jobs=2`` (aggregated map,
   40 frames, two speeds) through ``pylidar_slam_tpu_torch.run.main``
   against the same jobs one after the other: equal poses, B1's launches;
   and B2 at a rank's shard (M/2 targets) against its plain version, timed;
9d. viz: the ``cli`` recipe with ``save_map=true`` in this process (the PLY,
   the HTML file and their point count; the PNG views only with
   matplotlib), ``pylidar_slam_tpu_torch.replay`` over the whole window
   (poses bit for bit the run's) and over 40 frames, ``aggregate_map_cloud``
   over the KITTI sequence's ~17 M points on the card against numpy,
   exactly, and ``viz_debug`` over 3 frames;
10. slam: the port's ``SLAM`` (aggregated odometry with 6 GN trips, f32
   uploads, the elevation-image loop closure at its published widths --
   512 px images, 4096-point refine clouds, 10 candidates, Fourier-Mellin
   matching -- with candidates within 20 m, and the pose-graph backend)
   over 40 frames at 64x1024, at
   batch 1 and batch 4: at least one loop constraint with the backend
   optimizing before the last frame, the same loop pairs at both batch
   sizes, each constraint within 0.15 m and 0.25 deg of the ground truth,
   ATE < 0.05 m, B2 launched on the refine (total and active trips; the
   counts are set to 0 after ``init()``, whose loop-closure warm-up runs
   the match on zeros), scans/s, the warm-up's seconds and the loop
   closure's seconds on the pipeline thread (in all and the longest
   frame); one ``_match_candidates`` dispatch under
   ``torch.cuda.set_sync_debug_mode("error")`` and under ``torch.profiler``;
   the same runs without loop closure, for scans/s; B2 against its plain
   version on a refine's 4096 x 4096 inputs, masks on both sides;
11. cli: ``python -m pylidar_slam_tpu_torch.run dataset=synthetic
   dataset.num_frames=130 dataset.speed=1.3`` with the shared config's
   defaults (surfel map with hash NN, CV initialization) and no device
   override, so on the card: metrics.yaml with tr_err < 1% and ATE < 0.05 m;
12. projective: the same recipe with ``slam/odometry/local_map=projective``
   (the projective ring-buffer map at its published width, K = 20, 10 ICP
   trips): ATE < 0.05 m and tr_err at most the JAX package's CPU figure
   + 0.1 pt (``scripts/jax_cpu_map_bars.py``), the reference's projective
   tr_err printed beside it; then, in this process, one step of the map
   under ``torch.cuda.set_sync_debug_mode("error")`` and three under
   ``torch.profiler`` and a wall clock;
13. voxel: ``profile_configs()["voxel"]`` (the voxel-table map, batch 12,
   rimg8) over the 140-frame acceptance sequence: ATE < 0.05 m and tr_err
   at most the JAX package's CPU figure + 0.1 pt, scans/s; one step under
   sync-debug "error" and under the profiler; neither kernel is on the
   projective or the voxel path, and both phases check that neither ran;
13b. codecs: the acceptance sequence on de-calibrated beams (0.1 degree
   jitter, 140 frames at 64x1024): each upload codec's frame decoded on the
   card and on the CPU (rimg, rimg16, rimg8, rimg12, packed, int16: the same
   validity, points within 2e-5 m); the aggregated champion (batch 12,
   66,560 points) under rimg, rimg16, rimg12, packed, and int16 steps of
   4 mm without and with dither: B1's 1,112 launches, ATE < 0.05 m, tr_err at
   most the JAX package's on the same run on the CPU + 0.1 pt
   (``scripts/jax_cpu_codec_bars.py``), scans/s, one batched step under
   sync-debug "error"; the surfel champion under rimg: B2's 2,780 launches
   and the same kind of bar; the port's bench on this loader (not
   grid-regular: its default upload is rimg) at the ``bench`` phase's size,
   its line naming rimg and B1's launches counted;
14. posenet: the deep-learning track at 64x1024 on 40 synthetic frames
   loaded once: ``python -m pylidar_slam_tpu_torch.train dataset=synthetic
   dataset.num_frames=40 num_epochs=8 batch_size=8`` (supervised
   PoseResNet-18 from the port's own initialisation, no device override),
   then the deep odometry from its checkpoint over the 40 frames, whose
   trajectory ATE must beat the identity trajectory's by 3x (the JAX
   package's CPU figure, ``scripts/jax_cpu_posenet_bar.py``, printed
   beside it); the same recipe twice more in this process, on the frames
   loaded once, to say whether two runs give bit-identical weights; 20
   unsupervised steps at batch 4 with every loss finite; through the CLI
   (``TRAIN_DIR`` set to that checkpoint) ``slam/odometry=deep_odometry``,
   whose metrics.yaml ATE must beat the identity's by 3x, and
   ``slam/initialization=PoseNet`` with the default surfel odometry, ATE
   < 0.05 m, the CV-initialized run's ATE beside it; one train step (batch
   4 and 8) and one deep-odometry frame under
   ``torch.cuda.set_sync_debug_mode("error")``, then three of each under
   ``torch.profiler`` and a wall clock, beside the step's bound (its
   convolutions' FLOPs at 67 TFLOP/s); no B1 or B2 launch;
14b. bench: the port's measurement entry points through their module
   functions, once each at a reduced size: ``bench`` (the aggregated
   champion, 61 frames of the sequence, one timed repeat), ``bench_surfel``
   with ``SF_NN=exact`` (100 frames, one timed pass) and ``bench_pipeline``
   (96 frames at 0.5 m/frame, one run); each JSON line printed on a line of
   its own with the JAX script's keys and finite positive rates, B1's
   launches in ``bench`` and B2's in ``bench_surfel`` equal to the count the
   frames processed give;
14c. graft: the driver's entry points (``graft_entry``): ``entry()``'s
   aggregated step on the card (32x256, 8,192 points, 6 GN trips) over
   three steps -- the example arguments (an empty map), a keyframe step
   past the insert threshold and a matching step at a small twist -- with
   B1 and with B1's plain version (poses within 1e-5), B1's 18 launches, one
   step under sync-debug "error" and three under the profiler and a wall
   clock; then ``dryrun_multichip(4)`` (4 gloo ranks on cuda:0: dp=4, and
   dp=2 x tp=2) with its pose chain moved off its edges (the dry run's own
   fits them exactly): every rank's train steps, sharded GN step,
   edge-sharded pose graph and ``shard_points=4`` odometry equal, the pose
   graph within 1e-8 of the whole edge set optimized in one process on the
   card (float64) and moved, the odometry within 5e-4 of a one-rank run of
   its configuration, B2's launches per rank, and B2 against its plain
   version on every rank's recorded inputs (its block of 128 targets
   against the map: a split count of its own);
15. times: each kernel's device time per call (N calls captured in a CUDA
   graph, replayed under CUDA events), its wall time per call (back-to-back
   calls under CUDA events, which for B1 is the host's enqueue), its plain
   version's, B2's library yardstick (``torch.cdist`` + min) and each
   kernel's bound from this run's inputs, B2 at the surfel path's and at the
   loop-closure refine's shapes; the kernels each call launches as
   ``torch.profiler`` counts them; each champion's steady-state scans/s
   over the sequence (one warm run).

Every ``torch.profiler`` window (kernels and device ms per step) opens
with PROFILE_FILLER spin kernels, left out of its counts, which take the
profiler's loss of a window's first kernel records; it fails unless it saw
some of the filler and at least one kernel for each launch of B1 and B2
that the wrappers counted in it.

Phases 4 and 5 also hold each champion's trajectory against
``tests/fixtures/torch_e2e.npz``, recorded on the card by ``python -m
pylidar_slam_tpu_torch.eval.record_e2e``: the same code stamp
(``eval/acceptance.code_stamp``) and ground truth, tr_err within 5e-5 of the
recorded value, the largest translation gap printed.

``--only NAME`` builds and runs one phase alone (a probe, no result line):
``posenet``, ``datasets``, ``parallel``, ``viz``, ``codecs``, ``slam`` (with B2
against its plain version on the refine's inputs), ``bench``, which runs
the three benches at their own defaults (``bench`` also with the kdtree and
voxel maps), or ``graft``, which runs the dry run at 8 ranks (the driver's
MULTICHIP size).

With ``--compare DIR`` (repeatable; DIR holds another checkout of the
package, e.g. an earlier commit unpacked by ``git archive``), a last phase
times B1 and B2 of that checkout against this one's on phase 7's inputs by
device time, in the order other / this / this / other, each in a process of
its own (``utils/device_timing.py``, which loads that checkout's own
wrappers and kernel sources), after checking that both give the same
results.

The last line of stdout is the JSON result; the line before it holds the
card's name and power limit, and the one before that the kernels' numbers.
Details go to build/chip_smoke.json (git-ignored).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import math
import os
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from pylidar_slam_tpu_torch import bench, bench_pipeline, bench_surfel, graft_entry
from pylidar_slam_tpu_torch.config import compose, load_yaml_file
from pylidar_slam_tpu_torch.dataset import DATASET
from pylidar_slam_tpu_torch.dataset.synthetic import (SyntheticConfig,
                                                      SyntheticDatasetLoader)
from pylidar_slam_tpu_torch.eval import acceptance
from pylidar_slam_tpu_torch.eval import eval_odometry as ev
from pylidar_slam_tpu_torch.eval.record_e2e import card_line
from pylidar_slam_tpu_torch.ops import projection, se3
from pylidar_slam_tpu_torch.ops.kernels import assoc_gn as b1
from pylidar_slam_tpu_torch.ops.kernels import nn_argmin as b2
from pylidar_slam_tpu_torch.ops.kernels import seams
from pylidar_slam_tpu_torch.ops.kernels.cuda_build import CSRC
from pylidar_slam_tpu_torch.ops.pose_graph import PoseGraph, optimize_pose_graph
from pylidar_slam_tpu_torch.slam.odometry import aggregated_map as am
from pylidar_slam_tpu_torch.slam.odometry import surfel_map as sm
from pylidar_slam_tpu_torch.slam.odometry.icp_odometry import (ICPFrameToModel,
                                                               ICPFrameToModelConfig)
from pylidar_slam_tpu_torch.slam.slam import SLAM
from pylidar_slam_tpu_torch.utils import device_timing, native, timer
from pylidar_slam_tpu_torch.utils.device_timing import graph_ms, time_calls

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "scripts"))
import fabricate_datasets as fab  # noqa: E402
SCHEMES = ["least_square", "default", "huber", "exp", "neighborhood",
           "geman_mcclure", "square_geman_mcclure", "cauchy"]
PLANE_GATES = [0.0, 0.1]
# float32 sums of 65536 terms in two different tree orders: each output is
# held to SUM_TOL times its Cauchy-Schwarz scale (assoc_gn.sum_errors); the
# match count exactly.
SUM_TOL = 2e-5
# B2 and its plain version form the same float32 sums in the same order:
# indices identical, squared distances bit-identical (0 ulp).
NN_ULPS = 0
TIMED_CALLS = 200
B2_TIMED_CALLS = {"kernel": 100, "plain": 10}
# calls captured in one CUDA graph for a kernel's device time
GRAPH_CALLS = {"assoc_gn": 200, "nn_argmin": 100}
REPEAT_CALLS = 200  # B1 calls that must give bit-identical sums
# The H100 SXM's published peaks (NVIDIA data sheet, dense, 700 W).
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# float32 operations per (query, model point) pair of B2: 3 subtractions,
# 3 products, 2 adds.
NN_PAIR_FLOPS = 8
# Warm runs of each champion over the sequence in the times phase (one: the
# bench phase times the aggregated champion through the port's bench, and
# `--only bench` repeats it 5 times).
SEQ_REPEATS = 1
# The round's accuracy bar: the reference kd-tree run's tr_err + 0.1 pt.
BAR_PT = 0.001
# The JAX package's pins for the profiles: tests/test_high_speed.py:231 and
# tests/test_slam_e2e.py:331.
HIGHWAY_TR_ERR = 0.0095
CT_ICP_ATE_M = 0.12
PROFILE_FRAMES = 20
REPLACES = {"assoc_gn": "pylidar_slam_tpu/ops/pallas/assoc_gn_kernel.py:169",
            "nn_argmin": "pylidar_slam_tpu/ops/pallas/nn_kernel.py:76"}
# The slam phase: the configuration of tests/test_slam_e2e.py:367-390 (40
# frames at 64x1024, aggregated odometry with 6 GN trips) with the loop
# closure at its published widths and the pose-graph backend.  Candidates
# are the stored submaps within 20 m: the run's revisits are 13-20 m apart,
# and farther candidates (24-36 m) give spurious phase-correlation peaks of
# up to 0.12 against the 0.10 acceptance score.  Which of them passes is
# decided in the reference itself by the last bits of the odometry: a 1e-7
# change of the input clouds changes the JAX package's own loop set, while
# on identical submap inputs the port's scores and decisions are the JAX
# package's (ROADMAP.md §C1, tests/test_torch_loop_closure.py).  One did
# pass on the card with no distance limit, 36 m off.
SLAM_FRAMES = 40
SLAM_OVERRIDES = ["dataset=synthetic", f"dataset.num_frames={SLAM_FRAMES}",
                  "dataset.turn_rate=0.01", "slam/odometry/local_map=aggregated",
                  "slam.odometry.max_num_alignments=6",
                  "slam.odometry.num_points_padded=65536"]
LOOP_OVERRIDES = ["slam/loop_closure=elevation_image", "slam.loop_closure.local_map_size=4",
                  "slam.loop_closure.overlap=1", "slam.loop_closure.min_id_distance=9",
                  "slam.loop_closure.max_distance=20", "slam/backend=graph_slam"]
# About twice the JAX package's worst loop constraint on this run on the
# CPU (0.080 m, 0.123 deg).
LOOP_TRANS_M, LOOP_ROT_DEG = 0.15, 0.25
# scans/s of the slam phase's runs with loop closure when init() did not
# warm the match path (its first submap event paid the first cuFFT plans
# and solver handles; NVIDIA H100 80GB HBM3, 700.00 W, PERF.md §6; batch 1
# includes set-up), printed beside this call's
EARLIER_SCANS_PER_S = {1: 7.18, 4: 10.42}
SLAM_ATE_M = 0.05
# The verify recipe's run through the CLI; tr_err is a ratio (1%).
CLI_OVERRIDES = ["dataset=synthetic", "dataset.num_frames=130", "dataset.speed=1.3"]
CLI_TR_ERR, CLI_ATE_M = 0.01, 0.05
# The projective and voxel maps' bars: the JAX package's tr_err on the same
# run on the CPU (scripts/jax_cpu_map_bars.py) + 0.1 pt, and ATE < 0.05 m.
PROJECTIVE_OVERRIDES = CLI_OVERRIDES + ["slam/odometry/local_map=projective"]
MAP_ATE_M = 0.05
# The codecs phase: the acceptance sequence on de-calibrated beams (the
# sensors the per-pixel codecs are for), the aggregated champion under each
# upload codec and the surfel champion under rimg, with the same kind of bars.
CODEC_KW = dict(acceptance.SEQ_KW, beam_jitter_deg=0.1)
CODEC_RUNS = {"rimg": {"upload_format": "rimg"}, "rimg16": {"upload_format": "rimg16"},
              "rimg12": {"upload_format": "rimg12"}, "packed": {"upload_format": "packed"},
              "int16": {"upload_format": "f32", "upload_quantization": 0.004},
              "int16_dither": {"upload_format": "f32", "upload_quantization": 0.004,
                               "upload_dither": True}}
# The JAX package's tr_err on each run on the CPU: scripts/jax_cpu_map_bars.py
# (projective, voxel) and scripts/jax_cpu_codec_bars.py (the codecs phase).
JAX_CPU_TR_ERR = {"projective": 0.0010508689764278157, "voxel": 0.00048665772964472185,
                  "aggregated_rimg": 0.0006670670714887546,
                  "aggregated_rimg16": 0.0004520110694715823,
                  "aggregated_rimg12": 0.004980074871092508,
                  "aggregated_packed": 0.0018014607368871012,
                  "aggregated_int16": 0.0017627484052750116,
                  "aggregated_int16_dither": 0.0010772341778251177,
                  "surfel_rimg": 0.00026654895188508353}
DECODE_TOL = 2e-5  # m: a decoded point on the card against the CPU's
# The deep track: the JAX package's learning pin (tests/test_training.py:43-89,
# supervised, 8 epochs at batch 8 over 40 frames; deep odometry must beat the
# identity trajectory's ATE by 3x) at 64x1024 with 131,072 padded points.
# scripts/jax_cpu_posenet_bar.py gave these on the CPU at that size (7.03x).
POSENET_FRAMES = 40
POSENET_TRAIN = ["dataset=synthetic", f"dataset.num_frames={POSENET_FRAMES}", "num_epochs=8",
                 "batch_size=8"]
POSENET_RATIO = 3.0
JAX_CPU_POSENET = {"ate_m": 3.0491583206568817, "identity_ate_m": 21.433189234495064,
                   "relative_ate_m": 0.11415313096692876,
                   "identity_relative_ate_m": 1.0725000000000002}
UNSUPERVISED_STEPS = 20
# The datasets phase: (the root's environment variable, the sequence writer,
# the CLI's overrides, the ATE bar) per run.  kitti runs twice, to hold B1's
# launch count between two runs.  The bars: the JAX package's tr_err over
# the same files on the CPU (scripts/jax_cpu_dataset_bars.py) + 0.1 pt; ATE
# 0.05 m on KITTI (as the champions) and the JAX pin's 0.12 m on CT-ICP.
DATASETS_DIR = ROOT / "build" / "chip_datasets"
KITTI_ARGV = ["dataset=kitti", 'dataset.train_sequences=["00"]']
DATASET_RUNS = {
    "kitti": ("KITTI_ODOM_ROOT", fab.kitti_sequence,
              KITTI_ARGV + ["slam/odometry/local_map=aggregated"], 0.05),
    "kitti_default": ("KITTI_ODOM_ROOT", fab.kitti_sequence, KITTI_ARGV, 0.05),
    "ct_icp_files": ("CT_ICP_ROOT", fab.ct_icp_sequence,
                     ["dataset=ct_icp", "slam/odometry=ct_icp"], CT_ICP_ATE_M),
}
JAX_CPU_DATASET_TR_ERR = {"kitti": 0.0039289718311631755,
                          "kitti_default": 0.00012264956571831547,
                          "ct_icp_files": 0.018633348565646343}
# the files those bars were scored on (fabricate_datasets.digest)
DATASET_DIGESTS = {
    "kitti": "a95a51de50e699134c7eef338fd8527dcc7436cb311160e9d880f6c372b8b9ae",
    "ct_icp": "761d3b702a74dff3b0d7ea466d693eb654339b8822b14f01a250ecd898307b9e"}


FIXTURE = ROOT / "tests" / "fixtures" / "torch_e2e.npz"
FIXTURE_TR_ATOL = 5e-5  # a champion's tr_err against its recorded value
# The bench phase's sizes: (repeats, frames) of the smoke run; `--only bench`
# runs the benches' own defaults.
BENCH_SMOKE = {"bench": {"repeats": 1, "frames": 61},
               "bench_surfel": {"SF_REPEATS": "1", "SF_FRAMES": "100"},
               "bench_pipeline": {"FP_REPEATS": "1", "FP_FRAMES": "96",
                                  "FP_WARMUP_FRAMES": "24", "FP_COOLDOWN_FRAMES": "24"}}
BENCH_KEYS = {"bench": ["metric", "value", "unit", "vs_baseline", "median_value", "rates",
                        "batch", "stages", "phases"],
              "bench_surfel": ["metric", "value", "unit", "vs_baseline", "tr_err", "rot_err",
                               "timed_frames", "batch", "rates", "config", "total_wall_s"],
              "bench_pipeline": ["metric", "value", "unit", "timed_frames", "batch",
                                 "stages_ms_per_frame", "pipeline_ms_per_flush",
                                 "loop_ms_per_frame", "runs", "repeats"]}


def log(msg: str):
    print(msg, flush=True)


def build_phase() -> dict:
    """One nvcc per kernel source and the host encoder, started together."""
    def timed(fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        return time.perf_counter() - t0, out

    def encoder():
        if native.get_lib() is None:
            raise RuntimeError("native host encoder did not build")

    jobs = {"assoc_gn": (b1.build,), "nn_argmin": (b2.build,), "native": (encoder,)}
    with ThreadPoolExecutor(len(jobs)) as pool:
        futures = {name: pool.submit(timed, *job) for name, job in jobs.items()}
        done = {name: f.result() for name, f in futures.items()}
    secs = {name: t for name, (t, _) in done.items()}
    log("[build] " + ", ".join(f"{n} {t:.2f} s" for n, t in secs.items())
        + " (in parallel)")
    for report in sorted((ROOT / "build" / "kernels").glob("*.log")):
        log(f"[build] {report.name}:\n{report.read_text().strip()}")
    return {"seconds": secs,
            "sources": {name: str((CSRC / f"{name}.cu").relative_to(ROOT))
                        for name in ("assoc_gn", "nn_argmin")}}


def load_frames(kw: dict, extra: int = 0):
    """A synthetic sequence's loader and frames, plus `extra` frames after
    it (the trajectory is drawn frame by frame, so the first frames are the
    sequence's own)."""
    loader = SyntheticDatasetLoader(SyntheticConfig(
        **dict(kw, num_frames=kw["num_frames"] + extra)))
    ds = loader.sequences()[0][0][0]
    t0 = time.perf_counter()
    # frames are independent (each seeds its own noise); numpy's array
    # passes of the raycaster release the interpreter lock
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        frames = list(pool.map(ds.__getitem__, range(len(ds))))
    log(f"[setup] {len(frames)} frames of {kw} generated on the host in "
        f"{time.perf_counter() - t0:.1f} s")
    return loader, frames


def load_sequence():
    """The 140-frame acceptance sequence plus the frame after it."""
    loader, frames = load_frames(acceptance.SEQ_KW, extra=1)
    return loader, frames[:-1], frames[-1]


def kernel_inputs(loader, frames, dev):
    """Model image from frame 0's insert; target = frame 1 rasterized at its
    prior on the main path (the EI bootstrap estimate)."""
    cfg = acceptance.champion_configs()["aggregated"]
    odom = ICPFrameToModel(cfg, projector=loader.projector(), device=dev)
    proj = odom.projector
    odom.process_next_frame(dict(frames[0]))
    state = odom._map_state
    prior = odom._ei_bootstrap_pose(dict(frames[1]))
    if prior is None:
        raise RuntimeError("EI bootstrap found no frame-1 prior")
    buf = odom._upload(odom.encode_upload(frames[1]["numpy_pc"])[None])[0]
    pts, valid = projection.decode_range_image(buf, proj)
    q = se3.apply_transformation(pts, prior)
    idx, hit = am.rasterize_encoded(q, proj, valid)
    h, w = proj.height, proj.width
    timg = torch.where(hit[:, None], q[idx], torch.zeros_like(q[idx])).reshape(h, w, 3)
    return timg.contiguous(), state.xyz, state.normal, state.rng > 0


def compare_b1_phase(inputs) -> dict:
    wr, wc, gate = 1, 2, 0.6
    worst_abs, worst_scaled, rows = 0.0, 0.0, []
    for scheme in SCHEMES:
        for plane in PLANE_GATES:
            args = (*inputs, wr, wc, gate, scheme, 0.4, plane)
            ours = b1.assoc_gn(*args)
            again = b1.assoc_gn(*args)
            ref = b1.assoc_gn_plain(*args)
            torch.cuda.synchronize()
            ours, again, ref = (x.cpu().numpy() for x in (ours, again, ref))
            if not np.array_equal(ours, again):
                raise AssertionError(f"{scheme}: two kernel runs differ")
            if not np.all(np.isfinite(ours)):
                raise AssertionError(f"{scheme}: non-finite kernel sums {ours}")
            if ours[28] != ref[28]:
                raise AssertionError(f"{scheme} plane={plane}: match count "
                                     f"{ours[28]} (kernel) vs {ref[28]} (plain)")
            if ref[28] < 1000:
                raise AssertionError(f"{scheme}: only {ref[28]} matches")
            abs_err, scaled = b1.sum_errors(ours, ref)
            rows.append({"scheme": scheme, "plane_gate": plane,
                         "matches": int(ref[28]), "max_abs_err": abs_err,
                         "max_scaled_err": scaled})
            log(f"[compare B1] {scheme:21s} plane_gate={plane:.1f} matches="
                f"{int(ref[28])} max_abs_err={abs_err:.3e} "
                f"max_scaled_err={scaled:.3e} (tolerance {SUM_TOL:.0e})")
            if scaled > SUM_TOL:
                raise AssertionError(f"{scheme} plane={plane}: kernel vs plain "
                                     f"scaled error {scaled} > {SUM_TOL}")
            worst_abs = max(worst_abs, abs_err)
            worst_scaled = max(worst_scaled, scaled)
    dev = inputs[0].device
    # matches across the azimuth wrap, beyond the border rows and on the
    # kernel's strip edges; W off the strip width
    for (h, w), region in [((64, 1024), "wrap columns"), ((64, 1024), "border rows"),
                           ((64, 1024), "strip edges"), ((16, 1000), "all")]:
        images = [torch.from_numpy(a).to(dev) for a in seams.assoc_seam_images(h, w, region)]
        args = (*images, wr, wc, gate, "geman_mcclure", 0.4, 0.0)
        ours, ref = (x.cpu().numpy() for x in (b1.assoc_gn(*args), b1.assoc_gn_plain(*args)))
        abs_err, scaled = b1.sum_errors(ours, ref)
        log(f"[compare B1] seams {region:12s} {h}x{w} matches={int(ref[28])} "
            f"max_abs_err={abs_err:.3e} max_scaled_err={scaled:.3e}")
        if ours[28] != ref[28] or not ref[28] > 0 or scaled > SUM_TOL:
            raise AssertionError(f"B1 seams {region} {h}x{w}: matches {ours[28]} vs "
                                 f"{ref[28]}, scaled error {scaled}")
        rows.append({"scheme": "geman_mcclure", "seams": region, "shape": [h, w],
                     "matches": int(ref[28]), "max_abs_err": abs_err,
                     "max_scaled_err": scaled})
        worst_abs, worst_scaled = max(worst_abs, abs_err), max(worst_scaled, scaled)
    # the generic-window build: ct_icp_robust_shaky's 2x3 window at its first
    # trip's 3 m gate and its plane gate, and its last trip's 1 m gate
    for g_wr, g_wc, g_gate, plane in [(2, 3, 3.0, 0.8), (2, 3, 1.0, 0.8)]:
        args = (*inputs, g_wr, g_wc, g_gate, "neighborhood", 0.2, plane)
        ours, ref = (x.cpu().numpy() for x in (b1.assoc_gn(*args), b1.assoc_gn_plain(*args)))
        abs_err, scaled = b1.sum_errors(ours, ref)
        log(f"[compare B1] window {g_wr}x{g_wc} gate {g_gate} plane_gate {plane} "
            f"matches={int(ref[28])} max_abs_err={abs_err:.3e} max_scaled_err={scaled:.3e}")
        if ours[28] != ref[28] or ref[28] < 1000 or scaled > SUM_TOL:
            raise AssertionError(f"B1 window {g_wr}x{g_wc}: matches {ours[28]} vs "
                                 f"{ref[28]}, scaled error {scaled}")
        rows.append({"scheme": "neighborhood", "window": [g_wr, g_wc], "gate": g_gate,
                     "plane_gate": plane, "matches": int(ref[28]), "max_abs_err": abs_err,
                     "max_scaled_err": scaled})
        worst_abs, worst_scaled = max(worst_abs, abs_err), max(worst_scaled, scaled)
    # the last-block counter is back at 0 after every call
    args = (*inputs, wr, wc, gate, "geman_mcclure", 0.4, 0.0)
    first = b1.assoc_gn(*args)
    outs = torch.stack([b1.assoc_gn(*args) for _ in range(REPEAT_CALLS)])
    if not torch.equal(outs, first.expand_as(outs)):
        raise AssertionError(f"B1: {REPEAT_CALLS} consecutive calls differ")
    log(f"[compare B1] {REPEAT_CALLS} consecutive calls: bit-identical sums")
    return {"cases": rows, "max_abs_err": worst_abs, "max_scaled_err": worst_scaled,
            "tolerance": SUM_TOL, "repeat_calls_identical": REPEAT_CALLS}


def run_sequence(cfg, loader, frames, dev, log_iters=None):
    """One run of the configuration `cfg` (or the champion of that name)
    over the frames, each fed with the previous frame's pose as its prior
    (the batched path chains it on the device instead).  `log_iters`
    collects each step's iteration count."""
    if isinstance(cfg, str):
        cfg = acceptance.champion_configs()[cfg]
    odom = ICPFrameToModel(cfg, projector=loader.projector(), device=dev)
    if log_iters is not None:
        step = odom._map.step

        def counted(*args):
            out = step(*args)
            log_iters.append(out[4][1])
            return out
        odom._map = odom._map._replace(step=counted)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    last = None
    for f in frames:
        d = dict(f) if last is None else dict(f, init_rpose=last)
        odom.process_next_frame(d)
        last = d.get("odometry_pose")
    odom.finish()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    return odom, odom.get_relative_poses(), elapsed


def metrics(name, rel, loader, n) -> dict:
    """tr_err (None under 100 m), rot_err and ATE of `n` relative poses
    against the loader's ground truth; fails unless they are finite."""
    if rel.shape != (n, 4, 4) or not np.all(np.isfinite(rel)):
        raise AssertionError(f"{name}: relative poses are not finite (n, 4, 4)")
    gt_rel = loader.get_ground_truth("synth_00")[:n]
    ate, ate_std = ev.compute_ate(rel, gt_rel)
    tr_err, rot_err, _ = ev.compute_kitti_metrics(ev.compute_absolute_poses(rel),
                                                  ev.compute_absolute_poses(gt_rel))
    return {"tr_err": tr_err, "rot_err": rot_err, "ate_m": ate, "ate_std_m": ate_std}


def _pct(tr_err) -> str:
    return "n/a (under 100 m)" if tr_err is None else f"{100 * tr_err:.4f}%"


def score(name, rel, loader, n) -> dict:
    """tr_err / ATE against ground truth; fails on lost tracking or a miss
    of the round's bar."""
    m = metrics(name, rel, loader, n)
    tr_err, rot_err, ate, ate_std = m["tr_err"], m["rot_err"], m["ate_m"], m["ate_std_m"]
    if tr_err is None:
        raise AssertionError(f"{name}: the run is too short for tr_err")
    ref = np.load(ROOT / "tests" / "fixtures" / "reference_e2e.npz")
    bar = float(ref["kdtree_tr_err"]) + BAR_PT
    log(f"[{name}] tr_err {100 * tr_err:.4f}% rot_err {rot_err:.3e} rad/m "
        f"ATE {ate:.5f} m (std {ate_std:.5f}); bar: tr_err <= {100 * bar:.4f}% "
        f"(reference kd-tree {100 * float(ref['kdtree_tr_err']):.4f}% + 0.1 pt), "
        f"ATE < 0.05 m")
    if not ate < 0.05:
        raise AssertionError(f"{name}: ATE {ate} m: tracking lost")
    if not tr_err <= bar:
        raise AssertionError(f"{name}: tr_err {tr_err} above the bar {bar}")
    return {"tr_err": tr_err, "rot_err": rot_err, "ate_m": ate,
            "ate_std_m": ate_std, "tr_err_bar": bar}


def aggregated_phase(loader, frames, dev) -> dict:
    n = len(frames)
    expected = acceptance.champion_configs()["aggregated"].max_num_alignments * (n - 1)
    b1.assoc_gn.launches = 0
    b2.nn_argmin.launches = 0
    _, rel, elapsed = run_sequence("aggregated", loader, frames, dev)
    launches = b1.assoc_gn.launches
    log(f"[aggregated] {n} frames in {elapsed:.2f} s (first run, includes "
        f"set-up); assoc_gn launches {launches} (expected {expected}), "
        f"nn_argmin launches {b2.nn_argmin.launches}")
    if launches != expected:
        raise AssertionError(f"assoc_gn launched {launches} times, expected {expected}")
    return {"frames": n, "launches": launches, "first_run_s": elapsed,
            **score("aggregated", rel, loader, n),
            "fixture": fixture_check("aggregated", rel, loader)}


def surfel_phase(loader, frames, dev):
    n = len(frames)
    expected = acceptance.champion_configs()["surfel"].max_num_alignments * (n - 1)
    iters = []
    b1.assoc_gn.launches = 0
    b2.nn_argmin.launches = 0
    odom, rel, elapsed = run_sequence("surfel", loader, frames, dev, iters)
    launches = b2.nn_argmin.launches
    # every iteration the loop ran re-searched (reassoc_every = 1): those
    # launches did work, the frozen trips' launches returned at once
    worked = int(torch.stack(iters).sum())
    log(f"[surfel] {n} frames in {elapsed:.2f} s (first run, includes set-up); "
        f"nn_argmin launches {launches} (expected {expected}), {worked} of "
        f"them active; assoc_gn launches {b1.assoc_gn.launches}")
    if launches != expected:
        raise AssertionError(f"nn_argmin launched {launches} times, expected {expected}")
    if not 0 < worked <= launches:
        raise AssertionError(f"{worked} active nn_argmin launches")
    return odom, {"frames": n, "launches": launches, "active_launches": worked,
                  "first_run_s": elapsed, **score("surfel", rel, loader, n),
                  "fixture": fixture_check("surfel", rel, loader)}


def fixture_check(name, rel, loader) -> dict:
    """The champion's run against its trajectory in the card-recorded
    fixture: the same code stamp and ground truth, tr_err within
    FIXTURE_TR_ATOL of the recorded one; prints the largest translation gap
    between the two trajectories."""
    fx = np.load(FIXTURE)
    recorded, current = bytes(fx["stamp"]).decode(), acceptance.code_stamp()
    if recorded != current:
        raise AssertionError(f"{FIXTURE.name} was recorded under code stamp {recorded[:12]}, "
                             f"the sources stamp {current[:12]}: re-record it on the card "
                             f"(python -m pylidar_slam_tpu_torch.eval.record_e2e)")
    gt = fx["gt_absolute"]
    n = gt.shape[0]
    own_gt = ev.compute_absolute_poses(loader.get_ground_truth("synth_00")[:n])
    if not np.allclose(own_gt, gt, atol=1e-9):
        raise AssertionError(f"{FIXTURE.name}: another ground truth than this sequence's")
    traj = ev.compute_absolute_poses(rel)
    tr_err = ev.compute_kitti_metrics(traj, gt)[0]
    want = float(fx[f"{name}_tr_err"])
    gap = float(np.linalg.norm(traj[:, :3, 3] - fx[f"{name}_trajectory"][:, :3, 3],
                               axis=-1).max())
    log(f"[{name}] against {FIXTURE.name} (recorded on {fx['card']}, stamp {recorded[:12]}): "
        f"tr_err {100 * tr_err:.6f}% vs recorded {100 * want:.6f}% (|diff| "
        f"{abs(tr_err - want):.3e}, tolerance {FIXTURE_TR_ATOL:.0e}); largest translation "
        f"gap {gap:.3e} m")
    if not abs(tr_err - want) <= FIXTURE_TR_ATOL:
        raise AssertionError(f"{name}: tr_err {tr_err} vs recorded {want}")
    return {"stamp": recorded, "recorded_tr_err": want, "tr_err_diff": abs(tr_err - want),
            "max_translation_gap_m": gap, "recorded_on": str(fx["card"])}


def _step_call(odom, frame):
    """One step of `odom` on `frame` from its current state, as a callable
    (the frame is read and uploaded here), and a function of the step's
    output giving its pose params."""
    prior = odom.last_rpose_device
    step = odom._map.step
    if not odom._map.uploads:  # the projective map steps vertex maps
        vmap = odom._read_input(dict(frame))
        return (lambda: step(odom._map_state, odom._delta_since_update, vmap, prior),
                lambda out: out[2].pose_params)
    points, mask = odom._read_points(dict(frame))
    return (lambda: step(odom._map_state, odom._delta_since_update, points, mask,
                         prior), lambda out: out[3])


def sync_check(name, odom, frame) -> None:
    """One more step of `odom` on `frame` under
    ``torch.cuda.set_sync_debug_mode("error")``: any host sync inside the
    per-frame step raises.  The frame is uploaded before the mode is set."""
    step, pose_of = _step_call(odom, frame)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = step()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(pose_of(out)).all()):
        raise AssertionError(f"{name}: the checked step's pose is not finite")
    log(f"[sync] {name}: one step under set_sync_debug_mode('error'), no host sync")


def step_profile(name, odom, frame, steps=3) -> dict:
    """Kernels and device ms per step (torch.profiler), warm wall ms per
    step (back-to-back steps ending in a sync) and the device's idle share
    of a step, 1 - device / wall, all from the same map state."""
    step, _ = _step_call(odom, frame)
    prof = _device_kernels(step, steps)
    kernels, device_ms = prof.kernels, prof.device_ms
    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    idle = None if device_ms is None else 1.0 - device_ms / wall_ms
    log(f"[step] {name}: {kernels} kernels per step ({prof.own_kernels} of B1 and B2 for "
        f"{prof.own_launches} launches; {prof.filler_lost} filler kernels dropped), device "
        f"{device_ms} ms, wall "
        f"{wall_ms:.2f} ms per step, device idle share {idle}")
    return {"kernels_per_step": kernels, "device_ms_per_step": device_ms,
            "own_kernels_per_step": prof.own_kernels, "own_launches_per_step": prof.own_launches,
            "filler_lost": prof.filler_lost,
            "wall_ms_per_step": wall_ms, "idle_share": idle}


def profile_run(name, cfg, loader, frames, dev) -> tuple:
    """`cfg` over the frames with B1's launches counted (set to 0 just
    before the run, read just after).  Returns (odometry, metrics and
    counts); scans/s includes the odometry's set-up."""
    n = len(frames)
    b1.assoc_gn.launches = 0
    b2.nn_argmin.launches = 0
    odom, rel, elapsed = run_sequence(cfg, loader, frames, dev)
    launches, nn = b1.assoc_gn.launches, b2.nn_argmin.launches
    m = metrics(name, rel, loader, n)
    log(f"[{name}] {n} frames: tr_err {_pct(m['tr_err'])} ATE {m['ate_m']:.5f} m "
        f"(std {m['ate_std_m']:.5f}); assoc_gn launches {launches}, nn_argmin launches "
        f"{nn}; {n / elapsed:.2f} scans/s (includes set-up)")
    return odom, {"frames": n, "launches": launches, "nn_argmin_launches": nn,
                  "scans_per_s": n / elapsed, **m}


def _expect_launches(name, cfg, n, launches):
    point_to_plane = (cfg.alignment or {}).get(
        "mode", "point_to_plane_gauss_newton") == "point_to_plane_gauss_newton"
    expected = cfg.max_num_alignments * (n - 1) if point_to_plane else 0
    if launches != expected:
        raise AssertionError(f"{name}: assoc_gn launched {launches} times, "
                             f"expected {expected}")


def highway_phase(dev, card) -> dict:
    """The aggregated_highway profile over the 2 m/frame sequence."""
    cfg = acceptance.profile_configs()["aggregated_highway"]
    loader, frames = load_frames(acceptance.HIGHWAY_KW)
    odom, out = profile_run("highway", cfg, loader, frames, dev)
    _expect_launches("highway", cfg, len(frames), out["launches"])
    log(f"[highway] {card}: bar: tr_err <= {100 * HIGHWAY_TR_ERR:.2f}% (the JAX "
        f"package's pin)")
    if out["tr_err"] is None or not out["tr_err"] <= HIGHWAY_TR_ERR:
        raise AssertionError(f"highway: tr_err {out['tr_err']} above {HIGHWAY_TR_ERR}")
    sync_check("highway", odom, frames[-1])
    out["step"] = step_profile(f"highway {card}", odom, frames[-1])
    return out


def ct_icp_phase(loader, frames, dev, card) -> dict:
    """The ct_icp profile over the rolling-shutter sequence, elastic and
    then rigid (the same configuration with the warp off).

    The profile reports mid-sweep poses (``get_relative_poses``), held to
    the JAX package's ATE pin.  The sequence's ground truth is the
    scan-START poses, and mid-sweep poses differ from them by half a frame's
    motion, so the elastic run is held against the rigid one (which reports
    scan-start poses) on its scan-start surface
    (``get_ct_relative_poses("begin_pose")``)."""
    cfg = acceptance.profile_configs()["ct_icp"]
    n = len(frames)
    odom, elastic = profile_run("ct_icp", cfg, loader, frames, dev)
    _expect_launches("ct_icp", cfg, n, elastic["launches"])
    surfaces = {name: metrics(f"ct_icp {name}", odom.get_ct_relative_poses(name), loader, n)
                for name in ("begin_pose", "end_pose")}
    rigid_cfg = dataclasses.replace(cfg, alignment=dict(cfg.alignment, elastic=False))
    _, rigid = profile_run("ct_icp rigid", rigid_cfg, loader, frames, dev)
    begin = surfaces["begin_pose"]
    log(f"[ct_icp] {card}: elastic tr_err {_pct(elastic['tr_err'])} (mid_pose), {_pct(begin['tr_err'])} "
        f"(begin_pose, ATE {begin['ate_m']:.5f} m), "
        f"{_pct(surfaces['end_pose']['tr_err'])} (end_pose); rigid {_pct(rigid['tr_err'])}; "
        f"bar: ATE < {CT_ICP_ATE_M} m (the JAX package's pin), elastic begin_pose tr_err "
        f"below rigid")
    if not elastic["ate_m"] < CT_ICP_ATE_M:
        raise AssertionError(f"ct_icp: ATE {elastic['ate_m']} m")
    if begin["tr_err"] is None or rigid["tr_err"] is None or \
            not begin["tr_err"] < rigid["tr_err"]:
        raise AssertionError(f"ct_icp: elastic tr_err {begin['tr_err']} (begin_pose) not "
                             f"below rigid {rigid['tr_err']}")
    sync_check("ct_icp", odom, frames[-1])
    elastic["step"] = step_profile(f"ct_icp {card}", odom, frames[-1])
    return {"elastic": elastic, "elastic_surfaces": surfaces, "rigid": rigid}


def profile_variants() -> dict:
    """The other CT-ICP profiles and the aggregated champion with the other
    alignment modes and the one-shot deskew."""
    profiles = acceptance.profile_configs()
    out = {name: profiles[name] for name in ("ct_icp_drive", "ct_icp_robust_drive",
                                              "ct_icp_robust_shaky",
                                              "ct_icp_slow_outdoor")}
    champion = acceptance.champion_configs()["aggregated"]
    for name, over in (("point_to_point_gauss_newton",
                        {"mode": "point_to_point_gauss_newton"}),
                       ("point_to_point_procrustes", {"mode": "point_to_point_procrustes"}),
                       ("deskew", {"deskew": True})):
        out["champion " + name] = dataclasses.replace(
            champion, alignment=dict(champion.alignment, **over))
    return out


def profiles_phase(loader, frames, dev) -> dict:
    frames = frames[:PROFILE_FRAMES]
    out = {}
    for name, cfg in profile_variants().items():
        odom, out[name] = profile_run(name, cfg, loader, frames, dev)
        _expect_launches(name, cfg, len(frames), out[name]["launches"])
        sync_check(name, odom, frames[-1])
    return out


class _RunnerLog(logging.Handler):
    """Keeps the SLAM runner's log lines (its device and scans/s)."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _reader_rate(seq) -> float:
    """scans/s of `seq[i]` over the whole sequence, one thread, on this
    host (the files were just written or read: the page cache holds them)."""
    t0 = time.perf_counter()
    for i in range(len(seq)):
        seq[i]
    return len(seq) / (time.perf_counter() - t0)


def dataset_cli_run(name) -> dict:
    """One run of DATASET_RUNS[name] through the port's CLI in this process,
    with no device override, B1's and B2's launches and the native KITTI
    reads counted (each set to 0 just before the run, read just after)."""
    from pylidar_slam_tpu_torch import run as trun
    env, make, argv, _ = DATASET_RUNS[name]
    os.environ[env] = str(make(DATASETS_DIR))
    log_dir = ROOT / "build" / f"chip_{name}"
    shutil.rmtree(log_dir, ignore_errors=True)
    argv = argv + [f"log_dir={log_dir}", "num_workers=8"]
    handler = _RunnerLog()
    runner_log = logging.getLogger("pylidar_slam_tpu_torch.slam.odometry_runner")
    runner_log.addHandler(handler)
    runner_log.setLevel(logging.INFO)
    b1.assoc_gn.launches = 0
    b2.nn_argmin.launches = 0
    native.load_kitti_scan.reads = 0
    t0 = time.perf_counter()
    try:
        metrics = trun.main(argv)
    finally:
        runner_log.removeHandler(handler)
    seconds = time.perf_counter() - t0
    launches, nn, reads = b1.assoc_gn.launches, b2.nn_argmin.launches, native.load_kitti_scan.reads
    if not any(" on cuda" in line for line in handler.lines):
        raise AssertionError(f"{name}: the CLI did not run on the card: {handler.lines}")
    (seq, m), = ((k, v) for k, v in metrics.items() if k != "AVG")
    rate = next((line for line in handler.lines if "scans/s" in line), "")
    frames = int(re.search(r": (\d+) frames in", rate).group(1))
    return {"argv": argv, "sequence": seq, "seconds": seconds, "metrics": m,
            "rate_line": rate, "frames": frames, "scans_per_s": _rate_of(rate, frames, seconds),
            "tr_err": m.get("tr_err"), "ate_m": m["ATE"], "launches": launches,
            "nn_argmin_launches": nn, "native_reads": reads}


def _dataset_bar(name, out, card) -> dict:
    bar = JAX_CPU_DATASET_TR_ERR[name] + BAR_PT
    ate_bar = DATASET_RUNS[name][3]
    log(f"[datasets] {card}: {name}: python -m pylidar_slam_tpu_torch.run "
        f"{' '.join(out['argv'])}: {out['frames']} frames, tr_err {_pct(out['tr_err'])} ATE "
        f"{out['ate_m']:.5f} m, {out['scans_per_s']:.2f} scans/s ({out['rate_line']}; "
        f"{out['seconds']:.1f} s in all); assoc_gn launches {out['launches']}, nn_argmin "
        f"launches {out['nn_argmin_launches']}, native KITTI reads {out['native_reads']}; bar: "
        f"tr_err <= {100 * bar:.4f}% (the JAX package on the CPU "
        f"{100 * JAX_CPU_DATASET_TR_ERR[name]:.4f}% + 0.1 pt), ATE < {ate_bar} m")
    if out["tr_err"] is None or not out["tr_err"] <= bar:
        raise AssertionError(f"{name}: tr_err {out['tr_err']} above the bar {bar}")
    if not out["ate_m"] < ate_bar:
        raise AssertionError(f"{name}: ATE {out['ate_m']} m")
    return {"tr_err_bar": bar, "ate_bar_m": ate_bar}


def dataset_step(name, dev, card) -> dict:
    """One step of the run's configuration in this process, on the loader's
    own frames, under sync-debug "error", then three under the profiler."""
    env, make, argv, _ = DATASET_RUNS[name]
    os.environ[env] = str(make(DATASETS_DIR))
    cfg = compose(str(ROOT / "config"), "slam", argv)
    loader = DATASET.load(dict(cfg["dataset"]))
    ds = loader.sequences()[0][0][0]
    odom = ICPFrameToModel(cfg["slam"]["odometry"], projector=loader.projector(), device=dev)
    last = None
    for i in range(6):
        d = dict(ds[i]) if last is None else dict(ds[i], init_rpose=last)
        odom.process_next_frame(d)
        last = d.get("odometry_pose")
    sync_check(f"datasets {name}", odom, ds[6])
    return step_profile(f"datasets {name} {card}", odom, ds[6])


def datasets_phase(dev, card) -> dict:
    """The on-disk sequences through the port's CLI (see the module's
    docstring, phase 9b)."""
    from pylidar_slam_tpu_torch.dataset.kitti_dataset import KITTIOdometrySequence
    from pylidar_slam_tpu_torch.dataset.ct_icp_dataset import CTICPSequence
    out = {}
    t0 = time.perf_counter()
    roots = {"kitti": fab.kitti_sequence(DATASETS_DIR), "ct_icp": fab.ct_icp_sequence(DATASETS_DIR)}
    out["fabricate_s"] = time.perf_counter() - t0
    out["digests"] = {k: fab.digest(r) for k, r in roots.items()}
    out["same_bytes_as_bars"] = {k: out["digests"][k] == DATASET_DIGESTS[k] for k in roots}
    log(f"[datasets] files under {DATASETS_DIR} ready in {out['fabricate_s']:.1f} s; the same "
        f"bytes as the JAX package's bars read: {out['same_bytes_as_bars']}")
    native.load_kitti_scan.reads = 0
    kitti = KITTIOdometrySequence(str(roots["kitti"]), fab.KITTI_SEQUENCE)
    ply = CTICPSequence(str(roots["ct_icp"]), fab.CT_ICP_SEQUENCE)
    out["reader_scans_per_s"] = {"kitti": _reader_rate(kitti), "ct_icp": _reader_rate(ply)}
    points = [len(kitti[i]["numpy_pc"]) for i in (0, len(kitti) - 1)]
    if native.load_kitti_scan.reads != len(kitti) + 2:
        raise AssertionError(f"the native KITTI reader read {native.load_kitti_scan.reads} "
                             f"scans of {len(kitti) + 2}")
    log(f"[datasets] {card}: the readers on this host, one thread: KITTI "
        f"{out['reader_scans_per_s']['kitti']:.1f} scans/s (native one-pass reader; "
        f"{points} points in the first and last scans), CT-ICP PLY "
        f"{out['reader_scans_per_s']['ct_icp']:.1f} scans/s")

    runs = {}
    for name, repeat in (("kitti", 2), ("kitti_default", 1), ("ct_icp_files", 1)):
        results = [dataset_cli_run(name) for _ in range(repeat)]
        run = results[0]
        run["launches_runs"] = [r["launches"] for r in results]
        run["repeats"] = [{k: r[k] for k in ("tr_err", "ate_m", "scans_per_s", "seconds")}
                          for r in results[1:]]
        for again in run["repeats"]:
            log(f"[datasets] {card}: {name} again: tr_err {_pct(again['tr_err'])} ATE "
                f"{again['ate_m']:.5f} m, {again['scans_per_s']:.2f} scans/s")
        run.update(_dataset_bar(name, run, card))
        if name.startswith("kitti") and any(r["native_reads"] != r["frames"] for r in results):
            raise AssertionError(f"{name}: {[r['native_reads'] for r in results]} native "
                                 f"reads of {run['frames']} frames")
        if name == "kitti_default":
            _no_kernel_launches("kitti_default")
        else:
            # one launch per GN trip of every frame after the first
            trips = compose(str(ROOT / "config"), "slam", DATASET_RUNS[name][2])["slam"][
                "odometry"]["max_num_alignments"]
            run["expected_launches"] = int(trips) * (run["frames"] - 1)
            log(f"[datasets] {name}: assoc_gn launches {run['launches_runs']} (expected "
                f"{run['expected_launches']} in each run)")
            if set(run["launches_runs"]) != {run["expected_launches"]}:
                raise AssertionError(f"{name}: assoc_gn launches {run['launches_runs']}, "
                                     f"expected {run['expected_launches']}")
        run["step"] = dataset_step(name, dev, card)
        runs[name] = run
    out["runs"] = runs
    return out


def slam_config(batch: int, loop_closure: bool) -> dict:
    return compose(str(ROOT / "config"), "slam", SLAM_OVERRIDES + [
        f"slam.odometry.batch_size={batch}"] + (LOOP_OVERRIDES if loop_closure else []))


def run_slam(batch, loop_closure, loader, frames, dev) -> tuple:
    """The port's SLAM over the frames, the kernels' counts set to 0 after
    ``init()`` (the loop closure's warm-up launches B2); returns (slam, wall
    seconds of the frames, the loop constraints registered before the last
    frame)."""
    slam = SLAM(slam_config(batch, loop_closure)["slam"], projector=loader.projector(),
                device=dev)
    slam.init()
    torch.cuda.synchronize()
    b1.assoc_gn.launches = 0
    b2.nn_argmin.launches = 0
    t0 = time.perf_counter()
    before_last = []
    for i, f in enumerate(frames):
        slam.process_next_frame(dict(f))
        if i == len(frames) - 2 and slam.backend is not None:
            before_last = list(slam.backend.registered_loop_constraints())
    slam.finish()
    torch.cuda.synchronize()
    return slam, time.perf_counter() - t0, before_last


def loop_errors(loops, gt) -> list:
    """Each loop constraint (i, j, T) against the ground truth inv(P_i) P_j:
    (i, j, translation error m, rotation error deg)."""
    out = []
    for i, j, mat, _ in loops:
        d = np.linalg.inv(np.linalg.inv(gt[i]) @ gt[j]) @ np.asarray(mat)
        cos = np.clip((np.trace(d[:3, :3]) - 1.0) / 2.0, -1.0, 1.0)
        out.append((int(i), int(j), float(np.linalg.norm(d[:3, 3])),
                    float(np.degrees(np.arccos(cos)))))
    return out


def match_profile(lc, card) -> tuple:
    """The last submap event's candidate match dispatched again: once under
    ``set_sync_debug_mode("error")``, then timed (wall, synced) and traced
    (kernels, device ms); the extra results are dropped.  Returns (profile,
    B2 inputs of the event's first refine trip: the submap cloud, the
    first candidate's cloud and mask)."""
    stats = next(st for st in reversed(lc.match_stats) if st["candidates"] > 0)
    k = lc.maps_frame_ids.index(stats["frame_id"])
    args = (stats["ids"], lc.saved_images[k], lc.saved_clouds[k], stats["frame_id"])
    pending = list(lc._pending_matches)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        lc._match_candidates(*args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log("[sync] slam: one _match_candidates dispatch under set_sync_debug_mode('error'), "
        "no host sync")
    launches = b2.nn_argmin.launches
    prof = _device_kernels(lambda: lc._match_candidates(*args), 3)
    kernels, device_ms = prof.kernels, prof.device_ms
    b2_per_match = (b2.nn_argmin.launches - launches) / 4
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        lc._match_candidates(*args)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    lc._pending_matches = pending
    wall_ms = float(np.median(walls))
    out = {"candidates": stats["candidates"], "kernels": kernels, "device_ms": device_ms,
           "own_kernels": prof.own_kernels, "filler_lost": prof.filler_lost,
           "wall_ms": wall_ms, "wall_runs_ms": walls, "b2_launches": b2_per_match,
           "idle_share": None if device_ms is None else 1.0 - device_ms / wall_ms}
    log(f"[slam] {card}: one submap event's match ({stats['candidates']} candidates, padded "
        f"to 10): {kernels} kernels ({prof.own_kernels} of B2), device {device_ms} ms, "
        f"wall {wall_ms:.2f} ms "
        f"(runs {[round(w, 2) for w in walls]}), {b2_per_match:.0f} B2 launches")
    cloud, mask = lc.saved_clouds[k]
    cand, cand_mask = lc.saved_clouds[stats["ids"][0]]
    return out, (cloud.contiguous(), cand.contiguous(), cand_mask.contiguous(), mask)


def slam_phase(dev, card) -> tuple:
    """SLAM with loop closure and the backend at batch 1 and 4, then without
    loop closure (scans/s); B2's launches counted on the refine."""
    loader, frames = load_frames(dict(lidar_height=64, lidar_width=1024,
                                      num_frames=SLAM_FRAMES, turn_rate=0.01))
    gt = loader.sequences()[0][0][0].poses_gt
    gt_rel = loader.get_ground_truth("synth_00")[:SLAM_FRAMES]
    out, slams = {}, {}
    for batch in (1, 4):
        slam, elapsed, before_last = run_slam(batch, True, loader, frames, dev)
        launches = b2.nn_argmin.launches
        lc = slam.loop_closure
        loops = loop_errors(slam.backend.registered_loop_constraints(), gt)
        ate, ate_std = ev.compute_ate(slam.get_relative_poses(), gt_rel)
        odo_ate = ev.compute_ate(slam.odometry.get_relative_poses(), gt_rel)[0]
        trips = sum(st["refine_trips"] for st in lc.match_stats)
        run = {"batch": batch, "frames": SLAM_FRAMES, "seconds": elapsed,
               "scans_per_s": SLAM_FRAMES / elapsed, "loops": loops,
               "loops_before_last_frame": [(int(i), int(j)) for i, j, *_ in before_last],
               "ate_m": ate, "ate_std_m": ate_std, "odometry_ate_m": odo_ate,
               "b2_launches": launches, "b2_active_launches": trips,
               "b1_launches": b1.assoc_gn.launches, "submap_events": len(lc.maps_frame_ids),
               "matches": lc.match_stats, "warmup_s": lc.warmup_seconds,
               "loop_closure_s": sum(slam.elapsed_loop_closure),
               "loop_closure_max_s": max(slam.elapsed_loop_closure)}
        log(f"[slam] {card}: batch {batch}: {SLAM_FRAMES} frames in {elapsed:.2f} s "
            f"({SLAM_FRAMES / elapsed:.2f} scans/s, init() and its warm-up not counted; "
            f"{EARLIER_SCANS_PER_S[batch]} with no warm-up); warm-up at init "
            f"{lc.warmup_seconds:.3f} s; the loop closure's seconds on the pipeline thread "
            f"{run['loop_closure_s']:.3f}, the longest frame's {run['loop_closure_max_s']:.3f}; "
            f"loops {[(i, j, round(t, 4), round(r, 4)) for i, j, t, r in loops]}; ATE "
            f"{ate:.5f} m (odometry alone {odo_ate:.5f} m); B2 launches {launches}, {trips} "
            f"active; B1 launches {b1.assoc_gn.launches}")
        if not loops:
            raise AssertionError(f"slam batch {batch}: no loop constraint")
        if not any(abs(i - j) > 2 for i, j, *_ in before_last):
            raise AssertionError(f"slam batch {batch}: the backend did not optimize before "
                                 "the last frame")
        for i, j, terr, rerr in loops:
            if not (terr < LOOP_TRANS_M and rerr < LOOP_ROT_DEG):
                raise AssertionError(f"slam batch {batch}: loop ({i}, {j}) off the ground "
                                     f"truth by {terr} m, {rerr} deg")
        if not ate < SLAM_ATE_M:
            raise AssertionError(f"slam batch {batch}: ATE {ate} m")
        if not 0 < trips <= launches:
            raise AssertionError(f"slam batch {batch}: B2 launches {launches}, active {trips}")
        out[f"batch{batch}"], slams[batch] = run, slam
    pairs = {b: [(i, j) for i, j, *_ in out[f"batch{b}"]["loops"]] for b in (1, 4)}
    if pairs[1] != pairs[4]:
        raise AssertionError(f"slam: loop pairs differ, batch 1 {pairs[1]} vs 4 {pairs[4]}")
    log(f"[slam] loop pairs identical at batch 1 and 4: {pairs[1]}")
    out["match"], lc_inputs = match_profile(slams[1].loop_closure, card)
    for batch in (1, 4):
        slam, elapsed, _ = run_slam(batch, False, loader, frames, dev)
        ate = ev.compute_ate(slam.get_relative_poses(), gt_rel)[0]
        out[f"batch{batch}_no_loop_closure"] = {"seconds": elapsed, "ate_m": ate,
                                                "scans_per_s": SLAM_FRAMES / elapsed}
        log(f"[slam] {card}: batch {batch} without loop closure: {SLAM_FRAMES / elapsed:.2f} "
            f"scans/s, ATE {ate:.5f} m")
    return out, lc_inputs


def only_slam(dev, card) -> dict:
    """The slam phase, then B2 against its plain version on the refine's
    inputs."""
    out, lc_inputs = slam_phase(dev, card)
    out["compare_b2"] = _b2_case("loop-closure refine", *lc_b2_args(lc_inputs))
    return out


def lc_b2_args(lc_inputs) -> tuple:
    """B2's inputs on a refine's first trip: the submap cloud (4096 rows,
    padding included: the refine drops the padded queries by their mask) at
    the identity, against a candidate's 4096 rows and validity mask."""
    cloud, cand, cand_mask, _ = lc_inputs
    return cloud, cand, cand_mask


def cli_phase(card) -> dict:
    """The verify recipe through the port's CLI, in a process of its own,
    with no device override: it must run on the card."""
    log_dir = ROOT / "build" / "chip_cli"
    argv = CLI_OVERRIDES + [f"log_dir={log_dir}", "num_workers=8"]
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "pylidar_slam_tpu_torch.run", *argv],
                          cwd=ROOT, capture_output=True, text=True, timeout=900)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"the CLI failed:\n{proc.stderr[-4000:]}")
    on_card = "on cuda" in proc.stderr
    m = load_yaml_file(log_dir / "metrics.yaml")["synth_00"]
    rate = next((line for line in proc.stderr.splitlines() if "scans/s" in line), "")
    log(f"[cli] {card}: python -m pylidar_slam_tpu_torch.run {' '.join(argv)}: "
        f"{seconds:.1f} s in all; {rate.split(': ', 1)[-1]}; tr_err {100 * m['tr_err']:.4f}% "
        f"ATE {m['ATE']:.5f} m; bar: tr_err < {100 * CLI_TR_ERR:.0f}%, ATE < {CLI_ATE_M} m")
    if not on_card:
        raise AssertionError("the CLI did not run on the card")
    if not (m["tr_err"] < CLI_TR_ERR and m["ATE"] < CLI_ATE_M):
        raise AssertionError(f"cli: tr_err {m['tr_err']}, ATE {m['ATE']}")
    return {"argv": argv, "seconds": seconds, "metrics": m, "rate_line": rate}


def _no_kernel_launches(name):
    """Neither kernel is on the projective or the voxel path."""
    if b1.assoc_gn.launches or b2.nn_argmin.launches:
        raise AssertionError(f"{name}: assoc_gn launched {b1.assoc_gn.launches} times, "
                             f"nn_argmin {b2.nn_argmin.launches} times")


def _map_bar(name, m, scans_per_s, card, extra="") -> dict:
    bar = JAX_CPU_TR_ERR[name] + BAR_PT
    log(f"[{name}] {card}: tr_err {_pct(m['tr_err'])} ATE {m['ate_m']:.5f} m, "
        f"{scans_per_s:.2f} scans/s{extra}; bar: tr_err <= {100 * bar:.4f}% (the JAX "
        f"package on the CPU {100 * JAX_CPU_TR_ERR[name]:.4f}% + 0.1 pt), ATE < {MAP_ATE_M} m")
    if m["tr_err"] is None or not m["tr_err"] <= bar:
        raise AssertionError(f"{name}: tr_err {m['tr_err']} above the bar {bar}")
    if not m["ate_m"] < MAP_ATE_M:
        raise AssertionError(f"{name}: ATE {m['ate_m']} m")
    return {"tr_err_bar": bar}


def projective_phase(dev, card) -> dict:
    """The verify recipe on the projective map through the port's CLI (on
    the card, no device override), then one step of the same configuration
    in this process under sync-debug "error" and under the profiler."""
    log_dir = ROOT / "build" / "chip_projective"
    argv = PROJECTIVE_OVERRIDES + [f"log_dir={log_dir}", "num_workers=8"]
    b1.assoc_gn.launches = 0
    b2.nn_argmin.launches = 0
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "pylidar_slam_tpu_torch.run", *argv],
                          cwd=ROOT, capture_output=True, text=True, timeout=900)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"the projective CLI run failed:\n{proc.stderr[-4000:]}")
    if "on cuda" not in proc.stderr:
        raise AssertionError("the projective CLI run did not run on the card")
    rate = next((line for line in proc.stderr.splitlines() if "scans/s" in line), "")
    frames = int(CLI_OVERRIDES[1].split("=")[1])
    raw = load_yaml_file(log_dir / "metrics.yaml")["synth_00"]
    m = {"tr_err": raw["tr_err"], "ate_m": raw["ATE"]}
    ref = float(np.load(ROOT / "tests" / "fixtures" / "reference_e2e.npz")["projective_tr_err"])
    scans = _rate_of(rate, frames, seconds)
    out = {"argv": argv, "seconds": seconds, "metrics": raw, "rate_line": rate,
           "scans_per_s": scans, "reference_projective_tr_err": ref, **m,
           **_map_bar("projective", m, scans, card,
                      f" ({rate.split(': ', 1)[-1]}; the reference's projective class "
                      f"{100 * ref:.4f}%)")}
    # the CLI's process launches in its own address space; this one's
    # counts must stay at 0
    _no_kernel_launches("projective")
    cfg = compose(str(ROOT / "config"), "slam", PROJECTIVE_OVERRIDES)
    loader = DATASET.load(dict(cfg["dataset"]))
    ds = loader.sequences()[0][0][0]
    odom = ICPFrameToModel(cfg["slam"]["odometry"], projector=loader.projector(), device=dev)
    if odom._mode != "projective_local_map" or odom.local_map_size != 20:
        raise AssertionError(f"projective: composed {odom._mode} K={odom.local_map_size}")
    last = None
    for i in range(6):
        d = dict(ds[i]) if last is None else dict(ds[i], init_rpose=last)
        odom.process_next_frame(d)
        last = d.get("odometry_pose")
    sync_check("projective", odom, ds[6])
    out["step"] = step_profile(f"projective {card}", odom, ds[6])
    _no_kernel_launches("projective")
    return out


def _rate_of(rate_line, frames, seconds) -> float:
    """scans/s from the CLI's own log line, else frames over the process's
    wall time (start-up included)."""
    found = re.search(r"([0-9.]+) scans/s", rate_line)
    return float(found.group(1)) if found else frames / seconds


def voxel_phase(loader, frames, dev, card) -> dict:
    """The voxel-table map's bench configuration over the acceptance
    sequence."""
    cfg = acceptance.profile_configs()["voxel"]
    odom, out = profile_run("voxel", cfg, loader, frames, dev)
    _, _, elapsed = run_sequence(cfg, loader, frames, dev)
    out["warm_scans_per_s"] = len(frames) / elapsed
    out.update(_map_bar("voxel", out, out["scans_per_s"], card,
                        f" with set-up, {out['warm_scans_per_s']:.2f} warm"))
    _no_kernel_launches("voxel")
    sync_check("voxel", odom, frames[-1])
    out["step"] = step_profile(f"voxel {card}", odom, frames[-1])
    return out


def decode_check(frame, proj, dev) -> dict:
    """Each codec's frame decoded on the card and on the CPU by the port's
    own code: the same validity, points within DECODE_TOL."""
    pts = np.asarray(frame["numpy_pc"], np.float32)[:, :3]
    bufs = {"rimg": projection.np_encode_range_image(pts, proj, planes=False),
            "rimg16": projection.np_encode_range_image(pts, proj, sub16=True, planes=False),
            "rimg8": projection.np_encode_range_image(pts, proj),
            "rimg12": projection.np_encode_rimg12(pts, proj),
            "packed": projection.np_encode_packed_upload(pts[~np.isnan(pts).any(axis=1)],
                                                         proj),
            "int16": np.round(pts[~np.isnan(pts).any(axis=1)] / 0.004).astype(np.int16)}
    out = {}
    for fmt, buf in bufs.items():
        padded = np.zeros((buf.shape[0] + 1024, buf.shape[1]), buf.dtype)
        padded[:buf.shape[0]] = buf
        host = torch.from_numpy(padded)
        mask = torch.ones(host.shape[0] * (4 if fmt == "rimg12" else 1), dtype=torch.bool)
        cpu = am.dequant_upload(host, mask, proj, 0.004)
        card = am.dequant_upload(host.to(dev), mask.to(dev), proj, 0.004)
        torch.cuda.synchronize()
        same = bool(torch.equal(card[1].cpu(), cpu[1]))
        err = float((card[0].cpu() - cpu[0]).abs().max())
        out[fmt] = {"bytes": int(buf.nbytes), "valid": int(cpu[1].sum()),
                    "same_validity": same, "max_abs_err_m": err}
        if not same or not err <= DECODE_TOL or out[fmt]["valid"] < 10000:
            raise AssertionError(f"codecs: {fmt} decoded on the card: {out[fmt]}")
    log("[codecs] decoders on the card against the CPU: " + ", ".join(
        f"{f} {o['bytes']} B, {o['valid']} points, max |err| {o['max_abs_err_m']:.2e} m"
        for f, o in out.items()) + f" (bar {DECODE_TOL} m, the same validity)")
    return out


def batch_sync_check(name, odom, frames) -> None:
    """One batched step of `odom` on `frames` (one batch) under
    ``torch.cuda.set_sync_debug_mode("error")``, eagerly and then as the
    replays of the CUDA graph its run captured (the run's batched path);
    the batch is encoded and uploaded before the mode is set."""
    bufs = [odom._compact_host_buffer(np.asarray(f["numpy_pc"])) for f in frames]
    pts, msks = odom._upload(odom._stack(bufs)), odom._ones_mask(len(bufs))
    if (pts.dtype,) + tuple(pts.shape[1:]) not in odom._graphs:
        raise AssertionError(f"{name}: the run captured no CUDA graph for its uploads")
    torch.cuda.synchronize()
    replays = timer.snapshot().get("count.odometry.graph_replays", 0)
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = odom._map.batch_step(odom._map_state, odom._delta_since_update,
                                   odom.last_rpose_device, pts, msks)
        replayed = odom._step_graphed(pts, msks)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    replays = timer.snapshot().get("count.odometry.graph_replays", 0) - replays
    if replays != len(bufs):
        raise AssertionError(f"{name}: {replays} replays for a batch of {len(bufs)}")
    if not (bool(torch.isfinite(out[3]).all()) and bool(torch.equal(replayed, out[3]))):
        raise AssertionError(f"{name}: the checked batch's poses are not finite, or the "
                             "replays' differ from the eager step's")
    log(f"[sync] {name}: one batched step of {len(bufs)} frames, eager and replayed, under "
        f"set_sync_debug_mode('error'), no host sync; the same poses")


def codecs_phase(dev, card) -> dict:
    """The upload codecs on the card: each decoder against the CPU's; the
    aggregated champion under each codec and the surfel champion under rimg
    over the acceptance sequence on de-calibrated beams (launch counts, ATE,
    tr_err against the JAX package's CPU figure + 0.1 pt, scans/s with
    set-up, one batched step under sync-debug "error"); the port's bench at
    an irregular loader's default (rimg)."""
    loader, frames = load_frames(CODEC_KW)
    n = len(frames)
    out = {"decoders": decode_check(frames[0], loader.projector(), dev)}
    agg = acceptance.champion_configs()["aggregated"]
    for name, over in CODEC_RUNS.items():
        cfg = dataclasses.replace(agg, **over)
        b1.assoc_gn.launches = 0
        b2.nn_argmin.launches = 0
        odom, rel, elapsed = run_sequence(cfg, loader, frames, dev)
        launches, nn = b1.assoc_gn.launches, b2.nn_argmin.launches
        expected = cfg.max_num_alignments * (n - 1)
        m = metrics(name, rel, loader, n)
        run = {"overrides": over, "launches": launches, "scans_per_s": n / elapsed, **m}
        run.update(_map_bar(f"aggregated_{name}", m, n / elapsed, card,
                            f" (with set-up); assoc_gn launches {launches} "
                            f"(expected {expected})"))
        if launches != expected or nn:
            raise AssertionError(f"codecs {name}: assoc_gn {launches}, nn_argmin {nn}")
        batch_sync_check(f"aggregated {name}", odom, frames[-cfg.batch_size:])
        out[f"aggregated_{name}"] = run

    cfg = dataclasses.replace(acceptance.champion_configs()["surfel"], upload_format="rimg")
    b1.assoc_gn.launches = 0
    b2.nn_argmin.launches = 0
    _, rel, elapsed = run_sequence(cfg, loader, frames, dev)
    launches, l1 = b2.nn_argmin.launches, b1.assoc_gn.launches
    expected = cfg.max_num_alignments * (n - 1)
    m = metrics("surfel_rimg", rel, loader, n)
    out["surfel_rimg"] = {"launches": launches, "scans_per_s": n / elapsed, **m}
    out["surfel_rimg"].update(_map_bar(
        "surfel_rimg", m, n / elapsed, card,
        f" (with set-up); nn_argmin launches {launches} (expected {expected})"))
    if launches != expected or l1:
        raise AssertionError(f"codecs surfel_rimg: nn_argmin {launches}, assoc_gn {l1}")

    # the port's bench on this loader (grid_regular False): its default is rimg
    s = bench.Settings(**BENCH_SMOKE["bench"])
    bframes = [f["numpy_pc"] for f in frames[:s.frames]]
    result, l1, l2 = _counted(bench.run, s, bframes, loader, "synthetic-jittered")
    _bench_line("bench", result, card)
    if loader.grid_regular or "upload=rimg," not in result["metric"]:
        raise AssertionError(f"codecs bench: {result['metric']}")
    stepped = s.warmup - 1 + s.repeats * len(bench.timed_frames(bframes, s)) + 5 * s.batch
    _expect("bench on jittered beams", "assoc_gn", l1, agg.max_num_alignments * stepped)
    _expect("bench on jittered beams", "nn_argmin", l2, 0)
    out["bench"] = {"line": result, "assoc_gn_launches": l1}
    return out


def _cli(name, module, argv, env=None) -> tuple:
    """`python -m module argv` in a process of its own, with no device
    override; fails unless it ran on the card.  Returns (stderr, seconds)."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", module, *argv], cwd=ROOT, capture_output=True,
                          text=True, timeout=900, env=env)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"{name} failed:\n{proc.stderr[-4000:]}")
    if "on cuda" not in proc.stderr:
        raise AssertionError(f"{name} did not run on the card")
    return proc.stderr, seconds


def _posenet_trainer(overrides, train_dir, frames=None):
    """The port's trainer as ``python -m pylidar_slam_tpu_torch.train``
    builds it; with `frames`, its dataset is those frames, loaded once."""
    from pylidar_slam_tpu_torch.train import build_trainer
    shutil.rmtree(train_dir, ignore_errors=True)
    trainer = build_trainer(compose(str(ROOT / "config"), "train_posenet",
                                    overrides + [f"train_dir={train_dir}"]))
    if frames is not None:
        seqs = ([frames], ["synth_00"])
        trainer.dataset_loader.sequences = lambda: (seqs, seqs, seqs, lambda x: x)
    return trainer


def deep_odometry_run(train_dir, frames, dev) -> dict:
    """The deep odometry from `train_dir` over the frames: the trajectory
    ATE (the JAX pin's metric) against the identity trajectory's, the
    per-frame relative ATE (a SLAM run's metrics.yaml ATE) and frames/s."""
    from pylidar_slam_tpu_torch.slam.odometry.posenet_odometry import (PoseNetOdometry,
                                                                       PoseNetOdometryConfig)
    odom = PoseNetOdometry(PoseNetOdometryConfig(train_dir=str(train_dir)), device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for f in frames:
        odom.process_next_frame({"numpy_pc": f["numpy_pc"]})
    rel = odom.get_relative_poses().astype(np.float64)
    seconds = time.perf_counter() - t0
    gt = np.stack([np.asarray(f["absolute_pose_gt"], np.float64) for f in frames])
    gt = np.linalg.inv(gt[0]) @ gt
    if rel.shape != gt.shape or not np.all(np.isfinite(rel)):
        raise AssertionError("deep odometry: the relative poses are not finite")
    traj = ev.compute_absolute_poses(rel)
    identity = np.broadcast_to(np.eye(4), gt.shape)
    gt_rel = ev.compute_relative_poses(gt)

    def ate(t):
        return float(np.linalg.norm(t[:, :3, 3] - gt[:, :3, 3], axis=1).mean())

    return {"ate_m": ate(traj), "identity_ate_m": ate(identity),
            "relative_ate_m": ev.compute_ate(rel, gt_rel)[0],
            "identity_relative_ate_m": ev.compute_ate(np.array(identity), gt_rel)[0],
            "frames_per_s": len(frames) / seconds, "odometry": odom}


def conv_flops(module, vmaps) -> tuple:
    """(forward FLOPs of every convolution, of the stem alone) of one
    forward over `vmaps`: 2 * Cin * kh * kw per output element."""
    counts = []

    def hook(conv, _, out):
        k = conv.weight
        counts.append(2 * out.numel() * k.shape[1] * k.shape[2] * k.shape[3])
    handles = [m.register_forward_hook(hook) for m in module.modules()
               if isinstance(m, torch.nn.Conv2d)]
    was_training = module.training
    module.eval()
    with torch.no_grad():
        module(vmaps)
    module.train(was_training)
    for h in handles:
        h.remove()
    return sum(counts), counts[0]


def _sync_checked(name, fn):
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log(f"[sync] {name}: one call under set_sync_debug_mode('error'), no host sync")
    return out


def _profile_calls(name, fn, flops, card, calls=3) -> dict:
    """Kernels and device ms per call (torch.profiler), wall ms per call
    (back-to-back calls ending in a sync), the idle share and the bound:
    `flops` float32 operations at 67 TFLOP/s."""
    prof = _device_kernels(fn, calls)
    kernels, device_ms = prof.kernels, prof.device_ms
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / calls
    bound_ms = flops / PEAK_F32_FLOPS * 1e3
    idle = None if device_ms is None else 1.0 - device_ms / wall_ms
    log(f"[posenet] {card}: {name}: {kernels} kernels per call, device {device_ms} ms, wall "
        f"{wall_ms:.2f} ms, device idle share {idle}; bound {bound_ms:.3f} ms ({flops} conv "
        f"FLOP at 67 TFLOP/s), {bound_ms / device_ms if device_ms else None} of the device time")
    return {"kernels": kernels, "device_ms": device_ms, "wall_ms": wall_ms, "idle_share": idle,
            "conv_flops": flops, "bound_ms": bound_ms}


def train_step_profile(trainer, frames, batch, card) -> dict:
    """One train step of `trainer` at `batch` under sync-debug "error",
    then three under the profiler and the wall clock."""
    batches = trainer._batches([frames], batch, True, np.random.default_rng(1))
    host = next(batches)
    batches.close()
    points, masks, gt = trainer._upload(*host)

    def step():
        return trainer._train_step(points, masks, gt)
    loss, _ = _sync_checked(f"posenet train step, batch {batch}", step)
    if not bool(torch.isfinite(loss)):
        raise AssertionError(f"posenet batch {batch}: the checked step's loss is not finite")
    vmaps = projection.build_vertex_map(points, trainer.proj, mask=masks).permute(0, 1, 4, 2, 3)
    fwd, stem = conv_flops(trainer.module, vmaps)
    # backward: the gradients of every conv's weights and inputs, but the
    # stem's input (the vertex maps) needs none
    out = _profile_calls(f"train step, batch {batch}", step, 3 * fwd - stem, card)
    out.update(batch=batch, steps_per_s=1e3 / out["wall_ms"],
               samples_per_s=batch * 1e3 / out["wall_ms"])
    log(f"[posenet] {card}: batch {batch}: {out['steps_per_s']:.2f} train steps/s, "
        f"{out['samples_per_s']:.2f} samples/s")
    return out


def posenet_phase(dev, card) -> dict:
    """The deep-learning track: training through the port's CLI, the deep
    odometry and the PoseNet initialization, repeatability, unsupervised
    steps and the step's profile."""
    b1.assoc_gn.launches = 0
    b2.nn_argmin.launches = 0
    out = {}
    _, frames = load_frames(dict(lidar_height=64, lidar_width=1024, num_frames=POSENET_FRAMES))
    jax_ratio = JAX_CPU_POSENET["identity_ate_m"] / JAX_CPU_POSENET["ate_m"]

    # 1. the learning check, through the CLI
    train_dir = ROOT / "build" / "chip_posenet"
    shutil.rmtree(train_dir, ignore_errors=True)
    argv = POSENET_TRAIN + [f"train_dir={train_dir}", "num_workers=8"]
    stderr, seconds = _cli("the posenet training CLI", "pylidar_slam_tpu_torch.train", argv)
    losses = re.findall(r"epoch (\d+) (train|eval) loss ([0-9.eE+-]+|nan|inf)", stderr)
    run = deep_odometry_run(train_dir, frames, dev)
    odom = run.pop("odometry")
    out["learning"] = {"argv": argv, "seconds": seconds, "epoch_losses": losses, **run}
    log(f"[posenet] {card}: python -m pylidar_slam_tpu_torch.train {' '.join(argv)}: "
        f"{seconds:.1f} s in all; deep odometry over the {POSENET_FRAMES} frames: ATE "
        f"{run['ate_m']:.4f} m against the identity's {run['identity_ate_m']:.4f} m "
        f"({run['identity_ate_m'] / run['ate_m']:.2f}x; bar {POSENET_RATIO:.0f}x); the JAX "
        f"package on the CPU: {JAX_CPU_POSENET['ate_m']:.4f} m against "
        f"{JAX_CPU_POSENET['identity_ate_m']:.4f} m ({jax_ratio:.2f}x); relative ATE "
        f"{run['relative_ate_m']:.4f} m (JAX CPU {JAX_CPU_POSENET['relative_ate_m']:.4f}); "
        f"{run['frames_per_s']:.2f} frames/s; epoch losses {losses}")
    if not run["ate_m"] < run["identity_ate_m"] / POSENET_RATIO:
        raise AssertionError(f"posenet: ATE {run['ate_m']} m does not beat the identity's "
                             f"{run['identity_ate_m']} m by {POSENET_RATIO}x")

    # 5. repeatability: the same recipe twice more in this process, on the
    # frames loaded once
    first = torch.load(train_dir / "checkpoint.ckp", map_location=dev, weights_only=True)["model"]
    runs = []
    for i in range(2):
        trainer = _posenet_trainer(POSENET_TRAIN, ROOT / "build" / f"chip_posenet_again{i}",
                                   frames)
        trainer.init()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train()
        torch.cuda.synchronize()
        runs.append((trainer, time.perf_counter() - t0))

    def max_diff(a: dict, b: dict) -> float:
        return max(float((v.float() - b[k].float()).abs().max()) for k, v in a.items())
    states = [t.module.state_dict() for t, _ in runs]
    in_process, vs_cli = max_diff(states[0], states[1]), max_diff(states[0], first)
    again = runs[0][0]
    run2 = deep_odometry_run(again.train_dir, frames, dev)
    run2.pop("odometry")
    out["repeat"] = {"seconds": [s for _, s in runs], "train_steps": again.train_iter,
                     "max_weight_diff_in_process": in_process, "max_weight_diff_vs_cli": vs_cli,
                     "bit_identical_in_process": in_process == 0.0, **run2}
    log(f"[posenet] {card}: the same recipe twice in this process on the frames loaded once: "
        f"{again.train_iter} steps and {POSENET_FRAMES - 1} eval windows per epoch in "
        f"{[round(s, 2) for _, s in runs]} s; the two runs' weights bit-identical: "
        f"{in_process == 0.0} (max difference {in_process:.3e}; against the CLI run's "
        f"{vs_cli:.3e}); the first one's ATE {run2['ate_m']:.4f} m "
        f"({run2['identity_ate_m'] / run2['ate_m']:.2f}x)")
    if not run2["ate_m"] < run2["identity_ate_m"] / POSENET_RATIO:
        raise AssertionError(f"posenet repeat: ATE {run2['ate_m']} m")

    # 2. unsupervised steps
    unsup = _posenet_trainer(POSENET_TRAIN + ["training/loss=unsupervised", "batch_size=4"],
                             ROOT / "build" / "chip_posenet_unsup", frames)
    unsup.init()
    step_losses, epoch = [], 0
    while len(step_losses) < UNSUPERVISED_STEPS:
        for batch in unsup._batches([frames], 4, True, np.random.default_rng(epoch)):
            step_losses.append(unsup._train_step(*unsup._upload(*batch))[0])
            if len(step_losses) == UNSUPERVISED_STEPS:
                break
        epoch += 1
    unsup_losses = torch.stack(step_losses).cpu().numpy().tolist()
    out["unsupervised"] = {"steps": len(unsup_losses), "losses": unsup_losses}
    log(f"[posenet] {card}: {len(unsup_losses)} unsupervised steps at batch 4: losses "
        f"{[round(x, 5) for x in unsup_losses]}")
    if not np.all(np.isfinite(unsup_losses)):
        raise AssertionError(f"posenet unsupervised: non-finite losses {unsup_losses}")

    # 3. through the SLAM CLI
    env = dict(os.environ, TRAIN_DIR=str(train_dir))
    base = ["dataset=synthetic", f"dataset.num_frames={POSENET_FRAMES}", "num_workers=8"]
    identity_rel = run["identity_relative_ate_m"]
    cli = {}
    for name, extra in (("deep_odometry", ["slam/odometry=deep_odometry"]),
                        ("posenet_init", ["slam/initialization=PoseNet"]),
                        ("cv_init", [])):
        log_dir = ROOT / "build" / f"chip_{name}"
        stderr, seconds = _cli(f"the {name} CLI run", "pylidar_slam_tpu_torch.run",
                               base + extra + [f"log_dir={log_dir}"], env)
        m = load_yaml_file(log_dir / "metrics.yaml")["synth_00"]
        rate = next((line for line in stderr.splitlines() if "scans/s" in line), "")
        cli[name] = {"argv": base + extra, "seconds": seconds, "metrics": m, "rate_line": rate}
        log(f"[posenet] {card}: python -m pylidar_slam_tpu_torch.run "
            f"{' '.join(base + extra)}: ATE {m['ATE']:.5f} m; {rate.split(': ', 1)[-1]}")
    deep_ate, pn_ate = cli["deep_odometry"]["metrics"]["ATE"], cli["posenet_init"]["metrics"]["ATE"]
    log(f"[posenet] {card}: bars: deep odometry ATE {deep_ate:.5f} m < the identity's "
        f"{identity_rel:.5f} m / {POSENET_RATIO:.0f} (JAX CPU "
        f"{JAX_CPU_POSENET['relative_ate_m']:.5f} m); PoseNet-initialized surfel ATE "
        f"{pn_ate:.5f} m < {CLI_ATE_M} m (CV-initialized "
        f"{cli['cv_init']['metrics']['ATE']:.5f} m)")
    if not deep_ate < identity_rel / POSENET_RATIO:
        raise AssertionError(f"posenet CLI deep odometry: ATE {deep_ate} m")
    if not pn_ate < CLI_ATE_M:
        raise AssertionError(f"posenet CLI PoseNet initialization: ATE {pn_ate} m")
    out["cli"] = cli

    # 4. a train step at batch 4 and 8 and a deep-odometry frame: no host
    # sync, then the profile
    batch4 = _posenet_trainer(POSENET_TRAIN + ["batch_size=4"],
                              ROOT / "build" / "chip_posenet_b4", frames)
    batch4.init()
    out["train_step"] = {f"batch{b}": train_step_profile(t, frames, b, card)
                         for b, t in ((4, batch4), (8, again))}
    inf = odom.inference
    prev, cur = inf.upload(frames[-2]["numpy_pc"]), inf.upload(frames[-1]["numpy_pc"])

    def frame():
        return inf(*prev, *cur)
    params, _ = _sync_checked("posenet deep-odometry frame", frame)
    if not bool(torch.isfinite(params).all()):
        raise AssertionError("posenet: the checked frame's pose is not finite")
    vmaps = projection.build_vertex_map(torch.stack([prev[0], cur[0]]), inf.proj,
                                        mask=torch.stack([prev[1], cur[1]]))
    fwd, _ = conv_flops(inf.prediction.module, vmaps.permute(0, 3, 1, 2)[None])
    out["odometry_frame"] = _profile_calls("deep-odometry frame", frame, fwd, card)
    out["odometry_frame"]["frames_per_s_sequence"] = run["frames_per_s"]
    _no_kernel_launches("posenet")
    return out


def b2_inputs(odom, next_frame):
    """The surfel map after the main path, and the next frame's grid-sampled
    targets moved to their prior in the map's anchor frame -- what the
    next step's first NN pass receives."""
    cfg = odom._map.config
    state = odom._map_state
    points, mask, _ = am.dequant_upload(*odom._read_points(dict(next_frame)),
                                        odom.projector)
    targets, _, _ = sm._grid_sample_fixed(points, mask, float(cfg.target_voxel_size),
                                          int(cfg.target_samples))
    prior = state.anchor_from_cur @ odom.last_rpose_device
    return se3.apply_transformation(targets, prior).contiguous(), state.points, state.valid


def _b2_case(name, queries, model, valid, expect=None) -> dict:
    idx, sq = b2.nn_argmin(queries, model, valid)
    idx2, sq2 = b2.nn_argmin(queries, model, valid)
    ridx, rsq = b2.nn_argmin_plain(queries, model, valid)
    torch.cuda.synchronize()
    idx, sq, idx2, sq2, ridx, rsq = (x.cpu().numpy() for x in (idx, sq, idx2, sq2,
                                                               ridx, rsq))
    if not (np.array_equal(idx, idx2) and np.array_equal(sq.view(np.int32),
                                                         sq2.view(np.int32))):
        raise AssertionError(f"B2 {name}: two kernel runs differ")
    if not np.array_equal(idx, ridx):
        bad = int(np.sum(idx != ridx))
        raise AssertionError(f"B2 {name}: {bad} indices differ from the plain version")
    finite = np.isfinite(rsq)
    if not np.array_equal(np.isfinite(sq), finite):
        raise AssertionError(f"B2 {name}: +inf entries differ from the plain version")
    ulps = np.abs(sq[finite].view(np.int32).astype(np.int64)
                  - rsq[finite].view(np.int32).astype(np.int64))
    max_ulps = int(ulps.max()) if ulps.size else 0
    abs_err = float(np.abs(sq[finite] - rsq[finite]).max()) if ulps.size else 0.0
    log(f"[compare B2] {name:28s} M={len(idx)} V={len(valid)} "
        f"identical indices, max {max_ulps} ulp, max_abs_err {abs_err:.3e} "
        f"(tolerance {NN_ULPS} ulp)")
    if max_ulps > NN_ULPS:
        raise AssertionError(f"B2 {name}: {max_ulps} ulp > {NN_ULPS}")
    if expect is not None:
        expect(idx, sq)
    return {"case": name, "m": len(idx), "v": len(valid), "max_ulps": max_ulps,
            "max_abs_err": abs_err}


def compare_b2_phase(queries, model, valid, lc_args) -> dict:
    dev = queries.device
    rows = [_b2_case("surfel map, next frame", queries, model, valid),
            _b2_case("loop-closure refine", *lc_args)]
    gen = torch.Generator(device="cpu").manual_seed(0)

    def cloud(n, scale=20.0):
        return (torch.randn(n, 3, generator=gen) * scale).to(dev)

    base = cloud(3000)
    dup = torch.cat([base, base, base])  # row i == i + 3000 == i + 6000
    dup_valid = torch.ones(9000, dtype=torch.bool, device=dev)
    dup_valid[:100] = False
    q = base[::3] + 0.01

    def lower_index_wins(idx, _):
        rows_ = np.arange(0, 3000, 3)
        if not np.array_equal(idx, np.where(rows_ < 100, rows_ + 3000, rows_)):
            raise AssertionError("B2 duplicates: the lower index did not win")

    def empty(idx, sq):
        if not (np.all(idx == 0) and np.all(np.isinf(sq))):
            raise AssertionError("B2 all-invalid map: expected index 0 and +inf")

    rows.append(_b2_case("duplicate rows", q, dup, dup_valid, lower_index_wins))
    rows.append(_b2_case("all-invalid map", q, dup, torch.zeros_like(dup_valid), empty))
    odd_v = cloud(12345)
    rows.append(_b2_case("odd sizes", cloud(1001), odd_v,
                         torch.rand(12345, generator=gen).to(dev) < 0.9))
    # exact ties across sub-tile, tile and split boundaries, empty sub-tiles
    # and tiles, M and V off the kernel's multiples
    for m, v in [(16384, 122880), (16384 + 77, 122880 - 100), (1000, 12345),
                 (513, 257), (1, 300)]:
        case = seams.nn_seam_case(m, v)

        def ties_keep_the_lower_index(idx, _, case=case):
            if not np.array_equal(idx[case.tie_rows], case.tie_index):
                raise AssertionError(f"B2 seams M={m} V={v}: a tie did not go to "
                                     "the lower index")
        rows.append(_b2_case("seams", *(torch.from_numpy(a).to(dev) for a in
                                        (case.queries, case.model, case.valid)),
                             ties_keep_the_lower_index))
    # the device flag: False skips the pass (index 0, +inf), True computes it
    skip = b2.nn_argmin(queries, model, valid,
                        active=torch.zeros((), dtype=torch.bool, device=dev))
    run = b2.nn_argmin(queries, model, valid,
                       active=torch.ones((), dtype=torch.bool, device=dev))
    full = b2.nn_argmin(queries, model, valid)
    if not (bool((skip[0] == 0).all()) and bool(torch.isinf(skip[1]).all())):
        raise AssertionError("B2 active=False did not skip the pass")
    if not (torch.equal(run[0], full[0]) and torch.equal(run[1], full[1])):
        raise AssertionError("B2 active=True differs from the unflagged call")
    log("[compare B2] active flag: False skips the pass, True equals the unflagged call")
    return {"cases": rows, "max_ulps": max(r["max_ulps"] for r in rows),
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "tolerance_ulps": NN_ULPS}


@dataclasses.dataclass
class DeviceProfile:
    """What torch.profiler saw of `calls` calls, per call."""
    kernels: Optional[float]  # device kernels; None when it saw none
    device_ms: Optional[float]  # their summed device time
    own_kernels: float  # of them, B1's and B2's (by name)
    own_launches: float  # B1 and B2 launches the wrappers counted meanwhile
    filler_lost: int  # of the window's opening filler kernels, the ones it dropped


OWN_KERNELS = ("assoc_gn", "nn_argmin", "nn_pack_model")
# Spin kernels (torch.cuda._sleep) that open every profiler window, left out
# of its counts.  Once other processes have used the card (the CLI runs, the
# parallel phase's ranks), the profiler drops the first kernel records of
# each window, torch's kernels and B1's and B2's alike, more with each such
# process (up to 43 by the times phase, which a 10-call B1 window of 10
# kernels cannot spare): the filler takes that loss.
PROFILE_FILLER = 256


def _device_kernels(fn, calls: int) -> DeviceProfile:
    """Kernels and summed device ms per call of `fn`'s device work by
    torch.profiler over `calls` calls; fails when the profiler saw fewer of
    B1's and B2's kernels than their wrappers launched, or none of the
    filler."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    launches = b1.assoc_gn.launches + b2.nn_argmin.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_FILLER):
            torch.cuda._sleep(1000)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    launches = b1.assoc_gn.launches + b2.nn_argmin.launches - launches
    device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = [e for e in device if "spin_kernel" not in e.name]
    lost = PROFILE_FILLER - (len(device) - len(kernels))
    own = sum(any(k in e.name for k in OWN_KERNELS) for e in kernels)
    if lost >= PROFILE_FILLER or own < launches:
        raise AssertionError(f"torch.profiler dropped {lost} of {PROFILE_FILLER} filler "
                             f"kernels and saw {own} kernels of B1 and B2 for {launches} "
                             f"launches")
    if not kernels:
        return DeviceProfile(None, None, 0.0, 0.0, lost)
    total_us = sum(getattr(e, "device_time_total", None) or e.cuda_time_total
                   for e in kernels)
    return DeviceProfile(len(kernels) / calls, total_us / 1000.0 / calls, own / calls,
                         launches / calls, lost)


def device_time(name, fn, calls) -> dict:
    """Device ms per call by graph replay; torch.profiler's kernel sums if
    the capture fails (the record names the method).  Also the kernels the
    call launches, as the profiler counts them."""
    prof = _device_kernels(fn, 10)
    try:
        runs, method = graph_ms(fn, calls), f"CUDA graph of {calls} calls, replayed"
    except RuntimeError as e:
        log(f"[times] {name}: graph capture failed ({e}); torch.profiler kernel sums")
        if prof.device_ms is None:
            raise AssertionError(f"{name}: no device time: capture failed and the "
                                 "profiler saw no kernels") from e
        runs, method = [prof.device_ms], "torch.profiler kernel sums over 10 calls"
    return {"runs_ms": runs, "ms": float(np.mean(runs)), "method": method,
            "kernels_per_call": prof.kernels, "profiler_ms": prof.device_ms,
            "launches_per_call": prof.own_launches, "filler_lost": prof.filler_lost}


def _turns(name, fns, timer) -> dict:
    """`timer` over the callables `fns` (a dict of two) in the order
    a, b, b, a; mean per name."""
    (a, fa), (b, fb) = fns.items()
    runs = {a: [], b: []}
    for which, fn in [(a, fa), (b, fb), (b, fb), (a, fa)]:
        runs[which].append(timer(fn))
    return {k: {"runs": v, "mean": float(np.mean(v))} for k, v in runs.items()}


def b1_bound(timg, xyz, nrm, valid, sums, wr=1, wc=2) -> dict:
    """The least time of one B1 call on these inputs: each input byte read
    once and the 30 sums written once, against 3.35 TB/s; 8 float32
    operations per candidate distance of a valid target pixel and ~90 per
    match (residual, Jacobian, weight, the 30 products and sums), against
    67 TFLOP/s."""
    nbytes = sum(t.numel() * t.element_size() for t in (timg, xyz, nrm, valid)) + 4 * b1.NUM_OUT
    targets = int((timg.abs().amax(dim=-1) > 0).sum())
    flops = targets * (2 * wr + 1) * (2 * wc + 1) * 8 + int(sums[28]) * 90
    return _bound(nbytes, flops)


def b2_bound(queries, model, valid) -> dict:
    """The least time of one B2 pass on these inputs: NN_PAIR_FLOPS per
    (query, valid model point) pair against 67 TFLOP/s (invalid rows need
    no arithmetic), and each input byte read once and the outputs written
    once against 3.35 TB/s."""
    m, v = queries.shape[0], model.shape[0]
    nbytes = 12 * m + 12 * v + v + 8 * m
    flops = NN_PAIR_FLOPS * m * int(valid.sum())
    return _bound(nbytes, flops)


def _bound(nbytes, flops) -> dict:
    by_bytes, by_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_F32_FLOPS * 1e3
    return {"bytes": nbytes, "flops": flops, "bytes_ms": by_bytes, "ops_ms": by_ops,
            "bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def kernel_times(name, kernel, plain, library, bound, card, shape) -> dict:
    """Device time (graph replay) and wall time per call of the kernel, its
    plain version's wall time and the library yardstick's."""
    dev_t = device_time(name, kernel, GRAPH_CALLS[name])
    out = {"device": dev_t}
    wall_calls = {"assoc_gn": {"kernel": TIMED_CALLS, "plain": TIMED_CALLS},
                  "nn_argmin": B2_TIMED_CALLS}[name]
    for _ in range(2):  # warm-up
        kernel(), plain()
    wall = _turns(name, {"plain": plain, "kernel": kernel},
                  lambda fn: time_calls(fn, wall_calls["kernel" if fn is kernel else "plain"]))
    out["wall_ms"], out["plain_ms"] = wall["kernel"]["mean"], wall["plain"]["mean"]
    out["wall_runs_ms"], out["plain_runs_ms"] = wall["kernel"]["runs"], wall["plain"]["runs"]
    out["library_ms"] = None
    if library is not None:
        library()
        out["library_ms"] = time_calls(library, 3)
        torch.cuda.empty_cache()
    out.update(bound)
    out["roofline_share"] = bound["bound_ms"] / dev_t["ms"]
    lib_txt = ("none" if out["library_ms"] is None
               else f"{1000 * out['library_ms']:.1f} us")
    log(f"[times] {card}: {name} {shape}: device {1000 * dev_t['ms']:.2f} us/call "
        f"(runs {[round(1000 * x, 2) for x in dev_t['runs_ms']]}, {dev_t['method']}; "
        f"profiler: {dev_t['kernels_per_call']} kernels/call for "
        f"{dev_t['launches_per_call']} launches, {dev_t['profiler_ms']} ms/call, "
        f"{dev_t['filler_lost']} filler kernels dropped); wall {1000 * out['wall_ms']:.1f} us/call "
        f"(runs {[round(1000 * x, 1) for x in out['wall_runs_ms']]}); plain "
        f"{1000 * out['plain_ms']:.1f} us/call; library {lib_txt}; bound "
        f"{1000 * bound['bound_ms']:.3f} us by {bound['bound_by']} ({bound['bytes']} B, "
        f"{bound['flops']} FLOP), roofline share {out['roofline_share']:.3f}")
    return out


def time_sequence(name, loader, frames, dev, card) -> dict:
    rates = []
    for _ in range(SEQ_REPEATS):
        _, _, elapsed = run_sequence(name, loader, frames, dev)
        rates.append(len(frames) / elapsed)
    log(f"[times] {card}: {name} scans/s over the {len(frames)}-frame sequence "
        f"(host encode + upload + device, warm): median {np.median(rates):.2f}, "
        f"runs {[round(r, 2) for r in rates]}")
    return {"scans_per_s": rates, "scans_per_s_median": float(np.median(rates))}


B1_PARAMS = (1, 2, 0.6, "geman_mcclure", 0.4, 0.0)  # window 1x2, the main path's


def times_phase(b1_inputs, b2_args, lc_args, loader, frames, dev, card) -> dict:
    b1_args = (*b1_inputs, *B1_PARAMS)
    sums = b1.assoc_gn(*b1_args)
    out = {"assoc_gn": kernel_times(
        "assoc_gn", lambda: b1.assoc_gn(*b1_args), lambda: b1.assoc_gn_plain(*b1_args),
        None, b1_bound(*b1_inputs, sums), card, "64x1024 window 1x2")}
    out["aggregated"] = time_sequence("aggregated", loader, frames, dev, card)
    m, v = b2_args[0].shape[0], b2_args[1].shape[0]
    queries, model, valid = b2_args
    masked = torch.where(valid[:, None], model, torch.full_like(model, math.inf))

    def library():  # the yardstick: one PyTorch call, never used by the port
        return torch.cdist(queries, masked,
                           compute_mode="donot_use_mm_for_euclid_dist").min(dim=1)

    out["nn_argmin"] = kernel_times(
        "nn_argmin", lambda: b2.nn_argmin(*b2_args), lambda: b2.nn_argmin_plain(*b2_args),
        library, b2_bound(*b2_args), card, f"M={m} V={v}")
    lq, lm, lv = lc_args
    lmasked = torch.where(lv[:, None], lm, torch.full_like(lm, math.inf))

    def lc_library():
        return torch.cdist(lq, lmasked, compute_mode="donot_use_mm_for_euclid_dist").min(dim=1)

    out["nn_argmin_loop_closure"] = kernel_times(
        "nn_argmin", lambda: b2.nn_argmin(*lc_args), lambda: b2.nn_argmin_plain(*lc_args),
        lc_library, b2_bound(*lc_args), card,
        f"M={lq.shape[0]} V={lm.shape[0]} (loop-closure refine)")
    out["surfel"] = time_sequence("surfel", loader, frames, dev, card)
    return out


def compare_phase(others, b1_inputs, b2_args, card) -> list:
    """B1 and B2 of each other checkout against this one's on the same
    inputs, by device time per call in the order other / this / this /
    other, each run in a process of its own that loads its checkout's own
    wrappers and kernels; fails unless both give the same results."""
    work = ROOT / "build" / "compare"
    work.mkdir(parents=True, exist_ok=True)
    inputs = work / "inputs.pt"
    torch.save({"b1": [t.cpu() for t in b1_inputs], "b1_params": list(B1_PARAMS),
                "b2": [t.cpu() for t in b2_args], "calls": GRAPH_CALLS}, inputs)
    rows = []
    for other in others:
        runs, results = {"other": [], "this": []}, {}
        for i, (which, root) in enumerate([("other", other), ("this", ROOT),
                                           ("this", ROOT), ("other", other)]):
            out = work / f"run{i}.pt"
            proc = subprocess.run([sys.executable, "-P", device_timing.__file__, str(root),
                                   str(inputs), str(out)], capture_output=True, text=True,
                                  timeout=900)
            if proc.returncode != 0:
                raise RuntimeError(f"timing {root} failed:\n{proc.stderr[-4000:]}")
            results[which] = torch.load(out)
            runs[which].append(results[which]["device_ms"])
        o, t = results["other"], results["this"]
        scaled = b1.sum_errors(t["sums"].numpy(), o["sums"].numpy())[1]
        if float(o["sums"][28]) != float(t["sums"][28]) or scaled > SUM_TOL:
            raise AssertionError(f"B1 of {other} differs: scaled error {scaled}")
        if not (torch.equal(o["idx"], t["idx"]) and torch.equal(o["sq"], t["sq"])):
            raise AssertionError(f"B2 of {other} differs from this checkout's")
        row = {"other": str(other), "b1_bit_identical": torch.equal(o["sums"], t["sums"]),
               "b1_scaled_err": scaled}
        for name in GRAPH_CALLS:
            row[name] = {which: [float(np.mean(r[name])) for r in rs]
                         for which, rs in runs.items()}
            row[name + "_replays"] = {which: [r[name] for r in rs] for which, rs in runs.items()}
            log(f"[compare] {card}: {name} device us per call ({GRAPH_CALLS[name]} calls "
                f"per graph), in turns other/this/this/other: {other} "
                f"{[round(1000 * x, 3) for x in row[name]['other']]}, this checkout "
                f"{[round(1000 * x, 3) for x in row[name]['this']]}")
        log(f"[compare] {other}: B1 sums agree (scaled error {scaled:.3e}, bit-identical "
            f"{row['b1_bit_identical']}), B2 indices and distances identical")
        rows.append(row)
    return rows


# ----------------------------------------------------------------------------
# parallel: point-sharded surfel odometry, dp / tp train steps, parallel jobs
# ----------------------------------------------------------------------------

# The sharded champion against the unsharded one: the partial normal
# equations add in another order, and the champion's knn normals carry such
# last-bit differences forward (tests/test_parallel.py's bar for knn normals
# under sharding, on the relative-pose matrices).
SHARD_POSE_ATOL = 3e-2
SHARDS = 2
TRAIN_BATCH = 8
# The parallel train step against the one-process step (sgd, so an update
# is a gradient): tests/test_torch_training.py's one-step bars, each weight's
# update gap also allowed 1e-5 of the whole model's update norm (a gradient
# that sums to near zero, as a BatchNorm bias's can, keeps the rounding of
# its terms).
TRAIN_LOSS_RTOL, TRAIN_UPDATE_TOL, TRAIN_STATS_TOL = 1e-4, 1e-3, 1e-4
TRAIN_UPDATE_FLOOR = 1e-5
TRAIN_LR = 1e-2
MULTIRUN_FRAMES = 40
MULTIRUN_ARGV = ["-m", "dataset=synthetic", f"dataset.num_frames={MULTIRUN_FRAMES}",
                 "slam/odometry/local_map=aggregated", "dataset.speed=1.0,1.3",
                 "num_workers=8"]


def _parallel_trainer(dev, proj, train_dir, **kw):
    """Supervised PoseResNet-18 (learned exp weights, sgd) at 64x1024 and
    batch 8, from the port's seeded initialisation."""
    from pylidar_slam_tpu_torch.training import loss_modules, trainer
    from pylidar_slam_tpu_torch.training.prediction_modules import PredictionConfig

    class _Loader:
        def projector(self):
            return proj

    cfg = trainer.ATrainerConfig(train_dir=str(train_dir), batch_size=TRAIN_BATCH,
                                 with_tensorboard=False, optimizer_type="sgd",
                                 optimizer_learning_rate=TRAIN_LR, device=str(dev), **kw)
    tr = trainer.PoseNetTrainer(cfg, PredictionConfig(),
                                loss_modules.SupervisedLossConfig(with_exp_weights=True),
                                _Loader())
    tr._init_state()
    return tr


def _train_step_result(tr, batch, keep_state: bool) -> dict:
    """One step on the global batch: loss, wall ms, the whole weights after
    it (or their digest)."""
    import hashlib
    args = [torch.from_numpy(a).to(tr.device) for a in batch]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, _ = tr._train_step(*args)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    state, _ = tr._whole_state()
    state = {k: v.detach().cpu().numpy().copy() for k, v in state.items()}
    digest = hashlib.sha256(b"".join(state[k].tobytes() for k in sorted(state))).hexdigest()
    return {"loss": float(loss), "ms": ms, "digest": digest,
            "exp_s": tr.exp_s.detach().cpu().numpy(), "split": sorted(tr._split or {}),
            "state": state if keep_state else None}


def _parallel_rank(rank, world, device, frames_file, batch_file, work):
    """One rank of the parallel phase, on `device` (every rank on cuda:0) in
    a gloo group: the surfel champion with its targets sharded over the
    ranks (B2's launches and the all-reduces counted over the run), then a
    dp=2 and a tp=2 train step."""
    import torch.distributed as dist
    dev = torch.device(device)
    data = np.load(frames_file)
    frames = [{"numpy_pc": data[f"pc{i}"]} for i in range(len(data.files))]
    loader = SyntheticDatasetLoader(SyntheticConfig(**acceptance.SEQ_KW))
    reduces = [0]
    real = dist.all_reduce

    def counted(*args, **kwargs):
        reduces[0] += 1
        return real(*args, **kwargs)

    dist.all_reduce = counted
    cfg = dataclasses.replace(acceptance.champion_configs()["surfel"], shard_points=world)
    b2.nn_argmin.launches = 0
    _, rel, elapsed = run_sequence(cfg, loader, frames, dev)
    out = {"relative": rel, "seconds": elapsed, "launches": b2.nn_argmin.launches,
           "all_reduces": reduces[0]}
    dist.all_reduce = real
    batch = tuple(np.load(batch_file)[k] for k in ("points", "masks", "gt"))
    for layout, kw in (("dp", dict(data_parallel=True)), ("tp", dict(tensor_parallel=world))):
        tr = _parallel_trainer(dev, loader.projector(), Path(work) / f"{layout}{rank}", **kw)
        out[layout] = _train_step_result(tr, batch, keep_state=rank == 0)
        del tr
    return out


def _train_batch(frames) -> dict:
    """Windows (i, i+1), i < 8, of the sequence, padded as the trainer pads."""
    cap = 131072
    points = np.zeros((TRAIN_BATCH, 2, cap, 3), np.float32)
    masks = np.zeros((TRAIN_BATCH, 2, cap), bool)
    gt = np.zeros((TRAIN_BATCH, 2, 4, 4), np.float32)
    for i in range(TRAIN_BATCH):
        for s in range(2):
            pc = np.asarray(frames[i + s]["numpy_pc"], np.float32)[:cap, :3]
            points[i, s, :len(pc)] = pc
            masks[i, s, :len(pc)] = True
            gt[i, s] = frames[i + s]["absolute_pose_gt"]
    return {"points": points, "masks": masks, "gt": gt}


def _check_train_step(name, ours, ref, before):
    if not math.isclose(ours["loss"], ref["loss"], rel_tol=TRAIN_LOSS_RTOL):
        raise AssertionError(f"{name}: loss {ours['loss']} against {ref['loss']}")
    worst = {"update": 0.0, "stats": 0.0, "of_bound": 0.0, "weight": ""}
    whole = math.sqrt(sum(float(np.sum((r - before[k]) ** 2))
                          for k, r in ref["state"].items() if "running" not in k))
    for key, r in ref["state"].items():
        o = ours["state"][key]
        if "running" in key:
            err = float(np.abs(o - r).max() / max(np.abs(r).max(), 1e-12))
            worst["stats"] = max(worst["stats"], err)
            if err > TRAIN_STATS_TOL:
                raise AssertionError(f"{name}: {key} {err:.3e} of its scale")
            continue
        d_ref = r - before[key]
        err = float(np.linalg.norm(o - before[key] - d_ref))
        bound = (TRAIN_UPDATE_TOL * np.linalg.norm(d_ref) + TRAIN_UPDATE_FLOOR * whole
                 + np.linalg.norm(2 * np.spacing(r)))
        worst["update"] = max(worst["update"], err / max(float(np.linalg.norm(d_ref)), 1e-30))
        if err / bound > worst["of_bound"]:
            worst["of_bound"], worst["weight"] = float(err / bound), key
        if err > bound:
            raise AssertionError(f"{name}: {key} update off by {err:.3e} (bound {bound:.3e})")
    return worst


def _multirun(parallel_jobs: int) -> dict:
    from pylidar_slam_tpu_torch import run as trun
    log_dir = ROOT / "build" / f"chip_multirun_{parallel_jobs}"
    shutil.rmtree(log_dir, ignore_errors=True)
    b1.assoc_gn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = trun.main(MULTIRUN_ARGV + [f"parallel_jobs={parallel_jobs}", f"log_dir={log_dir}"])
    torch.cuda.synchronize()
    return {"seconds": time.perf_counter() - t0, "launches": b1.assoc_gn.launches,
            "dir": log_dir, "metrics": results}


def multirun_check(card) -> dict:
    """`-m ... parallel_jobs=2` (two job threads on the card, each on its own
    stream, B1 in both at once) against the same two jobs one after the
    other: each job's poses equal, B1's launches the two jobs' sum."""
    from pylidar_slam_tpu_torch.utils.io import read_poses_from_disk
    alone = _multirun(1)
    both = _multirun(2)
    trips = compose(str(ROOT / "config"), "slam", MULTIRUN_ARGV[1:4])["slam"]["odometry"][
        "max_num_alignments"]
    expected = 2 * int(trips) * (MULTIRUN_FRAMES - 1)
    same = []
    for job in range(2):
        if not (both["dir"] / str(job) / "metrics.yaml").exists():
            raise AssertionError(f"multirun: job {job} wrote no metrics.yaml")
        same.append(bool(np.array_equal(
            read_poses_from_disk(str(both["dir"] / str(job) / "synth_00.poses.txt")),
            read_poses_from_disk(str(alone["dir"] / str(job) / "synth_00.poses.txt")))))
    log(f"[parallel] {card}: multirun -m {' '.join(MULTIRUN_ARGV[1:])}: parallel_jobs=2 "
        f"{both['seconds']:.1f} s against parallel_jobs=1 {alone['seconds']:.1f} s (wall, "
        f"both jobs); assoc_gn launches {both['launches']} and {alone['launches']} (expected "
        f"{expected}); each job's poses equal to the job run alone: {same}")
    if not all(same):
        raise AssertionError(f"multirun: a parallel job's poses differ from the job alone: {same}")
    if both["launches"] != expected or alone["launches"] != expected:
        raise AssertionError(f"multirun: assoc_gn launches {both['launches']} / "
                             f"{alone['launches']}, expected {expected}")
    return {"parallel_s": both["seconds"], "sequential_s": alone["seconds"],
            "launches": both["launches"], "expected_launches": expected,
            "same_poses": same, "metrics": both["metrics"]}


def sharded_b2(b2_args, card) -> dict:
    """B2 at a rank's shard: the first M/S of the next frame's targets
    against the whole map, against its plain version, and timed."""
    queries, model, valid = b2_args
    block = queries[:queries.shape[0] // SHARDS].contiguous()
    case = _b2_case(f"sharded surfel block M/{SHARDS}", block, model, valid)
    masked = torch.where(valid[:, None], model, torch.full_like(model, math.inf))
    times = kernel_times(
        "nn_argmin", lambda: b2.nn_argmin(block, model, valid),
        lambda: b2.nn_argmin_plain(block, model, valid),
        lambda: torch.cdist(block, masked,
                            compute_mode="donot_use_mm_for_euclid_dist").min(dim=1),
        b2_bound(block, model, valid), card, f"M={block.shape[0]} V={model.shape[0]} "
        f"(a rank's shard of the surfel targets)")
    return {"compare": case, "times": times}


def parallel_phase(loader, frames, dev, card, surfel_odom=None) -> dict:
    """Multi-rank execution on the card (see the module's docstring)."""
    work = ROOT / "build" / "chip_parallel"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    if surfel_odom is None:  # run alone: the unsharded champion first
        surfel_odom, _ = surfel_phase(loader, frames, dev)
    unsharded = surfel_odom.get_relative_poses()
    np.savez(work / "frames.npz", **{f"pc{i}": np.asarray(f["numpy_pc"], np.float32)
                                     for i, f in enumerate(frames)})
    np.savez(work / "batch.npz", **_train_batch(frames))
    from pylidar_slam_tpu_torch.parallel.launch import run_ranks
    t0 = time.perf_counter()
    ranks = run_ranks(_parallel_rank, SHARDS, work, str(dev), str(work / "frames.npz"),
                      str(work / "batch.npz"), str(work))
    spawn_s = time.perf_counter() - t0
    out = {"spawn_s": spawn_s}

    # the sharded surfel champion
    n = len(frames)
    expected = acceptance.champion_configs()["surfel"].max_num_alignments * (n - 1)
    rel = ranks[0]["relative"]
    identical = all(np.array_equal(r["relative"], rel) for r in ranks[1:])
    gap = float(np.abs(rel - unsharded).max())
    launches = [r["launches"] for r in ranks]
    reduces = [r["all_reduces"] for r in ranks]
    m = score("sharded surfel", rel, loader, n)
    log(f"[parallel] {card}: surfel champion, shard_points={SHARDS} ({SHARDS} ranks on "
        f"cuda:0, gloo): {n} frames in {[round(r['seconds'], 2) for r in ranks]} s "
        f"({[round(n / r['seconds'], 2) for r in ranks]} scans/s); nn_argmin launches per "
        f"rank {launches} (expected {expected}); all-reduces per rank {reduces} "
        f"({reduces[0] / (n - 1):.2f} per frame, each a host round trip under gloo: the "
        f"path's host syncs per frame); ranks bit-identical {identical}; max gap to the "
        f"unsharded run {gap:.3e} (bar {SHARD_POSE_ATOL})")
    if not identical:
        raise AssertionError("sharded surfel: the ranks' trajectories differ")
    if set(launches) != {expected}:
        raise AssertionError(f"sharded surfel: nn_argmin launches {launches}, expected {expected}")
    if gap > SHARD_POSE_ATOL:
        raise AssertionError(f"sharded surfel: {gap} from the unsharded trajectory")
    out["sharded_surfel"] = {"frames": n, "launches": launches[0], "all_reduces": reduces,
                             "all_reduces_per_frame": reduces[0] / (n - 1),
                             "seconds": [r["seconds"] for r in ranks],
                             "scans_per_s": [n / r["seconds"] for r in ranks],
                             "gap_to_unsharded": gap, **m}

    # dp=2 and tp=2 train steps against the one-process step
    batch = tuple(np.load(work / "batch.npz")[k] for k in ("points", "masks", "gt"))
    ref_tr = _parallel_trainer(dev, loader.projector(), work / "one")
    before = {k: v.detach().cpu().numpy().copy()
              for k, v in ref_tr.module.state_dict().items()}
    ref = _train_step_result(ref_tr, batch, keep_state=True)
    del ref_tr
    for layout in ("dp", "tp"):
        res = [r[layout] for r in ranks]
        if len({r["digest"] for r in res}) != 1 or len({r["loss"] for r in res}) != 1:
            raise AssertionError(f"{layout}=2: the ranks' weights differ")
        worst = _check_train_step(f"{layout}=2", res[0], ref, before)
        log(f"[parallel] {card}: PoseResNet-18 train step at 64x1024, batch {TRAIN_BATCH}, "
            f"{layout}=2: loss {res[0]['loss']:.6f} against the one-process step's "
            f"{ref['loss']:.6f}; worst update gap {worst['update']:.3e} of its norm, "
            f"BatchNorm statistics {worst['stats']:.3e} (bars {TRAIN_LOSS_RTOL} / "
            f"{TRAIN_UPDATE_TOL} + {TRAIN_UPDATE_FLOOR} of the model's update / "
            f"{TRAIN_STATS_TOL}; closest to its bound: {worst['weight']} at "
            f"{worst['of_bound']:.3f}); {len(res[0]['split'])} split weights; first step "
            f"(set-up included) {res[0]['ms']:.1f} ms wall against {ref['ms']:.1f} ms")
        out[f"train_{layout}"] = {"loss": res[0]["loss"], "ref_loss": ref["loss"],
                                  "worst": worst, "ms": [r["ms"] for r in res],
                                  "ref_ms": ref["ms"], "split_weights": len(res[0]["split"])}
    out["multirun"] = multirun_check(card)
    return out


# ----------------------------------------------------------------------------
# viz: save_map, the map cloud on the card, replay, viz_debug
# ----------------------------------------------------------------------------

VIZ_DEBUG_FRAMES = 3
REPLAY_WINDOW = 40


def _map_cloud_check(dev, card) -> dict:
    """aggregate_map_cloud over the KITTI sequence's scans (~17 M points)
    with the datasets run's poses (ground truth when that run is absent),
    on the card and by numpy, which must agree exactly."""
    from pylidar_slam_tpu_torch.dataset.kitti_dataset import KITTIOdometrySequence
    from pylidar_slam_tpu_torch.utils.io import read_poses_from_disk
    from pylidar_slam_tpu_torch.viz import viz3d
    seq = KITTIOdometrySequence(str(fab.kitti_sequence(DATASETS_DIR)), fab.KITTI_SEQUENCE)
    items = [seq[i] for i in range(len(seq))]
    clouds = [it["numpy_pc"] for it in items]
    run_poses = ROOT / "build" / "chip_kitti" / f"{fab.KITTI_SEQUENCE}.poses.txt"
    if run_poses.exists():
        rel, source = ev.compute_relative_poses(read_poses_from_disk(str(run_poses))), "the run"
    else:
        gt = np.stack([np.asarray(it["absolute_pose_gt"], np.float64) for it in items])
        rel, source = ev.compute_relative_poses(np.linalg.inv(gt[0]) @ gt), "ground truth"
    points = sum(len(c) for c in clouds)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ours = viz3d.aggregate_map_cloud(clouds, rel, device=dev)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = viz3d.aggregate_map_cloud_numpy(clouds, rel)
    numpy_s = time.perf_counter() - t0
    equal = bool(np.array_equal(ours, ref))
    log(f"[viz] {card}: aggregate_map_cloud over {len(clouds)} KITTI scans ({points} points, "
        f"poses of {source}, voxel 0.2 m): {len(ours)} points; the voxel dedupe on the card "
        f"{card_s:.2f} s, numpy (np.unique on the host) {numpy_s:.2f} s, both with the "
        f"host's pose chaining; equal exactly: {equal}")
    if not equal:
        raise AssertionError("aggregate_map_cloud on the card differs from numpy's")
    return {"scans": len(clouds), "points": points, "kept": len(ours), "card_s": card_s,
            "numpy_s": numpy_s, "poses": source}


def viz_phase(dev, card) -> dict:
    """The map's files, the map cloud on the card, replay and viz_debug."""
    import importlib.util

    from pylidar_slam_tpu_torch import replay as treplay
    from pylidar_slam_tpu_torch import run as trun
    from pylidar_slam_tpu_torch.utils.io import read_poses_from_disk
    from pylidar_slam_tpu_torch.viz import viz3d
    out = {}
    log_dir = ROOT / "build" / "chip_viz"
    shutil.rmtree(log_dir, ignore_errors=True)
    argv = CLI_OVERRIDES + [f"log_dir={log_dir}", "num_workers=8", "save_map=true"]
    t0 = time.perf_counter()
    trun.main(argv)
    run_s = time.perf_counter() - t0
    cloud = viz3d.read_ply(str(log_dir / "synth_00_map.ply"))
    html = (log_dir / "synth_00_map.html").read_text()
    n_html = json.loads(re.search(r"const META = (\{.*?\});", html).group(1))["n"]
    views = sorted(p.name for p in log_dir.glob("synth_00_map_*.png"))
    with_mpl = importlib.util.find_spec("matplotlib") is not None
    log(f"[viz] {card}: python -m pylidar_slam_tpu_torch.run {' '.join(argv)}: {run_s:.1f} s; "
        f"synth_00_map.ply {len(cloud)} points, synth_00_map.html {n_html} points, PNG views "
        f"{views} (matplotlib {'present' if with_mpl else 'absent: views skipped'})")
    if not (len(cloud) > 10000 and n_html == len(cloud) and np.all(np.isfinite(cloud))):
        raise AssertionError(f"save_map: {len(cloud)} PLY points, {n_html} in the HTML file")
    if bool(views) != with_mpl:
        raise AssertionError(f"save_map: views {views} with matplotlib {with_mpl}")
    out["save_map"] = {"seconds": run_s, "points": len(cloud), "views": views}

    # replay: the whole window (bit for bit the run's poses), then 40 frames
    lc_state = log_dir / "loop_closure_synth_00.npz"
    args = ["--root_dir", str(log_dir), "--sequence", "synth_00",
            "--html", str(log_dir / "replay.html")]
    if lc_state.exists():
        args += ["--lc_state", str(lc_state)]
    t0 = time.perf_counter()
    relative = treplay.main(args)
    replay_s = time.perf_counter() - t0
    same = bool(np.array_equal(ev.compute_absolute_poses(relative),
                               read_poses_from_disk(str(log_dir / "synth_00.poses.txt"))))
    window = treplay.main(["--root_dir", str(log_dir), "--sequence", "synth_00",
                           "--num_frames", str(REPLAY_WINDOW)])
    rows = np.loadtxt(log_dir / "replay_synth_00.poses.txt").shape[0]
    log(f"[viz] {card}: replay of the whole window ({len(relative)} frames, {replay_s:.1f} s, "
        f"--lc_state {lc_state.exists()}): poses equal to the run's bit for bit: {same}; "
        f"--num_frames {REPLAY_WINDOW}: {len(window)} poses, {rows} rows written")
    if not same:
        raise AssertionError("replay: the poses differ from the run's")
    if not (len(window) == rows == REPLAY_WINDOW):
        raise AssertionError(f"replay --num_frames {REPLAY_WINDOW}: {len(window)} poses")
    out["replay"] = {"seconds": replay_s, "frames": len(relative), "bit_identical": same,
                     "window": len(window)}
    out["map_cloud"] = _map_cloud_check(dev, card)

    # viz_debug: the aggregated champion over 3 frames writes its PNGs
    loader, frames = load_frames(dict(acceptance.SEQ_KW, num_frames=VIZ_DEBUG_FRAMES))
    debug_dir = ROOT / "build" / "chip_viz_debug"
    shutil.rmtree(debug_dir, ignore_errors=True)
    debug_dir.mkdir(parents=True)
    cwd = os.getcwd()
    os.chdir(debug_dir)  # viz_debug writes under ./viz_debug
    try:
        cfg = dataclasses.replace(acceptance.champion_configs()["aggregated"], batch_size=1,
                                  viz_debug=True)
        run_sequence(cfg, loader, frames, dev)
    finally:
        os.chdir(cwd)
    pngs = sorted(p.name for p in (debug_dir / "viz_debug").glob("*.png"))
    log(f"[viz] viz_debug over {VIZ_DEBUG_FRAMES} frames: {pngs}")
    if len(pngs) != VIZ_DEBUG_FRAMES - 1:
        raise AssertionError(f"viz_debug wrote {pngs}")
    out["viz_debug"] = pngs
    return out


def _bench_line(name, result, card) -> None:
    """Prints a bench's JSON line on a line of its own; fails unless it has
    the JAX script's keys and finite positive rates."""
    log(f"[bench] {card}: {name}:")
    log(json.dumps(result))
    if list(result) != BENCH_KEYS[name]:
        raise AssertionError(f"{name}: keys {list(result)}, expected {BENCH_KEYS[name]}")
    rates = [result["value"]] + list(result.get("rates") or result.get("runs"))
    if not all(math.isfinite(r) and r > 0 for r in rates):
        raise AssertionError(f"{name}: rates {rates}")


def _counted(fn, *args):
    """(fn's result, B1 launches, B2 launches), the counts set to 0 just
    before the call."""
    b1.assoc_gn.launches = 0
    b2.nn_argmin.launches = 0
    out = fn(*args)
    return out, b1.assoc_gn.launches, b2.nn_argmin.launches


def _expect(name, kernel, launches, expected):
    log(f"[bench] {name}: {kernel} launches {launches} (expected {expected})")
    if launches != expected:
        raise AssertionError(f"{name}: {kernel} launched {launches} times, expected {expected}")


def bench_phase(loader, frames, dev, card, full=False) -> dict:
    """The port's three benches through their module functions: once each at
    the BENCH_SMOKE sizes, or (`full`, ``--only bench``) at their own
    defaults with the kdtree and voxel maps too.  B1's launches in the
    aggregated bench and B2's in ``bench_surfel`` with SF_NN=exact are held
    to the count the frames processed give."""
    out = {}
    iters = acceptance.champion_configs()["aggregated"].max_num_alignments
    if full:
        s = bench.Settings()
        bframes, bloader, source = bench.load_frames(s.frames)
    else:
        s = bench.Settings(**BENCH_SMOKE["bench"])
        bframes = [f["numpy_pc"] for f in frames[:s.frames]]
        bloader, source = loader, "synthetic-kitti64x1024"
    for bench_map in ("aggregated", "kdtree", "voxel") if full else ("aggregated",):
        result, l1, l2 = _counted(bench.run, dataclasses.replace(s, bench_map=bench_map),
                                  bframes, bloader, source)
        _bench_line("bench", result, card)
        if "probe_error" in result["stages"]:
            raise AssertionError(f"bench {bench_map}: {result['stages']['probe_error']}")
        # frames stepped: the warm-up's after the first, the repeats', and
        # the stage probe's 5 batched steps
        stepped = s.warmup - 1 + s.repeats * len(bench.timed_frames(bframes, s)) + 5 * s.batch
        _expect(f"bench {bench_map}", "assoc_gn", l1,
                iters * stepped if bench_map == "aggregated" else 0)
        _expect(f"bench {bench_map}", "nn_argmin", l2, 0)
        out[f"bench_{bench_map}"] = {"line": result, "assoc_gn_launches": l1,
                                     "nn_argmin_launches": l2}

    env = {"SF_NN": "exact", **({} if full else BENCH_SMOKE["bench_surfel"])}
    n = int(env.get("SF_FRAMES", "140"))
    gt = ev.compute_absolute_poses(loader.get_ground_truth("synth_00")[:n])
    result, l1, l2 = _counted(bench_surfel.run, [f["numpy_pc"] for f in frames[:n]], gt,
                              loader.projector(), env)
    _bench_line("bench_surfel", result, card)
    passes = 1 + int(env.get("SF_REPEATS", "3"))
    sf_iters = bench_surfel.build_config(env).max_num_alignments
    _expect("bench_surfel SF_NN=exact", "nn_argmin", l2, passes * (n - 1) * sf_iters)
    _expect("bench_surfel SF_NN=exact", "assoc_gn", l1, 0)
    out["bench_surfel"] = {"line": result, "nn_argmin_launches": l2}

    env = {} if full else dict(BENCH_SMOKE["bench_pipeline"])
    seq, proj = bench_pipeline.load(env)
    result, l1, l2 = _counted(bench_pipeline.run, seq, proj, env)
    _bench_line("bench_pipeline", result, card)
    _expect("bench_pipeline", "assoc_gn", l1,
            result["repeats"] * (len(seq) - 1) * iters)
    log(f"[bench] bench_pipeline: nn_argmin launches {l2} (the loop closure's warm-up at "
        "each init and its refine)")
    out["bench_pipeline"] = {"line": result, "assoc_gn_launches": l1, "nn_argmin_launches": l2}
    return out


def only_bench(dev, card) -> dict:
    """`--only bench`: the three benches at their own defaults."""
    loader, frames, _ = load_sequence()
    return bench_phase(loader, frames, dev, card, full=True)


def only_parallel(dev, card) -> dict:
    """`--only parallel`: the unsharded surfel champion, the parallel phase
    and B2 at a rank's shard."""
    loader, frames, next_frame = load_sequence()
    odom, _ = surfel_phase(loader, frames, dev)
    out = parallel_phase(loader, frames, dev, card, odom)
    out["sharded_b2"] = sharded_b2(b2_inputs(odom, next_frame), card)
    return out


# ----------------------------------------------------------------------------
# graft: the driver's entry points (graft_entry.entry, dryrun_multichip)
# ----------------------------------------------------------------------------

# B1 against its plain version over the three steps: the same 30 sums in
# another order (within SUM_TOL of their scale), so the poses within the
# port's bar against JAX's on the CPU (tests/test_torch_graft.py).
GRAFT_POSE_TOL = 1e-5
# The sharded odometry against one rank: tests/test_parallel.py's bar for
# exact NN (ROADMAP.md §C7).
GRAFT_SHARD_TOL = 5e-4
# The edge-sharded pose graph against the whole edge set in one process, in
# float64: tests/test_torch_graft.py's bar against JAX; and the least move
# of the perturbed chain that shows the optimizer worked.
GRAFT_POSE_GRAPH_TOL = 1e-8
GRAFT_POSE_GRAPH_MOVED = 1e-2
GRAFT_RANKS = 4  # the default run's dry run: dp 2 x tp 2 by factorize_two(4)
GRAFT_RANKS_ONLY = 8  # `--only graft`: the driver's MULTICHIP size


def _graft_chain(step, args) -> list:
    """``graft_entry.step_chain``: the example step (an empty map), the
    keyframe that fills it and the matching step; each one's inputs,
    relative pose and diagnostics."""
    return [{"inputs": inputs, "rpose": res[2], "diag": res[4]}
            for inputs, res in graft_entry.step_chain(step, args)]


def _graft_nn(res, dev) -> dict:
    """B2 against its plain version on every B2 call the dry run's ranks
    recorded (each rank's block of the targets against the map)."""
    cases = []
    for r, rank in enumerate(res):
        if len(rank["nn_calls"]) != rank["b2_launches"]:
            raise AssertionError(f"graft: rank {r} recorded {len(rank['nn_calls'])} B2 "
                                 f"calls for {rank['b2_launches']} launches")
        for q, m, v in rank["nn_calls"]:
            cases.append(_b2_case(f"graft dry run, rank {r}",
                                  *(torch.from_numpy(a).to(dev) for a in (q, m, v))))
    return {"cases": cases, "max_abs_err": max(c["max_abs_err"] for c in cases)}


def graft_phase(dev, card, ranks=GRAFT_RANKS) -> dict:
    """The port's driver entry points on the card: ``entry()``'s step on
    kernel B1 against the same steps on B1's plain version, B1's launches
    counted, one step under sync-debug "error", the matching step's kernels,
    device and wall ms; then ``dryrun_multichip(ranks)`` (gloo ranks on
    cuda:0) on a perturbed pose chain: every rank's results equal, the pose
    graph within GRAFT_POSE_GRAPH_TOL of the whole edge set in one process,
    the sharded odometry within GRAFT_SHARD_TOL of a one-rank run of its
    config, B2's launches per rank, B2 against its plain version on each
    rank's recorded inputs."""
    step, args = graft_entry.entry()  # no device: the card
    if args[2].device.type != "cuda":
        raise AssertionError(f"graft: entry() put its arguments on {args[2].device}")
    per_step = 6  # the entry's max_num_alignments: fixed trips, one B1 launch each
    chain, l1, _ = _counted(_graft_chain, step, args)
    torch.cuda.synchronize()
    _expect("graft entry", "assoc_gn", l1, per_step * len(chain))
    real = am.assoc_gn
    am.assoc_gn = b1.assoc_gn_plain
    try:
        plain = _graft_chain(step, args)
    finally:
        am.assoc_gn = real
    gap = max(float((a["rpose"] - b["rpose"]).abs().max()) for a, b in zip(chain, plain))
    diags = [[float(x) for x in c["diag"]] for c in chain]
    log(f"[graft] {card}: entry() on cuda, 3 steps (empty map, keyframe, matching): "
        f"(loss, iterations, matches, inserted) {diags}; assoc_gn launches {l1}; poses "
        f"against B1's plain version within {gap:.3e} (bar {GRAFT_POSE_TOL})")
    if gap > GRAFT_POSE_TOL:
        raise AssertionError(f"graft: entry() steps {gap} from B1's plain version")
    if diags[2][2] < 1000 or diags[1][3] != 1.0:
        raise AssertionError(f"graft: the keyframe did not fill the map for the matching "
                             f"step: {diags}")
    matching = chain[2]["inputs"]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step(*matching)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log("[sync] graft entry: one step under set_sync_debug_mode('error'), no host sync")
    prof = _device_kernels(lambda: step(*matching), 3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        step(*matching)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / 3
    log(f"[step] graft entry (matching step, 32x256, 8,192 points): {prof.kernels} kernels "
        f"per step ({prof.own_kernels} of B1 for {prof.own_launches} launches), device "
        f"{prof.device_ms} ms, wall {wall_ms:.2f} ms")
    out = {"entry": {"diags": diags, "assoc_gn_launches": l1, "plain_gap": gap,
                     "kernels_per_step": prof.kernels, "device_ms_per_step": prof.device_ms,
                     "wall_ms_per_step": wall_ms}}

    work = ROOT / "build" / "chip_graft"
    shutil.rmtree(work, ignore_errors=True)
    inputs = graft_entry.dryrun_inputs(ranks)
    # the JAX file's chain fits its edges exactly, so its optimum is its
    # start; moved off them, the ranks' all-reduced sums decide the result
    graph = inputs["pose_graph"] = graft_entry.perturbed_pose_graph(inputs["pose_graph"])
    t0 = time.perf_counter()
    res = graft_entry.dryrun_multichip(ranks, workdir=work, inputs=inputs, record_nn=True)
    dry_s = time.perf_counter() - t0
    first = res[0]
    same = all(r["gn"][1] == first["gn"][1]
               and np.array_equal(r["gn"][0], first["gn"][0])
               and np.array_equal(r["pose_graph"], first["pose_graph"])
               and np.array_equal(r["odometry"], first["odometry"])
               and all((r[p]["loss"], r[p]["digest"]) == (first[p]["loss"], first[p]["digest"])
                       for p in ("dp", "tp"))
               for r in res[1:])
    alone = graft_entry.odometry_poses(dev, ranks, inputs["odometry"], 0)
    odo_gap = float(np.abs(first["odometry"] - alone).max())
    whole = optimize_pose_graph(
        torch.from_numpy(graph["poses"]).to(dev),
        PoseGraph(**{k: torch.from_numpy(graph[k]).to(dev) for k in PoseGraph._fields}),
        num_iters=2, cg_iters=8).cpu().numpy()
    pg_gap = float(np.abs(first["pose_graph"] - whole).max())
    pg_moved = float(np.abs(whole - graph["poses"]).max())
    launches = [r["b2_launches"] for r in res]
    # B2 runs on the GN trips that search (every `reassoc_every`-th of the 3
    # fixed trips; the dry run keeps the default) of each registered frame
    every = ICPFrameToModelConfig().reassoc_every
    expected = len(range(0, 3, every)) * (len(inputs["odometry"]) - 1)
    log(f"[graft] {card}: dryrun_multichip({ranks}) on cuda:0 ({ranks} gloo ranks, dp "
        f"{ranks} / dp {ranks // 2} x tp 2): {dry_s:.1f} s wall; dp loss "
        f"{first['dp']['loss']:.6f}, tp loss {first['tp']['loss']:.6f}, sharded GN dx "
        f"{np.round(first['gn'][0], 6).tolist()} loss {first['gn'][1]:.6f}, pose graph "
        f"x {np.round(first['pose_graph'][:, 0, 3], 6).tolist()} (moved {pg_moved:.3e}, "
        f"against the whole edge set in one process within {pg_gap:.3e}, bar "
        f"{GRAFT_POSE_GRAPH_TOL}); every rank equal: {same}; sharded odometry against one rank within {odo_gap:.3e} (bar {GRAFT_SHARD_TOL}); "
        f"nn_argmin launches per rank {launches} (expected {expected})")
    if not same:
        raise AssertionError("graft: the dry run's ranks differ")
    if odo_gap > GRAFT_SHARD_TOL:
        raise AssertionError(f"graft: sharded odometry {odo_gap} from one rank")
    if pg_gap > GRAFT_POSE_GRAPH_TOL or pg_moved < GRAFT_POSE_GRAPH_MOVED:
        raise AssertionError(f"graft: edge-sharded pose graph {pg_gap} from the whole edge "
                             f"set, moved {pg_moved}")
    if set(launches) != {expected}:
        raise AssertionError(f"graft: nn_argmin launches {launches}, expected {expected}")
    if not all(np.isfinite(first[p]["loss"]) for p in ("dp", "tp")):
        raise AssertionError("graft: a train step's loss is not finite")
    nn = _graft_nn(res, dev)
    out["dryrun"] = {"ranks": ranks, "seconds": dry_s, "identical": same,
                     "odometry_gap": odo_gap, "pose_graph_gap": pg_gap,
                     "pose_graph_moved": pg_moved, "nn_argmin": nn,
                     "nn_argmin_launches": launches,
                     "losses": {p: first[p]["loss"] for p in ("dp", "tp")},
                     "gn": [first["gn"][0].tolist(), first["gn"][1]]}
    return out


def only_graft(dev, card) -> dict:
    """`--only graft`: the graft phase with the dry run at the driver's
    MULTICHIP size."""
    return graft_phase(dev, card, GRAFT_RANKS_ONLY)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    parser = argparse.ArgumentParser(description="Card-side smoke run of the port.")
    parser.add_argument("--compare", type=Path, action="append", default=[],
                        help="another checkout of the package (e.g. an earlier commit "
                             "unpacked by git archive) whose kernels are timed against "
                             "this one's; repeatable")
    parser.add_argument("--only", choices=["posenet", "datasets", "parallel", "viz", "bench",
                                           "graft", "codecs", "slam"],
                        help="build, then run this phase alone (a probe: no result line)")
    args = parser.parse_args()
    dev = torch.device("cuda", 0)
    card = card_line()
    name = torch.cuda.get_device_name(0)
    log(f"[device] {card} | torch {torch.__version__} CUDA {torch.version.cuda}")

    seconds = {}

    def phase(label, fn, *fn_args):
        t0 = time.perf_counter()
        out = fn(*fn_args)
        seconds[label] = time.perf_counter() - t0
        log(f"[time] {label}: {seconds[label]:.1f} s")
        return out

    build = phase("build", build_phase)
    if args.only:
        result = phase(args.only, {"posenet": posenet_phase, "datasets": datasets_phase,
                                   "parallel": only_parallel, "viz": viz_phase,
                                   "bench": only_bench, "graft": only_graft,
                                   "codecs": codecs_phase, "slam": only_slam}[args.only],
                       dev, card)
        (ROOT / "build" / f"chip_smoke_{args.only}.json").write_text(json.dumps(
            {"card": card, args.only: result, "seconds": seconds}, indent=1, default=str))
        log(f"[{args.only}] {card}: probe passed (no result line: the full run prints it)")
        return 0
    loader, frames, next_frame = phase("setup", load_sequence)
    b1_in = kernel_inputs(loader, frames, dev)
    compare_b1 = phase("compare B1", compare_b1_phase, b1_in)
    aggregated = phase("aggregated", aggregated_phase, loader, frames, dev)
    odom, surfel = phase("surfel", surfel_phase, loader, frames, dev)
    b2_in = b2_inputs(odom, next_frame)
    slam, lc_inputs = phase("slam", slam_phase, dev, card)
    lc_args = lc_b2_args(lc_inputs)
    compare_b2 = phase("compare B2", compare_b2_phase, *b2_in, lc_args)
    cli = phase("cli", cli_phase, card)
    projective_run = phase("projective", projective_phase, dev, card)
    voxel = phase("voxel", voxel_phase, loader, frames, dev, card)
    codecs = phase("codecs", codecs_phase, dev, card)
    highway = phase("highway", highway_phase, dev, card)
    rs_loader, rs_frames = phase("setup rolling shutter", load_frames,
                                 acceptance.ROLLING_SHUTTER_KW)
    ct_icp = phase("ct_icp", ct_icp_phase, rs_loader, rs_frames, dev, card)
    profiles = phase("profiles", profiles_phase, rs_loader, rs_frames, dev)
    datasets = phase("datasets", datasets_phase, dev, card)
    parallel = phase("parallel", parallel_phase, loader, frames, dev, card, odom)
    sharded = phase("sharded B2", sharded_b2, b2_in, card)
    viz = phase("viz", viz_phase, dev, card)
    posenet = phase("posenet", posenet_phase, dev, card)
    benches = phase("bench", bench_phase, loader, frames, dev, card)
    graft = phase("graft", graft_phase, dev, card)
    times = phase("times", times_phase, b1_in, b2_in, lc_args, loader, frames, dev, card)
    compare = phase("compare", compare_phase, args.compare, b1_in, b2_in, card)

    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "build": build, "compare_b1": compare_b1,
         "compare_b2": compare_b2, "aggregated": aggregated, "surfel": surfel,
         "highway": highway, "ct_icp": ct_icp, "profiles": profiles, "slam": slam,
         "cli": cli, "projective": projective_run, "voxel": voxel, "codecs": codecs,
         "posenet": posenet,
         "datasets": datasets, "parallel": parallel, "sharded_b2": sharded, "viz": viz,
         "bench": benches, "graft": graft, "times": times,
         "compare": compare, "seconds": seconds},
        indent=1, default=str))
    b1_paths = {"aggregated": aggregated["launches"], "highway": highway["launches"],
                "ct_icp": ct_icp["elastic"]["launches"],
                **{name: run["launches"] for name, run in profiles.items()},
                "kitti": datasets["runs"]["kitti"]["launches"],
                "ct_icp_files": datasets["runs"]["ct_icp_files"]["launches"],
                "multirun": parallel["multirun"]["launches"],
                "graft_entry": graft["entry"]["assoc_gn_launches"],
                **{f"codecs_{name}": codecs[f"aggregated_{name}"]["launches"]
                   for name in CODEC_RUNS}}

    kernels = []
    for kname, run, result in (("assoc_gn", aggregated, compare_b1),
                               ("nn_argmin", surfel, compare_b2)):
        t = times[kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": build["sources"][kname],
            "replaces": REPLACES[kname], "launches": run["launches"],
            "max_abs_err": result["max_abs_err"], "ms": t["wall_ms"],
            "device_ms": t["device"]["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "roofline_share": t["roofline_share"], "library_ms": t["library_ms"]})
        if "active_launches" in run:
            kernels[-1]["active_launches"] = run["active_launches"]
        if kname == "assoc_gn":
            kernels[-1]["launches_by_path"] = b1_paths
    lc_t = times["nn_argmin_loop_closure"]
    kernels[1]["launches_by_path"] = {"surfel": surfel["launches"],
                                      "loop_closure": slam["batch1"]["b2_launches"],
                                      "sharded_surfel": parallel["sharded_surfel"]["launches"],
                                      "graft_dryrun_per_rank": graft["dryrun"]["nn_argmin_launches"],
                                      "codecs_surfel_rimg": codecs["surfel_rimg"]["launches"]}
    sh_t = sharded["times"]
    kernels[1]["sharded_surfel_shape"] = {
        "m": sharded["compare"]["m"], "v": sharded["compare"]["v"], "ms": sh_t["wall_ms"],
        "device_ms": sh_t["device"]["ms"], "plain_ms": sh_t["plain_ms"],
        "bound_ms": sh_t["bound_ms"], "bound_by": sh_t["bound_by"],
        "roofline_share": sh_t["roofline_share"], "library_ms": sh_t["library_ms"],
        "max_abs_err": sharded["compare"]["max_abs_err"]}
    gr_nn = graft["dryrun"]["nn_argmin"]
    kernels[1]["graft_dryrun_shape"] = {"m": gr_nn["cases"][0]["m"], "v": gr_nn["cases"][0]["v"],
                                        "max_abs_err": gr_nn["max_abs_err"]}
    kernels[1]["active_launches_by_path"] = {
        "surfel": surfel["active_launches"], "loop_closure": slam["batch1"]["b2_active_launches"]}
    kernels[1]["loop_closure_shape"] = {
        "m": int(lc_args[0].shape[0]), "v": int(lc_args[1].shape[0]), "ms": lc_t["wall_ms"],
        "device_ms": lc_t["device"]["ms"], "plain_ms": lc_t["plain_ms"],
        "bound_ms": lc_t["bound_ms"], "bound_by": lc_t["bound_by"],
        "roofline_share": lc_t["roofline_share"], "library_ms": lc_t["library_ms"]}
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
