#!/usr/bin/env python3
"""Card-side smoke run of the PyTorch port (``pylidar_slam_tpu_torch``).

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device: require CUDA; print the card's name and power limit;
2. build: the CUDA kernel(s) and the native host encoder from the sources;
3. kernel vs plain: kernel B1 (``assoc_gn``) against its plain PyTorch
   version at the main path's shapes (64x1024, window 1x2), on a model image
   from frame 0 and a target from frame 1 of the acceptance sequence, for
   all 8 robust schemes with the plane gate off and on;
4. main path: ``ICPFrameToModel`` with the aggregated champion over the
   140-frame acceptance sequence (64x1024, rimg8, batch 12, EI bootstrap),
   counting the kernel's launches and scoring tr_err / ATE against ground
   truth;
5. times: kernel vs plain per call (CUDA events), and the port's
   steady-state scans/s over the sequence.

The last line of stdout is the JSON result; the line before it holds the
kernels' numbers.  Details go to build/chip_smoke.json (git-ignored).
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from pylidar_slam_tpu_torch.dataset.synthetic import (SyntheticConfig,
                                                      SyntheticDatasetLoader)
from pylidar_slam_tpu_torch.eval import acceptance
from pylidar_slam_tpu_torch.eval import eval_odometry as ev
from pylidar_slam_tpu_torch.ops import projection, se3
from pylidar_slam_tpu_torch.ops.kernels import assoc_gn as b1
from pylidar_slam_tpu_torch.ops.kernels.cuda_build import CSRC
from pylidar_slam_tpu_torch.slam.odometry import aggregated_map as am
from pylidar_slam_tpu_torch.slam.odometry.icp_odometry import ICPFrameToModel
from pylidar_slam_tpu_torch.utils import native

ROOT = Path(__file__).resolve().parent
SCHEMES = ["least_square", "default", "huber", "exp", "neighborhood",
           "geman_mcclure", "square_geman_mcclure", "cauchy"]
PLANE_GATES = [0.0, 0.1]
# float32 sums of 65536 terms in two different tree orders: each output is
# held to SUM_TOL times its Cauchy-Schwarz scale (assoc_gn.sum_errors); the
# match count exactly.
SUM_TOL = 2e-5
TIMED_CALLS = 200
SEQ_REPEATS = 3


def log(msg: str):
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def build_phase() -> dict:
    t0 = time.perf_counter()
    b1.build()
    t1 = time.perf_counter()
    if native.get_lib() is None:
        raise RuntimeError("native host encoder did not build")
    t2 = time.perf_counter()
    log(f"[build] assoc_gn.cu {t1 - t0:.2f} s, native encoder {t2 - t1:.2f} s")
    for report in sorted((ROOT / "build" / "kernels").glob("*.log")):
        log(f"[build] {report.name}:\n{report.read_text().strip()}")
    return {"kernel_build_s": t1 - t0, "native_build_s": t2 - t1,
            "source": str((CSRC / "assoc_gn.cu").relative_to(ROOT))}


def load_sequence():
    loader = SyntheticDatasetLoader(SyntheticConfig(**acceptance.SEQ_KW))
    ds = loader.sequences()[0][0][0]
    t0 = time.perf_counter()
    frames = [ds[i] for i in range(len(ds))]
    log(f"[setup] {len(frames)} frames generated on the host in "
        f"{time.perf_counter() - t0:.1f} s")
    return loader, frames


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


def compare_phase(inputs) -> dict:
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
            log(f"[compare] {scheme:21s} plane_gate={plane:.1f} matches="
                f"{int(ref[28])} max_abs_err={abs_err:.3e} "
                f"max_scaled_err={scaled:.3e} (tolerance {SUM_TOL:.0e})")
            if scaled > SUM_TOL:
                raise AssertionError(f"{scheme} plane={plane}: kernel vs plain "
                                     f"scaled error {scaled} > {SUM_TOL}")
            worst_abs = max(worst_abs, abs_err)
            worst_scaled = max(worst_scaled, scaled)
    return {"cases": rows, "max_abs_err": worst_abs,
            "max_scaled_err": worst_scaled, "tolerance": SUM_TOL}


def run_sequence(loader, frames, dev):
    cfg = acceptance.champion_configs()["aggregated"]
    odom = ICPFrameToModel(cfg, projector=loader.projector(), device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for f in frames:
        odom.process_next_frame(dict(f))
    odom.finish()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    return odom.get_relative_poses(), elapsed


def main_path_phase(loader, frames, dev) -> dict:
    n = len(frames)
    expected = acceptance.champion_configs()["aggregated"].max_num_alignments * (n - 1)
    b1.assoc_gn.launches = 0
    rel, elapsed = run_sequence(loader, frames, dev)
    launches = b1.assoc_gn.launches
    log(f"[main] {n} frames in {elapsed:.2f} s (first run, includes set-up); "
        f"assoc_gn launches {launches} (expected {expected})")
    if launches != expected:
        raise AssertionError(f"assoc_gn launched {launches} times, expected {expected}")
    if rel.shape != (n, 4, 4) or not np.all(np.isfinite(rel)):
        raise AssertionError("relative poses are not finite (n, 4, 4)")
    gt_rel = loader.get_ground_truth("synth_00")[:n]
    ate, ate_std = ev.compute_ate(rel, gt_rel)
    tr_err, rot_err, _ = ev.compute_kitti_metrics(ev.compute_absolute_poses(rel),
                                                  ev.compute_absolute_poses(gt_rel))
    ref = np.load(ROOT / "tests" / "fixtures" / "reference_e2e.npz")
    log(f"[main] tr_err {100 * tr_err:.4f}% rot_err {rot_err:.3e} rad/m "
        f"ATE {ate:.5f} m (std {ate_std:.5f}); reference bars: kd-tree "
        f"{100 * float(ref['kdtree_tr_err']):.4f}%, projective "
        f"{100 * float(ref['projective_tr_err']):.4f}% (asserted in a later PR)")
    if not ate < 0.05:
        raise AssertionError(f"ATE {ate} m: tracking lost")
    return {"frames": n, "launches": launches, "tr_err": tr_err,
            "rot_err": rot_err, "ate_m": ate, "ate_std_m": ate_std,
            "first_run_s": elapsed,
            "ref_kdtree_tr_err": float(ref["kdtree_tr_err"]),
            "ref_projective_tr_err": float(ref["projective_tr_err"])}


def time_calls(fn, calls: int) -> float:
    """Mean ms per call over `calls` back-to-back calls, CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def times_phase(inputs, loader, frames, dev, card: str) -> dict:
    args = (*inputs, 1, 2, 0.6, "geman_mcclure", 0.4, 0.0)
    kernel = lambda: b1.assoc_gn(*args)
    plain = lambda: b1.assoc_gn_plain(*args)
    for _ in range(20):  # warm-up
        kernel(), plain()
    order = [("plain", plain), ("kernel", kernel), ("kernel", kernel), ("plain", plain)]
    runs = {"kernel": [], "plain": []}
    for name, fn in order:
        runs[name].append(time_calls(fn, TIMED_CALLS))
    k_ms, p_ms = float(np.mean(runs["kernel"])), float(np.mean(runs["plain"]))
    log(f"[times] {card}: assoc_gn kernel {1000 * k_ms:.1f} us/call "
        f"(runs {[round(1000 * x, 1) for x in runs['kernel']]}), plain "
        f"{1000 * p_ms:.1f} us/call (runs {[round(1000 * x, 1) for x in runs['plain']]}), "
        f"64x1024, {TIMED_CALLS} calls per run, order plain/kernel/kernel/plain")
    rates = []
    for _ in range(SEQ_REPEATS):
        _, elapsed = run_sequence(loader, frames, dev)
        rates.append(len(frames) / elapsed)
    log(f"[times] {card}: port scans/s over the {len(frames)}-frame sequence "
        f"(host encode + upload + device, warm): median {np.median(rates):.2f}, "
        f"runs {[round(r, 2) for r in rates]}")
    return {"kernel_ms": k_ms, "plain_ms": p_ms, "kernel_runs_ms": runs["kernel"],
            "plain_runs_ms": runs["plain"], "scans_per_s": rates,
            "scans_per_s_median": float(np.median(rates))}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = card_line()
    name = torch.cuda.get_device_name(0)
    log(f"[device] {card} | torch {torch.__version__} CUDA {torch.version.cuda}")

    build = build_phase()
    loader, frames = load_sequence()
    inputs = kernel_inputs(loader, frames, dev)
    compare = compare_phase(inputs)
    main_run = main_path_phase(loader, frames, dev)
    times = times_phase(inputs, loader, frames, dev, card)

    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "build": build, "compare": compare, "main": main_run,
         "times": times}, indent=1))

    print(json.dumps({"kernels": [{
        "name": "assoc_gn", "route": "cuda", "source": build["source"],
        "replaces": "pylidar_slam_tpu/ops/pallas/assoc_gn_kernel.py:169",
        "launches": main_run["launches"], "max_abs_err": compare["max_abs_err"],
        "ms": times["kernel_ms"], "plain_ms": times["plain_ms"]}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
