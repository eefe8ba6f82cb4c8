"""Records both champions' trajectories over the acceptance sequence into
``tests/fixtures/torch_e2e.npz`` (the port of ``scripts/record_e2e_ours.py``).

    python -m pylidar_slam_tpu_torch.eval.record_e2e [--out PATH] [--expect-same OLD]
    python -m pylidar_slam_tpu_torch.eval.record_e2e --margin-seeds 1 2 3

Run it on the card after any change on a champion path: the fixture carries
``acceptance.code_stamp()``, and a tier-1 test fails while the stamp of the
sources differs from the recorded one.  The fixture has the keys of
``ours_e2e.npz`` (``stamp``, ``seq_params``, ``gt_absolute``,
``{aggregated,surfel}_trajectory``, ``{aggregated,surfel}_tr_err``) and
``card``, the card's name and power limit as ``nvidia-smi`` prints them.

``--expect-same OLD`` is for a change that leaves the champions' paths as
they compute: every array but ``stamp`` and ``card`` must equal OLD's bit
for bit, or nothing is written and the command fails.

``--margin-seeds`` records the champions over the same sequence drawn from
other ``SyntheticConfig`` seeds and prints one JSON line per seed with each
champion's tr_err and its margin under the round's bar; it writes no file.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time
from pathlib import Path

import numpy as np

from pylidar_slam_tpu_torch.eval import acceptance
from pylidar_slam_tpu_torch.eval.eval_odometry import (compute_absolute_poses,
                                                        compute_kitti_metrics)

FIXTURES = Path(__file__).resolve().parents[2] / "tests" / "fixtures"
FIXTURE = FIXTURES / "torch_e2e.npz"


def kdtree_bar() -> float:
    """The round's bar: the reference's kd-tree tr_err on the acceptance
    sequence (``reference_e2e.npz``) + 0.1 pt."""
    return float(np.load(FIXTURES / "reference_e2e.npz")["kdtree_tr_err"]) + 0.001


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` prints them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def acceptance_sequence(seed=None, num_frames=None) -> tuple:
    """(frames, float64 ground truth relative to frame 0, config) of the
    acceptance sequence, drawn from `seed` (the config's default seed when
    None), or of its first `num_frames` frames."""
    from pylidar_slam_tpu_torch.bench import generate
    from pylidar_slam_tpu_torch.dataset.synthetic import (SyntheticConfig,
                                                          SyntheticSequence)
    kw = dict(acceptance.SEQ_KW)
    if seed is not None:
        kw["seed"] = int(seed)
    if num_frames is not None:
        kw["num_frames"] = int(num_frames)
    cfg = SyntheticConfig(**kw)
    seq = SyntheticSequence(cfg, "synth_00", seed=cfg.seed)
    items = generate(seq, cfg.num_frames)
    gt = np.stack([np.asarray(f["absolute_pose_gt"], np.float64) for f in items])
    return [f["numpy_pc"] for f in items], np.linalg.inv(gt[0]) @ gt, cfg


def run_champion(name: str, frames: list, device=None) -> np.ndarray:
    """The champion's (T, 4, 4) float64 relative poses over `frames`, each
    frame fed the previous frame's pose as its prior (the batched path
    chains it on the device instead)."""
    odom = acceptance.build_odometry(name, device=device)
    last = None
    for pc in frames:
        d = {"numpy_pc": pc} if last is None else {"numpy_pc": pc, "init_rpose": last}
        odom.process_next_frame(d)
        last = d.get("odometry_pose")
    odom.finish()  # the final partial batch
    return odom.get_relative_poses()


def record(seed=None, device=None) -> dict:
    """The fixture's arrays for the sequence drawn from `seed`."""
    from pylidar_slam_tpu_torch.slam.odometry_runner import resolve_device
    device = resolve_device(device)
    frames, gt, cfg = acceptance_sequence(seed)
    out = {"stamp": acceptance.stamp_array(acceptance.code_stamp()),
           "seq_params": np.array([cfg.lidar_height, cfg.lidar_width, cfg.num_frames,
                                   cfg.num_walls, cfg.num_pillars, cfg.seed]),
           "gt_absolute": gt,
           "card": np.array(card_line() if device.type == "cuda" else "cpu")}
    for name in sorted(acceptance.champion_configs()):
        t0 = time.perf_counter()
        traj = compute_absolute_poses(run_champion(name, frames, device))
        tr_err, rot_err, _ = compute_kitti_metrics(traj, gt)
        if tr_err is None:
            raise ValueError(f"{name}: the sequence is too short for tr_err (100 m)")
        print(f"{name}: tr_err={tr_err} rot_err={rot_err} "
              f"({time.perf_counter() - t0:.0f} s)", flush=True)
        out[f"{name}_trajectory"] = traj
        out[f"{name}_tr_err"] = np.array(tr_err)
    return out


def compare_fixtures(new: dict, old: dict) -> dict:
    """{key: equal bit for bit} for every array of either fixture but the
    stamp and the card (a key in only one of them is unequal)."""
    keys = (set(new) | set(old)) - {"stamp", "card"}
    return {k: k in new and k in old and np.array_equal(np.asarray(new[k]), np.asarray(old[k]))
            for k in sorted(keys)}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", type=Path, default=FIXTURE)
    parser.add_argument("--device", default=None,
                        help="cpu to run on the CPU (hours for the surfel champion)")
    parser.add_argument("--margin-seeds", type=int, nargs="+", default=None)
    parser.add_argument("--expect-same", type=Path, default=None,
                        help="a fixture whose arrays (all but stamp and card) the new "
                             "recording must equal bit for bit")
    args = parser.parse_args(argv)
    if args.margin_seeds:
        bar = kdtree_bar()
        for seed in args.margin_seeds:
            out = record(seed, args.device)
            line = {"seed": seed, "card": str(out["card"]), "bar": bar}
            for name in sorted(acceptance.champion_configs()):
                tr_err = float(out[f"{name}_tr_err"])
                line[f"{name}_tr_err"], line[f"{name}_margin"] = tr_err, bar - tr_err
            print(json.dumps(line), flush=True)
        return 0
    out = record(None, args.device)
    if args.expect_same is not None:
        same = compare_fixtures(out, dict(np.load(args.expect_same)))
        print(f"FIXTURE_COMPARE {json.dumps(same)}", flush=True)
        if not all(same.values()):
            print(f"the recording differs from {args.expect_same}; nothing written",
                  flush=True)
            return 1
    args.out.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(args.out, **out)
    print(f"code stamp {acceptance.code_stamp()}; wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
