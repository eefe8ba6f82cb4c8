"""How ``correct`` is decided: the program's outputs against the plain
reference's, recomputed from the same scans after the window, each number
beside the limit its configuration file states under ``checks``.

The numbers (each the worst over the run's frames or events):

- ``odom_trans_gap_m`` / ``odom_rot_gap_deg``: the gap between the
  program's and the reference's relative pose of a frame, in translation
  and in rotation angle.  Both run freely from frame 0 over every frame of
  the run: the set-up frames and the window's.  The odometry's reference
  is ``slambench/reference/<name>.py``, `name` the configuration's
  ``"reference"`` key (``odometry``, the aggregated map's, without one):
  a module whose ``run(program, sensor, clouds, frames, device, dtype)``
  returns the (frames, 6) float32 relative-pose params.
- the loop closure's and the backend's numbers, in configurations that have
  them (``slambench/reference/loop_closure.py``).

A number that cannot be computed (an output missing or not finite) reads
``inf``, which fails any limit.
"""
from __future__ import annotations

import importlib.util
import math
import sys
from pathlib import Path

import numpy as np
import torch

from slambench.reference import odometry as ref_odometry
from slambench.trace import odometry_program


CONTROL_DTYPE = torch.bfloat16  # the precision below the configuration's float32
ROOT = Path(__file__).resolve().parents[1]
DEFAULT_REFERENCE = "odometry"


def load_module(path: Path, name: str):
    """The Python file `path`, loaded as the module `name`, registered in
    ``sys.modules`` as an import would be (a dataclass needs its module)."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = sys.modules[name] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reference_run(config: dict, root: Path = ROOT):
    """The ``run`` of the configuration's odometry reference,
    ``slambench/reference/<name>.py`` under `root`; a name that is not a
    module of that directory with a ``run`` stops the run, naming the file."""
    name = config.get("reference", DEFAULT_REFERENCE)
    path = Path(root) / "slambench" / "reference" / f"{name}.py"
    if not (isinstance(name, str) and name.isidentifier() and path.is_file()):
        raise SystemExit(f"slambench: the configuration's reference {str(path)!r} "
                         f"(\"reference\": {name!r}) is not a file of slambench/reference")
    run = getattr(load_module(path, f"slambench_reference_{name}"), "run", None)
    if not callable(run):
        raise SystemExit(f"slambench: the reference {str(path)!r} has no run()")
    return run


def sensor_of(config: dict) -> ref_odometry.Sensor:
    s = config["sensor"]
    return ref_odometry.Sensor(int(s["lidar_height"]), int(s["lidar_width"]),
                               float(s["up_fov"]), float(s["down_fov"]))


def pose_gaps(ours: np.ndarray, ref: np.ndarray):
    """Worst (translation m, rotation deg) gap between two (F, 6) logs of
    relative-pose params, each rebuilt as a float64 matrix."""
    if ours is None or ours.shape != ref.shape or not np.isfinite(ours).all():
        return math.inf, math.inf
    worst_t = worst_r = 0.0
    for a, b in zip(ours, ref):
        ma, mb = ref_odometry.pose_matrix_f64(a), ref_odometry.pose_matrix_f64(b)
        worst_t = max(worst_t, float(np.linalg.norm(ma[:3, 3] - mb[:3, 3])))
        cos = np.clip((np.trace(ma[:3, :3].T @ mb[:3, :3]) - 1.0) / 2.0, -1.0, 1.0)
        worst_r = max(worst_r, math.degrees(math.acos(cos)))
    return worst_t, worst_r


def reference_params(config: dict, clouds, frames: int, device,
                     dtype=torch.float32, reference=None) -> np.ndarray:
    """The reference's relative-pose params: `reference` (the run's, as
    ``harness.load_cell`` resolved it), else the configuration's own
    (``reference_run``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run = reference_run(config) if reference is None else reference
    return run(odometry_program(config), sensor_of(config), clouds, frames, device, dtype)


def numbers(config: dict, clouds, frames: int, outputs: dict, device, seed: int,
            control: bool = False, reference=None) -> dict:
    """The compared numbers of a run.  With `control`, the reference runs
    in the precision below the configuration's (``CONTROL_DTYPE`` for its
    float32 arithmetic, float32 for the backend's float64), which has to
    fail the limits."""
    dtype = CONTROL_DTYPE if control else torch.float32
    ref = reference_params(config, clouds, frames, device, dtype, reference)
    gap_t, gap_r = pose_gaps(outputs.get("params"), ref)
    out = {"odom_trans_gap_m": gap_t, "odom_rot_gap_deg": gap_r}
    if "loop_closure" in config["program"]:
        from slambench.reference import loop_closure
        out.update(loop_closure.numbers(config, clouds, outputs, device, seed, control))
    return out


def check(config: dict, clouds, frames: int, outputs: dict, device, seed: int,
          reference=None) -> dict:
    limits = config["checks"]
    got = numbers(config, clouds, frames, outputs, device, seed, reference=reference)
    return {name: {"value": got[name], "limit": limits[name]} for name in limits}
