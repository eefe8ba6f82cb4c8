"""Pose-graph backend (GraphSLAM), the port of
``pylidar_slam_tpu.slam.backend``: a float64 host-side sparse Gauss-Newton
(``ops/pose_graph.optimize_pose_graph_host``).

The backend scans each frame's ``data_dict`` by regex for
``se3_odometry_constraint_<i>``, ``se3_loop_closure_constraint_<i>_<j>`` and
``se3_absolute_constraint_<i>`` keys, chains odometry constraints into new
vertices, and optimizes the whole graph whenever a loop edge spans more than
2 indices.
"""
from __future__ import annotations

import logging
import re
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from pylidar_slam_tpu_torch.config import MISSING, Registry, dataclass_from_dict
from pylidar_slam_tpu_torch.eval.eval_odometry import compute_relative_poses
from pylidar_slam_tpu_torch.ops.pose_graph import optimize_pose_graph_host
from pylidar_slam_tpu_torch.utils import assert_debug

logger = logging.getLogger(__name__)


@dataclass
class BackendConfig:
    type: str = MISSING


class Backend:
    """Constraint accumulation + the key protocol."""

    def __init__(self, config: BackendConfig, **kwargs):
        self.config = config
        self._constraints: Optional[dict] = None
        self.need_to_update_pose: bool = False

    def init(self):
        self.clear()
        self._constraints = {"se3_odometry": [], "se3_loop_closure": [],
                             "se3_absolute": []}

    def clear(self):
        raise NotImplementedError("")

    def world_poses(self) -> np.ndarray:
        raise NotImplementedError("")

    def absolute_poses(self) -> np.ndarray:
        raise NotImplementedError("")

    def relative_odometry_poses(self):
        raise NotImplementedError("")

    def next_frame(self, data_dict: dict):
        raise NotImplementedError("")

    @staticmethod
    def _regexes():
        return (r"^se3_odometry_constraint_([\d]+)$",
                r"^se3_loop_closure_constraint_([\d]+)_([\d]+)$",
                r"^se3_absolute_constraint_([\d]+)$")

    @staticmethod
    def se3_odometry_constraint(reference_idx: int) -> str:
        return f"se3_odometry_constraint_{int(reference_idx)}"

    @staticmethod
    def se3_loop_closure_constraint(reference_idx: int, tgt_idx: int) -> str:
        return f"se3_loop_closure_constraint_{int(reference_idx)}_{int(tgt_idx)}"

    @staticmethod
    def se3_absolute_constraint(reference_idx: int) -> str:
        return f"se3_absolute_constraint_{int(reference_idx)}"

    def search_constraints(self, data_dict: dict) -> dict:
        constraints = {"se3_odometry": [], "se3_loop_closure": [],
                       "se3_absolute": []}
        reg_odom, reg_loop, reg_abs = self._regexes()
        for key in data_dict.keys():
            if not isinstance(key, str):
                continue
            m = re.search(reg_odom, key)
            if m is not None:
                matrix, information = data_dict[key]
                constraints["se3_odometry"].append(
                    (int(m.group(1)), np.asarray(matrix), information))
            m = re.search(reg_loop, key)
            if m is not None:
                matrix, information = data_dict[key]
                constraints["se3_loop_closure"].append(
                    (int(m.group(1)), int(m.group(2)), np.asarray(matrix),
                     information))
            m = re.search(reg_abs, key)
            if m is not None:
                matrix, information = data_dict[key]
                constraints["se3_absolute"].append(
                    (int(m.group(1)), np.asarray(matrix), information))

        constraints["se3_odometry"].sort(key=lambda x: x[0])
        self._constraints["se3_odometry"] += constraints["se3_odometry"]
        self._constraints["se3_loop_closure"] += constraints["se3_loop_closure"]
        self._constraints["se3_absolute"] += constraints["se3_absolute"]
        return constraints

    def registered_loop_constraints(self):
        return self._constraints["se3_loop_closure"] if self._constraints else []

    def registered_odometry_constraints(self):
        return self._constraints["se3_odometry"] if self._constraints else []

    def registered_absolute_constraints(self):
        return self._constraints["se3_absolute"] if self._constraints else []


@dataclass
class GraphSLAMConfig(BackendConfig):
    type: str = "graph_slam"
    initialize_world_coordinates: bool = True
    fix_first_frame: bool = True
    max_optim_iterations: int = 100
    online_optimization: bool = True
    cg_iterations: int = 50
    debug: bool = False


def _odometry_information() -> np.ndarray:
    """High-confidence odometry edge weight."""
    info = np.eye(6)
    info[:3, :3] *= 2.0
    info[3:, 3:] *= 5.0
    return info


def _loop_closure_information() -> np.ndarray:
    """Low-confidence loop-closure edge weight, keyed on the constraint's
    type (not its index distance): a loop closure between nearby frames
    still gets loop-closure-grade weight."""
    info = np.eye(6)
    info[:3, :3] *= 0.1
    info[3:, 3:] *= 0.5
    return info


def _gps_information() -> np.ndarray:
    info = np.eye(6)
    info[:3, :3] = 1.0
    info[3:, 3:] = 0.001
    return info


class GraphSLAM(Backend):
    """Online pose-graph SLAM on the float64 host solver."""

    def __init__(self, config: GraphSLAMConfig, **kwargs):
        if not isinstance(config, GraphSLAMConfig):
            config = dataclass_from_dict(GraphSLAMConfig, config)
        super().__init__(config)
        self._poses: List[np.ndarray] = []  # current absolute estimates
        self.odometry_poses: List[np.ndarray] = []  # raw odometry chain
        self._edges: List[Tuple[int, int, np.ndarray, np.ndarray]] = []
        self._priors: List[Tuple[int, np.ndarray, np.ndarray]] = []

    def clear(self):
        self._poses = []
        self.odometry_poses = []
        self._edges = []
        self._priors = []

    def init(self):
        super().init()
        self.clear()
        if self.config.initialize_world_coordinates:
            self._poses.append(np.eye(4))
            self.odometry_poses.append(np.eye(4))

    def next_frame(self, data_dict: dict):
        constraints = self.search_constraints(data_dict)
        do_update = False

        for i, mat, information in constraints["se3_odometry"]:
            mat = mat.astype(np.float64)
            if i + 1 >= len(self._poses):
                assert_debug(i < len(self._poses),
                             f"Odometry constraint {i} skips a vertex")
                self._poses.append(self._poses[i] @ mat)
                self.odometry_poses.append(self.odometry_poses[-1] @ mat)
            info = (np.asarray(information) if information is not None
                    else _odometry_information())
            self._edges.append((i, i + 1, mat, info))

        for i, mat, information in constraints["se3_absolute"]:
            info = (np.asarray(information) if information is not None
                    else _gps_information())
            self._priors.append((i, mat.astype(np.float64), info))

        for i, j, mat, information in constraints["se3_loop_closure"]:
            assert_debug(i < len(self._poses) and j < len(self._poses),
                         f"Loop constraint ({i}, {j}) references unknown poses")
            info = (np.asarray(information) if information is not None
                    else _loop_closure_information())
            self._edges.append((i, j, mat.astype(np.float64), info))
            if abs(i - j) > 2:
                do_update = True

        if do_update:
            logger.info("Optimizing pose graph (%d poses, %d edges)",
                        len(self._poses), len(self._edges))
            self.optimize(self.config.max_optim_iterations)
            self.need_to_update_pose = True

    def optimize(self, max_num_epochs: int = 20):
        if not self._edges:
            return
        if not self.config.online_optimization:
            self._poses = [p.copy() for p in self.odometry_poses]

        # float64 host solve (scipy sparse LU): the graph is tiny next to
        # the scan pipeline; ``optimize_pose_graph`` is the device solver
        poses = np.stack(self._poses)
        optimized = optimize_pose_graph_host(
            poses,
            edge_i=[e[0] for e in self._edges],
            edge_j=[e[1] for e in self._edges],
            measurements=np.stack([e[2] for e in self._edges]),
            information=np.stack([e[3] for e in self._edges]),
            prior_idx=[p[0] for p in self._priors] if self._priors else None,
            prior_measurements=(np.stack([p[1] for p in self._priors])
                                if self._priors else None),
            prior_information=(np.stack([p[2] for p in self._priors])
                               if self._priors else None),
            num_iters=min(max_num_epochs, 30),
            fix_first=self.config.fix_first_frame)
        self._poses = [optimized[k] for k in range(optimized.shape[0])]

    def world_poses(self) -> np.ndarray:
        return self.absolute_poses()

    def absolute_poses(self) -> np.ndarray:
        return np.stack(self._poses)

    def relative_odometry_poses(self) -> np.ndarray:
        return compute_relative_poses(self.absolute_poses())


BACKEND = Registry("backend", type_key="type")
BACKEND.register("graph_slam", GraphSLAM, GraphSLAMConfig)
