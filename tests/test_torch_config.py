"""The port's configuration layer against the JAX package's: the YAML-subset
reader against PyYAML on every file of the shared ``config/`` tree, the
composer against the JAX ``compose``, the writer against ``yaml.safe_dump``,
the registries, and the runner's device resolution.  Exact equality
throughout: these are the same plain data."""
import math
from pathlib import Path

import pytest
import torch
import yaml

from pylidar_slam_tpu import config as jconfig
from pylidar_slam_tpu.dataset import DATASET as JDATASET

from pylidar_slam_tpu_torch import config as tconfig
from pylidar_slam_tpu_torch.dataset import DATASET
from pylidar_slam_tpu_torch.slam.initialization import INITIALIZATION
from pylidar_slam_tpu_torch.slam.odometry import ODOMETRY
from pylidar_slam_tpu_torch.slam.odometry_runner import resolve_device
from pylidar_slam_tpu_torch.train import build_trainer

CONFIG = Path(__file__).resolve().parents[1] / "config"

# The override sets of tests/test_slam_e2e.py (composition and CLI tests)
# and the verify recipe's.
OVERRIDE_SETS = [
    [],
    ["dataset=synthetic"],
    ["dataset=synthetic", "slam/odometry/local_map=aggregated"],
    ["dataset=synthetic", "slam.odometry.max_num_alignments=25"],
    ["dataset=synthetic", "slam/odometry=ct_icp"],
    ["dataset=synthetic", "slam/odometry=ct_icp", "slam/odometry/local_map=projective"],
    ["dataset=synthetic", "slam/odometry=ct_icp_robust_drive"],
    ["dataset=synthetic", "slam/odometry=aggregated_highway"],
    ["dataset=synthetic", "dataset.num_frames=130", "dataset.speed=1.3",
     "log_dir=/tmp/verify_run"],
    ["dataset=synthetic", "dataset.num_frames=40", "dataset.turn_rate=0.01",
     "slam/odometry/local_map=aggregated", "slam.odometry.max_num_alignments=6",
     "slam.odometry.num_points_padded=65536", "slam.odometry.batch_size=4",
     "slam/loop_closure=elevation_image", "slam.loop_closure.local_map_size=4",
     "slam.loop_closure.overlap=1", "slam.loop_closure.min_id_distance=9",
     "slam.loop_closure.max_distance=1e6", "slam/backend=graph_slam"],
    ["dataset=synthetic", "dataset.skew=true", "dataset.turn_rate=0.08",
     "slam/preprocessing=grid_sample", "slam/initialization=EI",
     "+extra.key=[1, 2]", "slam.odometry.alignment.gauss_newton_config.sigma=2e-4"],
    ["dataset=kitti", 'dataset.train_sequences=["00"]', "max_num_frames=120"],
]


@pytest.mark.parametrize("path", sorted(CONFIG.rglob("*.yaml")),
                         ids=lambda p: str(p.relative_to(CONFIG)))
def test_yaml_reader_matches_pyyaml(path):
    text = path.read_text()
    assert tconfig.load_yaml(text) == yaml.safe_load(text)


SCALARS = ["2e-4", "1.5", "42", "-24", "16.6", "true", "Off", "yes", "null", "~", "",
           "0x1F", "017", "1_000", "1:30", "-.inf", "3.", ".5", "1.0e+5", "hello",
           "a b", "foo #bar", '"00"', "'it''s'", '[ "00", "01"]', "[1.0, 1.0]",
           "[[1, 2], [3]]", "{a: 1, b: [x, y]}", "[]", "{}", "a: b",
           ".outputs/slam/${now:%Y-%m-%d}_${now:%H-%M-%S}", "${env:KITTI_ODOM_ROOT}",
           "x: [1, 2]\ny:\n- 3\n- z: 4\n  w: 5\n"]


@pytest.mark.parametrize("text", SCALARS)
def test_yaml_reader_scalars_match_pyyaml(text):
    ours, ref = tconfig.load_yaml(text), yaml.safe_load(text)
    assert ours == ref or (isinstance(ref, float) and math.isnan(ref) and math.isnan(ours))


@pytest.mark.parametrize("text", ["2e-4", "1.5", "42", "true", "[1, 2]", "hello",
                                  '["00"]', "1e6", "-3", "null", "a,b"])
def test_cli_scalar_parsing_matches_jax(text):
    assert tconfig._parse_scalar(text) == jconfig._parse_scalar(text)


def test_yaml_writer_matches_safe_dump():
    data = {"synth_00": {"ATE": 0.00212, "tr_err": 1e-05, "rot_err": 2.5e-06,
                         "nsecs_per_frame": 0.12345678901234},
            "AVG": {"ATE": 3.0, "x": math.inf}, "list": ["a", "00", 1, [1, 2], {"k": None}],
            "empty": {}, "none": [], "quoted": "it's: x", "flag": True, "path": ".outputs/a"}
    assert tconfig.dump_yaml(data) == yaml.safe_dump(data)
    overrides = ["dataset=synthetic", "dataset.num_frames=130", "log_dir=/tmp/x"]
    assert tconfig.dump_yaml(overrides) == yaml.safe_dump(overrides)


def test_yaml_writer_round_trips_a_composed_config():
    cfg = tconfig.compose(str(CONFIG), "slam", OVERRIDE_SETS[-3])
    text = tconfig.dump_yaml(cfg)
    assert tconfig.load_yaml(text) == cfg
    assert yaml.safe_load(text) == cfg


@pytest.mark.parametrize("overrides", OVERRIDE_SETS, ids=lambda o: " ".join(o) or "defaults")
def test_compose_matches_jax(overrides, monkeypatch):
    monkeypatch.setenv("KITTI_ODOM_ROOT", "/data/kitti")
    ours = tconfig.compose(str(CONFIG), "slam", overrides)
    ref = jconfig.compose(str(CONFIG), "slam", overrides)
    # ${now:...} resolves to the wall clock in both: compare the rest
    ours.pop("log_dir"), ref.pop("log_dir")
    assert ours == ref


def test_compose_errors_match_jax(monkeypatch):
    monkeypatch.delenv("KITTI_ODOM_ROOT", raising=False)
    for overrides, error in ((["slam/odometry=bogus"], FileNotFoundError),
                             (["dataset=kitti"], KeyError),
                             (["notanoverride"], ValueError)):
        for compose in (tconfig.compose, jconfig.compose):
            with pytest.raises(error):
                compose(str(CONFIG), "slam", overrides)


def test_registries():
    assert DATASET.get("synthetic")[0].__name__ == "SyntheticDatasetLoader"
    # every loader of the JAX package, under its name, with its config
    assert sorted(DATASET.keys()) == sorted(JDATASET.keys())
    for name in JDATASET.keys():
        ours, ref = DATASET.get(name), JDATASET.get(name)
        assert [c.__name__ for c in ours] == [c.__name__ for c in ref]
    assert ODOMETRY.get("icp_F2M")[0].__name__ == "ICPFrameToModel"
    assert ODOMETRY.get("posenet")[0].__name__ == "PoseNetOdometry"
    assert INITIALIZATION.get("posenet")[0].__name__ == "PoseNetInitialization"
    # data_parallel and tensor_parallel build; without a process group of
    # more than one rank they keep the plain step (no layout), as the JAX
    # package's n_dev > 1 guard does
    cfg = tconfig.compose(str(CONFIG), "train_posenet", ["dataset=synthetic", "device=cpu"])
    for override in ({"data_parallel": True}, {"tensor_parallel": 2}):
        trainer = build_trainer(dict(cfg, **override))
        assert trainer._mesh is None and trainer.device.type == "cpu"
    assert INITIALIZATION.load({"type": "none"}) is None
    with pytest.raises(KeyError, match="Registered"):
        INITIALIZATION.load({"type": "bogus"})
    with pytest.raises(KeyError, match="discriminator"):
        ODOMETRY.load({})


def test_device_resolution(monkeypatch):
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device("CPU") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    # the card by default, and by every name the config tree uses for it
    for name in (None, "cuda", "gpu", "tpu", "cuda:0"):
        with pytest.raises(RuntimeError, match="device=cpu"):
            resolve_device(name)
    with pytest.raises(ValueError):
        resolve_device("mps")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    for name in (None, "cuda", "gpu", "tpu"):
        assert resolve_device(name) == torch.device("cuda", 0)
    assert resolve_device("cuda:1") == torch.device("cuda", 1)
