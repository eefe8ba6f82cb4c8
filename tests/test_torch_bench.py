"""The port's measurement entry points against the JAX repository's: the
bench configuration against the root ``bench.build_icp_config`` and the
champion, and ``bench`` run on the CPU at a tiny size, printing one JSON
line with the keys of the root bench (read from its source).
``bench_surfel`` and ``bench_pipeline`` are held the same way in
test_torch_bench_surfel.py and test_torch_bench_pipeline.py (one file per
bench, so that parallel workers take them apart)."""
import ast
import dataclasses
import json
import os
from pathlib import Path

import pytest
import torch

import bench as root_bench

from test_torch_odometry import _one_torch_thread  # noqa: F401
from pylidar_slam_tpu_torch import bench, bench_pipeline, bench_surfel
from pylidar_slam_tpu_torch.dataset.synthetic import (SyntheticConfig,
                                                      SyntheticDatasetLoader)
from pylidar_slam_tpu_torch.eval import acceptance

REPO = Path(__file__).resolve().parents[1]
TINY = dict(lidar_height=32, lidar_width=256, num_walls=40, num_pillars=25)


def _dict_keys(node: ast.Dict) -> list:
    return [k.value for k in node.keys]


def jax_script_keys(name: str) -> list:
    """The keys of the JSON line the JAX script prints, from its source."""
    if name == "bench":
        tree = ast.parse((REPO / "bench.py").read_text())
        return next(_dict_keys(n.value) for n in ast.walk(tree) if isinstance(n, ast.Assign)
                    and getattr(n.targets[0], "id", None) == "result")
    if name == "bench_surfel":
        tree = ast.parse((REPO / "scripts" / "bench_surfel.py").read_text())
        return next(_dict_keys(n.args[0]) for n in ast.walk(tree) if isinstance(n, ast.Call)
                    and getattr(n.func, "attr", None) == "dumps")
    tree = ast.parse((REPO / "scripts" / "bench_full_pipeline.py").read_text())
    run_once = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
                    and n.name == "run_once")
    ret = next(n for n in ast.walk(run_once) if isinstance(n, ast.Return))
    return _dict_keys(ret.value) + ["runs", "repeats"]


@pytest.fixture
def clean_env(monkeypatch):
    for k in list(os.environ):
        if k.startswith(("BENCH_", "SF_", "FP_", "KITTI_ODOM_ROOT")):
            monkeypatch.delenv(k)
    return monkeypatch


def test_bench_config_is_the_champion(clean_env):
    assert bench.build_icp_config("aggregated", "rimg8") == \
        acceptance.champion_configs()["aggregated"]
    assert bench.build_icp_config("voxel", "rimg8") == acceptance.profile_configs()["voxel"]


@pytest.mark.parametrize("bench_map", ["aggregated", "kdtree", "voxel"])
@pytest.mark.parametrize("env", [{}, {"BENCH_MODEL_NORMALS": "1", "BENCH_ITERS": "12",
                                      "BENCH_SIGMA": "0.3", "BENCH_BATCH": "8"}])
def test_bench_config_is_the_root_benchs(clean_env, bench_map, env):
    """Field for field the root bench's configuration (the device aside:
    the JAX package's default names its own)."""
    for k, v in env.items():
        clean_env.setenv(k, v)
    if "BENCH_BATCH" in env:  # the root bench reads it when imported
        clean_env.setattr(root_bench, "BATCH", int(env["BENCH_BATCH"]))
    ours = bench.build_icp_config(bench_map, "rimg8")
    theirs = root_bench.build_icp_config(bench_map, "rimg8")
    names = [f.name for f in dataclasses.fields(ours)]
    assert names == [f.name for f in dataclasses.fields(theirs)]
    for name in names:
        if name != "device":
            assert getattr(ours, name) == getattr(theirs, name), name
    assert ours.device == "cuda"


@pytest.mark.parametrize("fmt", ["rimg", "rimg12", "rimg16", "packed"])
def test_unported_format_raises(clean_env, fmt):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        bench.build_icp_config("aggregated", fmt)


def test_quantized_upload_raises(clean_env):
    clean_env.setenv("BENCH_QUANT", "0.01")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        bench.build_icp_config("aggregated", "rimg8")


def test_bench_default_format_of_an_irregular_loader_raises(clean_env):
    """A loader that is not grid-regular defaults to rimg, which the port
    leaves out: the bench raises rather than switching formats."""
    loader = SyntheticDatasetLoader(SyntheticConfig(num_frames=2, beam_jitter_deg=0.05, **TINY))
    assert not loader.grid_regular
    with pytest.raises(NotImplementedError, match="rimg"):
        bench.run(bench.Settings(device="cpu"), [], loader, "synthetic")


@pytest.mark.parametrize("entry", [bench, bench_surfel, bench_pipeline])
def test_bench_without_a_card_raises(clean_env, entry):
    """The card unless BENCH_DEVICE=cpu: no fallback to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    clean_env.setattr(bench, "load_frames", lambda n: pytest.fail("frames generated"))
    with pytest.raises(RuntimeError, match="device=cpu"):
        entry.main()


def _tiny_frames(n, **kw):
    loader = SyntheticDatasetLoader(SyntheticConfig(num_frames=n, **TINY, **kw))
    return bench.generate(loader.sequences()[0][0][0], n), loader


def test_bench_prints_the_root_benchs_line(clean_env, capsys):
    items, loader = _tiny_frames(13)
    clean_env.setattr(bench, "load_frames",
                      lambda n: ([f["numpy_pc"] for f in items], loader, "synthetic-tiny"))
    # capacity: the 32x256 rimg8 upload's 8,336 rows, rounded up to 1,024
    for k, v in {"BENCH_DEVICE": "cpu", "BENCH_BATCH": "4", "BENCH_REPEATS": "1",
                 "BENCH_CAP": "9216", "BENCH_WORKERS": "2"}.items():
        clean_env.setenv(k, v)
    result = bench.main()
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == result
    assert list(result) == jax_script_keys("bench")
    assert result["batch"] == 4 and len(result["rates"]) == 1
    assert result["value"] > 0 and result["median_value"] == result["value"]
    assert "probe_error" not in result["stages"], result["stages"]
    assert set(result["phases"]) == {"queue_wait_ms_per_frame", "upload_wait_ms_per_frame",
                                     "dispatch_ms_per_frame", "final_sync_ms_per_frame",
                                     "total_ms_per_frame"}


def test_bench_timed_frames_are_whole_batches():
    s = bench.Settings(batch=12, warmup=13)
    assert len(bench.timed_frames(list(range(253)), s)) == 240
    assert len(bench.timed_frames(list(range(61)), s)) == 48
