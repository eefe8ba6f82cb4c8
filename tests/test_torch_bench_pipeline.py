"""``python -m pylidar_slam_tpu_torch.bench_pipeline`` on the CPU at a tiny
size: one JSON line with the keys of the JAX script it ports,
``scripts/bench_full_pipeline.py`` (read from its source)."""
import json

import numpy as np

from test_torch_bench import TINY, _tiny_frames, clean_env, jax_script_keys  # noqa: F401
from test_torch_odometry import _one_torch_thread  # noqa: F401
from pylidar_slam_tpu_torch import bench_pipeline


def test_bench_pipeline_prints_the_jax_scripts_line(clean_env, capsys):
    items, loader = _tiny_frames(12, speed=0.5)
    clean_env.setattr(bench_pipeline, "load", lambda env: (items, loader.projector()))
    for k, v in {"BENCH_DEVICE": "cpu", "FP_BATCH": "4", "FP_WARMUP_FRAMES": "4",
                 "FP_COOLDOWN_FRAMES": "2", "FP_REPEATS": "1"}.items():
        clean_env.setenv(k, v)
    result = bench_pipeline.main()
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == result
    assert list(result) == jax_script_keys("bench_pipeline")
    assert result["timed_frames"] == 6 and result["runs"] == [result["value"]]
    assert result["value"] > 0
    assert np.isfinite(result["pipeline_ms_per_flush"]["dispatch"])
