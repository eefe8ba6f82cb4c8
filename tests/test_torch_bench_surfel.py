"""``python -m pylidar_slam_tpu_torch.bench_surfel`` on the CPU at a tiny
size, with hash and exact NN: one JSON line with the keys of the JAX
script it ports, ``scripts/bench_surfel.py`` (read from its source)."""
import json

import pytest

from test_torch_bench import TINY, _tiny_frames, clean_env, jax_script_keys  # noqa: F401
from test_torch_odometry import _one_torch_thread  # noqa: F401
from pylidar_slam_tpu_torch import bench_surfel
from pylidar_slam_tpu_torch.eval import acceptance


@pytest.mark.parametrize("nn", ["hash", "exact"])
def test_bench_surfel_prints_the_jax_scripts_line(clean_env, capsys, nn):
    clean_env.setattr(acceptance, "SEQ_KW", dict(acceptance.SEQ_KW, **TINY))
    for k, v in {"BENCH_DEVICE": "cpu", "SF_NN": nn, "SF_FRAMES": "6", "SF_BATCH": "2",
                 "SF_REPEATS": "1", "SF_TGT": "1024", "SF_POINTS": "512"}.items():
        clean_env.setenv(k, v)
    result = bench_surfel.main()
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == result
    assert list(result) == jax_script_keys("bench_surfel")
    assert result["config"]["nn"] == nn and result["timed_frames"] == 6
    assert result["value"] > 0 and len(result["rates"]) == 1
    assert result["tr_err"] is None  # under 100 m
