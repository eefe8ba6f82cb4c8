"""The cells at their own size on the card: a sound run is correct and its
control (the reference in the lower precision in the program's place)
fails a limit.  Skips without a card; on the card:

    python -m pytest slambench/tests/test_slambench_gpu.py -m gpu -q
"""
from __future__ import annotations

import pytest

from conftest import make_root, run_cell


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["agg-offline", "slam-revisit"])
def test_cell_is_correct_and_its_control_is_not(card, tmp_path, capsys, workload):
    root = make_root(tmp_path, tiny=False)
    rc, line = run_cell(root, workload, seed=4242, seconds=8.0, control=True, capsys=capsys)
    assert rc == 0 and line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
    assert any(line["control"][k] > c["limit"] for k, c in line["checks"].items())
