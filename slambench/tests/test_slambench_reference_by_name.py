"""A configuration that names its own odometry reference,
``slambench/reference/<name>.py``: added as files and entries alone, run
through that module in the run's and in the control's precision, stopped
before set-up where the name is wrong; without the key, the aggregated
map's reference as before."""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from conftest import run_cell
from slambench import correct
from slambench.reference import odometry as ref_odometry
from slambench.trace import odometry_program
from test_slambench_reference import tiny_case

# A reference of its own: the aggregated map's, through a module that logs
# the precision of each call beside itself.
LOGGED = '''"""The aggregated map's reference, logging each call's precision."""
from pathlib import Path

from slambench.reference import odometry


def run(program, sensor, clouds, frames, device, dtype):
    with open(Path(__file__).with_suffix(".log"), "a") as f:
        f.write(f"{dtype}\\n")
    return odometry.run(program, sensor, clouds, frames, device, dtype)
'''
# A reference of a sensor that never moves.
STILL = '''"""Every frame where the last one was."""
import numpy as np


def run(program, sensor, clouds, frames, device, dtype):
    return np.zeros((frames, 6), np.float32)
'''


def add_cell(root, reference: str, source: str = None) -> str:
    """A configuration naming `reference` (with the module `source` written
    as ``slambench/reference/<reference>.py``), a cell of it on the road,
    and the entries that name them; returns the cell's name."""
    if source is not None:
        (root / "slambench/reference" / f"{reference}.py").write_text(source)
    cfg = json.loads((root / "slambench/configs/hdl64-aggregated.json").read_text())
    cfg.update(name="hdl64-own-reference", reference=reference)
    (root / "slambench/configs/hdl64-own-reference.json").write_text(json.dumps(cfg))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "hdl64-own-reference", "source": "https://example.org",
                            "file": "slambench/configs/hdl64-own-reference.json",
                            "reduced": [], "why": "a reference of its own"})
    spec["workloads"].append({"name": "own-reference.road", "config": "hdl64-own-reference",
                              "traffic": "road", "chips": 1, "why": "a test cell"})
    spec["end_to_end"][0]["workloads"].append("own-reference.road")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return "own-reference.road"


def test_a_reference_added_as_a_file_decides_correct(tiny_root, capsys):
    """The run's check calls the named module in float32 and the control
    in ``CONTROL_DTYPE``; the control fails a limit as the aggregated map's
    does."""
    cell = add_cell(tiny_root, "logged", LOGGED)
    rc, line = run_cell(tiny_root, cell, seed=21, control=True, capsys=capsys)
    assert rc == 0 and line["correct"], line["checks"]
    log = (tiny_root / "slambench/reference/logged.log").read_text().split()
    assert log == [str(torch.float32), str(correct.CONTROL_DTYPE)]
    assert any(line["control"][k] > c["limit"] for k, c in line["checks"].items())


def test_the_named_reference_is_the_one_compared(tiny_root, capsys):
    """A reference that disagrees with the program makes the run not
    correct: the verdict is the named module's."""
    cell = add_cell(tiny_root, "still", STILL)
    rc, line = run_cell(tiny_root, cell, seed=22, capsys=capsys)
    assert rc == 0 and line["correct"] is False
    assert line["checks"]["odom_trans_gap_m"]["value"] > 0.5


@pytest.mark.parametrize("reference,source", [("no_such_reference", None),
                                              ("no_run", "RUN = None\n"),
                                              ("../configs/x", None)])
def test_a_misnamed_reference_stops_before_set_up(tiny_root, capsys, monkeypatch,
                                                  reference, source):
    """A name that is no module of ``slambench/reference`` with a ``run``
    stops the run before any scan is made, naming the file; no result."""
    from slambench import harness
    from slambench.traffic import generator

    def no_scans(*a, **k):
        raise AssertionError("scans made before the reference was found")

    monkeypatch.setattr(generator, "make_scans", no_scans)
    cell = add_cell(tiny_root, reference, source)
    with pytest.raises(SystemExit) as stop:
        run_cell(tiny_root, cell, capsys=capsys)
    assert f"slambench/reference/{reference}.py" in str(stop.value)
    assert capsys.readouterr().out == ""
    with pytest.raises(SystemExit):
        harness.load_cell(tiny_root, cell)


def test_without_the_key_the_aggregated_reference_decides():
    """A configuration without ``"reference"`` gives the numbers of a
    direct call of ``slambench.reference.odometry.run``, to the bit."""
    cfg, clouds, ours = tiny_case(frames=8)
    assert "reference" not in cfg
    frames = len(clouds)
    ref = ref_odometry.run(odometry_program(cfg), correct.sensor_of(cfg), clouds, frames,
                           "cpu", torch.float32)
    assert np.array_equal(correct.reference_params(cfg, clouds, frames, "cpu"), ref)
    gap_t, gap_r = correct.pose_gaps(ours, ref)
    got = correct.numbers(cfg, clouds, frames, {"params": ours}, "cpu", 0)
    assert got == {"odom_trans_gap_m": gap_t, "odom_rot_gap_deg": gap_r}
