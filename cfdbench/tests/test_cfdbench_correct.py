"""What decides `correct` fails where it must, on a tiny box in (i, j, k)
and in RCM order on the CPU: a sound float32 run passes; the control
(the port's bfloat16 path, the precision below float32) does not; nor
does a run with a fault planted in the timed path (faults.py). Each
drives a whole run with the card's look skipped."""
import json

import pytest

from cfdbench import run
from cfdbench.faults import FAULTS, plant
from cfdbench.tests.conftest import tiny_config
from cfdbench.tests.hostcard import HostCard


@pytest.fixture
def harness(kind, tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(run, "CACHE", str(tmp_path))
    monkeypatch.setattr(run, "require_card", HostCard)
    cfg = tiny_config(kind)
    spec = run.cell_spec(f"m6{kind}.graph")
    spec["config"] = cfg

    def go(dtype="float32", trace=0):
        cfg["solver"]["dtype"] = dtype
        monkeypatch.setattr(run, "cell_spec", lambda name: spec)
        assert run.main(["--workload", "tiny", "--seed", "41",
                         "--seconds", "0.2", "--trace", str(trace)]) == 0
        return json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    return go


def test_sound_run_is_correct(harness):
    line = harness()
    assert line["correct"] is True
    assert all(c["value"] <= c["limit"] for c in line["checks"].values())


def test_control_is_not_correct(harness, kind):
    line = harness(**tiny_config(kind)["control"])
    assert line["correct"] is False
    failed = [k for k, c in line["checks"].items()
              if not c["value"] <= c["limit"]]
    assert failed


@pytest.mark.parametrize("fault", FAULTS)
def test_fault_is_not_correct(harness, fault):
    with plant(fault):
        line = harness()
    assert line["correct"] is False
