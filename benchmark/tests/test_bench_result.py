"""The shape of a run's last line, from a whole run of a tiny cell on the
CPU (the harness's look for a card is what ``run.py`` adds)."""

import json

import pytest

from benchmark.harness import runner
from benchmark.tests import tiny


def _run(capsys, workload, trace):
    result = runner.run_cell(tiny.cell(workload), 2 ** 31 + 99, 0.5, trace, "cpu", 0.0,
                             emit=lambda line: None)
    runner.print_result(result)
    out, err = capsys.readouterr()
    return json.loads(out.strip().splitlines()[-1]), err.strip().splitlines()


@pytest.mark.parametrize("trace", [False, True])
def test_last_line(capsys, trace):
    line, err = _run(capsys, "spa3d.tail", trace)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert isinstance(line["correct"], bool)
    assert line["attempted"] > 0 and line["failed"] == 0
    dev = line["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    names = set(line["metrics"])
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in line["breakdown"].values())
        assert names <= {"attention_roofline.tail", "mfu.tail", "idle_share.tail"}
        assert "mfu.tail" in names  # the others read a device trace, which the CPU lacks
    else:
        assert names == {"setup_s", "tail_ms", "tail_ms_p95"}
    for metric in line["metrics"].values():
        assert set(metric) == {"value", "unit"}
    for check in line["checks"].values():
        assert set(check) == {"value", "limit"}
    # The checks are the last lines of standard error, one each.
    assert len(err) >= len(line["checks"])
    assert all(l.startswith("check ") for l in err[-len(line["checks"]):])


def test_a_reading_that_is_no_number_is_written_as_a_string(capsys):
    result = {"correct": False, "attempted": 1, "failed": 0, "metrics": {}, "device": {},
              "checks": {"gap": {"value": float("inf"), "limit": 0.1}}}
    runner.print_result(result)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["checks"]["gap"] == {"value": "inf", "limit": 0.1}
