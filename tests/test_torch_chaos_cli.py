"""The port's chaos CLI (``scripts/torch_chaos_run.py``) on the CPU.

* The crash drill with ``--slo-drill`` through ``main([...,
  "--device", "cpu"])``: the job survives one injected crash (exit 0), its
  one-line JSON report carries the JAX script's keys, names the restart
  and the ``node_death`` incident bundle (written before the teardown,
  the crashed node's snapshot from its manager KV) and the SLO drill's
  bundle with the breach marker on its timeline; with ``--workdir`` each
  bundle gets its ``report.txt`` and the merged trace survives.
* The flags the JAX script refuses together are refused (exit 2 from
  argparse).
"""

import json
import os
import sys

import pytest

from tensorflowonspark_tpu_torch import telemetry, telemetry_store

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))
import torch_chaos_run  # noqa: E402

pytestmark = pytest.mark.watchdog_timeout(120)

REPORT_KEYS = {"fault", "step", "times", "workdir", "attempts", "restarts",
               "failures", "committed_step", "survived", "goodput",
               "history_export", "slo_drill", "timeline", "incidents"}


@pytest.fixture()
def fresh():
    telemetry._reset_for_tests()
    yield
    telemetry._reset_for_tests()
    telemetry_store.disable()


def test_crash_drill_survives_and_reports_the_bundles(fresh, tmp_path,
                                                      capsys):
    workdir = str(tmp_path / "drill")
    rc = torch_chaos_run.main(["--fault", "crash", "--step", "3",
                               "--epochs", "4", "--slo-drill",
                               "--workdir", workdir, "--device", "cpu"])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0, report
    assert REPORT_KEYS <= set(report)
    assert report["survived"] and report["restarts"] == 1
    assert report["failures"][0]["kind"] == "crashed"
    assert report["failures"][0]["committed_step"] == 3
    markers = [m["name"] for m in report["timeline"]["restart_timeline"]]
    assert "supervise/relaunch" in markers and "node/error" in markers
    assert os.path.isfile(report["timeline"]["trace"])
    crash = [b for b in report["incidents"] if b["reason"] == "node_death"]
    assert len(crash) == 1 and crash[0]["nodes_captured"] == ["0"]
    assert "node0" in crash[0]["profiles"]
    bundle = os.path.join(workdir, "incidents", crash[0]["name"])
    with open(os.path.join(bundle, "nodes", "node0.json")) as f:
        snap = json.load(f)
    assert snap["via"] == "manager_kv"
    assert "injected failure at step 3" in snap["error"]
    with open(os.path.join(bundle, "rings", "node0.jsonl")) as f:
        steps = [json.loads(line)["attrs"]["step"] for line in f
                 if '"train/step"' in line]
    assert steps[-1] == 3
    with open(os.path.join(bundle, "report.txt")) as f:
        assert "reason:   node_death" in f.read()
    slo = report["slo_drill"]
    assert slo["fired"] and slo["breach_marker_on_timeline"]
    assert "slo_breach" in slo["bundle"]


@pytest.mark.parametrize("argv", [
    ["--autoscale-drill", "--preempt-drill", "1"],
    ["--disagg-drill", "--autoscale-drill"],
    ["--preempt-drill", "3", "--nodes", "3"],
    ["--device", "tpu"]], ids=["autoscale_preempt", "disagg_autoscale",
                              "preempt_all", "device"])
def test_refused_flag_combinations(fresh, tmp_path, argv):
    with pytest.raises(SystemExit) as err:
        torch_chaos_run.main(argv + ["--workdir", str(tmp_path)])
    assert err.value.code == 2
