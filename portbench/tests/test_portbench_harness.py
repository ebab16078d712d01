"""The harness's own guards: no card, no program, files found by name."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import spec

ROOT = Path(__file__).resolve().parents[1]
REPO = ROOT.parent
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())


def run_cli(cwd: Path, env_change: dict, workload: str = "live.single"):
    env = dict(os.environ, **env_change)
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", workload, "--seed", "2147483659",
         "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_no_card_exits_nonzero_and_prints_no_result():
    """Without a CUDA card the run fails before any step: it never falls
    back to the CPU."""
    res = run_cli(REPO, {"CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode != 0
    assert res.stdout.strip() == ""
    assert "needs 1 CUDA device" in res.stderr


def test_without_the_program_exits_nonzero(tmp_path):
    """A directory that holds only BENCHMARK.json and the benchmark's folder."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    for p in BENCH["paths"]:
        shutil.copytree(REPO / p, tmp_path / p, ignore=shutil.ignore_patterns("__pycache__"))
    res = run_cli(tmp_path, {})
    assert res.returncode != 0
    assert res.stdout.strip() == ""
    assert "trackdlo_tpu_torch" in res.stderr


def test_every_named_file_is_found():
    found = spec.listing()
    assert sorted(found["configs"]) == sorted(c["name"] for c in BENCH["configs"])
    assert sorted(found["workloads"]) == sorted(w["name"] for w in BENCH["workloads"])
    assert sorted(found["metrics"]) == sorted(m["name"] for m in BENCH["per_layer"])
    for c in BENCH["configs"]:
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert c["reduced"] == []


def test_files_dropped_into_a_copy_are_found_without_editing_others(tmp_path):
    """A new configuration, traffic mix, cell and per-layer metric: files
    and BENCHMARK.json entries only."""
    root = tmp_path / "portbench"
    shutil.copytree(ROOT, root, ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    cfg = json.loads((root / "configs" / "live.json").read_text())
    cfg["tracker"]["num_of_nodes"] = 50
    (root / "configs" / "live50.json").write_text(json.dumps(cfg))
    (root / "traffic" / "still.json").write_text(json.dumps(
        dict(json.loads((root / "traffic" / "rope_band.json").read_text()), rope={"speed": 0.0})))
    (root / "workloads" / "live50.still.json").write_text(
        (root / "workloads" / "live.single.json").read_text())
    (root / "metrics" / "em.main_trips.py").write_text(
        "def read(ctx):\n    return sum(f['iterations'] for f in ctx.frames) / len(ctx.frames)\n")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append(dict(bench["configs"][0], name="live50",
                                 file="portbench/configs/live50.json"))
    bench["workloads"].append({"name": "live50.still", "config": "live50", "traffic": "still",
                               "chips": 1, "why": "a still rope"})
    bench["per_layer"].append({"name": "em.main_trips", "unit": "trips", "better": "lower",
                               "source": "program_counter", "layer": "EM",
                               "moves": "frame_ms_p50", "workloads": ["live50.still"]})
    found = spec.listing(root, bench)
    assert "live50" in found["configs"] and found["configs"]["live50"]["tracker"]["num_of_nodes"] == 50
    assert "live50.still" in found["workloads"] and "still" in found["traffic"]
    assert "em.main_trips" in found["metrics"]
    cell = spec.cell("live50.still", root, bench)
    assert cell["config_file"]["tracker"]["num_of_nodes"] == 50
    assert cell["traffic_file"]["rope"] == {"speed": 0.0}
    assert "em.main_trips" in [m["name"] for m in cell["per_layer"]]
    assert {p: p.read_bytes() for p in before} == before  # nothing there was edited


def test_metric_scoping_follows_each_metrics_workloads():
    single = [m["name"] for m in spec.cell("live.single")["per_layer"]]
    batched = [m["name"] for m in spec.cell("live.b16c8")["per_layer"]]
    assert "kernel.em_loop.roofline_pct" in single and "kernel.em_loop.roofline_pct" not in batched
    assert "em.lockstep_tax" in batched and "em.lockstep_tax" not in single
    for name in ("live.single", "eval.single"):
        assert [m["name"] for m in spec.cell(name)["end_to_end"]] == [
            "stream_frames_per_s", "frame_ms_p50", "frame_ms_p95", "setup_s"]
    assert [m["name"] for m in spec.cell("live.b16c8")["end_to_end"]] == [
        "stream_frames_per_s", "frame_ms_p50", "setup_s"]


def test_traced_run_on_the_cpu_leaves_out_what_it_cannot_read():
    """A CPU run of the traced path (the harness's look for a card skipped):
    no device events, so every trace-read metric is left out, the counted
    ones stay, and the check still decides ``correct``."""
    from portbench import run

    cell = spec.cell("live.single")
    cell["cell"].update(trace_calls=3, warmup_calls=1)
    cell["cell"]["check"].update(calls=1, streams=1)
    cell["traffic_file"].update(film_frames=6, positions=6)
    result, lines = run.run(cell, 2 ** 32 + 5, 1.0, True, device="cpu")
    assert set(result["metrics"]) == {"em.trips_per_frame"}
    assert result["correct"] is True
    assert list(result)[-1] == "checks" and lines[-1].startswith("check sigma2_rel")
    assert result["device"]["window_s"] > 0


@pytest.mark.cuda
def test_card_run_prints_one_result_line():
    """On a card: one run of the first cell through the command line."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    res = run_cli(REPO, {}, "live.single")
    assert res.returncode == 0, res.stderr[-2000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
    assert set(line["metrics"]) == {"stream_frames_per_s", "frame_ms_p50", "frame_ms_p95",
                                    "setup_s"}
