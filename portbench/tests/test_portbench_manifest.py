"""BENCHMARK.json against the rules its format keeps, and a cell, a
configuration and a metric added as new files only."""

import json
import re
import shutil
import time

import pytest

from conftest import BENCH, ROOT, SERVE, SMALL
from harness import manifest, runner

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")
WIDTHS = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|projection|head")


@pytest.fixture(scope="module")
def m():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys_and_command(m):
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert m["command"] == ["python3", "portbench/run.py"] and m["paths"] == ["portbench"]
    assert 1 <= m["run_seconds"] <= 51 and isinstance(m["run_seconds"], int)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_configs_cells_and_names(m):
    configs = {c["name"]: c for c in m["configs"]}
    assert 1 <= len(configs) <= 24
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and LINE.match(c["source"]) and LINE.match(c["why"])
        assert c["source"].startswith("https://")
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).is_file()
        assert not any(WIDTHS.search(k) for k in c["reduced"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert (BENCH / "entries" / f"{cfg['entry']}.py").is_file()
    cells = m["workloads"]
    assert len({w["name"] for w in cells}) == len(cells)
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    assert {w["config"] for w in cells} == set(configs)
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert LINE.match(w["why"])
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert (BENCH / "limits" / f"{w['name']}.json").is_file()


def test_metrics_have_readers_and_every_cell_reports_enough(m):
    e2e = {e["name"]: e for e in m["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    names = [e["name"] for e in m["end_to_end"] + m["per_layer"]]
    assert len(set(names)) == len(names)
    for e in m["end_to_end"]:
        assert 0.01 <= e["bound"] <= 0.25 and e["source"] in ("host_clock", "device_trace")
    layers = {}
    for e in m["end_to_end"] + m["per_layer"]:
        assert NAME.match(e["name"]) and UNIT.match(e["unit"]) and e["better"] in (
            "lower", "higher")
        reader = manifest.metric_reader(e["name"])
        assert reader.UNIT == e["unit"] and callable(reader.read)
        if e in m["per_layer"]:
            assert set(e) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
            assert e["moves"] in e2e and LINE.match(e["layer"])
            assert reader.LAYER == e["layer"] and reader.MOVES == e["moves"]
            layers.setdefault(e["layer"].lower(), e["layer"])
            assert layers[e["layer"].lower()] == e["layer"]
            moved = e2e[e["moves"]].get("workloads")
            assert moved is None or set(e["workloads"]) <= set(moved)
            if e["name"].endswith("_roofline"):
                assert e["unit"] == "%"
    for w in m["workloads"]:
        cell = manifest.load_cell(w["name"], ROOT / "BENCHMARK.json")
        kinds = [x.kind for x in cell.metrics]
        assert "setup_s" in [x.name for x in cell.metrics]
        assert kinds.count("end_to_end") >= 2 and kinds.count("per_layer") >= 1


def test_a_full_check_fits(m):
    cells = 24
    total = (2 + 14 * cells) * (m["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert total <= 43200


def test_new_config_traffic_and_metric_are_found_by_name(tmp_path):
    """A later change adds files and manifest entries only: a configuration
    file, a traffic file, the cell's limits and a metric reader, and the
    harness runs the new cell (on the CPU, at test size) and reports the new
    metric."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "portbench", ignore=shutil.ignore_patterns("out",
                                                                             "__pycache__"))
    m = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((BENCH / "configs" / "sisec_dev1_sep.json").read_text())
    cfg.update(num_sources=2, num_iterations=10)
    (root / "portbench" / "configs" / "two_talkers.json").write_text(json.dumps(cfg))
    traffic = json.loads((BENCH / "traffic" / "batch16_60s_i16.json").read_text())
    traffic.update(SMALL["offline_separate_batches"])
    (root / "portbench" / "traffic" / "pairs_small.json").write_text(json.dumps(traffic))
    limits = json.loads((BENCH / "limits" / "sep_b16_60s_i16.json").read_text())
    (root / "portbench" / "limits" / "pairs_small.json").write_text(json.dumps(limits))
    (root / "portbench" / "metrics" / "offline.chunks_in_window.py").write_text(
        'UNIT = "chunks"\nLAYER = "entry points"\nMOVES = "audio_s_per_s.bf16"\n\n\n'
        'def read(rec):\n    return rec["offline"]["chunks"]\n')
    m["configs"].append(dict(name="two_talkers", source="https://example.org/two",
                             file="portbench/configs/two_talkers.json", reduced=[],
                             why="two talkers"))
    m["workloads"].append(dict(name="pairs_small", config="two_talkers", traffic="pairs_small",
                               chips=1, why="a test cell"))
    for e in m["end_to_end"]:
        if e["name"] == "audio_s_per_s.bf16":
            e["workloads"].append("pairs_small")
    m["per_layer"].append(dict(name="offline.chunks_in_window", unit="chunks", better="higher",
                               source="host_clock", layer="entry points",
                               moves="audio_s_per_s.bf16", workloads=["pairs_small"]))
    (root / "BENCHMARK.json").write_text(json.dumps(m))

    bench = root / "portbench"
    cell = manifest.load_cell("pairs_small", root / "BENCHMARK.json", bench)
    assert cell.config["num_sources"] == 2 and cell.traffic["batch"] == 2
    assert "offline.chunks_in_window" in [x.name for x in cell.metrics]
    line = runner.run_cell(cell, 5, 0.3, False, "cpu", time.perf_counter(), bench)
    assert line["correct"] and "audio_s_per_s.bf16" in line["metrics"]
    assert manifest.metric_reader("offline.chunks_in_window", bench).read(
        {"offline": {"chunks": 3}}) == 3
    assert list(line)[-1] == "compared"


def test_small_cells_run_and_report_on_the_cpu(small_cell):
    for name in ("sep_f32_b16_10s_i16", SERVE):
        cell = small_cell(name)
        line = runner.run_cell(cell, 2**31 + 99, 0.4, False, "cpu", time.perf_counter())
        assert line["correct"], line["compared"]
        e2e = {x.name for x in cell.metrics if x.kind == "end_to_end"}
        assert set(line["metrics"]) == e2e
        assert line["device"]["platform"] == "cpu"
