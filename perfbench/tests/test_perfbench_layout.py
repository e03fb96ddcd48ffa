"""Pieces are found by name, and a new cell, configuration, mix and metric
are added as new files and entries alone."""

import hashlib
import json
import shutil
import types

import pytest

import smoke
from harness import traffic
from harness.spec import Cell, read_metrics, reader


def _digest(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("name", ["mixtral-chat", "internlm2-summarize"])
def test_cells_resolve_to_their_files(tmp_path, name):
    # internlm2-summarize's files are kept; the smoke root lists the cell
    cell = Cell(smoke.make_root(tmp_path), name)
    assert cell.cfg["name"] == cell.entry["config"]
    assert cell.mix["name"] == cell.entry["traffic"]
    assert set(cell.limits) >= {"logit_gap", "delta_gap"}
    for m in cell.end_to_end + cell.per_layer:
        assert callable(reader(cell.bench, m["name"]))
    assert [m["name"] for m in cell.end_to_end][0] == "setup_s"
    assert "itl_p95_ms" in [m["name"] for m in cell.end_to_end]


def test_every_metric_and_cell_of_the_spec_has_its_file():
    spec = json.loads((smoke.ROOT / "BENCHMARK.json").read_text())
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert (smoke.BENCH / "metrics" / f"{m['name']}.py").is_file()
    for w in spec["workloads"]:
        assert (smoke.BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert (smoke.BENCH / "limits" / f"{w['name']}.json").is_file()
    for c in spec["configs"]:
        assert (smoke.ROOT / c["file"]).is_file()


def test_a_new_cell_config_mix_and_metric_are_files_alone(tmp_path):
    root = tmp_path / "root"
    root.mkdir()
    shutil.copytree(smoke.BENCH, root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(smoke.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    before = _digest(root / "perfbench")
    bench = root / "perfbench"
    cfg = json.loads((bench / "configs" / "internlm2-20b.json").read_text())
    cfg["name"] = "internlm2-20b-l4"
    cfg["num_hidden_layers"] = 4
    (bench / "configs" / "internlm2-20b-l4.json").write_text(json.dumps(cfg))
    mix = json.loads((bench / "traffic" / "chat-paged.json").read_text())
    mix["name"] = "chat-bursty"
    mix["arrival"]["rate_per_s"] = 9.0
    (bench / "traffic" / "chat-bursty.json").write_text(json.dumps(mix))
    (bench / "limits" / "internlm2-chat.json").write_text(
        json.dumps({"limits": {"logit_gap": 1.0, "delta_gap": 0.1}}))
    (bench / "metrics" / "rows_per_step.py").write_text(
        "def read(out):\n    return out.rows / out.steps\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "internlm2-20b-l4", "source": "x",
                            "file": "perfbench/configs/internlm2-20b-l4.json",
                            "reduced": ["num_hidden_layers"], "why": "x"})
    spec["workloads"].append({"name": "internlm2-chat",
                              "config": "internlm2-20b-l4",
                              "traffic": "chat-bursty", "chips": 1,
                              "why": "x"})
    spec["per_layer"].append({"name": "rows_per_step", "unit": "rows",
                              "better": "higher", "source": "program_span",
                              "layer": "x", "moves": "itl_p95_ms",
                              "workloads": ["internlm2-chat"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    cell = Cell(root, "internlm2-chat")
    assert cell.cfg["num_hidden_layers"] == 4
    assert cell.mix["arrival"]["rate_per_s"] == 9.0
    assert [m["name"] for m in cell.per_layer if m["name"] ==
            "rows_per_step"] == ["rows_per_step"]
    got = read_metrics(cell.bench, [m for m in cell.per_layer
                                    if m["name"] == "rows_per_step"],
                       types.SimpleNamespace(rows=128, steps=4))
    assert got == {"rows_per_step": {"value": 32.0, "unit": "rows"}}
    gen = traffic.Generator(cell.mix, cell.cfg["vocab_size"], 3)
    n = traffic.PAGE
    assert gen.get(n - 1).offset_s * 9.0 == pytest.approx(n, rel=0.2)
    after = _digest(bench)
    assert {k: v for k, v in after.items() if k in before} == before
