"""The harness end to end on the smoke presets through the port's eager
path on the CPU: a sound run is correct; the control and each fault the
cells can have are not; without a card ``run.py`` reports nothing."""

import json
import subprocess
import sys
import time

import pytest
import torch

import smoke
from harness import faults
from harness import main as hm
from harness.spec import Cell

SEED = 2**31 + 77          # seeds past 32 signed bits must work
# internlm2-summarize is not in BENCHMARK.json (PERF.md, Open questions);
# its files are, and the smoke root serves it as a cell
CELLS = ["mixtral-chat", "internlm2-summarize"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return smoke.make_root(tmp_path_factory.mktemp("bench"))


# long enough that requests are served wholly inside the window on a CPU
WINDOW_S = 6.0


def _run(root, name, trace=False, seconds=WINDOW_S):
    return hm.execute(Cell(root, name), SEED, seconds, trace, "cpu",
                      time.perf_counter())


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_a_sound_run_is_correct(root, name, trace):
    res = _run(root, name, trace)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    cell = Cell(root, name)
    want = {m["name"] for m in (cell.per_layer if trace
                                else cell.end_to_end)}
    got = set(res["metrics"])
    # a CPU run has no device kernels: no roofline to read
    assert got <= want and want - got <= {"lora_roofline"}
    if trace:
        assert res["device"]["window_s"] > 0
        assert "breakdown" in res


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_the_check(root, name):
    res = hm.execute(Cell(root, name), SEED, WINDOW_S, False, "cpu",
                     time.perf_counter(), control=True)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_each_fault_fails_the_check(root, name, fault):
    with faults.planted(fault):
        res = _run(root, name)
    assert not res["correct"], res["checks"]


def test_run_py_reports_nothing_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = subprocess.run(
        [sys.executable, str(smoke.BENCH / "run.py"), "--workload",
         "mixtral-chat", "--seed", "3", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=smoke.ROOT, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "no CUDA" in proc.stderr


def test_run_py_fails_outside_a_full_checkout(tmp_path):
    (tmp_path / "perfbench").mkdir()
    for name in ("run.py",):
        (tmp_path / "perfbench" / name).write_text(
            (smoke.BENCH / name).read_text())
    (tmp_path / "BENCHMARK.json").write_text(
        (smoke.ROOT / "BENCHMARK.json").read_text())
    proc = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "mixtral-chat",
         "--seed", "3", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=tmp_path, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_the_result_line_refuses_jax(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "jax", object())
    assert hm.emit({"checks": {}}) != 0
    assert capsys.readouterr().out == ""
    json.dumps({})


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["mixtral-chat"])
def test_a_short_run_on_the_card_is_correct(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = subprocess.run(
        [sys.executable, str(smoke.BENCH / "run.py"), "--workload", name,
         "--seed", str(SEED), "--seconds", "5", "--trace", "1"],
        capture_output=True, text=True, cwd=smoke.ROOT, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["busy_s"] > 0
