"""The harness on the CPU at tiny sizes: its files are found by name, the
window, percentile and metric arithmetic run, a run with the timed path
broken underneath comes out not correct, and the command refuses a machine
without a card."""

import json
import statistics
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from fembench import harness, run as frun, traffic

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
TINY = {"aniso_q4_r7": 2, "kershaw_q4": 0, "aniso_q4_r6": 2}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_every_file_is_found_by_name():
    for metric in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert frun.metric_file(metric["name"]).is_file()
    for cfg in BENCH["configs"]:
        data = json.loads((ROOT / cfg["file"]).read_text())
        published = json.loads((ROOT / data["published_file"]).read_text())
        assert sorted(data["changed"]) == sorted(cfg["reduced"])
        key = lambda k: k.replace("_", " ")  # the program's key of a size
        as_run = dict(published, **{key(k): v["run"]
                                    for k, v in data["changed"].items()})
        assert as_run == data["config"]
        for k, v in data["changed"].items():
            assert published[key(k)] == v["published"] and data[k] == v["run"]
        assert data["n_refinements"] == data["config"]["n refinements"]
        assert data["degree"] == data["config"]["degree"]
        assert data["n_dofs"] == harness.reference(data).n_dofs(data["config"])
        assert len(data["source"]) <= 200 and data["source"] == cfg["source"]
    for name in CELLS:
        cell = harness.load_cell(name)
        assert set(cell["workload"]["limits"]) == {"residual_gap", "vcycle_gap"}
        assert cell["traffic"] == traffic.load(cell["cell"]["traffic"])
        assert "setup_s" in cell["end_to_end"] and cell["per_layer"]


def test_percentile_is_the_inclusive_quantile():
    values = [0.3, 0.1, 0.2, 0.5, 0.4, 0.25, 0.35, 0.15, 0.45, 0.05, 0.33]
    q = statistics.quantiles(values, n=10, method="inclusive")[8]
    assert harness.percentile(values, 90) == pytest.approx(q)


def test_right_hand_sides_are_the_seeds_and_zero_on_the_boundary():
    spec = traffic.load("smooth_rhs8")
    big = 2 ** 31 + 977
    a = traffic.RightHandSides(spec, big, (4, 4, 4), 2, "cpu")
    b = traffic.RightHandSides(spec, big, (4, 4, 4), 2, "cpu")
    c = traffic.RightHandSides(spec, big + 1, (4, 4, 4), 2, "cpu")
    assert torch.equal(a(3), b(3)) and not torch.equal(a(3), c(3))
    g = a(5).reshape(9, 9, 9)
    for face in (g[0], g[-1], g[:, 0], g[:, -1], g[:, :, 0], g[:, :, -1]):
        assert float(face.abs().max()) == 0.0
    assert a.count == spec["right_hand_sides"]


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_a_tiny_run_is_correct_and_reports_its_metrics(tiny_cell, name, trace):
    cell = tiny_cell(name, TINY[name])
    rec = frun.measure(cell, 2 ** 31 + 5, 0.3, bool(trace), device="cpu")
    line = frun.result(cell, rec, bool(trace), {"platform": "cpu"})
    assert line["correct"], line["checks"]
    names = cell["per_layer"] if trace else cell["end_to_end"]
    if trace:  # no device trace on the CPU: the shares have nothing to read
        names = [n for n in names if n.split(".")[0] != "idle_share"]
    assert set(names) <= set(line["metrics"])
    w = rec["window"]
    assert line["attempted"] == len(w["seconds"]) >= cell["traffic"][
        "right_hand_sides"]
    # each right-hand side counted once: the seed fixes the iterations
    assert rec["rhs_iterations"] == dict(enumerate(
        w["iterations"][:cell["traffic"]["right_hand_sides"]]))
    if trace:
        key = next(n for n in names if n.split(".")[0] == "iterations")
        assert line["metrics"][key]["value"] == pytest.approx(
            sum(rec["rhs_iterations"].values()) / len(rec["rhs_iterations"]))
    else:
        key = next(n for n in names if n.split(".")[0] == "solve_s")
        assert line["metrics"][key]["value"] == pytest.approx(
            sum(w["seconds"]) / len(w["seconds"]))
    assert list(line)[-1] == "checks"


def _broken_run(tiny_cell, monkeypatch, name, patch):
    cell = tiny_cell(name, TINY[name])
    real = harness.set_up

    def set_up(config, device):
        prog = real(config, device)
        patch(prog)
        return prog

    monkeypatch.setattr(harness, "set_up", set_up)
    rec = frun.measure(cell, 11, 0.2, False, device="cpu")
    return frun.result(cell, rec, False, {"platform": "cpu"})


@pytest.mark.parametrize("name", CELLS)
def test_an_altered_answer_is_not_correct(tiny_cell, monkeypatch, name):
    def patch(prog):
        solve = prog.solve

        def altered(b):
            r = solve(b)
            r.x = r.x.clone()
            r.x[r.x.numel() // 2] += 1e-3 * float(r.x.abs().max())
            return r

        prog.solve = altered

    line = _broken_run(tiny_cell, monkeypatch, name, patch)
    assert not line["correct"]
    gap = line["checks"]["residual_gap"]
    assert gap["value"] > gap["limit"]


@pytest.mark.parametrize("name", CELLS)
def test_a_vcycle_returning_its_input_is_not_correct(tiny_cell, monkeypatch, name):
    def patch(prog):
        prog.M = lambda v: v.clone()

    line = _broken_run(tiny_cell, monkeypatch, name, patch)
    assert not line["correct"]
    gap = line["checks"]["vcycle_gap"]
    assert gap["value"] > gap["limit"]


def test_the_command_refuses_a_machine_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for machines without one")
    out = subprocess.run([sys.executable, "-m", "fembench.run", "--workload",
                          CELLS[0], "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 2 and out.stdout == ""


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_a_short_run_on_the_card_is_correct(cuda_device, name):
    out = subprocess.run([sys.executable, "-m", "fembench.run", "--workload",
                          name, "--seed", "4242", "--seconds", "5",
                          "--trace", "0"], cwd=ROOT, capture_output=True,
                         text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.splitlines()[-1])["correct"]
