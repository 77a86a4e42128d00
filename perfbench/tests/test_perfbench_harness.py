"""The harness finds everything by name: a configuration, a traffic mix, a
cell's limits and a metric added as new files are run with no existing
file edited; every cell of ``BENCHMARK.json`` resolves; every metric names
its layer and the end-to-end metric it moves, which each of its cells
reports; the manifest keeps to the benchmark's contract."""
from __future__ import annotations

import hashlib
import json
import re
import shutil
from pathlib import Path

import pytest

from perfbench.harness import Bench, execute
from perfbench.tests.tinyroot import cpu_run, make_root

REPO = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def manifest():
    return json.loads((REPO / "BENCHMARK.json").read_text())


def digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_files_are_found_by_name(tmp_path):
    """A later change adds a configuration, a mix, limits and a metric as
    files of their own and entries in the manifest: the run finds them, and
    no file the benchmark had is edited."""
    root = make_root(tmp_path)
    pb = root / "perfbench"
    before = digest(pb)
    cfg = json.loads((pb / "configs" / "tiny-lstm.json").read_text())
    cfg.update(name="tiny-lstm-z32", Z=32)
    (pb / "configs" / "tiny-lstm-z32.json").write_text(json.dumps(cfg))
    mix = json.loads((pb / "traffic" / "steady.json").read_text())
    mix["sample_every"] = 2
    (pb / "traffic" / "dense.json").write_text(json.dumps(mix))
    (pb / "limits" / "tiny-lstm-z32.dense.json").write_text(json.dumps(
        {"forecast_gap_std": 1e-4, "decisions_differing": 0}))
    (pb / "metrics" / "ticks_per_s.py").write_text(
        "def read(run):\n"
        "    r = run.record\n"
        "    return r['ticks'] / r['window_s'] if r.get('ticks') else None\n")
    m = json.loads((root / "BENCHMARK.json").read_text())
    m["configs"].append({"name": "tiny-lstm-z32", "source": cfg["source"],
                         "file": "perfbench/configs/tiny-lstm-z32.json",
                         "reduced": ["Z"], "why": "test"})
    m["workloads"].append({"name": "tiny-lstm-z32.dense",
                           "config": "tiny-lstm-z32", "traffic": "dense",
                           "chips": 1, "why": "test"})
    m["end_to_end"].append({"name": "ticks_per_s", "unit": "ticks/s",
                            "better": "higher", "bound": 0.25,
                            "source": "host_clock",
                            "workloads": ["tiny-lstm-z32.dense"]})
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    run = cpu_run(root, "tiny-lstm-z32.dense", seconds=0.5)
    out = execute(run)
    assert out["correct"], out
    assert out["metrics"]["ticks_per_s"]["value"] > 0
    assert set(out["metrics"]) == {"ticks_per_s", "setup_s"}
    after = digest(pb)
    assert all(after[k] == v for k, v in before.items())
    assert run.cell.cfg["Z"] == 32 and run.record["checked_ticks"] > 0


def test_every_cell_resolves():
    b = Bench(REPO)
    for w in b.manifest["workloads"]:
        cell = b.cell(w["name"])
        assert cell.limits, w["name"]
        b.loop(cell)
        b.reference(cell)


def test_every_metric_names_its_layer_and_a_reported_end_to_end_metric():
    m = manifest()
    cells = {w["name"] for w in m["workloads"]}
    e2e = {e["name"]: set(e.get("workloads", cells)) for e in m["end_to_end"]}
    assert all(cells <= e2e["setup_s"] for _ in [0])
    for cell in cells:
        assert any(cell in ws for n, ws in e2e.items() if n != "setup_s"), \
            cell
        assert any(cell in p.get("workloads", cells)
                   for p in m["per_layer"]), cell
    for p in m["per_layer"]:
        assert p["layer"].strip() and "\n" not in p["layer"]
        assert p["moves"] in e2e, p["name"]
        ws = set(p.get("workloads", cells))
        assert ws and ws <= cells and ws <= e2e[p["moves"]], p["name"]
    for metric in list(m["end_to_end"]) + list(m["per_layer"]):
        assert (REPO / "perfbench" / "metrics"
                / f"{metric['name']}.py").is_file()


def test_layer_names_agree_letter_for_letter():
    m = manifest()
    perf = (REPO / "PERF.md").read_text()
    for p in m["per_layer"]:
        assert p["layer"] in perf, p["layer"]


def test_manifest_keeps_to_the_contract():
    m = manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= m["run_seconds"] <= 51
    cells = m["workloads"]
    assert 1 <= len(cells) <= 24 and 1 <= len(m["configs"]) <= 24
    assert all(w["chips"] in (1, 4) for w in cells)
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)
    names = [x["name"] for x in m["configs"]] + [w["name"] for w in cells] \
        + [x["name"] for x in m["end_to_end"] + m["per_layer"]]
    for n in names + [w["traffic"] for w in cells]:
        assert NAME.match(n), n
    used = {w["config"] for w in cells}
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert c["file"].startswith("perfbench/")
        assert (REPO / c["file"]).is_file()
        assert len(c["reduced"]) <= 16
    pairs = [(w["config"], w["traffic"]) for w in cells]
    assert len(pairs) == len(set(pairs))
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    assert any(e["name"] == "setup_s" for e in m["end_to_end"])
    for e in m["end_to_end"]:
        assert set(e) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= e["bound"] <= 0.25
        assert e["source"] in ("host_clock", "device_trace")
    for p in m["per_layer"]:
        assert set(p) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert p["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for x in m["end_to_end"] + m["per_layer"]:
        assert UNIT.match(x["unit"]) and x["better"] in ("lower", "higher")
    for x in m["per_layer"]:
        if x["name"].endswith("_roofline") or "mfu" in x["name"]:
            assert x["unit"] == "%"
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    for p in m["paths"]:
        assert (REPO / p).is_dir() and not p.endswith("_torch")
    assert m["command"][1].startswith("perfbench/")


@pytest.mark.parametrize("cell", [w["name"] for w in
                                  json.loads((REPO / "BENCHMARK.json")
                                             .read_text())["workloads"]])
def test_a_cell_without_its_program_fails_to_run(tmp_path, cell):
    """A directory with only the manifest and the benchmark's files holds
    no program: the loop's import of it fails, so no result is
    printed."""
    shutil.copytree(REPO / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    b = Bench(tmp_path)
    src = b.loop(b.cell(cell)).__file__
    text = Path(src).read_text()
    assert "repro_torch" in text


def test_training_cuts_are_listed_in_reduced():
    """A configuration whose cells train states the batch they run as
    ``train_batch`` (a cut of the source's recipe) and lists it, with the
    random weights, in the manifest's ``reduced``."""
    b = Bench(REPO)
    for w in b.manifest["workloads"]:
        cell = b.cell(w["name"])
        if cell.mix["loop"] != "train_steps":
            continue
        c = next(c for c in b.manifest["configs"] if c["name"] == cell.config)
        assert cell.mix["batch"] == cell.cfg["train_batch"], w["name"]
        assert {"train_batch", "weights"} <= set(c["reduced"]), w["name"]
        assert all(k in cell.cfg for k in c["reduced"]), w["name"]
