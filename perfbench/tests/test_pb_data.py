"""BENCHMARK.json keeps to the contract's shapes, and the harness finds a
cell, a configuration, a mix and a metric added as new files by name."""
import hashlib
import json
import shutil

import pytest

from perfbench import spec, traffic

BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def _names():
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[key]:
            yield e["name"]
    for w in BENCH["workloads"]:
        yield w["config"]
        yield w["traffic"]
    for c in BENCH["configs"]:
        yield from c["reduced"]


@pytest.mark.parametrize("name", sorted(set(_names())))
def test_names_use_allowed_characters(name):
    assert spec.NAME_RE.match(name), name


def _files():
    for path in sorted(spec.HERE.rglob("*")):
        if path.is_file() and "__pycache__" not in path.parts:
            yield str(path.relative_to(spec.ROOT))


@pytest.mark.parametrize("path", list(_files()))
def test_file_names_use_allowed_characters(path):
    """A file under the benchmark's paths is named from a name's
    characters and '/'."""
    assert all(spec.NAME_RE.match(part) for part in path.split("/")), path


def test_units_and_lines():
    for e in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert spec.UNIT_RE.match(e["unit"]), e
        assert e["better"] in ("lower", "higher")
    for e in BENCH["workloads"] + BENCH["configs"]:
        assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"], e["name"]
    for e in BENCH["per_layer"]:
        assert 1 <= len(e["layer"]) <= 200
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_bounds_and_sources():
    for e in BENCH["end_to_end"]:
        assert 0.01 <= e["bound"] <= 0.25
        assert e["source"] in ("host_clock", "device_trace")
    assert any(e["name"] == "setup_s" for e in BENCH["end_to_end"])
    for e in BENCH["per_layer"]:
        assert e["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


@pytest.mark.parametrize("name", CELLS)
def test_cell_reports_what_it_must(name):
    cell = spec.cell(name)
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e, (m["name"], m["moves"])
        assert callable(spec.metric_reader(m["name"]))
    assert cell.chips == 1


def test_every_config_used_and_its_file_under_paths():
    used = {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert used == {c["name"] for c in BENCH["configs"]}
    assert len(set(files)) == len(files)
    for f in files:
        assert any(f.startswith(p + "/") for p in BENCH["paths"])
        assert (spec.ROOT / f).is_file()


def test_pairs_are_unique():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)


def _digest(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file()}


def test_new_cell_config_mix_and_metric_found_by_name(tmp_path):
    root = tmp_path / "checkout"
    here = root / "perfbench"
    shutil.copytree(spec.HERE, here,
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    before = _digest(here)

    cfg = spec.load_json(here / "configs" / "mistral-24b.json")
    (here / "configs" / "toy-dense.json").write_text(json.dumps(
        dict(cfg, num_hidden_layers=2)))
    (here / "traffic" / "toy-mix.json").write_text(json.dumps(
        {"loop": "open", "shape_seed": 1,
         "arrivals": {"process": "gamma", "cv": 1.0},
         "prompt": {"dist": "uniform", "min": 8, "max": 16},
         "output": {"dist": "uniform", "min": 1, "max": 4}}))
    (here / "workloads" / "toy-dense.toy-mix.json").write_text(json.dumps(
        {"rate_per_s": 1.0, "lead_in_s": 0.0, "warmup": {"requests": 1, "output_tokens": 1},
         "check": {"requests": 1, "served_tokens": 1,
                   "limits": {"max_logit_gap": 1.0}}}))
    (here / "metrics" / "toy_metric.py").write_text(
        "def read(win, name):\n    return 42.0\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "toy-dense", "source": "a paper",
                             "file": "perfbench/configs/toy-dense.json",
                             "reduced": ["num_hidden_layers"], "why": "toy"})
    bench["workloads"].append({"name": "toy-dense.toy-mix",
                               "config": "toy-dense", "traffic": "toy-mix",
                               "chips": 1, "why": "toy"})
    bench["per_layer"].append({"name": "toy_metric.x", "unit": "ms",
                               "better": "lower", "source": "program_span",
                               "layer": "engine", "moves": "setup_s",
                               "workloads": ["toy-dense.toy-mix"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.cell("toy-dense.toy-mix", root=root, here=here)
    assert cell.config["num_hidden_layers"] == 2
    assert cell.traffic["shape_seed"] == 1
    assert [m["name"] for m in cell.per_layer] == ["toy_metric.x"]
    assert spec.metric_reader("toy_metric.x", here)(None, "toy_metric.x") \
        == 42.0
    items = traffic.open_schedule(cell.traffic, 1.0, 10.0)
    assert len(items) == 10 and all(8 <= i.prompt_len <= 16 for i in items)
    after = _digest(here)
    assert all(after[k] == v for k, v in before.items())


@pytest.mark.parametrize("name", CELLS)
def test_traffic_is_the_same_for_every_seed(name):
    cell = spec.cell(name)
    mix, p = cell.traffic, cell.params
    if mix["loop"] == "open":
        lead = p["lead_in_s"]
        items = traffic.open_schedule(mix, p["rate_per_s"], 30.0, lead)
        due = [i.due for i in items]
        assert due == sorted(due) and -lead < due[0] and due[-1] < 30.0
        assert len(items) == round(p["rate_per_s"] * (lead + 30.0))
    else:
        first, rest = traffic.closed_plan(mix, p["clients"], p["rounds"])
        assert len(first) == p["clients"]
        assert len(rest) == p["clients"] * (p["rounds"] - 1)
        full = [i.output_len for i in rest]
        assert min(full) >= mix["output"]["min"]
        # each first request is under way: what it has served is context
        assert all(i.output_len < mix["output"]["max"] for i in first)
        assert max(i.prompt_len for i in first) > mix["prompt"]["max"]
    lo, hi = mix["prompt"]["min"], mix["prompt"]["max"]
    if mix["loop"] == "closed":   # a first request's served context
        hi += mix["output"]["max"]
    sizes = traffic.sizes(mix, p, 30.0)
    assert all(lo <= a <= hi for a, _ in sizes)
    assert traffic.sizes(mix, p, 30.0) == sizes
    a = traffic.tokens(1, [5, 7], 100)
    b = traffic.tokens(2**31 + 17, [5, 7], 100)
    assert [len(x) for x in a] == [5, 7] and a != b
