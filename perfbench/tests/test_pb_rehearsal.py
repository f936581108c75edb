"""The harness serves each cell's traffic on the CPU at reduced sizes, its
result line has the contract's keys, and the command gives no result where
there is no card or no program."""
import os
import shutil
import subprocess
import sys

import pytest

from perfbench import spec
from perfbench.tests.conftest import run_cpu

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_plain_run_line(name):
    line, logs = run_cpu(name)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True
    assert line["attempted"] > 0 and line["failed"] == 0
    cell = spec.cell(name)
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    for m in cell.end_to_end:
        assert line["metrics"][m["name"]]["unit"] == m["unit"]
        assert line["metrics"][m["name"]]["value"] > 0
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert set(line["checks"]) == set(cell.params["check"]["limits"])
    assert all(c["value"] <= c["limit"] for c in line["checks"].values())
    assert any("served_tokens" in kw for kw in logs)


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_line(name):
    line, _ = run_cpu(name, trace=True)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "breakdown", "checks"]
    cell = spec.cell(name)
    names = {m["name"] for m in cell.per_layer}
    assert set(line["metrics"]) <= names
    # the readers that need only the harness's spans read something here
    spans = {n for n in names if n.split(".")[0] in (
        "engine_host_ms", "decode_step_ms", "decode_batch_mean", "mfu")}
    assert spans <= set(line["metrics"])
    assert line["device"]["busy_s"] > 0 and line["device"]["window_s"] > 0
    bd = line["breakdown"]
    assert 0 < len(bd["device_ops"]) <= 10 and len(bd["idle_gaps"]) <= 10


def _env():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    return env


def test_command_without_a_card_gives_no_result():
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1", "--trace",
                        "0"], cwd=spec.ROOT, env=_env(), capture_output=True,
                       text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""


def test_without_the_program_nothing_runs(tmp_path):
    shutil.copytree(spec.HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    code = ("import sys; sys.path.insert(0, '.');"
            "from perfbench import harness, spec;"
            f"harness.Setup(spec.cell({CELLS[0]!r}), 1, 'cpu')")
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                       env=_env(), capture_output=True, text=True,
                       timeout=120)
    assert p.returncode != 0 and "repro_torch" in p.stderr


def test_engine_is_freed_after_the_window():
    """The reference runs after the window on what the program's state
    leaves free: the pool has to go with the engine."""
    import weakref

    from perfbench import harness
    from perfbench.tests.conftest import reduced_cell
    cell, model = reduced_cell(CELLS[0])
    setup = harness.Setup(cell, 5, "cpu", model)
    engine = setup.engine()
    harness.warm(setup, engine, 2.0)
    pool = weakref.ref(engine.executor.pool["k"])
    harness.serve(setup, engine, 2.0, 5)
    del engine
    harness.free("cpu")
    assert pool() is None


def test_open_loop_opens_on_a_loaded_engine():
    """The lead-in's requests (due before 0) are served before the window,
    stay out of its tails, and the window's own are all due inside it."""
    from perfbench import harness
    from perfbench.tests.conftest import reduced_cell
    cell, model = reduced_cell(CELLS[0])
    setup = harness.Setup(cell, 7, "cpu", model)
    engine = setup.engine()
    harness.warm(setup, engine, 3.0)
    win = harness.serve(setup, engine, 3.0, 7)
    assert win.lead and all(r.due < 0 for r in win.lead)
    assert win.requests and all(0 <= r.due < 3.0 for r in win.requests)
    assert all(s.t0 >= 0 for s in win.steps)
    assert any(r.seen for r in win.lead)


def test_closed_loop_on_the_cpu():
    """A closed loop (the batch mix) through the same harness: its clients'
    first requests are under way, primed before the window, and each
    completion sends the client's next request."""
    from perfbench import harness, traffic
    from perfbench.tests.conftest import reduced_cell
    cell, model = reduced_cell(CELLS[0])
    mix = spec.load_json(spec.HERE / "traffic" / "batch.json")
    cell.traffic = dict(mix, prompt=dict(mix["prompt"], max=64),
                        output=dict(mix["output"], min=2, max=12))
    cell.params = dict(cell.params, clients=4, rounds=16, lead_in_s=0.5)
    setup = harness.Setup(cell, 9, "cpu", model)
    engine = setup.engine()
    harness.warm(setup, engine, 2.0)
    win = harness.serve(setup, engine, 2.0, 9)
    first, _ = traffic.closed_plan(cell.traffic, 4, 16)
    assert len(win.lead) >= len(first)
    assert [len(r.prompt) for r in win.lead[:4]] == \
        [i.prompt_len for i in first]
    assert win.requests and harness.end_to_end(win)["output_tokens_per_s"] > 0


def test_moe_path_is_correct_on_the_cpu():
    """The moe configuration's closed loop, served on the CPU in float32
    at prompts the program routes without drops, matches the reference's
    moe path."""
    from perfbench.tests.conftest import moe_cell
    line, logs = run_cpu(cell=moe_cell())
    got = next(kw for kw in logs if "served_tokens" in kw)
    assert got["served_tokens"] > got["sampled_requests"], got
    assert line["correct"] is True, line["checks"]
