"""The benchmark's tests: on the CPU at reduced sizes, and, marked
``cuda``, on the card (``python -m pytest perfbench/tests`` from the
checkout's root)."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


@pytest.fixture(autouse=True, scope="session")
def one_thread():
    """One intra-op thread per test process: the CPU rehearsals serve on
    the wall clock, and workers that oversubscribe the cores would starve
    their windows of steps."""
    import torch
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def card():
    """Skips the test where there is no CUDA device."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def reduced_cell(name):
    """The cell with the program's reduced model and its traffic cut to
    what the CPU serves in seconds: prompts up to 128 tokens, outputs up to
    16, 8 clients of 8 rounds, a lead-in of 1 s."""
    from perfbench import spec
    from repro_torch.config import ModelConfig
    cell = spec.cell(name)
    cell.traffic = dict(cell.traffic,
                        prompt=dict(cell.traffic["prompt"], max=128),
                        output=dict(cell.traffic["output"], min=2, max=16))
    cell.params = dict(cell.params, rate_per_s=4.0, clients=8, rounds=8,
                       lead_in_s=1.0,
                       warmup=dict(cell.params["warmup"], requests=4))
    model = ModelConfig(**spec.model_kwargs(cell.config,
                                            cell.config_name)).reduced()
    return cell, model


def run_cpu(name=None, seed=2**31 + 11, trace=False, seconds=4.0,
            cell=None):
    """One run of the cell on the CPU through the harness's own entry
    (``cell``: a (cell, model) pair in place of a named one)."""
    import time

    from perfbench import cellrun
    cell, model = cell or reduced_cell(name)
    logs = []
    line = cellrun.run(cell, seed, seconds, trace, "cpu",
                       time.perf_counter(), lambda **kw: logs.append(kw),
                       model)
    return line, logs


def moe_cell():
    """The moe configuration (``configs/qwen3-moe.json``) under the batch
    mix, as a cell that ``BENCHMARK.json`` does not hold (its program drops
    prompt tokens that the published model routes), reduced as
    ``reduced_cell`` reduces, in float32: the harness and the reference's
    moe path on the CPU."""
    import dataclasses

    from perfbench import spec
    from repro_torch.config import ModelConfig
    conf = spec.load_json(spec.HERE / "configs" / "qwen3-moe.json")
    mix = spec.load_json(spec.HERE / "traffic" / "batch.json")
    bench = spec.benchmark()
    cell = spec.Cell(
        name="qwen3-moe.batch", chips=1, config_name="qwen3-moe",
        config=conf, traffic_name="batch",
        traffic=dict(mix, prompt=dict(mix["prompt"], max=48),
                     output=dict(mix["output"], min=2, max=12)),
        params={"clients": 4, "rounds": 16, "lead_in_s": 0.5,
                "warmup": {"requests": 2, "output_tokens": 2},
                "check": {"requests": 4, "served_tokens": 40,
                          "limits": {"max_logit_gap": 0.01}}},
        end_to_end=[m for m in bench["end_to_end"]
                    if m["name"] == "setup_s"],
        per_layer=[])
    model = ModelConfig(**spec.model_kwargs(conf, "qwen3-moe")).reduced()
    return cell, dataclasses.replace(model, param_dtype="float32")
