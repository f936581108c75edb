"""The control: the plain reference put in the program's place at the step
below the configuration's bfloat16 (float8 products) has to come out as not
correct. On the card at each cell's own size and load (three seeds, a
shorter window); on the CPU, at a reduced size, the mechanism: float8's
first tokens lie further below the reference's best than the bf16
program's served tokens do."""
import dataclasses

import pytest

from perfbench import check, harness, spec
from perfbench.tests.conftest import reduced_cell

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]
SEEDS = (2**31 + 101, 2**31 + 102, 2**31 + 103)


def _readings(cell, seeds, seconds, device, model=None):
    setup = harness.Setup(cell, seeds[0], device, model)
    for i, seed in enumerate(seeds):
        if i:
            setup.reseed(seed)
        engine = setup.engine()
        harness.warm(setup, engine, seconds)
        win = harness.serve(setup, engine, seconds, seed)
        served = [(r.prompt, list(r.req.output_tokens), r.done is not None)
                  for r in win.requests + win.lead]
        del engine
        harness.free(device)
        want = cell.params["check"]
        pick = check.sample(served, seed, want["requests"],
                            want["served_tokens"])
        yield check.gaps(setup.params, setup.file, served, pick,
                         control=True)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_on_the_card(name, card):
    cell = spec.cell(name)
    limits = cell.params["check"]["limits"]
    for got in _readings(cell, SEEDS, 15.0, "cuda"):
        assert all(got[k] <= v for k, v in limits.items()), got
        assert any(got["control_" + k] > v for k, v in limits.items()), got


@pytest.mark.parametrize("name", CELLS)
def test_control_reads_further_than_bf16_on_the_cpu(name):
    cell, model = reduced_cell(name)
    model = dataclasses.replace(model, param_dtype="bfloat16")
    for got in _readings(cell, SEEDS[:1], 2.0, "cpu", model):
        assert got["served_tokens"] > 0
        assert got["control_mean_logit_gap"] > got["mean_logit_gap"], got
