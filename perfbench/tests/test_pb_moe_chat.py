"""The qwen3-moe.chat cell on the CPU at the program's reduced size: its
rehearsal is correct with prompts past 64 tokens, where the port's serving
capacity once dropped routed rows, and with that capacity rule put back the
cell's check sees the drops; the grouped kernel's roofline reader against a
hand-counted step."""
import pytest

from perfbench import harness, spec
from perfbench.tests.conftest import run_cpu

CELL = "qwen3-moe.chat"


def _old_capacity(monkeypatch):
    """The serving capacity the port had before it served dropless: cap = n
    up to 64 tokens, else twice the even share, at least 16."""
    from repro_torch.models import moe
    rule = moe.capacity

    def old(n, k, e, capacity_factor):
        if capacity_factor is None and n > 64:
            return min(n, max(16, -((-n * k * 2) // e)))
        return rule(n, k, e, capacity_factor)
    monkeypatch.setattr(moe, "capacity", old)


def _served_prompts(logs):
    return next(kw for kw in logs if "served_tokens" in kw)


def test_rehearsal_is_correct_past_64_tokens():
    from perfbench.tests.conftest import reduced_cell
    cell, model = reduced_cell(CELL)
    assert model.family == "moe" and cell.traffic["prompt"]["max"] > 64
    line, logs = run_cpu(CELL)
    got = _served_prompts(logs)
    assert got["served_tokens"] > got["sampled_requests"], got
    assert line["correct"] is True, line["checks"]
    counters = next(kw for kw in logs if "prefill_computes" in kw)
    assert counters["prefill_computes"] > 0


def test_old_capacity_rule_is_not_correct(monkeypatch):
    _old_capacity(monkeypatch)
    line, logs = run_cpu(CELL)
    assert line["correct"] is False, line["checks"]
    assert any(c["value"] > c["limit"] for c in line["checks"].values())


def _reader():
    return spec.metric_reader("moe_grouped_roofline.moe_chat")


def _module():
    import importlib
    return importlib.import_module("perfbench.metrics.moe_grouped_roofline")


def test_roofline_bound_of_a_hand_counted_step():
    """One decode pass of 45 sequences and one prefill of 740 tokens at
    Qwen3-30B-A3B's sizes (48 layers, d 2048, f 768, k 8): the decode call
    is bound by bytes, the prefill call by operations."""
    m = _module()
    cfg = spec.cell(CELL).config
    d, f, k, layers = 2048, 768, 8, 48
    assert (cfg["hidden_size"], cfg["moe_intermediate_size"],
            cfg["num_experts_per_tok"], cfg["num_hidden_layers"]) == \
        (d, f, k, layers)
    weights = 2 * k * 3 * d * f                       # 75 497 472 bytes
    dec_bytes = weights + 2 * 2 * 360 * d             # 360 rows in and out
    dec_ops = 6 * d * f * 360
    assert m.call_bytes_ops(360, k, d, f) == (dec_bytes, dec_ops)
    pre_ops = 6 * d * f * 5920
    dec_s, pre_s = dec_bytes / 3.35e12, pre_ops / 989e12
    assert dec_s > dec_ops / 989e12 and pre_s > (weights + 4 * 5920 * d) \
        / 3.35e12
    steps = [harness.Step(t0=0.0, decode_seqs=45),
             harness.Step(t0=1.0, decode_seqs=45, prefills=(740,))]
    want = layers * (2 * dec_s + pre_s)
    assert m.window_bound_s(cfg, steps) == pytest.approx(want, rel=1e-12)


def test_roofline_share_is_100_at_the_bound():
    m = _module()
    cell = spec.cell(CELL)
    steps = [harness.Step(t0=0.0, decode_seqs=45, prefills=(740, 12))]
    bound = m.window_bound_s(cell.config, steps)
    trace = harness.Trace(busy_s=bound, window_s=51.0, intervals=[],
                          kernels={"void (anonymous namespace)::grouped_bf16"
                                   "<true>(...)": [0.75 * bound, 48],
                                   "void (anonymous namespace)::grouped_bf16"
                                   "<false>(...)": [0.25 * bound, 48],
                                   "paged_split": [5.0, 48]})
    win = harness.Window(cell, 51.0, steps=steps, trace=trace)
    share = _reader()(win, "moe_grouped_roofline.moe_chat")
    assert share == pytest.approx(100.0, rel=1e-12) and share <= 100.0 + 1e-9
    trace.kernels = {k: [2 * v[0], v[1]] for k, v in trace.kernels.items()}
    assert _reader()(win, "moe_grouped_roofline.moe_chat") == \
        pytest.approx(50.0)


def test_roofline_is_silent_without_the_kernel():
    """A program without the grouped kernel (its trace holds none of its
    names) reads nothing, as does an untraced window."""
    cell = spec.cell(CELL)
    steps = [harness.Step(t0=0.0, decode_seqs=45)]
    win = harness.Window(cell, 51.0, steps=steps)
    assert _reader()(win, "moe_grouped_roofline.moe_chat") is None
    win.trace = harness.Trace(busy_s=1.0, window_s=51.0, intervals=[],
                              kernels={"nvjet_bmm": [1.0, 96]})
    assert _reader()(win, "moe_grouped_roofline.moe_chat") is None
