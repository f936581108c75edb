"""With the timed path broken underneath, a run's ``correct`` comes out
false: a token altered where the engine produces it, a decode step that
leaves the KV pool as it was, and half of a decode batch left out (its rows
given the other half's logits). One card serves each cell, so there is no
exchange between chips to leave out."""
import pytest

from perfbench import spec
from perfbench.tests.conftest import moe_cell, run_cpu

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


def _altered_token(monkeypatch):
    from repro_torch.engine.engine import LLMEngine
    sample = LLMEngine._sample

    def wrong(self, req, logits):
        tok = sample(self, req, logits)
        if req.output_len == 1:
            tok = (tok + 1) % self.cfg.vocab_size
        return tok
    monkeypatch.setattr(LLMEngine, "_sample", wrong)


def _state_unchanged(monkeypatch):
    from repro_torch.engine import paged_model
    step = paged_model.decode_step

    def frozen(params, cfg, tokens, pos, pool, block_tables):
        logits, _ = step(params, cfg, tokens, pos,
                         {k: v.clone() for k, v in pool.items()},
                         block_tables)
        return logits, pool
    monkeypatch.setattr(paged_model, "decode_step", frozen)


def _half_batch(monkeypatch):
    from repro_torch.engine import paged_model
    step = paged_model.decode_step

    def half(params, cfg, tokens, pos, pool, block_tables):
        n = tokens.shape[0]
        h = max(1, n // 2)
        logits, pool = step(params, cfg, tokens[:h], pos[:h], pool,
                            block_tables[:h])
        idx = [i % h for i in range(n)]
        return logits[idx], pool
    monkeypatch.setattr(paged_model, "decode_step", half)


@pytest.mark.parametrize("fault", [_altered_token, _state_unchanged,
                                   _half_batch],
                         ids=["altered_token", "state_unchanged",
                              "half_batch"])
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    line, logs = run_cpu(name)
    got = next(kw for kw in logs if "served_tokens" in kw)
    # decode steps were compared, not only the prefills' first tokens
    assert got["served_tokens"] > got["sampled_requests"], got
    checks = line["checks"]
    assert line["correct"] is False, checks
    assert any(c["value"] > c["limit"] for c in checks.values())


@pytest.mark.parametrize("fault", [_altered_token, _state_unchanged,
                                   _half_batch],
                         ids=["altered_token", "state_unchanged",
                              "half_batch"])
def test_fault_is_not_correct_on_the_moe_path(fault, monkeypatch):
    """The same faults under the moe configuration's closed loop, at a
    prompt length the program routes without drops."""
    fault(monkeypatch)
    line, logs = run_cpu(cell=moe_cell())
    got = next(kw for kw in logs if "served_tokens" in kw)
    assert got["served_tokens"] > got["sampled_requests"], got
    assert line["correct"] is False, line["checks"]
