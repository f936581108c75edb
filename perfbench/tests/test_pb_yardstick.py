"""The yardstick's formulas against the bounds PERF.md printed for the same
shapes (chip_smoke.py, PRs 14-15), and the record arithmetic."""
import json

import pytest

from perfbench import spec, yardstick


def test_paged_bound_matches_printed():
    # S 4, H 32, KV 8, D 128, BS 16, bf16 q, f32 pool: 0.02405 ms
    ctx = [1, 4096, 3853, 1876]
    pages = sum(-(-c // 16) for c in ctx)
    ms = 1e3 * yardstick.paged_call_s(4, sum(ctx), pages, 32, 8, 128)
    assert round(ms, 5) == 0.02405
    n_bytes, n_ops = yardstick.paged_call(4, sum(ctx), pages, 32, 8, 128)
    assert n_bytes / yardstick.HBM_BYTES_PER_S \
        > n_ops / yardstick.PEAK_F32


def test_flash_bound_matches_printed():
    # B 1, T 1500, H 32, KV 8, D 128, bf16, causal: 0.01865 ms (operations)
    ms = 1e3 * yardstick.flash_call_s(1500, 32, 8, 128)
    assert round(ms, 5) == 0.01865
    n_bytes, n_ops = yardstick.flash_call(1, 1500, 32, 8, 128)
    assert n_ops / yardstick.PEAK_BF16 > n_bytes / yardstick.HBM_BYTES_PER_S


def test_mistral_decode_step_bound_matches_printed():
    # 4 sequences at PR 14's last contexts (prompts 37, 300, 1000, 1500
    # after 15 decode steps): 45.80 GB of weights, 0.95 GB of KV, 13.96 ms
    cfg = spec.load_json(spec.HERE / "configs" / "mistral-24b.json")
    ctx = [52, 315, 1015, 1515]
    assert round(yardstick.weight_bytes(cfg, 4) / 1e9, 2) == 45.80
    ms = 1e3 * yardstick.decode_step_bytes(cfg, ctx) \
        / yardstick.HBM_BYTES_PER_S
    assert round(ms, 2) == 13.96


def test_active_parameters():
    m = spec.load_json(spec.HERE / "configs" / "mistral-24b.json")
    q = spec.load_json(spec.HERE / "configs" / "qwen3-moe.json")
    stored, active = yardstick.layer_params(m)
    assert stored == active
    assert 23.5e9 < 40 * stored + 2 * 131072 * 5120 < 23.7e9
    stored, active = yardstick.layer_params(q)
    assert 30.4e9 < 48 * stored + 2 * 151936 * 2048 < 30.6e9
    assert 3.2e9 < 48 * active + 2 * 151936 * 2048 < 3.4e9


def test_step_flops_counts_prompt_head_once():
    m = spec.load_json(spec.HERE / "configs" / "mistral-24b.json")
    one = yardstick.step_flops(m, 0, 0, [1])
    two = yardstick.step_flops(m, 0, 0, [2])
    _, active = yardstick.layer_params(m)
    attn = 4 * 40 * 32 * 128
    assert two - one == pytest.approx(2 * 40 * active + 2 * attn)
    dec = yardstick.step_flops(m, 100, 1, [])
    assert dec == pytest.approx(2 * 40 * active + 2 * 5120 * 131072
                                + attn * 100)


def test_percentile_and_censoring():
    assert yardstick.percentile(list(range(11)), 90) == pytest.approx(9.0)
    assert yardstick.censored(1.0, None, 10.0) == 9.0
    assert yardstick.censored(1.0, 12.0, 10.0) == 9.0
    assert yardstick.censored(1.0, 3.5, 10.0) == 2.5


def test_reference_routes_every_row():
    """The reference's moe routes each row to its own top-k experts and
    drops none, as the published model does: a row's output does not
    depend on the rows routed beside it."""
    import torch

    from perfbench.reference import decoder
    torch.manual_seed(0)
    d, e, f = 16, 8, 8
    cfg = {"num_experts": e, "num_experts_per_tok": 2}
    # one expert wins every row: a capacity would drop most of them
    router = torch.zeros(d, e)
    router[:, 3] = 1.0
    lw = {"router": router, "w_gate": torch.randn(e, d, f),
          "w_up": torch.randn(e, d, f), "w_down": torch.randn(e, f, d)}
    x = torch.rand(200, d)
    mm = decoder._Products(False)
    whole = decoder._moe(mm, x, lw, cfg)
    rows = torch.cat([decoder._moe(mm, x[i:i + 1], lw, cfg)
                      for i in range(x.shape[0])])
    assert torch.allclose(whole, rows, atol=1e-5)
