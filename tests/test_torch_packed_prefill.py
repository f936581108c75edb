"""The packed prefill of the dense and moe families
(``paged_model.stage_prefill`` and ``paged_model.prefill``, which
``RealExecutor`` runs for a step's prompts on their last chunk) and the
executor's rule for cutting a step's prompts into passes
(``executor.pack_prefills``). A packed pass over prompts of mixed lengths
gives each prompt's last-token logits and writes each token's K/V into the
pool as ``api.prefill_fn`` and ``paged_model.write_prefill`` do one prompt
at a time, and touches no other slot of the pool but the scratch page. The
same test body runs on the CPU and, marked ``cuda``, on the card:

    PYTHONPATH=src python -m pytest --noconftest -m cuda -q \
        tests/test_torch_packed_prefill.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.config import GPU_H100  # noqa: E402
from repro_torch.engine import paged_model  # noqa: E402
from repro_torch.engine.executor import RealExecutor, pack_prefills  # noqa: E402
from repro_torch.models import api  # noqa: E402

BS, BLOCKS = 8, 48
SCRATCH = BLOCKS                # the pool's extra page, past the allocator's
PAGED = pytest.mark.parametrize("name", ["qwen3-1.7b", "qwen3-moe-30b-a3b"],
                                ids=["dense", "moe"])
# (atol, rtol) of the packed pass against one prompt at a time: the same
# f32 arithmetic, its products at another number of rows
TOL = {"cpu": (1e-5, 1e-5), "cuda": (1e-4, 1e-4)}


@pytest.fixture(params=["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def device(request):
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return request.param


def _model(name, device, seed=3):
    cfg = configs.get(name).reduced()
    params = api.init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    return cfg, torch.utils._pytree.tree_map(lambda v: v.to(device), params)


def _prompts(case, vocab, seed=11):
    """The executor's prefill input for prompts of mixed lengths (one of
    them a whole number of blocks), each whole, on pages of their own, none
    of them block 0; with ``shared``, the second prompt's first two blocks
    are the first's (a cached prefix: the same tokens on the same pages)."""
    rng = np.random.default_rng(seed)
    pages = [p for p in rng.permutation(BLOCKS).tolist() if p]
    lens = {"mixed": (5, 19, 33, 16, 1), "shared": (21, 30, 9)}[case]
    out = []
    for n in lens:
        nb = -(-n // BS)
        out.append({"token_ids": rng.integers(1, vocab, n).tolist(),
                    "block_table": pages[:nb], "chunk": (0, n),
                    "is_last": True, "slot": 0})
        pages = pages[nb:]
    if case == "shared":
        a, b = out[0], out[1]
        b["token_ids"][:2 * BS] = a["token_ids"][:2 * BS]
        b["block_table"][:2] = a["block_table"][:2]
    return out


@PAGED
@pytest.mark.parametrize("case", ["mixed", "shared"])
def test_packed_pass_matches_one_prompt_at_a_time(name, device, case):
    cfg, params = _model(name, device)
    prompts = _prompts(case, cfg.vocab_size)
    pool = paged_model.init_pool(cfg, BLOCKS + 1, BS, device=device)
    g = torch.Generator(device).manual_seed(5)
    for leaf in pool.values():
        leaf.normal_(generator=g)
    noise = {k: v.clone() for k, v in pool.items()}
    want = {k: v.clone() for k, v in pool.items()}
    lengths = [len(p["token_ids"]) for p in prompts]
    staged = torch.as_tensor(
        paged_model.stage_prefill(prompts, BS, SCRATCH), device=device)
    # one writer a slot (a shared page's earlier ones go to the scratch
    # page): a scatter with repeated indices keeps any one of them on the
    # card
    slots = staged[2 * sum(lengths):].cpu()
    real = slots[slots // BS != SCRATCH]
    assert len(torch.unique(real)) == len(real)
    assert len(real) == len(slots) - (2 * BS if case == "shared" else 0)
    got = paged_model.prefill(params, cfg, pool, staged, lengths)
    assert tuple(got.shape) == (len(prompts), cfg.vocab_size)
    atol, rtol = TOL[device]
    written = torch.zeros(BLOCKS + 1, BS, dtype=torch.bool)
    for i, p in enumerate(prompts):
        toks = torch.tensor(p["token_ids"], device=device)[None]
        logits, cache = api.prefill_fn(params, cfg, {"tokens": toks})
        torch.testing.assert_close(got[i], logits[0], atol=atol, rtol=rtol)
        paged_model.write_prefill(
            want, cache, torch.tensor(p["block_table"], device=device), BS)
        t = torch.arange(lengths[i])
        written[torch.tensor(p["block_table"])[t // BS], t % BS] = True
    written[SCRATCH] = False
    for k in ("k", "v"):
        # every token's slot holds its K/V, the last prompt's where two
        # prompts share a page, as writes one prompt at a time leave it
        torch.testing.assert_close(pool[k][:, written], want[k][:, written],
                                   atol=atol, rtol=rtol)
        # no other slot changed, the scratch page aside (past the prompts'
        # lengths write_prefill zeroes its pages; the packed pass leaves
        # them, and a decode writes a position before it reads it)
        keep = ~written
        keep[SCRATCH] = False
        assert torch.equal(pool[k][:, keep], noise[k][:, keep])


def _spec(n, last=True):
    return {"token_ids": [1] * n, "is_last": last}


@pytest.mark.parametrize("lens, last, budget, want", [
    # in the scheduler's order, each pass within the budget
    ((10, 20, 30, 50), None, 64, [[0, 1, 2], [3]]),
    ((32, 32, 1), None, 64, [[0, 1], [2]]),
    # a prompt longer than the budget is a pass alone
    ((10, 100, 20), None, 64, [[0], [1], [2]]),
    ((100, 200), None, 64, [[0], [1]]),
    # a chunk that is not its prompt's last is computed by no pass
    ((10, 40, 20, 30), (True, False, True, True), 64, [[0, 2, 3]]),
    ((10, 40), (False, False), 64, []),
    ((), None, 64, []),
], ids=["order", "exact", "long-alone", "all-long", "non-last", "none-last",
        "empty"])
def test_pack_prefills(lens, last, budget, want):
    last = last or (True,) * len(lens)
    prefills = [_spec(n, f) for n, f in zip(lens, last)]
    assert pack_prefills(prefills, budget) == want


@PAGED
def test_executor_computes_a_step_in_passes(name, device):
    """One executor step of five prompts (one not on its last chunk) under a
    budget of 64: passes of (5, 19, 33) and (40, 9), each prompt's logits
    those of the prompt computed alone, the non-last chunk's None."""
    cfg, params = _model(name, device)
    ex = RealExecutor(cfg, params, num_blocks=BLOCKS, block_size=BS,
                      hw=GPU_H100, max_model_len=128, max_slots=4,
                      device=device, max_prefill_tokens=64)
    rng = np.random.default_rng(2)
    pages = iter(range(1, BLOCKS))
    prefills = []
    for n, last in ((5, True), (19, True), (50, False), (33, True),
                    (40, True), (9, True)):
        prefills.append({"token_ids": rng.integers(1, cfg.vocab_size,
                                                   n).tolist(),
                         "block_table": [next(pages)
                                         for _ in range(-(-n // BS))],
                         "chunk": (0, n), "is_last": last, "slot": 0})
    pre, dec, _ = ex.step(prefills, None)
    assert dec is None and pre[2] is None
    assert (ex.prefill_passes, ex.prefill_computes) == (2, 5)
    if cfg.family == "moe":
        assert ex.moe_calls == 2 * cfg.num_layers
        assert ex.moe_rows == cfg.num_layers * 106 \
            * cfg.num_experts_per_tok
    atol, rtol = TOL[device]
    for i in (0, 1, 3, 4, 5):
        toks = torch.tensor(prefills[i]["token_ids"], device=device)[None]
        logits, _ = api.prefill_fn(params, cfg, {"tokens": toks})
        np.testing.assert_allclose(pre[i], logits[0].float().cpu().numpy(),
                                   atol=atol, rtol=rtol)
