"""The dense and moe paged decode (``paged_model.PagedDecoder``): the
bucket ladder (``paged_model.decode_buckets`` / ``decode_bucket``), the
families the decoder refuses, and the staged bucket on both devices. On the
CPU each bucket runs eagerly and nothing is captured; on the card
(``device`` "cuda", marked ``cuda``) it is replayed from a CUDA graph. The
same test body runs on each: padded buckets, a smaller batch after a larger
one and the scratch page taking every padding row's write, against
``paged_model.decode_step`` run eagerly on exactly the batch's rows. Run the
card's cases on a machine with an H100:

    PYTHONPATH=src python -m pytest --noconftest -m cuda -q \
        tests/test_torch_decode_graph.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.config import GPU_H100  # noqa: E402
from repro_torch.engine import paged_model  # noqa: E402
from repro_torch.engine.executor import RealExecutor  # noqa: E402
from repro_torch.engine.request import Request, SamplingParams  # noqa: E402
from repro_torch.launch import drive  # noqa: E402
from repro_torch.models import api  # noqa: E402

GRAPH_CAP = 16                  # max_slots: buckets 1, 2, 4, 8 and 16
GRAPH_BLOCKS, GRAPH_BS, GRAPH_LEN = 96, 16, 128      # tables of 8 pages
GRAPH_CTX = 64                  # contexts up to 4 pages: 17 fit the pool
# the paged families: a dense model and a moe one, each reduced
GRAPHED = pytest.mark.parametrize("name", ["qwen3-1.7b", "qwen3-moe-30b-a3b"],
                                  ids=["dense", "moe"])
# (atol, rtol) of a staged step against the eager one. The CPU computes both
# in f32; on the card they differ by bf16 rounding, at most one bf16 step.
TOL = {"cpu": (1e-5, 1e-5), "cuda": (2e-3, 8e-3)}


@pytest.fixture(params=["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def device(request):
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return request.param


def _executor(name, device, seed=7):
    """A reduced RealExecutor on ``device`` with every page of its paged
    pool (if it has one), the scratch page among them, filled with noise;
    returns (cfg, params, executor)."""
    cfg = configs.get(name).reduced()
    params = api.init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    params = torch.utils._pytree.tree_map(lambda v: v.to(device), params)
    ex = RealExecutor(cfg, params, num_blocks=GRAPH_BLOCKS,
                      block_size=GRAPH_BS, hw=GPU_H100,
                      max_model_len=GRAPH_LEN, max_slots=GRAPH_CAP,
                      device=device)
    if ex.paged:
        _noise(ex.pool, seed)
    return cfg, params, ex


def _noise(pool, seed):
    g = torch.Generator(pool["k"].device).manual_seed(seed)
    for leaf in pool.values():
        leaf.normal_(generator=g)


def _decode_batch(s, seed, vocab):
    """The executor's decode input for s sequences on pages of their own,
    none of them block 0 (an ordinary block that zero table entries name)."""
    rng = np.random.default_rng(seed)
    pages = [p for p in rng.permutation(GRAPH_BLOCKS).tolist() if p]
    dec = {"slots": list(range(s)), "tokens": [], "pos": [],
           "block_tables": []}
    for _ in range(s):
        ctx = int(rng.integers(1, GRAPH_CTX + 1))
        n = -(-ctx // GRAPH_BS)
        dec["block_tables"].append(pages[:n])
        pages = pages[n:]
        dec["tokens"].append(int(rng.integers(1, vocab)))
        dec["pos"].append(ctx - 1)
    return dec


def _eager_decode(cfg, params, pool, dec):
    """``paged_model.decode_step`` on ``pool``, eagerly on the batch's rows
    alone, their tables padded with zeros."""
    dev = pool["k"].device
    s, mb = len(dec["slots"]), GRAPH_LEN // GRAPH_BS
    bt = torch.zeros((s, mb), dtype=torch.int32)
    for i, table in enumerate(dec["block_tables"]):
        bt[i, :len(table)] = torch.tensor(table, dtype=torch.int32)
    logits, _ = paged_model.decode_step(
        params, cfg, torch.tensor(dec["tokens"], device=dev),
        torch.tensor(dec["pos"], device=dev), pool, bt.to(dev))
    return logits.float().cpu()


def _written(pool, before, dec):
    """Which (layer, block, offset) slots of the pool differ from
    ``before``, and which a step of ``dec`` should write: each real row's
    slot at its position, and, if its bucket has padding rows, slot 0 of
    the scratch page (every padding row writes its position 0 there)."""
    dev = pool["k"].device
    got = torch.zeros(pool["k"].shape[:3], dtype=torch.bool, device=dev)
    for name in ("k", "v"):
        got |= (pool[name] != before[name]).flatten(3).any(-1)
    want = torch.zeros_like(got)
    for table, p in zip(dec["block_tables"], dec["pos"]):
        want[:, table[p // GRAPH_BS], p % GRAPH_BS] = True
    s = len(dec["slots"])
    want[:, GRAPH_BLOCKS, 0] = paged_model.decode_bucket(s, GRAPH_CAP) > s
    return got, want


@pytest.mark.parametrize("cap", [1, 2, 4, 5, 8, 12, 64, 256])
def test_bucket_is_the_smallest_that_holds_the_batch(cap):
    buckets = paged_model.decode_buckets(cap)
    assert buckets[0] == 1 and buckets[-1] == cap
    assert list(buckets) == sorted(set(buckets))
    # steps of at most 8 rows, or a quarter of the bucket stepped from
    assert all(b - a <= max(8, a // 4) for a, b in zip(buckets, buckets[1:]))
    for s in range(1, cap + 1):
        b = paged_model.decode_bucket(s, cap)
        assert b in buckets and b >= s
        assert all(c < s for c in buckets if c < b)
    for s in (0, cap + 1, cap + 3):
        with pytest.raises(ValueError):
            paged_model.decode_bucket(s, cap)


def test_ladder_at_the_cells_cap():
    """256 sequences (the chat cell's ``max_num_seqs``): 19 graphs; a batch
    of 45 pads to 48, one of 65 to 80."""
    buckets = paged_model.decode_buckets(256)
    assert buckets == (1, 2, 4, 8, 16, 24, 32, 40, 48, 56, 64, 80, 96, 112,
                       128, 160, 192, 224, 256)
    assert paged_model.decode_bucket(45, 256) == 48
    assert paged_model.decode_bucket(65, 256) == 80
    with pytest.raises(ValueError):
        paged_model.decode_bucket(257, 256)


@pytest.mark.parametrize("name", ["mistral-small-24b", "qwen3-moe-30b-a3b"])
def test_cpu_executor_captures_nothing(name):
    """On the CPU the paged decode runs its staged buckets eagerly: the
    decoder is not graphed and holds no graphs, ``graph_decodes`` stays 0,
    and the pool has the scratch page at index ``num_blocks`` beside the
    allocator's pages, which no block table the allocator hands out
    names."""
    cfg = configs.get(name).reduced()
    params = api.init_params(cfg, torch.Generator("cpu").manual_seed(0),
                             "cpu")
    engine = drive.build_engine(cfg, params, "cpu", num_blocks=64,
                                block_size=16, max_num_seqs=4,
                                max_prefill_tokens=64, max_model_len=256)
    ex = engine.executor
    tables, step = [], ex.step

    def recording(prefills, decode):
        tables.extend(pf["block_table"] for pf in prefills or ())
        tables.extend(decode["block_tables"] if decode else ())
        return step(prefills, decode)
    ex.step = recording
    prompts = drive.make_prompts(cfg.vocab_size, (9, 30, 17), seed=3)
    for p in prompts:
        engine.add_request(Request(prompt_tokens=p, sampling=SamplingParams(
            temperature=0.0, max_new_tokens=4)), 0.0)
    while engine.has_work():
        engine.step(0.0)
    assert not ex.decoder.graphed and ex.decoder.graphs == {}
    assert ex.decoder.scratch == 64
    assert ex.decode_steps > 0 and ex.graph_decodes == 0
    assert ex.graph_padding_rows == 0
    assert tuple(ex.pool["k"].shape) == (cfg.num_layers, 65, 16,
                                         cfg.num_kv_heads, cfg.head_dim)
    assert tables and all(64 not in list(t) for t in tables)


@pytest.mark.parametrize("name", ["mamba2-780m", "recurrentgemma-9b"],
                         ids=["ssm", "hybrid"])
def test_graphs_refuse_the_slot_state_families(name):
    """The slot-state families have no paged pool to decode against:
    ``PagedDecoder`` refuses them by their family, before it reads the pool
    or touches a device (it is handed none here)."""
    cfg = configs.get(name).reduced()
    with pytest.raises(ValueError, match=cfg.family):
        paged_model.PagedDecoder(None, cfg, None, max_slots=4, mb=8,
                                 scratch=0)


@GRAPHED
@pytest.mark.parametrize("s", [3, 5, 13, 16])
def test_graphed_decode_matches_eager(s, name, device):
    """Batches between buckets (3, 5, 13) and one on the cap (16): the
    staged step's logits against the eager decode of the batch's rows alone
    on the same pool, within the device's tolerance and with the same
    argmax, and the pool's allocator pages as the eager decode leaves them.
    For moe, the padding rows' routed rows beside the real ones leave the
    real rows' outputs as the eager layer gives them."""
    cfg, params, ex = _executor(name, device)
    dcd = ex.decoder
    assert dcd.graphed == (device == "cuda")
    assert sorted(dcd.graphs) == ([1, 2, 4, 8, 16] if dcd.graphed else [])
    assert ex.pool["k"].shape[1] == GRAPH_BLOCKS + 1
    dec = _decode_batch(s, s, cfg.vocab_size)
    eager = {k: v.clone() for k, v in ex.pool.items()}
    _, out, _ = ex.step([], dec)
    bucket = paged_model.decode_bucket(s, GRAPH_CAP)
    assert bucket == {3: 4, 5: 8, 13: 16, 16: 16}[s]
    assert (ex.decode_steps, ex.graph_decodes) == (1, int(dcd.graphed))
    ref = _eager_decode(cfg, params, eager, dec)
    atol, rtol = TOL[device]
    torch.testing.assert_close(torch.from_numpy(out), ref, atol=atol,
                               rtol=rtol)
    assert (out.argmax(-1) == ref.argmax(-1).numpy()).all()
    for leaf in ("k", "v"):
        torch.testing.assert_close(ex.pool[leaf][:, :GRAPH_BLOCKS],
                                   eager[leaf][:, :GRAPH_BLOCKS], atol=atol,
                                   rtol=rtol)


@pytest.mark.parametrize("sizes", [(8, 5), (3,), (16, 1, 9)],
                         ids=["smaller_after_larger", "padded",
                              "three_buckets"])
@GRAPHED
def test_graphed_decode_writes_only_its_own_slots(sizes, name, device):
    """Each step (5 after 8 runs bucket 8 with three padding rows where the
    last batch had sequences) changes the pool only at the new token's slot
    of each real row and, if the bucket has padding rows, at slot 0 of the
    scratch page, where all of them write: every page a row does not own,
    block 0 among them, and every other slot stay bitwise as they were. The
    pool is refilled with noise before each step, so a row left over from
    the last batch would show by what it writes."""
    cfg, _, ex = _executor(name, device)
    for i, s in enumerate(sizes):
        _noise(ex.pool, 100 + i)
        dec = _decode_batch(s, 10 * i + s, cfg.vocab_size)
        before = {k: v.clone() for k, v in ex.pool.items()}
        ex.step([], dec)
        got, want = _written(ex.pool, before, dec)
        assert torch.equal(got, want)
        assert not bool(got[:, 0].any())
    assert ex.decode_steps == len(sizes)
    assert ex.graph_decodes == (len(sizes) if device == "cuda" else 0)


@GRAPHED
def test_graphed_replays_back_to_back(name, device):
    """Two staged steps with no read of the logits between them: on the
    card the second ``stage`` waits for the first copy to leave the pinned
    buffer, so each replay decodes its own batch, as the eager decode does
    on a copy of the pool."""
    cfg, params, ex = _executor(name, device)
    dcd = ex.decoder
    decs = [_decode_batch(s, 50 + s, cfg.vocab_size) for s in (7, 5)]
    eager = {k: v.clone() for k, v in ex.pool.items()}
    outs = []
    for dec in decs:
        b = paged_model.decode_bucket(len(dec["slots"]), GRAPH_CAP)
        dcd.stage(dec, b)
        outs.append(dcd.run(b, len(dec["slots"])).clone())
    atol, rtol = TOL[device]
    for dec, out in zip(decs, outs):
        ref = _eager_decode(cfg, params, eager, dec)
        torch.testing.assert_close(out.cpu(), ref, atol=atol, rtol=rtol)
        assert torch.equal(out.cpu().argmax(-1), ref.argmax(-1))


@GRAPHED
def test_cpu_decode_logits_do_not_alias(name):
    """A CPU step's logits are the decoder's own copy: the next decode,
    which runs in the same static buffer, leaves the last step's logits as
    they were."""
    cfg, _, ex = _executor(name, "cpu")
    _, first, _ = ex.step([], _decode_batch(5, 1, cfg.vocab_size))
    kept = first.copy()
    _, second, _ = ex.step([], _decode_batch(3, 2, cfg.vocab_size))
    assert not np.shares_memory(first, second)
    assert np.array_equal(first, kept)
