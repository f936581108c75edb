"""The port's hand-written CUDA kernels against their plain PyTorch versions,
on the card. Marked ``cuda``; each test skips without a CUDA device. Run on
a machine with an H100 (JAX need not be installed there):

    PYTHONPATH=src python -m pytest --noconftest -m cuda -q \
        tests/test_torch_cuda.py
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda

# (atol, rtol). Kernels and plain versions both compute in f32; a bf16
# output differs by its rounding, at most one bf16 step (2^-7 of |ref|).
TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2e-3, 8e-3)}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator("cuda").manual_seed(0)


def _close(out, ref, tol):
    atol, rtol = tol
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), rtol=rtol, atol=atol)


def _paged(gen, s, h, kv, d, bs, mb, q_dtype, kv_dtype):
    nb = s * mb + 1
    q = torch.randn(s, h, d, generator=gen, device="cuda").to(q_dtype)
    pk = torch.randn(nb, bs, kv, d, generator=gen, device="cuda").to(kv_dtype)
    pv = torch.randn(nb, bs, kv, d, generator=gen, device="cuda").to(kv_dtype)
    bt = torch.randint(0, nb, (s, mb), generator=gen, device="cuda",
                       dtype=torch.int32)
    lens = torch.randint(1, mb * bs + 1, (s,), generator=gen, device="cuda",
                         dtype=torch.int32)
    return q, pk, pv, bt, lens


DTYPES = [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
          (torch.bfloat16, torch.float32)]


@pytest.mark.parametrize("s,h,kv,d,bs,mb", [
    (4, 8, 2, 128, 16, 8),
    (2, 4, 4, 64, 32, 4),
    (3, 9, 3, 64, 16, 5),       # GQA ratio 3
    (1, 16, 1, 128, 32, 16),    # MQA, QPK 16
    (5, 8, 8, 96, 16, 3),       # head_dim 96
    (2, 32, 8, 128, 16, 256),   # the main path's shape
    (2, 32, 4, 128, 16, 256),   # Qwen3-30B-A3B's heads, QPK 8
    (3, 12, 2, 64, 16, 5),      # QPK 6: dead rows of the 8-row kernel
    (2, 8, 1, 32, 16, 4),       # QPK 8 at the smallest head width
])
@pytest.mark.parametrize("dtypes", DTYPES, ids=["f32", "bf16", "bf16q_f32kv"])
def test_paged_attention_kernel_matches_plain(s, h, kv, d, bs, mb, dtypes,
                                              gen):
    from repro_torch.kernels.paged_attention import kernel, ref
    args = _paged(gen, s, h, kv, d, bs, mb, *dtypes)
    before = kernel.paged_attention.launches
    out = kernel.paged_attention(*args)
    assert kernel.paged_attention.launches == before + 1
    _close(out, ref.paged_attention_ref(*args), TOL[dtypes[0]])


def test_paged_attention_never_reads_past_the_context(gen):
    """Block 0 is an ordinary block: zero-padded table slots point at it.
    Poison every block the live pages do not use, block 0 included; the
    kernel must not read them."""
    from repro_torch.kernels.paged_attention import kernel, ref
    s, h, kv, d, bs, mb = 3, 8, 2, 64, 16, 8
    q, pk, pv, _, _ = _paged(gen, s, h, kv, d, bs, mb, torch.float32,
                             torch.float32)
    lens = torch.tensor([1, 17, 40], device="cuda", dtype=torch.int32)
    bt = torch.zeros((s, mb), device="cuda", dtype=torch.int32)
    live = {1: [5], 2: [6, 7], 3: [8, 9, 10]}   # pages per sequence
    for i, n in enumerate(lens.tolist()):
        pages = -(-n // bs)
        bt[i, :pages] = torch.tensor(live[pages], dtype=torch.int32)
    expect = ref.paged_attention_ref(q, pk, pv, bt, lens)
    used = torch.zeros(pk.shape[0], dtype=torch.bool, device="cuda")
    used[[5, 6, 7, 8, 9, 10]] = True
    pk[~used] = float("nan")
    pv[~used] = float("nan")
    for i, n in enumerate(lens.tolist()):                 # the ragged tail
        pages = -(-n // bs)
        blk, off = live[pages][-1], n - (pages - 1) * bs
        pk[blk, off:] = float("nan")
        pv[blk, off:] = float("nan")
    out = kernel.paged_attention(q, pk, pv, bt, lens)
    _close(out, expect, TOL[torch.float32])


def test_paged_attention_zero_context_gives_zeros(gen):
    """ctx = 0 reads nothing and returns zeros, as the Pallas kernel does."""
    from repro_torch.kernels.paged_attention import kernel
    args = list(_paged(gen, 2, 4, 2, 64, 16, 2, torch.float32, torch.float32))
    args[4] = torch.zeros(2, dtype=torch.int32, device="cuda")
    out = kernel.paged_attention(*args)
    torch.cuda.synchronize()
    assert bool((out == 0).all())


@pytest.mark.parametrize("where", ["on_boundary", "one_past", "full_table"])
@pytest.mark.parametrize("dtypes", DTYPES, ids=["f32", "bf16", "bf16q_f32kv"])
def test_paged_attention_split_edges(where, dtypes, gen):
    """Contexts that end exactly on a split's last token, one token into the
    next split, and at MB * BS (every split live), beside ctx 1."""
    from repro_torch.kernels.paged_attention import kernel, ref
    s, h, kv, d, bs, mb = 3, 8, 2, 128, 16, 64
    p = kernel.plan(s, h, kv, d, bs, mb)
    span = p.span_pages * bs
    assert p.splits >= 3
    ctx = {"on_boundary": 2 * span, "one_past": 2 * span + 1,
           "full_table": mb * bs}[where]
    args = list(_paged(gen, s, h, kv, d, bs, mb, *dtypes))
    args[4] = torch.tensor([ctx, 1, span], device="cuda", dtype=torch.int32)
    out = kernel.paged_attention(*args)
    _close(out, ref.paged_attention_ref(*args), TOL[dtypes[0]])


def test_paged_attention_kernel_rejects_bad_inputs(gen):
    from repro_torch.kernels.paged_attention import kernel
    q, pk, pv, bt, lens = _paged(gen, 2, 4, 2, 64, 16, 2, torch.float32,
                                 torch.float32)
    with pytest.raises(ValueError, match="int32"):
        kernel.paged_attention(q, pk, pv, bt.long(), lens)
    with pytest.raises(ValueError, match="contiguous"):
        kernel.paged_attention(q.transpose(0, 1).contiguous().transpose(0, 1),
                               pk, pv, bt, lens)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.paged_attention(q.cpu(), pk, pv, bt, lens)
    with pytest.raises(ValueError, match="dtypes"):     # f32 q, bf16 pool
        kernel.paged_attention(q, pk.bfloat16(), pv.bfloat16(), bt, lens)
    with pytest.raises(ValueError, match="16-byte"):    # D = 62 f32
        kernel.paged_attention(q[..., :62].contiguous(),
                               pk[..., :62].contiguous(),
                               pv[..., :62].contiguous(), bt, lens)
    with pytest.raises(ValueError, match="16-byte"):    # pool off by 4 bytes
        flat = torch.empty(pk.numel() + 1, device="cuda")
        shifted = flat[1:].view(pk.shape)
        kernel.paged_attention(q, shifted, pv, bt, lens)
    with pytest.raises(ValueError, match="head_dim"):   # D = 48
        kernel.paged_attention(q[..., :48].contiguous(),
                               pk[..., :48].contiguous(),
                               pv[..., :48].contiguous(), bt, lens)


@pytest.mark.parametrize("b,t,h,kv,d,window", [
    (2, 256, 4, 2, 64, 0),
    (1, 256, 8, 8, 128, 0),
    (2, 512, 4, 1, 64, 128),    # windowed
    (1, 128, 9, 3, 64, 0),      # h=9 / kv=3
    (1, 512, 2, 2, 128, 256),
    (1, 37, 32, 8, 128, 0),     # ragged T, the main path's heads
    (3, 11, 4, 2, 96, 0),
    (1, 1, 4, 2, 64, 0),
    (1, 50, 16, 1, 64, 7),      # MQA, QPK 16, ragged and windowed
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_prefill_kernel_matches_plain(b, t, h, kv, d, window, dtype,
                                            gen):
    from repro_torch.kernels.flash_prefill import kernel, ref
    q = torch.randn(b, t, h, d, generator=gen, device="cuda").to(dtype)
    k = torch.randn(b, t, kv, d, generator=gen, device="cuda").to(dtype)
    v = torch.randn(b, t, kv, d, generator=gen, device="cuda").to(dtype)
    before = kernel.flash_prefill.launches
    out = kernel.flash_prefill(q, k, v, window)
    assert kernel.flash_prefill.launches == before + 1
    _close(out, ref.flash_prefill_ref(q, k, v, window),
           (2e-5, 2e-5) if dtype == torch.float32 else TOL[dtype])


@pytest.mark.parametrize("window", [0, 48], ids=["causal", "window48"])
@pytest.mark.parametrize("d", [64, 96, 128, 256])
@pytest.mark.parametrize("qpk", [1, 2, 3, 4, 8, 16])
@pytest.mark.parametrize("t", [1, 37, 63, 64, 65, 1500, 2049])
def test_flash_prefill_bf16_tensor_cores(t, qpk, d, window, gen):
    """The wgmma kernel over ragged T (tile edges at 64 keys and 64 // QPK
    positions), every QPK of the configs and tests (3 leaves a dead row),
    every head width, causal and windowed, at the bf16 output's rounding."""
    from repro_torch.kernels.flash_prefill import kernel, ref
    kv = 2
    q = torch.randn(1, t, kv * qpk, d, generator=gen, device="cuda").bfloat16()
    k = torch.randn(1, t, kv, d, generator=gen, device="cuda").bfloat16()
    v = torch.randn(1, t, kv, d, generator=gen, device="cuda").bfloat16()
    out = kernel.flash_prefill(q, k, v, window)
    _close(out, ref.flash_prefill_ref(q, k, v, window), TOL[torch.bfloat16])


@pytest.mark.parametrize("t,h,kv,window", [
    (37, 16, 1, 2048),
    (1500, 16, 1, 2048),
    (3072, 16, 1, 2048),     # past the window: tiles skipped at both ends
    (1500, 16, 1, 0),
    (1499, 16, 1, 2048),     # ragged: the last tile's positions past T
    (1001, 6, 2, 0),         # QPK 3: 63 live rows, a dead one
])
def test_flash_prefill_bf16_head_dim_256(t, h, kv, window, gen):
    """RecurrentGemma's attention (D 256, QPK 16, window 2048) on the
    tensor-core kernel, at the bf16 output's rounding."""
    from repro_torch.kernels.flash_prefill import kernel, ref
    d = 256
    q = torch.randn(1, t, h, d, generator=gen, device="cuda").bfloat16()
    k = torch.randn(1, t, kv, d, generator=gen, device="cuda").bfloat16()
    v = torch.randn(1, t, kv, d, generator=gen, device="cuda").bfloat16()
    before = kernel.flash_prefill.launches
    out = kernel.flash_prefill(q, k, v, window)
    assert kernel.flash_prefill.launches == before + 1
    _close(out, ref.flash_prefill_ref(q, k, v, window), TOL[torch.bfloat16])


def test_flash_prefill_kernel_rejects_bad_inputs(gen):
    """bf16 takes D 64, 96, 128 and 256 only, and never falls to the
    CUDA-core kernel; q must be contiguous."""
    from repro_torch.kernels.flash_prefill import kernel
    q = torch.randn(1, 16, 4, 80, generator=gen, device="cuda").bfloat16()
    k = torch.randn(1, 16, 2, 80, generator=gen, device="cuda").bfloat16()
    before = kernel.flash_prefill.launches
    with pytest.raises(ValueError, match="head_dim"):
        kernel.flash_prefill(q, k, k)
    q = torch.randn(1, 4, 16, 64, generator=gen, device="cuda").bfloat16()
    k = torch.randn(1, 16, 2, 64, generator=gen, device="cuda").bfloat16()
    with pytest.raises(ValueError, match="contiguous"):
        kernel.flash_prefill(q.transpose(1, 2), k, k)
    assert kernel.flash_prefill.launches == before


def test_flash_prefill_kernel_is_causal(gen):
    """Perturbing future tokens must not change earlier outputs."""
    from repro_torch.kernels.flash_prefill import kernel
    b, t, h, d = 1, 256, 4, 64
    q, k, v = (torch.randn(b, t, h, d, generator=gen, device="cuda")
               for _ in range(3))
    out1 = kernel.flash_prefill(q, k, v)
    k2, v2 = k.clone(), v.clone()
    k2[:, t // 2:] += 5.0
    v2[:, t // 2:] += 5.0
    out2 = kernel.flash_prefill(q, k2, v2)
    torch.cuda.synchronize()
    assert torch.equal(out1[:, :t // 2], out2[:, :t // 2])


def test_engine_on_card_matches_cpu(gen):
    """Reduced qwen3 served on the card (both kernels) gives the CPU port's
    greedy tokens (plain versions), f32 pool."""
    from repro_torch import configs
    from repro_torch.config import GPU_H100
    from repro_torch.engine.engine import LLMEngine
    from repro_torch.engine.executor import RealExecutor
    from repro_torch.engine.request import Request, SamplingParams
    from repro_torch.models import api
    cfg = configs.get("qwen3-1.7b").reduced()
    params = api.init_params(cfg, torch.Generator().manual_seed(7), "cpu")
    prompts = [list(range(3, 3 + n)) for n in (11, 64, 33)]
    outs = {}
    for device in ("cpu", "cuda"):
        tree = _to(params, device)
        ex = RealExecutor(cfg, tree, num_blocks=64, block_size=16,
                          hw=GPU_H100, max_model_len=256, device=device)
        eng = LLMEngine(cfg, ex, num_blocks=64, block_size=16,
                        max_num_seqs=4, max_prefill_tokens=32,
                        max_model_len=256)
        reqs = [Request(prompt_tokens=p, sampling=SamplingParams(
            temperature=0.0, max_new_tokens=6)) for p in prompts]
        for r in reqs:
            eng.add_request(r, 0.0)
        now = 0.0
        while eng.has_work():
            now += max(eng.step(now).elapsed, 1e-4)
        outs[device] = [r.output_tokens for r in reqs]
    assert outs["cuda"] == outs["cpu"]


def test_moe_engine_on_card_matches_cpu(gen):
    """Reduced qwen3-moe served on the card (all three kernels, MoE dispatch
    on the device) gives the CPU port's greedy tokens, f32 pool; the
    90-token prompt prefills past 64 tokens, dropless on both. The grouped
    kernel launches once a layer a pass, as ``moe_calls`` counts, the
    card's decodes each replayed from a CUDA graph."""
    from repro_torch import configs
    from repro_torch.config import GPU_H100
    from repro_torch.engine.engine import LLMEngine
    from repro_torch.engine.executor import RealExecutor
    from repro_torch.engine.request import Request, SamplingParams
    from repro_torch.kernels.moe_grouped import kernel as grouped
    from repro_torch.models import api
    cfg = configs.get("qwen3-moe-30b-a3b").reduced()
    params = api.init_params(cfg, torch.Generator().manual_seed(7), "cpu")
    prompts = [list(range(3, 3 + n)) for n in (11, 90, 33)]
    outs = {}
    for device in ("cpu", "cuda"):
        ex = RealExecutor(cfg, _to(params, device), num_blocks=64,
                          block_size=16, hw=GPU_H100, max_model_len=256,
                          device=device)
        eng = LLMEngine(cfg, ex, num_blocks=64, block_size=16,
                        max_num_seqs=4, max_prefill_tokens=32,
                        max_model_len=256)
        reqs = [Request(prompt_tokens=p, sampling=SamplingParams(
            temperature=0.0, max_new_tokens=6)) for p in prompts]
        for r in reqs:
            eng.add_request(r, 0.0)
        before = grouped.moe_grouped.launches
        now = 0.0
        while eng.has_work():
            now += max(eng.step(now).elapsed, 1e-4)
        outs[device] = [r.output_tokens for r in reqs]
        passes = ex.decode_steps + ex.prefill_passes
        assert ex.moe_calls == cfg.num_layers * passes
        assert ex.graph_decodes == (ex.decode_steps if device == "cuda"
                                    else 0)
        assert grouped.moe_grouped.launches - before == \
            (ex.moe_calls if device == "cuda" else 0)
    assert outs["cuda"] == outs["cpu"]


# --------------------------------------------------------------------------
# the dense and moe decode replayed from CUDA graphs (paged_model.PagedDecoder;
# its tests on both devices are in test_torch_decode_graph.py)
# --------------------------------------------------------------------------

from test_torch_decode_graph import (  # noqa: E402
    GRAPH_CAP, GRAPHED, _decode_batch, _executor)


@GRAPHED
def test_graph_decodes_counts_replays_only(name, gen):
    """A prefill leaves ``graph_decodes`` and ``graph_padding_rows`` where
    they were; each replay adds one decode, its bucket less its batch in
    padding rows, and the layers' launches of the paged kernel and (moe)
    of the grouped expert kernel, one a layer as an eager decode counts
    them. The captures count none."""
    from repro_torch.engine import paged_model
    from repro_torch.kernels.moe_grouped import kernel as mg
    from repro_torch.kernels.paged_attention import kernel as pa
    counted = (pa.paged_attention, mg.moe_grouped)
    before = [fn.launches for fn in counted]
    cfg, _, ex = _executor(name, "cuda")
    n = cfg.num_layers
    per_pass = (n, n if cfg.family == "moe" else 0)
    # the one eager pass before the captures launches; the captures do not
    assert [fn.launches - c for fn, c in zip(counted, before)] \
        == list(per_pass)
    # each bucket's replay adds what its capture took back, for every
    # counted wrapper (``kernels.build.COUNTED``), and only those two
    from repro_torch.kernels import build
    want = {fn: c for fn, c in zip(counted, per_pass) if c}
    for per_bucket in ex.decoder.launches.values():
        assert set(per_bucket) == set(build.COUNTED)
        assert {fn: c for fn, c in per_bucket.items() if c} == want
    prompt = list(range(3, 40))
    ex.step([{"chunk": (0, len(prompt)), "is_last": True, "slot": 0,
              "token_ids": prompt, "block_table": [1, 2, 3]}], None)
    assert (ex.prefill_computes, ex.decode_steps, ex.graph_decodes,
            ex.graph_padding_rows) == (1, 0, 0, 0)
    counts, padding = [], 0
    for s in (3, 16, 1, 13):
        n0 = [fn.launches for fn in counted]
        ex.step([], _decode_batch(s, s, cfg.vocab_size))
        padding += paged_model.decode_bucket(s, GRAPH_CAP) - s
        counts.append((ex.decode_steps, ex.graph_decodes,
                       tuple(fn.launches - c for fn, c in zip(counted, n0))))
    assert counts == [(1, 1, per_pass), (2, 2, per_pass), (3, 3, per_pass),
                      (4, 4, per_pass)]
    assert ex.graph_padding_rows == padding == 1 + 0 + 0 + 3


@pytest.mark.parametrize("name", ["mamba2-780m", "recurrentgemma-9b"],
                         ids=["ssm", "hybrid"])
def test_other_families_capture_nothing(name, gen):
    """The slot-state families decode eagerly on the card: no graphs,
    ``graph_decodes`` 0. moe left this test when its decode was graphed
    (its serving is dropless, so padding rows take no real row's expert
    capacity); the graphed tests of test_torch_decode_graph.py run it
    beside dense."""
    cfg, _, ex = _executor(name, "cuda")
    assert not ex.paged and not hasattr(ex, "decoder")
    ex.step([], _decode_batch(3, 3, cfg.vocab_size))
    assert (ex.decode_steps, ex.graph_decodes) == (1, 0)


def _serve_state(cfg, params, device, lens, n_new=6):
    """Greedy tokens of prompts of ``lens`` through the slot-state engine."""
    from repro_torch.config import GPU_H100
    from repro_torch.engine.engine import LLMEngine
    from repro_torch.engine.executor import RealExecutor
    from repro_torch.engine.request import Request, SamplingParams
    ex = RealExecutor(cfg, _to(params, device), num_blocks=64, block_size=16,
                      hw=GPU_H100, max_model_len=256, max_slots=4,
                      device=device)
    eng = LLMEngine(cfg, ex, num_blocks=64, block_size=16, max_num_seqs=4,
                    max_prefill_tokens=32, max_model_len=256,
                    enable_prefix_caching=False)
    reqs = [Request(prompt_tokens=list(range(3, 3 + n)), sampling=SamplingParams(
        temperature=0.0, max_new_tokens=n_new)) for n in lens]
    for r in reqs:
        eng.add_request(r, 0.0)
    now = 0.0
    while eng.has_work():
        now += max(eng.step(now).elapsed, 1e-4)
    assert all(r.status.value == "finished" for r in reqs)
    return [r.output_tokens for r in reqs]


@pytest.mark.parametrize("name,layers,lens", [
    ("mamba2-780m", 2, (11, 64, 96)),
    ("recurrentgemma-9b", 5, (11, 70, 130)),
], ids=["ssm", "hybrid"])
def test_state_engine_on_card_matches_cpu(name, layers, lens, gen):
    """Reduced mamba2 (2 layers) and griffin (5: a group and a tail) served
    on the card through the slot-state executor give the CPU port's greedy
    tokens, f32; the hybrid's prompts pass its window of 64."""
    from repro_torch import configs
    from repro_torch.models import api
    cfg = dataclasses.replace(configs.get(name).reduced(), num_layers=layers)
    params = api.init_params(cfg, torch.Generator().manual_seed(7), "cpu")
    assert _serve_state(cfg, params, "cuda", lens) == \
        _serve_state(cfg, params, "cpu", lens)


@pytest.mark.parametrize("name", ["mamba2-780m", "recurrentgemma-9b"])
def test_state_engine_bf16_weights_over_f32_slabs(name, gen):
    """bf16 weights with the executor's f32 slab on the card (head_dim 64,
    so that the hybrid's prefill runs the tensor-core kernel): decode reads
    the slab back in the model's cache dtypes and runs without a dtype
    error; every request gets its tokens."""
    from repro_torch import configs
    from repro_torch.kernels.flash_prefill import kernel
    from repro_torch.models import api
    cfg = dataclasses.replace(configs.get(name).reduced(),
                              param_dtype="bfloat16", head_dim=64)
    params = api.init_params(cfg, gen, "cuda")
    before = kernel.flash_prefill.launches
    toks = _serve_state(cfg, params, "cuda", (9, 32, 64), n_new=4)
    assert all(len(t) == 4 for t in toks)
    attn_layers = cfg.num_layers // 3 if cfg.family == "hybrid" else 0
    assert kernel.flash_prefill.launches - before == 3 * attn_layers


def _moe_layer(cfg, gen):
    """Layer 0's MoE leaves, drawn on the generator's device."""
    from repro_torch.models import moe
    p = moe.init(cfg, gen, gen.device)["layers"]["moe"]
    return {k: v[0] for k, v in p.items()}


@pytest.mark.parametrize("case", ["dropless", "overflow", "all_ties"])
def test_moe_block_on_card_matches_cpu(case, gen):
    """Serving moe_block on the card (the grouped kernel) against its CPU
    result (the buffer at C = n) in f32: 16 tokens, 300 tokens with a
    router skewed so that expert 0 gets more entries than twice its even
    share (which the old serving capacity dropped), and a zero router that
    ties every expert (lowest ids win). Dropless on both."""
    from repro_torch import configs
    from repro_torch.models import moe
    cfg = configs.get("qwen3-moe-30b-a3b").reduced()
    p = _moe_layer(cfg, torch.Generator().manual_seed(3))
    n = 16 if case == "dropless" else 300
    x = torch.randn(1, n, cfg.d_model, generator=torch.Generator()
                    .manual_seed(4)) * 0.3
    if case == "overflow":
        x[..., 0] = 1.0
        p["router"][0, 0] = 20.0
    if case == "all_ties":
        p["router"].zero_()
    y_cpu, aux_cpu = moe.moe_block(p, cfg, x, capacity_factor=None)
    y, aux = moe.moe_block(_to(p, "cuda"), cfg, x.cuda(),
                           capacity_factor=None)
    _close(y.cpu(), y_cpu, TOL[torch.float32])
    _close(aux.cpu(), aux_cpu, TOL[torch.float32])


def test_moe_block_never_syncs_with_the_host(gen):
    """Serving moe_block at decode and prefill sizes runs with the CUDA sync
    debugger set to raise: nothing in the layer waits for the device."""
    from repro_torch import configs
    from repro_torch.models import moe
    cfg = configs.get("qwen3-moe-30b-a3b").reduced()
    p = _to(_moe_layer(cfg, torch.Generator().manual_seed(3)), "cuda")
    for n in (4, 300):
        x = torch.randn(1, n, cfg.d_model, generator=gen, device="cuda")
        moe.moe_block(p, cfg, x, capacity_factor=None)      # warm up
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            moe.moe_block(p, cfg, x, capacity_factor=None)
        finally:
            torch.cuda.set_sync_debug_mode("default")


def test_moe_block_bf16_is_deterministic(gen):
    """bf16 at Qwen3-30B-A3B's widths over a 1500-token prefill, dropless
    through the grouped kernel: two calls give bitwise the same output."""
    from repro_torch import configs
    from repro_torch.models import moe
    cfg = dataclasses.replace(configs.get("qwen3-moe-30b-a3b"), num_layers=1)
    p = _moe_layer(cfg, gen)
    x = torch.randn(1, 1500, cfg.d_model, generator=gen,
                    device="cuda").bfloat16()
    a, _ = moe.moe_block(p, cfg, x, capacity_factor=None)
    b, _ = moe.moe_block(p, cfg, x, capacity_factor=None)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert bool(torch.isfinite(a.float()).all())


# --------------------------------------------------------------------------
# the grouped expert GEMM (kernels/moe_grouped) at Qwen3-30B-A3B's widths
# --------------------------------------------------------------------------

QWEN_MOE = dict(e=128, k=8, d=2048, f=768)
# (atol, rtol) of the grouped kernel against its plain version. Both round
# h = silu(x w_gate) * (x w_up) to bf16 between the two products, from f32
# sums taken in another order; an h element that lands on the other side of
# a rounding edge moves its outputs by one bf16 step of h (2^-8 |h|, |h| up
# to about 10 at these scales) times a down weight (up to about 0.2): up to
# about 0.008, besides the output's own rounding. f32 as the other kernels.
GROUPED_TOL = {torch.float32: TOL[torch.float32], torch.bfloat16: (1e-2, 8e-3)}


def _grouped_args(gen, n, dtype, e, k, d, f, counts=None):
    """n tokens' k distinct experts each (a random router), their rows
    sorted by expert, or with ``counts`` (E,) the rows each expert gets;
    weights at the fan-in scales, one layer."""
    dev = "cuda"
    if counts is None:
        pick = torch.rand(n, e, generator=gen, device=dev).topk(k, -1).indices
        counts = torch.bincount(pick.reshape(-1), minlength=e)
    counts = torch.as_tensor(counts, device=dev)
    offsets = torch.zeros(e + 1, dtype=torch.int32, device=dev)
    offsets[1:] = counts.cumsum(0)
    r = int(offsets[-1])
    x = torch.randn(r, d, generator=gen, device=dev).to(dtype)
    wg = (torch.randn(e, d, f, generator=gen, device=dev) * d ** -0.5)
    wu = (torch.randn(e, d, f, generator=gen, device=dev) * d ** -0.5)
    wd = (torch.randn(e, f, d, generator=gen, device=dev) * f ** -0.5)
    return x, offsets, wg.to(dtype), wu.to(dtype), wd.to(dtype)


@pytest.mark.parametrize("n", [1, 45, 300, 6061])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_moe_grouped_kernel_matches_plain(n, dtype, gen):
    """A decode row, the chat cell's decode batch, a prompt, and its replay's
    longest prompt at k 8 of 128 experts (most experts empty at n 1), at
    the published d and f; the launch count and the kernel's counters."""
    from repro_torch.kernels.moe_grouped import kernel, ref
    args = _grouped_args(gen, n, dtype, **QWEN_MOE)
    x, offsets = args[0], args[1]
    acc = kernel.counter(x.get_device())
    acc.zero_()
    before = kernel.moe_grouped.launches
    out = kernel.moe_grouped(*args)
    assert kernel.moe_grouped.launches == before + 1
    _close(out, ref.moe_grouped_ref(*args), GROUPED_TOL[dtype])
    counts = (offsets[1:] - offsets[:-1]).cpu()
    touched = int((counts > 0).sum())
    pad = int((-counts % kernel.BLOCK_M).sum())
    assert acc.tolist() == [1, n * 8, touched, pad]


@pytest.mark.parametrize("case", ["one_expert", "empty_first_and_last",
                                  "ragged_tiles"])
def test_moe_grouped_kernel_skewed_routing(case, gen):
    """Every row on one expert (a skewed router: 45 tokens' 8 copies, 360
    rows, on expert 5), experts 0 and 127 empty, and segments of 1, 63, 64,
    65 and 129 rows across tile edges, in bf16 at the published widths."""
    from repro_torch.kernels.moe_grouped import kernel, ref
    e = QWEN_MOE["e"]
    counts = [0] * e
    if case == "one_expert":
        counts[5] = 360
    elif case == "empty_first_and_last":
        counts = [3] * e
        counts[0] = counts[-1] = 0
    else:
        for i, c in zip((1, 2, 3, 60, 126), (1, 63, 64, 65, 129)):
            counts[i] = c
    args = _grouped_args(gen, 0, torch.bfloat16, counts=counts, **QWEN_MOE)
    out = kernel.moe_grouped(*args)
    _close(out, ref.moe_grouped_ref(*args), GROUPED_TOL[torch.bfloat16])


def test_moe_grouped_kernel_is_bitwise_repeatable_and_never_syncs(gen):
    """Two calls over a prompt's rows give bitwise the same output, and a
    call runs with the CUDA sync debugger set to raise."""
    from repro_torch.kernels.moe_grouped import kernel
    args = _grouped_args(gen, 740, torch.bfloat16, **QWEN_MOE)
    a = kernel.moe_grouped(*args)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        b = kernel.moe_grouped(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_moe_grouped_kernel_refuses_what_it_does_not_take(gen):
    from repro_torch.kernels.moe_grouped import kernel
    x, offsets, wg, wu, wd = _grouped_args(gen, 4, torch.bfloat16, e=8, k=2,
                                           d=128, f=64)
    with pytest.raises(ValueError, match="int32"):
        kernel.moe_grouped(x, offsets.long(), wg, wu, wd)
    with pytest.raises(ValueError, match="alike"):
        kernel.moe_grouped(x.float(), offsets, wg, wu, wd)
    with pytest.raises(ValueError, match="multiples"):
        kernel.moe_grouped(x[:, :96].contiguous(), offsets,
                           wg[:, :96].contiguous(), wu[:, :96].contiguous(),
                           wd[:, :, :96].contiguous())
    with pytest.raises(ValueError, match="out"):
        kernel.moe_grouped(x, offsets, wg, wu, wd, out=x[1:])


def test_moe_grouped_kernel_writes_over_its_input_rows(gen):
    """``out=x``, as the serving layer calls it: bitwise the output of a
    call into a fresh tensor, written into x's own memory, and one launch
    counted."""
    from repro_torch.kernels.moe_grouped import kernel
    args = _grouped_args(gen, 300, torch.bfloat16, **QWEN_MOE)
    want = kernel.moe_grouped(*args)
    x = args[0].clone()
    before = kernel.moe_grouped.launches
    got = kernel.moe_grouped(x, *args[1:], out=x)
    torch.cuda.synchronize()
    assert got.data_ptr() == x.data_ptr()
    assert torch.equal(got, want)
    assert kernel.moe_grouped.launches == before + 1


@pytest.mark.parametrize("n", [45, 300])
def test_moe_block_at_published_widths_matches_cpu(n, gen):
    """One layer of Qwen3-30B-A3B's MoE at its published widths in f32:
    serving moe_block on the card (the grouped kernel) against the CPU's
    buffer at C = n, at a decode batch and a prompt."""
    from repro_torch import configs
    from repro_torch.models import moe
    cfg = dataclasses.replace(configs.get("qwen3-moe-30b-a3b"), num_layers=1,
                              param_dtype="float32")
    p = _moe_layer(cfg, torch.Generator().manual_seed(3))
    x = torch.randn(1, n, cfg.d_model, generator=torch.Generator()
                    .manual_seed(4))
    y_cpu, _ = moe.moe_block(p, cfg, x, capacity_factor=None)
    y, _ = moe.moe_block(_to(p, "cuda"), cfg, x.cuda(), capacity_factor=None)
    _close(y.cpu(), y_cpu, TOL[torch.float32])


def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------

# (arch, batch, seq_len) of the reduced configs, f32, at 2 layers (the
# hybrid's 3: one group and a tail layer): hybrid past its window of 64,
# ssm on whole SSD chunks, vlm past its 16 patches
TRAIN_FAMILIES = {"dense": ("smollm-135m", 2, 48),
                  "moe": ("qwen3-moe-30b-a3b", 2, 48),
                  "ssm": ("mamba2-780m", 2, 64),
                  "hybrid": ("recurrentgemma-9b", 2, 96),
                  "audio": ("whisper-small", 2, 48),
                  "vlm": ("pixtral-12b", 2, 48)}
TRAIN_RTOL = 1e-4   # loss and grad_norm, card against CPU, TF32 off


def _train_batch(cfg, b, t, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, t), generator=g),
             "labels": torch.randint(0, cfg.vocab_size, (b, t), generator=g)}
    if cfg.family == "audio":
        batch["frames"] = torch.randn(b, cfg.encoder_seq_len,
                                      cfg.frontend_dim, generator=g)
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.randn(b, cfg.num_patches,
                                            cfg.frontend_dim, generator=g)
    return {k: v.to(device) for k, v in batch.items()}


@pytest.mark.parametrize("family", sorted(TRAIN_FAMILIES))
def test_train_step_on_card_matches_cpu(family, gen, monkeypatch):
    """One train step (loss, backward, AdamW) from the same f32 weights and
    batch: the card's loss and grad_norm equal the CPU port's to rel 1e-4,
    and neither hand-written kernel launches."""
    from repro_torch import configs
    from repro_torch.kernels.flash_prefill import kernel as fp
    from repro_torch.kernels.paged_attention import kernel as pa
    from repro_torch.models import api
    from repro_torch.train import step as tstep
    from repro_torch.train.optimizer import AdamW, cosine_schedule
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    name, b, t = TRAIN_FAMILIES[family]
    cfg = configs.get(name).reduced()
    params = api.init_params(cfg, torch.Generator().manual_seed(5), "cpu")
    opt = AdamW(cosine_schedule(1e-3, 1, 10))
    before = (pa.paged_attention.launches, fp.flash_prefill.launches)
    out = {}
    for device in ("cpu", "cuda"):
        state = tstep.init_train_state(cfg, opt, device=device,
                                       params=params)
        _, metrics = tstep.make_train_step(cfg, opt)(
            state, _train_batch(cfg, b, t, device))
        out[device] = {k: float(v) for k, v in metrics.items()}
    assert (pa.paged_attention.launches, fp.flash_prefill.launches) == before
    for k in ("loss", "aux_loss", "grad_norm", "lr"):
        assert out["cuda"][k] == pytest.approx(out["cpu"][k], rel=TRAIN_RTOL,
                                               abs=1e-12), k


def test_checkpoint_bf16_on_card_without_ml_dtypes(gen, tmp_path,
                                                    monkeypatch):
    """bf16, f32 and int32 leaves on the card save and restore onto the card
    bit for bit with ``ml_dtypes`` unimportable."""
    import sys
    from repro_torch.distributed import checkpoint as ckpt
    monkeypatch.setitem(sys.modules, "ml_dtypes", None)
    tree = {"p": {"w": torch.randn(64, 48, generator=gen, device="cuda")
                  .bfloat16(),
                  "b": torch.randn(48, generator=gen, device="cuda")},
            "step": torch.tensor(3, dtype=torch.int32, device="cuda")}
    ckpt.save_checkpoint(tmp_path, 3, tree)
    step, got = ckpt.restore_checkpoint(tmp_path)
    assert step == 3
    assert got["p"]["w"].device.type == "cuda"
    assert got["p"]["w"].dtype == torch.bfloat16
    assert torch.equal(got["p"]["w"].view(torch.int16),
                       tree["p"]["w"].view(torch.int16))
    assert torch.equal(got["p"]["b"], tree["p"]["b"])
    assert got["step"].dtype == torch.int32 and int(got["step"]) == 3


def test_trainer_on_card_resumes_exactly(gen, tmp_path):
    """The reduced dense model trains on the card; a trainer resumed from
    the step-4 checkpoint repeats the uninterrupted run's losses."""
    from repro_torch import configs
    from repro_torch.train.loop import Trainer, TrainerConfig
    cfg = configs.get("smollm-135m").reduced()
    kw = dict(seq_len=64, global_batch=4, steps=8, log_every=100)
    a = Trainer(cfg, TrainerConfig(ckpt_every=4, ckpt_dir=str(tmp_path / "a"),
                                   **kw))
    ha = a.run()
    b = Trainer(cfg, TrainerConfig(ckpt_every=1000,
                                   ckpt_dir=str(tmp_path / "b"), **kw))
    hb = b.run()
    assert [h["loss"] for h in ha] == pytest.approx(
        [h["loss"] for h in hb], rel=1e-5)
    import shutil
    shutil.rmtree(tmp_path / "a" / "step_0000000008")
    c = Trainer(cfg, TrainerConfig(ckpt_every=4, ckpt_dir=str(tmp_path / "a"),
                                   **kw))
    assert c.step_idx == 4
    hc = c.run()
    assert [h["loss"] for h in hc] == pytest.approx(
        [h["loss"] for h in ha[4:]], rel=1e-5)
    assert ha[-1]["loss"] < ha[0]["loss"]


def test_mesh_trainer_on_card_equals_the_plain_trainer(gen, tmp_path):
    """The reduced dense model on a 1 x 1 mesh over a one-rank NCCL group
    gives the plain trainer's losses on the card (rel 1e-5), and its step-4
    checkpoint, written from DTensors, resumes in the plain trainer."""
    import shutil

    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.launch.mesh import init_process_group, make_mesh
    from repro_torch.train.loop import Trainer, TrainerConfig
    init_process_group("cuda", rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        assert mesh.device_type == "cuda"
        cfg = configs.get("smollm-135m").reduced()
        kw = dict(seq_len=64, global_batch=4, steps=8, ckpt_every=4,
                  log_every=100)
        hm = Trainer(cfg, TrainerConfig(ckpt_dir=str(tmp_path / "m"), **kw),
                     mesh=mesh).run()
        hp = Trainer(cfg, TrainerConfig(ckpt_dir=str(tmp_path / "p"),
                                        **kw)).run()
        assert [h["loss"] for h in hm] == pytest.approx(
            [h["loss"] for h in hp], rel=1e-5)
        step = "step_0000000004"
        shutil.copytree(tmp_path / "m" / step, tmp_path / "r" / step)
        r = Trainer(cfg, TrainerConfig(ckpt_dir=str(tmp_path / "r"), **kw))
        assert r.step_idx == 4
        assert [h["loss"] for h in r.run()] == pytest.approx(
            [h["loss"] for h in hp[4:]], rel=1e-5)
    finally:
        dist.destroy_process_group()
