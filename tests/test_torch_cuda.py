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
    """Reduced qwen3-moe served on the card (both kernels, MoE dispatch on
    the device) gives the CPU port's greedy tokens, f32 pool; the 90-token
    prompt prefills with the capacity below n."""
    from repro_torch import configs
    from repro_torch.config import GPU_H100
    from repro_torch.engine.engine import LLMEngine
    from repro_torch.engine.executor import RealExecutor
    from repro_torch.engine.request import Request, SamplingParams
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
        now = 0.0
        while eng.has_work():
            now += max(eng.step(now).elapsed, 1e-4)
        outs[device] = [r.output_tokens for r in reqs]
    assert outs["cuda"] == outs["cpu"]


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
    """moe_block on the card against its CPU result in f32: 16 tokens
    (cap = n), 300 tokens with a router skewed so that expert 0 drops
    entries, and a zero router that ties every expert (lowest ids win)."""
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
    """bf16 at Qwen3-30B-A3B's widths over a 1500-token prefill (capacity
    188 of 1500): two calls give bitwise the same output."""
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


def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}
