#!/usr/bin/env python3
"""Brings the PyTorch port up on one NVIDIA H100 and checks it end to end.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit:
  1. the card's name and power limit; build both CUDA kernels from
     src/repro_torch/csrc (timed);
  2. each kernel against its plain PyTorch version on the card at the
     serving paths' shapes (Mistral's, Qwen3-30B-A3B's QPK 8,
     RecurrentGemma-9B's D 256 / QPK 16 with and without its 2048 window,
     Whisper-small's decoder), and at edge cases (every split of paged decode
     live, a dead tile row and the smallest head width in flash prefill),
     with its time, the plain version's time, its bound and, for flash
     prefill without a window, scaled_dot_product_attention's time as a
     yardstick. A timed kernel row also gives `device_ms`, the time of one
     call replayed from a CUDA graph of 20, which leaves out the wrapper's
     host time that `ms` includes. Timed calls cycle through copies of their
     inputs, enough that no call finds its bytes in the L2 cache: every time
     is from HBM;
  3. the serving paths, one after the other, each once the previous one's
     tensors are freed: Mistral-Small-24B (dense, 40 layers), Qwen3-30B-A3B
     (MoE, 48 layers, 128 experts, top-8), RecurrentGemma-9B (hybrid, 38
     layers: 12 (rec, rec, attn) groups and 2 rec layers) and Mamba2-780M
     (ssm, 48 layers), at full width and depth with bf16 weights drawn from
     a seeded torch.Generator, each serving 4 requests through LLMEngine:
     the paged path for the first two, the slot-state executor for the
     others. Each path's kernel launches must equal its attention layers x
     the model passes that ran them (none of either kernel for Mamba2, no
     paged decode for the state paths). Then one decode step at the run's
     last contexts, timed alone: its wall time, its device time and its
     byte bound;
  4. after each path, its architecture cut to 2 layers (RecurrentGemma to 5:
     a group and a tail), f32: the engine's greedy tokens (kernel path)
     must equal those of the plain oracle (plain attention in prefill, the
     model's decode_step);
  5. Whisper-small (audio, 12 + 12 layers) at full width through the model
     API: prefill_fn on seeded 1500 x 80 frames (flash prefill launched 12
     times) and 16 decode steps, timed as above; then at 2 layers f32 its
     greedy tokens with the kernel equal those with plain attention;
  6. one JSON line of per-kernel numbers, all measured in this run but the
     computed bounds, then the result line.
The port is imported from src/ next to this file; JAX is never imported.
"""
from __future__ import annotations

import dataclasses
import functools
import gc
import itertools
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12                 # H100 SXM data sheet
L2_BYTES = 50 * 2**20                     # H100 SXM L2 cache
PEAK_OPS = {torch.bfloat16: 989e12,       # dense tensor-core bf16
            torch.float32: 67e12}         # f32 outside the tensor cores
# (atol, rtol) of |out - ref| <= atol + rtol * |ref|. Both kernels compute in
# f32, as the plain versions do; a bf16 output differs from the plain one by
# its rounding, at most one bf16 step (2^-7 of |ref|), plus f32 arithmetic.
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-3, 8e-3)}
# the serving paths, in order, with their depth
LAYERS = {"mistral-small-24b": 40, "qwen3-moe-30b-a3b": 48,
          "recurrentgemma-9b": 38, "mamba2-780m": 48}
ORACLE_LAYERS = {"recurrentgemma-9b": 5}   # others: 2
AUDIO = "whisper-small"
AUDIO_PROMPT = 37                          # decoder prompt tokens


def check(cond, msg):
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(fn, iters=20, warmup=3):
    """Median time of one call, from CUDA events around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def graph_ms(fn, n=20):
    """Time of one call replayed from a CUDA graph of n calls: the device
    time, without the host time of the Python wrapper."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(n):
            fn()
    g.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    g.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def cold(fn, args, live_bytes):
    """A call of fn that cycles through copies of args, enough that the
    other copies' live bytes, read between two uses of one copy, exceed
    twice the L2: each call reads its inputs from HBM."""
    n = 1 + -(-2 * L2_BYTES // live_bytes)
    sets = itertools.cycle(
        [args] + [tuple(a.clone() if isinstance(a, torch.Tensor) else a
                        for a in args) for _ in range(n - 1)])
    return lambda: fn(*next(sets))


def compare(out, ref):
    """Max abs error, and whether |out - ref| <= atol + rtol * |ref|."""
    atol, rtol = TOL[out.dtype]
    err = (out.float() - ref.float()).abs()
    ok = bool((err <= atol + rtol * ref.float().abs()).all())
    return float(err.max()), ok


def bound(n_bytes, n_ops, dtype):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def size(t):
    return t.numel() * t.element_size()


# --------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------

def paged_case(gen, q_dtype, kv_dtype, timed, ctx=None, kv=8):
    """S 4, H 32, KV 8 (Mistral) or 4 (Qwen3-30B-A3B), D 128, BS 16, MB 256.
    ctx None: random contexts, ctx 1 and the full table among them."""
    from repro_torch.kernels.paged_attention import kernel, ref
    s, h, d, bs, mb = 4, 32, 128, 16, 256
    nb = s * mb + 1
    dev = "cuda"
    q = torch.randn(s, h, d, generator=gen, device=dev).to(q_dtype)
    pk = torch.randn(nb, bs, kv, d, generator=gen, device=dev).to(kv_dtype)
    pv = torch.randn(nb, bs, kv, d, generator=gen, device=dev).to(kv_dtype)
    bt = torch.randint(0, nb, (s, mb), generator=gen, device=dev,
                       dtype=torch.int32)
    lens = torch.randint(1, mb * bs + 1, (s,), generator=gen, device=dev,
                         dtype=torch.int32)
    lens[0] = 1                                   # ctx 1 and the full table
    lens[1] = mb * bs
    if ctx is not None:
        lens = torch.tensor(ctx, device=dev, dtype=torch.int32)
    args = (q, pk, pv, bt, lens)
    out = kernel.paged_attention(*args)
    torch.cuda.synchronize()
    err, ok = compare(out, ref.paged_attention_ref(*args))
    row = {"case": f"paged q={q_dtype} pool={kv_dtype} S={s} H={h} KV={kv} "
                   f"D={d} BS={bs} MB={mb} ctx={lens.tolist()}",
           "max_abs_err": err, "ok": ok}
    if timed:
        ctx = sum(min(c, mb * bs) for c in lens.tolist())
        live = ctx * kv * d * 2 * pk.element_size()
        pages = sum(-(-min(c, mb * bs) // bs) for c in lens.tolist())
        n_bytes = live + size(q) + size(out) + 4 * pages + size(lens)
        n_ops = 4 * h * d * ctx
        row["ms"] = cuda_ms(cold(kernel.paged_attention, args, live))
        row["device_ms"] = graph_ms(cold(kernel.paged_attention, args, live))
        row["plain_ms"] = cuda_ms(cold(ref.paged_attention_ref, args, live))
        row["bound_ms"], row["bound_by"] = bound(n_bytes, n_ops, kv_dtype)
        row["library_ms"] = None     # no single PyTorch call does paged decode
    return row


def visible_pairs(t, window):
    return sum(min(i + 1, window) if window else i + 1 for i in range(t))


def flash_case(gen, dtype, t, window, timed, h=32, kv=8, d=128):
    from repro_torch.kernels.flash_prefill import kernel, ref
    b = 1
    dev = "cuda"
    q = torch.randn(b, t, h, d, generator=gen, device=dev).to(dtype)
    k = torch.randn(b, t, kv, d, generator=gen, device=dev).to(dtype)
    v = torch.randn(b, t, kv, d, generator=gen, device=dev).to(dtype)
    out = kernel.flash_prefill(q, k, v, window)
    torch.cuda.synchronize()
    err, ok = compare(out, ref.flash_prefill_ref(q, k, v, window))
    row = {"case": f"flash {dtype} B={b} T={t} H={h} KV={kv} D={d} "
                   f"window={window}", "max_abs_err": err, "ok": ok}
    if timed:
        n_bytes = size(q) + size(k) + size(v) + size(out)
        n_ops = 4 * d * h * b * visible_pairs(t, window)
        row["ms"] = cuda_ms(cold(kernel.flash_prefill, (q, k, v, window),
                                 n_bytes))
        row["device_ms"] = graph_ms(cold(kernel.flash_prefill,
                                         (q, k, v, window), n_bytes))
        row["plain_ms"] = cuda_ms(cold(ref.flash_prefill_ref,
                                       (q, k, v, window), n_bytes))
        row["bound_ms"], row["bound_by"] = bound(n_bytes, n_ops, dtype)
        row["library_ms"] = None
        if window == 0:   # yardstick only; the port never calls it
            sq = q.transpose(1, 2)
            sk = k.repeat_interleave(h // kv, dim=2).transpose(1, 2)
            sv = v.repeat_interleave(h // kv, dim=2).transpose(1, 2)
            sdpa = torch.nn.functional.scaled_dot_product_attention
            row["library_ms"] = cuda_ms(cold(
                functools.partial(sdpa, is_causal=True), (sq, sk, sv),
                n_bytes))
    return row


def phase_kernels():
    gen = torch.Generator("cuda").manual_seed(1234)
    bf16, f32 = torch.bfloat16, torch.float32
    rows = {
        "paged_attention": paged_case(gen, bf16, f32, timed=True),
        "flash_prefill": flash_case(gen, bf16, 1500, 0, timed=True),
    }
    others = [paged_case(gen, f32, f32, True), paged_case(gen, bf16, bf16, True),
              # the main path's contexts at its last decode step
              paged_case(gen, bf16, f32, True, ctx=[52, 315, 1015, 1515]),
              # every split of one sequence live, the others one token
              paged_case(gen, bf16, f32, False, ctx=[256 * 16, 1, 1, 1]),
              flash_case(gen, bf16, 37, 0, False),
              flash_case(gen, bf16, 300, 0, True),
              flash_case(gen, bf16, 1000, 0, True),
              flash_case(gen, bf16, 2048, 0, True),
              flash_case(gen, bf16, 2048, 256, True),
              flash_case(gen, f32, 1500, 0, True),
              # QPK 3: 63 live rows of 64; the smallest head width
              flash_case(gen, bf16, 1000, 0, False, h=9, kv=3, d=64),
              # the MoE path's attention: Qwen3-30B-A3B, QPK 8
              paged_case(gen, bf16, f32, True, kv=4),
              paged_case(gen, bf16, f32, True, ctx=[52, 315, 1015, 1515],
                         kv=4),
              flash_case(gen, bf16, 1500, 0, True, kv=4),
              flash_case(gen, bf16, 37, 0, False, kv=4),
              # the hybrid path's attention: RecurrentGemma-9B, D 256,
              # QPK 16, its 2048 window; past the window; ragged T
              flash_case(gen, bf16, 1500, 0, True, h=16, kv=1, d=256),
              flash_case(gen, bf16, 3072, 2048, True, h=16, kv=1, d=256),
              flash_case(gen, bf16, 37, 2048, False, h=16, kv=1, d=256),
              flash_case(gen, bf16, 1499, 2048, False, h=16, kv=1, d=256),
              flash_case(gen, f32, 300, 2048, False, h=16, kv=1, d=256),
              # Whisper-small's decoder self-attention
              flash_case(gen, bf16, AUDIO_PROMPT, 0, False, h=12, kv=12,
                         d=64)]
    for row in list(rows.values()) + others:
        print("kernel-check " + json.dumps(row))
        check(row["ok"], f"kernel disagrees with its plain version: {row}")
    return rows


# --------------------------------------------------------------------------
# phases 3 to 5: the serving paths
# --------------------------------------------------------------------------

def reset_counts():
    from repro_torch.kernels.flash_prefill import kernel as fp
    from repro_torch.kernels.paged_attention import kernel as pa
    pa.paged_attention.launches = 0
    fp.flash_prefill.launches = 0


def read_counts():
    from repro_torch.kernels.flash_prefill import kernel as fp
    from repro_torch.kernels.paged_attention import kernel as pa
    return {"paged_attention": pa.paged_attention.launches,
            "flash_prefill": fp.flash_prefill.launches}


def attention_layers(cfg):
    """Layers that run attention: every one, a third of the hybrid's (one
    per (rec, rec, attn) group), none of mamba2's."""
    return {"ssm": 0, "hybrid": cfg.num_layers // 3}.get(cfg.family,
                                                        cfg.num_layers)


def expected_counts(cfg, ex):
    """The launches a run of the engine's executor must have made."""
    return {"paged_attention": cfg.num_layers * ex.decode_steps
            if ex.paged else 0,
            "flash_prefill": attention_layers(cfg) * ex.prefill_computes}


def phase_path(cfg):
    """``cfg`` at full width and depth serves the 4 requests through the
    engine; returns the kernels' launches in that run."""
    from repro_torch.launch import serve
    from repro_torch.models import api
    t0 = time.perf_counter()
    params = api.init_params(cfg, torch.Generator("cuda").manual_seed(0),
                             "cuda")
    torch.cuda.synchronize()
    name = cfg.name
    print(f"path {name}: family={cfg.family} layers={cfg.num_layers} "
          f"d_model={cfg.d_model} {cfg.param_dtype} weights "
          f"{sum(size(t) for t in _leaves(params)) / 1e9:.2f} GB, init "
          f"{time.perf_counter() - t0:.1f} s")
    engine = serve.build_engine(cfg, params, "cuda", num_blocks=1024,
                                block_size=16, max_num_seqs=8,
                                max_prefill_tokens=512, max_model_len=4096)
    lens = serve.prompt_lens(cfg)
    prompts = serve.make_prompts(cfg.vocab_size, lens, seed=0)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    reqs, timing = serve.serve(engine, prompts, serve.NEW_TOKENS)
    wall = time.perf_counter() - t0
    counts = read_counts()
    ex = engine.executor
    for r, t in zip(reqs, timing):
        print(f"path {name} request " + json.dumps(
            {"prompt_len": r.prompt_len, "status": r.status.value, **t,
             "tokens": r.output_tokens}))
    n = sum(len(r.output_tokens) for r in reqs)
    print(f"path {name} " + json.dumps(
        {"wall_s": wall, "output_tokens": n, "tokens_per_s": n / wall,
         "decode_steps": ex.decode_steps,
         "prefill_computes": ex.prefill_computes, "launches": counts,
         "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}))
    check(all(r.status.value == "finished"
              and len(r.output_tokens) == serve.NEW_TOKENS for r in reqs),
          f"{name}: not every request finished with its tokens")
    check(ex.prefill_computes == len(lens) and ex.decode_steps > 0,
          f"{name}: {ex.prefill_computes} prefill computes, "
          f"{ex.decode_steps} decode steps")
    check(counts == expected_counts(cfg, ex),
          f"{name}: launches {counts}, want {expected_counts(cfg, ex)}")
    # the output itself: finite logits of the expected shape
    toks = torch.tensor(prompts[0], device="cuda")[None]
    logits, _ = api.prefill_fn(params, cfg, {"tokens": toks})
    check(tuple(logits.shape) == (1, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()), f"{name}: bad logits")
    ctx = tuple(n + serve.NEW_TOKENS - 1 for n in lens)
    step = (decode_step_timing(cfg, params, ex.pool, ctx) if ex.paged
            else state_step_timing(cfg, params, ctx))
    print(f"path {name} decode-step " + json.dumps(step))
    return counts


def time_step(step):
    """`ms` (CUDA events around a call: the host's launches included),
    `device_ms` (the kernels' device time from torch.profiler), and the
    step's five costliest kernels and five costliest PyTorch ops by the
    device time of the kernels each launched itself (ms and calls a
    step)."""
    from repro_torch.launch import serve
    ms = cuda_ms(step, iters=5, warmup=1)
    from torch.profiler import ProfilerActivity, profile
    n = 3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    by_kernel = serve.device_time_by_kernel(prof, 1.0, top=5)
    kernels = [{"name": k["name"], "calls": k["calls"] / n,
                "device_ms": k["device_ms"] / n}
               for k in by_kernel["kernels"][:5]]
    ops = sorted(((getattr(e, "self_device_time_total", None)
                   or getattr(e, "self_cuda_time_total", 0.0), e.count,
                   e.key) for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CPU),
                 reverse=True)[:5]
    ops = [{"name": k, "calls": c / n, "device_ms": us / 1e3 / n}
           for us, c, k in ops if us > 0]
    return ms, by_kernel["device_busy_s"] * 1e3 / n, kernels, ops


def weight_bytes(params, s):
    """The weights a decode step of s sequences reads: every leaf once, but
    of the token embedding and the learned decoder positions only the rows
    looked up (the whole table where a tied head reads it), and nothing of
    an encoder."""
    encoder = ("frontend", "pos_enc", "enc_layers", "enc_norm")
    n = sum(size(t) for k, v in params.items() if k not in encoder
            for t in (_leaves(v) if isinstance(v, dict) else (v,)))
    for table in (params["embedding"]["tok"], params.get("pos_dec")):
        if table is not None:
            n += s * size(table[0]) - size(table)
    if "unembed" not in params["embedding"]:   # tied: the head reads it all
        n += size(params["embedding"]["tok"])
    return n


def step_row(ctx, timing, weights, other, other_name):
    ms, device_ms, kernels, ops = timing
    return {"ctx": list(ctx), "ms": ms, "device_ms": device_ms,
            "bound_ms": (weights + other) / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "weight_gb_read": weights / 1e9,
            other_name: other / 1e9, "top_kernels": kernels,
            "top_ops": ops}


def decode_step_timing(cfg, params, pool, ctx):
    """One paged decode step of 4 sequences at the run's last contexts,
    timed; its byte bound: the weights read once, the live KV read and the
    new KV written."""
    from repro_torch.engine import paged_model
    s, bs = len(ctx), pool["k"].shape[2]
    pages = [-(-c // bs) for c in ctx]
    mb = -(-4096 // bs)
    perm = torch.randperm(pool["k"].shape[1], device="cuda",
                          generator=torch.Generator("cuda").manual_seed(5))
    bt = torch.zeros((s, mb), dtype=torch.int32, device="cuda")
    used = 0
    for i, p in enumerate(pages):
        bt[i, :p] = perm[used:used + p].int()
        used += p
    toks = torch.arange(1, s + 1, device="cuda")
    pos = torch.tensor([c - 1 for c in ctx], device="cuda")
    timing = time_step(
        lambda: paged_model.decode_step(params, cfg, toks, pos, pool, bt))
    kv_token = 2 * cfg.num_layers * cfg.num_kv_heads * cfg.head_dim \
        * pool["k"].element_size()
    return step_row(ctx, timing, weight_bytes(params, s),
                    kv_token * (sum(ctx) + s), "kv_gb_read")


def state_step_timing(cfg, params, ctx):
    """One decode step of the slot-state families for 4 sequences, on caches
    in the model's own dtypes (as the executor hands them over), timed; its
    byte bound: the weights read once, each recurrent state read and
    written, the live window of the hybrid's KV read and its new row
    written."""
    from repro_torch.models import api
    s = len(ctx)
    cache = api.init_cache(cfg, s, 4096,
                           dtype=params["embedding"]["tok"].dtype,
                           device="cuda")
    toks = torch.arange(1, s + 1, device="cuda")
    pos = torch.tensor([c - 1 for c in ctx], device="cuda")
    timing = time_step(lambda: api.decode_fn(params, cfg, toks, cache, pos))
    state = 0
    for key, leaf in cache.items():
        if key in ("g_k", "g_v"):   # (groups, B, window, KV, D)
            row = leaf.shape[0] * size(leaf[0, 0, 0])
            state += row * sum(min(c, cfg.attn_window) for c in ctx)
        else:
            state += 2 * size(leaf)
    return step_row(ctx, timing, weight_bytes(params, s), state,
                    "state_gb_moved")


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def oracle_generate(cfg, params, prompt, n_new):
    """Greedy tokens with plain attention: prefill with chunked_causal_mha,
    then the model's own decode_step on a dense (or state) cache (the
    counterpart of the JAX tests' oracle_generate)."""
    from repro_torch.models import api
    from repro_torch.models import common as cm
    toks = torch.tensor(prompt, device="cuda")[None]
    logits, cache = api.prefill_fn(params, cfg, {"tokens": toks},
                                   attention=cm.plain_prefill_attention)
    cache = api.pad_cache(cfg, cache, len(prompt) + n_new + 8)
    out = [int(logits[0].argmax())]
    for i in range(n_new - 1):
        pos = torch.tensor([len(prompt) + i], device="cuda")
        logits, cache = api.decode_fn(
            params, cfg, torch.tensor([out[-1]], device="cuda"), cache, pos)
        out.append(int(logits[0].argmax()))
    return out


def phase_oracle(cfg):
    from repro_torch.launch import serve
    from repro_torch.models import api
    params = api.init_params(cfg, torch.Generator("cuda").manual_seed(1),
                             "cuda")
    engine = serve.build_engine(cfg, params, "cuda", num_blocks=1024,
                                block_size=16, max_num_seqs=8,
                                max_prefill_tokens=512, max_model_len=4096)
    prompts = serve.make_prompts(cfg.vocab_size, serve.prompt_lens(cfg),
                                 seed=1)
    reset_counts()
    reqs, _ = serve.serve(engine, prompts, serve.NEW_TOKENS)
    counts = read_counts()
    oracle = [oracle_generate(cfg, params, p, serve.NEW_TOKENS)
              for p in prompts]
    same = [r.output_tokens == o for r, o in zip(reqs, oracle)]
    print(f"oracle {cfg.name} " + json.dumps(
        {"layers": cfg.num_layers, "dtype": cfg.param_dtype, "equal": same,
         "launches": counts}))
    check(all(same), f"{cfg.name}: kernel path and plain oracle disagree on "
                     f"tokens")
    want = expected_counts(cfg, engine.executor)
    check(counts == want, f"{cfg.name}: launches {counts}, want {want}")


def audio_generate(cfg, params, prompt, frames, n_steps, attention=None):
    """Greedy decoding through the model API: prefill_fn on the frames and
    the prompt, then ``n_steps`` decode steps. Returns the tokens and the
    cache."""
    from repro_torch.models import api
    toks = torch.tensor(prompt, device="cuda")[None]
    logits, cache = api.prefill_fn(params, cfg, {"tokens": toks,
                                                 "frames": frames},
                                   attention=attention)
    cache = api.pad_cache(cfg, cache, len(prompt) + n_steps + 8)
    out = [int(logits[0].argmax())]
    for i in range(n_steps):
        pos = torch.tensor([len(prompt) + i], device="cuda")
        logits, cache = api.decode_fn(
            params, cfg, torch.tensor([out[-1]], device="cuda"), cache, pos)
        out.append(int(logits[0].argmax()))
    check(tuple(logits.shape) == (1, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()), f"{cfg.name}: bad logits")
    return out, cache


def phase_audio(cfg):
    """Whisper-small at full width through the model API: one clip's seeded
    frames, a prompt, 16 decode steps; flash prefill runs the decoder's
    causal self-attention once a layer. Returns the kernels' launches."""
    from repro_torch.launch import serve
    from repro_torch.models import api
    params = api.init_params(cfg, torch.Generator("cuda").manual_seed(0),
                             "cuda")
    frames = torch.randn(1, cfg.encoder_seq_len, cfg.frontend_dim,
                         generator=torch.Generator("cuda").manual_seed(2),
                         device="cuda")
    prompt = serve.make_prompts(cfg.vocab_size, (AUDIO_PROMPT,), seed=0)[0]
    print(f"path {cfg.name}: family={cfg.family} layers={cfg.num_layers}+"
          f"{cfg.encoder_layers} d_model={cfg.d_model} {cfg.param_dtype} "
          f"weights {sum(size(t) for t in _leaves(params)) / 1e9:.2f} GB")
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    toks, cache = audio_generate(cfg, params, prompt, frames,
                                 serve.NEW_TOKENS)
    wall = time.perf_counter() - t0
    counts = read_counts()
    print(f"path {cfg.name} " + json.dumps(
        {"wall_s": wall, "prompt_len": len(prompt), "decode_steps":
         serve.NEW_TOKENS, "tokens": toks, "tokens_per_s": len(toks) / wall,
         "launches": counts,
         "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}))
    want = {"paged_attention": 0, "flash_prefill": attention_layers(cfg)}
    check(counts == want, f"{cfg.name}: launches {counts}, want {want}")
    ctx = len(prompt) + serve.NEW_TOKENS + 1
    toks_t = torch.tensor([1], device="cuda")
    pos = torch.tensor([ctx - 1], device="cuda")
    timing = time_step(
        lambda: api.decode_fn(params, cfg, toks_t, cache, pos))
    kv = cache["k"]                      # (L, B, S, KV, D)
    row = kv.shape[0] * size(kv[0, 0, 0])
    other = 2 * row * ctx + size(cache["ck"]) + size(cache["cv"])
    print(f"path {cfg.name} decode-step " + json.dumps(step_row(
        (ctx,), timing, weight_bytes(params, 1), other, "kv_gb_read")))
    return counts


def phase_audio_oracle(cfg):
    """At 2 layers f32: greedy tokens with the flash-prefill kernel equal
    those with plain attention."""
    from repro_torch.launch import serve
    from repro_torch.models import api
    from repro_torch.models import common as cm
    params = api.init_params(cfg, torch.Generator("cuda").manual_seed(1),
                             "cuda")
    frames = torch.randn(1, cfg.encoder_seq_len, cfg.frontend_dim,
                         generator=torch.Generator("cuda").manual_seed(3),
                         device="cuda")
    prompt = serve.make_prompts(cfg.vocab_size, (AUDIO_PROMPT,), seed=1)[0]
    reset_counts()
    kernel, _ = audio_generate(cfg, params, prompt, frames, serve.NEW_TOKENS)
    counts = read_counts()
    plain, _ = audio_generate(cfg, params, prompt, frames, serve.NEW_TOKENS,
                              attention=cm.plain_prefill_attention)
    print(f"oracle {cfg.name} " + json.dumps(
        {"layers": cfg.num_layers, "dtype": cfg.param_dtype,
         "equal": kernel == plain, "launches": counts}))
    check(kernel == plain, f"{cfg.name}: kernel path and plain attention "
                           f"disagree on tokens")
    check(counts["flash_prefill"] == cfg.num_layers,
          f"{cfg.name}: launches {counts}")


def free_the_card():
    """Drop every tensor a finished phase left behind; the next path's
    weights need the card to themselves."""
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    print(f"memory allocated between paths: {held / 1e9:.3f} GB")
    check(held < 1e9, f"{held / 1e9:.2f} GB still allocated")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import configs
    from repro_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    reports = build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s for {sorted(reports)}")
    for name, text in reports.items():
        for line in text.splitlines():
            if any(w in line for w in ("registers", "spill", "setmaxnreg",
                                       "Compiling entry")):
                print(f"ptxas {name}: {line.strip()}")

    rows = phase_kernels()

    launches = {}
    for name, layers in LAYERS.items():
        cfg = configs.get(name)
        check(cfg.num_layers == layers, f"{name} is not {layers} layers")
        free_the_card()
        launches[name] = phase_path(cfg)
        free_the_card()
        phase_oracle(dataclasses.replace(
            cfg, num_layers=ORACLE_LAYERS.get(name, 2),
            param_dtype="float32"))
    cfg = configs.get(AUDIO)
    free_the_card()
    launches[AUDIO] = phase_audio(cfg)
    free_the_card()
    phase_audio_oracle(dataclasses.replace(cfg, num_layers=2,
                                           encoder_layers=2,
                                           param_dtype="float32"))

    sources = {"paged_attention": ("src/repro_torch/csrc/paged_attention.cu",
                                   "src/repro/kernels/paged_attention/"
                                   "kernel.py:28"),
               "flash_prefill": ("src/repro_torch/csrc/flash_prefill.cu",
                                 "src/repro/kernels/flash_prefill/"
                                 "kernel.py:28")}
    # `launches` is the main path's (Mistral's); every path's is beside it
    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": rep,
                "launches": launches["mistral-small-24b"][name],
                "launches_by_path": {p: c[name] for p, c in launches.items()},
                "max_abs_err": rows[name]["max_abs_err"],
                "ms": rows[name]["ms"], "plain_ms": rows[name]["plain_ms"],
                "bound_ms": rows[name]["bound_ms"],
                "bound_by": rows[name]["bound_by"],
                "library_ms": rows[name]["library_ms"],
                "device_ms": rows[name]["device_ms"]}
               for name, (src, rep) in sources.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
