#!/usr/bin/env python3
"""Brings the PyTorch port up on one NVIDIA H100 and checks it end to end.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit:
  1. the card's name and power limit; build both CUDA kernels from
     src/repro_torch/csrc (timed);
  2. each kernel against its plain PyTorch version on the card at the
     serving paths' shapes (Mistral's, Qwen3-30B-A3B's QPK 8,
     RecurrentGemma-9B's D 256 / QPK 16 with and without its 2048 window,
     Whisper-small's decoder at T 37 and 448), and at edge cases (every
     split of paged decode live, a dead tile row and the smallest head
     width in flash prefill),
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
     byte bound. Right after Mistral's path, on its params (not drawn
     again) once its engine and pool are freed, the control plane serves
     the same 4 prompts as streaming completions: ControlPlane (Slurm
     simulation, Web Gateway, router) with two replicas of LLMEngine over
     RealExecutor on the one card, stepping in turn. Every stream must
     finish with its 16 tokens, equal to the engine's output tokens; both
     replicas must have served; the launches must equal the layers x the
     two executors' passes. It prints each request's virtual and wall-clock
     TTFT and latency, and the run's wall time split into LLMEngine.step
     (RealExecutor.step within it) and the rest, the plane's own host time.
     Then the same plane serves the paper's Table-1 traffic, a burst of 100
     (benchmarks/table1.py's concurrent_burst), with the same checks and
     times as quantiles;
  4. after each path, its architecture cut to 2 layers (RecurrentGemma to 5:
     a group and a tail), f32: the engine's greedy tokens (kernel path)
     must equal those of the plain oracle (plain attention in prefill, the
     model's decode_step); for Mistral, the control plane's streamed tokens
     too;
  5. Whisper-small (audio, 12 + 12 layers) at full width through the model
     API: prefill_fn on seeded 1500 x 80 frames (flash prefill launched 12
     times) and 16 decode steps, timed as above; then at 2 layers f32 its
     greedy tokens with the kernel equal those with plain attention;
  6. training: SmolLM-135M at full width and depth (30 layers, bf16
     weights from a seeded torch.Generator) through the port's Trainer on
     TokenPipeline data at vocab 49 152, seq_len 2048, global batch 8: 20
     steps with a checkpoint at step 10; a second Trainer on that directory
     resumes at step 10 and must repeat the uninterrupted run's losses to
     rel 1e-5; the loss must fall from its first step (near ln 49 152).
     Neither kernel may launch (they have no backward; attention trains
     through the plain chunked_causal_mha). Prints the median step's wall
     time and tokens/s, one step's device time from torch.profiler with the
     device's busy share and its five costliest kernels and ops, the step's
     operation bound (6 x params x tokens plus causal attention's forward
     and backward, at the bf16 peak) and the step's share of it, and the
     peak memory. Then, per family (dense, moe, ssm, hybrid at its 3-layer
     reduced shape, audio, vlm), the reduced config at 2 layers in f32: one
     train step on the card gives the CPU's loss and grad_norm to rel 1e-4;
  7. the control plane's own host time per request with the roofline
     simulator as engine (no card work): Table-1 GPU-L bursts of 100, 500
     and 1000, through the Web Gateway and straight into the instance, and
     `python -m repro_torch.launch.serve` with its defaults;
  8. the dry run (launch/dryrun.py: DTensors on meta shards over a fake
     process group) grounded on the card: Mistral-Small-24B's decode step
     at 4 x 4096 and SmolLM-135M's train step at 2048 x 8 on a 1 x 1 mesh,
     whose state and input bytes must equal those of the same arguments
     materialised on the card, and whose FLOPs must equal
     FlopCounterMode's count of one real step there (neither kernel
     launches: the steps are the plain ones); then two production cells
     through `python -m repro_torch.launch.dryrun` on this machine's CPU
     (Mistral-Small-24B x decode_32k on the 16 x 16 mesh, Qwen3-30B-A3B x
     train_4k on the 2 x 16 x 16 mesh), each with its lower time;
  9. one JSON line of per-kernel numbers, all measured in this run but the
     computed bounds, then the result line.
The port is imported from src/ next to this file; JAX is never imported.
TF32 is off throughout.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import itertools
import json
import statistics
import math
import os
import re
import subprocess
import sys
import tempfile
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
AUDIO_MAX_PROMPT = 448                     # the decoder's longest prompt
PLANE = "mistral-small-24b"                # served through the control plane
PLANE_BURST = 100                          # Table-1's smallest concurrency
PLANE_HOST_BURSTS = (100, 500, 1000)       # Table-1's concurrencies
TRAIN = "smollm-135m"                      # trained at full width and depth
TRAIN_SEQ, TRAIN_BATCH = 2048, 8           # its pretraining context
TRAIN_STEPS, TRAIN_CKPT = 20, 10           # the resumed run starts at 10
TRAIN_RESUME_RTOL = 1e-5                   # resumed against uninterrupted
# (arch, batch, seq_len) of the reduced f32 configs at 2 layers (the
# hybrid's 3): hybrid past its window of 64, ssm on whole SSD chunks, vlm
# past its 16 patches
TRAIN_FAMILIES = {"dense": ("smollm-135m", 2, 48),
                  "moe": ("qwen3-moe-30b-a3b", 2, 48),
                  "ssm": ("mamba2-780m", 2, 64),
                  "hybrid": ("recurrentgemma-9b", 2, 96),
                  "audio": ("whisper-small", 2, 48),
                  "vlm": ("pixtral-12b", 2, 48)}
TRAIN_FAMILY_RTOL = 1e-4                   # card against CPU, TF32 off
# the dry run grounded on the card, on a 1 x 1 mesh: (arch, seq_len, batch,
# kind) at this script's engine size (4 sequences x max_model_len 4096) and
# at the training phase's shape
DRYRUN_GROUNDED = (("mistral-small-24b", 4096, 4, "decode"),
                   (TRAIN, TRAIN_SEQ, TRAIN_BATCH, "train"))
# production cells, each through `python -m repro_torch.launch.dryrun`
DRYRUN_CELLS = (("mistral-small-24b", "decode_32k", "single"),
                ("qwen3-moe-30b-a3b", "train_4k", "multi"))
# a kernel's kind, by the first pattern its name matches (any case)
KERNEL_KINDS = {"products": r"gemm|nvjet|xmma|cutlass|s16816|s1688",
                "softmax": r"softmax",
                "elementwise, copies, reductions":
                    r"elementwise|copy|reduce|fill|cat|index|gather|"
                    r"scatter|embedding|where"}


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
              # Whisper-small's decoder self-attention, its path's prompt
              # and its longest
              flash_case(gen, bf16, AUDIO_PROMPT, 0, True, h=12, kv=12,
                         d=64),
              flash_case(gen, bf16, AUDIO_MAX_PROMPT, 0, True, h=12, kv=12,
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
    engine; returns the kernels' launches in that run and the params."""
    from repro_torch.launch import drive
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
    engine = drive.build_engine(cfg, params, "cuda", num_blocks=1024,
                                block_size=16, max_num_seqs=8,
                                max_prefill_tokens=512, max_model_len=4096)
    lens = drive.prompt_lens(cfg)
    prompts = drive.make_prompts(cfg.vocab_size, lens, seed=0)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    reqs, timing = drive.serve(engine, prompts, drive.NEW_TOKENS)
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
              and len(r.output_tokens) == drive.NEW_TOKENS for r in reqs),
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
    ctx = tuple(n + drive.NEW_TOKENS - 1 for n in lens)
    step = (decode_step_timing(cfg, params, ex.pool, ctx) if ex.paged
            else state_step_timing(cfg, params, ctx))
    print(f"path {name} decode-step " + json.dumps(step))
    return counts, params


def time_step(step, iters=5, n=3, kinds=None):
    """`ms` (CUDA events around a call: the host's launches included),
    `device_ms` (the kernels' device time from torch.profiler over n
    calls), and the step's five costliest kernels and five costliest
    PyTorch ops by the device time of the kernels each launched itself (ms
    and calls a step). With ``kinds`` ({kind: kernel-name pattern}), also
    the device time a step by the first kind whose pattern a kernel's name
    matches in any case ("other" for none), as a fifth item, and the five
    costliest kernels of "other" as a sixth."""
    from repro_torch.launch import drive
    ms = cuda_ms(step, iters=iters, warmup=1)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    by_kernel = drive.device_time_by_kernel(prof, 1.0, top=10 ** 6)
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
    out = (ms, by_kernel["device_busy_s"] * 1e3 / n, kernels, ops)
    if kinds is None:
        return out
    split = dict.fromkeys([*kinds, "other"], 0.0)
    other = []
    for k in by_kernel["kernels"]:
        kind = next((kd for kd, pat in kinds.items()
                     if re.search(pat, k["name"], re.I)), "other")
        split[kind] += k["device_ms"] / n
        if kind == "other" and len(other) < 5:
            other.append({"name": k["name"], "device_ms": k["device_ms"] / n})
    return out + (split, other)


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
    """At 2 layers f32 (RecurrentGemma 5): the engine's greedy tokens on the
    kernel path equal the plain oracle's. Returns the params, the prompts
    and the oracle's tokens."""
    from repro_torch.launch import drive
    from repro_torch.models import api
    params = api.init_params(cfg, torch.Generator("cuda").manual_seed(1),
                             "cuda")
    engine = drive.build_engine(cfg, params, "cuda", num_blocks=1024,
                                block_size=16, max_num_seqs=8,
                                max_prefill_tokens=512, max_model_len=4096)
    prompts = drive.make_prompts(cfg.vocab_size, drive.prompt_lens(cfg),
                                 seed=1)
    reset_counts()
    reqs, _ = drive.serve(engine, prompts, drive.NEW_TOKENS)
    counts = read_counts()
    oracle = [oracle_generate(cfg, params, p, drive.NEW_TOKENS)
              for p in prompts]
    same = [r.output_tokens == o for r, o in zip(reqs, oracle)]
    print(f"oracle {cfg.name} " + json.dumps(
        {"layers": cfg.num_layers, "dtype": cfg.param_dtype, "equal": same,
         "launches": counts}))
    check(all(same), f"{cfg.name}: kernel path and plain oracle disagree on "
                     f"tokens")
    want = expected_counts(cfg, engine.executor)
    check(counts == want, f"{cfg.name}: launches {counts}, want {want}")
    return params, prompts, oracle


def timed_steps(engine, times, card=False):
    """Appends the wall seconds of each ``engine.step`` to
    ``times["engine"]`` and, with ``card``, of each ``RealExecutor.step``
    (synchronized before and after) to ``times["executor"]``."""
    inner = engine.step

    def step(*args, **kwargs):
        t = time.perf_counter()
        out = inner(*args, **kwargs)
        times["engine"].append(time.perf_counter() - t)
        return out

    engine.step = step
    if not card:
        return
    ex_inner = engine.executor.step

    def ex_step(*args, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = ex_inner(*args, **kwargs)
        torch.cuda.synchronize()
        times["executor"].append(time.perf_counter() - t)
        return out

    engine.executor.step = ex_step


@contextlib.contextmanager
def gc_pauses():
    """Counts the cyclic garbage collector's pauses while the block runs,
    wherever they fall (plane or engine): {"gc_s": seconds, "gc_runs": n}."""
    out, start = {"gc_s": 0.0, "gc_runs": 0}, [0.0]

    def note(phase, info):
        if phase == "start":
            start[0] = time.perf_counter()
        else:
            out["gc_s"] += time.perf_counter() - start[0]
            out["gc_runs"] += 1

    gc.callbacks.append(note)
    try:
        yield out
    finally:
        gc.callbacks.remove(note)


def plane_up(cfg, params):
    """The port's control plane (Slurm simulation, Web Gateway, router)
    with two replicas of LLMEngine over RealExecutor on the card, sharing
    ``params`` and stepping in turn; both endpoints Ready. Returns the
    plane, a client, the two engines and their step timers."""
    from repro_torch.api import AdminClient, ServingClient
    from repro_torch.config import GPU_H100
    from repro_torch.core.controller import ClusterSpec, ControlPlane
    from repro_torch.launch import serve
    build = serve.engine_factory(params, "cuda", num_blocks=1024,
                                 block_size=16, max_num_seqs=8,
                                 max_prefill_tokens=512, max_model_len=4096)
    engines, times = [], {"engine": [], "executor": []}

    def factory(c, tp):
        engine = build(c, tp)
        timed_steps(engine, times, card=True)
        engines.append(engine)
        return engine

    cp = ControlPlane(ClusterSpec(num_nodes=2, gpus_per_node=1,
                                  hardware=GPU_H100), engine_factory=factory)
    cp.add_tenant("smoke", "sk-smoke")
    cp.register_model(cfg)
    admin = AdminClient(cp)
    admin.apply(model=cfg.name, replicas=2, min_replicas=2, max_replicas=2,
                est_load_time=45.0)
    ready = admin.wait(cfg.name, "Ready", timeout=300.0)
    check(ready and len(cp.ready_endpoints(cfg.name)) == 2,
          f"{cfg.name}: the two endpoints are not Ready")
    client = ServingClient(cp, api_key="sk-smoke", default_model=cfg.name)
    return cp, client, engines, times


def plane_run(cp, client, wires, times):
    """Submits the streaming completions ``wires`` at once and runs the
    plane until every stream closes. Returns the streams and the run's
    timing: its wall time, the time inside LLMEngine.step and inside
    RealExecutor.step, and per request its wall-clock TTFT and latency.
    The wall time less the engines' steps is the plane's own host time:
    gateway, router, instances and the event loop."""
    for v in times.values():
        v.clear()
    first, last = {}, {}
    streams = []
    with gc_pauses() as pauses:
        t0 = time.perf_counter()
        for i, w in enumerate(wires):
            s = client.completions(w)
            s.subscribe(lambda req, tok, t, i=i: first.setdefault(
                i, time.perf_counter() - t0))
            s.on_done(lambda stream, i=i: last.setdefault(
                i, time.perf_counter() - t0))
            streams.append(s)
        cp.loop.run_while(lambda: any(not s.closed for s in streams),
                          max_t=cp.loop.now + 3600.0)
        wall = time.perf_counter() - t0
    engine_s, executor_s = sum(times["engine"]), sum(times["executor"])
    timing = {"requests": len(wires), "wall_s": wall,
              "engine_step_s": engine_s, "executor_step_s": executor_s,
              "engine_steps": len(times["engine"]),
              "engine_host_s": engine_s - executor_s,
              "plane_host_s": wall - engine_s,
              "plane_host_s_per_request": (wall - engine_s) / len(wires),
              **pauses, "per_request": [{"ttft_s": first.get(i),
                               "latency_s": last.get(i)}
                              for i in range(len(wires))]}
    return streams, timing


def plane_wires(cfg, prompts):
    from repro_torch.api import CompletionRequest
    from repro_torch.launch import drive
    return [CompletionRequest(model=cfg.name, prompt=list(p),
                              temperature=0.0, max_tokens=drive.NEW_TOKENS,
                              stream=True) for p in prompts]


def quantiles(xs):
    xs = sorted(xs)
    return {"p50": xs[len(xs) // 2], "p99": xs[min(len(xs) - 1,
                                                   int(0.99 * len(xs)))],
            "max": xs[-1]}


def plane_passes(exs):
    return [(ex.prefill_computes, ex.decode_steps) for ex in exs]


def plane_launches_want(cfg, before, exs):
    """The launches of a plane run: layers x each kernel's passes, summed
    over both executors since ``before`` (their passes then)."""
    return {"paged_attention": sum(cfg.num_layers * (ex.decode_steps - d)
                                   for ex, (_, d) in zip(exs, before)),
            "flash_prefill": sum(cfg.num_layers * (ex.prefill_computes - p)
                                 for ex, (p, _) in zip(exs, before))}


def phase_plane(cfg, params):
    """Mistral-Small-24B at full width served through the control plane to
    two replicas on the one card (``params``: the path phase's tree, not
    drawn again): the 4 prompts, then the Table-1 burst of
    ``PLANE_BURST`` requests. Returns the kernels' launches in each run."""
    from repro_torch.api import CompletionRequest
    from repro_torch.data.burstgpt import concurrent_burst
    from repro_torch.launch import drive
    name = cfg.name
    gc.collect()
    torch.cuda.empty_cache()
    print(f"plane {name}: memory allocated before the plane "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    prompts = drive.make_prompts(cfg.vocab_size, drive.prompt_lens(cfg),
                                 seed=0)
    torch.cuda.reset_peak_memory_stats()
    cp, client, engines, times = plane_up(cfg, params)
    exs = [e.executor for e in engines]
    reset_counts()
    streams, timing = plane_run(cp, client, plane_wires(cfg, prompts), times)
    counts = read_counts()
    per_request = timing.pop("per_request")
    for s, t in zip(streams, per_request):
        r = s.req
        print(f"plane {name} request " + json.dumps(
            {"prompt_len": r.prompt_len, "status": r.status.value,
             "virtual_ttft_s": r.metrics.ttft, "virtual_e2el_s":
             r.metrics.e2el, "wall_ttft_s": t["ttft_s"],
             "wall_latency_s": t["latency_s"],
             "tokens": [e.token for e in s.events]}))
    print(f"plane {name} " + json.dumps(
        {"replicas": len(engines), **timing,
         "prefill_computes": [ex.prefill_computes for ex in exs],
         "decode_steps": [ex.decode_steps for ex in exs],
         "launches": counts,
         "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}))
    check(all(s.ok and len(s.events) == drive.NEW_TOKENS for s in streams),
          f"{name}: not every stream finished with its tokens")
    check(all([e.token for e in s.events] == s.req.output_tokens
              and all(type(e.token) is int for e in s.events)
              for s in streams), f"{name}: streamed tokens != served tokens")
    check(len(exs) == 2 and all(ex.prefill_computes > 0 for ex in exs),
          f"{name}: the router did not use both replicas")
    want = plane_launches_want(cfg, [(0, 0)] * 2, exs)
    check(counts == want, f"{name} plane: launches {counts}, want {want}")

    # the paper's Table-1 traffic on GPU-L: a burst submitted at once,
    # prompts mostly sharing a prefix (the plane's queueing, routing among
    # queued streams and periodic ticks at a real concurrency)
    wl = concurrent_burst(PLANE_BURST, seed=0,
                          vocab=min(cfg.vocab_size, 32000))
    before = plane_passes(exs)
    reset_counts()
    streams, timing = plane_run(cp, client, [
        CompletionRequest.from_engine(r, name, stream=True)
        for r in wl.requests], times)
    burst_counts = read_counts()
    per_request = timing.pop("per_request")
    reqs = [s.req for s in streams]
    ok = [s for s in streams if s.ok]
    print(f"plane {name} burst " + json.dumps(
        {"virtual_s": max(r.metrics.finish_time or 0.0 for r in reqs)
         - min(r.metrics.arrival_time for r in reqs), **timing,
         "finished": len(ok),
         "output_tokens": sum(len(s.events) for s in streams),
         "virtual_ttft_s": quantiles([r.metrics.ttft for r in reqs]),
         "virtual_e2el_s": quantiles([r.metrics.e2el for r in reqs]),
         "wall_ttft_s": quantiles([t["ttft_s"] for t in per_request]),
         "wall_latency_s": quantiles([t["latency_s"] for t in per_request]),
         "passes": [[p - p0, d - d0] for (p, d), (p0, d0)
                    in zip(plane_passes(exs), before)],
         "preemptions": [e.metrics.preemptions for e in engines],
         "launches": burst_counts,
         "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}))
    check(len(ok) == len(streams) and all(
        len(s.events) == r.sampling.max_new_tokens
        for s, r in zip(streams, wl.requests)),
          f"{name} burst: {len(ok)} of {len(streams)} streams finished")
    want = plane_launches_want(cfg, before, exs)
    check(burst_counts == want,
          f"{name} burst: launches {burst_counts}, want {want}")
    cp.shutdown()
    return counts, burst_counts


def phase_plane_oracle(cfg, params, prompts, oracle):
    """The same plane at 2 layers f32: its streamed tokens equal the plain
    oracle's."""
    cp, client, _, times = plane_up(cfg, params)
    streams, _ = plane_run(cp, client, plane_wires(cfg, prompts), times)
    cp.shutdown()
    same = [[e.token for e in s.events] == o for s, o in zip(streams, oracle)]
    print(f"oracle {cfg.name} plane " + json.dumps(
        {"layers": cfg.num_layers, "dtype": cfg.param_dtype,
         "equal": same}))
    check(all(same), f"{cfg.name}: the plane's tokens and the plain oracle's "
                     f"disagree")


def plane_host_sim(n, mode):
    """The plane's own host time under the paper's Table-1 traffic on
    GPU-L (benchmarks/table1.py's plane: 2 nodes x 2 H100s, one replica of
    Mistral-Small-24B, 11 000 blocks, 256 sequences, prefill 2048, the
    roofline simulator as engine): a burst of ``n`` through the Web
    Gateway (mode "gateway", after one warm-up request) or straight into
    the instance ("direct"). The card does nothing here; the wall time
    less LLMEngine.step is the plane's Python on this host."""
    from repro_torch import configs
    from repro_torch.api import CompletionRequest, ServingClient
    from repro_torch.config import GPU_H100
    from repro_torch.core.controller import ClusterSpec, ControlPlane
    from repro_torch.data.burstgpt import concurrent_burst
    from repro_torch.engine.engine import LLMEngine
    from repro_torch.engine.executor import SimExecutor
    spec = ClusterSpec(num_nodes=2, gpus_per_node=2, hardware=GPU_H100,
                       num_blocks=11_000, block_size=16, max_num_seqs=256,
                       max_model_len=32_768, max_prefill_tokens=2048)
    times = {"engine": []}

    def factory(c, tp):
        engine = LLMEngine(c, SimExecutor(c, GPU_H100, tp=1, efficiency=0.5),
                           num_blocks=spec.num_blocks,
                           block_size=spec.block_size,
                           max_num_seqs=spec.max_num_seqs,
                           max_prefill_tokens=spec.max_prefill_tokens,
                           max_model_len=spec.max_model_len)
        timed_steps(engine, times)
        return engine

    cp = ControlPlane(spec, engine_factory=factory)
    cp.add_tenant("bench", "sk-bench")
    cp.add_model(configs.get(PLANE), instances=1, gpus_per_node=1,
                 est_load_time=60.0)
    cp.run_until(120.0)
    check(bool(cp.ready_endpoints(PLANE)), "Table-1 plane did not come up")
    wl = concurrent_burst(n, seed=0)
    if mode == "gateway":
        client = ServingClient(cp, api_key="sk-bench")
        client.completions(model=PLANE, prompt=[1] * 8, max_tokens=1,
                           target_output_len=1).result(max_wait=30.0)
    times["engine"].clear()
    v0 = cp.loop.now
    with gc_pauses() as pauses:
        t0 = time.perf_counter()
        if mode == "gateway":
            reqs = [client.completions(CompletionRequest.from_engine(
                r, PLANE, stream=True)).req for r in wl.requests]
        else:
            inst = next(iter(cp.registry.values()))
            reqs = wl.requests
            for r in reqs:
                inst.submit(r)
        cp.loop.run_while(lambda: any(r.status.value not in ("finished",
                                                             "failed")
                                      for r in reqs), max_t=v0 + 3600.0)
        wall = time.perf_counter() - t0
    engine_s = sum(times["engine"])
    row = {"traffic": f"Table-1 GPU-L burst, {mode}", "requests": n,
           "finished": sum(r.status.value == "finished" for r in reqs),
           "virtual_s": cp.loop.now - v0, "wall_s": wall,
           "engine_step_s": engine_s, "engine_steps": len(times["engine"]),
           "plane_host_s": wall - engine_s,
           "plane_host_s_per_request": (wall - engine_s) / n, **pauses}
    cp.shutdown()
    return row


def plane_host_launcher():
    """``python -m repro_torch.launch.serve`` as a user runs it, with its
    defaults (roofline simulator, one replica the autoscaler may grow to
    8, bursty_poisson at 4 requests/s for 300 virtual seconds): its wall
    time less LLMEngine.step, over its requests."""
    import io
    from repro_torch.engine.engine import LLMEngine
    from repro_torch.launch import serve
    times = {"engine": []}
    inner = LLMEngine.step

    def step(self, *args, **kwargs):
        t = time.perf_counter()
        out = inner(self, *args, **kwargs)
        times["engine"].append(time.perf_counter() - t)
        return out

    out = io.StringIO()
    LLMEngine.step = step
    try:
        with gc_pauses() as pauses, contextlib.redirect_stdout(out):
            t0 = time.perf_counter()
            serve.main([])
            wall = time.perf_counter() - t0
    finally:
        LLMEngine.step = inner
    text = out.getvalue()
    fin, n = text.split("finished ")[1].split(";")[0].split("/")
    engine_s = sum(times["engine"])
    return {"traffic": "launch.serve defaults: bursty_poisson 4/s, 300 s",
            "requests": int(n), "finished": int(fin), "wall_s": wall,
            "engine_step_s": engine_s, "engine_steps": len(times["engine"]),
            "plane_host_s": wall - engine_s,
            "plane_host_s_per_request": (wall - engine_s) / int(n),
            **pauses}


def phase_plane_host():
    """The plane's own host time per request at the concurrencies and
    virtual spans the paper serves, on the roofline simulator (no card
    work): Table-1 GPU-L bursts of 100, 500 and 1000, through the gateway
    and straight into the instance, and the serving launcher's default
    run."""
    rows = [plane_host_sim(n, mode) for n in PLANE_HOST_BURSTS
            for mode in ("gateway", "direct")]
    rows.append(plane_host_launcher())
    for row in rows:
        print("plane-host " + json.dumps(row))
        check(row["finished"] >= 0.99 * row["requests"],
              f"plane-host run failed requests: {row}")


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
    from repro_torch.launch import drive
    from repro_torch.models import api
    params = api.init_params(cfg, torch.Generator("cuda").manual_seed(0),
                             "cuda")
    frames = torch.randn(1, cfg.encoder_seq_len, cfg.frontend_dim,
                         generator=torch.Generator("cuda").manual_seed(2),
                         device="cuda")
    prompt = drive.make_prompts(cfg.vocab_size, (AUDIO_PROMPT,), seed=0)[0]
    print(f"path {cfg.name}: family={cfg.family} layers={cfg.num_layers}+"
          f"{cfg.encoder_layers} d_model={cfg.d_model} {cfg.param_dtype} "
          f"weights {sum(size(t) for t in _leaves(params)) / 1e9:.2f} GB")
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    toks, cache = audio_generate(cfg, params, prompt, frames,
                                 drive.NEW_TOKENS)
    wall = time.perf_counter() - t0
    counts = read_counts()
    print(f"path {cfg.name} " + json.dumps(
        {"wall_s": wall, "prompt_len": len(prompt), "decode_steps":
         drive.NEW_TOKENS, "tokens": toks, "tokens_per_s": len(toks) / wall,
         "launches": counts,
         "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}))
    want = {"paged_attention": 0, "flash_prefill": attention_layers(cfg)}
    check(counts == want, f"{cfg.name}: launches {counts}, want {want}")
    ctx = len(prompt) + drive.NEW_TOKENS + 1
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
    from repro_torch.launch import drive
    from repro_torch.models import api
    from repro_torch.models import common as cm
    params = api.init_params(cfg, torch.Generator("cuda").manual_seed(1),
                             "cuda")
    frames = torch.randn(1, cfg.encoder_seq_len, cfg.frontend_dim,
                         generator=torch.Generator("cuda").manual_seed(3),
                         device="cuda")
    prompt = drive.make_prompts(cfg.vocab_size, (AUDIO_PROMPT,), seed=1)[0]
    reset_counts()
    kernel, _ = audio_generate(cfg, params, prompt, frames, drive.NEW_TOKENS)
    counts = read_counts()
    plain, _ = audio_generate(cfg, params, prompt, frames, drive.NEW_TOKENS,
                              attention=cm.plain_prefill_attention)
    print(f"oracle {cfg.name} " + json.dumps(
        {"layers": cfg.num_layers, "dtype": cfg.param_dtype,
         "equal": kernel == plain, "launches": counts}))
    check(kernel == plain, f"{cfg.name}: kernel path and plain attention "
                           f"disagree on tokens")
    check(counts["flash_prefill"] == cfg.num_layers,
          f"{cfg.name}: launches {counts}")


# --------------------------------------------------------------------------
# phase 6: training
# --------------------------------------------------------------------------

def train_bound(cfg, n_params):
    """The least time of one train step: 6 x params x tokens (forward and
    backward of every product, the tied head included) plus causal
    attention's products (QK^T and PV over the lower triangle, forward and
    twice that backward), at the bf16 peak."""
    tokens = TRAIN_SEQ * TRAIN_BATCH
    attn = 6 * TRAIN_BATCH * cfg.num_heads * TRAIN_SEQ ** 2 * cfg.head_dim \
        * cfg.num_layers
    ops = 6 * n_params * tokens + attn
    return ops, ops / PEAK_OPS[torch.bfloat16] * 1e3


def phase_train(cfg):
    """SmolLM-135M trained at full width and depth through the Trainer;
    resumed from its step-10 checkpoint by a second Trainer. Returns the
    kernels' launches over the phase."""
    from repro_torch.models import api
    from repro_torch.train.loop import Trainer, TrainerConfig
    params = api.init_params(cfg, torch.Generator("cuda").manual_seed(0),
                             "cuda")
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"train {cfg.name}: family={cfg.family} layers={cfg.num_layers} "
          f"d_model={cfg.d_model} vocab={cfg.vocab_size} {cfg.param_dtype} "
          f"params {n_params / 1e6:.1f} M, seq_len {TRAIN_SEQ} x batch "
          f"{TRAIN_BATCH}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as d:
        tcfg = TrainerConfig(seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                             steps=TRAIN_STEPS, ckpt_every=TRAIN_CKPT,
                             ckpt_dir=d, log_every=5)
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        a = Trainer(cfg, tcfg, params=params, device="cuda")
        del params
        a.run(steps=TRAIN_CKPT)                # checkpoint at step 10
        peak = torch.cuda.max_memory_allocated()
        b = Trainer(cfg, dataclasses.replace(tcfg, ckpt_every=10 ** 9),
                    device="cuda")
        check(b.step_idx == TRAIN_CKPT,
              f"train: resumed at step {b.step_idx}, want {TRAIN_CKPT}")
        a.run()                                # uninterrupted to step 20
        b.run()                                # resumed to step 20
        wall = time.perf_counter() - t0
        counts = read_counts()
        ckpts = sorted(p.name for p in Path(d).glob("step_*"))
    losses = [h["loss"] for h in a.history]
    resumed = [h["loss"] for h in b.history]
    del b
    rel = max(abs(x - y) / abs(y) for x, y in
              zip(resumed, losses[TRAIN_CKPT:]))
    step_s = statistics.median(h["wall_s"] for h in a.history[1:])
    print(f"train {cfg.name} " + json.dumps(
        {"steps": len(a.history), "losses": losses,
         "grad_norms": [h["grad_norm"] for h in a.history],
         "lrs": [h["lr"] for h in a.history],
         "resumed_at": TRAIN_CKPT, "resumed_losses": resumed,
         "resume_max_rel_diff": rel, "checkpoints": ckpts,
         "median_step_s": step_s,
         "tokens_per_s": TRAIN_SEQ * TRAIN_BATCH / step_s,
         "first_step_s": a.history[0]["wall_s"], "phase_wall_s": wall,
         "peak_mem_gb": peak / 1e9, "launches": counts}))
    check(all(math.isfinite(x) for x in losses + resumed),
          "train: a loss is not finite")
    check(abs(losses[0] - math.log(cfg.vocab_size)) < 0.1 * math.log(
        cfg.vocab_size), f"train: first loss {losses[0]} is not near "
                         f"ln {cfg.vocab_size}")
    check(losses[-1] < losses[0], f"train: loss did not fall: {losses}")
    check(len(resumed) == TRAIN_STEPS - TRAIN_CKPT and rel <= TRAIN_RESUME_RTOL,
          f"train: resumed run differs from the uninterrupted one by rel "
          f"{rel}")
    check(counts == {"paged_attention": 0, "flash_prefill": 0},
          f"train: kernel launches {counts} on the training path")

    # one step, timed and traced, on the state the run left
    batch = {k: torch.from_numpy(v).to("cuda")
             for k, v in a.pipeline.batch(TRAIN_STEPS).items()}
    torch.cuda.reset_peak_memory_stats()
    ms, device_ms, kernels, ops, split, other = time_step(
        lambda: a._step(a.state, batch), iters=2, n=1, kinds=KERNEL_KINDS)
    n_ops, bound_ms = train_bound(cfg, n_params)
    print(f"train {cfg.name} step " + json.dumps(
        {"ms": ms, "device_ms": device_ms,
         "device_busy_share": device_ms / ms, "bound_ms": bound_ms,
         "bound_by": "operations", "model_tflop": n_ops / 1e12,
         "share_of_bound": bound_ms / ms,
         "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
         "device_ms_by_kind": split, "top_other_kernels": other,
         "top_kernels": kernels, "top_ops": ops}))
    return counts


def phase_train_families():
    """Per family, the reduced config at 2 layers (the hybrid's 3) in f32:
    one train step on the card and the same on the CPU, from the same
    weights and batch, give the same loss and grad_norm."""
    from repro_torch import configs
    from repro_torch.models import api
    from repro_torch.train import step as tstep
    from repro_torch.train.optimizer import AdamW, cosine_schedule
    opt = AdamW(cosine_schedule(1e-3, 1, 10))
    rows = {}
    reset_counts()
    for family, (name, b, t) in TRAIN_FAMILIES.items():
        cfg = configs.get(name).reduced()
        params = api.init_params(cfg, torch.Generator().manual_seed(5), "cpu")
        g = torch.Generator().manual_seed(0)
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, t),
                                         generator=g),
                 "labels": torch.randint(0, cfg.vocab_size, (b, t),
                                         generator=g)}
        if family == "audio":
            batch["frames"] = torch.randn(b, cfg.encoder_seq_len,
                                          cfg.frontend_dim, generator=g)
        if family == "vlm":
            batch["patch_embeds"] = torch.randn(b, cfg.num_patches,
                                                cfg.frontend_dim, generator=g)
        out = {}
        for device in ("cpu", "cuda"):
            state = tstep.init_train_state(cfg, opt, device=device,
                                           params=params)
            _, metrics = tstep.make_train_step(cfg, opt)(
                state, {k: v.to(device) for k, v in batch.items()})
            out[device] = {k: float(v) for k, v in metrics.items()}
        rel = {k: abs(out["cuda"][k] - out["cpu"][k])
               / max(abs(out["cpu"][k]), 1e-30)
               for k in ("loss", "grad_norm")}
        rows[family] = {"arch": name, "layers": cfg.num_layers,
                        "seq_len": t, "cuda": out["cuda"], "cpu": out["cpu"],
                        "rel": rel}
        check(max(rel.values()) <= TRAIN_FAMILY_RTOL,
              f"train {family}: card and CPU differ: {rows[family]}")
    counts = read_counts()
    print("train-families " + json.dumps(rows))
    check(counts == {"paged_attention": 0, "flash_prefill": 0},
          f"train families: kernel launches {counts}")


def tree_bytes(tree):
    return sum(size(t) for t in _leaves(tree))


def dryrun_real_args(cfg, shape):
    """The arguments of the cell's step, materialised on the card: seeded
    bf16 weights (and AdamW's state for training), a zero cache, seeded
    tokens; positions at the serving prompts' lengths."""
    from repro_torch.models import api
    from repro_torch.train.optimizer import AdamW, cosine_schedule
    from repro_torch.train.step import init_train_state
    gen = torch.Generator("cuda").manual_seed(0)
    b, t = shape.global_batch, shape.seq_len

    def ints(*s):
        return torch.randint(0, cfg.vocab_size, s, generator=gen,
                             device="cuda", dtype=torch.int32)

    if shape.kind == "train":
        state = init_train_state(cfg, AdamW(cosine_schedule(3e-4, 100,
                                                            10_000)),
                                 gen, "cuda")
        return [state, {"tokens": ints(b, t), "labels": ints(b, t)}]
    pos = torch.tensor([37, 300, 1000, 1500][:b], dtype=torch.int32,
                       device="cuda")
    return [api.init_params(cfg, gen, "cuda"), ints(b),
            api.init_cache(cfg, b, t, device="cuda"), pos]


def phase_dryrun():
    """The dry run (launch/dryrun.py), grounded on the card: for a serving
    cell (Mistral-Small-24B, one decode step at 4 x 4096) and a training
    cell (SmolLM-135M at seq 2048 x 8) on a 1 x 1 mesh, the dry run's state
    and input bytes per device equal the bytes of the same arguments
    materialised on the card, and FlopCounterMode's count of one real step
    there equals the dry run's count on meta shards. Then two production
    cells, each through the module's command line on this machine's CPU.
    Returns the kernels' launches over the real steps (neither kernel
    runs: the dry run's steps are the plain ones)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch import configs
    from repro_torch.config import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_process_group, make_host_mesh
    launches = {}
    for arch, seq, batch, kind in DRYRUN_GROUNDED:
        cfg = configs.get(arch)
        shape = ShapeConfig(f"chip_{kind}", seq, batch, kind)
        with fake_process_group(1):
            mesh = make_host_mesh(1, 1)
            counter, state_b, input_b, lower_s = dryrun.lower_cell(
                cfg, shape, mesh)
            step = dryrun.cell_args(cfg, shape, mesh)[0]
        free_the_card()
        args = dryrun_real_args(cfg, shape)
        # what the dry run counts: params and cache (decode), train state
        # and batch (train)
        card_b = sum(tree_bytes(args[i]) for i in (
            (0, 2) if kind == "decode" else (0, 1)))
        reset_counts()
        with FlopCounterMode(display=False) as flops:
            step(*args)
        torch.cuda.synchronize()
        launches[f"{arch} {kind}"] = read_counts()
        del args
        print(f"dryrun grounded {arch} {kind} " + json.dumps(
            {"seq_len": seq, "batch": batch, "mesh": "1 x 1",
             "lower_s": lower_s,
             "dryrun_state_plus_input_bytes": state_b + input_b,
             "card_bytes": card_b, "dryrun_flops": counter.flops,
             "card_flops": flops.get_total_flops(),
             "dryrun_bytes_accessed": counter.bytes_accessed,
             "collectives": counter.collectives.count,
             "launches": launches[f"{arch} {kind}"]}))
        check(card_b == state_b + input_b,
              f"dryrun {arch} {kind}: {card_b} bytes on the card, "
              f"{state_b + input_b} in the dry run")
        check(flops.get_total_flops() == counter.flops,
              f"dryrun {arch} {kind}: {flops.get_total_flops()} FLOPs on "
              f"the card, {counter.flops} in the dry run")
        check(counter.collectives.count == 0,
              f"dryrun {arch} {kind}: collectives on a 1 x 1 mesh")
        check(read_counts() == {"paged_attention": 0, "flash_prefill": 0},
              f"dryrun {arch} {kind}: a kernel ran in the plain step")
    free_the_card()
    for arch, shape, mesh in DRYRUN_CELLS:
        t0 = time.perf_counter()
        run = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mesh", mesh], capture_output=True,
            text=True, env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
            timeout=600)
        wall = time.perf_counter() - t0
        check(run.returncode == 0, f"dryrun {arch} x {shape} x {mesh}: "
                                   f"{run.stdout[-2000:]}{run.stderr[-2000:]}")
        cell = json.loads(run.stdout)
        print(f"dryrun cell {arch} x {shape} x {mesh} (CPU of the card's "
              f"host) " + json.dumps({**cell, "wall_s": wall}))
        check(cell["status"] == "ok" and cell["flops_per_device"] > 0
              and cell["num_collectives"] > 0,
              f"dryrun {arch} x {shape} x {mesh}: {cell}")
    return launches


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
    t_start = time.perf_counter()
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
        launches[name], params = phase_path(cfg)
        if name == PLANE:
            (launches[f"{name} through the control plane"],
             launches[f"{name} through the control plane, Table-1 burst of "
                      f"{PLANE_BURST}"]) = phase_plane(cfg, params)
        del params
        free_the_card()
        small = dataclasses.replace(cfg, num_layers=ORACLE_LAYERS.get(name, 2),
                                    param_dtype="float32")
        params, prompts, oracle = phase_oracle(small)
        if name == PLANE:
            phase_plane_oracle(small, params, prompts, oracle)
        del params
    cfg = configs.get(AUDIO)
    free_the_card()
    launches[AUDIO] = phase_audio(cfg)
    free_the_card()
    phase_audio_oracle(dataclasses.replace(cfg, num_layers=2,
                                           encoder_layers=2,
                                           param_dtype="float32"))
    free_the_card()
    t0 = time.perf_counter()
    launches[f"{TRAIN} training"] = phase_train(configs.get(TRAIN))
    free_the_card()
    phase_train_families()
    print(f"training phase: {time.perf_counter() - t0:.1f} s")
    phase_plane_host()
    t0 = time.perf_counter()
    for path, counts in phase_dryrun().items():
        launches[f"dryrun {path}"] = counts
    print(f"dryrun phase: {time.perf_counter() - t0:.1f} s")

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
    print(f"chip_smoke: every phase passed in "
          f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
