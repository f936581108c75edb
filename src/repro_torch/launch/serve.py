"""Serving entry point of the PyTorch port: one ``LLMEngine`` over
``RealExecutor`` on the card, fed seeded prompts and stepped until idle.

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch mistral-small-24b --requests 4

Every family but vlm and audio serves this way (those two need inputs that
requests do not carry; see ``RealExecutor``).

Weights are random, drawn from a seeded ``torch.Generator`` on the device.
Prints each request's tokens and its wall-clock TTFT and latency.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.config import GPU_H100
from repro_torch.engine.engine import LLMEngine
from repro_torch.engine.executor import RealExecutor
from repro_torch.engine.request import Request, SamplingParams
from repro_torch.kernels import build
from repro_torch.models import api

PROMPT_LENS = (37, 300, 1000, 1500)   # cycled over the requests
# mamba2 prefills a whole prompt with the chunked SSD scan, which takes a
# length below its chunk (256 at full width) or a multiple of it, as the
# reference's does
SSM_PROMPT_LENS = (37, 256, 1024, 1536)
NEW_TOKENS = 16                       # greedy tokens per request
STATE_FAMILIES = ("ssm", "hybrid")    # served from slot-state caches


def prompt_lens(cfg):
    return SSM_PROMPT_LENS if cfg.family == "ssm" else PROMPT_LENS


def build_engine(cfg, params, device="cuda", num_blocks: int = 1024,
                 block_size: int = 16, max_num_seqs: int = 8,
                 max_prefill_tokens: int = 512, max_model_len: int = 4096):
    """RealExecutor + LLMEngine for ``cfg`` on ``device`` (roofline timing
    against the H100). The state families keep one cache slot per sequence
    and serve without prefix caching, as the reference's engine test of the
    state executor does."""
    ex = RealExecutor(cfg, params, num_blocks=num_blocks,
                      block_size=block_size, hw=GPU_H100,
                      max_model_len=max_model_len, max_slots=max_num_seqs,
                      device=device)
    return LLMEngine(cfg, ex, num_blocks=num_blocks, block_size=block_size,
                     max_num_seqs=max_num_seqs,
                     max_prefill_tokens=max_prefill_tokens,
                     max_model_len=max_model_len,
                     enable_prefix_caching=cfg.family not in STATE_FAMILIES)


def make_prompts(vocab_size: int, lengths, seed: int):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(1, vocab_size, size=n)]
            for n in lengths]


def serve(engine: LLMEngine, prompts, max_new_tokens: int):
    """Submit greedy requests at once and step until idle. Returns the
    requests and, per request, its wall-clock TTFT and latency (seconds)."""
    reqs = [Request(prompt_tokens=list(p),
                    sampling=SamplingParams(temperature=0.0,
                                            max_new_tokens=max_new_tokens))
            for p in prompts]
    t0 = time.perf_counter()
    for r in reqs:
        engine.add_request(r, 0.0)
    ttft, latency = {}, {}
    now = 0.0
    while engine.has_work():
        rep = engine.step(now)
        now += max(rep.elapsed, 1e-4)
        wall = time.perf_counter() - t0  # logits reached the host: synced
        for r in reqs:
            if r.output_tokens and r.request_id not in ttft:
                ttft[r.request_id] = wall
            if r.status.value in ("finished", "failed") \
                    and r.request_id not in latency:
                latency[r.request_id] = wall
    timing = [{"ttft_s": ttft.get(r.request_id),
               "latency_s": latency.get(r.request_id)} for r in reqs]
    return reqs, timing


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="mistral-small-24b",
                    choices=sorted(configs.CONFIGS))
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--profile", action="store_true",
                    help="trace the run with torch.profiler and print the "
                         "device time by kernel")
    args = ap.parse_args(argv)

    cfg = configs.get(args.arch)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device (pass --device cpu for the CPU)")
    gen = torch.Generator(device).manual_seed(args.seed)
    params = api.init_params(cfg, gen, device)
    engine = build_engine(cfg, params, device)
    cycle = prompt_lens(cfg)
    lens = [cycle[i % len(cycle)] for i in range(args.requests)]
    prompts = make_prompts(cfg.vocab_size, lens, args.seed)
    if device.type == "cuda":
        build.build_all()  # compile before the clock starts, not in TTFT
    if args.profile:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            reqs, timing = serve(engine, prompts, NEW_TOKENS)
            wall = time.perf_counter() - t0
    else:
        t0 = time.perf_counter()
        reqs, timing = serve(engine, prompts, NEW_TOKENS)
        wall = time.perf_counter() - t0
    for r, t in zip(reqs, timing):
        print(json.dumps({"request": r.request_id, "prompt_len": r.prompt_len,
                          "status": r.status.value, **t,
                          "tokens": r.output_tokens}))
    n = sum(len(r.output_tokens) for r in reqs)
    print(json.dumps({"arch": cfg.name, "layers": cfg.num_layers,
                      "device": str(device), "wall_s": wall,
                      "output_tokens": n, "tokens_per_s": n / wall}))
    if args.profile:
        print(json.dumps(device_time_by_kernel(prof, wall)))


# substrings of the names of the port's own kernels (csrc/*.cu), listed
# whatever their rank
PORT_KERNELS = ("flash_prefill", "paged_split", "paged_combine")


def device_time_by_kernel(prof, wall_s: float, top: int = 12):
    """Device time per kernel name from a torch.profiler trace: the top
    ``top`` of them and every kernel of the port's own, and the sum of all
    as a share of the serving window (the profiler's own overhead
    included)."""
    rows = []
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue  # host-side ops; their kernels are listed themselves
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0.0)
        if us > 0:
            rows.append((us, evt.count, evt.key))
    rows.sort(reverse=True)
    busy_s = sum(r[0] for r in rows) / 1e6
    return {"device_busy_s": busy_s, "wall_s": wall_s,
            "device_busy_share": busy_s / wall_s,
            "kernels": [{"name": k[:80], "calls": c, "device_ms": us / 1e3}
                        for i, (us, c, k) in enumerate(rows)
                        if i < top or any(n in k for n in PORT_KERNELS)]}


if __name__ == "__main__":
    main()
