"""Quickstart: spin up the whole two-layer architecture in-process and
serve a few chat completions through the OpenAI-compatible API layer with
REAL model compute.

    PYTHONPATH=src python -m repro_torch.launch.quickstart [--arch qwen3-1.7b] [--device cpu]

What happens (paper §3): a declarative `ModelDeploymentSpec` is applied
through the kubectl-shaped `AdminClient`; the Reconciler converges it into
a Slurm job; the job registers with the Endpoint Gateway (port =
argmax+1); the Endpoint Worker marks it ready after weight load (the
deployment's Ready condition flips true); the `ServingClient` validates
the typed `ChatCompletionRequest`, the Web Gateway authenticates, looks up
the endpoint and forwards; token deltas stream back per-step on a
`TokenStream` session and the final response carries the OpenAI-style
Usage block.

The counterpart of the JAX package's ``examples/quickstart.py``: the
engine is the port's ``RealExecutor`` on ``--device`` (the card unless
``--device cpu`` is given; without a card it raises), built by
``launch/serve.py``'s ``engine_factory`` and timed on the virtual clock by
``GPU_H100``'s roofline.
"""
import argparse

import numpy as np
import torch

from repro_torch import configs
from repro_torch.api import (AdminClient, APIStatusError, ChatMessage,
                             ServingClient)
from repro_torch.core.controller import ClusterSpec, ControlPlane
from repro_torch.device import require
from repro_torch.launch.serve import engine_factory
from repro_torch.models import api


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b",
                    choices=list(configs.CONFIGS))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = configs.get(args.arch).reduced()   # CPU-sized
    print(f"[1/4] init reduced {args.arch}: "
          f"{cfg.num_layers}L d={cfg.d_model}")
    device = require(args.device)
    params = api.init_params(cfg, torch.Generator(device).manual_seed(0),
                             device)

    factory = engine_factory(params, device, num_blocks=256,
                             max_prefill_tokens=128, max_model_len=256)

    print("[2/4] bringing up control plane (slurm sim + microservices)")
    cp = ControlPlane(ClusterSpec(num_nodes=2, gpus_per_node=1),
                      engine_factory=factory)
    cp.add_tenant("demo", "sk-demo")
    cp.register_model(cfg)
    admin = AdminClient(cp)
    dep = admin.apply(model=cfg.name, replicas=1, est_load_time=15.0)
    admin.wait(cfg.name, "Ready", timeout=60.0)
    cp.run_until(max(cp.loop.now, 60.0))
    eps = cp.ready_endpoints(cfg.name)
    ready_cond = dep.status.condition("Ready")
    print(f"      ready endpoints: "
          f"{[(e['node'], e['port']) for e in eps]}  "
          f"(condition Ready={ready_cond.status} since "
          f"t={ready_cond.last_transition_time:.0f}s)")

    print("[3/4] sending 3 chat completions through the ServingClient")
    client = ServingClient(cp, api_key="sk-demo", default_model=cfg.name)
    # a wrong key raises a structured OpenAI-style error, not a bare int
    try:
        ServingClient(cp, api_key="sk-wrong").chat(
            model=cfg.name, messages=[ChatMessage("user", [1, 2, 3])])
    except APIStatusError as e:
        print(f"      bad key -> {e.error.type}/{e.error.code} "
              f"(HTTP {e.status})")

    rng = np.random.default_rng(0)
    streams = []
    for i in range(3):
        prompt = list(rng.integers(1, cfg.vocab_size, size=24))
        stream = client.chat(
            messages=[ChatMessage(role="user", content=prompt)],
            temperature=0.0, max_tokens=10, session_id=f"demo-{i}",
            stream=True)
        stream.subscribe(lambda req, tok, t: print(
            f"      req{req.request_id} +token {tok} @t={t:.3f}s"))
        streams.append(stream)
    cp.run_until(cp.loop.now + 60.0)

    print("[4/4] results")
    for stream in streams:
        resp = stream.response()
        choice = resp.choices[0]
        print(f"      {resp.id}: finish={choice.finish_reason:7s} "
              f"out={choice.message.content} "
              f"usage={resp.usage.to_dict()}")
    snap = next(iter(cp.registry.values())).metrics_snapshot()
    print(f"      engine: {snap['requests_finished_total']} finished, "
          f"kv_util={snap['kv_utilization']:.3f}")
    return streams


if __name__ == "__main__":
    main()
