"""Serving launcher: bring up the control plane + N instances of --arch and
drive an open-loop workload (or stay idle with --duration for interactive
poking from a REPL).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mistral-small-24b \
        --instances 2 --rate 4 --duration 300

The roofline simulator is the default engine. ``--real-compute`` serves the
reduced config through the port's ``RealExecutor`` on ``--device``: the card
unless ``--device cpu`` is given, and without a card it raises. Its
roofline, which sets only the plane's virtual clock, is ``GPU_H100``'s,
where the JAX package's launcher times its executor on ``TPU_V5E``.
``launch/drive.py`` drives one engine without the plane.
"""
import argparse
import sys


def engine_factory(params, device="cuda", num_blocks=512, block_size=16,
                   max_num_seqs=8, max_prefill_tokens=256,
                   max_model_len=512):
    """The control plane's ``engine_factory(cfg, tp)`` for real compute:
    ``drive.build_engine`` on ``params`` (a tree on ``device``), with the
    reference launcher's engine sizes by default. Every engine it builds
    shares the one tree."""
    from repro_torch.launch import drive
    return lambda c, tp: drive.build_engine(
        c, params, device, num_blocks=num_blocks, block_size=block_size,
        max_num_seqs=max_num_seqs, max_prefill_tokens=max_prefill_tokens,
        max_model_len=max_model_len)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mistral-small-24b")
    ap.add_argument("--instances", type=int, default=1)
    ap.add_argument("--rate", type=float, default=4.0)
    ap.add_argument("--duration", type=float, default=300.0)
    ap.add_argument("--hardware", default="h100-sxm",
                    choices=["h100-sxm", "l40s", "tpu-v5e"])
    ap.add_argument("--real-compute", action="store_true",
                    help="reduced config + RealExecutor instead of the "
                         "roofline simulator")
    ap.add_argument("--device", default="cuda",
                    help="where --real-compute runs (cpu only when asked)")
    args = ap.parse_args(argv)

    from repro_torch import configs
    from repro_torch.api import AdminClient, CompletionRequest, ServingClient
    from repro_torch.config import HARDWARE
    from repro_torch.core.controller import ClusterSpec, ControlPlane
    from repro_torch.data.burstgpt import bursty_poisson

    hw = HARDWARE[args.hardware]
    cfg = configs.get(args.arch)
    factory = None
    if args.real_compute:
        import torch
        from repro_torch.device import require
        from repro_torch.models import api
        cfg = cfg.reduced()
        device = require(args.device)
        params = api.init_params(cfg, torch.Generator(device).manual_seed(0),
                                 device)
        factory = engine_factory(params, device)

    cp = ControlPlane(ClusterSpec(num_nodes=8, gpus_per_node=2,
                                  hardware=hw),
                      engine_factory=factory)
    cp.add_tenant("serve", "sk-serve")
    cp.register_model(cfg)
    admin = AdminClient(cp)
    admin.apply_tenant(name="serve", weight=1.0, max_inflight=4096)
    dep = admin.apply(model=cfg.name, replicas=args.instances,
                      max_replicas=max(8, args.instances),
                      est_load_time=45.0)
    admin.wait(cfg.name, "Ready", timeout=120.0)
    cp.run_until(max(cp.loop.now, 120.0))
    print(f"ready endpoints: {[(e['node'], e['port']) for e in cp.ready_endpoints(cfg.name)]}")
    print(f"deployment status: {dep.status.to_dict()}")

    t0 = cp.loop.now
    client = ServingClient(cp, api_key="sk-serve", default_model=cfg.name)
    streams, submit = client.submitter()

    wl = bursty_poisson(args.rate, args.duration, seed=0,
                        vocab=min(cfg.vocab_size, 32000))
    for req, at in zip(wl.requests, wl.arrivals):
        wire = CompletionRequest.from_engine(req, cfg.name, stream=True)
        cp.loop.call_at(t0 + at, lambda w=wire: submit(w))
    cp.run_until(t0 + args.duration + 120.0)
    fin = sum(1 for s in streams if s.ok)
    print(f"finished {fin}/{len(wl.requests)}; gateway stats: "
          f"{cp.web_gateway.stats}")
    print(f"scale events: {cp.metrics_gateway.scale_events}")
    print(f"tenant usage: {admin.tenant_usage('serve').to_dict()}")


if __name__ == "__main__":
    main()
