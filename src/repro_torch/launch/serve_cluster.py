"""Autoscaling serving cluster (paper §3.3 end-to-end, virtual clock): the
counterpart of the JAX package's ``examples/serve_cluster.py``.

A bursty diurnal-ish load hits one Mistral-24B instance; the Grafana rule
(queue time > 5 s sustained 30 s) fires, the Job Worker spins up more Slurm
jobs, load drains; when the burst passes, the idle scale-down rule returns
capacity to the research partition (the paper's off-hours goal).

The cluster is managed declaratively: one `ModelDeploymentSpec` (applied
through the kubectl-shaped `AdminClient`) carries the replica window, the
least-loaded routing policy and the router-side queue knobs; requests that
arrive before the first instance finishes loading are parked in the
gateway queue (status 202) and drained the moment the Endpoint Worker
flips the endpoint to ready — and the queued backlog itself counts toward
the scale-up signal, which the autoscaler turns into replica-count patches
on the spec.

Every instance is the roofline simulator (L40S), so the run does no device
work and needs no card.

    PYTHONPATH=src python -m repro_torch.launch.serve_cluster
"""
import numpy as np

from repro_torch import configs
from repro_torch.api import AdminClient, CompletionRequest, ServingClient
from repro_torch.config import GPU_L40S
from repro_torch.core.controller import ClusterSpec, ControlPlane
from repro_torch.core.autoscaler import AlertRule, GATEWAY_QUEUE_SCALE_UP
from repro_torch.data.burstgpt import bursty_poisson

MODEL = "mistral-small-24b"


def main():
    rules = [
        AlertRule("queue_time>5s_for_30s", "queue_time_max", "gt", 5.0,
                  30.0, +1, cooldown=60.0),
        GATEWAY_QUEUE_SCALE_UP,
        AlertRule("idle_scale_down", "kv_util_avg", "lt", 0.02, 120.0, -1,
                  cooldown=120.0),
    ]
    spec = ClusterSpec(num_nodes=8, gpus_per_node=2, hardware=GPU_L40S,
                       max_num_seqs=8, num_blocks=512, block_size=16,
                       max_model_len=8192, max_instances=6)
    cp = ControlPlane(spec, alert_rules=rules)
    cp.add_tenant("uni", "sk-cluster")
    cp.register_model(configs.get(MODEL))
    admin = AdminClient(cp)
    # QoS policy for the tenant (docs/tenancy.md): generous token-bucket
    # rate limits (429 with retry_after past them) + usage metering
    admin.apply_tenant(name="uni", weight=1.0, requests_per_sec=50.0,
                       burst_requests=200, max_inflight=512)
    watch = admin.watch()        # kubectl get -w analogue
    admin.apply(model=MODEL, replicas=1, min_replicas=1, max_replicas=6,
                gpus_per_node=2, est_load_time=45.0,
                routing_policy="least_loaded",
                queue_capacity=128, queue_ttl=90.0)
    # no warm-up wait: the earliest requests hit the gateway while the
    # first instance is still loading and ride the router-side queue
    cp.run_until(10.0)
    t0 = cp.loop.now

    client = ServingClient(cp, api_key="sk-cluster", default_model=MODEL)
    # rejections (e.g. 461 with the queue full) are recorded by code
    rejected = []
    streams, submit = client.submitter(
        on_error=lambda e: rejected.append(e.error.code))

    # 6-minute burst at ~6 req/s, then quiet for scale-down
    wl = bursty_poisson(rate=6.0, duration=360.0, seed=0)
    for req, at in zip(wl.requests, wl.arrivals):
        wire = CompletionRequest.from_engine(req, MODEL, stream=True)
        cp.loop.call_at(t0 + at, lambda w=wire: submit(w))

    def finished():
        return sum(1 for s in streams if s.ok)

    dep = admin.get(MODEL)
    for minute in range(16):
        cp.run_until(t0 + 60.0 * (minute + 1))
        st = dep.status
        hist = cp.metrics_gateway.history.get(1, [])
        qt = hist[-1][1]["queue_time_max"] if hist else 0.0
        util = cp.slurm.utilization()
        print(f"t={minute + 1:3d}min  replicas={st.ready_replicas}"
              f"/{dep.spec.replicas} (+{st.starting_replicas} starting,"
              f" {st.draining_replicas} draining)"
              f"  queue_time={qt:7.1f}s  slurm_gpu_util={util:.2f}"
              f"  finished={finished()}/{len(wl.requests)}")

    print("\nscale events (alert rule -> spec patch, clamped to "
          f"[{dep.spec.min_replicas}, {dep.spec.max_replicas}]):")
    for t, cfg_id, delta, rule in cp.metrics_gateway.scale_events:
        print(f"  t={t - t0:7.1f}s  config {cfg_id}  {delta:+d}  ({rule})")
    print("\nwatch events:")
    for ev in watch.events:
        print(f"  t={ev.t:7.1f}s  {ev.type:10s} "
              f"spec.replicas={ev.object['spec']['replicas']}  "
              f"ready={ev.object['status']['ready_replicas']}")
    watch.stop()
    expired = sum(1 for s in streams
                  if s.error is not None and s.error.code == "model_not_ready")
    print(f"\nfinished {finished()}/{len(wl.requests)} requests "
          f"({len(rejected)} rejected at the gateway, {expired} expired "
          f"in-queue); final status: {dep.status.to_dict()}")
    done = [s for s in streams if s.ok]
    if done:
        usage = done[0].response().usage
        print(f"sample usage block: {usage.to_dict()}")
    rs = cp.web_gateway.router_stats()
    model_rs = rs.get("per_model", {}).get(MODEL, rs)
    print(f"router policy={model_rs['policy']}  picks={model_rs['picks']}")
    print(f"gateway queue: {rs['queue']}")
    # per-tenant metering: what the billing/usage dashboard reads
    print(f"tenant usage: {admin.tenant_usage('uni').to_dict()}")


if __name__ == "__main__":
    main()
