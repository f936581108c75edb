"""The port's control plane against the JAX package's.

Three things are held here:
- every control-plane module of the port, and every other module it copies
  (the engine's pure-Python layer, the token pipeline), is the reference's
  module, parsed to the same AST once imports are rewritten to
  ``repro_torch`` and docstrings dropped, apart from the differences listed
  (with their reason) in DEVIATIONS;
- the same scenarios, run through both planes on the roofline simulator
  with the sanitizer's trace, give the same event trace, span forest,
  per-request results, gateway stats and scale events, bit for bit;
- the port's plane over its RealExecutor on the CPU (the twins of
  tests/test_system.py:22 and examples/quickstart.py) streams exactly the
  JAX dense oracle's greedy tokens, and its launchers do not fall back to
  the CPU on their own.
"""
import ast
import dataclasses
import importlib
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
PACKAGES = ("repro", "repro_torch")

# --------------------------------------------------------------------------
# faithfulness of the copy
# --------------------------------------------------------------------------

# port module -> its reference, when the two paths differ
REFERENCE = {"launch/quickstart.py": "examples/quickstart.py"}

# port module -> the names it holds of the reference's top level, where it
# holds only part of it
ONLY = {"config.py": ("SLOTarget", "SLO_CLASSES", "DEFAULT_SLO_TARGETS",
                      "DEFAULT_SLO_OBJECTIVES", "ServiceConfig",
                      "ModelConfig", "HardwareConfig", "TPU_V5E", "GPU_L40S",
                      "GPU_H100", "HARDWARE")}

_DEVICE = ("the port's launchers run on the card unless asked for the CPU "
           "(--device), and raise without one")
_ARGV = "main takes argv, so that tests can call it"
_FACTORY = ("engines are built in one place, launch/drive.py's build_engine "
            "(through launch/serve.py's engine_factory): it times the virtual "
            "clock on GPU_H100, not TPU_V5E, and serves the state families "
            "without prefix caching")

# port module -> [(difference, reason)]. A difference is a top-level name
# whose definition is the port's own (or that one side lacks), or a pair
# (reference text, port text) substituted into the reference's source
# before both are parsed.
DEVIATIONS = {
    "config.py": [
        ("ShapeConfig", "the dry-run shapes wait for the dry-run slice"),
        ("SHAPES", "the dry-run shapes wait for the dry-run slice"),
    ],
    "core/telemetry.py": [
        (("(repro.core.telemetry.METRIC_REGISTRY)",
          "(repro_torch.core.telemetry.METRIC_REGISTRY)"),
         "the error message names the port's own registry"),
    ],
    "launch/serve.py": [
        ("engine_factory", "the real-compute engine factory is a module "
                           "function, so that a caller can build it at full "
                           "width; " + _FACTORY),
        (("def main():", "def main(argv=None):"), _ARGV),
        (("    args = ap.parse_args()\n",
          "    ap.add_argument('--device', default='cuda',\n"
          "                    help='where --real-compute runs (cpu only "
          "when asked)')\n"
          "    args = ap.parse_args(argv)\n"), _ARGV + "; " + _DEVICE),
        (("from repro.config import HARDWARE, TPU_V5E",
          "from repro.config import HARDWARE"),
         _FACTORY),
        (("""        import jax
        from repro.engine.engine import LLMEngine
        from repro.engine.executor import RealExecutor
        from repro.models import api
        cfg = cfg.reduced()
        params, _ = api.init_params(cfg, jax.random.key(0))

        def factory(c, tp):
            ex = RealExecutor(c, params, num_blocks=512, block_size=16,
                              hw=TPU_V5E, max_model_len=512, max_slots=8)
            return LLMEngine(c, ex, num_blocks=512, block_size=16,
                             max_num_seqs=8, max_prefill_tokens=256,
                             max_model_len=512)
""", """        import torch
        from repro_torch.device import require
        from repro_torch.models import api
        cfg = cfg.reduced()
        device = require(args.device)
        params = api.init_params(cfg, torch.Generator(device).manual_seed(0),
                                 device)
        factory = engine_factory(params, device)
"""), "weights from a seeded torch.Generator on --device; the factory is "
      "engine_factory (same engine sizes); " + _DEVICE),
    ],
    "launch/quickstart.py": [
        (("import sys\n\nsys.path.insert(0, \"src\")\n\nimport jax\n"
          "import numpy as np\n", "import numpy as np\nimport torch\n"),
         "a module of the package, run with -m, not a script beside src/; "
         "torch for jax"),
        (("from repro.config import TPU_V5E\n"
          "from repro.core.controller import ClusterSpec, ControlPlane\n"
          "from repro.engine.engine import LLMEngine\n"
          "from repro.engine.executor import RealExecutor\n",
          "from repro.core.controller import ClusterSpec, ControlPlane\n"
          "from repro.device import require\n"
          "from repro.launch.serve import engine_factory\n"),
         _FACTORY + "; " + _DEVICE),
        (("def main():", "def main(argv=None):"), _ARGV),
        (("    args = ap.parse_args()\n",
          "    ap.add_argument('--device', default='cuda')\n"
          "    args = ap.parse_args(argv)\n"), _ARGV + "; " + _DEVICE),
        (("    params, _ = api.init_params(cfg, jax.random.key(0))\n",
          "    device = require(args.device)\n"
          "    params = api.init_params(cfg, torch.Generator(device)"
          ".manual_seed(0),\n                             device)\n"),
         "weights from a seeded torch.Generator on --device"),
        (("""    def factory(c, tp):
        ex = RealExecutor(c, params, num_blocks=256, block_size=16,
                          hw=TPU_V5E, max_model_len=256, max_slots=8)
        return LLMEngine(c, ex, num_blocks=256, block_size=16,
                         max_num_seqs=8, max_prefill_tokens=128,
                         max_model_len=256)
""", """    factory = engine_factory(params, device, num_blocks=256,
                             max_prefill_tokens=128, max_model_len=256)
"""), _FACTORY + " (same engine sizes); " + _DEVICE),
        (("""          f"kv_util={snap['kv_utilization']:.3f}")\n""",
          """          f"kv_util={snap['kv_utilization']:.3f}")\n"""
          "    return streams\n"),
         "returns the streams, so that a caller can read the tokens"),
    ],
}

COPIED = sorted(
    ["config.py", "launch/serve.py", "launch/quickstart.py",
     "data/burstgpt.py", "data/tokens.py"]
    + [f"engine/{m}.py" for m in ("request", "kv_cache", "scheduler",
                                  "metrics", "costmodel", "engine")]
    + [f"core/{p.name}" for p in (ROOT / "src/repro/core").glob("*.py")]
    + [f"api/{p.name}" for p in (ROOT / "src/repro/api").glob("*.py")])


class _Normalise(ast.NodeTransformer):
    """Drops docstrings; imports of ``repro`` become ``repro_torch``."""

    def _strip(self, node):
        self.generic_visit(node)
        body = node.body
        if body and isinstance(body[0], ast.Expr) \
                and isinstance(body[0].value, ast.Constant) \
                and isinstance(body[0].value.value, str):
            node.body = body[1:] or ([] if isinstance(node, ast.Module)
                                     else [ast.Pass()])
        return node

    visit_Module = visit_ClassDef = visit_FunctionDef = _strip

    @staticmethod
    def _rename(name):
        if name == "repro" or name.startswith("repro."):
            return "repro_torch" + name[len("repro"):]
        return name

    def visit_ImportFrom(self, node):
        if node.level == 0:
            node.module = self._rename(node.module)
        return node

    def visit_Import(self, node):
        for alias in node.names:
            alias.name = self._rename(alias.name)
        return node


def _top_level(src):
    """[(name, dump)] of a module's top-level statements, docstrings
    dropped and imports rewritten."""
    out = []
    for node in _Normalise().visit(ast.parse(src)).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            name = node.name
        elif isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            name = node.targets[0].id
        elif isinstance(node, ast.AnnAssign) \
                and isinstance(node.target, ast.Name):
            name = node.target.id
        else:
            name = None
        out.append((name, ast.dump(node)))
    return out


@pytest.mark.parametrize("module", COPIED)
def test_port_module_is_the_reference_copy(module):
    ref_path = ROOT / (REFERENCE.get(module) or f"src/repro/{module}")
    ref = ref_path.read_text()
    port = (ROOT / "src/repro_torch" / module).read_text()
    names = set()
    for what, reason in DEVIATIONS.get(module, ()):
        assert reason
        if isinstance(what, tuple):
            old, new = what
            assert ref.count(old) == 1, f"stale deviation: {old!r}"
            ref = ref.replace(old, new)
        else:
            names.add(what)
    a, b = _top_level(ref), _top_level(port)
    for name in names:
        assert name in {n for n, _ in a + b}, f"stale deviation: {name}"
    if module in ONLY:
        a = [s for s in a if s[0] in ONLY[module]]
        b = [s for s in b if s[0] in ONLY[module]]
        assert {n for n, _ in b} == set(ONLY[module])
    a = [s for s in a if s[0] not in names]
    b = [s for s in b if s[0] not in names]
    assert [n for n, _ in a] == [n for n, _ in b]
    for (name, da), (_, db) in zip(a, b):
        assert da == db, f"{module}: {name or da[:80]} differs"


# --------------------------------------------------------------------------
# the same scenarios through both planes, bit for bit
# --------------------------------------------------------------------------

MODEL = "mistral-small-24b"


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _sim_factory(pkg, spec, hardware, tp, efficiency):
    """The benchmarks' roofline engine: SimExecutor at a fixed tp and
    efficiency, the spec's engine shape."""
    LLMEngine = mod(pkg, "engine.engine").LLMEngine
    SimExecutor = mod(pkg, "engine.executor").SimExecutor

    def factory(cfg, _tp):
        ex = SimExecutor(cfg, hardware, tp=tp, efficiency=efficiency)
        return LLMEngine(cfg, ex, num_blocks=spec.num_blocks,
                         block_size=spec.block_size,
                         max_num_seqs=spec.max_num_seqs,
                         max_prefill_tokens=spec.max_prefill_tokens,
                         max_model_len=spec.max_model_len)

    return factory


def _result(cp, reqs):
    """What both planes must agree on."""
    cp.db.check_invariants()
    return {
        "trace_digest": cp.loop.trace_digest(),
        "events_run": cp.loop.events_run,
        "callback_counts": dict(cp.loop.callback_counts),
        "span_forest_digest": cp.tracer.forest_digest(),
        "requests": [(r.request_id, r.status.value, r.metrics.ttft,
                      r.metrics.e2el, list(r.output_tokens)) for r in reqs],
        "gateway_stats": dataclasses.asdict(cp.web_gateway.stats),
        "scale_events": list(cp.metrics_gateway.scale_events),
    }


def scenario_table1(pkg):
    """Table-1 GPU-L: one H100 instance behind the gateway, a closed burst
    of 20 BurstGPT requests (benchmarks/table1.py, gateway mode)."""
    cfgmod = mod(pkg, "config")
    ctl = mod(pkg, "core.controller")
    api = mod(pkg, "api")
    spec = ctl.ClusterSpec(num_nodes=2, gpus_per_node=2,
                           hardware=cfgmod.GPU_H100, num_blocks=11_000,
                           block_size=16, max_num_seqs=256,
                           max_model_len=32_768, max_prefill_tokens=2048,
                           sanitize=True)
    cp = ctl.ControlPlane(spec, engine_factory=_sim_factory(
        pkg, spec, cfgmod.GPU_H100, 1, 0.5))
    cp.add_tenant("bench", "sk-bench")
    cp.add_model(mod(pkg, "configs").get(MODEL), instances=1,
                 gpus_per_node=1, est_load_time=60.0)
    cp.run_until(120.0)
    assert cp.ready_endpoints(MODEL)
    client = api.ServingClient(cp, api_key="sk-bench")
    client.completions(model=MODEL, prompt=[1] * 8, max_tokens=1,
                       target_output_len=1).result(max_wait=30.0)
    wl = mod(pkg, "data.burstgpt").concurrent_burst(20, seed=0)
    streams = [client.completions(
        api.CompletionRequest.from_engine(r, MODEL, stream=True))
        for r in wl.requests]
    cp.loop.run_while(lambda: any(not s.closed for s in streams),
                      max_t=cp.loop.now + 3600.0)
    return _result(cp, [s.req for s in streams])


def scenario_autoscale(pkg):
    """examples/serve_cluster.py, shortened: one L40S replica, a burst at 6
    requests/s through the gateway queue, queue-driven scale-up, then idle
    scale-down."""
    cfgmod = mod(pkg, "config")
    ctl = mod(pkg, "core.controller")
    auto = mod(pkg, "core.autoscaler")
    api = mod(pkg, "api")
    rules = [
        auto.AlertRule("queue_time>5s_for_30s", "queue_time_max", "gt", 5.0,
                       30.0, +1, cooldown=60.0),
        auto.GATEWAY_QUEUE_SCALE_UP,
        auto.AlertRule("idle_scale_down", "kv_util_avg", "lt", 0.02, 120.0,
                       -1, cooldown=120.0),
    ]
    spec = ctl.ClusterSpec(num_nodes=8, gpus_per_node=2,
                           hardware=cfgmod.GPU_L40S, max_num_seqs=8,
                           num_blocks=512, block_size=16, max_model_len=8192,
                           max_instances=6, sanitize=True)
    cp = ctl.ControlPlane(spec, alert_rules=rules)
    cp.add_tenant("uni", "sk-cluster")
    cp.register_model(mod(pkg, "configs").get(MODEL))
    admin = api.AdminClient(cp)
    admin.apply_tenant(name="uni", weight=1.0, requests_per_sec=50.0,
                       burst_requests=200, max_inflight=512)
    admin.apply(model=MODEL, replicas=1, min_replicas=1, max_replicas=6,
                gpus_per_node=2, est_load_time=45.0,
                routing_policy="least_loaded", queue_capacity=128,
                queue_ttl=90.0)
    cp.run_until(10.0)
    t0 = cp.loop.now
    client = api.ServingClient(cp, api_key="sk-cluster",
                               default_model=MODEL)
    rejected = []
    streams, submit = client.submitter(
        on_error=lambda e: rejected.append(e.error.code))
    wl = mod(pkg, "data.burstgpt").bursty_poisson(rate=6.0, duration=40.0,
                                                 seed=0)
    for req, at in zip(wl.requests, wl.arrivals):
        wire = api.CompletionRequest.from_engine(req, MODEL, stream=True)
        cp.loop.call_at(t0 + at, lambda w=wire: submit(w))
    cp.run_until(t0 + 600.0)
    out = _result(cp, [s.req for s in streams])
    out["rejected"] = rejected
    out["replicas"] = admin.get(MODEL).spec.replicas
    return out


def scenario_disagg(pkg):
    """benchmarks/disagg.py: 2 prefill + 2 decode GPU-L replicas behind the
    two-hop router, a mixed burst of 20."""
    cfgmod = mod(pkg, "config")
    ctl = mod(pkg, "core.controller")
    deps = mod(pkg, "core.deployments")
    disagg = mod(pkg, "core.disagg")
    api = mod(pkg, "api")
    spec = ctl.ClusterSpec(num_nodes=4, gpus_per_node=1,
                           hardware=cfgmod.GPU_H100, num_blocks=4096,
                           block_size=32, max_num_seqs=64,
                           max_model_len=16_384, max_prefill_tokens=2048,
                           sanitize=True)
    cp = ctl.ControlPlane(spec, engine_factory=_sim_factory(
        pkg, spec, cfgmod.GPU_H100, 1, 0.5), alert_rules=[])
    cp.add_tenant("bench", "sk-bench")
    cp.register_model(mod(pkg, "configs").get(MODEL))
    api.AdminClient(cp).apply(deps.ModelDeploymentSpec(
        model=MODEL, replicas=4, max_replicas=4,
        routing_policy="least_loaded", gpus_per_node=1, est_load_time=60.0,
        disaggregation=disagg.DisaggregationSpec(
            prefill_replicas=2, decode_replicas=2, max_prefill_replicas=2,
            max_decode_replicas=2, transfer_bandwidth=40e9)))
    cp.run_until(300.0)
    assert len(cp.ready_endpoints(MODEL)) == 4
    client = api.ServingClient(cp, api_key="sk-bench")
    client.completions(model=MODEL, prompt=[1] * 8, max_tokens=1,
                       target_output_len=1).result(max_wait=60.0)
    wl = mod(pkg, "data.burstgpt").mixed_burst(20, seed=0)
    streams = [client.completions(
        api.CompletionRequest.from_engine(r, MODEL, stream=True))
        for r in wl.requests]
    cp.loop.run_while(lambda: any(not s.closed for s in streams),
                      max_t=cp.loop.now + 7200.0)
    out = _result(cp, [s.req for s in streams])
    out["kv_transfer"] = [s.req.metrics.kv_transfer_time for s in streams]
    return out


def scenario_slo_burn(pkg):
    """slo_cost routing on an under-provisioned deployment with burn-rate
    scale-up and per-class shedding (benchmarks/slo_burn.py, burn mode,
    with the slo_cost policy of benchmarks/slo_routing.py)."""
    cfgmod = mod(pkg, "config")
    ctl = mod(pkg, "core.controller")
    auto = mod(pkg, "core.autoscaler")
    api = mod(pkg, "api")
    services = cfgmod.ServiceConfig(queue_capacity=2048, queue_ttl=60.0,
                                    slo_shed_enabled=True)
    spec = ctl.ClusterSpec(num_nodes=4, gpus_per_node=2,
                           hardware=cfgmod.GPU_L40S, max_num_seqs=8,
                           num_blocks=512, block_size=16, max_model_len=8192,
                           max_prefill_tokens=2048, max_instances=4,
                           services=services, sanitize=True)
    cp = ctl.ControlPlane(spec, engine_factory=_sim_factory(
        pkg, spec, cfgmod.GPU_L40S, 2, 0.5))
    cp.add_tenant("bench", "sk-bench")
    cp.register_model(mod(pkg, "configs").get(MODEL))
    rules = [dataclasses.asdict(r) for r in (
        auto.QUEUE_TIME_SCALE_UP, auto.GATEWAY_QUEUE_SCALE_UP,
        auto.SLO_BURN_SCALE_UP)]
    admin = api.AdminClient(cp)
    admin.apply(model=MODEL, replicas=1, min_replicas=1, max_replicas=4,
                gpus_per_node=2, est_load_time=45.0, queue_capacity=2048,
                queue_ttl=60.0, routing_policy="slo_cost", alert_rules=rules)
    admin.wait(MODEL, "Ready", timeout=90.0)
    cp.run_until(90.0)
    client = api.ServingClient(cp, api_key="sk-bench", default_model=MODEL)
    wl = mod(pkg, "data.burstgpt").concurrent_burst(120, seed=0)
    classes = ("interactive",) * 3 + ("standard",) * 5 + ("batch",) * 2
    t0 = cp.loop.now
    streams, shed = [], []
    for i, req in enumerate(wl.requests):
        req.session_id = f"s{i % 32}"
        req.slo_class = classes[i % len(classes)]
        wire = api.CompletionRequest.from_engine(req, MODEL, stream=True)

        def submit(w=wire):
            try:
                streams.append(client.completions(w))
            except api.APIStatusError as e:
                shed.append((w.slo_class, e.status))

        cp.loop.call_at(t0 + i * 0.25, submit)
    cp.run_until(t0 + 900.0)
    out = _result(cp, [s.req for s in streams])
    out["shed"] = shed
    out["alerts"] = cp.telemetry.alert_digest()
    return out


def scenario_recovery(pkg):
    """benchmarks/recovery.py, shortened: kill the node of one of two
    replicas under load; the reconciler restores the spec."""
    cfgmod = mod(pkg, "config")
    ctl = mod(pkg, "core.controller")
    api = mod(pkg, "api")
    spec = ctl.ClusterSpec(num_nodes=4, gpus_per_node=1,
                           hardware=cfgmod.GPU_H100, max_num_seqs=32,
                           num_blocks=2048, block_size=16,
                           endpoint_worker_interval=5.0,
                           job_worker_interval=15.0, sanitize=True)
    cp = ctl.ControlPlane(spec)
    cp.add_tenant("bench", "sk-bench")
    cp.register_model(mod(pkg, "configs").get(MODEL))
    admin = api.AdminClient(cp)
    admin.apply(model=MODEL, replicas=2, min_replicas=1, max_replicas=4,
                gpus_per_node=1, est_load_time=45.0)
    assert admin.wait(MODEL, "Ready", timeout=150.0)
    cp.run_until(max(cp.loop.now, 150.0))
    wl = mod(pkg, "data.burstgpt").bursty_poisson(3.0, 90.0, seed=0)
    t0 = cp.loop.now
    client = api.ServingClient(cp, api_key="sk-bench", default_model=MODEL)
    streams, submit = client.submitter()
    for req, at in zip(wl.requests, wl.arrivals):
        wire = api.CompletionRequest.from_engine(req, MODEL, stream=True)
        cp.loop.call_at(t0 + at, lambda w=wire: submit(w))
    victim = cp.ready_endpoints(MODEL)[0]["node"]
    cp.loop.call_at(t0 + 30.0, lambda: cp.slurm.fail_node(victim))
    cp.run_until(t0 + 300.0)
    dep = admin.get(MODEL)
    out = _result(cp, [s.req for s in streams])
    out["transitions"] = list(dep.transitions)
    out["ready"] = dep.status.ready_replicas
    out["errors"] = [s.error.code for s in streams if s.error is not None]
    return out


def _twin(scenario):
    """The scenario through the reference's plane, then the port's, with
    both request counters at the same start; both counters are left as
    they were found."""
    counters = [mod(p, "engine.request")._REQUEST_COUNTER for p in PACKAGES]
    found = [c[0] for c in counters]
    out = []
    try:
        for c, pkg in zip(counters, PACKAGES):
            c[0] = max(found)
            out.append(scenario(pkg))
    finally:
        for c, n in zip(counters, found):
            c[0] = n
    return out


@pytest.mark.parametrize("scenario", [scenario_table1, scenario_autoscale,
                                      scenario_disagg, scenario_slo_burn,
                                      scenario_recovery],
                         ids=lambda f: f.__name__[len("scenario_"):])
def test_both_planes_run_a_scenario_bit_for_bit(scenario):
    ref, port = _twin(scenario)
    assert port["events_run"] > 0 and port["requests"]
    for key in ref:
        assert port[key] == ref[key], key
    if scenario is scenario_disagg:
        assert port["gateway_stats"]["handoffs"] > 0
    if scenario is scenario_autoscale:
        deltas = {e[2] for e in port["scale_events"]}
        assert deltas == {+1, -1}
    if scenario is scenario_slo_burn:
        assert port["shed"] and port["gateway_stats"]["rejected_shed"] > 0
    if scenario is scenario_recovery:
        reasons = [t[3] for t in port["transitions"] if t[1] == "Ready"]
        assert "ReplicaFailure" in reasons and port["ready"] == 2


# --------------------------------------------------------------------------
# the port's plane over real compute, against the JAX dense oracle
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dense():
    """Reduced qwen3-1.7b: the JAX config and params (key 5, as in
    tests/test_system.py), and the port's config and the same params as a
    CPU tree."""
    from repro import configs as jconfigs
    from repro.models import api as japi
    from repro_torch import configs as tconfigs
    from repro_torch import params as tparams
    jcfg = jconfigs.get("qwen3-1.7b").reduced()
    params, _ = japi.init_params(jcfg, jax.random.key(5))
    tree = tparams.from_numpy(jax.tree.map(np.asarray, params), "cpu")
    return jcfg, params, tconfigs.get("qwen3-1.7b").reduced(), tree


def oracle_generate(cfg, params, prompt, n_new):
    """The JAX dense oracle of tests/test_system.py, its two functions
    jitted (the config static) to keep the test short."""
    from repro.models import api as japi
    prefill = jax.jit(japi.prefill_fn, static_argnums=1)
    decode = jax.jit(japi.decode_fn, static_argnums=1)
    toks = jnp.asarray(prompt, jnp.int32)[None]
    logits, cache = prefill(params, cfg, {"tokens": toks})
    cache = japi.pad_cache(cfg, cache, len(prompt) + n_new + 8)
    out = [int(jnp.argmax(logits[0]))]
    for i in range(n_new - 1):
        logits, cache = decode(
            params, cfg, jnp.asarray([out[-1]], jnp.int32), cache,
            jnp.asarray([len(prompt) + i], jnp.int32))
        out.append(int(jnp.argmax(logits[0])))
    return out


def test_full_stack_real_compute_end_to_end(dense):
    """Twin of tests/test_system.py:22 through the port: gateway -> Slurm
    job -> VLLMInstance -> LLMEngine -> RealExecutor on the CPU; served and
    streamed tokens equal the JAX oracle's."""
    from repro_torch.core.controller import ClusterSpec, ControlPlane
    from repro_torch.engine.request import Request, SamplingParams
    from repro_torch.launch.serve import engine_factory
    jcfg, jparams, cfg, tree = dense
    factory = engine_factory(tree, "cpu", num_blocks=256, block_size=16,
                             max_num_seqs=8, max_prefill_tokens=128,
                             max_model_len=256)
    cp = ControlPlane(ClusterSpec(num_nodes=2, gpus_per_node=1),
                      engine_factory=factory)
    cp.add_tenant("uni", "sk-e2e")
    cp.add_model(cfg, instances=1, est_load_time=20.0)
    cp.run_until(60.0)
    assert cp.ready_endpoints(cfg.name)

    rng = np.random.default_rng(11)
    prompts = [list(rng.integers(1, cfg.vocab_size, size=n))
               for n in (12, 33, 50)]
    expected = [oracle_generate(jcfg, jparams, p, 8) for p in prompts]

    streamed: dict[int, list] = {}
    reqs = []
    for p in prompts:
        r = Request(prompt_tokens=p,
                    sampling=SamplingParams(temperature=0.0,
                                            max_new_tokens=8))
        streamed[r.request_id] = []
        r.on_token = lambda req, tok, t, acc=streamed[r.request_id]: \
            acc.append(tok)
        assert cp.web_gateway.handle("sk-e2e", cfg.name, r) == 200
        reqs.append(r)
    cp.run_until(cp.loop.now + 120.0)

    for r, exp in zip(reqs, expected):
        assert r.status.value == "finished"
        assert r.output_tokens == exp, "served tokens != oracle"
        assert streamed[r.request_id] == exp, "streamed tokens != oracle"
        assert all(type(t) is int for t in streamed[r.request_id])
        assert r.metrics.ttft is not None and r.metrics.ttft > 0
    cp.db.check_invariants()


def test_quickstart_streams_the_jax_oracle_tokens(dense, monkeypatch):
    """Twin of examples/quickstart.py: launch/quickstart.py on the CPU,
    through AdminClient and ServingClient, with the JAX params carried over
    in place of its seeded ones; every stream carries the oracle's greedy
    tokens as ints, and the response holds them too."""
    from repro_torch.launch import quickstart
    from repro_torch.models import api as tapi
    jcfg, jparams, cfg, tree = dense
    monkeypatch.setattr(tapi, "init_params",
                        lambda c, gen, device: tree if c == cfg else None)
    streams = quickstart.main(["--device", "cpu"])
    rng = np.random.default_rng(0)
    prompts = [list(rng.integers(1, cfg.vocab_size, size=24))
               for _ in range(3)]
    assert len(streams) == 3
    for stream, prompt in zip(streams, prompts):
        exp = oracle_generate(jcfg, jparams, prompt, 10)
        toks = [e.token for e in stream.events]
        assert toks == exp and all(type(t) is int for t in toks)
        assert stream.response().choices[0].message.content == exp
        assert stream.req.metrics.ttft > 0


@pytest.mark.parametrize("launcher", ["serve --real-compute", "quickstart"])
def test_launchers_do_not_fall_back_to_cpu(monkeypatch, launcher):
    """Without a CUDA device the real-compute launchers raise unless asked
    for the CPU; the roofline launcher needs no card."""
    from repro_torch.launch import quickstart, serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main = serve.main if launcher.startswith("serve") else quickstart.main
    argv = ["--arch", "qwen3-1.7b"] + launcher.split()[1:]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "mamba2-780m"])
def test_engine_factory_builds_the_drivers_engine(arch):
    """launch/serve.py's engine_factory builds through launch/drive.py's
    build_engine with the reference launcher's sizes: the H100's roofline,
    a slot per sequence, and no prefix caching for the state families."""
    from repro_torch import configs
    from repro_torch.config import GPU_H100
    from repro_torch.launch import drive, serve
    from repro_torch.models import api
    cfg = configs.get(arch).reduced()
    params = api.init_params(cfg, torch.Generator("cpu").manual_seed(0),
                             "cpu")
    engine = serve.engine_factory(params, "cpu")(cfg, 1)
    ex = engine.executor
    assert ex.params is params and ex.cost.hw == GPU_H100
    assert ex.max_model_len == 512 and ex.block_size == 16
    assert engine.allocator.num_blocks == 512
    assert engine.scheduler.max_num_seqs == 8
    assert engine.scheduler.max_prefill_tokens == 256
    assert engine.allocator.enable_prefix_caching == (
        cfg.family not in drive.STATE_FAMILIES)
