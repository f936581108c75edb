"""Multi-pod dry run: the counterpart of ``repro/launch/dryrun.py``. Every
(architecture × input shape) cell runs one step on the production meshes
and reports the §Roofline terms.

The reference lowers and compiles each cell with XLA on 512 host
placeholder devices. Here the step runs eagerly on DTensors whose shards
are meta tensors, over a ``DeviceMesh`` on a fake process group of 256 or
512 ranks (this process is rank 0): shapes and sharding propagation only,
no allocation, no data, on the host's CPU by nature. For every cell this
proves, without hardware, that the sharding rules are coherent (DTensor
finds a placement for every op), which collectives the step needs, and
its per-device footprint. Failures here are bugs in the framework, not
environment problems.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all [--mesh single|multi|both] [--jobs 4]
"""
import argparse
import json
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

RESULTS_DIR = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"


def _sharded_bytes(tree, shardings) -> int:
    """Exact per-device bytes of a meta tree under its shardings."""
    from repro_torch.distributed.sharding import axis_sizes
    from repro_torch.train.optimizer import leaves

    total = 0
    for leaf, sh in zip(leaves(tree), leaves(shardings)):
        n = leaf.numel()
        div = 1
        sizes = axis_sizes(sh.mesh)
        for ax in sh.spec:
            if ax is None:
                continue
            for a in (ax if isinstance(ax, tuple) else (ax,)):
                div *= sizes[a]
        total += n * leaf.element_size() // max(div, 1)
    return total


def _analytic_activation_bytes(cfg, shape, mesh) -> int:
    """Device-side activation working-set estimate: the reference's model
    of a step's live activations."""
    from repro_torch.distributed.sharding import axis_sizes
    sizes = axis_sizes(mesh)
    n_data = 1
    for a in ("pod", "data"):
        n_data *= sizes.get(a, 1)
    n_model = sizes.get("model", 1)
    b_dev = max(shape.global_batch // n_data, 1)
    d = max(cfg.d_model, 1)
    t = shape.seq_len
    heads_loc = max(cfg.num_heads // n_model, 1)
    bq = 1024
    if shape.kind == "train":
        carries = cfg.num_layers * b_dev * t * d * 2          # bf16 stack
        chunk = 2 * b_dev * heads_loc * bq * min(t, 32768) * 4  # ~2 live
        logits = 2 * b_dev * t * max(cfg.vocab_size // n_model, 1) * 4
        layer_live = 8 * b_dev * t * d * 2 + 2 * b_dev * t \
            * max(cfg.d_ff, cfg.moe_d_ff * cfg.num_experts_per_tok, d) * 2
        return carries + chunk + logits + layer_live
    if shape.kind == "prefill":
        chunk = 2 * b_dev * heads_loc * bq * min(t, 32768) * 4
        layer_live = 6 * b_dev * t * d * 2
        return chunk + layer_live
    return 4 * b_dev * d * 2 * 8  # decode: negligible next to cache/params


def cell_args(cfg, shape, mesh):
    """This cell's step and its abstract arguments: (step, [(meta tree,
    shardings)] in the step's argument order, state bytes per device,
    input bytes per device). The reference's abstract state and inputs,
    each sharded by its rules: train runs ``make_train_step`` (forward,
    backward and AdamW), prefill ``make_prefill_step`` with the plain
    attention (a hand-written kernel never sees a meta tensor), decode
    ``make_decode_step`` on the contiguous cache. ``mesh`` needs only its
    axis sizes here."""
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import api
    from repro_torch.models import common as cm
    from repro_torch.train.optimizer import AdamW, cosine_schedule
    from repro_torch.train.step import (init_train_state, make_decode_step,
                                        make_prefill_step, make_train_step)

    axes = api.param_axes(cfg)
    if shape.kind == "train":
        opt = AdamW(cosine_schedule(3e-4, 100, 10_000))
        state = init_train_state(cfg, opt, abstract=True)
        psh = sh.param_shardings(mesh, state["params"], axes, sh.TRAIN_RULES)
        state_sh = {"params": psh,
                    "opt": {"m": psh, "v": psh, "step": sh.replicated(mesh)}}
        batch = api.input_specs(cfg, shape)
        batch_sh = {k: sh.batch_sharding(mesh, v.shape)
                    for k, v in batch.items()}
        return (make_train_step(cfg, opt), [(state, state_sh),
                                            (batch, batch_sh)],
                _sharded_bytes(state, state_sh),
                _sharded_bytes(batch, batch_sh))
    params = api.init_params(cfg, abstract=True)
    psh = sh.param_shardings(mesh, params, axes, sh.SERVE_RULES)
    if shape.kind == "prefill":
        batch = api.input_specs(cfg, shape)
        batch_sh = {k: sh.batch_sharding(mesh, v.shape)
                    for k, v in batch.items()}
        return (make_prefill_step(cfg, attention=cm.plain_prefill_attention),
                [(params, psh), (batch, batch_sh)],
                _sharded_bytes(params, psh), _sharded_bytes(batch, batch_sh))
    spec = api.input_specs(cfg, shape)
    cache_sh = sh.cache_shardings(mesh, spec["cache"], shape.global_batch)
    tok_sh = sh.batch_sharding(mesh, spec["tokens"].shape)
    return (make_decode_step(cfg),
            [(params, psh), (spec["tokens"], tok_sh),
             (spec["cache"], cache_sh), (spec["pos"], tok_sh)],
            _sharded_bytes(params, psh),
            _sharded_bytes(spec["cache"], cache_sh))


def lower_cell(cfg, shape, mesh):
    """One step of this cell on ``mesh``'s DTensors, under a
    ``DeviceCounter``. Returns (counter, state bytes per device, input bytes
    per device, seconds)."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.hlo_analysis import DeviceCounter

    t0 = time.time()
    fn, args, state_bytes, input_bytes = cell_args(cfg, shape, mesh)
    sh.install_activation_rules(mesh)
    try:
        args = [sh.distribute(tree, shardings) for tree, shardings in args]
        with DeviceCounter() as counter, implicit_replication():
            fn(*args)
    finally:
        sh.clear_activation_rules()
    return counter, state_bytes, input_bytes, time.time() - t0


def run_cell(arch: str, shape_name: str, mesh_kind: str) -> dict:
    from repro_torch import configs
    from repro_torch.config import GPU_H100, SHAPES
    from repro_torch.launch import hlo_analysis
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import api

    cfg = configs.get(arch)
    shape = SHAPES[shape_name]
    ok, reason = api.supports_cell(cfg, shape)
    if not ok:
        return {"status": "skipped", "reason": reason}

    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    chips = mesh.size()
    n_active = cfg.num_active_params()
    if shape.kind == "train":
        model_flops = 6.0 * n_active * shape.tokens_per_step
    else:
        model_flops = 2.0 * n_active * shape.tokens_per_step

    counter, state_bytes, input_bytes, t_lower = lower_cell(cfg, shape, mesh)
    terms = hlo_analysis.roofline_terms(counter, GPU_H100, chips,
                                        model_flops)
    # analytic per-device footprint: exact sharded state/input sizes +
    # activation working-set model (see _analytic_activation_bytes)
    act_bytes = _analytic_activation_bytes(cfg, shape, mesh)
    analytic = state_bytes + input_bytes + act_bytes \
        + (state_bytes if shape.kind == "train" else 0)  # grads live in bwd
    return {
        "status": "ok",
        "arch": arch, "shape": shape_name, "mesh": mesh_kind, "chips": chips,
        "params": cfg.num_params(), "active_params": n_active,
        "tokens_per_step": shape.tokens_per_step,
        "lower_s": round(t_lower, 2), "compile_s": None,
        "bytes_per_device_xla_cpu": None,
        "state_bytes_per_device": state_bytes,
        "input_bytes_per_device": input_bytes,
        "activation_bytes_est": act_bytes,
        "bytes_per_device": analytic,
        "fits_h100_hbm": bool(analytic < GPU_H100.hbm_bytes),
        **terms,
    }


# ---------------------------------------------------------------------------

def _cell_out_path(arch, shape, mesh_kind) -> Path:
    d = RESULTS_DIR / mesh_kind
    d.mkdir(parents=True, exist_ok=True)
    return d / f"{arch}__{shape}.json"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--jobs", type=int, default=3)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--table", action="store_true",
                    help="print the results as a markdown table")
    args = ap.parse_args(argv)

    if args.all:
        orchestrate(args)
        return
    if args.table:
        print(table())
        return

    out_path = _cell_out_path(args.arch, args.shape, args.mesh)
    try:
        res = run_cell(args.arch, args.shape, args.mesh)
    except Exception as e:  # a failure here is a framework bug — record it
        res = {"status": "error", "arch": args.arch, "shape": args.shape,
               "mesh": args.mesh, "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-4000:]}
    out_path.write_text(json.dumps(res, indent=2, default=float))
    print(json.dumps({k: v for k, v in res.items()
                      if k not in ("traceback", "collectives_by_kind",
                                   "memory")},
                     indent=2, default=float))
    if res["status"] == "error":
        sys.exit(1)


def table() -> str:
    """A markdown table of every cell in RESULTS_DIR: one row per arch, one
    column per shape, each entry the 16 x 16 mesh's cell, then the 2 x 16 x
    16 mesh's: GB per device ("over" past the H100's 80 GB), collectives
    as all-reduce / all-gather / reduce-scatter counts, the dominant
    roofline term, the lower time in seconds on the machine that ran it;
    or the cell's status when it did not run."""
    from repro_torch import configs
    from repro_torch.config import SHAPES

    def cell(arch, shape, mesh):
        path = RESULTS_DIR / mesh / f"{arch}__{shape}.json"
        if not path.exists():
            return "not run"
        r = json.loads(path.read_text())
        if r["status"] != "ok":
            return r["status"]
        c = r["collective_counts_by_kind"]
        kinds = "/".join(str(c.get(k, 0)) for k in
                         ("all-reduce", "all-gather", "reduce-scatter"))
        return (f"{r['bytes_per_device'] / 1e9:.4g} GB"
                f"{'' if r['fits_h100_hbm'] else ' over'}, {kinds}, "
                f"{r['dominant']}, {r['lower_s']} s")

    rows = ["| Arch | " + " | ".join(SHAPES) + " |",
            "| --- |" + " --- |" * len(SHAPES)]
    for arch in configs.ARCH_IDS:
        rows.append(f"| {arch} | " + " | ".join(
            cell(arch, s, "single") + " · " + cell(arch, s, "multi")
            for s in SHAPES) + " |")
    return "\n".join(rows)


def orchestrate(args):
    """Run every cell in its own subprocess (each holds its own fake
    process group)."""
    from repro_torch import configs
    from repro_torch.config import SHAPES
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    cells = [(a, s, m) for a in configs.ARCH_IDS for s in SHAPES
             for m in meshes]
    procs: list[tuple] = []
    pending = list(cells)
    failures = []
    src = str(Path(__file__).resolve().parents[2])

    def launch(cell):
        a, s, m = cell
        out = _cell_out_path(a, s, m)
        if out.exists() and not args.force:
            return None
        p = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun",
             "--arch", a, "--shape", s, "--mesh", m],
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
            env={**os.environ, "PYTHONPATH": src})
        return (cell, p)

    while pending or procs:
        while pending and len(procs) < args.jobs:
            h = launch(pending.pop(0))
            if h:
                procs.append(h)
        if not procs:
            continue
        time.sleep(1.0)
        for h in list(procs):
            (a, s, m), p = h
            if p.poll() is None:
                continue
            procs.remove(h)
            status = "ok" if p.returncode == 0 else "FAIL"
            if p.returncode != 0:
                failures.append((a, s, m))
            print(f"[{status}] {a} × {s} × {m}", flush=True)
    if failures:
        print(f"\n{len(failures)} cells failed:", failures)
        sys.exit(1)
    print("\nall cells ran")


if __name__ == "__main__":
    main()
