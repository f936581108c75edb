"""The port's dry-run tooling against the JAX package's, on the CPU.

Held here:
- the sharding rules: ``spec_for`` on the reference's cases, every
  parameter's logical axes, and every parameter's spec under both rule sets
  on both production mesh shapes equal the reference's (the reference side
  on a JAX ``AbstractMesh``, the port's on a stand-in with the same axis
  sizes, so no 512-device mesh is built);
- every cell's per-device state and input bytes, cache and input specs and
  ``supports_cell`` equal the reference's;
- the dry run itself: a cell on a fake one-device mesh runs no collective,
  one with a model axis of 2 reduces its row-parallel products (every
  family's steps on a 2 x 2 mesh, and the ``act_shard`` sites, are in
  tests/test_torch_dryrun_steps.py);
- numerics: reduced qwen3-1.7b sharded over 2 x 2 gloo ranks gives the
  unsharded port's train step and decode step;
- no meta tensor or DTensor reaches a kernel's entry point unnoticed.
Each test that builds a process group destroys it (xdist runs this file in
one worker).
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.config import SHAPES as JSHAPES  # noqa: E402
from repro.distributed import sharding as jsh  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.config import SHAPES, ShapeConfig  # noqa: E402
from repro_torch.distributed import sharding as tsh  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import fake_process_group, make_host_mesh  # noqa: E402,E501
from repro_torch.launch.mesh import free_port  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
ARCHS = tconfigs.ARCH_IDS
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


class FakeMesh:
    """A mesh's axis sizes alone, as tests/test_sharding.py's stand-in."""

    def __init__(self, shape, axes):
        self.shape = dict(zip(axes, shape))


def _paths(tree, prefix=()):
    """{key path: leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_paths(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _jax_paths(tree, is_leaf=None):
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]
    return {tuple(getattr(k, "key", k) for k in path): v for path, v in flat}


def _dtype(x):
    return str(x.dtype).replace("torch.", "")


def test_arch_ids_are_the_references():
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    assert SHAPES == {k: ShapeConfig(**vars(v)) for k, v in JSHAPES.items()}


# --------------------------------------------------------------------------
# sharding rules
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape,axes,rules,want", [
    ((151_936, 2048), ("vocab", "embed"), "TRAIN_RULES", P("model", "data")),
    ((576, 9, 64), ("embed", "q_heads", "head_dim"), "SERVE_RULES", P()),
    ((128, 16, 16), (None, "q_heads", "kv_heads"), "SERVE_RULES",
     P(None, "model")),
    ((4096, 32), ("mlp", None), "SERVE_RULES", P("model")),
])
def test_spec_for_divisibility(shape, axes, rules, want):
    """The cases of tests/test_sharding.py: divisibility, one use of a mesh
    axis per tensor, trailing Nones trimmed."""
    mesh = FakeMesh((16, 16), ("data", "model"))
    assert jsh.spec_for(mesh, shape, axes, getattr(jsh, rules)) == want
    assert tsh.spec_for(mesh, shape, axes, getattr(tsh, rules)) == \
        tuple(want)


def test_rule_tables_are_the_references():
    for name in ("SERVE_RULES", "TRAIN_RULES", "ACT_RULES"):
        assert getattr(tsh, name) == getattr(jsh, name)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_axes_equal_the_references(arch):
    """Every leaf's logical axes at full size ("layers" first on stacked
    leaves), and its abstract shape and dtype, built from the port's own
    init code."""
    _, jaxes = japi.init_params(jconfigs.get(arch), abstract=True)
    jparams, _ = japi.init_params(jconfigs.get(arch), abstract=True)
    ref = _jax_paths(jaxes, is_leaf=lambda x: isinstance(x, tuple))
    port = _paths(tapi.param_axes(tconfigs.get(arch)))
    assert port == ref
    meta = _paths(tapi.init_params(tconfigs.get(arch), abstract=True))
    jp = _jax_paths(jparams)
    assert meta.keys() == jp.keys()
    for k, t in meta.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(jp[k].shape) and \
            _dtype(t) == str(jp[k].dtype), k


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_references(arch, mesh):
    """Each parameter's spec under SERVE_RULES and TRAIN_RULES on the
    production mesh shape, and its DTensor placements."""
    shape, names = MESHES[mesh]
    jmesh, tmesh = AbstractMesh(shape, names), FakeMesh(shape, names)
    jparams, jaxes = japi.init_params(jconfigs.get(arch), abstract=True)
    tcfg = tconfigs.get(arch)
    tparams = tapi.init_params(tcfg, abstract=True)
    taxes = tapi.param_axes(tcfg)
    for rules in ("SERVE_RULES", "TRAIN_RULES"):
        ref = _jax_paths(jsh.param_shardings(jmesh, jparams, jaxes,
                                             getattr(jsh, rules)),
                         is_leaf=lambda x: hasattr(x, "spec"))
        port = _paths(tsh.param_shardings(tmesh, tparams, taxes,
                                          getattr(tsh, rules)))
        assert port.keys() == ref.keys()
        for k, s in port.items():
            assert s.spec == tuple(ref[k].spec), (rules, k)


def test_placements_of_a_spec():
    """A mesh dim sharding tensor dim d is Shard(d); a dim sharded over two
    mesh axes is Shard(d) on both; the rest Replicate."""
    from torch.distributed.tensor import Replicate, Shard

    class Mesh:
        mesh_dim_names = ("pod", "data", "model")

    assert tsh.placements(Mesh, (("pod", "data"), None, "model")) == \
        [Shard(0), Shard(0), Shard(2)]
    assert tsh.placements(Mesh, ()) == [Replicate()] * 3
    assert tsh.placements(Mesh, (None, "data")) == \
        [Replicate(), Shard(1), Replicate()]


@pytest.fixture(scope="module")
def jdryrun():
    """The reference's dry-run module. Importing it sets XLA_FLAGS for 512
    host devices: the backend is already up here, and the variable is put
    back as it was."""
    jax.devices()
    before = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as mod
    if before is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = before
    return mod


def _reference_bytes(jdryrun, cfg, shape, mesh):
    """(state, input) bytes per device as the reference's run_cell counts
    them."""
    from repro.train.optimizer import AdamW, cosine_schedule
    from repro.train.step import init_train_state
    if shape.kind == "train":
        opt = AdamW(cosine_schedule(3e-4, 100, 10_000))
        state, axes = init_train_state(cfg, opt, abstract=True)
        psh = jsh.param_shardings(mesh, state["params"], axes,
                                  jsh.TRAIN_RULES)
        state_sh = {"params": psh,
                    "opt": {"m": psh, "v": psh,
                            "step": jsh.replicated(mesh)}}
        batch = japi.input_specs(cfg, shape)
        batch_sh = {k: jsh.batch_sharding(mesh, v.shape)
                    for k, v in batch.items()}
        return (jdryrun._sharded_bytes(state, state_sh),
                jdryrun._sharded_bytes(batch, batch_sh))
    params, axes = japi.init_params(cfg, abstract=True)
    psh = jsh.param_shardings(mesh, params, axes, jsh.SERVE_RULES)
    if shape.kind == "prefill":
        batch = japi.input_specs(cfg, shape)
        batch_sh = {k: jsh.batch_sharding(mesh, v.shape)
                    for k, v in batch.items()}
        return (jdryrun._sharded_bytes(params, psh),
                jdryrun._sharded_bytes(batch, batch_sh))
    spec = japi.input_specs(cfg, shape)
    cache_sh = jsh.cache_shardings(mesh, spec["cache"], shape.global_batch)
    return (jdryrun._sharded_bytes(params, psh),
            jdryrun._sharded_bytes(spec["cache"], cache_sh))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_bytes_equal_the_references(jdryrun, arch, shape, mesh):
    """Per-device state and input bytes of every cell, from the port's
    ``cell_args`` against the reference's run_cell arithmetic."""
    dims, names = MESHES[mesh]
    jcfg, tcfg = jconfigs.get(arch), tconfigs.get(arch)
    ref = _reference_bytes(jdryrun, jcfg, JSHAPES[shape],
                           AbstractMesh(dims, names))
    _, _, state, inputs = dryrun.cell_args(tcfg, SHAPES[shape],
                                           FakeMesh(dims, names))
    assert (state, inputs) == ref


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_input_specs_equal_the_references(arch, shape):
    """input_specs (the decode entry's cache, tokens and pos too): the same
    keys, shapes and dtypes, on the meta device; supports_cell agrees."""
    jcfg, tcfg = jconfigs.get(arch), tconfigs.get(arch)
    assert tapi.supports_cell(tcfg, SHAPES[shape]) == \
        japi.supports_cell(jcfg, JSHAPES[shape])
    ref = _jax_paths(japi.input_specs(jcfg, JSHAPES[shape]))
    port = _paths(tapi.input_specs(tcfg, SHAPES[shape]))
    assert port.keys() == ref.keys()
    for k, t in port.items():
        assert t.device.type == "meta"
        assert (tuple(t.shape), _dtype(t)) == \
            (tuple(ref[k].shape), str(ref[k].dtype)), k
    if SHAPES[shape].kind == "decode":
        assert {k[0] for k in port} == {"cache", "tokens", "pos"}


@pytest.mark.parametrize("arch", ["mamba2-780m", "recurrentgemma-9b"])
def test_long_context_families_are_constant_memory(arch):
    """The counterpart of tests/test_models.py's: SSM and hybrid decode
    caches do not grow with the context, and match the reference's."""
    cfg = tconfigs.get(arch).reduced()
    c1 = _paths(tapi.cache_specs(cfg, 2, 1_000))
    c2 = _paths(tapi.cache_specs(cfg, 2, 1_000_000))
    assert {k: v.shape for k, v in c1.items()} == \
        {k: v.shape for k, v in c2.items()}
    ref = _jax_paths(japi.cache_specs(jconfigs.get(arch).reduced(), 2,
                                      1_000_000))
    assert {k: (tuple(v.shape), _dtype(v)) for k, v in c2.items()} == \
        {k: (tuple(v.shape), str(v.dtype)) for k, v in ref.items()}


def test_abstract_init_draws_nothing():
    """init_params(abstract=True) allocates and draws nothing: meta leaves,
    the default generator untouched; init_train_state's abstract state is
    the reference's (f32 moments, a 0-d int32 step)."""
    from repro_torch.train.optimizer import AdamW, cosine_schedule
    from repro_torch.train.step import init_train_state
    cfg = tconfigs.get("kimi-k2-1t-a32b")
    before = torch.random.get_rng_state()
    params = tapi.init_params(cfg, abstract=True)
    assert torch.equal(torch.random.get_rng_state(), before)
    n = sum(t.numel() for t in _paths(params).values())
    assert n == sum(int(np.prod(x.shape)) for x in jax.tree.leaves(
        japi.init_params(jconfigs.get("kimi-k2-1t-a32b"), abstract=True)[0]))
    state = init_train_state(tconfigs.get("smollm-135m"),
                             AdamW(cosine_schedule(1e-3, 2, 20)),
                             abstract=True)
    for t in _paths(state["opt"]["m"]).values():
        assert t.device.type == "meta" and t.dtype == torch.float32
    step = state["opt"]["step"]
    assert step.shape == () and step.dtype == torch.int32


# --------------------------------------------------------------------------
# the dry run on fake meshes
# --------------------------------------------------------------------------

def _cell(arch, kind, data, model, t=128, b=4):
    with fake_process_group(data * model):
        mesh = make_host_mesh(data, model)
        counter, state, inputs, _ = dryrun.lower_cell(
            tconfigs.get(arch).reduced(), ShapeConfig("t", t, b, kind), mesh)
    return counter


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_one_device_mesh_runs_no_collective(kind):
    counter = _cell("qwen3-1.7b", kind, 1, 1)
    assert counter.collectives.count == 0
    assert counter.flops > 0 and counter.bytes_accessed > 0


def test_collective_bytes_counts_a_ring_all_gather():
    """collective_bytes over a redistribution on a fake 1 x 4 mesh: one
    all-gather of group 4, moving (n - 1) / n of its output's bytes."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.launch.hlo_analysis import collective_bytes
    with fake_process_group(4):
        mesh = make_host_mesh(1, 4)
        x = distribute_tensor(torch.zeros(8, 16), mesh,
                              [Replicate(), Shard(0)])
        stats = collective_bytes(
            lambda: x.redistribute(mesh, [Replicate(), Replicate()]))
    assert stats.count == 1
    assert stats.counts_by_kind == {"all-gather": 1}
    assert stats.group_sizes == {"all-gather": [4]}
    assert stats.total_bytes == 3 / 4 * 8 * 16 * 4


def test_model_axis_reduces_row_parallel_products():
    """On model = 2 the output and down projections are row-parallel: each
    layer's two partial sums are reduced (all-reduce, or reduce-scatter
    where the next op wants a shard), over groups of 2."""
    cfg = tconfigs.get("qwen3-1.7b").reduced()
    counter = _cell("qwen3-1.7b", "prefill", 1, 2)
    stats = counter.collectives
    reduced = stats.counts_by_kind.get("all-reduce", 0) \
        + stats.counts_by_kind.get("reduce-scatter", 0)
    assert reduced >= 2 * cfg.num_layers
    assert set(sum(stats.group_sizes.values(), [])) == {2}
    assert stats.total_bytes > 0


_GLOO = textwrap.dedent("""
    import sys
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp


    def rank_main(rank, port, out):
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=4)
        torch.set_num_threads(1)
        from torch.distributed.tensor.experimental import implicit_replication
        from repro_torch import configs
        from repro_torch.distributed import sharding as sh
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.models import api
        from repro_torch.train.optimizer import AdamW, cosine_schedule, tree_map
        from repro_torch.train.step import (init_train_state,
                                            make_decode_step, make_train_step)
        cfg = configs.get("qwen3-1.7b").reduced()
        mesh = make_host_mesh(2, 2)
        axes = api.param_axes(cfg)
        opt = AdamW(cosine_schedule(1e-3, 2, 20))
        state = init_train_state(cfg, opt, torch.Generator().manual_seed(0),
                                 "cpu")
        g = torch.Generator().manual_seed(1)
        tokens = torch.randint(0, cfg.vocab_size, (4, 64), generator=g,
                               dtype=torch.int32)
        batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
        psh = sh.param_shardings(mesh, state["params"], axes, sh.TRAIN_RULES)
        ssh = {"params": psh, "opt": {"m": psh, "v": psh,
                                      "step": sh.replicated(mesh)}}
        bsh = {k: sh.batch_sharding(mesh, v.shape) for k, v in batch.items()}
        params = api.init_params(cfg, torch.Generator().manual_seed(2), "cpu")
        cache = api.init_cache(cfg, 4, 128, torch.float32, "cpu")
        for v in cache.values():
            v.normal_(generator=g)
        tok = torch.randint(0, cfg.vocab_size, (4,), generator=g,
                            dtype=torch.int32)
        pos = torch.tensor([5, 70, 127, 33], dtype=torch.int32)
        tsh = sh.batch_sharding(mesh, tok.shape)
        sh.install_activation_rules(mesh)
        try:
            dstate = sh.distribute(state, ssh)
            with implicit_replication():
                _, metrics = make_train_step(cfg, opt)(
                    dstate, sh.distribute(batch, bsh))
                dcache = sh.distribute(
                    cache, sh.cache_shardings(mesh, cache, 4))
                logits, dcache = make_decode_step(cfg)(
                    sh.distribute(params,
                                  sh.param_shardings(mesh, params, axes,
                                                     sh.SERVE_RULES)),
                    sh.distribute(tok, tsh), dcache, sh.distribute(pos, tsh))
            full = lambda t: t.detach().full_tensor()
            res = {"loss": full(metrics["loss"]),
                   "params": tree_map(full, dstate["params"]),
                   "logits": full(logits), "cache": tree_map(full, dcache),
                   "cache_placements": str(dcache["k"].placements)}
        finally:
            sh.clear_activation_rules()
        if rank == 0:
            torch.save(res, out)
        dist.destroy_process_group()


    if __name__ == "__main__":
        mp.spawn(rank_main, args=(int(sys.argv[1]), sys.argv[2]), nprocs=4)
""")


def test_gloo_sharded_steps_equal_the_unsharded_port(tmp_path):
    """The counterpart of tests/test_sharding.py's multi-device steps:
    reduced qwen3-1.7b over 4 gloo ranks (data 2 x model 2) under
    TRAIN_RULES gives the unsharded port's loss and updated params, and
    under SERVE_RULES one decode step's logits and cache (the sequence-
    sharded write included), within f32 1e-5 / 2e-5."""
    from repro_torch.train.optimizer import AdamW, cosine_schedule, tree_map
    from repro_torch.train.step import (init_train_state, make_decode_step,
                                        make_train_step)
    script = tmp_path / "gloo_steps.py"
    script.write_text(_GLOO)
    out = tmp_path / "res.pt"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    run = subprocess.run([sys.executable, str(script), str(free_port()),
                          str(out)], capture_output=True, text=True,
                         timeout=300, env=env)
    assert run.returncode == 0, run.stderr[-3000:]
    res = torch.load(out)

    cfg = tconfigs.get("qwen3-1.7b").reduced()
    opt = AdamW(cosine_schedule(1e-3, 2, 20))
    state = init_train_state(cfg, opt, torch.Generator().manual_seed(0),
                             "cpu")
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (4, 64), generator=g,
                           dtype=torch.int32)
    _, metrics = make_train_step(cfg, opt)(
        state, {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)})
    params = tapi.init_params(cfg, torch.Generator().manual_seed(2), "cpu")
    cache = tapi.init_cache(cfg, 4, 128, torch.float32, "cpu")
    for v in cache.values():
        v.normal_(generator=g)
    tok = torch.randint(0, cfg.vocab_size, (4,), generator=g,
                        dtype=torch.int32)
    pos = torch.tensor([5, 70, 127, 33], dtype=torch.int32)
    logits, cache = make_decode_step(cfg)(params, tok, cache, pos)

    close = dict(rtol=2e-5, atol=1e-5)
    torch.testing.assert_close(res["loss"], metrics["loss"].detach(), **close)
    tree_map(lambda a, b: torch.testing.assert_close(a, b.detach(), **close),
             res["params"], state["params"])
    torch.testing.assert_close(res["logits"], logits, **close)
    tree_map(lambda a, b: torch.testing.assert_close(a, b, **close),
             res["cache"], cache)
    # the cache was sharded over both axes: batch on data, sequence on model
    assert res["cache_placements"] == "(Shard(dim=1), Shard(dim=2))"


# --------------------------------------------------------------------------
# process groups and kernels
# --------------------------------------------------------------------------

def test_fake_store_is_imported_in_one_place():
    """FakeStore lives in torch.testing._internal; only launch/mesh.py
    imports it."""
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
        + [ROOT / "chip_smoke.py"]
    users = [p.relative_to(ROOT).as_posix() for p in files
             if "fake_pg" in p.read_text() or "FakeStore" in p.read_text()]
    assert users == ["src/repro_torch/launch/mesh.py"]


def test_production_meshes_on_a_fake_process_group():
    """The reference's shapes and axis names; a second size while one group
    is up raises; the block's group is gone after it."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import (init_fake_process_group,
                                         make_production_mesh)
    for multi, shape, names in ((False, (16, 16), ("data", "model")),
                                (True, (2, 16, 16),
                                 ("pod", "data", "model"))):
        try:
            mesh = make_production_mesh(multi_pod=multi)
            assert tuple(mesh.shape) == shape
            assert mesh.mesh_dim_names == names
            assert dist.get_world_size() == mesh.size()
            with pytest.raises(RuntimeError, match="initialised"):
                init_fake_process_group(3)
        finally:
            dist.destroy_process_group()
    with fake_process_group(4):
        assert tuple(make_host_mesh(2, 2).shape) == (2, 2)
    assert not dist.is_initialized()


@pytest.mark.parametrize("what", ["meta", "dtensor"])
@pytest.mark.parametrize("op", ["paged", "flash"])
def test_kernel_entry_points_refuse_meta_and_dtensors(op, what):
    """A meta tensor or a DTensor raises at a kernel's entry point; it does
    not pass to the plain version."""
    from repro_torch.kernels.flash_prefill.ops import flash_prefill
    from repro_torch.kernels.paged_attention.ops import paged_attention

    def make(*shape):
        t = torch.zeros(shape, device="meta" if what == "meta" else "cpu")
        if what == "dtensor":
            from torch.distributed.tensor import Replicate, distribute_tensor
            t = distribute_tensor(t, make_host_mesh(1, 1), [Replicate()] * 2)
        return t

    with fake_process_group(1):
        q = make(1, 4, 2, 32)
        with pytest.raises(TypeError, match="kernel's entry point"):
            if op == "flash":
                flash_prefill(q, q, q)
            else:
                pool = make(3, 4, 2, 32)
                paged_attention(q[0], pool, pool,
                                torch.zeros(4, 1, dtype=torch.int32),
                                torch.ones(4, dtype=torch.int32))
