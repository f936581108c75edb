"""The port's ``Trainer`` on a real process group against the JAX
``Trainer`` on a host mesh: reduced qwen3-1.7b, qwen3-moe, mamba2 and
recurrentgemma on 4 gloo ranks (data 2 x model 2) against 4 forced host
devices (the same mesh), each in a subprocess, from the same initial
params; checkpoints that cross mesh
shapes and packages; and the guards that keep a trainer or the launcher off
a fake process group."""
import json
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.train import loop as jloop  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.distributed import checkpoint as ckpt  # noqa: E402
from repro_torch.distributed import sharding as sh  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch.mesh import free_port  # noqa: E402
from repro_torch.train.loop import Trainer, TrainerConfig  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
ARCH = "qwen3-1.7b"
FAMILIES = ("qwen3-moe-30b-a3b", "mamba2-780m", "recurrentgemma-9b")
CURVE_RTOL = 1e-4          # as tests/test_torch_train.py's trainer curves
# both trainers: seq 32 x batch 4, 4 steps, a checkpoint every 2
TRAIN = dict(seq_len=32, global_batch=4, steps=4, ckpt_every=2,
             warmup_steps=2, log_every=100)

_JAX = textwrap.dedent("""
    import json
    import os
    import sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["JAX_PLATFORMS"] = "cpu"
    from pathlib import Path

    import jax
    import numpy as np

    from repro import configs
    from repro.launch.mesh import make_host_mesh
    from repro.train import loop

    out = Path(sys.argv[1])
    cfg = configs.get(sys.argv[2]).reduced()
    tr = loop.Trainer(cfg, loop.TrainerConfig(
        ckpt_dir=str(out / "ckpt"), **json.loads(sys.argv[3])),
        mesh=make_host_mesh(2, 2))
    flat = jax.tree_util.tree_flatten_with_path(tr.state["params"])[0]
    np.savez(out / "start.npz", **{
        ".".join(k.key for k in path): np.array(v) for path, v in flat})
    hist = tr.run()
    sharded = [not leaf.sharding.is_fully_replicated
               for leaf in jax.tree.leaves(tr.state["params"])]
    (out / "history.json").write_text(json.dumps(
        {"history": hist, "devices": jax.device_count(),
         "sharded_leaves": sum(sharded), "leaves": len(sharded)}))
""")

_PORT = textwrap.dedent("""
    import json
    import sys
    from pathlib import Path

    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp


    def nested(flat):
        tree = {}
        for name, v in flat.items():
            *head, last = name.split(".")
            t = tree
            for k in head:
                t = t.setdefault(k, {})
            t[last] = v
        return tree


    def rank_main(rank, port, out, arch, kw, full):
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=4)
        torch.set_num_threads(1)
        from repro_torch import configs
        from repro_torch import params as tparams
        from repro_torch.distributed import checkpoint as ckpt
        from repro_torch.distributed import sharding as sh
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.models import api
        from repro_torch.train.loop import Trainer, TrainerConfig
        from repro_torch.train.optimizer import tree_map
        out = Path(out)
        cfg = configs.get(arch).reduced()
        start = nested(dict(np.load(out / "start.npz")))
        mesh22 = make_mesh((2, 2), ("data", "model"))
        mesh41 = make_mesh((4, 1), ("data", "model"))
        whole = lambda t: t.detach().full_tensor()

        # the 2 x 2 trainer from the JAX trainer's initial params
        a = Trainer(cfg, TrainerConfig(ckpt_dir=str(out / "p22"), **kw),
                    params=tparams.from_numpy(start, "cpu"), device="cpu",
                    mesh=mesh22)
        res = {"history": a.run()}
        # the 4 x 1 trainer resumes the JAX trainer's step-2 checkpoint
        b = Trainer(cfg, TrainerConfig(ckpt_dir=str(out / "j2"), **kw),
                    device="cpu", mesh=mesh41)
        res["resumed_at"] = b.step_idx
        res["resumed"] = b.run()
        if full:
            layers = a.state["params"]["layers"]
            res["placements"] = {
                k: str(layers[k.split(".")[0]][k.split(".")[1]].placements)
                for k in ("attn.wq", "mlp.w_down")}
            final = res["final"] = tree_map(whole, a.state)
            # the 2 x 2 trainer's last checkpoint onto the 4 x 1 mesh
            psh = sh.param_shardings(mesh41, final["params"],
                                     api.param_axes(cfg), sh.TRAIN_RULES)
            step, tree = ckpt.restore_checkpoint(
                out / "p22", device="cpu", shardings={
                    "params": psh, "opt": {"m": psh, "v": psh,
                                           "step": sh.replicated(mesh41)}})
            res["restored_step"] = step
            res["onto41"] = tree_map(whole, tree)
            res["layout41"] = str(
                tree["params"]["layers"]["attn"]["wq"].placements)
            if rank == 0:
                ckpt.save_checkpoint(out / "plain", step, final)
        if rank == 0:
            torch.save(res, out / "port.pt")
        dist.destroy_process_group()


    if __name__ == "__main__":
        port, out, arch, kw, full = sys.argv[1:]
        mp.spawn(rank_main, args=(int(port), out, arch, json.loads(kw),
                                  full == "full"), nprocs=4)
""")


def _script(path, text, *args, timeout=300):
    path.write_text(text)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    run = subprocess.run([sys.executable, str(path), *map(str, args)],
                         capture_output=True, text=True, timeout=timeout,
                         env=env, stdin=subprocess.DEVNULL)
    assert run.returncode == 0, run.stderr[-3000:]


def _mesh_runs(out, arch, full):
    """The JAX mesh trainer's run, then the port's mesh runs on 4 gloo
    ranks: the 2 x 2 twin and the 4 x 1 resume of the JAX trainer's step-2
    checkpoint; ``full`` adds the 2 x 2 checkpoint restored onto 4 x 1."""
    _script(out / "jax_run.py", _JAX, out, arch, json.dumps(TRAIN))
    jax_run = json.loads((out / "history.json").read_text())
    (out / "j2").mkdir()
    shutil.copytree(out / "ckpt" / "step_0000000002",
                    out / "j2" / "step_0000000002")
    _script(out / "port_run.py", _PORT, free_port(), out, arch,
            json.dumps(TRAIN), "full" if full else "twin")
    return out, jax_run, torch.load(out / "port.pt")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return _mesh_runs(tmp_path_factory.mktemp("mesh_train"), ARCH, True)


@pytest.fixture(scope="module", params=FAMILIES)
def family_runs(request, tmp_path_factory):
    """The twin and the 4 x 1 resume for the families whose sharded steps
    differ most from dense: MoE (dispatch on whole tensors), the SSD scan
    and causal convs, the recurrent block and its window."""
    return _mesh_runs(tmp_path_factory.mktemp("mesh_train"), request.param,
                      False)


def _flat(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _flat(tree[k], prefix + k + ".")
        else:
            yield prefix + k, tree[k]


def _bits(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().numpy()
    x = np.asarray(x)
    return x.tobytes(), x.dtype.name, x.shape


def _assert_bit_equal(a, b):
    a, b = dict(_flat(a)), dict(_flat(b))
    assert a.keys() == b.keys()
    for name in a:
        assert _bits(a[name]) == _bits(b[name]), name


def _assert_curves_close(port, ref):
    assert len(port) == len(ref)
    for a, b in zip(port, ref):
        assert a["step"] == b["step"]
        for k in ("loss", "aux_loss", "grad_norm", "lr"):
            assert a[k] == pytest.approx(b[k], rel=CURVE_RTOL), (a["step"], k)


# --------------------------------------------------------------------------
# the twin: the port's 2 x 2 gloo trainer against the JAX 2 x 2 trainer
# --------------------------------------------------------------------------

def test_mesh_trainer_matches_the_jax_mesh_trainer(runs):
    """Loss, aux_loss, grad_norm and lr over 4 steps to rel 1e-4, from the
    JAX mesh trainer's initial params, on the same 2 x 2 mesh."""
    _, jax_run, port = runs
    assert jax_run["devices"] == 4
    _assert_curves_close(port["history"], jax_run["history"])
    assert port["history"][-1]["loss"] < port["history"][0]["loss"]


def test_family_mesh_trainer_matches_the_jax_mesh_trainer(family_runs):
    """As above for qwen3-moe, mamba2 and recurrentgemma: loss, aux_loss,
    grad_norm and lr over 4 steps to rel 1e-4 on the 2 x 2 mesh."""
    _, jax_run, port = family_runs
    assert jax_run["devices"] == 4 and jax_run["sharded_leaves"] > 0
    _assert_curves_close(port["history"], jax_run["history"])


def test_family_jax_mesh_checkpoint_resumes_on_a_4x1_port_mesh(family_runs):
    """The JAX 2 x 2 trainer's step-2 checkpoint of each of those families
    resumes on a 4 x 1 gloo mesh and repeats the JAX run's steps 2-3."""
    _, jax_run, port = family_runs
    assert port["resumed_at"] == 2
    _assert_curves_close(port["resumed"], jax_run["history"][2:])


def test_mesh_trainer_shards_its_state_as_the_reference(runs):
    """The stacked projections shard their embed dim over "data" (FSDP) and
    their heads or mlp dim over "model" under TRAIN_RULES; the JAX
    trainer's leaves are sharded too."""
    _, jax_run, port = runs
    assert jax_run["sharded_leaves"] > 0
    assert port["placements"] == {"attn.wq": "(Shard(dim=1), Shard(dim=2))",
                                  "mlp.w_down": "(Shard(dim=2), Shard(dim=1))"}


# --------------------------------------------------------------------------
# checkpoints across mesh shapes and packages
# --------------------------------------------------------------------------

def test_jax_mesh_checkpoint_resumes_on_a_4x1_port_mesh(runs):
    """The JAX 2 x 2 trainer's step-2 checkpoint resumes in the port's
    trainer on a 4 x 1 gloo mesh, whose steps 2-3 are the JAX run's."""
    _, jax_run, port = runs
    assert port["resumed_at"] == 2
    _assert_curves_close(port["resumed"], jax_run["history"][2:])


def test_checkpoint_crosses_mesh_shapes_bit_for_bit(runs):
    """Saved from 2 x 2, restored onto 4 x 1 (as DTensors, the embed dim
    sharded over the 4-wide data axis) and onto no mesh: the same bits as
    the 2 x 2 state."""
    out, _, port = runs
    assert port["restored_step"] == 4
    assert port["layout41"] == "(Shard(dim=1), Shard(dim=2))"
    _assert_bit_equal(port["onto41"], port["final"])
    step, plain = ckpt.restore_checkpoint(out / "p22", device="cpu")
    assert step == 4
    _assert_bit_equal(plain, port["final"])


def test_mesh_checkpoint_is_the_unsharded_format(runs):
    """A checkpoint written from DTensors is byte for byte the one written
    from the gathered tree: the same manifest, leaf by leaf."""
    out, _, _ = runs
    leaves = {}
    for d in ("p22", "plain"):
        m = json.loads((out / d / "step_0000000004" / "manifest.json")
                       .read_text())
        assert m["step"] == 4
        leaves[d] = m["leaves"]
    assert leaves["p22"] == leaves["plain"]
    assert not list((out / "p22").glob(".tmp_*"))


def test_port_mesh_checkpoint_restores_in_the_jax_trainer(runs, tmp_path):
    """The port's 2 x 2 checkpoint restores in the JAX unsharded Trainer:
    params, moments and step equal to the port's state bit for bit."""
    out, _, port = runs
    shutil.copytree(out / "p22", tmp_path / "ckpt")
    jtr = jloop.Trainer(jconfigs.get(ARCH).reduced(), jloop.TrainerConfig(
        ckpt_dir=str(tmp_path / "ckpt"), **TRAIN))
    assert jtr.step_idx == 4
    _assert_bit_equal(jax.tree.map(np.asarray, jtr.state), port["final"])


# --------------------------------------------------------------------------
# a one-rank gloo mesh in this process
# --------------------------------------------------------------------------

@pytest.fixture
def gloo_rank():
    import torch.distributed as dist
    tmesh.init_process_group("cpu", rank=0, world_size=1)
    try:
        yield tmesh.make_mesh((1, 1), ("data", "model"))
    finally:
        dist.destroy_process_group()


def test_one_rank_mesh_trainer_equals_the_plain_trainer(gloo_rank, tmp_path):
    """A 1 x 1 mesh runs the plain trainer's ops: the same curve to rel
    1e-5, its step-2 checkpoint resumes in the plain trainer and the plain
    one's on the mesh, each repeating the other's steps 2-3; the activation
    rules are off again after the run."""
    from repro_torch.models import common as cm
    cfg = configs.get("smollm-135m").reduced()
    kw = dict(TRAIN, seq_len=16)

    def trainer(d, mesh=None):
        return Trainer(cfg, TrainerConfig(ckpt_dir=str(tmp_path / d), **kw),
                       device="cpu", mesh=mesh)

    hm = trainer("mesh", gloo_rank).run()
    assert cm._ACTIVATION_RULES is None and cm._SHARDED_OPS is None
    hp = trainer("plain").run()
    for a, b in zip(hm, hp):
        assert a["loss"] == pytest.approx(b["loss"], rel=1e-5)
    for src, dst, mesh in (("mesh", "mesh_to_plain", None),
                           ("plain", "plain_to_mesh", gloo_rank)):
        shutil.copytree(tmp_path / src / "step_0000000002",
                        tmp_path / dst / "step_0000000002")
        tr = trainer(dst, mesh)
        assert tr.step_idx == 2
        for a, b in zip(tr.run(), hp[2:]):
            assert a["loss"] == pytest.approx(b["loss"], rel=1e-5)


def test_mesh_trainer_needs_its_mesh_device(gloo_rank, tmp_path,
                                            monkeypatch):
    """A CPU (gloo) mesh does not train on the card: the trainer raises
    before it builds anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    cfg = configs.get("smollm-135m").reduced()
    with pytest.raises(ValueError, match="cpu mesh cannot train on cuda"):
        Trainer(cfg, TrainerConfig(ckpt_dir=str(tmp_path)), device="cuda",
                mesh=gloo_rank)


# --------------------------------------------------------------------------
# no fallback: never a fake process group, never the CPU on its own
# --------------------------------------------------------------------------

def test_trainer_refuses_a_fake_process_group(tmp_path):
    cfg = configs.get("smollm-135m").reduced()
    with tmesh.fake_process_group(4):
        mesh = tmesh.make_host_mesh(2, 2)
        with pytest.raises(RuntimeError, match="fake process group"):
            Trainer(cfg, TrainerConfig(ckpt_dir=str(tmp_path)), device="cpu",
                    mesh=mesh)


def test_make_mesh_needs_a_real_group_of_its_size():
    import torch.distributed as dist
    with pytest.raises(RuntimeError, match="needs an initialised process"):
        tmesh.make_mesh((2, 2), ("data", "model"))
    with tmesh.fake_process_group(4):
        with pytest.raises(RuntimeError, match="fake"):
            tmesh.make_mesh((2, 2), ("data", "model"))
    assert not dist.is_initialized()


def test_mesh_over_an_nccl_group_is_on_the_card(monkeypatch):
    """A mesh takes its device type from the group's backend: cuda
    for NCCL (its backend name stands in for a launch here), cpu for fake
    and gloo."""
    import torch.distributed as dist
    with tmesh.fake_process_group(4):
        assert tmesh.make_host_mesh(2, 2).device_type == "cpu"
        monkeypatch.setattr(dist, "get_backend", lambda group=None: "nccl")
        assert sh.mesh_device_type() == "cuda"
        assert tmesh.make_host_mesh(2, 2).device_type == "cuda"


def test_launch_train_on_a_gloo_mesh_resumes(tmp_path):
    """``--devices 4 --data 2 --model 2`` trains on 4 gloo ranks; a rerun
    resumes from its checkpoint and repeats the plain CPU launcher's
    steps."""
    from repro_torch.launch import train as launch_train
    argv = ["--reduced", "--steps", "3", "--seq-len", "16",
            "--global-batch", "4"]
    mesh = ["--devices", "4", "--data", "2", "--model", "2"]
    hist = launch_train.main(argv + mesh + ["--ckpt-dir", str(tmp_path / "m")])
    assert [h["step"] for h in hist] == [0, 1, 2]
    argv[argv.index("3")] = "5"
    resumed = launch_train.main(argv + mesh +
                                ["--ckpt-dir", str(tmp_path / "m")])
    assert [h["step"] for h in resumed] == [3, 4]
    plain = launch_train.main(argv + ["--device", "cpu", "--ckpt-dir",
                                      str(tmp_path / "p")])
    for a, b in zip(hist + resumed, plain):
        assert a["loss"] == pytest.approx(b["loss"], rel=CURVE_RTOL)


@pytest.mark.parametrize("argv, match", [
    (["--devices", "4", "--data", "2"], "the mesh has 2 ranks and --devices "
                                        "is 4"),
    (["--devices", "2", "--data", "2", "--device", "cuda"],
     "gloo ranks on the CPU"),
    (["--device", "cpu", "--data", "2", "--model", "2"],
     "needs 4 ranks, and WORLD_SIZE is 1"),
    (["--device", "cpu", "--production-mesh"],
     "needs 256 ranks, and WORLD_SIZE is 1"),
])
def test_launch_train_refuses_a_mesh_it_cannot_build(argv, match, tmp_path,
                                                     monkeypatch):
    """The mesh must have exactly the ranks the launch has; the production
    mesh needs a real group of 256 and never gets a fake one."""
    import torch.distributed as dist
    from repro_torch.launch import train as launch_train
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises((RuntimeError, ValueError), match=match):
        launch_train.main(["--reduced", "--ckpt-dir", str(tmp_path)] + argv)
    assert not dist.is_initialized()
