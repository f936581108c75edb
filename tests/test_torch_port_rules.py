"""Rules of the PyTorch port: it imports neither JAX nor the JAX package,
its entry points never fall back to the CPU on their own, and weights carry
across from the JAX package unchanged."""
import ast
import functools
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import params as tparams  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_jax_package(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path}: {mod}"


def test_real_executor_does_not_fall_back_to_cpu(monkeypatch):
    """Without a CUDA device, the executor refuses to start unless the
    caller asks for the CPU."""
    from repro_torch.config import GPU_H100
    from repro_torch.engine.executor import RealExecutor
    from repro_torch.models import api
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tconfigs.get("smollm-135m").reduced()
    params = api.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RealExecutor(cfg, params, num_blocks=8, block_size=4, hw=GPU_H100)
    RealExecutor(cfg, params, num_blocks=8, block_size=4, hw=GPU_H100,
                 device="cpu")


def test_model_api_builds_on_the_card_by_default(monkeypatch):
    """Called without a device, the functions that build tensors aim at the
    card: with none available they raise rather than return CPU tensors."""
    from repro_torch.engine import paged_model
    from repro_torch.models import api
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tconfigs.get("qwen3-moe-30b-a3b").reduced()
    calls = {
        "init_params": lambda: api.init_params(cfg),
        "init_params with a CPU generator": lambda: api.init_params(
            cfg, torch.Generator().manual_seed(0)),
        "init_cache": lambda: api.init_cache(cfg, 1, 8),
        "init_pool": lambda: paged_model.init_pool(cfg, 4, 4),
        "from_numpy": lambda: tparams.from_numpy({"w": np.zeros(3)}),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
            pytest.fail(f"{name} returned without a card")
    assert api.init_params(cfg, device="cpu")["final_norm"].device.type == \
        "cpu"


@pytest.mark.parametrize("name", sorted(tconfigs.CONFIGS))
def test_port_config_equals_jax_config(name):
    """Each configuration of the port is the JAX package's, field for field,
    at full size and reduced."""
    import dataclasses
    t, j = tconfigs.get(name), jconfigs.get(name)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(t.reduced()) == dataclasses.asdict(j.reduced())
    assert t.num_params() == j.num_params()


def test_serve_entry_point_does_not_fall_back_to_cpu(monkeypatch):
    from repro_torch.launch import serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        serve.main(["--arch", "smollm-135m"])


@pytest.mark.parametrize("op", ["paged", "flash"])
def test_kernel_wrappers_refuse_cpu_tensors(op):
    """The kernels' wrappers launch on a CUDA tensor or raise; they never
    compute a CPU tensor's result themselves."""
    x = torch.zeros(2, 4, 32)
    if op == "paged":
        from repro_torch.kernels.paged_attention.kernel import paged_attention
        pool = torch.zeros(3, 4, 2, 32)
        with pytest.raises(ValueError, match="CUDA"):
            paged_attention(x, pool, pool, torch.zeros(2, 1, dtype=torch.int32),
                            torch.ones(2, dtype=torch.int32))
    else:
        from repro_torch.kernels.flash_prefill.kernel import flash_prefill
        with pytest.raises(ValueError, match="CUDA"):
            flash_prefill(x[None], x[None], x[None])


@pytest.mark.parametrize("name", sorted(tconfigs.CONFIGS))
def test_params_round_trip(name):
    """Every reduced config of the port: the JAX tree survives from_numpy and
    to_numpy with the same keys, shapes, dtypes and values."""
    jcfg = jconfigs.get(name).reduced()
    params, _ = japi.init_params(jcfg, jax.random.key(1))
    tree = jax.tree.map(np.asarray, params)
    tp = tparams.from_numpy(tree, "cpu")
    back = tparams.to_numpy(tp)
    flat_a = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [k for k, _ in flat_a] == [k for k, _ in flat_b]
    for (k, a), (_, b) in zip(flat_a, flat_b):
        assert a.shape == b.shape and a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b)
    # the stacked leading layer axis of each family's tree
    path = {"ssm": ("layers", "in_proj"), "hybrid": ("groups", "rec1", "w_in"),
            "audio": ("dec_layers", "attn", "wq")}.get(
                jcfg.family, ("layers", "attn", "wq"))
    n = jcfg.num_layers // 3 if jcfg.family == "hybrid" else jcfg.num_layers
    assert functools.reduce(dict.__getitem__, path, tp).shape[0] == n
    if jcfg.family == "audio":
        assert tp["enc_layers"]["attn"]["wq"].shape[0] == jcfg.encoder_layers


def test_params_bfloat16_round_trip(rng):
    import ml_dtypes
    a = rng.normal(size=(3, 5)).astype(ml_dtypes.bfloat16)
    t = tparams.from_numpy({"w": a}, "cpu")["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), a.astype(np.float32))
    b = tparams.to_numpy({"w": t})["w"]
    assert b.dtype == a.dtype
    np.testing.assert_array_equal(b, a)
