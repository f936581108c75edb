"""The port's checkpoints: the JAX package's checkpoint tests on
``repro_torch.distributed.checkpoint``, and checkpoints that restore bit for
bit in the other package, bf16 leaves included."""
import ast
import json
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.distributed import checkpoint as jckpt  # noqa: E402
from repro_torch.distributed import checkpoint as ckpt  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def tree():
    return {"params": {"w": torch.arange(12.0).reshape(3, 4),
                       "b": torch.ones(4, dtype=torch.bfloat16)},
            "opt": {"step": torch.tensor(7, dtype=torch.int32)}}


def test_roundtrip_preserves_shapes_dtypes(tmp_path):
    t = tree()
    ckpt.save_checkpoint(tmp_path, 7, t)
    step, r = ckpt.restore_checkpoint(tmp_path, device="cpu")
    assert step == 7
    assert r["params"]["w"].shape == (3, 4)
    assert r["params"]["b"].dtype == torch.bfloat16
    assert torch.equal(t["params"]["w"], r["params"]["w"])
    assert torch.equal(t["params"]["b"], r["params"]["b"])
    assert r["opt"]["step"].dtype == torch.int32
    assert int(r["opt"]["step"]) == 7


def test_corruption_detected(tmp_path):
    ckpt.save_checkpoint(tmp_path, 1, tree())
    victim = next((tmp_path / "step_0000000001").glob("params.w.npy"))
    raw = bytearray(victim.read_bytes())
    raw[-1] ^= 0xFF
    victim.write_bytes(bytes(raw))
    with pytest.raises(IOError):
        ckpt.restore_checkpoint(tmp_path, 1, device="cpu")


def test_half_written_checkpoint_is_invisible(tmp_path):
    ckpt.save_checkpoint(tmp_path, 1, tree())
    # a crashed writer leaves a temp dir: restore must ignore it
    broken = tmp_path / ".tmp_step_0000000002_999"
    broken.mkdir()
    (broken / "params.w.npy").write_bytes(b"garbage")
    assert ckpt.latest_step(tmp_path) == 1
    step, _ = ckpt.restore_checkpoint(tmp_path, device="cpu")
    assert step == 1
    # likewise a published dir without manifest (older partial semantics)
    nomanifest = tmp_path / "step_0000000003"
    nomanifest.mkdir()
    assert ckpt.latest_step(tmp_path) == 1


def test_gc_keeps_latest(tmp_path):
    for s in range(6):
        ckpt.save_checkpoint(tmp_path, s, tree(), keep=3)
    steps = sorted(int(p.name.split("_")[1])
                   for p in tmp_path.glob("step_*"))
    assert steps == [3, 4, 5]


def test_manifest_records_hashes(tmp_path):
    d = ckpt.save_checkpoint(tmp_path, 2, tree())
    man = json.loads((d / "manifest.json").read_text())
    assert set(man["leaves"]) == {"params.w", "params.b", "opt.step"}
    assert man["leaves"]["params.b"]["dtype"] == "bfloat16"
    for meta in man["leaves"].values():
        assert len(meta["sha256"]) == 64


def test_restore_aims_at_the_card_by_default(tmp_path, monkeypatch):
    """Without a device argument the tree is restored onto the card; with
    none available, restore raises rather than hand back CPU tensors."""
    ckpt.save_checkpoint(tmp_path, 1, tree())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ckpt.restore_checkpoint(tmp_path)


def test_bf16_round_trip_without_ml_dtypes(tmp_path, monkeypatch):
    """bf16 leaves save and restore with ``ml_dtypes`` unimportable, as on a
    machine that does not have it."""
    monkeypatch.setitem(sys.modules, "ml_dtypes", None)
    with pytest.raises(ImportError):
        import ml_dtypes  # noqa: F401
    gen = torch.Generator().manual_seed(0)
    w = torch.randn(5, 7, generator=gen).bfloat16()
    ckpt.save_checkpoint(tmp_path, 3, {"w": w})
    _, r = ckpt.restore_checkpoint(tmp_path, device="cpu")
    assert r["w"].dtype == torch.bfloat16
    assert torch.equal(r["w"].view(torch.int16), w.view(torch.int16))


def test_checkpoint_module_does_not_import_ml_dtypes():
    src = (ROOT / "src/repro_torch/distributed/checkpoint.py").read_text()
    names = {a.name for n in ast.walk(ast.parse(src))
             if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module for n in ast.walk(ast.parse(src))
              if isinstance(n, ast.ImportFrom)}
    assert "ml_dtypes" not in names


# --------------------------------------------------------------------------
# across the two packages
# --------------------------------------------------------------------------

def _mixed(rng):
    """f32, bf16 and int32 leaves, nested, with a 0-d step."""
    import ml_dtypes
    return {"params": {
        "w": rng.normal(size=(4, 6)).astype(np.float32),
        "b16": rng.normal(size=(3, 5)).astype(ml_dtypes.bfloat16),
        "layers": {"k": rng.normal(size=(2, 3, 4)).astype(ml_dtypes.bfloat16),
                   "idx": rng.integers(-9, 9, (5,)).astype(np.int32)}},
        "opt": {"step": np.asarray(11, np.int32)}}


def _flat(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _flat(v, prefix + k + ".")
        else:
            yield prefix + k, v


def _bits(x):
    """A leaf's raw bytes, dtype and shape: bf16 from either side compares
    by its 16-bit patterns."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().tobytes(), "bfloat16", \
                tuple(x.shape)
        x = x.numpy()
    x = np.asarray(x)
    return x.tobytes(), x.dtype.name, x.shape


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoint_restores_bit_for_bit_in_the_other_package(writer,
                                                              tmp_path, rng):
    ref = _mixed(rng)
    if writer == "jax":
        jckpt.save_checkpoint(tmp_path, 5, {
            k: {kk: jnp.asarray(vv) if not isinstance(vv, dict) else
                {a: jnp.asarray(b) for a, b in vv.items()}
                for kk, vv in v.items()} for k, v in ref.items()})
        step, got = ckpt.restore_checkpoint(tmp_path, device="cpu")
    else:
        from repro_torch import params as tparams
        ckpt.save_checkpoint(tmp_path, 5, tparams.from_numpy(ref, "cpu"))
        step, got = jckpt.restore_checkpoint(tmp_path)
    assert step == 5
    a, b = dict(_flat(ref)), dict(_flat(got))
    assert a.keys() == b.keys()
    for name in a:
        assert _bits(a[name]) == _bits(b[name]), name


def test_port_and_reference_write_the_same_manifest(tmp_path, rng):
    """Leaf names, shapes and dtypes in the manifests agree; the hashes of
    bf16 files differ only by the void's byte-order mark in the header."""
    from repro_torch import params as tparams
    ref = _mixed(rng)
    dj = jckpt.save_checkpoint(tmp_path / "j", 1, ref)
    dt = ckpt.save_checkpoint(tmp_path / "t", 1,
                              tparams.from_numpy(ref, "cpu"))
    mj = json.loads((dj / "manifest.json").read_text())["leaves"]
    mt = json.loads((dt / "manifest.json").read_text())["leaves"]
    assert mj.keys() == mt.keys()
    for name in mj:
        assert (mj[name]["shape"], mj[name]["dtype"]) == \
            (mt[name]["shape"], mt[name]["dtype"]), name
        if mj[name]["dtype"] != "bfloat16":
            assert mj[name]["sha256"] == mt[name]["sha256"], name
