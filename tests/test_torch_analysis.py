"""The port's determinism linter (``repro_torch.analysis``, a copy of the
JAX package's ``repro.analysis`` held by tests/test_torch_control_plane.py)
scoped to the port: the clean tree passes the CLI gate, and the rules fire
on a copy of the port's own tree with a seeded fault."""
from __future__ import annotations

import shutil
from pathlib import Path

import pytest

from repro.analysis import lint as jlint
from repro_torch.analysis import lint_file, lint_paths
from repro_torch.analysis.__main__ import main as lint_main
from repro_torch.analysis.crosscheck import crosscheck
from repro_torch.analysis.lint import SIM_PACKAGES, in_core_scope, \
    in_sim_scope

REPO = Path(__file__).resolve().parent.parent
SRC = REPO / "src" / "repro_torch"


@pytest.fixture
def port_copy(tmp_path):
    """A copy of the port's package tree (Python files only)."""
    root = tmp_path / "repro_torch"
    shutil.copytree(SRC, root, ignore=lambda d, names: [
        n for n in names
        if not n.endswith(".py") and not (Path(d) / n).is_dir()
        or n == "__pycache__"])
    return root


def test_port_tree_is_clean():
    """`python -m repro_torch.analysis src/repro_torch --check-goldens
    tests` finds nothing on the shipped tree."""
    findings = lint_paths([SRC], goldens_dir=REPO / "tests")
    assert findings == [], "\n".join(str(f) for f in findings)


def test_port_tree_cli_exit_0(capsys):
    assert lint_main([str(SRC), "--check-goldens", str(REPO / "tests")]) == 0
    assert "0 findings (clean)" in capsys.readouterr().err


def test_cli_lints_the_port_by_default(monkeypatch, capsys):
    monkeypatch.chdir(REPO)
    assert lint_main([]) == 0
    assert "0 findings (clean)" in capsys.readouterr().err


@pytest.mark.parametrize("pkg", SIM_PACKAGES)
def test_scope_is_the_ports_sim_packages(pkg):
    """R1-R3 run on repro_torch/{core,engine,api,data}; the reference's
    linter, whose scope is a path part named repro, sees none of them."""
    path = Path("src") / "repro_torch" / pkg / "mod.py"
    assert in_sim_scope(path)
    assert in_core_scope(path) == (pkg == "core")
    assert not jlint.in_sim_scope(path)
    assert not in_sim_scope(Path("src") / "repro" / pkg / "mod.py")


@pytest.mark.parametrize("pkg", ["launch", "train", "distributed",
                                 "models", "kernels"])
def test_wall_clock_code_is_out_of_scope(pkg):
    assert not in_sim_scope(Path("src") / "repro_torch" / pkg / "mod.py")


def test_seeded_wall_clock_read_is_r1(port_copy, capsys):
    """A time.time() seeded into a copy of a port core module: an R1
    finding at that line, and the CLI exits 1."""
    path = port_copy / "core" / "router.py"
    source = path.read_text()
    path.write_text(source + "\nimport time\n_T0 = time.time()\n")
    line = len((source + "\nimport time\n").splitlines()) + 1
    findings = [f for f in lint_file(path) if f.rule == "R1"]
    assert [(f.path, f.line) for f in findings] == [(str(path), line)]
    assert lint_main([str(port_copy)]) == 1
    out = capsys.readouterr().out
    assert f"{path}:{line}: R1" in out


def test_seeded_unordered_iteration_is_r2(port_copy):
    path = port_copy / "engine" / "scheduler.py"
    path.write_text(path.read_text()
                    + "\n\ndef _order(xs):\n    return list(set(xs))\n")
    assert [f.rule for f in lint_file(path)] == ["R2"]


def test_status_outside_the_taxonomy_is_r4(port_copy):
    """A status constant missing from the taxonomy, seeded into a copy of
    the port's web gateway: one R4 finding that names it."""
    path = port_copy / "core" / "web_gateway.py"
    path.write_text(path.read_text() + "\nHTTP_TEAPOT = 418\n")
    findings = crosscheck(port_copy)
    assert len(findings) == 1 and findings[0].rule == "R4"
    assert "418" in findings[0].message
    assert lint_main([str(port_copy)]) == 1


def test_golden_drift_is_r4(port_copy, tmp_path):
    """The GOLDEN status table of tests/test_api.py without one status."""
    tests_dir = tmp_path / "tests"
    tests_dir.mkdir()
    golden = (REPO / "tests" / "test_api.py").read_text()
    assert "429:" in golden
    (tests_dir / "test_api.py").write_text(golden.replace("429:", "4290:"))
    findings = crosscheck(port_copy, goldens_dir=tests_dir)
    assert findings and all(f.rule == "R4" for f in findings)
