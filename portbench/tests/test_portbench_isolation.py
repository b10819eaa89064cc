"""Nothing the benchmark runs imports jax, jaxlib, flax or the JAX package
(gravit_tpu), by top-level module names compared whole; the reference
imports nothing of the program (gravit_tpu_torch) either."""

import ast
import pathlib
import subprocess
import sys

from portbench import run as bench

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
JAX_SIDE = {"jax", "jaxlib", "flax", "gravit_tpu"}


def _imported_tops(path: pathlib.Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.partition(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.partition(".")[0])
    return tops


def _sources(under: pathlib.Path) -> list:
    return sorted(p for p in under.rglob("*.py") if "tests" not in p.parts)


def test_no_source_imports_the_jax_side():
    files = _sources(BENCH)
    assert len(files) > 20
    bad = {str(p.relative_to(ROOT)): sorted(_imported_tops(p) & JAX_SIDE)
           for p in files if _imported_tops(p) & JAX_SIDE}
    assert not bad, bad


def test_reference_imports_nothing_of_the_program():
    allowed = {"__future__", "dataclasses", "math", "numpy", "torch",
               "portbench"}
    for p in _sources(BENCH / "reference"):
        tops = _imported_tops(p)
        assert tops <= allowed, (p.name, tops - allowed)


def test_forbidden_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "gravit_tpu_torch_lookalike", sys)
    assert "gravit_tpu" not in bench.forbidden_modules()
    monkeypatch.setitem(sys.modules, "gravit_tpu.scene", sys)
    assert "gravit_tpu" in bench.forbidden_modules()


def test_a_run_loads_no_jax_side_module():
    """A whole run of a cell (CPU, small film, traced) in a process of its
    own: no module of the JAX side is loaded once it has finished."""
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from portbench import harness, run\n"
        "cell = harness.load_cell('gvt_simple.api_orbit')\n"
        "cell.traffic = dict(cell.traffic, trace_frames=1, warmup_frames=1,"
        " warmup_seconds=0.0)\n"
        "for trace in (False, True):\n"
        "    run.run_cell(cell, 5, 0.2, trace, device='cpu', film=(16, 16))\n"
        "print(run.forbidden_modules())\n"
        "print(sorted({m.partition('.')[0] for m in sys.modules}"
        " & {'gravit_tpu_torch', 'torch'}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT,
                         env={"PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert lines[-2] == "[]", out.stdout
    assert lines[-1] == "['gravit_tpu_torch', 'torch']", out.stdout
