"""The port stands alone: no file of gravit_tpu_torch, and not chip_smoke.py,
imports jax or any module of the JAX package, and importing every module of
the port loads no gravit_tpu module."""

import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "gravit_tpu_torch"
FORBIDDEN = re.compile(r"^\s*(import jax|from jax)|gravit_tpu\.", re.M)


def port_sources():
    files = sorted(p for p in PORT.rglob("*")
                   if p.suffix in (".py", ".cu", ".cuh", ".h")
                   and "_build" not in p.parts)
    return files + [ROOT / "chip_smoke.py"]


def test_sources_import_no_jax_and_no_jax_package():
    files = port_sources()
    assert len(files) > 15
    bad = {str(p.relative_to(ROOT)): m.group(0).strip()
           for p in files
           for m in [FORBIDDEN.search(p.read_text())] if m}
    assert not bad, bad


def test_importing_the_port_loads_no_jax_package_module():
    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        .removesuffix(".__init__")
        for p in PORT.rglob("*.py") if "_build" not in p.parts)
    code = (
        "import sys\n"
        f"for m in {modules!r}:\n"
        "    __import__(m)\n"
        "bad = [m for m in sys.modules\n"
        "       if m == 'gravit_tpu' or m.startswith('gravit_tpu.')]\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
