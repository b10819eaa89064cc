"""Build the port's CUDA sources with nvcc at first use and load them with
ctypes (a plain C interface; no PyTorch headers, so a build takes seconds).

Each source `csrc/<name>.cu` becomes `_build/lib<name>-<digest>.so`, where
the digest covers the source and the flags, so an edited source is never
served by a stale library. `_build/` is listed in .gitignore.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("bvh_traverse",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas=-v", "-shared",
              "-Xcompiler", "-fPIC")

_loaded: dict = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cand = shutil.which("nvcc") or (
        os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None)
    if not cand or not os.path.exists(cand):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build gravit_tpu_torch's kernels")
    return cand


def library_path(name: str) -> pathlib.Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build_all(names=SOURCES) -> dict:
    """Compile every source not yet built, one nvcc each, all started
    together. Returns {name: nvcc's -Xptxas=-v report} for those built;
    raises with nvcc's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{text}")
            continue
        os.replace(tmp, out)
        reports[name] = text
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `name`, built first if needed."""
    if name not in _loaded:
        path = library_path(name)
        if not path.exists():
            build_all((name,))
        _loaded[name] = ctypes.CDLL(str(path))
    return _loaded[name]
