"""Native host runtime bindings (ctypes over gravit_host.cpp), counterpart
of gravit_tpu/native/__init__.py.

The library is built with `g++ -O3 -fPIC -shared` at first use into
`gravit_tpu_torch/_build/libgravit_host-<digest>.so`, where the digest
covers the source and the flags (as ops/_build.py names the kernels'
libraries), so an edited source is never served by a stale library and
nothing is written next to the source. Every entry point returns None
when the library cannot be built or loaded; the callers then take their
numpy path (accel/bvh.py::_build_bvh_py), as the JAX package's do.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
from typing import Optional

import numpy as np

_SRC = pathlib.Path(__file__).resolve().parent / "gravit_host.cpp"
BUILD_DIR = _SRC.parent.parent / "_build"
GXX_FLAGS = ("-O3", "-fPIC", "-shared")

_lib: Optional[ctypes.CDLL] = None
_tried = False
# why the library is unavailable (None while it is, or before the first try)
error: Optional[str] = None


def library_path() -> pathlib.Path:
    digest = hashlib.sha256(_SRC.read_bytes()
                            + " ".join(GXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libgravit_host-{digest[:12]}.so"


def _build(out: pathlib.Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(_SRC)],
                   check=True, capture_output=True, timeout=120)
    os.replace(tmp, out)     # atomic: concurrent builders never see half


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried, error
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        path = library_path()
        if not path.exists():
            _build(path)
        lib = ctypes.CDLL(str(path))
    except (OSError, subprocess.SubprocessError) as exc:
        error = f"{type(exc).__name__}: {exc}"
        return None
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.gravit_build_bvh.restype = ctypes.c_int
    lib.gravit_build_bvh.argtypes = [
        f32p, f32p, f32p, ctypes.c_int, ctypes.c_int,
        f32p, i32p, i32p, ctypes.POINTER(ctypes.c_int32)]
    lib.gravit_parse_obj.restype = ctypes.c_int
    lib.gravit_parse_obj.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32)]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def build_bvh_native(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray,
                     max_leaf: int = 8):
    """Native binned-SAH build; returns (bounds, meta, order, depth) or
    None if the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    t = v0.shape[0]
    cap = max(2 * t + 8, 16)
    bounds = np.zeros((cap, 8), np.float32)
    meta = np.zeros((cap, 4), np.int32)
    order = np.zeros((t,), np.int32)
    depth = ctypes.c_int32(0)
    n = lib.gravit_build_bvh(
        np.ascontiguousarray(v0, np.float32),
        np.ascontiguousarray(e1, np.float32),
        np.ascontiguousarray(e2, np.float32),
        t, max_leaf, bounds.reshape(-1), meta.reshape(-1), order,
        ctypes.byref(depth))
    if n <= 0:
        return None
    return bounds[:n].copy(), meta[:n].copy(), order, int(depth.value)


def parse_obj_native(path: str):
    """Native OBJ vertex/face scan; returns (verts (V,3), faces (F,3)) or
    None."""
    lib = _load()
    if lib is None:
        return None
    nv = ctypes.c_int32(0)
    nf = ctypes.c_int32(0)
    rc = lib.gravit_parse_obj(path.encode(), None, None,
                              ctypes.byref(nv), ctypes.byref(nf))
    if rc != 0 or nv.value <= 0:
        return None
    verts = np.zeros((nv.value, 3), np.float32)
    faces = np.zeros((max(nf.value, 1), 3), np.int32)
    rc = lib.gravit_parse_obj(
        path.encode(), verts.ctypes.data_as(ctypes.c_void_p),
        faces.ctypes.data_as(ctypes.c_void_p),
        ctypes.byref(nv), ctypes.byref(nf))
    if rc != 0:
        return None
    return verts, faces[: nf.value]
