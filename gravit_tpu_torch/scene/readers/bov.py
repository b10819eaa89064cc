"""BOV (Block Of Values) volume reader.
Counterpart of gravit_tpu/scene/readers/bov.py, copied (numpy only).

Reference: VolApp.cpp's bovheader struct (apps/render/VolApp.cpp:94-270):
a text header (DATA_FILE, DATA_SIZE, DATA_FORMAT, DATA_BRICKLETS, ...) next
to a raw binary data file; DIVIDE_BRICK splits the grid into bricklets with
a shared boundary layer (counts+1 except at the low edge) — the domain
decomposition the domain scheduler consumes.
"""

from __future__ import annotations

import dataclasses
import pathlib
from typing import List, Optional

import numpy as np

from gravit_tpu_torch.scene.transfer import TransferFunction
from gravit_tpu_torch.scene.volume import Volume

_FORMATS = {"FLOAT": np.float32, "INT": np.int32, "DOUBLE": np.float64,
            "BYTE": np.uint8, "SHORT": np.int16}


@dataclasses.dataclass
class BovHeader:
    data_file: str
    size: tuple
    fmt: str
    bricklets: tuple
    divide: bool
    variable: str = ""


def read_bov_header(path: str) -> BovHeader:
    kv = {}
    for line in pathlib.Path(path).read_text().splitlines():
        if ":" in line:
            k, v = line.split(":", 1)
            kv[k.strip().upper()] = v.strip()
    size = tuple(int(x) for x in kv["DATA_SIZE"].split())
    bricklets = tuple(int(x) for x in kv.get(
        "DATA_BRICKLETS", kv["DATA_SIZE"]).split())
    return BovHeader(
        data_file=kv["DATA_FILE"],
        size=size,
        fmt=kv.get("DATA_FORMAT", "FLOAT").upper(),
        bricklets=bricklets,
        divide=kv.get("DIVIDE_BRICK", "false").lower() == "true",
        variable=kv.get("VARIABLE", ""),
    )


def read_bov(path: str, tf: Optional[TransferFunction] = None,
             sampling_rate: float = 1.0) -> List[Volume]:
    """Load a .bov into one Volume, or a list of bricklet Volumes when
    DIVIDE_BRICK is true (VolApp brick reader semantics: interior bricks
    gain one shared boundary layer on the low side of each axis)."""
    hdr = read_bov_header(path)
    base = pathlib.Path(path).parent
    dtype = _FORMATS[hdr.fmt]
    raw = np.fromfile(base / hdr.data_file, dtype=dtype)
    nx, ny, nz = hdr.size
    data = raw[: nx * ny * nz].astype(np.float32).reshape(nz, ny, nx)

    if tf is None:
        tf = TransferFunction.gray_ramp(low=float(data.min()),
                                        high=float(data.max()),
                                        max_opacity=0.05)

    if not hdr.divide or hdr.bricklets == hdr.size:
        return [Volume(samples=data, origin=np.zeros(3, np.float32),
                       spacing=np.ones(3, np.float32),
                       sampling_rate=sampling_rate, tf=tf)]

    bx, by, bz = hdr.bricklets
    out = []
    for k0 in range(0, nz, bz):
        for j0 in range(0, ny, by):
            for i0 in range(0, nx, bx):
                # shared boundary layer: extend one sample on the high side
                # (counts+1 unless at the domain edge), per VolApp.cpp:204-206
                i1 = min(i0 + bx + 1, nx)
                j1 = min(j0 + by + 1, ny)
                k1 = min(k0 + bz + 1, nz)
                brick = data[k0:k1, j0:j1, i0:i1].copy()
                out.append(Volume(
                    samples=brick,
                    origin=np.array([i0, j0, k0], np.float32),
                    spacing=np.ones(3, np.float32),
                    sampling_rate=sampling_rate, tf=tf))
    return out
