"""Structured-grid volumes (+ AMR nested grids), the port's own copy of
gravit_tpu/scene/volume.py (host-side numpy).

Reference: data/primitives/Volume.h. Samples are x-fastest
(samples[i + nx*(j + ny*k)]); the brick's world bounds are
origin .. origin + (counts-1)*spacing (VolApp.cpp:268-269). The AMR model
is a level-0 grid plus nested finer subgrids (griddata tree) — sampling
picks the finest grid containing the point.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from gravit_tpu_torch.scene.mesh import _CLOCK, _EditedList
from gravit_tpu_torch.scene.transfer import TransferFunction


@dataclasses.dataclass
class Volume:
    """One structured brick (a *domain* in GraviT terms).

    The editing contract, as Mesh's (scene/mesh.py), on the same edit
    clock: `revision` grows with every edit of the volume, and the facade
    uploads a volume's bricks again only when it grows (render/
    renderer.py). An edit is an assignment to a field or a change through
    `subgrids` (append, extend, +=, item assignment, del, ...). The api
    copies the samples, origin and spacing it is handed and makes the
    copies read-only (api.addVolumeSamples, api.addAmrSubgrid), so a caller
    may reuse its buffer and a write into an api volume's arrays raises.
    Not seen, and so not allowed once the volume has been rendered: writing
    into the arrays of a Volume built directly; assign a new array instead.
    The facade keys the transfer function, the isovalues and the slices by
    their values too, so editing those in place is seen. Counts, bounds,
    step size and max steps are derived from the fields and are no edit.
    """

    samples: np.ndarray            # (nz, ny, nx) float32  [z-major numpy view]
    origin: np.ndarray             # (3,)
    spacing: np.ndarray            # (3,)
    sampling_rate: float = 1.0
    tf: Optional[TransferFunction] = None
    # AMR: finer subgrids overlaying parts of this brick
    subgrids: List["Volume"] = dataclasses.field(default_factory=list)
    level: int = 0
    # implicit geometry (Volume.h slices/isovalues; rendered with the
    # hardcoded Ka/Kd headlight as in the OSPRay adapter)
    isovalues: tuple = ()
    slices: tuple = ()  # plane equations (a, b, c, d)

    def __setattr__(self, name, value) -> None:
        if name == "subgrids" and not isinstance(value, _EditedList):
            value = _EditedList(value)
        object.__setattr__(self, name, value)
        object.__setattr__(self, "_stamp", next(_CLOCK))

    @property
    def revision(self) -> int:
        """The clock's stamp of the volume's latest edit: equal readings
        mean no edit in between."""
        d = self.__dict__
        return max(d["_stamp"], d["subgrids"].stamp)

    @classmethod
    def from_flat(cls, flat: np.ndarray, counts, origin, spacing,
                  sampling_rate: float = 1.0, tf=None):
        """Build from the api layout: flat[i + nx*(j + ny*k)] (x fastest)."""
        nx, ny, nz = int(counts[0]), int(counts[1]), int(counts[2])
        samples = np.asarray(flat, np.float32).reshape(nz, ny, nx)
        return cls(samples=samples,
                   origin=np.asarray(origin, np.float32),
                   spacing=np.asarray(spacing, np.float32),
                   sampling_rate=float(sampling_rate), tf=tf)

    @property
    def counts(self) -> np.ndarray:
        nz, ny, nx = self.samples.shape
        return np.array([nx, ny, nz], np.int64)

    @property
    def bounds_min(self) -> np.ndarray:
        return self.origin.astype(np.float32)

    @property
    def bounds_max(self) -> np.ndarray:
        return (self.origin + (self.counts - 1) * self.spacing).astype(
            np.float32)

    def step_size(self) -> float:
        """March step: finest spacing / sampling rate (OSPRay convention)."""
        return float(np.min(self.spacing) / max(self.sampling_rate, 1e-6))

    def max_steps(self) -> int:
        diag = np.linalg.norm(self.bounds_max - self.bounds_min)
        return int(np.ceil(diag / self.step_size())) + 2


def wavelet_volume(n: int = 64, sampling_rate: float = 1.0,
                   tf: Optional[TransferFunction] = None) -> Volume:
    """Synthetic analog of VTK's wavelet source for tests/benchmarks."""
    idx = np.arange(n, dtype=np.float32)
    x, y, z = np.meshgrid(idx, idx, idx, indexing="ij")
    cx = (n - 1) / 2.0
    g = np.exp(-(((x - cx) ** 2 + (y - cx) ** 2 + (z - cx) ** 2)
                 / (2 * (n / 4.0) ** 2)))
    w = (
        100.0 * g
        + 30.0 * np.sin(x * 0.4) * np.cos(y * 0.35)
        + 20.0 * np.cos(z * 0.3)
    )
    samples = np.transpose(w, (2, 1, 0)).astype(np.float32)  # (nz,ny,nx)
    if tf is None:
        tf = TransferFunction.gray_ramp(low=float(samples.min()),
                                        high=float(samples.max()),
                                        max_opacity=0.05)
    return Volume(samples=samples, origin=np.zeros(3, np.float32),
                  spacing=np.ones(3, np.float32),
                  sampling_rate=sampling_rate, tf=tf)
