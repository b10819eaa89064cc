"""VTK's wavelet (vtkRTAnalyticSource, the field pygvt/gvtVol_serial.py
renders) on a cubic WholeExtent, cut into the bricklets of GraviT's
VolApp (src/apps/render/VolApp.cpp:94-230, DIVIDE_BRICK).

The field, as vtkRTAnalyticSource's RequestData computes it, in double and
stored as float32:

    per axis, x = (Center - index) / (extent max - extent min)
    value = Maximum * exp(-(x^2 + y^2 + z^2) / (2 * SD^2))
            + XMag * sin(XFreq * x) + YMag * sin(YFreq * y)
            + ZMag * cos(ZFreq * z)

with VTK's defaults: Maximum 255, Center (0, 0, 0), StandardDeviation
0.5, XFreq 60, YFreq 30, ZFreq 40, XMag 10, YMag 18, ZMag 5. The index
runs over the extent [lo, hi] on each axis (hi - lo + 1 samples); the
coordinates are normalised by the extent, so the field's shape does not
depend on it.

The bricking is VolApp's DIVIDE_BRICK with DATA_BRICKLETS b b b, as
gravit_tpu_torch's scene/readers/bov.py splits a grid: bricks in z, then
y, then x order, each reaching one sample further on its high side (the
shared boundary layer, VolApp.cpp:204-206) except at the domain's edge,
with its origin at its first grid index and spacing 1.
"""

from __future__ import annotations

import dataclasses

import numpy as np

MAXIMUM = 255.0
CENTER = (0.0, 0.0, 0.0)
STANDARD_DEVIATION = 0.5
FREQ = (60.0, 30.0, 40.0)
MAG = (10.0, 18.0, 5.0)


@dataclasses.dataclass
class Brick:
    samples: np.ndarray        # (nz, ny, nx) float32, x fastest
    origin: np.ndarray         # (3,) float32, the first sample's (x, y, z)


@dataclasses.dataclass
class VolumeData:
    """The bricks of one field and what both sides of the benchmark need of
    it: the grid's size and bricklets, (x, y, z) each, and the field's
    minimum and maximum (the transfer function's range)."""

    bricks: list               # [Brick]
    size: tuple
    bricklets: tuple
    low: float
    high: float

    def bounds(self) -> tuple:
        """(lo, hi) of the grid in world space (spacing 1)."""
        lo = np.min([b.origin for b in self.bricks], axis=0)
        hi = np.max([b.origin + np.asarray(b.samples.shape[::-1]) - 1
                     for b in self.bricks], axis=0)
        return lo.astype(np.float64), hi.astype(np.float64)


def axis_coords(lo: int, hi: int, center: float) -> np.ndarray:
    """(Center - index) / (hi - lo) over index lo..hi, in double."""
    idx = np.arange(lo, hi + 1, dtype=np.float64)
    scale = float(hi - lo) if hi > lo else 1.0
    return (center - idx) / scale


def field(extent) -> np.ndarray:
    """The wavelet on extent (lo, hi) along every axis: (nz, ny, nx)
    float32, one z-slab at a time in double."""
    lo, hi = int(extent[0]), int(extent[1])
    x, y, z = (axis_coords(lo, hi, c) for c in CENTER)
    t2 = 2.0 * STANDARD_DEVIATION * STANDARD_DEVIATION
    xx, yy = x * x, y * y
    wave_xy = (MAG[0] * np.sin(FREQ[0] * x))[None, :] \
        + (MAG[1] * np.sin(FREQ[1] * y))[:, None]
    out = np.empty((len(z), len(y), len(x)), np.float32)
    for k, zk in enumerate(z):
        r2 = xx[None, :] + yy[:, None] + zk * zk
        out[k] = (MAXIMUM * np.exp(-r2 / t2) + wave_xy
                  + MAG[2] * np.cos(FREQ[2] * zk))
    return out


def bricklets(data: np.ndarray, size) -> list:
    """VolApp's DIVIDE_BRICK: [Brick] of `data` (nz, ny, nx) in bricklets
    of `size` (x, y, z), each with the shared boundary layer."""
    nz, ny, nx = data.shape
    bx, by, bz = (int(s) for s in size)
    out = []
    for k0 in range(0, nz, bz):
        for j0 in range(0, ny, by):
            for i0 in range(0, nx, bx):
                k1, j1, i1 = (min(k0 + bz + 1, nz), min(j0 + by + 1, ny),
                              min(i0 + bx + 1, nx))
                out.append(Brick(
                    samples=np.ascontiguousarray(data[k0:k1, j0:j1, i0:i1]),
                    origin=np.array([i0, j0, k0], np.float32)))
    return out


def scene(whole_extent=(-256, 255),
          bricklets_xyz=(256, 256, 256)) -> VolumeData:
    """The field on `whole_extent` (every axis) in VolApp's bricklets."""
    data = field(whole_extent)
    n = data.shape[0]
    return VolumeData(bricks=bricklets(data, bricklets_xyz), size=(n, n, n),
                      bricklets=tuple(int(b) for b in bricklets_xyz),
                      low=float(data.min()), high=float(data.max()))
