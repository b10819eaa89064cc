"""ASCII VTK structured-points + .amrvol readers (the AmrApp inputs).
Counterpart of gravit_tpu/scene/readers/vtk.py, copied (numpy only).

The reference AmrApp (apps/render/AmrApp.cpp:246-262, 300-365) reads an
.amrvol index file and a set of VTK STRUCTURED_POINTS grids through
vtkStructuredPointsReader. The .amrvol layout (data/vol/*.amrvol):

    <number of levels>
    <grids in level 0> ... <grids in level L-1>     (one count per line)
    <gridfile> <parent-index>                       (one line per grid,
                                                     parent -1 = level 0)

Only the ASCII STRUCTURED_POINTS subset the reference data uses is
supported here; no VTK dependency.
"""

from __future__ import annotations

import dataclasses
import pathlib
from typing import List

import numpy as np

from gravit_tpu_torch.scene.volume import Volume


@dataclasses.dataclass
class VtkGrid:
    dims: tuple          # (nx, ny, nz) POINT dimensions
    origin: np.ndarray   # (3,) f32
    spacing: np.ndarray  # (3,) f32
    data: np.ndarray     # (nz, ny, nx) f32, x fastest in the file


def read_vtk_structured_points(path: str) -> VtkGrid:
    """Parse an ASCII VTK DataFile v2 STRUCTURED_POINTS scalar grid."""
    text = pathlib.Path(path).read_text()
    lines = [ln.strip() for ln in text.splitlines()]
    dims = origin = spacing = None
    npoints = None
    data_start = None
    for i, ln in enumerate(lines):
        up = ln.upper()
        if up.startswith("DIMENSIONS"):
            dims = tuple(int(x) for x in ln.split()[1:4])
        elif up.startswith("ORIGIN"):
            origin = np.array([float(x) for x in ln.split()[1:4]],
                              np.float32)
        elif up.startswith("SPACING") or up.startswith("ASPECT_RATIO"):
            spacing = np.array([float(x) for x in ln.split()[1:4]],
                               np.float32)
        elif up.startswith("POINT_DATA"):
            npoints = int(ln.split()[1])
        elif up.startswith("LOOKUP_TABLE"):
            data_start = i + 1
            break
    if dims is None or data_start is None:
        raise ValueError(f"{path}: not an ASCII STRUCTURED_POINTS file")
    if npoints is None:
        npoints = dims[0] * dims[1] * dims[2]
    flat = np.array(" ".join(lines[data_start:]).split(),
                    np.float32)[:npoints]
    nx, ny, nz = dims
    return VtkGrid(dims=dims, origin=origin, spacing=spacing,
                   data=flat.reshape(nz, ny, nx))


@dataclasses.dataclass
class AmrIndex:
    levels: int
    grids_per_level: List[int]
    grid_files: List[str]       # absolute-ish paths (resolved vs amrvol dir)
    parent: List[int]           # -1 for level-0 grids
    level_of_grid: List[int]
    subgrids: List[List[int]]   # children indices per grid


def read_amrvol(path: str) -> AmrIndex:
    """Parse the .amrvol index (the amrheader logic, AmrApp.cpp:246-262)."""
    p = pathlib.Path(path)
    lines = [ln.strip() for ln in p.read_text().splitlines() if ln.strip()]
    levels = int(lines[0])
    grids_per_level = [int(lines[1 + l]) for l in range(levels)]
    total = sum(grids_per_level)
    files, parent, level_of = [], [], []
    gi = 0
    for l in range(levels):
        for _ in range(grids_per_level[l]):
            parts = lines[1 + levels + gi].split()
            files.append(str(p.parent / parts[0]))
            parent.append(int(parts[1]))
            level_of.append(l)
            gi += 1
    subgrids = [[] for _ in range(total)]
    for g, par in enumerate(parent):
        if par >= 0:
            subgrids[par].append(g)
    return AmrIndex(levels=levels, grids_per_level=grids_per_level,
                    grid_files=files, parent=parent,
                    level_of_grid=level_of, subgrids=subgrids)


def amr_domain_subgrids(idx: AmrIndex, domain: int) -> List[int]:
    """BFS over the subgrid tree of one level-0 grid (AmrApp.cpp:316-334)."""
    out, queue = [], list(idx.subgrids[domain])
    while queue:
        g = queue.pop(0)
        out.append(g)
        queue.extend(idx.subgrids[g])
    return out


def read_amr_volume(path: str, tf=None, sampling_rate: float = 1.0
                    ) -> List[Volume]:
    """Load an .amrvol as a list of level-0 Volumes, each carrying its
    nested subgrids as Volume.subgrids (finer levels last, the
    sample_amr override order)."""
    idx = read_amrvol(path)
    out = []
    for d in range(idx.grids_per_level[0]):
        g = read_vtk_structured_points(idx.grid_files[d])
        vol = Volume(samples=g.data, origin=g.origin, spacing=g.spacing,
                     sampling_rate=sampling_rate, tf=tf)
        subs = sorted(amr_domain_subgrids(idx, d),
                      key=lambda k: idx.level_of_grid[k])
        for k in subs:
            sg = read_vtk_structured_points(idx.grid_files[k])
            sub = Volume(samples=sg.data, origin=sg.origin,
                         spacing=sg.spacing, tf=tf)
            sub.level = idx.level_of_grid[k]
            vol.subgrids.append(sub)
        out.append(vol)
    return out
