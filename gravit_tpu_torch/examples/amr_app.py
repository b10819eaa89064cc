"""gvtAmr on the port's api, counterpart of examples/amr_app.py: the
reference AmrApp (apps/render/AmrApp.cpp:201-401). An .amrvol index of
nested VTK structured-points grids becomes level-0 volume domains with AMR
subgrids attached via api.addAmrSubgrid; domain or image scheduling; PPM
out.

    python -m gravit_tpu_torch.examples.amr_app -volfile scene.amrvol \
        -ctffile c.cmap -otffile o.omap -wsize 512 512 [-domain]
    python -m gravit_tpu_torch.examples.amr_app     # nested wavelet subgrid

Without -volfile (or with -synthetic) it renders the minimal AMR tree: a
coarse wavelet field with a 2x-refined wavelet subgrid over its central
octant, which needs no data file.
"""

import argparse
import math
import pathlib

import numpy as np

from gravit_tpu_torch import api
from gravit_tpu_torch.scene.readers.vtk import (amr_domain_subgrids,
                                                read_amrvol,
                                                read_vtk_structured_points)
from gravit_tpu_torch.scene.transfer import TransferFunction
from gravit_tpu_torch.scene.volume import wavelet_volume


def synthetic_amr(n: int = 32):
    """Coarse n^3 wavelet + one 2x-refined central subgrid (level 1): the
    SAME wavelet field (scene/volume.py::wavelet_volume's formula)
    evaluated at half spacing over the central octant, the minimal nested
    griddata tree (Volume.h:40-165). Returns (coarse volume, fine samples,
    fine counts, fine origin, fine spacing)."""
    coarse = wavelet_volume(n)
    m = n + 1  # fine points spanning [n/4, 3n/4] at 0.5 spacing
    idx = np.arange(m, dtype=np.float32) * 0.5 + (n / 4.0)
    x, y, z = np.meshgrid(idx, idx, idx, indexing="ij")
    cx = (n - 1) / 2.0
    g = np.exp(-(((x - cx) ** 2 + (y - cx) ** 2 + (z - cx) ** 2)
                 / (2 * (n / 4.0) ** 2)))
    w = (100.0 * g + 30.0 * np.sin(x * 0.4) * np.cos(y * 0.35)
         + 20.0 * np.cos(z * 0.3))
    fine_samples = np.transpose(w, (2, 1, 0)).astype(np.float32)
    return coarse, fine_samples, [m, m, m], [n / 4.0] * 3, [0.5] * 3


def build_scene(schedule: int, volfile: str = "", ctffile: str = "",
                otffile: str = "", wsize=(500, 500), eye=None, look=None,
                samplingrate: float = 1.0, output: str = "amr",
                mesh=None, device=None) -> int:
    """The AMR scene in the api's database and a volume renderer named
    "amr" with `schedule`; returns the number of level-0 domains."""
    api.gvtInit(mesh=mesh, device=device)
    db = api._db()
    if not volfile:
        coarse, fsamp, fcounts, forigin, fspacing = synthetic_amr()
        name = "amrvol0"
        api.createVolume(name, amr=True)
        db.find(name)["tf"] = TransferFunction.gray_ramp(
            low=-50.0, high=150.0, max_opacity=0.1)
        api.addVolumeSamples(
            name, coarse.samples.reshape(-1), list(coarse.counts),
            list(coarse.origin), list(coarse.spacing), samplingrate)
        api.addAmrSubgrid(name, 1, 1, np.asarray(fsamp).reshape(-1),
                          fcounts, forigin, fspacing)
        api.addInstance("inst0", name,
                        np.eye(4, dtype=np.float32).flatten())
        domains = 1
        lo = np.asarray(coarse.bounds_min)
        hi = np.asarray(coarse.bounds_max)
        eye = eye or (((lo + hi) / 2) + (hi - lo) * 2.0).tolist()
        look = look or ((lo + hi) / 2).tolist()
    else:
        # the AmrApp path proper: amrvol index -> level-0 domains, BFS
        # subgrid tree per domain (AmrApp.cpp:316-334), TF range 0..83.1
        # (AmrApp.cpp:308)
        idx = read_amrvol(volfile)
        domains = idx.grids_per_level[0]
        for d in range(domains):
            name = f"{volfile}{d}"
            api.createVolume(name, amr=True)
            api.addVolumeTransferFunctions(name, ctffile, otffile, 0.0, 83.1)
            g = read_vtk_structured_points(idx.grid_files[d])
            api.addVolumeSamples(name, g.data.reshape(-1), list(g.dims),
                                 list(g.origin), list(g.spacing),
                                 samplingrate)
            for k in amr_domain_subgrids(idx, d):
                sg = read_vtk_structured_points(idx.grid_files[k])
                api.addAmrSubgrid(name, k, idx.level_of_grid[k],
                                  sg.data.reshape(-1), list(sg.dims),
                                  list(sg.origin), list(sg.spacing))
            api.addInstance(f"inst{d}", name,
                            np.eye(4, dtype=np.float32).flatten())
        eye = eye or [3.0, 3.0, 3.0]
        look = look or [-4.0, -4.0, -4.0]
    api.addCamera("conecam", eye, look, [0.0, 0.0, 1.0],
                  30.0 * math.pi / 180.0, 1, 1, 0.5)
    api.addFilm("conefilm", wsize[0], wsize[1], output)
    api.addRenderer("amr", int(api.Adapter.Pvol), schedule, "conecam",
                    "conefilm", volume=True)
    return domains


def main():
    p = argparse.ArgumentParser()
    p.add_argument("-volfile", default="")
    p.add_argument("-ctffile", default="")
    p.add_argument("-otffile", default="")
    p.add_argument("-synthetic", action="store_true")
    p.add_argument("-image", action="store_true")
    p.add_argument("-domain", action="store_true")
    p.add_argument("-wsize", type=int, nargs=2, default=[500, 500])
    p.add_argument("-eye", type=float, nargs=3, default=None)
    p.add_argument("-look", type=float, nargs=3, default=None)
    p.add_argument("-samplingrate", type=float, default=1.0)
    p.add_argument("-output", default="amr")
    p.add_argument("-device", default=None, help="default: the card")
    args = p.parse_args()
    volfile = args.volfile
    if args.synthetic or not (volfile and pathlib.Path(volfile).exists()):
        volfile = ""
    sched = api.Schedule.Domain if args.domain else api.Schedule.Image
    domains = build_scene(int(sched), volfile, args.ctffile, args.otffile,
                          tuple(args.wsize), args.eye, args.look,
                          args.samplingrate, args.output, device=args.device)
    api.render("amr")
    api.writeimage("amr", args.output)
    print(f"wrote {args.output}.ppm ({domains} AMR domain(s))")


if __name__ == "__main__":
    main()
