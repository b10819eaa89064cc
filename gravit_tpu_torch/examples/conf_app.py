"""Render a scene described by a .conf file (the ConfigFileLoader
equivalent), counterpart of examples/conf_app.py. The reference's
ConfigFileLoader (apps/render/ConfigFileLoader.cpp) is bit-rotted and
disabled; this drives the same README.conf format end to end, and the
geometry-domain list of data/geom/*.conf:

    python -m gravit_tpu_torch.examples.conf_app path/to/scene.conf \
        [-output out]
"""

import argparse
import math
import pathlib

import numpy as np

from gravit_tpu_torch import api
from gravit_tpu_torch.scene.readers.bov import read_bov
from gravit_tpu_torch.scene.readers.conf import (read_geom_conf,
                                                 read_render_conf)
from gravit_tpu_torch.scene.readers.obj import read_obj
from gravit_tpu_torch.scene.readers.ply import read_ply

SCHEDULES = {"Image": api.Schedule.Image, "Domain": api.Schedule.Domain,
             "LoadOnce": api.Schedule.LoadOnce,
             "LoadAnyOnce": api.Schedule.LoadAnyOnce,
             "LoadAnother": api.Schedule.LoadAnother,
             "LoadMany": api.Schedule.LoadMany}


def is_geom_conf(path: str) -> bool:
    """data/geom/*.conf lines are `file lox loy loz hix hiy hiz`: detect
    that shape so both reference .conf dialects work from one app."""
    for line in pathlib.Path(path).read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        if len(parts) >= 7:
            try:
                [float(x) for x in parts[1:7]]
                return True
            except ValueError:
                return False
        return False
    return False


def build_geom_conf(conf: str, output: str, mesh=None, device=None) -> int:
    """Format 1 (geometry-domain list): one mesh domain per line, a default
    camera fitted to the union bounding box (PlyApp.cpp's role), renderer
    "r". Returns the number of domains."""
    entries = read_geom_conf(conf)
    api.gvtInit(mesh=mesh, device=device)
    lo = np.array([e.lo for e in entries], np.float32).min(axis=0)
    hi = np.array([e.hi for e in entries], np.float32).max(axis=0)
    for i, e in enumerate(entries):
        mesh_i = (read_ply(e.path) if e.path.endswith(".ply")
                  else read_obj(e.path))
        name = f"m{i}"
        api.createMesh(name)
        api._db().find(name)["ptr"] = mesh_i
        api.finishMesh(name, compute_normal=not mesh_i.have_normals)
        api.addInstance(f"inst{i}", name,
                        np.eye(4, dtype=np.float32).flatten())
    c = (lo + hi) / 2.0
    diag = float(np.linalg.norm(hi - lo)) or 1.0
    eye = [float(c[0]), float(c[1]), float(c[2] + 1.2 * diag)]
    api.addPointLight("light", [eye[0], eye[1] + diag, eye[2]],
                      [1.0, 1.0, 1.0])
    api.addCamera("cam", eye, [float(x) for x in c], [0.0, 1.0, 0.0],
                  45.0 * math.pi / 180.0, 1, 1, 0.0)
    api.addFilm("film", 512, 512, output)
    api.addRenderer("r", int(api.Adapter.Embree), int(api.Schedule.Image),
                    "cam", "film")
    return len(entries)


def build_render_conf(conf: str, output: str, mesh=None,
                      device=None) -> None:
    """Format 2 (README.conf): the OBJ or BOV data file, its camera and
    film and schedule, renderer "r"."""
    cfg = read_render_conf(conf)
    api.gvtInit(mesh=mesh, device=device)
    base = pathlib.Path(conf).parent
    volume = cfg.render_type.lower() == "volume"
    if volume:
        datafile = str((base / cfg.datafile)
                       if not pathlib.Path(cfg.datafile).is_absolute()
                       else cfg.datafile)
        db = api._db()
        for i, b in enumerate(read_bov(datafile,
                                       sampling_rate=cfg.sample_rate)):
            name = f"vol{i}"
            api.createVolume(name)
            db.find(name)["tf"] = b.tf
            api.addVolumeSamples(name, b.samples.reshape(-1),
                                 list(b.counts), list(b.origin),
                                 list(b.spacing), b.sampling_rate)
            api.addInstance(f"inst{i}", name,
                            np.eye(4, dtype=np.float32).flatten())
    else:
        mesh_0 = read_obj(str(base / cfg.datafile))
        api.createMesh("m0")
        api._db().find("m0")["ptr"] = mesh_0
        api.finishMesh("m0", compute_normal=not mesh_0.have_normals)
        api.addInstance("inst0", "m0", np.eye(4, dtype=np.float32).flatten())
        api.addPointLight("light", list(np.asarray(cfg.camera) +
                                        np.array([0.0, 100.0, 0.0])),
                          [1.0, 1.0, 1.0])
    api.addCamera("cam", cfg.camera, cfg.focus, cfg.up,
                  cfg.view_angle * math.pi / 180.0, 1, 1, 0.5)
    api.addFilm("film", cfg.width, cfg.height, output)
    sched = SCHEDULES.get(cfg.schedule_type, api.Schedule.Image)
    adapter = api.Adapter.Pvol if volume else api.Adapter.Embree
    api.addRenderer("r", int(adapter), int(sched), "cam", "film",
                    volume=volume)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("conf")
    p.add_argument("-output", default="conf_render")
    p.add_argument("-device", default=None, help="default: the card")
    args = p.parse_args()
    if is_geom_conf(args.conf):
        n = build_geom_conf(args.conf, args.output, device=args.device)
        what = f" ({n} domain(s))"
    else:
        build_render_conf(args.conf, args.output, device=args.device)
        what = ""
    api.render("r")
    api.writeimage("r", args.output)
    print(f"wrote {args.output}.ppm{what}")


if __name__ == "__main__":
    main()
