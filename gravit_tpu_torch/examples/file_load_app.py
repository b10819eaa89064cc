"""gvtFileLoad on the port's api, counterpart of examples/file_load_app.py:
the reference SimpleFileLoadApp. Load an OBJ, one identity instance, a
point light, render.

    python -m gravit_tpu_torch.examples.file_load_app -obj path/to.obj \
        [-image|-domain]
"""

import argparse
import math
import pathlib

import numpy as np

from gravit_tpu_torch import api
from gravit_tpu_torch.scene.readers.obj import read_obj


def build_scene(obj: str, schedule: int, wsize=(512, 512),
                eye=(0.0, 0.1, 0.3), look=(0.0, 0.1, -0.3),
                output: str = "fileload", mesh=None, device=None) -> None:
    """The OBJ as one mesh named after its file, one identity instance,
    the light and camera of SimpleFileLoadApp, renderer "r"."""
    api.gvtInit(mesh=mesh, device=device)
    mesh_0 = read_obj(obj)
    name = pathlib.Path(obj).stem
    api.createMesh(name)
    api._db().find(name)["ptr"] = mesh_0  # the reader's mesh drops in
    api.finishMesh(name, compute_normal=not mesh_0.have_normals)
    api.addInstance("inst0", name, np.eye(4, dtype=np.float32).flatten())
    api.addPointLight("light", [0.0, 0.1, 0.5], [1.0, 1.0, 1.0])
    api.addCamera("cam", list(eye), list(look), [0.0, 1.0, 0.0],
                  45.0 * math.pi / 180.0, 1, 1, 0.0)
    api.addFilm("film", wsize[0], wsize[1], output)
    api.addRenderer("r", int(api.Adapter.Embree), schedule, "cam", "film")


def main():
    p = argparse.ArgumentParser()
    p.add_argument("-obj", required=True)
    p.add_argument("-image", action="store_true")
    p.add_argument("-domain", action="store_true")
    p.add_argument("-wsize", type=int, nargs=2, default=[512, 512])
    p.add_argument("-eye", type=float, nargs=3, default=[0.0, 0.1, 0.3])
    p.add_argument("-look", type=float, nargs=3, default=[0.0, 0.1, -0.3])
    p.add_argument("-output", default="fileload")
    p.add_argument("-device", default=None, help="default: the card")
    args = p.parse_args()
    sched = api.Schedule.Domain if args.domain else api.Schedule.Image
    build_scene(args.obj, int(sched), tuple(args.wsize), args.eye,
                args.look, args.output, device=args.device)
    api.render("r")
    api.writeimage("r", args.output)
    print(f"wrote {args.output}.ppm")


if __name__ == "__main__":
    main()
