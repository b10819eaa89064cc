"""gvtSimple on the port's api, counterpart of examples/simple_app.py: the
reference's SimpleApp (apps/render/SimpleApp.cpp) driven 1:1 through the
mirrored API surface.

    python -m gravit_tpu_torch.examples.simple_app [-image|-domain]
"""

import argparse
import math

import numpy as np

from gravit_tpu_torch import api

CONE_VERTS = [0.5, 0.0, 0.0, -0.5, 0.5, 0.0, -0.5, 0.25, 0.433013, -0.5,
              -0.25, 0.43013, -0.5, -0.5, 0.0, -0.5, -0.25, -0.433013,
              -0.5, 0.25, -0.433013]
CONE_FACES = [1, 2, 3, 1, 3, 4, 1, 4, 5, 1, 5, 6, 1, 6, 7, 1, 7, 2]
CUBE_VERTS = [-0.5, -0.5, 0.5, 0.5, -0.5, 0.5, 0.5, 0.5, 0.5, -0.5, 0.5, 0.5,
              -0.5, -0.5, -0.5, 0.5, -0.5, -0.5, 0.5, 0.5, -0.5, -0.5, 0.5,
              -0.5, 0.5, 0.5, 0.5, -0.5, 0.5, 0.5, 0.5, 0.5, -0.5, -0.5, 0.5,
              -0.5, -0.5, -0.5, 0.5, 0.5, -0.5, 0.5, -0.5, -0.5, -0.5, 0.5,
              -0.5, -0.5, 0.5, -0.5, 0.5, 0.5, 0.5, 0.5, 0.5, -0.5, -0.5,
              0.5, 0.5, -0.5, -0.5, -0.5, 0.5, -0.5, 0.5, 0.5, -0.5, -0.5,
              -0.5, -0.5, 0.5, -0.5]
CUBE_FACES = [1, 2, 3, 1, 3, 4, 17, 19, 20, 17, 20, 18, 6, 5, 8, 6, 8, 7,
              23, 21, 22, 23, 22, 24, 10, 9, 11, 10, 11, 12, 13, 15, 16,
              13, 16, 14]


def build_scene(schedule: int, wsize=(512, 512), output="simple",
                mesh=None, device=None):
    """The SimpleApp scene in the api's database: a 5 x 5 grid of cones and
    cubes, one point light, the camera and film, a renderer named
    "Enzoschedule" with `schedule`. `mesh` / `device` go to gvtInit."""
    api.gvtInit(mesh=mesh, device=device)
    kd = [1.0, 1.0, 1.0]
    api.createMesh("conemesh")
    api.addMeshVertices("conemesh", len(CONE_VERTS) // 3, CONE_VERTS)
    api.addMeshTriangles("conemesh", len(CONE_FACES) // 3, CONE_FACES)
    api.addMeshMaterial("conemesh", 0, kd, 1.0)
    api.finishMesh("conemesh")

    api.createMesh("cubemesh")
    api.addMeshVertices("cubemesh", len(CUBE_VERTS) // 3, CUBE_VERTS)
    api.addMeshTriangles("cubemesh", len(CUBE_FACES) // 3, CUBE_FACES)
    api.addMeshMaterial("cubemesh", 0, kd, 1.0)
    api.finishMesh("cubemesh")
    api.gvtsync()

    inst_id = 0
    for i in range(-2, 3):
        for j in range(-2, 3):
            # glm::scale(glm::translate(I, t), s), flattened column-major
            m = np.eye(4, dtype=np.float32)
            m[:3, :3] *= 0.4
            m[:3, 3] = (0.0, i * 0.5, j * 0.5)
            meshname = "cubemesh" if inst_id % 2 else "conemesh"
            api.addInstance(f"inst{inst_id}", meshname, m.T.flatten())
            inst_id += 1
    api.gvtsync()

    api.addPointLight("conelight", [1.0, 0.0, -1.0], [1.0, 1.0, 1.0])
    api.addCamera("conecam", [4.0, 0.0, 0.0], [0.0, 0.0, 0.0],
                  [0.0, 1.0, 0.0], 45.0 * math.pi / 180.0, 1, 1, 0.5)
    api.addFilm("conefilm", wsize[0], wsize[1], output)
    api.addRenderer("Enzoschedule", int(api.Adapter.Embree), schedule,
                    "conecam", "conefilm")
    api.gvtsync()


def main():
    p = argparse.ArgumentParser()
    p.add_argument("-image", action="store_true")
    p.add_argument("-domain", action="store_true")
    p.add_argument("-wsize", type=int, nargs=2, default=[512, 512])
    p.add_argument("-output", default="simple")
    p.add_argument("-device", default=None, help="default: the card")
    args = p.parse_args()
    schedule = api.Schedule.Domain if args.domain else api.Schedule.Image
    build_scene(int(schedule), tuple(args.wsize), args.output,
                device=args.device)
    api.render("Enzoschedule")
    api.writeimage("Enzoschedule", args.output)


if __name__ == "__main__":
    main()
