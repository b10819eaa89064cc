"""gvtVol on the port's api, counterpart of examples/vol_app.py: the
reference VolApp (apps/render/VolApp.cpp): BOV volume bricks, transfer
functions, domain scheduling.

    python -m gravit_tpu_torch.examples.vol_app -volfile data.bov \
        -ctffile Grayscale.cmap -otffile Grayscale.omap -wsize 512 512 \
        [-domain]
Without -volfile it renders the procedural wavelet volume.
"""

import argparse
import math

import numpy as np

from gravit_tpu_torch import api
from gravit_tpu_torch.scene.readers.bov import read_bov
from gravit_tpu_torch.scene.transfer import TransferFunction
from gravit_tpu_torch.scene.volume import wavelet_volume


def load_bricks(volfile: str = "", ctffile: str = "", otffile: str = "",
                samplingrate: float = 1.0) -> list:
    """The BOV file's bricks (with the colour / opacity maps when both are
    given), or the 64^3 wavelet volume without a file."""
    if not volfile:
        return [wavelet_volume(64, sampling_rate=samplingrate)]
    tf = None
    if ctffile and otffile:
        # VolApp passes low=0 high=65536 (VolApp.cpp:127)
        tf = TransferFunction.from_files(ctffile, otffile, 0.0, 65536.0)
    return read_bov(volfile, tf=tf, sampling_rate=samplingrate)


def build_scene(bricks: list, schedule: int, wsize=(512, 512), eye=None,
                look=None, output="vol", mesh=None, device=None) -> None:
    """One volume and one identity instance per brick, the camera fitted
    to their union, and a volume renderer named "vr" with `schedule`."""
    api.gvtInit(mesh=mesh, device=device)
    lo = np.min([b.bounds_min for b in bricks], axis=0)
    hi = np.max([b.bounds_max for b in bricks], axis=0)
    center = (lo + hi) / 2.0
    db = api._db()
    for i, b in enumerate(bricks):
        name = f"vol{i}"
        api.createVolume(name)
        db.find(name)["tf"] = b.tf
        flat = b.samples.reshape(-1)  # z-major view == x-fastest flat
        api.addVolumeSamples(name, flat, list(b.counts), list(b.origin),
                             list(b.spacing), b.sampling_rate)
        api.addInstance(f"inst{i}", name,
                        np.eye(4, dtype=np.float32).flatten())
    eye = eye or (center + (hi - lo) * 4.0).tolist()
    look = look or center.tolist()
    api.addCamera("cam", eye, look, [0.0, 0.0, 1.0],
                  30.0 * math.pi / 180.0, 1, 1, 0.5)
    api.addFilm("film", wsize[0], wsize[1], output)
    api.addRenderer("vr", int(api.Adapter.Pvol), schedule, "cam", "film",
                    volume=True)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("-volfile", default="")
    p.add_argument("-ctffile", default="")
    p.add_argument("-otffile", default="")
    p.add_argument("-image", action="store_true")
    p.add_argument("-domain", action="store_true")
    p.add_argument("-wsize", type=int, nargs=2, default=[512, 512])
    p.add_argument("-eye", type=float, nargs=3, default=None)
    p.add_argument("-look", type=float, nargs=3, default=None)
    p.add_argument("-samplingrate", type=float, default=1.0)
    p.add_argument("-output", default="vol")
    p.add_argument("-device", default=None, help="default: the card")
    args = p.parse_args()
    bricks = load_bricks(args.volfile, args.ctffile, args.otffile,
                         args.samplingrate)
    sched = api.Schedule.Domain if args.domain else api.Schedule.Image
    build_scene(bricks, int(sched), tuple(args.wsize), args.eye, args.look,
                args.output, device=args.device)
    api.render("vr")
    api.writeimage("vr", args.output)
    print(f"wrote {args.output}.ppm ({len(bricks)} brick(s))")


if __name__ == "__main__":
    main()
