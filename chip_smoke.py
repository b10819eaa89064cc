"""Drive gravit_tpu_torch's main path on one NVIDIA GPU and hold its kernel
against the plain PyTorch version.

    python3 chip_smoke.py

Phases (one JSON line each; any failure exits nonzero):
  1 environment  torch / CUDA versions, the card's name and power limit
  2 build        nvcc builds every kernel from csrc/ (seconds, ptxas report)
  3 K1           closest-hit traversal vs the plain version on the first
                 generation's object-space wavefront of the 512^2 frame
  4 K2           any-hit traversal vs the plain version on the depth-1
                 shadow-spawn matrix
  5 K3           a triangle table over 6 MB (the TPU kernel's HBM variant)
  6 frames       render_surface at depth 1 and 2 on the card, launch counts,
                 each frame against its impl="plain" twin
  7 golden       64^2 frames against the JAX package's committed frames
  8 times        CUDA-event times of every launch of the depth-1 and
                 depth-2 frames and of the K3 subset (with bounds), of the
                 plain version, and of the frames
then the kernels line and, last, the device line.

The scene is the flagship bench configuration (bench_inner.py --fast) with
a procedural stand-in for the bunny: `make_scene(seed)` below, a seeded,
radially displaced UV sphere of 187 x 187 bands (69,938 triangles) over a
floor quad, made anew from the seed on every run.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from gravit_tpu_torch.accel.scene_accel import build_scene_bvh  # noqa: E402
from gravit_tpu_torch.ops import _build  # noqa: E402
from gravit_tpu_torch.ops import bvh_traverse as bt  # noqa: E402
from gravit_tpu_torch.render.renderer import render_surface  # noqa: E402
from gravit_tpu_torch.render.scene_build import Instance, build_scene  # noqa: E402
from gravit_tpu_torch.render.tracer import trace_image_fast  # noqa: E402
from gravit_tpu_torch.scene import image as img  # noqa: E402
from gravit_tpu_torch.scene.camera import PerspectiveCamera  # noqa: E402
from gravit_tpu_torch.scene.light import point_light  # noqa: E402
from gravit_tpu_torch.scene.material import Material  # noqa: E402
from gravit_tpu_torch.scene.mesh import Mesh  # noqa: E402

GOLDEN = ROOT / "tests" / "data" / "torch_port_golden.npz"
FLAGSHIP_BANDS = 187          # 187 x 187 x 2 = 69,938 sphere triangles
K3_BANDS = 270                # 145,800 triangles: a 7 MB triangle table
TPU_VMEM_TABLE_BYTES = 6 * 2**20   # above it the TPU kernel's table is in HBM
SPHERE_RADIUS = 0.075
SPHERE_CENTER = (0.0, 0.11, 0.0)


@dataclasses.dataclass
class SceneSpec:
    meshes: list
    instances: list
    lights: list
    camera: PerspectiveCamera


def make_scene(seed: int = 0, bands: int = FLAGSHIP_BANDS, width: int = 512,
               height: int = 512, max_depth: int = 1) -> SceneSpec:
    """The flagship configuration (bench_inner.py:51-66) with a procedural
    mesh: a UV sphere of `bands` latitude bands x `bands` longitudes
    (2*bands^2 triangles, poles left open), radially displaced by six
    seeded low-order waves, plus a floor quad under it in the same mesh so
    that bounces hit something. Default lambert material, one instance
    with the identity transform, one point light."""
    rng = np.random.default_rng(seed)
    nlat, nlon = bands + 1, bands
    theta = np.pi * (np.arange(nlat) + 0.5) / nlat
    phi = 2.0 * np.pi * np.arange(nlon) / nlon
    th, ph = np.meshgrid(theta, phi, indexing="ij")
    disp = np.zeros_like(th)
    for _ in range(6):
        amp = rng.uniform(0.005, 0.025)
        fa, fb = rng.integers(1, 7, size=2)
        pa, pb = rng.uniform(0.0, 2.0 * np.pi, size=2)
        disp += amp * np.sin(fa * th + pa) * np.cos(fb * ph + pb)
    r = SPHERE_RADIUS * (1.0 + disp)
    verts = np.stack([r * np.sin(th) * np.cos(ph), r * np.cos(th),
                      r * np.sin(th) * np.sin(ph)], axis=-1).reshape(-1, 3)
    verts = (verts + np.asarray(SPHERE_CENTER)).astype(np.float32)

    i, j = np.meshgrid(np.arange(bands), np.arange(nlon), indexing="ij")
    a = i * nlon + j
    b = i * nlon + (j + 1) % nlon
    c = (i + 1) * nlon + j
    d = (i + 1) * nlon + (j + 1) % nlon
    # counter-clockwise seen from outside: cross(e1, e2) points outward
    faces = np.concatenate([np.stack([a, b, c], -1).reshape(-1, 3),
                            np.stack([b, d, c], -1).reshape(-1, 3)])

    floor_y = SPHERE_CENTER[1] - 1.2 * SPHERE_RADIUS
    floor = np.asarray([[-0.6, floor_y, -0.8], [0.6, floor_y, -0.8],
                        [0.6, floor_y, 0.25], [-0.6, floor_y, 0.25]],
                       np.float32)
    nv = verts.shape[0]
    faces = np.concatenate([faces, nv + np.asarray([[0, 3, 2], [0, 2, 1]])])

    mesh = Mesh()
    mesh.add_vertices(np.concatenate([verts, floor]))
    mesh.add_faces(faces + 1)
    mesh.material = Material()
    camera = PerspectiveCamera(
        eye=(0.0, 0.1, 0.3), focus=(0.0, 0.1, -0.3), up=(0.0, 1.0, 0.0),
        fov=float(45.0 * np.pi / 180.0), film_width=width,
        film_height=height, samples=1, max_depth=max_depth,
        jitter_window=0.0)
    return SceneSpec(
        meshes=[mesh.finish()],
        instances=[Instance(mesh_id=0, m=np.eye(4, dtype=np.float32))],
        lights=[point_light((0.0, 0.1, 0.5), (1.0, 1.0, 1.0))],
        camera=camera)


# ---------------------------------------------------------------------------
# measurement helpers

# fp32 operations per lane: a node's slab test (3 axes x [2 sub, 2 mul,
# min, max, max, min] + 4 compares) and one Möller-Trumbore row (cross,
# det, 1/det, tvec, u, q, v, t and the acceptance compares), counted from
# csrc/bvh_traverse.cu
NODE_FLOPS = 28
TRI_FLOPS = 51
PEAK_FP32 = 67e12             # H100 SXM, fp32 outside the tensor cores
PEAK_BYTES = 3.35e12          # H100 SXM HBM3
# tests/test_torch_tracer.py's tolerances against the JAX package
GOLDEN_TOL = {1: dict(byte_frac=0.0, float_max=1e-5),
              2: dict(byte_frac=5e-3, float_mean=1e-4)}


def log(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def card_identity() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of fn() in ms, by CUDA events around `reps` runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def capture_launches(fn) -> list:
    """Run fn() and return a copy of the inputs of every traversal-kernel
    launch it made (the shapes the main path gives the kernel)."""
    seen = []
    orig = bt.bvh_intersect_kernel

    def record(*args):
        seen.append(tuple(a.clone() if torch.is_tensor(a) else a
                          for a in args))
        return orig(*args)

    bt.bvh_intersect_kernel = record
    try:
        fn()
    finally:
        bt.bvh_intersect_kernel = orig
    torch.cuda.synchronize()
    return seen


def bound_ms(args, res) -> tuple:
    """Least time the card could take for this launch's work: the larger
    of its fp32 operations over the fp32 peak and its bytes (rays in, hits
    out, tables once) over the memory rate."""
    o, d, valid, block_root, bounds, meta, tri, t_far = args[:8]
    flops = (NODE_FLOPS * int(res.node_visits.sum())
             + TRI_FLOPS * int(res.tri_rows.sum())) * 1024
    n = o.shape[0]
    nbytes = (sum(x.numel() * x.element_size() for x in
                  (o, d, valid, block_root, bounds, meta, tri, t_far))
              + n * 16)
    t_ops, t_bytes = flops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes", flops, nbytes)


def hold_traversal(args, name: str) -> dict:
    """Kernel vs plain version on the same inputs. Closest hit: prim must
    be identical apart from equal-t ties, and t/u/v bit-equal where prim
    agrees (both compute the same IEEE operations in the same order).
    Any hit: the occluded flags (prim >= 0) must be identical."""
    any_hit = args[8]
    k = bt.bvh_intersect_kernel(*args)
    torch.cuda.synchronize()
    t0 = time.time()
    p = bt.bvh_intersect_plain(*args)
    torch.cuda.synchronize()
    plain_s = time.time() - t0
    live = args[2] != 0
    if any_hit:
        diff = ((k.prim >= 0) != (p.prim >= 0)) & live
        err = float(diff.any())
        ok = not bool(diff.any())
        extra = dict(occluded=int(((k.prim >= 0) & live).sum()),
                     flag_mismatches=int(diff.sum()))
    else:
        same = k.prim == p.prim
        mism = ~same & live
        ties = mism & (k.t == p.t)
        err = max(float((k.t - p.t)[same].abs().max()),
                  float((k.u - p.u)[same].abs().max()),
                  float((k.v - p.v)[same].abs().max()))
        ok = not bool((mism & ~ties).any()) and err == 0.0
        extra = dict(hits=int(((k.prim >= 0) & live).sum()),
                     tie_lanes=int(ties.sum()),
                     non_tie_mismatches=int((mism & ~ties).sum()))
    rec = dict(kernel=name, rays=int(args[0].shape[0]),
               blocks=int(args[3].numel()),
               live_blocks=int((args[3] >= 0).sum()),
               node_visits=[int(k.node_visits.sum()),
                            int(p.node_visits.sum())],
               tri_rows=[int(k.tri_rows.sum()), int(p.tri_rows.sum())],
               max_abs_err=err, plain_s=plain_s, ok=ok, **extra)
    log("hold_" + name, **rec)
    if not ok:
        raise SystemExit(f"{name}: kernel disagrees with the plain version")
    return rec


def compare_frames(a: torch.Tensor, b: torch.Tensor, w: int, h: int) -> dict:
    a, b = a.detach().cpu().numpy(), b.detach().cpu().numpy()
    ba, bb = img.to_rgb8(a, w, h), img.to_rgb8(b, w, h)
    d = np.abs(a[:, :3] - b[:, :3])
    return dict(byte_frac=float(np.mean(ba != bb)),
                byte_max=int(np.abs(ba.astype(int) - bb).max()),
                float_max=float(d.max()), float_mean=float(d.mean()),
                finite=bool(np.isfinite(a).all()),
                coverage=float(np.mean(a[:, :3].sum(axis=1) > 0)))


# ---------------------------------------------------------------------------


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    t_start = time.time()
    dev = torch.device("cuda")
    card = card_identity()
    kind = torch.cuda.get_device_name(0)
    print(card, flush=True)
    log("environment", torch=torch.__version__, cuda=torch.version.cuda,
        python=sys.version.split()[0], card=card, kind=kind,
        count=torch.cuda.device_count())

    # ---- 2: build every kernel from the sources -------------------------
    t0 = time.time()
    reports = _build.build_all()
    log("build", seconds=time.time() - t0,
        ptxas={k: [ln.strip() for ln in v.splitlines()
                   if "registers" in ln or "spill" in ln]
               for k, v in reports.items()})

    # ---- the flagship scene, and the kernel inputs its frame produces ---
    t0 = time.time()
    spec = make_scene(0)
    scene = build_scene(spec.meshes, spec.instances, spec.lights, device=dev)
    accel = build_scene_bvh(spec.meshes, device=dev)
    W, H = spec.camera.film_width, spec.camera.film_height
    # the rays' depth field carries the bounce budget: one wavefront per depth
    rays = {d: dataclasses.replace(spec.camera, max_depth=d).generate_rays(dev)
            for d in (1, 2)}
    log("scene", triangles=scene.num_triangles,
        nodes=int(accel.bounds.shape[0]),
        tri_table_mb=accel.tri.numel() * 4 / 2**20, film=[W, H],
        setup_s=time.time() - t0)
    cap = {d: capture_launches(lambda: trace_image_fast(
        scene, rays[d], W, H, accel=accel, max_depth=d)) for d in (1, 2)}
    k1_args = next(a for a in cap[1] if not a[8])
    k2_args = next(a for a in cap[1] if a[8])

    # ---- 3, 4: K1 and K2 against the plain version -----------------------
    k1 = hold_traversal(k1_args, "K1")
    k2 = hold_traversal(k2_args, "K2")
    # the depth-2 spawn matrix holds occluded rays (floor points in the
    # sphere's shadow, reached by bounces); the depth-1 one hardly any
    k1g1_args = [a for a in cap[2] if not a[8]][1]
    k2d2_args = next(a for a in cap[2] if a[8])
    hold_traversal(k2d2_args, "K2_depth2")
    del cap

    # ---- 5: K3, a triangle table over 6 MB (subset of blocks) -----------
    big = make_scene(1, bands=K3_BANDS)
    big_scene = build_scene(big.meshes, big.instances, big.lights, device=dev)
    big_accel = build_scene_bvh(big.meshes, device=dev)
    cap3 = capture_launches(lambda: trace_image_fast(
        big_scene, big.camera.generate_rays(dev), W, H, accel=big_accel,
        max_depth=1))
    a3 = next(a for a in cap3 if not a[8])
    nb = a3[3].numel()
    lo = max(0, nb // 2 - 32)
    blocks = torch.arange(lo, min(nb, lo + 64), device=dev)  # central 64
    lanes = (blocks[:, None] * bt.PACKET
             + torch.arange(bt.PACKET, device=dev)).reshape(-1)
    k3_args = (a3[0][lanes].contiguous(), a3[1][lanes].contiguous(),
               a3[2][lanes].contiguous(), a3[3][blocks].contiguous(),
               a3[4], a3[5], a3[6], a3[7][lanes].contiguous(), False)
    log("K3_table", triangles=big_scene.num_triangles,
        tri_table_mb=big_accel.tri.numel() * 4 / 2**20,
        over_6mb=big_accel.tri.numel() * 4 > TPU_VMEM_TABLE_BYTES,
        subset_blocks=[int(blocks[0]), int(blocks[-1]) + 1])
    if big_accel.tri.numel() * 4 <= TPU_VMEM_TABLE_BYTES:
        raise SystemExit("K3: the triangle table is not over 6 MB")
    hold_traversal(k3_args, "K3")
    del big_scene, big_accel, cap3, a3, lanes

    # ---- 6: the main path, through the user's entry point ---------------
    main_counts = {"closest": 0, "any_hit": 0}
    frames = {}
    for depth in (1, 2):
        cam = dataclasses.replace(spec.camera, max_depth=depth)
        bt.reset_launch_counts()
        fb = render_surface(spec.meshes, spec.instances, spec.lights, cam,
                            device="cuda")
        torch.cuda.synchronize()
        counts = {"closest": bt.launches_closest,
                  "any_hit": bt.launches_any_hit}
        for k in counts:
            main_counts[k] += counts[k]
        expect = {"closest": depth, "any_hit": 1}
        fb_plain = render_surface(spec.meshes, spec.instances, spec.lights,
                                  cam, device="cuda", impl="plain")
        cmp = compare_frames(fb, fb_plain, W, H)
        ok = (counts == expect and cmp["finite"] and cmp["coverage"] > 0.3
              and cmp["byte_frac"] <= 1e-4)
        frames[depth] = fb
        log("frame", depth=depth, launches=counts, expected=expect,
            vs_plain=cmp, tolerance=dict(byte_frac=1e-4), ok=ok)
        if not ok:
            raise SystemExit(f"frame depth {depth} failed")

    # ---- 7: against the JAX package's committed frames ------------------
    gold = np.load(GOLDEN)
    gw, gh = int(gold["width"]), int(gold["height"])
    gspec = make_scene(int(gold["seed"]), bands=int(gold["bands"]),
                       width=gw, height=gh)
    for depth in (1, 2):
        cam = dataclasses.replace(gspec.camera, max_depth=depth)
        fb = render_surface(gspec.meshes, gspec.instances, gspec.lights, cam,
                            device="cuda")
        ref = torch.from_numpy(gold[f"fb_depth{depth}"])
        cmp = compare_frames(fb, ref, gw, gh)
        tol = GOLDEN_TOL[depth]
        ok = all(cmp[k] <= v for k, v in tol.items()) and cmp["finite"]
        log("golden", depth=depth, film=[gw, gh], bands=int(gold["bands"]),
            vs_jax=cmp, tolerance=tol, ok=ok)
        if not ok:
            raise SystemExit(f"golden depth {depth} failed")

    # ---- 8: times (CUDA events, after warm-up) --------------------------
    # every launch of the depth-1 and depth-2 frames (and the K3 subset),
    # timed alone at its own inputs, with its bound from this run's visit
    # counts
    launch = {}
    for name, args in (("K1_gen0", k1_args), ("K1_gen1", k1g1_args),
                       ("K2_depth1", k2_args), ("K2_depth2", k2d2_args),
                       ("K3_subset", k3_args)):
        res = bt.bvh_intersect_kernel(*args)
        ms = cuda_ms(lambda: bt.bvh_intersect_kernel(*args), reps=20)
        b_ms, b_by, flops, nbytes = bound_ms(args, res)
        launch[name] = dict(
            ms=ms, bound_ms=b_ms, bound_by=b_by, share_of_bound=b_ms / ms,
            flops=flops, bytes=nbytes, rays=int(args[0].shape[0]),
            live_blocks=int((args[3] >= 0).sum()),
            node_visits=int(res.node_visits.sum()),
            tri_rows=int(res.tri_rows.sum()))
        log("time_launch", launch=name, card=card, **launch[name])
    plain_ms = {name: cuda_ms(lambda: bt.bvh_intersect_plain(*args), reps=1,
                              warmup=0)
                for name, args in (("K1_gen0", k1_args),
                                   ("K2_depth1", k2_args),
                                   ("K3_subset", k3_args))}
    log("time_plain", card=card, **plain_ms)
    # a frame's device time against its launches (the rest is PyTorch glue
    # and any wait on the host); host_ms is the wall clock per frame
    in_frame = {1: ("K1_gen0", "K2_depth1"),
                2: ("K1_gen0", "K1_gen1", "K2_depth2")}
    for depth in (1, 2):
        ms = cuda_ms(lambda: trace_image_fast(scene, rays[depth], W, H,
                                              accel=accel, max_depth=depth),
                     reps=10)
        t0 = time.perf_counter()
        for _ in range(5):
            trace_image_fast(scene, rays[depth], W, H, accel=accel,
                             max_depth=depth)
        torch.cuda.synchronize()
        kernel_ms = sum(launch[k]["ms"] for k in in_frame[depth])
        log("time_frame", depth=depth, card=card, ms=ms,
            host_ms=(time.perf_counter() - t0) * 1e3 / 5,
            kernel_ms=kernel_ms, kernel_share=kernel_ms / ms,
            rays_per_s=W * H / ms * 1e3)
    kernel_rows = [dict(
        name=name, route="cuda", source="gravit_tpu_torch/csrc/bvh_traverse.cu",
        replaces="gravit_tpu/ops/pallas_bvh.py:35", launches=launches,
        max_abs_err=rec["max_abs_err"], ms=launch[key]["ms"],
        plain_ms=plain_ms[key], bound_ms=launch[key]["bound_ms"],
        bound_by=launch[key]["bound_by"], library_ms=None)
        for name, key, rec, launches in (
            ("bvh_traverse (closest hit, K1)", "K1_gen0", k1,
             main_counts["closest"]),
            ("bvh_traverse (any hit, K2)", "K2_depth1", k2,
             main_counts["any_hit"]))]
    log("done", seconds=time.time() - t_start)

    print(json.dumps({"kernels": kernel_rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
