"""Drive gravit_tpu_torch's main path on one NVIDIA GPU and hold its kernel
against the plain PyTorch version.

    python3 chip_smoke.py

Phases (one JSON line each; any failure exits nonzero). The surface path:
  1 environment  torch / CUDA versions, the card's name and power limit
  2 build        nvcc builds every kernel from csrc/, all sources at once
                 (seconds, ptxas report)
  3 K1           closest-hit traversal (a vote per warp) vs the plain
                 version with the packet-wide vote, and vs the plain version
                 at the kernel's own group width (counts equal too), on the
                 object-space wavefronts of the 512^2 frame: the camera
                 rays, and the bounced rays of the depth-2 frame
  4 K2           any-hit traversal vs the plain versions on the shadow-spawn
                 matrices of the depth-1 and the depth-2 frame
  5 K3           a triangle table over 6 MB (the TPU kernel's HBM variant),
                 and one frame over it through render_surface
  6 frames       render_surface at depth 1 and 2 on the card, launch counts,
                 each frame against its impl="plain" twin
  7 golden       64^2 frames against the JAX package's committed frames
  8 times        CUDA-event times of every launch of the depth-1 and
                 depth-2 frames and of the K3 subset, each with its bound
                 (from the work the rays need on their own; the packet-wide
                 walk's work beside it) and its shape (visits per voting
                 group, blocks per SM, waves, the longest walk by the
                 kernel's own clock), of the plain version, and of the
                 frames (eager, the host's enqueue time and launch counts,
                 and replayed from a CUDA graph)
The multi-instance and looped surface tracers (scenes: `simple_app`, the
reference's gvtSimple, 25 instances of a cone and a cube; and
`make_multi_scene`, 80 instances of 10 displaced spheres, which turns on
the instance tree and the segment-aligned pack):
  hold_K1_multi / hold_K2_multi  K1 and K2 on launches of the slice C
                 frames (blocks of 10 meshes side by side in the pack, the
                 looped tracer's mixed pack, SimpleApp's in-place passes)
                 against both plain versions, as phases 3-4
  frame_multi    fast-multi and the looped tracer at 512^2 through the
                 entry points: launch counts against the formula from the
                 rounds the frame ran, the launches with no live block,
                 host syncs, the frame against its impl="plain" twin
                 (SimpleApp at 512^2, the many-domain scene at 128^2);
                 SimpleApp fast-multi against looped (bit-equal)
  golden_multi   64^2 frames against the JAX package's committed frames
                 (SimpleApp at depth 1 and 2, the area-light cube row, the
                 many-domain scene)
  time_launch / launch_shape / time_frame  for those launches and frames
The closest-instance search (csrc/instance_slab.cu, after slice C):
  hold_instance_slab  the kernel against its plain version, lane for lane
                 (found, index and t_entry bits), on every search of
                 SimpleApp's fast-multi frame (the full film and the
                 compacted tails), of the train cell's looped forward (the
                 2 x 1.25 arena, 655,360 lanes), of a gvt_vol frame (eight
                 bricks of 257^3) and at ragged widths as column slices of
                 a wider table; `_grad`: where autograd records, t_entry
                 recomputed from the winner's box, bit-equal
  frame_instance_slab  SimpleApp fast-multi and looped, and the gvt_vol
                 frame, bit-equal to the same frame with every search on
                 the plain version, one launch a search; the host's ms in
                 the instance search (split_frame) with the kernel and
                 with the plain version
  time_instance_slab  a launch's CUDA-event and graph-replay ms at the full
                 film and the train arena, against its byte bound
                 (41 B a lane / 3.35 TB/s), and the plain version's ms
The volume path (scenes: `make_volume_scene`, the volume bench configuration
of bench_inner.py:208-229 on the procedural wavelet brick):
  hold_K4 x4     the whole-brick slice kernel vs its plain version on the
                 arguments trace_volume_fast gives it for the 64^3 brick at
                 512^2: plain, isosurface, AMR subgrid, slice plane
                 and the three together; six subgrids in one launch; every
                 launch of the wavefront frame. Each hold also prints the
                 kernel's schedule counts (busy blocks, batches read
                 through L1, largest box) beside slice_schedule_plain's,
                 which must be equal
  hold_K5        the z-window kernel vs its plain version on the 256^3
                 brick (64 MiB, 17 windows), and vs K4 on the same brick
  frame_volume   render_volume on the card for those five, launch counts,
                 each frame against its impl="plain" twin
  frame_wavefront  two 96x96x49 bricks through the wavefront tracer (K4
                 under march_round), vs its plain twin and vs the gather
                 march
  golden_volume  64^2 frames against the JAX package's committed frames
  slice_occupancy  registers, shared memory, blocks per SM of K4 and K5
  time_launch / time_frame  CUDA-event and host times with bounds; a
                 slice launch with its wrapper's time, blocks, busy blocks
                 and waves, and its shape (slice_launch_shape: each block's
                 span on the card's clock, the longest block against the
                 launch)
F1 and the native builder (after phase 4):
  hold_K1_vertices  K1 and K2 on the camera wavefront with every 5th ray
                 aimed exactly at a mesh vertex or the floor's rim, lane by
                 lane against the packet-wide plain version (lost, swapped,
                 gained and other lanes; lost and other must be 0, swapped
                 and gained at most VERTEX_LIMITS), and bit-equal to the
                 plain version at the kernel's group width
  native         the native BVH builder must load; flagship build time,
                 native and numpy; the default frame byte-equal to one
                 over a tree from the native build's arrays; ties moved
                 against the numpy builder's leaf order
The schedulers (slice D; the many-domain scene at 512^2):
  hold_K1_sched / hold_K2_sched  K1 and K2 on launches of the
                 streamed renderer's rounds (its first group; the group
                 whose padded mesh slots have root -1) and of a domain
                 member's round after the first exchange, against both
                 plain versions, as phases 3-4
  sched_image    trace_image_sharded with the accel over a LocalGroup(4)
                 on the card (point light only, depth 1) against the
                 all-resident looped frame (<= 1e-5; the share of pixels
                 bit-equal)
  sched_streamed StreamedImageRenderer with the accel under a 24,576-
                 triangle budget: bit-equal to the all-resident frame;
                 rounds, group copies, bytes copied to the card
  sched_domain   DomainRenderer over a LocalGroup(4) at depth 1 and 2
                 (both lights) against the all-resident frame (<= 1e-5),
                 drops 0; per member triangles held and rays traced; per
                 frame rounds, exchanges taken and skipped, peak demand,
                 host syncs, ms; and at world size 1 on a one-rank NCCL
                 DistGroup, bit-equal to LocalGroup(1) (no member has a
                 migrant there, so the frame runs no all_to_all: the
                 group's all_to_all is called once on a (1, C) arena,
                 every field, and must return its input)
  Each of these frames is driven with the launch counts at 0 just before
  it and read just after; K1 and K2 must both have launched.
Slice D part 2 and the facade (the normal entry points: `api.*`,
`Renderer.render`, `writeimage`), all at 512^2 with CUDA-event and host
times, launch counts and host syncs:
  facade_flagship  make_scene(0) built through the api (createMesh ...
                 addRenderer with the Image schedule) at depth 1 and 2:
                 bit-equal to render_surface's frame, K1/K2 at {depth, 1},
                 the written PPM equal to to_rgb8 of the frame
  facade_simple_domain  SimpleApp through the api's Domain schedule over a
                 LocalGroup(4), <= 1e-5 of the Image schedule's frame
  sched_hybrid   the many-domain scene at depth 2 over a LocalGroup(4)
                 with the accel, every domain on member 0: render, then
                 render_hybrid (chunks of 2, tau 1.5, RayWeightedSpread):
                 remaps >= 1, the hot member's load >= 1.5x lower, the
                 frame <= 1e-5 of the static one; K1 and K2 held (as
                 phases 3-4) on the first live launch of a member round
                 after the first remap (a member with padded mesh slots
                 where the placement makes one)
  sched_volume_domain  trace_volume_domain with the stacked scene's slice
                 axes: (i) wavelet_volume(64) in 2 x-bricks over a
                 LocalGroup(2) (K4), (ii) wavelet_volume(256) in 4 x-bricks
                 of 256x256x65 (over 4 MiB: K5) over a LocalGroup(4); each
                 <= 1e-5 of the single-device trace_volume, <= 1e-4 of
                 bytes off its impl="plain" twin, drops 0; the first K4 /
                 K5 launch of a member round after an exchange held (as
                 hold_K4); the kernel each member launched
  facade_volume_domain  (ii) through the api's Domain schedule over a
                 LocalGroup(4): bit-equal to sched_volume_domain's frame
Slice E: training, checkpointing and the dry run (SimpleApp and V64 at
512^2; no TPU kernel lies on the training path, so each of these phases
also checks that the ports of the TPU kernels were launched no time; the
instance search's kernel, which ports none, runs in the forward):
  train_simple   train.loss_fn's gradient (4 rounds, brute intersection)
                 on the card against the same on the CPU; the directional
                 finite difference along kd; the default train step's
                 CUDA-event ms split into forward, backward and optimiser,
                 its peak memory, host syncs, operators and launches; 25
                 Adam steps at lr 5e-2 from light_color x 0.3 bring the
                 loss below 0.66 x its start
  train_sharded  make_sharded_train_step over a LocalGroup(4): the
                 single-device loss, the gradient within SHARD_TOL of it
                 (not 4 x it); a one-rank NCCL DistGroup step bit-equal to
                 LocalGroup(1)'s under torch's deterministic algorithms
  checkpoint     save from card tensors, restore onto the card; the resumed
                 step bit-equal to the uninterrupted one
  train_volume   V64: the samples' gradient through trace_volume(unroll=
                 True, max_rounds=4), the samples' and the colour LUT's
                 through slice_march_reference, against central differences
  dryrun         gravit_tpu_torch.dryrun.dryrun_multichip(4) on the card:
                 the accel and replica-routed frames within 1e-5 of the
                 brute one, the sums within 1e-5 relative of the JAX dry
                 run's (golden), a live K1 and K2 launch of an accel
                 member's round held against the plain versions; its K1/K2
                 launches and the holds' errors join the kernels line
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
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from gravit_tpu_torch import api  # noqa: E402
from gravit_tpu_torch import dryrun  # noqa: E402
from gravit_tpu_torch.dryrun import bricked_wavelet  # noqa: E402
from gravit_tpu_torch import native as native_lib  # noqa: E402
from gravit_tpu_torch import parallel  # noqa: E402
from gravit_tpu_torch.accel.bvh import LEAF_PAD_ROWS, build_bvh  # noqa: E402
from gravit_tpu_torch.accel.scene_accel import SceneBVH, build_scene_bvh  # noqa: E402
from gravit_tpu_torch.core.math3d import mat4_translate_scale  # noqa: E402
from gravit_tpu_torch.ops import _build  # noqa: E402
from gravit_tpu_torch.ops import bvh_traverse as bt  # noqa: E402
from gravit_tpu_torch.ops import instance_slab as slab  # noqa: E402
from gravit_tpu_torch.ops import slice_march as sm  # noqa: E402
from gravit_tpu_torch.render import checkpoint, train  # noqa: E402
from gravit_tpu_torch.render import tracer as tr  # noqa: E402
from gravit_tpu_torch.render import volume_tracer as vt  # noqa: E402
from gravit_tpu_torch.examples import simple_app as api_simple_app  # noqa: E402,E501
from gravit_tpu_torch.examples.simple_app import (CONE_FACES,  # noqa: E402
                                               CONE_VERTS, CUBE_FACES,
                                               CUBE_VERTS)
from gravit_tpu_torch.render.renderer import (Renderer,  # noqa: E402
                                              render_surface, render_volume)
from gravit_tpu_torch.render.scene_build import Instance, build_scene  # noqa: E402
from gravit_tpu_torch.render.tracer import (make_arena,  # noqa: E402
                                            trace_image, trace_image_fast,
                                            trace_image_fast_multi)
from gravit_tpu_torch.parallel import LocalGroup, Mesh as GroupMesh  # noqa: E402
from gravit_tpu_torch.render.volume_scene import build_volume_scene  # noqa: E402
from gravit_tpu_torch.schedule import domain_sched as ds  # noqa: E402
from gravit_tpu_torch.schedule import volume_domain as vd  # noqa: E402
from gravit_tpu_torch.schedule.image_sched import (  # noqa: E402
    StreamedImageRenderer, trace_image_sharded)
from gravit_tpu_torch.scene import image as img  # noqa: E402
from gravit_tpu_torch.scene.camera import PerspectiveCamera  # noqa: E402
from gravit_tpu_torch.scene.light import area_light, point_light  # noqa: E402
from gravit_tpu_torch.scene.material import Material  # noqa: E402
from gravit_tpu_torch.scene.mesh import Mesh  # noqa: E402
from gravit_tpu_torch.scene.volume import wavelet_volume  # noqa: E402

GOLDEN = ROOT / "tests" / "data" / "torch_port_golden.npz"
VOLUME_GOLDEN = ROOT / "tests" / "data" / "torch_port_volume_golden.npz"
MULTI_GOLDEN = ROOT / "tests" / "data" / "torch_port_multi_golden.npz"
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


def displaced_sphere(seed: int, bands: int):
    """(vertices, 0-based faces) of a UV sphere of `bands` latitude bands x
    `bands` longitudes (2*bands^2 triangles, poles left open) at
    SPHERE_CENTER, radially displaced by six seeded low-order waves."""
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
    return verts, faces


def compiled_mesh(verts: np.ndarray, faces: np.ndarray, kd=None):
    """A lambert mesh from vertices and 0-based faces."""
    mesh = Mesh()
    mesh.add_vertices(np.asarray(verts, np.float32))
    mesh.add_faces(np.asarray(faces) + 1)
    mesh.material = Material() if kd is None else Material(kd=kd)
    return mesh.finish()


def flagship_geometry(seed: int = 0, bands: int = FLAGSHIP_BANDS) -> tuple:
    """(vertices, 0-based faces) of make_scene's one mesh: the displaced
    sphere and a floor quad under it."""
    verts, faces = displaced_sphere(seed, bands)
    floor_y = SPHERE_CENTER[1] - 1.2 * SPHERE_RADIUS
    floor = np.asarray([[-0.6, floor_y, -0.8], [0.6, floor_y, -0.8],
                        [0.6, floor_y, 0.25], [-0.6, floor_y, 0.25]],
                       np.float32)
    nv = verts.shape[0]
    faces = np.concatenate([faces, nv + np.asarray([[0, 3, 2], [0, 2, 1]])])
    return np.concatenate([verts, floor]), faces


def make_scene(seed: int = 0, bands: int = FLAGSHIP_BANDS, width: int = 512,
               height: int = 512, max_depth: int = 1) -> SceneSpec:
    """The flagship configuration (bench_inner.py:51-66) with a procedural
    mesh: displaced_sphere(seed, bands) plus a floor quad under it in the
    same mesh so that bounces hit something. Default lambert material, one
    instance with the identity transform, one point light."""
    verts, faces = flagship_geometry(seed, bands)
    camera = PerspectiveCamera(
        eye=(0.0, 0.1, 0.3), focus=(0.0, 0.1, -0.3), up=(0.0, 1.0, 0.0),
        fov=float(45.0 * np.pi / 180.0), film_width=width,
        film_height=height, samples=1, max_depth=max_depth,
        jitter_window=0.0)
    return SceneSpec(
        meshes=[compiled_mesh(verts, faces)],
        instances=[Instance(mesh_id=0, m=np.eye(4, dtype=np.float32))],
        lights=[point_light((0.0, 0.1, 0.5), (1.0, 1.0, 1.0))],
        camera=camera)


def cone_mesh():
    return compiled_mesh(np.reshape(CONE_VERTS, (-1, 3)),
                         np.reshape(CONE_FACES, (-1, 3)) - 1,
                         kd=(1.0, 1.0, 1.0))


def cube_mesh():
    return compiled_mesh(np.reshape(CUBE_VERTS, (-1, 3)),
                         np.reshape(CUBE_FACES, (-1, 3)) - 1,
                         kd=(1.0, 1.0, 1.0))


def simple_app(width: int = 512, height: int = 512,
               max_depth: int = 1) -> SceneSpec:
    """The reference's gvtSimple (dryrun.simple_app) at 512^2 by default."""
    return SceneSpec(*dryrun.simple_app(width, height, max_depth))


def cube_row(lights: list, film: int = 32, n_cubes: int = 5,
             max_depth: int = 1) -> SceneSpec:
    """tests/test_fast_multi.py::_cube_row: cubes and cones alternating
    along z (scale 0.45, spacing 1), so the k-th instance is hit at hop
    round k; `lights` as given."""
    return SceneSpec(
        meshes=[cube_mesh(), cone_mesh()],
        instances=[Instance(k % 2, mat4_translate_scale(
            (0.0, 0.0, -2.0 + k), (0.45, 0.45, 0.45)))
            for k in range(n_cubes)],
        lights=lights,
        camera=PerspectiveCamera(
            eye=(4.5, 0.3, 0.0), focus=(0.0, 0.0, 0.0), up=(0.0, 1.0, 0.0),
            fov=float(55 * np.pi / 180), film_width=film, film_height=film,
            samples=1, max_depth=max_depth, jitter_window=0.5))


# the area-light cube row of the golden frames
CUBE_AREA_LIGHTS = [area_light((4.0, 4.0, 0.0), (1.0, 0.9, 0.8),
                               (-1.0, -1.0, 0.0), 1.5, 1.5),
                    point_light((-3.0, 2.0, 1.0), (0.3, 0.3, 0.5))]
MULTI_MESHES = 10
MULTI_GRID = (8, 10)          # rows (depth) x columns: 80 instances
MULTI_BANDS = 64              # 8,192 triangles a mesh


def make_multi_scene(seed: int = 0, width: int = 512, height: int = 512,
                     max_depth: int = 1, bands: int = MULTI_BANDS,
                     meshes: int = MULTI_MESHES,
                     grid: tuple = MULTI_GRID) -> SceneSpec:
    """The many-domain configuration: `meshes` meshes, mesh k the displaced
    sphere of make_scene(seed + k, bands) without its floor, and a rows x
    columns grid of instances on the y = 0 plane (instance k uses mesh
    k % meshes), seen at a slant so that rays cross several instance boxes.
    At the defaults: 80 instances (the instance BVH builds from 64 on) over
    10 meshes (more than INPLACE_MESH_LIMIT: the segment-aligned pack),
    81,920 triangles. One point light and one area light."""
    rows, cols = grid
    mesh_list = [compiled_mesh(*displaced_sphere(seed + k, bands))
                 for k in range(meshes)]
    instances = []
    for k in range(rows * cols):
        r, c = divmod(k, cols)
        x = (c - (cols - 1) / 2.0) * 0.2
        z = -r * 0.2
        instances.append(Instance(mesh_id=k % meshes, m=mat4_translate_scale(
            (x, -SPHERE_CENTER[1], z), (1.0, 1.0, 1.0))))
    lights = [point_light((0.6, 1.0, 0.6), (0.8, 0.8, 0.8)),
              area_light((-0.5, 0.9, -0.4), (0.6, 0.6, 0.5),
                         (0.3, -1.0, 0.2), 0.5, 0.4)]
    camera = PerspectiveCamera(
        eye=(0.0, 0.3, 0.6), focus=(0.0, -0.02, -0.7), up=(0.0, 1.0, 0.0),
        fov=float(40.0 * np.pi / 180.0), film_width=width,
        film_height=height, samples=1, max_depth=max_depth,
        jitter_window=0.0)
    return SceneSpec(meshes=mesh_list, instances=instances, lights=lights,
                     camera=camera)


@dataclasses.dataclass
class VolumeSpec:
    volumes: list
    instances: list
    camera: PerspectiveCamera


VOLUME_KINDS = ("plain", "iso", "amr", "slice", "bricks")


def make_volume_scene(kind: str, n: int = 64, width: int = 512,
                      height: int = 512,
                      eye: tuple = (4.0, 4.0, 4.0)) -> VolumeSpec:
    """The volume bench configuration (bench_inner.py:208-229): the
    procedural wavelet brick of n^3 samples, gray-ramp transfer function
    with max opacity 0.05, identity instance, camera at eye*n looking at
    the brick's centre, fov 30 degrees, up +z. `kind` adds features:
    "iso" an isosurface at the mean sample, "amr" a level-1 subgrid of
    (n/2)^3 samples at origin n/4 with spacing 0.5, "slice" the plane
    (1, 0.2, 0.1, -0.5625 n), several joined by "+"; "bricks" splits the
    brick in two along x."""
    feats = set(kind.split("+"))
    if not feats <= set(VOLUME_KINDS) or (len(feats) > 1
                                          and feats & {"plain", "bricks"}):
        raise ValueError(f"kind: {VOLUME_KINDS}, features joined by '+'; "
                         f"got {kind!r}")
    eye4 = np.eye(4, dtype=np.float32)
    if kind == "bricks":
        volumes, instances = bricked_wavelet(n), [(0, eye4), (1, eye4)]
    else:
        vol = wavelet_volume(n)
        if "iso" in feats:
            vol.isovalues = (float(vol.samples.mean()),)
        if "amr" in feats:
            sub = wavelet_volume(n // 2)
            sub.level = 1
            sub.origin = np.full(3, n / 4.0, np.float32)
            sub.spacing = np.full(3, 0.5, np.float32)
            vol.subgrids.append(sub)
        if "slice" in feats:
            vol.slices = ((1.0, 0.2, 0.1, -0.5625 * n),)
        volumes, instances = [vol], [(0, eye4)]
    c = (n - 1) / 2.0
    camera = PerspectiveCamera(
        eye=tuple(float(e) * n for e in eye), focus=(c, c, c),
        up=(0.0, 0.0, 1.0), fov=float(30.0 * np.pi / 180.0),
        film_width=width, film_height=height, samples=1, max_depth=1,
        jitter_window=0.0)
    return VolumeSpec(volumes=volumes, instances=instances, camera=camera)


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
NODE_BYTES = 48               # a node's bounds (8 f32) and meta (4 i32)
ROW_BYTES = 48                # a triangle row (12 f32)
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


def graph_ms(fn, reps: int = 20) -> tuple:
    """(ms per replay, replay == eager) of fn() captured once in a CUDA
    graph: the frame's device time when no host enqueue paces it. A
    measurement only; the port's entry points run eagerly."""
    eager = fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):       # warm-up off the default stream
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    graph.replay()
    torch.cuda.synchronize()
    return cuda_ms(graph.replay, reps=reps), bool(torch.equal(out, eager))


TRAVERSAL_KERNELS = ("packet_dpos_kernel", "bvh_traverse_kernel")


def host_counts(fn, reps: int = 2) -> dict:
    """What the host does per fn(): PyTorch operator calls and kernel
    launches, counted by torch.profiler; and what the card does: the
    device time of all kernels (`device_ms`, busy time), of the
    traversal's two kernels (`traversal_device_ms`) and of the six longest
    kernels by name ([name, ms, launches]), by CUPTI (None if the trace
    holds no device time)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    counts = {e.key: e.count for e in events}

    def device_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    kernels = [e for e in events if str(e.device_type).endswith("CUDA")]
    busy = sum(device_us(e) for e in kernels) / 1e3 / reps
    trav = sum(device_us(e) for e in kernels
               if any(k in e.key for k in TRAVERSAL_KERNELS)) / 1e3 / reps
    top = sorted(kernels, key=device_us, reverse=True)[:6]
    return dict(
        aten_ops=sum(c for k, c in counts.items()
                     if k.startswith("aten::")) / reps,
        kernel_launches=counts.get("cudaLaunchKernel", 0) / reps,
        device_ms=busy or None, traversal_device_ms=trav if busy else None,
        top_kernels=[[e.key[:60], device_us(e) / 1e3 / reps, e.count / reps]
                     for e in top])


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


def launch_bytes(args, table_reads: dict) -> int:
    """Bytes a traversal launch must move, each once: for every lane its
    t_far in (a miss keeps it) and t, prim, u, v out, and every block's
    root; in a live block (root >= 0) every lane's direction and valid
    flag (the packet's summed direction orders the walk) and each valid
    lane's origin; of the tables, the nodes the walk popped and the rows of
    the leaves it entered (`table_reads`, from hold_traversal). A block
    whose root is -1 needs nothing of the rest."""
    o, valid, block_root = args[0], args[2], args[3]
    n, nb = o.shape[0], block_root.numel()
    live = (block_root >= 0).repeat_interleave(bt.PACKET)
    origins = int((live & (valid != 0)).sum())
    return (n * 20 + nb * 4 + int(live.sum()) * 16 + origins * 12
            + table_reads["nodes"] * NODE_BYTES
            + table_reads["rows"] * ROW_BYTES)


def bound_ms(args, res, held: dict) -> dict:
    """Least time the card could take for this launch's work: the larger
    of its fp32 operations over the fp32 peak and its bytes (launch_bytes)
    over the memory rate. The operations are what the rays need on their
    own, whatever group they are walked in: a root test per live lane, two
    node tests per inner node a lane's own slab test passed, the rows of
    every leaf its own test passed (the kernel counts them).
    `packet_bound_ms` counts instead what the packet-wide walk does: every
    node and row the packet entered, times its 1024 lanes."""
    flops = (NODE_FLOPS * int(res.lane_node_tests.sum())
             + TRI_FLOPS * int(res.lane_tri_rows.sum()))
    packet_flops = (NODE_FLOPS * held["packet_walk"]["node_visits"]
                    + TRI_FLOPS * held["packet_walk"]["tri_rows"]) * bt.PACKET
    nbytes = launch_bytes(args, held["table_reads"])
    t_ops, t_bytes = flops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return dict(bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                flops=flops, bytes=nbytes,
                packet_bound_ms=max(packet_flops / PEAK_FP32 * 1e3, t_bytes),
                packet_flops=packet_flops)


def launch_shape(res, occupancy: dict) -> dict:
    """How a traversal launch sat on the card: visits per voting group
    (over the groups that walked), the blocks launched and walking,
    resident blocks per SM, the waves the launch needs; and from the
    kernel's own clock the longest walk (when it began after the first one,
    how long it took, its visits and rows), the span from the first
    beginning to the last end, and all walks' time spread evenly over the
    resident warps (what the launch would take if no walk were longer than
    another)."""
    visits = res.node_visits.float()
    walking = visits > 0
    per_block = occupancy["block_threads"] // res.group
    blocks = visits.numel() // per_block
    resident = occupancy["blocks_per_sm"] * occupancy["sms"]
    ns = res.walk_ns.double()
    # began_ns is the card's clock modulo 2^30 ns: unwrap around one walk
    began = (res.began_ns.double() - float(res.began_ns[walking][0])) % 2.0**30
    began = torch.where(began >= 2.0**29, began - 2.0**30, began)
    began = torch.where(walking, began - began[walking].min(), 0.0)
    longest = int(ns.argmax())
    clock = dict(
        longest_walk_us=float(ns[longest]) / 1e3,
        longest_walk_began_us=float(began[longest]) / 1e3,
        longest_walk_visits=int(res.node_visits[longest]),
        longest_walk_rows=int(res.tri_rows[longest]),
        span_us=float((began + ns)[walking].max()) / 1e3,
        even_us=float(ns.sum()) / (resident * per_block) / 1e3)
    return dict(
        **clock,
        group=res.group, groups=int(visits.numel()),
        groups_walking=int(walking.sum()),
        visits_per_group_mean=float(visits[walking].mean()),
        visits_per_group_max=int(visits.max()),
        rows_per_group_max=int(res.tri_rows.max()),
        blocks=blocks,
        blocks_walking=int(walking.reshape(blocks, per_block).any(dim=1).sum()),
        waves=blocks / resident, **occupancy)


def _disagreement(k, p, live, any_hit: bool) -> tuple:
    """(ok, max_abs_err, counts) of one traversal result against another.
    Closest hit: prim must be identical apart from equal-t ties, and t/u/v
    bit-equal where prim agrees (both compute the same IEEE operations in
    the same order). Any hit: the occluded flags (prim >= 0) must be
    identical."""
    if any_hit:
        diff = ((k.prim >= 0) != (p.prim >= 0)) & live
        return (not bool(diff.any()), float(diff.any()),
                dict(occluded=int(((k.prim >= 0) & live).sum()),
                     flag_mismatches=int(diff.sum())))
    same = k.prim == p.prim
    mism = ~same & live
    ties = mism & (k.t == p.t)
    err = max(float((k.t - p.t)[same].abs().max()),
              float((k.u - p.u)[same].abs().max()),
              float((k.v - p.v)[same].abs().max()))
    return (not bool((mism & ~ties).any()) and err == 0.0, err,
            dict(hits=int(((k.prim >= 0) & live).sum()),
                 tie_lanes=int(ties.sum()),
                 non_tie_mismatches=int((mism & ~ties).sum())))


def hold_traversal(args, name: str, launch=None) -> dict:
    """The kernel (a vote per warp) against the plain version on the same
    inputs, twice. Against the packet-wide vote, the TPU kernel's walk:
    this decides whether the warp walk computes the same function on these
    rays. And against the plain version at the kernel's own group width,
    where the four counts of every group must be equal as well."""
    any_hit = args[8]
    k = bt.bvh_intersect_kernel(*args)
    torch.cuda.synchronize()
    t0 = time.time()
    p = bt.bvh_intersect_plain(*args)
    torch.cuda.synchronize()
    plain_s = time.time() - t0
    reads = torch.zeros((args[4].shape[0],), dtype=torch.uint8,
                        device=args[0].device)
    g = bt.bvh_intersect_plain(*args, group=k.group, reads=reads)
    live = args[2] != 0
    ok, err, extra = _disagreement(k, p, live, any_hit)
    ok_g, err_g, extra_g = _disagreement(k, g, live, any_hit)
    # a count that differs: its sums, kernel and plain at group width
    counts_differ = {
        f: [int(getattr(k, f).sum()), int(getattr(g, f).sum())] for f in
        ("node_visits", "tri_rows", "lane_node_tests", "lane_tri_rows")
        if not torch.equal(getattr(k, f), getattr(g, f))}
    counts_equal = not counts_differ
    rec = dict(kernel=name, **({} if launch is None else {"launch": launch}),
               rays=int(args[0].shape[0]),
               blocks=int(args[3].numel()),
               live_blocks=int((args[3] >= 0).sum()),
               walk=dict(group=k.group, node_visits=int(k.node_visits.sum()),
                         tri_rows=int(k.tri_rows.sum()),
                         lane_node_tests=int(k.lane_node_tests.sum()),
                         lane_tri_rows=int(k.lane_tri_rows.sum())),
               packet_walk=dict(group=p.group,
                                node_visits=int(p.node_visits.sum()),
                                tri_rows=int(p.tri_rows.sum())),
               table_reads=dict(nodes=int(((reads & 1) != 0).sum()),
                                rows=int(args[5][(reads & 2) != 0, 1].sum())),
               max_abs_err=max(err, err_g), plain_s=plain_s,
               vs_same_group=dict(counts_equal=counts_equal,
                                  counts_differ=counts_differ, **extra_g),
               ok=ok and ok_g and counts_equal, **extra)
    log("hold_" + name, **rec)
    if not rec["ok"]:
        raise SystemExit(f"{name} {launch or ''}: kernel disagrees with the "
                         "plain version")
    return rec


def aim_at_vertices(args, cm, seed: int = 0, every: int = 5) -> tuple:
    """A traversal launch's rays with every `every`-th lane re-aimed EXACTLY
    at a point of the mesh `cm`, as tests/test_torch_bvh_groups.py's
    camera_wavefront("corners") does: a mesh vertex (shared by six
    triangles, and a corner of their leaf boxes) or a point of the floor's
    rim (on a face of the floor's zero-height box). The origins stay.
    Returns (args, re-aimed lanes)."""
    o = args[0].cpu().numpy()
    d = args[1].cpu().numpy().copy()
    n = o.shape[0]
    rng = np.random.default_rng(seed)
    # the floor is the mesh's last two faces, (c0, c3, c2) and (c0, c2, c1)
    c0 = cm.v0[-1]
    c2, c1 = c0 + cm.e1[-1], c0 + cm.e2[-1]
    s = rng.uniform(0, 1, (n, 1)).astype(np.float32)
    k = rng.integers(0, cm.num_triangles, n)
    on_mesh = cm.v0[k] + np.where(s < 0.5, cm.e1[k], cm.e2[k])
    on_floor = c1 + s * (c2 - c1)
    aim = np.where(rng.uniform(size=(n, 1)) < 0.7, on_mesh, on_floor)
    pick = np.arange(n) % every == 0
    new = aim - o
    new = (new / np.linalg.norm(new, axis=1, keepdims=True)).astype(np.float32)
    d[pick] = new[pick]
    dev = args[0].device
    return ((args[0], torch.from_numpy(d).to(dev)) + tuple(args[2:]),
            torch.from_numpy(pick).to(dev))


def vertex_lanes(k, p, live, aimed, any_hit: bool) -> dict:
    """The lanes where the kernel's warp-wide walk `k` and the packet-wide
    walk `p` differ, by kind: `lost` (the packet walk hits, the kernel
    misses), `swapped` (both hit, other prim, t within 1e-5 relative: the
    neighbouring triangle at the same point), `gained` (the kernel finds a
    hit the packet walk does not, or one closer by more than that), and
    `other`; `off_aim` counts differing lanes that were not re-aimed. Any
    hit: only the occluded flags."""
    if any_hit:
        kh, ph = (k.prim >= 0) & live, (p.prim >= 0) & live
        differ = kh != ph
        return dict(lost=int((ph & ~kh).sum()), gained=int((kh & ~ph).sum()),
                    swapped=0, other=0, off_aim=int((differ & ~aimed).sum()),
                    aimed=int(aimed.sum()), occluded=int(ph.sum()))
    differ = ((k.prim != p.prim) | (k.t != p.t)) & live
    kh, ph = k.prim >= 0, p.prim >= 0
    both = differ & kh & ph
    rel = (k.t - p.t).abs() / p.t.abs().clamp(min=1e-30)
    swapped = both & (rel <= 1e-5)
    lost = differ & ph & ~kh
    gained = differ & kh & (~ph | (both & ~swapped & (k.t < p.t)))
    other = differ & ~(swapped | lost | gained)
    return dict(lost=int(lost.sum()), swapped=int(swapped.sum()),
                gained=int(gained.sum()), other=int(other.sum()),
                off_aim=int((differ & ~aimed).sum()), aimed=int(aimed.sum()),
                hits=int((ph & live).sum()),
                swap_rel_max=float(rel[swapped].max()) if bool(
                    swapped.any()) else 0.0)


# hold_vertices' limits: the swapped and gained lanes measured on an H100
# 80GB HBM3 with the conservative slab test (make_scene(0), 512^2, seed 0:
# 52,429 re-aimed lanes). A gained lane is a hit the packet-wide walk does
# not find: the widened test lets a warp enter a leaf no lane of the packet
# enters, and a lane finds a closer hit there.
VERTEX_LIMITS = {"K1": dict(swapped=120, gained=25),
                 "K2": dict(swapped=0, gained=1)}


def hold_vertices(k1_args, cm) -> dict:
    """F1's count on the card: K1 and K2 on the flagship camera wavefront
    with every 5th lane re-aimed at a mesh vertex or the floor's rim,
    against the packet-wide plain version (the JAX function), lane by lane
    (vertex_lanes); and held bit-equal, counts included, to the plain
    version at the kernel's own group width, as every hold is. Fails on a
    lost hit, an `other` lane, a differing lane that was not re-aimed,
    swapped or gained lanes above VERTEX_LIMITS, or any difference from
    the plain version at group width."""
    v_args, aimed = aim_at_vertices(k1_args, cm)
    live = v_args[2] != 0
    recs = {}
    for any_hit in (False, True):
        args = tuple(v_args[:8]) + (any_hit,)
        k = bt.bvh_intersect_kernel(*args)
        p = bt.bvh_intersect_plain(*args)
        g = bt.bvh_intersect_plain(*args, group=k.group)
        torch.cuda.synchronize()
        same = all(torch.equal(getattr(k, f), getattr(g, f)) for f in (
            "t", "prim", "u", "v", "node_visits", "tri_rows",
            "lane_node_tests", "lane_tri_rows"))
        lanes = vertex_lanes(k, p, live, aimed, any_hit)
        name = "K2" if any_hit else "K1"
        limits = VERTEX_LIMITS[name]
        rec = dict(kernel=name, rays=int(args[0].shape[0]), **lanes,
                   limits=limits, vs_same_group_bit_equal=same,
                   walk=dict(group=k.group,
                             node_visits=int(k.node_visits.sum()),
                             tri_rows=int(k.tri_rows.sum()),
                             lane_node_tests=int(k.lane_node_tests.sum()),
                             lane_tri_rows=int(k.lane_tri_rows.sum())),
                   packet_walk=dict(node_visits=int(p.node_visits.sum()),
                                    tri_rows=int(p.tri_rows.sum())),
                   ok=(same and lanes["lost"] == 0 and lanes["other"] == 0
                       and lanes["off_aim"] == 0
                       and all(lanes[k] <= v for k, v in limits.items())))
        log("hold_K1_vertices", **rec)
        recs[name] = rec
        if not rec["ok"]:
            raise SystemExit(f"{name} on vertex-aimed rays: lost hits, "
                             "swaps or gains over their limits, or a "
                             "difference from the plain version")
    return recs


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
# the multi-instance and looped surface tracers

# the tolerance of tests/torch_parity.py::assert_multi_close (XLA contracts
# a*b+c into FMAs on the CPU; the port does not)
MULTI_GOLDEN_TOL = dict(pix_over_1e5=1e-3, float_mean=1e-4, byte_frac=5e-3)
MULTI_PLAIN_FILM = 128        # the many-domain frames' plain twins


def observe_frame(fn) -> tuple:
    """Run fn() once with every traversal launch observed (the main path
    runs unchanged; the observer only records): per launch its kind, its
    live blocks (read after the frame) and its device time by CUDA events
    around it; the calls of _intersect_bvh with and without shadow lanes
    and of trace_round (the rounds the frame ran); and the host syncs, by
    torch.cuda's sync debug mode. Returns (fn(), stats)."""
    import warnings

    launches, calls = [], {"closest_only": 0, "with_shadow": 0, "rounds": 0}
    orig_k, orig_i, orig_r = (bt.bvh_intersect_kernel, tr._intersect_bvh,
                              tr.trace_round)

    def kernel(*args):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        out = orig_k(*args)
        stop.record()
        launches.append((bool(args[8]), args[3].clone(), start, stop))
        return out

    def intersect(*args, is_shadow=None, **kw):
        calls["closest_only" if is_shadow is None else "with_shadow"] += 1
        return orig_i(*args, is_shadow=is_shadow, **kw)

    def round_(*args, **kw):
        calls["rounds"] += 1
        return orig_r(*args, **kw)

    bt.bvh_intersect_kernel, tr._intersect_bvh, tr.trace_round = (
        kernel, intersect, round_)
    torch.cuda.synchronize()
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode(1)
            try:
                out = fn()
            finally:
                torch.cuda.set_sync_debug_mode(0)
    finally:
        bt.bvh_intersect_kernel, tr._intersect_bvh, tr.trace_round = (
            orig_k, orig_i, orig_r)
    torch.cuda.synchronize()
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    per = [dict(any_hit=a, live_blocks=int((root >= 0).sum()),
                ms=s0.elapsed_time(s1)) for a, root, s0, s1 in launches]
    kinds = {"closest": [p for p in per if not p["any_hit"]],
             "any_hit": [p for p in per if p["any_hit"]]}
    return out, dict(
        calls=calls, host_syncs=syncs,
        launches={k: len(v) for k, v in kinds.items()},
        empty_launches={k: sum(p["live_blocks"] == 0 for p in v)
                        for k, v in kinds.items()},
        kernel_ms=sum(p["ms"] for p in per),
        live_blocks={k: [p["live_blocks"] for p in v]
                     for k, v in kinds.items()})


def capture_live(fn, want: dict) -> dict:
    """Run fn() and return {(kind, k): launch arguments} for the k-th launch
    of each kind ("closest" / "any_hit") that has a live block, for the
    (kind, k) pairs in `want`."""
    seen, count = {}, {"closest": 0, "any_hit": 0}
    orig = bt.bvh_intersect_kernel

    def record(*args):
        kind = "any_hit" if args[8] else "closest"
        if bool((args[3] >= 0).any()):
            if (kind, count[kind]) in want:
                seen[(kind, count[kind])] = tuple(
                    a.clone() if torch.is_tensor(a) else a for a in args)
            count[kind] += 1
        return orig(*args)

    bt.bvh_intersect_kernel = record
    try:
        fn()
    finally:
        bt.bvh_intersect_kernel = orig
    torch.cuda.synchronize()
    missing = set(want) - set(seen)
    if missing:
        raise SystemExit(f"no live launch {sorted(missing)} in the frame")
    return seen


def expected_launches(kind: str, meshes: int, calls: dict) -> dict:
    """Launches per frame from the code and the rounds the frame ran.
    fast-multi: phase A calls _intersect_bvh without shadow lanes (rA
    calls), phase C with all lanes shadow (rC calls); the looped tracer
    calls it twice a round (the mixed wavefront, the spawn matrix), both
    with shadow lanes. A call is one closest launch and, given shadow
    lanes, one any-hit launch with the pack; M of each in place."""
    per = 1 if meshes > tr.INPLACE_MESH_LIMIT else meshes
    if kind == "fast_multi":
        ra, rc = calls["closest_only"], calls["with_shadow"]
        return {"closest": per * (ra + rc), "any_hit": per * rc}
    r = calls["rounds"]
    if calls["with_shadow"] != 2 * r or calls["closest_only"]:
        raise SystemExit(f"looped frame: unexpected calls {calls}")
    return {"closest": 2 * per * r, "any_hit": 2 * per * r}


def multi_frame(name: str, kind: str, meshes: int, fn, plain_fn,
                film: list, plain_film: list, main_counts: dict) -> tuple:
    """Drive one slice C frame with the launch counts at 0 just before and
    read just after; check them against the formula from the rounds the
    frame ran (an observed second run, which must give the same bytes: the
    looped tracer's scatter deposits may differ in the last float bit), and
    hold the frame's plain twin against the kernel frame at
    `plain_film`."""
    bt.reset_launch_counts()
    fb = fn()
    torch.cuda.synchronize()
    counts = {"closest": bt.launches_closest, "any_hit": bt.launches_any_hit}
    for k in counts:
        main_counts[k] += counts[k]
    again, stats = observe_frame(fn)
    expect = expected_launches(kind, meshes, stats["calls"])
    W, H = film
    cmp_plain = compare_frames(*plain_fn(), *plain_film)
    same_run = compare_frames(fb, again, W, H)
    coverage = float((fb[:, :3].sum(dim=1) > 0).float().mean())
    ok = (counts == expect == stats["launches"] and cmp_plain["finite"]
          and bool(torch.isfinite(fb).all()) and coverage > 0.05
          and cmp_plain["byte_frac"] <= 1e-4 and same_run["byte_frac"] <= 1e-4)
    log("frame_multi", frame=name, tracer=kind, meshes=meshes, film=film,
        launches=counts, expected=expect, rounds=stats["calls"],
        empty_launches=stats["empty_launches"],
        host_syncs=stats["host_syncs"], plain_film=plain_film,
        vs_plain=cmp_plain, rerun=same_run, coverage=coverage,
        tolerance=dict(byte_frac=1e-4), ok=ok)
    if not ok:
        raise SystemExit(f"frame_multi {name} failed")
    return fb, stats


def split_frame(fn) -> dict:
    """Host wall time of one fn() spent inside the tracer's instance search
    (_next_instance: closest_box or the tree walk), the BVH dispatch
    (_intersect_bvh: the pack or the passes, and the launches), the brute
    intersector (intersect_closest) and the shading
    (_process_surface_hits), each call closed by a synchronize; `rest` is
    the frame's remainder (arena selects, compaction, deposit)."""
    names = ("_next_instance", "_intersect_bvh", "intersect_closest",
             "_process_surface_hits")
    spent = dict.fromkeys(names, 0.0)
    origs = {k: getattr(tr, k) for k in names}

    def timed(key):
        def call(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = origs[key](*args, **kw)
            torch.cuda.synchronize()
            spent[key] += (time.perf_counter() - t0) * 1e3
            return out
        return call

    for k in names:
        setattr(tr, k, timed(k))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        total = (time.perf_counter() - t0) * 1e3
    finally:
        for k, f in origs.items():
            setattr(tr, k, f)
    return dict(total_ms=total, instance_search_ms=spent["_next_instance"],
                bvh_dispatch_ms=spent["_intersect_bvh"],
                brute_ms=spent["intersect_closest"],
                shade_ms=spent["_process_surface_hits"],
                rest_ms=total - sum(spent.values()))


def time_multi_frame(name: str, fn, stats: dict, card: str, rays: int,
                     reps: int) -> dict:
    """ms eager (CUDA events; the frame's host syncs inside), host ms; from
    the observed run: syncs, rounds, launches (empty ones apart) and
    `kernel_ms_events`, CUDA events around each traversal call (an upper
    bound: a host-paced stream waits inside the pair); from torch.profiler:
    the traversal kernels' device time (`kernel_ms`, its share of the
    frame), all kernels' (`device_busy_ms`, the idle share), operator
    calls and kernel launches; where the host's time goes (split_frame).
    No CUDA-graph replay: the loops' lengths depend on the data."""
    ms = cuda_ms(fn, reps=reps, warmup=1)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / reps
    hc = host_counts(fn, reps=1)
    dev_ms, trav_ms = hc["device_ms"], hc["traversal_device_ms"]
    rec = dict(ms=ms, host_ms=host_ms, host_syncs=stats["host_syncs"],
               launches=stats["launches"],
               empty_launches=stats["empty_launches"],
               rounds=stats["calls"], kernel_ms=trav_ms,
               kernel_share=None if trav_ms is None else trav_ms / ms,
               device_busy_ms=dev_ms,
               device_idle_share=None if dev_ms is None else 1 - dev_ms / ms,
               kernel_ms_events=stats["kernel_ms"],
               rays_per_s=rays / ms * 1e3, graph_ms=None,
               aten_ops=hc["aten_ops"], kernel_launches=hc["kernel_launches"],
               top_kernels=hc["top_kernels"], split=split_frame(fn))
    log("time_frame", frame=name, card=card, **rec)
    return rec


def multi_phases(dev, card: str, occupancy: dict, film: int = 512,
                 plain_film: int = MULTI_PLAIN_FILM) -> dict:
    """Every slice C phase: SimpleApp (the reference's gvtSimple; BVH
    in place over its two meshes, as bench_inner.py --simple passes it, and
    the brute path through render_surface) and the many-domain scene
    (make_multi_scene: the instance tree and the segment-aligned pack)
    through fast-multi and the looped tracer. Returns the main path's
    launch counts and the held launches' records."""
    W = H = film
    t0 = time.time()
    simple = simple_app(W, H)
    sscene = build_scene(simple.meshes, simple.instances, simple.lights,
                         device=dev)
    sacc = build_scene_bvh(simple.meshes, device=dev)
    srays = simple.camera.generate_rays(dev)
    multi = {d: make_multi_scene(0, W, H, max_depth=d) for d in (1, 2)}
    mspec = multi[1]
    mscene = build_scene(mspec.meshes, mspec.instances, mspec.lights,
                         device=dev)
    macc = build_scene_bvh(mspec.meshes, device=dev)
    mrays = {d: multi[d].camera.generate_rays(dev) for d in (1, 2)}
    log("multi_scenes", film=[W, H], setup_s=time.time() - t0,
        simple=dict(instances=sscene.num_instances,
                    meshes=sscene.num_meshes,
                    triangles=sscene.num_triangles,
                    bvh_gate=sscene.num_triangles >= 512,
                    tree=sscene.inst_bvh is not None),
        many_domain=dict(instances=mscene.num_instances,
                         meshes=mscene.num_meshes,
                         triangles=mscene.num_triangles,
                         tree_nodes=mscene.inst_bvh.num_nodes,
                         tri_table_mb=macc.tri.numel() * 4 / 2**20,
                         pack=mscene.num_meshes > tr.INPLACE_MESH_LIMIT))
    if mscene.inst_bvh is None or sscene.inst_bvh is not None:
        raise SystemExit("the instance tree is not where it should be")

    def simple_fast(impl=None):
        return trace_image_fast_multi(sscene, srays, W, H, accel=sacc,
                                      impl=impl)

    def simple_looped(impl=None):
        return trace_image(sscene, make_arena(srays, 1), W, H,
                           max_rounds=64, accel=sacc, impl=impl)

    def many(depth, impl=None, size=film):
        cam = dataclasses.replace(mspec.camera, film_width=size,
                                  film_height=size, max_depth=depth)
        return render_surface(mspec.meshes, mspec.instances, mspec.lights,
                              cam, device=dev, impl=impl)

    def many_fast(depth):
        return trace_image_fast_multi(mscene, mrays[depth], W, H,
                                      accel=macc)

    def many_looped():
        return trace_image(mscene, make_arena(mrays[2], 2), W, H,
                           accel=macc)

    # ---- the kernels on their new launch shapes --------------------------
    held = {}
    picks = (
        ("pack_fast_multi", lambda: many_fast(1),
         {("closest", 0): "phase A round 0: blocks of 10 meshes side by "
                          "side", ("any_hit", 0): "phase C round 0"}),
        ("pack_looped_depth2", many_looped,
         {("closest", 1): "round 1: primary and bounced lanes",
          ("any_hit", 1): "round 1: shadow blocks of the mixed pack"}),
        ("inplace_simple", simple_fast,
         {("closest", 0): "phase A round 0, mesh 0 (cone)",
          ("any_hit", 1): "phase C round 0, mesh 1 (cube)"}),
    )
    for frame, fn, want in picks:
        for (kind, k), args in capture_live(fn, want).items():
            name = "K2_multi" if kind == "any_hit" else "K1_multi"
            what = want[(kind, k)]
            rec = hold_traversal(args, name, launch=f"{frame}/{kind}{k}")
            rec["args"] = args
            rec["what"] = what
            held[f"{frame}/{kind}{k}"] = rec
    del picks

    # ---- the frames, through the entry points -----------------------------
    main_counts = {"closest": 0, "any_hit": 0}
    frames = {}
    fb_fast, st = multi_frame(
        "simple_fast_multi", "fast_multi", 2, simple_fast,
        lambda: (simple_fast(), simple_fast("plain")), [W, H], [W, H],
        main_counts)
    frames["simple_fast_multi"] = (simple_fast, st)
    fb_loop, st = multi_frame(
        "simple_looped", "looped", 2, simple_looped,
        lambda: (simple_looped(), simple_looped("plain")), [W, H], [W, H],
        main_counts)
    frames["simple_looped"] = (simple_looped, st)
    equal = bool(torch.equal(fb_fast, fb_loop))
    log("frame_multi_fast_vs_looped", frame="simple", film=[W, H],
        bit_equal=equal, vs=compare_frames(fb_fast, fb_loop, W, H), ok=equal)
    if not equal:
        raise SystemExit("SimpleApp: fast-multi and looped differ on the card")
    # SimpleApp through render_surface: 18 triangles, the brute path
    bt.reset_launch_counts()
    fb_brute = render_surface(simple.meshes, simple.instances, simple.lights,
                              simple.camera, device=dev)
    torch.cuda.synchronize()
    counts = {"closest": bt.launches_closest, "any_hit": bt.launches_any_hit}
    cmp = compare_frames(fb_brute, fb_fast, W, H)
    ok = counts == {"closest": 0, "any_hit": 0} and cmp["byte_frac"] <= 1e-4
    log("frame_multi", frame="simple_render_surface_brute",
        tracer="fast_multi", launches=counts,
        expected={"closest": 0, "any_hit": 0}, vs_bvh_frame=cmp,
        tolerance=dict(byte_frac=1e-4), ok=ok)
    if not ok:
        raise SystemExit("SimpleApp brute frame failed")
    frames["simple_brute"] = (lambda: trace_image_fast_multi(
        sscene, srays, W, H), None)
    del fb_brute, fb_loop, fb_fast
    for depth, kind in ((1, "fast_multi"), (2, "looped")):
        _, st = multi_frame(
            f"many_domain_depth{depth}", kind,
            mscene.num_meshes, lambda: many(depth),
            lambda: (many(depth, size=plain_film),
                     many(depth, "plain", size=plain_film)),
            [W, H], [plain_film, plain_film], main_counts)
        frames[f"many_domain_depth{depth}"] = (
            (lambda: many_fast(1)) if depth == 1 else many_looped, st)

    # ---- against the JAX package's committed frames -----------------------
    gold = np.load(MULTI_GOLDEN)
    g = int(gold["film"])
    gspecs = {"simple_fast": simple_app(g, g),
              "simple_looped2": simple_app(g, g, max_depth=2),
              "cube_area": cube_row(CUBE_AREA_LIGHTS, film=g),
              "multi": make_multi_scene(0, g, g)}
    for name, spec in gspecs.items():
        fb = render_surface(spec.meshes, spec.instances, spec.lights,
                            spec.camera, device=dev).cpu().numpy()
        ref = gold[f"fb_{name}"]
        dpix = np.abs(fb[:, :3] - ref[:, :3]).max(axis=1)
        cmp = dict(byte_frac=float(np.mean(img.to_rgb8(fb, g, g)
                                           != img.to_rgb8(ref, g, g))),
                   pix_over_1e5=float(np.mean(dpix > 1e-5)),
                   float_mean=float(dpix.mean()), float_max=float(dpix.max()),
                   finite=bool(np.isfinite(fb).all()))
        ok = cmp["finite"] and all(cmp[k] <= v
                                   for k, v in MULTI_GOLDEN_TOL.items())
        log("golden_multi", frame=name, film=[g, g], vs_jax=cmp,
            tolerance=MULTI_GOLDEN_TOL, ok=ok)
        if not ok:
            raise SystemExit(f"golden_multi {name} failed")

    # ---- times ------------------------------------------------------------
    # `ms` times the wrapper call back to back by CUDA events, which a slow
    # host paces when the kernel is short; `graph_ms` replays the same
    # launch from a CUDA graph: the card's time alone
    for key, rec in held.items():
        args = rec["args"]
        res = bt.bvh_intersect_kernel(*args)
        ms = cuda_ms(lambda: bt.bvh_intersect_kernel(*args), reps=20)
        g_ms, g_equal = graph_ms(lambda: bt.bvh_intersect_kernel(*args).prim)
        bound = bound_ms(args, res, rec)
        rec["ms"], rec["graph_ms"], rec["bound"] = ms, g_ms, bound
        log("time_launch", launch=key, what=rec["what"], card=card, ms=ms,
            graph_ms=g_ms, graph_equals_eager=g_equal,
            share_of_bound=bound["bound_ms"] / g_ms,
            share_of_packet_bound=bound["packet_bound_ms"] / g_ms, **bound,
            rays=int(args[0].shape[0]),
            live_blocks=int((args[3] >= 0).sum()), **rec["walk"])
        log("launch_shape", launch=key, **launch_shape(res, occupancy))
        if not (bound["bound_ms"] <= g_ms and g_equal):
            raise SystemExit(f"{key}: faster than its bound, or the replay "
                             "differs")
    # a launch with no live block, as the passes without lanes of their
    # kind make (SimpleApp's camera launch with every root -1)
    empty = list(held["inplace_simple/closest0"]["args"])
    empty[3] = torch.full_like(empty[3], -1)
    ms = cuda_ms(lambda: bt.bvh_intersect_kernel(*empty), reps=20)
    g_ms, _ = graph_ms(lambda: bt.bvh_intersect_kernel(*empty).prim)
    log("time_launch", launch="empty", card=card, ms=ms, graph_ms=g_ms,
        rays=int(empty[0].shape[0]), live_blocks=0)
    for name, (fn, st) in frames.items():
        if st is None:
            _, st = observe_frame(fn)
        time_multi_frame(name, fn, st, card, W * H,
                         reps=3 if "looped" in name or "depth2" in name
                         else 5)
    for rec in held.values():
        del rec["args"]
    return dict(counts=main_counts, held=held)


# ---------------------------------------------------------------------------
# the closest-instance search (ops/instance_slab.py)

SLAB_BLOCK = 256          # threads per block of csrc/instance_slab.cu
SLAB_LANE_BYTES = 41      # origin, direction, t_max, exclude in; 9 B out


def capture_searches(fn) -> tuple:
    """(fn()'s result, a copy of the arguments (lo, hi, origin, direction,
    t_max, exclude) of every closest_box call the tracers made in it)."""
    calls = []
    orig = slab.closest_box

    def record(lo, hi, origin, direction, t_max, exclude, impl=None):
        calls.append(tuple(x.detach().clone() for x in (
            lo, hi, origin, direction, t_max, exclude)))
        return orig(lo, hi, origin, direction, t_max, exclude, impl=impl)

    tr.closest_box = vt.closest_box = record
    try:
        out = fn()
        torch.cuda.synchronize()
    finally:
        tr.closest_box = vt.closest_box = orig
    return out, calls


class plain_search:
    """Inside the block every closest_box call runs the plain version,
    whatever the device: the frame's one difference from the kernel's."""

    def __enter__(self):
        self.kernel = slab.closest_box_kernel
        slab.closest_box_kernel = slab.closest_box_plain

    def __exit__(self, *exc):
        slab.closest_box_kernel = self.kernel
        return False


def hold_search(name: str, args) -> dict:
    """The kernel against the plain version on one search's inputs: lanes
    whose found, nxt or t_entry bits differ (all must be 0)."""
    k = slab.closest_box_kernel(*args)
    p = slab.closest_box_plain(*args)
    torch.cuda.synchronize()
    off = {key: int((a.view(torch.int32) != b.view(torch.int32)).sum())
           if a.dtype == torch.float32 else int((a != b).sum())
           for key, a, b in zip(("found", "nxt", "t_entry"), k, p)}
    n = int(args[2].shape[0])
    rec = dict(lanes=n, boxes=int(args[0].shape[0]),
               tail_lanes=n % SLAB_BLOCK, found=int(p[0].sum()),
               strided=not args[2].is_contiguous(), mismatched=off,
               ok=not any(off.values()))
    log("hold_instance_slab", search=name, **rec)
    if not rec["ok"]:
        raise SystemExit(f"instance_slab {name}: kernel != plain")
    return rec


def search_frame(name: str, fn, card: str) -> dict:
    """One frame with the kernel and with the plain search: bit-equal, one
    launch a search, and the host's time in the instance search
    (split_frame) on both sides."""
    slab.reset_launch_counts()
    fb, calls = capture_searches(fn)
    launches = slab.launches_instance_slab
    with plain_search():
        fb_plain = fn()
    torch.cuda.synchronize()
    equal = bool(torch.equal(fb, fb_plain))
    searches = sum(c[2].shape[0] > 0 for c in calls)
    rec = dict(frame=name, card=card, launches=launches, searches=searches,
               widths=sorted({int(c[2].shape[0]) for c in calls}),
               bit_equal_to_plain=equal)
    if name != "volume":
        fn()
        after = split_frame(fn)
        with plain_search():
            fn()
            before = split_frame(fn)
        rec.update(instance_search_ms=after["instance_search_ms"],
                   total_ms=after["total_ms"],
                   plain_instance_search_ms=before["instance_search_ms"],
                   plain_total_ms=before["total_ms"])
    rec["ok"] = equal and launches == searches > 0
    log("frame_instance_slab", **rec)
    if not rec["ok"]:
        raise SystemExit(f"instance_slab frame {name} failed")
    return rec


def gvt_vol_scene(dev, film: int = 512):
    """The gvt_vol configuration (portbench/configs/gvt_vol.json): VTK's
    wavelet at 512^3 in VolApp's eight bricklets of 256, and its camera
    at 0.6 of the fitted distance."""
    from gravit_tpu_torch.scene.transfer import TransferFunction
    from gravit_tpu_torch.scene.volume import Volume
    from portbench.scenes import rt_wavelet

    data = rt_wavelet.scene((-256, 255), (256, 256, 256))
    tf = TransferFunction.gray_ramp(data.low, data.high, 0.05)
    volumes = [Volume(samples=b.samples, origin=b.origin,
                      spacing=np.ones(3, np.float32), tf=tf)
               for b in data.bricks]
    scene = build_volume_scene(volumes, [(i, np.eye(4, dtype=np.float32))
                                         for i in range(len(volumes))],
                               device=dev)
    focus = np.full(3, 255.5)
    eye = focus + (np.full(3, 2299.5) - focus) * 0.6
    cam = PerspectiveCamera(eye=tuple(eye), focus=tuple(focus),
                            up=(0.0, 1.0, 0.0), fov=np.radians(30.0),
                            film_width=film, film_height=film,
                            jitter_window=0.5)
    return scene, cam.generate_rays(dev, volume=True)


def instance_slab_phase(dev, card: str, film: int = 512) -> dict:
    """The search over every instance box (csrc/instance_slab.cu) against
    its plain version, lane for lane, on every search of SimpleApp's
    fast-multi frame (the full-width arena and the compacted tails), of the
    train cell's looped forward (the 2 x 1.25 arena), of a gvt_vol frame
    (eight bricks) and at widths that are not a multiple of the block, the
    rays as column slices of a wider table; the gradient route; the frames
    bit-equal to their plain-search twins, one launch a search; a launch's
    time against its byte bound. Returns the kernel's row."""
    W = H = film
    simple = simple_app(W, H)
    sscene = build_scene(simple.meshes, simple.instances, simple.lights,
                         device=dev)
    srays = simple.camera.generate_rays(dev)
    if sscene.inst_bvh is not None:
        raise SystemExit("SimpleApp should search its instances, not a tree")

    def fast():
        return trace_image_fast_multi(sscene, srays, W, H)

    L = sscene.num_lights

    def looped():
        return trace_image(sscene, make_arena(srays, L), W, H, max_rounds=64)

    def train_forward():
        with torch.no_grad():
            return trace_image(sscene, make_arena(srays, L), W, H,
                               max_rounds=4, unroll=True)

    vscene, vrays = gvt_vol_scene(dev, film)
    axes = vt.slice_axes_for(vscene, vrays.direction)

    def volume():
        return vt.trace_volume(vscene, make_arena(vrays, 0), W, H,
                               slice_axes=axes)

    held = []
    _, fast_calls = capture_searches(fast)
    for i, args in enumerate(fast_calls):
        held.append(hold_search(f"simple_fast_multi/{i}", args))
    _, train_calls = capture_searches(train_forward)
    for i, args in enumerate(train_calls):
        held.append(hold_search(f"train_forward/{i}", args))
    _, vol_calls = capture_searches(volume)
    for i, args in enumerate(vol_calls):
        held.append(hold_search(f"gvt_vol/{i}", args))
    # ragged widths, the rays as column slices of a (n, 16) table
    lo, hi, o, d, t_max, ex = fast_calls[0]
    for n in (1, 255, 257, W * H - 37):
        table = torch.zeros((n, 16), dtype=torch.float32, device=dev)
        table[:, 0:3], table[:, 3:6], table[:, 10] = o[:n], d[:n], t_max[:n]
        held.append(hold_search(f"ragged_{n}", (
            lo, hi, table[:, 0:3], table[:, 3:6], table[:, 10], ex[:n])))
    # where autograd records, t_entry is recomputed from the winner's box
    og = o.clone().requires_grad_(True)
    found, nxt, t_grad = slab.closest_box(lo, hi, og, d, t_max, ex)
    p = slab.closest_box_plain(lo, hi, o, d, t_max, ex)
    grad_equal = bool(torch.equal(t_grad.detach(), p[2])
                      and torch.equal(nxt, p[1]) and t_grad.requires_grad)
    log("hold_instance_slab_grad", lanes=int(o.shape[0]),
        bit_equal=grad_equal, ok=grad_equal)
    if not grad_equal:
        raise SystemExit("instance_slab: the recomputed t_entry differs")
    widths = {"simple_fast_multi": len(fast_calls),
              "train_forward": len(train_calls), "gvt_vol": len(vol_calls)}
    train_args = train_calls[0]
    del train_calls, vol_calls

    frames = [search_frame("simple_fast_multi", fast, card),
              search_frame("simple_looped", looped, card),
              search_frame("volume", volume, card)]

    # a launch's time (CUDA events, back to back) at the full film and the
    # train arena, against the bytes its lanes move
    times = {}
    for key, args in (("full_film", fast_calls[0]),
                      ("train_arena", train_args)):
        n = int(args[2].shape[0])
        ms = cuda_ms(lambda: slab.closest_box_kernel(*args), reps=50)
        g_ms, g_equal = graph_ms(lambda: slab.closest_box_kernel(*args)[2])
        plain = cuda_ms(lambda: slab.closest_box_plain(*args), reps=5)
        bound = n * SLAB_LANE_BYTES / 3.35e12 * 1e3
        times[key] = dict(ms=ms, graph_ms=g_ms, plain_ms=plain,
                          bound_ms=bound)
        log("time_instance_slab", launch=key, card=card, lanes=n,
            boxes=int(args[0].shape[0]), ms=ms, graph_ms=g_ms,
            graph_equals_eager=g_equal, plain_ms=plain, bound_ms=bound,
            bound_by="bytes", share_of_bound=bound / g_ms)
        if not (bound <= g_ms and g_equal):
            raise SystemExit(f"instance_slab {key}: faster than its bound, "
                             "or the replay differs")
    log("instance_slab", searches_held=len(held), by_frame=widths,
        max_abs_err=0.0, ok=True)
    return dict(
        name="instance_slab (closest instance box)", route="cuda",
        source="gravit_tpu_torch/csrc/instance_slab.cu", replaces=None,
        launches=sum(f["launches"] for f in frames), max_abs_err=0.0,
        ms=times["full_film"]["graph_ms"],
        plain_ms=times["full_film"]["plain_ms"],
        bound_ms=times["full_film"]["bound_ms"], bound_by="bytes",
        library_ms=None, packet_bound_ms=None)


# ---------------------------------------------------------------------------
# the native builder

def single_mesh_bvh(order, bounds, meta, cm, dev):
    """The SceneBVH of one mesh from a flat build's arrays, laid out as
    the JAX package's build_scene_bvh lays them out (gravit_tpu/accel/
    scene_accel.py): triangles in leaf order, padded by LEAF_PAD_ROWS."""
    t = order.shape[0]
    tri = np.zeros((t + LEAF_PAD_ROWS, 12), np.float32)
    tri[:t, 0:3], tri[:t, 3:6], tri[:t, 6:9] = (cm.v0[order], cm.e1[order],
                                                cm.e2[order])
    leaf2global = np.concatenate([order, np.zeros(LEAF_PAD_ROWS, np.int32)])
    def as_t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    return SceneBVH(bounds=as_t(bounds), meta=as_t(meta), tri=as_t(tri),
                    leaf2global=as_t(leaf2global),
                    mesh_root=as_t(np.zeros(1, np.int32)), num_meshes=1)


def native_phase(dev, spec: SceneSpec, scene, k1_args) -> None:
    """The native host builder on the flagship mesh: it must load (no
    quiet fall back to numpy); its build time beside the numpy builder's;
    the frame of render_surface (the default build) byte-equal to the frame
    traced over a tree assembled from the native build's own arrays (the
    JAX package's default order); and, against the numpy builder's leaf
    order (the port's default before), the frame's bytes and the camera
    lanes whose hit moved to another triangle at the same t (ties)."""
    if not native_lib.available():
        raise SystemExit(f"native builder unavailable: {native_lib.error}")
    cm = spec.meshes[0]
    times = {}
    for name, use_native in (("native", True), ("numpy", False)):
        t0 = time.perf_counter()
        flat = build_bvh(cm.v0, cm.e1, cm.e2, native=use_native)
        times[name] = (time.perf_counter() - t0, flat)
    nat, py = times["native"][1], times["numpy"][1]
    W, H = spec.camera.film_width, spec.camera.film_height
    fb = render_surface(spec.meshes, spec.instances, spec.lights,
                        spec.camera, device=dev)
    raw = native_lib.build_bvh_native(cm.v0, cm.e1, cm.e2)
    jax_order = single_mesh_bvh(raw[2], raw[0], raw[1], cm, dev)
    rays = spec.camera.generate_rays(dev)
    fb_jax_order = trace_image_fast(scene, rays, W, H, accel=jax_order)
    numpy_order = single_mesh_bvh(py.order, py.bounds, py.meta, cm, dev)
    fb_numpy = trace_image_fast(scene, rays, W, H, accel=numpy_order)
    # the camera launch over each tree: lanes whose hit moved at equal t
    hits = {}
    for name, acc in (("native", jax_order), ("numpy", numpy_order)):
        args = tuple(k1_args[:4]) + (acc.bounds, acc.meta, acc.tri,
                                     k1_args[7], False)
        r = bt.bvh_intersect_kernel(*args)
        hits[name] = (r.t, torch.where(r.prim >= 0,
                                       acc.leaf2global[r.prim.clamp(min=0)],
                                       -1))
    (tn, pn), (tp_, pp) = hits["native"], hits["numpy"]
    moved = (pn != pp) & (tn == tp_)
    vs_jax = compare_frames(fb, fb_jax_order, W, H)
    ok = (vs_jax["byte_frac"] == 0.0 and vs_jax["float_max"] == 0.0
          and np.array_equal(nat.bounds, py.bounds)
          and sorted(nat.order.tolist()) == list(range(cm.num_triangles)))
    log("native", triangles=cm.num_triangles, available=True,
        build_s={"native": times["native"][0], "numpy": times["numpy"][0]},
        nodes=int(nat.bounds.shape[0]), depth=nat.depth,
        same_node_table=bool(np.array_equal(nat.bounds, py.bounds)),
        leaf_order_equal=bool(np.array_equal(nat.order, py.order)),
        vs_native_arrays=vs_jax,
        vs_numpy_order=dict(**compare_frames(fb, fb_numpy, W, H),
                            camera_ties_moved=int(moved.sum()),
                            other_lanes_differ=int(((pn != pp) & ~moved)
                                                   .sum())),
        ok=ok)
    if not ok:
        raise SystemExit("native: the default frame is not the native "
                         "build's")


# ---------------------------------------------------------------------------
# slice D: the image and domain schedulers

SCHED_BUDGET_TRIS = 3 * 8192  # three of the many-domain scene's meshes


def observe_sched(fn) -> tuple:
    """observe_frame(fn) plus what the domain scheduler did: trace_round
    and _pack_exchange calls (per member) and the (drops, peak demand) of
    every trace_domain call."""
    calls = {"pack": 0, "domain": []}
    orig_p, orig_t = ds._pack_exchange, ds.trace_domain

    def pack(*args, **kw):
        calls["pack"] += 1
        return orig_p(*args, **kw)

    def trace(*args, **kw):
        out = orig_t(*args, **kw)
        if kw.get("return_stats") == "peak":
            calls["domain"].append([int(x) for x in out[1]])
        return out

    ds._pack_exchange, ds.trace_domain = pack, trace
    try:
        out, stats = observe_frame(fn)
    finally:
        ds._pack_exchange, ds.trace_domain = orig_p, orig_t
    stats.update(packs=calls["pack"], domain_calls=calls["domain"])
    return out, stats


def capture_round_launches(fn, target: str, tag_of) -> dict:
    """Run fn() with render/tracer.py's `target` (the round a scheduler
    runs for one member or one mesh group) wrapped, and return
    {(tag, kind): launch arguments} for the first launch of each kind
    ("closest" / "any_hit") with a live block made under a round call that
    `tag_of(call number, its accel)` tags (None: not taken)."""
    seen, state = {}, {"tag": None, "calls": 0}
    orig_round, orig = getattr(tr, target), bt.bvh_intersect_kernel

    def round_fn(*args, **kw):
        state["tag"] = tag_of(state["calls"], kw.get("accel"))
        state["calls"] += 1
        try:
            return orig_round(*args, **kw)
        finally:
            state["tag"] = None

    def record(*args):
        key = (state["tag"], "any_hit" if args[8] else "closest")
        if (key[0] is not None and key not in seen
                and bool((args[3] >= 0).any())):
            seen[key] = tuple(a.clone() if torch.is_tensor(a) else a
                              for a in args)
        return orig(*args)

    setattr(tr, target, round_fn)
    bt.bvh_intersect_kernel = record
    try:
        fn()
    finally:
        setattr(tr, target, orig_round)
        bt.bvh_intersect_kernel = orig
    torch.cuda.synchronize()
    return seen


def hold_sched_launches(name: str, fn, target: str, tag_of,
                        want: dict) -> dict:
    """K1 and K2 on the launches a scheduler's rounds give them (the
    member's or group's stacked tables, zero-padded rows, padded mesh
    slots with root -1), each held against both plain versions by
    hold_traversal. `want` maps (tag, kind) to what the launch is."""
    seen = capture_round_launches(fn, target, tag_of)
    missing = set(want) - set(seen)
    if missing:
        raise SystemExit(f"{name}: no live launch {sorted(missing)}")
    held = {}
    for (tag, kind), args in sorted(seen.items()):
        if (tag, kind) not in want:
            continue
        label = f"{name}/{tag}/{kind}"
        rec = hold_traversal(args, "K2_sched" if kind == "any_hit"
                             else "K1_sched", launch=label)
        held[label] = dict(max_abs_err=rec["max_abs_err"],
                           what=want[(tag, kind)])
    return held


def padded_slots(accel) -> bool:
    """Whether a group's tables have a padded mesh slot (root -1)."""
    return accel is not None and bool((accel.mesh_root < 0).any())


def sched_frame(name: str, fn, ref, W: int, H: int, card: str,
                main_counts: dict, tol: float, reps: int = 2,
                bit_equal: bool = False, extra=None) -> dict:
    """Drive one scheduled frame through its entry point with the launch
    counts at 0 just before and read just after (both kernels must have
    launched), hold it against the all-resident frame `ref` (max |d| <=
    tol; bit_equal: equal), observe a second run (host syncs, rounds,
    launches, exchanges) and time it (CUDA events over `reps` frames, host
    clock). `extra(stats)` adds fields."""
    bt.reset_launch_counts()
    fb = fn()
    torch.cuda.synchronize()
    counts = {"closest": bt.launches_closest, "any_hit": bt.launches_any_hit}
    for k in counts:
        main_counts[k] += counts[k]
    _, stats = observe_sched(fn)
    cmp = compare_frames(fb, ref, W, H)
    d = (fb[:, :3] - ref[:, :3]).abs().amax(dim=1)
    bit_frac = float((d == 0).float().mean())
    ms = cuda_ms(fn, reps=reps, warmup=0)
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    ok = (counts["closest"] > 0 and counts["any_hit"] > 0 and cmp["finite"]
          and cmp["coverage"] > 0.05 and cmp["float_max"] <= tol
          and (not bit_equal or bool(torch.equal(fb[:, :3], ref[:, :3]))))
    rec = dict(frame=name, card=card, launches=counts,
               observed_launches=stats["launches"],
               empty_launches=stats["empty_launches"],
               host_syncs=stats["host_syncs"],
               member_rounds=stats["calls"]["rounds"], ms=ms,
               host_ms=host_ms, rays_per_s=W * H / ms * 1e3,
               vs_resident=cmp, pixels_bit_equal=bit_frac,
               tolerance=dict(float_max=tol, bit_equal=bit_equal), ok=ok)
    if extra is not None:
        rec.update(extra(stats))
    log(name.split("/")[0], **rec)
    if not ok:
        raise SystemExit(f"{name}: failed")
    return rec


def sched_phases(dev, card: str, film: int = 512) -> dict:
    """Slice D on the card: the image scheduler on a LocalGroup(4) and the
    streamed renderer (the many-domain scene with its point light only,
    depth 1), and the domain scheduler on a LocalGroup(4) (depth 1 and 2,
    both lights) and at world size 1 on a one-rank NCCL DistGroup. Every
    frame drives K1 and K2 through the user's entry point and is held
    against the all-resident looped frame. K1 and K2 are held against
    their plain versions on launches of the streamed renderer's rounds
    and of a domain member's round (hold_sched_launches). Returns the main
    path's launch counts and the held launches' errors."""
    W = H = film
    main_counts = {"closest": 0, "any_hit": 0}
    holds = {}
    spec = make_multi_scene(0, W, H)
    point = dataclasses.replace(spec, lights=spec.lights[:1])
    t0 = time.time()
    accel = build_scene_bvh(spec.meshes, device=dev)
    scene_p = build_scene(point.meshes, point.instances, point.lights,
                          device=dev)
    rays = spec.camera.generate_rays(dev)
    ref_point = trace_image(scene_p, make_arena(rays, 1), W, H, accel=accel)
    torch.cuda.synchronize()
    log("sched_scene", film=[W, H], meshes=len(spec.meshes),
        instances=len(spec.instances),
        triangles=sum(m.num_triangles for m in spec.meshes),
        setup_s=time.time() - t0)

    # ---- the image scheduler: rays over 4 members, scene replicated ------
    mesh4 = GroupMesh({"rays": LocalGroup(4, dev)})
    sched_frame("sched_image", lambda: trace_image_sharded(
        scene_p, make_arena(rays, 1), W, H, mesh4, accel=accel), ref_point,
        W, H, card, main_counts, tol=1e-5, extra=lambda st: dict(members=4))

    # ---- the streamed renderer: mesh groups under a triangle budget -------
    t0 = time.time()
    sr = StreamedImageRenderer(point.meshes, point.instances, point.lights,
                               budget_tris=SCHED_BUDGET_TRIS, use_accel=True,
                               device=dev)
    setup_s = time.time() - t0
    log("sched_streamed_groups", groups=sr.num_groups,
        padded_mesh_slots=[int((a.mesh_root < 0).sum())
                           for a in sr.host_accels])
    holds.update(hold_sched_launches(
        "streamed", lambda: sr.render(point.camera), "trace_round",
        lambda call, acc: "group",
        {("group", "closest"): "a group's round: blocks of its 3 meshes",
         ("group", "any_hit"): "a group's round: shadow blocks"}))
    sched_frame("sched_streamed", lambda: sr.render(point.camera),
                ref_point, W, H, card, main_counts, tol=0.0,
                bit_equal=True, extra=lambda st: dict(
                    groups=sr.num_groups, budget_tris=SCHED_BUDGET_TRIS,
                    setup_s=setup_s, **{f"last_frame_{k}": v
                                        for k, v in sr.stats.items()}))
    del sr, scene_p, ref_point

    # ---- the domain scheduler: domains over 4 members ----------------------
    scene = build_scene(spec.meshes, spec.instances, spec.lights, device=dev)
    for depth in (1, 2):
        cam = dataclasses.replace(spec.camera, max_depth=depth)
        ref = trace_image(scene, make_arena(cam.generate_rays(dev),
                                            scene.num_lights), W, H,
                          accel=accel)
        n = 4
        t0 = time.time()
        dr = ds.DomainRenderer.build(
            spec.meshes, spec.instances, spec.lights,
            GroupMesh({"domains": LocalGroup(n, dev)}), use_accel=True)
        setup_s = time.time() - t0
        _, load = dr.render(cam, return_load=True)
        held = [sum(spec.meshes[g].num_triangles for g in
                    ds._local_mesh_ids(spec.instances, dr.resident, d))
                for d in range(n)]

        def extra(st, dr=dr, load=load, held=held, depth=depth,
                  setup_s=setup_s):
            rounds = st["calls"]["rounds"] // n
            taken = st["packs"] // n
            drops, peak = st["domain_calls"][-1]
            return dict(members=n, depth=depth, setup_s=setup_s,
                        triangles_held=held,
                        padded_triangles=int(dr.scene_stacked.tri_v0.shape[1]),
                        rays_traced=[int(x) for x in load], rounds=rounds,
                        exchanges_taken=taken,
                        exchanges_skipped=rounds - taken, peak_demand=peak,
                        drops=drops, renders=len(st["domain_calls"]))

        if depth == 2:
            # member rounds after the first exchange: migrated rays
            holds.update(hold_sched_launches(
                "domain_d2", lambda dr=dr, cam=cam: dr.render(cam),
                "trace_round",
                lambda call, acc: "member_round1" if call >= n else None,
                {("member_round1", "closest"):
                     "a member's round after the first exchange",
                 ("member_round1", "any_hit"):
                     "the same round's shadow blocks"}))
            # members of unequal size: placed by the default hybrid policy
            # from the primary-ray demand, so smaller members' tables carry
            # padded mesh slots (root -1) and zero rows
            dr_p = dr.reschedule(dr.pending_histogram(cam))
            meshes_held = [len(ds._local_mesh_ids(spec.instances,
                                                  dr_p.resident, d))
                           for d in range(n)]
            log("sched_domain_placed", policy="RayWeightedSpread",
                meshes_held=meshes_held,
                padded_mesh_slots=[int((dr_p.accel.mesh_root[d] < 0).sum())
                                   for d in range(n)])
            holds.update(hold_sched_launches(
                "domain_d2_placed", lambda dr=dr_p, cam=cam: dr.render(cam),
                "trace_round",
                lambda call, acc: "padded_member" if padded_slots(acc)
                else None,
                {("padded_member", "closest"):
                     "a member whose padded mesh slots have root -1",
                 ("padded_member", "any_hit"):
                     "the same member's shadow blocks"}))
            del dr_p
        rec = sched_frame(f"sched_domain/d{depth}",
                          lambda dr=dr, cam=cam: dr.render(cam), ref, W, H,
                          card, main_counts, tol=1e-5, extra=extra)
        if rec["drops"] != 0 or rec["renders"] != 1:
            raise SystemExit("sched_domain: rays dropped")

    # ---- world size 1 on NCCL: one member per process ----------------------
    cam = dataclasses.replace(spec.camera, max_depth=1)
    local1 = ds.DomainRenderer.build(
        spec.meshes, spec.instances, spec.lights,
        GroupMesh({"domains": LocalGroup(1, dev)}), use_accel=True).render(cam)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    parallel.initialize(f"localhost:{port}", 1, 0, backend="nccl")
    try:
        group = parallel.DistGroup(None, dev)
        dr = ds.DomainRenderer.build(spec.meshes, spec.instances, spec.lights,
                                     GroupMesh({"domains": group}),
                                     use_accel=True)
        bt.reset_launch_counts()
        fb = dr.render(cam)
        torch.cuda.synchronize()
        counts = {"closest": bt.launches_closest,
                  "any_hit": bt.launches_any_hit}
        for k in counts:
            main_counts[k] += counts[k]
        equal = bool(torch.equal(fb, local1))
        # no member has a migrant at world size 1: the frame ran no
        # all_to_all; one on a (1, C) arena, every field, is the identity
        packed = make_arena(cam.generate_rays(dev), 2).map(lambda a: a[None])
        a2a = {f.name: group.all_to_all([getattr(packed, f.name)])[0]
               for f in dataclasses.fields(packed)}
        a2a_equal = all(torch.equal(v, getattr(packed, k))
                        and v.dtype == getattr(packed, k).dtype
                        for k, v in a2a.items())
        torch.cuda.synchronize()
        ok = (equal and a2a_equal and counts["closest"] > 0
              and counts["any_hit"] > 0)
        log("sched_domain", frame="nccl_world1", backend="nccl", world=1,
            launches=counts, bit_equal_to_local_group1=equal,
            vs_local_group1=compare_frames(fb, local1, W, H),
            all_to_all_identity=a2a_equal,
            all_to_all_shape=list(packed.origin.shape), ok=ok)
    finally:
        parallel.shutdown()
    if not ok:
        raise SystemExit("sched_domain: NCCL world 1 differs from "
                         "LocalGroup(1), or its all_to_all")
    return dict(counts=main_counts, held=holds)


# ---------------------------------------------------------------------------
# the volume path

# fp32 operations per marched (ray, plane) pair, counted from
# csrc/slice_march.cu: plane position and validity 6, window row and z
# weights 6, grid coordinates and clips 8, two hat-tap pairs 36, the 2x2
# z-lerped bilinear 21, the table lookup and four lerps 20, opacity
# correction and compositing 13 (powf counted as one). Per pair and
# feature: the subgrid's affine map and bounds test 12, an isovalue's
# crossing test 5, a slice plane's affine function and test 16. The
# resample inside a subgrid and the taps at a crossing run for a part of
# the pairs the kernel does not count; they are left out of the bound.
PLANE_FLOPS = 110
SUBGRID_FLOPS = 12
ISO_FLOPS = 5
SLICE_FLOPS = 16
# chip_smoke's limits for a kernel against its plain version
HOLD_TOL = 2e-5
EVENT_FRAC = 1e-4
V64_KINDS = ("plain", "iso", "amr", "slice")
ALL_FEATURES = "iso+amr+slice"


def capture_slice_launches(fn) -> list:
    """Run fn() and return (plan, color_in, w_in, slab_rows, film_width) of
    every slice-kernel launch it made (the shapes the main path gives
    it)."""
    seen = []
    orig = sm._run_kernel

    def record(*args):
        seen.append(args)
        return orig(*args)

    sm._run_kernel = record
    try:
        fn()
    finally:
        sm._run_kernel = orig
    torch.cuda.synchronize()
    return seen


def count_rounds(fn) -> tuple:
    """(fn(), the number of march_round calls it made)."""
    calls = []
    orig = vt.march_round

    def record(*args, **kw):
        calls.append(1)
        return orig(*args, **kw)

    vt.march_round = record
    try:
        out = fn()
    finally:
        vt.march_round = orig
    return out, len(calls)


def count_held_bricks(fn) -> tuple:
    """(fn(), per march_round call the number of bricks that hold a queued
    ray, read from the arena the call is given: the passes it makes)."""
    held = []
    orig = vt.march_round

    def record(scene, arena, *args, **kw):
        queued = arena.active & (arena.inst >= 0)
        held.append(len(set(
            scene.inst_vol[arena.inst[queued].long()].tolist())))
        return orig(scene, arena, *args, **kw)

    vt.march_round = record
    try:
        out = fn()
    finally:
        vt.march_round = orig
    return out, held


def slice_bound_ms(plan, pairs: int, ray_bytes: int = 61) -> tuple:
    """Least time the card could take for one slice-march launch: its fp32
    operations (this run's marched pairs) over the fp32 peak, against its
    bytes (brick, subgrids, table, and `ray_bytes` per ray: the 7 ray rows,
    color and w in, the bool active mask, color and w out) over the memory
    rate. The first port's wrapper stacked 12 float rows in a ray, so its
    bound counted 64 bytes per ray; `bound_ms_64b` keeps shares comparable."""
    per_pair = (PLANE_FLOPS + SUBGRID_FLOPS * len(plan.subs)
                + ISO_FLOPS * len(plan.iso) + SLICE_FLOPS * len(plan.slices))
    flops = per_pair * pairs
    n = plan.rows[0].shape[0]
    nbytes = (4 * (plan.S.numel() + sum(Ss.numel() for Ss, _ in plan.subs)
                   + plan.rgba.numel()) + ray_bytes * n)
    t_ops, t_bytes = flops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes", flops, nbytes)


def hold_slice(name: str, call: tuple) -> dict:
    """A slice kernel against its plain version on the same launch
    arguments. Every ray must agree in color and w within HOLD_TOL and in
    its flags, except EVENT rays: rays that disagree AND whose w lies
    within 1e-5 of the 0.99 termination threshold on either side, or whose
    first iso / slice-plane crossing falls on another plane (a last-bit
    difference moved a discrete event by one plane). Event rays are
    counted and limited, a disagreeing ray without such an event fails.
    The kernel's schedule counts (busy blocks, batches read through L1,
    largest box) are held against slice_schedule_plain's on the same
    launch: all three must be equal."""
    plan, color_in, w_in, slab_rows, film_width = call
    k = sm._run_kernel(plan, color_in, w_in, slab_rows, film_width,
                       diag=True)
    torch.cuda.synchronize()
    t0 = time.time()
    p = sm._run_plain(plan, color_in, w_in, slab_rows)
    torch.cuda.synchronize()
    plain_s = time.time() - t0
    n = k.w.shape[0]
    near = ((k.w - 0.99).abs() <= 1e-5) | ((p.w - 0.99).abs() <= 1e-5)
    err = torch.maximum((k.color - p.color).abs().max(dim=1).values,
                        (k.w - p.w).abs())
    kf, pf = sm._flags(k.w, plan.active), sm._flags(p.w, plan.active)
    event = ((err > HOLD_TOL) | (kf != pf)) \
        & (near | (k.cross_k != p.cross_k))
    max_err = float(err[~event].max())
    flag_mism = int(((kf != pf) & ~event).sum())
    n_event = int(event.sum())
    nz = plan.S.shape[0]
    sch = sm.slice_schedule_plain(plan, color_in, w_in, slab_rows, film_width)
    mirror = sch.counts()
    sched_ok = k.sched == mirror
    rec = dict(
        kernel=name, rays=n, brick=list(plan.S.shape), planes=plan.n_planes,
        windows=len(sm._windows(nz, slab_rows)) if nz > slab_rows else 1,
        film_width=film_width, blocks=int(sch.ray_of.shape[0]),
        schedule=k.sched, schedule_plain=mirror, schedule_equal=sched_ok,
        pairs=[int(k.pairs), int(p.pairs)], max_abs_err=max_err,
        event_rays=n_event, near_threshold_rays=int(near.sum()),
        crossing_plane_differs=int((k.cross_k != p.cross_k).sum()),
        flag_mismatches=flag_mism,
        saturated=int((k.w > 0.99).sum()),
        crossings=int((k.cross_k >= 0).sum()), plain_s=plain_s,
        tolerance=dict(max_abs_err=HOLD_TOL, event_frac=EVENT_FRAC),
        ok=(max_err <= HOLD_TOL and n_event <= EVENT_FRAC * n
            and flag_mism == 0 and sched_ok))
    log("hold_" + name, **rec)
    if not rec["ok"]:
        raise SystemExit(f"{name}: kernel disagrees with the plain version")
    rec["color"] = k.color
    rec["w"] = k.w
    rec["busy_blocks"] = k.sched["busy_blocks"]
    return rec


def slice_occupancy() -> dict:
    """Registers, shared memory, blocks per SM of each slice entry point."""
    return {name: sm.kernel_occupancy(entry) for name, entry in
            (("K4", sm._ENTRY_PLAIN), ("K4_features", sm._ENTRY_FEATURES),
             ("K5", sm._ENTRY_SLAB))}


def time_slice_launch(name: str, call: tuple, card: str, pairs: int,
                      occupancy: dict, busy_blocks=None) -> dict:
    """CUDA-event time of the kernel alone (launch prepared once), of the
    whole wrapper call, the launch's bound, and how it sits on the card:
    blocks launched and busy, resident blocks per SM, waves (busy blocks
    over the resident ones)."""
    plan, color_in, w_in, slab_rows, film_width = call
    launch = sm._prepare_launch(plan, color_in, w_in, slab_rows,
                                film_width=film_width)
    ms = cuda_ms(lambda: sm._launch(launch), reps=20)
    wrapper_ms = cuda_ms(lambda: sm._run_kernel(*call), reps=10)
    b_ms, b_by, flops, nbytes = slice_bound_ms(plan, pairs)
    b64_ms = slice_bound_ms(plan, pairs, ray_bytes=64)[0]
    occ = occupancy[{sm._ENTRY_PLAIN: "K4", sm._ENTRY_FEATURES: "K4_features",
                     sm._ENTRY_SLAB: "K5"}[launch.entry]]
    resident = occ["blocks_per_sm"] * occ["sms"]
    blocks = int(sm._blocks(int(color_in.shape[0]), film_width).shape[0])
    rec = dict(ms=ms, wrapper_ms=wrapper_ms, bound_ms=b_ms, bound_by=b_by,
               share_of_bound=b_ms / ms, bound_ms_64b=b64_ms,
               share_of_bound_64b=b64_ms / ms, flops=flops, bytes=nbytes,
               rays=int(color_in.shape[0]), pairs=pairs,
               film_width=film_width, blocks=blocks, busy_blocks=busy_blocks,
               blocks_per_sm=occ["blocks_per_sm"],
               waves=None if busy_blocks is None else busy_blocks / resident)
    log("time_launch", launch=name, card=card, **rec)
    slice_launch_shape(name, call, resident)
    return rec


def slice_launch_shape(name: str, call: tuple, resident: int) -> None:
    """Where a slice launch's time goes, from the card's clock read at each
    block's start and end (one launch made for this, with no other
    diagnostic, so its blocks run the schedule a frame's do): the launch's
    span, the longest block's span, its batches and when it began, the mean
    span of busy and of idle blocks, and all blocks' spans spread evenly
    over the resident blocks (`even_us`: the launch if no block waited on
    another)."""
    plan, color_in, w_in, slab_rows, film_width = call
    launch = sm._prepare_launch(plan, color_in, w_in, slab_rows,
                                film_width=film_width)
    nb = int(sm._blocks(int(color_in.shape[0]), film_width).shape[0])
    clock = torch.zeros((nb, 3), dtype=torch.int64, device=launch.out.device)
    launch.args.block_ns = clock.data_ptr()
    sm._launch(launch)
    torch.cuda.synchronize()
    c = clock.cpu()
    t0 = int(c[:, 0].min())
    span = (c[:, 1] - c[:, 0]).double() / 1e3
    busy = c[:, 2] > 0
    i = int(torch.argmax(span))
    log("slice_launch_shape", launch=name, blocks=nb,
        busy_blocks=int(busy.sum()), span_us=(int(c[:, 1].max()) - t0) / 1e3,
        longest_block_us=float(span[i]), longest_block_batches=int(c[i, 2]),
        longest_block_began_us=(int(c[i, 0]) - t0) / 1e3,
        busy_block_us_mean=float(span[busy].mean()) if bool(busy.any())
        else 0.0,
        idle_block_us_mean=float(span[~busy].mean()) if bool((~busy).any())
        else 0.0,
        batches_per_busy_block=float(c[busy, 2].double().mean())
        if bool(busy.any()) else 0.0,
        even_us=float(span.sum()) / resident)


def time_frame(name: str, fn, card: str, kernel_ms: float, rays: int,
               reps: int = 10) -> dict:
    ms = cuda_ms(fn, reps=reps)
    t0 = time.perf_counter()
    for _ in range(max(1, reps // 2)):
        fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / max(1, reps // 2)
    rec = dict(ms=ms, host_ms=host_ms, kernel_ms=kernel_ms,
               glue_ms=ms - kernel_ms, kernel_share=kernel_ms / ms,
               rays_per_s=rays / ms * 1e3)
    log("time_frame", frame=name, card=card, **rec)
    return rec


def volume_frame(spec: VolumeSpec, impl=None) -> torch.Tensor:
    return render_volume(spec.volumes, spec.instances, spec.camera,
                         device="cuda", impl=impl)


def check_volume_frame(phase: str, name: str, spec: VolumeSpec,
                       expect: dict, extra_ok=None) -> tuple:
    """Drive one frame through render_volume with the slice counts at 0
    just before and read just after; hold it against its plain twin."""
    W, H = spec.camera.film_width, spec.camera.film_height
    sm.reset_launch_counts()
    fb, rounds = count_rounds(lambda: volume_frame(spec))
    torch.cuda.synchronize()
    counts = {"slice": sm.launches_slice, "slab": sm.launches_slab}
    cmp = compare_frames(fb, volume_frame(spec, impl="plain"), W, H)
    ok = (counts == expect and cmp["finite"] and cmp["coverage"] > 0.05
          and cmp["byte_frac"] <= 1e-4)
    log(phase, frame=name, film=[W, H], rounds=rounds, launches=counts,
        expected=expect, vs_plain=cmp, tolerance=dict(byte_frac=1e-4), ok=ok)
    if not ok:
        raise SystemExit(f"{phase} {name} failed")
    return fb, counts


def volume_phases(dev, card: str, film: int = 512, small: int = 64,
                  big: int = 256, split: int = 96) -> list:
    """Every volume phase; returns the K4 and K5 rows of the kernels line.
    The defaults are the full sizes: a 512^2 film, the 64^3 bench brick,
    the 256^3 brick that marches as windows, two 96x96x49 bricks."""
    W = H = film
    specs = {k: make_volume_scene(k, small, W, H) for k in V64_KINDS}
    specs["V256"] = make_volume_scene("plain", big, W, H)
    scenes = {k: build_volume_scene(s.volumes, s.instances, device=dev)
              for k, s in specs.items()}
    rays = {k: s.camera.generate_rays(dev, volume=True)
            for k, s in specs.items()}
    gates = {k: vt.can_slice_march(scenes[k], rays[k].direction)
             for k in specs}
    log("volume_scenes", film=[W, H],
        bricks={k: list(scenes[k].vol_samples[0].shape) for k in specs},
        brick_mib={k: scenes[k].vol_samples[0].numel() * 4 / 2**20
                   for k in specs},
        gate={k: list(g) for k, g in gates.items()})
    if not all(g[0] for g in gates.values()):
        raise SystemExit("a volume configuration failed the slice gate")

    def fast(k):
        _, axis, flip = gates[k]
        return vt.trace_volume_fast(scenes[k], rays[k], W, H, axis=axis,
                                    flip=flip)

    calls = {k: capture_slice_launches(lambda: fast(k))[0] for k in specs}

    # ---- the kernels against their plain versions ------------------------
    held = {k: hold_slice("K5" if k == "V256" else "K4_" + k, calls[k])
            for k in specs}
    n = W * H
    iso_sat = held["iso"]["saturated"]
    differs = {k: float((held[k]["color"] - held["plain"]["color"])
                        .abs().max()) for k in ("iso", "amr", "slice")}
    ok = iso_sat > 0.01 * n and all(v > 0.02 for v in differs.values())
    log("hold_K4_features", iso_saturated=iso_sat, rays=n,
        max_diff_from_plain_frame=differs, ok=ok)
    if not ok:
        raise SystemExit("a K4 feature did nothing")
    # the three features in one launch (a hold only: no frame, no time)
    aspec = make_volume_scene(ALL_FEATURES, small, W, H)
    ascene = build_volume_scene(aspec.volumes, aspec.instances, device=dev)
    hold_slice("K4_" + ALL_FEATURES, capture_slice_launches(
        lambda: vt.trace_volume_fast(ascene, rays["plain"], W, H))[0])
    del ascene
    # six subgrids along the brick's diagonal: the kernel reads them from a
    # device table of any length (a hold only)
    mspec = make_volume_scene("plain", small, W, H)
    for i in range(6):
        sub = wavelet_volume(small // 4)
        sub.level = 1
        sub.origin = np.full(3, small / 8.0 * (i + 1), np.float32)
        sub.spacing = np.full(3, 0.5, np.float32)
        mspec.volumes[0].subgrids.append(sub)
    mscene = build_volume_scene(mspec.volumes, mspec.instances, device=dev)
    many = hold_slice("K4_amr_x6", capture_slice_launches(
        lambda: vt.trace_volume_fast(mscene, rays["plain"], W, H))[0])
    d6 = float((many["color"] - held["plain"]["color"]).abs().max())
    log("hold_K4_amr_x6_differs", max_diff_from_plain_frame=d6, ok=d6 > 0.02)
    if not d6 > 0.02:
        raise SystemExit("six subgrids did nothing")
    del mscene, many
    # K5 against K4's entry point on the same brick, marched whole
    plan, c_in, w_in, slab_rows, fw = calls["V256"]
    whole = sm._run_kernel(plan, c_in, w_in, plan.S.shape[0], fw, diag=True)
    torch.cuda.synchronize()
    err = max(float((whole.color - held["V256"]["color"]).abs().max()),
              float((whole.w - held["V256"]["w"]).abs().max()))
    log("hold_K5_vs_K4", brick=list(plan.S.shape), slab_rows=slab_rows,
        pairs=[int(held["V256"]["pairs"][0]), int(whole.pairs)],
        max_abs_err=err, tolerance=1e-6, ok=err <= 1e-6)
    if err > 1e-6:
        raise SystemExit("K5 disagrees with K4 on the same brick")
    del whole

    # ---- the main path, through the user's entry point -------------------
    main_counts = {"slice": 0, "slab": 0}
    for k in specs:
        expect = ({"slice": 0, "slab": 1} if k == "V256"
                  else {"slice": 1, "slab": 0})
        _, counts = check_volume_frame("frame_volume", k, specs[k], expect)
        for key in counts:
            main_counts[key] += counts[key]

    # two bricks through the wavefront tracer: K4 under march_round, one
    # launch a round per brick that holds a queued ray; then the gather
    # march for both bricks
    bricks = make_volume_scene("bricks", split, W, H)
    bscene = build_volume_scene(bricks.volumes, bricks.instances, device=dev)
    brays = bricks.camera.generate_rays(dev, volume=True)
    barena = make_arena(brays, 0)
    saxes = vt.slice_axes_for(bscene, brays.direction)
    _, held_bricks = count_held_bricks(lambda: vt.trace_volume(
        bscene, barena, W, H, slice_axes=saxes))
    fb_wave, counts = check_volume_frame(
        "frame_wavefront", "V2x49", bricks,
        {"slice": sum(held_bricks), "slab": 0})
    for key in counts:
        main_counts[key] += counts[key]
    # the wavefront's launches carry masks and, from the second round on,
    # the color and opacity of the brick before: hold each one
    bcalls = capture_slice_launches(lambda: vt.trace_volume(
        bscene, barena, W, H, slice_axes=saxes))
    wave_busy = []
    for i, call in enumerate(bcalls):
        rec = hold_slice(f"K4_wavefront_{i}", call)
        wave_busy.append(rec["busy_blocks"])
        del rec["color"], rec["w"]
    fb_march = vt.trace_volume(bscene, barena, W, H, slice_axes=())
    d = (fb_wave[:, :3] - fb_march[:, :3]).abs()
    ok = (all(a is not None for a in saxes) and float(d.mean()) < 2e-3
          and bricks.volumes[0].samples.shape
          == (split, split, split // 2 + 1))
    log("frame_wavefront_vs_march", slice_axes=[a and list(a) for a in saxes],
        brick=list(bricks.volumes[0].samples.shape),
        float_mean=float(d.mean()), float_max=float(d.max()),
        tolerance=dict(float_mean=2e-3), ok=ok)
    if not ok:
        raise SystemExit("the slice engine and the gather march disagree")

    # ---- against the JAX package's committed frames ----------------------
    gold = np.load(VOLUME_GOLDEN)
    gw, gh = int(gold["width"]), int(gold["height"])
    for kind in VOLUME_KINDS:
        gspec = make_volume_scene(kind, int(gold["n"]), gw, gh,
                                  eye=tuple(float(x) for x in gold["eye"]))
        ref = gold[f"fb_{kind}"]
        fb = volume_frame(gspec).cpu().numpy()
        dpix = np.abs(fb[:, :3] - ref[:, :3]).max(axis=1)
        cmp = dict(
            byte_frac=float(np.mean(img.to_rgb8(fb, gw, gh)
                                    != img.to_rgb8(ref, gw, gh))),
            event_frac=float(np.mean(dpix > 1e-5)), float_max=float(dpix.max()),
            finite=bool(np.isfinite(fb).all()))
        ok = (cmp["finite"] and cmp["byte_frac"] <= 1e-3
              and cmp["event_frac"] <= 1e-3)
        log("golden_volume", frame=kind, film=[gw, gh], brick=int(gold["n"]),
            vs_jax=cmp, tolerance=dict(byte_frac=1e-3, event_frac=1e-3),
            ok=ok)
        if not ok:
            raise SystemExit(f"golden_volume {kind} failed")

    # ---- times ------------------------------------------------------------
    occupancy = slice_occupancy()
    log("slice_occupancy", card=card, tile=list(sm.TILE),
        plane_batch=sm.PLANE_BATCH, **occupancy)
    launch = {k: time_slice_launch("K5" if k == "V256" else "K4_" + k,
                                   calls[k], card, held[k]["pairs"][0],
                                   occupancy, held[k]["busy_blocks"])
              for k in specs}
    # what the window ladder costs: the same 256^3 brick marched whole
    plan, c_in, w_in, _, fw = calls["V256"]
    time_slice_launch("K4_whole_V256",
                      (plan, c_in, w_in, plan.S.shape[0], fw), card,
                      held["V256"]["pairs"][0], occupancy)
    plain_ms = {k: cuda_ms(lambda: sm._run_plain(*calls[k][:4]), reps=1,
                           warmup=0) for k in ("plain", "V256")}
    log("time_plain", card=card, K4_plain=plain_ms["plain"],
        K5=plain_ms["V256"])
    for k in specs:
        time_frame("fast_" + k, lambda: fast(k), card, launch[k]["ms"], n)
    scene64 = scenes["plain"]
    arena64 = make_arena(rays["plain"], 0)
    time_frame("march_brick_V64", lambda: vt.trace_volume(
        scene64, arena64, W, H, max_rounds=16), card, 0.0, n, reps=4)
    bms = [cuda_ms(lambda: sm._launch(launch_), reps=20)
           for launch_ in [sm._prepare_launch(*c[:4], film_width=c[4])
                           for c in bcalls]]
    wrap_ms = [cuda_ms(lambda: sm._run_kernel(*c), reps=5) for c in bcalls]
    resident = occupancy["K4"]["blocks_per_sm"] * occupancy["K4"]["sms"]
    log("time_wavefront_launches", card=card, ms=bms, wrapper_ms=wrap_ms,
        rays_queued=[int(c[0].active.sum()) for c in bcalls],
        busy_blocks=wave_busy, waves=[b / resident for b in wave_busy])
    time_frame("wavefront_V2x49", lambda: vt.trace_volume(
        bscene, barena, W, H, slice_axes=saxes), card, sum(bms), n, reps=4)
    time_frame("wavefront_V2x49_march", lambda: vt.trace_volume(
        bscene, barena, W, H, slice_axes=()), card, 0.0, n, reps=2)

    def row(name, line, key, hold, launches):
        return dict(
            name=name, route="cuda",
            source="gravit_tpu_torch/csrc/slice_march.cu",
            replaces=f"gravit_tpu/ops/slice_march.py:{line}",
            launches=launches, max_abs_err=hold["max_abs_err"],
            ms=launch[key]["ms"], wrapper_ms=launch[key]["wrapper_ms"],
            plain_ms=plain_ms[key], bound_ms=launch[key]["bound_ms"],
            bound_by=launch[key]["bound_by"], library_ms=None)

    return [row("slice_march (whole brick, K4)", 716, "plain",
                held["plain"], main_counts["slice"]),
            row("slice_march (z-windows, K5)", 743, "V256", held["V256"],
                main_counts["slab"])]


# ---------------------------------------------------------------------------
# slice D part 2 and the facade: the api, render_hybrid, the volume domain
# scheduler

def traversal_counts() -> dict:
    return {"closest": bt.launches_closest, "any_hit": bt.launches_any_hit}


def slice_counts() -> dict:
    return {"slice": sm.launches_slice, "slab": sm.launches_slab}


def timed(fn, reps: int = 2) -> dict:
    """CUDA-event ms over `reps` runs of fn() (no warm-up: a frame builds
    its tables each time) beside the host clock of one more, and that
    run's host syncs (torch.cuda's sync debug mode)."""
    ms = cuda_ms(fn, reps=reps, warmup=0)
    t0 = time.perf_counter()
    _, stats = observe_frame(fn)
    return dict(ms=ms, host_ms=(time.perf_counter() - t0) * 1e3,
                host_syncs=stats["host_syncs"])


def api_flagship(seed: int = 0, bands: int = FLAGSHIP_BANDS,
                 width: int = 512, height: int = 512, depth: int = 1,
                 device=None) -> SceneSpec:
    """make_scene(seed)'s scene built through the port's api, as a GraviT
    user builds it (createMesh, addMeshVertices, addMeshTriangles 1-based,
    addMeshMaterial, finishMesh, addInstance, addPointLight, addCamera,
    addFilm, addRenderer with the Image schedule), renderer "flagship".
    Returns make_scene's own spec, the reference."""
    spec = make_scene(seed, bands, width, height, max_depth=depth)
    verts, faces = flagship_geometry(seed, bands)
    api.gvtInit(device=device)
    api.createMesh("flagship")
    api.addMeshVertices("flagship", len(verts), verts.ravel())
    api.addMeshTriangles("flagship", len(faces), (faces + 1).ravel())
    mat = Material()
    api.addMeshMaterial("flagship", mat.type, mat.kd, mat.alpha)
    api.finishMesh("flagship")
    api.addInstance("inst0", "flagship", np.eye(4, dtype=np.float32).ravel())
    light = spec.lights[0]
    api.addPointLight("light", light.position, light.color)
    cam = spec.camera
    api.addCamera("cam", cam.eye, cam.focus, cam.up, cam.fov, depth,
                  cam.samples, cam.jitter_window)
    api.addFilm("film", width, height, "flagship")
    api.addRenderer("flagship", int(api.Adapter.Embree),
                    int(api.Schedule.Image), "cam", "film")
    return spec


def api_frame(name: str) -> torch.Tensor:
    api.render(name)
    return Renderer.instance().framebuffer(name)


def facade_phases(dev, card: str, film: int = 512) -> dict:
    """The main path through the normal entry points: the flagship built
    and rendered through the api (depth 1 and 2) against render_surface,
    its image file; SimpleApp through the api's Domain schedule over a
    LocalGroup(4). Returns the K1/K2 launch counts of these frames."""
    counts = {"closest": 0, "any_hit": 0}
    for depth in (1, 2):
        Renderer.reset()
        t0 = time.time()
        spec = api_flagship(0, width=film, height=film, depth=depth,
                            device=dev)
        setup_s = time.time() - t0
        bt.reset_launch_counts()
        fb = api_frame("flagship")
        torch.cuda.synchronize()
        got = traversal_counts()
        for k in counts:
            counts[k] += got[k]
        ref = render_surface(spec.meshes, spec.instances, spec.lights,
                             spec.camera, device=dev)
        expect = {"closest": depth, "any_hit": 1}
        with tempfile.TemporaryDirectory() as tmp:
            path = Renderer.instance().write_image(
                "flagship", str(pathlib.Path(tmp) / "flagship"))
            ppm = img.read_ppm(path)
        ppm_equal = bool(np.array_equal(ppm, img.to_rgb8(fb, film, film)))
        bit_equal = bool(torch.equal(fb, ref))
        t = timed(lambda: api_frame("flagship"))
        cmp = compare_frames(fb, ref, film, film)
        ok = (bit_equal and got == expect and ppm_equal and cmp["finite"]
              and cmp["coverage"] > 0.3)
        log("facade_flagship", depth=depth, card=card, film=[film, film],
            triangles=spec.meshes[0].num_triangles, api_setup_s=setup_s,
            launches=got, expected=expect,
            bit_equal_to_render_surface=bit_equal, vs_render_surface=cmp,
            ppm_equal_to_rgb8=ppm_equal, **t, ok=ok)
        if not ok:
            raise SystemExit(f"facade_flagship depth {depth} failed")

    # SimpleApp through the api: Image on the card, then Domain over 4
    Renderer.reset()
    api_simple_app.build_scene(int(api.Schedule.Image), (film, film),
                               device=dev)
    ref = api_frame("Enzoschedule").clone()
    Renderer.reset()
    mesh4 = GroupMesh({"domains": LocalGroup(4, dev)})
    api_simple_app.build_scene(int(api.Schedule.Domain), (film, film),
                               mesh=mesh4)
    bt.reset_launch_counts()
    fb = api_frame("Enzoschedule")
    torch.cuda.synchronize()
    got = traversal_counts()
    cmp = compare_frames(fb, ref, film, film)
    t = timed(lambda: api_frame("Enzoschedule"))
    ok = cmp["finite"] and cmp["coverage"] > 0.05 and cmp["float_max"] <= 1e-5
    log("facade_simple_domain", card=card, film=[film, film], members=4,
        launches=got, vs_image_schedule=cmp, tolerance=dict(float_max=1e-5),
        **t, ok=ok)
    if not ok:
        raise SystemExit("facade_simple_domain failed")
    Renderer.reset()
    return counts


def hybrid_phase(dev, card: str, film: int = 512) -> dict:
    """render_hybrid on the many-domain scene at depth 2 over a
    LocalGroup(4) with the accel, every domain placed on member 0: the
    static render and the in-frame remap (chunks of 2 rounds, tau 1.5,
    RayWeightedSpread). K1 and K2 held on the first live launch of a member
    round after the first remap (a member with padded mesh slots if the
    new placement makes one), and timed. Every chunk must drop no ray (a
    chunk that drops is replayed: none may need to). Returns the launch
    counts and the holds."""
    spec = make_multi_scene(0, film, film, max_depth=2)
    n = 4
    t0 = time.time()
    dr = ds.DomainRenderer.build(
        spec.meshes, spec.instances, spec.lights,
        GroupMesh({"domains": LocalGroup(n, dev)}),
        owners=np.zeros(len(spec.instances), np.int32), use_accel=True)
    setup_s = time.time() - t0
    cam = spec.camera
    bt.reset_launch_counts()
    fb_static, load_static = dr.render(cam, return_load=True)
    torch.cuda.synchronize()
    got_static = traversal_counts()
    load_static = [int(x) for x in load_static]

    seen = {"remaps": 0, "chunks": []}
    orig_rep, orig_trace = ds.DomainRenderer.repartition, ds.trace_domain

    def repartition(self, resident):
        seen["remaps"] += 1
        out = orig_rep(self, resident)
        seen.setdefault("placements", []).append(
            [len(ds._local_mesh_ids(spec.instances, resident, d))
             for d in range(n)])
        return out

    def trace(*args, **kw):
        out = orig_trace(*args, **kw)
        seen["chunks"].append(dict(rounds=args[7], cap=kw["exchange_cap"],
                                   drops=int(out[1][0]),
                                   peak=int(out[1][1])))
        return out

    def hybrid():
        return dr.render_hybrid(cam, chunk=2, tau=1.5,
                                policy="RayWeightedSpread", return_load=True)

    ds.DomainRenderer.repartition, ds.trace_domain = repartition, trace
    try:
        bt.reset_launch_counts()
        fb, load = hybrid()
        torch.cuda.synchronize()
        got = traversal_counts()
    finally:
        ds.DomainRenderer.repartition, ds.trace_domain = orig_rep, orig_trace
    load = [int(x) for x in load]
    cmp = compare_frames(fb, fb_static, film, film)
    d = (fb[:, :3] - fb_static[:, :3]).abs().amax(dim=1)

    # the holds: member rounds after the first remap, tagged by whether
    # the member's tables have padded mesh slots
    state = {"remapped": False}

    def mark(self, resident):
        state["remapped"] = True
        return orig_rep(self, resident)

    ds.DomainRenderer.repartition = mark
    try:
        caught = capture_round_launches(
            lambda: hybrid(), "trace_round",
            lambda call, acc: None if not state["remapped"] else
            ("padded_member" if padded_slots(acc) else "member"))
    finally:
        ds.DomainRenderer.repartition = orig_rep
    tag = ("padded_member" if {("padded_member", "closest"),
                               ("padded_member", "any_hit")} <= set(caught)
           else "member")
    holds = {}
    for kind in ("closest", "any_hit"):
        if (tag, kind) not in caught:
            raise SystemExit(f"sched_hybrid: no live {kind} launch after "
                             "the remap")
        label = f"hybrid_after_remap/{tag}/{kind}"
        args = caught[(tag, kind)]
        rec = hold_traversal(args, "K2_sched" if kind == "any_hit"
                             else "K1_sched", launch=label)
        holds[label] = dict(max_abs_err=rec["max_abs_err"])
        res = bt.bvh_intersect_kernel(*args)
        ms = cuda_ms(lambda: bt.bvh_intersect_kernel(*args), reps=20)
        bound = bound_ms(args, res, rec)
        log("time_launch", launch=label, card=card, ms=ms,
            share_of_bound=bound["bound_ms"] / ms, **bound,
            rays=int(args[0].shape[0]),
            live_blocks=int((args[3] >= 0).sum()))
    t = timed(lambda: hybrid()[0], reps=1)
    drops = [c["drops"] for c in seen["chunks"]]
    fall = max(load_static) / max(1, max(load))
    ok = (seen["remaps"] >= 1 and fall >= 1.5 and cmp["float_max"] <= 1e-5
          and cmp["finite"] and got["closest"] > 0 and got["any_hit"] > 0
          and not any(drops))
    log("sched_hybrid", card=card, film=[film, film], depth=2, members=n,
        setup_s=setup_s, launches=got, launches_static=got_static,
        remaps=seen["remaps"],
        placements=seen.get("placements"), chunks=seen["chunks"],
        drops=sum(drops), load_static=load_static,
        load_hybrid=load, hot_load_fall=fall, vs_static=cmp,
        pixels_bit_equal=float((d == 0).float().mean()),
        held_tag=tag, tolerance=dict(float_max=1e-5, hot_load_fall=1.5),
        **t, ok=ok)
    if not ok:
        raise SystemExit("sched_hybrid failed")
    return dict(counts={k: got[k] + got_static[k] for k in got},
                held=holds)


def volume_domain_spec(n: int, parts: int, film: int = 512) -> VolumeSpec:
    """wavelet_volume(n) split into `parts` x-bricks under the volume bench
    camera (make_volume_scene's: eye 4n on the diagonal, fov 30, up +z)."""
    base = make_volume_scene("plain", n, film, film)
    eye4 = np.eye(4, dtype=np.float32)
    return VolumeSpec(volumes=bricked_wavelet(n, parts),
                      instances=[(i, eye4) for i in range(parts)],
                      camera=base.camera)


def volume_domain_frame(spec: VolumeSpec, members: int, dev,
                        impl=None) -> tuple:
    """(frame, drops) of trace_volume_domain over a LocalGroup(members)
    with the stacked scene's slice axes, as the api's Domain arm runs it."""
    stacked, owners = vd.partition_volume_scene(
        spec.volumes, spec.instances, members, device=dev)
    rays = spec.camera.generate_rays(dev, volume=True)
    cam = spec.camera
    return vd.trace_volume_domain(
        stacked, owners, make_arena(rays, 0), cam.film_width,
        cam.film_height, GroupMesh({"domains": LocalGroup(members, dev)}),
        slice_axes=vt.slice_axes_for(stacked, rays.direction),
        return_stats=True, impl=impl)


def capture_member_slices(fn, members: int) -> tuple:
    """Run fn() and return the slice launches it made, each tagged with the
    member round it ran in ((round, member, call)) and whether an exchange
    had run before that round; and the rounds after which an exchange
    ran. A round calls march_round once per member, in member order."""
    seen, state = [], {"march": -1, "exchanged_after": []}
    orig_m, orig_k, orig_x = vt.march_round, sm._run_kernel, \
        ds._merge_incoming

    def march(*args, **kw):
        state["march"] += 1
        return orig_m(*args, **kw)

    def kernel(*args):
        rnd, member = divmod(state["march"], members)
        seen.append(dict(round=rnd, member=member, call=args,
                         after_exchange=any(r < rnd for r in
                                            state["exchanged_after"])))
        return orig_k(*args)

    def merge(*args, **kw):
        rnd = state["march"] // members
        if rnd not in state["exchanged_after"]:
            state["exchanged_after"].append(rnd)
        return orig_x(*args, **kw)

    vt.march_round, sm._run_kernel, ds._merge_incoming = march, kernel, merge
    try:
        out = fn()
    finally:
        vt.march_round, sm._run_kernel, ds._merge_incoming = (
            orig_m, orig_k, orig_x)
    torch.cuda.synchronize()
    return out, seen, state["exchanged_after"]


def volume_domain_phases(dev, card: str, film: int = 512, small: int = 64,
                         big: int = 256) -> dict:
    """The volume domain scheduler on the card: (i) wavelet_volume(small)
    in 2 x-bricks over a LocalGroup(2) (K4), (ii) wavelet_volume(big) in 4
    x-bricks over a LocalGroup(4) (bricks over SLAB_BYTES: K5); each frame
    against the single-device trace_volume of the same bricks and its
    impl="plain" twin; a K4 and a K5 launch of a member round after an
    exchange held against the plain version. Then (ii) through the api's
    Domain schedule: bit-equal to the scheduler's frame. Returns the slice
    launch counts and the holds."""
    counts = {"slice": 0, "slab": 0}
    holds = {}
    frames = {}
    parts_ii = 4
    occupancy = slice_occupancy()
    for name, n, parts in (("i", small, 2), ("ii", big, parts_ii)):
        spec = volume_domain_spec(n, parts, film)
        brick = spec.volumes[0].samples
        brick_bytes = brick.nbytes
        scene1 = build_volume_scene(spec.volumes, spec.instances, device=dev)
        rays = spec.camera.generate_rays(dev, volume=True)
        sm.reset_launch_counts()
        single = vt.trace_volume(scene1, make_arena(rays, 0), film, film,
                                 slice_axes=vt.slice_axes_for(
                                     scene1, rays.direction))
        torch.cuda.synchronize()
        got_single = slice_counts()
        sm.reset_launch_counts()
        (fb, drops), launches, exchanged = capture_member_slices(
            lambda: volume_domain_frame(spec, parts, dev), parts)
        torch.cuda.synchronize()
        got = slice_counts()
        for k in counts:
            counts[k] += got[k] + got_single[k]
        frames[name] = fb
        plain, plain_drops = volume_domain_frame(spec, parts, dev,
                                                 impl="plain")
        vs_single = compare_frames(fb, single, film, film)
        vs_plain = compare_frames(fb, plain, film, film)
        kinds = {}
        for rec in launches:
            plan = rec["call"][0]
            kind = "K5" if plan.S.shape[0] > rec["call"][3] else "K4"
            kinds.setdefault(rec["member"], []).append(kind)
        # hold the first launch of a member round after an exchange
        after = [r for r in launches if r["after_exchange"]]
        if not after:
            raise SystemExit(f"sched_volume_domain ({name}): no slice launch "
                             "after an exchange")
        first = after[0]
        plan = first["call"][0]
        kname = "K5" if plan.S.shape[0] > first["call"][3] else "K4"
        rec = hold_slice(f"{kname}_volume_domain_{name}", first["call"])
        holds[f"{kname}/{name}"] = dict(
            max_abs_err=rec["max_abs_err"], round=first["round"],
            member=first["member"])
        time_slice_launch(f"{kname}_volume_domain_{name}", first["call"],
                          card, rec["pairs"][0], occupancy,
                          rec["busy_blocks"])
        t = timed(lambda: volume_domain_frame(spec, parts, dev)[0], reps=1)
        want = "slice" if name == "i" else "slab"
        ok = (int(drops) == 0 and int(plain_drops) == 0
              and vs_single["float_max"] <= 1e-5
              and vs_plain["byte_frac"] <= 1e-4 and vs_single["finite"]
              and vs_single["coverage"] > 0.05 and got[want] > 0)
        log("sched_volume_domain", config=name, card=card, film=[film, film],
            members=parts, brick=list(brick.shape),
            brick_mib=brick_bytes / 2**20,
            over_slab_bytes=brick_bytes > sm.SLAB_BYTES, launches=got,
            launches_single_device=got_single,
            kernels_by_member={str(k): v for k, v in sorted(kinds.items())},
            exchanges_after_rounds=exchanged, drops=int(drops),
            vs_single_device=vs_single, vs_plain=vs_plain,
            held=f"{kname} round {first['round']} member {first['member']}",
            tolerance=dict(float_max=1e-5, plain_byte_frac=1e-4), **t, ok=ok)
        if not ok:
            raise SystemExit(f"sched_volume_domain ({name}) failed")
        del scene1, single, plain

    # (ii) through the api: the Domain schedule over a LocalGroup(4)
    spec = volume_domain_spec(big, parts_ii, film)
    Renderer.reset()
    api.gvtInit(mesh=GroupMesh({"domains": LocalGroup(parts_ii, dev)}))
    db = api._db()
    for i, b in enumerate(spec.volumes):
        api.createVolume(f"vol{i}")
        db.find(f"vol{i}")["tf"] = b.tf
        api.addVolumeSamples(f"vol{i}", b.samples.reshape(-1),
                             list(b.counts), list(b.origin), list(b.spacing),
                             b.sampling_rate)
        api.addInstance(f"inst{i}", f"vol{i}",
                        np.eye(4, dtype=np.float32).ravel())
    cam = spec.camera
    api.addCamera("cam", cam.eye, cam.focus, cam.up, cam.fov, 1,
                  cam.samples, cam.jitter_window)
    api.addFilm("film", film, film, "vol")
    api.addRenderer("vr", int(api.Adapter.Pvol), int(api.Schedule.Domain),
                    "cam", "film", volume=True)
    sm.reset_launch_counts()
    fb = api_frame("vr")
    torch.cuda.synchronize()
    got = slice_counts()
    for k in counts:
        counts[k] += got[k]
    equal = bool(torch.equal(fb, frames["ii"]))
    t = timed(lambda: api_frame("vr"), reps=1)
    ok = equal and got["slab"] > 0
    log("facade_volume_domain", card=card, film=[film, film],
        members=parts_ii, launches=got, bit_equal_to_scheduler=equal,
        vs_scheduler=compare_frames(fb, frames["ii"], film, film), **t,
        ok=ok)
    Renderer.reset()
    if not ok:
        raise SystemExit("facade_volume_domain failed")
    return dict(counts=counts, held=holds)


# ---------------------------------------------------------------------------
# slice E: training

TRAIN_ROUNDS = 4
# the card's gradient against the CPU's, relative in the 2-norm per leaf:
# the two round the same operations alike but for the accumulation order
# of the scatter-adds (atomics on the card) and the transcendentals' last
# ulp, and a grazing ray's hit can go the other way (measured at most
# 4.0e-6, kd, on an H100 at 512^2)
GRAD_CPU_TOL = 1e-4
# the sharded step's gradient against the single-device one
SHARD_TOL = 1e-5


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """|a - b| / |b| in the 2-norm, in float64, on the host."""
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


def train_fixture(dev, film: int):
    """SimpleApp at film^2 (the scene of tests/test_gradients.py, full
    width), its camera wavefront, a uniform random target from a seed."""
    spec = simple_app(film, film)
    scene = build_scene(spec.meshes, spec.instances, spec.lights, device=dev)
    arena = make_arena(spec.camera.generate_rays(dev), scene.num_lights)
    target = torch.as_tensor(np.random.default_rng(3).uniform(
        size=(film * film, 4)).astype(np.float32), device=dev)
    return scene, arena, target


def loss_and_grads(scene, arena, target, film: int) -> tuple:
    """(loss, gradients) of train.loss_fn at the scene's own params,
    rounds TRAIN_ROUNDS."""
    p = train.params_from_scene(scene)
    loss = train.loss_fn(p, scene, arena, target, film, film, TRAIN_ROUNDS)
    loss.backward()
    return float(loss.detach()), [x.grad for x in p]


def directional_fd(f, p: list, dps: list, eps: float) -> list:
    """[(autograd's derivative of f at p along dp, central differences)
    for each dp in dps], from one gradient."""
    q = [x.detach().clone().requires_grad_(True) for x in p]
    g = torch.autograd.grad(f(q), q, allow_unused=True)
    out = []
    for dp in dps:
        analytic = sum(float((ga * da).sum()) for ga, da in zip(g, dp)
                       if ga is not None)
        with torch.no_grad():
            fd = (float(f([x + eps * d for x, d in zip(p, dp)]))
                  - float(f([x - eps * d for x, d in zip(p, dp)])))
        out.append((analytic, fd / (2 * eps)))
    return out


def measured(fn) -> tuple:
    """(fn(), {CUDA-event ms, peak MiB, host syncs}) of one call."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out, stats = observe_frame(fn)
    stop.record()
    torch.cuda.synchronize()
    return out, dict(ms=start.elapsed_time(stop),
                     peak_mb=torch.cuda.max_memory_allocated() / 2**20,
                     host_syncs=stats["host_syncs"])


def fd_ok(analytic: float, fd: float, rtol: float, atol: float = 1e-6):
    return (np.isfinite(analytic) and np.isfinite(fd)
            and abs(analytic - fd) <= atol + rtol * abs(fd))


def kernel_counts() -> dict:
    return {**traversal_counts(), **slice_counts()}


def reset_kernel_counts() -> None:
    bt.reset_launch_counts()
    sm.reset_launch_counts()


def split_step(step_parts, reps: int = 3) -> dict:
    """Mean CUDA-event ms of a train step's three parts over `reps` steps
    (after one untimed step): forward (the loss), backward, optimiser.
    `step_parts(ev)` records ev[0..3] around them."""
    step_parts()
    totals = np.zeros(3)
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        step_parts(ev)
        torch.cuda.synchronize()
        totals += [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]
    return dict(zip(("forward_ms", "backward_ms", "optimizer_ms"),
                    (totals / reps).tolist()))


def step_record(step, p, opt, scene, arena, target) -> dict:
    """What one call of a train step costs on the card: CUDA-event ms per
    step over 3, and of one more its host clock, host syncs and peak
    memory (measured), and torch.profiler's operator count, launches and
    busy device time."""
    def run():
        return step(p, opt, scene, arena, target)

    run()
    ms = cuda_ms(run, reps=3, warmup=0)
    t0 = time.perf_counter()
    _, one = measured(run)
    host_ms = (time.perf_counter() - t0) * 1e3
    prof = host_counts(run, reps=1)
    return dict(ms=ms, host_ms=host_ms, host_syncs=one["host_syncs"],
                peak_mb=one["peak_mb"], aten_ops=prof["aten_ops"],
                cuda_launches=prof["kernel_launches"],
                device_ms=prof["device_ms"],
                idle_share=(None if prof["device_ms"] is None
                            else 1.0 - prof["device_ms"] / ms),
                top_kernels=prof["top_kernels"])


def train_simple_phase(dev, card: str, film: int = 512) -> dict:
    """train_simple: SimpleApp at film^2, 4 rounds, brute intersection (no
    TPU kernel lies on the training path). One step's loss and gradient on
    the card against the same on the CPU; the directional finite
    difference along kd (test_gradients.py: eps 3e-3, rtol 0.15); the
    default step's time split into forward, backward and optimiser, peak
    memory, syncs and launches; 25 Adam steps at lr 5e-2 from light_color
    x 0.3 towards the scene's own frame must bring the loss below 0.66 x
    its start. Returns the card's loss and gradients, and the fixture."""
    scene, arena, target = train_fixture(dev, film)
    reset_kernel_counts()
    (loss_c, g_c), grad_cost = measured(
        lambda: loss_and_grads(scene, arena, target, film))
    t0 = time.perf_counter()
    cpu = train_fixture("cpu", film)
    loss_h, g_h = loss_and_grads(*cpu, film)
    cpu_s = time.perf_counter() - t0
    del cpu
    vs_cpu = {n: rel_err(a, b) for n, a, b in
              zip(train.TrainParams._fields, g_c, g_h)}
    loss_rel = abs(loss_c - loss_h) / abs(loss_h)

    p0 = train.params_from_scene(scene)
    dp = [torch.zeros_like(x) for x in p0]
    dp[1] = torch.as_tensor(np.random.default_rng(0).standard_normal(
        tuple(p0.kd.shape)).astype(np.float32), device=dev)

    def f(q):
        return train.loss_fn(train.TrainParams(*q), scene, arena, target,
                             film, film, TRAIN_ROUNDS)

    (analytic, fd), = directional_fd(f, list(p0), [dp], 3e-3)

    step, optimizer = train.make_train_step(rounds=TRAIN_ROUNDS,
                                            width=film, height=film)
    p = train.params_from_scene(scene)
    opt = optimizer(list(p))

    def parts(ev=None):
        rec = (lambda i: ev[i].record()) if ev else (lambda i: None)
        opt.zero_grad(set_to_none=True)
        rec(0)
        loss = train.loss_fn(p, scene, arena, target, film, film,
                             TRAIN_ROUNDS)
        rec(1)
        loss.backward()
        rec(2)
        opt.step()
        rec(3)

    split = split_step(parts)
    rec = step_record(step, p, opt, scene, arena, target)

    with torch.no_grad():
        own = train.render_with_params(scene, train.params_from_scene(scene),
                                       arena, film, film, TRAIN_ROUNDS)
    q = train.params_from_scene(scene)
    q = q._replace(light_color=(q.light_color.detach() * 0.3)
                   .requires_grad_(True))
    step5, opt5 = train.make_train_step(train.adam(5e-2), TRAIN_ROUNDS,
                                        film, film)
    o = opt5(list(q))
    losses = []
    t0 = time.perf_counter()
    for _ in range(25):
        q, o, loss = step5(q, o, scene, arena, own)
        losses.append(float(loss))
    fall_s = time.perf_counter() - t0
    launches = kernel_counts()
    ok = (all(v <= GRAD_CPU_TOL for v in vs_cpu.values())
          and loss_rel <= 1e-5 and fd_ok(analytic, fd, 0.15)
          and abs(analytic) > 1e-8 and losses[-1] < 0.66 * losses[0]
          and all(np.isfinite(losses)) and not any(launches.values()))
    log("train_simple", card=card, film=[film, film], rounds=TRAIN_ROUNDS,
        triangles=scene.num_triangles, arena=arena.capacity,
        loss=loss_c, loss_cpu=loss_h, loss_rel_vs_cpu=loss_rel,
        grad_rel_vs_cpu=vs_cpu, tolerance=dict(grad_rel=GRAD_CPU_TOL,
                                                loss_rel=1e-5),
        first_grad=grad_cost, cpu_grad_s=cpu_s,
        fd_kd=dict(analytic=analytic, fd=fd, eps=3e-3, rtol=0.15),
        step=dict(**split, **rec), losses=[losses[0], losses[-1]],
        loss_ratio=losses[-1] / losses[0], adam_25_steps_s=fall_s,
        port_kernel_launches=launches, ok=ok)
    if not ok:
        raise SystemExit("train_simple failed")
    return dict(loss=loss_c, grads=g_c, fixture=(scene, arena, target))


def train_sharded_phase(dev, card: str, single: dict,
                        film: int = 512) -> None:
    """train_sharded: the data-parallel step over a LocalGroup(4) on the
    card, from the same params and target as train_simple's gradient: the
    loss equal to the single-device loss (1e-6 relative) and each
    gradient within SHARD_TOL of it, not 4 x it; its time, peak memory,
    syncs. Then a one-rank NCCL DistGroup step against LocalGroup(1), both
    with torch's deterministic algorithms (the card's scatter-adds
    otherwise accumulate in no fixed order): bit-equal loss, gradients and
    updated params."""
    scene, arena, target = single["fixture"]
    step, optimizer = train.make_sharded_train_step(
        LocalGroup(4, dev), rounds=TRAIN_ROUNDS, width=film, height=film)
    p = train.params_from_scene(scene)
    opt = optimizer(list(p))
    reset_kernel_counts()
    _, _, loss = step(p, opt, scene, arena, target)
    grads = [x.grad.detach().clone() for x in p]
    vs_single = {n: rel_err(a, b) for n, a, b in
                 zip(train.TrainParams._fields, grads, single["grads"])}
    loss_rel = abs(float(loss) - single["loss"]) / abs(single["loss"])
    rec = step_record(step, p, opt, scene, arena, target)
    launches = kernel_counts()

    def world1(group) -> tuple:
        st, mk = train.make_sharded_train_step(
            group, rounds=TRAIN_ROUNDS, width=film, height=film)
        q = train.params_from_scene(scene)
        q, o, ls = st(q, mk(list(q)), scene, arena, target)
        return ls, [x.grad for x in q], list(q)

    torch.use_deterministic_algorithms(True)
    try:
        local = world1(LocalGroup(1, dev))
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        parallel.initialize(f"localhost:{port}", 1, 0, backend="nccl")
        try:
            nccl = world1(parallel.DistGroup(None, dev))
        finally:
            parallel.shutdown()
    finally:
        torch.use_deterministic_algorithms(False)
    bit_equal = bool(torch.equal(local[0], nccl[0])) and all(
        torch.equal(a, b) for a, b in zip(local[1] + local[2],
                                          nccl[1] + nccl[2]))
    ok = (loss_rel <= 1e-6 and all(v <= SHARD_TOL
                                   for v in vs_single.values())
          and bit_equal and not any(launches.values()))
    log("train_sharded", card=card, film=[film, film], members=4,
        rounds=TRAIN_ROUNDS, loss=float(loss), loss_single=single["loss"],
        loss_equal=float(loss) == single["loss"], loss_rel=loss_rel,
        grad_rel_vs_single=vs_single, tolerance=dict(grad_rel=SHARD_TOL,
                                                     loss_rel=1e-6),
        step=rec, nccl_world1_bit_equal_local1=bit_equal,
        port_kernel_launches=launches, ok=ok)
    if not ok:
        raise SystemExit("train_sharded failed")


def train_volume_phase(dev, card: str, film: int = 512) -> None:
    """train_volume: V64 (make_volume_scene("plain"), the 64^3 wavelet
    brick at film^2). The image sum's gradient wrt the samples through
    trace_volume(unroll=True, max_rounds=4) (the gather march), and wrt
    the samples and the colour LUT through slice_march_reference (the
    slice engine's plain version), each against central differences
    along a random direction (eps 1e-2, rtol 0.1, test_gradients.py);
    each check's cost (one gradient and two forwards a direction: CUDA-event
    ms, peak memory, host syncs). The image sums are reduced in
    float64: at 512^2 a float32 sum's rounding is larger than the
    differences the central difference takes."""
    spec = make_volume_scene("plain", 64, film, film)
    scene = build_volume_scene(spec.volumes, spec.instances, device=dev)
    rays = spec.camera.generate_rays(dev, volume=True)
    arena = make_arena(rays, 0)
    s0 = scene.vol_samples[0].detach()
    rng = np.random.default_rng(0)
    out, cost = {}, {}
    reset_kernel_counts()

    def march(samples):
        fb = vt.trace_volume(dataclasses.replace(scene, vol_samples=(
            samples,)), arena, film, film, max_rounds=4, unroll=True)
        return fb[:, :3].double().sum()

    d = torch.as_tensor(rng.standard_normal(tuple(s0.shape)).astype(
        np.float32), device=dev)
    (out["march"],), cost["march"] = measured(lambda: directional_fd(
        lambda q: march(q[0]), [s0], [[d]], 1e-2))

    vol = spec.volumes[0]
    o, dirs = rays.origin, rays.direction
    n = o.shape[0]
    axis, flip = sm.choose_slice_axis(dirs.mean(0).cpu().numpy())
    meta = dict(axis=axis, flip=flip, step=float(vol.step_size()),
                base_step=float(vol.spacing.min()),
                low=float(vol.tf.low), high=float(vol.tf.high),
                origin=tuple(float(x) for x in vol.origin),
                spacing=tuple(float(x) for x in vol.spacing))
    cl0 = torch.as_tensor(vol.tf.color_lut, device=dev)
    ol = torch.as_tensor(vol.tf.opacity_lut, device=dev)
    active = torch.ones((n,), dtype=torch.bool, device=dev)
    zc, zw = torch.zeros((n, 3), device=dev), torch.zeros((n,), device=dev)

    def slice_sum(q):
        c, w, _ = sm.slice_march_reference(o, dirs, active, zc, zw, q[0],
                                           q[1], ol, **meta)
        return (c * w[:, None]).double().sum()

    dS = torch.as_tensor(rng.standard_normal(tuple(s0.shape)).astype(
        np.float32), device=dev)
    dC = torch.as_tensor(rng.standard_normal(tuple(cl0.shape)).astype(
        np.float32), device=dev)
    (out["slice_samples"], out["slice_lut"]), cost["slice"] = measured(
        lambda: directional_fd(slice_sum, [s0, cl0],
                               [[dS, torch.zeros_like(cl0)],
                                [torch.zeros_like(s0), dC]], 1e-2))
    launches = kernel_counts()
    checks = {k: dict(analytic=out[k][0], fd=out[k][1],
                      ok=bool(fd_ok(*out[k], rtol=0.1, atol=0.0)
                              and abs(out[k][0]) > 0))
              for k in ("march", "slice_samples", "slice_lut")}
    ok = all(c["ok"] for c in checks.values()) and not any(launches.values())
    log("train_volume", card=card, film=[film, film], brick=list(s0.shape),
        rounds=4, fd=checks, eps=1e-2, rtol=0.1, card_cost=cost,
        port_kernel_launches=launches, ok=ok)
    if not ok:
        raise SystemExit("train_volume failed")


def checkpoint_phase(dev, card: str, fixture: tuple, film: int = 512):
    """checkpoint: two Adam steps on the card, save (from card tensors),
    restore onto the card into a fresh optimiser; the third step of the
    uninterrupted and of the resumed run, both with torch's deterministic
    algorithms, must give bit-equal params, count and moments."""
    scene, arena, target = fixture
    step, optimizer = train.make_train_step(train.adam(5e-2), TRAIN_ROUNDS,
                                            film, film)
    p = train.params_from_scene(scene)
    opt = optimizer(list(p))
    for _ in range(2):
        p, opt, _ = step(p, opt, scene, arena, target)
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / "train_state"
        t0 = time.perf_counter()
        checkpoint.save(path, p, opt, step=2)
        save_ms = (time.perf_counter() - t0) * 1e3
        size = path.with_suffix(".npz").stat().st_size
        t0 = time.perf_counter()
        q, st, k = checkpoint.restore(path, device=dev)
        restore_ms = (time.perf_counter() - t0) * 1e3
    on_card = all(x.device.type == torch.device(dev).type
                  for x in list(q) + list(st.mu) + list(st.nu))
    resumed = train.load_adam_state(optimizer(list(q)), q, st)
    torch.use_deterministic_algorithms(True)
    try:
        p, opt, loss_p = step(p, opt, scene, arena, target)
        (q, resumed, loss_q), cost = measured(
            lambda: step(q, resumed, scene, arena, target))
    finally:
        torch.use_deterministic_algorithms(False)
    a, b = train.adam_state(opt, p), train.adam_state(resumed, q)
    equal = (bool(torch.equal(loss_p, loss_q)) and int(a.count)
             == int(b.count) == k + 1 and all(
                 torch.equal(x, y) for x, y in zip(
                     list(p) + list(a.mu) + list(a.nu),
                     list(q) + list(b.mu) + list(b.nu))))
    ok = equal and on_card
    log("checkpoint", card=card, film=[film, film], saved_step=k,
        file_bytes=size, save_ms=save_ms, restore_ms=restore_ms,
        restored_on_card=on_card, next_step_bit_equal=equal,
        resumed_step_deterministic=cost, ok=ok)
    if not ok:
        raise SystemExit("checkpoint: the resumed step differs")


DRYRUN_GOLDEN = ROOT / "tests" / "data" / "torch_port_train_golden.npz"


def dryrun_phase(dev, card: str) -> dict:
    """dryrun: dryrun_multichip(4) on the card (a (2, 2) layout of
    LocalGroups at 16^2: domain-scheduled, accel, replica-routed and
    volume-domain forwards, one sharded train step). The accel and
    replica-routed frames are held against the brute domain frame (max |d|
    <= 1e-5, the bound of the scheduler frames: the deposit's index_add_
    sums in any order on the card), every frame sum within 1e-5 relative
    of the JAX dry run's (the golden of tests/test_torch_dryrun.py) and the
    loss within 1e-6; a live K1 and K2 launch of an accel member's round
    is held against the plain versions. Returns the K1/K2 launches of the
    main run and the holds' errors."""
    reset_kernel_counts()
    (out, frames), cost = measured(
        lambda: dryrun.dryrun_multichip(4, device=dev, return_frames=True))
    counts = traversal_counts()
    brute = frames["domain_forward"]
    vs_brute = {name: float((frames[name] - brute).abs().max())
                for name in ("accel_domain_forward", "replica_routed_forward")}
    bit_equal = {name: bool(torch.equal(frames[name], brute))
                 for name in vs_brute}
    with np.load(DRYRUN_GOLDEN) as gold:
        ref = {key: float(gold[f"dryrun_{key}"]) for key in (
            "domain_forward", "accel_domain_forward",
            "replica_routed_forward", "volume_domain_forward", "train_loss")}
    vs_jax = {key: out[key] - r for key, r in ref.items()}
    ok = (np.isfinite(out["train_loss"]) and counts["closest"] > 0
          and counts["any_hit"] > 0
          and all(d <= 1e-5 for d in vs_brute.values())
          and all(abs(d) <= 1e-5 * abs(ref[k]) for k, d in vs_jax.items()
                  if k != "train_loss")
          and abs(vs_jax["train_loss"]) <= 1e-6)
    log("dryrun", card=card, **cost, launches=counts, **out,
        accel_vs_brute_max_abs=vs_brute, bit_equal_to_brute=bit_equal,
        minus_jax_dryrun=vs_jax, ok=ok)
    if not ok:
        raise SystemExit("dryrun failed")
    del frames, brute
    held = hold_sched_launches(
        "dryrun_accel", lambda: dryrun.dryrun_multichip(4, device=dev),
        "trace_round", lambda call, acc: "accel_member" if acc is not None
        else None,
        {("accel_member", "closest"):
             "an accel domain member's round (2 members of a (2, 2) layout)",
         ("accel_member", "any_hit"): "the same round's shadow blocks"})
    return dict(counts=counts, held=held)


def train_phases(dev, card: str, film: int = 512) -> dict:
    """Slice E's phases (train_simple, train_sharded, train_volume,
    checkpoint, dryrun). Returns the dry run's K1/K2 launches and the
    holds' errors."""
    single = train_simple_phase(dev, card, film)
    train_sharded_phase(dev, card, single, film)
    checkpoint_phase(dev, card, single["fixture"], film)
    del single
    train_volume_phase(dev, card, film)
    return dryrun_phase(dev, card)


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
    k1g1 = hold_traversal(k1g1_args, "K1_gen1")
    k2d2 = hold_traversal(k2d2_args, "K2_depth2")
    # F1: rays aimed exactly at vertices and at the floor's rim
    hold_vertices(k1_args, spec.meshes[0])
    native_phase(dev, spec, scene, k1_args)
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
    k3 = hold_traversal(k3_args, "K3")
    # the main path over that table: one frame through the entry point
    bt.reset_launch_counts()
    fb = render_surface(big.meshes, big.instances, big.lights, big.camera,
                        device="cuda")
    torch.cuda.synchronize()
    k3_launches = bt.launches_closest
    cover = float((fb[:, :3].sum(dim=1) > 0).float().mean())
    ok = (k3_launches == 1 and bt.launches_any_hit == 1 and cover > 0.3
          and bool(torch.isfinite(fb).all()))
    log("frame_K3", launches={"closest": k3_launches,
                              "any_hit": bt.launches_any_hit},
        expected={"closest": 1, "any_hit": 1}, coverage=cover, ok=ok)
    if not ok:
        raise SystemExit("the frame over the 6 MB table failed")
    del big_scene, big_accel, cap3, a3, lanes, fb

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
    occupancy = bt.kernel_occupancy()
    for name, args, held in (
            ("K1_gen0", k1_args, k1), ("K1_gen1", k1g1_args, k1g1),
            ("K2_depth1", k2_args, k2), ("K2_depth2", k2d2_args, k2d2),
            ("K3_subset", k3_args, k3)):
        res = bt.bvh_intersect_kernel(*args)
        ms = cuda_ms(lambda: bt.bvh_intersect_kernel(*args), reps=20)
        bound = bound_ms(args, res, held)
        launch[name] = dict(
            ms=ms, share_of_bound=bound["bound_ms"] / ms,
            share_of_packet_bound=bound["packet_bound_ms"] / ms, **bound,
            rays=int(args[0].shape[0]),
            live_blocks=int((args[3] >= 0).sum()), **held["walk"])
        log("time_launch", launch=name, card=card, **launch[name])
        log("launch_shape", launch=name, **launch_shape(res, occupancy))
        if not bound["bound_ms"] <= ms:
            raise SystemExit(f"{name}: faster than its bound")
    plain_ms = {name: cuda_ms(lambda: bt.bvh_intersect_plain(*args), reps=1,
                              warmup=0)
                for name, args in (("K1_gen0", k1_args),
                                   ("K2_depth1", k2_args),
                                   ("K3_subset", k3_args))}
    log("time_plain", card=card, **plain_ms)
    # a frame's device time against its launches (the rest is PyTorch glue
    # and any wait on the host); host_ms is the wall clock per frame and
    # enqueue_ms the part of it before the host waits for the card;
    # graph_ms is the frame replayed from a CUDA graph (no host pacing)
    in_frame = {1: ("K1_gen0", "K2_depth1"),
                2: ("K1_gen0", "K1_gen1", "K2_depth2")}
    for depth in (1, 2):
        def frame():
            return trace_image_fast(scene, rays[depth], W, H, accel=accel,
                                    max_depth=depth)

        ms = cuda_ms(frame, reps=10)
        t0 = time.perf_counter()
        for _ in range(5):
            frame()
        enqueue_ms = (time.perf_counter() - t0) * 1e3 / 5
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / 5
        kernel_ms = sum(launch[k]["ms"] for k in in_frame[depth])
        replay_ms, replay_equal = graph_ms(frame)
        log("time_frame", depth=depth, card=card, ms=ms, host_ms=host_ms,
            enqueue_ms=enqueue_ms, kernel_ms=kernel_ms,
            kernel_share=kernel_ms / ms, rays_per_s=W * H / ms * 1e3,
            graph_ms=replay_ms, graph_equals_eager=replay_equal,
            kernel_share_of_graph=kernel_ms / replay_ms,
            **host_counts(frame))
        if not replay_equal:
            raise SystemExit(f"depth {depth}: the graph replay differs")
    del scene, accel, rays, frames

    # ---- slice C: the multi-instance and looped tracers ------------------
    multi = multi_phases(dev, card, occupancy)
    for k in main_counts:
        main_counts[k] += multi["counts"][k]
    slab_row = instance_slab_phase(dev, card)
    # ---- slice D: the schedulers ----------------------------------------
    sched = sched_phases(dev, card)
    for k in main_counts:
        main_counts[k] += sched["counts"][k]
    # ---- slice D part 2 and the facade: the api, render_hybrid ----------
    facade = facade_phases(dev, card)
    hybrid = hybrid_phase(dev, card)
    for k in main_counts:
        main_counts[k] += facade[k] + hybrid["counts"][k]
    sched["held"].update(hybrid["held"])
    # the scheduler holds' errors count with the kernel they held
    sched_err = {kind: max([h["max_abs_err"] for label, h in
                            sched["held"].items() if label.endswith(kind)]
                           or [0.0])
                 for kind in ("closest", "any_hit")}
    kernel_rows = [dict(
        name=name, route="cuda", source="gravit_tpu_torch/csrc/bvh_traverse.cu",
        replaces="gravit_tpu/ops/pallas_bvh.py:35", launches=launches,
        max_abs_err=max(rec["max_abs_err"], sched_err.get(kind, 0.0)),
        ms=launch[key]["ms"],
        plain_ms=plain_ms[key], bound_ms=launch[key]["bound_ms"],
        bound_by=launch[key]["bound_by"], library_ms=None,
        packet_bound_ms=launch[key]["packet_bound_ms"])
        for name, key, rec, launches, kind in (
            ("bvh_traverse (closest hit, K1)", "K1_gen0", k1,
             main_counts["closest"], "closest"),
            ("bvh_traverse (any hit, K2)", "K2_depth1", k2,
             main_counts["any_hit"], "any_hit"),
            ("bvh_traverse (table over 6 MB, K3)", "K3_subset", k3,
             k3_launches, None))]
    kernel_rows.append(slab_row)

    volume_rows = volume_phases(dev, card)
    # ---- the volume domain scheduler, and through the api ---------------
    vdom = volume_domain_phases(dev, card)
    for row, key, kid in ((volume_rows[0], "slice", "K4"),
                          (volume_rows[1], "slab", "K5")):
        row["launches"] += vdom["counts"][key]
        row["max_abs_err"] = max([row["max_abs_err"]] + [
            h["max_abs_err"] for label, h in vdom["held"].items()
            if label.startswith(kid)])
    kernel_rows += volume_rows
    # ---- slice E: training, checkpointing and the dry run ----------------
    dry = train_phases(dev, card)
    for row, key in zip(kernel_rows[:2], ("closest", "any_hit")):
        row["launches"] += dry["counts"][key]
        row["max_abs_err"] = max([row["max_abs_err"]] + [
            h["max_abs_err"] for label, h in dry["held"].items()
            if label.endswith(key)])
    log("done", seconds=time.time() - t_start)

    print(json.dumps({"kernels": kernel_rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
