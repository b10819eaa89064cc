"""The renderer facade, counterpart of gravit_tpu/render/renderer.py:
gvtRenderer (render/Renderer.cpp:37-115).

`render_surface` and `render_volume` are the single-device branches of the
reference's Renderer.render, one function each, and each a build half
(`build_surface`, `build_volume_scene`) and a trace half (`trace_surface`,
`trace_volume_scene`). `Renderer` is the facade the api drives:
`render(name)` reads the Scheduler node, builds the camera
and the scene from the RenderContext database and picks the arm by the
scheduler enum and the layout's member count; `framebuffer(name)` and
`write_image(name)` (PPM, the rank-0 write of IceTComposite.cpp:119-157)
give the frame out.

Known differences from the JAX package, by design:
  * The member count is that of the layout the facade holds (a Mesh handed
    to the Renderer or to api.gvtInit, else parallel.global_mesh(): the
    torch.distributed world, one member in one process), not the JAX
    package's len(jax.devices()).
  * The BVH rule: the traversal kernel runs for meshes of 512 triangles or
    more on every device (its plain version on the CPU), where the JAX
    package's _maybe_accel takes brute force off a TPU. The domain arm
    builds no accel, as in the JAX package.
  * The surface arms gate on 1 <= max_depth: max_depth 0 raises instead of
    reaching the reference's IndexError.
  * The scene cache: the JAX package compiles the meshes and builds the
    scene and its BVH on every render, and builds the volume scene on
    every volume render. The single-device surface and volume arms here
    keep their last build and reuse it while the database's meshes and
    volumes (by object and revision; a volume's transfer function,
    isovalues, slices and subgrids too), instances, lights and the device
    are unchanged, as GraviT's ImageTracer reuses a built adapter from its
    adapter cache (ImageTracer.h:184-233). A camera or film change reuses;
    any other change rebuilds, with frames bit-equal to a fresh Renderer's.
    `render_surface`, `render_volume` and the domain arms build on every
    call.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np

from gravit_tpu_torch.accel.scene_accel import build_scene_bvh
from gravit_tpu_torch.core.context import RenderContext
from gravit_tpu_torch.core.timing import span, spanned
from gravit_tpu_torch.device import resolve_device
from gravit_tpu_torch.parallel import global_mesh
from gravit_tpu_torch.render.scene_build import Instance, build_scene
from gravit_tpu_torch.render.tracer import (MAX_FAST_DEPTH, make_arena,
                                            trace_image, trace_image_fast,
                                            trace_image_fast_multi)
from gravit_tpu_torch.render.volume_scene import (VolumeSceneData,
                                                  build_volume_scene)
from gravit_tpu_torch.render.volume_tracer import (can_slice_march,
                                                   slice_axes_for,
                                                   trace_volume,
                                                   trace_volume_fast)
from gravit_tpu_torch.scene import image as image_lib
from gravit_tpu_torch.scene.camera import PerspectiveCamera
from gravit_tpu_torch.scene.light import (Light, ambient_light, area_light,
                                          point_light)
from gravit_tpu_torch.scene.mesh import CompiledMesh
from gravit_tpu_torch.scene.volume import Volume
from gravit_tpu_torch.schedule.domain_sched import (DomainRenderer, Regrow,
                                                    first_cap)
from gravit_tpu_torch.schedule.volume_domain import (partition_volume_scene,
                                                     trace_volume_domain)

# the scheduler enum of render/Types.h:50-60 (api.Schedule) that shards
# domains over the layout's members
DOMAIN_SCHEDULES = (1, 3)               # Domain, AsyncDomain

# meshes below this many triangles take the brute intersector
# (renderer.py:235-242)
BVH_MIN_TRIANGLES = 512


def _gate_depth(camera: PerspectiveCamera) -> None:
    """The surface arms' gate, before any build: max_depth 0 raises here
    instead of reaching the reference's IndexError."""
    if camera.max_depth < 1:
        raise NotImplementedError(
            f"max_depth {camera.max_depth}: a frame needs max_depth >= 1")


def build_surface(meshes: Sequence[CompiledMesh],
                  instances: Sequence[Instance], lights: Sequence[Light],
                  device=None):
    """The build half of render_surface: (the scene, the BVH when the
    meshes hold 512 or more triangles, else None) on `device`. Calls
    build_scene and build_scene_bvh through this module's globals."""
    device = resolve_device(device)
    with span("facade.build_scene"):
        scene = build_scene(meshes, instances, lights, device=device)
    accel = None
    if sum(m.num_triangles for m in meshes) >= BVH_MIN_TRIANGLES:
        with span("facade.build_bvh"):
            accel = build_scene_bvh(meshes, device=device)
    return scene, accel


def trace_surface(scene, accel, camera: PerspectiveCamera, device=None,
                  impl=None):
    """The trace half of render_surface: one frame of a built scene."""
    device = resolve_device(device)
    rays = camera.generate_rays(device)
    W, H = camera.film_width, camera.film_height
    if scene.num_instances == 1 and camera.max_depth <= MAX_FAST_DEPTH:
        return trace_image_fast(scene, rays, W, H, accel=accel,
                                samples=camera.samples,
                                max_depth=camera.max_depth, impl=impl)
    if camera.max_depth <= 1:
        return trace_image_fast_multi(scene, rays, W, H, accel=accel,
                                      samples=camera.samples, impl=impl)
    return trace_image(scene, make_arena(rays, scene.num_lights), W, H,
                       accel=accel, impl=impl)


def render_surface(meshes: Sequence[CompiledMesh],
                   instances: Sequence[Instance], lights: Sequence[Light],
                   camera: PerspectiveCamera, device=None, impl=None):
    """Build the scene (and the BVH when the meshes hold 512 or more
    triangles), then render one frame; the single-device branch of the
    reference's Renderer (renderer.py:200-227):
      one instance, max_depth <= 6   trace_image_fast
      otherwise, max_depth <= 1      trace_image_fast_multi
      otherwise                      make_arena + trace_image (looped)
    Returns the (W*H, 4) framebuffer on `device`. Every call builds.

    The gate is `1 <= max_depth`: max_depth 0 raises here instead of
    reaching the reference's IndexError. The BVH path runs the traversal
    kernel on the card and its plain version on the CPU. `impl="plain"`
    forces the plain version on the card (comparisons only).
    """
    device = resolve_device(device)
    _gate_depth(camera)
    scene, accel = build_surface(meshes, instances, lights, device=device)
    return trace_surface(scene, accel, camera, device=device, impl=impl)


def trace_volume_scene(scene: VolumeSceneData, camera: PerspectiveCamera,
                       device=None, impl=None):
    """The trace half of render_volume: one frame of a built volume scene.

    One brick in one instance whose rays pass the slice gate renders as the
    single-launch megapass (trace_volume_fast). Anything else takes the
    wavefront tracer, with the slice engine serving each qualifying brick
    and the gather march the rest. On the card the slice engine runs its
    kernels; `impl="plain"` forces its plain version (comparisons only).
    """
    device = resolve_device(device)
    rays = camera.generate_rays(device, volume=True)
    ok, axis, flip = can_slice_march(scene, rays.direction)
    if ok:
        return trace_volume_fast(scene, rays, camera.film_width,
                                 camera.film_height, axis=axis, flip=flip,
                                 impl=impl)
    return trace_volume(scene, make_arena(rays, 0), camera.film_width,
                        camera.film_height,
                        slice_axes=slice_axes_for(scene, rays.direction),
                        impl=impl)


def render_volume(volumes: Sequence[Volume],
                  instances: Sequence[Tuple[int, np.ndarray]],
                  camera: PerspectiveCamera, device=None, impl=None):
    """Build the volume scene (build_volume_scene, in a
    `facade.volume_build` span) and render one frame (trace_volume_scene).
    `instances` is a list of (volume_id, 4x4 world transform). Returns the
    (W*H, 4) framebuffer on `device`. Every call builds."""
    device = resolve_device(device)
    with span("facade.volume_build"):
        scene = build_volume_scene(volumes, instances, device=device)
    return trace_volume_scene(scene, camera, device=device, impl=impl)


def _frozen(value):
    """A database field's value in a form that == compares whole."""
    if isinstance(value, np.ndarray):
        return (value.dtype, value.shape, value.tobytes())
    if isinstance(value, (tuple, list)):
        return tuple(_frozen(v) for v in value)
    return value


class SceneKey(NamedTuple):
    """What the single-device surface and volume builds read from the
    database, in node order: each mesh node's Mesh (held, compared by
    identity) with its name and revision; each volume node's Volume and
    transfer function (held) with its name, revision, the transfer
    function's tables and range, its isovalues and slices, and the node's
    subgrid entries (gridid, level, the subgrid held and its revision);
    each instance's name, meshRef and matrix; each light's name, type and
    fields; the device. Camera and film are not in it."""

    held: tuple
    values: tuple

    @classmethod
    def of(cls, db: RenderContext, device) -> "SceneKey":
        held, values = [], [device]
        for n in db.group("Data").children.values():
            if n.type == "Mesh":
                held.append(n["ptr"])
                values.append((n.name, n["ptr"].revision))
            elif n.type == "Volume" and n["ptr"] is not None:
                v, subs = n["ptr"], n.get("subgrids", [])
                held += [v, v.tf] + [sub for _, _, sub in subs]
                tf = None if v.tf is None else _frozen(
                    (v.tf.color_lut, v.tf.opacity_lut, v.tf.low, v.tf.high))
                values.append((n.name, v.revision, tf,
                               _frozen(v.isovalues), _frozen(v.slices),
                               tuple((gid, level, sub.revision)
                                     for gid, level, sub in subs)))
        for n in db.group("Instances").children.values():
            f = n.fields
            values.append((n.name, f["meshRef"], _frozen(f["mat"])))
        for n in db.group("Lights").children.values():
            values.append((n.name, n.type, _frozen(tuple(n.fields.items()))))
        return cls(tuple(held), tuple(values))

    def same(self, other: "SceneKey") -> bool:
        return (len(self.held) == len(other.held)
                and all(a is b for a, b in zip(self.held, other.held))
                and self.values == other.values)


class Build(NamedTuple):
    """A single-device build and the key it was made from."""

    key: SceneKey
    value: object


# the Renderer's kept builds: the attribute that holds each, and the spans
# of its reuse and of its build
KEPT_BUILDS = {
    "scene_build": ("facade.scene_reused", "facade.scene_build"),
    "volume_build": ("facade.volume_scene_reused",
                     "facade.volume_scene_build"),
}


class Renderer:
    """The facade's renderer (gvtRenderer): one per process, or one per
    layout for a caller that builds its own (`Renderer(mesh=...)`).

    The layout: the Mesh given here, else the one api.gvtInit(mesh=) put in
    the database, else parallel.global_mesh() on the device given to
    api.gvtInit (None: the card). Its one axis is the domain axis of the
    multi-member arms.

    The single-device surface and volume arms keep their last build
    (`scene_build`: the scene and its BVH, `volume_build`: the volume
    scene; one Build each per Renderer) and reuse it while the database's
    SceneKey holds."""

    _instance: "Optional[Renderer]" = None

    def __init__(self, mesh=None):
        self._fb = {}
        self._films = {}
        self.mesh = mesh
        self.scene_build: Optional[Build] = None
        self.volume_build: Optional[Build] = None

    @classmethod
    def instance(cls) -> "Renderer":
        if cls._instance is None:
            cls._instance = Renderer()
        return cls._instance

    @classmethod
    def reset(cls) -> None:
        """Drop the process's Renderer and free its kept builds."""
        if cls._instance is not None:
            for slot in KEPT_BUILDS:
                setattr(cls._instance, slot, None)
        cls._instance = None

    # -- the layout and the scene, from the database ----------------------

    def layout(self, db: RenderContext):
        """(mesh, its one axis name) this render runs over."""
        mesh = self.mesh or db.root.get("mesh")
        if mesh is None:
            mesh = global_mesh(device=db.root.get("device"))
        if len(mesh.groups) != 1:
            raise ValueError(f"the facade renders over a one-axis layout, "
                             f"got axes {list(mesh.groups)}")
        return mesh, next(iter(mesh.groups))

    def _camera(self, db: RenderContext, cam_name: str, film_name: str):
        cam = db.group("Cameras").children[cam_name]
        film = db.group("Films").children[film_name]
        return PerspectiveCamera(
            eye=cam["eyePoint"], focus=cam["focus"], up=cam["upVector"],
            fov=cam["fov"], film_width=film["width"],
            film_height=film["height"], samples=cam["raySamples"],
            max_depth=cam["rayMaxDepth"],
            jitter_window=cam["jitterWindowSize"])

    def _lights(self, db: RenderContext):
        out = []
        for node in db.group("Lights").children.values():
            if node.type == "PointLight":
                out.append(point_light(node["position"], node["color"]))
            elif node.type == "AreaLight":
                out.append(area_light(node["position"], node["color"],
                                      node["normal"], node["width"],
                                      node["height"]))
            elif node.type == "AmbientLight":
                out.append(ambient_light(node["color"]))
        return out

    def _surface_scene(self, db: RenderContext):
        mesh_nodes = [n for n in db.group("Data").children.values()
                      if n.type == "Mesh"]
        name2id = {n.name: i for i, n in enumerate(mesh_nodes)}
        with span("facade.compile_meshes"):
            meshes = [n["ptr"].compile() for n in mesh_nodes]
        instances = [Instance(mesh_id=name2id[n["meshRef"]], m=n["mat"])
                     for n in db.group("Instances").children.values()]
        return meshes, instances, self._lights(db)

    def _kept(self, slot: str, db: RenderContext, device, make):
        """The build kept in `slot` (KEPT_BUILDS) while the database's key
        on `device` holds (in the slot's reuse span), else make()'s, which
        replaces it (in the slot's build span)."""
        key = SceneKey.of(db, device)
        reused, built = KEPT_BUILDS[slot]
        kept = getattr(self, slot)
        if kept is not None and kept.key.same(key):
            with span(reused):
                return kept.value
        setattr(self, slot, None)       # freed before its replacement is made
        with span(built):
            value = make()
        setattr(self, slot, Build(key, value))
        return value

    def _volume_scene(self, db: RenderContext):
        """(volumes, instances) of the database's volume nodes: each Volume
        a shallow copy of the node's with the AMR subgrids registered by
        api.addAmrSubgrid attached at their entries' levels. Nothing in
        the database is written, so no revision moves."""
        vol_nodes = [n for n in db.group("Data").children.values()
                     if n.type == "Volume"]
        name2id = {n.name: i for i, n in enumerate(vol_nodes)}
        volumes = []
        for n in vol_nodes:
            subs = [sub if sub.level == level
                    else dataclasses.replace(sub, level=level)
                    for _gid, level, sub in n.get("subgrids", [])]
            volumes.append(dataclasses.replace(n["ptr"], subgrids=subs))
        instances = [(name2id[n["meshRef"]], n["mat"])
                     for n in db.group("Instances").children.values()]
        return volumes, instances

    # -- rendering --------------------------------------------------------

    @spanned("facade.render")
    def render(self, name: str) -> None:
        """Build the named Scheduler's camera and scene and trace a frame
        (a `facade.render` span):
          volume, Domain/AsyncDomain schedule, more than one member, one
            brick shape, more than one instance   trace_volume_domain, again
                                                  at Regrow's capacity while
                                                  it drops rays
          volume, otherwise                       trace_volume_scene of the
                                                  kept or a new build
        The volume arms read their bricks from the database in one
        `facade.volume_build` span, which holds the single-device arm's
        reuse or build.
          surface, Domain/AsyncDomain schedule, more than one member
                                                  DomainRenderer (no accel)
          surface, otherwise                      trace_surface of the kept
                                                  or a new build
        """
        db = RenderContext.instance()
        sched = db.group("Schedulers").children[name]
        camera = self._camera(db, sched["camera"], sched["film"])
        self._films[name] = (camera.film_width, camera.film_height,
                             db.group("Films").children[sched["film"]])
        mesh, axis = self.layout(db)
        n_dev, device = mesh.size, mesh.device
        domain = int(sched["type"]) in DOMAIN_SCHEDULES and n_dev > 1

        if sched["volume"]:
            with span("facade.volume_build"):
                volumes, instances = self._volume_scene(db)
                by_domain = (domain and len(instances) > 1 and len(
                    {tuple(v.samples.shape) for v in volumes}) == 1)
                if not by_domain:
                    scene = self._kept("volume_build", db, device,
                                       lambda: build_volume_scene(
                                           volumes, instances, device=device))
            if by_domain:
                stacked, owners = partition_volume_scene(
                    volumes, instances, n_dev, device=device)
                rays = camera.generate_rays(device, volume=True)
                arena = make_arena(rays, 0)
                axes = slice_axes_for(stacked, rays.direction)
                grow = Regrow(n_dev, first_cap(arena.capacity, n_dev))
                while True:
                    fb, (drops, peak) = trace_volume_domain(
                        stacked, owners, arena, camera.film_width,
                        camera.film_height, mesh, axis,
                        exchange_cap=grow.cap, return_stats="peak",
                        slice_axes=axes, local_slack=grow.slack)
                    if not grow.retry(drops, peak, arena.capacity):
                        break
            else:
                fb = trace_volume_scene(scene, camera, device=device)
            self._fb[name] = fb
            return

        _gate_depth(camera)
        if domain:
            meshes, instances, lights = self._surface_scene(db)
            dr = DomainRenderer.build(meshes, instances, lights, mesh, axis)
            fb = dr.render(camera)
        else:
            scene, accel = self._kept(
                "scene_build", db, device,
                lambda: build_surface(*self._surface_scene(db),
                                      device=device))
            fb = trace_surface(scene, accel, camera, device=device)
        self._fb[name] = fb

    def framebuffer(self, name: str):
        return self._fb[name]

    def write_image(self, name: str, output: str = "") -> str:
        w, h, film = self._films[name]
        path = output or film["outputPath"] or name
        if not path.endswith(".ppm"):
            path = path + ".ppm"
        image_lib.write_ppm(path, self._fb[name], w, h)
        return path
