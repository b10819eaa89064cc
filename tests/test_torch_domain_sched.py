"""The port's domain scheduler (gravit_tpu_torch/schedule/domain_sched.py)
against the JAX package's, on the CPU: the partitions (scene and BVH
arrays), the exchange pieces (_pack_exchange at 64 destinations, pack then
merge, merge and compaction overflow) and whole frames through
trace_domain / DomainRenderer on SimpleApp's 5x5 grid of cones and cubes at
32^2: 2 and 8 LocalGroup members, with and without the BVH accel, the 2-D
domains x rays layout, replica routing under the replication policies,
overflow and the render's auto-grow. JAX runs on the 8 virtual CPU devices
of tests/conftest.py (Pallas in interpret mode for the accel).

Tolerances: the partitions, the packed buffers, slots, drops and demands
are integer logic and copies: equal. Frames against JAX:
torch_parity.assert_multi_close (XLA's CPU backend contracts a*b+c into
FMAs, the port rounds each operation); against the port's own
all-resident looped frame: float |d| < 1e-5, the JAX tests' own bound
(tests/test_domain_sched.py:80); the per-device loads (integer counts of
ray-rounds): equal to JAX's.

JAX's frames are long to compute (shard_map compiles per mesh, the accel
runs in interpret mode), so they are committed: refresh them by hand with
    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
        python tests/test_torch_domain_sched.py --write-golden
"""

import pathlib
import sys

import numpy as np
import pytest
import torch

import torch_parity as tp  # noqa: I001 (puts the repo root on sys.path)
import chip_smoke
import jax.numpy as jnp
from gravit_tpu.core.rays import RayArena as JaxArena
from gravit_tpu.schedule import domain_sched as jds

from gravit_tpu_torch.core.rays import RayArena
from gravit_tpu_torch.core.math3d import mat4_translate_scale
from gravit_tpu_torch.parallel import LocalGroup, Mesh, global_mesh
from gravit_tpu_torch.render.scene_build import Instance, build_scene
from gravit_tpu_torch.render.tracer import make_arena, trace_image
from gravit_tpu_torch.scene.camera import PerspectiveCamera
from gravit_tpu_torch.scene.image import clamp_rgb
from gravit_tpu_torch.scene.light import area_light, point_light
from gravit_tpu_torch.schedule import domain_sched as ds

torch.set_num_threads(2)

GOLDEN = pathlib.Path(__file__).parent / "data" / \
    "torch_port_domain_golden.npz"
FILM = 32
POLICIES = ("LoadAnother", "LoadMany", "AdaptiveSend")


def grid(mesh_of=lambda k: k % 2, film: int = FILM):
    """SimpleApp (meshes cone, cube; 25 instances; one point light) with
    instance k on mesh `mesh_of(k)`, at film x film."""
    spec = chip_smoke.simple_app(film, film)
    return (spec.meshes, tp.grid_instances(mesh_of), spec.lights,
            spec.camera)


def accel_grid():
    """tests/test_domain_accel.py::_grid_scene: under 2-way round-robin
    each device owns BOTH meshes (mesh_id = (k // 2) % 2)."""
    return grid(lambda k: (k // 2) % 2)


def skewed():
    """tests/test_replicas.py::_skewed_scene: one big cube in front (domain
    0 gets nearly all primary rays) and two small off-axis cubes."""
    meshes = [chip_smoke.cube_mesh()]
    instances = [
        Instance(0, mat4_translate_scale((0, 0, 0), (1, 1, 1))),
        Instance(0, mat4_translate_scale((0, 2.5, 0), (0.3, 0.3, 0.3))),
        Instance(0, mat4_translate_scale((0, -2.5, 0), (0.3, 0.3, 0.3)))]
    lights = [point_light((2.0, 2.0, 2.0), (1.0, 1.0, 1.0))]
    cam = PerspectiveCamera(
        eye=(3.0, 0.2, 0.4), focus=(0.0, 0.0, 0.0), up=(0.0, 1.0, 0.0),
        fov=float(40 * np.pi / 180), film_width=24, film_height=24,
        samples=1, max_depth=1, jitter_window=0.5)
    return meshes, instances, lights, cam


def area_scene():
    """tests/test_domain_sched.py::test_depth3_area_light_sharding_invariant:
    a 3x3 grid, one area light, 2 samples, depth 3 (RR bounces)."""
    spec = chip_smoke.simple_app(24, 24)
    instances = tp.grid_instances(lambda k: k % 2, n=3)
    lights = [area_light((1.0, 0.5, -1.0), (1.0, 1.0, 1.0),
                         (0.0, 1.0, 0.0), 0.4, 0.4)]
    cam = PerspectiveCamera(
        eye=(4.0, 0.0, 0.0), focus=(0.0, 0.0, 0.0), up=(0.0, 1.0, 0.0),
        fov=float(45 * np.pi / 180), film_width=24, film_height=24,
        samples=2, max_depth=3, jitter_window=0.5)
    return spec.meshes, instances, lights, cam


def local_mesh(*shape, axes=("domains",)):
    return global_mesh(axes, shape, device="cpu")


def resident_frame(meshes, instances, lights, cam, max_rounds=32):
    scene = build_scene(meshes, instances, lights, device="cpu")
    arena = make_arena(cam.generate_rays("cpu"), scene.num_lights)
    return trace_image(scene, arena, cam.film_width, cam.film_height,
                       max_rounds=max_rounds)


def assert_resident(fb, ref, tol=1e-5):
    err = float((torch.as_tensor(fb) - ref)[:, :3].abs().max())
    assert err < tol, err


@pytest.fixture(scope="module")
def gold():
    return np.load(GOLDEN)


# ---- helpers and partitions ----------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_routing_helpers_equal_jax(seed):
    rng = np.random.default_rng(seed)
    n_inst, n_dev = 7, 4
    np.testing.assert_array_equal(ds.round_robin_owners(n_inst, n_dev),
                                  jds.round_robin_owners(n_inst, n_dev))
    owners = rng.integers(0, n_dev, n_inst).astype(np.int32)
    np.testing.assert_array_equal(ds.one_hot_residency(owners, n_dev),
                                  jds.one_hot_residency(owners, n_dev))
    res = rng.uniform(size=(n_inst, n_dev)) < 0.4
    res[0] = False                          # a domain with no residency
    for a, b in zip(ds.build_routes(res), jds.build_routes(res)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ds.primary_owner_np(res),
                                  jds.primary_owner_np(res))


def test_build_routes():
    res = np.array([[1, 0, 1, 0], [0, 1, 0, 0]], bool)
    route, n_rep = ds.build_routes(res)
    assert n_rep.tolist() == [2, 1]
    assert route[0].tolist() == [0, 2, 0, 2]
    assert route[1].tolist() == [1, 1, 1, 1]


def _tree_scene():
    """64 cubes on an 8 x 8 grid: the instance tree is built and stacked."""
    return ([chip_smoke.cube_mesh(), chip_smoke.cone_mesh()],
            [Instance(k % 2, mat4_translate_scale(
                (0.0, (k // 8) * 0.5 - 1.75, (k % 8) * 0.5 - 1.75),
                (0.2, 0.2, 0.2))) for k in range(64)],
            [point_light((4.0, 4.0, 0.0), (1.0, 1.0, 1.0))])


@pytest.mark.parametrize("case", ["grid2", "grid4", "tree3", "replicated"])
def test_partition_scene_equal_jax(case):
    if case == "tree3":
        meshes, instances, lights = _tree_scene()
    else:
        meshes, instances, lights, _ = grid()
    n_dev = {"grid2": 2, "grid4": 4, "tree3": 3, "replicated": 3}[case]
    resident = None
    if case == "replicated":
        resident = ds.one_hot_residency(
            ds.round_robin_owners(len(instances), n_dev), n_dev)
        resident[:5, 2] = True               # domains 0-4 on device 2 too
    got, owners = ds.partition_scene(meshes, instances, lights, n_dev,
                                     resident=resident, device="cpu")
    ref, jowners = jds.partition_scene(meshes, instances, lights, n_dev,
                                       resident=resident)
    np.testing.assert_array_equal(owners.numpy(), np.asarray(jowners))
    for name, arr in tp.leaves(ref).items():
        np.testing.assert_array_equal(getattr(got, name).numpy(), arr,
                                      err_msg=name)
    for name in ("num_meshes", "mesh_tri_offset", "mesh_tri_count",
                 "has_embree_materials", "has_specular", "num_instances",
                 "num_lights"):
        assert getattr(got, name) == getattr(ref, name), name
    assert (got.inst_bvh is None) == (ref.inst_bvh is None)
    if ref.inst_bvh is not None:
        for name, arr in tp.leaves(ref.inst_bvh).items():
            np.testing.assert_array_equal(getattr(got.inst_bvh, name).numpy(),
                                          arr, err_msg=name)
    # foreign instances have mesh -1 on each device
    im = got.inst_mesh.numpy()
    res = resident if resident is not None else ds.one_hot_residency(
        owners.numpy(), n_dev)
    for d in range(n_dev):
        np.testing.assert_array_equal(im[d] >= 0, res[:, d])


@pytest.mark.parametrize("n_dev", [2, 8])
def test_partition_accel_equal_jax(n_dev):
    meshes, instances, _, _ = accel_grid()
    owners = ds.round_robin_owners(len(instances), n_dev)
    got = ds.partition_accel(meshes, instances, n_dev, owners, device="cpu")
    ref = jds.partition_accel(meshes, instances, n_dev, owners)
    for name, arr in tp.leaves(ref).items():
        np.testing.assert_array_equal(getattr(got, name).numpy(), arr,
                                      err_msg=name)
    assert got.num_meshes == ref.num_meshes
    assert got.bounds.shape[0] == n_dev
    if n_dev == 2:          # both devices own both meshes
        assert got.num_meshes == 2 and int(got.mesh_root.min()) >= 0


# ---- the exchange pieces -------------------------------------------------

def _arenas(c: int, seed: int = 0, active=None):
    """The same seeded arena in both packages: every field random, ids and
    w the lane index (so payloads can be followed)."""
    rng = np.random.default_rng(seed)
    f = dict(
        origin=rng.normal(size=(c, 3)), direction=rng.normal(size=(c, 3)),
        color=rng.uniform(size=(c, 3)), t_max=rng.uniform(1, 9, c),
        t=rng.uniform(0, 1, c), w=np.arange(c), id=np.arange(c),
        depth=rng.integers(0, 4, c), type=rng.integers(0, 3, c),
        inst=rng.integers(-1, 25, c), prev=rng.integers(-1, 25, c),
        active=np.ones(c, bool) if active is None else active)
    f = {k: np.asarray(v, np.bool_ if k == "active" else
                       (np.int32 if k in ("id", "depth", "type", "inst",
                                          "prev") else np.float32))
         for k, v in f.items()}
    return (RayArena(**{k: torch.as_tensor(v) for k, v in f.items()}),
            JaxArena(**{k: jnp.asarray(v) for k, v in f.items()}))


def assert_arena_equal(got, ref):
    for name, arr in tp.leaves(ref).items():
        np.testing.assert_array_equal(getattr(got, name).numpy(), arr,
                                      err_msg=name)


@pytest.mark.parametrize("n_dev,cap", [(64, 96), (64, 32), (8, 600)])
def test_pack_exchange_equal_jax(n_dev, cap):
    """64 destinations (beyond the 8 virtual devices: the packing is pure
    array code), with and without overflow: the packed buffers (every
    lane's slot), the drops and the peak demand equal JAX's."""
    c = 4096
    rng = np.random.default_rng(n_dev + cap)
    dest = rng.integers(-1, n_dev, c).astype(np.int32)   # -1 = stays
    ta, ja = _arenas(c)
    out, packed, dropped, demand = ds._pack_exchange(
        ta, torch.as_tensor(dest), n_dev, cap)
    jout, jpacked, jdropped, jdemand = jds._pack_exchange(
        ja, jnp.asarray(dest), n_dev, cap)
    assert_arena_equal(out, jout)
    assert_arena_equal(packed, jpacked)
    assert int(dropped) == int(jdropped)
    assert int(demand) == int(jdemand)
    counts = np.bincount(dest[dest >= 0], minlength=n_dev)
    assert int(demand) == counts.max()
    assert int(dropped) == np.maximum(counts - cap, 0).sum()
    for d in range(n_dev):       # every packed ray is bound for its bucket
        ids = packed.id[d][packed.active[d]].numpy()
        assert (dest[ids] == d).all()


def test_pack_then_merge_roundtrip():
    """Pack 1024 rays for 16 destinations, merge every bucket into an empty
    arena (the identity all_to_all): each sent ray arrives once, in JAX's
    lane."""
    c, n_dev, cap = 1024, 16, 128
    dest = np.random.default_rng(1).integers(-1, n_dev, c).astype(np.int32)
    ta, ja = _arenas(c)
    _, packed, dropped, _ = ds._pack_exchange(ta, torch.as_tensor(dest),
                                              n_dev, cap)
    _, jpacked, _, _ = jds._pack_exchange(ja, jnp.asarray(dest), n_dev, cap)
    assert int(dropped) == 0
    te, je = _arenas(c, seed=5, active=np.zeros(c, bool))
    merged, mdrop = ds._merge_incoming(te, packed)
    jmerged, jmdrop = jds._merge_incoming(je, jpacked)
    assert int(mdrop) == int(jmdrop) == 0
    assert_arena_equal(merged, jmerged)
    got = np.sort(merged.id[merged.active].numpy())
    np.testing.assert_array_equal(got, np.arange(c)[dest >= 0])
    w = merged.w[merged.active].numpy()
    assert set(w.astype(int)) == set(got.tolist())


@pytest.mark.parametrize("free", [0.1, 0.5])
def test_merge_incoming_overflow_equal_jax(free):
    """Incoming rays into an arena with fewer free lanes than arrivals:
    the arrivals that find no lane are counted, the others land in JAX's
    lanes."""
    c, n_dev, cap = 2048, 4, 512
    rng = np.random.default_rng(7)
    active = rng.uniform(size=c) > free
    ta, ja = _arenas(c, seed=3, active=active)
    inc_active = rng.uniform(size=n_dev * cap) < 0.6
    ti, ji = _arenas(n_dev * cap, seed=4, active=inc_active)
    ti = ti.map(lambda a: a.reshape((n_dev, cap) + tuple(a.shape[1:])))
    ji = JaxArena(**{k: v.reshape((n_dev, cap) + v.shape[1:])
                     for k, v in tp.leaves(ji).items()})
    merged, drop = ds._merge_incoming(ta, ti)
    jmerged, jdrop = jds._merge_incoming(ja, ji)
    assert int(drop) == int(jdrop) == max(0, int(inc_active.sum())
                                          - int((~active).sum()))
    assert_arena_equal(merged, jmerged)


@pytest.mark.parametrize("c_local", [1024, 2048, 4096])
def test_compact_arena_overflow_equal_jax(c_local):
    c = 4096
    active = np.random.default_rng(c_local).uniform(size=c) < 0.4
    ta, ja = _arenas(c, seed=2, active=active)
    out, drop = ds._compact_arena(ta, c_local)
    jout, jdrop = jds._compact_arena(ja, c_local)
    assert int(drop) == int(jdrop) == max(0, int(active.sum()) - c_local)
    assert_arena_equal(out, jout)


# ---- frames --------------------------------------------------------------

@pytest.mark.parametrize("use_accel", [False, True])
@pytest.mark.parametrize("n_dev", [2, 8])
def test_domain_renderer_matches_jax(gold, n_dev, use_accel):
    meshes, instances, lights, cam = accel_grid() if use_accel else grid()
    dr = ds.DomainRenderer.build(meshes, instances, lights,
                                 local_mesh(n_dev), use_accel=use_accel)
    assert (dr.accel is not None) == use_accel
    fb = dr.render(cam, max_rounds=32)
    ref = gold[f"domain_{'accel' if use_accel else 'brute'}_{n_dev}"]
    tp.assert_multi_close(fb.numpy(), ref, FILM, FILM)
    assert_resident(fb, resident_frame(meshes, instances, lights, cam))
    assert tp.lit(fb) > 0.05


def test_hybrid_2d_mesh_domains_x_rays(gold):
    """Domains on one axis (2 members), rays split over the other (4):
    the domain and image schedulers composed."""
    meshes, instances, lights, cam = grid()
    stacked, owners = ds.partition_scene(meshes, instances, lights, 2,
                                         device="cpu")
    arena = make_arena(cam.generate_rays("cpu"), 1)
    assert arena.capacity % 4 == 0
    mesh = local_mesh(2, 4, axes=("domains", "rays"))
    fb = ds.trace_domain(stacked, owners, arena, FILM, FILM, mesh,
                         axis="domains", ray_axis="rays", max_rounds=32)
    tp.assert_multi_close(fb.numpy(), gold["domain_2d"], FILM, FILM)
    assert_resident(fb, resident_frame(meshes, instances, lights, cam))


def test_stats_load_hist_and_arena():
    """return_stats="peak", return_load and return_arena: the frame is the
    same, the loads count every primary ray at least once, a finished
    frame's pending histogram is zero, the stacked arena has n_dev *
    c_local lanes."""
    meshes, instances, lights, cam = grid()
    stacked, owners = ds.partition_scene(meshes, instances, lights, 4,
                                         device="cpu")
    arena = make_arena(cam.generate_rays("cpu"), 1)
    mesh = local_mesh(4)
    fb = ds.trace_domain(stacked, owners, arena, FILM, FILM, mesh)
    out = ds.trace_domain(stacked, owners, arena, FILM, FILM, mesh,
                          return_stats="peak", return_load=True,
                          return_arena=True)
    fb_raw, (drops, peak), load, arena_out, hist = out
    assert torch.equal(fb, torch.cat([fb_raw[:, :3].clamp(max=1.0),
                                      fb_raw[:, 3:]], dim=1))
    assert int(drops) == 0 and int(peak) > 0
    assert load.shape == (4,) and int(load.sum()) >= FILM * FILM // 4
    assert int(hist.sum()) == 0 and hist.shape == (len(instances),)
    assert arena_out.capacity % 4 == 0 and not bool(arena_out.active.any())


@pytest.mark.parametrize("shape", [(2,), (4,), (2, 2)])
def test_resume_partial_frame(shape):
    """return_arena=True after 1 round, then a resume with
    initial_shuffle=False from the stacked arena, on a 1-D layout and on a
    2-D domains x rays one: the two partial frames sum to the single
    call's frame (float |d| < 1e-6: only the order of the framebuffer sums
    differs; a depth-1 point-light frame draws no random numbers, so the
    resumed rounds counting from 0 again changes nothing), and the first
    call leaves rays pending that the second finishes."""
    meshes, instances, lights, cam = grid()
    stacked, owners = ds.partition_scene(meshes, instances, lights, shape[0],
                                         device="cpu")
    arena = make_arena(cam.generate_rays("cpu"), 1)
    axes = ("domains", "rays")[:len(shape)]
    mesh = local_mesh(*shape, axes=axes)
    ray_axis = "rays" if len(shape) == 2 else None
    whole = ds.trace_domain(stacked, owners, arena, FILM, FILM, mesh,
                            ray_axis=ray_axis)
    fb1, part, hist1 = ds.trace_domain(
        stacked, owners, arena, FILM, FILM, mesh, ray_axis=ray_axis,
        max_rounds=1, return_arena=True)
    assert int(hist1.sum()) > 0
    assert part.capacity % int(np.prod(shape)) == 0
    fb2, rest, hist2 = ds.trace_domain(
        stacked, owners, part, FILM, FILM, mesh, ray_axis=ray_axis,
        initial_shuffle=False, return_arena=True)
    assert int(hist2.sum()) == 0 and not bool(rest.active.any())
    assert rest.capacity == part.capacity
    fb = clamp_rgb(fb1 + fb2)
    assert float((fb - whole)[:, :3].abs().max()) < 1e-6
    assert tp.lit(whole) > 0.05


def test_depth3_area_light_sharding_invariant(gold):
    """RR bounces and area-light samples give the same image under any
    sharding (counter-based hashes): the image scheduler at 2 and 8
    members equals the resident frame within 1e-6 (the JAX test's bound),
    and the resident frame is JAX's within the multi tolerance."""
    from gravit_tpu_torch.schedule.image_sched import trace_image_sharded

    meshes, instances, lights, cam = area_scene()
    scene = build_scene(meshes, instances, lights, device="cpu")
    arena = make_arena(cam.generate_rays("cpu"), 1)
    fb1 = trace_image(scene, arena, 24, 24, max_rounds=48)
    assert bool(torch.isfinite(fb1).all())
    assert float(fb1[:, :3].max()) <= 1.0 + 1e-6
    assert int((fb1[:, :3].sum(-1) > 0).sum()) > 30
    tp.assert_multi_close(fb1.numpy(), gold["area_depth3"], 24, 24)
    for n in (2, 8):
        pad = -arena.capacity % n
        a = arena if not pad else arena.map(lambda x: torch.cat(
            [x, torch.zeros((pad,) + tuple(x.shape[1:]), dtype=x.dtype)]))
        fbn = trace_image_sharded(scene, a, 24, 24, local_mesh(n, axes=(
            "rays",)), max_rounds=48)
        assert float((fb1 - fbn).abs().max()) < 1e-6


# ---- replicas --------------------------------------------------------------

@pytest.mark.parametrize("policy", POLICIES)
def test_replication_spreads_load_image_unchanged(gold, policy):
    """A multi-hot residency row SERVES rays from the replica: the image is
    unchanged, the hot device's load falls, a replica's rises; the
    pending histogram, the placement and both loads equal JAX's."""
    meshes, instances, lights, cam = skewed()
    owners = np.array([0, 1, 2], np.int32)
    dr1 = ds.DomainRenderer.build(meshes, instances, lights, local_mesh(4),
                                  owners=owners)
    fb1, load1 = dr1.render(cam, return_load=True)
    pending = dr1.pending_histogram(cam)
    np.testing.assert_array_equal(pending, gold["pending"])
    assert int(np.argmax(pending)) == 0
    dr2 = dr1.reschedule(pending, policy)
    np.testing.assert_array_equal(dr2.resident, gold[f"resident_{policy}"])
    assert dr2.resident[0].sum() >= 2
    fb2, load2 = dr2.render(cam, return_load=True)
    np.testing.assert_array_equal(fb1[:, :3].numpy(), fb2[:, :3].numpy())
    np.testing.assert_array_equal(load1.numpy(), gold["load_owners"])
    np.testing.assert_array_equal(load2.numpy(), gold[f"load_{policy}"])
    assert int(load2.max()) < int(load1.max())
    gained = set(np.nonzero(dr2.resident[0])[0]) - {0}
    assert any(int(load2[d]) > int(load1[d]) for d in gained)


def test_one_hot_residency_matches_owner_path():
    meshes, instances, lights, cam = skewed()
    owners = np.array([0, 1, 2], np.int32)
    dr1 = ds.DomainRenderer.build(meshes, instances, lights, local_mesh(4),
                                  owners=owners)
    res = ds.one_hot_residency(owners, 4)
    dr2 = ds.DomainRenderer.build(meshes, instances, lights, local_mesh(4),
                                  resident=res)
    assert torch.equal(dr1.render(cam), dr2.render(cam))


# ---- overflow --------------------------------------------------------------

def test_exchange_overflow_is_counted_not_silent(gold):
    """A tiny exchange cap drops rays, counted as JAX counts them; the
    default cap drops none and gives the resident frame."""
    meshes, instances, lights, cam = accel_grid()
    stacked, owners = ds.partition_scene(meshes, instances, lights, 2,
                                         device="cpu")
    arena = make_arena(cam.generate_rays("cpu"), 1)
    mesh = local_mesh(2)
    _, drops = ds.trace_domain(stacked, owners, arena, FILM, FILM, mesh,
                               max_rounds=32, exchange_cap=8,
                               return_stats=True)
    assert int(drops) > 0
    assert int(drops) == int(gold["drops_cap8"])
    fb, drops = ds.trace_domain(stacked, owners, arena, FILM, FILM, mesh,
                                max_rounds=32, return_stats=True)
    assert int(drops) == 0
    assert_resident(fb, resident_frame(meshes, instances, lights, cam))


def _spy(monkeypatch, caps, first_cap=None):
    """Record every trace_domain call's exchange_cap; with first_cap, force
    that cap on the first call (always, if first_cap < 0: -first_cap)."""
    orig = ds.trace_domain

    def spy(*args, **kw):
        if first_cap is not None and (not caps or first_cap < 0):
            kw["exchange_cap"] = abs(first_cap)
        caps.append(kw.get("exchange_cap"))
        return orig(*args, **kw)

    monkeypatch.setattr(ds, "trace_domain", spy)


def test_render_auto_grow_recovers(monkeypatch):
    """render() starts at a forced cap of 8: the first frame drops rays,
    and ONE predictive regrow (to the observed peak demand) gives the
    resident frame."""
    meshes, instances, lights, cam = grid()
    dr = ds.DomainRenderer.build(meshes, instances, lights, local_mesh(2))
    caps = []
    _spy(monkeypatch, caps, first_cap=8)
    fb = dr.render(cam, max_rounds=32)
    assert len(caps) == 2 and caps[0] == 8 and caps[1] >= 1024, caps
    assert_resident(fb, resident_frame(meshes, instances, lights, cam))


def test_render_raises_after_max_grows(monkeypatch):
    meshes, instances, lights, cam = grid()
    dr = ds.DomainRenderer.build(meshes, instances, lights, local_mesh(2))
    caps = []
    _spy(monkeypatch, caps, first_cap=-8)
    with pytest.raises(RuntimeError, match="still dropping"):
        dr.render(cam, max_rounds=32, max_grows=2)
    assert caps == [8, 8, 8]


def test_render_hybrid_not_ported():
    """render_hybrid is ported now (it raised NotImplementedError until
    the in-frame remap came; tests/test_torch_hybrid.py holds it against
    JAX): on the grid over 2 members it gives render()'s frame, bit for
    bit, and counts every member's load."""
    meshes, instances, lights, cam = grid()
    dr = ds.DomainRenderer.build(meshes, instances, lights, local_mesh(2))
    fb, load = dr.render_hybrid(cam, return_load=True)
    assert torch.equal(fb[:, :3], dr.render(cam)[:, :3])
    assert load.shape == (2,) and int(load.min()) > 0


def test_mesh_layout():
    mesh = local_mesh(2, 4, axes=("domains", "rays"))
    assert mesh.shape == {"domains": 2, "rays": 4} and mesh.size == 8
    one = Mesh({"domains": LocalGroup(3, "cpu")})
    assert one.shape == {"domains": 3}


# ---- the committed JAX frames --------------------------------------------

def write_golden(path=GOLDEN) -> None:
    """JAX's frames and counts for the tests above (run by hand)."""
    from gravit_tpu.render.scene_build import build_scene as jax_build
    from gravit_tpu.render.tracer import make_arena as jax_arena
    from gravit_tpu.render.tracer import trace_image as jax_trace

    out = {}
    with tp.pallas_interpret():
        for use_accel in (False, True):
            meshes, instances, lights, cam = (accel_grid() if use_accel
                                              else grid())
            for n_dev in (2, 8):
                dr = jds.DomainRenderer.build(meshes, instances, lights,
                                              tp.jax_mesh((n_dev,)),
                                              use_accel=use_accel)
                key = f"domain_{'accel' if use_accel else 'brute'}_{n_dev}"
                out[key] = np.asarray(dr.render(tp.jax_camera(cam),
                                                max_rounds=32))
    meshes, instances, lights, cam = grid()
    stacked, owners = jds.partition_scene(meshes, instances, lights, 2)
    arena = jax_arena(tp.jax_camera(cam).generate_rays(), 1)
    out["domain_2d"] = np.asarray(jds.trace_domain(
        stacked, owners, arena, FILM, FILM,
        tp.jax_mesh((2, 4), ("domains", "rays")), axis="domains",
        ray_axis="rays", max_rounds=32))
    meshes, instances, lights, cam = accel_grid()
    stacked, owners = jds.partition_scene(meshes, instances, lights, 2)
    _, drops = jds.trace_domain(stacked, owners, arena, FILM, FILM,
                                tp.jax_mesh((2,)), max_rounds=32,
                                exchange_cap=8, return_stats=True)
    out["drops_cap8"] = np.asarray(drops)
    meshes, instances, lights, cam = area_scene()
    jarena = jax_arena(tp.jax_camera(cam).generate_rays(), 1)
    out["area_depth3"] = np.asarray(jax_trace(
        jax_build(meshes, instances, lights), jarena, 24, 24,
        max_rounds=48))
    meshes, instances, lights, cam = skewed()
    jcam = tp.jax_camera(cam)
    dr1 = jds.DomainRenderer.build(meshes, instances, lights,
                                   tp.jax_mesh((4,)),
                                   owners=np.array([0, 1, 2], np.int32))
    _, load1 = dr1.render(jcam, return_load=True)
    out["load_owners"] = np.asarray(load1)
    out["pending"] = dr1.pending_histogram(jcam)
    for policy in POLICIES:
        dr2 = dr1.reschedule(out["pending"], policy)
        _, load2 = dr2.render(jcam, return_load=True)
        out[f"resident_{policy}"] = dr2.resident
        out[f"load_{policy}"] = np.asarray(load2)
    np.savez_compressed(path, **out)


if __name__ == "__main__":
    if "--write-golden" in sys.argv:
        write_golden()
        print("wrote", GOLDEN)
