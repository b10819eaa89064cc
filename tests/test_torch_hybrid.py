"""The port's in-frame hybrid remap (DomainRenderer.render_hybrid,
HybridTracer.h:223-299) against the JAX package's, on the CPU: the
counterparts of tests/test_hybrid_inframe.py's three tests on its scene (a
row of 6 cubes, Russian-roulette bounces at depth 3, 24^2) over a
LocalGroup(8), plus the rewind's premise (an overflowing chunk leaves the
arena it was given untouched), the regrow's limit, and a frame remapped
mid-frame on a scene whose later rounds draw random numbers (where the
JAX package's hybrid frame drifts from its static one and the port's does
not).

Tolerances: the port's hybrid frames against the port's static frames:
bit-equal (the counter-based hashes make bounces placement-invariant, as
in the JAX tests). Against JAX's frames: torch_parity.assert_multi_close
(the domain scheduler's bound: XLA's CPU backend contracts a*b+c into
FMAs, the port rounds each operation). The per-member loads (integer
counts of ray-rounds) are equal to JAX's.

JAX's frames and loads are committed (its render_hybrid compiles a
shard_map program per chunk configuration); refresh them by hand with
    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \\
        python tests/test_torch_hybrid.py --write-golden
"""

import pathlib
import sys

import numpy as np
import pytest
import torch

import torch_parity as tp  # noqa: I001 (puts the repo root on sys.path)
import chip_smoke

from gravit_tpu_torch.core.math3d import mat4_translate_scale
from gravit_tpu_torch.parallel import global_mesh
from gravit_tpu_torch.render.scene_build import Instance
from gravit_tpu_torch.render.tracer import make_arena
from gravit_tpu_torch.scene.camera import PerspectiveCamera
from gravit_tpu_torch.scene.light import point_light
from gravit_tpu_torch.schedule import domain_sched as ds

torch.set_num_threads(2)

GOLDEN = pathlib.Path(__file__).parent / "data" / \
    "torch_port_hybrid_golden.npz"
N_DEV = 8
FILM = 24


def cube_row():
    """tests/test_hybrid_inframe.py::_scene: 6 cubes along z, one point
    light, depth 3 (bounces wander between instances for several rounds,
    so most ray-rounds are in-frame work a mid-frame remap can move)."""
    meshes = [chip_smoke.cube_mesh()]
    instances = [Instance(mesh_id=0, m=mat4_translate_scale(
        (0.0, 0.0, z), (0.45, 0.45, 0.45)))
        for z in (-2.5, -1.5, -0.5, 0.5, 1.5, 2.5)]
    lights = [point_light((4.0, 4.0, 0.0), (1.0, 1.0, 1.0))]
    cam = PerspectiveCamera(
        eye=(4.5, 0.3, 0.0), focus=(0.0, 0.0, 0.0), up=(0.0, 1.0, 0.0),
        fov=float(55 * np.pi / 180), film_width=FILM, film_height=FILM,
        samples=1, max_depth=3, jitter_window=0.5)
    return meshes, instances, lights, cam


BAD = np.zeros((6,), np.int32)                  # every domain on member 0
GOOD = np.arange(6, dtype=np.int32) % N_DEV


def renderer(owners):
    meshes, instances, lights, cam = cube_row()
    return ds.DomainRenderer.build(
        meshes, instances, lights,
        global_mesh(("domains",), (N_DEV,), device="cpu"),
        owners=owners), cam


@pytest.fixture(scope="module")
def gold():
    return np.load(GOLDEN)


def test_inframe_remap_balances_and_preserves_image(gold):
    """Every domain on member 0: the iteration-0 remap and the per-chunk
    remaps move work off it mid-frame; the frame is the static one, bit
    for bit, and JAX's within the multi tolerance; both loads are JAX's."""
    dr, cam = renderer(BAD)
    fb_static, load_static = dr.render(cam, return_load=True)
    assert int(load_static[1:].sum()) == 0
    fb_hybrid, load_hybrid = dr.render_hybrid(
        cam, chunk=1, tau=1.5, policy="RayWeightedSpread", return_load=True)
    assert torch.equal(fb_static[:, :3], fb_hybrid[:, :3])
    assert int(load_hybrid.max()) * 1.5 <= int(load_static.max())
    assert bool((load_hybrid[1:] > 0).any())
    np.testing.assert_array_equal(load_static.numpy(), gold["load_static"])
    np.testing.assert_array_equal(load_hybrid.numpy(), gold["load_hybrid"])
    tp.assert_multi_close(fb_hybrid.numpy(), gold["fb_hybrid"], FILM, FILM)
    assert tp.lit(fb_hybrid) > 0.05


def simple_grid():
    """SimpleApp's 5x5 grid at 32^2 (tests/test_torch_domain_sched.py::
    grid): round-robin over 8 members, rays migrate between members in the
    first rounds, so an exchange cap of 1 overflows."""
    spec = chip_smoke.simple_app(32, 32)
    return (spec.meshes, tp.grid_instances(lambda k: k % 2), spec.lights,
            spec.camera)


@pytest.mark.parametrize("scene", ["cube_row", "grid"])
def test_inframe_overflow_regrows_not_raises(gold, monkeypatch, scene):
    """exchange_cap=1 must not abort the frame: the finished frame is the
    static one, bit for bit. On the cube row (JAX's test, chunks of 2)
    every chunk happens to fit; on the grid (chunks of 1) the first chunk
    drops rays, is rewound and replayed at the observed peak demand from
    the very arena it was handed, and the frame resumes from there."""
    if scene == "cube_row":
        dr, cam = renderer(GOOD)
        chunk = 2
    else:
        meshes, instances, lights, cam = simple_grid()
        dr = ds.DomainRenderer.build(
            meshes, instances, lights,
            global_mesh(("domains",), (N_DEV,), device="cpu"))
        chunk = 1
    fb_plain = dr.render(cam)
    calls, orig = [], ds.trace_domain

    def spy(scene_, owners, arena, *args, **kw):
        out = orig(scene_, owners, arena, *args, **kw)
        calls.append((arena, kw["exchange_cap"], int(out[1][0])))
        return out

    monkeypatch.setattr(ds, "trace_domain", spy)
    fb_tiny = dr.render_hybrid(cam, chunk=chunk, tau=4.0, exchange_cap=1)
    assert torch.equal(fb_plain[:, :3], fb_tiny[:, :3])
    assert calls[0][1] == 1
    if scene == "grid":
        assert calls[0][2] > 0                              # dropped
        assert calls[1][0] is calls[0][0] and calls[1][1] >= 1024
        assert calls[1][2] == 0 and len(calls) > 2          # resumed
    w = cam.film_width
    tp.assert_multi_close(fb_tiny.numpy(), gold[f"fb_tiny_{scene}"], w, w)


def test_inframe_remap_noop_when_balanced(gold):
    """A well-placed frame is not perturbed (the remap is conditional)."""
    dr, cam = renderer(GOOD)
    fb_plain = dr.render(cam)
    fb_hybrid = dr.render_hybrid(cam, chunk=2, tau=4.0)
    assert torch.equal(fb_plain[:, :3], fb_hybrid[:, :3])
    tp.assert_multi_close(fb_hybrid.numpy(), gold["fb_noop"], FILM, FILM)


def test_overflowing_chunk_leaves_arena_unchanged():
    """The rewind's premise: trace_domain (its claim, compaction, rounds,
    pack, merge and gather) writes nothing into the arena it is given,
    when a chunk overflows (exchange_cap=1), on a fresh camera wavefront
    and on a resumed stacked one."""
    meshes, instances, lights, cam = simple_grid()
    dr = ds.DomainRenderer.build(
        meshes, instances, lights,
        global_mesh(("domains",), (N_DEV,), device="cpu"))
    arena = make_arena(cam.generate_rays("cpu"), 1)
    kw = dict(return_stats="peak", return_arena=True, resident=dr.resident)
    fresh = arena.map(torch.clone)
    _, (drops, _), part, _ = ds.trace_domain(
        dr.scene_stacked, dr.owners, arena, 32, 32, dr.mesh, max_rounds=1,
        exchange_cap=1, **kw)
    assert int(drops) > 0
    tp.assert_tree_equal(arena.map(torch.Tensor.numpy),
                         fresh.map(torch.Tensor.numpy))
    # claimed and compacted, no round traced yet: the rays that migrate
    # in the first round are still ahead
    _, (drops, _), part, _ = ds.trace_domain(
        dr.scene_stacked, dr.owners, arena, 32, 32, dr.mesh, max_rounds=0,
        **kw)
    assert int(drops) == 0 and bool(part.active.any())
    saved = part.map(torch.clone)
    _, (drops, _), _, _ = ds.trace_domain(
        dr.scene_stacked, dr.owners, part, 32, 32, dr.mesh, max_rounds=2,
        initial_shuffle=False, exchange_cap=1, **kw)
    assert int(drops) > 0
    tp.assert_tree_equal(part.map(torch.Tensor.numpy),
                         saved.map(torch.Tensor.numpy))


def test_inframe_regrow_raises_after_three(monkeypatch):
    """A chunk that still drops after three replays raises, as JAX's."""
    meshes, instances, lights, cam = simple_grid()
    dr = ds.DomainRenderer.build(
        meshes, instances, lights,
        global_mesh(("domains",), (N_DEV,), device="cpu"))
    orig = ds.trace_domain

    def capped(*args, **kw):
        kw["exchange_cap"] = 1
        return orig(*args, **kw)

    monkeypatch.setattr(ds, "trace_domain", capped)
    with pytest.raises(RuntimeError, match="in-frame exchange still"):
        dr.render_hybrid(cam, chunk=2, tau=4.0)


def many_domain():
    """chip_smoke's many-domain scene cut to 4-band spheres (32 triangles
    a mesh) at 32^2, depth 2 with the point and the area light:
    bounces between spheres run for several rounds, and every round after
    the first samples the area light with per-ray hashes keyed on the
    round."""
    spec = chip_smoke.make_multi_scene(0, 32, 32, max_depth=2, bands=4)
    return spec.meshes, spec.instances, spec.lights, spec.camera


def test_remapped_frame_is_the_static_frame(gold, monkeypatch):
    """With remaps mid-frame (chunks of 1 round, tau 1.2) the hybrid frame
    is the static render's within float summation order (|d| < 1e-6:
    the chunks' framebuffers are summed chunk by chunk). JAX's
    render_hybrid restarts its round count in every chunk and parks the
    rays a remap moved for a round, so its frame drifts from its own
    static render (the committed pair: > 1e-2); the port's frame is JAX's
    static frame within the multi tolerance."""
    meshes, instances, lights, cam = many_domain()
    dr = ds.DomainRenderer.build(
        meshes, instances, lights,
        global_mesh(("domains",), (4,), device="cpu"))
    fb_static = dr.render(cam)
    remaps, orig = [], ds.DomainRenderer.repartition

    def spy(self, resident):
        remaps.append(resident)
        return orig(self, resident)

    monkeypatch.setattr(ds.DomainRenderer, "repartition", spy)
    fb_hybrid = dr.render_hybrid(cam, chunk=1, tau=1.2)
    assert len(remaps) >= 2
    assert float((fb_hybrid - fb_static)[:, :3].abs().max()) < 1e-6
    drift = np.abs(gold["many_hybrid"] - gold["many_static"])[:, :3].max()
    assert drift > 1e-2
    tp.assert_multi_close(fb_hybrid.numpy(), gold["many_static"], 32, 32)


def write_golden(path=GOLDEN) -> None:
    """JAX's frames and loads for the tests above (run by hand)."""
    from gravit_tpu.schedule import domain_sched as jds

    meshes, instances, lights, cam = cube_row()
    jcam = tp.jax_camera(cam)
    mesh = tp.jax_mesh((N_DEV,))
    out = {}
    dr = jds.DomainRenderer.build(meshes, instances, lights, mesh,
                                  owners=BAD)
    _, load = dr.render(jcam, return_load=True)
    out["load_static"] = np.asarray(load)
    fb, load = dr.render_hybrid(jcam, chunk=1, tau=1.5,
                                policy="RayWeightedSpread", return_load=True)
    out["fb_hybrid"], out["load_hybrid"] = np.asarray(fb), np.asarray(load)
    dr = jds.DomainRenderer.build(meshes, instances, lights, mesh,
                                  owners=GOOD)
    out["fb_tiny_cube_row"] = np.asarray(dr.render_hybrid(
        jcam, chunk=2, tau=4.0, exchange_cap=1))
    out["fb_noop"] = np.asarray(dr.render_hybrid(jcam, chunk=2, tau=4.0))
    meshes, instances, lights, cam = simple_grid()
    dr = jds.DomainRenderer.build(meshes, instances, lights, mesh)
    out["fb_tiny_grid"] = np.asarray(dr.render_hybrid(
        tp.jax_camera(cam), chunk=1, tau=4.0, exchange_cap=1))
    meshes, instances, lights, cam = many_domain()
    dr = jds.DomainRenderer.build(meshes, instances, lights,
                                  tp.jax_mesh((4,)))
    out["many_static"] = np.asarray(dr.render(tp.jax_camera(cam)))
    out["many_hybrid"] = np.asarray(dr.render_hybrid(
        tp.jax_camera(cam), chunk=1, tau=1.2))
    np.savez_compressed(path, **out)


if __name__ == "__main__":
    if "--write-golden" in sys.argv:
        write_golden()
        print("wrote", GOLDEN)
