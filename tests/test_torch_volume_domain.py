"""The port's volume domain scheduler (gravit_tpu_torch/schedule/
volume_domain.py) against the JAX package's, on the CPU: the wavelet split
into two x-bricks (tests/test_volume_domain.py's scene) over LocalGroup(2)
and LocalGroup(4): the partition's tables leaf for leaf (the stacked
per-brick tuples: the tree_map trap), the stacked slice_axes_for, the
frames, the slice path inside the domain program, and the tree_map it all
rests on.

Tolerances: the partition and the slice axes are copies and host logic:
equal. Frames: within 1e-5 of the port's single-device trace_volume (the
JAX test's bound, tests/test_volume_domain.py:55) and within 1e-5 of
JAX's trace_volume_domain (a gather-march frame: its trilinear taps and
compositing are the same operations in the same order, an FMA at most
apart). The slice path inside the domain program against the single-device
slice frame: equal (the same plain march on the same lanes).

JAX's frames are committed (shard_map compiles per mesh); refresh them by
hand with
    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \\
        python tests/test_torch_volume_domain.py --write-golden
"""

import dataclasses
import pathlib
import sys

import numpy as np
import pytest
import torch

import torch_parity as tp  # noqa: I001 (puts the repo root on sys.path)
import chip_smoke
from gravit_tpu.render import volume_tracer as jvt
from gravit_tpu.schedule import volume_domain as jvd

from gravit_tpu_torch.core import timing
from gravit_tpu_torch.ops import slice_march as sm
from gravit_tpu_torch.parallel import global_mesh
from gravit_tpu_torch.render import volume_tracer as vt
from gravit_tpu_torch.render.tracer import make_arena
from gravit_tpu_torch.render.volume_scene import build_volume_scene
from gravit_tpu_torch.schedule import domain_sched as ds
from gravit_tpu_torch.schedule import volume_domain as vd
from gravit_tpu_torch.scene.camera import PerspectiveCamera

torch.set_num_threads(2)

GOLDEN = pathlib.Path(__file__).parent / "data" / \
    "torch_port_volume_domain_golden.npz"
N = 32
FILM = 24
EYE4 = np.eye(4, dtype=np.float32)
INSTANCES = [(0, EYE4), (1, EYE4)]


def camera():
    """tests/test_volume_domain.py's camera: on the diagonal, 4n out."""
    return PerspectiveCamera(
        eye=(4.0 * N,) * 3, focus=((N - 1) / 2,) * 3, up=(0.0, 0.0, 1.0),
        fov=float(30 * np.pi / 180), film_width=FILM, film_height=FILM)


def wavefront():
    rays = camera().generate_rays("cpu", volume=True)
    return rays, make_arena(rays, 0)


def mesh(n_dev):
    return global_mesh(("domains",), (n_dev,), device="cpu")


@pytest.fixture(scope="module")
def gold():
    return np.load(GOLDEN)


def test_tree_map_recurses_into_tensor_tuples():
    """Tuples that hold tensors (at any depth) are mapped item by item;
    tuples of Python numbers, and empty ones, stay the first tree's; a
    shard of a stacked tuple is that member's tensor, not member 0's."""
    a = (torch.zeros(2), (torch.ones(3), torch.full((1,), 2.0)))
    b = (torch.ones(2), (torch.zeros(3), torch.full((1,), 5.0)))
    meta = ((0.0, 1.0), (2.0,))
    got = ds.tree_map(lambda *xs: torch.stack(xs), a, b)
    assert got[1][1].tolist() == [[2.0], [5.0]]
    assert ds.tree_map(lambda *xs: None, meta, ((9.0, 9.0), (9.0,))) is meta
    assert ds.tree_map(lambda *xs: None, (), ()) == ()
    assert ds.shard(got, 1)[1][0].tolist() == [0.0, 0.0, 0.0]
    with pytest.raises(ValueError, match="unequal"):
        ds.tree_map(lambda *xs: xs[0], a, a[:1])


@pytest.mark.parametrize("n_dev", [2, 4])
def test_partition_volume_scene_equal_jax(n_dev):
    """Every leaf of the stacked scene (each member's bricks, inst_vol,
    the boxes, transforms and TF tables) equals JAX's, and so do the static
    fields (vol_meta, vol_step, vol_max_steps, ...) and the owners; member
    d holds brick d's samples (not member 0's) where it owns one."""
    bricks, jbricks = tp.bricked_wavelet(N)
    got, owners = vd.partition_volume_scene(bricks, INSTANCES, n_dev,
                                            device="cpu")
    ref, jowners = jvd.partition_volume_scene(jbricks, INSTANCES, n_dev)
    np.testing.assert_array_equal(owners.numpy(), np.asarray(jowners))
    for f in dataclasses.fields(ref):
        tp.assert_tree_equal(ds.tree_map(torch.Tensor.numpy,
                                         getattr(got, f.name)),
                             _np_tree(getattr(ref, f.name)), f.name)
    assert got.vol_meta == (((0.0, 0.0, 0.0), (1.0, 1.0, 1.0),
                             (0.0, 0.0)),)
    for d in range(2):
        np.testing.assert_array_equal(got.vol_samples[0][d].numpy(),
                                      bricks[d].samples)
    assert got.inst_vol.tolist()[:2] == [[0, -1], [-1, 0]]


def _np_tree(x):
    if isinstance(x, tuple):
        return tuple(_np_tree(v) for v in x)
    return np.asarray(x) if hasattr(x, "shape") else x


def test_partition_rejects_mixed_shapes_and_spacings():
    """Bricks of two shapes raise; bricks of two spacings turn the slice
    engine off (vol_meta = ()), as in JAX."""
    bricks = chip_smoke.bricked_wavelet(N)
    with pytest.raises(ValueError, match="share a shape"):
        vd.partition_volume_scene([bricks[0], chip_smoke.wavelet_volume(8)],
                                  INSTANCES, 2, device="cpu")
    bricks[1].spacing = np.full(3, 0.5, np.float32)
    got, _ = vd.partition_volume_scene(bricks, INSTANCES, 2, device="cpu")
    ref, _ = jvd.partition_volume_scene(tp.jax_volumes(bricks), INSTANCES,
                                        2)
    assert got.vol_meta == ref.vol_meta == ()
    rays, _ = wavefront()
    assert vt.slice_axes_for(got, rays.direction) == ()


@pytest.mark.parametrize("feature", [None, "iso", "oblique"])
@pytest.mark.parametrize("n_dev", [2, 4])
def test_stacked_slice_axes_equal_jax(n_dev, feature):
    """slice_axes_for on the stacked scene equals JAX's: a scene that
    qualifies, one whose bricks carry an isovalue (within SLAB_BYTES: it
    still qualifies), and one whose camera rays fail the dominant-axis
    gate (a direction opposing the others)."""
    bricks = chip_smoke.bricked_wavelet(N)
    if feature == "iso":
        # one isovalue on every brick: JAX's tree.map needs the static
        # fields of all members equal
        iso = (float(bricks[0].samples.mean()),)
        for b in bricks:
            b.isovalues = iso
    got, _ = vd.partition_volume_scene(bricks, INSTANCES, n_dev,
                                       device="cpu")
    ref, _ = jvd.partition_volume_scene(tp.jax_volumes(bricks), INSTANCES,
                                        n_dev)
    rays, _ = wavefront()
    d = rays.direction.numpy()
    if feature == "oblique":
        d = np.concatenate([d, -d[:1]])
    axes = vt.slice_axes_for(got, d)
    assert axes == jvt.slice_axes_for(ref, d)
    assert all(a is not None for a in axes) == (feature != "oblique")


@pytest.mark.parametrize("n_dev", [2, 4])
def test_volume_domain_matches_single_and_jax(gold, n_dev):
    """The gather-march frame over n members: within 1e-5 of the port's
    single-device trace_volume and of JAX's trace_volume_domain; no ray
    dropped; the frame lit."""
    bricks = chip_smoke.bricked_wavelet(N)
    rays, arena = wavefront()
    single = vt.trace_volume(build_volume_scene(bricks, INSTANCES,
                                                device="cpu"),
                             arena, FILM, FILM, max_rounds=8)
    stacked, owners = vd.partition_volume_scene(bricks, INSTANCES, n_dev,
                                                device="cpu")
    fb, drops = vd.trace_volume_domain(stacked, owners, arena, FILM, FILM,
                                       mesh(n_dev), max_rounds=8,
                                       return_stats=True)
    assert int(drops) == 0
    assert float((fb - single)[:, :3].abs().max()) < 1e-5
    ref = gold[f"fb_{n_dev}"]
    assert float(np.abs(fb.numpy() - ref)[:, :3].max()) < 1e-5
    assert int((fb[:, :3].sum(-1) > 0).sum()) > 50


@pytest.mark.parametrize("n_dev", [2, 4])
def test_slice_path_inside_domain_program(n_dev, monkeypatch):
    """With slice_axes the members march their local bricks through the
    slice engine (its plain version here), each with its own brick origin
    and TF range: one slice_march per member round with a queued ray of a
    brick, and the frame equal to the single-device slice frame."""
    bricks = chip_smoke.bricked_wavelet(N)
    rays, arena = wavefront()
    scene1 = build_volume_scene(bricks, INSTANCES, device="cpu")
    single = vt.trace_volume(scene1, arena, FILM, FILM, max_rounds=8,
                             slice_axes=vt.slice_axes_for(scene1,
                                                          rays.direction))
    stacked, owners = vd.partition_volume_scene(bricks, INSTANCES, n_dev,
                                                device="cpu")
    axes = vt.slice_axes_for(stacked, rays.direction)
    origins, orig = [], sm.slice_march

    def spy(*args, **kw):
        origins.append(kw["origin"].tolist())
        return orig(*args, **kw)

    monkeypatch.setattr(sm, "slice_march", spy)
    fb = vd.trace_volume_domain(stacked, owners, arena, FILM, FILM,
                                mesh(n_dev), max_rounds=8, slice_axes=axes)
    assert torch.equal(fb, single)
    assert [0.0, 0.0, 0.0] in origins and [N / 2, 0.0, 0.0] in origins
    gather = vd.trace_volume_domain(stacked, owners, arena, FILM, FILM,
                                    mesh(n_dev), max_rounds=8)
    assert float((gather - fb)[:, :3].abs().max()) > 1e-4


def test_members_march_only_bricks_holding_rays(monkeypatch):
    """Over 4 members holding 2 bricks (members 2 and 3 hold a padded copy
    of brick 0 and own no instance), each round's brick passes
    (`volume.march_*` spans) number no more than the members holding a
    queued ray of a local brick; the frame is the single-device one."""
    bricks = chip_smoke.bricked_wavelet(N)
    _, arena = wavefront()
    stacked, owners = vd.partition_volume_scene(bricks, INSTANCES, 4,
                                                device="cpu")
    calls, orig = [], vt.march_round

    def spy(scene, a, *args, **kw):
        queued = a.active & (a.inst >= 0)
        local = scene.inst_vol[a.inst.clamp(min=0).long()] >= 0
        since = len(timing.recorded())
        out = orig(scene, a, *args, **kw)
        calls.append((bool((queued & local).any()), sum(
            s.name.startswith("volume.march_")
            for s in timing.recorded(since))))
        return out

    monkeypatch.setattr(vt, "march_round", spy)
    with timing.recording():
        fb = vd.trace_volume_domain(stacked, owners, arena, FILM, FILM,
                                    mesh(4), max_rounds=8)
    rounds = [calls[k:k + 4] for k in range(0, len(calls), 4)]
    assert len(calls) % 4 == 0 and len(rounds) >= 2
    for members in rounds:
        assert sum(n for _, n in members) <= sum(h for h, _ in members)
    assert sum(n for _, n in calls) > 0
    single = vt.trace_volume(build_volume_scene(bricks, INSTANCES,
                                                device="cpu"),
                             arena, FILM, FILM, max_rounds=8)
    assert float((fb - single)[:, :3].abs().max()) < 1e-5


def test_exchange_overflow_counted():
    """A cap of one ray per destination drops migrating rays, counted."""
    bricks = chip_smoke.bricked_wavelet(N)
    _, arena = wavefront()
    stacked, owners = vd.partition_volume_scene(bricks, INSTANCES, 2,
                                                device="cpu")
    _, drops = vd.trace_volume_domain(stacked, owners, arena, FILM, FILM,
                                      mesh(2), max_rounds=8, exchange_cap=1,
                                      return_stats=True)
    assert int(drops) > 0


def write_golden(path=GOLDEN) -> None:
    """JAX's frames for the tests above (run by hand)."""
    from gravit_tpu.render.tracer import make_arena as jax_arena

    _, bricks = tp.bricked_wavelet(N)
    arena = jax_arena(tp.jax_camera(camera()).generate_rays(volume=True), 0)
    out = {}
    for n_dev in (2, 4):
        stacked, owners = jvd.partition_volume_scene(bricks, INSTANCES,
                                                     n_dev)
        out[f"fb_{n_dev}"] = np.asarray(jvd.trace_volume_domain(
            stacked, owners, arena, FILM, FILM, tp.jax_mesh((n_dev,)),
            max_rounds=8))
    np.savez_compressed(path, **out)


if __name__ == "__main__":
    if "--write-golden" in sys.argv:
        write_golden()
        print("wrote", GOLDEN)
