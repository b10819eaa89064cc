"""The port's scene readers (gravit_tpu_torch/scene/readers/) against the
JAX package's, on files the tests write: OBJ with its MTL, ASCII and
binary PLY and a PLY directory, the render and geometry .conf formats with
their error cases, BOV bricks with colour and opacity maps, and an ASCII
VTK AMR index with its structured-points grids. The readers are numpy host
code copied into the port, so every output must be equal, field for field
(torch_parity.assert_tree_equal), including the compiled mesh arrays."""

import struct

import numpy as np
import pytest

import torch_parity as tp  # noqa: I001 (puts the repo root on sys.path)
from gravit_tpu.scene.readers import bov as jbov
from gravit_tpu.scene.readers import conf as jconf
from gravit_tpu.scene.readers import obj as jobj
from gravit_tpu.scene.readers import ply as jply
from gravit_tpu.scene.readers import vtk as jvtk

from gravit_tpu_torch.scene.readers import bov, conf, obj, ply, vtk


def both(fn_port, fn_jax, *args, **kw):
    a, b = fn_port(*args, **kw), fn_jax(*args, **kw)
    tp.assert_tree_equal(a, b)
    return a


def write_obj(tmp_path, normals=False):
    (tmp_path / "scene.mtl").write_text(
        "newmtl red\nKd 1.0 0.0 0.0\nKs 0.2 0.2 0.2\nNs 8\n"
        "newmtl blue\nKd 0.0 0.0 1.0\nKa 0.1 0.1 0.1\n")
    body = ("mtllib scene.mtl\nv 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 0\n"
            "v 1 1 1\n")
    if normals:
        body += "vn 0 0 2\nvn 0 0 1\nvn 0 1 1\nvn 1 1 1\nvn 0 0 1\n"
        body += ("usemtl red\nf 1//1 2//2 3//3\nusemtl blue\n"
                 "f 2//2 4//4 5//5 3//3\nf -1//5 -2//4 -3//3\n")
    else:
        body += ("usemtl red\nf 1 2 3\nusemtl blue\nf 2/1 4/2 5/3 3/4\n"
                 "f -1 -2 -3\n")
    (tmp_path / "tri.obj").write_text(body)
    return str(tmp_path / "tri.obj")


@pytest.mark.parametrize("normals", [False, True])
@pytest.mark.parametrize("material_type", [0, 1])
def test_obj_with_mtl_equal_jax(tmp_path, normals, material_type):
    path = write_obj(tmp_path, normals)
    m = both(obj.read_obj, jobj.read_obj, path, material_type=material_type)
    assert len(m.faces) == 4 and len(m.face_materials) == 4
    assert m.face_materials[0].kd == (1.0, 0.0, 0.0)
    assert m.face_materials[0].type == material_type
    tp.assert_tree_equal(m.compile(), jobj.read_obj(
        path, material_type=material_type).compile())
    tp.assert_tree_equal(obj.read_mtl(str(tmp_path / "scene.mtl")),
                         jobj.read_mtl(str(tmp_path / "scene.mtl")))


def test_ply_ascii_equal_jax(tmp_path):
    (tmp_path / "t.ply").write_text(
        "ply\nformat ascii 1.0\nelement vertex 5\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property float confidence\n"
        "element face 3\nproperty list uchar int vertex_indices\n"
        "end_header\n"
        "0 0 0 1\n1 0 0 1\n0 1 0 1\n1 1 0 1\n0.5 0.5 1 1\n"
        "3 0 1 2\n4 1 3 4 2\n2 0 1\n")
    m = both(ply.read_ply, jply.read_ply, str(tmp_path / "t.ply"))
    assert len(m.vertices) == 5 and len(m.faces) == 3
    tp.assert_tree_equal(m.compile(),
                         jply.read_ply(str(tmp_path / "t.ply")).compile())


def _binary_ply(path, verts, faces):
    head = ("ply\nformat binary_little_endian 1.0\n"
            f"element vertex {len(verts)}\nproperty float x\n"
            "property float y\nproperty float z\n"
            f"element face {len(faces)}\n"
            "property list uchar int vertex_indices\nend_header\n")
    body = b"".join(struct.pack("<3f", *v) for v in verts)
    body += b"".join(struct.pack("<B%di" % len(f), len(f), *f)
                     for f in faces)
    path.write_bytes(head.encode() + body)


def test_ply_binary_and_directory_equal_jax(tmp_path):
    rng = np.random.default_rng(3)
    for k in range(3):
        verts = rng.uniform(-1, 1, (6, 3)).astype(np.float32)
        _binary_ply(tmp_path / f"d{k}.ply", verts,
                    [(0, 1, 2), (2, 3, 4, 5), (1, 3, 5)])
    m = both(ply.read_ply, jply.read_ply, str(tmp_path / "d0.ply"))
    assert len(m.faces) == 4
    for rank, size in ((0, 1), (1, 2)):
        both(ply.read_ply_dir, jply.read_ply_dir, str(tmp_path), rank, size)


def test_render_conf_equal_jax(tmp_path):
    f = tmp_path / "r.conf"
    f.write_text("# a scene\n512 256\n30.0\n1 2 3\n0 0 0\n0 1 0\n"
                 "Surface\nDomain\n0.5\n2 4 8\nfoo.bov\n")
    c = both(conf.read_render_conf, jconf.read_render_conf, str(f))
    assert (c.width, c.height, c.schedule_type) == (512, 256, "Domain")


def test_geom_conf_equal_jax(tmp_path):
    f = tmp_path / "g.conf"
    f.write_text("# domains\nmesh0.ply 0 0 0 1 1 1\n"
                 "sub/mesh1.obj -1 -2 -3 0 0.5 1\n")
    entries = both(conf.read_geom_conf, jconf.read_geom_conf, str(f))
    assert len(entries) == 2 and entries[1].lo == (-1.0, -2.0, -3.0)


@pytest.mark.parametrize("text,which,match", [
    ("512 256\n30.0\n1 2\n", "render", r"t\.conf.*camera"),
    ("512 wide\n", "render", r"t\.conf:1.*height.*int.*wide"),
    ("# only comments\n", "render", "width"),
    ("# header\nmesh.ply 0 0 0 1 1\n", "geom", r"t\.conf:2.*7 tokens"),
    ("mesh.ply 0 0 zero 1 1 1\n", "geom", r"t\.conf:1.*bad bounds"),
])
def test_conf_errors_equal_jax(tmp_path, text, which, match):
    """Malformed and truncated files raise ConfError naming the file, the
    field and the position, with the JAX package's message."""
    f = tmp_path / "t.conf"
    f.write_text(text)
    port = {"render": conf.read_render_conf, "geom": conf.read_geom_conf}
    ref = {"render": jconf.read_render_conf, "geom": jconf.read_geom_conf}
    with pytest.raises(conf.ConfError, match=match) as got:
        port[which](str(f))
    with pytest.raises(jconf.ConfError) as want:
        ref[which](str(f))
    assert str(got.value) == str(want.value)


def _write_bov(tmp_path, divide: bool):
    data = np.random.default_rng(1).uniform(0, 100, 5 * 6 * 7)
    data.astype(np.float32).tofile(tmp_path / "cube.raw")
    (tmp_path / "cube.bov").write_text(
        "TIME: 1.0\nDATA_FILE: cube.raw\nDATA_SIZE: 7 6 5\n"
        "DATA_FORMAT: FLOAT\nVARIABLE: v\nDATA_ENDIAN: LITTLE\n"
        f"DIVIDE_BRICK: {'true' if divide else 'false'}\n"
        "DATA_BRICKLETS: 4 3 3\n")
    (tmp_path / "c.cmap").write_text(
        "3\n0 0 0 0\n0.5 1 0 0\n1 1 1 1\n")
    (tmp_path / "o.omap").write_text("2\n0 0\n1 0.5\n")
    return str(tmp_path / "cube.bov")


@pytest.mark.parametrize("divide", [False, True])
def test_bov_equal_jax(tmp_path, divide):
    from gravit_tpu.scene.transfer import TransferFunction as JTF

    from gravit_tpu_torch.scene.transfer import TransferFunction

    path = _write_bov(tmp_path, divide)
    both(bov.read_bov_header, jbov.read_bov_header, path)
    vols = both(bov.read_bov, jbov.read_bov, path, sampling_rate=0.5)
    assert len(vols) == (8 if divide else 1)
    maps = (str(tmp_path / "c.cmap"), str(tmp_path / "o.omap"), 0.0, 100.0)
    tf, jtf = TransferFunction.from_files(*maps), JTF.from_files(*maps)
    tp.assert_tree_equal(tf, jtf)
    tp.assert_tree_equal(bov.read_bov(path, tf=tf), jbov.read_bov(path,
                                                                  tf=jtf))


def _write_vtk(path, dims, origin, spacing, seed):
    n = int(np.prod(dims))
    vals = np.random.default_rng(seed).uniform(0, 80, n)
    path.write_text(
        "# vtk DataFile Version 2.0\ngrid\nASCII\nDATASET STRUCTURED_POINTS\n"
        f"DIMENSIONS {dims[0]} {dims[1]} {dims[2]}\n"
        f"ORIGIN {origin[0]} {origin[1]} {origin[2]}\n"
        f"SPACING {spacing[0]} {spacing[1]} {spacing[2]}\n"
        f"POINT_DATA {n}\nSCALARS v float 1\nLOOKUP_TABLE default\n"
        + "\n".join(" ".join(f"{v:.6f}" for v in vals[i:i + 7])
                    for i in range(0, n, 7)) + "\n")


def test_vtk_amr_equal_jax(tmp_path):
    """Two level-0 grids, a level-1 grid in the first and a level-2 grid in
    that: the index, the BFS subgrid lists, the grids and the volumes."""
    grids = [("g0.vtk", (5, 4, 3), (0, 0, 0), (1, 1, 1), -1),
             ("g1.vtk", (5, 4, 3), (4, 0, 0), (1, 1, 1), -1),
             ("g2.vtk", (5, 5, 5), (1, 1, 0.5), (0.5, 0.5, 0.5), 0),
             ("g3.vtk", (3, 3, 3), (1.5, 1.5, 1), (0.25, 0.25, 0.25), 2)]
    for k, (name, dims, origin, spacing, _) in enumerate(grids):
        _write_vtk(tmp_path / name, dims, origin, spacing, k)
    (tmp_path / "s.amrvol").write_text(
        "3\n2\n1\n1\n" + "".join(f"{g[0]} {g[4]}\n" for g in grids))
    path = str(tmp_path / "s.amrvol")
    idx = both(vtk.read_amrvol, jvtk.read_amrvol, path)
    assert idx.grids_per_level == [2, 1, 1]
    for d in range(2):
        assert vtk.amr_domain_subgrids(idx, d) == \
            jvtk.amr_domain_subgrids(idx, d)
    assert vtk.amr_domain_subgrids(idx, 0) == [2, 3]
    g = both(vtk.read_vtk_structured_points, jvtk.read_vtk_structured_points,
             idx.grid_files[2])
    assert g.data.shape == (5, 5, 5)
    vols = both(vtk.read_amr_volume, jvtk.read_amr_volume, path,
                sampling_rate=2.0)
    assert [len(v.subgrids) for v in vols] == [2, 0]


def test_vtk_not_structured_points_raises(tmp_path):
    f = tmp_path / "bad.vtk"
    f.write_text("# vtk DataFile Version 2.0\nx\nASCII\nDATASET POLYDATA\n")
    with pytest.raises(ValueError, match="STRUCTURED_POINTS"):
        vtk.read_vtk_structured_points(str(f))
    with pytest.raises(ValueError, match="STRUCTURED_POINTS"):
        jvtk.read_vtk_structured_points(str(f))
