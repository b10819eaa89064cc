"""`import gvt` drop-in for pygvt (pygvt/src/gvt/gvt.pyx surface) on the
port; counterpart of the repository's top-level gvt.py.

The reference's Cython module wraps api::* 1:1; this module re-exports
gravit_tpu_torch.api under the exact pygvt names (including the pygvt-only
addMeshMaterialLambert/Specular and modifyLight2 spellings) so the pygvt
examples (gvtVol_serial.py & co.) run unchanged on the card:
`from gravit_tpu_torch import gvt`.
"""

from gravit_tpu_torch import api as _api
from gravit_tpu_torch.api import (  # noqa: F401
    Adapter, Schedule, addAmrSubgrid, addAreaLight, addCamera, addFilm,
    addInstance, addMeshFaceNormals, addMeshTriangles, addMeshVertexNormals,
    addMeshVertices, addPointLight, addRenderer, addVolumeSamples,
    addVolumeTransferFunctions, createMesh, createVolume, finishMesh,
    gvtInit, gvtsync, modifyFilm, render, writeimage)


def addMeshMaterialLambert(name, mattype, kd, alpha):
    _api.addMeshMaterial(name, mattype, kd, alpha)


def addMeshMaterialSpecular(name, mattype, kd, ks, alpha):
    _api.addMeshMaterial(name, mattype, kd, ks, alpha)


def modifyLight(name, pos, color):
    _api.modifyLight(name, pos, color)


def modifyLight2(name, pos, color, n, w, h):
    _api.modifyLight(name, pos, color, n, w, h)


def modifyCamera(name, pos, focus, up, fov):
    _api.modifyCamera(name, pos, focus, up, fov)


def addFilm(name, w, h, path=""):  # noqa: F811 (pygvt requires path)
    _api.addFilm(name, w, h, path)
