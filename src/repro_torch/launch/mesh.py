"""Production meshes.

Counterpart of ``repro/launch/mesh.py``. ``make_production_mesh_4d`` is
the paper's GNN mesh (G_d, x, y, z) with a cube 3D-PMM grid: (4, 4, 4, 4)
= 256 ranks on one pod, (8, 4, 4, 4) = 512 across two.
``make_production_serve_mesh`` is the serving mesh: a (2, 2, 2) PMM cube
per replica group, the other ranks stacked data groups, (32, 2, 2, 2) or
(64, 2, 2, 2). Both are ``fourd.make_mesh_4d`` on a process group of that
size. ``make_production_mesh`` is the LLM mesh: (16, 16) ``("data",
"model")`` = 256 ranks on one pod, (2, 16, 16) ``("pod", "data",
"model")`` = 512 across two (``models/sharding.make_llm_mesh``). All need
a process group of their size: ``torchrun`` on that many cards, or the
fake backend of the dry run (``launch/dryrun.py``, ``device="meta"``).
"""
from __future__ import annotations

from repro_torch.core import fourd
from repro_torch.models import sharding

MESH_LLM = {False: (16, 16), True: (2, 16, 16)}
MESH_4D = {False: (4, 4, 4, 4), True: (8, 4, 4, 4)}
SERVE_MESH = {False: (32, 2, 2, 2), True: (64, 2, 2, 2)}


def make_production_mesh(*, multi_pod: bool = False,
                         device=None) -> sharding.LLMMesh:
    """The LLM production mesh over the current process group."""
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return sharding.make_llm_mesh(MESH_LLM[multi_pod], axes, device)


def make_production_mesh_4d(*, multi_pod: bool = False,
                            device=None) -> fourd.Mesh:
    """ScaleGNN's 4D grid at production scale (cube 3D-PMM, §VII-C)."""
    g_d, g = MESH_4D[multi_pod][:2]
    return fourd.make_mesh_4d(g_d, g, device)


def make_production_serve_mesh(*, multi_pod: bool = False,
                               device=None) -> fourd.Mesh:
    """The serving mesh at production scale: a (2, 2, 2) cube per replica
    group and 32 groups on one pod (256 ranks), 64 across two."""
    g_d, g = SERVE_MESH[multi_pod][:2]
    return fourd.make_mesh_4d(g_d, g, device)
