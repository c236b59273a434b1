"""The port's production dry run (``repro_torch.launch.dryrun``) and
meshes (``repro_torch.launch.mesh``) on the CPU.

The reference's miniature (``tests/test_fourd_multidevice.py``'s
``test_gnn_production_dryrun_small``: a (2, 2, 2, 2) mesh, n_pad 4096,
batch 256, d 32/64, 3 layers, 8 classes, dropout 0.1) runs as rank 0 of
16 on the fake backend and the meta device, in one subprocess (the
process group is process-global). The full (4, 4, 4, 4) and (8, 4, 4, 4)
dry runs are ``chip_smoke.py``'s.
"""
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MINIATURE = """
import json
import torch
from repro.graphs import make_synthetic_dataset
from repro_torch.core import fourd
from repro_torch.core import gcn_model as M
from repro_torch.graphs import build_partitioned_graph
from repro_torch.launch import dryrun, mesh
rec = dryrun.run_gnn_dryrun(
    mesh_shape=(2, 2, 2, 2), rank=0, save=False,
    dims=dict(n_pad=4096, e_pad=40000, batch=256, d_in=32, d_hidden=64,
              num_classes=8, max_row_nnz=32, e_cap=128 * 32))

# the dry run's shards against shard_graph's on a real graph, every rank
ds = make_synthetic_dataset(n=512, num_classes=8, d_in=32, avg_degree=4,
                            seed=0)
pg = build_partitioned_graph(ds, g=2)
cfg = M.GCNConfig(d_in=32, d_hidden=64, num_layers=3, num_classes=8)
layout = []
def describe(graph):
    adj = graph["adj"]
    return {"keys": sorted(graph),
            "adj": [[[list(t.shape), str(t.dtype)] for t in blk]
                    for blk in adj],
            "shared": [[a is b for b in adj] for a in adj],
            "rest": {k: [list(v.shape), str(v.dtype), v.device.type]
                     for k, v in graph.items() if k != "adj"}}
for r in range(16):
    dryrun.init_fake_group(r, 16)
    plan = fourd.build_plan(pg, cfg, fourd.make_mesh_4d(2, 2, "meta"),
                            batch=64)
    real = describe(plan.shard_graph(pg))
    fake = describe(dryrun.meta_graph(plan, pg.n_local, pg.e_pad, cfg.d_in))
    layout.append([real, fake])

shapes = {}
for multi in (False, True):
    for name, make in (("train", mesh.make_production_mesh_4d),
                       ("serve", mesh.make_production_serve_mesh)):
        dryrun.init_fake_group(0, 512 if multi else 256)
        shapes[f"{name}_{multi}"] = make(multi_pod=multi,
                                         device="meta").shape
    dryrun.init_fake_group(3, 512 if multi else 256)
    llm = mesh.make_production_mesh(multi_pod=multi, device="meta")
    shapes[f"llm_{multi}"] = {"shape": list(llm.shape.items()),
                              "coords": llm.coords,
                              "axes": {"+".join(k): [a.size, a.index]
                                       for k, a in llm.axes.items()}}
torch.distributed.destroy_process_group()
print(json.dumps({"rec": rec, "layout": layout, "shapes": shapes},
                 default=str))
"""


@pytest.fixture(scope="module")
def probe():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", MINIATURE], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def miniature(probe):
    return probe["rec"]


def test_miniature_dry_run_is_ok(miniature):
    rec = miniature
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["n_devices"] == 16 and rec["device"] == "meta"
    assert rec["flops_per_device"] > 0 and rec["bytes_per_device"] > 0
    assert rec["memory"]["temp_bytes"] > 0
    # the extraction's count on meta is its every-slot bound
    assert rec["loop_aware"]["upper_bound"] is True
    assert rec["params"] == 32 * 64 + 3 * (64 * 64 + 64) + 64 * 8


def test_miniature_argument_bytes_are_the_rank_s_shards(miniature):
    """Rank 0's params (each sharded by its plane), AdamW's two moments of
    them and its step counter, and its graph shards: at rank 0 every
    rotation plane's block is block (0, 0), held once."""
    g, n_local, e_pad = 2, 2048, 40000
    params = (32 // g * 64 // g + 3 * (64 // g * 64 // g + 64 // g)
              + 64 // g * 8 // g) * 4
    from repro_torch.optim.adamw import _step_counter
    counter = _step_counter({"w": torch.zeros(1)}).element_size()
    graph = ((n_local + 1) * 4 + e_pad * 4 + e_pad * 4
             + n_local * 32 // g * 4 + n_local * 4)
    assert miniature["memory"]["argument_bytes"] == 3 * params + counter \
        + graph


def test_miniature_collectives(miniature):
    """The PMM all-reduces are there, nothing exotic, and sampling is
    communication-free (the reference's ``test_collective_bytes_
    accounting_2x2x2x2``, on the port's own step)."""
    counts = miniature["collective_counts_per_device"]
    byts = miniature["collective_bytes_per_device"]
    assert counts["all-reduce"] > 0 and byts["all-reduce"] > 0
    assert counts["all-to-all"] == 0 and counts["reduce-scatter"] == 0
    assert miniature["sampling_collectives"] == 0
    assert miniature["loop_aware"]["coll_total"] == sum(byts.values())


def test_meta_shards_are_shard_graph_s(probe):
    """``meta_graph`` gives every rank of the (2, 2, 2, 2) mesh the keys,
    shapes, dtypes and block sharing that ``FourDPlan.shard_graph`` gives
    it from a real partitioned graph (n 512, g 2), on the meta device."""
    assert len(probe["layout"]) == 16
    for r, (real, fake) in enumerate(probe["layout"]):
        assert real == fake, r
        assert real["rest"]["features"][2] == "meta"
    # ranks whose three planes hold distinct blocks are among them
    assert any(not any(row[j] for j in range(3) if j != i)
               for real, _ in probe["layout"]
               for i, row in enumerate(real["shared"]))


def test_production_meshes(probe):
    """The production meshes on the fake backend: (4, 4, 4, 4) and
    (8, 4, 4, 4) for training, (32, 2, 2, 2) and (64, 2, 2, 2) for
    serving."""
    want = {"train_False": (4, 4, 4, 4), "train_True": (8, 4, 4, 4),
            "serve_False": (32, 2, 2, 2), "serve_True": (64, 2, 2, 2)}
    for key, shape in want.items():
        got = probe["shapes"][key]
        assert tuple(got[a] for a in ("d", "x", "y", "z")) == shape, key


def test_llm_production_meshes(probe):
    """The LLM production mesh on the fake backend, as rank 3: (16, 16)
    ("data", "model") over 256 ranks and (2, 16, 16) ("pod", "data",
    "model") over 512, row-major coordinates, one group per axis, the DP
    axes together (two pods) and the whole mesh."""
    from repro_torch.launch import mesh
    assert mesh.MESH_LLM == {False: (16, 16), True: (2, 16, 16)}
    assert mesh.MESH_4D == {False: (4, 4, 4, 4), True: (8, 4, 4, 4)}
    assert mesh.SERVE_MESH == {False: (32, 2, 2, 2), True: (64, 2, 2, 2)}
    single, multi = probe["shapes"]["llm_False"], probe["shapes"]["llm_True"]
    assert single["shape"] == [["data", 16], ["model", 16]]
    assert multi["shape"] == [["pod", 2], ["data", 16], ["model", 16]]
    assert single["coords"] == {"data": 0, "model": 3}
    assert multi["coords"] == {"pod": 0, "data": 0, "model": 3}
    assert single["axes"] == {"data": [16, 0], "model": [16, 3],
                              "data+model": [256, 3]}
    assert multi["axes"] == {"pod": [2, 0], "data": [16, 0],
                             "model": [16, 3], "data+pod": [32, 0],
                             "data+model+pod": [512, 3]}
