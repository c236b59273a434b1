"""The port's mmap shard ingestion against the JAX package's: the files
the two writers produce from one seed are byte-identical, and the
partitioned graphs the two readers hand back are equal array for array;
then the training CLI trains from a shard set and rehearses the locality
sampling kinds on the CPU."""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.graphs import datasets as jds  # noqa: E402
from repro_torch.graphs import datasets as tds  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402


@pytest.mark.parametrize("g, clusters", [(1, 0), (2, 8)])
def test_writers_are_byte_identical_and_readers_equal(tmp_path, g,
                                                      clusters):
    kw = dict(n=1000, g=g, d_in=8, num_classes=5, avg_degree=6,
              clusters=clusters, seed=3, chunk_rows=300)
    tds.write_mmap_shards(str(tmp_path / "port"), **kw)
    jds.write_mmap_shards(str(tmp_path / "ref"), **kw)
    names = sorted(os.listdir(tmp_path / "ref"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    assert "meta.json" in names and len(names) == 7
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "ref" / name).read_bytes(), name
    got = tds.MmapShardedCSR.open(str(tmp_path / "port")
                                  ).to_partitioned_graph()
    want = jds.MmapShardedCSR.open(str(tmp_path / "ref")
                                   ).to_partitioned_graph()
    assert isinstance(got.block_ci, np.memmap)
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name
        else:
            assert a == b, f.name
    assert got.clusters == clusters


def test_train_cli_runs_the_locality_kinds_and_mmap_shards(tmp_path,
                                                           capsys):
    """``--sample-kind partition`` (clusters sized from the batch),
    ``walk`` and a partition run over ``--mmap-dir`` each train a few
    steps on the CPU."""
    base = ["--device", "cpu", "--batch", "64", "--d-hidden", "16",
            "--steps", "4", "--eval-every", "2", "--fused-elementwise"]
    tlaunch.main(base + ["--vertices", "512", "--sample-kind",
                         "partition"])
    tlaunch.main(base + ["--vertices", "512", "--sample-kind", "walk",
                         "--walk-len", "3"])
    assert tlaunch.default_clusters(512, 64, 1, 1) == 64
    shards = str(tmp_path / "shards")
    tds.write_mmap_shards(shards, n=512, g=1, d_in=8, clusters=16, seed=1)
    tlaunch.main(base + ["--mmap-dir", shards, "--sample-kind", "partition",
                         "--sample-mode", "epoch"])
    out = capsys.readouterr().out
    assert out.count("full-graph accuracy") == 3
    assert "sample-kind=partition" in out and "sample-kind=walk" in out
    assert "mmap-synthetic N=512" in out
    with pytest.raises(SystemExit, match="written for g=1"):
        tlaunch.main(base + ["--mmap-dir", shards, "--g", "2"])
