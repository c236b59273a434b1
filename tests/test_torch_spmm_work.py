"""``spmm_ell_work`` against a count by brute force, on small block-ELL
matrices: the SpMM's and its dX's units of work (32 x 32 chunks; steps of
8 rows x 1 column in the forward and 1 row x 8 columns in the dX; the most
any one CTA of 32 output rows carries). Plain PyTorch and numpy, no JAX:

    PYTHONPATH=src python -m pytest tests/test_torch_spmm_work.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import spmm_ell as tspmm  # noqa: E402


def _brute(tiles: np.ndarray, colidx: np.ndarray, n_cb: int) -> dict:
    """The counts element by element: a chunk, a step or a tile is live if
    one of its elements is nonzero (NaN counts, -0 does not)."""
    n_rb, n_slots, bm, bn = tiles.shape
    nz = tiles != 0
    kc_n, cc_n = -(-bm // 32), -(-bn // 32)

    def block(t, r0, r1, c0, c1):
        return nz[t[0], t[1], r0:min(r1, bm), c0:min(c1, bn)]

    cells = [(rb, s) for rb in range(n_rb) for s in range(n_slots)]
    chunk = {(t, kc, cc): bool(block(t, kc * 32, kc * 32 + 32, cc * 32,
                                     cc * 32 + 32).any())
             for t in cells for kc in range(kc_n) for cc in range(cc_n)}
    fwd = {}   # (t, kc, g, column) -> live
    dxs = {}   # (t, row, cc, cg) -> live
    for t in cells:
        for kc in range(kc_n):
            for g in range(4):
                r0 = kc * 32 + g * 8
                for col in range(cc_n * 32):
                    fwd[t, kc, g, col] = bool(block(t, r0, r0 + 8, col,
                                                    col + 1).any())
        for row in range(kc_n * 32):
            for cc in range(cc_n):
                for cg in range(4):
                    c0 = cc * 32 + cg * 8
                    dxs[t, row, cc, cg] = bool(block(t, row, row + 1, c0,
                                                     c0 + 8).any())
    live = {t: bool(nz[t].any()) for t in cells}
    f_max = {"chunks": 0, "steps": 0, "warp_steps": 0, "nonzeros": 0}
    for rb in range(n_rb):
        for kc in range(kc_n):
            mine = [t for t in cells if t[0] == rb]
            warps = [sum(fwd[t, kc, g, col] for t in mine
                         for col in range(cc_n * 32)) for g in range(4)]
            cta = {"chunks": sum(chunk[t, kc, cc] for t in mine
                                 for cc in range(cc_n)),
                   "steps": sum(warps), "warp_steps": max(warps),
                   "nonzeros": sum(int(block(t, kc * 32, kc * 32 + 32, 0,
                                             bn).sum()) for t in mine)}
            f_max = {k: max(f_max[k], v) for k, v in cta.items()}
    d_max = {"tiles": 0, "chunks": 0, "steps": 0, "warp_steps": 0,
             "nonzeros": 0}
    for cb in range(n_cb):
        mine = [t for t in cells
                if min(max(int(colidx[t]), 0), n_cb - 1) == cb]
        for cc in range(cc_n):
            warps = [sum(dxs[t, row, cc, cg] for t in mine
                         for row in range(kc_n * 32)) for cg in range(4)]
            cta = {"tiles": sum(live[t] for t in mine),
                   "chunks": sum(chunk[t, kc, cc] for t in mine
                                 for kc in range(kc_n)),
                   "steps": sum(warps), "warp_steps": max(warps),
                   "nonzeros": sum(int(block(t, 0, bm, cc * 32,
                                             cc * 32 + 32).sum())
                                   for t in mine)}
            d_max = {k: max(d_max[k], v) for k, v in cta.items()}
    return {"live_tiles": sum(live.values()), "nonzeros": int(nz.sum()),
            "live_chunks": sum(chunk.values()),
            "fwd_steps": sum(fwd.values()), "dx_steps": sum(dxs.values()),
            "fwd_ctas": n_rb * kc_n, "dx_ctas": n_cb * cc_n,
            "fwd_cta_max": f_max, "dx_cta_max": d_max}


def _case(name: str):
    """(tiles, colidx, n_cb): small layouts that exercise the units."""
    rng = np.random.default_rng(11)
    if name == "diagonal":           # a self-loop a row, nothing else
        tiles = np.zeros((2, 3, 64, 64), np.float32)
        colidx = np.zeros((2, 3), np.int32)
        for rb in range(2):
            tiles[rb, 0] = np.diag(rng.uniform(0.5, 2.0, 64))
            colidx[rb, 0] = rb
        return tiles, colidx, 2
    if name == "one_nonzero":        # at a warp's edge, in a late slot
        tiles = np.zeros((2, 4, 64, 64), np.float32)
        colidx = np.zeros((2, 4), np.int32)
        tiles[1, 3, 39, 63] = -1.5
        colidx[1, 3] = 1
        return tiles, colidx, 2
    if name == "dense":              # every element of every tile
        tiles = rng.normal(size=(2, 2, 64, 32)).astype(np.float32)
        return tiles, np.array([[0, 1], [1, 0]], np.int32), 2
    if name == "padding_layout":     # padding in any slot, a live block 0
        layout = [[3, None, 1, None, 2], [2, None, 0, 1, None], [None] * 5]
        tiles = rng.normal(size=(3, 5, 32, 32)).astype(np.float32)
        tiles *= rng.random(tiles.shape) < 0.05
        colidx = np.zeros((3, 5), np.int32)
        for i, row in enumerate(layout):
            for s, cb in enumerate(row):
                if cb is None:
                    tiles[i, s] = 0.0
                else:
                    colidx[i, s] = cb
                    tiles[i, s, 0, 0] = 1.0   # live whatever the draw
        return tiles, colidx, 4
    if name == "ragged":             # bm, bn not multiples of 32
        tiles = rng.normal(size=(3, 2, 40, 12)).astype(np.float32)
        tiles *= rng.random(tiles.shape) < 0.1
        return tiles, np.array([[0, 2], [1, 1], [2, 0]], np.int32), 3
    raise ValueError(name)


KERNEL_KEYS = {"fwd": ("live_tiles", "nonzeros", "live_chunks", "fwd_steps",
                       "fwd_ctas", "fwd_cta_max"),
               "dx": ("live_tiles", "nonzeros", "live_chunks", "dx_steps",
                      "dx_ctas", "dx_cta_max")}


@pytest.mark.parametrize("kernel", ["fwd", "dx"])
@pytest.mark.parametrize("name", ["diagonal", "one_nonzero", "dense",
                                  "padding_layout", "ragged"])
def test_spmm_ell_work_counts_match_brute_force(name, kernel):
    tiles, colidx, n_cb = _case(name)
    got = tspmm.spmm_ell_work(torch.from_numpy(tiles),
                              torch.from_numpy(colidx), n_cb)
    want = _brute(tiles, colidx, n_cb)
    assert {k: got[k] for k in KERNEL_KEYS[kernel]} == \
        {k: want[k] for k in KERNEL_KEYS[kernel]}


def test_spmm_ell_work_units_on_known_layouts():
    """A diagonal tile costs 8 steps a warp in both kernels; one nonzero
    one step of one warp; -0 is no work and NaN is."""
    tiles, colidx, n_cb = _case("diagonal")
    w = tspmm.spmm_ell_work(torch.from_numpy(tiles), torch.from_numpy(colidx),
                            n_cb)
    assert w["fwd_cta_max"]["warp_steps"] == 8
    assert w["dx_cta_max"]["warp_steps"] == 8
    assert w["fwd_steps"] == w["dx_steps"] == w["nonzeros"] == 128
    assert w["live_chunks"] == 4 and w["live_tiles"] == 2
    tiles, colidx, n_cb = _case("one_nonzero")
    tiles[0, 0, 5, 5] = -0.0
    tiles[0, 1, 6, 6] = np.nan
    w = tspmm.spmm_ell_work(torch.from_numpy(tiles), torch.from_numpy(colidx),
                            n_cb)
    assert w["live_tiles"] == w["live_chunks"] == w["nonzeros"] == 2
    assert w["fwd_steps"] == w["dx_steps"] == 2
    assert w["fwd_cta_max"]["steps"] == w["dx_cta_max"]["steps"] == 1
