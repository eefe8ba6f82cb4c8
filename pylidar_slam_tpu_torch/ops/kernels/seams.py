"""Seeded inputs planted at the seams of kernels B1 and B2.

The CUDA kernels cut their work at fixed widths: B2 (``csrc/nn_argmin.cu``)
takes the model in sub-tiles of ``NN_SUB`` points, stages ``NN_TILE`` at a
time and splits V over blocks at tile boundaries; B1
(``csrc/assoc_gn.cu``) covers one row x ``ASSOC_STRIP`` columns per block
and stages a halo that wraps in azimuth and is empty beyond the border
rows.  The cases below put exact ties, empty sub-tiles and the matches that
decide a sum on those seams.  They are made with numpy from a seed, so the
CPU tests can hand the same arrays to the JAX package and the card tests
and ``chip_smoke.py`` to the kernels.
"""
from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np

NN_SUB = 32        # B2: model points per sub-tile of the two-level argmin
NN_TILE = 256      # B2: model points per shared-memory stage (and split step)
ASSOC_STRIP = 256  # B1: target columns per block


class NNSeams(NamedTuple):
    queries: np.ndarray   # (M, 3) float32
    model: np.ndarray     # (V, 3) float32
    valid: np.ndarray     # (V,) bool
    tie_rows: np.ndarray  # query rows planted on an exact tie
    tie_index: np.ndarray  # the index each of them must get: the lower valid one


def _tie_pairs(v: int) -> List[Tuple[int, int]]:
    """(a, b), a < b: rows that get identical coordinates.  Pairs straddle
    the first sub-tile boundary, every tile boundary (so every split
    boundary, whatever the split count), and the last row; two pairs have
    the empty sub-tile between them, and one has its first copy in the
    empty tile."""
    pairs = [(NN_SUB - 1, NN_SUB), (5, v - 1), (40, 4 * NN_SUB),
             (2 * NN_TILE + 10, 3 * NN_TILE + 20)]
    pairs += [(k * NN_TILE - 1, k * NN_TILE) for k in range(1, (v - 1) // NN_TILE + 1)]
    used, kept = set(), []
    for a, b in pairs:
        if 0 <= a < b < v and a not in used and b not in used:
            kept.append((a, b))
            used.update((a, b))
    return kept


def nn_seam_case(m: int, v: int, seed: int = 0) -> NNSeams:
    """Queries against a random cloud of V points (scale 20 m) with:

    * exact duplicate rows across a sub-tile, every tile and the last row
      (the lower valid index must win), one query on each;
    * an all-invalid sub-tile (rows 3*NN_SUB .. 4*NN_SUB-1, all +inf to the
      kernel) between finite ones, and an all-invalid tile (rows 2*NN_TILE
      .. 3*NN_TILE-1), where they fit;
    * every other query near a random model point.

    M and V take any size; pick them off the kernel's multiples."""
    rng = np.random.default_rng(seed)
    model = (rng.normal(size=(v, 3)) * 20.0).astype(np.float32)
    valid = rng.random(v) < 0.95
    empty = np.zeros(v, bool)
    if v >= 4 * NN_SUB + 1:
        empty[3 * NN_SUB:4 * NN_SUB] = True
    if v >= 3 * NN_TILE + 1:
        empty[2 * NN_TILE:3 * NN_TILE] = True
    pairs = _tie_pairs(v)
    for a, b in pairs:
        model[b] = model[a]
        valid[[a, b]] = True
    valid &= ~empty
    queries = (model[rng.integers(0, v, size=m)]
               + rng.normal(size=(m, 3)).astype(np.float32) * 0.3)
    pairs = pairs[:m]
    rows = np.arange(len(pairs))
    for r, (a, _) in zip(rows, pairs):
        queries[r] = model[a] + rng.normal(size=3).astype(np.float32) * 1e-3
    index = np.array([a if valid[a] else b for a, b in pairs], np.int32)
    return NNSeams(queries.astype(np.float32), model, valid, rows, index)


def assoc_seam_images(h: int, w: int, region: str, seed: int = 0):
    """(timg, model_xyz, model_normal, model_valid) as numpy arrays, with
    the target shifted one row and one column against the model, so that
    the best candidate of pixel (r, c) tends to sit at (r - 1, c - 1): at
    the first column it lies across the azimuth wrap, at the first row
    outside the image.  The target is kept only in `region`:

    * ``"wrap columns"``: the 3 first and 3 last columns;
    * ``"border rows"``: the 2 first and 2 last rows;
    * ``"strip edges"``: the 2 columns on each side of every B1 strip edge;
    * ``"all"``: everywhere.
    """
    rng = np.random.default_rng(seed)
    base = np.cumsum(rng.normal(size=(h, w, 3)).astype(np.float32) * 0.1, axis=1)
    base += np.array([20.0, -5.0, 1.0], np.float32)
    timg = base + rng.normal(size=(h, w, 3)).astype(np.float32) * 0.02
    model = np.roll(base, (-1, -1), axis=(0, 1)) \
        + rng.normal(size=(h, w, 3)).astype(np.float32) * 0.02
    normals = rng.normal(size=(h, w, 3)).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    valid = rng.random((h, w)) < 0.9
    model[~valid] = 0.0
    normals[~valid] = 0.0
    rows, cols = np.arange(h)[:, None], np.arange(w)[None, :]
    keep = {"wrap columns": (cols < 3) | (cols >= w - 3),
            "border rows": (rows < 2) | (rows >= h - 2),
            "strip edges": ((cols % ASSOC_STRIP) < 2)
            | ((cols % ASSOC_STRIP) >= ASSOC_STRIP - 2) | (cols >= w - 2),
            "all": np.ones((1, 1), bool)}[region]
    timg = np.where(np.broadcast_to(keep, (h, w))[..., None], timg,
                    np.float32(0.0)).astype(np.float32)
    return timg, model.astype(np.float32), normals, valid
