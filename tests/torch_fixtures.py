"""Shared inputs of the port's kernel tests (numpy only: no jax, no torch)."""

import numpy as np


def finish_rows(rng, R, B):
    """Sp/m rows for the finish: exact ties at the K cut, n = 0, n < K, a
    Q1-wrapped m = 2**64 (a read shorter than k) and a Q3 row (every
    10**score underflows in double)."""
    Sp = rng.uniform(0.0, 30.0, (R, B)).astype(np.float32)
    Sp[rng.random((R, B)) > 0.2] = 0.0
    Sp[0] = 0.0  # n == 0
    Sp[1] = 0.0
    Sp[1, [3, B - 1]] = [2.0, 5.0]  # n < K
    Sp[2] = 0.0
    Sp[2, 10:30] = 7.5  # 20 exact ties straddling the K cut
    Sp[3, ::3] = 4.25  # ties across the whole row
    m = rng.integers(80, 150, R).astype(np.float32)
    m[4] = np.float32(2.0**64)  # quirk Q1
    Sp[4, :5] = 1.0
    m[5] = 4000.0  # quirk Q3
    return Sp, m


def packed_cells(rng, R, PP, B, fill=0.5):
    """Packed posting-tile cells ``(branch << 16) | q`` int32 (R, PP) and
    window counts m f32 (R,): random cells with trash padding
    (``(tile_width(B) - 1) << 16``), plus engineered rows -- n == 0, n < K,
    20 exact ties straddling the K cut, a Q1-wrapped m = 2**64 -- and, when
    PP allows, one branch hit by many cells of the row."""
    trash = (-(-(B + 1) // 128) * 128 - 1) << 16
    b = rng.integers(0, B, (R, PP))
    q = rng.integers(1, 64001, (R, PP))
    p = ((b << 16) | q).astype(np.int32)
    p[rng.random((R, PP)) > fill] = trash
    p[0] = trash  # n == 0
    p[1] = trash
    p[1, :2] = [(3 << 16) | 500, ((B - 1) << 16) | 900]  # n < K
    p[2] = trash
    n_tie = min(20, PP, B - 10)
    p[2, :n_tie] = ((np.arange(10, 10 + n_tie) << 16) | 1000)  # exact ties
    if PP >= 64:
        p[3, :64] = (5 << 16) | 64000  # one branch, 64 cells
    m = rng.integers(80, 150, R).astype(np.float32)
    m[4] = np.float32(2.0**64)  # quirk Q1
    return p, m


def score_cells(rng, R, PP, B, fill=0.6):
    """(branch, score) cells: b int32 (R, PP) with trash padding
    (``tile_width(B) - 1``), s f32 (R, PP) with 0 at trash cells; one row
    hits one branch with every cell, to exercise a long sum in cell order."""
    trash = -(-(B + 1) // 128) * 128 - 1
    b = rng.integers(0, B, (R, PP)).astype(np.int32)
    s = rng.uniform(-4.0, 8.5, (R, PP)).astype(np.float32)
    pad = rng.random((R, PP)) > fill
    b[pad] = trash
    s[pad] = 0.0
    b[0] = B - 1
    return b, s
