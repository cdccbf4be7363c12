"""Shared inputs of the port's kernel tests (numpy only: no jax, no torch)."""

import numpy as np


def finish_rows(rng, R, B, density=0.2):
    """Sp/m rows for the finish: exact ties at the K cut, n = 0, n < K, a
    Q1-wrapped m = 2**64 (a read shorter than k) and a Q3 row (every
    10**score underflows in double); the other rows touch about ``density``
    of the branches."""
    Sp = rng.uniform(0.0, 30.0, (R, B)).astype(np.float32)
    Sp[rng.random((R, B)) > density] = 0.0
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


def counts_rows(rng, R, B, density=0.2):
    """S f32 / C int32 (R, B) classic sums and exact counts, and m f32 (R,),
    for the counts finish: the classic sums are negative (a cell holds a
    log10 score), the ambiguous first hit adds a positive contribution; rows
    with n = 0, n < K, 20 exact ties straddling the K cut, C > m (the Q1 wrap
    of m - C to 2**64), m = 2**64 (a read shorter than k), a Q3 row (every
    10**score underflows in double), and touched cells whose sum is 0 or
    positive beside untouched cells (C = 0) whose sum is not (touched is C >
    0, never S); the other rows touch about ``density`` of the branches."""
    R = max(R, 8)
    C = rng.integers(1, 12, (R, B)).astype(np.int32)
    C[rng.random((R, B)) > density] = 0
    S = (-rng.uniform(0.05, 2.5, (R, B)) * C).astype(np.float32)
    pos = rng.random((R, B)) < 0.05
    S[pos] += rng.uniform(0.0, 3.0, int(pos.sum())).astype(np.float32)
    m = rng.integers(80, 150, R).astype(np.float32)
    S[0], C[0] = 0.0, 0  # n == 0
    S[1], C[1] = 0.0, 0
    S[1, [3, B - 1]], C[1, [3, B - 1]] = [-2.0, -5.0], [1, 2]  # n < K
    S[2], C[2] = 0.0, 0
    S[2, 10:30], C[2, 10:30] = -4.5, 3  # 20 exact ties
    m[3] = 5.0
    S[3], C[3] = 0.0, 0
    S[3, :min(40, B - 3)], C[3, :min(40, B - 3)] = -3.0, 9  # C > m: wraps to 2**64 (Q1)
    S[3, B - 3:], C[3, B - 3:] = -1.0, 2  # C < m: these three lead
    m[4] = np.float32(2.0**64)  # quirk Q1: a read shorter than k
    m[5] = 4000.0  # quirk Q3
    S[6], C[6] = 0.0, 0
    S[6, :5], C[6, :5] = [0.0, 0.0, 1.5, 2.5, -0.0], 1  # touched at S = 0 and S > 0
    C[6, 5:10], S[6, 5:10] = 0, 7.0  # untouched however large the sum
    return S, C, m


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


def packed_rows(rng, R, PP, B):
    """:func:`packed_cells` with more engineered rows (as far as R allows):
    5, every cell on its own branch (``min(PP, B)`` branches touched); 6, a
    Q3 row (m = 4000: every 10**score underflows in double); 7, cells
    cycling over all B branches (every branch touched when PP >= B)."""
    p, m = packed_cells(rng, R, PP, B)
    trash = (-(-(B + 1) // 128) * 128 - 1) << 16
    q = rng.integers(1, 64001, PP)
    distinct = np.full(PP, trash, np.int64)
    nd = min(PP, B)
    distinct[:nd] = (rng.permutation(B)[:nd] << 16) | q[:nd]
    if R > 5:
        p[5] = distinct.astype(np.int32)
    if R > 6:
        m[6] = 4000.0  # quirk Q3
    if R > 7:
        p[7] = (((np.arange(PP) % B) << 16) | q).astype(np.int32)
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


#: the row of :func:`score_rows` whose sums depend on the order of the adds
MIXED_ROW = 6


def score_rows(rng, R, PP, B, edges=None):
    """:func:`score_cells` with engineered rows 1-8 (as far as R allows) that
    pin the cell-order contract of the segment sums: trash cells interleaved
    with valid ones; one branch hit by the first 100 cells, and by every 8th
    cell; every branch a multiple of 32 (one owner warp takes the whole row);
    cells alternating at the tile edges ``e - 1`` / ``e`` of ``edges``
    (default: the edge of two equal tiles) and at ``B - 1`` / ``B``; an all-trash row; scores of mixed magnitude (1e8, 1,
    -1e8) on a few branches, so that another order of the adds gives other
    bits; ``-0.0`` scores, alone on some branches. Trash cells carry a
    nonzero score, which must be skipped with them."""
    b, s = score_cells(rng, R, PP, B)
    edges = (-(-B // 2),) if edges is None else edges
    trash = -(-(B + 1) // 128) * 128 - 1
    col = np.arange(PP)

    def rand_b():
        return rng.integers(0, B, PP).astype(np.int32)

    def rand_s():
        return rng.uniform(-4.0, 8.5, PP).astype(np.float32)

    rows = []
    bb = rand_b()  # 1: trash interleaved: every third cell, and a random tenth
    bb[(col % 3 == 1) | (rng.random(PP) < 0.1)] = trash
    rows.append((bb, rand_s()))
    bb = rand_b()  # 2: a run of 100 cells on one branch, and every 8th cell on another
    bb[:100] = 5 % B
    bb[100::8] = 7 % B
    rows.append((bb, rand_s()))
    # 3: one owner warp (of 16 or 32) takes every cell
    rows.append(((rng.integers(0, -(-B // 32), PP) * 32 % B).astype(np.int32), rand_s()))
    pairs = [x for e in (*edges, B) for x in (e - 1, e)]  # 4: the tile edges
    bb = np.asarray(pairs, np.int32)[col % len(pairs)]
    bb[bb >= B] = trash
    rows.append((bb, rand_s()))
    rows.append((np.full(PP, trash, np.int32), rand_s()))  # 5: all trash
    # 6 (MIXED_ROW): mixed magnitudes on 3 branches: 1e8 + 1 rounds back to 1e8
    mags = np.array([1e8, 1.0, -1e8, 1.0, 3.0, -1e8, 1e8], np.float32)
    rows.append(((col % 3 * 97 % B).astype(np.int32), mags[col % len(mags)]))
    ss = rand_s()  # 7: -0.0 scores, alone on branch 11, mixed on branch 12
    bb = rand_b()
    bb[::5] = 11 % B
    ss[::5] = -0.0
    bb[1::5] = 12 % B
    ss[1::10] = -0.0
    rows.append((bb, ss))
    bb = rand_b()  # 8: a valid prefix, then trash (the CSR step's padding)
    bb[PP // 3:] = trash
    rows.append((bb, rand_s()))
    for i, (bb, ss) in enumerate(rows[:R - 1], start=1):
        b[i], s[i] = bb, ss
    s[b >= B] = 7.0
    return b, s


def cell_order_sums(b, s, B):
    """The segment sums as a Python loop over each row's cells in order: f32
    sums (each add rounded to f32) and int64 counts of the cells with branch
    ``< B``."""
    R, PP = b.shape
    S = np.zeros((R, B), np.float32)
    C = np.zeros((R, B), np.int64)
    for r in range(R):
        for c in range(PP):
            j = b[r, c]
            if j < B:
                S[r, j] = np.float32(S[r, j] + s[r, c])
                C[r, j] += 1
    return S, C
