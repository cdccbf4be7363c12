"""Seeded inputs of the benchmark: the database arrays and the reads.

``reference_like_db`` is a frozen, vectorised copy of the port's
``io/build.py::reference_like_db``: for the same arguments it returns the same
arrays (a CPU test holds them equal), so a later change to the port's
``io/build.py`` cannot move the benchmark's data. ``make_reads`` is the one general read
generator that every traffic mix drives by its parameters.

Nothing here imports the port or JAX.
"""

from __future__ import annotations

import math

import numpy as np

LETTERS = b"ACGT"
SIGMA = 4
EARLIEST_INDEX = 4


def log10_score_threshold(omega: float, k: int, sigma: int = SIGMA) -> float:
    """log10 of the float32 score floor (omega / sigma) ** k."""
    eps32 = np.float32((omega / sigma) ** k)
    return float(np.float32(math.log10(float(eps32))))


def random_tree_newick(num_leaves: int, rng: np.random.Generator) -> str:
    """A random binary tree with branch lengths, leaves L0..L{n-1}; the
    draws are the port's, in its order."""
    subtrees = [f"L{i}:{rng.uniform(0.01, 0.5):.6f}" for i in range(num_leaves)]
    while len(subtrees) > 1:
        i = int(rng.integers(len(subtrees)))
        a = subtrees.pop(i)
        j = int(rng.integers(len(subtrees)))
        b = subtrees.pop(j)
        bl = f":{rng.uniform(0.01, 0.5):.6f}" if len(subtrees) else ""
        subtrees.append(f"({a},{b}){bl}")
    return subtrees[0] + ";"


def rolling_keys(codes: np.ndarray, k: int) -> np.ndarray:
    """Base-4 keys (first base most significant) of every length-k window of
    ``codes`` (values 0-3)."""
    n = codes.shape[0] - k + 1
    if n <= 0:
        return np.empty(0, np.uint64)
    keys = np.zeros(n, np.uint64)
    c = codes.astype(np.uint64)
    for j in range(k):
        keys = keys * np.uint64(SIGMA) + c[j:j + n]
    return keys


def reference_like_db(num_leaves: int, kmer_size: int, ref_length: int,
                      mean_posting_len: float = 12.0, omega: float = 1.5,
                      seed: int = 0) -> dict:
    """The database whose keys are the k-mers of a random reference sequence.

    Returns a dict: ``keys`` (uint64, sorted), ``row_off`` (int64),
    ``branches`` (uint32), ``scores`` (float32), ``newick``, ``ref`` (bytes),
    ``num_branches``, ``kmer_size``, ``omega``. Every posting list holds
    distinct branches and every score lies in [log10(eps), -0.05).
    """
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(LETTERS, dtype=np.uint8)
    codes = rng.integers(0, SIGMA, ref_length)
    ref = letters[codes].tobytes()
    keys = np.unique(rolling_keys(codes, kmer_size))

    newick = random_tree_newick(num_leaves, rng)
    num_branches = 2 * num_leaves - 1  # a rooted binary tree
    n = keys.shape[0]
    lens = np.minimum(1 + rng.poisson(mean_posting_len - 1, size=n), num_branches)
    row_off = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    total = int(row_off[-1])
    branches = rng.integers(0, num_branches, size=total).astype(np.uint32)
    # one score per (k-mer, branch): redraw the repeated entries until none
    # is left. The port sorts every posting each round; only rows that were
    # redrawn can repeat a branch, so the later rounds sort those rows alone,
    # which gives the same entries in the same order and the same draws.
    row_id = np.repeat(np.arange(n, dtype=np.int64), lens)
    cand = np.arange(total, dtype=np.int64)
    for _ in range(200):
        key = row_id[cand] * np.int64(num_branches) + branches[cand]
        order = cand[np.argsort(key, kind="stable")]
        sk = row_id[order] * np.int64(num_branches) + branches[order]
        dup = np.diff(sk) == 0
        if not dup.any():
            break
        idx = order[1:][dup]
        branches[idx] = rng.integers(0, num_branches, idx.size)
        redrawn = np.zeros(n, dtype=bool)
        redrawn[row_id[idx]] = True
        cand = np.flatnonzero(redrawn[row_id])
    else:  # pragma: no cover
        raise RuntimeError("per-row branch dedup did not converge")
    log_eps = log10_score_threshold(omega, kmer_size)
    scores = rng.uniform(log_eps, -0.05, size=total).astype(np.float32)
    return {"keys": keys.astype(np.uint64), "row_off": row_off, "branches": branches,
            "scores": scores, "newick": newick, "ref": ref, "num_branches": num_branches,
            "kmer_size": kmer_size, "omega": omega}


def spread_lengths(n: int, lo: int, hi: int) -> np.ndarray:
    """``n`` lengths spread evenly over [lo, hi] (the same multiset for every
    seed; the seed only orders them)."""
    return lo + ((2 * np.arange(n, dtype=np.int64) + 1) * (hi - lo + 1)) // (2 * n)


def make_reads(ref: bytes, n: int, lengths: tuple[int, int], divergence: float,
               iupac_share: float, iupac_per_read: tuple[int, int],
               rng: np.random.Generator, chunk: int = 2000
               ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``n`` reads cut from ``ref`` with point substitutions.

    Lengths are :func:`spread_lengths` over ``lengths`` in a seeded order;
    about a ``divergence`` share of the bases is redrawn from ACGT; a
    ``iupac_share`` of the reads (the same count for every seed) get between
    ``iupac_per_read`` 'N's at distinct positions. Returns (buf, off, iupac):
    the reads back to back as uint8, their offsets (n + 1), and the indices of
    the reads with an 'N'. Works ``chunk`` reads at a time.
    """
    ref_arr = np.frombuffer(ref, dtype=np.uint8)
    letters = np.frombuffer(LETTERS, np.uint8)
    lens = rng.permutation(spread_lengths(n, *lengths))
    off = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    starts = rng.integers(0, ref_arr.size - lens + 1)
    buf = np.empty(int(off[-1]), np.uint8)
    for c0 in range(0, n, chunk):
        c1 = min(n, c0 + chunk)
        lo, hi = int(off[c0]), int(off[c1])
        pos = np.arange(lo, hi, dtype=np.int64) - np.repeat(off[c0:c1] - starts[c0:c1],
                                                           lens[c0:c1])
        part = ref_arr[pos]
        mut = rng.integers(0, hi - lo, rng.binomial(hi - lo, divergence))
        part[mut] = letters[rng.integers(0, SIGMA, mut.size)]
        buf[lo:hi] = part
    n_iupac = int(round(n * iupac_share))
    iupac = (np.sort(rng.choice(n, size=n_iupac, replace=False)) if n_iupac
             else np.empty(0, np.int64))
    for r in iupac:
        count = int(rng.integers(iupac_per_read[0], iupac_per_read[1] + 1))
        at = rng.choice(int(lens[r]), size=min(count, int(lens[r])), replace=False)
        buf[off[r] + at] = ord("N")
    return buf, off, iupac


def fasta_bytes(buf: np.ndarray, off: np.ndarray) -> bytes:
    """The reads as FASTA records named ``r<index>``, one line of sequence
    each."""
    raw = buf.tobytes()
    return b"".join(b">r%d\n%s\n" % (i, raw[off[i]:off[i + 1]]) for i in range(off.size - 1))
