"""The plain reference that decides ``correct``: placement in NumPy.

A frozen copy of the scalar algorithm of the port's ``engine/reference.py``
(the upstream ``place.cpp`` with its quirks): its tokenizer with the
one-ambiguity policy, its newick parser and tree index, float32 scores added
in posting order, the correction, the LWR over all branches and the top-K
with the keep factor. The exact windows' adds run as one ``np.add.at`` a
read, which adds in index order as the scalar loop does.

It works everything out from what the harness hands it: the database arrays,
the newick and the reads. It imports neither the port nor JAX.
"""

from __future__ import annotations

import numpy as np

SIGMA = 4
_U64 = 1 << 64
#: code of each byte: 0-3 for ACGT (U as T), 0x80 + j for the j-th IUPAC
#: symbol, 0xFF for a byte that invalidates its windows
_INVALID, _AMBIG = 0xFF, 0x80
_AMBIGS = {"R": "AG", "Y": "CT", "S": "CG", "W": "AT", "K": "GT", "M": "AC",
           "B": "CGT", "D": "AGT", "H": "ACT", "V": "ACG", "N": "ACGT"}
CODE = np.full(256, _INVALID, np.uint8)
for _i, _ch in enumerate("ACGT"):
    CODE[ord(_ch)] = CODE[ord(_ch.lower())] = _i
CODE[ord("U")] = CODE[ord("u")] = 3
EXPANSIONS = []
for _j, (_ch, _to) in enumerate(sorted(_AMBIGS.items())):
    CODE[ord(_ch)] = CODE[ord(_ch.lower())] = _AMBIG + _j
    EXPANSIONS.append(np.array(["ACGT".index(t) for t in _to], np.uint64))


def tokenize(seq: bytes, k: int) -> tuple[int, np.ndarray, list[np.ndarray]]:
    """(windows, exact keys in window order, one key array per one-ambiguity
    window in window order). Windows with two ambiguous symbols or an invalid
    byte give no key."""
    codes = CODE[np.frombuffer(seq, np.uint8)]
    L = codes.size
    if L < k:
        return 0, np.empty(0, np.uint64), []
    m = L - k + 1
    inv = codes == _INVALID
    amb = (codes >= _AMBIG) & ~inv

    def per_window(flags):
        c = np.concatenate([[0], np.cumsum(flags, dtype=np.int64)])
        return c[k:] - c[:-k]

    n_inv, n_amb = per_window(inv), per_window(amb)
    digits = np.where(codes < SIGMA, codes, 0).astype(np.uint64)
    keys = np.zeros(m, np.uint64)
    for j in range(k):
        keys = keys * np.uint64(SIGMA) + digits[j:j + m]
    exact = keys[(n_inv == 0) & (n_amb == 0)]
    ambs = []
    one = np.flatnonzero((n_inv == 0) & (n_amb == 1))
    if one.size:
        amb_pos = np.flatnonzero(amb)
        for w in one:
            p = amb_pos[np.searchsorted(amb_pos, w)]
            mult = np.uint64(SIGMA ** (k - 1 - (p - w)))
            ambs.append(keys[w] + EXPANSIONS[int(codes[p]) - _AMBIG] * mult)
    return m, exact, ambs


class Tree:
    """Post-order nodes of a newick tree: branch lengths and the pendant /
    distal lengths the jplace rows carry."""

    def __init__(self, newick: str):
        lengths, children = _parse_newick(newick)
        n = len(lengths)
        self.n = n
        self.branch_lengths = np.array([x or 0.0 for x in lengths], np.float64)
        num = np.ones(n, np.int64)
        tot = np.zeros(n, np.float64)
        for i in range(n):  # post-order: the children come first
            for c in children[i]:
                num[i] += num[c]
                tot[i] += tot[c] + self.branch_lengths[c]
        self.distal = self.branch_lengths / 2.0
        mean = np.where(num > 1, tot / np.maximum(num, 1), 0.0)
        self.pendant = mean + self.distal


def _parse_newick(text: str) -> tuple[list, list]:
    """(branch length or None, children) of each node in post-order."""
    s = text.strip().rstrip(";")
    lengths: list = []
    children: list = []
    stack: list[list[int]] = []
    p, n = 0, len(s)

    def suffix(p, kids):
        q = p
        while q < n and s[q] not in ",();":
            q += 1
        label = s[p:q]
        length = float(label.split(":", 1)[1]) if ":" in label else None
        lengths.append(length)
        children.append(kids)
        return len(lengths) - 1, q

    while True:
        if s[p] == "(":
            stack.append([])
            p += 1
            continue
        node, p = suffix(p, [])
        while True:
            if not stack:
                return lengths, children
            stack[-1].append(node)
            if s[p] == ",":
                p += 1
                break
            if s[p] == ")":
                node, p = suffix(p + 1, stack.pop())
                continue
            raise ValueError(f"newick parse error at {p}")


class ReferencePlacer:
    """The scalar placement of each read, all branches' scores kept."""

    def __init__(self, db: dict, keep_at_most: int = 7, keep_factor: float = 0.01):
        self.keys = db["keys"]
        self.row_off = db["row_off"]
        self.branches = db["branches"].astype(np.int64)
        self.scores = db["scores"]
        self.k = int(db["kmer_size"])
        self.tree = Tree(db["newick"])
        self.B = self.tree.n
        thr = np.float32((float(db["omega"]) / SIGMA) ** self.k)
        self.threshold = thr
        self.log_threshold = np.float32(np.log10(thr))
        self.keep_at_most = keep_at_most
        self.keep_factor = keep_factor

    def _postings(self, keys: np.ndarray) -> np.ndarray:
        """Indices of the postings of ``keys`` (misses skipped), key by key."""
        i = np.searchsorted(self.keys, keys)
        i = np.minimum(i, self.keys.size - 1)
        i = i[self.keys[i] == keys]
        lo, hi = self.row_off[i], self.row_off[i + 1]
        lens = hi - lo
        if not lens.size:
            return np.empty(0, np.int64)
        starts = np.repeat(lo - np.concatenate([[0], np.cumsum(lens)[:-1]]), lens)
        return starts + np.arange(int(lens.sum()), dtype=np.int64)

    def scores_of(self, seq: bytes) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(S, C, edges): the corrected float32 score and the count of every
        branch, and the touched branches (C > 0) in the order of their first
        hit, the order the scalar loop lists its placements in."""
        k, B = self.k, self.B
        _, exact, ambs = tokenize(seq, k)
        S = np.zeros(B, np.float32)
        C = np.zeros(B, np.int64)
        post = self._postings(exact)
        hit = self.branches[post]
        np.add.at(S, hit, self.scores[post])
        np.add.at(C, hit, 1)
        _, first_at = np.unique(hit, return_index=True)
        edges = list(hit[np.sort(first_at)])
        if ambs:
            S_amb = np.zeros(B, np.float32)
            C_amb = np.zeros(B, np.int64)
            for keys in ambs:  # each expanded key is its own group (Q6/Q7)
                for key in keys:
                    post = self._postings(np.array([key], np.uint64))
                    first = []
                    for b, sc in zip(self.branches[post], self.scores[post]):
                        if C_amb[b] == 0:
                            first.append(b)
                        C_amb[b] += 1
                        S_amb[b] += np.float32(10.0 ** float(sc))
                    for b in first:
                        if C[b] == 0:
                            edges.append(b)
                        avg = np.float32((S_amb[b] + np.float32(k - C_amb[b]) * self.threshold)
                                         / np.float32(k))
                        C[b] += 1
                        S[b] += avg
        touched = C > 0
        # (m - C) as a size_t (Q1): float32(2**64 - small) == float32(2**64)
        diff = (len(seq) - k + 1) - C[touched]
        wrapped = np.where(diff >= 0, diff.astype(np.float32),
                           np.float32(float(_U64)) + diff.astype(np.float32))
        S[touched] += wrapped.astype(np.float32) * self.log_threshold
        S[touched] = S[touched] / np.float32(k)
        return S, C, np.array(edges, np.int64)

    def place(self, seq: bytes) -> dict:
        """The jplace rows of ``seq`` as the scalar reference writes them,
        and every touched branch's likelihood.

        Returns ``{"rows": [(edge, likelihood, lwr, distal, pendant)],
        "S": every branch's likelihood (float32), "touched": C > 0,
        "untouched": the likelihood a branch with no hit has, "zero_sum":
        whether every ratio is 0 (Q3)}``.
        """
        k = self.k
        S, C, edges = self.scores_of(seq)
        m_wrapped = (len(seq) - k + 1) % _U64
        untouched = float(self.log_threshold * np.float32(m_wrapped) / np.float32(k))
        # the LWR's sum runs over all branches (Q4)
        exponent = np.float32(np.float32(m_wrapped) * self.log_threshold / np.float32(k))
        score_sum = float(np.float32(self.B) - np.float32(edges.size)) * (10.0 ** float(exponent))
        placed = 0.0
        for score in S[edges].tolist():  # in the scalar loop's order and libm's pow
            placed += 10.0 ** score
        score_sum += placed
        if edges.size:  # the top-K by score, ties to the lowest branch
            order = np.lexsort((edges, -S[edges].astype(np.float64)))
            best = [(int(edges[i]), float(S[edges[i]])) for i in order[:self.keep_at_most]]
        else:  # no hit: the first K branches at the threshold score (Q2)
            best = [(i, untouched) for i in range(self.keep_at_most)]
        keep_factor = self.keep_factor
        rows = []
        for e, s in best:
            if score_sum == 0:  # every ratio 0, the filter off (Q3)
                wr, keep_factor = 0.0, 0.0
            else:
                power = 10.0 ** s
                wr = 0.0 if power == 0.0 else power / score_sum
            if edges.size:
                rows.append((e, s, wr, float(self.tree.distal[e]), float(self.tree.pendant[e])))
            else:  # the fallback rows carry no lengths
                rows.append((e, s, wr, 0.0, 0.0))
        cut = rows[0][2] * keep_factor if rows else 0.0
        rows = [r for r in rows if r[2] >= cut]
        return {"rows": rows, "S": S, "touched": C > 0, "untouched": untouched,
                "zero_sum": score_sum == 0}
