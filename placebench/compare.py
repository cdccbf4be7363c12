"""What decides ``correct``: the jplace the window wrote, read back and held
to the reference.

The parser reads the header and the byte range of each sampled batch's write;
each placement object gives a read's rows ``[edge_num, likelihood,
like_weight_ratio, distal_length, pendant_length]``. The numbers compared:

* ``lost_reads``: reads handed to the pipeline and not written (exact, 0);
* ``missing``: sampled reads without exactly one placement object in their
  batch's range, plus objects there that name no read of that batch (exact);
* ``ll_gap``: the widest gap, in log10 units, by which a written row lies off
  the reference: ``|ll - ll_ref(edge)|`` over the written rows, and for an
  edge written where the reference keeps another (or the other way round),
  how far it lies past the reference's cut (at a near tie, a rounding);
* ``lwr_gap``: the widest ``|lwr - lwr_ref|`` over the edges both keep;
* ``length_gap``: the widest ``|distal - ref| + |pendant - ref|`` over the
  written rows (the lengths follow from the edge id and the tree, exact).
"""

from __future__ import annotations

import json
import math

import numpy as np

from .reference import ReferencePlacer

def read_header(path: str) -> dict:
    """The jplace header's ``fields`` and ``tree`` (the text before the
    placements array)."""
    with open(path, "rb") as f:
        head = f.read(1 << 16)
        while b'"placements": [' not in head:
            more = f.read(1 << 20)
            if not more:
                raise ValueError(f"{path}: no placements array")
            head += more
    text = head[:head.index(b'"placements": [')].decode()
    text = text.rstrip().rstrip(",") + "}"
    return json.loads(text)


def read_range(path: str, start: int, end: int, fields: list[str]) -> dict:
    """name -> rows of the placement objects in bytes [start, end) of the
    file: the text one write appended."""
    with open(path, "rb") as f:
        f.seek(start)
        text = f.read(end - start).decode().strip()
    if text.startswith(","):
        text = text[1:]
    objs = json.loads("[" + text + "]") if text else []
    cols = [fields.index(c) for c in ("edge_num", "likelihood", "like_weight_ratio",
                                      "distal_length", "pendant_length")]
    out: dict = {}
    for obj in objs:
        rows = [tuple(row[c] for c in cols) for row in obj["p"]]
        names = obj["n"] if "n" in obj else [nm[0] for nm in obj["nm"]]
        for name in names:
            out.setdefault(name, []).append(rows)
    return out


def file_is_closed(path: str) -> bool:
    """Whether the file ends with the placements array and the object
    closed, as the writer's ``end`` leaves it."""
    with open(path, "rb") as f:
        f.seek(0, 2)
        f.seek(max(0, f.tell() - 64))
        return f.read().endswith(b"\n    ]\n}")


def read_gaps(rows: list, ref: dict, keep_factor: float) -> dict:
    """The gaps of one read's written ``rows`` against the reference's
    placement ``ref`` (:meth:`ReferencePlacer.place`)."""
    S, touched = ref["S"], ref["touched"]
    any_touched = bool(touched.any())

    def ll_ref(e: int) -> float:
        return float(S[e]) if touched[e] else ref["untouched"]

    kept = {r[0]: r for r in ref["rows"]}
    written = {int(r[0]): r for r in rows}
    ll_gap = max((abs(float(r[1]) - ll_ref(e)) for e, r in written.items()), default=0.0)
    if set(kept) != set(written):
        # the reference keeps an edge iff its likelihood clears the top-K cut
        # and the keep line: a mismatch is at most as far past them as it is
        cut = min(r[1] for r in ref["rows"])
        lls = np.where(touched, S, np.float32(ref["untouched"])).astype(np.float64)
        lls[list(kept)] = -np.inf
        next_best = float(lls.max()) if (any_touched and lls.size) else -math.inf
        best = max(r[1] for r in ref["rows"])
        line = (-math.inf if ref["zero_sum"] or keep_factor <= 0
                else best + math.log10(keep_factor))
        for e in set(kept) ^ set(written):
            margin = (ll_ref(e) - max(next_best, line) if e in kept else cut - ll_ref(e))
            ll_gap = max(ll_gap, margin)
    lwr_gap = max((abs(float(written[e][2]) - kept[e][2]) for e in set(kept) & set(written)),
                  default=0.0)
    length_gap = 0.0
    for e, r in written.items():
        d, p = (ref["distal"][e], ref["pendant"][e]) if any_touched else (0.0, 0.0)
        length_gap = max(length_gap, abs(float(r[3]) - d) + abs(float(r[4]) - p))
    return {"ll_gap": ll_gap, "lwr_gap": lwr_gap, "length_gap": length_gap}


def check_sample(path: str, batches: dict, sample: dict, reads: dict,
                 placer: ReferencePlacer, keep_factor: float) -> dict:
    """The numbers over the sampled reads.

    ``batches[j]`` is the sampled batch j's ``(start, end, names)``: its bytes
    in the file and the read names it held; ``sample`` maps batch j to the
    names sampled in it; ``reads`` maps a name to its sequence.
    """
    fields = read_header(path)["fields"]
    out = {"missing": 0, "ll_gap": 0.0, "lwr_gap": 0.0, "length_gap": 0.0, "reads_checked": 0}
    for j, names in sorted(sample.items()):
        start, end, batch_names = batches[j]
        records = read_range(path, start, end, fields)
        expected = set(batch_names)
        out["missing"] += sum(1 for name in records if name not in expected)
        for name in names:
            found = records.get(name, [])
            if len(found) != 1:
                out["missing"] += 1
                continue
            ref = placer.place(reads[name])
            ref["distal"], ref["pendant"] = placer.tree.distal, placer.tree.pendant
            gaps = read_gaps(found[0], ref, keep_factor)
            for key, value in gaps.items():
                out[key] = max(out[key], value)
            out["reads_checked"] += 1
    return out
