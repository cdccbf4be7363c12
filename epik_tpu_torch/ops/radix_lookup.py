"""Top-bits radix index: exact key -> row lookup by element gathers.

Ports ``epik_tpu/ops/radix_lookup.py``. The amino alphabet (sigma = 20) has
no direct-address table (20**k does not fit), and DNA past k = 13 neither
(4**k int32). The index keeps every device access an element gather from a
small int32 table:

* keys are stored sorted (the database contract, ``io/db.py``), so a key's
  row IS its position in the sorted array;
* the top ``key_bits - shift`` bits of a key form an exact radix bucket:
  ``off`` delimits each bucket's slice of the sorted keys;
* within a bucket every key shares its top bits, so one int32 compare of the
  low ``shift`` bits identifies the key: no hashing, exact by construction.

:class:`RadixIndex`, :func:`LP` and :func:`build_radix` are numpy copies of
the originals (the same arrays from the same keys), except that
:meth:`RadixIndex.device_arrays` returns torch tensors. The lookups take the
window key as one int64 tensor (``sigma**k < 2**48``), where the JAX
functions take two uint32 limbs ``key = a * 2**16 + b``; the bucket and the
low bits are the same. Three forms, chosen by the build:

* the low-pair-overlap form (:func:`radix_lookup_lp`): two gathers, a bucket
  word and an overlapping triple of low bits;
* the packed form (:func:`radix_lookup_packed`): three gathers, start and
  count in one word and two words of paired lows;
* the generic probe loop (:func:`radix_lookup`): two offsets and one low per
  probe, ``max_bucket`` probes.

Every packed word is a non-negative int32, so ``>>`` is a logical shift.
A miss returns ``n_keys``, the plane's all-zero row.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["DeviceRadix", "RadixIndex", "LP", "build_radix", "radix_lookup",
           "radix_lookup_packed", "radix_lookup_lp", "radix_lookup_dispatch"]


#: ``off_bits`` < 0 selects :func:`radix_lookup_lp` in the shared dispatch
#: (the two device arrays are then v1/lp, not offc/low2); the magnitude is
#: the start-field width ``nb``.
def LP(nb: int) -> int:
    return -nb


@dataclasses.dataclass
class RadixIndex:
    off: np.ndarray  # int32 (2**table_bits + 1,) bucket offsets into keys
    low: np.ndarray  # int32 (n,) low `shift` bits of each sorted key
    shift: int  # low-bits width (<= 31)
    max_bucket: int  # probe count the device loop must unroll
    #: packed tables (present when shift <= 15, max_bucket <= 3 and n fits
    #: the offset field): offc[b] = start | (count << off_bits), one gather
    #: for the off[b]/off[b+1] pair; low2[w] = low[2w] | (low[2w+1] << shift),
    #: so any <= 3 consecutive probe positions live in 2 words
    offc: np.ndarray | None = None
    low2: np.ndarray | None = None
    off_bits: int = 0
    #: low-pair-overlap tables: two gathers in all. v1[bucket] (<= 2**24
    #: buckets) = start | count << nb | hi(low[start+2]) << (nb+2); lp[i]
    #: (n+3 entries) packs low[i], low[i+1] and the low 31-2s bits of
    #: low[i+2], overlapping triples, so lp[start] covers every candidate of a
    #: <= 3-key bucket. Gate: shift s <= 11, max bucket <= 3,
    #: nb + 2 + max(0, 3s-31) <= 31.
    v1: np.ndarray | None = None
    lp: np.ndarray | None = None
    lp_shift: int = 0
    lp_nb: int = 0

    @property
    def packed(self) -> bool:
        return self.offc is not None

    @property
    def lowpair(self) -> bool:
        return self.v1 is not None

    def device_arrays(self, device) -> tuple[torch.Tensor, torch.Tensor]:
        """The two int32 tables of the chosen form, on ``device``."""
        if self.lowpair:
            pair = (self.v1, self.lp)
        elif self.packed:
            pair = (self.offc, self.low2)
        else:
            pair = (self.off, self.low)
        return tuple(torch.from_numpy(np.require(a, np.int32, ["C", "W"])).to(device)
                     for a in pair)

    def dispatch_args(self):
        """(shift, n_probe, off_bits) statics for :func:`radix_lookup_dispatch`,
        matching whatever representation :meth:`device_arrays` returned."""
        if self.lowpair:
            return self.lp_shift, self.max_bucket, LP(self.lp_nb)
        if self.packed:
            return self.shift, self.max_bucket, self.off_bits
        return self.shift, self.max_bucket, 0


def build_radix(keys: np.ndarray, key_bits: int, max_table_bits: int = 24,
                allow_split: bool = True) -> RadixIndex:
    """Build the index from SORTED unique uint64 keys (< 2**key_bits).

    ``table_bits`` targets ~32 buckets per key (load 1/32), capped at
    ``max_table_bits`` (64 MB of offsets), so that ``max_bucket``, the probe
    count, stays small. ``shift`` = key_bits - table_bits must stay <= 31 so
    the low bits fit an int32 compare.
    """
    n = int(keys.shape[0])
    table_bits = min(max_table_bits, max(1, (32 * max(n, 1) - 1).bit_length()))
    shift = max(0, key_bits - table_bits)
    if shift > 31:
        raise ValueError(f"key_bits={key_bits} too wide: low bits {shift} > 31")
    table_bits = key_bits - shift
    buckets = (keys >> np.uint64(shift)).astype(np.int64)
    counts = np.bincount(buckets, minlength=(1 << table_bits))
    off = np.zeros((1 << table_bits) + 1, np.int32)
    np.cumsum(counts, out=off[1:])
    low = (keys & np.uint64((1 << shift) - 1)).astype(np.int32)
    max_bucket = int(counts.max()) if n else 0
    idx = RadixIndex(off=off, low=low, shift=shift, max_bucket=max_bucket)
    # low-pair-overlap variant (see RadixIndex.v1): the bucket table scales
    # with the key count (~32 buckets/key like the generic form) down to the
    # key_bits - 11 floor the lp word packing needs
    s_tb = max(key_bits - 11,
               min(24, key_bits, (32 * max(n, 1) - 1).bit_length()))
    s = key_bits - s_tb
    nb = max(1, int(n).bit_length())
    b3 = max(0, 3 * s - 31)  # third-low bits that spill into v1
    if (allow_split and n and s_tb <= 24 and 0 <= s <= 11
            and nb + 2 + b3 <= 31):
        s_buckets = (keys >> np.uint64(s)).astype(np.int64)
        s_counts = np.bincount(s_buckets, minlength=(1 << s_tb))
        if int(s_counts.max()) <= 3:
            s_off = np.zeros(1 << s_tb, np.int64)
            np.cumsum(s_counts[:-1], out=s_off[1:])
            s_low = (keys & np.uint64((1 << s) - 1)).astype(np.int64)
            lo_pad = np.zeros(n + 3, np.int64)
            lo_pad[:n] = s_low
            lp_lo3 = 31 - 2 * s if s else 0  # low3 bits kept in lp
            lp_w = lo_pad[:-2].copy()
            if s:
                lp_w |= lo_pad[1:-1] << s
                lp_w |= (lo_pad[2:] & ((1 << lp_lo3) - 1)) << (2 * s)
            v1 = s_off | (s_counts.astype(np.int64) << nb)
            if b3:
                # top bits of low[start+2], valid only for 3-key buckets
                hi3 = (lo_pad[2:][s_off] >> lp_lo3) & ((1 << b3) - 1)
                v1 |= hi3 << (nb + 2)
            idx.lp_shift = s
            idx.lp_nb = nb
            idx.v1 = v1.astype(np.int32)
            idx.lp = lp_w.astype(np.int32)
            return idx
    # packed variant (see RadixIndex.offc): 3 gather passes instead of 5
    cb = max(max_bucket, 1).bit_length()
    off_bits = 31 - cb
    if n and max_bucket <= 3 and 0 < shift <= 15 and n < (1 << off_bits):
        idx.off_bits = off_bits
        idx.offc = (off[:-1] | (counts.astype(np.int64) << off_bits)).astype(
            np.int32
        )
        nw = (n + 2) // 2  # +1 pad word so w0+1 is always in bounds
        lp = np.zeros(2 * nw, np.int64)
        lp[:n] = low
        idx.low2 = (lp[0::2] | (lp[1::2] << shift)).astype(np.int32)
    return idx


def _split_bucket_lo(key: torch.Tensor, shift: int):
    """(bucket int64, lo int32) of int64 keys: the top bits index the bucket
    table, the low ``shift`` bits are compared."""
    return key >> shift, (key & ((1 << shift) - 1)).to(torch.int32)


def radix_lookup_packed(offc, low2, key, *, shift: int, off_bits: int, n_keys: int):
    """Packed lookup, three gathers: ``offc[bucket]`` gives start and count,
    two ``low2`` words cover every candidate position (max_bucket <= 3)."""
    bucket, lo = _split_bucket_lo(key, shift)
    oc = offc[bucket]
    st = oc & ((1 << off_bits) - 1)
    en = st + (oc >> off_bits)
    w0 = (st >> 1).long()
    nw = low2.shape[0]
    l01 = low2[w0]
    l23 = low2[torch.clamp(w0 + 1, max=nw - 1)]
    mask = (1 << shift) - 1
    row = torch.full_like(st, n_keys)
    base = st & ~1
    for j, cand in enumerate((l01 & mask, l01 >> shift, l23 & mask, l23 >> shift)):
        pos = base + j
        hit = (pos >= st) & (pos < en) & (cand == lo)
        row = torch.where(hit, pos, row)
    return row


def radix_lookup_lp(v1, lp, key, *, shift: int, nb: int, n_keys: int):
    """Low-pair-overlap lookup, two gathers: ``v1[bucket]`` gives start,
    count and (at shift 11) the two spill bits of the third candidate's low;
    ``lp[start]`` the up-to-three candidate lows as an overlapping triple."""
    bucket, lo = _split_bucket_lo(key, shift)
    o1 = v1[bucket]
    st = o1 & ((1 << nb) - 1)
    cnt = (o1 >> nb) & 3
    w = lp[st.long()]
    if shift:
        mask = (1 << shift) - 1
        lo3_bits = 31 - 2 * shift
        b3 = max(0, 3 * shift - 31)
        c0 = w & mask
        c1 = (w >> shift) & mask
        c2 = (w >> (2 * shift)) & ((1 << lo3_bits) - 1)
        if b3:
            c2 = c2 | (((o1 >> (nb + 2)) & ((1 << b3) - 1)) << lo3_bits)
    else:
        c0 = c1 = c2 = torch.zeros_like(w)
    row = torch.full_like(st, n_keys)
    for j, cand in enumerate((c0, c1, c2)):
        row = torch.where((cnt > j) & (cand == lo), st + j, row)
    return row


def radix_lookup(off, low, key, *, shift: int, n_probe: int, n_keys: int):
    """Generic lookup: ``off[bucket]`` and ``off[bucket + 1]`` delimit the
    bucket, then ``n_probe`` probes compare one low each; the first hit wins.
    A probe past the bucket reads a clamped position and is masked."""
    bucket, lo = _split_bucket_lo(key, shift)
    st = off[bucket]
    en = off[bucket + 1]
    row = torch.full_like(st, n_keys)
    found = torch.zeros(st.shape, dtype=torch.bool, device=st.device)
    nmax = max(low.shape[0] - 1, 0)
    for p in range(n_probe):
        jc = torch.clamp(st + p, max=nmax)
        m = (st + p < en) & (low[jc.long()] == lo) & ~found
        row = torch.where(m, jc, row)
        found = found | m
    return row


def radix_lookup_dispatch(arr1, arr2, key, *, shift: int, n_probe: int, off_bits: int,
                          n_keys: int):
    """The lookup of the index's form: ``off_bits`` < 0 the low-pair-overlap
    form (arr1/arr2 = v1/lp, nb = -off_bits), > 0 the packed form
    (offc/low2), 0 the generic probe loop (off/low). The statics come from
    :meth:`RadixIndex.dispatch_args`. Returns int32 rows, ``n_keys`` for a
    miss."""
    if off_bits < 0:
        return radix_lookup_lp(arr1, arr2, key, shift=shift, nb=-off_bits, n_keys=n_keys)
    if off_bits > 0:
        return radix_lookup_packed(arr1, arr2, key, shift=shift, off_bits=off_bits,
                                   n_keys=n_keys)
    return radix_lookup(arr1, arr2, key, shift=shift, n_probe=n_probe, n_keys=n_keys)


@dataclasses.dataclass
class DeviceRadix:
    """An index's two tables on the device with its dispatch statics."""

    arr1: torch.Tensor
    arr2: torch.Tensor
    shift: int
    n_probe: int
    off_bits: int

    @classmethod
    def from_index(cls, idx: RadixIndex, device) -> "DeviceRadix":
        return cls(*idx.device_arrays(device), *idx.dispatch_args())

    @property
    def form(self) -> str:
        """``"lowpair"``, ``"packed"`` or ``"generic"``."""
        return "lowpair" if self.off_bits < 0 else "packed" if self.off_bits > 0 else "generic"

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (self.arr1, self.arr2))

    def lookup(self, key: torch.Tensor, n_keys: int) -> torch.Tensor:
        """int32 rows of int64 ``key``; ``n_keys`` for a miss."""
        return radix_lookup_dispatch(self.arr1, self.arr2, key, shift=self.shift,
                                     n_probe=self.n_probe, off_bits=self.off_bits,
                                     n_keys=n_keys)
