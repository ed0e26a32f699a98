"""
ctypes bindings for the native BAM decoder (native/bam.cc, baq.cc) —
counterpart of instrain_tpu/io/bam.py, over this package's own build of
the decoder (build.native_io_library; the tracked
instrain_tpu/io/libinstrain_io.so is never loaded).

Decodes a whole sorted BAM into flat numpy arrays:
  - a per-record table with the fields read filtering needs (NM, mapq,
    inferred length, ref start/end; reference:
    inStrain/filter_reads.py:885-955)
  - a per-aligned-base event stream (ref position, base code, quality)
    that the pileup scatters into counts (replacing pysam.pileup,
    profile_utilities.py:150-153)

Quality post-processing (BAQ + mate-overlap tweak) mirrors the reference's
pileup parameters compute_baq=True, ignore_overlaps=True; pass
`baq=False` / `tweak_overlaps=False` to disable.
"""

from __future__ import annotations

import ctypes as ct
import logging
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from .bai import find_bai

_lib = None
_lib_lock = threading.Lock()


def _load_lib():
    global _lib
    with _lib_lock:
        if _lib is None:
            from ..build import native_io_library
            _lib = load_native(native_io_library())
    return _lib


def load_native(path: str):
    """Load and bind a build of the decoder library."""
    return _bind(ct.CDLL(path))


def _bind(lib):
    lib.bd_open.restype = ct.c_void_p
    lib.bd_open.argtypes = [ct.c_char_p, ct.c_int]
    lib.bd_open_sam.restype = ct.c_void_p
    lib.bd_open_sam.argtypes = [ct.c_char_p]
    lib.bd_open_ranged.restype = ct.c_void_p
    lib.bd_open_ranged.argtypes = [ct.c_char_p, ct.c_int, ct.c_char_p]
    lib.bd_error.restype = ct.c_char_p
    lib.bd_free.argtypes = [ct.c_void_p]
    lib.bd_ref_name.restype = ct.c_char_p
    lib.bd_ref_name.argtypes = [ct.c_void_p, ct.c_int64]
    lib.bd_qname_blob.restype = ct.c_void_p
    lib.bd_qname_blob.argtypes = [ct.c_void_p]
    for name in ["bd_n_refs", "bd_n_records", "bd_n_events",
                 "bd_n_qnames", "bd_qname_blob_len"]:
        getattr(lib, name).restype = ct.c_int64
        getattr(lib, name).argtypes = [ct.c_void_p]
    lib.bd_ref_len.restype = ct.c_int64
    lib.bd_ref_len.argtypes = [ct.c_void_p, ct.c_int64]
    for name, typ in _PTR_FUNCS.items():
        fn = getattr(lib, name)
        fn.restype = ct.POINTER(typ)
        fn.argtypes = [ct.c_void_p]
    lib.bd_apply_baq.argtypes = [ct.c_void_p, ct.c_int32,
                                 ct.POINTER(ct.c_uint8), ct.c_int64]
    lib.bd_tweak_overlaps_ex.argtypes = [ct.c_void_p, ct.c_int, ct.c_int]
    lib.bd_build_counts.restype = ct.c_int64
    lib.bd_build_counts.argtypes = [
        ct.c_void_p, ct.c_int32, ct.POINTER(ct.c_int32), ct.c_int32,
        ct.c_int64, ct.POINTER(ct.c_int32), ct.c_uint8]
    lib.bd_build_counts16.restype = ct.c_int32
    lib.bd_build_counts16.argtypes = [
        ct.c_void_p, ct.c_int32, ct.POINTER(ct.c_int32), ct.c_int32,
        ct.c_int64, ct.c_int64, ct.POINTER(ct.c_int16),
        ct.POINTER(ct.c_int64), ct.POINTER(ct.c_int32), ct.c_uint8]
    lib.bd_pack_counts_sparse_d16.restype = ct.c_int64
    lib.bd_pack_counts_sparse_d16.argtypes = [
        ct.POINTER(ct.c_int16), ct.c_int64, ct.POINTER(ct.c_uint16),
        ct.POINTER(ct.c_uint8), ct.c_int64, ct.POINTER(ct.c_int32),
        ct.POINTER(ct.c_int32), ct.c_int64, ct.POINTER(ct.c_int64)]
    lib.bd_total_cum16.restype = None
    lib.bd_total_cum16.argtypes = [ct.POINTER(ct.c_int16), ct.c_int32,
                                   ct.c_int64, ct.POINTER(ct.c_int32)]
    lib.bd_clon_cum16.restype = None
    lib.bd_clon_cum16.argtypes = [ct.POINTER(ct.c_int16), ct.c_int32,
                                  ct.c_int64, ct.c_int32,
                                  ct.POINTER(ct.c_int32),
                                  ct.POINTER(ct.c_float)]
    lib.bd_select_events.restype = ct.c_int64
    lib.bd_select_events.argtypes = [
        ct.c_void_p, ct.c_int32, ct.POINTER(ct.c_int32),
        ct.POINTER(ct.c_uint8), ct.c_int64, ct.c_uint8,
        ct.POINTER(ct.c_int32), ct.POINTER(ct.c_uint8),
        ct.POINTER(ct.c_int32), ct.POINTER(ct.c_int64), ct.c_int64]
    lib.gr_range_sums.restype = ct.c_int
    lib.gr_range_sums.argtypes = [
        ct.c_void_p, ct.c_int, ct.c_int64, ct.c_int64,
        ct.POINTER(ct.c_float), ct.c_int64, ct.c_int64, ct.c_int32,
        ct.c_int64, ct.POINTER(ct.c_int64), ct.c_int64,
        ct.POINTER(ct.c_int64), ct.POINTER(ct.c_int64),
        ct.POINTER(ct.c_int64), ct.POINTER(ct.c_double)]
    lib.bd_baq_one.restype = ct.c_int
    lib.bd_baq_one.argtypes = [
        ct.POINTER(ct.c_uint8), ct.c_int64, ct.c_int64,
        ct.POINTER(ct.c_uint32), ct.c_int, ct.POINTER(ct.c_uint8),
        ct.POINTER(ct.c_uint8), ct.c_int, ct.POINTER(ct.c_uint8)]
    return lib


# record-table / event-stream accessors: name -> element type
_PTR_FUNCS = {
    "bd_rec_ref_id": ct.c_int32, "bd_rec_pos": ct.c_int32,
    "bd_rec_flag": ct.c_uint16, "bd_rec_mapq": ct.c_uint8,
    "bd_rec_nm": ct.c_int32, "bd_rec_qname_id": ct.c_int64,
    "bd_rec_qlen_infer": ct.c_int32, "bd_rec_ref_start": ct.c_int32,
    "bd_rec_ref_end": ct.c_int32, "bd_rec_tlen": ct.c_int32,
    "bd_rec_mate_pos": ct.c_int32, "bd_rec_mate_ref": ct.c_int32,
    "bd_rec_ev_off": ct.c_int64,
    "bd_rec_ev_len": ct.c_int32, "bd_rec_pileup_ok": ct.c_uint8,
    "bd_ev_pos": ct.c_int32, "bd_ev_base": ct.c_uint8,
    "bd_ev_qual": ct.c_uint8,
}


def _is_sam(path: str) -> bool:
    if path.endswith(".sam"):
        return True
    with open(path, "rb") as f:
        head = f.read(4)
    return not (head[:2] == b"\x1f\x8b" or head == b"BAM\x01")


class _NativeHandle:
    """Owns a native BamData* — freed, by the library that made it, when
    the last reference (BamArrays or any zero-copy array view) dies."""

    __slots__ = ("h", "lib")

    def __init__(self, h, lib):
        self.h = h
        self.lib = lib

    def __del__(self):
        if self.h:
            self.lib.bd_free(self.h)
            self.h = None


class _OwnedArray(np.ndarray):
    """ndarray view into native decoder memory holding a reference to the
    owning handle, so the buffer outlives any view/slice of it."""

    _owner = None

    def __array_finalize__(self, obj):
        # propagate ownership only to true views (base chains to the
        # native buffer); ufunc results / copies have fresh buffers
        if obj is not None and self.base is not None:
            self._owner = getattr(obj, "_owner", None)


def _arr(ptr, n, dtype, owner=None):
    """Zero-copy read-only view of a native buffer, keeping `owner`
    (the native handle) alive."""
    if n == 0:
        return np.empty(0, dtype=dtype)
    a = np.ctypeslib.as_array(ptr, shape=(n,))
    if a.dtype != dtype:
        raise TypeError(f"native buffer is {a.dtype}, expected {dtype}")
    v = a.view(_OwnedArray)
    v._owner = owner
    v.flags.writeable = False
    return v


@dataclass
class BamArrays:
    """Decoded BAM as flat numpy arrays — zero-copy read-only views into
    the native decoder's buffers."""

    ref_names: List[str]
    ref_lens: np.ndarray          # int64 [n_refs]
    # record table
    ref_id: np.ndarray            # int32
    pos: np.ndarray               # int32
    flag: np.ndarray              # uint16
    mapq: np.ndarray              # uint8
    nm: np.ndarray                # int32
    qname_id: np.ndarray          # int64
    qlen_infer: np.ndarray        # int32
    ref_start: np.ndarray         # int32
    ref_end: np.ndarray           # int32
    tlen: np.ndarray              # int32 template length (BAM TLEN)
    mate_pos: np.ndarray          # int32 mate 0-based pos (-1 if unknown)
    mate_ref: np.ndarray          # int32 mate ref id (-1 if unknown)
    ev_off: np.ndarray            # int64
    ev_len: np.ndarray            # int32
    pileup_ok: np.ndarray         # uint8 (bool)
    # events
    ev_pos: np.ndarray            # int32
    ev_base: np.ndarray           # uint8
    ev_qual: np.ndarray           # uint8
    # qnames (lazy: most paths only need ids)
    _qnames: Optional[List[str]] = None
    n_qnames: int = 0
    ranged: bool = False          # decoded only the asked scaffolds' ranges
    _handle_obj: Optional[_NativeHandle] = None

    @property
    def _handle(self):
        ho = self._handle_obj
        return ho.h if ho is not None else None

    @property
    def qnames(self) -> Optional[List[str]]:
        if self._qnames is None and self._handle:
            lib = self._handle_obj.lib
            nq = lib.bd_n_qnames(self._handle)
            blob = ct.string_at(lib.bd_qname_blob(self._handle),
                                lib.bd_qname_blob_len(self._handle))
            self._qnames = [s.decode() for s in blob.split(b"\0")[:nq]]
        return self._qnames

    def _require_handle(self):
        if not self._handle:
            raise RuntimeError("native BAM handle is closed")
        return self._handle

    def build_counts(self, rid: int, qid2mmidx: np.ndarray, n_mm: int,
                     L: int, min_qual: int = 30):
        """Native event->counts scatter: counts[n_mm, 4, L] int32."""
        h = self._require_handle()
        lib = self._handle_obj.lib
        q = np.ascontiguousarray(qid2mmidx, dtype=np.int32)
        out = np.zeros(n_mm * 4 * L, dtype=np.int32)
        lib.bd_build_counts(h, rid,
                            q.ctypes.data_as(ct.POINTER(ct.c_int32)),
                            n_mm, L,
                            out.ctypes.data_as(ct.POINTER(ct.c_int32)),
                            min_qual)
        return out.reshape(n_mm, 4, L)

    def build_counts_padded(self, rid: int, qid2mmidx: np.ndarray,
                            n_mm: int, L: int, Lp: int, Mp: int,
                            min_qual: int = 30):
        """Native event->counts scatter straight into a padded int16
        tensor [Mp, 4, Lp], the mm levels with no counted base dropped in
        the same pass (bd_build_counts16). Returns (counts16,
        level_events[n_mm] int64, level_map[n_mm] int32: each level's kept
        index or -1), or None when a cell would overflow int16 (an
        exact-mm count over 32,767): the caller builds int32 counts
        instead."""
        if not (Mp >= n_mm and Lp >= L):
            raise ValueError(f"padded shape ({Mp}, {Lp}) below ({n_mm}, "
                             f"{L})")
        h = self._require_handle()
        lib = self._handle_obj.lib
        q = np.ascontiguousarray(qid2mmidx, dtype=np.int32)
        out = np.zeros(Mp * 4 * Lp, dtype=np.int16)
        level_events = np.zeros(n_mm, dtype=np.int64)
        level_map = np.zeros(n_mm, dtype=np.int32)
        kept = lib.bd_build_counts16(
            h, rid, q.ctypes.data_as(ct.POINTER(ct.c_int32)), n_mm, L, Lp,
            out.ctypes.data_as(ct.POINTER(ct.c_int16)),
            level_events.ctypes.data_as(ct.POINTER(ct.c_int64)),
            level_map.ctypes.data_as(ct.POINTER(ct.c_int32)), min_qual)
        if kept < 0:
            return None
        return out.reshape(Mp, 4, Lp), level_events, level_map

    def select_events(self, rid: int, qid2mmidx: np.ndarray,
                      pos_mask: np.ndarray, min_qual: int = 30,
                      capacity: int = 1 << 20):
        """Counted events at masked positions: (pos, base, mm_idx, qname)."""
        h = self._require_handle()
        lib = self._handle_obj.lib
        q = np.ascontiguousarray(qid2mmidx, dtype=np.int32)
        mask = np.ascontiguousarray(pos_mask, dtype=np.uint8)
        L = len(mask)
        while True:
            pos = np.empty(capacity, dtype=np.int32)
            base = np.empty(capacity, dtype=np.uint8)
            mm = np.empty(capacity, dtype=np.int32)
            qn = np.empty(capacity, dtype=np.int64)
            n = lib.bd_select_events(
                h, rid,
                q.ctypes.data_as(ct.POINTER(ct.c_int32)),
                mask.ctypes.data_as(ct.POINTER(ct.c_uint8)), L, min_qual,
                pos.ctypes.data_as(ct.POINTER(ct.c_int32)),
                base.ctypes.data_as(ct.POINTER(ct.c_uint8)),
                mm.ctypes.data_as(ct.POINTER(ct.c_int32)),
                qn.ctypes.data_as(ct.POINTER(ct.c_int64)), capacity)
            if n <= capacity:
                return pos[:n], base[:n], mm[:n], qn[:n]
            capacity = int(n)

    @property
    def n_records(self) -> int:
        return len(self.ref_id)

    @property
    def name_to_ref_id(self) -> Dict[str, int]:
        return {n: i for i, n in enumerate(self.ref_names)}

    def records_of_ref(self, rid: int) -> np.ndarray:
        """Indices of the records on reference rid, in file order."""
        return np.nonzero(self.ref_id == rid)[0]


def decode_bam(path: str, ref_seqs: Optional[Dict[str, np.ndarray]] = None,
               threads: int = 6, baq: bool = False,
               tweak_overlaps: bool = True,
               tweak_orphans: bool = False,
               tweak_legacy_walk: bool = True,
               scaffolds: Optional[List[str]] = None) -> BamArrays:
    """
    Decode a BAM (or SAM) file.

    ref_seqs: {ref_name: uint8 ASCII array} — required for BAQ (uppercased
    reference sequences, e.g. from io.fasta.read_fasta).
    scaffolds: decode only these scaffolds' ranges, through the .bai
    (native bd_open_ranged), where the BAM has an index beside it; a full
    decode otherwise. The result's `ranged` says which ran.
    """
    lib = _load_lib()
    ranged = False
    h = None
    if _is_sam(path):
        h = lib.bd_open_sam(path.encode())
    else:
        if scaffolds is not None:
            if find_bai(path) is not None:
                h = lib.bd_open_ranged(path.encode(), threads,
                                       "\n".join(scaffolds).encode())
                ranged = bool(h)
                if not h:
                    logging.debug(f"ranged decode failed "
                                  f"({lib.bd_error().decode()}); full decode")
        if not h:
            h = lib.bd_open(path.encode(), threads)
    if not h:
        raise IOError(f"BAM decode failed: {lib.bd_error().decode()}")
    try:
        n_refs = lib.bd_n_refs(h)
        ref_names = [lib.bd_ref_name(h, i).decode() for i in range(n_refs)]
        ref_lens = np.array([lib.bd_ref_len(h, i) for i in range(n_refs)],
                            dtype=np.int64)

        if baq:
            if ref_seqs is None:
                raise ValueError("BAQ requires ref_seqs")
            for i, name in enumerate(ref_names):
                if name not in ref_seqs:
                    continue
                seq = np.ascontiguousarray(ref_seqs[name], dtype=np.uint8)
                lib.bd_apply_baq(h, i,
                                 seq.ctypes.data_as(ct.POINTER(ct.c_uint8)),
                                 len(seq))
        if tweak_overlaps:
            lib.bd_tweak_overlaps_ex(h, int(tweak_orphans),
                                     int(tweak_legacy_walk))

        n = lib.bd_n_records(h)
        ne = lib.bd_n_events(h)
        ho = _NativeHandle(h, lib)
        h = None  # ownership transferred to the handle object
        hp = ho.h
        fields = {}
        for name, typ in _PTR_FUNCS.items():
            count = ne if name.startswith("bd_ev_") else n
            key = name.replace("bd_rec_", "").replace("bd_", "")
            fields[key] = _arr(getattr(lib, name)(hp), count,
                               np.dtype(typ), ho)
        out = BamArrays(ref_names=ref_names, ref_lens=ref_lens, **fields)
        out.n_qnames = int(lib.bd_n_qnames(hp))
        out.ranged = ranged
        out._handle_obj = ho
        return out
    finally:
        if h:
            lib.bd_free(h)


def _int16_counts(counts16: np.ndarray) -> np.ndarray:
    c = np.ascontiguousarray(counts16)
    if c.dtype != np.int16 or c.ndim != 3 or c.shape[1] != 4:
        raise ValueError(f"counts must be int16 [M, 4, L], got {c.dtype} "
                         f"{c.shape}")
    return c


def pack_counts_sparse_d16_into(counts16: np.ndarray, delta_out: np.ndarray,
                                vals_out: np.ndarray, corr_idx: np.ndarray,
                                corr_val: np.ndarray):
    """Delta-encoded sparse pack of one int16 count tensor into the given
    buffers (bd_pack_counts_sparse_d16): for each nonzero cell, in flat
    order, a uint16 delta from the previous entry's flat index (the first
    from -1; gaps over 65,535 chained through zero-value entries) and its
    value as uint8, saturated at 255; each cell over 255 also an int32
    correction (its flat index, value - 255). Returns (entries,
    corrections) the tensor needs; where either exceeds its buffer the
    buffer holds a prefix (buffers of length 0 count without writing)."""
    flat = np.ascontiguousarray(counts16).reshape(-1)
    if flat.dtype != np.int16:
        raise ValueError(f"counts must be int16, got {flat.dtype}")
    if not (delta_out.dtype == np.uint16 and vals_out.dtype == np.uint8 and
            corr_idx.dtype == np.int32 and corr_val.dtype == np.int32 and
            len(delta_out) == len(vals_out) and
            len(corr_idx) == len(corr_val)):
        raise ValueError("wire buffers must be uint16/uint8 and int32/int32 "
                         "pairs of equal lengths")
    for a in (delta_out, vals_out, corr_idx, corr_val):
        if not a.flags.c_contiguous:
            raise ValueError("wire buffers must be contiguous")
    ncorr = ct.c_int64(0)
    nnz = _load_lib().bd_pack_counts_sparse_d16(
        flat.ctypes.data_as(ct.POINTER(ct.c_int16)), flat.size,
        delta_out.ctypes.data_as(ct.POINTER(ct.c_uint16)),
        vals_out.ctypes.data_as(ct.POINTER(ct.c_uint8)), len(vals_out),
        corr_idx.ctypes.data_as(ct.POINTER(ct.c_int32)),
        corr_val.ctypes.data_as(ct.POINTER(ct.c_int32)), len(corr_idx),
        ct.byref(ncorr))
    return int(nnz), int(ncorr.value)


def total_cum16(counts16: np.ndarray, n_mm: int) -> np.ndarray:
    """Cumulative coverage [n_mm, Lp] int32 of an int16 count tensor
    [Mp, 4, Lp] (bd_total_cum16): the sum over bases of the counts of
    levels 0..m."""
    c = _int16_counts(counts16)
    if not 0 <= n_mm <= c.shape[0]:
        raise ValueError(f"n_mm {n_mm} outside the tensor's {c.shape[0]}")
    Lp = c.shape[2]
    out = np.empty((n_mm, Lp), dtype=np.int32)
    _load_lib().bd_total_cum16(c.ctypes.data_as(ct.POINTER(ct.c_int16)),
                               n_mm, Lp,
                               out.ctypes.data_as(ct.POINTER(ct.c_int32)))
    return out


def clon_cum16(counts16: np.ndarray, n_mm: int, min_cov: int):
    """One native pass over an int16 count tensor [Mp, 4, Lp]
    (bd_clon_cum16): (total int32 [n_mm, Lp] as total_cum16, clonality
    float32 [n_mm, Lp], NaN where the exact level has no count or the
    coverage is below min_cov): the hybrid and batch engines' total and
    clon of a scaffold whose counts went over the sparse wire, as the JAX
    package's take them."""
    c = _int16_counts(counts16)
    if not 0 <= n_mm <= c.shape[0]:
        raise ValueError(f"n_mm {n_mm} outside the tensor's {c.shape[0]}")
    Lp = c.shape[2]
    total = np.empty((n_mm, Lp), dtype=np.int32)
    clon = np.empty((n_mm, Lp), dtype=np.float32)
    _load_lib().bd_clon_cum16(c.ctypes.data_as(ct.POINTER(ct.c_int16)),
                              n_mm, Lp, min_cov,
                              total.ctypes.data_as(ct.POINTER(ct.c_int32)),
                              clon.ctypes.data_as(ct.POINTER(ct.c_float)))
    return total, clon


def baq_one(ref_codes: np.ndarray, pos: int, cigar: np.ndarray,
            seq_codes: np.ndarray, qual: np.ndarray) -> np.ndarray:
    """BAQ-capped qualities of one alignment (native/baq.cc bd_baq_one):
    the read's base codes `seq_codes` with qualities `qual`, aligned at
    0-based `pos` of `ref_codes` by the BAM-encoded `cigar` (length << 4 |
    op). Where the alignment cannot be realigned, `qual` unchanged (a
    copy)."""
    lib = _load_lib()
    ref_codes = np.ascontiguousarray(ref_codes, dtype=np.uint8)
    cigar = np.ascontiguousarray(cigar, dtype=np.uint32)
    seq_codes = np.ascontiguousarray(seq_codes, dtype=np.uint8)
    qual = np.ascontiguousarray(qual, dtype=np.uint8)
    out = qual.copy()
    u8 = ct.POINTER(ct.c_uint8)
    rc = lib.bd_baq_one(
        ref_codes.ctypes.data_as(u8), len(ref_codes), pos,
        cigar.ctypes.data_as(ct.POINTER(ct.c_uint32)), len(cigar),
        seq_codes.ctypes.data_as(u8), qual.ctypes.data_as(u8), len(qual),
        out.ctypes.data_as(u8))
    return out if rc == 0 else qual.copy()
