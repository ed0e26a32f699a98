"""
Minimal BAM index (.bai) support: a writer and an extent reader — the
counterpart of instrain_tpu/io/bai.py, the same bytes.

The native ranged decoder (native/bam.cc:parse_bai) consumes only the
per-reference chunk extents [min voffset, max voffset) of a .bai — bins
and linear intervals are ignored (except the 37450 pseudo-bin). So a
minimal index with ONE synthetic bin holding ONE chunk per reference is
sufficient for `decode_bam(..., scaffolds=[...])`, and lets synthetic
BAMs (synth.synth, synth.synth_samples) take the ranged path the
reference reaches via `samtools index` (reference:
inStrain/profile/samtools_ops.py:70-164).

`read_ref_extents` additionally exposes the per-reference COMPRESSED
byte extents as a load-balance proxy: the bytes of BGZF data holding a
scaffold's records are ~proportional to its read count, which lets
multi-host runs assign scaffolds to hosts BEFORE any decode happens
(the reference's analogous pre-split cost model is pair-count based,
profile_controller.py:460-465, but pair counts require a decode).
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import List, Optional, Tuple

import numpy as np


def _scan_bgzf_blocks(raw: bytes) -> List[Tuple[int, int]]:
    """[(compressed_offset, block_size)] for each BGZF member."""
    blocks = []
    p = 0
    n = len(raw)
    while p < n:
        if raw[p:p + 2] != b"\x1f\x8b":
            raise ValueError("not a BGZF stream")
        xlen = struct.unpack_from("<H", raw, p + 10)[0]
        q = p + 12
        end = q + xlen
        bsize = None
        while q < end:
            si1, si2 = raw[q], raw[q + 1]
            slen = struct.unpack_from("<H", raw, q + 2)[0]
            if si1 == 66 and si2 == 67:  # 'BC'
                bsize = struct.unpack_from("<H", raw, q + 4)[0] + 1
            q += 4 + slen
        if bsize is None:
            raise ValueError("BGZF block without BC subfield")
        blocks.append((p, bsize))
        p += bsize
    return blocks


def make_bai(bam_path: str, out_path: Optional[str] = None) -> str:
    """Write a minimal .bai for a coordinate-sorted BGZF BAM.

    One bin (id 0) with one chunk [first record voffset, end-of-last
    record voffset) per reference; no linear index. Satisfies the native
    ranged decoder's parse_bai; NOT a general htslib-compatible index
    (no region queries below whole-reference granularity)."""
    raw = open(bam_path, "rb").read()
    blocks = _scan_bgzf_blocks(raw)
    # decompress per block, tracking each block's uncompressed start
    ustarts = []
    parts = []
    u = 0
    for coff, bsize in blocks:
        data = zlib.decompress(raw[coff:coff + bsize], 31)
        ustarts.append(u)
        parts.append(data)
        u += len(data)
    stream = b"".join(parts)
    ustarts_a = np.array(ustarts, dtype=np.int64)
    coffs_a = np.array([c for c, _ in blocks], dtype=np.int64)

    def voffset(upos: int) -> int:
        i = int(np.searchsorted(ustarts_a, upos, side="right")) - 1
        return (int(coffs_a[i]) << 16) | (upos - int(ustarts_a[i]))

    if stream[:4] != b"BAM\x01":
        raise ValueError("not a BAM stream")
    p = 4
    l_text = struct.unpack_from("<i", stream, p)[0]
    p += 4 + l_text
    n_ref = struct.unpack_from("<i", stream, p)[0]
    p += 4
    for _ in range(n_ref):
        l_name = struct.unpack_from("<i", stream, p)[0]
        p += 4 + l_name + 4

    vbeg = [None] * n_ref
    vend = [None] * n_ref
    while p < len(stream):
        bsz = struct.unpack_from("<i", stream, p)[0]
        rid = struct.unpack_from("<i", stream, p + 4)[0]
        if 0 <= rid < n_ref:
            if vbeg[rid] is None:
                vbeg[rid] = voffset(p)
            vend[rid] = voffset(p + 4 + bsz)
        p += 4 + bsz

    out_path = out_path or bam_path + ".bai"
    with open(out_path, "wb") as f:
        f.write(b"BAI\x01")
        f.write(struct.pack("<i", n_ref))
        for r in range(n_ref):
            if vbeg[r] is None:
                f.write(struct.pack("<ii", 0, 0))  # n_bin=0, n_intv=0
                continue
            f.write(struct.pack("<i", 1))           # n_bin
            f.write(struct.pack("<Ii", 0, 1))       # bin id 0, n_chunk
            f.write(struct.pack("<QQ", vbeg[r], vend[r]))
            f.write(struct.pack("<i", 0))           # n_intv
    return out_path


def read_bam_ref_names(bam_path: str) -> List[str]:
    """Reference names from a BGZF BAM's header ONLY — inflates leading
    blocks until the reference dictionary is complete (headers are one
    or two blocks), so multi-host scaffold assignment can run before any
    record decode."""
    out: List[str] = []
    with open(bam_path, "rb") as f:
        # headers are usually < 4 MB, but a 100k-contig metagenome's
        # reference dictionary can exceed that — read up to 64 MB
        raw = f.read(1 << 26)

    def try_parse(stream: bytes):
        if stream[:4] != b"BAM\x01" or len(stream) < 12:
            return None
        try:
            sp = 4
            l_text = struct.unpack_from("<i", stream, sp)[0]
            sp += 4 + l_text
            n_ref = struct.unpack_from("<i", stream, sp)[0]
            sp += 4
            names = []
            for _ in range(n_ref):
                l_name = struct.unpack_from("<i", stream, sp)[0]
                sp += 4
                # a bytes slice never raises on short data: bound-check
                # explicitly so the LAST name cannot come back truncated
                # when it straddles a block boundary
                if sp + l_name + 4 > len(stream):
                    return None
                names.append(stream[sp:sp + l_name - 1].decode())
                sp += l_name + 4
            return names
        except (struct.error, IndexError, UnicodeDecodeError):
            return None  # need more blocks

    parts: List[bytes] = []
    p = 0
    n_blocks = 0
    next_try = 1  # parse attempts at 1, 2, 4, ... blocks: O(B log B)
    while p < len(raw):
        if raw[p:p + 2] != b"\x1f\x8b":
            break
        xlen = struct.unpack_from("<H", raw, p + 10)[0]
        q = p + 12
        bsize = None
        while q < p + 12 + xlen:
            si1, si2 = raw[q], raw[q + 1]
            slen = struct.unpack_from("<H", raw, q + 2)[0]
            if si1 == 66 and si2 == 67:
                bsize = struct.unpack_from("<H", raw, q + 4)[0] + 1
            q += 4 + slen
        if bsize is None or p + bsize > len(raw):
            break
        parts.append(zlib.decompress(raw[p:p + bsize], 31))
        p += bsize
        n_blocks += 1
        if n_blocks >= next_try or p >= len(raw):
            next_try = n_blocks * 2
            got = try_parse(b"".join(parts))
            if got is not None:
                out = got
                break
    if not out:
        raise ValueError(f"could not parse BAM header of {bam_path}")
    return out


def find_bai(bam_path: str) -> Optional[str]:
    """The index beside a BAM (BAM.bai, or BAM with .bam replaced by
    .bai), or None."""
    cands = [bam_path + ".bai"]
    if bam_path.endswith(".bam"):
        cands.append(bam_path[:-4] + ".bai")
    for c in cands:
        if os.path.exists(c):
            return c
    return None


def read_ref_extents(bai_path: str) -> np.ndarray:
    """Per-reference compressed byte extent from a .bai: for each ref the
    span (max chunk_end - min chunk_beg) of COMPRESSED file offsets
    (voffset >> 16), 0 for refs with no chunks. A cheap, decode-free
    proxy for per-scaffold record volume (multi-host load balance)."""
    b = open(bai_path, "rb").read()
    if b[:4] != b"BAI\x01":
        raise ValueError("bad .bai magic")
    p = 4
    n_ref = struct.unpack_from("<i", b, p)[0]
    p += 4
    out = np.zeros(n_ref, dtype=np.int64)
    for r in range(n_ref):
        n_bin = struct.unpack_from("<i", b, p)[0]
        p += 4
        lo, hi = None, None
        for _ in range(n_bin):
            bin_id, n_chunk = struct.unpack_from("<Ii", b, p)
            p += 8
            for _ in range(n_chunk):
                beg, end = struct.unpack_from("<QQ", b, p)
                p += 16
                if bin_id == 37450:  # pseudo-bin holds counts, not offsets
                    continue
                cb, ce = beg >> 16, end >> 16
                lo = cb if lo is None else min(lo, cb)
                hi = ce if hi is None else max(hi, ce)
        n_intv = struct.unpack_from("<i", b, p)[0]
        p += 4 + n_intv * 8
        if lo is not None:
            # +1: same-block refs still get a nonzero weight
            out[r] = (hi - lo) + 1
    return out
