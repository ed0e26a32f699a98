"""
BGZF, BAM and .bai writing for the benchmark's generator (SAMv1: BAM
section 4.2, BGZF section 4.1, BAI section 5.2).

The payload is cut into members of MEMBER bytes, compressed by a pool of
threads (zlib releases the interpreter lock while it deflates), and
written in order with the EOF block. Because every member but the last
holds exactly MEMBER bytes, the virtual offset of any byte of the payload
follows from the members' compressed sizes, so the .bai is written from
the record offsets the writer already knows, without reading the BAM back.
"""

from __future__ import annotations

import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import List, Sequence, Tuple

import numpy as np

MEMBER = 60000
_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")

# base letter -> BAM 4-bit code (=ACMGRSVTWYHKDBN)
CHAR2NIB = np.zeros(256, np.uint8)
for _i, _ch in enumerate("=ACMGRSVTWYHKDBN"):
    CHAR2NIB[ord(_ch)] = _i


def header(refs: Sequence[Tuple[str, int]]) -> bytes:
    """The BAM magic, a coordinate-sorted @HD line and the references."""
    text = b"@HD\tVN:1.6\tSO:coordinate\n"
    out = [b"BAM\x01", struct.pack("<i", len(text)), text,
           struct.pack("<i", len(refs))]
    for name, length in refs:
        nb = name.encode() + b"\x00"
        out.append(struct.pack("<i", len(nb)) + nb + struct.pack("<i", length))
    return b"".join(out)


def _member(chunk: bytes, level: int) -> bytes:
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    cdata = co.compress(chunk) + co.flush()
    bsize = 12 + 6 + len(cdata) + 8
    return (struct.pack("<BBBBIBBH", 0x1f, 0x8b, 8, 4, 0, 0, 0xff, 6) +
            struct.pack("<BBHH", 66, 67, 2, bsize - 1) + cdata +
            struct.pack("<II", zlib.crc32(chunk) & 0xffffffff, len(chunk)))


def write_bgzf(path: str, payload: bytes, threads: int,
               level: int = 6) -> np.ndarray:
    """Write `payload` as BGZF; returns the compressed offset of each
    member, and of the EOF block last."""
    view = memoryview(payload)
    chunks = [view[i:i + MEMBER] for i in range(0, len(payload), MEMBER)]
    with ThreadPoolExecutor(max(threads, 1)) as pool:
        members = list(pool.map(lambda c: _member(bytes(c), level), chunks))
    offs = np.zeros(len(members) + 1, dtype=np.int64)
    offs[1:] = np.cumsum([len(m) for m in members])
    with open(path, "wb") as f:
        for m in members:
            f.write(m)
        f.write(_EOF)
    return offs


def voffset(member_offs: np.ndarray, u: int) -> int:
    """The virtual offset of uncompressed byte u of the payload."""
    return (int(member_offs[u // MEMBER]) << 16) | (u % MEMBER)


def write_bai(path: str, member_offs: np.ndarray,
              spans: List[Tuple[int, int]]) -> None:
    """A .bai with one bin (0) and one chunk per reference: from its first
    record to the end of its last, `spans` giving those two payload
    offsets per reference ((-1, -1) for a reference with no records); no
    linear index. Enough for a decoder that reads whole references."""
    with open(path, "wb") as f:
        f.write(b"BAI\x01" + struct.pack("<i", len(spans)))
        for beg, end in spans:
            if beg < 0:
                f.write(struct.pack("<ii", 0, 0))
                continue
            f.write(struct.pack("<iIi", 1, 0, 1))
            f.write(struct.pack("<QQ", voffset(member_offs, beg),
                                voffset(member_offs, end)))
            f.write(struct.pack("<i", 0))
