"""
FASTA parsing and scaffold windowing.

Replaces the reference's Bio.SeqIO + pandas split table
(reference: inStrain/profile/fasta.py:12-107) with a dependency-free parser
that returns numpy base-code arrays ready for device transfer.

Base encoding: A=0, C=1, T=2, G=3, everything else (incl. N, lowercase in
reads) = 4. The reference uppercases scaffold sequences on load
(fasta.py:25-27) — we do the same for the reference genome; read bases are
NOT uppercased, matching the pileup's KeyError-skip of lowercase/N bases
(profile/profile_utilities.py:284-285).
"""

from __future__ import annotations

import gzip
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

# base -> code lookup table over all 256 byte values
BASE2CODE = np.full(256, 4, dtype=np.uint8)
for i, b in enumerate(b"ACTG"):  # P2C order (profile_utilities.py:34)
    BASE2CODE[b] = i
CODE2BASE = np.frombuffer(b"ACTGN", dtype=np.uint8)

# uppercasing table for reference sequences
_UPPER = np.arange(256, dtype=np.uint8)
_UPPER[ord("a"):ord("z") + 1] -= 32


def _open(path: str):
    if str(path).endswith(".gz"):
        return gzip.open(path, "rb")
    return open(path, "rb")


def read_fasta(path: str, use_full_header: bool = False,
               uppercase: bool = True) -> Dict[str, np.ndarray]:
    """Parse FASTA into {name: uint8 byte array of sequence}."""
    seqs: Dict[str, np.ndarray] = {}
    name = None
    chunks: List[bytes] = []
    with _open(path) as f:
        for raw in f:
            line = raw.rstrip(b"\r\n")
            if line.startswith(b">"):
                if name is not None:
                    seqs[name] = _finalize(chunks, uppercase)
                header = line[1:].decode()
                name = header if use_full_header else header.split()[0]
                chunks = []
            elif line:
                chunks.append(line)
    if name is not None:
        seqs[name] = _finalize(chunks, uppercase)
    return seqs


def _finalize(chunks: List[bytes], uppercase: bool) -> np.ndarray:
    arr = np.frombuffer(b"".join(chunks), dtype=np.uint8)
    if uppercase:
        arr = _UPPER[arr]
    return arr


def seq_to_codes(seq: np.ndarray) -> np.ndarray:
    """uint8 ASCII -> base codes (A0 C1 T2 G3 other 4)."""
    return BASE2CODE[seq]


def codes_to_str(codes: np.ndarray) -> str:
    """Base codes -> their sequence text (code 4 and above: N)."""
    return CODE2BASE[np.minimum(codes, 4)].tobytes().decode()


def iterate_splits(s_len: int, window_len: int) -> Iterator[Tuple[int, int]]:
    """
    0-based double-inclusive windows, exactly the reference's chunking
    (profile/fasta.py:56-73): numberChunks = len // window + 1, equal-size
    chunks of int(len / numberChunks), remainder absorbed by the last.
    """
    number_chunks = s_len // window_len + 1
    chunk_len = int(s_len / number_chunks)
    start = 0
    end = 0
    for i in range(number_chunks):
        if i + 1 == number_chunks:
            yield start, s_len - 1
        else:
            end += chunk_len
            yield start, end - 1
            start += chunk_len


@dataclass
class ScaffoldRegistry:
    """
    Canonical host-side registry of the reference genome: names, lengths,
    base codes, and window (split) layout. This replaces the reference's
    (Fdb DataFrame, scaff2sequence dict) pair.
    """

    names: List[str]
    lengths: np.ndarray                    # int64 [n_scaffolds]
    codes: Dict[str, np.ndarray]           # name -> uint8 base codes
    window_length: int = 10000
    name_to_id: Dict[str, int] = field(default_factory=dict)

    def __post_init__(self):
        if not self.name_to_id:
            self.name_to_id = {n: i for i, n in enumerate(self.names)}

    @classmethod
    def from_fasta(cls, path: str, window_length: int = 10000,
                   use_full_header: bool = False,
                   scaffolds_to_profile=None) -> "ScaffoldRegistry":
        seqs = read_fasta(path, use_full_header=use_full_header)
        if scaffolds_to_profile is not None:
            keep = set(scaffolds_to_profile)
            seqs = {n: s for n, s in seqs.items() if n in keep}
        names = list(seqs.keys())
        lengths = np.array([len(seqs[n]) for n in names], dtype=np.int64)
        codes = {n: seq_to_codes(seqs[n]) for n in names}
        return cls(names=names, lengths=lengths, codes=codes,
                   window_length=window_length)

    @property
    def s2l(self) -> Dict[str, int]:
        return {n: int(l) for n, l in zip(self.names, self.lengths)}

    def length_of(self, name: str) -> int:
        return int(self.lengths[self.name_to_id[name]])

    def splits_of(self, name: str) -> List[Tuple[int, int]]:
        """The scaffold's windows (iterate_splits over its length)."""
        return list(iterate_splits(self.length_of(name), self.window_length))


def load_scaff_list(path: Optional[str]):
    """
    Text file of scaffold names, or a FASTA whose ids are taken
    (reference: profile/fasta.py:138-166). Returns a set or None.
    """
    if path is None:
        return None
    with _open(path) as f:
        data = f.read()
    if data.lstrip().startswith(b">"):
        return {line[1:].split()[0].decode()
                for line in data.splitlines() if line.startswith(b">")}
    return {line.strip().decode() for line in data.splitlines()
            if line.strip()}
