"""
The coverage-overlap counts of `compare` on the host, and the plain
PyTorch version of the overlap kernel (K7) — the counterpart of
instrain_tpu/kernels/compare.py.

Per scaffold and mm level, `compare` needs for every sample pair the
number of positions covered >= min_cov in both samples, |t_i & t_j|, and
per sample |t_i| (reference: readComparer.calc_mm2overlap,
readComparer.py:145-191). The masks t are kept bit-packed: 64 positions
per word, position p at bit p % 64 of word p // 64 (little-endian bit
order), the bits past L zero. Both paths AND the words and count bits, so
they give the same integers as the JAX package's bf16 einsum, exactly
and with no bound on L.

  pack_mask                    bool [Mg, L] -> uint64 [Mg, ceil(L / 64)]
  mask_bits                    the bits of packed words at given positions
  pairwise_overlap_counts_host numpy AND + popcount (the host engine)
  overlap_counts_plain         the plain PyTorch version of the kernel
                               (kernels/cuda_compare.py): AND of the
                               words' bytes and a 256-entry popcount table
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def n_words(L: int) -> int:
    """Words of 64 positions that hold L positions."""
    return -(-L // 64)


def pack_mask(mask: np.ndarray) -> np.ndarray:
    """bool [..., L] -> uint64 [..., ceil(L / 64)], zero past L."""
    b = np.packbits(mask, axis=-1, bitorder="little")
    pad = (-b.shape[-1]) % 8
    if pad:
        b = np.pad(b, [(0, 0)] * (b.ndim - 1) + [(0, pad)])
    return np.ascontiguousarray(b).view("<u8")


def unpack_words(words: np.ndarray, L: int) -> np.ndarray:
    """uint64 [..., W] -> bool [..., L] (the inverse of pack_mask)."""
    b = np.ascontiguousarray(words).view(np.uint8)
    return np.unpackbits(b, axis=-1, count=L, bitorder="little").astype(bool)


def mask_bits(words: np.ndarray, positions: np.ndarray) -> np.ndarray:
    """The mask bits at `positions` of packed words [Mg, W]: bool
    [Mg, len(positions)]."""
    p = np.asarray(positions, dtype=np.int64)
    w = words[:, p >> 6] >> (p & 63).astype(np.uint64)
    return (w & np.uint64(1)).astype(bool)


def pairwise_overlap_counts_host(words: np.ndarray
                                 ) -> Tuple[np.ndarray, np.ndarray]:
    """words: uint64 [N, Mg, W] packed masks. Returns (both [Mg, N, N],
    single [Mg, N]) int64: |t_i & t_j| and |t_i| per mm level."""
    n, mg, _ = words.shape
    both = np.zeros((mg, n, n), np.int64)
    single = np.zeros((mg, n), np.int64)
    for i in range(n):
        single[:, i] = np.bitwise_count(words[i]).sum(axis=-1,
                                                      dtype=np.int64)
        for j in range(i, n):
            c = np.bitwise_count(words[i] & words[j]).sum(axis=-1,
                                                         dtype=np.int64)
            both[:, i, j] = c
            both[:, j, i] = c
    return both, single


_POPCOUNT8 = torch.tensor([bin(b).count("1") for b in range(256)],
                          dtype=torch.uint8)


def overlap_counts_plain(words: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the overlap_counts kernel. words: int64
    [N, Mg, W] (the uint64 words' bits) on any device. Returns (both
    int64 [Mg, N, N], single int64 [Mg, N])."""
    n, mg, _ = words.shape
    b = words.contiguous().view(torch.uint8)             # [N, Mg, 8W]
    table = _POPCOUNT8.to(words.device)
    both = torch.zeros((mg, n, n), dtype=torch.int64, device=words.device)
    for i in range(n):
        c = table[(b[i:i + 1] & b[i:]).long()].sum(dim=-1,
                                                   dtype=torch.int64)
        both[:, i, i:] = c.T                              # [Mg, N - i]
        both[:, i:, i] = c.T
    single = torch.diagonal(both, dim1=1, dim2=2).contiguous()
    return both, single
