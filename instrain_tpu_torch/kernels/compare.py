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
                               for one scaffold (kernels/cuda_compare.py):
                               AND of the words' bytes and a 256-entry
                               popcount table
  group_plan, group_buffer     a comparison group's scaffolds in one
                               buffer for one launch: the group table
                               (csrc/compare.cu) and the words
  overlap_counts_group_plain   the plain version of the group kernel: a
                               loop of overlap_counts_plain over the table
  split_counts                 the group's counts, scaffold by scaffold
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

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


# ---------------------------------------------------------------------------
# A comparison group in one launch (csrc/compare.cu): per scaffold s,
# words [N_s, Mg_s, W_s] end to end after the group table; its counts
# both [Mg_s, N_s, N_s] then single [Mg_s, N_s] end to end in one int64
# output. Each (scaffold, mm level) row is cut into blocks of `chunk`
# words, chunk set per scaffold for about the same bytes a block (the
# kernel is bound by its reads), so that the group gives every SM
# GROUP_BLOCKS_PER_SM blocks; chunk is a multiple of GROUP_MIN_CHUNK, and
# a block's 32-bit sums bound it by GROUP_MAX_CHUNK (2^24 words hold 2^30
# positions).

GROUP_FIELDS = 7           # N, Mg, W, chunk, word off, out off, block0
GROUP_MIN_CHUNK = 32
GROUP_MAX_CHUNK = 1 << 24
GROUP_BLOCKS_PER_SM = 4


class GroupPlan(NamedTuple):
    """The launch of a group of scaffolds of `shapes` (N, Mg, W): the
    int64 table [GROUP_FIELDS, S + 1] (csrc/compare.cu), the words and
    counts in all and the blocks of the launch."""
    shapes: Tuple[Tuple[int, int, int], ...]
    table: np.ndarray
    n_words: int
    n_out: int
    n_blocks: int


def group_plan(shapes: Sequence[Tuple[int, int, int]],
               sms: int = 132) -> GroupPlan:
    """The group table of scaffolds of (N, Mg, W), each >= 1, for a card
    of `sms` SMs (plain Python: it runs before every launch)."""
    shapes = tuple((int(n), int(mg), int(w)) for n, mg, w in shapes)
    assert shapes and all(min(x) >= 1 for x in shapes), shapes
    total = sum(n * mg * w for n, mg, w in shapes)
    per_block = -(-total // (sms * GROUP_BLOCKS_PER_SM))
    t = np.zeros((GROUP_FIELDS, len(shapes) + 1), np.int64)
    for s, (n, mg, w) in enumerate(shapes):
        chunk = -(-per_block // n // GROUP_MIN_CHUNK) * GROUP_MIN_CHUNK
        chunk = min(max(chunk, GROUP_MIN_CHUNK), GROUP_MAX_CHUNK, w)
        t[:4, s] = n, mg, w, chunk
        t[4, s + 1] = t[4, s] + n * mg * w
        t[5, s + 1] = t[5, s] + mg * n * (n + 1)
        t[6, s + 1] = t[6, s] + mg * -(-w // chunk)
    return GroupPlan(shapes, t, int(t[4, -1]), int(t[5, -1]),
                     int(t[6, -1]))


def group_buffer(words: Sequence[np.ndarray], plan: GroupPlan,
                 out: np.ndarray = None) -> np.ndarray:
    """The group's one host buffer, int64 [table | words], written into
    `out` (a view of pinned memory, say) when given."""
    n_table = plan.table.size
    if out is None:
        out = np.empty(n_table + plan.n_words, np.int64)
    out[:n_table] = plan.table.reshape(-1)
    at = n_table
    for w in words:
        out[at:at + w.size] = w.reshape(-1).view(np.int64)
        at += w.size
    assert at == out.size, (at, out.size)
    return out


def overlap_counts_group_plain(buf: torch.Tensor, plan: GroupPlan
                               ) -> torch.Tensor:
    """Plain version of the group kernel: int64 [n_out] counts of the
    group buffer `buf` (int64 [table | words], on any device)."""
    words = buf[plan.table.size:]
    out = []
    for s, (n, mg, w) in enumerate(plan.shapes):
        a = int(plan.table[4, s])
        both, single = overlap_counts_plain(
            words[a:a + n * mg * w].view(n, mg, w))
        out += [both.reshape(-1), single.reshape(-1)]
    return torch.cat(out)


def split_counts(out: np.ndarray, plan: GroupPlan
                 ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """(both [Mg, N, N], single [Mg, N]) of each scaffold of the group,
    views of its counts `out` int64 [n_out]."""
    res = []
    for s, (n, mg, _) in enumerate(plan.shapes):
        a = int(plan.table[5, s])
        res.append((out[a:a + mg * n * n].reshape(mg, n, n),
                    out[a + mg * n * n:a + mg * n * (n + 1)].reshape(mg, n)))
    return res
