"""
Synthetic mapping generators.

synth: S random scaffolds of L bp with planted strain SNVs (~1 per kb on
~30% of the reads covering them) and proper read pairs at ~COV coverage,
written as a FASTA and a BGZF BAM. It makes the same random draws in the
same order as the JAX package's benchmark generator (bench_batch.synth),
so for equal seed and sizes the BAM is byte-identical to it (asserted in
tests/test_torch_io.py).

synth_samples: the input of `compare` — one shared FASTA, one BAM per
sample mapped to it, and a scaffold-to-genome file; each genome has two
strain haplotypes, and each sample carries one of them at its own
coverage.

The records are built with numpy in blocks of reads; no .bai index is
written.
"""

from __future__ import annotations

import multiprocessing
import os
import struct
from concurrent.futures import ProcessPoolExecutor
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .io.bgzf import _CHAR2NIB, bam_header, write_bgzf

READ = 150       # read length
INSERT = 300     # outer insert size
MAPQ = 42
QUAL = 40        # >= the pileup's min base quality 30

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def synth(workdir: str, S: int = 128, L: int = 40_000, COV: int = 30,
          seed: int = 7) -> Tuple[str, str, int]:
    """Write <workdir>/synth.fasta and synth.bam; returns
    (fasta, bam, number of read pairs)."""
    rng = np.random.default_rng(seed)
    fasta = os.path.join(workdir, "synth.fasta")
    bam = os.path.join(workdir, "synth.bam")
    n_pairs = int(L * COV / (2 * READ))
    refs = []
    with open(fasta, "w") as f:
        for s in range(S):
            seq = BASES[rng.integers(0, 4, L)]
            refs.append(seq)
            f.write(f">scaf_{s}\n{seq.tobytes().decode()}\n")

    parts = [bam_header([(f"scaf_{s}", L) for s in range(S)])]
    qid = 0
    for s in range(S):
        parts.append(_scaffold_records(rng, s, refs[s], L, n_pairs, qid))
        qid += n_pairs
    write_bgzf(bam, b"".join(parts))
    return fasta, bam, S * n_pairs


def synth_samples(workdir: str, n_samples: int, S: int, L: int,
                  covs: Sequence[float], seed: int = 7, n_genomes: int = 2
                  ) -> Tuple[str, List[str], str]:
    """Write <workdir>/samples.fasta (S random scaffolds of L bp), one
    sample_<i>.bam per sample, and samples.stb, which puts consecutive
    runs of S / n_genomes scaffolds into genome_0, genome_1, ... Each
    genome has two strain haplotypes, each the reference with its own
    SNVs (~1 per kb, at positions of its own). Each sample draws, per
    genome, which strain it carries (both strains occur in every genome
    from two samples on) and maps reads from it at coverage covs[i], with
    synth's within-sample variants on top; NM counts the mismatches
    against the shared reference. Sample i draws its reads from a
    generator of its own (seed, i), so the samples are written in
    parallel processes. Returns (fasta, bams, stb)."""
    rng = np.random.default_rng(seed)
    assert S % n_genomes == 0 and len(covs) == n_samples
    per = S // n_genomes
    fasta = os.path.join(workdir, "samples.fasta")
    stb = os.path.join(workdir, "samples.stb")
    refs = [BASES[rng.integers(0, 4, L)] for _ in range(S)]
    with open(fasta, "w") as f:
        for s, seq in enumerate(refs):
            f.write(f">scaf_{s}\n{seq.tobytes().decode()}\n")
    with open(stb, "w") as f:
        for s in range(S):
            f.write(f"scaf_{s}\tgenome_{s // per}\n")
    # two haplotypes per scaffold, on disjoint SNV positions
    haps = []
    for ref in refs:
        pos = rng.choice(L, 2 * (L // 1000), replace=False)
        pair = []
        for k in range(2):
            p = pos[k::2]
            h = ref.copy()
            h[p] = BASES[(np.searchsorted(BASES, ref[p]) +
                          rng.integers(1, 4, len(p))) % 4]
            pair.append(h)
        haps.append(pair)
    strain = np.stack([rng.permutation(np.arange(n_samples) % 2)
                       for _ in range(n_genomes)])       # [genome, sample]
    bams = [os.path.join(workdir, f"sample_{i}.bam")
            for i in range(n_samples)]
    jobs = [(bams[i], (seed, i), [haps[s][strain[s // per, i]]
                                  for s in range(S)], refs, covs[i])
            for i in range(n_samples)]
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(min(n_samples, os.cpu_count() or 1),
                             mp_context=ctx) as pool:
        list(pool.map(_write_sample, *zip(*jobs)))
    return fasta, bams, stb


def _write_sample(bam: str, seed, haps: List[np.ndarray],
                  refs: List[np.ndarray], cov: float) -> None:
    """One synth_samples BAM: reads from each scaffold's haplotype."""
    rng = np.random.default_rng(seed)
    L = len(refs[0])
    n_pairs = int(L * cov / (2 * READ))
    parts = [bam_header([(f"scaf_{s}", L) for s in range(len(refs))])]
    for s, (hap, ref) in enumerate(zip(haps, refs)):
        parts.append(_scaffold_records(rng, s, hap, L, n_pairs,
                                       s * n_pairs, truth=ref))
    write_bgzf(bam, b"".join(parts))


def _scaffold_records(rng, s: int, ref: np.ndarray, L: int, n_pairs: int,
                      qid0: int, truth: Optional[np.ndarray] = None
                      ) -> bytes:
    """Coordinate-sorted BAM records of one scaffold's read pairs, read
    from `ref`; NM counts mismatches against `truth` (the mapping
    reference) where it is given, else the planted SNVs a read carries."""
    snv_pos = rng.choice(L, L // 1000, replace=False)
    snv_alt = BASES[(np.searchsorted(BASES, ref[snv_pos]) +
                     rng.integers(1, 4, len(snv_pos))) % 4]
    starts = np.sort(rng.integers(0, L - INSERT, n_pairs))

    # reads in generation order: mate 1 then mate 2 of each pair
    pos = np.empty(2 * n_pairs, dtype=np.int64)
    pos[0::2] = starts
    pos[1::2] = starts + INSERT - READ
    # planted SNVs inside each read's window; a read with any draws one
    # uniform (in read order) and carries all of them with p = 0.3
    sorted_snv = np.sort(snv_pos)
    n_in = (np.searchsorted(sorted_snv, pos + READ) -
            np.searchsorted(sorted_snv, pos))
    has = n_in > 0
    mutated = np.zeros(len(pos), dtype=bool)
    mutated[has] = rng.random(int(has.sum())) < 0.3
    nm = np.where(mutated, n_in, 0)

    alt_ref = ref.copy()
    alt_ref[snv_pos] = snv_alt
    if truth is not None:
        win = pos[:, None] + np.arange(READ)
        nm = (np.where(mutated[:, None], alt_ref[win], ref[win]) !=
              truth[win]).sum(axis=1)
    n = len(pos)
    first = np.arange(n) % 2 == 0
    mate = np.empty_like(pos)
    mate[0::2], mate[1::2] = pos[1::2], pos[0::2]
    q = qid0 + np.arange(n, dtype=np.int64) // 2
    digits = np.ones(n, dtype=np.int64)
    p10 = 10
    while (q >= p10).any():
        digits += q >= p10
        p10 *= 10
    l_name = digits + 2                     # "r", the digits, "\0"
    tail = 4 + (READ + 1) // 2 + READ + 7   # cigar, seq, qual, NM:i

    hdr = np.zeros(n, dtype=_HDR)
    hdr["block_size"] = _HDR.itemsize - 4 + l_name + tail
    hdr["ref_id"] = hdr["next_ref_id"] = s
    hdr["pos"], hdr["next_pos"] = pos, mate
    hdr["l_read_name"], hdr["mapq"] = l_name, MAPQ
    hdr["bin"], hdr["n_cigar_op"] = 4680, 1
    hdr["flag"] = np.where(first, 99, 147)
    hdr["l_seq"] = READ
    hdr["tlen"] = np.where(first, INSERT, -INSERT)

    # records in coordinate order (a stable sort of pos); each row is the
    # fixed part, the name padded to the block's widest and the tail, and
    # the padding is masked out as the rows are flattened
    order = np.argsort(pos, kind="stable")
    fixed = np.frombuffer(struct.pack("<I", (READ << 4) | 0), np.uint8)
    qual_nm = np.frombuffer(bytes([QUAL]) * READ + b"NMi", np.uint8)
    out = []
    block = 1 << 15      # reads per vectorised block (bounds memory)
    for i in range(0, n, block):
        idx = order[i:i + block]
        b = len(idx)
        d, qq = digits[idx], q[idx]
        w = int(d.max()) + 2
        rows = np.empty((b, _HDR.itemsize + w + tail), dtype=np.uint8)
        rows[:, :_HDR.itemsize] = hdr[idx].view(np.uint8).reshape(
            b, _HDR.itemsize)
        name = rows[:, _HDR.itemsize:_HDR.itemsize + w]
        name[:] = 0
        name[:, 0] = ord("r")
        for k in range(w - 2):
            live = k < d
            place = 10 ** np.maximum(d - 1 - k, 0)
            name[live, 1 + k] = ord("0") + (qq[live] // place[live]) % 10
        win = pos[idx, None] + np.arange(READ)
        seqs = np.where(mutated[idx, None], alt_ref[win], ref[win])
        nibs = _CHAR2NIB[seqs]
        t = rows[:, _HDR.itemsize + w:]
        t[:, :4] = fixed
        t[:, 4:4 + READ // 2] = (nibs[:, 0::2] << 4) | nibs[:, 1::2]
        t[:, 4 + READ // 2:-4] = qual_nm
        t[:, -4:] = nm[idx].astype("<i4").view(np.uint8).reshape(b, 4)
        keep = np.ones(rows.shape, dtype=bool)
        keep[:, _HDR.itemsize:_HDR.itemsize + w] = (
            np.arange(w)[None, :] < (d + 2)[:, None])
        out.append(rows[keep])
    return np.concatenate(out).tobytes() if out else b""


# the fixed part of a BAM record: block_size and the 32-byte core
_HDR = np.dtype([("block_size", "<i4"), ("ref_id", "<i4"), ("pos", "<i4"),
                 ("l_read_name", "u1"), ("mapq", "u1"), ("bin", "<u2"),
                 ("n_cigar_op", "<u2"), ("flag", "<u2"), ("l_seq", "<i4"),
                 ("next_ref_id", "<i4"), ("next_pos", "<i4"),
                 ("tlen", "<i4")])


def site_stats_inputs(M: int, L: int, seed: int):
    """Random site-stats inputs (counts int32 [M, 4, L], ref codes uint8
    [L]) with the edge cases the kernels must get right: reference code 4,
    coverage above the 10000-entry LUT cap, an mm level with no counts
    (M > 1), and positions with no coverage at all."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 30, (M, 4, L)).astype(np.int32)
    counts[rng.random((M, 4, L)) < 0.55] = 0
    counts[:, :, rng.random(L) < 0.1] = 0              # uncovered positions
    hot = rng.choice(L, 40, replace=False)
    counts[:, :, hot] = rng.integers(2000, 4000, (M, 4, 40))  # > LUT cap
    if M > 1:
        counts[M // 2] = 0                             # a zero-count level
    ref = rng.integers(0, 4, L).astype(np.uint8)
    ref[rng.random(L) < 0.15] = 4                      # not ACTG
    return counts, ref


def ld_inputs(E: int, M: int, N: int, seed: int):
    """Random inputs of the linkage kernel for E edges over M mm levels
    and N captured pairs: (e_idx, mm_idx, combo int32 [N], c1, c2 int32
    [E, M, 4] cumulative base counts, present1, present2 bool [E, M]).
    Each edge has a major and a minor base at each end, and most pairs
    carry them, so many cells pass the gates; some edges tie their two
    bases' counts (the stable allele order), and some levels are absent."""
    rng = np.random.default_rng(seed)
    ends = np.stack([rng.permutation(4)[:2] for _ in range(2 * E)])
    ends = ends.reshape(E, 2, 2)                 # [edge, end, major/minor]
    e_idx = rng.integers(0, E, N).astype(np.int32)
    mm_idx = rng.integers(0, M, N).astype(np.int32)
    b = [ends[e_idx, k, (rng.random(N) > p).astype(int)]
         for k, p in ((0, 0.65), (1, 0.6))]
    noise = rng.random((2, N)) < 0.03
    b = [np.where(noise[k], rng.integers(0, 4, N), b[k]) for k in range(2)]
    combo = (b[0] * 4 + b[1]).astype(np.int32)
    c = []
    for k in range(2):
        exact = np.zeros((E, M, 4), np.int64)
        np.add.at(exact, (e_idx, mm_idx, b[k]), 1)
        exact += rng.integers(0, 3, (E, M, 4)) * (rng.random((E, M, 4)) < 0.2)
        tie = rng.random(E) < 0.1
        maj, mnr = ends[:, k, 0], ends[:, k, 1]
        ee = np.nonzero(tie)[0]
        exact[ee, :, mnr[ee]] = exact[ee, :, maj[ee]]
        c.append(np.cumsum(exact, axis=1).astype(np.int32))
    present = [rng.random((E, M)) < 0.9 for _ in range(2)]
    return e_idx, mm_idx, combo, c[0], c[1], present[0], present[1]
