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

synth_genes: gene files for a synth FASTA — a prodigal-style .fna and a
minimal GenBank file — laid out so that profile -g meets every case of
the gene code (see its docstring).

The records are built with numpy in blocks of reads. Each BAM gets a
minimal .bai beside it (io/bai.py:make_bai), as bench_batch.synth writes,
so a decode of some scaffolds (compare's pooling) takes the ranged path.
"""

from __future__ import annotations

import multiprocessing
import os
import struct
from concurrent.futures import ProcessPoolExecutor
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .io.bai import make_bai
from .io.bgzf import _CHAR2NIB, bam_header, write_bgzf

READ = 150       # read length
INSERT = 300     # outer insert size
MAPQ = 42
QUAL = 40        # >= the pileup's min base quality 30

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def synth(workdir: str, S: int = 128, L: int = 40_000, COV: int = 30,
          seed: int = 7) -> Tuple[str, str, int]:
    """Write <workdir>/synth.fasta, synth.bam and synth.bam.bai; returns
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
    make_bai(bam)
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
    make_bai(bam)


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


_GENE_COMP = bytes.maketrans(b"ACGTN", b"TGCAN")


def _gene_layout(rng, L: int, past_end: bool):
    """[(start, end, strand)] 0-based inclusive genes tiling a scaffold of
    L bp: 300-1197 bp each, on either strand; between two genes an
    overlap of 90-299 bp (40 %), an intergenic gap of 150-599 bp (35 %)
    or 0-29 bp. With past_end, the last gene starts at least 150 bp
    before the end and runs 60 bp past it."""
    genes = []
    pos = int(rng.integers(0, 200))
    while True:
        end = pos + 3 * int(rng.integers(100, 400)) - 1
        strand = "-1" if rng.random() < 0.5 else "1"
        if end >= L - 1:
            if past_end:
                genes.append((min(pos, L - 150), L - 1 + 60, strand))
            return genes
        genes.append((pos, end, strand))
        r = rng.random()
        gap = (-int(rng.integers(90, 300)) if r < 0.4 else
               int(rng.integers(150, 600)) if r < 0.75 else
               int(rng.integers(0, 30)))
        pos = max(end + 1 + gap, pos + 1)


def _genbank_record(name: str, seq: bytes, features: List[str]) -> str:
    lines = [f"LOCUS       {name:<16} {len(seq):>11} bp    DNA     linear"
             f"   UNK 01-JAN-1980",
             f"DEFINITION  synthetic scaffold {name}.",
             f"ACCESSION   {name}",
             f"VERSION     {name}",
             "FEATURES             Location/Qualifiers",
             f"     source          1..{len(seq)}",
             '                     /mol_type="genomic DNA"']
    lines += features
    lines.append("ORIGIN")
    low = seq.decode().lower()
    for i in range(0, len(low), 60):
        groups = " ".join(low[j:j + 10] for j in range(i, min(i + 60,
                                                              len(low)), 10))
        lines.append(f"{i + 1:>9} {groups}")
    lines.append("//")
    return "\n".join(lines) + "\n"


def synth_genes(fasta: str, seed: int = 0) -> Tuple[str, str]:
    """Write <stem>.genes.fna (prodigal-style) and <stem>.genes.gb
    (GenBank) beside a synth FASTA; returns their paths. Every scaffold
    but the last gets genes from _gene_layout: both strands (the .fna
    holds a minus-strand gene's reverse complement, as prodigal writes
    it), overlapping genes, intergenic gaps, and on the first scaffold a
    last gene running past the scaffold's end (its header says
    partial=01; its sequence is padded with N). One more gene lies on
    scaffold 'scaf_absent', which the FASTA does not hold. The GenBank
    file has the same genes as CDS features: complement(...) for the
    minus strand, a '<' start on each record's first gene and a '>' end
    on the gene past the end, and the third gene of the first scaffold
    as a join(...) of two spans, written over two lines."""
    from .io.fasta import read_fasta
    rng = np.random.default_rng(seed)
    seqs = {n: s.tobytes() for n, s in read_fasta(fasta).items()}
    names = list(seqs)
    stem = os.path.splitext(fasta)[0]
    fna, gb = stem + ".genes.fna", stem + ".genes.gb"
    absent = BASES[rng.integers(0, 4, 300)].tobytes()
    layouts = {n: _gene_layout(rng, len(seqs[n]), past_end=(i == 0))
               for i, n in enumerate(names[:-1])}
    layouts["scaf_absent"] = [(0, 299, "1")]
    seqs["scaf_absent"] = absent
    records = []
    with open(fna, "w") as f:
        for si, (name, genes) in enumerate(layouts.items()):
            seq = seqs[name]
            features = []
            for k, (a, b, strand) in enumerate(genes, start=1):
                gene = f"{name}_{k}"
                body = seq[a:b + 1].ljust(b - a + 1, b"N")
                if strand == "-1":
                    body = body.translate(_GENE_COMP)[::-1]
                partial = "01" if b >= len(seq) else "00"
                f.write(f">{gene} # {a + 1} # {b + 1} # {strand} # "
                        f"ID={si + 1}_{k};partial={partial};start_type=ATG;"
                        f"rbs_motif=None;rbs_spacer=None;gc_cont=0.500\n")
                for i in range(0, len(body), 60):
                    f.write(body[i:i + 60].decode() + "\n")
                lo = ("<" if k == 1 else "") + str(a + 1)
                hi = (">" if b >= len(seq) else "") + str(b + 1)
                if si == 0 and k == 3:
                    cut = a + (b - a) // 3
                    loc = (f"join({lo}..{cut},\n{' ' * 21}"
                           f"{cut + 31}..{hi})")
                else:
                    loc = f"{lo}..{hi}"
                if strand == "-1":
                    loc = f"complement({loc})"
                features += [f"     CDS             {loc}",
                             f'                     /gene="{gene}"',
                             f'                     /locus_tag="{gene}"']
            records.append(_genbank_record(name, seq, features))
    with open(gb, "w") as f:
        f.write("".join(records))
    return fna, gb


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
