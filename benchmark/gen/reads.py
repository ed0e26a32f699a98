"""
The benchmark's input generator: a database of random scaffolds (the
"weights" of this system are data) and one sample's read pairs mapped to
it, written as a FASTA, a coordinate-sorted BGZF BAM with its .bai, and,
for a database of several genomes, a scaffold-to-genome (.stb) file.

Everything is drawn from the seed and the configuration's parameters
(benchmark/configs/<name>.json); the program under test receives only the
files. The same draws come back from `scaffold_reads`, which the plain
reference (benchmark/ref/) calls to count what the program should find.

Read model (widened from the port's own synthetic generator, whose record
layout it keeps):
  - scaffold lengths: the configuration's lengths, or quantiles of a
    log-normal distribution, clipped; genomes get lengths dealt in a snake
    order, so each genome holds about the same total length;
  - coverage: one value per genome, quantiles of a log-uniform range;
  - every seed has the same scaffolds (length, genome coverage and pairs)
    and the same number of pairs: the seed shuffles the order of the
    genomes and of each genome's scaffolds and draws the sequences and
    reads, so it changes the data and not the amount of work;
  - pairs: a normal insert, clipped; mate 1 forward at the fragment start,
    mate 2 reverse at its end; every pair is a proper pair;
  - SNVs at a rate per kb, each with its alternative allele frequency
    drawn uniformly; a fragment carries each SNV it spans independently
    with that frequency, and both mates of a fragment agree;
  - substitution errors per base, drawn per read (so overlapping mates can
    disagree); base qualities all `base_quality`;
  - a share of the pairs comes from a relative genome at the configured
    ANI to the scaffold (the read-ANI filter should drop them); NM counts
    mismatches against the scaffold, as a mapper reports it.
"""

from __future__ import annotations

import os
import statistics
import struct
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from . import bam as bamw

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
_CODE = np.full(256, 255, dtype=np.uint8)       # ASCII -> index in ACGT
_CODE[ACGT] = np.arange(4, dtype=np.uint8)


def seed_words(seed: int) -> int:
    """The seed as a non-negative integer for numpy's SeedSequence (any
    whole number is accepted, negative ones too)."""
    return int(seed) % (1 << 64)


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """The generator of one stream of draws: 0 the layout, 1 + s the
    sequence and reads of scaffold s."""
    return np.random.default_rng([seed_words(seed), stream])


@dataclass
class Layout:
    names: List[str]
    genomes: List[str]          # per scaffold
    lengths: np.ndarray         # int64 per scaffold
    coverage: np.ndarray        # float per scaffold (its genome's mean)
    pairs: np.ndarray           # int64 read pairs per scaffold, all sources
    relative: np.ndarray        # int64 of them from the relative genome

    @property
    def total_pairs(self) -> int:
        return int(self.pairs.sum())


def layout(cfg: dict, seed: int) -> Layout:
    """Scaffold names, lengths, genomes and pair counts of one seed."""
    rng = rng_for(seed, 0)
    G, per = int(cfg["genomes"]), int(cfg["scaffolds_per_genome"])
    n = G * per
    sl = cfg["scaffold_length"]
    if "fixed" in sl:
        lengths = np.full(n, int(sl["fixed"]), dtype=np.int64)
    else:
        nd = statistics.NormalDist()
        q = [nd.inv_cdf((i + 0.5) / n) for i in range(n)]
        lengths = np.clip(np.rint(sl["median"] * np.exp(sl["sigma"] *
                                                         np.array(q))),
                          sl["min"], sl["max"]).astype(np.int64)
    # deal the lengths, longest first, to genomes in a snake order; genome
    # g keeps its lengths and its coverage for every seed, so each seed
    # has the same (length, coverage) pairs, in an order of its own
    desc = np.sort(lengths)[::-1]
    dealt: List[List[int]] = [[] for _ in range(G)]
    for i, L in enumerate(desc):
        k, r = divmod(i, G)
        dealt[r if k % 2 == 0 else G - 1 - r].append(int(L))
    cv = cfg["coverage"]
    covs = cv["min"] * (cv["max"] / cv["min"]) ** ((np.arange(G) + 0.5) / G)
    # which genome has which coverage: one fixed shuffle, the same for
    # every seed, so that length and coverage are not ranked alike
    covs = covs[np.random.default_rng(0).permutation(G)]
    R = int(cfg["read_length"])
    share = float(cfg["relative"]["share"])
    gl = sum(map(sum, dealt)) / G
    names, genomes, out_len, pair_l = [], [], [], []
    for gi, g in enumerate(rng.permutation(G)):
        lens = np.array(dealt[g], dtype=np.int64)
        # each genome's pairs follow from its coverage at the mean genome
        # length, so every seed has the same total; its scaffolds share
        # them in proportion to length (largest remainders)
        want = int(round(covs[g] * gl / (2 * R)))
        part = lens / lens.sum() * want
        base = np.floor(part).astype(np.int64)
        extra = np.argsort(-(part - base), kind="stable")[:want - base.sum()]
        base[extra] += 1
        for j, k in enumerate(rng.permutation(len(lens))):
            names.append(f"g{gi}_s{j}")
            genomes.append(f"genome_{gi}")
            out_len.append(int(lens[k]))
            pair_l.append(int(base[k]))
    out_len = np.array(out_len, dtype=np.int64)
    pairs = np.array(pair_l, dtype=np.int64)
    out_cov = pairs * 2 * R / out_len
    rel = np.rint(pairs * share).astype(np.int64)
    return Layout(names, genomes, out_len, out_cov, pairs, rel)


def scaffold_fragments(cfg: dict, lay: Layout, s: int, seed: int):
    """The first draws of scaffold s: its sequence, SNVs, relative and
    fragments (pairs numbered by fragment start). Returns (rng, dict),
    rng positioned for scaffold_reads' further draws."""
    rng = rng_for(seed, 1 + s)
    L, n, n_rel = int(lay.lengths[s]), int(lay.pairs[s]), int(lay.relative[s])
    R = int(cfg["read_length"])
    ref = ACGT[rng.integers(0, 4, L)]
    n_snv = max(int(round(cfg["snv_per_kb"] * L / 1000)), 0)
    snv_pos = np.sort(rng.choice(L, n_snv, replace=False))
    snv_alt = ACGT[(_CODE[ref[snv_pos]] + rng.integers(1, 4, n_snv)) % 4]
    fr = cfg["snv_alt_freq"]
    snv_freq = rng.uniform(fr["min"], fr["max"], n_snv)
    relseq = ref.copy()
    k = int(round(L * (1.0 - cfg["relative"]["ani"])))
    rp = rng.choice(L, k, replace=False)
    relseq[rp] = ACGT[(_CODE[ref[rp]] + rng.integers(1, 4, k)) % 4]

    ins = cfg["insert"]
    insert = np.clip(np.rint(rng.normal(ins["mean"], ins["sd"], n)),
                     ins["min"], min(ins["max"], L)).astype(np.int64)
    start = (rng.random(n) * (L - insert + 1)).astype(np.int64)
    rel = np.zeros(n, dtype=bool)
    rel[rng.choice(n, n_rel, replace=False)] = True
    order = np.argsort(start, kind="stable")
    return rng, dict(ref=ref, snv_pos=snv_pos, snv_alt=snv_alt,
                     snv_freq=snv_freq, relseq=relseq, insert=insert[order],
                     start=start[order], rel=rel[order])


def scaffold_reads(cfg: dict, lay: Layout, s: int, seed: int) -> Dict:
    """The sequence of scaffold s and its read pairs, in record
    (coordinate) order:
      ref [L] uint8 ASCII; pos [2n] int64 read starts; bases [2n, R]
      uint8 ASCII; nm [2n] int32; pair [2n] int64 (pair index, pairs
      numbered by fragment start); first [2n] bool (mate 1); insert [n]
      int64 and rel [n] bool per pair."""
    rng, fr = scaffold_fragments(cfg, lay, s, seed)
    ref, snv_pos, snv_alt, snv_freq, relseq, insert, start, rel = (
        fr[k] for k in ("ref", "snv_pos", "snv_alt", "snv_freq", "relseq",
                        "insert", "start", "rel"))
    n, R = len(insert), int(cfg["read_length"])

    # reads in generation order: mate 1 then mate 2 of each pair
    pos = np.empty(2 * n, dtype=np.int64)
    pos[0::2] = start
    pos[1::2] = start + insert - R
    win = pos[:, None] + np.arange(R)
    bases = ref[win]
    rr = np.repeat(rel, 2)
    bases[rr] = relseq[win[rr]]

    # SNVs a fragment spans, carried with their frequency by both mates
    lo = np.searchsorted(snv_pos, start)
    hi = np.searchsorted(snv_pos, start + insert)
    cnt = hi - lo
    pi = np.repeat(np.arange(n), cnt)
    si = lo[pi] + (np.arange(len(pi)) - np.repeat(np.cumsum(cnt) - cnt, cnt))
    carried = (rng.random(len(pi)) < snv_freq[si]) & ~rel[pi]
    pi, si = pi[carried], si[carried]
    P = snv_pos[si]
    for mate in (0, 1):
        r = 2 * pi + mate
        off = P - pos[r]
        inside = (off >= 0) & (off < R)
        bases[r[inside], off[inside]] = snv_alt[si[inside]]

    # substitution errors, per read
    n_err = rng.binomial(R, cfg["substitution_rate"], 2 * n)
    er = np.repeat(np.arange(2 * n), n_err)
    eo = rng.integers(0, R, len(er))
    shift = rng.integers(1, 4, len(er))
    bases[er, eo] = ACGT[(_CODE[bases[er, eo]] + shift) % 4]
    nm = (bases != ref[win]).sum(axis=1).astype(np.int32)

    rec = np.argsort(pos, kind="stable")
    pair = np.arange(2 * n, dtype=np.int64) // 2
    first = np.arange(2 * n) % 2 == 0
    return dict(ref=ref, pos=pos[rec], bases=bases[rec], nm=nm[rec],
                pair=pair[rec], first=first[rec], insert=insert, rel=rel)


# the fixed part of a BAM record: block_size and the 32-byte core
_HDR = np.dtype([("block_size", "<i4"), ("ref_id", "<i4"), ("pos", "<i4"),
                 ("l_read_name", "u1"), ("mapq", "u1"), ("bin", "<u2"),
                 ("n_cigar_op", "<u2"), ("flag", "<u2"), ("l_seq", "<i4"),
                 ("next_ref_id", "<i4"), ("next_pos", "<i4"),
                 ("tlen", "<i4")])


def records(cfg: dict, s: int, reads: Dict, qid0: int) -> bytes:
    """BAM records of scaffold s's reads, in their order; pair k is named
    r<qid0 + k>. Cigar <R>M, NM:i tag, every base at base_quality."""
    R = int(cfg["read_length"])
    pos, first, pair = reads["pos"], reads["first"], reads["pair"]
    ins = reads["insert"][pair]
    n = len(pos)
    mate = np.where(first, pos + ins - R, pos - ins + R)
    q = qid0 + pair
    digits = np.ones(n, dtype=np.int64)
    p10 = 10
    while (q >= p10).any():
        digits += q >= p10
        p10 *= 10
    l_name = digits + 2                     # "r", the digits, "\0"
    tail = 4 + (R + 1) // 2 + R + 7         # cigar, seq, qual, NM:i

    hdr = np.zeros(n, dtype=_HDR)
    hdr["block_size"] = _HDR.itemsize - 4 + l_name + tail
    hdr["ref_id"] = hdr["next_ref_id"] = s
    hdr["pos"], hdr["next_pos"] = pos, mate
    hdr["l_read_name"], hdr["mapq"] = l_name, int(cfg["mapq"])
    hdr["bin"], hdr["n_cigar_op"] = 4680, 1
    hdr["flag"] = np.where(first, 99, 147)
    hdr["l_seq"] = R
    hdr["tlen"] = np.where(first, ins, -ins)

    fixed = np.frombuffer(struct.pack("<I", (R << 4) | 0), np.uint8)
    qual_nm = np.frombuffer(bytes([int(cfg["base_quality"])]) * R + b"NMi",
                            np.uint8)
    out = []
    block = 1 << 15
    for i in range(0, n, block):
        idx = np.arange(i, min(i + block, n))
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
        nibs = bamw.CHAR2NIB[reads["bases"][idx]]
        if R % 2:
            nibs = np.concatenate([nibs, np.zeros((b, 1), np.uint8)], axis=1)
        t = rows[:, _HDR.itemsize + w:]
        t[:, :4] = fixed
        t[:, 4:4 + (R + 1) // 2] = (nibs[:, 0::2] << 4) | nibs[:, 1::2]
        t[:, 4 + (R + 1) // 2:-4] = qual_nm
        t[:, -4:] = reads["nm"][idx].astype("<i4").view(np.uint8).reshape(
            b, 4)
        keep = np.ones(rows.shape, dtype=bool)
        keep[:, _HDR.itemsize:_HDR.itemsize + w] = (
            np.arange(w)[None, :] < (d + 2)[:, None])
        out.append(rows[keep])
    return np.concatenate(out).tobytes() if out else b""


def write_inputs(cfg: dict, seed: int, workdir: str,
                 threads: int = 8) -> Dict:
    """Write <workdir>/sample.fasta, sample.bam, sample.bam.bai and, for a
    configuration with `stb`, sample.stb. Returns their paths (stb None
    where there is none), the layout and the number of read pairs."""
    os.makedirs(workdir, exist_ok=True)
    lay = layout(cfg, seed)
    fasta = os.path.join(workdir, "sample.fasta")
    bam = os.path.join(workdir, "sample.bam")
    payload = [bamw.header(list(zip(lay.names, lay.lengths.tolist())))]
    u = len(payload[0])
    spans = []
    qid = 0
    with open(fasta, "wb") as f:
        for s, name in enumerate(lay.names):
            reads = scaffold_reads(cfg, lay, s, seed)
            f.write(b">" + name.encode() + b"\n" + reads["ref"].tobytes() +
                    b"\n")
            body = records(cfg, s, reads, qid)
            qid += int(lay.pairs[s])
            spans.append((u, u + len(body)) if body else (-1, -1))
            payload.append(body)
            u += len(body)
            del reads
    offs = bamw.write_bgzf(bam, b"".join(payload), threads)
    bamw.write_bai(bam + ".bai", offs, spans)
    stb: Optional[str] = None
    if cfg.get("stb"):
        stb = os.path.join(workdir, "sample.stb")
        with open(stb, "w") as f:
            for name, g in zip(lay.names, lay.genomes):
                f.write(f"{name}\t{g}\n")
    return dict(fasta=fasta, bam=bam, stb=stb, layout=lay,
                pairs=lay.total_pairs)
