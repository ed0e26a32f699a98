"""
The genes file of a sample (benchmark/inputs/<name>.py): what Prodigal
writes with `prodigal -p meta -i genomes.fasta -d genes.fna` over the
configuration's database, the file inStrain's genome-database workflow
hands to `inStrain profile -g` (inStrain v1.9.1 docs: tutorial.rst and
user_manual.rst, `-g`, "Path to prodigal .fna genes file").

Taken from the sources:
  - Prodigal (Hyatt et al. 2010, BMC Bioinformatics 11:119): the header
    `>scaffold_k # start # end # strand # ID=i_k;partial=..;...`, 1-based
    inclusive coordinates, strand 1 or -1, genes numbered k = 1, 2, ...
    along each scaffold, a minus-strand gene's sequence reverse-
    complemented, sequence lines of 70 bases; a closed gene of at least
    90 bp (Prodigal's MIN_GENE) and a gene cut by a scaffold end of at
    least 60 bp (MIN_EDGE_GENE), whole codons, flagged partial=10 (cut at
    the left end), 01 (the right) or 11 (both);
  - the gene model of E. coli K-12 MG1655 (Blattner et al. 1997, Science
    277:1453): 4,288 protein-coding genes in 4.64 Mb, 87.8 % coding, a
    mean ORF of 951 bp.

The configuration's `genes` group (benchmark/configs/
metagenome_genes.json), which this writer reads, holds the two minimum
lengths above and these figures, assumed, not taken from the sources:
  - gene lengths: 3 x codons, codons gamma-distributed with shape 2.5 and
    mean 317, clipped to 30-3,000 codons (90 bp to 9 kb);
  - the space between genes: with probability 0.2 an overlap of 1-4 bp
    (a stop/start overlap), else a gap drawn uniformly from 0-325 bp, so
    the spacing averages about 130 bp and about 88 % of a scaffold is
    coding;
  - strands: runs of co-directed genes; the strand turns at a gene with
    probability 0.3;
Assumed, and fixed here:
  - the first gene starts up to one gene and gap before the scaffold, so
    that scaffold ends cut genes as an assembly's contig ends do;
  - sequences are the scaffold's own bases (the generator's random
    sequence): no start or stop codon is planted, so a gene holds internal
    stop codons, which inStrain's site count skips;
  - start_type ATG (Edge where the start is cut), rbs_motif None,
    gc_cont of the gene's sequence.
Every draw comes from the seed, on streams of their own; the same seed
writes the same file.
"""

from __future__ import annotations

import os

import numpy as np

from benchmark.gen import reads as gen

GENE_STREAM = 0x67656E65     # "gene": the genes' own draws, per scaffold
LINE = 70
COMP = bytes.maketrans(b"ACGT", b"TGCA")


def gene_rng(seed: int, s: int) -> np.random.Generator:
    return np.random.default_rng([gen.seed_words(seed), 1 + s, GENE_STREAM])


def scaffold_genes(L: int, rng: np.random.Generator, model: dict):
    """The genes of a scaffold of L bases under the configuration's gene
    model: a list of (start, end, strand, partial), 0-based inclusive, in
    order of start."""
    cod, over, gap_max = model["codons"], model["overlap"], model["gap_max"]

    def codons() -> int:
        c = rng.gamma(cod["shape"], cod["mean"] / cod["shape"])
        return int(np.clip(np.rint(c), cod["min"], cod["max"]))

    def space() -> int:
        if rng.random() < over["p"]:
            return -int(rng.integers(1, over["max"] + 1))
        return int(rng.integers(0, gap_max + 1))

    out = []
    length = 3 * codons()
    x = -int(rng.integers(0, length + gap_max + 1))
    strand = 1 if rng.random() < 0.5 else -1
    while x < L:
        a, b = x, x + length - 1
        if b >= 0:
            left, right = a < 0, b > L - 1
            # a cut gene keeps whole codons, in its own frame, inside the
            # scaffold
            if left:
                a %= 3
            if right:
                b -= (b - (L - 1) + 2) // 3 * 3
            if b - a + 1 >= model["min_edge_gene" if left or right
                                  else "min_gene"]:
                out.append((a, b, strand,
                            f"{int(left)}{int(right)}"))
        x = x + length + space()
        length = 3 * codons()
        if rng.random() < model["turn_p"]:
            strand = -strand
    return out


def write(cfg, seed, layout, workdir):
    path = os.path.join(workdir, "genes.fna")
    with open(path, "w") as f:
        for s, name in enumerate(layout.names):
            ref = gen.scaffold_fragments(cfg, layout, s, seed)[1]["ref"]
            genes = scaffold_genes(len(ref), gene_rng(seed, s), cfg["genes"])
            for k, (a, b, strand, partial) in enumerate(genes, start=1):
                body = ref[a:b + 1].tobytes()
                if strand == -1:
                    body = body.translate(COMP)[::-1]
                cut = partial[0] if strand == 1 else partial[1]
                gc = (body.count(b"G") + body.count(b"C")) / len(body)
                f.write(f">{name}_{k} # {a + 1} # {b + 1} # {strand} # "
                        f"ID={s + 1}_{k};partial={partial};start_type="
                        f"{'Edge' if cut == '1' else 'ATG'};rbs_motif=None;"
                        f"rbs_spacer=None;gc_cont={gc:.3f}\n")
                seq = body.decode()
                f.write("".join(seq[i:i + LINE] + "\n"
                                for i in range(0, len(seq), LINE)))
    return path
