"""A toy input writer (benchmark/inputs/<name>.py) for the benchmark's
tests: two prodigal-style genes of 300 bp on every scaffold, one on each
strand (a minus-strand gene's sequence reverse-complemented, as prodigal
writes it)."""

import os

from benchmark.gen import reads as gen

COMP = bytes.maketrans(b"ACGT", b"TGCA")


def write(cfg, seed, layout, workdir):
    path = os.path.join(workdir, "toy.genes.fna")
    with open(path, "w") as f:
        for s, name in enumerate(layout.names):
            ref = gen.scaffold_fragments(cfg, layout, s, seed)[1]["ref"]
            L = len(ref)
            for k, (a, b, strand) in enumerate(
                    [(100, 399, "1"), (L - 700, L - 401, "-1")], start=1):
                body = ref[a:b + 1].tobytes()
                if strand == "-1":
                    body = body.translate(COMP)[::-1]
                f.write(f">{name}_{k} # {a + 1} # {b + 1} # {strand} # "
                        f"ID={s + 1}_{k};partial=00\n{body.decode()}\n")
    return path
