"""A toy check (benchmark/checks/<name>.py) for the benchmark's tests: the
gene rows of gene_info and their lengths against the genes file that was
written, on the scaffolds the base reference profiles. DROP leaves that
many genes out of the reference, so that the check must fail."""

import os

import pandas as pd

DROP = 0
LIMITS = {"toy_gene_rows_mismatched": 0, "toy_gene_lengths_mismatched": 0}


def read(outdir):
    base = os.path.join(outdir, "output", os.path.basename(outdir))
    db = pd.read_csv(base + "_gene_info.tsv", sep="\t")
    return dict(zip(db["gene"], db["gene_length"]))


def reference(cfg, seed, layout, paths, base, precision):
    profiled = set(base["scaffold_info"].index)
    genes = {}
    with open(paths["toy_genes"]) as f:
        for line in f:
            if line.startswith(">"):
                name, start, end = (p.strip() for p in
                                    line[1:].split("#")[:3])
                if name.rsplit("_", 1)[0] in profiled:
                    genes[name] = int(end) - int(start) + 1
    return dict(sorted(genes.items())[DROP:])


def judge(prog, ref):
    both = set(prog) & set(ref)
    return {"toy_gene_rows_mismatched": len(set(prog) ^ set(ref)),
            "toy_gene_lengths_mismatched": sum(prog[g] != ref[g]
                                               for g in both)}
