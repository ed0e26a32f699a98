"""
Re-cluster an existing `compare` output with new thresholds — the
counterpart of auxiliary_scripts/recluster_compare.py (reference:
auxiliary_scripts/recluster_instrain_compare.py), over this package's
compare/clustering.py. Host only.

    python -m instrain_tpu_torch.auxiliary_scripts.recluster_compare \\
        -i COMPARE_DIR -a ANI_THRESHOLD [-cov COVERAGE_THRESHOLD] \\
        [--clusterAlg average] [-o OUT.tsv]
"""

import argparse
import os
import sys


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m instrain_tpu_torch.auxiliary_scripts."
             "recluster_compare")
    p.add_argument("-i", "--input", required=True,
                   help="compare output directory (RC profile)")
    p.add_argument("-a", "--ani_threshold", type=float, default=0.99999)
    p.add_argument("-cov", "--coverage_treshold", type=float, default=0.1)
    p.add_argument("--clusterAlg", default="average")
    p.add_argument("-o", "--output", default=None)
    args = p.parse_args(argv)

    import pandas as pd

    from ..compare.clustering import cluster_genome_strains
    from ..config import CompareConfig
    from ..store.profile_dir import ProfileDir

    rc = ProfileDir(args.input)
    base = rc.get_output_base()
    gw = base + "genomeWide_compare.tsv"
    if not os.path.exists(gw):
        sys.exit(f"{gw} not found; run compare with an .stb first")
    mdb = pd.read_csv(gw, sep="\t")

    cfg = CompareConfig(ani_threshold=args.ani_threshold,
                        coverage_treshold=args.coverage_treshold,
                        clusterAlg=args.clusterAlg)
    cdb = cluster_genome_strains(
        mdb.sort_values(["genome", "name1", "name2"]), cfg)
    out = args.output or (base + "strain_clusters_reclustered.tsv")
    cdb.to_csv(out, index=False, sep="\t")
    print(f"Wrote {len(cdb)} cluster assignments to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
