"""
Rarefaction curve: profile a BAM at decreasing read depths and report how
key metrics respond — the counterpart of
auxiliary_scripts/rarefaction_curve.py (reference:
auxiliary_scripts/rarefaction_curve.py, which subsamples with
sambamba/samtools; here subsampling is the decoder's deterministic
template-level subsample, --maximum_reads). Each fraction is a full
`profile` through this package, its kernels on --device (cuda by
default).

    python -m instrain_tpu_torch.auxiliary_scripts.rarefaction_curve \\
        BAM FASTA -o OUTDIR [-s 0.1 0.25 0.5 1.0] [--device cuda]

Writes OUTDIR/subset_<fraction>.IS per fraction and
OUTDIR/rarefaction_curve.tsv (fraction, mean_coverage, mean_breadth,
divergent_sites), and prints each row as JSON.
"""

import argparse
import json
import os
import sys


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m instrain_tpu_torch.auxiliary_scripts."
             "rarefaction_curve")
    p.add_argument("bam")
    p.add_argument("fasta")
    p.add_argument("-o", "--output", default="rarefaction_out")
    p.add_argument("-s", "--subsets", nargs="*", type=float,
                   default=[0.1, 0.25, 0.5, 0.75, 1.0])
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the profile kernels run")
    args = p.parse_args(argv)

    import pandas as pd

    from ..config import ProfileConfig
    from ..io.bam import decode_bam
    from ..profile.pipeline import profile
    from ..store import generate as gen
    from ..store.profile_dir import ProfileDir

    n_records = decode_bam(args.bam, baq=False,
                           tweak_overlaps=False).n_records
    os.makedirs(args.output, exist_ok=True)
    rows = []
    for frac in sorted(args.subsets):
        out = os.path.join(args.output, f"subset_{frac}.IS")
        cfg = ProfileConfig(output=out, skip_plot_generation=True,
                            seed=args.seed, device=args.device)
        cfg.filter.maximum_reads = max(int(n_records * frac), 1) \
            if frac < 1 else None
        profile(args.bam, args.fasta, cfg)
        db = gen.nonredundant_scaffold_table(ProfileDir(out))
        rows.append({
            "fraction": frac,
            "mean_coverage": float(db["coverage"].mean()),
            "mean_breadth": float(db["breadth"].mean()),
            "divergent_sites": int(db["divergent_site_count"].sum()),
        })
        print(json.dumps(rows[-1]))
    pd.DataFrame(rows).to_csv(
        os.path.join(args.output, "rarefaction_curve.tsv"), sep="\t",
        index=False)
    return 0


if __name__ == "__main__":
    sys.exit(main())
