"""
The 10 numbered plots (reference: inStrain/plotting/*.py; output names and
content match the reference's figures/ PDFs) — the counterpart of
instrain_tpu/plotting/plots.py. Each reads a stored profile (or compare)
directory on the host: no tensor, no device. With SOURCE_DATE_EPOCH set,
matplotlib writes the same PDF bytes as the JAX package's for the same
tables.
"""

from __future__ import annotations

import logging
from typing import Optional

import matplotlib
matplotlib.use("Agg")
# TrueType (Type-42) fonts so figure text stays editable, matching every
# reference plotting module (e.g. plotting/positional_plots.py:10,
# mapping_plots.py:13, SNV_plots.py:12).
matplotlib.rcParams["pdf.fonttype"] = 42
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pandas as pd  # noqa: E402

from ..store import generate as gen  # noqa: E402
from ..store.profile_dir import ProfileDir  # noqa: E402


def _figpath(isdir: ProfileDir, name: str) -> str:
    base = (isdir.get_location("figures") +
            str(isdir.get("location")).split("/")[-1])
    return f"{base}_{name}"


def _genome_of(isdir):
    s2b = isdir.get("scaffold2bin")
    if s2b is None:
        s2l = isdir.get("scaffold2length")
        s2b = {s: "all_scaffolds" for s in s2l}
    return s2b


def _allowed_genomes(isdir: ProfileDir, **kwargs) -> Optional[set]:
    """Genomes passing the plot filters, or None for "all" (reference:
    plotting/utilities.py:9-39 plot_genome, evaluated per genome page)."""
    genomes = kwargs.get("genomes")
    if genomes is not None:
        return set(genomes)
    allowed = _allowed_scaffolds(isdir, **kwargs)
    if allowed is None:
        return None
    s2b = _genome_of(isdir)
    return {b for s, b in s2b.items() if s in allowed}


def _allowed_scaffolds(isdir: ProfileDir, **kwargs) -> Optional[set]:
    """Scaffolds whose genome passes the plot filters, or None for "all"
    (reference: plotting/utilities.py:9-39 plot_genome — an explicit
    --genomes list wins; otherwise genomes below --minimum_breadth at the
    highest mm are skipped)."""
    if "_allowed" in kwargs:  # precomputed once by the controller
        return kwargs["_allowed"]
    s2b = _genome_of(isdir)
    genomes = kwargs.get("genomes")
    if genomes is not None:
        # an explicit list wins, even an empty one (reference
        # plotting/utilities.py:18-23 treats [] as "no genome passes")
        keep = set(genomes)
        return {s for s, b in s2b.items() if b in keep}
    mb = float(kwargs.get("minimum_breadth", 0) or 0)
    if mb <= 0:
        return None
    gdb = isdir.get("genome_level_info")
    if gdb is None or len(gdb) == 0:
        # roll up length-weighted breadth from the scaffold table
        # (reference computes genomeWideFromIS on the fly)
        db = isdir.get("cumulative_scaffold_table")
        if db is None or len(db) == 0:
            return None
        db = db.sort_values("mm").drop_duplicates(
            subset="scaffold", keep="last").copy()
        db["genome"] = db["scaffold"].map(s2b)
        g = db.groupby("genome").apply(
            lambda d: (d["breadth"] * d["length"]).sum() /
            d["length"].sum(), include_groups=False)
        b2b = g.to_dict()
    else:
        if "mm" in gdb.columns:
            gdb = gdb.sort_values("mm").drop_duplicates(subset="genome",
                                                        keep="last")
        b2b = dict(zip(gdb["genome"], gdb["breadth"]))
    keep = {g for g, b in b2b.items() if float(b) >= mb}
    return {s for s, b in s2b.items() if b in keep}


# 1 ---------------------------------------------------------------------

def plot_coverage_breadth_vs_mm(isdir: ProfileDir, **kwargs):
    """Breadth vs read-pair ANI level, one page per genome (reference:
    mapping_plots.py:25-67 mm_plot_from_IS + the live line of mm_plot at
    :143 — a single blue breadth-vs-ANI_level line per genome page; the
    rest of mm_plot is commented out upstream)."""
    db = isdir.get("cumulative_scaffold_table")
    if db is None or len(db) == 0 or "mm" not in db.columns:
        raise ValueError(
            "Plot 1 cannot be created when run with --database_mode or "
            "--skip_mm_profiling")
    # NOTE: no nunique()<=1 gate here — the reference applies that check
    # only to plot 3 (mapping_plots.py:105-107); a single-mm run renders
    # a flat line upstream and does here too
    s2b = _genome_of(isdir)
    db = db.copy()
    db["genome"] = db["scaffold"].map(s2b)
    read_len = int(isdir.get_read_length())
    allowed_g = _allowed_genomes(isdir, **kwargs)
    figs = []
    for genome, gdb in db.groupby("genome"):
        if allowed_g is not None and genome not in allowed_g:
            continue
        # genome-wide per-mm rollup (reference mm_genome_info: length-
        # weighted means, genomeUtilities.py _genome_wide_si_2)
        agg = gdb.groupby("mm").apply(
            lambda d: pd.Series({
                "breadth": (d["breadth"] * d["length"]).sum() /
                d["length"].sum(),
                "coverage": (d["coverage"] * d["length"]).sum() /
                d["length"].sum()}), include_groups=False).reset_index()
        agg["ANI_level"] = (read_len - agg["mm"].astype(int)) / read_len
        agg = agg.sort_values("ANI_level")
        # the full two-axis layout of the shipped golden figures
        # (mapping_plots.py:148-166 — blue breadth + dashed expected
        # breadth, red coverage twin axis, x = minimum read ANI)
        from ..profile.tables import estimate_breadth as _eb
        fig, ax1 = plt.subplots()
        ax1.plot(agg["ANI_level"], agg["breadth"], ls="-", color="blue")
        ax1.plot(agg["ANI_level"], _eb(agg["coverage"].values), ls="--",
                 color="lightblue")
        ax1.set_ylabel("breadth", color="blue")
        ax1.set_xlabel("Minimum read ANI level")
        ax1.set_ylim(0, 1)
        ax2 = ax1.twinx()
        ax2.plot(agg["ANI_level"], agg["coverage"], ls="-", color="red")
        ax2.set_ylabel("coverage", color="red")
        ax2.set_ylim(0,)
        ax1.set_xlim(1, max(0.9, float(agg["ANI_level"].min())))
        plt.title(str(genome))
        fig.set_size_inches(6, 4)
        figs.append(fig)
    _save_pages(figs, _figpath(isdir,
                               "CoverageAndBreadth_vs_readMismatch.pdf"))


# 2 ---------------------------------------------------------------------

_METRIC_ORDER = ["linkage", "snp_density", "coverage", "nucl_diversity"]


def _genome_pages(isdir: ProfileDir, **kwargs):
    """Yield (genome, Wdb, breaks, midpoints) per plottable genome
    (reference: positional_plots.py:21-68 — one PDF page per genome,
    windowed metrics over its scaffolds, longest first)."""
    from collections import defaultdict
    from .windowed import load_windowed_metrics
    s2b = _genome_of(isdir)
    b2s = defaultdict(list)
    for s, b in s2b.items():
        b2s[b].append(s)
    covT = isdir.get("covT")
    clonT = isdir.get("clonT")
    ldb = isdir.get("raw_linkage_table")
    sdb = isdir.get("cumulative_snv_table")
    s2l = isdir.get("scaffold2length")
    rl = isdir.get_read_length()
    allowed = _allowed_scaffolds(isdir, **kwargs)
    for genome, scaffolds in b2s.items():
        present = [s for s in scaffolds if s in s2l]
        if allowed is not None:
            present = [s for s in present if s in allowed]
        if not present:
            continue
        Wdb, breaks, midpoints = load_windowed_metrics(
            present, s2l, rl, covTs=covT, clonTs=clonT,
            raw_linkage_table=ldb, cumulative_snv_table=sdb)
        if len(Wdb) == 0 or Wdb["value"].notna().sum() == 0:
            continue
        yield genome, Wdb, breaks, midpoints


def _save_pages(figs, path):
    from matplotlib.backends.backend_pdf import PdfPages
    if not figs:
        raise ValueError("no genome had windowed metrics to plot")
    with PdfPages(path) as pp:
        for fig in figs:
            pp.savefig(fig)
            plt.close(fig)


def plot_genome_wide_microdiversity(isdir: ProfileDir, **kwargs):
    """Per-genome windowed linkage / SNV density / coverage / diversity,
    one page per genome, two read-ANI levels per panel
    (positional_plots.py:21-83, 140-183)."""
    figs = []
    for genome, Wdb, breaks, _mid in _genome_pages(isdir, **kwargs):
        present = [m for m in _METRIC_ORDER
                   if m in set(Wdb["metric"])]
        fig, axes = plt.subplots(len(present), 1, sharex=True,
                                 squeeze=False, figsize=(8, 5))
        colors = ["red", "blue", "black"]
        for i, metric in enumerate(present):
            ax = axes[i][0]
            wdb = Wdb[Wdb["metric"] == metric]
            for c, (ani, ddb) in enumerate(wdb.groupby("ANI")):
                ax.plot(ddb["midpoint"], ddb["value"],
                        c=colors[c % 3], label=ani, marker="o", ms=1)
            ax.set_title(str(metric))
            ax.grid(False)
            if i == 0:
                ax.legend(loc="upper left", title="Min read ANI (%)",
                          fontsize=7)
            for b in breaks:
                ax.axvline(b, ls="-", c="lightgrey", zorder=-1)
        axes[-1][0].set_xlabel("genome position")
        axes[-1][0].set_xlim(0, float(Wdb["midpoint"].max()))
        fig.suptitle(str(genome), y=0.999)
        fig.subplots_adjust(hspace=0.3)
        fig.tight_layout()
        figs.append(fig)
    _save_pages(figs, _figpath(isdir,
                               "genomeWide_microdiveristy_metrics.pdf"))


# 3 ---------------------------------------------------------------------

def plot_read_ani_distribution(isdir: ProfileDir, **kwargs):
    """Read pairs per exact-mm level as a line over ANI level, one page
    per genome, x inverted max->min ANI (reference: mapping_plots.py:
    102-135 ANI_dist_plot_from_IS, prepare_read_ani_dist_plot :169-215,
    read_ani_dist_plot :218-230). Per-mm coverage comes from the
    NON-cumulative covT; read_pairs = coverage*length/(2*read_len)."""
    covT = isdir.get("covT")
    s2l = isdir.get("scaffold2length")
    if not covT:
        raise ValueError("no covT (skip_mm_profiling?)")
    s2b = _genome_of(isdir)
    b2l = isdir.get("bin2length")
    if not isinstance(b2l, dict):
        from collections import defaultdict
        b2l = defaultdict(float)
        for s, b in s2b.items():
            b2l[b] += float(s2l.get(s, 0))
    read_len = int(isdir.get_read_length())
    rows = []
    for scaffold, mm2counts in covT.items():
        L = float(s2l[scaffold])
        for mm, counts in mm2counts.items():
            rows.append((s2b.get(scaffold), int(mm),
                         float(np.asarray(counts.values,
                                          dtype=np.float64).sum()) / L,
                         L))
    db = pd.DataFrame(rows, columns=["genome", "mm", "coverage", "length"])
    if db["mm"].nunique() <= 1:
        raise ValueError(
            "Plot 3 cannot be created when run with --database_mode or "
            "--skip_mm_profiling")
    allowed_g = _allowed_genomes(isdir, **kwargs)
    figs = []
    for genome, gdb in db.groupby("genome"):
        if allowed_g is not None and genome not in allowed_g:
            continue
        gl = float(b2l[genome])
        agg = gdb.groupby("mm").apply(
            lambda d: (d["coverage"] * d["length"]).sum() / gl,
            include_groups=False).rename("coverage").reset_index()
        agg["read_pairs"] = [int(c * gl / (read_len * 2))
                             for c in agg["coverage"]]
        agg["ANI_level"] = (read_len - agg["mm"]) / read_len
        fig = plt.figure()
        plt.plot(agg["ANI_level"], agg["read_pairs"])
        if agg["ANI_level"].max() != agg["ANI_level"].min():
            plt.gca().set_xlim(agg["ANI_level"].max(),
                               agg["ANI_level"].min())
        plt.xlabel("Read ANI level")
        # the ylabel string (typo included) matches the reference PDF
        # (mapping_plots.py:229)
        plt.ylabel("Numbner of read pairs (average length "
                   "{0}bp)".format(read_len))
        plt.title(str(genome))
        fig.set_size_inches(6, 4)
        fig.tight_layout()
        figs.append(fig)
    _save_pages(figs, _figpath(isdir, "readANI_distribution.pdf"))


# 4 ---------------------------------------------------------------------

def plot_allele_frequencies(isdir: ProfileDir, **kwargs):
    """Major allele frequency histogram, one page per genome (reference:
    SNV_plots.py:23-77 — major_allele_freq = max(var_freq, ref_freq),
    bins arange(0.5, 1, 0.01), xlim 0.5-1)."""
    db = isdir.get("cumulative_snv_table")
    if db is None or len(db) == 0:
        raise ValueError("no SNVs")
    db = db.sort_values("mm").drop_duplicates(
        subset=["scaffold", "position"], keep="last").sort_index()
    db = db[~db["cryptic"].astype(bool)]
    db = db[db["allele_count"] >= 2]
    s2b = _genome_of(isdir)
    db = db.copy()
    db["genome"] = db["scaffold"].map(s2b)
    allowed_g = _allowed_genomes(isdir, **kwargs)
    figs = []
    for genome, gdb in db.groupby("genome"):
        if allowed_g is not None and genome not in allowed_g:
            continue
        vf, rf = gdb["var_freq"].values, gdb["ref_freq"].values
        # python max(var, nan) returns var (SNV_plots.py:71), so a NaN
        # ref_freq falls back to var_freq rather than dropping the row
        maf = np.where(np.isnan(rf), vf, np.maximum(vf, rf))
        maf = maf[~np.isnan(maf)]
        fig = plt.figure()
        if len(maf):
            # seaborn histplot's binwidth=0.005 overrides its bins arg
            # (SNV_plots.py:72): 0.005-wide bins over the data range
            edges = np.arange(maf.min(), maf.max() + 0.005, 0.005)
            plt.hist(maf, bins=edges if len(edges) > 1 else 1)
        plt.xlim(0.5, 1)
        plt.title(str(genome))
        plt.xlabel("Major allele frequency")
        plt.ylabel("Number of SNPs")
        fig.set_size_inches(6, 4)
        fig.tight_layout()
        figs.append(fig)
    _save_pages(figs, _figpath(isdir, "MajorAllele_frequency_plot.pdf"))


# 5 ---------------------------------------------------------------------

_LD_COLS = ["r2", "r2_normalized", "d_prime", "d_prime_normalized"]


def _ld_window_means(db: pd.DataFrame, chunk_size: int = 5,
                     min_vals: Optional[int] = 5,
                     max_d: Optional[int] = None) -> pd.DataFrame:
    """Window the linkage table into [i*chunk, (i+1)*chunk) distance bins
    and mean each LD metric per bin; a bin's metric is NaN when fewer than
    min_vals non-NaN values land in it (reference: linkage_plots.py:
    106-130 linkage_decay_plot's chunking). `max_d` fixes the window grid
    (the reference shares one grid across a genome's link types)."""
    dist = db["distance"].astype(int).values
    if max_d is None:
        max_d = int(db["distance"].max())
    n_chunks = int(max_d) // chunk_size + 1
    idx = np.minimum(dist // chunk_size, n_chunks - 1)
    out = {"distance": [(i + 0.5) * chunk_size for i in range(n_chunks)]}
    for col in _LD_COLS:
        v = db[col].values.astype(float)
        ok = ~np.isnan(v)
        cnt = np.bincount(idx[ok], minlength=n_chunks)
        s = np.bincount(idx[ok], weights=v[ok], minlength=n_chunks)
        with np.errstate(invalid="ignore", divide="ignore"):
            mean = np.where(cnt > 0, s / np.maximum(cnt, 1), np.nan)
        if min_vals is not None:
            mean = np.where(cnt >= min_vals, mean, np.nan)
        out[col] = mean
    return pd.DataFrame(out)


def plot_linkage_decay(isdir: ProfileDir, **kwargs):
    """r2 / r2_normalized / d_prime / d_prime_normalized vs SNP distance
    in 5 bp windows (>=5 values per plotted window), one page per genome
    (reference: linkage_plots.py:23-58, 106-139)."""
    db = isdir.get("raw_linkage_table")
    if db is None or len(db) == 0:
        raise ValueError("no linkage")
    db = db.sort_values("mm").drop_duplicates(
        subset=["scaffold", "position_A", "position_B"],
        keep="last").sort_index()
    s2b = _genome_of(isdir)
    db = db.copy()
    db["genome"] = db["scaffold"].map(s2b)
    allowed_g = _allowed_genomes(isdir, **kwargs)
    figs = []
    for genome, gdb in db.groupby("genome"):
        if allowed_g is not None and genome not in allowed_g:
            continue
        w = _ld_window_means(gdb, chunk_size=5, min_vals=5)
        fig = plt.figure()
        for col in _LD_COLS:
            plt.plot(w["distance"], w[col], label=col, marker="o", ms=4)
        plt.title(str(genome))
        plt.xlabel("Distance between SNPs (bp)\nAveraged over 5bp "
                   "windows; plotting windows with at least 5 values")
        plt.ylabel("SNP linkage")
        plt.legend()
        fig.set_size_inches(6, 4)
        fig.tight_layout()
        figs.append(fig)
    _save_pages(figs, _figpath(isdir, "LinkageDecay_plot.pdf"))


# 6 ---------------------------------------------------------------------

def plot_read_filtering(isdir: ProfileDir, **kwargs):
    """Read filtering tallies: horizontal bars sorted descending, grey
    with 'Total filtered pairs' green, percent-of-mapped-pairs annotations
    (reference: mapping_plots.py:69-99, 233-276 read_filtering_plot)."""
    db = isdir.get("mapping_info")
    row = db[db["scaffold"] == "all_scaffolds"].iloc[0]
    keep_cols = ([c for c in db.columns if "pass" in c] +
                 ["unfiltered_reads", "unfiltered_pairs", "filtered_pairs"])
    c2c = {"unfiltered_reads": "Total mapping reads (divided by 2)",
           "unfiltered_pairs": "Total mapped pairs",
           "pass_min_mapq": "Pairs passing mapQ threshold",
           "pass_max_insert": "Pairs passing max insert size threshold",
           "pass_min_insert": "Pairs passing min insert size threshold",
           "pass_filter_cutoff": "Pairs passing ANI threshold",
           "filtered_pairs": "Total filtered pairs"}
    melted = pd.DataFrame({
        "variable": [c2c.get(c, c) for c in keep_cols],
        "value": [int(row[c] / 2) if c == "unfiltered_reads"
                  else float(row[c]) for c in keep_cols]})
    melted = melted.sort_values(["value", "variable"], ascending=False)
    colors = ["green" if v == "Total filtered pairs" else "grey"
              for v in melted["variable"]]

    fig = plt.figure()
    ax = plt.gca()
    ax.barh(range(len(melted)), melted["value"], color=colors)
    ax.set_yticks(range(len(melted)))
    ax.set_yticklabels(melted["variable"])
    ax.invert_yaxis()  # seaborn barplot draws the first row on top
    plt.xlabel("Number of read pairs")
    plt.ylabel("")
    offset = melted["value"].max() / 12
    total_rows = melted[melted["variable"] == "Total mapped pairs"]["value"]
    total = float(total_rows.iloc[0]) if len(total_rows) else 0.0
    if total > 0:
        # annotate every bar but the first with its % of mapped pairs
        # (mapping_plots.py:262-270)
        for i, (v, w) in enumerate(zip(melted["variable"],
                                       melted["value"])):
            if i == 0:
                continue
            plt.text(offset + w, i, "{:1.0f}%".format(w / total * 100),
                     ha="center", va="center")
    ax.spines["right"].set_visible(False)
    ax.spines["top"].set_visible(False)
    plt.title("all scaffolds")
    fig.set_size_inches(6, 4)
    fig.tight_layout()
    from matplotlib.backends.backend_pdf import PdfPages
    with PdfPages(_figpath(isdir, "ReadFiltering_plot.pdf")) as pp:
        pp.savefig(fig)
    plt.close(fig)


# 7 ---------------------------------------------------------------------

def plot_scaffold_inspection(isdir: ProfileDir, **kwargs):
    """Per-genome scaffold inspection: the same four windowed metrics as
    plot 2 rotated sideways — genome position on y (inverted), one column
    per metric, scaffold names as y-ticks at their midpoints, page height
    scaled to genome length (positional_plots.py:85-138, 510-569)."""
    figs = []
    for genome, Wdb, breaks, midpoints in _genome_pages(isdir, **kwargs):
        present = [m for m in _METRIC_ORDER
                   if m in set(Wdb["metric"])]
        ymax = float(Wdb["midpoint"].max())
        # reference utilities._calc_ylim:49-50
        height = min(max(5.0, ymax / 5000.0), 100.0)
        fig, axes = plt.subplots(1, len(present), sharey=True,
                                 squeeze=False, figsize=(8, height))
        colors = ["red", "blue", "black"]
        for i, metric in enumerate(present):
            ax = axes[0][i]
            wdb = Wdb[Wdb["metric"] == metric]
            for c, (ani, ddb) in enumerate(wdb.groupby("ANI")):
                ax.plot(ddb["value"], ddb["midpoint"],
                        c=colors[c % 3], label=ani, marker="o", ms=5)
            ax.set_title(str(metric))
            ax.yaxis.grid(False)
            if i == 0:
                ax.legend(loc="upper left", title="Min read ANI (%)",
                          fontsize=7)
            for b in breaks:
                ax.axhline(b, ls="-", c="lightgrey", zorder=-1)
        axes[0][0].set_yticks(list(midpoints.values()))
        axes[0][0].set_yticklabels(list(midpoints.keys()), fontsize=2)
        axes[0][0].set_ylim(ymax, 0)
        fig.suptitle(str(genome), y=0.999)
        fig.subplots_adjust(hspace=0.3)
        fig.tight_layout()
        figs.append(fig)
    _save_pages(figs, _figpath(isdir, "ScaffoldInspection_plot.pdf"))


# 8 ---------------------------------------------------------------------

def plot_linkage_decay_types(isdir: ProfileDir, **kwargs):
    """Linkage decay (r2, 5 bp windows) split by mutation-type pair, one
    page per genome (reference: linkage_plots.py:60-104, 141-196).
    Requires gene profiling. The reference builds windows for the
    link_type key 'S=S' but plots 'S-S' (:163 vs :185), so its S-S line
    is always empty — yet seaborn still adds an 'S-S' legend entry for
    the empty selection; reproduced here (empty line artist, data-less
    legend entry)."""
    db = isdir.get("raw_linkage_table")
    mdb = isdir.get("SNP_mutation_types")
    if db is None or len(db) == 0 or mdb is None or len(mdb) == 0:
        raise ValueError("needs linkage + genes")
    db = db.sort_values("mm").drop_duplicates(
        subset=["scaffold", "position_A", "position_B"],
        keep="last").sort_index()
    k2t = {(s, p): t for s, p, t in zip(
        mdb["scaffold"], mdb["position"], mdb["mutation_type"])}

    def link_type(s, pa, pb):
        ka, kb = (s, pa), (s, pb)
        if ka in k2t and kb in k2t:
            return f"{k2t[ka]}-{k2t[kb]}"
        return np.nan

    db = db.copy()
    db["link_type"] = [link_type(s, pa, pb) for s, pa, pb in zip(
        db["scaffold"], db["position_A"], db["position_B"])]
    s2b = _genome_of(isdir)
    db["genome"] = db["scaffold"].map(s2b)
    allowed_g = _allowed_genomes(isdir, **kwargs)
    figs = []
    for genome, gdb in db.groupby("genome"):
        if allowed_g is not None and genome not in allowed_g:
            continue
        fig = plt.figure()
        for lt_build, lt_label in (("S=S", "S-S"), ("N-N", "N-N"),
                                   ("all", "all")):
            sel = gdb if lt_build == "all" else \
                gdb[gdb["link_type"] == lt_build]
            if len(sel):
                # no min_vals masking here — the reference's
                # linkage_decay_type computes but never applies it
                w = _ld_window_means(sel, chunk_size=5, min_vals=None,
                                     max_d=int(gdb["distance"].max()))
                plt.plot(w["distance"], w["r2"], label=lt_label,
                         marker="o", ms=4)
            else:
                # reference passes the empty selection to sns.lineplot
                # with label='S-S' (linkage_plots.py:189), which still
                # registers the legend entry
                plt.plot([], [], label=lt_label, marker="o", ms=4)
        plt.title(str(genome))
        plt.xlabel("Distance between SNPs (bp)\nAveraged over 5bp "
                   "windows; plotting windows with at least 2 values")
        plt.ylabel("SNP linkage")
        if plt.gca().get_legend_handles_labels()[1]:
            plt.legend()
        fig.set_size_inches(6, 4)
        fig.tight_layout()
        figs.append(fig)
    _save_pages(figs, _figpath(isdir, "LinkageDecay_types_plot.pdf"))


# 9 ---------------------------------------------------------------------

def plot_gene_histograms(isdir: ProfileDir, **kwargs):
    """Gene-level sorted rank plots — each metric's values descending vs
    gene index, stacked rows sharing x, one page per genome (reference:
    gene_plots.py:23-87; despite the PDF name these are rank plots, not
    histograms, and SNPs_per_bp is absent upstream so the rendered rows
    are coverage and nucl_diversity)."""
    db = gen.generate(isdir, "gene_info", store=False, return_table=True)
    if db is None or len(db) == 0:
        raise ValueError("needs genes")
    s2b = _genome_of(isdir)
    db = db.copy()
    db["genome"] = db["scaffold"].map(s2b)
    allowed_g = _allowed_genomes(isdir, **kwargs)
    cols = [c for c in ["coverage", "nucl_diversity", "SNPs_per_bp"]
            if c in db.columns]
    figs = []
    for genome, gdb in db.groupby("genome"):
        if allowed_g is not None and genome not in allowed_g:
            continue
        fig, axes = plt.subplots(max(len(cols), 1), 1, sharex=True,
                                 squeeze=False)
        for i, col in enumerate(cols):
            ax = axes[i][0]
            vals = gdb[col].sort_values(ascending=False).reset_index(
                drop=True)
            ax.axvline(0, c="black")
            ax.axhline(0, c="black")
            ax.plot(vals.index, vals.values, marker="o", ms=1)
            ax.set_ylabel(str(col))
        axes[-1][0].set_xlabel("gene index")
        fig.suptitle(str(genome), y=0.999)
        fig.set_size_inches(8, 5)
        fig.tight_layout()
        figs.append(fig)
    _save_pages(figs, _figpath(isdir, "GeneHistogram_plot.pdf"))


# 10 --------------------------------------------------------------------

def _shorten_sample(name: str) -> str:
    """reference: plotting/utilities.py:52-58 _shorten_name."""
    name = str(name).replace(".sorted.bam", "")
    if "-vs-" in name:
        name = name.split("-vs-")[1]
    if len(name) > 15:
        name = "\n".join(name[n:n + 15] for n in range(0, len(name), 15))
    return name


def _symmetric_matrix(gdb: pd.DataFrame, col: str) -> pd.DataFrame:
    """Square sample-by-sample similarity matrix from directed rows:
    cell = nanmean of the two directions, diagonal = 1
    (reference: compare_plots.py:120-154 add_av_RC)."""
    samples = sorted(set(gdb["name1"]) | set(gdb["name2"]))
    m = pd.DataFrame(np.nan, index=samples, columns=samples, dtype=float)
    for n1, n2, v in zip(gdb["name1"], gdb["name2"], gdb[col]):
        m.loc[n1, n2] = v
    arr = m.values
    # explicit empty guard: cells missing in BOTH directions stay NaN
    # without nanmean's `Mean of empty slice` RuntimeWarning
    both = np.stack([arr, arr.T])
    have = (~np.isnan(both)).sum(axis=0)
    with np.errstate(invalid="ignore"):
        sym = np.where(have > 0,
                       np.nansum(both, axis=0) / np.maximum(have, 1),
                       np.nan)
    np.fill_diagonal(sym, 1.0)
    return pd.DataFrame(sym, index=samples, columns=samples)


def plot_compare_dendrograms(isdir: ProfileDir, **kwargs):
    """Per-genome page with two right-oriented dendrograms — popANI and
    shared-genome coverage — labels colored by ANI cluster, x ticks
    relabeled as percent identity (compare_plots.py:27-119)."""
    import scipy.cluster.hierarchy as sch
    import scipy.spatial.distance as ssd
    ct = isdir.get("comparisonsTable")
    if ct is None or len(ct) == 0:
        raise ValueError("needs a compare profile")
    s2b = _genome_of(isdir)
    from ..profile.genome import genome_wide_readcomparer
    ct = ct.copy()
    if "mm" not in ct.columns:
        ct["mm"] = 0
    ct["genome"] = ct["scaffold"].map(s2b)
    b2l = isdir.get("bin2length")
    db = genome_wide_readcomparer(ct, s2b, b2l, mm_level=False)
    db["name1"] = [_shorten_sample(x) for x in db["name1"]]
    db["name2"] = [_shorten_sample(x) for x in db["name2"]]
    db = db.sort_values(["genome", "name1", "name2"])
    if len(db) == 0:
        raise ValueError("empty genome-wide compare table")

    figs = []
    for genome, gdb in db.groupby("genome"):
        # skip genomes with zero-overlap comparisons
        # (reference: compare_utils.py:257-268 evalute_genome_dist_matrix)
        if (gdb["compared_bases_count"] == 0).any():
            logging.error(
                f"Cannot cluster genome {genome}; comparisons with no "
                "genomic overlap")
            continue
        panels = [("popANI", "Average Nucleotide Identity (ANI)"),
                  ("coverage_overlap", "Shared Genome Coverage (%)")]
        fig, axes = plt.subplots(1, 2, gridspec_kw={"wspace": 0.5})
        name2color = None
        for ax, (col, xlabel) in zip(axes, panels):
            m = _symmetric_matrix(gdb, col)
            names = list(m.columns)
            dist = 1.0 - m.values
            np.fill_diagonal(dist, 0.0)
            condensed = ssd.squareform(dist, checks=False)
            linkage = sch.linkage(condensed, method="average")
            if col == "popANI":
                # color labels by 0.1%-ANI cluster (compare_plots.py:94-101)
                fclust = sch.fcluster(linkage, 0.001,
                                      criterion="distance")
                nclust = max(fclust)
                cmap = plt.get_cmap("jet")
                name2color = {n: cmap(int(c) / max(nclust, 1))
                              for n, c in zip(names, fclust)}
            plt.sca(ax)
            sch.dendrogram(linkage, labels=names, orientation="right")
            for lbl in ax.get_ymajorticklabels():
                if name2color:
                    lbl.set_color(name2color.get(lbl.get_text(), "black"))
            ax.set_xlabel(xlabel)
            ax.set_title(str(genome), fontsize=10)
            ax.tick_params(axis="x", which="major", labelsize=8)
            ax.tick_params(axis="y", which="major", labelsize=12)
            ax.yaxis.grid(False)
            # relabel distances as percent identity/overlap
            # (compare_plots.py:110-118)
            locs = ax.xaxis.get_majorticklocs()
            ax.set_xticks(locs)
            ax.set_xticklabels([round((1 - float(x)) * 100, 3)
                                for x in locs])
        n = len(set(gdb["name1"]) | set(gdb["name2"]))
        # reference utilities._x_fig_size(n, factor=.5)
        fig.set_size_inches(20, max(n * 0.5, 8))
        fig.subplots_adjust(left=0.5)
        figs.append(fig)
    _save_pages(figs, _figpath(isdir, "inStrainCompare_dendrograms.pdf"))
