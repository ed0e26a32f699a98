"""
Plotting controller (reference: inStrain/plotting/plotting_controller.py).

Registry of the reference's 10 numbered plots; each plot is wrapped so a
failure never kills the run (reference: plotting_controller.py:60-73).
The counterpart of instrain_tpu/plotting/controller.py; the plots live in
plots.py beside it, which imports matplotlib (a missing matplotlib raises
its ImportError from make_plots).
"""

from __future__ import annotations

import logging
import traceback
from typing import List, Union

from ..store.profile_dir import ProfileDir


def make_plots(isdir: ProfileDir, plots: Union[str, List[str]] = "a",
               **kwargs):
    from . import plots as P
    import matplotlib
    # re-assert per call: ambient code (tests, user scripts) may have reset
    # rcParams since plots.py was imported (reference pins it per module,
    # plotting/positional_plots.py:10)
    matplotlib.rcParams["pdf.fonttype"] = 42
    if isinstance(isdir, str):
        isdir = ProfileDir(isdir)
    registry = {
        "1": P.plot_coverage_breadth_vs_mm,
        "2": P.plot_genome_wide_microdiversity,
        "3": P.plot_read_ani_distribution,
        "4": P.plot_allele_frequencies,
        "5": P.plot_linkage_decay,
        "6": P.plot_read_filtering,
        "7": P.plot_scaffold_inspection,
        "8": P.plot_linkage_decay_types,
        "9": P.plot_gene_histograms,
        "10": P.plot_compare_dendrograms,
    }
    if plots in ("a", "all"):
        todo = list(registry)
    else:
        todo = [str(p) for p in plots]
    if "_allowed" not in kwargs:
        try:
            kwargs["_allowed"] = P._allowed_scaffolds(isdir, **kwargs)
        except Exception:
            kwargs["_allowed"] = None
    done = []
    for p in todo:
        fn = registry.get(p)
        if fn is None:
            continue
        try:
            fn(isdir, **kwargs)
            done.append(p)
        except Exception as e:
            logging.debug(f"Plot {p} failed: {e}\n{traceback.format_exc()}")
    logging.info(f"Plotting finished: made plots {', '.join(done)}")
    return done
