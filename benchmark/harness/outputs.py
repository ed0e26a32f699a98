"""
Reads what one `profile` run wrote (its output TSVs and the covT/clonT
views in raw_data) into the form of benchmark/ref/profile.reference, so the
two can be compared. Reads files only: nothing of the program is imported.
The covT and clonT views are a pickle of scaffold -> mm -> pandas Series
where h5py is missing, else an hd5 file with one dataset [values, index]
per "scaffold::mm".
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, Tuple

import numpy as np
import pandas as pd

Views = Dict[str, Dict[int, Tuple[np.ndarray, np.ndarray]]]


def _views(raw: str, name: str) -> Views:
    pk = os.path.join(raw, name + ".pickle")
    out: Views = {}
    if os.path.exists(pk):
        with open(pk, "rb") as f:
            obj = pickle.load(f)
        for s, mm2 in obj.items():
            out[s] = {int(m): (np.asarray(v.index, dtype=np.int64),
                               np.asarray(v.values))
                      for m, v in mm2.items() if len(v)}
        return out
    import h5py
    with h5py.File(os.path.join(raw, name + ".hd5"), "r") as f:
        for key in f.keys():
            s, m = key.split("::")
            d = np.array(f[key])
            if d.shape[-1]:
                out.setdefault(s, {})[int(m)] = (d[1].astype(np.int64), d[0])
    return out


def _tsv(base: str, name: str, **kw) -> pd.DataFrame:
    for ext in (".tsv", ".tsv.gz"):
        if os.path.exists(base + name + ext):
            try:
                return pd.read_csv(base + name + ext, sep="\t", **kw)
            except pd.errors.EmptyDataError:
                return pd.DataFrame()
    return pd.DataFrame()


def read_profile(outdir: str) -> Dict:
    """The tables one profile directory holds."""
    base = os.path.join(outdir, "output", os.path.basename(outdir) + "_")
    raw = os.path.join(outdir, "raw_data")
    mapping = _tsv(base, "mapping_info", header=1)
    mapping = mapping[mapping["scaffold"] != "all_scaffolds"].set_index(
        "scaffold")
    snvs = _tsv(base, "SNVs")
    link = _tsv(base, "linkage")
    return dict(
        mapping=mapping, covT=_views(raw, "covT"), clonT=_views(raw, "clonT"),
        scaffold_info=_tsv(base, "scaffold_info").set_index("scaffold"),
        snvs=(snvs.set_index(["scaffold", "position"]) if len(snvs)
              else pd.DataFrame()),
        linkage=(link.set_index(["scaffold", "position_A", "position_B"])
                 if len(link) else pd.DataFrame()),
        genome_info=_tsv(base, "genome_info").set_index("genome"))


def digest(outdir: str) -> str:
    """A digest of the user-visible output tables of one run, so runs of
    the same input into directories of the same name can be held to each
    other byte for byte."""
    import hashlib
    h = hashlib.sha256()
    out = os.path.join(outdir, "output")
    for name in sorted(os.listdir(out)):
        h.update(name.encode())
        with open(os.path.join(out, name), "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def size(outdir: str) -> int:
    """Bytes of every file one run wrote."""
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(outdir) for f in files)
