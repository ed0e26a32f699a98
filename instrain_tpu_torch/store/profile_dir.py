"""
The profile directory object — the counterpart of
instrain_tpu/store/profile_dir.py, same on-disk format (compatible with
the reference's SNVprofile, inStrain/SNVprofile.py:29-150).

Layout: <loc>/output, raw_data, log, figures; raw_data/attributes.tsv maps
attribute name -> (value-or-file, type, description). Typed payloads:
value, dictionary (json), list (txt), numpy (npz), pandas (csv.gz),
pickle, special (hd5: one dataset per "scaffold::mm" holding
[values, index]; for compare's scaff2pair2mm2cov, one dataset per
"scaffold::pair::mm" holding the sorted positions).

h5py is imported only to write or read a 'special' attribute. Where it is
not installed, a special attribute is written as a pickle of the mapping
it was given (and a warning is logged); the attribute keeps its 'special'
type, and this package's reader loads either file (the JAX package's
reads the pickled scaffold -> mm -> Series attributes too).
scaff2pair2mm2cov is given and pickled as packed masks (uint64 words, 64
positions each, kernels/compare.py) and read back as sets of positions
from either file.
"""

from __future__ import annotations

import glob
import json
import logging
import os
import pickle
import threading
from typing import List

import numpy as np
import pandas as pd

from .. import __capability_version__, __version__

SPECIAL_SERIES = {"covT", "snpsCounted", "clonT", "clonTR"}
# compare's scaffold -> "name1-vs-name2" -> mm -> positions attribute
SPECIAL_PAIRS = {"scaff2pair2mm2cov"}

# hd5 dataset compression for 'special' attributes (the JAX package's
# default; INSTRAIN_H5_COMP=gzip gives the reference's own choice)
_H5_COMP = os.environ.get("INSTRAIN_H5_COMP", "lzf")
if _H5_COMP in ("none", ""):
    _H5_COMP = None


def _h5py():
    try:
        import h5py
    except ImportError:
        return None
    return h5py


def _positions(words: np.ndarray) -> np.ndarray:
    """The set bits' positions of packed mask words, ascending."""
    return np.flatnonzero(np.unpackbits(
        np.ascontiguousarray(words).view(np.uint8), bitorder="little"))


def _special_pack(series: pd.Series) -> np.ndarray:
    """[values, index] 2-row array (reference layout,
    SNVprofile.py:717-748) in the narrowest exact dtype: readers rebuild
    the index with .astype(int) and take values as stored."""
    vals = series.values
    idx = series.index.values
    n = len(idx)
    if np.issubdtype(vals.dtype, np.integer):
        if (n == 0 or (idx.max() < 2 ** 31 and idx.min() >= 0)) and \
           (n == 0 or (vals.min() >= -2 ** 31 and vals.max() < 2 ** 31)):
            return np.array([vals.astype(np.int32),
                             idx.astype(np.int32)])
        return np.array([vals, idx])
    if vals.dtype == np.float32 and (n == 0 or
                                     (0 <= idx.min() and
                                      idx.max() < 2 ** 24)):
        return np.array([vals, idx.astype(np.float32)])
    return np.array([vals.astype(np.float64), idx.astype(np.float64)])


class ProfileDir:
    """A profile results directory (reference: SNVprofile)."""

    first_levels = ["output", "raw_data", "log", "figures"]

    def __init__(self, location: str):
        self.location = os.path.abspath(location)
        # attributes.tsv is a read-modify-write registry
        self._attr_lock = threading.RLock()
        self._make_structure()
        self._init_attributes()

    # ---------- public API ----------

    def store(self, name: str, value, typ: str, description: str):
        with self._attr_lock:
            adb = self._get_attributes()
            if typ == "value":
                stored = value
            elif typ == "dictionary":
                stored = self._fileloc(name) + ".json"
                with open(stored, "w") as f:
                    json.dump(value, f)
            elif typ == "list":
                stored = self._fileloc(name) + ".txt"
                with open(stored, "w") as f:
                    for x in value:
                        f.write(str(x) + "\n")
            elif typ == "numpy":
                stored = self._fileloc(name) + ".npz"
                np.savez_compressed(stored, value)
            elif typ == "pandas":
                # gzip level 1: the same text as the reference's level 9,
                # written faster
                stored = self._fileloc(name) + ".csv.gz"
                value.to_csv(stored, compression={"method": "gzip",
                                                  "compresslevel": 1})
            elif typ == "pickle":
                stored = self._fileloc(name) + ".pickle"
                with open(stored, "wb") as f:
                    pickle.dump(value, f)
            elif typ == "special":
                stored = self._store_special(name, value)
            else:
                raise ValueError(f"unknown attribute type {typ}")
            self._register(name, stored, typ, description, adb)

    def _register(self, name, stored, typ, description, adb):
        row = pd.DataFrame({"value": [stored], "type": [typ],
                            "description": [description]}, index=[name])
        if name in adb.index:
            adb.at[name, "value"] = stored
        else:
            adb = pd.concat([adb, row])
        self._store_attributes(adb)

    def get(self, name: str, **kwargs):
        adb = self._get_attributes()
        if name not in adb.index:
            return None
        typ = adb.loc[name, "type"]
        if typ == "value":
            return adb.loc[name, "value"]
        filename = os.path.join(self.get_location("raw_data"),
                                os.path.basename(adb.loc[name, "value"]))
        if typ == "dictionary":
            with open(filename) as f:
                return json.load(f)
        if typ == "list":
            with open(filename) as f:
                return [l.strip() for l in f]
        if typ == "numpy":
            base = np.load(filename)
            return base[base.files[0]]
        if typ == "pandas":
            return pd.read_csv(filename, index_col=0)
        if typ == "pickle":
            with open(filename, "rb") as f:
                return pickle.load(f)
        if typ == "special":
            return self._load_special(filename, name, **kwargs)
        raise ValueError(f"unknown attribute type {typ}")

    def get_location(self, name: str) -> str:
        loc = os.path.join(self.location, name)
        if not os.path.exists(loc):
            os.makedirs(loc)
        return loc + "/"

    def get_output_base(self) -> str:
        return (self.get_location("output") +
                os.path.basename(self.get("location")) + "_")

    def keys(self) -> List[str]:
        return list(self._get_attributes().index)

    def load_output(self, name: str) -> pd.DataFrame:
        """Load an already-generated output TSV
        (reference: SNVprofile.load_output, 168-190)."""
        loc = self.get_output_base() + name
        files = glob.glob(loc + "*")
        if len(files) > 1:
            # the reference's assertion, which parse_annotations catches
            raise AssertionError(files)
        if not files:
            logging.error(f"{name} does not exist")
            return pd.DataFrame()
        if name == "mapping_info":
            return pd.read_csv(files[0], sep="\t", header=1)
        return pd.read_csv(files[0], sep="\t")

    def get_read_length(self) -> float:
        """reference: SNVprofile.get_read_length (458-460)."""
        rdb = self.get("mapping_info").head(1)
        return float(rdb["mean_pair_length"].iloc[0])

    def get_clonality_table(self, nonredundant: bool = True) -> pd.DataFrame:
        """clonT as one table of scaffold, position, clonality (and mm
        unless nonredundant: then each position's highest mm level)
        (reference: SNVprofile.get_clonality_table, 524-548)."""
        clonT = self.get("clonT")
        if clonT is None:
            return pd.DataFrame()
        dbs = []
        for scaff, mm2series in clonT.items():
            for mm, series in mm2series.items():
                db = series.to_frame(name="clonality")
                db["mm"] = mm
                db = db.reset_index().rename(columns={"index": "position"})
                db["scaffold"] = scaff
                dbs.append(db)
        if not dbs:
            return pd.DataFrame()
        cdb = pd.concat(dbs).dropna().reset_index(drop=True)
        if nonredundant:
            cdb = (cdb.sort_values("mm").dropna()
                      .drop_duplicates(subset=["scaffold", "position"],
                                       keep="last")
                      .sort_index().drop(columns=["mm"]))
        return cdb

    def get_parsed_log(self) -> pd.DataFrame:
        from ..obs.logging import load_log
        return load_log(os.path.join(self.get_location("log"), "log.log"))

    # ---------- special ----------

    def _store_special(self, name: str, obj) -> str:
        h5py = _h5py()
        if name not in SPECIAL_SERIES | SPECIAL_PAIRS or h5py is None:
            if name in SPECIAL_SERIES | SPECIAL_PAIRS:
                logging.warning(f"h5py is not installed: storing {name} "
                                f"as a pickle instead of hd5")
            fileloc = self._fileloc(name) + ".pickle"
            with open(fileloc, "wb") as f:
                pickle.dump(obj, f)
            return fileloc
        fileloc = self._fileloc(name) + ".hd5"
        with h5py.File(fileloc, "w") as f:
            for scaff, inner in obj.items():
                if name in SPECIAL_PAIRS:
                    # instrain_tpu/store/profile_dir.py:241-249
                    for pair, mm2 in inner.items():
                        for mm, words in mm2.items():
                            f.create_dataset(
                                f"{scaff}::{pair}::{mm}",
                                data=_positions(words).astype("float64"),
                                compression=_H5_COMP)
                    continue
                for mm, series in inner.items():
                    data = _special_pack(series)
                    # small datasets: contiguous beats chunk+filter overhead
                    comp = _H5_COMP if data.size >= 8192 else None
                    f.create_dataset(f"{scaff}::{mm}", data=data,
                                     compression=comp, track_times=False)
        return fileloc

    def _load_special(self, location: str, name: str, scaffolds=()):
        """The attribute's mapping; with `scaffolds`, only those
        scaffolds'. Pair-keyed attributes come back as sets of positions,
        from either file kind."""
        scaffolds = set(scaffolds)
        if location.endswith(".pickle"):
            with open(location, "rb") as f:
                obj = pickle.load(f)
            if scaffolds:
                obj = {s: v for s, v in obj.items() if s in scaffolds}
            if name in SPECIAL_PAIRS:
                obj = {s: {p: {int(mm): set(_positions(w))
                               for mm, w in mm2.items()}
                           for p, mm2 in p2.items()}
                       for s, p2 in obj.items()}
            return obj
        h5py = _h5py()
        if h5py is None:
            raise ImportError(f"reading {location} needs h5py")
        out = {}
        with h5py.File(location, "r") as f:
            for key in f.keys():
                parts = key.split("::")
                if scaffolds and parts[0] not in scaffolds:
                    continue
                if name in SPECIAL_PAIRS:
                    scaff, pair, mm = parts
                    out.setdefault(scaff, {}).setdefault(pair, {})[
                        int(mm)] = set(np.array(f[key]).astype(int))
                    continue
                scaff, mm = parts
                dset = list(f[key])
                out.setdefault(scaff, {})[int(mm)] = pd.Series(
                    data=dset[0], index=np.array(dset[1]).astype(int))
        return out

    def covt_scaffolds(self) -> set:
        """Scaffolds present in covT without loading its series
        (reference: _get_covt_keys, SNVprofile.py:636-648), from an hd5
        or a pickled covT."""
        adb = self._get_attributes()
        filename = os.path.join(self.get_location("raw_data"),
                                os.path.basename(adb.loc["covT", "value"]))
        if filename.endswith(".pickle"):
            with open(filename, "rb") as f:
                return set(pickle.load(f))
        h5py = _h5py()
        if h5py is None:
            raise ImportError(f"reading {filename} needs h5py")
        with h5py.File(filename, "r") as f:
            return {key.split("::")[0] for key in f.keys()}

    # ---------- internals ----------

    def _make_structure(self):
        for l in [""] + self.first_levels:
            os.makedirs(os.path.join(self.location, l), exist_ok=True)

    def _init_attributes(self):
        aloc = os.path.join(self.location, "raw_data/attributes.tsv")
        if not os.path.exists(aloc):
            adb = pd.DataFrame({"value": [], "type": [], "description": []})
            self._store_attributes(adb)
            self.store("location", self.location, "value",
                       "Location of SNVprofile object")
            # the capability-matched inStrain version, so reference tooling
            # accepts the directory (SNVprofile.py:863-873)
            self.store("version", __capability_version__, "value",
                       "Version of inStrain")
            with open(self._fileloc("_README.txt"), "w") as f:
                f.write("Profile directory written by instrain_tpu_torch "
                        f"{__version__} (inStrain-compatible format).\n")
        elif self.location != self.get("location"):
            self.store("location", self.location, "value",
                       "Location of SNVprofile object")

    def _get_attributes(self) -> pd.DataFrame:
        aloc = os.path.join(self.location, "raw_data/attributes.tsv")
        return pd.read_csv(aloc, sep="\t", index_col="name")

    def _store_attributes(self, adb: pd.DataFrame):
        adb.to_csv(os.path.join(self.location, "raw_data/attributes.tsv"),
                   sep="\t", index_label="name")

    def _fileloc(self, name: str) -> str:
        return os.path.join(self.get_location("raw_data"), name)
