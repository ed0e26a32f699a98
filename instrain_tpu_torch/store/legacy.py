"""
Legacy profile conversion (reference: SNVprofile.convert_SNVprofile,
SNVprofile.py:1059-1149 — converts a v0.3/v0.4 pickled SNVprofile_old
object into a profile directory).

The old pickle contains an instance of `inStrain.SNVprofile.SNVprofile`
(pre-directory era) whose attributes are plain pandas/numpy/dict payloads.
We unpickle it with a permissive shim (any missing class resolves to a
plain attribute bag) and re-store each recognized attribute into the
directory format. The counterpart of instrain_tpu/store/legacy.py.
Unpickling runs the pickle's code: convert only profiles you trust.
"""

from __future__ import annotations

import logging
import os
import pickle
from typing import Any, Dict

from .profile_dir import ProfileDir


class _Bag:
    """Attribute bag standing in for any legacy class during unpickling."""

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        else:
            self.__dict__["_state"] = state


class _ShimUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        try:
            return super().find_class(module, name)
        except (ImportError, AttributeError):
            logging.debug(f"shimming legacy class {module}.{name}")
            return _Bag


# legacy attribute name -> (new name, storage type, description)
_CONVERT = {
    "location": None,
    "version": None,
    "bam": ("bam_loc", "value", "Location of .bam file"),
    "scaffold_list": ("scaffold_list", "list",
                      "1d list of scaffolds that were profiled"),
    "scaffold2length": ("scaffold2length", "dictionary",
                        "Dictionary of scaffold 2 length"),
    "snp_table": ("cumulative_snv_table", "pandas",
                  "Cumulative SNP on mm level"),
    "raw_snp_table": ("raw_snp_table", "pandas",
                      "Contains raw SNP information on a mm level"),
    "raw_linkage_table": ("raw_linkage_table", "pandas",
                          "Raw table of linkage information"),
    "cumulative_scaffold_table": ("cumulative_scaffold_table", "pandas",
                                  "Cumulative coverage on mm level"),
    "read_report": ("mapping_info", "pandas", "Report on reads"),
    "mapping_info": ("mapping_info", "pandas", "Report on reads"),
    "covT": ("covT", "special", "Scaffold -> mm -> position coverage"),
    "clonT": ("clonT", "special", "Scaffold -> mm -> position clonality"),
    "r2m": ("Rdic", "pickle", "Read pair -> mismatches"),
    "Rdic": ("Rdic", "pickle", "Read pair -> mismatches"),
}


def convert_legacy_profile(pickle_loc: str, out_loc: str = None
                           ) -> ProfileDir:
    """Convert a pre-v1 pickled profile into a profile directory."""
    if out_loc is None:
        out_loc = pickle_loc + ".IS"
    with open(pickle_loc, "rb") as f:
        obj = _ShimUnpickler(f).load()

    attrs: Dict[str, Any] = dict(getattr(obj, "__dict__", {}))
    if not attrs and isinstance(obj, dict):
        attrs = obj

    isdir = ProfileDir(out_loc)
    converted = 0
    for old_name, value in attrs.items():
        spec = _CONVERT.get(old_name)
        if spec is None:
            if old_name not in _CONVERT:
                logging.info(f"skipping legacy attribute {old_name!r}")
            continue
        new_name, typ, descr = spec
        try:
            isdir.store(new_name, value, typ, descr)
            converted += 1
        except Exception as e:
            logging.error(f"could not convert {old_name}: {e}")
    logging.info(f"converted {converted} attributes from {pickle_loc} "
                 f"into {out_loc}")
    return isdir
