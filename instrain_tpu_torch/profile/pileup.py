"""
Per-scaffold pileup construction and the dense site-stats engine — the
counterpart of instrain_tpu/profile/pileup.py.

Decoded base events of filtered read pairs scatter natively into
counts[M, 4, L] (M = distinct pair-mismatch levels on the scaffold), then
the site-stats kernels (kernels/cuda_sitestats.py) compute clonality, SNV
calls and the cryptic scan for every (mm, position) cell on the chosen
device, and the results come back to host numpy for the tables.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..io.bam import BamArrays
from ..kernels import cuda_sitestats, nullmodel
from ..kernels.sitestats import freq_min_count_lut
from .filter_reads import PairSet


@dataclass
class ScaffoldPileup:
    """Dense pileup inputs for one scaffold."""

    name: str
    rid: int
    length: int
    mm_values: np.ndarray          # int64 [M] sorted distinct pair mms
    counts: np.ndarray             # int32 [M, 4, L] exact-mm base counts
    # event source for linkage capture (native-backed)
    bam: Optional[BamArrays] = None
    qid2mmidx: Optional[np.ndarray] = None  # int32 per qname -> mm index

    def select_events(self, pos_mask: np.ndarray):
        """(pos, base, mm_idx, qname) of counted bases at masked positions
        — extracted natively from the decoder's event buffers."""
        if self.bam is None or self.qid2mmidx is None:
            raise ValueError("pileup has no event source")
        return self.bam.select_events(self.rid, self.qid2mmidx, pos_mask)


def build_scaffold_pileup(bam: BamArrays, pairs: PairSet, rid: int,
                          length: int) -> Optional[ScaffoldPileup]:
    """
    Scatter counted base events (qual >= 30, ACTG, reads whose pair passed
    filtering) into the dense count tensor — a single native pass over the
    decoder's event buffers (bd_build_counts).
    """
    qids, mms = pairs.r2m_for_scaffold(rid)
    if len(qids) == 0:
        return None
    mm_values = np.unique(mms)
    mm_to_idx = {int(m): i for i, m in enumerate(mm_values)}
    n_q = bam.n_qnames
    qid2mmidx = np.full(n_q, -1, dtype=np.int32)
    qid2mmidx[qids] = np.array([mm_to_idx[int(m)] for m in mms],
                               dtype=np.int32)

    counts = bam.build_counts(rid, qid2mmidx, len(mm_values), length)
    if counts.sum() == 0:
        return None

    # drop mm levels with no counted bases anywhere (a pair whose bases
    # were all quality-masked contributes no level, matching the
    # reference's covT key semantics)
    level_mask = counts.sum(axis=(1, 2)) > 0
    if not level_mask.all():
        keep_idx = np.nonzero(level_mask)[0]
        remap = np.full(len(mm_values), -1, dtype=np.int32)
        remap[keep_idx] = np.arange(len(keep_idx), dtype=np.int32)
        qid2mmidx = np.where(qid2mmidx >= 0, remap[qid2mmidx], -1).astype(
            np.int32)
        counts = counts[level_mask]
        mm_values = mm_values[level_mask]

    return ScaffoldPileup(name=bam.ref_names[rid], rid=rid, length=length,
                          mm_values=mm_values, counts=counts,
                          bam=bam, qid2mmidx=qid2mmidx)


@dataclass
class ScaffoldStats:
    """site_stats outputs materialized to host numpy (see sitestats.py)."""

    pileup: ScaffoldPileup
    arrays: Dict[str, np.ndarray]

    def __getattr__(self, name):
        try:
            return self.arrays[name]
        except KeyError:
            raise AttributeError(name)

    @property
    def mm_values(self):
        return self.pileup.mm_values


def _bucket(n: int, step: int) -> int:
    return -(-n // step) * step


def run_site_stats(pileup: ScaffoldPileup, ref_codes: np.ndarray,
                   null_lut, freq_lut, min_cov: int = 5,
                   rarefied_coverage: int = 50, seed: int = 42,
                   max_chunk: int = 1 << 20,
                   device="cpu") -> ScaffoldStats:
    """
    Run the site-stats kernels for one scaffold on `device`.

    Every output is position-local, so scaffolds longer than `max_chunk`
    are processed in position chunks and concatenated on host — one
    multi-Mb isolate genome never holds the whole [M, 4, L] working set on
    the device at once. Chunk c0 draws under seed + 7919 * (c0 // max_chunk)
    with positions counted from the chunk start, as the JAX engine does.

    No shape padding is needed here; only the rarefied draws' counter
    keeps the JAX engine's padded mm extent max(ceil8(M), 8), so clonR
    is bit-identical to it.
    """
    from .compact import _fold_keys
    counts = pileup.counts
    M, _, L = counts.shape
    dev = torch.device(device)
    null_t = torch.as_tensor(null_lut, dtype=torch.int32, device=dev)
    freq_t = torch.as_tensor(freq_lut, dtype=torch.int32, device=dev)
    m_stride = max(_bucket(M, 8), 8)
    parts = []
    for c0 in range(0, L, max_chunk):
        c1 = min(c0 + max_chunk, L)
        key = _fold_keys(seed + 7919 * (c0 // max_chunk), [pileup.rid])[0]
        seg = cuda_sitestats.single_segment(c1 - c0, key, dev)
        out = cuda_sitestats.site_stats(
            torch.from_numpy(np.ascontiguousarray(counts[:, :, c0:c1],
                                                  dtype=np.int32)).to(dev),
            torch.from_numpy(np.ascontiguousarray(ref_codes[c0:c1])).to(
                dev),
            null_t, freq_t, seg, min_cov=min_cov,
            min_covR=rarefied_coverage, rarefied_draws=rarefied_coverage,
            m_stride=m_stride)
        parts.append({k: v.cpu().numpy() for k, v in out.items()})
    if len(parts) == 1:
        arrays = parts[0]
    else:
        arrays = {k: np.concatenate([p[k] for p in parts], axis=-1)
                  for k in parts[0]}
    return ScaffoldStats(pileup=pileup, arrays=arrays)


def make_luts(cfg_variant) -> Tuple[np.ndarray, np.ndarray]:
    """Resolve (null threshold LUT, min-freq LUT) from a VariantConfig."""
    null_lut = nullmodel.null_thresholds(
        cfg_variant.null_model, fdr=cfg_variant.fdr,
        error_rate=cfg_variant.null_model_error_rate,
        max_coverage=cfg_variant.null_model_max_coverage)
    freq_lut = freq_min_count_lut(
        cfg_variant.min_freq,
        max_coverage=cfg_variant.null_model_max_coverage)
    return null_lut, freq_lut
