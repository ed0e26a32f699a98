"""
Per-scaffold pileup construction and the dense site-stats engine — the
counterpart of instrain_tpu/profile/pileup.py.

Decoded base events of filtered read pairs scatter natively into
counts[M, 4, L] (M = distinct pair-mismatch levels on the scaffold) —
int32, or for the hybrid and batch engines int16 and bucket-padded, the
form their sparse count wire packs (build_scaffold_pileup_padded) — then
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
from ..parallel.mesh import default_device
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
    # set when counts is bucket-padded ([Mp, 4, Lp] int16 from the native
    # padded builder): the true number of mm levels M. `length` stays the
    # true L. None: counts has the true shape.
    true_M: Optional[int] = None

    @property
    def counts_exact(self) -> np.ndarray:
        """The true-shaped [M, 4, L] view of counts (no bucket padding)."""
        if self.true_M is None:
            return self.counts
        return self.counts[:self.true_M, :, :self.length]

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
    levels = _qid_levels(bam, pairs, rid)
    if levels is None:
        return None
    mm_values, qid2mmidx = levels

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


def _qid_levels(bam: BamArrays, pairs: PairSet, rid: int):
    """(distinct pair mms of the scaffold's pairs, their qname -> mm level
    map), or None where the scaffold has no pairs."""
    qids, mms = pairs.r2m_for_scaffold(rid)
    if len(qids) == 0:
        return None
    mm_values = np.unique(mms)
    mm_to_idx = {int(m): i for i, m in enumerate(mm_values)}
    qid2mmidx = np.full(bam.n_qnames, -1, dtype=np.int32)
    qid2mmidx[qids] = np.array([mm_to_idx[int(m)] for m in mms],
                               dtype=np.int32)
    return mm_values, qid2mmidx


def build_scaffold_pileup_padded(bam: BamArrays, pairs: PairSet, rid: int,
                                 length: int, m_step: int = 8,
                                 l_step: int = 4096
                                 ) -> Optional[ScaffoldPileup]:
    """
    build_scaffold_pileup through the native padded int16 scatter
    (bd_build_counts16) — the counterpart of
    instrain_tpu/profile/pileup.py:build_scaffold_pileup_padded: the
    counts come out bucket-padded, [Mp, 4, Lp] with the mm axis to a
    multiple of `m_step` (at least m_step) and the positions to one of
    `l_step`, the empty mm levels dropped in the same pass, ready for the
    hybrid and batch engines' sparse count wire. Where an exact-mm count
    exceeds int16 (32,767) the int32 builder's pileup is returned
    instead: a route the data decides, as in the JAX package.
    """
    levels = _qid_levels(bam, pairs, rid)
    if levels is None:
        return None
    mm_values, qid2mmidx = levels
    n_mm = len(mm_values)
    Lp = max(_bucket(length, l_step), l_step)
    res = bam.build_counts_padded(rid, qid2mmidx, n_mm, length, Lp,
                                  max(_bucket(n_mm, m_step), m_step))
    if res is None:
        return build_scaffold_pileup(bam, pairs, rid, length)
    counts, level_events, level_map = res
    kept = int((level_events > 0).sum())
    if kept == 0:
        return None
    if kept < n_mm:
        qid2mmidx = np.where(qid2mmidx >= 0, level_map[qid2mmidx],
                             -1).astype(np.int32)
        mm_values = mm_values[level_events > 0]
    Mp = max(_bucket(kept, m_step), m_step)
    return ScaffoldPileup(name=bam.ref_names[rid], rid=rid, length=length,
                          mm_values=mm_values, counts=counts[:Mp],
                          bam=bam, qid2mmidx=qid2mmidx, true_M=kept)


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
                   device=None, pallas: bool = False) -> ScaffoldStats:
    """
    Run the site-stats kernels for one scaffold on `device` (None: the
    current CUDA device; raises without a GPU). `pallas` (`--engine
    pallas`) rounds clon as the JAX package's Pallas core does
    (instrain_tpu/profile/pileup.py:215-223); the chunks, keys and every
    other output are the dense engine's.

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
    counts = pileup.counts_exact
    M, _, L = counts.shape
    dev = default_device(device)
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
            m_stride=m_stride, pallas=pallas)
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
