"""
Golden outputs of the JAX package's device compaction (K4) for the
port's compact kernels.

tests/data/torch_compact_golden.npz holds, for each case below, the
inputs (counts, ref codes, key, counter stride) and what
instrain_tpu.kernels.sitestats.site_stats_compact returns for them on the
CPU, the way instrain_tpu's hybrid engine calls it
(profile/compact.py:_padded_inputs: mm axis padded to max(ceil8(M), 8),
positions to a multiple of 4096, true_len = L), cut to the true extents:
the valid SNP rows, the [M] aggregates, the linkage profiles at the
n_pos SNV positions and the [L] masks; plus the two LUTs. chip_smoke.py
holds the CUDA kernels against it on a machine without jax;
tests/test_torch_compact.py regenerates it in memory and asserts the
committed file is unchanged.

    JAX_PLATFORMS=cpu python tests/make_torch_compact_golden.py
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from instrain_tpu_torch.synth import (  # noqa: E402
    site_stats_inputs as make_inputs)

PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "torch_compact_golden.npz")

# (M, L, seed): one mm level at a tile-sized length, eight at a ragged
# one, and more levels than one padded bucket of 8 (M = 33 -> Mp = 40)
CASES = [(1, 4096, 0), (8, 1237, 1), (33, 160, 2)]
MIN_COV, RAREFIED = 5, 50


def jax_compact(counts, ref, key, null_lut, freq_lut, min_cov=MIN_COV,
                rarefied=RAREFIED):
    """site_stats_compact of the JAX package as its hybrid engine runs it
    (padded inputs, capacities that hold every row and position), cut to
    the true extents. Returns ({group: {name: array}}, Mp)."""
    import instrain_tpu  # noqa: F401  (x64 mode, as the package runs)
    from instrain_tpu.kernels.sitestats import site_stats_compact
    from instrain_tpu.profile import compact as JC
    from instrain_tpu.profile.pileup import ScaffoldPileup
    pu = ScaffoldPileup(name="golden", rid=0, length=counts.shape[2],
                        mm_values=np.arange(counts.shape[0]), counts=counts)
    cp, rp, M, L = JC._padded_inputs(pu, ref)
    Mp, _, Lp = cp.shape
    out = site_stats_compact(cp, rp, null_lut, freq_lut, key,
                             min_cov=min_cov, min_covR=rarefied,
                             rarefied_draws=rarefied,
                             snp_capacity=Mp * Lp, pos_capacity=Lp,
                             true_len=L)
    n_rows = int(out["rows"]["n_rows"])
    n_pos = int(out["linkage"]["n_pos"])
    res = {
        "rows": {k: np.asarray(v)[:n_rows] for k, v in out["rows"].items()
                 if k not in ("valid", "n_rows")},
        "agg": {k: np.asarray(v)[:M] for k, v in out["agg"].items()},
        "linkage": dict(pos=np.asarray(out["linkage"]["pos"])[:n_pos],
                        cum=np.asarray(out["linkage"]["cum"])[:M, :, :n_pos],
                        present=np.asarray(
                            out["linkage"]["present"])[:M, :n_pos]),
        "masks": {k: np.asarray(v)[..., :L]
                  for k, v in out["masks"].items()},
    }
    res["rows"]["n_rows"] = np.int64(n_rows)
    res["linkage"]["n_pos"] = np.int64(n_pos)
    return res, Mp


def golden_arrays():
    """{name: array} of every case's inputs and JAX outputs."""
    import instrain_tpu  # noqa: F401
    from instrain_tpu.kernels.nullmodel import analytic_null_thresholds
    from instrain_tpu.kernels.sitestats import freq_min_count_lut
    from instrain_tpu.profile.compact import _fold_keys

    null_lut = analytic_null_thresholds(max_coverage=10000)
    freq_lut = freq_min_count_lut(0.05, max_coverage=10000)
    out = {"null_lut": null_lut, "freq_lut": freq_lut}
    for M, L, seed in CASES:
        counts, ref = make_inputs(M, L, seed)
        key = _fold_keys(7 + seed, [seed])[0]
        res, Mp = jax_compact(counts, ref, key, null_lut, freq_lut)
        tag = f"M{M}_L{L}"
        out[f"{tag}/counts"] = counts
        out[f"{tag}/ref"] = ref
        out[f"{tag}/key"] = key
        out[f"{tag}/m_stride"] = np.int64(Mp)
        for group, d in res.items():
            for k, v in d.items():
                out[f"{tag}/{group}/{k}"] = np.asarray(v)
    return out


if __name__ == "__main__":
    os.makedirs(os.path.dirname(PATH), exist_ok=True)
    np.savez_compressed(PATH, **golden_arrays())
    print(PATH, os.path.getsize(PATH), "bytes")
