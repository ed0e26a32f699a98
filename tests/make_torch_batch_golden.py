"""
Golden outputs of the JAX package's batch engine kernel (K5) for the
port's segmented kernels.

tests/data/torch_batch_golden.npz holds, for each chunk below, every
scaffold's inputs (counts [M, 4, L], ref codes, key) with the chunk's
counter stride, and what instrain_tpu.kernels.sitestats.
site_stats_compact_batch returns for them on the CPU, the way the JAX
batch engine calls it (profile/compact.py:_dispatch_batch_chunk: the
chunk padded to one [S, Mp, 4, Lp] shape, per-scaffold true lengths and
keys fold_in(seed, rid)), cut to each scaffold's true extents: the valid
SNP rows, the [M] aggregates, the linkage profiles at the n_pos SNV
positions and the [L] masks; plus the two LUTs. A chunk's scaffolds
share Mp but not M or L: one has a single position. chip_smoke.py holds
the CUDA kernels against it on a machine without jax;
tests/test_torch_batch.py regenerates it in memory and asserts the
committed file is unchanged.

    JAX_PLATFORMS=cpu python tests/make_torch_batch_golden.py
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from instrain_tpu_torch.synth import site_stats_inputs  # noqa: E402

PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "torch_batch_golden.npz")

# chunk name -> [(M, L, rid)] of its scaffolds: Mp = 8 and Mp = 40
CHUNKS = {"mp8": [(3, 1, 11), (8, 1237, 12), (5, 2000, 13), (1, 300, 14)],
          "mp40": [(33, 160, 21), (34, 1, 22), (40, 97, 23)]}
SEED, MIN_COV, RAREFIED = 17, 5, 50


def make_inputs(M, L, seed):
    """synth.site_stats_inputs, and for scaffolds shorter than its 40
    high-coverage positions plain random counts."""
    if L >= 40:
        return site_stats_inputs(M, L, seed)
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 90, (M, 4, L)).astype(np.int32),
            rng.integers(0, 5, L).astype(np.uint8))


def _cut(out, s, M, L):
    """Scaffold s of the batch outputs, cut to its true [M, L]."""
    def at(v):
        return np.asarray(v)[s]
    n_rows = int(at(out["rows"]["n_rows"]))
    n_pos = int(at(out["linkage"]["n_pos"]))
    res = {
        "rows": {k: at(v)[:n_rows] for k, v in out["rows"].items()
                 if k not in ("valid", "n_rows")},
        "agg": {k: at(v)[:M] for k, v in out["agg"].items()},
        "linkage": dict(pos=at(out["linkage"]["pos"])[:n_pos],
                        cum=at(out["linkage"]["cum"])[:M, :, :n_pos],
                        present=at(out["linkage"]["present"])[:M, :n_pos]),
        "masks": {k: at(v)[..., :L] for k, v in out["masks"].items()},
    }
    res["rows"]["n_rows"] = np.int64(n_rows)
    res["linkage"]["n_pos"] = np.int64(n_pos)
    return res


def jax_batch(scaffolds, null_lut, freq_lut):
    """site_stats_compact_batch of the JAX package over one chunk of
    (counts, ref, key) scaffolds, as its batch engine pads them, with
    capacities that hold every row and position. Returns ([per-scaffold
    {group: {name: array}}], Mp)."""
    import instrain_tpu  # noqa: F401  (x64 mode, as the package runs)
    from instrain_tpu.kernels.sitestats import site_stats_compact_batch
    from instrain_tpu.profile.pileup import _bucket
    Mp = max(max(_bucket(c.shape[0], 8), 8) for c, _, _ in scaffolds)
    Lp = max(max(_bucket(c.shape[2], 4096), 4096) for c, _, _ in scaffolds)
    S = len(scaffolds)
    counts = np.zeros((S, Mp, 4, Lp), np.int32)
    ref = np.full((S, Lp), 4, np.uint8)
    for s, (c, r, _) in enumerate(scaffolds):
        counts[s, :c.shape[0], :, :c.shape[2]] = c
        ref[s, :c.shape[2]] = r
    lens = np.array([c.shape[2] for c, _, _ in scaffolds], np.int32)
    keys = np.stack([k for _, _, k in scaffolds])
    out = site_stats_compact_batch(counts, ref, lens, null_lut, freq_lut,
                                   keys, min_cov=MIN_COV, min_covR=RAREFIED,
                                   rarefied_draws=RAREFIED,
                                   snp_capacity=Mp * Lp, pos_capacity=Lp)
    return ([_cut(out, s, c.shape[0], c.shape[2])
             for s, (c, _, _) in enumerate(scaffolds)], Mp)


def golden_arrays():
    """{name: array} of every chunk's inputs and JAX outputs."""
    import instrain_tpu  # noqa: F401
    from instrain_tpu.kernels.nullmodel import analytic_null_thresholds
    from instrain_tpu.kernels.sitestats import freq_min_count_lut
    from instrain_tpu.profile.compact import _fold_keys

    null_lut = analytic_null_thresholds(max_coverage=10000)
    freq_lut = freq_min_count_lut(0.05, max_coverage=10000)
    out = {"null_lut": null_lut, "freq_lut": freq_lut}
    for name, spec in CHUNKS.items():
        keys = _fold_keys(SEED, [rid for _, _, rid in spec])
        scaffolds = [make_inputs(M, L, rid) + (keys[s],)
                     for s, (M, L, rid) in enumerate(spec)]
        res, Mp = jax_batch(scaffolds, null_lut, freq_lut)
        out[f"{name}/m_stride"] = np.int64(Mp)
        for s, ((counts, ref, key), r) in enumerate(zip(scaffolds, res)):
            tag = f"{name}/{s}"
            out[f"{tag}/counts"] = counts
            out[f"{tag}/ref"] = ref
            out[f"{tag}/key"] = key
            for group, d in r.items():
                for k, v in d.items():
                    out[f"{tag}/{group}/{k}"] = np.asarray(v)
    return out


if __name__ == "__main__":
    os.makedirs(os.path.dirname(PATH), exist_ok=True)
    np.savez_compressed(PATH, **golden_arrays())
    print(PATH, os.path.getsize(PATH), "bytes")
