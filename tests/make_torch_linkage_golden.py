"""
Golden outputs of the JAX package's device linkage kernel (K6) for the
port's ld kernel.

tests/data/torch_linkage_golden.npz holds, for each case below, the
inputs (synth.ld_inputs: captured pairs, cumulative counts and presence
of E edges over M mm levels; the key; min_snp) and what
instrain_tpu.kernels.linkage.ld_device returns for them on the CPU, the
way instrain_tpu/profile/linkage.py:_calculate_linkage_device calls it
(pairs padded to a power of two >= 1024 with e_idx = -1, edges to a power
of two >= 256, mm levels to ceil8(M)), cut to [E, M]: every column,
the rarefied ones included. chip_smoke.py holds the CUDA kernel against
it bit for bit on a machine without jax; tests/test_torch_linkage.py
regenerates it in memory and asserts the committed file is unchanged.

    JAX_PLATFORMS=cpu python tests/make_torch_linkage_golden.py
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from instrain_tpu_torch.synth import ld_inputs  # noqa: E402

PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "torch_linkage_golden.npz")

# (E, M, N, min_snp, seed): a few hundred edges over five levels; more
# levels than one padded bucket of 8 with a small min_snp; one edge and
# one level
CASES = [(300, 5, 20000, 20, 1), (40, 9, 5000, 7, 2), (1, 1, 40, 20, 3)]
INPUTS = ("e_idx", "mm_idx", "combo", "c1", "c2", "present1", "present2")


def _pow2_at_least(n, lo):
    cap = lo
    while cap < n:
        cap <<= 1
    return cap


def jax_ld(inputs, key, min_snp):
    """ld_device of the JAX package as its device linkage engine pads and
    calls it, cut to the true [E, M]."""
    import instrain_tpu  # noqa: F401  (x64 mode, as the package runs)
    from instrain_tpu.kernels.linkage import ld_device
    e_idx, mm_idx, combo, c1, c2, p1, p2 = inputs
    E, M, _ = c1.shape
    n = len(e_idx)
    cap = _pow2_at_least(n, 1024)
    Ep = _pow2_at_least(E, 256)
    Mp = -(-M // 8) * 8
    ei = np.full(cap, -1, np.int32)
    mi = np.zeros(cap, np.int32)
    cb = np.zeros(cap, np.int32)
    ei[:n], mi[:n], cb[:n] = e_idx, mm_idx, combo

    def padEM(a):
        out = np.zeros((Ep, Mp) + a.shape[2:], a.dtype)
        out[:E, :M] = a
        return out

    out = ld_device(ei, mi, cb, np.int64(n), padEM(c1), padEM(c2),
                    padEM(p1), padEM(p2), key, E=Ep, M=Mp,
                    min_snp=int(min_snp))
    return {k: np.asarray(v)[:E, :M] for k, v in out.items()}, Mp


def golden_arrays():
    """{name: array} of every case's inputs and JAX outputs."""
    import instrain_tpu  # noqa: F401
    from instrain_tpu.profile.compact import _fold_keys

    out = {}
    for E, M, N, min_snp, seed in CASES:
        inputs = ld_inputs(E, M, N, seed)
        key = _fold_keys(42, [seed])[0]
        res, Mp = jax_ld(inputs, key, min_snp)
        tag = f"E{E}_M{M}"
        for k, v in zip(INPUTS, inputs):
            out[f"{tag}/{k}"] = v
        out[f"{tag}/key"] = key
        out[f"{tag}/min_snp"] = np.int64(min_snp)
        out[f"{tag}/m_stride"] = np.int64(Mp)
        for k, v in res.items():
            out[f"{tag}/out/{k}"] = v
    return out


if __name__ == "__main__":
    os.makedirs(os.path.dirname(PATH), exist_ok=True)
    np.savez_compressed(PATH, **golden_arrays())
    print(PATH, os.path.getsize(PATH), "bytes")
