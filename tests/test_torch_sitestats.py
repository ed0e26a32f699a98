"""
The port's site statistics against the JAX package: the plain PyTorch
site_stats (and the kernel wrappers, which take it for CPU tensors)
against instrain_tpu's site_stats and its Pallas core (interpret mode),
Threefry and key derivation against JAX, the committed golden file
against a fresh JAX run, and — on a machine with an NVIDIA GPU — the CUDA
kernels against their plain versions.

Tolerances: integers, masks and codes exact; clon within 1e-6 absolute
(tests/test_pallas.py's bound); clonR bit for bit (the counter-based
draws and the f32 arithmetic order are reproduced exactly).
"""

import numpy as np
import pytest
import torch

import jax

from instrain_tpu.kernels import pallas_sitestats as JP
from instrain_tpu.kernels import sitestats as JS
from instrain_tpu.kernels.nullmodel import analytic_null_thresholds
from instrain_tpu.profile.compact import _fold_keys as jax_fold_keys
from instrain_tpu_torch.kernels import cuda_sitestats as C
from instrain_tpu_torch.kernels import sitestats as S
from instrain_tpu_torch.profile import compact as PC

import make_torch_golden as G

NULL_LUT = analytic_null_thresholds(max_coverage=10000)
FREQ_LUT = JS.freq_min_count_lut(0.05, max_coverage=10000)

CASES = [(M, L, seed) for seed in (0, 5, 11)
         for M, L in ((1, 700), (8, 1237), (5, 4096), (3, 8192))]


def _jax_site_stats(counts, ref, key, min_cov=5, draws=50):
    """JAX site_stats as the dense engine calls it (padded, sliced)."""
    M, _, L = counts.shape
    Mp = max(-(-M // 8) * 8, 8)
    Lp = max(-(-L // 4096) * 4096, 4096)
    cp = np.zeros((Mp, 4, Lp), np.int32)
    cp[:M, :, :L] = counts
    rp = np.full(Lp, 4, np.uint8)
    rp[:L] = ref
    out = JS.site_stats(cp, rp, NULL_LUT, FREQ_LUT, key, min_cov=min_cov,
                        min_covR=draws, rarefied_draws=draws)
    res = {}
    for k, v in out.items():
        v = np.asarray(v)
        if k == "bases_mask":
            v = v[:, :L]
        elif v.ndim == 3:
            v = v[:M, :, :L]
        elif v.ndim == 2:
            v = v[:M, :L]
        else:
            v = v[:L]
        res[k] = v
    return res, Mp


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _assert_same(expected, got, what=""):
    assert set(expected) == set(got), (what, set(expected) ^ set(got))
    for k in sorted(expected):
        a, b = np.asarray(expected[k]), np.asarray(got[k])
        assert a.dtype == b.dtype and a.shape == b.shape, (what, k, a.dtype,
                                                           b.dtype)
        if k == "clon":
            assert np.array_equal(np.isnan(a), np.isnan(b)), (what, k)
            d = np.abs(np.nan_to_num(a) - np.nan_to_num(b))
            assert d.max(initial=0) <= 1e-6, (what, k, d.max())
        elif a.dtype.kind == "f":      # clonR: bit for bit
            assert np.array_equal(a.view(np.uint32), b.view(np.uint32)), \
                (what, k)
        else:
            assert np.array_equal(a, b), (what, k)


@pytest.mark.parametrize("M,L,seed", CASES)
def test_site_stats_matches_jax(M, L, seed):
    counts, ref = G.make_inputs(M, L, seed)
    key = jax_fold_keys(100 + seed, [seed])[0]
    expected, Mp = _jax_site_stats(counts, ref, key)
    c, r, nl, fl = _torch(counts, ref, NULL_LUT, FREQ_LUT)
    plain = S.site_stats(c, r, nl, fl, key, min_cov=5, min_covR=50,
                         rarefied_draws=50, m_stride=Mp)
    _assert_same(expected, {k: v.numpy() for k, v in plain.items()},
                 "plain")
    # the kernel wrappers take the plain versions for CPU tensors
    C.reset_launch_counts()
    wrapped = C.site_stats(c, r, nl, fl, C.single_segment(L, key, c.device),
                           min_cov=5, min_covR=50, rarefied_draws=50,
                           m_stride=Mp)
    _assert_same(expected, {k: v.numpy() for k, v in wrapped.items()},
                 "wrapper")
    assert C.launch_counts() == {"site_stats": 0, "clonR": 0}
    assert np.isfinite(expected["clonR"]).any()     # draws were exercised


@pytest.mark.parametrize("M,L,seed", [(1, 1024, 2), (8, 1537, 3),
                                      (4, 2048, 4)])
def test_core_matches_pallas_interpret(M, L, seed):
    """The fields of the Pallas kernel's core (K1) against the port."""
    counts, ref = G.make_inputs(M, L, seed)
    tile = 512
    Lp = -(-L // tile) * tile
    cp = np.zeros((M, 4, Lp), np.int32)
    cp[:, :, :L] = counts
    rp = np.full(Lp, 4, np.uint8)
    rp[:L] = ref
    core = {k: np.asarray(v)[:, :L] for k, v in JP.pallas_site_stats(
        cp, rp, NULL_LUT, FREQ_LUT, min_cov=5, tile=tile,
        interpret=True).items()}
    c, r, nl, fl = _torch(counts, ref, NULL_LUT, FREQ_LUT)
    got = {k: v.numpy() for k, v in C.site_stats_core(
        c, r, nl, fl, min_cov=5, min_covR=50).items()}
    for k in ("total", "morphia", "con", "var", "cls"):
        assert np.array_equal(core[k].astype(np.int64),
                              got[k].astype(np.int64)), k
    # the Pallas core's row omits the present mask (its wrapper ANDs it in)
    assert np.array_equal(core["row"] & got["present"], got["row"])
    assert np.array_equal(np.isnan(core["clon"]), np.isnan(got["clon"]))
    d = np.abs(np.nan_to_num(core["clon"]) - np.nan_to_num(got["clon"]))
    assert d.max() <= 1e-6


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_threefry_matches_jax_and_numpy(seed):
    rng = np.random.default_rng(seed)
    k0, k1 = (int(x) for x in rng.integers(0, 2 ** 32, 2, dtype=np.uint64))
    x0 = rng.integers(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32)
    x1 = rng.integers(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32)
    j0, j1 = JS._threefry2x32(jax.numpy.uint32(k0), jax.numpy.uint32(k1),
                              jax.numpy.asarray(x0), jax.numpy.asarray(x1))
    t0, t1 = S._threefry2x32(k0, k1, torch.from_numpy(x0.astype(np.int64)),
                             torch.from_numpy(x1.astype(np.int64)))
    n0, n1 = PC._np_threefry2x32(k0, k1, x0, x1)
    assert np.array_equal(np.asarray(j0), t0.numpy().astype(np.uint32))
    assert np.array_equal(np.asarray(j1), t1.numpy().astype(np.uint32))
    assert np.array_equal(np.asarray(j0), n0)
    assert np.array_equal(np.asarray(j1), n1)
    # the uniform built from the first word
    ju = JS._ctr_uniform(jax.numpy.uint32(k0), jax.numpy.uint32(k1),
                         jax.numpy.asarray(x0), jax.numpy.asarray(x1))
    tu = S._ctr_uniform(k0, k1, torch.from_numpy(x0.astype(np.int64)),
                        torch.from_numpy(x1.astype(np.int64)))
    assert np.array_equal(np.asarray(ju).view(np.uint32),
                          tu.numpy().view(np.uint32))


@pytest.mark.parametrize("seed", [0, 42, 7919 * 3 + 42, 2 ** 33 + 5])
def test_fold_keys_matches_jax(seed):
    rids = [0, 1, 5, 127, 70000]
    got = PC._fold_keys(seed, rids)
    for i, rid in enumerate(rids):
        want = jax.random.key_data(
            jax.random.fold_in(jax.random.PRNGKey(seed), rid))
        assert np.array_equal(np.asarray(want, dtype=np.uint32), got[i])


def test_golden_file_is_current():
    """The committed golden file equals a fresh JAX run of its recipe."""
    fresh = G.golden_arrays()
    with np.load(G.PATH) as z:
        assert sorted(z.files) == sorted(fresh)
        for k in fresh:
            a, b = fresh[k], z[k]
            assert a.dtype == b.dtype and a.shape == b.shape, k
            if a.dtype.kind == "f":
                assert np.array_equal(a.view(np.uint32), b.view(np.uint32)), k
            else:
                assert np.array_equal(a, b), k


@pytest.mark.parametrize("M,L,seed", G.CASES)
def test_plain_matches_golden(M, L, seed):
    """What chip_smoke.py checks with the kernels, with the plain path."""
    tag = f"M{M}_L{L}"
    with np.load(G.PATH) as z:
        g = {k: z[k] for k in z.files}
    c, r, nl, fl = _torch(g[f"{tag}/counts"], g[f"{tag}/ref"],
                          g["null_lut"], g["freq_lut"])
    got = C.site_stats(c, r, nl, fl,
                       C.single_segment(L, g[f"{tag}/key"], c.device),
                       min_cov=G.MIN_COV, min_covR=G.RAREFIED,
                       rarefied_draws=G.RAREFIED,
                       m_stride=int(g[f"{tag}/m_stride"]))
    expected = {k.split("/")[-1]: v for k, v in g.items()
                if k.startswith(f"{tag}/out/")}
    _assert_same(expected, {k: v.numpy() for k, v in got.items()}, tag)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("M,L,seed", CASES)
def test_kernels_match_plain_on_gpu(M, L, seed, cuda_device):
    counts, ref = G.make_inputs(M, L, seed)
    key = PC._fold_keys(100 + seed, [seed])[0]
    Mp = max(-(-M // 8) * 8, 8)
    c, r, nl, fl = (t.to(cuda_device)
                    for t in _torch(counts, ref, NULL_LUT, FREQ_LUT))
    C.reset_launch_counts()
    got = C.site_stats(c, r, nl, fl, C.single_segment(L, key, c.device),
                       m_stride=Mp)
    torch.cuda.synchronize()
    assert C.launch_counts() == {"site_stats": 1, "clonR": 1}
    want = S.site_stats(c, r, nl, fl, key, m_stride=Mp)
    _assert_same({k: v.cpu().numpy() for k, v in want.items()},
                  {k: v.cpu().numpy() for k, v in got.items()}, "gpu")
