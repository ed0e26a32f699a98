"""
The port's device linkage (K6) against the JAX package: the plain
PyTorch ld_device (and the kernel wrapper, which takes it for CPU
tensors) against instrain_tpu.kernels.linkage.ld_device on padded random
inputs, every column bit for bit, the rarefied ones included; the f64
FMA and the uniforms it is built from; calculate_linkage(engine="device")
against the JAX package's on a synthetic scaffold; the auto engine rule;
the committed golden file against a fresh JAX run; and — on a machine
with an NVIDIA GPU — the ld kernel against its plain version.

Tolerances: none. Float columns are compared by their bits, with every
NaN equal to every NaN (XLA and the card may write different NaN
payloads, and the tables print NaN as an empty field). Host against
device engine: every column but the rarefied ones within 1e-12, as in
tests/test_linkage_device.py (the device engine contracts two products
into FMAs).
"""

from fractions import Fraction

import numpy as np
import pandas as pd
import pytest
import torch

import jax  # noqa: F401  (the JAX package runs on the CPU here)
import jax.numpy as jnp

from instrain_tpu.config import ReadFilterConfig as JaxFilterConfig
from instrain_tpu.io.bam import decode_bam as jax_decode
from instrain_tpu.kernels.nullmodel import analytic_null_thresholds
from instrain_tpu.kernels.sitestats import freq_min_count_lut
from instrain_tpu.profile import compact as JC
from instrain_tpu.profile import filter_reads as JF
from instrain_tpu.profile import linkage as JL
from instrain_tpu.profile import pileup as JPU
from instrain_tpu_torch.config import ReadFilterConfig
from instrain_tpu_torch.io.bam import decode_bam as port_decode
from instrain_tpu_torch.kernels import cuda_linkage as CL
from instrain_tpu_torch.kernels import linkage as KL
from instrain_tpu_torch.profile import compact as PC
from instrain_tpu_torch.profile import filter_reads as PF
from instrain_tpu_torch.profile import linkage as PL
from instrain_tpu_torch.profile import pileup as PPU
from instrain_tpu_torch.synth import ld_inputs, synth

import make_torch_linkage_golden as G

NULL_LUT = analytic_null_thresholds(max_coverage=10000)
FREQ_LUT = freq_min_count_lut(0.05, max_coverage=10000)


def assert_same(want, got, what):
    """Bit for bit, every NaN equal to every NaN."""
    a = np.asarray(want)
    b = got.cpu().numpy() if isinstance(got, torch.Tensor) else \
        np.asarray(got)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype,
                                                       b.dtype)
    if a.dtype.kind == "f":
        nan = np.isnan(a)
        assert np.array_equal(nan, np.isnan(b)), what
        u = f"u{a.itemsize}"
        assert np.array_equal(a[~nan].view(u), b[~nan].view(u)), what
    else:
        assert np.array_equal(a, b), what


def _t(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("E,M,N,min_snp,seed", [
    (200, 5, 12000, 20, 11), (30, 9, 4000, 7, 12), (64, 1, 3000, 20, 13),
    (5, 16, 800, 3, 14)])
def test_plain_ld_matches_jax(E, M, N, min_snp, seed):
    inputs = ld_inputs(E, M, N, seed)
    key = PC._fold_keys(5, [seed])[0]
    want, Mp = G.jax_ld(inputs, key, min_snp)
    CL.reset_launch_counts()
    got = CL.ld(*_t(inputs), key, min_snp, Mp)
    assert CL.launch_counts() == {"ld": 0}    # CPU tensors: plain version
    assert set(want) == set(got)
    for k in want:
        assert_same(want[k], got[k], k)
    assert want["valid"].sum() > 0


def test_fma64_is_single_rounding():
    """_fma64 against the exact rational value rounded once, on the
    frequency quotients the linkage math feeds it, with ties."""
    rng = np.random.default_rng(4)
    n = 4000
    tot = rng.integers(1, 300, n).astype(np.float64)
    a, b, c = (rng.integers(0, 300, n) / tot for _ in range(3))
    a[:50], b[:50], c[:50] = 0.5, 0.5, 0.25          # exact: c - a * b = 0
    got = KL._fma64(*_t((-a, b, c))).numpy()
    want = np.array([float(Fraction(-x) * Fraction(y) + Fraction(z))
                     for x, y, z in zip(a, b, c)])
    assert np.array_equal(got.view(np.uint64), want.view(np.uint64))


def test_uniform64_matches_jax_random():
    key = PC._fold_keys(9, [3])[0]
    want = np.asarray(jax.random.uniform(key, (37, 16, 20),
                                         dtype=jnp.float64))
    got = KL.uniform64(key, 30, 11, 20, 16).numpy()
    assert_same(want[:30, :11], got, "uniforms")


@pytest.fixture(scope="module")
def deep_scaffold(tmp_path_factory):
    """One 6 kb scaffold at 400x: some 900 captured pairs."""
    d = tmp_path_factory.mktemp("deep")
    fasta, bam, _ = synth(str(d), S=1, L=6000, COV=400, seed=21)
    return fasta, bam


def _ref_codes(fasta):
    from instrain_tpu_torch.io import fasta as fasta_io
    reg = fasta_io.ScaffoldRegistry.from_fasta(fasta)
    return reg.codes[reg.names[0]]


def _hybrid_stats(fasta, bam):
    ref = _ref_codes(fasta)
    out = []
    for decode, filt, pu_mod, cfg, comp in (
            (jax_decode, JF, JPU, JaxFilterConfig(), JC),
            (port_decode, PF, PPU, ReadFilterConfig(), PC)):
        b = decode(bam, baq=False)
        pairs = filt.filter_reads(b, cfg)
        pu = pu_mod.build_scaffold_pileup(b, pairs, 0, len(ref))
        out.append(comp.run_site_stats_hybrid(pu, ref, NULL_LUT, FREQ_LUT,
                                              seed=3))
    return out


def test_calculate_linkage_device_matches_jax(deep_scaffold):
    fasta, bam = deep_scaffold
    js, ps = _hybrid_stats(fasta, bam)
    ws = PL.window_starts_for(ps.L)
    assert len(PL.capture_read_pairs(ps, ws)) > 500
    want = JL.calculate_linkage(js, ws, seed=3, engine="device")
    got = PL.calculate_linkage(ps, ws, seed=3, engine="device")
    assert len(got) >= 10
    pd.testing.assert_frame_equal(want, got, check_exact=True)
    # the host engine: the same rows; every column but the rarefied ones
    # within 1e-12
    host = PL.calculate_linkage(ps, ws, seed=3, engine="host")
    pd.testing.assert_frame_equal(
        JL.calculate_linkage(js, ws, seed=3, engine="host"), host,
        check_exact=True)
    assert len(host) == len(got)
    for col in got.columns:
        if col in ("r2_normalized", "d_prime_normalized"):
            continue
        if got[col].dtype.kind == "f":
            np.testing.assert_allclose(host[col], got[col], rtol=1e-12,
                                       atol=1e-12)
        else:
            assert (host[col].values == got[col].values).all(), col


def test_auto_linkage_engine_rule(deep_scaffold, monkeypatch):
    """auto: the device engine on a CUDA device from DEVICE_MIN_PAIRS
    captured pairs on, the host engine below it and on the CPU — the rule
    of instrain_tpu/profile/linkage.py:135-138, which the port did not
    follow before (it always ran the host engine)."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    bound = PL.DEVICE_MIN_PAIRS
    assert bound == 100_000
    assert PL.resolve_linkage_engine("auto", cuda, bound) == "device"
    assert PL.resolve_linkage_engine("auto", cuda, bound - 1) == "host"
    assert PL.resolve_linkage_engine("auto", cpu, 10 * bound) == "host"
    assert PL.resolve_linkage_engine("auto", None, 10 * bound) == "host"
    assert PL.resolve_linkage_engine("device", cpu, 1) == "device"
    assert PL.resolve_linkage_engine("host", cuda, 10 * bound) == "host"
    with pytest.raises(ValueError):
        PL.resolve_linkage_engine("gpu", cuda, 1)
    # calculate_linkage follows it: with the bound below this scaffold's
    # pair count, a CUDA device takes the device path
    fasta, bam = deep_scaffold
    _, ps = _hybrid_stats(fasta, bam)
    ws = PL.window_starts_for(ps.L)
    n = len(PL.capture_read_pairs(ps, ws))
    calls = []
    monkeypatch.setattr(PL, "_calculate_linkage_device",
                        lambda *a: calls.append(a[-1]) or pd.DataFrame())
    monkeypatch.setattr(PL, "DEVICE_MIN_PAIRS", n)
    PL.calculate_linkage(ps, ws, engine="auto", device=cuda)
    assert calls == [cuda]
    PL.calculate_linkage(ps, ws, engine="auto", device=cpu)
    monkeypatch.setattr(PL, "DEVICE_MIN_PAIRS", n + 1)
    PL.calculate_linkage(ps, ws, engine="auto", device=cuda)
    assert calls == [cuda]


def _golden():
    with np.load(G.PATH) as z:
        return {k: z[k] for k in z.files}


def test_linkage_golden_is_current():
    """The committed golden file equals a fresh JAX run of its recipe."""
    fresh = G.golden_arrays()
    g = _golden()
    assert sorted(g) == sorted(fresh)
    for k in fresh:
        assert_same(fresh[k], g[k], k)


@pytest.mark.parametrize("case", G.CASES, ids=lambda c: f"E{c[0]}_M{c[1]}")
def test_plain_matches_linkage_golden(case):
    """What chip_smoke.py checks with the kernel, with the plain path."""
    g = _golden()
    tag = f"E{case[0]}_M{case[1]}"
    got = CL.ld(*[torch.from_numpy(g[f"{tag}/{k}"]) for k in G.INPUTS],
                g[f"{tag}/key"], int(g[f"{tag}/min_snp"]),
                int(g[f"{tag}/m_stride"]))
    for k, v in got.items():
        assert_same(g[f"{tag}/out/{k}"], v, k)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("E,M,N,min_snp", [(1, 1, 30, 20), (300, 5, 20000, 20),
                                           (5000, 12, 150000, 20),
                                           (64, 33, 9000, 7)])
def test_ld_kernel_matches_plain_on_gpu(E, M, N, min_snp, cuda_device):
    inputs = [t.to(cuda_device) for t in _t(ld_inputs(E, M, N, E + M))]
    key = PC._fold_keys(2, [E])[0]
    Mp = -(-M // 8) * 8
    CL.reset_launch_counts()
    got = CL.ld(*inputs, key, min_snp, Mp)
    torch.cuda.synchronize()
    assert CL.launch_counts() == {"ld": 1}
    want = CL.ld_plain(*inputs, key, min_snp, Mp)
    for k in want:
        assert_same(want[k].cpu().numpy(), got[k], k)
