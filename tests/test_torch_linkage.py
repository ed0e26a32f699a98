"""
The port's device linkage (K6) against the JAX package: the plain
PyTorch ld_device (and the kernel wrapper, which takes it for CPU
tensors) against instrain_tpu.kernels.linkage.ld_device on padded random
inputs, every column bit for bit, the rarefied ones included; the f64
FMA and the uniforms it is built from; calculate_linkage(engine="device")
against the JAX package's on a synthetic scaffold and on one of many mm
levels; the auto engine rule; the committed golden file against a fresh
JAX run; the kernel's grid planner, its one-buffer output layout, the
call site's one-buffer input staging and the kernel's tiled mm scan
rendered in numpy; and — on a machine with an NVIDIA GPU — the ld kernel
against its plain version, one launch a call.

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
from instrain_tpu_torch.io.bgzf import bam_header, write_bgzf
from instrain_tpu_torch.synth import (BASES, _scaffold_records, ld_inputs,
                                      synth)

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


@pytest.fixture(scope="module")
def many_mm_scaffold(tmp_path_factory):
    """One 20 kb scaffold at 300x read from a strain that differs from the
    reference at 3.5 % of its positions, at random: a read pair carries
    some 10 mismatches, more or fewer, so the pairs spread over many mm
    levels."""
    d = tmp_path_factory.mktemp("many_mm")
    rng = np.random.default_rng(31)
    L = 20_000
    ref = BASES[rng.integers(0, 4, L)]
    strain = ref.copy()
    pos = np.nonzero(rng.random(L) < 0.035)[0]
    strain[pos] = BASES[(np.searchsorted(BASES, ref[pos]) +
                         rng.integers(1, 4, len(pos))) % 4]
    fasta, bam = str(d / "many.fasta"), str(d / "many.bam")
    with open(fasta, "w") as f:
        f.write(f">scaf_0\n{ref.tobytes().decode()}\n")
    write_bgzf(bam, bam_header([("scaf_0", L)]) + _scaffold_records(
        rng, 0, strain, L, L, 0, truth=ref))
    return fasta, bam


def test_calculate_linkage_device_many_mm_levels(many_mm_scaffold):
    """The device engine (its one-copy staging and one-buffer unpacking
    on the CPU) against the JAX package's where the pairs spread over many
    mm levels, two buckets of the counter's padded mm extent."""
    fasta, bam = many_mm_scaffold
    js, ps = _hybrid_stats(fasta, bam)
    assert len(ps.mm_values) >= 9
    ws = PL.window_starts_for(ps.L)
    want = JL.calculate_linkage(js, ws, min_snp=5, seed=4, engine="device")
    got = PL.calculate_linkage(ps, ws, min_snp=5, seed=4, engine="device")
    assert len(got) >= 10 and got["mm"].nunique() >= 5
    pd.testing.assert_frame_equal(want, got, check_exact=True)


def test_device_ld_args_stage_one_buffer(deep_scaffold, monkeypatch):
    """_device_ld_args makes one copy of one buffer: its seven tensors are
    views of it at multiples of 128 bytes, equal to the arrays they come
    from."""
    fasta, bam = deep_scaffold
    _, ps = _hybrid_stats(fasta, bam)
    ws = PL.window_starts_for(ps.L)
    pairs = PL.capture_read_pairs(ps, ws)
    key = pairs[:, 0] * (1 << 32) + pairs[:, 1]
    uedges, e_idx = np.unique(key, return_inverse=True)
    p1, p2 = uedges >> 32, uedges & 0xFFFFFFFF
    M = len(ps.mm_values)
    copies = []
    monkeypatch.setattr(PL, "_copy_to_device",
                        lambda host, dev: copies.append(host) or host)
    args = PL._device_ld_args(ps, pairs, e_idx, M, p1, p2, 20, 3, "cpu")
    assert len(copies) == 1
    buf = copies[0]
    c1, pr1 = PL._gather_pos_stats(ps, p1)
    c2, pr2 = PL._gather_pos_stats(ps, p2)
    want = [(e_idx, np.int32), (pairs[:, 4], np.int32),
            (pairs[:, 2] * 4 + pairs[:, 3], np.int32), (c1, np.int32),
            (c2, np.int32), (pr1, np.bool_), (pr2, np.bool_)]
    for t, (a, dt) in zip(args[:7], want):
        assert t.untyped_storage().data_ptr() == buf.data_ptr()
        assert (t.data_ptr() - buf.data_ptr()) % PL._STAGE_ALIGN == 0
        assert t.is_contiguous()
        assert_same(np.asarray(a, dtype=dt), t, "staged input")
    assert args[8:] == (20, -(-M // 8) * 8)
    np.testing.assert_array_equal(args[7],
                                  PC._fold_keys(3, [ps.pileup.rid])[0])


@pytest.mark.parametrize("E,M", [(1, 1), (83, 5), (40, 9), (7, 33)])
def test_ld_layout_roundtrip(E, M):
    """The plain version's outputs packed into ld's one buffer and read
    back: every column's dtype, shape and values, each column starting at
    a multiple of LD_ALIGN bytes."""
    inputs = _t(ld_inputs(E, M, 40 * E, E))
    want = CL.ld_plain(*inputs, PC._fold_keys(1, [E])[0], 7, -(-M // 8) * 8)
    cols, n = CL.ld_layout(E * M)
    assert [c for c, _, _ in cols] == [c for c, _ in CL.LD_COLUMNS]
    assert sorted(want) == sorted(c for c, _ in CL.LD_COLUMNS)
    assert all(off % CL.LD_ALIGN == 0 for _, _, off in cols)
    assert n % CL.LD_ALIGN == 0 and n >= cols[-1][2] + E * M
    buf = CL.pack_ld(want, E, M)
    assert buf.dtype == torch.uint8 and buf.numel() == n
    got = CL.unpack_ld(buf, E, M)
    assert sorted(got) == sorted(want)
    for (name, dt, off), (cname, cdt) in zip(cols, CL.LD_COLUMNS):
        t = got[name]
        assert t.dtype == dt == cdt and tuple(t.shape) == (E, M)
        assert t.untyped_storage().data_ptr() == buf.data_ptr()
        assert t.storage_offset() * t.element_size() == off
        assert_same(want[name].numpy(), t, name)


@pytest.mark.parametrize("E,M,N,min_snp,sms,per_sm,want", [
    # E * M = 1: one edge, every block adding pairs
    (1, 1, 30, 20, 132, 2, (264, 1, 0, 64)),
    # one edge a block, then two
    (264, 5, 1000, 20, 132, 2, (264, 1, 0, 264 * 5 * 64)),
    (265, 5, 1000, 20, 132, 2, (264, 2, 0, 265 * 5 * 64)),
    # draws made ahead from 256 pairs a block on
    (5000, 12, 264 * 256 - 1, 20, 132, 2, (264, 19, 0, 5000 * 12 * 64)),
    (5000, 12, 264 * 256, 20, 132, 2, (264, 19, 39, 5000 * 12 * 64)),
    # ... bounded by the pairs a block adds (3 draws each)
    (5000, 12, 150_000, 20, 132, 2, (264, 19, 86, 5000 * 12 * 64)),
    # ... by shared memory (64 KB of 4-byte words, min_snp a cell)
    (50_000, 8, 4_000_000, 20, 132, 2, (264, 190, 819, 50_000 * 8 * 64)),
    (50_000, 8, 4_000_000, 2, 132, 2, (264, 190, 1520, 50_000 * 8 * 64)),
    # ... by the block's cells
    (83, 5, 132_840, 20, 132, 2, (264, 1, 5, 83 * 5 * 64)),
    # no pairs: nothing drawn ahead
    (10, 3, 0, 20, 132, 2, (264, 1, 0, 10 * 3 * 64)),
    # another card
    (1000, 4, 50_000, 7, 16, 3, (48, 21, 84, 1000 * 4 * 64)),
])
def test_ld_plan(E, M, N, min_snp, sms, per_sm, want):
    plan = CL.ld_plan(E, M, N, min_snp, sms, per_sm)
    assert tuple(plan) == want
    grid, epb, pre, _ = plan
    assert grid == sms * per_sm
    assert grid * epb >= E > grid * (epb - 1)      # every edge, no idle row
    assert 0 <= pre <= epb * M
    assert pre * min_snp * 4 <= CL.LD_PRE_SMEM
    assert pre == 0 or N >= grid * CL.LD_THREADS


def _tile_scan(hist, E, M, lo_e, hi_e, threads=256, warp=32):
    """The cumulative combo counts of cells [lo_e * M, hi_e * M) as
    csrc/linkage.cu:ld_block forms them: tiles of `threads` cells, a
    segmented scan over each warp's lanes (lane - d in the same edge
    exactly when its level m >= d), the warps' last lanes and the tile's
    last cell carried through shared memory (double-buffered by tile)."""
    lo, hi = lo_e * M, hi_e * M
    out = np.zeros((hi - lo, 16), np.int64)
    last = np.zeros((2, threads // warp, 16), np.int64)
    tail = np.zeros((2, 16), np.int64)
    buf = 0
    for base in range(lo, hi, threads):
        cell = base + np.arange(threads)
        active = cell < hi
        e = np.where(active, cell // M, -1)
        m = np.where(active, cell % M, 0)
        h = np.zeros((threads, 16), np.int64)
        h[active] = hist[cell[active]]
        lane = np.arange(threads) % warp
        d = 1
        while d < warp and d < M:
            up = np.roll(h.reshape(-1, warp, 16), d, axis=1).reshape(h.shape)
            take = (lane >= d) & (m >= d)
            h = h + np.where(take[:, None], up, 0)
            d <<= 1
        last[buf] = h.reshape(-1, warp, 16)[:, -1]
        for w in range(threads // warp):
            r = slice(w * warp, (w + 1) * warp)
            if m[w * warp] == 0:
                continue
            e_first, start = e[w * warp], e[w * warp] * M
            c = np.zeros(16, np.int64)
            k = w - 1
            while k >= 0:
                c += last[buf][k]
                if base + warp * k <= start:
                    break
                k -= 1
            if k < 0:
                c += tail[buf ^ 1]
            h[r] += np.where((e[r] == e_first)[:, None], c, 0)
        tail[buf] = h[-1]
        out[cell[active] - lo] = h[active]
        buf ^= 1
    return out


@pytest.mark.parametrize("E,M,lo_e,hi_e", [
    (40, 8, 0, 40),      # edges within warps
    (30, 5, 3, 30),      # edges across warps
    (4, 33, 0, 4),       # an edge across warps and tiles of 32
    (2, 300, 0, 2),      # edges across tiles
    (9, 97, 2, 9),       # across warps and tiles, not from edge 0
    (1, 1, 0, 1), (700, 1, 0, 700)])
def test_tile_scan_is_the_mm_prefix(E, M, lo_e, hi_e):
    """ld_block's tiled segmented scan, rendered in numpy, equals each
    edge's cumulative sum over its mm levels."""
    rng = np.random.default_rng(E * M)
    hist = rng.integers(0, 5, (E * M, 16))
    want = np.cumsum(hist.reshape(E, M, 16), axis=1)[lo_e:hi_e]
    got = _tile_scan(hist, E, M, lo_e, hi_e)
    np.testing.assert_array_equal(got.reshape(hi_e - lo_e, M, 16), want)


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
@pytest.mark.parametrize("E,M,N,min_snp", [
    (1, 1, 30, 20), (300, 5, 20000, 20), (5000, 12, 150000, 20),
    (64, 33, 9000, 7), (50_000, 8, 4_000_000, 20),
    # one tile a block and two on the H100's grid of 396 blocks
    (12_672, 8, 1_013_760, 20), (12_673, 8, 1_013_840, 20)])
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
