"""
Device linkage disequilibrium in plain PyTorch: the counterpart of
instrain_tpu/kernels/linkage.py:ld_device (:28-100) and _ld_math_jnp
(:103-120), with the same output dict, dtypes and values.

From the captured within-read SNV base pairs of one scaffold (edge index,
mm index and combo code b1 * 4 + b2 per pair) and the cumulative base
counts at each edge's two positions, it computes per (edge, mm level):
the combo counts cumulated over mm' <= mm, the major/minor alleles at
each end (a stable descending sort, ties in ACTG order), the gates, r2
and D', and their rarefied variants from `min_snp` categorical draws.

These are the plain versions the CUDA kernel (csrc/linkage.cu) is held
against. Every column is bit-identical to the JAX function as XLA's CPU
backend evaluates it, which takes three things:
  - linkD = fAB - fA * fB in r2, and linkd = fab - fa * fb, are
    single-rounding FMAs there (XLA contracts them); _fma64 reproduces
    that in f64. The sign test of D' (linkD > 0) is not: XLA computes
    linkD anew there with a rounded product, and where linkD is 0 exactly
    (fAB * fab = fAb * faB) the two differ in sign;
  - the rarefied frequencies are draws times the f64 reciprocal of
    min_snp (XLA rewrites the division by the constant);
  - the uniforms are jax.random.uniform(key, (Ep, Mp, min_snp), f64)
    under jax_threefry_partitionable: element (e, m, s) takes Threefry-2x32
    of its flat index (e * Mp + m) * min_snp + s split into (hi, lo)
    words, the two output words joined high first into 64 bits, shifted
    right by 12, ORed with the bits of 1.0, minus 1.0. The JAX caller pads
    the mm axis to Mp = ceil8(M); `m_stride` is that Mp. The padded edge
    count does not enter the counter, so nothing here is padded.
"""

from __future__ import annotations

from typing import Dict

import torch

from .sitestats import _M32, _threefry2x32, key_words

_ONE_BITS = 0x3FF0000000000000
_SPLIT = 134217729.0              # 2^27 + 1: Veltkamp's splitting constant


def _two_sum(a, b):
    """(s, e) with s = fl(a + b) and a + b = s + e exactly."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _two_prod(a, b):
    """(p, e) with p = fl(a * b) and a * b = p + e exactly (Dekker), for
    products far from overflow and underflow."""
    p = a * b

    def split(x):
        c = _SPLIT * x
        hi = c - (c - x)
        return hi, x - hi

    ah, al = split(a)
    bh, bl = split(b)
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _fma64(a, b, c):
    """Single-rounding f64 a * b + c (the CUDA kernel's __fma_rn) from
    f64 operations, for finite operands whose product is far from
    overflow and underflow (here: frequencies in [0, 2]).

    a * b + c = s + w + ew exactly, with s = fl(c + fl(a * b)), w the
    rounded sum of the two rounding errors and ew the error of that sum.
    fl(s + w) is then the correctly rounded result unless s + w lies
    exactly halfway between two doubles and ew is non-zero: ew then says
    on which side the true value lies."""
    p, ep = _two_prod(a, b)
    s, es = _two_sum(c, p)
    w, ew = _two_sum(es, ep)
    r, er = _two_sum(s, w)
    toward = torch.where(er > 0, torch.full_like(r, float("inf")),
                         torch.full_like(r, float("-inf")))
    nxt = torch.nextafter(r, toward)
    halfway = (er != 0) & (nxt - r == 2 * er)
    past = halfway & (ew != 0) & ((ew > 0) == (er > 0))
    return torch.where(past, nxt, r)


def ld_math(fAB, fAb, faB, fab):
    """r2 and D' from f64 haplotype frequencies (reference linkage.py:
    168-228), in the JAX function's operation order, with its FMAs."""
    fA = fAB + fAb
    fa = fab + faB
    fB = fAB + faB
    fb = fab + fAb
    nan = torch.full_like(fAB, float("nan"))
    linkD = _fma64(-fA, fB, fAB)
    r2 = torch.where((fa == 0) | (fA == 0) | (fB == 0) | (fb == 0), nan,
                     linkD * linkD / (fA * fa * fB * fb))
    linkd = _fma64(-fa, fb, fab)
    neg = linkd < 0
    d_prime = torch.where(neg, linkd / torch.maximum(-fA * fB, -fa * fb),
                          nan)
    d_prime = torch.where((fAB - fA * fB > 0) & ~neg,      # no FMA here
                          linkd / torch.minimum(fA * fb, fa * fB), d_prime)
    return r2, d_prime


def uniform64(key, E: int, M: int, S: int, m_stride: int, device=None):
    """[E, M, S] f64 uniforms in [0, 1): element (e, m, s) of
    jax.random.uniform(key, (Ep, m_stride, S), float64) for any Ep >= E."""
    k0, k1 = key_words(key)

    def ar(n):
        return torch.arange(n, dtype=torch.int64, device=device)

    ctr = (ar(E)[:, None, None] * m_stride + ar(M)[None, :, None]) * S + \
        ar(S)[None, None, :]
    o0, o1 = _threefry2x32(k0, k1, (ctr >> 32) & _M32, ctr & _M32)
    # (o0 << 32 | o1) >> 12, without a 64-bit logical shift
    mant = (o0 << 20) | (o1 >> 12)
    return (mant | _ONE_BITS).view(torch.float64) - 1.0


def ld_device(e_idx, mm_idx, combo, c1, c2, present1, present2, key,
              min_snp: int, m_stride: int) -> Dict[str, torch.Tensor]:
    """
    Args:
      e_idx, mm_idx, combo: int32 [N] — per captured pair its edge, its
        read pair's mm index and b1 * 4 + b2
      c1, c2: int32 [E, M, 4] cumulative base counts at each edge's two
        positions; present1, present2: bool [E, M] exact-mm presence
      key: uint32[2] key of the rarefied draws
      m_stride: the counter's mm extent (the JAX caller's ceil8(M))

    Returns the JAX function's dict of [E, M] arrays: valid (bool),
    AB/Ab/aB/ab/total (int32), A/a/B/b (int64 base codes), r2, d_prime,
    r2_normalized, d_prime_normalized (f64)."""
    E, M, _ = c1.shape
    dev = c1.device
    flat = (e_idx.to(torch.int64) * M + mm_idx.to(torch.int64)) * 16 + \
        combo.to(torch.int64)
    cnt = torch.zeros(E * M * 16, dtype=torch.int32, device=dev).index_add_(
        0, flat, torch.ones_like(flat, dtype=torch.int32)).view(E, M, 16)
    cumcombo = torch.cumsum(cnt, dim=1, dtype=torch.int32)

    both_present = present1 & present2
    sums_ok = (c1.sum(dim=2, dtype=torch.int32) +
               c2.sum(dim=2, dtype=torch.int32)) >= min_snp
    o1 = torch.argsort(-c1, dim=2, stable=True)
    o2 = torch.argsort(-c2, dim=2, stable=True)
    A, a_ = o1[:, :, 0], o1[:, :, 1]
    B, b_ = o2[:, :, 0], o2[:, :, 1]

    def take(c, idx):
        return torch.gather(c, 2, idx[:, :, None])[:, :, 0]

    nonzero_ok = ((take(c1, A) > 0) & (take(c1, a_) > 0) &
                  (take(c2, B) > 0) & (take(c2, b_) > 0))

    def combo_at(x, y):
        return take(cumcombo, x * 4 + y)

    AB, Ab = combo_at(A, B), combo_at(A, b_)
    aB, ab = combo_at(a_, B), combo_at(a_, b_)
    total = AB + Ab + aB + ab
    valid = (both_present & sums_ok & nonzero_ok & (total > min_snp) &
             (cnt.sum(dim=2) > 0))

    tot_f = total.clamp(min=1).to(torch.float64)
    fAB, fAb, faB, fab = (x.to(torch.float64) / tot_f
                          for x in (AB, Ab, aB, ab))
    r2, d_prime = ld_math(fAB, fAb, faB, fab)

    u = uniform64(key, E, M, min_snp, m_stride, dev)        # [E, M, S]
    cdf0 = fAB
    cdf1 = cdf0 + fAb
    cdf2 = cdf1 + faB
    cat = ((u > cdf0[:, :, None]).to(torch.int64) + (u > cdf1[:, :, None]) +
           (u > cdf2[:, :, None]))
    draws = torch.stack([(cat == k).sum(dim=2) for k in range(4)], dim=2)
    rf = draws.to(torch.float64) * (1.0 / min_snp)
    r2n, d_primen = ld_math(rf[:, :, 0], rf[:, :, 1], rf[:, :, 2],
                            rf[:, :, 3])
    return dict(valid=valid, AB=AB, Ab=Ab, aB=aB, ab=ab, total=total,
                A=A, a=a_, B=B, b=b_, r2=r2, d_prime=d_prime,
                r2_normalized=r2n, d_prime_normalized=d_primen)
