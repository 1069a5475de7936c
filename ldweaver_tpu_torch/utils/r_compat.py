"""R-compatible numerics needed for output parity with the reference.

The reference pipeline's rankings depend on several R-specific numeric
behaviours (SURVEY.md section 7 "hard parts"):
  * stats::quantile type-7 (R/computePairwiseMI.R:354,422; R/lr_analyser.R:72)
  * base R's Mersenne-Twister RNG + set.seed scrambling + the "Rejection"
    sample() algorithm (R/computePairwiseMI.R:95-96, set.seed(1988))
  * stats::optim Nelder-Mead ("nmmin") as used by fitdistrplus::fitdist
    for the Beta background fit (R/computePairwiseMI.R:452)

These are independent re-implementations of the published algorithms (R's
documented quantile types; Matsumoto-Nishimura MT19937; Nelder-Mead 1965 as
parameterised by R's optim defaults) - no code is taken from R.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence, Tuple

import numpy as np


# --------------------------------------------------------------------------
# stats::quantile type 7 (the R default)
# --------------------------------------------------------------------------
def quantile_type7(x: np.ndarray, probs) -> np.ndarray:
    """R stats::quantile(x, probs) with the default type=7.

    h = (n-1)p; q = x[floor(h)] + (h - floor(h)) * (x[floor(h)+1] - x[floor(h)])
    """
    x = np.sort(np.asarray(x, dtype=np.float64))
    probs_arr = np.atleast_1d(np.asarray(probs, dtype=np.float64))
    n = x.size
    if n == 0:
        raise ValueError("quantile of empty vector")
    if n == 1:
        out = np.full(probs_arr.shape, x[0])
    else:
        h = (n - 1) * probs_arr
        lo = np.floor(h).astype(np.int64)
        lo = np.clip(lo, 0, n - 1)
        hi = np.clip(lo + 1, 0, n - 1)
        out = x[lo] + (h - lo) * (x[hi] - x[lo])
    if np.isscalar(probs) or np.asarray(probs).ndim == 0:
        return float(out[0])
    return out


# --------------------------------------------------------------------------
# base R RNG: MT19937 with R's set.seed scrambling + sample() (Rejection)
# --------------------------------------------------------------------------
_N = 624
_M = 397
_MATRIX_A = 0x9908B0DF
_UPPER_MASK = 0x80000000
_LOWER_MASK = 0x7FFFFFFF


class RRandomState:
    """Base R's default RNG stream: set.seed(seed) + Mersenne-Twister.

    R scrambles the user seed through the LCG `seed = seed*69069 + 1`
    (once as the initial scramble, then once per state word) before filling
    the MT19937 state; unif_rand() then applies a fixup keeping values in
    (0, 1).  This replicates the documented behaviour of R's RNG.c so that
    the seeded LR-link subsample (R/computePairwiseMI.R:95-96) matches.
    """

    def __init__(self, seed: int):
        seed = seed & 0xFFFFFFFF
        # Initial scramble (R RNG.c Randomize): 50 LCG iterations
        for _ in range(50):
            seed = (69069 * seed + 1) & 0xFFFFFFFF
        # R fills 625 words; the first lands in the (discarded) mti slot
        seed = (69069 * seed + 1) & 0xFFFFFFFF
        # Fill MT state, one LCG step per word
        self.mt = np.zeros(_N + 1, dtype=np.uint64)  # mt[0] is mti counter slot
        state = np.zeros(_N, dtype=np.uint64)
        for j in range(_N):
            seed = (69069 * seed + 1) & 0xFFFFFFFF
            state[j] = seed
        self._state = state
        self._mti = _N  # forces regeneration on first draw
        # R calls FixupSeeds: for MT it ensures mti in range and
        # that the state is not all zero; our scrambled state never is.

    def _genrand(self) -> int:
        mt = self._state
        if self._mti >= _N:
            mag01 = (0, _MATRIX_A)
            for kk in range(_N - _M):
                y = (int(mt[kk]) & _UPPER_MASK) | (int(mt[kk + 1]) & _LOWER_MASK)
                mt[kk] = int(mt[kk + _M]) ^ (y >> 1) ^ mag01[y & 1]
            for kk in range(_N - _M, _N - 1):
                y = (int(mt[kk]) & _UPPER_MASK) | (int(mt[kk + 1]) & _LOWER_MASK)
                mt[kk] = int(mt[kk + (_M - _N)]) ^ (y >> 1) ^ mag01[y & 1]
            y = (int(mt[_N - 1]) & _UPPER_MASK) | (int(mt[0]) & _LOWER_MASK)
            mt[_N - 1] = int(mt[_M - 1]) ^ (y >> 1) ^ mag01[y & 1]
            self._mti = 0
        y = int(mt[self._mti])
        self._mti += 1
        y ^= y >> 11
        y ^= (y << 7) & 0x9D2C5680
        y &= 0xFFFFFFFF
        y ^= (y << 15) & 0xEFC60000
        y &= 0xFFFFFFFF
        y ^= y >> 18
        return y

    def unif_rand(self) -> float:
        """MT draw in [0,1) with R's fixup into (0,1)."""
        u = self._genrand() * 2.3283064365386963e-10  # 1/2^32
        # R fixup: ensure in (0, 1)
        if u <= 0.0:
            return 0.5 * 2.328306437080797e-10
        if 1.0 - u <= 0.0:
            return 1.0 - 0.5 * 2.328306437080797e-10
        return u

    # ---- R_unif_index + sample() without replacement (Rejection) -------
    def _rbits(self, bits: int) -> int:
        v = 0
        n = 0
        while n <= bits:
            v1 = int(math.floor(self.unif_rand() * 65536))
            v = 65536 * v + v1
            n += 16
        return v & ((1 << bits) - 1)

    def unif_index(self, dn: float) -> float:
        if dn <= 0:
            return 0.0
        bits = int(math.ceil(math.log2(dn)))
        while True:
            dv = float(self._rbits(bits))
            if dv < dn:
                return dv

    def sample_int(self, n: int, size: int) -> np.ndarray:
        """R sample(n, size) without replacement, sample.kind="Rejection".

        Mirrors R's do_sample non-hashed path: partial Fisher-Yates driven
        by R_unif_index.
        """
        x = np.arange(n, dtype=np.int64)
        out = np.empty(size, dtype=np.int64)
        navail = n
        for i in range(size):
            j = int(self.unif_index(navail))
            navail -= 1
            out[i] = x[j] + 1  # 1-based like R
            x[j] = x[navail]
        return out


# --------------------------------------------------------------------------
# R optim() Nelder-Mead (nmmin), as used by fitdistrplus -> stats::optim
# --------------------------------------------------------------------------
def nmmin(
    fn: Callable[[np.ndarray], float],
    x0: Sequence[float],
    abstol: float = -np.inf,
    reltol: float = 1.490116119384766e-08,  # sqrt(.Machine$double.eps)
    alpha: float = 1.0,
    beta: float = 0.5,
    gamma: float = 2.0,
    maxit: int = 500,
) -> Tuple[np.ndarray, float, int]:
    """Nelder-Mead with R optim()'s defaults and simplex construction.

    Re-implementation of the classic Nelder-Mead (1965) simplex method with
    the parameterisation and stopping rule R's optim uses (reltol-based
    convergence check `VH <= VL + reltol*(|VL| + reltol)`, initial simplex
    step 0.1*max(|x0_i|, 0.1)).  Returns (xmin, fmin, fail_flag).
    """
    x0 = np.asarray(x0, dtype=np.float64)
    n = x0.size
    f0 = fn(x0)
    if not np.isfinite(f0):
        raise ValueError("function cannot be evaluated at initial parameters")

    big = 1.0e35
    # simplex: n+1 points
    P = np.empty((n + 1, n), dtype=np.float64)
    V = np.empty(n + 1, dtype=np.float64)
    P[0] = x0
    V[0] = f0
    # R's initial step: size = 0.1 * max(|x0_i|) over nonzero, min 0.1
    size = 0.0
    for i in range(n):
        size = max(size, 0.1 * abs(x0[i]))
    if size == 0.0:
        size = 0.1
    for i in range(n):
        P[i + 1] = x0
        P[i + 1, i] = x0[i] + size
        v = fn(P[i + 1])
        V[i + 1] = v if np.isfinite(v) else big

    funcount = n + 1
    while True:
        # order: find lowest VL and highest VH
        L = int(np.argmin(V))
        H = int(np.argmax(V))
        VL, VH = V[L], V[H]
        conv = VH <= VL + reltol * (abs(VL) + reltol)
        if conv or VL <= abstol or funcount >= maxit:
            break
        # centroid of all but worst
        cent = (P.sum(axis=0) - P[H]) / n
        # reflect
        xr = cent + alpha * (cent - P[H])
        fr = fn(xr)
        fr = fr if np.isfinite(fr) else big
        funcount += 1
        if fr < VL:
            # try expansion
            xe = cent + gamma * (xr - cent)
            fe = fn(xe)
            fe = fe if np.isfinite(fe) else big
            funcount += 1
            if fe < fr:
                P[H], V[H] = xe, fe
            else:
                P[H], V[H] = xr, fr
        elif fr < VH:
            P[H], V[H] = xr, fr
            # R performs an additional contraction check when the
            # reflected point is still the worst; covered below on next
            # iteration via standard NM behaviour.
            # If xr is still worst, contract:
            if fr >= np.max(np.delete(V, H)):
                xc = cent + beta * (P[H] - cent)
                fc = fn(xc)
                fc = fc if np.isfinite(fc) else big
                funcount += 1
                if fc < V[H]:
                    P[H], V[H] = xc, fc
        else:
            # contraction toward the better side
            xc = cent + beta * (P[H] - cent)
            fc = fn(xc)
            fc = fc if np.isfinite(fc) else big
            funcount += 1
            if fc < VH:
                P[H], V[H] = xc, fc
            else:
                # shrink toward best
                for i in range(n + 1):
                    if i != L:
                        P[i] = P[L] + beta * (P[i] - P[L])
                        v = fn(P[i])
                        V[i] = v if np.isfinite(v) else big
                funcount += n

    L = int(np.argmin(V))
    fail = 0 if V.max() <= V[L] + reltol * (abs(V[L]) + reltol) else 1
    return P[L].copy(), float(V[L]), fail


# --------------------------------------------------------------------------
# Accurate log survival of the Beta distribution (R pbeta(..., log.p=TRUE))
# --------------------------------------------------------------------------
def _log_betainc_cf(x: float, a: float, b: float) -> float:
    """log of the regularised incomplete beta I_x(a,b) for x < (a+1)/(a+b+2),
    via the standard continued fraction (Lentz), computed so the log never
    underflows.  Used to build an accurate log-sf."""
    if x <= 0.0:
        return -np.inf
    if x >= 1.0:
        return 0.0
    log_prefactor = (
        math.lgamma(a + b)
        - math.lgamma(a)
        - math.lgamma(b)
        + a * math.log(x)
        + b * math.log1p(-x)
        - math.log(a)
    )
    # Lentz continued fraction for betacf(a,b,x)
    tiny = 1e-300
    qab, qap, qam = a + b, a + 1.0, a - 1.0
    c = 1.0
    d = 1.0 - qab * x / qap
    if abs(d) < tiny:
        d = tiny
    d = 1.0 / d
    h = d
    for m in range(1, 400):
        m2 = 2 * m
        aa = m * (b - m) * x / ((qam + m2) * (a + m2))
        d = 1.0 + aa * d
        if abs(d) < tiny:
            d = tiny
        c = 1.0 + aa / c
        if abs(c) < tiny:
            c = tiny
        d = 1.0 / d
        h *= d * c
        aa = -(a + m) * (qab + m) * x / ((a + m2) * (qap + m2))
        d = 1.0 + aa * d
        if abs(d) < tiny:
            d = tiny
        c = 1.0 + aa / c
        if abs(c) < tiny:
            c = tiny
        d = 1.0 / d
        delta = d * c
        h *= delta
        if abs(delta - 1.0) < 3e-16:
            break
    return log_prefactor + math.log(abs(h))


def _log_beta_sf_scalar(xi: float, a: float, b: float) -> float:
    if xi <= 0.0:
        return 0.0
    if xi >= 1.0:
        return -np.inf
    # sf = I_{1-x}(b, a)
    y = 1.0 - xi
    if y < (b + 1.0) / (a + b + 2.0):
        return _log_betainc_cf(y, b, a)
    # sf = 1 - I_x(a,b); compute cdf via CF and log1p(-cdf)
    log_cdf = _log_betainc_cf(xi, a, b)
    cdf = math.exp(min(log_cdf, 0.0))
    if cdf < 1.0:
        return math.log1p(-cdf)
    return -np.inf


def log_beta_sf(x, a: float, b: float):
    """log P(X > x) for X ~ Beta(a, b), accurate far into the tail.

    Equivalent to R's pbeta(x, a, b, lower.tail=FALSE, log.p=TRUE)
    (used for srp, R/computePairwiseMI.R:453).  Vectorised through
    scipy.special.betainc; elements whose survival would underflow float64
    fall back to a log-space continued fraction.
    """
    from scipy.special import betainc as _betainc

    xs = np.atleast_1d(np.asarray(x, dtype=np.float64))
    out = np.zeros_like(xs)
    inside = (xs > 0.0) & (xs < 1.0)
    out[xs >= 1.0] = -np.inf
    if inside.any():
        sf = _betainc(b, a, 1.0 - xs[inside])  # I_{1-x}(b,a) = sf
        with np.errstate(divide="ignore"):
            vals = np.log(sf)
        tiny = sf < 1e-290
        if tiny.any():
            xin = xs[inside]
            idx = np.flatnonzero(tiny)
            for k in idx:
                vals[k] = _log_beta_sf_scalar(float(xin[k]), a, b)
        out[inside] = vals
    if np.isscalar(x) or np.asarray(x).ndim == 0:
        return float(out[0])
    return out


def beta_loglik(x: np.ndarray, a: float, b: float) -> float:
    """sum log dbeta(x; a, b) (for the fitdistrplus-style MLE)."""
    if a <= 0.0 or b <= 0.0:
        return -np.inf
    n = x.size
    const = n * (math.lgamma(a + b) - math.lgamma(a) - math.lgamma(b))
    return const + (a - 1.0) * np.log(x).sum() + (b - 1.0) * np.log1p(-x).sum()


def fit_beta_mle(x: np.ndarray) -> Tuple[float, float]:
    """Beta MLE with fitdistrplus defaults: moment-matching start values
    (population variance), then Nelder-Mead on the negative log-likelihood
    (fitdistrplus::fitdist(x, "beta") -> mledist -> optim,
    R/computePairwiseMI.R:452)."""
    x = np.asarray(x, dtype=np.float64)
    n = x.size
    m = x.mean()
    v = (n - 1) / n * x.var(ddof=1) if n > 1 else 1e-4
    if v <= 0:
        v = 1e-8
    aux = m * (1.0 - m) / v - 1.0
    start = np.array([m * aux, (1.0 - m) * aux], dtype=np.float64)
    if not np.all(np.isfinite(start)) or np.any(start <= 0):
        start = np.array([1.0, 1.0])

    # the beta log-likelihood depends on the data only through
    # sum(log x) and sum(log1p(-x)): hoist them out of the optimizer loop
    # (bit-identical to beta_loglik per evaluation — same sums, same
    # expression — but O(1) instead of O(n) per Nelder-Mead step; at the
    # 131k-SNP production scale the residual pool is ~1e7 values and the
    # per-iteration O(n) eval dominated the whole background model)
    slx = np.log(x).sum()
    sl1x = np.log1p(-x).sum()

    def nll(p):
        a, b = float(p[0]), float(p[1])
        if a <= 0.0 or b <= 0.0:
            return np.inf
        const = n * (math.lgamma(a + b) - math.lgamma(a) - math.lgamma(b))
        ll = const + (a - 1.0) * slx + (b - 1.0) * sl1x
        return -ll if np.isfinite(ll) else np.inf

    # R optim default maxit for Nelder-Mead is 500
    popt, _, _ = nmmin(nll, start, maxit=500)
    return float(popt[0]), float(popt[1])
