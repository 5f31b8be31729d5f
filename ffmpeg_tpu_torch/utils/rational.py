"""Rational numbers for time bases and frame rates, and timestamp
rescaling (the port's copy of ffmpeg_tpu/utils/rational.py; analog of
libavutil/rational.h and mathematics.c).  Python ints
are arbitrary precision, so no INT64 overflow handling is needed; the
rounding modes are the reference's (libavutil/mathematics.h:79-94)."""

from __future__ import annotations

import fractions
import math
from dataclasses import dataclass
from enum import IntEnum


class Rounding(IntEnum):
    """Rounding modes, matching libavutil/mathematics.h:79-94."""

    ZERO = 0        # toward zero
    INF = 1         # away from zero
    DOWN = 2        # toward -inf
    UP = 3          # toward +inf
    NEAR_INF = 5    # nearest, halfway away from zero
    PASS_MINMAX = 8192  # flag: pass NOPTS / INT64_MIN/MAX through untouched


# Sentinel matching AV_NOPTS_VALUE (libavutil/avutil.h).
NOPTS = -(2**63)
INT64_MAX = 2**63 - 1
INT64_MIN = -(2**63)


@dataclass(frozen=True, slots=True)
class Rational:
    """A rational number num/den (reference: libavutil/rational.h:58)."""

    num: int = 0
    den: int = 1

    def __post_init__(self):
        object.__setattr__(self, "num", int(self.num))
        object.__setattr__(self, "den", int(self.den))

    @staticmethod
    def from_float(value: float, max_den: int = 1 << 30) -> "Rational":
        """av_d2q (rational.c): nearest rational with bounded denominator."""
        if math.isnan(value):
            return Rational(0, 0)
        if math.isinf(value):
            return Rational(-1 if value < 0 else 1, 0)
        frac = fractions.Fraction(value).limit_denominator(max_den)
        return Rational(frac.numerator, frac.denominator)

    def reduce(self) -> "Rational":
        """Normalize sign and reduce by gcd (av_reduce, rational.c:35)."""
        n, d = self.num, self.den
        if d == 0:
            return Rational(0 if n == 0 else (1 if n > 0 else -1), 0)
        if d < 0:
            n, d = -n, -d
        g = math.gcd(n, d)
        if g:
            n //= g
            d //= g
        return Rational(n, d)

    def __mul__(self, other: "Rational") -> "Rational":
        return Rational(self.num * other.num, self.den * other.den).reduce()

    def __truediv__(self, other: "Rational") -> "Rational":
        return Rational(self.num * other.den, self.den * other.num).reduce()

    def __add__(self, other: "Rational") -> "Rational":
        return Rational(
            self.num * other.den + other.num * self.den, self.den * other.den
        ).reduce()

    def __sub__(self, other: "Rational") -> "Rational":
        return Rational(
            self.num * other.den - other.num * self.den, self.den * other.den
        ).reduce()

    def __float__(self) -> float:
        if self.den == 0:
            return math.inf if self.num > 0 else (-math.inf if self.num
                                                  else math.nan)
        return self.num / self.den

    def __bool__(self) -> bool:
        return self.num != 0

    def inv(self) -> "Rational":
        return Rational(self.den, self.num)

    def __repr__(self) -> str:  # pragma: no cover
        return f"{self.num}/{self.den}"

    def cmp(self, other: "Rational") -> int:
        """av_cmp_q: -1, 0 or 1."""
        a = self.num * other.den
        b = other.num * self.den
        s = self.den * other.den
        if s == 0:
            raise ZeroDivisionError("comparing rationals with zero "
                                    "denominator")
        diff = (a - b) * (1 if s > 0 else -1)
        return (diff > 0) - (diff < 0)

    def __lt__(self, other: "Rational") -> bool:
        return self.cmp(other) < 0

    def __le__(self, other: "Rational") -> bool:
        return self.cmp(other) <= 0


# Common timebases.
TIME_BASE = 1000000  # AV_TIME_BASE
TIME_BASE_Q = Rational(1, TIME_BASE)


def _div_round(a: int, b: int, rnd: Rounding) -> int:
    """Integer a/b with an explicit rounding mode (b > 0)."""
    mode = Rounding(rnd & ~Rounding.PASS_MINMAX)
    if mode == Rounding.ZERO:
        q = abs(a) // b
        return -q if a < 0 else q
    if mode == Rounding.INF:
        q = (abs(a) + b - 1) // b
        return -q if a < 0 else q
    if mode == Rounding.DOWN:
        return a // b  # python floordiv == toward -inf
    if mode == Rounding.UP:
        return -((-a) // b)
    if mode == Rounding.NEAR_INF:
        # nearest; halfway cases away from zero (mathematics.c av_rescale_rnd)
        q = (2 * abs(a) + b) // (2 * b)
        return -q if a < 0 else q
    raise ValueError(f"bad rounding mode {rnd}")


def rescale_rnd(a: int, b: int, c: int,
                rnd: Rounding = Rounding.NEAR_INF) -> int:
    """a * b / c with rounding (av_rescale_rnd, mathematics.c:58)."""
    if c <= 0 or b < 0:
        raise ValueError("rescale_rnd: invalid b/c")
    if (rnd & Rounding.PASS_MINMAX) and a in (INT64_MIN, INT64_MAX, NOPTS):
        return a
    return _div_round(a * b, c, rnd)


def rescale(a: int, b: int, c: int) -> int:
    """av_rescale: a*b/c rounded to nearest, halfway away from zero."""
    return rescale_rnd(a, b, c, Rounding.NEAR_INF)


def rescale_q_rnd(a: int, bq: Rational, cq: Rational,
                  rnd: Rounding = Rounding.NEAR_INF) -> int:
    """av_rescale_q_rnd: convert timestamp a from timebase bq to cq."""
    return rescale_rnd(a, bq.num * cq.den, cq.num * bq.den, rnd)


def rescale_q(a: int, bq: Rational, cq: Rational) -> int:
    return rescale_q_rnd(a, bq, cq, Rounding.NEAR_INF)


def compare_ts(ts_a: int, tb_a: Rational, ts_b: int, tb_b: Rational) -> int:
    """av_compare_ts (mathematics.c:147): -1, 0 or 1, the order of two
    timestamps in different time bases, exact."""
    a = ts_a * tb_a.num * tb_b.den
    b = ts_b * tb_b.num * tb_a.den
    return (a > b) - (a < b)


def gcd_q(a: Rational, b: Rational, max_den: int = 1 << 30) -> Rational:
    """av_gcd_q-style: gcd of two rationals (used for timebase merging)."""
    g = math.gcd(a.num * b.den, b.num * a.den)
    return Rational(g, a.den * b.den).reduce()
