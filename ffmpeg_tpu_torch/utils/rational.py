"""Rational numbers for time bases and frame rates (the port's copy of
the part of ffmpeg_tpu/utils/rational.py it uses; analog of
libavutil/rational.h).  Python ints are arbitrary precision, so no
INT64 overflow handling is needed."""

from __future__ import annotations

import math
from dataclasses import dataclass

# Sentinel matching AV_NOPTS_VALUE (libavutil/avutil.h).
NOPTS = -(2**63)


@dataclass(frozen=True, slots=True)
class Rational:
    """A rational number num/den (reference: libavutil/rational.h:58)."""

    num: int = 0
    den: int = 1

    def __post_init__(self):
        object.__setattr__(self, "num", int(self.num))
        object.__setattr__(self, "den", int(self.den))

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
