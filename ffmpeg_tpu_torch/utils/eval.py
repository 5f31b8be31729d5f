"""Arithmetic expression mini-language (the port's copy of
ffmpeg_tpu/utils/eval.py; analog of libavutil/eval.c).

Used everywhere option values may be expressions: filter args like
`scale=w=iw/2:h=-1`, rate-control equations, crop positions. Supports the
reference language's operators, SI number postfixes (eval.c av_strtod), the
core function set, named constants, user variables, and the st()/ld()
register file (10 slots, like eval.c).
"""

from __future__ import annotations

import math
import random as _random
from typing import Callable, Dict, Mapping, Optional

from .error import InvalidData

_SI = {
    "y": 1e-24, "z": 1e-21, "a": 1e-18, "f": 1e-15, "p": 1e-12,
    "n": 1e-9, "u": 1e-6, "m": 1e-3, "c": 1e-2, "d": 1e-1,
    "h": 1e2, "k": 1e3, "K": 1e3, "M": 1e6, "G": 1e9, "T": 1e12,
    "P": 1e15, "E": 1e18, "Z": 1e21, "Y": 1e24,
}

CONSTANTS = {
    "PI": math.pi,
    "E": math.e,
    "PHI": (1 + 5 ** 0.5) / 2,
    "QP2LAMBDA": 118,
    "NAN": math.nan,
    "INF": math.inf,
}


def _sgn(x):
    return (x > 0) - (x < 0)


class _Parser:
    def __init__(self, s: str, names: Mapping[str, float],
                 funcs: Mapping[str, Callable], state: list):
        self.s = s
        self.i = 0
        self.names = names
        self.funcs = funcs
        self.state = state

    # --- lexer helpers ------------------------------------------------------
    def _peek(self) -> str:
        return self.s[self.i] if self.i < len(self.s) else ""

    def _skip_ws(self):
        while self.i < len(self.s) and self.s[self.i] in " \t\n":
            self.i += 1

    def _accept(self, tok: str) -> bool:
        self._skip_ws()
        if self.s.startswith(tok, self.i):
            self.i += len(tok)
            return True
        return False

    def _expect(self, tok: str):
        if not self._accept(tok):
            raise InvalidData(f"expected {tok!r} at {self.s[self.i:self.i+16]!r}")

    # --- grammar: expr := term (('+'|'-') term)* ... --------------------------
    def parse_expr(self) -> float:
        v = self.parse_term()
        while True:
            if self._accept("+"):
                v = v + self.parse_term()
            elif self._peek() == "-" and not self.s.startswith("->", self.i):
                self.i += 1
                v = v - self.parse_term()
            else:
                return v

    def parse_term(self) -> float:
        v = self.parse_pow()
        while True:
            self._skip_ws()
            c = self._peek()
            if c == "*" and not self.s.startswith("**", self.i):
                self.i += 1
                v = v * self.parse_pow()
            elif c == "/":
                self.i += 1
                d = self.parse_pow()
                v = math.nan if d == 0 and v == 0 else (
                    math.inf * _sgn(v) if d == 0 else v / d)
            elif c == "%":
                self.i += 1
                d = self.parse_pow()
                v = math.fmod(v, d) if d else math.nan
            else:
                return v

    def parse_pow(self) -> float:
        v = self.parse_unary()
        self._skip_ws()
        if self._accept("^") or self._accept("**"):
            e = self.parse_pow()  # right assoc
            try:
                v = v ** e
            except (OverflowError, ValueError):
                v = math.nan
        return v

    def parse_unary(self) -> float:
        self._skip_ws()
        if self._accept("+"):
            return self.parse_unary()
        if self._accept("-"):
            return -self.parse_unary()
        if self._accept("!"):
            return float(self.parse_unary() == 0)
        return self.parse_primary()

    def parse_primary(self) -> float:
        self._skip_ws()
        c = self._peek()
        if c == "(":
            self.i += 1
            v = self.parse_expr()
            self._expect(")")
            return v
        if c.isdigit() or c == "." or (c == "0" and self.s.startswith("0x", self.i)):
            return self._number()
        # identifier
        j = self.i
        while j < len(self.s) and (self.s[j].isalnum() or self.s[j] in "_"):
            j += 1
        ident = self.s[self.i:j]
        if not ident:
            raise InvalidData(f"parse error at {self.s[self.i:self.i+16]!r}")
        self.i = j
        self._skip_ws()
        if self._peek() == "(":
            self.i += 1
            args = []
            self._skip_ws()
            if self._peek() != ")":
                args.append(self.parse_expr())
                while self._accept(","):
                    args.append(self.parse_expr())
            self._expect(")")
            return self._call(ident, args)
        if ident in self.names:
            return float(self.names[ident])
        if ident in CONSTANTS:
            return CONSTANTS[ident]
        raise InvalidData(f"unknown identifier {ident!r}")

    def _number(self) -> float:
        s = self.s
        i = self.i
        if s.startswith("0x", i) or s.startswith("0X", i):
            j = i + 2
            while j < len(s) and s[j] in "0123456789abcdefABCDEF":
                j += 1
            self.i = j
            return float(int(s[i:j], 16))
        j = i
        while j < len(s) and (s[j].isdigit() or s[j] in ".eE" or
                              (s[j] in "+-" and j > i and s[j - 1] in "eE")):
            j += 1
        val = float(s[i:j])
        # SI postfix (+ optional 'i' for binary, B for bytes→*8)
        if j < len(s) and s[j] in _SI:
            mult = _SI[s[j]]
            j += 1
            if j < len(s) and s[j] == "i":
                # binary: k->1024 etc.
                mult = 2 ** round(math.log2(mult) / math.log2(10) * math.log2(10))
                mult = {1e3: 2**10, 1e6: 2**20, 1e9: 2**30, 1e12: 2**40,
                        1e15: 2**50}.get(mult, mult)
                j += 1
            val *= mult
        if j < len(s) and s[j] == "B":
            val *= 8
            j += 1
        self.i = j
        return val

    def _call(self, name: str, a: list) -> float:
        st = self.state
        one = {
            "sin": math.sin, "cos": math.cos, "tan": math.tan,
            "asin": math.asin, "acos": math.acos, "atan": math.atan,
            "sinh": math.sinh, "cosh": math.cosh, "tanh": math.tanh,
            "exp": math.exp, "abs": abs,
            "floor": math.floor, "ceil": math.ceil, "trunc": math.trunc,
            "round": lambda x: math.floor(x + 0.5) if x >= 0 else math.ceil(x - 0.5),
            "sqrt": lambda x: math.sqrt(x) if x >= 0 else math.nan,
            "log": lambda x: math.log(x) if x > 0 else -math.inf if x == 0 else math.nan,
            "sgn": _sgn,
            "isnan": lambda x: float(math.isnan(x)),
            "isinf": lambda x: float(math.isinf(x)),
            "not": lambda x: float(x == 0),
            "squish": lambda x: 1 / (math.exp(4 * x) + 1),
            "gauss": lambda x: math.exp(-x * x / 2) / math.sqrt(2 * math.pi),
            "ld": lambda x: st[int(x) % len(st)],
            "random": lambda x: _random.random(),
        }
        if name in one:
            if len(a) != 1:
                raise InvalidData(f"{name}() takes 1 arg")
            return float(one[name](a[0]))
        two = {
            "mod": lambda x, y: math.fmod(x, y) if y else math.nan,
            "max": max, "min": min,
            "eq": lambda x, y: float(x == y),
            "gte": lambda x, y: float(x >= y),
            "gt": lambda x, y: float(x > y),
            "lte": lambda x, y: float(x <= y),
            "lt": lambda x, y: float(x < y),
            "pow": lambda x, y: x ** y,
            "atan2": math.atan2,
            "hypot": math.hypot,
            "bitand": lambda x, y: float(int(x) & int(y)),
            "bitor": lambda x, y: float(int(x) | int(y)),
            "gcd": lambda x, y: float(math.gcd(int(x), int(y))),
            "truncd": lambda x, y: math.trunc(x / y) * y if y else x,
        }
        if name in two:
            if len(a) != 2:
                raise InvalidData(f"{name}() takes 2 args")
            return float(two[name](a[0], a[1]))
        if name == "st":
            st[int(a[0]) % len(st)] = a[1]
            return a[1]
        if name == "if":
            return (a[1] if a[0] else (a[2] if len(a) > 2 else 0.0))
        if name == "ifnot":
            return (a[1] if not a[0] else (a[2] if len(a) > 2 else 0.0))
        if name == "clip":
            return min(max(a[0], a[1]), a[2])
        if name == "between":
            return float(a[1] <= a[0] <= a[2])
        if name == "lerp":
            return a[0] + (a[1] - a[0]) * a[2]
        if name in self.funcs:
            return float(self.funcs[name](*a))
        raise InvalidData(f"unknown function {name!r}")


def eval_expr(expr: str, names: Optional[Mapping[str, float]] = None,
              funcs: Optional[Mapping[str, Callable]] = None,
              state: Optional[list] = None) -> float:
    """Evaluate an expression string → float (av_expr_parse_and_eval)."""
    p = _Parser(str(expr), names or {}, funcs or {}, state if state is not None else [0.0] * 10)
    v = p.parse_expr()
    p._skip_ws()
    if p.i != len(p.s):
        raise InvalidData(f"trailing garbage in expression: {p.s[p.i:]!r}")
    return v


def strtod(s: str) -> float:
    """av_strtod: number with SI postfix."""
    return eval_expr(s)
