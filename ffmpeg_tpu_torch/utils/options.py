"""Introspectable option system (the port's copy of
ffmpeg_tpu/utils/options.py; analog of AVOption/AVClass,
libavutil/opt.h:68-208).

Every configurable context (codec, demuxer, filter, scaler...) declares a
table of typed Options. Values are settable from strings (CLI parity with
`-opt value` / `opt=value` filter args) or natively. Numeric options accept
the eval expression mini-language (libavutil/eval.c analog in utils/eval.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Callable, Dict, Optional, Sequence

from .error import InvalidData, NotSupported, OptionNotFound
from .rational import Rational
from . import eval as _eval


class OptType(Enum):
    FLAGS = "flags"
    INT = "int"
    INT64 = "int64"
    DOUBLE = "double"
    FLOAT = "float"
    STRING = "string"
    RATIONAL = "rational"
    BOOL = "bool"
    CONST = "const"          # named constant for an INT/FLAGS option
    IMAGE_SIZE = "image_size"
    PIXEL_FMT = "pixel_fmt"
    SAMPLE_FMT = "sample_fmt"
    VIDEO_RATE = "video_rate"
    DURATION = "duration"
    COLOR = "color"
    CHLAYOUT = "channel_layout"
    DICT = "dict"


@dataclass(frozen=True)
class Option:
    name: str
    help: str = ""
    type: OptType = OptType.INT
    default: Any = None
    min: float = float("-inf")
    max: float = float("inf")
    unit: Optional[str] = None   # groups CONSTs with their option
    aliases: Sequence[str] = ()


def opt_int(name, help="", default=0, min=float("-inf"), max=float("inf"), unit=None):
    return Option(name, help, OptType.INT, default, min, max, unit)


def opt_float(name, help="", default=0.0, min=float("-inf"), max=float("inf")):
    return Option(name, help, OptType.DOUBLE, default, min, max)


def opt_str(name, help="", default=None):
    return Option(name, help, OptType.STRING, default)


def opt_bool(name, help="", default=False):
    return Option(name, help, OptType.BOOL, default)


def opt_rational(name, help="", default=Rational(0, 1)):
    return Option(name, help, OptType.RATIONAL, default)


def opt_const(name, value, unit, help=""):
    return Option(name, help, OptType.CONST, value, unit=unit)


_TRUE = {"1", "true", "yes", "on"}
_FALSE = {"0", "false", "no", "off"}


def _parse_video_size(s: str) -> tuple[int, int]:
    abbrevs = {
        "ntsc": (720, 480), "pal": (720, 576), "qcif": (176, 144),
        "cif": (352, 288), "4cif": (704, 576), "qvga": (320, 240),
        "vga": (640, 480), "svga": (800, 600), "xga": (1024, 768),
        "hd480": (852, 480), "hd720": (1280, 720), "hd1080": (1920, 1080),
        "2k": (2048, 1080), "4k": (4096, 2160), "uhd2160": (3840, 2160),
        "uhd4320": (7680, 4320),
    }
    if s.lower() in abbrevs:
        return abbrevs[s.lower()]
    w, _, h = s.partition("x")
    return int(w), int(h)


def _parse_duration(s: str) -> int:
    """Parse [-][HH:]MM:SS[.m...] or [-]S+[.m...][s|ms|us] → microseconds
    (av_parse_time analog)."""
    s = s.strip()
    neg = s.startswith("-")
    if neg:
        s = s[1:]
    mult = 1_000_000
    for suffix, m in (("ms", 1_000), ("us", 1), ("s", 1_000_000)):
        if s.endswith(suffix):
            s = s[: -len(suffix)]
            mult = m
            break
    if ":" in s:
        parts = s.split(":")
        if len(parts) == 2:
            total = int(parts[0]) * 60 + float(parts[1])
        elif len(parts) == 3:
            total = int(parts[0]) * 3600 + int(parts[1]) * 60 + float(parts[2])
        else:
            raise InvalidData(f"bad duration {s!r}")
        value = int(round(total * 1_000_000))
    else:
        value = int(round(float(s) * mult))
    return -value if neg else value


class OptionsMixin:
    """Mixin giving a context a typed, string-settable option table.

    Subclasses declare `OPTIONS: Sequence[Option]`. Values land as plain
    attributes (snake_case) so hot-path code reads `self.width` directly.
    """

    OPTIONS: Sequence[Option] = ()

    def init_options(self, **overrides) -> None:
        self._opt_table: Dict[str, Option] = {}
        self._consts: Dict[str, Dict[str, Any]] = {}
        for o in type(self).mro_options():
            if o.type is OptType.CONST:
                self._consts.setdefault(o.unit or "", {})[o.name] = o.default
                continue
            self._opt_table[o.name] = o
            for a in o.aliases:
                self._opt_table[a] = o
            setattr(self, o.name.replace("-", "_"), o.default)
        for k, v in overrides.items():
            self.set_option(k, v)

    @classmethod
    def mro_options(cls):
        seen = set()
        out = []
        for klass in cls.__mro__:
            for o in getattr(klass, "OPTIONS", ()):
                if o.name not in seen:
                    seen.add(o.name)
                    out.append(o)
        return out

    def option_names(self):
        return list(self._opt_table)

    def set_option(self, name: str, value: Any) -> None:
        """av_opt_set: accepts native values or strings for any option."""
        table = getattr(self, "_opt_table", None)
        if table is None:
            self.init_options()
            table = self._opt_table
        o = table.get(name)
        if o is None:
            raise OptionNotFound(f"option {name!r} not found on {type(self).__name__}")
        setattr(self, o.name.replace("-", "_"), self._convert(o, value))

    def set_options(self, opts: Dict[str, Any]) -> None:
        for k, v in opts.items():
            self.set_option(k, v)

    def get_option(self, name: str) -> Any:
        o = self._opt_table.get(name)
        if o is None:
            raise OptionNotFound(name)
        return getattr(self, o.name.replace("-", "_"))

    # --- conversion ---------------------------------------------------------
    def _convert(self, o: Option, v: Any) -> Any:
        if v is None:
            return None
        consts = self._consts.get(o.unit or "", {}) if o.unit else {}
        if o.type in (OptType.INT, OptType.INT64, OptType.FLAGS):
            if isinstance(v, str):
                if v in consts:
                    v = consts[v]
                elif o.type is OptType.FLAGS and ("+" in v or "-" in v):
                    acc = 0
                    for tok in v.replace("-", "+-").split("+"):
                        if not tok:
                            continue
                        neg = tok.startswith("-")
                        tok = tok.lstrip("-")
                        bit = consts.get(tok)
                        if bit is None:
                            bit = int(tok, 0)
                        acc = acc & ~bit if neg else acc | bit
                    v = acc
                else:
                    v = int(_eval.eval_expr(v))
            v = int(v)
            self._check_range(o, v)
            return v
        if o.type in (OptType.DOUBLE, OptType.FLOAT):
            if isinstance(v, str):
                v = consts.get(v, None) if v in consts else _eval.eval_expr(v)
            v = float(v)
            self._check_range(o, v)
            return v
        if o.type is OptType.BOOL:
            if isinstance(v, str):
                lv = v.lower()
                if lv in _TRUE:
                    return True
                if lv in _FALSE:
                    return False
                if lv == "auto":
                    return None
                raise InvalidData(f"bad bool {v!r} for option {o.name}")
            return bool(v)
        if o.type is OptType.STRING:
            return str(v)
        if o.type is OptType.RATIONAL or o.type is OptType.VIDEO_RATE:
            if isinstance(v, Rational):
                return v
            if isinstance(v, (int, float)):
                return Rational.from_float(float(v))
            s = str(v)
            rates = {"ntsc": Rational(30000, 1001), "pal": Rational(25, 1),
                     "film": Rational(24, 1), "ntsc-film": Rational(24000, 1001)}
            if s in rates:
                return rates[s]
            if "/" in s:
                n, d = s.split("/")
                return Rational(int(n), int(d))
            if ":" in s:
                n, d = s.split(":")
                return Rational(int(n), int(d))
            return Rational.from_float(float(s))
        if o.type is OptType.IMAGE_SIZE:
            if isinstance(v, (tuple, list)):
                return (int(v[0]), int(v[1]))
            return _parse_video_size(str(v))
        if o.type is OptType.DURATION:
            if isinstance(v, (int, float)):
                return int(v)
            return _parse_duration(str(v))
        if o.type is OptType.PIXEL_FMT:
            from ..formats import pixfmt
            return pixfmt.get(v).name if not isinstance(v, str) else v
        if o.type is OptType.SAMPLE_FMT:
            return str(v)
        if o.type is OptType.COLOR:
            # the reference imports a `color_names` module it does not
            # have, so a colour option raises there too; no filter of
            # either package declares one (drawbox, colorkey, chromakey
            # and color take their colour as a string)
            raise NotSupported(f"colour option {o.name}: not ported")
        if o.type is OptType.CHLAYOUT:
            return v
        if o.type is OptType.DICT:
            if isinstance(v, dict):
                return dict(v)
            out = {}
            for kv in str(v).split(":"):
                if kv:
                    k, _, val = kv.partition("=")
                    out[k] = val
            return out
        raise InvalidData(f"unhandled option type {o.type}")

    def _check_range(self, o: Option, v: float) -> None:
        if not (o.min <= v <= o.max):
            raise InvalidData(
                f"value {v} for option {o.name} out of range [{o.min}, {o.max}]"
            )
