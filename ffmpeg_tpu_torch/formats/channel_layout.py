"""Channel layout algebra (the port's copy of
ffmpeg_tpu/formats/channel_layout.py; analog of
libavutil/channel_layout.{c,h}).

Native order bitmask layouts plus name parsing; drives the rematrix
(down/upmix) coefficient builder in resample/rematrix.py.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

from ..utils.error import InvalidData

# Channel ids (bit positions) — match AV_CHAN_* native order.
CHANNELS = [
    "FL", "FR", "FC", "LFE", "BL", "BR", "FLC", "FRC",
    "BC", "SL", "SR", "TC", "TFL", "TFC", "TFR", "TBL",
    "TBC", "TBR", "DL", "DR", "WL", "WR", "SDL", "SDR",
    "LFE2", "TSL", "TSR", "BFC", "BFL", "BFR",
]
_CH_INDEX = {name: i for i, name in enumerate(CHANNELS)}

_NAMED: Dict[str, int] = {}


def _mask(*names: str) -> int:
    m = 0
    for n in names:
        m |= 1 << _CH_INDEX[n]
    return m


_NAMED["mono"] = _mask("FC")
_NAMED["stereo"] = _mask("FL", "FR")
_NAMED["2.1"] = _mask("FL", "FR", "LFE")
_NAMED["3.0"] = _mask("FL", "FR", "FC")
_NAMED["3.0(back)"] = _mask("FL", "FR", "BC")
_NAMED["4.0"] = _mask("FL", "FR", "FC", "BC")
_NAMED["quad"] = _mask("FL", "FR", "BL", "BR")
_NAMED["quad(side)"] = _mask("FL", "FR", "SL", "SR")
_NAMED["3.1"] = _mask("FL", "FR", "FC", "LFE")
_NAMED["5.0"] = _mask("FL", "FR", "FC", "BL", "BR")
_NAMED["5.0(side)"] = _mask("FL", "FR", "FC", "SL", "SR")
_NAMED["4.1"] = _mask("FL", "FR", "FC", "LFE", "BC")
_NAMED["5.1"] = _mask("FL", "FR", "FC", "LFE", "BL", "BR")
_NAMED["5.1(side)"] = _mask("FL", "FR", "FC", "LFE", "SL", "SR")
_NAMED["6.0"] = _mask("FL", "FR", "FC", "BC", "SL", "SR")
_NAMED["6.1"] = _mask("FL", "FR", "FC", "LFE", "BC", "SL", "SR")
_NAMED["7.0"] = _mask("FL", "FR", "FC", "BL", "BR", "SL", "SR")
_NAMED["7.1"] = _mask("FL", "FR", "FC", "LFE", "BL", "BR", "SL", "SR")
_NAMED["7.1(wide)"] = _mask("FL", "FR", "FC", "LFE", "BL", "BR", "FLC", "FRC")
_NAMED["octagonal"] = _mask("FL", "FR", "FC", "BL", "BR", "BC", "SL", "SR")
_NAMED["downmix"] = _mask("DL", "DR")


@dataclass(frozen=True)
class ChannelLayout:
    """Native-order bitmask layout; unknown layouts carry only a count."""

    mask: int = 0
    _nb: int = 0  # for unspec layouts

    @property
    def nb_channels(self) -> int:
        return bin(self.mask).count("1") if self.mask else self._nb

    def channel_names(self) -> List[str]:
        if not self.mask:
            return [f"ch{i}" for i in range(self._nb)]
        return [CHANNELS[i] for i in range(len(CHANNELS)) if self.mask >> i & 1]

    def index_of(self, name: str) -> int:
        """Index of channel `name` within this layout's packed order."""
        bit = _CH_INDEX[name]
        if not (self.mask >> bit & 1):
            return -1
        return bin(self.mask & ((1 << bit) - 1)).count("1")

    def has(self, name: str) -> bool:
        return bool(self.mask >> _CH_INDEX[name] & 1)

    def describe(self) -> str:
        for n, m in _NAMED.items():
            if m == self.mask and self.mask:
                return n
        if self.mask:
            return "+".join(self.channel_names())
        return f"{self._nb} channels"

    @staticmethod
    def from_string(s) -> "ChannelLayout":
        if isinstance(s, ChannelLayout):
            return s
        if isinstance(s, int):
            return default_layout(s)
        s = str(s).strip()
        if s in _NAMED:
            return ChannelLayout(_NAMED[s])
        if s.endswith("c") and s[:-1].isdigit():
            return default_layout(int(s[:-1]))
        if s.isdigit():
            return default_layout(int(s))
        if "+" in s or s in _CH_INDEX:
            m = 0
            for part in s.split("+"):
                if part not in _CH_INDEX:
                    raise InvalidData(f"unknown channel {part!r}")
                m |= 1 << _CH_INDEX[part]
            return ChannelLayout(m)
        raise InvalidData(f"unknown channel layout {s!r}")

    @staticmethod
    def unspec(n: int) -> "ChannelLayout":
        return ChannelLayout(0, n)


def default_layout(nb: int) -> ChannelLayout:
    """av_channel_layout_default: canonical layout for a channel count."""
    by_count = {1: "mono", 2: "stereo", 3: "3.0", 4: "4.0", 5: "5.0",
                6: "5.1", 7: "6.1", 8: "7.1"}
    if nb in by_count:
        return ChannelLayout(_NAMED[by_count[nb]])
    return ChannelLayout.unspec(nb)


MONO = ChannelLayout(_NAMED["mono"])
STEREO = ChannelLayout(_NAMED["stereo"])
SURROUND_5_1 = ChannelLayout(_NAMED["5.1"])
