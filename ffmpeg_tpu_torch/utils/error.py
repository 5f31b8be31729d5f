"""Exceptions the port raises (its own copy of ffmpeg_tpu/utils/error.py's
classes; analog of libavutil/error.h).

The send/receive encode API signals EAGAIN and EOF with TryAgain and
EndOfStream, as avcodec.h documents them.
"""

from __future__ import annotations


class FFTPUError(Exception):
    """Base class for framework errors."""


class TryAgain(FFTPUError):
    """AVERROR(EAGAIN): the operation needs more input / output drained."""


class EndOfStream(FFTPUError):
    """AVERROR_EOF: no more data will ever be produced."""


class InvalidData(FFTPUError):
    """AVERROR_INVALIDDATA: bitstream corrupt or unsupported."""


class BugError(FFTPUError):
    """AVERROR_BUG: internal invariant violated."""


class NotSupported(FFTPUError):
    """AVERROR(ENOSYS)/PATCHWELCOME: feature not (yet) implemented."""


class DecoderNotFound(FFTPUError):
    pass


class EncoderNotFound(FFTPUError):
    pass


class DemuxerNotFound(FFTPUError):
    pass


class MuxerNotFound(FFTPUError):
    pass


class FilterNotFound(FFTPUError):
    pass


class OptionNotFound(FFTPUError):
    pass


class ProtocolNotFound(FFTPUError):
    pass
