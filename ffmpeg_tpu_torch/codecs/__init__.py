"""The port's codecs.  Importing the package registers its decoders and
encoders, as the reference's codec registry does."""

from .codec import (CodecContext, EncoderParameters, Rational,  # noqa: F401
                    decoder_names, encoder_names)
from . import aac  # noqa: F401  (registers the aac decoder)
from . import aac_enc  # noqa: F401  (registers the aac encoder)
from . import ac3  # noqa: F401  (registers ac3, eac3)
from . import dnxhd  # noqa: F401  (registers the dnxhd decoder)
from . import dnxhd_enc  # noqa: F401  (registers the dnxhd encoder)
from . import h264  # noqa: F401  (registers the h264 decoder)
from . import h264_enc  # noqa: F401  (registers the h264 encoder)
from . import hevc  # noqa: F401  (registers the hevc decoder)
from . import mjpeg  # noqa: F401  (registers the mjpeg decoder)
from . import mjpeg_enc  # noqa: F401  (registers the mjpeg encoder)
from . import mp3  # noqa: F401  (registers mp3, mp2, mp1)
from . import mpeg12  # noqa: F401  (registers mpeg2video, mpeg1video)
from . import mpeg12_enc  # noqa: F401  (registers mpeg2video)
from . import mpeg4  # noqa: F401  (registers mpeg4, h263)
from . import opus  # noqa: F401  (registers the opus decoder)
from . import prores  # noqa: F401  (registers the prores decoder)
from . import prores_enc  # noqa: F401  (registers the prores encoder)
from . import vorbis  # noqa: F401  (registers the vorbis decoder)
from . import vp9  # noqa: F401  (registers the vp9 decoder)
