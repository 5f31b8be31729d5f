"""ID3v2 tag reader (reference: libavformat/id3v2.c).

Parses v2.2/v2.3/v2.4 headers: text frames to metadata (with the
reference's key translation table), COMM/TXXX/USLT, CHAP frames to
chapters, and APIC to an attached-picture payload. Unsynchronisation
(both whole-tag v2.3 and per-frame v2.4) is undone before parsing.

The port's copy of ffmpeg_tpu/io/id3v2.py, held equal to it by
tests/test_torch_protocols.py.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

# id3v2.c ff_id3v2_tags / ff_id3v2_4_tags / ff_id3v2_3_tags conversion
_TAG_MAP = {
    "TALB": "album", "TCOM": "composer", "TCON": "genre",
    "TCOP": "copyright", "TENC": "encoded_by", "TIT2": "title",
    "TLAN": "language", "TPE1": "artist", "TPE2": "album_artist",
    "TPE3": "performer", "TPOS": "disc", "TPUB": "publisher",
    "TRCK": "track", "TSSE": "encoder", "USLT": "lyrics",
    "TCMP": "compilation", "TDRC": "date", "TDRL": "date",
    "TDEN": "creation_time", "TSOA": "album-sort", "TSOP": "artist-sort",
    "TSOT": "title-sort", "TIT1": "grouping", "TYER": "date",
    # v2.2 3-char ids
    "TAL": "album", "TCO": "genre", "TCP": "compilation", "TT2": "title",
    "TEN": "encoded_by", "TP1": "artist", "TP2": "album_artist",
    "TP3": "performer", "TRK": "track", "TYE": "date",
}


@dataclass
class Id3Chapter:
    element_id: str
    start_ms: int
    end_ms: int
    metadata: Dict[str, str]


def _syncsafe(b: bytes) -> int:
    v = 0
    for x in b:
        v = (v << 7) | (x & 0x7F)
    return v


def _deunsync(b: bytes) -> bytes:
    return b.replace(b"\xff\x00", b"\xff")


def _decode_text(data: bytes) -> str:
    if not data:
        return ""
    enc, body = data[0], data[1:]
    try:
        if enc == 0:
            return body.decode("latin-1").rstrip("\x00")
        if enc == 1:
            return body.decode("utf-16").rstrip("\x00")
        if enc == 2:
            return body.decode("utf-16-be").rstrip("\x00")
        return body.decode("utf-8").rstrip("\x00")
    except UnicodeDecodeError:
        return body.decode("latin-1", "replace").rstrip("\x00")


def _split_encoded(data: bytes) -> Tuple[str, bytes]:
    """Split an <encoding><string>\0<rest> frame at the terminator."""
    if not data:
        return "", b""
    enc = data[0]
    if enc in (1, 2):                         # utf-16 variants: \0\0 term
        i = 1
        while i + 1 < len(data):
            if data[i] == 0 and data[i + 1] == 0:
                return (_decode_text(bytes([enc]) + data[1:i]),
                        data[i + 2:])
            i += 2
        return _decode_text(data), b""
    i = data.find(b"\x00", 1)
    if i < 0:
        return _decode_text(data), b""
    return _decode_text(bytes([enc]) + data[1:i]), data[i + 1:]


def tag_size(header: bytes) -> int:
    """Total byte size of an ID3v2 tag given its first 10 bytes (incl.
    header and any footer), or 0 if not an ID3v2 header."""
    if len(header) < 10 or header[:3] != b"ID3":
        return 0
    size = _syncsafe(header[6:10])
    footer = 10 if header[5] & 0x10 else 0
    return 10 + size + footer


def parse(data: bytes):
    """Parse a whole ID3v2 tag (header included).

    Returns (metadata: dict, chapters: [Id3Chapter],
             pictures: [(mime, desc, bytes)]).
    """
    meta: Dict[str, str] = {}
    chapters: List[Id3Chapter] = []
    pics: List[tuple] = []
    if len(data) < 10 or data[:3] != b"ID3":
        return meta, chapters, pics
    ver = data[3]
    flags = data[5]
    size = _syncsafe(data[6:10])
    body = data[10:10 + size]
    if flags & 0x80 and ver <= 3:             # whole-tag unsync (<=2.3)
        body = _deunsync(body)
    if flags & 0x40 and ver >= 3 and len(body) >= 4:   # extended header
        if ver == 4:
            ehsize = _syncsafe(body[:4])
        else:
            ehsize = int.from_bytes(body[:4], "big") + 4
        body = body[ehsize:]
    pos = 0
    id_len, sz_len = (3, 3) if ver == 2 else (4, 4)
    hdr_len = id_len + sz_len + (0 if ver == 2 else 2)
    while pos + hdr_len <= len(body):
        fid = body[pos:pos + id_len]
        if fid.rstrip(b"\x00") == b"" or not fid.isascii():
            break
        fid_s = fid.decode("latin-1").strip()
        raw_sz = body[pos + id_len:pos + id_len + sz_len]
        if ver == 2:
            fsize = int.from_bytes(raw_sz, "big")
            fflags = 0
        else:
            fsize = _syncsafe(raw_sz) if ver == 4 else \
                int.from_bytes(raw_sz, "big")
            fflags = int.from_bytes(
                body[pos + id_len + sz_len:pos + hdr_len], "big")
        pos += hdr_len
        payload = body[pos:pos + fsize]
        pos += fsize
        if ver == 4 and fflags & 0x02:        # per-frame unsync
            payload = _deunsync(payload)
        if ver == 4 and fflags & 0x01:        # data-length indicator
            payload = payload[4:]
        _handle_frame(fid_s, payload, meta, chapters, pics, ver)
    return meta, chapters, pics


def _handle_frame(fid: str, payload: bytes, meta, chapters, pics,
                  ver: int) -> None:
    if fid == "CHAP":
        i = payload.find(b"\x00")
        if i < 0 or len(payload) < i + 17:
            return
        elem = payload[:i].decode("latin-1", "replace")
        start = int.from_bytes(payload[i + 1:i + 5], "big")
        end = int.from_bytes(payload[i + 5:i + 9], "big")
        sub = payload[i + 17:]
        submeta: Dict[str, str] = {}
        p = 0
        while p + 10 <= len(sub):
            sid = sub[p:p + 4].decode("latin-1", "replace")
            ssz = _syncsafe(sub[p + 4:p + 8]) if ver == 4 else \
                int.from_bytes(sub[p + 4:p + 8], "big")
            sp = sub[p + 10:p + 10 + ssz]
            p += 10 + ssz
            if sid.startswith("T"):
                key = _TAG_MAP.get(sid, sid)
                submeta[key] = _decode_text(sp)
        chapters.append(Id3Chapter(elem, start, end, submeta))
        return
    if fid in ("COMM", "COM", "USLT", "ULT"):
        if len(payload) < 4:
            return
        enc = payload[0]
        rest = payload[4:]                    # skip 3-byte language
        desc, text = _split_encoded(bytes([enc]) + rest)
        key = _TAG_MAP.get(fid, "comment" if fid.startswith("COM")
                           else "lyrics")
        meta[key] = _decode_text(bytes([enc]) + text) if text else desc
        return
    if fid in ("TXXX", "TXX"):
        desc, text = _split_encoded(payload)
        if desc:
            meta[desc] = _decode_text(bytes([payload[0]]) + text)
        return
    if fid in ("APIC", "PIC"):
        if len(payload) < 2:
            return
        enc = payload[0]
        if fid == "APIC":
            i = payload.find(b"\x00", 1)
            if i < 0:
                return
            mime = payload[1:i].decode("latin-1", "replace")
            rest = payload[i + 2:]            # skip picture type
        else:
            mime = "image/" + payload[1:4].decode(
                "latin-1", "replace").lower()
            rest = payload[5:]
        desc, img = _split_encoded(bytes([enc]) + rest)
        pics.append((mime, desc, img))
        return
    if fid.startswith("T"):
        key = _TAG_MAP.get(fid, fid)
        meta[key] = _decode_text(payload)
