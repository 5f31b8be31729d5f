"""AES-128/192/256 block cipher + CBC/CTR modes (reference:
libavutil/aes.c, aes_ctr.c). Host-side: used by crypto-bearing protocols
(HLS AES-128 segments, SRTP) — never on the TPU path.

Decryption uses the equivalent-inverse-cipher table layout like the
reference; numpy vectorizes the per-block byte work.

The port's copy of ffmpeg_tpu/utils/aes.py, held equal to it by
tests/test_torch_protocols.py.
"""

from __future__ import annotations

import numpy as np

_SBOX = bytes.fromhex(
    "637c777bf26b6fc53001672bfed7ab76ca82c97dfa5947f0add4a2af9ca472c0"
    "b7fd9326363ff7cc34a5e5f171d8311504c723c31896059a071280e2eb27b275"
    "09832c1a1b6e5aa0523bd6b329e32f8453d100ed20fcb15b6acbbe394a4c58cf"
    "d0efaafb434d338545f9027f503c9fa851a3408f929d38f5bcb6da2110fff3d2"
    "cd0c13ec5f974417c4a77e3d645d197360814fdc222a908846eeb814de5e0bdb"
    "e0323a0a4906245cc2d3ac629195e479e7c8376d8dd54ea96c56f4ea657aae08"
    "ba78252e1ca6b4c6e8dd741f4bbd8b8a703eb5664803f60e613557b986c11d9e"
    "e1f8981169d98e949b1e87e9ce5528df8ca1890dbfe6426841992d0fb054bb16")
_INV_SBOX = bytearray(256)
for i, v in enumerate(_SBOX):
    _INV_SBOX[v] = i
_INV_SBOX = bytes(_INV_SBOX)

_RCON = (0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x40, 0x80, 0x1B, 0x36)


def _xtime(a: int) -> int:
    return ((a << 1) ^ 0x1B) & 0xFF if a & 0x80 else a << 1


_MUL = np.zeros((256, 256), np.uint8)
for a in range(256):
    for b in (1, 2, 3, 9, 11, 13, 14):
        x, y, r = a, b, 0
        while y:
            if y & 1:
                r ^= x
            x = _xtime(x)
            y >>= 1
        _MUL[a, b] = r


def _key_expand(key: bytes):
    nk = len(key) // 4
    nr = nk + 6
    w = [list(key[4 * i:4 * i + 4]) for i in range(nk)]
    for i in range(nk, 4 * (nr + 1)):
        t = list(w[i - 1])
        if i % nk == 0:
            t = t[1:] + t[:1]
            t = [_SBOX[b] for b in t]
            t[0] ^= _RCON[i // nk - 1]
        elif nk > 6 and i % nk == 4:
            t = [_SBOX[b] for b in t]
        w.append([a ^ b for a, b in zip(w[i - nk], t)])
    return [np.array(sum(w[4 * r:4 * r + 4], []), np.uint8).reshape(4, 4)
            for r in range(nr + 1)], nr


_SHIFT = np.array([[0, 1, 2, 3], [1, 2, 3, 0], [2, 3, 0, 1], [3, 0, 1, 2]])
_INV_SHIFT = np.array([[0, 1, 2, 3], [3, 0, 1, 2],
                       [2, 3, 0, 1], [1, 2, 3, 0]])
_SBOX_NP = np.frombuffer(_SBOX, np.uint8)
_INV_SBOX_NP = np.frombuffer(_INV_SBOX, np.uint8)


class AES:
    def __init__(self, key: bytes):
        if len(key) not in (16, 24, 32):
            raise ValueError("aes: key must be 128/192/256 bit")
        self._rk, self._nr = _key_expand(key)

    # state layout: (nblocks, 4 rows, 4 cols) with column-major fill
    def _to_state(self, data: np.ndarray):
        return data.reshape(-1, 4, 4).transpose(0, 2, 1)

    def _from_state(self, st: np.ndarray) -> np.ndarray:
        return st.transpose(0, 2, 1).reshape(-1)

    def _mix(self, st, inv: bool):
        c = (14, 11, 13, 9) if inv else (2, 3, 1, 1)
        r0, r1, r2, r3 = st[:, 0], st[:, 1], st[:, 2], st[:, 3]
        rows = (r0, r1, r2, r3)
        out = np.empty_like(st)
        for i in range(4):
            out[:, i] = (_MUL[rows[i % 4], c[0]] ^
                         _MUL[rows[(i + 1) % 4], c[1]] ^
                         _MUL[rows[(i + 2) % 4], c[2]] ^
                         _MUL[rows[(i + 3) % 4], c[3]])
        return out

    def encrypt_blocks(self, data: bytes) -> bytes:
        st = self._to_state(np.frombuffer(data, np.uint8).copy())
        st ^= self._rk[0].T
        for rnd in range(1, self._nr):
            st = _SBOX_NP[st]
            st = self._shift_rows(st, _SHIFT)
            st = self._mix(st, inv=False)
            st ^= self._rk[rnd].T
        st = _SBOX_NP[st]
        st = self._shift_rows(st, _SHIFT)
        st ^= self._rk[self._nr].T
        return self._from_state(st).tobytes()

    def _shift_rows(self, st, table):
        out = np.empty_like(st)
        for r in range(4):
            out[:, r] = st[:, r][:, table[r]]
        return out

    def decrypt_blocks(self, data: bytes) -> bytes:
        st = self._to_state(np.frombuffer(data, np.uint8).copy())
        st ^= self._rk[self._nr].T
        for rnd in range(self._nr - 1, 0, -1):
            st = self._shift_rows(st, _INV_SHIFT)
            st = _INV_SBOX_NP[st]
            st ^= self._rk[rnd].T
            st = self._mix(st, inv=True)
        st = self._shift_rows(st, _INV_SHIFT)
        st = _INV_SBOX_NP[st]
        st ^= self._rk[0].T
        return self._from_state(st).tobytes()


def cbc_decrypt(key: bytes, iv: bytes, data: bytes,
                strip_padding: bool = True) -> bytes:
    if len(data) % 16:
        raise ValueError("aes-cbc: data not block aligned")
    a = AES(key)
    pt = np.frombuffer(a.decrypt_blocks(data), np.uint8).copy()
    prev = np.frombuffer(iv + data[:-16], np.uint8)
    pt ^= prev
    out = pt.tobytes()
    if strip_padding and out:
        pad = out[-1]
        if 1 <= pad <= 16 and out[-pad:] == bytes([pad]) * pad:
            out = out[:-pad]
    return out


def cbc_encrypt(key: bytes, iv: bytes, data: bytes,
                add_padding: bool = True) -> bytes:
    if add_padding:
        pad = 16 - (len(data) % 16)
        data = data + bytes([pad]) * pad
    elif len(data) % 16:
        raise ValueError("aes-cbc: data not block aligned")
    a = AES(key)
    out = bytearray()
    prev = iv
    for i in range(0, len(data), 16):
        blk = bytes(x ^ y for x, y in zip(data[i:i + 16], prev))
        ct = a.encrypt_blocks(blk)
        out += ct
        prev = ct
    return bytes(out)


def ctr_crypt(key: bytes, iv: bytes, data: bytes) -> bytes:
    a = AES(key)
    n = (len(data) + 15) // 16
    ctr = int.from_bytes(iv, "big")
    blocks = b"".join(((ctr + i) % (1 << 128)).to_bytes(16, "big")
                      for i in range(n))
    ks = a.encrypt_blocks(blocks)[:len(data)]
    return bytes(x ^ y for x, y in zip(data, ks))
