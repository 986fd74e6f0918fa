# SPDX-License-Identifier: Apache-2.0
"""SentencePiece unigram tokenizer (pure Python, no sentencepiece dep).

The reference's helsinki plugin runs Marian SentencePiece vocabularies
(``plugins/native/helsinki/``); the ``sentencepiece`` wheel is absent here,
so this module reads the standard ``.model`` protobuf directly (wire-format
parse of the two fields inference needs: the piece list and the trainer-spec
special-token ids) and implements unigram Viterbi segmentation + decoding.

Also provides :func:`write_model` (serialize a compatible ``.model``) so
tokenizers can be built and tested offline.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

__all__ = ["SentencePieceModel", "write_model"]

WS = "▁"  # ▁ meta symbol for space

# sentencepiece_model.proto field numbers
_F_PIECES = 1
_F_TRAINER = 2
_SP_PIECE = 1
_SP_SCORE = 2
_SP_TYPE = 3
_T_UNK_ID = 40
_T_BOS_ID = 41
_T_EOS_ID = 42
_T_PAD_ID = 43

TYPE_NORMAL = 1
TYPE_UNKNOWN = 2
TYPE_CONTROL = 3
TYPE_USER_DEFINED = 4
TYPE_BYTE = 6


def _read_varint(buf: bytes, off: int) -> Tuple[int, int]:
    v = 0
    s = 0
    while True:
        b = buf[off]
        off += 1
        v |= (b & 0x7F) << s
        if not b & 0x80:
            return v, off
        s += 7


def _iter_fields(buf: bytes):
    """Yield (field_number, wire_type, value_bytes_or_int) over a message."""
    off = 0
    n = len(buf)
    while off < n:
        key, off = _read_varint(buf, off)
        fnum, wtype = key >> 3, key & 7
        if wtype == 0:  # varint
            v, off = _read_varint(buf, off)
            yield fnum, wtype, v
        elif wtype == 1:  # 64-bit
            yield fnum, wtype, buf[off : off + 8]
            off += 8
        elif wtype == 2:  # length-delimited
            ln, off = _read_varint(buf, off)
            yield fnum, wtype, buf[off : off + ln]
            off += ln
        elif wtype == 5:  # 32-bit
            yield fnum, wtype, buf[off : off + 4]
            off += 4
        else:
            raise ValueError(f"unsupported protobuf wire type {wtype}")


@dataclass
class SentencePieceModel:
    pieces: List[str] = field(default_factory=list)
    scores: List[float] = field(default_factory=list)
    types: List[int] = field(default_factory=list)
    unk_id: int = 0
    bos_id: int = -1
    eos_id: int = 1
    pad_id: int = -1
    _index: Dict[str, int] = field(default_factory=dict)
    _max_piece_len: int = 1

    @classmethod
    def load(cls, path: str) -> "SentencePieceModel":
        return cls.from_bytes(open(path, "rb").read())

    @classmethod
    def from_bytes(cls, data: bytes) -> "SentencePieceModel":
        m = cls()
        for fnum, wtype, val in _iter_fields(data):
            if fnum == _F_PIECES and wtype == 2:
                piece, score, ptype = "", 0.0, TYPE_NORMAL
                for f2, w2, v2 in _iter_fields(val):
                    if f2 == _SP_PIECE:
                        piece = v2.decode("utf-8")
                    elif f2 == _SP_SCORE:
                        score = struct.unpack("<f", v2)[0]
                    elif f2 == _SP_TYPE:
                        ptype = v2
                m.pieces.append(piece)
                m.scores.append(score)
                m.types.append(ptype)
            elif fnum == _F_TRAINER and wtype == 2:
                for f2, w2, v2 in _iter_fields(val):
                    if f2 == _T_UNK_ID:
                        m.unk_id = v2
                    elif f2 == _T_BOS_ID:
                        m.bos_id = v2 - ((v2 >> 63) << 64 if v2 >> 63 else 0)
                    elif f2 == _T_EOS_ID:
                        m.eos_id = v2
                    elif f2 == _T_PAD_ID:
                        m.pad_id = v2 - (1 << 64) if v2 >> 63 else v2
        m._build_index()
        return m

    def _build_index(self) -> None:
        self._index = {}
        for i, (p, t) in enumerate(zip(self.pieces, self.types)):
            if t in (TYPE_NORMAL, TYPE_USER_DEFINED):
                self._index.setdefault(p, i)
        self._max_piece_len = max((len(p) for p in self._index), default=1)

    @property
    def vocab_size(self) -> int:
        return len(self.pieces)

    # ------------------------------------------------------------- encoding

    def _normalize(self, text: str) -> str:
        # add_dummy_prefix + space replacement (default normalizer behavior)
        text = " ".join(text.split())
        return WS + text.replace(" ", WS)

    def encode(self, text: str, add_eos: bool = True) -> List[int]:
        """Unigram Viterbi segmentation → token ids."""
        s = self._normalize(text)
        n = len(s)
        neg_inf = float("-inf")
        best = [neg_inf] * (n + 1)
        back: List[Optional[Tuple[int, int]]] = [None] * (n + 1)
        best[0] = 0.0
        unk_penalty = min(self.scores, default=0.0) - 10.0
        for i in range(n):
            if best[i] == neg_inf:
                continue
            for ln in range(1, min(self._max_piece_len, n - i) + 1):
                piece = s[i : i + ln]
                idx = self._index.get(piece)
                if idx is None:
                    continue
                sc = best[i] + self.scores[idx]
                if sc > best[i + ln]:
                    best[i + ln] = sc
                    back[i + ln] = (i, idx)
            # unknown fallback: single char as UNK
            sc = best[i] + unk_penalty
            if sc > best[i + 1]:
                best[i + 1] = sc
                back[i + 1] = (i, self.unk_id)
        ids: List[int] = []
        pos = n
        while pos > 0:
            prev, idx = back[pos]
            ids.append(idx)
            pos = prev
        ids.reverse()
        if add_eos and self.eos_id >= 0:
            ids.append(self.eos_id)
        return ids

    def decode(self, ids: List[int]) -> str:
        out = []
        for i in ids:
            if 0 <= i < len(self.pieces):
                if self.types[i] in (TYPE_CONTROL, TYPE_UNKNOWN):
                    continue
                out.append(self.pieces[i])
        return "".join(out).replace(WS, " ").strip()


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field(fnum: int, wtype: int, payload: bytes) -> bytes:
    return _varint((fnum << 3) | wtype) + (
        _varint(len(payload)) + payload if wtype == 2 else payload
    )


def write_model(
    path: str,
    pieces: List[Tuple[str, float, int]],
    unk_id: int = 0,
    eos_id: int = 1,
    pad_id: int = -1,
) -> None:
    """Serialize a unigram ``.model`` (piece, score, type) the loader reads."""
    out = bytearray()
    for piece, score, ptype in pieces:
        sub = bytearray()
        sub += _field(_SP_PIECE, 2, piece.encode("utf-8"))
        sub += _field(_SP_SCORE, 5, struct.pack("<f", score))
        sub += _varint((_SP_TYPE << 3) | 0) + _varint(ptype)
        out += _field(_F_PIECES, 2, bytes(sub))
    trainer = bytearray()
    trainer += _varint((_T_UNK_ID << 3) | 0) + _varint(unk_id)
    trainer += _varint((_T_EOS_ID << 3) | 0) + _varint(eos_id)
    if pad_id >= 0:
        trainer += _varint((_T_PAD_ID << 3) | 0) + _varint(pad_id)
    out += _field(_F_TRAINER, 2, bytes(trainer))
    with open(path, "wb") as f:
        f.write(bytes(out))
