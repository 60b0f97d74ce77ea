"""Self-contained sentencepiece-unigram tokenizer (no sentencepiece dep): the
port's copy of aria_tpu/data/spm.py, pure Python (the card's machine has
neither ``sentencepiece`` nor ``transformers``).

The reference requires the *slow* Llama tokenizer everywhere
(processing_aria.py:74; sentencepiece C++ underneath, SURVEY.md §2.3). This
module reads a ``tokenizer.model`` (sentencepiece ModelProto protobuf)
directly and implements Llama-style unigram tokenization:

- minimal protobuf wire-format parser for ModelProto.pieces
  (field 1: repeated SentencePiece {1: piece, 2: score, 3: type})
- normalization: " " -> "▁" with a dummy "▁" prefix (Llama's normalizer)
- Viterbi segmentation maximizing total piece score
- byte fallback via the <0xNN> pieces for out-of-vocab characters
- added special tokens (``<|img|>`` etc.) split greedily before
  segmentation, matching HF added-token semantics

An encoder for tiny synthetic models is included so the implementation is
fully testable offline.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Sequence, Tuple

WS = "▁"  # ▁

NORMAL, UNKNOWN, CONTROL, USER_DEFINED, BYTE, UNUSED = 1, 2, 3, 4, 6, 5


# ------------------------------------------------------------ protobuf

def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[i]
        i += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, i
        shift += 7


def parse_model_proto(data: bytes) -> List[Tuple[str, float, int]]:
    """Extract (piece, score, type) from a sentencepiece ModelProto."""
    pieces: List[Tuple[str, float, int]] = []
    i = 0
    n = len(data)
    while i < n:
        tag, i = _read_varint(data, i)
        field, wire = tag >> 3, tag & 7
        if field == 1 and wire == 2:  # pieces
            length, i = _read_varint(data, i)
            sub = data[i : i + length]
            i += length
            piece, score, ptype = "", 0.0, NORMAL
            j = 0
            while j < len(sub):
                t2, j = _read_varint(sub, j)
                f2, w2 = t2 >> 3, t2 & 7
                if f2 == 1 and w2 == 2:
                    ln, j = _read_varint(sub, j)
                    piece = sub[j : j + ln].decode("utf-8")
                    j += ln
                elif f2 == 2 and w2 == 5:
                    (score,) = struct.unpack("<f", sub[j : j + 4])
                    j += 4
                elif f2 == 3 and w2 == 0:
                    ptype, j = _read_varint(sub, j)
                else:
                    j = _skip(sub, j, w2)
            pieces.append((piece, score, ptype))
        else:
            i = _skip(data, i, wire)
    return pieces


def _skip(buf: bytes, i: int, wire: int) -> int:
    if wire == 0:
        _, i = _read_varint(buf, i)
        return i
    if wire == 1:
        return i + 8
    if wire == 2:
        ln, i = _read_varint(buf, i)
        return i + ln
    if wire == 5:
        return i + 4
    raise ValueError(f"unsupported wire type {wire}")


def _write_varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def encode_model_proto(pieces: Sequence[Tuple[str, float, int]]) -> bytes:
    """Build a minimal ModelProto (for tests)."""
    out = bytearray()
    for piece, score, ptype in pieces:
        sub = bytearray()
        pb = piece.encode("utf-8")
        sub += b"\x0a" + _write_varint(len(pb)) + pb  # field 1, wire 2
        sub += b"\x15" + struct.pack("<f", score)  # field 2, wire 5
        sub += b"\x18" + _write_varint(ptype)  # field 3, wire 0
        out += b"\x0a" + _write_varint(len(sub)) + sub
    return bytes(out)


# ------------------------------------------------------------ tokenizer

class SentencePieceTokenizer:
    """Llama-style unigram tokenizer over a parsed ModelProto."""

    def __init__(
        self,
        pieces: Sequence[Tuple[str, float, int]],
        added_tokens: Optional[Dict[str, int]] = None,
        add_dummy_prefix: bool = True,
    ):
        self.pieces = list(pieces)
        self.piece_to_id = {p: i for i, (p, _, _) in enumerate(self.pieces)}
        self.scores = [s for _, s, _ in self.pieces]
        self.types = [t for _, _, t in self.pieces]
        self.max_piece_len = max((len(p) for p, _, _ in self.pieces), default=1)
        self.unk_id = next(
            (i for i, t in enumerate(self.types) if t == UNKNOWN), 0
        )
        self.byte_ids = {}
        for i, (p, _, t) in enumerate(self.pieces):
            if t == BYTE and p.startswith("<0x") and p.endswith(">"):
                self.byte_ids[int(p[3:-1], 16)] = i
        self.added_tokens = dict(added_tokens or {})
        self.id_to_added = {v: k for k, v in self.added_tokens.items()}
        self.add_dummy_prefix = add_dummy_prefix
        self.vocab_size = len(self.pieces) + len(
            [i for i in self.added_tokens.values() if i >= len(self.pieces)]
        )

    @classmethod
    def from_file(cls, path: str, added_tokens: Optional[Dict[str, int]] = None):
        with open(path, "rb") as f:
            return cls(parse_model_proto(f.read()), added_tokens)

    # -------- unigram Viterbi over one normalized chunk (pure Python: the
    # JAX package's native fast path, native/spm_ops.cc, is not the port's)

    def _segment(self, text: str) -> List[int]:
        n = len(text)
        best = [float("-inf")] * (n + 1)
        back: List[Optional[Tuple[int, int]]] = [None] * (n + 1)
        best[0] = 0.0
        UNK_PENALTY = -10.0
        for i in range(n):
            if best[i] == float("-inf"):
                continue
            for j in range(i + 1, min(i + self.max_piece_len, n) + 1):
                pid = self.piece_to_id.get(text[i:j])
                if pid is not None and self.types[pid] in (NORMAL, USER_DEFINED):
                    sc = best[i] + self.scores[pid]
                    if sc > best[j]:
                        best[j] = sc
                        back[j] = (i, pid)
            # unknown single char fallback
            j = i + 1
            sc = best[i] + min(self.scores, default=0.0) + UNK_PENALTY
            if sc > best[j]:
                best[j] = sc
                back[j] = (i, -1)

        ids: List[int] = []
        pos = n
        rev: List[int] = []
        while pos > 0:
            i, pid = back[pos]
            if pid == -1:
                ch = text[i:pos]
                bs = ch.encode("utf-8")
                if all(b in self.byte_ids for b in bs):
                    rev.extend(self.byte_ids[b] for b in reversed(bs))
                else:
                    rev.append(self.unk_id)
            else:
                rev.append(pid)
            pos = i
        ids.extend(reversed(rev))
        return ids

    def _split_added(self, text: str) -> List[Tuple[str, Optional[int]]]:
        """Greedy longest-match split on added special tokens."""
        if not self.added_tokens:
            return [(text, None)]
        out: List[Tuple[str, Optional[int]]] = []
        buf = []
        i = 0
        toks = sorted(self.added_tokens, key=len, reverse=True)
        while i < len(text):
            matched = False
            for tkn in toks:
                if text.startswith(tkn, i):
                    if buf:
                        out.append(("".join(buf), None))
                        buf = []
                    out.append((tkn, self.added_tokens[tkn]))
                    i += len(tkn)
                    matched = True
                    break
            if not matched:
                buf.append(text[i])
                i += 1
        if buf:
            out.append(("".join(buf), None))
        return out

    def encode(self, text: str) -> List[int]:
        """The dummy "▁" prefix applies only at the true start of the string
        (HF legacy=False semantics: text after an added special token gets no
        phantom space)."""
        ids: List[int] = []
        for ci, (chunk, tid) in enumerate(self._split_added(text)):
            if tid is not None:
                ids.append(tid)
                continue
            norm = chunk.replace(" ", WS)
            if self.add_dummy_prefix and ci == 0:
                norm = WS + norm
            ids.extend(self._segment(norm))
        return ids

    def token_bytes(self, tid: int) -> Optional[bytes]:
        """Exact byte string one token contributes to detokenized text (the
        map guided decoding lifts its DFA over, engine/guided.py). Pieces
        keep their sentencepiece leading-space semantics: "▁yes" → b" yes",
        so anchor patterns with an optional leading space (" ?(yes|no)").
        Control/added/unknown tokens → None (forbidden under a constraint)."""
        if tid in self.id_to_added or tid >= len(self.pieces):
            return None
        p, _, t = self.pieces[tid]
        if t == BYTE and p.startswith("<0x") and p.endswith(">"):
            return bytes([int(p[3:-1], 16)])
        if t in (CONTROL, UNKNOWN, UNUSED):
            return None
        return p.replace("▁", " ").encode("utf-8") or None

    def decode(self, ids: Sequence[int]) -> str:
        parts: List[str] = []
        byte_buf = bytearray()

        def flush():
            nonlocal byte_buf
            if byte_buf:
                parts.append(byte_buf.decode("utf-8", errors="replace"))
                byte_buf = bytearray()

        for t in ids:
            t = int(t)
            if t in self.id_to_added:
                flush()
                parts.append(self.id_to_added[t])
            elif 0 <= t < len(self.pieces) and self.types[t] == BYTE:
                byte_buf.append(int(self.pieces[t][0][3:-1], 16))
            elif 0 <= t < len(self.pieces):
                flush()
                parts.append(self.pieces[t][0])
        flush()
        text = "".join(parts).replace(WS, " ")
        if self.add_dummy_prefix and text.startswith(" "):
            text = text[1:]
        return text

    # Tokenizer-protocol compatibility
    @property
    def pad_token_id(self) -> int:
        return self.unk_id

    @property
    def image_token_id(self) -> int:
        return self.added_tokens.get("<|img|>", self.unk_id)
