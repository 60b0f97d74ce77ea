"""Tokenizers (the port's own copy of what the trainer uses from
aria_tpu/data/tokenizer.py): the ``Tokenizer`` protocol, ``ByteTokenizer``
(byte-level ids with the Aria special tokens, for tests and runs without a
vocabulary) and ``HFTokenizer`` / ``load_tokenizer`` for a checkpoint's
own vocabulary through ``transformers`` or the port's sentencepiece reader
(data/spm.py).
"""

from __future__ import annotations

from typing import List, Protocol, Sequence

IMAGE_TOKEN = "<|img|>"
FIM_PREFIX = "<fim_prefix>"
FIM_SUFFIX = "<fim_suffix>"
IM_START = "<|im_start|>"
IM_END = "<|im_end|>"

SPECIAL_TOKENS = (IMAGE_TOKEN, FIM_PREFIX, FIM_SUFFIX, IM_START, IM_END)


class Tokenizer(Protocol):
    pad_token_id: int

    def encode(self, text: str) -> List[int]: ...

    def decode(self, ids: Sequence[int]) -> str: ...

    @property
    def image_token_id(self) -> int: ...


class ByteTokenizer:
    """Byte-level tokenizer with Aria special tokens. ids 0..255 are bytes;
    specials follow. Deterministic and reversible — good enough to exercise
    every pipeline stage in tests."""

    def __init__(self):
        self._special_to_id = {t: 256 + i for i, t in enumerate(SPECIAL_TOKENS)}
        self._id_to_special = {v: k for k, v in self._special_to_id.items()}
        self.pad_token_id = 256 + len(SPECIAL_TOKENS)
        self.eos_token_id = self._special_to_id[IM_END]
        self.vocab_size = 256 + len(SPECIAL_TOKENS) + 1

    @property
    def image_token_id(self) -> int:
        return self._special_to_id[IMAGE_TOKEN]

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        i = 0
        while i < len(text):
            matched = False
            for tok, tid in self._special_to_id.items():
                if text.startswith(tok, i):
                    ids.append(tid)
                    i += len(tok)
                    matched = True
                    break
            if not matched:
                ids.extend(text[i].encode("utf-8"))
                i += 1
        return ids

    def token_bytes(self, tid: int) -> "bytes | None":
        """Exact byte string of one token (None for specials/pad) — the
        byte-level map guided decoding lifts its DFA over (engine/guided.py)."""
        return bytes([tid]) if tid < 256 else None

    def decode(self, ids: Sequence[int]) -> str:
        out: List[str] = []
        buf = bytearray()
        for t in ids:
            t = int(t)
            if t < 256:
                buf.append(t)
            else:
                if buf:
                    out.append(buf.decode("utf-8", errors="replace"))
                    buf = bytearray()
                if t in self._id_to_special:
                    out.append(self._id_to_special[t])
        if buf:
            out.append(buf.decode("utf-8", errors="replace"))
        return "".join(out)


def load_tokenizer(path: str):
    """Load the best available tokenizer implementation for a checkpoint dir
    (tokenizer.py:93-136):

    1. HF slow tokenizer (sentencepiece-backed), the reference's choice;
    2. HF fast tokenizer (tokenizer.json) when the slow one does not load;
    3. the port's pure-Python sentencepiece-unigram reader (data/spm.py):
       tokenizer.model with added_tokens.json or tokenizer_config.json's
       ``added_tokens_decoder`` (the card's machine has no transformers).
    """
    import json
    import os

    try:
        return HFTokenizer(path, use_fast=False)
    except Exception:
        pass
    try:
        return HFTokenizer(path, use_fast=True)
    except Exception:
        pass

    model_file = os.path.join(path, "tokenizer.model")
    if os.path.exists(model_file):
        from aria_tpu_torch.data.spm import SentencePieceTokenizer, parse_model_proto

        with open(model_file, "rb") as f:
            pieces = parse_model_proto(f.read())
        added = {}
        added_file = os.path.join(path, "added_tokens.json")
        if os.path.exists(added_file):
            with open(added_file) as f:
                added = {k: int(v) for k, v in json.load(f).items()}
        else:
            cfg_file = os.path.join(path, "tokenizer_config.json")
            if os.path.exists(cfg_file):
                with open(cfg_file) as f:
                    tc = json.load(f)
                for tid, info in (tc.get("added_tokens_decoder") or {}).items():
                    added[info["content"]] = int(tid)
        return SentencePieceTokenizer(pieces, added_tokens=added)
    raise FileNotFoundError(f"no loadable tokenizer found in {path}")


class HFTokenizer:
    """Wraps a transformers tokenizer loaded from local files."""

    def __init__(self, path: str, use_fast: bool = False):
        from transformers import AutoTokenizer

        self._tok = AutoTokenizer.from_pretrained(
            path, use_fast=use_fast, trust_remote_code=False
        )
        if self._tok.pad_token is None:
            self._tok.pad_token = self._tok.unk_token
        self.pad_token_id = self._tok.pad_token_id
        self.eos_token_id = self._tok.eos_token_id

    @property
    def image_token_id(self) -> int:
        ids = self._tok.convert_tokens_to_ids([IMAGE_TOKEN])
        return ids[0]

    def encode(self, text: str) -> List[int]:
        # encode() is called per ChatML *fragment*; a tokenizer configured to
        # add BOS/EOS would silently corrupt the assembled sequence
        # (reference assembles with add_special_tokens=False semantics,
        # aria/data.py:88-99).
        return self._tok(text, add_special_tokens=False).input_ids

    def token_bytes(self, tid: int) -> "bytes | None":
        """Exact byte map for guided decoding (engine/guided.py): pieces keep
        their sentencepiece leading-space semantics ("▁yes" → b" yes");
        byte-fallback pieces map to their raw byte; specials → None."""
        if tid in set(self._tok.all_special_ids):
            return None
        piece = self._tok.convert_ids_to_tokens(tid)
        if piece is None:
            return None
        if piece.startswith("<0x") and piece.endswith(">") and len(piece) == 6:
            return bytes([int(piece[3:-1], 16)])
        return piece.replace("▁", " ").encode("utf-8") or None

    def decode(self, ids: Sequence[int]) -> str:
        return self._tok.decode(ids)
