"""Guided (constrained) decoding (counterpart of aria_tpu/engine/guided.py).

A regex or the bounded-depth JSON grammar is compiled once on the host
into a byte-level DFA and lifted to a token-level table ``trans[state,
token]`` (-1 forbidden) over the tokenizer's byte strings; the table goes
to the device once. A decode step then masks the logits with one gathered
row, and advances each lane's state with one gathered element, as plain
torch ops on [B] state tensors: no host round trip, so the engines keep
their one read-back a chunk. The JAX package runs the same two steps in
XLA; they are no kernel here either.

Pipeline (numpy, copied from the JAX module, which imports ``jax.numpy``):
  regex string ──parse──┐
                        ├─> NFA (Thompson combinators) ──subset──> byte DFA
  JSON grammar ─build───┘
  byte DFA × token vocab ──vectorized byte walk──> TokenFSM (torch tensors)

JSON is not regular; ``json_fsm`` bounds nesting depth (default 4) which
makes it finite. ``regex_fsm``, ``json_fsm`` and ``schema_fsm`` build their
table on the card unless given ``device=``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from aria_tpu_torch.ops import backend

# ============================================================ NFA combinators


class _NFA:
    def __init__(self):
        self.eps: List[set] = []  # node -> set(node)
        self.byte: List[Dict[int, set]] = []  # node -> {byte: set(node)}

    def node(self) -> int:
        self.eps.append(set())
        self.byte.append({})
        return len(self.eps) - 1


@dataclasses.dataclass(frozen=True)
class _Expr:
    """Regex AST node built by the combinators below."""

    kind: str  # "cls" | "seq" | "alt" | "star" | "plus" | "opt" | "eps"
    data: tuple = ()

    def compile_into(self, nfa: _NFA) -> Tuple[int, int]:
        """Returns (start, accept) node ids."""
        if self.kind == "eps":
            s = nfa.node()
            return s, s
        if self.kind == "cls":
            s, a = nfa.node(), nfa.node()
            for b in self.data[0]:
                nfa.byte[s].setdefault(b, set()).add(a)
            return s, a
        if self.kind == "seq":
            s = a = None
            for part in self.data:
                ps, pa = part.compile_into(nfa)
                if s is None:
                    s, a = ps, pa
                else:
                    nfa.eps[a].add(ps)
                    a = pa
            if s is None:
                s = a = nfa.node()
            return s, a
        if self.kind == "alt":
            s, a = nfa.node(), nfa.node()
            for part in self.data:
                ps, pa = part.compile_into(nfa)
                nfa.eps[s].add(ps)
                nfa.eps[pa].add(a)
            return s, a
        if self.kind == "star":
            inner_s, inner_a = self.data[0].compile_into(nfa)
            s = nfa.node()
            nfa.eps[s].add(inner_s)
            nfa.eps[inner_a].add(s)
            return s, s
        if self.kind == "plus":
            inner_s, inner_a = self.data[0].compile_into(nfa)
            nfa.eps[inner_a].add(inner_s)
            return inner_s, inner_a
        if self.kind == "opt":
            # the skip edge lives on a FRESH start node — putting it on
            # inner_s would let any loop that re-enters inner_s (sepby1)
            # skip the inner machine, accepting e.g. trailing commas
            inner_s, inner_a = self.data[0].compile_into(nfa)
            s, a = nfa.node(), nfa.node()
            nfa.eps[s].add(inner_s)
            nfa.eps[s].add(a)  # skip
            nfa.eps[inner_a].add(a)
            return s, a
        if self.kind == "sepby1":
            # item (sep item)* with ONE copy of the item machine: after item,
            # either exit or take sep and loop back into the same copy. This
            # keeps the bounded-depth JSON grammar's NFA linear in depth
            # instead of exponential (star() would duplicate the item).
            item_s, item_a = self.data[0].compile_into(nfa)
            sep_s, sep_a = self.data[1].compile_into(nfa)
            a = nfa.node()
            nfa.eps[item_a].add(a)
            nfa.eps[item_a].add(sep_s)
            nfa.eps[sep_a].add(item_s)
            return item_s, a
        raise ValueError(self.kind)


def cls(bytes_set) -> _Expr:
    return _Expr("cls", (frozenset(bytes_set),))


def lit(s: str) -> _Expr:
    return _Expr("seq", tuple(cls({b}) for b in s.encode("utf-8"))) if s else eps()


def seq(*parts: _Expr) -> _Expr:
    return _Expr("seq", parts)


def alt(*parts: _Expr) -> _Expr:
    return _Expr("alt", parts)


def star(e: _Expr) -> _Expr:
    return _Expr("star", (e,))


def plus(e: _Expr) -> _Expr:
    return _Expr("plus", (e,))


def opt(e: _Expr) -> _Expr:
    return _Expr("opt", (e,))


def eps() -> _Expr:
    return _Expr("eps")


def sepby1(item: _Expr, sep: _Expr) -> _Expr:
    """item (sep item)* sharing one item sub-machine."""
    return _Expr("sepby1", (item, sep))


def rep(e: _Expr, lo: int, hi: Optional[int]) -> _Expr:
    """{lo,hi} quantifier by expansion (hi=None → lo copies then star)."""
    parts = [e] * lo
    if hi is None:
        parts.append(star(e))
    else:
        parts.extend([opt(e)] * (hi - lo))
    return seq(*parts) if parts else eps()


# ============================================================ regex parser

_CLASS_ESCAPES = {
    "d": set(range(0x30, 0x3A)),
    "w": set(range(0x30, 0x3A)) | set(range(0x41, 0x5B)) | set(range(0x61, 0x7B)) | {0x5F},
    "s": {0x20, 0x09, 0x0A, 0x0D, 0x0C, 0x0B},
    "n": {0x0A}, "t": {0x09}, "r": {0x0D},
}
_ANY = set(range(256)) - {0x0A}


def _parse_class(pat: str, i: int) -> Tuple[set, int]:
    """Parse [...] starting after '['; returns (byte set, index after ']')."""
    neg = i < len(pat) and pat[i] == "^"
    if neg:
        i += 1
    out: set = set()
    prev: Optional[int] = None
    while i < len(pat) and pat[i] != "]":
        c = pat[i]
        if c == "\\":
            i += 1
            e = pat[i]
            if e in _CLASS_ESCAPES:
                out |= _CLASS_ESCAPES[e]
                prev = None
            else:
                prev = ord(e)
                out.add(prev)
            i += 1
        elif c == "-" and prev is not None and i + 1 < len(pat) and pat[i + 1] != "]":
            hi = ord(pat[i + 1])
            out |= set(range(prev, hi + 1))
            prev = None
            i += 2
        else:
            prev = ord(c)
            out.add(prev)
            i += 1
    if i >= len(pat):
        raise ValueError("unterminated character class")
    if neg:
        out = set(range(256)) - out
    return out, i + 1


def parse_regex(pat: str) -> _Expr:
    """Regex subset: literals, escapes (\\d \\w \\s \\n \\t \\r \\<punct>),
    '.', classes [..] / [^..], groups (), alternation |, quantifiers
    * + ? {m} {m,} {m,n}. Byte-level semantics (UTF-8 literals ok)."""
    pos = 0

    def parse_alt() -> _Expr:
        nonlocal pos
        branches = [parse_seq()]
        while pos < len(pat) and pat[pos] == "|":
            pos += 1
            branches.append(parse_seq())
        return branches[0] if len(branches) == 1 else alt(*branches)

    def parse_seq() -> _Expr:
        nonlocal pos
        parts: List[_Expr] = []
        while pos < len(pat) and pat[pos] not in "|)":
            parts.append(parse_quant())
        return seq(*parts) if parts else eps()

    def parse_quant() -> _Expr:
        nonlocal pos
        atom = parse_atom()
        while pos < len(pat) and pat[pos] in "*+?{":
            c = pat[pos]
            if c == "*":
                atom = star(atom)
                pos += 1
            elif c == "+":
                atom = plus(atom)
                pos += 1
            elif c == "?":
                atom = opt(atom)
                pos += 1
            else:  # {m}, {m,}, {m,n}
                end = pat.index("}", pos)
                body = pat[pos + 1 : end]
                if "," in body:
                    lo_s, hi_s = body.split(",", 1)
                    atom = rep(atom, int(lo_s), int(hi_s) if hi_s else None)
                else:
                    atom = rep(atom, int(body), int(body))
                pos = end + 1
        return atom

    def parse_atom() -> _Expr:
        nonlocal pos
        c = pat[pos]
        if c == "(":
            pos += 1
            inner = parse_alt()
            if pos >= len(pat) or pat[pos] != ")":
                raise ValueError("unbalanced group")
            pos += 1
            return inner
        if c == "[":
            pos += 1
            byte_set, pos2 = _parse_class(pat, pos)
            pos = pos2
            return cls(byte_set)
        if c == ".":
            pos += 1
            return cls(_ANY)
        if c == "\\":
            pos += 1
            e = pat[pos]
            pos += 1
            if e in _CLASS_ESCAPES:
                return cls(_CLASS_ESCAPES[e])
            return cls(set(e.encode("utf-8")))
        pos += 1
        return _Expr("seq", tuple(cls({b}) for b in c.encode("utf-8")))

    expr = parse_alt()
    if pos != len(pat):
        raise ValueError(f"trailing regex input at {pos}")
    return expr


# ============================================================ DFA


@dataclasses.dataclass
class ByteDFA:
    trans: np.ndarray  # [S, 256] int32, -1 = dead
    accepting: np.ndarray  # [S] bool
    start: int = 0

    def simulate(self, data: bytes) -> int:
        """Final state, or -1 once dead."""
        s = self.start
        for b in data:
            s = int(self.trans[s, b])
            if s < 0:
                return -1
        return s

    def matches(self, data: bytes) -> bool:
        s = self.simulate(data)
        return s >= 0 and bool(self.accepting[s])


def compile_expr(expr: _Expr) -> ByteDFA:
    """Thompson NFA → subset-construction DFA.

    Two scaling tricks keep the depth-bounded JSON grammar compiling in
    milliseconds: (1) the alphabet is partitioned into byte-equivalence
    classes (bytes with identical edges everywhere transition identically,
    so one representative per class is determinized and the row is expanded
    at the end — JSON has ~25 classes, not 256); (2) subset states are
    frozensets with per-transition memoized eps-closure."""
    nfa = _NFA()
    start, accept = expr.compile_into(nfa)

    # --- byte-equivalence classes: signature = all (node, targets) edges
    by_byte_sig: Dict[int, list] = {b: [] for b in range(256)}
    for n, edges in enumerate(nfa.byte):
        for b, tgts in edges.items():
            by_byte_sig[b].append((n, frozenset(tgts)))
    sig_to_rep: Dict[tuple, int] = {}
    rep_of = np.zeros(256, np.int32)
    for b in range(256):
        sig = tuple(by_byte_sig[b])
        if sig not in sig_to_rep:
            sig_to_rep[sig] = b
        rep_of[b] = sig_to_rep[sig]

    # --- memoized single-node eps-closure (as frozenset)
    closure_memo: Dict[int, frozenset] = {}

    def node_closure(n: int) -> frozenset:
        got = closure_memo.get(n)
        if got is not None:
            return got
        stack, out = [n], {n}
        while stack:
            for nxt in nfa.eps[stack.pop()]:
                if nxt not in out:
                    out.add(nxt)
                    stack.append(nxt)
        got = frozenset(out)
        closure_memo[n] = got
        return got

    def closure(states) -> frozenset:
        out: set = set()
        for n in states:
            out |= node_closure(n)
        return frozenset(out)

    start_set = closure({start})
    ids: Dict[frozenset, int] = {start_set: 0}
    order = [start_set]
    rows: List[np.ndarray] = []
    i = 0
    while i < len(order):
        cur = order[i]
        row = np.full(256, -1, np.int32)
        by_rep: Dict[int, set] = {}
        for n in cur:
            for b, nxts in nfa.byte[n].items():
                if rep_of[b] == b:
                    by_rep.setdefault(b, set()).update(nxts)
        for b, nxts in by_rep.items():
            tgt = closure(nxts)
            if tgt not in ids:
                ids[tgt] = len(order)
                order.append(tgt)
            row[b] = ids[tgt]
        rows.append(row[rep_of])  # expand class representatives to all bytes
        i += 1
    accepting = np.array([accept in s for s in order], bool)
    return ByteDFA(np.stack(rows), accepting, 0)


def compile_regex(pattern: str) -> ByteDFA:
    return compile_expr(parse_regex(pattern))


# ============================================================ JSON grammar

_WS = star(cls({0x20, 0x09, 0x0A, 0x0D}))
_STRING = seq(
    lit('"'),
    star(alt(
        cls(set(range(0x20, 0x100)) - {0x22, 0x5C}),  # any non-quote/backslash
        seq(cls({0x5C}), cls(set(b'"\\/bfnrtu'))),     # escape
    )),
    lit('"'),
)
_NUMBER = seq(
    opt(lit("-")),
    alt(lit("0"), seq(cls(set(range(0x31, 0x3A))), star(cls(set(range(0x30, 0x3A)))))),
    opt(seq(lit("."), plus(cls(set(range(0x30, 0x3A)))))),
    opt(seq(cls(set(b"eE")), opt(cls(set(b"+-"))), plus(cls(set(range(0x30, 0x3A)))))),
)
_SCALAR = alt(_STRING, _NUMBER, lit("true"), lit("false"), lit("null"))


def _json_obj(inner: _Expr) -> _Expr:
    pair = seq(_STRING, _WS, lit(":"), _WS, inner)
    return seq(lit("{"), _WS,
               opt(sepby1(pair, seq(_WS, lit(","), _WS))),
               _WS, lit("}"))


def _json_arr(inner: _Expr) -> _Expr:
    return seq(lit("["), _WS,
               opt(sepby1(inner, seq(_WS, lit(","), _WS))),
               _WS, lit("]"))


def _json_value(depth: int) -> _Expr:
    if depth <= 0:
        return _SCALAR
    inner = _json_value(depth - 1)
    # one shared inner machine per container (sepby1), so the NFA stays
    # linear in depth — the naive star() expansion is exponential
    return alt(_SCALAR, _json_obj(inner), _json_arr(inner))


def json_dfa(max_depth: int = 4, object_only: bool = True) -> ByteDFA:
    """DFA accepting JSON values nested up to ``max_depth``. ``object_only``
    requires the top level to be an object (OpenAI json_object semantics)."""
    top = _json_value(max_depth)
    if object_only:
        top = _json_obj(_json_value(max_depth - 1))
    return compile_expr(seq(_WS, top))


# ============================================================ token lifting


def token_byte_strings(tokenizer, vocab_size: Optional[int] = None) -> List[Optional[bytes]]:
    """Best-effort token_id -> byte string map. Special tokens map to None
    (always forbidden inside a constrained region; stop tokens are handled
    separately by TokenFSM). ``vocab_size`` pads to the MODEL's logit width
    when it exceeds the tokenizer's vocab (padded ids are forbidden)."""
    V = tokenizer.vocab_size
    out: List[Optional[bytes]] = [None] * V
    exact = getattr(tokenizer, "token_bytes", None)  # exact byte-level map
    specials = set()
    for attr in ("_special_to_id", "special_token_ids"):
        m = getattr(tokenizer, attr, None)
        if isinstance(m, dict):
            specials |= set(m.values())
        elif m is not None:
            specials |= set(m)
    for tid in range(V):
        if tid in specials:
            continue
        if exact is not None:
            out[tid] = exact(tid)
            continue
        try:
            s = tokenizer.decode([tid])
        except Exception:  # noqa: BLE001
            continue
        if s:
            out[tid] = s.encode("utf-8")
    if vocab_size is not None and vocab_size > V:
        out.extend([None] * (vocab_size - V))
    return out


def regex_fsm(pattern: str, tokenizer, stop_token_ids: Sequence[int],
              vocab_size: Optional[int] = None, device="cuda") -> "TokenFSM":
    """One-call constrained-decoding setup for a regex pattern."""
    return TokenFSM.build(
        compile_regex(pattern),
        token_byte_strings(tokenizer, vocab_size), stop_token_ids, device,
    )


def json_fsm(tokenizer, stop_token_ids: Sequence[int],
             vocab_size: Optional[int] = None, max_depth: int = 4,
             object_only: bool = True, device="cuda") -> "TokenFSM":
    """OpenAI ``response_format={"type": "json_object"}`` semantics."""
    return TokenFSM.build(
        json_dfa(max_depth, object_only=object_only),
        token_byte_strings(tokenizer, vocab_size), stop_token_ids, device,
    )


# ============================================================ JSON Schema

def schema_to_expr(schema: dict) -> _Expr:
    """JSON Schema → grammar expression (OpenAI "structured outputs"
    semantics: object properties are emitted in SCHEMA ORDER and are all
    required — the convention that keeps the automaton linear instead of
    enumerating key permutations).

    Supported: type object/array/string/number/integer/boolean/null,
    properties, items, enum, const, string pattern (the regex subset of
    :func:`parse_regex`), minItems/maxItems, anyOf/oneOf, $defs-free
    inline schemas."""
    if "const" in schema:
        return lit(_json_dump(schema["const"]))
    if "enum" in schema:
        return alt(*[lit(_json_dump(v)) for v in schema["enum"]])
    if "anyOf" in schema or "oneOf" in schema:
        subs = schema.get("anyOf", schema.get("oneOf"))
        return alt(*[schema_to_expr(s) for s in subs])

    t = schema.get("type")
    if isinstance(t, list):
        return alt(*[schema_to_expr({**schema, "type": ti}) for ti in t])
    if t == "object" or (t is None and "properties" in schema):
        props = schema.get("properties", {})
        if not props:
            return seq(lit("{"), _WS, lit("}"))
        parts = [lit("{"), _WS]
        for i, (key, sub) in enumerate(props.items()):
            if i:
                parts += [_WS, lit(","), _WS]
            parts += [lit(_json_dump(key)), _WS, lit(":"), _WS,
                      schema_to_expr(sub)]
        parts += [_WS, lit("}")]
        return seq(*parts)
    if t == "array":
        item = schema_to_expr(schema.get("items", {"type": "string"}))
        lo = int(schema.get("minItems", 0))
        hi = schema.get("maxItems")
        sep = seq(_WS, lit(","), _WS)
        if hi is not None:
            hi = int(hi)
            if hi == 0:
                return seq(lit("["), _WS, lit("]"))
            body = seq(item, rep(seq(sep, item), max(lo - 1, 0), hi - 1))
            core = body if lo >= 1 else opt(body)
            return seq(lit("["), _WS, core, _WS, lit("]"))
        if lo >= 1:
            body = seq(item, rep(seq(sep, item), lo - 1, None))
            return seq(lit("["), _WS, body, _WS, lit("]"))
        return seq(lit("["), _WS, opt(sepby1(item, sep)), _WS, lit("]"))
    if t == "string":
        if "pattern" in schema:
            inner = parse_regex(schema["pattern"])
            # escape-free contents only: the pattern constrains the raw text
            return seq(lit('"'), inner, lit('"'))
        return _STRING
    if t == "integer":
        return seq(opt(lit("-")), alt(
            lit("0"), seq(cls(set(range(0x31, 0x3A))),
                          star(cls(set(range(0x30, 0x3A)))))))
    if t == "number":
        return _NUMBER
    if t == "boolean":
        return alt(lit("true"), lit("false"))
    if t == "null":
        return lit("null")
    # unconstrained: any JSON value (bounded depth)
    return _json_value(3)


def _json_dump(v) -> str:
    import json as _json

    return _json.dumps(v, separators=(",", ":"))


def schema_fsm(schema: dict, tokenizer, stop_token_ids: Sequence[int],
               vocab_size: Optional[int] = None, device="cuda") -> "TokenFSM":
    """OpenAI ``response_format={"type": "json_schema"}``: outputs conform
    to the schema exactly (schema-ordered, all-required properties)."""
    return TokenFSM.build(
        compile_expr(seq(_WS, schema_to_expr(schema))),
        token_byte_strings(tokenizer, vocab_size), stop_token_ids, device,
    )


@dataclasses.dataclass
class TokenFSM:
    """Device-resident token-level automaton (guided.py:580-644).

    ``trans[s, v]`` = DFA state after emitting token v from state s (-1
    forbidden), int16 where the states fit, else int32; ``accepting[s]``
    gates stop tokens; ``stop_mask[v]`` marks stop/eos ids. FREE_STATE (the
    last row) permits everything with a self-loop: unconstrained lanes park
    there, so one table serves mixed batches."""

    trans: torch.Tensor  # [S+1, V] int16 / int32
    accepting: torch.Tensor  # [S+1] bool
    stop_mask: torch.Tensor  # [V] bool
    start: int
    free_state: int

    @staticmethod
    def build(dfa: ByteDFA, token_bytes: Sequence[Optional[bytes]],
              stop_token_ids: Sequence[int], device="cuda") -> "TokenFSM":
        """The JAX package's table, array for array, on ``device`` (the card
        unless another is named)."""
        device = backend.device(device)
        S = dfa.trans.shape[0]
        V = len(token_bytes)
        DEAD = S  # sentinel row during the walk
        T = np.concatenate([dfa.trans, np.full((1, 256), -1, np.int32)], 0)
        T = np.where(T < 0, DEAD, T)  # dead self-traps

        maxlen = max((len(b) for b in token_bytes if b), default=0)
        byte_mat = np.zeros((V, maxlen), np.uint8)
        len_vec = np.zeros(V, np.int32)
        for v, b in enumerate(token_bytes):
            if b:
                byte_mat[v, : len(b)] = np.frombuffer(b, np.uint8)
                len_vec[v] = len(b)

        # walk every token from every DFA state, vectorized over [S, V]
        state = np.broadcast_to(
            np.arange(S, dtype=np.int32)[:, None], (S, V)).copy()
        for i in range(maxlen):
            nxt = T[state, byte_mat[None, :, i]]  # [S, V] broadcast gather
            np.copyto(state, nxt, where=(len_vec > i)[None, :])
        trans = np.where(
            (state == DEAD) | (len_vec[None, :] == 0), -1, state
        )

        # free state: self-loop on EVERY token (unconstrained lanes must see
        # an unmodified distribution, special tokens included)
        FREE = S
        free_row = np.full((1, V), FREE, np.int32)
        # int16 halves the device table (the 100k-vocab JSON FSM is ~50MB
        # instead of 100+); guided_next_state casts back to the state dtype
        dt = np.int16 if S + 1 < np.iinfo(np.int16).max else np.int32
        trans = np.concatenate([trans, free_row], 0).astype(dt)
        accepting = np.concatenate([dfa.accepting, [True]])

        stop_mask = np.zeros(V, bool)
        for t in stop_token_ids:
            if 0 <= t < V:
                stop_mask[t] = True
        return TokenFSM(
            torch.from_numpy(trans).to(device), torch.from_numpy(accepting).to(device),
            torch.from_numpy(stop_mask).to(device), start=dfa.start, free_state=FREE,
        )

    def to(self, device) -> "TokenFSM":
        return dataclasses.replace(self, trans=self.trans.to(device),
                                   accepting=self.accepting.to(device),
                                   stop_mask=self.stop_mask.to(device))

    @property
    def device(self) -> torch.device:
        return self.trans.device

    @property
    def num_states(self) -> int:
        return int(self.trans.shape[0])

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.trans, self.accepting, self.stop_mask))


def guided_mask(fsm_trans: torch.Tensor, fsm_accepting: torch.Tensor, fsm_stop: torch.Tensor,
                state: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """Mask logits [B, V] to the FSM-legal tokens of each lane's state [B]
    (guided.py:647-657). Stop tokens are legal in accepting states, and
    forced when the constraint language has no continuation (a finite
    pattern exhausted)."""
    st = state.long()
    allowed = fsm_trans[st] >= 0  # [B, V]
    any_reg = allowed.any(dim=-1, keepdim=True)
    stop_ok = (fsm_accepting[st][:, None] | ~any_reg) & fsm_stop[None, :]
    allowed = allowed | stop_ok
    return torch.where(allowed, logits, torch.full_like(logits, -1e30))


def guided_next_state(fsm_trans: torch.Tensor, state: torch.Tensor,
                      tok: torch.Tensor) -> torch.Tensor:
    """Advance each lane's state by its sampled token (stop tokens and
    forbidden ones keep the state; guided.py:660-664)."""
    nxt = fsm_trans[state.long(), tok.long()].to(state.dtype)
    return torch.where(nxt >= 0, nxt, state)
