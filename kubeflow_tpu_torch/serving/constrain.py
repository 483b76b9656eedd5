"""Grammar-constrained decoding: compile -> map -> advance -> mask.

A copy of ``kubeflow_tpu/serving/constrain.py`` (numpy only), kept in the
port so that the port imports nothing of the JAX package.  Apart from this
header it is the same module, so a spec compiles to the same automaton and
a tokenizer maps to the same token table in both packages.

The subsystem turns a client-supplied JSON-Schema / EBNF grammar into a
byte-level pushdown automaton (PDA), maps it onto the model's tokenizer
vocabulary ONCE at registration (the token->bytes table is a durable
artifact: disk-cached and CRC'd like every KVPG frame), and then advances
one automaton per constrained slot host-side — on the tick loop's own
schedule, off the device critical path (JetStream discipline).  Each tick
the automaton emits a static-shape ``[V]`` boolean mask of grammar-legal
next tokens; model.py's fused samplers apply it as ONE extra masked-logits
op (finite ``-1e30``, the ``_attn`` idiom — never ``-inf``, so the NaN
guard stays meaningful and keeps reading the RAW logits).

Correctness contract (the byte-identity oracle, tests/test_constrain.py):

* every constrained output is a prefix of the grammar's language, and is
  grammar-COMPLETE when the engine reports ``outcome="valid"``;
* whenever the UNCONSTRAINED run of the same request happens to comply
  with the grammar, the constrained run is byte-identical to it — the
  mask only removes illegal tokens, it never reorders legal ones (greedy
  argmax over masked logits == argmax over raw logits when the raw argmax
  is legal).

Compile once, advance per tick: grammar/schema compilation and the vocab
mapping are BANNED from ``# graftlint: hot-path`` functions by the hotpath
rule — everything here that runs per tick is pure dict/set stepping.

PDA representation
------------------
A *configuration* is the stack of symbols still to be consumed, stored as
a persistent linked list of nested pairs ``(symbol, rest)`` with ``()`` as
the empty stack, so ``clone()`` is O(1) sharing and snapshots are cheap.
Symbols are ``("t", ("lit", bytes))`` (literal byte string),
``("t", ("cls", frozenset[int]))`` (byte class) or ``("nt", name)``
(nonterminal).  The automaton state is a CLOSED frozenset of
configurations (every head is a terminal, or the configuration is empty =
accepting); ``_step`` consumes one byte and re-closes.  Left recursion is
rejected at compile time (it would make closure unbounded); the state-set
is capped at ``MAX_CONFIGS`` — overflow is a compile/mapping bug surfaced
as ``ConstraintStall``, never an invalid output.
"""

from __future__ import annotations

import binascii
import json
import os
import threading
from typing import Dict, FrozenSet, List, Optional, Tuple

import numpy as np

__all__ = [
    "GrammarError", "ConstraintStall", "Grammar", "TokenTable",
    "GrammarConstraint", "ConstrainRegistry", "compile_grammar",
    "compile_json_schema", "compile_spec", "json_grammar",
    "token_bytes_from_tokenizer", "MAX_CONFIGS", "MAX_GRAMMAR_BYTES",
]

# state-set cap: a healthy grammar stays far below this; overflow means a
# compile bug or pathological nesting and is surfaced as ConstraintStall
# (the engine's constraint_stall incident class), never an invalid output
MAX_CONFIGS = 256
# ingress bound on grammar/schema source size (engine.json-strict 400s)
MAX_GRAMMAR_BYTES = 65536
# longest token byte string admitted into the trie (longer tokens are
# simply never grammar-legal — no real grammar terminal is this long)
MAX_TOKEN_BYTES = 64
# bounded maxItems for enumerated (non-recursive) array schemas
MAX_ARRAY_ITEMS = 64


class GrammarError(ValueError):
    """Invalid grammar/schema/spec at compile time — the CLIENT's fault,
    mapped to a 400 at ingress (serve.py/router.py)."""


class ConstraintStall(RuntimeError):
    """The automaton reached a state with zero legal tokens (and is not
    accepting), or the config-set overflowed — a compile or mapping bug,
    NEVER the client's fault.  The engine fails the slot and feeds a
    ``constraint_stall`` incident."""


# ------------------------------------------------------------------ symbols


def _lit(s) -> tuple:
    b = s if isinstance(s, bytes) else str(s).encode("utf-8")
    if not b:
        raise GrammarError("grammar: empty literal")
    return ("t", ("lit", b))


def _cls(byteset) -> tuple:
    return ("t", ("cls", frozenset(int(b) for b in byteset)))


def _nt(name: str) -> tuple:
    return ("nt", name)


def _canon_sym(sym) -> list:
    """JSON-safe canonical encoding of one symbol (grammar CRC + snapshots)."""
    if sym[0] == "nt":
        return ["n", sym[1]]
    kind, val = sym[1]
    if kind == "lit":
        return ["l", val.hex()]
    return ["c", sorted(int(b) for b in val)]


def _decode_sym(enc) -> tuple:
    if not isinstance(enc, (list, tuple)) or len(enc) != 2:
        raise GrammarError("snapshot: malformed symbol")
    tag, val = enc
    if tag == "n":
        return ("nt", str(val))
    if tag == "l":
        return ("t", ("lit", bytes.fromhex(val)))
    if tag == "c":
        return ("t", ("cls", frozenset(int(x) for x in val)))
    raise GrammarError(f"snapshot: unknown symbol tag {tag!r}")


# ------------------------------------------------------------------ grammar


def _nullable_map(rules) -> Dict[str, bool]:
    nullable = {n: False for n in rules}
    changed = True
    while changed:
        changed = False
        for n, alts in rules.items():
            if nullable[n]:
                continue
            for alt in alts:
                if all(s[0] == "nt" and nullable[s[1]] for s in alt):
                    nullable[n] = True
                    changed = True
                    break
    return nullable


def _check_rules(rules, start: str) -> None:
    """Referenced-rules-defined + no-left-recursion validation.

    Left recursion (direct or through a nullable prefix) would make the
    closure below grow a distinct configuration per expansion — rejected
    at compile time with a client-visible error instead of a runtime
    config-set overflow."""
    if not rules:
        raise GrammarError("grammar: no rules defined")
    if start not in rules:
        raise GrammarError(f"grammar: start rule {start!r} is not defined")
    for n, alts in rules.items():
        for alt in alts:
            for s in alt:
                if s[0] == "nt" and s[1] not in rules:
                    raise GrammarError(
                        f"grammar: rule {n!r} references undefined rule {s[1]!r}")
    nullable = _nullable_map(rules)
    edges = {}
    for n, alts in rules.items():
        es = set()
        for alt in alts:
            for s in alt:
                if s[0] == "t":
                    break
                es.add(s[1])
                if not nullable[s[1]]:
                    break
        edges[n] = es
    color = {n: 0 for n in rules}  # 0 white / 1 on-stack / 2 done
    for root in rules:
        if color[root]:
            continue
        color[root] = 1
        stack = [(root, iter(edges[root]))]
        while stack:
            node, it = stack[-1]
            nxt = next(it, None)
            if nxt is None:
                color[node] = 2
                stack.pop()
                continue
            if color[nxt] == 1:
                raise GrammarError(
                    f"grammar: rule {nxt!r} is left-recursive (left recursion "
                    "— including via a nullable prefix or a starred nullable "
                    "group — is not supported; rewrite as right recursion)")
            if color[nxt] == 0:
                color[nxt] = 1
                stack.append((nxt, iter(edges[nxt])))


class Grammar:
    """Compiled grammar: rules (name -> tuple of alternatives, each a tuple
    of symbols), a start rule, and a CRC over the canonical encoding — the
    identity snapshots and caches are keyed on."""

    __slots__ = ("rules", "start", "crc")

    def __init__(self, rules: Dict[str, tuple], start: str):
        _check_rules(rules, start)
        self.rules = rules
        self.start = start
        canonical = json.dumps(
            {"start": start,
             "rules": {n: [[_canon_sym(s) for s in alt] for alt in alts]
                       for n, alts in sorted(rules.items())}},
            separators=(",", ":"), sort_keys=True)
        self.crc = binascii.crc32(canonical.encode()) & 0xFFFFFFFF


# ---------------------------------------------------------------- PDA core


def _closure(grammar: Grammar, configs) -> FrozenSet[tuple]:
    """Expand every nonterminal head until all heads are terminals (or the
    configuration is empty).  Terminates because left recursion is rejected
    at compile; capped at MAX_CONFIGS as the stall-class backstop."""
    out = set()
    seen = set(configs)
    stack = list(configs)
    rules = grammar.rules
    while stack:
        cfg = stack.pop()
        if cfg == () or cfg[0][0] == "t":
            out.add(cfg)
            continue
        rest = cfg[1]
        for alt in rules[cfg[0][1]]:
            nxt = rest
            for sym in reversed(alt):
                nxt = (sym, nxt)
            if nxt not in seen:
                seen.add(nxt)
                stack.append(nxt)
        if len(seen) > MAX_CONFIGS:
            raise ConstraintStall(
                f"config-set overflow (> {MAX_CONFIGS}): grammar nesting "
                "exceeds the automaton's state budget")
    return frozenset(out)


def _step(grammar: Grammar, configs, byte: int) -> FrozenSet[tuple]:
    """Consume one byte from a CLOSED config set; returns the next closed
    set (empty frozenset == byte illegal here)."""
    nxt = set()
    for cfg in configs:
        if cfg == ():
            continue  # accepting config has no continuation
        (_, term), rest = cfg
        kind, val = term
        if kind == "lit":
            if val[0] == byte:
                if len(val) > 1:
                    nxt.add((("t", ("lit", val[1:])), rest))
                else:
                    nxt.add(rest)
        elif byte in val:
            nxt.add(rest)
    if not nxt:
        return frozenset()
    return _closure(grammar, nxt)


# -------------------------------------------------------------- EBNF parser


def _lex_string(text: str, i: int):
    quote = text[i]
    i += 1
    out = bytearray()
    n = len(text)
    while i < n:
        c = text[i]
        if c == quote:
            return bytes(out), i + 1
        if c == "\\":
            if i + 1 >= n:
                raise GrammarError("grammar: unterminated escape in string")
            e = text[i + 1]
            if e == "n":
                out.append(0x0A)
            elif e == "t":
                out.append(0x09)
            elif e == "r":
                out.append(0x0D)
            elif e == "0":
                out.append(0x00)
            elif e in ("\\", "'", '"'):
                out.append(ord(e))
            elif e == "x":
                if i + 3 >= n:
                    raise GrammarError("grammar: truncated \\xNN escape")
                try:
                    out.append(int(text[i + 2:i + 4], 16))
                except ValueError:
                    raise GrammarError(
                        f"grammar: bad \\x escape {text[i:i + 4]!r}")
                i += 4
                continue
            else:
                raise GrammarError(f"grammar: unknown escape \\{e}")
            i += 2
            continue
        out.extend(c.encode("utf-8"))
        i += 1
    raise GrammarError("grammar: unterminated string literal")


def _class_char(text: str, i: int):
    """One byte inside a [...] class; returns (byte, next_index)."""
    c = text[i]
    if c == "\\":
        if i + 1 >= len(text):
            raise GrammarError("grammar: unterminated escape in class")
        e = text[i + 1]
        if e == "n":
            return 0x0A, i + 2
        if e == "t":
            return 0x09, i + 2
        if e == "r":
            return 0x0D, i + 2
        if e == "0":
            return 0x00, i + 2
        if e in ("\\", "]", "-", "^", "'", '"'):
            return ord(e), i + 2
        if e == "x":
            if i + 3 >= len(text):
                raise GrammarError("grammar: truncated \\xNN escape in class")
            try:
                return int(text[i + 2:i + 4], 16), i + 4
            except ValueError:
                raise GrammarError(f"grammar: bad \\x escape {text[i:i + 4]!r}")
        raise GrammarError(f"grammar: unknown escape \\{e} in class")
    o = ord(c)
    if o > 0xFF:
        raise GrammarError(
            f"grammar: byte classes are byte-valued; {c!r} is multi-byte — "
            "use a string literal or \\xNN")
    return o, i + 1


def _lex_class(text: str, i: int):
    i += 1  # past '['
    n = len(text)
    negate = i < n and text[i] == "^"
    if negate:
        i += 1
    bytes_in = set()
    while i < n and text[i] != "]":
        lo, i = _class_char(text, i)
        if i < n and text[i] == "-" and i + 1 < n and text[i + 1] != "]":
            hi, i = _class_char(text, i + 1)
            if hi < lo:
                raise GrammarError(f"grammar: inverted class range "
                                   f"{chr(lo)!r}-{chr(hi)!r}")
            bytes_in.update(range(lo, hi + 1))
        else:
            bytes_in.add(lo)
    if i >= n:
        raise GrammarError("grammar: unterminated [class]")
    if not bytes_in and not negate:
        raise GrammarError("grammar: empty [class]")
    if negate:
        bytes_in = set(range(256)) - bytes_in
    return frozenset(bytes_in), i + 1


def _lex_ebnf(text: str) -> List[tuple]:
    toks = []
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if c in " \t\r\n":
            i += 1
            continue
        if c == "#":
            while i < n and text[i] != "\n":
                i += 1
            continue
        if text.startswith("::=", i):
            toks.append(("op", "::=", i))
            i += 3
            continue
        if c in "=|()*+?;":
            toks.append(("op", c, i))
            i += 1
            continue
        if c in "'\"":
            val, i = _lex_string(text, i)
            toks.append(("str", val, i))
            continue
        if c == "[":
            val, i = _lex_class(text, i)
            toks.append(("cls", val, i))
            continue
        if c.isalpha() or c == "_":
            j = i
            while j < n and (text[j].isalnum() or text[j] in "_."):
                j += 1
            toks.append(("name", text[i:j], i))
            i = j
            continue
        raise GrammarError(f"grammar: unexpected character {c!r} at offset {i}")
    return toks


def compile_grammar(text: str, start: Optional[str] = None) -> Grammar:
    """EBNF subset -> Grammar.

    Syntax: ``name ::= alternation ;?`` (``=`` also accepted), ``|``
    alternatives, ``'...'``/``"..."`` byte-string literals (escapes
    ``\\n \\t \\r \\0 \\\\ \\' \\" \\xNN``), ``[a-z0-9]`` byte classes
    (ranges, escapes, leading ``^`` negation over all 256 bytes),
    ``( ... )`` groups, ``* + ?`` repetition (desugared into fresh
    right-recursive rules), ``#`` comments.  The first rule is the start
    rule unless ``start`` is given.  Left recursion is rejected.
    """
    if not isinstance(text, str):
        raise GrammarError("grammar: must be a string")
    if len(text) > MAX_GRAMMAR_BYTES:
        raise GrammarError(
            f"grammar: source too large ({len(text)} > {MAX_GRAMMAR_BYTES})")
    toks = _lex_ebnf(text)
    rules: Dict[str, tuple] = {}
    order: List[str] = []
    fresh_n = [0]
    pos = [0]

    def fresh() -> str:
        # '%' cannot start an identifier, so generated names never collide
        fresh_n[0] += 1
        return f"%{fresh_n[0]}"

    def peek():
        return toks[pos[0]] if pos[0] < len(toks) else ("eof", "", len(text))

    def take():
        t = peek()
        pos[0] += 1
        return t

    def parse_alternation() -> tuple:
        alts = [parse_concat()]
        while peek()[:2] == ("op", "|"):
            take()
            alts.append(parse_concat())
        return tuple(alts)

    def parse_concat() -> tuple:
        syms: List[tuple] = []
        while True:
            k, v, _ = peek()
            if k == "name":
                # one-token lookahead: a name followed by '::='/'=' starts
                # the NEXT rule, not a factor of this one
                if pos[0] + 1 < len(toks):
                    k2, v2, _ = toks[pos[0] + 1]
                    if k2 == "op" and v2 in ("::=", "="):
                        break
                syms.extend(parse_factor())
            elif k in ("str", "cls") or (k == "op" and v == "("):
                syms.extend(parse_factor())
            else:
                break
        return tuple(syms)

    def parse_factor() -> List[tuple]:
        prim = parse_primary()
        k, v, _ = peek()
        if k == "op" and v in "*+?":
            take()
            if len(prim) == 1:
                sym = prim[0]
            else:
                name = fresh()
                rules[name] = (tuple(prim),)
                sym = _nt(name)
            rname = fresh()
            if v == "*":
                rules[rname] = ((), (sym, _nt(rname)))
            elif v == "+":
                star = fresh()
                rules[star] = ((), (sym, _nt(star)))
                rules[rname] = ((sym, _nt(star)),)
            else:
                rules[rname] = ((), (sym,))
            return [_nt(rname)]
        return prim

    def parse_primary() -> List[tuple]:
        k, v, p = take()
        if k == "str":
            return [] if v == b"" else [("t", ("lit", v))]
        if k == "cls":
            return [("t", ("cls", v))]
        if k == "name":
            return [("nt", v)]
        if k == "op" and v == "(":
            alts = parse_alternation()
            ck, cv, _ = take()
            if (ck, cv) != ("op", ")"):
                raise GrammarError(f"grammar: expected ')' at offset {p}")
            name = fresh()
            rules[name] = alts
            return [_nt(name)]
        raise GrammarError(f"grammar: unexpected token {v!r} at offset {p}")

    while pos[0] < len(toks):
        k, name, p = take()
        if k != "name":
            raise GrammarError(f"grammar: rule name expected at offset {p}")
        k2, v2, p2 = take()
        if not (k2 == "op" and v2 in ("::=", "=")):
            raise GrammarError(f"grammar: '::=' expected at offset {p2}")
        if name in rules:
            raise GrammarError(f"grammar: duplicate rule {name!r}")
        alts = parse_alternation()
        rules[name] = alts
        order.append(name)
        if peek()[:2] == ("op", ";"):
            take()

    if not order:
        raise GrammarError("grammar: no rules defined")
    return Grammar(rules, start or order[0])


# -------------------------------------------------------- JSON-Schema compile


_JSON_PRINTABLE = frozenset(range(0x20, 0x7F)) - {0x22, 0x5C}  # minus " and \
_JSON_HEX = frozenset(b"0123456789abcdefABCDEF")
_JSON_DIGIT = frozenset(b"0123456789")
_JSON_DIGIT19 = frozenset(b"123456789")


def _json_base_rules() -> Dict[str, tuple]:
    """Compact (no-whitespace) JSON value grammar — the shared base every
    schema compiles against, and the whole grammar for format="json".
    Strings are printable-ASCII + escapes (incl. \\uXXXX), so any unicode
    payload remains expressible."""
    # every list/option rule is TAIL-FACTORED (one alternative per rule
    # until the actual branch byte): `members ::= pair | pair "," members`
    # would advance BOTH alternatives in lockstep through the whole pair,
    # doubling the live config count per nesting level (2^depth by 5 levels
    # deep); `pair members_t` keeps ONE config until the comma decides
    return {
        "j.value": ((_nt("j.object"),), (_nt("j.array"),), (_nt("j.string"),),
                    (_nt("j.number"),), (_lit("true"),), (_lit("false"),),
                    (_lit("null"),)),
        "j.object": ((_lit("{}"),),
                     (_lit("{"), _nt("j.members"), _lit("}"))),
        "j.members": ((_nt("j.pair"), _nt("j.members_t")),),
        "j.members_t": ((), (_lit(","), _nt("j.members"))),
        "j.pair": ((_nt("j.string"), _lit(":"), _nt("j.value")),),
        "j.array": ((_lit("[]"),),
                    (_lit("["), _nt("j.elements"), _lit("]"))),
        "j.elements": ((_nt("j.value"), _nt("j.elements_t")),),
        "j.elements_t": ((), (_lit(","), _nt("j.elements"))),
        "j.string": ((_lit('"'), _nt("j.chars"), _lit('"')),),
        "j.chars": ((), (_nt("j.char"), _nt("j.chars"))),
        "j.char": ((_cls(_JSON_PRINTABLE),), (_lit("\\"), _nt("j.escape"))),
        "j.escape": ((_cls(frozenset(b'"\\/bfnrt')),),
                     (_lit("u"), _cls(_JSON_HEX), _cls(_JSON_HEX),
                      _cls(_JSON_HEX), _cls(_JSON_HEX))),
        "j.number": ((_nt("j.int"), _nt("j.frac_o"), _nt("j.exp_o")),),
        "j.frac_o": ((), (_nt("j.frac"),)),
        "j.exp_o": ((), (_nt("j.exp"),)),
        "j.int": ((_lit("-"), _nt("j.uint")), (_nt("j.uint"),)),
        "j.uint": ((_lit("0"),), (_cls(_JSON_DIGIT19), _nt("j.digits"))),
        "j.digits": ((), (_cls(_JSON_DIGIT), _nt("j.digits"))),
        "j.frac": ((_lit("."), _cls(_JSON_DIGIT), _nt("j.digits")),),
        "j.exp": ((_cls(frozenset(b"eE")), _nt("j.sign"), _cls(_JSON_DIGIT),
                   _nt("j.digits")),),
        "j.sign": ((), (_cls(frozenset(b"+-")),)),
    }


_json_grammar_lock = threading.Lock()
_json_grammar_cached: Optional[Grammar] = None


def json_grammar() -> Grammar:
    """The built-in format="json" grammar (compiled once per process)."""
    global _json_grammar_cached
    with _json_grammar_lock:
        if _json_grammar_cached is None:
            _json_grammar_cached = Grammar(_json_base_rules(), "j.value")
        return _json_grammar_cached


def compile_json_schema(schema, path: str = "constrain.schema") -> Grammar:
    """JSON-Schema subset -> Grammar over the COMPACT canonical encoding
    (no whitespace; object properties in declaration order, every declared
    property emitted).

    Supported: ``type`` object (with ``properties``/``required``), array
    (``items``, ``minItems``, ``maxItems`` — unbounded via right
    recursion, bounded enumerated up to 64), string, integer, number,
    boolean, null; plus ``enum`` and ``const`` with JSON-literal members.
    Anything else is a GrammarError carrying the full ``a.b.c`` path —
    the same file-naming-error strictness engine.json parsing uses.
    """
    rules = dict(_json_base_rules())
    ctr = [0]

    def fresh(tag: str) -> str:
        ctr[0] += 1
        return f"%s.{tag}{ctr[0]}"

    def enc(v) -> str:
        try:
            return json.dumps(v, separators=(",", ":"), sort_keys=True)
        except (TypeError, ValueError):
            raise GrammarError(f"{path}: value is not JSON-encodable")

    def build(s, p: str) -> List[tuple]:
        if not isinstance(s, dict):
            raise GrammarError(f"{p}: schema node must be an object")
        allowed = {"type", "properties", "required", "items", "enum",
                   "const", "minItems", "maxItems"}
        unknown = sorted(set(s) - allowed)
        if unknown:
            raise GrammarError(f"{p}: unsupported schema key(s) {unknown} "
                               f"(supported: {sorted(allowed)})")
        if "const" in s:
            return [_lit(enc(s["const"]))]
        if "enum" in s:
            vals = s["enum"]
            if not isinstance(vals, list) or not vals:
                raise GrammarError(f"{p}.enum: must be a non-empty array")
            name = fresh("enum")
            rules[name] = tuple((_lit(enc(v)),) for v in vals)
            return [_nt(name)]
        t = s.get("type")
        if t == "string":
            return [_nt("j.string")]
        if t == "integer":
            return [_nt("j.int")]
        if t == "number":
            return [_nt("j.number")]
        if t == "boolean":
            name = fresh("bool")
            rules[name] = ((_lit("true"),), (_lit("false"),))
            return [_nt(name)]
        if t == "null":
            return [_lit("null")]
        if t == "object":
            props = s.get("properties", {})
            if not isinstance(props, dict):
                raise GrammarError(f"{p}.properties: must be an object")
            req = s.get("required", [])
            if not isinstance(req, list):
                raise GrammarError(f"{p}.required: must be an array")
            for r in req:
                if r not in props:
                    raise GrammarError(
                        f"{p}.required: unknown property {r!r}")
            if not props:
                return [_nt("j.object")]  # free-form object
            syms: List[tuple] = [_lit("{")]
            first = True
            for k, sub in props.items():
                if not isinstance(k, str):
                    raise GrammarError(f"{p}.properties: keys must be strings")
                pre = ("" if first else ",") + enc(k) + ":"
                syms.append(_lit(pre))
                syms.extend(build(sub, f"{p}.properties.{k}"))
                first = False
            syms.append(_lit("}"))
            name = fresh("obj")
            rules[name] = (tuple(syms),)
            return [_nt(name)]
        if t == "array":
            items = s.get("items")
            iname = fresh("item")
            rules[iname] = (tuple(build(items, f"{p}.items")),) \
                if items is not None else ((_nt("j.value"),),)
            isym = _nt(iname)
            m = s.get("minItems", 0)
            big = s.get("maxItems")
            if not isinstance(m, int) or isinstance(m, bool) or m < 0:
                raise GrammarError(f"{p}.minItems: must be a non-negative int")
            if big is not None and (not isinstance(big, int)
                                    or isinstance(big, bool) or big < m):
                raise GrammarError(f"{p}.maxItems: must be an int >= minItems")
            if big is not None and big > MAX_ARRAY_ITEMS:
                raise GrammarError(
                    f"{p}.maxItems: bounded arrays cap at {MAX_ARRAY_ITEMS}; "
                    "omit maxItems for an unbounded array")
            name = fresh("arr")
            if big is None:
                tname = fresh("tail")
                rules[tname] = ((), (_lit(","), isym, _nt(tname)))
                head: List[tuple] = [_lit("["), isym]
                for _ in range(max(m, 1) - 1):
                    head.extend((_lit(","), isym))
                head.extend((_nt(tname), _lit("]")))
                if m == 0:
                    rules[name] = ((_lit("[]"),), tuple(head))
                else:
                    rules[name] = (tuple(head),)
            else:
                # tail-factored count chain (NOT one alternative per count,
                # which would advance them all in lockstep): tail_i decides
                # "]" vs ",item" after the i-th item, tail_big only "]"
                tails = {i: fresh("tail") for i in range(1, big + 1)}
                for i, tname in tails.items():
                    if i >= big:
                        rules[tname] = ((),)
                    elif i < m:
                        rules[tname] = ((_lit(","), isym, _nt(tails[i + 1])),)
                    else:
                        rules[tname] = ((), (_lit(","), isym,
                                             _nt(tails[i + 1])))
                head = [_lit("["), isym, _nt(tails[1]), _lit("]")]
                if m == 0:
                    rules[name] = ((_lit("[]"),), tuple(head))
                else:
                    rules[name] = (tuple(head),)
            return [_nt(name)]
        raise GrammarError(
            f"{p}.type: unsupported type {t!r} (supported: object, array, "
            "string, integer, number, boolean, null; or enum/const)")

    root = build(schema, path)
    rules["%root"] = (tuple(root),)
    return Grammar(rules, "%root")


# ----------------------------------------------------------------- the spec


_SPEC_KEYS = ("schema", "grammar", "format", "tool")


def compile_spec(spec) -> Tuple[Grammar, str, Optional[str]]:
    """``parameters.constrain`` -> (grammar, kind, tool_name).

    Exactly one of ``schema`` (JSON-Schema object), ``grammar`` (EBNF
    string), ``format`` (the literal "json"), or ``tool``
    ({"name": str, "parameters": schema} — the grammar constrains the
    ARGUMENTS object).  Unknown keys are rejected with the same
    strictness engine.json parsing applies to its blocks."""
    if not isinstance(spec, dict):
        raise GrammarError("constrain: must be an object")
    unknown = sorted(set(spec) - set(_SPEC_KEYS))
    if unknown:
        raise GrammarError(f"constrain: unknown key(s) {unknown} "
                           f"(supported: {list(_SPEC_KEYS)})")
    keys = [k for k in _SPEC_KEYS if k in spec]
    if len(keys) != 1:
        raise GrammarError(
            "constrain: exactly one of schema | grammar | format | tool")
    k = keys[0]
    if k == "format":
        if spec["format"] != "json":
            raise GrammarError('constrain.format: only "json" is supported')
        return json_grammar(), "json", None
    if k == "grammar":
        g = spec["grammar"]
        if not isinstance(g, str):
            raise GrammarError("constrain.grammar: must be an EBNF string")
        return compile_grammar(g), "grammar", None
    if k == "schema":
        if not isinstance(spec["schema"], dict):
            raise GrammarError("constrain.schema: must be an object")
        return compile_json_schema(spec["schema"]), "schema", None
    tool = spec["tool"]
    if not isinstance(tool, dict):
        raise GrammarError("constrain.tool: must be an object")
    t_unknown = sorted(set(tool) - {"name", "parameters"})
    if t_unknown:
        raise GrammarError(f"constrain.tool: unknown key(s) {t_unknown}")
    name = tool.get("name")
    if not isinstance(name, str) or not name:
        raise GrammarError("constrain.tool.name: must be a non-empty string")
    params = tool.get("parameters")
    if not isinstance(params, dict):
        raise GrammarError("constrain.tool.parameters: must be a schema object")
    return (compile_json_schema(params, "constrain.tool.parameters"),
            "tool", name)


# ----------------------------------------------------------- tokenizer map


def token_bytes_from_tokenizer(tok) -> List[bytes]:
    """Per-id byte strings for a serve.py tokenizer (Byte/Vocab/HF).

    ByteTokenizer is identity by construction; VocabTokenizer maps through
    its ``inv`` table; anything else decodes one id at a time.  Ids that
    decode to nothing (specials) get ``b""`` and are never grammar-legal —
    eos legality is composed engine-side from ``accepting()``."""
    vocab = int(getattr(tok, "vocab_size", 0) or 0)
    if vocab <= 0:
        raise GrammarError("constrain: tokenizer has no vocabulary")
    if type(tok).__name__ == "ByteTokenizer":
        return [bytes([i % 256]) for i in range(vocab)]
    inv = getattr(tok, "inv", None)
    if isinstance(inv, dict):
        return [str(inv.get(i, "")).encode("utf-8") for i in range(vocab)]
    out = []
    for i in range(vocab):
        try:
            s = tok.decode([i])
        except Exception:
            s = ""
        out.append(s.encode("utf-8") if isinstance(s, str) else bytes(s))
    return out


class _Trie:
    __slots__ = ("children", "ids")

    def __init__(self):
        self.children: Dict[int, "_Trie"] = {}
        self.ids: List[int] = []


class TokenTable:
    """token id -> byte string, plus a byte trie over the whole vocabulary.

    Built once per vocab at registration and shared by every constraint on
    that model; ``GrammarConstraint.token_mask`` walks the trie so each
    trie node's automaton step runs ONCE per mask regardless of how many
    tokens share the prefix."""

    __slots__ = ("vocab_size", "token_bytes", "root", "crc", "skipped")

    def __init__(self, token_bytes: List[bytes]):
        self.token_bytes = [bytes(b) for b in token_bytes]
        self.vocab_size = len(self.token_bytes)
        payload = json.dumps([b.hex() for b in self.token_bytes],
                             separators=(",", ":")).encode()
        self.crc = binascii.crc32(payload) & 0xFFFFFFFF
        self.root = _Trie()
        self.skipped = 0
        for tid, bs in enumerate(self.token_bytes):
            if not bs or len(bs) > MAX_TOKEN_BYTES:
                self.skipped += 1
                continue
            node = self.root
            for b in bs:
                child = node.children.get(b)
                if child is None:
                    child = node.children[b] = _Trie()
                node = child
            node.ids.append(tid)


# -------------------------------------------------------------- constraint


class GrammarConstraint:
    """One slot's automaton: advanced per COMMITTED token, masked per tick.

    All state is the closed config frozenset plus byte/token counters, so
    ``clone()`` is O(1) (persistent stacks share structure) — the spec
    path clones per draft walk without copying anything."""

    __slots__ = ("grammar", "table", "configs", "n_tokens", "n_bytes",
                 "kind", "tool_name", "_mask_memo")

    def __init__(self, grammar: Grammar, table: TokenTable,
                 kind: str = "grammar", tool_name: Optional[str] = None,
                 _configs=None, _memo=None):
        self.grammar = grammar
        self.table = table
        self.kind = kind
        self.tool_name = tool_name
        self.n_tokens = 0
        self.n_bytes = 0
        if _configs is None:
            _configs = _closure(grammar,
                                frozenset({(("nt", grammar.start), ())}))
        self.configs = _configs
        # per-STATE mask memo, shared by every clone of this automaton:
        # decode revisits config sets constantly (an all-legal loop is ONE
        # state; a JSON grammar cycles through a handful per nesting
        # level), so steady-state ticks skip the trie DFS entirely
        self._mask_memo = {} if _memo is None else _memo

    def accepting(self) -> bool:
        """True when the bytes consumed so far form a COMPLETE sentence of
        the grammar (eos becomes legal; engine composes mask[eos] |= this)."""
        return () in self.configs

    def token_mask(self) -> np.ndarray:
        """Static-shape [V] bool mask of grammar-legal next tokens.

        # graftlint: hot-path
        Runs once per constrained slot per tick on the host: a trie DFS
        advancing the config set per byte edge — no compilation, no
        allocation beyond the mask row itself.  Masks are memoized by
        config set (the automaton state), so a revisited state costs one
        dict hit plus a row memcpy; callers own the returned row and may
        mutate it (the engine composes stop ids into it)."""
        memo = self._mask_memo
        cached = memo.get(self.configs)
        if cached is not None:
            return cached.copy()
        mask = np.zeros(self.table.vocab_size, dtype=np.bool_)
        stack = [(self.table.root, self.configs)]
        grammar = self.grammar
        while stack:
            node, cfgs = stack.pop()
            for tid in node.ids:
                mask[tid] = True
            for b, child in node.children.items():
                nxt = _step(grammar, cfgs, b)
                if nxt:
                    stack.append((child, nxt))
        if len(memo) >= 512:  # adversarial count-chains can't grow it
            memo.clear()      # unboundedly; refill beats an LRU here
        memo[self.configs] = mask
        return mask.copy()

    def advance(self, token_id: int) -> bool:
        """Consume one committed token; returns False (state UNCHANGED) if
        the token is grammar-illegal — with correct masking that cannot
        happen for a committed token, so the engine treats False as a
        stall-class fault, never an invalid output."""
        if token_id < 0 or token_id >= self.table.vocab_size:
            return False
        bs = self.table.token_bytes[token_id]
        if not bs:
            return False
        cfgs = self.configs
        for b in bs:
            cfgs = _step(self.grammar, cfgs, b)
            if not cfgs:
                return False
        self.configs = cfgs
        self.n_tokens += 1
        self.n_bytes += len(bs)
        return True

    def clone(self) -> "GrammarConstraint":
        c = GrammarConstraint(self.grammar, self.table, kind=self.kind,
                              tool_name=self.tool_name, _configs=self.configs,
                              _memo=self._mask_memo)
        c.n_tokens = self.n_tokens
        c.n_bytes = self.n_bytes
        return c

    def snapshot(self) -> dict:
        """JSON-safe byte-exact state capture — rides the slot through
        preempt/swap exactly like its KV pages, and restores cross-process
        (session tiers) because symbols serialize canonically."""
        enc = []
        for cfg in self.configs:
            syms = []
            node = cfg
            while node != ():
                syms.append(_canon_sym(node[0]))
                node = node[1]
            enc.append(syms)
        enc.sort(key=lambda s: json.dumps(s))
        return {"v": 1, "grammar_crc": self.grammar.crc,
                "table_crc": self.table.crc, "n_tokens": self.n_tokens,
                "n_bytes": self.n_bytes, "configs": enc}

    def restore(self, snap: dict) -> None:
        """Inverse of snapshot; CRC-checked against THIS grammar/table so a
        snapshot can never silently resume under the wrong automaton."""
        if not isinstance(snap, dict) or snap.get("v") != 1:
            raise GrammarError("snapshot: unsupported version")
        if int(snap.get("grammar_crc", -1)) != self.grammar.crc:
            raise GrammarError("snapshot: grammar crc mismatch")
        if int(snap.get("table_crc", -1)) != self.table.crc:
            raise GrammarError("snapshot: token-table crc mismatch")
        cfgs = set()
        for syms in snap.get("configs", ()):
            node: tuple = ()
            for s in reversed(syms):
                node = (_decode_sym(s), node)
            cfgs.add(node)
        self.configs = frozenset(cfgs)
        self.n_tokens = int(snap.get("n_tokens", 0))
        self.n_bytes = int(snap.get("n_bytes", 0))


# ---------------------------------------------------------------- registry


def _vocab_sig(tok) -> int:
    parts = [type(tok).__name__, str(int(getattr(tok, "vocab_size", 0) or 0))]
    inv = getattr(tok, "inv", None)
    if isinstance(inv, dict):
        parts.append(json.dumps(sorted((int(k), str(v))
                                       for k, v in inv.items())))
    return binascii.crc32("|".join(parts).encode()) & 0xFFFFFFFF


class ConstrainRegistry:
    """Per-model registry: tokenizer -> TokenTable (built once per vocab,
    disk-cached as ``tokmap-<sig>.json`` with a CRC over the payload) and
    spec -> Grammar (bounded in-memory cache).  A corrupt cache file —
    torn write, bit rot, or the ConstrainChaos hook — fails CRC and
    degrades to a counted re-compile, never an invalid token map."""

    def __init__(self, cache_dir: Optional[str] = None, chaos=None):
        self._lock = threading.Lock()
        self._tables: Dict[int, TokenTable] = {}
        self._grammars: Dict[str, tuple] = {}
        self.cache_dir = cache_dir
        self.chaos = chaos
        self.table_builds = 0
        self.table_cache_hits = 0
        self.table_cache_recompiles = 0
        self.grammar_compiles = 0
        self.grammar_cache_hits = 0

    def stats(self) -> dict:
        with self._lock:
            return {"table_builds": self.table_builds,
                    "table_cache_hits": self.table_cache_hits,
                    "table_cache_recompiles": self.table_cache_recompiles,
                    "grammar_compiles": self.grammar_compiles,
                    "grammar_cache_hits": self.grammar_cache_hits}

    # ---- token tables

    def table_for(self, tok) -> TokenTable:
        sig = _vocab_sig(tok)
        with self._lock:
            t = self._tables.get(sig)
        if t is not None:
            return t
        table = self._load_or_build(sig, tok)
        with self._lock:
            # a lost race keeps the first table: constraints share identity
            return self._tables.setdefault(sig, table)

    def _cache_path(self, sig: int) -> str:
        return os.path.join(self.cache_dir, f"tokmap-{sig:08x}.json")

    def _load_or_build(self, sig: int, tok) -> TokenTable:
        if self.cache_dir:
            path = self._cache_path(sig)
            if os.path.exists(path):
                try:
                    with open(path, "rb") as f:
                        data = f.read()
                    chaos = self.chaos
                    if chaos is not None and hasattr(chaos, "on_cache_read"):
                        data = chaos.on_cache_read(data)
                    obj = json.loads(data)
                    payload = json.dumps(obj["tokens"],
                                         separators=(",", ":")).encode()
                    if (binascii.crc32(payload) & 0xFFFFFFFF) != int(obj["crc"]):
                        raise GrammarError("token-map cache crc mismatch")
                    table = TokenTable([bytes.fromhex(h)
                                        for h in obj["tokens"]])
                    with self._lock:
                        self.table_cache_hits += 1
                    return table
                except Exception:
                    # corrupt cache degrades to a counted re-compile —
                    # the CRC gate means it can never corrupt a mask
                    with self._lock:
                        self.table_cache_recompiles += 1
        table = TokenTable(token_bytes_from_tokenizer(tok))
        with self._lock:
            self.table_builds += 1
        if self.cache_dir:
            self._write_cache(sig, table)
        return table

    def _write_cache(self, sig: int, table: TokenTable) -> None:
        try:
            os.makedirs(self.cache_dir, exist_ok=True)
            toks = [b.hex() for b in table.token_bytes]
            payload = json.dumps(toks, separators=(",", ":")).encode()
            obj = {"crc": binascii.crc32(payload) & 0xFFFFFFFF,
                   "tokens": toks}
            path = self._cache_path(sig)
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(obj, f)
            os.replace(tmp, path)  # readers see old-or-new, never torn
        except OSError:
            pass  # the in-memory table is authoritative; cache is best-effort

    # ---- grammars

    def grammar_for(self, spec) -> tuple:
        try:
            key = json.dumps(spec, sort_keys=True, separators=(",", ":"))
        except (TypeError, ValueError):
            raise GrammarError("constrain: spec is not JSON-encodable")
        if len(key) > MAX_GRAMMAR_BYTES:
            raise GrammarError(
                f"constrain: spec too large ({len(key)} > {MAX_GRAMMAR_BYTES})")
        with self._lock:
            ent = self._grammars.get(key)
            if ent is not None:
                self.grammar_cache_hits += 1
                return ent
        ent = compile_spec(spec)
        with self._lock:
            if len(self._grammars) >= 512:  # bounded: distinct SPECS, not rids
                self._grammars.clear()
            self._grammars[key] = ent
            self.grammar_compiles += 1
        return ent

    def constraint(self, spec, tok) -> GrammarConstraint:
        """spec + tokenizer -> a fresh slot automaton (the admission path:
        everything expensive — compile, vocab map — is memoized here)."""
        grammar, kind, tool = self.grammar_for(spec)
        table = self.table_for(tok)
        return GrammarConstraint(grammar, table, kind=kind, tool_name=tool)
