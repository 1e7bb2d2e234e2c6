"""KDL document parser.

A small, dependency-free recursive-descent parser for the KDL configuration
language (https://kdl.dev), covering the surface the fleet config language
uses (reference: crates/fleetflow-core/src/parser/*.rs parses KDL via kdl-rs;
we parse the same documents natively):

  - nodes with string/number/bool/null arguments and key=value properties
  - children blocks ``{ ... }``, ``;`` node terminators
  - ``//`` line comments, nestable ``/* */`` block comments,
    ``/-`` slash-dash comments (node / entry / children-block)
  - escaped strings, raw strings ``r"..."`` / ``r#"..."#``
  - decimal / hex / octal / binary numbers with ``_`` separators
  - ``\\`` line continuations
  - ``(type)`` annotations (parsed and stored, not interpreted)

The output is a list of :class:`KdlNode`. This module is the port's copy of
``fleetflow_tpu/core/kdl.py``; tests/test_torch_kdl.py holds it to that
module on the reference's parser test corpus
(crates/fleetflow-core/src/parser/tests.rs).
"""

from __future__ import annotations

import os
import re
from bisect import bisect_left
from dataclasses import dataclass, field
from typing import Any, Iterator, Optional

__all__ = ["KdlNode", "KdlError", "parse_document", "format_document"]


class KdlError(ValueError):
    """Raised on malformed KDL input, with 1-based line/column context."""

    def __init__(self, message: str, line: int, col: int):
        super().__init__(f"KDL parse error at {line}:{col}: {message}")
        self.message = message
        self.line = line
        self.col = col

    def __reduce__(self):
        # default exception pickling replays __init__ with the FORMATTED
        # args tuple (wrong arity); parse errors cross process boundaries
        # on the parallel-ingest path, so rebuild from the raw triple
        return (type(self), (self.message, self.line, self.col))


_BOOL_TRUE = frozenset(("true", "1", "yes", "on"))
_BOOL_FALSE = frozenset(("false", "0", "no", "off", ""))


def bool_value(v, node: Optional["KdlNode"] = None) -> bool:
    """Coerce a KDL value to bool: keyword booleans (#true/#false) arrive
    as real bools, but bare-word `true`/`false` arrive as STRINGS — and
    bool("false") is True, so naive coercion silently enables whatever a
    config said to disable. One definition, shared by the flow parser and
    the daemon config.

    Only the exact spellings true/1/yes/on and false/0/no/off (any case)
    are accepted; anything else raises — a typo like `enabled "flase"`
    must be a loud config error, not a silently-enabled feature (the
    mirror image of the bool("false") trap this helper exists to stop).
    When the owning `node` is passed and carries a span, the error is a
    positioned :class:`KdlError`, so a strict-bool failure points at
    file:line like every other parse error (KdlError IS a ValueError, so
    existing handlers keep working).
    """
    if isinstance(v, str):
        s = v.strip().lower()
        if s in _BOOL_TRUE:
            return True
        if s in _BOOL_FALSE:
            return False
        msg = (f"invalid boolean value {v!r} (expected one of: "
               f"{'/'.join(sorted(_BOOL_TRUE))} or "
               f"{'/'.join(sorted(x for x in _BOOL_FALSE if x))})")
        if node is not None and node.line:
            raise KdlError(msg, node.line, node.col)
        raise ValueError(msg)
    return bool(v)


@dataclass(slots=True)
class KdlNode:
    """A single KDL node: ``name arg1 arg2 key=value { children }``.

    ``line``/``col`` are the 1-based source position of the node's name
    token, recorded by the pure-Python parser (0 = unknown, e.g. nodes
    built programmatically or by the native fast path). They are excluded
    from equality so span-carrying and span-less parses of the same text
    stay ``==`` (the native-parity contract, tests/test_torch_native_kdl.py).
    """

    name: str
    args: list[Any] = field(default_factory=list)
    props: dict[str, Any] = field(default_factory=dict)
    children: list["KdlNode"] = field(default_factory=list)
    type_annotation: Optional[str] = None
    line: int = field(default=0, compare=False, repr=False)
    col: int = field(default=0, compare=False, repr=False)

    def __getattr__(self, name: str):
        # the native assemblers (native/kdl.py ctypes path, native/kdlpy.cpp
        # via tp_new) bypass __init__ and only set the content fields; with
        # slots=True an unset span slot would raise on read, so fall back
        # to 0 ("no span") instead of requiring a lockstep native rebuild
        if name in ("line", "col"):
            return 0
        raise AttributeError(name)

    # -- convenience accessors used throughout the config parsers ----------

    def arg(self, i: int = 0, default: Any = None) -> Any:
        return self.args[i] if i < len(self.args) else default

    def prop(self, key: str, default: Any = None) -> Any:
        return self.props.get(key, default)

    def child(self, name: str) -> Optional["KdlNode"]:
        for c in self.children:
            if c.name == name:
                return c
        return None

    def children_named(self, name: str) -> Iterator["KdlNode"]:
        return (c for c in self.children if c.name == name)

    def first_string(self, default: Any = None) -> Any:
        """First argument coerced to str (fleet configs use string-ish args)."""
        v = self.arg(0, default)
        if v is None:
            return default
        return v if isinstance(v, str) else _value_to_str(v)


def _value_to_str(v: Any) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return str(v)


# Characters that terminate a bare identifier.
_NON_IDENTIFIER = set('\\/(){}<>;[]=,"')
_WS_CHARS = (" \t\ufeff\u00a0\u1680\u2000\u2001\u2002\u2003\u2004\u2005\u2006"
             "\u2007\u2008\u2009\u200a\u202f\u205f\u3000")
_NL_CHARS = "\r\n\x0c\u0085\u2028\u2029"
_WS = set(_WS_CHARS)
_NEWLINES = set(_NL_CHARS)

# -- precompiled token regexes (the hot-loop rewrite) -----------------------
# The scanner used to walk characters one peek() at a time (~400k calls on a
# fleet-scale document). Each regex below consumes exactly the run the old
# per-char loop consumed, so token boundaries \u2014 and therefore every parse
# and every error position \u2014 are unchanged. The rare/ambiguous corners
# (escaped strings, exotic digits) fall back to the original per-char code.
_RX_WS = re.compile("[%s]+" % re.escape(_WS_CHARS))
# ws / newlines / line comments, interleaved in any order: the entire
# inter-node gap in one match (parse_nodes' dominant skip)
_RX_GAP = re.compile("(?:[%s%s]+|//[^%s]*)+"
                     % (re.escape(_WS_CHARS), re.escape(_NL_CHARS),
                        re.escape(_NL_CHARS)))
_RX_LINE_COMMENT = re.compile("//[^%s]*" % re.escape(_NL_CHARS))
_RX_BLOCK_DELIM = re.compile(r"/\*|\*/")
_RX_IDENT = re.compile("[^%s]+" % re.escape(
    "".join(sorted(_NON_IDENTIFIER)) + _WS_CHARS + _NL_CHARS))
# a complete terminated string, escapes included ([^"\\] spans newlines)
_RX_STRING = re.compile(r'"[^"\\]*(?:\\.[^"\\]*)*"', re.DOTALL)
# exactly the runs the per-char number scanner consumes (incl. its quirks:
# multiple '.' accepted when digit-followed, one exponent, digits optional
# after a radix prefix \u2014 conversion errors reproduce "bad number ...").
# The dot lookahead is \d, not [0-9]: the scanner's peek(1).isdigit() is
# unicode-wide, so `1.\u0663` must consume "1." (then error on the lone \u0663)
# exactly as the per-char code did.
_RX_NUMBER = re.compile(
    r"[+-]?(?=[0-9])(?:"
    r"0[xX][0-9a-fA-F_]*"
    r"|0[oO][0-7_]*"
    r"|0[bB][01_]*"
    r"|(?:[0-9_]|\.(?=\d))+(?:[eE][+-]?(?:[0-9_]|\.(?=\d))*)?"
    r")")
_NUM_SRC = _RX_NUMBER.pattern
_IDENT_SRC = _RX_IDENT.pattern
# one master regex per node ENTRY: horizontal ws, then the next token, in
# one match. Covers the overwhelmingly common entry forms — escape-free
# string / number / ident=prop / bare ident / terminator / brace. Anything
# else (comments, (type) annotations, /- entries, raw strings, #keywords,
# escaped strings, continuations, malformed input) fails the alternation
# and replays through _entry_fallback, the original general path.
# `special` catches raw-string starts and '#' so `r"..."`/`#true` never
# half-match as identifiers.
_RX_ENTRY = re.compile(
    "[%s]*(?:" % re.escape(_WS_CHARS) +
    '(?P<estr>"[^"\\\\]*")' +
    "|(?P<num>%s)" % _NUM_SRC +
    '|(?P<special>r["#]|#)' +
    "|(?P<prop>%s)=" % _IDENT_SRC +
    "|(?P<ident>%s)" % _IDENT_SRC +
    "|(?P<term>;|\r\n|[%s])" % re.escape(_NL_CHARS) +
    "|(?P<brace>[{}])" +
    ")", re.DOTALL)
_BARE_WORDS = {"true": True, "false": False, "null": None}
# node-level master: the inter-node gap (ws / newlines / semicolons / line
# comments, interleaved) plus a bare-identifier node name, one match per
# node. Quoted/annotated/slash-dashed names, block comments, EOF and '}'
# miss and take the general path. The gap is made ATOMIC via the
# lookahead-capture trick ((?=(?P<gap>...))(?P=gap)): a plain
# `(?:[class]+|...)*` followed by a required name backtracks
# exponentially when the name can't match (~30 gap chars before EOF or a
# quoted name would hang the parser); lookarounds don't backtrack, so
# the maximal gap is committed in one pass and a name failure fails the
# whole match immediately.
_RX_NODE_START = re.compile(
    "(?=(?P<gap>(?:[%s%s;]+|//[^%s]*(?=[%s]|$))*))(?P=gap)(?P<name>%s)"
    % (re.escape(_WS_CHARS), re.escape(_NL_CHARS), re.escape(_NL_CHARS),
       re.escape(_NL_CHARS), _IDENT_SRC))


MAX_DEPTH = 128    # a document nested deeper is hostile or broken — fail
                   # with a parse error, not a Python RecursionError


class _Parser:
    def __init__(self, text: str, record_spans: bool = False,
                 line_offset: int = 0):
        self.text = text
        self.pos = 0
        self.n = len(text)
        self.depth = 0
        # span recording is opt-in so the want_spans contract holds on
        # every path: a parse WITHOUT want_spans yields span-less nodes
        # whether it ran natively or fell back to this parser
        self.record_spans = record_spans
        # line_offset shifts every reported line (spans AND errors): the
        # loader parses each rendered file as its own fragment but keeps
        # positions in the multi-file concatenation's coordinates, which
        # the lint SourceMap resolves back to files
        self.line_offset = line_offset
        self._nl: Optional[list[int]] = None  # newline index, built lazily

    # -- position helpers ---------------------------------------------------

    def _line_col_at(self, pos: int) -> tuple[int, int]:
        """1-based (line, col) of `pos`, O(log n) via a one-time newline
        index (the old slice-and-count was O(pos) per lookup — fine for a
        single error, quadratic once every node records its span)."""
        if self._nl is None:
            nl, find = [], self.text.find
            i = find("\n")
            while i != -1:
                nl.append(i)
                i = find("\n", i + 1)
            self._nl = nl
        line = bisect_left(self._nl, pos) + 1
        col = pos - (self._nl[line - 2] + 1 if line > 1 else 0) + 1
        return line + self.line_offset, col

    def _line_col(self) -> tuple[int, int]:
        return self._line_col_at(self.pos)

    def error(self, msg: str) -> KdlError:
        line, col = self._line_col()
        return KdlError(msg, line, col)

    # -- low-level cursor ---------------------------------------------------

    def peek(self, off: int = 0) -> str:
        i = self.pos + off
        return self.text[i] if i < self.n else ""

    def at_end(self) -> bool:
        return self.pos >= self.n

    def startswith(self, s: str) -> bool:
        return self.text.startswith(s, self.pos)

    # -- whitespace / comments ---------------------------------------------

    def _skip_block_comment(self) -> None:
        # nestable /* */: regex-scan for the next delimiter instead of
        # stepping one char at a time
        start = self.pos
        pos = start + 2
        depth = 1
        while depth:
            m = _RX_BLOCK_DELIM.search(self.text, pos)
            if m is None:
                self.pos = start
                raise self.error("unterminated block comment")
            depth += 1 if m.group() == "/*" else -1
            pos = m.end()
        self.pos = pos

    def skip_ws(self, newlines: bool = False) -> None:
        """Skip horizontal whitespace, comments, and line continuations.

        With ``newlines=True`` also skips newlines and line (``//``) comments;
        otherwise stops at a newline (which terminates a node).
        """
        text, n = self.text, self.n
        rx = _RX_GAP if newlines else _RX_WS
        pos = self.pos
        while pos < n:
            m = rx.match(text, pos)
            if m is not None:
                pos = m.end()
                if pos >= n:
                    break
            c = text[pos]
            if c == "/" and text.startswith("/*", pos):
                self.pos = pos
                self._skip_block_comment()
                pos = self.pos
            elif c == "\\" and not newlines:
                # line continuation: \ ws* (// comment)? newline
                save = pos
                pos += 1
                m = _RX_WS.match(text, pos)
                if m is not None:
                    pos = m.end()
                m = _RX_LINE_COMMENT.match(text, pos)
                if m is not None:
                    pos = m.end()
                if pos < n and text[pos] in _NEWLINES:
                    pos += 2 if text.startswith("\r\n", pos) else 1
                else:
                    self.pos = save
                    return
            else:
                break
        self.pos = pos

    def _consume_newline(self) -> None:
        if self.startswith("\r\n"):
            self.pos += 2
        elif self.peek() in _NEWLINES:
            self.pos += 1

    # -- tokens -------------------------------------------------------------

    def parse_string(self) -> str:
        # fast path: one regex match spans the whole terminated string; the
        # escape-free common case returns a single slice. Strings with
        # escapes (or unterminated ones) replay through the per-char
        # decoder, which owns the exact error positions.
        m = _RX_STRING.match(self.text, self.pos)
        if m is not None:
            tok = m.group()
            if "\\" not in tok:
                self.pos = m.end()
                return tok[1:-1]
        return self._parse_string_slow()

    def _parse_string_slow(self) -> str:
        assert self.peek() == '"'
        self.pos += 1
        out: list[str] = []
        while True:
            if self.at_end():
                raise self.error("unterminated string")
            c = self.peek()
            if c == '"':
                self.pos += 1
                return "".join(out)
            if c == "\\":
                self.pos += 1
                e = self.peek()
                simple = {"n": "\n", "t": "\t", "r": "\r", "\\": "\\",
                          '"': '"', "b": "\b", "f": "\f", "/": "/",
                          "s": " "}
                if e in simple:
                    out.append(simple[e])
                    self.pos += 1
                elif e == "u":
                    self.pos += 1
                    if self.peek() != "{":
                        raise self.error("expected '{' in \\u escape")
                    self.pos += 1
                    hexdigits = []
                    while self.peek() != "}":
                        if self.at_end() or len(hexdigits) > 6:
                            raise self.error("bad \\u escape")
                        hexdigits.append(self.peek())
                        self.pos += 1
                    self.pos += 1
                    try:
                        out.append(chr(int("".join(hexdigits), 16)))
                    except ValueError:
                        raise self.error("bad \\u escape") from None
                else:
                    raise self.error(f"unknown escape '\\{e}'")
            else:
                out.append(c)
                self.pos += 1

    def parse_raw_string(self) -> str:
        # r"..."  or  r#"..."#  (any number of #)
        assert self.peek() == "r"
        start = self.pos
        self.pos += 1
        hashes = 0
        while self.peek() == "#":
            hashes += 1
            self.pos += 1
        if self.peek() != '"':
            self.pos = start
            raise self.error("malformed raw string")
        self.pos += 1
        terminator = '"' + "#" * hashes
        end = self.text.find(terminator, self.pos)
        if end < 0:
            self.pos = start
            raise self.error("unterminated raw string")
        s = self.text[self.pos : end]
        self.pos = end + len(terminator)
        return s

    def parse_number(self) -> Any:
        # fast path: the regex consumes exactly the run the per-char scanner
        # consumed; conversion failures raise the same "bad number" at the
        # same position — except a bare exponent at EOF ("1e"), where the
        # old scanner's `peek() in "+-"` was True for "" and stepped one
        # past the end; the regex reports the correct column. Leading
        # unicode-digit oddities (isdigit() is wider than [0-9]) miss the
        # regex and replay through the original scanner.
        m = _RX_NUMBER.match(self.text, self.pos)
        if m is None:
            return self._parse_number_slow()
        self.pos = m.end()
        return self._number_value(m.group())

    def _number_value(self, tok: str) -> Any:
        """Convert a _RX_NUMBER token; self.pos must already sit at the
        token end so "bad number" errors point where the scanner's did."""
        body = tok[1:] if tok[0] in "+-" else tok
        prefix = body[:2].lower()
        if prefix in ("0x", "0o", "0b"):
            digits = body[2:].replace("_", "")
            sign = -1 if tok[0] == "-" else 1
            try:
                return sign * int(digits,
                                  {"0x": 16, "0o": 8, "0b": 2}[prefix])
            except ValueError:
                raise self.error(f"bad number {digits!r}") from None
        dec = tok.replace("_", "")
        try:
            if "." in dec or "e" in dec or "E" in dec:
                return float(dec)
            return int(dec)
        except ValueError:
            raise self.error(f"bad number {dec!r}") from None

    def _parse_number_slow(self) -> Any:
        start = self.pos
        if self.peek() in "+-":
            self.pos += 1
        two = self.text[self.pos : self.pos + 2].lower()
        digits: str
        base = 10
        if two == "0x":
            base, allowed = 16, "0123456789abcdefABCDEF_"
            self.pos += 2
        elif two == "0o":
            base, allowed = 8, "01234567_"
            self.pos += 2
        elif two == "0b":
            base, allowed = 2, "01_"
            self.pos += 2
        else:
            allowed = "0123456789_.eE+-"
        tok_start = self.pos
        if base == 10:
            # decimal: digits, optional fraction / exponent
            seen_e = False
            while not self.at_end():
                c = self.peek()
                if c in "0123456789_":
                    self.pos += 1
                elif c == "." and self.peek(1).isdigit():
                    self.pos += 1
                elif c in "eE" and not seen_e:
                    seen_e = True
                    self.pos += 1
                    if self.peek() in "+-":
                        self.pos += 1
                else:
                    break
            tok = self.text[start : self.pos].replace("_", "")
            try:
                if any(ch in tok for ch in ".eE"):
                    return float(tok)
                return int(tok)
            except ValueError:
                raise self.error(f"bad number {tok!r}") from None
        else:
            while not self.at_end() and self.peek() in allowed:
                self.pos += 1
            tok = self.text[tok_start : self.pos].replace("_", "")
            sign = -1 if self.text[start] == "-" else 1
            try:
                return sign * int(tok, base)
            except ValueError:
                raise self.error(f"bad number {tok!r}") from None

    def parse_identifier(self) -> str:
        m = _RX_IDENT.match(self.text, self.pos)
        if m is None:
            raise self.error("expected identifier")
        self.pos = m.end()
        return m.group()

    def _at_value_start(self) -> bool:
        c = self.peek()
        if c == '"':
            return True
        if c == "r" and (self.peek(1) == '"' or self.peek(1) == "#"):
            return True
        if c == "#" and self.peek(1).isalpha():
            return True   # KDL v2 keyword (#true/#false/#null/#inf/#nan)
        if c.isdigit():
            return True
        if c in "+-" and self.peek(1).isdigit():
            return True
        return False

    def parse_value(self) -> Any:
        c = self.peek()
        if c == '"':
            return self.parse_string()
        if c == "r" and (self.peek(1) == '"' or self.peek(1) == "#"):
            return self.parse_raw_string()
        if c.isdigit() or (c in "+-" and self.peek(1).isdigit()):
            return self.parse_number()
        if c == "#":
            # KDL v2 keywords: #true / #false / #null
            self.pos += 1
            kw = self.parse_identifier()
            if kw == "true":
                return True
            if kw == "false":
                return False
            if kw in ("null", "nan", "inf", "-inf"):
                return {"null": None, "nan": float("nan"),
                        "inf": float("inf"), "-inf": float("-inf")}[kw]
            raise self.error(f"unknown keyword #{kw}")
        ident = self.parse_identifier()
        if ident == "true":
            return True
        if ident == "false":
            return False
        if ident == "null":
            return None
        # Lenient mode: bare words as string values (strict KDL rejects these,
        # but fleet configs in the wild use them for enum-ish fields).
        return ident

    # -- nodes ----------------------------------------------------------------

    def parse_type_annotation(self) -> Optional[str]:
        if self.peek() != "(":
            return None
        self.pos += 1
        ty = self.parse_identifier() if self.peek() != '"' else self.parse_string()
        if self.peek() != ")":
            raise self.error("expected ')' after type annotation")
        self.pos += 1
        return ty

    def parse_node(self) -> Optional[KdlNode]:
        """Parse one node. Returns None for a slash-dash'd node."""
        text = self.text
        slashdash = False
        if text.startswith("/-", self.pos):
            slashdash = True
            self.pos += 2
            self.skip_ws(newlines=True)
        name_pos = self.pos
        ty = self.parse_type_annotation()
        if text[self.pos : self.pos + 1] == '"':
            name = self.parse_string()
        else:
            name = self.parse_identifier()
        node = self._node_tail(name, ty, name_pos)
        return None if slashdash else node

    def _node_tail(self, name: str, ty: Optional[str],
                   name_pos: int) -> KdlNode:
        """Entries + children of a node whose name token is consumed."""
        text = self.text
        node = KdlNode(name=name, type_annotation=ty)
        if self.record_spans:
            node.line, node.col = self._line_col_at(name_pos)

        # entry loop: one master-regex match per argument/property in the
        # common case; everything it can't express takes _entry_fallback
        # (the original general path, bit-for-bit)
        args_append = node.args.append
        props = node.props
        entry_match = _RX_ENTRY.match
        while True:
            m = entry_match(text, self.pos)
            if m is None:
                if self._entry_fallback(node):
                    break
                continue
            g = m.lastgroup
            if g == "estr":
                self.pos = m.end()
                args_append(m.group("estr")[1:-1])
            elif g == "num":
                self.pos = m.end()
                args_append(self._number_value(m.group("num")))
            elif g == "prop":
                tok = m.group("prop")
                if tok[0].isdigit() or (tok[0] in "+-"
                                        and tok[1:2].isdigit()):
                    # non-ASCII digit (isdigit() is wider than [0-9]): the
                    # scanner treats it as a value start — general path
                    if self._entry_fallback(node):
                        break
                    continue
                self.pos = m.end()
                props[tok] = self.parse_value()
            elif g == "ident":
                tok = m.group("ident")
                if tok[0].isdigit() or (tok[0] in "+-"
                                        and tok[1:2].isdigit()):
                    if self._entry_fallback(node):
                        break
                    continue
                self.pos = m.end()
                args_append(_BARE_WORDS.get(tok, tok))
            elif g == "term":
                self.pos = m.end()
                break
            elif g == "brace":
                if m.group("brace") == "{":
                    # children terminate the node (KDL spec: nothing may
                    # follow a children block). Anything after `}` on the
                    # same line parses as a sibling node, so
                    # `capacity { cpu 4 } labels { ... }` reads naturally.
                    self.pos = m.end()
                    self.depth += 1
                    if self.depth > MAX_DEPTH:
                        raise self.error(f"children nested deeper than "
                                         f"{MAX_DEPTH} levels")
                    node.children = self.parse_nodes(until_brace=True)
                    self.depth -= 1
                else:
                    # let caller consume the closing brace
                    self.pos = m.start("brace")
                break
            else:
                # special (raw-string start / '#'): general path owns it
                if self._entry_fallback(node):
                    break
        return node

    def _entry_fallback(self, node: KdlNode) -> bool:
        """One node entry via the general path: comments, ``(type)``
        annotations, ``/-`` entries, raw strings, ``#`` keywords, escaped
        strings, line continuations, EOF — and the error corners. Returns
        True when the node ends (terminator/children/EOF/closing brace)."""
        text, n = self.text, self.n
        self.skip_ws(newlines=False)
        pos = self.pos
        if pos >= n:
            return True
        c = text[pos]
        if c in _NEWLINES or c == ";":
            if c == ";":
                self.pos = pos + 1
            else:
                self._consume_newline()
            return True
        if c == "/" and text.startswith("//", pos):
            m = _RX_LINE_COMMENT.match(text, pos)
            self.pos = m.end()
            return False
        if c == "{":
            self.pos += 1
            self.depth += 1
            if self.depth > MAX_DEPTH:
                raise self.error(f"children nested deeper than "
                                 f"{MAX_DEPTH} levels")
            node.children = self.parse_nodes(until_brace=True)
            self.depth -= 1
            return True
        if c == "}":
            return True  # let caller consume the closing brace

        entry_slashdash = False
        if c == "/" and text.startswith("/-", pos):
            entry_slashdash = True
            self.pos = pos + 2
            self.skip_ws(newlines=False)
            if self.peek() == "{":
                self.pos += 1
                self.depth += 1
                if self.depth > MAX_DEPTH:
                    raise self.error(f"children nested deeper than "
                                     f"{MAX_DEPTH} levels")
                self.parse_nodes(until_brace=True)  # discard
                self.depth -= 1
                return False
            # refresh: c was peeked before the `/-` was consumed, so a
            # slash-dashed annotated entry (`a /- (t)5`) must re-peek to
            # see the '(' (parity with native/kdl.cpp, which accepts it)
            c = self.peek()

        if c == "(":
            # (type)value annotation on an argument: parse and discard
            # the annotation, keep the value
            self.parse_type_annotation()
            val = self.parse_value()
            if not entry_slashdash:
                node.args.append(val)
            return False

        if self._at_value_start():
            val = self.parse_value()
            if not entry_slashdash:
                node.args.append(val)
            return False

        # identifier: either prop key or bare-word arg
        ident = self.parse_identifier()
        if text[self.pos : self.pos + 1] == "=":
            self.pos += 1
            val = self.parse_value()
            if not entry_slashdash:
                node.props[ident] = val
        elif not entry_slashdash:
            node.args.append(_BARE_WORDS.get(ident, ident))
        return False

    def parse_nodes(self, until_brace: bool = False) -> list[KdlNode]:
        text, n_len = self.text, self.n
        nodes: list[KdlNode] = []
        append = nodes.append
        start_match = _RX_NODE_START.match
        while True:
            # fast path: gap + bare node name in one match
            m = start_match(text, self.pos)
            if m is not None:
                self.pos = m.end()
                append(self._node_tail(m.group("name"), None,
                                       m.start("name")))
                continue
            self.skip_ws(newlines=True)
            while text.startswith(";", self.pos):
                self.pos += 1
                self.skip_ws(newlines=True)
            if self.pos >= n_len:
                if until_brace:
                    raise self.error("unexpected EOF, expected '}'")
                return nodes
            if text[self.pos] == "}":
                if until_brace:
                    self.pos += 1
                    return nodes
                raise self.error("unexpected '}'")
            n = self.parse_node()
            if n is not None:
                append(n)


def parse_document(text: str, *, want_spans: bool = False,
                   line_offset: int = 0) -> list[KdlNode]:
    """Parse a KDL document into a list of top-level nodes.

    Uses the native parser (csrc/host/kdl.cpp, built with g++ at its first
    use; native/kdl.py) as the fast path, and this pure-Python parser when
    the document needs it: the native parser returns None on ANY parse
    error or unsupported corner, so every error path re-parses here and
    raises the canonical KdlError with codepoint-exact line/col. A native
    library that cannot be built raises RuntimeError (no quiet fallback).
    Parity across the full corpus is enforced by tests/test_torch_kdl.py
    and tests/test_torch_native_kdl.py. Set FLEET_KDL_NATIVE=0 to force
    pure Python.

    ``want_spans=True`` forces the pure-Python parser so every node carries
    its 1-based line/col (the native export has no position channel) —
    the `fleet lint` path, where diagnostics must point at source.
    ``line_offset`` shifts every reported line (spans and error positions)
    by a constant — per-fragment parses of a multi-file concatenation keep
    concatenation coordinates.
    """
    if not want_spans and \
            os.environ.get("FLEET_KDL_NATIVE", "1").lower() not in ("0", "false"):
        from ..native.kdl import native_parse_document
        nodes = native_parse_document(text)
        if nodes is not None:
            return nodes
    return _Parser(text, record_spans=want_spans,
                   line_offset=line_offset).parse_nodes()


def _format_value(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return repr(v)
    s = str(v)
    escaped = s.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    return f'"{escaped}"'


def _format_node(node: KdlNode, indent: int) -> list[str]:
    pad = "    " * indent
    parts = [node.name if _is_bare(node.name) else _format_value(node.name)]
    parts += [_format_value(a) for a in node.args]
    parts += [f"{k}={_format_value(v)}" for k, v in node.props.items()]
    line = pad + " ".join(parts)
    if not node.children:
        return [line]
    lines = [line + " {"]
    for c in node.children:
        lines.extend(_format_node(c, indent + 1))
    lines.append(pad + "}")
    return lines


def _is_bare(name: str) -> bool:
    if not name or name[0].isdigit():
        return False
    return not any(c in _NON_IDENTIFIER or c in _WS or c in _NEWLINES for c in name)


def format_document(nodes: list[KdlNode]) -> str:
    """Serialize nodes back to KDL text (used by init wizard / quadlet sync)."""
    out: list[str] = []
    for n in nodes:
        out.extend(_format_node(n, 0))
    return "\n".join(out) + "\n"
