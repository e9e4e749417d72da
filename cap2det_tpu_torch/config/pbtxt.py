"""A small proto2 text-format (pbtxt) parser.

The port's own copy of ``cap2det_tpu/config/pbtxt.py``. Parses the
experiment configs under ``configs/`` into nested Python dicts without
requiring protoc or generated message classes.

Supported syntax:
  - `field: value` scalars (int, float, bool, enum identifier, "string")
  - adjacent string concatenation (`f: "a" "b"`)
  - `message { ... }` and `message: { ... }` submessages
  - extension keys: `[Cap2DetModel.ext] { ... }`
  - repeated fields (same key occurring multiple times accumulates a list)
  - `#` comments

The output of :func:`parse` is a dict mapping field name -> value, where a
repeated field maps to ``RepeatedValue`` (a list subclass) and a submessage
maps to a dict. The typed config layer (`schema.py`) consumes this.
"""

from __future__ import annotations

import re


class RepeatedValue(list):
    """Marks a field that occurred more than once (proto2 repeated)."""


_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+)
  | (?P<comment>\#[^\n]*)
  | (?P<string>"(?:[^"\\]|\\.)*"|'(?:[^'\\]|\\.)*')
  | (?P<extkey>\[[A-Za-z_][\w./]*\])
  | (?P<punct>[{}:,;])
  | (?P<scalar>[^\s{}:,;#"']+)
    """,
    re.VERBOSE,
)


def _tokenize(text):
    tokens = []
    pos = 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if m is None:
            raise ValueError("pbtxt: cannot tokenize at %r" % text[pos : pos + 40])
        pos = m.end()
        kind = m.lastgroup
        if kind in ("ws", "comment"):
            continue
        tokens.append((kind, m.group()))
    return tokens


_ESCAPES = {
    "n": "\n",
    "t": "\t",
    "r": "\r",
    "\\": "\\",
    '"': '"',
    "'": "'",
    "0": "\0",
}


def _unquote(tok):
    body = tok[1:-1]
    out = []
    i = 0
    while i < len(body):
        c = body[i]
        if c == "\\" and i + 1 < len(body):
            out.append(_ESCAPES.get(body[i + 1], body[i + 1]))
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


_INT_RE = re.compile(r"^[+-]?\d+$")
_FLOAT_RE = re.compile(r"^[+-]?(\d+\.\d*|\.\d+|\d+)([eE][+-]?\d+)?$")


def _coerce_scalar(tok):
    if tok == "true":
        return True
    if tok == "false":
        return False
    if _INT_RE.match(tok):
        return int(tok)
    if _FLOAT_RE.match(tok) and any(ch in tok for ch in ".eE"):
        return float(tok)
    # Enum identifier or bareword; keep as string.
    return tok


class _Parser:
    def __init__(self, tokens):
        self.tokens = tokens
        self.pos = 0

    def peek(self):
        if self.pos < len(self.tokens):
            return self.tokens[self.pos]
        return (None, None)

    def next(self):
        tok = self.peek()
        self.pos += 1
        return tok

    def parse_message(self, top_level=False):
        msg = {}
        while True:
            kind, tok = self.peek()
            if kind is None:
                if top_level:
                    return msg
                raise ValueError("pbtxt: unexpected end of input inside message")
            if kind == "punct" and tok == "}":
                if top_level:
                    raise ValueError("pbtxt: unmatched '}'")
                self.next()
                return msg
            self.parse_field(msg)

    def parse_field(self, msg):
        kind, tok = self.next()
        if kind == "extkey":
            key = tok[1:-1]
        elif kind == "scalar":
            key = tok
        else:
            raise ValueError("pbtxt: expected field name, got %r" % tok)

        kind, tok = self.peek()
        if kind == "punct" and tok == ":":
            self.next()
            kind, tok = self.peek()
            if kind == "punct" and tok == "{":
                self.next()
                value = self.parse_message()
            else:
                value = self.parse_value()
        elif kind == "punct" and tok == "{":
            self.next()
            value = self.parse_message()
        else:
            raise ValueError("pbtxt: expected ':' or '{' after %r" % key)

        # Optional trailing separators.
        kind, tok = self.peek()
        if kind == "punct" and tok in (",", ";"):
            self.next()

        if key in msg:
            prev = msg[key]
            if not isinstance(prev, RepeatedValue):
                prev = RepeatedValue([prev])
                msg[key] = prev
            prev.append(value)
        else:
            msg[key] = value

    def parse_value(self):
        kind, tok = self.next()
        if kind == "string":
            value = _unquote(tok)
            # Adjacent string literals concatenate.
            while self.peek()[0] == "string":
                value += _unquote(self.next()[1])
            return value
        if kind == "scalar":
            return _coerce_scalar(tok)
        raise ValueError("pbtxt: expected value, got %r" % tok)


def parse(text):
    """Parses pbtxt `text` into a nested dict."""
    return _Parser(_tokenize(text)).parse_message(top_level=True)


def parse_file(path):
    with open(path, "r") as fid:
        return parse(fid.read())


def as_list(value):
    """Normalizes an optional/repeated field to a list."""
    if value is None:
        return []
    if isinstance(value, RepeatedValue):
        return list(value)
    return [value]
