"""Minimal protobuf text-format parser (enough for Caffe prototxt files): the
port's own copy of ``tools/caffe_converter/prototxt.py``.

Produces plain dicts: each message is ``{field_name: [value, ...]}`` — every
field is a list because prototxt fields are implicitly repeatable (e.g.
``bottom`` appearing twice). Values are str/int/float/bool or nested dicts.
"""

from __future__ import annotations

import re

__all__ = ["parse", "first"]

_TOKEN = re.compile(
    r"""\s*(?:(?P<comment>\#[^\n]*)"""
    r"""|(?P<brace>[{}])"""
    r"""|(?P<colon>:)"""
    r"""|(?P<string>"(?:[^"\\]|\\.)*"|'(?:[^'\\]|\\.)*')"""
    r"""|(?P<atom>[A-Za-z0-9_.+\-eE]+))""")


def _tokenize(text):
    pos = 0
    while pos < len(text):
        m = _TOKEN.match(text, pos)
        if not m:
            if text[pos:].strip():
                raise ValueError(f"prototxt parse error at char {pos}: "
                                 f"{text[pos:pos + 40]!r}")
            return
        pos = m.end()
        if m.lastgroup != "comment":
            yield m.lastgroup, m.group(m.lastgroup)


def _coerce(atom):
    if atom in ("true", "True"):
        return True
    if atom in ("false", "False"):
        return False
    try:
        return int(atom)
    except ValueError:
        pass
    try:
        return float(atom)
    except ValueError:
        return atom  # enum identifier (e.g. MAX, AVE, LMDB)


def _parse_message(tokens, it):
    msg = {}
    for kind, tok in it:
        if kind == "brace" and tok == "}":
            return msg
        if kind != "atom":
            raise ValueError(f"expected field name, got {tok!r}")
        name = tok
        kind2, tok2 = next(it)
        if kind2 == "brace" and tok2 == "{":
            value = _parse_message(tokens, it)
        elif kind2 == "colon":
            kind3, tok3 = next(it)
            if kind3 == "brace" and tok3 == "{":
                value = _parse_message(tokens, it)
            elif kind3 == "string":
                value = tok3[1:-1]
            else:
                value = _coerce(tok3)
        else:
            raise ValueError(f"expected ':' or '{{' after {name!r}")
        msg.setdefault(name, []).append(value)
    return msg


def parse(text):
    """Parse prototxt text into a nested ``{field: [values]}`` dict."""
    it = iter(_tokenize(text))
    return _parse_message(None, it)


def first(msg, name, default=None):
    """First value of a field, or ``default`` when absent."""
    values = msg.get(name)
    return values[0] if values else default
