"""A reader for the subset of YAML that ``configs/*.yaml`` use, in pure Python.

The JAX package reads its configs with PyYAML's ``yaml.safe_load``. The
GPU machine does not promise PyYAML, so the port reads them with this
module instead, and gets the same values:

- ``# comments``, whole-line or after a value;
- ``key: value`` maps with identifier keys, nested by indentation (spaces
  only);
- one-line flow lists of scalars: ``[256, 128]``, ``[happy, sad]``;
- scalars: decimal ints; floats with a dot (``1.0e-5``; an exponent needs
  its sign); ``true`` and ``false``; ``null``, ``~`` and an empty value;
  an exponent without a dot (``2e-4``), which YAML 1.1 keeps as a string;
  plain strings of letters, digits and ``_ . / -`` that start with a
  letter, ``_`` or ``/``; single- or double-quoted strings without escapes
  or inner quotes.

Any other spelling raises ``ValueError`` rather than risk a value that
differs from PyYAML's: the other YAML 1.1 booleans, nulls and numbers
(``yes``, ``Off``, ``NULL``, ``0x1F``, ``010``, ``1:30``, ``.inf``), block
lists, flow maps, block scalars, anchors, tags, several documents, tabs.
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Tuple

_INT = re.compile(r"[-+]?(?:0|[1-9][0-9]*)")
_FLOAT = re.compile(r"[-+]?[0-9]+\.[0-9]*(?:[eE][-+][0-9]+)?")
_EXPONENT_STRING = re.compile(r"[-+]?[0-9]+[eE][-+]?[0-9]+")
_WORD = re.compile(r"[A-Za-z_/][A-Za-z0-9_./-]*")
_KEY = re.compile(r"([A-Za-z_][A-Za-z0-9_]*):(?: |$)")
_CONSTANTS = {"true": True, "false": False, "null": None, "~": None, "": None}
# words YAML 1.1 reads as booleans or null in some spelling
_YAML11_WORDS = {"true", "false", "null", "yes", "no", "on", "off"}


def resolve_plain(s: str) -> Any:
    """A plain (unquoted) scalar as ``yaml.safe_load`` types it."""
    if s in _CONSTANTS:
        return _CONSTANTS[s]
    if _INT.fullmatch(s):
        return int(s)
    if _FLOAT.fullmatch(s):
        return float(s)
    if _EXPONENT_STRING.fullmatch(s) or (_WORD.fullmatch(s) and s.lower() not in _YAML11_WORDS):
        return s
    raise ValueError(f"unsupported YAML scalar {s!r}")


def _scalar(token: str) -> Any:
    if token[:1] in ("'", '"'):
        q, body = token[0], token[1:-1]
        if len(token) < 2 or token[-1] != q or q in body or "\\" in body:
            raise ValueError(f"unsupported quoted scalar {token!r}")
        return body
    return resolve_plain(token)


def _value(token: str) -> Any:
    if not token.startswith("["):
        return _scalar(token)
    if not token.endswith("]"):
        raise ValueError(f"a flow list must close on its line: {token!r}")
    body = token[1:-1].strip()
    if not body:
        return []
    items = [item.strip() for item in body.split(",")]
    if not all(items):
        raise ValueError(f"empty entry in flow list {token!r}")
    return [_scalar(item) for item in items]


def _strip_comment(line: str) -> str:
    """``line`` without its comment: a ``#`` at the start or after
    whitespace, outside quotes."""
    i = 0
    while i < len(line):
        c = line[i]
        if c in "'\"":
            end = line.find(c, i + 1)
            if end < 0:
                raise ValueError(f"unterminated quoted scalar in {line!r}")
            i = end + 1
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
        else:
            i += 1
    return line.rstrip()


def _lines(text: str) -> List[Tuple[int, int, str]]:
    out = []
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = _strip_comment(raw)
        if line.strip():
            body = line.lstrip(" ")
            out.append((lineno, len(line) - len(body), body))
    return out


def _block(lines, pos: int, indent: int) -> Tuple[Dict[str, Any], int]:
    out: Dict[str, Any] = {}
    while pos < len(lines):
        lineno, ind, content = lines[pos]
        if ind < indent:
            break
        if ind > indent:
            raise ValueError(f"line {lineno}: unexpected indentation")
        m = _KEY.match(content)
        if m is None:
            raise ValueError(f"line {lineno}: expected 'key: value', got {content!r}")
        key, rest = m.group(1), content[m.end():].strip()
        pos += 1
        nested = pos < len(lines) and lines[pos][1] > indent
        if rest:
            if nested:
                raise ValueError(f"line {lines[pos][0]}: multi-line scalars are not supported")
            out[key] = _value(rest)
        elif nested:
            out[key], pos = _block(lines, pos, lines[pos][1])
        else:
            out[key] = None
    return out, pos


def safe_load(text: str) -> Optional[Dict[str, Any]]:
    """The mapping a config file's text holds, as ``yaml.safe_load`` gives
    it; None for a file with no content."""
    lines = _lines(text)
    if not lines:
        return None
    out, pos = _block(lines, 0, lines[0][1])
    if pos != len(lines):
        raise ValueError(f"line {lines[pos][0]}: indentation does not match any key")
    return out
