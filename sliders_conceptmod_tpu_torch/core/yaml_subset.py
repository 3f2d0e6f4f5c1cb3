"""A reader for the subset of YAML that the repository's config and prompt
files use — the port's own, since the GPU machine has no ``yaml`` package.

The subset:

* block mappings (``key: value``, ``key:`` followed by a more indented block,
  or by a block list at the same indent);
* block lists (``- value``, ``- key: value`` starting a mapping);
* scalars: double-quoted (with backslash escapes), single-quoted (``''``
  escape), and plain, resolved as PyYAML's ``safe_load`` resolves them
  (YAML 1.1): null (``~``, ``null``, empty), bool (``true``/``yes``/``on`` and
  their negatives, three spellings each), decimal int, float (a ``.`` is
  required and an exponent needs its sign: ``1e-4`` stays a string),
  ``.inf`` / ``.nan``; everything else is a string;
* comments: whole lines, and a ``#`` preceded by whitespace outside quotes.

Anything outside the subset raises :class:`YAMLSubsetError` rather than
being misread: flow collections (``[...]``, ``{...}``), anchors and aliases,
tags, block scalars (``|``, ``>``), directives and document markers,
multi-line plain or quoted scalars, tabs in indentation, and the plain
scalar forms PyYAML would resolve to something else (hex, octal, binary,
sexagesimal numbers).
"""

from __future__ import annotations

import math
import re
from typing import Any, List, Tuple

_BOOL = {
    **{s: True for s in ("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON")},
    **{s: False for s in ("no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF")},
}
_NULL = {"", "~", "null", "Null", "NULL"}
_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"^(?:[-+]?[0-9][0-9_]*\.[0-9_]*(?:[eE][-+][0-9]+)?|\.[0-9_]+(?:[eE][-+][0-9]+)?)$")
_INF = re.compile(r"^([-+]?)\.(?:inf|Inf|INF)$")
_NAN = re.compile(r"^\.(?:nan|NaN|NAN)$")
# plain forms that PyYAML resolves to numbers this reader does not take
_OTHER_NUMBERS = re.compile(
    r"^(?:[-+]?0b[01_]+|[-+]?0[0-7_]+|[-+]?0x[0-9a-fA-F_]+|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?)$"
)
_ESCAPES = {'"': '"', "\\": "\\", "/": "/", "n": "\n", "t": "\t", "r": "\r", "0": "\0", " ": " "}


class YAMLSubsetError(ValueError):
    """The text uses YAML outside the subset this reader takes."""


def _strip_comment(text: str, lineno: int) -> str:
    """Cut a comment (``#`` at the start or after whitespace, outside quotes)."""
    quote = None
    i = 0
    while i < len(text):
        ch = text[i]
        if quote == '"':
            if ch == "\\":
                i += 1
            elif ch == '"':
                quote = None
        elif quote == "'":
            if ch == "'":
                if i + 1 < len(text) and text[i + 1] == "'":
                    i += 1
                else:
                    quote = None
        elif ch in "\"'" and (i == 0 or text[i - 1] in " \t-:" or text[: i].rstrip().endswith(("-", ":"))):
            quote = ch
        elif ch == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i].rstrip()
        i += 1
    if quote is not None:
        raise YAMLSubsetError(f"line {lineno}: unterminated or multi-line quoted scalar")
    return text.rstrip()


def _lines(text: str) -> List[Tuple[int, int, str]]:
    """(line number, indent, content) of every line that holds something."""
    out = []
    for lineno, raw in enumerate(text.splitlines(), 1):
        body = raw.lstrip(" ")
        if body.startswith("\t") or (body and "\t" in raw[: len(raw) - len(body)]):
            raise YAMLSubsetError(f"line {lineno}: tab in indentation")
        content = _strip_comment(body, lineno)
        if not content:
            continue
        if content.startswith(("---", "...", "%")):
            raise YAMLSubsetError(f"line {lineno}: directives and document markers are outside the subset")
        out.append((lineno, len(raw) - len(body), content))
    return out


def _double_quoted(s: str, lineno: int) -> str:
    out, i = [], 1
    while i < len(s) - 1:
        ch = s[i]
        if ch == "\\":
            nxt = s[i + 1] if i + 1 < len(s) - 1 else ""
            if nxt not in _ESCAPES:
                raise YAMLSubsetError(f"line {lineno}: escape \\{nxt} is outside the subset")
            out.append(_ESCAPES[nxt])
            i += 2
            continue
        if ch == '"':
            raise YAMLSubsetError(f"line {lineno}: text after a closing quote")
        out.append(ch)
        i += 1
    return "".join(out)


def _scalar(s: str, lineno: int) -> Any:
    if s[:1] == '"':
        if len(s) < 2 or not s.endswith('"'):
            raise YAMLSubsetError(f"line {lineno}: text after a quoted scalar, or a multi-line one")
        return _double_quoted(s, lineno)
    if s[:1] == "'":
        if len(s) < 2 or not s.endswith("'") or "'" in s[1:-1].replace("''", ""):
            raise YAMLSubsetError(f"line {lineno}: text after a quoted scalar, or a multi-line one")
        return s[1:-1].replace("''", "'")
    if s[:1] in ("[", "{", "&", "*", "!", "|", ">", "@", "`", "%", "?"):
        raise YAMLSubsetError(f"line {lineno}: {s[:1]!r} (flow style, anchor, alias, tag or block scalar)")
    if s == "-" or s.startswith("- "):
        raise YAMLSubsetError(f"line {lineno}: a list entry where a value belongs")
    if ": " in s or s.endswith(":"):
        raise YAMLSubsetError(f"line {lineno}: a plain scalar holds ': '")
    if s in _NULL:
        return None
    if s in _BOOL:
        return _BOOL[s]
    if _INT.match(s):
        return int(s.replace("_", ""))
    if _FLOAT.match(s):
        return float(s.replace("_", ""))
    m = _INF.match(s)
    if m:
        return -math.inf if m.group(1) == "-" else math.inf
    if _NAN.match(s):
        return math.nan
    if _OTHER_NUMBERS.match(s):
        raise YAMLSubsetError(f"line {lineno}: number form {s!r} is outside the subset")
    return s


def _split_key(content: str, lineno: int):
    """``(key, rest)`` if the line is a mapping entry, else None."""
    if content[:1] in "\"'":
        q = content[0]
        end = 1
        while end < len(content):
            if content[end] == "\\" and q == '"':
                end += 2
                continue
            if content[end] == q:
                if q == "'" and content[end + 1 : end + 2] == "'":
                    end += 2
                    continue
                break
            end += 1
        after = content[end + 1 :]
        if after == ":" or after.startswith(": "):
            return _scalar(content[: end + 1], lineno), after[1:].strip()
        return None
    m = re.search(r":( |$)", content)
    if m is None:
        return None
    key = content[: m.start()]
    if key[:1] in ("[", "{", "&", "*", "!", "?"):
        raise YAMLSubsetError(f"line {lineno}: complex or decorated keys are outside the subset")
    return _scalar(key, lineno), content[m.end() :].strip()


def _is_item(content: str) -> bool:
    return content == "-" or content.startswith("- ")


class _Parser:
    def __init__(self, lines):
        self.lines = lines
        self.i = 0

    def block(self, indent: int) -> Any:
        _, _, content = self.lines[self.i]
        return self.seq(indent) if _is_item(content) else self.map(indent)

    def _child(self, indent: int, allow_seq_at_indent: bool) -> Any:
        """The value of an entry whose inline part was empty."""
        if self.i < len(self.lines):
            _, nxt_indent, nxt = self.lines[self.i]
            if nxt_indent > indent:
                return self.block(nxt_indent)
            if allow_seq_at_indent and nxt_indent == indent and _is_item(nxt):
                return self.seq(indent)
        return None

    def map(self, indent: int) -> dict:
        out: dict = {}
        while self.i < len(self.lines):
            lineno, ind, content = self.lines[self.i]
            if ind < indent:
                break
            if ind > indent:
                raise YAMLSubsetError(f"line {lineno}: unexpected indentation")
            if _is_item(content):
                break
            kv = _split_key(content, lineno)
            if kv is None:
                raise YAMLSubsetError(f"line {lineno}: expected 'key: value'")
            key, rest = kv
            self.i += 1
            out[key] = self._child(indent, True) if rest == "" else _scalar(rest, lineno)
        return out

    def seq(self, indent: int) -> list:
        out = []
        while self.i < len(self.lines):
            lineno, ind, content = self.lines[self.i]
            if ind < indent or (ind == indent and not _is_item(content)):
                break
            if ind > indent:
                raise YAMLSubsetError(f"line {lineno}: unexpected indentation")
            rest = content[1:].lstrip(" ")
            if rest == "":
                self.i += 1
                out.append(self._child(indent, False))
            elif _is_item(rest):
                raise YAMLSubsetError(f"line {lineno}: nested inline lists are outside the subset")
            elif _split_key(rest, lineno) is not None:
                # "- key: value" opens a mapping whose keys sit at the column of "key"
                self.lines[self.i] = (lineno, indent + len(content) - len(rest), rest)
                out.append(self.map(self.lines[self.i][1]))
            else:
                self.i += 1
                out.append(_scalar(rest, lineno))
        return out


def loads(text: str) -> Any:
    """Parse YAML text of the subset; an empty document gives None."""
    lines = _lines(text)
    if not lines:
        return None
    parser = _Parser(lines)
    value = parser.block(lines[0][1])
    if parser.i != len(lines):
        lineno = lines[parser.i][0]
        raise YAMLSubsetError(f"line {lineno}: unexpected content after the top-level block")
    return value


def load_file(path) -> Any:
    with open(path, "r", encoding="utf-8") as f:
        return loads(f.read())
