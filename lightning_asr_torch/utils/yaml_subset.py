"""A reader for the subset of YAML that the repository's ``conf/`` files
use, giving what ``yaml.safe_load`` gives on them, without PyYAML: the
port does not depend on it.

Supported: block mappings and sequences (a sequence item may open a
mapping, ``- log: hypra_logger``), flow sequences and mappings that span
lines, single- and double-quoted scalars on one line, ``>-`` folded
block scalars, comments, and the YAML 1.1
resolution of plain scalars that PyYAML applies: null (``~``, ``null``,
empty), booleans (``true``/``yes``/``on`` and their negatives), ints
(decimal, ``0x``, ``0b``, octal, ``_`` separators, base 60) and floats,
which need a dot, so ``1e-2`` stays the string ``"1e-2"``.  Anything else
(other block scalar styles, anchors, tags, multi-document streams,
timestamps, merge keys) raises ``ValueError``.
"""

from __future__ import annotations

import re
from typing import Any, List, Tuple

_BOOL = {**{k: True for k in ("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON")},
         **{k: False for k in ("no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF")}}
_NULL = ("", "~", "null", "Null", "NULL")
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9_]+(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_UNSUPPORTED = re.compile(r"^(?:[&*!%@`|>]|---|\.\.\.)|^\d{4}-\d\d?-\d\d?")


def _base60(text: str, cast) -> Any:
    sign = -1 if text.startswith("-") else 1
    value = cast(0)
    for part in text.lstrip("+-").split(":"):
        value = value * 60 + cast(part)
    return sign * value


def resolve_plain(text: str) -> Any:
    """YAML 1.1 resolution of a plain scalar, as PyYAML's SafeLoader."""
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.match(text):
        t = text.replace("_", "")
        sign = -1 if t.startswith("-") else 1
        body = t.lstrip("+-")
        if ":" in body:
            return _base60(t, int)
        if body.startswith("0b"):
            return sign * int(body[2:], 2)
        if body.startswith("0x"):
            return sign * int(body[2:], 16)
        if body != "0" and body.startswith("0"):
            return sign * int(body, 8)
        return sign * int(body)
    if _FLOAT.match(text):
        t = text.replace("_", "").lower()
        if t.endswith(".inf"):
            return float("-inf") if t.startswith("-") else float("inf")
        if t.endswith(".nan"):
            return float("nan")
        return _base60(t, float) if ":" in t else float(t)
    if _UNSUPPORTED.match(text):
        raise ValueError(f"unsupported YAML in plain scalar {text!r}")
    return text


_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v",
            "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\",
            "N": "\x85", "_": "\xa0", "L": " ", "P": " "}
_HEX = {"x": 2, "u": 4, "U": 8}


def _quoted(text: str, i: int) -> Tuple[str, int]:
    """The quoted scalar starting at text[i]; returns (value, index after)."""
    quote = text[i]
    out = []
    j = i + 1
    while j < len(text):
        ch = text[j]
        if quote == "'":
            if ch == "'":
                if text[j + 1: j + 2] == "'":
                    out.append("'")
                    j += 2
                    continue
                return "".join(out), j + 1
            out.append(ch)
            j += 1
        else:
            if ch == '"':
                return "".join(out), j + 1
            if ch == "\\":
                esc = text[j + 1: j + 2]
                if esc in _HEX:
                    n = _HEX[esc]
                    out.append(chr(int(text[j + 2: j + 2 + n], 16)))
                    j += 2 + n
                    continue
                if esc not in _ESCAPES:
                    raise ValueError(f"unsupported escape \\{esc} in {text!r}")
                out.append(_ESCAPES[esc])
                j += 2
                continue
            out.append(ch)
            j += 1
    raise ValueError(f"unterminated quoted scalar in {text!r}")


def _strip_comment(line: str) -> str:
    """The line without its comment (a ``#`` at its start or after a blank,
    outside quotes)."""
    i, quote = 0, None
    while i < len(line):
        ch = line[i]
        if quote:
            if ch == quote:
                if quote == "'" and line[i + 1: i + 2] == "'":
                    i += 2
                    continue
                quote = None
            elif ch == "\\" and quote == '"':
                i += 1
        elif ch in "'\"" and (i == 0 or line[i - 1] in " \t[{,:-"):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
        i += 1
    return line.rstrip()


class _Flow:
    """Parser of one flow node (``[...]``, ``{...}`` or a scalar) in a
    string."""

    def __init__(self, text: str):
        self.text, self.i = text, 0

    def _skip(self):
        while self.i < len(self.text) and self.text[self.i] in " \t\n":
            self.i += 1

    def node(self) -> Any:
        self._skip()
        ch = self.text[self.i: self.i + 1]
        if ch == "[":
            self.i += 1
            items = []
            while True:
                self._skip()
                if self.text[self.i: self.i + 1] == "]":
                    self.i += 1
                    return items
                items.append(self.node())
                self._skip()
                if self.text[self.i: self.i + 1] == ",":
                    self.i += 1
                elif self.text[self.i: self.i + 1] != "]":
                    raise ValueError(f"expected ',' or ']' in {self.text!r}")
        if ch == "{":
            self.i += 1
            out = {}
            while True:
                self._skip()
                if self.text[self.i: self.i + 1] == "}":
                    self.i += 1
                    return out
                key = self.node()
                self._skip()
                if self.text[self.i: self.i + 1] != ":":
                    raise ValueError(f"expected ':' in {self.text!r}")
                self.i += 1
                out[key] = self.node()
                self._skip()
                if self.text[self.i: self.i + 1] == ",":
                    self.i += 1
                elif self.text[self.i: self.i + 1] != "}":
                    raise ValueError(f"expected ',' or '}}' in {self.text!r}")
        if ch in ("'", '"'):
            value, self.i = _quoted(self.text, self.i)
            return value
        j = self.i
        while j < len(self.text) and self.text[j] not in ",]}" and not (
                self.text[j] == ":" and self.text[j + 1: j + 2] in (" ", "", ",", "]", "}")):
            j += 1
        word = " ".join(self.text[self.i: j].split())
        self.i = j
        return resolve_plain(word)

    def whole(self) -> Any:
        value = self.node()
        self._skip()
        if self.i != len(self.text):
            raise ValueError(f"trailing text after a flow node in {self.text!r}")
        return value


def _balanced(text: str) -> bool:
    depth, quote, i = 0, None, 0
    while i < len(text):
        ch = text[i]
        if quote:
            if ch == quote:
                if quote == "'" and text[i + 1: i + 2] == "'":
                    i += 1
                else:
                    quote = None
            elif ch == "\\" and quote == '"':
                i += 1
        elif ch in "'\"":
            quote = ch
        elif ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
        i += 1
    return depth <= 0


def _split_key(text: str):
    """(key, rest) if ``text`` is ``key: rest`` or ``key:``, else None."""
    if text[:1] in ("'", '"'):
        key, j = _quoted(text, 0)
        rest = text[j:].lstrip(" ")
        if rest[:1] == ":" and rest[1:2] in ("", " "):
            return key, rest[1:].strip()
        return None
    if text[:1] in "[{":
        return None
    m = re.search(r":(?: |$)", text)
    if not m:
        return None
    return resolve_plain(text[: m.start()].rstrip()), text[m.end():].strip()


class _Block:
    def __init__(self, text: str):
        self.lines: List[Tuple[int, str, str]] = []      # (indent, content, raw)
        for raw in text.splitlines():
            if "\t" in raw[: len(raw) - len(raw.lstrip())]:
                raise ValueError("tabs in indentation")
            content = _strip_comment(raw)
            self.lines.append((len(raw) - len(raw.lstrip(" ")), content.strip(), raw))
        self.i = 0

    def _next(self) -> int:
        """Index of the next line with content (from self.i)."""
        j = self.i
        while j < len(self.lines) and not self.lines[j][1]:
            j += 1
        return j

    def node(self, indent: int) -> Any:
        j = self._next()
        if j >= len(self.lines) or self.lines[j][0] < indent:
            return None
        self.i = j
        ind, content, _ = self.lines[j]
        if content == "-" or content.startswith("- "):
            return self._sequence(ind)
        if _split_key(content) is not None:
            return self._mapping(ind)
        return self._scalar_lines(ind)

    def _scalar_lines(self, indent: int) -> Any:
        """A flow node or a plain/quoted scalar on this and more indented
        lines."""
        parts = []
        while self.i < len(self.lines):
            ind, content, _ = self.lines[self.i]
            if content and ind < indent:
                break
            if content:
                parts.append(content)
            self.i += 1
        text = " ".join(parts)
        if text[:1] in "[{'\"":
            return _Flow(text).whole()
        return resolve_plain(text)

    def _value(self, rest: str, indent: int) -> Any:
        """The value after ``key:`` (or ``- ``) at ``indent``."""
        self.i += 1
        if not rest:
            j = self._next()
            if j < len(self.lines):
                ind, content = self.lines[j][:2]
                if ind > indent or (ind == indent and (content == "-" or content.startswith("- "))):
                    return self.node(ind)
            return None
        if rest[0] in ">|":
            return self._block_scalar(rest, indent)
        if rest[0] in "[{":
            text = rest
            while not _balanced(text):
                if self.i >= len(self.lines):
                    raise ValueError(f"unterminated flow collection {rest!r}")
                text += " " + self.lines[self.i][1]
                self.i += 1
            return _Flow(text).whole()
        if rest[0] in ("'", '"'):
            return _Flow(rest).whole()
        parts = [rest]                  # a plain scalar may continue, more indented
        while self.i < len(self.lines):
            ind, content, _ = self.lines[self.i]
            if content and ind <= indent:
                break
            if content:
                parts.append(content)
            self.i += 1
        return resolve_plain(" ".join(parts))

    def _block_scalar(self, header: str, indent: int) -> str:
        """A ``>-`` folded scalar: lines joined by blanks, an empty line a
        newline, no final newline.  More indented lines raise."""
        if header != ">-":
            raise ValueError(f"unsupported block scalar header {header!r}")
        body: List[str] = []
        block_indent = None
        while self.i < len(self.lines):
            raw = self.lines[self.i][2]
            if raw.strip():
                ind = len(raw) - len(raw.lstrip(" "))
                if ind <= indent:
                    break
                block_indent = ind if block_indent is None else block_indent
                body.append(raw[block_indent:])
            else:
                body.append("")
            self.i += 1
        while body and not body[-1]:
            body.pop()
        text, prev_blank = "", True
        for line in body:
            if not line:
                text += "\n"
                prev_blank = True
            elif line.startswith(" "):
                raise ValueError(f"more indented line in a folded scalar: {line!r}")
            else:
                text += ("" if prev_blank else " ") + line
                prev_blank = False
        return text

    def _mapping(self, indent: int) -> dict:
        out: dict = {}
        while True:
            j = self._next()
            if j >= len(self.lines) or self.lines[j][0] != indent:
                if j < len(self.lines) and self.lines[j][0] > indent:
                    raise ValueError(f"bad indentation: {self.lines[j][2]!r}")
                return out
            self.i = j
            split = _split_key(self.lines[j][1])
            if split is None:
                raise ValueError(f"expected 'key: value', got {self.lines[j][2]!r}")
            key, rest = split
            out[key] = self._value(rest, indent)

    def _sequence(self, indent: int) -> list:
        out = []
        while True:
            j = self._next()
            if j >= len(self.lines) or self.lines[j][0] != indent:
                return out
            content = self.lines[j][1]
            if not (content == "-" or content.startswith("- ")):
                return out
            rest = content[1:].strip()
            self.i = j
            nested_seq = rest == "-" or rest.startswith("- ")
            if nested_seq or (rest and not rest.startswith(("'", '"', "[", "{"))
                              and _split_key(rest) is not None):
                # "- key: value" or "- - item": a block node whose first line
                # starts after the dash
                item_indent = indent + 1 + (len(content) - 1 - len(content[1:].lstrip()))
                self.lines[j] = (item_indent, rest, self.lines[j][2])
                out.append(self._sequence(item_indent) if nested_seq else self._mapping(item_indent))
            else:
                out.append(self._value(rest, indent))


def safe_load(text: str) -> Any:
    """The document in ``text``, as ``yaml.safe_load`` reads it (for the
    subset above)."""
    block = _Block(text)
    value = block.node(0)
    j = block._next()
    if j < len(block.lines):
        raise ValueError(f"unparsed YAML from line {j + 1}: {block.lines[j][2]!r}")
    return value
