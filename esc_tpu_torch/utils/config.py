"""Config helpers (port of ``esc_tpu/utils/config.py::read_yaml``).

The port reads its YAML configs with its own reader, so the card's machine
needs no PyYAML and every machine parses alike. The reader takes the YAML
subset that the repo's configs use (``configs/**/*.yaml``, ``*.yml``):

- block mappings and block sequences by indentation, sequences also at the
  indentation of their key and nested on one line (``- - 0.0``);
- flow sequences and mappings (``[1, 2]``, ``{a: 1}``, ``[]``);
- plain, single- and double-quoted scalars, resolved as PyYAML's
  ``safe_load`` (YAML 1.1) resolves them: null, bool, int (decimal, hex,
  octal, binary), float (with a dot, signed exponent, ``.inf``, ``.nan``),
  else str;
- ``#`` comments and blank lines.

Anchors, tags, block scalars (``|``, ``>``) and multiple documents raise
``ValueError``. :func:`dump_yaml` writes a config back in that subset
(maps in block style, lists in flow style, strings quoted), which the port
and PyYAML both read as it was.

:func:`dict2namespace` / :func:`namespace2dict` turn a config into nested
``argparse.Namespace`` objects and back (scripts/utils.py:75-91).
"""

from __future__ import annotations

import argparse
import re
from typing import Any, List, Tuple

__all__ = ["read_yaml", "parse_yaml", "dump_yaml", "write_yaml",
           "dict2namespace", "namespace2dict", "download_data_hf"]

_NULL = {"", "~", "null", "Null", "NULL"}
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
# PyYAML's implicit resolvers (yaml/resolver.py), sexagesimal forms left out
_INT = re.compile(r"^[-+]?(0b[0-1_]+|0[0-7_]+|0|[1-9][0-9_]*"
                  r"|0x[0-9a-fA-F_]+)$")
_FLOAT = re.compile(r"^([-+]?[0-9][0-9_]*\.[0-9_]*([eE][-+][0-9]+)?"
                    r"|\.[0-9_]+([eE][-+][0-9]+)?"
                    r"|[-+]?\.(inf|Inf|INF)|\.(nan|NaN|NAN))$")
_DATE = re.compile(r"^[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}")


def _scalar(text: str) -> Any:
    """A plain scalar as ``yaml.safe_load`` resolves it."""
    if text in _NULL:
        return None
    if text in _TRUE:
        return True
    if text in _FALSE:
        return False
    if _INT.match(text):
        t = text.replace("_", "")
        sign = -1 if t[0] == "-" else 1
        t = t.lstrip("+-")
        if t.startswith("0b"):
            return sign * int(t[2:], 2)
        if t.startswith("0x"):
            return sign * int(t[2:], 16)
        if len(t) > 1 and t[0] == "0":
            return sign * int(t, 8)
        return sign * int(t)
    if _FLOAT.match(text):
        t = text.replace("_", "").lower()
        if t.endswith(".inf"):
            return float("-inf") if t[0] == "-" else float("inf")
        if t.endswith(".nan"):
            return float("nan")
        return float(t)
    if text[:1] in "&*!|>%@`" or _DATE.match(text) or text == "=":
        raise ValueError(f"YAML outside the supported subset: {text!r}")
    return text


def _quoted(text: str, i: int) -> Tuple[str, int]:
    """The quoted scalar starting at ``text[i]``; returns (value, end)."""
    q = text[i]
    out, j = [], i + 1
    while j < len(text):
        c = text[j]
        if q == "'" and c == "'":
            if text[j + 1:j + 2] == "'":
                out.append("'")
                j += 2
                continue
            return "".join(out), j + 1
        if q == '"' and c == "\\":
            esc = text[j + 1:j + 2]
            out.append({"n": "\n", "t": "\t", '"': '"', "\\": "\\",
                        "/": "/", "0": "\0"}.get(esc, esc))
            j += 2
            continue
        if q == '"' and c == '"':
            return "".join(out), j + 1
        out.append(c)
        j += 1
    raise ValueError(f"unterminated quoted scalar: {text!r}")


def _strip_comment(line: str) -> str:
    """The line without its ``#`` comment (outside quotes)."""
    i, quote = 0, None
    while i < len(line):
        c = line[i]
        if quote:
            if c == quote:
                if quote == "'" and line[i + 1:i + 2] == "'":
                    i += 1
                else:
                    quote = None
            elif quote == '"' and c == "\\":
                i += 1
        elif c in "'\"" and (i == 0 or line[i - 1] in " \t[{,:-"):
            quote = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
        i += 1
    return line.rstrip()


def _split_key(text: str):
    """``key: rest`` -> (key, rest); None if the text is no mapping entry."""
    if text[:1] in "'\"":
        key, j = _quoted(text, 0)
        rest = text[j:]
        if rest.startswith(":") and (len(rest) == 1 or rest[1] in " \t"):
            return key, rest[1:].strip()
        return None
    if text[:1] in "[{":
        return None
    m = re.match(r"^([^#]*?):(?:[ \t]+(.*))?$", text)
    if not m or not m.group(1):
        return None
    return _scalar(m.group(1).rstrip()), (m.group(2) or "").strip()


class _Flow:
    """Parser of one flow collection or scalar (``[..]``, ``{..}``)."""

    def __init__(self, text: str):
        self.text, self.i = text, 0

    def _skip(self):
        while self.i < len(self.text) and self.text[self.i] in " \t":
            self.i += 1

    def value(self, stops: str) -> Any:
        self._skip()
        c = self.text[self.i:self.i + 1]
        if c == "[":
            self.i += 1
            out: List[Any] = []
            while True:
                self._skip()
                if self.text[self.i:self.i + 1] == "]":
                    self.i += 1
                    return out
                out.append(self.value(",]"))
                self._skip()
                if self.text[self.i:self.i + 1] == ",":
                    self.i += 1
        if c == "{":
            self.i += 1
            out_map = {}
            while True:
                self._skip()
                if self.text[self.i:self.i + 1] == "}":
                    self.i += 1
                    return out_map
                key = self.value(":,}")
                self._skip()
                val = None
                if self.text[self.i:self.i + 1] == ":":
                    self.i += 1
                    val = self.value(",}")
                out_map[key] = val
                self._skip()
                if self.text[self.i:self.i + 1] == ",":
                    self.i += 1
        if c in ("'", '"'):
            val, self.i = _quoted(self.text, self.i)
            return val
        j = self.i
        while j < len(self.text) and self.text[j] not in stops:
            if self.text[j] == ":" and ":" in stops and (
                    j + 1 == len(self.text) or self.text[j + 1] in " \t"):
                break
            j += 1
        if j == len(self.text) and stops:
            if any(s in "]}" for s in stops):
                raise ValueError(f"unterminated flow collection: "
                                 f"{self.text!r}")
        tok, self.i = self.text[self.i:j].strip(), j
        return _scalar(tok)


def _inline(text: str) -> Any:
    """The value written after ``key:`` or ``-`` on one line."""
    if text[:1] in "[{":
        f = _Flow(text)
        val = f.value("")
        if f.text[f.i:].strip():
            raise ValueError(f"text after a flow collection: {text!r}")
        return val
    if text[:1] in "'\"":
        val, j = _quoted(text, 0)
        if text[j:].strip():
            raise ValueError(f"text after a quoted scalar: {text!r}")
        return val
    return _scalar(text)


class _Block:
    """Parser of block collections over (indent, text) lines."""

    def __init__(self, lines: List[Tuple[int, str]]):
        self.lines, self.i = lines, 0

    def _peek(self):
        return self.lines[self.i] if self.i < len(self.lines) else None

    def node(self, indent: int) -> Any:
        ind, text = self._peek()
        if text == "-" or text.startswith("- "):
            return self._sequence(ind)
        if _split_key(text) is not None:
            return self._mapping(ind)
        self.i += 1
        return _inline(text)

    def _item(self, indent: int, text: str) -> Any:
        """A value that starts on a line after ``-`` or ``key:``:
        ``text`` at column ``indent``."""
        if text == "-" or text.startswith("- ") or _split_key(text):
            self.lines.insert(self.i, (indent, text))
            return self.node(indent)
        return _inline(text)

    def _nested(self, indent: int, seq_ok: bool) -> Any:
        nxt = self._peek()
        if nxt is None:
            return None
        ind, text = nxt
        if ind > indent or (seq_ok and ind == indent
                            and (text == "-" or text.startswith("- "))):
            return self.node(ind)
        return None

    def _sequence(self, indent: int) -> list:
        out = []
        while True:
            nxt = self._peek()
            if nxt is None or nxt[0] != indent or not (
                    nxt[1] == "-" or nxt[1].startswith("- ")):
                break
            self.i += 1
            rest = nxt[1][1:]
            if not rest.strip():
                out.append(self._nested(indent, False))
            else:
                col = indent + 1 + len(rest) - len(rest.lstrip())
                out.append(self._item(col, rest.strip()))
        if self._peek() is not None and self._peek()[0] > indent:
            raise ValueError(f"bad indentation at {self._peek()[1]!r}")
        return out

    def _mapping(self, indent: int) -> dict:
        out = {}
        while True:
            nxt = self._peek()
            if nxt is None or nxt[0] != indent:
                break
            if nxt[1] == "-" or nxt[1].startswith("- "):
                break
            entry = _split_key(nxt[1])
            if entry is None:
                break
            self.i += 1
            key, rest = entry
            out[key] = (_inline(rest) if rest
                        else self._nested(indent, True))
        if self._peek() is not None and self._peek()[0] > indent:
            raise ValueError(f"bad indentation at {self._peek()[1]!r}")
        return out


def parse_yaml(text: str) -> Any:
    """Parse one YAML document of the supported subset."""
    lines = []
    for raw in text.splitlines():
        if "\t" in raw[:len(raw) - len(raw.lstrip())]:
            raise ValueError("tabs in indentation are not YAML")
        line = _strip_comment(raw)
        if not line.strip():
            continue
        if line.strip() in ("---", "...") or line.startswith("%"):
            if lines:
                raise ValueError("more than one YAML document")
            continue
        lines.append((len(line) - len(line.lstrip(" ")), line.strip()))
    if not lines:
        return None
    block = _Block(lines)
    value = block.node(lines[0][0])
    if block.i != len(block.lines):
        raise ValueError(f"unparsed YAML from {block.lines[block.i][1]!r}")
    return value


def read_yaml(path: str) -> dict:
    """Parse a YAML config file (see the module docstring for the subset)."""
    with open(path, "r") as f:
        return parse_yaml(f.read())


_PLAIN_KEY = re.compile(r"^[A-Za-z_][A-Za-z0-9_./-]*$")


def _dump_scalar(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if v != v:
            return ".nan"
        if v in (float("inf"), float("-inf")):
            return ".inf" if v > 0 else "-.inf"
        text = repr(v)
        if "." not in text:      # YAML 1.1 floats need a dot: 1e-05
            mant, _, exp = text.partition("e")
            text = mant + ".0" + ("e" + exp if exp else "")
        return text
    if isinstance(v, str):
        return "'" + v.replace("'", "''") + "'"
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_dump_scalar(x) for x in v) + "]"
    if isinstance(v, dict):
        return "{" + ", ".join(f"{_dump_key(k)}: {_dump_scalar(x)}"
                               for k, x in v.items()) + "}"
    raise TypeError(f"cannot write {type(v).__name__} to YAML")


def _dump_key(k: Any) -> str:
    if not isinstance(k, str):
        raise TypeError(f"YAML keys here are str, got {k!r}")
    return k if _PLAIN_KEY.match(k) and _scalar(k) == k else _dump_scalar(k)


def dump_yaml(config: dict, indent: int = 0) -> str:
    """A config of nested str-keyed maps, lists and scalars as YAML text."""
    out = []
    for k, v in config.items():
        if isinstance(v, dict) and v:
            out.append(" " * indent + f"{_dump_key(k)}:")
            out.append(dump_yaml(v, indent + 2).rstrip("\n"))
        else:
            out.append(" " * indent + f"{_dump_key(k)}: {_dump_scalar(v)}")
    return "\n".join(out) + "\n"


def write_yaml(path: str, config: dict) -> None:
    with open(path, "w") as f:
        f.write(dump_yaml(config))


def dict2namespace(config: dict) -> argparse.Namespace:
    """A config dict -> nested namespaces, a dict value becoming one."""
    ns = argparse.Namespace()
    for key, value in config.items():
        setattr(ns, key,
                dict2namespace(value) if isinstance(value, dict) else value)
    return ns


def namespace2dict(config) -> dict:
    """The inverse of :func:`dict2namespace`; other values pass through."""
    if isinstance(config, argparse.Namespace):
        return {k: namespace2dict(v) for k, v in vars(config).items()}
    return config


def download_data_hf(repo_id: str = "yzGuu830/dnscustom",
                     filename: str = "testset.tar.gz",
                     local_dir: str = "./data") -> str:
    """Fetch an evaluation-set tarball from the Hugging Face hub
    (scripts/utils.py:93-102) and return its path. Needs the
    ``huggingface_hub`` package, imported here and not with the module,
    and network access; without the package it raises ``ImportError``."""
    try:
        from huggingface_hub import hf_hub_download
    except ImportError as e:
        raise ImportError(
            "download_data_hf needs the 'huggingface_hub' package "
            "(pip install huggingface_hub)") from e
    path = hf_hub_download(repo_id=repo_id, filename=filename,
                           repo_type="dataset", local_dir=local_dir)
    print(f"File has been downloaded and is located at {path}")
    return path
