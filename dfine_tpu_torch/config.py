"""Config system (port of ``dfine_tpu/config.py``, without yaml).

One YAML file, ``${dotted.path}`` interpolation (nested too, as in
``${train.lrs.${model_name}.base_lr}``), ``${now:%fmt}`` timestamps and CLI
dotted overrides (``python -m dfine_tpu_torch.apps.train exp_name=x
train.epochs=5``). Access is attribute-style (``cfg.train.base_lr``).

The port does not depend on yaml, so this module reads and writes the subset
of YAML that the repo's configs use, with PyYAML's ``safe_load`` meaning
(YAML 1.1 scalars):

- block mappings and block lists (a list may sit at its key's indent),
  ``- key: value`` items, flow lists ``[640, 640]`` and flow maps
  ``{0: red, 1: blue}``, nested;
- comments, single- and double-quoted scalars, plain scalars resolved as
  PyYAML resolves them: null (``~``, ``null``, empty), bools (``true``,
  ``False``, ``yes``, ``off`` ...), ints (decimal, ``0x``, ``0b``, octal
  ``017``, ``1_000``, base 60 ``1:30``), floats (``0.000125``, ``1.5e-3``,
  ``.inf``, ``.nan``; like PyYAML, ``1e-4`` without a dot or without a sign
  on its exponent is a string), dates ``2024-01-31``; everything else a
  string.

Anything else (anchors, aliases, tags, block scalars ``|`` / ``>``, plain
scalars over several lines, tabs, documents) raises ``ValueError`` with the
line number. ``dump_yaml`` writes what both this reader and
``yaml.safe_load`` read back to the same tree.
"""

from __future__ import annotations

import copy
import datetime
import json
import math
import re
from pathlib import Path
from typing import Any, List, Optional, Tuple

_INTERP = re.compile(r"\$\{([^${}]+)\}")

# PyYAML's implicit resolvers (resolver.py), YAML 1.1
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_INT = re.compile(r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
                  r"|[-+]?0x[0-9a-fA-F_]+|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?"
                    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
_DATE = re.compile(r"^[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]$")
_TIMESTAMP = re.compile(r"^[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?(?:[Tt]|[ \t]+)[0-9]")
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v",
            "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\",
            "N": "\x85", "_": "\xa0", "L": "\u2028", "P": "\u2029"}


class YAMLSubsetError(ValueError):
    pass


def _sexagesimal(text: str, cast):
    sign = -1 if text[0] == "-" else 1
    value = 0
    for part in text.lstrip("+-").split(":"):
        value = value * 60 + cast(part)
    return sign * value


def resolve_scalar(text: str, line: int = 0) -> Any:
    """A plain scalar's value, as PyYAML's ``safe_load`` resolves it."""
    if _NULL.match(text):
        return None
    if _BOOL.match(text):
        return text in _TRUE
    if _INT.match(text):
        t = text.replace("_", "")
        if ":" in t:
            return _sexagesimal(t, int)
        sign, body = (-1, t[1:]) if t[0] == "-" else (1, t.lstrip("+"))
        if body.startswith("0b"):
            return sign * int(body[2:], 2)
        if body.startswith("0x"):
            return sign * int(body[2:], 16)
        if len(body) > 1 and body[0] == "0":
            return sign * int(body, 8)
        return sign * int(body)
    if _FLOAT.match(text):
        t = text.replace("_", "").lower()
        if t.endswith(".inf"):
            return -math.inf if t[0] == "-" else math.inf
        if t.endswith(".nan"):
            return math.nan
        if ":" in t:
            return _sexagesimal(t, float)
        return float(t)
    if _DATE.match(text):
        return datetime.date(*(int(v) for v in text.split("-")))
    if _TIMESTAMP.match(text):
        raise YAMLSubsetError(f"line {line}: timestamps are outside the YAML subset: {text!r}")
    return text


# ------------------------------------------------------------ the reader --


def _quoted_end(s: str, i: int) -> int:
    """Index just past the quoted scalar that starts at s[i]."""
    q = s[i]
    j = i + 1
    while j < len(s):
        if q == "'" and s[j] == "'":
            if s[j + 1:j + 2] == "'":
                j += 2
                continue
            return j + 1
        if q == '"' and s[j] == "\\":
            j += 2
            continue
        if q == '"' and s[j] == '"':
            return j + 1
        j += 1
    return -1


def _unquote(s: str, line: int) -> str:
    if s[0] == "'":
        return s[1:-1].replace("''", "'")
    out, i, body = [], 0, s[1:-1]
    while i < len(body):
        c = body[i]
        if c != "\\":
            out.append(c)
            i += 1
            continue
        e = body[i + 1:i + 2]
        if e in _ESCAPES:
            out.append(_ESCAPES[e])
            i += 2
        elif e in ("x", "u", "U"):
            n = {"x": 2, "u": 4, "U": 8}[e]
            out.append(chr(int(body[i + 2:i + 2 + n], 16)))
            i += 2 + n
        else:
            raise YAMLSubsetError(f"line {line}: unknown escape \\{e} in {s!r}")
    return "".join(out)


def _strip_comment(s: str) -> str:
    """``s`` without its comment: a ``#`` at the start or after a space,
    outside quoted scalars (a quote opens one where a scalar may start)."""
    i = 0
    while i < len(s):
        c = s[i]
        if c in "'\"":
            before = s[:i].rstrip()
            if not before or before[-1] in ":-[{,?":
                end = _quoted_end(s, i)
                if end < 0:
                    return s
                i = end
                continue
        if c == "#" and (i == 0 or s[i - 1] in " \t"):
            return s[:i]
        i += 1
    return s


def _split_key(text: str, line: int) -> Optional[Tuple[str, str]]:
    """(key, rest) of ``key: rest`` or ``key:``, or None when ``text`` has
    no such colon outside quotes and brackets."""
    i, depth = 0, 0
    if text[:1] in "'\"":
        i = _quoted_end(text, 0)
        if i < 0:
            raise YAMLSubsetError(f"line {line}: unterminated quoted key")
    while i < len(text):
        c = text[i]
        if c in "[{":
            depth += 1
        elif c in "]}":
            depth -= 1
        elif c == ":" and depth == 0 and (i + 1 == len(text) or text[i + 1] in " \t"):
            return text[:i].rstrip(), text[i + 1:].strip()
        i += 1
    return None


_NOT_PLAIN = ("&", "*", "!", "|", ">", "%", "@", "`")


def _scalar(text: str, line: int) -> Any:
    if text[:1] in "'\"":
        if _quoted_end(text, 0) != len(text):
            raise YAMLSubsetError(f"line {line}: text after a quoted scalar: {text!r}")
        return _unquote(text, line)
    if text[:1] in _NOT_PLAIN or text.startswith(("---", "...")):
        raise YAMLSubsetError(f"line {line}: {text[:1]!r} (anchor, alias, tag, block scalar "
                              "or directive) is outside the YAML subset")
    return resolve_scalar(text, line)


class _Flow:
    """Recursive-descent reader of one flow collection or scalar."""

    def __init__(self, text: str, line: int):
        self.s, self.i, self.line = text, 0, line

    def error(self, what: str):
        raise YAMLSubsetError(f"line {self.line}: {what} in {self.s!r}")

    def ws(self):
        while self.i < len(self.s) and self.s[self.i] in " \t":
            self.i += 1

    def value(self, in_flow: bool):
        self.ws()
        c = self.s[self.i:self.i + 1]
        if c == "[":
            return self.seq()
        if c == "{":
            return self.map()
        if c in ("'", '"'):
            end = _quoted_end(self.s, self.i)
            if end < 0:
                self.error("unterminated quoted scalar")
            text, self.i = self.s[self.i:end], end
            return _unquote(text, self.line)
        j = self.i
        stops = ",[]{}" if in_flow else ""
        while j < len(self.s) and self.s[j] not in stops:
            if self.s[j] == ":" and (j + 1 == len(self.s) or self.s[j + 1] in " \t,[]{}") \
                    and in_flow:
                break
            j += 1
        text, self.i = self.s[self.i:j].strip(), j
        return _scalar(text, self.line)

    def seq(self):
        self.i += 1
        out = []
        while True:
            self.ws()
            if self.s[self.i:self.i + 1] == "]":
                self.i += 1
                return out
            out.append(self.value(True))
            self.ws()
            c = self.s[self.i:self.i + 1]
            if c == ",":
                self.i += 1
            elif c != "]":
                self.error("expected , or ]")

    def map(self):
        self.i += 1
        out = {}
        while True:
            self.ws()
            if self.s[self.i:self.i + 1] == "}":
                self.i += 1
                return out
            key = self.value(True)
            self.ws()
            if self.s[self.i:self.i + 1] == ":":
                self.i += 1
                self.ws()
                val = None if self.s[self.i:self.i + 1] in (",", "}") else self.value(True)
            else:
                val = None
            out[key] = val
            self.ws()
            c = self.s[self.i:self.i + 1]
            if c == ",":
                self.i += 1
            elif c != "}":
                self.error("expected , or }")


def _inline(text: str, line: int) -> Any:
    if text[:1] in "[{":
        f = _Flow(text, line)
        v = f.value(False)
        f.ws()
        if f.i != len(text):
            f.error("text after a flow collection")
        return v
    return _scalar(text, line)


class _Block:
    def __init__(self, text: str):
        self.lines = []  # [line number, indent, content]
        for n, raw in enumerate(text.splitlines(), 1):
            body = _strip_comment(raw).rstrip()
            if not body.strip():
                continue
            lead = body[:len(body) - len(body.lstrip())]
            if "\t" in lead:
                raise YAMLSubsetError(f"line {n}: tab in indentation")
            if body.startswith(("---", "...", "%")):
                raise YAMLSubsetError(f"line {n}: documents and directives are outside the "
                                      "YAML subset")
            self.lines.append([n, len(lead), body.strip()])
        self.i = 0

    @staticmethod
    def is_item(content: str) -> bool:
        return content == "-" or content.startswith("- ")

    def block(self, indent: int):
        n, ind, content = self.lines[self.i]
        if self.is_item(content):
            return self.seq(ind)
        return self.map(ind)

    def nested(self, indent: int, allow_seq_at: bool):
        """The value of a key (or item) with nothing after its colon."""
        if self.i < len(self.lines):
            n, ind, content = self.lines[self.i]
            if ind > indent or (allow_seq_at and ind == indent and self.is_item(content)):
                return self.block(ind)
        return None

    def seq(self, indent: int):
        out = []
        while self.i < len(self.lines):
            n, ind, content = self.lines[self.i]
            if ind < indent:
                break
            if ind > indent or not self.is_item(content):
                if ind == indent:
                    break
                raise YAMLSubsetError(f"line {n}: bad indentation in a block list")
            rest = content[1:].lstrip()
            if not rest:
                self.i += 1
                out.append(self.nested(indent, False))
            elif _split_key(rest, n) is not None and rest[:1] not in "[{":
                # "- key: value": a mapping whose keys sit at the column of "key"
                self.lines[self.i] = [n, ind + len(content) - len(rest), rest]
                out.append(self.map(ind + len(content) - len(rest)))
            elif self.is_item(rest):
                raise YAMLSubsetError(f"line {n}: nested '- -' lists are outside the subset")
            else:
                self.i += 1
                out.append(_inline(rest, n))
        return out

    def map(self, indent: int):
        out = {}
        while self.i < len(self.lines):
            n, ind, content = self.lines[self.i]
            if ind < indent or (ind == indent and self.is_item(content)):
                break
            if ind > indent:
                raise YAMLSubsetError(f"line {n}: bad indentation (a plain scalar over "
                                      "several lines is outside the YAML subset)")
            kv = _split_key(content, n)
            if kv is None:
                raise YAMLSubsetError(f"line {n}: expected 'key: value', got {content!r}")
            key = _inline(kv[0], n) if kv[0] else None
            self.i += 1
            out[key] = _inline(kv[1], n) if kv[1] else self.nested(indent, True)
        return out


def load_yaml(text: str) -> Any:
    """``yaml.safe_load(text)`` for the subset in the module doc."""
    b = _Block(text)
    if not b.lines:
        return None
    first_indent = b.lines[0][1]
    if len(b.lines) == 1 and _split_key(b.lines[0][2], b.lines[0][0]) is None \
            and not b.is_item(b.lines[0][2]):
        return _inline(b.lines[0][2], b.lines[0][0])
    v = b.block(first_indent)
    if b.i != len(b.lines):
        raise YAMLSubsetError(f"line {b.lines[b.i][0]}: bad indentation")
    return v


# ------------------------------------------------------------ the writer --


def _scalar_text(v: Any, in_flow: bool) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        t = repr(v)
        if "e" in t:
            mant, exp = t.split("e")
            mant = mant if "." in mant else mant + ".0"
            t = f"{mant}e{exp if exp[0] in '+-' else '+' + exp}"
        return t
    if isinstance(v, datetime.date):
        return v.isoformat()
    s = str(v)
    special = ",[]{}#&*!|>'\"%@`" if in_flow else "#&*!|>'\"%@`[]{}"
    plain_ok = (s and s == s.strip() and s[0] not in special + "-?:" and ": " not in s
                and " #" not in s and not s.endswith(":") and "\n" not in s
                and (not in_flow or not any(c in s for c in ",[]{}:"))
                and resolve_scalar(s) == s)
    return s if plain_ok else json.dumps(s)


def _flow_text(v: Any) -> str:
    if isinstance(v, dict):
        return "{" + ", ".join(f"{_flow_text(k)}: {_flow_text(x)}" for k, x in v.items()) + "}"
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_flow_text(x) for x in v) + "]"
    return _scalar_text(v, True)


def dump_yaml(obj: Any) -> str:
    """Block mappings for dicts (flow ``{}`` when empty), flow lists."""
    lines: List[str] = []

    def emit(node, indent):
        for k, v in node.items():
            key = _scalar_text(k, True)
            if isinstance(v, dict) and v:
                lines.append(" " * indent + key + ":")
                emit(v, indent + 2)
            else:
                lines.append(" " * indent + key + ": " + _flow_text(v))

    if isinstance(obj, dict) and obj:
        emit(obj, 0)
        return "\n".join(lines) + "\n"
    return _flow_text(obj) + "\n"


# ------------------------------------------------------------ the config --


class ConfigNode(dict):
    """dict with attribute access, recursively."""

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k, v):
        self[k] = v

    @staticmethod
    def wrap(obj):
        if isinstance(obj, dict):
            return ConfigNode({k: ConfigNode.wrap(v) for k, v in obj.items()})
        if isinstance(obj, list):
            return [ConfigNode.wrap(v) for v in obj]
        return obj

    def to_dict(self) -> dict:
        def unwrap(o):
            if isinstance(o, dict):
                return {k: unwrap(v) for k, v in o.items()}
            if isinstance(o, list):
                return [unwrap(v) for v in o]
            return o

        return unwrap(self)


def _lookup(root: dict, dotted: str):
    cur: Any = root
    for part in dotted.split("."):
        if isinstance(cur, list):
            cur = cur[int(part)]
        else:
            cur = cur[part]
    return cur


def _resolve_str(s: str, root: dict, depth: int = 0):
    if depth > 20:
        raise ValueError(f"interpolation loop at {s!r}")
    while True:
        m = _INTERP.search(s)
        if not m:
            return s
        expr = m.group(1)
        if expr.startswith("now:"):
            val: Any = datetime.datetime.now().strftime(expr[4:])
        else:
            val = _lookup(root, expr)
            if isinstance(val, str) and _INTERP.search(val):
                val = _resolve_str(val, root, depth + 1)
        if m.span() == (0, len(s)):
            return val  # full-string interpolation keeps the value's type
        s = s[: m.start()] + str(val) + s[m.end() :]


def _resolve_tree(obj, root):
    if isinstance(obj, dict):
        return {k: _resolve_tree(v, root) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_resolve_tree(v, root) for v in obj]
    if isinstance(obj, str):
        return _resolve_str(obj, root)
    return obj


def _parse_value(v: str):
    """An override's value: the YAML reading of the text, or the text
    itself where it is not YAML (as ``yaml.safe_load`` with a fallback)."""
    try:
        return load_yaml(v)
    except YAMLSubsetError:
        return v


def apply_overrides(raw: dict, overrides: List[str]) -> dict:
    raw = copy.deepcopy(raw)
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override {ov!r} must look like key.path=value")
        key, val = ov.split("=", 1)
        parts = key.strip().split(".")
        cur = raw
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = _parse_value(val)
    return raw


def load_config(
    path: str | Path = "config.yaml", overrides: Optional[List[str]] = None
) -> ConfigNode:
    raw = load_yaml(Path(path).read_text())
    if overrides:
        raw = apply_overrides(raw, overrides)
    # multi-pass: interpolations may reference interpolated values
    resolved = raw
    for _ in range(5):
        nxt = _resolve_tree(resolved, resolved)
        if nxt == resolved:
            break
        resolved = nxt
    return ConfigNode.wrap(resolved)


def save_config(cfg: ConfigNode, path: str | Path) -> None:
    Path(path).write_text(dump_yaml(cfg.to_dict() if isinstance(cfg, ConfigNode) else cfg))


def cli_config(argv: List[str], default_path: str = "config.yaml") -> ConfigNode:
    """Entry-point helper: a positional argument ending in .yaml selects the
    file; every other one is a dotted override."""
    path = default_path
    overrides = []
    for a in argv:
        if a.endswith((".yaml", ".yml")) and "=" not in a:
            path = a
        else:
            overrides.append(a)
    return load_config(path, overrides)


def get_latest_experiment_dir(models_root: Path, exp_name: str) -> Path:
    """The newest date-stamped experiment directory ``<exp_name>_*``."""
    candidates = sorted(
        [p for p in Path(models_root).glob(f"{exp_name}_*") if p.is_dir()],
        key=lambda p: p.name,
    )
    if not candidates:
        raise FileNotFoundError(f"no experiment dirs matching {exp_name}_* in {models_root}")
    return candidates[-1]
