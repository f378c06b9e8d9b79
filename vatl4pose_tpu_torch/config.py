"""Config system: YAML → attribute-access tree (the port's own copy of
vatl4pose_tpu/config.py).

The section names are the reference's (DATASET.{TRAIN,EVAL}, DATA_PRESET,
MODEL, LOSS, AE, AUXNET, RETRAIN, VAL, TRAIN), so its configs load
unchanged.  `Cfg` is a dict with attribute get/set, nesting and runtime
mutation (the AL CLI rewrites ANN paths per video).

The YAML is read by the port's own reader (`parse_yaml`), not PyYAML,
which the machine with the card does not have.  It reads the YAML that
configs/**/*.yaml use (block mappings and sequences, flow sequences of
scalars, comments, single- and double-quoted strings) and resolves plain
scalars as PyYAML's `safe_load` does (YAML 1.1: `yes`/`on`/`off` are
booleans, a float needs a dot, `1e-3` stays a string).  Anything else
(anchors, aliases, tags, block scalars, flow mappings, several documents,
tabs, multi-line scalars) raises ValueError naming the source and line.
"""

from __future__ import annotations

import copy
import math
import re

__all__ = ["Cfg", "update_config", "load_config_str", "parse_yaml"]


class Cfg(dict):
    """dict with attribute access, recursively wrapping nested dicts."""

    def __init__(self, d=None, **kwargs):
        super().__init__()
        d = dict(d or {})
        d.update(kwargs)
        for k, v in d.items():
            self[k] = v

    def __setitem__(self, k, v):
        if isinstance(v, dict) and not isinstance(v, Cfg):
            v = Cfg(v)
        elif isinstance(v, (list, tuple)):
            v = type(v)(Cfg(x) if isinstance(x, dict) and not isinstance(x, Cfg)
                        else x for x in v)
        super().__setitem__(k, v)

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k, v):
        self[k] = v

    def setdefault(self, k, default=None):
        if k not in self:
            self[k] = default          # routes through the wrapping setitem
        return self[k]

    def __deepcopy__(self, memo):
        return Cfg({k: copy.deepcopy(v, memo) for k, v in self.items()})


def update_config(config_file: str) -> Cfg:
    """Load a YAML experiment config (config.py:5-8)."""
    with open(config_file, encoding="utf-8") as f:
        return Cfg(parse_yaml(f.read(), config_file))


def load_config_str(text: str) -> Cfg:
    """A config from YAML text."""
    return Cfg(parse_yaml(text))


# ---- the YAML reader ------------------------------------------------------

# PyYAML's YAML 1.1 implicit resolvers (yaml/resolver.py), as safe_load
# applies them to plain scalars
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False"
                   r"|FALSE|on|On|ON|off|Off|OFF)$")
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
# resolved by safe_load to types a config never holds: refused
_TIMESTAMP = re.compile(r"^[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?"
                        r"(?:(?:[Tt]|[ \t]+)[0-9][0-9]?:[0-9][0-9]"
                        r":[0-9][0-9](?:\.[0-9]*)?(?:[ \t]*(?:Z|[-+][0-9]"
                        r"[0-9]?(?::[0-9][0-9])?))?)?$")
_ESCAPES = {"0": "\0", "a": "\x07", "b": "\x08", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\x0b", "f": "\x0c", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}
# characters that cannot start a plain scalar, with what they start; '-',
# '?' and ':' cannot when a space or the line's end follows
_NOT_PLAIN = {"&": "an anchor", "*": "an alias", "!": "a tag",
              "|": "a block scalar", ">": "a block scalar",
              "{": "a flow mapping", "}": "a flow mapping",
              "[": "a flow sequence", "]": "a flow sequence",
              ",": "a flow entry", "#": "a comment", "%": "a directive",
              "@": "a reserved indicator", "`": "a reserved indicator",
              "'": "a quoted scalar", '"': "a quoted scalar",
              "-": "a sequence entry", "?": "a complex key",
              ":": "a mapping value"}


class _Reader:
    """One YAML text as lines of (indent, text, line number)."""

    def __init__(self, text: str, source: str):
        self.source = source
        self.lines = []
        started = False
        for no, raw in enumerate(text.lstrip("\ufeff").splitlines(), 1):
            body = raw.lstrip(" ")
            if not body.strip(" \t") or body.startswith("#"):
                continue
            if body[0] == "\t":
                self.fail(no, "a tab in the indentation")
            indent = len(raw) - len(body)
            if body.rstrip() == "---" and indent == 0 and not started:
                started = True               # one explicit document start
                continue
            if indent == 0 and (body.startswith(("---", "...", "%"))):
                self.fail(no, "a document marker or directive (one "
                              "document only)")
            started = True
            self.lines.append([indent, body, no])

    def fail(self, lineno, msg):
        raise ValueError(f"{self.source}:{lineno}: {msg}")

    # -- scalars --

    def quoted(self, s, no):
        """A quoted scalar at s[0]; returns (str, rest of s)."""
        q, out, i = s[0], [], 1
        while i < len(s):
            c = s[i]
            if q == "'":
                if c == "'":
                    if s[i + 1:i + 2] == "'":
                        out.append("'")
                        i += 2
                        continue
                    return "".join(out), s[i + 1:]
            else:
                if c == '"':
                    return "".join(out), s[i + 1:]
                if c == "\\":
                    e = s[i + 1:i + 2]
                    if e in _ESCAPES:
                        out.append(_ESCAPES[e])
                        i += 2
                        continue
                    n = _HEX_ESCAPES.get(e)
                    digits = s[i + 2:i + 2 + n] if n else ""
                    if not n or len(digits) != n or not all(
                            d in "0123456789abcdefABCDEF" for d in digits):
                        self.fail(no, f"an escape the reader does not "
                                      f"know: {s[i:i + 2]!r}")
                    out.append(chr(int(digits, 16)))
                    i += 2 + n
                    continue
            out.append(c)
            i += 1
        self.fail(no, "a quoted scalar that does not end on its line")

    def plain(self, s, no, flow=False):
        """A plain scalar's text, checked; s has no comment."""
        s = s.strip(" ")
        if "\t" in s:
            self.fail(no, "a tab in a plain scalar")
        if s and s[0] in _NOT_PLAIN and (s[0] not in "-?:" or len(s) == 1
                                         or s[1] == " "):
            self.fail(no, f"{_NOT_PLAIN[s[0]]} ({s[0]!r}) where a plain "
                          f"scalar was expected: the reader does not read "
                          f"it here")
        if ": " in s or s.endswith(":") or (flow and any(
                c in s for c in ",[]{}")):
            self.fail(no, f"a mapping or flow indicator inside the scalar "
                          f"{s!r}")
        return s

    def resolve(self, s, no):
        """A plain scalar's value, as safe_load resolves it."""
        if _NULL.match(s):
            return None
        if _BOOL.match(s):
            return s.lower() in ("yes", "true", "on")
        if _INT.match(s):
            v = s.replace("_", "")
            sign = -1 if v[0] == "-" else 1
            v = v.lstrip("+-")
            if v == "0":
                return 0
            if v.startswith("0b"):
                return sign * int(v[2:], 2)
            if v.startswith("0x"):
                return sign * int(v[2:], 16)
            if v[0] == "0":
                return sign * int(v, 8)
            if ":" in v:
                return sign * _sexagesimal(v)
            return sign * int(v)
        if _FLOAT.match(s):
            v = s.replace("_", "").lower()
            sign = -1.0 if v[0] == "-" else 1.0
            v = v.lstrip("+-")
            if v == ".inf":
                return sign * math.inf
            if v == ".nan":
                return math.nan
            if ":" in v:
                return sign * _sexagesimal(v, float)
            return sign * float(v)
        if _TIMESTAMP.match(s) or s in ("=", "<<"):
            self.fail(no, f"the scalar {s!r} is not a config value (a "
                          f"timestamp, value or merge key)")
        return s

    @staticmethod
    def comment_free(s):
        """s up to a comment (' #'), for a plain scalar or what follows a
        quoted one."""
        cut = s.find(" #")
        return s if cut < 0 else s[:cut]

    def after(self, rest, no):
        """What follows a complete scalar must be blank or a comment."""
        rest = rest.lstrip(" ")
        if rest and not rest.startswith("#"):
            self.fail(no, f"unexpected text after a scalar: {rest!r}")

    def flow_seq(self, s, no):
        """A one-line flow sequence of scalars at s[0] == '['."""
        items, i, need_item = [], 1, True
        while True:
            while i < len(s) and s[i] == " ":
                i += 1
            if i >= len(s):
                self.fail(no, "a flow sequence that does not end on its line")
            c = s[i]
            if c == "]":
                self.after(s[i + 1:], no)
                return items
            if not need_item:
                if c != ",":
                    self.fail(no, f"expected ',' or ']' in a flow sequence, "
                                  f"found {c!r}")
                i += 1
                need_item = True
                continue
            if c in "'\"":
                v, rest = self.quoted(s[i:], no)
                items.append(v)
                i = len(s) - len(rest)
            elif c in "[{":
                self.fail(no, "a nested flow collection (only flow "
                              "sequences of scalars are read)")
            elif c == ",":
                self.fail(no, "an empty entry in a flow sequence")
            else:
                j = i
                while j < len(s) and s[j] not in ",]" and s[j:j + 2] != " #":
                    j += 1
                items.append(self.resolve(self.plain(s[i:j], no, flow=True),
                                          no))
                i = j
            need_item = False

    def value(self, s, no):
        """The scalar or flow sequence that s (not blank) holds."""
        if s[0] in "'\"":
            v, rest = self.quoted(s, no)
            self.after(rest, no)
            return v
        if s[0] == "[":
            return self.flow_seq(s, no)
        return self.resolve(self.plain(self.comment_free(s), no), no)

    # -- blocks --

    @staticmethod
    def is_entry(text):
        return text[0] == "-" and (len(text) == 1 or text[1] == " ")

    def split_key(self, text, no):
        """(key, the value's text) of a mapping entry, or None when the
        line holds no 'key:'."""
        if text[0] in "'\"":
            key, rest = self.quoted(text, no)
            stripped = rest.lstrip(" ")
            if not stripped.startswith(":") or stripped[1:2] not in ("", " "):
                return None
            return key, stripped[1:].strip(" ")
        if text[0] == "?" and text[1:2] in ("", " "):
            self.fail(no, "a complex key ('?')")
        body = self.comment_free(text)
        cut = body.find(": ")
        if cut < 0:
            if not body.rstrip(" ").endswith(":"):
                return None
            cut = len(body.rstrip(" ")) - 1
        key = self.resolve(self.plain(body[:cut], no), no)
        return key, text[cut + 1:].strip(" ")

    def block(self, i):
        """The node whose first line is lines[i]; returns (node, next i)."""
        indent, text, no = self.lines[i]
        if self.is_entry(text):
            return self.sequence(i, indent)
        if self.split_key(text, no) is not None:
            return self.mapping(i, indent)
        node = self.value(text, no)
        return node, i + 1

    def nested(self, i, indent):
        """The node on the lines after an empty value at `indent`: a deeper
        block, a sequence at the same indent, or null."""
        if i < len(self.lines):
            nxt = self.lines[i]
            if nxt[0] > indent:
                return self.block(i)
            if nxt[0] == indent and self.is_entry(nxt[1]):
                return self.sequence(i, indent)
        return None, i

    def check_dedent(self, i, indent):
        if i < len(self.lines) and self.lines[i][0] > indent:
            self.fail(self.lines[i][2], "unexpected indentation (multi-line "
                                        "scalars are not read)")

    def sequence(self, i, indent):
        items = []
        while i < len(self.lines) and self.lines[i][0] == indent \
                and self.is_entry(self.lines[i][1]):
            _, text, no = self.lines[i]
            rest = text[1:].lstrip(" ")
            if not rest or rest.startswith("#"):
                node, i = self.nested(i + 1, indent)
            else:
                # "- x": x's node starts at its own column
                col = indent + len(text) - len(rest)
                self.lines[i] = [col, rest, no]
                node, i = self.block(i)
            self.check_dedent(i, indent)
            items.append(node)
        return items, i

    def mapping(self, i, indent):
        out = {}
        while i < len(self.lines) and self.lines[i][0] == indent:
            _, text, no = self.lines[i]
            kv = None if self.is_entry(text) else self.split_key(text, no)
            if kv is None:
                self.fail(no, "expected 'key: value' in a mapping")
            key, rest = kv
            if not rest or rest.startswith("#"):
                out[key], i = self.nested(i + 1, indent)
            else:
                out[key] = self.value(rest, no)
                i += 1
            self.check_dedent(i, indent)
        return out, i

    def document(self):
        if not self.lines:
            return None
        node, i = self.block(0)
        if i < len(self.lines):
            self.fail(self.lines[i][2], "unexpected dedent or a second "
                                        "top-level node")
        return node


def _sexagesimal(v, kind=int):
    """'1:30' -> 90, summed from the last part as PyYAML sums it."""
    total, base = kind(0), 1
    for part in reversed(v.split(":")):
        total += kind(part) * base
        base *= 60
    return total


def parse_yaml(text: str, source: str = "<string>"):
    """The value of one YAML document in the subset the configs use,
    resolved as PyYAML's safe_load resolves it; ValueError (naming
    `source` and the line) on anything outside that subset."""
    return _Reader(text, source).document()
