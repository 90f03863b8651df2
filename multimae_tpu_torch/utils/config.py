"""A reader for the flat `key: value` YAML files the CLIs take with -c
(every file under cfgs/), giving what yaml.safe_load gives for them, so
the port needs no YAML package.

What it reads: one `key: value` per line; blank lines and comments (a
line starting with #, or ` #` after a value); single- and double-quoted
strings; and plain scalars resolved by YAML 1.1's rules as PyYAML's
SafeLoader applies them: null (`null`, `~`, nothing), booleans
(true/false, yes/no, on/off, in lower, Title or UPPER case), decimal
integers (sign and `_` allowed), floats (a `.` required, an exponent
needs its sign: `1.0e-06`; `.inf`, `.nan`), everything else a string.
Nested mappings, lists, anchors, multi-line values and octal, hex,
binary or base-60 numbers raise.
"""

from __future__ import annotations

import re
from typing import Any, Dict

_BOOL = {v: True for v in ("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON")}
_BOOL.update({v: False for v in ("no", "No", "NO", "false", "False", "FALSE", "off",
                                 "Off", "OFF")})
_NULL = ("", "~", "null", "Null", "NULL")
_INT = re.compile(r"^[-+]?(0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"^[-+]?([0-9][0-9_]*)?\.[0-9_]*([eE][-+][0-9]+)?$")
_INF = re.compile(r"^[-+]?\.(inf|Inf|INF)$")
_NAN = re.compile(r"^\.(nan|NaN|NAN)$")
_OTHER_INT = re.compile(r"^[-+]?(0[0-7_]+|0x[0-9a-fA-F_]+|0b[01_]+|[1-9][0-9_]*(:[0-5]?[0-9])+)$")
_KEY = re.compile(r"^([A-Za-z_][A-Za-z0-9_.\-]*)\s*:(\s+|$)(.*)$")


def _scalar(text: str, where: str) -> Any:
    if text[:1] in ("'", '"'):
        q = text[0]
        end = text.rfind(q)
        rest = text[end + 1:].strip()
        if end == 0 or (rest and not rest.startswith("#")):
            raise ValueError(f"{where}: unterminated or trailing text after a quoted string")
        body = text[1:end]
        return body.replace("''", "'") if q == "'" else body
    value = re.split(r"\s+#", text, maxsplit=1)[0].strip()
    if value[:1] in ("[", "{", "&", "*", "|", ">", "!") or value == "-" \
            or value.startswith("- "):
        raise ValueError(f"{where}: only flat scalars are read, not {value!r}")
    if _OTHER_INT.match(value):
        raise ValueError(f"{where}: octal, hex, binary and base-60 numbers are not read")
    if value in _NULL:
        return None
    if value in _BOOL:
        return _BOOL[value]
    if _INT.match(value):
        return int(value.replace("_", ""))
    if _FLOAT.match(value) and value.strip("+-.") and any(c.isdigit() for c in value):
        return float(value.replace("_", ""))
    if _INF.match(value):
        return float("-inf") if value.startswith("-") else float("inf")
    if _NAN.match(value):
        return float("nan")
    return value


def load_flat_yaml(path: str) -> Dict[str, Any]:
    """{key: value} of a flat YAML file."""
    out: Dict[str, Any] = {}
    with open(path) as f:
        for n, line in enumerate(f, 1):
            stripped = line.strip()
            if not stripped or stripped.startswith("#") or stripped == "---":
                continue
            where = f"{path}:{n}"
            if line[:1].isspace():
                raise ValueError(f"{where}: nested or continued values are not read")
            m = _KEY.match(stripped)
            if not m:
                raise ValueError(f"{where}: not a `key: value` line")
            out[m.group(1)] = _scalar(m.group(3).strip(), where)
    return out
