"""Config system: INI files with ``${:var}`` interpolation + dataclass opts,
one-value parameter files and dict shards (the part of
``satpu.utils.config`` that runs without jax).

INI semantics:
- a ``[var]`` section defines variables,
- ``${:name}`` anywhere is replaced by the variable value, the process
  environment taking precedence over the ``[var]`` section,
- inline ``  # comment`` suffixes are stripped.
"""
from __future__ import annotations

import argparse
import configparser
import dataclasses
import os
import re
import sys
from typing import Any, Dict, List, Type, TypeVar

_RE_VAR = re.compile(r"[$][{][:]([a-zA-Z0-9_-]+)[}]")
_RE_INLINE_COMMENT = re.compile(r"\s+#")


def _strip_inline_comment(value: str) -> str:
    m = _RE_INLINE_COMMENT.search(value)
    return value[: m.start()].strip() if m else value


def load_ini(path: str) -> Dict[str, Dict[str, str]]:
    """Parse an INI config with ``${:var}`` interpolation and env override."""
    cp = configparser.ConfigParser(interpolation=None)
    cp.optionxform = str  # keep case
    with open(path) as f:
        cp.read_string(f.read())
    raw = {sec: dict(cp.items(sec)) for sec in cp.sections()}
    variables = dict(raw.get("var", {}))

    def substitute(value: str) -> str:
        def repl(m: re.Match) -> str:
            name = m.group(1)
            if name in os.environ:
                return os.environ[name]
            if name not in variables:
                raise KeyError(
                    f"config variable '{name}' not defined in [var] section nor environment")
            return variables[name]

        # variables may reference other variables: substitute to a fixed
        # point, bounded against cycles
        for _ in range(10):
            if not _RE_VAR.search(value):
                return value
            new = _RE_VAR.sub(repl, value)
            if new == value:
                raise ValueError(f"unresolvable config variable reference in {value!r}")
            value = new
        raise ValueError(f"config variable nesting too deep (cycle?) in {value!r}")

    out: Dict[str, Dict[str, str]] = {}
    for sec, kv in raw.items():
        out[sec] = {}
        for k, v in kv.items():
            v = _strip_inline_comment(v)
            out[sec][k] = substitute(v) if _RE_VAR.search(v) else v
    return out


def str2bool(v: Any) -> bool:
    if isinstance(v, bool):
        return v
    s = str(v).strip().lower()
    if s in ("yes", "true", "t", "y", "1"):
        return True
    if s in ("no", "false", "f", "n", "0", ""):
        return False
    raise ValueError(f"cannot interpret {v!r} as bool")


T = TypeVar("T", bound="Opts")


@dataclasses.dataclass
class Opts:
    """Base for option dataclasses of scalar fields (int, float, str, bool):
    ``load_from_config`` assigns from a string dict, ``load_from_args`` from
    command-line flags (field ``a_b`` is ``--a-b``; unknown flags are
    ignored); each value is coerced to the type of its field's default."""

    def load_from_config(self: T, cfg: Dict[str, Any]) -> T:
        for field in dataclasses.fields(self):
            if field.name in cfg:
                default = getattr(self, field.name)
                caster = str2bool if isinstance(default, bool) else type(default)
                setattr(self, field.name, caster(cfg[field.name]))
        return self

    def load_from_args(self: T, argv=None) -> T:
        parser = argparse.ArgumentParser(description=type(self).__name__)
        for field in dataclasses.fields(self):
            default = getattr(self, field.name)
            caster = str2bool if isinstance(default, bool) else type(default)
            parser.add_argument("--" + field.name.replace("_", "-"), type=caster,
                                default=default)
        args, _ = parser.parse_known_args(argv if argv is not None else sys.argv[1:])
        for field in dataclasses.fields(self):
            setattr(self, field.name, getattr(args, field.name))
        return self


def read_single_param_file(src: str, typename: Type = int):
    """The first line of ``src`` as a ``typename``."""
    with open(src) as f:
        return typename(f.readline().strip())


def write_single_param_file(value: Any, filename: str) -> None:
    with open(filename, "w") as f:
        f.write(f"{value}")


def split_dict(d: Dict, n: int) -> List[Dict]:
    """``n`` contiguous shards of ``d``, the first ``len % n`` one longer
    (reference script_utils.py:500-507)."""
    keys = list(d.keys())
    k, m = divmod(len(keys), n)
    return [
        {key: d[key] for key in keys[i * k + min(i, m):(i + 1) * k + min(i + 1, m)]}
        for i in range(n)
    ]
