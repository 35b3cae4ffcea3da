"""Shared fail-loud resolver for ``REPRO_*`` string policies.

A copy of ``src/repro/utils/envpolicy.py``: an unknown value raises
immediately with the valid options listed, instead of falling into a
string-compare default somewhere downstream.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence, Union


def env_policy(name: str, *, choices: Sequence[str], default: str,
               override: Union[str, int, None] = None,
               int_ok: bool = False, int_min: int = 1,
               int_prefixes: Sequence[str] = ()) -> Union[str, int]:
    """Resolve the policy value of env var ``name``.

    ``override`` (a function argument, e.g. ``fitness_agg=``) wins over
    the environment; the environment wins over ``default``.  The value
    must be one of ``choices`` (case-insensitively) or, when ``int_ok``,
    an integer >= ``int_min`` — anything else raises ``ValueError``
    naming the variable and every accepted value.  Integer-looking
    strings that are also in ``choices`` (e.g. ``"1"`` for
    REPRO_POP_SHARDS) resolve to the string form.

    ``int_prefixes`` admits ``"<prefix>:<n>"`` forms (e.g.
    ``REPRO_SERVE_SLOTS=thread:4``): the integer suffix must be >=
    ``int_min`` and the validated, normalized string is returned.
    """
    raw = override if override is not None else os.environ.get(name, default)
    s = str(raw).strip().lower()
    if s in choices:
        return s
    for prefix in int_prefixes:
        if not s.startswith(prefix + ":"):
            continue
        suffix = s[len(prefix) + 1:]
        try:
            val = int(suffix)
        except ValueError:
            break                     # fall through to the fail-loud raise
        if val < int_min:
            raise ValueError(
                f"{name}={raw!r}: '{prefix}:<n>' values must have "
                f"n >= {int_min}")
        return f"{prefix}:{val}"
    if int_ok:
        try:
            val2: Optional[int] = int(s)
        except ValueError:
            val2 = None
        if val2 is not None:
            if val2 < int_min:
                raise ValueError(
                    f"{name}={raw!r}: integer values must be >= {int_min}")
            return val2
    opts = ", ".join(repr(c) for c in choices if c)
    opts += "".join(f", '{p}:<n>'" for p in int_prefixes)
    if int_ok:
        opts += f", or an integer >= {int_min}"
    raise ValueError(f"{name}={raw!r}: valid values are {opts}")
