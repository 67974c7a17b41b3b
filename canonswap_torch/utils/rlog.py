"""Console logging (the reference's src/utils/rprint.py:8-16): through
``rich`` where it imports, else ``print``.  The port's counterpart of
``canonswap_tpu/utils/rlog.py``; ``rich`` is looked for at the first call,
not when the module is imported."""

from __future__ import annotations

import functools


@functools.cache
def _console():
    try:
        from rich.console import Console
    except ImportError:
        return None
    return Console()


def log(*args, style: str | None = None, **kwargs):
    console = _console()
    if console is None:
        print(*args, **kwargs, flush=True)
    else:
        console.print(*args, style=style, **kwargs)
