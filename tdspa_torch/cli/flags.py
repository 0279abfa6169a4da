"""absl-style boolean and list flags on ``argparse`` (the card's machine has
no ``absl``): a boolean takes ``--name`` / ``--noname`` and
``--name=true|false``; a list is comma-separated. Other flags are plain
``argparse`` options, which take ``--name=value`` as absl does.
"""

from __future__ import annotations

import argparse


def _bool(text: str) -> bool:
    value = text.strip().lower()
    if value in ("true", "t", "1", "yes"):
        return True
    if value in ("false", "f", "0", "no"):
        return False
    raise argparse.ArgumentTypeError(f"not a boolean: {text!r}")


def comma_list(text: str) -> list[str]:
    return [item for item in text.split(",") if item]


def boolean(p: argparse.ArgumentParser, name: str, default: bool, help: str) -> None:
    p.add_argument(f"--{name}", dest=name, type=_bool, nargs="?", const=True, default=default,
                   help=f"{help} (--{name} / --no{name})")
    p.add_argument(f"--no{name}", dest=name, action="store_false", help=argparse.SUPPRESS)
