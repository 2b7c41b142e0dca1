"""Service launchers and the ``dfget`` CLI.

Counterpart of ``dragonfly2_tpu/tools`` (reference ``cmd/``): each runs as
``python -m dragonfly2_tpu_torch.tools.<name>`` with the reference's
parser, flag for flag. Every flag's subsystem is ported; a flag a later
reference change adds, without its subsystem, would exit non-zero through
``refuse_unported`` with a message that names it.
"""

from __future__ import annotations

import argparse


def add_debug_arg(parser: argparse.ArgumentParser) -> None:
    """The services' shared ``--debug-port`` flag (reference
    ``common/debug_http.add_debug_arg``)."""
    parser.add_argument("--debug-port", type=int, default=0,
                        help="serve /debug/{stacks,profile} + /metrics "
                        "(pprof analog, reference cmd/dependency "
                        "InitMonitor); 0 off, -1 ephemeral")


def refuse_unported(parser: argparse.ArgumentParser,
                    flags: dict[str, tuple[object, str]]) -> None:
    """Exit non-zero (status 2, argparse's) when a flag of a subsystem not
    ported yet was given. ``flags``: flag -> (given, what it needs)."""
    given = [f"{flag} ({what})" for flag, (on, what) in flags.items() if on]
    if given:
        parser.error("not ported to this package yet: " + ", ".join(given))
