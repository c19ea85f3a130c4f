"""A minimal docopt-compatible flag parser.

The reference CLIs use docopt usage strings (``run_infer_tile.py:1-23``,
``run_infer_wsi.py:1-37``). docopt is not available in this environment, so
this module implements the subset those CLIs need: long ``--flag=<value>``
options with ``[default: ...]`` annotations, ``-h/--help`` and ``--version``.
Flag spelling and defaults stay bit-for-bit compatible.
"""
from __future__ import annotations

import re
import sys


def parse_defaults(doc: str) -> dict:
    """Extract ``{--flag: default-or-None}`` from the Options section.

    ``[default: ...]`` may sit on a CONTINUATION line of a multi-line
    option description (real docopt scans the whole description block);
    track the most recent flag so e.g. run_train.py's ``--grad_accum``
    default is found on its last wrapped line."""
    defaults = {}
    current = None
    current_indent = 0
    for line in doc.splitlines():
        stripped = line.strip()
        if not stripped:
            # blank lines inside an Options block don't end the current
            # option's description (more lenient than real docopt, which
            # stops the options section at a blank line; lenience can only
            # FIND a default, never misplace one)
            continue
        indent = len(line) - len(line.lstrip())
        match = re.match(r"(--[A-Za-z0-9_\-]+)(?:=<[^>]*>)?(?:\s{2,}|$)",
                         stripped)
        if not match:
            # options with no trailing description double-space — but a
            # single-space match DEEPER-indented than the current option's
            # own line is a wrapped description line that happens to start
            # with '--word ', not a new option: keep scanning it for the
            # current flag's [default: ...] instead of hijacking it
            match = re.match(r"(--[A-Za-z0-9_\-]+)(?:=<[^>]*>)?\s", stripped)
            if match and current is not None and indent > current_indent:
                match = None
        if match:
            current = match.group(1)
            current_indent = indent
            default_match = re.search(r"\[default:\s*(.*?)\]", stripped)
            defaults[current] = (default_match.group(1)
                                 if default_match else None)
            continue
        # continuation line of the current option's description: any
        # indented non-option line, including one whose wrap point lands
        # the '[default: ...]' at the start of the line (usage lines can
        # also start with '[' but never contain a default annotation, so
        # scanning them for one is harmless)
        if current and line.startswith(" "):
            default_match = re.search(r"\[default:\s*(.*?)\]", stripped)
            if default_match and defaults.get(current) is None:
                defaults[current] = default_match.group(1)
        elif not line.startswith(" "):
            current = None  # section break (e.g. prose after Options)
    return defaults


def docopt(doc: str, argv=None, version: str = "") -> dict:
    """Parse argv against a docopt usage string.

    Returns ``{--flag: value}`` with values from argv, falling back to the
    ``[default: ...]`` annotations; flags with no default and not given parse
    to ``None``. Boolean (valueless) flags parse to True/False.
    """
    if argv is None:
        argv = sys.argv[1:]
    args = parse_defaults(doc)

    value_flags = set(re.findall(r"(--[A-Za-z0-9_\-]+)=<[^>]*>", doc))
    known = set(args) | value_flags | {"--help", "--version"}
    for flag in known - value_flags:
        if args.get(flag) is None and flag in doc:
            # valueless boolean flag
            args.setdefault(flag, None)
            if args[flag] is None:
                args[flag] = False

    i = 0
    while i < len(argv):
        token = argv[i]
        if token in ("-h", "--help"):
            print(doc)
            sys.exit(0)
        if token == "--version":
            print(version)
            sys.exit(0)
        if token.startswith("--"):
            if "=" in token:
                flag, value = token.split("=", 1)
            else:
                flag = token
                if flag in value_flags:
                    if i + 1 >= len(argv):
                        # real docopt exits with usage on a missing option
                        # argument; silently parsing True would e.g. turn a
                        # forgotten --batch_size value into batch size 1
                        print(doc)
                        sys.exit(1)
                    i += 1
                    value = argv[i]
                else:
                    value = True
            if flag not in known:
                print(doc)
                sys.exit(1)
            args[flag] = value
        else:
            print(doc)
            sys.exit(1)
        i += 1
    return args
