"""Indentation-aware logging helpers (parity with ``misc/utils.py:268-283``)."""
from __future__ import annotations

import inspect
import logging


def _indent_log(level: int, msg: str) -> None:
    try:
        frame_info = inspect.getouterframes(inspect.currentframe())[2]
        lines = frame_info.code_context
        line = lines[0] if lines else ""
        indentation_level = line.find(line.lstrip())
    except Exception:
        indentation_level = 0
    logging.log(level, "{i} {m}".format(i="." * indentation_level, m=msg))


def log_debug(msg: str) -> None:
    _indent_log(logging.DEBUG, msg)


def log_info(msg: str) -> None:
    _indent_log(logging.INFO, msg)
