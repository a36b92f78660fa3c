"""Leveled logging for the framework.

The reference prints diagnostics unconditionally; here everything that is
not part of the CLI's stdout contract (banners, validation verdicts, the
timer report) goes through stdlib logging, leveled via the
``LIGERO_LOG`` environment variable (debug/info/warning/error, default
warning) or ``configure(level)``.
"""

from __future__ import annotations

import logging
import os

_CONFIGURED = False


def configure(level: str | int | None = None) -> None:
    global _CONFIGURED
    if level is None:
        level = os.environ.get("LIGERO_LOG", "warning")
    if isinstance(level, str):
        level = getattr(logging, level.upper(), logging.WARNING)
    root = logging.getLogger("ligero")
    if not root.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname).1s %(name)s: %(message)s",
            datefmt="%H:%M:%S"))
        root.addHandler(h)
        root.propagate = False
    root.setLevel(level)
    _CONFIGURED = True


def get_logger(name: str) -> logging.Logger:
    if not _CONFIGURED:
        configure()
    return logging.getLogger(f"ligero.{name}")
