"""Gated diagnostic logging, as mgcfd_tpu.utils.logging: the reference's
log() printf wrapper is compiled out unless -DLOG (common.h:28-45); here
MGCFD_LOG=1 turns it on. Messages go to stderr, prefixed with the
process id."""
from __future__ import annotations

import os
import sys

_enabled = os.environ.get("MGCFD_LOG", "") not in ("", "0")


def log_enabled() -> bool:
    return _enabled


def log(fmt: str, *args) -> None:
    if _enabled:
        msg = fmt % args if args else fmt
        print(f"[mgcfd pid={os.getpid()}] {msg}", file=sys.stderr,
              flush=True)
