"""Structured logging (a copy of tryraytrace_tpu/utils/logging.py).

The reference logs with bare printf at init and on camera changes
(SURVEY.md section 5).  Here the same events flow through one logger
with an optional JSONL event stream for machine parsing: set
``TPURT_EVENT_LOG`` to a path and every ``log_event`` is appended to
it as one JSON object per line.  ``TPURT_LOG_LEVEL`` sets the level.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time

_LOGGER = None
_EVENT_FILE = None


def get_logger() -> logging.Logger:
    global _LOGGER
    if _LOGGER is None:
        logger = logging.getLogger("tpurt")
        if not logger.handlers:
            h = logging.StreamHandler(sys.stderr)
            h.setFormatter(logging.Formatter("[%(name)s] %(message)s"))
            logger.addHandler(h)
        logger.setLevel(os.environ.get("TPURT_LOG_LEVEL", "INFO"))
        _LOGGER = logger
    return _LOGGER


def log_event(event: str, **fields) -> None:
    """Log a structured event; mirrors to TPURT_EVENT_LOG as JSONL."""
    global _EVENT_FILE
    get_logger().info("%s %s", event,
                      " ".join(f"{k}={v}" for k, v in fields.items()))
    path = os.environ.get("TPURT_EVENT_LOG")
    if path:
        if _EVENT_FILE is None:
            _EVENT_FILE = open(path, "a")
        _EVENT_FILE.write(json.dumps(
            {"ts": time.time(), "event": event, **fields}) + "\n")
        _EVENT_FILE.flush()
