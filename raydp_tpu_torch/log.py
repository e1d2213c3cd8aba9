"""Structured logging — the port's copy of :mod:`raydp_tpu.log`.

One process-tagged formatter on the ``raydp_tpu_torch`` logger tree, an
optional per-process log file under a session log dir, and a
``:session_id:`` marker line so log shippers can attribute a file to a
session.
"""

from __future__ import annotations

import logging
import os
import sys
from typing import Optional

_ROOT = "raydp_tpu_torch"
_FORMAT = "%(asctime)s %(levelname)s [%(raydp_role)s pid=%(process)d] %(name)s: %(message)s"


class _RoleFilter(logging.Filter):
    def __init__(self, role: str):
        super().__init__()
        self.role = role

    def filter(self, record):
        record.raydp_role = self.role
        return True


def init_logging(
    role: str = "driver",
    level: str = "INFO",
    log_dir: Optional[str] = None,
    session_id: Optional[str] = None,
) -> logging.Logger:
    """Configure the ``raydp_tpu_torch`` logger tree for this process.

    ``role`` is e.g. ``driver`` or ``worker-0``: the per-process tag every
    line carries.
    """
    logger = logging.getLogger(_ROOT)
    logger.setLevel(getattr(logging, level.upper(), logging.INFO))
    logger.propagate = False
    for h in list(logger.handlers):
        logger.removeHandler(h)

    fmt = logging.Formatter(_FORMAT)
    flt = _RoleFilter(role)

    sh = logging.StreamHandler(sys.stderr)
    sh.setFormatter(fmt)
    sh.addFilter(flt)
    logger.addHandler(sh)

    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        fname = f"{role}-{os.getpid()}.log"
        fh = logging.FileHandler(os.path.join(log_dir, fname))
        fh.setFormatter(fmt)
        fh.addFilter(flt)
        logger.addHandler(fh)
        if session_id:
            logger.info(":session_id:%s", session_id)
    return logger


def get_logger(name: str) -> logging.Logger:
    logger = logging.getLogger(f"{_ROOT}.{name}")
    if not logging.getLogger(_ROOT).handlers:
        init_logging()
    return logger
