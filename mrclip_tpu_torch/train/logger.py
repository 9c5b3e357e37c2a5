"""Logging setup of the training CLI (counterpart of
`mrclip_tpu/train/logger.py`): one format on stderr and, with a path, in a
log file. A second call (a second run in one process) replaces the handlers
of the first; torch's own loggers keep their levels."""

from __future__ import annotations

import logging


def setup_logging(log_file, level, include_host: bool = False):
    if include_host:
        import socket

        hostname = socket.gethostname()
        formatter = logging.Formatter(
            f"%(asctime)s |  {hostname} | %(levelname)s | %(message)s",
            datefmt="%Y-%m-%d,%H:%M:%S",
        )
    else:
        formatter = logging.Formatter(
            "%(asctime)s | %(levelname)s | %(message)s", datefmt="%Y-%m-%d,%H:%M:%S"
        )

    logging.root.setLevel(level)
    for name in logging.root.manager.loggerDict:
        if not name.startswith("torch"):
            logging.getLogger(name).setLevel(level)
    for h in [h for h in logging.root.handlers if getattr(h, "_mrclip", False)]:
        logging.root.removeHandler(h)
        h.close()

    handlers = [logging.StreamHandler()]
    if log_file:
        handlers.append(logging.FileHandler(filename=log_file))
    for h in handlers:
        h.setFormatter(formatter)
        h._mrclip = True
        logging.root.addHandler(h)
