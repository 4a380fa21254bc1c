"""Leveled logging of the port and its launcher (port of
``horovod_tpu/utils/logging.py``).

Levels TRACE/DEBUG/INFO/WARNING/ERROR/FATAL selected by
``HVD_LOG_LEVEL`` (default warning), timestamps suppressible with
``HVD_LOG_HIDE_TIME``; the launcher's format.
"""

import logging
import sys

from horovod_tpu_torch.utils import env as env_util

_LEVELS = {
    "trace": 5,
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "fatal": logging.CRITICAL,
}

logging.addLevelName(5, "TRACE")

_logger = None


def get_logger():
    global _logger
    if _logger is not None:
        return _logger
    logger = logging.getLogger("horovod_tpu_torch")
    level_name = env_util.get_str(
        env_util.HVD_LOG_LEVEL, "warning").strip().lower()
    logger.setLevel(_LEVELS.get(level_name, logging.WARNING))
    handler = logging.StreamHandler(sys.stderr)
    if env_util.get_bool(env_util.HVD_LOG_HIDE_TIME):
        fmt = "[%(levelname)s] %(message)s"
    else:
        fmt = "%(asctime)s [%(levelname)s] %(message)s"
    handler.setFormatter(logging.Formatter(fmt))
    logger.addHandler(handler)
    logger.propagate = False
    _logger = logger
    return logger
