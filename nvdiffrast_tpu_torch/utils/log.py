"""Log level plumbing.

Same integer convention as ``nvdiffrast_tpu.utils.log`` (0=Info,
1=Warning, 2=Error, 3=Fatal; default 1), mapped onto Python's logging
module for the ``nvdiffrast_tpu_torch`` logger.
"""

import logging

_LOGGER = logging.getLogger("nvdiffrast_tpu_torch")

# Integer level convention <-> python logging levels.
_LEVELS = [logging.INFO, logging.WARNING, logging.ERROR, logging.CRITICAL]

_current_level = 1
_LOGGER.setLevel(_LEVELS[_current_level])


def get_log_level():
    """Get current log level (see `set_log_level()` for the values)."""
    return _current_level


def set_log_level(level):
    """Set log level.

    Log levels: 0 = Info, 1 = Warning, 2 = Error, 3 = Fatal. The default
    is 1. Messages of this severity or higher are printed.
    """
    global _current_level
    level = int(level)
    if not 0 <= level <= 3:
        raise ValueError("log level must be in [0, 3]")
    _current_level = level
    _LOGGER.setLevel(_LEVELS[level])


def logger():
    return _LOGGER
