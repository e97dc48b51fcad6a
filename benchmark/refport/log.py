"""Logging facade — equivalent of the reference's spdlog wrapper.

Reference: src/log/logmanager.cpp:20-41 (console + strelka.log file sinks,
level from SPDLOG_LEVEL env var), include/log/log.h:5-14 (STRELKA_* macros).
"""

from __future__ import annotations

import logging
import os
import sys

_LOGGER_NAME = "Strelka"
_initialized = False

_LEVELS = {
    "trace": logging.DEBUG - 5,
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warn": logging.WARNING,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "critical": logging.CRITICAL,
    "fatal": logging.CRITICAL,
    "off": logging.CRITICAL + 10,
}

logging.addLevelName(_LEVELS["trace"], "TRACE")


def _init() -> logging.Logger:
    global _initialized
    logger = logging.getLogger(_LOGGER_NAME)
    if _initialized:
        return logger
    _initialized = True
    # Level from env, mirroring SPDLOG_LEVEL (reference README.md:61-64).
    level_name = os.environ.get("STRELKA_LOG_LEVEL", os.environ.get("SPDLOG_LEVEL", "info"))
    logger.setLevel(_LEVELS.get(level_name.lower(), logging.INFO))
    fmt = logging.Formatter("[%(asctime)s] [%(name)s] [%(levelname)s] %(message)s", "%H:%M:%S")
    console = logging.StreamHandler(sys.stderr)
    console.setFormatter(fmt)
    logger.addHandler(console)
    try:
        filesink = logging.FileHandler("strelka.log")
        filesink.setFormatter(fmt)
        logger.addHandler(filesink)
    except OSError:
        pass  # read-only cwd: console only
    logger.propagate = False
    return logger


def _log(level: int, msg: str, *args) -> None:
    _init().log(level, msg.format(*args) if args else msg)


def trace(msg: str, *args) -> None:
    _log(_LEVELS["trace"], msg, *args)


def debug(msg: str, *args) -> None:
    _log(logging.DEBUG, msg, *args)


def info(msg: str, *args) -> None:
    _log(logging.INFO, msg, *args)


def warning(msg: str, *args) -> None:
    _log(logging.WARNING, msg, *args)


def error(msg: str, *args) -> None:
    _log(logging.ERROR, msg, *args)


def fatal(msg: str, *args) -> None:
    _log(logging.CRITICAL, msg, *args)
