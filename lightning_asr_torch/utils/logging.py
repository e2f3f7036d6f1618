"""Logging and determinism helpers (port of
``lightning_asr_tpu/utils/logging.py``): a formatted package logger, the
templated run directory of the ``log`` config group with its log file, and
``seed_everything``, which seeds Python, numpy and torch and returns a
``torch.Generator`` for the run."""

from __future__ import annotations

import logging
import os
import random
import sys
from pathlib import Path

import numpy as np
import torch

_FORMAT = "[%(asctime)s][%(name)s][%(levelname)s] - %(message)s"
PACKAGE = "lightning_asr_torch"


def get_logger(name: str = PACKAGE, level: int = logging.INFO) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(handler)
        logger.setLevel(level)
        logger.propagate = False
    return logger


def setup_run_dir(cfg, default: str = "outputs/run") -> Path:
    """Create the run directory (``log.run.dir``, else ``run_dir``, else
    ``default``) and apply the ``log.job_logging`` profile to the package
    logger: its format, level and a log file inside the run directory."""
    run_dir = Path(cfg.get("log.run.dir") or cfg.get("run_dir") or default)
    run_dir.mkdir(parents=True, exist_ok=True)
    job = cfg.get("log.job_logging")
    if job:
        fmt = job.get("format", _FORMAT)
        pkg = logging.getLogger(PACKAGE)
        pkg.setLevel(getattr(logging, str(job.get("level", "INFO")).upper(), logging.INFO))
        for h in pkg.handlers:
            h.setFormatter(logging.Formatter(fmt))
        if job.get("filename"):
            handler = logging.FileHandler(run_dir / job["filename"], encoding="utf-8")
            handler.setFormatter(logging.Formatter(fmt))
            pkg.addHandler(handler)
    return run_dir


def seed_everything(seed: int = 0) -> torch.Generator:
    """Seed Python, numpy and torch; return a generator seeded with
    ``seed``."""
    random.seed(seed)
    np.random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)
