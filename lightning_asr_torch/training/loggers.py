"""Experiment loggers (port of ``lightning_asr_tpu/training/loggers.py``):
a JSONL metrics stream, TensorBoard and Comet, fanned out by
``MultiLogger``.  ``init_loggers(cfg)`` builds them from the ``loggers``
config section.  TensorBoard and Comet switch themselves off with a warning
when their package (or, for Comet, an api key) is absent."""

from __future__ import annotations

import json
import logging
import time
from pathlib import Path
from typing import Mapping, Optional, Union

logger = logging.getLogger(__name__)


class BaseLogger:
    def log_metrics(self, metrics: Mapping[str, float], step: int) -> None:
        raise NotImplementedError

    def log_hyperparams(self, params: Mapping) -> None:
        pass

    def log_text(self, tag: str, text: str, step: int) -> None:
        pass

    def finalize(self) -> None:
        pass


class CSVLogger(BaseLogger):
    """JSONL metrics stream, one object per call, in ``<save_dir>/<name>.jsonl``;
    hyperparameters in ``hparams.json`` beside it."""

    def __init__(self, save_dir: Union[str, Path], name: str = "metrics"):
        self.path = Path(save_dir) / f"{name}.jsonl"
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._fh = open(self.path, "a", encoding="utf-8")

    def log_metrics(self, metrics, step):
        row = {"step": int(step), "time": time.time()}
        row.update({k: float(v) for k, v in metrics.items()})
        self._fh.write(json.dumps(row) + "\n")
        self._fh.flush()

    def log_hyperparams(self, params):
        self.path.with_name("hparams.json").write_text(json.dumps(params, indent=2, default=str))

    def finalize(self):
        self._fh.close()


class TensorBoardLogger(BaseLogger):
    def __init__(self, save_dir: Union[str, Path], name: str = "default"):
        self.save_dir = str(Path(save_dir) / name)
        self._writer = None
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._writer = SummaryWriter(self.save_dir)
        except ImportError:
            logger.warning("no tensorboard writer available; TensorBoardLogger disabled")

    def log_metrics(self, metrics, step):
        if self._writer is not None:
            for k, v in metrics.items():
                self._writer.add_scalar(k, float(v), int(step))

    def log_text(self, tag, text, step):
        if self._writer is not None:
            self._writer.add_text(tag, text, int(step))

    def log_hyperparams(self, params):
        if self._writer is not None:
            self._writer.add_text("hparams", json.dumps(params, indent=2, default=str), 0)

    def finalize(self):
        if self._writer is not None:
            self._writer.close()


class CometLogger(BaseLogger):
    """A no-op unless ``comet_ml`` is installed and an api key is given."""

    def __init__(self, api_key: Optional[str] = None, workspace: Optional[str] = None,
                 project_name: Optional[str] = None, experiment_name: Optional[str] = None,
                 experiment_key: Optional[str] = None):
        self._exp = None
        if not api_key:
            logger.info("CometLogger: no api key; disabled")
            return
        try:
            import comet_ml

            if experiment_key:
                self._exp = comet_ml.ExistingExperiment(api_key=api_key,
                                                        previous_experiment=experiment_key)
            else:
                self._exp = comet_ml.Experiment(api_key=api_key, workspace=workspace,
                                                project_name=project_name)
            if experiment_name:
                self._exp.set_name(experiment_name)
        except ImportError:
            logger.warning("CometLogger disabled: comet_ml is not installed")

    def log_metrics(self, metrics, step):
        if self._exp is not None:
            self._exp.log_metrics({k: float(v) for k, v in metrics.items()}, step=int(step))

    def log_hyperparams(self, params):
        if self._exp is not None:
            self._exp.log_parameters(dict(params))

    def log_text(self, tag, text, step):
        if self._exp is not None:
            self._exp.log_text(f"[{tag}] {text}", step=int(step))

    def finalize(self):
        if self._exp is not None:
            self._exp.end()


class MultiLogger(BaseLogger):
    def __init__(self, loggers):
        self.loggers = [lg for lg in loggers if lg is not None]

    def log_metrics(self, metrics, step):
        for lg in self.loggers:
            lg.log_metrics(metrics, step)

    def log_hyperparams(self, params):
        for lg in self.loggers:
            lg.log_hyperparams(params)

    def log_text(self, tag, text, step):
        for lg in self.loggers:
            lg.log_text(tag, text, step)

    def finalize(self):
        for lg in self.loggers:
            lg.finalize()


def init_loggers(cfg, run_dir: Union[str, Path] = "outputs") -> MultiLogger:
    """The logger fan-out from the ``loggers`` config section."""
    run_dir = Path(run_dir)
    cfg = cfg or {}
    tb_cfg = cfg.get("tensorboard") or {}
    comet_cfg = cfg.get("comet") or {}
    return MultiLogger([
        CSVLogger(run_dir),
        TensorBoardLogger(tb_cfg.get("save_dir") or run_dir / "tensorboard_log",
                          tb_cfg.get("name", "default")),
        CometLogger(api_key=comet_cfg.get("COMET_API_KEY"), workspace=comet_cfg.get("workspace"),
                    project_name=comet_cfg.get("project_name"),
                    experiment_name=comet_cfg.get("experiment_fixed_name"),
                    experiment_key=comet_cfg.get("experiment_key")),
    ])
