"""Parity: the port's WER metric, config loader (with its own YAML reader),
plateau controller and the trainer's small parts (runtime-lr NovoGrad,
callbacks, loggers, profiler) against the JAX package's, on the CPU."""

import datetime
import json
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from lightning_asr_tpu.metrics.wer import WER as JaxWER
from lightning_asr_tpu.metrics.wer import word_error_rate as jax_wer
from lightning_asr_tpu.optim import ReduceLROnPlateau as JaxPlateau
from lightning_asr_tpu.utils.config import load_config as jax_load_config
from lightning_asr_tpu.utils.config import parse_overrides as jax_parse_overrides
from lightning_asr_torch.metrics.wer import WER, editdistance_eval, word_error_rate
from lightning_asr_torch.optim import ReduceLROnPlateau, novograd_with_runtime_lr
from lightning_asr_torch.training.callbacks import EarlyStopping
from lightning_asr_torch.training.loggers import init_loggers
from lightning_asr_torch.training.profiler import SimpleProfiler
from lightning_asr_torch.utils.config import load_config, parse_overrides
from lightning_asr_torch.utils.yaml_subset import safe_load

REPO = Path(__file__).resolve().parents[1]
LABELS = [" ", "'"] + [chr(ord("a") + i) for i in range(26)]

HYPS = ["the cat sat", "a dog", "", "hello world again", "xyz"]
REFS = ["the cat sat down", "the dog", "nothing here", "hello word again", "xyz"]


@pytest.mark.parametrize("use_cer", [False, True])
def test_wer_matches_jax(use_cer):
    assert word_error_rate(HYPS, REFS, use_cer) == jax_wer(HYPS, REFS, use_cer)
    ours, theirs = WER(LABELS, use_cer), JaxWER(LABELS, use_cer)
    for i in range(0, len(HYPS), 2):
        assert ours.update(HYPS[i:i + 2], REFS[i:i + 2]) == theirs.update(HYPS[i:i + 2], REFS[i:i + 2])
    assert ours.compute() == theirs.compute()
    assert (ours.scores, ours.words) == (theirs.scores, theirs.words)
    targets = np.array([[2, 3, 0, 4, 9], [5, 5, 1, 0, 0]], np.int32)
    assert ours.decode_reference(targets, [4, 3]) == theirs.decode_reference(targets, [4, 3])
    assert editdistance_eval("kitten", "sitting") == 3
    assert word_error_rate([""], [""]) == float("inf")
    with pytest.raises(ValueError):
        word_error_rate(["a"], [])


def _yaml_files():
    return sorted((REPO / "conf").rglob("*.yaml"))


@pytest.mark.parametrize("path", _yaml_files(), ids=lambda p: str(p.relative_to(REPO)))
def test_yaml_reader_matches_pyyaml_on_conf(path):
    text = path.read_text(encoding="utf-8")
    assert safe_load(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", [
    "1e-2", "1.0e-2", "0.", "-3", "0x1f", "010", "1_000", "1:30", ".inf", "-.Inf", "yes", "Off",
    "~", "null", "", "'it''s'", '"a\\tb"', "a: [1, 2.5, 'x', [y, {k: v}]]",
    "- a\n- b: 1\n  c: 2\n- - x\n  - y\n", "k: >-\n  one\n  two\n\n  three\nz: 1\n",
    "k: >-\n  a\n\n\n  b\n", "x: 'a # b' # c\ny: \"#q\"\n", "outputs/${a}/${now:%Y-%m-%d}",
    "a:\n- 1\n-\n  b: c\n", '"q": 1\n\'r s\': [a,\n  b]\n', "a: b\n  c\n", "[a, b]\n"])
def test_yaml_reader_matches_pyyaml_on_the_subset(text):
    assert safe_load(text) == yaml.safe_load(text)


def test_yaml_reader_refuses_what_it_does_not_read():
    for text in ("a: &x 1\nb: *x\n", "a: !!int 3\n", "d: 2001-12-14\n", "k: |\n  a\n",
                 "k: >\n  a\n", "k: >-\n  a\n   b\n"):
        with pytest.raises(ValueError):
            safe_load(text)


class _FixedNow(datetime.datetime):
    @classmethod
    def now(cls, tz=None):
        return cls(2026, 1, 2, 3, 4, 5)


OVERRIDES = ["train.learning_rate=1e-3", 'data.train_manifest=["a.json", "b.json"]',
             "model_name=run7", "train.checkpoint=/ckpt/last", "loggers.comet.workspace='w s'",
             "train.new.deep.key=3", "data.labels=/vocab.txt", "log.run.dir=outputs/${model_name}"]


@pytest.mark.parametrize("name", ["conf.yaml", "ssl-conf.yaml"])
def test_load_config_matches_jax(name, monkeypatch):
    monkeypatch.setattr(datetime, "datetime", _FixedNow)
    for overrides in ([], OVERRIDES):
        ours = load_config(REPO / "conf" / name, overrides)
        theirs = jax_load_config(REPO / "conf" / name, overrides)
        assert ours.to_dict() == theirs.to_dict()
        assert json.loads(ours.to_json()) == json.loads(json.dumps(theirs.to_dict()))
    assert ours.train.learning_rate == 1e-3 and ours.get("train.new.deep.key") == 3
    assert load_config(REPO / "conf" / name, resolve=False).get("log.run.dir").startswith("outputs/${")


def test_parse_overrides_matches_jax():
    args = ["a=1", "b=1e-3", "c=true", "d=[1, 2]", "e=hello", "f='1'", "g=", "h=x: y", "i=-2.5"]
    assert parse_overrides(args) == jax_parse_overrides(args)
    with pytest.raises(ValueError):
        parse_overrides(["novalue"])


def test_plateau_matches_jax():
    metrics = [5.0, 4.0, 4.0, 4.1, 3.9996, 3.9, 3.9, 3.95, 4.0, 4.0, 4.0, 4.0, 3.0, 3.0, 3.0,
               3.0, 3.0, 3.0, 3.0, 3.0]
    for kw in ({}, {"patience": 1, "cooldown": 1}, {"patience": 0, "cooldown": 0, "factor": 0.5,
                                                    "threshold_mode": "abs", "threshold": 0.05}):
        ours, theirs = ReduceLROnPlateau(1e-2, **kw), JaxPlateau(1e-2, **kw)
        for m in metrics:
            assert ours.step(m) == theirs.step(m)
            assert ours.state_dict() == theirs.state_dict()
        fresh = ReduceLROnPlateau(1e-2, **kw)
        fresh.load_state_dict(ours.state_dict())
        assert fresh.step(0.5) == theirs.step(0.5) and fresh.scale == theirs.scale
    with pytest.raises(ValueError):
        ReduceLROnPlateau(1e-2, factor=1.0)


def test_runtime_lr_novograd():
    """The learning rate is a tensor in the state: a new value there scales
    the next update, with the same optimizer."""
    opt = novograd_with_runtime_lr(1e-2, betas=(0.0, 0.5), weight_decay=0.0)
    p = {"w": torch.ones(4)}
    state = opt.init(p)
    g = {"w": torch.full((4,), 2.0)}
    u1, state = opt.update(g, state, p)
    state = state._replace(hyperparams={"learning_rate": torch.tensor(1e-3)})
    u2, state = opt.update(g, state, p)
    np.testing.assert_allclose(u2["w"].abs().numpy(), u1["w"].abs().numpy() / 10, rtol=1e-6)
    assert int(state.count) == int(state.inner_state.count) == 2


def test_callbacks_loggers_profiler(tmp_path):
    class T:
        should_stop = False

    stop = EarlyStopping(monitor="val_wer", patience=1)
    for i, v in enumerate([0.9, 0.8, 0.85, 0.81]):
        stop.on_validation_end(T, None, i, {"val_wer": v})
    assert T.should_stop and stop.best == 0.8

    loggers = init_loggers({"tensorboard": {"name": "tb"}}, tmp_path)
    loggers.log_hyperparams({"lr": 0.1})
    loggers.log_metrics({"loss": 1.5, "wer": torch.tensor(0.25)}, 3)
    loggers.log_text("sample", "abc", 3)
    loggers.finalize()
    rows = [json.loads(line) for line in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert rows[0]["step"] == 3 and rows[0]["loss"] == 1.5 and rows[0]["wer"] == 0.25
    assert json.loads((tmp_path / "hparams.json").read_text()) == {"lr": 0.1}

    prof = SimpleProfiler()
    for _ in range(3):
        with prof.profile("step"):
            pass
    assert prof.counts["step"] == 3 and "step" in prof.summary()
