"""The two checkpoint converters of the port, on the CPU:

  * ``scripts/torch_from_jax_ckpt.py``: a train state saved by the JAX
    package's Orbax ``CheckpointManager`` -> a port checkpoint, served by the
    port's ``AsrTranslator`` with JAX's log-probs and resumed by the port's
    ``CheckpointManager.restore`` with the NovoGrad state of
    ``opt_state_from_jax``;
  * ``lightning_asr_torch/utils/torch_import.py`` and
    ``scripts/torch_import_ckpt.py``: a reference (pytorch-lightning)
    state_dict -> the port's state_dict, equal bit for bit to the JAX
    package's converter followed by ``from_jax``.  No reference checkpoint
    is at hand (ROADMAP.md C3), so the test writes one, naming a random
    flax tree's tensors as the reference names them.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightning_asr_tpu.inference.predict import AsrTranslator as JaxTranslator
from lightning_asr_tpu.models import build_model as jax_build_model
from lightning_asr_tpu.optim import novograd as jax_novograd
from lightning_asr_tpu.training.checkpoint import CheckpointManager as JaxCheckpointManager
from lightning_asr_tpu.training.steps import AsrTrainState as JaxState
from lightning_asr_tpu.utils import torch_import as jax_torch_import
from lightning_asr_torch.data.audio import write_wav
from lightning_asr_torch.inference.predict import AsrTranslator
from lightning_asr_torch.models.quartznet import MODEL_REGISTRY, build_model
from lightning_asr_torch.predict import main as predict_main
from lightning_asr_torch.optim import novograd
from lightning_asr_torch.training.checkpoint import CheckpointManager
from lightning_asr_torch.training.steps import create_train_state
from lightning_asr_torch.utils.jax_params import from_jax, opt_state_from_jax
from lightning_asr_torch.utils.torch_import import convert_state_dict
from test_torch_model import NUM_CLASSES, class_std, with_teeth

REPO = Path(__file__).resolve().parents[1]
LABELS = JaxTranslator.EN_LABELS
CONTEXT_ENCODERS = ("quartznet12_context", "quartznet12_context_se")
assert len(LABELS) + 1 == NUM_CLASSES


def _script(name):
    spec = importlib.util.spec_from_file_location(name, REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _teeth_weights(encoder, seed):
    model = jax_build_model(NUM_CLASSES, encoder, mask=True)
    variables = jax.jit(lambda f, p: model.init(jax.random.PRNGKey(seed), f, p, False))(
        jnp.zeros((1, 40, 64), jnp.float32), jnp.ones((1,), jnp.float32))
    return with_teeth(variables["params"], variables["batch_stats"], np.random.default_rng(seed))


@pytest.mark.parametrize("encoder", MODEL_REGISTRY)
def test_orbax_checkpoint_serves_and_resumes_on_the_port(encoder, tmp_path):
    """A JAX train state of each encoder after one fused NovoGrad update,
    saved by the JAX package, converted by ``scripts/torch_from_jax_ckpt.py``:
    both translators' float32 log-probs on one seeded wave agree within 1e-5
    (frontend tier "highest": both compute it in float32), the port's predict
    CLI transcribes the wave as its translator does, and the port's
    ``CheckpointManager.restore`` reads the converted ``train_state.pt`` as
    ``opt_state_from_jax`` gives it, bit for bit."""
    params, stats = _teeth_weights(encoder, 1)
    opt = jax_novograd(1e-2, betas=(0.8, 0.5), weight_decay=1e-3, fused=True)
    rng = np.random.default_rng(2)
    grads = jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(np.float32), params)
    opt_state = jax.device_get(jax.jit(lambda g, p: opt.update(g, opt.init(p), p)[1])(grads, params))
    state = JaxState(step=jnp.ones((), jnp.int32), params=params, batch_stats=stats,
                     opt_state=opt_state, nan_count=jnp.zeros((), jnp.int32))
    hparams = {"labels": LABELS, "use_cer": False, "encoder": encoder, "mask": True,
               "drop_rate": 0.0, "compute_dtype": "float32", "normalize": True,
               "frontend": {"precision": "highest", "dither": 0.0}}
    JaxCheckpointManager(tmp_path / "jax", top_k=1).save(state, epoch=3, metrics={"val_wer": 0.5},
                                                         hparams=hparams)

    out = _script("torch_from_jax_ckpt").main(["--jax-ckpt", str(tmp_path / "jax" / "last"),
                                               "--out", str(tmp_path / "port")])
    assert {p.name for p in out.iterdir()} == {"state.pt", "metadata.json", "train_state.pt"}

    jt = JaxTranslator(tmp_path / "jax" / "last")
    pt = AsrTranslator(out, device="cpu")
    wave = (np.random.default_rng(4).standard_normal(21000) * 0.1).astype(np.float32)
    batch, lens = pt.pad_batch([wave])
    want, want_lens = jt._jit_forward(jnp.asarray(batch), jnp.asarray(lens))
    want = np.asarray(want)
    assert class_std(want) >= 0.5, class_std(want)          # the comparison has teeth
    got, got_lens = pt._forward(torch.from_numpy(batch), torch.from_numpy(lens))
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    write_wav(tmp_path / "a.wav", wave[None], 16000)
    text = predict_main(["--model", str(out), "--audio", str(tmp_path / "a.wav"), "--device", "cpu"])
    assert text == {"audio": pt.translate(str(tmp_path / "a.wav"))}

    model = build_model(NUM_CLASSES, encoder, mask=True)
    template = create_train_state(model, novograd(1e-2, betas=(0.8, 0.5), weight_decay=1e-3,
                                                  fused=True))
    restored, meta = CheckpointManager(tmp_path / "resume").restore(template, str(out))
    assert meta["epoch"] == 3 and meta["hparams"]["encoder"] == encoder
    assert int(restored.step) == 1 and int(restored.nan_count) == 0
    want_opt = opt_state_from_jax(opt_state, params, stats, template.params)
    for field in want_opt._fields:
        assert torch.equal(getattr(restored.opt_state, field), getattr(want_opt, field)), field
    for k, v in from_jax(params, stats).items():
        assert torch.equal(restored.params[k] if k in restored.params else restored.batch_stats[k], v), k


def test_orbax_runtime_lr_state_behind_clipping_resumes_on_the_port(tmp_path):
    """The plateau recipe's optimizer as the JAX trainer builds it (fused
    NovoGrad inside ``inject_hyperparams``, behind gradient clipping): the
    converter finds the fused state in the restored chain, and the port's
    ``CheckpointManager.restore`` gives its runtime-lr state the JAX
    state's count, learning rate and NovoGrad buffers, bit for bit."""
    from lightning_asr_tpu.optim import novograd_with_runtime_lr as jax_runtime_lr
    from lightning_asr_tpu.optim import with_gradient_clipping as jax_clipping
    from lightning_asr_torch.optim import novograd_with_runtime_lr, with_gradient_clipping

    params, stats = _teeth_weights("quartznet12_context", 3)
    opt = jax_clipping(jax_runtime_lr(3e-3, betas=(0.8, 0.5), weight_decay=1e-3, fused=True), 0.5)
    rng = np.random.default_rng(4)
    grads = jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(np.float32), params)
    opt_state = jax.device_get(jax.jit(lambda g, p: opt.update(g, opt.init(p), p)[1])(grads, params))
    state = JaxState(step=jnp.ones((), jnp.int32), params=params, batch_stats=stats,
                     opt_state=opt_state, nan_count=jnp.zeros((), jnp.int32))
    JaxCheckpointManager(tmp_path / "jax", top_k=1).save(
        state, epoch=1, metrics={}, hparams={"labels": LABELS, "encoder": "quartznet12_context"})
    out = _script("torch_from_jax_ckpt").main(["--jax-ckpt", str(tmp_path / "jax" / "last"),
                                               "--out", str(tmp_path / "port")])

    model = build_model(NUM_CLASSES, "quartznet12_context", mask=True)
    template = create_train_state(model, with_gradient_clipping(
        novograd_with_runtime_lr(1e-2, betas=(0.8, 0.5), weight_decay=1e-3, fused=True), 0.5))
    restored, _ = CheckpointManager(tmp_path / "resume").restore(template, str(out))
    inject = opt_state[1]
    assert int(restored.opt_state.count) == int(inject.count) == 1
    assert restored.opt_state.hyperparams["learning_rate"].item() == np.float32(3e-3)
    want = opt_state_from_jax(inject.inner_state, params, stats, template.params)
    for field in want._fields:
        assert torch.equal(getattr(restored.opt_state.inner_state, field), getattr(want, field)), field


def _reference_name(module: tuple, leaf: str, n_seq: dict) -> str:
    """The reference's key of a flax leaf (the JAX converter's map,
    inverted)."""
    if module[0] == "decoder":
        return f"encoder.decoder.{'weight' if leaf == 'kernel' else 'bias'}"
    parts = list(module[1:])
    if parts[0] == "context_rnn":
        kind = {"w_ih": "weight_ih_l0", "w_hh": "weight_hh_l0", "b_ih": "bias_ih_l0",
                "b_hh": "bias_hh_l0"}[leaf[:4]]
        return f"encoder.encoder.context_rnn.{kind}{'_reverse' if leaf.endswith('_b') else ''}"
    rename = {"last_conv": "last_cnn2.0", "last_bn": "last_cnn2.1", "reside_conv": "reside.0",
              "reside_bn": "reside.1", "fc1": "fc.0", "fc2": "fc.2"}
    out = []
    for i, part in enumerate(parts):
        if part == "sep_last":
            out.append(f"seq.{n_seq[parts[i - 1]] - 1}")
        elif part.startswith("sep"):
            out.append(f"seq.{part[3:]}")
        else:
            out.append(rename.get(part, part))
    name = {"kernel": "weight", "scale": "weight", "mean": "running_mean",
            "var": "running_var"}.get(leaf, leaf)
    return "encoder.encoder." + ".".join(out + [name])


def reference_state_dict(params, stats) -> dict:
    """A reference-named torch state_dict of a flax tree: conv kernels as
    (out, in, k), Dense kernels as (out, in), each BatchNorm with its
    ``num_batches_tracked``, and a loss buffer the converters drop."""
    flat = {}
    for tree in (params, stats):
        for path, value in jax.tree_util.tree_leaves_with_path(tree):
            flat[tuple(p.key for p in path)] = np.asarray(value)
    seps = {}
    for path in flat:
        if path[0] == "encoder" and path[1].startswith("block") and path[2].startswith("sep"):
            seps.setdefault(path[1], set()).add(path[2])
    n_seq = {block: len(names) for block, names in seps.items()}
    sd = {}
    for path, value in flat.items():
        key = _reference_name(path[:-1], path[-1], n_seq)
        sd[key] = torch.from_numpy(np.ascontiguousarray(np.transpose(value)) if path[-1] == "kernel"
                                   else value.copy())
        if path[-1] == "mean":
            sd[key.replace("running_mean", "num_batches_tracked")] = torch.tensor(7)
    sd["wer.total"] = torch.tensor(0.0)
    return sd


@pytest.mark.parametrize("encoder", CONTEXT_ENCODERS)
def test_reference_checkpoint_converts_as_the_jax_package(encoder, tmp_path):
    """The port's ``convert_state_dict`` of a reference-named state_dict
    equals ``from_jax`` of the JAX package's ``convert_state_dict`` bit for
    bit, key for key, and loads into the port's model; then
    ``scripts/torch_import_ckpt.py`` writes a directory that the port's
    ``AsrTranslator`` loads and serves with JAX's log-probs."""
    params, stats = _teeth_weights(encoder, 5)
    sd = reference_state_dict(params, stats)
    assert any(".seq.0." in k for k in sd) and "encoder.encoder.last_cnn2.1.num_batches_tracked" in sd
    if encoder.endswith("_se"):
        assert "encoder.encoder.block6.seq.0.se.fc.2.weight" in sd
    got = convert_state_dict(sd)
    want = from_jax(*jax_torch_import.convert_state_dict(sd))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    build_model(NUM_CLASSES, encoder, mask=True).load_state_dict(got, strict=True)

    ckpt = tmp_path / "ref.ckpt"
    torch.save({"state_dict": sd, "hyper_parameters": {"mask": True, "drop_rate": 0.0}}, ckpt)
    out = _script("torch_import_ckpt").main(["--ckpt", str(ckpt), "--out", str(tmp_path / "port"),
                                             "--encoder", encoder])
    pt = AsrTranslator(out, device="cpu")
    for k, v in pt.model.state_dict().items():
        assert torch.equal(v, got[k]), k
    wave = (np.random.default_rng(6).standard_normal(16000) * 0.1).astype(np.float32)
    batch, lens = pt.pad_batch([wave])
    jmodel = jax_build_model(NUM_CLASSES, encoder, mask=True)
    feats, feat_lens = _jax_features(batch, lens, pt)
    want_lp, _ = jax.jit(lambda f, p: jmodel.apply({"params": params, "batch_stats": stats},
                                                   f, p, False))(feats, feat_lens)
    lp, _ = pt._forward(torch.from_numpy(batch), torch.from_numpy(lens))
    np.testing.assert_allclose(lp.numpy(), np.asarray(want_lp), rtol=1e-5, atol=1e-5)
    assert isinstance(pt.transcribe_batch([wave])[0], str)


def _jax_features(batch, lens, translator):
    """JAX's normalised features and percents for the translator's frontend."""
    from lightning_asr_tpu.ops import frontend as jf

    cfg = jf.MelFrontendConfig(**translator.frontend.__dict__)
    feats, feat_lens = jf.log_mel_spectrogram(jnp.asarray(batch), jnp.asarray(lens), cfg)
    feats = jf.normalize_features(feats, feat_lens)
    return feats, feat_lens.astype(jnp.float32) / jnp.float32(feats.shape[1])
