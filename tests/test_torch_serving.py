"""The port's serving slice on the CPU: JAX weights through the bridge into a
port checkpoint, ``AsrTranslator`` against the JAX ``_forward`` composition
on the same padded batch, and the stdlib HTTP server's contract."""

import ast
import http.client
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightning_asr_tpu.models import build_model as jax_build_model
from lightning_asr_tpu.ops import frontend as jf
from lightning_asr_torch.data.audio import wav_bytes
from lightning_asr_torch.inference.predict import AsrTranslator
from lightning_asr_torch.inference import server as server_mod
from lightning_asr_torch.inference.server import DynamicBatcher, make_stdlib_server
from lightning_asr_torch.training.checkpoint import save_checkpoint
from lightning_asr_torch.utils.jax_params import from_jax
from test_torch_model import NUM_CLASSES, class_std, with_teeth

REPO = Path(__file__).resolve().parents[1]
FRONTEND = jf.MelFrontendConfig(precision="default")    # the training tier, K1's path


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """(JAX model, params, stats, port checkpoint dir, CPU translator)."""
    rng = np.random.default_rng(11)
    model = jax_build_model(NUM_CLASSES, "quartznet12_context", mask=True)
    variables = model.init(jax.random.PRNGKey(3), jnp.zeros((1, 40, 64), jnp.float32),
                           jnp.ones((1,), jnp.float32), False)
    params, stats = with_teeth(variables["params"], variables["batch_stats"], rng)
    hparams = {"labels": AsrTranslator.EN_LABELS, "use_cer": False,
               "encoder": "quartznet12_context", "in_c": 64, "mask": True,
               "compute_dtype": "float32", "frontend": dict(FRONTEND.__dict__),
               "normalize": True}
    ckpt = save_checkpoint(tmp_path_factory.mktemp("ckpt"), from_jax(params, stats), hparams)
    return model, params, stats, ckpt, AsrTranslator(ckpt, device="cpu")


def _waves(seed, lengths):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(n) * 0.1).astype(np.float32) for n in lengths]


def test_translator_matches_jax_forward(served):
    model, params, stats, _, translator = served
    assert translator.device.type == "cpu" and translator.frontend.precision == "default"
    batch, lens = translator.pad_batch(_waves(0, [16000, 11000, 5200]))
    assert batch.shape == (4, 32000)                       # 2 s bucket, rows to 4
    np.testing.assert_array_equal(batch[3], batch[0])      # padding rows copy row 0

    feats, feat_lens = jf.log_mel_spectrogram(jnp.asarray(batch), jnp.asarray(lens), FRONTEND)
    feats = jf.normalize_features(feats, feat_lens)
    percents = feat_lens.astype(jnp.float32) / jnp.float32(feats.shape[1])
    want_lp, want_lens = jax.jit(lambda f, p: model.apply(
        {"params": params, "batch_stats": stats}, f, p, False))(feats, percents)
    want_lp = np.asarray(want_lp)
    assert class_std(want_lp) >= 0.5, class_std(want_lp)

    lp, out_lens = translator._forward(torch.from_numpy(batch), torch.from_numpy(lens))
    np.testing.assert_array_equal(out_lens.numpy(), np.asarray(want_lens))
    err = np.abs(lp.numpy() - np.asarray(want_lp))
    # the frontends agree to 0.035 dB (one bf16 power flip, see
    # test_torch_frontend.py), i.e. ~3e-3 in normalized features, which the
    # float32 model carries into the log-probs
    assert err.max() < 5e-2, err.max()
    assert err.mean() < 1e-3, err.mean()
    assert np.mean(lp.numpy().argmax(-1) == want_lp.argmax(-1)) > 0.98


def _post(port, body, content_type):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("POST", "/", body=body, headers={"Content-Type": content_type})
        resp = conn.getresponse()
        return resp.status, resp.read().decode("utf-8", "replace")
    finally:
        conn.close()


def _multipart(payload: bytes, field: str = "audio"):
    boundary = "lasrtestboundary"
    body = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"{field}\"; "
            f"filename=\"a.wav\"\r\nContent-Type: audio/wav\r\n\r\n").encode()
    body += payload + f"\r\n--{boundary}--\r\n".encode()
    return body, f"multipart/form-data; boundary={boundary}"


@pytest.mark.parametrize("batching", [False, True])
def test_http_server_contract(served, batching):
    translator = served[4]
    wave = _waves(1, [12000])[0]
    audio = wav_bytes(wave, 16000)
    want = translator.translate(audio)
    server = make_stdlib_server(translator, port=0, batching=batching, max_batch=4)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        port = server.server_address[1]
        assert _post(port, *_multipart(audio)) == (200, want)
        status, _ = _post(port, *_multipart(audio, field="file"))
        assert status == 400
        status, _ = _post(port, *_multipart(wav_bytes(wave, 22050)))
        assert status == 400
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()


def test_dynamic_batcher_takes_max_seconds_and_decode_threads(served, monkeypatch):
    """``DynamicBatcher(max_seconds=, decode_threads=)``, as the JAX
    batcher takes them: a request longer than ``max_seconds`` is cut to that
    many samples before it is transcribed, and the native parser runs on
    ``decode_threads`` threads."""
    translator = served[4]
    calls = []
    real = server_mod.parse_wav_batch_mem

    def spy(blobs, max_samples, threads):
        calls.append((len(blobs), max_samples, threads))
        return real(blobs, max_samples, threads)

    monkeypatch.setattr(server_mod, "parse_wav_batch_mem", spy)
    wave = _waves(5, [20000])[0]
    blob = wav_bytes(wave, 16000)
    batcher = DynamicBatcher(translator, max_batch=1, max_wait_ms=1.0, max_seconds=0.5,
                             decode_threads=3)
    assert batcher.max_samples == 8000 and batcher.decode_threads == 3
    decoded = batcher._decode([blob])[0]
    assert decoded.shape == (8000,)
    np.testing.assert_array_equal(decoded, batcher._decode([wav_bytes(wave[:8000], 16000)])[0])
    # the request is transcribed as its first 8000 samples
    assert batcher.translate(blob) == translator.transcribe_batch([decoded])[0]
    assert calls and all(c[1:] == (8000, 3) for c in calls), calls


_FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "yaml", "lightning_asr_tpu")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", "")) in
              ("import_module", "__import__")):
            yield node.args[0].value.split(".")[0]


def test_port_imports_no_jax():
    files = sorted((REPO / "lightning_asr_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10 and files[-1].exists()
    bad = [(str(p.relative_to(REPO)), root) for p in files for root in _imported_roots(p)
           if root in _FORBIDDEN]
    assert not bad, bad


@pytest.mark.parametrize("module", ["native.py", "predict.py", "decoding/__init__.py",
                                    "decoding/beam_search.py", "decoding/device_beam.py",
                                    "decoding/greedy.py", "inference/predict.py",
                                    "inference/server.py", "inference/streaming.py",
                                    "ssl_codec/confidence.py"])
def test_decoding_and_inference_modules_import_no_jax(module):
    """The decoding and offline-inference modules import neither JAX nor the
    JAX package, not even its JAX-free ``native`` binding."""
    path = REPO / "lightning_asr_torch" / module
    roots = set(_imported_roots(path))
    assert not roots & set(_FORBIDDEN), roots
    assert "import jax" not in path.read_text() and "lightning_asr_tpu.native" not in path.read_text()
