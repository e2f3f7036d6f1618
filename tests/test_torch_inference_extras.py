"""The port's offline-inference extras on the CPU: ``plan_chunks`` and
``translate_long`` against the JAX package (one module-scoped full-width
JAX model, as ``test_torch_serving.py`` builds it), ``StreamingTranscriber``
against ``translate_long``, ``evaluate_manifest`` with its CSV, the
server's native WAV parser, and the predict CLI with ``--device cpu``."""

import csv
import http.client
import json
import threading
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightning_asr_tpu.decoding.greedy import greedy_decode_to_strings as jax_greedy_strings
from lightning_asr_tpu.inference.predict import plan_chunks as jax_plan_chunks
from lightning_asr_tpu.models import build_model as jax_build_model
from lightning_asr_tpu.ops import frontend as jf
from lightning_asr_torch.data.audio import read_audio, wav_bytes, write_wav
from lightning_asr_torch.decoding.device_beam import DeviceBeamSearchDecoder
from lightning_asr_torch.inference.predict import AsrTranslator, plan_chunks
from lightning_asr_torch.inference.server import DynamicBatcher, make_stdlib_server
from lightning_asr_torch.inference.streaming import StreamingTranscriber
from lightning_asr_torch.metrics.wer import word_error_rate
from lightning_asr_torch.predict import main as predict_main
from lightning_asr_torch.ssl_codec.confidence import sum_logprob
from lightning_asr_torch.training.checkpoint import save_checkpoint
from lightning_asr_torch.utils.jax_params import from_jax
from test_torch_model import NUM_CLASSES, class_std, with_teeth

SR = 16000
# the float32 frontend tier: the port and JAX agree to float32 rounding,
# so the log-probs agree far inside the serving test's bounds (max 5e-2,
# mean 1e-3) and the greedy texts are equal
FRONTEND = jf.MelFrontendConfig(precision="highest", dither=0.0)
CHUNK_S, OVERLAP_S = 2.0, 0.25        # windows of 2 s, 0.5 s shared


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


def _wave(seconds, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(int(seconds * SR)) * 0.1).astype(np.float32)


@pytest.mark.parametrize("chunk,overlap", [(32000, 4000), (320000, 32000), (1000, 499)])
def test_plan_chunks_matches_jax(chunk, overlap):
    for n in list(range(0, 3 * chunk, max(1, chunk // 37))) + [chunk - 1, chunk, chunk + 1,
                                                               10 * chunk + 7]:
        plans = plan_chunks(n, chunk, overlap)
        assert plans == jax_plan_chunks(n, chunk, overlap), n
        kept = [(s + lo, s + hi) for s, lo, hi in plans]
        assert kept[0][0] == 0 and kept[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(kept, kept[1:]))
    with pytest.raises(ValueError):
        plan_chunks(10, 4, 2)


def test_translate_long_matches_jax(served):
    """The port's stitched log-probs against JAX's forward of the same
    window batch with the same stitch.  Every window of a long file fills
    the window, the row shape on which JAX's jitted translator folds the
    length recovery into one constant product and can drop a row's last
    frame (ROADMAP §C5); here JAX's percents are computed outside the jit,
    as in ``test_torch_serving.py``, so no row is affected: both sides give
    every window T' frames, the reference's int(T'·(len/T))."""
    model, params, stats, _, translator = served
    wave = _wave(5.3, 1)
    chunk, overlap = int(CHUNK_S * SR), int(OVERLAP_S * SR)
    plans = plan_chunks(wave.shape[0], chunk, overlap)
    assert len(plans) == 4
    batch, lens = translator.pad_batch([wave[s: s + chunk] for s, _, _ in plans], n_max=chunk)
    assert (lens == chunk).all()

    feats, feat_lens = jf.log_mel_spectrogram(jnp.asarray(batch), jnp.asarray(lens), FRONTEND)
    feats = jf.normalize_features(feats, feat_lens)
    percents = feat_lens.astype(jnp.float32) / jnp.float32(feats.shape[1])
    want_lp, want_lens = jax.jit(lambda f, p: model.apply(
        {"params": params, "batch_stats": stats}, f, p, False))(feats, percents)
    want_lp, want_lens = np.asarray(want_lp), np.asarray(want_lens)
    T_out = want_lp.shape[1]
    np.testing.assert_array_equal(want_lens, T_out)
    _, out_lens = translator._forward(torch.from_numpy(batch), torch.from_numpy(lens))
    np.testing.assert_array_equal(out_lens.numpy(), T_out)

    # JAX's stitch (inference/predict.py translate_long) on JAX's log-probs
    T_mel = jf.mel_num_frames(chunk, FRONTEND)

    def frame(s):
        return 0 if s <= 0 else min(T_out, T_out * jf.mel_num_frames(s, FRONTEND) // T_mel)

    want = np.concatenate([want_lp[i, frame(lo): max(frame(hi), frame(lo))]
                           for i, (_, lo, hi) in enumerate(plans)])
    got = translator.long_log_probs(wave, CHUNK_S, OVERLAP_S)
    assert got.shape == want.shape and got.dtype == np.float32
    assert class_std(want) >= 0.5, class_std(want)
    err = np.abs(got - want)
    assert err.max() < 5e-2 and err.mean() < 1e-3, (err.max(), err.mean())
    text = translator.translate_long(wav_bytes(wave, SR), CHUNK_S, OVERLAP_S)
    want_text = jax_greedy_strings(want.argmax(-1)[None], np.asarray([want.shape[0]]),
                                   translator.vocab.labels, translator.vocab.blank_id)[0]
    assert text == want_text and len(text) > 10


@pytest.mark.parametrize("decoder", ["greedy", "device_beam"])
def test_streaming_finish_equals_translate_long(served, decoder):
    """Fed in ragged blocks, the stream's transcript is translate_long's;
    greedy partials only ever append."""
    translator = served[4]
    blob = wav_bytes(_wave(5.3, 2), SR)
    wave = read_audio(blob)[0][0]               # the 16-bit samples translate_long reads
    translator.beam_decoder = (DeviceBeamSearchDecoder(translator.vocab.labels, 8, device="cpu")
                               if decoder == "device_beam" else None)
    try:
        offline = translator.translate_long(blob, CHUNK_S, OVERLAP_S)
        st = StreamingTranscriber(translator, CHUNK_S, OVERLAP_S)
        rng = np.random.default_rng(7)
        pos, parts = 0, []
        while pos < wave.shape[0]:
            n = int(rng.integers(1_000, 12_000))
            parts.append(st.feed(wave[pos: pos + n]))
            pos += n
        assert st.samples_fed == wave.shape[0]
        final = st.finish()
    finally:
        translator.beam_decoder = None
    assert final == offline and len(final) > 10
    for a, b in zip(parts, parts[1:]):
        assert b.startswith(a)
    assert st.finish() == final and st.partial() == final
    with pytest.raises(RuntimeError):
        st.feed(wave[:10])


def test_streaming_final_window_reads_real_samples(served, monkeypatch):
    """The final right-aligned window can start before the next hop
    boundary; it must read the true samples, not zeros."""
    translator = served[4]
    wave = _wave(5.3, 9)
    st = StreamingTranscriber(translator, CHUNK_S, OVERLAP_S)
    captured = []
    inner = translator._forward

    def capturing(w, lens):
        captured.append(w[0].numpy().copy())
        return inner(w, lens)

    monkeypatch.setattr(translator, "_forward", capturing)
    for pos in range(0, wave.shape[0], 1000):
        st.feed(wave[pos: pos + 1000])
        assert sum(p.size for p in st._buf) <= st.chunk + st.hop + 1000
    st.finish()
    final_start = wave.shape[0] - st.chunk
    assert final_start < st._next_start
    np.testing.assert_array_equal(captured[-1], wave[final_start:])
    with pytest.raises(ValueError):
        StreamingTranscriber(translator, 1.0, 0.5)
    assert StreamingTranscriber(translator, CHUNK_S, OVERLAP_S).finish() == ""


def _corpus(root, n=5):
    """n WAVs of 0.6-1.8 s and a manifest whose texts are the translator's
    words and a made-up one."""
    entries = []
    for i in range(n):
        wave = _wave(0.6 + 0.3 * i, 20 + i)
        path = root / f"u{i}.wav"
        write_wav(path, wave, SR)
        entries.append({"audio_filepath": str(path), "duration": wave.shape[0] / SR,
                        "text": "a b" if i % 2 else "hello"})
    manifest = root / "manifest.json"
    manifest.write_text("".join(json.dumps(e) + "\n" for e in entries))
    return manifest, entries


def test_evaluate_manifest_wer_and_csv(served, tmp_path):
    _, _, _, ckpt, plain = served
    manifest, entries = _corpus(tmp_path)
    translator = AsrTranslator(ckpt, device="cpu", return_confidence=True)
    out_csv = tmp_path / "report.csv"
    result = translator.evaluate_manifest(manifest, batch_size=2, csv_path=out_csv)
    waves = [read_audio(e["audio_filepath"], mono=True)[0][0] for e in entries]
    pairs = translator.transcribe_batch(waves)
    texts = [t for t, _ in pairs]
    assert texts == plain.transcribe_batch(waves)
    refs = [e["text"] for e in entries]
    assert result == {"wer": word_error_rate(texts, refs), "n_utterances": len(entries)}
    with open(out_csv, newline="", encoding="utf-8") as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["audio_filepath", "reference", "hypothesis", "wer", "confidence"]
    assert [r[2] for r in rows[1:]] == texts and len(rows) == 1 + len(entries)
    confs = np.asarray([float(r[4]) for r in rows[1:]])
    assert np.isfinite(confs).all()
    # the manifest ran in batches of 2, this in one of 5: float32 sums of
    # another batch shape
    np.testing.assert_allclose(confs, [c for _, c in pairs], rtol=1e-5)
    # the confidence is sum_logprob of the forward's log-probs, blank frames skipped
    batch, lens = translator.pad_batch(waves)
    lp, out_lens = translator._forward(torch.from_numpy(batch), torch.from_numpy(lens))
    np.testing.assert_array_equal([c for _, c in pairs], sum_logprob(
        lp.numpy()[:5], out_lens.numpy()[:5], translator.vocab.blank_id))


def test_native_parser_rows(served):
    """One native pass per batch: good rows equal read_audio's samples, a
    malformed body and a wrong sample rate become that row's ValueError."""
    batcher = DynamicBatcher(served[4], max_batch=4)
    good = wav_bytes(_wave(0.7, 3), SR)
    rows = batcher._decode([good, b"RIFF\x00\x00junk", wav_bytes(_wave(0.5, 4), 22050), good[:60]])
    np.testing.assert_array_equal(rows[0], read_audio(good)[0][0])
    assert isinstance(rows[1], ValueError) and "malformed" in str(rows[1])
    assert isinstance(rows[2], ValueError) and "22050" in str(rows[2])
    assert isinstance(rows[3], ValueError)


def _post(port, payload, field="audio"):
    boundary = "lasrtestboundary"
    body = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"{field}\"; "
            f"filename=\"a.wav\"\r\nContent-Type: audio/wav\r\n\r\n").encode()
    body += payload + f"\r\n--{boundary}--\r\n".encode()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("POST", "/", body=body,
                     headers={"Content-Type": f"multipart/form-data; boundary={boundary}"})
        resp = conn.getresponse()
        return resp.status, resp.read().decode("utf-8", "replace")
    finally:
        conn.close()


def test_batched_server_answers_through_native_parser(served):
    translator = served[4]
    waves = [_wave(s, 30 + i) for i, s in enumerate((0.8, 1.3, 0.5))]
    blobs = [wav_bytes(w, SR) for w in waves]
    want = translator.transcribe_batch([read_audio(b)[0][0] for b in blobs])
    server = make_stdlib_server(translator, port=0, batching=True, max_batch=5, max_wait_ms=500)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        port = server.server_address[1]
        with ThreadPoolExecutor(5) as pool:
            futs = [pool.submit(_post, port, b) for b in blobs]
            bad = pool.submit(_post, port, b"RIFF\x10\x00\x00\x00WAVEjunk")
            rate = pool.submit(_post, port, wav_bytes(waves[0], 8000))
            answers = [f.result() for f in futs]
            assert bad.result()[0] == 400 and rate.result()[0] == 400
        assert answers == [(200, t) for t in want]
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()


CLI_MODES = {
    "manifest_csv_confidence": ["--csv", "{csv}", "--confidence"],
    "manifest_lm_hotword": ["--lm", "{lm}", "--hotword", "hello:3", "--beam_width", "8"],
    "audio_device_beam": ["--audio", "{wav}", "--device_beam", "--beam_width", "8"],
    "audio_long": ["--audio", "{long}", "--long", "--chunk_seconds", "2",
                   "--overlap_seconds", "0.25"],
    "audio_stream": ["--audio", "{long}", "--stream", "--chunk_seconds", "2",
                     "--overlap_seconds", "0.25"],
}


@pytest.mark.parametrize("mode", sorted(CLI_MODES))
def test_predict_cli_on_cpu(served, tmp_path, mode, capsys):
    _, _, _, ckpt, translator = served
    manifest, entries = _corpus(tmp_path, n=3)
    lm = tmp_path / "lm.arpa"
    lm.write_text("\\data\\\nngram 1=3\n\n\\1-grams:\n-0.5\t<unk>\n-0.5\thello\n-0.5\t</s>\n\n"
                  "\\end\\\n")
    long_wav = tmp_path / "long.wav"
    write_wav(long_wav, _wave(5.3, 2), SR)
    args = [a.format(csv=tmp_path / "r.csv", lm=lm, wav=entries[0]["audio_filepath"],
                     long=long_wav) for a in CLI_MODES[mode]]
    if mode.startswith("manifest"):
        args = ["--manifest", str(manifest)] + args
    result = predict_main(["--model", str(ckpt), "--device", "cpu"] + args)
    printed = capsys.readouterr().out
    if mode.startswith("manifest"):
        assert result["manifest"]["n_utterances"] == 3 and str(result["manifest"]) in printed
    if mode == "manifest_csv_confidence":
        rows = list(csv.reader(open(tmp_path / "r.csv", newline="", encoding="utf-8")))
        assert len(rows) == 4 and all(np.isfinite(float(r[4])) for r in rows[1:])
    if mode == "audio_long":
        assert result["audio"] == translator.translate_long(str(long_wav), 2.0, 0.25)
    if mode == "audio_stream":
        assert result["audio"] == translator.translate_long(str(long_wav), 2.0, 0.25)
        assert printed.count("s] ") >= 1
    if mode.startswith("audio"):
        assert result["audio"] in printed
    with pytest.raises(SystemExit):
        predict_main(["--model", str(ckpt), "--device", "cpu"])
