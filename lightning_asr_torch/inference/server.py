"""HTTP transcription server (port of ``lightning_asr_tpu/inference/server.py``):
model loaded once at startup, ``POST /`` with a multipart form file field
``audio`` returns the transcription as text/plain.  400 for a missing field,
malformed audio or a wrong sample rate; 503 when the request queue is full.

A dynamic batcher collects concurrent requests for up to ``max_wait_ms`` or
``max_batch`` and transcribes them as one device batch.  Its assembler
thread decodes each batch's request bodies in one pass of the native WAV
parser (``native.parse_wav_batch_mem``: a C++ thread pool, without the
interpreter lock).  Serving uses the stdlib ``http.server``, or the
reference's Flask app (``create_flask_app``, one request at a time): ``serve``
picks Flask by itself, as the JAX package's does, when ``flask`` imports,
batching is off and no warmup is asked (``--flask`` forces it).  Nothing
here installs Flask.

Run on the GPU with ``python -m lightning_asr_torch.inference.server --model <dir>``.
"""

from __future__ import annotations

import io
import logging
import os
import queue
import re
import threading
import time
from concurrent.futures import Future
from pathlib import Path
from typing import List, Optional, Sequence

from ..native import get_lib, parse_wav_batch_mem
from .predict import AsrTranslator

logger = logging.getLogger(__name__)


class ServerOverloaded(RuntimeError):
    """Request queue full — shed with 503 instead of queueing unboundedly."""


class DynamicBatcher:
    """Collect concurrent transcription requests into device batches.

    Two stages, each in a daemon thread: the assembler collects raw request
    bytes into a batch and decodes it in one native pass; the device loop
    submits batch N+1 before resolving batch N, so the copy of N's result
    overlaps N+1's compute.  The request queue is bounded (``max_queue``);
    when it is full, ``translate`` raises ``ServerOverloaded``.  A request
    longer than ``max_seconds`` is cut to that many seconds; the native
    parser decodes a batch's bodies on ``decode_threads`` threads."""

    def __init__(self, translator: AsrTranslator, max_batch: int = 8,
                 max_wait_ms: float = 20.0, max_queue: int = 64,
                 max_seconds: float = 60.0, decode_threads: int = 4):
        self.translator = translator
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1000.0
        self.max_samples = int(max_seconds * translator.frontend.sample_rate)
        self.decode_threads = decode_threads
        get_lib()  # build the parser now: a failed build raises here, not in a request
        self._queue: "queue.Queue" = queue.Queue(maxsize=max_queue)
        self._ready: "queue.Queue" = queue.Queue(maxsize=1)
        threading.Thread(target=self._assemble, daemon=True).start()
        threading.Thread(target=self._device_loop, daemon=True).start()

    def translate(self, audio) -> str:
        if isinstance(audio, bytes):
            blob = audio
        elif isinstance(audio, io.BytesIO):
            blob = audio.getvalue()
        elif hasattr(audio, "read"):
            blob = audio.read()
        else:  # path-like
            blob = Path(audio).read_bytes()
        fut: "Future[str]" = Future()
        try:
            self._queue.put_nowait((blob, fut))
        except queue.Full:
            raise ServerOverloaded(f"request queue full ({self._queue.maxsize}); retry later")
        return fut.result()

    def _decode(self, blobs: List[bytes]) -> List:
        """bytes -> 1-D float32 waveform per row, or the row's ValueError
        (malformed / wrong sample rate), in one native pass."""
        sr_expect = self.translator.frontend.sample_rate
        waves, lens, srs = parse_wav_batch_mem(blobs, self.max_samples, self.decode_threads)
        out: List = []
        for wave, n, sr in zip(waves, lens, srs):
            if n < 0:
                out.append(ValueError("malformed or unsupported wav body"))
            elif sr != sr_expect:
                out.append(ValueError(f"expected {sr_expect} Hz audio, got {int(sr)}"))
            else:
                out.append(wave[:n])
        return out

    def _assemble(self) -> None:
        while True:
            batch: List = [self._queue.get()]
            deadline = time.monotonic() + self.max_wait
            while len(batch) < self.max_batch:
                timeout = deadline - time.monotonic()
                if timeout <= 0:
                    break
                try:
                    batch.append(self._queue.get(timeout=timeout))
                except queue.Empty:
                    break
            decoded = self._decode([b for b, _ in batch])
            good = []
            for w, (_, f) in zip(decoded, batch):
                if isinstance(w, Exception):
                    f.set_exception(w)
                else:
                    good.append((w, f))
            if good:
                self._ready.put(good)

    def _device_loop(self) -> None:
        pending = None  # (rows, resolver) for the batch in flight
        while True:
            if pending is None:
                good = self._ready.get()
            else:
                try:
                    # wait one batching window for batch N+1 before blocking
                    # on batch N's result
                    good = self._ready.get(timeout=self.max_wait)
                except queue.Empty:
                    self._resolve_batch(pending)
                    pending = None
                    continue
            try:
                resolver = self.translator.transcribe_batch_submit([w for w, _ in good])
            except Exception as e:  # the device loop must keep serving
                logger.exception("batch submit failed")
                for _, f in good:
                    f.set_exception(e)
                resolver = None
            if pending is not None:
                self._resolve_batch(pending)
            pending = (good, resolver) if resolver is not None else None

    @staticmethod
    def _resolve_batch(pending) -> None:
        good, resolver = pending
        try:
            texts = resolver()
        except Exception as e:  # the device loop must keep serving
            logger.exception("batch resolve failed")
            for _, f in good:
                f.set_exception(e)
            return
        for (_, f), text in zip(good, texts):
            f.set_result(text)


def _parse_multipart_file(body: bytes, content_type: str, field: str = "audio") -> Optional[bytes]:
    """Minimal multipart/form-data parser for one file field."""
    m = re.search(r'boundary="?([^";]+)"?', content_type)
    if not m:
        return None
    boundary = b"--" + m.group(1).encode()
    for part in body.split(boundary):
        if b"Content-Disposition" not in part:
            continue
        header_end = part.find(b"\r\n\r\n")
        if header_end < 0:
            continue
        headers = part[:header_end].decode("utf-8", "replace")
        if f'name="{field}"' not in headers:
            continue
        payload = part[header_end + 4 :]
        if payload.endswith(b"\r\n"):
            payload = payload[:-2]
        return payload
    return None


def resolve_batching(batching, min_cores: int = 4) -> bool:
    """Serving mode for ``batching``: 'on'/True, 'off'/False/None, or 'auto'
    — batched when the host has at least ``min_cores`` cores, since the
    batcher's threads compete with the HTTP threads for the host's cores."""
    if batching == "auto":
        cores = os.cpu_count() or 1
        on = cores >= min_cores
        logger.info("batching=auto: %d host cores -> %s mode", cores, "batched" if on else "serial")
        return on
    if batching in ("on", True):
        return True
    if batching in ("off", False, None):
        return False
    raise ValueError(f"batching must be 'auto'|'on'|'off'|bool, got {batching!r}")


def make_stdlib_server(translator, host: str = "127.0.0.1", port: int = 0,
                       batching: bool = False, max_batch: int = 8,
                       max_wait_ms: float = 20.0,
                       warmup_seconds: Optional[Sequence[float]] = None,
                       max_queue: int = 64):
    """stdlib HTTP server exposing the POST / contract.  ``batching=True``
    wraps the translator in a DynamicBatcher; ``warmup_seconds`` runs the
    (batch, bucket) ladder for those durations once at startup."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Server(ThreadingHTTPServer):
        # the default listen backlog of 5 resets connections of a burst
        request_queue_size = 128
        daemon_threads = True

    if warmup_seconds:
        translator.warmup(warmup_seconds, max_batch if batching else 1)
    if batching:
        translator = DynamicBatcher(translator, max_batch, max_wait_ms, max_queue=max_queue)

    class Handler(BaseHTTPRequestHandler):
        def do_POST(self):
            try:
                length = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(length)
                payload = _parse_multipart_file(body, self.headers.get("Content-Type", ""), "audio")
                if payload is None:
                    self.send_error(400, "missing form file field 'audio'")
                    return
                data = translator.translate(io.BytesIO(payload)).encode("utf-8")
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; charset=utf-8")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
            except ServerOverloaded as e:
                self.send_error(503, str(e))
            except ValueError as e:  # malformed audio / wrong sample rate
                self.send_error(400, str(e))
            except Exception as e:  # the server must keep answering
                logger.exception("transcription failed")
                self.send_error(500, str(e))

        def log_message(self, fmt, *args):
            logger.info("server: " + fmt, *args)

    return Server((host, port), Handler)


def create_flask_app(translator: AsrTranslator):
    """The reference's Flask app: ``POST /`` reads the form file ``audio``
    and returns ``translator.translate`` of it."""
    from flask import Flask, request

    app = Flask(__name__)

    @app.route("/", methods=["POST"])
    def transcribe():
        data = io.BytesIO()
        request.files["audio"].save(data)
        data.seek(0)
        return translator.translate(data)

    return app


def serve(model_path: str, host: str = "0.0.0.0", port: int = 5000, device=None, batching="auto",
          max_batch: int = 8, max_wait_ms: float = 20.0,
          warmup_seconds: Optional[Sequence[float]] = None, max_queue: int = 64,
          conv_kernel: Optional[str] = None, use_flask: Optional[bool] = None):
    """Load the checkpoint (on ``cuda`` unless ``device`` says otherwise;
    ``conv_kernel`` as ``AsrTranslator`` takes it) and serve until
    interrupted.  ``use_flask`` None: the Flask app when ``flask`` imports,
    batching is off and no warmup is asked, else the stdlib server; True
    forces the Flask app."""
    batching = resolve_batching(batching)
    translator = AsrTranslator(model_path, device=device, conv_kernel=conv_kernel)
    if use_flask is None and not batching and not warmup_seconds:
        try:
            import flask  # noqa: F401

            use_flask = True
        except ImportError:
            use_flask = False
    if use_flask:
        create_flask_app(translator).run(host=host, port=port)
        return
    server = make_stdlib_server(translator, host, port, batching=batching, max_batch=max_batch,
                                max_wait_ms=max_wait_ms, warmup_seconds=warmup_seconds,
                                max_queue=max_queue)
    try:
        server.serve_forever()
    finally:
        server.server_close()


def _main() -> None:
    import argparse

    ap = argparse.ArgumentParser(description="Serve a lightning_asr_torch checkpoint over HTTP.")
    ap.add_argument("--model", required=True, help="port checkpoint dir (state.pt + metadata.json)")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=5000)
    ap.add_argument("--batching", choices=["auto", "on", "off"], default="auto",
                    help="collect concurrent requests into device batches "
                         "('auto': on hosts with >= 4 cores)")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-wait-ms", type=float, default=20.0)
    ap.add_argument("--max-queue", type=int, default=64,
                    help="bounded request queue; overflow sheds with 503")
    ap.add_argument("--warmup-seconds", type=float, nargs="*", default=None,
                    help="run the (batch, bucket) ladder for these request "
                         "durations at startup")
    ap.add_argument("--conv-kernel", choices=["sepconv", "dw_wgrad"], default=None,
                    help="run the blocks' separable convs through the fused kernels "
                         "(default: the F.conv1d pair)")
    ap.add_argument("--flask", action="store_true", default=None,
                    help="force the Flask app (default: it when flask imports and no "
                         "batching or warmup is asked)")
    args = ap.parse_args()
    logging.basicConfig(level=logging.INFO)
    serve(args.model, host=args.host, port=args.port, device=args.device,
          batching=args.batching, max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
          warmup_seconds=args.warmup_seconds, max_queue=args.max_queue,
          conv_kernel=args.conv_kernel, use_flask=args.flask)


if __name__ == "__main__":
    _main()
