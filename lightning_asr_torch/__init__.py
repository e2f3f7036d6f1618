"""lightning_asr_torch — the PyTorch / CUDA port of ``lightning_asr_tpu``.

The module layout mirrors the JAX package so that each port sits at the
same path as its counterpart.  The JAX package is the reference the port is
tested against; this package imports neither it nor JAX.

Layering (bottom → top):
  csrc/      hand-written CUDA C++ kernels for Hopper (sm_90a)
  ops/       mel frontend (+ fused log-mel and extension kernels), LSTM
             recurrence and its backward, also batch-stacked, at hidden 40
             and 128 (+ kernels), CTC loss (+ alpha / beta kernels),
             separable and depthwise convs (+ kernels), crops, SpecAugment
             and the other augmentations, length masks
  data/      vocabulary, WAV decode (the native threaded loader), manifests,
             bucketed batches, the RAM and mmap wave caches, datamodule
             (with the SSL pseudo-label pool)
  models/    the four QuartzNet encoders + CTC head or LSTM head
             (nn.Modules, eval and train), the SSL feature mapping, the
             dual-stream model, activations, parameter and FLOP counts
  optim/     NovoGrad (also with a runtime lr), cosine warmup restarts and
             the LR-policy zoo, ReduceLROnPlateau, gradient clipping
  metrics/   WER / CER
  decoding/  greedy CTC collapse on the device, LM-free prefix beam search
             as batched tensor ops, the native LM beam search with hot words
  ssl_codec/ CTC confidence scores, the wav2vec2 extractor wrapper and
             feature pickles, the SSL and dual datamodules, the trainable
             wav2vec2 feature encoder and the retrain model
  training/  train and eval steps (also the dual and raw-SSL ones), the
             trainer and the SSL trainers, checkpoints of train state
             (state.pt + train_state.pt + metadata.json), callbacks,
             loggers, profiler
  utils/     device selection, config (own YAML reader), logging, the
             flax <-> torch weight and optimizer-state bridge
  native.py  the repository's C++ decoder, Levenshtein distance and WAV
             parser and loader (native/ctc_decoder), built by g++ at first
             use
  inference/ AsrTranslator (long audio, manifest evaluation), streaming,
             HTTP server
  train.py   the training CLI (python -m lightning_asr_torch.train)
  train_ssl.py, train_ssl_double.py
             the SSL training CLIs
  predict.py the inference CLI (python -m lightning_asr_torch.predict)

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
On a CPU tensor every kernel wrapper runs its plain PyTorch version; on a
CUDA tensor it launches the kernel or raises.
"""

__version__ = "0.1.0"
