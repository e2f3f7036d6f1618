"""Data parallelism: the process group (``distributed``) and the row layout
of a global batch over its ranks (``mesh``).  Tensor parallelism
(``lightning_asr_tpu/parallel/tp.py``) is not ported: ``train.tp > 1``
raises."""
