"""The H100 benchmark of lightning_asr_torch (see README.md)."""
