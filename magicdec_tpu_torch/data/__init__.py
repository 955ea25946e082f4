"""The port's data layer: tokenized long-context corpora
(``data/datasets.py``) and the RULER task generators (``data/ruler``),
copies of ``magicdec_tpu/data`` (numpy and the standard library only)."""
