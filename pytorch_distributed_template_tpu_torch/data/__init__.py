"""Data: the byte-level BPE tokenizer the serving path decodes with, and
the LM training loaders (importing ``data.datasets`` registers them in
``config.LOADERS``)."""
