"""Data: the byte-level BPE tokenizer the serving path decodes with, and
the training loaders, LM and image (importing ``data.datasets`` registers
them in ``config.LOADERS``; ``data.sharded`` holds the uint8 image
shards)."""
