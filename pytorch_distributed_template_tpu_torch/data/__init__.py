"""Text data: the byte-level BPE tokenizer the serving path decodes with."""
