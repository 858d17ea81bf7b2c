"""Engines: KV-cached decoding and the request-level services (serving),
and the train/eval steps and the trainer (training)."""
