"""Generation engine: KV-cached decoding and the request-level service."""
