"""Model families of the port; importing this package registers them
in ``config.MODELS``."""
from . import llama  # noqa: F401  (registers Llama, Mistral, TinyLlama)
from . import transformer  # noqa: F401  (registers GPT2, TinyLM)
