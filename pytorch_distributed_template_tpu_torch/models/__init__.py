"""Model families of the port; importing this package registers them
in ``config.MODELS``."""
from . import llama  # noqa: F401  (registers Llama, Mistral, TinyLlama)
from . import transformer  # noqa: F401  (registers GPT2, TinyLM)
from . import moe  # noqa: F401  (registers MoeLM, TinyMoeLM)
from . import lenet  # noqa: F401  (registers LeNet, MnistModel)
