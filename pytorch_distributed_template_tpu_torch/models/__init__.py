"""Model families of the port; importing this package registers them
in ``config.MODELS``."""
from . import llama  # noqa: F401  (registers Llama, Mistral, TinyLlama)
from . import transformer  # noqa: F401  (registers GPT2, TinyLM)
from . import moe  # noqa: F401  (registers MoeLM, TinyMoeLM)
from . import lenet  # noqa: F401  (registers LeNet, MnistModel)
from . import resnet  # noqa: F401  (registers ResNet18/34/50/101/152)
from . import vit  # noqa: F401  (registers ViT)
from . import bert  # noqa: F401  (registers BertMLM, BertClassifier)
from . import pipelined  # noqa: F401  (registers GPT2Pipelined, PipelinedLM,
#                                  LlamaPipelined, TinyPipeLM)
