"""llava_align_tpu_torch — the PyTorch/CUDA port of llava_align_tpu.

The JAX package (llava_align_tpu/) is the reference; this package mirrors its
module paths and function names so each function has a findable counterpart.
It imports torch and never jax. Its hot ops are CUDA C++ kernels written for
Hopper (sm_90a) under csrc/, built with nvcc at first use
(ops/_kernels.py); each kernel's wrapper runs a plain PyTorch version of the
same math when its input tensor lies on the CPU.

Ported so far: the LLaVA-v1.5 int8 dual-branch VDD decode path —
DecodeEngine.generate / submit_generate / collect_generate.
"""

__version__ = "0.1.0"

from llava_align_tpu_torch import constants  # noqa: F401
from llava_align_tpu_torch.config import (  # noqa: F401
    ClipVisionConfig,
    GenerationConfig,
    LlamaConfig,
    LlavaConfig,
)
