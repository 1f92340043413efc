"""csm-torch: the PyTorch/CUDA port of csm-tpu for NVIDIA Hopper.

Text-to-speech with the CSM dual transformer (Llama-3.2-1B backbone + 100M
audio decoder over interleaved text and Mimi RVQ tokens) and the Mimi codec,
with the attention kernels and the grouped-int4 matmul written by hand in CUDA
C++ for sm_90a (``csm_torch/csrc``); int8 and int4 weights and an int8 KV cache
for the quantized modes.  It imports neither JAX nor the JAX package; the tests
hold it against that package on the CPU.
"""

__version__ = "0.1.0"

from csm_torch.generator import Generator, PackedContext, Segment, load_csm, load_csm_1b
from csm_torch.models.config import ModelArgs, TransformerConfig, csm_1b_args

__all__ = [
    "Generator",
    "PackedContext",
    "Segment",
    "load_csm",
    "load_csm_1b",
    "ModelArgs",
    "TransformerConfig",
    "csm_1b_args",
    "__version__",
]
