"""Audio watermarking (SilentCipher-equivalent), in PyTorch: the STFT, the
gated-conv CNNs and the message protocol of the JAX package's
``watermarking``, with the public CSM key."""

from csm_torch.watermarking.watermarker import (
    CSM_1B_GH_WATERMARK,
    Watermarker,
    check_audio_from_file,
    load_watermarker,
    verify,
    watermark,
)

__all__ = [
    "CSM_1B_GH_WATERMARK",
    "Watermarker",
    "check_audio_from_file",
    "load_watermarker",
    "verify",
    "watermark",
]
