"""PyTorch/CUDA port of sam_audio_tpu (text-prompted separation).

Plain tensor code is PyTorch; the three TPU (Pallas) kernels of the path are
hand-written CUDA kernels for Hopper (sm_90a) in `csrc/`, built with nvcc at
first use (ops/_build.py). Entry points run on the card by default:

    from sam_audio_tpu_torch import SAMAudio, SAMAudioProcessor
    model = SAMAudio.from_pretrained(snapshot_dir)          # device="cuda"
    processor = SAMAudioProcessor.from_pretrained(snapshot_dir)
    result = model.separate(processor(descriptions=[...], audios=[...]))

The package imports neither jax nor the JAX package.
"""

from sam_audio_tpu_torch.config import SAMAudioConfig, tiny_test_config
from sam_audio_tpu_torch.models.sam_audio import SAMAudio, SeparationResult
from sam_audio_tpu_torch.processor import Batch, SAMAudioProcessor

__all__ = ["SAMAudio", "SAMAudioConfig", "SAMAudioProcessor", "Batch",
           "SeparationResult", "tiny_test_config"]
