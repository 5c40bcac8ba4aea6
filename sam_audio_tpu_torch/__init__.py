"""PyTorch/CUDA port of sam_audio_tpu: separation prompted by text, spans
(given or predicted, models/span_predictor.py) or video, k-candidate
reranking (CLAP, the judge, ImageBind, sound activity, their ensemble),
streaming of long clips, the int8 / int4 serving modes, and serving
(serving.py offline, server.py over HTTP, separate_cli.py).

Plain tensor code is PyTorch; the four TPU (Pallas) kernels of the JAX package are
hand-written CUDA kernels for Hopper (sm_90a) in `csrc/`, built with nvcc at
first use (ops/_build.py). Entry points run on the card by default:

    from sam_audio_tpu_torch import SAMAudio, SAMAudioProcessor
    model = SAMAudio.from_pretrained(snapshot_dir)          # device="cuda"
    processor = SAMAudioProcessor.from_pretrained(snapshot_dir)
    result = model.separate(processor(descriptions=[...], audios=[...]))

The package imports neither jax nor the JAX package.
"""

from sam_audio_tpu_torch.config import (
    DACVAEConfig,
    SAMAudioConfig,
    SAMAudioJudgeConfig,
    T5EncoderConfig,
    TransformerConfig,
    parse_ranker_config,
    tiny_test_config,
)
from sam_audio_tpu_torch.models.sam_audio import SAMAudio, SeparationResult
from sam_audio_tpu_torch.processor import Batch, SAMAudioJudgeProcessor, SAMAudioProcessor

__all__ = ["SAMAudio", "SAMAudioConfig", "SAMAudioProcessor", "Batch",
           "SeparationResult", "tiny_test_config", "DACVAEConfig", "SAMAudioJudgeConfig",
           "T5EncoderConfig", "TransformerConfig", "parse_ranker_config",
           "SAMAudioJudgeProcessor", "SAMAudioJudgeModel", "SeparationPipeline",
           "SeparationRequest", "SeparationResponse", "ContinuousBatcher",
           "SeparationServer"]


def __getattr__(name):
    # lazy, as in the JAX package: the judge pulls in its tower stack, and the
    # serving entry points their threads and HTTP modules
    if name == "SAMAudioJudgeModel":
        from sam_audio_tpu_torch.models.judge import SAMAudioJudgeModel

        return SAMAudioJudgeModel
    if name in ("SeparationPipeline", "SeparationRequest", "SeparationResponse"):
        from sam_audio_tpu_torch import serving

        return getattr(serving, name)
    if name in ("ContinuousBatcher", "SeparationServer"):
        from sam_audio_tpu_torch import server

        return getattr(server, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
