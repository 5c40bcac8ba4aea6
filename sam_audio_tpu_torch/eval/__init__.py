"""The eval harness of the port (counterpart of sam_audio_tpu/eval):
settings, datasets, metrics and `run_eval` over torch.distributed."""

from sam_audio_tpu_torch.eval.settings import SETTINGS, make_dataset  # noqa: F401
