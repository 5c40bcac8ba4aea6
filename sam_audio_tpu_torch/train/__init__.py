"""Training on the port: flow matching, LoRA, span prediction, sharded
records, checkpoints, export and the command line
(`python -m sam_audio_tpu_torch.train`); counterpart of sam_audio_tpu/train/."""

from sam_audio_tpu_torch.train.checkpoints import TrainCheckpointManager  # noqa: F401
from sam_audio_tpu_torch.train.flow_matching import (  # noqa: F401
    Trainer,
    TrainState,
    flow_matching_loss,
    make_train_step,
)
from sam_audio_tpu_torch.train.lora import (  # noqa: F401
    LoRATrainer,
    lora_init,
    lora_merge,
    merge_lora_checkpoint,
)
from sam_audio_tpu_torch.train.records import (  # noqa: F401
    ShardedRecordDataset,
    ShardWriter,
    iter_batches,
    write_shards,
)
