from llava_align_tpu_torch.train.trainer import (  # noqa: F401
    TrainState,
    make_optimizer,
    make_train_step,
    multimodal_lm_loss,
)
