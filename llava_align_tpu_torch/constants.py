"""Framework-wide constants.

Parity: reference experiments/llava/constants.py:7-12. A copy of
llava_align_tpu/constants.py, kept so the port never imports the JAX package.
"""

CONTROLLER_HEART_BEAT_EXPIRATION = 30
WORKER_HEART_BEAT_INTERVAL = 15

LOGDIR = "."

# Special token bookkeeping. IMAGE_TOKEN_INDEX is an out-of-vocab sentinel id
# spliced into input_ids wherever the literal "<image>" appeared in the prompt;
# the prefill replaces each sentinel position with the projected vision-tower
# patch embeddings (576 for CLIP ViT-L/14-336).
IGNORE_INDEX = -100
IMAGE_TOKEN_INDEX = -200
DEFAULT_IMAGE_TOKEN = "<image>"
DEFAULT_IMAGE_PATCH_TOKEN = "<im_patch>"
DEFAULT_IM_START_TOKEN = "<im_start>"
DEFAULT_IM_END_TOKEN = "<im_end>"
