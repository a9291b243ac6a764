from llava_align_tpu_torch.framework.registry import registry  # noqa: F401

# Importing the package registers the built-in tasks, models and dataset
# builders (as the JAX package's framework/__init__.py does, and the
# reference's lavis/__init__.py): a user reaching them only through
# `registry.get_*_class(...)` must not get None.
from llava_align_tpu_torch.framework import tasks as _tasks  # noqa: E402,F401
from llava_align_tpu_torch.framework import model_zoo as _model_zoo  # noqa: E402,F401
from llava_align_tpu_torch.framework import datasets as _datasets  # noqa: E402,F401
