"""Data parallelism over CUDA cards (``conan_tpu/parallel``); see ``dist``."""

from conan_tpu_torch.parallel.dist import (World, all_reduce_grads,  # noqa: F401
                                           broadcast_state, init_distributed, local_rows,
                                           pad_batch_to_multiple, scope)
