"""Data parallelism over a ``torch.distributed`` process group (port of
``dfine_tpu/parallel``)."""

from .dp import (AXIS, all_reduce_flat_, all_reduce_grads_, all_reduce_mean_,  # noqa: F401
                 barrier, broadcast_scalar, gather_objects, gather_predictions, init_multihost,
                 is_main_process, make_dp_train_step, process_count, process_index,
                 rank_generator, replicate, shard_batch, shutdown, unreplicate)
