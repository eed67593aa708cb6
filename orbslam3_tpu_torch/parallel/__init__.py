"""The port's distributed layer (the JAX package's `parallel/`): the sharded
bundle adjustment (`ba_sharded.py`), the sharded keyframe-database query
(`kfdb_sharded.py`), the context the pipeline dispatches through
(`context.py`), the counted collectives (`comm.py`) and the multi-process
launcher (`launch.py`), over `torch.distributed` process groups: one process
per rank where the JAX package runs `shard_map` over a device mesh."""
