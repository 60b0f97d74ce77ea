"""Serving and training over several ranks (counterpart of
aria_tpu/parallel/): the process group and its collectives, the mesh over
it and the parameters' spec trees, the KV cache sharded by position and by
head, expert parallelism and sharded training."""
