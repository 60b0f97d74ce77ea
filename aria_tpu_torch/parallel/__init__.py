"""Serving over several ranks (counterpart of aria_tpu/parallel/): the
process group, the mesh over it, and the KV cache sharded by position and
by head."""
