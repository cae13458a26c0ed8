"""Parallelism over the device mesh: Megatron tensor parallelism of the
transformer blocks (``parallel.tensor``) and spatially sharded
full-resolution inference (``parallel.tiled``)."""
