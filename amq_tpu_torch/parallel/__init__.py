"""Parallelism on ``torch.distributed``: one process per shard (SPMD),
collectives in place of the JAX package's ``psum`` / ``all_gather`` /
``ppermute``."""
