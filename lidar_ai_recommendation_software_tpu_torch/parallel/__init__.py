"""Sharded analytics and training over ``torch.distributed`` ranks: the
counterpart of the JAX package's ``parallel/`` (``mesh``, ``spatial``,
``cluster``, ``trainer``)."""
