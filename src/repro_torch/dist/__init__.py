"""Tensor parallelism of the port: roles, the active context and the two
collectives its kernel rules need (``sharding.py``)."""
