"""Progressive accumulation with checkpoint/resume (``progressive.py``).

The JAX package's ``parallel/`` also holds the device mesh and sharded
rendering (``mesh.py``, ``sharding.py``); the port has one card for now.
"""
