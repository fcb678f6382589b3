"""Multi-device rendering: device meshes (``mesh.py``), the (tile × sample)
split of each chunk call over a mesh (``sharding.py``), each entry in a
worker process of its own (``workers.py``), and progressive accumulation
with checkpoint/resume (``progressive.py``)."""
