"""Multi-device rendering: device meshes (``mesh.py``), the (tile × sample)
split of each chunk call over a mesh (``sharding.py``), and progressive
accumulation with checkpoint/resume (``progressive.py``)."""
