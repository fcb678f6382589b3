"""Seconds of the scene's compile in set-up (``renderer.compiled(scene)``:
the tables, the atlas, on the mesh the BVH build), by the host clock."""


def read(run):
    return run.compile_s
