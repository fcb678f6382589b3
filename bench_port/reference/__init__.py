"""The benchmark's plain reference: the path tracer's semantics in plain
torch (``pathtrace.py``), its RNG (``rng.py``) and the scene tables it works
out from a configuration's description (``tables.py``).  Imports nothing of
the program."""
