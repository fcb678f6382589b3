"""Native (C++) host components, bound with ctypes.

The binned-SAH BVH builder (``bvh_builder.cpp``, the JAX package's source
unchanged), compiled with the system C++ compiler at first use into the
package's git-ignored ``_build/``.  ``ops/bvh.build_bvh`` takes the numpy
builder, which gives the same arrays, when this one is unavailable.
"""

from .build import NativeUnavailable, native_build_bvh  # noqa: F401
