"""Native (C++) runtime components, bound via ctypes.

The image has no pybind11, so each component ships a flat C ABI compiled
on first use (g++ -O2 -shared) and cached in ray_tpu_torch/_build/native/. See
store_binding.py for the object-store arena.
"""
