"""Native (C++) host components, built with ``g++`` at first use and loaded
with ctypes; a failed build raises."""

from .loader import fast_load_safetensors, native_available

__all__ = ["fast_load_safetensors", "native_available"]
