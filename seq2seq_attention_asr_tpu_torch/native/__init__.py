"""The port's native C++ helpers on the host: edit distance, batch
packing and FLAC decoding (the JAX package's native/ sources, with the
same ctypes ABI), each built by g++ at first use into the package's
``_build/`` (``build.py``). A failed build raises; the numpy versions
stay as named functions for the tests and for explicit callers."""
