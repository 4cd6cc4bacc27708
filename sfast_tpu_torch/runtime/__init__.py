"""Build, load and count the hand-written CUDA kernels; capture CUDA
graphs per input signature (``tracing``, ``signature``,
``executable_cache``, ``shape_bucket``)."""
