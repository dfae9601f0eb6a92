"""Entry points of the port: the measured serving engine over the tiered
paged-KV cache (``launch.serve``)."""
