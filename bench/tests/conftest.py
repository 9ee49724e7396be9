"""Tiny frame sizes, for ``_bench_tiny.tiny_root``, of the configurations
added to ``BENCHMARK.json`` after its own table was written."""
import _bench_tiny

# Tiles of 32² (the tiny layout's 2 x 2 grid) take an injected source's
# 15-pixel stamp with its margin.
_bench_tiny.SIZES.setdefault("stream_10k", 64)
