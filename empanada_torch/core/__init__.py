"""Sparse host library (numpy): boxes, RLE algebra, range algebra and
run-based connected components — the parts the stack-mode path uses."""
