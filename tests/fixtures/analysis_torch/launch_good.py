"""Fixture: shapes every kernel takes (0 findings expected)."""

LAUNCH_SHAPE_PROBES = [
    ("transform_quant", 2048, 8192, 32, "up", "float32"),
    ("transform_quant", 9728, 2560, 32, "down", "bfloat16"),
    ("group_quant", 92160, 9728, 32),
    ("decode", 128),
]
