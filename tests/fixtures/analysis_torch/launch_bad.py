"""Fixture: shapes the CUDA kernels refuse (5 findings expected)."""

LAUNCH_SHAPE_PROBES = [
    ("transform_quant", 100, 64, 32, "up", "float32"),        # K not a multiple of group
    ("transform_quant", 8192, 2048, 8192, "down", "float32"),  # a group's tile past shared memory
    ("transform_quant", 32, 4194304, 32, "up", "float32"),     # no cluster holds the band
    ("group_quant", 4096, 20_000_000, 32),                     # N past the grid's columns
    ("decode", 66),                                            # head dim not a multiple of 4
]
