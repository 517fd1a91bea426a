"""Format layer: pure NumPy/Python Snappy wire formats — constants, varint,
CRC32C tables, and the scalar oracle codec used to check the kernels."""
