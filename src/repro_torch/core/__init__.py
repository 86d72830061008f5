"""PQ math, table quantization, the LUT linear layer and the replacement plan."""
