"""Serving example: batched requests through the continuous-batching engine
with int8 LUT tables (the paper's deployment mode), chunked prefill, and
nucleus sampling, in PyTorch.

The port's counterpart of examples/serve_batched.py: qwen3_1p7b from random
init, reduced as the launcher reduces it (`configs.reduce_arch`), on the
card unless `--device cpu` asks for the CPU. Further flags go to
`repro_torch.launch.serve`.

  PYTHONPATH=src python examples_torch/serve_batched.py [--device cpu] [launcher flags]
"""

import sys

from repro_torch.launch.serve import main as serve_main

if __name__ == "__main__":
    serve_main([
        "--arch", "qwen3_1p7b", "--requests", "8", "--slots", "4",
        "--prefill-chunk", "8", "--temperature", "0.8", "--top-p", "0.95",
        "--seed", "0", *sys.argv[1:],
    ])
