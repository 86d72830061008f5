"""Trace one production cell on the 512-GPU multi-pod mesh on the meta
device and print its memory and H100 roofline analysis (no card touched).

The port's counterpart of examples/multipod_dryrun.py (which lowers and
compiles the cell with XLA):

  PYTHONPATH=src python examples_torch/multipod_dryrun.py [arch] [shape]
"""

import json
import sys

if __name__ == "__main__":
    from repro_torch.launch import dryrun

    arch = sys.argv[1] if len(sys.argv) > 1 else "qwen3_1p7b"
    shape = sys.argv[2] if len(sys.argv) > 2 else "decode_32k"
    rec = dryrun.run_cell(arch, shape, multi_pod=True)
    print(json.dumps(rec, indent=2))
