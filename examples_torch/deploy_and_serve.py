"""The full LUT-NN lifecycle in one script, in PyTorch:

  dense pretrain -> k-means convert -> soft-PQ fine-tune -> int8 deploy
  -> LUTArtifact on disk -> serve the DEPLOYED tables from the artifact.

The port's counterpart of examples/deploy_and_serve.py, with its sizes and
steps: the train half (`repro_torch.launch.train --lut`, the resumable
`Recipe`) hands off to the serve half (`repro_torch.launch.serve
--artifact`) through the artifact directory, on the card unless `--device
cpu` asks for the CPU. Inspect the artifact with `python -m
repro_torch.serving.artifact <dir>`.

  PYTHONPATH=src python examples_torch/deploy_and_serve.py [--device cpu]
"""

import argparse
import os
import tempfile

from repro_torch.launch.serve import main as serve_main
from repro_torch.launch.train import main as train_main

if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--artifact-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_torch_example_artifact"))
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as ckpt_dir:
        train_main([
            "--arch", "qwen3_1p7b", "--d-model", "64", "--layers", "2",
            "--vocab", "128", "--seq", "32", "--batch", "8", "--steps", "20",
            "--lut", "--ckpt-dir", ckpt_dir, "--artifact-dir", args.artifact_dir,
            "--device", args.device,
        ])
    serve_main([
        "--artifact", args.artifact_dir, "--requests", "8", "--slots", "4",
        "--max-seq", "64", "--prefill-chunk", "8", "--max-tokens", "12",
        "--device", args.device,
    ])
