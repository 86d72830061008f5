"""End to end: the LUT-NN training lifecycle as a first-class
`Recipe` over a HETEROGENEOUS per-site LUTPlan, in PyTorch:

  * MLP sites:       K=16 tables
  * attention sites: K=8 tables (cheaper encode, the paper's K ablation)
  * first and last layers: kept dense (the paper's accuracy-critical ends)

and a custom stage list — dense pretrain, k-means centroid init, soft-PQ
fine-tune *with dense-teacher distillation* (KL vs the frozen pretrained
model), int8 deploy, and an eval gate that fails the run if the deployed
model regresses more than 1.0 nats past the teacher. The port's
counterpart of examples/train_softpq_pipeline.py, with its sizes and steps,
on the card unless `--device cpu` asks for the CPU:

  PYTHONPATH=src python examples_torch/train_softpq_pipeline.py [--steps 200] [--device cpu]

The run is resumable: kill it at any point and re-run with the same
--ckpt-dir — the pipeline manifest (<ckpt_dir>/recipe_run.json) resumes at
the recorded stage and checkpoint step. The emitted artifact serves with
`python -m repro_torch.launch.serve --artifact <dir>` and introspects with
`python -m repro_torch.serving.artifact <dir>`. For the plain flag-built
default recipe use `python -m repro_torch.launch.train --lut`.
"""

import argparse
import dataclasses
import os
import tempfile

from repro_torch.configs import LUTPlan, effective_plan, get_arch, reduce_arch, rule
from repro_torch.core.amm import Mode
from repro_torch.data import MarkovLM
from repro_torch.train.recipe import (
    CentroidInit,
    Deploy,
    DensePretrain,
    Eval,
    OptimSpec,
    Recipe,
    SoftPQ,
)
from repro_torch.train.train_step import DistillSpec


def main() -> None:
    tmp = tempfile.gettempdir()
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="qwen3_1p7b")
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--ckpt-dir", default=os.path.join(tmp, "repro_torch_plan_run"))
    ap.add_argument("--artifact-dir", default=os.path.join(tmp, "repro_torch_plan_artifact"))
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args()

    plan = LUTPlan(rules=(
        rule(kinds=("mlp/*",), k=16),
        rule(kinds=("attn/*",), k=8),
        rule(layers="set", layer_set=(0, args.layers - 1), replace=False),
    ))
    arch = reduce_arch(
        get_arch(args.arch),
        d_model=256, n_layers=args.layers, vocab=512, d_ff=512,
    )
    arch = dataclasses.replace(arch, lut_plan=plan)
    print(f"replacement plan: {effective_plan(arch).describe()}")

    recipe = Recipe(stages=(
        DensePretrain(
            steps=args.steps,
            optim=OptimSpec(lr=3e-3, schedule="cosine", warmup_steps=20),
            ckpt_every=max(50, args.steps // 4), log_every=50,
        ),
        CentroidInit(sample_batches=2, sample_start=10_000),
        SoftPQ(
            steps=args.steps,
            optim=OptimSpec(lr=1e-3, schedule="cosine", warmup_steps=10,
                            rules="distill"),
            distill=DistillSpec(weight=0.5, temperature=2.0),
            ckpt_every=max(50, args.steps // 4), log_every=50,
        ),
        Deploy(artifact_dir=args.artifact_dir),
        Eval(batch_step=99_999, max_regression=1.0),
    )).validate()
    print(f"recipe: {recipe.describe()}")

    data = MarkovLM(vocab=arch.vocab, seq_len=64, batch=16)
    result = recipe.run(arch, data, ckpt_dir=args.ckpt_dir, device=args.device)

    # the registry shows how the plan resolved every site
    print("per-site resolution (layer 1):")
    for s in result.lut_bundle.sites():
        if s.layer == 1 and s.stack_index is not None:
            lut = f"K={s.lut.k} V={s.lut.v}" if s.mode != Mode.DENSE else "dense"
            print(f"  {s.kind:12s} {s.d_in:4d}->{s.d_out:<4d} {lut}")

    ev = result.stage_result("eval") or {}
    print(f"deployed INT8 LUT eval loss: {ev.get('deployed_loss'):.4f} "
          f"(dense teacher {ev.get('dense_loss'):.4f})")
    print(f"wrote LUTArtifact (manifest v2, plan + recipe) to {args.artifact_dir}\n"
          f"  inspect: python -m repro_torch.serving.artifact {args.artifact_dir}\n"
          f"  serve:   python -m repro_torch.launch.serve --artifact {args.artifact_dir}")


if __name__ == "__main__":
    main()
